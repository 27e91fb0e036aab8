"""One run of one cell: data from the seed, the table, the warm-up, the
measured window, the check against the plain reference, the result.

The program under test is ``repro_torch`` (``src/``): the harness builds
its table through ``Database.create_table`` (and ``Database.freeze`` on
a frozen configuration), drives it through the cell's traffic loop, and
reads its spans, counters and kernel names.  Everything else (the bases,
the patterns, the reference's suffix array and answers, the byte counts
of the rooflines) is made here from ``--seed``.
"""
from __future__ import annotations

import gc
import os
import shutil
import sys
import tempfile
import threading
import time
import types

import numpy as np
import torch

from suffixbench import devtrace, roofline, spec

TABLE = "chr1"
TRACE_SECONDS = 5.0          # the traced stretch at the end of the window
SEED_BITS = 1 << 64


def derive(seed: int, *path: int) -> int:
    """A 63-bit generator seed for one stream of one run's seed."""
    ss = np.random.SeedSequence([seed % SEED_BITS, *path])
    hi, lo = ss.generate_state(2, np.uint32)
    return (int(hi) << 31) ^ int(lo)


def make_text(n: int, seed: int, device: torch.device) -> np.ndarray:
    """``n`` uniform bases (uint8 codes 0..3), drawn on ``device`` in one
    call, as a host array."""
    g = torch.Generator(device=device)
    g.manual_seed(derive(seed, 0))
    text = torch.randint(0, 4, (n,), generator=g, device=device,
                         dtype=torch.uint8)
    return text.cpu().numpy()


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def table_counters(db, table) -> dict:
    """The program's spans and counters, flat: ``table.<span>`` and
    ``client.<span>`` as (sum_ms, count), the scheduler's and the string
    cache's counters as numbers."""
    out = {}
    for prefix, tracer in (("table", table.tracer),
                           ("client", db.scheduler.tracer)):
        for span, h in tracer.snapshot().items():
            out[f"{prefix}.{span}"] = (float(h["sum_ms"]), int(h["total"]))
    st = db.scheduler.stats
    out["client.executed"] = st.executed
    out["client.batches"] = st.batches
    cache = table.stats()["cache"]
    out["cache.hits"] = cache["hits"]
    out["cache.misses"] = cache["misses"]
    return out


def delta(after: dict, before: dict) -> dict:
    out = {}
    for k, v in after.items():
        b = before.get(k)
        if isinstance(v, tuple):
            b = b or (0.0, 0)
            out[k] = (v[0] - b[0], v[1] - b[1])
        else:
            out[k] = v - (b or 0)
    return out


class LaunchRecorder:
    """While installed, records the patterns of every search the planner
    sends to the card: ``core.query.query`` (one ``bounded_search``
    launch) and ``kernels.ops.fm_search`` (one ``fm_scan`` launch),
    host copies of (packed words, lengths) in call order."""

    def __init__(self):
        self.calls = {"bounded_search": [], "fm_scan": []}
        self._undo = []

    def install(self) -> None:
        from repro_torch.core import query as Q
        from repro_torch.kernels import ops
        for mod, attr, kernel in ((Q, "query", "bounded_search"),
                                  (ops, "fm_search", "fm_scan")):
            inner = getattr(mod, attr)
            setattr(mod, attr, self._wrap(inner, kernel))
            self._undo.append((mod, attr, inner))

    def _wrap(self, inner, kernel: str):
        calls = self.calls[kernel]

        def recorded(a, patt, plen, *args, **kw):
            calls.append((patt, plen))
            return inner(a, patt, plen, *args, **kw)
        return recorded

    def remove(self) -> None:
        for mod, attr, inner in reversed(self._undo):
            setattr(mod, attr, inner)
        self._undo.clear()
        for kernel, calls in self.calls.items():
            self.calls[kernel] = [(_host(p), _host(l)) for p, l in calls]


def _host(x) -> np.ndarray:
    """A tensor (packed ``uint32`` words moved as their bits) as a
    host array."""
    if not torch.is_tensor(x):
        return np.asarray(x)
    if x.dtype == torch.uint32:
        return x.view(torch.int32).cpu().numpy().view(np.uint32)
    return x.cpu().numpy()


def run_window(callers, seconds: float, on_trace=None, trace_at=None):
    """Runs each caller in a thread of its own from one instant for
    ``seconds``.  Each caller is ``f(stop_at) -> list of requests``; it
    sends no request after ``stop_at``.  With ``on_trace``, the main
    thread calls it at ``start + trace_at``.  Returns (start, the time
    the last request ended, the callers' requests)."""
    go = threading.Event()
    results = [None] * len(callers)
    errors = []
    t = {}

    def body(i, f):
        go.wait()
        try:
            results[i] = f(t["stop"])
        except BaseException as exc:      # re-raised in the main thread
            errors.append(exc)

    threads = [threading.Thread(target=body, args=(i, f), daemon=True)
               for i, f in enumerate(callers)]
    for th in threads:
        th.start()
    t["start"] = time.perf_counter()
    t["stop"] = t["start"] + seconds
    go.set()
    if on_trace is not None:
        time.sleep(max(0.0, t["start"] + trace_at - time.perf_counter()))
        on_trace()
    for th in threads:
        th.join()
    if errors:
        raise errors[0]
    requests = [r for res in results for r in res]
    end = max([r.t_done for r in requests], default=t["stop"])
    return t["start"], end, requests


def judge(ref, codes, plen, count, found, first_pos,
          unanswered: int) -> dict:
    """Every answer against the reference's: the numbers compared, each
    with its limit (all exact, limit 0)."""
    want_count, want_first = ref.answer(torch.as_tensor(codes),
                                        torch.as_tensor(plen))
    return {
        "wrong_count": {"value": int((count != want_count).sum()),
                        "limit": 0},
        "wrong_found": {"value": int((found != (want_count > 0)).sum()),
                        "limit": 0},
        "wrong_first_pos": {"value": int((first_pos != want_first).sum()),
                            "limit": 0},
        "unanswered": {"value": int(unanswered), "limit": 0},
    }


def run_cell(cell, seed: int, seconds: float, trace: bool,
             device: torch.device, t_process: float) -> dict:
    """One run of ``cell``; returns the result line (a dict) whose
    ``checks`` come last."""
    text = make_text(int(cell.config["n_bases"]), seed, device)
    root = tempfile.mkdtemp(prefix="suffixbench_", dir=tempfile.gettempdir())
    try:
        return _run(cell, seed, seconds, trace, device, t_process, text,
                    root)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _run(cell, seed, seconds, trace, device, t_process, text, root):
    from repro_torch.api import Database
    cfg, traffic = cell.config, cell.traffic
    n = int(cfg["n_bases"])
    on_card = device.type == "cuda"
    if on_card:
        # build (first run in a checkout) or find the kernels now, so that
        # no compile lands in the ingest or the window
        from repro_torch.kernels import _build
        _build.build()
    db = Database(root, device=device)
    os.sync()              # no earlier run's writes left to flush here
    sync(device)
    t0 = time.perf_counter()
    table = db.create_table(TABLE, text, is_dna=True,
                            max_query_len=int(cfg["max_query_len"]))
    if cfg.get("freeze_sample_rate"):
        db.freeze(TABLE, sample_rate=int(cfg["freeze_sample_rate"]))
    sync(device)
    ingest_s = time.perf_counter() - t0

    ctx = types.SimpleNamespace(db=db, table=table, table_name=TABLE,
                                seed=seed, config=cfg, traffic=traffic,
                                device=device, n_bases=n)
    load = cell.loop.Traffic(ctx)
    load.warm_up()
    prof = None
    if trace:
        prof = devtrace.Profiler()     # the profiler's own start-up
        warm = devtrace.Profiler()     # is set-up, not window
        warm.start(device)
        warm.stop()
    sync(device)
    # the table's snapshot, written but not flushed (the checkpoint does
    # not fsync), goes to disk now and not in the window
    os.sync()
    setup_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_process

    before = table_counters(db, table)
    marks = {}
    recorder = LaunchRecorder()
    on_trace = trace_at = None
    if trace:
        trace_s = min(TRACE_SECONDS, seconds / 2)
        trace_at = seconds - trace_s

        def start_trace():
            sync(device)
            marks["segment_end"] = time.perf_counter()
            marks["segment"] = table_counters(db, table)
            recorder.install()
            prof.start(device)

        def on_trace():
            db.scheduler.run_exclusive(table, start_trace)

    start, end, requests = run_window(load.callers(), seconds, on_trace,
                                      trace_at)
    if trace:
        sync(device)
        prof.stop()
        recorder.remove()
    window_peak = (torch.cuda.max_memory_allocated(device) if on_card
                   else 0)
    answers = load.answers(requests)
    device_trace = prof.result() if trace else None
    if trace:
        for kernel, calls in recorder.calls.items():
            print(f"trace: {kernel} calls={len(calls)} launches="
                  f"{device_trace.kernel_ns(kernel + '_kernel').size}",
                  file=sys.stderr)

    # the program's state goes before the reference is built
    db.close()
    del db, table, load, ctx
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    reference = spec.load_module(os.path.join(spec.ROOT, cfg["reference"]),
                                 "suffixbench_reference")
    ref = reference.SuffixReference(torch.from_numpy(text).to(device),
                                    int(cfg["max_query_len"]))
    checks = judge(ref, answers.codes, answers.plen, answers.count,
                   answers.found, answers.first_pos, answers.unanswered)
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    lat_ms = np.array([(r.t_done - r.t_submit) * 1e3 for r in requests])
    if lat_ms.size:
        print("window: requests={} seconds={:.3f} latency_ms p50={:.3f} "
              "p90={:.3f} p95={:.3f} p99={:.3f} max={:.3f}".format(
                  lat_ms.size, end - start,
                  *np.percentile(lat_ms, [50, 90, 95, 99, 100])),
              file=sys.stderr)
    w = types.SimpleNamespace(
        seconds=end - start, requests=len(requests),
        patterns=int(sum(r.n_patterns for r in requests if r.ok)),
        lat_ms=lat_ms, setup_s=setup_s, ingest_s=ingest_s,
        window_peak_bytes=window_peak, n_bases=n)
    if trace:
        seg_end = marks["segment_end"]
        seg_patterns = int(sum(r.n_patterns for r in requests
                               if r.ok and r.t_done <= seg_end))
        lctx = types.SimpleNamespace(
            window=w, counters=delta(marks["segment"], before),
            segment_patterns=seg_patterns, trace=device_trace,
            launches=recorder.calls, reference=ref, roofline=roofline)
        metrics = _read(cell.per_layer, lctx)
    else:
        metrics = _read(cell.end_to_end, w)
    dev_info = {
        "platform": "gpu" if on_card else device.type,
        "kind": (torch.cuda.get_device_name(device) if on_card
                 else device.type),
        "count": 1,
        "memory_peak_bytes": int(max(setup_peak, window_peak)),
    }
    out = {"correct": bool(correct), "attempted": len(requests),
           "failed": int(sum(1 for r in requests if not r.ok)),
           "metrics": metrics, "device": dev_info}
    if trace:
        dev_info["busy_s"] = device_trace.busy_s
        dev_info["window_s"] = device_trace.window_s
        out["breakdown"] = {"device_ops": device_trace.device_ops,
                            "idle_gaps": device_trace.idle_gaps}
    out["checks"] = checks
    return out


def _read(metrics, ctx) -> dict:
    """Each metric's reader on ``ctx``; one that finds nothing to read
    returns None and is left out."""
    out = {}
    for m in metrics:
        v = m.reader.read(ctx)
        if v is not None:
            out[m.name] = {"value": float(v), "unit": m.entry["unit"]}
    return out
