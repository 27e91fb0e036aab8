"""One run of one cell: data from the seed, the table, the warm-up, the
measured window, the check against the plain reference, the result.

The program under test is ``repro_torch`` (``src/``): the harness builds
its table through ``Database.create_table`` (with the configuration's
``table_options``, and ``Database.freeze`` on a frozen configuration),
drives it through the cell's traffic loop, and reads its spans, counters
and kernel names.  Everything else (the bases, the patterns, the
reference's suffix array and answers, the byte counts of the rooflines)
is made here from ``--seed``.

A loop that writes has ``appended()``: every acknowledged appended code
in ack order.  Its answers carry ``n_visible``, the text length each was
answered over; the reference is built over the bases and the appends
and answers each at its own length.  Every append from the load phase
to the window's close is watched for an fsync of the commit log that
held its record before its ack (``unsynced_acks``).  After the window
the table is reopened from its root (snapshot and commit-log replay)
and checked against every acknowledged append (``lost_appends``).
"""
from __future__ import annotations

import gc
import glob
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
TRACE_SECONDS = 5.0          # the traced stretch at the end of the window,
                             # unless the traffic sets ``trace_seconds``
# the keyword arguments of ``create_table`` a configuration may set
TABLE_OPTIONS = ("memtable_limit", "max_runs", "group_commit_ms")
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
    host copies of (packed words, lengths) in call order; and
    ``kernels.ops.fused_single`` (the base and delta tiers of a table
    that has them: one ``tier_scan`` launch beside the base's
    ``bounded_search``), with each tier's offset, owned end and rows.
    ``spans`` holds each call's (enter, exit) on ``time.time_ns``, the
    profiler's clock."""

    def __init__(self):
        self.calls = {"bounded_search": [], "fm_scan": [], "tier_scan": []}
        self.spans = {kernel: [] for kernel in self.calls}
        self._undo = []

    def install(self) -> None:
        from repro_torch.core import query as Q
        from repro_torch.kernels import ops
        for mod, attr, kernel in ((Q, "query", "bounded_search"),
                                  (ops, "fm_search", "fm_scan")):
            inner = getattr(mod, attr)
            setattr(mod, attr, self._wrap(inner, kernel))
            self._undo.append((mod, attr, inner))
        inner = ops.fused_single
        calls, spans = self.calls["tier_scan"], self.spans["tier_scan"]

        def fused(store, stack, patt, plen):
            calls.append((patt, plen, stack.offset, stack.hi, stack.n_rows))
            t0 = time.time_ns()
            try:
                return inner(store, stack, patt, plen)
            finally:
                spans.append((t0, time.time_ns()))
        ops.fused_single = fused
        self._undo.append((ops, "fused_single", inner))

    def _wrap(self, inner, kernel: str):
        calls, spans = self.calls[kernel], self.spans[kernel]

        def recorded(a, patt, plen, *args, **kw):
            calls.append((patt, plen))
            t0 = time.time_ns()
            try:
                return inner(a, patt, plen, *args, **kw)
            finally:
                spans.append((t0, time.time_ns()))
        return recorded

    def remove(self) -> None:
        for mod, attr, inner in reversed(self._undo):
            setattr(mod, attr, inner)
        self._undo.clear()
        for kernel, calls in self.calls.items():
            self.calls[kernel] = [tuple(_host(x) for x in c) for c in calls]


class DurableAcks:
    """While installed, witnesses every ``Database.append`` on one
    handle: its ack is durable when the commit-log file that held its
    record (the table's ``wal.log`` as it was when the append was sent,
    told apart by its inode) was fsync'd between the send and the ack.
    Counts the acks and those that no such fsync came before."""

    def __init__(self, root: str):
        self.root = root
        self.acks = self.unsynced = 0
        self._synced = []          # the inode of every fsync, in order
        self._fsync = self._db = None

    def install(self, db) -> None:
        logs = glob.glob(os.path.join(self.root, "**", "wal.log"),
                         recursive=True)
        log = logs[0] if len(logs) == 1 else None
        real_fsync, real_append = os.fsync, db.append
        synced = self._synced

        def fsync(fd):
            real_fsync(fd)
            synced.append(os.fstat(fd).st_ino)

        def append(*args, **kw):
            ino = os.stat(log).st_ino if log and os.path.exists(log) \
                else None
            k = len(synced)
            out = real_append(*args, **kw)
            self.acks += 1
            self.unsynced += ino is None or ino not in synced[k:]
            return out
        os.fsync, db.append = fsync, append
        self._fsync, self._db = real_fsync, db

    def remove(self) -> None:
        os.fsync = self._fsync
        del self._db.append          # the class's method again
        self._fsync = self._db = None


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
          unanswered: int, n_visible=None) -> dict:
    """Every answer against the reference's (each at its ``n_visible``
    where given): the numbers compared, each with its limit (all exact,
    limit 0)."""
    want_count, want_first = ref.answer(torch.as_tensor(codes),
                                        torch.as_tensor(plen), n_visible)
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
    options = table_options(cfg)
    db = Database(root, device=device)
    os.sync()              # no earlier run's writes left to flush here
    sync(device)
    t0 = time.perf_counter()
    table = db.create_table(TABLE, text, is_dna=True,
                            max_query_len=int(cfg["max_query_len"]),
                            **options)
    if cfg.get("freeze_sample_rate"):
        db.freeze(TABLE, sample_rate=int(cfg["freeze_sample_rate"]))
    sync(device)
    ingest_s = time.perf_counter() - t0

    ctx = types.SimpleNamespace(db=db, table=table, table_name=TABLE,
                                seed=seed, config=cfg, traffic=traffic,
                                device=device, n_bases=n, text=text,
                                seconds=seconds)
    load = cell.loop.Traffic(ctx)
    writes = hasattr(load, "appended")
    if writes:
        acks = DurableAcks(root)
        acks.install(db)
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
    runs_before = len(table.runs)
    marks = {}
    recorder = LaunchRecorder()
    on_trace = trace_at = None
    if trace:
        # a mix whose turns are long traces longer, so that the stretch
        # always holds whole requests
        trace_s = min(float(traffic.get("trace_seconds", TRACE_SECONDS)),
                      seconds / 2)
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
    if writes:
        acks.remove()
    window_peak = (torch.cuda.max_memory_allocated(device) if on_card
                   else 0)
    answers = load.answers(requests)
    device_trace = prof.result() if trace else None
    if trace:
        for kernel, calls in recorder.calls.items():
            launch_ns, _durs = device_trace.kernel_launches(kernel + "_kernel")
            paired = roofline.pair_launches(recorder.spans[kernel], launch_ns)
            print(f"trace: {kernel} calls={len(calls)} launches="
                  f"{launch_ns.size} paired={int((paired >= 0).sum())}",
                  file=sys.stderr)

    n_appends = len(load.append_log) if writes else 0
    if writes:
        append_ms = [(a - d) * 1e3 for d, a in load.append_log]
        print("writes: window_appends={} sealed_in_window={} runs={} "
              "memtable_bases={} append_ms p50={:.3f} p95={:.3f} "
              "max={:.3f}".format(
                  n_appends, len(table.runs) - runs_before,
                  len(table.runs), table.memtable.size,
                  *np.percentile(append_ms, [50, 95, 100])),
              file=sys.stderr)
        wal = table.stats()["wal"]["log"] or {}
        print(f"durability: acks={acks.acks} unsynced={acks.unsynced} "
              f"log_acked={wal.get('acked')} log_fsyncs={wal.get('fsyncs')} "
              f"log_seals={wal.get('seals')}", file=sys.stderr)

    # the program's state goes before the reference is built
    db.close()
    if writes:
        ctx.db = ctx.table = None      # the loop stays for the reopen
    else:
        del load
    del db, table, ctx
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    if writes:
        t_reopen = time.perf_counter()
        durable = reopened(root, device, options, load, n)
        print(f"reopen: seconds={time.perf_counter() - t_reopen:.3f} "
              f"length={durable.length} of {durable.n_final}",
              file=sys.stderr)
        text = np.concatenate([text, load.appended()])
        del load

    reference = spec.load_module(os.path.join(spec.ROOT, cfg["reference"]),
                                 "suffixbench_reference")
    ref = reference.SuffixReference(torch.from_numpy(text).to(device),
                                    int(cfg["max_query_len"]),
                                    n_fixed=n if writes else None)
    checks = judge(ref, answers.codes, answers.plen, answers.count,
                   answers.found, answers.first_pos, answers.unanswered,
                   getattr(answers, "n_visible", None))
    if writes:
        checks["unsynced_acks"] = {"value": acks.unsynced, "limit": 0}
        checks["lost_appends"] = {"value": lost_appends(ref, durable),
                                  "limit": 0}
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
            launches=recorder.calls, launch_spans=recorder.spans,
            reference=ref, roofline=roofline)
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
    out = {"correct": bool(correct), "attempted": len(requests) + n_appends,
           "failed": int(sum(1 for r in requests if not r.ok)),
           "metrics": metrics, "device": dev_info}
    if trace:
        dev_info["busy_s"] = device_trace.busy_s
        dev_info["window_s"] = device_trace.window_s
        out["breakdown"] = {"device_ops": device_trace.device_ops,
                            "idle_gaps": device_trace.idle_gaps}
    out["checks"] = checks
    return out


def table_options(cfg: dict) -> dict:
    """The configuration's ``table_options`` (``TABLE_OPTIONS`` only)."""
    options = dict(cfg.get("table_options") or {})
    unknown = set(options) - set(TABLE_OPTIONS)
    if unknown:
        raise ValueError(f"table_options: no such option {sorted(unknown)}")
    return options


def reopened(root: str, device, options: dict, load,
             n: int) -> types.SimpleNamespace:
    """The table reopened from ``root`` by a fresh handle (the snapshot
    and the commit log's replay): its logical length and its answers to
    the window's last read batch; and the length that every
    acknowledged append makes.  The handle is closed and freed before this returns."""
    from repro_torch.api import Database
    db = Database(root, device=device, **options)
    try:
        # the text's whole length: base, sealed runs and the memtable
        length = len(db.table(TABLE))
        again = load.reread(db)
    finally:
        db.close()
    del db
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return types.SimpleNamespace(length=length, answers=again,
                                 n_final=n + int(load.appended().size))


def lost_appends(ref, durable) -> int:
    """What the reopened table lost: the bases missing from (or extra
    in) its logical length, plus the patterns of the last read batch
    whose reopened answer differs from the reference's at the final
    length."""
    a = durable.answers
    want_count, want_first = ref.answer(
        torch.as_tensor(a.codes), torch.as_tensor(a.plen),
        np.full(a.plen.size, durable.n_final))
    differ = ((a.count != want_count) | (a.found != (want_count > 0))
              | (a.first_pos != want_first))
    return abs(durable.length - durable.n_final) + int(differ.sum())


def _read(metrics, ctx) -> dict:
    """Each metric's reader on ``ctx``; one that finds nothing to read
    returns None and is left out."""
    out = {}
    for m in metrics:
        v = m.reader.read(ctx)
        if v is not None:
            out[m.name] = {"value": float(v), "unit": m.entry["unit"]}
    return out
