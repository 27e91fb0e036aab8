"""Periodic JSON-lines metrics feed — the port's own copy of
``repro.serving.metrics`` (standard library only; the port imports
nothing of ``repro``).

An in-process table joins the feed through ``SuffixTable.start_metrics``:
one row per interval, built by :func:`table_record` (the full
``stats()`` tree under ``"stats"``), appended to the table's
``root/<name>/metrics.jsonl``.  The rows keep the reference's schema, so
the reference's :func:`aggregate_metrics` and ``benchmarks/
check_regression.py --from-feed`` read a feed the port wrote, and
``python -m repro_torch.launch.serve --dump-stats`` aggregates it into a
``/varz``-style snapshot: the latest line per emitter plus totals.

Appends are single ``os.write`` calls on an ``O_APPEND`` fd, so
concurrent writers interleave whole lines, never fragments (each line
stays far under ``PIPE_BUF``).
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Callable, Optional


class LatencyWindow:
    """Rolling window of service latencies with p50/p95 quantiles."""

    def __init__(self, size: int = 512):
        self._window: deque = deque(maxlen=size)
        self._lock = threading.Lock()
        self.total = 0

    def record(self, ms: float) -> None:
        with self._lock:
            self._window.append(float(ms))
            self.total += 1

    def quantiles(self) -> dict:
        with self._lock:
            data = sorted(self._window)
        if not data:
            return {"p50_ms": 0.0, "p95_ms": 0.0, "p99_ms": 0.0, "n": 0}

        def q(frac: float) -> float:
            return data[min(len(data) - 1, int(frac * len(data)))]

        return {"p50_ms": round(q(0.50), 4), "p95_ms": round(q(0.95), 4),
                "p99_ms": round(q(0.99), 4), "n": len(data)}


def append_line(path: str, record: dict) -> None:
    """Append one metrics line atomically (O_APPEND, single write)."""
    line = json.dumps(record, separators=(",", ":")) + "\n"
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
    try:
        os.write(fd, line.encode("utf-8"))
    finally:
        os.close(fd)


class MetricsEmitter:
    """Background thread appending ``provider()`` to ``path`` every
    ``interval_s`` (plus one final line on :meth:`stop`, so short-lived
    workers still leave a record).  ``interval_s <= 0`` disables the
    periodic thread but keeps the final line."""

    def __init__(self, path: str, provider: Callable[[], dict], *,
                 interval_s: float = 10.0):
        self.path = path
        self.provider = provider
        self.interval_s = float(interval_s)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if self.interval_s > 0:
            self._thread = threading.Thread(target=self._loop,
                                            name="metrics-emitter",
                                            daemon=True)
            self._thread.start()

    def emit(self) -> None:
        record = dict(self.provider())
        record["ts"] = round(time.time(), 3)
        try:
            append_line(self.path, record)
        except OSError:
            pass                   # metrics must never take serving down

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.emit()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
        self.emit()                # final line: the worker's last word


def table_record(name: Optional[str], stats: dict) -> dict:
    """One feed row for an in-process table — the SAME schema plane
    workers emit: ``role`` + identity + top-level ``queries`` /
    ``p50_ms`` / ``p95_ms`` / ``p99_ms`` scalars the aggregator sums,
    with the full ``SuffixTable.stats()`` tree (tiers/cache/planner/
    build/wal/latency) riding under ``"stats"`` for drill-down.  The
    latency scalars come from the ``"total"`` span histogram (end-to-end
    ``scan_batch`` time); docs/observability.md documents the row."""
    latency = stats.get("latency") or {}
    total = latency.get("total") or {}
    return {
        "role": "table",
        "table": name,
        "pid": os.getpid(),
        "queries": int((stats.get("planner") or {}).get("queries") or 0),
        "p50_ms": float(total.get("p50_ms") or 0.0),
        "p95_ms": float(total.get("p95_ms") or 0.0),
        "p99_ms": float(total.get("p99_ms") or 0.0),
        "stats": stats,
    }


def read_lines(path: str) -> list[dict]:
    """Every parseable metrics line (torn/corrupt lines are skipped —
    the feed is observability, not a source of truth)."""
    if not os.path.exists(path):
        return []
    out = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except ValueError:
                continue
    return out


def aggregate_metrics(path: str) -> dict:
    """The ``/varz`` snapshot ``serve.py --dump-stats`` prints.

    Groups lines by emitter (``role``/``tablet``/``replica``/``pid``,
    plus ``table`` for in-process ``role: "table"`` rows), keeps each
    emitter's LATEST line, and sums the countable fields across
    emitters: queries served, RPCs, sheds, hedge wins, failovers, WAL
    records replayed.  Latencies aggregate as the worst (max) p95 and
    the median of p50s over every query-serving emitter (workers AND
    in-process tables) — a fleet summary, not a merged histogram.
    """
    lines = read_lines(path)
    latest: dict[tuple, dict] = {}
    for rec in lines:
        key = (rec.get("role", "worker"), rec.get("tablet"),
               rec.get("replica"), rec.get("pid"), rec.get("table"))
        cur = latest.get(key)
        if cur is None or rec.get("ts", 0) >= cur.get("ts", 0):
            latest[key] = rec
    workers = [r for r in latest.values()
               if r.get("role", "worker") == "worker"]
    routers = [r for r in latest.values() if r.get("role") == "router"]
    tables = [r for r in latest.values() if r.get("role") == "table"]
    serving = workers + tables     # everything that answers queries

    def total(records: list[dict], field: str) -> int:
        return int(sum(r.get(field) or 0 for r in records))

    p50s = sorted(r.get("p50_ms", 0.0) for r in serving)
    summary = {
        "emitters": len(latest),
        "workers": len(workers),
        "tables": len(tables),
        "tablets": len({r.get("tablet") for r in workers}),
        "queries": total(serving, "queries"),
        "rpcs": total(workers, "rpcs"),
        "shed_worker": total(workers, "shed"),
        "shed_quota": total(routers, "quota_shed"),
        "hedge_fired": total(routers, "hedge_fired"),
        "hedge_wins": total(routers, "hedge_wins"),
        "failovers": total(routers, "failovers"),
        "wal_records_replayed": total(workers, "wal_records_replayed"),
        "queue_depth": total(workers, "queue_depth"),
        "p50_ms_median": (p50s[len(p50s) // 2] if p50s else 0.0),
        "p95_ms_max": max((r.get("p95_ms", 0.0) for r in serving),
                          default=0.0),
    }
    return {"summary": summary,
            "latest": sorted(latest.values(),
                             key=lambda r: (str(r.get("role", "worker")),
                                            str(r.get("table") or ""),
                                            r.get("tablet") or 0,
                                            r.get("replica") or 0))}
