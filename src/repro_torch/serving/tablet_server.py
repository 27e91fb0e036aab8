"""Tablet worker process — serves one rank-range tablet of one table; the
port's own copy of ``repro.serving.tablet_server``.

One worker owns one **tablet**: a contiguous suffix-rank slice
``[rank_lo, rank_hi)`` of a table's base suffix array, cut by
``repro_torch.serving.plane.split_table`` and recorded in the table's
``tablets/manifest.json`` (the METADATA entry).  The worker opens the
manifest's snapshot READ-ONLY with numpy alone — no torch import, so a
replica starts in milliseconds — loading:

* the full base text (``codes``; every tablet needs it to compare
  suffixes) but only the **suffix-array rows of its own rank slice**:
  when the snapshot was shard-streamed (``ShardedSave``, the staged
  build), only the ``shard_sa_real_*.npy`` files overlapping the slice
  are opened;
* for the **delta-owner** tablet (the last one) the delta tier too:
  sealed run codes + snapshot memtable codes + the commit log's tail
  **replayed read-only** (records with seq beyond the snapshot's
  ``wal_seq``, exactly the records ``SuffixTable.open`` would replay —
  so a worker restarted after a kill -9 serves the same view, which the
  text CRC shows).

The read algorithms give the single-process table's answers exactly:

* base counts/positions come from a **batched binary search** over the
  rank slice with depth-capped lexicographic compare (a suffix shorter
  than the pattern compares less via a −1 sentinel) — per-tablet counts
  over disjoint rank slices sum to the single-process count;
* delta occurrences (those ending past ``n_base``) are matched over the
  overlap window + delta text with the memtable's two-sided rule
  ``n_base < g + plen <= n_base + delta_len``.

Execution is serialized per worker behind a **device lock** with an
optional per-pattern service floor (``--device-floor-ms``).  Admission
is bounded by ``--max-inflight`` (requests beyond it get the typed
OVERLOADED shed, see ``repro_torch.serving.rpc``), and every worker
appends a periodic metrics line to the table's ``metrics.jsonl``.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading
import time
import zlib
from typing import Optional

import numpy as np

from repro_torch.api.wal import read_segment
from repro_torch.serving import rpc
from repro_torch.serving.metrics import LatencyWindow, MetricsEmitter
from repro_torch.serving.trace import Tracer

_DNA = {c: i for i, c in enumerate("ACGT")}


def encode_pattern_rows(patterns: list) -> tuple:
    """Strings -> (B, Lmax) int32 rows + (B,) int64 lens.  A numpy-only
    mirror of ``repro_torch.core.query.encode_patterns`` (which sits
    behind a torch import): string patterns are DNA-encoded for every
    store kind, zero-padded to the batch width."""
    lens = np.array([len(p) for p in patterns], np.int64)
    lmax = max(1, int(lens.max()) if lens.size else 1)
    rows = np.zeros((len(patterns), lmax), np.int32)
    for i, p in enumerate(patterns):
        try:
            row = [_DNA[c.upper()] for c in p]
        except KeyError as e:
            raise ValueError(f"non-DNA symbol {e} in pattern") from e
        rows[i, :len(row)] = row
    return rows, lens


# ---------------------------------------------------------------------------
# snapshot slice loading (numpy-only)
# ---------------------------------------------------------------------------
def _array_name(path: str) -> str:
    """``"['codes']"`` -> ``"codes"`` (CheckpointManager path strings)."""
    return path.replace("['", "").replace("']", "").strip("'[]")


class SnapshotReader:
    """Read-only view of one published ``step_*`` snapshot dir."""

    def __init__(self, table_dir: str, step: int):
        self.dir = os.path.join(table_dir, f"step_{int(step):010d}")
        with open(os.path.join(self.dir, "meta.json")) as f:
            self.meta = json.load(f)
        self.extra = self.meta.get("extra", {})
        self._npz = np.load(os.path.join(self.dir, "arrays.npz"))
        self._index = {_array_name(p): f"a{i}"
                       for i, p in enumerate(self.meta["paths"])}

    def has(self, name: str) -> bool:
        return name in self._index or name in self.meta.get("shards", {})

    def load(self, name: str) -> np.ndarray:
        """Full array ``name`` (npz member or stitched shards)."""
        if name in self._index:
            return self._npz[self._index[name]]
        ent = self.meta["shards"][name]
        parts = [np.load(os.path.join(self.dir,
                                      f"shard_{name}_{i:06d}.npy"))
                 for i in range(ent["count"])]
        if not parts:
            return np.zeros((0,), np.dtype(ent["dtype"] or "int32"))
        return np.concatenate(parts)

    def load_slice(self, name: str, lo: int, hi: int) -> np.ndarray:
        """Rows ``[lo, hi)`` of 1-D array ``name`` — for a shard-streamed
        array only the overlapping shard files are opened (memory-mapped,
        then sliced), so a tablet's footprint is its slice, not the SA."""
        shards = self.meta.get("shards", {})
        if name not in shards:
            return np.asarray(self.load(name)[lo:hi])
        parts = []
        offset = 0
        for i in range(shards[name]["count"]):
            path = os.path.join(self.dir, f"shard_{name}_{i:06d}.npy")
            mm = np.load(path, mmap_mode="r")
            n = int(mm.shape[0])
            a, b = max(lo, offset), min(hi, offset + n)
            if a < b:
                parts.append(np.asarray(mm[a - offset:b - offset]))
            offset += n
        if not parts:
            dt = np.dtype(shards[name]["dtype"] or "int32")
            return np.zeros((0,), dt)
        return np.concatenate(parts)


def load_tablet(manifest_path: str, tablet_id: int) -> "TabletIndex":
    """Open the manifest's snapshot and build this tablet's index."""
    with open(manifest_path) as f:
        manifest = json.load(f)
    tablets_dir = os.path.dirname(os.path.abspath(manifest_path))
    table_dir = os.path.dirname(tablets_dir)
    spec = manifest["tablets"][tablet_id]
    if spec["id"] != tablet_id:
        raise ValueError(f"manifest tablet order broken at {tablet_id}")
    snap = SnapshotReader(table_dir, manifest["step"])
    extra = snap.extra
    if extra.get("frozen"):
        raise RuntimeError(
            "tablet workers serve the SA base tier; this snapshot is "
            "frozen onto the FM-index — split before freeze()")
    if int(extra["version"]) != int(manifest["table_version"]):
        raise RuntimeError(
            f"manifest was cut at table version "
            f"{manifest['table_version']} but the snapshot holds "
            f"v{extra['version']} — redeploy the plane (split_table)")
    codes = np.asarray(snap.load("codes"))
    n_base = int(codes.shape[0])
    rank_lo, rank_hi = int(spec["rank_lo"]), int(spec["rank_hi"])
    sa_slice = snap.load_slice("sa_real", rank_lo, rank_hi)
    mql = int(extra["max_query_len"])

    serves_delta = tablet_id == manifest["n_tablets"] - 1
    delta_parts: list[np.ndarray] = []
    wal_replayed = 0
    if serves_delta:
        for i, _meta in enumerate(extra.get("runs", [])):
            delta_parts.append(np.asarray(snap.load(f"run{i}_codes")))
        if snap.has("mem_codes"):
            mem = np.asarray(snap.load("mem_codes"))
            if mem.size:
                delta_parts.append(mem)
        wal_path = os.path.join(table_dir, "wal", "wal.log")
        if os.path.exists(wal_path):
            # read-only tail replay: never touches the live segment
            # (SuffixTable.open would truncate/attach it — workers must
            # not, the primary owns the log)
            _start, records, _summary = read_segment(wal_path)
            wal_seq = int(extra.get("wal_seq", 0))
            for seq, rec_codes, _end in records:
                if seq > wal_seq:
                    delta_parts.append(np.asarray(rec_codes))
                    wal_replayed += 1
    delta = (np.concatenate(delta_parts).astype(codes.dtype)
             if delta_parts else np.zeros((0,), codes.dtype))
    return TabletIndex(
        codes=codes, sa_slice=sa_slice, rank_lo=rank_lo, rank_hi=rank_hi,
        delta_codes=delta, max_query_len=mql,
        is_dna=bool(extra["is_dna"]), serves_delta=serves_delta,
        wal_records_replayed=wal_replayed, manifest=manifest,
        tablet_id=tablet_id)


# ---------------------------------------------------------------------------
# the tablet index
# ---------------------------------------------------------------------------
class TabletIndex:
    """Rank-slice suffix search + (for the owner) delta matching."""

    def __init__(self, *, codes: np.ndarray, sa_slice: np.ndarray,
                 rank_lo: int, rank_hi: int, delta_codes: np.ndarray,
                 max_query_len: int, is_dna: bool, serves_delta: bool,
                 wal_records_replayed: int = 0,
                 manifest: Optional[dict] = None, tablet_id: int = 0):
        self.n_base = int(codes.shape[0])
        self.rank_lo, self.rank_hi = int(rank_lo), int(rank_hi)
        self.max_query_len = int(max_query_len)
        self.is_dna = bool(is_dna)
        self.serves_delta = bool(serves_delta)
        self.wal_records_replayed = int(wal_records_replayed)
        self.manifest = manifest
        self.tablet_id = int(tablet_id)
        self._sa = np.ascontiguousarray(sa_slice).astype(np.int64)
        if self._sa.shape[0] != self.rank_hi - self.rank_lo:
            raise ValueError(
                f"SA slice holds {self._sa.shape[0]} rows for rank range "
                f"[{rank_lo}, {rank_hi}) — snapshot/manifest mismatch")
        codes32 = np.ascontiguousarray(codes).astype(np.int32)
        # −1 sentinel pad: a suffix running out of text inside the
        # compare depth reads −1 < every real code, i.e. shorter-is-less
        self._pad = np.concatenate(
            [codes32, np.full(self.max_query_len, -1, np.int32)])
        self.delta_len = int(delta_codes.shape[0])
        self.overlap = min(self.max_query_len - 1, self.n_base)
        if self.serves_delta and self.delta_len:
            self._window = np.concatenate([
                codes32[self.n_base - self.overlap:self.n_base],
                np.asarray(delta_codes).astype(np.int32)])
        else:
            self._window = np.zeros((0,), np.int32)
        # identity of the served view: crc over base + delta code bytes
        crc = zlib.crc32(np.ascontiguousarray(codes).tobytes())
        self.text_crc = zlib.crc32(
            np.asarray(delta_codes).astype(codes.dtype).tobytes(), crc)

    @property
    def n_slice(self) -> int:
        return int(self._sa.shape[0])

    # -- base tier: batched rank-slice binary search -------------------------
    def _cmp_rows(self, g: np.ndarray, rows: np.ndarray,
                  mask: np.ndarray, rowsel: np.ndarray) -> np.ndarray:
        """sign(suffix(g) - pattern) per row, compared to pattern depth."""
        idx = g[:, None] + np.arange(rows.shape[1], dtype=np.int64)[None, :]
        w = self._pad[np.minimum(idx, self._pad.shape[0] - 1)]
        diff = (w != rows) & mask
        has = diff.any(axis=1)
        first = np.where(has, diff.argmax(axis=1), 0)
        delta = (w[rowsel, first].astype(np.int64)
                 - rows[rowsel, first].astype(np.int64))
        return np.where(has, np.sign(delta), 0)

    def _bound(self, rows: np.ndarray, mask: np.ndarray,
               upper: bool) -> np.ndarray:
        B = rows.shape[0]
        rowsel = np.arange(B)
        lo = np.zeros(B, np.int64)
        hi = np.full(B, self.n_slice, np.int64)
        while True:
            act = lo < hi
            if not act.any():
                return lo
            mid = (lo + hi) >> 1
            g = self._sa[np.minimum(mid, max(self.n_slice - 1, 0))]
            c = self._cmp_rows(g, rows, mask, rowsel)
            go_right = (c <= 0) if upper else (c < 0)
            lo = np.where(act & go_right, mid + 1, lo)
            hi = np.where(act & ~go_right, mid, hi)

    def base_bounds(self, rows: np.ndarray,
                    lens: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(lb, ub) local rank bounds per pattern; count = ub - lb."""
        rows = np.ascontiguousarray(rows).astype(np.int32)
        lens = np.asarray(lens).astype(np.int64)
        if np.any(lens < 1) or np.any(lens > self.max_query_len):
            raise ValueError(
                f"pattern lengths must be in [1, {self.max_query_len}]")
        if self.n_slice == 0:
            z = np.zeros(rows.shape[0], np.int64)
            return z, z.copy()
        mask = (np.arange(rows.shape[1], dtype=np.int64)[None, :]
                < lens[:, None])
        return (self._bound(rows, mask, upper=False),
                self._bound(rows, mask, upper=True))

    def base_scan(self, rows: np.ndarray, lens: np.ndarray,
                  top_k: int = 0) -> dict:
        lb, ub = self.base_bounds(rows, lens)
        B = lb.shape[0]
        count = ub - lb
        first = np.full(B, -1, np.int64)
        positions = (np.full((B, top_k), -1, np.int64) if top_k else None)
        for i in np.flatnonzero(count > 0):
            seg = self._sa[lb[i]:ub[i]]
            first[i] = int(seg.min())
            if top_k:
                c = (np.partition(seg, top_k - 1)[:top_k]
                     if seg.shape[0] > top_k else seg.copy())
                c.sort()
                positions[i, :c.shape[0]] = c
        out = {"count": count, "first_pos": first}
        if top_k:
            out["positions"] = positions
        return out

    def base_positions(self, row: np.ndarray, length: int) -> np.ndarray:
        """All base occurrences of one pattern inside this slice."""
        lb, ub = self.base_bounds(row[None, :], np.array([length]))
        return np.sort(self._sa[int(lb[0]):int(ub[0])])

    # -- delta tier (owner only) ---------------------------------------------
    def delta_positions_one(self, row: np.ndarray,
                            length: int) -> np.ndarray:
        """Global start positions of delta-owned occurrences of one
        pattern (``n_base < g + L <= n_base + delta_len``), ascending."""
        L = int(length)
        win = self._window
        if not self.serves_delta or win.shape[0] < L:
            return np.zeros((0,), np.int64)
        sl = np.lib.stride_tricks.sliding_window_view(win, L)
        hit = np.flatnonzero((sl == row[:L]).all(axis=1))
        g = hit.astype(np.int64) + (self.n_base - self.overlap)
        return g[g + L > self.n_base]

    def delta_scan(self, rows: np.ndarray, lens: np.ndarray,
                   top_k: int = 0) -> dict:
        rows = np.ascontiguousarray(rows).astype(np.int32)
        lens = np.asarray(lens).astype(np.int64)
        B = rows.shape[0]
        count = np.zeros(B, np.int64)
        first = np.full(B, -1, np.int64)
        positions = (np.full((B, top_k), -1, np.int64) if top_k else None)
        if self.delta_len:
            for i in range(B):
                g = self.delta_positions_one(rows[i], int(lens[i]))
                if g.size:
                    count[i] = g.shape[0]
                    first[i] = int(g[0])
                    if top_k:
                        positions[i, :min(top_k, g.shape[0])] = g[:top_k]
        out = {"count": count, "first_pos": first}
        if top_k:
            out["positions"] = positions
        return out

    def locate_range(self, row: np.ndarray, length: int, after: int,
                     limit: Optional[int]) -> np.ndarray:
        """This tablet's contribution to a paged enumeration: ascending
        positions strictly greater than ``after``, capped at ``limit``
        (per-tablet caps are safe — the router keeps the globally
        smallest ``limit`` of the merged streams)."""
        base = self.base_positions(row, length)
        parts = [base[base > after]]
        if self.serves_delta and self.delta_len:
            g = self.delta_positions_one(row, length)
            parts.append(g[g > after])
        cand = np.concatenate(parts)
        cand.sort()
        if limit is not None and cand.shape[0] > limit:
            cand = cand[:limit]
        return cand.astype(np.int64)

    def stats(self) -> dict:
        return {"tablet": self.tablet_id, "rank_lo": self.rank_lo,
                "rank_hi": self.rank_hi, "n_base": self.n_base,
                "serves_delta": self.serves_delta,
                "delta_len": self.delta_len,
                "wal_records_replayed": self.wal_records_replayed,
                "text_crc": self.text_crc}


# ---------------------------------------------------------------------------
# the worker process
# ---------------------------------------------------------------------------
class TabletWorker:
    """One serving process: index + RPC server + metrics feed."""

    def __init__(self, index: TabletIndex, sock_path: str, *,
                 replica: int = 0, max_inflight: int = 8,
                 metrics_path: Optional[str] = None,
                 metrics_interval_s: float = 10.0,
                 device_floor_ms: float = 0.0,
                 inject_slow_ms: float = 0.0, inject_slow_p: float = 0.0,
                 seed: int = 0):
        self.index = index
        self.replica = int(replica)
        self.device_floor_ms = float(device_floor_ms)
        self.inject_slow_ms = float(inject_slow_ms)
        self.inject_slow_p = float(inject_slow_p)
        self._rng = np.random.default_rng(
            seed * 1000003 + index.tablet_id * 101 + replica)
        # one logical device per worker: scan execution is serialized,
        # like a single-accelerator planner dispatch queue
        self._device_lock = threading.Lock()
        self._latency = LatencyWindow()
        # per-op span histograms (stats()["latency"]): scan / locate /
        # stats service time, same snapshot schema as every other tier
        self.tracer = Tracer("tablet")
        self._queries = 0
        self._rpcs = 0
        self._t0 = time.time()
        self.stop_event = threading.Event()
        self.server = rpc.RpcServer(sock_path, self.handle,
                                    max_inflight=max_inflight,
                                    stats_hook=self._observe)
        self.emitter = None
        if metrics_path is not None:
            self.emitter = MetricsEmitter(metrics_path, self.stats,
                                          interval_s=metrics_interval_s)

    def _observe(self, op: str, service_ms: float, shed: bool) -> None:
        if not shed:
            self._latency.record(service_ms)
            self.tracer.record(str(op), service_ms)

    def _device_execute(self, n_patterns: int):
        """The device model: serialized execution, optional per-pattern
        service floor, optional injected straggler (for the hedged-read
        bench — a replica that sometimes stalls like the paper's 771 ms
        outlier)."""
        with self._device_lock:
            dt = self.device_floor_ms * n_patterns / 1e3
            if self.inject_slow_p > 0 and \
                    self._rng.random() < self.inject_slow_p:
                dt += self.inject_slow_ms / 1e3
            if dt > 0:
                time.sleep(dt)

    def stats(self) -> dict:
        st = self.index.stats()
        st.update(self._latency.quantiles())
        st.update({"role": "worker", "replica": self.replica,
                   "pid": os.getpid(), "queries": self._queries,
                   "rpcs": self._rpcs,
                   "shed": self.server.shed_count,
                   "queue_depth": self.server.queue_depth,
                   "max_inflight": self.server.max_inflight,
                   "uptime_s": round(time.time() - self._t0, 1)})
        st["latency"] = self.tracer.snapshot()
        return st

    # -- request handling -----------------------------------------------------
    def handle(self, msg: dict) -> dict:
        op = msg.get("op")
        if op == "ping":
            return {"status": "ok", "pid": os.getpid(),
                    "tablet": self.index.tablet_id,
                    "replica": self.replica}
        if op == "stats":
            return {"status": "ok", "stats": self.stats()}
        if op == "shutdown":
            self.stop_event.set()
            return {"status": "ok"}
        if op == "scan":
            return self._handle_scan(msg)
        if op == "locate_range":
            return self._handle_locate(msg)
        return {"status": "error", "error": f"unknown op {op!r}"}

    def _handle_scan(self, msg: dict) -> dict:
        self._rpcs += 1
        reply: dict = {"status": "ok"}
        n_device = 0
        rows = msg.get("rows")
        if rows is not None and rows.shape[0]:
            n_device += int(rows.shape[0])
        drows = msg.get("drows")
        has_delta = (self.index.serves_delta and self.index.delta_len > 0)
        if drows is not None and drows.shape[0] and has_delta:
            n_device += int(drows.shape[0])
        self._device_execute(n_device)
        top_k = int(msg.get("top_k", 0))
        if rows is not None and rows.shape[0]:
            self._queries += int(rows.shape[0])
            reply.update(self.index.base_scan(rows, msg["lens"], top_k))
        if drows is not None and drows.shape[0]:
            d = self.index.delta_scan(drows, msg["dlens"], top_k)
            reply["dcount"] = d["count"]
            reply["dfirst_pos"] = d["first_pos"]
            if top_k:
                reply["dpositions"] = d["positions"]
        return reply

    def _handle_locate(self, msg: dict) -> dict:
        self._rpcs += 1
        self._queries += 1
        self._device_execute(1)
        limit = msg.get("limit")
        out = self.index.locate_range(
            np.asarray(msg["row"]), int(msg["len"]),
            int(msg.get("after", -1)),
            None if limit is None or limit < 0 else int(limit))
        return {"status": "ok", "positions": out}

    def run_forever(self) -> None:
        try:
            while not self.stop_event.wait(0.25):
                pass
        finally:
            self.shutdown()

    def shutdown(self) -> None:
        if self.emitter is not None:
            self.emitter.stop()
        self.server.stop()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="serve one tablet of a suffix table (numpy-only)")
    ap.add_argument("--manifest", required=True)
    ap.add_argument("--tablet", type=int, required=True)
    ap.add_argument("--replica", type=int, default=0)
    ap.add_argument("--sock", required=True)
    ap.add_argument("--max-inflight", type=int, default=8)
    ap.add_argument("--metrics-path", default=None)
    ap.add_argument("--metrics-interval", type=float, default=10.0)
    ap.add_argument("--device-floor-ms", type=float, default=0.0)
    ap.add_argument("--inject-slow-ms", type=float, default=0.0)
    ap.add_argument("--inject-slow-p", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    index = load_tablet(args.manifest, args.tablet)
    worker = TabletWorker(
        index, args.sock, replica=args.replica,
        max_inflight=args.max_inflight, metrics_path=args.metrics_path,
        metrics_interval_s=args.metrics_interval,
        device_floor_ms=args.device_floor_ms,
        inject_slow_ms=args.inject_slow_ms,
        inject_slow_p=args.inject_slow_p, seed=args.seed)
    signal.signal(signal.SIGTERM,
                  lambda *_: worker.stop_event.set())
    print(f"[tablet-worker] tablet={args.tablet} replica={args.replica} "
          f"ranks=[{index.rank_lo},{index.rank_hi}) "
          f"delta={index.delta_len} pid={os.getpid()}", flush=True)
    worker.run_forever()
    return 0


if __name__ == "__main__":
    sys.exit(main())
