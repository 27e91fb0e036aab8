"""Tablet router — the client half of the serving plane; the port's own
copy of ``repro.serving.router``.

Bigtable clients cache the METADATA tablet map, send each read straight
to the tablet server owning its row range, and merge.  This module is
that client: :class:`TabletRouter` routes every pattern to the tablets
whose rank-key range can contain it (docs/serving_plane.md has the
range math), fans the per-tablet RPCs out concurrently, and merges the
replies into exactly the result a single-process ``SuffixTable`` would
return.  :class:`RemoteTable` wraps a router in the ``SuffixTable`` scan
surface (``scan`` / ``scan_batch`` / ``locate_range``), so the existing
``Database`` / ``QueryScheduler`` / ``ReadSession`` frontend
(``repro_torch.api.client``) drives a multi-process deployment
unchanged.

Reliability semantics, in router order:

* **admission** — per-tenant :class:`TokenBucket` quotas are charged
  BEFORE any RPC leaves the process (``admit``); an over-quota tenant is
  shed locally with the typed ``OVERLOADED`` result, costing the plane
  nothing;
* **hedging** — with ``hedge_enabled`` and a replica available, a
  request still unanswered after ``hedge_deadline_ms`` fires a backup
  RPC to a different process; first success wins, the loser's reply is
  discarded (each call holds its own pooled connection, so a late loser
  can never corrupt a later exchange);
* **failover** — a dead or shedding replica (``RpcError`` / worker
  ``overloaded``) falls through to the next replica; only when every
  replica of some needed tablet sheds does the caller see
  :class:`OverloadedError`.

Numpy-only on purpose (no torch import): client processes route without
paying the accelerator runtime's start-up.
"""
from __future__ import annotations

import concurrent.futures as cf
import json
import os
import threading
import time
from typing import Optional, Sequence

import numpy as np

from repro_torch.serving import rpc
from repro_torch.serving.metrics import LatencyWindow, MetricsEmitter
from repro_torch.serving.tablet_server import encode_pattern_rows
from repro_torch.serving.trace import Tracer


class OverloadedError(RuntimeError):
    """Every replica of a needed tablet shed the request (or the tenant
    is over quota).  The message starts with ``OVERLOADED`` so the typed
    marker survives the trip through a ``QueryResult.error`` string."""

    def __init__(self, detail: str):
        super().__init__(f"OVERLOADED: {detail}")


class TokenBucket:
    """Per-tenant admission quota: ``rate_per_s`` sustained, ``burst``
    peak.  ``try_acquire(n)`` charges n patterns and answers whether the
    tenant is inside its quota — it never blocks (shedding beats
    queueing; the caller turns False into an ``OVERLOADED`` result)."""

    def __init__(self, rate_per_s: float, burst: float):
        if rate_per_s <= 0 or burst <= 0:
            raise ValueError("rate_per_s and burst must be > 0")
        self.rate = float(rate_per_s)
        self.burst = float(burst)
        self._tokens = float(burst)
        self._t_last = time.monotonic()
        self._lock = threading.Lock()

    def try_acquire(self, n: float = 1.0) -> bool:
        with self._lock:
            now = time.monotonic()
            self._tokens = min(self.burst,
                               self._tokens + (now - self._t_last) * self.rate)
            self._t_last = now
            if self._tokens >= n:
                self._tokens -= n
                return True
            return False


def _unpack_2bit(words: np.ndarray) -> np.ndarray:
    """(B, W) packed uint32 DNA words -> (B, 16 W) int32 code rows —
    the numpy mirror of the codec's packed layout (big-endian: base i of
    a word at bit 30−2i), kept here so the router never imports the
    torch-backed codec module."""
    words = np.asarray(words, dtype=np.uint32)
    shifts = (30 - 2 * np.arange(16)).astype(np.uint32)
    lanes = (words[:, :, None] >> shifts[None, None, :]) & np.uint32(3)
    return lanes.reshape(words.shape[0], -1).astype(np.int32)


class _Overloaded(Exception):
    """Internal: one replica shed; the router may still fail over."""


class TabletRouter:
    """Routes pattern batches across tablet workers and merges replies.

    ``manifest`` is the table's ``tablets/manifest.json`` dict;
    ``endpoints`` is ``[[sock, sock, ...], ...]`` — one socket list per
    tablet, replica 0 first (the ``tablets/serving.json`` layout
    :class:`repro_torch.serving.plane.ServingPlane` writes).
    """

    def __init__(self, manifest: dict, endpoints: Sequence[Sequence[str]], *,
                 hedge_deadline_ms: float = 50.0, hedge_enabled: bool = True,
                 rpc_timeout_s: float = 30.0,
                 metrics_path: Optional[str] = None,
                 metrics_interval_s: float = 0.0):
        if len(endpoints) != manifest["n_tablets"]:
            raise ValueError(
                f"manifest has {manifest['n_tablets']} tablets but "
                f"{len(endpoints)} endpoint lists were given")
        self.manifest = manifest
        self.n_tablets = int(manifest["n_tablets"])
        self.owner = self.n_tablets - 1      # delta-owner tablet
        # split keys: tablet i serves suffixes in [key_i, key_{i+1});
        # key_0 is implicitly -inf, key_{n} +inf
        self._keys = [np.asarray(t["key"], np.int32)
                      for t in manifest["tablets"]]
        self._clients = [[rpc.RpcClient(p, timeout=rpc_timeout_s)
                          for p in reps] for reps in endpoints]
        self.hedge_deadline_ms = float(hedge_deadline_ms)
        self.hedge_enabled = bool(hedge_enabled)
        # separate pools: fan-out tasks block on hedge futures, so they
        # must never compete for the same worker slots (deadlock)
        self._fanout = cf.ThreadPoolExecutor(
            max_workers=max(8, 2 * self.n_tablets),
            thread_name_prefix="router-fanout")
        max_reps = max(len(r) for r in endpoints)
        self._hedge = cf.ThreadPoolExecutor(
            max_workers=max(8, 4 * self.n_tablets * max_reps),
            thread_name_prefix="router-hedge")
        self._stats_lock = threading.Lock()
        self.hedge_fired = 0
        self.hedge_wins = 0
        self.failovers = 0
        self.quota_shed = 0
        self.rpcs = 0
        self._latency = LatencyWindow()
        # span histograms (stats()["latency"]): dispatch_remote (one
        # logical tablet read: hedge + failover walk) and hedge_wait
        # (hedge fired -> first success) — docs/observability.md
        self.tracer = Tracer("router")
        self._quotas: dict[str, TokenBucket] = {}
        self.emitter = None
        if metrics_path is not None:
            self.emitter = MetricsEmitter(metrics_path, self.stats,
                                          interval_s=metrics_interval_s)

    # -- admission (the quota half; the worker holds the queue half) ---------
    def set_quota(self, tenant: str, rate_per_s: float,
                  burst: Optional[float] = None) -> None:
        """Cap ``tenant`` at ``rate_per_s`` patterns/s (peak ``burst``,
        default 2x the rate).  Tenants without a quota are unmetered."""
        self._quotas[str(tenant)] = TokenBucket(
            rate_per_s, burst if burst is not None else 2.0 * rate_per_s)

    def admit(self, tenant: Optional[str], n_patterns: int) -> bool:
        """Charge ``tenant`` for ``n_patterns``; False = shed locally."""
        if tenant is None:
            return True
        bucket = self._quotas.get(str(tenant))
        if bucket is None or bucket.try_acquire(n_patterns):
            return True
        with self._stats_lock:
            self.quota_shed += n_patterns
        return False

    # -- tablet RPC with hedging + failover ----------------------------------
    def _try_replica(self, tid: int, rep: int, msg: dict) -> dict:
        reply = self._clients[tid][rep].call(msg)
        status = reply.get("status")
        if status == "overloaded":
            raise _Overloaded(
                f"tablet {tid} replica {rep} queue at "
                f"{reply.get('queue_depth')}")
        if status != "ok":
            raise rpc.RpcError(
                f"tablet {tid} replica {rep}: {reply.get('error')}")
        return reply

    def _call_tablet(self, tid: int, msg: dict) -> dict:
        """One logical tablet read: hedge across replicas, fail over on
        transport errors and worker sheds, raise only when every replica
        is gone (RpcError) or shedding (OverloadedError).  The whole
        walk is one ``dispatch_remote`` span (recorded on error too)."""
        with self.tracer.span("dispatch_remote"):
            return self._call_tablet_inner(tid, msg)

    def _call_tablet_inner(self, tid: int, msg: dict) -> dict:
        with self._stats_lock:
            self.rpcs += 1
        clients = self._clients[tid]
        if self.hedge_enabled and len(clients) > 1:
            reply = self._call_hedged(tid, msg)
            if reply is not None:
                return reply
        # serial failover walk (also the hedged path's last resort)
        overloads, last_err = 0, None
        for rep in range(len(clients)):
            try:
                reply = self._try_replica(tid, rep, msg)
                if rep > 0:
                    with self._stats_lock:
                        self.failovers += 1
                return reply
            except _Overloaded as e:
                overloads += 1
                last_err = e
            except rpc.RpcError as e:
                last_err = e
        if overloads:
            raise OverloadedError(f"all {len(clients)} replicas of tablet "
                                  f"{tid} shed ({last_err})")
        raise rpc.RpcError(f"every replica of tablet {tid} failed: "
                           f"{last_err}")

    def _call_hedged(self, tid: int, msg: dict) -> Optional[dict]:
        """Primary + (after ``hedge_deadline_ms``) one backup on a
        different replica; first success wins.  ``None`` means both
        attempts died and the caller should walk the failover path."""
        primary = self._hedge.submit(self._try_replica, tid, 0, msg)
        try:
            return primary.result(timeout=self.hedge_deadline_ms / 1e3)
        except cf.TimeoutError:
            pass
        except (_Overloaded, rpc.RpcError):
            return None                    # fast failure: no hedge needed
        with self._stats_lock:
            self.hedge_fired += 1
        with self.tracer.span("hedge_wait"):
            backup = self._hedge.submit(self._try_replica, tid, 1, msg)
            pending = {primary, backup}
            while pending:
                done, pending = cf.wait(pending,
                                        return_when=cf.FIRST_COMPLETED)
                for fut in done:
                    try:
                        reply = fut.result()
                    except (_Overloaded, rpc.RpcError):
                        continue
                    if fut is backup:
                        with self._stats_lock:
                            self.hedge_wins += 1
                    return reply           # loser's reply is discarded
            return None

    # -- routing -------------------------------------------------------------
    def _prefix_cmp(self, row: np.ndarray, length: int,
                    key: np.ndarray) -> int:
        """Compare pattern prefix to a split key over their common
        depth: −1 / +1 on the first differing symbol, 0 when one is a
        prefix of the other (ambiguous — the pattern's rank range may
        straddle this boundary, so the caller must include both sides)."""
        m = min(int(length), int(key.shape[0]))
        a, b = row[:m], key[:m]
        neq = np.flatnonzero(a != b)
        if neq.size == 0:
            return 0
        j = int(neq[0])
        return -1 if int(a[j]) < int(b[j]) else 1

    def candidates(self, row: np.ndarray, length: int) -> list[int]:
        """Tablets whose rank range can hold suffixes starting with this
        pattern.  Sound by construction: a tablet is EXCLUDED only when
        the whole pattern range provably sorts outside its key range
        (strict prefix compare), so no occurrence can be missed — an
        over-included tablet just answers zero."""
        out = []
        for tid in range(self.n_tablets):
            if tid > 0 and self._prefix_cmp(row, length,
                                            self._keys[tid]) < 0:
                continue               # every p-suffix sorts before tablet
            if tid + 1 < self.n_tablets and \
                    self._prefix_cmp(row, length, self._keys[tid + 1]) > 0:
                continue               # every p-suffix sorts after tablet
            out.append(tid)
        return out

    # -- the merged scan ------------------------------------------------------
    def scan_rows(self, rows: np.ndarray, lens: np.ndarray,
                  top_k: int = 0) -> dict:
        """Scan a decoded (B, L) int32 batch across the plane and merge
        to single-process semantics: count = Σ per-tablet counts (+ the
        owner's delta count), first_pos = min, positions = ascending
        top-k of the union (docs/serving_plane.md proves each)."""
        t0 = time.perf_counter()
        rows = np.ascontiguousarray(rows).astype(np.int32)
        lens = np.asarray(lens).astype(np.int64)
        B = rows.shape[0]
        per_tablet: dict[int, list[int]] = {}
        for i in range(B):
            for tid in self.candidates(rows[i], int(lens[i])):
                per_tablet.setdefault(tid, []).append(i)
        futures = {}
        for tid in range(self.n_tablets):
            idx = per_tablet.get(tid, [])
            if not idx and tid != self.owner:
                continue
            msg: dict = {"op": "scan", "top_k": int(top_k)}
            if idx:
                sub = np.asarray(idx, np.int64)
                msg["rows"] = rows[sub]
                msg["lens"] = lens[sub]
            if tid == self.owner:
                # the delta tier is unpartitioned: its owner always sees
                # the full batch (delta-empty planes short-circuit it)
                msg["drows"] = rows
                msg["dlens"] = lens
            futures[tid] = (self._fanout.submit(self._call_tablet, tid,
                                                msg),
                            per_tablet.get(tid, []))
        count = np.zeros(B, np.int64)
        first = np.full(B, -1, np.int64)
        parts: list[list[np.ndarray]] = [[] for _ in range(B)]
        for tid, (fut, idx) in futures.items():
            reply = fut.result()
            if idx:
                sub = np.asarray(idx, np.int64)
                self._merge_rows(count, first, parts, sub,
                                 reply["count"], reply["first_pos"],
                                 reply.get("positions"), top_k)
            if tid == self.owner and "dcount" in reply:
                all_rows = np.arange(B, dtype=np.int64)
                self._merge_rows(count, first, parts, all_rows,
                                 reply["dcount"], reply["dfirst_pos"],
                                 reply.get("dpositions"), top_k)
        positions = None
        if top_k:
            positions = np.full((B, top_k), -1, np.int64)
            for i in range(B):
                if parts[i]:
                    cand = np.concatenate(parts[i])
                    cand = cand[cand >= 0]
                    if cand.shape[0] > top_k:
                        cand = np.partition(cand, top_k - 1)[:top_k]
                    cand.sort()
                    positions[i, :cand.shape[0]] = cand
        self._latency.record((time.perf_counter() - t0) * 1e3)
        return {"found": count > 0, "count": count, "first_pos": first,
                "positions": positions}

    @staticmethod
    def _merge_rows(count, first, parts, idx, sub_count, sub_first,
                    sub_pos, top_k) -> None:
        count[idx] += np.asarray(sub_count, np.int64)
        sf = np.asarray(sub_first, np.int64)
        cur = first[idx]
        first[idx] = np.where(cur < 0, sf,
                              np.where(sf < 0, cur, np.minimum(cur, sf)))
        if top_k and sub_pos is not None:
            for j, i in enumerate(np.asarray(idx)):
                parts[int(i)].append(np.asarray(sub_pos[j], np.int64))

    def locate_rows(self, row: np.ndarray, length: int, *,
                    after: int = -1,
                    limit: Optional[int] = None) -> np.ndarray:
        """Merged paged enumeration of one decoded pattern row: each
        tablet returns its ascending positions ``> after`` capped at
        ``limit``; keeping the smallest ``limit`` of the union is exact
        because every tablet stream is individually complete-from-
        ``after``."""
        row = np.ascontiguousarray(row).astype(np.int32)
        msg_limit = -1 if limit is None else int(limit)
        # the owner joins even when it is not a base candidate: it may
        # still hold delta-tier occurrences of the pattern
        tablets = set(self.candidates(row, length)) | {self.owner}
        msg = {"op": "locate_range", "row": row, "len": int(length),
               "after": int(after), "limit": msg_limit}
        futures = [self._fanout.submit(self._call_tablet, tid, dict(msg))
                   for tid in sorted(tablets)]
        cands = [np.asarray(fut.result()["positions"], np.int64)
                 for fut in futures]
        cand = (np.concatenate(cands) if cands
                else np.zeros((0,), np.int64))
        cand.sort()
        if limit is not None and cand.shape[0] > limit:
            cand = cand[:limit]
        return cand

    # -- observability / lifecycle -------------------------------------------
    def stats(self) -> dict:
        with self._stats_lock:
            st = {"role": "router", "pid": os.getpid(),
                  "n_tablets": self.n_tablets, "rpcs": self.rpcs,
                  "hedge_fired": self.hedge_fired,
                  "hedge_wins": self.hedge_wins,
                  "failovers": self.failovers,
                  "quota_shed": self.quota_shed,
                  "hedge_enabled": self.hedge_enabled}
        st.update(self._latency.quantiles())
        st["latency"] = self.tracer.snapshot()
        return st

    def ping_all(self, *, timeout: float = 1.0) -> list[list[bool]]:
        return [[c.ping(timeout=timeout) for c in reps]
                for reps in self._clients]

    def close(self) -> None:
        if self.emitter is not None:
            self.emitter.stop()
        self._fanout.shutdown(wait=False)
        self._hedge.shutdown(wait=False)
        for reps in self._clients:
            for c in reps:
                c.close()


# ---------------------------------------------------------------------------
# the SuffixTable-shaped facade
# ---------------------------------------------------------------------------
class _RemoteOutcome:
    """Duck-typed ``ScanOutcome`` (found/count/first_pos/positions) —
    defined here so the router stack never imports the torch-backed
    planner module."""

    __slots__ = ("found", "count", "first_pos", "positions")

    def __init__(self, found, count, first_pos, positions):
        self.found = found
        self.count = count
        self.first_pos = first_pos
        self.positions = positions


class RemoteTable:
    """A ``SuffixTable``-shaped handle served by the tablet plane.

    Attach one to a :class:`repro_torch.api.client.Database` (or let
    ``Database.connect_plane`` do it) and the whole typed frontend —
    ``Query`` kinds, coalescing, ``ReadSession`` paging — runs against
    the multi-process deployment unchanged.  Read-only: the plane serves
    a frozen snapshot + WAL tail, so there is no append path and
    ``write_generation`` is constant.

    ``supports_concurrent_scans`` tells the ``QueryScheduler`` NOT to
    serialize dispatches to this table: concurrency here IS the point
    (each dispatch fans out to different worker processes), and the
    single-table lock that protects an in-process table's tier view
    would re-serialize the plane back to one-worker throughput.
    """

    is_remote = True
    supports_concurrent_scans = True
    write_generation = 0

    def __init__(self, router: TabletRouter, *, name: str, is_dna: bool,
                 max_query_len: int):
        self.router = router
        self.name = name
        self.is_dna = bool(is_dna)
        self.max_query_len = int(max_query_len)

    @classmethod
    def from_manifest(cls, router: TabletRouter) -> "RemoteTable":
        m = router.manifest
        return cls(router, name=m["table"], is_dna=bool(m["is_dna"]),
                   max_query_len=int(m["max_query_len"]))

    # -- admission hook consulted by the QueryScheduler ----------------------
    def admit(self, tenant: Optional[str], n_patterns: int) -> bool:
        return self.router.admit(tenant, n_patterns)

    # -- the scan surface ----------------------------------------------------
    def _check_lens(self, lens: np.ndarray) -> None:
        if lens.size and int(lens.max()) > self.max_query_len:
            raise ValueError(
                f"pattern of length {int(lens.max())} exceeds "
                f"max_query_len={self.max_query_len}; compares are "
                f"depth-capped, so it would be silently truncated")

    def scan(self, patterns: list[str], top_k: int = 0) -> _RemoteOutcome:
        rows, lens = encode_pattern_rows(list(patterns))
        self._check_lens(lens)
        out = self.router.scan_rows(rows, lens, top_k=top_k)
        return _RemoteOutcome(out["found"], out["count"],
                              out["first_pos"], out["positions"])

    def scan_batch(self, patt, plen, top_k: int = 0) -> _RemoteOutcome:
        """Encoded-batch scan: packed uint32 DNA words (the planner's
        DNA encoding) are unpacked host-side; int32 code rows pass
        through."""
        patt = np.asarray(patt)
        lens = np.asarray(plen).astype(np.int64)
        self._check_lens(lens)
        rows = (_unpack_2bit(patt) if patt.dtype == np.uint32
                else patt.astype(np.int32))
        out = self.router.scan_rows(rows, lens, top_k=top_k)
        return _RemoteOutcome(out["found"], out["count"],
                              out["first_pos"], out["positions"])

    def locate_range(self, pattern: str, *, after: int = -1,
                     limit: Optional[int] = 256) -> np.ndarray:
        if limit is not None and limit <= 0:
            raise ValueError(f"limit must be positive, got {limit}")
        rows, lens = encode_pattern_rows([pattern])
        self._check_lens(lens)
        return self.router.locate_rows(rows[0], int(lens[0]),
                                       after=after, limit=limit)

    def count(self, patterns: list[str]) -> np.ndarray:
        return self.scan(list(patterns)).count

    def contains(self, patterns: list[str]) -> np.ndarray:
        return self.scan(list(patterns)).found

    def locate(self, patterns: list[str], top_k: int = 8) -> np.ndarray:
        return self.scan(list(patterns), top_k=top_k).positions

    def stats(self) -> dict:
        return {"name": self.name, "remote": True,
                "is_dna": self.is_dna,
                "max_query_len": self.max_query_len,
                "router": self.router.stats()}

    def close(self) -> None:
        self.router.close()


def connect(root: str, name: str, **router_kw) -> RemoteTable:
    """Open a served table by root/name: reads the ``tablets/`` manifest
    (METADATA) and ``serving.json`` (live endpoints) and returns a
    routed handle.  Use from any process — e.g. a second client process
    against a plane another process launched."""
    tdir = os.path.join(root, name, "tablets")
    with open(os.path.join(tdir, "manifest.json")) as f:
        manifest = json.load(f)
    with open(os.path.join(tdir, "serving.json")) as f:
        serving = json.load(f)
    router = TabletRouter(manifest, serving["endpoints"], **router_kw)
    return RemoteTable.from_manifest(router)
