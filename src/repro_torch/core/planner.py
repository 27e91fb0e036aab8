"""Scan planner — the single entry point for pattern lookups; the
single-device part of ``repro.core.planner`` (``MODE_SINGLE`` and
``MODE_FM``).

A live table runs every batch through ``query.query`` (the
``bounded_search`` kernel on CUDA for packed DNA), and merged reads over
delta tiers through ``kernels.ops.fused_single``.  A frozen table (an
``api.fm.FMIndex`` bound with ``fm=``) plans ``MODE_FM``: its base reads
run ``kernels.ops.fm_search`` (the ``fm_scan`` kernel on CUDA), and
merged reads add ``kernels.ops.fused_tiers`` over the delta tiers.
Broadcast and routed modes need a mesh, which is not ported yet: asking
for them raises ``NotImplementedError``.

On top of the exact scan the planner adds match enumeration
(:meth:`ScanPlanner.locate`, positions in suffix-rank order from the SA
slice ``[lb, ub)``, or LF walks on a frozen table) and an LRU result
cache for the string-level API.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from repro_torch.core import codec
from repro_torch.core import query as Q
from repro_torch.core.query import MatchResult
from repro_torch.core.tablet import TabletStore
from repro_torch.kernels import ops
from repro_torch.kernels.tier_scan import merge_tier_results
from repro_torch.serving.trace import Tracer

MODE_SINGLE = "single"
MODE_BROADCAST = "broadcast"
MODE_ROUTED = "routed"
MODE_FM = "fm"


@dataclasses.dataclass(frozen=True)
class ScanPlan:
    """One planning decision: which executor a batch will run through."""
    mode: str
    reason: str
    batch: int


@dataclasses.dataclass
class PlannerStats:
    """Counters for observability, the reference's schema; reset with
    :meth:`ScanPlanner.reset_stats`.  The ``retried_*`` counters count
    the routed mode's sentinel retries and stay 0 on one device.
    ``bucketed_batches`` / ``bucketed_queries`` count the table-level
    dispatches (``SuffixTable.scan_batch``, ``locate_range``) and their
    queries; ``pad_slots`` stays 0, since the port pads no batch to a
    bucket.
    ``fused_batches`` crossed into the fused base + delta-tier read,
    ``base_only_batches`` took the no-delta fast path, ``tier_reads``
    counts logical tier visits per kind."""
    batches: int = 0
    queries: int = 0
    cache_hits: int = 0
    cache_misses: int = 0
    retried_overflow: int = 0
    retried_saturated: int = 0
    retried_inexact_rank: int = 0
    bucketed_batches: int = 0
    bucketed_queries: int = 0
    pad_slots: int = 0
    mode_counts: dict = dataclasses.field(
        default_factory=lambda: {MODE_SINGLE: 0, MODE_BROADCAST: 0,
                                 MODE_ROUTED: 0, MODE_FM: 0})
    fused_batches: int = 0
    base_only_batches: int = 0
    tier_reads: dict = dataclasses.field(
        default_factory=lambda: {"base": 0, "runs": 0, "memtable": 0})

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["mode_counts"] = dict(self.mode_counts)
        d["tier_reads"] = dict(self.tier_reads)
        return d


@dataclasses.dataclass(frozen=True)
class TierScanResult:
    """The fused tier scan's per-tier outputs ((T, B) int32 tensors, tier
    order = the TierSet's).  ``less``/``matches`` delimit each tier's
    raw prefix-match run in its own suffix array."""
    count: torch.Tensor
    less: torch.Tensor
    matches: torch.Tensor
    first_g: torch.Tensor


class TopKCache:
    """LRU over pattern strings, top_k-aware and generation-stamped (a
    copy of ``repro.core.planner.TopKCache``): an entry cached with
    ``k_stored`` positions serves any ``top_k <= k_stored``, or any
    ``top_k`` when its position set is complete; :meth:`bump` lazily
    invalidates every older entry in O(1)."""

    def __init__(self, size: int):
        self.size = int(size)
        self.generation = 0
        self.hits = 0
        self.misses = 0
        self._d: OrderedDict[str, tuple] = OrderedDict()
        self._lock = threading.Lock()

    def get(self, pattern: str, top_k: int):
        """(count, first_pos, positions (top_k,) | None) or None on miss."""
        if self.size <= 0:
            return None
        with self._lock:
            ent = self._d.get(pattern)
            if ent is not None and ent[0] != self.generation:
                del self._d[pattern]
                ent = None
            if ent is None:
                self.misses += 1
                return None
            _gen, count, first_pos, k_stored, row = ent
            if top_k > 0 and k_stored < top_k and count > k_stored:
                self.misses += 1
                return None
            self._d.move_to_end(pattern)
            self.hits += 1
        if top_k <= 0:
            return count, first_pos, None
        out = np.full(top_k, -1, np.int64)
        if row is not None:
            take = np.asarray(row)[:top_k]
            out[:take.shape[0]] = take
        return count, first_pos, out

    def put(self, pattern: str, count: int, first_pos: int,
            k_stored: int, row) -> None:
        if self.size <= 0:
            return
        with self._lock:
            old = self._d.get(pattern)
            if (old is not None and old[0] == self.generation
                    and old[3] > k_stored):
                self._d.move_to_end(pattern)
                return
            self._d[pattern] = (self.generation, int(count), int(first_pos),
                                int(k_stored),
                                None if row is None else np.asarray(row))
            self._d.move_to_end(pattern)
            while len(self._d) > self.size:
                self._d.popitem(last=False)

    def bump(self) -> int:
        with self._lock:
            self.generation += 1
            return self.generation

    def clear(self) -> None:
        with self._lock:
            self._d.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._d)


@dataclasses.dataclass(frozen=True)
class ScanOutcome:
    """Host-side result of a string-level scan (numpy): exact counts;
    ``positions`` (B, top_k) int64, -1 padded, when ``top_k > 0``."""
    found: np.ndarray
    count: np.ndarray
    first_pos: np.ndarray
    positions: Optional[np.ndarray] = None


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to repro_torch yet "
                               f"(single-device MODE_SINGLE / MODE_FM only)")


class ScanPlanner:
    """Plans, executes and caches pattern scans over a single-device
    store, or over a frozen table's FM index when ``fm`` is bound.
    ``mesh`` raises ``NotImplementedError``."""

    def __init__(self, store: TabletStore, *, cache_size: int = 4096,
                 max_pattern_len: Optional[int] = None,
                 tracer: Optional[Tracer] = None, mesh=None, fm=None):
        if mesh is not None:
            raise _not_ported("a mesh (broadcast/routed scans)")
        self.fm = fm
        self.store = store
        self.cache_size = int(cache_size)
        self.max_pattern_len = int(max_pattern_len or store.max_query_len)
        self.stats = PlannerStats()
        self.tracer = tracer if tracer is not None else Tracer()
        self._cache = TopKCache(self.cache_size)
        self._sa_host: Optional[np.ndarray] = None

    def rebind(self, store: TabletStore, *, fm=None) -> None:
        """Swap the underlying store in place; the host SA copy is
        dropped and the result cache generation-bumped.  ``fm`` moves the
        planner onto (or off) the frozen tier: base reads then go
        through the FM index instead of ``store.sa``."""
        self.fm = fm
        self.store = store
        self.max_pattern_len = int(store.max_query_len)
        self._sa_host = None
        self._cache.bump()

    def invalidate_cache(self) -> int:
        return self._cache.bump()

    def plan(self, batch: int) -> ScanPlan:
        if self.fm is not None:
            return ScanPlan(MODE_FM, "frozen table: FM backward search",
                            batch)
        return ScanPlan(MODE_SINGLE, "no mesh / single device", batch)

    # -- encoded-batch API --------------------------------------------------
    def _check_mode(self, mode: Optional[str], B: int) -> str:
        chosen = mode or self.plan(B).mode
        if chosen == MODE_FM and self.fm is None:
            raise ValueError("mode 'fm' requires a frozen table (planner "
                             "has no FM-index bound)")
        if chosen == MODE_SINGLE and self.fm is not None:
            raise ValueError("mode 'single' needs the live suffix array, "
                             "which a frozen table has dropped")
        if chosen in (MODE_BROADCAST, MODE_ROUTED):
            raise _not_ported(f"scan mode {chosen!r}")
        if chosen not in (MODE_SINGLE, MODE_FM):
            raise ValueError(f"unknown scan mode {chosen!r}")
        return chosen

    def _check_plen(self, plen, B: int) -> None:
        if B:
            max_plen = int(plen.max())
            if max_plen > self.max_pattern_len:
                raise ValueError(
                    f"pattern length {max_plen} exceeds max_pattern_len="
                    f"{self.max_pattern_len}; compares are depth-capped, so "
                    f"longer patterns would be silently truncated — rebuild "
                    f"the store with a larger max_query_len")

    def _account(self, chosen: str, B: int) -> None:
        self.stats.batches += 1
        self.stats.queries += B
        self.stats.mode_counts[chosen] += 1

    def scan_encoded(self, patt, plen, *, mode: Optional[str] = None,
                     first_pos: bool = True) -> MatchResult:
        """Exact scan of an encoded batch (packed uint32 DNA or int32
        codes, on the store's device).  ``first_pos=False`` lets a frozen
        read skip the LF walk of every lower-bound row and report
        ``first_pos`` -1, for callers that derive text-order positions
        themselves (a live read's ``first_pos`` is one gather and is
        always filled)."""
        B = int(patt.shape[0])
        chosen = self._check_mode(mode, B)
        self._check_plen(plen, B)
        self._account(chosen, B)
        self.stats.tier_reads["base"] += 1
        if B == 0:
            z = torch.zeros(0, dtype=torch.int32, device=patt.device)
            return MatchResult(found=z.to(torch.bool), count=z,
                               first_rank=z, first_pos=z)
        with self.tracer.span("dispatch_" + chosen):
            if chosen == MODE_FM:
                return ops.fm_search(self.fm.arrays, patt, plen,
                                     first_pos=first_pos)
            return Q.query(self.store, patt, plen)

    def scan_tiers(self, tierset, patt, plen, *, mode: Optional[str] = None,
                   first_pos: bool = True
                   ) -> tuple[MatchResult, Optional[TierScanResult]]:
        """Merged read over base + every delta tier of ``tierset`` (an
        ``api.runs.TierSet`` or None): the MERGED MatchResult plus the
        per-tier :class:`TierScanResult` (None on the base-only path).
        ``first_pos`` as in :meth:`scan_encoded`."""
        B = int(patt.shape[0])
        if tierset is None or tierset.num_tiers == 0 or B == 0:
            res = self.scan_encoded(patt, plen, mode=mode,
                                    first_pos=first_pos)
            self.stats.base_only_batches += 1
            return res, None
        chosen = self._check_mode(mode, B)
        self._check_plen(plen, B)
        n_runs = sum(1 for k in tierset.kinds if k == "run")
        if chosen == MODE_SINGLE:
            self._account(chosen, B)
            self.stats.tier_reads["base"] += 1
            with self.tracer.span("dispatch_fused"):
                merged, _base, tiers = ops.fused_single(
                    self.store, tierset.stack, patt, plen)
        else:
            # frozen base: the FM read (scan_encoded does its accounting),
            # then every delta tier in one scan, then the merge
            base = self.scan_encoded(patt, plen, mode=chosen,
                                     first_pos=first_pos)
            with self.tracer.span("dispatch_fused"):
                tiers = ops.fused_tiers(tierset.stack, patt, plen)
                merged = merge_tier_results(base, tiers[0], tiers[3])
        self.stats.fused_batches += 1
        self.stats.tier_reads["runs"] += n_runs
        self.stats.tier_reads["memtable"] += tierset.num_tiers - n_runs
        return merged, TierScanResult(count=tiers[0], less=tiers[1],
                                      matches=tiers[2], first_g=tiers[3])

    # -- match enumeration --------------------------------------------------
    def _sa(self) -> np.ndarray:
        if self._sa_host is None:
            self._sa_host = self.store.sa.cpu().numpy()
        return self._sa_host

    def locate_encoded(self, patt, plen, top_k: int = 8, *,
                       mode: Optional[str] = None) -> np.ndarray:
        res = self.scan_encoded(patt, plen, mode=mode)
        return self.positions_from_result(res, top_k)

    def positions_from_result(self, res: MatchResult,
                              top_k: int = 8) -> np.ndarray:
        """Up to ``top_k`` positions per query from the SA slice
        ``[lb, lb + min(count, top_k))`` (suffix-rank order), -1 padded."""
        count = res.count.cpu().numpy()
        found = res.found.cpu().numpy()
        first_rank = res.first_rank.cpu().numpy()
        if self.fm is not None:
            # frozen tier: no SA to slice — LF-walk the SA$ rows
            # [lo, lo + min(count, top_k)) back to text positions
            k = np.arange(max(int(top_k), 1))[None, :]
            rows = first_rank[:, None] + 1 + k           # SA$ row = rank + 1
            valid = ((found & (first_rank >= 0))[:, None]
                     & (k < count[:, None]))
            rows = np.clip(rows, 1, self.fm.n)
            pos = self.fm.ranks_to_positions(rows).cpu().numpy()
            return np.where(valid, pos, -1)[:, :top_k].astype(np.int64)
        sa = self._sa()
        lb = first_rank + self.store.pad_count
        k = np.arange(max(int(top_k), 1))[None, :]
        idx = lb[:, None] + k
        valid = (found & (first_rank >= 0))[:, None] & (k < count[:, None])
        idx = np.clip(idx, 0, sa.shape[0] - 1)
        return np.where(valid, sa[idx], -1)[:, :top_k].astype(np.int64)

    # -- string-level API with LRU cache ------------------------------------
    def encode(self, patterns: list[str]):
        """Pattern strings -> (patt, plen) on the store's device: packed
        uint32 words for DNA stores, exact-width int32 codes otherwise.
        Raises on a pattern longer than ``max_pattern_len``."""
        for p in patterns:
            if len(p) > self.max_pattern_len:
                raise ValueError(
                    f"pattern of length {len(p)} exceeds max_pattern_len="
                    f"{self.max_pattern_len} ({p[:32]!r}...); compares are "
                    f"depth-capped, so it would be silently truncated")
        dev = self.store.device
        if self.store.is_dna:
            width = (codec.packed_length(self.max_pattern_len)
                     * codec.BASES_PER_WORD)
            _codes, packed, lengths = Q.encode_patterns(patterns, width,
                                                        device=dev)
            return packed, lengths
        codes, _packed, lengths = Q.encode_patterns(
            patterns, self.max_pattern_len, device=dev)
        return codes, lengths

    def scan(self, patterns: list[str], top_k: int = 0) -> ScanOutcome:
        """Scan pattern strings over the base store; exact counts,
        optional suffix-rank-order enumeration, LRU-cached."""
        B = len(patterns)
        count = np.full(B, -1, np.int64)
        first_pos = np.full(B, -1, np.int64)
        positions = (np.full((B, top_k), -1, np.int64) if top_k else None)
        miss_idx: list[int] = []
        for i, pat in enumerate(patterns):
            hit = self._cache.get(pat, top_k)
            if hit is not None:
                count[i], first_pos[i] = hit[0], hit[1]
                if top_k:
                    positions[i] = hit[2]
            else:
                miss_idx.append(i)
        self.stats.cache_hits += B - len(miss_idx)
        self.stats.cache_misses += len(miss_idx)
        if miss_idx:
            patt, plen = self.encode([patterns[i] for i in miss_idx])
            res = self.scan_encoded(patt, plen)
            sub_count = res.count.cpu().numpy()
            sub_first = res.first_pos.cpu().numpy()
            sub_pos = (self.positions_from_result(res, top_k)
                       if top_k else None)
            for j, i in enumerate(miss_idx):
                count[i] = sub_count[j]
                first_pos[i] = sub_first[j]
                row = sub_pos[j] if top_k else None
                if top_k:
                    positions[i] = row
                self._cache.put(patterns[i], int(sub_count[j]),
                                int(sub_first[j]), top_k, row)
        return ScanOutcome(found=count > 0, count=count,
                           first_pos=first_pos, positions=positions)

    def locate(self, patterns: list[str], top_k: int = 8) -> np.ndarray:
        return self.scan(patterns, top_k=top_k).positions

    def clear_cache(self) -> None:
        self._cache.clear()

    def reset_stats(self) -> None:
        self.stats = PlannerStats()
