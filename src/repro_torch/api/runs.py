"""Immutable LSM runs — the port of ``repro.api.runs`` (in memory).

Tier layout, with ``start_i`` the logical text length when run *i* was
sealed (``end_i = start_i + len(codes_i)``)::

    base [0, n_base) | run 0 [start_0, end_0) | run 1 ... | memtable

Every occurrence ends in exactly one tier: the base reports ``g + plen
<= n_base``, run *i* reports ``start_i < g + plen <= end_i``, the
memtable what ends past the last run.  A run's store is built over its
overlap window (the last ``max_query_len - 1`` symbols before it) plus
its codes, padded with symbol 0 to a power-of-two length; the two-sided
rule makes the padding inert.  A persisted run keeps its suffix array
(``Run.sa_padded``), so ``Run.restore`` brings the index back without a
sort.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from repro_torch.core import query as Q
from repro_torch.core.tablet import (MAX_POSITIONS, TabletStore,
                                     TierStack, build_tablet_store,
                                     stack_tier_stores, store_from_arrays)
from repro_torch.device import DeviceLike


def bucket_rows(n: int) -> int:
    """Next power of two >= n (floor 16): text padding for run/memtable
    stores, so their shapes take O(log appends) distinct values."""
    return 1 << max(4, (max(n, 1) - 1).bit_length())


def padded_segment_store(text: np.ndarray, *, is_dna: bool,
                         max_query_len: int,
                         device: DeviceLike = None) -> TabletStore:
    """Single-device store over ``text`` padded to a power-of-two length
    with symbol 0 (the pad symbols are REAL to the store)."""
    n = int(text.shape[0])
    padded = np.pad(text, (0, bucket_rows(n) - n))
    return build_tablet_store(padded, is_dna=is_dna,
                              max_query_len=max_query_len, device=device)


def positions_in_bounds(store: TabletStore, sa_host: np.ndarray,
                        patt, plen, *, offset: int, lo: int,
                        hi: int) -> list[np.ndarray]:
    """Query ``store`` and return, per query, the ascending GLOBAL start
    positions of occurrences with ``lo < g + plen <= hi`` — the tier's
    exact contribution, the per-tier oracle of the fused read."""
    plen_np = plen.cpu().numpy()
    B = int(plen_np.shape[0])
    empty = np.zeros((0,), np.int64)
    if B == 0:
        return []
    res = Q.query(store, patt, plen)
    count = res.count.cpu().numpy()
    rank = res.first_rank.cpu().numpy()
    pad = store.pad_count
    out = []
    for i in range(B):
        c = int(count[i])
        if c <= 0 or rank[i] < 0:
            out.append(empty)
            continue
        lb = pad + int(rank[i])
        g = sa_host[lb:lb + c].astype(np.int64) + offset
        e = g + int(plen_np[i])
        g = g[(e > lo) & (e <= hi)]
        g.sort()
        out.append(g)
    return out


def logical_tail(segments: list[np.ndarray], k: int) -> np.ndarray:
    """Last ``k`` symbols of ``concatenate(segments)`` without building
    the concatenation."""
    if k <= 0:
        return np.zeros((0,), segments[0].dtype if segments else np.uint8)
    parts: list[np.ndarray] = []
    need = k
    for seg in reversed(segments):
        if need <= 0:
            break
        seg = np.asarray(seg)
        take = seg[max(0, seg.shape[0] - need):]
        if take.size:
            parts.append(take)
            need -= int(take.shape[0])
    parts.reverse()
    if not parts:
        return np.zeros((0,), segments[0].dtype if segments else np.uint8)
    return np.ascontiguousarray(np.concatenate(parts))


class Run:
    """One immutable LSM run: a sealed memtable.  ``tail`` is the overlap
    window, ``codes`` the run's appended symbols; the suffix index over
    ``tail + codes`` is taken from the sealing memtable, or built lazily
    on ``device``."""

    def __init__(self, tail: np.ndarray, codes: np.ndarray, *, start: int,
                 is_dna: bool, max_query_len: int, device: torch.device,
                 store: Optional[TabletStore] = None,
                 sa_host: Optional[np.ndarray] = None):
        self.tail = np.ascontiguousarray(tail)
        self.codes = np.ascontiguousarray(codes)
        self.start = int(start)
        self.length = int(self.codes.shape[0])
        self.is_dna = bool(is_dna)
        self.max_query_len = int(max_query_len)
        self.overlap = int(self.tail.shape[0])
        self.device = device
        self._store = store
        self._sa_host = sa_host

    @property
    def end(self) -> int:
        return self.start + self.length

    @classmethod
    def from_memtable(cls, mem) -> "Run":
        """Seal a memtable: freeze its codes, window and store."""
        mem._ensure_store()
        return cls(mem._tail, mem.appended.copy(), start=mem.n_base,
                   is_dna=mem.is_dna, max_query_len=mem.max_query_len,
                   device=mem.device, store=mem._store,
                   sa_host=mem._sa_host)

    def _ensure_store(self) -> TabletStore:
        if self._store is None:
            text = np.concatenate([self.tail, self.codes])
            self._store = padded_segment_store(
                text, is_dna=self.is_dna, max_query_len=self.max_query_len,
                device=self.device)
            self._sa_host = self._store.sa.cpu().numpy()
        return self._store

    @property
    def sa_padded(self) -> np.ndarray:
        """The run's full suffix array over its padded text, int32 on the
        host (persisted so ``open`` restores the index, not rebuilds
        it)."""
        self._ensure_store()
        return self._sa_host

    @classmethod
    def restore(cls, tail: np.ndarray, codes: np.ndarray, sa_padded, *,
                start: int, is_dna: bool, max_query_len: int,
                device: torch.device) -> "Run":
        """A run from persisted arrays (no suffix sort); without
        ``sa_padded`` its index is built lazily."""
        run = cls(tail, codes, start=start, is_dna=is_dna,
                  max_query_len=max_query_len, device=device)
        if sa_padded is not None:
            text = np.concatenate([run.tail, run.codes])
            n = int(text.shape[0])
            padded = np.pad(text, (0, bucket_rows(n) - n))
            run._store = store_from_arrays(
                padded, np.asarray(sa_padded, np.int32), is_dna=is_dna,
                max_query_len=max_query_len, device=device)
            run._sa_host = run._store.sa.cpu().numpy()
        return run

    def match_positions(self, patt, plen) -> list[np.ndarray]:
        """Global start positions, ascending, of exactly the occurrences
        this run owns: ``start < g + plen <= end``."""
        B = int(plen.shape[0])
        if self.length == 0 or B == 0:
            return [np.zeros((0,), np.int64)] * B
        store = self._ensure_store()
        return positions_in_bounds(store, self._sa_host, patt, plen,
                                   offset=self.start - self.overlap,
                                   lo=self.start, hi=self.end)


class TierSet:
    """All delta tiers of a table as ONE stacked device view plus the
    host-side suffix arrays that enumerate matches.  Immutable snapshot;
    tier order is runs (oldest first) then the memtable."""

    def __init__(self, stores, offsets, bounds, kinds):
        self.stack: TierStack = stack_tier_stores(
            stores, offsets=offsets, bounds=bounds)
        self.offsets = np.asarray(offsets, np.int64)
        self.los = np.asarray([b[0] for b in bounds], np.int64)
        self.his = np.asarray([b[1] for b in bounds], np.int64)
        self.kinds = tuple(kinds)
        self.num_tiers = len(stores)

    @classmethod
    def build(cls, runs, memtable) -> Optional["TierSet"]:
        """Snapshot the live tiers (non-empty runs, then the memtable if
        it has appends); None when there are none."""
        stores, offsets, bounds, kinds = [], [], [], []
        for r in runs:
            if r.length == 0:
                continue
            stores.append(r._ensure_store())
            offsets.append(r.start - r.overlap)
            bounds.append((r.start, r.end))
            kinds.append("run")
        if memtable is not None and memtable.size > 0:
            stores.append(memtable._ensure_store())
            offsets.append(memtable.n_base - memtable.overlap)
            bounds.append((memtable.n_base,
                           memtable.n_base + memtable.size))
            kinds.append("memtable")
        if not stores:
            return None
        return cls(stores, offsets, bounds, kinds)

    @functools.cached_property
    def sa_host(self) -> np.ndarray:
        """(T, rows) int64: every tier's suffix array on the host, pad
        rows 0; copied on the first read that enumerates delta rows."""
        return self.stack.sa.cpu().numpy().astype(np.int64)

    @staticmethod
    def first_positions(first_g) -> np.ndarray:
        """Per query, its smallest GLOBAL position owned by any delta
        tier, (B,) int64 with -1 where none, from the fused scan's
        ``first_g`` ((T, B), ``MAX_POSITIONS`` where a tier owns none):
        the head of :meth:`delta_positions`, with no rows copied to the
        host, for a read that needs only the first position."""
        first = first_g.min(dim=0).values.cpu().numpy().astype(np.int64)
        return np.where(first < MAX_POSITIONS, first, -1)

    def delta_positions(self, tless, tmatch, plen) -> list[np.ndarray]:
        """Per query, the ascending GLOBAL positions owned by any delta
        tier, from the fused scan's ``less``/``matches`` ((T, B)) by host
        slicing of each tier's SA."""
        tless = tless.cpu().numpy()
        tmatch = tmatch.cpu().numpy()
        plen_np = plen.cpu().numpy()
        B = int(plen_np.shape[0])
        empty = np.zeros((0,), np.int64)
        out = []
        for i in range(B):
            parts = []
            for t in range(self.num_tiers):
                m = int(tmatch[t, i])
                if m <= 0:
                    continue
                lb = int(tless[t, i])
                g = self.sa_host[t, lb:lb + m] + self.offsets[t]
                e = g + int(plen_np[i])
                g = g[(e > self.los[t]) & (e <= self.his[t])]
                if g.size:
                    parts.append(g)
            if not parts:
                out.append(empty)
                continue
            g = np.concatenate(parts)
            g.sort()
            out.append(g)
        return out
