"""The host half of the staged external sort — the port's own copy of
``repro.core.dsort.merge_sorted_runs`` (numpy only).

The reference module also holds the mesh sorts (bitonic and sample
sort over ``shard_map``); they need several devices and wait for
ROADMAP queue 1, item 6.
"""
from __future__ import annotations

import numpy as np


class _RunCursor:
    """Merge-side view of one sorted run: a cursor plus one cached block
    so threshold peeks and takes never re-read spilled bytes."""

    __slots__ = ("run", "n", "cur", "_blo", "_key", "_idx")

    def __init__(self, run):
        self.run = run
        self.n = int(run.n)
        self.cur = 0
        self._blo = -1
        self._key = self._idx = None

    def _ensure(self, block_rows: int):
        if self._blo <= self.cur and self._key is not None \
                and self.cur < self._blo + self._key.shape[0]:
            return
        self._blo = self.cur
        self._key, self._idx = self.run.read_block(
            self.cur, min(self.cur + block_rows, self.n))

    def block(self, block_rows: int):
        """The (key, idx) rows [cur, min(cur+block_rows, n))."""
        self._ensure(block_rows)
        s = self.cur - self._blo
        return self._key[s:], self._idx[s:]

    def block_end(self, block_rows: int):
        """(key, idx) of the last row of the current block — the run's
        contribution to the merge threshold."""
        k, i = self.block(block_rows)
        return int(k[-1]), int(i[-1])


def merge_sorted_runs(runs, *, block_rows: int = 1 << 15):
    """Streaming k-way merge of sorted ``(key, idx)`` runs — the host
    half of the staged external sort (``core.build_pipeline``).

    Each run exposes ``n`` and ``read_block(lo, hi) -> (key int64,
    idx int32)`` and is sorted ascending by ``(key, idx)`` with idx
    globally unique.  Yields ``(key, idx)`` blocks that concatenate to
    the full merge, using O(len(runs) * block_rows) host memory — never
    more than one block per run is resident, so spilled runs merge
    without being materialized.

    Per iteration the threshold ``T`` is the lexicographic minimum of
    every run's current block-end ``(key, idx)`` pair; because idx makes
    pairs unique, each run holds at most ``block_rows`` rows ``<= T``
    (they all sit inside its current block), so one iteration moves at
    least ``block_rows`` rows (the argmin run drains its whole block)
    while gathering at most ``block_rows`` per run."""
    live = [_RunCursor(r) for r in runs if int(r.n) > 0]
    if len(live) == 1:
        # single-run fast path: the run IS the merge (chunk_rows >= n)
        c = live[0]
        while c.cur < c.n:
            k, i = c.block(block_rows)
            c.cur += k.shape[0]
            yield k, i
        return
    while live:
        t_key, t_idx = min(c.block_end(block_rows) for c in live)
        parts_k, parts_i = [], []
        for c in live:
            kblk, iblk = c.block(block_rows)
            take = int(np.searchsorted(kblk, t_key, side="left"))
            hi = int(np.searchsorted(kblk, t_key, side="right"))
            if hi > take:       # ties on key: idx breaks them exactly
                take += int(np.searchsorted(iblk[take:hi], t_idx,
                                            side="right"))
            if take:
                parts_k.append(kblk[:take])
                parts_i.append(iblk[:take])
                c.cur += take
        live = [c for c in live if c.cur < c.n]
        if len(parts_k) == 1:
            yield parts_k[0], parts_i[0]
            continue
        key = np.concatenate(parts_k)
        idx = np.concatenate(parts_i)
        order = np.lexsort((idx, key))
        yield key[order], idx[order]
