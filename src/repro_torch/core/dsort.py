"""Distributed sorts over the tablet mesh, and the host half of the
staged external sort — the port of ``repro.core.dsort``.

The mesh sorts run single-controller: a sharded operand is a list of
per-tablet tensors (``blocks[d]`` a tuple of 1-D operands on tablet
``d``'s device, every tablet the same length ``m``), and each tablet's
body is written as phases around the collectives of
``distributed.collectives``, with the reference's ``perm`` pairs.

* :func:`bitonic_sort_sharded` — block-bitonic merge network: a local
  sort, then log2(p)*(log2(p)+1)/2 rounds of a pairwise ``ppermute`` and
  a merge-split.  Always correct; p a power of two.  The baseline build.
* :func:`sample_sort_sharded` — one splitter round and one
  ``all_to_all`` into fixed-capacity buckets, then a re-balance through
  the two neighbours.  Returns ``(blocks, overflow)``; a sort that
  overflowed is not a valid sort.
* :func:`sort_sharded_auto` — the sample sort, with the bitonic sort
  where it overflowed.

Local multi-key stable sorts (``lax.sort(num_keys=k, is_stable=True)``
in the reference) are stable ``torch.sort`` calls on order-preserving
int64 keys, two int32 keys packed per call, least significant first
(:func:`lex_sort`).  Keys are int32 and values ride along; blocks come
back globally sorted across the tablets (tablet d holds global ranks
``[d*m, (d+1)*m)``).

:func:`merge_sorted_runs` is numpy only: the streaming k-way merge of
the staged build.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.distributed import collectives as C

INT32_MAX = int(np.iinfo(np.int32).max)


def _pack_pair(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Order-preserving int64 key of an (int32, int32) pair."""
    return (hi.to(torch.int64) << 32) + (lo.to(torch.int64) + 2**31)


def lex_sort(operands, num_keys: int) -> tuple:
    """``lax.sort(operands, num_keys=num_keys, is_stable=True)``: every
    operand reordered by the first ``num_keys`` operands (int32,
    lexicographic), ties kept in their input order."""
    keys = list(operands[:num_keys])
    groups = [keys[i:i + 2] for i in range(0, len(keys), 2)]
    order = None
    for g in reversed(groups):             # least significant first
        k = _pack_pair(g[0], g[1]) if len(g) == 2 else g[0]
        if order is not None:
            k = k[order]
        _, o = torch.sort(k, stable=True)
        order = o if order is None else order[o]
    return tuple(x[order] for x in operands)


def _ppermute_blocks(blocks, perm):
    """ppermute of every operand of a list of per-tablet tuples."""
    cols = [C.ppermute([b[i] for b in blocks], perm)
            for i in range(len(blocks[0]))]
    return [tuple(col[d] for col in cols) for d in range(len(blocks))]


def _merge_split(ops_a, ops_b, num_keys: int, keep_low: bool,
                 i_am_lower: bool):
    """Merge two sorted blocks and keep the low or the high half.  Both
    partners build the same merged array — the lower tablet's block
    first — or tied keys would split inconsistently."""
    first, second = (ops_a, ops_b) if i_am_lower else (ops_b, ops_a)
    merged = lex_sort(tuple(torch.cat([f, s]) for f, s in
                            zip(first, second)), num_keys)
    m = int(ops_a[0].shape[0])
    return tuple(x[:m] if keep_low else x[m:] for x in merged)


def bitonic_sort_sharded(blocks, *, num_keys: int):
    """Block-bitonic sort of equal-size per-tablet blocks (a list of
    operand tuples, the first ``num_keys`` the keys).  p must be a power
    of two."""
    blocks = [tuple(b) for b in blocks]
    p = len(blocks)
    log_p = int(np.log2(p))
    if 1 << log_p != p:
        raise ValueError(f"axis size {p} must be a power of two")
    blocks = [lex_sort(b, num_keys) for b in blocks]       # 1. local sort
    if p == 1:
        return blocks
    for stage in range(1, log_p + 1):                      # 2. the network
        k = 1 << stage          # ascending-run length being built (blocks)
        for sub in range(stage - 1, -1, -1):
            j = 1 << sub
            partner = _ppermute_blocks(blocks, [(r, r ^ j)
                                                for r in range(p)])
            out = []
            for d in range(p):
                # keep low iff ascending == (I am the lower of the pair)
                i_am_lower = (d & j) == 0
                keep_low = ((d & k) == 0) == i_am_lower
                out.append(_merge_split(blocks[d], partner[d], num_keys,
                                        keep_low, i_am_lower))
            blocks = out
    return blocks


def linspace_take(m: int, s: int) -> np.ndarray:
    """``jnp.linspace(0, m - 1, s).astype(jnp.int32)`` bit for bit, as
    XLA computes it: the division by ``s - 1`` becomes a multiply by its
    float32 reciprocal, reassociated with the scale, so sample i sits at
    ``i * fl32((m - 1) * fl32(1 / (s - 1)))``, the last at ``m - 1``
    exactly, truncated toward zero.  (A plain ``i / (s - 1) * (m - 1)``
    differs at some ``m``; the sample decides the splitters, hence the
    overflow flag and an overflowed sort's output.)"""
    if s <= 1:
        return np.zeros((max(s, 0),), np.int32)
    div = s - 1
    scale = np.float32(m - 1) * (np.float32(1) / np.float32(div))
    out = np.arange(div, dtype=np.float32) * scale
    return np.concatenate([out, [np.float32(m - 1)]]).astype(np.int32)


def _scatter_last(buf: torch.Tensor, index, values: torch.Tensor
                  ) -> torch.Tensor:
    """``buf.at[index].set(values, mode="drop")`` (flat ``index``):
    out-of-range indices are dropped, and where an index repeats the
    last update wins, as the reference's scatter writes them in
    order."""
    n = int(buf.shape[0])
    idx = index.to(torch.int64)
    keep = (idx >= 0) & (idx < n)
    idx, vals = idx[keep], values[keep]
    if idx.numel():
        order = torch.arange(idx.shape[0], device=idx.device)
        last = torch.full((n,), -1, dtype=torch.int64, device=idx.device)
        last.scatter_reduce_(0, idx, order, reduce="amax")
        win = last[idx] == order
        buf = buf.clone()
        buf[idx[win]] = vals[win]
    return buf


def sample_sort_sharded(blocks, *, num_keys: int,
                        capacity_factor: float = 2.0, oversample: int = 64):
    """One-shot sample sort: splitters, one ``all_to_all``, a local sort
    and a re-balance through the two neighbours.  Returns ``(blocks,
    overflow)``, ``overflow`` one bool for all tablets (the reference's
    psum'd flag); on overflow the output is NOT a valid sort.  Only the first key splits (the
    local sort finishes the job)."""
    blocks = [tuple(b) for b in blocks]
    p = len(blocks)
    n_ops = len(blocks[0])
    m = int(blocks[0][0].shape[0])
    devs = [b[0].device for b in blocks]
    sentinel = INT32_MAX

    # --- splitters: regular sampling (PSRS), s per tablet -> p-1 cuts
    s = min(oversample, m)
    take = torch.from_numpy(linspace_take(m, s).astype(np.int64))
    local_sample = [torch.sort(b[0]).values[take.to(b[0].device)]
                    for b in blocks]
    gathered = C.all_gather(local_sample)
    cut_at = torch.arange(1, p, dtype=torch.int64) * s
    send, overflow = [], []
    cap = int(np.ceil(m / p * capacity_factor))
    for d in range(p):
        samples = torch.sort(gathered[d].reshape(-1)).values
        cuts = samples[cut_at.to(devs[d])]
        key = blocks[d][0]
        # --- bucket assignment and the fixed-capacity layout
        dest = torch.searchsorted(cuts, key, right=True).to(torch.int32)
        order = torch.sort(dest, stable=True).indices
        dest_sorted = dest[order]
        bucket_start = torch.searchsorted(
            dest_sorted, torch.arange(p, dtype=torch.int32,
                                      device=devs[d]))
        within = (torch.arange(m, dtype=torch.int64, device=devs[d])
                  - bucket_start[dest_sorted.to(torch.int64)])
        overflow.append(bool((within >= cap).any()))
        slot = within.clamp(0, cap - 1)
        flat_idx = dest_sorted.to(torch.int64) * cap + slot
        bufs = []
        for i, x in enumerate(blocks[d]):
            fill = sentinel if i < num_keys else 0
            buf = torch.full((p * cap,), fill, dtype=x.dtype,
                             device=devs[d])
            bufs.append(_scatter_last(buf, flat_idx, x[order])
                        .reshape(p, cap))
        send.append(bufs)
    recv = [C.all_to_all([send[d][i] for d in range(p)])
            for i in range(n_ops)]              # (p, cap): rows from all
    del send        # tablets sharing a card share its memory: free early

    # --- local sort; sentinels sink to the end
    flat = [lex_sort(tuple(recv[i][d].reshape(-1) for i in range(n_ops)),
                     num_keys) for d in range(p)]
    del recv

    # --- re-balance to exactly m per tablet: global rank g belongs on
    # tablet g // m; spill goes to the immediate neighbours through two
    # ppermutes of a fixed window H
    H = min(p * cap, cap + max(1, m // 4))
    n_real_local = [(f[0] != sentinel).sum().to(torch.int32) for f in flat]
    counts = C.all_gather(n_real_local)
    ar = torch.arange(p * cap, dtype=torch.int64)
    withg, lefts, rights = [], [], []
    for d in range(p):
        dev = devs[d]
        my_offset = int(counts[d][:d].sum())
        gidx = my_offset + ar.to(dev)
        valid = flat[d][0] != sentinel
        grank = torch.where(valid, gidx, -1).to(torch.int32)
        owner = torch.where(valid, gidx // m, -1)
        # anything spilling past the immediate neighbours: bad splitters
        overflow[d] |= bool((valid & ((owner - d).abs() > 1)).any())
        fl = flat[d] + (grank,)
        withg.append(fl)
        lo, hi = d * m, (d + 1) * m

        def spill(direction):
            """Fixed-H buffers of the rows bound for tablet d+direction."""
            if direction < 0:
                sel = valid & (gidx < lo)
                slot_ = gidx - my_offset             # the first rows
            else:
                sel = valid & (gidx >= hi)
                slot_ = gidx - hi                    # rank in the spill
            slot_ = torch.where(sel, slot_, p * cap)
            overflow[d] |= bool((sel & (slot_ >= H)).any())
            bufs = []
            for j, x in enumerate(fl):
                fill = (-1 if j == len(fl) - 1
                        else (sentinel if x.dtype == torch.int32 else 0))
                buf = torch.full((H,), fill, dtype=x.dtype, device=dev)
                bufs.append(_scatter_last(buf, slot_[sel], x[sel]))
            return tuple(bufs)

        lefts.append(spill(-1))     # rows whose owner is d-1 (or worse)
        rights.append(spill(+1))
    from_left = _ppermute_blocks(rights, [(r, (r + 1) % p)
                                          for r in range(p)])
    from_right = _ppermute_blocks(lefts, [(r, (r - 1) % p)
                                          for r in range(p)])
    out = []
    for d in range(p):
        lo, hi = d * m, (d + 1) * m
        placed = []
        for i in range(n_ops):
            buf = torch.zeros((m,), dtype=withg[d][i].dtype,
                              device=devs[d])
            for src in (withg[d], from_left[d], from_right[d]):
                g = src[-1].to(torch.int64)
                at = torch.where((g >= lo) & (g < hi), g - lo, m)
                buf = _scatter_last(buf, at, src[i])
            placed.append(buf)
        out.append(tuple(placed))
    return out, any(overflow)                 # the psum'd flag


def sort_sharded_auto(blocks, *, num_keys: int,
                      capacity_factor: float = 2.0, oversample: int = 64):
    """The sample sort, with the bitonic sort where its splitters
    overflowed: O(m) exchanged rows on the fast path, O(m log^2 p) on the
    fallback (tie-heavy keys of the early doubling rounds)."""
    blocks = [tuple(b) for b in blocks]
    fast, overflow = sample_sort_sharded(
        blocks, num_keys=num_keys, capacity_factor=capacity_factor,
        oversample=oversample)
    if overflow:
        del fast
        return bitonic_sort_sharded(blocks, num_keys=num_keys)
    return fast


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
