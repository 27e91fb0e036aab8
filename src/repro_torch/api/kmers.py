"""The smallest base position of every DNA pattern of 1..K bases.

A table answers a pattern's ``first_pos`` (its smallest text position)
with the minimum over every base-tier row it matches: a live table
reduces the pattern's SA slice, a frozen one LF-walks each of its rows.
On uniform bases a pattern of ``l`` bases matches about n / 4**l rows,
so at chromosome scale the patterns of a few bases hold nearly every
row a batch reduces or walks.  Their answers depend on the base text
alone, and every DNA string of 1..K bases (K = 8: 87,380 strings) fits
in one int32 table of 0.35 MB.

:func:`build` makes that table from the base's codes on a device: one
scatter-min of the n - K + 1 K-mer windows' positions into 4**K bins,
each shorter length the minimum over its four one-base extensions, then
the last K - 1 positions, which start no K-mer.  Only suffixes that lie
wholly inside the base count, as in the base tier's counts, so a
pattern's entry is its smallest base-tier match, or -1 where it has
none.  :func:`lookup` reads a packed batch's entries on the device.

The table is flat: the ``4**l`` strings of ``l`` bases start at
``(4**l - 4) // 3``, each at its 2-bit code, the first base highest (the
order of a packed word's leading bases).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import codec

K = 8
SIZE = (4 ** (K + 1) - 4) // 3       # 87,380 entries, lengths 1..K
CHUNK = 1 << 24                      # K-mer windows a device pass


def _offset(length):
    """Where the strings of ``length`` bases start (an int or a tensor)."""
    return (4 ** length - 4) // 3


def build(codes: np.ndarray, device: torch.device) -> torch.Tensor:
    """The (SIZE,) int32 table of ``codes`` (DNA codes 0..3 on the
    host), made on ``device``."""
    codes = np.asarray(codes)
    n = int(codes.shape[0])
    # n stands for "none" until the end: it is above every position
    level = torch.full((4 ** K,), n, dtype=torch.int64, device=device)
    windows = max(n - K + 1, 0)
    for w0 in range(0, windows, CHUNK):
        m = min(CHUNK, windows - w0)
        c = codec.as_tensor(codes[w0:w0 + m + K - 1], device).to(
            torch.int64)
        idx = c[:m].clone()
        for j in range(1, K):
            idx.mul_(4).add_(c[j:j + m])
        level.scatter_reduce_(0, idx, torch.arange(
            w0, w0 + m, dtype=torch.int64, device=device), reduce="amin")
    levels = [level]
    for _ in range(K - 1):
        levels.append(levels[-1].view(-1, 4).amin(1))
    table = torch.cat(levels[::-1])
    # every prefix of the last K - 1 suffixes, each shorter than K
    idx, pos = [], []
    for p in range(windows, n):
        x = 0
        for length in range(1, n - p + 1):
            x = 4 * x + int(codes[p + length - 1])
            idx.append(_offset(length) + x)
            pos.append(p)
    if idx:
        table.scatter_reduce_(
            0, torch.tensor(idx, dtype=torch.int64, device=device),
            torch.tensor(pos, dtype=torch.int64, device=device),
            reduce="amin")
    return torch.where(table < n, table, -1).to(torch.int32)


def lookup(table: torch.Tensor, words: torch.Tensor,
           lens: torch.Tensor) -> torch.Tensor:
    """(B,) int64 on the batch's device: each pattern's entry of
    ``table`` (packed ``(B, W)`` words, ``(B,)`` lengths), -1 for a
    pattern of no or more than K bases."""
    n = lens.to(torch.int64)
    short = (n >= 1) & (n <= K)
    n = n.clamp(1, K)
    code = codec.words_i64(words[:, 0]) >> (32 - 2 * n)
    pos = table[_offset(n) + code].to(torch.int64)
    return torch.where(short, pos, -1)
