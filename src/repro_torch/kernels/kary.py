"""The 17-ary two-bound search of the ``tablet_scan`` and ``tier_scan``
kernels (``csrc/search.cuh`` ``warp_kary_bounds``), in plain PyTorch.

Over sorted suffix rows the predicate "row < pattern" is monotone (a
truncated prefix-equal row counts as less; pad rows sort first and are
truncated), so a query's lower bound is the first row where ``lt`` is
false and its upper bound the first row where ``lt | eq`` is false.
Each round probes 16 splitter rows of each bound's interval ``[lo, lo +
n)``, row ``lo + (j + 1) * n // 17`` for ``j`` in 0..15; the count ``c``
of splitters still before the pattern leaves the bound in ``(splitter
c-1, splitter c]``.  An interval of ``n`` rows shrinks to at most ``n //
17``, so the search ends after ``floor(log17 n) + 1`` rounds at most.
Row 0 of every (2, B, ...) batch below is the lower bound, row 1 the
upper, as lanes 0-15 and 16-31 of the kernel's warp.

Every step is the kernel's, so the CPU tests check the kernel's
algorithm exactly where it could go wrong (intervals under 17 rows,
the last row, empty intervals), and ``chip_smoke.py`` reads the rows the
kernels probe from ``trace``.
"""
from __future__ import annotations

import torch

from repro_torch.core import query as Q
from repro_torch.core.codec import BASES_PER_WORD, words_i64

ARITY = 17


def max_rounds(n_rows: int, arity: int = ARITY) -> int:
    """floor(log_arity n_rows) + 1 for n_rows >= 1, 0 for no rows."""
    rounds = 0
    while n_rows > 0:
        n_rows //= arity
        rounds += 1
    return rounds


def _splitter(lo, n, j, arity=ARITY):
    return lo + (j + 1) * n // arity


def compare(window, pos, patt, plen, n_real):
    """The kernel's early-exit compare of probed suffixes against their
    queries.  window (2, B, S, W) packed words (uint32, or their int32
    view), pos (2, B, S), patt (B, W) uint32, plen (B,).  Returns (lt,
    eq, words): ``words`` is the number of window words the early-exit
    compare reads (up to the first differing masked word, at most
    ceil(plen / 16))."""
    W = patt.shape[-1]
    mask = Q.word_masks(plen, W)[None, :, None, :]
    a = words_i64(window) & mask
    b = words_i64(patt)[None, :, None, :] & mask
    lt_raw, eq_all = Q.prefix_compare(a, b)
    plen64 = plen.to(torch.int64)[None, :, None]
    truncated = pos.to(torch.int64) + plen64 > n_real
    lead = torch.cumprod((a == b).to(torch.int64), dim=-1).sum(dim=-1)
    used = ((plen64 + BASES_PER_WORD - 1) // BASES_PER_WORD).clamp(max=W)
    words = torch.minimum(lead + 1, used)
    return lt_raw | (eq_all & truncated), eq_all & ~truncated, words


def search(n_rows: int, batch: int, probe, *, device, trace=None,
           arity: int = ARITY):
    """(lb, ub) int64 (batch,): both bounds of every query over sorted
    rows ``[0, n_rows)``.  ``probe(rows)`` takes (2, batch, arity - 1)
    int64 rows in ``[0, n_rows)`` and returns ``(lt, eq, words)`` of that
    shape (as :func:`compare`).  With a ``trace`` list, each round
    appends ``(rows, words)`` of the probes the kernel makes (its active
    lanes), 1-D.  ``arity=2`` steps a binary search instead: the same
    bounds, from the fewest rows a search reads (``chip_smoke.py``
    counts the bytes the function needs from its trace)."""
    splitters = arity - 1
    j = torch.arange(splitters, dtype=torch.int64, device=device)
    lo = torch.zeros((2, batch), dtype=torch.int64, device=device)
    hi = torch.full_like(lo, n_rows)
    upper = torch.tensor([False, True], device=device)[:, None, None]
    for _ in range(max_rounds(n_rows, arity)):
        n = hi - lo
        act = n > 0
        rows = _splitter(lo[..., None], n[..., None], j, arity)
        lt, eq, words = probe(rows.clamp(max=n_rows - 1))
        pred = torch.where(upper, lt | eq, lt) & act[..., None]
        c = pred.sum(dim=-1)
        nlo = torch.where(c > 0, _splitter(lo, n, c - 1, arity) + 1, lo)
        nhi = torch.where(c < splitters, _splitter(lo, n, c, arity), hi)
        lo = torch.where(act, nlo, lo)
        hi = torch.where(act, nhi, hi)
        if trace is not None:
            trace.append((rows[act].reshape(-1), words[act].reshape(-1)))
    return lo[0], lo[1]
