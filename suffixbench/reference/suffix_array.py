"""The plain reference of the chr1 configurations: a suffix array of the
same bases, built here, and the answers a scan owes.

It is plain PyTorch (any device) and imports nothing of the program.
For a DNA text of uint8 codes 0..3 it builds the full suffix array by
prefix doubling (shorter suffix first on ties, as the end of the text is
an empty symbol below every base), and answers a batch of patterns with
their exact ``count`` and text-order ``first_pos``: the smallest text
position among the matching rows (-1 when none).  ``found`` is
``count > 0``.

:meth:`SuffixReference.answer_rank_first` is the control: it breaks the
guarantee that ``first_pos`` is the smallest position, by reporting the
position of the first matching row in suffix order instead, the step a
scan that skips its range minimum would take.

A text that grew by appends is answered at any length it had: built
with ``n_fixed`` (the length before the first append), the reference
keeps a second suffix array over the stretch that can still change
(from ``max_len`` before ``n_fixed`` to the end), and
``answer(..., n_visible)`` answers each pattern over ``text[:n_visible]``
exactly.  The text only grows at its end, so the smallest position holds
while its occurrence ends inside the prefix, and the count drops the
occurrences that start past ``n_visible - len``: all of them start in
the stretch, whose rows in the pattern's range are counted above that
bound.
"""
from __future__ import annotations

import numpy as np
import torch

KEY_DIGITS = 27          # base-5 digits of the first key: 5**27 < 2**63
RMQ_BLOCK = 1024         # rows a block of the range minimum
QUERY_CHUNK = 1 << 17    # patterns a binary-search step at once
RMQ_CHUNK = 1 << 13      # ranges whose partial blocks are gathered at once
BIG = np.iinfo(np.int64).max


def build_suffix_array(text: torch.Tensor) -> torch.Tensor:
    """(n,) uint8 codes -> (n,) int64 suffix array on the text's device.

    The first key of each suffix is its first ``KEY_DIGITS`` bases in base
    5 (0 past the end, bases 1..4); each later round doubles the sorted
    depth with the pair (rank, rank ``h`` further on)."""
    n = int(text.numel())
    dev = text.device
    if n == 0:
        return torch.zeros(0, dtype=torch.int64, device=dev)
    key = torch.zeros(n, dtype=torch.int64, device=dev)
    depth = min(KEY_DIGITS, n)
    for j in range(depth):
        key.mul_(5)
        key[:n - j] += text[j:].to(torch.int64) + 1
    h = depth
    while True:
        sorted_key, sa = torch.sort(key)
        del key
        new = torch.ones(n, dtype=torch.bool, device=dev)
        new[1:] = sorted_key[1:] != sorted_key[:-1]
        del sorted_key
        rank_sorted = torch.cumsum(new, 0)
        del new
        if int(rank_sorted[-1]) == n or h >= n:
            return sa
        rank = torch.empty_like(rank_sorted)
        rank[sa] = rank_sorted
        del rank_sorted, sa
        key = rank * (n + 1)
        key[:n - h] += rank[h:]
        del rank
        h *= 2


class SuffixReference:
    """Exact answers over one text from its own suffix array."""

    def __init__(self, text: torch.Tensor, max_len: int,
                 n_fixed: int | None = None):
        self.n = int(text.numel())
        self.device = text.device
        self.max_len = int(max_len)
        self.sa = build_suffix_array(text)
        # the text with max_len empty symbols (-1) past its end
        self.text = torch.cat([
            text.to(torch.int8),
            torch.full((self.max_len,), -1, dtype=torch.int8,
                       device=self.device)])
        self._rmq_levels = None
        self.n_fixed = None if n_fixed is None else int(n_fixed)
        self._stretch = None
        if self.n_fixed is not None:
            # every occurrence that a shorter prefix (>= n_fixed) loses
            # starts at or after this, and lies inside the stretch
            self.stretch_start = max(0, self.n_fixed - self.max_len)
            self._stretch = SuffixReference(text[self.stretch_start:],
                                            self.max_len)

    # -- binary search ------------------------------------------------------
    def compare(self, rows: torch.Tensor, patt: torch.Tensor,
                plen: torch.Tensor):
        """Sign of suffix ``sa[rows]`` against each pattern over the
        pattern's length (-1, 0, 1), and the index of the first base that
        differs (the length where none does)."""
        L = int(patt.shape[1])
        ar = torch.arange(L, device=self.device)
        pos = self.sa[rows]
        win = self.text[pos[:, None] + ar[None, :]]
        diff = (win != patt) & (ar[None, :] < plen[:, None])
        any_diff = diff.any(1)
        first = torch.argmax(diff.to(torch.uint8), 1)
        wv = win.gather(1, first[:, None]).squeeze(1)
        pv = patt.gather(1, first[:, None]).squeeze(1)
        sign = torch.where(any_diff, torch.where(wv < pv, -1, 1), 0)
        return sign, torch.where(any_diff, first, plen)

    def _bound(self, patt, plen, upper: bool, trace=None):
        B = int(patt.shape[0])
        lo = torch.zeros(B, dtype=torch.int64, device=self.device)
        hi = torch.full((B,), self.n, dtype=torch.int64, device=self.device)
        for _ in range(self.n.bit_length() + 1):
            act = lo < hi
            if not bool(act.any()):
                break
            mid = (lo + hi) // 2
            sign, first = self.compare(mid.clamp(max=max(self.n - 1, 0)),
                                       patt, plen)
            right = (sign <= 0) if upper else (sign < 0)
            if trace is not None:
                trace.append((mid[act], first[act], plen[act]))
            lo = torch.where(act & right, mid + 1, lo)
            hi = torch.where(act & ~right, mid, hi)
        return lo

    def bounds(self, patt: torch.Tensor, plen: torch.Tensor, trace=None):
        """(lower, upper) rows of each pattern: the rows ``[lower, upper)``
        are the suffixes that start with it.  ``patt`` is (B, L) codes
        (any integer type; bases past a pattern's length are ignored),
        ``plen`` (B,).  With ``trace`` (a list), each step's probed rows,
        the first differing base and the length are appended to it."""
        patt = patt.to(self.device, torch.int8)
        plen = plen.to(self.device, torch.int64)
        if self.n == 0:
            z = torch.zeros(int(plen.numel()), dtype=torch.int64,
                            device=self.device)
            return z, z
        return (self._bound(patt, plen, False, trace),
                self._bound(patt, plen, True, trace))

    # -- range minimum over the suffix array --------------------------------
    def _levels(self):
        if self._rmq_levels is None:
            nb = -(-self.n // RMQ_BLOCK)
            padded = torch.full((nb * RMQ_BLOCK,), BIG, dtype=torch.int64,
                                device=self.device)
            padded[:self.n] = self.sa
            levels = [padded.view(nb, RMQ_BLOCK).min(1).values]
            k = 1
            while (1 << k) <= nb:
                prev = levels[-1]
                half = 1 << (k - 1)
                levels.append(torch.minimum(prev[:-half], prev[half:]))
                k += 1
            self._padded = padded
            self._rmq_levels = levels
        return self._rmq_levels

    def _partial_min(self, start, end):
        """Min of ``sa[start:end]`` where each range lies in one block."""
        out = torch.full(start.shape, BIG, dtype=torch.int64,
                         device=self.device)
        ar = torch.arange(RMQ_BLOCK, device=self.device)
        for c in range(0, int(start.numel()), RMQ_CHUNK):
            s, e = start[c:c + RMQ_CHUNK], end[c:c + RMQ_CHUNK]
            idx = s[:, None] + ar[None, :]
            vals = self._padded[idx.clamp(max=self._padded.numel() - 1)]
            vals = torch.where(idx < e[:, None], vals, BIG)
            out[c:c + RMQ_CHUNK] = vals.min(1).values
        return out

    def range_min(self, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
        """Per range, ``min(sa[lo:hi])`` (BIG for an empty range)."""
        levels = self._levels()
        S = RMQ_BLOCK
        first_full = (lo + S - 1) // S
        last_full = hi // S                      # full blocks [first, last)
        head_end = torch.minimum(hi, first_full * S)
        out = self._partial_min(lo, torch.maximum(head_end, lo))
        tail_start = torch.maximum(lo, last_full * S)
        has_tail = last_full >= first_full
        out = torch.minimum(out, self._partial_min(
            torch.where(has_tail, tail_start, hi), hi))
        span = last_full - first_full
        full = span > 0
        if bool(full.any()):
            k = torch.zeros_like(span)
            k[full] = torch.floor(torch.log2(span[full].double())).long()
            # log2 of an exact power of two can round below it
            k = torch.where(full & ((1 << (k + 1)) <= span), k + 1, k)
            for lev in torch.unique(k[full]).tolist():
                m = full & (k == lev)
                tab = levels[lev]
                a = tab[first_full[m]]
                b = tab[last_full[m] - (1 << lev)]
                out[m] = torch.minimum(out[m], torch.minimum(a, b))
        return out

    # -- answers ------------------------------------------------------------
    def _chunks(self, patt, plen):
        """Shortest patterns first, in chunks of at most QUERY_CHUNK, each
        cut to the width its longest pattern needs."""
        plen = plen.to(self.device, torch.int64)
        order = torch.argsort(plen, stable=True)
        for c in range(0, int(order.numel()), QUERY_CHUNK):
            at = order[c:c + QUERY_CHUNK]
            width = max(int(plen[at].max()), 1)
            yield at, patt[at.to(patt.device)][:, :width], plen[at]

    def answer(self, patt: torch.Tensor, plen: torch.Tensor,
               n_visible=None):
        """Exact (count, first_pos) int64 numpy arrays of a batch; with
        ``n_visible`` (one length a pattern, each from ``n_fixed`` to
        the text's length), each answered over ``text[:n_visible]``."""
        count, first = self._answer(patt, plen, rank_first=False)
        if n_visible is None:
            return count, first
        if self._stretch is None:
            raise ValueError("answers at a shorter length need n_fixed")
        vis = np.asarray(n_visible, np.int64)
        ln = np.asarray(plen, np.int64)
        if vis.size and (vis.min() < self.n_fixed or vis.max() > self.n):
            raise ValueError(f"n_visible outside [{self.n_fixed}, "
                             f"{self.n}]")
        first = np.where((first >= 0) & (first + ln <= vis), first, -1)
        count = count - self._starts_after(patt, plen, vis - ln)
        return count, first

    def _starts_after(self, patt, plen, bound: np.ndarray) -> np.ndarray:
        """Per pattern, its occurrences in the whole text that start
        after ``bound`` (text position), each past ``stretch_start``:
        the stretch's rows in the pattern's range with a larger start."""
        s = self._stretch
        out = np.zeros(len(bound), np.int64)
        # a bound below the stretch would miss occurrences before it;
        # n_visible >= n_fixed and len <= max_len keep it inside
        if self.stretch_start and bound.size \
                and bound.min() + 1 < self.stretch_start:
            raise ValueError("a pattern longer than max_len")
        local = torch.as_tensor(bound - self.stretch_start,
                                device=s.device)
        for at, p, ln in s._chunks(patt, plen):
            lo, hi = s.bounds(p, ln)
            lo_h, hi_h = lo.tolist(), hi.tolist()
            got = torch.zeros(len(lo_h), dtype=torch.int64,
                              device=s.device)
            b = local[at]
            for j, (a, e) in enumerate(zip(lo_h, hi_h)):
                if e > a:
                    got[j] = (s.sa[a:e] > b[j]).sum()
            out[at.cpu().numpy()] = got.cpu().numpy()
        return out

    def answer_rank_first(self, patt: torch.Tensor, plen: torch.Tensor):
        """The control: ``first_pos`` is the position of the first
        matching row in suffix order, not the smallest position."""
        return self._answer(patt, plen, rank_first=True)

    def _answer(self, patt, plen, rank_first: bool):
        B = int(plen.numel())
        count = torch.zeros(B, dtype=torch.int64, device=self.device)
        first = torch.full((B,), -1, dtype=torch.int64, device=self.device)
        for at, p, ln in self._chunks(patt, plen):
            lo, hi = self.bounds(p, ln)
            count[at] = hi - lo
            hit = hi > lo
            if not bool(hit.any()):
                continue
            if rank_first:
                first[at[hit]] = self.sa[lo[hit]]
            else:
                first[at[hit]] = self.range_min(lo[hit], hi[hit])
        return count.cpu().numpy(), first.cpu().numpy()
