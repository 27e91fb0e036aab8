"""Pattern-match queries over a TabletStore — the single-device part of
``repro.core.query``.

A scan is a batched lower/upper-bound search over the sorted suffix
array.  On a CUDA device a packed-DNA batch is ONE launch of the
``bounded_search`` kernel (``kernels/csrc/pattern_scan.cu``, a 17-ary
search, one warp per query) whose epilogue compares the reported row
and writes the result; everywhere
else (the CPU, token tables) the plain PyTorch binary search below
runs, one compare per round, mirroring the reference line by line.
Both return the same bounds, the exact partition points.

Counts, ranks and positions are int32, as the reference's (JAX without
x64), so overflow behaves the same.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING

import numpy as np
import torch

from repro_torch.core import codec
from repro_torch.core.codec import MASK32, words_i64
from repro_torch.device import DeviceLike, resolve_device

if TYPE_CHECKING:
    from repro_torch.core.tablet import TabletStore

WORD = codec.BASES_PER_WORD


@dataclasses.dataclass(frozen=True)
class MatchResult:
    """Outcome of one batch of scans (paper Table II columns)."""
    found: torch.Tensor       # (B,)  bool
    count: torch.Tensor       # (B,)  int32
    first_rank: torch.Tensor  # (B,)  int32 — row index in the real SA
    first_pos: torch.Tensor   # (B,)  int32 — text position of first match


# ---------------------------------------------------------------------------
# Pattern encoding
# ---------------------------------------------------------------------------
def encode_patterns(patterns: list[str], max_len: int,
                    device: DeviceLike = None):
    """list of DNA strings -> (codes (B, max_len) int32 zero-padded,
    packed (B, W) uint32, lengths (B,) int32), on ``device``."""
    dev = resolve_device(device)
    B = len(patterns)
    lengths = np.array([len(p) for p in patterns], np.int32)
    assert lengths.max(initial=0) <= max_len, (
        f"pattern length {int(lengths.max(initial=0))} exceeds "
        f"max_len={max_len}")
    W = codec.packed_length(max_len)
    codes = np.zeros((B, max_len), np.int32)
    for i, p in enumerate(patterns):
        codes[i, : len(p)] = codec.encode_dna(p)
    packed = (codec.pack_2bit_batch(codes)[:, :W] if B
              else np.zeros((0, W), np.uint32))
    return (codec.as_tensor(codes, dev), codec.as_tensor(packed, dev),
            codec.as_tensor(lengths, dev))


def random_patterns(num: int, min_len: int = 1, max_len: int = 100,
                    seed: int = 0):
    """The paper's workload: random ACGT patterns, uniform length 1..100
    (the reference's generator, so a seed gives the same patterns)."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(min_len, max_len + 1, size=num)
    return ["".join(codec.DNA_ALPHABET[c]
                    for c in rng.integers(0, 4, size=int(L)))
            for L in lengths]


# ---------------------------------------------------------------------------
# Packed compare (DNA): suffix-vs-pattern at depth `plen`
# ---------------------------------------------------------------------------
def word_masks(plen: torch.Tensor, n_words: int) -> torch.Tensor:
    """(B, n_words) int64 masks keeping the first ``plen`` bases of each
    word.  ``~`` in int64 does not wrap at 32 bits, hence ``& MASK32``;
    the ``r == 0`` guard keeps the shift by 32 out (undefined in C)."""
    w = torch.arange(n_words, dtype=torch.int64, device=plen.device)[None, :]
    r = (plen.to(torch.int64)[:, None] - w * WORD).clamp(0, WORD)
    part = (~((1 << (32 - 2 * r)) - 1)) & MASK32
    return torch.where(r == 0, 0, torch.where(r == WORD, MASK32, part))


def prefix_compare(a: torch.Tensor, b: torch.Tensor):
    """Lexicographic compare of masked int64 word rows along the last
    axis: (lt_raw, eq_all) — a < b at the first differing word, all
    words equal."""
    eq_w = a == b
    prefix_eq = torch.cumprod(eq_w.to(torch.int32), dim=-1)
    shifted = torch.cat([torch.ones_like(prefix_eq[..., :1]),
                         prefix_eq[..., :-1]], dim=-1)
    first_diff = (~eq_w) & (shifted == 1)
    lt_raw = (first_diff & (a < b)).any(dim=-1)
    return lt_raw, eq_w.all(dim=-1)


def compare_windows_packed(window: torch.Tensor, pos: torch.Tensor,
                           n_real, patt_packed: torch.Tensor,
                           plen: torch.Tensor):
    """(lt, eq) for pre-extracted packed ``window`` rows (B, W) uint32.
    ``n_real`` may be a scalar or a per-row tensor."""
    mask = word_masks(plen, patt_packed.shape[-1])
    lt_raw, eq_all = prefix_compare(words_i64(window) & mask,
                                    words_i64(patt_packed) & mask)
    # a suffix shorter than the pattern is "less", never "equal"
    truncated = pos.to(torch.int64) + plen.to(torch.int64) > n_real
    return lt_raw | (eq_all & truncated), eq_all & ~truncated


def compare_packed(packed_text: torch.Tensor, n_real: int,
                   pos: torch.Tensor, patt_packed: torch.Tensor,
                   plen: torch.Tensor):
    """(lt, eq): suffix(pos) < pattern, suffix starts with pattern."""
    window = codec.extract_window(packed_text, pos, patt_packed.shape[-1])
    return compare_windows_packed(window, pos, n_real, patt_packed, plen)


def gather_suffix_codes(codes: torch.Tensor, n_real, pos: torch.Tensor,
                        length: int) -> torch.Tensor:
    """(B, length) int32 suffix windows at ``pos``; reads past ``n_real``
    come back -1 (< any real code)."""
    offs = torch.arange(length, dtype=torch.int64, device=pos.device)[None]
    idx = pos.to(torch.int64)[:, None] + offs
    n_real = (n_real if not isinstance(n_real, torch.Tensor)
              else n_real.to(torch.int64))
    got = codes[idx.clamp(0, codes.shape[0] - 1)]
    return torch.where(idx < n_real, got, -1).to(torch.int32)


def compare_suffix_codes(suf: torch.Tensor, patt_codes: torch.Tensor,
                         plen: torch.Tensor):
    """(lt, eq) for pre-gathered token suffix windows (B, L)."""
    L = patt_codes.shape[-1]
    offs = torch.arange(L, dtype=torch.int64, device=suf.device)[None, :]
    valid = offs < plen.to(torch.int64)[:, None]
    s = suf.to(torch.int64)
    p = patt_codes.to(torch.int64)
    eq_w = torch.where(valid, s == p, True)
    prefix_eq = torch.cumprod(eq_w.to(torch.int32), dim=-1)
    shifted = torch.cat([torch.ones_like(prefix_eq[:, :1]),
                         prefix_eq[:, :-1]], dim=-1)
    first_diff = (~eq_w) & (shifted == 1)
    return (first_diff & (s < p)).any(dim=-1), eq_w.all(dim=-1)


def compare_codes(codes: torch.Tensor, n_real: int, pos: torch.Tensor,
                  patt_codes: torch.Tensor, plen: torch.Tensor):
    """Generic token path: codes is the padded int32 text."""
    suf = gather_suffix_codes(codes, n_real, pos, patt_codes.shape[-1])
    return compare_suffix_codes(suf, patt_codes, plen)


def is_packed(store, patt: torch.Tensor) -> bool:
    """True for a packed-DNA batch against a DNA store (uint32 words)."""
    return bool(store.is_dna and patt.dtype == torch.uint32)


def _compare(store: "TabletStore", pos, patt, plen):
    if is_packed(store, patt):
        return compare_packed(store.text_packed, store.n_real, pos, patt,
                              plen)
    return compare_codes(store.text_codes, store.n_real, pos, patt, plen)


# ---------------------------------------------------------------------------
# Batched binary search
# ---------------------------------------------------------------------------
def search_steps(n_rows: int) -> int:
    return max(1, int(np.ceil(np.log2(n_rows + 1))))


def _bounded_search(sa: torch.Tensor, pred_fn, batch: int,
                    n_rows: int) -> torch.Tensor:
    """Per-query first index in [0, n_rows] where pred(sa[idx]) is False
    (pred = 'suffix is still before the target')."""
    lo = torch.zeros(batch, dtype=torch.int32, device=sa.device)
    hi = torch.full((batch,), n_rows, dtype=torch.int32, device=sa.device)
    for _ in range(search_steps(n_rows)):
        mid = (lo + hi) // 2
        pos = sa[mid.clamp(0, n_rows - 1).to(torch.int64)]
        pred = pred_fn(pos)
        active = lo < hi
        lo = torch.where(active & pred, mid + 1, lo)
        hi = torch.where(active & ~pred, mid, hi)
    return lo


def search_bounds_plain(store: "TabletStore", patt, plen):
    """(lb, ub) int32 by the plain search: one compare per round."""
    B = patt.shape[0]
    n = store.n_pad
    lb = _bounded_search(
        store.sa, lambda pos: _compare(store, pos, patt, plen)[0], B, n)
    ub = _bounded_search(
        store.sa,
        lambda pos: (lambda lt, eq: lt | eq)(*_compare(store, pos, patt,
                                                       plen)), B, n)
    return lb, ub


def result_from_bounds(store: "TabletStore", lb: torch.Tensor,
                       ub: torch.Tensor) -> MatchResult:
    n = store.n_pad
    count = ub - lb
    found = count > 0
    first_pos = store.sa[lb.clamp(0, n - 1).to(torch.int64)]
    first_pos = torch.where(found, first_pos, -1).to(torch.int32)
    first_rank = torch.where(found, lb - store.pad_count, -1)
    return MatchResult(found=found, count=count.to(torch.int32),
                       first_rank=first_rank.to(torch.int32),
                       first_pos=first_pos)


def query(store: "TabletStore", patt, plen) -> MatchResult:
    """Single-device scan batch.  ``patt`` is packed uint32 (B, W) for DNA
    or int32 codes (B, L) for token corpora; ``plen`` (B,) int32.

    On CUDA a packed-DNA batch is one launch of the search kernel with
    the compare at the lower bound as its epilogue (``pattern_scan.
    bounded_match_cuda``): the kernel writes the four fields, ``found``
    from the suffix at ``sa[lb]`` (the rows ``[lb, ub)`` are exactly the
    matching rows, so that row matches iff ``ub > lb``)."""
    if not (is_packed(store, patt) and patt.is_cuda):
        lb, ub = search_bounds_plain(store, patt, plen)
        return result_from_bounds(store, lb, ub)
    from repro_torch.kernels import pattern_scan
    found, count, first_rank, first_pos = pattern_scan.bounded_match_cuda(
        store.sa, store.text_packed, store.n_real, patt, plen, store.n_pad,
        store.pad_count)
    return MatchResult(found=found, count=count, first_rank=first_rank,
                       first_pos=first_pos)


# ---------------------------------------------------------------------------
# Oracle (naive scan, paper Algorithm 1) for tests
# ---------------------------------------------------------------------------
def brute_force_count(text_codes: np.ndarray, pattern_codes: np.ndarray):
    """BruteForceSearch of paper Algorithm 1, returning (count, first_pos)."""
    n, k = len(text_codes), len(pattern_codes)
    count, first = 0, -1
    for i in range(n - k + 1):
        if (text_codes[i:i + k] == pattern_codes).all():
            count += 1
            if first < 0:
                first = i
    return count, first
