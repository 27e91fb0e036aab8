"""Peaks of the card, and what a kernel's launches need in bytes and
operations, counted on the run's own data.

The peaks are NVIDIA's data sheet for one H100 SXM (dense rates): 3.35
TB/s of HBM and 67 TFLOP/s of float32 outside the tensor cores, taken as
the integer ALU rate.  A launch's least time is the larger of its bytes
over the bandwidth and its operations over the ALU rate; its share of
the roofline is that least time over its measured device time.

Bytes count each input byte read once and each output byte written
once, for what these inputs need:

* ``bounded_search`` (both bounds of each pattern over the suffix array
  and the packed text): what a binary search of both bounds reads once,
  4 B per distinct probed row (its suffix-array entry) and 4 B per
  distinct packed text word that the early-exit compares of those rows
  read; plus the pattern words, the lengths and the four 4-byte outputs
  a pattern.  Operations: 4 per compared word.
* ``fm_scan`` (the FM backward search): per active step one rank at
  ``lo`` and, while the run is not empty, one at ``hi``; a rank at row
  ``i`` of symbol ``c`` reads the Occ entry ``(i // 64, c)`` (4 B) and
  the ``ceil((i % 64) / 16)`` BWT words of its block below ``i``, each
  counted once a launch; plus the pattern words, the lengths and the two
  4-byte outputs a pattern.  Operations: 4 per BWT word read.

The intervals of the backward search are those of the pattern's
suffixes in the text's own suffix array (``reference``): after the step
that prepends base ``P[L - t]`` the interval of SA$ rows is ``[1 +
lower, 1 + upper)`` of the suffix ``P[L - t:]``, whether or not it
occurs, and before the first step it is ``[0, n + 1)``.
"""
from __future__ import annotations

import numpy as np
import torch

MEM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12
BASES_PER_WORD = 16
FM_BLOCK = 64                       # BWT symbols of an Occ checkpoint block
FM_WORDS_PER_BLOCK = FM_BLOCK // BASES_PER_WORD


def least_seconds(n_bytes: float, n_ops: float) -> float:
    return max(n_bytes / MEM_BYTES_PER_S, n_ops / ALU_OPS_PER_S)


def unpack_words(words: np.ndarray) -> np.ndarray:
    """(B, W) packed uint32 words (base ``s`` of a word at bit ``30 -
    2s``) -> (B, 16 W) uint8 codes."""
    w = np.asarray(words, np.uint32)
    shifts = (30 - 2 * np.arange(BASES_PER_WORD, dtype=np.uint32))
    codes = (w[:, :, None] >> shifts[None, None, :]) & np.uint32(3)
    return codes.reshape(w.shape[0], -1).astype(np.uint8)


def search_traffic(ref, codes: np.ndarray, plen: np.ndarray,
                   n_words: int) -> tuple[int, int]:
    """(bytes, operations) of one ``bounded_search`` launch over the
    patterns ``codes``/``plen`` (``n_words`` words a pattern)."""
    trace = []
    ref.bounds(torch.as_tensor(codes), torch.as_tensor(plen), trace=trace)
    rows = torch.cat([r for r, _f, _l in trace])
    first = torch.cat([f for _r, f, _l in trace])
    ln = torch.cat([l for _r, _f, l in trace])
    # words an early-exit compare reads: through the first differing
    # base, or all of the pattern's words where none differs
    used = (ln + BASES_PER_WORD - 1) // BASES_PER_WORD
    words = torch.minimum(first // BASES_PER_WORD + 1, used)
    uniq, inv = torch.unique(rows, return_inverse=True)
    most = torch.zeros(uniq.shape, dtype=torch.int64, device=rows.device)
    most.scatter_reduce_(0, inv, words, "amax")
    pos = ref.sa[uniq]
    span = most + ((pos % BASES_PER_WORD) != 0).to(torch.int64)
    text_words = torch.cat([
        (pos // BASES_PER_WORD + j)[span > j]
        for j in range(int(span.max()) if span.numel() else 0)]
        or [torch.zeros(0, dtype=torch.int64, device=rows.device)])
    n_text = int(torch.unique(text_words).numel())
    B = int(len(plen))
    n_bytes = 4 * int(uniq.numel()) + 4 * n_text \
        + 4 * B * n_words + 4 * B + 16 * B
    return n_bytes, 4 * int(words.sum())


def fm_traffic(ref, codes: np.ndarray, plen: np.ndarray,
               n_words: int) -> tuple[int, int]:
    """(bytes, operations) of one ``fm_scan`` launch over the patterns
    ``codes``/``plen``."""
    plen = np.asarray(plen, np.int64)
    B, L = codes.shape
    n = ref.n
    # every suffix P[L - t:] (t = 1..len) as a row of its own
    pat_idx = np.repeat(np.arange(B), plen)
    t = np.concatenate([np.arange(1, k + 1) for k in plen]) \
        if B else np.zeros(0, np.int64)
    start = plen[pat_idx] - t
    cols = start[:, None] + np.arange(L)[None, :]
    suf = np.where(cols < plen[pat_idx][:, None],
                   codes[pat_idx[:, None], np.minimum(cols, L - 1)], 0)
    lo, hi = ref.bounds(torch.as_tensor(suf.astype(np.uint8)),
                        torch.as_tensor(t))
    lo = lo.cpu().numpy() + 1
    hi = hi.cpu().numpy() + 1
    # the interval before the step that prepends P[L - t]: that of the
    # suffix one shorter (t - 1), or [0, n + 1) before the first step
    prev = np.arange(len(t)) - 1
    first_step = t == 1
    lo_before = np.where(first_step, 0, lo[np.maximum(prev, 0)])
    hi_before = np.where(first_step, n + 1, hi[np.maximum(prev, 0)])
    sym = codes[pat_idx, start].astype(np.int64)
    two = hi_before > lo_before
    rows = np.concatenate([lo_before, hi_before[two]])
    syms = np.concatenate([sym, sym[two]])
    blk = rows // FM_BLOCK
    n_occ = np.unique(blk * 4 + syms).size
    rem_words = (rows % FM_BLOCK + BASES_PER_WORD - 1) // BASES_PER_WORD
    word_ids = np.concatenate([
        (blk * FM_WORDS_PER_BLOCK + j)[rem_words > j]
        for j in range(FM_WORDS_PER_BLOCK)])
    n_bwt = np.unique(word_ids).size
    n_bytes = 4 * n_occ + 4 * n_bwt + 4 * B * n_words + 4 * B + 8 * B
    return n_bytes, 4 * int(rem_words.sum())


SAMPLE_LAUNCHES = 256        # launches a share is read from, evenly spread


def kernel_share(ctx, kernel: str, traffic) -> float | None:
    """Percent of its roofline that ``kernel`` reaches over the traced
    stretch: the least time of its launches over their device time, on
    at most ``SAMPLE_LAUNCHES`` of them.  Each recorded call is one
    launch, in launch order; where the calls and the trace's launches do
    not pair up one to one, nothing is read."""
    calls = ctx.launches.get(kernel) or []
    durs = ctx.trace.kernel_ns(f"{kernel}_kernel")
    if not calls or len(calls) != len(durs):
        return None
    picks = np.unique(np.linspace(0, len(calls) - 1,
                                  min(len(calls), SAMPLE_LAUNCHES))
                      .round().astype(np.int64))
    least = spent = 0.0
    for i in picks:
        words, plen = calls[i]
        n_bytes, n_ops = traffic(ctx.reference, unpack_words(words),
                                 np.asarray(plen), int(words.shape[1]))
        least += least_seconds(n_bytes, n_ops)
        spent += float(durs[i]) / 1e9
    return 100.0 * least / spent if spent else None
