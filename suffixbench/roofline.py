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
* ``tier_scan`` (both bounds of each pattern in every delta tier of a
  table, a sealed run or the memtable): per tier, what a binary search
  of both bounds over that tier's own suffix array reads once, counted
  as for ``bounded_search``; plus the pattern words, the lengths and
  the four 4-byte outputs a pattern and tier.  A tier is the text from
  its offset to its owned end, padded with base 0 to its rows, as the
  program stores it; its suffix array is built here from the
  reference's text.  The sweep over a tier's matching rows that the
  kernel makes for its first position is not counted: what it needs
  depends on how the minimum is found.  The base search of the same
  read is the ``bounded_search`` launch beside it.
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
    n_rows, n_text, n_ops = _probe_traffic(ref, codes, plen)
    B = int(len(plen))
    n_bytes = 4 * n_rows + 4 * n_text \
        + 4 * B * n_words + 4 * B + 16 * B
    return n_bytes, n_ops


def _probe_traffic(ref, codes: np.ndarray,
                   plen: np.ndarray) -> tuple[int, int, int]:
    """(distinct rows, distinct text words, operations) of a binary
    search of both bounds of each pattern over ``ref``'s suffix array."""
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
    return int(uniq.numel()), n_text, 4 * int(words.sum())


def _tier_reference(ref, offset: int, end: int, rows: int):
    """A reference over one tier's text: ``ref``'s text from ``offset``
    to ``end``, padded with base 0 to ``rows``."""
    text = ref.text[offset:end].to(torch.uint8)
    pad = torch.zeros(rows - (end - offset), dtype=torch.uint8,
                      device=text.device)
    return type(ref)(torch.cat([text, pad]), ref.max_len)


def tier_traffic(ref, codes: np.ndarray, plen: np.ndarray, n_words: int,
                 offsets: np.ndarray, ends: np.ndarray,
                 rows: np.ndarray) -> tuple[int, int]:
    """(bytes, operations) of one ``tier_scan`` launch over the patterns
    ``codes``/``plen`` and the tiers ``offsets``/``ends``/``rows`` (as
    the stack holds them when the launch is made)."""
    B, T = int(len(plen)), int(len(offsets))
    n_bytes = 4 * B * n_words + 4 * B + 16 * B * T
    n_ops = 0
    for off, end, r in zip(np.asarray(offsets).tolist(),
                           np.asarray(ends).tolist(),
                           np.asarray(rows).tolist()):
        n_rows, n_text, ops = _probe_traffic(
            _tier_reference(ref, int(off), int(end), int(r)), codes, plen)
        n_bytes += 4 * n_rows + 4 * n_text
        n_ops += ops
    return n_bytes, n_ops


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


def pair_launches(spans, launch_ns: np.ndarray) -> np.ndarray:
    """For each traced launch (its runtime call's host time, -1 where
    lost), the index of the recorded call whose (enter, exit) span holds
    it, or -1: where no span or more than one holds it, or where its
    call holds another launch as well."""
    out = np.full(len(launch_ns), -1, np.int64)
    if not len(spans) or not len(launch_ns):
        return out
    sp = np.asarray(spans, np.int64).reshape(-1, 2)
    order = np.argsort(sp[:, 0], kind="stable")
    enters = sp[order, 0]
    exits = np.sort(sp[:, 1])
    t = np.asarray(launch_ns, np.int64)
    holding = (np.searchsorted(enters, t, "right")
               - np.searchsorted(exits, t, "left"))
    last = np.searchsorted(enters, t, "right") - 1
    ok = (t >= 0) & (holding == 1)
    # the one span that holds it is, as a rule, the latest entered
    # before it; where calls overlap, it is looked for
    idx = np.where(ok, order[np.maximum(last, 0)], -1)
    for j in np.flatnonzero(ok & (t > sp[np.maximum(idx, 0), 1])):
        idx[j] = np.flatnonzero((sp[:, 0] <= t[j]) & (t[j] <= sp[:, 1]))[0]
    calls, n = np.unique(idx[idx >= 0], return_counts=True)
    idx[np.isin(idx, calls[n > 1])] = -1
    return idx


def kernel_share(ctx, kernel: str, traffic) -> float | None:
    """Percent of its roofline that ``kernel`` reaches over the traced
    stretch: the least time of its launches over their device time, on
    at most ``SAMPLE_LAUNCHES`` of them.  Each recorded call is one
    launch.  Where the calls and the trace's launches pair up one to one
    in order, every call counts; where the trace lost some launches,
    each launch is tied to its call by the host time of the runtime call
    that made it (``pair_launches``), and the share is read over the
    calls so tied.  Where none is, nothing is read."""
    calls = ctx.launches.get(kernel) or []
    launch_ns, durs = ctx.trace.kernel_launches(f"{kernel}_kernel")
    if not calls or not len(durs):
        return None
    if len(calls) == len(durs):
        pairs = list(zip(range(len(calls)), durs))
    else:
        idx = pair_launches(ctx.launch_spans.get(kernel) or [], launch_ns)
        pairs = sorted((int(i), d) for i, d in zip(idx, durs) if i >= 0)
        if not pairs:
            return None
    picks = np.unique(np.linspace(0, len(pairs) - 1,
                                  min(len(pairs), SAMPLE_LAUNCHES))
                      .round().astype(np.int64))
    least = spent = 0.0
    for p in picks:
        i, dur = pairs[p]
        words, plen, *tiers = calls[i]
        n_bytes, n_ops = traffic(ctx.reference, unpack_words(words),
                                 np.asarray(plen), int(words.shape[1]),
                                 *tiers)
        least += least_seconds(n_bytes, n_ops)
        spent += float(dur) / 1e9
    return 100.0 * least / spent if spent else None
