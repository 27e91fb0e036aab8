"""FM-index backward search over a compressed BWT — the port of
``repro.kernels.fm_scan``.

The frozen storage tier (``repro_torch.api.fm``) replaces the base
suffix array with a Burrows-Wheeler index: ``count`` is one backward
search step per pattern symbol, each step two rank queries over the
packed BWT.  Conventions are the reference's:

* the BWT is over ``T$`` (virtual sentinel), so its ``n + 1`` rows are
  the real suffix array plus one sentinel row; the lower bound ``lo``
  maps to ``first_rank = lo - 1``;
* DNA: 2-bit-packed words, rank = Occ checkpoint (every ``SB`` symbols)
  + an in-block popcount over ``0x55555555``; the sentinel row stores
  dummy symbol 0 and rank subtracts it;
* tokens: int32 BWT codes, per-symbol checkpoints, compare-equal sums;
* the schedule is the reference's ``(steps, B)`` symbol plan (-1 =
  step inactive): step t takes pattern position ``plen - 1 - t``.  The
  plain search reads it from :func:`syms_from_packed` /
  :func:`syms_from_codes`; the kernel takes the same symbols straight
  from the packed patterns.

Two implementations of the backward search:

* :func:`search_syms` — plain PyTorch (the CPU path, token tables on
  every device, and what the kernel is held against).  PyTorch has no
  popcount and cannot shift ``uint32``, so words are widened to int64
  and counted by SWAR;
* :func:`fm_scan_cuda` — the hand-written kernel ``csrc/fm_scan.cu``
  (packed DNA on a CUDA device): the ``fm_scan_pallas`` contract over
  packed patterns, whose plain version is :func:`backward_search`
  (``search_syms`` over ``syms_from_packed(patt, plen, 16 * W)``).

:func:`lf_walk` (text positions of SA$ rows through the sampled SA) is
plain PyTorch on the index's device.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.core.codec import MASK32
from repro_torch.kernels import _build

SB = 64                 # symbols per Occ checkpoint block
WPB = SB // 16          # packed words per block (DNA)
EVEN = 0x55555555       # every 2-bit slot's low bit


@dataclasses.dataclass(frozen=True)
class FMArrays:
    """Device view of one frozen table's FM-index.

    ``rows = n + 1`` BWT rows (row 0 is the ``$``-only suffix).  ``occ``
    holds exclusive prefix counts of the raw symbol stream (the sentinel
    row's dummy 0 included — rank subtracts it); ``cc[c]`` is ``C$[c] =
    1 + #{symbols < c}``.  Row r is marked iff ``SA$[r] % sample_rate ==
    0``; ``samples`` holds the marked rows' ``SA$`` values in row order."""
    bwt: torch.Tensor          # DNA: (Wb,) uint32 packed | tokens: (L,) int32
    occ: torch.Tensor          # (nblk + 1, vocab) int32 checkpoint counts
    cc: torch.Tensor           # (vocab,) int32  C$ array
    marked: torch.Tensor       # (Wm,) uint32 bitvector over rows
    marked_rank: torch.Tensor  # (Wm,) int32 set bits before each word
    samples: torch.Tensor      # (S,) int32 SA$ values of marked rows
    sent_row: int              # row whose BWT symbol is $
    n: int                     # real text length (rows - 1)
    is_dna: bool
    sample_rate: int
    vocab: int

    @property
    def device(self) -> torch.device:
        return self.occ.device

    @functools.cached_property
    def meta(self) -> torch.Tensor:
        """:func:`fm_meta` of this index, built once."""
        return fm_meta(self)


def _words(words: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``words[idx]`` of a uint32 tensor as int64 holding the unsigned
    value (gathered through an int32 view: uint32 indexing and shifts
    are not available everywhere)."""
    return words.view(torch.int32)[idx].to(torch.int64) & MASK32


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of int64 values below 2**32, by SWAR."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF


# ---------------------------------------------------------------------------
# rank — Occ(c, i) = occurrences of c in bwt$[0:i)
# ---------------------------------------------------------------------------
def _rank_packed(bwt, occ_flat, sent_row: int, c, i):
    """Packed-DNA rank: checkpoint gather + per-word popcount.  ``c``
    and ``i`` int64 tensors of one shape.  When ``rows`` is a multiple of
    ``SB``, ``rank(c, rows)`` reaches one block past the BWT; those
    words have no slot in range (``v == 0``) and their index is clamped
    instead of read out of bounds."""
    blk = i // SB
    base = occ_flat[blk * 4 + c].to(torch.int64)
    j = torch.arange(WPB, dtype=torch.int64, device=i.device)
    # the block's WPB words side by side, (..., WPB): one gather for all
    w = _words(bwt, (blk[..., None] * WPB + j).clamp(max=bwt.shape[0] - 1))
    v = ((i - blk * SB)[..., None] - 16 * j).clamp(0, 16)  # slots in range
    nx = ~(w ^ (c * EVEN)[..., None]) & MASK32
    y = nx & (nx >> 1) & EVEN                           # bit per match
    sh = 2 * (16 - v.clamp(1, 16))                      # 0..30, never 32
    keep = torch.where(v > 0, (EVEN << sh) & MASK32, 0)
    cnt = popcount32(y & keep).sum(dim=-1)
    return base + cnt - ((c == 0) & (i > sent_row)).to(torch.int64)


def _rank_codes(bwt, occ_flat, sent_row: int, vocab: int, c, i):
    """Token rank: checkpoint gather + compare-equal sum over the
    ``SB``-symbol window (indices past the BWT clamped; they lie beyond
    ``rem`` and never count)."""
    blk = i // SB
    base = occ_flat[blk * vocab + c].to(torch.int64)
    rem = i - blk * SB
    offs = torch.arange(SB, dtype=torch.int64, device=i.device)
    idx = (blk[..., None] * SB + offs).clamp(max=int(bwt.shape[0]) - 1)
    hit = (bwt[idx] == c[..., None]) & (offs < rem[..., None])
    cnt = hit.sum(dim=-1)
    return base + cnt - ((c == 0) & (i > sent_row)).to(torch.int64)


def rank(fa: FMArrays, c, i):
    """Occ(c, i) over the index (int64 in, int64 out): the rank shared by
    backward search and LF walks."""
    occ_flat = fa.occ.reshape(-1)
    c = c.to(torch.int64)
    i = i.to(torch.int64)
    if fa.is_dna:
        return _rank_packed(fa.bwt, occ_flat, fa.sent_row, c, i)
    return _rank_codes(fa.bwt, occ_flat, fa.sent_row, fa.vocab, c, i)


# ---------------------------------------------------------------------------
# per-step symbol plan
# ---------------------------------------------------------------------------
def _plan_index(plen, steps: int):
    j = (plen.to(torch.int64)[None, :] - 1
         - torch.arange(steps, dtype=torch.int64, device=plen.device)[:, None])
    return j, j >= 0


def syms_from_packed(patt: torch.Tensor, plen: torch.Tensor,
                     steps: int) -> torch.Tensor:
    """(B, W) packed patterns -> (steps, B) int32 backward-order symbols
    (step t processes pattern position ``plen - 1 - t``; -1 = inactive)."""
    j, valid = _plan_index(plen, steps)
    jc = j.clamp(0, steps - 1)
    W = int(patt.shape[1])
    widx = (jc // 16).clamp(max=W - 1).T                # (B, steps)
    words = (patt.view(torch.int32).gather(1, widx).to(torch.int64)
             & MASK32).T
    sym = (words >> (30 - 2 * (jc % 16))) & 3
    return torch.where(valid, sym, -1).to(torch.int32)


def syms_from_codes(patt: torch.Tensor, plen: torch.Tensor,
                    steps: int) -> torch.Tensor:
    """(B, L) code patterns -> (steps, B) int32 backward-order symbols."""
    j, valid = _plan_index(plen, steps)
    jc = j.clamp(0, int(patt.shape[1]) - 1)
    sym = patt.to(torch.int64).gather(1, jc.T).T
    return torch.where(valid, sym, -1).to(torch.int32)


# ---------------------------------------------------------------------------
# backward search — plain PyTorch
# ---------------------------------------------------------------------------
def search_syms(fa: FMArrays, syms: torch.Tensor):
    """Backward search over a (steps, B) symbol plan -> (lo, hi) int32
    rows of SA$: matches occupy rows [lo, hi), count = hi - lo.  A
    symbol outside the alphabet (``>= vocab``) empties the run."""
    B = int(syms.shape[1])
    dev = syms.device
    cc = fa.cc.to(torch.int64)
    lo = torch.zeros(B, dtype=torch.int64, device=dev)
    hi = torch.full((B,), fa.n + 1, dtype=torch.int64, device=dev)
    for t in range(int(syms.shape[0])):
        s = syms[t].to(torch.int64)
        active = s >= 0
        known = s < fa.vocab
        sc = s.clamp(0, fa.vocab - 1)
        lo2 = cc[sc] + rank(fa, sc, lo)
        hi2 = torch.where(known, cc[sc] + rank(fa, sc, hi), lo2)
        lo = torch.where(active, lo2, lo)
        hi = torch.where(active, hi2, hi)
    return lo.to(torch.int32), hi.to(torch.int32)


def backward_search(fa: FMArrays, patt, plen):
    """Count-path entry: encoded batch -> (lo, hi) SA$ rows."""
    if fa.is_dna:
        syms = syms_from_packed(patt, plen, int(patt.shape[1]) * 16)
    else:
        syms = syms_from_codes(patt, plen, int(patt.shape[1]))
    return search_syms(fa, syms)


# ---------------------------------------------------------------------------
# LF walk — text positions of SA$ rows
# ---------------------------------------------------------------------------
def _bwt_symbol(fa: FMArrays, r):
    if fa.is_dna:
        return (_words(fa.bwt, r // 16) >> (30 - 2 * (r % 16))) & 3
    return fa.bwt[r].to(torch.int64)


def _sample_pos(fa: FMArrays, r):
    wi = r // 32
    low = _words(fa.marked, wi) & ((1 << (r % 32)) - 1)
    idx = fa.marked_rank[wi].to(torch.int64) + popcount32(low)
    return fa.samples[idx].to(torch.int64)


def lf_walk(fa: FMArrays, rows) -> torch.Tensor:
    """Text positions (``SA$`` values) of SA$ ``rows``, int64, by LF walks
    to the nearest sampled row: ``fm_scan.lf_walk``'s result.  Every walk
    stops within ``sample_rate`` steps (position 0 is always marked).
    Rows whose walk has stopped leave the working set, so each step
    costs only the walks still running; all walks share the step count,
    so a stop at step k reports ``sample + k``."""
    r = torch.as_tensor(rows, device=fa.device).to(torch.int64).reshape(-1)
    pos = torch.full_like(r, -1)
    idx = torch.arange(r.shape[0], dtype=torch.int64, device=r.device)
    cc = fa.cc.to(torch.int64)
    for k in range(fa.sample_rate + 1):
        if r.numel() == 0:
            break
        hit = ((_words(fa.marked, r // 32) >> (r % 32)) & 1) != 0
        if bool(hit.any()):
            pos[idx[hit]] = _sample_pos(fa, r[hit]) + k
            miss = ~hit
            r, idx = r[miss], idx[miss]
            if r.numel() == 0:
                break
        if k == fa.sample_rate:
            break
        s = _bwt_symbol(fa, r)
        r = cc[s] + rank(fa, s, r)
    return pos


def finish_match(fa: FMArrays, lo, hi, *, walk: bool = True):
    """(lo, hi) -> (found, count, first_rank, first_pos) int32:
    ``first_rank`` is the real-SA lower-bound row ``lo - 1`` when found
    and -1 otherwise (the code's behaviour, which ``ops.fm_search``'s
    reference docstring describes as widened); ``first_pos`` is the
    matched run's first text position in suffix-rank order (one LF
    walk), -1 when not found, and -1 everywhere when ``walk`` is False
    (callers that derive text positions themselves skip the walk)."""
    count = hi.to(torch.int64) - lo.to(torch.int64)
    found = count > 0
    first_rank = torch.where(found, lo.to(torch.int64) - 1, -1)
    if walk:
        pos = lf_walk(fa, lo.to(torch.int64).clamp(1, max(fa.n, 1)))
        first_pos = torch.where(found, pos, -1)
    else:
        first_pos = torch.full_like(count, -1)
    return (found, count.to(torch.int32), first_rank.to(torch.int32),
            first_pos.to(torch.int32))


def fm_meta(fa: FMArrays) -> torch.Tensor:
    """The (8,) int32 block ``fm_scan_cuda`` reads:
    ``[C0..C3, sent_row, rows, 0, 0]`` (``pallas_meta``'s layout)."""
    meta = torch.zeros(8, dtype=torch.int32, device=fa.device)
    meta[:4] = fa.cc[:4].to(torch.int32)
    meta[4] = fa.sent_row
    meta[5] = fa.n + 1
    return meta


# ---------------------------------------------------------------------------
# CUDA kernel: backward search over packed patterns, one thread per query
# ---------------------------------------------------------------------------
_P, _I = ctypes.c_void_p, ctypes.c_int


def fm_scan_cuda(patterns: torch.Tensor, plen: torch.Tensor,
                 bwt: torch.Tensor, occ: torch.Tensor, meta: torch.Tensor):
    """The ``fm_scan_pallas`` contract on CUDA, over packed patterns in
    place of the symbol plan.  patterns: (B, W) uint32, W <= 256; plen:
    (B,); bwt: (4 * nblk,) uint32 packed BWT (16-byte aligned); occ:
    (nblk + 1, 4) int32 checkpoints; meta: (8,) int32 ``[C0..C3,
    sent_row, rows, 0, 0]`` (``FMArrays.meta``).  Returns (lo, hi) int32
    (B,), exactly :func:`backward_search`'s."""
    if not patterns.is_cuda or patterns.dtype != torch.uint32 or \
            patterns.dim() != 2:
        raise ValueError(f"patterns must be a (B, W) uint32 CUDA tensor, "
                         f"got {patterns.dtype} {tuple(patterns.shape)} on "
                         f"{patterns.device}")
    B, W = (int(d) for d in patterns.shape)
    _build.check_width(W, "fm_scan")
    if not plen.is_cuda or tuple(plen.shape) != (B,):
        raise ValueError(f"plen must be a ({B},) CUDA tensor")
    if not bwt.is_cuda or bwt.dtype != torch.uint32 or bwt.dim() != 1:
        raise ValueError("bwt must be a 1-D uint32 CUDA tensor")
    if not occ.is_cuda or occ.dtype != torch.int32 or occ.dim() != 2 \
            or occ.shape[1] != 4:
        raise ValueError(f"occ must be an (nblk + 1, 4) int32 CUDA tensor, "
                         f"got {occ.dtype} {tuple(occ.shape)}")
    if not meta.is_cuda or meta.dtype != torch.int32 or \
            tuple(meta.shape) != (8,):
        raise ValueError("meta must be an (8,) int32 CUDA tensor")
    nblk = int(occ.shape[0]) - 1
    # every block the kernel reads, [0, nblk), lies inside the BWT
    if int(bwt.shape[0]) < nblk * WPB or nblk < 1:
        raise ValueError(f"bwt has {bwt.shape[0]} words for {nblk} "
                         f"checkpoint blocks of {WPB}")
    bwt = bwt.contiguous()
    if bwt.data_ptr() % 16:
        raise ValueError("bwt must be 16-byte aligned: the kernel reads a "
                         "block's 4 words as one vector")
    patterns = patterns.contiguous()
    plen = plen.to(torch.int32).contiguous()
    occ = occ.contiguous()
    lo = torch.empty(B, dtype=torch.int32, device=patterns.device)
    hi = torch.empty(B, dtype=torch.int32, device=patterns.device)
    if B == 0:
        return lo, hi
    fn = _build.launcher("fm_scan", "fm_scan_launch",
                         [_P, _P, _P, _I, _P, _P, _I, _I, _P, _P, _P])
    _build.check(fn(_build.ptr(patterns), _build.ptr(plen), _build.ptr(bwt),
                    nblk, _build.ptr(occ), _build.ptr(meta), B, W,
                    _build.ptr(lo), _build.ptr(hi),
                    _build.stream_of(patterns)), "fm_scan")
    _build.LAUNCHES["fm_scan"] += 1
    return lo, hi
