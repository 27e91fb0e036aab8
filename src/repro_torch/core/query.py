"""Pattern-match queries over a TabletStore — the port of
``repro.core.query``.

A scan is a batched lower/upper-bound search over the sorted suffix
array.  On a CUDA device a packed-DNA batch is ONE launch of the
``bounded_search`` kernel (``kernels/csrc/pattern_scan.cu``, a 17-ary
search, one warp per query) whose epilogue compares the reported row
and writes the result; everywhere
else (the CPU, token tables) the plain PyTorch binary search below
runs, one compare per round, mirroring the reference line by line.
Both return the same bounds, the exact partition points.

Over a tablet mesh (``launch.mesh``) two more scans run, single
controller, on the per-tablet views of ``tablet.shard_store``:
:func:`query_sharded` (every tablet searches its rows for every query;
bounds add up over contiguous tablets, so one ``psum`` gives the global
answer) and :func:`query_routed` (each query travels to the tablet that
owns its lower bound through a fixed-capacity ``all_to_all``; it returns
sentinel counts that ``core.planner`` retries).  Each tablet's bounds are
one ``bounded_search`` launch on the card (bounds only), and the routed
owner choice one ``pattern_compare`` launch per tablet.

Counts, ranks and positions are int32, as the reference's (JAX without
x64), so overflow behaves the same.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import TYPE_CHECKING

import numpy as np
import torch

from repro_torch.core import codec
from repro_torch.core.codec import MASK32, words_i64
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed import collectives as C

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
    """(lb, ub) int32 by the plain search: one compare per round, over
    every row of ``store.sa`` (a whole store's, or one tablet view's of
    ``tablet.shard_store``) against the store's text."""
    B = patt.shape[0]
    n = int(store.sa.shape[0])
    lb = _bounded_search(
        store.sa, lambda pos: _compare(store, pos, patt, plen)[0], B, n)
    ub = _bounded_search(
        store.sa,
        lambda pos: (lambda lt, eq: lt | eq)(*_compare(store, pos, patt,
                                                       plen)), B, n)
    return lb, ub


def _card(device: torch.device):
    """The device a tablet's kernel launches on: the kernels launch on
    the calling thread's current card, and a tablet may live on
    another."""
    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())


def tablet_bounds(tablet: "TabletStore", patt, plen):
    """(lb, ub) int32 of every query over one tablet's rows
    ``tablet.sa`` (a view of ``tablet.shard_store``): on CUDA a packed
    batch is one ``bounded_search`` launch (bounds only), elsewhere the
    plain binary search."""
    if is_packed(tablet, patt) and patt.is_cuda:
        from repro_torch.kernels import pattern_scan
        with _card(patt.device):
            return pattern_scan.bounded_search_cuda(
                tablet.sa, tablet.text_packed, tablet.n_real, patt, plen,
                int(tablet.sa.shape[0]))
    return search_bounds_plain(tablet, patt, plen)


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
# Distributed scans over the tablet mesh (single controller)
# ---------------------------------------------------------------------------
def _take(sa_local: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    m = int(sa_local.shape[0])
    return sa_local[idx.clamp(0, m - 1).to(torch.int64)]


def take_rows(x: torch.Tensor, *index) -> torch.Tensor:
    """``x[index[0]][index[1]]...``; packed uint32 words move as int32
    bits (neither CUDA nor the CPU indexes uint32)."""
    bits = x.view(torch.int32) if x.dtype == torch.uint32 else x
    for at in index:
        bits = bits[at]
    return bits.view(x.dtype)


def query_sharded(tablets, patt, plen) -> MatchResult:
    """The paper's Accumulo fan-out: every tablet searches its own rows
    for every query, and the bounds add up.  ``tablets`` are the
    per-tablet views of ``tablet.shard_store`` (``sa`` the tablet's m
    rows, the text replicated); the result lies on ``patt``'s device."""
    p = len(tablets)
    m = int(tablets[0].sa.shape[0])
    lbs, ubs = [], []
    for t in tablets:                                   # local search
        lb, ub = tablet_bounds(t, patt.to(t.device), plen.to(t.device))
        lbs.append(lb)
        ubs.append(ub)
    lbs, ubs = C.psum(lbs), C.psum(ubs)                 # one psum each
    mines = []
    for d, t in enumerate(tablets):
        # the tablet owning the global lower bound reports its position
        lb = lbs[d]
        owner_is_me = (lb >= d * m) & (lb < (d + 1) * m)
        mines.append(torch.where(owner_is_me, _take(t.sa, lb - d * m), 0)
                     .to(torch.int32))
    first_pos = C.psum(mines)[0].to(patt.device)
    lb, ub = lbs[0].to(patt.device), ubs[0].to(patt.device)
    count = (ub - lb).to(torch.int32)
    found = count > 0
    pad_count = tablets[0].pad_count
    return MatchResult(
        found=found, count=count,
        first_rank=torch.where(found, lb - pad_count, -1).to(torch.int32),
        first_pos=torch.where(found, first_pos, -1).to(torch.int32))


def owner_lt_count(tablet: "TabletStore", split_pos: torch.Tensor,
                   patt: torch.Tensor, plen: torch.Tensor) -> torch.Tensor:
    """Per query, how many tablets' FIRST suffix (at ``split_pos``, (p,))
    sorts strictly before the pattern: (B,) int32.  The (B*p, W) tiled
    compare is ``pattern_compare``'s contract (``ops.pattern_compare``:
    the kernel on CUDA, ``ref.pattern_compare_ref`` elsewhere)."""
    from repro_torch.kernels import ops
    p = int(split_pos.shape[0])
    B, W = patt.shape
    win = codec.extract_window(tablet.text_packed, split_pos, W)
    args = (win.repeat(B, 1), patt.repeat_interleave(p, 0),
            plen.repeat_interleave(p), split_pos.repeat(B))
    with _card(patt.device):
        lt = ops.pattern_compare(*args, n_real=tablet.n_real)[0]
    return lt.view(B, p).sum(dim=1, dtype=torch.int32)


def query_routed(tablets, patt, plen, capacity_factor: float = 2.0
                 ) -> MatchResult:
    """Each query travels to the tablet owning its lower bound: a
    fixed-capacity ``all_to_all`` out, one search on the owner's rows, a
    correction against the RIGHT neighbour only (a run may spill past
    the owner's last row), an ``all_to_all`` back and the un-permute.
    ``patt``/``plen`` are the whole batch, B a multiple of p; tablet d
    dispatches rows ``[d*B/p, (d+1)*B/p)``.  Counts: > 0 exact, 0 no
    match, -1 dispatch overflow (never run; found False), -2 a match
    run over more than two tablets (found and first_pos exact)."""
    p = len(tablets)
    m = int(tablets[0].sa.shape[0])
    B, W = patt.shape
    if B % p:
        raise ValueError(f"routed batch {B} is not a multiple of the "
                         f"{p} tablets")
    Bl = B // p
    pad_count = tablets[0].pad_count
    devs = [t.device for t in tablets]
    # --- split keys: the first suffix of every tablet (replicated)
    split_pos = C.all_gather([t.sa[:1].reshape(()) for t in tablets])

    # --- owner tablet per query: a = #{tablets whose first suffix < P};
    # the lower bound lives in tablet a-1 (or on its boundary, which the
    # spill correction covers); then the fixed-capacity dispatch
    cap = max(4, int(np.ceil(Bl / p * capacity_factor)))
    ar = torch.arange(Bl, dtype=torch.int64)
    send_patt, send_len, plans = [], [], []
    for d, t in enumerate(tablets):
        lp = patt[d * Bl:(d + 1) * Bl].to(devs[d])
        ll = plen[d * Bl:(d + 1) * Bl].to(devs[d]).to(torch.int32)
        a = owner_lt_count(t, split_pos[d], lp, ll)
        owner = (a - 1).clamp(0, p - 1)
        order = torch.sort(owner, stable=True).indices
        o_s = owner[order]
        start = torch.searchsorted(o_s, torch.arange(p, dtype=torch.int32,
                                                     device=devs[d]))
        slot_in = ar.to(devs[d]) - start[o_s.to(torch.int64)]
        ok = slot_in < cap
        slot = torch.where(ok, o_s.to(torch.int64) * cap + slot_in, p * cap)
        plans.append((order, ok, slot))
        # (the words move as int32 bits: the CPU has no uint32 scatter)
        sp = torch.zeros((p * cap, W), dtype=torch.int32, device=devs[d])
        sl = torch.full((p * cap,), -1, dtype=torch.int32, device=devs[d])
        sp[slot[ok]] = take_rows(lp, order, ok).view(torch.int32)
        sl[slot[ok]] = ll[order][ok]
        send_patt.append(sp.view(lp.dtype).reshape(p, cap, W))
        send_len.append(sl.reshape(p, cap))
    recv_patt = [x.reshape(-1, W) for x in C.all_to_all(send_patt)]
    recv_len = [x.reshape(-1) for x in C.all_to_all(send_len)]

    # --- the search on the owner's rows only
    cnts, fposs, franks, spills, rls = [], [], [], [], []
    for d, t in enumerate(tablets):
        valid = recv_len[d] >= 0
        rl = torch.where(valid, recv_len[d], 1).to(torch.int32)
        lb, ub = tablet_bounds(t, recv_patt[d], rl)
        cnt = (ub - lb).to(torch.int32)
        cnts.append(cnt)
        fposs.append(torch.where(cnt > 0, _take(t.sa, lb), -1))
        franks.append(torch.where(cnt > 0, d * m + lb - pad_count, -1))
        # the run may continue in the next tablet (none past the last)
        spills.append((cnt >= 0) & (ub == m) & valid & (d < p - 1))
        rls.append(rl)

    # --- spill correction: tablet d searches the queries owned by d-1
    # (patterns travel right, r -> r+1) and the answers travel back left
    perm_right = [(r, (r + 1) % p) for r in range(p)]
    perm_left = [(r, (r - 1) % p) for r in range(p)]
    nb_patt = C.ppermute(recv_patt, perm_right)
    nb_len = C.ppermute(rls, perm_right)
    nb_cnt, nb_sat, nb_first, nb_rank = [], [], [], []
    for d, t in enumerate(tablets):
        lb, ub = tablet_bounds(t, nb_patt[d], nb_len[d])
        c = (ub - lb).to(torch.int32)
        nb_cnt.append(c)
        nb_sat.append(ub == m)
        nb_first.append(torch.where(c > 0, _take(t.sa, lb), -1)
                        .to(torch.int32))
        nb_rank.append(torch.where(c > 0, d * m + lb - pad_count, -1)
                       .to(torch.int32))
    spill_cnt = C.ppermute(nb_cnt, perm_left)
    spill_sat = C.ppermute(nb_sat, perm_left)
    spill_first = C.ppermute(nb_first, perm_left)
    spill_rank = C.ppermute(nb_rank, perm_left)
    backs = []
    for d in range(p):
        cnt = torch.where(spills[d], cnts[d] + spill_cnt[d], cnts[d])
        fpos = torch.where((cnt > 0) & (fposs[d] < 0), spill_first[d],
                           fposs[d])
        frank = torch.where((cnt > 0) & (franks[d] < 0), spill_rank[d],
                            franks[d])
        # a run over more than two tablets: exact count needs broadcast
        cnt = torch.where(spills[d] & spill_sat[d], -2, cnt)
        backs.append([x.to(torch.int32).reshape(p, cap)
                      for x in (cnt, fpos, frank)])

    # --- route the results back and un-permute into query order
    back = [[x.reshape(-1) for x in C.all_to_all([b[i] for b in backs])]
            for i in range(3)]
    outs = []
    for d in range(p):
        order, ok, slot = plans[d]
        at = slot.clamp(0, p * cap - 1)
        got = [torch.where(ok, back[i][d][at], -1) for i in range(3)]
        res = [torch.full((Bl,), -1, dtype=torch.int32, device=devs[d]),
               torch.zeros((Bl,), dtype=torch.int32, device=devs[d]),
               torch.zeros((Bl,), dtype=torch.int32, device=devs[d])]
        for r, g in zip(res, got):
            r[order] = g.to(torch.int32)
        outs.append([r.to(patt.device) for r in res])
    out_cnt, out_pos, out_rank = (torch.cat([o[i] for o in outs])
                                  for i in range(3))
    found = (out_cnt > 0) | (out_cnt == -2)
    return MatchResult(
        found=found, count=out_cnt,
        first_rank=torch.where(found, out_rank, -1).to(torch.int32),
        first_pos=torch.where(found, out_pos, -1).to(torch.int32))


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
