"""TabletStore and TierStack — the port of ``repro.core.tablet``.

The text is stored once (2-bit packed ``uint32`` words for DNA, int32
codes padded with -1 for every table) and the "table" is the globally
sorted suffix array.  Pad rows (positions ``n_real .. n_pad-1``) sort
first and are inert for every query.  Text positions stay below
``2**30``: ``BIG = 2**30`` is the "no match" sentinel downstream.

Over a tablet mesh (``launch.mesh.TabletMesh``) the sorted rows are
range-partitioned into contiguous tablets of ``m = n_pad / p`` rows, one
per mesh device (the split keys are implicit: tablet d owns sorted rows
``[d*m, (d+1)*m)``); :func:`shard_store` gives each tablet its view and
:func:`build_tablet_store` with ``mesh`` builds the suffix array by the
distributed prefix doubling of ``core.dsa``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import codec
from repro_torch.core.suffix_array import build_suffix_array
from repro_torch.device import DeviceLike, resolve_device

MAX_POSITIONS = 2**30


@dataclasses.dataclass(frozen=True)
class TabletStore:
    """One suffix-array "table".  ``sa`` is the padded, globally sorted
    suffix array; pad rows (positions >= n_real) sort first."""
    text_packed: Optional[torch.Tensor]  # (n_words,) uint32 | None
    text_codes: Optional[torch.Tensor]   # (n_pad,)  int32  | None
    sa: torch.Tensor                     # (n_pad,)  int32
    n_real: int
    n_pad: int
    is_dna: bool
    max_query_len: int

    @property
    def pad_count(self) -> int:
        return self.n_pad - self.n_real

    @property
    def device(self) -> torch.device:
        return self.sa.device

    def tablet_rows(self, num_tablets: int) -> int:
        if self.n_pad % num_tablets:
            raise ValueError(f"n_pad={self.n_pad} is not divisible by "
                             f"{num_tablets} tablets")
        return self.n_pad // num_tablets


def shard_store(store: TabletStore, mesh) -> list:
    """Per-tablet views of ``store`` over ``mesh``: view d's ``sa`` is
    tablet d's m sorted rows on its device; text, ``n_real`` and
    ``n_pad`` are the whole store's (the text replicated, one copy per
    distinct device; on the store's own device nothing is copied)."""
    p = mesh.size
    m = store.tablet_rows(p)
    texts: dict = {}
    views = []
    for d, dev in enumerate(mesh.devices):
        if dev not in texts:
            texts[dev] = tuple(None if t is None else t.to(dev)
                               for t in (store.text_packed,
                                         store.text_codes))
        views.append(dataclasses.replace(
            store, text_packed=texts[dev][0], text_codes=texts[dev][1],
            sa=store.sa[d * m:(d + 1) * m].to(dev)))
    return views


@dataclasses.dataclass
class TierStack:
    """All delta tiers (sealed runs + memtable) stacked into one
    rectangular device view; see ``repro.core.tablet.TierStack`` for the
    straddle rule ``lo < g + plen <= hi`` and the four host-precomputed
    structures (``ov_rank``/``hi_rank``/``pad_cnt``/``rmq``) the plain
    binary-search path uses to apply it.

    ``ov_rank``, ``hi_rank`` and ``rmq`` are None until
    :func:`fill_straddle` builds them for the plain path, the only one
    that reads them (the ``tier_scan`` kernel reads the packed text,
    ``sa`` and ``pad_cnt``); ``rmq`` is ``rows * log2(rows)`` int32 a
    tier, 0.8 GB for a 2**22-base run."""
    text_packed: Optional[torch.Tensor]  # (T, W_max)  uint32 | None
    text_codes: Optional[torch.Tensor]   # (T, rows)   int32
    sa: torch.Tensor                     # (T, rows)   int32, pad rows 0
    n_real: torch.Tensor                 # (T,) int32  compare depth cap
    n_rows: torch.Tensor                 # (T,) int32  real sorted rows
    offset: torch.Tensor                 # (T,) int32  local -> global
    lo: torch.Tensor                     # (T,) int32  owned range, open
    hi: torch.Tensor                     # (T,) int32  owned range, closed
    pad_cnt: torch.Tensor                # (T, rows+1) int32
    num_tiers: int
    rows: int
    is_dna: bool
    max_query_len: int
    ov_rank: Optional[torch.Tensor] = None   # (T, OV) int32
    hi_rank: Optional[torch.Tensor] = None   # (T, OV) int32
    rmq: Optional[torch.Tensor] = None       # (T, K, rows) int32

    @property
    def device(self) -> torch.device:
        return self.sa.device


def fill_straddle(stack: TierStack) -> TierStack:
    """``stack`` with the plain path's straddle structures, built once
    in host numpy as the reference builds them, on the stack's device:
    ``ov_rank``/``hi_rank`` the rows of the suffixes that start in a
    tier's overlap window or end within ``OV`` of its owned end, ``rmq``
    the sparse table of the smallest owned position over ``2**k`` rows."""
    if stack.rmq is not None:
        return stack
    T, rows = stack.num_tiers, stack.rows
    sa = stack.sa.cpu().numpy()
    n_pad, offset, lo, hi = (getattr(stack, k).cpu().numpy().astype(
        np.int64) for k in ("n_rows", "offset", "lo", "hi"))
    overlaps = lo - offset
    edge = max(int(overlaps.max()), stack.max_query_len - 1, 1)
    OV = 1 << (edge - 1).bit_length()
    K = rows.bit_length()                         # rows is a power of 2
    BIG = np.int32(MAX_POSITIONS)
    ov_rank = np.full((T, OV), BIG, np.int32)
    hi_rank = np.full((T, OV), BIG, np.int32)
    rmq = np.full((T, K, rows), BIG, np.int32)
    for t in range(T):
        sa_t = sa[t, :n_pad[t]]
        ov_t = int(overlaps[t])
        tl = int(hi[t] - offset[t])
        in_ov = np.flatnonzero(sa_t < ov_t)
        ov_rank[t, sa_t[in_ov]] = in_ov
        at_end = np.flatnonzero((sa_t >= max(tl - OV, 0)) & (sa_t < tl))
        hi_rank[t, tl - 1 - sa_t[at_end]] = at_end
        rmq[t, 0, :n_pad[t]] = np.where(
            (sa_t >= ov_t) & (sa_t < tl), sa_t + int(offset[t]), BIG)
        for k in range(1, K):
            h = 1 << (k - 1)
            rmq[t, k, :rows - h] = np.minimum(rmq[t, k - 1, :rows - h],
                                              rmq[t, k - 1, h:])
            rmq[t, k, rows - h:] = rmq[t, k - 1, rows - h:]
    stack.ov_rank = codec.as_tensor(ov_rank, stack.device)
    stack.hi_rank = codec.as_tensor(hi_rank, stack.device)
    stack.rmq = codec.as_tensor(rmq, stack.device)
    return stack


def stack_tier_stores(stores, *, offsets, bounds) -> TierStack:
    """Stack per-tier segment stores into one :class:`TierStack` on the
    stores' device.  ``offsets[t]`` is the tier's local->global shift,
    ``bounds[t] = (lo, hi)`` its owned global range.  Pad words/codes
    read as 0/-1, exactly what a tier's own arrays return past its end.
    The rows are copied and ``pad_cnt`` counted on the stores' device
    (no tier's arrays cross to the host: a read after every write
    restacks them); the plain path's straddle structures wait for it
    (:func:`fill_straddle`).  The tiers share one ``max_query_len``."""
    assert stores, "need at least one tier"
    T = len(stores)
    rows = max(s.n_pad for s in stores)
    is_dna, mq = stores[0].is_dna, stores[0].max_query_len
    assert all(s.is_dna == is_dna and s.max_query_len == mq
               for s in stores)
    meta = np.zeros((5, T), np.int32)
    meta[0] = [s.n_real for s in stores]
    meta[1] = [s.n_pad for s in stores]
    meta[2] = np.asarray(offsets, np.int32)
    meta[3] = [b[0] for b in bounds]
    meta[4] = [b[1] for b in bounds]
    for t, s in enumerate(stores):
        tl = int(meta[4][t]) - int(meta[2][t])    # true text length
        if not (0 <= int(meta[3][t]) - int(meta[2][t]) < tl <= s.n_real):
            raise ValueError(
                f"tier {t}: bounds ({int(meta[3][t])}, {int(meta[4][t])}) "
                f"inconsistent with offset={int(meta[2][t])}, "
                f"n_real={s.n_real}")
    dev = stores[0].device
    sa = torch.zeros((T, rows), dtype=torch.int32, device=dev)
    codes = torch.full((T, rows), -1, dtype=torch.int32, device=dev)
    pad_cnt = torch.zeros((T, rows + 1), dtype=torch.int32, device=dev)
    packed = None
    if is_dna:       # uint32 words moved as their int32 bits
        packed = torch.zeros((T, codec.packed_length(rows)),
                             dtype=torch.int32, device=dev)
    for t, s in enumerate(stores):
        n = s.n_pad
        sa[t, :n] = s.sa
        codes[t, :n] = s.text_codes
        tl = int(meta[4][t]) - int(meta[2][t])
        pad_cnt[t, 1:n + 1] = torch.cumsum(s.sa >= tl, 0)
        pad_cnt[t, n + 1:] = pad_cnt[t, n]
        if is_dna:
            packed[t, :s.text_packed.shape[0]] = s.text_packed.view(
                torch.int32)
    host = {k: codec.as_tensor(meta[i], dev) for i, k in enumerate(
        ("n_real", "n_rows", "offset", "lo", "hi"))}
    return TierStack(
        text_packed=None if packed is None else packed.view(torch.uint32),
        text_codes=codes, sa=sa, pad_cnt=pad_cnt, **host, num_tiers=T,
        rows=rows, is_dna=is_dna, max_query_len=mq)


def tierstack_from_numpy(fields: dict, device: DeviceLike = None
                         ) -> TierStack:
    """A :class:`TierStack` from a reference ``TierStack``'s fields given
    as numpy arrays / Python scalars (``text_packed`` may be None), its
    straddle structures among them."""
    dev = resolve_device(device)
    arrays = {k: (None if fields.get(k) is None
                  else codec.as_tensor(fields[k], dev))
              for k in ("text_packed", "text_codes", "sa", "n_real",
                        "n_rows", "offset", "lo", "hi", "pad_cnt",
                        "ov_rank", "hi_rank", "rmq")}
    return TierStack(**arrays, num_tiers=int(fields["num_tiers"]),
                     rows=int(fields["rows"]), is_dna=bool(fields["is_dna"]),
                     max_query_len=int(fields["max_query_len"]))


def _finalize_store(codes, sa: torch.Tensor, n_pad: int, *, is_dna: bool,
                    max_query_len: int) -> TabletStore:
    """Pack and pad the text on the SA's device.  DNA text is packed by
    the pack2bit kernel on a CUDA device (``kernels.ops.pack2bit``)."""
    from repro_torch.kernels import ops
    dev = sa.device
    c = codec.as_tensor(codes, dev)
    n_real = int(c.shape[0])
    if n_pad >= MAX_POSITIONS:
        raise ValueError(f"{n_pad} rows: text positions must stay below "
                         f"2**30 (the BIG no-match sentinel)")
    text_packed = ops.pack2bit(c.to(torch.uint8)) if is_dna else None
    text_codes = torch.nn.functional.pad(c.to(torch.int32),
                                         (0, n_pad - n_real), value=-1)
    return TabletStore(text_packed=text_packed, text_codes=text_codes,
                       sa=sa.to(torch.int32), n_real=n_real, n_pad=n_pad,
                       is_dna=bool(is_dna), max_query_len=max_query_len)


def store_from_arrays(codes, sa_real, *, is_dna: bool,
                      max_query_len: int = 128, num_tablets: int = 1,
                      min_rows: int = 0, device: DeviceLike = None
                      ) -> TabletStore:
    """Assemble a store from the text and its real-row suffix array
    (numpy or tensors).  Pad rows ``n_pad-1, ..., n_real`` are prepended:
    they sort before all real rows (see the reference's docstring)."""
    dev = resolve_device(device)
    c = codec.as_tensor(codes, dev)
    sa_real = codec.as_tensor(sa_real, dev).to(torch.int32)
    n_real = int(c.shape[0])
    if sa_real.shape[0] != n_real:
        raise ValueError(f"sa_real has {sa_real.shape[0]} rows for "
                         f"{n_real} text symbols")
    p = num_tablets
    m = int(np.ceil(max(n_real, min_rows, 1) / p))
    n_pad = m * p
    pads = torch.arange(n_pad - 1, n_real - 1, -1, dtype=torch.int32,
                        device=dev)
    return _finalize_store(c, torch.cat([pads, sa_real]), n_pad,
                           is_dna=bool(is_dna), max_query_len=max_query_len)


def store_from_numpy(fields: dict, device: DeviceLike = None
                     ) -> TabletStore:
    """The port's store from a reference ``TabletStore``'s fields as
    numpy arrays / scalars: ``text_packed`` (uint32 or None),
    ``text_codes``, ``sa``, ``n_real``, ``n_pad``, ``is_dna``,
    ``max_query_len``.  Feeds the same index to both packages."""
    dev = resolve_device(device)
    tp = fields.get("text_packed")
    tc = fields.get("text_codes")
    return TabletStore(
        text_packed=None if tp is None else codec.as_tensor(
            np.asarray(tp, np.uint32), dev),
        text_codes=None if tc is None else codec.as_tensor(
            np.asarray(tc, np.int32), dev),
        sa=codec.as_tensor(np.asarray(fields["sa"], np.int32), dev),
        n_real=int(fields["n_real"]), n_pad=int(fields["n_pad"]),
        is_dna=bool(fields["is_dna"]),
        max_query_len=int(fields["max_query_len"]))


def build_tablet_store(codes, *, is_dna: bool | None = None,
                       max_query_len: int = 128, num_tablets: int = 1,
                       min_rows: int = 0, mesh=None,
                       axis_name: str | None = None,
                       method: str = "bitonic",
                       device: DeviceLike = None) -> TabletStore:
    """Build the store: the suffix array by prefix doubling on one
    device (``cuda`` unless ``device`` says otherwise), or with ``mesh``
    by the distributed builder (``core.dsa``, ``method`` its sort) with
    the store on ``device`` (the first tablet's when None).  The text is
    packed on the store's device."""
    codes = np.asarray(codes)
    if is_dna is None:
        is_dna = codes.size > 0 and codes.max() < 4
    if mesh is not None:
        from repro_torch.core.dsa import build_suffix_array_distributed
        dev = mesh.devices[0] if device is None else resolve_device(device)
        sa, _pad = build_suffix_array_distributed(codes, mesh, axis_name,
                                                  method=method)
        return _finalize_store(codec.as_tensor(codes, dev), sa.to(dev),
                               int(sa.shape[0]), is_dna=bool(is_dna),
                               max_query_len=max_query_len)
    dev = resolve_device(device)
    c = codec.as_tensor(codes, dev)
    sa_real = build_suffix_array(c)
    return store_from_arrays(c, sa_real, is_dna=bool(is_dna),
                             max_query_len=max_query_len,
                             num_tablets=num_tablets, min_rows=min_rows,
                             device=dev)
