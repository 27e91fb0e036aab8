"""FM-index artifact of a frozen table — the port of ``repro.api.fm``.

``FMIndex`` owns one table's compressed base index (what
``SuffixTable.freeze()`` makes): it derives the BWT from the base suffix
array, packs it (2-bit for DNA, the ``pack2bit`` layout), builds the
blocked Occ checkpoints and the sampled-SA structures.  The build is
host numpy, as in the reference, and its arrays are byte-identical to
the reference's; the device view (:attr:`FMIndex.arrays`) lives on the
index's device (``cuda`` unless told otherwise), and so do the LF walks
that turn SA$ rows back into text positions.

Bytes per base (DNA, ``SB = 64``, ``sample_rate = 32``): packed BWT
0.25, Occ checkpoints 0.25, sampled SA 0.125, marked bitvector 0.125
and its rank words 0.125 — 0.875 B/base against 4 B/base for the live
tier's device suffix array.

Conventions (those of ``kernels.fm_scan`` and the binary-search path):
the index is over ``T$``; ``SA$ = [n] + SA`` because the base builder
orders equal-prefix suffixes shorter-first, which is the sentinel
order.  The sentinel row (``SA$ == 0``) stores dummy symbol 0 in the
BWT; Occ counts the raw stream and rank subtracts the dummy.

:meth:`FMIndex.save`/:meth:`FMIndex.load` keep the artifact in the
reference's format (a ``checkpoint.manager`` snapshot of
``state_dict()`` with ``extra_dict()``), so either package loads the
other's; :meth:`FMIndex.from_numpy` takes a reference index's arrays in
memory.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager, by_key
from repro_torch.core import codec
from repro_torch.core.suffix_array import build_suffix_array
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import fm_scan
from repro_torch.kernels.fm_scan import SB, WPB, FMArrays

FM_FORMAT = 1
DEFAULT_SAMPLE_RATE = 32
MAX_VOCAB = 64          # token tables above this stay on the live tier
LF_CHUNK = 2**24        # SA$ rows per device LF-walk chunk


def sa_is_fully_sorted(codes: np.ndarray, sa: np.ndarray) -> bool:
    """True iff ``sa`` is the FULL lexicographic suffix order of ``codes``
    (shorter-suffix-first on ties).  A merge-built SA is only ordered to
    the compare depth, which is not enough for a BWT; ``FMIndex.build``
    checks and re-sorts."""
    codes = np.asarray(codes)
    sa = np.asarray(sa)
    n = len(codes)
    if len(sa) != n:
        return False
    if n <= 1:
        return n == 0 or sa[0] == 0
    if int(sa.min()) < 0 or int(sa.max()) >= n:
        return False
    seen = np.zeros(n, dtype=bool)
    seen[sa] = True
    if not seen.all():                # a permutation of 0..n-1
        return False
    rank = np.empty(n + 1, dtype=np.int64)
    rank[sa] = np.arange(n)
    rank[n] = -1                      # empty suffix sorts first
    a, b = sa[:-1].astype(np.int64), sa[1:].astype(np.int64)
    ca, cb = codes[a].astype(np.int64), codes[b].astype(np.int64)
    ok = (ca < cb) | ((ca == cb) & (rank[a + 1] < rank[b + 1]))
    return bool(np.all(ok))


def segment_bounds(starts, counts) -> tuple[np.ndarray, int]:
    """Host bounds of row segments ``[start, start + count)``: a (2, S)
    int64 array of the starts over the inclusive prefix sums of the
    counts (each segment's exclusive end in the flat order of all their
    rows), and the total row count."""
    starts = np.asarray(starts, np.int64).reshape(-1)
    ends = np.cumsum(np.asarray(counts, np.int64).reshape(-1))
    return np.stack([starts, ends]), int(ends[-1]) if ends.size else 0


class FMIndex:
    """One table's frozen-tier index.  Host arrays are authoritative; the
    device view (:attr:`arrays`) is made on ``device`` at first use."""

    def __init__(self, *, bwt, occ, cc, marked, marked_rank, samples,
                 sent_row: int, n: int, is_dna: bool, sample_rate: int,
                 vocab: int, device: DeviceLike = None):
        self.bwt = bwt                    # DNA: (Wb,) u32 | tokens: (L,) u8
        self.occ = occ                    # (nblk + 1, vocab) int32
        self.cc = cc                      # (vocab,) int32
        self.marked = marked              # (Wm,) uint32
        self.marked_rank = marked_rank    # (Wm,) int32
        self.samples = samples            # (S,) int32
        self.sent_row = int(sent_row)
        self.n = int(n)
        self.is_dna = bool(is_dna)
        self.sample_rate = int(sample_rate)
        self.vocab = int(vocab)
        self.device = resolve_device(device)
        self._arrays: Optional[FMArrays] = None

    # ------------------------------------------------------------- build
    @classmethod
    def build(cls, codes: np.ndarray, sa_real=None, *, is_dna: bool,
              sample_rate: int = DEFAULT_SAMPLE_RATE,
              device: DeviceLike = None) -> "FMIndex":
        """Derive the index from text ``codes`` and (optionally) its base
        suffix array.  A missing or not fully sorted SA is rebuilt, so
        correctness never rests on a merge's compare depth."""
        codes = np.asarray(codes, dtype=np.uint8)
        n = len(codes)
        if n == 0:
            raise ValueError("cannot freeze an empty table")
        if sample_rate < 2:
            raise ValueError("sample_rate must be >= 2")
        vocab = 4 if is_dna else int(codes.max()) + 1
        if vocab > MAX_VOCAB:
            raise ValueError(
                f"vocab {vocab} exceeds the frozen tier's cap {MAX_VOCAB}")
        if sa_real is not None:
            sa_real = np.asarray(sa_real, dtype=np.int64)
        if sa_real is None or not sa_is_fully_sorted(codes, sa_real):
            sa_real = build_suffix_array(codec.as_tensor(
                codes, resolve_device(device))).cpu().numpy().astype(np.int64)

        rows = n + 1
        sa_dollar = np.empty(rows, dtype=np.int64)
        sa_dollar[0] = n                    # the $-only suffix
        sa_dollar[1:] = sa_real
        prev = sa_dollar - 1
        sent_row = int(np.nonzero(sa_dollar == 0)[0][0])
        bwt_codes = codes[np.where(prev >= 0, prev, 0)]
        bwt_codes[sent_row] = 0             # dummy symbol for $

        # C$[c] = 1 + #{symbols in T < c}  (the +1 is the sentinel)
        counts = np.bincount(codes, minlength=vocab).astype(np.int64)
        cc = (1 + np.concatenate(([0], np.cumsum(counts)[:-1]))).astype(
            np.int32)

        nblk = -(-rows // SB)
        if is_dna:
            packed = codec.pack_2bit_batch(bwt_codes[None, :])[0]
            pad_w = nblk * WPB - len(packed)
            if pad_w:
                packed = np.pad(packed, (0, pad_w))
            # Occ from the PACKED words (what rank reads), not the codes
            blocks = codec.unpack_2bit_batch(packed.reshape(nblk, WPB), SB)
            blocks = blocks.astype(np.int16)
            tail = np.arange(nblk * SB).reshape(nblk, SB) >= rows
            blocks[tail] = -1               # pad slots count as nothing
            bwt_store = packed
        else:
            padded = np.full(nblk * SB, -1, dtype=np.int16)
            padded[:rows] = bwt_codes
            blocks = padded.reshape(nblk, SB)
            bwt_store = bwt_codes
        per_blk = np.stack(
            [(blocks == c).sum(axis=1) for c in range(vocab)], axis=1)
        occ = np.zeros((nblk + 1, vocab), dtype=np.int32)
        occ[1:] = np.cumsum(per_blk, axis=0)

        # sampled SA: mark rows whose TEXT position is = 0 (mod k); the
        # p == 0 row is always marked, so every LF walk terminates
        mark = (sa_dollar % sample_rate) == 0
        wm = -(-rows // 32)
        bits = np.zeros(wm * 32, dtype=np.uint32)
        bits[:rows] = mark
        words = bits.reshape(wm, 32)
        marked = (words << np.arange(32, dtype=np.uint32)).sum(
            axis=1, dtype=np.uint32)
        per_word = words.sum(axis=1, dtype=np.int64)
        marked_rank = np.concatenate(
            ([0], np.cumsum(per_word)[:-1])).astype(np.int32)
        samples = sa_dollar[mark].astype(np.int32)

        return cls(bwt=bwt_store, occ=occ, cc=cc, marked=marked,
                   marked_rank=marked_rank, samples=samples,
                   sent_row=sent_row, n=n, is_dna=is_dna,
                   sample_rate=sample_rate, vocab=vocab, device=device)

    @classmethod
    def from_numpy(cls, state: dict, extra: dict,
                   device: DeviceLike = None) -> "FMIndex":
        """The port's index from a reference ``FMIndex``'s
        ``state_dict()`` and ``extra_dict()`` (numpy arrays and scalars):
        feeds one index to both packages."""
        if extra.get("kind") != "fm_index" or extra.get("sb") != SB \
                or extra.get("format") != FM_FORMAT:
            raise ValueError(f"not an FM index of format {FM_FORMAT} with "
                             f"SB={SB}: {extra!r}")
        is_dna = bool(extra["is_dna"])
        return cls(bwt=np.asarray(state["bwt"]).astype(
                       np.uint32 if is_dna else np.uint8),
                   occ=np.asarray(state["occ"], np.int32),
                   cc=np.asarray(state["cc"], np.int32),
                   marked=np.asarray(state["marked"], np.uint32),
                   marked_rank=np.asarray(state["marked_rank"], np.int32),
                   samples=np.asarray(state["samples"], np.int32),
                   sent_row=int(extra["sent_row"]), n=int(extra["n"]),
                   is_dna=is_dna, sample_rate=int(extra["sample_rate"]),
                   vocab=int(extra["vocab"]), device=device)

    # ------------------------------------------------------- device view
    @property
    def arrays(self) -> FMArrays:
        if self._arrays is None:
            dev = self.device
            bwt = (codec.as_tensor(np.asarray(self.bwt, np.uint32), dev)
                   if self.is_dna
                   else codec.as_tensor(np.asarray(self.bwt, np.int32), dev))
            self._arrays = FMArrays(
                bwt=bwt,
                occ=codec.as_tensor(self.occ, dev),
                cc=codec.as_tensor(self.cc, dev),
                marked=codec.as_tensor(self.marked, dev),
                marked_rank=codec.as_tensor(self.marked_rank, dev),
                samples=codec.as_tensor(self.samples, dev),
                sent_row=self.sent_row, n=self.n, is_dna=self.is_dna,
                sample_rate=self.sample_rate, vocab=self.vocab)
        return self._arrays

    # -------------------------------------------------------- LF walks
    @staticmethod
    def _lf_chunks(total: int):
        """The LF walks' one chunk rule: ``(c0, c1)`` bounds that cover the
        flat rows ``[0, total)`` in chunks of at most ``LF_CHUNK`` (read at
        each call)."""
        return ((c0, min(total, c0 + LF_CHUNK))
                for c0 in range(0, total, LF_CHUNK))

    def ranks_to_positions(self, rows) -> torch.Tensor:
        """``SA$[row]`` for a flat batch of rows (array-like or tensor), as
        an int64 tensor on the index's device: LF walks to the nearest
        sampled position (at most ``sample_rate`` steps each), run there
        in :meth:`_lf_chunks`, one ``lf_walk`` launch a chunk where
        ``fm_scan.walks_on_kernel``."""
        r = torch.as_tensor(rows).to(self.device, torch.int64).reshape(-1)
        parts = [fm_scan.walk_rows(self.arrays, r[c0:c1])
                 for c0, c1 in self._lf_chunks(r.numel())]
        return torch.cat(parts) if parts else r

    def segment_min_positions(self, starts,
                              counts) -> tuple[torch.Tensor, int]:
        """Per segment, the smallest text position among SA$ rows
        ``[start, start + count)`` (``count >= 1``), int64 on the index's
        device, so a short pattern's millions of rows never leave the
        device; and the number of rows the ``lf_walk`` kernel walked, as
        its wrapper reports the launch (0 on the plain walk).  The
        segments' bounds (:func:`segment_bounds`) are made on the host
        and sent in one copy.  Where ``fm_scan.walks_on_kernel``, one
        ``lf_walk`` launch walks every row and takes each segment's
        minimum, with no host sync before the caller reads it; elsewhere
        the rows of all segments are walked together in
        :meth:`_lf_chunks` and reduced into their segment with a
        scatter-min."""
        dev = self.device
        host, total = segment_bounds(starts, counts)
        if fm_scan.walks_on_kernel(self.arrays):
            # from pinned memory the copy joins the stream: no host sync
            bounds = torch.from_numpy(host).pin_memory().to(
                dev, non_blocking=True)
            return fm_scan.lf_walk_min_cuda(self.arrays, bounds, total)
        starts, ends = torch.from_numpy(host).to(dev)
        out = torch.full(starts.shape, np.iinfo(np.int64).max,
                         dtype=torch.int64, device=dev)
        begins = torch.cat((ends.new_zeros(1), ends[:-1]))
        for c0, c1 in self._lf_chunks(total):
            k = torch.arange(c0, c1, dtype=torch.int64, device=dev)
            seg = torch.searchsorted(ends, k, right=True)
            rows = starts[seg] + (k - begins[seg])
            out.scatter_reduce_(0, seg, fm_scan.lf_walk(self.arrays, rows),
                                reduce="amin")
        return out, 0

    def suffix_array(self) -> torch.Tensor:
        """The full real SA (rows 1..n of SA$), int64 on the index's
        device — what compaction of a frozen table would merge from."""
        return self.ranks_to_positions(
            torch.arange(1, self.n + 1, dtype=torch.int64))

    def count(self, patt, plen):
        """Host (count, first_rank) for an encoded batch (tests and
        benches); ``first_rank`` is the real-SA lower bound when found,
        -1 otherwise."""
        lo, hi = fm_scan.backward_search(
            self.arrays, torch.as_tensor(patt).to(self.device),
            torch.as_tensor(plen).to(self.device))
        lo = lo.cpu().numpy().astype(np.int64)
        hi = hi.cpu().numpy().astype(np.int64)
        return hi - lo, np.where(hi > lo, lo - 1, -1)

    # ------------------------------------------------------- persistence
    def state_dict(self) -> dict:
        return {"bwt": np.asarray(self.bwt), "occ": self.occ,
                "cc": self.cc, "marked": self.marked,
                "marked_rank": self.marked_rank, "samples": self.samples}

    def extra_dict(self) -> dict:
        return {"kind": "fm_index", "format": FM_FORMAT, "n": self.n,
                "sample_rate": self.sample_rate, "sb": SB,
                "is_dna": self.is_dna, "vocab": self.vocab,
                "sent_row": self.sent_row}

    def save(self, directory: str, version: int) -> str:
        mgr = CheckpointManager(directory, keep_n=2)
        return mgr.save(version, self.state_dict(), extra=self.extra_dict())

    @classmethod
    def load(cls, directory: str,
             device: DeviceLike = None) -> Optional["FMIndex"]:
        """Latest persisted artifact in ``directory`` on ``device``, or
        None when the dir is absent or empty or of another format (the
        caller rebuilds from codes then)."""
        if not os.path.isdir(directory):
            return None
        mgr = CheckpointManager(directory, keep_n=2)
        step = mgr.latest_step()
        if step is None:
            return None
        arrays, extra = mgr.restore_arrays(step)
        if extra.get("kind") != "fm_index" or extra.get("sb") != SB \
                or extra.get("format") != FM_FORMAT:
            return None
        return cls.from_numpy(by_key(arrays), extra, device=device)

    # ------------------------------------------------------------- stats
    def resident_bytes(self) -> int:
        """Index bytes (host copy == device copy sizes)."""
        return int(np.asarray(self.bwt).nbytes + self.occ.nbytes
                   + self.cc.nbytes + self.marked.nbytes
                   + self.marked_rank.nbytes + self.samples.nbytes)
