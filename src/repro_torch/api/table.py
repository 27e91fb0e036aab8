"""``SuffixTable`` — the in-memory subset of ``repro.api.table``.

Build a table over a text (:meth:`SuffixTable.from_codes`, on ``cuda``
unless ``device`` says otherwise), read it with :meth:`count` /
:meth:`contains` / :meth:`scan` / :meth:`locate` / :meth:`locate_range`,
and write it with :meth:`append` into the memtable and
:meth:`minor_compact` into sealed runs (automatic at
``memtable_limit``).  With delta tiers live, every read is one fused
merged dispatch over base + runs + memtable (``ScanPlanner.
scan_tiers``), each tier owning the occurrences that END in its region.

:meth:`freeze` (or the ``fm_threshold`` policy) moves the base onto a
compressed FM index (``api.fm.FMIndex``) and drops the live suffix array
and the device text; base reads then run the FM backward search, and
text positions come from LF walks on the device.

Not ported yet, and raising ``NotImplementedError`` when asked for:
persistence (``root``, ``create``/``open``/``flush``), the commit log
(``wal``), major compaction (``compact``, ``max_runs``) and meshes.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from repro_torch.api.fm import MAX_VOCAB, FMIndex
from repro_torch.api.memtable import Memtable
from repro_torch.api.runs import Run, TierSet, logical_tail
from repro_torch.core import codec
from repro_torch.core.planner import ScanOutcome, ScanPlanner, TopKCache
from repro_torch.core.query import MatchResult
from repro_torch.core.suffix_array import build_suffix_array
from repro_torch.core.tablet import TabletStore, store_from_arrays
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.serving.trace import Tracer

# keyword arguments of repro's SuffixTable that this slice does not port
_UNPORTED = ("root", "version", "keep_n", "wal", "group_commit_ms",
             "max_runs", "distributed_build", "capacity_factor",
             "routed_min_batch", "mesh")


def _check_unported(kw: dict) -> None:
    for k in kw:
        if k in _UNPORTED:
            raise NotImplementedError(
                f"SuffixTable({k}=...) is not ported to repro_torch yet "
                f"(in-memory, single-device tables only)")
        raise TypeError(f"unexpected keyword argument {k!r}")


def _as_codes(codes, is_dna: Optional[bool]):
    """DNA strings/bytes become uint8 codes; DNA is inferred only for
    uint8 arrays with codes < 4 (as in the reference)."""
    if isinstance(codes, (str, bytes, bytearray)):
        return codec.encode_dna(codes), True
    codes = np.asarray(codes)
    if is_dna is None:
        is_dna = bool(codes.size > 0 and codes.dtype == np.uint8
                      and codes.max() < 4)
    return codes, bool(is_dna)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class SuffixTable:
    """A mutable, in-memory suffix-array table on one device."""

    def __init__(self, codes: np.ndarray, sa_real, *, is_dna: bool,
                 max_query_len: int = 128, name: Optional[str] = None,
                 cache_size: int = 4096,
                 memtable_limit: Optional[int] = None,
                 fm_threshold: Optional[int] = None,
                 device: DeviceLike = None,
                 _store: Optional[TabletStore] = None,
                 _planner: Optional[ScanPlanner] = None, **unported):
        _check_unported(unported)
        self.name = name
        self.is_dna = bool(is_dna)
        self.max_query_len = int(max_query_len)
        self.cache_size = int(cache_size)
        self.memtable_limit = memtable_limit
        self.fm_threshold = fm_threshold
        self.fm: Optional[FMIndex] = None
        self.runs: list[Run] = []
        self._codes = np.asarray(codes)
        self.tracer = Tracer()
        if _store is not None:
            self.device = _store.device
            self.store = _store
            self.planner = _planner or ScanPlanner(
                _store, cache_size=cache_size, tracer=self.tracer)
            if _planner is not None:
                self.tracer = _planner.tracer
        else:
            self.device = resolve_device(device)
            self.store = store_from_arrays(
                self._codes, sa_real, is_dna=self.is_dna,
                max_query_len=self.max_query_len, device=self.device)
            self.planner = ScanPlanner(self.store, cache_size=cache_size,
                                       tracer=self.tracer)
        self.memtable = Memtable(self._codes, is_dna=self.is_dna,
                                 max_query_len=self.max_query_len,
                                 device=self.device)
        self._tiers: Optional[TierSet] = None
        self._tiers_valid = False
        self._cache = TopKCache(cache_size)
        self._build: Optional[dict] = None

    # -- construction --------------------------------------------------------
    @classmethod
    def from_codes(cls, codes, *, is_dna: Optional[bool] = None,
                   max_query_len: int = 128, device: DeviceLike = None,
                   **kw) -> "SuffixTable":
        """In-memory table built over ``codes`` now, on ``device``
        (``cuda`` when None): the SA by prefix doubling there, the text
        packed there by the pack2bit kernel."""
        _check_unported({k: v for k, v in kw.items() if k in _UNPORTED})
        dev = resolve_device(device)
        codes, is_dna = _as_codes(codes, is_dna)
        _sync(dev)
        t0 = time.perf_counter()
        sa = build_suffix_array(codec.as_tensor(codes, dev))
        table = cls(codes, sa, is_dna=is_dna, max_query_len=max_query_len,
                    device=dev, **kw)
        _sync(dev)
        elapsed = time.perf_counter() - t0
        n = int(codes.shape[0])
        table._build = {"mode": "in_memory", "n_bases": n,
                        "elapsed_s": elapsed,
                        "bases_per_s": n / elapsed if elapsed > 0 else 0.0}
        table._maybe_freeze()
        return table

    @classmethod
    def from_store(cls, store: TabletStore, *,
                   planner: Optional[ScanPlanner] = None,
                   **kw) -> "SuffixTable":
        """Wrap an existing :class:`TabletStore` (and optional planner)."""
        codes = store.text_codes[:store.n_real].cpu().numpy()
        if store.is_dna:
            codes = codes.astype(np.uint8)
        return cls(codes, None, is_dna=store.is_dna,
                   max_query_len=store.max_query_len,
                   _store=store, _planner=planner, **kw)

    @classmethod
    def create(cls, *args, **kw):
        raise NotImplementedError("persistent tables (create) are not "
                                  "ported to repro_torch yet")

    @classmethod
    def open(cls, *args, **kw):
        raise NotImplementedError("persistent tables (open) are not "
                                  "ported to repro_torch yet")

    def flush(self) -> None:
        raise NotImplementedError("flush is not ported to repro_torch yet")

    def freeze(self, *, sample_rate: int = 32) -> "SuffixTable":
        """Move the base tier onto a frozen FM index: the BWT is derived
        from the current base SA (host numpy), 2-bit-packed with blocked
        Occ checkpoints and a sampled SA, and the live suffix array and
        device text are dropped (the index takes ~0.875 bytes per base
        against the device SA's 4).
        Base reads then run the FM backward search; appends keep landing
        in the memtable and runs and merge through the fused tier path.
        Idempotent."""
        if self.fm is not None:
            return self
        sa_real = self.store.sa[self.store.pad_count:].cpu().numpy()
        fm = FMIndex.build(self._codes, sa_real, is_dna=self.is_dna,
                           sample_rate=sample_rate, device=self.device)
        self._attach_frozen(fm)
        return self

    def _maybe_freeze(self) -> None:
        """The ``fm_threshold`` policy: freeze once the base reaches the
        threshold (a no-op for token tables above the frozen vocab
        cap)."""
        if (self.fm is None and self.fm_threshold is not None
                and self.n_base >= int(self.fm_threshold)):
            if (not self.is_dna and self._codes.size
                    and int(self._codes.max()) >= MAX_VOCAB):
                return
            self.freeze()

    def _attach_frozen(self, fm: FMIndex) -> None:
        """Swap the base onto ``fm``.  The store becomes metadata only
        (no text, an empty SA on the table's device, so ``store.device``
        still resolves); the host codes stay for the memtable's overlap
        window."""
        if fm.n != self.n_base or fm.is_dna != self.is_dna:
            raise ValueError(
                f"FM-index (n={fm.n}, is_dna={fm.is_dna}) does not match "
                f"the table (n={self.n_base}, is_dna={self.is_dna})")
        self.fm = fm
        self.store = TabletStore(
            text_packed=None, text_codes=None,
            sa=torch.zeros((0,), dtype=torch.int32, device=self.device),
            n_real=self.n_base, n_pad=self.n_base, is_dna=self.is_dna,
            max_query_len=self.max_query_len)
        self.planner.rebind(self.store, fm=fm)

    def compact(self) -> int:
        raise NotImplementedError("major compaction is not ported to "
                                  "repro_torch yet")

    # -- introspection -------------------------------------------------------
    def __len__(self) -> int:
        return self.n_logical + self.memtable.size

    @property
    def n_base(self) -> int:
        return int(self._codes.shape[0])

    @property
    def n_logical(self) -> int:
        """Symbols covered by base + sealed runs (the memtable's start)."""
        return self.n_base + sum(r.length for r in self.runs)

    @property
    def is_frozen(self) -> bool:
        """True when the base tier serves from the FM index."""
        return self.fm is not None

    def stats(self) -> dict:
        """Observability snapshot: identity, ``tiers`` (symbols per LSM
        level), the table's string ``cache``, ``build`` (how the base was
        built), ``planner`` (``PlannerStats.as_dict()``) and ``latency``
        (span histograms)."""
        return {
            "name": self.name,
            "is_dna": self.is_dna,
            "max_query_len": self.max_query_len,
            "device": str(self.device),
            "tiers": {
                "base_rows": self.n_base,
                "run_count": len(self.runs),
                "run_rows": self.n_logical - self.n_base,
                "memtable_rows": self.memtable.size,
                "frozen": self.fm is not None,
                "resident_bytes": self._resident_bytes(),
            },
            "cache": {
                "entries": len(self._cache),
                "hits": self._cache.hits,
                "misses": self._cache.misses,
                "generation": self._cache.generation,
            },
            "build": self._build,
            "planner": self.planner.stats.as_dict(),
            "latency": self.tracer.snapshot(),
        }

    def _resident_bytes(self) -> dict:
        """Per-tier index bytes (the reference's schema): ``base_sa`` the
        device SA plus the planner's host copy, ``text_device`` the
        packed and padded device text (both 0 once frozen, where ``fm``
        holds the index), ``text_host`` the raw codes every table
        keeps."""
        base_sa = int(self.store.sa.numel()) * 4
        if self.planner._sa_host is not None:
            base_sa += int(self.planner._sa_host.nbytes)
        text_dev = sum(int(t.numel()) * 4 for t in (self.store.text_packed,
                                                    self.store.text_codes)
                       if t is not None)
        run_bytes = 0
        for r in self.runs:
            run_bytes += int(r.tail.nbytes) + int(r.codes.nbytes)
            if r._sa_host is not None:
                run_bytes += int(r._sa_host.nbytes)
        return {
            "base_sa": base_sa,
            "fm": self.fm.resident_bytes() if self.fm is not None else 0,
            "text_device": text_dev,
            "runs": run_bytes,
            "memtable": int(self.memtable.size),
            "text_host": int(self._codes.nbytes),
        }

    def _invalidate_caches(self) -> None:
        self._cache.bump()
        self.planner.invalidate_cache()
        self._tiers = None
        self._tiers_valid = False

    def clear_cache(self) -> None:
        self._cache.clear()
        self.planner.clear_cache()

    def _reset_memtable(self) -> None:
        """Fresh empty memtable whose overlap window is the tail of the
        current logical text (base + sealed runs)."""
        n = self.n_logical
        tail = logical_tail([self._codes] + [r.codes for r in self.runs],
                            min(self.max_query_len - 1, n))
        self.memtable = Memtable(tail.astype(self._codes.dtype, copy=False),
                                 is_dna=self.is_dna,
                                 max_query_len=self.max_query_len,
                                 device=self.device, n_base=n)
        self._tiers = None
        self._tiers_valid = False

    # -- read path -----------------------------------------------------------
    def _tierset(self) -> Optional[TierSet]:
        """The cached delta-tier snapshot (None: base-only fast path)."""
        if not self._tiers_valid:
            self._tiers = TierSet.build(self.runs, self.memtable)
            self._tiers_valid = True
        return self._tiers

    def _scan_tiers(self, patt, plen):
        """One fused merged dispatch: (merged MatchResult, TierScanResult
        | None, delta positions per query | None, base-only count).  The
        merged ``first_pos`` is not filled on a frozen table: every
        caller derives text-order positions from the base rows itself."""
        merged, tres = self.planner.scan_tiers(self._tierset(), patt, plen,
                                               first_pos=False)
        count = merged.count.cpu().numpy().astype(np.int64)
        if tres is None:
            return merged, None, None, count
        delta = self._tiers.delta_positions(tres.less, tres.matches, plen)
        base_count = count - tres.count.cpu().numpy().astype(
            np.int64).sum(axis=0)
        return merged, tres, delta, base_count

    def _base_min_positions(self, base_count: np.ndarray,
                            base_rank: np.ndarray) -> np.ndarray:
        """Per query, the smallest BASE text position among its base-tier
        matches (-1 when none): the min of each SA slice ``[lb, lb +
        count)``, reduced in place on the store's device, one reduction
        per matching query and one host copy for the batch.  (The
        reference gathers every slice into one flat array first; at
        chromosome scale a short pattern's slice holds millions of rows,
        and that gather dominated a batch.)  A frozen table has no SA:
        its rows are LF-walked and min-reduced on the index's device."""
        B = int(base_count.shape[0])
        out = np.full(B, -1, np.int64)
        nz = np.flatnonzero((base_count > 0) & (base_rank >= 0))
        if nz.size == 0:
            return out
        starts = self.store.pad_count + base_rank[nz].astype(np.int64)
        if self.fm is not None:
            # real-SA row r is SA$ row r + 1
            out[nz] = self.fm.segment_min_positions(
                starts + 1, base_count[nz]).cpu().numpy()
            return out
        sa = self.store.sa
        ends = starts + base_count[nz].astype(np.int64)
        mins = torch.stack([sa[s:e].min()
                            for s, e in zip(starts.tolist(), ends.tolist())])
        out[nz] = mins.cpu().numpy()
        return out

    def scan_encoded(self, patt, plen, *, mode: Optional[str] = None
                     ) -> MatchResult:
        """Exact merged scan of an encoded batch; ``first_rank`` refers to
        the BASE suffix array (-1 when only delta tiers match)."""
        merged, _tres = self.planner.scan_tiers(self._tierset(), patt,
                                                plen, mode=mode)
        return merged

    def _base_slice(self, base_count, base_rank, i) -> np.ndarray:
        """Base-tier SA slice of row ``i``'s matches (suffix-rank order)."""
        cb = int(base_count[i])
        if cb <= 0 or base_rank[i] < 0:
            return np.zeros((0,), np.int64)
        lb = self.store.pad_count + int(base_rank[i])
        if self.fm is not None:
            rows = torch.arange(lb + 1, lb + 1 + cb, dtype=torch.int64)
            return self.fm.ranks_to_positions(rows).cpu().numpy()
        return self.store.sa[lb:lb + cb].cpu().numpy().astype(np.int64)

    def scan_batch(self, patt, plen, top_k: int = 0) -> ScanOutcome:
        """Merged scan of an encoded batch with **text-order** semantics:
        exact counts, ``first_pos`` the smallest occurrence position,
        ``positions`` the ``top_k`` smallest, ascending, -1 padded.  (The
        reference pads the batch to a power-of-two bucket to bound jit
        compilations; eager PyTorch compiles nothing, so it does not.)"""
        B = int(plen.shape[0])
        if B == 0:
            return ScanOutcome(
                found=np.zeros(0, bool), count=np.zeros(0, np.int64),
                first_pos=np.full(0, -1, np.int64),
                positions=(np.full((0, top_k), -1, np.int64)
                           if top_k else None))
        tr = self.tracer
        t_all = time.monotonic_ns()
        with tr.span("dispatch"):
            merged, _tres, delta, base_count = self._scan_tiers(patt, plen)
        with tr.span("merge"):
            count = merged.count.cpu().numpy().astype(np.int64)
            base_rank = merged.first_rank.cpu().numpy()
            first_pos = self._base_min_positions(base_count, base_rank)
            positions = (np.full((B, top_k), -1, np.int64)
                         if top_k else None)
            for i in range(B):
                g = (delta[i] if delta is not None
                     else np.zeros((0,), np.int64))
                if g.size and (first_pos[i] < 0 or g[0] < first_pos[i]):
                    first_pos[i] = int(g[0])
                if top_k:
                    run = self._base_slice(base_count, base_rank, i)
                    cand = np.concatenate([run, g])
                    if cand.size > top_k:
                        cand = np.partition(cand, top_k - 1)[:top_k]
                    cand.sort()
                    positions[i, :cand.size] = cand
        tr.record("total", (time.monotonic_ns() - t_all) / 1e6)
        return ScanOutcome(found=count > 0, count=count,
                           first_pos=first_pos, positions=positions)

    def scan(self, patterns: list[str], top_k: int = 0) -> ScanOutcome:
        """String-level merged scan with text-order semantics, LRU-cached;
        every write generation-bumps the cache."""
        B = len(patterns)
        count = np.zeros(B, np.int64)
        first_pos = np.full(B, -1, np.int64)
        positions = (np.full((B, top_k), -1, np.int64) if top_k else None)
        miss_idx: list[int] = []
        for i, pat in enumerate(patterns):
            hit = self._cache.get(pat, top_k)
            if hit is not None:
                count[i], first_pos[i] = hit[0], hit[1]
                if top_k:
                    positions[i] = hit[2]
            else:
                miss_idx.append(i)
        if miss_idx:
            with self.tracer.span("encode"):
                patt, plen = self.planner.encode(
                    [patterns[i] for i in miss_idx])
            sub = self.scan_batch(patt, plen, top_k=top_k)
            for j, i in enumerate(miss_idx):
                count[i] = sub.count[j]
                first_pos[i] = sub.first_pos[j]
                row = sub.positions[j] if top_k else None
                if top_k:
                    positions[i] = row
                self._cache.put(patterns[i], int(count[i]),
                                int(first_pos[i]), top_k, row)
        return ScanOutcome(found=count > 0, count=count,
                           first_pos=first_pos, positions=positions)

    def locate_range(self, pattern: str, *, after: int = -1,
                     limit: Optional[int] = 256) -> np.ndarray:
        """Up to ``limit`` occurrence positions of ``pattern`` strictly
        greater than ``after``, ascending int64 (``limit=None``: all)."""
        if limit is not None and limit <= 0:
            raise ValueError(f"limit must be positive, got {limit}")
        patt, plen = self.planner.encode([pattern])
        merged, _tres, delta, base_count = self._scan_tiers(patt, plen)
        run = self._base_slice(base_count,
                               merged.first_rank.cpu().numpy(), 0)
        g = delta[0] if delta is not None else np.zeros((0,), np.int64)
        cand = np.concatenate([run, g]) if g.size else run
        cand = cand[cand > after]
        if limit is not None and cand.size > limit:
            cand = np.partition(cand, limit - 1)[:limit]
        cand.sort()
        return cand.astype(np.int64)

    def count(self, patterns: list[str]) -> np.ndarray:
        """Exact occurrence counts, (B,) int64."""
        return self.scan(patterns).count

    def contains(self, patterns: list[str]) -> np.ndarray:
        """Per-pattern membership, (B,) bool."""
        return self.scan(patterns).found

    def locate(self, patterns: list[str], top_k: int = 8) -> np.ndarray:
        """Up to ``top_k`` smallest occurrence positions per pattern,
        ascending, (B, top_k) int64, -1 padded."""
        return self.scan(patterns, top_k=top_k).positions

    # -- write path ----------------------------------------------------------
    def append(self, codes) -> int:
        """Append text (memtable write path); visible to every later read
        with exact merged counts.  Returns the memtable size; seals the
        memtable (:meth:`minor_compact`) at ``memtable_limit``."""
        if isinstance(codes, (str, bytes, bytearray)):
            if not self.is_dna:
                raise TypeError("string appends are DNA-only; pass a code "
                                "array for token tables")
            codes = codec.encode_dna(codes)
        codes = Memtable.validate_codes(codes, is_dna=self.is_dna)
        if codes.size == 0:
            return self.memtable.size
        self.memtable.append(codes, _prevalidated=True)
        self._invalidate_caches()
        if (self.memtable_limit is not None
                and self.memtable.size >= self.memtable_limit):
            self.minor_compact()
        return self.memtable.size

    def minor_compact(self) -> int:
        """Seal the memtable into an immutable :class:`Run` and start a
        fresh one.  No-op on an empty memtable.  Returns the run count."""
        if self.memtable.size == 0:
            return len(self.runs)
        self.runs.append(Run.from_memtable(self.memtable))
        self._reset_memtable()
        self._invalidate_caches()
        return len(self.runs)
