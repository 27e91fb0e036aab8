"""``SuffixTable`` — the port of ``repro.api.table`` on one device.

Build a table over a text (:meth:`SuffixTable.from_codes` in memory, or
:meth:`SuffixTable.create` persisted under a catalog root; on ``cuda``
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

Major compaction (:meth:`compact`, automatic at ``max_runs``) folds the
runs and the memtable into the base by merging (``api.compaction``); a
frozen table stays frozen across it.  A persistent table (``create`` /
``open``) publishes an atomic snapshot (``checkpoint.manager``) at every
seal, compaction, freeze and :meth:`flush`, and logs every append to
its commit log (``api.wal``) before acking it; :meth:`open` replays the
log's tail.  The on-disk format is the reference's: a table written by
either package opens in the other.

:meth:`start_metrics` streams :meth:`stats` into the reference's
``metrics.jsonl`` feed (``serving.metrics``).

``create(staged=True)`` (or ``max_device_bytes`` / ``spill_dir`` /
``build_chunk_rows``) builds out of core under a device-byte budget
(``core.build_pipeline``) and streams the suffix array into the snapshot
shard by shard.

When more than one device is visible (``launch.mesh``: the cards of
``cuda``, or ``REPRO_TORCH_HOST_DEVICES=N`` tablets placed round-robin
over the table's device type) the table builds its suffix array by the
distributed prefix doubling (``core.dsa``) and serves over a tablet mesh
(broadcast and routed scans, ``core.planner``); ``capacity_factor`` and
``routed_min_batch`` steer the routed path, and ``compact()`` rebuilds
over the mesh when ``distributed_build`` (on a mesh by default).  As in
the reference, no constructor takes a ``mesh``: a mesh planner goes in
through :meth:`SuffixTable.from_store`.  Frozen tables serve from one
device.
"""
from __future__ import annotations

import os
import shutil
import time
from typing import Optional, Union

import numpy as np
import torch

from repro_torch.api.catalog import (Catalog, _check_name, default_root,
                                     table_fm_dir, table_wal_dir)
from repro_torch.api.compaction import merge_delta_sa
from repro_torch.api.fm import DEFAULT_SAMPLE_RATE, MAX_VOCAB, FMIndex
from repro_torch.api.memtable import Memtable
from repro_torch.api.runs import Run, TierSet, logical_tail
from repro_torch.api.wal import WriteAheadLog
from repro_torch.checkpoint.manager import CheckpointManager, by_key
from repro_torch.core import codec
from repro_torch.core.build_pipeline import (BuildStats,
                                             chunk_rows_for_budget,
                                             device_sort_rows,
                                             in_memory_build_stats,
                                             mesh_sort_rows,
                                             staged_suffix_array)
from repro_torch.core.planner import ScanOutcome, ScanPlanner, TopKCache
from repro_torch.core.query import MatchResult
from repro_torch.core.suffix_array import build_suffix_array
from repro_torch.core.dsa import build_suffix_array_distributed
from repro_torch.core.tablet import TabletStore, store_from_arrays
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.sharding import mesh_axis_size
from repro_torch.launch.mesh import AXIS, table_mesh
from repro_torch.serving.metrics import MetricsEmitter, table_record
from repro_torch.serving.trace import Tracer

def _as_batch(x, device: torch.device) -> torch.Tensor:
    """An encoded batch (numpy or torch) as a tensor on ``device``:
    packed DNA stays ``uint32``, token codes and lengths keep their
    integer dtype.  A numpy batch is copied (it may be read-only, as a
    view of another framework's array is)."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.tensor(np.asarray(x), device=device)


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


def _build_sa(codes: np.ndarray, dev: torch.device):
    """The base SA over ``codes`` on ``dev`` and the ``stats()["build"]``
    record of its construction: distributed over the tablet mesh when
    more than one device is visible (``launch.mesh.table_mesh``), on
    ``dev`` otherwise."""
    mesh = table_mesh(dev)
    _sync(dev)
    t0 = time.perf_counter()
    if mesh is not None:
        sa_pad, pad = build_suffix_array_distributed(codes, mesh, AXIS)
        sa = sa_pad[pad:].to(dev)
    else:
        sa = build_suffix_array(codec.as_tensor(codes, dev))
    _sync(dev)
    return sa, in_memory_build_stats(int(codes.shape[0]),
                                     time.perf_counter() - t0)


class SuffixTable:
    """A named, versioned, mutable suffix-array table.

    Construct through :meth:`create` / :meth:`open` (persistent) or
    :meth:`from_codes` / :meth:`from_store` (in memory)."""

    def __init__(self, codes: np.ndarray, sa_real, *, is_dna: bool,
                 max_query_len: int = 128, name: Optional[str] = None,
                 root: Optional[str] = None, version: int = 0,
                 cache_size: int = 4096, keep_n: int = 3,
                 memtable_limit: Optional[int] = None,
                 max_runs: Optional[int] = None,
                 wal: Optional[bool] = None, group_commit_ms: float = 0.0,
                 fm_threshold: Optional[int] = None,
                 capacity_factor: float = 2.0, routed_min_batch: int = 64,
                 distributed_build: Optional[bool] = None,
                 device: DeviceLike = None,
                 _store: Optional[TabletStore] = None,
                 _planner: Optional[ScanPlanner] = None,
                 _fm: Optional[FMIndex] = None):
        self.name = name
        self.root = root
        self.version = int(version)
        self.is_dna = bool(is_dna)
        self.max_query_len = int(max_query_len)
        self.keep_n = int(keep_n)
        # the routed mode's knobs (a mesh planner reads them)
        self.capacity_factor = float(capacity_factor)
        self.routed_min_batch = int(routed_min_batch)
        self.cache_size = int(cache_size)
        self.memtable_limit = memtable_limit
        self.max_runs = max_runs
        self.fm_threshold = fm_threshold
        self.fm: Optional[FMIndex] = None
        self.runs: list[Run] = []
        self._codes = np.asarray(codes)
        self.tracer = Tracer()
        self._metrics: Optional[MetricsEmitter] = None
        self.planner: Optional[ScanPlanner] = None
        if _store is not None:                       # adopted as it is
            self.device = _store.device
            self.mesh = _planner.mesh if _planner is not None else None
            self.store = _store
            self.planner = _planner or ScanPlanner(
                _store, cache_size=cache_size,
                capacity_factor=capacity_factor,
                routed_min_batch=routed_min_batch, tracer=self.tracer)
            if _planner is not None:
                self.tracer = _planner.tracer
        elif _fm is not None:                        # open(): frozen tier
            self.device = _fm.device
            self.mesh = None
            self._attach_frozen(_fm)
        else:
            self.device = resolve_device(device)
            self.mesh = table_mesh(self.device)
            self._attach(self._codes, sa_real)
        self._distributed_build = (self.mesh is not None
                                   if distributed_build is None
                                   else bool(distributed_build))
        self.memtable = Memtable(self._codes, is_dna=self.is_dna,
                                 max_query_len=self.max_query_len,
                                 device=self.device)
        self._tiers: Optional[TierSet] = None
        self._tiers_valid = False
        self._cache = TopKCache(cache_size)
        self._manager: Optional[CheckpointManager] = None
        if self.root is not None and self.name is not None:
            self._manager = CheckpointManager(
                os.path.join(self.root, self.name), keep_n=self.keep_n)
        # the commit log defaults on for persistent tables; create() and
        # open() attach it once the snapshot exists, so it only ever
        # covers appends the snapshot does not
        if wal and self._manager is None:
            raise ValueError("wal=True needs a persistent table (create/"
                             "open with a root); in-memory tables have "
                             "nothing to recover into")
        self._wal_on = (self._manager is not None) if wal is None \
            else bool(wal)
        self.group_commit_ms = float(group_commit_ms)
        self._wal: Optional[WriteAheadLog] = None
        self._wal_seq = 0            # seq of the last logged/applied append
        self._recovery: Optional[dict] = None
        self._replaying = False
        self._build: Optional[BuildStats] = None

    # -- construction --------------------------------------------------------
    @classmethod
    def from_codes(cls, codes, *, is_dna: Optional[bool] = None,
                   max_query_len: int = 128, device: DeviceLike = None,
                   **kw) -> "SuffixTable":
        """In-memory table built over ``codes`` now, on ``device``
        (``cuda`` when None): the SA by prefix doubling there (over the
        tablet mesh when more than one device is visible), the text
        packed there by the pack2bit kernel."""
        dev = resolve_device(device)
        codes, is_dna = _as_codes(codes, is_dna)
        sa, build = _build_sa(codes, dev)
        table = cls(codes, sa, is_dna=is_dna, max_query_len=max_query_len,
                    device=dev, **kw)
        table._build = build
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
    def create(cls, name: str, codes, *, root: Optional[str] = None,
               is_dna: Optional[bool] = None, max_query_len: int = 128,
               overwrite: bool = False, staged: Optional[bool] = None,
               max_device_bytes: Optional[int] = None,
               spill_dir: Optional[str] = None,
               build_chunk_rows: Optional[int] = None,
               shard_rows: Optional[int] = None,
               device: DeviceLike = None, **kw) -> "SuffixTable":
        """Build AND persist version 1 of a named table under ``root``
        (``default_root()`` when None), registered in the root's
        :class:`~repro_torch.api.catalog.Catalog`; the build runs on
        ``device`` (``cuda`` when None).

        Two build paths with bit-identical results, as in the reference:
        the in-memory builder, and — when ``staged=True`` or any of
        ``max_device_bytes`` / ``spill_dir`` / ``build_chunk_rows`` is
        given — the out-of-core staged pipeline
        (``core.build_pipeline``), which sorts device-budgeted chunks,
        spills working state to host RAM or ``spill_dir``, and streams
        finished SA shards of ``shard_rows`` rows straight into the
        snapshot.

        Crash-safe order, the reference's: the catalog entry is written
        BEFORE the snapshot, so a create that dies mid-persist (or
        mid-shard-stream) leaves a registered table without a published
        snapshot, which ``Catalog.reconcile`` and a later ``create`` of
        the name remove instead of refusing."""
        _check_name(name)
        root = root or default_root()
        catalog = Catalog(root)
        table_dir = os.path.join(root, name)
        if name in catalog or os.path.isdir(table_dir):
            # only a published snapshot makes the table real; a bare dir
            # or catalog entry is a crashed create's remnant
            has_snapshot = (os.path.isdir(table_dir) and
                            CheckpointManager(table_dir).latest_step()
                            is not None)
            if has_snapshot and not overwrite:
                raise FileExistsError(
                    f"table {name!r} already exists in {root!r} — "
                    f"SuffixTable.open() it, or pass overwrite=True")
            # a surviving higher step would shadow the fresh version 1
            shutil.rmtree(table_dir, ignore_errors=True)
        dev = resolve_device(device)
        codes, is_dna = _as_codes(codes, is_dna)
        if staged is None:
            staged = (max_device_bytes is not None or spill_dir is not None
                      or build_chunk_rows is not None)
        if staged:
            return cls._create_staged(
                name, codes, root=root, catalog=catalog, is_dna=is_dna,
                max_query_len=max_query_len,
                max_device_bytes=max_device_bytes, spill_dir=spill_dir,
                build_chunk_rows=build_chunk_rows, shard_rows=shard_rows,
                device=dev, **kw)
        sa, build = _build_sa(codes, dev)
        table = cls(codes, sa, is_dna=is_dna, max_query_len=max_query_len,
                    name=name, root=root, version=1, device=dev, **kw)
        table._build = build
        catalog.register(name, {"is_dna": table.is_dna,
                                "max_query_len": table.max_query_len})
        table._persist()
        table._maybe_freeze()       # fm_threshold policy; re-persists frozen
        table._open_wal(fresh=True)
        return table

    @classmethod
    def _create_staged(cls, name: str, codes: np.ndarray, *, root: str,
                       catalog: Catalog, is_dna: bool, max_query_len: int,
                       max_device_bytes: Optional[int],
                       spill_dir: Optional[str],
                       build_chunk_rows: Optional[int],
                       shard_rows: Optional[int], device: torch.device,
                       **kw) -> "SuffixTable":
        """The out-of-core create: the staged chunked build with SA
        shards streamed into a ``ShardedSave`` as they finish, published
        atomically, then reopened through :meth:`open` (which attaches
        the commit log and the freeze policy)."""
        chunk_rows = (int(build_chunk_rows) if build_chunk_rows
                      else chunk_rows_for_budget(max_device_bytes))
        if shard_rows is None:
            shard_rows = chunk_rows
        # a budget too small for one device sort (on a mesh, one sort on
        # every tablet of a card) raises before the catalog names the table
        mesh = table_mesh(device)
        if mesh is None:
            device_sort_rows(chunk_rows, max_device_bytes, device)
        else:
            mesh_sort_rows(chunk_rows, max_device_bytes, mesh)
        mgr = CheckpointManager(os.path.join(root, name),
                                keep_n=int(kw.get("keep_n", 3)))
        catalog.register(name, {"is_dna": is_dna,
                                "max_query_len": max_query_len})
        stage = mgr.stage_sharded(1)
        try:
            _, stats = staged_suffix_array(
                codes, chunk_rows=chunk_rows,
                max_device_bytes=max_device_bytes, spill_dir=spill_dir,
                mesh=mesh, axis_name=AXIS,
                shard_rows=shard_rows, device=device,
                emit_shard=lambda i, blk: stage.add_shard("sa_real", i,
                                                          blk))
            if "sa_real" not in stage._shards:   # empty corpus: no shards
                stage.add_shard("sa_real", 0, np.zeros((0,), np.int32))
            state = {"codes": codes,
                     "mem_codes": np.zeros((0,), codes.dtype)}
            extra = {"kind": "suffix_table", "name": name, "version": 1,
                     "is_dna": is_dna, "max_query_len": max_query_len,
                     "n_base": int(len(codes)), "runs": [], "mem_len": 0,
                     "wal_seq": 0, "frozen": False, "fm_sample_rate": None,
                     "build": stats.to_dict()}
            stage.commit(state, extra)
        except BaseException:
            stage.abort()
            raise
        return cls.open(name, root=root, device=device, **kw)

    @classmethod
    def open(cls, name: str, *, root: Optional[str] = None,
             device: DeviceLike = None, **kw) -> "SuffixTable":
        """Restore the latest persisted version of ``name`` onto
        ``device`` (``cuda`` when None): the saved real-row SA is
        re-padded, sealed runs come back with their saved indexes, the
        memtable with its codes, a frozen base with its FM artifact
        (rebuilt from the codes if the artifact is missing or stale) —
        no suffix sort — then the commit log's tail is replayed."""
        _check_name(name)
        root = root or default_root()
        table_dir = os.path.join(root, name)
        if not os.path.isdir(table_dir):        # before CheckpointManager:
            raise FileNotFoundError(            # its ctor mkdirs the path
                f"no table {name!r} under {root!r}")
        mgr = CheckpointManager(table_dir)
        step = mgr.latest_step()
        if step is None:
            raise FileNotFoundError(
                f"no persisted version of table {name!r} under {root!r}")
        arrays, extra = mgr.restore_arrays(step)
        arrays = by_key(arrays)
        dev = resolve_device(device)
        is_dna = bool(extra["is_dna"])
        fm = None
        if extra.get("frozen"):
            fm = FMIndex.load(table_fm_dir(root, name), device=dev)
            if fm is None or fm.n != int(arrays["codes"].shape[0]):
                fm = FMIndex.build(
                    arrays["codes"], None, is_dna=is_dna,
                    sample_rate=int(extra.get("fm_sample_rate")
                                    or DEFAULT_SAMPLE_RATE), device=dev)
        table = cls(arrays["codes"], arrays["sa_real"], is_dna=is_dna,
                    max_query_len=int(extra["max_query_len"]), name=name,
                    root=root, version=int(extra["version"]), device=dev,
                    _fm=fm, **kw)
        if extra.get("build"):
            table._build = BuildStats.from_dict(extra["build"])
        for i, rm in enumerate(extra.get("runs", [])):
            table.runs.append(Run.restore(
                arrays[f"run{i}_tail"], arrays[f"run{i}_codes"],
                arrays.get(f"run{i}_sa"), start=int(rm["start"]),
                is_dna=table.is_dna, max_query_len=table.max_query_len,
                device=table.device))
        if table.runs:
            table._reset_memtable()
        mem = arrays.get("mem_codes")
        if mem is not None and mem.size:
            table.memtable.append(mem)
        # crash recovery: replay the commit-log tail (appends acked after
        # this snapshot was published) through the memtable path
        table._wal_seq = int(extra.get("wal_seq", 0))
        table._open_wal(fresh=False)
        table._maybe_freeze()       # the threshold may be new on this open
        return table

    def _attach(self, codes: np.ndarray, sa_real) -> None:
        """(Re)build the base store on the table's device, padded for the
        table's tablet count.  An existing planner is re-bound in place,
        so references to it keep serving the new text and its stats
        survive."""
        self.store = store_from_arrays(
            codes, sa_real, is_dna=self.is_dna,
            max_query_len=self.max_query_len,
            num_tablets=mesh_axis_size(self.mesh), device=self.device)
        if self.planner is None:
            self.planner = ScanPlanner(
                self.store, mesh=self.mesh, cache_size=self.cache_size,
                capacity_factor=self.capacity_factor,
                routed_min_batch=self.routed_min_batch, tracer=self.tracer)
        else:
            self.planner.rebind(self.store)     # also drops any FM binding
        self.fm = None

    def flush(self) -> None:
        """Persist the current state — base, sealed runs and the
        memtable's codes — without compacting (same version, a fresh
        snapshot).  Raises on an in-memory table."""
        if self._manager is None:
            raise RuntimeError(
                "flush() on a non-persistent table — build it with "
                "SuffixTable.create(...) to get durable storage")
        self._persist()

    def close(self) -> None:
        """Release the commit log's file handle and stop the metrics
        emitter.  Reads keep working; a later :meth:`append` raises
        (reopen the table to write)."""
        self.stop_metrics()
        if self._wal is not None:
            self._wal.close()

    def start_metrics(self, path: str, interval_s: float = 1.0,
                      name: Optional[str] = None) -> None:
        """Stream :meth:`stats` into the ``metrics.jsonl`` feed at
        ``path`` every ``interval_s`` seconds (one final row on
        :meth:`stop_metrics`; ``interval_s <= 0``: that row only).  Each
        row is ``serving.metrics.table_record(name, stats())``, the
        reference's schema; ``name`` overrides ``self.name`` as the
        row's identity.  A second call restarts the emitter."""
        self.stop_metrics()
        row_name = name if name is not None else self.name
        self._metrics = MetricsEmitter(
            path, lambda: table_record(row_name, self.stats()),
            interval_s=interval_s)

    def stop_metrics(self) -> None:
        """Stop the feed emitter (it writes one final row)."""
        if self._metrics is not None:
            self._metrics.stop()
            self._metrics = None

    def _persist(self) -> None:
        """Publish the table's state as a fresh snapshot step, then seal
        the commit log.  Always a FRESH step: saving over an existing
        step deletes it before the rename, which would open a window
        with no live snapshot; the table version rides in ``extra``."""
        if self._manager is None:
            return
        if self.fm is not None:
            # frozen: the FM artifact under fm/ is the base index on disk
            sa_real = np.zeros((0,), np.int32)
        else:
            sa_real = self.store.sa[self.store.pad_count:].cpu().numpy()
        state = {"codes": self._codes, "sa_real": sa_real,
                 "mem_codes": self.memtable.appended}
        runs_meta = []
        for i, r in enumerate(self.runs):
            state[f"run{i}_tail"] = r.tail
            state[f"run{i}_codes"] = r.codes
            state[f"run{i}_sa"] = r.sa_padded      # its index, no re-sort
            runs_meta.append({"start": r.start, "length": r.length,
                              "overlap": r.overlap})
        extra = {"kind": "suffix_table", "name": self.name,
                 "version": self.version, "is_dna": self.is_dna,
                 "max_query_len": self.max_query_len,
                 "n_base": self.n_base, "runs": runs_meta,
                 "mem_len": self.memtable.size,
                 "wal_seq": self._wal_seq,
                 "frozen": self.fm is not None,
                 "fm_sample_rate": (self.fm.sample_rate
                                    if self.fm is not None else None),
                 "build": (self._build.to_dict()
                           if self._build is not None else None)}
        step = (self._manager.latest_step() or 0) + 1
        self._manager.save(step, state, extra=extra)
        if self._wal is not None:
            # only once the snapshot is published may the log be
            # truncated; a crash between the two is caught by the seq
            # skip on replay
            self._wal.seal(self._wal_seq + 1)

    def freeze(self, *, sample_rate: int = 32) -> "SuffixTable":
        """Move the base tier onto a frozen FM index: the BWT is derived
        from the current base SA (host numpy), 2-bit-packed with blocked
        Occ checkpoints and a sampled SA, and the live suffix array and
        device text are dropped (the index takes ~0.875 bytes per base
        against the device SA's 4).
        Base reads then run the FM backward search; appends keep landing
        in the memtable and runs and merge through the fused tier path.
        A persistent table saves the artifact under its ``fm/`` dir and
        publishes a snapshot.  Idempotent."""
        if self.fm is not None:
            return self
        sa_real = self.store.sa[self.store.pad_count:].cpu().numpy()
        fm = FMIndex.build(self._codes, sa_real, is_dna=self.is_dna,
                           sample_rate=sample_rate, device=self.device)
        self._attach_frozen(fm)
        if self._manager is not None:
            fm.save(table_fm_dir(self.root, self.name), self.version)
            self._persist()
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
        window.  Frozen tables serve single-replica: a mesh is
        released."""
        if fm.n != self.n_base or fm.is_dna != self.is_dna:
            raise ValueError(
                f"FM-index (n={fm.n}, is_dna={fm.is_dna}) does not match "
                f"the table (n={self.n_base}, is_dna={self.is_dna})")
        self.fm = fm
        self.mesh = None
        self.store = TabletStore(
            text_packed=None, text_codes=None,
            sa=torch.zeros((0,), dtype=torch.int32, device=self.device),
            n_real=self.n_base, n_pad=self.n_base, is_dna=self.is_dna,
            max_query_len=self.max_query_len)
        if self.planner is None:
            self.planner = ScanPlanner(
                self.store, cache_size=self.cache_size,
                capacity_factor=self.capacity_factor,
                routed_min_batch=self.routed_min_batch,
                tracer=self.tracer, fm=fm)
        else:
            self.planner.rebind(self.store, fm=fm)

    def _delta_codes(self) -> np.ndarray:
        """All un-compacted symbols (sealed runs + memtable), in order."""
        parts = [r.codes for r in self.runs]
        if self.memtable.size:
            parts.append(self.memtable.appended)
        if not parts:
            return np.zeros((0,), self._codes.dtype)
        return np.concatenate(
            [p.astype(self._codes.dtype, copy=False) for p in parts])

    def compact(self) -> int:
        """Major compaction: fold every sealed run and the memtable into
        the base suffix array BY MERGING (``api.compaction``: prefix
        doubling over the dirty range, the ``bounded_search`` kernel's
        insertion search on CUDA), clear the delta tiers, bump and
        persist the version.  A table with a live mesh and
        ``distributed_build`` rebuilds over the mesh instead (the merge
        is single-device).  A frozen table's SA is first rebuilt from
        its index (LF walks), and the merged base is frozen again at the
        same sample rate.  No-op when there is nothing to fold.  Returns
        the version."""
        delta = self._delta_codes()
        if delta.size == 0:
            return self.version
        combined = np.concatenate([self._codes, delta])
        was_frozen = self.fm is not None
        fm_rate = self.fm.sample_rate if was_frozen else None
        if self.mesh is not None and self._distributed_build:
            sa_real, _stats = _build_sa(combined, self.device)
        else:
            base_sa = (self.fm.suffix_array() if was_frozen
                       else self.store.sa[self.store.pad_count:])
            sa_real = merge_delta_sa(combined, self.n_base, base_sa,
                                     is_dna=self.is_dna,
                                     max_query_len=self.max_query_len,
                                     device=self.device)
            del base_sa
        self._codes = combined
        self._attach(combined, sa_real)      # rebind bumps the planner
        self.runs = []                       # cache and drops any FM
        self._reset_memtable()
        self._invalidate_caches()
        self.version += 1
        self._persist()
        if was_frozen:
            self.freeze(sample_rate=fm_rate)  # frozen is a sticky state
        else:
            self._maybe_freeze()
        return self.version

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
    def is_persistent(self) -> bool:
        return self._manager is not None

    @property
    def is_frozen(self) -> bool:
        """True when the base tier serves from the FM index."""
        return self.fm is not None

    @property
    def write_generation(self) -> int:
        """Monotone counter bumped by every write (append, seal,
        compaction): the staleness stamp of cached results."""
        return self._cache.generation

    def stats(self) -> dict:
        """Observability snapshot, the reference's schema plus
        ``device``: identity (``name``, ``version``, ...), ``tiers``
        (symbols per LSM level), the table's string ``cache``, ``build``
        (``BuildStats``: how the base was built), ``planner``
        (``PlannerStats.as_dict()``; ``bucketed_batches`` /
        ``bucketed_queries`` count each table-level dispatch
        (:meth:`scan_batch`, :meth:`locate_range`) and its queries,
        ``pad_slots`` stays 0 since no batch is padded),
        ``latency`` (span histograms) and ``wal`` (``enabled``, ``seq``,
        the log's counters, the last recovery summary or None)."""
        return {
            "name": self.name,
            "version": self.version,
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
            "build": (self._build.to_dict() if self._build is not None
                      else None),
            "planner": self.planner.stats.as_dict(),
            "latency": self.tracer.snapshot(),
            "wal": {
                "enabled": self._wal is not None,
                "seq": self._wal_seq,
                "log": (self._wal.stats() if self._wal is not None
                        else None),
                "recovery": self._recovery,
            },
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
        caller derives text-order positions from the base rows itself.
        Each call counts one ``bucketed_batches`` and its queries, where
        the reference counts its bucket-padded dispatches (the port pads
        nothing: ``pad_slots`` stays 0)."""
        merged, tres = self.planner.scan_tiers(self._tierset(), patt, plen,
                                               first_pos=False)
        self.planner.stats.bucketed_batches += 1
        self.planner.stats.bucketed_queries += int(plen.shape[0])
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
        """Exact merged scan of an encoded batch (numpy or torch; moved to
        the table's device); ``first_rank`` refers to the BASE suffix
        array (-1 when only delta tiers match)."""
        patt, plen = _as_batch(patt, self.device), _as_batch(plen,
                                                             self.device)
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
        """Merged scan of an encoded batch (numpy or torch; moved to the
        table's device) with **text-order** semantics: exact counts,
        ``first_pos`` the smallest occurrence position, ``positions`` the
        ``top_k`` smallest, ascending, -1 padded.  The client frontend's
        batch entry point (no string cache).  The reference pads the
        batch to a power-of-two bucket to bound jit compilations; eager
        PyTorch compiles nothing, so the port does not (``pad_slots``
        stays 0)."""
        patt, plen = _as_batch(patt, self.device), _as_batch(plen,
                                                             self.device)
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
    def _open_wal(self, *, fresh: bool) -> None:
        """Attach the table's commit log.  ``fresh=True`` (create) starts
        an empty segment; ``fresh=False`` (open) recovers the live one:
        torn tails are discarded by CRC, records the snapshot already
        covers are skipped by sequence number, and the rest — the
        appends acked after that snapshot — replay through the memtable
        path.  The summary lands in ``stats()["wal"]["recovery"]``."""
        if self._manager is None:
            return
        path = os.path.join(table_wal_dir(self.root, self.name), "wal.log")
        if not self._wal_on:
            # opting out with a live log on disk: move it aside, so a
            # later wal=True open never splices its stale records into
            # the text this table goes on to write
            if os.path.exists(path):
                os.replace(path, path + ".orphaned")
            return
        if fresh or not os.path.exists(path):
            self._wal = WriteAheadLog.create(
                path, start_seq=self._wal_seq + 1,
                group_commit_ms=self.group_commit_ms)
            return
        wal = WriteAheadLog(path, group_commit_ms=self.group_commit_ms)
        records, summary = wal.recover()
        self._wal = wal
        self._replaying = True      # no auto-seal mid-replay: a seal here
        try:                        # would truncate records not yet applied
            for seq, codes in records:
                if seq <= self._wal_seq:
                    summary.records_skipped += 1
                    continue
                if seq != self._wal_seq + 1:
                    # the log starts past the snapshot: the records
                    # between are gone, so nothing later can be applied
                    summary.reason = "snapshot_gap"
                    break
                self._apply_append(codes)
                self._wal_seq = seq
                summary.records_replayed += 1
        finally:
            self._replaying = False
        self._recovery = summary.as_dict()
        if wal._last_written_seq != self._wal_seq:
            # only stale or unreachable records remain: re-seal so the
            # next append gets a contiguous sequence
            wal.seal(self._wal_seq + 1)
        if (self.memtable_limit is not None
                and self.memtable.size >= self.memtable_limit):
            self.minor_compact()    # deferred from replay; persists + seals

    def append(self, codes) -> int:
        """Append text (memtable write path); visible to every later read
        with exact merged counts.  On a persistent table the batch is
        committed to the commit log and fsync'd before this returns.
        Returns the memtable size; seals the memtable
        (:meth:`minor_compact`) at ``memtable_limit``."""
        size, token = self.append_nowait(codes)
        self.wait_durable(token)
        return size

    def append_nowait(self, codes) -> tuple[int, Optional[int]]:
        """The two-phase append under :meth:`append`: validate, log the
        record (buffered, not yet fsync'd), apply it to the memtable, and
        return ``(memtable_size, durability_token)``; pass the token to
        :meth:`wait_durable` before acking."""
        if isinstance(codes, (str, bytes, bytearray)):
            if not self.is_dna:
                raise TypeError("string appends are DNA-only; pass a code "
                                "array for token tables")
            codes = codec.encode_dna(codes)
        # validate BEFORE logging: a bad batch must fail the caller, not
        # poison the log with a record that re-raises on every recovery
        codes = Memtable.validate_codes(codes, is_dna=self.is_dna)
        if codes.size == 0:
            return self.memtable.size, None
        token = None
        if self._wal is not None:
            token = self._wal.append(codes, self._wal_seq + 1)
        self._wal_seq += 1          # counted even unlogged: snapshots
        self._apply_append(codes)   # persist it, keeping replay aligned
        return self.memtable.size, token

    def wait_durable(self, token: Optional[int]) -> None:
        """Block until the append that returned ``token`` is on disk.
        No-op for None (empty appends, tables without a log)."""
        if token is not None and self._wal is not None:
            self._wal.wait(token)

    def _apply_append(self, codes: np.ndarray) -> None:
        """Memtable apply and cache invalidation, shared by live appends
        and log replay (which defers the ``memtable_limit`` seal)."""
        self.memtable.append(codes, _prevalidated=True)
        self._invalidate_caches()
        if (not self._replaying and self.memtable_limit is not None
                and self.memtable.size >= self.memtable_limit):
            self.minor_compact()

    def minor_compact(self) -> int:
        """Seal the memtable into an immutable :class:`Run` and start a
        fresh one; a persistent table publishes a snapshot.  No-op on an
        empty memtable.  Returns the run count; at ``max_runs`` the runs
        are folded into the base by :meth:`compact` first."""
        if self.memtable.size == 0:
            return len(self.runs)
        self.runs.append(Run.from_memtable(self.memtable))
        self._reset_memtable()
        self._invalidate_caches()
        if self.max_runs is not None and len(self.runs) >= self.max_runs:
            self.compact()
        elif self._manager is not None:
            self._persist()
        return len(self.runs)


def open_table(name: str, *, root: Optional[str] = None,
               **kw) -> SuffixTable:
    """``SuffixTable.open`` under its older spelling, one call deep."""
    return SuffixTable.open(name, root=root, **kw)


TableLike = Union[SuffixTable, TabletStore]
