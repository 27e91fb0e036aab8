"""Staged out-of-core suffix-array construction — the port of
``repro.core.build_pipeline``.

``build_suffix_array`` (core/suffix_array.py) holds the text and its
working arrays on one device; this module runs the same Manber–Myers
recurrence as an external algorithm, as the reference does:

  1. **Chunk sort** — each round's rows, in text order, get the
     order-preserving int64 key ``_pack_keys(rank, next rank)`` on the
     host; the keys go to the device a sub-chunk at a time and come back
     sorted by ONE ``torch.sort(stable=True)`` each.  Rows arrive in
     ``idx`` order, so stability is the reference's explicit ``idx``
     tie-break (its ``lax.sort`` of ``(first, second, idx)``).
  2. **Spill** — sorted runs and the text-order rank chunks live in a
     :class:`SpillStore`: host RAM by default, files under ``spill_dir``
     when set.
  3. **Merge + relabel** — ``dsort.merge_sorted_runs`` streams the
     globally sorted order; dense new ranks are assigned on the fly and
     scattered back to text order through a :class:`ChunkScatter`.
  4. **Emit** — once every rank is distinct the merged order IS the
     suffix array; it streams out in ``shard_rows`` blocks through
     ``emit_shard``.

**The device budget.**  The reference models a row in the device sort
as 24 bytes (three int32 operands, double-buffered) and sizes
``chunk_rows = max_device_bytes // 24``; ``BuildStats`` keeps that
model (``chunk_rows``, ``n_chunks``, ``peak_device_bytes``), so
``stats()["build"]`` reads the same in both packages.  ``torch.sort`` of
int64 keys with int64 indices holds more than 24 bytes a row on the card
(:data:`SORT_BYTES_PER_ROW`, measured on the H100), so on CUDA under a
budget each chunk is sorted as sub-chunks of :func:`device_sort_rows`
rows that fit it, each spilled as its own sorted run.  The merge does not care
how many runs there are, and the suffix array stays bit-identical.  On
the CPU, or without a budget, a sub-chunk is a whole chunk, so the runs,
the merge's blocks and ``spill_bytes`` are the reference's.

With a tablet mesh the reference's mesh path runs: each round sorts
super-chunks of ``p * chunk_rows`` rows, one ``core.dsa.
make_superchunk_sorter`` sort each (every tablet holds ``chunk_rows``
rows), padded with ``INT32_MAX`` rows; each super-chunk is one run, and
the merge's block size is the reference's, so ``stats()["build"]``
matches it.  On CUDA under a budget the budget is a card's, and the
single-controller sort keeps the working set of every tablet on a card
alive at once (:data:`MESH_SORT_BYTES_PER_ROW` a tablet row, measured on
the H100), so a tablet takes :func:`mesh_sort_rows` rows a super-chunk.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.dsa import make_superchunk_sorter
from repro_torch.core.dsort import INT32_MAX as _I32_MAX
from repro_torch.core.dsort import merge_sorted_runs
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.sharding import mesh_axis_size

DEFAULT_CHUNK_ROWS = 1 << 16
MIN_CHUNK_ROWS = 256
# 3 int32 sort operands, double-buffered through the device sort (the
# reference's figure behind chunk_rows and peak_device_bytes).
BYTES_PER_ROW = 24
# Device bytes one row of a chunk sort on CUDA holds at the sort's peak
# (the uploaded int64 key, torch.sort's int64 values and indices and its
# radix-sort buffers), rounded up, and a margin for what a sort holds
# besides its rows: the caching allocator may hand each of the sort's
# ~5 large buffers a cached block up to 1 MiB larger than asked.
# chip_smoke.py measures both on the card ([sort-footprint] at 2**16,
# 2**20 and 2**22 rows; the [staged] build's measured peak); PERF.md
# gives the H100's numbers.
SORT_BYTES_PER_ROW = 49
SORT_FIXED_BYTES = 6 << 20
# The same for one tablet row of a mesh super-chunk sort
# (``dsa.make_superchunk_sorter``): the uploaded operands, the sample
# sort's bucket buffers at twice the rows, its local sort and
# re-balance, or the bitonic fallback's merge-splits, whichever holds
# more), rounded up, and a margin a tablet for the caching allocator's
# oversized blocks.  chip_smoke.py's [mesh-sort-footprint] measures the
# rows' bytes on the card (8 tablets, random and tie-heavy keys); PERF.md
# gives the H100's numbers.
MESH_SORT_BYTES_PER_ROW = 100
MESH_SORT_FIXED_BYTES = 2 << 20


def chunk_rows_for_budget(max_device_bytes: Optional[int]) -> int:
    """Rows per device chunk under a byte budget (None -> default)."""
    if max_device_bytes is None:
        return DEFAULT_CHUNK_ROWS
    return max(MIN_CHUNK_ROWS, int(max_device_bytes) // BYTES_PER_ROW)


def device_sort_rows(chunk_rows: int, max_device_bytes: Optional[int],
                     device: torch.device) -> int:
    """Rows one device sort takes: a whole chunk on the CPU or without a
    budget, as the reference sorts; on CUDA under ``max_device_bytes``
    as many as fit it at the sort's measured footprint.  A budget that
    cannot hold a sort of ``MIN_CHUNK_ROWS`` rows raises ValueError."""
    if device.type != "cuda" or max_device_bytes is None:
        return chunk_rows
    fit = (int(max_device_bytes) - SORT_FIXED_BYTES) // SORT_BYTES_PER_ROW
    if fit < MIN_CHUNK_ROWS:
        raise ValueError(
            f"max_device_bytes={max_device_bytes} cannot hold a device "
            f"sort of {MIN_CHUNK_ROWS} rows on CUDA (needs at least "
            f"{MIN_CHUNK_ROWS * SORT_BYTES_PER_ROW + SORT_FIXED_BYTES})")
    return min(chunk_rows, fit)


def mesh_sort_rows(chunk_rows: int, max_device_bytes: Optional[int],
                   mesh) -> int:
    """Rows a tablet takes in one super-chunk sort: ``chunk_rows`` on
    the CPU or without a budget, as the reference sorts; on CUDA as many
    as fit ``max_device_bytes`` on the card that holds the most tablets.
    A budget that cannot hold ``MIN_CHUNK_ROWS`` rows a tablet raises
    ValueError."""
    devs = list(mesh.devices)
    if devs[0].type != "cuda" or max_device_bytes is None:
        return chunk_rows
    k = max(devs.count(d) for d in devs)     # tablets sharing a card
    per_tablet = int(max_device_bytes) // k - MESH_SORT_FIXED_BYTES
    fit = per_tablet // MESH_SORT_BYTES_PER_ROW
    if fit < MIN_CHUNK_ROWS:
        need = k * (MIN_CHUNK_ROWS * MESH_SORT_BYTES_PER_ROW
                    + MESH_SORT_FIXED_BYTES)
        raise ValueError(
            f"max_device_bytes={max_device_bytes} cannot hold a mesh sort "
            f"of {MIN_CHUNK_ROWS} rows on each of the {k} tablets of a "
            f"card (needs at least {need})")
    return min(chunk_rows, fit)


@dataclasses.dataclass
class BuildStats:
    """Construction telemetry — ``SuffixTable.stats()["build"]``."""

    mode: str = "staged"            # "staged" | "in_memory"
    n_bases: int = 0
    rounds: int = 0                 # sort/merge rounds actually run
    n_chunks: int = 0               # device chunks per round
    chunk_rows: int = 0
    peak_device_bytes: int = 0      # the sort's working set, as modelled
    spill_bytes: int = 0            # cumulative bytes written to spill_dir
    elapsed_s: float = 0.0
    bases_per_s: float = 0.0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "BuildStats":
        """Keys the schema lacks are dropped, missing ones default (a
        record written before a key existed still loads)."""
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


def in_memory_build_stats(n: int, elapsed_s: float) -> BuildStats:
    """The reference's record of a one-sort build over ``n`` bases:
    ``1 + ceil(log2 n)`` rounds, one chunk of ``n`` rows, ``24 n`` modelled
    device bytes (not measured), nothing spilled."""
    rounds = 1 + max(1, int(np.ceil(np.log2(max(2, n)))))
    return BuildStats(
        mode="in_memory", n_bases=n, rounds=rounds, n_chunks=1,
        chunk_rows=n, peak_device_bytes=n * BYTES_PER_ROW, spill_bytes=0,
        elapsed_s=elapsed_s,
        bases_per_s=(n / elapsed_s) if elapsed_s > 0 else 0.0)


# --------------------------------------------------------------------------
# Spill store: chunked working arrays + sorted runs, RAM or disk.
# --------------------------------------------------------------------------
class SpillStore:
    """Between-round working state, addressed as ``(name, chunk_index)``.

    RAM mode (``spill_dir=None``) keeps plain numpy arrays in a dict.
    Disk mode writes ``.npy`` per chunk and raw ``tofile`` pairs per
    sorted run; reads come back through ``np.load`` / ``np.fromfile``
    block reads (never mmap — mmap counts against RLIMIT_AS)."""

    def __init__(self, spill_dir: Optional[str] = None):
        self.spill_dir = spill_dir
        self._ram: dict = {}
        self.spill_bytes = 0
        if spill_dir is not None:
            os.makedirs(spill_dir, exist_ok=True)

    def _path(self, name: str, i: int, ext: str = "npy") -> str:
        return os.path.join(self.spill_dir, f"{name}_{i:06d}.{ext}")

    def put(self, name: str, i: int, arr: np.ndarray) -> None:
        if self.spill_dir is None:
            self._ram[(name, i)] = arr
            return
        np.save(self._path(name, i), arr)
        self.spill_bytes += arr.nbytes

    def get(self, name: str, i: int) -> np.ndarray:
        if self.spill_dir is None:
            return self._ram[(name, i)]
        return np.load(self._path(name, i))

    def put_run(self, r: int, key: np.ndarray,
                idx: np.ndarray) -> "SortedRun":
        if self.spill_dir is None:
            return SortedRun(len(key), key=key, idx=idx)
        kp = self._path("run", r, "key")
        ip = self._path("run", r, "idx")
        key.tofile(kp)
        idx.tofile(ip)
        self.spill_bytes += key.nbytes + idx.nbytes
        return SortedRun(len(key), key_path=kp, idx_path=ip)

    def drop_runs(self, runs) -> None:
        for run in runs:
            run.drop()

    def append_raw(self, path: str, arr: np.ndarray) -> None:
        with open(os.path.join(self.spill_dir, path), "ab") as f:
            arr.tofile(f)
        self.spill_bytes += arr.nbytes

    def read_raw(self, path: str, dtype) -> np.ndarray:
        full = os.path.join(self.spill_dir, path)
        if not os.path.exists(full):
            return np.zeros((0,), dtype)
        return np.fromfile(full, dtype=dtype)

    def drop_raw(self, path: str) -> None:
        full = os.path.join(self.spill_dir, path)
        if os.path.exists(full):
            os.remove(full)

    def close(self) -> None:
        """Delete every spill artifact (working state is round-local)."""
        self._ram.clear()
        if self.spill_dir is not None and os.path.isdir(self.spill_dir):
            for fn in os.listdir(self.spill_dir):
                if fn.split("_")[0] in ("run", "rank", "sa", "scat"):
                    try:
                        os.remove(os.path.join(self.spill_dir, fn))
                    except OSError:
                        pass


class SortedRun:
    """One sorted ``(key int64, idx int32)`` run, RAM- or file-backed.
    ``read_block(lo, hi)`` is the contract ``merge_sorted_runs`` needs."""

    def __init__(self, n: int, key=None, idx=None,
                 key_path: Optional[str] = None,
                 idx_path: Optional[str] = None):
        self.n = int(n)
        self._key, self._idx = key, idx
        self._key_path, self._idx_path = key_path, idx_path

    def read_block(self, lo: int, hi: int):
        if self._key is not None:
            return self._key[lo:hi], self._idx[lo:hi]
        k = np.fromfile(self._key_path, dtype=np.int64, count=hi - lo,
                        offset=lo * 8)
        i = np.fromfile(self._idx_path, dtype=np.int32, count=hi - lo,
                        offset=lo * 4)
        return k, i

    def drop(self) -> None:
        self._key = self._idx = None
        for p in (self._key_path, self._idx_path):
            if p is not None and os.path.exists(p):
                os.remove(p)


# --------------------------------------------------------------------------
# Scatter-back shuffle: merged (idx, rank) rows -> text-order rank chunks.
# --------------------------------------------------------------------------
class ChunkScatter:
    """MapReduce-style shuffle for the relabel writeback.

    Merged blocks arrive in SA order; rows are bucketed by destination
    chunk ``idx // chunk_rows`` and buffered, spilling each bucket to
    append-only files once it exceeds ``flush_rows`` (disk mode), so the
    resident set stays O(n_chunks * flush_rows) instead of O(n).  Every
    text position is written exactly once per round, so ``finish`` can
    assemble each rank chunk with a plain scatter."""

    def __init__(self, store: SpillStore, n_chunks: int, chunk_rows: int,
                 flush_rows: int = 1 << 14):
        self.store = store
        self.n_chunks = n_chunks
        self.chunk_rows = chunk_rows
        self.flush_rows = flush_rows
        self._buf: list[list] = [[] for _ in range(n_chunks)]
        self._pending = [0] * n_chunks
        self._spilled = [False] * n_chunks

    def add(self, idx: np.ndarray, rank: np.ndarray) -> None:
        dest = idx // self.chunk_rows
        order = np.argsort(dest, kind="stable")
        dsort, isort, rsort = dest[order], idx[order], rank[order]
        bounds = np.searchsorted(dsort, np.arange(self.n_chunks + 1))
        for c in np.unique(dsort):
            lo, hi = bounds[c], bounds[c + 1]
            pos = (isort[lo:hi] - c * self.chunk_rows).astype(np.int32)
            self._buf[c].append((pos, rsort[lo:hi].astype(np.int32)))
            self._pending[c] += hi - lo
            if (self.store.spill_dir is not None
                    and self._pending[c] >= self.flush_rows):
                self._flush(c)

    def _flush(self, c: int) -> None:
        pos = np.concatenate([p for p, _ in self._buf[c]])
        rnk = np.concatenate([r for _, r in self._buf[c]])
        self.store.append_raw(f"scat_{c:06d}.pos", pos)
        self.store.append_raw(f"scat_{c:06d}.rank", rnk)
        self._buf[c] = []
        self._pending[c] = 0
        self._spilled[c] = True

    def finish(self, n: int) -> None:
        """Assemble and store the new text-order rank chunks."""
        for c in range(self.n_chunks):
            size = min(self.chunk_rows, n - c * self.chunk_rows)
            out = np.empty((size,), np.int32)
            if self._spilled[c]:
                pos = self.store.read_raw(f"scat_{c:06d}.pos", np.int32)
                rnk = self.store.read_raw(f"scat_{c:06d}.rank", np.int32)
                out[pos] = rnk
            for pos, rnk in self._buf[c]:
                out[pos] = rnk
            self._buf[c] = []
            self.store.put("rank", c, out)
        self.discard()

    def discard(self) -> None:
        self._buf = [[] for _ in range(self.n_chunks)]
        for c in range(self.n_chunks):
            if self._spilled[c]:
                self.store.drop_raw(f"scat_{c:06d}.pos")
                self.store.drop_raw(f"scat_{c:06d}.rank")
                self._spilled[c] = False


class _ChunkedWriter:
    """Sequential writer of a chunked array into the store."""

    def __init__(self, store: SpillStore, name: str, chunk_rows: int):
        self.store, self.name, self.chunk_rows = store, name, chunk_rows
        self._parts: list = []
        self._have = 0
        self.next_chunk = 0

    def add(self, arr: np.ndarray) -> None:
        self._parts.append(arr)
        self._have += len(arr)
        while self._have >= self.chunk_rows:
            cat = np.concatenate(self._parts)
            self.store.put(self.name, self.next_chunk,
                           cat[:self.chunk_rows])
            self.next_chunk += 1
            self._parts = [cat[self.chunk_rows:]]
            self._have = len(self._parts[0])

    def finish(self) -> None:
        if self._have:
            self.store.put(self.name, self.next_chunk,
                           np.concatenate(self._parts))
            self.next_chunk += 1
        self._parts = []
        self._have = 0


# --------------------------------------------------------------------------
# Device chunk sort
# --------------------------------------------------------------------------
def _sort_chunk(key: np.ndarray, lo: int, device: torch.device):
    """Sort the packed keys of rows ``lo, lo + 1, ...`` on ``device``:
    (sorted keys int64, their idx int32).  One stable ``torch.sort``:
    the rows arrive in idx order, so ties keep it (the reference's
    ``(first, second, idx)`` order)."""
    vals, order = torch.sort(torch.from_numpy(key).to(device), stable=True)
    idx = order.add_(lo).to(torch.int32)
    del order
    return vals.cpu().numpy(), idx.cpu().numpy()


def _read_rank_range(store: SpillStore, lo: int, hi: int, n: int,
                     chunk_rows: int) -> np.ndarray:
    """rank[lo:hi] from the chunked store, -1 for positions >= n."""
    out = np.full((hi - lo,), -1, np.int32)
    pos = lo
    while pos < min(hi, n):
        c = pos // chunk_rows
        chunk = store.get("rank", c)
        base = c * chunk_rows
        take = min(hi, base + len(chunk)) - pos
        out[pos - lo:pos - lo + take] = chunk[pos - base:pos - base + take]
        pos += take
    return out


def _pack_keys(first: np.ndarray, second: np.ndarray, n: int) -> np.ndarray:
    """Order-preserving int64 packing of the (first, second) sort key:
    first in [0, n), second in [-1, n) -> first*(n+1) + second+1.
    Fits int64 for n up to ~3e9."""
    return first.astype(np.int64) * np.int64(n + 1) \
        + (second.astype(np.int64) + 1)


# --------------------------------------------------------------------------
# The staged build
# --------------------------------------------------------------------------
def staged_suffix_array(
    codes,
    *,
    chunk_rows: Optional[int] = None,
    max_device_bytes: Optional[int] = None,
    spill_dir: Optional[str] = None,
    mesh=None,
    axis_name: str = "tablets",
    method: str = "sample",
    shard_rows: Optional[int] = None,
    emit_shard: Optional[Callable[[int, np.ndarray], None]] = None,
    num_steps: Optional[int] = None,
    device: DeviceLike = None,
):
    """Out-of-core prefix doubling; bit-identical to ``build_suffix_array``.

    Returns ``(sa, stats)``.  With ``emit_shard`` set the SA is streamed
    as ``emit_shard(shard_index, int32_block)`` calls of ``shard_rows``
    rows (last one partial) and ``sa`` is None; otherwise the full array
    is assembled and returned (numpy int32).  The chunk sorts run on
    ``device`` (``cuda`` when None), or with ``mesh`` as one ``method``
    sort over the tablets per super-chunk of ``p`` times
    :func:`mesh_sort_rows` rows; everything else is host work."""
    dev = resolve_device(device)
    codes = np.asarray(codes, dtype=np.int32)
    n = int(len(codes))
    t0 = time.perf_counter()
    if chunk_rows is None:
        chunk_rows = chunk_rows_for_budget(max_device_bytes)
    chunk_rows = max(MIN_CHUNK_ROWS, int(chunk_rows))
    if shard_rows is None:
        shard_rows = chunk_rows

    if n <= 1:
        sa = np.arange(n, dtype=np.int32)
        stats = BuildStats(n_bases=n, rounds=0, n_chunks=min(n, 1),
                           chunk_rows=chunk_rows,
                           elapsed_s=time.perf_counter() - t0)
        if emit_shard is not None:
            if n:
                emit_shard(0, sa)
            return None, stats
        return sa, stats

    p = mesh_axis_size(mesh, axis_name) if mesh is not None else 1
    n_chunks = -(-n // chunk_rows)
    if p > 1:
        # one mesh sort per super-chunk: each tablet holds chunk_rows
        # (fewer on CUDA under a budget); the merge's blocks are the
        # reference's
        mesh_sort = make_superchunk_sorter(mesh, axis_name, method)
        sort_rows = mesh_sort_rows(chunk_rows, max_device_bytes, mesh) * p
        ref_rows = chunk_rows * p
        block_rows = max(MIN_CHUNK_ROWS, ref_rows // -(-n // ref_rows))
    else:
        sort_rows = device_sort_rows(chunk_rows, max_device_bytes, dev)
        block_rows = max(MIN_CHUNK_ROWS, chunk_rows // n_chunks)
    if num_steps is None:
        num_steps = max(1, int(np.ceil(np.log2(n))))

    store = SpillStore(spill_dir)
    stats = BuildStats(n_bases=n, n_chunks=n_chunks, chunk_rows=chunk_rows,
                       peak_device_bytes=chunk_rows * BYTES_PER_ROW)

    def sort_run(first, second, lo):
        """One sorted run of the rows ``lo, lo + 1, ...``: (key, idx)."""
        if p == 1:
            return _sort_chunk(_pack_keys(first, second, n), lo, dev)
        real = len(first)
        idx = np.arange(lo, lo + real, dtype=np.int32)
        pad = np.full((sort_rows - real,), _I32_MAX, np.int32)
        f_s, s_s, i_s = mesh_sort(np.concatenate([first, pad]),
                                  np.concatenate([second, pad]),
                                  np.concatenate([idx, pad]))
        return _pack_keys(f_s[:real], s_s[:real], n), i_s[:real]

    try:
        k = 0                                      # round 0 = densify
        for rnd in range(num_steps + 1):
            runs = []
            for r, lo in enumerate(range(0, n, sort_rows)):
                hi = min(lo + sort_rows, n)
                if rnd == 0:
                    first = codes[lo:hi]
                    second = np.zeros((hi - lo,), np.int32)
                else:
                    first = _read_rank_range(store, lo, hi, n, chunk_rows)
                    second = _read_rank_range(store, lo + k, hi + k, n,
                                              chunk_rows)
                runs.append(store.put_run(r, *sort_run(first, second, lo)))

            # flush threshold scales with the chunk so pending scatter
            # buffers stay a fraction of the device budget, not O(n)
            scat = ChunkScatter(store, n_chunks, chunk_rows,
                                flush_rows=max(1024, chunk_rows // 8))
            sa_out = _ChunkedWriter(store, "sa", chunk_rows)
            last_rank = np.int64(0)
            prev_key = None
            for key_blk, idx_blk in merge_sorted_runs(
                    runs, block_rows=block_rows):
                ch = np.empty((len(key_blk),), np.int64)
                ch[1:] = key_blk[1:] != key_blk[:-1]
                ch[0] = 0 if prev_key is None else key_blk[0] != prev_key
                ranks = last_rank + np.cumsum(ch)
                last_rank = ranks[-1]
                prev_key = key_blk[-1]
                sa_out.add(idx_blk)
                scat.add(idx_blk, ranks)
            sa_out.finish()
            store.drop_runs(runs)
            stats.rounds = rnd + 1
            saturated = int(last_rank) == n - 1
            if saturated or rnd == num_steps:
                scat.discard()                     # ranks no longer needed
                break
            scat.finish(n)
            k = 1 if k == 0 else k * 2

        # Emit the final SA ("sa" chunks hold the last round's order).
        stats.spill_bytes = store.spill_bytes
        stats.elapsed_s = time.perf_counter() - t0
        stats.bases_per_s = n / stats.elapsed_s if stats.elapsed_s else 0.0
        if emit_shard is None:
            sa = np.concatenate([store.get("sa", j)
                                 for j in range(n_chunks)])
            return sa, stats
        shard_i = 0
        buf: list = []
        have = 0
        for j in range(n_chunks):
            buf.append(store.get("sa", j))
            have += len(buf[-1])
            while have >= shard_rows:
                cat = np.concatenate(buf)
                emit_shard(shard_i, cat[:shard_rows])
                shard_i += 1
                buf = [cat[shard_rows:]]
                have = len(buf[0])
        if have:
            emit_shard(shard_i, np.concatenate(buf))
        return None, stats
    finally:
        store.close()
