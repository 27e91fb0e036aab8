"""Atomic, versioned snapshots — the numpy-only port of
``repro.checkpoint.manager``: ``save``, ``stage_sharded``,
``all_steps``, ``latest_step``, ``restore_arrays``, ``restore``,
``restore_latest`` and ``keep_n`` GC.

On-disk format, the reference's, so a snapshot written by either package
restores in the other::

    <dir>/step_0000000001/arrays.npz   keys a0, a1, ... (one per leaf)
    <dir>/step_0000000001/meta.json    {"step", "paths", "extra"}

``paths`` lists the leaves in the order jax flattens the state, as
jax's key-path strings (``repro_torch.tree``): ``"['codes']"`` for a
table's flat dict of arrays, ``".params['stack'][0]['attn']['wq']"``,
``".opt_state['m'][...]"`` and ``".step"`` for a ``TrainState``.
:meth:`CheckpointManager.restore` puts a step back into the structure of
a ``like`` tree, leaf by path, so a train state saved by either package
restores in the other.  A sharded state (``distributed.sharding.
Sharded`` leaves) is saved as full arrays joined from its blocks, and
``restore(step, like, shardings=(mesh, spec_tree))`` places the leaves
on that mesh by those specs: the elastic path, onto another mesh shape
or, with ``shardings=None``, onto one device.  A save writes
``step_XXXX.tmp`` and publishes it with one ``os.rename``, so a
preempted save never corrupts the latest snapshot; ``.tmp`` dirs are
ignored by :meth:`CheckpointManager.all_steps`.

Shard-streaming saves (:meth:`CheckpointManager.stage_sharded`, the
reference's format): a large array is streamed into the staged
``step_XXXX.tmp`` dir one ``shard_<name>_<i>.npy`` file at a time and
the step is published with the same single ``os.rename``, its shards
listed under ``"shards"`` in ``meta.json``.  The staged table build
streams suffix-array shards this way without ever holding the whole
array; a crash mid-stream leaves only a ``.tmp`` dir, which
``all_steps`` ignores and ``Catalog.reconcile`` removes.

A rename alone survives a crash of the process, not a power loss: the
step's data may still sit in the page cache.  ``save(durable=True)``
fsyncs every file of the staged step and the step directory before the
rename, and the checkpoint directory after it, so the published step is
on disk when it returns; the time and bytes add to the manager's
``synced_ms`` and ``synced_bytes``.  ``ShardedSave.commit`` publishes
through the same rename, without the fsyncs.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import stat
import time
from typing import Optional

import numpy as np

from repro_torch import tree as T


def key_path(key: str) -> str:
    """jax's key-path string of a dict entry: ``"['codes']"``."""
    return f"[{key!r}]"


def by_key(arrays: dict) -> dict:
    """Strip the key-path decoration of restored arrays: ``"['codes']"``
    -> ``"codes"``."""
    return {re.sub(r"[^0-9A-Za-z_]", "", k): v for k, v in arrays.items()}


def _host(arr) -> np.ndarray:
    """A tensor, a ``Sharded`` (joined) or an array as host numpy."""
    if hasattr(arr, "join") and hasattr(arr, "layout"):
        arr = arr.join()
    if hasattr(arr, "detach"):
        arr = arr.detach().cpu().numpy()
    return np.asarray(arr)


def fsync_path(path: str) -> int:
    """fsync a file or a directory; the file's bytes (0 for a
    directory)."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
        st = os.fstat(fd)
    finally:
        os.close(fd)
    return 0 if stat.S_ISDIR(st.st_mode) else int(st.st_size)


def fsync_step(path: str) -> int:
    """fsync every file of the step directory ``path``, then the
    directory itself; the files' bytes."""
    n = sum(fsync_path(os.path.join(path, f))
            for f in sorted(os.listdir(path)))
    fsync_path(path)
    return n


def flatten(state) -> list[tuple[str, np.ndarray]]:
    """(path, array) per leaf of a tree (a flat dict: one per entry, in
    sorted key order), jax's flatten order and key paths; tensors come
    back to host numpy."""
    return [(p, _host(x)) for p, x in T.flatten_with_path(state)]


class ShardedSave:
    """One in-flight shard-streaming save: register -> stream shards ->
    publish atomically.

    Created by :meth:`CheckpointManager.stage_sharded`.  Shards of a named
    array are appended in order with :meth:`add_shard`; :meth:`commit`
    writes the remaining (small) state plus metadata and publishes the
    whole step with one rename.  Until then nothing is visible:
    ``all_steps()`` skips ``.tmp`` dirs, so a kill at ANY shard boundary
    leaves the previous published version untouched and the partial
    stream reclaimable (``Catalog.reconcile``)."""

    def __init__(self, manager: "CheckpointManager", step: int):
        self.manager = manager
        self.step = int(step)
        self.final = os.path.join(manager.dir, f"step_{step:010d}")
        self.tmp = self.final + ".tmp"
        if os.path.exists(self.tmp):
            shutil.rmtree(self.tmp)
        os.makedirs(self.tmp)
        self._shards: dict[str, dict] = {}
        self._done = False

    def add_shard(self, name: str, i: int, arr) -> str:
        """Stream shard ``i`` of array ``name`` (must arrive in order)."""
        if self._done:
            raise RuntimeError("ShardedSave already committed/aborted")
        ent = self._shards.setdefault(name, {"count": 0, "dtype": None})
        if i != ent["count"]:
            raise ValueError(f"shard {i} of {name!r} out of order "
                             f"(expected {ent['count']})")
        arr = _host(arr)
        np.save(os.path.join(self.tmp, f"shard_{name}_{i:06d}.npy"), arr)
        ent["count"] += 1
        ent["dtype"] = arr.dtype.name
        return f"shard_{name}_{i:06d}.npy"

    def commit(self, state: dict, extra: Optional[dict] = None) -> str:
        """Write the non-sharded state + metadata and publish the step.
        Sharded arrays come back from ``restore_arrays`` stitched under
        their plain name, exactly like ``save``'d entries."""
        flat = flatten(state)
        arrays = {f"a{i}": x for i, (_, x) in enumerate(flat)}
        meta = {"step": self.step,
                "paths": [p for p, _ in flat],
                "shards": self._shards,
                "extra": extra or {}}
        np.savez(os.path.join(self.tmp, "arrays.npz"), **arrays)
        with open(os.path.join(self.tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        self.manager._publish(self.tmp, self.final, False)
        self._done = True
        self.manager._gc()
        return self.final

    def abort(self) -> None:
        """Discard the staged shards (graceful-failure path; a hard kill
        leaves the same end state via reconcile)."""
        self._done = True
        shutil.rmtree(self.tmp, ignore_errors=True)


class CheckpointManager:
    def __init__(self, directory: str, keep_n: int = 3):
        self.dir = directory
        self.keep_n = keep_n
        self.synced_ms = 0.0          # the durable publishes' fsyncs
        self.synced_bytes = 0
        os.makedirs(directory, exist_ok=True)

    def stage_sharded(self, step: int) -> ShardedSave:
        """Open a shard-streaming save of ``step`` (see ShardedSave)."""
        return ShardedSave(self, step)

    def save(self, step: int, state, extra: Optional[dict] = None, *,
             durable: bool = False) -> str:
        """Publish ``state`` (a tree of arrays or tensors) as ``step``
        (``durable``: on disk when this returns)."""
        flat = flatten(state)
        arrays = {f"a{i}": x for i, (_, x) in enumerate(flat)}
        meta = {"step": int(step),
                "paths": [p for p, _ in flat],
                "extra": extra or {}}
        final = os.path.join(self.dir, f"step_{step:010d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        self._publish(tmp, final, durable)
        self._gc()
        return final

    def _publish(self, tmp: str, final: str, durable: bool) -> None:
        """Rename the staged step ``tmp`` to ``final``; ``durable``: its
        files and itself fsync'd before the rename, the checkpoint
        directory after it."""
        t0 = time.perf_counter()
        nbytes = fsync_step(tmp) if durable else 0
        sync_s = time.perf_counter() - t0
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)                    # atomic publish
        if durable:
            t0 = time.perf_counter()
            fsync_path(self.dir)
            sync_s += time.perf_counter() - t0
            self.synced_ms += sync_s * 1e3
            self.synced_bytes += nbytes

    def sync_latest(self) -> int:
        """fsync the latest published step (its files and directory) and
        the checkpoint directory; the files' bytes (0 with no step)."""
        step = self.latest_step()
        if step is None:
            return 0
        n = fsync_step(os.path.join(self.dir, f"step_{step:010d}"))
        fsync_path(self.dir)
        return n

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep_n]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"),
                          ignore_errors=True)

    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)", name)
            if m and os.path.exists(os.path.join(self.dir, name,
                                                 "meta.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore_arrays(self, step: int):
        """``({path: np.ndarray}, extra)`` of a published step; sharded
        arrays come back stitched under their plain path."""
        path = os.path.join(self.dir, f"step_{step:010d}")
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        data = np.load(os.path.join(path, "arrays.npz"))
        arrays = {p: data[f"a{i}"] for i, p in enumerate(meta["paths"])}
        for name, ent in meta.get("shards", {}).items():
            parts = [np.load(os.path.join(path, f"shard_{name}_{i:06d}.npy"))
                     for i in range(ent["count"])]
            arrays[key_path(name)] = (
                np.concatenate(parts) if parts
                else np.zeros((0,), np.dtype(ent["dtype"] or "int32")))
        return arrays, meta["extra"]

    def restore(self, step: int, like, shardings=None):
        """``(tree, extra)``: step ``step`` in the structure of ``like``,
        each leaf found by its key path, checked for shape and cast to
        the ``like`` leaf's dtype; a tensor (or ``Sharded``) leaf comes
        back a tensor on that leaf's device, anything else numpy.  With
        ``shardings=(mesh, spec_tree)`` the leaves come back placed on
        ``mesh`` by ``spec_tree`` (``distributed.sharding.place_tree``)."""
        saved, extra = self.restore_arrays(step)
        if shardings is not None:
            from repro_torch.distributed.sharding import place
            mesh, specs = shardings
            specs = T.leaves(specs)
        leaves = []
        for k, (p, x) in enumerate(T.flatten_with_path(like)):
            if p not in saved:
                raise KeyError(f"checkpoint missing leaf {p}")
            a = saved[p]
            if tuple(a.shape) != tuple(x.shape):
                raise ValueError(f"shape mismatch at {p}: "
                                 f"{a.shape} vs {tuple(x.shape)}")
            if hasattr(x, "detach") or hasattr(x, "layout"):
                import torch                     # a tensor or a Sharded
                t = torch.from_numpy(a if a.flags.writeable else a.copy()
                                     ).to(device=x.device, dtype=x.dtype)
                leaves.append(t if shardings is None
                              else place(t, specs[k], mesh))
            else:
                leaves.append(a.astype(np.asarray(x).dtype))
        return T.unflatten_like(like, leaves), extra

    def restore_latest(self, like, shardings=None):
        """``(step, tree, extra)`` of the latest step, or None."""
        step = self.latest_step()
        if step is None:
            return None
        tree, extra = self.restore(step, like, shardings)
        return step, tree, extra
