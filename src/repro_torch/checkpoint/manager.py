"""Atomic, versioned snapshots — the numpy-only port of
``repro.checkpoint.manager`` (the parts a table needs: ``save``,
``all_steps``, ``latest_step``, ``restore_arrays``, ``keep_n`` GC).

On-disk format, the reference's, so a snapshot written by either package
restores in the other::

    <dir>/step_0000000001/arrays.npz   keys a0, a1, ... (one per leaf)
    <dir>/step_0000000001/meta.json    {"step", "paths", "extra"}

``paths`` lists the leaves in the order jax flattens a dict (sorted
keys) as jax's key-path strings (``"['codes']"``); a state here is a
flat dict of arrays.  A save writes ``step_XXXX.tmp`` and publishes it
with one ``os.rename``, so a preempted save never corrupts the latest
snapshot; ``.tmp`` dirs are ignored by :meth:`CheckpointManager.
all_steps`.  The reference's shard-streaming save (``stage_sharded``)
belongs to the staged build and is not ported; ``restore_arrays`` reads
such a snapshot's shards all the same.
"""
from __future__ import annotations

import json
import os
import re
import shutil
from typing import Optional

import numpy as np


def key_path(key: str) -> str:
    """jax's key-path string of a dict entry: ``"['codes']"``."""
    return f"[{key!r}]"


def by_key(arrays: dict) -> dict:
    """Strip the key-path decoration of restored arrays: ``"['codes']"``
    -> ``"codes"``."""
    return {re.sub(r"[^0-9A-Za-z_]", "", k): v for k, v in arrays.items()}


def flatten(state: dict) -> list[tuple[str, np.ndarray]]:
    """(path, array) per entry of a flat dict, in jax's flatten order
    (sorted keys); tensors come back to host numpy."""
    out = []
    for k in sorted(state):
        v = state[k]
        if hasattr(v, "detach"):                    # a torch tensor
            v = v.detach().cpu().numpy()
        out.append((key_path(k), np.asarray(v)))
    return out


class CheckpointManager:
    def __init__(self, directory: str, keep_n: int = 3):
        self.dir = directory
        self.keep_n = keep_n
        os.makedirs(directory, exist_ok=True)

    def save(self, step: int, state: dict,
             extra: Optional[dict] = None) -> str:
        """Publish ``state`` (a flat dict of arrays) as ``step``."""
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
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)                    # atomic publish
        self._gc()
        return final

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
