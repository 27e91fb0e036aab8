"""``Catalog`` — named tables under one root directory, the port's own
copy of ``repro.api.catalog`` (same layout, so a root written by either
package opens in the other)::

    root/
      catalog.json                 # {"tables": {name: {is_dna, ...}}}
      <name>/                      # one dir per table (CheckpointManager)
        step_0000000001/           #   atomic versioned snapshots
          arrays.npz  meta.json    #   codes + sa_real + mem_codes + runs
        wal/wal.log                #   the table's live commit-log segment
        fm/step_.../               #   frozen-tier FM-index artifact

``catalog.json`` is rewritten atomically (tmp + ``os.replace``).  Commit
logs and FM artifacts live inside each table's directory, so
``drop_table`` and the crashed-create reconcile remove them with the
table.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
from typing import Optional

# no leading dot: forbids '.', '..' (drop_table rmtree's the name under
# root) and hidden-file collisions; 'catalog.json' is the catalog's own
_NAME_RE = re.compile(r"(?!\.)[A-Za-z0-9._-]{1,128}")
_RESERVED_NAMES = frozenset({"catalog.json"})


def default_root() -> str:
    """Root directory for persisted tables (``REPRO_TABLE_ROOT``, else
    ``./repro_tables``)."""
    return os.environ.get("REPRO_TABLE_ROOT", "repro_tables")


def _check_name(name: str) -> str:
    if not _NAME_RE.fullmatch(name or "") or name in _RESERVED_NAMES:
        raise ValueError(f"table name {name!r} must match "
                         f"{_NAME_RE.pattern} and not be reserved "
                         f"(it becomes a directory under the root)")
    return name


_STEP_RE = re.compile(r"step_(\d+)")


def _has_snapshot(table_dir: str) -> bool:
    """True iff ``table_dir`` holds at least one PUBLISHED snapshot (a
    ``step_*`` dir with its meta.json — the same test as
    ``CheckpointManager.all_steps``, without the ctor's mkdir)."""
    if not os.path.isdir(table_dir):
        return False
    for entry in os.listdir(table_dir):
        if _STEP_RE.fullmatch(entry) and os.path.exists(
                os.path.join(table_dir, entry, "meta.json")):
            return True
    return False


def _is_table_remnant(table_dir: str) -> bool:
    """True iff every entry of ``table_dir`` is table machinery — step
    dirs (published or ``.tmp`` partial streams), ``wal/``, ``fm/``, the
    serving plane's ``tablets/`` map and ``metrics.jsonl`` feed.  The
    guard that keeps reconcile from deleting an unrelated directory (a
    user's spill dir, say) that merely lives under the catalog root."""
    for entry in os.listdir(table_dir):
        if entry in ("wal", "fm", "tablets", "metrics.jsonl"):
            continue
        if _STEP_RE.fullmatch(entry.removesuffix(".tmp")):
            continue
        return False
    return True


def table_wal_dir(root: str, name: str) -> str:
    """Directory holding ``name``'s commit-log segments under ``root``
    (the single place the WAL path layout is decided)."""
    return os.path.join(root, name, "wal")


def table_fm_dir(root: str, name: str) -> str:
    """Directory holding ``name``'s frozen-tier FM-index artifact (the
    single place the fm/ path layout is decided — ``drop_table`` and the
    crashed-create reconcile remove it with the table dir)."""
    return os.path.join(root, name, "fm")


def table_tablets_dir(root: str, name: str) -> str:
    """Directory of ``name``'s serving-plane tablet map (the reference's
    ``manifest.json`` and ``serving.json``); inside the table directory,
    so drop and reconcile remove it with the table; the layout is the
    reference's."""
    return os.path.join(root, name, "tablets")


class Catalog:
    """Named-table registry over one root directory."""

    def __init__(self, root: Optional[str] = None, *,
                 reconcile: bool = True):
        self.root = root or default_root()
        os.makedirs(self.root, exist_ok=True)
        if reconcile:
            self.reconcile()

    def reconcile(self) -> list[str]:
        """Garbage-collect crashed-create remnants; returns the names
        removed.  Three cases (docs/build_pipeline.md, "Crash safety"):

        * a REGISTERED table with no published snapshot — a create
          (including the staged shard-streaming path) died between
          ``register`` and the atomic publish: its entry and directory
          (holding at most a ``step_*.tmp`` partial stream, a wal/, an
          empty fm/) are removed;
        * an UNREGISTERED directory with no published snapshot whose
          contents are all table machinery (step dirs / .tmp stages /
          wal/ / fm/) — a pre-register crash: removed.  A directory
          holding anything else is NOT touched — it is the user's, not a
          remnant;
        * a stale ``step_*.tmp`` staging dir inside an otherwise healthy
          table — a crashed re-publish (flush/compact): just the .tmp is
          removed, the table survives.

        Directories with a published snapshot but no catalog entry (a
        crashed ``drop_table``) are left for ``drop_table`` to finish —
        they hold real data, so an open-time GC must not guess."""
        removed: list[str] = []
        data = self.load()
        dirty = False
        for name in list(data["tables"]):
            table_dir = os.path.join(self.root, name)
            if not _has_snapshot(table_dir):
                shutil.rmtree(table_dir, ignore_errors=True)
                del data["tables"][name]
                dirty = True
                removed.append(name)
        if dirty:
            self._write(data)
        for entry in os.listdir(self.root):
            path = os.path.join(self.root, entry)
            if not os.path.isdir(path):
                continue
            if (entry in data["tables"] or _has_snapshot(path)
                    or not _is_table_remnant(path)):
                # healthy (or data-bearing orphan, or not ours at all):
                # drop only stale .tmp stages left by a crashed republish
                for sub in os.listdir(path):
                    if sub.endswith(".tmp") and \
                            _STEP_RE.fullmatch(sub.removesuffix(".tmp")):
                        shutil.rmtree(os.path.join(path, sub),
                                      ignore_errors=True)
                continue
            shutil.rmtree(path, ignore_errors=True)
            removed.append(entry)
        return removed

    # -- the metadata file ---------------------------------------------------
    @property
    def path(self) -> str:
        return os.path.join(self.root, "catalog.json")

    def load(self) -> dict:
        if not os.path.exists(self.path):
            return {"tables": {}}
        with open(self.path) as f:
            data = json.load(f)
        data.setdefault("tables", {})
        return data

    def _write(self, data: dict) -> None:
        fd, tmp = tempfile.mkstemp(dir=self.root, suffix=".catalog.tmp")
        with os.fdopen(fd, "w") as f:
            json.dump(data, f, indent=2, sort_keys=True)
            f.write("\n")
        os.replace(tmp, self.path)            # atomic publish

    def register(self, name: str, meta: dict) -> None:
        data = self.load()
        data["tables"][name] = dict(meta)
        self._write(data)

    # -- queries -------------------------------------------------------------
    def list_tables(self) -> list[str]:
        return sorted(self.load()["tables"])

    def table_meta(self, name: str) -> dict:
        tables = self.load()["tables"]
        if name not in tables:
            raise KeyError(f"no table {name!r} in catalog {self.root!r}")
        return tables[name]

    def __contains__(self, name: str) -> bool:
        return name in self.load()["tables"]

    def wal_dir(self, name: str) -> str:
        """Where ``name``'s commit log lives (``api.wal``)."""
        return table_wal_dir(self.root, name)

    def fm_dir(self, name: str) -> str:
        """Where ``name``'s frozen FM-index artifact lives (``api.fm``)."""
        return table_fm_dir(self.root, name)

    def tablets_dir(self, name: str) -> str:
        """Where ``name``'s serving-plane tablet map lives."""
        return table_tablets_dir(self.root, name)

    def create_table(self, name: str, codes, **kw):
        """``SuffixTable.create`` under this root."""
        from repro_torch.api.table import SuffixTable
        return SuffixTable.create(name, codes, root=self.root, **kw)

    def open_table(self, name: str, **kw):
        """``SuffixTable.open`` under this root."""
        from repro_torch.api.table import SuffixTable
        return SuffixTable.open(name, root=self.root, **kw)

    # -- table lifecycle -----------------------------------------------------
    def drop_table(self, name: str, *, missing_ok: bool = False) -> None:
        """Unregister ``name`` and delete its on-disk state — snapshots,
        commit log, and every per-table auxiliary artifact dir (wal/,
        fm/) under the table directory.

        An UNREGISTERED name whose directory still exists is a crashed
        create/drop remnant: its orphan dir (which can hold a frozen
        FM-index or a stale log, not just snapshots) is removed too,
        instead of leaking forever behind the KeyError.  The name is
        validated before any rmtree so a crafted name can never escape
        the root."""
        _check_name(name)
        data = self.load()
        table_dir = os.path.join(self.root, name)
        if name not in data["tables"]:
            if os.path.isdir(table_dir):      # orphan-dir reconcile
                shutil.rmtree(table_dir, ignore_errors=True)
                return
            if missing_ok:
                return
            raise KeyError(f"no table {name!r} in catalog {self.root!r}")
        del data["tables"][name]
        self._write(data)
        shutil.rmtree(table_dir, ignore_errors=True)
