"""repro_torch.api — the table-level public API, ported from
``repro.api``.

Storage side: ``SuffixTable`` (build, read, append, compact, freeze,
create/open/flush under a ``Catalog`` root, the commit log).  Client
side: ``Database`` routes typed ``Query`` requests by table name,
coalesces concurrent callers through a ``QueryScheduler``, and streams
huge enumerations in pages via ``ReadSession``.

Exports resolve lazily (PEP 562), as the reference's do: importing a
light submodule such as ``repro_torch.api.wal`` does not import the
table and its kernels' wrappers.
"""
import importlib

_EXPORTS = {
    "Catalog": "repro_torch.api.catalog",
    "Database": "repro_torch.api.client",
    "Page": "repro_torch.api.client",
    "Query": "repro_torch.api.client",
    "QueryFuture": "repro_torch.api.client",
    "QueryResult": "repro_torch.api.client",
    "QueryScheduler": "repro_torch.api.client",
    "ReadSession": "repro_torch.api.client",
    "FMIndex": "repro_torch.api.fm",
    "Memtable": "repro_torch.api.memtable",
    "Run": "repro_torch.api.runs",
    "SuffixTable": "repro_torch.api.table",
    "default_root": "repro_torch.api.table",
    "open_table": "repro_torch.api.table",
    "RecoverySummary": "repro_torch.api.wal",
    "WriteAheadLog": "repro_torch.api.wal",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    value = getattr(importlib.import_module(module), name)
    globals()[name] = value        # cache: resolve each name once
    return value


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
