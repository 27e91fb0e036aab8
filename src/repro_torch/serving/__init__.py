"""repro_torch.serving — the scan service (``HedgedScanService``), the
metrics feed and per-query tracing, ported from ``repro.serving``.

Exports resolve lazily (PEP 562), as the reference's do, so the
standard-library-only modules (``metrics``, ``trace``) import without
the table and its kernels' wrappers.  The reference's LM serving
functions and its multi-process serving plane are not ported yet.
"""
import importlib

_EXPORTS = {
    "HedgedScanService": "repro_torch.serving.engine",
    "ScanPlanner": "repro_torch.core.planner",
    "aggregate_metrics": "repro_torch.serving.metrics",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    value = getattr(importlib.import_module(module), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
