"""repro_torch.serving — LM serving (``ServeConfig``, ``make_prefill_fn``,
``make_decode_fn``, ``greedy_generate``), the scan service
(``HedgedScanService``), the multi-process serving plane
(``ServingPlane``, ``TabletRouter``, ``RemoteTable``), the metrics feed
and per-query tracing, ported from ``repro.serving``.

Exports resolve lazily (PEP 562), as the reference's do, so the plane's
numpy-only modules (``rpc``, ``router``, ``plane``, ``tablet_server``,
``metrics``, ``trace``) import without torch: tablet worker processes
start in milliseconds.
"""
import importlib

_EXPORTS = {
    "HedgedScanService": "repro_torch.serving.engine",
    "ServeConfig": "repro_torch.serving.engine",
    "greedy_generate": "repro_torch.serving.engine",
    "make_decode_fn": "repro_torch.serving.engine",
    "make_prefill_fn": "repro_torch.serving.engine",
    "ScanPlanner": "repro_torch.core.planner",
    "ServingPlane": "repro_torch.serving.plane",
    "split_table": "repro_torch.serving.plane",
    "TabletRouter": "repro_torch.serving.router",
    "RemoteTable": "repro_torch.serving.router",
    "OverloadedError": "repro_torch.serving.router",
    "connect": "repro_torch.serving.router",
    "RpcClient": "repro_torch.serving.rpc",
    "RpcServer": "repro_torch.serving.rpc",
    "RpcError": "repro_torch.serving.rpc",
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
