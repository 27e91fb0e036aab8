"""repro_torch — the PyTorch/CUDA port of ``repro``'s suffix-array table.

Laid out module for module like ``repro`` so each counterpart is easy to
find.  It imports ``torch`` and numpy only: never ``jax`` and never a
module of ``repro``.  Entry points run on the CUDA device unless the
caller passes ``device="cpu"`` (see :mod:`repro_torch.device`).

Packed DNA words are ``torch.uint32`` tensors (big-endian, 16 bases per
word, the ``repro.core.codec`` layout).  PyTorch on the CPU cannot
compare or shift ``uint32``, so the plain versions widen words to
``int64`` holding the unsigned value before any arithmetic; the CUDA
kernels read the same tensors as ``uint32``.

``resolve_device`` resolves lazily (PEP 562), so the standard-library
modules (``serving.metrics``, and ``launch.serve --dump-stats``) import
without torch.
"""
import importlib

__all__ = ["resolve_device"]


def __getattr__(name: str):
    if name != "resolve_device":
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    value = importlib.import_module("repro_torch.device").resolve_device
    globals()[name] = value
    return value
