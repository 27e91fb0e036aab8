"""Hand-written CUDA kernels for the scan path, one per TPU kernel of
``repro.kernels`` that the single-device table path runs:

  pack2bit      — 2-bit DNA ingest packing          (csrc/pack2bit.cu)
  pattern_scan  — masked packed compare, and the batched binary search
                  built on it                       (csrc/pattern_scan.cu)
  tier_scan     — dense scan over every delta tier  (csrc/tier_scan.cu)

``ref.py`` holds their plain PyTorch versions, ``ops.py`` the wrappers
that pick one by the tensor's device, ``_build.py`` the nvcc harness.
Kernel sources build on first use, never at import."""
from repro_torch.kernels import ops, ref

__all__ = ["ops", "ref"]
