"""Hand-written CUDA kernels for the scan path, one per TPU kernel of
``repro.kernels``:

  pack2bit      — 2-bit DNA ingest packing          (csrc/pack2bit.cu)
  pattern_scan  — masked packed compare, and the batched binary search
                  built on it                       (csrc/pattern_scan.cu)
  tablet_scan   — dense scan over consecutive sorted rows
                                                    (csrc/tablet_scan.cu)
  tier_scan     — dense scan over every delta tier  (csrc/tier_scan.cu)
  fm_scan       — FM-index backward search of a frozen table
                                                    (csrc/fm_scan.cu)

``ref.py`` (and ``fm_scan.py``) hold their plain PyTorch versions, ``ops.py`` the wrappers
that pick one by the tensor's device, ``_build.py`` the nvcc harness.
Kernel sources build on first use, never at import."""
from repro_torch.kernels import ops, ref

__all__ = ["ops", "ref"]
