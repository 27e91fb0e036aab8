"""Hand-written CUDA kernels for the scan path, one per TPU kernel of
``repro.kernels``:

  pack2bit      — 2-bit DNA ingest packing          (csrc/pack2bit.cu)
  pattern_scan  — masked packed compare, and the batched binary search
                  built on it                       (csrc/pattern_scan.cu)
  tablet_scan   — 17-ary search over consecutive sorted rows
                                                    (csrc/tablet_scan.cu)
  tier_scan     — 17-ary search of every delta tier + the straddle rule
                  over the match runs               (csrc/tier_scan.cu)
  fm_scan       — FM-index backward search of a frozen table
                                                    (csrc/fm_scan.cu)

``csrc/search.cuh`` holds the compare and the warp search they share.
Plain PyTorch versions: ``ref.py`` (the TPU kernels' algorithms),
``kary.py`` with ``tablet_scan.py`` and ``tier_scan.py`` (the two
searches' own algorithm) and ``fm_scan.py``.  ``ops.py`` holds the
wrappers that pick one by the tensor's device, ``_build.py`` the nvcc
harness.
Kernel sources build on first use, never at import."""
from repro_torch.kernels import ops, ref

__all__ = ["ops", "ref"]
