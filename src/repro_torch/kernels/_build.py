"""Build harness for the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled on first use by ``nvcc`` for Hopper
(``-gencode arch=compute_90a,code=sm_90a -O3``) into a shared library
with a plain C interface, then loaded with ``ctypes``.  No PyTorch header
is included, so a source builds in seconds; the wrappers pass
``tensor.data_ptr()`` and ``torch.cuda.current_stream().cuda_stream``.

Libraries land in ``build/repro_torch_kernels/`` at the root of the
checkout (listed in ``.gitignore``), named by a hash of their source and
of every shared header ``csrc/*.cuh``, so an edited source or header is
rebuilt and a stale library is never loaded.  A
failed build raises; nothing falls back to the plain version.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch_kernels"
SOURCES = ("pack2bit", "pattern_scan", "tier_scan", "tablet_scan", "fm_scan",
           "lf_walk")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[tuple[str, str], object] = {}
_lock = threading.Lock()

# launches per kernel; each wrapper adds one where it launches, so a run
# can show its main path went through the kernels.  A search launch
# with the compare epilogue (pattern_scan.bounded_match_cuda) counts as
# bounded_search and as pattern_compare_fused; pattern_compare counts
# the standalone compare only.
LAUNCHES = {"pack2bit": 0, "pattern_compare": 0, "pattern_compare_fused": 0,
            "bounded_search": 0, "tier_scan": 0, "tablet_scan": 0,
            "fm_scan": 0, "lf_walk": 0}


# widest pattern batch (words of 16 bases) the four searches take: each
# stages its query's words in shared memory (MAX_PATTERN_WORDS of
# csrc/search.cuh, which all four include)
MAX_PATTERN_WORDS = 256


def check_width(W: int, what: str) -> None:
    """Raise for a pattern batch wider than the kernels take (never
    truncate it)."""
    if W > MAX_PATTERN_WORDS:
        raise ValueError(
            f"{what}: {W} pattern words > {MAX_PATTERN_WORDS} "
            f"({16 * MAX_PATTERN_WORDS} bases), the widest batch the "
            f"kernel stages in shared memory")


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin and PATH): the CUDA kernels "
                           "cannot be built")
    return found


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to: named by a digest of the
    source and of every header in ``csrc``, which any source may
    include."""
    h = hashlib.sha256()
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.name.encode() + b"\0" + src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def build(names=SOURCES) -> dict[str, Path]:
    """Compile every source in ``names`` whose library is missing, one
    ``nvcc`` per source, all started together.  Returns name -> library
    path.  Raises ``RuntimeError`` with the compiler output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    out = {}
    for name in names:
        lib = library_path(name)
        out[name] = lib
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp.so")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, lib)
    errors = []
    for name, (proc, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        (BUILD_DIR / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu "
                          f"(exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, lib)
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build((name,))[name]))
            _libs[name] = lib
        return lib


def launcher(name: str, symbol: str, argtypes):
    """The C launcher ``symbol`` of ``csrc/<name>.cu``, its argument
    types (``ctypes.c_void_p`` for pointers and the stream) and its
    ``int`` return (a ``cudaError_t``) set once, when first asked for."""
    fn = _fns.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _fns[(name, symbol)] = fn
    return fn


def check(status: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launcher."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t "
                           f"{status}")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
