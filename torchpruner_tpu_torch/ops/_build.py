"""Build and load the port's CUDA kernels (the four sources of
``csrc/``, listed in :data:`KERNELS`) at first use.

Each source compiles with ``nvcc`` into its own shared library with a
plain C interface, loaded with ``ctypes`` — seconds per file, against
minutes for a source that includes PyTorch's headers.  Libraries land in
``torchpruner_tpu_torch/_build/`` (listed in ``.gitignore``) under a
name carrying a digest of the source and flags, so an edited source is
never served by a stale library.  :func:`build` compiles every missing
library in parallel, one ``nvcc`` per source, all started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"

#: every kernel source of the port, by library name: four sources holding
#: nine kernels (dequant matmul; decode attention; flash forward, dQ and
#: dK/dV; block-sparse forward, dx and dW)
KERNELS = ("dequant_matmul", "decode_attention", "flash_attention",
           "blocksparse_matmul")

#: Hopper with its architecture-specific features (wgmma, setmaxnreg)
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[tuple, object] = {}


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``/usr/local/cuda``,
    or the one on ``PATH``."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, dict]:
    """Compile every library of ``names`` not built yet, in parallel.
    Returns ``{name: {"seconds", "ptxas", "cached"}}``; raises with the
    compiler's output when a source does not compile."""
    names = list(names)
    info: Dict[str, dict] = {}
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for name in names:
            out = _target(name)
            if out.exists():
                info[name] = {"seconds": 0.0, "ptxas": "", "cached": True}
                continue
            tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
            cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True), tmp, out, time.perf_counter())
        for name, (proc, tmp, out, t0) in procs.items():
            stdout, stderr = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed for csrc/{name}.cu (exit "
                    f"{proc.returncode}):\n{stdout}\n{stderr}")
            os.replace(tmp, out)
            info[name] = {"seconds": time.perf_counter() - t0,
                          "ptxas": (stdout + stderr).strip(),
                          "cached": False}
    return info


def library(name: str) -> ctypes.CDLL:
    """The loaded library for kernel ``name``, built on first use."""
    lib: Optional[ctypes.CDLL] = _libs.get(name)
    if lib is None:
        build([name])
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = _libs[name] = ctypes.CDLL(str(_target(name)))
    return lib


def function(lib: str, name: str, argtypes):
    """Kernel entry ``name`` of library ``lib`` with its ctypes signature
    set (returning a ``cudaError_t`` as int), configured once."""
    fn = _fns.get((lib, name))
    if fn is None:
        fn = getattr(library(lib), name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _fns[(lib, name)] = fn
    return fn


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t "
                           f"{err}")
