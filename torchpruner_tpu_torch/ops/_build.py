"""Build and load the port's CUDA kernels (the four sources of
``csrc/``, listed in :data:`KERNELS`) at first use.

Each source compiles with ``nvcc`` into its own shared library with a
plain C interface, loaded with ``ctypes`` — seconds per file, against
minutes for a source that includes PyTorch's headers.  Libraries land in
``torchpruner_tpu_torch/_build/`` (listed in ``.gitignore``) under a
name carrying a digest of the source, the shared headers and the flags,
so an edited source or header is never served by a stale library.  :func:`build` compiles every missing
library in parallel, one ``nvcc`` per source, all started together.

Every build and every load is reported to the callables in
:data:`listeners` as ``listener(event, name, seconds)`` with ``event``
``"build"`` or ``"load"`` — how the telemetry plane counts the port's
compiles (``obs/compile_watch.py``).
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
from typing import Callable, Dict, Iterable, List, Optional

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

#: build/load observers, called ``(event, name, seconds)`` on the
#: building or loading thread; an observer that raises is ignored
listeners: List[Callable[[str, str, float], None]] = []

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[tuple, object] = {}


def _report(event: str, name: str, seconds: float) -> None:
    for fn in list(listeners):
        try:
            fn(event, name, seconds)
        except Exception:
            pass


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
    """The library of ``csrc/{name}.cu``, named by a digest of the source,
    every shared header of ``csrc/`` (``*.cuh``) and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


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
    for name, v in info.items():
        if not v["cached"]:
            _report("build", name, v["seconds"])
    return info


def library(name: str) -> ctypes.CDLL:
    """The loaded library for kernel ``name``, built on first use."""
    lib: Optional[ctypes.CDLL] = _libs.get(name)
    if lib is None:
        build([name])
        loaded = None
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                t0 = time.perf_counter()
                lib = _libs[name] = ctypes.CDLL(str(_target(name)))
                loaded = time.perf_counter() - t0
        if loaded is not None:
            _report("load", name, loaded)
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
