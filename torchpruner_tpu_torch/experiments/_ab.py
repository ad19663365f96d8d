"""What the kernel A/B scripts share (``flash_ab``, ``dequant_ab``,
``blocksparse_ab``): the turn order, extracting an earlier revision's
kernel sources, building a second library from them, and binding the
package's wrappers to it.

An earlier source is built from its own directory, beside the headers of
its own revision, never against the package's ``csrc/``: so a later edit
of a shared header cannot leak into the "old" side of an A/B.  Extract a
revision's ``csrc/`` (its ``.cu`` and ``.cuh`` files) into the
git-ignored ``_archive/REV/`` with

    python -m torchpruner_tpu_torch.experiments._ab REV

and pass ``--old _archive/REV/NAME.cu`` to an A/B.  An edited copy of a
source, placed beside its headers there, is timed the same way."""

from __future__ import annotations

import contextlib
import ctypes
import re
import subprocess
import sys
import time
from pathlib import Path

#: turns of an A/B in one process on one card
ORDER = ("old", "new", "new", "old")

_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


def archive(rev: str, root: str = "_archive") -> Path:
    """Write every kernel source and shared header of ``csrc/`` at git
    revision ``rev`` into ``root/rev/``; that directory."""
    csrc = "torchpruner_tpu_torch/csrc"
    dest = Path(root) / rev
    dest.mkdir(parents=True, exist_ok=True)
    names = subprocess.run(["git", "ls-tree", "--name-only", f"{rev}:{csrc}"],
                           check=True, capture_output=True,
                           text=True).stdout.split()
    for name in names:
        if name.endswith((".cu", ".cuh")):
            (dest / name).write_bytes(subprocess.run(
                ["git", "show", f"{rev}:{csrc}/{name}"], check=True,
                capture_output=True).stdout)
    return dest


def missing_includes(src) -> list:
    """The quoted ``#include`` files that ``src`` reaches, directly or
    through a header, and that do not lie beside the file naming them."""
    missing, seen, todo = [], set(), [Path(src)]
    while todo:
        f = todo.pop()
        for name in _INCLUDE.findall(f.read_text()):
            h = f.parent / name
            if h in seen:
                continue
            seen.add(h)
            if h.exists():
                todo.append(h)
            else:
                missing.append(str(h))
    return missing


def build_library(src: str, tag: str) -> tuple:
    """Compile ``src`` with the package's nvcc flags, its quoted includes
    taken from its own directory only, into ``_build/lib{tag}.so``; the
    loaded library and the build seconds.  Raises before compiling when
    a header it includes is not beside it."""
    from torchpruner_tpu_torch.ops import _build

    missing = missing_includes(src)
    if missing:
        raise FileNotFoundError(
            f"{src} includes {', '.join(missing)}, not beside it: extract "
            "its revision's csrc/ whole (python -m "
            "torchpruner_tpu_torch.experiments._ab REV)")
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = _build.BUILD_DIR / f"lib{tag}.so"
    t0 = time.perf_counter()
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(out), src],
                   check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(out)), time.perf_counter() - t0


@contextlib.contextmanager
def bound_library(name: str, lib: ctypes.CDLL):
    """While open, the package's wrappers that launch from library
    ``name`` (``_build.function(name, ...)``) launch from ``lib``."""
    from torchpruner_tpu_torch.ops import _build

    saved_lib = _build._libs.get(name)
    saved = {k: _build._fns.pop(k) for k in list(_build._fns)
             if k[0] == name}
    _build._libs[name] = lib
    try:
        yield
    finally:
        for k in [k for k in _build._fns if k[0] == name]:
            del _build._fns[k]
        _build._fns.update(saved)
        if saved_lib is None:
            _build._libs.pop(name, None)
        else:
            _build._libs[name] = saved_lib


if __name__ == "__main__":
    if len(sys.argv) != 2:
        sys.exit("usage: python -m torchpruner_tpu_torch.experiments._ab REV")
    print(archive(sys.argv[1]))
