"""Atomic JSON writes — the two helpers of
``torchpruner_tpu/resilience/manifest.py`` the checkpoint format and the
serving drain snapshot need.  The run manifest itself is ROADMAP A8."""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Optional


def fsync_dir(path: str) -> None:
    """Best-effort directory fsync — makes the rename durable on POSIX
    filesystems that need it; silently skipped where unsupported."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_write_json(path: str, obj: Any, *, indent: Optional[int] = 2,
                      default=None) -> None:
    """Write ``obj`` as JSON such that ``path`` is either the old complete
    file or the new complete file — never a truncated hybrid: tmp in the
    same directory, flush, fsync, ``os.replace``, fsync the directory."""
    path = os.path.abspath(path)
    d = os.path.dirname(path)
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".tmp.", suffix=".json")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(obj, f, indent=indent, default=default)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        fsync_dir(d)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
