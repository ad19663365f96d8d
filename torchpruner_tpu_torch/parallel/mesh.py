"""Device meshes on ``torch.distributed`` — counterpart of
``torchpruner_tpu/parallel/mesh.py``.

One process per device, started by ``torchrun`` (``RANK`` /
``WORLD_SIZE`` / ``LOCAL_RANK`` / ``MASTER_ADDR`` in the environment);
:func:`initialize_distributed` joins the process group and
:func:`make_mesh` lays the ranks out on named axes, row-major in the
order the config lists them (``{"data": 2, "model": 2}``: rank
``2 d + m`` sits at ``(data=d, model=m)``).  Default axes: ``data`` (DP
/ sharded scoring) and ``model`` (FSDP / TP).

Each rank's device is ``cuda:LOCAL_RANK % device_count``, so several
ranks may share one card.  NCCL refuses two ranks on one device, so
when the ranks of a host outnumber its cards the group runs on gloo,
which takes CUDA tensors too.
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

def _env_rank() -> Optional[int]:
    r = os.environ.get("RANK")
    return None if r is None else int(r)


def rank_device(device=None) -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK % device_count`` for a CUDA
    run (``device`` None or ``"cuda"``), else ``device``."""
    from torchpruner_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    local = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local % torch.cuda.device_count())


def backend_for(device: torch.device) -> str:
    """``nccl`` on CUDA when every rank of the host has a card of its
    own, ``gloo`` when ranks share a card (NCCL refuses two ranks on
    one device) and on the CPU."""
    if device.type != "cuda":
        return "gloo"
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
    return "nccl" if local_world <= torch.cuda.device_count() else "gloo"


def initialize_distributed(device=None, *, timeout_s: float = 600.0
                           ) -> bool:
    """Join the ``torchrun`` process group (the JAX package's
    ``jax.distributed.initialize``).  Returns True when running
    distributed, False (and does nothing) without torchrun's ``RANK`` /
    ``WORLD_SIZE`` / ``MASTER_ADDR`` in the environment.  Safe to call
    twice; the rank's CUDA device is made current."""
    if dist.is_initialized():
        return True
    if _env_rank() is None or not os.environ.get("MASTER_ADDR") \
            or os.environ.get("WORLD_SIZE") is None:
        return False
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend_for(dev), init_method="env://",
        rank=int(os.environ["RANK"]),
        world_size=int(os.environ["WORLD_SIZE"]),
        timeout=datetime.timedelta(seconds=timeout_s))
    return True


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def resolve_axes(axes: Optional[Dict[str, int]], n: int) -> Dict[str, int]:
    """``axes`` with its ``-1`` resolved against ``n`` devices, checked
    as the JAX package checks it: at most one ``-1``, and the product of
    the sizes equals ``n`` (the error names both numbers)."""
    if axes is None:
        return {"data": n}
    names = tuple(axes.keys())
    sizes = [int(s) for s in axes.values()]
    if sizes.count(-1) > 1:
        raise ValueError("at most one axis size may be -1")
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        if n % known:
            raise ValueError(f"{n} devices not divisible by {known}")
        sizes[sizes.index(-1)] = n // known
    if int(np.prod(sizes)) != n:
        raise ValueError(
            f"mesh {dict(zip(names, sizes))} needs {int(np.prod(sizes))} "
            f"devices, have {n}")
    return dict(zip(names, sizes))


def _ensure_group(device: torch.device) -> None:
    """A world of one when no process group exists (a mesh config run
    without torchrun): an in-memory store, this process as rank 0."""
    if dist.is_initialized():
        return
    dist.init_process_group(backend_for(device), store=dist.HashStore(),
                            rank=0, world_size=1)


def make_mesh(axes: Optional[Dict[str, int]] = None, device=None):
    """A ``DeviceMesh`` from ``{axis_name: size}`` whose dimension names
    are the config's axis names.

    - ``axes=None``: every rank on a 1-D ``data`` axis (pure DP);
    - one size may be ``-1``, meaning "whatever is left";
    - the product must equal the world size (``ValueError`` naming
      both otherwise).

    Without torchrun the world is this one process (a group of one is
    made)."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = rank_device(device)
    shape = resolve_axes(axes, world_size())
    _ensure_group(dev)
    return init_device_mesh(dev.type, tuple(shape.values()),
                            mesh_dim_names=tuple(shape.keys()))


def make_hybrid_mesh(ici_axes: Dict[str, int], dcn_axes: Dict[str, int],
                     *, device=None, devices: Optional[Sequence] = None):
    """The JAX package's multi-slice mesh, single-slice fallback only:
    the same axis names and sizes as ``make_mesh({**dcn_axes,
    **ici_axes})`` (DCN axes first).  ``devices`` is accepted for the
    JAX signature and must be None."""
    if devices is not None:
        raise ValueError("make_hybrid_mesh lays out the process group's "
                         "ranks; an explicit device list is not taken")
    return make_mesh({**dcn_axes, **ici_axes}, device=device)


def mesh_axes(mesh) -> Dict[str, int]:
    """``{axis_name: size}`` of a ``DeviceMesh`` (or of a plain dict, as
    the placement rules take it)."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate on ``axis`` (0 when the mesh lacks it)."""
    if axis not in (mesh.mesh_dim_names or ()):
        return 0
    return int(mesh.get_coordinate()[mesh.mesh_dim_names.index(axis)])


def is_writer() -> bool:
    """True on the one rank that writes a run's outputs (rank 0; the
    only rank without a process group)."""
    return rank() == 0
