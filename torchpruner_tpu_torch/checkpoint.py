"""Shape-aware checkpoints — counterpart of ``torchpruner_tpu/checkpoint.py``
and the parity bridge between the two packages: a checkpoint written by
either one restores in the other.

A checkpoint is a directory holding

- ``spec.json``: the model spec (layer kinds and fields, input shape and
  dtype), the prunable widths, ``step``, ``prune_history``, ``extra``,
  the quantization metadata of every ``QTensor`` leaf (``quantized``),
  the optimizer structure (``opt_treedef``) and the sha256 ``digest`` of
  the array files;
- ``arrays/index.json`` + ``arrays/data.bin``: every leaf's raw
  little-endian bytes in C order, concatenated, and per leaf its tree,
  key path, dtype name (numpy's: ``float32``, ``int8``, ``bfloat16``
  ...), shape (``[]`` for a 0-d leaf) and byte offset.  ``params`` and
  ``state`` are walked in sorted-key order; ``opt_state`` is a flat leaf
  list.

The bytes and the index are those the JAX package writes for the same
tree, so the two packages seal the same digest.  bfloat16 leaves are
read and written through torch (``t.view(torch.int16)``): the port needs
no ``ml_dtypes``.

The write is atomic and digest-sealed (arrays into a temp directory,
their digest into the spec, the spec replaced last), and a kill inside
an in-place re-save is recovered from the displaced ``.arrays.old.*``
tree.  Damage raises :class:`CheckpointCorruptError`.

A trainer over a mesh (``parallel.ShardedTrainer``) holds pieces: its
savers (``resilience/runner.py commit_checkpoint``,
``experiments/train_model.py``) gather every sharded leaf on every rank
(``full_params`` / ``full_opt_state``) and rank 0 writes the same
format, so the digest is a one-process save's of the same values; a
restore returns full trees, which the trainer re-places under its plan
(``ShardedTrainer.create`` / ``rebuild``).

Optimizer state: ``opt_treedef`` is the port's own structure string
(``train/optim.py`` states are nested dicts and lists), so within the
port a restore under another optimizer is refused; optimizer state does
not cross between the packages (their structure strings differ).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
from typing import Any, Dict, Optional

import numpy as np
import torch

from torchpruner_tpu_torch.core import layers as L
from torchpruner_tpu_torch.core.segment import SegmentedModel
from torchpruner_tpu_torch.ops.quant import QTensor
from torchpruner_tpu_torch.resilience.manifest import atomic_write_json
from torchpruner_tpu_torch.utils.device import resolve_device


class CheckpointCorruptError(RuntimeError):
    """The checkpoint on disk is incomplete or damaged (truncated write,
    bit rot, torn rename): the content digest recorded at save time does
    not match the bytes present, or a required artifact is missing or
    unparseable.  Restore from an older checkpoint — the atomic save
    protocol guarantees the previously committed one is intact."""


_LAYER_TYPES = {
    cls.__name__: cls
    for cls in (L.Dense, L.Conv, L.BatchNorm, L.LayerNorm, L.RMSNorm,
                L.Activation, L.Pool, L.GlobalPool, L.Flatten, L.Reshape,
                L.Dropout, L.Embedding, L.PosEmbed, L.ClsToken,
                L.MultiHeadAttention, L.GatedDense, L.MoE, L.Residual)
}

#: the dtype names of the index (numpy's) <-> torch storage dtypes
_DTYPES = {
    "float32": torch.float32, "float64": torch.float64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int8": torch.int8, "int16": torch.int16, "int32": torch.int32,
    "int64": torch.int64, "uint8": torch.uint8, "bool": torch.bool,
}
_NAMES = {v: k for k, v in _DTYPES.items()}


def _layer_to_dict(l) -> dict:
    if isinstance(l, L.Residual):
        return {
            "type": "Residual",
            "fields": {
                "name": l.name,
                "body": [_layer_to_dict(c) for c in l.body],
                "shortcut": [_layer_to_dict(c) for c in l.shortcut],
            },
        }
    return {"type": type(l).__name__, "fields": dataclasses.asdict(l)}


def _layer_from_dict(entry: dict):
    cls = _LAYER_TYPES.get(entry["type"])
    if cls is None:
        raise ValueError(f"the port has no layer {entry['type']!r}")
    if cls is L.Residual:
        f = entry["fields"]
        return L.Residual(
            f["name"],
            body=tuple(_layer_from_dict(c) for c in f["body"]),
            shortcut=tuple(_layer_from_dict(c) for c in f["shortcut"]),
        )
    fields = {k: tuple(v) if isinstance(v, list) else v
              for k, v in entry["fields"].items()}
    return cls(**fields)


def spec_to_dict(model: SegmentedModel) -> dict:
    """JSON-serializable model spec (layer kinds + fields + input shape)."""
    return {
        "input_shape": list(model.input_shape),
        "input_dtype": model.input_dtype,
        "layers": [_layer_to_dict(l) for l in model.layers],
    }


def spec_from_dict(d: dict) -> SegmentedModel:
    return SegmentedModel(
        tuple(_layer_from_dict(entry) for entry in d["layers"]),
        tuple(d["input_shape"]),
        d.get("input_dtype", "float32"),
    )


def _pack_qtensors(tree):
    """Replace :class:`QTensor` leaves with plain ``{"q", "scale"}``
    dicts and collect their static data keyed by root-relative path."""
    aux: Dict[str, list] = {}

    def walk(t, p):
        if isinstance(t, QTensor):
            aux[p] = [list(t.in_axes), t.bits, t.pack_axis]
            return {"q": t.q, "scale": t.scale}
        if isinstance(t, dict):
            return {k: walk(v, f"{p}/{k}" if p else k)
                    for k, v in t.items()}
        return t

    return walk(tree, ""), aux


def _unpack_qtensors(tree, aux: Dict[str, list]):
    def walk(t, p):
        if p in aux:
            in_axes, bits, pack_axis = aux[p]
            return QTensor(t["q"], t["scale"], tuple(in_axes), bits,
                           pack_axis)
        if isinstance(t, dict):
            return {k: walk(v, f"{p}/{k}" if p else k)
                    for k, v in t.items()}
        return t

    return walk(tree, "")


def _opt_leaves(tree) -> list:
    """An optimizer state's leaves in a fixed order: dict keys sorted,
    lists and tuples in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _opt_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _opt_leaves(v)]
    return [tree]


def _opt_fill(template, leaves):
    it = iter(leaves)

    def walk(t):
        if isinstance(t, dict):  # filled in sorted order, kept in t's
            filled = {k: walk(t[k]) for k in sorted(t)}
            return {k: filled[k] for k in t}
        if isinstance(t, (list, tuple)):
            out = [walk(v) for v in t]
            return out if isinstance(t, list) else type(t)(out)
        return next(it)

    return walk(template)


def opt_structure(tree) -> str:
    """The port's optimizer-structure string (``opt_treedef``): nested
    dict keys and list / tuple arities, ``*`` for a leaf."""
    if isinstance(tree, dict):
        return "{" + ",".join(f"{k}:{opt_structure(tree[k])}"
                              for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        o, c = ("[", "]") if isinstance(tree, list) else ("(", ")")
        return o + ",".join(opt_structure(v) for v in tree) + c
    return "*"


_OPT_PREFIX = "torchpruner_tpu_torch.train.optim:"


def _leaf_bytes(leaf):
    """``(dtype name, shape, raw C-order bytes)`` of a tensor or array."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu").contiguous()
        if t.dtype not in _NAMES:
            raise TypeError(f"checkpoints take {sorted(_DTYPES)}, got "
                            f"{t.dtype}")
        raw = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        return _NAMES[t.dtype], list(t.shape), raw.numpy().tobytes()
    a = np.asarray(leaf)
    # NOT ascontiguousarray: it promotes 0-d arrays to shape (1,), and
    # tobytes() already emits C order
    return str(a.dtype), list(a.shape), a.tobytes()


def _write_arrays(path: str, tree: Dict[str, Any]) -> None:
    """Serialize ``{"params": ..., "state": ..., "opt_state": ...}`` as
    ``data.bin`` (concatenated raw leaf buffers) + ``index.json``
    (tree / path / dtype / shape / offset / size per leaf), fsynced."""
    os.makedirs(path, exist_ok=True)
    index = []
    offset = 0

    with open(os.path.join(path, "data.bin"), "wb") as f:

        def emit(tree_name, keypath, leaf):
            nonlocal offset
            dtype, shape, buf = _leaf_bytes(leaf)
            f.write(buf)
            index.append({
                "tree": tree_name, "path": keypath, "dtype": dtype,
                "shape": shape, "offset": offset, "size": len(buf),
            })
            offset += len(buf)

        def walk(tree_name, t, p):
            if isinstance(t, dict):
                for k in sorted(t):
                    walk(tree_name, t[k], p + [k])
            else:
                emit(tree_name, p, t)

        for name in ("params", "state"):
            if name in tree:
                walk(name, tree[name], [])
        if "opt_state" in tree:
            for i, leaf in enumerate(_opt_leaves(tree["opt_state"])):
                emit("opt_state", [str(i)], leaf)
        f.flush()
        os.fsync(f.fileno())

    with open(os.path.join(path, "index.json"), "w") as f:
        # "trees" lists what was SAVED, not just what has leaves: a
        # stateless optimizer has an opt_state with zero leaves, and
        # restore must still rebuild it
        json.dump({"version": 1, "leaves": index,
                   "trees": sorted(tree.keys())}, f)
        f.flush()
        os.fsync(f.fileno())


def _read_arrays(path: str) -> Dict[str, Any]:
    """Inverse of :func:`_write_arrays` as CPU tensors → ``{"params":
    nested dict, "state": nested dict, "opt_state": [leaves...]}`` (keys
    present only when saved)."""
    with open(os.path.join(path, "index.json")) as f:
        index = json.load(f)
    out: Dict[str, Any] = {}
    opt: list = []
    with open(os.path.join(path, "data.bin"), "rb") as f:
        # per-leaf reads into owned, writable buffers
        for e in index["leaves"]:
            if e["dtype"] not in _DTYPES:
                raise CheckpointCorruptError(
                    f"leaf {e['path']} has dtype {e['dtype']!r}, which the "
                    f"port does not read ({sorted(_DTYPES)})")
            dt = _DTYPES[e["dtype"]]
            store = torch.int16 if dt == torch.bfloat16 else dt
            t = torch.empty(int(np.prod(e["shape"], dtype=np.int64)),
                            dtype=store)
            f.seek(e["offset"])
            n = f.readinto(memoryview(t.numpy()).cast("B"))
            if n != e["size"]:
                raise CheckpointCorruptError(
                    f"arrays data.bin truncated: leaf {e['path']} "
                    f"expected {e['size']} bytes, got {n}")
            t = t.view(dt).reshape(e["shape"])
            if e["tree"] == "opt_state":
                opt.append(t)
                continue
            node = out.setdefault(e["tree"], {})
            for k in e["path"][:-1]:
                node = node.setdefault(k, {})
            node[e["path"][-1] if e["path"] else ""] = t
    for name in index.get("trees", []):
        if name == "opt_state":
            out["opt_state"] = opt  # possibly [] — stateless optimizer
        else:
            out.setdefault(name, {})
    return out


def _tree_digest(root: str) -> str:
    """sha256 over every file under ``root`` in sorted relative-path
    order (path bytes included, so a renamed or missing file changes the
    digest as surely as changed contents)."""
    h = hashlib.sha256()
    root = os.path.abspath(root)
    paths = []
    for d, _dirs, files in os.walk(root):
        for fn in files:
            fp = os.path.join(d, fn)
            paths.append((os.path.relpath(fp, root), fp))
    for rel, fp in sorted(paths):
        h.update(rel.encode())
        h.update(b"\0")
        with open(fp, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                h.update(chunk)
        h.update(b"\0")
    return h.hexdigest()


def save_checkpoint(path: str, model: SegmentedModel, params, state=None,
                    opt_state=None, *, step: int = 0,
                    prune_history: Optional[list] = None,
                    extra: Optional[Dict[str, Any]] = None) -> None:
    """Write a checkpoint directory (see the module docstring).  Leaves
    may live on any device; quantized (:class:`QTensor`) params save
    their payload and scale as arrays, the static quantization data in
    ``spec.json``.  Atomic: a crash mid-save leaves the previous complete
    checkpoint, or a digest mismatch :func:`restore_checkpoint` reports
    as :class:`CheckpointCorruptError`."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    params, q_aux = _pack_qtensors(params)
    meta = {
        "spec": spec_to_dict(model),
        "widths": model.widths(),
        "step": step,
        "prune_history": prune_history or [],
        "extra": extra or {},
    }
    if q_aux:
        meta["quantized"] = q_aux
    if opt_state is not None:
        # restore refuses to rebuild under a different optimizer whose
        # state happens to flatten to the same leaves
        meta["opt_treedef"] = _OPT_PREFIX + opt_structure(opt_state)

    tree = {"params": params}
    if state:
        tree["state"] = state
    if opt_state is not None:
        tree["opt_state"] = opt_state

    # 0. sweep TMP litter of earlier crashed saves.  .arrays.old.* stays:
    #    after a mid-swap crash it is the only sealed copy of the
    #    previous checkpoint, and dies only after this save commits
    for entry in os.listdir(path):
        if entry.startswith(".arrays.tmp."):
            shutil.rmtree(os.path.join(path, entry), ignore_errors=True)

    # 1. arrays → temp dir, digest over the real bytes
    tmp_arrays = os.path.join(path, f".arrays.tmp.{os.getpid()}")
    _write_arrays(tmp_arrays, tree)
    meta["digest"] = _tree_digest(tmp_arrays)

    # 2. swap arrays into place; the displaced tree survives until the
    #    new spec.json commits, so a crash here is recoverable
    final_arrays = os.path.join(path, "arrays")
    old_arrays = os.path.join(path, f".arrays.old.{os.getpid()}")
    if os.path.exists(final_arrays):
        os.rename(final_arrays, old_arrays)
    os.rename(tmp_arrays, final_arrays)

    # 3. spec.json last, atomically: its replace is the commit point
    atomic_write_json(os.path.join(path, "spec.json"), meta)
    for entry in os.listdir(path):
        if entry.startswith(".arrays.old."):
            shutil.rmtree(os.path.join(path, entry), ignore_errors=True)


def _to_device(tree, dev):
    if isinstance(tree, QTensor):
        return QTensor(tree.q.to(dev), tree.scale.to(dev), tree.in_axes,
                       tree.bits, tree.pack_axis)
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_to_device(v, dev) for v in tree]
        return out if isinstance(tree, list) else type(tree)(out)
    return tree.to(dev)


def restore_checkpoint(path: str, tx=None, *, device=None):
    """Restore ``(model, params, state, opt_state, meta)`` onto
    ``device`` (``None`` = ``cuda``; raises without a GPU unless
    ``device="cpu"``).

    ``opt_state`` needs ``tx`` to rebuild the optimizer's structure at
    the restored shapes (``tx.init`` on the restored params); the
    recorded ``opt_treedef`` must be this optimizer's, else
    ``ValueError``.  Without ``tx`` a saved ``opt_state`` comes back as its flat
    leaf list.  The digest is verified before anything is read: a
    mismatch raises :class:`CheckpointCorruptError`."""
    dev = resolve_device(device)
    path = os.path.abspath(path)
    spec_path = os.path.join(path, "spec.json")
    if not os.path.exists(spec_path):
        raise CheckpointCorruptError(
            f"checkpoint {path!r} has no spec.json — the directory is "
            "empty, mid-write, or not a checkpoint")
    try:
        with open(spec_path) as f:
            meta = json.load(f)
    except (json.JSONDecodeError, UnicodeDecodeError, OSError) as e:
        raise CheckpointCorruptError(
            f"checkpoint {path!r} spec.json is unreadable/truncated: "
            f"{type(e).__name__}: {e}") from e
    arrays_dir = os.path.join(path, "arrays")
    expected = meta.get("digest")
    actual = _tree_digest(arrays_dir) \
        if expected and os.path.isdir(arrays_dir) else None
    verified = os.path.isdir(arrays_dir) and (not expected
                                              or actual == expected)
    if not verified and expected:
        # crash-window recovery for in-place re-saves: the PREVIOUS tree,
        # which the current spec.json seals, sits at .arrays.old.<pid>
        for entry in sorted(os.listdir(path)):
            if not entry.startswith(".arrays.old."):
                continue
            candidate = os.path.join(path, entry)
            if os.path.isdir(candidate) \
                    and _tree_digest(candidate) == expected:
                shutil.rmtree(arrays_dir, ignore_errors=True)
                os.rename(candidate, arrays_dir)
                verified = True
                break
    if not os.path.isdir(arrays_dir):
        raise CheckpointCorruptError(
            f"checkpoint {path!r} has spec.json but no arrays/ tree — "
            "the save was interrupted before its commit point")
    if expected and not verified:
        raise CheckpointCorruptError(
            f"checkpoint {path!r} failed digest verification: spec.json "
            f"sealed sha256 {expected[:16]}… but the array files hash to "
            f"{(actual or '<missing>')[:16]}… — the bytes on disk were "
            "truncated or corrupted after the save committed")
    model = spec_from_dict(meta["spec"])
    if not os.path.exists(os.path.join(arrays_dir, "index.json")):
        raise CheckpointCorruptError(
            f"checkpoint {path!r} has no arrays/index.json (an orbax-era "
            "checkpoint, which the port does not read)")
    try:
        restored = _read_arrays(arrays_dir)
    except CheckpointCorruptError:
        raise
    except Exception as e:
        raise CheckpointCorruptError(
            f"checkpoint {path!r} arrays failed to deserialize "
            f"({type(e).__name__}: {str(e)[:200]}) — the tree is "
            "incomplete or damaged") from e
    params = restored["params"]
    if meta.get("quantized"):
        params = _unpack_qtensors(params, meta["quantized"])
    params = _to_device(params, dev)
    state = _to_device(restored.get("state", {}), dev)
    opt_state = None
    if tx is not None and "opt_state" in restored:
        template = tx.init(params)
        flat_template = _opt_leaves(template)
        flat_restored = restored["opt_state"]
        saved = meta.get("opt_treedef")
        want = _OPT_PREFIX + opt_structure(template)
        if saved is not None and saved != want:
            raise ValueError(
                "optimizer-state structure mismatch: the checkpoint was "
                f"saved with {saved[:200]}... but tx.init gives "
                f"{want[:200]}... — restoring under a different optimizer "
                "would silently cross-wire its slots")
        if len(flat_template) != len(flat_restored):
            raise ValueError(
                "optimizer-state layout mismatch: checkpoint has "
                f"{len(flat_restored)} leaves, tx.init gives "
                f"{len(flat_template)}")
        for t, r in zip(flat_template, flat_restored):
            if tuple(t.shape) != tuple(r.shape):
                raise ValueError(
                    f"optimizer-state shape mismatch: {tuple(r.shape)} vs "
                    f"expected {tuple(t.shape)}")
        opt_state = _opt_fill(template, [
            r.to(device=t.device, dtype=t.dtype)
            for t, r in zip(flat_template, flat_restored)])
    elif "opt_state" in restored:
        opt_state = _to_device(restored["opt_state"], dev)
    return model, params, state, opt_state, meta
