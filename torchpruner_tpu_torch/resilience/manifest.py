"""Run manifests: the durable record of *pipeline position* — the port
of ``torchpruner_tpu/resilience/manifest.py``.

A checkpoint (``checkpoint.py``) holds the training *state*: params,
optimizer slots, BatchNorm statistics, the model's widths.  It does not
say where the pipeline was: which prune round, which retrain epoch, how
many batches of the current epoch were consumed, what LR backoff is in
force.  :class:`RunManifest` records exactly that, as a small JSON file
written atomically (tmp + fsync + ``os.replace``) beside the checkpoints
it points at, so a preempted or killed run re-enters the prune loop,
training or the robustness sweep mid-round instead of from scratch.

The JSON schema and field names are the JAX package's, so either package
reads a ``manifest.json`` the other wrote (resuming a run directory of
the other package is refused by ``resilience/runner.py``: its rng and
optimizer state do not cross).

Commit protocol (``resilience/runner.py``): write the new checkpoint
directory first, then atomically replace ``manifest.json`` to point at
it.  A crash at any instant leaves the manifest referencing a complete,
digest-verified checkpoint; a half-written one is garbage-collected by a
later commit.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import tempfile
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

MANIFEST_NAME = "manifest.json"
MANIFEST_VERSION = 1


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


def read_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


@dataclass
class RunManifest:
    """Pipeline position for one resumable run directory.

    ``kind`` names the experiment that owns the run ("train",
    "prune_retrain", "robustness"); resuming it as another kind is
    refused, since their ``stage`` payloads are not interchangeable.
    ``checkpoint`` is the run-dir-relative name of the last committed
    checkpoint directory ("" before the first commit).  ``stage`` is the
    experiment's own mid-round position (retrain epoch, partial-epoch
    losses, pre-prune evaluation, ...), opaque to this module.
    """

    kind: str = "train"
    experiment: str = "experiment"
    version: int = MANIFEST_VERSION
    #: run-dir-relative directory name of the last committed checkpoint
    checkpoint: str = ""
    #: global optimizer-step count at the last commit
    step: int = 0
    #: epoch (train) / round index (prune_retrain) at the last commit
    epoch: int = 0
    #: batches of the current epoch consumed at the last commit — the
    #: cursor a resume fast-forwards the deterministic shuffle past
    batch_cursor: int = 0
    #: completed unit-of-work names (prune targets / sweep layers)
    completed: List[str] = field(default_factory=list)
    #: per-round records (PruneStepRecord dicts / epoch rows), so a
    #: resumed run returns the whole history, not just its own tail
    records: List[Dict[str, Any]] = field(default_factory=list)
    #: LR backoff multiplier in force (each rollback multiplies it by
    #: ``lr_backoff``)
    lr_scale: float = 1.0
    #: accum_steps after OOM degradation (0 = the config's)
    accum_steps: int = 0
    #: monotone commit counter (names checkpoint directories uniquely
    #: even when two commits land at the same optimizer step)
    commits: int = 0
    #: how many times this run has been resumed
    resumes: int = 0
    #: how many rollback-to-checkpoint recoveries have fired
    rollbacks: int = 0
    #: "running" | "preempted" | "done"
    status: str = "running"
    #: experiment-specific mid-round position (opaque here)
    stage: Dict[str, Any] = field(default_factory=dict)

    @staticmethod
    def path_in(run_dir: str) -> str:
        return os.path.join(os.path.abspath(run_dir), MANIFEST_NAME)

    @classmethod
    def exists_in(cls, run_dir: str) -> bool:
        return os.path.exists(cls.path_in(run_dir))

    @classmethod
    def load(cls, run_dir: str) -> "RunManifest":
        raw = read_json(cls.path_in(run_dir))
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in raw.items() if k in known})

    @classmethod
    def load_or_new(cls, run_dir: str, *, kind: str,
                    experiment: str) -> "RunManifest":
        """An existing manifest is loaded (and must have been written by
        the same ``kind`` of experiment); otherwise a fresh one is made in
        memory (written at the first commit)."""
        if cls.exists_in(run_dir):
            m = cls.load(run_dir)
            if m.kind != kind:
                raise ValueError(
                    f"run dir {run_dir!r} holds a {m.kind!r} manifest — "
                    f"refusing to resume it as a {kind!r} run (their "
                    "stage payloads are not interchangeable; use a fresh "
                    "directory)")
            return m
        return cls(kind=kind, experiment=experiment)

    def save(self, run_dir: str) -> None:
        atomic_write_json(self.path_in(run_dir), dataclasses.asdict(self))

    def gc_checkpoints(self, run_dir: str, keep: int = 2) -> None:
        """Delete ``ckpt-*`` directories not among the ``keep`` most
        recently committed (the manifest's current pointer is always
        kept).  A half-written checkpoint from a crash is itself a
        ``ckpt-*`` directory, so it ages out here too.  Best effort: a
        failed GC never fails a commit."""
        try:
            entries = sorted(
                (e for e in os.listdir(run_dir) if e.startswith("ckpt-")),
                key=lambda e: os.path.getmtime(os.path.join(run_dir, e)))
        except OSError:
            return
        survivors = set(entries[-keep:]) | {self.checkpoint}
        for e in entries:
            if e not in survivors:
                shutil.rmtree(os.path.join(run_dir, e), ignore_errors=True)
