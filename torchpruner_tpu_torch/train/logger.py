"""Structured experiment logging — a host copy of
``torchpruner_tpu/train/logger.py``: one CSV row per prune step with
pre/post-prune metrics, parameter count, FLOPs, layer widths and prune
time, mirrored to JSONL.  The ``span_id`` column holds the obs span
active when the row was written (``obs.current_span_id``; empty when
telemetry is off), joining the rows to the ``events.jsonl`` phase
stream.
"""

from __future__ import annotations

import csv
import json
import logging
import os
import time
from dataclasses import dataclass
from typing import Optional

log = logging.getLogger("torchpruner_tpu_torch")


CSV_FIELDS = [
    "timestamp",
    "experiment",
    "step",
    "layer",
    "method",
    "test_loss",
    "test_acc",
    "test_loss_pp",   # post-prune ("pp" naming from reference utils.py:58-62)
    "test_acc_pp",
    "n_params",
    "flops",
    "widths",
    "prune_time",
    "prune_ratio",
    "train_loss",     # from-scratch training rows only (run_train)
    "span_id",        # obs span active when the row was written ("" when
                      # telemetry is off) — joins rows with the events.jsonl
                      # phase stream (obs.current_span_id)
]


@dataclass
class CSVLogger:
    """Append one row per prune step to ``path`` (+ ``path.jsonl``).

    - Appending to an EXISTING csv resumes: ``_step`` continues from the
      last row's step id and the file's own header order is honored (a
      pre-``span_id`` file keeps its narrower schema).
    - File handles are opened once and held (flushed per row), not
      reopened per write; the ``.jsonl`` mirror writes keys in the CSV
      header order so both artifacts agree column-for-column.
    """

    path: str
    experiment: str = "experiment"
    _step: int = 0

    def __post_init__(self):
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        self._fields = list(CSV_FIELDS)
        header_needed = True
        if os.path.exists(self.path) and os.path.getsize(self.path):
            with open(self.path, newline="") as f:
                reader = csv.reader(f)
                header = next(reader, None)
                if header:
                    self._fields = header
                    header_needed = False
                last = None
                for last in reader:
                    pass
            if last is not None and "step" in self._fields:
                try:
                    self._step = int(last[self._fields.index("step")]) + 1
                except (ValueError, IndexError):
                    pass
        self._csv_f = open(self.path, "a", newline="")
        self._writer = csv.DictWriter(self._csv_f, self._fields,
                                      extrasaction="ignore")
        if header_needed:
            self._writer.writeheader()
        self._jsonl_f = open(self.path + ".jsonl", "a")

    def close(self):
        for f in (getattr(self, "_csv_f", None),
                  getattr(self, "_jsonl_f", None)):
            if f is not None and not f.closed:
                f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def log_prune_step(
        self,
        *,
        layer: str,
        method: str,
        test_loss: float,
        test_acc: float,
        test_loss_pp: float,
        test_acc_pp: float,
        n_params: int,
        flops: Optional[float] = None,
        widths: Optional[dict] = None,
        prune_time: float = 0.0,
        prune_ratio: Optional[float] = None,
    ):
        row = {
            "timestamp": time.strftime("%Y-%m-%d %H:%M:%S"),
            "experiment": self.experiment,
            "step": self._step,
            "layer": layer,
            "method": method,
            "test_loss": f"{test_loss:.6f}",
            "test_acc": f"{test_acc:.6f}",
            "test_loss_pp": f"{test_loss_pp:.6f}",
            "test_acc_pp": f"{test_acc_pp:.6f}",
            "n_params": n_params,
            "flops": flops if flops is not None else "",
            "widths": "-".join(str(v) for v in (widths or {}).values()),
            "prune_time": f"{prune_time:.3f}",
            "prune_ratio": prune_ratio if prune_ratio is not None else "",
        }
        self._write(row)
        log.info(
            "prune step %d [%s/%s]: loss %.4f→%.4f acc %.4f→%.4f params %d",
            self._step, layer, method, test_loss, test_loss_pp,
            test_acc, test_acc_pp, n_params,
        )
        self._step += 1

    def log_epoch(
        self,
        *,
        epoch: int,
        train_loss: float,
        test_loss: float,
        test_acc: float,
        seconds: float = 0.0,
    ):
        """One from-scratch training epoch (run_train): test metrics land in
        their real columns, the training loss in its own."""
        row = {
            "timestamp": time.strftime("%Y-%m-%d %H:%M:%S"),
            "experiment": self.experiment,
            "step": self._step,
            "layer": f"epoch{epoch}",
            "method": "train",
            "test_loss": f"{test_loss:.6f}",
            "test_acc": f"{test_acc:.6f}",
            "test_loss_pp": "",
            "test_acc_pp": "",
            "n_params": "",
            "flops": "",
            "widths": "",
            "prune_time": f"{seconds:.3f}",
            "prune_ratio": "",
            "train_loss": f"{train_loss:.6f}",
        }
        self._write(row)
        log.info(
            "epoch %d: train %.4f test %.4f acc %.4f",
            epoch, train_loss, test_loss, test_acc,
        )
        self._step += 1

    def _write(self, row: dict):
        from torchpruner_tpu_torch import obs

        row.setdefault("span_id", obs.current_span_id() or "")
        self._writer.writerow(row)
        self._csv_f.flush()
        # mirror in the CSV's own column order — consumers diffing the two
        # artifacts see identical key sequences row for row
        ordered = {k: row.get(k, "") for k in self._fields}
        self._jsonl_f.write(json.dumps(ordered) + "\n")
        self._jsonl_f.flush()
