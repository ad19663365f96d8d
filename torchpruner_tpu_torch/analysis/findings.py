"""Finding records and the severity configuration for the static analyzer.
(A copy of ``torchpruner_tpu/analysis/findings.py``, imports renamed.)

A finding is one diagnosed hazard: which pass produced it, a stable check
id (``"plan/missing-path"`` style), the pytree/layer path it anchors to,
and a human message.  Severities are ``"error"`` (the run WILL fail or
silently corrupt — lint exits nonzero), ``"warning"`` (the run degrades —
silent replication, a blocking call under a hot lock), and ``"info"``
(measurements worth seeing, e.g. per-chip HBM deltas).

:class:`SeverityConfig` lets deployments re-grade individual checks —
e.g. a single-host run that *wants* replicated small models downgrades
``sharding/replicated-fallback`` to ``"ignore"``.  The module-level
:data:`severity_config` is what integration points (``shard_params``'s
one-line warning, ``apply_plan``'s pre-flight) consult, so one knob
controls both the batch analyzer and the inline checks.

This module is dependency-free (stdlib only) on purpose: integration
points deep in ``core``/``parallel`` import it lazily without pulling the
analysis passes (and their model building) into their import graph.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Sequence, Tuple

#: severity order, most severe first; "ignore" suppresses a finding.
SEVERITIES = ("error", "warning", "info", "ignore")


@dataclass(frozen=True)
class Finding:
    """One diagnosed hazard.

    ``lint`` names the pass (``"plan"`` | ``"sharding"`` | ``"host"``;
    the JAX package's ``"jaxpr"`` / ``"collective"`` / ``"cost"`` /
    ``"planner"`` passes read XLA programs the port does not build),
    ``check`` is the stable id severity overrides key on, ``path`` the
    tree path / layer path / ``file:line`` source site the finding
    anchors to.
    """

    severity: str
    lint: str
    check: str
    path: str
    message: str

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(
                f"unknown severity {self.severity!r} (use one of {SEVERITIES})"
            )

    def format(self) -> str:
        return (
            f"{self.severity.upper():7s} {self.check:30s} "
            f"{self.path}: {self.message}"
        )


@dataclass
class SeverityConfig:
    """Per-check severity overrides: ``{check_id: severity}``.

    ``"ignore"`` drops the finding entirely.  Unlisted checks keep the
    severity the pass assigned.
    """

    overrides: Dict[str, str] = field(default_factory=dict)

    def severity_for(self, check: str, default: str) -> str:
        sev = self.overrides.get(check, default)
        if sev not in SEVERITIES:
            raise ValueError(
                f"unknown severity {sev!r} for check {check!r} "
                f"(use one of {SEVERITIES})"
            )
        return sev

    def apply(self, findings: Iterable[Finding]) -> Tuple[Finding, ...]:
        out = []
        for f in findings:
            sev = self.severity_for(f.check, f.severity)
            if sev == "ignore":
                continue
            out.append(
                f if sev == f.severity
                else dataclasses.replace(f, severity=sev)
            )
        return tuple(out)


#: The active severity configuration.  Mutate ``severity_config.overrides``
#: (or swap the object) to re-grade checks process-wide — both the batch
#: analyzer (:func:`torchpruner_tpu_torch.analysis.runner.lint_config`) and the
#: inline integration points (``shard_params``, ``apply_plan``) read it.
severity_config = SeverityConfig()


def active_severity(check: str, default: str) -> str:
    """The effective severity of ``check`` under the active config."""
    return severity_config.severity_for(check, default)


@dataclass(frozen=True)
class LintReport:
    """The findings of one analyzer run, plus formatting helpers."""

    name: str
    findings: Tuple[Finding, ...]

    @property
    def errors(self) -> Tuple[Finding, ...]:
        return tuple(f for f in self.findings if f.severity == "error")

    @property
    def warnings(self) -> Tuple[Finding, ...]:
        return tuple(f for f in self.findings if f.severity == "warning")

    @property
    def ok(self) -> bool:
        return not self.errors

    def format(self) -> str:
        head = (
            f"lint: {self.name} — {len(self.errors)} error(s), "
            f"{len(self.warnings)} warning(s), "
            f"{len(self.findings) - len(self.errors) - len(self.warnings)} "
            f"info"
        )
        order = {s: i for i, s in enumerate(SEVERITIES)}
        body = [
            "  " + f.format()
            for f in sorted(self.findings, key=lambda f: order[f.severity])
        ]
        return "\n".join([head] + body)


def merge_reports(name: str, *parts: Sequence[Finding]) -> LintReport:
    """One report out of several passes' findings, with the active
    severity overrides applied."""
    merged: List[Finding] = []
    for p in parts:
        merged.extend(p)
    return LintReport(name, severity_config.apply(merged))
