"""Static checks of the port: twin of ``repro/analysis/``.

  * ``analysis.kernels`` — verifies every registered CUDA launch plan
    (``repro_torch.kernels.KERNEL_REGISTRY``): grid and block limits, read
    and write tiles in bounds, output coverage, write races, shared memory,
    cooperative co-residency, TMA descriptors, 16-byte vector alignment.
  * ``analysis.shard_lint`` — ``lint_traffic`` (the traffic matrices
    ``map_pages`` and the placement session produce), ``lint_spec_tree``,
    ``lint_ops`` (the bf16 -> float32 upcasts of a traced step) and
    ``lint_cell``.

Entry points: ``python -m repro_torch.analysis`` (the CLI and its JSON
findings), ``PlacementSession.verify()``, and ``--lint`` on the dry-run and
train launchers. Every check emits :class:`Finding` records with a
severity from :data:`SEVERITIES`, with the helpers (:func:`severity_rank`,
:func:`max_severity`, :func:`at_least`, :func:`counts`, :func:`to_json`,
:func:`format_findings`) giving the same strings and JSON as the
reference's."""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional, Sequence

SEVERITIES = ("info", "warning", "error")


@dataclasses.dataclass
class Finding:
    """One static-analysis result.

    ``check`` is the stable machine-readable check id
    ("traffic-asymmetric", ...), ``subject`` the thing checked
    ("page-traffic"), ``message`` the human line, ``detail`` JSON-native
    context.
    """
    check: str
    severity: str
    subject: str
    message: str
    detail: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(f"unknown severity {self.severity!r}; "
                             f"known: {SEVERITIES}")

    def format(self) -> str:
        return (f"[{self.severity.upper():<7}] {self.check:<20} "
                f"{self.subject}: {self.message}")


def severity_rank(severity: str) -> int:
    return SEVERITIES.index(severity)


def max_severity(findings: Sequence[Finding]) -> Optional[str]:
    """Highest severity present, or None for an empty list."""
    if not findings:
        return None
    return max((f.severity for f in findings), key=severity_rank)


def at_least(findings: Sequence[Finding], severity: str) -> List[Finding]:
    """Findings at or above ``severity``."""
    rank = severity_rank(severity)
    return [f for f in findings if severity_rank(f.severity) >= rank]


def counts(findings: Sequence[Finding]) -> Dict[str, int]:
    return {s: sum(1 for f in findings if f.severity == s)
            for s in SEVERITIES}


def to_json(findings: Sequence[Finding], *,
            gate_severity: str = "error") -> str:
    """Structured findings document: every finding plus per-severity
    counts and whether the gate at ``gate_severity`` fails."""
    return json.dumps({
        "findings": [dataclasses.asdict(f) for f in findings],
        "counts": counts(findings),
        "gate": {"severity": gate_severity,
                 "failed": bool(at_least(findings, gate_severity))},
    }, indent=1, default=str)


def format_findings(findings: Sequence[Finding]) -> str:
    """Human-readable report, most severe first."""
    if not findings:
        return "[ANALYSIS] clean: no findings"
    ordered = sorted(findings, key=lambda f: -severity_rank(f.severity))
    lines = [f.format() for f in ordered]
    c = counts(findings)
    lines.append(f"[ANALYSIS] {c['error']} error(s), "
                 f"{c['warning']} warning(s), {c['info']} info")
    return "\n".join(lines)
