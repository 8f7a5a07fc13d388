"""Static checks of the port: twin of the parts of ``repro/analysis/`` the
ported slices use, the :class:`Finding` record, ``shard_lint.lint_traffic``
(the traffic-matrix lint ``map_pages`` and the placement session run) and
``shard_lint.lint_spec_tree``. The reference's Pallas kernel verifier has
no counterpart yet (ROADMAP Queue 1, item 2)."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

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
