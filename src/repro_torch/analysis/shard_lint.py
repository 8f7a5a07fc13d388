"""Traffic-matrix lint: twin of ``lint_traffic`` in
``repro/analysis/shard_lint.py`` (host numpy; the spec-tree and jaxpr lints
there have no counterpart on one card).

:func:`lint_traffic` checks one measured ``[D, D]`` pair-traffic matrix:
square, finite, non-negative, zero diagonal, symmetric. The mapping search
and the page mapper treat traffic as an undirected edge weighting; an
asymmetric or negative matrix means the traffic was mis-attributed.
"""
from __future__ import annotations

from typing import Any, List

import numpy as np

from repro_torch.analysis import Finding


def lint_traffic(traffic: Any, *, subject: str = "",
                 rtol: float = 1e-5) -> List[Finding]:
    """Sanity of one measured device-pair traffic matrix (see module
    docstring); all violations are errors — the mapping search's scoring
    is meaningless on a malformed matrix."""
    out: List[Finding] = []
    if traffic is None:
        return [Finding("traffic-missing", "warning", subject,
                        "no traffic matrix recorded for this cell")]
    t = np.asarray(traffic, dtype=np.float64)
    if t.ndim != 2 or t.shape[0] != t.shape[1]:
        return [Finding("traffic-shape", "error", subject,
                        f"traffic matrix must be square 2-d, got "
                        f"{list(t.shape)}", {"shape": list(t.shape)})]
    if not np.all(np.isfinite(t)):
        out.append(Finding("traffic-finite", "error", subject,
                           "traffic matrix contains NaN/inf"))
        return out
    scale = max(float(np.abs(t).max()), 1.0)
    if float(t.min()) < -rtol * scale:
        out.append(Finding(
            "traffic-negative", "error", subject,
            f"negative device-pair bytes (min {float(t.min()):.3e}) — "
            "the collective parser mis-attributed traffic",
            {"min": float(t.min())}))
    diag = float(np.abs(np.diag(t)).max()) if t.shape[0] else 0.0
    if diag > rtol * scale:
        out.append(Finding(
            "traffic-diagonal", "error", subject,
            f"nonzero self-traffic on the diagonal (max {diag:.3e}) — "
            "a device never pays link bytes to itself",
            {"max_diag": diag}))
    asym = float(np.abs(t - t.T).max())
    if asym > rtol * scale:
        out.append(Finding(
            "traffic-asymmetric", "error", subject,
            f"asymmetric traffic (max |T - T^T| = {asym:.3e}) — the "
            "mapping search scores undirected pair weights",
            {"max_asym": asym}))
    return out
