"""Sharding and traffic lint: twin of ``lint_spec_tree`` and
``lint_traffic`` in ``repro/analysis/shard_lint.py`` (host numpy; the
jaxpr lint and ``lint_cell`` there wait for the dry-run's slice).

:func:`lint_spec_tree` walks a (tensor tree, spec tree) pair the way
``dist.sharding.sanitize_tree`` does and flags ``unknown-mesh-axis``
(error: a spec names an axis the mesh does not have, the static twin of
``sanitize_spec(strict=True)``), ``duplicate-mesh-axis`` (error: one spec
claims a mesh axis twice) and ``replicated-param`` (a large tensor left
fully replicated: error at ``replicated_error_bytes``, warning at
``replicated_warn_bytes``).

:func:`lint_traffic` checks one measured ``[D, D]`` pair-traffic matrix:
square, finite, non-negative, zero diagonal, symmetric. The mapping search
and the page mapper treat traffic as an undirected edge weighting; an
asymmetric or negative matrix means the traffic was mis-attributed.
"""
from __future__ import annotations

from typing import Any, List, Sequence, Tuple

import numpy as np

from repro_torch.analysis import Finding

REPLICATED_ERROR_BYTES = 2**28        # 256 MiB fully replicated -> error
REPLICATED_WARN_BYTES = 2**24         # 16 MiB -> warning


def _spec_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    if isinstance(entry, (tuple, list)):
        return tuple(entry)
    return (entry,)


def _leaf_name(path) -> str:
    """A tree path as ``jax.tree_util.keystr`` writes it: ``['a'][0]``."""
    return "".join(f"[{k!r}]" for k in path)


def lint_spec_tree(tree: Any, spec_tree: Any, mesh_axes: Sequence[str], *,
                   subject: str = "",
                   replicated_error_bytes: int = REPLICATED_ERROR_BYTES,
                   replicated_warn_bytes: int = REPLICATED_WARN_BYTES,
                   ) -> List[Finding]:
    """Lint one argument's spec tree against the mesh axis names (see the
    module docstring). ``tree`` holds tensors (meta ones do: only shapes
    and dtypes are read); ``spec_tree`` mirrors it with specs or ``None``
    (replicated), as ``sanitize_tree`` takes them."""
    from repro_torch import tree as tree_lib
    from repro_torch.dist.sharding import spec_leaves
    axes = set(mesh_axes)
    paths = [p for p, _ in tree_lib.flatten(tree)]
    out: List[Finding] = []
    for path, (x, spec) in zip(paths, spec_leaves(tree, spec_tree)):
        name = f"{subject}:{_leaf_name(path)}"
        shape = tuple(getattr(x, "shape", ()))
        nbytes = int(np.prod(shape, dtype=np.int64)) * x.element_size()
        entries = () if spec is None else tuple(spec)
        claimed: set = set()
        used_any = False
        for dim, entry in enumerate(entries):
            for ax in _spec_axes(entry):
                if ax not in axes:
                    out.append(Finding(
                        "unknown-mesh-axis", "error", name,
                        f"dim {dim} names mesh axis {ax!r} but the mesh "
                        f"only has {sorted(axes)} — the spec would "
                        "silently drop it at sanitize time",
                        {"dim": dim, "axis": ax,
                         "mesh_axes": sorted(axes)}))
                    continue
                if ax in claimed:
                    out.append(Finding(
                        "duplicate-mesh-axis", "error", name,
                        f"mesh axis {ax!r} appears twice in spec "
                        f"{entries!r} — GSPMD rejects double-claimed "
                        "axes at compile time",
                        {"axis": ax}))
                claimed.add(ax)
                used_any = True
        if not used_any and nbytes >= replicated_warn_bytes:
            sev = ("error" if nbytes >= replicated_error_bytes
                   else "warning")
            out.append(Finding(
                "replicated-param", sev, name,
                f"{nbytes / 2**20:.0f} MiB tensor {shape} is fully "
                "replicated — every device holds a full copy",
                {"bytes": nbytes, "shape": list(shape)}))
    return out


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
