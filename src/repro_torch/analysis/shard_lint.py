"""Sharding, upcast and traffic lint: twin of
``repro/analysis/shard_lint.py`` (host numpy).

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

:func:`lint_ops` is the twin of ``lint_jaxpr``: there is no jaxpr, so it
reads the bf16 -> float32 conversions (``_to_copy`` / ``to`` /
``.float()``, and a ``copy_`` of bf16 into float32) that the op-cost
recorder (``launch/op_cost.py``) saw a traced step run, by shape: each
shape of at least ``UPCAST_WARN_ELEMENTS`` elements is one warning, and
all of them one info. The port's layers are unrolled, so a layer's
upcast counts once a layer, as a scan body's does once a trip in the
reference. :func:`lint_cell` lints one cell: the spec trees of its
arguments, then the upcasts of its step traced on a one-device fake world
(the reference traces a jaxpr on a unit mesh).
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.analysis import Finding

REPLICATED_ERROR_BYTES = 2**28        # 256 MiB fully replicated -> error
REPLICATED_WARN_BYTES = 2**24         # 16 MiB -> warning
UPCAST_WARN_ELEMENTS = 1 << 22        # bf16 -> f32 upcasts worth a warning


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
        nbytes = (int(np.prod(shape, dtype=np.int64)) * x.element_size()
                  if isinstance(x, torch.Tensor) else 0)  # a Python scalar
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


def lint_ops(upcasts: Any, *, subject: str = "",
             upcast_warn_elements: int = UPCAST_WARN_ELEMENTS,
             ) -> List[Finding]:
    """The bf16 -> float32 upcasts of a traced step: ``upcasts`` is an
    ``OpCostRecorder`` (its ``upcasts``), its ``{shape: count}`` dict, or
    the record's ``[[shape, count], ...]`` list. Each shape of at least
    ``upcast_warn_elements`` elements is one warning, largest first, plus
    one info over all sites."""
    if hasattr(upcasts, "upcasts"):
        upcasts = upcasts.upcasts
    items: Iterable = (upcasts.items() if isinstance(upcasts, dict)
                       else upcasts)
    sites: Dict[Tuple[int, ...], int] = {}
    for shape, count in items:
        shape = tuple(int(d) for d in shape)
        sites[shape] = sites.get(shape, 0) + int(count)
    out: List[Finding] = []
    total_elems = 0
    n_sites = 0
    for shape, count in sorted(sites.items(),
                               key=lambda kv: -int(np.prod(kv[0]))):
        elems = int(np.prod(shape, dtype=np.int64))
        total_elems += elems * count
        n_sites += count
        if elems >= upcast_warn_elements:
            out.append(Finding(
                "bf16-upcast", "warning", subject,
                f"bf16 -> f32 upcast of {list(shape)} ({elems} elements) "
                f"at {count} site(s) — 2x the HBM traffic the bf16 path "
                "budgets",
                {"shape": list(shape), "elements": elems,
                 "sites": count}))
    if n_sites:
        out.append(Finding(
            "bf16-upcast", "info", subject,
            f"{n_sites} bf16 -> f32 upcast site(s), "
            f"{total_elems} elements total",
            {"sites": n_sites, "elements": total_elems}))
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


# (arch, shape, overrides) -> the upcasts of its step traced on one device
_ONE_DEVICE_UPCASTS: Dict[Tuple[str, str, str], Dict] = {}


def lint_cell(arch_name: str, shape_name: Optional[str] = None, *,
              profile: str = "2d",
              mesh_axes: Sequence[str] = ("pod", "data", "model"),
              trace: bool = True,
              overrides: Optional[dict] = None) -> List[Finding]:
    """Spec-tree and upcast lint of one (arch, shape, profile) cell, with
    nothing allocated: the specs of the cell's meta arguments against
    ``mesh_axes`` (default the multi-pod production axes), then, with
    ``trace``, its step run once on meta DTensors over a one-device fake
    world whose mesh has those axes at size 1 (``launch/placement``'s
    trace), under the op-cost recorder, for :func:`lint_ops`. On one
    device the arguments are plain tensors and the rules place nothing, so
    the step's ops do not depend on the profile: a process traces each
    (arch, shape, overrides) once and lints its other profiles' steps from
    that trace. ``shape_name=None`` picks the arch's first non-skip
    shape."""
    from repro_torch import configs
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import placement
    from repro_torch.launch.steps import build_cell, rules_for

    arch = configs.get(arch_name)
    if shape_name is None:
        shape_name = next(s.name for s in arch.shapes.values()
                          if s.kind != "skip")
    shape = arch.shapes[shape_name]
    subject = f"{arch_name}/{shape_name}/{profile}"
    if shape.kind == "skip":
        return [Finding("cell-skip", "info", subject,
                        f"shape is skipped: {shape.skip_reason}")]
    axes = tuple(mesh_axes)
    rules = rules_for(arch.family, axes, profile=profile)
    key = (arch_name, shape_name, repr(sorted((overrides or {}).items())))
    out: List[Finding] = []
    with mesh_lib.fake_world(1):
        cell = build_cell(arch, shape, rules, overrides=overrides)
        for i, (x, spec) in enumerate(zip(cell["args"],
                                          cell["args_specs"])):
            out.extend(lint_spec_tree(x, spec, axes,
                                      subject=f"{subject}:arg{i}"))
        if trace and key not in _ONE_DEVICE_UPCASTS:
            mesh = mesh_lib.make_mapped_mesh((1,) * len(axes), axes)
            args = tuple(placement.meta_dtensors(a, s, mesh) for a, s in
                         zip(cell["args"], cell["args_specs"]))
            del cell["args"]
            _, _, cost = placement.trace_step(cell["step"], args, mesh)
            _ONE_DEVICE_UPCASTS[key] = dict(cost.upcasts)
    if trace:
        out.extend(lint_ops(_ONE_DEVICE_UPCASTS[key], subject=subject))
    return out
