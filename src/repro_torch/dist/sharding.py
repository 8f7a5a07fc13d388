"""Named-axis sharding rules: twin of ``repro/dist/sharding.py``.

One table per model family maps *logical* tensor axes ("batch", "fsdp",
"rows", ...) onto *mesh* axes ("pod", "data", "model"). Models annotate
with logical names only (``rules.spec("fsdp", "model")``,
``rules.shard(x, "batch", "seq", None)``); the table, not the model,
decides the layout.

Resolution semantics (the reference's "lookup precedence" contract):

  * ``None`` always means replicated and never consults the table.
  * A logical name resolves to the rule's mesh axes filtered to the axes
    the mesh has (``lm_rules(())`` replicates everything).
  * Within one spec a mesh axis appears at most once: the first logical
    axis to claim it wins, later claims resolve to ``None``.
  * An unknown logical name raises ``KeyError``.

A spec is a :class:`Spec`, a tuple with one entry per tensor dim: ``None``,
a mesh axis name, or a tuple of names (the reference's ``PartitionSpec``).
:func:`placements` turns an entry list into DTensor placements on a
``DeviceMesh``: ``Shard(d)`` on each mesh dim that dim ``d`` names,
``Replicate()`` on the others. A dim named over two mesh axes nests as
JAX nests it, the first-named axis outermost; DTensor nests its shards in
mesh-dim order, so such an entry must name its axes in the mesh's order
(every table here does) and :func:`placements` raises otherwise.

:meth:`Rules.shard` is ``with_sharding_constraint``'s twin: on a DTensor
it redistributes to the sanitized spec; on a plain tensor it returns the
tensor itself, so the single-device paths are untouched.
"""
from __future__ import annotations

import math
import warnings
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

AxisEntry = Tuple[str, ...]


class Spec(tuple):
    """One entry per tensor dim: ``None`` (replicated), a mesh axis name or
    a tuple of names. A tuple subclass, so ``Spec(...) == (...)``; spec
    trees treat it as a leaf (:func:`spec_leaves`)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


class Rules:
    """Logical-axis -> mesh-axes rule table (see module docstring)."""

    def __init__(self, table: Dict[str, Sequence[str]],
                 mesh_axes: Sequence[str]):
        self.mesh_axes: Tuple[str, ...] = tuple(mesh_axes)
        self.table: Dict[str, AxisEntry] = {
            name: tuple(a for a in axes if a in self.mesh_axes)
            for name, axes in table.items()}

    def _resolve(self, name: Optional[str], claimed: set):
        if name is None:
            return None
        if name not in self.table:
            raise KeyError(f"unknown logical axis {name!r}; rules know "
                           f"{sorted(self.table)}")
        axes = tuple(a for a in self.table[name] if a not in claimed)
        claimed.update(axes)
        if not axes:
            return None
        return axes[0] if len(axes) == 1 else axes

    def spec(self, *logical: Optional[str]) -> Spec:
        """The spec of a tensor whose dims carry these logical axes."""
        claimed: set = set()
        return Spec(*[self._resolve(name, claimed) for name in logical])

    def shard(self, x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
        """Constrain ``x`` to the spec of ``logical``: a DTensor is
        redistributed to the spec sanitized against its own mesh; a plain
        tensor, a spec that resolves to nothing, or one no surviving axis
        divides, returns ``x`` itself."""
        if not _is_dtensor(x):
            return x
        spec = self.spec(*logical)
        if all(a is None for a in spec):
            return x
        mesh = x.device_mesh
        spec = sanitize_spec(x.shape, spec, mesh)
        if all(a is None for a in spec):
            return x
        want = placements(mesh, spec)
        if tuple(x.placements) == tuple(want):
            return x
        return x.redistribute(mesh, want)


# ---------------------------------------------------------------------------
# Family rule tables
# ---------------------------------------------------------------------------

def _present(mesh_axes: Sequence[str], *wanted: str) -> AxisEntry:
    return tuple(a for a in wanted if a in mesh_axes)


LM_PROFILES = ("2d", "fsdp", "sp", "expert")


def lm_rules(mesh_axes: Sequence[str], profile: str = "2d") -> Rules:
    """LM-family table. Profiles (the reference's ``--profile`` values):

      * ``"2d"``     FSDP x tensor: params ZeRO-shard over "data",
                     head/ffn/vocab/expert dims over "model"; batch over
                     all dp axes.
      * ``"fsdp"``   pure ZeRO: params flat-sharded over ("data",
                     "model"), no tensor parallelism; batch over ("pod",
                     "data").
      * ``"sp"``     "2d" plus sequence parallelism: activation sequence
                     dims (and the decode KV cache) over "model".
      * ``"expert"`` the "expert" dim gets its own mesh axis ("pod" when
                     the mesh has one, else "model"); everything else as
                     "2d". No tensor of a dense arch carries "expert", so
                     there the profile is "2d" exactly.
    """
    dp = _present(mesh_axes, "pod", "data")
    model = _present(mesh_axes, "model")
    if profile == "2d":
        table = {"batch": dp, "seq": (), "fsdp": _present(mesh_axes, "data"),
                 "model": model, "vocab": model, "expert": model,
                 "kv_seq": model}
    elif profile == "fsdp":
        table = {"batch": dp, "seq": (),
                 "fsdp": _present(mesh_axes, "data", "model"),
                 "model": (), "vocab": (), "expert": (), "kv_seq": ()}
    elif profile == "sp":
        table = {"batch": dp, "seq": model,
                 "fsdp": _present(mesh_axes, "data"),
                 "model": model, "vocab": model, "expert": model,
                 "kv_seq": model}
    elif profile == "expert":
        ep = _present(mesh_axes, "pod") or model
        table = {"batch": dp, "seq": (), "fsdp": _present(mesh_axes, "data"),
                 "model": model, "vocab": model, "expert": ep,
                 "kv_seq": model}
    else:
        raise ValueError(f"unknown lm sharding profile {profile!r}; "
                         f"known: {LM_PROFILES}")
    return Rules(table, mesh_axes)


def gnn_rules(mesh_axes: Sequence[str]) -> Rules:
    """GNN-family table: node/arc arrays row-shard over the whole mesh
    (row counts are padded to 512, the multi-pod device count); MLP
    weights are FSDP x tensor like the LMs."""
    return Rules({"rows": tuple(mesh_axes),
                  "batch": _present(mesh_axes, "pod", "data"),
                  "fsdp": _present(mesh_axes, "data"),
                  "model": _present(mesh_axes, "model")}, mesh_axes)


def recsys_rules(mesh_axes: Sequence[str]) -> Rules:
    """Two-tower table: embedding tables and candidate matrices row-shard
    over the whole mesh; towers are FSDP x tensor; batch over dp axes."""
    return Rules({"rows": tuple(mesh_axes),
                  "cand": tuple(mesh_axes),
                  "batch": _present(mesh_axes, "pod", "data"),
                  "fsdp": _present(mesh_axes, "data"),
                  "model": _present(mesh_axes, "model")}, mesh_axes)


# the table a caller without a mesh gets: every name resolves to None
NO_MESH = lm_rules(())


# ---------------------------------------------------------------------------
# Spec sanitation and placements
# ---------------------------------------------------------------------------

def axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or of anything whose
    ``shape`` is such a mapping (the reference's ``dict(mesh.shape)``)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(mesh.shape)


def _entry_axes(entry) -> AxisEntry:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def sanitize_spec(shape: Sequence[int], spec: Sequence, mesh, *,
                  strict: bool = False) -> Spec:
    """Drop mesh axes that do not evenly divide their dimension.

    Per dim: axes the mesh lacks are removed (with a warning; ``strict=True``
    raises ``ValueError``), then the entry keeps the longest prefix of its
    axes whose size product divides the dim. Entries beyond ``len(shape)``
    are dropped; missing trailing entries stay unsharded."""
    sizes = axis_sizes(mesh)
    entries = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, entry in zip(shape, entries):
        if entry is None:
            out.append(None)
            continue
        axes = _entry_axes(entry)
        missing = tuple(a for a in axes if a not in sizes)
        if missing:
            msg = (f"spec entry {entry!r} names mesh axes {missing!r} "
                   f"absent from the mesh (axes: {sorted(sizes)})")
            if strict:
                raise ValueError(msg)
            warnings.warn(msg, stacklevel=2)
        axes = tuple(a for a in axes if a in sizes)
        while axes and dim % math.prod(sizes[a] for a in axes):
            axes = axes[:-1]
        out.append(None if not axes else axes[0] if len(axes) == 1 else axes)
    return Spec(*out)


def spec_leaves(tree: Any, specs: Any) -> List[Tuple[Any, Any]]:
    """``[(leaf, spec)]`` of a tree of tensors (or anything with a
    ``shape``) and its mirror spec tree, in ``repro_torch.tree``'s
    flattening order. A spec leaf (a :class:`Spec` or ``None``) covers a
    whole tensor leaf; ``None`` where the tensor tree has a subtree covers
    every leaf under it (replicated)."""
    from repro_torch import tree as tree_lib
    out: List[Tuple[Any, Any]] = []

    def walk(node, spec):
        kids = tree_lib._children(node)
        if kids is None:
            out.append((node, spec))
            return
        for key, sub in kids:
            if spec is None:
                walk(sub, None)
            elif isinstance(spec, dict):
                walk(sub, spec[key])
            elif isinstance(spec, Spec):
                raise ValueError(f"spec {spec!r} where the tree has a "
                                 f"subtree")
            else:
                walk(sub, spec[key])
    walk(tree, specs)
    return out


def sanitize_tree(tree: Any, specs: Any, mesh, *,
                  strict: bool = False) -> Any:
    """:func:`sanitize_spec` over a tree of tensors and its mirror spec
    tree: a spec tree shaped like ``tree`` (``None`` leaves stay ``None``:
    replicated)."""
    from repro_torch import tree as tree_lib
    return tree_lib.unflatten(tree, [
        None if s is None else sanitize_spec(x.shape, s, mesh, strict=strict)
        for x, s in spec_leaves(tree, specs)])


def placements(mesh, spec: Optional[Sequence]) -> Tuple:
    """The DTensor placements of ``spec`` on ``mesh`` (a ``DeviceMesh``
    with named dims): ``Shard(d)`` on each mesh dim that tensor dim ``d``
    names, ``Replicate()`` on every other and on a mesh dim of size 1 (a
    shard over one device is the whole tensor, and DTensor refuses to
    flatten a dim it calls sharded). A dim named over several mesh axes
    must name them in the mesh's order (outermost first, as JAX nests
    them; see the module docstring)."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    out: List[Any] = [Replicate()] * len(names)
    for d, entry in enumerate(spec or ()):
        axes = _entry_axes(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} names mesh axes out of "
                             f"the mesh's order {names}: DTensor nests "
                             f"shards in mesh-dim order")
        for i in idx:
            if mesh.size(i) > 1:
                out[i] = Shard(d)
    return tuple(out)


def local_shape(shape: Sequence[int], spec: Optional[Sequence],
                mesh) -> Tuple[int, ...]:
    """The shape of one device's shard of a ``shape`` tensor under a
    sanitized ``spec``."""
    sizes = axis_sizes(mesh)
    out = list(shape)
    for d, entry in enumerate(spec or ()):
        out[d] //= math.prod(sizes[a] for a in _entry_axes(entry))
    return tuple(out)



def split_dim(x: torch.Tensor, dim: int, *sizes: int) -> torch.Tensor:
    """``x`` with dim ``dim`` reshaped to ``sizes`` (a heads split).
    DTensor refuses a split that cannot keep its shards whole (12 heads
    over a 16-way ``model`` axis), where GSPMD gathers on its own; a
    DTensor whose ``dim`` is sharded over mesh dims whose size product
    does not divide ``sizes[0]`` is first gathered on those dims, and its
    gradient is merged back with :func:`merge_dims` (autograd's own view
    backward would refuse a gradient sharded on an inner dim). A plain
    tensor is reshaped as it is."""
    dim %= x.dim()
    shape = tuple(x.shape[:dim]) + tuple(sizes) + tuple(x.shape[dim + 1:])
    if not _is_dtensor(x):
        return x.reshape(shape)
    from torch.distributed.tensor import Replicate, Shard
    on = [i for i, p in enumerate(x.placements)
          if isinstance(p, Shard) and p.dim % x.dim() == dim]
    ways = math.prod(x.device_mesh.shape[i] for i in on)
    if on and sizes[0] % ways:
        x = x.redistribute(x.device_mesh, [
            Replicate() if i in on else p for i, p in enumerate(x.placements)])
    if len(sizes) != 2:
        return x.reshape(shape)
    return _SplitDim.apply(x, dim, shape)


class _SplitDim(torch.autograd.Function):
    """A DTensor's dim split in two, whose gradient is merged back with
    :func:`merge_dims`."""

    @staticmethod
    def forward(ctx, x, dim, shape):
        ctx.dim = dim
        return x.reshape(shape)

    @staticmethod
    def backward(ctx, g):
        return merge_dims(g, ctx.dim), None, None


def split_last(x: torch.Tensor, *sizes: int) -> torch.Tensor:
    """``x [..., prod(sizes)]`` reshaped to ``[..., *sizes]``: the heads
    split of an attention projection (:func:`split_dim` on the last dim)."""
    return split_dim(x, -1, *sizes)


def _merged(shape, dim: int):
    return tuple(shape[:dim]) + (-1,) + tuple(shape[dim + 2:])


class _MergeDims(torch.autograd.Function):
    """A DTensor's dims ``dim`` and ``dim + 1`` merged, whose gradient is
    split back with :func:`split_dim` (autograd's own view backward would
    refuse the uneven split)."""

    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim, ctx.sizes = dim, tuple(x.shape[dim:dim + 2])
        return _gather_dims(x, (dim + 1,)).reshape(_merged(x.shape, dim))

    @staticmethod
    def backward(ctx, g):
        return split_dim(g, ctx.dim, *ctx.sizes), None


def merge_dims(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` with dims ``dim`` and ``dim + 1`` merged into one (a heads
    merge, tokens flattened), the inverse of :func:`split_dim`. A DTensor
    sharded on the inner of the two is first gathered there (DTensor
    refuses that flatten; GSPMD gathers on its own); a plain tensor is
    reshaped as it is."""
    dim %= x.dim()
    if not _is_dtensor(x):
        return x.reshape(_merged(x.shape, dim))
    return _MergeDims.apply(x, dim)


def merge_last(x: torch.Tensor) -> torch.Tensor:
    """``x [..., a, b]`` reshaped to ``[..., a·b]`` (the heads merge before
    an attention's output projection), the inverse of :func:`split_last`;
    a plain tensor is reshaped as it is."""
    return merge_dims(x, -2)


def _gather_dims(x: torch.Tensor, dims) -> torch.Tensor:
    """A DTensor replicated on every mesh dim that shards one of its tensor
    dims ``dims``."""
    from torch.distributed.tensor import Replicate, Shard
    on = [isinstance(p, Shard) and p.dim % x.dim() in dims
          for p in x.placements]
    if not any(on):
        return x
    return x.redistribute(x.device_mesh, [
        Replicate() if o else p for o, p in zip(on, x.placements)])


def whole_local(x: torch.Tensor):
    """``(value, wrap)``: ``x``'s whole value as a plain tensor and the way
    back. A DTensor is gathered (and reduced) on every mesh dim, and
    ``wrap(t)`` makes a plain tensor computed from that value a DTensor
    replicated on x's mesh: the twin of GSPMD replicating an operation it
    cannot partition (a sort, a scatter with global indices). A plain
    ``x`` is its own value and ``wrap`` the identity. Both ways are
    differentiable: each device holds the whole gradient of a replicated
    value, so the way back to a shard is a local chunk."""
    if not _is_dtensor(x):
        return x, lambda t: t
    from torch.distributed.tensor import DTensor, Replicate
    mesh = x.device_mesh
    rep = [Replicate()] * mesh.ndim
    return (x.redistribute(mesh, rep).to_local(),
            lambda t: DTensor.from_local(t, mesh, rep, run_check=False))


def placed_like(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``y`` redistributed to the shards of ``x`` (replicated where x is
    partial: y is not a share of a sum) where both are DTensors; otherwise
    ``y`` itself."""
    if not (_is_dtensor(y) and _is_dtensor(x)):
        return y
    from torch.distributed.tensor import Replicate
    want = tuple(Replicate() if p.is_partial() else p for p in x.placements)
    if tuple(y.placements) == want:
        return y
    return y.redistribute(x.device_mesh, want)


class _VocabParallelEmbed(torch.autograd.Function):
    """The embedding lookup of a DTensor table whose vocab dim may be
    sharded: the table gathered on its other dims (the FSDP gather), each
    device looking up the ids that fall in its vocab slice (zeros
    elsewhere), the rows left partial over the vocab dims' mesh dims for
    the next redistribution to sum; the backward adds each row's gradient
    into its device's slice and reduces it to the table's placements. The
    vocab-parallel lookup GSPMD lowers a gather of a vocab-sharded table
    to. With ``weights`` (shaped like the ids) the rows are summed over the
    ids' last dim with those weights (an embedding bag) before they leave
    the device, still partial."""

    @staticmethod
    def forward(ctx, table, ids, weights=None):
        from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
        mesh = table.device_mesh
        vocab = [i for i, p in enumerate(table.placements)
                 if isinstance(p, Shard) and p.dim == 0]
        table_g = table.redistribute(mesh, [
            p if i in vocab else Replicate()
            for i, p in enumerate(table.placements)])
        i_pl = [Replicate() if i in vocab else p
                for i, p in enumerate(ids.placements)]
        ids_r = ids.redistribute(mesh, i_pl)
        t_loc, i_loc = table_g.to_local(), ids_r.to_local()
        rows = t_loc.shape[0]
        coord = mesh.get_coordinate()
        index = 0
        for i in vocab:                        # nested in mesh-dim order
            index = index * mesh.size(i) + coord[i]
        local_ids = (i_loc - index * rows).long()
        hit = (local_ids >= 0) & (local_ids < rows)
        local_ids = local_ids.clamp(0, rows - 1)
        scale = hit.to(t_loc.dtype)
        shape = tuple(ids.shape) + (table.shape[1],)
        if weights is not None:
            scale = scale * _as_dtensor(weights, mesh).redistribute(
                mesh, i_pl).to_local().to(t_loc.dtype)
            shape = shape[:-2] + shape[-1:]
        out = t_loc[local_ids] * scale[..., None]
        if weights is not None:
            out = out.sum(-2)
        out_pl = [Partial() if i in vocab else p for i, p in enumerate(i_pl)]
        ctx.save_for_backward(local_ids, scale)
        ctx.meta = (mesh, vocab, tuple(table.placements), tuple(table.shape),
                    tuple(table.stride()), tuple(i_pl), rows,
                    weights is not None)
        return DTensor.from_local(out, mesh, out_pl, run_check=False,
                                  shape=shape,
                                  stride=_contiguous_stride(shape))

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
        mesh, vocab, t_pl, t_shape, t_stride, i_pl, rows, bag = ctx.meta
        local_ids, scale = ctx.saved_tensors
        g = g.redistribute(mesh, [Replicate() if i in vocab else p
                                  for i, p in enumerate(i_pl)])
        g_loc = g.to_local()
        if bag:
            g_loc = g_loc.unsqueeze(-2)
        d = g_loc.shape[-1]
        grad = g_loc.new_zeros((rows, d)).index_add_(
            0, local_ids.reshape(-1),
            (g_loc * scale[..., None].to(g_loc.dtype)).reshape(-1, d))
        grad_pl = [Shard(0) if i in vocab
                   else Partial() if isinstance(p, Shard) else Replicate()
                   for i, p in enumerate(i_pl)]
        grad = DTensor.from_local(grad, mesh, grad_pl, run_check=False,
                                  shape=t_shape, stride=t_stride)
        return grad.redistribute(mesh, t_pl), None, None


def embed_rows(table: torch.Tensor, ids: torch.Tensor,
               weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``table[ids]``: the embedding lookup, or with ``weights`` (shaped
    like ``ids``) the bag ``sum(weights[..., None] * table[ids], -2)``. A
    DTensor table takes the vocab-parallel lookup (``_VocabParallelEmbed``):
    DTensor's own indexing refuses ids sharded over two mesh dims, and its
    masked vocab-sharded gather cannot run on meta tensors. A plain table
    is indexed as it is."""
    if not _is_dtensor(table):
        rows = table[ids]
        if weights is None:
            return rows
        return (rows * weights[..., None].to(rows.dtype)).sum(-2)
    return _VocabParallelEmbed.apply(table, ids, weights)


def _gather_mid(x: torch.Tensor) -> torch.Tensor:
    """A DTensor with its middle dims (neither the first nor the last)
    gathered: ``@`` and its backward flatten the leading dims, which
    DTensor refuses where a middle dim is sharded."""
    from torch.distributed.tensor import Replicate, Shard
    mid = [isinstance(p, Shard) and 0 < p.dim % x.dim() < x.dim() - 1
           for p in x.placements]
    if not any(mid):
        return x
    return x.redistribute(x.device_mesh, [
        Replicate() if m else p for m, p in zip(mid, x.placements)])


class _Dense(torch.autograd.Function):
    """``x @ w`` of DTensors whose backward gathers the incoming gradient's
    middle dims before its products (see :func:`dense`)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return x @ w

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = _gather_mid(g)
        gw = (x.reshape(-1, x.shape[-1]).transpose(0, 1)
              @ g.reshape(-1, g.shape[-1]))
        return g @ w.transpose(0, 1), gw


def dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for activations ``x [..., D]`` and a weight ``w [D, F]``.
    ``@`` and its backward flatten x's leading dims, which DTensor refuses
    where a middle dim is sharded under a sharded leading one (the ``sp``
    profile's sequence under the batch). A DTensor ``x`` is first gathered
    on such dims, as sequence parallelism gathers the sequence before a
    projection, and so is the gradient in the backward. A plain ``x``
    multiplies as it is. A DTensor ``x`` of rows ``[N, D]`` multiplies
    placed so that the product is local (:func:`_fsdp_gathered`)."""
    if not _is_dtensor(x):
        return x @ w
    if x.dim() < 3:
        x, w = _fsdp_gathered(w, x)
        return x @ w
    return _Dense.apply(_gather_mid(x), w)


def _fsdp_gathered(w: torch.Tensor, x: torch.Tensor):
    """``(x, w)`` of a DTensor product ``x [N, D] @ w [D, F]`` placed so
    that it is local on every mesh dim: where a mesh dim shards x's rows
    and w's ``D``, w is gathered there (the FSDP gather); where it shards
    x's ``D`` but not w's, x is gathered there; where it shards both ``D``s
    (row-parallel tensor parallelism) both stay and the product is
    partial. Left to DTensor, the card's torch would plan to turn x's row
    shards into a partial sum, a redistribution it cannot run."""
    from torch.distributed.tensor import Replicate, Shard

    def on(t, i, d):
        p = t.placements[i]
        return isinstance(p, Shard) and p.dim % t.dim() == d
    if not _is_dtensor(w):
        return x, w
    wp = [Replicate() if on(w, i, 0) and on(x, i, 0) else p
          for i, p in enumerate(w.placements)]
    xp = [Replicate() if on(x, i, 1) and not on(w, i, 0) else p
          for i, p in enumerate(x.placements)]
    if wp != list(w.placements):
        w = w.redistribute(w.device_mesh, wp)
    if xp != list(x.placements):
        x = x.redistribute(x.device_mesh, xp)
    return x, w


# ---------------------------------------------------------------------------
# Row gathers and segment reductions over an arc list (the GNN families)
# ---------------------------------------------------------------------------

def _as_dtensor(t: torch.Tensor, mesh) -> torch.Tensor:
    """A plain tensor as a DTensor replicated on ``mesh``; a DTensor as it
    is."""
    if _is_dtensor(t):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _contiguous_stride(shape) -> Tuple[int, ...]:
    """A contiguous tensor's strides, computed without allocating one (a
    meta tensor of a global shape would count in a trace's memory)."""
    out, step = [], 1
    for n in reversed(tuple(shape)):
        out.append(step)
        step *= max(int(n), 1)
    return tuple(reversed(out))


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` along dim 0 (``index_select``). A DTensor ``x`` whose rows
    are sharded is first gathered on those mesh dims (and on every mesh dim
    that shards the ids: the output takes their shards), each device picks
    the rows of its own ids, and the gradient is each device's share of a
    sum over its ids, reduced back to x's shards: GSPMD's gather of a
    row-sharded operand by sharded indices. A plain ``x`` with plain ids
    is ``index_select`` itself."""
    if not (_is_dtensor(x) or _is_dtensor(idx)):
        return torch.index_select(x, 0, idx)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = (x if _is_dtensor(x) else idx).device_mesh
    x, idx = _as_dtensor(x, mesh), _as_dtensor(idx, mesh)
    ip = [p if isinstance(p, Shard) else Replicate() for p in idx.placements]
    if tuple(ip) != tuple(idx.placements):
        idx = idx.redistribute(mesh, ip)
    xp = [Replicate() if isinstance(ip[i], Shard) or p.is_partial()
          or (isinstance(p, Shard) and p.dim % x.dim() == 0) else p
          for i, p in enumerate(x.placements)]
    grad = [Partial() if isinstance(ip[i], Shard) else p
            for i, p in enumerate(xp)]
    out = [Shard(0) if isinstance(ip[i], Shard) else p
           for i, p in enumerate(xp)]
    xr = x if tuple(xp) == tuple(x.placements) else x.redistribute(mesh, xp)
    local = torch.index_select(xr.to_local(grad_placements=grad), 0,
                               idx.to_local())
    shape = (idx.shape[0],) + tuple(x.shape[1:])
    return DTensor.from_local(local, mesh, out, run_check=False,
                              shape=torch.Size(shape),
                              stride=_contiguous_stride(shape))


def segment_reduce(values: torch.Tensor, segments: torch.Tensor, n: int,
                   reduce: str = "sum") -> torch.Tensor:
    """``values`` [E, ...] reduced into ``n`` rows by ``segments`` [E]: a
    sum from zeros (``index_add_``), or ``"amax"`` / ``"amin"`` from the
    empty-segment identity ``-inf`` / ``+inf`` (``scatter_reduce``, the
    start included, as ``segment_max`` starts). On DTensors each device
    reduces its own share of the arcs into a whole ``[n, ...]`` block, left
    partial (sum, max or min) over the mesh dims that shard the arcs, for
    the next redistribution to reduce: a scatter-add under GSPMD is a
    partial sum and a reduce-scatter. The gradient of a partial block is
    whole on each device, so the backward gathers it, and each device
    takes its own arcs' rows. Plain tensors take the op itself."""
    shape = (n,) + tuple(values.shape[1:])
    if not (_is_dtensor(values) or _is_dtensor(segments)):
        return _segment_local(values, segments, shape, reduce)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = (values if _is_dtensor(values) else segments).device_mesh
    values = _as_dtensor(values, mesh)
    if reduce != "sum" and any(p.is_partial() for p in values.placements):
        values = values.redistribute(mesh, [
            Replicate() if p.is_partial() else p for p in values.placements])
    vp = list(values.placements)
    on_arcs = [isinstance(p, Shard) and p.dim % values.dim() == 0
               for p in vp]
    segments = _as_dtensor(segments, mesh)
    sp = [Shard(0) if a else Replicate() for a in on_arcs]
    if tuple(sp) != tuple(segments.placements):
        segments = segments.redistribute(mesh, sp)
    op = {"sum": "sum", "amax": "max", "amin": "min"}[reduce]
    out = [Partial(op) if a else p for a, p in zip(on_arcs, vp)]
    local = _segment_local(values.to_local(), segments.to_local(),
                           (n,) + tuple(values.to_local().shape[1:]), reduce)
    return DTensor.from_local(local, mesh, out, run_check=False,
                              shape=torch.Size(shape),
                              stride=_contiguous_stride(shape))


def _segment_local(values: torch.Tensor, segments: torch.Tensor, shape,
                   reduce: str) -> torch.Tensor:
    if reduce == "sum":
        return values.new_zeros(shape).index_add_(0, segments, values)
    idx = segments.reshape((-1,) + (1,) * (values.dim() - 1))
    start = values.new_full(shape, -torch.inf if reduce == "amax"
                            else torch.inf)
    return start.scatter_reduce(0, idx.expand_as(values), values, reduce)


def select(x: torch.Tensor, dim: int, idx: torch.Tensor) -> torch.Tensor:
    """``x.index_select(dim, idx)`` with plain ``idx``. A DTensor selects
    on each shard locally (gathered first on the mesh dims that shard
    ``dim``), so its backward is a local ``index_add``: the card's DTensor
    has no sharding rule for a DTensor ``index_add``. A plain ``x`` is
    ``index_select`` itself."""
    if not _is_dtensor(x):
        return x.index_select(dim, idx)
    from torch.distributed.tensor import DTensor
    dim %= x.dim()
    x = _gather_dims(x, (dim,))
    local = x.to_local().index_select(dim, idx)
    shape = list(x.shape)
    shape[dim] = idx.shape[0]
    return DTensor.from_local(local, x.device_mesh, x.placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=_contiguous_stride(shape))


def rowwise(fn, x: torch.Tensor):
    """``fn(x)`` for a function that acts on each row of ``x`` (dim 0) on
    its own and returns a tensor or a list of tensors with those rows
    first. A DTensor ``x`` sharded on its rows only is mapped shard by
    shard (the card's torch has no sharding rule for some per-row ops,
    such as ``linalg_cross``), the outputs placed as x is; a plain ``x`` is
    ``fn(x)`` itself."""
    if not _is_dtensor(x):
        return fn(x)
    from torch.distributed.tensor import DTensor, Replicate
    mesh = x.device_mesh
    x = _gather_dims(x, tuple(range(1, x.dim())))
    if any(p.is_partial() for p in x.placements):
        x = x.redistribute(mesh, [Replicate() if p.is_partial() else p
                                  for p in x.placements])
    out = fn(x.to_local())

    def wrap(t):
        shape = (x.shape[0],) + tuple(t.shape[1:])
        return DTensor.from_local(t, mesh, x.placements, run_check=False,
                                  shape=torch.Size(shape),
                                  stride=_contiguous_stride(shape))
    return [wrap(t) for t in out] if isinstance(out, list) else wrap(out)
