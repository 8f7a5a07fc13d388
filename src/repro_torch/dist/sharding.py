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
    names, ``Replicate()`` on every other. A dim named over several mesh
    axes must name them in the mesh's order (outermost first, as JAX nests
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
    does not divide ``sizes[0]`` is first gathered on those dims. A plain
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
    return x.reshape(shape)


def split_last(x: torch.Tensor, *sizes: int) -> torch.Tensor:
    """``x [..., prod(sizes)]`` reshaped to ``[..., *sizes]``: the heads
    split of an attention projection (:func:`split_dim` on the last dim)."""
    return split_dim(x, -1, *sizes)


class _MergeLast(torch.autograd.Function):
    """A DTensor's two last dims merged, whose gradient is split back with
    :func:`split_last` (autograd's own view backward would refuse the
    uneven split)."""

    @staticmethod
    def forward(ctx, x):
        ctx.sizes = tuple(x.shape[-2:])
        return x.reshape(tuple(x.shape[:-2]) + (-1,))

    @staticmethod
    def backward(ctx, g):
        return split_last(g, *ctx.sizes)


def merge_last(x: torch.Tensor) -> torch.Tensor:
    """``x [..., a, b]`` reshaped to ``[..., a·b]`` (the heads merge before
    an attention's output projection), the inverse of :func:`split_last`;
    a plain tensor is reshaped as it is."""
    if not _is_dtensor(x):
        return x.reshape(tuple(x.shape[:-2]) + (-1,))
    return _MergeLast.apply(x)


class _VocabParallelEmbed(torch.autograd.Function):
    """The embedding lookup of a DTensor table whose vocab dim may be
    sharded: the table gathered on its other dims (the FSDP gather), each
    device looking up the ids that fall in its vocab slice (zeros
    elsewhere), the rows left partial over the vocab dims' mesh dims for
    the next redistribution to sum; the backward adds each row's gradient
    into its device's slice and reduces it to the table's placements. The
    vocab-parallel lookup GSPMD lowers a gather of a vocab-sharded table
    to."""

    @staticmethod
    def forward(ctx, table, ids):
        from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
        mesh = table.device_mesh
        vocab = [i for i, p in enumerate(table.placements)
                 if isinstance(p, Shard) and p.dim == 0]
        table_g = table.redistribute(mesh, [
            p if i in vocab else Replicate()
            for i, p in enumerate(table.placements)])
        ids_r = ids.redistribute(mesh, [
            Replicate() if i in vocab else p
            for i, p in enumerate(ids.placements)])
        t_loc, i_loc = table_g.to_local(), ids_r.to_local()
        rows = t_loc.shape[0]
        coord = mesh.get_coordinate()
        index = 0
        for i in vocab:                        # nested in mesh-dim order
            index = index * mesh.size(i) + coord[i]
        local_ids = (i_loc - index * rows).long()
        hit = (local_ids >= 0) & (local_ids < rows)
        local_ids = local_ids.clamp(0, rows - 1)
        out = t_loc[local_ids] * hit[..., None].to(t_loc.dtype)
        out_pl = [Partial() if i in vocab else p
                  for i, p in enumerate(ids_r.placements)]
        ctx.save_for_backward(local_ids, hit)
        ctx.meta = (mesh, vocab, tuple(table.placements), tuple(table.shape),
                    tuple(table.stride()), tuple(ids_r.placements), rows)
        shape = tuple(ids.shape) + (table.shape[1],)
        return DTensor.from_local(out, mesh, out_pl, run_check=False,
                                  shape=shape,
                                  stride=torch.empty(shape,
                                                     device="meta").stride())

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
        mesh, vocab, t_pl, t_shape, t_stride, i_pl, rows = ctx.meta
        local_ids, hit = ctx.saved_tensors
        g = g.redistribute(mesh, [Replicate() if i in vocab else p
                                  for i, p in enumerate(i_pl)])
        g_loc = g.to_local()
        d = g_loc.shape[-1]
        grad = g_loc.new_zeros((rows, d)).index_add_(
            0, local_ids.reshape(-1),
            (g_loc * hit[..., None].to(g_loc.dtype)).reshape(-1, d))
        grad_pl = [Shard(0) if i in vocab
                   else Partial() if isinstance(p, Shard) else Replicate()
                   for i, p in enumerate(i_pl)]
        grad = DTensor.from_local(grad, mesh, grad_pl, run_check=False,
                                  shape=t_shape, stride=t_stride)
        return grad.redistribute(mesh, t_pl), None


def embed_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]``: the embedding lookup. A DTensor table takes the
    vocab-parallel lookup (``_VocabParallelEmbed``): DTensor's own indexing
    refuses ids sharded over two mesh dims, and its masked vocab-sharded
    gather cannot run on meta tensors. A plain table is indexed as it
    is."""
    if not _is_dtensor(table):
        return table[ids]
    return _VocabParallelEmbed.apply(table, ids)


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
    multiplies as it is."""
    if not _is_dtensor(x) or x.dim() < 3:
        return x @ w
    return _Dense.apply(_gather_mid(x), w)
