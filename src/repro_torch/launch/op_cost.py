"""Per-device op costs and peak memory of a traced step: twin of
``repro/launch/hlo_cost.py``.

The reference re-derives per-device FLOPs and HBM bytes from a compiled
SPMD module's HLO text. The port has no HLO: :class:`OpCostRecorder` is a
``TorchDispatchMode`` that records every aten op the step runs, as one
device runs it, with the reference's counting rules (``hlo_cost.py``):

  * a product (``mm``, ``bmm``, ``addmm``, ...): 2 * prod(result) *
    prod(contracted dims);
  * an elementwise or transcendental op: one per result element (a few
    for the composite ones, ``silu`` and the like, one per HLO op they
    lower to); ``transcendentals`` counts the transcendental ones apart;
  * a reduction: one per operand element;
  * ``bytes``: the result bytes plus the operand bytes of every op that is
    not bookkeeping (views, ``detach``, ``empty``, a copy from one device
    to another and the like: the reference's ``_FREE`` set, where a host
    table is a constant);
  * ``bytes_fused``: only the op classes of the reference's ``_FUSED_HBM``
    (products, copies, concatenations, gathers, scatters, slices written
    in place, sorts, reductions, collectives, custom kernels);
  * ``bytes_tight``: only ``_TIGHT_HBM``'s (products, gathers and
    scatters, slices written in place, sorts, reductions, collectives,
    random bits, custom kernels), and ``bytes_tight_f32`` its float32 part.

:data:`OPS` maps aten op names to those classes. An op it does not know
counts under ``bytes`` and is listed once in the record
(``unclassified``), never dropped.

**Per device.** A DTensor op is not counted where DTensor receives it:
the recorder hands it on (``NotImplemented``), and DTensor's dispatch then
runs its local op, and each redistribution's collectives and local
copies, on the local shards with the recorder still on; those are what it
counts. Ops inside ``local_map`` and the shard-local helpers of
``dist/sharding.py`` run on local tensors and count as they run. So work
that runs replicated counts in full on every device, as in the
reference's SPMD module, and no op is counted twice. The shape
propagation DTensor runs on fake tensors of the global shapes is not
counted.

**Kernel sites.** Where a hand-written kernel runs on the card, the trace
on ``meta`` tensors computes nothing, so the site counts by declaration
(``kernels/cost_sites.py``: ``declare``), with one rule on every device,
and the ops inside it (the plain version on CPU or CUDA tensors) are not
counted (``opaque``). Two sites declare: the attention
(``cost_sites.attention_cost``, ``models/common.py``), whose FLOPs are what the
reference's HLO counts for ``_flash`` (every kv chunk with the mask
applied, the forward and the pure-JAX backward) and whose bytes are the
fused kernel's Q/K/V/O I/O, as the reference's dry-run swaps them in
(``attention_kernel_bytes``): nothing of the attention's interior is
counted, so the record's ``bytes_deep`` is 0; and the token loss
(``cost_sites.token_nll_cost``), whose log-sum-exp, gold gather and
backward scatter over ``[tokens, vocab]`` the meta trace cannot run,
counted as the reference's HLO counts them.
Every other path of the meta trace (the MoE dispatch, the GNN gathers,
segment sums and chunked arcs, the two-tower lookups) runs its ops on
meta tensors and counts them as they are; on a one-device trace the
two-tower model's bag lookup takes its plain version (no kernel runs on
meta), whose ops count (the card's launch of ``bag_combine`` is not seen:
only the LM step is held to the card's count).

**The port's own rule.** The traced dtypes are the real ones, so nothing
is halved as the reference halves float32 traffic for XLA:CPU's upcasts
of the bf16 path; ``bytes_tight_f32`` is still reported.

**Peak memory.** The recorder also tracks the bytes live on the device.
Meta tensors all have ``data_ptr`` 0, so storages are keyed by identity
and freed when Python finalizes them. ``memory`` gives the reference's
three keys per device: ``argument_bytes`` (the step's inputs),
``output_bytes`` (its outputs) and ``temp_bytes``, the most bytes the step
allocated and held at once; unlike XLA's, that includes the outputs live
at that moment, so ``argument_bytes + temp_bytes`` is the step's peak.
"""
from __future__ import annotations

import os
import sys
import weakref
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels.cost_sites import _ACTIVE

KEYS = ("flops", "bytes", "bytes_fused", "bytes_tight", "bytes_tight_f32",
        "transcendentals")

# op classes; FUSED / TIGHT are the reference's _FUSED_HBM / _TIGHT_HBM
FREE, FILL, COPY, ELEM, DOT, GATHER, SCATTER, DUS, SORT, REDUCE, \
    COLLECTIVE, CUSTOM, CONCAT, PAD, RNG = (
        "free", "fill", "copy", "elementwise", "dot", "gather", "scatter",
        "dynamic-update-slice", "sort", "reduce", "collective", "custom",
        "concatenate", "pad", "rng")
FUSED = frozenset((COPY, DOT, GATHER, SCATTER, DUS, SORT, REDUCE, COLLECTIVE,
                   CUSTOM, CONCAT, PAD, RNG))
TIGHT = frozenset((DOT, GATHER, SCATTER, DUS, SORT, REDUCE, COLLECTIVE,
                   CUSTOM, RNG))


def _table() -> Dict[str, Tuple[str, float, float]]:
    """aten op name (the overload packet's, in-place ``_`` stripped) ->
    (class, flops per result element, transcendentals per result
    element); the per-element numbers apply to ``elementwise`` ops only."""
    t: Dict[str, Tuple[str, float, float]] = {}
    for names, cls in (
            ("alias detach empty empty_like empty_strided new_empty "
             "new_empty_strided lift_fresh resolve_conj resolve_neg "
             "_wrap_tensor_autograd wait_tensor _local_scalar_dense "
             "sym_size sym_stride sym_numel set record_stream "
             "_assert_async _assert_tensor_metadata is_same_size "
             "_has_compatible_shallow_copy_type _unsafe_view item", FREE),
            ("zeros ones full zeros_like ones_like full_like fill zero "
             "new_zeros new_ones new_full scalar_tensor arange linspace eye "
             "lift_fresh_copy", FILL),
            ("clone copy _copy_from _copy_from_and_resize repeat roll flip "
             "contiguous", COPY),
            ("mm bmm addmm baddbmm addbmm dot mv addmv convolution "
             "_convolution", DOT),
            ("index_select gather index embedding take take_along_dim "
             "_embedding_bag repeat_interleave _unsafe_index", GATHER),
            ("scatter scatter_add scatter_reduce index_add index_put "
             "_index_put_impl index_copy masked_scatter index_fill "
             "_unsafe_index_put embedding_dense_backward", SCATTER),
            ("slice_scatter select_scatter diagonal_scatter "
             "as_strided_scatter slice_backward select_backward", DUS),
            ("sort topk argsort kthvalue msort searchsorted", SORT),
            ("sum mean amax amin max min argmax argmin prod any all "
             "count_nonzero cumsum cumprod logcumsumexp nansum equal "
             "_local_scalar", REDUCE),
            ("cat stack", CONCAT),
            ("constant_pad_nd pad", PAD),
            ("rand randn normal uniform bernoulli randint randperm "
             "rand_like randn_like randint_like exponential", RNG)):
        for n in names.split():
            t[n] = (cls, 0.0, 0.0)
    for names, flops, trans in (
            ("add sub rsub mul div neg abs maximum minimum clamp clamp_min "
             "clamp_max where eq ne lt le gt ge logical_and logical_or "
             "logical_not logical_xor bitwise_and bitwise_or bitwise_xor "
             "bitwise_not floor ceil round trunc sign sgn reciprocal "
             "remainder fmod isfinite isinf isnan masked_fill relu "
             "square tril triu signbit bitwise_left_shift "
             "bitwise_right_shift floor_divide _to_copy to", 1.0, 0.0),
            ("exp exp2 log log2 log10 sqrt rsqrt tanh sigmoid sin cos erf "
             "pow atan2 expm1 log1p cbrt", 1.0, 1.0),
            ("addcmul addcdiv threshold_backward hardtanh leaky_relu "
             "nan_to_num", 2.0, 0.0),
            ("lerp", 3.0, 0.0),
            ("silu", 2.0, 1.0),
            ("gelu softplus elu", 4.0, 1.0),
            ("sigmoid_backward tanh_backward", 3.0, 0.0),
            ("silu_backward", 5.0, 1.0),
            ("gelu_backward", 8.0, 1.0),
            ("_softmax _log_softmax", 5.0, 1.0),
            ("_softmax_backward_data _log_softmax_backward_data", 4.0, 1.0),
            ("native_layer_norm", 8.0, 0.0),
            ("native_layer_norm_backward", 12.0, 0.0)):
        for n in names.split():
            t[n] = (ELEM, flops, trans)
    for n in ("all_gather_into_tensor", "all_reduce", "reduce_scatter_tensor",
              "all_to_all_single", "shard_dim_alltoall", "broadcast",
              "all_gather_into_tensor_coalesced", "all_reduce_coalesced",
              "reduce_scatter_tensor_coalesced"):
        t[n] = (COLLECTIVE, 0.0, 0.0)
    return t


OPS: Dict[str, Tuple[str, float, float]] = _table()
# reductions whose result is also divided (XLA: a reduce, then a divide)
_MEAN = frozenset(("mean",))
_VAR = frozenset(("var", "std", "var_mean", "std_mean"))
_NORM = frozenset(("linalg_vector_norm", "norm", "frobenius_norm"))
_LOGSUMEXP = frozenset(("logsumexp",))


def op_name(func) -> str:
    """``func``'s name in :data:`OPS`: the overload packet's name with an
    in-place ``_`` stripped (``add_`` -> ``add``, ``_index_put_impl_`` ->
    ``_index_put_impl``)."""
    name = func._opname
    return name[:-1] if name.endswith("_") and not name.endswith("__") \
        else name


def _tensors(tree_: Any) -> List[torch.Tensor]:
    """The tensors of a nest of lists, tuples and dicts, in order."""
    out: List[torch.Tensor] = []
    stack = [tree_]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            stack.extend(reversed(x))
        elif isinstance(x, dict):
            stack.extend(reversed(list(x.values())))
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _f32_bytes(ts: Sequence[torch.Tensor]) -> int:
    return sum(_nbytes(t) for t in ts if t.dtype == torch.float32)


def _dot_flops(name: str, args, outs: Sequence[torch.Tensor]) -> float:
    """2 * prod(result) * prod(contracted dims), and one per result element
    for the addition of the ``add*`` forms."""
    tens = [a for a in args if isinstance(a, torch.Tensor)]
    out = float(sum(o.numel() for o in outs))
    if name in ("dot", "mv", "addmv"):
        mat = tens[1] if name == "addmv" else tens[0]
        k = mat.shape[-1]
    elif name in ("convolution", "_convolution"):
        w = tens[1]
        groups = args[8] if len(args) > 8 and isinstance(args[8], int) else 1
        k = (w.shape[1] if not (len(args) > 6 and args[6]) else
             w.shape[0] // max(groups, 1))
        for s in w.shape[2:]:
            k *= s
    else:
        lhs = tens[1] if name in ("addmm", "baddbmm", "addbmm") else tens[0]
        k = lhs.shape[-1]
    flops = 2.0 * out * k
    if name.startswith("add") or name == "baddbmm":
        flops += out
    return flops


def _call_site() -> str:
    """The first frame outside torch, this module and the collective
    recorder's redistribution hook: ``file:line (function)``, the file
    relative to the package's parent."""
    here = os.path.abspath(__file__)
    skip = (here, os.path.join(os.path.dirname(here), "collectives.py"))
    torch_dir = os.path.dirname(os.path.abspath(torch.__file__))
    f = sys._getframe(2)
    while f is not None:
        path = os.path.abspath(f.f_code.co_filename)
        if path not in skip and not path.startswith(torch_dir) \
                and "contextlib" not in path:
            root = os.path.dirname(os.path.dirname(os.path.dirname(here)))
            rel = os.path.relpath(path, root) if path.startswith(root) \
                else os.path.basename(path)
            return f"{rel}:{f.f_lineno} ({f.f_code.co_name})"
        f = f.f_back
    return "?"


def local(t: torch.Tensor) -> torch.Tensor:
    """``t``'s local shard (``t`` itself unless it is a DTensor)."""
    return getattr(t, "_local_tensor", t)


class OpCostRecorder(TorchDispatchMode):
    """Counts every op a step runs, per device (see the module docstring).

    After the ``with`` block: ``totals`` (the six :data:`KEYS`), ``by_op``
    (each aten op name's totals and ``count``), ``by_site`` (with
    ``call_sites=True``: each (op, calling line)'s totals, for the
    diagnosis), ``sites`` (each declared kernel site's totals and
    ``count``), ``unclassified`` (op names :data:`OPS` does not know),
    ``upcasts`` (bf16 -> float32 conversions: shape -> count) and
    :meth:`memory`. Call :meth:`arguments` on the step's inputs before the
    step and :meth:`outputs` on its results after it."""

    def __init__(self, *, call_sites: bool = False):
        super().__init__()
        from torch._subclasses.fake_tensor import FakeTensor
        self._fake = FakeTensor
        self.call_sites = call_sites
        self.totals: Dict[str, float] = {k: 0.0 for k in KEYS}
        self.by_op: Dict[str, Dict[str, float]] = {}
        self.by_site: Dict[Tuple[str, str], Dict[str, float]] = {}
        self.sites: Dict[str, Dict[str, float]] = {}
        self.unclassified: List[str] = []
        self.upcasts: Dict[Tuple[int, ...], int] = {}
        self.n_ops = 0
        self._opaque = 0
        self._paused = 0
        self._args: Dict[int, int] = {}
        self._live: Dict[int, int] = {}
        self._cur = 0
        self._peak = 0
        self._out_bytes = 0

    # -- memory ------------------------------------------------------------

    def _storage_key(self, t: torch.Tensor):
        try:
            st = t.untyped_storage()
        except (RuntimeError, NotImplementedError):
            return None, None
        return st._cdata, st

    def arguments(self, *trees: Any) -> int:
        """Register the step's inputs (local shards of DTensors); returns
        their bytes (each storage once)."""
        for t in _tensors(list(trees)):
            key, st = self._storage_key(local(t))
            if key is not None and key not in self._args:
                self._args[key] = st.nbytes()
        return sum(self._args.values())

    def outputs(self, *trees: Any) -> int:
        """Register the step's results; returns their bytes (each storage
        once)."""
        seen: Dict[int, int] = {}
        for t in _tensors(list(trees)):
            key, st = self._storage_key(local(t))
            if key is not None:
                seen[key] = st.nbytes()
        self._out_bytes = sum(seen.values())
        return self._out_bytes

    def _free(self, key: int) -> None:
        n = self._live.pop(key, 0)
        self._cur -= n

    def _track(self, outs: Sequence[torch.Tensor]) -> None:
        for t in outs:
            key, st = self._storage_key(t)
            if key is None or key in self._live or key in self._args:
                continue
            n = st.nbytes()
            if not n:
                continue
            self._live[key] = n
            self._cur += n
            self._peak = max(self._peak, self._cur)
            weakref.finalize(st, self._free, key)

    def memory(self) -> Dict[str, int]:
        """``{argument_bytes, output_bytes, temp_bytes}`` of one device."""
        return {"argument_bytes": int(sum(self._args.values())),
                "output_bytes": int(self._out_bytes),
                "temp_bytes": int(self._peak)}

    # -- counting ----------------------------------------------------------

    def _add(self, name: str, cost: Dict[str, float]) -> None:
        for k in KEYS:
            self.totals[k] += cost.get(k, 0.0)
        row = self.by_op.setdefault(name, dict.fromkeys(KEYS, 0.0))
        row["count"] = row.get("count", 0) + 1
        for k in KEYS:
            row[k] += cost.get(k, 0.0)
        if self.call_sites:
            srow = self.by_site.setdefault((name, _call_site()),
                                           dict.fromkeys(KEYS, 0.0))
            srow["count"] = srow.get("count", 0) + 1
            for k in KEYS:
                srow[k] += cost.get(k, 0.0)

    def _declare(self, site: str, declared: Dict[str, float]) -> None:
        io = declared["bytes"]
        cost = {"flops": declared["flops"],
                "transcendentals": declared["transcendentals"],
                "bytes": io, "bytes_fused": io, "bytes_tight": io,
                "bytes_tight_f32": declared["f32_bytes"]}
        row = self.sites.setdefault(site, dict.fromkeys(KEYS, 0.0))
        row["count"] = row.get("count", 0) + 1
        for k in KEYS:
            row[k] += cost[k]
        self._add(f"site:{site}", cost)

    def cost_of(self, func, args, kwargs, out) -> Optional[Dict[str, float]]:
        """The cost of one local op (None: bookkeeping, not counted)."""
        name = op_name(func)
        if func.namespace in ("_c10d_functional", "_dtensor",
                              "c10d_functional"):
            cls = OPS.get(name, (FREE, 0.0, 0.0))[0]
        elif getattr(func, "is_view", False):
            return None
        elif name in OPS:
            cls = OPS[name][0]
        elif name in _MEAN or name in _VAR or name in _NORM \
                or name in _LOGSUMEXP:
            cls = REDUCE
        else:
            cls = None
        if cls == FREE:
            return None
        outs = _tensors(out)
        ins = _tensors([args, kwargs or {}])
        if name in ("_to_copy", "copy", "_copy_from") and ins and outs \
                and ins[0].device != outs[0].device:
            # a host table moved to the device: a constant of the
            # reference's module (its _FREE set), not device traffic
            return None
        out_b = float(sum(_nbytes(t) for t in outs))
        in_b = float(sum(_nbytes(t) for t in ins))
        cost = {"bytes": out_b + in_b}
        if cls is None:
            if name not in self.unclassified:
                self.unclassified.append(name)
            return cost
        if cls == FILL:
            cost["bytes"] = out_b
        if cls in FUSED:
            cost["bytes_fused"] = cost["bytes"]
        if cls in TIGHT:
            cost["bytes_tight"] = cost["bytes"]
            cost["bytes_tight_f32"] = float(_f32_bytes(outs) + _f32_bytes(ins))
        n_out = float(sum(t.numel() for t in outs))
        if cls == DOT:
            cost["flops"] = _dot_flops(name, args, outs)
        elif cls == REDUCE:
            n_in = float(ins[0].numel()) if ins else 0.0
            if name in _MEAN:
                cost["flops"] = n_in + n_out
            elif name in _VAR:
                cost["flops"] = 3.0 * n_in + n_out
            elif name in _NORM:
                cost["flops"] = 2.0 * n_in + n_out
                cost["transcendentals"] = n_out
            elif name in _LOGSUMEXP:
                cost["flops"] = 4.0 * n_in + 2.0 * n_out
                cost["transcendentals"] = n_in + n_out
            else:
                cost["flops"] = n_in
        elif cls == ELEM:
            _, per, trans = OPS[name]
            if name in ("_to_copy", "to"):
                if ins and outs and ins[0].dtype == outs[0].dtype:
                    # a copy across devices or layouts, no convert
                    cost["bytes_fused"] = cost["bytes"]
                    return cost
            if name == "pow" and len(args) > 1 \
                    and isinstance(args[1], (int, float)) and args[1] == 2:
                trans = 0.0                 # a square: XLA's multiply
            cost["flops"] = per * n_out
            if trans:
                cost["transcendentals"] = trans * n_out
        elif cls == COPY and name in ("copy", "_copy_from") and len(ins) >= 2 \
                and ins[0].dtype != ins[1].dtype:
            cost["flops"] = n_out           # a convert written in place
        return cost

    def _upcast(self, name: str, args, out) -> None:
        ins = _tensors(args)
        outs = _tensors(out)
        if not ins or not outs:
            return
        src = ins[1] if name in ("copy", "_copy_from") and len(ins) > 1 \
            else ins[0]
        if src.dtype == torch.bfloat16 and outs[0].dtype == torch.float32:
            shape = tuple(int(s) for s in src.shape)
            self.upcasts[shape] = self.upcasts.get(shape, 0) + 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(t is not torch.Tensor and t is not torch.nn.Parameter
               and not issubclass(t, self._fake) for t in types):
            # a DTensor (or another wrapper): its local ops come back here
            return NotImplemented
        out = func(*args, **kwargs)
        if self._paused:
            return out
        outs = _tensors(out)
        if any(isinstance(t, self._fake) for t in outs) or any(
                isinstance(t, self._fake) for t in _tensors(args)):
            return out                      # DTensor's shape propagation
        self._track(outs)
        if self._opaque:
            return out
        cost = self.cost_of(func, args, kwargs, out)
        if cost is None:
            return out
        self.n_ops += 1
        name = op_name(func)
        if name in ("_to_copy", "to", "copy", "_copy_from"):
            self._upcast(name, args, out)
        self._add(name, cost)
        return out

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            if self in _ACTIVE:
                _ACTIVE.remove(self)

    # -- the record ---------------------------------------------------------

    def record(self) -> Dict[str, Any]:
        """JSON-native: ``hlo_cal`` (the six totals), ``memory``,
        ``sites``, ``unclassified``, ``upcasts`` and ``n_ops``."""
        return {"hlo_cal": {k: float(self.totals[k]) for k in KEYS},
                "memory": self.memory(),
                "sites": {k: {kk: float(vv) for kk, vv in v.items()}
                          for k, v in sorted(self.sites.items())},
                "unclassified": sorted(self.unclassified),
                "upcasts": [[list(s), c] for s, c in
                            sorted(self.upcasts.items())],
                "n_ops": int(self.n_ops)}

    def top_ops(self, key: str = "bytes_tight", n: int = 10
                ) -> List[Tuple[str, Dict[str, float]]]:
        """The ``n`` aten ops (by name) with the most ``key``."""
        return sorted(self.by_op.items(), key=lambda kv: -kv[1][key])[:n]

    def top_sites(self, key: str = "bytes_tight", n: int = 10
                  ) -> List[Tuple[Tuple[str, str], Dict[str, float]]]:
        """The ``n`` (aten op, calling line) pairs with the most ``key``
        (``call_sites=True``)."""
        return sorted(self.by_site.items(), key=lambda kv: -kv[1][key])[:n]
