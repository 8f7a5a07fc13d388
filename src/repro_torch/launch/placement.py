"""The launch layer's placement session: twin of
``repro/launch/placement.py``.

``PlacementSession`` owns the trace -> measure -> search -> retrace loop:

1. **trace** one ``(arch x shape x profile)`` cell on the identity mesh
   (any non-skip cell of ``configs.all_cells()``, under any profile of its
   arch, with or without ``grad_compress``):
   a ``fake`` process group of the machine's size (``launch/mesh.
   fake_world``, the twin of the reference's 512 placeholder host
   devices), a ``DeviceMesh`` in the given device order, the cell's step
   (``launch/steps.build_cell``) run once on DTensors whose local shards
   are ``meta`` tensors, which allocate and compute nothing, under the
   collective recorder (``launch/collectives.py``): forward, backward and
   the AdamW update for a ``train`` cell. What the launch layer reads of
   it, the per-op link bytes and the ``[D, D]`` device-pair traffic
   matrix, goes into one serializable :class:`CellRecord`. The reference
   compiles the cell with XLA and parses the HLO instead.
2. **search** the logical -> physical device order with the port's
   ``core.mapping.search`` (on ``device``, ``None`` = CUDA: its scorer
   launches ``quotient_link_loads``) against the machine tree.
3. **retrace** under the searched order and diff the two schedules,
   iterating to a fixed point as the reference does (``min_gain``, warm
   starts, the monotone guard, ``max_rounds``).

Every trace goes through a keyed cache, in memory within the session and
(``cache_dir``) on disk across processes. The key covers what changes the
trace: arch, shape, mesh shape and axes, profile, gradient compression,
overrides, device order, machine, torch's version, the world size and a
content hash of the ``repro_torch`` sources.

Differences from the reference's records: ``compile_s`` is the trace's
seconds. The trace runs under the op-cost recorder too
(``launch/op_cost.py``, the twin of ``hlo_cost.py``), which counts every
op as one device runs it, on its local shards: ``hlo_cal`` holds its six
per-device totals (FLOPs, bytes, fused, tight and float32-tight bytes,
transcendentals), with no float32 halving (the traced dtypes are the real
ones); ``agg_flops`` / ``agg_bytes`` are the same per-device FLOPs and
bytes (the reference's are XLA's ``cost_analysis``, which counts a while
body once; the port's layers are unrolled); ``memory`` is the recorder's
per-device peak count (``argument_bytes``, ``output_bytes``,
``temp_bytes``); ``bytes_deep`` is 0, since the attention counts as its
fused kernel's I/O and its interior never enters the record; and
``calibrate_s`` is the seconds taken to fold the record. ``link_bf16``
equals ``link`` (see ``launch/collectives.py``). Three fields are the
port's own: ``by_op`` (the collectives counted by op), ``link_by_axis``
(link bytes by mesh axis and op) and ``ops`` (the recorder's declared
kernel sites, the op names it could not classify, the bf16 -> float32
conversions by shape, the op count).

``map_pages`` places the pages of the serving engine's paged KV pool as
the rows of a graph with the port's ``partition()``: the paper's makespan
objective inside the server.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import logging
import os
import time
import warnings
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import DeviceLike
from repro_torch.core import machine as machine_lib
from repro_torch.core import mapping, topology
from repro_torch.core.machine import MachineSpec
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import op_cost
from repro_torch.launch.collectives import CollectiveRecorder, parse_collectives

# Disk cache location: override with REPRO_PLACEMENT_CACHE; an empty value
# (or cache_dir="" at construction) disables the disk tier.
_CACHE_ENV = "REPRO_PLACEMENT_CACHE"
_DEFAULT_CACHE_DIR = os.path.join("results", "placement_cache_torch")

_SRC_FINGERPRINT: Optional[str] = None


def _source_fingerprint() -> str:
    """Content hash of the ``repro_torch`` package's ``.py`` sources,
    computed once per process and folded into every cache key: editing a
    model, the sharding rules or the recorder invalidates the records."""
    global _SRC_FINGERPRINT
    if _SRC_FINGERPRINT is None:
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        h = hashlib.sha256()
        for dirpath, dirnames, filenames in sorted(os.walk(root)):
            dirnames.sort()
            for name in sorted(filenames):
                if not name.endswith(".py"):
                    continue
                path = os.path.join(dirpath, name)
                h.update(os.path.relpath(path, root).encode())
                with open(path, "rb") as f:
                    h.update(f.read())
        _SRC_FINGERPRINT = h.hexdigest()[:16]
    return _SRC_FINGERPRINT


# ---------------------------------------------------------------------------
# Records
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CellRecord:
    """Everything the launch layer derives from one trace of a cell.

    Cache-serializable (json metadata + the traffic array in one ``.npz``).
    ``device_order=None`` is the identity trace; a list is the logical ->
    physical permutation the mesh was built with. See the module docstring
    for the fields that differ from the reference's.
    """
    arch: str
    shape: str
    mesh_shape: Tuple[int, ...]
    axes: Tuple[str, ...]
    profile: str
    device_order: Optional[List[int]]
    compile_s: float                 # the trace's seconds
    calibrate_s: float
    scan_lengths: List[int]
    link: Dict[str, float]           # per-op per-device ring link bytes
    operand: Dict[str, float]
    link_bf16: Dict[str, float]      # = link (no XLA:CPU upcasts here)
    n_collectives: int
    agg_flops: float                 # op-cost recorder, per device
    agg_bytes: float
    memory: Dict[str, Optional[int]]
    hlo_cal: Dict[str, float]        # the recorder's six totals
    bytes_deep: float                # 0: attention counts as kernel I/O
    traffic: Any = None              # [D, D] np.ndarray device-pair bytes
    cached: bool = False             # served from cache, not traced
    by_op: Dict[str, int] = dataclasses.field(default_factory=dict)
    link_by_axis: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)        # mesh axis -> op -> link bytes
    ops: Dict[str, Any] = dataclasses.field(default_factory=dict)


def _json_sides(d: Dict[str, float]) -> Dict[str, float]:
    return {k: float(v) for k, v in d.items()}


@dataclasses.dataclass
class PlacementReport:
    """Searched-vs-identity placement comparison for one cell.

    All fields are JSON-native, so ``to_json`` / ``from_json`` round-trip
    to an equal dataclass. ``rounds`` records the fixed-point trajectory
    (round 0 is the identity trace's search; later rounds are retraces
    under the then-best order); ``schedule_diff`` is the retrace diff
    (None without ``recompile``).
    """
    arch: str
    shape: str
    profile: str
    mesh: str                        # "2x16x16"
    identity: Dict[str, float]       # makespan / bottleneck_link_bytes /
    searched: Dict[str, float]       #   dcn_bytes of each side
    makespan_ratio: float
    axis_perm: List[int]
    axis_orders: List[int]
    n_candidates: int
    device_order: List[int]
    total_link_bytes: float
    search_s: float
    rounds: List[Dict[str, Any]]
    schedule_diff: Optional[Dict[str, Any]]
    n_compiles: int                  # traces this place() actually ran
    cache_hits: int                  # cache hits this place() enjoyed

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @classmethod
    def from_json(cls, s: str) -> "PlacementReport":
        return cls(**json.loads(s))

    def summary(self) -> str:
        i, s = self.identity, self.searched
        return (f"[MAP]  {self.arch}/{self.shape}/{self.profile} "
                f"makespan id={i['makespan']:.3e} "
                f"searched={s['makespan']:.3e} "
                f"(ratio {self.makespan_ratio:.3f}) "
                f"dcn_bytes id={i['dcn_bytes']:.3e} "
                f"searched={s['dcn_bytes']:.3e} "
                f"perm={tuple(self.axis_perm)} "
                f"compiles={self.n_compiles} cache_hits={self.cache_hits}")

    def diff_summary(self) -> str:
        d = self.schedule_diff
        if not d:
            return "[DIFF] (no recompile requested)"
        lines = [f"[DIFF] {self.arch}/{self.shape}/{self.profile} "
                 f"searched-vs-identity traced schedule "
                 f"(recompiles={d['recompiles']}, "
                 f"fixed_point={d['fixed_point']})"]
        for op, v in sorted(d["per_op_link_bytes"].items()):
            lines.append(f"[DIFF]   {op:<19} id={v['identity']:.3e} "
                         f"searched={v['searched']:.3e} "
                         f"delta={v['delta']:+.3e}")
        for key in ("bottleneck_link_bytes", "dcn_bytes", "makespan"):
            v = d[key]
            lines.append(f"[DIFF]   {key:<19} id={v['identity']:.3e} "
                         f"searched={v['searched']:.3e} "
                         f"delta={v['delta']:+.3e}")
        return "\n".join(lines)


@dataclasses.dataclass
class PlacementResult:
    """What :meth:`PlacementSession.place` returns: the identity-order
    trace's record, the searched-vs-identity report, and, when
    ``recompile`` ran, the record of the trace under the winning order."""
    record: CellRecord
    report: PlacementReport
    searched_record: Optional[CellRecord] = None


# ---------------------------------------------------------------------------
# Side metrics + schedule diff
# ---------------------------------------------------------------------------

def _link_depths(topo) -> Optional[np.ndarray]:
    """Tree-link depths (1 = the top level, cross-pod DCN), or None for
    routing topologies, whose links have no depth (dcn_bytes report 0)."""
    if not isinstance(topo, topology.TreeTopology):
        return None
    return np.asarray([topo.depth(int(c)) for c in topo.link_nodes])


def _side_metrics(traffic: np.ndarray, topo, device_to_bin: np.ndarray,
                  depths: Optional[np.ndarray] = None,
                  device: DeviceLike = None) -> Dict[str, float]:
    """The paper's three observables of one placement under one measured
    schedule: F_l-weighted makespan, raw bottleneck-link bytes, and the
    bytes crossing the depth-1 (cross-pod DCN) tree links."""
    if depths is None:
        depths = _link_depths(topo)
    f_l = np.asarray(topo.F_l)
    loads = mapping.link_loads_of_device_map(traffic, topo, device_to_bin,
                                             device=device)
    return {"makespan": float((f_l * loads).max()),
            "bottleneck_link_bytes": float(loads.max()),
            "dcn_bytes": (float(loads[depths == 1].sum())
                          if depths is not None else 0.0)}


def schedule_diff(identity_rec: CellRecord, searched_rec: CellRecord,
                  topo, identity_order: np.ndarray,
                  searched_order: np.ndarray, *, recompiles: int = 1,
                  fixed_point: bool = True,
                  device: DeviceLike = None) -> Dict[str, Any]:
    """Diff two traced collective schedules under their placements.

    Each side's link metrics come from its own measured traffic matrix
    placed with its own order. Identical records under identical orders
    diff to exactly zero everywhere (``max_abs_delta == 0``)."""
    depths = _link_depths(topo)
    side_i = _side_metrics(identity_rec.traffic, topo,
                           np.asarray(identity_order), depths, device)
    side_s = _side_metrics(searched_rec.traffic, topo,
                           np.asarray(searched_order), depths, device)
    per_op: Dict[str, Dict[str, float]] = {}
    for op in sorted(set(identity_rec.link_bf16)
                     | set(searched_rec.link_bf16)):
        a = float(identity_rec.link_bf16.get(op, 0.0))
        b = float(searched_rec.link_bf16.get(op, 0.0))
        per_op[op] = {"identity": a, "searched": b, "delta": b - a}
    out: Dict[str, Any] = {"per_op_link_bytes": per_op,
                           "n_collectives": {
                               "identity": identity_rec.n_collectives,
                               "searched": searched_rec.n_collectives,
                               "delta": (searched_rec.n_collectives
                                         - identity_rec.n_collectives)},
                           "recompiles": int(recompiles),
                           "fixed_point": bool(fixed_point)}
    deltas = [v["delta"] for v in per_op.values()]
    for key in ("makespan", "bottleneck_link_bytes", "dcn_bytes"):
        out[key] = {"identity": side_i[key], "searched": side_s[key],
                    "delta": side_s[key] - side_i[key]}
        deltas.append(out[key]["delta"])
    deltas.append(float(out["n_collectives"]["delta"]))
    out["max_abs_delta"] = float(np.max(np.abs(np.asarray(deltas)))
                                 if deltas else 0.0)
    return out


# ---------------------------------------------------------------------------
# Tracing a cell
# ---------------------------------------------------------------------------

def meta_dtensors(tree_: Any, specs: Any, mesh) -> Any:
    """The tensors of ``tree_`` (meta tensors of global shapes) as DTensors
    on ``mesh`` placed by their sanitized ``specs``, their local shards
    ``meta`` tensors; anything else (a Python scalar) passes through. On a
    one-device mesh the local shard is the whole tensor: ``tree_`` is
    returned as it is, so the step runs the plain path a single device
    runs (the card's own step, op for op)."""
    from torch.distributed.tensor import DTensor

    from repro_torch import tree as tree_lib
    from repro_torch.dist import sharding

    if mesh.size() == 1:
        return tree_
    out = []
    for x, spec in sharding.spec_leaves(tree_, specs):
        if not isinstance(x, torch.Tensor):
            out.append(x)
            continue
        spec = sharding.sanitize_spec(x.shape, spec or (), mesh)
        local = torch.empty(sharding.local_shape(x.shape, spec, mesh),
                            dtype=x.dtype, device="meta")
        out.append(DTensor.from_local(
            local, mesh, sharding.placements(mesh, spec), run_check=False,
            shape=x.shape, stride=x.stride()))
    return tree_lib.unflatten(tree_, out)


def meta_like(x: Any) -> Any:
    """A ``meta`` copy of ``x``: a DTensor keeps its mesh, placements and
    global shape and stride on a ``meta`` local shard; a plain tensor
    becomes an empty ``meta`` tensor like it; anything else (a Python
    scalar) is itself."""
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor):
        local = torch.empty(x.to_local().shape, dtype=x.dtype, device="meta")
        return DTensor.from_local(local, x.device_mesh, x.placements,
                                  run_check=False, shape=x.shape,
                                  stride=x.stride())
    if isinstance(x, torch.Tensor):
        return torch.empty_like(x, device="meta")
    return x


@contextlib.contextmanager
def _quiet():
    """DTensor warns about every sequential multi-axis redistribution (the
    nested rings the trace records); keep a trace's output readable."""
    log = logging.getLogger("torch.distributed.tensor")
    level = log.level
    log.setLevel(logging.ERROR)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            yield
    finally:
        log.setLevel(level)


def trace_step(step, args: Sequence[Any], mesh, *,
               cost: Optional[op_cost.OpCostRecorder] = None
               ) -> Tuple[CollectiveRecorder, float, op_cost.OpCostRecorder]:
    """Run ``step(*args)`` once on ``mesh`` under the collective recorder
    and an op-cost recorder (``cost``, a new one by default): (collective
    recorder, seconds, op-cost recorder), the latter with the step's
    arguments and outputs registered for its memory count. Plain tensors
    among the step's operands (rope tables, scalars) act as replicated."""
    from torch.distributed.tensor.experimental import implicit_replication

    rec = CollectiveRecorder(mesh)
    cost = cost if cost is not None else op_cost.OpCostRecorder()
    cost.arguments(*args)
    t0 = time.perf_counter()
    with _quiet(), implicit_replication(), rec, cost:
        out = step(*args)
    cost.outputs(out)
    return rec, time.perf_counter() - t0, cost


def fold_costs(cost: op_cost.OpCostRecorder) -> Dict[str, Any]:
    """The :class:`CellRecord` fields of one op-cost recorder:
    ``hlo_cal``, ``agg_flops``, ``agg_bytes``, ``memory``, ``bytes_deep``
    (0), ``ops`` and ``calibrate_s`` (this fold's seconds)."""
    t0 = time.perf_counter()
    r = cost.record()
    cal = r["hlo_cal"]
    return dict(hlo_cal=cal, agg_flops=cal["flops"], agg_bytes=cal["bytes"],
                memory=r["memory"], bytes_deep=0.0,
                ops={k: r[k] for k in ("sites", "unclassified", "upcasts",
                                       "n_ops")},
                calibrate_s=round(time.perf_counter() - t0, 4))


# ---------------------------------------------------------------------------
# The session
# ---------------------------------------------------------------------------

class PlacementSession:
    """One trace -> measure -> search -> retrace session with a keyed
    trace cache (see module docstring), and the serving page mapper.

    ``cache_dir=None`` resolves ``$REPRO_PLACEMENT_CACHE`` (default
    ``results/placement_cache_torch``); ``cache_dir=""`` keeps the cache in
    memory only. ``map_restarts`` / ``recursive`` / ``seed`` parameterize
    every search; ``max_rounds`` bounds the retrace fixed point;
    ``min_gain`` is the relative makespan gain below which a searched
    order is not adopted. ``machine`` (a ``MachineSpec`` or preset name)
    is the default machine model. ``device`` (``None`` = CUDA) is where
    the searches and ``map_pages``' partitioner run. ``n_map_pages`` /
    ``map_pages_s`` count ``map_pages``' calls and their wall seconds.
    """

    def __init__(self, cache_dir: Optional[str] = None,
                 map_restarts: int = 32, recursive: bool = True,
                 seed: int = 0, max_rounds: int = 2,
                 min_gain: float = 1e-3, verbose: bool = False,
                 machine: Optional[Any] = None, device: DeviceLike = None):
        if cache_dir is None:
            cache_dir = os.environ.get(_CACHE_ENV, _DEFAULT_CACHE_DIR)
        self.cache_dir = cache_dir
        self.machine = machine_lib.resolve(machine)
        self.map_restarts = map_restarts
        self.recursive = recursive
        self.seed = seed
        self.max_rounds = max_rounds
        self.min_gain = min_gain
        self.verbose = verbose
        self.device = device
        self._mem: Dict[str, CellRecord] = {}
        self.n_compiles = 0
        self.n_cache_hits = 0
        self.n_map_pages = 0
        self.map_pages_s = 0.0

    # -- mesh construction -----------------------------------------------

    def build_mesh(self, mesh_shape: Sequence[int], axes: Sequence[str],
                   device_order: Optional[np.ndarray] = None):
        """``DeviceMesh`` of the current process group with an explicit
        logical -> physical order (identity when ``None``)."""
        return mesh_lib.make_mapped_mesh(tuple(mesh_shape), tuple(axes),
                                         device_order)

    def local_mesh(self):
        """Identity 1-D ``data`` mesh over the world's ranks: the starting
        mesh :meth:`map_step` permutes."""
        return self.build_mesh((mesh_lib.world_size(),), ("data",))

    def serving_mesh(self, device_order: Optional[np.ndarray] = None):
        """Production mesh when the device count matches a known machine,
        local 1-D data mesh otherwise."""
        shape, axes = mesh_lib.serving_mesh_spec()
        return self.build_mesh(shape, axes, device_order)

    # -- machine resolution ------------------------------------------------

    def _resolve_machine(self, machine, mesh_shape, axes, multi_pod):
        """(spec, mesh_shape, axes) of one call. Precedence: explicit
        ``machine`` > session default > (with no explicit mesh either) the
        TPU production preset the ``multi_pod`` flag names. An explicit
        ``mesh_shape`` with no machine anywhere runs machine-less."""
        spec = machine_lib.resolve(machine) or self.machine
        if spec is None:
            if mesh_shape is None:
                spec = mesh_lib.production_machine(multi_pod)
            else:
                return None, tuple(mesh_shape), tuple(axes)
        if mesh_shape is None:
            mesh_shape, axes = spec.mesh_spec()
        elif tuple(mesh_shape) != spec.mesh_shape:
            raise ValueError(f"mesh_shape {tuple(mesh_shape)} does not "
                             f"match machine {spec.name!r} "
                             f"({spec.mesh_shape})")
        return spec, tuple(mesh_shape), tuple(axes)

    # -- trace cache --------------------------------------------------------

    def _key(self, arch: str, shape: str, mesh_shape: Tuple[int, ...],
             axes: Tuple[str, ...], profile: str, grad_compress,
             overrides: Optional[Dict], device_order,
             machine: Optional[MachineSpec] = None) -> str:
        order_tag = None
        if device_order is not None:
            order = np.asarray(device_order, dtype=np.int64)
            order_tag = hashlib.sha256(order.tobytes()).hexdigest()[:16]
        payload = {"arch": arch, "shape": shape,
                   "mesh": list(mesh_shape), "axes": list(axes),
                   "profile": profile, "grad_compress": str(grad_compress),
                   "overrides": sorted((overrides or {}).items()),
                   "order": order_tag, "torch": torch.__version__,
                   "world": int(np.prod(mesh_shape)),
                   "machine": (machine.cache_token()
                               if machine is not None else None),
                   "src": _source_fingerprint()}
        return hashlib.sha256(
            json.dumps(payload, sort_keys=True).encode()).hexdigest()[:24]

    def _cache_path(self, key: str) -> str:
        return os.path.join(self.cache_dir, f"cell_{key}.npz")

    def _load(self, key: str) -> Optional[CellRecord]:
        if not self.cache_dir:
            return None
        path = self._cache_path(key)
        if not os.path.exists(path):
            return None
        try:
            with np.load(path, allow_pickle=False) as z:
                meta = json.loads(str(z["meta"]))
                traffic = np.asarray(z["traffic"])
            meta["mesh_shape"] = tuple(meta["mesh_shape"])
            meta["axes"] = tuple(meta["axes"])
            return CellRecord(**meta, traffic=traffic, cached=True)
        except Exception:     # corrupt or schema-stale entry: retrace
            return None

    def _store(self, key: str, rec: CellRecord) -> None:
        if not self.cache_dir:
            return
        os.makedirs(self.cache_dir, exist_ok=True)
        meta = dataclasses.asdict(rec)
        meta.pop("traffic")
        meta.pop("cached")
        path = self._cache_path(key)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez_compressed(f, meta=np.asarray(json.dumps(meta)),
                                traffic=np.asarray(rec.traffic))
        os.replace(tmp, path)             # atomic: readers never see halves

    # -- measure: one cell, cache-aware -----------------------------------

    def measure(self, arch_name: str, shape_name: str, *,
                mesh_shape: Optional[Sequence[int]] = None,
                axes: Optional[Sequence[str]] = None,
                multi_pod: bool = False, profile: str = "2d",
                grad_compress=False,
                overrides: Optional[Dict[str, Any]] = None,
                device_order: Optional[np.ndarray] = None,
                machine: Optional[Any] = None) -> CellRecord:
        """The traced-cell entry: a cache hit or a trace. Returns the
        :class:`CellRecord` of the cell traced on the mesh built with
        ``device_order`` (identity when None); ``mesh_shape`` / ``axes``
        default to the mesh of ``machine``."""
        spec, mesh_shape, axes = self._resolve_machine(
            machine, mesh_shape, axes, multi_pod)
        key = self._key(arch_name, shape_name, mesh_shape, axes, profile,
                        grad_compress, overrides, device_order, spec)
        rec = self._mem.get(key)
        if rec is None:
            rec = self._load(key)
            if rec is not None:
                self._mem[key] = rec
        if rec is not None:
            self.n_cache_hits += 1
            if self.verbose:
                print(f"[PLACE] cache hit {arch_name}/{shape_name}/"
                      f"{profile} key={key}", flush=True)
            return dataclasses.replace(rec, cached=True)
        rec = self._trace_and_measure(arch_name, shape_name, mesh_shape,
                                      axes, profile, grad_compress,
                                      overrides, device_order)
        self.n_compiles += 1
        self._mem[key] = rec
        self._store(key, rec)
        if self.verbose:
            print(f"[PLACE] traced {arch_name}/{shape_name}/{profile} "
                  f"in {rec.compile_s:.1f}s key={key}", flush=True)
        return rec

    def _trace_and_measure(self, arch_name, shape_name, mesh_shape, axes,
                           profile, grad_compress, overrides,
                           device_order) -> CellRecord:
        from repro_torch import configs
        from repro_torch.launch.steps import build_cell, rules_for

        arch = configs.get(arch_name)
        shape = arch.shapes[shape_name]
        order = (None if device_order is None
                 else np.asarray(device_order, dtype=np.int64))
        n = int(np.prod(mesh_shape))
        with mesh_lib.fake_world(n):
            mesh = self.build_mesh(mesh_shape, axes, order)
            rules = rules_for(arch.family, axes, profile=profile)
            cell = build_cell(arch, shape, rules,
                              grad_compress=grad_compress,
                              overrides=overrides)
            args = tuple(meta_dtensors(a, s, mesh) for a, s in
                         zip(cell["args"], cell["args_specs"]))
            scan_lengths = cell["scan_lengths"]
            rec, trace_s, cost = trace_step(cell["step"], args, mesh)
            del args, cell
        coll = parse_collectives(rec.records, n, traffic=True)
        return CellRecord(
            arch=arch_name, shape=shape_name, mesh_shape=tuple(mesh_shape),
            axes=tuple(axes), profile=profile,
            device_order=None if order is None else order.tolist(),
            compile_s=round(trace_s, 2),
            scan_lengths=list(scan_lengths),
            link=coll["link"], operand=coll["operand"],
            link_bf16=coll["link_bf16"], n_collectives=coll["count"],
            traffic=coll["traffic"], by_op=rec.by_op(),
            link_by_axis=coll["link_by_axis"], **fold_costs(cost))

    # -- place: the full searched-placement loop --------------------------

    def _search(self, mesh_shape, topo, traffic, warm_starts=None):
        return mapping.search(mesh_shape, topo, traffic,
                              warm_starts=warm_starts,
                              n_random=self.map_restarts,
                              recursive=self.recursive, seed=self.seed,
                              device=self.device)

    def place(self, arch_name: str, shape_name: str, *,
              mesh_shape: Optional[Sequence[int]] = None,
              axes: Optional[Sequence[str]] = None,
              multi_pod: bool = False, profile: str = "2d",
              grad_compress=False,
              overrides: Optional[Dict[str, Any]] = None,
              recompile: bool = False,
              machine: Optional[Any] = None) -> PlacementResult:
        """Trace (cache-aware), search the device order, optionally retrace
        under it to a fixed point; return record + report.

        The monotone guard keeps the best-seen order by the makespan of
        the latest measured schedule: every round's search carries the
        prior winner as a warm start, identity is always candidate 0, and
        if the final searched schedule still loses to identity's the
        report falls back to the identity order. ``machine`` supplies the
        mesh and the scored topology (tree machines search their F_l tree,
        routing machines go through the dense oracle)."""
        if recompile and self.max_rounds < 1:
            raise ValueError("recompile=True needs max_rounds >= 1: the "
                             "session never ships an order whose schedule "
                             "was not traced")
        spec, mesh_shape, axes = self._resolve_machine(
            machine, mesh_shape, axes, multi_pod)
        d = int(np.prod(mesh_shape))
        topo = (spec.topology() if spec is not None
                else topology.mesh_tree(mesh_shape))
        depths = _link_depths(topo)
        ident = np.arange(d)
        compiles0, hits0 = self.n_compiles, self.n_cache_hits

        rec0 = self.measure(arch_name, shape_name, mesh_shape=mesh_shape,
                            axes=axes, profile=profile,
                            grad_compress=grad_compress,
                            overrides=overrides, machine=spec)
        t0 = time.time()
        best = self._search(mesh_shape, topo, rec0.traffic)
        identity_side = _side_metrics(rec0.traffic, topo, ident, depths,
                                      self.device)
        best_order = np.asarray(best.device_to_bin, dtype=np.int64)
        if best.bottleneck >= identity_side["makespan"] * (1.0
                                                          - self.min_gain):
            best_order = ident            # sub-min_gain win: keep identity
        rounds: List[Dict[str, Any]] = [{
            "round": 0, "recompiled": False,
            "makespan": float(best.bottleneck
                              if not np.array_equal(best_order, ident)
                              else identity_side["makespan"]),
            "n_candidates": int(best.n_candidates),
            "order_changed": bool(not np.array_equal(best_order, ident))}]
        if np.array_equal(best_order, ident):
            axis_perm = list(range(len(mesh_shape)))
            axis_orders = [0] * len(mesh_shape)
        else:
            axis_perm = list(best.axis_perm)
            axis_orders = list(best.axis_orders)

        rec_s: Optional[CellRecord] = None
        fixed_point = True
        if recompile:
            for rnd in range(1, self.max_rounds + 1):
                if np.array_equal(best_order, ident):
                    rec_s = rec0          # identity's retrace is rec0
                    break
                rec_r = self.measure(arch_name, shape_name,
                                     mesh_shape=mesh_shape, axes=axes,
                                     profile=profile,
                                     grad_compress=grad_compress,
                                     overrides=overrides,
                                     device_order=best_order, machine=spec)
                rec_s = rec_r
                prev_cost = mapping.makespan_of_device_map(
                    rec_r.traffic, topo, best_order, device=self.device)
                cur = self._search(mesh_shape, topo, rec_r.traffic,
                                   warm_starts=[best_order])
                changed = not np.array_equal(cur.device_to_bin, best_order)
                improved = cur.bottleneck < prev_cost * (1.0 - self.min_gain)
                # adopt only while budget remains to retrace the new order
                adopt = changed and improved and rnd < self.max_rounds
                rounds.append({
                    "round": rnd, "recompiled": True,
                    "makespan": float(cur.bottleneck if adopt
                                      else prev_cost),
                    "n_candidates": int(cur.n_candidates),
                    "order_changed": bool(adopt)})
                if adopt:
                    best = cur
                    best_order = np.asarray(cur.device_to_bin,
                                            dtype=np.int64)
                    axis_perm = list(cur.axis_perm)
                    axis_orders = list(cur.axis_orders)
                else:
                    fixed_point = not (changed and improved)
                    break

        rec_for_side = rec_s if rec_s is not None else rec0
        searched_side = _side_metrics(rec_for_side.traffic, topo,
                                      best_order, depths, self.device)
        if searched_side["makespan"] > identity_side["makespan"]:
            # monotone guard: never ship an order that loses to identity
            best_order = ident
            axis_perm = list(range(len(mesh_shape)))
            axis_orders = [0] * len(mesh_shape)
            rec_for_side = rec0
            searched_side = dict(identity_side)
        diff = None
        if recompile:
            diff = schedule_diff(rec0, rec_for_side, topo, ident,
                                 best_order,
                                 recompiles=sum(r["recompiled"]
                                                for r in rounds),
                                 fixed_point=fixed_point,
                                 device=self.device)
        report = PlacementReport(
            arch=arch_name, shape=shape_name, profile=profile,
            mesh="x".join(str(s) for s in mesh_shape),
            identity=_json_sides(identity_side),
            searched=_json_sides(searched_side),
            makespan_ratio=(searched_side["makespan"]
                            / identity_side["makespan"]
                            if identity_side["makespan"] > 0 else 1.0),
            axis_perm=[int(p) for p in axis_perm],
            axis_orders=[int(o) for o in axis_orders],
            n_candidates=int(best.n_candidates),
            device_order=[int(x) for x in best_order],
            total_link_bytes=float(np.asarray(rec0.traffic).sum() / 2.0),
            search_s=round(time.time() - t0, 2),
            rounds=rounds, schedule_diff=diff,
            n_compiles=self.n_compiles - compiles0,
            cache_hits=self.n_cache_hits - hits0)
        return PlacementResult(record=rec0, report=report,
                               searched_record=rec_s if recompile else None)

    # -- verify: the static-analysis hook ---------------------------------

    def verify(self, *, kernels: bool = True, traffic: bool = True):
        """Static analysis over everything this session touches
        (``repro_torch.analysis``): the registered CUDA launch plans
        (bounds, coverage, write-race, shared-memory, co-residency and TMA
        proofs, ``analysis.kernels.verify_all``) and the traffic matrix of
        every cached :class:`CellRecord` (square, finite, non-negative,
        zero diagonal, symmetric). Returns the Finding list; ``--lint`` on
        the launchers gates on error severity."""
        from repro_torch.analysis import kernels as akernels
        from repro_torch.analysis import shard_lint
        findings = []
        if kernels:
            findings.extend(akernels.verify_all())
        if traffic:
            for rec in self._mem.values():
                findings.extend(shard_lint.lint_traffic(
                    np.asarray(rec.traffic),
                    subject=f"{rec.arch}/{rec.shape}/{rec.profile}"))
        return findings

    # -- map_step: place an already-built step (train / serve) ------------

    def map_step(self, step, step_args, mesh, scan_lengths: Sequence[int],
                 *, tag: str = "step",
                 machine: Optional[Any] = None) -> Tuple[Any, PlacementReport]:
        """Trace a caller-built step once on ``mesh`` (a ``DeviceMesh`` of
        the current process group, identity order; its arguments DTensors
        on it or plain tensors), search the logical -> physical order
        over ``machine`` (else the tree guessed from the mesh shape), and
        return the mapped mesh with the report. The trainer's
        ``searched_mesh`` and serve's ``--topology-aware`` wrap this.

        The trace runs on meta copies of the arguments (:func:`meta_like`:
        the same shapes, dtypes and placements, no storage), as the
        reference compiles its step without running it: a real probe
        would compute a whole step, and a decode step would write its
        cache. Every rank of a process group traces and searches the same
        step, and all of them take rank 0's result, so every rank builds
        the same mapped mesh: on cards the search's float ties break
        either way (``quotient_link_loads``' atomics)."""
        from repro_torch import tree as tree_lib
        mesh_shape = tuple(mesh.shape)
        n_dev = int(np.prod(mesh_shape))
        spec = machine_lib.resolve(machine) or self.machine
        if spec is not None and spec.n_devices != n_dev:
            raise ValueError(f"machine {spec.name!r} has "
                             f"{spec.n_devices} devices, mesh has {n_dev}")
        rec, trace_s, _ = trace_step(
            step, tree_lib.map_(meta_like, tuple(step_args)), mesh)
        coll = parse_collectives(rec.records, n_dev, traffic=True)
        self.n_compiles += 1
        topo = (spec.topology() if spec is not None
                else topology.mesh_tree(mesh_shape))
        depths = _link_depths(topo)
        t0 = time.time()
        best = self._search(mesh_shape, topo, coll["traffic"])
        ident = np.arange(n_dev)
        identity_side = _side_metrics(coll["traffic"], topo, ident, depths,
                                      self.device)
        if best.bottleneck >= identity_side["makespan"] * (1.0
                                                          - self.min_gain):
            best = dataclasses.replace(
                best, axis_perm=tuple(range(len(mesh_shape))),
                axis_orders=(0,) * len(mesh_shape),
                device_to_bin=ident, bottleneck=identity_side["makespan"])
        best = mesh_lib.from_rank0(best)
        searched_side = _side_metrics(coll["traffic"], topo,
                                      best.device_to_bin, depths,
                                      self.device)
        mapped = self.build_mesh(mesh_shape, mesh.mesh_dim_names,
                                 best.device_to_bin)
        report = PlacementReport(
            arch=tag, shape="", profile="",
            mesh="x".join(str(s) for s in mesh_shape),
            identity=_json_sides(identity_side),
            searched=_json_sides(searched_side),
            makespan_ratio=(searched_side["makespan"]
                            / identity_side["makespan"]
                            if identity_side["makespan"] > 0 else 1.0),
            axis_perm=[int(p) for p in best.axis_perm],
            axis_orders=[int(o) for o in best.axis_orders],
            n_candidates=int(best.n_candidates),
            device_order=[int(x) for x in best.device_to_bin],
            total_link_bytes=float(coll["traffic"].sum() / 2.0),
            search_s=round(time.time() - t0 + trace_s, 2),
            rounds=[{"round": 0, "recompiled": False,
                     "makespan": float(best.bottleneck),
                     "n_candidates": int(best.n_candidates),
                     "order_changed": bool(not np.array_equal(
                         best.device_to_bin, ident))}],
            schedule_diff=None, n_compiles=1, cache_hits=0)
        return mapped, report

    # -- map_pages: place a paged KV pool (serving) -----------------------

    def map_pages(self, traffic: np.ndarray, *,
                  node_weight: Optional[np.ndarray] = None,
                  n_devices: Optional[int] = None,
                  machine: Optional[Any] = None,
                  current: Optional[np.ndarray] = None,
                  seeds: int = 1):
        """Pages-as-rows placement for the serving KV pool.

        ``traffic`` is the measured [n_pages, n_pages] co-access matrix
        (``serving.PagedKVCache.page_traffic``), ``node_weight`` the
        per-page access counts; vertices are pages and the bins are the
        leaves of the machine tree (``machine``/session default, else
        ``guess_tree(n_devices)``), so the full multilevel partitioner
        optimizes exactly the paper's capacity-normalized makespan over
        hot pages. The matrix is linted first (square, finite, symmetric,
        zero diagonal) — a malformed matrix is a serving bug, not a
        placement preference.

        ``current`` (the live assignment) prices drift:
        ``drift_ratio = makespan(current on this traffic) /
        makespan(searched)``; the engine re-places when it exceeds
        ``1 + drift_threshold``. ``seeds`` is the partitioner's best-of-S
        refinement (``PartitionConfig.seeds``). Returns a
        ``serving.kv_cache.PagePlacement``.
        """
        from repro_torch.analysis import shard_lint
        from repro_torch.core import baselines
        from repro_torch.core.partitioner import PartitionConfig, partition
        from repro_torch.core.topology import guess_tree
        from repro_torch.graph.graph import from_edges
        from repro_torch.serving.kv_cache import PagePlacement

        t0 = time.perf_counter()
        traffic = np.asarray(traffic, dtype=np.float64)
        findings = shard_lint.lint_traffic(traffic, subject="page-traffic")
        errors = [f for f in findings if f.severity == "error"]
        if errors:
            raise ValueError("malformed page-traffic matrix: "
                             + "; ".join(f.message for f in errors))
        n = traffic.shape[0]
        spec = machine_lib.resolve(machine) or self.machine
        if spec is not None:
            topo = spec.tree()
        else:
            if not n_devices or n_devices < 1:
                raise ValueError("map_pages needs a machine or n_devices")
            topo = guess_tree(int(n_devices))
        if topo.bin_speed is not None and not (topo.bin_speed > 0).all():
            raise ValueError("zero-capacity bin reached the page mapper — "
                             "degrade() masks dead leaves; never zero a "
                             "bin_speed entry")
        k = topo.k
        nw = (np.asarray(node_weight, dtype=np.float64)
              if node_weight is not None else traffic.sum(axis=1))
        # every page gets a positive weight so cold pages still spread
        nw = np.maximum(nw, max(float(nw.max()), 1.0) * 1e-3)
        iu = np.triu_indices(n, 1)
        w = traffic[iu]
        nz = w > 0
        g = (from_edges(n, iu[0][nz], iu[1][nz], w[nz].astype(np.float32),
                        nw.astype(np.float32)) if nz.any() else None)
        if g is None or n <= k:
            # degenerate epochs (no co-access yet, or fewer pages than
            # bins): balanced contiguous blocks
            part = (np.arange(n) * k) // max(n, 1)
            makespan = (float(baselines.score_all(
                g, topo, part, device=self.device)["makespan"])
                if g is not None else 0.0)
        else:
            res = partition(g, topo, PartitionConfig(seed=self.seed,
                                                     seeds=seeds),
                            device=self.device)
            part, makespan = res.part, float(res.makespan)
        drift = float("inf")
        if current is not None:
            current = np.asarray(current)
            if current.shape != (n,):
                raise ValueError(f"current assignment must be [{n}], got "
                                 f"{list(current.shape)}")
            if g is None:
                drift = 1.0
            else:
                cur_ms = baselines.score_all(g, topo, current,
                                             device=self.device)["makespan"]
                drift = (float(cur_ms) / makespan if makespan > 0
                         else (1.0 if cur_ms <= 0 else float("inf")))
        self.n_map_pages += 1
        self.map_pages_s += time.perf_counter() - t0
        return PagePlacement(page_to_device=np.asarray(part,
                                                       dtype=np.int64),
                             n_devices=int(k), makespan=makespan,
                             drift_ratio=drift, replaced=False)
