"""Declarative machine models: :class:`MachineSpec` and the preset registry.

The paper's machine is a tree with per-link cost factors ``F_l``; real
deployments add per-leaf compute/HBM capacities (heterogeneous PEs — the
load-balanced bottleneck objective normalizes bin loads by speed,
``comp(b)/speed(b)``) and come in more shapes than one TPU pod. A
``MachineSpec`` is the single declarative description the whole placement
stack consumes:

* ``topology()`` — the scored machine graph: a :class:`TreeTopology`
  (levels of link bandwidth, fat trees) or a :class:`RoutingTopology`
  (torus + routing oracle), with ``bin_speed`` attached when leaves are
  heterogeneous;
* ``mesh_spec()`` — the logical JAX mesh ``(shape, axes)`` whose row-major
  devices the topology's leaves back (``launch/mesh.py:make_mapped_mesh``);
* ``peak_flops`` / ``hbm_bw`` / ``link_bw`` — per-leaf roofline capacities
  (the dry-run sizes its compute/memory/collective terms per leaf, so a
  mixed-generation machine reports per-bin rooflines).

Presets (``MachineSpec.preset``): ``tpu_v5e-256`` / ``tpu_v5e-512``
reproduce the historical production machine bit-for-bit (same tree as
``topology.production_tree``, same constants as ``launch/mesh.py``),
``gpu-superpod`` wires ``topology.fat_tree_topology`` (NVLink leaves, IB
uplinks), ``torus-2d`` wires ``topology.torus2d_topology``, and
``tpu-mixed-32`` is a genuinely heterogeneous two-generation pod pair
(nonuniform leaf speeds). New machines are ``register()`` calls, not code
forks (DESIGN.md §Machine-models).

Numpy twin of ``repro/core/machine.py``: the same presets, ``resolve`` and
``degrade``, giving identical topology arrays. The port keeps its own copy so
it never imports the JAX package.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Dict, Optional, Tuple, Union

import numpy as np

from repro_torch.core.topology import (Topology, TreeTopology, balanced_tree,
                                 fat_tree_topology, mask_bins,
                                 torus2d_topology)


@dataclasses.dataclass(frozen=True)
class Level:
    """One level of a tree machine, root-side first: ``fanout`` children
    per node, links into this level running at ``gbps``."""
    name: str
    fanout: int
    gbps: float


@dataclasses.dataclass(frozen=True)
class MachineSpec:
    """Declarative machine model (frozen; register instances, don't subclass).

    ``kind`` selects the topology family:

    * ``"tree"`` — ``levels`` gives branching + per-level link bandwidth;
      ``F_l`` of a level is ``leaf_gbps / level_gbps`` (crossing a slow
      link costs proportionally more per byte), which reproduces the
      historical DCN/ICI asymmetry exactly;
    * ``"fat-tree"`` — ``topology.fat_tree_topology(n_devices,
      fat_tree_arity, uplink_speedup=fat_tree_uplink_speedup)``;
    * ``"torus2d"`` — ``topology.torus2d_topology(*torus)`` (a routing
      oracle, not a tree: small device counts only).

    ``leaf_tflops`` / ``leaf_hbm_gbps`` are either one number (uniform
    machine) or one per leaf, leaf order = tree leaf order = row-major
    logical mesh order. ``link_gbps`` is the leaf-level link bandwidth the
    roofline's collective term divides by.

    ``dead_leaves`` / ``link_degrade`` describe a *degraded* machine —
    normally produced by :meth:`degrade` from injected fault events, never
    written in a preset. Dead leaves are masked out of the scored topology
    (they become routers; ``k`` shrinks to the survivors, so zero capacity
    never reaches the partitioner), and degraded levels are repriced into
    the per-link cost factors (``F_l`` of a level at ``factor``× bandwidth
    grows by ``1/factor``). Both fields are part of ``cache_token()``, so
    a PlacementSession can never serve a healthy machine's cached
    placement for a degraded one.
    """

    name: str
    mesh_shape: Tuple[int, ...]
    axes: Tuple[str, ...]
    kind: str = "tree"
    levels: Tuple[Level, ...] = ()
    fat_tree_arity: int = 4
    fat_tree_uplink_speedup: float = 2.0
    torus: Optional[Tuple[int, int]] = None
    torus_multipath: bool = False
    leaf_tflops: Union[float, Tuple[float, ...]] = 197.0
    leaf_hbm_gbps: Union[float, Tuple[float, ...]] = 819.0
    link_gbps: float = 50.0
    dead_leaves: Tuple[int, ...] = ()
    link_degrade: Tuple[Tuple[str, float], ...] = ()

    def __post_init__(self):
        # canonicalize per-leaf capacities: any sequence (list, ndarray)
        # becomes a tuple so the isinstance(tuple) checks below, the
        # heterogeneous/bin_speed properties and cache_token all see one
        # representation — a list would otherwise be scored as a scalar
        for field in ("leaf_tflops", "leaf_hbm_gbps"):
            v = getattr(self, field)
            if not isinstance(v, (int, float, tuple)):
                object.__setattr__(self, field,
                                   tuple(float(x) for x in np.asarray(v)))
        d = self.n_devices
        if len(self.axes) != len(self.mesh_shape):
            raise ValueError(f"{self.name}: {len(self.mesh_shape)}-d mesh "
                             f"needs {len(self.mesh_shape)} axis names, got "
                             f"{self.axes}")
        if self.kind == "tree":
            leaves = int(np.prod([l.fanout for l in self.levels])) \
                if self.levels else 0
            if leaves != d:
                raise ValueError(f"{self.name}: tree levels give {leaves} "
                                 f"leaves, mesh has {d} devices")
        elif self.kind == "fat-tree":
            depth = max(int(np.ceil(np.log(d)
                                    / np.log(self.fat_tree_arity))), 1)
            if self.fat_tree_arity ** depth != d:
                raise ValueError(f"{self.name}: fat tree of arity "
                                 f"{self.fat_tree_arity} has "
                                 f"{self.fat_tree_arity ** depth} leaves, "
                                 f"mesh has {d} devices")
        elif self.kind == "torus2d":
            if self.torus is None or int(np.prod(self.torus)) != d:
                raise ValueError(f"{self.name}: torus {self.torus} does not "
                                 f"match {d} mesh devices")
            if self.heterogeneous:
                # RoutingTopology carries no bin_speed: nonuniform leaves
                # would be silently scored speed-blind downstream
                raise ValueError(f"{self.name}: torus machines do not "
                                 "support nonuniform leaf speeds yet")
        else:
            raise ValueError(f"{self.name}: unknown machine kind "
                             f"{self.kind!r}")
        for field in ("leaf_tflops", "leaf_hbm_gbps"):
            v = getattr(self, field)
            if isinstance(v, tuple) and len(v) != d:
                raise ValueError(f"{self.name}: {field} has {len(v)} "
                                 f"entries, mesh has {d} devices")
        # degradation state: canonical (sorted, unique), validated
        dead = tuple(sorted({int(x) for x in self.dead_leaves}))
        object.__setattr__(self, "dead_leaves", dead)
        if dead and (dead[0] < 0 or dead[-1] >= d):
            raise ValueError(f"{self.name}: dead leaves {dead} out of "
                             f"range for {d} devices")
        if len(dead) >= d:
            raise ValueError(f"{self.name}: all {d} leaves dead — no "
                             "survivors to place onto")
        deg = tuple(sorted((str(n), float(f)) for n, f in self.link_degrade))
        object.__setattr__(self, "link_degrade", deg)
        if deg:
            if self.kind != "tree":
                raise ValueError(f"{self.name}: link_degrade names tree "
                                 f"levels; {self.kind!r} machines have none")
            names = {l.name for l in self.levels}
            for n, f in deg:
                if n not in names:
                    raise ValueError(f"{self.name}: link_degrade level "
                                     f"{n!r} not in {sorted(names)}")
                if not (0.0 < f <= 1.0):
                    raise ValueError(f"{self.name}: link_degrade factor "
                                     f"for {n!r} must be in (0, 1], got {f}")
        if dead and self.kind == "torus2d":
            raise ValueError(f"{self.name}: torus machines cannot mask "
                             "dead leaves (RoutingTopology has no routers)")

    # -- sizes -------------------------------------------------------------

    @property
    def n_devices(self) -> int:
        return int(np.prod(self.mesh_shape))

    @property
    def n_alive(self) -> int:
        """Surviving leaves — the bin count the partitioner sees."""
        return self.n_devices - len(self.dead_leaves)

    def alive_leaves(self) -> np.ndarray:
        """[n_alive] original leaf indices of the survivors, ascending.
        Position in this array == bin index on the degraded topology."""
        return np.setdiff1d(np.arange(self.n_devices),
                            np.asarray(self.dead_leaves, dtype=np.int64))

    def mesh_spec(self) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
        """(shape, axis names) of the logical mesh this machine backs."""
        return self.mesh_shape, self.axes

    # -- per-leaf capacities ----------------------------------------------

    def _per_leaf(self, v: Union[float, Tuple[float, ...]],
                  unit: float) -> np.ndarray:
        arr = np.asarray(v if isinstance(v, tuple) else
                         [v] * self.n_devices, dtype=np.float64)
        return arr * unit

    @property
    def peak_flops(self) -> np.ndarray:
        """[D] peak FLOP/s per leaf."""
        return self._per_leaf(self.leaf_tflops, 1e12)

    @property
    def hbm_bw(self) -> np.ndarray:
        """[D] HBM bytes/s per leaf."""
        return self._per_leaf(self.leaf_hbm_gbps, 1e9)

    @property
    def link_bw(self) -> float:
        """Leaf-level link bytes/s (the roofline collective term)."""
        return self.link_gbps * 1e9

    @property
    def heterogeneous(self) -> bool:
        """Any per-leaf capacity nonuniform — compute OR HBM: either one
        makes per-bin rooflines (and the torus speed-blind guard) apply."""
        def nonuniform(v):
            return isinstance(v, tuple) and len(set(v)) > 1
        return nonuniform(self.leaf_tflops) or nonuniform(self.leaf_hbm_gbps)

    @property
    def bin_speed(self) -> Optional[np.ndarray]:
        """[D] relative leaf COMPUTE speeds (fastest = 1.0) for the
        capacity-normalized objective, or None when compute is uniform —
        the None path keeps uniform presets bit-for-bit on the historical
        speed-free code path. (HBM asymmetry shows up in the per-bin
        rooflines, not in comp(b)/speed(b).)"""
        if not (isinstance(self.leaf_tflops, tuple)
                and len(set(self.leaf_tflops)) > 1):
            return None
        speeds = np.asarray(self.leaf_tflops, dtype=np.float32)
        return speeds / speeds.max()

    # -- topology ----------------------------------------------------------

    def topology(self, F: float = 1.0) -> Topology:
        """The scored machine graph. Leaves in natural order back the
        row-major logical mesh devices. On a degraded spec, dead leaves
        are masked out (bin index = rank among survivors, k = n_alive)
        and degraded levels carry ``1/factor``× their nominal per-byte
        cost — the reference bandwidth stays the *nominal* leaf link, so
        degrading a level never cheapens another."""
        if self.kind == "tree":
            deg = dict(self.link_degrade)
            leaf_gbps = self.levels[-1].gbps
            cost = tuple(F * leaf_gbps / (l.gbps * deg.get(l.name, 1.0))
                         for l in self.levels)
            topo = balanced_tree(tuple(l.fanout for l in self.levels),
                                 F=F, level_cost=cost)
        elif self.kind == "fat-tree":
            topo = fat_tree_topology(
                self.n_devices, arity=self.fat_tree_arity, F=F,
                uplink_speedup=self.fat_tree_uplink_speedup)
        else:
            return torus2d_topology(self.torus[0], self.torus[1], F=F,
                                    multipath=self.torus_multipath)
        speed = self.bin_speed
        if speed is not None:
            topo = dataclasses.replace(topo, bin_speed=speed)
        if self.dead_leaves:
            topo = mask_bins(topo, self.dead_leaves)
        return topo

    def tree(self, F: float = 1.0) -> TreeTopology:
        topo = self.topology(F=F)
        if not isinstance(topo, TreeTopology):
            raise TypeError(f"machine {self.name!r} ({self.kind}) is not a "
                            "tree topology")
        return topo

    # -- degradation -------------------------------------------------------

    def degrade(self, events) -> "MachineSpec":
        """A new spec with the fault ``events`` applied (cumulative with
        any existing degradation). Events are anything with ``.kind`` /
        ``.target`` / ``.factor`` (``resilience.faults.FaultEvent``) or
        equivalent dicts:

        * ``leaf_death``   — adds ``target`` to ``dead_leaves``
          (idempotent); killing the last survivor raises;
        * ``link_degrade`` — multiplies the named level's bandwidth
          factor (two 0.5 degrades leave it at 0.25);
        * ``straggler``    — scales leaf ``target``'s ``leaf_tflops``,
          which flows into ``bin_speed`` / capacity-normalized loads
          (tree machines only — the torus carries no bin_speed).

        The result's ``cache_token()`` differs from the healthy spec's,
        so placement caches never serve stale placements.
        """
        dead = set(self.dead_leaves)
        link = dict(self.link_degrade)
        tflops = list(self.leaf_tflops) if isinstance(self.leaf_tflops,
                                                      tuple) \
            else [float(self.leaf_tflops)] * self.n_devices
        slowed = False
        for ev in events:
            if isinstance(ev, dict):
                kind, target = ev["kind"], ev["target"]
                factor = float(ev.get("factor", 1.0))
            else:
                kind, target, factor = ev.kind, ev.target, ev.factor
            if kind == "leaf_death":
                t = int(target)
                if not (0 <= t < self.n_devices):
                    raise ValueError(f"{self.name}: dead leaf {t} out of "
                                     f"range for {self.n_devices} devices")
                dead.add(t)
            elif kind == "link_degrade":
                link[str(target)] = link.get(str(target), 1.0) * factor
            elif kind == "straggler":
                t = int(target)
                if not (0 <= t < self.n_devices):
                    raise ValueError(f"{self.name}: straggler leaf {t} out "
                                     f"of range for {self.n_devices} "
                                     "devices")
                if not (0.0 < factor <= 1.0):
                    raise ValueError(f"{self.name}: straggler factor must "
                                     f"be in (0, 1], got {factor}")
                tflops[t] *= factor
                slowed = True
            else:
                raise ValueError(f"unknown fault kind {kind!r}")
        if len(dead) >= self.n_devices:
            raise ValueError(f"{self.name}: fault plan kills all "
                             f"{self.n_devices} leaves — nothing left to "
                             "place onto")
        new_tflops = tuple(tflops) if (slowed or isinstance(
            self.leaf_tflops, tuple)) else self.leaf_tflops
        return dataclasses.replace(
            self, dead_leaves=tuple(sorted(dead)),
            link_degrade=tuple(sorted(link.items())),
            leaf_tflops=new_tflops)

    # -- identity ----------------------------------------------------------

    def cache_token(self) -> str:
        """Stable short token folded into placement cache keys: covers
        every field, so editing a registered machine invalidates records
        keyed under its name."""
        payload = dataclasses.asdict(self)
        h = hashlib.sha256(
            json.dumps(payload, sort_keys=True).encode()).hexdigest()[:12]
        return f"{self.name}:{h}"

    # -- registry ----------------------------------------------------------

    @classmethod
    def preset(cls, name: str) -> "MachineSpec":
        try:
            return _REGISTRY[name]
        except KeyError:
            raise KeyError(f"unknown machine preset {name!r}; available: "
                           f"{', '.join(sorted(_REGISTRY))}") from None

    @classmethod
    def presets(cls) -> Tuple[str, ...]:
        return tuple(sorted(_REGISTRY))


_REGISTRY: Dict[str, MachineSpec] = {}


def register(spec: MachineSpec, overwrite: bool = False) -> MachineSpec:
    """Add a machine to the preset registry (``--machine <name>`` in the
    launchers). Re-registering a name requires ``overwrite=True``."""
    if spec.name in _REGISTRY and not overwrite:
        raise ValueError(f"machine {spec.name!r} already registered")
    _REGISTRY[spec.name] = spec
    return spec


def resolve(machine: Union[None, str, MachineSpec]) -> Optional[MachineSpec]:
    """CLI front: a preset name, an already-built spec, or None."""
    if machine is None or isinstance(machine, MachineSpec):
        return machine
    return MachineSpec.preset(machine)


def machine_for_devices(n: int) -> Optional[MachineSpec]:
    """The production machine a bare device count implies (the serving
    entry point's auto-match), or None. Only the TPU production presets
    auto-match — other presets must be named explicitly."""
    for name in ("tpu_v5e-512", "tpu_v5e-256"):
        spec = _REGISTRY[name]
        if spec.n_devices == n:
            return spec
    return None


# ---------------------------------------------------------------------------
# Presets
# ---------------------------------------------------------------------------

# TPU v5e-class pods — the historical production machine (DESIGN.md §6).
# Tree and constants reproduce topology.production_tree / launch/mesh.py
# bit-for-bit: DCN 6.25 GB/s vs ICI 50 GB/s -> F_l = 8 on cross-pod links.
_V5E = dict(leaf_tflops=197.0, leaf_hbm_gbps=819.0, link_gbps=50.0)

register(MachineSpec(
    name="tpu_v5e-256", mesh_shape=(16, 16), axes=("data", "model"),
    levels=(Level("dcn", 1, 6.25), Level("ici-row", 16, 50.0),
            Level("ici", 16, 50.0)), **_V5E))

register(MachineSpec(
    name="tpu_v5e-512", mesh_shape=(2, 16, 16),
    axes=("pod", "data", "model"),
    levels=(Level("dcn", 2, 6.25), Level("ici-row", 16, 50.0),
            Level("ici", 16, 50.0)), **_V5E))

# GPU superpod: 8 nodes x 8 GPUs, NVLink (450 GB/s) inside a node, IB
# (100 GB/s per GPU) between nodes — wired through fat_tree_topology:
# uplink_speedup = 100/450 makes the node->spine links 4.5x the per-byte
# cost of an NVLink hop.
register(MachineSpec(
    name="gpu-superpod", mesh_shape=(8, 8), axes=("data", "model"),
    kind="fat-tree", fat_tree_arity=8,
    fat_tree_uplink_speedup=100.0 / 450.0,
    leaf_tflops=989.0, leaf_hbm_gbps=3350.0, link_gbps=450.0))

# 2D torus with X-then-Y dimension-ordered routing (the BlueGene-style
# interconnect of the paper's related work) — a RoutingTopology, scored
# through the routing oracle rather than the tree identity.
register(MachineSpec(
    name="torus-2d", mesh_shape=(8, 8), axes=("data", "model"),
    kind="torus2d", torus=(8, 8),
    leaf_tflops=100.0, leaf_hbm_gbps=400.0, link_gbps=25.0))

# Mixed-generation pod pair: pod 0 is v5e-class, pod 1 an older 123 TF /
# 512 GB/s generation — nonuniform leaf speeds exercise the paper's
# heterogeneous-PE objective (comp(b)/speed(b)) end to end.
register(MachineSpec(
    name="tpu-mixed-32", mesh_shape=(2, 4, 4),
    axes=("pod", "data", "model"),
    levels=(Level("dcn", 2, 6.25), Level("ici-row", 4, 50.0),
            Level("ici", 4, 50.0)),
    leaf_tflops=tuple([197.0] * 16 + [123.0] * 16),
    leaf_hbm_gbps=tuple([819.0] * 16 + [512.0] * 16),
    link_gbps=50.0))
