"""Machine topologies for the graph-constrained makespan partitioning problem.

The paper's base formulation takes a tree ``C = (B, L)``; generalizations add
routers (bins with zero compute capacity), per-link cost factors ``F_l``, and
non-tree routing graphs with a routing oracle (optionally multipath).

Numpy twin of ``repro/core/topology.py`` (the port keeps its own copy so it
never imports the JAX package; every array is identical for the same inputs).

Accelerator-friendly representation: for trees we never materialize per-pair paths.
Link ``l`` (the edge between node ``c`` and ``parent(c)``) lies on
``path(i, j)`` iff exactly one of ``i, j`` is in ``subtree(c)``, so the whole
objective reduces to GEMMs against the subtree indicator ``S`` (see
``objective.py``). For non-tree routing oracles we store sparse padded
per-pair link tables (``RoutingTopology.path_links`` / ``path_frac``); the
dense fractional incidence tensor ``R[i, j, l]`` is an on-demand derived view
for small machines only.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Union

import numpy as np


@dataclasses.dataclass(frozen=True)
class TreeTopology:
    """Tree machine model.

    Nodes ``0..n_nodes-1``; ``parent[root] = -1``. Compute bins are the
    non-router nodes (typically the leaves); routers are the paper's
    interconnect generalization. ``link_cost[c]`` is the per-unit cost factor
    ``F_l`` of the link (c, parent[c]) — the edge-weighted generalization; the
    basic problem uses ``F_l = F`` for all links.
    """

    parent: np.ndarray        # [n_nodes] int32
    is_router: np.ndarray     # [n_nodes] bool
    link_cost: np.ndarray     # [n_nodes] float32; entry at root unused
    # Derived (built by __post_init__ helpers):
    compute_bins: np.ndarray  # [k] node ids that can take load
    subtree: np.ndarray       # [n_links, k] float32 indicator
    link_nodes: np.ndarray    # [n_links] child-node id of each link
    F_l: np.ndarray           # [n_links] float32 per-link cost factors
    # Heterogeneous PEs (core/machine.py): relative per-bin compute speed.
    # None = uniform machine, the exact historical code path; when set, the
    # objective normalizes bin loads to comp(b)/speed(b) (the paper's
    # load-balanced bottleneck objective for heterogeneous processors).
    bin_speed: Optional[np.ndarray] = None  # [k] float32, fastest = 1.0

    @property
    def n_nodes(self) -> int:
        return int(self.parent.shape[0])

    @property
    def n_links(self) -> int:
        return int(self.link_nodes.shape[0])

    @property
    def k(self) -> int:
        return int(self.compute_bins.shape[0])

    def depth(self, node: int) -> int:
        d = 0
        while self.parent[node] >= 0:
            node = int(self.parent[node])
            d += 1
        return d

    def children(self, node: int) -> np.ndarray:
        return np.nonzero(self.parent == node)[0]

    def leaves_under(self, node: int) -> np.ndarray:
        """Compute bins in the subtree rooted at ``node`` (in bin index space)."""
        in_sub = _subtree_mask(self.parent, node)
        return np.nonzero(in_sub[self.compute_bins])[0]

    def distance_matrix(self) -> np.ndarray:
        """[k, k] cost-weighted tree distance between compute bins:
        ``dist[a, b] = sum_{l in path(a,b)} F_l``. Via the XOR identity."""
        S, f = self.subtree, self.F_l[:, None]
        u = (f * S).sum(0)                      # [k]
        cross = S.T @ (f * S)                   # [k, k]
        return u[:, None] + u[None, :] - 2.0 * cross

    def node_subtree_indicator(self) -> np.ndarray:
        """[n_links, n_nodes] float32: node j lies in the subtree hanging
        below link l (i.e. below-or-at the link's child node). The node-level
        analogue of ``subtree``, used by the batched permutation scorer's
        LCA bucketing (objective.permutation_link_loads_batch)."""
        A = np.zeros((self.n_links, self.n_nodes), dtype=np.float32)
        for li, c in enumerate(self.link_nodes):
            A[li] = _subtree_mask(self.parent, int(c))
        return A

    def ancestry_matrix(self) -> np.ndarray:
        """[n_nodes, k] bool: node i is an ancestor-or-self of compute bin j."""
        A = np.zeros((self.n_nodes, self.k), dtype=bool)
        for c in range(self.n_nodes):
            A[c] = _subtree_mask(self.parent, c)[self.compute_bins]
        return A

    def lca_table(self) -> np.ndarray:
        """[k, k] int32: node id of the lowest common ancestor of each pair
        of compute bins. Diagonal holds the bin's own node id."""
        A = self.ancestry_matrix()
        depth = np.asarray([self.depth(c) for c in range(self.n_nodes)])
        out = np.empty((self.k, self.k), dtype=np.int32)
        for vi in range(self.k):
            anc = np.nonzero(A[:, vi])[0]        # ancestors-or-self of bin vi
            order = anc[np.argsort(depth[anc], kind="stable")]
            common = A[order]                    # [d_v, k] shallow -> deep
            deepest = (common *
                       np.arange(1, order.size + 1)[:, None]).argmax(axis=0)
            out[vi] = order[deepest]
        return out


def _subtree_mask(parent: np.ndarray, node: int) -> np.ndarray:
    n = parent.shape[0]
    mask = np.zeros(n, dtype=bool)
    mask[node] = True
    # parent[] is arbitrary order; iterate to fixpoint (tree depth bounded)
    for _ in range(n):
        new = mask.copy()
        valid = parent >= 0
        new[valid] |= mask[parent[valid]]
        if (new == mask).all():
            break
        mask = new
    return mask


def make_tree(parent: Sequence[int], is_router: Optional[Sequence[bool]] = None,
              link_cost: Optional[Sequence[float]] = None, F: float = 1.0) -> TreeTopology:
    parent = np.asarray(parent, dtype=np.int32)
    n = parent.shape[0]
    roots = np.nonzero(parent < 0)[0]
    if roots.shape[0] != 1:
        raise ValueError(f"tree must have exactly one root, got {roots}")
    if is_router is None:
        # default: internal nodes are routers, leaves compute
        has_child = np.zeros(n, dtype=bool)
        has_child[parent[parent >= 0]] = True
        is_router = has_child
    is_router = np.asarray(is_router, dtype=bool)
    if link_cost is None:
        link_cost = np.full(n, F, dtype=np.float32)
    link_cost = np.asarray(link_cost, dtype=np.float32)
    compute_bins = np.nonzero(~is_router)[0].astype(np.int32)
    if compute_bins.shape[0] == 0:
        raise ValueError("topology has no compute bins")
    link_nodes = np.nonzero(parent >= 0)[0].astype(np.int32)
    S = np.zeros((link_nodes.shape[0], compute_bins.shape[0]), dtype=np.float32)
    for li, c in enumerate(link_nodes):
        S[li] = _subtree_mask(parent, int(c))[compute_bins]
    return TreeTopology(
        parent=parent, is_router=is_router, link_cost=link_cost,
        compute_bins=compute_bins, subtree=S, link_nodes=link_nodes,
        F_l=link_cost[link_nodes],
    )


def with_bin_speed(topo: TreeTopology, speed: Sequence[float]) -> TreeTopology:
    """Attach relative per-bin compute speeds to a tree (heterogeneous
    PEs). Speeds are normalized so the fastest bin is 1.0 — ``comp(b) /
    speed(b)`` then stays in the same units as the uniform objective."""
    s = np.asarray(speed, dtype=np.float32)
    if s.shape != (topo.k,):
        raise ValueError(f"speed has shape {s.shape}, topology has "
                         f"{topo.k} bins")
    if not (s > 0).all():
        raise ValueError("bin speeds must be positive")
    return dataclasses.replace(topo, bin_speed=s / s.max())


def mask_bins(topo: TreeTopology, dead_bins: Sequence[int]) -> TreeTopology:
    """Remove compute bins (dead leaves) from a tree: the dead nodes become
    routers — zero-capacity bins never reach the partitioner — and the
    derived structures (``compute_bins``, ``subtree``, ``F_l``) are rebuilt
    so ``k`` shrinks to the survivor count. ``dead_bins`` is in *bin index*
    space (0..k-1). ``bin_speed`` is subset to survivors and renormalized
    (fastest survivor = 1.0), keeping ``comp(b)/speed(b)`` in the uniform
    objective's units on the degraded machine."""
    dead = np.unique(np.asarray(list(dead_bins), dtype=np.int64))
    if dead.size == 0:
        return topo
    if dead.size and (dead.min() < 0 or dead.max() >= topo.k):
        raise ValueError(f"dead bins {dead.tolist()} out of range for a "
                         f"{topo.k}-bin tree")
    if dead.size >= topo.k:
        raise ValueError("cannot mask every compute bin: no survivors")
    is_router = topo.is_router.copy()
    is_router[topo.compute_bins[dead]] = True
    masked = make_tree(topo.parent, is_router=is_router,
                       link_cost=topo.link_cost)
    if topo.bin_speed is not None:
        alive = np.setdiff1d(np.arange(topo.k), dead)
        masked = with_bin_speed(masked, topo.bin_speed[alive])
    return masked


def flat_topology(k: int, F: float = 1.0) -> TreeTopology:
    """Star: one router root, k compute leaves. Equivalent to classic k-way
    partitioning where comm(l) is the communication volume of bin l."""
    parent = np.concatenate([[-1], np.zeros(k, dtype=np.int64)])
    return make_tree(parent, F=F)


def balanced_tree(branching: Sequence[int], F: float = 1.0,
                  level_cost: Optional[Sequence[float]] = None) -> TreeTopology:
    """Balanced hierarchy, e.g. ``branching=(2, 16, 16)`` = 2 pods x 16 rows x
    16 chips. ``level_cost[i]`` is F_l for links from level i to level i+1
    nodes (root = level 0); defaults to F everywhere."""
    parent: List[int] = [-1]
    level_nodes = [[0]]
    for lvl, b in enumerate(branching):
        nxt = []
        for p in level_nodes[-1]:
            for _ in range(b):
                parent.append(p)
                nxt.append(len(parent) - 1)
        level_nodes.append(nxt)
    parent_arr = np.asarray(parent, dtype=np.int32)
    cost = np.full(len(parent), F, dtype=np.float32)
    if level_cost is not None:
        for lvl, nodes in enumerate(level_nodes[1:]):
            cost[np.asarray(nodes)] = level_cost[min(lvl, len(level_cost) - 1)]
    return make_tree(parent_arr, link_cost=cost, F=F)


# Production machine model (DESIGN.md §6): TPU v5e-class pods.
#   root -(DCN)- pod -(ICI row links)- row -(ICI chip links)- chip
# F_l is cost per byte relative to compute cost of one vertex; the DCN/ICI
# asymmetry is what makes pod-aware mapping matter.
ICI_GBPS = 50.0
DCN_GBPS = 6.25


def production_tree(n_pods: int = 2, rows: int = 16, chips: int = 16,
                    F: float = 1.0) -> TreeTopology:
    rel = ICI_GBPS / DCN_GBPS
    return balanced_tree((n_pods, rows, chips), F=F,
                         level_cost=(F * rel, F, F))


def mesh_tree(mesh_shape: Sequence[int], F: float = 1.0) -> TreeTopology:
    """Machine tree whose leaves (in natural order) back a production mesh:
    the multi-pod (2, 16, 16) mesh gets the two-pod tree with the expensive
    DCN level, the single-pod (16, 16) mesh the one-pod tree. This is the
    topology ``core.mapping.search_mesh_mapping`` scores against when the
    dry-run picks the logical -> physical device order (DESIGN.md §6)."""
    shape = tuple(mesh_shape)
    if len(shape) == 3:
        return production_tree(shape[0], shape[1], shape[2], F=F)
    if len(shape) == 2:
        return production_tree(1, shape[0], shape[1], F=F)
    if len(shape) == 1:
        return guess_tree(shape[0], F=F)
    raise ValueError(f"no machine tree for mesh shape {shape}")


def guess_tree(n: int, F: float = 1.0) -> TreeTopology:
    """Best-effort machine tree for ``n`` local devices (the launcher's
    ``--topology-aware`` path, where no pod structure is known): the largest
    divisor split (a, n // a) with a <= sqrt(n) as an asymmetric two-level
    tree — upper links carry the DCN-like cost so mapping has something to
    optimize — falling back to the flat star for prime or single counts."""
    best = 1
    a = 2
    while a * a <= n:
        if n % a == 0:
            best = a
        a += 1
    if best == 1:
        return flat_topology(max(n, 1), F=F)
    rel = ICI_GBPS / DCN_GBPS
    return balanced_tree((best, n // best), F=F, level_cost=(F * rel, F))


# Dense [k, k, L] materialization guard: path_incidence is a derived view
# for small-machine reference paths only; past this entry count the sparse
# tables are the ONLY representation (a 16x16 torus is ~34M entries; a
# 32x32 torus would be 2.1G — the exact blow-up the sparse oracle removes).
DENSE_INCIDENCE_MAX = 1 << 28


@dataclasses.dataclass(frozen=True)
class RoutingTopology:
    """Routing-graph generalization: arbitrary interconnect + routing oracle.

    Sparse-first representation: the routing oracle is a padded per-link
    incidence table — ``path_links[i, j, :]`` lists the link ids on
    ``path(i, j)`` (padded with the sentinel ``n_links``) and
    ``path_frac[i, j, p]`` the fraction of (i, j) traffic each carries
    (1.0 for single-path oracles; fractions sum per shared link for
    multipath). Storage is ``O(k^2 * max_path)`` instead of the dense
    ``[k, k, L]`` incidence tensor, which for a torus grows as the 6th
    power of the side — the sparse tables are what lets ``torus-2d``-style
    machines scale past a few hundred devices (``core.mapping`` scores
    candidate batches with one flat ``segment_sum`` over these tables).

    ``path_incidence`` is still available as an on-demand dense view for
    the small-machine reference paths (``reference.makespan_routing_ref``,
    ``objective.link_loads_routing``); it raises past
    ``DENSE_INCIDENCE_MAX`` entries rather than silently allocating GBs.
    """

    k: int
    n_links: int
    path_links: np.ndarray      # [k, k, P] int32, padded with n_links
    path_frac: np.ndarray       # [k, k, P] float32, 0 on padding
    F_l: np.ndarray             # [L] float32

    @property
    def max_path(self) -> int:
        return int(self.path_links.shape[2])

    @property
    def path_incidence(self) -> np.ndarray:
        """Dense ``[k, k, L]`` fractional incidence, materialized on demand
        (and cached) for small machines; the scoring hot paths never call
        this — they run on the sparse tables directly."""
        cached = self.__dict__.get("_dense_incidence")
        if cached is not None:
            return cached
        if self.k * self.k * self.n_links > DENSE_INCIDENCE_MAX:
            raise MemoryError(
                f"dense [k, k, L] incidence of {self.k}x{self.k}x"
                f"{self.n_links} exceeds {DENSE_INCIDENCE_MAX} entries — "
                "use the sparse path tables (path_links/path_frac)")
        R = np.zeros((self.k, self.k, self.n_links), dtype=np.float32)
        i, j, p = np.nonzero(self.path_links < self.n_links)
        np.add.at(R, (i, j, self.path_links[i, j, p]),
                  self.path_frac[i, j, p])
        object.__setattr__(self, "_dense_incidence", R)
        return R

    def distance_matrix(self) -> np.ndarray:
        f = np.append(self.F_l.astype(np.float64), 0.0)  # sentinel costs 0
        return (f[self.path_links] * self.path_frac).sum(axis=2)


# A machine graph the objective/mapping layers can score: the tree
# identity path or the dense routing-oracle path (small bin counts).
Topology = Union[TreeTopology, RoutingTopology]


def routing_from_paths(k: int, n_links: int,
                       paths: dict, F_l: Optional[np.ndarray] = None) -> RoutingTopology:
    """``paths[(i, j)]`` is a list of paths, each a list of link ids; traffic
    splits evenly across the listed paths (multipath oracle). Fractions are
    aggregated per (pair, link) — a link shared by several of a pair's paths
    appears once with the summed fraction — then laid out as the padded
    ``[k, k, P]`` tables (P = longest aggregated link set)."""
    per_pair: dict = {}
    for (i, j), plist in paths.items():
        acc = per_pair.setdefault((i, j), {})
        for p in plist:
            for l in p:
                acc[l] = acc.get(l, 0.0) + 1.0 / len(plist)
    max_path = max((len(a) for a in per_pair.values()), default=0)
    max_path = max(max_path, 1)
    links = np.full((k, k, max_path), n_links, dtype=np.int32)
    fracs = np.zeros((k, k, max_path), dtype=np.float32)
    for (i, j), acc in per_pair.items():
        ls = np.fromiter(acc.keys(), dtype=np.int32, count=len(acc))
        fs = np.fromiter(acc.values(), dtype=np.float32, count=len(acc))
        links[i, j, :ls.size] = links[j, i, :ls.size] = ls
        fracs[i, j, :fs.size] = fracs[j, i, :fs.size] = fs
    if F_l is None:
        F_l = np.ones(n_links, dtype=np.float32)
    return RoutingTopology(k=k, n_links=n_links, path_links=links,
                           path_frac=fracs,
                           F_l=np.asarray(F_l, dtype=np.float32))


def torus2d_topology(nx: int, ny: int, F: float = 1.0,
                     multipath: bool = False) -> RoutingTopology:
    """2D torus with X-then-Y dimension-ordered routing (the BlueGene-style
    interconnect of the paper's related work). With ``multipath`` the oracle
    returns both X-then-Y and Y-then-X, splitting traffic 1/2 each."""
    k = nx * ny
    # links: for each node, +x and +y ring links
    def node(x, y):
        return (x % nx) * ny + (y % ny)

    link_id = {}
    for x in range(nx):
        for y in range(ny):
            link_id[("x", x, y)] = len(link_id)   # node(x,y) -> node(x+1,y)
            link_id[("y", x, y)] = len(link_id)   # node(x,y) -> node(x,y+1)

    def ring_hops(a, b, n):
        """Shortest ring direction from a to b: list of (start, step)."""
        fwd = (b - a) % n
        bwd = (a - b) % n
        hops = []
        if fwd <= bwd:
            for t in range(fwd):
                hops.append(((a + t) % n, +1))
        else:
            for t in range(bwd):
                hops.append(((a - t - 1) % n, +1))  # link stored at lower end
        return hops

    def route(ax, ay, bx, by, order):
        links = []
        cx, cy = ax, ay
        for dim in order:
            if dim == "x":
                for (pos, _s) in ring_hops(cx, bx, nx):
                    links.append(link_id[("x", pos, cy)])
                cx = bx
            else:
                for (pos, _s) in ring_hops(cy, by, ny):
                    links.append(link_id[("y", cx, pos)])
                cy = by
        return links

    paths = {}
    for a in range(k):
        for b in range(a + 1, k):
            ax, ay, bx, by = a // ny, a % ny, b // ny, b % ny
            ps = [route(ax, ay, bx, by, "xy")]
            if multipath:
                alt = route(ax, ay, bx, by, "yx")
                if alt != ps[0]:
                    ps.append(alt)
            paths[(a, b)] = ps
    return routing_from_paths(k, len(link_id), paths,
                              F_l=np.full(len(link_id), F, dtype=np.float32))


def fat_tree_topology(k: int, arity: int = 4, F: float = 1.0,
                      uplink_speedup: float = 2.0) -> TreeTopology:
    """Fat tree as an F_l-weighted TreeTopology: links nearer the root have
    ``uplink_speedup``x the capacity per level (lower cost factor)."""
    levels = []
    n = k
    while n > 1:
        n = int(np.ceil(n / arity))
        levels.append(n)
    branching = []
    prev = 1
    for n in reversed(levels):
        branching.append(int(np.ceil(n / prev)) if prev else n)
        prev = n
    # simpler: balanced tree with ceil(log_arity k) levels of `arity`
    depth = max(int(np.ceil(np.log(k) / np.log(arity))), 1)
    branching = [arity] * depth
    cost = [F / (uplink_speedup ** (depth - 1 - i)) for i in range(depth)]
    topo = balanced_tree(branching, F=F, level_cost=cost)
    return topo
