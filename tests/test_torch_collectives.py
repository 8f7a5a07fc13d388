"""The port's collective accounting (``repro_torch.launch.collectives``)
against the reference's (``repro.launch.collectives``): the ring link-byte
model and the group traffic exactly, the device groups of each mesh dim
against the reference's HLO replica-group parser, hand-computed bytes of
toy DTensor programs on a (2, 4) fake mesh, and the one-axis invariant
against ``core.mapping.collective_traffic_matrix``."""
import numpy as np
import pytest
import torch

from repro.launch import collectives as rcol
from repro_torch.core import mapping
from repro_torch.launch import collectives as col
from repro_torch.launch import mesh as mesh_lib

OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
       "collective-permute")


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("s", [1, 2, 3, 16])
def test_link_bytes_equal_the_reference(op, s):
    assert col._link_bytes(op, 4096, s) == rcol._link_bytes(op, 4096, s)


def _random_groups(rng, d, s):
    return rng.permutation(d).reshape(-1, s)


@pytest.mark.parametrize("d,s", [(8, 2), (8, 4), (16, 8), (32, 1),
                                 (512, 16)])
def test_add_group_traffic_equals_the_reference(d, s):
    rng = np.random.default_rng(d + s)
    got, want = np.zeros((d, d)), np.zeros((d, d))
    for _ in range(3):
        groups = _random_groups(rng, d, s)
        b = float(rng.uniform(1, 1e9))
        col.add_group_traffic(got, groups, b)
        rcol.add_group_traffic(want, groups, b)
    np.testing.assert_array_equal(got, want)


# iota and explicit-list replica groups of each (2, 4) / (2, 2, 2) mesh dim
# as XLA writes them, and the mesh dims they slice
GROUP_CASES = [
    ((2, 4), ("model",), "replica_groups=[2,4]<=[8]"),
    ((2, 4), ("data",), "replica_groups=[4,2]<=[2,4]T(1,0)"),
    ((2, 4), ("data",), "replica_groups={{0,4},{1,5},{2,6},{3,7}}"),
    ((2, 4), ("data", "model"), "replica_groups=[1,8]<=[8]"),
    ((2, 2, 2), ("pod",), "replica_groups=[4,2]<=[2,4]T(1,0)"),
    ((2, 2, 2), ("data",), "replica_groups=[4,2]<=[2,2,2]T(0,2,1)"),
    ((2, 2, 2), ("model",), "replica_groups={{0,1},{2,3},{4,5},{6,7}}"),
    ((2, 2, 2), ("pod", "data"), "replica_groups=[2,4]<=[4,2]T(1,0)"),
]


@pytest.mark.parametrize("shape,dims,line", GROUP_CASES)
def test_groups_of_equal_the_reference_parser(shape, dims, line):
    axes = ("pod", "data", "model")[-len(shape):]
    n = int(np.prod(shape))
    want = rcol.materialize_groups(line, n)
    with mesh_lib.fake_world(n):
        mesh = mesh_lib.make_mapped_mesh(shape, axes)
        got = col.groups_of(mesh, dims if len(dims) > 1 else dims[0])
        if len(dims) == 1:
            name = mesh.get_group(axes.index(dims[0])).group_name
            np.testing.assert_array_equal(col.groups_of(mesh, name), got)
    np.testing.assert_array_equal(got, want)


def test_groups_of_follow_the_device_order():
    """A mapped mesh's groups are ranks of its grid: the order applied to
    the identity mesh's groups."""
    order = np.random.default_rng(0).permutation(8)
    with mesh_lib.fake_world(8):
        mesh = mesh_lib.make_mapped_mesh((2, 4), ("data", "model"), order)
        np.testing.assert_array_equal(
            col.groups_of(mesh, "model"),
            order[np.arange(8).reshape(2, 4)])
        np.testing.assert_array_equal(
            col.groups_of(mesh, "data"), order[np.arange(8).reshape(2, 4).T])


def _trace(fn, order=None):
    """Run ``fn(mesh)`` on a (2, 4) fake mesh under the recorder."""
    from torch.distributed.tensor.experimental import implicit_replication
    with mesh_lib.fake_world(8):
        mesh = mesh_lib.make_mapped_mesh((2, 4), ("data", "model"), order)
        rec = col.CollectiveRecorder(mesh)
        with implicit_replication(), rec:
            out = fn(mesh)
    return rec, out


def _dt(mesh, local, placements):
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local, mesh, placements, run_check=False)


def test_toy_programs_record_hand_computed_bytes():
    """f32 ``[8, 4]`` tensors on a (data=2, model=4) mesh: an all-gather
    over data (128 result bytes), an all-reduce over model of a partial
    (local 64 bytes), a reduce-scatter over model to rows (result 16
    bytes) and a shard-dim swap over model (all-to-all, result 16 bytes),
    each with its groups and the ring link bytes of the reference's
    model."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    def prog(mesh):
        x = _dt(mesh, torch.empty(4, 4, device="meta"),
                [Shard(0), Replicate()])
        x.redistribute(mesh, [Replicate(), Replicate()])        # gather
        p = _dt(mesh, torch.empty(4, 4, device="meta"),
                [Shard(0), Partial()])
        p.redistribute(mesh, [Shard(0), Replicate()])           # reduce
        p.redistribute(mesh, [Shard(0), Shard(0)])              # scatter
        y = _dt(mesh, torch.empty(4, 1, device="meta"),
                [Shard(0), Shard(1)])
        y.redistribute(mesh, [Shard(0), Shard(0)])              # swap

    rec, _ = _trace(prog)
    got = [(r["op"], r["bytes"], r["axis"], r["dtype"]) for r in rec.records]
    assert got == [("all-gather", 128, "data", "float32"),
                   ("all-reduce", 64, "model", "float32"),
                   ("reduce-scatter", 16, "model", "float32"),
                   ("all-to-all", 16, "model", "float32")]
    data = np.arange(8).reshape(2, 4).T
    np.testing.assert_array_equal(rec.records[0]["groups"], data)
    np.testing.assert_array_equal(rec.records[1]["groups"],
                                  np.arange(8).reshape(2, 4))
    out = col.parse_collectives(rec.records, 8)
    assert out["link"] == {"all-gather": 64.0, "all-reduce": 96.0,
                           "reduce-scatter": 48.0, "all-to-all": 12.0}
    assert out["operand"] == {"all-gather": 64.0, "all-reduce": 64.0,
                              "reduce-scatter": 64.0, "all-to-all": 16.0}
    assert out["link_bf16"] == out["link"] and out["count"] == 4
    assert out["link_by_axis"] == {
        "data": {"all-gather": 64.0},
        "model": {"all-reduce": 96.0, "reduce-scatter": 48.0,
                  "all-to-all": 12.0}}
    assert rec.by_op() == {"all-gather": 1, "all-reduce": 1,
                           "all-to-all": 1, "reduce-scatter": 1}


def _ops(records):
    return [(r["op"], r["bytes"], r["axis"]) for r in records]


@pytest.mark.parametrize("case", ["sequence", "heads"])
def test_meta_attention_records_what_the_plain_path_implies(case):
    """Attention on meta DTensors computes nothing but redistributes as
    the chunked path needs: under sequence parallelism (q, k and v [2, 8,
    *, 4] float32 with the batch over data and the sequence over model)
    k and v are gathered over model in the forward (local [1, 8, 2, 4]:
    256 bytes each) and their partial gradients reduce-scattered back in
    the backward (64 bytes each); with the heads of q over model and k, v
    whole there, the forward moves nothing and the k and v gradients
    (each device's share of the heads) are all-reduced (local [1, 8, 2,
    4]: 256 bytes)."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.kernels.flash_attention import attention
    on = Shard(1) if case == "sequence" else Shard(2)
    kv_on = Shard(1) if case == "sequence" else Replicate()

    def prog(mesh):
        q = _dt(mesh, torch.empty(1, *(
            (2, 4, 4) if case == "sequence" else (8, 1, 4)),
            device="meta"), [Shard(0), on]).requires_grad_()
        k, v = (_dt(mesh, torch.empty(1, *(
            (2, 2, 4) if case == "sequence" else (8, 2, 4)),
            device="meta"), [Shard(0), kv_on]).requires_grad_()
            for _ in range(2))
        out = attention(q, k, v)
        n = len(rec.records)
        grads = torch.autograd.grad(out, (q, k, v), torch.empty_like(out))
        return out, q, grads, n

    rec = None

    def run(mesh):
        nonlocal rec
        rec = col.CollectiveRecorder(mesh)
        with rec:
            return prog(mesh)

    _, (out, q, grads, n) = _trace(run)
    assert tuple(out.shape) == tuple(q.shape)
    assert tuple(out.placements) == tuple(q.placements)
    assert [tuple(g.placements) for g in grads] == [
        (Shard(0), on), (Shard(0), kv_on), (Shard(0), kv_on)]
    if case == "sequence":
        assert _ops(rec.records[:n]) == [("all-gather", 256, "model")] * 2
        assert _ops(rec.records[n:]) == [("reduce-scatter", 64, "model")] * 2
    else:
        assert n == 0
        assert _ops(rec.records) == [("all-reduce", 256, "model")] * 2


def test_meta_loss_records_the_vocab_parallel_reductions():
    """The chunked loss on meta DTensor logits [2, 8, 16] float32, batch
    over data and vocab over model: the row max, the sum of exponentials
    and the gold logit, each a float32 all-reduce over model of the local
    [1, 8] rows (32 bytes); the backward forms each vocab slice's gradient
    where it lies and moves nothing."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.models.common import cross_entropy

    def prog(mesh):
        logits = _dt(mesh, torch.empty(1, 8, 4, device="meta"),
                     [Shard(0), Shard(2)]).requires_grad_()
        labels = _dt(mesh, torch.empty(1, 8, dtype=torch.int32,
                                       device="meta"),
                     [Shard(0), Replicate()])
        loss = cross_entropy(logits, labels)
        n = len(rec.records)
        (g,) = torch.autograd.grad(loss, (logits,))
        return logits, g, n

    rec = None

    def run(mesh):
        nonlocal rec
        rec = col.CollectiveRecorder(mesh)
        with rec:
            return prog(mesh)

    _, (logits, g, n) = _trace(run)
    fwd = [r for r in rec.records[:n] if r["axis"] == "model"]
    assert _ops(fwd) == [("all-reduce", 32, "model")] * 3
    assert {r["dtype"] for r in fwd} == {"float32"}
    assert not [r for r in rec.records[n:] if r["axis"] == "model"]
    assert tuple(g.placements) == tuple(logits.placements)


def test_implicit_redistribution_inside_an_op_is_recorded():
    """A matmul whose operands disagree redistributes inside DTensor's
    dispatch, where a plain dispatch mode sees nothing: the recorder
    wraps the redistribution and sees its collectives."""
    from torch.distributed.tensor import Replicate, Shard

    def prog(mesh):
        x = _dt(mesh, torch.empty(4, 4, device="meta"),
                [Shard(0), Shard(1)])
        w = _dt(mesh, torch.empty(16, 2, device="meta"),
                [Replicate(), Shard(1)])
        return x @ w

    rec, _ = _trace(prog)
    assert rec.records and {r["op"] for r in rec.records} <= {
        "all-gather", "all-reduce", "reduce-scatter", "all-to-all"}


def test_recorder_restores_what_it_wraps():
    from torch.distributed.tensor import _dispatch, _redistribute, \
        placement_types
    before = (_dispatch.redistribute_local_tensor,
              _redistribute.redistribute_local_tensor,
              placement_types.shard_dim_alltoall)
    _trace(lambda mesh: None)
    assert (_dispatch.redistribute_local_tensor,
            _redistribute.redistribute_local_tensor,
            placement_types.shard_dim_alltoall) == before


@pytest.mark.parametrize("axis", [0, 1])
def test_one_axis_collective_matrix_is_the_ring_model_exactly(axis):
    """One collective along one mesh axis gives exactly
    ``collective_traffic_matrix``'s matrix for that axis's link bytes (the
    reference's own invariant)."""
    from torch.distributed.tensor import Replicate, Shard

    def prog(mesh):
        pl = [Replicate(), Replicate()]
        pl[axis] = Shard(0)
        _dt(mesh, torch.empty(6, 3, device="meta"), pl).redistribute(
            mesh, [Replicate(), Replicate()])

    rec, _ = _trace(prog)
    out = col.parse_collectives(rec.records, 8)
    (lb,) = out["link"].values()
    np.testing.assert_array_equal(
        out["traffic"], mapping.collective_traffic_matrix((2, 4),
                                                          {axis: lb}))


def test_traffic_is_logical_whatever_the_device_order():
    """A mesh in another order records the same logical traffic: index i
    is the mesh position, as the reference's partition ids are."""
    from torch.distributed.tensor import Replicate, Shard

    def prog(mesh):
        _dt(mesh, torch.empty(6, 3, device="meta"),
            [Shard(0), Shard(1)]).redistribute(
                mesh, [Replicate(), Replicate()])

    a, _ = _trace(prog)
    b, _ = _trace(prog, np.random.default_rng(1).permutation(8))
    np.testing.assert_array_equal(col.parse_collectives(a.records,
                                                        8)["traffic"],
                                  col.parse_collectives(b.records,
                                                        8)["traffic"])
