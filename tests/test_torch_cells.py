"""Every non-skip cell of ``configs.all_cells()`` through the port's
``launch.steps.build_cell`` and the placement session's trace: the LMs
(dense GQA and MoE + MLA), the GNNs (EquiformerV2 with positions) and the
two-tower model, under each sharding profile of the arch, each train cell
also with ``grad_compress``, on a (2, 4) fake world at tiny overrides (a
DeepSeek cut keeps 2 layers, so its MoE layer is in). The records are
held against the reference's in ``tests/test_torch_cells_reference.py``."""
import pytest
import torch

from repro_torch import configs, tree
from repro_torch.analysis import shard_lint
from repro_torch.launch import placement as pl
from repro_torch.launch.steps import build_cell, rules_for

TINY = {"lm": {"n_layers": 2, "batch": 2, "seq": 16},
        "gnn": {"n_layers": 1, "n": 1024, "arcs": 2048},
        "recsys": {"batch": 64, "n_cand": 4096}}
EQUIFORMER = {"channels": 16, "l_max": 2}
SESSION = pl.PlacementSession(cache_dir="", map_restarts=2, device="cpu")


def tiny(arch: str):
    a = configs.get(arch)
    return dict(TINY[a.family], **(EQUIFORMER if a.name == "equiformer-v2"
                                   else {}))


def _cells():
    for arch, shape in configs.all_cells():
        if shape.kind == "skip":
            continue
        for profile in arch.profiles:
            for gc in ((False, True) if shape.kind == "train" else (False,)):
                yield pytest.param(
                    arch.name, shape.name, profile, gc,
                    id=f"{arch.name}/{shape.name}/{profile}"
                       + ("/grad_compress" if gc else ""))


@pytest.mark.parametrize("arch,shape,profile,grad_compress", list(_cells()))
def test_every_cell_builds_and_traces(arch, shape, profile, grad_compress):
    rec = SESSION.measure(arch, shape, mesh_shape=(2, 4),
                          axes=("data", "model"), profile=profile,
                          grad_compress=grad_compress, overrides=tiny(arch))
    assert rec.n_collectives > 0 and rec.traffic.shape == (8, 8)
    assert rec.agg_flops > 0
    assert not [f for f in shard_lint.lint_traffic(
        rec.traffic, subject=f"{arch}/{shape}") if f.severity == "error"]


def test_the_profiles_are_the_reference_grids():
    """Every LM traces under the four profiles, the GNNs and the two-tower
    model under 2d, as the reference's registry says."""
    from repro import configs as rconfigs
    for arch in configs.REGISTRY.values():
        assert arch.profiles == rconfigs.get(arch.name).profiles, arch.name
    n = sum(len(a.profiles) * (2 if s.kind == "train" else 1)
            for a, s in configs.all_cells() if s.kind != "skip")
    assert n == 117


def test_grad_compress_takes_the_residual_as_third_argument():
    """The reference's ``_with_compress_state``: (params, opt_state,
    compress_state, batch), the residual float32 and placed like the
    parameters, all three donated."""
    arch = configs.get("pna")
    rules = rules_for("gnn", ("data", "model"))
    plain = build_cell(arch, arch.shapes["molecule"], rules,
                       overrides=tiny("pna"))
    cell = build_cell(arch, arch.shapes["molecule"], rules,
                      grad_compress=256, overrides=tiny("pna"))
    assert len(cell["args"]) == 4 and cell["donate"] == (0, 1, 2)
    assert cell["args_specs"][2] == cell["args_specs"][0]
    for res, p in zip(tree.leaves(cell["args"][2]),
                      tree.leaves(cell["args"][0])):
        assert res.shape == p.shape and res.dtype == torch.float32
    assert cell["args_specs"][3] == plain["args_specs"][2]


def test_deepseek_cut_keeps_a_moe_layer_and_the_scan_lengths():
    arch = configs.get("deepseek-v2-lite-16b")
    cell = build_cell(arch, arch.shapes["train_4k"],
                      rules_for("lm", ("data", "model")),
                      overrides=tiny(arch.name))
    layers = cell["args"][0]["layers"]
    assert "router" not in layers[0]["ffn"] and "router" in layers[1]["ffn"]
    assert cell["scan_lengths"] == [2]
    eq = configs.get("equiformer-v2")
    chunked = build_cell(eq, eq.shapes["ogb_products"],
                         rules_for("gnn", ("data", "model")))
    assert chunked["scan_lengths"] == [12, -(-61859140 // 262144)]


def test_two_tower_tables_pad_to_the_mesh():
    """In a cell the tables pad to lcm(mesh size, 8) rows, as the
    reference's ``_row_pad`` pads to its device count; without a world
    they keep 8."""
    from repro_torch.launch import mesh as mesh_lib
    arch = configs.get("two-tower-retrieval")
    rules = rules_for("recsys", ("data", "model"))
    rows = {}
    for n in (1, 48):
        if n == 1:
            cell = build_cell(arch, arch.shapes["serve_p99"], rules)
        else:
            with mesh_lib.fake_world(n):
                cell = build_cell(arch, arch.shapes["serve_p99"], rules)
        rows[n] = cell["args"][0]["cat_table"].shape[0]
    assert rows == {1: 10_000, 48: 10_032}
