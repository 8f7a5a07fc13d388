"""The dry-run's cost model (``launch/op_cost.py``, the twin of
``launch/hlo_cost.py``) and its CLI (``launch/dryrun.py``).

The counting rules on plain ops against closed forms; per-device counts
on a (2, 4) fake world (local shards, the replicated MoE dispatch in full
on every device); the records of the LM, GNN and two-tower cells against
the reference's ``hlo_cal``, ``agg_flops`` and ``memory``, which the
reference compiles with XLA on 8 host devices in a subprocess (the
``REFERENCE_RECORDS`` pattern of ``tests/test_torch_cells_reference.py``);
the meta trace of a one-device cell against the same step run for real;
and ``run_cell``'s result and ``_emit``'s files against the reference's.
"""
import ast
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.kernels import cost_sites
from repro_torch.launch import dryrun, op_cost
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import placement as pl

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from chip_smoke import (DRYRUN_KEYS, lm_attention_sites,  # noqa: E402
                        lm_product_flops)

TINY = {"n_layers": 2, "batch": 4, "seq": 32, "d_model": 64, "n_heads": 4,
        "n_kv_heads": 2, "d_ff": 128, "vocab": 512}
LM = {"n_layers": 1, "batch": 2, "seq": 64}
DS = {"n_layers": 2, "batch": 2, "seq": 64}
GRAPH = {"n": 1024, "arcs": 2048}
CELLS = {
    "q": ["qwen2-1.5b", "train_4k", "2d", LM],
    "ds_2d": ["deepseek-v2-lite-16b", "train_4k", "2d", DS],
    "ds_expert": ["deepseek-v2-lite-16b", "train_4k", "expert", DS],
    "gin": ["gin-tu", "molecule", "2d", {}],
    "pna": ["pna", "minibatch_lg", "2d", GRAPH],
    "tt_train": ["two-tower-retrieval", "train_batch", "2d", {"batch": 64}],
}

REFERENCE_COSTS = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
from repro import configs
from repro.dist.sharding import sanitize_tree, tree_shardings
from repro.launch import hlo_cost
from repro.launch.mesh import make_mapped_mesh
from repro.launch.steps import build_cell, rules_for

def record(arch, shape, profile, overrides):
    a = configs.get(arch)
    mesh = make_mapped_mesh((2, 4), ("data", "model"), None)
    rules = rules_for(a.family, mesh.axis_names, profile=profile)
    cell = build_cell(a, a.shapes[shape], rules, overrides=overrides)
    specs = tuple(sanitize_tree(s, sp, mesh) for s, sp in
                  zip(cell["args_sds"], cell["args_specs"]))
    with mesh:
        comp = jax.jit(cell["step"], in_shardings=tuple(
            tree_shardings(mesh, s) for s in specs)).lower(
                *cell["args_sds"]).compile()
    comps, entry = hlo_cost.parse(comp.as_text())
    cal = dict.fromkeys(("flops", "bytes", "bytes_fused", "bytes_tight",
                         "bytes_tight_f32", "transcendentals"), 0.0)
    for name, m in hlo_cost.multipliers(comps, entry).items():
        c = comps[name]
        cal["flops"] += m * c.flops
        cal["bytes"] += m * c.bytes
        cal["bytes_fused"] += m * c.bytes_fused
        cal["bytes_tight"] += m * (c.bytes_tight - 0.5 * c.bytes_tight_f32)
        cal["bytes_tight_f32"] += m * c.bytes_tight_f32
        cal["transcendentals"] += m * c.transcendentals
    mem = comp.memory_analysis()
    agg = hlo_cost.normalize_cost_analysis(comp.cost_analysis())
    return {"hlo_cal": cal, "agg_flops": float(agg.get("flops", 0.0)),
            "memory": {"argument_bytes": mem.argument_size_in_bytes,
                       "output_bytes": mem.output_size_in_bytes,
                       "temp_bytes": mem.temp_size_in_bytes}}

print(json.dumps({k: record(*v) for k, v in json.loads(sys.argv[1]).items()}))
"""


@pytest.fixture(scope="module")
def ref():
    env = dict(os.environ, PYTHONPATH="src")
    out = subprocess.run([sys.executable, "-c", REFERENCE_COSTS,
                          json.dumps(CELLS)], env=env, capture_output=True,
                         text=True, check=True, cwd=ROOT)
    return json.loads(out.stdout.strip().splitlines()[-1])


SESSION = pl.PlacementSession(cache_dir="", map_restarts=2, device="cpu")


def _port(name):
    arch, shape, profile, over = CELLS[name]
    return SESSION.measure(arch, shape, mesh_shape=(2, 4),
                           axes=("data", "model"), profile=profile,
                           overrides=over)


def _recorded(fn, *args):
    rec = op_cost.OpCostRecorder()
    with rec:
        out = fn(*args)
    return rec, out


class _FreesIgnored(op_cost.OpCostRecorder):
    """A planted fault: the recorder never frees a storage."""

    def _free(self, key):
        pass


class _AttentionUncounted(op_cost.OpCostRecorder):
    """A planted fault: the attention site's declarations are dropped."""

    def _declare(self, site, declared):
        if site != "flash_attention":
            super()._declare(site, declared)


# ---------------------------------------------------------------------------
# The counting rules
# ---------------------------------------------------------------------------

def test_product_elementwise_and_reduction_closed_forms():
    x, w = torch.randn(8, 16), torch.randn(16, 32)
    rec, _ = _recorded(torch.mm, x, w)
    io = (8 * 16 + 16 * 32 + 8 * 32) * 4.0
    assert rec.totals == {"flops": 2.0 * 8 * 32 * 16, "bytes": io,
                          "bytes_fused": io, "bytes_tight": io,
                          "bytes_tight_f32": io, "transcendentals": 0.0}
    b = torch.randn(4, 8, 16, dtype=torch.bfloat16)
    c = torch.randn(4, 16, 8, dtype=torch.bfloat16)
    rec, _ = _recorded(torch.bmm, b, c)
    assert rec.totals["flops"] == 2.0 * 4 * 8 * 8 * 16
    assert rec.totals["bytes_tight_f32"] == 0.0
    rec, _ = _recorded(torch.exp, x)
    assert rec.totals == {"flops": 128.0, "bytes": 2 * 128 * 4.0,
                          "bytes_fused": 0.0, "bytes_tight": 0.0,
                          "bytes_tight_f32": 0.0, "transcendentals": 128.0}
    rec, _ = _recorded(lambda t: t.sum(dim=1), x)
    assert rec.totals["flops"] == 128.0               # operand elements
    assert rec.totals["bytes_tight"] == (128 + 8) * 4.0
    rec, _ = _recorded(lambda t: t.reshape(16, 8).t().detach(), x)
    assert rec.n_ops == 0 and rec.totals["bytes"] == 0.0
    rec, _ = _recorded(lambda t: torch.square(t), x)   # XLA's multiply
    assert rec.totals["transcendentals"] == 0.0


def test_fused_and_tight_are_nested_and_unknown_ops_are_listed():
    """On a small MLP's training step every class shows up:
    bytes >= bytes_fused >= bytes_tight > 0. An op the table lacks counts
    bytes and is listed once."""
    torch.manual_seed(0)
    w1 = torch.randn(32, 64, requires_grad=True)
    w2 = torch.randn(64, 8, requires_grad=True)
    x = torch.randn(16, 32)

    def step():
        h = torch.nn.functional.silu(x @ w1)
        loss = torch.logsumexp(h @ w2, -1).mean()
        return torch.autograd.grad(loss, (w1, w2))
    rec, _ = _recorded(step)
    t = rec.totals
    assert t["bytes"] >= t["bytes_fused"] >= t["bytes_tight"] > 0
    assert rec.by_op["mm"]["count"] == 5     # 2 forward, 3 backward (x: none)
    rec, _ = _recorded(lambda a: torch.special.i0(a), x)
    assert rec.unclassified == ["special_i0"] or rec.unclassified == ["i0"]
    assert rec.totals["bytes"] == 2 * x.numel() * 4.0
    rec2, _ = _recorded(lambda a: torch.special.i0(torch.special.i0(a)), x)
    assert len(rec2.unclassified) == 1


def test_upcasts_and_host_copies():
    x = torch.randn(4, 8, dtype=torch.bfloat16)
    rec, _ = _recorded(lambda t: t.float() * 2, x)
    assert rec.upcasts == {(4, 8): 1}
    assert rec.totals["flops"] == 2 * 32.0          # the convert, the mul
    meta = torch.empty(4, 8, device="meta")
    rec, _ = _recorded(lambda: torch.as_tensor(np.ones((4, 8), np.float32),
                                               device="meta") + meta)
    assert rec.by_op.keys() == {"add"}     # the host copy is a constant


def test_peak_memory_keys_storages_by_identity_and_frees():
    """Meta storages all sit at address 0: the recorder keys them by
    identity. Three 4 KB temporaries, one freed before the third: the
    peak is 8 KB; with frees ignored (a planted fault) 12 KB."""
    def step(a):
        t1 = a * 2
        t2 = t1 + 1
        del t1
        t3 = t2 * 3
        return t3
    a = torch.empty(1024, device="meta")
    for cls, peak in ((op_cost.OpCostRecorder, 8192), (_FreesIgnored, 12288)):
        rec = cls()
        rec.arguments(a)
        with rec:
            out = step(a)
        rec.outputs(out)
        assert rec.memory() == {"argument_bytes": 4096,
                                "output_bytes": 4096, "temp_bytes": peak}


def test_attention_site_counts_by_declaration_on_every_device():
    """The plain attention on CPU tensors and the meta path declare the
    same cost, the closed form, and count none of their ops; the backward
    likewise."""
    from repro_torch.models import common
    b, s, h, kh, d = 2, 48, 4, 2, 16
    q = torch.randn(b, s, h, d)
    k, v = torch.randn(b, s, kh, d), torch.randn(b, s, kh, d)
    want = cost_sites.attention_cost(b, s, s, h, kh, d, d, 4, 0, 16)
    for dev in ("cpu", "meta"):
        args = [t.to(dev) for t in (q, k, v)]
        rec, (out, lse) = _recorded(common.flash_attention_fwd, *args,
                                    True, 0, 16)
        assert rec.sites["flash_attention"]["flops"] == want["flops"]
        assert set(rec.by_op) <= {"site:flash_attention"}, dev
        rec, _ = _recorded(common.flash_attention_bwd, *args, out, lse,
                           torch.ones_like(out), True, 0, 16)
        bwd = cost_sites.attention_cost(b, s, s, h, kh, d, d, 4, 0, 16,
                                        True)
        assert rec.sites["flash_attention"]["bytes"] == bwd["bytes"]
        assert rec.sites["flash_attention"]["flops"] == bwd["flops"]
    # the rule's bytes are the kernel's I/O: q, k, v read, o written
    assert want["bytes"] == 4.0 * (2 * b * s * h * d + 2 * b * s * kh * d)
    rec, _ = _recorded(common.flash_attention_fwd, q, k, v, True, 0, 16)
    off = _AttentionUncounted()
    with off:
        common.flash_attention_fwd(q, k, v, True, 0, 16)
    assert off.totals["flops"] == 0.0 and rec.totals["flops"] > 0


# The declared sites against the reference's own count of the same
# functions: ``hlo_cost.analyze`` of ``_flash_fwd_impl`` / ``_flash_bwd``
# and of the per-token loss of ``cross_entropy``, each compiled alone.
# float32 and bf16; one to four kv chunks, D > Dv (MLA's), q chunks.
ATTENTION_SHAPES = [  # b, s, h, kh, d, dv, q_chunk, kv_chunk
    (2, 64, 4, 2, 16, 16, 0, 0), (2, 64, 4, 2, 16, 16, 0, 32),
    (1, 96, 4, 4, 32, 32, 0, 32), (2, 128, 4, 1, 16, 16, 0, 32),
    (1, 64, 2, 2, 24, 16, 0, 16), (1, 64, 4, 2, 16, 16, 32, 32)]
# the elementwise constants are fitted (cost_sites.attention_cost): 2.5%
# forward, 3.5% backward; the products and the exps are exact
ATTENTION_REL = (0.025, 0.035)


def _hlo_counts(fn, *args):
    import jax

    from repro.launch import hlo_cost
    return hlo_cost.analyze(jax.jit(fn).lower(*args).compile().as_text())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", ATTENTION_SHAPES,
                         ids=["x".join(map(str, s)) for s in ATTENTION_SHAPES])
def test_attention_cost_against_the_reference_hlo(shape, dtype):
    import jax.numpy as jnp

    from repro.models import common as rc
    b, s, h, kh, d, dv, qc, kc = shape
    dt = jnp.dtype(dtype)
    q = jnp.zeros((b, s, h, d), dt)
    k, v = jnp.zeros((b, s, kh, d), dt), jnp.zeros((b, s, kh, dv), dt)
    out, lse = jnp.zeros((b, s, h, dv), dt), jnp.zeros(
        (b, s, kh, h // kh), jnp.float32)
    fwd = _hlo_counts(lambda q, k, v: rc._flash_fwd_impl(
        q, k, v, True, qc, kc), q, k, v)
    bwd = _hlo_counts(lambda q, k, v, o, l, do: rc._flash_bwd(
        True, qc, kc, (q, k, v, o, l), do), q, k, v, out, lse, out)
    for ref, backward, rel in ((fwd, False, ATTENTION_REL[0]),
                               (bwd, True, ATTENTION_REL[1])):
        ours = cost_sites.attention_cost(b, s, s, h, kh, d, dv, dt.itemsize,
                                         qc, kc, backward)
        assert ours["flops"] == pytest.approx(ref["flops"], rel=rel)
        assert ours["transcendentals"] == pytest.approx(
            ref["transcendentals"], rel=1e-9)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tokens,vocab", [(64, 512), (48, 4096)])
def test_token_nll_cost_against_the_reference_hlo(tokens, vocab, dtype):
    """The forward against the loss alone; forward and backward together
    against the loss and its VJP compiled as one program, as a train step
    runs them (XLA's backward reuses the forward's exps). Within 1%: the
    per-token terms are fitted."""
    import jax
    import jax.numpy as jnp

    def nll(x, lab):
        logz = jax.nn.logsumexp(x.astype(jnp.float32), axis=-1)
        gold = jnp.take_along_axis(x.astype(jnp.float32), lab[..., None],
                                   axis=-1)[..., 0]
        return logz - gold

    def value_and_vjp(x, lab, g):
        y, pull = jax.vjp(lambda x: nll(x, lab), x)
        return y, pull(g)[0]
    x = jnp.zeros((tokens, vocab), dtype)
    lab = jnp.zeros((tokens,), jnp.int32)
    fwd = _hlo_counts(nll, x, lab)
    both = _hlo_counts(value_and_vjp, x, lab,
                       jnp.zeros((tokens,), jnp.float32))
    it = jnp.dtype(dtype).itemsize
    ours = cost_sites.token_nll_cost(tokens, vocab, it)
    back = cost_sites.token_nll_cost(tokens, vocab, it, True)
    for mine, ref in ((ours, fwd),
                      ({k: ours[k] + back[k] for k in ours}, both)):
        assert mine["flops"] == pytest.approx(ref["flops"], rel=0.01)
        assert mine["transcendentals"] == pytest.approx(
            ref["transcendentals"], rel=0.01)
        assert mine["bytes"] == pytest.approx(ref["bytes_tight"], rel=0.01)
        assert mine["f32_bytes"] == pytest.approx(ref["bytes_tight_f32"],
                                                  rel=0.01)


# ---------------------------------------------------------------------------
# Per device
# ---------------------------------------------------------------------------

def test_sharded_products_count_local_shards_and_the_closed_form():
    """On a (2, 4) fake world under sp (every product split eight ways) a
    tiny qwen2 train step's product FLOPs are the closed form over 8,
    and on one device the closed form itself, less the down projections
    the checkpoint's early stop does not recompute on plain tensors; the
    attention on one device is declared n_layers times forward for the
    step, as many again for the checkpoint's recompute, and n_layers times
    backward, each at ``cost_sites.attention_cost`` of the cell's shapes
    (``lm_attention_sites``)."""
    arch = configs.get("qwen2-1.5b")
    cfg = dataclasses.replace(arch.make_config("train_4k"), **{
        k: v for k, v in TINY.items() if k not in ("batch", "seq")})
    b, s = TINY["batch"], TINY["seq"]
    for mesh_shape, n in (((2, 4), 8), ((1, 1), 1)):
        with mesh_lib.fake_world(n):
            mesh = mesh_lib.make_mapped_mesh(mesh_shape, ("data", "model"))
            _, cost, _ = dryrun._trace(arch, arch.shapes["train_4k"], mesh,
                                       TINY, profile="sp")
        products = sum(v["flops"] for k, v in cost.by_op.items()
                       if k in ("mm", "bmm", "addmm", "baddbmm"))
        # one device traces plain tensors, whose checkpoint stops early
        assert products == lm_product_flops(cfg, b, s, n,
                                            early_stop=n == 1)
        assert cost.unclassified == []
    site, want = cost.sites["flash_attention"], lm_attention_sites(cfg, b, s)
    assert site["count"] == want["count"]
    assert site["flops"] == pytest.approx(want["flops"], rel=1e-12)


def test_replicated_moe_dispatch_counts_in_full_on_every_device():
    """The MoE routing's sort and scatters run on the whole token set on
    every device (``sharding.whole_local``, GSPMD's replicated dispatch):
    their per-device counts on (2, 4) equal a one-device trace's, while
    the sharded products shrink."""
    over = dict(DS, seq=32)
    recs = {}
    for mesh_shape, n in (((2, 4), 8), ((1, 1), 1)):
        with mesh_lib.fake_world(n):
            mesh = mesh_lib.make_mapped_mesh(mesh_shape, ("data", "model"))
            arch = configs.get("deepseek-v2-lite-16b")
            _, recs[n], _ = dryrun._trace(arch, arch.shapes["train_4k"],
                                          mesh, over)
    for op in ("sort", "scatter_add", "searchsorted"):
        if op in recs[1].by_op:
            assert recs[8].by_op[op]["flops"] == recs[1].by_op[op]["flops"]
            assert recs[8].by_op[op]["bytes"] == recs[1].by_op[op]["bytes"]
    assert "sort" in recs[1].by_op
    assert recs[8].by_op["bmm"]["flops"] < recs[1].by_op["bmm"]["flops"]


def test_one_device_trace_counts_what_the_real_step_counts():
    """The meta record of a one-device cell and the same step run on real
    CPU tensors under the same recorder (params from ``init``): the same
    counts and the same memory (the card anchor's gate, on the CPU)."""
    for arch, over in (("qwen2-1.5b", TINY),
                       ("deepseek-v2-lite-16b",
                        {"n_layers": 2, "batch": 2, "seq": 32, "d_model": 64,
                         "n_heads": 4, "d_ff": 128, "vocab": 512,
                         "n_experts": 8, "top_k": 2, "moe_d_ff": 32})):
        rec = SESSION.measure(arch, "train_4k", mesh_shape=(1, 1),
                              axes=("data", "model"), overrides=over)
        cell, args = dryrun.lm_train_args(arch, "train_4k", over,
                                          device="cpu")
        card = op_cost.OpCostRecorder()
        card.arguments(*args)
        with card:
            out = cell["step"](*args)
        card.outputs(out)
        for k in op_cost.KEYS:
            assert card.totals[k] == rec.hlo_cal[k], (arch, k)
        assert card.memory() == rec.memory
        assert set(rec.ops["sites"]) == {"flash_attention", "token_nll"}


# ---------------------------------------------------------------------------
# Against the reference
# ---------------------------------------------------------------------------

# Per-device FLOPs, port / reference, on (2, 4). The LM cells hold 10%.
# At these sizes the products are what both count alike (the unembed and
# the layers' GEMMs; mm agrees with XLA's dots to 0.1%); the rest is
# elementwise. The other bands come from the two counts, op by op:
#   gin  1.001: the products match; the port's masks and selects of the
#        segment max add 0.1%.
#   pna  1.042: the products (324M) match XLA's dots; the port's eager
#        elementwise ops count 21M against XLA's 7M after its algebraic
#        simplifier (the degree scalers' divides and multiplies and the
#        segment max/min's eq masks, 44 of them, that XLA folds).
#   tt   1.000: the towers' GEMMs are 99.9% of either count.
# Within 10% at seq 8 the LM cells do not hold: XLA:CPU converts each bf16
# product's operands to float32 (its "upcasts", 1.45 GFLOP against the
# port's 0.32 on qwen2), which grows as 1 / tokens per device; at 64
# tokens a sequence the products dominate as they do in every real cell.
FLOP_BANDS = {"q": (0.9, 1.1), "ds_2d": (0.9, 1.1), "ds_expert": (0.9, 1.1),
              "gin": (0.98, 1.02), "pna": (1.0, 1.06),
              "tt_train": (0.98, 1.02)}


@pytest.mark.parametrize("name", list(CELLS))
def test_per_device_flops_against_the_reference(ref, name):
    rec = _port(name)
    want = ref[name]["hlo_cal"]["flops"]
    lo, hi = FLOP_BANDS[name]
    assert lo <= rec.hlo_cal["flops"] / want <= hi
    # the port's layers are unrolled, so its agg_flops is the whole count;
    # XLA's cost_analysis counts a scanned layer once
    assert rec.agg_flops == rec.hlo_cal["flops"]
    assert rec.agg_flops >= lo * ref[name]["agg_flops"]
    assert rec.ops["unclassified"] == []


# Per-device tight bytes (the roofline's HBM term), port / reference, on
# (2, 4), by op class (port vs reference, GB a device). The LM cells are
# held to the reference's record, which halves XLA:CPU's all-float32
# traffic as its estimate of the bf16 path; the float32 families to XLA's
# own count (the record plus the halved half: halving is a bf16 rule).
#   q     0.745 of 2.15: XLA's layer scan slices each layer's weights and
#         AdamW state out of the stacked arrays (dynamic-slice, 0.63; the
#         port's layers are unrolled, none); collectives 0.61 vs 0.73 (each
#         gradient reduce-scattered once in bf16 where XLA all-reduces);
#         products 0.33 vs 0.46 (the same FLOPs within 3%; XLA's dots read
#         float32 copies and write float32, which halving only
#         approximates); the embedding's gather and gradient scatter 0.35
#         vs 0.19 (the port's equal XLA's unhalved 0.35, row for row); the
#         global norm's float32 sums 0.26 vs 0.14 (XLA's 0.28, halved); the
#         declared loss and attention 0.04 (XLA's counted in the classes).
#   ds    0.831 of 3.40: slices 0.73 vs 0.01; collectives 0.75 vs 0.94;
#         products 1.02 vs 1.15; reductions 0.57 vs 0.29 (the norm's sums
#         again); gathers and scatters 0.43 vs 0.29 (the MoE dispatch's and
#         the embedding's, in bf16, against XLA's halved float32).
#   gin   0.727 of 0.137: XLA's layer scan slices and updates its carry
#         (0.049, none in the port); collectives 0.046 vs 0.034 (the
#         port's reduce-scatters and gathers of the node rows); gathers and
#         scatters, products and reductions equal (0.043, 0.009, 0.002).
#   pna   0.831 of 0.196: slices 0.094 vs 0; collectives 0.102 vs 0.046
#         (the port's segment max, min and std all-reduce whole node rows
#         over the arc shards); gathers and scatters 0.044 vs 0.040;
#         products equal (0.015).
#   tt    1.332 of 0.700: the item table's gradient: XLA adds the history
#         bags' and the candidates' rows first and scatters once into the
#         [125000, 256] shard (0.26); the port's autograd scatters each
#         (index_add twice, 0.52); the gathers equal (0.26); slices 0.016
#         vs 0.
TIGHT_BANDS = {"q": (0.70, 0.79), "ds_2d": (0.79, 0.87),
               "ds_expert": (0.79, 0.87), "gin": (0.69, 0.77),
               "pna": (0.79, 0.87), "tt_train": (1.27, 1.40)}
# Per-device transcendentals, port / reference:
#   q, ds 1.006, 1.008: AdamW's sqrt, one a parameter element of the
#         device, is 95% of either count and equal (64.2M, 137.1M); the
#         rest: the loss's and the attention's exps (declared at the
#         reference's count), silu's sigmoid (XLA's exp) and RoPE's sin and
#         cos on both sides.
#   gin   1.029: the sqrt equal within 0.6% (6,024 vs 5,991); the declared
#         loss over the graph logits, 192 against XLA's 48 exps and logs.
#   pna   7.04: the port runs the std aggregator's sqrt over the whole node
#         set (4 layers x [1024, 75], 0.31M) where XLA's runs on the
#         device's 128 rows (38K), and AdamW's update on each device's whole
#         replicated parameters (0.35M) where XLA splits it over the model
#         axis and gathers the result (45K).
#   tt    1.000: AdamW's sqrt (32.6M) is all of either count.
TRANSCENDENTAL_BANDS = {"q": (0.99, 1.03), "ds_2d": (0.99, 1.03),
                        "ds_expert": (0.99, 1.03), "gin": (1.0, 1.06),
                        "pna": (6.7, 7.4), "tt_train": (0.99, 1.01)}
LM_CELLS = ("q", "ds_2d", "ds_expert")


@pytest.mark.parametrize("name", list(CELLS))
def test_per_device_tight_bytes_and_transcendentals_against_the_reference(
        ref, name):
    rec, want = _port(name), ref[name]["hlo_cal"]
    tight = want["bytes_tight"] if name in LM_CELLS else \
        want["bytes_tight"] + 0.5 * want["bytes_tight_f32"]
    lo, hi = TIGHT_BANDS[name]
    assert lo <= rec.hlo_cal["bytes_tight"] / tight <= hi
    lo, hi = TRANSCENDENTAL_BANDS[name]
    assert lo <= rec.hlo_cal["transcendentals"] / want[
        "transcendentals"] <= hi


@pytest.mark.parametrize("name", list(CELLS))
def test_memory_against_the_reference(ref, name):
    """The arguments are the same shards: equal bytes on the LMs and the
    two-tower model; the GNNs' spec trees hold one more float32 row a
    node-sized input (the port pads its labels; within 10%). The outputs
    are the new parameters and optimizer state (within 1%). ``temp``
    differs by design: XLA aliases donated buffers and excludes the
    outputs, the port's peak holds them (``op_cost``'s docstring)."""
    mem, want = _port(name).memory, ref[name]["memory"]
    assert set(mem) == set(want)
    rel = abs(mem["argument_bytes"] / want["argument_bytes"] - 1)
    assert rel == 0.0 if name in ("q", "ds_2d", "ds_expert", "tt_train") \
        else rel <= 0.1
    assert abs(mem["output_bytes"] / want["output_bytes"] - 1) <= 0.01
    assert mem["temp_bytes"] > 0


def test_hlo_cal_has_the_reference_keys(ref):
    rec = _port("q")
    assert set(rec.hlo_cal) == set(ref["q"]["hlo_cal"])
    assert rec.bytes_deep == 0.0
    assert set(rec.memory) == {"argument_bytes", "output_bytes",
                               "temp_bytes"}


# ---------------------------------------------------------------------------
# run_cell and _emit against the reference's
# ---------------------------------------------------------------------------

def _reference_result_keys():
    """The top-level keys of the reference's ``run_cell`` result, read off
    its source (importing the reference's dry-run would set 512 host
    devices): the ``result`` literal, its ``update`` and its item
    assignments."""
    tree = ast.parse((ROOT / "src/repro/launch/dryrun.py").read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "run_cell")
    keys = set()

    def literal(d):
        return {k.value for k in d.keys if isinstance(k, ast.Constant)}
    for node in ast.walk(fn):
        if isinstance(node, ast.AnnAssign) and getattr(
                node.target, "id", None) == "result":
            keys |= literal(node.value)
        elif isinstance(node, ast.Call) and isinstance(
                node.func, ast.Attribute) and node.func.attr == "update" \
                and getattr(node.func.value, "id", None) == "result":
            keys |= literal(node.args[0])
        elif isinstance(node, ast.Subscript) and getattr(
                node.value, "id", None) == "result" and isinstance(
                    node.ctx, ast.Store):
            keys.add(node.slice.value)
    return keys


SCHEMA_CELLS = [
    ("qwen2-1.5b", "train_4k", {"n_layers": 1, "batch": 8, "seq": 16}),
    ("qwen2-1.5b", "prefill_32k", {"n_layers": 1, "batch": 8, "seq": 16}),
    ("qwen2-1.5b", "decode_32k", {"n_layers": 1, "batch": 8, "seq": 16}),
    ("gin-tu", "molecule", {}),
    ("two-tower-retrieval", "serve_p99", {"batch": 64}),
    ("two-tower-retrieval", "retrieval_cand", {"n_cand": 4096}),
]


@pytest.mark.parametrize("arch,shape,over", SCHEMA_CELLS,
                         ids=[f"{a}/{s}" for a, s, _ in SCHEMA_CELLS])
def test_run_cell_has_every_key_of_the_reference(arch, shape, over):
    r = dryrun.run_cell(arch, shape, False, None, overrides=over,
                        session=SESSION, machine="gpu-superpod")
    ref_keys = _reference_result_keys()
    optional = {"mapping", "roofline_per_bin", "reason"}
    assert set(r) == ref_keys - optional
    assert set(DRYRUN_KEYS) == ref_keys - optional
    assert r["status"] == "ok" and r["mesh"] == "gpu-superpod"
    assert r["hlo_cost"]["flops"] > 0 and r["hlo_cost"]["bytes_tight"] > 0
    assert r["per_device"]["bytes_attn_xla"] == 0.0
    assert r["dominant"] in r["roofline_terms"]
    assert r["memory_analysis"]["argument_bytes"] > 0


def test_skip_and_heterogeneous_cells():
    skip = next((a.name, s.name) for a, s in configs.all_cells()
                if s.kind == "skip")
    r = dryrun.run_cell(*skip, False, None, machine="gpu-superpod")
    assert r["status"] == "skip" and r["reason"]
    r = dryrun.run_cell("two-tower-retrieval", "serve_p99", False, None,
                        overrides={"batch": 64}, session=SESSION,
                        machine="tpu-mixed-32")
    per_bin = r["roofline_per_bin"]
    assert set(per_bin) == {"compute_s_min", "compute_s_max",
                            "memory_s_min", "memory_s_max", "slowest_bin"}
    assert per_bin["compute_s_min"] < per_bin["compute_s_max"]
    assert per_bin["compute_s_max"] == r["roofline_terms"]["compute_s"]
    assert set(r) | {"mapping", "reason"} == _reference_result_keys()


EMIT_REFERENCE = r"""
import json, sys
sys.path.insert(0, "src")
import importlib.util, types
# the reference's _emit alone, without importing the dry-run module
src = open("src/repro/launch/dryrun.py").read()
start = src.index("def _emit(")
end = src.index("def _report_of(")
ns = {"os": __import__("os"), "json": json, "Dict": dict,
      "Optional": __import__("typing").Optional}
exec(src[start:end], ns)
for r in json.loads(sys.argv[1]):
    ns["_emit"](r, sys.argv[2])
"""


def test_emit_writes_the_reference_file_names(tmp_path):
    results = [{"arch": "qwen2-1.5b", "shape": "train_4k",
                "mesh": "2x16x16", "tag": "map_2d"},
               {"arch": "gin-tu", "shape": "molecule", "mesh": "16x16",
                "tag": ""},
               {"arch": "pna", "shape": "minibatch_lg",
                "mesh": "gpu-superpod"}]
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    subprocess.run([sys.executable, "-c", EMIT_REFERENCE,
                    json.dumps(results), str(ref_dir)], check=True, cwd=ROOT)
    for r in results:
        dryrun._emit(dict(r), str(port_dir))
    assert sorted(os.listdir(port_dir)) == sorted(os.listdir(ref_dir))
    for name in os.listdir(ref_dir):
        assert json.loads((port_dir / name).read_text()) == json.loads(
            (ref_dir / name).read_text())


def test_attention_kernel_bytes_is_the_reference_formula():
    """The reference's ``attention_kernel_bytes`` at bf16, the configs'
    own dtype, on the dense and the MLA archs."""
    for name, want in (("qwen2-1.5b", None), ("deepseek-v2-lite-16b", None)):
        arch = configs.get(name)
        shape = arch.shapes["train_4k"]
        cfg = arch.make_config("train_4k")
        b, s = shape.meta["batch"], shape.meta["seq"]
        if cfg.mla:
            dqk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
            fwd = b * s * cfg.n_heads * (2 * dqk + 2 * cfg.v_head_dim)
        else:
            dh = cfg.head_dim
            fwd = b * s * dh * (2 * cfg.n_heads + 2 * cfg.n_kv_heads)
        assert dryrun.attention_kernel_bytes(arch, shape) == \
            cfg.n_layers * fwd * 2 * 3.0
        assert dryrun.attention_kernel_bytes(arch, arch.shapes[
            "decode_32k"]) == 0.0
