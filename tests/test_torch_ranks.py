"""The LM trainer and the one-shot server on several ranks: 4 gloo ranks
on the CPU, started as ``torchrun`` starts them (``RANK``, ``LOCAL_RANK``,
``WORLD_SIZE``, ``MASTER_ADDR`` / ``MASTER_PORT``), against the reference
on 4 XLA host devices in a subprocess (the ``REFERENCE_RECORDS`` pattern
of ``tests/test_torch_cells_reference.py``), whose CLIs record their
per-step losses and grad norms (``repro.train.loop.run`` wrapped) and
their searched orders (``PlacementSession.map_step`` wrapped). Nothing
under ``src/repro/`` changes.

One world of 4 ranks runs every port case in turn (``WORKER``), and one
reference subprocess runs every reference case at the same time; both
start in the module's fixture. The port's trainer starts from the
reference's weights (``PRNGKey(0)``, carried across by ``interop``), so
its trajectory is held to the reference's; the server runs the port's
own weights of seed 0 and is held to the port's one-process run.

The cases:

* (i) 6 SMOKE steps at 8 x 64 on a 1-d ``data`` mesh: qwen2-1.5b under
  ``2d`` and ``fsdp``, deepseek-v2-lite-16b under ``2d``;
* (ii) the same on the 2 x 2 ``(data, model)`` machine ``ranks-2x2``,
  registered in both packages, whose top links are 4x slower than its
  leaf links; qwen2's ``fsdp`` with ``--topology-aware``, where the
  reference's searched order is not the identity;
* (iii) every rank holds the same order, the reference's (or one tied
  with it in float64 on the port's traffic), and trains on that mesh;
* (iv) ``--fault-plan "3:leaf_death:1"`` with a checkpoint every 2 steps:
  the stitched losses equal the clean run's bit for bit, rank 0 alone
  writes, and each save leaves one complete step directory;
* (v) the one-shot server's greedy tokens equal the one-process run's,
  and its ``--topology-aware`` order on ``ranks-2x2`` equals the
  reference's ``map_step``.
"""
import functools
import json
import os
import socket
import subprocess
import sys
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.dist.sharding import lm_rules
from repro.models import transformer as rtr
from repro_torch import interop
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as tlaunch
from repro_torch.models import transformer as ttr

WORLD = 4
STEPS, BATCH, SEQ = 6, 8, 64
SERVE = ["--batch", "4", "--prompt-len", "4", "--gen-len", "8",
         "--temperature", "0"]
# top links 25 Gb/s, leaf links 100 Gb/s: crossing the top costs 4x a byte
MACHINE = dict(name="ranks-2x2", mesh_shape=[2, 2], axes=["data", "model"],
               levels=[["node", 2, 25.0], ["gpu", 2, 100.0]])


def _train(arch, profile, *extra):
    return ["--arch", arch, "--smoke", "--steps", str(STEPS), "--batch",
            str(BATCH), "--seq", str(SEQ), "--profile", profile, *extra]


Q, DS = "qwen2-1.5b", "deepseek-v2-lite-16b"
ON_MACHINE = ("--machine", "ranks-2x2")
MAPPED = ("--topology-aware", "--map-restarts", "4")
TRAIN = {
    "q_2d": _train(Q, "2d"),
    "q_fsdp": _train(Q, "fsdp"),
    "ds_2d": _train(DS, "2d"),
    "q_2d_m": _train(Q, "2d", *ON_MACHINE),
    "q_fsdp_m": _train(Q, "fsdp", *ON_MACHINE, *MAPPED),
    "ds_2d_m": _train(DS, "2d", *ON_MACHINE),
}
FAULT = _train(Q, "2d", "--fault-plan", "3:leaf_death:1",
               "--ckpt-every", "2")
SERVE_CASES = {
    "serve": ["--arch", Q, *SERVE, *MAPPED],
    "serve_m": ["--arch", Q, *SERVE, *ON_MACHINE, *MAPPED],
    "serve_ds_m": ["--arch", DS, *SERVE, *ON_MACHINE],
}
# the reference's runs, in one subprocess beside the port's world. Its
# trajectory does not depend on its mesh or profile beyond float32
# reduction orders, so qwen2 2d (on either mesh) is held to its 1-d fsdp
# run and deepseek on the machine to its 1-d run; the mapped runs give the
# searched orders
REFERENCE_CASES = {
    "ds_2d": ["train", TRAIN["ds_2d"]],
    "q_fsdp": ["train", TRAIN["q_fsdp"]],
    "q_fsdp_m": ["train", TRAIN["q_fsdp_m"]],
    "serve": ["serve", ["--smoke", "--oneshot", *SERVE_CASES["serve"]]]}
REFERENCE_OF = {"q_2d": "q_fsdp", "q_2d_m": "q_fsdp", "ds_2d_m": "ds_2d"}

REFERENCE_RECORDS = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
from repro.core import machine as M
spec = json.loads(sys.argv[2])
M.register(M.MachineSpec(
    name=spec["name"], mesh_shape=tuple(spec["mesh_shape"]),
    axes=tuple(spec["axes"]), levels=tuple(M.Level(*l)
                                           for l in spec["levels"])))
from repro.launch import placement as P, serve, train
from repro.train import loop
rec = {}
map_step, run = P.PlacementSession.map_step, loop.run

def mapped(self, *a, **k):
    mesh, rep = map_step(self, *a, **k)
    rec["order"] = [int(x) for x in rep.device_order]
    return mesh, rep

def recorded(step_fn, *a, **k):
    def step(*args):
        out = step_fn(*args)
        rec["losses"].append(float(out[-1]["loss"]))
        rec["norms"].append(float(out[-1]["grad_norm"]))
        return out
    return run(step, *a, **k)

P.PlacementSession.map_step = mapped
loop.run = recorded
results = {}
for name, (cli, argv) in json.loads(sys.argv[1]).items():
    rec = results[name] = {"losses": [], "norms": []}
    sys.argv = [cli] + argv
    (train if cli == "train" else serve).main()
    jax.clear_caches()
print(json.dumps(results))
"""

# One rank of the port's world: every case in turn on one process group
WORKER = r"""
import json, os, sys
import torch
torch.set_num_threads(1)
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.core import machine as M
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import placement as P
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as tlaunch
from repro_torch.models import transformer as tr
from repro_torch.train import loop
cases, spec, tmp = json.loads(sys.argv[1]), json.loads(sys.argv[2]), sys.argv[3]
M.register(M.MachineSpec(
    name=spec["name"], mesh_shape=tuple(spec["mesh_shape"]),
    axes=tuple(spec["axes"]), levels=tuple(M.Level(*l)
                                           for l in spec["levels"])))
rec = {}
run, search, rename = loop.run, P.PlacementSession._search, os.rename

def recorded(step_fn, *a, **k):
    def step(*args):
        out = step_fn(*args)
        rec["losses"].append(loop._scalar(out[-1]["loss"]))
        rec["norms"].append(loop._scalar(out[-1]["grad_norm"]))
        return out
    return run(step, *a, **k)

def searched(self, mesh_shape, topo, traffic, warm_starts=None):
    rec["traffic"] = traffic.tolist()
    return search(self, mesh_shape, topo, traffic, warm_starts)

def renamed(src, dst):
    rec.setdefault("renames", []).append(os.path.basename(dst))
    return rename(src, dst)

loop.run, P.PlacementSession._search = recorded, searched
ckpt.os.rename = renamed
params = {a: torch.load(os.path.join(tmp, a + ".pt"))
          for a in ("qwen2-1.5b", "deepseek-v2-lite-16b")}
out = {}
for name, (kind, argv) in cases.items():
    rec = out[name] = {"losses": [], "norms": []}
    if kind == "train":
        args = tlaunch._parser().parse_args(argv + ["--device", "cpu"])
        if args.fault_plan:
            args.ckpt_dir = os.path.join(tmp, "ckpt")
        setup = {}
        build = tlaunch.build

        def keep(*a, **k):
            setup["s"] = build(*a, **k)
            return setup["s"]
        tlaunch.build = keep
        # the reference's weights in place of the port's seed-0 ones
        init, tr.init = tr.init, lambda *a, **k: params[args.arch]
        result = tlaunch.train(args)[2]
        tlaunch.build, tr.init = build, init
        if setup["s"].mapping is not None:
            rec["order"] = setup["s"].mapping.device_order
        rec["mesh"] = mesh_lib.device_order_of(setup["s"].mesh).tolist()
        rec["stitched"] = result.losses
    elif kind == "attn_gqa":
        from torch.distributed.tensor import Replicate, Shard, distribute_tensor
        from repro_torch.kernels import ops
        mesh = mesh_lib.make_mapped_mesh((1, 4), ("data", "model"))
        g = torch.Generator().manual_seed(2)
        q, k, v, do = (torch.randn(s_, generator=g) for s_ in (
            (2, 8, 4, 16), (2, 8, 2, 16), (2, 8, 2, 16), (2, 8, 4, 16)))
        plain = [t.clone().requires_grad_(True) for t in (q, k, v)]
        want = ops.flash_attention(*plain, q_chunk=4, kv_chunk=4)
        want.backward(do)
        on = [distribute_tensor(t, mesh, pl).requires_grad_(True)
              for t, pl in ((q, [Replicate(), Shard(2)]),
                            (k, [Replicate(), Replicate()]),
                            (v, [Replicate(), Replicate()]))]
        got = ops.flash_attention(*on, q_chunk=4, kv_chunk=4)
        got.backward(distribute_tensor(do, mesh, got.placements))
        pairs = [(got, want)] + [(a.grad, b.grad) for a, b in zip(on, plain)]
        rec["attn_err"] = max(float((a.full_tensor() - b).abs().max()
                                    / b.abs().max()) for a, b in pairs)
    elif kind == "moe_ep":
        import dataclasses
        from torch.distributed.tensor.experimental import implicit_replication
        from repro_torch import configs
        from repro_torch.dist import sharding
        from repro_torch.launch.steps import rules_for
        cfg = dataclasses.replace(configs.get(argv[0]).smoke_config(),
                                  capacity_factor=4.0)
        mesh = mesh_lib.make_machine_mesh(M.resolve(spec["name"]))
        rules = rules_for("lm", mesh.mesh_dim_names, "2d")
        p = tr.init(cfg, torch.Generator().manual_seed(0),
                    device="cpu")["layers"][1]["ffn"]
        x = torch.randn(16, cfg.d_model,
                        generator=torch.Generator().manual_seed(1))
        want = tr.moe_ffn(p, x, cfg)[0]
        on = sharding.distribute_tree(
            p, tr.param_specs(cfg, rules)["layers"][1]["ffn"], mesh)
        with implicit_replication():
            got = tr.moe_ffn(on, sharding.distribute_tree(
                x, rules.spec("batch", None), mesh),
                dataclasses.replace(cfg, ep_shard_map=1), rules)[0]
        rec["moe_err"] = float((got.full_tensor() - want).abs().max()
                               / want.abs().max())
    else:
        args = tserve._parser().parse_args(
            ["--smoke", "--device", "cpu", "--oneshot"] + argv)
        cfg, dev, p = tserve._setup(args)
        mesh = args.mesh
        if args.topology_aware:
            session = P.PlacementSession(cache_dir="", device=dev,
                                         map_restarts=args.map_restarts)
            mesh, p, rep = tserve.map_decode(
                p, cfg, dev, args.batch, args.prompt_len + args.gen_len,
                args.rules, mesh, session, args.machine)
            rec["order"] = rep.device_order
        rec["mesh"] = mesh_lib.device_order_of(mesh).tolist()
        rec["tokens"] = tserve.oneshot(
            p, cfg, dev, args.batch, args.prompt_len, args.gen_len,
            args.temperature, args.seed, args.rules, mesh)[0].tolist()
with open(os.path.join(tmp, f"rank{mesh_lib.rank()}.json"), "w") as f:
    json.dump(out, f)
torch.distributed.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _reference_params(arch):
    cfg = rconfigs.get(arch).smoke_config()
    params, _ = rtr.init(jax.random.PRNGKey(0), cfg, lm_rules(()))
    return interop.transformer_params_from(jax.tree.map(np.asarray, params))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the port's per-rank results, the reference's results, tmp dir):
    the reference subprocess and the 4 ranks run side by side."""
    tmp = tmp_path_factory.mktemp("ranks")
    for arch in (Q, DS):
        torch.save(_reference_params(arch), tmp / f"{arch}.pt")
    env = dict(os.environ, PYTHONPATH="src")
    ref = subprocess.Popen(
        [sys.executable, "-c", REFERENCE_RECORDS,
         json.dumps(REFERENCE_CASES), json.dumps(MACHINE)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    cases = {k: ["train", v] for k, v in TRAIN.items()}
    cases["fault"] = ["train", FAULT]
    cases.update({k: ["serve", v] for k, v in SERVE_CASES.items()})
    cases["moe_ep"] = ["moe_ep", [DS]]
    cases["attn_gqa"] = ["attn_gqa", []]
    port = _free_port()
    ranks = [subprocess.Popen(
        [sys.executable, "-c", WORKER, json.dumps(cases),
         json.dumps(MACHINE), str(tmp)],
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(WORLD),
                 MASTER_ADDR="localhost", MASTER_PORT=str(port),
                 OMP_NUM_THREADS="1"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(WORLD)]
    for r, p in enumerate(ranks):
        _, err = p.communicate(timeout=600)
        assert p.returncode == 0, f"rank {r}:\n{err[-4000:]}"
    out, err = ref.communicate(timeout=600)
    assert ref.returncode == 0, err[-4000:]
    got = [json.loads((tmp / f"rank{r}.json").read_text())
           for r in range(WORLD)]
    return got, json.loads(out.strip().splitlines()[-1]), tmp


@functools.lru_cache(maxsize=None)
def _one_process(arch):
    """The port's trainer without a process group, from the reference's
    weights: (losses, grad norms). Without a mesh the profile's rules
    constrain nothing, so one run serves every profile."""
    args = tlaunch._parser().parse_args(_train(arch, "2d", "--device",
                                               "cpu"))
    weights = _reference_params(arch)
    with mock.patch.object(ttr, "init", lambda *a, **k: weights):
        s = tlaunch.build(args)
    params, opt = s.params, s.opt
    losses, norms = [], []
    for _, b in zip(range(STEPS), s.batches(0)):
        params, opt, m = s.step(params, opt, b)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return losses, norms


@pytest.mark.parametrize("case", sorted(TRAIN))
def test_trajectory_matches_reference_and_one_process(runs, case):
    """(i), (ii): every rank reads the same losses and grad norms, held to
    the reference's on 4 host devices and to the port's one-process run
    at rtol 1e-4 (``test_train_trajectory_matches_reference``'s band;
    float32 sums in other orders, measured within 5e-7 here)."""
    got, ref, _ = runs
    arch = TRAIN[case][1]
    for r in range(1, WORLD):
        assert got[r][case]["losses"] == got[0][case]["losses"]
        assert got[r][case]["norms"] == got[0][case]["norms"]
    losses, norms = got[0][case]["losses"], got[0][case]["norms"]
    assert len(losses) == STEPS
    want = ref[REFERENCE_OF.get(case, case)]
    np.testing.assert_allclose(losses, want["losses"], rtol=1e-4)
    np.testing.assert_allclose(norms, want["norms"], rtol=1e-4)
    one_losses, one_norms = _one_process(arch)
    np.testing.assert_allclose(losses, one_losses, rtol=1e-4)
    np.testing.assert_allclose(norms, one_norms, rtol=1e-4)
    assert np.mean(losses[-2:]) < losses[0]


def _makespan64(traffic, order, machine):
    """The float64 makespan of ``order`` on the port's traffic over
    ``machine``'s tree (a 1-d mesh's guessed tree without one)."""
    from repro_torch.core import machine as M
    from repro_torch.core import topology
    from repro_torch.launch import placement as pl
    if machine is None:
        topo = topology.mesh_tree((WORLD,))
    else:
        M.register(M.MachineSpec(
            name=machine["name"], mesh_shape=tuple(machine["mesh_shape"]),
            axes=tuple(machine["axes"]),
            levels=tuple(M.Level(*l) for l in machine["levels"])),
            overwrite=True)
        topo = M.resolve(machine["name"]).topology()
    return pl._side_metrics(np.asarray(traffic, np.float64), topo,
                            np.asarray(order), pl._link_depths(topo),
                            "cpu")["makespan"]


@pytest.mark.parametrize("case", ["q_fsdp_m", "serve"])
def test_topology_aware_order_is_the_references_on_every_rank(runs, case):
    """(ii), (iii), (v): every rank adopts the same searched order and runs
    on a mesh in it; it is the reference's order, or ties with it in
    float64 on the port's traffic (rel 1e-9, the rule of the smoke's
    ``place`` (a)). On ``ranks-2x2`` the trainer's order is not the
    identity. The server's is held on the 1-d serving mesh: the
    reference's one-shot decode is compiled for one device (its
    parameters and cache are never placed), so it maps an empty traffic
    matrix and keeps the identity, and so does the port's on a
    symmetric tree."""
    got, ref, _ = runs
    order = got[0][case]["order"]
    assert all(got[r][case]["order"] == order for r in range(WORLD))
    assert all(got[r][case]["mesh"] == order for r in range(WORLD))
    want = ref[case]["order"]
    machine = MACHINE if case.endswith("_m") else None
    if machine is not None:
        assert want != list(range(WORLD))
    if order != want:
        traffic = got[0][case]["traffic"]
        a = _makespan64(traffic, order, machine)
        b = _makespan64(traffic, want, machine)
        assert abs(a - b) <= 1e-9 * max(abs(b), 1e-30), (order, want)


def test_mapped_server_follows_its_own_traffic(runs):
    """On ``ranks-2x2`` the port's decode step gathers its FSDP-sharded
    weights over ``data`` every step, so its search moves ``data`` onto
    the fast leaf links, as it does for the trainer's ``fsdp`` step; every
    rank decodes on that mesh (the tokens: the test below)."""
    got, _, _ = runs
    order = got[0]["serve_m"]["order"]
    assert order == got[0]["q_fsdp_m"]["order"] != list(range(WORLD))
    assert all(got[r]["serve_m"]["mesh"] == order for r in range(WORLD))


def test_fault_plan_stitches_the_clean_run_and_writes_once(runs):
    """(iv): a leaf death at step 3 resumes from the step-2 checkpoint on
    the launcher's mesh; the stitched losses equal the clean run's bit
    for bit. Rank 0 alone renamed each save into place, and the three
    step directories left (2, 4, 6; pruned to 3) are complete: every leaf
    the manifest lists is there, and no ``.tmp_`` directory is."""
    got, _, tmp = runs
    for r in range(WORLD):
        assert got[r]["fault"]["stitched"] == got[0]["q_2d"]["losses"]
    assert got[0]["fault"]["renames"] == [
        "step_000000002", "step_000000004", "step_000000006",
        "step_000000006"]
    assert all("renames" not in got[r]["fault"] for r in range(1, WORLD))
    root = tmp / "ckpt"
    assert sorted(os.listdir(root)) == [
        "step_000000002", "step_000000004", "step_000000006"]
    for d in os.listdir(root):
        manifest = json.loads((root / d / "MANIFEST.json").read_text())
        files = sorted(os.listdir(root / d))
        assert files == ["MANIFEST.json"] + [
            f"leaf_{i:05d}.npy" for i in range(manifest["n_leaves"])]


@pytest.mark.parametrize("case", sorted(SERVE_CASES))
def test_oneshot_tokens_equal_the_one_process_run(runs, case):
    """(v): greedy tokens on 4 ranks, on the serving mesh and on the
    mapped ``ranks-2x2`` mesh (qwen2), and on that machine's mesh
    (deepseek-v2-lite: MLA's absorbed decode and the MoE layers), equal
    the port's one-process decode from the same weights and prompts."""
    got, _, _ = runs
    args = tserve._parser().parse_args(
        ["--smoke", "--device", "cpu", "--oneshot"] + SERVE_CASES[case][:2]
        + SERVE)
    cfg, dev, params = tserve._setup(args)
    want = tserve.oneshot(params, cfg, dev, args.batch, args.prompt_len,
                          args.gen_len, args.temperature, args.seed,
                          args.rules)[0].tolist()
    for r in range(WORLD):
        assert got[r][case]["tokens"] == want


def test_expert_parallel_route_on_a_real_mesh(runs):
    """``moe_ffn``'s expert-parallel route (``ep_shard_map``: the routed
    experts under ``local_map``, each ``model`` rank dispatching its own
    experts' pairs, their weights all-gathered over ``data``, y summed
    over ``model``) on the 2 x 2 mesh against the local route on plain
    tensors, at capacity 4.0 (nothing dropped on either): float32 sums
    in other orders, within rel 1e-5 of the output's largest entry."""
    got, _, _ = runs
    for r in range(WORLD):
        assert got[r]["moe_ep"]["moe_err"] <= 1e-5


def test_attention_on_shards_cuts_the_kv_heads(runs):
    """The attention site on DTensors (``models.common.
    attention_on_shards``) where the query heads are sharded 4 ways and
    the 2 KV heads cannot be: each rank reads the KV head its query heads
    use (GQA), and its k and v gradients are shares of a sum. Output and
    the three gradients against the plain path, at rel 1e-6 of each's
    largest entry (float32, the same chunked sums)."""
    got, _, _ = runs
    for r in range(WORLD):
        assert got[r]["attn_gqa"]["attn_err"] <= 1e-6


def test_refusals_name_the_roadmap():
    """On a process group the trainer refuses what its mesh does not run
    yet, and the stream server is refused; each message names ROADMAP.
    A one-rank gloo world stands for the group."""
    import torch.distributed as dist
    store = dist.HashStore()
    dist.init_process_group("gloo", rank=0, world_size=1, store=store)
    try:
        for argv in (["--arch", "pna"], ["--arch", Q, "--grad-compress"],
                     ["--arch", Q, "--prefetch", "2"]):
            with pytest.raises(SystemExit, match="ROADMAP"):
                tlaunch.build(tlaunch._parser().parse_args(
                    argv + ["--smoke", "--device", "cpu"]))
        args = tserve._parser().parse_args(
            ["--arch", Q, "--smoke", "--device", "cpu"])
        with pytest.raises(SystemExit, match="ROADMAP"):
            tserve.serve_stream(args)
        with pytest.raises(ValueError, match="gloo process group runs on "
                                             "cpu devices"):
            tlaunch.build(tlaunch._parser().parse_args(
                ["--arch", Q, "--smoke", "--device", "meta"]))
    finally:
        dist.destroy_process_group()


def test_one_rank_world_is_bitwise_the_plain_run(tmp_path):
    """The smoke's ``ranks`` gates on the CPU (``chip_smoke.ranks_runs``)
    at SMOKE and small shapes, on a one-rank gloo world: the train CLI's
    mesh path with real DTensors is bitwise the run without a process
    group (losses, grad norms, parameters, AdamW state), its
    ``--topology-aware`` is a no-op, and the one-shot server's tokens are
    the same, greedy and sampled. One thread: the CPU's accumulating
    ``index_put_`` (the embedding's backward on either path) sums
    duplicate ids in a thread-dependent order."""
    import chip_smoke
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = chip_smoke.ranks_runs(
            "cpu", True, str(tmp_path),
            train=["--steps", "3", "--batch", "2", "--seq", "64"],
            serve=["--oneshot", "--batch", "2", "--prompt-len", "4",
                   "--gen-len", "6"])
    finally:
        torch.set_num_threads(threads)
    assert out["checks"] and all(out["checks"].values()), out["checks"]
