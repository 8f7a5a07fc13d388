#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU: the partitioner, the
two-tower retrieval serving path over a partition-sharded item table,
GIN-TU graph classification through the BSR aggregation kernel, GNN
training (GIN-TU through the kernel both ways, PNA, MeshGraphNet),
EquiformerV2 training (plain PyTorch: the reference has no kernel there),
the
Qwen2-1.5B prefill through the flash-attention kernel with the paged
continuous-batching server, DeepSeek-V2-Lite's MoE + MLA prefill and
absorbed decode, the mesh-mapping search, the paper's C1
comparison against the total-cut baselines, its remaining claims (C2, C3,
C4, the section 3.1 variants, scaling), Qwen2-1.5B training,
DeepSeek-V2-Lite training at full width (its depth cut), the twins of
the placement bench, the serving bench and the 100M-LM example, and the
placement session's trace -> search -> retrace loop over Qwen2-1.5B's
sharded train step, the dry-run's roofline terms over those traces,
anchored to a real Qwen2-1.5B step, and the static verifier's launch
plans held against the card.

    python3 chip_smoke.py

Phases, one JSON line each, all of them on every run; any failure exits
non-zero:

  env      torch/CUDA versions and the card's name and power limit;
  build    nvcc over ``src/repro_torch/csrc/*.cu`` (all sources in
           parallel), with each kernel's -Xptxas -v register / shared
           memory / spill lines and nvcc's warnings and performance notes
           (a serialised wgmma); fails if any kernel spills registers;
  kernels  every kernel against its plain PyTorch version on the card, at
           the main path's shapes (for the bag kernels every shape the
           recsys path gives them: 512, 262,144 and 1 bags, and
           ``gather_combine`` also on a bf16 copy of the table at 512 and
           262,144, held within 1 bf16 ulp plus the float32 band, two
           planted faults failing it, the path each call takes, and the
           card's L2 read rate, from ``csrc/l2_read.cu``, for its
           every-slot bound; ``match_round`` bitwise against the plain
           round on the full cell's level 0 after one round, on
           ``rmat(20000, 120000, 1)``'s hub rows and at a ragged size;
           ``quotient_link_loads`` on random and CSR-local partitions and
           both kernels at the serve pools' k = 4 and, after one death,
           at k = 3 (``guess_tree(3)``); ``partition_gain``
           beside ``scatter_add_`` on bins gathered beforehand and the
           gather + ``scatter_add_`` sequence) and at a
           ragged one, with the device time
           of the kernel, of the plain version and of one PyTorch call
           computing the same function where there is one (L2 flushed
           before each call; ``warm_ms`` without the flush), the time per
           back-to-back call with the host's launch cost (``call_ms``), and
           the least time the H100 could take for the same bytes and
           operations; ``bucket_assign`` and ``torch.searchsorted`` are
           also timed in alternation (one call each per round, 201
           rounds) for a median and quartiles each, and so are the bag
           kernels at one retrieve query beside their plain versions,
           ``torch.bmm`` and ``F.embedding_bag``; ``bag_combine`` at
           train_recsys's forward (32,768 x 50 x 256 float32) beside
           ``torch.bmm``, with its plain backward timed; ``bag_combine`` also on
           bf16 rows and weights at all three recsys shapes, held within 1
           bf16 ulp plus the float32 band and the reference's 5e-2, two
           planted faults failing it; ``prefix_split`` (the device initial
           partition's whole split) at the full cell's coarsest shape, at
           k = 512, at one million vertices (the cooperative path) and at a
           ragged n, bitwise against its plain version for integer weights,
           twice (bitwise), and for float weights within the scan's
           rounding, timed beside the ATen sequence it replaces and the old
           cumsum + ``bucket_assign`` pair (also in alternation), then
           ``initial_partition_device`` on the full cell's coarsest graph:
           one kernel between its two copies in a trace, its wall time
           against the old sequence's in alternation;
  full     ``partition(grid3d(64, 64, 64), gpu-superpod, backend="device")``
           cold, warm, and once more under torch.profiler (device busy
           time, idle share and top kernels, all from that one traced
           run); the warm run's makespan is re-evaluated on the host and
           held to 1.05x the reference's worst device-backend makespan
           over seeds 0-3; ``match_round``, ``prefix_split`` and
           ``quotient_link_loads`` must have launched in the warm run,
           whose ``quotient_link_loads`` launches are grouped by k and
           arc count (powers of two), each group with the device time of
           one call at its largest shape on random and on CSR-local inputs
           and, from one more run that records them, on the path's own
           inputs (``qll_by_shape``; the serve steps report the synthetic
           two);
  small    ``_rmat(2000, 8000)`` on ``balanced_tree((2, 4))``, host
           backend, then the device backend with the launch counts set to
           0 just before it: the path-walking oracle (``verify``) must pass
           for both, the device backend must be within 1.05x of the host
           backend, and all four kernels (``partition_gain`` because every
           level is dense at k = 8) must have launched in the device run;
  recsys   the two-tower model at its full width (``configs/
           two_tower_retrieval.py:FULL``: 1M x 256 item table, towers
           1024-512-256, history 50), launch counts set to 0 just before
           it. Plan: ``RowAccessStats(1_000_000)`` records the ``user_hist``
           bags of ``recsys_batches(..., 512, 50, 16, seed=0)``
           (``RECSYS_PLAN_BATCHES`` batches) and ``plan_shards(stats,
           machine="gpu-superpod")`` places the rows on k = 64 leaves; the
           plan must pass ``check()`` and its makespan must be below a
           seeded random balanced assignment's. Table: ``TwoTower(FULL)``
           from a seed on the card, its item table permuted into a
           ``ShardedEmbeddingTable`` by the plan. Serve: ``score`` with
           ``row_perm`` at ``serve_p99`` (512) and ``serve_bulk``
           (262,144), cold and warm; one traced request of each (after
           one warm-up under the profiler; its bag-kernel events must
           equal the launch counts) gives the device idle share. Lookup: the table's fused ``lookup_bags`` of
           the same histories and of one retrieve query, cold and warm,
           with its own launch counts (``score`` does not call it).
           Retrieve: ``item_embed`` over all 1M items once, then
           ``retrieve(top_k=1024)`` per query, warm. Then, outside the
           counted run: ``score`` and ``user_embed`` equal the unpermuted
           model's bitwise, the 512-bag ``lookup_bags`` equals
           ``embedding_bag`` on the original table bitwise, ``bag_combine``
           on the path's gathered histories and ``lookup_bags``' output
           agree with the plain bag sum at all three shapes, and the top-k
           values equal a full sort's.
           ``bag_combine``, ``gather_combine`` and (in the plan step)
           ``quotient_link_loads`` must have launched.
  gnn      GIN-TU at its full width (``configs/gin_tu.py``, ``molecule``
           shape: 5 layers, width 64, d_in 16, 2 classes, graph-level) from
           seed 0 on the card, every layer aggregating through
           ``bsr_spmm``. The kernels phase first checks and times
           ``bsr_spmm`` on the bulk batch's layout (3,840 block rows,
           11,008 blocks, F = 64), on the request's, and at a ragged shape
           (R = 32, F = 96, an empty block row), each with the tile it
           takes, the 16-column slabs it reads against all of them, and
           two bounds: ``bound_ms`` (x, out and the nonzeros once: what no
           kernel can beat) and ``bound_ms_stored_blocks`` (every stored
           block read once), and each equal bitwise to the kernel's walk
           over every slab (``bitwise_every_slab``). Launch counts set to 0
           just before the counted run, which drives: request, one
           ``molecule_batches(128, 30, 64, 16, 2, seed=0)`` batch
           (``prepare_bsr`` timed on its own), cold, warm, one traced
           request, and end to end from the host's arrays (upload, host
           ``to_bsr``, forward); bulk, 16,384 molecules (491,520 nodes,
           1,947,010 arcs), the same and peak bytes; placed, the
           reference's ``bsr_locality`` graph (``rmat(4096, 32768,
           seed=3)`` on ``balanced_tree((4, 8))``, ``partition()`` seed 0,
           ``block_placement`` / ``apply_placement``): node-level
           ``gin_tu.BASE`` on ``gnn_features(g, 16, 2, seed=0)`` in both
           vertex orders, with the block counts and the kernel's time on
           each layout. ``bsr_spmm`` must have launched 5 times per
           forward, and each traced run (after a warm-up under the
           profiler) must hold as many of its events as it launched. Then, outside the counted run: the kernel against its
           plain version on the path's own layouts and layer inputs, the
           forward against the same forward aggregated by ``gnn_aggregate``
           (the reference's ``segment_sum``), both at both batch sizes, and
           the placed logits, un-permuted, against the unplaced ones.
  gnn_train  GNN training at full width, launch counts set to 0 just
           before it, each run ``GNN_TRAIN_STEPS`` AdamW steps through
           ``train.loop.run`` (lr ``GNN_TRAIN_LR``) with one traced step:
           gin_molecule, GIN-TU's ``molecule`` config from seed 0 on
           ``molecule_batches(128, 30, 64, 16, 2, seed=0)`` with each
           batch's BSR layouts (``gin_layouts``: ``bsr_spmm`` forward on
           A, backward on Aᵀ; 5 + 5 launches a step, counted and traced),
           then 2 steps on the gnn phase's bulk 16,384 molecules;
           pna_minibatch and mgn_minibatch, ``pna.py`` / ``meshgraphnet.py``
           BASE at ``minibatch_lg`` on ``minibatch_batches`` of 1,024 seeds
           over ``random_regular(232,965, GNN_TRAIN_DEGREE)`` (the cut is in
           each line's ``reduced``). Gates: (a) GIN's loss and gradients
           through the kernel against the plain ``edge_apply`` path, on the
           molecules and on them with a seeded half of one direction of
           their edges dropped (``asymmetric_batch``); (b) a backward
           through the forward layout on those arcs must fail (a); (c) PNA
           and MeshGraphNet at full width cut to 2 layers, float32 with
           TF32 off, the card's loss and gradients against the CPU's in
           (a)'s bands; (d)
           finite and the loss comes down in every run; (e) ``bsr_spmm`` on
           the transposed layout on step 1's own cotangents against the
           plain product in float64.
  equiformer  EquiformerV2 at full width (``configs/equiformer_v2.py``
           BASE at ``molecule``: 12 layers, 128 channels, l_max 6, m_max 2,
           8 heads; 103.3M parameters) from seed 0 with ``remat``, float32,
           TF32 off, launch counts set to 0 just before it (no port kernel
           lies on this path, and none launches): ``GNN_TRAIN_STEPS`` AdamW
           steps of ``molecule_batches(128, 30, 64, 16, 2, seed=0)`` (3,840
           nodes, 15,286 arcs and ``pos`` a batch) through ``loop.run`` at
           lr ``EQ_LR``, with one traced step (idle share, top operations):
           s a step, molecules/s, model TFLOP/s, peak bytes. Gates at
           ``EQ_CUT_LAYERS`` layers of full width: (a) finite and the loss
           comes down; (b) step 1's first 16 molecules, the card's loss
           and gradients against the CPU's; (c) the chunked arc path
           (``edge_chunk`` ``EQ_CHUNK``, 4 chunks) against the direct one
           on step 1's 128 molecules, with each one's seconds and peak
           bytes; (d) the logits with every position rotated by a seeded
           rotation, and a planted fault (the value messages rotated back
           by D, not Dᵀ, by replacing ``models.equiformer._rotate``) that
           must fail the band by ``EQ_FAULT_TIMES``x.

  lm       ``qwen2-1.5b`` at full width (``configs/qwen2_1_5b.py:FULL``:
           28 layers, d_model 1536, 12 query heads on 2 KV heads of 128,
           bf16, 3.55 GB) from seed 0. The kernels phase first checks and
           times ``flash_attention`` at the prefill shape and at 32,768
           tokens (library yardstick: ``scaled_dot_product_attention`` with
           ``is_causal`` and ``enable_gqa``). Steps, each with the launch
           counts set to 0 just before it: prefill, 4 prompts of 4,096
           tokens through ``prefill`` (cold, warm, tokens/s, peak bytes, one
           traced forward after a warm-up: 28 ``flash_attention`` launches
           per forward, counted and traced); prefill_long, the grid's
           ``prefill_32k`` sequence with its batch cut from 32 to 1, cold and
           warm; serve, the serving CLI's default stream (16 requests, 4
           slots, page 8, placement every 16 steps on 4 bins, temperature
           0.8, ``--seed 0``) through ``ServingEngine`` (the ``ServeReport``,
           wall ms per step p50/p99, ``map_pages`` calls and seconds, which
           partitioner kernels the server launched), with a traced stretch
           of 4 steps of its greedy run; serve_wide, 64 requests (prompts
           2-256, gens 1-64) on 32 slots, page 16, 1,280 pages;
           serve_chaos (its own phase lines and launch counts), the serve
           stream again with ``CHAOS_PLAN`` (device 1 dies at step 6), at
           0.8 and greedy (one step traced after the recovery), and with
           ``CHAOS_PLAN_PLACED`` (step 12) at 0.8: every request completes
           and none fails, the tokens equal the clean runs', the recovery
           reads device 1 with 3 alive, re-placed exactly where page
           co-access was left to place (none at step 6; at step 12 the
           forced ``map_pages`` over 3 bins must run and launch
           ``quotient_link_loads`` and ``partition_gain`` within the death
           step), every retired page's K and V rows are zero on the card,
           the re-prefilled tokens equal the requeued requests' prompts
           plus replayed tokens (read before the death), and both
           partition kernels launch after the death. Then the
           checks: (a) the kernel against its plain version on layers 0 and
           27's own inputs, both held to the float32 plain version; (b)
           both in float32 at the reference's ``CASES`` and two calls
           bitwise equal; (c) prefill through the kernel against prefill
           through the plain version, greedy tokens agreeing at 99% with
           the weights in float32, and in bf16 at the positions whose top
           two logits are more than 2 bf16 ulps apart; (d) prefill's
           logits on a 64-token prompt against ``decode_step`` stepping
           it, two planted faults failing the band; (e) paged against
           dense decode for 4 slots and 16 steps; (f) the serve stream's tokens identical with placement on
           and off, greedy and at 0.8.
  lm_mla   ``deepseek-v2-lite-16b`` at full width and depth
           (``configs/deepseek_v2_lite_16b.py:FULL``: 27 layers, MLA with
           q/k heads of 192 and v heads of 128, 64 routed experts top-6
           and 2 shared, bf16, 31.4 GB) from seed 0. The kernels phase
           first checks and times ``flash_attention`` at its prefill call
           (4 x 4,096, 16 heads, D = 192, Dv = 128; SDPA's backend
           recorded) and at the reference's MLA-like float32 case. Steps:
           prefill 4 x 4,096 (counted and traced as lm's: 27 launches a
           forward; each MoE layer's dropped share, the aux loss); the
           one-shot CLI path twice and one traced decode step. Checks: (a)
           as lm's on layers 0 and 26; (c) kernel against plain prefill,
           greedy, in bf16 within the spread of two plain chunkings and
           with float32 weights on 1 x 1,024 at 99%; (d) prefill against
           the absorbed decode on 64 tokens at capacity E / k (no drops),
           within the spread of a materialising decode, two planted faults
           failing it; (e) MoE dispatch on the card equal to the CPU's,
           ``moe_ffn`` twice bitwise; (f) the one-shot tokens identical;
           (g) (c) on a 2-layer cut of ``deepseek-v2-236b``.
  mapping  the mesh-mapping search at 512 devices, launch counts set to 0
           just before it, through the rows of the port's bench twin
           (``benchmarks/torch_bench_mapping_search.py``). Scoring: ``bench_mapping_search.py``'s table at
           (2, 16, 16) and (8, 8, 8) on ``mesh_tree(shape)`` with its ring
           traffic (bytes 10^(3-a) on axis a): every enumerated candidate
           (588 and 2,058) scored batched and by the looped canonical
           scorer (one ``quotient_link_loads`` launch and one sync each),
           timed after a warm-up and held together to ``rtol 1e-3, atol
           1e-4 * max|looped|``. Machines: one search each (16 random
           restarts) on ``tpu_v5e-512``, ``gpu-superpod``, ``torus-2d`` and
           ``tpu-mixed-32``; searched <= identity exactly, on the comm
           makespan and on ``capacity_makespan``, and ``recursive=True``
           never worse on the trees. Routing: the sparse scorer against the
           dense oracle on ``torus-2d`` to atol 1e-5 (the reference test's
           traffic, normalised to O(1) loads).
  c1       the paper's C1 table, launch counts set to 0 just before it:
           ``partition`` (device backend), ``total_cut_partition``,
           ``flat_twice_partition`` and ``random_partition`` (seed 0) on
           ``bench_makespan_vs_cut.py``'s three full-tier cases and on the
           full cell's ``grid3d(64, 64, 64)`` / ``gpu-superpod``. Each
           method is scored by ``score_all`` (through the kernel) and by a
           float64 host re-evaluation (rel 1e-4); the modelled SpMV step
           (``max(comp_max, comm_max)``), total cut, seconds and
           ``speedup_vs_cut`` are printed with the cut-refinement's ELL
           widths and bytes. ``speedup_vs_cut`` must land in its band and
           the total-cut imbalance under its limit (``C1_*`` below). Every
           ``partition_gain`` output of the run (the first call at each
           level and k) must equal its plain version on the CPU bitwise,
           and ``total_cut_partition`` with numpy draws (and
           ``C1_REPLAY_ROUNDS`` refinement rounds a level) on the card must
           equal the same call on the CPU vertex for vertex. A control,
           the total-cut partition with its refinement off, is reported
           against the band. The rows come from the port's bench twin
           (``benchmarks/torch_bench_makespan_vs_cut.py: c1_row``).
  claims   the paper's remaining claims through the port's bench twins at
           their full tier, launch counts set to 0 just before it: C2
           (``torch_bench_spmspv``: every BFS round's link loads from
           ``quotient_link_loads`` on the card equal to the host walk's),
           C3 (``torch_bench_tradeoff``), C4 (``torch_bench_hierarchical``),
           the section 3.1 variants (``torch_bench_variants``: the torus
           rows equal to the reference's, the fast bins' load above the slow
           bins') and the scaling rows of ``CLAIMS_SCALING_ROWS``
           (``torch_bench_scaling``: size, k up to 512, the host and device
           V-cycles at 10k and 100k edges). Every checked number must lie in
           its band (``CLAIMS_REF``, from the reference's rows, with C1's
           slack) and every scorecard must equal a float64 host
           re-evaluation at rel 1e-4; ``match_round``, ``prefix_split``,
           ``quotient_link_loads`` and ``partition_gain`` must launch.
  train    ``qwen2-1.5b`` at train_4k's config (FULL, bf16, ``remat``)
           from seed 0, ``TRAIN_STEPS`` AdamW steps of ``lm_batches(151936,
           4, 4096, seed=0)`` through ``train.loop.run`` and
           ``make_train_step`` with the CLI's optimizer settings, launch
           counts set to 0 just before it (56 ``flash_attention`` launches
           a step: 28 forward, 28 in the remat recompute; the backward is
           the plain ``_flash_bwd`` twin): cold and warm (p50) step
           seconds, tokens/s, ``mfu`` (6 N tokens over the step and the
           dense bf16 peak), peak bytes, the loss and grad-norm
           trajectory, one traced step (its 56 kernel events counted),
           the kernel with and without its log-sum-exp and the plain
           backward per layer, timed on layer 0's inputs. Gates: (a) on
           layers 0 and 27's own q, k, v and output cotangents from step
           1, the kernel's lse, its output with and without it, and dq /
           dk / dv through its forward against the float32 plain path
           (``flash_grad_judge``, two planted faults); (b) float32 at FULL
           widths, 2 layers, 1 x 2,048: kernel path against plain path;
           (c) bf16 at full depth, banded by two chunkings of the plain
           path; (d) finite, and the loss comes down; (e) 3 steps with
           ``--grad-compress-block 256``: the first loss bitwise the
           uncompressed one's, ``compress.roundtrip`` of step 1's
           gradients on the card equal to the CPU's bitwise (the CPU's
           round trip runs on a worker thread beside the 3 compressed
           steps); (f) SMOKE on
           the card: 8 steps straight against 4, a checkpoint and a
           resumed ``loop.run``, bitwise.
  train_mla  ``deepseek-v2-lite-16b`` at train_4k's config (FULL widths,
           bf16, remat, capacity factor 1.5) from seed 0, its depth cut to
           ``TRAIN_MLA_LAYERS`` (1 dense + 4 MoE; the cut is in the run
           line's ``reduced``). Gates (a) and (d) first, on step 1's
           params: (a) as train's, on the first and last layers' own q, k,
           v (D = 192, Dv = 128) and output cotangents; (d) each MoE
           layer's aux loss above 0 and its dropped share reported. Then
           ``TRAIN_MLA_STEPS`` AdamW steps of ``lm_batches(102400, 4,
           4096, seed=0)`` through ``loop.run`` at ``TRAIN_MLA_LR``, launch
           counts set to 0 just before (2 ``flash_attention`` launches a
           layer a step, each at (192, 128) in bf16 with its log-sum-exp,
           recorded by wrapping ``kernels.flash_attention.kernel_fwd``):
           cold and warm step seconds, tokens/s, ``mfu``, peak bytes (at
           most ``TRAIN_MLA_PEAK_BYTES``), one traced step; the kernel with
           and without lse, SDPA and the plain backward on layer 0's
           inputs. Gates (b): FULL widths at 2 layers in float32, 1 x 512
           tokens, the MoE layer's expert ids equal on card and CPU, then
           the card's loss, aux and gradients against the CPU's in train
           (b)'s bands, and a planted fault (the router's top-k weights
           detached from autograd, by replacing ``transformer.route``)
           failing them; (c) finite, and the loss comes down.
  train_recsys  two-tower retrieval at full width (1M x 256 item table)
           through the train CLI's ``build`` with ``TRAIN_RECSYS_CLI``
           (``--embed-shard --embed-machine gpu-superpod
           --embed-cache-rows 65536 --embed-probe-batches 1 --prefetch 2``,
           batch 32,768, cut from 65,536: see ``TRAIN_RECSYS_BATCH``), 6
           steps through ``loop.run``, launch counts set to 0 just before
           (one ``bag_combine`` launch a step): seconds a step, examples/s,
           peak bytes, ``plan_shards``' seconds, the cache's counters, one
           traced step. Gates: (a) step 1's loss and gradients, kernel path
           against plain path, float32; (b) dense, masked and sparse row
           updates bitwise on step 1's table gradients; (c) the same step
           twice bitwise; (d) ``run_supervised`` with a leaf death at step
           3 and a checkpoint every 2 steps: the stitched losses and the
           final params, AdamW and Adagrad state bitwise the clean run's,
           resumed from 2; (e) finite, the loss comes down; (f) the
           hot-row cache's invariants, its traffic below the replicated
           baseline, the prefetcher ran ahead.
  placement  ``benchmarks/torch_bench_placement.py``'s four rows at the
           full tier (expert placement on a 2 x 8 x 10 tree and on
           ``tpu-mixed-32``, embedding rows on ``production_tree(2, 4,
           4)``, BSR locality), launch counts set to 0 just before: each
           number that the partition seed moves within its
           ``CLAIMS_REF`` band (the reference's rows over seeds 0-3 with
           C1's slack), each that no seed moves (the scatter and hash
           baselines, the unplaced layout's blocks, the fast pod's FLOPs)
           within rel 1e-6 of the reference's (``CLAIMS_EXACT``), each
           scorecard against a
           float64 host re-evaluation at rel 1e-4, the bench's
           heterogeneous claims (they raise inside the twin).
  place    ``PlacementSession.place`` (``recompile=True``) at full width,
           traced on meta DTensors over a fake world: qwen2-1.5b FULL at
           train_4k (28 layers, 256 x 4,096) and DeepSeek-V2-Lite FULL
           (27 layers, MoE + MLA) with the 2d, fsdp, sp and expert
           profiles on ``tpu_v5e-512``; qwen2 2d on ``gpu-superpod``; PNA
           at minibatch_lg and the two-tower model at train_batch on
           ``tpu_v5e-512``; qwen2's decode_32k on ``gpu-superpod``. One
           child process a cell, at most 8 at a time, the searches on the
           card, launch counts set to 0 just before each: (a) each search
           again on the card and on the CPU on the same traffic, the same
           order or a float64 tie, and the card's makespan within rel 1e-4
           of the CPU order's float64 score; (b) searched <= identity;
           (c) an identity -> identity retrace diffs to 0 (two cells); (d)
           ``lint_traffic`` clean; (e) expert equals 2d on qwen2; (f)
           ``quotient_link_loads`` launched; the kernel at the largest call
           of the DeepSeek expert searches timed against its plain
           version. Each train_4k cell's ratio and perm beside the
           reference's ``EXPERIMENTS.md`` row (reported).
  dryrun   the dry-run CLI (``launch/dryrun.py``) over its cost model
           (``launch/op_cost.py``) on the cells ``place`` traced, read from
           its trace cache (nothing is traced again): (a) ``python -m
           repro_torch.launch.dryrun --mapping-grid`` for qwen2-1.5b and
           DeepSeek-V2-Lite (one child each) and ``run_cell`` on
           ``place``'s four other cells: each ``status: ok`` with the
           reference's result keys, finite counts, FLOPs and tight bytes
           above 0, perm and ratio those of ``place``'s first search (or
           an order tied with it in float64), ``quotient_link_loads``
           launched; (b) the anchor: qwen2-1.5b FULL train_4k at the train
           phase's batch on a (1, 1) mesh, its meta record against the same
           step run once on the card under the same recorder (FLOPs,
           bytes, tight bytes, transcendentals within rel 1e-9), the
           predicted peak within [0.85, 1.15] of ``max_memory_allocated``,
           ``step_time_bound_s`` at gpu-superpod's capacities at most 1.05x
           the median of 3 warm steps, the attention declared
           n_layers x (1 + remat) times forward and n_layers times
           backward at ``attention_cost``, and two planted faults (frees
           ignored; the attention site off), recorded on the same card
           step, failing; (c) ``lint_cell`` on the grid's eight cells (two
           children, one trace an arch): no error. One line per cell: the
           three terms, the dominant one, the useful ratio, per-device
           FLOPs, tight bytes and peak bytes; the bound of
           ``quotient_link_loads`` at ``place``'s largest search call.
  serving_bench  ``benchmarks/torch_bench_serving.py`` at its full tier
           (32 requests, 8 slots, page 8: continuous, static, placed every
           8 steps on 4 bins, a leaf death at a third of the steps), launch
           counts set to 0 just before: at qwen2-1.5b SMOKE from seed 0
           every schedule field of the three rows without a fault equal to
           the reference's (``SERVING_REF``), the chaos row reported beside
           the reference's; then at qwen2-1.5b FULL in bf16 from seed 0,
           tokens/s recorded. The bench's claims raise inside the twin in
           both runs. The engine steps through the paged decode, so no
           ``flash_attention`` launches here; ``map_pages`` runs the
           partitioner kernels.
  lm100m   ``flash_attention`` at the example's shape (4 x 128, 8 heads
           on 4, D = 64, float32) with its log-sum-exp, out and lse held
           to the plain forward at FLASH_F32_TOL; then
           ``examples/torch_train_lm_100m.py`` at its defaults (12 x 512
           float32, 4 x 128, checkpoints every 100) but 100 steps, not
           300 (``LM100M_STEPS``: the smoke's time limit), in a
           process of its own: it exits 0 (its own learned-assert),
           its checkpoint at step 100 is written, and the launch counts
           it prints (its own counters, zeroed before its loop) show one
           ``flash_attention`` launch a layer a step (float32, D = 64,
           with lse: the SIMT kernel).
  kernel_plans  the launch plans (``kernels/plan.py``) every launch is
           built from, in this process (``phase_kernel_plans``; under 15
           s): (a) every plan the paths above launched, read from the plan
           caches, the full-width ones among them, verifies with no error
           or warning under the card's own ``DeviceModel``
           (``analysis.kernels``); (b) each kernel instance's
           ``cudaFuncGetAttributes`` against its plans, and each
           cooperative plan's residency on the card at least the static
           check's; (c) every registered example plan launched into
           sentinel-filled outputs: none left, bitwise the public
           wrapper, within the kernels phase's band of the plain version;
           (d) two planted faults, each failing statically and on the
           card; (e) ``python -m repro_torch.analysis`` in a child.

Then one line ``{"kernels": [...]}``: each kernel's launches on the path
that drives it (``full`` for the partitioner's kernels but
``partition_gain``, ``small`` for it; ``match_keys`` and
``bucket_assign``, which no path launches since the coarsening runs each
round as ``match_round`` and the initial split runs as ``prefix_split``,
with 0 and ``on_path_as``; ``recsys`` for the bag kernels,
``gnn`` for ``bsr_spmm``, which also launches on ``gnn_train``, ``lm`` for
``flash_attention``, which also
launches on ``train``, ``train_mla`` and ``lm100m``; ``serve_chaos``,
``train_recsys``, ``placement``, ``place``, ``dryrun`` and ``serving_bench``
are paths too), its
launches
on every path (``serve`` and ``serve_wide`` show which partitioner
kernels the server reaches; ``mapping``, ``c1`` and ``claims`` that the
search, the baselines and the claims' twins run ``quotient_link_loads``
and ``partition_gain``), and the
kernels phase's numbers at the main path's shape (``flash_attention`` also
at 32,768 tokens, ``long``; the bag kernels their one-query alternation,
``retrieve_query``, and ``bag_combine`` its training shape and plain
backward, ``train``; ``gather_combine``, ``bag_combine`` (bf16 too),
``match_round`` and ``prefix_split`` every shape, ``shapes``, and
``prefix_split`` its alternation and ``initial_partition_device``'s wall;
``bsr_spmm`` its second bound, tile and slabs read, and its rows on the
gnn_train backward's transposed layouts, ``transposed``;
``flash_attention`` its training shapes, ``train`` and ``train_mla``).
Just before the kernels line, one line ``{"phase": "timing", ...}``: each
phase's seconds and the total. Last, the result line ``{"ok": true,
"device": {...}}``.
Without a CUDA device it exits 2 and prints no result; it never runs on the
CPU.
"""
from __future__ import annotations

import contextlib
import concurrent.futures
import dataclasses
import functools
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# Worst makespan of the reference (JAX) device backend on the full phase's
# problem over seeds 0..3 (32593.5, 32584.5, 38457.0, 34573.5; jax 0.9.0 on
# a CPU), from
#   PYTHONPATH=src JAX_PLATFORMS=cpu python -c "from repro.core.machine import
#   MachineSpec; from repro.core.partitioner import PartitionConfig, partition;
#   from repro.graph.generators import grid3d; g = grid3d(64, 64, 64);
#   t = MachineSpec.preset('gpu-superpod').tree(); print(max(partition(g, t,
#   PartitionConfig(seed=s, backend='device')).makespan for s in range(4)))"
# The seed alone moves the reference by up to 18%, so the band is taken
# over seeds, not at one seed.
REF_DEVICE_MAKESPAN_MAX = 38457.0
QUALITY_BAND = 1.05

# NVIDIA H100 SXM data sheet: HBM3 bytes/s, float32 (non-tensor) FLOP/s and
# the dense bf16 tensor-core FLOP/s
H100_BYTES_PER_S = 3.35e12
H100_F32_PER_S = 67e12
H100_BF16_PER_S = 989e12

# Batches of 512 recorded histories behind the recsys phase's shard plan
RECSYS_PLAN_BATCHES = 100
RECSYS_TOP_K = 1024
RECSYS_QUERIES = 8

# GIN-TU's molecule cell: 128 molecules of 30 atoms / 64 bonds per request
# (configs/common.py GNN_SHAPE_META["molecule"]); the bulk batch is 128
# requests in one
GNN_REQUEST_GRAPHS = 128
GNN_BULK_GRAPHS = 16_384
# logits through the kernel against another float32 sum order (segment_sum,
# the placed layout): |diff| <= GNN_RTOL * (max|logit| + |logit|); the CPU
# parity tests measure 2.8e-7 of the largest logit against the reference
GNN_RTOL = 1e-5
BSR_TOLERANCE = ("rtol 1e-6 + 2*K*2^-24*(|A| @ |x|), K = R x most blocks in "
                 "a block row (two float32 sums in different orders)")

# The gnn_train phase: GIN-TU (molecule), PNA and MeshGraphNet
# (minibatch_lg) at their BASE widths and depths, GNN_TRAIN_STEPS AdamW
# steps each through train.loop.run with the train CLI's optimizer
# settings. minibatch_lg's parent graph is cut from 232,965 nodes of mean
# degree 492 (114,615,892 arcs) to random_regular(232,965, 50): 11,646,970
# arcs (rmat at that node count leaves 239,540 of the 337,920 arc slots to
# padding); its batches are the grid's 1,024 seeds with fanout (15, 10),
# padded to 169,984 nodes and 337,920 arcs.
GNN_TRAIN_STEPS = 6
# the CLI's 3e-3 without warm-up (6 steps) throws PNA's loss up at step 3
# and it is not back below step 1's by step 6's mean (gate (d)); the
# reference's make_train_step does the same on the same params and batches
# (scripts/gnn_train_lr_reference.py: PNA at 128 seeds of this stream)
GNN_TRAIN_LR = 1e-3
GNN_TRAIN_DEGREE = 50
# gate (c): PNA and MeshGraphNet at full width cut to this many layers
GNN_TRAIN_CUT_LAYERS = 2
# gates (a), (c): train (b)'s float32 bands (loss rel, per-leaf rel L2)
GNN_TRAIN_LOSS_RTOL = 1e-5
GNN_TRAIN_GRAD_REL_L2 = 1e-4

# The equiformer phase: EquiformerV2 at full width (configs/equiformer_v2.py
# BASE at the molecule shape: 12 layers, 128 channels, l_max 6, m_max 2, 8
# heads, d_in 16, 2 classes, graph-level) with remat on (one layer's
# edge-frame tensors, [arcs, 49, 256] float32, are several GB), float32 with
# TF32 off, on molecule_batches(128, 30, 64, 16, 2, seed=0): GNN_TRAIN_STEPS
# AdamW steps at EQ_LR. Gates (b)-(d) cut the depth to EQ_CUT_LAYERS:
# (b) step 1's first EQ_CPU_GRAPHS molecules, card against CPU in the
# gnn_train bands; (c) step 1's 128 molecules with edge_chunk EQ_CHUNK
# against 0 (logits within GNN_RTOL's band); (d) the logits of (c) with
# every position rotated by a seeded rotation, within EQ_INVARIANCE_TOL of
# the largest logit (float32; the CPU reads 4.3e-7 at 16 molecules), and the
# planted fault (value messages rotated back by D, not its transpose) at
# least EQ_FAULT_TIMES the band (the CPU reads 2.9e-2 there).
# gnn_train's 1e-3 without warm-up (6 steps) throws the loss up after the
# first step in both packages on the same params and batches (the reference
# 1.04 -> 4.47 at 1e-3, 1.04 -> 1.77 at 3e-4, not at 1e-4;
# scripts/equiformer_lr_reference.py, full width on 16 molecules a step),
# and the card's run at 1e-3 ends above its first loss (0.704 -> 6.68,
# ..., 1.13, 0.753: gate (a) fails); scripts/equiformer_lr_card.py reads
# the card's trajectory at each rate
EQ_LR = 1e-4
EQ_CUT_LAYERS = 2
EQ_CPU_GRAPHS = 16
EQ_CHUNK = 4096
EQ_INVARIANCE_TOL = 1e-3
EQ_FAULT_TIMES = 10

# The LM phase: qwen2-1.5b at full width (configs/qwen2_1_5b.py FULL, bf16,
# random weights from seed 0). prefill: 4 prompts of 4,096 tokens; its
# long step is the grid's prefill_32k sequence (configs/common.py) with the
# batch cut from 32 to 1 (32 sequences' logits alone would be 318 GB).
LM_ARCH = "qwen2-1.5b"
LM_PREFILL = (4, 4096)
LM_LONG = (1, 32768)
# serve: the serving CLI's default stream (launch/serve.py: 16 requests,
# prompts 2-16, gens 1-32, 4 slots, page 8, placement every 16 steps on 4
# bins, temperature 0.8, --seed 0); serve_wide: a pool a deployment would
# hold (64 requests, prompts 2-256, gens 1-64, 32 slots, page 16, at most
# 20 pages per request, 1,280 pages: 0.59 GB of K/V)
LM_SERVE = dict(num_requests=16, prompt_len=16, gen_len=32, slots=4,
                page_size=8, n_pages=0, seed=0)
LM_SERVE_POLICY = dict(replace_every=16, place_devices=4)
LM_WIDE = dict(num_requests=64, prompt_len=256, gen_len=64, slots=32,
               page_size=16, n_pages=0, seed=0)
LM_WIDE_POLICY = dict(replace_every=64, place_devices=4)
LM_TEMPERATURE = 0.8
# bucket_assign against torch.searchsorted, and the bag kernels at one
# retrieve query against their plain versions and library calls: rounds of
# one call each
BUCKET_RANKING_ROUNDS = 201
BAG_RANKING_ROUNDS = 201
# Idle seconds between the profiler's switch to its recorded cycle and the
# run it records: a run launched at once sometimes loses its first device
# events from the trace, or all of them (trace_gap.py counts how often,
# with and without this gap).
TRACE_GAP_S = 0.05
# Traces taken before a trace that still lost events fails the run: the
# gap makes a loss rare, not impossible (one serve_bulk trace of the recsys
# phase lost its one port kernel in PR 22's smokes); a trace is reported
# only when it holds every launch.
TRACE_ATTEMPTS = 3
# flash_attention against its plain version: the reference's float32 band
# for its kernel (tests/test_flash_kernel.py: rtol = atol = 2e-5 at its
# CASES). In bf16 an absolute band says little at long sequences (the
# output's rms is 0.027 at 32,768 random keys), so the kernel is held to
# the function's value, the plain version in float32 on the same bf16
# inputs: its error against that, largest and root mean square, at most
# FLASH_BF16_RATIO times the bf16 plain version's own, 1.00x on one H100
# (PERF.md section 2). Two planted faults (the output scaled by 1 + 2^-7;
# one kv tile's values zeroed) must fail it: they read 3.4x or more.
FLASH_CASES = [(2, 64, 64, 4, 2, 32, True), (1, 100, 100, 4, 1, 16, True),
               (2, 64, 64, 8, 8, 32, False), (1, 128, 128, 4, 2, 64, True)]
FLASH_F32_TOL = 2e-5
FLASH_BF16_RATIO = 2.0
# the reference's MLA-like float32 case (tests/test_flash_attention.py):
# (b, sq, sk, h, kh, d, dv, causal)
MLA_F32_CASE = (2, 33, 33, 4, 2, 24, 16, True)
# the kernel's log-sum-exp against the bf16 plain forward's on the same
# inputs (natural-log units of the scaled scores): both are float32 sums of
# the same bf16 products in other orders, the kernel's exponentials in
# base 2 (ex2.approx)
TRAIN_LSE_TOL = 1e-4
# prefill through the kernel against prefill through the plain version
# (PERF.md section 2): greedy next tokens agree at this share of positions,
# in float32 at every position; in bf16 at the positions whose top two
# logits (the plain version's) are more than LM_BF16_TIE_ULPS bf16 ulps of
# the top logit apart (70% of them on one H100). Random weights tie the
# top two in bf16 at 6.4% of positions, and two correct bf16 forwards
# differ by up to 5 ulps of the largest logit.
LM_GREEDY_AGREE = 0.99
LM_BF16_TIE_ULPS = 2
# prefill's logits against decode_step stepping the same 64-token prompt
# (PERF.md section 2): |d| <= LM_STEP_BAND * max|logit|, 2.5x the 1.6%
# read on one H100 (a 64-row GEMM against one row at a time, online
# against one-pass softmax, over 28 bf16 layers). Two planted faults,
# read at 122% and 64%, must fail it: a decode whose cache is zeroed
# before every step, and one stepped a position on.
LM_STEP_BAND = 0.04
# paged against dense decode: the reference's band (tests/test_serving.py)
LM_PAGED_RTOL = 1e-5

# The lm_mla phase: deepseek-v2-lite-16b at full width and depth
# (configs/deepseek_v2_lite_16b.py FULL: 27 layers, MLA, 64 routed experts
# top-6 and 2 shared, bf16, 31.4 GB), random weights from seed 0, nothing
# cut: prefill at the Qwen cell's 4 x 4,096, the absorbed decode, the
# one-shot CLI path (launch/serve.py's defaults: 4 prompts of 16 tokens,
# 32 generated). Its checks use lm's bands; (d) compares prefill with the
# stepped decode at a capacity factor of E / k, where neither drops a pair
# (at the config's 1.5 prefill's 256 slots an expert and decode's 8 drop
# different pairs: different functions). The band for (d) is the larger of
# LM_STEP_BAND and MLA_STEP_SPREAD times what a second correct decode,
# one that materialises k_nope and v from the same cache, reads against
# prefill (PERF.md section 2).
MLA_ARCH = "deepseek-v2-lite-16b"
MLA_ONESHOT = dict(batch=4, prompt_len=16, gen_len=32, temperature=0.8,
                   seed=0)
MLA_STEP_SPREAD = 2.0
# check (c) in float32: the weights take 62.8 GB, so one prompt of 1,024
MLA_F32_PREFILL = (1, 1024)
# a 2-layer cut of deepseek-v2-236b (one dense, one MoE layer at full
# width, ~10 GB): check (c) on a 1 x 2,048 prefill covers the q_lora branch
# and 128 heads at D = 192 on the kernel
MLA_236B_LAYERS = 2
MLA_236B_PREFILL = (1, 2048)

# The train phase: qwen2-1.5b at train_4k's config (configs/qwen2_1_5b.py
# FULL: 28 layers, bf16, remat) from seed 0, TRAIN_STEPS steps of
# lm_batches(vocab, 4, 4,096, seed=0) through the CLI's optimizer settings
# (launch/train.py: lr 3e-3, warm-up min(20, steps // 10)). train_4k's
# batch of 256 sequences is cut to 4: one card holds one data-parallel
# replica, and 4 x 4,096 is the prefill cell's token count.
TRAIN_BATCH = (4, 4096)
TRAIN_STEPS = 6
TRAIN_LR = 3e-3
# gate (b): the kernel path against the plain path in float32 at FULL widths
# with 2 layers, 1 x 2,048 tokens (the SIMT kernel): the first step's loss
# to rel 1e-5, each gradient leaf to a relative L2 of 1e-4 (float32 sums in
# other orders; the CPU parity tests read 2.4e-6 against the reference)
TRAIN_F32_LAYERS = 2
TRAIN_F32_BATCH = (1, 2048)
TRAIN_F32_LOSS_RTOL = 1e-5
TRAIN_F32_GRAD_REL_L2 = 1e-4
# gate (c): bf16 at full depth, the kernel path against the plain path
# (kv_chunk 512), the worst leaf's relative L2 and the loss's relative
# difference each at most FLASH_BF16_RATIO times the spread between two
# chunkings of the plain path (kv_chunk 512 against 256); a spread below
# float32's epsilon counts as that epsilon
TRAIN_PLAIN_CHUNKS = (512, 256)
# gate (e): TRAIN_COMPRESS_STEPS steps with --grad-compress-block
TRAIN_COMPRESS_STEPS = 3
TRAIN_COMPRESS_BLOCK = 256
# gate (f): resume at the SMOKE config on the card: TRAIN_RESUME_STEPS
# straight against a checkpoint at TRAIN_RESUME_AT and a fresh run that
# resumes, 4 x 64 tokens a step
TRAIN_RESUME_STEPS = 8
TRAIN_RESUME_AT = 4
TRAIN_RESUME_BATCH = (4, 64)

# The train_mla phase: deepseek-v2-lite-16b at train_4k's config (FULL
# widths, bf16, remat, capacity factor 1.5) from seed 0, its depth cut from
# 27 layers to TRAIN_MLA_LAYERS (the first dense, the rest MoE): one card
# holds no more (PERF.md section 4: AdamW's update makes new params and
# moments beside the old ones, ~23 bytes a parameter at its peak, and a
# MoE layer holds 584.8M parameters; scripts/mla_train_memory.py read
# 53.5 / 66.3 / 79.2 GB at 4 / 5 / 6 layers), TRAIN_MLA_STEPS AdamW steps of
# lm_batches(102400, 4, 4,096, seed=0) at TRAIN_MLA_LR through loop.run;
# the peak must stay below TRAIN_MLA_PEAK_BYTES.
TRAIN_MLA_LAYERS = 5
TRAIN_MLA_BATCH = (4, 4096)
TRAIN_MLA_STEPS = 6
TRAIN_MLA_LR = 3e-3
TRAIN_MLA_PEAK_BYTES = 72e9
# gate (b): FULL widths cut to 2 layers (1 dense + 1 MoE), float32, TF32
# off, 1 x 512 tokens: the card's loss, aux and gradients against the
# CPU's in train (b)'s bands, once the MoE layer's expert ids are equal
TRAIN_MLA_F32_LAYERS = 2
TRAIN_MLA_F32_BATCH = (1, 512)

# The serving_bench phase: benchmarks/torch_bench_serving.py's full tier
# (32 requests, 8 slots, page 8) twice: at qwen2-1.5b SMOKE from seed 0,
# as the reference bench runs it, where every schedule field of the rows
# without a fault must equal the reference's full-tier row (python -m
# benchmarks.bench_serving, jax 0.9.0 on a CPU; the schedule depends on the
# workload and the scheduler only); and at qwen2-1.5b FULL in bf16 on the
# same workload shape, where the bench's own claims must hold. The chaos
# row's retries depend on where placement put the pages, so its schedule
# is reported beside the reference's and gated by the bench's claims only.
SERVING_REF = {
    "continuous_x8": dict(steps=85, tokens_out=271, latency_p50=45.5,
                          latency_p99=84.69, ttft_p50=38.5, ttft_p99=83.69,
                          occupancy=0.9353),
    "static_x8": dict(steps=122, tokens_out=271, latency_p50=65.5,
                      latency_p99=121.69, ttft_p50=59.0, ttft_p99=120.0,
                      occupancy=0.6516),
    "continuous_placed_x8": dict(steps=85, tokens_out=271, latency_p50=45.5,
                                 latency_p99=84.69, ttft_p50=38.5,
                                 ttft_p99=83.69, occupancy=0.9353),
}
SERVING_REF_CHAOS = dict(steps=100, tokens_out=271, latency_p50=53.0,
                         latency_p99=99.38, ttft_p50=42.5, ttft_p99=87.0,
                         occupancy=0.8588, requests_retried=4,
                         tokens_reprefilled=59)

# serve_chaos: the lm serve stream (LM_SERVE, LM_SERVE_POLICY) with this
# fault plan, at LM_TEMPERATURE and greedy, on the same weights. Up to step
# 7 every request's tokens fit its first page, so the measured page
# co-access is empty at step 6 and the forced re-placement has nothing to
# place (the reference's rule: no traffic, no placement; PR 23's first
# card run read replaced=false). CHAOS_PLAN_PLACED kills the same device
# at step 12, after 32 co-access counts, where the forced map_pages over
# the 3 survivors must run
CHAOS_PLAN = "6:leaf_death:1"
CHAOS_PLAN_PLACED = "12:leaf_death:1"
# train_recsys: two-tower retrieval at full width (configs/
# two_tower_retrieval.py:FULL) through the train CLI's own code, at the
# CLI's learning rate. The batch is cut from the grid's 65,536 to 32,768:
# each [B, B] float32 logits tensor is 17.2 GB at 65,536 and the loss holds
# about four at once (logits, logits after logQ, the logsumexp's
# exponentials, the softmax gradient), ~69 GB before the 3.4 GB of gathered
# rows and their gradient; at 32,768 that count is ~25 GB. One probe batch
# (32,768 bags) builds the co-access graph (see PERF.md for the seconds).
TRAIN_RECSYS_BATCH = 32_768
TRAIN_RECSYS_STEPS = 6
TRAIN_RECSYS_CLI = ["--arch", "two-tower-retrieval", "--steps",
                    str(TRAIN_RECSYS_STEPS), "--batch",
                    str(TRAIN_RECSYS_BATCH), "--embed-shard",
                    "--embed-machine", "gpu-superpod", "--embed-cache-rows",
                    "65536", "--embed-probe-batches", "1", "--prefetch", "2"]
# gate (a): kernel path against plain path, float32: train (b)'s bands
# (TRAIN_F32_LOSS_RTOL, TRAIN_F32_GRAD_REL_L2); gate (d): run_supervised
# with this plan and a checkpoint every TRAIN_RECSYS_CKPT_EVERY steps
TRAIN_RECSYS_FAULTS = "3:leaf_death:1"
TRAIN_RECSYS_CKPT_EVERY = 2

# The mapping phase: bench_mapping_search.py's full-tier scoring table at
# its two 512-device meshes (the Qwen2 production mesh and the cube), on
# mesh_tree(shape), then its machine sweep (the port's twin,
# benchmarks/torch_bench_mapping_search.py, runs both)
MAPPING_SHAPES = [(2, 16, 16), (8, 8, 8)]
MAPPING_MACHINES = ["tpu_v5e-512", "gpu-superpod", "torus-2d", "tpu-mixed-32"]
# The C1 phase's bands, from the reference's own rows over seeds 0-3
# (scripts/c1_reference_rows.py, jax 0.9.0 on a CPU; PERF.md section 2).
# speedup_vs_cut read 4.64-5.53 (grid2d_64), 6.16-6.96 (grid3d_16),
# 4.01-4.07 (rmat_20000) and 5.63-6.52 (full); the port draws other
# numbers than any reference seed, so the band reaches C1_SPEEDUP_SLACK
# beyond the reference's extremes each way (the port's CPU runs over seeds
# 0-3 read 4.13-5.75, 6.12-6.91 and 4.11-4.18).
C1_SPEEDUP_SLACK = 1.25
C1_REF_SPEEDUPS = {"grid2d_64": (4.6351, 5.5264),
                   "grid3d_16": (6.1577, 6.9561),
                   "rmat_20000": (4.0122, 4.0669),
                   "full": (5.6250, 6.5188)}
C1_SPEEDUP_BAND = {case: (lo / C1_SPEEDUP_SLACK, hi * C1_SPEEDUP_SLACK)
                   for case, (lo, hi) in C1_REF_SPEEDUPS.items()}
# total_cut_partition's imbalance: the reference's largest over seeds 0-3
# plus twice the constraint's epsilon (0.05): the constraint only stops
# moves, so what the coarsest split leaves stays, and other draws move it
# (the port's CPU runs read up to 0.211 on grid3d_16 against 0.164)
C1_REF_CUT_IMBALANCE = {"grid2d_64": 0.87890625, "grid3d_16": 0.1640625,
                        "rmat_20000": 0.05280006, "full": 2.23754883}
C1_IMBALANCE_MARGIN = 0.10
# The card-against-CPU replay of total_cut_partition (numpy draws on both)
# runs this many refinement rounds a level, not the method's 64: the CPU's
# plain rounds took 39.3 s on rmat_20000 (its ELL pads 133x) and 22.8 s on
# the full cell of the c1 phase's 117 s at 64, 11.9 s and 14.0 s of its
# 85 s at 16 (measured on one H100); every level's conn, argmax, capacity
# and thinning still run on both
C1_REPLAY_ROUNDS = 4
# The claims phase's bands, from the reference's own rows
# (scripts/claims_reference_rows.py, jax 0.9.0 on a CPU; PERF.md section
# 2): the least and the largest of each checked number over seeds 0-3;
# the port's row must lie in [min / CLAIMS_SLACK, max * CLAIMS_SLACK],
# C1's slack. Filled in below from the script's rows.
CLAIMS_SLACK = C1_SPEEDUP_SLACK
CLAIMS_REF = {}
# the torus rows score the same numpy draw through the same host oracle as
# the reference's, so they must equal its rows
CLAIMS_TORUS = {}
# (scripts/claims_reference_rows.py --bands over its rows)
CLAIMS_REF.update({
    ('hierarchical', 'grid3d_14', 'hybrid_vs_flat'): (1.344, 1.9516),
    ('hierarchical', 'grid3d_14', 'ratio'): (0.2978, 0.4896),
    ('hierarchical', 'rmat_10000', 'hybrid_vs_flat'): (1.6575, 1.6836),
    ('hierarchical', 'rmat_10000', 'ratio'): (1.6727, 1.7217),
    ('scaling', 'k_1x16x16', 'makespan'): (557.0, 882.0),
    ('scaling', 'k_1x4x4', 'makespan'): (4121.0, 4145.0),
    ('scaling', 'k_2x16x16', 'makespan'): (2896.0, 6888.0),
    ('scaling', 'size_10000', 'makespan'): (17667.0, 18390.0),
    ('scaling', 'size_10000', 'vs_random'): (13.0845, 13.62),
    ('scaling', 'size_100000', 'makespan'): (51546.0, 53254.0),
    ('scaling', 'size_100000', 'vs_random'): (45.0396, 46.5322),
    ('scaling', 'size_400000', 'makespan'): (420916.0, 420916.0),
    ('scaling', 'size_400000', 'vs_random'): (22.8401, 22.8402),
    ('scaling', 'vcycle_10000', 'device_bottleneck'): (725.0, 1193.0),
    ('scaling', 'vcycle_10000', 'device_makespan'): (2485.0, 3300.0),
    ('scaling', 'vcycle_10000', 'host_bottleneck'): (1051.0, 1315.0),
    ('scaling', 'vcycle_10000', 'host_makespan'): (2237.0, 2554.0),
    ('scaling', 'vcycle_100000', 'device_bottleneck'): (5672.0, 5672.0),
    ('scaling', 'vcycle_100000', 'device_makespan'): (22088.0, 22088.0),
    ('scaling', 'vcycle_100000', 'host_bottleneck'): (10328.0, 11325.0),
    ('scaling', 'vcycle_100000', 'host_makespan'): (21374.0, 22331.0),
    ('scaling', 'vcycle_1000000', 'device_bottleneck'): (61489.0, 61489.0),
    ('scaling', 'vcycle_1000000', 'device_makespan'): (222938.0, 222938.0),
    ('scaling', 'vcycle_1000000', 'host_bottleneck'): (109459.0, 109459.0),
    ('scaling', 'vcycle_1000000', 'host_makespan'): (240485.0, 240485.0),
    ('spmspv', 'high_diam_grid', 'ratio'): (1.612, 2.3972),
    ('spmspv', 'low_diam_rmat', 'ratio'): (8.3901, 8.8098),
    ('tradeoff', 'cut_eps0.03', 'makespan'): (792.0, 1632.0),
    ('tradeoff', 'cut_eps0.1', 'makespan'): (780.0, 1170.0),
    ('tradeoff', 'makespan_F0.05', 'makespan'): (303.0, 364.0),
    ('tradeoff', 'makespan_F0.2', 'makespan'): (303.0, 399.0),
    ('tradeoff', 'makespan_F1.0', 'makespan'): (342.0, 534.0),
    ('tradeoff', 'makespan_F5.0', 'makespan'): (1740.0, 2550.0),
    ('variants', 'fat_tree_Fl', 'makespan'): (66.0, 68.0),
    ('variants', 'fat_tree_Fl', 'makespan_cut_baseline'): (69.0, 91.0),
    ('variants', 'hetero_speeds', 'makespan'): (2888.0, 3228.335),
    ('variants', 'routers_16bins', 'makespan'): (68.0, 74.0),
    ('variants', 'vertex_weighted', 'makespan'): (2933.0, 3106.0),
})
CLAIMS_TORUS.update({
    'torus_multipath=False': {'makespan': 1516.0, 'max_link': 1516.0, 'total_link': 17707.0},
    'torus_multipath=True': {'makespan': 1072.0, 'max_link': 1072.0, 'total_link': 17785.0},
})
# (end of the generated bands)
# The placement phase: benchmarks/torch_bench_placement.py's full tier on
# the card, each number the partition seed moves within [min /
# CLAIMS_SLACK, max * CLAIMS_SLACK] of the reference's rows over partition
# seeds 0-3 (scripts/placement_reference_rows.py, jax 0.9.0 on a CPU; C1's
# slack: the port draws other numbers than any reference seed), and each
# number no seed moves (the baselines score the bench's own draws) in
# CLAIMS_EXACT: within CLAIMS_EXACT_RTOL of max(|value|, 1), float32 sums
# in another order
CLAIMS_EXACT = {}
CLAIMS_EXACT_RTOL = 1e-6
# (scripts/placement_reference_rows.py --bands over its rows)
CLAIMS_REF.update({
    ('placement', 'bsr_locality_4096', 'block_density_after'): (0.13, 0.2216),
    ('placement', 'bsr_locality_4096', 'blocks_after'): (1935.0, 2189.0),
    ('placement', 'embedding_rows_4096', 'hot_device_ours'): (718.1415, 1296.1219),
    ('placement', 'embedding_rows_4096', 'hot_link_ours'): (5590.0, 6528.0),
    ('placement', 'hetero_experts_96', 'makespan_ours'): (3214.9274, 3476.4236),
    ('placement', 'moe_experts_160', 'bottleneck_ours'): (51243.7031, 51316.9063),
    ('placement', 'moe_experts_160', 'makespan_ours'): (51243.7031, 51316.9063),
})
CLAIMS_EXACT.update({
    ('placement', 'bsr_locality_4096', 'block_density_before'): 0.8896484375,
    ('placement', 'bsr_locality_4096', 'blocks_before'): 911,
    ('placement', 'embedding_rows_4096', 'hot_device_hash'): 708.646484375,
    ('placement', 'embedding_rows_4096', 'hot_link_hash'): 82120.0,
    ('placement', 'hetero_experts_96', 'fast_pod_flops'): 116.05223149720018,
    ('placement', 'hetero_experts_96', 'makespan_scatter'): 37114.109375,
    ('placement', 'hetero_experts_96', 'slow_pod_flops'): 0.0,
    ('placement', 'moe_experts_160', 'bottleneck_scatter'): 101352.5546875,
    ('placement', 'moe_experts_160', 'makespan_scatter'): 101352.5546875,
})
# (end of the generated placement entries)
# the scaling rows the smoke runs (the twin's full tier also runs
# size_400000 and vcycle_1000000, minutes of host work each)
CLAIMS_SCALING_ROWS = ("size_10000", "size_100000", "k_1x4x4", "k_1x16x16",
                       "k_2x16x16", "vcycle_10000", "vcycle_100000")

# name: (source, the TPU kernel it replaces, the driven paths that must
# launch it, the first being the one the kernels line reports; the
# device coarsening runs each matching round as match_round, so the
# map kernel match_keys, the reference ops.match_keys' twin, is on no path
# and is held to its plain version in the kernels phase only; likewise the
# device initial partition runs its whole split as prefix_split, and
# bucket_assign is on no path; the claims phase's scaling rows run the
# device V-cycle, so both fused kernels launch there; the small
# path's device V-cycle runs every partitioner kernel; partition_gain needs
# dense levels, n*k <= 200,000, which the full cell never reaches at k = 64;
# the recsys plan's host V-cycle scores through quotient_link_loads only;
# the mapping search re-scores through it; the C1 table scores every method
# through it and the total-cut baselines take their connectivity rows from
# partition_gain; the placement bench's host V-cycles score through
# quotient_link_loads and refine their dense levels through
# partition_gain, and the serving bench's map_pages runs both; training
# launches flash_attention forward and in the remat recompute, the 100M-LM
# example once a layer a step)
KERNEL_INFO = {
    "match_keys": ("src/repro_torch/csrc/match_keys.cu",
                   "src/repro/kernels/match_keys.py:60", ()),
    "match_round": ("src/repro_torch/csrc/match_keys.cu",
                    "src/repro/kernels/match_keys.py:60",
                    ("full", "small", "c1", "claims")),
    "bucket_assign": ("src/repro_torch/csrc/bucket_assign.cu",
                      "src/repro/kernels/bucket_assign.py:69", ()),
    "prefix_split": ("src/repro_torch/csrc/bucket_assign.cu",
                     "src/repro/kernels/bucket_assign.py:69",
                     ("full", "small", "claims")),
    "quotient_link_loads": ("src/repro_torch/csrc/quotient_link_loads.cu",
                            "src/repro/kernels/quotient_link_loads.py:99",
                            ("full", "small", "recsys", "mapping", "c1",
                             "claims", "serve_chaos", "placement",
                             "place", "dryrun", "serving_bench")),
    "partition_gain": ("src/repro_torch/csrc/partition_gain.cu",
                       "src/repro/kernels/partition_gain.py:67",
                       ("small", "c1", "claims", "serve_chaos",
                        "placement", "serving_bench")),
    "bag_combine": ("src/repro_torch/csrc/bag_combine.cu",
                    "src/repro/kernels/bag_combine.py:59",
                    ("recsys", "train_recsys")),
    "gather_combine": ("src/repro_torch/csrc/gather_combine.cu",
                       "src/repro/kernels/gather_combine.py:85",
                       ("recsys",)),
    "bsr_spmm": ("src/repro_torch/csrc/bsr_spmm.cu",
                 "src/repro/kernels/bsr_spmm.py:94", ("gnn", "gnn_train")),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:115",
                        ("lm", "train", "lm_mla", "train_mla",
                         "lm100m", "dryrun")),
}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean milliseconds per call of ``fn`` on the card (CUDA events over
    ``iters`` calls after ``warmup`` calls)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int, flush=None, warmup: int = 3) -> float:
    """Mean device milliseconds per call of ``fn``, host launch cost left
    out: before each call the stream is stalled (``torch.cuda._sleep``)
    while the host queues the call, so the two events around it time only
    the device's work. ``flush`` (a large buffer) is read before each call
    to evict the 50 MB L2 (read, not written, so no dirty lines are left to
    write back during the call), so inputs come from device memory as the
    bound assumes; without it the inputs stay in L2 between calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        torch.cuda._sleep(2_000_000)
        if flush is not None:
            flush.sum()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


def alternating_device_ms(fns, rounds: int, flush=None, warmup: int = 3):
    """Device milliseconds of each of ``fns``, timed in alternation: every
    round times one call of each, in order, as ``device_ms`` times one
    call (stream stalled while the host queues it, ``flush`` read first).
    Returns, per function, the median and the quartiles over the rounds,
    so that two close times are compared with their spread."""
    import numpy as np
    import torch
    for fn in fns:
        for _ in range(warmup):
            fn()
    torch.cuda.synchronize()
    pairs = [[] for _ in fns]
    for _ in range(rounds):
        for fn, out in zip(fns, pairs):
            torch.cuda._sleep(2_000_000)
            if flush is not None:
                flush.sum()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            out.append((start, end))
    torch.cuda.synchronize()
    stats = []
    for out in pairs:
        ms = np.array([a.elapsed_time(b) for a, b in out])
        q25, q50, q75 = np.percentile(ms, [25, 50, 75])
        stats.append(dict(median_ms=float(q50), q25_ms=float(q25),
                          q75_ms=float(q75), rounds=rounds))
    return stats


def _device_work(e) -> bool:
    """A profiler event of work on the card (a kernel, copy or memset),
    not a user annotation's range such as a schedule's ProfilerStep."""
    import torch
    name = getattr(e, "name", None) or e.key    # an event or an average
    return (e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not name.startswith("ProfilerStep"))


def device_busy_and_span(prof):
    """(busy, span) seconds of the device events (kernels, copies,
    memsets) of one torch.profiler run: the union of their intervals, and
    the time from the first one's start to the last one's end."""
    iv = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                if _device_work(e))
    busy, end = 0.0, float("-inf")
    for a, b in iv:
        if b > end:
            busy += b - max(a, end)
            end = b
    span = (end - iv[0][0]) if iv else 0.0
    return busy / 1e6, span / 1e6


def bound(bytes_moved: float, flops: float, peak: float = H100_F32_PER_S):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate of their type (float32 by default)."""
    t_bytes = bytes_moved / H100_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rmat_graph(n, m, seed=0):
    """The reference tests' random multigraph (tests/test_device_vcycle.py)."""
    import numpy as np

    from repro_torch.graph.graph import from_edges
    rng = np.random.default_rng(seed)
    u = rng.integers(0, n, m)
    v = rng.integers(0, n, m)
    w = rng.random(m).astype(np.float32) + 0.1
    nw = rng.random(n).astype(np.float32) + 0.5
    return from_edges(n, u, v, w, nw)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_env(state):
    import torch
    smi = nvidia_smi_line()
    print(smi, flush=True)
    state["smi"] = smi
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi)


def phase_build(state):
    """Build the kernel library; fails if ptxas spilled any kernel's
    registers."""
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    rep = build.build_all()
    spilled = build.spilled(rep["ptxas"])
    emit("build", seconds=time.perf_counter() - t0, built=rep["built"],
         spilled=spilled, notes=rep["notes"], ptxas=rep["ptxas"])
    if spilled:
        raise AssertionError(f"ptxas spilled registers in {spilled}")


def _flush_buffer(state):
    """256 MB, read before each timed call to evict the 50 MB L2."""
    import torch
    if "flush" not in state:
        state["flush"] = torch.ones(64 << 20, dtype=torch.int32,
                                    device="cuda")
    return state["flush"]


def _check_kernel(state, name, shape, kern, plain, exact, rtol=0.0, atol=0.0,
                  tolerance=None, iters=30, library=None, bytes_moved=0.0,
                  flops=0.0, extra=None, warmup=3, peak=H100_F32_PER_S,
                  plain_warmup=None, judge=None):
    """Hold ``kern()`` against ``plain()``: equal where ``exact``, by
    ``judge(got, want) -> (ok, tolerance, readings)`` where given, else
    ``|got - want| <= atol + rtol * |want|`` elementwise (``atol`` a number
    or a tensor, ``tolerance`` its description), then time both (each
    timing after ``warmup`` calls, the plain version's after
    ``plain_warmup`` if given); the bound takes operations at ``peak``."""
    import torch
    got = kern()
    want = plain()
    torch.cuda.synchronize()
    err_t = (got.double() - want.double()).abs()
    if exact:
        ok, tolerance = torch.equal(got, want), "exact"
    elif judge is not None:
        ok, tolerance, readings = judge(got, want)
        extra = dict(extra or {}, readings=readings)
    else:
        ok = bool((err_t <= atol + rtol * want.double().abs()).all())
        tolerance = tolerance or f"rtol {rtol}, atol {atol}"
    err = float(err_t.max()) if got.numel() else 0.0
    flush = _flush_buffer(state)
    pw = warmup if plain_warmup is None else plain_warmup
    row = dict(kernel=name, shape=shape, max_abs_err=err, tolerance=tolerance,
               **(extra or {}),
               ms=device_ms(kern, iters, flush=flush, warmup=warmup),
               plain_ms=device_ms(plain, iters, flush=flush, warmup=pw),
               library_ms=(None if library is None
                           else device_ms(library, iters, flush=flush,
                                          warmup=warmup)),
               warm_ms=device_ms(kern, iters, warmup=warmup),
               plain_warm_ms=device_ms(plain, iters, warmup=pw),
               call_ms=cuda_ms(kern, iters, warmup=warmup),
               plain_call_ms=cuda_ms(plain, iters, warmup=pw))
    row["bound_ms"], row["bound_by"] = bound(bytes_moved, flops, peak)
    emit("kernels", **row)
    if not ok:
        raise AssertionError(f"{name} {shape}: kernel disagrees with its "
                             f"plain version (max abs err {err})")
    rows = state.setdefault("kernel_rows", {}).setdefault(name, [])
    rows.append(row)


def phase_kernels(state):
    import torch

    from repro_torch.core.machine import MachineSpec
    from repro_torch.core.topology import guess_tree, production_tree
    from repro_torch.graph.generators import grid3d
    from repro_torch.kernels import (bucket_assign, match_keys, ops,
                                     partition_gain)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    # match_keys: level 0 of the full phase (1,548,288 arcs), and ragged
    for m in (1_548_288, 10_001):
        w = torch.rand(m, generator=gen, device=dev) + 0.5
        u = torch.rand(m, generator=gen, device=dev)
        mask = (torch.rand(m, generator=gen, device=dev) > 0.4).float()
        _check_kernel(state, "match_keys", [m],
                      lambda: match_keys.match_keys(w, u, mask),
                      lambda: match_keys.plain(w, u, mask), exact=True,
                      bytes_moved=16.0 * m, flops=3.0 * m)

    # match_round: the whole matching round, bitwise its plain version
    for label, g, after_round in match_round_cases():
        _check_match_round(state, label, g, after_round, gen)

    # bucket_assign: the coarsest level of the full phase (~12.4k vertices,
    # k = 64), and k = 257
    for n, k in ((12_400, 64), (12_401, 257)):
        nw = torch.rand(n, generator=gen, device=dev) + 0.1
        cum = torch.cumsum(nw, 0) - 0.5 * nw
        bounds = (torch.arange(1, k, device=dev, dtype=torch.float64) / k
                  * float(nw.sum())).float()
        _check_kernel(state, "bucket_assign", [n, k],
                      lambda: bucket_assign.bucket_assign(cum, bounds, k),
                      lambda: bucket_assign.plain(cum, bounds, k), exact=True,
                      library=lambda: torch.searchsorted(bounds, cum,
                                                         right=True),
                      bytes_moved=8.0 * n + 4.0 * (k - 1),
                      flops=float(n) * (k - 1))

    # bucket_assign against torch.searchsorted(right=True) at the main
    # shape, one call of each per round: the two are within a few percent,
    # so each gets a median and quartiles, and the verdict is "slower" or
    # "faster" only where the two interquartile ranges do not overlap
    n, k = 12_400, 64
    nw = torch.rand(n, generator=gen, device=dev) + 0.1
    cum = torch.cumsum(nw, 0) - 0.5 * nw
    bounds = (torch.arange(1, k, device=dev, dtype=torch.float64) / k
              * float(nw.sum())).float()
    kern, lib = alternating_device_ms(
        [lambda: bucket_assign.bucket_assign(cum, bounds, k),
         lambda: torch.searchsorted(bounds, cum, right=True)],
        rounds=BUCKET_RANKING_ROUNDS, flush=_flush_buffer(state))
    slower = kern["q25_ms"] > lib["q75_ms"]
    faster = kern["q75_ms"] < lib["q25_ms"]
    state["bucket_ranking"] = dict(
        shape=[n, k], bucket_assign=kern, searchsorted=lib,
        verdict="slower" if slower else "faster" if faster else "tied")
    emit("kernels", kernel="bucket_assign", step="ranking",
         **state["bucket_ranking"])

    phase_kernels_split(state)

    # quotient_link_loads: the full phase's level-0 arcs on gpu-superpod
    # (k = 64, L = 72) and on production_tree(2, 16, 16) (k = 512) under a
    # random partition (no two neighbouring arcs share their bin pair), on
    # gpu-superpod under a CSR-local one (arange(n) * k // n: neighbouring
    # vertices share a bin, as the path's partitions place them), and at
    # the serve pools' k = 4 (guess_tree(4)) on 1,280 and 48 pages, both
    # partitions, and the serve pool after one death (serve_chaos's forced
    # re-placement over 3 survivors: guess_tree(3), the flat star)
    g = grid3d(64, 64, 64)
    superpod = MachineSpec.preset("gpu-superpod").tree()
    pool, pool_small = rmat_graph(1280, 2135, seed=0), rmat_graph(48, 300,
                                                                  seed=0)
    for label, gq, topo, kind in (
            ("gpu-superpod", g, superpod, "random"),
            ("production_tree(2,16,16)", g, production_tree(2, 16, 16),
             "random"),
            ("gpu-superpod", g, superpod, "csr_local"),
            ("serve_wide pool", pool, guess_tree(4), "random"),
            ("serve_wide pool", pool, guess_tree(4), "csr_local"),
            ("serve pool", pool_small, guess_tree(4), "random"),
            ("serve pool", pool_small, guess_tree(4), "csr_local"),
            ("serve pool after a death", pool_small, guess_tree(3),
             "random"),
            ("serve pool after a death", pool_small, guess_tree(3),
             "csr_local")):
        _check_qll(state, gq, topo, kind, label, gen)

    # partition_gain: the small phase's level 0 (every level is dense at
    # k = 8), a ragged row count, and the serve pools' level 0 at k = 4
    # and, after one death, at k = 3;
    # library_ms: scatter_add_ on bins gathered beforehand,
    # library_sequence_ms: the gather and the scatter_add_ in one sequence
    for n, m, k in ((2000, 8000, 8), (1001, 5003, 8), (1280, 2135, 4),
                    (48, 300, 4), (48, 300, 3)):
        gs = rmat_graph(n, m, seed=0)
        idx, ew = ops.to_ell(gs.n_nodes, gs.senders, gs.receivers,
                             gs.edge_weight)
        nbr_idx = torch.as_tensor(idx, device=dev)
        nbr_w = torch.as_tensor(ew, device=dev)
        part = torch.randint(0, k, (gs.n_nodes,), generator=gen, device=dev,
                             dtype=torch.int32)
        d = idx.shape[1]
        idx64 = nbr_idx.long()
        part_pad = torch.cat([part.long(), torch.full((1,), k, device=dev)])
        bins = part_pad[idx64]

        def scatter(b=bins, n=gs.n_nodes, k=k, w=nbr_w):
            return torch.zeros(n, k + 1, device=dev).scatter_add_(1, b, w)

        seq_ms = device_ms(lambda: scatter(part_pad[idx64]), 30,
                           flush=_flush_buffer(state))
        _check_kernel(
            state, "partition_gain", [gs.n_nodes, d, k],
            lambda: partition_gain.partition_gain(part, nbr_idx, nbr_w, k),
            lambda: partition_gain.plain(part, nbr_idx, nbr_w, k),
            exact=False, rtol=1e-5, atol=1e-5, library=scatter,
            extra=dict(library_sequence_ms=seq_ms),
            bytes_moved=8.0 * gs.n_nodes * d + 4.0 * gs.n_nodes
            + 4.0 * gs.n_nodes * k,
            flops=float(gs.n_arcs))


def split_inputs(n, k, gen, integer=True):
    """Node weights ``[n]`` on the card (integers 1-4, or floats in [0.1,
    1.1)) and the k-1 boundaries of k equal capacities, computed on the
    host in float64 and cast as ``initial_partition_device`` does."""
    import numpy as np
    import torch
    dev = torch.device("cuda")
    nw = (torch.randint(1, 5, (n,), generator=gen, device=dev).float()
          if integer else torch.rand(n, generator=gen, device=dev) + 0.1)
    total = float(nw.double().sum())
    b = (np.cumsum(np.ones(k))[:-1] / k * total).astype(np.float32)
    return nw, torch.as_tensor(b, device=dev)


def aten_split(nw, bounds, k):
    """The ATen sequence ``prefix_split`` replaces: cumsum, product,
    subtraction, ``searchsorted(right=True)`` and the clip (5 launches)."""
    import torch
    cum = torch.cumsum(nw, 0) - 0.5 * nw
    return torch.searchsorted(bounds, cum, right=True).clamp_(0, k - 1)


# prefix_split's shapes: the full cell's coarsest graph (12,400 vertices) at
# its k = 64 and at k = 512, one million vertices (the cooperative path) and
# a ragged n just past one tile
SPLIT_CASES = [(12_400, 64), (12_400, 512), (1_000_000, 64), (16_385, 7)]
SPLIT_RANKING_ROUNDS = 201


def _initial_before(g, topo, dev):
    """``initial_partition_device`` as it was before ``prefix_split``: the
    weights and boundaries copied apart, cumsum, product and subtraction,
    ``bucket_assign``, the bins back."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    k = topo.k
    caps = np.ones(k, dtype=np.float64)
    bounds = np.cumsum(caps)[:-1] / caps.sum() * float(g.node_weight.sum())
    nw = torch.as_tensor(g.node_weight, dtype=torch.float32, device=dev)
    cum = torch.cumsum(nw, dim=0) - 0.5 * nw
    part = ops.bucket_assign(
        cum, torch.as_tensor(bounds, dtype=torch.float32, device=dev), k)
    return part.cpu().numpy().astype(np.int32)


def phase_kernels_split(state):
    """``prefix_split`` at ``SPLIT_CASES``: integer weights bitwise against
    its plain version, two calls bitwise, float weights two calls bitwise
    and within the scan's rounding of the plain version (a bin may differ
    only where the plain midpoint lies within 2^-20 of the total of a
    boundary), the blocks each call takes; timed beside the ATen sequence
    it replaces and the old cumsum + ``bucket_assign`` pair, in
    alternation at the main shape; then ``initial_partition_device`` on
    the full cell's coarsest graph: one kernel between its two copies in a
    trace, and its wall time against the old sequence's, in alternation."""
    import numpy as np
    import torch

    from repro_torch.core.coarsen import coarsen_device
    from repro_torch.core.initial import initial_partition_device
    from repro_torch.core.machine import MachineSpec
    from repro_torch.graph.generators import grid3d
    from repro_torch.kernels import bucket_assign
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    for n, k in SPLIT_CASES:
        nw, bounds = split_inputs(n, k, gen)
        first = bucket_assign.split_kernel(nw, bounds, k)
        again = bucket_assign.split_kernel(nw, bounds, k)
        fw, fb = split_inputs(n, k, gen, integer=False)
        f1 = bucket_assign.split_kernel(fw, fb, k)
        f2 = bucket_assign.split_kernel(fw, fb, k)
        fp = bucket_assign.prefix_split_plain(fw, fb, k)
        cum = torch.cumsum(fw.double(), 0) - 0.5 * fw.double()
        near = ((cum[:, None] - fb.double()[None, :]).abs()
                <= 2.0 ** -20 * float(cum[-1])).any(1) if k > 1 else \
            torch.zeros(n, dtype=torch.bool, device=dev)
        float_ok = bool(((f1 == fp) | near).all())
        readings = dict(
            deterministic_integer=bool(torch.equal(first, again)),
            deterministic_float=bool(torch.equal(f1, f2)),
            float_bins_differing=int((f1 != fp).sum()),
            float_bins_near_a_boundary=int(near.sum()),
            float_within_rounding=float_ok,
            non_decreasing=bool((first[1:] >= first[:-1]).all()))
        seq_ms = device_ms(lambda: aten_split(nw, bounds, k), 30,
                           flush=_flush_buffer(state))
        pair_ms = device_ms(lambda: bucket_assign.bucket_assign(
            torch.cumsum(nw, 0) - 0.5 * nw, bounds, k), 30,
            flush=_flush_buffer(state))
        _check_kernel(
            state, "prefix_split", [n, k],
            lambda: bucket_assign.split_kernel(nw, bounds, k),
            lambda: bucket_assign.prefix_split_plain(nw, bounds, k),
            exact=True, bytes_moved=8.0 * n + 4.0 * (k - 1),
            flops=float(n) * (3 + max(k - 1, 1).bit_length()),
            extra=dict(blocks=bucket_assign.split_blocks(n, k - 1, dev),
                       aten_sequence_ms=seq_ms, aten_sequence_launches=5,
                       cumsum_bucket_assign_ms=pair_ms, **readings))
        bad = [key for key in ("deterministic_integer", "deterministic_float",
                               "float_within_rounding", "non_decreasing")
               if not readings[key]]
        if bad:
            raise AssertionError(f"prefix_split {n, k}: {bad} {readings}")
    try:
        bucket_assign.prefix_split(nw, bounds.flip(0), k)
    except ValueError:
        pass
    else:
        raise AssertionError("prefix_split took unsorted boundaries")

    n, k = SPLIT_CASES[0]
    nw, bounds = split_inputs(n, k, gen)
    kern, seq, pair = alternating_device_ms(
        [lambda: bucket_assign.split_kernel(nw, bounds, k),
         lambda: aten_split(nw, bounds, k),
         lambda: bucket_assign.bucket_assign(
             torch.cumsum(nw, 0) - 0.5 * nw, bounds, k)],
        rounds=SPLIT_RANKING_ROUNDS, flush=_flush_buffer(state))
    state["split_ranking"] = dict(shape=[n, k], prefix_split=kern,
                                  aten_sequence=seq,
                                  cumsum_bucket_assign=pair)
    emit("kernels", kernel="prefix_split", step="ranking",
         **state["split_ranking"])

    # initial_partition_device on the full cell's coarsest graph
    topo = MachineSpec.preset("gpu-superpod").tree()
    coarsest = coarsen_device(grid3d(64, 64, 64), topo.k, seed=0,
                              device=dev)[-1].graph
    after = initial_partition_device(coarsest, topo, device=dev)
    before = _initial_before(coarsest, topo, dev)
    walls = {"prefix_split": [], "before": []}
    for _ in range(SPLIT_RANKING_ROUNDS):
        for name, fn in (("prefix_split", lambda: initial_partition_device(
                coarsest, topo, device=dev)),
                ("before", lambda: _initial_before(coarsest, topo, dev))):
            t0 = time.perf_counter()
            fn()
            walls[name].append((time.perf_counter() - t0) * 1e6)
    # one call traced after an untraced one, its device events in order
    trace = _traced(lambda: initial_partition_device(coarsest, topo,
                                                     device=dev),
                    {"prefix_split": ("prefix_split",)}, events=True)
    events, event_us = trace["device_events"], trace["device_event_us"]
    kernels = [e for e in events if "emcpy" not in e and "emset" not in e]
    stats = {name: dict(zip(("q25_us", "median_us", "q75_us"),
                            map(float, np.percentile(v, [25, 50, 75]))))
             for name, v in walls.items()}
    emit("kernels", kernel="prefix_split", step="initial_partition_device",
         n=coarsest.n_nodes, k=topo.k, equal_to_before=bool(
             np.array_equal(after, before)), wall=stats,
         rounds=SPLIT_RANKING_ROUNDS, device_events=events,
         device_event_us=event_us, trace_attempts=trace["attempts"])
    state["split_initial"] = dict(n=coarsest.n_nodes, wall=stats,
                                  device_events=events,
                                  device_event_us=event_us)
    if len(kernels) != 1 or "prefix_split" not in kernels[0]:
        raise AssertionError(f"initial_partition_device ran {events}, not "
                             f"one prefix_split between two copies")
    if not np.array_equal(after, before):
        raise AssertionError("initial_partition_device's bins differ from "
                             "the old sequence's")


def match_round_cases():
    """(label, graph, after one round) of the kernels phase's
    ``match_round`` checks: level 0 of the full phase's grid3d(64, 64, 64)
    with the eligibility one real round leaves; the C1 table's
    rmat(20000, 120000, 1), whose hub rows hold thousands of arcs; and a
    ragged size."""
    from repro_torch.graph.generators import grid3d, rmat
    return [("full level 0, round 2", grid3d(64, 64, 64), True),
            ("rmat(20000,120000,1)", rmat(20000, 120000, seed=1), False),
            ("ragged", rmat_graph(1001, 5003, seed=0), True)]


def round_inputs(g, after_round, gen):
    """The arc list of ``g`` on the card, a jitter draw, and the matched
    flags: none, or those one round with another draw leaves (mutual
    proposals, as ``core.coarsen.coarsen_step`` takes them)."""
    import torch

    from repro_torch.kernels import match_keys
    dev = torch.device("cuda")
    s = torch.as_tensor(g.senders, device=dev)
    r = torch.as_tensor(g.receivers, device=dev)
    w = torch.as_tensor(g.edge_weight, device=dev)
    n, m = g.n_nodes, g.n_arcs
    matched = torch.zeros(n, dtype=torch.bool, device=dev)
    if after_round:
        u0 = torch.rand(m, generator=gen, device=dev)
        best = match_keys.match_round_plain(s, r, w, u0, matched)
        iota = torch.arange(n, dtype=torch.int32, device=dev)
        prop = torch.where(best >= 0, r[best.clamp_min(0).long()], iota)
        matched = (prop[prop.long()] == iota) & (prop != iota)
    u = torch.rand(m, generator=gen, device=dev)
    return s, r, w, u, matched


def _check_match_round(state, label, g, after_round, gen):
    """``match_round`` bitwise against ``match_round_plain`` (the ATen
    round it replaces: mask, keys, two segment maxima), timed beside it."""
    import numpy as np

    from repro_torch.kernels import match_keys
    s, r, w, u, matched = round_inputs(g, after_round, gen)
    n, m = g.n_nodes, g.n_arcs
    plain = match_keys.match_round_plain(s, r, w, u, matched)
    _check_kernel(
        state, "match_round", [m, n, label],
        lambda: match_keys.match_round(s, r, w, u, matched),
        lambda: match_keys.match_round_plain(s, r, w, u, matched),
        exact=True,
        # the arcs' s, r, w, u once, the flags once per vertex, the word
        # buffer (8 B) and best_arc (4 B) per vertex
        bytes_moved=16.0 * m + 13.0 * n, flops=5.0 * m,
        extra=dict(
            max_degree=int(np.diff(g.offsets).max()),
            matched=int(matched.sum()),
            live_senders=int((plain >= 0).sum())))


def _check_qll(state, g, topo, kind, label, gen):
    """``quotient_link_loads`` on graph ``g``'s arcs over ``topo``, the
    partition random (``kind`` "random") or ``arange(n) * k // n``
    ("csr_local"), against its plain version."""
    import numpy as np
    import torch

    from repro_torch.kernels import quotient_link_loads
    dev = torch.device("cuda")
    k, n, m = topo.k, g.n_nodes, g.n_arcs
    s = torch.as_tensor(g.senders, device=dev)
    r = torch.as_tensor(g.receivers, device=dev)
    w = torch.as_tensor(g.edge_weight, device=dev)
    if kind == "random":
        part = torch.randint(0, k, (n,), generator=gen, device=dev,
                             dtype=torch.int32)
    else:
        part = (torch.arange(n, device=dev) * k // n).to(torch.int32)
    S = torch.as_tensor(topo.subtree, device=dev)
    F = torch.as_tensor(topo.F_l, device=dev)
    nnz_rows = float(np.count_nonzero(topo.subtree))
    _check_kernel(
        state, "quotient_link_loads", [m, k, topo.n_links, label, kind],
        lambda: quotient_link_loads.quotient_link_loads(part, s, r, w, S, F,
                                                        k),
        lambda: quotient_link_loads.plain(part, s, r, w, S, F, k),
        exact=False, rtol=1e-4, atol=1e-3,
        bytes_moved=12.0 * m + 4.0 * n + 4.0 * S.numel()
        + 8.0 * topo.n_links,
        flops=float(m) + 4.0 * k * nnz_rows + 2.0 * topo.n_links)


@functools.lru_cache(maxsize=None)
def recsys_request(n_items, n_cats, batch, seed=1):
    """One batch of the recsys stream (``repro_torch.data.pipeline``) on
    the card, with the mean-combine weights of its histories (made once per
    argument tuple; nothing writes to it)."""
    import torch

    from repro_torch.data.pipeline import recsys_batches
    b = next(recsys_batches(n_items, n_cats, batch, 50, 16, seed=seed))
    out = {k: torch.as_tensor(v, device="cuda") for k, v in b.items()}
    valid = (out["user_hist"] >= 0).float()
    out["w"] = valid / valid.sum(-1, keepdim=True).clamp_min(1)
    return out


def bag_plain(rows_of, w, chunk=1 << 14):
    """(plain bag sums, order tolerance), both ``[B, F]``, of the gathered
    rows ``rows_of(i, j)`` (``[j - i, D, F]``, bags i..j-1) and weights
    ``w [B, D]``, chunk by chunk of bags so that no temporary outgrows one
    chunk's. The tolerance bounds two float32 sums of the same D products
    taken in different orders (``bag_combine.order_tolerance``)."""
    import torch

    from repro_torch.kernels import bag_combine
    want, tol = [], []
    for i in range(0, w.shape[0], chunk):
        rows, wc = rows_of(i, i + chunk), w[i:i + chunk]
        want.append(bag_combine.plain(rows, wc))
        tol.append(bag_combine.order_tolerance(rows, wc))
    return torch.cat(want), torch.cat(tol)


BAG_TOLERANCE = ("rtol 1e-6 + 2*D*2^-24*sum_d|w*row| (two float32 sums in "
                 "different orders)")
BF16_BAG_TOLERANCE = ("1 bf16 ulp of |out| + rtol 1e-6 + "
                      "2*D*2^-24*sum_d|w*row| against the float32 plain sum "
                      "of the bf16 rows rounded once to bf16")
# the L2 probe: a buffer that fits the 50 MB L2, read this many times
L2_PROBE_BYTES = 40 << 20
L2_PROBE_REPS = 20


def bag_bytes(b, d, f, unique, elem):
    """The bound's bytes of a gather_combine call: each distinct row the
    bags name once, the ids and weights (8 B a slot), the output."""
    return elem * unique * f + 8.0 * b * d + elem * b * f


def l2_read_rate(state):
    """Bytes per second the card reads from L2 (``csrc/l2_read.cu``): a
    40 MB buffer read ``L2_PROBE_REPS`` times against once, the difference
    of the two device times over the difference of the bytes."""
    import ctypes

    import torch

    from repro_torch.kernels import build
    if "l2_rate" not in state:
        dev = torch.device("cuda")
        buf = torch.zeros(L2_PROBE_BYTES // 4, device=dev)
        sink = torch.zeros(1, device=dev)
        fn = build.entry("l2_read", [ctypes.c_void_p, ctypes.c_longlong,
                                     ctypes.c_int, ctypes.c_void_p,
                                     ctypes.c_int, ctypes.c_void_p])

        def run(reps):
            build.check("l2_read", fn(build.ptr(buf), L2_PROBE_BYTES, reps,
                                      build.ptr(sink), build.sm_count(dev),
                                      build.stream_of(dev)))
        many = device_ms(lambda: run(L2_PROBE_REPS), 10)
        once = device_ms(lambda: run(1), 10)
        state["l2_rate"] = dict(
            bytes=L2_PROBE_BYTES, reps=L2_PROBE_REPS, ms=many, ms_once=once,
            bytes_per_s=(L2_PROBE_REPS - 1) * L2_PROBE_BYTES
            / ((many - once) * 1e-3))
    return state["l2_rate"]


def tile_dedup(ids, tiles):
    """Distinct rows per tile of T consecutive bags of ``ids`` [B, D], for
    each T of ``tiles``: mean and most over the tiles, and the share of row
    reads that reading each distinct row once per tile saves."""
    import numpy as np
    a = ids.cpu().numpy()
    b, d = a.shape
    out = {}
    for t in tiles:
        k = b // t
        srt = np.sort(a[:k * t].reshape(k, t * d), axis=1)
        distinct = 1 + (np.diff(srt, axis=1) != 0).sum(1)
        out[str(t)] = dict(mean=float(distinct.mean()),
                           max=int(distinct.max()),
                           reads_saved=float(1 - distinct.sum() / (k * t * d)))
    return out


def gather_extra(tbl, idx, unique, l2_rate, sms):
    """A gather_combine row's extra readings: its path, the distinct rows,
    and the every-slot bounds (each slot's row read from device memory, and
    from L2 at the measured rate)."""
    from repro_torch.kernels import gather_combine
    (b, d), f, elem = idx.shape, tbl.shape[1], tbl.element_size()
    per_slot = elem * b * d * f + 8.0 * b * d + elem * b * f
    return dict(
        dtype=str(tbl.dtype).replace("torch.", ""), unique_rows=unique,
        path=gather_combine.path(b, f, tbl.dtype, tbl.data_ptr() % 16 == 0,
                                 sms),
        bound_ms_every_slot=bound(per_slot, 2.0 * b * d * f)[0],
        bound_ms_every_slot_l2=per_slot / l2_rate["bytes_per_s"] * 1e3)


def bf16_ulp(x):
    """One bf16 ulp of |x| (8 significant bits), 0 where x is 0."""
    import torch
    _, e = torch.frexp(x.double())
    ulp = torch.ldexp(torch.ones_like(x, dtype=torch.float64), e - 8)
    return torch.where(x == 0, torch.zeros_like(ulp), ulp)


def bf16_bag_judge(table16, idx, w, got, want):
    """``gather_combine`` on a bf16 table against ``want``, the float32
    plain sum of the bf16 rows rounded once to bf16: every element within 1
    bf16 ulp of |want| plus the float32 band. Two planted faults must fail
    it: the output x (1 + 2^-7), and the first live slot of bag 0 dropped
    (its weight zeroed in a second kernel call)."""
    from repro_torch.kernels import gather_combine
    tol = bag_plain(lambda i, j: table16[idx[i:j]].float(), w)[1]
    band = bf16_ulp(want) + 1e-6 * want.double().abs() + tol

    def share(x):
        return float(((x.double() - want.double()).abs() / band).max())
    w2 = w.clone()
    j = int((w2[0] > 0).nonzero()[0])
    w2[0, j] = 0.0
    read = dict(worst_share=share(got),
                scaled_fault_share=share(got.double() * (1 + 2 ** -7)),
                dropped_fault_share=share(
                    gather_combine.gather_combine(table16, idx, w2)))
    ok = (read["worst_share"] <= 1.0 and read["scaled_fault_share"] > 1.0
          and read["dropped_fault_share"] > 1.0)
    return ok, BF16_BAG_TOLERANCE, read


def bf16_combine_judge(rows16, w16, got, want):
    """``bag_combine`` on bf16 rows and weights against ``want``, the
    float32 plain sum of the same bf16 values rounded once to bf16:
    ``bf16_bag_judge``'s band (1 bf16 ulp of |want| plus the float32 band)
    and the reference's ``rtol = atol = 5e-2``. Two planted faults must
    fail the band: the output x (1 + 2^-7), and the first live slot of bag
    0 dropped (its weight zeroed in a second kernel call)."""
    from repro_torch.kernels import bag_combine
    tol = bag_plain(lambda i, j: rows16[i:j].float(), w16.float())[1]
    band = bf16_ulp(want) + 1e-6 * want.double().abs() + tol
    diff = (got.double() - want.double()).abs()

    def share(x):
        return float(((x.double() - want.double()).abs() / band).max())
    w2 = w16.clone()
    j = int((w2[0] > 0).nonzero()[0])
    w2[0, j] = 0.0
    read = dict(worst_share=share(got),
                scaled_fault_share=share(got.double() * (1 + 2 ** -7)),
                dropped_fault_share=share(bag_combine.bag_combine(rows16,
                                                                  w2)),
                reference_5e_2=bool((diff <= 5e-2 * (
                    1.0 + want.double().abs())).all()))
    ok = (read["worst_share"] <= 1.0 and read["reference_5e_2"]
          and read["scaled_fault_share"] > 1.0
          and read["dropped_fault_share"] > 1.0)
    return ok, BF16_BAG_TOLERANCE + "; and rtol = atol = 5e-2", read


def phase_kernels_recsys(state):
    """bag_combine and gather_combine at the recsys path's shapes (its
    stream's histories on a 1M x 256 table): serve_p99 (512 bags, the main
    shape), serve_bulk (262,144 bags; bag_combine reads a 13.4 GB
    [262144, 50, 256] tensor) and one retrieve query (1 bag), and at a
    ragged shape; gather_combine also on a bf16 copy of the table at
    serve_p99 and serve_bulk. First the card's L2 read rate and the
    distinct rows per tile of consecutive bulk bags."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs.two_tower_retrieval import FULL, SHAPES
    from repro_torch.kernels import bag_combine, gather_combine
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    table = torch.randn(FULL.n_items, FULL.embed_dim, generator=gen,
                        device=dev) * 0.01
    table_r = torch.randn(5000, 96, generator=gen, device=dev)
    p99 = recsys_request(FULL.n_items, FULL.n_cats,
                         SHAPES["serve_p99"].meta["batch"])
    bulk = recsys_request(FULL.n_items, FULL.n_cats,
                          SHAPES["serve_bulk"].meta["batch"])
    cases = [
        ("serve_p99", table, p99["user_hist"].clamp_min(0), p99["w"]),
        ("ragged", table_r,
         torch.randint(0, 5000, (37, 7), generator=gen, device=dev,
                       dtype=torch.int32),
         torch.rand(37, 7, generator=gen, device=dev)),
        ("retrieve_query", table, p99["user_hist"][:1].clamp_min(0),
         p99["w"][:1]),
        ("serve_bulk", table, bulk["user_hist"].clamp_min(0), bulk["w"]),
    ]
    l2_rate = l2_read_rate(state)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    emit("kernels", kernel="gather_combine", step="tile_dedup",
         ids="serve_bulk", tiles=tile_dedup(bulk["user_hist"].clamp_min(0),
                                            (1, 2, 4, 8, 16)),
         l2_read=l2_rate)
    for label, tbl, idx, w in cases:
        (b, d), f = idx.shape, tbl.shape[1]
        rows = tbl[idx]
        unique = int(torch.unique(idx).numel())
        tol = bag_plain(lambda i, j, rows=rows: rows[i:j], w)[1]
        iters = 5 if label == "serve_bulk" else 30
        flops = 2.0 * b * d * f
        _check_kernel(
            state, "gather_combine", [b, d, f, tbl.shape[0], label],
            lambda: gather_combine.gather_combine(tbl, idx, w),
            lambda: gather_combine.plain(tbl, idx, w), exact=False,
            rtol=1e-6, atol=tol, tolerance=BAG_TOLERANCE, iters=iters,
            library=lambda: F.embedding_bag(idx, tbl, per_sample_weights=w,
                                            mode="sum"),
            bytes_moved=bag_bytes(b, d, f, unique, 4), flops=flops,
            extra=gather_extra(tbl, idx, unique, l2_rate, sms))
        _check_kernel(
            state, "bag_combine", [b, d, f, label],
            lambda: bag_combine.bag_combine(rows, w),
            lambda: bag_combine.plain(rows, w), exact=False, rtol=1e-6,
            atol=tol, tolerance=BAG_TOLERANCE, iters=iters,
            library=lambda: torch.bmm(w[:, None, :], rows),
            bytes_moved=4.0 * b * d * f + 4.0 * b * d + 4.0 * b * f,
            flops=flops)
        del rows, tol

    # gather_combine on a bf16 copy of the table: float32 sums rounded once
    # to bf16, held to the float32 plain sum of the bf16 values rounded
    # once, within 1 bf16 ulp plus the float32 band; two planted faults
    # must fail the band
    table16 = table.to(torch.bfloat16)
    for label, _, idx, w in (cases[0], cases[3]):
        (b, d), f = idx.shape, table16.shape[1]
        unique = int(torch.unique(idx).numel())
        iters = 5 if label == "serve_bulk" else 30
        _check_kernel(
            state, "gather_combine", [b, d, f, table16.shape[0], label,
                                      "bf16"],
            lambda: gather_combine.gather_combine(table16, idx, w),
            lambda: gather_combine.plain(table16, idx, w), exact=False,
            judge=functools.partial(bf16_bag_judge, table16, idx, w),
            iters=iters,
            library=lambda: F.embedding_bag(idx, table16,
                                            per_sample_weights=w.to(
                                                torch.bfloat16), mode="sum"),
            bytes_moved=bag_bytes(b, d, f, unique, 2), flops=2.0 * b * d * f,
            extra=gather_extra(table16, idx, unique, l2_rate, sms))

    # bag_combine on bf16 rows with bf16 weights (the reference takes the
    # input's dtype) at all three shapes: float32 sums rounded once, held
    # to the float32 plain sum of the bf16 values rounded once, within 1
    # bf16 ulp plus the float32 band and the reference's 5e-2; two planted
    # faults must fail the band
    for label, _, idx, w in (cases[0], cases[3], cases[2]):
        (b, d), f = idx.shape, table16.shape[1]
        rows16, w16 = table16[idx], w.to(torch.bfloat16)
        _check_kernel(
            state, "bag_combine", [b, d, f, label, "bf16"],
            lambda: bag_combine.bag_combine(rows16, w16),
            lambda: bag_combine.plain(rows16, w16), exact=False,
            judge=functools.partial(bf16_combine_judge, rows16, w16),
            iters=5 if label == "serve_bulk" else 30,
            library=lambda: torch.bmm(w16[:, None, :], rows16),
            bytes_moved=2.0 * b * d * f + 2.0 * b * d + 2.0 * b * f,
            flops=2.0 * b * d * f, extra=dict(dtype="bfloat16"))
        del rows16, w16
    del table16

    # one retrieve query (1 bag): the two kernels, their plain versions and
    # their library calls in alternation, one call each per round (L2
    # flushed first), a median and quartiles each; the times are within a
    # few microseconds of each other
    _, tbl, idx, w = cases[2]
    rows = tbl[idx]
    names = ("bag_combine", "bag_combine_plain", "torch.bmm",
             "gather_combine", "gather_combine_plain", "F.embedding_bag")
    stats = alternating_device_ms(
        [lambda: bag_combine.bag_combine(rows, w),
         lambda: bag_combine.plain(rows, w),
         lambda: torch.bmm(w[:, None, :], rows),
         lambda: gather_combine.gather_combine(tbl, idx, w),
         lambda: gather_combine.plain(tbl, idx, w),
         lambda: F.embedding_bag(idx, tbl, per_sample_weights=w,
                                 mode="sum")],
        rounds=BAG_RANKING_ROUNDS, flush=_flush_buffer(state))
    ranking = dict(zip(names, stats))
    med = {k: v["median_ms"] for k, v in ranking.items()}
    state["bag_ranking"] = dict(
        shape=list(rows.shape), **ranking,
        bag_combine_at_or_below_bmm_and_plain=bool(
            med["bag_combine"] <= min(med["torch.bmm"],
                                      med["bag_combine_plain"])),
        gather_combine_at_or_below_embedding_bag=bool(
            med["gather_combine"] <= med["F.embedding_bag"]))
    emit("kernels", kernel="bag_combine", step="retrieve_query_ranking",
         **state["bag_ranking"])
    del rows

    # bag_combine at train_recsys's forward: TRAIN_RECSYS_BATCH of the
    # stream's histories, float32 (1.68 GB of gathered rows), beside
    # torch.bmm; then the plain backward it runs under autograd, d gathered
    # = w[:, :, None] * g[:, None, :] (a [B, D, F] write), with its bound
    train = recsys_request(FULL.n_items, FULL.n_cats, TRAIN_RECSYS_BATCH)
    idx, w = train["user_hist"].clamp_min(0), train["w"]
    (b, d), f = idx.shape, table.shape[1]
    rows = table[idx]
    tol = bag_plain(lambda i, j: rows[i:j], w)[1]
    _check_kernel(
        state, "bag_combine", [b, d, f, "train"],
        lambda: bag_combine.bag_combine(rows, w),
        lambda: bag_combine.plain(rows, w), exact=False, rtol=1e-6,
        atol=tol, tolerance=BAG_TOLERANCE, iters=10,
        library=lambda: torch.bmm(w[:, None, :], rows),
        bytes_moved=4.0 * b * d * f + 4.0 * b * d + 4.0 * b * f,
        flops=2.0 * b * d * f)
    del tol
    g = torch.randn(b, f, generator=gen, device=dev)
    bwd_bytes = 4.0 * b * f + 4.0 * b * d + 4.0 * b * d * f
    state["bag_train"] = dict(
        shape=[b, d, f, "train"],
        plain_backward_ms=device_ms(lambda: w[:, :, None] * g[:, None, :],
                                    10, flush=_flush_buffer(state)),
        plain_backward_bound_ms=bound(bwd_bytes, float(b * d * f))[0])
    emit("kernels", kernel="bag_combine", step="train_backward",
         **state["bag_train"])
    del rows, g


def host_scorecard(g, topo, part):
    """Host numpy re-evaluation in float64: the quotient by ``bincount``
    and the S-XOR identity; makespan, comp_max, comm_max, total cut."""
    import numpy as np
    k = topo.k
    part = np.asarray(part).astype(np.int64)
    comp = np.bincount(part, weights=g.node_weight.astype(np.float64),
                       minlength=k)
    if topo.bin_speed is not None:
        comp = comp / topo.bin_speed
    W = np.bincount(part[g.senders] * k + part[g.receivers],
                    weights=g.edge_weight.astype(np.float64),
                    minlength=k * k).reshape(k, k)
    S = topo.subtree.astype(np.float64)
    cross = ((S @ W) * S).sum(1)
    comm = 0.5 * (S @ W.sum(1) + S @ W.sum(0) - 2.0 * cross)
    comm_max = float((topo.F_l * comm).max())
    return {"makespan": max(float(comp.max()), comm_max),
            "comp_max": float(comp.max()), "comm_max": comm_max,
            "total_cut": float(0.5 * (W.sum() - np.trace(W)))}


def host_makespan(g, topo, part):
    return host_scorecard(g, topo, part)["makespan"]


def qll_by_shape(state, shapes, path_inputs=None):
    """``quotient_link_loads``' launches of one run, ``shapes`` ``{(arcs m,
    vertices n, bins k, links L): launches}``, grouped by k and arc count
    (m in [2^(b-1), 2^b)), with the device time of one call at each
    group's largest shape (L2 flushed first) on two synthetic inputs of that
    shape, a random 0/1 subtree matrix each: ``ms_at_largest`` random (parts
    in [0, k), arcs between random vertices) and ``ms_at_largest_local``
    CSR-local (sorted senders, receivers within 8 ids of them, part =
    arange(n) * k // n); and, where ``path_inputs`` (of
    :func:`record_qll_inputs`) holds the group, ``ms_at_path`` on the
    inputs of the path's own call with the most arcs in the group."""
    import torch

    from repro_torch.kernels import quotient_link_loads
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    groups = {}
    for (m, n, k, links), c in shapes.items():
        g = groups.setdefault((k, m.bit_length()), dict(
            k=k, arcs_from=1 << max(m.bit_length() - 1, 0),
            arcs_below=1 << m.bit_length(), launches=0, largest=None))
        g["launches"] += c
        if g["largest"] is None or m > g["largest"][0]:
            g["largest"] = [m, n, k, links]

    def timed(*args):
        return device_ms(lambda: quotient_link_loads.quotient_link_loads(
            *args), 30, flush=_flush_buffer(state))
    out = []
    for key in sorted(groups):
        g = groups[key]
        m, n, k, links = g["largest"]
        part = torch.randint(0, k, (n,), generator=gen, device=dev,
                             dtype=torch.int32)
        s, r = (torch.randint(0, n, (m,), generator=gen, device=dev,
                              dtype=torch.int32) for _ in range(2))
        w = torch.rand(m, generator=gen, device=dev)
        sub = (torch.rand(links, k, generator=gen, device=dev) < 0.5).float()
        fl = torch.ones(links, device=dev)
        g["ms_at_largest"] = timed(part, s, r, w, sub, fl, k)
        s_local = s.sort().values
        r_local = (s_local + torch.randint(1, 9, (m,), generator=gen,
                                           device=dev, dtype=torch.int32)) % n
        part_local = (torch.arange(n, device=dev) * k // n).to(torch.int32)
        g["ms_at_largest_local"] = timed(part_local, s_local, r_local, w, sub,
                                         fl, k)
        g["device_ms_estimate"] = g["launches"] * g["ms_at_largest"]
        g["device_ms_estimate_local"] = (g["launches"]
                                         * g["ms_at_largest_local"])
        if path_inputs and key in path_inputs:
            args = path_inputs[key]
            g["path_shape"] = [args[1].shape[0], args[0].shape[0]]
            g["ms_at_path"] = timed(*args)
            g["device_ms_estimate_path"] = g["launches"] * g["ms_at_path"]
        out.append(g)
    return out


def record_qll_inputs(run):
    """Run ``run()`` with ``quotient_link_loads``' inputs recorded: for each
    (k, arc-count group) of :func:`qll_by_shape`, the arguments of its call
    with the most arcs. The wrapper is replaced for the run only."""
    from repro_torch.kernels import quotient_link_loads as qll
    orig = qll.loads_and_quotient
    seen = {}

    def recording(part, senders, receivers, weight, subtree, F_l, k):
        m = senders.shape[0]
        key = (k, m.bit_length())
        if key not in seen or m > seen[key][1].shape[0]:
            seen[key] = (part, senders, receivers, weight, subtree, F_l, k)
        return orig(part, senders, receivers, weight, subtree, F_l, k)
    qll.loads_and_quotient = recording
    try:
        run()
    finally:
        qll.loads_and_quotient = orig
    return seen


def phase_full(state):
    import torch

    from repro_torch.core.machine import MachineSpec
    from repro_torch.core.partitioner import PartitionConfig, partition
    from repro_torch.graph.generators import grid3d
    from repro_torch.kernels import ops, quotient_link_loads
    g = grid3d(64, 64, 64)
    topo = MachineSpec.preset("gpu-superpod").tree()
    cfg = PartitionConfig(seed=0, backend="device")

    t0 = time.perf_counter()
    partition(g, topo, cfg)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = partition(g, topo, cfg)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    counts = ops.launch_counts()
    qll_shapes = dict(quotient_link_loads.launch_shapes)
    state["launches"]["full"] = counts

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        partition(g, topo, cfg)
        torch.cuda.synchronize()
        profiled = time.perf_counter() - t0
    busy, span = device_busy_and_span(prof)
    dev_rows = [e for e in prof.key_averages() if _device_work(e)]
    top = sorted(dev_rows, key=lambda e: -e.self_device_time_total)[:8]
    # device seconds of the port's own kernels in the traced run
    own = {name: sum(e.self_device_time_total for e in dev_rows
                     if name in e.key or (name == "quotient_link_loads"
                                          and "qll_" in e.key)) / 1e6
           for name in KERNEL_INFO}

    # the path's own inputs for qll_by_shape, from one more run
    path_inputs = record_qll_inputs(lambda: partition(g, topo, cfg))

    host = host_makespan(g, topo, res.part)
    rel = abs(host - res.makespan) / host
    limit = QUALITY_BAND * REF_DEVICE_MAKESPAN_MAX
    emit("full", graph="grid3d(64,64,64)", n=g.n_nodes, arcs=g.n_arcs,
         machine="gpu-superpod", k=topo.k, links=topo.n_links,
         cold_s=cold, warm_s=warm, makespan=res.makespan,
         comp_max=res.comp_max, comm_max=res.comm_max,
         levels=len(res.level_makespans),
         # one traced run: its wall time (profiler overhead included, so
         # the idle share is an upper bound), the device's busy time and
         # the span from its first to its last device event
         profiled_s=profiled, device_busy_s=busy, device_span_s=span,
         device_idle_share=1.0 - busy / profiled,
         kernel_device_s=own,
         top_device=[[e.key, e.self_device_time_total / 1e6, e.count]
                     for e in top],
         host_makespan=host,
         host_rel_err=rel, limit=limit, launches=counts,
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         quotient_link_loads_by_shape=qll_by_shape(state, qll_shapes,
                                                   path_inputs))
    if rel > 1e-4:
        raise AssertionError(f"device makespan {res.makespan} != host "
                             f"re-evaluation {host}")
    if res.makespan > limit:
        raise AssertionError(f"makespan {res.makespan} above {limit}")
    _require_launched(counts, "full")


def _require_launched(counts, path):
    """Every kernel that lists ``path`` must have launched on it."""
    for name, (_, _, paths) in KERNEL_INFO.items():
        if path in paths and counts[name] <= 0:
            raise AssertionError(f"{name} never launched on the {path} path")


def phase_small(state):
    import torch

    from repro_torch.core.partitioner import PartitionConfig, partition, verify
    from repro_torch.core.topology import balanced_tree
    from repro_torch.kernels import ops
    g = rmat_graph(2000, 8000, seed=0)
    topo = balanced_tree((2, 4))
    t0 = time.perf_counter()
    host = partition(g, topo, PartitionConfig(seed=0))
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    dev = partition(g, topo, PartitionConfig(seed=0, backend="device"))
    torch.cuda.synchronize()
    device_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    state["launches"]["small"] = counts
    emit("small", graph="_rmat(2000,8000)", machine="balanced_tree((2,4))",
         host_makespan=host.makespan, device_makespan=dev.makespan,
         ratio=dev.makespan / host.makespan, host_s=host_s,
         device_s=device_s, launches=counts)
    verify(g, topo, host)
    verify(g, topo, dev)
    if dev.makespan > QUALITY_BAND * host.makespan:
        raise AssertionError(f"device {dev.makespan} above {QUALITY_BAND}x "
                             f"host {host.makespan}")
    _require_launched(counts, "small")


def _wall(fn, reps=1):
    """(result of the last call, mean wall ms per call), synchronised."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3 / reps


def _traced(fn, kernel_events, gap_s=TRACE_GAP_S, attempts=TRACE_ATTEMPTS,
            events=False):
    """One run of ``fn`` under torch.profiler, after one warm-up run under
    its schedule that is not recorded and ``gap_s`` idle seconds: wall s,
    device busy s and idle share (busy over that run's wall, profiler
    overhead included) and the top device operations. ``kernel_events``
    maps a substring of a port kernel's device-event name to the launch
    counters it stands for; the trace must hold as many such events as
    those counters counted in the recorded run, or its times miss work: a
    trace that lost events is taken again, up to ``attempts`` traces, and
    then this raises. ``runs`` says how many times ``fn`` ran (two a
    trace), for callers that count launches around it. With ``events``
    the readings also hold the recorded run's device events in time
    order, ``device_events`` (names) and ``device_event_us`` (each one's
    duration, µs)."""
    for attempt in range(1, attempts + 1):
        out, missing = _trace_once(fn, kernel_events, gap_s, events)
        out.update(attempts=attempt, runs=2 * attempt)
        if not missing:
            return out
    raise AssertionError(f"the trace misses port kernel launches "
                         f"{missing} in {attempts} traces: {out}")


def _trace_once(fn, kernel_events, gap_s, events=False):
    """One trace of ``_traced``: (its readings, the kernel events whose
    traced count differs from the launches counted)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    from repro_torch.kernels import ops
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        time.sleep(gap_s)
        c0 = ops.launch_counts()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counted = _since(c0)
    busy, _ = device_busy_and_span(prof)
    dev_events = [e for e in prof.events() if _device_work(e)]
    launches = {sub: dict(counted=sum(counted[k] for k in names),
                          traced=sum(sub in e.name for e in dev_events))
                for sub, names in kernel_events.items()}
    dev_rows = [e for e in prof.key_averages() if _device_work(e)]
    top = sorted(dev_rows, key=lambda e: -e.self_device_time_total)[:6]
    out = dict(wall_s=wall, device_busy_s=busy,
               device_idle_share=1.0 - busy / wall, port_launches=launches,
               top_device=[[e.key, e.self_device_time_total / 1e6, e.count]
                           for e in top])
    if events:
        ordered = sorted(dev_events, key=lambda e: e.time_range.start)
        out.update(device_events=[e.name for e in ordered],
                   device_event_us=[e.time_range.end - e.time_range.start
                                    for e in ordered])
    return out, {k: v for k, v in launches.items()
                 if v["counted"] != v["traced"]}


def _since(c0):
    """Launches per kernel since the counts ``c0`` were read."""
    from repro_torch.kernels import ops
    return {k: n - c0[k] for k, n in ops.launch_counts().items()}


def phase_recsys(state):
    import numpy as np
    import torch

    from repro_torch.configs.two_tower_retrieval import FULL, SHAPES
    from repro_torch.core import baselines
    from repro_torch.core.initial import random_partition
    from repro_torch.core.machine import MachineSpec
    from repro_torch.data.pipeline import item_categories, recsys_batches
    from repro_torch.embed import (RowAccessStats, ShardedEmbeddingTable,
                                   plan_shards)
    from repro_torch.graph.graph import from_edges
    from repro_torch.kernels import bag_combine, ops
    from repro_torch.models.recsys import TwoTower
    dev = torch.device("cuda")
    n_items, hist = FULL.n_items, FULL.hist_len
    ops.reset_launch_counts()

    # -- plan: co-access statistics of the stream -> partition() over k=64
    stream = recsys_batches(n_items, FULL.n_cats, 512, hist, FULL.d_dense,
                            seed=0)
    t0 = time.perf_counter()
    bags = [next(stream)["user_hist"] for _ in range(RECSYS_PLAN_BATCHES)]
    gen_s = time.perf_counter() - t0
    stats = RowAccessStats(n_items)
    t0 = time.perf_counter()
    for ids in bags:
        stats.record(ids)
    n_pairs = stats.n_pairs
    record_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plan = plan_shards(stats, machine="gpu-superpod")
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    plan_counts = ops.launch_counts()
    plan.check()
    topo = MachineSpec.preset("gpu-superpod").tree()
    nw = np.maximum(stats.counts, max(float(stats.counts.max()), 1.0) * 1e-3)
    u, v, w = stats.pair_arrays()
    g = from_edges(n_items, u, v, w.astype(np.float32), nw.astype(np.float32))
    rand = baselines.score_all(g, topo, random_partition(
        n_items, topo.k, g.node_weight, seed=0))
    ops.reset_launch_counts()     # the random baseline is not the path
    sizes = plan.shard_sizes
    emit("recsys", step="plan", batches=RECSYS_PLAN_BATCHES,
         bags=RECSYS_PLAN_BATCHES * 512, rows=n_items,
         rows_touched=int((stats.counts > 0).sum()), pairs=n_pairs,
         arcs=g.n_arcs, machine="gpu-superpod", k=topo.k,
         stream_gen_s=gen_s, record_s=record_s, plan_shards_s=plan_s,
         makespan=plan.makespan, random_makespan=rand["makespan"],
         rows_per_device=[int(sizes.min()), int(sizes.max())],
         launches=plan_counts)
    if not plan.makespan < rand["makespan"]:
        raise AssertionError(f"plan makespan {plan.makespan} not below a "
                             f"random assignment's {rand['makespan']}")
    if plan_counts["quotient_link_loads"] <= 0:
        raise AssertionError("quotient_link_loads never launched in the "
                             "plan step")

    # -- table: the full-width model from a seed, its item table permuted
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    model = TwoTower(FULL, generator=gen, device=dev)
    st = ShardedEmbeddingTable(model.item_table, plan)
    served = TwoTower(FULL, device="meta")
    served.load_state_dict({**model.state_dict(), "item_table": st.data},
                           assign=True)
    row_perm = torch.as_tensor(plan.perm, device=dev)

    # -- serve: one request is score() through the permuted table
    out, requests = {}, {}
    for shape, reps in (("serve_p99", 20), ("serve_bulk", 3)):
        b = SHAPES[shape].meta["batch"]
        req = recsys_request(n_items, FULL.n_cats, b)
        requests[shape] = req

        def serve(req=req):
            return served.score(req, row_perm=row_perm)
        torch.cuda.reset_peak_memory_stats()
        c0 = ops.launch_counts()
        _, cold = _wall(serve)
        out[shape], warm = _wall(serve, reps)
        trace = _traced(serve, {"bag_reduce": ("bag_combine",
                                               "gather_combine")})
        emit("recsys", step="serve", shape=shape, batch=b, cold_ms=cold,
             warm_ms=warm, warm_reps=reps,
             max_memory_allocated=torch.cuda.max_memory_allocated(),
             launches=_since(c0), traced=trace)

    # -- lookup: the sharded table's fused lookup of the same histories
    # (and of one retrieve query's), which score() does not call
    p99 = requests["serve_p99"]
    requests["retrieve_query"] = {"user_hist": p99["user_hist"][:1],
                                  "w": p99["w"][:1]}
    fused = {}
    for shape, reps in (("serve_p99", 20), ("serve_bulk", 3),
                        ("retrieve_query", 20)):
        req = requests[shape]

        def lookup(req=req):
            return st.lookup_bags(req["user_hist"], req["w"])
        c0 = ops.launch_counts()
        _, cold = _wall(lookup)
        fused[shape], warm = _wall(lookup, reps)
        emit("recsys", step="lookup", shape=shape,
             batch=int(req["w"].shape[0]), cold_ms=cold, warm_ms=warm,
             warm_reps=reps, launches=_since(c0))

    # -- retrieve: every item embedded once, then one query at a time
    t0 = time.perf_counter()
    cats = item_categories(n_items, FULL.n_cats, seed=1)
    cand = served.item_embed({"item_id": torch.arange(n_items, device=dev),
                              "item_cat": torch.as_tensor(cats, device=dev)},
                             row_perm=row_perm)
    torch.cuda.synchronize()
    cand_s = time.perf_counter() - t0
    queries = [{"user_hist": p99["user_hist"][i:i + 1],
                "user_dense": p99["user_dense"][i:i + 1], "cand_emb": cand}
               for i in range(RECSYS_QUERIES)]
    served.retrieve(queries[0], top_k=RECSYS_TOP_K, row_perm=row_perm)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    found = [served.retrieve(q, top_k=RECSYS_TOP_K, row_perm=row_perm)
             for q in queries]
    torch.cuda.synchronize()
    query_ms = (time.perf_counter() - t0) * 1e3 / RECSYS_QUERIES
    counts = {k: n + plan_counts[k] for k, n in ops.launch_counts().items()}
    state["launches"]["recsys"] = counts
    emit("recsys", step="retrieve", candidates=n_items, top_k=RECSYS_TOP_K,
         queries=RECSYS_QUERIES, cand_embed_s=cand_s, warm_ms_per_query=query_ms,
         cand_finite=bool(torch.isfinite(cand).all()), launches=counts)

    # -- checks, outside the counted run
    checks, errors = {}, {}
    for shape, score in out.items():
        req = requests[shape]
        checks[f"{shape}_score_bitwise"] = torch.equal(score,
                                                       model.score(req))
        checks[f"{shape}_user_embed_bitwise"] = torch.equal(
            served.user_embed(req, row_perm=row_perm), model.user_embed(req))
        checks[f"{shape}_finite"] = bool(torch.isfinite(score).all())
    table = model.item_table.detach()
    checks["lookup_bags_equals_embedding_bag"] = torch.equal(
        fused["serve_p99"], ops.embedding_bag(
            table, p99["user_hist"].clamp_min(0), p99["w"]))
    # both kernels against their plain versions on the path's own inputs
    # at each shape it gives them: the user-history bag of user_embed
    # (bag_combine over item_table[ids]) and lookup_bags' output
    for shape, req in requests.items():
        safe, w = req["user_hist"].clamp_min(0), req["w"]
        want, tol = bag_plain(lambda i, j, safe=safe: table[safe[i:j]], w)
        rows = table[safe]
        got = {"bag_combine": bag_combine.bag_combine(rows, w),
               "lookup_bags": fused[shape]}
        del rows
        for name, g in got.items():
            err = (g.double() - want.double()).abs()
            checks[f"{shape}_{name}_vs_plain"] = bool(
                (err <= 1e-6 * want.double().abs() + tol).all())
            errors[f"{shape}_{name}"] = float(err.max())
        del want, tol, got
    checks["topk_values_equal_full_sort"] = True
    checks["topk_indices_equal_full_sort_outside_ties"] = True
    for q, (vals, idx) in zip(queries, found):
        scores = cand @ model.user_embed(q)[0]
        ranked, order = torch.sort(scores, descending=True)
        ranked, order = ranked[:RECSYS_TOP_K], order[:RECSYS_TOP_K]
        checks["topk_values_equal_full_sort"] &= torch.equal(vals, ranked)
        # values held once in the top k and above its last (a tie may
        # straddle the cut) must name the same items in both
        keep = (((vals[:, None] == vals[None, :]).sum(1) == 1)
                & (vals > vals[-1]))
        checks["topk_indices_equal_full_sort_outside_ties"] &= torch.equal(
            torch.sort(idx[keep]).values, torch.sort(order[keep]).values)
    emit("recsys", step="checks", tolerance=BAG_TOLERANCE,
         max_abs_err=errors, **checks)
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"recsys checks failed: {failed}")
    _require_launched(counts, "recsys")


# ---------------------------------------------------------------------------
# gnn: GIN-TU through bsr_spmm
# ---------------------------------------------------------------------------

def gnn_inputs(state, n_graphs):
    """One ``molecule_batches(n_graphs, 30, 64, 16, 2, seed=0)`` batch (on
    the host), its BSR layout on the card (``gin_layout``: host ``to_bsr``
    and the upload, timed) and the request the model reads (``x``,
    ``graph_id``, ``labels`` on the card, as the recsys requests are), made
    once per size and kept in ``state`` until the gnn phase ends."""
    import torch

    from repro_torch.data.pipeline import molecule_batches
    from repro_torch.models.gnn import gin_layout
    key = f"gnn_{n_graphs}"
    if key not in state:
        t0 = time.perf_counter()
        batch = next(molecule_batches(n_graphs, 30, 64, 16, 2, seed=0))
        gen_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        layout = gin_layout(batch, device="cuda")
        torch.cuda.synchronize()
        prepare_s = time.perf_counter() - t0
        request = {k: torch.as_tensor(batch[k], device="cuda")
                   for k in ("x", "graph_id", "labels")}
        state[key] = dict(batch=batch, layout=layout, request=request,
                          gen_s=gen_s, prepare_s=prepare_s)
    return state[key]


def gnn_placement(state):
    """The reference's ``bsr_locality`` set-up on the port: ``rmat(4096,
    32768, seed=3)``, ``partition()`` on ``balanced_tree((4, 8))`` with seed
    0, ``block_placement`` / ``apply_placement``; node features
    ``gnn_features(g, 16, 2, seed=0)`` in both vertex orders (padding rows
    zero), each with its BSR layout on the card. Made once, kept in
    ``state`` until the gnn phase ends."""
    import numpy as np
    import torch

    from repro_torch.core.mapping import apply_placement, block_placement
    from repro_torch.core.partitioner import PartitionConfig, partition
    from repro_torch.core.topology import balanced_tree
    from repro_torch.data.pipeline import gnn_features
    from repro_torch.graph.generators import rmat
    from repro_torch.models.gnn import gin_layout
    if "gnn_placement" not in state:
        g = rmat(4096, 32768, seed=3)
        topo = balanced_tree((4, 8))
        t0 = time.perf_counter()
        res = partition(g, topo, PartitionConfig(seed=0))
        torch.cuda.synchronize()
        partition_s = time.perf_counter() - t0
        pl = block_placement(res.part, topo.k)
        gp = apply_placement(g, pl)
        feats = gnn_features(g, 16, 2, seed=0)
        x_placed = np.zeros((pl.n_pad, 16), np.float32)
        x_placed[pl.perm] = feats["x"]
        orders = {}
        for name, graph, x in (("unplaced", g, feats["x"]),
                               ("placed", gp, x_placed)):
            b = {"x": torch.as_tensor(x, device="cuda"),
                 "senders": graph.senders, "receivers": graph.receivers}
            b["layout"] = gin_layout(b, device="cuda")
            orders[name] = b
        state["gnn_placement"] = dict(topo=topo, res=res, pl=pl,
                                      partition_s=partition_s, orders=orders)
    return state["gnn_placement"]


def bsr_work(layout, f):
    """(bytes, operations) that one ``bsr_spmm`` call cannot do without:
    ``x`` and ``out`` each moved once and every nonzero's value and
    position (4 bytes each), and one multiply-add per nonzero and feature.
    A kernel that reads only the nonzero slabs can go under the stored
    blocks' bytes (``bsr_stored_work``), never under these."""
    import torch
    nbr, r = layout.n_block_rows, layout.block
    nnz = int(torch.count_nonzero(layout.blocks))
    return 8.0 * nbr * r * f + 8.0 * nnz, 2.0 * nnz * f


def bsr_stored_work(layout, f):
    """(bytes, operations) with every stored block read once: blocks,
    ``x``, ``out`` and the layout's indices."""
    nnzb, r, _ = layout.blocks.shape
    nbr = layout.n_block_rows
    bytes_moved = 4.0 * nnzb * r * r + 8.0 * nbr * r * f + 4.0 * (nbr + 1
                                                                + nnzb)
    return bytes_moved, bsr_work(layout, f)[1]


def bsr_slabs(layout, f, sms):
    """The tile the kernel takes for this layout and F, and the 16-column
    slabs of the blocks it reads (those with a nonzero in its row tile)
    against all of them."""
    from repro_torch.kernels import bsr_spmm
    shape = bsr_spmm.tile(layout.n_block_rows, layout.block, f, sms)
    read, stored = bsr_spmm.nonzero_slabs(layout.occupancy, shape[0])
    return dict(tile=list(shape), slabs_read=read, slabs_stored=stored,
                slab_share=read / stored)


def bsr_dense_ops(layout, f):
    """The multiply-adds (x2) of every stored block's dense product."""
    nnzb, r, _ = layout.blocks.shape
    return 2.0 * nnzb * r * r * f


def bsr_args(layout, x):
    return (layout.row_ptr, layout.block_cols, layout.blocks, x)


def bsr_call(layout, x, occupancy=None):
    """``bsr_spmm`` on the layout with its occupancy, as the model calls
    it, or with ``occupancy`` in its place."""
    from repro_torch.kernels import bsr_spmm
    occ = layout.occupancy if occupancy is None else occupancy
    return bsr_spmm.bsr_spmm(*bsr_args(layout, x), occ)


def bsr_library(layout, x):
    """One PyTorch call computing ``A @ x``: ``torch.sparse.mm`` on a
    ``sparse_bsr_tensor`` of the same blocks (cuSPARSE; timed here, never
    called by the port)."""
    import torch
    n = layout.n_block_rows * layout.block
    a = torch.sparse_bsr_tensor(layout.row_ptr, layout.block_cols,
                                layout.blocks, size=(n, n))
    return lambda: torch.sparse.mm(a, x)


def gapped_graph(n, m, gap, seed=0):
    """Random multigraph without arcs at the vertices in ``gap``: its block
    rows there are empty, and to_bsr fills each with one zero block."""
    import numpy as np

    from repro_torch.graph.graph import from_edges
    rng = np.random.default_rng(seed)
    keep = np.setdiff1d(np.arange(n), np.arange(*gap))
    return from_edges(n, rng.choice(keep, m), rng.choice(keep, m),
                      rng.random(m).astype(np.float32) + 0.1)


def asymmetric_batch(batch, seed=0):
    """The batch with one direction of a seeded half of its edges dropped
    (each arc s -> r with s < r goes with probability 1/2, its reverse
    stays), so that A != Aᵀ: what a backward through the forward layout
    gets wrong. ``degrees`` counts the arcs left."""
    import numpy as np
    s, r = np.asarray(batch["senders"]), np.asarray(batch["receivers"])
    keep = ~((s < r) & (np.random.default_rng(seed).random(s.shape[0])
                        < 0.5))
    out = dict(batch, senders=s[keep], receivers=r[keep],
               edge_weight=np.asarray(batch["edge_weight"])[keep])
    out["degrees"] = np.bincount(out["senders"], minlength=int(
        batch["x"].shape[0])).astype(np.float32)
    return out


def transposed_layout(batch, device):
    """The layout of the batch's reversed arcs (Aᵀ, unit weights), built
    as ``ops.prepare_bsr_pair`` builds it when the arcs are not
    symmetric."""
    import numpy as np

    from repro_torch.kernels import ops
    s = np.asarray(batch["senders"])
    return ops.prepare_bsr(int(batch["x"].shape[0]),
                           np.asarray(batch["receivers"]), s,
                           np.ones(s.shape[0], np.float32), device=device)


def bsr_cases(state):
    """(label, layout, F) of the gnn path's ``bsr_spmm`` shapes: the bulk
    batch's layout (the main shape), the request's and the bsr_locality
    graph's in both vertex orders at F = 64, a ragged R = 32, F = 96
    layout with an empty block row (its count of filled rows in
    ``state``), then the gnn_train backward's transposed layouts (built
    from the reversed arcs: the bulk and request molecules', equal to
    their forward layouts, whose arcs are symmetric, and the asymmetric
    request's of gate (a))."""
    import torch

    from repro_torch.kernels import ops
    cases = [(label, gnn_inputs(state, n)["layout"], 64)
             for label, n in (("bulk", GNN_BULK_GRAPHS),
                              ("request", GNN_REQUEST_GRAPHS))]
    cases += [(f"{label}_rmat4096", b["layout"], 64)
              for label, b in gnn_placement(state)["orders"].items()]
    g = gapped_graph(1000, 4000, (96, 160))
    lay = ops.prepare_bsr(g.n_nodes, g.senders, g.receivers, g.edge_weight,
                          32, device=torch.device("cuda"))
    state["bsr_empty_rows"] = lay.n_block_rows - len(set(
        (g.senders // 32).tolist()))
    cases.append(("ragged_R32_F96", lay, 96))
    dev = torch.device("cuda")
    for label, n in (("bulk", GNN_BULK_GRAPHS),
                     ("request", GNN_REQUEST_GRAPHS)):
        inp = gnn_inputs(state, n)
        cases.append((f"{label}_transposed",
                      transposed_layout(inp["batch"], dev), 64))
    asym = asymmetric_batch(gnn_inputs(state, GNN_REQUEST_GRAPHS)["batch"])
    cases.append(("request_asymmetric_transposed",
                  transposed_layout(asym, dev), 64))
    return cases


def phase_kernels_gnn(state):
    """bsr_spmm at the gnn path's shapes (``bsr_cases``), with both bounds:
    what no kernel can beat (``bsr_work``) and every stored block read
    once (``bsr_stored_work``), and the share of slabs the kernel reads.
    Each shape's result must also equal, bitwise, the kernel's walk over
    every slab of every stored block (an occupancy with every bit set)."""
    import torch

    from repro_torch.kernels import bsr_spmm
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for label, layout, f in bsr_cases(state):
        x = torch.randn(layout.n_block_rows * layout.block, f, generator=gen,
                        device=dev)
        args = bsr_args(layout, x)
        bytes_moved, flops = bsr_work(layout, f)
        extra = dict(
            nonzero=int(flops // (2 * f)), **bsr_slabs(layout, f, sms),
            bound_ms_stored_blocks=bound(*bsr_stored_work(layout, f))[0],
            # every stored block's dense product at the f32 peak
            dense_ops_ms=bsr_dense_ops(layout, f) / H100_F32_PER_S * 1e3)
        if label.startswith("ragged"):
            extra["empty_block_rows_filled"] = state["bsr_empty_rows"]
        if label in ("bulk_transposed", "request_transposed"):
            fwd = gnn_inputs(state, GNN_BULK_GRAPHS if label.startswith(
                "bulk") else GNN_REQUEST_GRAPHS)["layout"]
            extra["equal_to_forward_layout"] = bool(
                torch.equal(fwd.block_cols, layout.block_cols)
                and torch.equal(fwd.blocks, layout.blocks))
        every = bsr_spmm.slab_occupancy(torch.ones_like(layout.blocks))
        extra["bitwise_every_slab"] = bool(torch.equal(
            bsr_call(layout, x), bsr_call(layout, x, every)))
        del every
        if not extra["bitwise_every_slab"]:
            raise AssertionError(f"bsr_spmm {label}: reading the nonzero "
                                 f"slabs differs from reading every slab")
        _check_kernel(
            state, "bsr_spmm",
            [layout.n_block_rows, int(layout.blocks.shape[0]),
             layout.block, f, label],
            lambda: bsr_call(layout, x), lambda: bsr_spmm.plain(*args),
            exact=False, rtol=1e-6, atol=bsr_spmm.order_tolerance(*args),
            tolerance=BSR_TOLERANCE,
            iters=10 if label.startswith("bulk") else 30,
            library=bsr_library(layout, x), bytes_moved=bytes_moved,
            flops=flops, extra=extra)


def _end_to_end(model, batch, reps):
    """A request from the host's batch to logits, ``reps`` times: the
    inputs uploaded and the BSR layout built (host ``to_bsr``, block-row
    pointers, upload; ``gin_layout``), then the forward. Mean wall ms of
    the whole, of the upload and layout, of ``to_bsr`` alone on the host
    (timed apart, once per rep) and of the forward."""
    import numpy as np
    import torch

    from repro_torch.kernels import bsr_spmm
    from repro_torch.models.gnn import gin_layout
    senders = np.asarray(batch["senders"])
    ones = np.ones(senders.shape[0], np.float32)
    total = prep = host = fwd = 0.0
    for _ in range(reps):
        t0 = time.perf_counter()
        bsr_spmm.to_bsr(int(batch["x"].shape[0]), senders,
                        np.asarray(batch["receivers"]), ones)
        host += time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        req = {k: torch.as_tensor(batch[k], device="cuda")
               for k in ("x", "graph_id", "labels")}
        layout = gin_layout(batch, device="cuda")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        model(req, layout)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        total += t2 - t0
        prep += t1 - t0
        fwd += t2 - t1
    return {k: v * 1e3 / reps for k, v in (
        ("ms", total), ("upload_and_layout_ms", prep),
        ("host_to_bsr_ms", host), ("forward_ms", fwd))} | {"reps": reps}


def _logits_close(got, want):
    """(ok, max abs err, scale): |got - want| <= GNN_RTOL * (max|want| +
    |want|) elementwise."""
    scale = max(float(want.abs().max()), 1.0)
    err = (got.double() - want.double()).abs()
    ok = bool((err <= GNN_RTOL * (scale + want.double().abs())).all())
    return ok, float(err.max()), scale


def phase_gnn(state):
    import torch

    from repro_torch.configs import gin_tu
    from repro_torch.kernels import bsr_spmm, ops
    from repro_torch.models.gnn import GIN
    dev = torch.device("cuda")
    cfg = gin_tu.ARCH.make_config("molecule")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    model = GIN(cfg, generator=gen, device=dev)
    n_layers = cfg.n_layers
    inputs = {"request": gnn_inputs(state, GNN_REQUEST_GRAPHS),
              "bulk": gnn_inputs(state, GNN_BULK_GRAPHS)}

    place_in = gnn_placement(state)
    placed = place_in["orders"]
    gen.manual_seed(0)
    node_model = GIN(gin_tu.BASE, generator=gen, device=dev)

    # -- the counted run: request, bulk, placed
    ops.reset_launch_counts()
    forwards, logits = 0, {}
    for step, reps, e2e_reps in (("request", 20, 20), ("bulk", 3, 2)):
        inp = inputs[step]
        batch, layout = inp["batch"], inp["layout"]

        def serve(req=inp["request"], layout=layout):
            return model(req, layout)
        torch.cuda.reset_peak_memory_stats()
        c0 = ops.launch_counts()
        _, cold = _wall(serve)
        logits[step], warm = _wall(serve, reps)
        trace = _traced(serve, {"bsr_spmm_kernel": ("bsr_spmm",)})
        peak = torch.cuda.max_memory_allocated()
        e2e = _end_to_end(model, batch, e2e_reps)
        n_fwd = 1 + reps + trace["runs"] + e2e_reps
        forwards += n_fwd
        got = _since(c0)
        emit("gnn", step=step, graphs=int(batch["labels"].shape[0]),
             nodes=int(batch["x"].shape[0]), arcs=len(batch["senders"]),
             block_rows=layout.n_block_rows,
             blocks=int(layout.blocks.shape[0]),
             block_bytes=layout.blocks.numel() * 4,
             data_gen_s=inp["gen_s"], prepare_bsr_s=inp["prepare_s"],
             cold_ms=cold, warm_ms=warm, warm_reps=reps, end_to_end=e2e,
             max_memory_allocated=peak,
             forwards=n_fwd, launches=got,
             bsr_spmm_per_forward=got["bsr_spmm"] / n_fwd, traced=trace)
    for name, b in placed.items():
        logits[name] = node_model(b, b["layout"])
        forwards += 1
    counts = ops.launch_counts()
    state["launches"]["gnn"] = counts

    # -- placement: block counts and the kernel on each layout
    gen.manual_seed(3)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    place = {}
    for name, b in placed.items():
        lay = b["layout"]
        x = torch.randn(lay.n_block_rows * lay.block, 64, generator=gen,
                        device=dev)
        bound_ms, bound_by = bound(*bsr_work(lay, 64))
        place[name] = dict(
            nodes=lay.n_nodes, block_rows=lay.n_block_rows,
            blocks=int(lay.blocks.shape[0]),
            density=bsr_spmm.bsr_density(lay.block_cols, lay.n_block_rows,
                                         lay.n_block_rows),
            bsr_spmm_ms=device_ms(lambda x=x, lay=lay: bsr_call(lay, x), 30,
                                  flush=_flush_buffer(state)),
            bound_ms=bound_ms, bound_by=bound_by,
            bound_ms_stored_blocks=bound(*bsr_stored_work(lay, 64))[0],
            **bsr_slabs(lay, 64, sms),
            dense_ops_ms=bsr_dense_ops(lay, 64) / H100_F32_PER_S * 1e3)
    pl, res = place_in["pl"], place_in["res"]
    emit("gnn", step="placed", graph="rmat(4096,32768,seed=3)",
         machine="balanced_tree((4,8))", k=place_in["topo"].k,
         partition_s=place_in["partition_s"], makespan=res.makespan,
         bin_fill=[int(pl.fill.min()), int(pl.fill.max())], n_pad=pl.n_pad,
         layouts=place, forwards=2)

    # -- checks, outside the counted run
    checks, errors = {}, {}
    checks["bsr_spmm_5_launches_per_forward"] = (
        counts["bsr_spmm"] == n_layers * forwards)
    for step, inp in inputs.items():
        batch, layout = inp["batch"], inp["layout"]
        states = []

        def record(x, layout=layout):
            states.append(x)
            return ops.gnn_aggregate_bsr(layout, x)
        model.forward_with(inp["request"], record)
        worst = 0.0
        ok = True
        for x in states:
            pad = layout.n_block_rows * layout.block - x.shape[0]
            xp = torch.nn.functional.pad(x, (0, 0, 0, pad)).contiguous()
            args = bsr_args(layout, xp)
            got, want = bsr_call(layout, xp), bsr_spmm.plain(*args)
            err = (got - want).abs()
            ok &= bool((err <= bsr_spmm.order_tolerance(*args)
                        + 1e-6 * want.abs()).all())
            worst = max(worst, float(err.max()))
        checks[f"{step}_bsr_spmm_vs_plain_on_layer_inputs"] = ok
        errors[f"{step}_bsr_spmm"] = worst
        del states
        s = torch.as_tensor(batch["senders"], device=dev)
        r = torch.as_tensor(batch["receivers"], device=dev)
        ones = torch.ones(s.shape[0], device=dev)
        seg = model.forward_with(
            inp["request"],
            lambda x: ops.gnn_aggregate(s, r, ones, x, x.shape[0]))
        ok, err, scale = _logits_close(logits[step], seg)
        checks[f"{step}_forward_vs_segment_sum"] = ok
        errors[f"{step}_forward_vs_segment_sum"] = err
        errors[f"{step}_logit_scale"] = scale
        checks[f"{step}_logits_finite_and_shaped"] = bool(
            torch.isfinite(logits[step]).all()) and tuple(
                logits[step].shape) == (int(batch["labels"].shape[0]),
                                        cfg.n_classes)
    perm = torch.as_tensor(pl.perm, device=dev)
    ok, err, scale = _logits_close(logits["placed"][perm], logits["unplaced"])
    checks["placed_logits_equal_unplaced"] = ok
    errors["placed_vs_unplaced"] = err
    errors["placed_logit_scale"] = scale
    emit("gnn", step="checks", tolerance_logits=f"{GNN_RTOL} x (max|logit| "
         f"+ |logit|)", tolerance_bsr_spmm=BSR_TOLERANCE, forwards=forwards,
         launches=counts, max_abs_err=errors, **checks)
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"gnn checks failed: {failed}")
    _require_launched(counts, "gnn")


def _gnn_device_batch(batch, dev, layouts=False):
    """A host batch's arrays on the card, with GIN's BSR layouts
    (``gin_layouts``) where asked."""
    from repro_torch.launch.train import to_device
    from repro_torch.models.gnn import gin_layouts
    out = to_device(batch, dev)
    if layouts:
        out.update(gin_layouts(batch, device=dev))
    return out


def _gnn_train_run(cfg, params, batches, kernel_events, loss_fn=None,
                   lr=GNN_TRAIN_LR):
    """GNN_TRAIN_STEPS AdamW steps of ``loss_fn`` (default ``gnn.loss_fn``
    on ``cfg``) at ``lr`` through ``loop.run`` and ``make_train_step`` with
    the train CLI's optimizer settings (launches read around it), then one
    traced step from its end state. Returns the readings and the step."""
    import dataclasses as dc

    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch import train as tlaunch
    from repro_torch.models import gnn
    from repro_torch.optim import adamw
    from repro_torch.train import loop
    from repro_torch.train.steps import make_train_step
    ocfg = tlaunch.optimizer_config(lr, GNN_TRAIN_STEPS)
    if loss_fn is None:
        def loss_fn(p, b):
            return gnn.loss_fn(p, b, cfg)
    step = make_train_step(loss_fn, ocfg)
    rec = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    c0 = ops.launch_counts()
    p_end, o_end, result = loop.run(
        _recording_step(step, rec), params, adamw.init(params, ocfg),
        iter(batches), loop.LoopConfig(total_steps=GNN_TRAIN_STEPS))
    launches = _since(c0)
    peak = torch.cuda.max_memory_allocated()
    trace = _traced(lambda: step(p_end, o_end, batches[0]), kernel_events)
    del p_end, o_end
    torch.cuda.empty_cache()
    return dict(
        steps=GNN_TRAIN_STEPS, optimizer=dc.asdict(ocfg), remat=cfg.remat,
        cold_s=rec[0]["s"],
        warm_s_p50=float(np.median([r["s"] for r in rec[1:]])),
        step_s=[r["s"] for r in rec], losses=[r["loss"] for r in rec],
        grad_norms=[r["grad_norm"] for r in rec],
        lrs=[r["lr"] for r in rec], loop_seconds=result.seconds,
        max_memory_allocated=peak, launches=launches, traced=trace), step


def _progress(run):
    """Gate (d): finite losses and grad norms, and the mean of the last
    two losses below the first."""
    import numpy as np
    losses, norms = run["losses"], run["grad_norms"]
    return bool(np.isfinite(losses).all() and np.isfinite(norms).all()
                and np.mean(losses[-2:]) < losses[0])


def _grads_against(got, want):
    """(loss rel, per-leaf relative L2) of two ``loss_and_grads`` results."""
    loss_g, _, grads_g = got
    loss_w, _, grads_w = want
    from repro_torch import tree
    rel = [_rel_l2(a.cpu(), b.cpu()) for a, b in zip(tree.leaves(grads_g),
                                                     tree.leaves(grads_w))]
    return abs(float(loss_g) - float(loss_w)) / abs(float(loss_w)), rel


def _bsr_backward_check(params, batch, cfg):
    """Gate (e): the step's own cotangents of the five aggregations
    (recorded by a hook on each output), each through ``bsr_spmm`` on the
    transposed layout against the plain version of the same product in
    float64, in the forward's band. (The plain version in float32 is no
    yardstick here: its ``bmm`` flushes subnormal products to zero, and a
    saturated softmax gives cotangents of ~1e-40, which the kernel sums
    exactly.) Returns (ok, readings)."""
    import torch

    from repro_torch import tree
    from repro_torch.kernels import bsr_spmm, ops
    from repro_torch.models import gnn
    from repro_torch.models.common import cross_entropy
    lay, lay_t = batch["bsr"], batch["bsr_t"]
    douts = []

    def record(x):
        out = ops.gnn_aggregate_bsr(lay, x, lay_t)
        out.register_hook(lambda g: douts.append(g.detach()))
        return out
    live = [p.detach().requires_grad_(True) for p in tree.leaves(params)]
    logits = gnn.forward(tree.unflatten(params, live), batch, cfg, record)
    torch.autograd.grad(cross_entropy(logits, batch["labels"],
                                      batch["label_mask"]), live)
    ok, worst, worst_plain, flushed = True, 0.0, 0.0, 0
    n = lay_t.n_nodes
    for g in douts:
        got = ops.gnn_aggregate_bsr(lay_t, g)
        pad = lay_t.n_block_rows * lay_t.block - n
        args = bsr_args(lay_t, torch.nn.functional.pad(g, (0, 0, 0, pad)))
        exact = bsr_spmm.plain(*args[:2], args[2].double(),
                               args[3].double())[:n]
        err = (got.double() - exact).abs()
        tol = bsr_spmm.order_tolerance(*args[:2], args[2].double(),
                                       args[3].double())[:n]
        ok &= bool((err <= tol + 1e-6 * exact.abs()).all())
        worst = max(worst, float(err.max()))
        plain32 = bsr_spmm.plain(*args)[:n]
        worst_plain = max(worst_plain,
                          float((plain32.double() - exact).abs().max()))
        flushed += int(((plain32 == 0) & (exact != 0)).sum())
    return ok, dict(cotangents=len(douts), max_abs_err=worst,
                    plain_f32_max_abs_err=worst_plain,
                    plain_f32_flushed_entries=flushed,
                    subnormal_cotangent_entries=sum(
                        int(((g != 0) & (g.abs() < 2.0 ** -126)).sum())
                        for g in douts))


def phase_gnn_train(state):
    """GNN training on the card at full width: GIN-TU on molecules through
    ``bsr_spmm`` forward and on the transposed layout backward, PNA and
    MeshGraphNet on minibatch_lg's sampled batches (plain PyTorch
    aggregations), each GNN_TRAIN_STEPS steps through ``loop.run`` with one
    traced step, then the gates (a)-(e)."""
    import dataclasses as dc
    import itertools

    import numpy as np
    import torch

    from repro_torch import tree
    from repro_torch.configs import gin_tu, meshgraphnet, pna
    from repro_torch.configs.common import GNN_SHAPE_META
    from repro_torch.data.pipeline import (gnn_features, minibatch_batches,
                                           molecule_batches)
    from repro_torch.graph.generators import random_regular
    from repro_torch.kernels import ops
    from repro_torch.launch import train as tlaunch
    from repro_torch.models import gnn
    from repro_torch.optim import adamw
    from repro_torch.train.steps import loss_and_grads
    dev = torch.device("cuda")
    bsr_events = {"bsr_spmm_kernel": ("bsr_spmm",)}
    checks, errors = {}, {}
    ops.reset_launch_counts()

    # -- gin_molecule: 6 steps of 128 molecules, then the bulk batch
    cfg = gin_tu.ARCH.make_config("molecule")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = gnn.init(cfg, gen, device=dev)
    t0 = time.perf_counter()
    mol_host = list(itertools.islice(molecule_batches(
        GNN_REQUEST_GRAPHS, 30, 64, 16, 2, seed=0), GNN_TRAIN_STEPS))
    mol = [_gnn_device_batch(b, dev, layouts=True) for b in mol_host]
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t0
    gin, gin_step = _gnn_train_run(cfg, params, mol, bsr_events)
    n_layers = cfg.n_layers
    c0 = ops.launch_counts()
    with torch.no_grad():
        gnn.loss_fn(params, mol[0], cfg)
    gin["bsr_spmm_per_forward"] = _since(c0)["bsr_spmm"]
    gin["bsr_spmm_per_step"] = gin["launches"]["bsr_spmm"] / GNN_TRAIN_STEPS
    flops = gin_tu.ARCH.model_flops("molecule")
    emit("gnn_train", step="gin_molecule", arch="gin-tu", config="molecule",
         layers=n_layers, width=cfg.d_hidden, graphs=GNN_REQUEST_GRAPHS,
         nodes=int(mol_host[0]["x"].shape[0]),
         arcs=len(mol_host[0]["senders"]), batches_and_layouts_s=prep_s,
         molecules_per_s=GNN_REQUEST_GRAPHS / gin["warm_s_p50"],
         model_flops_per_step=flops,
         model_tflops_per_s=flops / gin["warm_s_p50"] / 1e12,
         nvidia_smi=state["smi"], **gin)
    checks["a_gin_bsr_spmm_5_forward_launches"] = (
        gin["bsr_spmm_per_forward"] == n_layers)
    checks["a_gin_bsr_spmm_10_launches_per_step"] = (
        gin["launches"]["bsr_spmm"] == 2 * n_layers * GNN_TRAIN_STEPS)
    checks["a_gin_trace_holds_10_bsr_spmm_events"] = (
        gin["traced"]["port_launches"]["bsr_spmm_kernel"]["traced"]
        == 2 * n_layers)
    checks["d_gin_molecule_progress"] = _progress(gin)

    bulk_in = gnn_inputs(state, GNN_BULK_GRAPHS)
    bulk_host, bulk_lay = bulk_in["batch"], bulk_in["layout"]
    t0 = time.perf_counter()
    symmetric = ops.arcs_symmetric(
        bulk_host["senders"], bulk_host["receivers"],
        np.ones(len(bulk_host["senders"]), np.float32))
    sym_s = time.perf_counter() - t0
    if not symmetric:
        raise AssertionError("the bulk molecules' arcs are not symmetric")
    bulk = dict(_gnn_device_batch(bulk_host, dev), bsr=bulk_lay,
                bsr_t=bulk_lay)
    torch.cuda.reset_peak_memory_stats()
    c0 = ops.launch_counts()
    rec = []
    timed = _recording_step(gin_step, rec)
    p_b, o_b = params, adamw.init(params, tlaunch.optimizer_config(
        GNN_TRAIN_LR, GNN_TRAIN_STEPS))
    for _ in range(2):
        p_b, o_b, _ = timed(p_b, o_b, bulk)
    bulk_launches = _since(c0)
    flops_bulk = flops * GNN_BULK_GRAPHS / GNN_REQUEST_GRAPHS
    emit("gnn_train", step="gin_bulk", graphs=GNN_BULK_GRAPHS,
         nodes=int(bulk_host["x"].shape[0]),
         arcs=len(bulk_host["senders"]), symmetric_check_s=sym_s,
         cold_s=rec[0]["s"], warm_s=rec[1]["s"],
         molecules_per_s=GNN_BULK_GRAPHS / rec[1]["s"],
         model_tflops_per_s=flops_bulk / rec[1]["s"] / 1e12,
         losses=[r["loss"] for r in rec],
         grad_norms=[r["grad_norm"] for r in rec],
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         launches=bulk_launches)
    checks["a_gin_bulk_bsr_spmm_10_launches_per_step"] = (
        bulk_launches["bsr_spmm"] == 2 * 2 * n_layers)
    checks["d_gin_bulk_finite"] = bool(np.isfinite(
        [r["loss"] for r in rec] + [r["grad_norm"] for r in rec]).all())
    del bulk, p_b, o_b
    for key in [k for k in state if k.startswith("gnn_")]:
        del state[key]     # the gnn phase's batches, layouts, placement
    torch.cuda.empty_cache()

    # -- minibatch_lg: the sampled batches, then PNA and MeshGraphNet
    meta = GNN_SHAPE_META["minibatch_lg"]
    t0 = time.perf_counter()
    g = random_regular(meta["full_n"], GNN_TRAIN_DEGREE, seed=0)
    graph_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    feats = gnn_features(g, meta["d_feat"], meta["classes"], seed=0)
    feats_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    stream = minibatch_batches(g, feats, meta["batch_nodes"],
                               tuple(meta["fanout"]), meta["n"],
                               meta["arcs"], seed=0)
    mb_host = list(itertools.islice(stream, GNN_TRAIN_STEPS))
    sample_s = (time.perf_counter() - t0) / GNN_TRAIN_STEPS
    del g, feats, stream
    s0, r0 = mb_host[0]["senders"], mb_host[0]["receivers"]
    sink = meta["n"] - 1
    real = ~((s0 == sink) & (r0 == sink))
    keys = s0[real].astype(np.int64) * meta["n"] + r0[real]
    data = dict(parent_nodes=meta["full_n"], parent_degree=GNN_TRAIN_DEGREE,
                parent_arcs=meta["full_n"] * GNN_TRAIN_DEGREE,
                graph_s=graph_s, features_s=feats_s,
                sample_s_per_batch=sample_s,
                batch0_padding_arcs=int((~real).sum()),
                batch0_duplicate_arcs=int(real.sum() - np.unique(keys).size),
                batch0_nodes_used=int(np.unique(np.concatenate(
                    [s0[real], r0[real]])).size))
    mb = [_gnn_device_batch(b, dev) for b in mb_host]
    reduced = (f"minibatch_lg's parent graph cut from full_arcs "
               f"{meta['full_arcs']:,} (mean degree 492) to random_regular("
               f"{meta['full_n']:,}, {GNN_TRAIN_DEGREE}): "
               f"{meta['full_n'] * GNN_TRAIN_DEGREE:,} arcs; batches at the "
               f"grid's full size")
    runs = {}
    for kind, arch in (("pna", pna.ARCH), ("mgn", meshgraphnet.ARCH)):
        kcfg = arch.make_config("minibatch_lg")
        gen.manual_seed(0)
        kparams = gnn.init(kcfg, gen, device=dev)
        run, _ = _gnn_train_run(kcfg, kparams, mb, {})
        del kparams
        kflops = arch.model_flops("minibatch_lg")
        runs[kind] = run
        emit("gnn_train", step=f"{kind}_minibatch", arch=arch.name,
             config="minibatch_lg", layers=kcfg.n_layers,
             width=kcfg.d_hidden, d_in=kcfg.d_in, classes=kcfg.n_classes,
             seeds=meta["batch_nodes"], nodes=meta["n"], arcs=meta["arcs"],
             data=data, reduced=reduced,
             seeds_per_s=meta["batch_nodes"] / run["warm_s_p50"],
             model_flops_per_step=kflops,
             model_tflops_per_s=kflops / run["warm_s_p50"] / 1e12,
             mfu_f32=kflops / run["warm_s_p50"] / H100_F32_PER_S,
             tf32=torch.backends.cuda.matmul.allow_tf32,
             nvidia_smi=state["smi"], **run)
        checks[f"d_{kind}_minibatch_progress"] = _progress(run)
        torch.cuda.empty_cache()
    counts = ops.launch_counts()
    state["launches"]["gnn_train"] = counts
    del mb

    # -- (c) PNA and MeshGraphNet, card against CPU at full width, 2 layers
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    for kind, arch in (("pna", pna.ARCH), ("mgn", meshgraphnet.ARCH)):
        kcfg = dc.replace(arch.make_config("minibatch_lg"),
                          n_layers=GNN_TRAIN_CUT_LAYERS)
        p_cpu = gnn.init(kcfg, torch.Generator().manual_seed(0),
                         device="cpu")
        t0 = time.perf_counter()
        card = loss_and_grads(
            lambda p, b: gnn.loss_fn(p, b, kcfg),
            tree.map_(lambda t: t.to(dev), p_cpu),
            _gnn_device_batch(mb_host[0], dev))
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        cpu = loss_and_grads(lambda p, b: gnn.loss_fn(p, b, kcfg), p_cpu,
                             mb_host[0])
        cpu_s = time.perf_counter() - t0
        names = _leaf_names(p_cpu)
        l_rel, rel = _grads_against(card, cpu)
        errors[f"c_{kind}"] = dict(
            layers=GNN_TRAIN_CUT_LAYERS, loss_card=float(card[0]),
            loss_cpu=float(cpu[0]), loss_rel=l_rel,
            worst_leaf_rel_l2=max(rel),
            worst_leaf=names[int(np.argmax(rel))],
            seconds=dict(card=card_s, cpu=cpu_s))
        checks[f"c_{kind}_card_vs_cpu"] = (
            l_rel <= GNN_TRAIN_LOSS_RTOL and max(rel) <= GNN_TRAIN_GRAD_REL_L2)
        del card, cpu, p_cpu
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = allow

    # -- (a), (b), (e): GIN's kernel path against its plain path
    plain0 = {k: v for k, v in mol[0].items() if k not in ("bsr", "bsr_t")}
    asym_host = asymmetric_batch(mol_host[0], seed=0)
    asym = _gnn_device_batch(asym_host, dev, layouts=True)
    checks["a_asymmetric_layouts_differ"] = asym["bsr_t"] is not asym["bsr"]
    asym_plain = {k: v for k, v in asym.items() if k not in ("bsr", "bsr_t")}

    def grads(b, aggregate=None):
        return loss_and_grads(
            lambda p, bt: gnn.loss_fn(p, bt, cfg, aggregate), params, b)

    def plain_grads(b):
        return grads(b, gnn.plain_aggregate(b))
    names = _leaf_names(params)
    for label, kern, plain in (("molecule", mol[0], plain0),
                               ("asymmetric", asym, asym_plain)):
        l_rel, rel = _grads_against(grads(kern), plain_grads(plain))
        errors[f"a_{label}"] = dict(loss_rel=l_rel,
                                    worst_leaf_rel_l2=max(rel),
                                    worst_leaf=names[int(np.argmax(rel))])
        checks[f"a_{label}_kernel_vs_plain"] = (
            l_rel <= GNN_TRAIN_LOSS_RTOL and max(rel) <= GNN_TRAIN_GRAD_REL_L2)
    planted = dict(asym, bsr_t=asym["bsr"])
    l_rel, rel = _grads_against(grads(planted), plain_grads(asym_plain))
    errors["b_planted_forward_layout_backward"] = dict(
        loss_rel=l_rel, worst_leaf_rel_l2=max(rel),
        worst_leaf=names[int(np.argmax(rel))],
        times_the_band=max(rel) / GNN_TRAIN_GRAD_REL_L2)
    checks["b_planted_fault_fails_a"] = max(rel) > GNN_TRAIN_GRAD_REL_L2
    for label, b in (("molecule", mol[0]), ("asymmetric", asym)):
        ok, readings = _bsr_backward_check(params, b, cfg)
        errors[f"e_{label}_bsr_spmm_backward"] = readings
        checks[f"e_{label}_backward_vs_plain"] = (
            ok and readings["cotangents"] == n_layers)

    emit("gnn_train", step="checks", tolerances=dict(
        a=f"loss rel <= {GNN_TRAIN_LOSS_RTOL}, every gradient leaf's "
          f"relative L2 <= {GNN_TRAIN_GRAD_REL_L2}: kernel path vs plain "
          f"edge_apply path on the card; molecules and a seeded half of one "
          f"direction of their edges dropped",
        b="a backward through the forward layout on the asymmetric arcs "
          "must fail (a)",
        c=f"float32, TF32 off, full width at {GNN_TRAIN_CUT_LAYERS} "
          f"layers: the card's loss and each gradient leaf against the "
          f"CPU's in the (a) bands",
        d="finite; mean of the last two losses below the first",
        e=BSR_TOLERANCE + ", on each of step 1's own cotangents through "
          "the transposed layout, against the plain product in float64"),
        max_abs_err=errors, launches=counts,
        **checks)
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"gnn_train checks failed: {failed}")
    _require_launched(counts, "gnn_train")


def molecules_head(batch, graphs, nodes_per=30):
    """The first ``graphs`` molecules of a ``molecule_batches`` batch: their
    nodes, the arcs among them (the batch's adjacency is block-diagonal)
    and their labels."""
    import numpy as np
    n = graphs * nodes_per
    keep = batch["senders"] < n
    if not (batch["receivers"][keep] < n).all():
        raise AssertionError("an arc leaves the first molecules")
    out = {k: batch[k][:n] for k in ("x", "pos", "degrees", "graph_id")}
    out.update({k: batch[k][keep] for k in ("senders", "receivers",
                                            "edge_weight")})
    out.update({k: batch[k][:graphs] for k in ("labels", "label_mask")})
    return {k: np.ascontiguousarray(v) for k, v in out.items()}


def seeded_rotation(seed):
    """A proper rotation matrix from a seeded Gaussian's QR."""
    import numpy as np
    q, _ = np.linalg.qr(np.random.default_rng(seed).normal(size=(3, 3)))
    return q * np.linalg.det(q)


def _rotated_back_by_d(rotate):
    """The planted fault of gate (d): ``_rotate`` that applies D where the
    value messages should be rotated back by its transpose."""
    def fault(d_blocks, x, l_max, transpose=False):
        return rotate(d_blocks, x, l_max)
    return fault


def phase_equiformer(state):
    """EquiformerV2 training on the card at full width (remat), launch
    counts set to 0 just before it (no port kernel lies on this path):
    GNN_TRAIN_STEPS steps through ``loop.run`` at EQ_LR with one traced
    step, then gates
    (a) progress, (b) card against CPU, (c) the chunked arcs against the
    direct ones, (d) rotation invariance with a planted fault."""
    import dataclasses as dc
    import itertools

    import numpy as np
    import torch

    from repro_torch import tree
    from repro_torch.configs import equiformer_v2
    from repro_torch.data.pipeline import molecule_batches
    from repro_torch.kernels import ops
    from repro_torch.models import equiformer
    from repro_torch.train.steps import loss_and_grads
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    checks, errors = {}, {}
    allow = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ops.reset_launch_counts()

    # -- (a) full width: GNN_TRAIN_STEPS steps of 128 molecules
    cfg = dc.replace(equiformer_v2.ARCH.make_config("molecule"), remat=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = equiformer.init(cfg, gen, device=dev)
    n_params = sum(t.numel() for t in tree.leaves(params))
    host = list(itertools.islice(molecule_batches(
        GNN_REQUEST_GRAPHS, 30, 64, 16, 2, seed=0), GNN_TRAIN_STEPS))
    batches = [_gnn_device_batch(b, dev) for b in host]
    run, _ = _gnn_train_run(
        cfg, params, batches, {},
        lambda p, b: equiformer.loss_fn(p, b, cfg), lr=EQ_LR)
    state["launches"]["equiformer"] = ops.launch_counts()
    flops = equiformer_v2.ARCH.model_flops("molecule")
    emit("equiformer", step="train", arch="equiformer-v2", config="molecule",
         layers=cfg.n_layers, channels=cfg.channels, l_max=cfg.l_max,
         m_max=cfg.m_max, heads=cfg.n_heads, params=n_params,
         graphs=GNN_REQUEST_GRAPHS, nodes=int(host[0]["x"].shape[0]),
         arcs=len(host[0]["senders"]), edge_chunk=cfg.edge_chunk,
         molecules_per_s=GNN_REQUEST_GRAPHS / run["warm_s_p50"],
         model_flops_per_step=flops,
         model_tflops_per_s=flops / run["warm_s_p50"] / 1e12,
         mfu_f32=flops / run["warm_s_p50"] / H100_F32_PER_S,
         tf32=torch.backends.cuda.matmul.allow_tf32,
         nvidia_smi=state["smi"], **run)
    checks["a_progress"] = _progress(run)
    del params, run
    torch.cuda.empty_cache()

    # -- (b) the card against the CPU: 2 layers, step 1's first molecules
    cut = dc.replace(cfg, n_layers=EQ_CUT_LAYERS, remat=False)
    p_cpu = equiformer.init(cut, torch.Generator().manual_seed(0),
                            device="cpu")
    p_dev = tree.map_(lambda t: t.to(dev), p_cpu)
    names = _leaf_names(p_cpu)

    def grads(p, b, c):
        return loss_and_grads(lambda pp, bb: equiformer.loss_fn(pp, bb, c),
                              p, b)
    small = molecules_head(host[0], EQ_CPU_GRAPHS)
    t0 = time.perf_counter()
    card = grads(p_dev, _gnn_device_batch(small, dev), cut)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = grads(p_cpu, small, cut)
    cpu_s = time.perf_counter() - t0
    l_rel, rel = _grads_against(card, cpu)
    errors["b_card_vs_cpu"] = dict(
        layers=EQ_CUT_LAYERS, graphs=EQ_CPU_GRAPHS,
        nodes=int(small["x"].shape[0]), arcs=len(small["senders"]),
        loss_card=float(card[0]), loss_cpu=float(cpu[0]), loss_rel=l_rel,
        worst_leaf_rel_l2=max(rel), worst_leaf=names[int(np.argmax(rel))],
        seconds=dict(card=card_s, cpu=cpu_s))
    checks["b_card_vs_cpu"] = (l_rel <= GNN_TRAIN_LOSS_RTOL
                               and max(rel) <= GNN_TRAIN_GRAD_REL_L2)
    del card, cpu, p_cpu

    # -- (c) chunked against direct arcs on the card, step 1's molecules
    chunked = dc.replace(cut, edge_chunk=EQ_CHUNK)
    b0 = batches[0]
    readings = {}
    for label, c in (("direct", cut), ("chunked", chunked)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = grads(p_dev, b0, c)
        torch.cuda.synchronize()
        readings[label] = (out, time.perf_counter() - t0,
                           torch.cuda.max_memory_allocated())
    with torch.no_grad():
        lg = equiformer.forward(p_dev, b0, cut)
        lg_c = equiformer.forward(p_dev, b0, chunked)
    band = GNN_RTOL * (lg.abs().max() + lg.abs())
    l_rel, rel = _grads_against(readings["chunked"][0],
                                readings["direct"][0])
    errors["c_chunked_vs_direct"] = dict(
        chunk=EQ_CHUNK, chunks=-(-len(host[0]["senders"]) // EQ_CHUNK),
        logit_max_abs_err=float((lg_c - lg).abs().max()),
        logit_share_of_band=float(((lg_c - lg).abs() / band).max()),
        loss_rel=l_rel, worst_leaf_rel_l2=max(rel),
        worst_leaf=names[int(np.argmax(rel))],
        seconds={k: v[1] for k, v in readings.items()},
        max_memory_allocated={k: v[2] for k, v in readings.items()})
    checks["c_chunked_vs_direct"] = bool(
        ((lg_c - lg).abs() <= band).all() and l_rel <= GNN_TRAIN_LOSS_RTOL
        and max(rel) <= GNN_TRAIN_GRAD_REL_L2)
    del readings

    # -- (d) rotation invariance on the card, and the planted fault
    q = torch.as_tensor(seeded_rotation(5), dtype=torch.float32, device=dev)
    b_rot = dict(b0, pos=b0["pos"] @ q.T)

    def invariance():
        with torch.no_grad():
            a = equiformer.forward(p_dev, b0, cut)
            r = equiformer.forward(p_dev, b_rot, cut)
        return float((a - r).abs().max() / a.abs().max())
    inv = invariance()
    rotate = equiformer._rotate
    equiformer._rotate = _rotated_back_by_d(rotate)
    try:
        planted = invariance()
    finally:
        equiformer._rotate = rotate
    errors["d_invariance"] = dict(
        l_max=cut.l_max, rel_max_abs_err=inv, band=EQ_INVARIANCE_TOL,
        planted_rotate_back_by_d=planted,
        planted_times_the_band=planted / EQ_INVARIANCE_TOL)
    checks["d_rotation_invariant"] = inv <= EQ_INVARIANCE_TOL
    checks["d_planted_fault_fails_10x"] = (
        planted >= EQ_FAULT_TIMES * EQ_INVARIANCE_TOL)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = \
        allow
    del p_dev, batches
    counts = ops.launch_counts()

    emit("equiformer", step="checks", tolerances=dict(
        a="finite; mean of the last two losses below the first",
        b=f"float32, TF32 off, full width at {EQ_CUT_LAYERS} layers, step "
          f"1's first {EQ_CPU_GRAPHS} molecules: loss rel <= "
          f"{GNN_TRAIN_LOSS_RTOL}, every gradient leaf's relative L2 <= "
          f"{GNN_TRAIN_GRAD_REL_L2}, card against CPU",
        c=f"edge_chunk {EQ_CHUNK} against 0 on step 1's molecules: logits "
          f"|d| <= {GNN_RTOL} (max|logit| + |logit|), (b)'s loss and "
          f"gradient bands",
        d=f"positions rotated by a seeded rotation: max|d logit| <= "
          f"{EQ_INVARIANCE_TOL} max|logit|; rotating back by D instead of "
          f"its transpose must read {EQ_FAULT_TIMES}x that or more"),
        max_abs_err=errors, launches=counts, nvidia_smi=state["smi"],
        seconds=time.perf_counter() - t_phase, **checks)
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"equiformer checks failed: {failed}")


def flash_bf16_judge(q, k, v, got, want, q_chunk, kv_chunk):
    """Hold bf16 ``flash_attention`` output ``got`` (causal) to the
    function's value, the plain version in float32 on the same inputs:
    its largest and root-mean-square error, the latter also in every
    128-row sequence tile (so a fault confined to a few tiles does not hide
    in the whole tensor's mean), at most ``FLASH_BF16_RATIO`` times those
    of ``want``, the bf16 plain version's. Two planted faults are read
    against the same band and must fail it: the output scaled by 1 + 2^-7,
    and the kernel run with the values of the kv tile at the sequence's
    middle zeroed. Returns (ok, tolerance, readings)."""
    import math

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.common import flash_attention as plain
    truth = plain(q.float(), k.float(), v.float(), causal=True,
                  q_chunk=q_chunk, kv_chunk=kv_chunk)

    def errs(x):
        d = (x.float() - truth).square_()
        tiles = [float(d[:, r:r + 128].mean().sqrt())
                 for r in range(0, d.shape[1], 128)]
        return float(d.max().sqrt()), float(d.mean().sqrt()), tiles

    def within(x):
        e_max, e_rms, e_tiles = errs(x)
        worst = max((a / b if b else (0.0 if a == 0 else math.inf))
                    for a, b in zip(e_tiles, p_tiles))
        return (e_max <= FLASH_BF16_RATIO * p_max
                and e_rms <= FLASH_BF16_RATIO * p_rms
                and worst <= FLASH_BF16_RATIO), e_max, e_rms, worst

    p_max, p_rms, p_tiles = errs(want)
    ok, k_max, k_rms, k_worst = within(got)
    mid = v.shape[1] // 2
    v_cut = v.clone()
    v_cut[:, mid:mid + 64] = 0
    planted = {"scaled_1+2^-7": within(got.float() * (1 + 2.0 ** -7)),
               "tile_values_zeroed": within(
                   fa.flash_attention(q, k, v_cut, causal=True))}
    del truth, v_cut
    rejected = not any(p[0] for p in planted.values())
    readings = dict(
        kernel_vs_f32_max=k_max, kernel_vs_f32_rms=k_rms,
        kernel_worst_tile_rms_ratio=k_worst,
        plain_bf16_vs_f32_max=p_max, plain_bf16_vs_f32_rms=p_rms,
        out_rms=float(got.float().square().mean().sqrt()),
        planted={name: dict(max=m, rms=r, worst_tile_rms_ratio=w,
                            rejected=not passed)
                 for name, (passed, m, r, w) in planted.items()})
    return (ok and rejected,
            f"max and rms error against the float32 plain version, the rms "
            f"also per 128-row tile, <= {FLASH_BF16_RATIO}x the bf16 plain "
            f"version's; planted faults rejected", readings)


def flash_grad_judge(q, k, v, do, q_chunk, kv_chunk):
    """Hold the training path's attention, the kernel's forward with its
    log-sum-exp and the plain ``_flash_bwd`` recompute from its residuals,
    to the function's value on bf16 ``q, k, v`` (causal) and the output
    cotangent ``do``: the plain forward and backward in float32 on the same
    inputs. dq, dk and dv each: largest and root-mean-square error at most
    ``FLASH_BF16_RATIO`` times those of the bf16 plain path (the plain
    forward's residuals, the same backward), the root-mean-square also in
    every 128-row tile along the sequence, so a fault confined to a few
    tiles does not hide in the whole tensor's mean. The kernel's ``lse``
    against the bf16 plain forward's within ``TRAIN_LSE_TOL``; its output
    bitwise the same with and without ``lse``. Two planted faults are read against
    the same band and must fail it: ``lse + ln 2`` in the saved residuals
    (the forward stays right), and the kv tile at the sequence's middle
    given dv = 0. Returns (ok, readings)."""
    import math

    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.common import flash_attention_bwd as bwd
    from repro_torch.models.common import flash_attention_fwd as fwd
    chunks = (True, q_chunk, kv_chunk)
    names = ("dq", "dk", "dv")
    f32 = [x.float() for x in (q, k, v, do)]
    o32, l32 = fwd(*f32[:3], *chunks)
    truth = bwd(*f32[:3], o32, l32, f32[3], *chunks)
    del o32, f32
    o_k, l_k = fa.flash_attention(q, k, v, causal=True, return_lse=True)
    same_out = torch.equal(o_k, fa.flash_attention(q, k, v, causal=True))
    o_p, l_p = fwd(q, k, v, *chunks)
    g_k = bwd(q, k, v, o_k, l_k, do, *chunks)
    g_p = bwd(q, k, v, o_p, l_p, do, *chunks)

    def errs(gs):
        """Per gradient: (max, rms, [rms of each 128-row sequence tile])."""
        out = []
        for g, t in zip(gs, truth):
            e = g.float() - t
            sq = e.square()
            out.append((float(e.abs().max()), float(sq.mean().sqrt()),
                        [float(sq[:, r:r + 128].mean().sqrt())
                         for r in range(0, sq.shape[1], 128)]))
        return out
    p_err = errs(g_p)

    def within(gs):
        e = errs(gs)
        return all(em <= FLASH_BF16_RATIO * pm and er <= FLASH_BF16_RATIO * pr
                   and all(a <= FLASH_BF16_RATIO * b for a, b in zip(et, pt))
                   for (em, er, et), (pm, pr, pt) in zip(e, p_err)), e

    def reading(e):
        """max, rms and the largest tile rms over the plain path's."""
        return {n: dict(max=m, rms=r, worst_tile_rms_ratio=max(
            a / b if b else (0.0 if a == 0 else math.inf)
            for a, b in zip(et, pt)))
            for n, (m, r, et), (_, _, pt) in zip(names, e, p_err)}
    ok_grads, k_err = within(g_k)
    dv_cut = g_k[2].clone()
    mid = v.shape[1] // 2
    dv_cut[:, mid:mid + 128] = 0
    planted = {"lse_plus_ln2": within(bwd(q, k, v, o_k, l_k + math.log(2.0),
                                          do, *chunks)),
               "tile_dv_zeroed": within((g_k[0], g_k[1], dv_cut))}
    del dv_cut
    lse_err = float((l_k - l_p).abs().max())
    rejected = not any(p[0] for p in planted.values())
    readings = dict(
        kernel_vs_f32=reading(k_err),
        plain_bf16_vs_f32={n: dict(max=m, rms=r) for n, (m, r, _) in
                           zip(names, p_err)},
        lse_kernel_vs_plain_bf16_max=lse_err,
        lse_kernel_vs_f32_max=float((l_k - l32).abs().max()),
        lse_range=[float(l_k.min()), float(l_k.max())],
        out_bitwise_with_and_without_lse=same_out,
        planted={name: dict(rejected=not passed, **reading(e))
                 for name, (passed, e) in planted.items()})
    ok = ok_grads and rejected and same_out and lse_err <= TRAIN_LSE_TOL
    return ok, readings


def phase_kernels_lm(state):
    """flash_attention at the lm paths' shapes, on random bf16 inputs: one
    prefill call (4 x 4,096 tokens, 12 query heads on 2 KV heads of 128,
    causal; the main shape), one call of the 32,768-token prefill, and
    DeepSeek-V2-Lite's MLA prefill call (4 x 4,096, 16 heads on 16, q/k
    head dim 192, v head dim 128), each held to the float32 plain version
    by ``flash_bf16_judge``, then the reference's MLA-like float32 case
    (D = 24, Dv = 16: the SIMT kernel) at its band, two calls bitwise.
    The library yardstick is ``scaled_dot_product_attention(is_causal=
    True, enable_gqa=True)``: its causal mask is top-left aligned, the
    same function at Sq = Sk (the backend it picks is recorded). The
    path's own inputs are held to the plain version in the lm and lm_mla
    phases' checks."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend

    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.common import flash_attention as plain
    cfg = configs.get(LM_ARCH).make_config("decode_32k")
    mla = configs.get(MLA_ARCH).make_config("decode_32k")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    # the plain version takes ~3.3 s at 32k: one timed call of each there,
    # the plain version's warm-up the check's own call
    for label, (b, s), (h, kh, d, dv), iters, warmup, plain_warmup in (
            ("prefill", LM_PREFILL,
             (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.head_dim),
             10, 3, 3),
            ("prefill_long", LM_LONG,
             (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.head_dim),
             1, 1, 0),
            ("mla", LM_PREFILL,
             (mla.n_heads, mla.n_heads, mla.qk_head_dim, mla.v_head_dim),
             10, 3, 1)):
        q, k, v = (torch.randn(b, s, n, w, generator=gen, device=dev)
                   .to(torch.bfloat16)
                   for n, w in ((h, d), (kh, d), (kh, dv)))
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))

        def library():
            return F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True)
        nbytes, flops = fa.work(b, s, s, h, kh, d, True, 2, dv=dv)
        extra = dict(gflop=flops / 1e9, mbytes=nbytes / 1e6,
                     f32_vector_bound_ms=flops / H100_F32_PER_S * 1e3)
        if label == "mla":       # the backend SDPA picks, for the record
            extra["sdpa_backend"] = SDPBackend(torch._fused_sdp_choice(
                qt, kt, vt, is_causal=True, enable_gqa=True)).name
        _check_kernel(
            state, "flash_attention", [b, s, h, kh, d, dv, "bf16", label],
            lambda: fa.flash_attention(q, k, v, causal=True),
            lambda: plain(q, k, v, causal=True, q_chunk=cfg.q_chunk,
                          kv_chunk=cfg.kv_chunk),
            exact=False, iters=iters, warmup=warmup,
            plain_warmup=plain_warmup,
            judge=lambda got, want: flash_bf16_judge(
                q, k, v, got, want, cfg.q_chunk, cfg.kv_chunk),
            library=library, bytes_moved=nbytes, flops=flops,
            peak=H100_BF16_PER_S, extra=extra)
        del q, k, v, qt, kt, vt
    # the reference's MLA-like float32 case (Dv != D, the SIMT kernel): its
    # band, and two calls bitwise
    b, sq, sk, h, kh, d, dv, causal = MLA_F32_CASE
    q, k, v = (torch.randn(shape, generator=gen, device=dev) for shape in
               ((b, sq, h, d), (b, sk, kh, d), (b, sk, kh, dv)))

    def f32_judge(got, want):
        err = (got - want).abs()
        ok = bool((err <= FLASH_F32_TOL + FLASH_F32_TOL * want.abs()).all())
        repeat = torch.equal(got, fa.flash_attention(q, k, v, causal=causal))
        return (ok and repeat, f"rtol = atol = {FLASH_F32_TOL}, two calls "
                f"bitwise", dict(bitwise_repeat=repeat))
    nbytes, flops = fa.work(b, sq, sk, h, kh, d, causal, 4, dv=dv)
    _check_kernel(
        state, "flash_attention", [b, sq, h, kh, d, dv, "f32", "mla_like"],
        lambda: fa.flash_attention(q, k, v, causal=causal),
        lambda: plain(q, k, v, causal=causal, q_chunk=64, kv_chunk=64),
        exact=False, judge=f32_judge, iters=10, bytes_moved=nbytes,
        flops=flops)


def _serve_engine(params, cfg, workload, injector=None, **policy):
    """A ``ServingEngine`` on the card with the serving CLI's stream
    (``launch.serve.stream_workload``) submitted, its own
    ``PlacementSession`` and the fault ``injector`` if given."""
    import torch

    from repro_torch.launch.placement import PlacementSession
    from repro_torch.launch.serve import stream_workload
    from repro_torch.serving import EngineConfig, ServingEngine
    dev = torch.device("cuda")
    prompts, gens, max_pages, n_pages = stream_workload(cfg.vocab,
                                                        **workload)
    ecfg = EngineConfig(
        n_slots=workload["slots"], page_size=workload["page_size"],
        n_pages=n_pages, max_pages_per_req=max_pages, seed=workload["seed"],
        **policy)
    eng = ServingEngine(params, cfg, ecfg, device=dev,
                        session=PlacementSession(device=dev),
                        injector=injector)
    for p, g in zip(prompts, gens):
        eng.submit(p, g)
    return eng, sum(gens)


def _serve_line(eng, report, n_tokens):
    """The serve steps' line: the report without its per-request lists,
    wall ms per engine step, ``map_pages`` calls and seconds, the pool."""
    import numpy as np
    steps = np.asarray(eng.step_s) * 1e3
    rep = {k: v for k, v in report.__dict__.items()
           if k not in ("requests", "placements")}
    return dict(report=rep, placements=report.placements,
                step_ms_p50=float(np.percentile(steps, 50)),
                step_ms_p99=float(np.percentile(steps, 99)),
                step_ms_mean=float(steps.mean()),
                map_pages_calls=eng.session.n_map_pages,
                map_pages_s=eng.session.map_pages_s,
                n_pages=eng.ecfg.n_pages, n_slots=eng.ecfg.n_slots,
                kv_pool_bytes=2 * eng.cache.k_pool.numel()
                * eng.cache.k_pool.element_size(),
                completed=report.n_requests, tokens_expected=n_tokens)


def _tokens_of(report):
    return {r["rid"]: r["generated"] for r in report.requests}


def phase_lm(state):
    """qwen2-1.5b at full width on the card: prefill (counted, traced),
    the 32k prefill, the CLI's stream and a wide stream through the
    serving engine, then the checks (a)-(f)."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, quotient_link_loads
    from repro_torch.models import transformer as tr
    from repro_torch.models.common import flash_attention as plain
    from repro_torch.serving.paged_decode import paged_decode_step
    dev = torch.device("cuda")
    cfg = configs.get(LM_ARCH).make_config("decode_32k")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    t0 = time.perf_counter()
    params = tr.init(cfg, gen, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, LM_PREFILL), device=dev)
    flash_events = {"flash_fwd_": ("flash_attention",)}

    def prefill(t=toks):
        return tr.prefill(params, t, cfg)

    # -- prefill: the counted run
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    logits, cold = _wall(prefill)
    del logits
    logits, warm = _wall(prefill, reps=2)
    trace = _traced(prefill, flash_events)
    counts = ops.launch_counts()
    state["launches"]["lm"] = counts
    forwards = 3 + trace["runs"]
    n_tok = LM_PREFILL[0] * LM_PREFILL[1]
    checks, errors = {}, {}
    checks["prefill_logits_finite_and_shaped"] = bool(
        torch.isfinite(logits).all()) and tuple(logits.shape) == (
            *LM_PREFILL, cfg.vocab)
    checks["prefill_28_flash_launches_per_forward"] = (
        counts["flash_attention"] == cfg.n_layers * forwards
        and trace["port_launches"]["flash_fwd_"]["traced"]
        == cfg.n_layers)
    emit("lm", step="prefill", arch=LM_ARCH, params=cfg.n_params(),
         param_bytes=sum(t.numel() * t.element_size() for t in
                         _leaves(params)),
         init_s=init_s, batch=LM_PREFILL[0], seq=LM_PREFILL[1],
         cold_ms=cold, warm_ms=warm, tokens_per_s=n_tok / (warm / 1e3),
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         forwards=forwards, launches=counts,
         flash_per_forward=counts["flash_attention"] / forwards,
         traced=trace)
    del logits

    # -- the grid's prefill_32k sequence, batch cut to 1
    long_toks = torch.as_tensor(rng.integers(0, cfg.vocab, LM_LONG),
                                device=dev)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    logits, long_cold = _wall(lambda: prefill(long_toks))
    del logits
    logits, long_warm = _wall(lambda: prefill(long_toks))
    long_counts = ops.launch_counts()
    checks["prefill_long_logits_finite_and_shaped"] = bool(
        torch.isfinite(logits).all()) and tuple(logits.shape) == (
            *LM_LONG, cfg.vocab)
    checks["prefill_long_28_flash_launches_per_forward"] = (
        long_counts["flash_attention"] == 2 * cfg.n_layers)
    emit("lm", step="prefill_long", batch=LM_LONG[0], seq=LM_LONG[1],
         reduced="batch 32 -> 1: 32 sequences' logits would be 318 GB",
         cold_ms=long_cold, warm_ms=long_warm,
         tokens_per_s=LM_LONG[0] * LM_LONG[1] / (long_warm / 1e3),
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         launches=long_counts)
    del logits, long_toks
    torch.cuda.empty_cache()

    # -- serve: the CLI's default stream (counted); a traced stretch of
    # steps comes from the greedy run of check (f) below
    policy = dict(temperature=LM_TEMPERATURE, **LM_SERVE_POLICY)
    ops.reset_launch_counts()
    eng, n_gen = _serve_engine(params, cfg, LM_SERVE, **policy)
    report = eng.run()
    serve_counts = ops.launch_counts()
    serve_qll = dict(quotient_link_loads.launch_shapes)
    state["launches"]["serve"] = serve_counts
    serve_line = _serve_line(eng, report, n_gen)
    tokens = {f"placed_{LM_TEMPERATURE}": _tokens_of(report)}
    checks["serve_every_request_completed"] = (
        report.n_requests == LM_SERVE["num_requests"]
        and report.tokens_out == n_gen)
    traced_eng, _ = _serve_engine(params, cfg, LM_SERVE,
                                  **dict(policy, temperature=0.0))
    for _ in range(18):          # past the first placement epoch (step 16)
        traced_eng.step()
    serve_trace = _traced(lambda: [traced_eng.step() for _ in range(4)],
                          flash_events)
    tokens["placed_0.0"] = _tokens_of(traced_eng.run())
    emit("lm", step="serve", workload=LM_SERVE, policy=policy,
         launches=serve_counts, traced_steps=4, traced_temperature=0.0,
         traced=serve_trace,
         quotient_link_loads_by_shape=qll_by_shape(state, serve_qll),
         **serve_line)
    serve_chaos(state, params, cfg, tokens)

    # -- serve_wide: a deployment's pool
    wide_policy = dict(temperature=LM_TEMPERATURE, **LM_WIDE_POLICY)
    ops.reset_launch_counts()
    eng, n_gen = _serve_engine(params, cfg, LM_WIDE, **wide_policy)
    wide = eng.run()
    state["launches"]["serve_wide"] = ops.launch_counts()
    wide_qll = dict(quotient_link_loads.launch_shapes)
    emit("lm", step="serve_wide", workload=LM_WIDE, policy=wide_policy,
         launches=state["launches"]["serve_wide"],
         quotient_link_loads_by_shape=qll_by_shape(state, wide_qll),
         **_serve_line(eng, wide, n_gen))
    checks["serve_wide_every_request_completed"] = (
        wide.n_requests == LM_WIDE["num_requests"]
        and wide.tokens_out == n_gen)
    del eng
    torch.cuda.empty_cache()

    # -- checks, outside the counted runs
    # (a) the kernel against its plain version on layers 0 and 27's inputs
    seen, calls = {}, []

    def record(q, k, v, **kw):
        if len(calls) in (0, cfg.n_layers - 1):
            seen[len(calls)] = (q, k, v)
        calls.append(1)
        return ops.flash_attention(q, k, v, **kw)
    out = tr.forward_with(params, toks, cfg, record)
    del out
    ok_a = len(seen) == 2
    for li, (q, k, v) in sorted(seen.items()):
        passed, _, readings = flash_bf16_judge(
            q, k, v, fa.flash_attention(q, k, v, causal=True),
            plain(q, k, v, causal=True, q_chunk=cfg.q_chunk,
                  kv_chunk=cfg.kv_chunk), cfg.q_chunk, cfg.kv_chunk)
        errors[f"a_flash_vs_f32_layer_{li}"] = readings
        ok_a &= passed
    checks["a_flash_vs_plain_on_the_path_inputs"] = ok_a
    del seen
    # (b) float32 at the reference's CASES, and two calls bitwise equal
    ok_b = True
    for case in FLASH_CASES:
        b, sq, sk, h, kh, d, causal = case
        q, k, v = (torch.randn(shape, generator=gen, device=dev) for shape in
                   ((b, sq, h, d), (b, sk, kh, d), (b, sk, kh, d)))
        got = fa.flash_attention(q, k, v, causal=causal)
        want = plain(q, k, v, causal=causal, q_chunk=64, kv_chunk=64)
        err = (got - want).abs()
        ok_b &= bool((err <= FLASH_F32_TOL + FLASH_F32_TOL
                      * want.abs()).all())
        ok_b &= torch.equal(got, fa.flash_attention(q, k, v, causal=causal))
        errors[f"b_f32_{'x'.join(map(str, case[:6]))}"] = float(err.max())
    checks["b_flash_f32_cases_and_bitwise_repeat"] = ok_b
    # (c) prefill through the kernel against prefill through the plain
    # version, greedy next tokens: in bf16 at the positions whose top two
    # logits are more than LM_BF16_TIE_ULPS ulps apart, in float32 (the
    # weights cast) at every position. Two chunkings of the plain version
    # are read beside them.
    def plain_wide(q, k, v, **kw):
        return plain(q, k, v, causal=True, q_chunk=2 * cfg.q_chunk,
                     kv_chunk=2 * cfg.kv_chunk)
    with_kernel = prefill()
    with_plain = tr.forward_with(params, toks, cfg, plain)[0]
    other_plain = tr.forward_with(params, toks, cfg, plain_wide)[0]
    keep = _decisive(with_plain, LM_BF16_TIE_ULPS)
    agree, dmax = _greedy_agreement(with_kernel, with_plain, keep)
    errors.update(c_bf16_decisive_agreement=agree,
                  c_bf16_decisive_share=float(keep.float().mean()),
                  c_bf16_max_abs_dlogit=dmax,
                  c_bf16_all_positions_agreement=_greedy_agreement(
                      with_kernel, with_plain)[0],
                  c_max_abs_logit=float(with_plain.abs().max()))
    for ulps in (1, 2, 4, 8, 16):
        kp = _decisive(with_plain, ulps)
        errors[f"c_bf16_beyond_{ulps}_ulps"] = dict(
            share=float(kp.float().mean()),
            kernel_vs_plain=_greedy_agreement(with_kernel, with_plain, kp)[0],
            plain_chunkings=_greedy_agreement(other_plain, with_plain, kp)[0])
    errors["c_bf16_plain_chunkings_max_abs_dlogit"] = _greedy_agreement(
        other_plain, with_plain)[1]
    del with_kernel, with_plain, other_plain, keep
    checks["c_bf16_kernel_vs_plain_greedy_agree_where_decisive"] = (
        agree >= LM_GREEDY_AGREE)
    params32 = _cast(params, torch.float32)
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    agree, dmax = _greedy_agreement(tr.prefill(params32, toks, cfg32),
                            tr.forward_with(params32, toks, cfg32, plain)[0])
    del params32
    errors.update(c_f32_greedy_agreement=agree, c_f32_max_abs_dlogit=dmax)
    checks["c_f32_kernel_vs_plain_greedy_agree"] = agree >= LM_GREEDY_AGREE
    torch.cuda.empty_cache()
    # (d) prefill against decode_step over the dense cache, 64 tokens; two
    # planted faults must fail the same band: a decode whose cache is
    # zeroed before every step, and one that steps every token one
    # position on, so a zero key stays in its softmax
    toks64 = torch.as_tensor(rng.integers(0, cfg.vocab, (1, 64)), device=dev)
    full = prefill(toks64)[0].float()

    def stepped(fresh=False, shift=0):
        cache = tr.init_cache(cfg, 1, 64 + shift, device=dev)
        out = []
        for pos in range(64):
            if fresh:
                cache = tr.init_cache(cfg, 1, 64, device=dev)
            lg, cache = tr.decode_step(params, cache, toks64[:, pos:pos + 1],
                                       pos + shift, cfg)
            out.append(lg[0].float())
        return torch.stack(out)
    scale = float(full.abs().max())
    dec = stepped()
    errors["d_max_abs_dlogit"] = float((dec - full).abs().max())
    errors["d_max_abs_logit"] = scale
    errors["d_greedy_agreement"] = float(
        (dec.argmax(-1) == full.argmax(-1)).float().mean())
    errors["d_planted_share"] = {
        name: float((stepped(**kw) - full).abs().max()) / scale
        for name, kw in (("cache_zeroed", dict(fresh=True)),
                         ("one_position_on", dict(shift=1)))}
    checks["d_prefill_vs_stepped_decode"] = (
        errors["d_max_abs_dlogit"] <= LM_STEP_BAND * scale)
    checks["d_band_rejects_the_planted_faults"] = all(
        share > LM_STEP_BAND for share in errors["d_planted_share"].values())
    # (e) paged against dense decode, one batch of 4 slots for 16 steps
    b, t, page, n_pages = 4, 16, 8, 12
    seqs = torch.as_tensor(rng.integers(0, cfg.vocab, (b, t)), device=dev)
    dense = tr.init_cache(cfg, b, t, device=dev)
    pools = [torch.zeros(cfg.n_layers, n_pages + 1, page, cfg.n_kv_heads,
                         cfg.head_dim, dtype=cfg.dtype, device=dev)
             for _ in range(2)]
    table = torch.tensor([[7, 2], [0, 9], [3, 11], [5, 1]], device=dev)
    worst, ok_e = 0.0, True
    for pos in range(t):
        lg_d, dense = tr.decode_step(params, dense, seqs[:, pos:pos + 1], pos,
                                     cfg)
        lg_p = paged_decode_step(params, *pools, table,
                                 torch.full((b,), pos, device=dev),
                                 seqs[:, pos:pos + 1], cfg)
        err = (lg_p.float() - lg_d.float()).abs()
        ok_e &= bool((err <= LM_PAGED_RTOL
                      * (1.0 + lg_d.float().abs())).all())
        worst = max(worst, float(err.max()))
    errors["e_paged_vs_dense"] = worst
    checks["e_paged_equals_dense_decode"] = ok_e
    # (f) placement does not change an answer, greedy and at 0.8
    for temp in (0.0, LM_TEMPERATURE):
        for placed in (True, False):
            key = f"{'placed' if placed else 'unplaced'}_{temp}"
            if key in tokens:
                continue
            pol = dict(LM_SERVE_POLICY, temperature=temp)
            if not placed:
                pol["replace_every"] = 0
            tokens[key] = _tokens_of(_serve_engine(params, cfg, LM_SERVE,
                                                   **pol)[0].run())
    checks["f_placement_keeps_tokens_greedy"] = (
        tokens["placed_0.0"] == tokens["unplaced_0.0"])
    checks["f_placement_keeps_tokens_at_0.8"] = (
        tokens["placed_0.8"] == tokens["unplaced_0.8"])
    emit("lm", step="checks", tolerances=dict(
        a=f"max and rms error against the float32 plain version <= "
          f"{FLASH_BF16_RATIO}x the bf16 plain version's; planted faults "
          f"rejected",
        b=f"rtol = atol = {FLASH_F32_TOL} (float32), bitwise repeat",
        c=f"greedy agreement >= {LM_GREEDY_AGREE}: in bf16 where the top "
          f"two logits are > {LM_BF16_TIE_ULPS} ulps apart, in float32 "
          f"everywhere",
        d=f"|d| <= {LM_STEP_BAND} * max|logit|",
        e=f"|d| <= {LM_PAGED_RTOL} * (1 + |logit|)",
        f="identical tokens"), max_abs_err=errors, **checks)
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"lm checks failed: {failed}")
    _require_launched(counts, "lm")


def _chaos_engine(params, cfg, temperature, plan):
    """The lm serve stream's engine with ``plan`` injected, and a record
    of each ``handle_leaf_death`` call: the requeued requests' prompt
    lengths and generated counts read just before the call, the page
    traffic left after it (what the forced re-placement places) and the
    launch counts at that point."""
    from repro_torch.kernels import ops
    from repro_torch.resilience import FaultInjector, parse_fault_plan
    eng, n_gen = _serve_engine(
        params, cfg, LM_SERVE,
        injector=FaultInjector(parse_fault_plan(plan)),
        **dict(LM_SERVE_POLICY, temperature=temperature))
    deaths = []
    handle = eng.scheduler.handle_leaf_death

    def recorded(dead_pages, step, **kw):
        before = {r.rid: (r.prompt_len, len(r.generated))
                  for r in eng.scheduler.active.values()}
        res = handle(dead_pages, step, **kw)
        deaths.append(dict(step=step, pages=len(dead_pages),
                           requeued={r.rid: before[r.rid]
                                     for r in res["requeued"]},
                           traffic=float(eng.cache.page_traffic().sum()),
                           counts_before=ops.launch_counts()))
        return res
    eng.scheduler.handle_leaf_death = recorded
    return eng, n_gen, deaths


def serve_chaos(state, params, cfg, clean_tokens):
    """The lm serve stream with CHAOS_PLAN (a leaf death at step 6) on the
    same weights, at LM_TEMPERATURE (counted) and greedy (one step traced
    after the recovery), then with CHAOS_PLAN_PLACED at LM_TEMPERATURE:
    every request completes, the tokens equal the clean runs', the
    recovery record (re-placed exactly where page co-access was left to
    place, and at step 12 it must be), the retired pages zeroed on the
    card, the re-prefilled tokens, and the partition kernels launched
    after the death, by the forced re-placement itself at step 12."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    t0 = time.perf_counter()
    checks, out = {}, {}
    for plan, temp in ((CHAOS_PLAN, LM_TEMPERATURE), (CHAOS_PLAN, 0.0),
                       (CHAOS_PLAN_PLACED, LM_TEMPERATURE)):
        ops.reset_launch_counts()
        eng, n_gen, deaths = _chaos_engine(params, cfg, temp, plan)
        trace, at_death = None, {}
        death_step = int(plan.split(":")[0])
        while eng._step <= death_step:
            eng.step()
        if deaths:
            now = ops.launch_counts()
            at_death = {k: now[k] - deaths[0]["counts_before"][k]
                        for k in now}
        if temp == 0.0:
            trace = _traced(eng.step, {"flash_fwd_": ("flash_attention",)})
        report = eng.run()
        counts = ops.launch_counts()
        if (plan, temp) == (CHAOS_PLAN, LM_TEMPERATURE):
            state["launches"]["serve_chaos"] = counts
        key = f"{plan}@{temp}"
        rec = report.recoveries[0] if report.recoveries else {}
        dead = eng.cache.allocator.dead_pages()
        rows = torch.as_tensor(dead, device=eng.cache.k_pool.device)
        zeroed = bool(dead.size) and all(
            not bool(pool.index_select(1, rows).any())
            for pool in (eng.cache.k_pool, eng.cache.v_pool))
        want_reprefill = sum(p + g for d in deaths
                             for p, g in d["requeued"].values())
        after = ({k: counts[k] - deaths[0]["counts_before"][k]
                  for k in counts} if deaths else {})
        placeable = bool(deaths) and deaths[0]["traffic"] > 0
        checks[f"{key}_every_request_completed_none_failed"] = (
            report.n_requests == LM_SERVE["num_requests"]
            and report.requests_failed == 0
            and report.tokens_out == n_gen)
        checks[f"{key}_tokens_equal_the_clean_run"] = (
            _tokens_of(report) == clean_tokens[f"placed_{temp}"])
        checks[f"{key}_recovery_device_1_alive_3"] = (
            len(deaths) == 1 and rec.get("device") == 1
            and rec.get("n_alive") == 3)
        checks[f"{key}_replaced_where_traffic_was_left"] = (
            rec.get("replaced") is placeable)
        checks[f"{key}_retired_pages_zero_on_the_card"] = zeroed
        checks[f"{key}_tokens_reprefilled"] = (
            report.tokens_reprefilled == want_reprefill)
        checks[f"{key}_partition_kernels_launch_after_the_death"] = (
            after.get("quotient_link_loads", 0) > 0
            and after.get("partition_gain", 0) > 0)
        if plan == CHAOS_PLAN_PLACED:
            checks[f"{key}_forced_replacement_ran_the_kernels"] = (
                placeable and rec.get("replaced") is True
                and at_death.get("quotient_link_loads", 0) > 0
                and at_death.get("partition_gain", 0) > 0)
        steps = np.asarray(eng.step_s) * 1e3
        out[key] = dict(
            report={k: v for k, v in report.__dict__.items()
                    if k not in ("requests", "placements")},
            placements=report.placements, recovery=rec,
            retired_pages=int(dead.size),
            traffic_left_at_the_death=deaths[0]["traffic"] if deaths
            else None,
            requeued={str(k): v for d in deaths
                      for k, v in d["requeued"].items()},
            tokens_reprefilled_expected=want_reprefill,
            launches=counts, launches_after_the_death=after,
            launches_in_the_death_step=at_death,
            step_ms_p50=float(np.percentile(steps, 50)),
            step_ms_p99=float(np.percentile(steps, 99)),
            step_ms_max=float(steps.max()),
            recovery_s=rec.get("recovery_s"), traced=trace)
    emit("serve_chaos", plans=[CHAOS_PLAN, CHAOS_PLAN_PLACED],
         workload=LM_SERVE, policy=LM_SERVE_POLICY, runs=out,
         seconds=time.perf_counter() - t0, nvidia_smi=state["smi"],
         **checks)
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"serve_chaos checks failed: {failed}")
    _require_launched(state["launches"]["serve_chaos"], "serve_chaos")


def materialised_mla_decode(p, x, c_cache, kr_cache, pos, cfg, tables,
                            mask):
    """MLA decode attention that materialises per-head k_nope and v from
    the cached c_kv instead of absorbing ``w_uk`` / ``w_uv``: the same
    function as ``transformer._decode_attn_mla`` in another order, with
    its arguments (a second correct decode for check (d)'s band)."""
    import numpy as np
    import torch

    from repro_torch.models import transformer as tr
    from repro_torch.models.common import rms_norm, rotate
    b = x.shape[0]
    h = cfg.n_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    f32 = torch.float32
    q = tr._mla_q(p, x, cfg).reshape(b, h, dn + dr)
    q_rope = rotate(q[:, None, :, dn:], *tables)[:, 0]
    c_cache[:, pos] = rms_norm(x @ p["w_dkv"], p["kv_norm"])[:, 0]
    kr_cache[:, pos] = rotate((x @ p["w_kr"])[:, :, None, :],
                              *tables)[:, 0, 0]
    k_nope = (c_cache @ p["w_uk"]).reshape(b, -1, h, dn)
    v = (c_cache @ p["w_uv"]).reshape(b, -1, h, dv)
    s = (torch.einsum("bhn,bshn->bhs", q[..., :dn].to(f32), k_nope.to(f32))
         + torch.einsum("bhd,bsd->bhs", q_rope.to(f32), kr_cache.to(f32))
         ) / float(np.sqrt(dn + dr))
    s = torch.where(mask[None, None, :], s, -torch.inf)
    o = torch.einsum("bhs,bshv->bhv", torch.softmax(s, -1), v.to(f32))
    return o.to(x.dtype).reshape(b, 1, h * dv) @ p["w_o"]


def _greedy_agreement(a, b, keep=None):
    """(share of positions whose argmax agrees, where ``keep``; the
    largest |a - b|)."""
    same = a.argmax(-1) == b.argmax(-1)
    return (float(same[keep].float().mean() if keep is not None
                  else same.float().mean()),
            max(float((a[i].float() - b[i].float()).abs().max())
                for i in range(a.shape[0])))


def _decisive(logits, ulps):
    """Positions whose top two logits are more than ``ulps`` bf16 ulps of
    the top logit apart."""
    import torch
    top = torch.topk(logits.float(), 2, dim=-1).values
    ulp = torch.exp2(torch.floor(torch.log2(top[..., 0].abs())) - 7)
    return (top[..., 0] - top[..., 1]) > ulps * ulp


def _kernel_vs_plain(params, toks, cfg, errors, prefix):
    """Check (c): greedy next tokens of prefill through the kernel against
    prefill through the plain attention, at the positions the plain
    logits decide by more than LM_BF16_TIE_ULPS ulps; two chunkings of
    the plain version read beside them. Returns (ok, agreement): ok when
    the kernel's disagreement is at most the larger of 1 -
    LM_GREEDY_AGREE and FLASH_BF16_RATIO times the two plain chunkings'
    (two correct paths; a MoE model's routing turns rounding differences
    into other experts, PERF.md section 2)."""
    from repro_torch.models import transformer as tr
    from repro_torch.models.common import flash_attention as plain

    def plain_wide(q, k, v, **kw):
        return plain(q, k, v, causal=True, q_chunk=2 * cfg.q_chunk,
                     kv_chunk=2 * cfg.kv_chunk)
    with_kernel = tr.prefill(params, toks, cfg)
    with_plain = tr.forward_with(params, toks, cfg, plain)[0]
    other_plain = tr.forward_with(params, toks, cfg, plain_wide)[0]
    keep = _decisive(with_plain, LM_BF16_TIE_ULPS)
    agree, dmax = _greedy_agreement(with_kernel, with_plain, keep)
    errors.update({
        f"{prefix}_bf16_decisive_agreement": agree,
        f"{prefix}_bf16_decisive_share": float(keep.float().mean()),
        f"{prefix}_bf16_max_abs_dlogit": dmax,
        f"{prefix}_bf16_all_positions_agreement": _greedy_agreement(
            with_kernel, with_plain)[0],
        f"{prefix}_plain_chunkings_decisive_agreement": _greedy_agreement(
            other_plain, with_plain, keep)[0],
        f"{prefix}_plain_chunkings_max_abs_dlogit": _greedy_agreement(
            other_plain, with_plain)[1],
        f"{prefix}_max_abs_logit": float(with_plain.abs().max())})
    spread = 1.0 - errors[f"{prefix}_plain_chunkings_decisive_agreement"]
    allowed = max(1.0 - LM_GREEDY_AGREE, FLASH_BF16_RATIO * spread)
    errors[f"{prefix}_allowed_disagreement"] = allowed
    return 1.0 - agree <= allowed, agree


def phase_lm_mla(state):
    """deepseek-v2-lite-16b at full width and depth on the card: prefill
    4 x 4,096 (counted, traced, each MoE layer's drop share and the aux
    loss), then checks: (a) the kernel on layers 0 and 26's own q, k, v;
    (c) kernel vs plain prefill, greedy, in bf16 and with float32
    weights; (d) prefill vs the absorbed decode without drops; (e) MoE
    dispatch on the card vs the CPU; (f) the one-shot CLI path twice,
    and one traced decode step; (g) check (c) on a 2-layer cut of
    deepseek-v2-236b. The kernels phase holds the kernel at the
    reference's MLA-like float32 case."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import oneshot
    from repro_torch.models import transformer as tr
    from repro_torch.models.common import flash_attention as plain
    dev = torch.device("cuda")
    cfg = configs.get(MLA_ARCH).make_config("decode_32k")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    t0 = time.perf_counter()
    params = tr.init(cfg, gen, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, LM_PREFILL), device=dev)
    n_tok = LM_PREFILL[0] * LM_PREFILL[1]

    def prefill(t=toks):
        return tr.prefill(params, t, cfg)

    # -- prefill: the counted run
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    logits, cold = _wall(prefill)
    del logits
    logits, warm = _wall(prefill, reps=2)
    del logits
    trace = _traced(prefill, {"flash_fwd_": ("flash_attention",)})
    counts = ops.launch_counts()
    state["launches"]["lm_mla"] = counts
    forwards = state["lm_mla_forwards"] = 3 + trace["runs"]
    peak = torch.cuda.max_memory_allocated()

    # one more prefill, recording each MoE layer's stats and the first MoE
    # layer's input (for check (e))
    moe_inputs, moe_stats = [], []
    inner = tr.moe_ffn

    def recording_moe(p, x, c, *rules):
        y, st = inner(p, x, c, *rules)
        if not moe_inputs:
            moe_inputs.append((p, x))
        moe_stats.append(st)
        return y, st
    tr.moe_ffn = recording_moe
    try:
        logits, aux = tr.forward(params, toks, cfg)
    finally:
        tr.moe_ffn = inner
    checks, errors = {}, {}
    checks["prefill_logits_finite_and_shaped"] = bool(
        torch.isfinite(logits).all()) and tuple(logits.shape) == (
            *LM_PREFILL, cfg.vocab)
    del logits
    dropped = [float(st.dropped_frac) for st in moe_stats]
    checks["prefill_27_flash_launches_per_forward"] = (
        counts["flash_attention"] == cfg.n_layers * forwards
        and trace["port_launches"]["flash_fwd_"]["traced"] == cfg.n_layers)
    checks["aux_loss_finite_and_summed"] = bool(torch.isfinite(aux)) and abs(
        float(aux) - sum(float(st.aux_loss) for st in moe_stats)) <= 1e-6 * (
            abs(float(aux)) + 1e-30)
    emit("lm_mla", step="prefill", arch=MLA_ARCH, params=cfg.n_params(),
         active_params=cfg.n_active_params(),
         param_bytes=sum(t.numel() * t.element_size() for t in
                         _leaves(params)),
         init_s=init_s, batch=LM_PREFILL[0], seq=LM_PREFILL[1],
         capacity_factor=cfg.capacity_factor,
         capacity=tr.capacity(cfg, n_tok), cold_ms=cold, warm_ms=warm,
         tokens_per_s=n_tok / (warm / 1e3), max_memory_allocated=peak,
         forwards=forwards, launches=counts,
         flash_per_forward=counts["flash_attention"] / forwards,
         dropped_frac_by_moe_layer=dropped, aux_loss=float(aux),
         traced=trace)
    del moe_stats

    # (a) the kernel against its plain version on layers 0 and 26's inputs
    seen, calls = {}, []

    def record(q, k, v, **kw):
        if len(calls) in (0, cfg.n_layers - 1):
            seen[len(calls)] = (q, k, v)
        calls.append(1)
        return ops.flash_attention(q, k, v, **kw)
    tr.forward_with(params, toks, cfg, record)
    ok_a = len(seen) == 2
    for li, (q, k, v) in sorted(seen.items()):
        ok_a &= tuple(q.shape) == (*LM_PREFILL, cfg.n_heads,
                                   cfg.qk_head_dim) and tuple(v.shape) == (
            *LM_PREFILL, cfg.n_heads, cfg.v_head_dim)
        passed, _, readings = flash_bf16_judge(
            q, k, v, fa.flash_attention(q, k, v, causal=True),
            plain(q, k, v, causal=True, q_chunk=cfg.q_chunk,
                  kv_chunk=cfg.kv_chunk), cfg.q_chunk, cfg.kv_chunk)
        errors[f"a_flash_vs_f32_layer_{li}"] = readings
        ok_a &= passed
    checks["a_flash_vs_plain_on_the_path_inputs"] = ok_a
    del seen
    # (c) prefill through the kernel against the plain attention, greedy
    checks["c_bf16_kernel_vs_plain_greedy_agree_where_decisive"] = (
        _kernel_vs_plain(params, toks, cfg, errors, "c")[0])
    torch.cuda.empty_cache()
    # (d) prefill against the absorbed decode over a 64-token prompt, at a
    # capacity that drops nothing; a materialising decode reads the band's
    # second correct path; two planted faults must fail the band
    nodrop = dataclasses.replace(cfg, capacity_factor=cfg.n_experts
                                 / cfg.top_k)
    toks64 = torch.as_tensor(rng.integers(0, cfg.vocab, (1, 64)), device=dev)
    drops = []

    def counting_moe(p, x, c, *rules):
        y, st = inner(p, x, c, *rules)
        drops.append(st.dropped_frac)
        return y, st
    tr.moe_ffn = counting_moe
    try:
        full = tr.prefill(params, toks64, nodrop)[0].float()

        def stepped(fresh=False, shift=0):
            cache = tr.init_cache(nodrop, 1, 64 + shift, device=dev)
            out = []
            for pos in range(64):
                if fresh:
                    cache = tr.init_cache(nodrop, 1, 64, device=dev)
                lg, cache = tr.decode_step(params, cache,
                                           toks64[:, pos:pos + 1],
                                           pos + shift, nodrop)
                out.append(lg[0].float())
            return torch.stack(out)
        dec = stepped()
        absorbed = tr._decode_attn_mla
        tr._decode_attn_mla = materialised_mla_decode
        try:
            mat = stepped()
        finally:
            tr._decode_attn_mla = absorbed
        no_drops = not any(bool(x) for x in drops)
        planted = {name: stepped(**kw) for name, kw in (
            ("cache_zeroed", dict(fresh=True)),
            ("one_position_on", dict(shift=1)))}
    finally:
        tr.moe_ffn = inner
    scale = float(full.abs().max())
    d_abs = float((dec - full).abs().max()) / scale
    d_mat = float((mat - full).abs().max()) / scale
    band = max(LM_STEP_BAND, MLA_STEP_SPREAD * d_mat)
    errors.update(
        d_max_abs_logit=scale, d_absorbed_share=d_abs,
        d_materialised_share=d_mat,
        d_absorbed_vs_materialised_share=float(
            (dec - mat).abs().max()) / scale,
        d_band_share=band, d_band_from_spread=band > LM_STEP_BAND,
        d_greedy_agreement=float(
            (dec.argmax(-1) == full.argmax(-1)).float().mean()),
        d_moe_calls=len(drops),
        d_planted_share={name: float((x - full).abs().max()) / scale
                         for name, x in planted.items()})
    checks["d_no_pair_dropped_at_capacity_e_over_k"] = no_drops
    checks["d_prefill_vs_absorbed_decode"] = d_abs <= band
    checks["d_band_rejects_the_planted_faults"] = all(
        share > band for share in errors["d_planted_share"].values())
    del full, dec, mat, planted
    # (e) MoE dispatch on the card against the CPU on the same expert ids;
    # moe_ffn twice on the card bitwise
    p1, x1 = moe_inputs[0]
    _, _, top_i = tr.route(p1, x1, cfg)
    cap = tr.capacity(cfg, x1.shape[0])
    on_card = tr.dispatch(top_i, cfg.n_experts, cap)
    on_cpu = tr.dispatch(top_i.cpu(), cfg.n_experts, cap)
    names = ("order", "sorted_e", "starts", "pos", "valid", "slot")
    same = {n: torch.equal(a.cpu(), c) for n, a, c in zip(names, on_card,
                                                          on_cpu)}
    y1, st1 = tr.moe_ffn(p1, x1, cfg)
    y2, st2 = tr.moe_ffn(p1, x1, cfg)
    errors["e_dispatch_equal"] = same
    errors["e_dropped_frac_layer_1"] = float(st1.dropped_frac)
    checks["e_dispatch_card_equals_cpu"] = all(same.values())
    checks["e_moe_ffn_bitwise_repeat"] = torch.equal(y1, y2) and (
        torch.equal(st1.aux_loss, st2.aux_loss))
    del moe_inputs, p1, x1, y1, y2
    # (f) the one-shot CLI path, twice with the same seed
    ops.reset_launch_counts()
    runs = [oneshot(params, cfg, dev, **MLA_ONESHOT) for _ in range(2)]
    steps = runs[0][2]
    checks["f_oneshot_same_seed_same_tokens"] = bool(
        np.array_equal(runs[0][0], runs[1][0])) and runs[0][0].shape == (
            MLA_ONESHOT["batch"], MLA_ONESHOT["gen_len"])
    emit("lm_mla", step="oneshot", workload=MLA_ONESHOT, steps=steps,
         seconds=[r[1] for r in runs],
         ms_per_step=[r[1] / steps * 1e3 for r in runs],
         tokens_per_s=[MLA_ONESHOT["batch"] * MLA_ONESHOT["gen_len"] / r[1]
                       for r in runs],
         weight_bytes_read_per_step=sum(
             t.numel() * t.element_size() for t in _leaves(params))
         - params["embed"].numel() * params["embed"].element_size(),
         launches=ops.launch_counts(), sample=runs[0][0][0][:16].tolist())
    # one decode step, traced: where a step's time goes
    cache = tr.init_cache(cfg, MLA_ONESHOT["batch"], 48, device=dev)
    step_trace = _traced(lambda: tr.decode_step(
        params, cache, toks[:MLA_ONESHOT["batch"], :1], 0, cfg), {})
    emit("lm_mla", step="oneshot_traced_step", traced=step_trace)
    del params, runs, cache
    torch.cuda.empty_cache()
    # (c, float32) the same comparison with float32 weights (62.8 GB, so
    # on MLA_F32_PREFILL tokens; the SIMT kernel at D = 192, Dv = 128):
    # rounding no longer moves the routing, so the 99% gate holds at every
    # position
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    gen.manual_seed(0)
    params = tr.init(cfg32, gen, device=dev)
    toks32 = torch.as_tensor(rng.integers(0, cfg.vocab, MLA_F32_PREFILL),
                             device=dev)
    ops.reset_launch_counts()
    agree, dmax = _greedy_agreement(
        tr.prefill(params, toks32, cfg32),
        tr.forward_with(params, toks32, cfg32, plain)[0])
    errors.update(c_f32_greedy_agreement=agree, c_f32_max_abs_dlogit=dmax,
                  c_f32_flash_launches=ops.launch_counts()[
                      "flash_attention"])
    checks["c_f32_kernel_vs_plain_greedy_agree"] = (
        agree >= LM_GREEDY_AGREE
        and errors["c_f32_flash_launches"] == cfg.n_layers)
    del params
    torch.cuda.empty_cache()
    # (g) check (c) on a 2-layer cut of deepseek-v2-236b: the q_lora branch
    # and 128 heads at D = 192
    big = dataclasses.replace(configs.get("deepseek-v2-236b").make_config(
        "decode_32k"), n_layers=MLA_236B_LAYERS)
    gen.manual_seed(0)
    params = tr.init(big, gen, device=dev)
    toks_b = torch.as_tensor(rng.integers(0, big.vocab, MLA_236B_PREFILL),
                             device=dev)
    ops.reset_launch_counts()
    ok_g = _kernel_vs_plain(params, toks_b, big, errors, "g_236b")[0]
    g_counts = ops.launch_counts()
    checks["g_236b_cut_kernel_vs_plain_greedy_agree_where_decisive"] = (
        ok_g and g_counts["flash_attention"] == MLA_236B_LAYERS)
    errors["g_236b_param_bytes"] = sum(t.numel() * t.element_size()
                                       for t in _leaves(params))
    del params
    torch.cuda.empty_cache()
    emit("lm_mla", step="checks", tolerances=dict(
        a=f"max and rms error against the float32 plain version, the rms "
          f"also per 128-row tile, <= {FLASH_BF16_RATIO}x the bf16 plain "
          f"version's; planted faults rejected",
        c=f"bf16: greedy disagreement where the plain top two logits are > "
          f"{LM_BF16_TIE_ULPS} ulps apart <= max({1 - LM_GREEDY_AGREE:.2f}, "
          f"{FLASH_BF16_RATIO} x two plain chunkings'); float32 weights on "
          f"{MLA_F32_PREFILL}: agreement >= {LM_GREEDY_AGREE} everywhere",
        d=f"|d| <= max({LM_STEP_BAND}, {MLA_STEP_SPREAD} x the "
          f"materialising decode's) * max|logit|, no pair dropped; planted "
          f"faults above it",
        e="bitwise", f="identical tokens",
        g=f"as c, on {MLA_236B_LAYERS} layers of deepseek-v2-236b at "
          f"{MLA_236B_PREFILL}"),
         reduced={"deepseek-v2-236b": f"n_layers 60 -> {MLA_236B_LAYERS}"},
         max_abs_err=errors, **checks)
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"lm_mla checks failed: {failed}")
    _require_launched(counts, "lm_mla")


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast(v, dtype) for v in tree]
    return tree.to(dtype)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def routing_traffic(d, seed, density=0.3):
    """tests/test_device_vcycle.py's traffic, normalised to O(1) link loads
    so that atol 1e-5 is a float32 statement."""
    import numpy as np
    rng = np.random.default_rng(seed)
    T = rng.uniform(0, 4, (d, d)) * (rng.uniform(0, 1, (d, d)) > 1 - density)
    T = np.triu(T, 1)
    T = T + T.T
    return T / max(T.sum(), 1.0)


def phase_mapping(state):
    import numpy as np

    from benchmarks import torch_bench_mapping_search as bench
    from repro_torch.core import mapping
    from repro_torch.core.machine import MachineSpec
    from repro_torch.core.topology import TreeTopology
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    for shape in MAPPING_SHAPES:
        c0 = ops.launch_counts()
        row = bench.score_row(shape, "cuda")
        # the looped scores' launches and the one warm-up's
        emit("mapping", step="scoring", **row,
             qll_launches=_since(c0)["quotient_link_loads"])
    for name in MAPPING_MACHINES:
        row = bench.machine_row(name, "cuda")
        spec = MachineSpec.preset(name)
        rec = None
        if isinstance(spec.topology(), TreeTopology):
            t0 = time.perf_counter()
            rec = mapping.search(spec.mesh_shape, None,
                                 bench._traffic(spec.mesh_shape),
                                 machine=spec, n_random=bench.N_RANDOM,
                                 recursive=True)
            row.update(recursive_s=time.perf_counter() - t0,
                       makespan_recursive=rec.bottleneck)
        emit("mapping", step="machine", **row)
        if rec is not None and rec.bottleneck > row["makespan_searched"]:
            raise AssertionError(f"recursive search worse on {name}: {row}")
    torus = MachineSpec.preset("torus-2d").topology()
    rng = np.random.default_rng(0)
    cands = np.stack([rng.permutation(torus.k) for _ in range(5)]
                     + [np.arange(torus.k)])
    err = 0.0
    for seed in range(3):
        T = routing_traffic(torus.k, seed)
        err = max(err, float(np.abs(
            mapping._routing_loads_batch(T, torus, cands)
            - mapping._routing_loads_dense(T, torus, cands)).max()))
    counts = ops.launch_counts()
    state["launches"]["mapping"] = counts
    emit("mapping", step="routing", machine="torus-2d", candidates=len(cands),
         sparse_vs_dense_max_abs=err, atol=1e-5, launches=counts)
    if err > 1e-5:
        raise AssertionError(f"sparse routing scorer off the dense one by "
                             f"{err}")
    _require_launched(counts, "mapping")


class NumpyDraws:
    """Cut-refinement uniforms from numpy's ``default_rng(seed)``: the same
    numbers on any device, so that a card run of ``total_cut_partition``
    can be held equal to a CPU run (a ``core/draws.py`` draw source)."""

    def cut_refine(self, seed, n):
        import numpy as np
        import torch
        rng = np.random.default_rng(seed)
        while True:
            yield torch.from_numpy(rng.random((2, n), dtype=np.float32))


def record_gain_calls(run):
    """Run ``run()`` with ``partition_gain``'s calls recorded: at each
    (k, rows), the first call's inputs and its output as the wrapper
    returned it (the refinement then masks it in place). The wrapper is
    replaced for the run only."""
    from repro_torch.kernels import ops
    orig = ops.partition_gain
    seen = {}

    def recording(part, nbr_idx, nbr_w, k):
        out = orig(part, nbr_idx, nbr_w, k)
        if (k, part.shape[0]) not in seen:
            seen[(k, part.shape[0])] = (part.clone(), nbr_idx, nbr_w,
                                        out.clone())
        return out
    ops.partition_gain = recording
    try:
        out = run()
    finally:
        ops.partition_gain = orig
    return out, seen


def check_gain_calls(seen):
    """Each recorded ``partition_gain`` output against the plain version
    on the same inputs, on the CPU: calls checked, how many differ, the
    largest difference, and the ELL widths (the finest level's [n, D] and
    the largest layout's bytes)."""
    import torch

    from repro_torch.kernels import partition_gain
    differ, err = 0, 0.0
    for (k, _), (part, idx, w, out) in seen.items():
        want = partition_gain.plain(part.cpu(), idx.cpu(), w.cpu(), k)
        got = out.cpu()
        differ += not torch.equal(got, want)
        err = max(err, float((got - want).abs().max()))
    shapes = [tuple(idx.shape) for _, idx, _, _ in seen.values()]
    return dict(calls=len(seen), not_bitwise=differ, max_abs_err=err,
                ell_finest=list(max(shapes)) if shapes else None,
                ell_max_bytes=max((n * d * 8 for n, d in shapes),
                                  default=0))


def phase_c1(state):
    from benchmarks.torch_bench_makespan_vs_cut import CASES, c1_row
    from repro_torch.core import baselines
    from repro_torch.core.machine import MachineSpec
    from repro_torch.graph.generators import grid3d
    from repro_torch.kernels import ops
    cases = CASES + [("full", lambda: grid3d(64, 64, 64),
                      lambda: MachineSpec.preset("gpu-superpod").tree())]
    cfg = baselines.CutRefineConfig(seed=0)
    ops.reset_launch_counts()
    counts = ops.launch_counts()
    for name, mk_g, mk_t in cases:
        g, topo = mk_g(), mk_t()
        c0 = ops.launch_counts()
        row, gains = record_gain_calls(lambda: c1_row(g, topo, "cuda", cfg))
        for kernel, n in _since(c0).items():
            counts[kernel] += n
        # the checks below launch kernels too; the path's counts are read
        cards, bad = row["scorecards"], []
        for method, part in row["parts"].items():
            host = host_scorecard(g, topo, part)
            s = cards[method]
            s["host_rel_err"] = max(abs(s[k] - v) / max(abs(v), 1.0)
                                    for k, v in host.items())
            if s["host_rel_err"] > 1e-4:
                bad.append(f"{method} scorecard off the host's: {s} {host}")
        gain = check_gain_calls(gains)
        if gain["not_bitwise"]:
            bad.append(f"partition_gain differs from plain: {gain}")
        replay_cfg = dataclasses.replace(cfg, rounds=C1_REPLAY_ROUNDS)
        t0 = time.perf_counter()
        on_card = baselines.total_cut_partition(g, topo.k, replay_cfg,
                                                draws=NumpyDraws())
        t1 = time.perf_counter()
        on_cpu = baselines.total_cut_partition(g, topo.k, replay_cfg,
                                               device="cpu",
                                               draws=NumpyDraws())
        replay = dict(rounds=C1_REPLAY_ROUNDS, card_s=t1 - t0,
                      cpu_s=time.perf_counter() - t1,
                      differing=int((on_card != on_cpu).sum()))
        if replay["differing"]:
            bad.append(f"total-cut on the card differs from the CPU run at "
                       f"{replay['differing']} vertices")
        speedup = row["speedup_vs_cut"]
        lo, hi = C1_SPEEDUP_BAND[name]
        # the band's control: the total-cut partition with its refinement
        # off, reported against the band (PERF.md section 2)
        ctrl = baselines.score_all(g, topo, baselines.total_cut_partition(
            g, topo.k, dataclasses.replace(cfg, rounds=0)))
        ctrl_speedup = (max(ctrl["comp_max"], ctrl["comm_max"])
                        / cards["ours"]["step"])
        imb_limit = C1_REF_CUT_IMBALANCE[name] + C1_IMBALANCE_MARGIN
        emit("c1", case=name, n=g.n_nodes, arcs=g.n_arcs, k=topo.k,
             links=topo.n_links, seconds=row["seconds"], scorecards=cards,
             speedup_vs_cut=speedup, band=[lo, hi],
             cut_imbalance_limit=imb_limit, partition_gain=gain,
             cut_card_vs_cpu=replay,
             control_rounds_0=dict(speedup_vs_cut=ctrl_speedup,
                                   inside_band=lo <= ctrl_speedup <= hi,
                                   total_cut=ctrl["total_cut"],
                                   imbalance=ctrl["imbalance"]))
        if not lo <= speedup <= hi:
            bad.append(f"speedup_vs_cut {speedup} outside [{lo}, {hi}]")
        if cards["cut"]["imbalance"] > imb_limit:
            bad.append(f"total-cut imbalance {cards['cut']['imbalance']} "
                       f"above {imb_limit}")
        if bad:
            raise AssertionError(f"c1 {name}: " + "; ".join(bad))
    state["launches"]["c1"] = counts
    emit("c1", step="launches", launches=counts)
    _require_launched(counts, "c1")


def claims_bands(claim, row, bad):
    """Each checked number of ``row`` (a dict of a twin's row) against its
    band in ``CLAIMS_REF`` or its value in ``CLAIMS_EXACT``, keyed by
    (claim, row name, number): ``{key: {value, band, inside}}``; a number
    outside its band is listed in ``bad``."""
    out = {}
    bands = {key: (lo / CLAIMS_SLACK, hi * CLAIMS_SLACK)
             for key, (lo, hi) in CLAIMS_REF.items()}
    for key, want in CLAIMS_EXACT.items():
        tol = CLAIMS_EXACT_RTOL * max(abs(want), 1.0)
        bands[key] = (want - tol, want + tol)
    for (c, name, key), band in bands.items():
        if c != claim or name != row["name"]:
            continue
        v = float(row[key])
        out[key] = dict(value=v, band=list(band),
                        inside=band[0] <= v <= band[1])
        if not out[key]["inside"]:
            bad.append(f"{claim} {name} {key} {v} outside {list(band)}")
    return out


def claims_host(row, label, bad):
    """Each scorecard a twin's row took on the card (``row["scored"]``:
    ``(graph, machine, part, scorecard)``) against a float64 host
    re-evaluation of the same part, over the keys both have: the largest
    relative difference, or None where the row scored nothing; above 1e-4
    is listed in ``bad``."""
    rel = None
    for g, topo, part, card in row.get("scored", ()):
        host = host_scorecard(g, topo, part)
        r = max(abs(card[k] - v) / max(abs(v), 1.0)
                for k, v in host.items() if k in card)
        rel = r if rel is None else max(rel, r)
        if r > 1e-4:
            bad.append(f"{label}: card scorecard {card} off the host's "
                       f"{host}")
    return rel


def phase_claims(state):
    """The paper's remaining claims through the port's bench twins at their
    full tier, launch counts set to 0 just before: C2 (every BFS round's
    load from the card equal to the host walk's), C3, C4, the section 3.1
    variants (the torus rows equal to the reference's, the fast bins above
    the slow ones) and the scaling rows of ``CLAIMS_SCALING_ROWS``, each
    checked number in its band and each scorecard against a float64 host
    re-evaluation."""
    import torch

    from benchmarks import torch_bench_hierarchical as c4
    from benchmarks import torch_bench_scaling as scaling
    from benchmarks import torch_bench_spmspv as c2
    from benchmarks import torch_bench_tradeoff as c3
    from benchmarks import torch_bench_variants as variants
    from benchmarks.torch_common import public
    from repro_torch.kernels import ops
    dev = "cuda"
    ops.reset_launch_counts()
    bad = []
    t_all = time.perf_counter()

    topo = c2.machine()
    for name, mk_g in c2.CASES:
        g = mk_g()
        t0 = time.perf_counter()
        row = c2.spmspv_row(g, topo, dev, host_walk=True)
        secs = time.perf_counter() - t0
        rounds = differ = 0
        for method in row["card_rounds"]:
            for card, host in zip(row["card_rounds"][method],
                                  row["host_rounds"][method]):
                rounds += len(host)
                differ += int(len(card) != len(host)) + sum(
                    int(a != b) for a, b in zip(card, host))
        if differ:
            bad.append(f"C2 {name}: {differ} of {rounds} rounds' card loads "
                       f"differ from the host walk")
        r = dict(name=name, ratio=row["ratio"])
        emit("claims", claim="C2", case=name, seconds=secs,
             frontier_cost_ours=row["frontier_cost_ours"],
             frontier_cost_cut=row["frontier_cost_cut"], ratio=row["ratio"],
             rounds_checked=rounds, rounds_differing=differ,
             bands=claims_bands("spmspv", r, bad))

    t0 = time.perf_counter()
    for row in c3.tradeoff_rows(dev):
        emit("claims", claim="C3", case=row["name"], **public(row),
             host_rel_err=claims_host(row, f"C3 {row['name']}", bad),
             bands=claims_bands("tradeoff", row, bad))
    emit("claims", claim="C3", step="seconds",
         seconds=time.perf_counter() - t0)

    topo = c4.machine()
    for name, mk_g in c4.CASES:
        g = mk_g()
        row = dict(name=name, **c4.hierarchical_row(g, topo, dev))
        emit("claims", claim="C4", case=name, **public(row),
             host_rel_err=claims_host(row, f"C4 {name}", bad),
             bands=claims_bands("hierarchical", row, bad))

    t0 = time.perf_counter()
    for row in variants.variants_rows(dev):
        extra = dict(host_rel_err=claims_host(row, f"variants {row['name']}",
                                              bad))
        if row["name"] in CLAIMS_TORUS:
            want = CLAIMS_TORUS[row["name"]]
            extra["equal_to_reference"] = all(row[k] == v
                                              for k, v in want.items())
            if not extra["equal_to_reference"]:
                bad.append(f"variants {row['name']} {public(row)} != "
                           f"the reference's {want}")
        if row["name"] == "hetero_speeds" and not (row["fast_load"]
                                                   > row["slow_load"]):
            bad.append(f"hetero_speeds: fast bins' load {row['fast_load']} "
                       f"not above the slow bins' {row['slow_load']}")
        emit("claims", claim="variants", case=row["name"],
             **public(row), bands=claims_bands("variants", row, bad),
             **extra)
    emit("claims", claim="variants", step="seconds",
         seconds=time.perf_counter() - t0)

    only = CLAIMS_SCALING_ROWS
    for fn in (scaling.scaling_size, scaling.scaling_k, scaling.vcycle):
        for row in fn(dev, only=only):
            emit("claims", claim="scaling", case=row["name"],
                 **public(row),
                 host_rel_err=claims_host(row, f"scaling {row['name']}", bad),
                 bands=claims_bands("scaling", row, bad))

    counts = ops.launch_counts()
    state["launches"]["claims"] = counts
    emit("claims", step="launches", seconds=time.perf_counter() - t_all,
         launches=counts)
    if bad:
        raise AssertionError("claims: " + "; ".join(bad))
    _require_launched(counts, "claims")


def _loss_and_grads(params, batch, cfg, attend):
    """(loss, flat grads) of ``transformer.loss_fn`` with the attention
    ``attend``, through the train step's own ``steps.loss_and_grads``."""
    from repro_torch import tree
    from repro_torch.models import transformer as tr
    from repro_torch.train.steps import loss_and_grads
    loss, _, grads = loss_and_grads(
        lambda p, b: tr.loss_fn(p, b, cfg, attend), params, batch)
    return float(loss), tree.leaves(grads)


def _plain_attend(kv_chunk):
    """The training path's attention with the plain forward (the
    ``FlashAttention`` Function, plain ``flash_attention_fwd`` and the same
    backward) at ``kv_chunk``: what the kernel path is held to."""
    from repro_torch.kernels.flash_attention import FlashAttention
    from repro_torch.models.common import flash_attention_fwd

    def attend(q, k, v, causal=True, q_chunk=512, **_):
        return FlashAttention.apply(q, k, v, causal, q_chunk, kv_chunk,
                                    flash_attention_fwd)
    return attend


def _rel_l2(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm().clamp_min(
        1e-30))


def _leaf_names(params):
    from repro_torch import tree
    return ["/".join(map(str, p)) for p, _ in tree.flatten(params)]


def _recording_step(step, record):
    """``step`` with each call's wall seconds, loss, grad norm and lr (read
    on the host, so each step ends synchronised) appended to ``record``."""
    def timed(params, opt, *rest):
        t0 = time.perf_counter()
        out = step(params, opt, *rest)
        m = out[-1]
        loss, gn, lr = float(m["loss"]), float(m["grad_norm"]), float(m["lr"])
        record.append(dict(s=time.perf_counter() - t0, loss=loss,
                           grad_norm=gn, lr=lr))
        return out
    return timed


def _train_resume_gate(dev, tmp):
    """Gate (f): SMOKE on the card, TRAIN_RESUME_STEPS straight against
    TRAIN_RESUME_AT steps, a checkpoint and a fresh ``loop.run`` that
    resumes from it (the batch stream fast-forwarded): losses and final
    state compared bitwise."""
    import itertools

    import torch

    from repro_torch import configs, tree
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.launch import train as tlaunch
    from repro_torch.models import transformer as tr
    from repro_torch.optim import adamw
    from repro_torch.train import loop
    from repro_torch.train.steps import make_train_step
    cfg = configs.get(LM_ARCH).smoke_config()
    ocfg = tlaunch.optimizer_config(TRAIN_LR, TRAIN_RESUME_STEPS)
    step = make_train_step(lambda p, b: tr.loss_fn(p, b, cfg), ocfg)

    def run(ckpt_dir, fail_at=None):
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        params = tr.init(cfg, gen, device=dev)
        start = ckpt.latest_step(ckpt_dir) or 0
        batches = tlaunch.make_batches(cfg.vocab, *TRAIN_RESUME_BATCH, dev)
        batches = itertools.islice(batches, start, None)
        return loop.run(step, params, adamw.init(params, ocfg), batches,
                        loop.LoopConfig(total_steps=TRAIN_RESUME_STEPS,
                                        ckpt_every=TRAIN_RESUME_AT,
                                        ckpt_dir=ckpt_dir,
                                        fail_at_step=fail_at))
    p_a, o_a, r_a = run(str(Path(tmp) / "straight"))
    try:
        run(str(Path(tmp) / "resumed"), fail_at=TRAIN_RESUME_AT + 2)
        failed = False
    except loop.InjectedFailure:
        failed = True
    p_b, o_b, r_b = run(str(Path(tmp) / "resumed"))
    a_leaves, b_leaves = tree.leaves((p_a, o_a)), tree.leaves((p_b, o_b))
    differing = [i for i, (x, y) in enumerate(zip(a_leaves, b_leaves))
                 if not torch.equal(x, y)]
    readings = dict(losses_straight=r_a.losses, losses_resumed=r_b.losses,
                    resumed_from=r_b.resumed_from, injected_failure=failed,
                    leaves=len(a_leaves), leaves_differing=len(differing),
                    max_abs_diff=max([float((a_leaves[i].float()
                                             - b_leaves[i].float()).abs()
                                            .max()) for i in differing],
                                     default=0.0))
    ok = (failed and r_b.resumed_from == TRAIN_RESUME_AT
          and r_a.losses[TRAIN_RESUME_AT:] == r_b.losses and not differing)
    return ok, readings


def phase_train(state):
    """qwen2-1.5b training at full width on the card: TRAIN_STEPS AdamW
    steps of train_4k's config at TRAIN_BATCH through ``loop.run``
    (counted; one more step traced), then the gates (a)-(f)."""
    import dataclasses as dc
    import itertools
    import tempfile

    import numpy as np
    import torch

    from repro_torch import configs, tree
    from repro_torch.configs.common import ShapeSpec, lm_model_flops
    from repro_torch.dist import compress
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch import train as tlaunch
    from repro_torch.models import transformer as tr
    from repro_torch.models.common import flash_attention_bwd
    from repro_torch.optim import adamw
    from repro_torch.train import loop
    from repro_torch.train.steps import make_train_step
    dev = torch.device("cuda")
    cfg = configs.get(LM_ARCH).make_config("train_4k")
    b, s = TRAIN_BATCH
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    t0 = time.perf_counter()
    params = tr.init(cfg, gen, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    batches = list(itertools.islice(
        tlaunch.make_batches(cfg.vocab, b, s, dev), TRAIN_STEPS))
    ocfg = tlaunch.optimizer_config(TRAIN_LR, TRAIN_STEPS)
    step = make_train_step(lambda p, bt: tr.loss_fn(p, bt, cfg), ocfg)
    flash_events = {"flash_fwd_": ("flash_attention",)}
    checks, errors = {}, {}

    # -- the counted run: TRAIN_STEPS steps through the loop
    rec = []
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    p_end, o_end, result = loop.run(
        _recording_step(step, rec), params, adamw.init(params, ocfg),
        iter(batches), loop.LoopConfig(total_steps=TRAIN_STEPS))
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    state["launches"]["train"] = counts
    per_step = 2 * cfg.n_layers
    checks["train_flash_launches_2_per_layer_per_step"] = (
        counts["flash_attention"] == per_step * TRAIN_STEPS)
    trace = _traced(lambda: step(p_end, o_end, batches[0]), flash_events)
    checks["train_trace_holds_2_flash_launches_per_layer"] = (
        trace["port_launches"]["flash_fwd_"]["traced"] == per_step)
    del p_end, o_end
    torch.cuda.empty_cache()
    tokens = b * s
    warm = float(np.median([r["s"] for r in rec[1:]]))
    flops = lm_model_flops(cfg.n_active_params(), ShapeSpec(
        "train", "train", {"batch": b, "seq": s}))
    losses = [r["loss"] for r in rec]
    norms = [r["grad_norm"] for r in rec]
    emit("train", step="run", arch=LM_ARCH, config="train_4k",
         params=cfg.n_params(), init_s=init_s, batch=b, seq=s,
         reduced="train_4k's batch 256 -> 4: one card holds one replica; "
                 "4 x 4,096 is the prefill cell's token count",
         steps=TRAIN_STEPS, optimizer=dc.asdict(ocfg), remat=cfg.remat,
         cold_s=rec[0]["s"], warm_s_p50=warm,
         step_s=[r["s"] for r in rec], tokens_per_step=tokens,
         tokens_per_s=tokens / warm, model_flops_per_step=flops,
         mfu=flops / warm / H100_BF16_PER_S, max_memory_allocated=peak,
         launches=counts, flash_per_step=counts["flash_attention"]
         / TRAIN_STEPS, losses=losses, grad_norms=norms,
         lrs=[r["lr"] for r in rec], loop_seconds=result.seconds,
         stragglers=result.straggler_steps, nvidia_smi=state["smi"])
    # (d) finite, and the loss comes down
    checks["d_finite_losses_and_grad_norms"] = bool(
        np.isfinite(losses).all() and np.isfinite(norms).all())
    checks["d_last_two_losses_below_the_first"] = (
        float(np.mean(losses[-2:])) < losses[0])

    # -- (a) the kernel inside the Function, on layers 0 and 27's own bf16
    # q, k, v and their attention outputs' cotangents from step 1; the
    # step-1 gradients through the kernel path come with them
    seen, calls = {}, [0]

    def record(q, k, v, **kw):
        i = calls[0]
        calls[0] += 1
        out = ops.flash_attention(q, k, v, **kw)
        if i in (0, cfg.n_layers - 1):      # the forward, not the recompute
            seen[i] = [q.detach(), k.detach(), v.detach(), None]
            out.register_hook(
                lambda g, i=i: seen[i].__setitem__(3, g.detach()))
        return out
    loss_k, grads_k = _loss_and_grads(params, batches[0], cfg, record)
    ok_a = sorted(seen) == [0, cfg.n_layers - 1] and all(
        x[3] is not None for x in seen.values())
    for li, (q, k, v, do) in sorted(seen.items()):
        passed, readings = flash_grad_judge(q, k, v, do, cfg.q_chunk,
                                            cfg.kv_chunk)
        errors[f"a_layer_{li}"] = readings
        ok_a &= passed
    checks["a_flash_function_grads_vs_f32"] = ok_a
    # (e)'s round trip of these gradients, on the card now and on the CPU
    # on a worker thread (its kernels release the GIL) while the card runs
    # the timings, (c) and the compressed steps
    emitted, residual = compress.roundtrip(
        tree.unflatten(params, grads_k), block=TRAIN_COMPRESS_BLOCK)
    card_out = [a.cpu() for a in tree.leaves((emitted, residual))]
    cpu_grads = tree.unflatten(params, [g.cpu() for g in grads_k])
    del emitted, residual

    def cpu_roundtrip():
        t0 = time.perf_counter()
        out = compress.roundtrip(cpu_grads, block=TRAIN_COMPRESS_BLOCK)
        return out, time.perf_counter() - t0
    pool = concurrent.futures.ThreadPoolExecutor(1)
    cpu_job = pool.submit(cpu_roundtrip)
    # the kernel with and without lse, and the plain backward, at the
    # path's own shape (layer 0's inputs): device ms, alternating
    q, k, v, do = seen[0]
    out, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
    no_lse, with_lse = alternating_device_ms(
        [lambda: fa.flash_attention(q, k, v, causal=True),
         lambda: fa.flash_attention(q, k, v, causal=True, return_lse=True)],
        rounds=21, flush=_flush_buffer(state))
    bwd_ms = device_ms(lambda: flash_attention_bwd(
        q, k, v, out, lse, do, True, cfg.q_chunk, cfg.kv_chunk), iters=5)
    nbytes, fl = fa.work(b, s, s, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                         True, 2)
    timing = dict(kernel_no_lse=no_lse, kernel_with_lse=with_lse,
                  bound_ms=bound(nbytes + 4 * b * s * cfg.n_heads, fl,
                                 H100_BF16_PER_S)[0],
                  plain_bwd_ms_per_layer=bwd_ms,
                  plain_bwd_share_of_traced_device_busy=cfg.n_layers * bwd_ms
                  / 1e3 / trace["device_busy_s"])
    del seen, q, k, v, do, out, lse
    state["train_flash"] = dict(shape=[b, s, cfg.n_heads, cfg.n_kv_heads,
                                       cfg.head_dim, "bf16", "train"],
                                **{k: timing[k] for k in (
                                    "kernel_no_lse", "kernel_with_lse",
                                    "bound_ms")})
    emit("train", step="trace", traced=trace, **timing)

    # -- (c) bf16 at full depth: the kernel path against the plain path,
    # banded by two chunkings of the plain path
    names = _leaf_names(params)
    plain_runs = {c: _loss_and_grads(params, batches[0], cfg,
                                     _plain_attend(c))
                  for c in TRAIN_PLAIN_CHUNKS}
    (loss_p, grads_p), (loss_q, grads_q) = (plain_runs[c] for c in
                                            TRAIN_PLAIN_CHUNKS)
    del plain_runs
    eps = float(np.finfo(np.float32).eps)
    kern = [_rel_l2(g, w) for g, w in zip(grads_k, grads_p)]
    spread = [_rel_l2(g, w) for g, w in zip(grads_q, grads_p)]
    del grads_p, grads_q
    loss_kern = abs(loss_k - loss_p) / abs(loss_p)
    loss_spread = abs(loss_q - loss_p) / abs(loss_p)
    worst = sorted(range(len(names)), key=lambda i: -kern[i])[:3]
    errors["c_bf16"] = dict(
        loss_kernel=loss_k, loss_plain=loss_p,
        loss_plain_other_chunking=loss_q, loss_rel_kernel_vs_plain=loss_kern,
        loss_rel_plain_chunkings=loss_spread,
        worst_leaf_rel_l2_kernel_vs_plain=max(kern),
        worst_leaf_rel_l2_plain_chunkings=max(spread),
        worst_leaves={names[i]: dict(kernel=kern[i], chunkings=spread[i])
                      for i in worst})
    checks["c_bf16_kernel_vs_plain_within_chunking_spread"] = (
        loss_kern <= FLASH_BF16_RATIO * max(loss_spread, eps)
        and max(kern) <= FLASH_BF16_RATIO * max(max(spread), eps))
    checks["a_step1_loss_equals_the_run"] = loss_k == losses[0]

    # -- (e) compression: its first loss is the uncompressed first loss
    # bitwise; roundtrip of step 1's gradients equals the CPU's bitwise
    # (the CPU's, started after (a), has run beside the card's work)
    del grads_k
    crec = []
    cocfg = tlaunch.optimizer_config(TRAIN_LR, TRAIN_COMPRESS_STEPS)
    cstep = make_train_step(lambda p, bt: tr.loss_fn(p, bt, cfg), cocfg,
                            grad_compress=TRAIN_COMPRESS_BLOCK)
    p_c, o_c, _ = loop.run(
        _recording_step(cstep, crec), params, adamw.init(params, cocfg),
        iter(batches), loop.LoopConfig(total_steps=TRAIN_COMPRESS_STEPS,
                                       grad_compress=TRAIN_COMPRESS_BLOCK))
    del p_c, o_c
    torch.cuda.empty_cache()
    cpu_out, cpu_s = cpu_job.result()
    pool.shutdown()
    diff = sum(not torch.equal(a, c) for a, c in zip(
        card_out, tree.leaves(cpu_out)))
    del card_out, cpu_out, cpu_grads
    errors["e_compress"] = dict(
        losses=[r["loss"] for r in crec],
        grad_norms=[r["grad_norm"] for r in crec],
        step_s=[r["s"] for r in crec], roundtrip_leaves_differing=diff,
        cpu_roundtrip_s=cpu_s)
    checks["e_compressed_first_loss_equals_uncompressed"] = (
        crec[0]["loss"] == losses[0])
    checks["e_roundtrip_card_equals_cpu_bitwise"] = diff == 0
    checks["e_compressed_losses_finite"] = bool(np.isfinite(
        [r["loss"] for r in crec]).all())
    del params
    torch.cuda.empty_cache()

    # -- (b) float32, FULL widths at 2 layers, 1 x 2,048: the SIMT kernel
    cfg32 = dc.replace(cfg, n_layers=TRAIN_F32_LAYERS, dtype=torch.float32)
    gen.manual_seed(0)
    params32 = tr.init(cfg32, gen, device=dev)
    batch32 = next(tlaunch.make_batches(cfg32.vocab, *TRAIN_F32_BATCH, dev))
    loss_k, grads_k = _loss_and_grads(params32, batch32, cfg32,
                                      ops.flash_attention)
    loss_p, grads_p = _loss_and_grads(params32, batch32, cfg32,
                                      _plain_attend(cfg32.kv_chunk))
    rel = [_rel_l2(g, w) for g, w in zip(grads_k, grads_p)]
    errors["b_f32"] = dict(loss_kernel=loss_k, loss_plain=loss_p,
                           loss_rel=abs(loss_k - loss_p) / abs(loss_p),
                           worst_leaf_rel_l2=max(rel),
                           worst_leaf=_leaf_names(params32)[int(np.argmax(
                               rel))])
    checks["b_f32_kernel_vs_plain"] = (
        errors["b_f32"]["loss_rel"] <= TRAIN_F32_LOSS_RTOL
        and max(rel) <= TRAIN_F32_GRAD_REL_L2)
    del params32, grads_k, grads_p
    torch.cuda.empty_cache()

    # -- (f) resume on the card, SMOKE
    with tempfile.TemporaryDirectory() as tmp:
        ok_f, errors["f_resume"] = _train_resume_gate(dev, tmp)
    checks["f_resume_equals_uninterrupted_bitwise"] = ok_f

    emit("train", step="checks", tolerances=dict(
        a=f"dq, dk, dv: max and rms error against the float32 plain path "
          f"<= {FLASH_BF16_RATIO}x the bf16 plain path's; lse within "
          f"{TRAIN_LSE_TOL} of the bf16 plain forward's; out bitwise with "
          f"and without lse; planted faults rejected",
        b=f"loss rel <= {TRAIN_F32_LOSS_RTOL}, every gradient leaf's "
          f"relative L2 <= {TRAIN_F32_GRAD_REL_L2}",
        c=f"loss rel and the worst leaf's relative L2 <= "
          f"{FLASH_BF16_RATIO}x the plain path's kv_chunk "
          f"{TRAIN_PLAIN_CHUNKS[0]} vs {TRAIN_PLAIN_CHUNKS[1]} spread",
        d="finite; mean of the last two losses below the first",
        e="first loss bitwise the uncompressed one's; roundtrip card == "
          "CPU bitwise",
        f="losses and final state bitwise"), max_abs_err=errors, **checks)
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"train checks failed: {failed}")
    _require_launched(counts, "train")


def _plain_bag_forward():
    """A context in which ``bag_combine``'s forward is its plain version
    (the ``BagCombine`` Function looks ``_forward`` up at call time): the
    plain path gate (a) holds the kernel path to."""
    import contextlib

    from repro_torch.kernels import bag_combine

    @contextlib.contextmanager
    def ctx():
        saved = bag_combine._forward
        bag_combine._forward = bag_combine.plain
        try:
            yield
        finally:
            bag_combine._forward = saved
    return ctx()


def _restored_state(ckpt_dir, like):
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch import tree
    state, _ = ckpt.restore(ckpt_dir, like, TRAIN_RECSYS_STEPS)
    return tree.leaves(state)


def phase_train_recsys(state):
    """Two-tower retrieval training at full width through the train CLI's
    ``build`` (TRAIN_RECSYS_CLI: the sharded table, sparse rowwise Adagrad,
    the hot-row cache report, the prefetcher): TRAIN_RECSYS_STEPS steps
    through ``loop.run`` (counted, its final state saved; one more step
    traced), then gates (a)-(f)."""
    import tempfile

    import numpy as np
    import torch

    from repro_torch import tree
    from repro_torch.embed import hot_cache
    from repro_torch.embed import training as embed_training
    from repro_torch.kernels import ops
    from repro_torch.launch import train as tlaunch
    from repro_torch.resilience import parse_fault_plan
    from repro_torch.train import loop
    from repro_torch.train.steps import loss_and_grads
    t_phase = time.perf_counter()
    args = tlaunch._parser().parse_args(TRAIN_RECSYS_CLI)
    t0 = time.perf_counter()
    setup = tlaunch.build(args)
    build_s = time.perf_counter() - t0
    emb = setup.embed
    params, cfg = setup.params, setup.cfg
    host0 = next(tlaunch.host_batches("recsys", cfg, args.batch, args.seq))
    batch0 = tlaunch.to_device(host0, setup.device)
    checks, errors = {}, {}

    # -- the counted run: the CLI's loop; its final state is saved once,
    # after the last step, for gate (d)
    tmp = tempfile.TemporaryDirectory()
    clean_dir = str(Path(tmp.name) / "clean")
    rec = []
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    stream = setup.batches(0)
    p_end, o_end, result = loop.run(
        _recording_step(setup.step, rec), params, setup.opt, stream,
        dataclasses.replace(setup.lcfg, ckpt_dir=clean_dir,
                            ckpt_every=TRAIN_RECSYS_STEPS + 1))
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    state["launches"]["train_recsys"] = counts
    prefetch = stream.stats()
    checks["bag_combine_one_launch_a_step"] = (
        counts["bag_combine"] == TRAIN_RECSYS_STEPS)
    e0 = embed_training.init_embed_state(p_end, emb["ecfg"])
    trace = _traced(lambda: setup.step(p_end, o_end, e0, batch0),
                    {"bag_reduce": ("bag_combine", "gather_combine")})
    del p_end, o_end, e0
    torch.cuda.empty_cache()
    losses = [r["loss"] for r in rec]
    warm = float(np.median([r["s"] for r in rec[1:]]))
    cache, rep_t = emb["cache"], emb["replicated"]
    emit("train_recsys", step="run", arch=setup.arch.name, cli=args.__dict__,
         reduced="batch 65,536 -> 32,768: the loss's [B, B] float32 "
                 "tensors (~4 x 17.2 GB at 65,536) do not fit beside the "
                 "table; --embed-probe-batches 1",
         params=cfg.n_params(), batch=args.batch, steps=TRAIN_RECSYS_STEPS,
         build_s=build_s, probe_s=emb["probe_s"],
         plan_shards_s=emb["plan_s"], cache_report_s=emb["cache_s"],
         plan=dict(n_rows=emb["plan"].n_rows,
                   n_devices=emb["plan"].n_devices,
                   machine=emb["plan"].machine,
                   makespan=emb["plan"].makespan),
         cold_s=rec[0]["s"], warm_s_p50=warm,
         step_s=[r["s"] for r in rec], examples_per_s=args.batch / warm,
         max_memory_allocated=peak, launches=counts, losses=losses,
         grad_norms=[r["grad_norm"] for r in rec], lrs=[r["lr"] for r in rec],
         loop_seconds=result.seconds, prefetch=prefetch,
         cache=dict(hits=cache.hits, misses=cache.misses,
                    lookups=cache.lookups, evictions=cache.evictions,
                    hit_rate=cache.hit_rate,
                    traffic_bytes=cache.traffic_bytes(),
                    replicated_bytes=float(rep_t.sum()) / 2),
         traced=trace, nvidia_smi=state["smi"])
    # (e) finite, and the loss comes down
    checks["e_finite_losses"] = bool(np.isfinite(losses).all())
    checks["e_last_two_losses_below_the_first"] = (
        float(np.mean(losses[-2:])) < losses[0])
    # (f) the hot-row cache and the prefetcher
    cache.check_invariants()
    checks["f_cache_invariants_hold"] = True
    checks["f_cache_traffic_below_replicated"] = (
        cache.traffic_bytes() < float(rep_t.sum()) / 2)
    checks["f_prefetch_ran_ahead"] = prefetch["max_occupancy"] >= 1

    # -- (a) step 1: loss and every gradient leaf, kernel path against the
    # plain path, float32
    names = _leaf_names(params)
    loss_k, _, grads_k = loss_and_grads(setup.loss_fn, params, batch0)
    with _plain_bag_forward():
        loss_p, _, grads_p = loss_and_grads(setup.loss_fn, params, batch0)
    rel = [_rel_l2(g, w) for g, w in zip(tree.leaves(grads_k),
                                         tree.leaves(grads_p))]
    del grads_p
    errors["a"] = dict(loss_kernel=float(loss_k), loss_plain=float(loss_p),
                       loss_rel=abs(float(loss_k) - float(loss_p))
                       / abs(float(loss_p)),
                       worst_leaf_rel_l2=max(rel),
                       worst_leaf=names[int(np.argmax(rel))])
    checks["a_kernel_vs_plain"] = (
        errors["a"]["loss_rel"] <= TRAIN_F32_LOSS_RTOL
        and max(rel) <= TRAIN_F32_GRAD_REL_L2)
    checks["a_step1_loss_equals_the_run"] = float(loss_k) == losses[0]

    # -- (b) dense, masked and sparse row updates on step 1's table
    # gradients, bitwise
    ok_b, touched = True, {}
    for name in emb["ecfg"].tables:
        g, tbl = grads_k[name], params[name]
        acc = torch.zeros(tbl.shape[0], device=tbl.device)
        dense = hot_cache.dense_row_update(tbl, acc, g)
        masked = hot_cache.masked_row_update(tbl, acc, g)
        rows = torch.nonzero((g != 0).any(-1))[:, 0]
        sparse = hot_cache.sparse_row_update(tbl, acc, rows, g[rows])
        touched[name] = int(rows.numel())
        ok_b &= all(torch.equal(a, b) for a, b in zip(dense, masked))
        ok_b &= all(torch.equal(a, b) for a, b in zip(dense, sparse))
        del dense, masked, sparse
    errors["b_touched_rows"] = touched
    checks["b_dense_masked_sparse_bitwise"] = ok_b
    del grads_k
    torch.cuda.empty_cache()

    # -- (c) the same step twice, bitwise (the table gradient is a scatter
    # with duplicate ids)
    e0 = embed_training.init_embed_state(params, emb["ecfg"])
    one = tree.leaves(setup.step(params, setup.opt, e0, batch0)[:3])
    two = tree.leaves(setup.step(params, setup.opt, e0, batch0)[:3])
    differing = [i for i, (a, b) in enumerate(zip(one, two))
                 if not torch.equal(a, b)]
    errors["c_leaves_differing"] = len(differing)
    checks["c_step_twice_bitwise"] = not differing
    del one, two, e0
    torch.cuda.empty_cache()

    # -- (d) run_supervised with a leaf death against the counted run: the
    # stitched losses and the final params, AdamW and Adagrad state bitwise
    with tmp:
        lcfg = loop.LoopConfig(
            total_steps=TRAIN_RECSYS_STEPS,
            ckpt_every=TRAIN_RECSYS_CKPT_EVERY,
            ckpt_dir=str(Path(tmp.name) / "chaos"), embed_sparse=emb["ecfg"])
        t0 = time.perf_counter()
        _, _, chaos = loop.run_supervised(
            setup.step, params, setup.opt, setup.batches, lcfg,
            parse_fault_plan(TRAIN_RECSYS_FAULTS),
            machine=args.embed_machine)
        chaos_s = time.perf_counter() - t0
        like = (params, setup.opt,
                embed_training.init_embed_state(params, emb["ecfg"]))
        a_leaves = _restored_state(clean_dir, like)
        b_leaves = _restored_state(lcfg.ckpt_dir, like)
        differing = [i for i, (a, b) in enumerate(zip(a_leaves, b_leaves))
                     if not torch.equal(a, b)]
        del a_leaves, b_leaves, like
    errors["d"] = dict(losses_chaos=chaos.losses,
                       recoveries=chaos.recoveries, attempts=chaos.attempts,
                       n_alive=chaos.machine.n_alive,
                       final_leaves_differing=len(differing),
                       seconds=chaos_s)
    checks["d_stitched_losses_equal_the_clean_run"] = chaos.losses == losses
    checks["d_final_state_bitwise"] = not differing
    checks["d_resumed_from_2"] = (
        len(chaos.recoveries) == 1
        and chaos.recoveries[0]["resumed_from"] == TRAIN_RECSYS_CKPT_EVERY)

    emit("train_recsys", step="checks", tolerances=dict(
        a=f"loss rel <= {TRAIN_F32_LOSS_RTOL}, every gradient leaf's "
          f"relative L2 <= {TRAIN_F32_GRAD_REL_L2}; step 1's loss bitwise "
          f"the run's",
        b="bitwise", c="bitwise",
        d="stitched losses equal; final params, AdamW and Adagrad state "
          "bitwise; resumed from step 2",
        e="finite; mean of the last two losses below the first",
        f="check_invariants; traffic below the replicated baseline; "
          "prefetch max_occupancy >= 1"),
        max_abs_err=errors, seconds=time.perf_counter() - t_phase, **checks)
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"train_recsys checks failed: {failed}")
    _require_launched(counts, "train_recsys")


@contextlib.contextmanager
def _patched(module, name, value):
    """``module.name`` is ``value`` inside the context (the model code looks
    the name up at call time)."""
    real = getattr(module, name)
    setattr(module, name, value)
    try:
        yield real
    finally:
        setattr(module, name, real)


def _recording_moe(record):
    """A context in which ``transformer.moe_ffn`` appends each call's
    ``MoEStats``, detached from autograd, to ``record``."""
    from repro_torch.models import transformer as tr
    inner = tr.moe_ffn

    def moe_ffn(p, x, cfg, *rules):
        y, st = inner(p, x, cfg, *rules)
        record.append(tr.MoEStats(*(t.detach() for t in st)))
        return y, st
    return _patched(tr, "moe_ffn", moe_ffn)


def _recording_route(record, detach_weights=False):
    """A context in which ``transformer.route`` appends each call's expert
    ids to ``record``; with ``detach_weights`` it also hands back the top-k
    weights detached from autograd (gate (b)'s planted fault)."""
    from repro_torch.models import transformer as tr
    inner = tr.route

    def route(p, x, cfg):
        probs, top_p, top_i = inner(p, x, cfg)
        record.append(top_i.detach().cpu())
        return probs, (top_p.detach() if detach_weights else top_p), top_i
    return _patched(tr, "route", route)


def _mla_f32_gate(cfg, errors, checks):
    """Train_mla gate (b): ``cfg`` (FULL widths) cut to
    TRAIN_MLA_F32_LAYERS layers in float32, one batch of
    TRAIN_MLA_F32_BATCH tokens, the same params on the card and the CPU:
    first every MoE layer's expert ids equal on both, then the loss, aux
    and every gradient leaf in train (b)'s bands; the planted fault (the
    router's top-k weights detached from autograd) must fail them."""
    import dataclasses as dc

    import numpy as np
    import torch

    from repro_torch import tree
    from repro_torch.launch import train as tlaunch
    from repro_torch.models import transformer as tr
    from repro_torch.train.steps import loss_and_grads
    dev = torch.device("cuda")
    cfg32 = dc.replace(cfg, n_layers=TRAIN_MLA_F32_LAYERS,
                       dtype=torch.float32)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = tr.init(cfg32, gen, device=dev)
    batch = next(tlaunch.make_batches(cfg32.vocab, *TRAIN_MLA_F32_BATCH,
                                      dev))

    def run(p, bt, detach=False):
        ids = []
        with _recording_route(ids, detach_weights=detach):
            loss, aux, grads = loss_and_grads(
                lambda q, c: tr.loss_fn(q, c, cfg32), p, bt)
        return (float(loss), float(aux["aux"]), tree.leaves(grads),
                ids[:cfg32.n_layers - cfg32.n_dense_layers])
    card = run(params, batch)
    fault = run(params, batch, detach=True)
    t0 = time.perf_counter()
    host = run(tree.map_(lambda x: x.cpu(), params),
               {k: v.cpu() for k, v in batch.items()})
    cpu_s = time.perf_counter() - t0
    names = _leaf_names(params)
    del params
    same_ids = [bool(torch.equal(a, c)) for a, c in zip(card[3], host[3])]

    def against_cpu(got):
        rel = [_rel_l2(g.cpu(), w) for g, w in zip(got[2], host[2])]
        worst = int(np.argmax(rel))
        return dict(loss_card=got[0], loss_cpu=host[0],
                    loss_rel=abs(got[0] - host[0]) / abs(host[0]),
                    aux_card=got[1], aux_cpu=host[1],
                    aux_rel=abs(got[1] - host[1]) / abs(host[1]),
                    worst_leaf_rel_l2=rel[worst], worst_leaf=names[worst])

    def inside(r):
        return (r["loss_rel"] <= TRAIN_F32_LOSS_RTOL
                and r["aux_rel"] <= TRAIN_F32_LOSS_RTOL
                and r["worst_leaf_rel_l2"] <= TRAIN_F32_GRAD_REL_L2)
    errors["b_f32_card_vs_cpu"] = dict(
        layers=TRAIN_MLA_F32_LAYERS, batch=list(TRAIN_MLA_F32_BATCH),
        expert_ids_equal=same_ids, cpu_s=cpu_s, **against_cpu(card),
        planted_router_weights_detached=against_cpu(fault))
    if not all(same_ids):
        # the margin of the router probabilities where the ids differ
        errors["b_f32_card_vs_cpu"]["differing_tokens"] = [
            int((a != c).any(-1).sum()) for a, c in zip(card[3], host[3])]
    checks["b_expert_ids_card_equal_cpu"] = all(same_ids)
    checks["b_f32_card_vs_cpu"] = all(same_ids) and inside(
        errors["b_f32_card_vs_cpu"])
    checks["b_planted_router_fault_rejected"] = not inside(
        errors["b_f32_card_vs_cpu"]["planted_router_weights_detached"])


def phase_train_mla(state):
    """deepseek-v2-lite-16b training at full width on the card, the depth
    cut to TRAIN_MLA_LAYERS: gates (a) and (d) on step 1's params, then
    TRAIN_MLA_STEPS AdamW steps of train_4k's config at TRAIN_MLA_BATCH
    through ``loop.run`` (counted; one more step traced), then gates (b)
    and (c)."""
    import dataclasses as dc
    import itertools

    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch import configs
    from repro_torch.configs.common import ShapeSpec, lm_model_flops
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch import train as tlaunch
    from repro_torch.models import transformer as tr
    from repro_torch.models.common import flash_attention_bwd
    from repro_torch.optim import adamw
    from repro_torch.train import loop
    from repro_torch.train.steps import make_train_step
    dev = torch.device("cuda")
    full = configs.get(MLA_ARCH).make_config("train_4k")
    cfg = dc.replace(full, n_layers=TRAIN_MLA_LAYERS)
    b, s = TRAIN_MLA_BATCH
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    t0 = time.perf_counter()
    params = tr.init(cfg, gen, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    batches = list(itertools.islice(
        tlaunch.make_batches(cfg.vocab, b, s, dev), TRAIN_MLA_STEPS))
    ocfg = tlaunch.optimizer_config(TRAIN_MLA_LR, TRAIN_MLA_STEPS)
    step = make_train_step(lambda p, bt: tr.loss_fn(p, bt, cfg), ocfg)
    flash_events = {"flash_fwd_": ("flash_attention",)}
    n_moe = cfg.n_layers - cfg.n_dense_layers
    checks, errors = {}, {}

    # -- (a), (d) on step 1's params: the first and last layers' own bf16
    # q, k, v and their attention outputs' cotangents; each MoE layer's
    # aux loss and dropped share (the forward's calls, not the recompute's)
    seen, calls, moe_stats = {}, [0], []

    def record(q, k, v, **kw):
        i = calls[0]
        calls[0] += 1
        out = ops.flash_attention(q, k, v, **kw)
        if i in (0, cfg.n_layers - 1):      # the forward, not the recompute
            seen[i] = [q.detach(), k.detach(), v.detach(), None]
            out.register_hook(
                lambda g, i=i: seen[i].__setitem__(3, g.detach()))
        return out
    with _recording_moe(moe_stats):
        loss_a, grads_a = _loss_and_grads(params, batches[0], cfg, record)
    del grads_a
    # the first n_moe calls are the forward's; the recompute's may stop
    # inside moe_ffn once autograd has what it needs (no stats then)
    aux = [float(st.aux_loss) for st in moe_stats[:n_moe]]
    dropped = [float(st.dropped_frac) for st in moe_stats[:n_moe]]
    ok_a = sorted(seen) == [0, cfg.n_layers - 1] and all(
        x[3] is not None for x in seen.values())
    for li, (q, k, v, do) in sorted(seen.items()):
        passed, readings = flash_grad_judge(q, k, v, do, cfg.q_chunk,
                                            cfg.kv_chunk)
        errors[f"a_layer_{li}"] = readings
        ok_a &= passed
    checks["a_flash_function_grads_vs_f32"] = ok_a
    errors["d_moe"] = dict(aux_loss=aux, dropped_frac=dropped,
                           moe_calls=len(moe_stats))
    checks["d_aux_positive_at_every_moe_layer"] = (
        len(aux) == n_moe and all(a > 0 for a in aux))
    # the kernel with and without lse, the plain backward and SDPA at the
    # path's own shape (layer 0's inputs): device ms
    q, k, v, do = seen.pop(0)
    seen.clear()
    out, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
    flush = _flush_buffer(state)
    no_lse, with_lse = alternating_device_ms(
        [lambda: fa.flash_attention(q, k, v, causal=True),
         lambda: fa.flash_attention(q, k, v, causal=True, return_lse=True)],
        rounds=21, flush=flush)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    sdpa_ms = device_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True), iters=10, flush=flush)
    bwd_ms = device_ms(lambda: flash_attention_bwd(
        q, k, v, out, lse, do, True, cfg.q_chunk, cfg.kv_chunk), iters=3)
    h, d, dv = cfg.n_heads, cfg.qk_head_dim, cfg.v_head_dim
    nbytes, fl = fa.work(b, s, s, h, h, d, True, 2, dv=dv)
    del q, k, v, do, out, lse, qt, kt, vt
    torch.cuda.empty_cache()

    # -- the counted run: TRAIN_MLA_STEPS steps through the loop, which
    # holds the only reference to the initial params (so they go after
    # step 1); each kernel launch's head dims recorded
    rec, shapes = [], []

    def shaped_fwd(q, k, v, *rest):
        shapes.append((q.shape[-1], v.shape[-1], str(q.dtype)))
        return real_fwd(q, k, v, *rest)
    run_args = [params, adamw.init(params, ocfg)]
    del params
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    with _patched(fa, "kernel_fwd", shaped_fwd) as real_fwd:
        p_end, o_end, result = loop.run(
            _recording_step(step, rec), run_args.pop(0), run_args.pop(0),
            iter(batches), loop.LoopConfig(total_steps=TRAIN_MLA_STEPS))
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    state["launches"]["train_mla"] = counts
    per_step = 2 * cfg.n_layers
    checks["flash_launches_2_per_layer_per_step"] = (
        counts["flash_attention"] == per_step * TRAIN_MLA_STEPS)
    checks["flash_launches_at_192_128_bf16_with_lse"] = (
        len(shapes) == counts["flash_attention"]
        and set(shapes) == {(d, dv, "torch.bfloat16")})
    checks["peak_memory_within_limit"] = peak <= TRAIN_MLA_PEAK_BYTES
    trace = _traced(lambda: step(p_end, o_end, batches[0]), flash_events)
    checks["trace_holds_2_flash_launches_per_layer"] = (
        trace["port_launches"]["flash_fwd_"]["traced"] == per_step)
    del p_end, o_end
    torch.cuda.empty_cache()
    tokens = b * s
    warm = float(np.median([r["s"] for r in rec[1:]]))
    flops = lm_model_flops(cfg.n_active_params(), ShapeSpec(
        "train", "train", {"batch": b, "seq": s}))
    losses = [r["loss"] for r in rec]
    norms = [r["grad_norm"] for r in rec]
    timing = dict(kernel_no_lse=no_lse, kernel_with_lse=with_lse,
                  sdpa_ms=sdpa_ms,
                  bound_ms=bound(nbytes + 4 * b * s * h, fl,
                                 H100_BF16_PER_S)[0],
                  plain_bwd_ms_per_layer=bwd_ms,
                  plain_bwd_share_of_traced_device_busy=cfg.n_layers
                  * bwd_ms / 1e3 / trace["device_busy_s"])
    state["train_mla_flash"] = dict(
        shape=[b, s, h, h, d, dv, "bf16", "train_mla"],
        launches=counts["flash_attention"], per_step=per_step,
        **{k: timing[k] for k in ("kernel_no_lse", "kernel_with_lse",
                                  "sdpa_ms", "bound_ms")})
    emit("train_mla", step="run", arch=MLA_ARCH, config="train_4k",
         layers=cfg.n_layers, params=cfg.n_params(),
         active_params=cfg.n_active_params(), init_s=init_s, batch=b,
         seq=s, reduced=f"depth 27 -> {cfg.n_layers} layers (1 dense + "
         f"{n_moe} MoE): the full model's 15.7B parameters and AdamW state "
         f"do not fit one card (PERF.md section 4); train_4k's batch 256 "
         f"-> 4: one card holds one replica",
         steps=TRAIN_MLA_STEPS, optimizer=dc.asdict(ocfg), remat=cfg.remat,
         capacity_factor=cfg.capacity_factor,
         capacity=tr.capacity(cfg, tokens), cold_s=rec[0]["s"],
         warm_s_p50=warm, step_s=[r["s"] for r in rec],
         tokens_per_step=tokens, tokens_per_s=tokens / warm,
         model_flops_per_step=flops, mfu=flops / warm / H100_BF16_PER_S,
         max_memory_allocated=peak, peak_limit=TRAIN_MLA_PEAK_BYTES,
         launches=counts, flash_per_step=counts["flash_attention"]
         / TRAIN_MLA_STEPS, flash_head_dims=sorted(set(shapes)),
         losses=losses, grad_norms=norms, lrs=[r["lr"] for r in rec],
         moe=errors["d_moe"], loop_seconds=result.seconds,
         nvidia_smi=state["smi"])
    emit("train_mla", step="trace", traced=trace, **timing)
    checks["a_step1_loss_equals_the_run"] = loss_a == losses[0]
    # (c) finite, and the loss comes down
    checks["c_finite_losses_and_grad_norms"] = bool(
        np.isfinite(losses).all() and np.isfinite(norms).all())
    checks["c_last_two_losses_below_the_first"] = (
        float(np.mean(losses[-2:])) < losses[0])

    # -- (b) float32 at 2 layers: the card against the CPU
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        _mla_f32_gate(cfg, errors, checks)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.cuda.empty_cache()

    emit("train_mla", step="checks", tolerances=dict(
        a=f"dq, dk, dv: max and rms error against the float32 plain path "
          f"<= {FLASH_BF16_RATIO}x the bf16 plain path's, the rms also per "
          f"128-row tile; lse within {TRAIN_LSE_TOL} of the bf16 plain "
          f"forward's; out bitwise with and without lse; planted faults "
          f"rejected",
        b=f"expert ids equal; loss and aux rel <= {TRAIN_F32_LOSS_RTOL}, "
          f"every gradient leaf's relative L2 <= {TRAIN_F32_GRAD_REL_L2}; "
          f"the router fault rejected",
        c="finite; mean of the last two losses below the first",
        d="aux > 0 at every MoE layer"), max_abs_err=errors, **checks)
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"train_mla checks failed: {failed}")
    _require_launched(counts, "train_mla")


def phase_placement(state):
    """The placement bench twin's four rows at the full tier on the card,
    launch counts set to 0 just before: each checked number in its band
    or at its value (``CLAIMS_REF``, ``CLAIMS_EXACT``), each scorecard
    against a float64 host re-evaluation at rel 1e-4; the heterogeneous
    claims raise inside the twin."""
    from benchmarks import torch_bench_placement as pb
    from benchmarks.torch_common import public
    from repro_torch.kernels import ops
    bad = []
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rows = [fn("cuda") for fn in pb.ROWS]
    seconds = time.perf_counter() - t0
    counts = ops.launch_counts()
    state["launches"]["placement"] = counts
    for row in rows:
        emit("placement", case=row["name"], **public(row),
             host_rel_err=claims_host(row, f"placement {row['name']}", bad),
             bands=claims_bands("placement", row, bad))
    emit("placement", step="launches", seconds=seconds, launches=counts)
    if bad:
        raise AssertionError("placement: " + "; ".join(bad))
    _require_launched(counts, "placement")


def phase_serving_bench(state):
    """The serving bench twin at its full tier on the card, launch counts
    set to 0 just before: at qwen2-1.5b SMOKE from seed 0 every schedule
    field of the rows without a fault equal to the reference's
    (``SERVING_REF``); then at qwen2-1.5b FULL in bf16 from seed 0. The
    bench's claims raise inside the twin in both runs."""
    import torch

    from benchmarks import torch_bench_serving as sb
    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tr
    dev = torch.device("cuda")
    bad = []
    ops.reset_launch_counts()
    cfg, params = sb.default_model(dev)
    t0 = time.perf_counter()
    rows = sb.serving_throughput(cfg, params, dev)
    smoke_s = time.perf_counter() - t0
    for row in rows:
        want = SERVING_REF.get(row["name"])
        got = {k: row[k] for k in sb.SCHEDULE}
        if want is not None and got != want:
            bad.append(f"{row['name']}: schedule {got} != the reference's "
                       f"{want}")
        emit("serving_bench", config="smoke", **row,
             reference=want if want is not None else SERVING_REF_CHAOS,
             schedule_gated=want is not None)
    del params
    full = configs.get(LM_ARCH).make_config("decode_32k")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = tr.init(full, gen, device=dev)
    t0 = time.perf_counter()
    rows_full = sb.serving_throughput(full, params, dev)
    full_s = time.perf_counter() - t0
    del params
    counts = ops.launch_counts()
    state["launches"]["serving_bench"] = counts
    for row in rows_full:
        emit("serving_bench", config="full", dtype="bf16", **row)
    emit("serving_bench", step="launches", smoke_s=smoke_s, full_s=full_s,
         launches=counts, nvidia_smi=state["smi"])
    if bad:
        raise AssertionError("serving_bench: " + "; ".join(bad))
    _require_launched(counts, "serving_bench")


def _lm100m_example():
    """``examples/torch_train_lm_100m.py`` as a module (``examples/`` is no
    package): its ``CFG`` and its flags' defaults."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "torch_train_lm_100m", ROOT / "examples" / "torch_train_lm_100m.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _lm100m_flash_check(state, cfg, args):
    """``flash_attention`` at the example's shape, float32 on the card
    (B = batch, S = seq, the model's heads, KV heads and head dim), as its
    training calls it: the kernel's forward with its log-sum-exp
    (``kernel_fwd``) against the plain forward on the same random inputs,
    out and lse both within FLASH_F32_TOL (rtol = atol), out bitwise the
    same without lse; timed beside the plain version and SDPA."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    dev = torch.device("cuda")
    b, s, h, kh = args.batch, args.seq, cfg.n_heads, cfg.n_kv_heads
    d = cfg.d_model // cfg.n_heads
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    q, k, v = (torch.randn(b, s, n, d, generator=gen, device=dev)
               for n in (h, kh, kh))
    chunks = (True, cfg.q_chunk, cfg.kv_chunk)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))

    def judge(got, want):
        _, l_k = fa.kernel_fwd(q, k, v, *chunks)
        _, l_p = fa.plain_fwd(q, k, v, *chunks)

        def close(a, w):
            return bool(((a - w).abs() <= FLASH_F32_TOL
                         + FLASH_F32_TOL * w.abs()).all())
        same = torch.equal(got, fa.flash_attention(q, k, v, causal=True))
        readings = dict(lse_max_abs_err=float((l_k - l_p).abs().max()),
                        out_bitwise_with_and_without_lse=same)
        return (close(got, want) and close(l_k, l_p) and same,
                f"out and lse: rtol = atol = {FLASH_F32_TOL}; out bitwise "
                f"with and without lse", readings)
    nbytes, flops = fa.work(b, s, s, h, kh, d, True, 4, dv=d)
    _check_kernel(
        state, "flash_attention", [b, s, h, kh, d, d, "f32", "lm100m"],
        lambda: fa.kernel_fwd(q, k, v, *chunks)[0],
        lambda: fa.plain_fwd(q, k, v, *chunks)[0], exact=False,
        judge=judge, iters=30,
        library=lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True),
        bytes_moved=nbytes + 4 * b * s * h, flops=flops)


# lm100m's depth: the example's defaults but its steps, 300 cut to 100
# (one checkpoint; ~22 s of the smoke's 1,200 s limit on a normal host)
LM100M_STEPS = 100


def phase_lm100m(state):
    """``examples/torch_train_lm_100m.py`` at its defaults but
    ``--steps LM100M_STEPS``, in a process of its own: its learned-assert
    holds (it exits 0), a checkpoint every 100 steps is written, and its
    ``flash_attention`` launches (the example's own counter, zeroed before
    its loop) are one a layer a step. First the kernel at the example's
    shape with its log-sum-exp, held to the plain forward
    (``_lm100m_flash_check``)."""
    import os
    import tempfile

    from repro_torch.kernels import ops
    start_analysis_cli(state)    # kernel_plans (e), on the idle host
    ex = _lm100m_example()
    args = ex.parser().parse_args(["--steps", str(LM100M_STEPS)])
    _lm100m_flash_check(state, ex.CFG, args)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, str(ROOT / "examples" / "torch_train_lm_100m.py"),
             "--steps", str(args.steps), "--ckpt-dir", tmp], env=env,
            capture_output=True, text=True,
            timeout=600)
        seconds = time.perf_counter() - t0
        ckpts = sorted(os.listdir(tmp))
    lines = out.stdout.splitlines()
    counts = {k: 0 for k in ops.launch_counts()}
    for ln in lines:
        if ln.startswith("kernel launches:"):
            counts.update({k: int(v) for k, v in (
                kv.split("=") for kv in ln.split(":", 1)[1].split())})
    state["launches"]["lm100m"] = counts
    want = [f"step_{n:09d}" for n in range(100, args.steps + 1, 100)]
    checks = dict(
        exit_0_the_example_learned=out.returncode == 0,
        checkpoints_every_100=ckpts == want,
        flash_launches_one_per_layer_per_step=(
            counts["flash_attention"] == args.steps * ex.CFG.n_layers))
    emit("lm100m", seconds=seconds, returncode=out.returncode,
         stdout_tail=lines[-4:], stderr_tail=out.stderr[-2000:],
         checkpoints=ckpts, launches=counts, **checks)
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"lm100m checks failed: {failed}")
    _require_launched(counts, "lm100m")


# The placement session's cells at full width, one child process each, at
# most PLACE_PARALLEL at a time: qwen2-1.5b FULL (28 layers, the shape's
# own batch of 256 x 4,096 on meta tensors) under every profile, and
# DeepSeek-V2-Lite FULL (27 layers: 1 dense + 26 MoE) likewise, on
# tpu_v5e-512; qwen2 2d on gpu-superpod; the GNN and two-tower cells the
# gnn_train and train_recsys phases train (pna minibatch_lg, the
# two-tower's train_batch); and qwen2's decode_32k (128 x 32,768 of cache).
# (longest first: the four DeepSeek children, ~65 s each, start with the
# first eight, and the short ones fill the slots the qwen2 ones free)
PLACE_CELLS = (
    ("deepseek-v2-lite-16b", "train_4k", "tpu_v5e-512", "2d"),
    ("deepseek-v2-lite-16b", "train_4k", "tpu_v5e-512", "fsdp"),
    ("deepseek-v2-lite-16b", "train_4k", "tpu_v5e-512", "sp"),
    ("deepseek-v2-lite-16b", "train_4k", "tpu_v5e-512", "expert"),
    ("qwen2-1.5b", "train_4k", "tpu_v5e-512", "2d"),
    ("qwen2-1.5b", "train_4k", "tpu_v5e-512", "expert"),
    ("qwen2-1.5b", "train_4k", "tpu_v5e-512", "fsdp"),
    ("qwen2-1.5b", "train_4k", "tpu_v5e-512", "sp"),
    ("qwen2-1.5b", "train_4k", "gpu-superpod", "2d"),
    ("pna", "minibatch_lg", "tpu_v5e-512", "2d"),
    ("two-tower-retrieval", "train_batch", "tpu_v5e-512", "2d"),
    ("qwen2-1.5b", "decode_32k", "gpu-superpod", "2d"),
)
PLACE_PARALLEL = 8        # children at a time: the host's 8 cores
# the reference's rows for the tpu_v5e-512 train_4k cells (EXPERIMENTS.md
# §Mapping-grid, XLA host compiles): searched / identity makespan, the axis
# permutation, recompiles
PLACE_REF = {("qwen2-1.5b", "2d"): (0.631, [1, 0, 2], 1),
             ("qwen2-1.5b", "fsdp"): (0.450, [2, 0, 1], 1),
             ("qwen2-1.5b", "sp"): (1.000, [0, 1, 2], 0),
             ("qwen2-1.5b", "expert"): (0.631, [1, 0, 2], 1),
             ("deepseek-v2-lite-16b", "2d"): (1.000, [0, 1, 2], 0),
             ("deepseek-v2-lite-16b", "fsdp"): (0.040, [2, 0, 1], 1),
             ("deepseek-v2-lite-16b", "sp"): (1.000, [0, 1, 2], 0),
             ("deepseek-v2-lite-16b", "expert"): (0.001, [2, 1, 0], 1)}
PLACE_REL = 1e-4          # gate (a): the card's makespan vs the float64
                          # score of the CPU's order, the mapping band
PLACE_TIE = 1e-9          # rel float64 difference of an exact tie
PLACE_TIMEOUT_S = 420
# the cells that also retrace identity under identity for gate (c): the
# cheapest trace, and a 3-d mesh's
PLACE_RETRACE = (("qwen2-1.5b", "train_4k", "gpu-superpod", "2d"),
                 ("qwen2-1.5b", "train_4k", "tpu_v5e-512", "expert"))
# gate (e): expert equals 2d on the dense arch (on DeepSeek the profiles
# shard the experts differently)
PLACE_EXPERT_PAIR = (("qwen2-1.5b", "train_4k", "tpu_v5e-512", "2d"),
                     ("qwen2-1.5b", "train_4k", "tpu_v5e-512", "expert"))
# the cell whose searches' own quotient_link_loads inputs are timed
PLACE_QLL_CELL = ("deepseek-v2-lite-16b", "train_4k", "tpu_v5e-512",
                  "expert")


def place_label(cell) -> str:
    return "/".join(cell)


def host_map_makespan(traffic, topo, order) -> float:
    """The F_l-weighted makespan of a device -> bin order on a tree in
    float64 on the host: link l carries the traffic of every device pair
    it separates. Tells an exact tie (which the card's float32 atomics and
    the CPU's float32 sums may break either way) from a real difference."""
    import numpy as np
    x = np.asarray(topo.subtree, np.float64)[:, np.asarray(order)]
    t = np.asarray(traffic, np.float64)
    xt = x @ t
    loads = xt.sum(1) - (xt * x).sum(1)
    return float((np.asarray(topo.F_l, np.float64) * loads).max())


def place_child(cell: int, cache_dir: str) -> None:
    """One cell of ``PLACE_CELLS`` in a process of its own (the fake world
    is process-global state): ``PlacementSession.place`` with
    ``recompile=True``, its searches on the card and the launch counts
    read around it; then a CPU search over the same traces (the disk
    cache) for gate (a), a fresh identity retrace for (c) in the
    ``PLACE_RETRACE`` cells, the lint for (d), and for (e) a digest of the
    record; in ``PLACE_QLL_CELL`` the kernel timed on the largest call of
    the searches' own inputs against its plain version. Prints one JSON
    line.

    ``quotient_link_loads`` sums with float atomics, so the card's scores
    vary in their last bits from call to call, and among candidates whose
    makespans tie exactly the card and the CPU may pick different ones:
    where the orders differ both are scored in float64 on the host, and
    they must tie (``PLACE_TIE``). The card's makespan is held to the
    float64 score of the CPU's order (``PLACE_REL``): the CPU's own float32
    score cancels terms of the order of all the traffic (the reference's
    load algebra, which the CPU path keeps) and missed the exact value by
    1.5e-4 on the sp cell, whose bottleneck link carries a small share of
    it; it is reported beside (``cpu_f32_makespan_rel``)."""
    import hashlib
    import resource

    import numpy as np
    import torch

    from repro_torch.core import mapping
    from repro_torch.core.machine import MachineSpec
    from repro_torch.kernels import ops
    from repro_torch.kernels import quotient_link_loads as qll
    from repro_torch.launch.placement import PlacementSession, schedule_diff

    arch, shape, machine, prof = PLACE_CELLS[cell]
    spec = MachineSpec.preset(machine)
    topo = spec.topology()
    t0 = time.perf_counter()
    torch.zeros(1, device="cuda")
    out = {"arch": arch, "shape": shape, "machine": machine,
           "profile": prof, "cuda_init_s": time.perf_counter() - t0}
    card = PlacementSession(cache_dir=cache_dir, device=None)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    held = []

    def run():
        held.append(card.place(arch, shape, profile=prof, machine=machine,
                               recompile=True))
    qll_inputs = (record_qll_inputs(run) if PLACE_CELLS[cell] == PLACE_QLL_CELL
                  else run())
    res = held[0]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out["launches"] = ops.launch_counts()
    if qll_inputs:
        args = max(qll_inputs.values(), key=lambda a: a[1].shape[0])
        flush = _flush_buffer({})
        out["qll_at_search"] = dict(
            arcs=int(args[1].shape[0]), vertices=int(args[0].shape[0]),
            k=int(args[6]), links=int(args[4].shape[0]),
            calls=out["launches"].get("quotient_link_loads", 0),
            ms=device_ms(lambda: qll.quotient_link_loads(*args), 30,
                         flush=flush),
            plain_ms=device_ms(lambda: qll.plain(*args), 30, flush=flush),
            max_abs_err=float((qll.quotient_link_loads(*args)
                               - qll.plain(*args)).abs().max()),
            max_plain=float(qll.plain(*args).abs().max()))
    rep = res.report
    traced = {id(r): r for r in (res.record, res.searched_record)
              if r is not None and not r.cached}
    trace_s = sum(r.compile_s for r in traced.values())
    traffic = (res.searched_record or res.record).traffic
    out.update(
        trace_s=trace_s, traces=len(traced), search_s=wall - trace_s,
        collectives=res.record.by_op, n_collectives=res.record.n_collectives,
        link_bytes=res.record.link, link_by_axis=res.record.link_by_axis,
        agg_flops=res.record.agg_flops, identity=rep.identity,
        searched=rep.searched, ratio=rep.makespan_ratio, perm=rep.axis_perm,
        device_order=rep.device_order,
        round0_ratio=rep.rounds[0]["makespan"] / rep.identity["makespan"],
        moved_after_round0=any(r["order_changed"] for r in rep.rounds[1:]),
        recompiles=sum(r["recompiled"] for r in rep.rounds),
        fixed_point=(rep.schedule_diff or {}).get("fixed_point"),
        n_candidates=rep.n_candidates,
        host_makespan=host_map_makespan(traffic, topo, rep.device_order))

    # (a): each search place() ran, again on the card and on the CPU on the
    # same traffic: round 0 on the identity trace, round 1 (warm-started
    # with the winner) on the retrace
    t0 = time.perf_counter()
    rounds_a = []
    searched = [(res.record.traffic, None)]
    if res.searched_record is not None and res.searched_record is not \
            res.record:
        searched.append((res.searched_record.traffic,
                         [np.asarray(rep.device_order)]))
    for t, warm in searched:
        kw = dict(warm_starts=warm, n_random=card.map_restarts,
                  recursive=card.recursive, seed=card.seed)
        g = mapping.search(spec.mesh_shape, topo, t, device=None, **kw)
        c = mapping.search(spec.mesh_shape, topo, t, device="cpu", **kw)
        same = np.array_equal(g.device_to_bin, c.device_to_bin)
        hg = host_map_makespan(t, topo, g.device_to_bin)
        hc = host_map_makespan(t, topo, c.device_to_bin)
        tie = 0.0 if same else abs(hg - hc) / hg
        rel = abs(g.bottleneck - hc) / hc
        rounds_a.append(dict(order_equal=bool(same), tie_rel_f64=tie,
                             makespan_rel=rel,
                             cpu_f32_makespan_rel=abs(
                                 g.bottleneck - c.bottleneck) / c.bottleneck,
                             card_perm=list(g.axis_perm),
                             cpu_perm=list(c.axis_perm),
                             cpu_order=c.device_to_bin.tolist(),
                             cpu_makespan=float(c.bottleneck),
                             ok=(same or tie <= PLACE_TIE)
                             and rel <= PLACE_REL))
    out["a"] = dict(rounds=rounds_a, seconds=time.perf_counter() - t0,
                    ok=all(r["ok"] for r in rounds_a))
    out["b_searched_le_identity"] = (rep.searched["makespan"]
                                     <= rep.identity["makespan"])
    if PLACE_CELLS[cell] in PLACE_RETRACE:
        ident = np.arange(spec.n_devices)
        t0 = time.perf_counter()
        fresh = PlacementSession(cache_dir="", device=card.device).measure(
            arch, shape, profile=prof, machine=machine)
        out["c_identity_retrace"] = dict(
            seconds=time.perf_counter() - t0,
            max_abs_delta=schedule_diff(res.record, fresh, topo, ident,
                                        ident, device=card.device)[
                                            "max_abs_delta"])
    out["d_lint_errors"] = [f.message for f in card.verify()
                            if f.severity == "error"]
    out["d_matrices"] = len(card._mem)
    h = hashlib.sha256(np.ascontiguousarray(
        res.record.traffic).tobytes())
    h.update(json.dumps([res.record.link, res.record.by_op],
                        sort_keys=True).encode())
    out["e_record_digest"] = h.hexdigest()
    out["max_rss_gb"] = resource.getrusage(
        resource.RUSAGE_SELF).ru_maxrss / 2**20
    print(json.dumps(out), flush=True)


def phase_place(state):
    """The placement session's trace -> search -> retrace loop at full
    width: ``PLACE_CELLS``, each in a child process (``place_child``), at
    most ``PLACE_PARALLEL`` at a time. Gates: (a) each of the card's
    searches equals a CPU search on the same traffic (the same order, or
    one tied with it in float64, and the card's makespan within
    ``PLACE_REL`` of the CPU order's float64 score); (b) searched <=
    identity on each side's own schedule; (c) an identity -> identity
    retrace diffs to 0 (``PLACE_RETRACE``); (d) ``lint_traffic`` finds no
    error in any traced matrix; (e) expert equals 2d on the dense arch
    (``PLACE_EXPERT_PAIR``): the traced records and the CPU searches
    exactly, the card's orders up to a float64 tie; (f)
    ``quotient_link_loads`` launched. The ratios and perms stand beside the
    reference's rows (``PLACE_REF``), reported, not gated."""
    import atexit
    import os
    import shutil
    import tempfile

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    outs = [None] * len(PLACE_CELLS)
    # the trace cache outlives the phase: the dryrun phase reads the same
    # records (it removes the directory)
    tmp = tempfile.mkdtemp(prefix="place_cache_")
    atexit.register(shutil.rmtree, tmp, True)
    state["place_cache"] = tmp
    pending = list(range(len(PLACE_CELLS)))
    running = {}
    try:
        while pending or running:
            while pending and len(running) < PLACE_PARALLEL:
                i = pending.pop(0)
                running[i] = (subprocess.Popen(
                    [sys.executable, "-c",
                     f"import chip_smoke; chip_smoke.place_child({i}, "
                     f"{tmp!r})"],
                    cwd=ROOT, env=env, stdout=subprocess.PIPE,
                    stderr=subprocess.PIPE, text=True),
                    time.perf_counter())
            done = [i for i, (p, _) in running.items()
                    if p.poll() is not None]
            for i, (p, t0) in running.items():
                if i not in done and \
                        time.perf_counter() - t0 > PLACE_TIMEOUT_S:
                    raise AssertionError(
                        f"place child {place_label(PLACE_CELLS[i])} "
                        f"ran past {PLACE_TIMEOUT_S} s")
            for i in done:
                p, t0 = running.pop(i)
                stdout, stderr = p.communicate()
                lines = [ln for ln in stdout.splitlines()
                         if ln.startswith("{")]
                if p.returncode != 0 or not lines:
                    raise AssertionError(
                        f"place child {place_label(PLACE_CELLS[i])} "
                        f"failed ({p.returncode}): {stderr[-3000:]}")
                outs[i] = dict(json.loads(lines[-1]),
                               wall_s=time.perf_counter() - t0)
                emit("place", step="child",
                     cell=place_label(PLACE_CELLS[i]),
                     wall_s=outs[i]["wall_s"],
                     trace_s=outs[i]["trace_s"],
                     ratio=outs[i]["ratio"])
            time.sleep(0.2)
    finally:
        for p, _ in running.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    place_gates(state, outs)


def place_gates(state, outs):
    """``phase_place``'s lines and gates from its children's outputs."""
    counts = {}
    gates = {}
    by_cell = {}
    for cell, out in zip(PLACE_CELLS, outs):
        for name, n in out["launches"].items():
            counts[name] = counts.get(name, 0) + n
        label = place_label(cell)
        by_cell[cell] = out
        ref = (PLACE_REF.get((out["arch"], out["profile"]))
               if out["machine"] == "tpu_v5e-512"
               and out["shape"] == "train_4k" else None)
        line = {k: v for k, v in out.items()
                if k not in ("launches", "e_record_digest", "device_order")}
        line["a"] = dict(out["a"], rounds=[
            {k: v for k, v in r.items() if k != "cpu_order"}
            for r in out["a"]["rounds"]])
        emit("place", cell=label, **line,
             reference=None if ref is None else dict(
                 ratio=ref[0], perm=ref[1], recompiles=ref[2],
                 source="EXPERIMENTS.md §Mapping-grid"))
        gates[f"a_{label}"] = out["a"]["ok"]
        gates[f"b_{label}"] = out["b_searched_le_identity"]
        if "c_identity_retrace" in out:
            gates[f"c_{label}"] = \
                out["c_identity_retrace"]["max_abs_delta"] == 0
        gates[f"d_{label}"] = not out["d_lint_errors"]
    two, ex = (by_cell[c] for c in PLACE_EXPERT_PAIR)
    tie = abs(two["host_makespan"] - ex["host_makespan"]) \
        / two["host_makespan"]
    cpu = [[(r["cpu_order"], r["cpu_makespan"]) for r in o["a"]["rounds"]]
           for o in (two, ex)]
    expert = dict(
        records_equal=two["e_record_digest"] == ex["e_record_digest"],
        cpu_searches_equal=cpu[0] == cpu[1],
        card_orders_tie_rel_f64=tie,
        card_makespan_rel=abs(two["searched"]["makespan"]
                              - ex["searched"]["makespan"])
        / two["searched"]["makespan"])
    gates["e_expert_equals_2d"] = (
        expert["records_equal"] and expert["cpu_searches_equal"]
        and tie <= PLACE_TIE and expert["card_makespan_rel"] <= PLACE_REL)
    gates["f_quotient_link_loads_launched"] = \
        counts.get("quotient_link_loads", 0) > 0
    state["launches"]["place"] = counts
    state["place_qll"] = by_cell[PLACE_QLL_CELL]["qll_at_search"]
    state["place_reports"] = {c: {k: o[k] for k in (
        "round0_ratio", "perm", "device_order", "moved_after_round0")}
        for c, o in by_cell.items()}
    emit("place", step="checks", gates=gates, launches=counts,
         expert_vs_2d=expert, qll_at_search=state["place_qll"],
         concurrency=PLACE_PARALLEL)
    failed = [k for k, ok in gates.items() if not ok]
    if failed:
        raise AssertionError(f"place checks failed: {failed}")
    _require_launched(counts, "place")

# The dryrun phase: the dry-run CLI's roofline terms over the cells place
# traced (read from place's trace cache: nothing is traced twice), anchored
# to a real step on the card. (a) the mapping grid (qwen2-1.5b and
# DeepSeek-V2-Lite at train_4k on tpu_v5e-512, every profile) through
# ``python -m repro_torch.launch.dryrun --mapping-grid``, one child per
# arch, and ``run_cell`` on place's other cells in a third child;
# (b) the anchor: qwen2-1.5b FULL train_4k at the train phase's batch on a
# (1, 1) mesh, its meta trace's record against the same step run once on
# the card under the same recorder; (c) ``lint_cell`` on the grid's cells.
DRYRUN_OTHER = (("pna", "minibatch_lg", "tpu_v5e-512", "2d"),
                ("two-tower-retrieval", "train_batch", "tpu_v5e-512", "2d"),
                ("qwen2-1.5b", "train_4k", "gpu-superpod", "2d"),
                ("qwen2-1.5b", "decode_32k", "gpu-superpod", "2d"))
DRYRUN_GRID_ARCHS = ("qwen2-1.5b", "deepseek-v2-lite-16b")
DRYRUN_ANCHOR = ("qwen2-1.5b", "train_4k", {"batch": TRAIN_BATCH[0]})
DRYRUN_COUNT_REL = 1e-9   # (b): the card step's counts against the trace's
DRYRUN_MEM_BAND = (0.85, 1.15)   # predicted peak / max_memory_allocated
DRYRUN_BOUND_SHARE = 1.05        # step_time_bound_s / median warm step
DRYRUN_WARM_STEPS = 3
DRYRUN_TIMEOUT_S = 300
# the reference's result keys of run_cell (src/repro/launch/dryrun.py),
# with "mapping" where the cell was searched
DRYRUN_KEYS = ("arch", "shape", "mesh", "machine", "kind", "tag", "profile",
               "status", "chips", "compile_s", "calibrate_s", "cache_hit",
               "per_device", "total", "agg_once", "hlo_cost",
               "memory_analysis", "model_flops", "useful_ratio",
               "roofline_terms", "dominant", "step_time_bound_s",
               "roofline_fraction", "scan_lengths")


def lm_attention_sites(cfg, b: int, s: int) -> dict:
    """The attention declarations of one train step on one device holding
    the whole batch: per layer the forward (twice with remat: the
    checkpoint's recompute) and the backward, each at
    ``cost_sites.attention_cost`` of the cell's shapes: ``{count,
    flops}``. A record whose attention site was not counted differs."""
    import torch

    from repro_torch.kernels.cost_sites import attention_cost
    d = dv = cfg.head_dim
    if cfg.mla:
        d = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
        dv = cfg.v_head_dim
    args = (b, s, s, cfg.n_heads, cfg.n_kv_heads, d, dv,
            torch.empty((), dtype=cfg.dtype).element_size(), cfg.q_chunk,
            cfg.kv_chunk)
    n_fwd = cfg.n_layers * (2 if cfg.remat else 1)
    return {"count": n_fwd + cfg.n_layers,
            "flops": n_fwd * attention_cost(*args)["flops"]
            + cfg.n_layers * attention_cost(*args, True)["flops"]}


def lm_product_flops(cfg, b: int, s: int, devices: int = 1,
                     early_stop: bool = False) -> float:
    """The closed form of a dense LM train step's product FLOPs on one of
    ``devices`` devices that split every product evenly (the sp profile):
    2 per parameter and token forward, 4 backward, and with remat the
    layers' forward once more; the attention's own products are a declared
    kernel site, not products here. ``early_stop``: torch's non-reentrant
    checkpoint stops a layer's recompute once every tensor its backward
    saved is back, so on plain tensors the down projection's product (its
    output is saved by nobody) is not recomputed; on DTensors it is."""
    d, h, kh, dh, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                       cfg.head_dim, cfg.d_ff)
    layer = d * h * dh + 2 * d * kh * dh + h * dh * d + 3 * d * f
    mm = cfg.n_layers * layer + d * cfg.vocab
    tokens = float(b) * s
    remat = cfg.n_layers * (layer - (f * d if early_stop else 0)) \
        if cfg.remat else 0
    return 2.0 * tokens * (3.0 * mm + remat) / devices


def dryrun_grid_child(arch: str, cache_dir: str, out_dir: str) -> None:
    """One arch's mapping grid through the dry-run CLI (its entry point;
    the searches on the identity trace, no retrace), with the launch
    counts set to 0 just before it; prints one JSON line: the counts and
    the seconds."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    torch.zeros(1, device="cuda")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    dryrun.main(["--mapping-grid", "--arch", arch, "--cache-dir", cache_dir,
                 "--out", out_dir, "--lint"])
    torch.cuda.synchronize()
    print(json.dumps({"launches": ops.launch_counts(),
                      "seconds": time.perf_counter() - t0}), flush=True)


def dryrun_cells_child(cache_dir: str, out_dir: str) -> None:
    """``run_cell`` on ``DRYRUN_OTHER`` (searched, from the trace cache),
    the launch counts set to 0 just before; the results go to
    ``out_dir`` (``_emit``'s files) and one JSON line of the counts, the
    seconds and the traces is printed."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.launch.placement import PlacementSession
    torch.zeros(1, device="cuda")
    session = PlacementSession(cache_dir=cache_dir, device=None)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for arch, shape, machine, prof in DRYRUN_OTHER:
        dryrun.run_cell(arch, shape, False, out_dir, profile=prof,
                        topology_aware=True, session=session,
                        machine=machine)
    torch.cuda.synchronize()
    print(json.dumps({"launches": ops.launch_counts(),
                      "seconds": time.perf_counter() - t0,
                      "traces": session.n_compiles}), flush=True)


def dryrun_lint_child(arch: str) -> None:
    """``lint_cell`` on every profile of ``arch`` at train_4k (the spec
    trees, then the upcasts of the step traced on one device); prints one
    JSON line per cell's findings."""
    from repro_torch import configs
    from repro_torch.analysis import counts, shard_lint
    out = {}
    for prof in configs.get(arch).profiles:
        t0 = time.perf_counter()
        f = shard_lint.lint_cell(arch, "train_4k", profile=prof)
        out[prof] = dict(counts=counts(f), seconds=time.perf_counter() - t0,
                         errors=[x.message for x in f
                                 if x.severity == "error"],
                         warnings=[x.message[:160] for x in f
                                   if x.severity == "warning"])
    print(json.dumps(out), flush=True)


def _dryrun_line(r) -> dict:
    """The per-cell line: the three terms, the dominant one, the useful
    ratio, and per device the FLOPs, tight bytes and peak bytes."""
    mem = r["memory_analysis"]
    return dict(terms=r["roofline_terms"], dominant=r["dominant"],
                useful_ratio=r["useful_ratio"],
                flops_per_device=r["per_device"]["flops"],
                bytes_tight_per_device=r["per_device"]["bytes"],
                peak_bytes_per_device=mem["argument_bytes"]
                + mem["temp_bytes"],
                memory=mem, step_time_bound_s=r["step_time_bound_s"],
                cache_hit=r["cache_hit"], hlo_cost=r["hlo_cost"])


def _dryrun_cell_ok(r) -> bool:
    """Status ok, the reference's keys, finite counts, FLOPs and tight
    bytes above 0."""
    import math
    cal = r.get("hlo_cost", {})
    return (r.get("status") == "ok" and all(k in r for k in DRYRUN_KEYS)
            and all(math.isfinite(v) for v in cal.values())
            and cal.get("flops", 0) > 0 and cal.get("bytes_tight", 0) > 0)


def _mapping_matches_place(state, cell, report, traffic, topo) -> dict:
    """A dry-run mapping report (the search on the identity trace) against
    place's round 0 for the same cell, the same search on the same record:
    the ratio within ``PLACE_REL``, and the perm equal, or the two orders
    tied in float64 on the host (the card's float atomics break exact ties
    either way, as place's gate (a) allows). Where place's retrace moved
    the order after round 0, only the ratio is compared."""
    ref = state.get("place_reports", {}).get(cell)
    if ref is None:
        return dict(compared=False, ok=True)
    want = ref["round0_ratio"]
    rel = abs(report["makespan_ratio"] - want) / max(want, 1e-30)
    same = list(report["axis_perm"]) == list(ref["perm"])
    tie = 0.0
    if not same and not ref["moved_after_round0"]:
        a = host_map_makespan(traffic, topo, report["device_order"])
        b = host_map_makespan(traffic, topo, ref["device_order"])
        tie = abs(a - b) / max(b, 1e-30)
    return dict(compared=True, ratio=report["makespan_ratio"],
                place_round0_ratio=want, ratio_rel=rel,
                perm=report["axis_perm"], place_perm=ref["perm"],
                perm_equal=same, tie_rel_f64=tie,
                ok=rel <= PLACE_REL and (same or tie <= PLACE_TIE
                                         or ref["moved_after_round0"]))


def _planted_recorders():
    """The two planted faults of anchor (b), as recorders: one that never
    frees a storage, and one that drops the attention site's
    declarations."""
    from repro_torch.launch.op_cost import OpCostRecorder

    class FreesIgnored(OpCostRecorder):
        def _free(self, key):
            pass

    class AttentionUncounted(OpCostRecorder):
        def _declare(self, site, declared):
            if site != "flash_attention":
                super()._declare(site, declared)
    return FreesIgnored(), AttentionUncounted()


def _anchor(state, checks) -> dict:
    """(b): the (1, 1) meta record of ``DRYRUN_ANCHOR`` against its step
    run once on the card under the same recorder (params from ``init``,
    seed 0), the memory band, the bound share over the median of
    ``DRYRUN_WARM_STEPS`` warm steps, the attention's declarations
    (``lm_attention_sites``), and the two planted faults, recorded on the
    same card step beside the true recorder."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.core.machine import MachineSpec
    from repro_torch.launch import dryrun, op_cost
    from repro_torch.launch.placement import PlacementSession
    arch_name, shape_name, over = DRYRUN_ANCHOR
    arch = configs.get(arch_name)
    session = PlacementSession(cache_dir="", device=None)
    t0 = time.perf_counter()
    meta = session.measure(arch_name, shape_name, mesh_shape=(1, 1),
                           axes=("data", "model"), overrides=over)
    meta_s = time.perf_counter() - t0
    cell, args = dryrun.lm_train_args(arch_name, shape_name, over,
                                      device=None, seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    card = op_cost.OpCostRecorder()
    no_frees, no_attention = _planted_recorders()
    for rec in (card, no_frees, no_attention):
        rec.arguments(*args)
    t0 = time.perf_counter()
    with card, no_frees, no_attention:
        out = cell["step"](*args)
    torch.cuda.synchronize()
    recorded_s = time.perf_counter() - t0
    for rec in (card, no_frees, no_attention):
        rec.outputs(out)
    peak = torch.cuda.max_memory_allocated()
    del out
    warm = []
    for _ in range(DRYRUN_WARM_STEPS):
        t0 = time.perf_counter()
        out = cell["step"](*args)
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
        del out
    del args
    torch.cuda.empty_cache()
    keys = ("flops", "bytes", "bytes_tight", "transcendentals")
    rel = {k: abs(card.totals[k] - meta.hlo_cal[k])
           / max(abs(meta.hlo_cal[k]), 1.0) for k in keys}
    checks["b_counts_agree"] = max(rel.values()) <= DRYRUN_COUNT_REL
    mem = meta.memory
    predicted = mem["argument_bytes"] + mem["temp_bytes"]
    share_mem = predicted / peak
    checks["b_memory_band"] = (DRYRUN_MEM_BAND[0] <= share_mem
                               <= DRYRUN_MEM_BAND[1])
    spec = MachineSpec.preset("gpu-superpod")
    compute_s = meta.hlo_cal["flops"] / float(spec.peak_flops.max())
    memory_s = meta.hlo_cal["bytes_tight"] / float(spec.hbm_bw.max())
    bound = max(compute_s, memory_s)
    median = float(np.median(warm))
    share = bound / median
    checks["b_bound_share"] = share <= DRYRUN_BOUND_SHARE
    cfg = arch.make_config(shape_name)
    b, s = over["batch"], arch.shapes[shape_name].meta["seq"]
    closed = lm_attention_sites(cfg, b, s)

    def declared(sites):
        site = sites.get("flash_attention", {})
        return (site.get("count", 0) == closed["count"]
                and abs(site.get("flops", 0.0) - closed["flops"])
                <= DRYRUN_COUNT_REL * closed["flops"])
    attn = meta.ops["sites"].get("flash_attention", {})
    checks["b_attention_declarations"] = declared(meta.ops["sites"])

    # the planted faults, recorded on the same card step: the recorder
    # ignoring frees, and the attention site's count switched off
    bad_mem = no_frees.memory()
    bad_share = (bad_mem["argument_bytes"] + bad_mem["temp_bytes"]) / peak
    bad_attn = no_attention.sites.get("flash_attention", {})
    checks["b_planted_frees_ignored_fails_band"] = not (
        DRYRUN_MEM_BAND[0] <= bad_share <= DRYRUN_MEM_BAND[1])
    checks["b_planted_site_off_fails_declarations"] = not declared(
        no_attention.sites)
    return dict(cell=f"{arch_name}/{shape_name}", overrides=over,
                mesh=[1, 1], meta_trace_s=meta_s, recorded_step_s=recorded_s,
                warm_step_s=warm, warm_step_median_s=median,
                counts_meta={k: meta.hlo_cal[k] for k in keys},
                counts_card={k: card.totals[k] for k in keys},
                counts_rel=rel, memory_predicted=mem,
                predicted_peak_bytes=predicted,
                max_memory_allocated=peak, memory_share=share_mem,
                step_time_bound_s=bound,
                terms={"compute_s": compute_s, "memory_s": memory_s},
                bound_share=share, capacities=dict(
                    machine="gpu-superpod",
                    peak_flops=float(spec.peak_flops.max()),
                    hbm_bw=float(spec.hbm_bw.max())),
                attention=attn, attention_closed_form=closed,
                sites=meta.ops["sites"], unclassified=meta.ops[
                    "unclassified"],
                planted=dict(frees_ignored_memory_share=bad_share,
                             site_off_attention=bad_attn))


def phase_dryrun(state):
    """The dry-run CLI's roofline terms (``launch/dryrun.py`` over the
    op-cost recorder, ``launch/op_cost.py``), anchored to a real step on
    the card. (a) the mapping grid in two children of the CLI and
    ``run_cell`` on place's other cells (``DRYRUN_OTHER``) in a third, all
    from place's trace cache (nothing traced): each ``status: ok`` with the
    reference's keys, finite counts, FLOPs and tight bytes above 0, its
    perm and ratio those of place's round 0 for the same cell (up to a
    float64 tie), and ``quotient_link_loads`` launched; (b) ``_anchor``'s
    gates, run while the children work (its step launches
    ``flash_attention``); (c) ``lint_cell`` on the grid's cells (two more
    children): no error. The launch counts are set to 0 before (b) and
    read after (a); the children count their own."""
    import os
    import re
    import tempfile

    import torch

    from repro_torch import configs
    from repro_torch.core.machine import MachineSpec
    from repro_torch.kernels import ops
    from repro_torch.launch.placement import PlacementSession
    cache = state.get("place_cache") or tempfile.mkdtemp(prefix="dryrun_")
    out_dir = tempfile.mkdtemp(prefix="dryrun_out_")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    checks = {}
    children = {}
    t_phase = time.perf_counter()
    children[("grid", "other")] = subprocess.Popen(
        [sys.executable, "-c", f"import chip_smoke; chip_smoke."
         f"dryrun_cells_child({cache!r}, {out_dir!r})"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    for arch in DRYRUN_GRID_ARCHS:
        children[("grid", arch)] = subprocess.Popen(
            [sys.executable, "-c", f"import chip_smoke; chip_smoke."
             f"dryrun_grid_child({arch!r}, {cache!r}, {out_dir!r})"],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        children[("lint", arch)] = subprocess.Popen(
            [sys.executable, "-c",
             f"import chip_smoke; chip_smoke.dryrun_lint_child({arch!r})"],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
    results = {}
    try:
        # (b) the card anchor while the children trace and search (their
        # host work shares the cores with its warm steps, whose time the
        # bound is held under)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        anchor = _anchor(state, checks)
        anchor_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        outs = {}
        for key, p in children.items():
            try:
                stdout, stderr = p.communicate(timeout=DRYRUN_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                raise AssertionError(f"dryrun child {key} ran past "
                                     f"{DRYRUN_TIMEOUT_S} s")
            lines = [ln for ln in stdout.splitlines() if ln.startswith("{")]
            if p.returncode != 0 or not lines:
                raise AssertionError(f"dryrun child {key} failed "
                                     f"({p.returncode}): {stderr[-3000:]}"
                                     f"{stdout[-2000:]}")
            outs[key] = json.loads(lines[-1])
            if key[0] == "grid" and key[1] != "other":
                outs[key]["traces"] = sum(int(h) for h in re.findall(
                    r"\[CACHE\] compiles=(\d+)", stdout))
    finally:
        for p in children.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    children_s = time.perf_counter() - t_phase
    grid = ("other",) + DRYRUN_GRID_ARCHS
    for arch in grid:
        for name, n in outs[("grid", arch)]["launches"].items():
            counts[name] = counts.get(name, 0) + n
    for arch, shape, machine, prof in DRYRUN_OTHER:
        tag = (machine if machine not in ("tpu_v5e-256", "tpu_v5e-512")
               else "2x16x16")
        with open(os.path.join(out_dir, f"{arch}__{shape}__{tag}.json")) as f:
            results[(arch, shape, machine, prof)] = json.load(f)
    for arch in DRYRUN_GRID_ARCHS:
        for prof in configs.get(arch).profiles:
            path = os.path.join(out_dir, f"{arch}__train_4k__2x16x16"
                                         f"__map_{prof}.json")
            with open(path) as f:
                results[(arch, "train_4k", "tpu_v5e-512", prof)] = \
                    json.load(f)
    reader = PlacementSession(cache_dir=cache, device=None)
    for cell, r in results.items():
        label = place_label(cell)
        arch, shape, machine, prof = cell
        spec = MachineSpec.preset(machine)
        rec = reader.measure(arch, shape, profile=prof, machine=machine)
        match = _mapping_matches_place(state, cell, r["mapping"],
                                       rec.traffic, spec.topology())
        checks[f"a_{label}"] = _dryrun_cell_ok(r) and match["ok"]
        emit("dryrun", cell=label, **_dryrun_line(r), mapping=match,
             unclassified=rec.ops.get("unclassified"))
    # nothing is traced: every record comes from place's cache
    traces = {place_label(c): r["mapping"]["n_compiles"]
              for c, r in results.items()}
    checks["a_no_trace_twice"] = (reader.n_compiles == 0 and not any(
        traces.values()) and not any(outs[("grid", a)]["traces"]
                                     for a in grid))
    state["launches"]["dryrun"] = counts
    checks["a_quotient_link_loads_launched"] = \
        counts.get("quotient_link_loads", 0) > 0

    # (c) lint_cell on the grid's cells
    lint = {}
    for arch in DRYRUN_GRID_ARCHS:
        for prof, v in outs[("lint", arch)].items():
            lint[f"{arch}/train_4k/{prof}"] = v
            checks[f"c_{arch}/{prof}_no_error"] = not v["errors"]

    qll = state.get("place_qll")
    qll_bound = None
    if qll:
        topo = MachineSpec.preset("tpu_v5e-512").topology()
        import numpy as np
        nnz = float(np.count_nonzero(topo.subtree))
        m, n, k, links = qll["arcs"], qll["vertices"], qll["k"], qll["links"]
        qbytes = 12.0 * m + 4.0 * n + 4.0 * links * k + 8.0 * links
        qflops = float(m) + 4.0 * k * nnz + 2.0 * links
        qll_bound = dict(arcs=m, vertices=n, k=k, links=links,
                         bytes=qbytes, flops=qflops,
                         bound_ms=1e3 * max(qbytes / H100_BYTES_PER_S,
                                            qflops / H100_F32_PER_S),
                         bound_by=("bytes" if qbytes / H100_BYTES_PER_S
                                   >= qflops / H100_F32_PER_S
                                   else "operations"),
                         ms=qll["ms"])
    emit("dryrun", step="checks", checks=checks, launches=counts,
         anchor=anchor, lint=lint, qll_at_search_bound=qll_bound,
         grid_children={a: outs[("grid", a)]["seconds"] for a in grid},
         grid_traces={a: outs[("grid", a)]["traces"] for a in grid},
         traces_by_cell=traces,
         children_s=children_s, anchor_s=anchor_s,
         budget_s=90, nvidia_smi=state["smi"])
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"dryrun checks failed: {failed}")
    _require_launched(counts, "dryrun")



# the full-width plans the kernel_plans phase must find among those this
# process launched: (kernel module, a predicate on the plan)
KERNEL_PLANS_FULL_WIDTH = {
    "flash 4 x 4,096 at D = 128": ("flash_attention", lambda p: (
        p.operands[0].shape[:2] == (4, 4096) and p.operands[0].shape[3] == 128
        and p.args["path"] == "wgmma")),
    "flash at (192, 128)": ("flash_attention", lambda p: (
        p.operands[0].shape[3] == 192 and p.operands[2].shape[3] == 128)),
    "bsr_spmm bulk layout": ("bsr_spmm", lambda p: (
        p.outputs[0].shape[0] == GNN_BULK_BLOCK_ROWS * 128)),
    "gather_combine serve_bulk": ("gather_combine", lambda p: (
        p.outputs[0].shape[0] == 262_144)),
    "quotient_link_loads k = 512": ("quotient_link_loads", lambda p: (
        p.operands[4].shape[1] == 512)),
}
GNN_BULK_BLOCK_ROWS = 3840


def _sentinel(shape, dtype, dev):
    """An output filled with a sentinel no kernel writes: NaN, or the int32
    minimum for integer outputs."""
    import torch
    if dtype.is_floating_point:
        return torch.full(shape, float("nan"), dtype=dtype, device=dev)
    return torch.full(shape, torch.iinfo(dtype).min, dtype=dtype, device=dev)


def _left(t) -> int:
    """Sentinel elements left in ``t``."""
    import torch
    if t.dtype.is_floating_point:
        return int(torch.isnan(t).sum())
    return int((t == torch.iinfo(t.dtype).min).sum())


def plan_case(p, dev, gen):
    """Inputs at example plan ``p``'s shapes and three callables: ``launch
    (outs)`` launches ``p`` itself into the given outputs, ``wrapper()`` the
    public wrapper on the same inputs, ``plain()`` the plain version; and
    ``band(got, want)`` -> (ok, tolerance) against the plain version (the
    kernels phase's bands). Returns (outputs' (shape, dtype), launch,
    wrapper, plain, band, bitwise): ``bitwise`` False where the wrapper
    may differ in the last bits (float atomics)."""
    import torch

    from repro_torch.kernels import (bag_combine, bsr_spmm, bucket_assign,
                                     flash_attention, gather_combine,
                                     match_keys, partition_gain,
                                     quotient_link_loads)
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "int32": torch.int32}
    shapes = [(o.shape, dt[o.dtype]) for o in p.outputs]

    def rnd(*shape, dtype=torch.float32):
        return torch.rand(shape, generator=gen, device=dev).to(dtype)

    def ints(hi, *shape):
        return torch.randint(0, hi, shape, generator=gen, device=dev,
                             dtype=torch.int32)

    def close(rtol, atol):
        def band(got, want):
            err = (got.double() - want.double()).abs()
            lim = atol + rtol * want.double().abs()
            return bool((err <= lim).all()), f"rtol {rtol}, atol {atol}"
        return band

    def exact(got, want):
        return torch.equal(got, want), "bitwise"

    e = p.entry
    if e == "partition_gain":
        (n, d), k = p.operands[1].shape, p.outputs[0].shape[1]
        part, idx, w = ints(k, n), ints(n + 1, n, d), rnd(n, d)
        w = torch.where(idx == n, torch.zeros_like(w), w)
        return (shapes, lambda o: partition_gain.launch(p, part, idx, w, *o),
                lambda: partition_gain.partition_gain(part, idx, w, k),
                lambda: partition_gain.plain(part, idx, w, k),
                close(1e-5, 1e-5), True)
    if e == "quotient_link_loads":
        n, m = p.operands[0].shape[0], p.operands[1].shape[0]
        nl, k = p.operands[4].shape
        part, s, r = ints(k, n), ints(n, m), ints(n, m)
        w, sub, fl = rnd(m), (rnd(nl, k) > 0.5).float(), rnd(nl)
        work = torch.zeros(2 * k * k + 2, device=dev)

        def wrapper():
            out, W = quotient_link_loads.loads_and_quotient(part, s, r, w,
                                                            sub, fl, k)
            return W.reshape(-1), out

        def plain():
            out, W = quotient_link_loads._plain_with_quotient(
                part, s, r, w, sub, fl, k)
            return W.reshape(-1), out
        return (shapes, lambda o: quotient_link_loads.launch(
                    p, part, s, r, w, sub, fl, *o, work, 0),
                wrapper, plain, close(1e-4, 1e-3), False)
    if e == "match_keys":
        m = p.operands[0].shape[0]
        w, u, mask = rnd(m), rnd(m), (rnd(m) > 0.4).float()
        return (shapes, lambda o: match_keys.launch(p, w, u, mask, *o),
                lambda: match_keys.match_keys(w, u, mask),
                lambda: match_keys.plain(w, u, mask), exact, True)
    if e == "match_round":
        m, n = p.operands[0].shape[0], p.operands[4].shape[0]
        s = torch.sort(ints(n, m))[0]
        r, w, u = ints(n, m), rnd(m) - 0.1, rnd(m)
        matched = rnd(n) > 0.8
        words = torch.zeros(max(n, 1024) + 1, dtype=torch.int64, device=dev)
        return (shapes, lambda o: match_keys.launch_round(
                    p, s, r, w, u, matched, *o, words),
                lambda: match_keys.match_round(s, r, w, u, matched),
                lambda: match_keys.match_round_plain(s, r, w, u, matched),
                exact, True)
    if e == "bucket_assign":
        n, nb = p.operands[0].shape[0], p.operands[1].shape[0]
        cum, bounds = rnd(n) * nb, torch.sort(rnd(nb) * nb)[0]
        return (shapes, lambda o: bucket_assign.launch(p, cum, bounds, *o,
                                                       nb + 1),
                lambda: bucket_assign.bucket_assign(cum, bounds, nb + 1),
                lambda: bucket_assign.plain(cum, bounds, nb + 1), exact, True)
    if e == "prefix_split":
        n, nb = p.operands[0].shape[0], p.operands[1].shape[0]
        nw = torch.randint(1, 9, (n,), generator=gen, device=dev).float()
        bounds = torch.sort(rnd(nb) * float(nw.sum()))[0]
        work = torch.zeros(p.operands[2].shape, dtype=torch.int32,
                           device=dev)
        return (shapes, lambda o: bucket_assign.launch_split(
                    p, nw, bounds, *o, work, nb + 1),
                lambda: bucket_assign.prefix_split(nw, bounds, nb + 1),
                lambda: bucket_assign.prefix_split_plain(nw, bounds, nb + 1),
                exact, True)
    if e in ("bag_combine", "gather_combine"):
        b, f = p.outputs[0].shape
        d = p.operands[-1].shape[1]
        dtype = dt[p.outputs[0].dtype]
        if e == "bag_combine":
            rows, w = rnd(b, d, f, dtype=dtype), rnd(b, d, dtype=dtype)
            launch = (lambda o: bag_combine.launch(p, rows, w, *o))
            wrapper = (lambda: bag_combine.bag_combine(rows, w))
            plain = (lambda: bag_combine.plain(rows, w))
            tol = bag_combine.order_tolerance(rows.float(), w.float())
        else:
            table = rnd(p.operands[0].shape[0], f, dtype=dtype)
            idx, w = ints(table.shape[0], b, d), rnd(b, d)
            launch = (lambda o: gather_combine.launch(p, table, idx, w, *o))
            wrapper = (lambda: gather_combine.gather_combine(table, idx, w))
            plain = (lambda: gather_combine.plain(table, idx, w))
            tol = bag_combine.order_tolerance(table[idx].float(), w)

        def band(got, want):
            lim = tol + 1e-6 * want.double().abs()
            if dtype == torch.bfloat16:
                lim = lim + bf16_ulp(want)
            ok = bool(((got.double() - want.double()).abs() <= lim).all())
            return ok, (BF16_BAG_TOLERANCE if dtype == torch.bfloat16
                        else BAG_TOLERANCE)
        return shapes, launch, wrapper, plain, band, True
    if e == "bsr_spmm":
        nbr = p.operands[0].shape[0] - 1
        nnzb, r, _ = p.operands[3].shape
        nbc = p.operands[4].shape[0] // r
        counts = torch.full((nbr,), nnzb // nbr, dtype=torch.int64)
        counts[:nnzb % nbr] += 1
        row_ptr = torch.zeros(nbr + 1, dtype=torch.int32)
        row_ptr[1:] = torch.cumsum(counts, 0).int()
        cols = torch.cat([(torch.arange(c) * 7 + i) % nbc
                          for i, c in enumerate(counts.tolist())])
        cols = torch.cat([torch.sort(cols[a:b])[0] for a, b in zip(
            row_ptr[:-1].tolist(), row_ptr[1:].tolist())]).int()
        row_ptr, cols = row_ptr.to(dev), cols.to(dev)
        blocks = rnd(nnzb, r, r) * (rnd(nnzb, r, r) > 0.9)
        occ = bsr_spmm.slab_occupancy(blocks)
        x = rnd(nbc * r, p.outputs[0].shape[1])
        args = (row_ptr, cols, blocks, x)
        tol = bsr_spmm.order_tolerance(*args)

        def band(got, want):
            lim = tol + 1e-6 * want.double().abs()
            return (bool(((got.double() - want.double()).abs()
                          <= lim).all()), BSR_TOLERANCE)
        return (shapes, lambda o: bsr_spmm.launch(p, row_ptr, cols, occ,
                                                  blocks, x, *o),
                lambda: bsr_spmm.bsr_spmm(row_ptr, cols, blocks, x, occ),
                lambda: bsr_spmm.plain(*args), band, True)
    if e == "flash_attention":
        dtype = dt[p.operands[0].dtype]
        q, k, v = (torch.randn(a.shape, generator=gen, device=dev).to(dtype)
                   for a in p.operands)
        lse = len(p.outputs) > 1
        from repro_torch.models.common import flash_attention_fwd

        def launch(o):
            flash_attention.launch(p, q, k, v, o[0], o[1] if lse else None,
                                   True)

        def wrapper():
            got = flash_attention.flash_attention(q, k, v, causal=True,
                                                  return_lse=lse)
            return got if lse else (got,)

        def plain():
            out, l_ = flash_attention_fwd(q, k, v, causal=True)
            return (out, l_) if lse else (out,)

        def band(got, want):
            if dtype == torch.float32:
                return close(FLASH_F32_TOL, FLASH_F32_TOL)(got, want)
            if got.dim() == 3:          # bf16 inputs' log-sum-exp
                return close(1e-2, 1e-2)(got, want)
            ok, tol, _ = flash_bf16_judge(q, k, v, got, want, 512, 512)
            return ok, tol
        return shapes, launch, wrapper, plain, band, True
    raise ValueError(f"kernel_plans: no case for entry {e!r}")


def start_analysis_cli(state):
    """``python -m repro_torch.analysis --suite all --no-trace --json`` in a
    child process, for ``kernel_plans`` (e); started where the host is idle
    (lm100m's example trains on the card in a process of its own), as it
    takes ~20 s of host time on the card's machine, and waited for in
    ``kernel_plans``. Returns the child; ``state['analysis_cli']`` holds
    it with its JSON path and log."""
    import os
    import tempfile
    out_dir = tempfile.mkdtemp(prefix="kernel_plans_")
    log = open(os.path.join(out_dir, "analysis.log"), "w")
    path = os.path.join(out_dir, "analysis.json")
    child = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.analysis", "--suite", "all",
         "--no-trace", "--json", path, "--quiet"], stdout=log,
        stderr=subprocess.STDOUT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    state["analysis_cli"] = (child, path, log, time.perf_counter())
    return child


def stop_analysis_cli(state):
    """Kill the analysis child if it still runs and close its log."""
    got = state.pop("analysis_cli", None)
    if got is not None:
        child, _, log, _ = got
        if child.poll() is None:
            child.kill()
            child.wait()
        log.close()


def phase_kernel_plans(state):
    """The launch plans (``kernels/plan.py``) checked against the card.
    (a) every distinct plan this process built on its paths, read from the
    plan caches (the full-width ones among them, ``KERNEL_PLANS_FULL_WIDTH``),
    verifies under the card's own ``DeviceModel`` with no error and no
    warning; (b) each kernel instance's ``cudaFuncGetAttributes``:
    static + dynamic shared memory within the card's opt-in limit at every
    plan, threads within its maximum, and every cooperative plan's
    residency on the card at least what the static ``co-residency`` check
    assumed; (c) every registered example plan launched into outputs
    filled with a sentinel (NaN, or the int32 minimum): none left,
    bitwise the public wrapper's output (``quotient_link_loads``, whose
    float atomics sum in any order: within its band) and within the
    kernels phase's band of the plain version; (d) two planted faults,
    each failing both ways: ``partition_gain``'s example one block short
    (the static ``coverage`` error; sentinels left on the card) and a
    cooperative ``quotient_link_loads`` plan one block past the card's
    residency (the static ``co-residency`` error; the launcher refuses it,
    nothing clipped); (e) ``python -m repro_torch.analysis --suite all
    --no-trace --json`` in a child process (``start_analysis_cli``, from
    lm100m's start when the phases run in order; the sharding suite's
    meta traces are the dryrun phase's ``lint_cell`` children's already),
    exit 0."""
    import collections

    import torch

    from repro_torch.analysis import kernels as akernels
    from repro_torch.kernels import KERNEL_REGISTRY, build
    from repro_torch.kernels import plan as plan_lib
    from repro_torch.kernels import quotient_link_loads as qll
    dev = torch.device("cuda")
    model = plan_lib.device_model(dev)
    t0 = time.perf_counter()
    if "analysis_cli" not in state:
        start_analysis_cli(state)
    cli, cli_json, _, cli_t0 = state["analysis_cli"]
    try:
        bad = []
        # (a) the plans this process launched
        launched = plan_lib.cached_plans()
        by_kernel = collections.Counter(p.name for p in launched)
        for label, (name, pred) in KERNEL_PLANS_FULL_WIDTH.items():
            if not any(p.name == name and pred(p) for p in launched):
                bad.append(f"(a) no {label} plan among those launched")
        worst = collections.Counter()
        for p in launched:
            for f in akernels.verify_plan(p, device=model):
                if f.severity != "info":
                    worst[f.severity] += 1
                    bad.append(f"(a) {f.format()}")
                elif f.check == "grid-sampled":
                    worst["sampled"] += 1
        emit("kernel_plans", step="launched", plans=len(launched),
             by_kernel=dict(by_kernel), errors=worst["error"],
             warnings=worst["warning"], sampled=worst["sampled"],
             device_model=dataclasses.asdict(model),
             seconds=time.perf_counter() - t0)
        # (b) the card's own answers about every kernel instance
        examples = {n: f() for n, f in KERNEL_REGISTRY.items()}
        every = launched + [p for ps in examples.values() for p in ps]
        attrs, residency = {}, []
        for p in every:
            key = (p.entry, p.kernel)
            if key not in attrs:
                attrs[key] = build.func_attributes(*key)
            a = attrs[key]
            if a["static_smem"] + p.dyn_smem > model.smem_block_optin:
                bad.append(f"(b) {p.kernel}: {a['static_smem']} + "
                           f"{p.dyn_smem} B of shared memory")
            if p.block_threads > a["max_threads"]:
                bad.append(f"(b) {p.kernel}: {p.block_threads} threads, at "
                           f"most {a['max_threads']}")
            if p.cooperative:
                have = build.occupancy(p.entry, p.kernel, p.block_threads,
                                       p.dyn_smem)
                want = model.resident_blocks(p.block_threads, p.dyn_smem,
                                             p.min_blocks_per_sm)
                residency.append(dict(kernel=p.kernel, grid=list(p.grid),
                                      threads=p.block_threads,
                                      smem=p.dyn_smem, card_per_sm=have,
                                      assumed_per_sm=want))
                if have < want:
                    bad.append(f"(b) {p.kernel}: {have} blocks an SM on the "
                               f"card, the static check assumed {want}")
        emit("kernel_plans", step="attributes",
             kernels={f"{e}:{k}": a for (e, k), a in attrs.items()},
             residency=[json.loads(r) for r in sorted(
                 {json.dumps(r, sort_keys=True) for r in residency})],
             seconds=time.perf_counter() - t0)
        # (c) every example plan on the card, outputs filled with sentinels
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        rows = []
        for name, plans in examples.items():
            for p in plans:
                shapes, launch, wrapper, plain, band, bitwise = plan_case(
                    p, dev, gen)
                outs = [_sentinel(s_, d_, dev) for s_, d_ in shapes]
                launch(outs)
                torch.cuda.synchronize()
                left = sum(_left(o) for o in outs)
                ref = wrapper()
                ref = ref if isinstance(ref, tuple) else (ref,)
                want = plain()
                want = want if isinstance(want, tuple) else (want,)
                same = all(torch.equal(o.reshape(r.shape), r)
                           for o, r in zip(outs, ref)) if bitwise else None
                wrap_ok = same if bitwise else all(
                    band(o.reshape(r.shape), r)[0] for o, r in zip(outs, ref))
                in_band = [band(o.reshape(w.shape), w) for o, w in
                           zip(outs, want)]
                ok = left == 0 and wrap_ok and all(b for b, _ in in_band)
                rows.append(dict(kernel=name, entry=p.entry,
                                 instance=p.kernel, grid=list(p.grid),
                                 threads=list(p.threads), smem=p.dyn_smem,
                                 sentinels_left=left, bitwise_wrapper=same,
                                 band=in_band[0][1], ok=ok))
                if not ok:
                    bad.append(f"(c) {p.kernel} at grid {p.grid}: "
                               f"{left} sentinels left, wrapper "
                               f"{'equal' if wrap_ok else 'differs'}, band "
                               f"{[b for b, _ in in_band]}")
        emit("kernel_plans", step="coverage", plans=len(rows),
             failed=[r for r in rows if not r["ok"]],
             seconds=time.perf_counter() - t0)
        # (d) two planted faults, each failing both ways
        pg = examples["partition_gain"][0]
        short = dataclasses.replace(pg, grid=(pg.grid[0] - 1,))
        static_short = [f.check for f in akernels.verify_plan(
            short, device=model) if f.severity == "error"]
        shapes, launch, *_ = plan_case(short, dev, gen)
        outs = [_sentinel(s_, d_, dev) for s_, d_ in shapes]
        launch(outs)
        torch.cuda.synchronize()
        short_left = sum(_left(o) for o in outs)
        big = next(p for p in examples["quotient_link_loads"]
                   if p.blocks > 1)
        per_sm = build.occupancy(big.entry, big.kernel, big.block_threads,
                                 big.dyn_smem)
        m, n = big.operands[1].shape[0], big.operands[0].shape[0]
        nl, k = big.operands[4].shape
        past = qll._plan(m, n, k, nl, dev, blocks=per_sm * model.sms + 1)
        static_past = [f.check for f in akernels.verify_plan(
            past, device=model) if f.severity == "error"]
        shapes, launch, *_ = plan_case(past, dev, gen)
        outs = [_sentinel(s_, d_, dev) for s_, d_ in shapes]
        try:
            launch(outs)
            torch.cuda.synchronize()
            refused = None
        except RuntimeError as e:
            refused = str(e)
        emit("kernel_plans", step="planted",
             short_grid=dict(grid=list(short.grid), static=static_short,
                             sentinels_left=short_left),
             past_residency=dict(grid=list(past.grid), card_per_sm=per_sm,
                                 static=static_past, refused=refused))
        if "coverage" not in static_short or short_left == 0:
            bad.append(f"(d) the short grid: static {static_short}, "
                       f"{short_left} sentinels left")
        if "co-residency" not in static_past or refused is None:
            bad.append(f"(d) past residency: static {static_past}, launch "
                       f"{'refused' if refused else 'ran'}")
        # (e) the CLI
        rc = cli.wait(timeout=600)
        with open(cli_json) as f:
            doc = json.load(f)
        emit("kernel_plans", step="cli", rc=rc, counts=doc["counts"],
             gate=doc["gate"], seconds=time.perf_counter() - t0,
             child_started_s_before=t0 - cli_t0)
        if rc != 0 or doc["gate"]["failed"]:
            bad.append(f"(e) python -m repro_torch.analysis exited {rc}")
        if bad:
            raise AssertionError("kernel_plans: " + "; ".join(bad[:20]))
    finally:
        stop_analysis_cli(state)


PHASES = (phase_env, phase_build, phase_kernels, phase_kernels_recsys,
          phase_full, phase_small, phase_recsys, phase_kernels_gnn,
          phase_gnn, phase_gnn_train, phase_equiformer, phase_kernels_lm,
          phase_lm,
          phase_lm_mla, phase_mapping,
          phase_c1,
          phase_claims, phase_train, phase_train_mla, phase_train_recsys,
          phase_placement, phase_place, phase_dryrun, phase_serving_bench,
          phase_lm100m, phase_kernel_plans)


def kernels_line(state):
    """The per-kernel summary: launches on the path that drives the kernel
    (and on each path), and the numbers of its first (main-path) shape."""
    out = []
    for name, (source, replaces, paths) in KERNEL_INFO.items():
        rows = state["kernel_rows"][name]
        path = paths[0] if paths else None
        out.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            path=path,
            launches=state["launches"][path][name] if path else 0,
            launches_by_path={p: c[name]
                              for p, c in state["launches"].items()},
            max_abs_err=max(r["max_abs_err"] for r in rows),
            ms=rows[0]["ms"], plain_ms=rows[0]["plain_ms"],
            bound_ms=rows[0]["bound_ms"], bound_by=rows[0]["bound_by"],
            library_ms=rows[0]["library_ms"], call_ms=rows[0]["call_ms"]))
        if name == "bucket_assign":        # timed against its library call
            out[-1]["ranking"] = state["bucket_ranking"]
            out[-1]["on_path_as"] = "prefix_split"
        if name == "prefix_split":         # every shape; the ATen sequence
            out[-1]["shapes"] = [{k: r.get(k) for k in (
                "shape", "blocks", "ms", "call_ms", "plain_ms", "bound_ms",
                "aten_sequence_ms", "cumsum_bucket_assign_ms")}
                for r in rows]
            out[-1]["ranking"] = state["split_ranking"]
            out[-1]["initial_partition_device"] = state["split_initial"]
        if name in ("bag_combine", "gather_combine"):  # at one query
            out[-1]["retrieve_query"] = state["bag_ranking"]
        if name == "bag_combine":          # every shape, bf16 too; training
            out[-1]["shapes"] = [{k: r.get(k) for k in (
                "shape", "ms", "call_ms", "plain_ms", "library_ms",
                "bound_ms", "max_abs_err", "readings")} for r in rows]
            out[-1]["train"] = dict(
                next(r for r in out[-1]["shapes"] if "train" in r["shape"]),
                **state["bag_train"])
        if name == "match_keys":           # off the path: match_round
            out[-1]["on_path_as"] = "match_round"
        if name == "match_round":          # every case; the old sequence
            out[-1]["shapes"] = [{k: r.get(k) for k in (
                "shape", "ms", "call_ms", "plain_ms", "bound_ms",
                "max_degree")} for r in rows]
        if name == "gather_combine":       # bulk, ragged, one query, bf16
            out[-1]["shapes"] = [{k: r.get(k) for k in (
                "shape", "dtype", "path", "ms", "call_ms",
                "plain_ms", "library_ms", "bound_ms", "bound_ms_every_slot",
                "bound_ms_every_slot_l2", "max_abs_err", "readings")}
                for r in rows]
        if name == "bsr_spmm":             # both bounds, the slabs read
            out[-1].update({k: rows[0][k] for k in (
                "bound_ms_stored_blocks", "tile", "slabs_read",
                "slabs_stored", "slab_share", "bitwise_every_slab")})
            # the gnn_train backward's transposed layouts
            out[-1]["transposed"] = [{k: r.get(k) for k in (
                "shape", "ms", "call_ms", "plain_ms", "library_ms",
                "bound_ms", "bound_by", "max_abs_err",
                "equal_to_forward_layout")}
                for r in rows if "transposed" in r["shape"][-1]]
        if name == "quotient_link_loads":  # at a DeepSeek expert search
            out[-1]["place_search"] = state["place_qll"]
        if name in ("quotient_link_loads", "partition_gain"):
            # every shape: CSR-local partitions, the serve pools
            out[-1]["shapes"] = [{k: r.get(k) for k in (
                "shape", "ms", "call_ms", "plain_ms", "library_ms",
                "library_sequence_ms", "bound_ms", "max_abs_err")}
                for r in rows]
        if name == "flash_attention":      # the 32k prefill; MLA; training
            keys = ("shape", "ms", "call_ms", "plain_ms", "library_ms",
                    "bound_ms", "bound_by")
            out[-1]["long"] = {k: rows[1][k] for k in keys}
            mla = next(r for r in rows if "mla" in r["shape"])
            out[-1]["mla"] = dict({k: mla[k] for k in keys},
                                  sdpa_backend=mla["sdpa_backend"],
                                  launches=state["launches"]["lm_mla"][name],
                                  per_prefill=state["launches"]["lm_mla"][
                                      name] // state["lm_mla_forwards"])
            out[-1]["train"] = state["train_flash"]
            out[-1]["train_mla"] = state["train_mla_flash"]
    return {"kernels": out}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one "
              "GPU and never falls back to the CPU", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails here when run outside the repo)

    state = {"launches": {}}
    seconds = {}
    t_all = time.perf_counter()
    try:
        for phase in PHASES:
            t0 = time.perf_counter()
            phase(state)
            torch.cuda.empty_cache()    # a phase's tensors go with it
            seconds[phase.__name__[len("phase_"):]] = (time.perf_counter()
                                                       - t0)
    finally:
        stop_analysis_cli(state)    # a phase failed before kernel_plans
    emit("timing", seconds=seconds, total=time.perf_counter() - t_all,
         nvidia_smi=state["smi"])
    print(json.dumps(kernels_line(state)), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
