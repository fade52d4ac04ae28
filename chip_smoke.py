#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port's main paths once on one NVIDIA GPU.

    python3 chip_smoke.py

Fourteen paths, each driven with its kernels' launch counts set to 0 just
before and read just after (the paper pipeline once more through its CLI):

* the paper pipeline of `repro_torch` (R-MAT graph → vertex-program trace →
  partition → traffic → stacked placement search → stacked analytic
  simulator) on the Table-2 workload `amazon` at its published size (304,000
  nodes, 4,300,000 edges), on the `paper` grid's 12 configurations for it
  (bfs/sssp/pagerank × mesh2d/fbutterfly × proposed vs randomized baseline, 16
  engines); then on the same graph the windowed NoC replay (the
  `backpressure` grid's 6 configurations, pagerank × mesh2d/torus2d/torus3d ×
  proposed vs baseline, both routing arms, open loop and credit at depths
  0.5-8 and inf, the flight recorder attached) and the journaled resilience
  runner (the `faults` grid: mesh2d/torus2d × 5 fault rates, 10 units, then
  resumed from its journal); its kernel is `segment_spmm` (every ELL bucket
  of a PageRank reduce in one launch, `csrc/ell_spmm.cu`), launched by the
  traces of all three runs.  Then the same pipeline as its users run it,
  through the sweep CLI (`repro_torch.experiments.run.main`, in process):
  `--grid backpressure` and `--grid faults` (20 units, then `--resume`) on
  amazon and soc-pokec (1,600,000 nodes, 30,600,000 edges) at scale 1.0, and
  `--grid paper` at its own scale 0.01 (48 configurations, the four Table-2
  workloads), whose records must equal the reference package's committed
  numpy run (`BENCH_sweep.json`) field for field but the wall time;
* the paper's multi-engine paths: 16 engines (the `paper` grid's count)
  stacked on the card over amazon at its published size, through
  `graph.distributed.DistributedEngine.run` (BFS, SSSP and PageRank on the
  powerlaw partition under `DeviceMapper((4, 4))`'s site permutation and on
  the random one; PageRank also with the bf16 exchange), the
  "process_group" backend over NCCL at world size 1, and gin-tu (5 × 64)
  at `ogb_products`' feature width (100) by halo exchange
  (`models.gnn_dist.gin_forward_halo`); its kernel is `segment_spmm` (one
  launch a PageRank step for all 16 engines' partials, one a halo GIN
  layer);
* LM serving: `repro_torch.launch.serve.build_engine` on llama3.2-3b at its
  published width and depth (28 layers, d_model 3072, 24/8 heads, d_ff 8192,
  vocab 128256; random weights from a seeded generator on the card), 4 slots,
  max_seq 4096, float32 KV cache, 8 requests of 512-3072 prompt tokens and 32
  new tokens each; its kernel is `flash_attention` (every prefill layer);
* GNNs: gin-tu, gat-cora, pna and graphcast at their published widths and
  depths on the `full_graph_sm` cell (R-MAT, 2,708 nodes, 10,556 edges,
  d_in 1,433; graphcast's mesh at refinement 4), gin-tu on `molecule` (128
  graphs of 30 nodes), and gin-tu on the amazon graph above at the
  `ogb_products` feature width (100), through `models.gnn.forward` and
  `loss_fn` under `inference_mode`; its kernel is `segment_spmm` (GIN's
  neighbour sum, once a layer, at D = d_in and then 64); gin-tu on amazon
  also trains (6 AdamW steps), its gradient through the same kernel over the
  transposed ELL;
* training: `launch.train.train`, the code path of `python -m
  repro_torch.launch.train`: llama3.2-3b at its published width and depth
  (3,606,752,256 float32 params, bf16 activations, a recompute a layer) for
  20 steps at the reference's defaults (batch 8, seq 128, lr 1e-3, AdamW,
  clip 1.0), then gin-tu, gat-cora and pna at `full_graph_sm`'s widths on
  the reference launcher's graph (R-MAT, 512 nodes, 4,096 edges) for 20
  steps each, and graphcast refused; its kernels are `flash_attention` (twice
  a layer a step: forward and recompute), `flash_attention_bwd` (once a
  layer a step) and `segment_spmm` (gin-tu: 5 forward and 4 backward a step);
* recsys: dcn-v2 at its published configuration (26 tables × 1,000,000 × 16,
  cross 3 × 429², MLP 1024-1024-512: 418,569,930 float32 params from a seeded
  generator on the card) — the `RECSYS_SHAPES` cells `serve_p99` (batch 512),
  `serve_bulk` (262,144) and `retrieval_cand` (1 query, 1,000,000 candidates,
  top-100) through `models.recsys`, then `train_batch` (65,536) for 20 steps
  through `launch.train.train`, the code path of `python -m
  repro_torch.launch.train --arch dcn-v2 --batch 65536`; its kernel is
  `embedding_bag` (every forward and every training step);
* MoE serving: `build_engine` on olmoe-1b-7b at its published width and
  depth (16 layers, d_model 2048, 16/16 heads, 64 experts top-8 of width
  1024, vocab 50304; random weights, bf16 over a float32 master) with the
  LM serving path's traffic, then qwen2-moe-a2.7b at its published width (60
  experts top-4 of width 1408, a 5632-wide shared expert with its sigmoid
  gate, vocab 151936) over 4 of its 24 layers, one prompt of 2048 tokens and
  8 decode steps; experts `impl="local"` (sort, scatter, `torch.bmm`,
  combine); its kernel is `flash_attention` (every prefill layer);
* MoE training: `launch.train.train`, the code path of `python -m
  repro_torch.launch.train --arch olmoe-1b-7b`, on olmoe-1b-7b at its
  published width over 8 of its 16 layers (3,562,571,776 float32 params:
  at 16 layers the params, grads and AdamW moments, 111 GB, exceed the
  card) for 20 steps at the LM training path's defaults, the router in
  float32, the loss cross-entropy alone as the reference's; then
  qwen2-moe-a2.7b at its published width over 2 of its 24 layers for 5
  steps (the shared expert's and its gate's backward); its kernels are
  `flash_attention` (twice a layer a step) and `flash_attention_bwd`
  (once a layer a step, at group 1 and dh 128);
* the model paths on a 2-D engine mesh: one olmoe layer with expert
  parallelism (`impl="ep_shardmap"`: two exchanges over "model") on
  `launch.mesh.make_production_mesh()` (256 engines); the "process_group"
  backend over NCCL at world size 1; dcn-v2 at its published size with
  `lookup_impl="psum_model"` on ("data", "model") = (2, 8) stacked on the
  card (`graph.distributed.make_mesh`; its tables row-sharded over "model"
  by `models.sharding.shard_tensor`): `serve_bulk` and 5 `train_batch`
  steps; its kernel is `embedding_bag` (one launch a data row a lookup over
  the sharded slab);
* training through the engine mesh's exchanges: gin-tu (5 × 64) at
  `ogb_products`' feature width trained by halo exchange over the 16 stacked
  engines on amazon under `DeviceMapper((4, 4))`'s permutation (5 steps at
  the reference launcher's defaults); olmoe-1b-7b at its published width
  over 8 of its 16 layers trained with EP on ("data", "model") = (2, 8) for
  10 steps (batch 8 × 128), beside the local path on the same weights, and
  qwen2-moe-a2.7b over 2 layers for 3 steps; EP and dcn-v2's `psum_model`
  (5 `train_batch` steps) over NCCL at world size 1; its kernels are
  `segment_spmm` (5 launches a halo GIN forward, 4 backward over the
  transposed halo ELL), `flash_attention` and `flash_attention_bwd` (every
  EP training step) and `embedding_bag` (every `psum_model` step);
* Megatron TP and FSDP dense training (`models.dense_mesh`): llama3.2-3b at
  its published width and depth trained on ("data", "model") = (2, 8)
  under `MeshRules(strategy="tp_sp")` and `"fsdp"` (every leaf laid out by
  `transformer.shard_params`) for 10 steps each at batch 16 × 128 and the
  launcher's AdamW, beside the one-device step on the same weights and
  batches; float32 gradients of llama3.2-3b and yi-34b (d 7168, 56/8 heads,
  d_ff 20480, vocab 64,000) at full width over 2 layers; both strategies
  over NCCL at world size 1; its kernels are `flash_attention` (twice a
  layer a step, every engine's heads folded into one launch) and
  `flash_attention_bwd` (once a layer a step);
* serving the dense transformer under Megatron TP (`models.dense_mesh`'s
  prefill and decode over a KV cache laid out by `kv_cache_specs`):
  llama3.2-3b at its published width and depth through
  `launch.serve.build_engine(..., mesh=)` on (2, 8) under "tp_sp" with the
  serving path's traffic, beside one device on the same bf16 weights; in
  float32 under "tp_sp" and "fsdp" 16 one-slot prefills of 384-512 tokens and
  8 decode steps at the rows' own positions against one device's; both
  strategies over NCCL at world size 1; its kernel is `flash_attention` (once
  a layer a prefill, every engine's heads folded into one launch);
* serving the MoE transformer under tp_sp with Megatron TP attention and
  expert-parallel experts in one layer (`models.dense_mesh` with
  `moe.moe_ep_rows` as its FFN, every leaf and the KV cache laid out):
  olmoe-1b-7b at its published width and depth and qwen2-moe-a2.7b over 4
  layers (60 experts padded to 64, the shared expert under TP) through
  `launch.serve.build_engine(..., mesh=)` on (2, 8) with the serving path's
  traffic, beside one device's impl="local" engine on the same bf16
  weights; in float32 at capacity factor E/k 16 one-slot prefills and 8
  decode steps against one device's; the drop path at 1.25 against the
  plain per-engine loop; NCCL at world size 1; its kernel is
  `flash_attention` (once a layer a prefill, every model engine's 2 of 16
  heads folded into one launch).
* the example twins as their users run them (`examples/torch_*.py`, each
  `main` called in process): the quickstart's PageRank trace and mapping on
  the card against its own run on the CPU, continuous batching of 10
  requests over llama3.2-3b's smoke model, the ~100M-param LM (12 layers,
  d_model 768) trained 40 steps, checkpointed and resumed to 50, its MoE
  form 20 steps, and the distributed and expert-placement twins; its
  kernels are `segment_spmm` (one launch a PageRank iteration),
  `flash_attention` (every prefill layer, twice a layer a training step)
  and `flash_attention_bwd` (once a layer a training step);
* the cost model (`launch.roofline`, `launch.perf.measure_cell`): three
  cells of the dry run on one device at a stated cut — llama3.2-3b
  `train_4k` at batch 8 × 128 (baseline and `bf16params`), dcn-v2
  `serve_bulk` at its published batch, gin-tu at `ogb_products`' width on
  amazon — each step counted on the card and on 'meta' and timed, the
  counted bound set beside the measured step; its kernels are
  `flash_attention`, `flash_attention_bwd`, `embedding_bag` and
  `segment_spmm`, each counted once at its entry.

Phases, one JSON line each:

  probe      the card and the toolchain
  build      `nvcc` on every source of `src/repro_torch/csrc/`, all at once
  kernels    `ell_spmm` (one bucket) against its plain PyTorch version (test
             shapes, every real ELL bucket of the full-size graph, two runs
             bit-equal); the fused `segment_spmm` reduce against the
             per-bucket route (bit-equal), the plain reader of the flat
             layout and `torch.sparse.mm`, one launch a reduce, isolated
             vertices 0; its time beside the per-bucket route's, the byte
             bound and `torch.sparse.mm` (call and CUDA-graph replay)
  engine     `run_traced` for the three algorithms against host references
  sweep      `run_sweep` with the torch backend against the numpy backend
  contention `run_sweep` with the contention pass and the flight recorder:
             the torch steppers' timelines against numpy's (open arm bit for
             bit, credit arm within 1e-9 of the peak, credit@inf bit-equal to
             open), recording on against off, proposed beating baseline on
             the mesh; launches, device time a window and busy share of a
             replay (`torch.profiler`), the two arms' wall times
  faults     `run_resilience` with the torch arm: every unit completes, parity
             within 1e-6 (0 at rate 0), a resumed run served from the journal
             and byte-identical
  gnn        the four GNN archs at published width: finite outputs and losses,
             GIN's ELL route against its scatter route, one `segment_spmm`
             launch a GIN layer and none elsewhere; gin-tu on amazon at d_in
             100: host batch and `build_ell` seconds, forward wall and device
             time by kernel, busy share, and one reduce at D = 100 and 64 beside
             its bound, `torch.sparse.mm`, the scatter route, the plain version
             and the same launch without its hub rows; then its training: the
             ELL and its transpose on the host, gradients against the scatter
             route's, 9 reduces a step, step ms, and the transposed reduce at
             D = 64 beside its bound and `torch.sparse.mm`
  distributed  16 stacked engines on amazon: BFS/SSSP bit-equal to the
             one-device `run`, PageRank within 1e-5 of the largest rank at
             the same iteration count, the bf16 exchange within 2e-2; one
             `segment_spmm` launch a PageRank step, none for BFS/SSSP, no
             other kernel; n_local, e_local, iterations, ms a step and
             exchange bytes a step for each algorithm and partition; NCCL at
             world size 1 bit-equal to stacked P = 1; the halo GIN within
             1e-4 of the one-device forward, its loss finite, 5 launches a
             forward, `plan_sizes`, halo bytes an engine a layer, forward ms
             and peak memory; the reduce at both new call sites against its
             plain version and `torch.sparse.mm`, beside its bound
  cli        the sweep CLI: backpressure, faults (then resumed: byte-identical,
             no trace) and paper, each with a cold cache of its own; wall time
             and stage split a grid, one `segment_spmm` launch a PageRank
             iteration, `--check` clean on the port's EXPERIMENTS.md and
             BENCH_sweep.json, the paper records equal to the committed ones
  attention  `flash_attention` against its plain version (test shapes, the
             examples phase's call sites, f32 and bf16, and the serve path's
             shapes; two runs bit-equal), its
             time and TFLOP/s at every path shape beside the operation bound
             and `scaled_dot_product_attention` (call and CUDA-graph
             replay), and the bf16 kernel's registers and shared memory;
             the forward's output and log-sum-exp against the plain
             forward's, and `flash_attention_bwd` on the kernel's forward
             against `flash_attention_bwd_ref` on the plain forward (test
             shapes, olmoe-1b-7b's and torch_train_lm_e2e's training
             shapes among them, f32 and
             bf16, offsets, rows that see no key, the training and serve
             shapes; two runs bit-equal) and its time at llama's and
             olmoe's training shapes and the serve shape beside its bound,
             the plain version and SDPA's backward, each of its three kernels' device
             time there, the bf16 route's kernels by name and their
             registers, spills and shared memory
  serve      the serve path, its throughput, and full-width logit checks
  train      the training path: llama3.2-3b's losses (finite, the last below
             the first), step ms of the last 10, tokens/s, peak memory, one
             step's device time by kernel (GEMMs, attention forward and
             backward, the rest) and busy share, the optimizer alone, 56 + 28
             attention launches a step; gin-tu/gat-cora/pna losses, step ms,
             9 reduces a gin-tu step; on gin-tu's training batch, one step's
             gradients through the ELL against the scatter route's and the
             transposed reduce against its plain version and the scatter
             route's gradient; graphcast refused
  embedding_bag  `embedding_bag` against its plain version (test shapes, f32
             and bf16, weighted or not; autograd gradients of tables and
             weights; dcn-v2's lookup at batch 65,536 and a weighted
             multi-hot lookup, L = 8 at batch 8,192; two runs bit-equal) and
             its time beside the byte bound and `F.embedding_bag`
  recsys     the recsys path: serve logits of the kernel route against the
             plain route, retrieval top-100 against the full scores, 20
             training steps against the same 20 through the plain route:
             table rows never looked up only decayed, looked-up rows changed
             (the same rows in both routes)
  moe        the attention kernel at olmoe's prefill shape (16 query and 16
             kv heads) against its plain version; olmoe-1b-7b and the cut
             qwen2-moe-a2.7b through the serve path: requests drained,
             attention launches, float32 and bf16 logits against the float32
             model, `moe_block` against the plain per-expert loop
             `moe_loop_ref` on one layer (float32: kept slots equal), two
             prefills bit-equal; prefill tokens/s, decode ms a step, peak
             memory, C and the dropped share of each prefill, the expert
             load skew of each layer, the device split of a prefill and of a
             decode step (router, dispatch, experts, combine, attention, the
             rest) and the decode step's byte bound with every expert read
             and with only the experts hit
  moe_train  the MoE training path: olmoe's losses (finite, the last below
             the first), 16 + 8 attention launches a step on the bf16
             wgmma route, one `route_log` entry a layer a step, two
             gradients of one state bit-equal, gradients with and without
             the recompute bit-equal (2 layers), `moe_block`'s gradients
             against `moe_loop_ref`'s on one layer in float32; step ms of
             the last 10, tokens/s, peak memory, one step's device time by
             part (GEMMs, attention forward and backward, router,
             dispatch, expert products, combine, optimizer, the rest) and
             busy share; C, the dropped share of every step and each
             layer's load skew at the first and last step; the trained
             routing's per-sequence expert counts through
             `expert_device_permutation` (EP 8 on a 2 × 4 torus: hop
             reduction and load balance a layer); qwen2-moe-a2.7b's
             losses, launches (the backward's on the same route) and peak
  mesh_models  the model paths on a 2-D mesh: one olmoe layer with EP on
             the production mesh (Cs 8) against local; dcn-v2
             `serve_bulk` logits of `psum_model` bit-equal to the gather's,
             one bag launch a data row a lookup, 5 training losses within 1e-6 and the
             unsharded table gradient within 1e-6 of its largest entry, the
             bag at the slab's shape against its plain version, its bound
             and `F.embedding_bag`; NCCL at world size 1 bit-equal to
             stacked (1, 1)
  mesh_train   training through the mesh's exchanges: the halo GIN's first
             loss within 1e-5 and every gradient within 1e-4 of the
             one-device `gnn.loss_fn`'s, two gradients bit-equal, 5 losses
             falling, 5 + 4 reduces a step, step ms, peak memory and halo
             bytes an engine a layer each way, NCCL at world size 1 bit-equal,
             the transposed halo reduce at D = 64 against its plain version,
             its bound and `torch.sparse.mm`; olmoe EP and local trained in
             turns (losses finite and falling, step ms, tokens/s, peak
             memory, 16 + 8 attention launches and 8 `ep_log` entries a step,
             Cs, Ce, dropped shares, all-to-all bytes a layer each way), float32
             EP gradients within 1e-4 of local's at capacity_factor E/k and of
             autograd through `moe_ep_loop_ref` at 1.25 (the same slots) on 2
             layers; qwen2-moe's losses (its padded experts no slot); EP's
             gradients and step and `psum_model`'s 5 steps over NCCL at world
             size 1 bit-equal to stacked
  mesh_dense   Megatron TP and FSDP on (2, 8): llama3.2-3b trained under
             both strategies and on one device in turns (losses finite and
             falling, the first within 5e-3 of one device's, step ms,
             tokens/s, peak memory, 56 + 28 attention launches a step, the
             bytes a step of the FSDP gathers, their reduce-scatters, the
             model-axis psums and the embedding's); float32 gradients of
             llama3.2-3b and yi-34b over 2 layers within 1e-4 of one
             device's, two runs bit-equal, the AdamW step keeping every
             layout; both strategies over NCCL at world size 1 bit-equal to
             stacked; the attention kernels at the tp_sp per-engine shape
             against their plain versions, bounds and SDPA
  mesh_dense_serve  Megatron TP serving on (2, 8): llama3.2-3b drained
             through `build_engine(..., mesh=)` under tp_sp and on one device
             in turns (8 requests, 28 × 8 attention launches a drain,
             finite logits, prefill tokens/s, decode ms a step, peak memory,
             the bytes a prefill and a decode step move, the share of served
             tokens equal to one device's); float32 prefill and decode
             logits and the unsharded cache under tp_sp and fsdp within 2e-3
             of one device's, two runs bit-equal; both strategies' prefill
             and decode over NCCL at world size 1 bit-equal to stacked; the
             attention kernel at the per-engine prefill shape against its
             plain version, bound and SDPA
  mesh_moe_serve  MoE serving under TP attention + EP experts on (2, 8):
             olmoe-1b-7b and qwen2-moe drained through `build_engine(...,
             mesh=)` and on one device (impl="local") in turns (every
             request drained, L × requests attention launches a drain,
             finite logits, prefill tokens/s, decode ms a step, peak memory,
             the dropped share of routed slots, two prefills bit-equal with
             their Cs, Ce and dropped shares by layer, a decode step
             dropping nothing, the bytes of each exchange a prefill and a
             decode step); float32 logits and cache at capacity factor E/k
             within 2e-3 of one device's, greedy tokens equal, two runs
             bit-equal; olmoe's layers 0-1 at 1.25 on a 2,047-token
             one-slot prompt against `moe_ep_loop_ref` (the same slots,
             drops in both stages, within 1e-4); a prefill and decode steps
             over NCCL at world size 1 bit-equal to stacked; the attention
             kernel at the per-engine prefill shape against its plain
             version, bound and SDPA
  mesh_moe_fsdp  MoE on (2, 8) under "fsdp" (ZeRO-3 expert stacks
             gathered into EP's slab at use, each engine routing its own
             rows): olmoe-1b-7b drained through `build_engine(..., slots=16,
             mesh=)` and on one device in turns (as mesh_moe_serve's
             drain); float32 logits and cache at capacity factor E/k within
             2e-3 of one device's (16 one-slot prefills, 8 decode steps of
             one row an engine), greedy tokens equal, two runs bit-equal,
             olmoe's layers 0-1 at 1.25 against `moe_ep_loop_ref`;
             qwen2-moe over 4 layers the same; olmoe over 2 layers: float32
             loss and every gradient within 1e-4 of one device's, two runs
             bit-equal, and a bf16 step timed under local, tp_sp and fsdp; a
             prefill and decode steps over NCCL at world size 1 bit-equal to
             stacked; the attention kernels at the fsdp per-engine training
             shape against their plain versions, bounds and SDPA
  examples   the example twins: torch_quickstart's lines on the card equal
             to its --device cpu run's and one `segment_spmm` launch a
             PageRank iteration; torch_serve_continuous_batching's 10
             requests drained (12 tokens each or EOS) with the tokens of its
             --device cpu run, no slot idle while a request waited, one
             `flash_attention` launch a prefill layer (the attention phase
             holds both attention kernels at these twins' shapes);
             torch_train_lm_e2e at --width 768 --layers 12 for 40 steps
             then resumed to 50 (`[resume] restored step 40`), and --moe
             for 20: losses finite and falling, `flash_attention` and
             `flash_attention_bwd` launched; the distributed and
             expert-placement twins; each twin's seconds, launches and
             lines, the phase within 60 s
  roofline   the cost model of `launch.roofline` against the card
             (`launch.perf.measure_cell`): llama3.2-3b train_4k at batch 8
             × 128 (baseline and bf16params), dcn-v2 serve_bulk at 262,144
             and gin-tu at ogb_products' width on amazon, each on one
             device, counted on the card and on 'meta' (FLOPs by dtype and
             bytes equal exactly) and timed over 5 warm steps, the counted
             compute time at most 1.05 × the step's; the halo GIN counted
             on 'meta' over 16 engines

Every line carries `seconds`, the time since the line before it.

then the contract lines: one `{"kernels": [...]}` object (ell_spmm with its
`launches_distributed` and `distributed` call sites,
flash_attention, flash_attention_bwd, embedding_bag; the attention rows
with their `moe_train` launches, the backward's with `moe_train_shape`,
the forward's with `launches_mesh_moe_serve`, the bag's with its
`psum_model` call site; every kernel with its `launches_mesh_train`, and
ell_spmm with its `halo_transpose` call site; the attention rows with their
`launches_mesh_dense`, and `flash_attention.tp`: the forward and the
backward at the tp_sp per-engine shape; the forward's
`launches_mesh_dense_serve`, and `flash_attention.tp_prefill`: the forward
at the tp_sp per-engine prefill shape; `flash_attention.tp_ep_prefill`: the
forward at olmoe's per-engine prefill shape under TP + EP; the attention
rows' `launches_mesh_moe_fsdp`, and `flash_attention.fsdp_ep`: the forward
and the backward at olmoe's per-engine training shape under "fsdp";
`launches_examples` on ell_spmm and both attention rows),
the card's name and
power limit as `nvidia-smi` prints them, and last
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}`.

Any failed check raises, so the script exits non-zero and prints no last
line.  Without a CUDA device it exits with code 2 at once; it never carries on
on the CPU.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import pathlib
import re
import statistics
import sys
import time
import warnings

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# the card's peaks, the kernels' bounds and the mesh paths' byte counters: one cost model for the
# script and the package (NVIDIA H100 80GB HBM3 at 700 W, from the data sheet)
from repro_torch.launch.roofline import (  # noqa: E402
    attention_bound_ms,
    attention_bwd_bound_ms,
    attention_flops,
    bag_bound_ms,
    bucket_bound_ms,
    dense_serve_bytes,
    dense_step_bytes,
    gin_reduce_bound_ms,
    moe_decode_bytes,
    moe_tp_bytes,
    reduce_bound_ms,
)

TEST_SHAPES = [(50, 16, 8), (100, 7, 3), (30, 4, 16), (64, 32, 1)]  # (N, R, W)
TEST_DIMS = [1, 16, 64, 128, 256]
F32_TOL = dict(rtol=2e-3, atol=2e-5)  # fp32 accumulation in another order
BF16_TOL = dict(rtol=1e-2, atol=1e-2)  # one bf16 rounding of an fp32 sum
KERNEL_SOURCE = "src/repro_torch/csrc/ell_spmm.cu"
KERNEL_REPLACES = "src/repro/kernels/segment_spmm/kernel.py:51"

# flash attention: tests/test_kernels.py:24-29 (B, Sq, Skv, Hq, Hkv, dh); the
# examples phase's call sites: torch_serve_continuous_batching's prefills (its
# shortest and longest prompt, 2 heads of 32) and torch_train_lm_e2e's forward at
# 768 wide (12q/6kv of 64) and at --moe's default 256 (4q/2kv), batch 8, seq 256;
# and the serve path's q (1, S, 24, 128), k/v (1, S, 8, 128) bf16 at these S
EXAMPLES_SERVE_ATTN = [(1, 8, 8, 2, 2, 32), (1, 23, 23, 2, 2, 32)]
EXAMPLES_TRAIN_ATTN = [(8, 256, 256, 12, 6, 64), (8, 256, 256, 4, 2, 64)]
ATTN_TEST_SHAPES = [(2, 128, 128, 4, 2, 64), (1, 256, 256, 8, 1, 32), (2, 96, 160, 4, 4, 64),
                    (1, 200, 200, 6, 2, 128), *EXAMPLES_SERVE_ATTN, *EXAMPLES_TRAIN_ATTN,
                    (2, 1000, 1100, 16, 4, 64)]  # the last: ragged 128-row q tiles
ATTN_PATH_S = (512, 2048, 3072)
ATTN_TIMED_S = 2048
FA_SOURCE = "src/repro_torch/csrc/flash_attention.cu"
FA_REPLACES = "src/repro/kernels/flash_attention/flash_attention.py:89"
# the attention backward: (B, Sq, Skv, Hq, Hkv, dh) at G = 1, 3, 3, 4, 1, 2, 2, 3, every
# head dim, ragged lengths, olmoe-1b-7b's training shape (G = 1 at dh 128),
# torch_train_lm_e2e's two (the examples phase), each causal (q_offset = Skv - Sq)
# and not; then q_offset -40 (40 rows see no key) and 37; timed at llama3.2-3b's and
# olmoe-1b-7b's training shapes (launch.train's batch 8, seq 128) and at the serve path's S
ATTN_BWD_TEST_SHAPES = [(2, 128, 128, 4, 4, 64), (1, 96, 160, 6, 2, 32), (2, 77, 77, 24, 8, 128),
                        (1, 200, 328, 8, 2, 128), (8, 128, 128, 16, 16, 128), *EXAMPLES_TRAIN_ATTN,
                        (2, 100, 90, 6, 2, 64)]
ATTN_BWD_OFFSETS = (-40, 37)
ATTN_TRAIN_SHAPE = (8, 128, 24, 8, 128)  # (B, S, Hq, Hkv, dh)
ATTN_MOE_TRAIN_SHAPE = (8, 128, 16, 16, 128)
# each gradient within this share of its largest magnitude: float32 sums in
# another order; in bf16 the kernel and the plain version each round one fp32 value
BWD_REL = {"f32": 1e-5, "bf16": 1e-2}
# the forward's log-sum-exp (natural log, float32 in both dtypes: fp32 scores
# summed in another order; the bf16 kernel's exponentials are exp2 of scores
# scaled into log2 units) of each row that sees a key, as the `-m gpu` tests
# hold it; a row that sees none holds a sentinel at or below LSE_NO_KEY in both
# (its output is not compared: the plain version and the kernel average
# different masked tiles there, and the backward gives such a row nothing)
LSE_TOL = {"f32": dict(rtol=1e-4, atol=1e-4), "bf16": dict(rtol=1e-4, atol=1e-2)}
LSE_NO_KEY = -1e29
FA_BWD_SOURCE = "src/repro_torch/csrc/flash_attention_bwd.cu"

# embedding bag: tests/test_kernels.py:84-86 (T, V, D, B, L); the path's
# lookup is dcn-v2's, single-hot at the train_batch cell's 65,536, and a
# weighted multi-hot lookup (DcnConfig.multi_hot) at L = 8, batch 8,192
BAG_TEST_SHAPES = [(3, 64, 128, 4, 5), (2, 32, 16, 8, 1), (1, 100, 256, 2, 7), (4, 17, 8, 3, 2)]
BAG_PATH_BATCH = 65_536
BAG_MULTI_HOT, BAG_MULTI_BATCH = 8, 8_192
BAG_SOURCE = "src/repro_torch/csrc/embedding_bag.cu"
BAG_REPLACES = "src/repro/kernels/embedding_bag/kernel.py:51"

# the sweep CLI: the backpressure and faults grids as users run them (amazon
# and soc-pokec), and the reference package's committed numpy run of the
# paper grid (its own scale, 0.01, seed 0) that the port's paper records
# must equal field for field but the wall time
CLI_SCALE = 1.0
COMMITTED_BENCH = ROOT / "BENCH_sweep.json"

# windowed NoC replay: the credit arm's torch stepper against numpy's, relative
# to each timeline's peak (its contractions sum in another order; ~1e-15 seen)
NOC_CREDIT_RTOL = 1e-9

# recsys: dcn-v2 at its published configuration
RECSYS_ARCH = "dcn-v2"
RECSYS_PARAMS = 418_569_930
TRAIN_STEPS, TRAIN_LR = 20, 1e-3  # launch.train's defaults but for --steps
# the two routes' forwards are bit-equal at L = 1 (one id × 1.0); their
# backward is one code path whose `index_add_` adds with atomics in a run's
# own order, so the routes drift apart by rounding only
TRAIN_LOSS_TOL = 1e-4
DECAY_RTOL = 1e-5  # 20 steps of p − lr·wd·p in float32, three roundings a step
# The loss falls from 0.69 to about 0.12 in the 20 steps: a row looked up late,
# by well-classified examples only, gets a gradient far below AdamW's eps and
# moves by less than DECAY_RTOL — in both routes alike.  So: every row never
# looked up only decays; every row first looked up in the first half changes;
# at least this share of all looked-up rows changes; and the plain route
# changes the same rows, but for this share of them (atomic-order noise)
ROWS_CHANGED_MIN_SHARE = 0.9
ROUTES_ROW_DISAGREEMENT_MAX = 1e-4

# serve: llama3.2-3b at its published width and depth
SERVE_ARCH = "llama3.2-3b"
SERVE_SLOTS, SERVE_MAX_SEQ, SERVE_REQUESTS, SERVE_NEW = 4, 4096, 8, 32
SERVE_PROMPT = (512, 3073)  # prompt lengths drawn from [512, 3072]
MODEL_TOL = dict(rtol=2e-3, atol=2e-3)  # float32 logits, as tests/test_models.py
# bf16 logits of 28 layers: a rounding flip in one layer's activations cascades,
# so the one-op bf16 tolerance does not apply to them; instead the kernel's route
# (and decode) must be no less accurate against the float32 model than the
# plain route is (mean abs error, within this factor)
BF16_ROUTE_FACTOR = 1.5


# GNNs: the four archs at their published widths on full_graph_sm, then gin-tu
# on the amazon graph at ogb_products' feature width (tools/gnn_full_scale.py
# runs ogb_products' own size)
GNN_ARCH = "gin-tu"
GNN_WIDE_CELL = "ogb_products"
# float32 logits of the ELL route against the scatter route: the same sums in
# another order, through 5 layers with LayerNorm
GNN_TOL = dict(rtol=1e-4, atol=1e-4)
# one neighbour sum of N(0, 1) rows against another route, in another order:
# up to 23,552 terms on amazon (sums ~150 in magnitude), over 131,072 at
# ogb_products' size
GIN_REDUCE_TOL = dict(rtol=2e-3, atol=1e-3)
GIN_KERNEL_GROUPS = {"segment_fused_ms": ("segment_fused",), "gemm_ms": ("gemm", "xmma", "cutlass")}
GNN_CUTS = [
    "weights random from a seeded generator (no trained checkpoint)",
    "graphs are seeded R-MAT with features and labels planted by GraphBatcher, not Cora/TU/ogbn-products",
    "graphcast: full_graph_sm's 2,708 grid nodes, its mesh at refinement 4 (2,562 nodes, 20,460 m2m edges) "
    "with random edges and features, as tests/test_arch_smoke.py makes them; no icosahedral geometry",
    "gin-tu at ogb_products' width (d_in 100) runs on amazon (304,000 nodes, 4,300,000 edges), the graph the "
    "other phases hold; ogb_products' own size is tools/gnn_full_scale.py",
    "gin-tu trains on amazon for 6 steps here; the 20-step training of gin-tu, gat-cora and pna is the "
    "train phase, on the reference launcher's graph (R-MAT, 512 nodes, 4,096 edges)",
    "minibatch_lg (fanout-sampled batches) is not driven on the card",
]


# the distributed phase: the paper grid's 16 engines stacked on the card, on
# amazon; the DeviceMapper's torus for them
DIST_ENGINES = 16
DIST_TORUS = (4, 4)
DIST_MAX_ITERATIONS = 200  # DistributedEngine.run's default, as the reference's
# PageRank through the exchange against the one-device run at the same iteration
# count, relative to the largest rank (ranks are ~3e-6 on amazon, so an absolute
# bound says nothing): float32 sums of the same messages in another order (a
# partial an engine, then a fold of 16), through ~40 iterations
DIST_PAGERANK_REL = 1e-5
# the bf16 exchange rounds every partial to 8 significant bits each step
# (2^-9 relative); the fixed point it settles at moves by a few of those
DIST_BF16_REL = 2e-2

_LAST_LINE = [time.perf_counter()]


def say(phase: str, **fields) -> None:
    """One JSON line; `seconds` is the time since the line before it."""
    now = time.perf_counter()
    fields.setdefault("seconds", now - _LAST_LINE[0])
    _LAST_LINE[0] = now
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


class Timer:
    """Median time of one call of a callable, two ways, both with CUDA events.

    `call_ms`   — `calls` calls enqueued back to back between one pair of
                  events: what a caller in a loop sees, the larger of the
                  host's enqueue cost and the device's time.
    `device_ms` — the same calls captured once into a CUDA graph and replayed:
                  the device's time alone, with no host between launches.
    """

    def _median(self, run, calls: int, reps: int) -> float:
        times = []
        for _ in range(reps):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            run()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b) / calls)
        return statistics.median(times)

    def call_ms(self, fn, *, calls: int = 20, reps: int = 20) -> float:
        def run():
            for _ in range(calls):
                fn()

        run()  # warm
        return self._median(run, calls, reps)

    def device_ms(self, fn, *, calls: int = 20, reps: int = 20) -> float:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # warm up off the default stream, as capture asks
            for _ in range(3):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(calls):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        return self._median(graph.replay, calls, reps)


# --------------------------------------------------------------------------- kernels


def per_bucket_reduce(x: torch.Tensor, ell) -> torch.Tensor:
    """The reduce as PR 13's engine ran it: a zeroed (N+1, D) buffer, one
    `ell_spmm` launch and one scatter a bucket, the sentinel row sliced off."""
    from repro_torch.kernels.segment_spmm.ops import ell_spmm

    n = x.shape[0]
    out = torch.zeros((n + 1, x.shape[1]), dtype=x.dtype, device=x.device)
    for b in range(ell.num_buckets):
        if ell.cols[b].shape[0]:
            out[ell.rows[b].long().clamp(max=n)] = ell_spmm(x, ell.cols[b], ell.weights[b])
    return out[:n]


def phase_kernels(device: torch.device, graph, timer: Timer) -> dict:
    from repro_torch.graph.algorithms import prepare_graph
    from repro_torch.graph.structs import build_ell
    from repro_torch.kernels.segment_spmm.ops import ell_spmm, segment_spmm
    from repro_torch.kernels.segment_spmm.ref import ell_spmm_ref, segment_spmm_ref

    max_err = {"f32": 0.0, "bf16": 0.0}
    cases = 0
    rng = np.random.default_rng(0)
    for n, r, w in TEST_SHAPES:
        for d in TEST_DIMS:
            x32 = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(device)
            cols = torch.from_numpy(rng.integers(0, n + 10, (r, w)).astype(np.int32)).to(device)
            wts = torch.from_numpy(rng.standard_normal((r, w)).astype(np.float32)).to(device)
            for dtype, tag, tol in ((torch.float32, "f32", F32_TOL), (torch.bfloat16, "bf16", BF16_TOL)):
                x = x32.to(dtype)
                for ww in (wts, None):
                    got = ell_spmm(x, cols, ww)
                    again = ell_spmm(x, cols, ww)
                    want = ell_spmm_ref(x, cols, ww)
                    torch.cuda.synchronize()
                    check(got.dtype == x.dtype and got.shape == (r, d), f"shape/dtype at {(n, r, w, d, tag)}")
                    check(torch.equal(got, again), f"two runs differ at {(n, r, w, d, tag)}")
                    err = float((got.float() - want.float()).abs().max())
                    max_err[tag] = max(max_err[tag], err)
                    check(
                        torch.allclose(got.float(), want.float(), **tol),
                        f"kernel vs plain version at {(n, r, w, d, tag, ww is not None)}: max abs err {err}",
                    )
                    cases += 1
    # R == 0: an empty result and no launch
    before = ell_spmm.launches
    empty = ell_spmm(x32, torch.zeros((0, 8), dtype=torch.int32, device=device), None)
    check(empty.shape == (0, x32.shape[1]) and ell_spmm.launches == before, "R == 0 must not launch")

    # every real bucket of the full-size PageRank graph, at the engine's D = 1
    pg = prepare_graph("pagerank", graph)
    ell = build_ell(pg.reversed(), device=device)
    n = graph.num_nodes
    x = torch.from_numpy(rng.random((n, 1)).astype(np.float32)).to(device)
    buckets = []
    real_err = 0.0
    for b in range(ell.num_buckets):
        cols, wts = ell.cols[b], ell.weights[b]
        if cols.shape[0] == 0:
            continue
        got, again, want = ell_spmm(x, cols, wts), ell_spmm(x, cols, wts), ell_spmm_ref(x, cols, wts)
        torch.cuda.synchronize()
        check(torch.equal(got, again), f"two runs differ on bucket W={ell.widths[b]}")
        err = float((got - want).abs().max())
        check(torch.allclose(got, want, **F32_TOL), f"bucket W={ell.widths[b]}: max abs err {err}")
        real_err = max(real_err, err)
        bound, _ = bucket_bound_ms(x, cols, wts)
        buckets.append({"W": ell.widths[b], "R": int(cols.shape[0]), "ms": timer.device_ms(lambda: ell_spmm(x, cols, wts)),
                        "bound_ms": bound, "max_abs_err": err})

    # the whole reduce in one launch, against the per-bucket route (bit-equal:
    # the same lanes and order a row), the plain reader of the flat layout, and
    # at D = 16 as well; isolated vertices exactly 0
    isolated = torch.from_numpy(np.setdiff1d(np.arange(n), pg.dst)).to(device)
    fused_err = 0.0
    for d in (1, 16):
        xd = x if d == 1 else torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(device)
        for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
            xt = xd.to(dtype)
            before = segment_spmm.launches
            got = segment_spmm(xt, ell)
            check(segment_spmm.launches == before + 1, "segment_spmm: one launch a reduce")
            per_bucket, want = per_bucket_reduce(xt, ell), segment_spmm_ref(xt, ell)
            torch.cuda.synchronize()
            check(torch.equal(got, per_bucket), f"fused vs per-bucket route differ at D={d}, {dtype}")
            check(bool((got[isolated] == 0).all()), "a vertex in no bucket is not 0")
            err = float((got.float() - want.float()).abs().max())
            check(torch.allclose(got.float(), want.float(), **tol), f"fused vs plain reader at D={d}: {err}")
            if dtype == torch.float32:
                fused_err = max(fused_err, err)
    before = segment_spmm.launches
    segment_spmm(x, ell)
    launches_per_reduce = segment_spmm.launches - before
    check(launches_per_reduce == 1, f"a reduce launched {launches_per_reduce} kernels")

    reduce_ms = timer.device_ms(lambda: segment_spmm(x, ell), calls=10)
    reduce_call_ms = timer.call_ms(lambda: segment_spmm(x, ell))
    per_bucket_ms = timer.device_ms(lambda: per_bucket_reduce(x, ell), calls=5)
    per_bucket_call_ms = timer.call_ms(lambda: per_bucket_reduce(x, ell), calls=5)
    reduce_plain_ms = timer.call_ms(lambda: segment_spmm_ref(x, ell), calls=2, reps=3)
    work = ell.work()
    real_entries = int(((work.cols >= 0) & (work.cols < n)).sum())
    bound_ms, bound_by = reduce_bound_ms(x, ell)
    per_bucket_bound_ms = sum(bk["bound_ms"] for bk in buckets)

    # yardstick: one library call computing the same function (used nowhere in the port)
    idx = torch.from_numpy(np.stack([pg.dst, pg.src]).astype(np.int64)).to(device)
    val = torch.from_numpy(pg.weight.astype(np.float32)).to(device)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="Sparse")  # torch's beta notices
        a_csr = torch.sparse_coo_tensor(idx, val, (n, n)).coalesce().to_sparse_csr()
    lib = torch.sparse.mm(a_csr, x)
    whole = segment_spmm(x, ell)
    torch.cuda.synchronize()
    lib_err = float((whole - lib).abs().max())
    check(torch.allclose(whole, lib, **F32_TOL), f"fused reduce vs torch.sparse.mm: {lib_err}")
    library_ms = timer.call_ms(lambda: torch.sparse.mm(a_csr, x))
    library_device_ms = timer.device_ms(lambda: torch.sparse.mm(a_csr, x))

    out = {
        "test_cases": cases, "max_abs_err_f32": max_err["f32"], "max_abs_err_bf16": max_err["bf16"],
        "tolerance_f32": F32_TOL, "tolerance_bf16": BF16_TOL, "bit_equal_two_runs": True,
        "graph": {"nodes": n, "edges": graph.num_edges, "ell_fill": ell.fill_fraction(),
                  "real_entries": real_entries, "D": 1, "work_items": int(work.items.shape[0]),
                  "vertices_in_no_bucket": int(work.zero_rows.numel())},
        "buckets": buckets, "real_bucket_max_abs_err": real_err,
        "fused_equals_per_bucket_route": True, "fused_max_abs_err_vs_plain": fused_err,
        "launches_per_reduce": launches_per_reduce,
        "kernel_ms": reduce_ms, "kernel_call_ms": reduce_call_ms, "per_bucket_reduce_ms": per_bucket_ms,
        "per_bucket_reduce_call_ms": per_bucket_call_ms, "ref_ms": reduce_plain_ms,
        "library_ms": library_ms, "library_device_ms": library_device_ms, "library_max_abs_err": lib_err,
        "bound_ms": bound_ms, "bound_by": bound_by, "per_bucket_bound_ms": per_bucket_bound_ms,
        "timing": "warm medians with CUDA events. kernel_ms: one whole segment_spmm reduce (output "
                  "allocation and the one fused launch) replayed from a CUDA graph (device time alone); "
                  "per_bucket_reduce_ms: PR 13's route (zeroed buffer, 12 ell_spmm launches, 12 scatters, "
                  "slice), the same way; library_device_ms: torch.sparse.mm (CSR) the same way; *_call_ms, "
                  "ref_ms, library_ms: calls enqueued from Python (host enqueue cost included); buckets[]: "
                  "each bucket's ell_spmm alone, its cols/wts warm in the L2. bound_ms: the whole reduce's "
                  "inputs read once; per_bucket_bound_ms: the sum of the buckets' bounds (PR 13's bound)",
    }
    say("kernels", **out)
    return out


# --------------------------------------------------------------------------- engine


def phase_engine(device: torch.device, graph, small_graph) -> dict:
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import shortest_path

    from repro_torch.graph import algorithms as alg
    from repro_torch.graph.vertex_program import run_traced
    from repro_torch.kernels.segment_spmm.ops import segment_spmm

    out: dict = {}

    def traced(name, g, **kw):
        """(trace, seconds of the iteration loop, seconds of set-up).  Two
        iterations run first and are thrown away, so that the timed loop pays
        no first-use cost (CUDA loads an operator's kernels at its first call)."""
        t: dict = {}
        prepared, program = alg.prepare_graph(name, g), alg.ALGORITHMS[name]()
        run_traced(prepared, program, max_iterations=2, device=device, **kw)
        t["launches_before"] = segment_spmm.launches
        tr = run_traced(prepared, program, max_iterations=40 if name == "pagerank" else 200,
                        device=device, timings=t, **kw)
        traced.launches = segment_spmm.launches - t["launches_before"]
        return tr, t["loop_s"], t["prepare_s"]

    # BFS: the pure-Python frontier reference at a twentieth of the size, scipy at full size
    tr, _, _ = traced("bfs", small_graph)
    check(np.array_equal(tr.props, alg.reference_bfs(small_graph, 0)), "bfs vs reference_bfs (small)")
    tr, secs, prep = traced("bfs", graph)
    adj = csr_matrix((np.ones(graph.num_edges), (graph.src, graph.dst)),
                     shape=(graph.num_nodes, graph.num_nodes))
    want = shortest_path(adj, method="D", directed=True, unweighted=True, indices=0)
    check(np.array_equal(tr.props.astype(np.float64), want), "bfs vs scipy shortest_path (full size)")
    out["bfs"] = {"iterations": tr.num_iterations, "s_per_iteration": secs / max(tr.num_iterations, 1),
                  "prepare_s": prep, "reached": int(np.isfinite(tr.props).sum()), "exact": True}

    # SSSP: Dijkstra in float64 against min over float32 path sums
    tr, secs, prep = traced("sssp", graph)
    want = alg.reference_sssp(alg.prepare_graph("sssp", graph), 0)
    check(np.array_equal(np.isfinite(tr.props), np.isfinite(want)), "sssp reachability")
    fin = np.isfinite(want)
    rel = float(np.max(np.abs(tr.props[fin] - want[fin]) / np.maximum(want[fin], 1.0)))
    check(rel <= 1e-5, f"sssp vs Dijkstra: max relative error {rel}")
    out["sssp"] = {"iterations": tr.num_iterations, "s_per_iteration": secs / max(tr.num_iterations, 1),
                   "prepare_s": prep, "max_rel_err_vs_float64_dijkstra": rel}

    # PageRank: the kernel's sum against index_add_ and against the host reference
    tr_ell, secs_ell, prep_ell = traced("pagerank", graph, reduce_impl="ell")
    launches = traced.launches  # of the timed run alone
    check(launches == tr_ell.num_iterations,
          f"pagerank launched segment_spmm {launches} times in {tr_ell.num_iterations} iterations, want one each")
    tr_sc, secs_sc, prep_sc = traced("pagerank", graph, reduce_impl="scatter")
    ref = alg.reference_pagerank(alg.prepare_graph("pagerank", graph))
    rel = float(np.max(np.abs(tr_ell.props - tr_sc.props) / np.abs(tr_sc.props)))
    check(rel <= 2e-3, f"pagerank ell vs scatter: max relative error {rel}")
    l1 = float(np.abs(tr_ell.props.astype(np.float64) - ref).sum())
    check(np.allclose(tr_ell.props, ref, atol=1e-4) and l1 <= 1e-3, f"pagerank vs reference: L1 {l1}")
    check(abs(float(tr_ell.props.sum()) - float(tr_sc.props.sum())) < 1e-3, "pagerank mass")
    check(tr_ell.num_iterations == tr_sc.num_iterations, "pagerank: ell and scatter iteration counts differ")
    check(bool(np.array_equal(tr_ell.edge_activity, tr_sc.edge_activity)), "pagerank: edge_activity differs")
    out["pagerank"] = {
        "iterations_ell": tr_ell.num_iterations, "iterations_scatter": tr_sc.num_iterations,
        "s_per_iteration_ell": secs_ell / tr_ell.num_iterations,
        "s_per_iteration_scatter": secs_sc / tr_sc.num_iterations,
        "prepare_s_ell": prep_ell, "prepare_s_scatter": prep_sc,
        "segment_spmm_launches": launches, "max_rel_err_ell_vs_scatter": rel, "l1_vs_reference": l1,
        "edge_activity_equal": bool(np.array_equal(tr_ell.edge_activity, tr_sc.edge_activity)),
    }
    say("engine", **out)
    return out


# --------------------------------------------------------------------------- sweep


def phase_sweep(device: torch.device, grid, graph, smi: str | None) -> tuple[dict, int]:
    from repro_torch.experiments.batched import simulate_batch
    from repro_torch.experiments.placement_batch import place_batch
    from repro_torch.experiments.sweep import figure_comparisons, run_sweep
    from repro_torch.kernels.segment_spmm.ops import ell_spmm, segment_spmm

    segment_spmm.launches = ell_spmm.launches = 0  # the main path's own count starts here
    torch.cuda.synchronize()
    res = run_sweep(grid, backend="torch", device=device, measure_serial=True,
                    graphs={"amazon": graph}, keep_artifacts=True)
    torch.cuda.synchronize()
    launches = segment_spmm.launches
    check(launches > 0, "run_sweep launched segment_spmm no time")
    check(ell_spmm.launches == 0, "run_sweep launched the one-bucket kernel")
    configs = grid.expand()
    check(len(res.records) == len(configs), "a record for every configuration")
    for r in res.records:
        vals = dataclasses.asdict(r.result)
        check(all(v is None or np.isfinite(v) for v in vals.values()), f"non-finite result in {r.config.key}")
        check(r.result.total_bytes > 0 and r.num_edges == graph.num_edges, f"empty traffic in {r.config.key}")
    comps = figure_comparisons(res.records)
    check(len(comps) == len(configs) // 2 and all(np.isfinite(c["speedup"]) for c in comps),
          "a finite proposed-vs-baseline comparison for every cell")
    check(all(c["speedup"] > 1 for c in comps if c["topology"] == "mesh2d"),
          "the proposed scheme must beat the randomized baseline on the mesh")

    art = res.artifacts
    kw = dict(methods=[c.placement for c in configs], seeds=[c.seed for c in configs])
    p_torch, _ = place_batch(art["traffics"], art["partitions"], art["topologies"],
                             backend="torch", device=device, **kw)
    p_numpy, _ = place_batch(art["traffics"], art["partitions"], art["topologies"], backend="numpy", **kw)
    sites_equal = all(np.array_equal(a.site, b.site) for a, b in zip(p_torch, p_numpy))
    check(sites_equal, "placements of the torch backend differ from the numpy backend's")
    s_numpy = simulate_batch(art["traffics"], art["placements"], num_iterations=art["num_iterations"],
                             backend="numpy")
    worst = 0.0
    for rec, b in zip(res.records, s_numpy):
        for k, v in dataclasses.asdict(rec.result).items():
            w = getattr(b, k)
            if v is None or w is None:
                check(v is w, f"{k} set in one backend only")
                continue
            worst = max(worst, abs(v - w) / max(abs(w), 1e-300))
    check(worst <= 1e-9, f"simulate_batch torch vs numpy: max relative difference {worst}")
    out = {
        "configs": len(configs), "scale": grid.scale, "backend": res.backend, "cuts": [],
        "placement_sites_equal_numpy": sites_equal, "simulate_max_rel_diff_vs_numpy": worst,
        "min_speedup": min(c["speedup"] for c in comps), "max_speedup": max(c["speedup"] for c in comps),
        "timings_s": res.timings, "placement_stats": res.placement_stats,
        "segment_spmm_launches": launches, "card": smi,
    }
    say("sweep", **out)
    return out, launches


# --------------------------------------------------------------------------- windowed NoC replay


def device_profile(fn) -> dict:
    """Kernel launches, memory copies and device time of one call, read from
    `torch.profiler`: `device_busy_ms` is the union of the device's intervals,
    `kernel_ms` the sum of the kernels' durations, `profiled_wall_ms` the host
    clock around that same call (profiler overhead included) and
    `busy_share` their ratio; `result` is what `fn` returned."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    kernels = [e for e in dev if not e.name.lower().startswith(("memcpy", "memset"))]
    busy, end = 0.0, float("-inf")
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in dev):
        if b > end:
            busy += b - max(a, end)
            end = b
    return {"kernel_launches": len(kernels), "copies": len(dev) - len(kernels),
            "kernel_ms": sum(e.time_range.elapsed_us() for e in kernels) / 1e3,
            "device_busy_ms": busy / 1e3, "profiled_wall_ms": wall,
            "busy_share": busy / 1e3 / wall, "result": result}


def wall_ms(fn, reps: int = 3) -> float:
    """Median host-clock time of one call that ends in a synchronise."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _without_clock(d: dict) -> dict:
    """A `SweepResult.to_dict()` without what the wall clock and the cache's
    hit/miss counts set: what recording must leave unchanged."""
    out = {k: v for k, v in d.items() if k not in ("timings", "memory", "cache_stats")}
    for rows in ("records", "comparisons"):
        out[rows] = [{k: v for k, v in r.items() if k != "elapsed_us"} for r in d[rows]]
    out["placement_stats"] = {k: v for k, v in d["placement_stats"].items() if not k.endswith("_s")}
    if d["contention"] is not None:
        out["contention"] = {k: v for k, v in d["contention"].items() if k != "timings"}
    return out


def _rel(got: np.ndarray, want: np.ndarray) -> float:
    """Largest |got − want| relative to the timeline's peak (a backlog that
    drains to ~0 keeps a residue of the order of its peak's last bit)."""
    return float(np.max(np.abs(got - want), initial=0.0) / max(1.0, float(np.max(np.abs(want), initial=0.0))))


def phase_contention(device: torch.device, grid, graph, smi: str | None) -> tuple[dict, int]:
    import tempfile

    from repro_torch.experiments.cache import SweepCache
    from repro_torch.experiments.sweep import run_sweep
    from repro_torch.kernels.segment_spmm.ops import ell_spmm, segment_spmm
    from repro_torch.nocsim import NocSimParams, build_credit_program, contended_batch, run_credit
    from repro_torch.nocsim.batch import (PARITY_RTOL, contention_sweep_payload, open_step, run_windows,
                                          stacked_open_program)
    from repro_torch.nocsim.model import build_schedule
    from repro_torch.nocsim.routes import ROUTING_POLICIES
    from repro_torch.obs import FlightRecorder

    with tempfile.TemporaryDirectory() as tmp:
        cache = SweepCache(tmp, device=device)
        rec = FlightRecorder()
        segment_spmm.launches = ell_spmm.launches = 0  # the path's own count starts here
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run_sweep(grid, backend="torch", device=device, measure_serial=False, cache=cache,
                        graphs={"amazon": graph}, recorder=rec, keep_artifacts=True)
        torch.cuda.synchronize()
        sweep_s = time.perf_counter() - t0
        launches = segment_spmm.launches
        check(launches > 0, "the contention sweep launched segment_spmm no time")
        check(ell_spmm.launches == 0, "the contention sweep launched the one-bucket kernel")
        # the same sweep with the recorder off (traces and traffic from the cache)
        off = run_sweep(grid, backend="torch", device=device, measure_serial=False, cache=cache,
                        graphs={"amazon": graph})
    check(_without_clock(res.to_dict()) == _without_clock(off.to_dict()),
          "the sweep's payload differs with the recorder on")
    cont = res.contention
    configs = grid.expand()
    n_arms = len(ROUTING_POLICIES) * (1 + len(grid.buffer_depths))
    check(len(cont["records"]) == len(configs) * n_arms, "a contention record for every config and arm")
    for r in cont["records"]:
        check(all(v is None or np.isfinite(v) for v in r.values() if isinstance(v, float)),
              f"non-finite contention record {r['key']} {r['routing']} {r['flow_control']}")
    check(cont["backends"] == ["numpy", "torch"], "both arms ran")
    check(cont["backend_parity_max_rel"] <= NOC_CREDIT_RTOL, f"numpy↔torch parity {cont['backend_parity_max_rel']}")
    check(cont["credit_inf_numpy_max_abs"] == 0.0, "numpy credit@inf differs from the open arm")
    check(cont["credit_inf_torch_max_rel"] == 0.0, "torch credit@inf differs from the open arm")

    # proposed vs baseline, contended T_network, on the mesh: every routing arm, open loop
    def t_net(routing, flow_control, depth, scheme):
        (r,) = [r for r in cont["records"] if r["topology"] == "mesh2d" and r["routing"] == routing
                and r["flow_control"] == flow_control and r["buffer_depth"] == depth
                and (r["partitioner"], r["placement"]) == scheme]
        return r["t_network_contended_s"]

    (prop, base) = grid.schemes()
    wins = {f"{routing}/{fc}" + ("" if d is None else f"@{d:g}"):
            t_net(routing, fc, d, base) / t_net(routing, fc, d, prop)
            for routing in ROUTING_POLICIES
            for fc, d in [("open", None)] + [("credit", d) for d in grid.buffer_depths]}
    check(all(wins[f"{routing}/open"] > 1.0 for routing in ROUTING_POLICIES),
          f"the proposed scheme does not beat the baseline on the mesh: {wins}")

    # the steppers state by state, on the sweep's own traffic and placements
    art = res.artifacts
    w = NocSimParams().windows
    worst_credit, open_equal, inf_equal, chunks_equal = 0.0, True, True, True
    replay = {}
    for routing in ROUTING_POLICIES:
        params = NocSimParams(routing=routing)
        scheds = [build_schedule(t, p, noc_params=params) for t, p in zip(art["traffics"], art["placements"])]
        inj = stacked_open_program(scheds, w)
        (s_np, b_np), _ = run_windows(open_step("numpy"), (inj,), None)
        (s_t, b_t), _ = run_windows(open_step("torch"), (torch.from_numpy(inj).to(device),), None)
        s_t, b_t = s_t.cpu().numpy(), b_t.cpu().numpy()
        open_equal &= bool(np.array_equal(s_t, s_np) and np.array_equal(b_t, b_np))
        for chunk in (1, w - 1, w):  # the carry stays on the card between chunks
            (s_c, b_c), _ = run_windows(open_step("torch"), (torch.from_numpy(inj).to(device),), None,
                                        window_chunk=chunk)
            chunks_equal &= bool(np.array_equal(s_c.cpu().numpy(), s_t) and np.array_equal(b_c.cpu().numpy(), b_t))
        for depth in tuple(grid.buffer_depths) + (float("inf"),):
            prog = build_credit_program(scheds, NocSimParams(routing=routing, flow_control="credit",
                                                             buffer_depth=depth))
            tl_t, carry_t = run_credit(prog, backend="torch", device=device)
            if depth == float("inf"):
                inf_equal &= bool(np.array_equal(tl_t.serviced, s_t) and np.array_equal(tl_t.eff_backlog, b_t))
                continue
            tl_np, carry_np = run_credit(prog, backend="numpy")
            if depth == 1.0:
                for chunk in (1, w - 1, w):
                    tl_c, _ = run_credit(prog, backend="torch", device=device, window_chunk=chunk)
                    chunks_equal &= all(np.array_equal(getattr(tl_c, f), getattr(tl_t, f)) for f in
                                        ("serviced", "eff_backlog", "buf", "src", "admitted", "arrivals"))
            for f in ("serviced", "eff_backlog", "buf", "src", "admitted", "arrivals"):
                worst_credit = max(worst_credit, _rel(getattr(tl_t, f), getattr(tl_np, f)))
            worst_credit = max(worst_credit, *(_rel(a, b) for a, b in zip(carry_t, carry_np)))
        if routing == "dor":
            replay["configs"], replay["links"] = inj.shape[1], inj.shape[2]
            replay["flows"] = prog.offered.shape[2]
            replay["pairs"] = int(prog.pair_c.size)
            replay["incidence_mb"] = prog.inc.nbytes / 1e6
            cred = NocSimParams(flow_control="credit", buffer_depth=1.0)
            for arm, p in (("open", params), ("credit_d1", cred)):
                call = lambda p=p: contended_batch(art["traffics"], art["placements"], noc_params=p,  # noqa: E731
                                                   backend="torch", schedules=scheds, device=device)
                call()  # warm
                prof = device_profile(call)
                del prof["result"]
                ms = wall_ms(call)
                replay[arm] = {**prof, "wall_ms": ms, "numpy_wall_ms": wall_ms(
                    lambda p=p: contended_batch(art["traffics"], art["placements"], noc_params=p,
                                                backend="numpy", schedules=scheds), reps=1),
                    "launches_per_window": prof["kernel_launches"] / w,
                    "device_ms_per_window": prof["kernel_ms"] / w}
    check(open_equal, "open arm: torch timelines differ from numpy's")
    check(inf_equal, "torch credit@inf differs from the torch open arm")
    check(chunks_equal, "torch arm: window chunks 1, W-1, W differ from the unchunked replay")
    check(worst_credit <= NOC_CREDIT_RTOL, f"credit arm: torch vs numpy {worst_credit} (relative to the peak)")

    # the device over the whole pass: the payload again under the profiler,
    # every share taken against that same call's own clocks
    pass_prof = device_profile(lambda: contention_sweep_payload(
        configs, art["traffics"], art["placements"], num_iterations=art["num_iterations"],
        buffer_depths=grid.buffer_depths, device=device))
    prof_torch_s = sum(v for k, v in pass_prof.pop("result")["timings"].items() if k.endswith("_torch_s"))
    t = cont["timings"]
    numpy_s = sum(v for k, v in t.items() if k.endswith("_numpy_s"))
    torch_s = sum(v for k, v in t.items() if k.endswith("_torch_s"))
    out = {
        "configs": len(configs), "scale": grid.scale, "routing_arms": list(ROUTING_POLICIES),
        "buffer_depths": list(grid.buffer_depths), "records": len(cont["records"]), "cuts": [],
        "open_torch_equals_numpy_bitwise": open_equal, "credit_max_rel_vs_numpy": worst_credit,
        "credit_tolerance": NOC_CREDIT_RTOL, "credit_inf_equals_open_torch_bitwise": inf_equal,
        "torch_chunks_1_Wm1_W_bitwise": chunks_equal,
        "payload_parity_max_rel": cont["backend_parity_max_rel"], "parity_rtol": PARITY_RTOL,
        "credit_inf_numpy_max_abs": cont["credit_inf_numpy_max_abs"],
        "credit_inf_torch_max_rel": cont["credit_inf_torch_max_rel"],
        "recorder_on_equals_off": True, "mesh_win_baseline_over_proposed": wins,
        "numpy_arm_s": numpy_s, "torch_arm_s": torch_s, "arm_timings_s": t,
        "contention_s": res.timings["contention_s"], "sweep_s": sweep_s, "sweep_timings_s": res.timings,
        "replay": replay,
        "pass_profile": {**pass_prof, "torch_arm_s": prof_torch_s,
                         "busy_share_of_torch_arm": pass_prof["device_busy_ms"] / 1e3 / prof_torch_s},
        "recorder": rec.summary(), "segment_spmm_launches": launches, "card": smi,
        "timing": "numpy_arm_s / torch_arm_s: the sums of contention_sweep_payload's per-arm host-clock "
                  "timings (14 replays each); replay.*: one contended_batch of the 6 configs on prebuilt "
                  "schedules, torch.profiler for launches and device time, busy_share = device_busy_ms / "
                  "profiled_wall_ms of that same profiled call; wall_ms: the host clock around an "
                  "unprofiled synchronised call (median of 3); pass_profile: the whole payload again under "
                  "torch.profiler, busy_share over that call's own host clock and busy_share_of_torch_arm "
                  "over the torch arm's time inside that same call",
    }
    say("contention", **out)
    return out, launches


def phase_faults(device: torch.device, grid, graph, smi: str | None) -> tuple[dict, int]:
    import os
    import tempfile

    from repro_torch.experiments.cache import SweepCache
    from repro_torch.experiments.journal import SweepJournal
    from repro_torch.experiments.resilience import run_resilience, unit_ids
    from repro_torch.faults.degraded import PARITY_RTOL
    from repro_torch.kernels.segment_spmm.ops import ell_spmm, segment_spmm

    with tempfile.TemporaryDirectory() as tmp:
        cache = SweepCache(os.path.join(tmp, "cache"), device=device)
        path = os.path.join(tmp, "faults.json")
        segment_spmm.launches = ell_spmm.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run_resilience(grid, cache=cache, backend="torch", device=device, graphs={"amazon": graph},
                             journal=SweepJournal(path, grid.name, resume=False))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = segment_spmm.launches
        check(launches > 0, "the faults runner launched segment_spmm no time")
        check(ell_spmm.launches == 0, "the faults runner launched the one-bucket kernel")
        t0 = time.perf_counter()
        again = run_resilience(grid, cache=cache, backend="torch", device=device, graphs={"amazon": graph},
                               journal=SweepJournal(path, grid.name, resume=True))
        resume_s = time.perf_counter() - t0
    uids = unit_ids(grid)
    check(len(res.records) == len(uids) and res.quarantined == {},
          f"{len(res.records)} of {len(uids)} units completed, quarantined: {sorted(res.quarantined)}")
    check(res.backend == "numpy+torch", f"backend {res.backend}")
    check(res.backend_parity_max_rel <= PARITY_RTOL, f"numpy↔torch parity {res.backend_parity_max_rel}")
    for r in res.records:
        for scheme in ("proposed", "baseline"):
            check(all(np.isfinite(v) for v in r[scheme].values() if isinstance(v, float)),
                  f"non-finite record {r['unit_id']}")
        if r["fault_rate"] == 0.0:
            check(r["backend_parity_rel"] == 0.0, f"open arm at rate 0 not bit-equal: {r['unit_id']}")
    check(all(row["batch_parity"] for row in res.repair), "repair_batch differs from the serial repair")
    check(json.dumps(again.to_dict(), sort_keys=True) == json.dumps(res.to_dict(), sort_keys=True),
          "the resumed run's payload differs")
    check(segment_spmm.launches == launches, "the resumed run traced again")
    out = {
        "units": len(res.records), "quarantined": len(res.quarantined), "scale": grid.scale,
        "topologies": list(grid.topologies), "fault_rates": list(grid.fault_rates), "cuts": [],
        "backend": res.backend, "parity_max_rel": res.backend_parity_max_rel, "parity_rtol": PARITY_RTOL,
        "parity_rel_by_unit": {r["unit_id"]: r["backend_parity_rel"] for r in res.records},
        "win_by_unit": {r["unit_id"]: r["win"] for r in res.records},
        "dead_links_by_unit": {r["unit_id"]: r["num_dead_links"] for r in res.records},
        "repair_rows": len(res.repair), "repair_batch_parity": True,
        "resume_byte_identical": True, "resume_s": resume_s, "wall_s": wall,
        "cache_stats": res.cache_stats, "segment_spmm_launches": launches, "card": smi,
        "timing": "wall_s: host clock around run_resilience (every unit on the numpy reference and the "
                  "torch arm, the repair ledger of the fault-free units, one trace); resume_s: the same call "
                  "served from the journal",
    }
    say("faults", **out)
    return out, launches


# --------------------------------------------------------------------------- GNNs


def graphcast_batch(n_grid: int, cfg, seed: int) -> dict:
    """GraphCast's batch at `n_grid` grid nodes: grid features, the planned
    multimesh's node count, random g2m/m2m/m2g edges and edge features, drawn
    from a seeded numpy generator as `tests/test_arch_smoke.py` draws them."""
    from repro_torch.models.gnn import graphcast_mesh_plan

    rng = np.random.default_rng(seed)
    plan = graphcast_mesh_plan(n_grid, cfg.mesh_refinement)
    m = plan["n_mesh"]
    b = {"x": rng.standard_normal((n_grid, cfg.d_in)).astype(np.float32),
         "mesh_x": rng.standard_normal((m, 3)).astype(np.float32),
         "labels": rng.standard_normal((n_grid, cfg.d_out)).astype(np.float32),
         "node_mask": np.ones(n_grid, bool)}
    for pre, cnt, ns, nd in (("g2m", plan["e_g2m"], n_grid, m), ("m2m", plan["e_m2m"], m, m),
                             ("m2g", plan["e_m2g"], m, n_grid)):
        b[f"{pre}_src"] = rng.integers(0, ns, cnt).astype(np.int32)
        b[f"{pre}_dst"] = rng.integers(0, nd, cnt).astype(np.int32)
        b[f"{pre}_feat"] = rng.standard_normal((cnt, 4)).astype(np.float32)
        b[f"{pre}_mask"] = np.ones(cnt, bool)
    return b


def without_hub_items(ell):
    """`ell` with the hub items (rows of width ≥ ELL_HUB_WIDTH) left out of its
    work table: the fused launch then skips their rows (timing only)."""
    from repro_torch.graph.structs import ELL_HUB_WIDTH, EllWork

    w = ell.work()
    keep = w.items[:, 2] < ELL_HUB_WIDTH
    return dataclasses.replace(ell, _work=EllWork(w.rows, w.cols, w.weights, w.items[keep], w.zero_rows))


def gin_at_scale(device: torch.device, graph, timer: Timer, *, seed: int, full_scatter: bool) -> tuple[dict, int]:
    """gin-tu at its published width (5 layers of 64, 16 classes) with the
    `ogb_products` feature width (100) on `graph`, through `models.gnn`'s
    entry points: the host's batch and ELL, a forward on the ELL route (wall,
    device time by kernel, busy share), checked against the scatter route
    (the whole forward when `full_scatter`, else one layer's sum at each
    width: it materialises E × D messages) and the plain version; then one
    reduce at D = 100 and D = 64 timed beside its bound, `torch.sparse.mm`,
    the scatter route's sum, the plain version and the same launch without
    the hub items.  Returns the numbers and the `segment_spmm` launches of
    the forwards."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.pipeline import GraphBatcher, to_device
    from repro_torch.graph.structs import ELL_HUB_WIDTH
    from repro_torch.kernels.segment_spmm.ops import segment_spmm
    from repro_torch.kernels.segment_spmm.ref import segment_spmm_ref
    from repro_torch.models import gnn

    cfg = get_arch(GNN_ARCH).model_config(GNN_WIDE_CELL)
    scatter = dataclasses.replace(cfg, reduce_impl="scatter")
    n = graph.num_nodes
    t0 = time.perf_counter()
    host = GraphBatcher(graph, d_feat=cfg.d_in, n_classes=cfg.d_out, seed=seed).full_batch()
    batch_host_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ell = gnn.batch_ell(host, device=device)
    work = ell.work()
    torch.cuda.synchronize()
    build_ell_s = time.perf_counter() - t0
    batch = to_device(host, device)
    batch["ell"] = ell
    params = gnn.init_params(cfg, seed, device=device)

    before = segment_spmm.launches
    with torch.inference_mode():
        out = gnn.forward(params, batch, cfg)
        loss = float(gnn.loss_fn(params, batch, cfg))
        torch.cuda.synchronize()
        check(segment_spmm.launches - before == 2 * cfg.n_layers, "a GIN forward: one launch a layer")
        check(out.shape == (n, cfg.d_out) and bool(torch.isfinite(out).all()) and np.isfinite(loss),
              "gin on the large graph: finite logits of the right shape")
        forward_wall_ms = wall_ms(lambda: gnn.forward(params, batch, cfg))
        prof = profile_window(lambda: gnn.forward(params, batch, cfg), groups=GIN_KERNEL_GROUPS)
        prof["other_ms"] = prof["device_ms"] - prof["segment_fused_ms"] - prof["gemm_ms"]
        err = scatter_wall_ms = None
        if full_scatter:
            other = gnn.forward(params, batch, scatter)
            torch.cuda.synchronize()
            err = float((out - other).abs().max())
            check(torch.allclose(out, other, **GNN_TOL), f"gin on the large graph: ell vs scatter {err}")
            del other
            scatter_wall_ms = wall_ms(lambda: gnn.forward(params, batch, scatter))
    launches = segment_spmm.launches - before

    idx = torch.from_numpy(np.stack([graph.dst, graph.src]).astype(np.int64)).to(device)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="Sparse")  # torch's beta notices
        a_csr = torch.sparse_coo_tensor(idx, torch.ones(graph.num_edges, device=device), (n, n)).coalesce()
        a_csr = a_csr.to_sparse_csr()
    del idx
    no_hub = without_hub_items(ell)
    rng = np.random.default_rng(seed)
    reduces = {}
    with torch.inference_mode():
        for d in (cfg.d_in, cfg.d_hidden):
            x = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(device)
            hb = {"x": x, "src": batch["src"], "dst": batch["dst"], "edge_mask": batch["edge_mask"]}
            got, again = segment_spmm(x, ell), segment_spmm(x, ell)
            lib = torch.sparse.mm(a_csr, x)
            torch.cuda.synchronize()
            r = {"D": d, "bit_equal_two_runs": bool(torch.equal(got, again)),
                 "max_abs_err_vs_library": float((got - lib).abs().max())}
            check(r["bit_equal_two_runs"], f"two runs of the reduce differ at D={d}")
            check(torch.allclose(got, lib, **GIN_REDUCE_TOL), f"reduce vs torch.sparse.mm at D={d}")
            del lib
            want = segment_spmm_ref(x, ell)
            r["max_abs_err_vs_plain"] = float((got - want).abs().max())
            check(torch.allclose(got, want, **GIN_REDUCE_TOL), f"reduce vs its plain version at D={d}")
            del want
            sc = gnn.gin_sum(x, hb, scatter)
            r["max_abs_err_vs_scatter"] = float((got - sc).abs().max())
            check(torch.allclose(got, sc, **GIN_REDUCE_TOL), f"reduce vs the scatter route at D={d}")
            del sc, got, again
            torch.cuda.empty_cache()
            r["ms"] = timer.device_ms(lambda: segment_spmm(x, ell), calls=10)
            r["call_ms"] = timer.call_ms(lambda: segment_spmm(x, ell), calls=10)
            r["no_hub_ms"] = timer.device_ms(lambda: segment_spmm(x, no_hub), calls=10)
            r["bound_ms"], r["bound_by"] = gin_reduce_bound_ms(x, ell), "bytes"
            r["library_ms"] = timer.call_ms(lambda: torch.sparse.mm(a_csr, x), calls=10)
            r["library_device_ms"] = timer.device_ms(lambda: torch.sparse.mm(a_csr, x), calls=10)
            r["scatter_ms"] = timer.call_ms(lambda: gnn.gin_sum(x, hb, scatter), calls=2, reps=5)
            torch.cuda.empty_cache()
            r["plain_ms"] = timer.call_ms(lambda: segment_spmm_ref(x, ell), calls=1, reps=3)
            torch.cuda.empty_cache()
            reduces[f"D{d}"] = r
    training, train_launches = gin_training_at_scale(device, graph, host, batch, params, cfg, timer, seed=seed)
    launches += train_launches
    hub = work.items[:, 2] >= ELL_HUB_WIDTH
    out = {
        "arch": GNN_ARCH, "cell_widths": GNN_WIDE_CELL, "params": cfg.num_params, "nodes": n,
        "edges": graph.num_edges, "d_in": cfg.d_in, "loss": loss,
        "batch_host_s": batch_host_s, "build_ell_host_s": build_ell_s,
        "ell": {"work_items": int(work.items.shape[0]), "hub_items": int(hub.sum()),
                "max_width": int(work.items[:, 2].max()), "fill": ell.fill_fraction(),
                "vertices_in_no_bucket": int(work.zero_rows.numel())},
        "forward_wall_ms": forward_wall_ms, "forward_profile": prof,
        "scatter_forward_wall_ms": scatter_wall_ms, "ell_vs_scatter_max_abs_err": err,
        "reduce": reduces, "train": training,
    }
    return out, launches


def gin_grads_vs_scatter(params, batch: dict, cfg, where: str) -> tuple[float, int]:
    """One step's gradients of every leaf on the ELL route (the forward
    reduce and its transpose through the fused kernel) against the scatter
    route's (`index_add_` and its autograd) on the same weights and batch,
    within GNN_TOL.  Returns the largest difference and the step's
    `segment_spmm` launches (checked: 5 forward, 4 backward)."""
    from repro_torch.kernels.segment_spmm.ops import segment_spmm
    from repro_torch.models import gnn
    from repro_torch.train.pytree import tree_leaves

    scatter = dataclasses.replace(cfg, reduce_impl="scatter")
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    before = segment_spmm.launches
    got = torch.autograd.grad(gnn.loss_fn(params, batch, cfg), leaves)
    torch.cuda.synchronize()
    launches = segment_spmm.launches - before
    check(launches == 2 * cfg.n_layers - 1, f"gin training step on {where}: {launches} reduces, want 5 + 4")
    want = torch.autograd.grad(gnn.loss_fn(params, batch, scatter), leaves)
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    check(all(torch.allclose(a, b, **GNN_TOL) for a, b in zip(got, want)),
          f"gin gradients on {where}, ell vs scatter: {err}")
    for p in leaves:
        p.requires_grad_(False)
    return err, launches


def gin_training_held(device: torch.device, seed: int) -> dict:
    """gin-tu on the batch `launch.train` trains it on (its own `_gnn_setup`:
    R-MAT 512/4,096, full_graph_sm widths, the ELL and its transpose):
    one step's gradients on the ELL route against the scatter route's, and
    the transposed reduce at D = d_hidden against its plain version and the
    scatter route's reduce gradient (autograd of `index_add_` over the same
    edges), on N(0, 1) rows."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels.segment_spmm.ops import segment_spmm
    from repro_torch.kernels.segment_spmm.ref import segment_spmm_ref
    from repro_torch.launch.train import _gnn_setup
    from repro_torch.models import gnn

    cfg, params, _, batches = _gnn_setup(get_arch(GNN_ARCH), smoke=False, seed=seed, device=device)
    batch = next(batches)
    check(batch["ell"].transpose is not None, "launch.train's gin-tu batch carries no transposed ELL")
    grad_err, launches = gin_grads_vs_scatter(params, batch, cfg, "launch.train's graph")

    n = batch["x"].shape[0]
    g = torch.from_numpy(np.random.default_rng(seed + 5).standard_normal((n, cfg.d_hidden)).astype(np.float32))
    g = g.to(device)
    h = torch.zeros_like(g, requires_grad=True)
    scatter = dataclasses.replace(cfg, reduce_impl="scatter")
    by_scatter = torch.autograd.grad(gnn.gin_sum(h, batch, scatter), h, g)[0]
    with torch.inference_mode():
        red = segment_spmm(g, batch["ell"].transpose)
        plain = segment_spmm_ref(g, batch["ell"].transpose)
    torch.cuda.synchronize()
    plain_err = float((red - plain).abs().max())
    check(torch.allclose(red, plain, **F32_TOL), f"transposed reduce on launch.train's graph vs plain: {plain_err}")
    scatter_err = float((red - by_scatter).abs().max())
    check(torch.allclose(red, by_scatter, **F32_TOL),
          f"transposed reduce on launch.train's graph vs the scatter route's gradient: {scatter_err}")
    del params, batch
    return {"grads_ell_vs_scatter_max_abs_err": grad_err, "segment_spmm_launches_a_step": launches,
            "transpose_reduce": {"D": cfg.d_hidden, "max_abs_err_vs_plain": plain_err,
                                 "max_abs_err_vs_scatter_gradient": scatter_err},
            "tolerance_grads": GNN_TOL, "tolerance_reduce": F32_TOL}


def gin_training_at_scale(device, graph, host, batch, params, cfg, timer: Timer, *, seed: int) -> tuple[dict, int]:
    """gin-tu training on the large graph: the ELL with its transpose built
    on the host (time), one step's gradients on the ELL route against the
    scatter route's on the same weights, the step's `segment_spmm` launches (5
    forward, 4 backward), the step time of `make_train_step` with AdamW, and
    one transposed reduce at D = 64 beside its bound and `torch.sparse.mm` of
    the transposed adjacency.  Returns the numbers and the launches."""
    from repro_torch.kernels.segment_spmm.ops import segment_spmm
    from repro_torch.kernels.segment_spmm.ref import segment_spmm_ref
    from repro_torch.models import gnn
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.optim import adamw, cosine_schedule

    t0 = time.perf_counter()
    ell = gnn.batch_ell(host, device=device, transpose=True)
    torch.cuda.synchronize()
    build_both_s = time.perf_counter() - t0
    tb = {**batch, "ell": ell}
    start = segment_spmm.launches
    grad_err, launches_a_step = gin_grads_vs_scatter(params, tb, cfg, "the large graph")

    init, step = make_train_step(lambda p, b: gnn.loss_fn(p, b, cfg), adamw(cosine_schedule(TRAIN_LR, 10, TRAIN_STEPS)))
    st = init(params)
    losses, walls = [], []
    for i in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, m = step(st, tb)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        if i:  # the first is warm-up
            walls.append((time.perf_counter() - t0) * 1e3)
    check(all(np.isfinite(losses)), f"gin training on the large graph: losses {losses}")
    del st
    train_launches = segment_spmm.launches - start  # the gradient check's step and the 6 steps
    check(train_launches == 7 * launches_a_step, f"gin training on the large graph: {train_launches} reduces")

    n = graph.num_nodes
    ell_t = ell.transpose
    idx = torch.from_numpy(np.stack([graph.src, graph.dst]).astype(np.int64)).to(device)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="Sparse")
        a_t = torch.sparse_coo_tensor(idx, torch.ones(graph.num_edges, device=device), (n, n)).coalesce()
        a_t = a_t.to_sparse_csr()
    del idx
    x = torch.from_numpy(np.random.default_rng(seed + 3).standard_normal((n, cfg.d_hidden)).astype(np.float32))
    x = x.to(device)
    with torch.inference_mode():
        red = segment_spmm(x, ell_t)
        lib = torch.sparse.mm(a_t, x)
        torch.cuda.synchronize()
        red_err = float((red - lib).abs().max())
        check(torch.allclose(red, lib, **GIN_REDUCE_TOL), f"transposed reduce vs torch.sparse.mm: {red_err}")
        want = segment_spmm_ref(x, ell_t)
        plain_err = float((red - want).abs().max())
        check(torch.allclose(red, want, **GIN_REDUCE_TOL), f"transposed reduce vs its plain version: {plain_err}")
        del want
        work_t = ell_t.work()
        transpose = {
            "D": cfg.d_hidden, "ms": timer.device_ms(lambda: segment_spmm(x, ell_t), calls=10),
            "call_ms": timer.call_ms(lambda: segment_spmm(x, ell_t), calls=10),
            "bound_ms": gin_reduce_bound_ms(x, ell_t), "bound_by": "bytes",
            "library_ms": timer.call_ms(lambda: torch.sparse.mm(a_t, x), calls=10),
            "library_device_ms": timer.device_ms(lambda: torch.sparse.mm(a_t, x), calls=10),
            "max_abs_err_vs_library": red_err, "max_abs_err_vs_plain": plain_err,
            "plain_ms": timer.call_ms(lambda: segment_spmm_ref(x, ell_t), calls=1, reps=3),
            "ell_t": {"work_items": int(work_t.items.shape[0]), "max_width": int(work_t.items[:, 2].max()),
                      "vertices_in_no_bucket": int(work_t.zero_rows.numel())},
        }
    del red, lib, a_t, x
    torch.cuda.empty_cache()
    return {"build_ell_and_transpose_host_s": build_both_s, "segment_spmm_launches_a_step": launches_a_step,
            "grads_ell_vs_scatter_max_abs_err": grad_err, "losses": losses,
            "step_ms_median": float(np.median(walls)), "step_ms": walls, "transpose_reduce": transpose,
            "timing": "step_ms: host clock around one synchronised make_train_step step (AdamW) on the "
                      "resident batch, 5 after one warm-up; transpose_reduce as reduce.*"}, train_launches


def phase_gnn(device: torch.device, graph, seed: int, smi: str | None, timer: Timer) -> tuple[dict, int]:
    """The four GNN archs at their published widths and depths on
    `full_graph_sm`, gin-tu on `molecule`, and gin-tu on the large graph
    (`gin_at_scale`); `segment_spmm` launches of their forwards."""
    from repro_torch.configs.base import GNN_SHAPES
    from repro_torch.configs.registry import arch_ids, get_arch
    from repro_torch.data.pipeline import GraphBatcher, to_device
    from repro_torch.graph.generators import rmat
    from repro_torch.kernels.segment_spmm.ops import segment_spmm
    from repro_torch.models import gnn

    sh = GNN_SHAPES["full_graph_sm"]
    small = rmat(sh["n_nodes"], sh["n_edges"], seed=seed)
    runs = [(arch, "full_graph_sm") for arch in arch_ids("gnn")] + [(GNN_ARCH, "molecule")]
    segment_spmm.launches = 0
    archs = {}
    for arch, cell in runs:
        cfg = get_arch(arch).model_config(cell)
        params = gnn.init_params(cfg, seed, device=device)
        batcher = GraphBatcher(small, d_feat=cfg.d_in, n_classes=cfg.d_out, seed=seed)
        if cfg.kind == "graphcast":
            host = graphcast_batch(sh["n_nodes"], cfg, seed)
        elif cell == "molecule":
            mol = GNN_SHAPES["molecule"]
            host = batcher.molecule_batch(mol["batch"], mol["n_nodes"], mol["n_edges"])
        else:
            host = batcher.full_batch()
        batch = to_device(host, device)
        if cfg.kind == "gin":
            batch["ell"] = gnn.batch_ell(host, device=device)
        with torch.inference_mode():
            before = segment_spmm.launches
            out = gnn.forward(params, batch, cfg)
            torch.cuda.synchronize()
            launches = segment_spmm.launches - before
            loss = float(gnn.loss_fn(params, batch, cfg))
            rows = host["labels"].shape[0]
            check(tuple(out.shape) == (rows, cfg.d_out) and bool(torch.isfinite(out).all()) and np.isfinite(loss),
                  f"{arch} on {cell}: finite outputs of shape ({rows}, {cfg.d_out})")
            check(launches == (cfg.n_layers if cfg.kind == "gin" else 0),
                  f"{arch}: {launches} segment_spmm launches in a forward")
            r = {"kind": cfg.kind, "cell": cell, "layers": cfg.n_layers, "d_hidden": cfg.d_hidden,
                 "d_in": cfg.d_in, "params": cfg.num_params, "out_shape": list(out.shape), "loss": loss,
                 "segment_spmm_launches_a_forward": launches,
                 "forward_wall_ms": wall_ms(lambda: gnn.forward(params, batch, cfg))}
            if cfg.kind == "gin":
                scatter = dataclasses.replace(cfg, reduce_impl="scatter")
                other = gnn.forward(params, batch, scatter)
                torch.cuda.synchronize()
                r["ell_vs_scatter_max_abs_err"] = float((out - other).abs().max())
                check(torch.allclose(out, other, **GNN_TOL), f"{arch} on {cell}: ell vs scatter route")
                r["scatter_forward_wall_ms"] = wall_ms(lambda: gnn.forward(params, batch, scatter))
            if cfg.kind == "graphcast":
                r["mesh"] = gnn.graphcast_mesh_plan(sh["n_nodes"], cfg.mesh_refinement)
        archs[f"{arch}@{cell}"] = r
        del params, batch
    torch.cuda.empty_cache()
    launches = segment_spmm.launches  # the forwards of the five runs (and their timing)
    wide, wide_launches = gin_at_scale(device, graph, timer, seed=seed, full_scatter=True)
    launches += wide_launches
    out = {
        "archs": archs, "amazon": wide, "segment_spmm_launches": launches, "tolerance_ell_vs_scatter": GNN_TOL,
        "tolerance_reduce": GIN_REDUCE_TOL, "card": smi,
        "cuts": GNN_CUTS,
        "timing": "forward_wall_ms: host clock around one forward that ends in a synchronise, warm median "
                  "of 3, under inference_mode; forward_profile: torch.profiler over one forward (device time "
                  "by kernel, summed; busy share = that sum over the profiled wall); reduce.*: one "
                  "segment_spmm on random N(0,1) x of that width: ms and no_hub_ms replayed from a CUDA graph "
                  "(device time), call_ms, library_ms, scatter_ms, plain_ms enqueued from Python, "
                  "library_device_ms torch.sparse.mm (CSR) replayed; bound_ms: x's read rows, the real "
                  "cols and the output once over 3.35 TB/s",
    }
    say("gnn", **out)
    return out, launches


# --------------------------------------------------------------------------- distributed


def counted(fn):
    """`fn()` with every kernel wrapper's launch count set to 0 just before
    and read just after (a synchronise between): the result and the counts."""
    from repro_torch.kernels.embedding_bag.ops import embedding_bag
    from repro_torch.kernels.flash_attention.ops import flash_attention, flash_attention_bwd
    from repro_torch.kernels.segment_spmm.ops import ell_spmm, segment_spmm

    wrappers = {"segment_spmm": segment_spmm, "ell_spmm": ell_spmm, "flash_attention": flash_attention,
                "flash_attention_bwd": flash_attention_bwd, "embedding_bag": embedding_bag}
    for w in wrappers.values():
        w.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {k: w.launches for k, w in wrappers.items()}


def check_only_reduces(counts: dict, reduces: int, what: str) -> int:
    """`counts` must be `reduces` launches of `segment_spmm` and none of any
    other kernel; returns `reduces`."""
    want = {k: (reduces if k == "segment_spmm" else 0) for k in counts}
    check(counts == want, f"{what}: launch counts {counts}, want {want}")
    return reduces


def library_csr(ell, n: int):
    """The (n, n) CSR matrix whose product with x is the reduce over `ell`
    (row v holds v's ELL row), for `torch.sparse.mm`."""
    work = ell.work()
    widths = torch.cat([torch.full((int(r.shape[0]),), w, dtype=torch.int64, device=work.rows.device)
                        for r, w in zip(ell.rows, ell.widths)])
    rows = torch.repeat_interleave(work.rows.long(), widths)
    cols = work.cols.long()
    vals = torch.ones(cols.shape, device=cols.device) if work.weights is None else work.weights
    real = (rows < n) & (cols < n)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="Sparse")  # torch's beta notices
        a = torch.sparse_coo_tensor(torch.stack([rows[real], cols[real]]), vals[real], (n, n)).coalesce()
        return a.to_sparse_csr()


def call_site_check(ell, x: torch.Tensor, timer: Timer, bound) -> dict:
    """The fused reduce at a new call site against its plain version on the
    same inputs (F32_TOL) and `torch.sparse.mm`, two runs bit-equal; its time
    beside `bound(x, ell)`, the plain version's and the library call's."""
    from repro_torch.kernels.segment_spmm.ops import segment_spmm
    from repro_torch.kernels.segment_spmm.ref import segment_spmm_ref

    with torch.inference_mode():
        got, again = segment_spmm(x, ell), segment_spmm(x, ell)
        want = segment_spmm_ref(x, ell)
        torch.cuda.synchronize()
        r = {"N": x.shape[0], "D": x.shape[1], "max_abs_err": float((got - want).abs().max()),
             "bit_equal_two_runs": bool(torch.equal(got, again))}
        check(torch.allclose(got, want, **F32_TOL), f"reduce at N={x.shape[0]}, D={x.shape[1]} vs its plain version")
        check(r["bit_equal_two_runs"], "two runs of the reduce differ")
        del again, want
        a = library_csr(ell, x.shape[0])
        lib = torch.sparse.mm(a, x)
        r["max_abs_err_vs_library"] = float((got - lib).abs().max())
        check(torch.allclose(got, lib, **GIN_REDUCE_TOL), "reduce vs torch.sparse.mm")
        del got, lib
        torch.cuda.empty_cache()
        r["ms"] = timer.device_ms(lambda: segment_spmm(x, ell), calls=5, reps=5)
        r["call_ms"] = timer.call_ms(lambda: segment_spmm(x, ell), calls=5, reps=5)
        r["plain_ms"] = timer.call_ms(lambda: segment_spmm_ref(x, ell), calls=1, reps=3)
        r["library_ms"] = timer.call_ms(lambda: torch.sparse.mm(a, x), calls=5, reps=5)
        r["bound_ms"], r["bound_by"] = bound(x, ell)
    del a
    torch.cuda.empty_cache()
    return r


def engine_runs(device: torch.device, graph, parts: dict, timer: Timer, seed: int) -> tuple[dict, int, dict]:
    """BFS, SSSP and PageRank through `DistributedEngine.run` on each of
    `parts` ({name: (partition, site permutation)}) against the one-device
    `run`, the bf16 exchange for PageRank, and a step of each timed.
    Returns the numbers, the checked runs' `segment_spmm` launches and the
    reduce at the partials' call site."""
    from repro_torch.graph import algorithms as alg
    from repro_torch.graph.distributed import DistributedEngine, ShardedVertexGraph, make_engines_mesh, partial_ell
    from repro_torch.graph.vertex_program import run

    launches, algos, site = 0, {}, None
    for name in ("bfs", "sssp", "pagerank"):
        g = alg.prepare_graph(name, graph)
        program = alg.ALGORITHMS[name]
        one = run(g, program(), device=device)
        rec: dict = {"one_device_iterations": one.num_iterations}
        for pn, (part, perm) in parts.items():
            mesh = make_engines_mesh(perm, num_engines=DIST_ENGINES, device=device)
            eng = DistributedEngine(program(), mesh)
            # PageRank is held at the one-device run's iteration count (its
            # convergence test reads a sum that the empty slots and the
            # order of additions move in the last bits)
            cap = one.num_iterations if name == "pagerank" else DIST_MAX_ITERATIONS
            t0 = time.perf_counter()
            (got, it), counts = counted(lambda: eng.run(g, part, max_iterations=cap))
            r = {"iterations": it, "run_s": time.perf_counter() - t0}
            r["segment_spmm_launches"] = check_only_reduces(
                counts, it if name == "pagerank" else 0, f"{name} ({pn}) on {DIST_ENGINES} engines")
            launches += r["segment_spmm_launches"]
            if name == "pagerank":
                at = one if it == one.num_iterations else run(g, program(), max_iterations=it, device=device)
                check(at.num_iterations == it, f"pagerank ({pn}): {it} iterations, one device {at.num_iterations}")
                r["max_abs_err_rel_to_largest_rank"] = float(np.abs(got - at.props).max() / at.props.max())
                check(r["max_abs_err_rel_to_largest_rank"] <= DIST_PAGERANK_REL,
                      f"pagerank ({pn}): {r['max_abs_err_rel_to_largest_rank']} of the largest rank")
                eng16 = DistributedEngine(program(), mesh, comm_dtype=torch.bfloat16)
                t0 = time.perf_counter()
                (got16, it16), counts = counted(lambda: eng16.run(g, part, max_iterations=DIST_MAX_ITERATIONS))
                r["bf16"] = {"iterations": it16, "run_s": time.perf_counter() - t0,
                             "segment_spmm_launches": check_only_reduces(counts, it16, f"pagerank bf16 ({pn})"),
                             "max_abs_err_rel_to_largest_rank": float(np.abs(got16 - one.props).max()
                                                                      / one.props.max())}
                launches += it16
                check(r["bf16"]["max_abs_err_rel_to_largest_rank"] <= DIST_BF16_REL,
                      f"pagerank bf16 ({pn}): {r['bf16']['max_abs_err_rel_to_largest_rank']} of the largest rank")
            else:
                check(np.array_equal(got, one.props), f"{name} ({pn}): {DIST_ENGINES} stacked engines vs one device")
                r["bit_equal_one_device"] = True
            # one step timed alone (not counted: the run above is the path)
            sg = ShardedVertexGraph.build(g, part)
            r.update(n_local=sg.n_local, e_local=sg.e_local, rehomed_edges=sg.rehomed_edges,
                     exchange_bytes_a_step=sg.exchange_bytes(4))
            if name == "pagerank":
                r["bf16"]["exchange_bytes_a_step"] = sg.exchange_bytes(2)
            props, active = eng.init_state(sg, 0)
            step = eng.step_fn(sg, {k: v for k, v in eng.program.make_aux(g).items() if np.ndim(v) == 0})
            with torch.inference_mode():
                r["ms_a_step"] = timer.call_ms(lambda: step(props, active), calls=10, reps=5)
                r["device_ms_a_step"] = timer.device_ms(lambda: step(props, active), calls=10, reps=5)
            if name == "pagerank" and pn == "powerlaw":
                # the new call site of the reduce: the 16 engines' partials, one block-diagonal ELL, D = 1
                ell = partial_ell(sg, np.arange(DIST_ENGINES), device)
                x = torch.zeros((ell.num_nodes, 1), device=device)
                gen = torch.Generator(device).manual_seed(seed)
                x[: DIST_ENGINES * sg.n_local] = torch.rand((DIST_ENGINES * sg.n_local, 1), device=device,
                                                            generator=gen)
                site = call_site_check(ell, x, timer, reduce_bound_ms)
                del ell, x
            del props, active, step, sg
            rec[pn] = r
        algos[name] = rec
    torch.cuda.empty_cache()
    return algos, launches, site


def nccl_world_one(device: torch.device, graph) -> tuple[dict, int]:
    """PageRank over the "process_group" backend, NCCL at world size 1 from a
    `file://` store in a temporary directory, against the stacked backend at
    P = 1: bit-equal, the same iterations.  The group is destroyed after."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.core.partition import powerlaw_partition
    from repro_torch.graph import algorithms as alg
    from repro_torch.graph.distributed import DistributedEngine, make_engines_mesh

    g = alg.prepare_graph("pagerank", graph)
    part = powerlaw_partition(g.src, g.dst, g.num_nodes, 1)
    stacked = DistributedEngine(alg.pagerank_program(), make_engines_mesh(num_engines=1, device=device))
    (want, want_it), counts = counted(lambda: stacked.run(g, part))
    launches = check_only_reduces(counts, want_it, "pagerank, stacked P = 1")
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store", world_size=1, rank=0)
        try:
            mesh = make_engines_mesh(backend="process_group", device=device)
            t0 = time.perf_counter()
            (got, it), counts = counted(lambda: DistributedEngine(alg.pagerank_program(), mesh).run(g, part))
            run_s = time.perf_counter() - t0
            backend = dist.get_backend()
        finally:
            dist.destroy_process_group()
    launches += check_only_reduces(counts, it, "pagerank, NCCL P = 1")
    r = {"backend": backend, "world_size": 1, "iterations": it, "stacked_iterations": want_it, "run_s": run_s,
         "bit_equal_stacked": bool(np.array_equal(got, want) and it == want_it)}
    check(r["bit_equal_stacked"], "pagerank over NCCL at world size 1 vs the stacked backend at P = 1")
    return r, launches


def halo_gin(device: torch.device, graph, perm: np.ndarray, seed: int, timer: Timer) -> tuple[dict, int, dict]:
    """gin-tu (published width and depth) at `ogb_products`' feature width by
    halo exchange over DIST_ENGINES stacked engines against the one-device
    `gnn.forward` on the same weights; sizes, bytes, time and peak memory.
    Returns the numbers, the forward's launches and the reduce at the halo
    sum's call site (D = d_in)."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.pipeline import GraphBatcher, to_device
    from repro_torch.graph.distributed import make_engines_mesh
    from repro_torch.graph.halo import build_halo_plan, plan_sizes
    from repro_torch.models import gnn
    from repro_torch.models.gnn_dist import gin_forward_halo, gin_halo_loss_fn, pack_batch, shard_batch

    cfg = get_arch(GNN_ARCH).model_config(GNN_WIDE_CELL)
    n = graph.num_nodes
    t0 = time.perf_counter()
    plan = build_halo_plan(graph.src, graph.dst, n, DIST_ENGINES)
    plan_s = time.perf_counter() - t0
    host = GraphBatcher(graph, d_feat=cfg.d_in, n_classes=cfg.d_out, seed=seed).full_batch()
    mesh = make_engines_mesh(perm, num_engines=DIST_ENGINES, device=device)
    t0 = time.perf_counter()
    batch = shard_batch(pack_batch(plan, host["x"], host["labels"], host["train_mask"]), mesh)
    torch.cuda.synchronize()
    shard_s = time.perf_counter() - t0
    params = gnn.init_params(cfg, seed, device=device)
    r = {"arch": GNN_ARCH, "layers": cfg.n_layers, "d_hidden": cfg.d_hidden, "d_in": cfg.d_in,
         "plan": plan_sizes(plan), "plan_host_s": plan_s, "shard_batch_host_s": shard_s,
         "halo_bytes_an_engine_a_layer": {f"D{d}": plan.halo_bytes_per_device(d)
                                          for d in (cfg.d_in, cfg.d_hidden)},
         "ext_rows_bytes": {f"D{d}": DIST_ENGINES * plan.ext_size * d * 4 for d in (cfg.d_in, cfg.d_hidden)}}
    with torch.inference_mode():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        logits, counts = counted(lambda: gin_forward_halo(params, batch, cfg, mesh))
        r["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
        r["forward_peak_above_inputs_gb"] = (torch.cuda.max_memory_allocated() - base) / 1e9
        launches = check_only_reduces(counts, cfg.n_layers, "a halo GIN forward")
        r["segment_spmm_launches_a_forward"] = launches
        loss = float(gin_halo_loss_fn(params, batch, cfg, mesh))
        r["loss"] = loss
        check(np.isfinite(loss), f"halo GIN loss {loss}")
        r["forward_ms"] = timer.call_ms(lambda: gin_forward_halo(params, batch, cfg, mesh), calls=3, reps=5)
        got = np.zeros((n, cfg.d_out), np.float32)
        ok = plan.slot_to_vertex >= 0
        got[plan.slot_to_vertex[ok]] = logits.cpu().numpy()[ok]
        del logits
        full = to_device(host, device)
        full["ell"] = gnn.batch_ell(host, device=device)
        want = gnn.forward(params, full, cfg).cpu().numpy()
        r["max_abs_err_vs_one_device"] = float(np.abs(got - want).max())
        check(np.allclose(got, want, **GNN_TOL), f"halo GIN vs one device: {r['max_abs_err_vs_one_device']}")
        r["one_device_forward_ms"] = timer.call_ms(lambda: gnn.forward(params, full, cfg), calls=3, reps=5)
        del full, want
        torch.cuda.empty_cache()
        # the new call site of the reduce: the halo sum's block-diagonal ELL over the extended rows
        gen = torch.Generator(device).manual_seed(seed)
        x = torch.randn((batch["ell"].num_nodes, cfg.d_in), device=device, generator=gen)
        site = call_site_check(batch["ell"], x, timer, lambda x, ell: (gin_reduce_bound_ms(x, ell), "bytes"))
    del batch, params, x
    torch.cuda.empty_cache()
    return r, launches, site


def phase_distributed(device: torch.device, graph, seed: int, smi: str | None, timer: Timer) -> tuple[dict, int]:
    """The paper's multi-engine paths, DIST_ENGINES engines stacked on the
    card (`engine_runs`, `nccl_world_one`, `halo_gin`).  Returns the numbers
    and the checked runs' `segment_spmm` launches."""
    from repro_torch.core.mapping import DeviceMapper
    from repro_torch.core.partition import random_partition

    n = graph.num_nodes
    t0 = time.perf_counter()
    perm, part, h_opt, h_id = DeviceMapper(DIST_TORUS).device_permutation(graph.src, graph.dst, n)
    mapper_s = time.perf_counter() - t0
    parts = {"powerlaw": (part, perm), "random": (random_partition(graph.src, graph.dst, n, DIST_ENGINES), None)}
    algos, launches, site_pr = engine_runs(device, graph, parts, timer, seed)
    nccl, nccl_launches = nccl_world_one(device, graph)
    halo, halo_launches, site_halo = halo_gin(device, graph, perm, seed, timer)
    launches += nccl_launches + halo_launches
    out = {
        "engines": DIST_ENGINES, "nodes": n, "edges": graph.num_edges, "card": smi,
        "mapper": {"torus": list(DIST_TORUS), "site_permutation": perm.tolist(), "hops_identity": h_id,
                   "hops_optimized": h_opt, "host_s": mapper_s},
        "algorithms": algos, "nccl": nccl, "halo_gin": halo,
        "reduce_call_sites": {"pagerank_partials": site_pr, "halo_gin": site_halo},
        "segment_spmm_launches": launches,
        "tolerance": {"pagerank_rel_to_largest_rank": DIST_PAGERANK_REL,
                      "pagerank_bf16_rel_to_largest_rank": DIST_BF16_REL, "halo_gin_vs_one_device": GNN_TOL,
                      "reduce_vs_plain": F32_TOL, "reduce_vs_library": GIN_REDUCE_TOL},
        "timing": "ms_a_step: one step enqueued back to back, CUDA events over 10 (median of 5); "
                  "device_ms_a_step: the same replayed from a CUDA graph; run_s: host clock around "
                  "DistributedEngine.run (host build of the sharded graph and ELL included); forward_ms: CUDA "
                  "events over 3 forwards; exchange bytes: P·P·n_local·itemsize a step, a copy on one card",
    }
    say("distributed", **out)
    return out, launches


# --------------------------------------------------------------------------- attention


def attention_backward(device: torch.device, timer: Timer, qkv) -> dict:
    """The forward kernel's output and log-sum-exp against the plain
    forward's, then the backward kernel on the kernel's forward against
    `flash_attention_bwd_ref` on the plain forward (test shapes, f32 and bf16,
    causal and not, offsets, rows that see no key; two runs bit-equal; the
    training and serve shapes), then its time at llama's and olmoe's
    training shapes and at the serve path's S beside its bound, the plain
    version and the backward of `scaled_dot_product_attention`."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.kernel import (
        BWD_ROUTES,
        bwd_consumer_groups,
        bwd_kernel_info,
        bwd_kernel_launches,
        flash_attention_cuda,
    )
    from repro_torch.kernels.flash_attention.ops import flash_attention_bwd
    from repro_torch.kernels.flash_attention.ref import flash_attention_bwd_ref, flash_attention_ref

    gen = torch.Generator(device=device).manual_seed(7)
    fwd = {"o_max_abs_err": 0.0, "lse_max_abs_err": 0.0, "cases": 0}

    def largest_diff(a, b):
        return float((a - b).abs().max()) if a.numel() else 0.0

    def case(b, sq, skv, hq, hkv, dh, dtype, causal, off):
        """Inputs, the kernel's forward (o, lse) held against the plain
        forward's, and the plain forward (o, lse) for the plain backward."""
        q, k, v = qkv(b, sq, skv, hq, hkv, dh, dtype)
        o, lse = flash_attention_cuda(q, k, v, causal=causal, q_offset=off, with_lse=True)
        o_ref, lse_ref = flash_attention_ref(q, k, v, causal=causal, q_offset=off, return_lse=True)
        do = torch.randn(o.shape, generator=gen, device=device).to(dtype)
        torch.cuda.synchronize()
        what = (b, sq, skv, hq, hkv, dh, causal, off, str(dtype))
        check(lse.shape == (b, hq, sq) and lse.dtype == torch.float32, f"lse shape/dtype at {what}")
        sees = (torch.arange(sq, device=device) + off >= 0) if causal else torch.ones(sq, dtype=torch.bool,
                                                                                         device=device)
        no_key = ~sees
        check(bool((lse[:, :, no_key] <= LSE_NO_KEY).all() and (lse_ref[:, :, no_key] <= LSE_NO_KEY).all()),
              f"lse of rows that see no key at {what}")
        tag = "f32" if dtype == torch.float32 else "bf16"
        lse_err = largest_diff(lse[:, :, sees], lse_ref[:, :, sees])
        check(torch.allclose(lse[:, :, sees], lse_ref[:, :, sees], **LSE_TOL[tag]),
              f"forward lse vs plain version at {what}: max abs err {lse_err}")
        o_seen, o_ref_seen = o[:, sees].float(), o_ref[:, sees].float()
        o_err = largest_diff(o_seen, o_ref_seen)
        check(torch.allclose(o_seen, o_ref_seen, **(F32_TOL if tag == "f32" else BF16_TOL)),
              f"forward o vs plain version at {what}: {o_err}")
        fwd["o_max_abs_err"] = max(fwd["o_max_abs_err"], o_err)
        fwd["lse_max_abs_err"] = max(fwd["lse_max_abs_err"], lse_err)
        fwd["cases"] += 1
        return q, k, v, o, do, lse, o_ref, lse_ref

    worst = {"f32": 0.0, "bf16": 0.0}
    max_abs = 0.0
    cases = 0
    runs = [(shape, causal, (shape[2] - shape[1]) if causal else 0)
            for shape in ATTN_BWD_TEST_SHAPES for causal in (True, False)]
    runs += [(ATTN_BWD_TEST_SHAPES[-1], True, off) for off in ATTN_BWD_OFFSETS]
    for shape, causal, off in runs:
        for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            q, k, v, o, do, lse, o_ref, lse_ref = case(*shape, dtype, causal, off)
            got = flash_attention_bwd(q, k, v, o, do, lse, causal=causal, q_offset=off)
            again = flash_attention_bwd(q, k, v, o, do, lse, causal=causal, q_offset=off)
            want = flash_attention_bwd_ref(q, k, v, o_ref, do, lse_ref, causal=causal, q_offset=off)
            torch.cuda.synchronize()
            what = (*shape, causal, off, tag)
            check(all(torch.equal(a, b) for a, b in zip(got, again)), f"backward: two runs differ at {what}")
            for a, b in zip(got, want):
                scale = float(b.float().abs().max()) + 1e-6
                err = float((a.float() - b.float()).abs().max())
                check(a.dtype == q.dtype and err <= BWD_REL[tag] * scale,
                      f"backward vs plain version at {what}: {err} of {scale}")
                worst[tag] = max(worst[tag], err / scale)
                max_abs = max(max_abs, err)
            if off < 0:
                check(bool((got[0][:, :-off] == 0).all()), "rows that see no key must add no gradient")
            cases += 1

    timed = {}
    for name, (b, s, hq, hkv, dh) in (("train", ATTN_TRAIN_SHAPE), ("moe_train", ATTN_MOE_TRAIN_SHAPE),
                                       ("serve", (1, ATTN_TIMED_S, 24, 8, 128))):
        q, k, v, o, do, lse, o_ref, lse_ref = case(b, s, s, hq, hkv, dh, torch.bfloat16, True, 0)
        bound, by = attention_bwd_bound_ms(q, k, True, 0)
        before = bwd_kernel_launches()
        flash_attention_bwd(q, k, v, o, do, lse, causal=True)
        ran = {n: c - before[n] for n, c in bwd_kernel_launches().items()}
        check(ran == BWD_BF16_ROUTE, f"bf16 backward at the {name} shape launched {ran}, want {BWD_BF16_ROUTE}")
        split = kernel_split_ms(lambda: flash_attention_bwd(q, k, v, o, do, lse, causal=True), ATTN_BWD_GROUPS)
        ms = timer.device_ms(lambda: flash_attention_bwd(q, k, v, o, do, lse, causal=True), calls=5, reps=10)
        # yardstick, used nowhere in the port: the backward of one library call in its own layout
        qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True) for t in (q, k, v))
        lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
        dot = do.transpose(1, 2).contiguous()
        lib = torch.autograd.grad(lib_out, (qt, kt, vt), dot, retain_graph=True)
        ours = flash_attention_bwd(q, k, v, o, do, lse, causal=True)
        plain = flash_attention_bwd_ref(q, k, v, o_ref, do, lse_ref, causal=True)
        torch.cuda.synchronize()
        held = []
        for got, want in zip(ours, plain):  # the kernel at the path's shape, against its plain version
            scale = float(want.float().abs().max()) + 1e-6
            held.append(float((got.float() - want.float()).abs().max()) / scale)
            check(held[-1] <= BWD_REL["bf16"], f"backward vs plain version at the {name} shape: {held[-1]}")
        worst["bf16"] = max(worst["bf16"], *held)
        del plain
        lib_err = max(float((a.float() - b.transpose(1, 2).float()).abs().max() / (b.float().abs().max() + 1e-6))
                      for a, b in zip(ours, lib))
        timed[name] = {
            "q": [b, s, hq, dh], "k": [b, s, hkv, dh], "dtype": "bfloat16", "causal": True,
            "ms": ms, "call_ms": timer.call_ms(lambda: flash_attention_bwd(q, k, v, o, do, lse, causal=True),
                                               calls=5, reps=10),
            "tflops": 2.5 * attention_flops(q, k, True, 0) / (ms * 1e-3) / 1e12,
            "bound_ms": bound, "bound_by": by,
            "plain_ms": timer.call_ms(lambda: flash_attention_bwd_ref(q, k, v, o_ref, do, lse_ref, causal=True),
                                      calls=2, reps=3),
            "library_ms": timer.call_ms(lambda: torch.autograd.grad(lib_out, (qt, kt, vt), dot, retain_graph=True),
                                        calls=5, reps=10),
            "max_rel_err_vs_plain": max(held), "max_rel_err_vs_library": lib_err,
            "kernels_ms": split if any(split.values()) else "not measured (the profiler saw no kernel)",
            "kernels_launched_a_call": ran,
            "consumer_groups": bwd_consumer_groups(b, s, s, hq, hkv),
        }
        del q, k, v, o, do, lse, o_ref, lse_ref, qt, kt, vt, lib_out, lib, ours
        torch.cuda.empty_cache()
    return {"test_cases": cases, "max_rel_err_f32": worst["f32"], "max_rel_err_bf16": worst["bf16"],
            "max_abs_err": max_abs, "tolerance_rel": BWD_REL, "bit_equal_two_runs": True,
            "forward_with_lse": {**fwd, "tolerance_lse": LSE_TOL, "lse_no_key_at_most": LSE_NO_KEY,
                                 "tolerance_o_f32": F32_TOL, "tolerance_o_bf16": BF16_TOL},
            "rows_that_see_no_key_add_nothing": True, "timed": timed,
            "route_bf16": BWD_ROUTES[torch.bfloat16], "route_f32": BWD_ROUTES[torch.float32],
            "kernel_resources": {"dkdv_dh128": bwd_kernel_info(128, 2, "dkdv"),
                                 **{f"dq_dh128_q{64 * nc}": bwd_kernel_info(128, nc, "dq") for nc in (1, 2)}},
            "timing": "ms: device time replayed from a CUDA graph (one call = the D, dK/dV and dQ kernels); "
                      "kernels_ms: each kernel's device time a call (torch.profiler, device activity, 5 calls); "
                      "kernels_launched_a_call: the library's own launch counts over one call; "
                      "kernel_resources: cudaFuncGetAttributes of the bf16 kernels (registers a thread, "
                      "local_bytes = spills) at dh 128, dQ at one and two consumer warpgroups; "
                      "call_ms, plain_ms (flash_attention_bwd_ref), library_ms (torch.autograd.grad of "
                      "scaled_dot_product_attention(is_causal, enable_gqa) on (B, H, S, dh) copies, its forward "
                      "done once): calls enqueued back to back; max_rel_err_vs_library: largest difference of a "
                      "gradient over its largest magnitude (each from its own forward), recorded, not checked"}


def phase_attention(device: torch.device, timer: Timer) -> dict:
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.kernel import kernel_info
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    rng = np.random.default_rng(1)

    def qkv(b, sq, skv, hq, hkv, dh, dtype):
        return [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(device).to(dtype)
                for s in ((b, sq, hq, dh), (b, skv, hkv, dh), (b, skv, hkv, dh))]

    def held(q, k, v, causal, off, tol, what):
        got = flash_attention(q, k, v, causal=causal, q_offset=off)
        again = flash_attention(q, k, v, causal=causal, q_offset=off)
        want = flash_attention_ref(q, k, v, causal=causal, q_offset=off)
        torch.cuda.synchronize()
        check(got.dtype == q.dtype and got.shape == q.shape, f"shape/dtype at {what}")
        check(torch.equal(got, again), f"two runs differ at {what}")
        err = float((got.float() - want.float()).abs().max())
        check(torch.allclose(got.float(), want.float(), **tol), f"kernel vs plain version at {what}: max abs err {err}")
        return err

    max_err = {"f32": 0.0, "bf16": 0.0}
    cases = 0
    for b, sq, skv, hq, hkv, dh in ATTN_TEST_SHAPES:
        for causal in (True, False):
            for dtype, tag, tol in ((torch.float32, "f32", F32_TOL), (torch.bfloat16, "bf16", BF16_TOL)):
                q, k, v = qkv(b, sq, skv, hq, hkv, dh, dtype)
                off = skv - sq if causal else 0
                err = held(q, k, v, causal, off, tol, (b, sq, skv, hq, hkv, dh, causal, tag))
                max_err[tag] = max(max_err[tag], err)
                cases += 1

    # yardstick, used nowhere in the port: one library call in its own (B, H, S, dh) layout
    def library(q, k, v):
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        return lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)

    path = []
    timed = None
    for s in ATTN_PATH_S:
        q, k, v = qkv(1, s, s, 24, 8, 128, torch.bfloat16)
        err = held(q, k, v, True, 0, BF16_TOL, ("path", s))
        bound, by = attention_bound_ms(q, k, True, 0)
        ms = timer.device_ms(lambda: flash_attention(q, k, v, causal=True))
        lib = library(q, k, v)
        path.append({"S": s, "max_abs_err": err, "ms": ms, "tflops": attention_flops(q, k, True, 0) / (ms * 1e-3) / 1e12,
                     "bound_ms": bound, "bound_by": by, "library_ms": timer.call_ms(lib),
                     "library_device_ms": timer.device_ms(lib)})
        if s == ATTN_TIMED_S:
            timed = (q, k, v)
    path_err = max(p["max_abs_err"] for p in path)
    resources = {f"dh128_q{64 * nc}": kernel_info(128, nc) for nc in (1, 2)}

    q, k, v = timed
    refused = False
    before = flash_attention.launches
    try:
        flash_attention(q, k, v, kv_valid_len=torch.full((1,), 100, device=device))
    except NotImplementedError:
        refused = True
    check(refused and flash_attention.launches == before, "kv_valid_len on the kernel's route must raise")

    ms = timer.device_ms(lambda: flash_attention(q, k, v, causal=True))
    call_ms = timer.call_ms(lambda: flash_attention(q, k, v, causal=True))
    plain_ms = timer.call_ms(lambda: flash_attention_ref(q, k, v, causal=True), calls=3, reps=5)
    lib_fn = library(q, k, v)
    lib = lib_fn().transpose(1, 2)
    ours = flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    lib_err = float((lib.float() - ours.float()).abs().max())
    check(torch.allclose(lib.float(), ours.float(), **BF16_TOL), f"kernel vs scaled_dot_product_attention: {lib_err}")
    library_ms = timer.call_ms(lib_fn)
    library_device_ms = timer.device_ms(lib_fn)
    bound_ms, bound_by = attention_bound_ms(q, k, True, 0)
    backward = attention_backward(device, timer, qkv)
    out = {
        "backward": backward,
        "test_cases": cases, "max_abs_err_f32": max_err["f32"], "max_abs_err_bf16": max_err["bf16"],
        "tolerance_f32": F32_TOL, "tolerance_bf16": BF16_TOL, "bit_equal_two_runs": True,
        "kv_valid_len_refused": refused, "path": path, "path_max_abs_err": path_err,
        "timed_shape": {"q": list(q.shape), "k": list(k.shape), "dtype": "bfloat16", "causal": True},
        "kernel_ms": ms, "kernel_call_ms": call_ms, "ref_ms": plain_ms, "library_ms": library_ms,
        "library_device_ms": library_device_ms,
        "library_max_abs_err": lib_err, "bound_ms": bound_ms, "bound_by": bound_by,
        "achieved_tflops": attention_flops(q, k, True, 0) / (ms * 1e-3) / 1e12,
        "library_device_tflops": attention_flops(q, k, True, 0) / (library_device_ms * 1e-3) / 1e12,
        "kernel_resources": resources,
        "timing": "warm medians with CUDA events. kernel_ms, path[].ms, library_device_ms: device time, "
                  "replayed from a CUDA graph; kernel_call_ms, ref_ms, library_ms: calls enqueued back to back "
                  "from Python. library: scaled_dot_product_attention(is_causal, enable_gqa) on (B, H, S, dh) "
                  "copies made once. kernel_resources: cudaFuncGetAttributes of the bf16 kernel (registers at "
                  "launch; the consumer warpgroups raise theirs to 232 with setmaxnreg at 128-row tiles)",
    }
    say("attention", **out)
    return out


# --------------------------------------------------------------------------- serve


ATTN_GROUPS = {"flash_attention_ms": ("attn_bf16_wgmma",)}
# the bf16 backward's three kernels (the float32 route's are attn_bwd_dkdv<float, ...>, attn_bwd_dq<...>),
# and what one bf16 call launches, as the library counts them (`kernel.bwd_kernel_launches`)
BWD_BF16_ROUTE = {"attn_bwd_delta": 1, "attn_bwd_dkdv_wgmma": 1, "attn_bwd_dq_wgmma": 1, "attn_bwd_dkdv": 0,
                  "attn_bwd_dq": 0}
ATTN_BWD_GROUPS = {"delta_ms": ("attn_bwd_delta",), "dkdv_wgmma_ms": ("attn_bwd_dkdv_wgmma",),
                   "dq_wgmma_ms": ("attn_bwd_dq_wgmma",)}


def device_rows(prof) -> list[tuple[float, str, int]]:
    """(device µs, kernel name, calls) of a finished `torch.profiler` session,
    device rows only, longest first; the spin kernel that starts a session
    (`profile_window`) is left out."""
    from torch.autograd import DeviceType

    def device_us(e):
        for name in ("self_device_time_total", "self_cuda_time_total"):
            v = getattr(e, name, None)
            if v is not None:
                return float(v)
        return 0.0

    return sorted(((device_us(e), e.key, e.count) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and "Activity Buffer" not in e.key
                   and "spin_kernel" not in e.key), reverse=True)


def summarize_profile(rows, wall_s: float, groups: dict) -> dict:
    """Device time and busy share over `wall_s`; `groups` maps a key to the
    kernel-name pieces whose device time it sums."""
    total = sum(r[0] for r in rows) / 1e3
    by_group = {key: sum(r[0] for r in rows if any(p in r[1] for p in pieces)) / 1e3
                for key, pieces in groups.items()}
    return {"wall_ms": wall_s * 1e3, "device_ms": total, "device_busy_share": total / (wall_s * 1e3),
            **by_group,
            "top_kernels": [{"name": k[:80], "device_ms": us / 1e3, "calls": n} for us, k, n in rows[:8]]}


def kernel_split_ms(fn, groups: dict, calls: int = 5) -> dict:
    """Device ms a call of `fn` by kernel group (`groups` maps a key to the
    kernel-name pieces it sums), from `torch.profiler` with device activity
    only over `calls` calls after a warm one."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = [(float(getattr(e, "self_device_time_total", 0.0) or getattr(e, "self_cuda_time_total", 0.0)), e.key)
            for e in prof.key_averages()]
    return {key: sum(us for us, name in rows if any(p in name for p in pieces)) / 1e3 / calls
            for key, pieces in groups.items()}


def profile_window(fn, groups: dict = ATTN_GROUPS) -> dict:
    """Device time by kernel over one call of `fn` (`torch.profiler`), summed
    over device rows only, beside the wall time; `groups` maps a key to the
    kernel-name pieces whose device time it sums.  A session can lose its
    first kernel (gin-tu's first reduce went missing from one), so a short
    spin kernel goes first and is left out of the sums."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return summarize_profile(device_rows(prof), wall, groups)


def drain_timed(engine, prompts, new_tokens: int, route_logs: dict | None = None):
    """Submit `prompts` and drain `engine`, every prefill and decode call timed
    on the host clock (synchronised on both sides) and its logits checked
    finite; `flash_attention.launches` counts from 0 over the drain.  With
    `route_logs` ({"prefill": [], "decode": []}) each call appends the list
    of its MoE routings (`moe_block.route_log`, and `ep_log` on a mesh)
    there.  Returns (done, stats, wall_s, launches)."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.models.moe import moe_block
    from repro_torch.serve.engine import Request

    prefill_one, decode = engine.prefill_one, engine.decode
    st = {"prefill_s": 0.0, "decode_s": 0.0, "prefill_tokens": 0, "decode_tokens": 0, "decode_steps": 0,
          "finite": True}

    def timed(kind, fn, *args):
        if route_logs is not None:
            route_logs[kind].append([])
            moe_block.route_log = moe_block.ep_log = route_logs[kind][-1]
        torch.cuda.synchronize()
        t = time.perf_counter()
        try:
            out = fn(*args)
            torch.cuda.synchronize()
        finally:
            moe_block.route_log = moe_block.ep_log = None
        st[f"{kind}_s"] += time.perf_counter() - t
        return out

    def timed_prefill(cache, slot, tokens):
        cache, logits = timed("prefill", prefill_one, cache, slot, tokens)
        st["prefill_tokens"] += int(tokens.shape[1])
        st["finite"] &= bool(torch.isfinite(logits).all())
        return cache, logits

    def timed_decode(cache, tokens, pos):
        live = sum(a is not None for a in engine.active)
        logits, cache = timed("decode", decode, cache, tokens, pos)
        st["decode_tokens"] += live
        st["decode_steps"] += 1
        st["finite"] &= bool(torch.isfinite(logits).all())
        return logits, cache

    engine.prefill_one, engine.decode = timed_prefill, timed_decode
    for i, p in enumerate(prompts):
        engine.submit(Request(uid=i, prompt=p, max_new_tokens=new_tokens))
    flash_attention.launches = 0  # the path's own count starts here
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        done = engine.run_until_drained()
        torch.cuda.synchronize()
    finally:
        engine.prefill_one, engine.decode = prefill_one, decode
    return done, st, time.perf_counter() - t0, flash_attention.launches


def logit_checks(cfg, params32: dict, params: dict, toks: torch.Tensor, device: torch.device) -> dict:
    """Full-width logit checks on one prompt `toks` (1, n), each route in a
    one-slot cache of its own: the float32 model through the kernel (prefill,
    and prefill of n - 1 then one decode step) within MODEL_TOL of the float32
    model through the plain attention (the truth); the bf16 model's kernel
    route and decode no further from the truth than its plain route, by
    BF16_ROUTE_FACTOR (mean abs error).  With MoE layers decode is held to a
    truth of its own (the float32 model, plain prefill of n - 1, one decode
    step) beside the bf16 plain route's decode: the prefill's capacity, from
    n tokens, may drop the last token's slots where one decode step's (C = 8)
    drops none, so decode and prefill differ by design.  Raises on a failure."""
    from repro_torch.models import transformer as tfm

    n = toks.shape[1]
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)

    def last(c, prm, impl="auto", decode_last=False):
        c = dataclasses.replace(c, attn_impl=impl)
        cache = tfm.init_kv_cache(c, 1, n, dtype=torch.float32, device=device)
        if not decode_last:
            return tfm.prefill(prm, toks, cache, c)[0].float()
        tfm.prefill(prm, toks[:, :-1], cache, c)
        return tfm.decode_step_batched_pos(prm, cache, torch.full((1,), n - 1, device=device), toks[:, -1:], c)[0].float()

    truth = last(cfg32, params32, "ref")  # float32 activations, plain attention
    k32, d32 = last(cfg32, params32), last(cfg32, params32, decode_last=True)
    kb, rb, db = last(cfg, params), last(cfg, params, "ref"), last(cfg, params, decode_last=True)
    if cfg.moe is not None:
        truth_d, rbd = last(cfg32, params32, "ref", decode_last=True), last(cfg, params, "ref", decode_last=True)
    else:
        truth_d, rbd = truth, rb
    torch.cuda.synchronize()

    def err(a, b):
        return float((a - b).abs().max()), float((a - b).abs().mean())

    checks = {
        "prompt_tokens": n, "truth": "float32 activations, impl='ref'", "truth_std": float(truth.std()),
        "f32_kernel_vs_ref": err(k32, truth), "f32_decode_vs_prefill": err(d32, k32),
        "bf16_kernel_vs_truth": err(kb, truth), "bf16_ref_vs_truth": err(rb, truth),
        "bf16_decode_vs_truth": err(db, truth), "bf16_kernel_vs_ref": err(kb, rb),
        "bf16_kernel_vs_ref_within_one_op_tolerance": float(
            torch.isclose(kb, rb, **BF16_TOL).float().mean()),
        "argmax_equal_kernel_ref_truth": [int(kb.argmax()), int(rb.argmax()), int(truth.argmax())],
        "tolerance_f32": MODEL_TOL, "bf16_route_factor": BF16_ROUTE_FACTOR, "errors": "[max abs, mean abs]",
    }
    check(torch.allclose(k32, truth, **MODEL_TOL), f"f32 logits, kernel vs ref: {checks['f32_kernel_vs_ref']}")
    floor = checks["bf16_ref_vs_truth"][1]
    check(checks["bf16_kernel_vs_truth"][1] <= BF16_ROUTE_FACTOR * floor,
          f"bf16 logits, kernel route less accurate than the plain route: {checks}")
    if cfg.moe is None:
        check(torch.allclose(d32, k32, **MODEL_TOL),
              f"f32 logits, decode vs prefill: {checks['f32_decode_vs_prefill']}")
        check(checks["bf16_decode_vs_truth"][1] <= BF16_ROUTE_FACTOR * floor,
              f"bf16 logits, decode less accurate than the plain prefill: {checks}")
        return checks
    checks.update({"decode_truth": "float32 activations, impl='ref' prefill of n - 1, one decode step",
                   "f32_decode_vs_decode_truth": err(d32, truth_d), "bf16_decode_vs_decode_truth": err(db, truth_d),
                   "bf16_ref_decode_vs_decode_truth": err(rbd, truth_d)})
    check(torch.allclose(d32, truth_d, **MODEL_TOL), f"f32 logits, decode vs its truth: {checks}")
    check(checks["bf16_decode_vs_decode_truth"][1] <= BF16_ROUTE_FACTOR * checks["bf16_ref_decode_vs_decode_truth"][1],
          f"bf16 logits, decode less accurate than the plain route's decode: {checks}")
    return checks


def phase_serve(device: torch.device, seed: int, smi: str | None) -> tuple[dict, int]:
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.serve import build_engine
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import gqa_attention

    cfg = get_arch(SERVE_ARCH).model_config()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params32 = tfm.init_params(cfg, seed, device=device)  # a seeded torch.Generator on the card
    params = tfm.cast_params(params32, cfg)  # the weights as served: one bf16 copy
    engine = build_engine(cfg, params, slots=SERVE_SLOTS, max_seq=SERVE_MAX_SEQ, device=device)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    shape = (cfg.n_layers, SERVE_SLOTS, SERVE_MAX_SEQ, cfg.n_kv_heads, cfg.head_dim)
    check(engine.cache["k"].dtype == torch.float32 and tuple(engine.cache["k"].shape) == shape, "the KV cache")

    rng = np.random.default_rng(seed)
    lengths = rng.integers(*SERVE_PROMPT, size=SERVE_REQUESTS)
    prompts = [rng.integers(2, cfg.vocab, size=int(n)).astype(np.int32) for n in lengths]

    # first use of each operator (cuBLAS handles, kernel loads) before anything is timed
    prefill_one, decode = engine.prefill_one, engine.decode
    engine.cache, _ = prefill_one(engine.cache, 0, torch.from_numpy(prompts[0][None, :256].astype(np.int64)))
    _, engine.cache = decode(engine.cache, torch.zeros((SERVE_SLOTS, 1), dtype=torch.long),
                             torch.zeros(SERVE_SLOTS, dtype=torch.long))
    torch.cuda.synchronize()

    done, st, wall_s, launches = drain_timed(engine, prompts, SERVE_NEW)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    check(len(done) == SERVE_REQUESTS, f"{len(done)} of {SERVE_REQUESTS} requests drained")
    for r in done:
        check(len(r.out_tokens) == SERVE_NEW or r.out_tokens[-1] == engine.eos_id,
              f"request {r.uid}: {len(r.out_tokens)} tokens")
    check(launches == cfg.n_layers * SERVE_REQUESTS, f"flash_attention launched {launches} times, "
          f"want {cfg.n_layers} a prefill × {SERVE_REQUESTS}")
    check(st["finite"], "non-finite logits")

    # full-width logit checks on request 0's prompt
    toks = torch.from_numpy(prompts[0][None, :].astype(np.int64)).to(device)
    checks = logit_checks(cfg, params32, params, toks, device)
    checks["first_token_engine"] = done[[r.uid for r in done].index(0)].out_tokens[0]
    del params32

    # where the time goes: one prefill (request 0's prompt, slot 0) and 8 decode steps
    pos = torch.from_numpy(engine.pos.astype(np.int64))
    prof_prefill = profile_window(lambda: prefill_one(engine.cache, 0, toks.cpu()))
    check(prof_prefill["flash_attention_ms"] > 0, "the prefill profile found no flash-attention kernel by name")
    step_tokens = torch.zeros((SERVE_SLOTS, 1), dtype=torch.long)

    def eight_steps():
        for _ in range(8):
            decode(engine.cache, step_tokens, pos)

    prof_decode = profile_window(eight_steps)
    # decode attention alone at the engine's shapes: 4 slots over the float32 cache
    qd = torch.randn((SERVE_SLOTS, 1, cfg.n_heads, cfg.head_dim), device=device).bfloat16()
    valid = torch.full((SERVE_SLOTS,), 2048, device=device)
    ck, cv = engine.cache["k"][0], engine.cache["v"][0]
    timer = Timer()
    decode_attn_ms = timer.call_ms(lambda: gqa_attention(qd, ck, cv, causal=False, kv_valid_len=valid))

    out = {
        "arch": SERVE_ARCH, "layers": cfg.n_layers, "d_model": cfg.d_model, "heads": cfg.n_heads,
        "kv_heads": cfg.n_kv_heads, "head_dim": cfg.head_dim, "d_ff": cfg.d_ff, "vocab": cfg.vocab,
        "params": cfg.num_params, "activations": "bfloat16", "cuts": [],
        "slots": SERVE_SLOTS, "max_seq": SERVE_MAX_SEQ, "kv_cache": "float32",
        "requests": SERVE_REQUESTS, "prompt_lengths": [int(x) for x in lengths], "max_new_tokens": SERVE_NEW,
        "new_tokens": [len(r.out_tokens) for r in sorted(done, key=lambda r: r.uid)],
        "setup_s": setup_s, "wall_s": wall_s,
        "prefill_s": st["prefill_s"], "prefill_tokens": st["prefill_tokens"],
        "prefill_tok_s": st["prefill_tokens"] / st["prefill_s"],
        "decode_s": st["decode_s"], "decode_steps": st["decode_steps"], "decode_tokens": st["decode_tokens"],
        "decode_tok_s": st["decode_tokens"] / st["decode_s"],
        "flash_attention_launches": launches, "max_memory_allocated_gb": peak_gb,
        "logit_checks": checks,
        "profile_prefill": prof_prefill, "profile_8_decode_steps": prof_decode,
        "decode_attention_layer_ms": decode_attn_ms,
        "timing": "host clock around each prefill / decode call, synchronised on both sides; "
                  "profiles with torch.profiler after the drain; decode_attention_layer_ms: one layer's "
                  "gqa_attention at the engine's decode shapes, calls back to back, CUDA events",
        "card": smi,
    }
    say("serve", **out)
    return out, launches


# --------------------------------------------------------------------------- training

LM_TRAIN_ARCH = "llama3.2-3b"
LM_TRAIN_BATCH, LM_TRAIN_SEQ = 8, 128  # launch.train's defaults
GNN_TRAIN_ARCHS = ("gin-tu", "gat-cora", "pna")
PROFILED_STEP = 5  # one step in the first half, so the last ten are not slowed by the profiler
LM_GROUPS = {"gemm_ms": ("gemm", "xmma", "cutlass", "nvjet", "sm90_"), "attention_forward_ms": ("attn_bf16_wgmma",),
             "attention_backward_ms": ("attn_bwd_",)}


class StepRecorder:
    """`on_step` for `launch.train.train`: each step's loss and the host
    clock at its synchronised end; `torch.profiler` over step
    `profiled_step` alone (started at the end of the step before it; None:
    no profile)."""

    def __init__(self, groups: dict, profiled_step: int | None = PROFILED_STEP):
        self.losses, self.ends, self.groups = [], [], groups
        self.profiled_step = profiled_step
        self.profile = None
        self._prof = None

    def __call__(self, state, metrics, batch):
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        now = time.perf_counter()
        self.losses.append(metrics["loss"])
        self.ends.append(now)
        if self.profiled_step is None:
            return
        if metrics["step"] == self.profiled_step - 1:
            self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self._prof.__enter__()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            self._t0 = time.perf_counter()
        elif metrics["step"] == self.profiled_step:
            self._prof.__exit__(None, None, None)
            self.profile = summarize_profile(device_rows(self._prof), now - self._t0, self.groups)
            self._prof = None

    def step_ms(self) -> float:
        """Median wall of the last ten steps (end to end of consecutive steps)."""
        walls = np.diff(self.ends)[-10:] * 1e3
        return float(np.median(walls))

    def float_losses(self) -> list[float]:
        return [float(x) for x in self.losses]


def phase_train(device: torch.device, seed: int, smi: str | None, timer: Timer) -> tuple[dict, dict]:
    """`launch.train.train`, the code path of `python -m repro_torch.launch.train`:
    llama3.2-3b at its published width and depth for TRAIN_STEPS steps at the
    reference's defaults (batch 8, seq 128, lr 1e-3, AdamW with clip 1.0, a
    recompute a layer), then gin-tu, gat-cora and pna at `full_graph_sm`'s
    widths on the reference's graph (R-MAT, 512 nodes, 4,096 edges), and
    graphcast refused.  The kernels' counts are set to 0 just before and read
    just after; returns the numbers and the counts."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels.flash_attention.kernel import bwd_kernel_launches
    from repro_torch.kernels.flash_attention.ops import flash_attention, flash_attention_bwd
    from repro_torch.kernels.segment_spmm.ops import segment_spmm
    from repro_torch.launch.train import GRAPHCAST_REFUSAL, train
    from repro_torch.train.optim import adamw, cosine_schedule

    cfg = get_arch(LM_TRAIN_ARCH).model_config()
    rec = StepRecorder(LM_GROUPS)
    log = []
    gc.collect()  # what the earlier phases left in reference cycles
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = flash_attention_bwd.launches = segment_spmm.launches = 0
    bwd_before = bwd_kernel_launches()
    t0 = time.perf_counter()
    state = train(LM_TRAIN_ARCH, steps=TRAIN_STEPS, batch=LM_TRAIN_BATCH, seq=LM_TRAIN_SEQ, lr=TRAIN_LR,
                  device=device, seed=seed, on_step=rec, log_fn=log.append)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = {"flash_attention": flash_attention.launches, "flash_attention_bwd": flash_attention_bwd.launches}
    bwd_kernels = {n: c - bwd_before[n] for n, c in bwd_kernel_launches().items()}
    check(bwd_kernels == {n: c * launches["flash_attention_bwd"] for n, c in BWD_BF16_ROUTE.items()},
          f"the backward's kernels on the training path: {bwd_kernels}, want the bf16 wgmma route each call")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = rec.float_losses()
    check(state.step == TRAIN_STEPS and len(losses) == TRAIN_STEPS, f"llama trained {state.step} steps")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0], f"llama losses: {losses}")
    check(launches["flash_attention"] == 2 * cfg.n_layers * TRAIN_STEPS,
          f"attention forward launches {launches['flash_attention']}, want 2 a layer a step (recompute)")
    check(launches["flash_attention_bwd"] == cfg.n_layers * TRAIN_STEPS,
          f"attention backward launches {launches['flash_attention_bwd']}, want 1 a layer a step")
    check(segment_spmm.launches == 0, "the LM path launched the ELL reduce")
    step_ms = rec.step_ms()
    # the optimizer alone: one AdamW update (clip included) of every leaf, after training.  The
    # params stand in for their own gradients (a 14.4 GB gradient tree would not fit beside
    # params, mu and nu); the same work on the same shapes, and the values are thrown away
    opt = adamw(cosine_schedule(TRAIN_LR, 10, TRAIN_STEPS))
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    opt_ms = []
    for _ in range(3):
        ev[0].record()
        opt.update(state.params, state.opt_state, state.params, TRAIN_STEPS)
        ev[1].record()
        torch.cuda.synchronize()
        opt_ms.append(ev[0].elapsed_time(ev[1]))
    del state
    torch.cuda.empty_cache()
    prof = rec.profile
    prof["optimizer_ms_measured_alone"] = statistics.median(opt_ms)
    prof["other_ms"] = prof["device_ms"] - prof["gemm_ms"] - prof["attention_forward_ms"] - prof["attention_backward_ms"]
    lm = {
        "arch": LM_TRAIN_ARCH, "layers": cfg.n_layers, "d_model": cfg.d_model, "heads": cfg.n_heads,
        "kv_heads": cfg.n_kv_heads, "d_ff": cfg.d_ff, "vocab": cfg.vocab, "params": cfg.num_params,
        "param_dtype": "float32", "activations": "bfloat16", "remat": cfg.remat, "cuts": [],
        "batch": LM_TRAIN_BATCH, "seq": LM_TRAIN_SEQ, "steps": TRAIN_STEPS, "lr": TRAIN_LR, "losses": losses,
        "wall_s": wall_s, "step_ms_median_last10": step_ms,
        "tokens_per_s": LM_TRAIN_BATCH * LM_TRAIN_SEQ / (step_ms / 1e3),
        "max_memory_allocated_gb": peak_gb, "profile_one_step": prof,
        "flash_attention_launches_a_step": launches["flash_attention"] / TRAIN_STEPS,
        "flash_attention_bwd_launches_a_step": launches["flash_attention_bwd"] / TRAIN_STEPS,
        "flash_attention_bwd_kernel_launches": bwd_kernels,
        "log": log,
    }

    gnns = {}
    segment_spmm.launches = 0
    for arch in GNN_TRAIN_ARCHS:
        gcfg = get_arch(arch).model_config("full_graph_sm")
        grec = StepRecorder({"segment_fused_ms": ("segment_fused",), "gemm_ms": ("gemm", "xmma", "cutlass", "nvjet")})
        before = segment_spmm.launches
        st = train(arch, steps=TRAIN_STEPS, lr=TRAIN_LR, device=device, seed=seed, on_step=grec,
                   log_fn=lambda _: None)
        torch.cuda.synchronize()
        n_launch = segment_spmm.launches - before
        gl = grec.float_losses()
        check(st.step == TRAIN_STEPS and all(np.isfinite(gl)), f"{arch}: losses {gl}")
        want = (2 * gcfg.n_layers - 1) * TRAIN_STEPS if gcfg.kind == "gin" else 0
        check(n_launch == want, f"{arch}: {n_launch} segment_spmm launches in training, want {want}")
        gnns[arch] = {"kind": gcfg.kind, "layers": gcfg.n_layers, "d_hidden": gcfg.d_hidden, "d_in": gcfg.d_in,
                      "params": gcfg.num_params, "losses": gl, "step_ms_median_last10": grec.step_ms(),
                      "segment_spmm_launches_a_step": n_launch / TRAIN_STEPS, "profile_one_step": grec.profile}
        del st
    gnn_launches = segment_spmm.launches
    gnns[GNN_ARCH]["held_against_scatter"] = gin_training_held(device, seed)  # after the count is read
    refused = None
    try:
        train("graphcast", steps=1, device=device, seed=seed, log_fn=lambda _: None)
    except SystemExit as e:
        refused = str(e)
    check(refused == GRAPHCAST_REFUSAL, f"graphcast training must be refused as the reference refuses it: {refused}")
    torch.cuda.empty_cache()
    out = {
        "lm": lm, "gnn": gnns, "gnn_graph": "rmat(512, 4096, seed 0), GraphBatcher.full_batch (launch.train)",
        "graphcast_refused": refused, "segment_spmm_launches": gnn_launches,
        "timing": "step_ms_median_last10: host clock between the synchronised ends of consecutive loop steps "
                  "(batch fetch, step and the loop's bookkeeping), median of the last 10; profile_one_step: "
                  "torch.profiler over step 5 alone (device time by kernel, busy share = that over the step's "
                  "wall); optimizer_ms_measured_alone: one AdamW update (clip included) of every leaf after "
                  "training, the params standing in for the gradients, CUDA events, median of 3",
        "card": smi,
    }
    say("train", **out)
    return out, {**launches, "segment_spmm": gnn_launches}


# --------------------------------------------------------------------------- embedding bag


def library_bag(tables: torch.Tensor, ids: torch.Tensor, weights: torch.Tensor | None):
    """The same function as one `F.embedding_bag` call (the yardstick; used
    nowhere in the port): tables viewed as (T·V, D), ids offset by t·V and
    clamped, `mode="sum"`, per-sample weights w·valid.  The inputs are
    prepared once; the returned callable is the call alone."""
    import torch.nn.functional as F

    t, v, d = tables.shape
    b, _, l = ids.shape
    valid = (ids >= 0) & (ids < v)
    flat = (ids.long().clamp(0, v - 1) + torch.arange(t, device=ids.device)[None, :, None] * v).reshape(b * t, l)
    psw = (valid.float() if weights is None else weights * valid).reshape(b * t, l)
    table2d = tables.view(t * v, d)
    return lambda: F.embedding_bag(flat, table2d, mode="sum", per_sample_weights=psw).view(b, t, d)


def phase_bag(device: torch.device, seed: int, timer: Timer) -> dict:
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.pipeline import RecsysPipeline
    from repro_torch.kernels.embedding_bag.ops import embedding_bag
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref

    rng = np.random.default_rng(2)

    def inputs(t, v, d, b, l):
        tables = torch.from_numpy(rng.standard_normal((t, v, d)).astype(np.float32)).to(device)
        ids = torch.from_numpy(rng.integers(-2, v, (b, t, l)).astype(np.int32)).to(device)  # with padding ids
        w = torch.from_numpy(rng.standard_normal((b, t, l)).astype(np.float32)).to(device)
        return tables, ids, w

    def held(tables, ids, w, tol, what):
        got, again, want = embedding_bag(tables, ids, w), embedding_bag(tables, ids, w), embedding_bag_ref(tables, ids, w)
        torch.cuda.synchronize()
        check(got.dtype == tables.dtype and got.shape == (ids.shape[0], tables.shape[0], tables.shape[2]),
              f"shape/dtype at {what}")
        check(torch.equal(got, again), f"two runs differ at {what}")
        err = float((got.float() - want.float()).abs().max())
        check(torch.allclose(got.float(), want.float(), **tol), f"kernel vs plain version at {what}: max abs err {err}")
        return got, err

    max_err = {"f32": 0.0, "bf16": 0.0}
    cases = 0
    grad_err = 0.0
    for shape in BAG_TEST_SHAPES:
        tables32, ids, w = inputs(*shape)
        for dtype, tag, tol in ((torch.float32, "f32", F32_TOL), (torch.bfloat16, "bf16", BF16_TOL)):
            for ww in (w, None):
                _, err = held(tables32.to(dtype), ids, ww, tol, (*shape, tag, ww is not None))
                max_err[tag] = max(max_err[tag], err)
                cases += 1
        # gradients of tables and weights through the kernel's autograd.Function
        # against autograd through the plain version
        g = torch.from_numpy(rng.standard_normal((shape[3], shape[0], shape[2])).astype(np.float32)).to(device)
        t1, w1 = tables32.clone().requires_grad_(), w.clone().requires_grad_()
        before = embedding_bag.launches
        (embedding_bag(t1, ids, w1) * g).sum().backward()
        check(embedding_bag.launches == before + 1, "the gradient's forward must be the kernel")
        t2, w2 = tables32.clone().requires_grad_(), w.clone().requires_grad_()
        (embedding_bag_ref(t2, ids, w2) * g).sum().backward()
        for a, b_, name in ((t1.grad, t2.grad, "tables"), (w1.grad, w2.grad, "weights")):
            e = float((a - b_).abs().max())
            check(torch.allclose(a, b_, **F32_TOL), f"d {name} at {shape}: max abs err {e}")
            grad_err = max(grad_err, e)

    # the path's lookup: dcn-v2's tables, Zipf ids from its pipeline
    cfg = get_arch(RECSYS_ARCH).model_config()
    gen = torch.Generator(device=device).manual_seed(seed)
    tables = torch.randn((cfg.n_sparse, cfg.rows_per_table, cfg.embed_dim), generator=gen,
                         device=device).mul_(0.01)  # init_params' scale
    t0 = time.perf_counter()
    single = next(iter(RecsysPipeline(cfg.n_dense, cfg.n_sparse, cfg.rows_per_table, BAG_PATH_BATCH, seed=seed)))
    batch_host_s = time.perf_counter() - t0
    multi = next(iter(RecsysPipeline(cfg.n_dense, cfg.n_sparse, cfg.rows_per_table, BAG_MULTI_BATCH,
                                     multi_hot=BAG_MULTI_HOT, seed=seed)))
    lookups = {
        "single_hot": (torch.from_numpy(single["sparse_ids"]).to(device)[..., None], None),
        "multi_hot_weighted": (torch.from_numpy(multi["sparse_ids"]).to(device),
                               torch.from_numpy(rng.random(multi["sparse_ids"].shape, dtype=np.float32)).to(device)),
    }
    path = {}
    for name, (ids, w) in lookups.items():
        got, err = held(tables, ids, w, F32_TOL, name)
        lib_fn = library_bag(tables, ids, w)
        lib = lib_fn()
        torch.cuda.synchronize()
        lib_err = float((lib - got).abs().max())
        check(torch.allclose(lib, got, **F32_TOL), f"kernel vs F.embedding_bag at {name}: {lib_err}")
        bound, by, distinct = bag_bound_ms(tables, ids, w)
        path[name] = {
            "B": int(ids.shape[0]), "T": int(ids.shape[1]), "L": int(ids.shape[2]), "V": cfg.rows_per_table,
            "D": cfg.embed_dim, "weighted": w is not None, "distinct_rows": distinct,
            "gathered_rows": int(ids.numel()), "max_abs_err": err, "library_max_abs_err": lib_err,
            "ms": timer.device_ms(lambda: embedding_bag(tables, ids, w)),
            "call_ms": timer.call_ms(lambda: embedding_bag(tables, ids, w)),
            "plain_ms": timer.call_ms(lambda: embedding_bag_ref(tables, ids, w), calls=5, reps=5),
            "library_ms": timer.call_ms(lib_fn),
            "bound_ms": bound, "bound_by": by,
        }
    out = {
        "test_cases": cases, "max_abs_err_f32": max_err["f32"], "max_abs_err_bf16": max_err["bf16"],
        "grad_max_abs_err": grad_err, "tolerance_f32": F32_TOL, "tolerance_bf16": BF16_TOL,
        "bit_equal_two_runs": True, "path": path,
        "path_max_abs_err": max(p["max_abs_err"] for p in path.values()),
        "zipf_batch_host_ms": batch_host_s * 1e3,
        "timing": "warm medians with CUDA events. ms: device time, replayed from a CUDA graph; call_ms, "
                  "plain_ms, library_ms: calls enqueued back to back from Python. library: F.embedding_bag "
                  "(mode='sum', per_sample_weights=w·valid) on tables.view(T·V, D) with ids offset by t·V "
                  "and clamped, prepared once. zipf_batch_host_ms: RecsysPipeline's first batch of 65,536",
    }
    say("embedding_bag", **out)
    return out


# --------------------------------------------------------------------------- recsys


def phase_recsys(device: torch.device, seed: int, smi: str | None, timer: Timer) -> tuple[dict, int]:
    from repro_torch.configs.base import RECSYS_SHAPES
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.pipeline import RecsysPipeline, to_device
    from repro_torch.kernels.embedding_bag.ops import embedding_bag
    from repro_torch.launch.train import train
    from repro_torch.models import recsys as rec
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.optim import adamw, cosine_schedule

    cfg = get_arch(RECSYS_ARCH).model_config()
    plain = dataclasses.replace(cfg, bag_impl="ref")
    check(cfg.num_params == RECSYS_PARAMS, f"dcn-v2 has {cfg.num_params} params, want {RECSYS_PARAMS}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = rec.init_params(cfg, seed, device=device)  # a seeded torch.Generator on the card
    # `num_params` is the reference's formula, which counts 2·d0 a cross layer
    # for what is one d0 bias: the tensors hold n_cross·d0 fewer
    held_params = sum(t.numel() for t in [params["tables"]] + [
        t for lp in params["cross"] + params["mlp"] + [params["out"]] for t in lp.values()])
    check(held_params == RECSYS_PARAMS - cfg.n_cross_layers * cfg.d_input, f"params made: {held_params}")

    def first_batch(batch_size):
        return next(iter(RecsysPipeline(cfg.n_dense, cfg.n_sparse, cfg.rows_per_table, batch_size, seed=seed)))

    cells = ("serve_p99", "serve_bulk")
    batches = {c: to_device(first_batch(RECSYS_SHAPES[c]["batch"]), device) for c in cells}
    query = to_device(first_batch(RECSYS_SHAPES["retrieval_cand"]["batch"]), device)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    n_cand = RECSYS_SHAPES["retrieval_cand"]["n_candidates"]
    cands = torch.randn((n_cand, cfg.mlp_dims[-1]), generator=gen, device=device)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    # ---- the main path: serve, retrieve, train (the kernel's route)
    losses, walls = [], []
    first = torch.full((cfg.n_sparse * cfg.rows_per_table,), -1, dtype=torch.int16, device=device)
    offsets = torch.arange(cfg.n_sparse, device=device) * cfg.rows_per_table

    def on_step(state, metrics, batch):
        losses.append(metrics["loss"])
        rows = (batch["sparse_ids"].long() + offsets).reshape(-1)
        first[rows] = torch.where(first[rows] < 0, metrics["step"], first[rows]).to(torch.int16)
        torch.cuda.synchronize()
        walls.append(time.perf_counter())

    train_log = []
    embedding_bag.launches = 0
    torch.cuda.synchronize()
    with torch.inference_mode():
        logits = {c: rec.forward(params, batches[c], cfg) for c in cells}
        vals, idx = rec.retrieval_scores(params, query, cands, cfg, top_k=100)
    serve_launches = embedding_bag.launches
    t_train = time.perf_counter()
    state = train(RECSYS_ARCH, steps=TRAIN_STEPS, batch=RECSYS_SHAPES["train_batch"]["batch"], lr=TRAIN_LR,
                  device=device, seed=seed, on_step=on_step, log_fn=train_log.append)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t_train
    launches = embedding_bag.launches
    check(serve_launches == len(cells) + 1, f"embedding_bag launched {serve_launches} times in serving, want 3")
    check(launches == serve_launches + TRAIN_STEPS, f"embedding_bag launched {launches} times, want "
          f"{len(cells) + 1} + {TRAIN_STEPS}")
    check(state.step == TRAIN_STEPS and len(losses) == TRAIN_STEPS, f"trained {state.step} steps")
    losses = [float(x) for x in losses]
    check(all(np.isfinite(losses)), f"non-finite loss: {losses}")

    # ---- serving against the plain route
    serve = {}
    with torch.inference_mode():
        for c in cells:
            want = rec.forward(params, batches[c], plain)
            torch.cuda.synchronize()
            e = float((logits[c] - want).abs().max())
            check(logits[c].shape == (RECSYS_SHAPES[c]["batch"],) and bool(torch.isfinite(logits[c]).all()),
                  f"{c}: logits")
            check(torch.allclose(logits[c], want, **MODEL_TOL), f"{c}: kernel vs plain route, max abs err {e}")
            ms = timer.call_ms(lambda: rec.forward(params, batches[c], cfg), calls=5, reps=5)
            serve[c] = {"batch": RECSYS_SHAPES[c]["batch"], "max_abs_err_vs_plain": e, "ms": ms,
                        "rows_per_s": RECSYS_SHAPES[c]["batch"] / (ms / 1e3),
                        "plain_ms": timer.call_ms(lambda: rec.forward(params, batches[c], plain), calls=5, reps=5)}
        scores = rec.user_tower(params, query, cfg) @ cands.T
        top = scores.float().sort(dim=-1, descending=True).values[:, :100]
        torch.cuda.synchronize()
        check(vals.shape == (1, 100) and torch.equal(vals, top), "retrieval top-100 vs the sorted full scores")
        check(float(vals[0, 0]) == float(scores.max()), "retrieval: the best score is the maximum")
        check(torch.equal(scores[0, idx[0]].float(), vals[0]), "retrieval: indices point at their values")
        retrieval = {"candidates": n_cand, "width": cfg.mlp_dims[-1], "top_k": 100,
                     "candidates_gb": cands.numel() * 4 / 1e9, "top_equals_sorted_full_scores": True,
                     "ms": timer.call_ms(lambda: rec.retrieval_scores(params, query, cands, cfg), calls=5, reps=5)}
    del cands, scores

    # ---- training: gradient reached the tables through the kernel's Function
    decay = 1.0
    lr_fn = cosine_schedule(TRAIN_LR, 10, TRAIN_STEPS)
    for k in range(TRAIN_STEPS):
        decay *= 1.0 - lr_fn(k) * 0.1  # adamw's weight decay, the only force on a row never looked up

    def changed_rows(tables):
        p0 = params["tables"].reshape(-1, cfg.embed_dim)
        p1 = tables.detach().reshape(-1, cfg.embed_dim)
        return ~((p1 - p0 * decay).abs() <= DECAY_RTOL * p0.abs() + 1e-12).all(dim=1)

    changed = changed_rows(state.params["tables"])
    touched = first >= 0
    n_touched, n_changed = int(touched.sum()), int(changed[touched].sum())
    unchanged_by_first_step = [int((~changed & (first == k)).sum()) for k in range(TRAIN_STEPS)]
    check(not bool(changed[~touched].any()), "a table row never looked up changed by more than weight decay")
    check(sum(unchanged_by_first_step[:TRAIN_STEPS // 2]) == 0,
          f"rows first looked up in the first half did not change: {unchanged_by_first_step}")
    check(n_changed >= ROWS_CHANGED_MIN_SHARE * n_touched, f"only {n_changed} of {n_touched} looked-up rows changed")

    # host share: a step on a resident batch (device time) against the loop's wall time a step
    step_walls = np.diff(walls)
    init, step = make_train_step(lambda p, b: rec.loss_fn(p, b, cfg), adamw(lr_fn))
    st = init(state.params)
    resident = to_device(first_batch(RECSYS_SHAPES["train_batch"]["batch"]), device)
    for _ in range(2):
        st, _ = step(st, resident)
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(5):
        st, _ = step(st, resident)
    b.record()
    torch.cuda.synchronize()
    step_device_ms = a.elapsed_time(b) / 5
    t0 = time.perf_counter()
    host = iter(RecsysPipeline(cfg.n_dense, cfg.n_sparse, cfg.rows_per_table, RECSYS_SHAPES["train_batch"]["batch"],
                               seed=seed + 1))
    for _ in range(3):
        next(host)
    batch_host_ms = (time.perf_counter() - t0) / 3 * 1e3
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del st, state

    # ---- the same 20 steps through the plain route
    ref_losses = []
    torch.cuda.empty_cache()
    before = embedding_bag.launches
    ref_state = train(RECSYS_ARCH, steps=TRAIN_STEPS, batch=RECSYS_SHAPES["train_batch"]["batch"], lr=TRAIN_LR,
                      device=device, seed=seed, bag_impl="ref",
                      on_step=lambda s, m, bt: ref_losses.append(m["loss"]), log_fn=lambda _: None)
    ref_losses = [float(x) for x in ref_losses]
    check(embedding_bag.launches == before, "the plain route launched the kernel")
    loss_diff = float(np.max(np.abs(np.array(losses) - np.array(ref_losses))))
    check(loss_diff <= TRAIN_LOSS_TOL, f"losses, kernel vs plain route: max abs diff {loss_diff}")
    disagree = int((changed_rows(ref_state.params["tables"]) != changed)[touched].sum())
    check(disagree <= ROUTES_ROW_DISAGREEMENT_MAX * n_touched,
          f"the routes change different looked-up rows: {disagree} of {n_touched}")
    del ref_state

    wall_ms = float(np.median(step_walls[1:])) * 1e3
    out = {
        "arch": RECSYS_ARCH, "params": cfg.num_params, "params_held": held_params,
        "params_gb": held_params * 4 / 1e9,
        "tables": [cfg.n_sparse, cfg.rows_per_table, cfg.embed_dim], "d_input": cfg.d_input,
        "mlp": list(cfg.mlp_dims), "cross_layers": cfg.n_cross_layers, "cuts": [],
        "setup_s": setup_s, "serve": serve, "retrieval": retrieval,
        "train": {
            "batch": RECSYS_SHAPES["train_batch"]["batch"], "steps": TRAIN_STEPS, "lr": TRAIN_LR,
            "losses": losses, "plain_route_losses": ref_losses, "loss_max_abs_diff": loss_diff,
            "loss_tolerance": TRAIN_LOSS_TOL, "rows_looked_up": n_touched,
            "rows_looked_up_changed": n_changed, "rows_never_looked_up_only_decayed": True,
            "rows_unchanged_by_first_step": unchanged_by_first_step,
            "rows_change_status_differs_from_plain_route": disagree, "decay_factor": decay, "wall_s": train_s, "step_wall_ms_median": wall_ms,
            "step_device_ms": step_device_ms, "zipf_batch_host_ms": batch_host_ms,
            "host_share": max(0.0, 1.0 - step_device_ms / wall_ms), "log": train_log,
        },
        "embedding_bag_launches": launches, "serve_launches": serve_launches,
        "max_memory_allocated_gb": peak_gb,
        "timing": "serve/retrieval ms: calls enqueued back to back, CUDA events (plain_ms: the plain "
                  "embedding-bag route); step_wall_ms_median: host clock between the ends of consecutive "
                  "loop steps, each synchronised; step_device_ms: 5 steps on one resident batch between two "
                  "CUDA events; host_share = 1 - step_device_ms / step_wall_ms_median",
        "card": smi,
    }
    say("recsys", **out)
    return out, launches


# --------------------------------------------------------------------------- sweep CLI


def _pagerank_iterations(records: list[dict]) -> int:
    """One `segment_spmm` launch a PageRank iteration, one trace a workload."""
    return sum({r["workload"]: r["num_iterations"] for r in records if r["algorithm"] == "pagerank"}.values())


def phase_cli(smi: str | None) -> tuple[dict, int]:
    """The sweep CLI as its users run it (`python -m repro_torch.experiments.run`),
    in process so the launch counts can be read: `--grid backpressure` and
    `--grid faults` at CLI_SCALE (amazon and soc-pokec), the faults grid again
    with `--resume`, then `--grid paper` at its own scale rendering the port's
    EXPERIMENTS.md with both folded in; `--check` on those outputs, and the
    paper records against the reference package's committed numpy run of the
    same grid, scale and seed (`BENCH_sweep.json`).  Each grid has a cache of
    its own, so each traces."""
    import os
    import tempfile

    from repro_torch.experiments import report
    from repro_torch.experiments.grid import GRIDS
    from repro_torch.experiments.run import main as run_main
    from repro_torch.kernels.segment_spmm.ops import ell_spmm, segment_spmm

    def drive(*argv: str) -> tuple[float, int]:
        segment_spmm.launches = ell_spmm.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = run_main([*argv, "-q"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(rc == 0, f"run {' '.join(argv)} exited {rc}")
        check(ell_spmm.launches == 0, f"run {' '.join(argv)} launched the one-bucket kernel")
        return wall, segment_spmm.launches

    def finite(values) -> bool:
        return all(np.isfinite(v) for v in values if isinstance(v, float))

    scale = f"{CLI_SCALE:g}"
    cuts = [] if CLI_SCALE == 1.0 else [f"backpressure and faults grids at --scale {scale}"]
    out: dict = {"scale": CLI_SCALE, "cuts": cuts}
    with tempfile.TemporaryDirectory() as tmp:
        sweeps = os.path.join(tmp, "sweeps")

        def paths(grid: str) -> list[str]:
            return ["--sweeps-dir", sweeps, "--cache-dir", os.path.join(tmp, f"cache_{grid}")]

        # 1. backpressure: both routing arms, open loop and credit at every depth
        wall, launches = drive("--grid", "backpressure", "--scale", scale, *paths("backpressure"))
        with open(os.path.join(sweeps, "backpressure.json")) as f:
            bp = json.load(f)
        cont = bp["contention"]
        check(len(bp["records"]) == GRIDS["backpressure"].num_configs == 12, "backpressure: 12 configurations")
        check(len(cont["records"]) == 12 * 2 * (len(cont["buffer_depths"]) + 1), "a contention record an arm")
        check(cont["backends"] == ["numpy", "torch"] and cont["backend_parity_max_rel"] <= cont["parity_rtol"],
              f"backpressure numpy↔torch parity {cont['backend_parity_max_rel']}")
        check(cont["credit_inf_numpy_max_abs"] == 0.0 and cont["credit_inf_torch_max_rel"] <= cont["parity_rtol"],
              "credit@inf differs from the open arm")
        check(all(finite(r.values()) for r in bp["records"] + cont["records"]), "non-finite backpressure record")
        check(launches == _pagerank_iterations(bp["records"]) > 0,
              f"backpressure: {launches} segment_spmm launches, not one a PageRank iteration")
        soc = bp["workload_stats"]["soc-pokec"]
        out["backpressure"] = {
            "wall_s": wall, "timings": bp["timings"], "records": len(bp["records"]),
            "contention_records": len(cont["records"]), "parity_max_rel": cont["backend_parity_max_rel"],
            "credit_inf_torch_max_rel": cont["credit_inf_torch_max_rel"],
            "min_speedup": min(c["speedup"] for c in bp["comparisons"]),
            "segment_spmm_launches": launches, "ell_spmm_launches": 0,
        }
        out["soc_pokec"] = {"scale": CLI_SCALE, "nodes": soc["num_nodes"], "edges": soc["num_edges"],
                            "max_degree": soc["max_degree"]}

        # 2. faults: every unit, then the same command resumed from its journal
        fargs = ("--grid", "faults", "--scale", scale, "--journal", os.path.join(tmp, "faults.journal.json"),
                 *paths("faults"))
        wall, launches = drive(*fargs)
        with open(os.path.join(sweeps, "faults.json"), "rb") as f:
            first = f.read()
        resume_wall, resume_launches = drive(*fargs, "--resume")
        with open(os.path.join(sweeps, "faults.json"), "rb") as f:
            resumed = f.read()
        fl = json.loads(first)
        check(fl["backend"] == "numpy+torch", f"faults backend {fl['backend']}")
        fl = fl["faults"]
        n_units = len(GRIDS["faults"].workloads) * len(GRIDS["faults"].topologies) * len(GRIDS["faults"].fault_rates)
        check(len(fl["records"]) == n_units == 20 and fl["quarantined"] == {},
              f"{len(fl['records'])} of 20 units, quarantined: {sorted(fl['quarantined'])}")
        check(fl["backend_parity_max_rel"] <= fl["parity_rtol"], f"faults parity {fl['backend_parity_max_rel']}")
        check(all(r["backend_parity_rel"] == 0.0 for r in fl["records"] if r["fault_rate"] == 0.0),
              "the open arm at rate 0 is not bit-equal")
        check(all(finite(r[s].values()) for r in fl["records"] for s in ("proposed", "baseline")),
              "non-finite faults record")
        check(all(row["batch_parity"] for row in fl["repair"]), "repair_batch differs from the serial repair")
        check(launches > 0, "the faults grid launched segment_spmm no time")
        check(resumed == first, "the resumed faults artifact differs")
        check(resume_launches == 0, "the resumed faults run traced again")
        out["faults"] = {
            "wall_s": wall, "units": len(fl["records"]), "quarantined": len(fl["quarantined"]),
            "parity_max_rel": fl["backend_parity_max_rel"], "repair_rows": len(fl["repair"]),
            "min_win_at_10pct": min(r["win"] for r in fl["records"] if r["fault_rate"] == 0.10),
            "segment_spmm_launches": launches, "ell_spmm_launches": 0,
            "resume_wall_s": resume_wall, "resume_byte_identical": True,
        }

        # 3. paper at its own scale: the port's report, §Backpressure and §Resilience folded in
        md, js = os.path.join(tmp, "EXPERIMENTS.md"), os.path.join(tmp, "BENCH_sweep.json")
        wall, launches = drive("--grid", "paper", "--md", md, "--json", js, *paths("paper"))
        with open(md) as f:
            text = f.read()
        with open(js) as f:
            paper = json.load(f)
        check(all(f"## §{s}" in text for s in ("Calibration", "Perf", "Backpressure", "Resilience")),
              "the paper report lacks a section")
        check(launches == _pagerank_iterations(paper["records"]) > 0,
              f"paper: {launches} segment_spmm launches, not one a PageRank iteration")

        # 4. the freshness audit on those outputs
        issues = report.experiments_md_issues(md, js, sweeps)
        check(issues == [] and report.main(["--check", "--md", md, "--json", js, "--sweeps-dir", sweeps]) == 0,
              f"--check: {issues}")

    # 5. the paper records against the reference's committed numpy run
    with open(COMMITTED_BENCH) as f:
        bench = json.load(f)
    keys_equal = [r["key"] for r in paper["records"]] == [r["key"] for r in bench["records"]]
    differing = [(a["key"], k) for a, b in zip(paper["records"], bench["records"])
                 for k in sorted(set(a) | set(b)) if k != "elapsed_us" and a.get(k) != b.get(k)]
    equal = keys_equal and paper["grid"] == bench["grid"] and not differing
    out["paper"] = {
        "wall_s": wall, "timings": paper["timings"], "records": len(paper["records"]),
        "scale": paper["grid"]["scale"], "placement_stats": paper["placement_stats"],
        "segment_spmm_launches": launches, "ell_spmm_launches": 0,
    }
    out.update(check_issues=issues, paper_records_equal_committed=equal, paper_fields_differing=differing[:20],
               card=smi,
               timing="wall_s: host clock around run_main, closed by a device synchronise; timings: the "
                      "payload's own stage split (obs spans); each grid with a cold cache of its own")
    say("cli", **out)
    check(equal, f"paper records differ from the committed BENCH_sweep.json: {differing[:20]}")
    total = sum(out[g]["segment_spmm_launches"] for g in ("backpressure", "faults", "paper"))
    return out, total


# --------------------------------------------------------------------------- MoE serving

# olmoe-1b-7b at its published width and depth through the serve path, with the serve phase's traffic; then
# qwen2-moe-a2.7b at its published width over 4 of its 24 layers (at full depth its float32 master and bf16
# copy, 57.3 + 28.6 GB, do not fit on the card), one prompt of 2048 tokens and 8 decode steps
MOE_ARCH = "olmoe-1b-7b"
MOE_WIDE_ARCH, MOE_WIDE_LAYERS = "qwen2-moe-a2.7b", 4
MOE_WIDE_PROMPT, MOE_WIDE_STEPS = 2048, 8
# moe_block against moe_loop_ref on one layer at full width in float32: the same slots kept, outputs through
# float32 products of width 2048 (and 1024 back) in other shapes (one (E, C, D) bmm against an expert's rows
# at a time), each free to take another cuBLAS algorithm; tests/test_torch_moe.py's 1e-5 (at widths <= 128)
# is reported beside
MOE_LOOP_TOL = dict(rtol=1e-4, atol=1e-4)
MOE_TEST_TOL = dict(rtol=1e-5, atol=1e-5)


@contextlib.contextmanager
def moe_inputs_seen(layers=None):
    """Yields a list that gets the (weights, input) of each MoE block called
    in the block (None for the calls not in `layers`, where given): the
    transformer's reference to `models.moe` is swapped meanwhile, so the
    block itself runs as it is."""
    import types

    from repro_torch.models import moe as moe_lib
    from repro_torch.models import transformer as tfm

    seen = []

    def grab(m, lp, x, *, mesh=None):
        seen.append((lp, x.clone()) if layers is None or len(seen) in layers else None)
        return moe_lib.moe_block(m, lp, x, mesh=mesh)

    tfm.moe_lib = types.SimpleNamespace(**{**vars(moe_lib), "moe_block": grab})
    try:
        yield seen
    finally:
        tfm.moe_lib = moe_lib


def moe_layer_inputs(run, layers=None) -> list:
    """(weights, input) of each MoE block called during `run()` (`moe_inputs_seen`)."""
    with moe_inputs_seen(layers) as seen:
        run()
        torch.cuda.synchronize()
    return seen


def moe_layer_input(run, layer: int) -> tuple[dict, torch.Tensor]:
    """(weights, input) of the MoE block of layer `layer` during `run()`."""
    return moe_layer_inputs(run, (layer,))[layer]


def moe_loop_check(m, lp: dict, x: torch.Tensor) -> dict:
    """`moe_block` against `moe_loop_ref` on one layer's weights and input:
    the kept slots equal, the outputs within MOE_LOOP_TOL, two runs bit-equal."""
    from repro_torch.models import moe as moe_lib

    got, again = moe_lib.moe_block(m, lp, x), moe_lib.moe_block(m, lp, x)
    want, kept = moe_lib.moe_loop_ref(m, lp, x)
    _, top_i, _ = moe_lib._router(m, lp, x.reshape(-1, x.shape[-1]))
    plan = moe_lib._plan(m, top_i)
    kept_sort = torch.zeros_like(kept.view(-1)).index_copy_(0, plan.order, plan.keep).view(kept.shape)
    torch.cuda.synchronize()
    out = {"dtype": str(x.dtype).split(".")[-1], "tokens": x.shape[0] * x.shape[1], "C": plan.C,
           "kept_slots_equal": bool(torch.equal(kept, kept_sort)), "slots_dropped": int((~kept).sum()),
           "max_abs_err": float((got - want).abs().max()), "out_max_abs": float(want.abs().max()),
           "within_tolerance": bool(torch.allclose(got, want, **MOE_LOOP_TOL)), "tolerance": MOE_LOOP_TOL,
           "within_test_tolerance": bool(torch.allclose(got, want, **MOE_TEST_TOL)),
           "bit_equal_two_runs": bool(torch.equal(got, again))}
    check(out["kept_slots_equal"], f"moe_block and moe_loop_ref keep other slots: {out}")
    check(out["within_tolerance"], f"moe_block vs moe_loop_ref: {out}")
    check(out["bit_equal_two_runs"], "two runs of moe_block differ")
    return out


def moe_routes(calls: list, m, n_layers: int) -> dict:
    """From `drain_timed`'s route logs (a list of routings a call, one a
    layer): each call's C, tokens and share of routed slots dropped, the
    experts that got a slot (summed over layers, mean over calls), and the
    expert load skew (max/mean of the slots an expert got) of each layer over
    all calls."""
    per_call, total = [], torch.zeros((n_layers, m.num_experts), dtype=torch.long)
    hit = 0.0
    for routings in calls:
        check(len(routings) == n_layers, f"{len(routings)} routings in a call of {n_layers} layers")
        C = routings[0][0]
        counts = torch.stack([c for _, c in routings]).cpu()  # (L, E)
        slots = int(counts[0].sum())
        per_call.append({"C": C, "tokens": slots // m.top_k,
                         "dropped_share": int((counts - C).clamp_min(0).sum()) / (slots * n_layers)})
        hit += int((counts > 0).sum()) / len(calls)
        total += counts
    skew = total.max(1).values.float() / (total.sum(1).float() / m.num_experts)
    return {"calls": per_call, "experts_hit_a_call": hit, "skew_by_layer": [round(float(s), 4) for s in skew],
            "skew_max": float(skew.max())}


def moe_split(m, lp: dict, x: torch.Tensor, timer: Timer, n_layers: int, *, attention=None,
              total_ms: float | None = None, backward: bool = False) -> dict:
    """Device ms of one call by part, each part replayed alone from a CUDA
    graph on one layer's weights and input and counted once a layer: router
    and top-k, dispatch (plan, sort, scatter), expert products, combine, the
    shared expert where there is one, attention (`attention()`, where
    given); with `total_ms` (the whole call's device time, from
    `torch.profiler`), the rest is that less those.  With `backward` (a
    training step, on the float32 master cast as training casts it), each
    MoE part is the forward twice (forward and recompute) and its backward
    once, each part's forward and backward a layer kept beside, and the
    GEMMs inside the router and the expert products (the float32 router
    product, the experts' `bmm`s, forward twice and backward) are timed too."""
    from repro_torch.models import moe as moe_lib

    check(not (backward and m.d_ff_shared), "the training split has no shared-expert backward")
    flat = x.reshape(-1, x.shape[-1]).detach()
    w = {k: v.detach().clone().requires_grad_(True) for k, v in lp.items()} if backward else lp
    with torch.no_grad():
        top_p, top_i, _ = moe_lib._router(m, w, flat)
        plan = moe_lib._plan(m, top_i)
        buf = moe_lib._dispatch(m, plan, flat)
        y = moe_lib._expert_ffn(w["we_gate"], w["we_up"], w["we_down"], buf)
    parts = {
        "router_topk_ms": lambda: moe_lib._router(m, w, flat),
        "dispatch_ms": lambda: moe_lib._dispatch(m, moe_lib._plan(m, top_i), flat),
        "experts_ms": lambda: moe_lib._expert_ffn(w["we_gate"], w["we_up"], w["we_down"], buf),
        "combine_ms": lambda: moe_lib._combine(m, plan, y, top_p),
    }
    if m.d_ff_shared:
        parts["shared_expert_ms"] = lambda: moe_lib._shared_expert(w, x)
    with torch.no_grad():
        a_layer = {k: timer.device_ms(fn, calls=5, reps=10) for k, fn in parts.items()}
    if attention is not None:
        a_layer["attention_ms"] = timer.device_ms(attention, calls=5, reps=10)
    out = {}
    if backward:
        xg = flat.clone().requires_grad_(True)
        bufg, yg, top_pg = (t.clone().requires_grad_(True) for t in (buf, y, top_p))
        gen = torch.Generator(device=x.device).manual_seed(5)

        def randn(shape, dtype):
            return torch.randn(shape, generator=gen, device=x.device).to(dtype)

        def with_backward(fwd, inputs, like):
            cot = randn(like.shape, like.dtype)
            return lambda: torch.autograd.grad(fwd(), inputs, cot)

        experts = (w["we_gate"], w["we_up"], w["we_down"])
        with_bwd = {
            "router_topk_ms": with_backward(lambda: moe_lib._router(m, w, xg)[0], (xg, w["router"]), top_p),
            "dispatch_ms": with_backward(lambda: moe_lib._dispatch(m, moe_lib._plan(m, top_i), xg), (xg,), buf),
            "experts_ms": with_backward(lambda: moe_lib._expert_ffn(*experts, bufg), (bufg, *experts), y),
            "combine_ms": with_backward(lambda: moe_lib._combine(m, plan, yg, top_pg), (yg, top_pg), flat),
        }
        for key, fn in with_bwd.items():
            f, fb = a_layer[key], timer.device_ms(fn, calls=5, reps=10)
            out[key[:-3] + "_forward_ms_a_layer"] = f
            out[key[:-3] + "_backward_ms_a_layer"] = fb - f
            a_layer[key] = f + fb
        # the GEMMs alone: the router's float32 product, the experts' three bmm's
        x32, r = flat.float(), w["router"].detach()
        dlogits = randn((x32.shape[0], m.num_experts), torch.float32)
        wg, wu, wd = (t.detach().to(buf.dtype) for t in experts)
        h = randn((m.num_experts, plan.C, m.d_ff_expert), buf.dtype)
        dh, dy = randn(h.shape, buf.dtype), randn(y.shape, buf.dtype)
        gemms = [(lambda: x32 @ r, lambda: (dlogits @ r.T, x32.T @ dlogits)),
                 (lambda: (torch.bmm(buf, wg), torch.bmm(buf, wu), torch.bmm(h, wd)),
                  lambda: (torch.bmm(dy, wd.transpose(1, 2)), torch.bmm(h.transpose(1, 2), dy),
                           torch.bmm(dh, wg.transpose(1, 2)), torch.bmm(buf.transpose(1, 2), dh),
                           torch.bmm(dh, wu.transpose(1, 2)), torch.bmm(buf.transpose(1, 2), dh)))]
        with torch.no_grad():
            a_layer["gemm_inside_router_and_experts_ms"] = sum(
                2 * timer.device_ms(f, calls=5, reps=10) + timer.device_ms(b, calls=5, reps=10) for f, b in gemms)
    out |= {k: v * n_layers for k, v in a_layer.items()}
    if total_ms is not None:
        out["total_ms"] = total_ms
        out["rest_ms"] = total_ms - sum(out[k] for k in a_layer) if total_ms > 0 else "not measured"
    return out


def moe_serve(cfg, device: torch.device, seed: int, prompts: list, new_tokens: int, timer: Timer) -> dict:
    """One MoE model through `build_engine` (4 slots, max_seq 4096, float32
    cache): the drain and its checks, the logit checks, `moe_block` against
    `moe_loop_ref` on the middle layer in float32, two bf16 prefills
    bit-equal, routing statistics, the device split of a prefill and of a
    decode step, the decode step's byte bound."""
    from repro_torch.launch.serve import build_engine
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import gqa_attention

    m, L = cfg.moe, cfg.n_layers
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params32 = tfm.init_params(cfg, seed, device=device)  # a seeded torch.Generator on the card
    params = tfm.cast_params(params32, cfg)  # bf16 weights, the router kept in float32
    engine = build_engine(cfg, params, slots=SERVE_SLOTS, max_seq=SERVE_MAX_SEQ, device=device)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    check(params["layers"]["router"].dtype == torch.float32 and params["layers"]["we_gate"].dtype == torch.bfloat16,
          "the served weights: bf16 experts, float32 router")

    prefill_one, decode = engine.prefill_one, engine.decode
    engine.cache, _ = prefill_one(engine.cache, 0, torch.from_numpy(prompts[0][None, :256].astype(np.int64)))
    _, engine.cache = decode(engine.cache, torch.zeros((SERVE_SLOTS, 1), dtype=torch.long),
                             torch.zeros(SERVE_SLOTS, dtype=torch.long))
    torch.cuda.synchronize()

    logs = {"prefill": [], "decode": []}
    done, st, wall_s, launches = drain_timed(engine, prompts, new_tokens, logs)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(len(done) == len(prompts), f"{len(done)} of {len(prompts)} requests drained")
    for r in done:
        check(len(r.out_tokens) == new_tokens or r.out_tokens[-1] == engine.eos_id,
              f"request {r.uid}: {len(r.out_tokens)} tokens")
    check(launches == L * len(prompts), f"flash_attention launched {launches} times, want {L} a prefill × "
          f"{len(prompts)}")
    check(st["finite"], "non-finite logits")
    prefill_routes, decode_routes = moe_routes(logs["prefill"], m, L), moe_routes(logs["decode"], m, L)
    check(all(c["dropped_share"] == 0 for c in decode_routes["calls"]), "a decode step dropped a slot")

    toks = torch.from_numpy(prompts[0][None, :].astype(np.int64)).to(device)
    n, layer = toks.shape[1], L // 2
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)

    def one_prefill(c, prm):
        cache = tfm.init_kv_cache(c, 1, n, dtype=torch.float32, device=device)
        return tfm.prefill(prm, toks, cache, c)[0], cache

    loop_f32 = moe_loop_check(m, *moe_layer_input(lambda: one_prefill(cfg32, params32), layer))
    checks = logit_checks(cfg, params32, params, toks, device)
    checks["first_token_engine"] = done[[r.uid for r in done].index(0)].out_tokens[0]
    del params32
    gc.collect()
    torch.cuda.empty_cache()
    (la, ca), (lb, cb) = one_prefill(cfg, params), one_prefill(cfg, params)
    bit_equal = bool(torch.equal(la, lb) and torch.equal(ca["k"], cb["k"]) and torch.equal(ca["v"], cb["v"]))
    check(bit_equal, "two bf16 prefills of one prompt differ")
    del ca, cb

    # where the time goes: request 0's prompt in slot 0, and decode steps at the drained engine's positions
    lp, x = moe_layer_input(lambda: one_prefill(cfg, params), layer)
    prof_prefill = profile_window(lambda: prefill_one(engine.cache, 0, toks))
    q = torch.randn((1, n, cfg.n_heads, cfg.head_dim), device=device).bfloat16()
    kv = torch.randn((1, n, cfg.n_kv_heads, cfg.head_dim), device=device).bfloat16()
    split_prefill = moe_split(m, lp, x, timer, L, attention=lambda: causal_attention(q, kv, kv),
                              total_ms=prof_prefill["device_ms"])
    pos = torch.from_numpy(engine.pos.astype(np.int64)).to(device)
    step_tokens = torch.zeros((SERVE_SLOTS, 1), dtype=torch.long, device=device)
    lpd, xd = moe_layer_input(lambda: decode(engine.cache, step_tokens, pos), layer)

    def eight_steps():
        for _ in range(8):
            decode(engine.cache, step_tokens, pos)

    prof_decode = profile_window(eight_steps)
    qd = torch.randn((SERVE_SLOTS, 1, cfg.n_heads, cfg.head_dim), device=device).bfloat16()
    ck, cv = engine.cache["k"][0], engine.cache["v"][0]
    split_decode = moe_split(m, lpd, xd, timer, L,
                             attention=lambda: gqa_attention(qd, ck, cv, causal=False, kv_valid_len=pos + 1),
                             total_ms=prof_decode["device_ms"] / 8)
    decode_bytes = moe_decode_bytes(cfg, decode_routes["experts_hit_a_call"], engine.pos)
    decode_routes = {k: v for k, v in decode_routes.items() if k != "calls"} | {
        "C": sorted({c["C"] for c in decode_routes["calls"]}),
        "dropped_share_max": max(c["dropped_share"] for c in decode_routes["calls"])}
    del engine, params, lp, x, lpd, xd
    gc.collect()
    torch.cuda.empty_cache()
    return {
        "arch": cfg.name, "layers": L, "d_model": cfg.d_model, "heads": cfg.n_heads, "kv_heads": cfg.n_kv_heads,
        "head_dim": cfg.head_dim, "vocab": cfg.vocab, "experts": m.num_experts, "top_k": m.top_k,
        "d_ff_expert": m.d_ff_expert, "d_ff_shared": m.d_ff_shared, "norm_topk": m.norm_topk,
        "capacity_factor": m.capacity_factor, "impl": m.impl, "params": cfg.num_params,
        "active_params": cfg.num_active_params, "activations": "bfloat16", "slots": SERVE_SLOTS,
        "max_seq": SERVE_MAX_SEQ, "kv_cache": "float32", "requests": len(prompts),
        "prompt_lengths": [len(p) for p in prompts], "max_new_tokens": new_tokens,
        "new_tokens": [len(r.out_tokens) for r in sorted(done, key=lambda r: r.uid)],
        "setup_s": setup_s, "wall_s": wall_s, "prefill_s": st["prefill_s"], "prefill_tokens": st["prefill_tokens"],
        "prefill_tok_s": st["prefill_tokens"] / st["prefill_s"], "decode_steps": st["decode_steps"],
        "decode_ms_a_step": st["decode_s"] / st["decode_steps"] * 1e3,
        "decode_tok_s": st["decode_tokens"] / st["decode_s"], "flash_attention_launches": launches,
        "max_memory_allocated_gb": peak_gb, "logit_checks": checks, "moe_vs_loop_f32": loop_f32,
        "prefills_bit_equal": bit_equal, "routes_prefill": prefill_routes, "routes_decode": decode_routes,
        "split_prefill_ms": split_prefill, "split_decode_step_ms": split_decode, "decode_bytes": decode_bytes,
        "profile_prefill": prof_prefill, "profile_8_decode_steps": prof_decode,
    }


def causal_attention(q, k, v):
    from repro_torch.kernels.flash_attention.ops import flash_attention

    return flash_attention(q, k, v, causal=True)


def phase_moe(device: torch.device, seed: int, smi: str | None, timer: Timer) -> tuple[dict, dict]:
    """The attention kernel at olmoe's prefill shape against its plain
    version; olmoe-1b-7b, then qwen2-moe-a2.7b cut to 4 layers, through
    `moe_serve`.  Returns (the `moe` line, the attention check)."""
    import torch.nn.functional as F

    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls would change which experts the router picks")
    cfg = get_arch(MOE_ARCH).model_config()
    rng = np.random.default_rng(seed)
    lengths = rng.integers(*SERVE_PROMPT, size=SERVE_REQUESTS)  # the serve phase's traffic
    prompts = [rng.integers(2, cfg.vocab, size=int(n)).astype(np.int32) for n in lengths]

    # the attention kernel at olmoe's prefill shape (group 1: 16 query and 16 kv heads), the longest prompt
    s = int(lengths.max())
    q, k, v = (torch.from_numpy(rng.standard_normal((1, s, cfg.n_heads, cfg.head_dim)).astype(np.float32))
               .to(device).bfloat16() for _ in range(3))
    got, again = causal_attention(q, k, v), causal_attention(q, k, v)
    want = flash_attention_ref(q, k, v, causal=True)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    check(torch.equal(got, again), "two runs of the attention kernel differ at olmoe's shape")
    check(torch.allclose(got.float(), want.float(), **BF16_TOL), f"attention kernel vs plain at olmoe's shape: {err}")
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    bound_ms, bound_by = attention_bound_ms(q, k, True, 0)
    attn = {"shape": f"olmoe-1b-7b prefill attention: q/k/v (1, {s}, {cfg.n_heads}, {cfg.head_dim}) bf16, causal",
            "max_abs_err": err,
            "tolerance": BF16_TOL, "bit_equal_two_runs": True,
            "ms": timer.device_ms(lambda: causal_attention(q, k, v)),
            "plain_ms": timer.call_ms(lambda: flash_attention_ref(q, k, v, causal=True), calls=3, reps=5),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": timer.call_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True))}
    del q, k, v, qt, kt, vt, got, again, want

    olmoe = moe_serve(cfg, device, seed, prompts, SERVE_NEW, timer)
    wide = dataclasses.replace(get_arch(MOE_WIDE_ARCH).model_config(), n_layers=MOE_WIDE_LAYERS)
    wide_prompt = [rng.integers(2, wide.vocab, size=MOE_WIDE_PROMPT).astype(np.int32)]
    qwen = moe_serve(wide, device, seed, wide_prompt, MOE_WIDE_STEPS + 1, timer)
    out = {"olmoe": olmoe | {"cuts": []},
           "qwen": qwen | {"cuts": [f"{MOE_WIDE_LAYERS} of {get_arch(MOE_WIDE_ARCH).n_layers} layers: at full "
                                    "depth the float32 master (57.3 GB) and bf16 copy (28.6 GB) exceed the card"]},
           "attention_at_olmoe_shape": attn,
           "weights": "random, from a seeded torch.Generator on the card; a bf16 served copy of a float32 master",
           "timing": "host clock around each prefill / decode call, synchronised on both sides; profiles with "
                     "torch.profiler after the drain; split parts replayed alone from a CUDA graph (device time) "
                     "on the middle layer's weights and input, counted once a layer",
           "card": smi}
    say("moe", **out)
    return out, attn


# --------------------------------------------------------------------------- MoE training

# olmoe-1b-7b at its published width through launch.train.train at the reference's defaults, cut in
# depth: at 16 layers its float32 params, grads and two AdamW moments come to 111 GB, more than the
# card; 8 layers (3,562,571,776 params, 57.0 GB of that state) is about llama3.2-3b's size (3.61 G,
# a 66.24 GB peak).  Then qwen2-moe-a2.7b at its published width over 2 of its 24 layers (its shared
# expert and sigmoid gate), 5 steps
MOE_TRAIN_LAYERS = 8
MOE_EQUAL_LAYERS = 2  # gradients with the recompute and without, at this depth
MOE_WIDE_TRAIN_LAYERS, MOE_WIDE_TRAIN_STEPS = 2, 5
# moe_block's gradients against moe_loop_ref's on one layer in float32 at 1,024 tokens: each within
# this share of its largest entry (float32 sums of up to 1,024 terms in other shapes and orders;
# tests/test_torch_moe_train.py holds 1e-6 at width 32)
MOE_GRAD_REL = 1e-5
MOE_EP, MOE_EP_TORUS = 8, (2, 4)  # expert_device_permutation: one row a sequence, EP 8 on a 2 × 4 torus


def train_grads(params, batch, cfg, mesh=None) -> tuple:
    """Every leaf's gradient of `tfm.loss_fn` on one batch (what a training
    step takes from autograd); `mesh` is handed to the loss."""
    from repro_torch.models import transformer as tfm
    from repro_torch.train.pytree import tree_leaves

    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        return torch.autograd.grad(tfm.loss_fn(params, batch, cfg, mesh=mesh), leaves)
    finally:
        for p in leaves:
            p.requires_grad_(False)


def bit_equal(a: tuple, b: tuple) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def moe_grads_vs_loop(m, lp: dict, x: torch.Tensor) -> dict:
    """`moe_block`'s gradients (input, router, expert stacks; the shared
    expert's where there is one) against `moe_loop_ref`'s in float32, on one
    layer's weights and input, for one seeded cotangent."""
    from repro_torch.models import moe as moe_lib

    names = [k for k in moe_lib.layer_shapes(m, x.shape[-1]) if k in lp]
    x32 = x.float()
    dy = torch.randn(x32.shape, generator=torch.Generator(device=x.device).manual_seed(11), device=x.device)

    def grads(fn):
        w = {k: lp[k].detach().float().clone().requires_grad_(True) for k in names}
        xi = x32.clone().requires_grad_(True)
        return torch.autograd.grad((fn(m, w, xi) * dy).sum(), [xi, *w.values()])

    got = grads(moe_lib.moe_block)
    want = grads(lambda *a: moe_lib.moe_loop_ref(*a)[0])
    rel = {n: float((g - w).abs().max()) / (float(w.abs().max()) + 1e-30)
           for n, g, w in zip(["input", *names], got, want)}
    out = {"dtype": "float32", "tokens": x.shape[0] * x.shape[1], "max_rel_err": rel,
           "tolerance_rel": MOE_GRAD_REL}
    check(max(rel.values()) <= MOE_GRAD_REL, f"moe_block's gradients vs moe_loop_ref's: {rel}")
    return out


def moe_step_routes(routes: list, m, n_layers: int) -> dict:
    """C, the dropped share and each layer's load skew of every step, from
    `route_log` (one (C, counts) a layer a step)."""
    steps = [routes[i:i + n_layers] for i in range(0, len(routes), n_layers)]
    by_step = [moe_routes([s], m, n_layers) for s in steps]
    return {"C": sorted({c["C"] for r in by_step for c in r["calls"]}),
            "dropped_share_by_step": [r["calls"][0]["dropped_share"] for r in by_step],
            "first_step": {"dropped_share": by_step[0]["calls"][0]["dropped_share"],
                           "skew_by_layer": by_step[0]["skew_by_layer"]},
            "last_step": {"dropped_share": by_step[-1]["calls"][0]["dropped_share"],
                          "skew_by_layer": by_step[-1]["skew_by_layer"]}}


def moe_placement(m, layer_inputs: list, batch: int) -> dict:
    """`expert_device_permutation` fed by the card's routing: for each layer
    the experts each of the `batch` sequences routes its tokens' slots to
    (one row a sequence, as data-parallel shards would hold them), at EP
    MOE_EP on a Torus2D(MOE_EP_TORUS)."""
    from repro_torch.core.noc import Torus2D
    from repro_torch.models import moe as moe_lib

    by_layer = []
    for lp, x in layer_inputs:
        _, top_i, _ = moe_lib._router(m, lp, x.reshape(-1, x.shape[-1]))
        counts = torch.zeros((batch, m.num_experts), dtype=torch.long, device=x.device)
        counts.scatter_add_(1, top_i.reshape(batch, -1), torch.ones_like(top_i.reshape(batch, -1)))
        perm, stats = moe_lib.expert_device_permutation(counts.cpu().numpy(), MOE_EP, topology=Torus2D(*MOE_EP_TORUS))
        by_layer.append({"hop_reduction": stats["hop_reduction"], "load_balance": stats["load_balance"],
                         "hops_identity": stats["hops_identity"], "hops_optimized": stats["hops_optimized"],
                         "perm": perm.tolist()})
    return {"ep": MOE_EP, "topology": f"Torus2D{MOE_EP_TORUS}", "rows": batch, "counts": "routed slots (top-k "
            "choices, before capacity) of each sequence to each expert", "by_layer": by_layer}


def phase_moe_train(device: torch.device, seed: int, smi: str | None, timer: Timer) -> tuple[dict, dict]:
    """`launch.train.train`, the code path of `python -m repro_torch.launch.train
    --arch olmoe-1b-7b`: olmoe-1b-7b at its published width over
    MOE_TRAIN_LAYERS layers for TRAIN_STEPS steps at the reference's
    defaults (batch 8, seq 128, lr 1e-3, AdamW with clip 1.0, a recompute a
    layer, bf16 activations over a float32 master, the router in float32),
    its routing logged (`moe_block.route_log`); then its checks (losses,
    launches, route_log entries, two gradients bit-equal, recompute on and
    off bit-equal, `moe_block`'s gradients against `moe_loop_ref`'s), the
    step's device split, the routing fed to `expert_device_permutation`,
    and qwen2-moe-a2.7b over MOE_WIDE_TRAIN_LAYERS layers.  The kernels'
    counts are set to 0 just before each training run and read just after;
    returns the numbers and the counts."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels.flash_attention.kernel import bwd_kernel_launches
    from repro_torch.kernels.flash_attention.ops import flash_attention, flash_attention_bwd
    from repro_torch.launch.train import train
    from repro_torch.models import moe as moe_lib
    from repro_torch.models import transformer as tfm
    from repro_torch.train.optim import adamw, cosine_schedule

    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls would change which experts the router picks")
    cfg = dataclasses.replace(get_arch(MOE_ARCH).model_config(), n_layers=MOE_TRAIN_LAYERS)
    m, L = cfg.moe, cfg.n_layers
    rec = StepRecorder(LM_GROUPS)
    held, profiled = {}, contextlib.ExitStack()

    def on_step(state, metrics, batch):
        """Keeps the first batch; for the profiled step, the middle layer's
        MoE weights it runs on (copied to the host before the profile starts)
        and that layer's input in its forward, for `moe_split`."""
        if metrics["step"] == 0:
            held["batch"] = batch
        if metrics["step"] == PROFILED_STEP - 1:
            held["weights"] = {k: state.params["layers"][k][L // 2].cpu() for k in moe_lib.layer_shapes(m, cfg.d_model)}
            held["inputs"] = profiled.enter_context(moe_inputs_seen((L // 2,)))
        rec(state, metrics, batch)
        if metrics["step"] == PROFILED_STEP:
            profiled.close()

    log, routes = [], []
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = flash_attention_bwd.launches = 0
    bwd_before = bwd_kernel_launches()
    moe_lib.moe_block.route_log = routes
    t0 = time.perf_counter()
    try:
        state = train(MOE_ARCH, steps=TRAIN_STEPS, batch=LM_TRAIN_BATCH, seq=LM_TRAIN_SEQ, lr=TRAIN_LR,
                      device=device, seed=seed, cfg=cfg, on_step=on_step, log_fn=log.append)
        torch.cuda.synchronize()
    finally:
        moe_lib.moe_block.route_log = None
        profiled.close()
    wall_s = time.perf_counter() - t0
    launches = {"flash_attention": flash_attention.launches, "flash_attention_bwd": flash_attention_bwd.launches}
    bwd_kernels = {n: c - bwd_before[n] for n, c in bwd_kernel_launches().items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = rec.float_losses()
    check(state.step == TRAIN_STEPS and len(losses) == TRAIN_STEPS, f"olmoe trained {state.step} steps")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0], f"olmoe losses: {losses}")
    check(launches["flash_attention"] == 2 * L * TRAIN_STEPS,
          f"attention forward launches {launches['flash_attention']}, want 2 a layer a step (recompute)")
    check(launches["flash_attention_bwd"] == L * TRAIN_STEPS,
          f"attention backward launches {launches['flash_attention_bwd']}, want 1 a layer a step")
    check(bwd_kernels == {n: c * launches["flash_attention_bwd"] for n, c in BWD_BF16_ROUTE.items()},
          f"the backward's kernels on the MoE training path: {bwd_kernels}, want the bf16 wgmma route each call")
    check(len(routes) == L * TRAIN_STEPS, f"route_log holds {len(routes)} entries, want one a layer a step "
          f"({L * TRAIN_STEPS})")
    step_ms = rec.step_ms()
    step_routes = moe_step_routes(routes, m, L)
    batch, params = held["batch"], state.params
    split_weights, split_x = held["weights"], held["inputs"][L // 2][1]  # the input alone: its weights are views
    del state, held, routes  # the moments with the state: nothing below needs them
    gc.collect()
    torch.cuda.empty_cache()

    # the trained model's routing, fed to the placement, and one layer's gradients against the loop's
    with torch.no_grad():
        inputs = moe_layer_inputs(lambda: tfm.loss_fn(params, batch, cfg))
    check(len(inputs) == L, f"{len(inputs)} MoE blocks in a forward of {L} layers")
    placement = moe_placement(m, inputs, LM_TRAIN_BATCH)
    lp, x = inputs[L // 2]
    grads_vs_loop = moe_grads_vs_loop(m, lp, x) | {"layer": L // 2}
    del inputs, lp, x
    torch.cuda.empty_cache()

    # two gradients of the trained state on one batch, bit for bit
    g1 = train_grads(params, batch, cfg)
    g2 = train_grads(params, batch, cfg)
    torch.cuda.synchronize()
    grads_bit_equal = bit_equal(g1, g2)
    check(grads_bit_equal, "two gradients of one state on one batch differ: "
          f"{[i for i, (a, b) in enumerate(zip(g1, g2)) if not torch.equal(a, b)]}")
    del g2
    torch.cuda.empty_cache()

    # the optimizer alone: one AdamW update (clip included) of every leaf by that gradient, from fresh
    # moments (the same work as a step's update); it writes the params, which nothing reads after it
    opt = adamw(cosine_schedule(TRAIN_LR, 10, TRAIN_STEPS))
    opt_state = opt.init(params)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    opt_ms = []
    for _ in range(3):
        ev[0].record()
        opt.update(g1, opt_state, params, TRAIN_STEPS)
        ev[1].record()
        torch.cuda.synchronize()
        opt_ms.append(ev[0].elapsed_time(ev[1]))
    del g1, opt_state, params, opt
    gc.collect()
    torch.cuda.empty_cache()

    split = moe_split(m, {k: v.to(device) for k, v in split_weights.items()}, split_x, timer, L, backward=True)
    split["optimizer_ms"] = statistics.median(opt_ms)
    prof = rec.profile
    if prof and prof["device_ms"] > 0:
        split |= {"gemm_ms": prof["gemm_ms"] - split["gemm_inside_router_and_experts_ms"],
                  **{k: prof[k] for k in ("attention_forward_ms", "attention_backward_ms", "device_ms")}}
        split["rest_ms"] = prof["device_ms"] - sum(split[k] for k in (
            "router_topk_ms", "dispatch_ms", "experts_ms", "combine_ms", "gemm_ms", "attention_forward_ms",
            "attention_backward_ms", "optimizer_ms"))
    else:
        split |= {"gemm_ms": "not measured (the profiler saw no kernel)", "rest_ms": "not measured"}
    del split_weights, split_x
    gc.collect()
    torch.cuda.empty_cache()

    # the recompute routes as the forward did: gradients with it and without, at a cut depth
    cfg_eq = dataclasses.replace(cfg, n_layers=MOE_EQUAL_LAYERS)
    params_eq = tfm.init_params(cfg_eq, seed, device=device)
    with_remat = train_grads(params_eq, batch, cfg_eq)
    without = train_grads(params_eq, batch, dataclasses.replace(cfg_eq, remat=False))
    torch.cuda.synchronize()
    remat_bit_equal = bit_equal(with_remat, without)
    check(remat_bit_equal, "gradients with the recompute and without differ: "
          f"{[i for i, (a, b) in enumerate(zip(with_remat, without)) if not torch.equal(a, b)]}")
    del params_eq, with_remat, without
    torch.cuda.empty_cache()

    olmoe = {
        "arch": MOE_ARCH, "layers": L, "d_model": cfg.d_model, "heads": cfg.n_heads, "kv_heads": cfg.n_kv_heads,
        "head_dim": cfg.head_dim, "vocab": cfg.vocab, "experts": m.num_experts, "top_k": m.top_k,
        "d_ff_expert": m.d_ff_expert, "capacity_factor": m.capacity_factor, "impl": m.impl,
        "params": cfg.num_params, "active_params": cfg.num_active_params, "param_dtype": "float32",
        "activations": "bfloat16", "router": "float32", "remat": cfg.remat, "loss": "cross-entropy alone",
        "cuts": [f"{L} of {get_arch(MOE_ARCH).n_layers} layers: at 16 its float32 params, grads and AdamW moments "
                 "(111 GB) exceed the card; weights random from a seeded generator"],
        "batch": LM_TRAIN_BATCH, "seq": LM_TRAIN_SEQ, "steps": TRAIN_STEPS, "lr": TRAIN_LR, "losses": losses,
        "wall_s": wall_s, "step_ms_median_last10": step_ms,
        "tokens_per_s": LM_TRAIN_BATCH * LM_TRAIN_SEQ / (step_ms / 1e3), "max_memory_allocated_gb": peak_gb,
        "profile_one_step": rec.profile, "split_one_step_ms": split, "routes": step_routes,
        "flash_attention_launches_a_step": launches["flash_attention"] / TRAIN_STEPS,
        "flash_attention_bwd_launches_a_step": launches["flash_attention_bwd"] / TRAIN_STEPS,
        "flash_attention_bwd_kernel_launches": bwd_kernels, "route_log_entries_a_step": L,
        "grads_bit_equal_two_runs": grads_bit_equal,
        f"grads_bit_equal_remat_on_off_{MOE_EQUAL_LAYERS}_layers": remat_bit_equal,
        "grads_vs_loop": grads_vs_loop, "expert_placement": placement, "log": log,
    }

    wide = dataclasses.replace(get_arch(MOE_WIDE_ARCH).model_config(), n_layers=MOE_WIDE_TRAIN_LAYERS)
    qrec = StepRecorder(LM_GROUPS, profiled_step=None)
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = flash_attention_bwd.launches = 0
    bwd_before = bwd_kernel_launches()
    qstate = train(MOE_WIDE_ARCH, steps=MOE_WIDE_TRAIN_STEPS, batch=LM_TRAIN_BATCH, seq=LM_TRAIN_SEQ, lr=TRAIN_LR,
                   device=device, seed=seed, cfg=wide, on_step=qrec, log_fn=lambda _: None)
    torch.cuda.synchronize()
    qlosses = qrec.float_losses()
    q_launches = (flash_attention.launches, flash_attention_bwd.launches)
    q_bwd_kernels = {n: c - bwd_before[n] for n, c in bwd_kernel_launches().items()}
    check(qstate.step == MOE_WIDE_TRAIN_STEPS and all(np.isfinite(qlosses)), f"qwen2-moe losses: {qlosses}")
    check(q_launches == (2 * wide.n_layers * MOE_WIDE_TRAIN_STEPS, wide.n_layers * MOE_WIDE_TRAIN_STEPS),
          f"qwen2-moe attention launches {q_launches}")
    check(q_bwd_kernels == {n: c * q_launches[1] for n, c in BWD_BF16_ROUTE.items()},
          f"the backward's kernels on qwen2-moe's training path: {q_bwd_kernels}, want the bf16 wgmma route each call")
    qwen = {"arch": MOE_WIDE_ARCH, "layers": wide.n_layers, "experts": wide.moe.num_experts,
            "top_k": wide.moe.top_k, "d_ff_expert": wide.moe.d_ff_expert, "d_ff_shared": wide.moe.d_ff_shared,
            "params": wide.num_params, "steps": MOE_WIDE_TRAIN_STEPS, "losses": qlosses,
            "step_ms_median": qrec.step_ms(), "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
            "flash_attention_launches": q_launches[0], "flash_attention_bwd_launches": q_launches[1],
            "flash_attention_bwd_kernel_launches": q_bwd_kernels,
            "cuts": [f"{wide.n_layers} of {get_arch(MOE_WIDE_ARCH).n_layers} layers, {MOE_WIDE_TRAIN_STEPS} steps"]}
    del qstate
    gc.collect()
    torch.cuda.empty_cache()
    out = {"olmoe": olmoe, "qwen": qwen,
           "timing": "step_ms_median_last10: host clock between the synchronised ends of consecutive loop steps, "
                     "median of the last 10; profile_one_step: torch.profiler over step 5 alone; "
                     "split_one_step_ms: the MoE parts and the GEMMs inside them timed alone on the middle layer "
                     "with CUDA events (forward, and forward with backward, each replayed from a CUDA graph; the "
                     "forward counted twice), times the layers; GEMMs and attention "
                     "from profile_one_step (GEMMs less those inside the MoE parts); rest = device_ms less all; "
                     "optimizer: one AdamW update (clip included) of every leaf by a gradient of the trained "
                     "state, from fresh moments, after the checks, CUDA events, median of 3; qwen step_ms_median: "
                     "its last 4 steps",
           "card": smi}
    say("moe_train", **out)
    return out, {"flash_attention": launches["flash_attention"], "flash_attention_bwd": launches["flash_attention_bwd"],
                 "flash_attention_qwen": q_launches[0], "flash_attention_bwd_qwen": q_launches[1]}


# --------------------------------------------------------------------------- main


# --------------------------------------------------------------------------- the model paths on a 2-D mesh

# the mesh: 16 engines stacked on the card over ("data", "model") = (2, 8); one olmoe layer with expert
# parallelism (impl="ep_shardmap") on the production mesh (16, 16); dcn-v2 at its published size with the
# psum_model lookup on (2, 8); NCCL at world size 1 on (1, 1)
MESH_SHAPE, MESH_AXES = (2, 8), ("data", "model")
MESH_TURNS = ("local", "ep", "ep", "local")  # the two routes timed in turns on the same card
# float32 logits, EP against local, held at capacity_factor E/k, where no expert and no engine can overflow (at
# 4.0 the local path drops slots of a long prompt, so the two would keep different slots)
MESH_F32_TOL = 2e-3
# a float32 MoE route on the mesh may pick other experts than one device's only where the one-device router's k-th
# and (k+1)-th logits lie closer than ROUTER_NEAR_TIE (rounding orders them either way), at a position's first such
# layer, and at no more than ROUTER_FLIP_SHARE of the routings
ROUTER_NEAR_TIE, ROUTER_FLIP_SHARE = 1e-4, 1e-3
# the drop path at the config's capacity_factor: these float32 layers, on their inputs in a float32 prefill, against
# the plain per-engine loop (moe_ep_loop_ref): the same slots kept, outputs within
MESH_LOOP_LAYERS, MESH_LOOP_TOL = (0, 1), dict(rtol=1e-4, atol=1e-4)
MESH_PROD_TOKENS = 512  # n_l = 2 on 256 engines: Cs at its floor of 8, no slot can drop in EP
MESH_PROD_TOL = dict(rtol=1e-4, atol=1e-4)  # one float32 layer: the expert products over other row counts
MESH_DCN_STEPS = 5
MESH_DCN_LOSS_TOL = 1e-6
# the unsharded table gradient against the gather's with its batch looked up a data row at a time, of its
# largest entry, with deterministic adds (the atomic adds of training differ by ~5e-7 of it from run to run,
# and the whole batch's gather, its rows summed in one pass, by ~3e-6: both reported beside)
MESH_DCN_GRAD_REL = 1e-6


def ep_stats(log: list, m, ep: int, n_tokens: int, d_model: int, itemsize: int) -> dict:
    """From one call's `moe_block.ep_log` (an `EpRoute` a layer): each layer's
    share of routed slots dropped in stage 1 and of those kept dropped in
    stage 2, the slots the padded experts got, and the all-to-all bytes a
    layer (tokens there and outputs back, 2·engines·ep·Cs·d·itemsize, and the
    expert ids)."""
    e_l = m.padded_experts(ep) // ep
    s1, s2, padded = [], [], 0
    for r in log:
        c1, c2 = r.stage1.cpu(), r.stage2.cpu()
        slots = int(c1.sum())
        drop1 = int((c1 - r.Cs).clamp_min(0).sum())
        drop2 = int((c2[:, :e_l] - r.Ce).clamp_min(0).sum())
        s1.append(drop1 / slots)
        s2.append(drop2 / max(slots - drop1, 1))
        experts = c2[:, :e_l].reshape(-1, ep * e_l)  # (data rows, padded experts) in expert order
        padded += int(experts[:, m.num_experts:].sum())
    engines = log[0].stage1.shape[0]
    Cs, Ce = log[0].Cs, log[0].Ce
    return {"tokens": n_tokens, "Cs": Cs, "Ce": Ce, "layers": len(log),
            "stage1_dropped_share_by_layer": [round(v, 6) for v in s1],
            "stage2_dropped_share_by_layer": [round(v, 6) for v in s2],
            "stage1_dropped_share_mean": float(np.mean(s1)), "stage2_dropped_share_mean": float(np.mean(s2)),
            "padded_experts": m.padded_experts(ep) - m.num_experts, "padded_expert_slots": padded,
            "all_to_all_bytes_a_layer": 2 * engines * ep * Cs * d_model * itemsize,
            "expert_id_bytes_a_layer": engines * ep * Cs * 8}


@contextlib.contextmanager
def deterministic_algorithms():
    """`torch.use_deterministic_algorithms(True)` inside the block, warnings
    only (cuBLAS asks for a workspace setting to promise it), then as before."""
    was = torch.are_deterministic_algorithms_enabled(), torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            yield
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])


def ep_logged(fn):
    """(fn()'s result, the `EpRoute`s its MoE layers logged)."""
    from repro_torch.models.moe import moe_block

    moe_block.ep_log = log = []
    try:
        out = fn()
        torch.cuda.synchronize()
    finally:
        moe_block.ep_log = None
    return out, log


def local_dropped(fn) -> tuple:
    """(fn()'s result, slots its local-path MoE layers dropped)."""
    from repro_torch.models.moe import moe_block

    moe_block.route_log = log = []
    try:
        out = fn()
        torch.cuda.synchronize()
    finally:
        moe_block.route_log = None
    return out, sum(int((c - C).clamp_min(0).sum()) for C, c in log)


def production_layer(device: torch.device, m, lp: dict, timer: Timer, seed: int) -> tuple[dict, torch.Tensor]:
    """One olmoe MoE layer (float32 weights of layer 0) on the production mesh,
    (16, 16) stacked: 256 engines, MESH_PROD_TOKENS random tokens, Cs at its
    floor, at capacity_factor 4.0 against the local path."""
    from repro_torch.launch.mesh import make_production_mesh, mesh_devices
    from repro_torch.models import moe as moe_lib

    mesh = make_production_mesh(device=device)
    check(mesh_devices(mesh) == 256 and mesh.shape == {"data": 16, "model": 16}, f"production mesh {mesh.shape}")
    gen = torch.Generator(device=device).manual_seed(seed + 3)
    x = torch.randn((1, MESH_PROD_TOKENS, lp["router"].shape[0]), generator=gen, device=device)
    m4 = dataclasses.replace(m, capacity_factor=4.0)
    ep = dataclasses.replace(m4, impl="ep_shardmap")
    want, local_drop = local_dropped(lambda: moe_lib.moe_block(m4, lp, x))
    lp_ep = moe_lib.shard_experts(ep, lp, mesh)
    got, log = ep_logged(lambda: moe_lib.moe_block(ep, lp_ep, x, mesh=mesh))
    routes = ep_stats(log, m, 16, MESH_PROD_TOKENS, x.shape[-1], 4)
    err = float((got - want).abs().max())
    check(routes["Cs"] == 8, f"Cs {routes['Cs']} on the production mesh, want its floor of 8")
    check(local_drop == 0 and routes["stage1_dropped_share_mean"] == 0 and routes["stage2_dropped_share_mean"] == 0,
          f"slots dropped on the production mesh's layer: local {local_drop}, EP {routes}")
    check(torch.allclose(got, want, **MESH_PROD_TOL), f"the production mesh's EP layer vs local: {err}")
    with torch.no_grad():
        ep_ms = timer.device_ms(lambda: moe_lib.moe_block(ep, lp_ep, x, mesh=mesh), calls=3, reps=5)
        local_ms = timer.device_ms(lambda: moe_lib.moe_block(m4, lp, x), calls=3, reps=5)
    return {"mesh": dict(mesh.shape), "engines": 256, "tokens": MESH_PROD_TOKENS, "dtype": "float32",
            "capacity_factor": 4.0, "Cs": routes["Cs"], "Ce": routes["Ce"], "max_abs_err_vs_local": err,
            "out_max_abs": float(want.abs().max()), "tolerance": MESH_PROD_TOL,
            "all_to_all_bytes": routes["all_to_all_bytes_a_layer"], "ep_ms": ep_ms, "local_ms": local_ms}, x


@contextlib.contextmanager
def bag_by_rows(rows: int):
    """`models.recsys`'s bag called once for each of `rows` equal slices of
    the batch (the gather route's lookup split as psum_model splits it over
    the data axis); its own call, as before, after the block."""
    from repro_torch.models import recsys as rec

    bag = rec.embedding_bag

    def by_rows(tables, ids, weights=None, *, impl="auto"):
        ws = [None] * rows if weights is None else weights.chunk(rows)
        return torch.cat([bag(tables, i, w, impl=impl) for i, w in zip(ids.chunk(rows), ws)])

    rec.embedding_bag = by_rows
    try:
        yield
    finally:
        rec.embedding_bag = bag


def mesh_recsys(device: torch.device, seed: int, timer: Timer, mesh) -> tuple[dict, dict, dict]:
    """dcn-v2 at its published size with lookup_impl="psum_model" on `mesh`,
    its tables row-sharded by `shard_tensor`: `serve_bulk` logits against the
    gather path's (bit-equal), MESH_DCN_STEPS training steps at `train_batch`
    against the gather path's (losses, and the first step's unsharded table
    gradient), one bag launch a data row a lookup; the bag kernel at the slab's shape
    against its plain version, its bound and `F.embedding_bag`.  Returns (the
    entry, the kernel's call site, what the NCCL check reuses)."""
    from repro_torch.configs.base import RECSYS_SHAPES
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.pipeline import RecsysPipeline, to_device
    from repro_torch.kernels.embedding_bag.ops import embedding_bag
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
    from repro_torch.models import recsys as rec
    from repro_torch.models.sharding import shard_tensor, unshard_tensor
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.optim import adamw, cosine_schedule
    from repro_torch.train.pytree import tree_map

    cfg = get_arch(RECSYS_ARCH).model_config()
    ps = dataclasses.replace(cfg, lookup_impl="psum_model")
    ep, t, v, d = mesh.shape["model"], cfg.n_sparse, cfg.rows_per_table, cfg.embed_dim
    params = rec.init_params(cfg, seed, device=device)
    spec = rec.param_specs(ps, mesh)["tables"]
    t0 = time.perf_counter()
    sharded = dict(params, tables=shard_tensor(params["tables"], spec, mesh))
    torch.cuda.synchronize()
    shard_s = time.perf_counter() - t0
    check(tuple(sharded["tables"].shape) == (1, ep, t, v // ep, d) and sharded["tables"].is_contiguous(),
          f"the slab {tuple(sharded['tables'].shape)}")
    check(torch.equal(unshard_tensor(sharded["tables"], spec, mesh), params["tables"]), "unshard(shard(tables))")

    def batches(size, n):
        it = iter(RecsysPipeline(cfg.n_dense, cfg.n_sparse, cfg.rows_per_table, size, seed=seed))
        return [to_device(next(it), device) for _ in range(n)]

    bulk = batches(RECSYS_SHAPES["serve_bulk"]["batch"], 1)[0]
    embedding_bag.launches = 0  # the path's own count starts here
    with torch.inference_mode():
        got = rec.forward(sharded, bulk, ps, mesh=mesh)
        torch.cuda.synchronize()
        serve_launches = embedding_bag.launches
        want = rec.forward(params, bulk, cfg)
        torch.cuda.synchronize()
    rows = int(np.prod([n for a, n in mesh.shape.items() if a != "model"]))  # one bag launch a data row
    check(serve_launches == rows, f"the psum_model forward launched the bag {serve_launches} times, want {rows}")
    check(got.shape == want.shape and torch.equal(got, want), "serve_bulk: psum_model logits vs the gather's")
    with torch.inference_mode():
        bulk_ms = timer.call_ms(lambda: rec.forward(sharded, bulk, ps, mesh=mesh), calls=3, reps=5)
        bulk_gather_ms = timer.call_ms(lambda: rec.forward(params, bulk, cfg), calls=3, reps=5)
    del bulk, got, want

    # training: the first step's table gradient, then MESH_DCN_STEPS steps of each route
    train = batches(RECSYS_SHAPES["train_batch"]["batch"], MESH_DCN_STEPS)

    def table_grad(p, c, **kw):
        """The whole (T, V, D) table gradient of the first batch's loss."""
        tab = p["tables"].detach().requires_grad_(True)
        g = torch.autograd.grad(rec.loss_fn(dict(p, tables=tab), train[0], c, **kw), tab)[0]
        check(g.shape == p["tables"].shape, "the table gradient leaves the table's layout")
        return unshard_tensor(g, spec, mesh) if kw else g

    def rel(a, b):
        return float((a - b).abs().max()) / float(b.abs().max())

    # as training runs: the bag's backward adds with `index_add_`'s atomics, in an order that changes from
    # run to run, so the gather route is also held against itself
    g_gather = table_grad(params, cfg)
    grads = {"atomic_rel_err": rel(table_grad(sharded, ps, mesh=mesh), g_gather),
             "atomic_gather_run_to_run_rel": rel(table_grad(params, cfg), g_gather)}
    del g_gather
    # the same with deterministic algorithms (`index_add_` adds a row's terms in index order), against the
    # gather route with its batch looked up one data row at a time, as psum_model splits it (each row's table
    # gradient summed apart, then the rows added): the routes add the same nonzero terms in the same order, the
    # sharded one also zeros for the ids its shards do not own; beside it, the whole batch's gather
    with deterministic_algorithms():
        g_psum = table_grad(sharded, ps, mesh=mesh)
        grads["rel_err_whole_batch_gather"] = rel(g_psum, table_grad(params, cfg))
        with bag_by_rows(rows):
            grads["rel_err"] = rel(g_psum, table_grad(params, cfg))
    del g_psum
    check(grads["rel_err"] <= MESH_DCN_GRAD_REL,
          f"unsharded table gradient vs the gather's (deterministic adds): {grads}")
    lr_fn = cosine_schedule(TRAIN_LR, 10, TRAIN_STEPS)
    routes = {"gather": (cfg, params, {}), "psum_model": (ps, sharded, {"mesh": mesh})}
    losses = {name: {"runs": []} for name in routes}
    for name in ("gather", "psum_model", "psum_model", "gather"):  # in turns on the same card
        c, p, kw = routes[name]
        init, step = make_train_step(lambda prm, b, c=c, kw=kw: rec.loss_fn(prm, b, c, **kw), adamw(lr_fn))
        st = init(tree_map(torch.clone, p))  # each run trains a copy of the same weights
        embedding_bag.launches = 0
        out = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in train:
            st, metrics = step(st, b)
            out.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        losses[name]["runs"].append({"losses": out, "wall_ms_a_step": (time.perf_counter() - t0) / len(train) * 1e3,
                                     "embedding_bag_launches": embedding_bag.launches})
        del st
        gc.collect()
    for name, r in losses.items():
        r["losses"] = r["runs"][0]["losses"]
        r["wall_ms_a_step"] = float(np.mean([run["wall_ms_a_step"] for run in r["runs"]]))
        r["embedding_bag_launches"] = r["runs"][0]["embedding_bag_launches"]
        r["runs_bit_equal"] = r["runs"][0]["losses"] == r["runs"][1]["losses"]
    check(all(run["embedding_bag_launches"] == MESH_DCN_STEPS * rows for run in losses["psum_model"]["runs"]),
          f"psum_model training launched the bag {losses['psum_model']['runs']} times, want {MESH_DCN_STEPS * rows}")
    loss_diff = float(np.max(np.abs(np.array(losses["psum_model"]["losses"]) - np.array(losses["gather"]["losses"]))))
    check(all(np.isfinite(losses["psum_model"]["losses"])) and loss_diff <= MESH_DCN_LOSS_TOL,
          f"psum_model losses vs the gather's: {losses}")

    # the lookup and its kernel at the training batch: the slab seen as (ep·T, V/ep, D), shifted ids
    ids = train[0]["sparse_ids"].to(torch.int32)
    slab = sharded["tables"].view(ep * t, v // ep, d)
    lo = torch.arange(ep, device=device, dtype=torch.int32) * (v // ep)
    shifted = (ids[:, None, :] - lo[None, :, None]).reshape(ids.shape[0], ep * t, 1).contiguous()
    kern, again, plain = embedding_bag(slab, shifted), embedding_bag(slab, shifted), embedding_bag_ref(slab, shifted)
    lib_fn = library_bag(slab, shifted, None)
    lib = lib_fn()
    torch.cuda.synchronize()
    k_err = float((kern - plain).abs().max())
    check(torch.equal(kern, again) and torch.allclose(kern, plain, **F32_TOL), f"bag at the slab vs plain: {k_err}")
    check(torch.allclose(lib, kern, **F32_TOL), "bag at the slab vs F.embedding_bag")
    bound, by, distinct = bag_bound_ms(slab, shifted, None)
    part = kern.view(ids.shape[0], ep, t, d).transpose(0, 1)[None]  # (1, ep, B, T, D): the local engines' partials
    with torch.no_grad():
        site = {"shape": f"dcn-v2's psum_model lookup on {tuple(mesh.axis_sizes)}: the slab ({ep * t}, {v // ep}, {d}) f32, "
                         f"shifted ids ({ids.shape[0]}, {ep * t}, 1) Zipf, no weights",
                "distinct_rows": distinct, "max_abs_err": k_err,
                "ms": timer.device_ms(lambda: embedding_bag(slab, shifted)),
                "call_ms": timer.call_ms(lambda: embedding_bag(slab, shifted)),
                "plain_ms": timer.call_ms(lambda: embedding_bag_ref(slab, shifted), calls=3, reps=5),
                "bound_ms": bound, "bound_by": by, "library_ms": timer.call_ms(lib_fn)}
        ids3 = ids[..., None]
        lookup = {"psum_model_ms": timer.device_ms(lambda: rec.embedding_lookup(ps, sharded["tables"], ids, mesh=mesh)),
                  "fold_ms": timer.device_ms(lambda: mesh.psum(part, "model")),
                  "gather_ms": timer.device_ms(lambda: embedding_bag(params["tables"], ids3)),
                  "partial_bytes": ep * ids.shape[0] * t * d * 4}
    out = {"arch": RECSYS_ARCH, "tables": [t, v, d], "mesh": dict(mesh.shape), "slab": list(sharded["tables"].shape),
           "shard_s": shard_s, "serve_bulk": {"batch": RECSYS_SHAPES["serve_bulk"]["batch"],
                                              "logits_bit_equal_gather": True, "embedding_bag_launches": serve_launches,
                                              "ms": bulk_ms, "gather_ms": bulk_gather_ms,
                                              "partial_bytes": ep * RECSYS_SHAPES["serve_bulk"]["batch"] * t * d * 4},
           "train": {"batch": RECSYS_SHAPES["train_batch"]["batch"], "steps": MESH_DCN_STEPS, **losses,
                     "loss_max_abs_diff": loss_diff, "loss_tolerance": MESH_DCN_LOSS_TOL,
                     "table_grad": grads | {"tolerance": MESH_DCN_GRAD_REL}},
           "lookup_at_train_batch": lookup}
    keep = {"cfg": ps, "tables": params["tables"], "ids": ids[:512]}
    return out, site, keep


def nccl_world_one_models(device: torch.device, m, lp: dict, x: torch.Tensor, dcn: dict) -> dict:
    """EP on one olmoe layer and the psum_model lookup over the
    "process_group" backend, NCCL at world size 1 on a (1, 1) mesh, against
    the stacked (1, 1) mesh: bit-equal.  The group is destroyed after."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.graph.distributed import make_mesh
    from repro_torch.models import moe as moe_lib
    from repro_torch.models import recsys as rec
    from repro_torch.models.sharding import shard_tensor

    ep = dataclasses.replace(m, impl="ep_shardmap")
    stacked = make_mesh((1, 1), MESH_AXES, device=device)
    cfg = dcn["cfg"]
    slab = shard_tensor(dcn["tables"], rec.param_specs(cfg, stacked)["tables"], stacked)
    with torch.no_grad():
        want_ep = moe_lib.moe_block(ep, moe_lib.shard_experts(ep, lp, stacked), x, mesh=stacked)
        want_bag = rec.embedding_lookup(cfg, slab, dcn["ids"], mesh=stacked)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store", world_size=1, rank=0)
        try:
            pg = make_mesh((1, 1), MESH_AXES, backend="process_group", device=device)
            with torch.no_grad():
                got_ep = moe_lib.moe_block(ep, moe_lib.shard_experts(ep, lp, pg), x, mesh=pg)
                got_bag = rec.embedding_lookup(cfg, slab, dcn["ids"], mesh=pg)
            torch.cuda.synchronize()
            backend = dist.get_backend()
        finally:
            dist.destroy_process_group()
    r = {"backend": backend, "world_size": 1, "mesh": dict(stacked.shape),
         "ep_bit_equal_stacked": bool(torch.equal(got_ep, want_ep)),
         "psum_model_bit_equal_stacked": bool(torch.equal(got_bag, want_bag))}
    check(r["ep_bit_equal_stacked"] and r["psum_model_bit_equal_stacked"],
          f"NCCL at world size 1 vs the stacked (1, 1) mesh: {r}")
    return r


def phase_mesh_models(device: torch.device, seed: int, smi: str | None, timer: Timer) -> tuple[dict, dict]:
    """The model paths on a 2-D engine mesh: one olmoe layer with EP on the
    production mesh, dcn-v2's psum_model lookup on (2, 8), NCCL at world
    size 1 (olmoe and qwen2-moe served on (2, 8): `phase_mesh_moe_serve`).
    Returns (the `mesh_models` line, the bag's new call site)."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.graph.distributed import make_mesh
    from repro_torch.models import transformer as tfm

    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls would change which experts the router picks")
    mesh = make_mesh(MESH_SHAPE, MESH_AXES, device=device)
    check(mesh.num_engines == 16 and mesh.backend == "stacked" and mesh.device.type == "cuda", "the (2, 8) mesh")
    cfg = get_arch(MOE_ARCH).model_config()
    t0 = time.perf_counter()
    lp0 = tfm._layer(tfm.init_params(dataclasses.replace(cfg, n_layers=1), seed, device=device), 0)
    prod, x = production_layer(device, cfg.moe, lp0, timer, seed)
    prod["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    dcn, site, keep = mesh_recsys(device, seed, timer, mesh)
    dcn["seconds"] = time.perf_counter() - t0
    nccl = nccl_world_one_models(device, cfg.moe, lp0, x, keep)
    del lp0, x, keep
    gc.collect()
    torch.cuda.empty_cache()
    out = {"production_mesh_layer": prod, "dcn": dcn, "nccl": nccl,
           "weights": "random, from a seeded torch.Generator on the card (the production layer: a one-layer "
                      "olmoe's; dcn-v2: the recsys phase's seed)",
           "timing": "layer and lookup ms: CUDA-graph replays (device time), serve_bulk ms calls back to back",
           "card": smi}
    say("mesh_models", **out)
    return out, site


# --------------------------------------------------------------------------- mesh_train

# Training through the engine mesh's exchanges: (e′) the halo GIN over DIST_ENGINES stacked engines on amazon,
# (f′) olmoe-1b-7b and qwen2-moe-a2.7b with EP on MESH_SHAPE, (f″) dcn-v2's psum_model over NCCL at world size 1.
HALO_TRAIN_STEPS = 5
HALO_LOSS_RTOL = 1e-5  # the halo GIN's first loss against the one-device gnn.loss_fn's, same weights and mask
MESH_GRAD_REL = 1e-4  # each gradient leaf against the largest entry of its reference's
# (b‴)'s cut; at a peak above EP_TRAIN_PEAK_GB it would be 6 layers
EP_TRAIN_LAYERS, EP_TRAIN_STEPS, EP_TRAIN_PEAK_GB = 8, 10, 78.0
# the float32 gradient checks run on these layers: EP against local at capacity_factor E/k (neither drops),
# and at the config's against autograd through moe_ep_loop_ref (the same slots)
EP_F32_LAYERS = 2
EP_QWEN_LAYERS, EP_QWEN_STEPS = 2, 3
PSUM_NCCL_STEPS = 5


def rel_errs(got, want, names) -> dict:
    """{name: max |got − want| / max |want|} over matching leaves."""
    return {n: float((g.float() - w.float()).abs().max()) / (float(w.float().abs().max()) + 1e-30)
            for n, g, w in zip(names, got, want)}


def halo_train(device: torch.device, graph, perm: np.ndarray, seed: int, timer: Timer) -> tuple[dict, int, dict]:
    """(e′): gin-tu (published width and depth) at `ogb_products`' feature
    width trained by halo exchange over DIST_ENGINES stacked engines under
    `perm`, HALO_TRAIN_STEPS steps at the reference launcher's defaults
    (AdamW on its schedule from lr 1e-3, clip 1.0): the first loss and every
    gradient against the one-device `gnn.loss_fn`'s on the same weights and
    mask, two gradients bit-equal, losses finite and falling, NCCL at world
    size 1 bit-equal to stacked; step ms, peak memory, reduce launches a step
    (forward and backward apart), halo bytes an engine a layer each way.
    Returns (the entry, the training's `segment_spmm` launches, the
    transposed halo reduce's call site)."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.configs.registry import get_arch
    from repro_torch.data.pipeline import GraphBatcher, to_device
    from repro_torch.graph.distributed import make_engines_mesh
    from repro_torch.graph.halo import build_halo_plan, plan_sizes
    from repro_torch.models import gnn
    from repro_torch.models.gnn_dist import gin_halo_loss_fn, pack_batch, shard_batch
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.optim import adamw, cosine_schedule
    from repro_torch.train.pytree import tree_leaves, tree_leaves_with_path, tree_map

    cfg = get_arch(GNN_ARCH).model_config(GNN_WIDE_CELL)
    n = graph.num_nodes
    plan = build_halo_plan(graph.src, graph.dst, n, DIST_ENGINES)
    host = GraphBatcher(graph, d_feat=cfg.d_in, n_classes=cfg.d_out, seed=seed).full_batch()
    mesh = make_engines_mesh(perm, num_engines=DIST_ENGINES, device=device)
    t0 = time.perf_counter()
    batch = shard_batch(pack_batch(plan, host["x"], host["labels"], host["train_mask"]), mesh, transpose=True)
    torch.cuda.synchronize()
    shard_s = time.perf_counter() - t0
    params = gnn.init_params(cfg, seed, device=device)
    names = ["/".join(map(str, path)) for path, _ in tree_leaves_with_path(params)]

    def grads(loss_fn, p, b, m=None):
        """(loss, every leaf's gradient, forward counts, backward counts)."""
        leaves = tree_leaves(p)
        for t in leaves:
            t.requires_grad_(True)
        try:
            loss, fwd = counted(lambda: loss_fn(p, b, cfg, m) if m is not None else loss_fn(p, b, cfg))
            g, bwd = counted(lambda: torch.autograd.grad(loss, leaves))
        finally:
            for t in leaves:
                t.requires_grad_(False)
        return loss.detach(), g, fwd, bwd

    loss, g, fwd, bwd = grads(gin_halo_loss_fn, params, batch, mesh)
    r = {"arch": GNN_ARCH, "layers": cfg.n_layers, "d_hidden": cfg.d_hidden, "d_in": cfg.d_in,
         "engines": DIST_ENGINES, "plan": plan_sizes(plan), "shard_batch_host_s": shard_s,
         "reduce_launches_a_step": {"forward": check_only_reduces(fwd, cfg.n_layers, "a halo GIN forward"),
                                    "backward": check_only_reduces(bwd, cfg.n_layers - 1, "a halo GIN backward")}}
    again = grads(gin_halo_loss_fn, params, batch, mesh)
    r["grads_bit_equal_two_runs"] = bool(torch.equal(loss, again[0]) and bit_equal(g, again[1]))
    check(r["grads_bit_equal_two_runs"], "two halo GIN gradients differ")
    del again
    full = to_device(host, device)
    full["ell"] = gnn.batch_ell(host, device=device, transpose=True)
    loss1, g1, _, _ = grads(gnn.loss_fn, params, full)
    del full
    r["first_loss"], r["one_device_first_loss"] = float(loss), float(loss1)
    r["first_loss_rel_err"] = abs(float(loss) - float(loss1)) / abs(float(loss1))
    r["grads_rel_err_vs_one_device"] = rel_errs(g, g1, names)
    r["tolerance"] = {"first_loss_rel": HALO_LOSS_RTOL, "grad_rel_to_largest": MESH_GRAD_REL}
    check(r["first_loss_rel_err"] <= HALO_LOSS_RTOL, f"halo GIN first loss vs one device: {r['first_loss_rel_err']}")
    check(max(r["grads_rel_err_vs_one_device"].values()) <= MESH_GRAD_REL,
          f"halo GIN gradients vs one device: {r['grads_rel_err_vs_one_device']}")
    del g, g1

    # training, the reference launcher's optimizer and schedule
    init, step = make_train_step(lambda p, b: gin_halo_loss_fn(p, b, cfg, mesh),
                                 adamw(cosine_schedule(TRAIN_LR, 10, HALO_TRAIN_STEPS)))
    state = init(tree_map(torch.clone, params))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def loop():
        nonlocal state
        ends, losses = [time.perf_counter()], []
        for _ in range(HALO_TRAIN_STEPS):
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))  # the host waits for the step here
            ends.append(time.perf_counter())
        return losses, ends

    (losses, ends), counts = counted(loop)
    del state
    r["losses"], r["steps"] = losses, HALO_TRAIN_STEPS
    r["step_ms"] = float(np.median(np.diff(ends)[1:]) * 1e3)
    r["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    launches = check_only_reduces(counts, (2 * cfg.n_layers - 1) * HALO_TRAIN_STEPS, "halo GIN training")
    r["segment_spmm_launches"] = launches
    check(all(np.isfinite(losses)) and losses[-1] < losses[0], f"halo GIN losses: {losses}")
    # the exchange's bytes an engine: forward at every layer's input width; backward at every layer but the
    # first (the input features need no gradient), the cotangents of the same rows
    widths = [cfg.d_in] + [cfg.d_hidden] * (cfg.n_layers - 1)
    r["halo_bytes_an_engine_a_layer"] = {"forward": {f"D{d}": plan.halo_bytes_per_device(d) for d in sorted(set(widths))},
                                         "backward": {f"D{cfg.d_hidden}": plan.halo_bytes_per_device(cfg.d_hidden)}}
    r["halo_bytes_a_step_all_engines"] = DIST_ENGINES * (sum(plan.halo_bytes_per_device(d) for d in widths)
                                                         + sum(plan.halo_bytes_per_device(d) for d in widths[1:]))

    # NCCL at world size 1 against the stacked backend, one engine
    plan1 = build_halo_plan(graph.src, graph.dst, n, 1)
    packed1 = pack_batch(plan1, host["x"], host["labels"], host["train_mask"])
    one = make_engines_mesh(num_engines=1, device=device)
    want = grads(gin_halo_loss_fn, params, shard_batch(packed1, one, transpose=True), one)[:2]
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store", world_size=1, rank=0)
        try:
            pg = make_engines_mesh(backend="process_group", device=device)
            got = grads(gin_halo_loss_fn, params, shard_batch(packed1, pg, transpose=True), pg)[:2]
            torch.cuda.synchronize()
        finally:
            dist.destroy_process_group()
    r["nccl_world_one_bit_equal_stacked"] = bool(torch.equal(got[0], want[0]) and bit_equal(got[1], want[1]))
    check(r["nccl_world_one_bit_equal_stacked"], "halo GIN gradients over NCCL at world size 1 vs stacked")
    del got, want

    # the new call site of the reduce: the halo sum's transpose, the backward at D = d_hidden
    gen = torch.Generator(device).manual_seed(seed)
    tr = batch["ell"].transpose
    x = torch.randn((tr.num_nodes, cfg.d_hidden), device=device, generator=gen)
    site = call_site_check(tr, x, timer, lambda x, ell: (gin_reduce_bound_ms(x, ell), "bytes"))
    del batch, params, x, tr
    gc.collect()
    torch.cuda.empty_cache()
    return r, launches, site


def lm_train_run(cfg, batches: list, device: torch.device, seed: int, mesh=None) -> dict:
    """`len(batches)` training steps of `cfg` from the seed's weights (laid
    out on `mesh` where given: EP's expert stacks, or every leaf of a dense
    model) at the launcher's defaults: losses, step ms, peak memory, each
    kernel's launches, and for EP its `EpRoute`s."""
    from repro_torch.models import moe as moe_lib
    from repro_torch.models import transformer as tfm
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.optim import adamw, cosine_schedule

    params = tfm.init_params(cfg, seed, device=device)
    if mesh is not None:
        params = tfm.shard_params(params, cfg, mesh)
    sharded = tfm.sharded_specs(cfg, mesh) if mesh is not None else {}
    opt = adamw(cosine_schedule(TRAIN_LR, 10, len(batches)), mesh=mesh, sharded=sharded)
    init, step = make_train_step(lambda p, b: tfm.loss_fn(p, b, cfg, mesh=mesh), opt)
    state = init(params)
    del params
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def loop():
        nonlocal state
        ends, losses = [time.perf_counter()], []
        for b in batches:
            state, metrics = step(state, b)
            losses.append(float(metrics["loss"]))
            ends.append(time.perf_counter())
        return losses, ends

    log = []
    moe_lib.moe_block.ep_log = log if mesh is not None else None
    try:
        (losses, ends), counts = counted(loop)
    finally:
        moe_lib.moe_block.ep_log = None
    peak = torch.cuda.max_memory_allocated() / 1e9
    del state
    gc.collect()
    torch.cuda.empty_cache()
    step_ms = float(np.median(np.diff(ends)[1:]) * 1e3)
    tokens = batches[0]["tokens"].numel()
    return {"losses": losses, "step_ms": step_ms, "tokens_per_s": tokens / (step_ms / 1e3),
            "max_memory_allocated_gb": peak, "launches": counts, "ep_log": log}


def ep_train(device: torch.device, seed: int, mesh) -> tuple[dict, dict]:
    """(f′): olmoe-1b-7b at its published width over EP_TRAIN_LAYERS layers
    trained EP_TRAIN_STEPS steps with EP on `mesh` and with the local path on
    the same weights and batches, in turns (MESH_TURNS); its float32
    gradients on EP_F32_LAYERS layers against local's at capacity_factor E/k
    and, layer by layer at the config's, against autograd through
    `moe_ep_loop_ref`; qwen2-moe-a2.7b over EP_QWEN_LAYERS layers for
    EP_QWEN_STEPS steps.  Returns (the entry, the first EP run's and qwen's
    kernel launches)."""
    import itertools

    from repro_torch.configs.registry import get_arch
    from repro_torch.data.pipeline import TokenPipeline, to_device
    from repro_torch.models import moe as moe_lib
    from repro_torch.models import transformer as tfm
    from repro_torch.models.sharding import P, shard_tensor, unshard_tensor
    from repro_torch.train.pytree import tree_leaves, tree_leaves_with_path, tree_unflatten

    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls would change which experts the router picks")
    cfg = dataclasses.replace(get_arch(MOE_ARCH).model_config(), n_layers=EP_TRAIN_LAYERS)
    m, L = cfg.moe, cfg.n_layers
    ep = mesh.shape[m.ep_axis]
    ep_cfg = dataclasses.replace(cfg, moe=dataclasses.replace(m, impl="ep_shardmap"))

    def token_batches(vocab, steps):
        data = TokenPipeline(vocab, LM_TRAIN_SEQ, LM_TRAIN_BATCH, seed=seed)
        return [to_device(b, device) for b in itertools.islice(data, steps)]

    batches = token_batches(cfg.vocab, EP_TRAIN_STEPS)
    runs = {"local": [], "ep": []}
    for name in MESH_TURNS:
        r = lm_train_run(ep_cfg if name == "ep" else cfg, batches, device, seed, mesh if name == "ep" else None)
        check(all(np.isfinite(r["losses"])) and r["losses"][-1] < r["losses"][0], f"olmoe {name}: {r['losses']}")
        check(r["launches"]["flash_attention"] == 2 * L * EP_TRAIN_STEPS
              and r["launches"]["flash_attention_bwd"] == L * EP_TRAIN_STEPS,
              f"olmoe {name}: attention launches {r['launches']}")
        if name == "ep":
            check(len(r["ep_log"]) == L * EP_TRAIN_STEPS, f"ep_log: {len(r['ep_log'])} entries, want one a layer a step")
        runs[name].append(r)
    first = runs["ep"][0]
    routes = ep_stats(first["ep_log"][:L], m, ep, batches[0]["tokens"].numel(), cfg.d_model, 2)
    last = ep_stats(first["ep_log"][-L:], m, ep, batches[0]["tokens"].numel(), cfg.d_model, 2)
    out = {"arch": MOE_ARCH, "layers": L, "steps": EP_TRAIN_STEPS, "batch": LM_TRAIN_BATCH, "seq": LM_TRAIN_SEQ,
           "mesh": dict(mesh.shape), "engines": mesh.num_engines, "turns": list(MESH_TURNS),
           "cuts": [f"{L} of {get_arch(MOE_ARCH).n_layers} layers, as the moe_train phase (at 16 the training "
                    "state needs 111 GB)"],
           "losses": {k: v[0]["losses"] for k, v in runs.items()},
           "ep_runs_losses_bit_equal": first["losses"] == runs["ep"][1]["losses"],
           "step_ms": {k: float(np.mean([r["step_ms"] for r in v])) for k, v in runs.items()},
           "tokens_per_s": {k: float(np.mean([r["tokens_per_s"] for r in v])) for k, v in runs.items()},
           "max_memory_allocated_gb": {k: max(r["max_memory_allocated_gb"] for r in v) for k, v in runs.items()},
           "runs": {k: [{f: r[f] for f in ("step_ms", "tokens_per_s", "max_memory_allocated_gb")} for r in v]
                    for k, v in runs.items()},
           "flash_attention_launches_a_step": first["launches"]["flash_attention"] / EP_TRAIN_STEPS,
           "flash_attention_bwd_launches_a_step": first["launches"]["flash_attention_bwd"] / EP_TRAIN_STEPS,
           "ep_log_entries_a_step": len(first["ep_log"]) / EP_TRAIN_STEPS,
           "routes_first_step": routes,
           "routes_last_step": {k: last[k] for k in ("stage1_dropped_share_mean", "stage2_dropped_share_mean")},
           "all_to_all_bytes_a_layer": {"forward": routes["all_to_all_bytes_a_layer"],
                                        "backward": routes["all_to_all_bytes_a_layer"]},
           "peak_limit_gb": EP_TRAIN_PEAK_GB}
    out["ep_vs_local_step_ms"] = out["step_ms"]["ep"] / out["step_ms"]["local"]
    check(out["max_memory_allocated_gb"]["ep"] <= EP_TRAIN_PEAK_GB,
          f"EP training's peak {out['max_memory_allocated_gb']['ep']} GB at {L} layers: take 6")
    launches = dict(first["launches"])
    del runs, first

    # float32 gradients on EP_F32_LAYERS layers
    f32 = dataclasses.replace(cfg, n_layers=EP_F32_LAYERS, dtype=torch.float32)
    cf = m.num_experts / m.top_k
    loc = dataclasses.replace(f32, moe=dataclasses.replace(m, capacity_factor=cf))
    e_cf = dataclasses.replace(loc, moe=dataclasses.replace(loc.moe, impl="ep_shardmap"))
    params = tfm.init_params(f32, seed, device=device)
    names = ["/".join(map(str, p)) for p, _ in tree_leaves_with_path(params)]
    want, local_drop = local_dropped(lambda: train_grads(params, batches[0], loc))
    sharded = tfm.shard_params(params, e_cf, mesh)
    got, log = ep_logged(lambda: train_grads(sharded, batches[0], e_cf, mesh))
    ep_drop = sum(int((r.stage1 - r.Cs).clamp_min(0).sum()) + int((r.stage2[:, :-1] - r.Ce).clamp_min(0).sum())
                  for r in log)
    got = tree_leaves(tfm.unshard_params(tree_unflatten(sharded, got), e_cf, mesh))
    check(local_drop == 0 and ep_drop == 0, f"slots dropped at capacity_factor {cf}: local {local_drop}, EP {ep_drop}")
    rel = rel_errs(got, want, names)
    check(max(rel.values()) <= MESH_GRAD_REL, f"float32 EP gradients vs local at capacity_factor {cf}: {rel}")
    out["float32_grads_vs_local"] = {"layers": EP_F32_LAYERS, "capacity_factor": cf, "Cs": log[0].Cs, "Ce": log[0].Ce,
                                     "max_rel_err": max(rel.values()), "rel_err_by_leaf": rel,
                                     "tolerance_rel": MESH_GRAD_REL}
    del want, got
    # the drop path at the config's capacity factor: each layer's composed EP block (each engine's own tokens of the
    # rows it holds) against the plain per-engine loop on the whole batch
    e125 = dataclasses.replace(f32, moe=dataclasses.replace(m, impl="ep_shardmap"))
    with torch.no_grad(), ep_rows_seen(tuple(range(EP_F32_LAYERS))) as seen:
        tfm.forward(sharded, batches[0]["tokens"], e125, mesh=mesh)
        torch.cuda.synchronize()
    keys = ["router", *moe_lib.EXPERT_KEYS]
    spec = P(seen[0][3] or None, None, None)
    dy = torch.randn((*batches[0]["tokens"].shape, cfg.d_model), device=device,
                     generator=torch.Generator(device=device).manual_seed(seed + 5))
    loop = []
    for li, (lp, h, router, batch) in enumerate(seen):
        w = {k: lp[k].detach().clone().requires_grad_(True) for k in moe_lib.EXPERT_KEYS}
        rw, xi = router.clone().requires_grad_(True), h.clone().requires_grad_(True)
        out_ep, log = ep_logged(lambda: moe_lib.moe_ep_rows(e125.moe, w, xi, rw, batch, mesh))
        g = torch.autograd.grad((out_ep * shard_tensor(dy, spec, mesh)).sum(), [xi, rw, *w.values()])
        g_ep = [unshard_tensor(g[0], spec, mesh), g[1].reshape(rw.shape[-2:]),
                *moe_lib.unshard_experts(m, dict(zip(moe_lib.EXPERT_KEYS, g[2:])), mesh).values()]
        whole = {k: v.detach().clone().requires_grad_(True) for k, v in moe_lib.unshard_experts(m, w, mesh).items()}
        whole["router"] = router.reshape(rw.shape[-2:]).clone().requires_grad_(True)
        xp = unshard_tensor(h, spec, mesh).requires_grad_(True)
        plain, stage1, stage2 = moe_lib.moe_ep_loop_ref(e125.moe, whole, xp, mesh)
        g_plain = torch.autograd.grad((plain * dy).sum(), [xp, *(whole[k] for k in keys)])
        (r,) = log
        same = bool(torch.equal(r.stage1.cpu(), stage1) and torch.equal(r.stage2.cpu(), stage2))
        stats = ep_stats(log, m, ep, dy.shape[0] * dy.shape[1], cfg.d_model, 4)
        rel = rel_errs(g_ep, g_plain, ["input", *keys])
        loop.append({"layer": li, "same_slots": same, "Cs": r.Cs, "Ce": r.Ce, "max_rel_err": max(rel.values()),
                     "rel_err_by_leaf": rel, "stage1_dropped_share": stats["stage1_dropped_share_mean"],
                     "stage2_dropped_share": stats["stage2_dropped_share_mean"]})
        check(same, f"layer {li}: EP and the plain loop keep other slots")
        check(max(rel.values()) <= MESH_GRAD_REL, f"layer {li}: EP gradients vs the plain loop's: {rel}")
    out["float32_layers_grads_vs_plain_loop"] = {"capacity_factor": m.capacity_factor, "layers": loop,
                                                 "inputs": "each layer's MoE input in a float32 forward of the first "
                                                           "batch, every leaf laid out (TP attention, EP experts)",
                                                 "tolerance_rel": MESH_GRAD_REL}
    del params, sharded, seen, w, whole, g_ep, g_plain
    gc.collect()
    torch.cuda.empty_cache()

    # qwen2-moe-a2.7b: the shared expert beside EP, 60 experts padded to 64
    wide = dataclasses.replace(get_arch(MOE_WIDE_ARCH).model_config(), n_layers=EP_QWEN_LAYERS)
    wide = dataclasses.replace(wide, moe=dataclasses.replace(wide.moe, impl="ep_shardmap"))
    q = lm_train_run(wide, token_batches(wide.vocab, EP_QWEN_STEPS), device, seed, mesh)
    q_routes = ep_stats(q["ep_log"], wide.moe, ep, LM_TRAIN_BATCH * LM_TRAIN_SEQ, wide.d_model, 2)
    check(all(np.isfinite(q["losses"])), f"qwen2-moe EP losses {q['losses']}")
    check(q_routes["padded_expert_slots"] == 0, "qwen2-moe: a padded expert got a slot")
    check(q["launches"]["flash_attention"] == 2 * EP_QWEN_LAYERS * EP_QWEN_STEPS, f"qwen2-moe: {q['launches']}")
    out["qwen"] = {"arch": MOE_WIDE_ARCH, "layers": EP_QWEN_LAYERS, "steps": EP_QWEN_STEPS,
                   "cuts": [f"{EP_QWEN_LAYERS} of {get_arch(MOE_WIDE_ARCH).n_layers} layers, as the moe_train phase"],
                   "padded_experts": wide.moe.padded_experts(ep), "padded_expert_slots": 0,
                   **{k: q[k] for k in ("losses", "step_ms", "tokens_per_s", "max_memory_allocated_gb")},
                   "Cs": q_routes["Cs"], "Ce": q_routes["Ce"]}
    return out, {"ep": launches, "qwen": q["launches"]}


def nccl_world_one_train(device: torch.device, seed: int) -> dict:
    """EP (olmoe over EP_F32_LAYERS layers, bf16 activations: one step's
    gradients and updated weights) and dcn-v2's psum_model (PSUM_NCCL_STEPS
    `train_batch` steps: losses and final tables) over the "process_group"
    backend, NCCL at world size 1 on a (1, 1) mesh, against the stacked (1,
    1) mesh under `deterministic_algorithms()`: bit-equal.  The group is
    destroyed after."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.configs.base import RECSYS_SHAPES
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.pipeline import RecsysPipeline, TokenPipeline, to_device
    from repro_torch.graph.distributed import make_mesh
    from repro_torch.kernels.embedding_bag.ops import embedding_bag
    from repro_torch.models import recsys as rec
    from repro_torch.models import transformer as tfm
    from repro_torch.models.sharding import shard_tensor
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.optim import adamw, cosine_schedule
    from repro_torch.train.pytree import tree_leaves

    lm = dataclasses.replace(get_arch(MOE_ARCH).model_config(), n_layers=EP_F32_LAYERS)
    lm = dataclasses.replace(lm, moe=dataclasses.replace(lm.moe, impl="ep_shardmap"))
    tokens = to_device(next(iter(TokenPipeline(lm.vocab, LM_TRAIN_SEQ, LM_TRAIN_BATCH, seed=seed))), device)
    dcn = dataclasses.replace(get_arch(RECSYS_ARCH).model_config(), lookup_impl="psum_model")
    data = iter(RecsysPipeline(dcn.n_dense, dcn.n_sparse, dcn.rows_per_table, RECSYS_SHAPES["train_batch"]["batch"],
                               seed=seed))
    dcn_batches = [to_device(next(data), device) for _ in range(PSUM_NCCL_STEPS)]

    def runs(mesh) -> dict:
        with deterministic_algorithms():
            p = tfm.shard_params(tfm.init_params(lm, seed, device=device), lm, mesh)
            g = train_grads(p, tokens, lm, mesh)
            init, step = make_train_step(lambda q, b: tfm.loss_fn(q, b, lm, mesh=mesh),
                                         adamw(TRAIN_LR, mesh=mesh, sharded=tfm.sharded_specs(lm, mesh)))
            st, _ = step(init(p), tokens)
            ep = {"grads": [t.cpu() for t in g], "params": [t.cpu() for t in tree_leaves(st.params)]}
            del p, g, st
            p = rec.init_params(dcn, seed, device=device)
            spec = rec.param_specs(dcn, mesh)["tables"]
            p["tables"] = shard_tensor(p["tables"], spec, mesh)
            init, step = make_train_step(lambda q, b: rec.loss_fn(q, b, dcn, mesh=mesh),
                                         adamw(cosine_schedule(TRAIN_LR, 10, PSUM_NCCL_STEPS), mesh=mesh,
                                               sharded={("tables",): spec}))
            st, losses = init(p), []
            del p
            embedding_bag.launches = 0
            for b in dcn_batches:
                st, metrics = step(st, b)
                losses.append(float(metrics["loss"]))
            psum = {"losses": losses, "tables": st.params["tables"].cpu(), "launches": embedding_bag.launches}
            del st
        gc.collect()
        torch.cuda.empty_cache()
        return {"ep": ep, "psum": psum}

    want = runs(make_mesh((1, 1), MESH_AXES, device=device))
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store", world_size=1, rank=0)
        try:
            got = runs(make_mesh((1, 1), MESH_AXES, backend="process_group", device=device))
            backend = dist.get_backend()
        finally:
            dist.destroy_process_group()
    r = {"backend": backend, "world_size": 1, "mesh": {a: 1 for a in MESH_AXES},
         "ep_layers": EP_F32_LAYERS, "psum_model_steps": PSUM_NCCL_STEPS, "psum_model_losses": got["psum"]["losses"],
         "ep_grads_and_step_bit_equal_stacked": bool(bit_equal(got["ep"]["grads"], want["ep"]["grads"])
                                                     and bit_equal(got["ep"]["params"], want["ep"]["params"])),
         "psum_model_bit_equal_stacked": bool(got["psum"]["losses"] == want["psum"]["losses"]
                                              and torch.equal(got["psum"]["tables"], want["psum"]["tables"])),
         "embedding_bag_launches": got["psum"]["launches"] + want["psum"]["launches"],
         "deterministic_algorithms": True}
    check(r["ep_grads_and_step_bit_equal_stacked"] and r["psum_model_bit_equal_stacked"],
          f"training over NCCL at world size 1 vs the stacked (1, 1) mesh: {r}")
    check(got["psum"]["launches"] == PSUM_NCCL_STEPS, f"psum_model launched the bag {got['psum']['launches']} "
          f"times in {PSUM_NCCL_STEPS} steps")
    return r


def phase_mesh_train(device: torch.device, graph, perm: np.ndarray, seed: int, smi: str | None,
                     timer: Timer) -> tuple[dict, dict, dict]:
    """Training through the engine mesh's exchanges: (e′) `halo_train`, (f′)
    `ep_train` on MESH_SHAPE, (f″) and EP's check at world size 1,
    `nccl_world_one_train`.  Returns (the `mesh_train` line, each kernel's
    launches in the phase's training runs, the transposed halo reduce's call
    site)."""
    from repro_torch.graph.distributed import make_mesh

    t0 = time.perf_counter()
    halo, halo_launches, site = halo_train(device, graph, perm, seed, timer)
    halo["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    mesh = make_mesh(MESH_SHAPE, MESH_AXES, device=device)
    ep, ep_launches = ep_train(device, seed, mesh)
    ep["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    nccl = nccl_world_one_train(device, seed)
    nccl["seconds"] = time.perf_counter() - t0
    out = {"halo_gin": halo, "olmoe_ep": ep, "nccl": nccl, "card": smi,
           "weights": "random, from a seeded torch.Generator on the card (the moe_train and recsys phases' seeds)",
           "timing": "step ms: the host clock between the ends of consecutive steps (each ends on the loss's read), "
                     "median of all but the first; EP and local in turns, means of two; reduce ms: CUDA-graph "
                     "replays (device time)"}
    say("mesh_train", **out)
    counts = {"segment_spmm": halo_launches, "flash_attention": ep_launches["ep"]["flash_attention"],
              "flash_attention_bwd": ep_launches["ep"]["flash_attention_bwd"],
              "flash_attention_qwen": ep_launches["qwen"]["flash_attention"],
              "flash_attention_bwd_qwen": ep_launches["qwen"]["flash_attention_bwd"],
              "embedding_bag": nccl["embedding_bag_launches"]}
    return out, counts, site


# --------------------------------------------------------------------------- mesh_dense

# (g) Megatron TP and FSDP dense training on MESH_SHAPE (`models.dense_mesh`): llama3.2-3b at its published
# width and depth under both strategies beside the one-device step, in turns (no two training states, ~58 GB
# each, alive at once); float32 gradients of llama3.2-3b and yi-34b over DENSE_F32_LAYERS layers against one
# device's; NCCL at world size 1; the attention kernels at tp_sp's per-engine shape
DENSE_ARCH, DENSE_WIDE_ARCH = "llama3.2-3b", "yi-34b"
DENSE_BATCH, DENSE_STEPS = 16, 10  # 16 rows of the launcher's seq: fsdp's 16-way batch split gives each engine one
DENSE_TURNS = ("one_device", "tp_sp", "fsdp", "one_device")
DENSE_LOSS_RTOL = 5e-3  # the first bf16 loss against one device's: TP adds its 8 model engines' bf16 partials
DENSE_PEAK_GB = 78.0  # above it the phase fails: take fewer layers
DENSE_F32_LAYERS = 2
DENSE_NCCL_LAYERS = 2


def dense_train(device: torch.device, seed: int, mesh) -> tuple[dict, dict]:
    """(g): llama3.2-3b at its published width and depth trained
    DENSE_STEPS steps (batch DENSE_BATCH × 128) under tp_sp and fsdp on
    `mesh` and on one device, on the same weights and batches, in turns
    (DENSE_TURNS); losses finite and falling, the first within
    DENSE_LOSS_RTOL of one device's; step ms, tokens/s, peak, attention
    launches a step and the collectives' bytes.  Returns (the entry, the
    tp_sp run's kernel launches)."""
    import itertools

    from repro_torch.configs.registry import get_arch
    from repro_torch.data.pipeline import TokenPipeline, to_device
    from repro_torch.models.sharding import MeshRules

    cfg = get_arch(DENSE_ARCH).model_config()
    L = cfg.n_layers
    data = TokenPipeline(cfg.vocab, LM_TRAIN_SEQ, DENSE_BATCH, seed=seed)
    batches = [to_device(b, device) for b in itertools.islice(data, DENSE_STEPS)]
    runs = {name: [] for name in DENSE_TURNS}
    for name in DENSE_TURNS:
        on_mesh = name != "one_device"
        c = dataclasses.replace(cfg, rules=MeshRules(strategy=name)) if on_mesh else cfg
        r = lm_train_run(c, batches, device, seed, mesh if on_mesh else None)
        check(all(np.isfinite(r["losses"])) and r["losses"][-1] < r["losses"][0], f"llama {name}: {r['losses']}")
        check(r["launches"]["flash_attention"] == 2 * L * DENSE_STEPS
              and r["launches"]["flash_attention_bwd"] == L * DENSE_STEPS, f"llama {name}: launches {r['launches']}")
        check(r["max_memory_allocated_gb"] <= DENSE_PEAK_GB,
              f"llama {name}: peak {r['max_memory_allocated_gb']} GB at {L} layers: take fewer")
        runs[name].append(r)
    one = runs["one_device"][0]["losses"][0]
    out = {"arch": DENSE_ARCH, "layers": L, "steps": DENSE_STEPS, "batch": DENSE_BATCH, "seq": LM_TRAIN_SEQ,
           "mesh": dict(mesh.shape), "engines": mesh.num_engines, "turns": list(DENSE_TURNS),
           "losses": {k: v[0]["losses"] for k, v in runs.items()},
           "first_loss_rel_err_vs_one_device": {k: abs(runs[k][0]["losses"][0] - one) / one for k in ("tp_sp", "fsdp")},
           "one_device_runs_losses_bit_equal": runs["one_device"][0]["losses"] == runs["one_device"][1]["losses"],
           "step_ms": {k: float(np.mean([r["step_ms"] for r in v])) for k, v in runs.items()},
           "tokens_per_s": {k: float(np.mean([r["tokens_per_s"] for r in v])) for k, v in runs.items()},
           "max_memory_allocated_gb": {k: max(r["max_memory_allocated_gb"] for r in v) for k, v in runs.items()},
           "runs": {k: [{f: r[f] for f in ("step_ms", "tokens_per_s", "max_memory_allocated_gb")} for r in v]
                    for k, v in runs.items()},
           "flash_attention_launches_a_step": {k: v[0]["launches"]["flash_attention"] / DENSE_STEPS
                                               for k, v in runs.items()},
           "flash_attention_bwd_launches_a_step": {k: v[0]["launches"]["flash_attention_bwd"] / DENSE_STEPS
                                                   for k, v in runs.items()},
           "bytes_a_step": {k: dense_step_bytes(dataclasses.replace(cfg, rules=MeshRules(strategy=k)), mesh,
                                                DENSE_BATCH, LM_TRAIN_SEQ) for k in ("tp_sp", "fsdp")},
           "tolerance": {"first_loss_rel": DENSE_LOSS_RTOL}, "peak_limit_gb": DENSE_PEAK_GB}
    for k in ("tp_sp", "fsdp"):
        out[f"{k}_vs_one_device_step_ms"] = out["step_ms"][k] / out["step_ms"]["one_device"]
        check(out["first_loss_rel_err_vs_one_device"][k] <= DENSE_LOSS_RTOL,
              f"llama {k}: first loss vs one device {out['first_loss_rel_err_vs_one_device'][k]}")
    return out, dict(runs["tp_sp"][0]["launches"])


def dense_grads(arch: str, device: torch.device, seed: int, mesh) -> dict:
    """`arch` at its published width over DENSE_F32_LAYERS layers in float32:
    one device's gradients of one batch (DENSE_BATCH × 128), then under each
    strategy on `mesh` the laid-out tree's gradients twice (bit-equal), put
    back whole and held within MESH_GRAD_REL of the largest entry of one
    device's, and one AdamW step that leaves every leaf in its layout (in
    place)."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.pipeline import TokenPipeline, to_device
    from repro_torch.models import transformer as tfm
    from repro_torch.models.sharding import MeshRules, unshard_tensor
    from repro_torch.train.optim import adamw
    from repro_torch.train.pytree import tree_leaves, tree_leaves_with_path, tree_unflatten

    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls in the float32 gradient check")
    cfg = dataclasses.replace(get_arch(arch).model_config(), n_layers=DENSE_F32_LAYERS, dtype=torch.float32)
    batch = to_device(next(iter(TokenPipeline(cfg.vocab, LM_TRAIN_SEQ, DENSE_BATCH, seed=seed))), device)
    params = tfm.init_params(cfg, seed, device=device)
    paths = [p for p, _ in tree_leaves_with_path(params)]
    names = ["/".join(map(str, p)) for p in paths]
    torch.cuda.reset_peak_memory_stats()
    want = train_grads(params, batch, cfg)
    out = {"arch": arch, "layers": DENSE_F32_LAYERS, "d_model": cfg.d_model, "n_heads": cfg.n_heads,
           "n_kv_heads": cfg.n_kv_heads, "d_ff": cfg.d_ff, "vocab": cfg.vocab, "batch": DENSE_BATCH,
           "seq": LM_TRAIN_SEQ, "params": sum(t.numel() for t in want), "tolerance_rel": MESH_GRAD_REL}
    for strategy in ("tp_sp", "fsdp"):
        c = dataclasses.replace(cfg, rules=MeshRules(strategy=strategy))
        specs = tfm.sharded_specs(c, mesh)
        laid = tfm.shard_params(params, c, mesh)
        got = train_grads(laid, batch, c, mesh)
        again = train_grads(laid, batch, c, mesh)
        same = bit_equal(got, again)
        del again
        rel = {n: float((unshard_tensor(g, specs[p], mesh) - w).abs().max()) / (float(w.abs().max()) + 1e-30)
               for n, p, g, w in zip(names, paths, got, want)}
        before = [(t.shape, t.data_ptr()) for t in tree_leaves(laid)]
        opt = adamw(TRAIN_LR, mesh=mesh, sharded=specs)
        opt.update(tree_unflatten(laid, got), opt.init(laid), laid, 0)
        kept = [(t.shape, t.data_ptr()) for t in tree_leaves(laid)] == before
        torch.cuda.synchronize()
        out[strategy] = {"max_rel_err": max(rel.values()), "rel_err_by_leaf": rel, "grads_bit_equal_two_runs": same,
                         "adamw_step_keeps_layout": kept,
                         "laid_out": {n: list(t.shape) for n, t in zip(names, tree_leaves(laid))
                                      if n in ("embed", "layers/wq", "layers/w_gate", "layers/w_down")}}
        check(same, f"{arch} {strategy}: two gradients of one state differ")
        check(kept, f"{arch} {strategy}: the AdamW step moved a leaf out of its layout")
        check(max(rel.values()) <= MESH_GRAD_REL, f"{arch} {strategy}: float32 gradients vs one device: {rel}")
        del laid, got
        gc.collect()
        torch.cuda.empty_cache()
    out["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del params, want
    gc.collect()
    torch.cuda.empty_cache()
    return out


def nccl_world_one_dense(device: torch.device, seed: int) -> dict:
    """llama3.2-3b over DENSE_NCCL_LAYERS layers (bf16 activations), under
    each strategy: one step's gradients and updated weights over the
    "process_group" backend, NCCL at world size 1 on a (1, 1) mesh, against
    the stacked (1, 1) mesh under `deterministic_algorithms()`: bit-equal."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.configs.registry import get_arch
    from repro_torch.data.pipeline import TokenPipeline, to_device
    from repro_torch.graph.distributed import make_mesh
    from repro_torch.models import transformer as tfm
    from repro_torch.models.sharding import MeshRules
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.optim import adamw
    from repro_torch.train.pytree import tree_leaves

    cfg = dataclasses.replace(get_arch(DENSE_ARCH).model_config(), n_layers=DENSE_NCCL_LAYERS)
    batch = to_device(next(iter(TokenPipeline(cfg.vocab, LM_TRAIN_SEQ, DENSE_BATCH, seed=seed))), device)

    def runs(mesh, want: dict | None = None) -> dict:
        """Each strategy's (gradients, updated weights, loss), kept on the
        card; against `want`, whether they are bit-equal to it."""
        out = {}
        with deterministic_algorithms():
            for strategy in ("tp_sp", "fsdp"):
                c = dataclasses.replace(cfg, rules=MeshRules(strategy=strategy))
                p = tfm.shard_params(tfm.init_params(c, seed, device=device), c, mesh)
                g = train_grads(p, batch, c, mesh)
                init, step = make_train_step(lambda q, b: tfm.loss_fn(q, b, c, mesh=mesh),
                                             adamw(TRAIN_LR, mesh=mesh, sharded=tfm.sharded_specs(c, mesh)))
                st, metrics = step(init(p), batch)
                got = (g, tuple(tree_leaves(st.params)), float(metrics["loss"]))
                if want is None:
                    out[strategy] = got
                else:
                    w = want.pop(strategy)
                    out[strategy] = bool(bit_equal(got[0], w[0]) and bit_equal(got[1], w[1]) and got[2] == w[2])
                del p, g, st, got
        gc.collect()
        torch.cuda.empty_cache()
        return out

    want = runs(make_mesh((1, 1), MESH_AXES, device=device))
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store", world_size=1, rank=0)
        try:
            same = runs(make_mesh((1, 1), MESH_AXES, backend="process_group", device=device), want)
            backend = dist.get_backend()
        finally:
            dist.destroy_process_group()
    r = {"backend": backend, "world_size": 1, "mesh": {a: 1 for a in MESH_AXES}, "layers": DENSE_NCCL_LAYERS,
         "deterministic_algorithms": True,
         **{f"{k}_grads_and_step_bit_equal_stacked": v for k, v in same.items()}}
    check(r["tp_sp_grads_and_step_bit_equal_stacked"] and r["fsdp_grads_and_step_bit_equal_stacked"],
          f"dense training over NCCL at world size 1 vs the stacked (1, 1) mesh: {r}")
    return r


def dense_attention(device: torch.device, timer: Timer, mesh) -> dict:
    """`flash_attention` and its backward at llama3.2-3b's tp_sp per-engine
    shape on `mesh` (every engine's rows and heads folded into the kernel's
    batch: q (DENSE_BATCH / data × model × rows, 128, 24 / model, 128), k/v
    with 8 / model heads), bf16, causal (`attention_train_site`)."""
    from repro_torch.configs.registry import get_arch

    cfg = get_arch(DENSE_ARCH).model_config()
    tp = mesh.shape["model"]
    b = DENSE_BATCH * tp  # (data rows × model engines × the data row's batch), folded
    return attention_train_site(device, timer, (b, LM_TRAIN_SEQ, cfg.n_heads // tp, cfg.n_kv_heads // tp,
                                                cfg.head_dim), 11, "the tp_sp shape")


def attention_train_site(device: torch.device, timer: Timer, shape: tuple, seed: int, what: str) -> dict:
    """`flash_attention` and its backward on random bf16 q (B, S, Hq, dh), k/v
    (B, S, Hkv, dh) of `shape` = (B, S, Hq, Hkv, dh), causal: against the
    plain versions, the bounds and `scaled_dot_product_attention` (forward,
    and its backward)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.kernels.flash_attention.ops import flash_attention_bwd
    from repro_torch.kernels.flash_attention.ref import flash_attention_bwd_ref, flash_attention_ref

    b, s, hq, hkv, dh = shape
    gen = torch.Generator(device=device).manual_seed(seed)
    q, k, v = (torch.randn((b, s, h, dh), generator=gen, device=device).to(torch.bfloat16) for h in (hq, hkv, hkv))
    do = torch.randn((b, s, hq, dh), generator=gen, device=device).to(torch.bfloat16)
    forward = attention_forward_site(q, k, v, timer)
    o, lse = flash_attention_cuda(q, k, v, causal=True, with_lse=True)
    o_ref, lse_ref = flash_attention_ref(q, k, v, causal=True, return_lse=True)
    grads = flash_attention_bwd(q, k, v, o, do, lse, causal=True)
    plain = flash_attention_bwd_ref(q, k, v, o_ref, do, lse_ref, causal=True)
    torch.cuda.synchronize()
    bwd_rel = max(float((a.float() - w.float()).abs().max()) / (float(w.float().abs().max()) + 1e-6)
                  for a, w in zip(grads, plain))
    check(bwd_rel <= BWD_REL["bf16"], f"attention backward at {what} vs plain: {bwd_rel}")
    del plain
    # a yardstick, used nowhere in the port: the library's backward in its own layout
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(True) for t in (q, k, v))
    lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
    dot = do.transpose(1, 2).contiguous()
    bbound, bby = attention_bwd_bound_ms(q, k, True, 0)
    out = {"q": list(q.shape), "k": list(k.shape), "dtype": "bfloat16", "causal": True, "forward": forward,
           "backward": {"ms": timer.device_ms(lambda: flash_attention_bwd(q, k, v, o, do, lse, causal=True),
                                              calls=5, reps=10),
                        "call_ms": timer.call_ms(lambda: flash_attention_bwd(q, k, v, o, do, lse, causal=True),
                                                 calls=5, reps=10),
                        "plain_ms": timer.call_ms(lambda: flash_attention_bwd_ref(q, k, v, o_ref, do, lse_ref,
                                                                                  causal=True), calls=2, reps=3),
                        "bound_ms": bbound, "bound_by": bby,
                        "library_ms": timer.call_ms(lambda: torch.autograd.grad(lib_out, (qt, kt, vt), dot,
                                                                                retain_graph=True), calls=5, reps=10),
                        "max_rel_err": bwd_rel},
           "timing": "ms: device time replayed from a CUDA graph; call_ms, plain_ms (flash_attention_ref, "
                     "flash_attention_bwd_ref), library_ms (scaled_dot_product_attention(is_causal, enable_gqa) on "
                     "(B, H, S, dh) copies; its backward by torch.autograd.grad): calls enqueued back to back"}
    del q, k, v, o, do, lse, o_ref, lse_ref, qt, kt, vt, lib_out, dot, grads
    torch.cuda.empty_cache()
    return out


def phase_mesh_dense(device: torch.device, seed: int, smi: str | None, timer: Timer) -> tuple[dict, dict]:
    """(g) Megatron TP and FSDP dense training on MESH_SHAPE: `dense_train`,
    `dense_grads` for llama3.2-3b and yi-34b, `nccl_world_one_dense`,
    `dense_attention`.  Returns (the `mesh_dense` line, the tp_sp training
    run's kernel launches)."""
    from repro_torch.graph.distributed import make_mesh

    mesh = make_mesh(MESH_SHAPE, MESH_AXES, device=device)
    t0 = time.perf_counter()
    train, launches = dense_train(device, seed, mesh)
    train["seconds"] = time.perf_counter() - t0
    print(f"mesh_dense: llama trained, step ms {train['step_ms']}", file=sys.stderr, flush=True)
    grads = {}
    for arch in (DENSE_ARCH, DENSE_WIDE_ARCH):
        t0 = time.perf_counter()
        grads[arch] = dense_grads(arch, device, seed, mesh)
        grads[arch]["seconds"] = time.perf_counter() - t0
        print(f"mesh_dense: {arch} float32 gradients held", file=sys.stderr, flush=True)
    t0 = time.perf_counter()
    nccl = nccl_world_one_dense(device, seed)
    nccl["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    attn = dense_attention(device, timer, mesh)
    attn["seconds"] = time.perf_counter() - t0
    out = {"llama": train, "float32_grads_vs_one_device": grads, "nccl": nccl, "attention_tp_shape": attn,
           "card": smi, "weights": "random, from a seeded torch.Generator on the card (the train phase's seed)",
           "timing": "step ms: the host clock between the ends of consecutive steps (each ends on the loss's "
                     "read), median of all but the first; the routes in turns, one device's a mean of two"}
    say("mesh_dense", **out)
    return out, launches


# (h) serving the dense transformer under Megatron TP on MESH_SHAPE (`models.dense_mesh.prefill` / `decode`
# over a KV cache laid out by `kv_cache_specs`): llama3.2-3b at its published width and depth drained through
# `build_engine(..., mesh=)` under tp_sp beside one device, in turns, on the same bf16 weights and the serve
# phase's traffic; float32 logits under tp_sp and fsdp against one device's; NCCL at world size 1; the
# attention kernel at tp_sp's per-engine prefill shape
SERVE_TP_TURNS = ("one_device", "tp_sp", "tp_sp", "one_device")
SERVE_F32_ROWS, SERVE_F32_PROMPT, SERVE_F32_MAX_SEQ, SERVE_F32_STEPS = 16, (384, 513), 576, 8  # 16 rows: fsdp's 16
SERVE_NCCL_LAYERS, SERVE_NCCL_ROWS, SERVE_NCCL_PROMPT, SERVE_NCCL_STEPS = 2, 4, 64, 4
TP_PREFILL_S = 2048


def serve_turn(cfg, params: dict, prompts: list, device: torch.device, mesh=None, *, new_tokens: int = SERVE_NEW,
               routes: bool = False, slots: int = SERVE_SLOTS) -> tuple[dict, dict]:
    """One drain of `prompts` through `build_engine` (`slots` slots,
    SERVE_MAX_SEQ positions, `new_tokens` new tokens), after a warm-up
    prefill and decode step: (the turn's numbers, with `routes` an MoE
    model's dropped share of routed slots, {uid: tokens})."""
    from repro_torch.launch.serve import build_engine

    engine = build_engine(cfg, params, slots=slots, max_seq=SERVE_MAX_SEQ, device=device, mesh=mesh)
    engine.cache, _ = engine.prefill_one(engine.cache, 0, torch.from_numpy(prompts[0][None, :256].astype(np.int64)))
    _, engine.cache = engine.decode(engine.cache, torch.zeros((slots, 1), dtype=torch.long),
                                    torch.zeros(slots, dtype=torch.long))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    logs = {"prefill": [], "decode": []} if routes else None
    done, st, wall_s, launches = drain_timed(engine, prompts, new_tokens, logs)
    out = {"wall_s": wall_s, "prefill_tokens": st["prefill_tokens"], "prefill_tok_s": st["prefill_tokens"] / st["prefill_s"],
           "decode_steps": st["decode_steps"], "decode_ms_a_step": st["decode_s"] / st["decode_steps"] * 1e3,
           "decode_tok_s": st["decode_tokens"] / st["decode_s"], "flash_attention_launches": launches,
           "finite": st["finite"], "requests_drained": len(done),
           "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
           "kv_cache_shape": list(engine.cache["k"].shape)}
    if routes:
        out["dropped_share"] = dropped_share(logs["prefill"] + logs["decode"])
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return out, {r.uid: list(r.out_tokens) for r in done}


def dense_serve_drain(device: torch.device, seed: int, mesh) -> tuple[dict, int]:
    """llama3.2-3b at its published width and depth served through
    `build_engine` under tp_sp on `mesh` and on one device, in turns
    (SERVE_TP_TURNS), on the same bf16 weights and the serve phase's
    traffic: every request drained, logits finite, one attention launch a
    layer a prefill; tokens/s, decode ms, peak, the bytes a prefill and a
    decode step move, the share of served tokens equal to one device's and
    each request's tokens in common with one device's before the first
    that differs (a token that differs changes every later one's context).
    Returns (the entry, the first tp_sp turn's attention launches)."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import transformer as tfm
    from repro_torch.models.sharding import MeshRules

    cfg = get_arch(SERVE_ARCH).model_config()
    tp_cfg = dataclasses.replace(cfg, rules=MeshRules(strategy="tp_sp"))
    L = cfg.n_layers
    t0 = time.perf_counter()
    params = tfm.cast_params(tfm.init_params(cfg, seed, device=device), cfg)  # the serve phase's bf16 weights
    laid = tfm.shard_params(params, tp_cfg, mesh)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed)
    lengths = rng.integers(*SERVE_PROMPT, size=SERVE_REQUESTS)
    prompts = [rng.integers(2, cfg.vocab, size=int(n)).astype(np.int32) for n in lengths]
    runs, tokens = {"one_device": [], "tp_sp": []}, {}
    for name in SERVE_TP_TURNS:
        on_mesh = name == "tp_sp"
        r, toks = serve_turn(tp_cfg if on_mesh else cfg, laid if on_mesh else params, prompts, device,
                             mesh if on_mesh else None)
        check(r["requests_drained"] == SERVE_REQUESTS and r["finite"], f"llama {name}: {r}")
        check(r["flash_attention_launches"] == L * SERVE_REQUESTS,
              f"llama {name}: flash_attention launched {r['flash_attention_launches']} times, want {L} a prefill × "
              f"{SERVE_REQUESTS}")
        runs[name].append(r)
        tokens.setdefault(name, toks)
    one, tp = tokens["one_device"], tokens["tp_sp"]
    equal = sum(a == b for u in one for a, b in zip(one[u], tp[u]))
    total = sum(len(t) for t in one.values())
    prefix = [next((i for i, (a, b) in enumerate(zip(one[u], tp[u])) if a != b), len(one[u])) for u in sorted(one)]
    out = {"arch": SERVE_ARCH, "layers": L, "mesh": dict(mesh.shape), "engines": mesh.num_engines,
           "strategy": "tp_sp", "activations": "bfloat16", "kv_cache": "float32", "slots": SERVE_SLOTS,
           "max_seq": SERVE_MAX_SEQ, "requests": SERVE_REQUESTS, "prompt_lengths": [int(x) for x in lengths],
           "max_new_tokens": SERVE_NEW, "setup_s": setup_s, "turns": list(SERVE_TP_TURNS), "runs": runs,
           "prefill_tok_s": {k: float(np.mean([r["prefill_tok_s"] for r in v])) for k, v in runs.items()},
           "decode_ms_a_step": {k: float(np.mean([r["decode_ms_a_step"] for r in v])) for k, v in runs.items()},
           "max_memory_allocated_gb": {k: max(r["max_memory_allocated_gb"] for r in v) for k, v in runs.items()},
           "flash_attention_launches_a_drain": {k: v[0]["flash_attention_launches"] for k, v in runs.items()},
           "served_tokens_equal_one_device_share": equal / total, "served_tokens": total,
           "served_tokens_common_prefix_by_request": prefix,
           "bytes": {"prefill_2048_one_slot": dense_serve_bytes(tp_cfg, mesh, 1, TP_PREFILL_S, False),
                     "decode_step": dense_serve_bytes(tp_cfg, mesh, SERVE_SLOTS, 1, True)}}
    out["tp_sp_vs_one_device_prefill_tok_s"] = out["prefill_tok_s"]["tp_sp"] / out["prefill_tok_s"]["one_device"]
    out["tp_sp_vs_one_device_decode_ms"] = out["decode_ms_a_step"]["tp_sp"] / out["decode_ms_a_step"]["one_device"]
    del params, laid
    gc.collect()
    torch.cuda.empty_cache()
    return out, runs["tp_sp"][0]["flash_attention_launches"]


def dense_serve_f32(device: torch.device, seed: int, mesh) -> dict:
    """llama3.2-3b at its published width and depth in float32 (weights and
    activations): SERVE_F32_ROWS one-slot prefills of their own lengths into
    a cache of as many slots and SERVE_F32_MAX_SEQ positions, then
    SERVE_F32_STEPS `decode_step_batched_pos` steps with every row at its
    own position, on one device and under tp_sp and fsdp on `mesh` (each
    twice: bit-equal); every logit and the unsharded cache within MODEL_TOL
    of one device's."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import transformer as tfm
    from repro_torch.models.sharding import MeshRules

    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls in the float32 serving check")
    cfg = dataclasses.replace(get_arch(SERVE_ARCH).model_config(), dtype=torch.float32)
    rng = np.random.default_rng(seed + 1)
    lengths = rng.integers(*SERVE_F32_PROMPT, size=SERVE_F32_ROWS)
    prompts = [torch.from_numpy(rng.integers(2, cfg.vocab, size=(1, int(n)))).to(device) for n in lengths]
    steps = [torch.from_numpy(rng.integers(2, cfg.vocab, size=(SERVE_F32_ROWS, 1))).to(device)
             for _ in range(SERVE_F32_STEPS)]
    pos0 = torch.from_numpy(lengths.astype(np.int64)).to(device)
    params = tfm.init_params(cfg, seed, device=device)
    torch.cuda.reset_peak_memory_stats()

    def run(c, p, m) -> dict:
        cache = tfm.init_kv_cache(c, SERVE_F32_ROWS, SERVE_F32_MAX_SEQ, torch.float32, device=device, mesh=m)
        pre = torch.cat([tfm.prefill(p, t, cache, c, mesh=m, slot=i)[0] for i, t in enumerate(prompts)])
        dec = [tfm.decode_step_batched_pos(p, cache, pos0 + i, t, c, mesh=m)[0] for i, t in enumerate(steps)]
        torch.cuda.synchronize()
        return {"prefill": pre, "decode": dec, "cache": tfm.unshard_kv_cache(cache, c, m)}

    def diff(a, b) -> float:
        return float((a - b).abs().max())

    with torch.no_grad():
        want = run(cfg, params, None)
        out = {"arch": SERVE_ARCH, "layers": cfg.n_layers, "dtype": "float32", "mesh": dict(mesh.shape),
               "rows": SERVE_F32_ROWS, "prompt_lengths": [int(x) for x in lengths], "max_seq": SERVE_F32_MAX_SEQ,
               "decode_steps": SERVE_F32_STEPS, "tolerance": MODEL_TOL,
               "logits_max_abs": float(want["prefill"].abs().max()), "cache_max_abs": float(want["cache"]["k"].abs().max())}
        for strategy in ("tp_sp", "fsdp"):
            c = dataclasses.replace(cfg, rules=MeshRules(strategy=strategy))
            laid = tfm.shard_params(params, c, mesh)
            got, again = run(c, laid, mesh), run(c, laid, mesh)
            same = (torch.equal(got["prefill"], again["prefill"]) and all(map(torch.equal, got["decode"], again["decode"]))
                    and all(torch.equal(got["cache"][k], again["cache"][k]) for k in ("k", "v")))
            del again, laid
            close = (torch.allclose(got["prefill"], want["prefill"], **MODEL_TOL)
                     and all(torch.allclose(a, b, **MODEL_TOL) for a, b in zip(got["decode"], want["decode"]))
                     and all(torch.allclose(got["cache"][k], want["cache"][k], **MODEL_TOL) for k in ("k", "v")))
            greedy = [torch.equal(a.argmax(-1), b.argmax(-1)) for a, b in zip([got["prefill"], *got["decode"]],
                                                                                [want["prefill"], *want["decode"]])]
            out[strategy] = {"prefill_max_abs_err": diff(got["prefill"], want["prefill"]),
                             "decode_max_abs_err_by_step": [diff(a, b) for a, b in zip(got["decode"], want["decode"])],
                             "cache_max_abs_err": max(diff(got["cache"][k], want["cache"][k]) for k in ("k", "v")),
                             "greedy_tokens_equal_prefill_then_steps": greedy, "within_tolerance": close,
                             "two_runs_bit_equal": same}
            del got
            gc.collect()
            torch.cuda.empty_cache()
            check(same, f"float32 serving under {strategy}: two runs differ")
            check(close, f"float32 serving under {strategy} vs one device: {out[strategy]}")
    out["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del params, want
    gc.collect()
    torch.cuda.empty_cache()
    return out


def nccl_world_one_serve(device: torch.device, seed: int, *, moe: bool = False,
                         strategies: tuple = ("tp_sp", "fsdp")) -> dict:
    """llama3.2-3b over SERVE_NCCL_LAYERS layers (bf16 activations), under
    each of `strategies` (with `moe`: olmoe-1b-7b with EP): a prefill
    of SERVE_NCCL_ROWS rows and SERVE_NCCL_STEPS decode steps over the
    "process_group" backend, NCCL at world size 1 on a (1, 1) mesh, against
    the stacked (1, 1) mesh under `deterministic_algorithms()`: logits and
    cache bit-equal."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.configs.registry import get_arch
    from repro_torch.graph.distributed import make_mesh
    from repro_torch.models import transformer as tfm
    from repro_torch.models.sharding import MeshRules

    cfg = dataclasses.replace(get_arch(MOE_ARCH if moe else SERVE_ARCH).model_config(), n_layers=SERVE_NCCL_LAYERS)
    if moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, impl="ep_shardmap"))
    rng = np.random.default_rng(seed + 2)
    prompt = torch.from_numpy(rng.integers(2, cfg.vocab, (SERVE_NCCL_ROWS, SERVE_NCCL_PROMPT))).to(device)
    steps = [torch.from_numpy(rng.integers(2, cfg.vocab, (SERVE_NCCL_ROWS, 1))).to(device)
             for _ in range(SERVE_NCCL_STEPS)]
    pos0 = torch.from_numpy(SERVE_NCCL_PROMPT + rng.integers(0, 4, SERVE_NCCL_ROWS)).to(device)
    params = tfm.cast_params(tfm.init_params(cfg, seed, device=device), cfg)

    def runs(mesh, want: dict | None = None) -> dict:
        out = {}
        with deterministic_algorithms(), torch.no_grad():
            for strategy in strategies:
                c = dataclasses.replace(cfg, rules=MeshRules(strategy=strategy))
                p = tfm.shard_params(params, c, mesh)
                cache = tfm.init_kv_cache(c, SERVE_NCCL_ROWS, SERVE_NCCL_PROMPT + 16, torch.float32, device=device,
                                          mesh=mesh)
                got = [tfm.prefill(p, prompt, cache, c, mesh=mesh)[0]]
                got += [tfm.decode_step_batched_pos(p, cache, pos0 + i, t, c, mesh=mesh)[0] for i, t in enumerate(steps)]
                got += [cache["k"], cache["v"]]
                out[strategy] = got if want is None else all(map(torch.equal, got, want.pop(strategy)))
        return out

    want = runs(make_mesh((1, 1), MESH_AXES, device=device))
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store", world_size=1, rank=0)
        try:
            same = runs(make_mesh((1, 1), MESH_AXES, backend="process_group", device=device), want)
            backend = dist.get_backend()
        finally:
            dist.destroy_process_group()
    del params
    gc.collect()
    torch.cuda.empty_cache()
    r = {"backend": backend, "world_size": 1, "mesh": {a: 1 for a in MESH_AXES}, "arch": cfg.name,
         "layers": SERVE_NCCL_LAYERS, "rows": SERVE_NCCL_ROWS, "prompt": SERVE_NCCL_PROMPT,
         "decode_steps": SERVE_NCCL_STEPS,
         "deterministic_algorithms": True, **{f"{k}_logits_and_cache_bit_equal_stacked": v for k, v in same.items()}}
    check(all(same.values()), f"{cfg.name} served over NCCL at world size 1 vs the stacked (1, 1) mesh: {r}")
    return r


def attention_forward_site(q, k, v, timer: Timer) -> dict:
    """`flash_attention` (causal) on q, k, v against its plain version (within
    BF16_TOL), timed beside the plain version, its bound and
    `scaled_dot_product_attention` (a yardstick, used nowhere in the port)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    o, o_ref = flash_attention(q, k, v, causal=True), flash_attention_ref(q, k, v, causal=True)
    torch.cuda.synchronize()
    err = float((o.float() - o_ref.float()).abs().max())
    check(torch.allclose(o.float(), o_ref.float(), **BF16_TOL), f"attention at {tuple(q.shape)} vs plain: {err}")
    del o, o_ref
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    bound, by = attention_bound_ms(q, k, True, 0)
    return {"q": list(q.shape), "k": list(k.shape), "dtype": str(q.dtype).removeprefix("torch."), "causal": True,
            "ms": timer.device_ms(lambda: flash_attention(q, k, v, causal=True)),
            "call_ms": timer.call_ms(lambda: flash_attention(q, k, v, causal=True)),
            "plain_ms": timer.call_ms(lambda: flash_attention_ref(q, k, v, causal=True), calls=2, reps=3),
            "bound_ms": bound, "bound_by": by,
            "library_ms": timer.call_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                                               enable_gqa=True)),
            "max_abs_err": err}


def dense_serve_attention(device: torch.device, timer: Timer, mesh) -> dict:
    """`flash_attention` at llama3.2-3b's tp_sp per-engine prefill shape on
    `mesh`: one slot's TP_PREFILL_S-token prompt, held once along "data", the
    model engines' 24 / model query and 8 / model kv heads folded into the
    batch (q (model, S, 3, 128)), and with both data engines' copies
    folded (q (data × model, S, 3, 128), a "process_group" row's work summed),
    bf16, causal."""
    from repro_torch.configs.registry import get_arch

    cfg = get_arch(SERVE_ARCH).model_config()
    tp = mesh.shape["model"]
    hq, hkv, dh = cfg.n_heads // tp, cfg.n_kv_heads // tp, cfg.head_dim
    gen = torch.Generator(device=device).manual_seed(13)
    out = {}
    for name, b in (("path", tp), ("both_data_engines", mesh.num_engines)):
        q, k, v = (torch.randn((b, TP_PREFILL_S, h, dh), generator=gen, device=device).to(torch.bfloat16)
                   for h in (hq, hkv, hkv))
        out[name] = attention_forward_site(q, k, v, timer)
        del q, k, v
    torch.cuda.empty_cache()
    out["timing"] = ("ms: device time replayed from a CUDA graph; call_ms, plain_ms (flash_attention_ref), library_ms "
                     "(scaled_dot_product_attention(is_causal, enable_gqa) on (B, H, S, dh) copies): calls enqueued "
                     "back to back")
    return out


def phase_mesh_dense_serve(device: torch.device, seed: int, smi: str | None, timer: Timer) -> tuple[dict, int]:
    """(h) Megatron TP serving on MESH_SHAPE: `dense_serve_drain`,
    `dense_serve_f32`, `nccl_world_one_serve`, `dense_serve_attention`.
    Returns (the `mesh_dense_serve` line, the tp_sp drain's attention
    launches)."""
    from repro_torch.graph.distributed import make_mesh

    mesh = make_mesh(MESH_SHAPE, MESH_AXES, device=device)
    parts = {}
    for name, fn in (("llama", lambda: dense_serve_drain(device, seed, mesh)),
                     ("float32_vs_one_device", lambda: dense_serve_f32(device, seed, mesh)),
                     ("nccl", lambda: nccl_world_one_serve(device, seed)),
                     ("attention_tp_prefill_shape", lambda: dense_serve_attention(device, timer, mesh))):
        t0 = time.perf_counter()
        parts[name] = fn()
        print(f"mesh_dense_serve: {name} done", file=sys.stderr, flush=True)
        if name == "llama":
            parts[name], launches = parts[name]
        parts[name]["seconds"] = time.perf_counter() - t0
    out = {**parts, "card": smi,
           "weights": "random, from a seeded torch.Generator on the card (the serve phase's seed)",
           "timing": "host clock around each prefill / decode call, synchronised on both sides; the routes in "
                     "turns, each a mean of two"}
    say("mesh_dense_serve", **out)
    return out, launches


# --------------------------------------------------------------------------- mesh_moe_serve

# (i) serving the MoE transformer on MESH_SHAPE under tp_sp, Megatron TP attention and expert-parallel experts in
# one layer (`models.dense_mesh` with `_moe_ffn` over `moe.moe_ep_rows`, the KV cache laid out by
# `kv_cache_specs`): olmoe-1b-7b at its published width and depth and qwen2-moe-a2.7b over MOE_WIDE_LAYERS layers
# drained through `build_engine(..., mesh=)` beside one device's impl="local" engine, in turns, on the same bf16
# weights and the serve phase's traffic; float32 logits and cache at capacity factor E/k against one device's; the
# drop path at the config's capacity factor against the plain per-engine loop; NCCL at world size 1; the attention
# kernel at the per-engine prefill shape
MOE_TP_TURNS = ("local", "tp_ep", "tp_ep", "local")  # "tp_ep": the mesh's route, named by MOE_ROUTE
MOE_ROUTE = {"tp_sp": "tp_ep", "fsdp": "fsdp_ep"}
MOE_F32_LAYERS = 16  # olmoe's float32 weights laid out beside one device's copy: 2 × 27 GB, with the caches
MOE_DROP_PROMPT = 2047  # a one-slot prompt that 16 engines do not divide: the reference's flat layout, padded


def dropped_share(calls: list) -> float:
    """The share of routed slots dropped over `drain_timed`'s route logs
    (each call's routings: (C, counts) of the local path, or an `EpRoute`,
    both stages)."""
    slots = dropped = 0
    for call in calls:
        for r in call:
            if isinstance(r, tuple):
                C, c = r
                slots += int(c.sum())
                dropped += int((c - C).clamp_min(0).sum())
            else:
                slots += int(r.stage1.sum())
                dropped += int((r.stage1 - r.Cs).clamp_min(0).sum()) + int((r.stage2[:, :-1] - r.Ce).clamp_min(0).sum())
    return dropped / max(slots, 1)


@contextlib.contextmanager
def ep_rows_seen(layers: tuple):
    """Yields a list that gets (weights, input, router, batch axes) of the
    composed MoE blocks (`moe.moe_ep_rows`) of `layers` called in the block,
    in call order; each block runs as it is."""
    from repro_torch.models import moe as moe_lib

    fn, seen, calls = moe_lib.moe_ep_rows, [], [0]

    def grab(m, lp, x, router, batch, mesh):
        if calls[0] in layers:
            seen.append((lp, x.detach().clone(), router.detach(), batch))
        calls[0] += 1
        return fn(m, lp, x, router, batch, mesh)

    moe_lib.moe_ep_rows = grab
    try:
        yield seen
    finally:
        moe_lib.moe_ep_rows = fn


@contextlib.contextmanager
def expert_choices():
    """Yields a list that gets each MoE routing's (top-k expert ids, sorted,
    (tokens, k); the gap between each token's k-th and (k+1)-th router
    logit, (tokens,)) in the flat token order, one entry a layer a call: the
    local path's, and EP's (the engines' blocks in (data…, model) order are
    the reference's flat layout, padding last); each routing runs as it is."""
    from repro_torch.models import moe as moe_lib

    route, seen = moe_lib._route, []

    def spy(m, logits, dtype):
        out = route(m, logits, dtype)
        flat = logits.reshape(-1, logits.shape[-1])
        if flat.shape[-1] > m.top_k:
            top = flat.topk(m.top_k + 1, dim=-1).values
            gap = top[:, -2] - top[:, -1]
        else:  # every expert picked: no tie to break
            gap = torch.full(flat.shape[:1], float("inf"), device=flat.device)
        seen.append((out[1].reshape(-1, m.top_k).sort(-1).values, gap))
        return out

    moe_lib._route = spy
    try:
        yield seen
    finally:
        moe_lib._route = route


def moe_tp_drain(cfg, device: torch.device, seed: int, prompts: list, new_tokens: int, mesh, *,
                 strategy: str = "tp_sp") -> tuple[dict, int]:
    """One MoE model served through `build_engine` under `strategy` with EP
    on `mesh` (tp_sp: SERVE_SLOTS slots; "fsdp": MOE_FSDP_SLOTS, which split
    over every engine) and with impl="local" on one device with as many
    slots, in turns (MOE_TP_TURNS, the mesh's route named by MOE_ROUTE), on
    the same bf16 weights: every request drained, logits finite, one
    attention launch a layer a prefill, the dropped share of routed slots;
    prefill tokens/s, decode ms, peak; on the mesh two prefills of the
    longest prompt bit-equal with their routes (Cs, Ce, dropped shares by
    layer), a decode step's (nothing dropped), under tp_sp the bytes a
    prefill and a decode step move.  Returns (the entry, the first mesh
    turn's attention launches)."""
    from repro_torch.models import transformer as tfm
    from repro_torch.models.sharding import MeshRules

    m, L = cfg.moe, cfg.n_layers
    ep = mesh.shape[m.ep_axis]
    route, slots = MOE_ROUTE[strategy], SERVE_SLOTS if strategy == "tp_sp" else MOE_FSDP_SLOTS
    tp_cfg = dataclasses.replace(cfg, moe=dataclasses.replace(m, impl="ep_shardmap"),
                                 rules=MeshRules(strategy=strategy))
    t0 = time.perf_counter()
    params = tfm.cast_params(tfm.init_params(cfg, seed, device=device), cfg)  # the moe phase's bf16 weights
    laid = tfm.shard_params(params, tp_cfg, mesh)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    dp = mesh.shape["data"]
    if strategy == "tp_sp":
        check(laid["layers"]["wq"].shape[:2] == (dp, ep) and laid["layers"]["router"].shape[:2] == (dp, 1)
              and laid["layers"]["we_gate"].shape[:2] == (1, ep), "the laid-out leaves: wq over both axes, the router "
              "over data, the expert stacks over model")
    else:
        check(all(v.shape[:2] == (dp, ep) for k, v in laid["layers"].items() if "norm" not in k and k != "ws_sig")
              and laid["layers"]["we_gate"].shape[3:] == (m.num_experts, cfg.d_model // (dp * ep), m.d_ff_expert),
              "the laid-out leaves: every weight over both axes, the expert stacks ZeRO-3 (experts whole)")
    runs = {"local": [], route: []}
    for name in MOE_TP_TURNS:
        on_mesh = name == "tp_ep"
        name = route if on_mesh else name
        r, _ = serve_turn(tp_cfg if on_mesh else cfg, laid if on_mesh else params, prompts, device,
                          mesh if on_mesh else None, new_tokens=new_tokens, routes=True, slots=slots)
        check(r["requests_drained"] == len(prompts) and r["finite"], f"{cfg.name} {name}: {r}")
        check(r["flash_attention_launches"] == L * len(prompts), f"{cfg.name} {name}: flash_attention launched "
              f"{r['flash_attention_launches']} times, want {L} a prefill × {len(prompts)}")
        runs[name].append(r)
    # the longest prompt's prefill on the mesh, twice, and a decode step at every slot
    toks = torch.from_numpy(max(prompts, key=len)[None, :].astype(np.int64)).to(device)

    def one_prefill():
        cache = tfm.init_kv_cache(tp_cfg, slots, toks.shape[1], dtype=torch.float32, device=device, mesh=mesh)
        return tfm.prefill(laid, toks, cache, tp_cfg, mesh=mesh, slot=0)[0], cache

    with torch.no_grad():
        (la, ca), log = ep_logged(one_prefill)
        lb, cb = one_prefill()
        torch.cuda.synchronize()
        bit_equal = bool(torch.equal(la, lb) and torch.equal(ca["k"], cb["k"]) and torch.equal(ca["v"], cb["v"]))
        check(bit_equal, f"{cfg.name}: two composed prefills of one prompt differ")
        prefill_routes = ep_stats(log, m, ep, toks.shape[1], cfg.d_model, 2)
        pos = torch.full((slots,), toks.shape[1] - 1, dtype=torch.long, device=device)
        _, dlog = ep_logged(lambda: tfm.decode_step_batched_pos(laid, ca, pos, toks[0, :slots, None], tp_cfg,
                                                               mesh=mesh))
    decode_routes = ep_stats(dlog, m, ep, slots, cfg.d_model, 2)
    check(prefill_routes["padded_expert_slots"] == 0 and decode_routes["padded_expert_slots"] == 0,
          f"{cfg.name}: a padded expert got a slot")
    check(decode_routes["stage1_dropped_share_mean"] == 0 and decode_routes["stage2_dropped_share_mean"] == 0,
          f"{cfg.name}: a composed decode step dropped a slot")
    del la, lb, ca, cb, params, laid
    gc.collect()
    torch.cuda.empty_cache()
    out = {"arch": cfg.name, "layers": L, "d_model": cfg.d_model, "heads": cfg.n_heads, "kv_heads": cfg.n_kv_heads,
           "experts": m.num_experts, "top_k": m.top_k, "d_ff_expert": m.d_ff_expert, "d_ff_shared": m.d_ff_shared,
           "capacity_factor": m.capacity_factor, "padded_experts": m.padded_experts(ep),
           "experts_an_engine": m.padded_experts(ep) // ep, "mesh": dict(mesh.shape), "engines": mesh.num_engines,
           "strategy": strategy, "activations": "bfloat16", "kv_cache": "float32", "slots": slots,
           "max_seq": SERVE_MAX_SEQ, "requests": len(prompts), "prompt_lengths": [len(p) for p in prompts],
           "max_new_tokens": new_tokens, "setup_s": setup_s,
           "turns": [route if t == "tp_ep" else t for t in MOE_TP_TURNS], "runs": runs,
           "prefill_tok_s": {k: float(np.mean([r["prefill_tok_s"] for r in v])) for k, v in runs.items()},
           "decode_ms_a_step": {k: float(np.mean([r["decode_ms_a_step"] for r in v])) for k, v in runs.items()},
           "max_memory_allocated_gb": {k: max(r["max_memory_allocated_gb"] for r in v) for k, v in runs.items()},
           "flash_attention_launches_a_drain": {k: v[0]["flash_attention_launches"] for k, v in runs.items()},
           "dropped_share_a_drain": {k: [r["dropped_share"] for r in v] for k, v in runs.items()},
           "prefills_bit_equal": bit_equal, "routes_longest_prefill": prefill_routes,
           "routes_decode_step": {k: decode_routes[k] for k in (
               "tokens", "Cs", "Ce", "stage1_dropped_share_mean", "stage2_dropped_share_mean", "padded_expert_slots")}}
    if strategy == "tp_sp":
        out["bytes"] = {"prefill_2048_one_slot": moe_tp_bytes(tp_cfg, mesh, 1, TP_PREFILL_S, False),
                        "decode_step": moe_tp_bytes(tp_cfg, mesh, SERVE_SLOTS, 1, True)}
    out[f"{route}_vs_local_prefill_tok_s"] = out["prefill_tok_s"][route] / out["prefill_tok_s"]["local"]
    out[f"{route}_vs_local_decode_ms"] = out["decode_ms_a_step"][route] / out["decode_ms_a_step"]["local"]
    return out, runs[route][0]["flash_attention_launches"]


def moe_tp_f32(cfg, device: torch.device, seed: int, mesh, *, drop_path: bool, strategy: str = "tp_sp") -> dict:
    """`cfg` in float32 (weights and activations) at capacity factor E/k
    (no slot can drop): SERVE_F32_ROWS one-slot prefills of their own
    lengths into a cache of as many slots and SERVE_F32_MAX_SEQ positions,
    then SERVE_F32_STEPS `decode_step_batched_pos` steps, on one device
    (impl="local") and under `strategy` with EP on `mesh` (twice: bit-equal;
    under "fsdp" each decode step's engines route their own row);
    every logit within MESH_F32_TOL of one device's, greedy tokens equal, no
    slot dropped, the unsharded cache within MODEL_TOL at every position
    whose token picked the same experts in every layer on both routes (a
    near tie in the router flips on float32 rounding: such a token's later
    k/v differ, and it is counted; each position's first such layer must be
    a near tie in the one-device run, ROUTER_NEAR_TIE, and such routings at
    most ROUTER_FLIP_SHARE of all).  With `drop_path`, at the
    config's capacity factor: a one-slot prefill of MOE_DROP_PROMPT tokens
    (the reference's padded flat layout), and each composed MoE block of
    MESH_LOOP_LAYERS on its input there against `moe_ep_loop_ref` on the
    same flat batch: the same slots kept in both stages, slots dropped in
    both, outputs within MESH_LOOP_TOL."""
    from repro_torch.models import moe as moe_lib
    from repro_torch.models import transformer as tfm
    from repro_torch.models.sharding import MeshRules

    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls in the float32 serving check")
    m = cfg.moe
    cf = m.num_experts / m.top_k
    local = dataclasses.replace(cfg, dtype=torch.float32, moe=dataclasses.replace(m, capacity_factor=cf, impl="local"))
    tp_cfg = dataclasses.replace(local, moe=dataclasses.replace(local.moe, impl="ep_shardmap"),
                                 rules=MeshRules(strategy=strategy))
    rng = np.random.default_rng(seed + 1)
    lengths = rng.integers(*SERVE_F32_PROMPT, size=SERVE_F32_ROWS)
    prompts = [torch.from_numpy(rng.integers(2, cfg.vocab, size=(1, int(n)))).to(device) for n in lengths]
    steps = [torch.from_numpy(rng.integers(2, cfg.vocab, size=(SERVE_F32_ROWS, 1))).to(device)
             for _ in range(SERVE_F32_STEPS)]
    pos0 = torch.from_numpy(lengths.astype(np.int64)).to(device)
    params = tfm.init_params(local, seed, device=device)
    torch.cuda.reset_peak_memory_stats()

    def run(c, p, msh) -> dict:
        cache = tfm.init_kv_cache(c, SERVE_F32_ROWS, SERVE_F32_MAX_SEQ, torch.float32, device=device, mesh=msh)
        pre = torch.cat([tfm.prefill(p, t, cache, c, mesh=msh, slot=i)[0] for i, t in enumerate(prompts)])
        dec = [tfm.decode_step_batched_pos(p, cache, pos0 + i, t, c, mesh=msh)[0] for i, t in enumerate(steps)]
        torch.cuda.synchronize()
        return {"prefill": pre, "decode": dec, "cache": tfm.unshard_kv_cache(cache, c, msh)}

    def diff(a, b) -> float:
        return float((a - b).abs().max())

    with torch.no_grad():
        with expert_choices() as want_k:
            want, local_drop = local_dropped(lambda: run(local, params, None))
        laid = tfm.shard_params(params, tp_cfg, mesh)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        with expert_choices() as got_k:
            got, log = ep_logged(lambda: run(tp_cfg, laid, mesh))
        again = run(tp_cfg, laid, mesh)
    # the positions whose token picked other experts in some layer on the two routes: each prefill's L routings,
    # then each decode step's
    L, rows = cfg.n_layers, SERVE_F32_ROWS
    check(len(want_k) == len(got_k) == L * (rows + SERVE_F32_STEPS), "one routing a layer a call on both routes")
    # the one-device router's gap between the k-th and (k+1)-th logit where a position first picked other experts
    flipped = torch.zeros((rows, SERVE_F32_MAX_SEQ), dtype=torch.bool, device=device)
    flips, first_gaps = 0, []
    for call in range(rows + SERVE_F32_STEPS):
        if call < rows:
            at = (torch.full_like(prompts[call][0], call), torch.arange(prompts[call].shape[1], device=device))
        else:
            at = (torch.arange(rows, device=device), pos0 + call - rows)
        for layer in range(L):
            (a, gap), (b, _) = want_k[call * L + layer], got_k[call * L + layer]
            differ = (a != b[:a.shape[0]]).any(-1)
            flips += int(differ.sum())
            first_gaps += gap[differ & ~flipped[at]].tolist()
            flipped[at] |= differ
    del want_k, got_k
    ep_drop = sum(int((r.stage1 - r.Cs).clamp_min(0).sum()) + int((r.stage2[:, :-1] - r.Ce).clamp_min(0).sum())
                  for r in log)
    same = (torch.equal(got["prefill"], again["prefill"]) and all(map(torch.equal, got["decode"], again["decode"]))
            and all(torch.equal(got["cache"][k], again["cache"][k]) for k in ("k", "v")))
    del again
    err = max([diff(got["prefill"], want["prefill"])] + [diff(a, b) for a, b in zip(got["decode"], want["decode"])])
    cache_err = max(diff(got["cache"][k], want["cache"][k]) for k in ("k", "v"))
    kept = ~flipped[None, :, :, None, None]
    cache_close = all(bool(((got["cache"][k] - want["cache"][k]).abs() <= MODEL_TOL["atol"] + MODEL_TOL["rtol"]
                            * want["cache"][k].abs()).logical_or(~kept).all()) for k in ("k", "v"))
    cache_err_kept = max(float(((got["cache"][k] - want["cache"][k]).abs() * kept).max()) for k in ("k", "v"))
    greedy = [torch.equal(a.argmax(-1), b.argmax(-1)) for a, b in zip([got["prefill"], *got["decode"]],
                                                                        [want["prefill"], *want["decode"]])]
    out = {"arch": cfg.name, "layers": cfg.n_layers, "dtype": "float32", "capacity_factor": cf,
           "mesh": dict(mesh.shape), "strategy": strategy, "rows": SERVE_F32_ROWS,
           "prompt_lengths": [int(x) for x in lengths],
           "max_seq": SERVE_F32_MAX_SEQ, "decode_steps": SERVE_F32_STEPS, "tolerance_abs": MESH_F32_TOL,
           "logits_max_abs": float(want["prefill"].abs().max()), "max_abs_err": err,
           "prefill_max_abs_err": diff(got["prefill"], want["prefill"]),
           "decode_max_abs_err_by_step": [diff(a, b) for a, b in zip(got["decode"], want["decode"])],
           "cache_max_abs_err": cache_err, "cache_max_abs_err_same_experts": cache_err_kept,
           "cache_max_abs": float(want["cache"]["k"].abs().max()), "cache_tolerance": MODEL_TOL,
           "routings": L * (int(lengths.sum()) + SERVE_F32_STEPS * rows), "routings_with_other_experts": flips,
           "positions_with_other_experts": int(flipped.sum()), "router_logit_gap_at_first_flip": first_gaps,
           "router_near_tie": ROUTER_NEAR_TIE, "router_flip_share_limit": ROUTER_FLIP_SHARE,
           "greedy_tokens_equal_prefill_then_steps": greedy,
           "two_runs_bit_equal": same, "slots_dropped": {"local": local_drop, MOE_ROUTE[strategy]: ep_drop},
           "Cs_of_a_prefill": log[0].Cs, "Ce_of_a_prefill": log[0].Ce,
           "tokens_an_engine_routes": {"prefill": int(log[0].stage1[0].sum()) // m.top_k,
                                       "decode_step": int(log[-1].stage1[0].sum()) // m.top_k}}
    del got, want
    check(local_drop == 0 and ep_drop == 0,
          f"{cfg.name}: slots dropped at capacity_factor {cf}: {out['slots_dropped']}")
    check(same, f"{cfg.name}: two float32 composed runs differ")
    check(strategy != "fsdp" or out["tokens_an_engine_routes"]["decode_step"] == SERVE_F32_ROWS // mesh.num_engines,
          f"{cfg.name}: under fsdp each engine routes its own decode row: {out['tokens_an_engine_routes']}")
    check(flips <= ROUTER_FLIP_SHARE * out["routings"] and all(g < ROUTER_NEAR_TIE for g in first_gaps),
          f"{cfg.name}: the composed route picked other experts than one device's where the router is no near tie: "
          f"{flips} of {out['routings']} routings, first-flip gaps {first_gaps}")
    check(err <= MESH_F32_TOL and cache_close and all(greedy),
          f"{cfg.name}: float32 composed serving vs one device: {out}")
    if drop_path:
        e125 = dataclasses.replace(tp_cfg, moe=dataclasses.replace(m, impl="ep_shardmap"))
        toks = torch.from_numpy(rng.integers(2, cfg.vocab, size=(1, MOE_DROP_PROMPT))).to(device)
        slots = SERVE_SLOTS if strategy == "tp_sp" else MOE_FSDP_SLOTS
        cache = tfm.init_kv_cache(e125, slots, MOE_DROP_PROMPT, torch.float32, device=device, mesh=mesh)
        with torch.no_grad(), ep_rows_seen(MESH_LOOP_LAYERS) as seen:
            tfm.prefill(laid, toks, cache, e125, mesh=mesh, slot=0)
            torch.cuda.synchronize()
        del cache
        check(len(seen) == len(MESH_LOOP_LAYERS), f"{len(seen)} composed MoE inputs caught, want {MESH_LOOP_LAYERS}")
        ep, loop = mesh.shape[m.ep_axis], []
        for li, (lp, h, router, batch) in zip(MESH_LOOP_LAYERS, seen):
            check(batch == () and h.shape[:2] == (1, 1), f"the one-slot prompt's rows are held once: {batch}")
            with torch.no_grad():
                got, log = ep_logged(lambda: moe_lib.moe_ep_rows(e125.moe, lp, h, router, batch, mesh))
                whole = moe_lib.unshard_experts(m, {k: lp[k] for k in moe_lib.EXPERT_KEYS}, mesh)
                whole["router"] = router.reshape(router.shape[-2:])
                plain, stage1, stage2 = moe_lib.moe_ep_loop_ref(e125.moe, whole, h.reshape(1, *h.shape[-2:]), mesh)
            (r,) = log
            same = bool(torch.equal(r.stage1.cpu(), stage1) and torch.equal(r.stage2.cpu(), stage2))
            routes = ep_stats(log, m, ep, MOE_DROP_PROMPT, cfg.d_model, 4)
            got = got.reshape(plain.shape)
            e = float((got - plain).abs().max())
            loop.append({"layer": li, "max_abs_err": e, "out_max_abs": float(plain.abs().max()), "same_slots": same,
                         "Cs": r.Cs, "Ce": r.Ce, "stage1_dropped_share": routes["stage1_dropped_share_mean"],
                         "stage2_dropped_share": routes["stage2_dropped_share_mean"]})
            check(same, f"{cfg.name} layer {li}: the composed block and the plain loop keep other slots")
            check(loop[-1]["stage1_dropped_share"] > 0 and loop[-1]["stage2_dropped_share"] > 0,
                  f"{cfg.name} layer {li}: no slot dropped in a stage at capacity_factor {m.capacity_factor}: "
                  f"{loop[-1]}")
            check(torch.allclose(got, plain, **MESH_LOOP_TOL),
                  f"{cfg.name} layer {li}: composed vs the plain loop: {e}")
        out["drop_path_vs_plain_loop"] = {"capacity_factor": m.capacity_factor, "prompt": MOE_DROP_PROMPT,
                                          "engines": mesh.num_engines, "tolerance": MESH_LOOP_TOL, "layers": loop,
                                          "input": "each layer's MoE input in a float32 composed one-slot prefill"}
        del seen, got, plain, whole
    out["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del laid
    gc.collect()
    torch.cuda.empty_cache()
    return out


def moe_tp_attention(device: torch.device, timer: Timer, mesh) -> dict:
    """`flash_attention` at olmoe's composed per-engine prefill shape on
    `mesh`: one slot's TP_PREFILL_S-token prompt held once along "data",
    the model engines' 16 / model query and kv heads folded into the batch
    (q (model, S, 2, 128)), bf16, causal."""
    from repro_torch.configs.registry import get_arch

    cfg = get_arch(MOE_ARCH).model_config()
    tp = mesh.shape["model"]
    gen = torch.Generator(device=device).manual_seed(17)
    q, k, v = (torch.randn((tp, TP_PREFILL_S, h // tp, cfg.head_dim), generator=gen, device=device).to(torch.bfloat16)
               for h in (cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads))
    out = attention_forward_site(q, k, v, timer)
    del q, k, v
    torch.cuda.empty_cache()
    out["timing"] = ("ms: device time replayed from a CUDA graph; call_ms, plain_ms (flash_attention_ref), library_ms "
                     "(scaled_dot_product_attention(is_causal, enable_gqa) on (B, H, S, dh) copies): calls enqueued "
                     "back to back")
    return out


def phase_mesh_moe_serve(device: torch.device, seed: int, smi: str | None, timer: Timer) -> tuple[dict, dict]:
    """(i) MoE serving on MESH_SHAPE under tp_sp, Megatron TP attention and EP
    experts in one layer: olmoe-1b-7b and qwen2-moe-a2.7b (MOE_WIDE_LAYERS)
    through `moe_tp_drain` and `moe_tp_f32`, NCCL at world size 1, the
    attention kernel at the new shape.  Returns (the `mesh_moe_serve` line,
    the drains' attention launches)."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.graph.distributed import make_mesh

    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls would change which experts the router picks")
    mesh = make_mesh(MESH_SHAPE, MESH_AXES, device=device)
    cfg = get_arch(MOE_ARCH).model_config()
    wide = dataclasses.replace(get_arch(MOE_WIDE_ARCH).model_config(), n_layers=MOE_WIDE_LAYERS)
    check(wide.moe.d_ff_shared > 0 and wide.moe.padded_experts(8) == 64, "qwen2-moe: a shared expert, 60 → 64")
    rng = np.random.default_rng(seed)
    lengths = rng.integers(*SERVE_PROMPT, size=SERVE_REQUESTS)  # the moe phase's traffic
    prompts = [rng.integers(2, cfg.vocab, size=int(n)).astype(np.int32) for n in lengths]
    wide_prompt = [rng.integers(2, wide.vocab, size=MOE_WIDE_PROMPT).astype(np.int32)]
    f32_cfg = dataclasses.replace(cfg, n_layers=MOE_F32_LAYERS)
    parts, launches = {}, {}
    for name, fn in (("olmoe", lambda: moe_tp_drain(cfg, device, seed, prompts, SERVE_NEW, mesh)),
                     ("olmoe_float32_vs_one_device", lambda: moe_tp_f32(f32_cfg, device, seed, mesh, drop_path=True)),
                     ("qwen", lambda: moe_tp_drain(wide, device, seed, wide_prompt, MOE_WIDE_STEPS + 1, mesh)),
                     ("qwen_float32_vs_one_device", lambda: moe_tp_f32(wide, device, seed, mesh, drop_path=False)),
                     ("nccl", lambda: nccl_world_one_serve(device, seed, moe=True, strategies=("tp_sp",))),
                     ("attention_tp_ep_prefill_shape", lambda: moe_tp_attention(device, timer, mesh))):
        t0 = time.perf_counter()
        parts[name] = fn()
        print(f"mesh_moe_serve: {name} done", file=sys.stderr, flush=True)
        if name in ("olmoe", "qwen"):
            parts[name], launches[name] = parts[name]
        parts[name]["seconds"] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
    parts["olmoe_float32_vs_one_device"]["cuts"] = [] if MOE_F32_LAYERS == cfg.n_layers else [
        f"{MOE_F32_LAYERS} of {cfg.n_layers} layers"]
    for k in ("qwen", "qwen_float32_vs_one_device"):
        parts[k]["cuts"] = [f"{MOE_WIDE_LAYERS} of {get_arch(MOE_WIDE_ARCH).n_layers} layers, as the moe phase"]
    out = {**parts, "card": smi,
           "weights": "random, from a seeded torch.Generator on the card (the moe phase's seed: the same weights)",
           "timing": "host clock around each prefill / decode call, synchronised on both sides; the routes in "
                     "turns, each a mean of two"}
    say("mesh_moe_serve", **out)
    return out, launches


# --------------------------------------------------------------------------- mesh_moe_fsdp

# (j) MoE on MESH_SHAPE under `MeshRules(strategy="fsdp")`: every leaf laid out ZeRO-3 by `param_specs`, the
# expert stacks too (experts whole, d_model over both axes) and gathered into EP's slab at use
# (`moe.zero3_expert_slabs`), the token rows split over all 16 engines and each engine routing its own
# (`moe.moe_ep_rows`'s in-place branch): olmoe-1b-7b at its published width and depth drained through
# `build_engine(..., slots=MOE_FSDP_SLOTS, mesh=)` beside one device's engine with as many slots, in turns, on the
# moe phase's bf16 weights and traffic; float32 logits and cache at capacity factor E/k against one device's (the
# decode steps one row an engine) and the drop path at 1.25 against the plain per-engine loop; qwen2-moe over
# MOE_WIDE_LAYERS layers the same; olmoe over MOE_FSDP_TRAIN_LAYERS layers trained: float32 loss and gradients
# against one device's, and a bf16 step timed under local, tp_sp and fsdp; NCCL at world size 1; the attention
# kernels at the fsdp per-engine training shape
MOE_FSDP_SLOTS = 16  # "fsdp" splits the slots over all 16 engines (4 do not divide: refused, as the reference)
MOE_FSDP_TRAIN_LAYERS, MOE_FSDP_STEPS = 2, 3  # 3 steps a route: the step time is the median of the last two
MOE_FSDP_TRAIN_TURNS = ("local", "tp_sp", "fsdp")
MOE_FSDP_LOSS_RTOL = 1e-5  # the float32 loss against one device's


def moe_fsdp_train(device: torch.device, seed: int, mesh) -> tuple[dict, dict]:
    """olmoe-1b-7b at its published width over MOE_FSDP_TRAIN_LAYERS layers
    on DENSE_BATCH × LM_TRAIN_SEQ tokens (16 rows: one an engine under
    "fsdp"): in float32 at capacity factor E/k the loss (within
    MOE_FSDP_LOSS_RTOL) and every gradient (within MESH_GRAD_REL of its
    largest entry) under "fsdp" on `mesh` against one device's impl="local",
    two runs bit-equal, nothing dropped, every engine routing its own row;
    then MOE_FSDP_STEPS bf16 steps under each of MOE_FSDP_TRAIN_TURNS,
    timed and reported, not checked.  Returns (the entry, the fsdp run's
    kernel launches)."""
    import itertools

    from repro_torch.configs.registry import get_arch
    from repro_torch.data.pipeline import TokenPipeline, to_device
    from repro_torch.models import transformer as tfm
    from repro_torch.models.sharding import MeshRules
    from repro_torch.train.pytree import tree_leaves, tree_leaves_with_path, tree_unflatten

    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls in the float32 gradient check")
    cfg = dataclasses.replace(get_arch(MOE_ARCH).model_config(), n_layers=MOE_FSDP_TRAIN_LAYERS)
    m, L = cfg.moe, cfg.n_layers
    data = TokenPipeline(cfg.vocab, LM_TRAIN_SEQ, DENSE_BATCH, seed=seed)
    batches = [to_device(b, device) for b in itertools.islice(data, MOE_FSDP_STEPS)]

    def loss_and_grads(params, c, msh=None):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        try:
            loss = tfm.loss_fn(params, batches[0], c, mesh=msh)
            return float(loss.detach()), torch.autograd.grad(loss, leaves)
        finally:
            for p in leaves:
                p.requires_grad_(False)

    f32 = dataclasses.replace(cfg, dtype=torch.float32)
    cf = m.num_experts / m.top_k
    loc = dataclasses.replace(f32, moe=dataclasses.replace(m, capacity_factor=cf))
    fs = dataclasses.replace(loc, moe=dataclasses.replace(loc.moe, impl="ep_shardmap"),
                             rules=MeshRules(strategy="fsdp"))
    params = tfm.init_params(f32, seed, device=device)
    names = ["/".join(map(str, p)) for p, _ in tree_leaves_with_path(params)]
    torch.cuda.reset_peak_memory_stats()
    (want_loss, want), local_drop = local_dropped(lambda: loss_and_grads(params, loc))
    laid = tfm.shard_params(params, fs, mesh)
    del params
    dp, ep = mesh.shape["data"], mesh.shape[m.ep_axis]
    check(laid["layers"]["we_gate"].shape == (dp, ep, L, m.num_experts, cfg.d_model // (dp * ep), m.d_ff_expert),
          f"the ZeRO-3 expert stacks: {tuple(laid['layers']['we_gate'].shape)}")
    (got_loss, got), log = ep_logged(lambda: loss_and_grads(laid, fs, mesh))
    again = loss_and_grads(laid, fs, mesh)[1]
    same = bit_equal(got, again)
    del again
    ep_drop = sum(int((r.stage1 - r.Cs).clamp_min(0).sum()) + int((r.stage2[:, :-1] - r.Ce).clamp_min(0).sum())
                  for r in log)
    own = batches[0]["tokens"].numel() // mesh.num_engines
    routed = sorted({int(r.stage1[i].sum()) // m.top_k for r in log for i in range(r.stage1.shape[0])})
    got = tree_leaves(tfm.unshard_params(tree_unflatten(laid, got), fs, mesh))
    rel = rel_errs(got, want, names)
    loss_rel = abs(got_loss - want_loss) / abs(want_loss)
    peak = torch.cuda.max_memory_allocated() / 1e9
    del laid, got, want
    gc.collect()
    torch.cuda.empty_cache()
    out = {"arch": MOE_ARCH, "layers": L, "batch": DENSE_BATCH, "seq": LM_TRAIN_SEQ, "mesh": dict(mesh.shape),
           "cuts": [f"{L} of {get_arch(MOE_ARCH).n_layers} layers: a float32 state beside one device's, and three "
                    "routes' bf16 training states in turn"],
           "float32_vs_one_device": {
               "capacity_factor": cf, "loss": got_loss, "one_device_loss": want_loss, "loss_rel_err": loss_rel,
               "loss_tolerance_rel": MOE_FSDP_LOSS_RTOL, "max_rel_err": max(rel.values()), "rel_err_by_leaf": rel,
               "tolerance_rel": MESH_GRAD_REL, "grads_bit_equal_two_runs": same,
               "slots_dropped": {"local": local_drop, "fsdp_ep": ep_drop}, "Cs": log[0].Cs, "Ce": log[0].Ce,
               "tokens_an_engine_routes": routed, "max_memory_allocated_gb": peak}}
    check(local_drop == 0 and ep_drop == 0, f"slots dropped at capacity_factor {cf}: local {local_drop}, EP {ep_drop}")
    check(routed == [own], f"each engine routes its own row's {own} tokens: got {routed}")
    check(same, "two float32 fsdp gradients of one state differ")
    check(loss_rel <= MOE_FSDP_LOSS_RTOL, f"float32 fsdp loss vs one device: {got_loss} vs {want_loss}")
    check(max(rel.values()) <= MESH_GRAD_REL, f"float32 fsdp gradients vs one device: {rel}")

    runs, launches = {}, {}
    for name in MOE_FSDP_TRAIN_TURNS:
        c = cfg if name == "local" else dataclasses.replace(
            cfg, moe=dataclasses.replace(m, impl="ep_shardmap"), rules=MeshRules(strategy=name))
        r = lm_train_run(c, batches, device, seed, None if name == "local" else mesh)
        runs[name] = {k: r[k] for k in ("losses", "step_ms", "tokens_per_s", "max_memory_allocated_gb")}
        runs[name]["flash_attention_launches_a_step"] = r["launches"]["flash_attention"] / MOE_FSDP_STEPS
        runs[name]["flash_attention_bwd_launches_a_step"] = r["launches"]["flash_attention_bwd"] / MOE_FSDP_STEPS
        if name == "fsdp":
            launches = dict(r["launches"])
    check(launches["flash_attention"] == 2 * L * MOE_FSDP_STEPS
          and launches["flash_attention_bwd"] == L * MOE_FSDP_STEPS, f"fsdp training's attention launches: {launches}")
    out["bf16_step"] = {"steps": MOE_FSDP_STEPS, "capacity_factor": m.capacity_factor, "routes": runs,
                        "fsdp_vs_local_step_ms": runs["fsdp"]["step_ms"] / runs["local"]["step_ms"],
                        "tp_sp_vs_local_step_ms": runs["tp_sp"]["step_ms"] / runs["local"]["step_ms"],
                        "timing": "the host clock between the ends of consecutive steps (each ends on the loss's "
                                  "read), the median of the last two; timed and reported, not checked"}
    return out, launches


def moe_fsdp_attention(device: torch.device, timer: Timer, mesh) -> dict:
    """The attention kernels at olmoe's per-engine training shape under
    "fsdp" on `mesh`: each engine's one row of DENSE_BATCH with all 16 query
    and kv heads (nothing split over "model"), every engine's folded into
    the batch: q (DENSE_BATCH, LM_TRAIN_SEQ, 16, 128), bf16, causal
    (`attention_train_site`)."""
    from repro_torch.configs.registry import get_arch

    cfg = get_arch(MOE_ARCH).model_config()
    check(DENSE_BATCH % mesh.num_engines == 0, "one row an engine")
    return attention_train_site(device, timer, (DENSE_BATCH, LM_TRAIN_SEQ, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim),
                                19, "olmoe's fsdp training shape")


def phase_mesh_moe_fsdp(device: torch.device, seed: int, smi: str | None, timer: Timer) -> tuple[dict, dict]:
    """(j) MoE on MESH_SHAPE under "fsdp": `moe_tp_drain` and `moe_tp_f32`
    with strategy "fsdp", `moe_fsdp_train`, `nccl_world_one_serve`,
    `moe_fsdp_attention`.  Returns (the `mesh_moe_fsdp` line, the drain's
    and the fsdp training run's attention launches)."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.graph.distributed import make_mesh

    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls would change which experts the router picks")
    mesh = make_mesh(MESH_SHAPE, MESH_AXES, device=device)
    cfg = get_arch(MOE_ARCH).model_config()
    wide = dataclasses.replace(get_arch(MOE_WIDE_ARCH).model_config(), n_layers=MOE_WIDE_LAYERS)
    rng = np.random.default_rng(seed)
    lengths = rng.integers(*SERVE_PROMPT, size=SERVE_REQUESTS)  # the moe phase's traffic
    prompts = [rng.integers(2, cfg.vocab, size=int(n)).astype(np.int32) for n in lengths]
    f32_cfg = dataclasses.replace(cfg, n_layers=MOE_F32_LAYERS)
    parts, launches = {}, {}
    for name, fn in (("olmoe", lambda: moe_tp_drain(cfg, device, seed, prompts, SERVE_NEW, mesh, strategy="fsdp")),
                     ("olmoe_float32_vs_one_device", lambda: moe_tp_f32(f32_cfg, device, seed, mesh, drop_path=True,
                                                                       strategy="fsdp")),
                     ("qwen_float32_vs_one_device", lambda: moe_tp_f32(wide, device, seed, mesh, drop_path=False,
                                                                      strategy="fsdp")),
                     ("train", lambda: moe_fsdp_train(device, seed, mesh)),
                     ("nccl", lambda: nccl_world_one_serve(device, seed, moe=True, strategies=("fsdp",))),
                     ("attention_fsdp_train_shape", lambda: moe_fsdp_attention(device, timer, mesh))):
        t0 = time.perf_counter()
        parts[name] = fn()
        print(f"mesh_moe_fsdp: {name} done", file=sys.stderr, flush=True)
        if name in ("olmoe", "train"):
            parts[name], launches[name] = parts[name]
        parts[name]["seconds"] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
    parts["olmoe_float32_vs_one_device"]["cuts"] = [] if MOE_F32_LAYERS == cfg.n_layers else [
        f"{MOE_F32_LAYERS} of {cfg.n_layers} layers"]
    parts["qwen_float32_vs_one_device"]["cuts"] = [
        f"{MOE_WIDE_LAYERS} of {get_arch(MOE_WIDE_ARCH).n_layers} layers, as the moe phase"]
    out = {**parts, "card": smi,
           "weights": "random, from a seeded torch.Generator on the card (the moe phase's seed: the same weights)",
           "timing": "host clock around each prefill / decode call, synchronised on both sides; the routes in "
                     "turns, each a mean of two"}
    say("mesh_moe_fsdp", **out)
    return out, launches


EXAMPLES_DIR = ROOT / "examples"
EXAMPLES_TRAIN_FULL = ("--width", "768", "--layers", "12")  # the twin's documented ~100M-param size
EXAMPLES_TRAIN_STEPS = (40, 50)  # the first call, then the resumed one
EXAMPLES_MOE_STEPS = 20
EXAMPLES_BUDGET_S = 60.0  # the phase's time on the card; above it the phase fails
TRAIN_LOG = re.compile(r"^\[step (\d+)\] loss=(\S+) ")


def example(name: str):
    """The example twin `examples/<name>.py`, loaded by path as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"example_{name}", EXAMPLES_DIR / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_example(fn) -> dict:
    """`fn()` under `counted`, its stdout captured: {"result", "lines",
    "launches" (the kernels it launched), "seconds"}."""
    import io

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        result, launches = counted(fn)
    return {"result": result, "lines": buf.getvalue().splitlines(),
            "launches": {k: v for k, v in launches.items() if v}, "seconds": time.perf_counter() - t0}


def phase_examples(device: torch.device, smi: str | None) -> tuple[dict, dict]:
    """The example twins as their users run them (`examples/torch_*.py`), each
    loaded by path and its `main` called in process under `counted`:
    torch_quickstart on the card against its own `--device cpu` run (every
    line equal: hops, speedup, energy, iterations), one `segment_spmm` launch
    an iteration; torch_serve_continuous_batching on the card against its own
    `--device cpu` run (the same (uid, tokens) for every request), 10 requests
    drained, each with 12 tokens or ended at EOS, no slot idle while a request
    waited, `flash_attention` in every prefill; torch_train_lm_e2e at its documented
    full size for 40 steps into a temporary directory, then resumed to 50
    (`[resume] restored step 40`), the loss finite and falling between the
    first and the last logged step, and `--moe` at its default width for 20
    steps, each through `flash_attention` and `flash_attention_bwd`; then the
    two twins of earlier slices at their defaults
    (torch_distributed_graph_analytics; torch_moe_expert_placement, host
    numpy with no `main`, through `runpy`).  The attention kernels at these
    call sites' shapes are held against their plain versions in the
    `attention` phase (EXAMPLES_SERVE_ATTN, EXAMPLES_TRAIN_ATTN).  The phase
    must take at most EXAMPLES_BUDGET_S.  Returns the `examples` line and each kernel's launches
    over the phase."""
    import os
    import runpy
    import tempfile

    t_phase = time.perf_counter()
    twins: dict = {}

    quick = example("torch_quickstart")
    host = run_example(lambda: quick.main(["--device", "cpu"]))
    card = run_example(quick.main)
    check(card["lines"] == host["lines"], f"torch_quickstart: the card printed {card['lines']}, the CPU {host['lines']}")
    iterations = int(re.search(r"converged in (\d+) iterations", "\n".join(card["lines"])).group(1))
    check(card["launches"] == {"segment_spmm": iterations},
          f"torch_quickstart: launches {card['launches']}, want one segment_spmm a PageRank iteration ({iterations})")
    check(host["launches"] == {}, f"torch_quickstart --device cpu launched {host['launches']}")
    twins["torch_quickstart"] = {**{k: card[k] for k in ("lines", "launches", "seconds")},
                                 "cpu_seconds": host["seconds"], "lines_equal_cpu": True}

    serve_mod = example("torch_serve_continuous_batching")
    host = run_example(lambda: serve_mod.main(["--device", "cpu"]))
    run = run_example(serve_mod.main)
    engine, stats = run["result"]
    done = engine.completed
    served = [(r.uid, list(r.out_tokens)) for r in done]
    on_cpu = [(r.uid, list(r.out_tokens)) for r in host["result"][0].completed]
    check(served == on_cpu, f"torch_serve_continuous_batching: the card served {served}, the CPU {on_cpu}")
    check(host["launches"] == {}, f"torch_serve_continuous_batching --device cpu launched {host['launches']}")
    check(len(done) == serve_mod.REQUESTS and not engine.queue and all(a is None for a in engine.active),
          f"torch_serve_continuous_batching: {len(done)} of {serve_mod.REQUESTS} requests drained")
    check(all(len(r.out_tokens) == serve_mod.NEW_TOKENS or r.out_tokens[-1] == engine.eos_id for r in done),
          f"torch_serve_continuous_batching: tokens a request {[len(r.out_tokens) for r in done]}")
    check(stats["idle_steps"] == 0, f"torch_serve_continuous_batching: {stats['idle_steps']} steps with an idle slot "
                                    "while requests waited")
    prefills = serve_mod.serve_config().n_layers * serve_mod.REQUESTS  # one launch a layer a prefill
    check(run["launches"] == {"flash_attention": prefills},
          f"torch_serve_continuous_batching: launches {run['launches']}, want {prefills} flash_attention")
    check("tok/s" in run["lines"][-1], f"torch_serve_continuous_batching: last line {run['lines'][-1]!r}")
    twins["torch_serve_continuous_batching"] = {
        **{k: run[k] for k in ("lines", "launches", "seconds")}, "tokens": stats["tokens"],
        "tokens_a_request": [len(r.out_tokens) for r in done], "ended_at_eos": sum(
            len(r.out_tokens) < serve_mod.NEW_TOKENS for r in done), "steps": stats["steps"],
        "tok_s": stats["tokens"] / stats["seconds"], "idle_steps": stats["idle_steps"],
        "tokens_equal_cpu": True, "cpu_seconds": host["seconds"]}
    del engine, run, host

    train = example("torch_train_lm_e2e")
    with tempfile.TemporaryDirectory() as tmp:
        runs = []
        for steps in EXAMPLES_TRAIN_STEPS:
            runs.append(run_example(lambda: train.main([*EXAMPLES_TRAIN_FULL, "--steps", str(steps), "--ckpt-dir",
                                                        os.path.join(tmp, "lm")])))
        moe = run_example(lambda: train.main(["--moe", "--steps", str(EXAMPLES_MOE_STEPS), "--ckpt-dir",
                                              os.path.join(tmp, "moe")]))
    check(f"[resume] restored step {EXAMPLES_TRAIN_STEPS[0]}" in runs[1]["lines"],
          f"torch_train_lm_e2e: the second call printed {runs[1]['lines']}")
    for what, lines in (("lm", runs[0]["lines"] + runs[1]["lines"]), ("moe", moe["lines"])):
        logged = [(int(m.group(1)), float(m.group(2))) for m in map(TRAIN_LOG.match, lines) if m]
        check(len(logged) >= 2 and all(np.isfinite(v) for _, v in logged) and logged[-1][1] < logged[0][1],
              f"torch_train_lm_e2e {what}: logged losses {logged}")
    for what, r in (("lm", runs[0]), ("lm resumed", runs[1]), ("moe", moe)):
        check(r["launches"].get("flash_attention", 0) > 0 and r["launches"].get("flash_attention_bwd", 0) > 0
              and set(r["launches"]) == {"flash_attention", "flash_attention_bwd"},
              f"torch_train_lm_e2e {what}: launches {r['launches']}")
    twins["torch_train_lm_e2e"] = {
        "argv": list(EXAMPLES_TRAIN_FULL), "steps": list(EXAMPLES_TRAIN_STEPS),
        "lines": runs[0]["lines"] + runs[1]["lines"], "seconds": [r["seconds"] for r in runs],
        "launches": {k: runs[0]["launches"][k] + runs[1]["launches"][k] for k in runs[0]["launches"]},
        "moe": {"steps": EXAMPLES_MOE_STEPS, **{k: moe[k] for k in ("lines", "launches", "seconds")}}}
    del runs, moe
    gc.collect()
    torch.cuda.empty_cache()

    dist = example("torch_distributed_graph_analytics")
    run = run_example(dist.main)
    check(run["launches"].get("segment_spmm", 0) > 0, f"torch_distributed_graph_analytics: launches {run['launches']}")
    check(any(line.startswith("pagerank:") for line in run["lines"]),
          f"torch_distributed_graph_analytics: printed {run['lines']}")
    twins["torch_distributed_graph_analytics"] = {k: run[k] for k in ("lines", "launches", "seconds")}

    def placement():
        runpy.run_path(str(EXAMPLES_DIR / "torch_moe_expert_placement.py"), run_name="__main__")

    run = run_example(placement)
    check(run["launches"] == {} and run["lines"], f"torch_moe_expert_placement: launches {run['launches']}")
    twins["torch_moe_expert_placement"] = {k: run[k] for k in ("lines", "launches", "seconds")}

    launches: dict = {}
    for t in twins.values():
        for part in (t, t.get("moe", {})):
            for k, v in part.get("launches", {}).items():
                launches[k] = launches.get(k, 0) + v
    seconds = time.perf_counter() - t_phase
    check(seconds <= EXAMPLES_BUDGET_S, f"examples: the phase took {seconds:.1f} s, above {EXAMPLES_BUDGET_S} s")
    out = {"twins": twins, "launches": launches, "card": smi, "phase_seconds": seconds}
    say("examples", **out)
    return out, launches


ROOFLINE_CELLS = (("llama3.2-3b", "train_4k", None), ("llama3.2-3b", "train_4k", "bf16params"),
                  ("dcn-v2", "serve_bulk", None), ("gin-tu", "ogb_products", None))  # (arch, cell, variant)
ROOFLINE_LM_CUT = {"batch": 8, "seq": 128}  # (b′)'s batch, at full width and depth
ROOFLINE_DCN_BATCH = 262_144  # serve_bulk's published batch
ROOFLINE_SLACK = 1.05  # the counted compute time may not exceed the measured step by more than this
ROOFLINE_HALO_ENGINES = DIST_ENGINES


def phase_roofline(device: torch.device, graph, seed: int, smi: str | None) -> dict:
    """The counted roofline against the card (`launch.roofline`,
    `launch.perf.measure_cell`): each of ROOFLINE_CELLS run on one device at
    its cut (llama3.2-3b train_4k at ROOFLINE_LM_CUT, baseline and
    bf16params; dcn-v2 serve_bulk at its published batch; gin-tu at
    ogb_products' width on `graph`, amazon, by the ELL route), counted on the
    card and on 'meta' (FLOPs by dtype and bytes must be equal exactly) and
    timed over `launch.perf.MEASURED_STEPS` warm steps; the counted compute time must not
    exceed ROOFLINE_SLACK × the measured step.  Then the `halo` variant
    counted on 'meta' (no card) on amazon over ROOFLINE_HALO_ENGINES engines.
    Returns the `roofline` line."""
    from repro_torch.launch.dryrun import count_case, roofline_of
    from repro_torch.launch.perf import MEASURED_STEPS, halo_case, measure_cell

    t_phase = time.perf_counter()
    cuts = {"llama3.2-3b": ROOFLINE_LM_CUT, "dcn-v2": {"batch": ROOFLINE_DCN_BATCH}, "gin-tu": {"graph": graph}}
    cells = {}
    for arch, cell, variant in ROOFLINE_CELLS:
        t0 = time.perf_counter()
        rec, launches = counted(lambda: measure_cell(arch, cell, variant, cut=cuts[arch], seed=seed, device=device,
                                                     smi=smi))
        m = rec["measured"]
        key = f"{arch}.{cell}" + (f".{variant}" if variant else "")
        check(rec["counts_equal_meta"], f"roofline {key}: the card counted {rec['flops_by_dtype']} FLOPs and "
                                        f"{rec['hlo_bytes']} bytes, 'meta' {rec['meta']}")
        check(rec["t_compute_s"] <= ROOFLINE_SLACK * m["s"],
              f"roofline {key}: counted compute {rec['t_compute_s']} s above {ROOFLINE_SLACK} × the measured {m['s']} s")
        cells[key] = {
            "cut": m["cut"], "flops_by_dtype": rec["flops_by_dtype"], "bytes": rec["hlo_bytes"],
            "counts_equal_meta": rec["counts_equal_meta"], "t_compute_s": rec["t_compute_s"],
            "t_memory_s": rec["t_memory_s"], "t_collective_s": rec["t_collective_s"], "dominant": rec["dominant"],
            "bound_s": max(rec["t_compute_s"], rec["t_memory_s"], rec["t_collective_s"]),
            "measured_s": m["s"], "step_s": m["step_s"], "fraction": m["fraction"],
            "t_compute_over_measured": m["t_compute_over_measured"],
            "t_memory_over_measured": m["t_memory_over_measured"], "model_flops": rec["model_flops"],
            "kernels_counted": rec["kernels"], "launches": {k: v for k, v in launches.items() if v},
            "seconds": time.perf_counter() - t0}
        del rec
        gc.collect()
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    case = halo_case(graph, ROOFLINE_HALO_ENGINES)
    c = count_case(case)
    halo = roofline_of(case, c, f"{ROOFLINE_HALO_ENGINES}").to_dict()
    halo = {k: halo[k] for k in ("chips", "hlo_flops", "hlo_bytes", "coll_bytes", "coll_breakdown", "t_compute_s",
                                 "t_memory_s", "t_collective_s", "dominant", "bytes_per_device")}
    halo.update({"graph": graph.name, "engines": ROOFLINE_HALO_ENGINES, "kernels_counted": dict(c.kernels),
                 "measured": False, "seconds": time.perf_counter() - t0})
    out = {"cells": cells, "halo_gin_counted_on_meta": halo, "card": smi, "steps": MEASURED_STEPS,
           "timing": "CUDA events around each warm step, the median; one device a cell",
           "phase_seconds": time.perf_counter() - t_phase}
    say("roofline", **out)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only", file=sys.stderr)
        return 2

    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.device import probe
    from repro_torch.experiments.grid import GRIDS
    from repro_torch.graph.generators import table2_workloads
    from repro_torch.kernels.build import build_library

    device = torch.device("cuda")
    scale = 1.0
    t_all = time.perf_counter()
    info = probe()
    say("probe", **info)

    t0 = time.perf_counter()
    sources = {"ell_spmm": KERNEL_SOURCE, "flash_attention": FA_SOURCE, "flash_attention_bwd": FA_BWD_SOURCE,
               "embedding_bag": BAG_SOURCE}
    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc a source, all at once
        libs = dict(zip(sources, pool.map(build_library, sources)))
    say("build", sources=list(sources.values()), libraries=[p.name for p in libs.values()],
        seconds=time.perf_counter() - t0)

    t0 = time.perf_counter()
    graph = table2_workloads(scale=scale, seed=args.seed, names=("amazon",))["amazon"]
    small = table2_workloads(scale=scale * 0.05, seed=args.seed, names=("amazon",))["amazon"]
    say("graph", workload="amazon", scale=scale, nodes=graph.num_nodes, edges=graph.num_edges,
        host_seconds=time.perf_counter() - t0)

    timer = Timer()
    kern = phase_kernels(device, graph, timer)
    phase_engine(device, graph, small)
    grid = dataclasses.replace(GRIDS["paper"], name="paper-amazon", workloads=("amazon",),
                               scale=scale, seed=args.seed)
    _, launches = phase_sweep(device, grid, graph, info["nvidia_smi"])
    cgrid = dataclasses.replace(GRIDS["backpressure"], name="backpressure-amazon", workloads=("amazon",),
                                scale=scale, seed=args.seed)
    _, noc_launches = phase_contention(device, cgrid, graph, info["nvidia_smi"])
    fgrid = dataclasses.replace(GRIDS["faults"], name="faults-amazon", workloads=("amazon",),
                                scale=scale, seed=args.seed)
    _, faults_launches = phase_faults(device, fgrid, graph, info["nvidia_smi"])
    gnn, gnn_launches = phase_gnn(device, graph, args.seed, info["nvidia_smi"], timer)
    torch.cuda.empty_cache()
    dist_out, dist_launches = phase_distributed(device, graph, args.seed, info["nvidia_smi"], timer)
    del small  # the graph stays for the mesh_train phase
    _, cli_launches = phase_cli(info["nvidia_smi"])
    torch.cuda.empty_cache()
    attn = phase_attention(device, timer)
    _, fa_launches = phase_serve(device, args.seed, info["nvidia_smi"])
    torch.cuda.empty_cache()
    _, train_launches = phase_train(device, args.seed, info["nvidia_smi"], timer)
    bag = phase_bag(device, args.seed, timer)
    _, bag_launches = phase_recsys(device, args.seed, info["nvidia_smi"], timer)
    gc.collect()
    torch.cuda.empty_cache()
    moe, moe_attn = phase_moe(device, args.seed, info["nvidia_smi"], timer)
    gc.collect()  # the serve weights, before the training state
    torch.cuda.empty_cache()
    _, moe_train_launches = phase_moe_train(device, args.seed, info["nvidia_smi"], timer)
    gc.collect()  # the training state, before the mesh paths' weights
    torch.cuda.empty_cache()
    mesh, bag_site = phase_mesh_models(device, args.seed, info["nvidia_smi"], timer)
    gc.collect()
    torch.cuda.empty_cache()
    perm = np.asarray(dist_out["mapper"]["site_permutation"])
    _, train_mesh, halo_site = phase_mesh_train(device, graph, perm, args.seed, info["nvidia_smi"], timer)
    gc.collect()
    torch.cuda.empty_cache()
    dense, dense_launches = phase_mesh_dense(device, args.seed, info["nvidia_smi"], timer)
    gc.collect()
    torch.cuda.empty_cache()
    serve_tp, serve_tp_launches = phase_mesh_dense_serve(device, args.seed, info["nvidia_smi"], timer)
    gc.collect()
    torch.cuda.empty_cache()
    serve_moe, serve_moe_launches = phase_mesh_moe_serve(device, args.seed, info["nvidia_smi"], timer)
    gc.collect()
    torch.cuda.empty_cache()
    moe_fsdp, moe_fsdp_launches = phase_mesh_moe_fsdp(device, args.seed, info["nvidia_smi"], timer)
    gc.collect()
    torch.cuda.empty_cache()
    _, examples_launches = phase_examples(device, info["nvidia_smi"])
    gc.collect()
    torch.cuda.empty_cache()
    phase_roofline(device, graph, args.seed, info["nvidia_smi"])
    del graph
    say("done", seconds=time.perf_counter() - t_all)

    print(json.dumps({"kernels": [{
        "name": "ell_spmm", "route": "cuda", "source": KERNEL_SOURCE, "replaces": KERNEL_REPLACES,
        "launches": launches, "launches_contention": noc_launches, "launches_faults": faults_launches,
        "launches_cli": cli_launches,
        "max_abs_err": max(kern["max_abs_err_f32"], kern["real_bucket_max_abs_err"]),
        "max_abs_err_bf16": kern["max_abs_err_bf16"],
        "ms": kern["kernel_ms"], "call_ms": kern["kernel_call_ms"], "plain_ms": kern["ref_ms"],
        "bound_ms": kern["bound_ms"],
        "bound_by": kern["bound_by"], "library_ms": kern["library_ms"],
        "library_device_ms": kern["library_device_ms"], "per_bucket_reduce_ms": kern["per_bucket_reduce_ms"],
        "launches_per_reduce": kern["launches_per_reduce"], "entry": "segment_spmm_launch (every bucket, one launch)",
        "shape": "one PageRank reduce on amazon (every ELL bucket, PageRank weights) at D=1",
        "launches_gnn": gnn_launches, "launches_train": train_launches["segment_spmm"],
        "launches_distributed": dist_launches, "launches_mesh_train": train_mesh["segment_spmm"],
        "launches_examples": examples_launches["segment_spmm"],
        "halo_transpose": {"shape": f"the transposed reduce of the halo GIN's backward on amazon over {DIST_ENGINES} "
                                    "stacked engines: the transpose of the extended rows' block-diagonal ELL, weights "
                                    "1, D=64, f32", **halo_site},
        "distributed": {
            "pagerank_partials": {"shape": f"{DIST_ENGINES} stacked engines' PageRank partials on amazon (powerlaw "
                                           "partition): one block-diagonal ELL, PageRank weights, D=1, f32",
                                  **dist_out["reduce_call_sites"]["pagerank_partials"]},
            "halo_gin": {"shape": f"gin-tu's halo sum on amazon over {DIST_ENGINES} stacked engines: the extended "
                                  "rows' block-diagonal ELL, weights 1, D=100, f32",
                         **dist_out["reduce_call_sites"]["halo_gin"]}},
        "gin_transpose": {"shape": f"the transposed reduce of gin-tu's backward on amazon (ELL of the unreversed "
                                   f"edges, weights 1) at D={gnn['amazon']['train']['transpose_reduce']['D']}, f32",
                          **{k: gnn["amazon"]["train"]["transpose_reduce"][k] for k in (
                              "ms", "call_ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                              "library_device_ms", "max_abs_err_vs_library", "max_abs_err_vs_plain")}},
        "gin": {"shape": f"GIN's neighbour sum on amazon ({gnn['amazon']['nodes']:,} nodes, "
                         f"{gnn['amazon']['edges']:,} edges, ELL of the reversed edges, weights 1), f32",
                **{k: {f: r[f] for f in ("D", "ms", "call_ms", "no_hub_ms", "plain_ms", "bound_ms", "bound_by",
                                         "library_ms", "library_device_ms", "scatter_ms", "max_abs_err_vs_plain",
                                         "max_abs_err_vs_library", "max_abs_err_vs_scatter")}
                   for k, r in gnn["amazon"]["reduce"].items()}},
    }, {
        "name": "flash_attention", "route": "cuda", "source": FA_SOURCE, "replaces": FA_REPLACES,
        "launches": fa_launches,
        "max_abs_err": max(attn["max_abs_err_f32"], attn["max_abs_err_bf16"], attn["path_max_abs_err"]),
        "max_abs_err_f32": attn["max_abs_err_f32"],
        "ms": attn["kernel_ms"], "call_ms": attn["kernel_call_ms"], "plain_ms": attn["ref_ms"],
        "bound_ms": attn["bound_ms"], "bound_by": attn["bound_by"], "library_ms": attn["library_ms"],
        "library_device_ms": attn["library_device_ms"], "achieved_tflops": attn["achieved_tflops"],
        "shape": f"llama3.2-3b prefill attention: q (1, {ATTN_TIMED_S}, 24, 128), k/v (1, {ATTN_TIMED_S}, 8, 128) "
                 "bf16, causal",
        "launches_train": train_launches["flash_attention"],
        "launches_moe": moe["olmoe"]["flash_attention_launches"],
        "launches_moe_qwen": moe["qwen"]["flash_attention_launches"],
        "moe_shape": moe_attn,
        "launches_moe_train": moe_train_launches["flash_attention"],
        "launches_moe_train_qwen": moe_train_launches["flash_attention_qwen"],
        "launches_mesh_moe_serve": serve_moe_launches["olmoe"],
        "launches_mesh_moe_serve_qwen": serve_moe_launches["qwen"],
        "launches_mesh_train": train_mesh["flash_attention"], "launches_mesh_train_qwen": train_mesh["flash_attention_qwen"],
        "launches_mesh_dense": dense_launches["flash_attention"],
        "launches_mesh_dense_serve": serve_tp_launches,
        "launches_mesh_moe_fsdp": moe_fsdp_launches["olmoe"],
        "launches_mesh_moe_fsdp_train": moe_fsdp_launches["train"]["flash_attention"],
        "launches_examples": examples_launches["flash_attention"],
    }, {
        "name": "flash_attention.tp", "route": "cuda", "source": FA_SOURCE, "replaces": FA_REPLACES,
        "launches": dense_launches["flash_attention"],
        "max_abs_err": dense["attention_tp_shape"]["forward"]["max_abs_err"],
        **{k: dense["attention_tp_shape"]["forward"][k] for k in ("ms", "call_ms", "plain_ms", "bound_ms", "bound_by",
                                                                   "library_ms")},
        "shape": f"llama3.2-3b's tp_sp training attention on {MESH_SHAPE} (every engine's rows and its 3 of 24 query "
                 f"and 1 of 8 kv heads folded into the batch): q {tuple(dense['attention_tp_shape']['q'])}, k/v "
                 f"{tuple(dense['attention_tp_shape']['k'])} bf16, causal; library: scaled_dot_product_attention",
        "backward": {"source": FA_BWD_SOURCE, "launches": dense_launches["flash_attention_bwd"],
                     **dense["attention_tp_shape"]["backward"]},
    }, {
        "name": "flash_attention.tp_prefill", "route": "cuda", "source": FA_SOURCE, "replaces": FA_REPLACES,
        "launches": serve_tp_launches,
        **{k: serve_tp["attention_tp_prefill_shape"]["path"][k] for k in (
            "max_abs_err", "ms", "call_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "shape": f"llama3.2-3b's tp_sp one-slot prefill attention on {MESH_SHAPE} (the prompt held once along "
                 "\"data\", every model engine's 3 of 24 query and 1 of 8 kv heads folded into the batch): q "
                 f"{tuple(serve_tp['attention_tp_prefill_shape']['path']['q'])}, k/v "
                 f"{tuple(serve_tp['attention_tp_prefill_shape']['path']['k'])} bf16, causal; library: "
                 "scaled_dot_product_attention",
        "both_data_engines": serve_tp["attention_tp_prefill_shape"]["both_data_engines"],
    }, {
        "name": "flash_attention.tp_ep_prefill", "route": "cuda", "source": FA_SOURCE, "replaces": FA_REPLACES,
        "launches": serve_moe_launches["olmoe"],
        **{k: serve_moe["attention_tp_ep_prefill_shape"][k] for k in (
            "max_abs_err", "ms", "call_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "shape": f"olmoe-1b-7b's one-slot prefill attention under tp_sp with EP on {MESH_SHAPE} (the prompt held once "
                 "along \"data\", every model engine's 2 of 16 query and kv heads folded into the batch): q "
                 f"{tuple(serve_moe['attention_tp_ep_prefill_shape']['q'])}, k/v "
                 f"{tuple(serve_moe['attention_tp_ep_prefill_shape']['k'])} bf16, causal; library: "
                 "scaled_dot_product_attention",
    }, {
        "name": "flash_attention.fsdp_ep", "route": "cuda", "source": FA_SOURCE, "replaces": FA_REPLACES,
        "launches": moe_fsdp_launches["olmoe"] + moe_fsdp_launches["train"]["flash_attention"],
        "launches_drain": moe_fsdp_launches["olmoe"], "launches_train": moe_fsdp_launches["train"]["flash_attention"],
        "max_abs_err": moe_fsdp["attention_fsdp_train_shape"]["forward"]["max_abs_err"],
        **{k: moe_fsdp["attention_fsdp_train_shape"]["forward"][k] for k in (
            "ms", "call_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "shape": f"olmoe-1b-7b's fsdp training attention on {MESH_SHAPE} (each engine's one row with all 16 query "
                 "and kv heads, every engine's folded into the batch): q "
                 f"{tuple(moe_fsdp['attention_fsdp_train_shape']['q'])}, k/v "
                 f"{tuple(moe_fsdp['attention_fsdp_train_shape']['k'])} bf16, causal; library: "
                 "scaled_dot_product_attention; the drain's one-slot prefills are the moe phase's shape",
        "backward": {"source": FA_BWD_SOURCE, "launches": moe_fsdp_launches["train"]["flash_attention_bwd"],
                     **moe_fsdp["attention_fsdp_train_shape"]["backward"]},
    }, {
        "name": "flash_attention_bwd", "route": "cuda", "source": FA_BWD_SOURCE,
        "replaces": FA_REPLACES + " (its gradient: the TPU kernel has none; the reference differentiates "
                    "its attention by autodiff)",
        "launches": train_launches["flash_attention_bwd"],
        "max_abs_err": attn["backward"]["max_abs_err"],
        "max_rel_err_f32": attn["backward"]["max_rel_err_f32"], "max_rel_err_bf16": attn["backward"]["max_rel_err_bf16"],
        **{k: attn["backward"]["timed"]["train"][k] for k in ("ms", "call_ms", "plain_ms", "bound_ms", "bound_by",
                                                              "library_ms", "tflops", "kernels_ms")},
        "shape": "llama3.2-3b training attention: q (8, 128, 24, 128), k/v (8, 128, 8, 128) bf16, causal; "
                 "library: the backward of scaled_dot_product_attention",
        "kernel_route": attn["backward"]["route_bf16"],
        "kernel_resources": attn["backward"]["kernel_resources"],
        "serve_shape": {k: attn["backward"]["timed"]["serve"][k] for k in (
            "q", "ms", "call_ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "tflops", "kernels_ms")},
        "launches_moe_train": moe_train_launches["flash_attention_bwd"],
        "launches_moe_train_qwen": moe_train_launches["flash_attention_bwd_qwen"],
        "launches_mesh_train": train_mesh["flash_attention_bwd"],
        "launches_mesh_train_qwen": train_mesh["flash_attention_bwd_qwen"],
        "launches_mesh_dense": dense_launches["flash_attention_bwd"],
        "launches_mesh_moe_fsdp": moe_fsdp_launches["train"]["flash_attention_bwd"],
        "launches_examples": examples_launches["flash_attention_bwd"],
        "moe_train_shape": {"shape": "olmoe-1b-7b training attention: q/k/v (8, 128, 16, 128) bf16, causal",
                            **{k: attn["backward"]["timed"]["moe_train"][k] for k in (
                                "ms", "call_ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "tflops",
                                "max_rel_err_vs_plain", "kernels_launched_a_call", "consumer_groups")}},
    }, {
        "name": "embedding_bag", "route": "cuda", "source": BAG_SOURCE, "replaces": BAG_REPLACES,
        "launches": bag_launches,
        "max_abs_err": max(bag["max_abs_err_f32"], bag["path_max_abs_err"], bag["grad_max_abs_err"]),
        "max_abs_err_bf16": bag["max_abs_err_bf16"],
        **{k: bag["path"]["single_hot"][k] for k in ("ms", "call_ms", "plain_ms", "bound_ms", "bound_by",
                                                      "library_ms")},
        "shape": f"dcn-v2 lookup: tables (26, 1000000, 16) f32, ids ({BAG_PATH_BATCH}, 26, 1) Zipf(1.1), "
                 "no weights",
        "multi_hot_weighted": {k: bag["path"]["multi_hot_weighted"][k] for k in (
            "B", "L", "ms", "call_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "launches_mesh_models": mesh["dcn"]["serve_bulk"]["embedding_bag_launches"]
        + mesh["dcn"]["train"]["psum_model"]["embedding_bag_launches"],
        "psum_model": bag_site, "launches_mesh_train": train_mesh["embedding_bag"],
    }]}), flush=True)
    print(info["nvidia_smi"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
