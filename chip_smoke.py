#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py [--model] [--top1] [--nearest] [--families [NAMES]] [--train]
                          [--layout] [--dryrun] [--hash] [--near-tie] [--examples]
                          [--bwd-rows] [--d256-rows] [--norm-rope] [--src DIR]

Builds the hand-written kernels from ``src/repro_torch/kernels/csrc/`` (into
``build/kernels/``), holds each kernel against its plain PyTorch version on
the card, and drives the port's paths, each with the launch counts set to 0
just before it and read just after:

* serve: two replicas behind a router with 100k-entry stores and a stub
  executor (the reuse decision: K1, K3, K4a);
* store: the store's fused-query acceptance configuration (250k entries),
  fused against staged;
* nearest: ``ops.nearest_neighbor`` over a 250k-row store (K5);
* model: qwen3-1.7b at full width and depth (28 layers, bf16, random
  weights from a seed) prefills 4 prompts of 2048 tokens and decodes 16
  greedy tokens (K6 on every layer of the prefill, K7 on every layer of
  each step, the fused norm twice a layer and once more at the end, the
  fused bias, qk-norm and rotation once a layer), held against the plain
  attention and a longer prefill;
* model-serve: two replicas whose misses run that model's prefill
  (``launch/serve.py``'s executor), with mixed near-duplicate and fresh
  traffic;
* async-serve: the serve launcher's traffic (200 requests of the ``cctv1``
  stream, 32-token prompts, threshold 0.9, Poisson arrivals at 200 req/s on
  the virtual clock, batches of up to 8 within 5 ms, wall-time execution) on
  two fresh replicas of that model, through ``AsyncServingEngine`` and
  through ``ServingFleet.submit`` (K4a once a request, K6 28 times a miss
  group; a staged store query scores with K3 where its gather work reaches
  ``use_kernel_threshold``, else on the host, as the reference routes it:
  K3's launches equal those queries); then the async benchmark's two
  straggler configurations (``load200/batch8``, ``load1000/batch32``) on
  the card with a stub executor, held equal to
  ``BENCH_async_serving.json`` and, where every query scored on the host,
  request by request to a CPU run; then ``launch/serve.py``'s ``main``
  with ``--engine async`` and ``sync``;
* cosim: the network simulator with its reuse stores on the card — the
  seeded traces of tests/test_cosim.py (stub services) held to their pinned
  summaries and task by task to a CPU run (a record scored on the host bit
  for bit, one scored by K3 or K1 within ``COSIM_SIM_TOL``),
  ``BENCH_cosim.json``'s rows at
  200 req/s, then ``launch/serve.py``'s co-simulation (``build_cosim``: the
  testbed's two ENs, each with two replicas of that model behind an
  ``EngineBackend``, 200 ``cctv1`` tasks at 200 req/s, an 8 ms EN window;
  K4a per client hash, admission and insert, K3 per staged store query
  whose gather work reaches ``use_kernel_threshold``, K6 28 times a model
  execution), and its ``main --engine cosim --trace-out``;
* federation: federation and faults with the stores on the card — the arms
  of the federation, migration and fault-recovery benchmarks (stub services:
  6 ENs under the three offload policies and load-driven rebalance, store
  migration on re-partition and under the autoscaler, link loss, an EN
  crash, an empty fault plan), each held task by task to its CPU run (as
  phase cosim holds its records) and to the reference's row; then
  ``build_cosim`` with a federator (``--offload-policy least-loaded`` and
  ``reuse-affinity``: an EN's miss may run on, or be answered by, the other
  EN; peeks scored as every staged query, K6 28 times a model execution on
  either EN), and ``main --engine cosim --offload-policy reuse-affinity``;
* near-tie: the store's scoring route at near-ties: 1000 groups of 8 unit
  rows at dim 64, 1e-6 around a common base (a numpy seed; the count of
  groups whose best row differs between a plain dot and the cosine is
  printed and must be at least 10), inserted into a store on the card and
  one on the CPU (``LSHParams(dim=64, num_tables=5, num_probes=8)``);
  scalar ``query`` and staged ``query_batch`` at B = 1 (gather work below
  ``use_kernel_threshold``: host cosine, bit-equal to the CPU) and B = 8,
  32 (above it: K3, one launch a batch, similarities within
  ``SCORE_TOL``; ids may differ within a group, whose rows are ties for
  any dot, so this half shows the route and not K3's choice of row, which
  phases top1 and serve hold); then K3 on the scalar queries' candidates
  against the plain ``gather_top1`` on the same ids, and how many of those
  queries K3's dot would have answered with another row than the cosine;
* examples: the port's three examples (``examples/torch_*.py``) on the
  card against their CPU runs: quickstart's summary equal, the cognitive
  assistant's hits by kind, executions per replica and re-partition equal
  (both from the same CPU-drawn weights, at a fixed virtual execution time
  of 50 ms set through the fleet engine's ``exec_time_fn``; K6 once a
  layer a prefill),
  and train_lm's 5 steps at its default width 512 with finite losses, the
  first step's loss, grad norm and lr within ``TRAIN_F32_REL_TOL`` of a
  CPU step from the same weights (exact K6 launches);
* families: the other model families at full width, one model at a time,
  each with its own seeded random weights (bf16): qwen2-moe-a2.7b (24
  layers), zamba2-7b (81), xlstm-125m (12), seamless-m4t-large-v2 (24 + 24,
  1024 frames), phi-3-vision-4.2b (32, 576 patch embeddings),
  llama4-maverick-400b-a17b at depth 1 (1024 patch embeddings), gemma-2b
  (18, MQA, head width 256), gemma2-9b (42: local layers with a
  4096-slot ring buffer, softcaps; one prompt of 4608 tokens, so that the
  ring wraps in the prefill and again in decode) and qwen2.5-14b (48); each
  prefills 2 prompts of 1535 text tokens and decodes 8 greedy tokens, with
  the exact K6 and K7 launch counts, its first and last K6 call of the
  prefill and K7 call of decode step 1 held against the plain attention,
  decode step 1 against a prefill of prompt + token (for an MoE model only
  where neither prefill dropped a token past capacity, the drops printed;
  for zamba2 in float32, where bf16 rounding grows past the limit through
  its depth, the bf16 gap printed beside that of a run with plain
  attention), and the prefill and first step
  against a run of the same model with the attention ops swapped for their
  plain versions (an MoE model routed as the kernels' run was);
* train: (a) K6's backward (``csrc/flash_attention_bwd.cu``: delta, dK/dV,
  dQ; bf16 on the tensor cores, D=256 in two column halves) and the
  forward's log-sum-exp against their plain versions in f32 and bf16 (head
  widths 32 to 256, G from 1 to 8, causal, window, softcap, S != T, ragged
  S, rows that see no key; at D=256 gemma2-9b's masks and gemma-2b's MQA),
  then at qwen3-1.7b's training shape (B=4, S=2048, bf16, causal),
  each entry point timed with its bound and the three beside SDPA's
  backward; (b) the reduced qwen3 in float32 on the
  card against the same seeded run on the CPU: every parameter's gradient
  (none zero), then three train steps (loss, grad norm, lr, parameters),
  also with 2 microbatches and int8 moments; (c) 2 steps, a checkpoint, a
  restore into a fresh state and 2 more equal 4 uninterrupted steps bit
  for bit; (d) ``launch/train.py``'s ``main`` at full width (on its 1 x 1
  host mesh; qwen3-1.7b, 28 layers, fp32 masters, remat block, B=4 x 2048
  tokens, 4 steps) with
  its exact K6 counts (56 forward launches a step with the recompute, 28
  of each backward kernel), ms a step and peak memory, then 3 steps on
  one repeated batch (the loss must fall) and the idle share of a step;
  (e) every other family's reduced config (zamba2, xlstm, seamless,
  qwen2-moe, phi-3-vision, llama4, gemma-2b, gemma2-9b, qwen2.5-14b) in
  float32 on the card against the same
  seeded model on the CPU: exact K6 launches (derived from depth and
  remat: ``train_launches``), every gradient non-zero and within 1e-4 (an
  MoE model's CPU run routed as the card's), and a restart of the reduced
  zamba2 bit for bit; (f) full-width steps of each family that fits one
  card (B=4 x 2048 synthetic tokens, fp32 masters, bf16 activations, f32
  moments, each config's remat): xlstm-125m and seamless at full depth
  through ``launch/train.py``'s ``main``, as are phi-3-vision and
  gemma-2b (they fit at full depth too), zamba2, qwen2-moe and gemma2-9b
  cut in depth only (``TRAIN_FAM_DEPTH``) through ``make_train_step``;
  exact K6 counts, finite losses, ms a step, peak memory, a profiled
  step's idle share and device ops, and K6's backward at each family's
  attention shape (D=256 at gemma-2b's MQA and gemma2-9b's softcap, 112,
  96, 128, and 64 with and without the causal mask) against its plain
  version, its bound and SDPA's backward (its backend named).  llama4
  takes no full-width step (one layer's experts are about 16 B
  parameters), nor qwen2.5-14b (236 GB of training state);
* layout: (a) K6 with ``q_offset`` at qwen3-1.7b's attention shape (B=4,
  H=16, KV=8, D=128, causal) in bf16 and f32: 512-row chunks at q_offset
  0, 512 and 1536 (T = q_offset + 512), each against its plain version,
  timed beside SDPA with the chunk's mask, its bound over the (row, key)
  pairs the mask keeps; a window of 256 with softcap 50 at 1536; the four
  chunks of a 2048-token prompt against one call; the backward at 1536
  against its plain version; (b) qwen3-1.7b's 4 x 2048 prefill at full
  width and depth through ``attn_impl="blocked"`` (``blocked_attention``,
  28 K6 launches, counted from 0 around the blocked prefill alone), logits
  and cache bit-equal to the default route's; (c) ``launch/train.py``'s
  ``main`` at full width on its host mesh (1 x 1, nccl, where
  ``distribute`` leaves the state plain; 4 steps, the exact K6 counts of
  (d), counted from 0 around ``main`` alone), then 4 steps of
  ``make_train_step`` from the same state on plain tensors and on DTensors
  of the 1 x 1 mesh: the launcher's and the DTensors' losses and grad
  norms against the plain ones (bit-equal, or within 1e-6 relative), ms a
  step and a profiled step's idle share each way (what DTensor's dispatch
  would cost on one card); (d) one qwen2-moe MoE block at full width (d =
  2048, 60 experts, top-4, expert width 1408, 4 shared experts, bf16,
  seeded weights) on 16 x 2048 tokens in 16 dispatch groups, in ``ep``
  (experts over "data") on DTensors of the 1 x 1 mesh, through the expert
  parallel route (each rank's own groups routed, the buffer moved to the
  experts by all-to-all and back), against the same block on plain
  tensors: output, aux loss and the gradients of the input and every
  weight bit-equal; ms a call (forward and backward) and a profiled call's
  idle share each way, and the collectives the DTensor call dispatched;
  (e) llama4's attention at full width (B=1, S=2048, 40 q heads, 8 kv
  heads, D=128, bf16, causal) in the q-head slices of a 16-way "model" axis
  (3 heads on ranks 0-12, 1 on 13, none on 14-15), each through
  ``ops.head_slice_attention`` as a rank of a mesh runs it: the slices
  concatenated against one K6 call (bit-equal or not) and its plain
  version, their backward (dQ concatenated, dK and dV summed) against the
  whole call's, K6's launches counted from 0 (none for an empty slice), the
  slices' ms against the one call's, one SDPA call's (``enable_gqa``,
  forward, and forward with backward) and the plain version's; seamless's
  cross entropy (d=1024, 256206 rows, 2048 bf16 tokens) in the
  vocabulary's 16 chunks, each through the functions a rank runs
  (``layers.vocab_chunk``, ``chunk_max``, ``chunk_sum_gold``), lse and
  gold against ``layers.lse_gold`` of the whole logits; (f) one of
  zamba2-7b's Mamba2 layers at full width (B=1, S=2048, 112 heads of 64)
  in the head slices of a 16-way "model" axis (7 heads each, as a rank of
  a mesh computes them: its in_proj columns and conv channels, the gated
  norm's sum of squares summed over the slices, the partial outputs
  summed; ``ssm.mamba2_slices``) against the whole layer, in f32 and bf16,
  its f32 gradients, a decode step whose conv buffer moves from the
  cache's 456-channel chunks to the slices and back, a group (6 Mamba2
  layers and the shared block, its 32 q heads through K6 in 16 slices of
  2, K6's launches counted from 0 around the sliced bf16 group) against
  the whole group, one layer through ``ssm.mamba2_sharded`` on DTensors
  of the 1 x 1 mesh bit-equal to plain tensors (output and every
  gradient), and the slices' ms against the whole layer's, with launches
  and on the device; (g) the MoE block of (d) without dispatch groups, in
  ``fsdp`` on DTensors of the 1 x 1 mesh (every token routed on every
  rank, each rank's experts over its chunk of their hidden,
  ``moe._split_hidden``, once a call) against plain tensors: bit-equal as
  in (d), ms a call and idle share each way; (h) zamba2-7b's decode at
  batch 1 as its ``long_500k`` cell splits it: K7 on one rank's share of
  the shared attention's cache (B=1, 32768 bf16 slots, H=KV=32, D=112,
  f32 q, kv_len 30001) in 16 head slices of 2, each through
  ``ops.decode_head_slice`` on strided views with lse (as a rank of a
  16-way "data" axis runs it), concatenated: bit-equal to one call at the
  slices' split, within 1e-5 of one call at its own plan and of the plain
  version, one slice's device ms against the whole call's (K7's launches
  counted from 0 around the 16 slices); then a full-width zamba2-7b decode
  step (bf16, seeded weights, a seeded 32768-slot cache at position 30000,
  3 steps) on DTensors of the 1 x 1 mesh (parameters placed in ``fsdp``,
  the cache as ``cache_shardings``) against plain tensors: logits and the
  cache bit-equal, ms a step and a profiled step's idle share each way, 13
  K7 launches a step;
* dryrun: (a) K7 with ``return_lse`` against its plain version at
  decode_row's shape, then qwen3-1.7b's decode cache (B=8, H=16, KV=8,
  D=128, a bf16 cache of 32768 slots, ragged kv_len) cut into 16 shards,
  K7 with lse on each (q in f32) merged by ``decode_attention.combine``
  (what ``ops.sharded_decode_attention`` runs over a 16-way "model" axis)
  against one call: out within 1e-5 of max |out|, lse within 1e-5; K7's
  time with and without lse and the combine's; (b)
  ``launch/hlo_analysis.py`` on phase train's full-width qwen3-1.7b step on
  fake CUDA tensors and on the card: FLOPs equal, the fake peak within 10 %
  of ``max_memory_allocated``, the roofline terms beside the step's time;
  (c) ``launch/dryrun.py``'s CLI on qwen3-1.7b's four cells on the 16 x 16
  mesh with fake CUDA tensors in a fake world of 256 ranks (the phase runs
  last: the process group of phase layout is ended first), then on
  qwen2-moe's ``prefill_32k`` and ``decode_32k`` in ``ep`` with 16
  dispatch groups, then on llama4's (the same way) and gemma-2b's
  ``prefill_32k`` (40 and 8 q heads, which 16 does not divide) and
  zamba2-7b's ``prefill_32k`` and ``decode_32k`` (Mamba2's heads split
  over "model"), and qwen2-moe's and llama4's ``decode_32k`` in ``fsdp``
  without dispatch groups (each rank's experts over its chunk of their
  hidden, the shared MLP's contraction split over "model"), each cell
  ok, no kernel launched, the ``ep`` MoE cells with an all-to-all among
  their collectives, the head cells' and the ``fsdp`` MoE cells' FLOPs
  between the useful FLOPs a chip and 1.5 x the reference's; then
  zamba2-7b's, seamless's and xlstm-125m's ``long_500k`` (a batch of 1,
  decoded under ``embed_split``), each cell's FLOPs equal to the CLI's with
  fake CPU tensors on a CPU host and its FLOPs and collective bytes within
  the limits of ``DRYRUN_B1_LIMITS``.

It prints one line per phase with its seconds, the card's name and power
limit, one JSON line ``{"kernels": [...]}`` with each kernel's launches on
its path, its launches on the async-serve, cosim, federation, near-tie,
examples and families paths, error against its plain
version, time, plain time, bound and the time of one PyTorch library call
computing the same function (where there is one), and last
``{"ok": true, "device": {...}}``.  K4b's path is its caller
``ops.lsh_hash_ids`` at the serving hash shape.  Kernel times are
CUDA-event medians of single calls, each with its launch.  The two attention
kernels and their library calls also give ``device_ms`` and
``library_device_ms``: device time per call over a CUDA graph of 20 calls,
which leaves out the host's time to enqueue a call (longer than the kernel
itself at these shapes) and re-reads inputs that may sit in L2.  The build
line gives the attention kernels' wgmma and TMA instruction counts and their
registers and spills, and the sim_topk kernels' (which must not spill); it
fails if K6's bf16 forward or backward kernels spill, if the backward's
have no wgmma or TMA load, or if K6's D=256 forward is not its one
two-warpgroup, 64-key instance (``fwd_ptxas``).
K3 is timed at the staged path's batches B in {1, 8, 32} (``b1_*``,
``b8_*`` beside the B=32 row) and by candidates a block; K5 adds
``device_ms`` over a CUDA graph, its TFLOP/s and its share of the bound.
K6 and K7 are also timed at the head widths 112 and 96 (zamba2's and
phi-3-vision's prefill and decode shapes: ``d112_*``, ``d96_*``) and 256
(``d256``: gemma-2b's prefill and decode, gemma2-9b's windowed, soft-capped
prefill, its decode and its full ring), after the D=256 variants against
their plain versions (``d256_variants``: K6 at G in {1, 2, 8}, window and
softcap, ragged S and T, q_offset, the forward with lse, rows without a
key, 4096 positions; K7 at kv_len 0, 1, 15, 16, 17, 31, 32, 33, 63, 64,
65 and T, at its plan and a forced split, bit-equal again, and a full
ring).  The
backward's rows (``flash_attention_bwd_*``) are launches on the train path
(d), each entry point's ms a launch (CUDA events) and ``device_ms``, its
route (``kernel_route``) and the TFLOP/s of the products its outputs need
(``tflops``) and of those it issues (``issued_tflops``); the dK/dV row adds
the whole backward's times (``whole_backward_ms``, one wrapper call, and
``whole_backward_device_ms``) and SDPA's (``library_backward_ms`` and
``library_backward_device_ms``, from torch.profiler's kernel times: a
graph does not capture autograd's backward; also the dK/dV and dQ rows'
``library_ms`` and ``library_device_ms``), and ``family_backward``: the
same whole-backward times, bound and SDPA times at each family's training
shape (phase train (f)), with its calls a step.  ``train_families_launches``
counts each kernel's launches in (f), ``layout_blocked_launches``,
``layout_train_launches``, ``layout_heads_launches``,
``layout_mamba_launches`` and ``layout_batch1_launches`` in phase layout
(b), (c), (e), (f) and (h) (the head slices and the DTensor steps); K6's row
adds ``mamba_split`` ((f): the slices' errors, gradients, decode step,
group, K6 launches, the 1 x 1 mesh's bit-equality and the times),
``head_split`` ((e): the slices' heads,
errors, times, bound and launches, SDPA's and the plain version's times
beside them (``library_*``, ``plain_ms``), and ``vocab_split``),
``q_offset_chunks`` (each chunk of (a): its offset, dtype, visible pairs,
times, bound and error), ``q_offset_concat_max_err``,
``q_offset_bwd_max_err`` and ``layout_train`` ((c): ms a step and
profiled device time, each way).  ``dryrun_launches`` counts each
kernel's real launches in phase dryrun (a) and (b); K7's row adds
``lse_max_abs_err``, ``split`` ((a): the split's errors, K7's times with
and without lse, the combine's, bounds), ``analysis`` ((b)) and
``dryrun_cells`` ((c): each cell's seconds, per-device bytes, FLOPs and
dominant term), ``batch1_slices`` and ``batch1_step`` (phase layout (h):
errors, bit-equality, grids, times and bounds).
Any failure exits non-zero before the last line.
Without a CUDA card it exits non-zero at once.  Imports nothing of JAX or of
the JAX package.

``--model``, ``--top1``, ``--nearest``, ``--families``, ``--train``,
``--layout``, ``--dryrun``, ``--hash``, ``--near-tie``, ``--examples``,
``--bwd-rows``, ``--d256-rows`` and ``--norm-rope``
run only the env and build phases and the named ones (the
model's prefill and decode; K3 at B in {1, 8, 32} and K1's id route on the
wrappers; ``nearest_neighbor`` first and warm; the families, or those of a
comma-separated list of names after the flag; phase train; phase layout;
phase dryrun; ``phase_hash_repeat``: K4a, K4b and their plain versions
each held to the float64 vertex ids over many calls and seeds;
``--bwd-rows``: the backward's ptxas report, phase train (a)'s D=256 cases
and K6's backward at gemma-2b's and gemma2-9b's training shapes;
``--d256-rows``: K6's forward ptxas report, the D=256 variants, the d256
rows with ``flex_attention`` compiled as the softcapped rows' library,
and the D <= 128 rows whose plans stay the parent's: qwen3's K6 and K7
and zamba2's D=112 decode; ``--norm-rope``: the fused norm and rotary
kernels' ptxas report, their ulps from the plain chain and their times at
the qwen3-1.7b and qwen2.5-14b cells' prefill shapes, beside their bound,
the plain chain and ``F.rms_norm``)
and print no kernels or ok line; ``--src DIR`` takes the port from DIR (the ``src``
of another checkout or ``git archive`` of this repository) instead of this
checkout.  Running it for the parent and the change in turns (parent,
change, change, parent) on one card, one after another, compares two commits.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import importlib.util
import io
import json
import math
import subprocess
import sys
import tempfile
import time
import zlib
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# the port under test: this checkout's, or --src DIR's
SRC = Path(sys.argv[sys.argv.index("--src") + 1]).resolve() if "--src" in sys.argv[:-1] \
    else ROOT / "src"
sys.path.insert(0, str(SRC))

import networkx as nx  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core.edge_node import Service  # noqa: E402
from repro_torch.core.lsh import LSHParams, normalize, sample_params  # noqa: E402
from repro_torch.core.network import PaperDelayModel, ReservoirNetwork  # noqa: E402
from repro_torch.core.reuse_store import ReuseStore, scores_on_device  # noqa: E402
from repro_torch.core.sim_clock import EventLoop  # noqa: E402
from repro_torch.core.topology import testbed_topology  # noqa: E402
from repro_torch.data import DATASETS, dataset_service, make_stream  # noqa: E402
from repro_torch.data import dot_cosine_disagree, near_tie_trace  # noqa: E402
from repro_torch.faults import ChaosController, FaultPlan  # noqa: E402
from repro_torch.federation.policy import AutoscalePolicy  # noqa: E402
from repro_torch.kernels import build, lsh_hash, ops, ref, sim_topk  # noqa: E402
from repro_torch.kernels import decode_attention as decode_k  # noqa: E402
from repro_torch.kernels import flash_attention as flash_k  # noqa: E402
from repro_torch.launch.serve import LSH_PARAMS, build_cosim, make_executor  # noqa: E402
from repro_torch.launch.serve import main as serve_main  # noqa: E402
from repro_torch.launch.serve import make_request, make_service  # noqa: E402
from repro_torch.models import DecoderLM, build_model  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    AsyncServingEngine,
    EngineBackend,
    ReplicaEngine,
    ReuseRouter,
    ServeRequest,
    ServingFleet,
)
from repro_torch.training.elastic import BackupPolicy  # noqa: E402
from repro_torch.configs import ShapeSpec  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.launch.shardings import batch_shardings  # noqa: E402
from repro_torch.launch.shardings import state_shardings  # noqa: E402
from repro_torch.launch.train import main as train_main  # noqa: E402
from repro_torch.launch.train import synthetic_batch  # noqa: E402
from repro_torch.models import layers, partitioning, use_mesh  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import hlo_analysis  # noqa: E402
from repro_torch.training import (  # noqa: E402
    OptimizerConfig,
    adamw_init,
    init_state,
    make_train_step,
    restore,
    save,
)

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM bytes/s, fp32
# FLOP/s on the CUDA cores, and dense bf16 FLOP/s on the tensor cores (the
# bound of a bf16 function, whatever the kernel computes it with).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12
SCORE_TOL = 1e-5    # kernel vs plain similarity (fp32, different sum order)
TIE_MARGIN = 1e-5   # ids may differ only where the float64 margin is below
ATTN_F32_TOL = 2e-5  # attention kernel vs plain, fp32 (the JAX tests' tolerance)
# bf16 attention outputs: an absolute limit plus one bf16 ulp of the plain
# value (kernel and plain both round an fp32 result summed in another order,
# so they differ by at most one ulp and the fp32 order's ~1e-6).  The small
# variants keep the JAX tests' 2e-2; at the main path's shapes (S = 2048, a
# typical |output| of 0.03-0.05) the limit is 1e-3, so that a kernel reading
# a few slots past kv_len or one tile too many is caught.
ATTN_BF16_TOL = 2e-2
ATTN_BF16_MAIN_TOL = 1e-3
# qwen3 step-1 decode logits vs a prefill of prompt + token, both bf16
# through 28 layers: max |difference| within this share of max |logit|
DECODE_LOGIT_REL_TOL = 5e-2
# the same in float32 with a float32 cache (zamba2's check in phase
# families): only the order of fp32 sums differs (readings 1.5e-5 to 1.8e-5
# on the H100)
DECODE_LOGIT_F32_REL_TOL = 1e-4
# phase train: the backward kernels vs plain (fp32 sums of up to S * G
# products in another order), relative to the largest |value| of a tensor
# (bf16: plus one bf16 ulp of the plain value); the reduced model's train
# steps on the card vs the CPU (loss, grad norm, lr, and parameters
# relative to the largest |parameter|), and its gradients (each relative
# to its largest |value|, the CPU tests' limit against the reference)
BWD_REL_TOL = 2e-5
TRAIN_F32_REL_TOL = 1e-5
TRAIN_GRAD_REL_TOL = 1e-4

SOURCES = {
    "reuse_top1": ("src/repro_torch/kernels/csrc/sim_topk.cu",
                   "src/repro/kernels/sim_topk.py:293"),
    "reuse_top1_probed": ("src/repro_torch/kernels/csrc/reuse_probed.cu",
                          "src/repro/kernels/sim_topk.py:293"),
    "gather_top1": ("src/repro_torch/kernels/csrc/sim_topk.cu",
                    "src/repro/kernels/sim_topk.py:172"),
    "lsh_hash_mix": ("src/repro_torch/kernels/csrc/lsh_hash.cu",
                     "src/repro/kernels/lsh_hash.py:83"),
    "lsh_hash": ("src/repro_torch/kernels/csrc/lsh_hash.cu",
                 "src/repro/kernels/lsh_hash.py:104"),
    "sim_top1": ("src/repro_torch/kernels/csrc/sim_topk.cu",
                 "src/repro/kernels/sim_topk.py:91"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:101"),
    "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:86"),
    # K6's backward: the reference differentiates K6's math with jax.grad
    # (no pallas_call of its own); each entry point is listed as K6's
    **{f"flash_attention_bwd_{e}": ("src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                                    "src/repro/kernels/flash_attention.py:101")
       for e in ("delta", "dkdv", "dq")},
    # no pallas_call: the reference leaves these sites to XLA's fusion
    **{name: ("src/repro_torch/kernels/csrc/norm_rope.cu", "none (XLA fuses them on the TPU)")
       for name in ("rms_norm", "qk_rope")},
}
# kernel -> the path that must launch it (the id-matrix route of K1 is on
# none: the serve path's count of it, 0, is reported); the async-serve path
# must launch K4a and K6 too (each row reports its async_serve_launches).
# K3 is on a path only where its trace has a staged query whose gather work
# reaches use_kernel_threshold (the reference's route): serve's routed
# batches of 32 and the near-tie batches of 8 and 32; async-serve, cosim and
# federation score every query on the host (small stores, small windows),
# and their launch checks hold K3 to those queries' count
MAIN_PATH = {"reuse_top1_probed": "serve", "gather_top1": "serve", "lsh_hash_mix": "serve",
             "lsh_hash": "hash-ids", "sim_top1": "nearest", "flash_attention": "model",
             "decode_attention": "model", "flash_attention_bwd_delta": "train",
             "flash_attention_bwd_dkdv": "train", "flash_attention_bwd_dq": "train",
             "rms_norm": "model", "qk_rope": "model"}
ASYNC_PATH = ("lsh_hash_mix", "flash_attention")
COSIM_PATH = ("lsh_hash_mix", "flash_attention")
FEDERATION_PATH = ("lsh_hash_mix", "flash_attention")
NEAR_TIE_PATH = ("gather_top1",)
EXAMPLES_PATH = {"examples-quickstart": ("lsh_hash_mix",),
                 "examples-cognitive": ("lsh_hash_mix", "flash_attention"),
                 "examples-train": ("flash_attention", "flash_attention_bwd_delta",
                                    "flash_attention_bwd_dkdv", "flash_attention_bwd_dq")}
FAMILIES_PATH = ("flash_attention", "decode_attention")
TRAIN_FAMILIES_PATH = ("flash_attention", "flash_attention_bwd_delta", "flash_attention_bwd_dkdv",
                       "flash_attention_bwd_dq")
LAYOUT_PATH = {"layout-blocked": ("flash_attention",), "layout-train": TRAIN_FAMILIES_PATH,
               "layout-heads": TRAIN_FAMILIES_PATH, "layout-mamba": ("flash_attention",),
               "layout-batch1": ("decode_attention",)}

# sizes: phase 3 (kernels), phase 4 (serve), phase 5 (store)
HASH_B = 4096
ROUTED_B = 1024                            # a routed batch: the router hashes it
CROSSOVER_B = (64, 128, 256, 512, 1024)    # B·P/NB 2 .. 32 on the serve store
K3_BATCHES, K3_C = (1, 8, 32), 16384      # the staged path's batches (below fused_min_batch)
K3_CHUNKS = (512, 1024, 2048)              # candidates a block, timed at B=32
K1_Q, K1_C = 1024, 20480
STORE_ROWS, PAGE_SIZE = 100_000, 4096
SERVE_CAPACITY, SERVE_BATCH, SMALL_BATCH, SERVE_BATCHES = 100_000, 1024, 32, 4
ACC_STORE, ACC_BATCH = 250_000, 4096
REPS, PLAIN_REPS = 20, 5
# phase kernels (attention, K5); phase nearest; phases model, model-serve
ATTN_B, ATTN_S, ATTN_H, ATTN_KV, ATTN_D = 4, 2048, 16, 8, 128   # qwen3-1.7b
DECODE_STEPS = 16
PREFILL_REPS = 5                          # warm prefills timed after the first
DECODE_T = ATTN_S + DECODE_STEPS          # the model's cache window
NN_Q, NN_N, NN_TAIL = 4096, 250_000, 1000
SIM_GRAPH_REPS = 5                        # K5 calls a graph (a call takes milliseconds)
NEAREST_WARM = 5                          # warm nearest_neighbor calls timed after the first
MODEL_ARCH = "qwen3-1.7b"
# phase families: every other family at full width, one model at a time:
# prefill FAM_B x FAM_S text tokens (both S and S + 1 pass the Mamba2 chunk
# rule at scan_chunk 256: 5 x 307 and 6 x 256), FAM_STEPS greedy decode
# steps; seamless encodes FAM_FRAMES frames; llama4 at depth 1 (its 48
# layers, about 800 GB in bf16, do not fit one card).  The dense
# architectures come last, so that the seeds of the others stay; gemma2-9b
# prefills one prompt of 4608 tokens (FAM_SHAPE), so that its local
# layers' 4096-slot ring buffers wrap in the prefill and again in decode
FAMILIES = ("qwen2-moe-a2.7b", "zamba2-7b", "xlstm-125m", "seamless-m4t-large-v2",
            "phi-3-vision-4.2b", "llama4-maverick-400b-a17b", "gemma-2b", "gemma2-9b",
            "qwen2.5-14b")
FAM_B, FAM_S, FAM_STEPS, FAM_FRAMES, FAM_WARM = 2, 1535, 8, 1024, 2
FAM_SHAPE = {"gemma2-9b": (1, 4608)}      # (prompts, text tokens) where not FAM_B x FAM_S
FAM_DEPTH = {"llama4-maverick-400b-a17b": 1}
# decode step 1 against a longer prefill is held in float32 for zamba2: in
# bf16 its 81 Mamba2 layers and 13 attention blocks grow the rounding of
# GEMMs of other shapes (a step is M = 2 rows, a prefill 3072) beyond
# DECODE_LOGIT_REL_TOL (6.1 % on the H100).  The bf16 gap of the run with
# plain attention is printed beside the kernels' one.
FAM_F32_STEP_CHECK = ("zamba2-7b",)
# (K6 launches a prefill, K7 launches a decode step)
FAM_LAUNCHES = {"qwen2-moe-a2.7b": (24, 24), "zamba2-7b": (13, 13), "xlstm-125m": (0, 0),
                "seamless-m4t-large-v2": (72, 48), "phi-3-vision-4.2b": (32, 32),
                "llama4-maverick-400b-a17b": (1, 1), "gemma-2b": (18, 18),
                "gemma2-9b": (42, 42), "qwen2.5-14b": (48, 48)}
# phase kernels at the padded head widths (zamba2's 112, phi-3-vision's 96),
# at each model's heads: model -> tokens of its prefill (1535 text tokens;
# phi-3-vision's 576 patches besides)
PADDED_WIDTHS = {"zamba2-7b": FAM_S, "phi-3-vision-4.2b": FAM_S + 576}
MS_SEQ, MS_BATCH, MS_BATCHES = 32, 256, 4
# phase async-serve: the serve launcher's defaults (launch/serve.py), its CLI at
# the size the launcher's documented example runs
AS_DATASET, AS_REQUESTS, AS_RATE, AS_MAX_BATCH, AS_MAX_WAIT_S = "cctv1", 200, 200.0, 8, 0.005
AS_CLI_REQUESTS, AS_CLI_RATE = 40, 500.0
# phase train: the reduced model's steps and sequence length; launch/train.py
# at full width (qwen3-1.7b, B = ATTN_B, S = ATTN_S) for FULL_STEPS steps,
# then REPEAT_STEPS steps on one repeated batch
TRAIN_STEPS, TRAIN_S = 3, 32
FULL_STEPS, REPEAT_STEPS = 4, 3
# phase train (e): every other family's reduced config at f32, card vs CPU
# (FAMILIES, llama4 included); (f): a full-width step of each family that
# can take one on one card, B = ATTN_B x S = ATTN_S synthetic tokens,
# TRAIN_FAM_STEPS steps (the first timed apart).  xlstm-125m, seamless and
# phi-3-vision fit at full depth (peaks 27.4, 35.8 and 64.0 GB of the
# card's 85.0) and run through launch/train.py's main; the others are cut
# in depth only (16 bytes a parameter: fp32 masters, gradients and two f32
# moments), as deep as the measured peak allows: zamba2-7b to 5 groups of 6
# Mamba2 layers and the 3 tail layers (33 of 81: 76.9 GB; a group more adds
# 7.5 GB of state alone), qwen2-moe to 6 of 24 layers (74.5 GB; a layer
# more adds 9.1 GB).  llama4 takes no step: one layer's 128 experts are
# about 16 B parameters.  gemma-2b (K6's backward at D = 256, MQA) runs at
# full depth through main (peak 54.8 GB); gemma2-9b (D = 256, softcap 50,
# windowed local layers) is cut in depth only, to whole (local, global)
# pairs: 12 of 42 layers (78.5 GB; its tied 256000 x 3584 table is 14.7
# GB of state, a layer 3.2 GB more, activations the other ~26 GB at 12,
# so a pair more does not fit).  qwen2.5-14b takes no full-width
# step (its D = 128 backward is qwen3's route; 48 layers of 14.7 B
# parameters are 236 GB of state).
TRAIN_FAM_FULL = ("xlstm-125m", "seamless-m4t-large-v2", "phi-3-vision-4.2b", "gemma-2b")
TRAIN_FAM_DEPTH = {"zamba2-7b": 33, "qwen2-moe-a2.7b": 6, "gemma2-9b": 12}
TRAIN_FAM_STEPS = 3
# phase cosim: the launcher's --engine cosim defaults (EN window 8 ms), and
# the store size at which an EN search is timed (PaperDelayModel's 100k point)
COSIM_WINDOW_S, COSIM_SEARCH_N = 0.008, 100_000


class SmokeFailure(RuntimeError):
    pass


def expect(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def sync() -> None:
    torch.cuda.synchronize()


def median_ms(fn, reps: int) -> float:
    """Median time of ``fn`` in ms from CUDA events, after a warm-up call."""
    fn()
    sync()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def loop_ms(fn, reps: int) -> float:
    """ms a call over ``reps`` back-to-back calls between two CUDA events,
    after a warm-up call: the device's time a call wherever the host
    enqueues a call faster than the device runs it (no profiler and no
    graph, which does not capture autograd's backward)."""
    fn()
    sync()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def graph_ms(fn, reps: int, rounds: int = 5) -> float:
    """Device time per call in ms: ``reps`` calls captured in one CUDA graph,
    the median over ``rounds`` replays timed with CUDA events, divided by
    ``reps``.  Unlike ``median_ms`` it leaves out the host's time to enqueue
    a call, which is longer than a short kernel itself."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):     # warm up off the capture
        fn()
    torch.cuda.current_stream().wait_stream(side)
    sync()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    sync()
    times = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    del graph
    return float(np.median(times))


def attention_times(fn, plain, lib) -> dict:
    """An attention kernel's times beside its plain version's and its
    library call's: ``ms``/``library_ms`` are single calls with their
    launches (``median_ms``, as every kernel is timed), ``device_ms``/
    ``library_device_ms`` device time per call (``graph_ms``)."""
    return {"ms": median_ms(fn, REPS), "plain_ms": median_ms(plain, PLAIN_REPS),
            "library_ms": median_ms(lib, REPS), "device_ms": graph_ms(fn, REPS),
            "library_device_ms": graph_ms(lib, REPS)}


def _rates(t: dict, work: float, unit: str, lib: str = "sdpa") -> str:
    """``attention_times`` as a log fragment; ``work`` per call in units of
    ``unit`` * 1e3 (GFLOP for TFLOP/s, MB for GB/s); ``lib`` names the
    library call."""
    return (f"{t['ms']:.4f} ms a call with its launch ({lib} {t['library_ms']:.4f}), "
            f"{t['device_ms']:.4f} ms device per call, {work / t['device_ms']:.1f} {unit} "
            f"({lib} {t['library_device_ms']:.4f} ms, {work / t['library_device_ms']:.1f} "
            f"{unit}); plain {t['plain_ms']:.4f} ms")


def bound(n_bytes: float, n_flop: float, flop_per_s: float = FP32_FLOP_PER_S):
    """(least ms on an H100, what bounds it)."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_flop / flop_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def top1_bound(q: np.ndarray, ids: np.ndarray):
    """Bound of a gather top-1 on this run's data: q, ids and each store row
    the ids reference read once, (score, id) written; 2·D FLOP for each
    distinct (query, id) pair (duplicates and -1 slots need none)."""
    d = q.shape[1]
    n_rows = np.unique(ids[ids >= 0]).size
    n_pairs = int(ops.unique_counts(ids).sum())
    return bound(q.nbytes + ids.nbytes + n_rows * d * 4 + q.shape[0] * 8,
                 2.0 * d * n_pairs)


# ------------------------------------------------------------------ phase 1
def phase_env() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(f"card: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"matmul_precision={torch.get_float32_matmul_precision()}")
    expect(not torch.backends.cuda.matmul.allow_tf32
           and torch.get_float32_matmul_precision() == "highest",
           "TF32 is on for float32 matmuls: plain versions would not be fp32")
    return {"card": smi}


# ------------------------------------------------------------------ phase 3
def _unit(rng, *shape) -> np.ndarray:
    return normalize(rng.standard_normal(shape).astype(np.float32))


def _cp_margins(x: np.ndarray, rot: np.ndarray) -> np.ndarray:
    """(B, T, K) float64 gap between the best and second-best vertex score."""
    proj = np.einsum("tkde,be->btkd", rot.astype(np.float64), x.astype(np.float64))
    s = np.sort(np.concatenate([proj, -proj], axis=-1), axis=-1)
    return s[..., -1] - s[..., -2]


def check_hash(name: str, got: torch.Tensor, want: torch.Tensor,
               margins: np.ndarray, again=None) -> tuple:
    """Equal ids, except where a vertex of that hash is a float64 near-tie;
    returns (max |id difference|, ids that differ).  On a failure the
    message names the rows and tables that differ and, where ``again``
    (a call giving a new (kernel ids, plain ids)) is given, whether each
    side repeats its ids, so that a fault that does not repeat shows as
    one; it fails either way."""
    g, w = got.cpu().numpy(), want.cpu().numpy()
    bad = g != w
    if g.ndim == 2:                        # mixed (B, T): any of its K rotations
        near = (margins < TIE_MARGIN).any(axis=-1)
    else:
        near = margins < TIE_MARGIN
    far = bad & ~near
    if far.any():
        rows, tables = np.nonzero(far.reshape(far.shape[0], far.shape[1], -1).any(-1))
        msg = (f"{name}: {int(far.sum())} ids differ away from a near-tie, in "
               f"{np.unique(rows).size} rows ({np.unique(rows // 64).size} tiles of 64) "
               f"and tables {np.unique(tables).tolist()}")
        if again is not None:
            g2, w2 = (t.cpu().numpy() for t in again())
            same = {True: "the same", False: "other"}
            msg += (f"; called again, the kernel gives {same[np.array_equal(g, g2)]} ids, "
                    f"the plain version {same[np.array_equal(w, w2)]} ids, and "
                    f"{int(((g2 != w2) & ~near).sum())} differ away from a near-tie")
        raise SmokeFailure(msg)
    return float(np.abs(g.astype(np.int64) - w).max()), int(bad.sum())


def check_top1(name: str, q: np.ndarray, rows: np.ndarray, got, want) -> tuple:
    """Kernel vs plain top-1: ids equal except at float64 near-ties, scores
    within SCORE_TOL.  rows: the flat (N, D) store on the host."""
    gv, gi = (t.cpu().numpy() for t in got)
    wv, wi = (t.cpu().numpy() for t in want)
    fin = np.isfinite(wv)
    expect((np.isfinite(gv) == fin).all(), f"{name}: found/not-found rows differ")
    expect(((gi < 0) == ~fin).all() and ((wi < 0) == ~fin).all(),
           f"{name}: -1 ids do not match -inf scores")
    err = float(np.abs(gv[fin] - wv[fin]).max()) if fin.any() else 0.0
    expect(err <= SCORE_TOL, f"{name}: max |score error| {err} > {SCORE_TOL}")
    ties = 0
    for r in np.flatnonzero(gi != wi):
        s = rows[[gi[r], wi[r]]].astype(np.float64) @ q[r].astype(np.float64)
        expect(abs(s[0] - s[1]) < TIE_MARGIN,
               f"{name}: row {r} picks {gi[r]} vs plain {wi[r]}, margin {s[0] - s[1]}")
        ties += 1
    return err, ties


def phase_kernels(dev: torch.device, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    out = {}
    # --- K4a / K4b at the serving hash shapes, then D=128, K=2 (the fold)
    for d, k in ((64, 1), (128, 2)):
        p = LSHParams(dim=d, num_tables=5, rotations_per_table=k, seed=seed)
        rot_np, _ = sample_params(p)
        x_np = _unit(rng, HASH_B, d)
        x, rot = torch.from_numpy(x_np).to(dev), torch.from_numpy(rot_np).to(dev)
        margins = _cp_margins(x_np, rot_np)
        nb = p.num_buckets
        for name, fn, plain in (
                ("lsh_hash_mix", lambda x=x, rot=rot: lsh_hash.lsh_hash_mix(x, rot, nb),
                 lambda x=x, rot=rot: ref.lsh_hash_mix_ref(x, rot, nb)),
                ("lsh_hash", lambda x=x, rot=rot: lsh_hash.lsh_hash(x, rot),
                 lambda x=x, rot=rot: ref.lsh_hash_ref(x, rot))):
            err, ties = check_hash(f"{name} D={d} K={k}", fn(), plain(), margins,
                                   again=lambda fn=fn, plain=plain: (fn(), plain()))
            ms, plain_ms = median_ms(fn, REPS), median_ms(plain, PLAIN_REPS)
            dev_ms = graph_ms(fn, REPS)
            n_out = x_np.shape[0] * p.num_tables * (1 if name == "lsh_hash_mix" else k)
            bms, by = bound((x_np.size + rot_np.size + n_out) * 4,
                            2.0 * x_np.shape[0] * p.num_tables * k * d * d)
            plan = lsh_hash.launch_plan(x_np.shape[0], d, p.num_tables)
            log(f"  {name} B={x_np.shape[0]} D={d} T=5 K={k}: {ms:.4f} ms a call with its "
                f"launch, {dev_ms:.5f} ms device per call (plain {plain_ms:.4f} ms, bound "
                f"{bms:.5f} ms by {by}; {plan['grid']} blocks of {plan['tile_rows']} rows), "
                f"differing ids at near-ties {ties}")
            if d == 64:   # the serving path's shape is the row's own
                out[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                             "bound_ms": bms, "bound_by": by, "device_ms": dev_ms}
            else:         # D=128, K=2 beside it
                out[name].update({"d128_k2_ms": ms, "d128_k2_plain_ms": plain_ms,
                                  "d128_k2_device_ms": dev_ms, "d128_k2_bound_ms": bms})
        # one request's hash, as the async engine's admission gives it
        check_hash(f"lsh_hash_mix B=1 D={d} K={k}", lsh_hash.lsh_hash_mix(x[:1], rot, nb),
                   ref.lsh_hash_mix_ref(x[:1], rot, nb), margins[:1])
        # the routed batch: device time of each tile against the plan's choice
        xb = x[:ROUTED_B]
        got = lsh_hash.lsh_hash_mix(xb, rot, nb)
        check_hash(f"lsh_hash_mix B={ROUTED_B} D={d} K={k}", got,
                   ref.lsh_hash_mix_ref(xb, rot, nb), margins[:ROUTED_B])
        chosen = lsh_hash.launch_plan(ROUTED_B, d, p.num_tables)
        tiles = {}
        for ri in (1, 2, 4):
            plan = lsh_hash.launch_plan(ROUTED_B, d, p.num_tables, row_slots=ri)
            buf = torch.empty_like(got)
            fn = lambda xb=xb, rot=rot, buf=buf, plan=plan: lsh_hash.launch(  # noqa: E731
                "lsh_hash_mix_launch", xb, rot, buf, nb, plan=plan)
            expect(torch.equal(fn(), got),
                   f"lsh_hash_mix: tiles of {plan['tile_rows']} rows give other ids")
            tiles[plan["tile_rows"]] = graph_ms(fn, REPS)
        log(f"  lsh_hash_mix B={ROUTED_B} D={d} K={k} device ms by tile rows: "
            + ", ".join(f"{r} rows ({-(-ROUTED_B // r) * p.num_tables} blocks) {t:.5f}"
                        for r, t in tiles.items())
            + f"; the plan takes {chosen['tile_rows']}")
        out["lsh_hash_mix"][f"b{ROUTED_B}_d{d}_k{k}_tile_device_ms"] = tiles
    return out


def phase_hash_repeat(dev: torch.device, reps: int = 400, seeds: int = 20) -> dict:
    """K4a and K4b and their plain versions, each held to the float64 vertex
    ids (mixed for K4a) at phase kernels' shapes (and its D=64 inputs): the
    first calls, then ``reps`` calls at D=64, K=1 and ``reps // 4`` at D=128, K=2,
    then 5 calls at each of ``seeds`` other seeds (D=64).  Counts, per side,
    the calls with an id off the float64 one away from a near-tie, and fails
    if there is one."""
    out = {}

    def run(seed, d, k, n):
        rng = np.random.default_rng(seed)
        p = LSHParams(dim=d, num_tables=5, rotations_per_table=k, seed=seed)
        rot_np, _ = sample_params(p)
        x_np = _unit(rng, HASH_B, d)
        x, rot = torch.from_numpy(x_np).to(dev), torch.from_numpy(rot_np).to(dev)
        proj = np.einsum("tkde,be->btkd", rot_np.astype(np.float64), x_np.astype(np.float64))
        vids = np.argmax(np.concatenate([proj, -proj], axis=-1), axis=-1)
        mixed = np.zeros(vids.shape[:2], np.int64)
        for kk in range(k):
            mixed = (mixed * 2 * d + vids[..., kk]) % p.num_buckets
        near = _cp_margins(x_np, rot_np) < TIE_MARGIN
        sides = {"lsh_hash_mix": (lambda: lsh_hash.lsh_hash_mix(x, rot, p.num_buckets),
                                  mixed, near.any(axis=-1)),
                 "lsh_hash_mix plain": (lambda: ref.lsh_hash_mix_ref(x, rot, p.num_buckets),
                                        mixed, near.any(axis=-1)),
                 "lsh_hash": (lambda: lsh_hash.lsh_hash(x, rot), vids, near),
                 "lsh_hash plain": (lambda: ref.lsh_hash_ref(x, rot), vids, near)}
        bad = dict.fromkeys(sides, 0)
        for _ in range(n):
            for side, (fn, want, tie) in sides.items():
                bad[side] += int(((fn().cpu().numpy() != want) & ~tie).any())
        return bad

    runs = {"first_calls_d64_k1": [(0, 64, 1, 1)], "d128_k2": [(0, 128, 2, reps // 4)],
            "d64_k1": [(0, 64, 1, reps)],
            f"{seeds}_seeds_d64_k1": [(s, 64, 1, 5) for s in range(1, seeds + 1)]}
    for key, cases in runs.items():
        counts = [run(*case) for case in cases]
        out[key] = {"calls": sum(case[3] for case in cases),
                    "calls_off": {side: sum(c[side] for c in counts) for side in counts[0]}}
        log(f"  hash repeat {key}: {out[key]['calls']} calls a side; calls with an id off the "
            f"float64 one away from a near-tie: {out[key]['calls_off']}")
    expect(not any(v for o in out.values() for v in o["calls_off"].values()),
           "hash repeat: an id off the float64 one away from a near-tie")
    return out


def phase_hash_ids(dev: torch.device, seed: int = 9) -> dict:
    """K4b through its caller, ``ops.lsh_hash_ids``, at the serving hash
    shape, against its plain version; returns the call's launches."""
    rng = np.random.default_rng(seed)
    p = LSHParams(dim=64, num_tables=5, seed=seed)
    rot_np, _ = sample_params(p)
    x_np = _unit(rng, HASH_B, 64)
    x, rot = torch.from_numpy(x_np).to(dev), torch.from_numpy(rot_np).to(dev)
    ops.reset_launch_counts()
    got = ops.lsh_hash_ids(x, rot)
    counts = ops.launch_counts()
    _, ties = check_hash("ops.lsh_hash_ids", got, ref.lsh_hash_ref(x, rot),
                         _cp_margins(x_np, rot_np))
    log(f"  ops.lsh_hash_ids B={HASH_B} D=64 T=5: vertex ids equal to the plain version's "
        f"(differing at near-ties {ties}); launches {counts}")
    return counts


# ------------------------------------------------------------------ phase 3a
def phase_top1(dev: torch.device, seed: int = 4) -> dict:
    """K3 at the staged path's batches and K1's id-matrix route on a paged
    100k x 64 store with planted equal rows, each against its plain version.
    Calls only the wrappers, so ``--top1 --src DIR`` times another tree's
    port on the same inputs."""
    rng = np.random.default_rng(seed)
    out = {}
    # --- a paged (P, S, 64) store of store_rows rows, planted duplicates
    n, s_ = STORE_ROWS, PAGE_SIZE
    pages = -(-n // s_)
    rows = np.zeros((pages * s_, 64), np.float32)
    rows[:n] = _unit(rng, n, 64)
    dup_src = rng.choice(n // 2, 64, replace=False)
    dup_dst = n // 2 + dup_src
    rows[dup_dst] = rows[dup_src]           # equal rows: exact score ties
    store = torch.from_numpy(rows.reshape(pages, s_, 64)).to(dev)

    def near_queries(m: int, src: np.ndarray) -> np.ndarray:
        noise = 0.05 * rng.standard_normal((m, 64)).astype(np.float32) / 8.0
        return normalize(rows[src] + noise)

    # --- K3: sorted, unique, front-packed candidates, at the staged path's
    # batches (scalar queries, windows below fused_min_batch); the largest is
    # the row's own shape, the others give b1_* and b8_*
    c3 = K3_C
    src = rng.integers(0, n, max(K3_BATCHES))
    q3_np = near_queries(src.size, src)
    ids3 = np.full((src.size, c3), -1, np.int32)
    for r in range(src.size):
        cnt = int(rng.integers(c3 // 2, c3 + 1))
        pick = rng.choice(n, cnt, replace=False)
        pick[0] = src[r]
        ids3[r, :cnt] = np.sort(pick)
    planned = hasattr(sim_topk, "gather_plan")   # False for a port from before the split kernel
    res = {}
    for b in K3_BATCHES:
        q3, i3 = torch.from_numpy(q3_np[:b]).to(dev), torch.from_numpy(ids3[:b]).to(dev)
        fn = lambda q3=q3, i3=i3: sim_topk.gather_top1(q3, store, i3)  # noqa: E731
        plain = lambda q3=q3, i3=i3: ref.gather_top1_ref(q3, store, i3)  # noqa: E731
        err, ties = check_top1(f"gather_top1 B={b}", q3_np[:b], rows, fn(), plain())
        ms, plain_ms = median_ms(fn, REPS), median_ms(plain, PLAIN_REPS)
        dev_ms = graph_ms(fn, REPS)
        bms, by = top1_bound(q3_np[:b], ids3[:b])
        plan = sim_topk.gather_plan(b, c3, 64) if planned else None
        log(f"  gather_top1 B={b} C={c3} store {n}x64: {ms:.4f} ms a call, {dev_ms:.5f} ms "
            f"device (plain {plain_ms:.4f} ms, bound {bms:.5f} ms by {by}, device time "
            f"{bms / dev_ms:.3f} of it"
            + (f"; {plan['blocks']} blocks of {plan['chunk']} candidates" if plan else "")
            + f"), max err {err:.3g}, differing ids at near-ties {ties}")
        res[b] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                  "bound_by": by, "device_ms": dev_ms}
    big = max(K3_BATCHES)
    out["gather_top1"] = dict(res[big])
    for b in K3_BATCHES[:-1]:
        out["gather_top1"].update({f"b{b}_{k}": v for k, v in res[b].items() if k != "bound_by"})
    if planned:   # device time by candidates a block at the largest batch
        chunks = {}
        want = sim_topk.gather_top1(q3, store, i3)
        for chunk in K3_CHUNKS:
            plan = sim_topk.gather_plan(big, c3, 64, chunk=chunk)
            fn = lambda plan=plan: sim_topk.launch_gather(  # noqa: E731
                "gather_top1_launch", q3, store, i3, plan)
            got = fn()
            expect(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
                   f"gather_top1: {chunk} candidates a block give another result")
            chunks[chunk] = graph_ms(fn, REPS)
        log(f"  gather_top1 B={big} device ms by candidates a block: " + ", ".join(
            f"{c} ({-(-c3 // c) * big} blocks) {t:.5f}" for c, t in chunks.items())
            + f"; the plan takes {sim_topk.gather_plan(big, c3, 64)['chunk']}")
        out["gather_top1"][f"b{big}_chunk_device_ms"] = chunks

    # --- K1: raw table candidates with duplicates, -1 slots and planted ties
    q1n, c1 = K1_Q, K1_C
    src = rng.integers(0, n, q1n)
    src[: q1n // 8] = dup_src[rng.integers(0, dup_src.size, q1n // 8)]
    q1_np = near_queries(q1n, src)
    q1_np[: q1n // 16] = rows[src[: q1n // 16]]     # exact: tie between src and dst
    ids1 = rng.integers(0, n, (q1n, c1)).astype(np.int32)
    ids1[rng.random((q1n, c1)) < 0.1] = -1          # empty slots
    dup_cols = rng.integers(0, c1, (q1n, c1 // 8))
    ids1[np.arange(q1n)[:, None], dup_cols] = ids1[:, : c1 // 8]   # duplicates
    col0 = rng.integers(0, c1, q1n)                  # the source and its twin
    col1 = (col0 + 1 + rng.integers(0, c1 - 1, q1n)) % c1
    ids1[np.arange(q1n), col0] = src
    partner = np.where(np.isin(src, dup_src), n // 2 + src, src)
    ids1[np.arange(q1n), col1] = partner
    q1, i1 = torch.from_numpy(q1_np).to(dev), torch.from_numpy(ids1).to(dev)
    fn = lambda: sim_topk.reuse_top1(q1, store, i1)  # noqa: E731
    plain = lambda: ref.reuse_top1_ref(q1, store, i1)  # noqa: E731
    got = fn()
    err, ties = check_top1("reuse_top1", q1_np, rows, got, plain())
    exact = np.arange(q1n // 16)
    expect((got[1].cpu().numpy()[exact] == np.minimum(src, partner)[exact]).all(),
           "reuse_top1: a planted exact tie did not go to the lowest id")
    ms, plain_ms, dev_ms = median_ms(fn, REPS), median_ms(plain, PLAIN_REPS), graph_ms(fn, REPS)
    bms, by = top1_bound(q1_np, ids1)
    log(f"  reuse_top1 (id route) B={q1n} C={c1} store {n}x64: {ms:.4f} ms a call, "
        f"{dev_ms:.4f} ms device "
        f"(plain {plain_ms:.4f} ms, bound {bms:.5f} ms by {by}), max err {err:.3g}, "
        f"differing ids at near-ties {ties}")
    out["reuse_top1"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bms, "bound_by": by, "device_ms": dev_ms}
    return out


# ------------------------------------------------------------------ phase 3c
def probed_bound(q: np.ndarray, buckets: np.ndarray, ids: np.ndarray, cap: int,
                 num_buckets: int):
    """Bound of the bucket route on this run's data: q, the buckets, each
    distinct probed slot row (cap ids) and each distinct store row those
    rows reference read once, (score, id) written; 2·D FLOP for each
    distinct valid (query, id) pair."""
    d, t = q.shape[1], buckets.shape[1]
    n_slot_rows = np.unique(buckets + np.arange(t)[None, :, None] * num_buckets).size
    n_rows = np.unique(ids[ids >= 0]).size
    n_pairs = int(ops.unique_counts(ids).sum())
    return bound(q.nbytes + buckets.nbytes + n_slot_rows * cap * 4 + n_rows * d * 4
                 + q.shape[0] * 8, 2.0 * d * n_pairs)


def check_routes(name: str, store: ReuseStore, q_np: np.ndarray, planted=None,
                 plain_reps: int = PLAIN_REPS) -> dict:
    """K1's bucket route against its id-matrix route on a store's own device
    mirrors and the probe buckets of ``q_np``: val and idx bit-equal, ids
    equal to the plain version's but at float64 near-ties, ``planted`` (query
    rows, lower id, higher id of two equal store rows) won by the lower id
    wherever both are candidates.  Returns both routes' times and the bound."""
    store.sync_device(ensure=True)
    store._sync_tables(ensure=True)
    pages, slots = store._emb_dev, store._slots_dev
    qd = torch.from_numpy(q_np).to(pages.device)
    buckets = store.lsh.probe_batch(qd).contiguous()
    ids = ref.probed_candidate_ids(slots, buckets).contiguous()
    fn = lambda: sim_topk.reuse_top1_probed(qd, pages, slots, buckets)  # noqa: E731
    id_route = lambda: sim_topk.reuse_top1(qd, pages, ids)  # noqa: E731
    plain = lambda: ref.reuse_top1_probed_ref(qd, pages, slots, buckets)  # noqa: E731
    got, other = fn(), id_route()
    expect(torch.equal(got[0], other[0]) and torch.equal(got[1], other[1]),
           f"{name}: the bucket route and the id-matrix route differ in "
           f"{int((got[1] != other[1]).sum())} ids, "
           f"{int((got[0] != other[0]).sum())} scores")
    rows = pages.reshape(-1, pages.shape[-1]).cpu().numpy()
    err, ties = check_top1(name, q_np, rows, got, plain())
    ids_np, idx = ids.cpu().numpy(), got[1].cpu().numpy()
    n_planted = 0
    if planted is not None:
        for r, lo, hi in zip(*planted):
            if lo in ids_np[r] and hi in ids_np[r]:
                expect(idx[r] == lo, f"{name}: planted tie of rows {lo}, {hi} went to {idx[r]}")
                n_planted += 1
        expect(n_planted > 0, f"{name}: no planted tie had both rows among its candidates")
    bms, by = probed_bound(q_np, buckets.cpu().numpy(), ids_np, slots.shape[1],
                           store.params.num_buckets)
    t = {"ms": median_ms(fn, REPS), "device_ms": graph_ms(fn, REPS),
         "id_route_ms": median_ms(id_route, REPS), "id_route_device_ms": graph_ms(id_route, REPS),
         "plain_ms": median_ms(plain, plain_reps), "bound_ms": bms, "bound_by": by,
         "max_abs_err": err}
    inv = graph_ms(lambda: sim_topk.probe_inversion(buckets, store.params.num_buckets), REPS)
    offsets, _ = sim_topk.probe_inversion(buckets, store.params.num_buckets)
    n_prob = np.diff(offsets.cpu().numpy())
    log(f"  {name}: B={q_np.shape[0]} T={buckets.shape[1]} P={buckets.shape[2]} "
        f"cap {slots.shape[1]}, {int((n_prob > 0).sum())} probed slot rows of "
        f"{n_prob.size} (probers a row: mean {n_prob[n_prob > 0].mean():.1f}, max "
        f"{n_prob.max()}): bucket route {t['ms']:.4f} ms a call, {t['device_ms']:.4f} ms "
        f"device (the inversion {inv:.4f} ms of it); id-matrix route {t['id_route_ms']:.4f} "
        f"ms, {t['id_route_device_ms']:.4f} ms device; plain {t['plain_ms']:.4f} ms; bound "
        f"{bms:.5f} ms by {by}; routes bit-equal, max err {err:.3g}, differing ids vs "
        f"plain at near-ties {ties}, planted ties won by the lower id {n_planted}")
    return t


def phase_probed(dev: torch.device, seed: int = 3) -> dict:
    """K1's bucket route on the serve configuration's store at capacity (100k
    rows, planted equal rows), 1024 near-duplicate queries; then one fused
    call that must read nothing back from the card."""
    rng = np.random.default_rng(seed)
    p = LSHParams(dim=64, num_tables=5, num_probes=8)
    n = SERVE_CAPACITY
    store = ReuseStore(p, capacity=n, device=dev)
    x = _unit(rng, n, 64)
    dup_src = rng.choice(n // 2, 64, replace=False)
    x[n // 2 + dup_src] = x[dup_src]
    ids = []
    for lo in range(0, n, 8192):
        ids += store.insert_batch(x[lo:lo + 8192], list(range(lo, min(lo + 8192, n))))
    ids = np.asarray(ids)
    src = rng.integers(0, n, K1_Q)
    q = normalize(x[src] + 0.05 * rng.standard_normal((K1_Q, 64)).astype(np.float32) / 8.0)
    q[:dup_src.size] = x[dup_src]                         # exact ties of two rows
    a, b = ids[dup_src], ids[n // 2 + dup_src]
    planted = (np.arange(dup_src.size), np.minimum(a, b), np.maximum(a, b))
    out = check_routes(f"reuse_top1_probed serve store ({len(store)} rows, bucket_cap "
                       f"{store.bucket_cap})", store, q, planted)
    # the fused call reads no device value on the host: a synchronising call
    # raises under this debug mode
    qd = torch.from_numpy(q).to(dev)
    for need in (True, False):
        ops.reuse_query_top1(qd, store.lsh, store._slots_dev, store._emb_dev, need_counts=need)
    sync()
    n0, f0 = ops.launch_counts()["reuse_top1_probed"], ops.FUSED_DISPATCH_COUNT
    torch.cuda.set_sync_debug_mode("error")
    try:
        for need in (True, False):
            ops.reuse_query_top1(qd, store.lsh, store._slots_dev, store._emb_dev,
                                 need_counts=need)
    except RuntimeError as e:
        raise SmokeFailure(f"the fused query synchronised with the card: {e}") from e
    finally:
        torch.cuda.set_sync_debug_mode("default")
    sync()
    expect(ops.launch_counts()["reuse_top1_probed"] - n0 == ops.FUSED_DISPATCH_COUNT - f0 == 2,
           "the fused query did not launch the bucket route once a call")
    # the count epilogue on the card against the host count of the id matrix
    _, _, counts = ops.reuse_query_top1(qd, store.lsh, store._slots_dev, store._emb_dev)
    buckets = store.lsh.probe_batch(qd).contiguous()
    want = ops.unique_counts(ref.probed_candidate_ids(store._slots_dev, buckets).cpu().numpy())
    expect(np.array_equal(counts.cpu().numpy(), want),
           "the fused query's candidate counts differ from the host count")
    log(f"  fused reuse_query_top1 under torch.cuda.set_sync_debug_mode('error'): no host "
        f"read, one bucket-route launch a call; candidate counts equal to the host count "
        f"(mean {want.mean():.1f})")
    out["crossover_device_ms"] = probed_crossover(store, qd)
    return out


def probed_crossover(store: ReuseStore, qd: torch.Tensor) -> dict:
    """Device time of the dense and the sparse blocks on one store at the
    batches of CROSSOVER_B, both bit-equal; the plan's threshold
    (``sim_topk.PROBED_DENSE_MIN``) sits where they cross."""
    pages, slots = store._emb_dev, store._slots_dev
    nb, p = store.params.num_buckets, store.params.num_probes
    res = {}
    for b in CROSSOVER_B:
        q = qd[:b].contiguous()
        buckets = store.lsh.probe_batch(q).contiguous()
        dense = lambda q=q, bk=buckets: sim_topk.launch_probed(  # noqa: E731
            q, pages, slots, bk, sim_topk.dense_plan(q.shape[1]))
        sparse = lambda q=q, bk=buckets: sim_topk.launch_probed(  # noqa: E731
            q, pages, slots, bk, sim_topk.SPARSE_PLAN)
        a, c = dense(), sparse()
        expect(torch.equal(a[0], c[0]) and torch.equal(a[1], c[1]),
               f"dense and sparse blocks differ at B={b}")
        offsets, _ = sim_topk.probe_inversion(buckets, nb)
        n_prob = np.diff(offsets.cpu().numpy())
        plan = sim_topk.probed_plan(b, p, nb, q.shape[1])
        res[b * p // nb] = {"dense": graph_ms(dense, REPS), "sparse": graph_ms(sparse, REPS)}
        log(f"  bucket route B={b} (B·P/NB {b * p / nb:g}, probers a probed slot row: mean "
            f"{n_prob[n_prob > 0].mean():.1f}): dense {res[b * p // nb]['dense']:.5f} ms, "
            f"sparse {res[b * p // nb]['sparse']:.5f} ms device; the plan takes "
            f"{'sparse' if plan['sparse'] else 'dense'}")
    return res


# ------------------------------------------------------------------ phase 4
def profile_call(name: str, fn, top: int = 8, host: bool = True) -> dict:
    """Where one call's time goes: device busy share (torch.profiler, one
    call) and, with ``host``, the host functions with the most time
    (cProfile, another call; ``fn`` draws fresh inputs on each call).
    Without ``host`` the profiler records device activity only (a call of
    ~100k launches would otherwise spend tens of seconds on host events).
    -> the profiled call's wall and device ms, device ops, and (ms, count)
    by device op name."""
    import cProfile
    import pstats

    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if host else [ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side entries only (kernels, copies), summed by name from the raw
    # trace: the profiler's per-op tables (key_averages) take minutes to build
    # for a call of ~500k launches (an xLSTM train step)
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if str(e.device_type()).endswith("CUDA"):
            t, n = by_name.get(e.name(), (0.0, 0))
            by_name[e.name()] = (t + e.duration_ns() / 1e6, n + 1)
    dev_ms = sum(t for t, _ in by_name.values())
    n_ops = sum(n for _, n in by_name.values())
    busy = (f"device busy {dev_ms:.3f} ms in {n_ops} device ops, idle share "
            f"{1 - dev_ms / wall_ms:.3f}"
            if dev_ms > 0 else "device time not measured (the profiler saw none)")
    log(f"  profile {name}: wall {wall_ms:.3f} ms (under the profiler), {busy}; "
        "top device ops " + "; ".join(f"{k[:160]} {t:.3f} ms" for k, (t, _) in sorted(
            by_name.items(), key=lambda kv: kv[1][0], reverse=True)[:4]))
    out = {"wall_ms": wall_ms, "device_ms": dev_ms, "device_ops": n_ops, "by_name": by_name}
    if not host:
        return out
    prof_host = cProfile.Profile()
    t0 = time.perf_counter()
    prof_host.enable()
    fn()
    sync()
    prof_host.disable()
    wall_ms = (time.perf_counter() - t0) * 1e3
    stats = pstats.Stats(prof_host).stats
    own = sorted(((tt, f"{Path(f).name}:{ln}:{fn_}") for (f, ln, fn_), (_, _, tt, _, _)
                  in stats.items()), reverse=True)[:top]
    # the port's own stages, by time including what they call
    stages = sorted(((ct, f"{Path(f).name}:{fn_}") for (f, ln, fn_), (_, _, _, ct, _)
                     in stats.items() if "repro_torch" in f), reverse=True)[:top]
    log(f"  host profile {name}: wall {wall_ms:.3f} ms (under cProfile); own time "
        + "; ".join(f"{k} {t * 1e3:.2f} ms" for t, k in own))
    log(f"  host stages {name}: " + "; ".join(f"{k} {t * 1e3:.2f} ms" for t, k in stages))
    return out


def _route_and_serve(router: ReuseRouter, replicas, reqs):
    """Route a batch (one hash launch), then one handle_batch per replica."""
    owners, _ = router.route_batch(np.stack([r.embedding for r in reqs]))
    results = [None] * len(reqs)
    for rid in sorted(set(owners.tolist())):
        idxs = np.flatnonzero(owners == rid)
        for i, res in zip(idxs, replicas[rid].handle_batch([reqs[i] for i in idxs])):
            results[i] = res
    return results


def compare_query(name: str, store: ReuseStore, q: np.ndarray, a, b) -> int:
    """Fused vs staged query_batch results: same ids (float64 near-ties
    excepted), similarities within SCORE_TOL."""
    ties = 0
    for i, ((ra, sa, ia), (rb, sb, ib)) in enumerate(zip(a, b)):
        expect(abs(sa - sb) <= SCORE_TOL or sa == sb, f"{name}: query {i} sim {sa} vs {sb}")
        if ia != ib:
            expect(ia is not None and ib is not None, f"{name}: query {i} hit vs miss")
            s = store._rows(np.array([ia, ib])).astype(np.float64) @ q[i].astype(np.float64)
            expect(abs(s[0] - s[1]) < TIE_MARGIN, f"{name}: query {i} id {ia} vs {ib}")
            ties += 1
        else:
            expect(ra == rb, f"{name}: query {i} result {ra!r} vs {rb!r}")
    return ties


def phase_serve(dev: torch.device, seed: int = 1) -> dict:
    """Two replicas behind a router (the serve.py configuration), stores
    filled to capacity through handle_batch, then mixed traffic."""
    rng = np.random.default_rng(seed)
    p = LSHParams(dim=64, num_tables=5, num_probes=8)
    execute = lambda reqs: [f"label-{r.request_id}" for r in reqs]  # noqa: E731
    cap, bsz = SERVE_CAPACITY, SERVE_BATCH
    replicas = [ReplicaEngine(i, p, execute, store_capacity=cap, device=dev)
                for i in range(2)]
    router = ReuseRouter(p, 2, device=dev)
    embs = []

    def requests(x: np.ndarray, thr: float = 0.9):
        base = sum(len(e) for e in embs)
        embs.append(x)
        return [ServeRequest(base + i, "svc", x[i], threshold=thr) for i in range(len(x))]

    def filled() -> int:
        return min(len(r.stores["svc"]) if "svc" in r.stores else 0 for r in replicas)

    ops.reset_launch_counts()
    fused_calls0 = ops.FUSED_DISPATCH_COUNT
    t0, fill_batches = time.perf_counter(), 0
    while filled() < cap:
        expect(fill_batches < 4 * cap // bsz + 8, "stores never reached capacity")
        res = _route_and_serve(router, replicas, requests(_unit(rng, bsz, 64)))
        expect(all(r is not None for r in res), "a fill request got no result")
        fill_batches += 1
    sync()
    log(f"  fill: {fill_batches} batches of {bsz} -> stores "
        f"{[len(r.stores['svc']) for r in replicas]} in {time.perf_counter() - t0:.3f} s")

    n_sent = sum(len(e) for e in embs)
    all_x = np.concatenate(embs)

    def mixed(size: int):
        """Half near-duplicates of recent (still live) requests, half fresh."""
        src = rng.integers(n_sent - cap // 5, n_sent, size // 2)
        noise = 0.05 * rng.standard_normal((src.size, 64)).astype(np.float32) / 8.0
        return np.concatenate([normalize(all_x[src] + noise),
                               _unit(rng, size - src.size, 64)]), src

    kinds = {"cs": 0, "en": 0, None: 0}
    right = near_reused = near_total = fresh_exec = fresh_total = 0
    fused0 = [r.stores["svc"].fused_queries for r in replicas]
    staged0 = [r.stores["svc"].staged_queries for r in replicas]
    for size, n_batches in ((bsz, SERVE_BATCHES), (SMALL_BATCH, SERVE_BATCHES)):
        times = []
        for _ in range(n_batches):
            x, src = mixed(size)
            half = src.size
            t0 = time.perf_counter()
            res = _route_and_serve(router, replicas, requests(x))
            sync()
            times.append(time.perf_counter() - t0)
            for j, r in enumerate(res):
                kinds[r.reuse] += 1
                if j < half:
                    near_total += 1
                    if r.reuse is not None:
                        near_reused += 1
                        right += r.result == f"label-{src[j]}"
                else:
                    fresh_total += 1
                    fresh_exec += r.reuse is None
        log(f"  serve batches of {size}: {', '.join(f'{t * 1e3:.3f}' for t in times)} ms")
    counts = ops.launch_counts()   # the serving path's launches
    expect(counts["reuse_top1_probed"] == ops.FUSED_DISPATCH_COUNT - fused_calls0 > 0,
           f"serve: {counts['reuse_top1_probed']} bucket-route launches for "
           f"{ops.FUSED_DISPATCH_COUNT - fused_calls0} fused calls")
    for size in (bsz, SMALL_BATCH):   # fresh traffic for every profiled call
        profile_call(f"serve batch of {size}", lambda size=size: _route_and_serve(
            router, replicas, requests(mixed(size)[0])))
    log(f"  hits by kind: cs {kinds['cs']}, en {kinds['en']}, executed {kinds[None]}; "
        f"near-duplicates reused {near_reused}/{near_total} ({right} with the source's "
        f"result), fresh executed {fresh_exec}/{fresh_total}; launches {counts}")
    expect(near_reused >= 0.8 * near_total, "too few near-duplicates were reused")
    expect(right >= 0.99 * near_reused, "reused near-duplicates got a wrong result")
    expect(fresh_exec >= 0.99 * fresh_total, "fresh requests were wrongly reused")
    expect(all(r.stores["svc"].fused_queries > f for r, f in zip(replicas, fused0)),
           "the large batches did not take the fused path")
    expect(all(r.stores["svc"].staged_queries > s for r, s in zip(replicas, staged0)),
           "the small batches did not take the staged path")

    # fused vs staged on the same store (peek: no state changes)
    store = replicas[0].stores["svc"]
    q = mixed(bsz)[0]
    fused = store.query_batch(q, 0.9, peek=True)
    expect(store.last_query_fused, "parity check: fused path not taken")
    store.fused = False
    staged = store.query_batch(q, 0.9, peek=True)
    store.fused = True
    ties = compare_query("serve fused vs staged", store, q, fused, staged)
    log(f"  fused vs staged on replica 0 ({len(store)} entries, {bsz} queries): "
        f"agree, differing ids at near-ties {ties}")
    return counts


# ------------------------------------------------------------------ phase 5
def phase_store(dev: torch.device, seed: int = 2) -> dict:
    """The fused-query acceptance configuration (benchmarks/fused_query.py):
    hyperplane LSH, 16384 buckets, a 250k-entry store, query batch 4096;
    returns K1's two routes on its inputs (``check_routes``)."""
    rng = np.random.default_rng(seed)
    n, bsz = ACC_STORE, ACC_BATCH
    p = LSHParams(dim=64, num_tables=5, num_probes=8, num_buckets=16384,
                  family="hyperplane", seed=11)
    store = ReuseStore(p, capacity=n + 1, device=dev)
    x = _unit(rng, n, 64)
    dup = np.random.default_rng(seed + 1).choice(n // 2, 64, replace=False)
    x[n // 2 + dup] = x[dup]                  # equal rows: exact ties for K1's routes
    t0 = time.perf_counter()
    ids = []
    for lo in range(0, n, 8192):
        ids += store.insert_batch(x[lo:lo + 8192], list(range(lo, min(lo + 8192, n))))
    t_fill = time.perf_counter() - t0
    q = normalize(x[:bsz] + 0.05 * rng.standard_normal((bsz, 64)).astype(np.float32) / 8.0)
    store.query_batch(q, 0.9)           # first call: both mirrors go resident
    store.sync_device()
    ops.reset_launch_counts()
    fused_calls0 = ops.FUSED_DISPATCH_COUNT
    t0 = time.perf_counter()
    fused = store.query_batch(q, 0.9)
    sync()
    t_fused = time.perf_counter() - t0
    expect(store.last_query_fused, "store: fused path not taken")
    expect(ops.launch_counts()["reuse_top1_probed"] == ops.FUSED_DISPATCH_COUNT - fused_calls0
           == 1, "store: the fused call did not launch the bucket route once")
    expect(store.last_sync_pages == 0 and store.last_table_sync_pages == 0,
           f"store: timed call uploaded {store.last_sync_pages} pages, "
           f"{store.last_table_sync_pages} table slabs")
    counts = ops.launch_counts()
    profile_call(f"fused query_batch({bsz})", lambda: store.query_batch(q, 0.9, peek=True))
    store.fused = False
    t0 = time.perf_counter()
    staged = store.query_batch(q, 0.9, peek=True)
    sync()
    t_staged = time.perf_counter() - t0
    ties = compare_query("store fused vs staged", store, q, fused, staged)
    hits = sum(r[2] is not None for r in fused)
    log(f"  store {len(store)} entries (filled in {t_fill:.3f} s), bucket_cap "
        f"{store.bucket_cap}: fused query_batch({bsz}) {t_fused * 1e3:.3f} ms, "
        f"staged {t_staged * 1e3:.3f} ms, hits {hits}/{bsz}, launches {counts}, "
        f"sync pages 0/0, differing ids at near-ties {ties}")
    q_tie = q.copy()
    q_tie[:dup.size] = x[dup]
    a, b = np.asarray(ids)[dup], np.asarray(ids)[n // 2 + dup]
    t = check_routes("reuse_top1_probed store configuration", store, q_tie,
                     (np.arange(dup.size), np.minimum(a, b), np.maximum(a, b)), plain_reps=2)
    return {f"store_{k}": v for k, v in t.items() if k != "bound_by"}


# ------------------------------------------------------------------ phase 3b
def attn_err(name: str, got: torch.Tensor, want: torch.Tensor,
             bf16_tol: float = ATTN_BF16_MAIN_TOL) -> float:
    """Kernel vs plain attention output: finite, within ATTN_F32_TOL (fp32)
    or ``bf16_tol`` plus one bf16 ulp of the plain value (bf16); returns the
    max |error|."""
    g, w = got.float(), want.float()
    expect(bool(torch.isfinite(g).all()), f"{name}: non-finite output")
    err = (g - w).abs()
    if got.dtype == torch.bfloat16:
        lim = bf16_tol + w.abs() * 2.0 ** -7
    else:
        lim = torch.full_like(w, ATTN_F32_TOL)
    bad = int((err > lim).sum())
    expect(bad == 0, f"{name}: {bad} outputs off, max |error| {err.max().item():.3g}")
    return float(err.max())


def _randn(gen, *shape, dtype=torch.bfloat16, dev):
    return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(dtype)


def phase_attention_kernels(dev: torch.device, seed: int = 5) -> dict:
    """K6 and K7 at qwen3-1.7b's serving shapes, K5 at the store's scale,
    and the attention variants at a small size."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = {}
    # --- K6 variants: window, softcap, no causal mask, cross, odd S, G in {1, 2, 8};
    # then each f32 one (the CUDA-core route) again in bf16 (the tensor-core route)
    variants = (
        (2, 333, 333, 16, 8, 128, torch.float32, {}),
        (2, 300, 300, 8, 8, 128, torch.bfloat16, {"window": 64}),
        (2, 256, 256, 16, 2, 128, torch.float32, {"softcap": 30.0}),
        (1, 257, 257, 16, 8, 128, torch.float32, {"window": 100, "softcap": 50.0}),
        (2, 200, 200, 16, 8, 64, torch.float32, {"causal": False}),
        (2, 100, 180, 16, 8, 128, torch.bfloat16, {"causal": False}),
        (1, 96, 96, 8, 8, 32, torch.float32, {"scale": 0.0625}),
        (1, 48, 16, 4, 4, 32, torch.float32, {"window": 8}),   # rows with no key
        (8, 32, 32, 16, 8, 128, torch.bfloat16, {}),   # a miss group of 8 (async-serve)
        # the padded head widths (zamba2's 112, phi-3-vision's 96), then G = 5
        # (llama4: 64 rows a warpgroup are not whole groups of 5 heads)
        (2, 333, 333, 8, 8, 112, torch.float32, {}),
        (2, 100, 180, 16, 8, 96, torch.float32, {"causal": False}),
        (1, 257, 257, 8, 4, 112, torch.float32, {"window": 64, "softcap": 30.0}),
        (2, 200, 200, 8, 8, 96, torch.float32, {}),
        (1, 300, 300, 40, 8, 128, torch.float32, {}))
    variants += tuple((*v[:6], torch.bfloat16, v[7]) for v in variants
                      if v[6] == torch.float32)
    for B, S, T, H, KV, D, dt, kw in variants:
        q = _randn(gen, B, S, H, D, dtype=dt, dev=dev)
        k, v = (_randn(gen, B, T, KV, D, dtype=dt, dev=dev) for _ in range(2))
        got = flash_k.flash_attention(q, k, v, **kw)
        err = attn_err(f"flash_attention {B, S, T, H, KV, D} {kw}", got,
                       ref.flash_attention_ref(q, k, v, **kw), ATTN_BF16_TOL)
        log(f"  flash_attention variant B={B} S={S} T={T} H={H} KV={KV} D={D} "
            f"{str(dt)[6:]} {kw}: max err {err:.3g}")

    # --- K6 at the prefill shape (bf16, causal), K7 over a ring-sized cache
    # with kv_len below T in some rows (one per row of ATTN_B = 4)
    S, T = ATTN_S, DECODE_T
    heads = (ATTN_H, ATTN_KV, ATTN_D)
    out["flash_attention"] = flash_row(gen, dev, ATTN_B, S, *heads)
    out["decode_attention"] = decode_row(gen, dev, T, [T, S + 1, 1500, 7], *heads)
    # --- the same at the padded head widths, at zamba2's and phi-3-vision's
    # heads and prefill lengths (extra keys of each row: d112_*, d96_*)
    for name, S in PADDED_WIDTHS.items():
        cfg = get_arch(name)
        heads = (cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim)
        for row, got in (("flash_attention", flash_row(gen, dev, FAM_B, S, *heads)),
                         ("decode_attention",
                          decode_row(gen, dev, S + FAM_STEPS, [S + 1, S // 2 + 3], *heads))):
            out[row].update({f"d{heads[2]}_{k}": v for k, v in got.items()})
    # --- head width 256: the variants against plain, then gemma-2b's and
    # gemma2-9b's prefill and decode (d256)
    errs = d256_variants(gen, dev)
    for row, got in d256_rows(gen, dev).items():
        out[row]["d256"] = got
    out["flash_attention"]["d256_variants"] = {k: errs[k] for k in ("flash_out", "flash_lse")}
    out["decode_attention"]["d256_variants"] = {k: errs[k] for k in ("decode_out", "decode_lse")}

    # --- K5 over the store phase's scale, an n_valid tail and planted ties
    rng = np.random.default_rng(seed)
    rows = _unit(rng, NN_N, 64)
    dup_src = rng.choice(NN_N // 2, 64, replace=False)
    rows[NN_N // 2 + dup_src] = rows[dup_src]         # exact ties: the first wins
    q_np = normalize(rows[rng.integers(0, NN_N, NN_Q)]
                     + 0.05 * rng.standard_normal((NN_Q, 64)).astype(np.float32))
    q_np[:64] = rows[dup_src]
    n_valid = NN_N - NN_TAIL
    qd, sd = torch.from_numpy(q_np).to(dev), torch.from_numpy(rows).to(dev)
    fn = lambda: sim_topk.sim_top1(qd, sd, n_valid)  # noqa: E731
    plain = lambda: ref.sim_top1_ref(qd, sd, n_valid)  # noqa: E731
    got = fn()
    err, ties = check_top1("sim_top1", q_np, rows, got, plain())
    idx = got[1].cpu().numpy()
    expect((idx < n_valid).all(), "sim_top1: picked a row past n_valid")
    expect((idx[:64] == dup_src).all(), "sim_top1: a planted tie did not go to the first index")
    ms, plain_ms = median_ms(fn, REPS), median_ms(plain, PLAIN_REPS)
    dev_ms = graph_ms(fn, SIM_GRAPH_REPS)
    flop = 2.0 * NN_Q * n_valid * 64
    bms, by = bound(q_np.nbytes + n_valid * 64 * 4 + NN_Q * 8, flop)
    plan = sim_topk.sim_plan(NN_Q, n_valid, 64)
    log(f"  sim_top1 Q={NN_Q} N={NN_N} n_valid={n_valid} D=64 f32: {ms:.4f} ms a call, "
        f"{dev_ms:.4f} ms device, {flop / dev_ms / 1e9:.1f} TFLOP/s, {bms / dev_ms:.3f} of "
        f"its bound {bms:.5f} ms by {by} ({bms / ms:.3f} a call); plain {plain_ms:.4f} ms; "
        f"{plan['blocks']} blocks ({plan['q_tiles']} query tiles of {plan['q_rows']} x "
        f"{plan['splits']} splits of {plan['chunk']} rows, {plan['slots']} block slots); "
        f"max err {err:.3g}, differing ids at near-ties {ties}")
    out["sim_top1"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                       "bound_by": by, "library_ms": None, "device_ms": dev_ms,
                       "tflops": flop / dev_ms / 1e9, "bound_share": bms / dev_ms}
    return out


def flash_row(gen, dev, B: int, S: int, H: int, KV: int, D: int, flex: bool = False,
              **kw) -> dict:
    """K6 (bf16 route) causal at (B, S, H, D) x (B, S, KV, D), with the
    masks of ``kw`` (window, softcap, scale): against its plain version,
    timed beside SDPA (a window as a boolean mask; SDPA has no softcap, so
    with one it times the uncapped function) or, with a softcap and
    ``flex``, beside ``flex_attention`` compiled (the same function:
    ``flex_library``), with its bound."""
    q = _randn(gen, B, S, H, D, dev=dev)
    k, v = (_randn(gen, B, S, KV, D, dev=dev) for _ in range(2))
    kw = {"scale": 1.0 / np.sqrt(D), **kw}
    window, capped = kw.get("window"), kw.get("softcap") is not None
    shape = f"B={B} S={S} H={H} KV={KV} D={D}" + "".join(
        f" {n}={kw[n]}" for n in ("window", "softcap") if kw.get(n) is not None)
    fn = lambda: flash_k.flash_attention(q, k, v, **kw)  # noqa: E731
    plain = lambda: ref.flash_attention_ref(q, k, v, **kw)  # noqa: E731
    err = attn_err(f"flash_attention {shape}", fn(), plain())
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    if window is None:
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, is_causal=True, enable_gqa=H != KV, scale=kw["scale"])
    else:
        pos = torch.arange(S, device=dev)
        mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, attn_mask=mask, enable_gqa=H != KV, scale=kw["scale"])
    err_lib, flex_note = None, None
    if capped and flex:
        flex_lib, flex_note = flex_library(
            qt, kt, vt, kw["scale"], kw["softcap"],
            lambda b, h, qi, ki: (qi >= ki) & (qi - ki < (window or S + 1)), S, S, B)
        if flex_lib is not None:
            lib, capped = flex_lib, False
    if flex_note == "flex":   # reported, not held: the library is the yardstick
        err_lib = float((lib().transpose(1, 2).float() - plain().float()).abs().max())
    elif not capped:
        err_lib = attn_err(f"sdpa {shape} vs plain", lib().transpose(1, 2), plain(),
                           ATTN_BF16_TOL)
    t = attention_times(fn, plain, lib)
    flop = 4.0 * B * H * D * flash_k.visible_pairs(S, S, True, window)
    # q, out (B, S, H, D) and k, v (B, S, KV, D), bf16, each moved once
    bms, by = bound(2 * (2 * q.numel() + k.numel() + v.numel()), flop, BF16_FLOP_PER_S)
    log(f"  flash_attention {shape} bf16 causal (tiles "
        f"{flash_k.launch_plan(q.dtype, B, S, S, H, KV, D)['tile_width']} wide): "
        + _rates(t, flop / 1e9, "TFLOP/s", "flex" if flex_note == "flex" else "sdpa")
        + f"; bound {bms:.5f} ms by {by}; device time "
        f"{t['device_ms'] / t['library_device_ms']:.3f}x "
        + ("flex_attention's (compiled, the same function)" if flex_note == "flex" else "sdpa's")
        + (" (sdpa without the softcap: not the same function)" if capped else "")
        + (f" (flex_attention: {flex_note})" if flex_note not in (None, "flex") else "")
        + f"; max err {err:.3g}" + (f" (library {err_lib:.3g})" if err_lib is not None else ""))
    return {"shape": [B, S, H, KV, D], "max_abs_err": err, **t, "bound_ms": bms,
            "bound_by": by, **({"library_without_softcap": True} if capped else {}),
            **({"library": flex_note} if flex_note is not None else {})}


def decode_row(gen, dev, T: int, lens: list, H: int, KV: int, D: int, flex: bool = False,
               **kw) -> dict:
    """K7 at (B, H, D) x (B, T, KV, D), B = len(lens), row b's kv_len
    lens[b], with ``kw`` (softcap, scale): against its plain version (also
    at kv_len 1 and T in every row), timed beside SDPA with a mask (without
    the softcap: SDPA has none) or, with a softcap and ``flex``, beside
    ``flex_attention`` compiled with a kv_len mask, with its bound."""
    B = len(lens)
    q = _randn(gen, B, H, D, dev=dev)
    k, v = (_randn(gen, B, T, KV, D, dev=dev) for _ in range(2))
    kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
    kw = {"scale": 1.0 / np.sqrt(D), **kw}
    capped = kw.get("softcap") is not None
    shape = f"B={B} T={T} kv_len={lens} H={H} KV={KV} D={D}" + (
        f" softcap={kw['softcap']}" if capped else "")
    fn = lambda: decode_k.decode_attention(q, k, v, kv_len, **kw)  # noqa: E731
    plain = lambda: ref.decode_attention_ref(q, k, v, kv_len, **kw)  # noqa: E731
    err = attn_err(f"decode_attention {shape}", fn(), plain())
    for d_len in (1, T):
        dl = torch.full((B,), d_len, dtype=torch.int32, device=dev)
        attn_err(f"decode_attention {shape} at kv_len={d_len}",
                 decode_k.decode_attention(q, k, v, dl, **kw),
                 ref.decode_attention_ref(q, k, v, dl, **kw))
    mask = (torch.arange(T, device=dev)[None, :] < kv_len[:, None])[:, None, None, :]
    qt, kt, vt = q[:, :, None, :], k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, attn_mask=mask, enable_gqa=H != KV, scale=kw["scale"])
    err_lib, flex_note = None, None
    if capped and flex:
        flex_lib, flex_note = flex_library(
            qt, kt, vt, kw["scale"], kw["softcap"],
            lambda b, h, qi, ki: ki < kv_len[b], 1, T, B)
        if flex_lib is not None:
            lib, capped = flex_lib, False
    if flex_note == "flex":   # reported, not held: the library is the yardstick
        err_lib = float((lib()[:, :, 0].float() - plain().float()).abs().max())
    elif not capped:
        err_lib = attn_err(f"sdpa decode {shape} vs plain", lib()[:, :, 0], plain(),
                           ATTN_BF16_TOL)
    t = attention_times(fn, plain, lib)
    n_slots = sum(lens)
    n_bytes = 2 * (2 * q.numel() + 2 * n_slots * KV * D) + 4 * B
    bms, by = bound(n_bytes, 4.0 * H * D * n_slots, BF16_FLOP_PER_S)
    log(f"  decode_attention {shape} bf16: "
        + _rates(t, n_bytes / 1e6, "GB/s", "flex" if flex_note == "flex" else "sdpa")
        + f"; bound {bms:.5f} ms by {by} (the device time re-reads a cache that fits in "
        f"L2); max err {err:.3g}"
        + (f" (library {err_lib:.3g}"
           + (", flex_attention compiled: the same function)" if flex_note == "flex" else ")")
           if err_lib is not None else " (sdpa without the softcap: not the same function)")
        + (f" (flex_attention: {flex_note})" if flex_note not in (None, "flex") else ""))
    return {"shape": [B, T, H, KV, D], "max_abs_err": err, **t, "bound_ms": bms,
            "bound_by": by, **({"library_without_softcap": True} if capped else {}),
            **({"library": flex_note} if flex_note is not None else {})}


def d256_rows(gen, dev, flex: bool = False) -> dict:
    """K6 and K7 at head width 256, at gemma-2b's and gemma2-9b's serving
    shapes in phase families -> {"flash_attention": {model: row},
    "decode_attention": {model: row}}; with ``flex`` the softcapped rows'
    library is ``flex_attention`` compiled (``flex_library``)."""
    out = {"flash_attention": {}, "decode_attention": {}}
    for name in ("gemma-2b", "gemma2-9b"):
        cfg = get_arch(name)
        B, S = FAM_SHAPE.get(name, (FAM_B, FAM_S))
        heads = (cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim)
        kw = {"scale": cfg.query_pre_attn_scalar ** -0.5} if cfg.query_pre_attn_scalar else {}
        if cfg.attn_logit_softcap:
            kw["softcap"] = cfg.attn_logit_softcap
        win = cfg.sliding_window
        # the prefill's K6 (a local layer's window), then K7: a global layer's
        # cache at step 1, and a local layer's ring, every slot filled
        out["flash_attention"][name] = flash_row(gen, dev, B, S, *heads, flex, window=win,
                                                 **kw)
        lens = [S + 1] if B == 1 else [S + 1, S // 2 + 3]
        out["decode_attention"][name] = decode_row(gen, dev, S + FAM_STEPS, lens, *heads, flex,
                                                   **kw)
        if win and win < S:
            out["decode_attention"][f"{name} ring"] = decode_row(
                gen, dev, win, [win] * B, *heads, flex, **kw)
    return out


def flex_library(qt, kt, vt, scale: float, softcap: float, mask_mod, L: int, T: int,
                 B: int):
    """``flex_attention`` under ``torch.compile`` with a softcap
    ``score_mod`` and ``mask_mod`` as a block mask, on (B, H, L, D) x (B, KV,
    T, D) -> (a call, "flex"), or (None, the error's first line) where it does
    not compile or run.  Timed beside K6 / K7 as the one PyTorch call that
    computes the same function; the port never calls it.  It compiles in
    this process (no compile workers)."""
    try:
        import torch._inductor.config as inductor_config
        from torch.nn.attention.flex_attention import create_block_mask, flex_attention

        inductor_config.compile_threads = 1
        cap = float(softcap)

        def score_mod(score, b, h, q_idx, kv_idx):
            return cap * torch.tanh(score / cap)

        block_mask = create_block_mask(mask_mod, B, None, L, T, device=qt.device)
        compiled = torch.compile(flex_attention, dynamic=False)
        call = lambda: compiled(qt, kt, vt, score_mod=score_mod,  # noqa: E731
                                block_mask=block_mask, scale=scale,
                                enable_gqa=qt.shape[1] != kt.shape[1])
        call()
        graph_ms(call, 2, 1)     # the rows time it in a CUDA graph too
        return call, "flex"
    except Exception as e:   # noqa: BLE001 - the row reports why there is no library time
        line = (str(e).strip().splitlines() or [type(e).__name__])[0]
        log(f"  flex_attention did not compile or run: {type(e).__name__}: {line}")
        return None, f"did not compile: {type(e).__name__}: {line[:160]}"


def fwd_ptxas(route_check: bool = True) -> None:
    """ptxas's registers and spills of every K6 forward kernel; the bf16
    (tensor-core) instances must not spill; with ``route_check``, D = 256
    has its one instance of the redesign (two consumer warpgroups, 64-key
    tiles: flash_tc_kernel<256, 64>) and no other."""
    report = build.ptxas_report("flash_attention")
    for r in report:
        log(f"  ptxas {r['entry']}: {r['registers']} registers, {r['smem']} bytes static "
            f"smem, spill stores {r['spill_stores']} bytes, spill loads {r['spill_loads']} bytes")
    spilled = [r["entry"] for r in report
               if "_tc_kernel" in r["entry"] and (r["spill_stores"] or r["spill_loads"])]
    expect(not spilled, f"K6's bf16 forward kernels spill registers: {spilled}")
    if route_check:
        d256 = [r["entry"] for r in report if "flash_tc_kernel" in r["entry"]
                and "ILi256E" in r["entry"]]
        expect(len(d256) == 1 and "ILi256ELi64E" in d256[0],
               f"K6's bf16 forward at D = 256: tensor-core instances {d256}")


# K6 at D = 256 in bf16 against its plain version: (B, S, T, H, KV, kw,
# with lse); G in {1, 2, 8}, gemma2-9b's masks, ragged S and T, S != T,
# q_offset, rows that see no key, a long prompt.  Cases with S or T of at
# least D256_LONG are held at the main path's ATTN_BF16_MAIN_TOL (there a
# tile read too many shows above 1e-3), the short ones at ATTN_BF16_TOL.
D256_FLASH_CASES = (
    (2, 150, 150, 4, 4, {}, False),                        # G = 1
    (2, 150, 150, 8, 4, {}, True),                         # G = 2
    (2, 203, 203, 8, 1, {}, True),                         # G = 8 (MQA), ragged S
    (1, 333, 333, 16, 8, {"window": 100, "softcap": 50.0, "scale": 256 ** -0.5}, True),
    (1, 70, 150, 8, 1, {"causal": False, "window": 60}, False),
    (1, 150, 70, 4, 2, {"causal": False}, True),
    (1, 100, 612, 8, 1, {"q_offset": 512}, True),           # a chunk at position 512
    (1, 300, 812, 16, 8, {"q_offset": 512, "window": 200, "softcap": 50.0}, True),
    (1, 48, 16, 4, 4, {"window": 8}, True),                # rows 24.. see no key
    (1, 4096, 4096, 16, 8, {}, False))                     # 64 laps of the key ring
D256_LONG = 512
# K7 at D = 256: kv_len at the split boundaries (CHUNK_ALIGN 16, a bf16
# plan's min_chunk 32 = 16 KB / 512 B, and 64) and the ends, at gemma-2b's
# heads and gemma2-9b's with its softcap
D256_DECODE_LENS = (0, 1, 15, 16, 17, 31, 32, 33, 63, 64, 65)


def d256_variants(gen, dev) -> dict:
    """K6 and K7 at D = 256 against their plain versions: the forward's
    cases (``D256_FLASH_CASES``, bf16, out within ATTN_BF16_TOL, or
    ATTN_BF16_MAIN_TOL from D256_LONG positions on, lse where asked), K7
    at ``D256_DECODE_LENS`` and T (out, lse: -inf at kv_len 0) at its plan
    and at a forced ``n_split``, each call again bit-equal, and a full
    4096-slot ring -> max errors."""
    errs = {"flash_out": 0.0, "flash_lse": 0.0, "decode_out": 0.0, "decode_lse": 0.0}
    for B, S, T, H, KV, kw, with_lse in D256_FLASH_CASES:
        kw = dict(kw)
        q = _randn(gen, B, S, H, 256, dev=dev)
        k, v = (_randn(gen, B, T, KV, 256, dev=dev) for _ in range(2))
        name = f"flash_attention D=256 B={B} S={S} T={T} H={H} KV={KV} {kw}"
        if with_lse:
            masks = (kw.get("causal", True), kw.get("window"), kw.get("softcap"),
                     kw.get("scale", 256 ** -0.5))
            got, lse = flash_k.forward(q, k, v, *masks, with_lse=True,
                                       q_offset=kw.get("q_offset", 0))
            want, want_lse = ref.flash_attention_ref(q, k, v, return_lse=True, **kw)
            errs["flash_lse"] = max(errs["flash_lse"], lse_err(f"lse {name}", lse, want_lse))
        else:
            got = flash_k.flash_attention(q, k, v, **kw)
            want = ref.flash_attention_ref(q, k, v, **kw)
        err = attn_err(name, got, want,
                       ATTN_BF16_MAIN_TOL if max(S, T) >= D256_LONG else ATTN_BF16_TOL)
        if kw.get("window") == 8:
            expect(bool((got[:, 24:] == 0).all()), f"{name}: rows without a key are not 0")
        errs["flash_out"] = max(errs["flash_out"], err)
        log(f"  {name}{' with lse' if with_lse else ''}: max err {err:.3g}")
    for name, T, H, KV, kw in (("gemma-2b", 1543, 8, 1, {}),
                               ("gemma2-9b", 4616, 16, 8, {"softcap": 50.0,
                                                           "scale": 256 ** -0.5}),
                               ("gemma2-9b ring", 4096, 16, 8, {"softcap": 50.0})):
        lens = [min(x, T) for x in D256_DECODE_LENS] + [T]
        B = len(lens)
        q = _randn(gen, B, H, 256, dev=dev)
        k, v = (_randn(gen, B, T, KV, 256, dev=dev) for _ in range(2))
        kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
        plan = decode_k.split_plan(B, KV, T, H // KV, 256, 2)
        want, want_lse = ref.decode_attention_ref(q, k, v, kv_len, return_lse=True, **kw)
        for n_split in (None, 3):
            got, lse = decode_k.decode_attention(q, k, v, kv_len, return_lse=True,
                                                 n_split=n_split, **kw)
            tag = f"decode_attention D=256 {name} T={T} kv_len={lens} n_split={n_split}"
            err = attn_err(tag, got, want)
            expect(bool((got[0] == 0).all()) and bool(torch.isneginf(lse[0]).all()),
                   f"{tag}: kv_len 0 gives out {got[0].abs().max().item():.3g}, lse {lse[0]}")
            fin = ~torch.isneginf(want_lse)
            lse_e = float((lse[fin] - want_lse[fin]).abs().max())
            expect(lse_e <= SPLIT_REL_TOL * max(1.0, float(want_lse[fin].abs().max())),
                   f"{tag}: lse off by {lse_e:.3g}")
            again = decode_k.decode_attention(q, k, v, kv_len, return_lse=True,
                                              n_split=n_split, **kw)
            expect(bool(torch.equal(again[0], got)) and bool(torch.equal(again[1], lse)),
                   f"{tag}: a second call is not bit-equal")
            errs["decode_out"] = max(errs["decode_out"], err)
            errs["decode_lse"] = max(errs["decode_lse"], lse_e)
            log(f"  {tag} (plan: {plan['n_split']} splits of at least "
                f"{plan.get('min_chunk', decode_k.CHUNK_ALIGN)} slots, combine "
                f"{plan.get('combine', 'kernel')}): max err {err:.3g}, lse {lse_e:.3g}, "
                "bit-equal again")
    return errs


def sass_digests(name: str) -> dict:
    """{kernel: digest of its SASS instructions} for a built library's
    kernels (cuobjdump from nvcc's directory), without their addresses and
    the source's namespace hash: two trees' equal digests are the same
    machine code."""
    import hashlib
    import re

    tool = Path(build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(build.library_path(name))],
                          capture_output=True, text=True, check=True, timeout=120).stdout
    parts = re.split(r"Function : (\S+)", sass)   # [head, name, body, name, body, ...]
    out = {}
    for fn, body in zip(parts[1::2], parts[2::2]):
        code = "\n".join(re.findall(r"/\*[0-9a-f]{4,}\*/\s+([^;]*;)", body))
        labels = {}   # branch labels are numbered across the file: renumber them
        code = re.sub(r"\.L_x_\d+", lambda m: labels.setdefault(m.group(), f"L{len(labels)}"),
                      code)
        out[re.sub(r"_GLOBAL__N__\w+?_cu_\w{8}", "", fn)] = \
            hashlib.sha1(code.encode()).hexdigest()[:16]
    return out


def phase_d256_rows(dev: torch.device, seed: int = 16) -> dict:
    """``--d256-rows``: K6's forward ptxas report, the D = 256 variants
    against the plain versions, K6 and K7 at gemma-2b's and gemma2-9b's
    rows with ``flex_attention`` as the softcapped rows' library, then
    phase kernels' D <= 128 rows whose plans must stay the parent's
    (qwen3's K6 and K7, zamba2's D=112 decode), after a digest of each K6
    and K7 kernel's SASS (``sass_digests``): the D = 256 routes and those
    rows alone, whose times and machine code ``--src`` compares between
    two trees.  Inductor's
    and Triton's caches go under build/."""
    import os

    for var, sub in (("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, str(ROOT / "build" / sub))
    fwd_ptxas(route_check=False)
    for r in build.ptxas_report("decode_attention"):
        log(f"  ptxas {r['entry']}: {r['registers']} registers, spills {r['spill_stores']}/"
            f"{r['spill_loads']} bytes")
    for name in ("flash_attention", "decode_attention"):
        for fn, digest in sorted(sass_digests(name).items()):
            log(f"  sass {digest} {fn}")
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = {"variants": d256_variants(gen, dev), **d256_rows(gen, dev, flex=True)}
    heads = (ATTN_H, ATTN_KV, ATTN_D)
    out["flash_attention"]["qwen3"] = flash_row(gen, dev, ATTN_B, ATTN_S, *heads)
    out["decode_attention"]["qwen3"] = decode_row(gen, dev, DECODE_T,
                                                  [DECODE_T, ATTN_S + 1, 1500, 7], *heads)
    cfg = get_arch("zamba2-7b")
    S = PADDED_WIDTHS["zamba2-7b"]
    out["decode_attention"]["zamba2 d112"] = decode_row(
        gen, dev, S + FAM_STEPS, [S + 1, S // 2 + 3], cfg.n_heads, cfg.n_kv_heads,
        cfg.resolved_head_dim)
    log("d256 rows: " + json.dumps(out, default=str))
    return out


# ------------------------------------------------------------------ phase 9b
# the fused norm and rotary kernels (csrc/norm_rope.cu) at the serving
# shapes: a replica's prefill in the qwen3-1.7b.fresh cell (256 prompts of
# 256 tokens; d 2048, 16 + 8 heads of 128 with qk-norm) and in
# qwen2.5-14b.fresh (96 prompts; d 5120, 40 + 8 heads with the QKV bias)
NORM_ROPE_SHAPES = {"qwen3-1.7b": (65536, 2048, 16, 8, 128, False, True),
                    "qwen2.5-14b": (24576, 5120, 40, 8, 128, True, False)}


def bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """The largest distance of two bf16 tensors in units in the last place."""
    def ordered(t):
        i = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return int((ordered(a) - ordered(b)).abs().max().item())


def norm_rope_ptxas() -> None:
    rows = build.ptxas_report("norm_rope")
    for r in rows:
        log(f"  ptxas norm_rope {r['entry']}: {r['registers']} registers, spill stores "
            f"{r['spill_stores']} bytes, spill loads {r['spill_loads']} bytes")
    spilled = [r["entry"] for r in rows if r["spill_stores"] or r["spill_loads"]]
    expect(not spilled, f"norm_rope kernels spill registers: {spilled}")


def library_norm(x: torch.Tensor, res, w: torch.Tensor, eps: float) -> torch.Tensor:
    """``F.rms_norm`` of x's rows, or of ``res + x`` (the bf16 add first)."""
    return F.rms_norm(x if res is None else res + x, (x.shape[-1],), w, eps)


def phase_norm_rope(dev: torch.device, seed: int = 17) -> dict:
    """``rms_norm`` (plain rows, and with the residual) and ``qk_rope`` at
    NORM_ROPE_SHAPES: the norm within 1 ulp of bf16 of the plain chain, the
    rotary kernel's normed values within 1 and its rotation of them within
    1 (a rotation that cancels may leave an output many of its own ulps
    from the plain chain's: ``tests/test_torch_cuda.py::rope_errors``); ms
    a call with its launch, device ms over a CUDA graph, the bound (bytes
    at 3.35 TB/s, each element read once and written once), the plain
    chain's ms and, for the norm, ``F.rms_norm`` (with the bf16 add before
    it for the residual form) as the library's yardstick."""
    norm_rope_ptxas()
    gen = torch.Generator(device=dev).manual_seed(seed)
    rows_out = {"rms_norm": {}, "qk_rope": {}}
    for name, (T, d, H, KV, D, bias, qkn) in NORM_ROPE_SHAPES.items():
        x = torch.randn((T, d), generator=gen, device=dev).to(torch.bfloat16)
        res = (torch.randn((T, d), generator=gen, device=dev) * 4).to(torch.bfloat16)
        scale = torch.randn((d,), generator=gen, device=dev) * 0.1
        w = (1.0 + scale).to(torch.bfloat16)
        for form in ("plain", "residual"):
            r = res if form == "residual" else None
            got = ops.rms_norm(x, scale, 1e-6, residual=r)
            want = ref.rms_norm_ref(x, scale, 1e-6, residual=r)
            if r is not None:
                expect(torch.equal(got[1], want[1]), f"rms_norm {name}: the residual sum differs")
                got, want = got[0], want[0]
            ulps = bf16_ulps(got, want)
            expect(ulps <= 1, f"rms_norm {name} {form}: {ulps} ulps from the plain chain")
            fn = functools.partial(ops.rms_norm, x, scale, 1e-6, residual=r)
            plain = functools.partial(ref.rms_norm_ref, x, scale, 1e-6, residual=r)
            lib = functools.partial(library_norm, x, r, w, 1e-6)
            n_bytes = T * d * 2 * (4 if r is not None else 2) + d * 4
            t = {"ms": median_ms(fn, REPS), "device_ms": graph_ms(fn, REPS),
                 "plain_ms": median_ms(plain, PLAIN_REPS), "library_ms": median_ms(lib, REPS),
                 "library_device_ms": graph_ms(lib, REPS), "bound_ms": bound(n_bytes, 0)[0],
                 "ulps": ulps, "shape": [T, d]}
            t["bound_share"] = t["bound_ms"] / t["device_ms"]
            rows_out["rms_norm"][f"{name}_{form}"] = t
            log(f"  rms_norm {name} {form} ({T} x {d}): {t['ms']:.4f} ms a call, "
                f"{t['device_ms']:.4f} ms device ({100 * t['bound_share']:.1f} % of the "
                f"bound {t['bound_ms']:.4f} ms by bytes, {n_bytes / t['device_ms'] / 1e6:.1f} "
                f"GB/s); F.rms_norm {t['library_ms']:.4f} ms, {t['library_device_ms']:.4f} ms "
                f"device; plain {t['plain_ms']:.4f} ms; {ulps} ulps")
        del x, res
        B, S = T // 256, 256
        q = torch.randn((B, S, H, D), generator=gen, device=dev).to(torch.bfloat16)
        k = torch.randn((B, S, KV, D), generator=gen, device=dev).to(torch.bfloat16)
        extra = {}
        if bias:
            extra["bq"] = (torch.randn((H * D,), generator=gen, device=dev) * 0.5).to(
                torch.bfloat16)
            extra["bk"] = (torch.randn((KV * D,), generator=gen, device=dev) * 0.5).to(
                torch.bfloat16)
        if qkn:
            extra["q_norm"] = torch.randn((D,), generator=gen, device=dev) * 0.1
            extra["k_norm"] = torch.randn((D,), generator=gen, device=dev) * 0.1
        pos = torch.arange(S, device=dev)[None, :]
        theta = get_arch(name).rope_theta
        # the kernel's own biased and normed values (position 0: the rotation
        # is the identity) within 1 ulp of the plain chain's (a row's sum in
        # another order); its rotation of them within 1 ulp of the plain one
        zero = torch.zeros_like(pos)
        normed = ops.qk_rope(q.clone(), k.clone(), zero, theta, eps=1e-6, **extra)
        plain_n = ref.qk_rope_ref(q.clone(), k.clone(), zero, theta, eps=1e-6, **extra)
        got = ops.qk_rope(q.clone(), k.clone(), pos, theta, eps=1e-6, **extra)
        ulps = max(bf16_ulps(a, b) for a, b in zip(normed, plain_n))
        rot = max(bf16_ulps(g, ref.apply_rope(n, pos, theta)) for g, n in zip(got, normed))
        expect(ulps <= 1 and rot <= 1, f"qk_rope {name}: normed values {ulps} ulps, rotation "
                                       f"{rot} ulps from the plain chain")
        fn = functools.partial(ops.qk_rope, q, k, pos, theta, eps=1e-6, **extra)
        plain = functools.partial(ref.qk_rope_ref, q, k, pos, theta, eps=1e-6, **extra)
        n_bytes = (q.numel() + k.numel()) * 2 * 2 + pos.numel() * 8 + D * 2 + sum(
            t.numel() * t.element_size() for t in extra.values())
        t = {"ms": median_ms(fn, REPS), "device_ms": graph_ms(fn, REPS),
             "plain_ms": median_ms(plain, PLAIN_REPS), "bound_ms": bound(n_bytes, 0)[0],
             "norm_ulps": ulps, "rotation_ulps": rot, "shape": [B, S, H, KV, D]}
        t["bound_share"] = t["bound_ms"] / t["device_ms"]
        rows_out["qk_rope"][name] = t
        log(f"  qk_rope {name} (B={B} S={S} H={H} KV={KV} D={D}, bias {bias}, qk-norm {qkn}): "
            f"{t['ms']:.4f} ms a call, {t['device_ms']:.4f} ms device "
            f"({100 * t['bound_share']:.1f} % of the bound {t['bound_ms']:.4f} ms by bytes, "
            f"{n_bytes / t['device_ms'] / 1e6:.1f} GB/s); plain {t['plain_ms']:.4f} ms; normed "
            f"values {ulps} ulps, rotation {rot} ulps from the plain chain")
        del q, k, normed, plain_n, got
        torch.cuda.empty_cache()
    return rows_out


@contextlib.contextmanager
def plain_norms():
    """The model's norm and rotary sites on their plain float32 chain, as a
    DTensor runs them: the fused kernels' dispatch sees no card."""
    on_card = ops._on_card
    ops._on_card = lambda x: False
    try:
        yield
    finally:
        ops._on_card = on_card


# ------------------------------------------------------------------ phase 5b
def phase_nearest(dev: torch.device, seed: int = 6) -> dict:
    """``ops.nearest_neighbor`` (K5) over a 250k-row store: near-duplicate
    queries find their source row."""
    rng = np.random.default_rng(seed)
    rows = _unit(rng, NN_N, 64)
    src = rng.integers(0, NN_N, NN_Q)
    q = normalize(rows[src] + 0.05 * rng.standard_normal((NN_Q, 64)).astype(np.float32) / 8.0)
    qd, sd = torch.from_numpy(q).to(dev), torch.from_numpy(rows).to(dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    val, idx = ops.nearest_neighbor(qd, sd)
    sync()
    dt = time.perf_counter() - t0
    counts = ops.launch_counts()
    warm = []
    for _ in range(NEAREST_WARM):
        t0 = time.perf_counter()
        ops.nearest_neighbor(qd, sd)
        sync()
        warm.append((time.perf_counter() - t0) * 1e3)
    found = float((idx.cpu().numpy() == src).mean())
    log(f"  nearest_neighbor({NN_Q}) over {NN_N}x64: {dt * 1e3:.3f} ms (first call), warm "
        f"median {np.median(warm):.3f} ms (" + ", ".join(f"{t:.3f}" for t in warm) + " ms); "
        f"source row found for {found:.4f} of queries, min similarity "
        f"{val.min().item():.4f}; launches {counts}")
    expect(found >= 0.99, "nearest_neighbor missed the source row of a near-duplicate")
    return counts


@contextlib.contextmanager
def recorded_attention(n_calls: int, op: str = "flash_attention"):
    """Keep the arguments and output of the first and the last of
    ``n_calls`` calls of ``ops.<op>`` (K6 or K7) inside (the kernel runs as
    usual); yields {index: (tensor arguments, kwargs, out)}."""
    seen, captured = [0], {}
    kernel_fn = getattr(ops, op)

    def recording(*args, **kw):
        o = kernel_fn(*args, **kw)
        if seen[0] in (0, n_calls - 1):
            captured[seen[0]] = (tuple(a.clone() for a in args), kw, o.clone())
        seen[0] += 1
        return o

    setattr(ops, op, recording)
    try:
        yield captured
    finally:
        setattr(ops, op, kernel_fn)


def check_recorded(name: str, op: str, captured: dict, n_calls: int) -> None:
    """Hold each recorded call of ``ops.<op>`` against its plain version."""
    plain = {"flash_attention": ref.flash_attention_ref,
             "decode_attention": ref.decode_attention_ref}[op]
    for i, (args, kw, o) in sorted(captured.items()):
        err = attn_err(f"{name} {op} call {i}", o, plain(*args, **kw))
        log(f"  {name} {op} call {i} (q {tuple(args[0].shape)}, k {tuple(args[1].shape)}"
            + (f", kv_len {args[3].tolist()}" if len(args) > 3 else "")
            + (f", causal {kw.get('causal', True)}" if op == "flash_attention" else "")
            + f") vs plain: max err {err:.3g}")
    expect(sorted(captured) == sorted({0, n_calls - 1}) if n_calls else not captured,
           f"{name}: {op} calls were not captured")
    captured.clear()


# ------------------------------------------------------------------ phase 6
def phase_model(dev: torch.device, seed: int = 7):
    """qwen3-1.7b at full width and depth: prefill B x S, then greedy decode;
    returns (model, launches on the path)."""
    cfg = get_arch(MODEL_ARCH)
    B, S = ATTN_B, ATTN_S
    t0 = time.perf_counter()
    model = build_model(cfg, dev, seed=seed)
    sync()
    n_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, {n_params} parameters, "
        f"{n_bytes} bytes ({cfg.dtype}), built in {time.perf_counter() - t0:.3f} s")
    gen = torch.Generator(device=dev).manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device=dev)
    max_len = S + DECODE_STEPS

    # record the first and last layer's attention calls (inputs and outputs)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    with recorded_attention(cfg.n_layers) as captured:
        t0 = time.perf_counter()
        logits, cache = model.prefill({"tokens": tokens}, max_len)
        sync()
        t_prefill = time.perf_counter() - t0
    after_prefill = ops.launch_counts()
    expect(after_prefill["flash_attention"] == cfg.n_layers,
           f"prefill launched flash_attention {after_prefill['flash_attention']} times")
    # the fused norms: two a layer (the second with the residual) and the
    # final one; the fused bias, qk-norm and rotation once a layer
    norms_a_pass = 2 * cfg.n_layers + 1
    expect(after_prefill["rms_norm"] == norms_a_pass and after_prefill["qk_rope"] == cfg.n_layers,
           f"prefill launched rms_norm {after_prefill['rms_norm']} and qk_rope "
           f"{after_prefill['qk_rope']} times")
    expect(bool(torch.isfinite(logits).all()), "prefill logits are not finite")
    tok = logits[:, -1].argmax(dim=-1, keepdim=True)
    first_tok, step_ms = tok, []
    for i in range(DECODE_STEPS):
        t0 = time.perf_counter()
        lg, cache = model.decode_step(tok, cache, S + i)
        sync()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        expect(bool(torch.isfinite(lg).all()), f"decode step {i} logits are not finite")
        if i == 0:
            first_logits = lg
        tok = lg[:, -1].argmax(dim=-1, keepdim=True)
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    expect(counts["flash_attention"] == cfg.n_layers
           and counts["decode_attention"] == cfg.n_layers * DECODE_STEPS
           and counts["rms_norm"] == norms_a_pass * (1 + DECODE_STEPS)
           and counts["qk_rope"] == cfg.n_layers * (1 + DECODE_STEPS),
           f"model path launches {counts}")

    check_recorded(cfg.name, "flash_attention", captured, cfg.n_layers)
    # step 1 of decode against a prefill of prompt + that token
    longer, _ = model.prefill({"tokens": torch.cat([tokens, first_tok], dim=1)}, S + 1)
    a, b = first_logits[:, -1].float(), longer[:, -1].float()
    rel = ((a - b).abs().max() / b.abs().max()).item()
    same = int((a.argmax(-1) == b.argmax(-1)).sum())
    log(f"  decode step 1 vs prefill of prompt + token: max |diff| / max |logit| {rel:.4g}, "
        f"argmax equal in {same}/{B} rows")
    expect(rel <= DECODE_LOGIT_REL_TOL, f"decode logits differ from prefill by {rel:.3g}")

    warm = []
    for _ in range(PREFILL_REPS):
        t0 = time.perf_counter()
        model.prefill({"tokens": tokens}, max_len)
        sync()
        warm.append((time.perf_counter() - t0) * 1e3)
    log(f"  prefill B={B} S={S}: {t_prefill * 1e3:.3f} ms (first call), warm median "
        f"{np.median(warm):.3f} ms (" + ", ".join(f"{t:.3f}" for t in warm) + " ms); "
        f"decode per token (B={B}): median {np.median(step_ms):.3f} ms, steps "
        + ", ".join(f"{t:.3f}" for t in step_ms) + f" ms; peak memory {peak} bytes; "
        f"launches {counts}")
    profile_call(f"prefill B={B} S={S}", lambda: model.prefill({"tokens": tokens}, max_len))
    last = S + DECODE_STEPS - 1   # rewrites the last slot with the same token's k/v
    profile_call(f"decode step B={B}", lambda: model.decode_step(tok, cache, last))
    del cache
    return model, counts


# ------------------------------------------------------------------ phase 10
# phase families: the other model families at full width on the card.
@contextlib.contextmanager
def plain_attention():
    """The attention ops swapped for their plain versions (a check of the
    model's results in this script, not a route of the port)."""
    kernels = ops.flash_attention, ops.decode_attention
    ops.flash_attention, ops.decode_attention = ref.flash_attention_ref, ref.decode_attention_ref
    try:
        yield
    finally:
        ops.flash_attention, ops.decode_attention = kernels


@contextlib.contextmanager
def moe_routes(replay=None):
    """Log the expert ids of every MoE routing call inside
    (``models/moe.py::route``), with the call's config: nothing else runs
    in the call (``_drops`` counts its drops afterwards).  With ``replay``
    (the ids of an earlier log, call by call) each call routes to those
    experts instead, its gates taken from its own probabilities: a run with
    other attention then takes the same routing and drops, which a near-tie
    at a capacity edge would otherwise flip.  A check in this script, not a
    route of the port."""
    from repro_torch.models import moe as moe_mod

    route_fn, log_ = moe_mod.route, []

    def logged(params, xf, cfg):
        probs, gates, ids = route_fn(params, xf, cfg)
        if replay is not None:
            ids = replay[len(log_)]
            gates = probs.gather(1, ids)
            if getattr(cfg, "renorm_topk", True) and cfg.top_k > 1:
                gates = gates / gates.sum(dim=-1, keepdim=True)
        log_.append((ids, cfg))
        return probs, gates, ids

    moe_mod.route = logged
    try:
        yield log_
    finally:
        moe_mod.route = route_fn


def _drops(log_) -> tuple:
    """(dropped (token, pick) pairs, tokens with a pick dropped) over the
    calls of a ``moe_routes`` log: each call's dispatch again on its ids."""
    from repro_torch.models import moe as moe_mod

    pairs = tokens = 0
    for ids, cfg in log_:
        sort_idx, _, keep = moe_mod.dispatch(ids, cfg.n_experts,
                                             moe_mod.capacity(ids.shape[0], cfg))
        pairs += int((~keep).sum())
        tokens += int(torch.unique(sort_idx[~keep] // cfg.top_k).numel())
    return pairs, tokens


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| / max |b| of two logit tensors."""
    a, b = a.float(), b.float()
    return ((a - b).abs().max() / b.abs().max()).item()


def _family_inputs(cfg, dev, gen, B: int, n_text: int) -> dict:
    """A batch of B prompts of ``n_text`` tokens, with 576/1024 patch
    embeddings (vision) or FAM_FRAMES frames (encoder-decoder), from ``gen``."""
    dt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, n_text), generator=gen,
                                     device=dev)}
    if cfg.frontend == "vision":
        batch["patch_embeds"] = _randn(gen, B, cfg.n_frontend_tokens, cfg.d_model,
                                       dtype=dt, dev=dev) * 0.02
    if cfg.is_encdec:
        batch["frames"] = _randn(gen, B, FAM_FRAMES, cfg.d_model, dtype=dt, dev=dev) * 0.02
    return batch


def run_family(name: str, dev: torch.device, seed: int) -> dict:
    """One architecture at full width (depth cut only where FAM_DEPTH says):
    prefill, greedy decode, the checks, the times; returns its launches."""
    cfg = get_arch(name)
    if name in FAM_DEPTH:
        log(f"  {name}: depth cut from {cfg.n_layers} to {FAM_DEPTH[name]} layers (the full "
            f"depth does not fit one card), full width")
        cfg = dataclasses.replace(cfg, n_layers=FAM_DEPTH[name])
    k6_want, k7_want = FAM_LAUNCHES[name]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, dev, seed=seed)
    sync()
    n_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  {name} ({type(model).__name__}): {n_params} parameters, {n_bytes} bytes "
        f"({cfg.dtype}), built in {time.perf_counter() - t0:.3f} s")
    gen = torch.Generator(device=dev).manual_seed(seed)
    B, n_text = FAM_SHAPE.get(name, (FAM_B, FAM_S))
    batch = _family_inputs(cfg, dev, gen, B, n_text)
    n_front = cfg.n_frontend_tokens if cfg.frontend == "vision" else 0
    pos0 = n_text + n_front                 # the first decode position
    max_len = pos0 + FAM_STEPS

    ops.reset_launch_counts()
    with recorded_attention(k6_want) as captured, moe_routes() as routes_p:
        t0 = time.perf_counter()
        logits, cache = model.prefill(batch, max_len)
        sync()
        first_ms = (time.perf_counter() - t0) * 1e3
    drops = _drops(routes_p)
    k6 = ops.launch_counts()["flash_attention"]
    expect(k6 == k6_want, f"{name}: prefill launched flash_attention {k6} times, not {k6_want}")
    expect(bool(torch.isfinite(logits).all()) and logits.shape == (B, 1, cfg.vocab_size),
           f"{name}: prefill logits {tuple(logits.shape)} not finite or of the wrong shape")
    # (a) the first and last K6 call of the prefill, and below the first and
    # last K7 call of decode step 1, against their plain versions
    check_recorded(name, "flash_attention", captured, k6_want)

    tok = logits[:, -1].argmax(dim=-1, keepdim=True)
    first_tok, step_ms = tok, []
    for i in range(FAM_STEPS):
        # step 1's routing is kept for the plain run
        with contextlib.ExitStack() as stack:
            if i == 0:
                routes_d = stack.enter_context(moe_routes())
                captured = stack.enter_context(recorded_attention(k7_want, "decode_attention"))
            t0 = time.perf_counter()
            lg, cache = model.decode_step(tok, cache, pos0 + i)
            sync()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        expect(bool(torch.isfinite(lg).all()), f"{name}: decode step {i} logits not finite")
        if i == 0:
            first_logits = lg
            check_recorded(name, "decode_attention", captured, k7_want)
        tok = lg[:, -1].argmax(dim=-1, keepdim=True)
    counts = ops.launch_counts()
    expect(counts["flash_attention"] == k6_want
           and counts["decode_attention"] == k7_want * FAM_STEPS,
           f"{name}: launches {counts}, want K6 {k6_want} and K7 {k7_want * FAM_STEPS}")
    del cache

    # (b) step 1 against a prefill of prompt + that token
    longer_batch = dict(batch, tokens=torch.cat([batch["tokens"], first_tok], dim=1))
    with moe_routes() as log_:
        longer, _ = model.prefill(longer_batch, pos0 + 1)
    drops_longer = _drops(log_)
    rel = _rel(first_logits[:, -1], longer[:, -1])
    same = int((first_logits[:, -1].argmax(-1) == longer[:, -1].argmax(-1)).sum())
    if cfg.n_experts:
        log(f"  {name}: dropped (token, pick) pairs / tokens with a pick dropped, over its "
            f"MoE layers: prefill {drops[0]} / {drops[1]}, prefill of prompt + token "
            f"{drops_longer[0]} / {drops_longer[1]}")
    checked = not cfg.n_experts or (drops[0] == 0 and drops_longer[0] == 0)
    why = ("" if checked else " (not held: capacity dropped tokens, which couples the rows)")
    if name in FAM_F32_STEP_CHECK:
        checked, why = False, " (in bf16 not held: held in float32 below)"
    log(f"  {name}: decode step 1 vs prefill of prompt + token: max |diff| / max |logit| "
        f"{rel:.4g}, argmax equal in {same}/{B} rows" + why)
    if checked:
        expect(rel <= DECODE_LOGIT_REL_TOL, f"{name}: decode logits differ from prefill by "
               f"{rel:.3g}")
    del longer

    # the same prefill and first step with the plain attention (an MoE model
    # routed as the kernels' run was)
    with plain_attention():
        with moe_routes([e[0] for e in routes_p]):
            plain_logits, cache = model.prefill(batch, max_len)
        with moe_routes([e[0] for e in routes_d]):
            plain_step, _ = model.decode_step(first_tok, cache, pos0)
        if name in FAM_F32_STEP_CHECK:
            # the bf16 gap of (b) with no kernel on the path
            plain_longer, _ = model.prefill(longer_batch, pos0 + 1)
            rel_plain = _rel(plain_step[:, -1], plain_longer[:, -1])
            log(f"  {name}: with plain attention, decode step 1 vs prefill of prompt + "
                f"token: max |diff| / max |logit| {rel_plain:.4g} (the kernels' run: {rel:.4g})")
            del plain_longer
    del cache
    rel_p, rel_d = _rel(logits, plain_logits), _rel(first_logits, plain_step)
    log(f"  {name}: kernels vs plain attention: prefill logits {rel_p:.4g}, decode step 1 "
        f"logits {rel_d:.4g} (max |diff| / max |logit|"
        + ("; the plain run routed as the kernels' run" if cfg.n_experts else "") + ")")
    expect(rel_p <= DECODE_LOGIT_REL_TOL and rel_d <= DECODE_LOGIT_REL_TOL,
           f"{name}: the kernels' logits differ from the plain attention's")

    warm = []
    for _ in range(FAM_WARM):
        t0 = time.perf_counter()
        _, cache = model.prefill(batch, max_len)
        sync()
        warm.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    # a dense model's caches (groups, B, slots, KV, D): windows shorter than the prompt
    ring = (sorted({c.shape[2] for c in cache.values()} - {max_len})
            if isinstance(model, DecoderLM) else [])
    log(f"  {name} prefill B={B} S={n_text}+{n_front or 0} text+patches"
        + (f" with {FAM_FRAMES} frames" if cfg.is_encdec else "")
        + (f" (ring buffers of {ring} slots, wrapped)" if ring else "")
        + f": {first_ms:.3f} ms (first call), warm " + ", ".join(f"{t:.3f}" for t in warm)
        + f" ms; decode per token (B={B}): median {np.median(step_ms):.3f} ms, steps "
        + ", ".join(f"{t:.3f}" for t in step_ms) + f" ms; peak memory {peak} bytes; "
        f"launches K6 {counts['flash_attention']}, K7 {counts['decode_attention']}")
    profile_call(f"{name} prefill", lambda: model.prefill(batch, max_len), host=False)
    profile_call(f"{name} decode step", lambda: model.decode_step(tok, cache, max_len - 1),
                 host=False)
    del model, cache, batch
    gc.collect()
    torch.cuda.empty_cache()
    if name in FAM_F32_STEP_CHECK:
        f32_step_check(name, cfg, dev, seed, B, n_text)
    return {k: counts[k] for k in ("flash_attention", "decode_attention", "rms_norm", "qk_rope")}


def f32_step_check(name: str, cfg, dev: torch.device, seed: int, B: int, n_text: int) -> None:
    """Decode step 1 against a prefill of prompt + token with the model,
    its inputs and its cache in float32 (K6's f32 route, K7 over an f32
    cache), held within DECODE_LOGIT_F32_REL_TOL."""
    cfg = dataclasses.replace(cfg, dtype="float32")
    model = build_model(cfg, dev, seed=seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    batch = _family_inputs(cfg, dev, gen, B, n_text)
    pos0 = n_text + (cfg.n_frontend_tokens if cfg.frontend == "vision" else 0)
    logits, cache = model.prefill(batch, pos0 + 1, cache_dtype=torch.float32)
    tok = logits[:, -1].argmax(dim=-1, keepdim=True)
    step, _ = model.decode_step(tok, cache, pos0)
    del cache
    longer, _ = model.prefill(dict(batch, tokens=torch.cat([batch["tokens"], tok], dim=1)),
                              pos0 + 1, cache_dtype=torch.float32)
    rel = _rel(step[:, -1], longer[:, -1])
    log(f"  {name} in float32 ({sum(p.numel() * 4 for p in model.parameters())} bytes): decode "
        f"step 1 vs prefill of prompt + token: max |diff| / max |logit| {rel:.4g}")
    expect(rel <= DECODE_LOGIT_F32_REL_TOL,
           f"{name}: float32 decode logits differ from prefill by {rel:.3g}")
    del model, batch, step, longer
    gc.collect()
    torch.cuda.empty_cache()


def phase_families(dev: torch.device, names=FAMILIES, seed: int = 11) -> dict:
    """Each family at full width, one model at a time; -> launches summed
    over the models (and by model)."""
    total = {"flash_attention": 0, "decode_attention": 0, "rms_norm": 0, "qk_rope": 0}
    for name in names:
        t0 = time.perf_counter()
        counts = run_family(name, dev, seed + FAMILIES.index(name))   # as in the whole run
        for k, n in counts.items():
            total[k] += n
        log(f"  {name}: {time.perf_counter() - t0:.3f} s")
    return total


# ------------------------------------------------------------------ phase 7
def phase_model_serve(dev: torch.device, model, seed: int = 8) -> dict:
    """Two replicas behind a router whose misses run the model's prefill
    (serve.py's executor and request payloads), mixed traffic."""
    rng = np.random.default_rng(seed)
    cfg = model.cfg
    p = LSHParams(dim=64, num_tables=5, num_probes=8)
    execute = make_executor(model, MS_SEQ)
    exec_log = []                                  # (requests, seconds)

    def timed_execute(reqs):
        t0 = time.perf_counter()
        res = execute(reqs)                        # ends in a host read of the tokens
        exec_log.append((len(reqs), time.perf_counter() - t0))
        return res

    replicas = [ReplicaEngine(i, p, timed_execute, device=dev) for i in range(2)]
    router = ReuseRouter(p, 2, device=dev)
    # executed fresh requests (embedding, id); each is the source of at most
    # one near-duplicate, so "the source's token" names one executed result
    # (two near-duplicates of one source share a task name, and the second
    # would inherit whatever the first got)
    n_sent, token_of, fresh_pool, unused = 0, {}, [], []

    def send(x: np.ndarray):
        nonlocal n_sent
        reqs = [make_request(n_sent + i, "svc", x[i], MS_SEQ, cfg.vocab_size)
                for i in range(len(x))]
        n_sent += len(x)
        return reqs, _route_and_serve(router, replicas, reqs)

    ops.reset_launch_counts()
    fused_calls0 = ops.FUSED_DISPATCH_COUNT
    x0 = _unit(rng, MS_BATCH, 64)
    reqs, res = send(x0)
    expect(all(r.reuse is None for r in res), "a first fresh request was reused")
    for rq, r in zip(reqs, res):
        token_of[rq.request_id] = r.result
    fresh_pool += [(x0[i], reqs[i].request_id) for i in range(len(x0))]
    unused += range(len(x0))
    near_total = near_reused = right = fresh_total = fresh_exec = 0
    kinds = {"cs": 0, "en": 0}
    for b in range(MS_BATCHES):
        sel = rng.choice(len(unused), MS_BATCH // 2, replace=False)
        pick = np.array([unused[j] for j in sel])
        unused = [u for j, u in enumerate(unused) if j not in set(sel.tolist())]
        near = normalize(np.stack([fresh_pool[j][0] for j in pick])
                         + 0.05 * rng.standard_normal((pick.size, 64)).astype(np.float32) / 8.0)
        fresh = _unit(rng, MS_BATCH - pick.size, 64)
        k6_0, calls_0 = ops.launch_counts()["flash_attention"], len(exec_log)
        t0 = time.perf_counter()
        reqs, res = send(np.concatenate([near, fresh]))
        sync()
        wall = time.perf_counter() - t0
        calls = exec_log[calls_0:]
        k6 = ops.launch_counts()["flash_attention"] - k6_0
        expect(k6 == cfg.n_layers * len(calls),
               f"batch {b}: {k6} flash_attention launches for {len(calls)} miss groups")
        t_exec = sum(t for _, t in calls)
        for j, (rq, r) in enumerate(zip(reqs, res)):
            if j < pick.size:
                near_total += 1
                if r.reuse is not None:
                    near_reused += 1
                    kinds[r.reuse] += 1
                    right += r.result == token_of[fresh_pool[pick[j]][1]]
            else:
                fresh_total += 1
                fresh_exec += r.reuse is None
                token_of[rq.request_id] = r.result
                unused.append(len(fresh_pool))
                fresh_pool.append((fresh[j - pick.size], rq.request_id))
        log(f"  model-serve batch {b} of {MS_BATCH}: {wall * 1e3:.3f} ms, of it execution "
            f"{t_exec * 1e3:.3f} ms ({len(calls)} miss groups, "
            f"{sum(n for n, _ in calls)} requests) and reuse decision "
            f"{(wall - t_exec) * 1e3:.3f} ms")
    counts = ops.launch_counts()
    expect(counts["reuse_top1_probed"] == ops.FUSED_DISPATCH_COUNT - fused_calls0 > 0,
           f"model-serve: {counts['reuse_top1_probed']} bucket-route launches for "
           f"{ops.FUSED_DISPATCH_COUNT - fused_calls0} fused calls")
    log(f"  model-serve: near-duplicates reused {near_reused}/{near_total} (cs {kinds['cs']}, "
        f"en {kinds['en']}; {right} with the source's token), fresh executed "
        f"{fresh_exec}/{fresh_total}; launches {counts}")
    expect(fresh_exec == fresh_total, "a fresh request was reused")
    expect(near_reused >= 0.8 * near_total, "too few near-duplicates were reused")
    expect(right >= 0.99 * near_reused, "reused near-duplicates got a wrong token")
    expect(counts["flash_attention"] > 0, "no miss ran the model")
    profile_call(f"model-serve batch of {MS_BATCH}", lambda: send(np.concatenate(
        [_unit(rng, MS_BATCH // 2, 64), normalize(np.stack([fresh_pool[j][0] for j in
         rng.integers(0, len(fresh_pool), MS_BATCH // 2)]))]))[1])
    return counts


# ------------------------------------------------------------------ phase 8
# virtual-clock parity: the sweep of benchmarks/async_serving.py (its
# _trace, _exec_time_fn, _max_wait_s and warm _replicas), rebuilt here since
# the smoke imports nothing outside the port
PARITY_DIM, PARITY_N, PARITY_REPLICAS = 32, 600, 3
PARITY_DEADLINE_S, PARITY_BASE_EXEC_S, PARITY_STRAGGLER = 0.25, 0.08, 8.0
# BENCH_async_serving.json, rows async_serving/load{load}/batch{batch}/strag0.1,
# at the precision the file records
PARITY_WANT = {
    (200.0, 8): {"makespan_s": 3.12, "p99_ms": 244.4, "deadline_miss_pct": 1.0,
                 "backups": 19, "backup_wins": 7, "executed": 37, "en": 12, "cs": 519,
                 "aggregated": 32},
    (1000.0, 32): {"makespan_s": 2.39, "p99_ms": 593.2, "deadline_miss_pct": 2.8,
                   "backups": 35, "backup_wins": 24, "executed": 42, "en": 7, "cs": 364,
                   "aggregated": 187},
}


def _parity_run(dev: torch.device, load: float, max_batch: int):
    """One configuration of the async benchmark's sweep (straggler rate 0.1)
    on ``dev``: stub executor, virtual execution times, 3 replicas with a
    warm TTC.  Returns (its virtual-clock fields, rounded as the benchmark
    prints them, and each request's (reuse, replica, backup, result,
    latency))."""
    rng = np.random.default_rng(0)
    base = normalize(rng.standard_normal((24, PARITY_DIM)).astype(np.float32))
    embs = normalize(base[rng.integers(0, 24, PARITY_N)]
                     + 0.04 * rng.standard_normal((PARITY_N, PARITY_DIM)).astype(np.float32)
                     / np.sqrt(PARITY_DIM))
    reqs = [ServeRequest(i, "svc", embs[i], threshold=0.9, deadline_s=PARITY_DEADLINE_S)
            for i in range(PARITY_N)]
    exec_rng = np.random.default_rng(2)

    def exec_time(rid, service, batch):
        per_req = PARITY_BASE_EXEC_S * (1 + 0.2 * exec_rng.random())
        if exec_rng.random() < 0.1:
            per_req *= PARITY_STRAGGLER
        return per_req * max(1.0, len(batch)) ** 0.5

    execute = lambda batch: [  # noqa: E731
        round(float(np.sum(np.asarray(r.embedding))), 5) for r in batch]
    p = LSHParams(dim=PARITY_DIM, num_tables=5, num_probes=8, seed=7)
    replicas = [ReplicaEngine(i, p, execute, device=dev) for i in range(PARITY_REPLICAS)]
    for r in replicas:
        r.ttc.observe("svc", PARITY_BASE_EXEC_S)
    engine = AsyncServingEngine(
        p, replicas, backup=BackupPolicy(factor=1.5, max_backups=1), max_batch=max_batch,
        max_wait_s=min(PARITY_DEADLINE_S / 4, max_batch / load), exec_time_fn=exec_time,
        device=dev)
    arrivals = np.cumsum(np.random.default_rng(3).exponential(1.0 / load, PARITY_N))
    futs = [engine.submit_at(t, r) for t, r in zip(arrivals, reqs)]
    makespan = engine.drain()
    lats = np.asarray([f.result.latency_s for f in futs])
    s = engine.stats()
    raw = {"makespan_s": float(makespan), "p99_ms": float(np.percentile(lats, 99)) * 1e3,
           "deadline_miss_pct": float(np.mean(lats > PARITY_DEADLINE_S)) * 100}
    log(f"  virtual-clock parity load{load:.0f}/batch{max_batch}/strag0.1 on {dev.type}, "
        f"unrounded: {raw}; stats {dict(sorted(s.items()))}")
    got = {"makespan_s": round(raw["makespan_s"], 2), "p99_ms": round(raw["p99_ms"], 1),
           "deadline_miss_pct": round(raw["deadline_miss_pct"], 1)}
    got.update({k: s[k] for k in ("backups", "backup_wins", "executed", "en", "cs",
                                  "aggregated")})
    res = [(f.result.reuse, f.result.replica, f.result.backup, f.result.result,
            f.result.latency_s) for f in futs]
    return got, res


def _serve_run(engine_kind: str, dev: torch.device, model, reqs, arrivals, groups):
    """Serve ``reqs`` on two fresh replicas of ``model`` at full width, through
    ``AsyncServingEngine`` (Poisson ``arrivals`` on the virtual clock, an
    event-loop profile) or through ``ServingFleet.submit`` one at a time;
    each miss group's size is appended to ``groups``.  Returns (engine, futures
    or results, makespan)."""
    execute = make_executor(model, MS_SEQ)

    def counted(batch):
        groups.append(len(batch))
        return execute(batch)

    p = LSHParams(dim=64, num_tables=5, num_probes=8)
    replicas = [ReplicaEngine(i, p, counted, device=dev) for i in range(2)]
    if engine_kind == "async":
        engine = AsyncServingEngine(p, replicas, loop=EventLoop(profile=True),
                                    max_batch=AS_MAX_BATCH, max_wait_s=AS_MAX_WAIT_S,
                                    device=dev)
        futs = [engine.submit_at(t, r) for t, r in zip(arrivals, reqs)]
        return engine, futs, engine.drain()
    fleet = ServingFleet(p, replicas, max_batch=AS_MAX_BATCH, max_wait_s=AS_MAX_WAIT_S,
                         device=dev)
    results = [fleet.submit(r) for r in reqs]
    return fleet.engine, results, fleet.engine.loop.now


def phase_async_serve(dev: torch.device, model) -> dict:
    """The serve launcher's traffic at full width: qwen3-1.7b behind two
    replicas (100k-entry stores) through ``AsyncServingEngine`` and through
    ``ServingFleet``; the async benchmark's virtual-clock results on the card;
    the launcher's ``main`` for both engines.  Returns the async run's
    launches."""
    cfg = model.cfg
    X, _ = make_stream(DATASETS[AS_DATASET], AS_REQUESTS, seed=0)
    reqs = [make_request(i, AS_DATASET, X[i], MS_SEQ, cfg.vocab_size, 0.9)
            for i in range(AS_REQUESTS)]
    arrivals = np.cumsum(np.random.default_rng(0).exponential(1.0 / AS_RATE, AS_REQUESTS))
    # warm the executor at every miss-group size: with wall-time execution a
    # first call's set-up would be its virtual duration and seed the TTC
    execute = make_executor(model, MS_SEQ)
    for n in range(1, AS_MAX_BATCH + 1):
        execute(reqs[:n])
    sync()
    out = {}
    for kind in ("async", "sync"):
        groups = []
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with store_query_log() as queries:
            engine, res, makespan = _serve_run(kind, dev, model, reqs, arrivals, groups)
            sync()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        calls = query_calls(queries)
        if kind == "async":
            expect(all(f.done for f in res), "async-serve: a future was not resolved")
        results = [f.result for f in res] if kind == "async" else res
        stats = engine.stats()
        p99 = float(np.percentile([r.latency_s for r in results], 99))
        log(f"  {kind} ({'AsyncServingEngine' if kind == 'async' else 'ServingFleet.submit'})"
            f": {AS_REQUESTS} requests of {AS_DATASET} in {wall:.3f} s wall, virtual "
            f"makespan {makespan:.6f} s, virtual p99 latency {p99 * 1e3:.3f} ms; stats "
            f"{dict(sorted(stats.items()))}; {len(groups)} miss groups of "
            f"{sum(groups)} requests; store queries by route (calls) {calls}; launches {counts}")
        expect(engine.pending() == 0, f"async-serve {kind}: {engine.pending()} in flight")
        expect(stats["cs"] + stats["en"] + stats["executed"] + stats["aggregated"]
               == AS_REQUESTS, f"async-serve {kind}: stats {stats} do not add up")
        expect(counts["lsh_hash_mix"] == AS_REQUESTS,
               f"async-serve {kind}: {counts['lsh_hash_mix']} hash launches for "
               f"{AS_REQUESTS} admitted requests")
        expect(counts["flash_attention"] == cfg.n_layers * len(groups),
               f"async-serve {kind}: {counts['flash_attention']} flash_attention launches "
               f"for {len(groups)} miss groups")
        # K3: one a staged store query whose gather work reaches
        # use_kernel_threshold (replica handle_batch); smaller ones on the host
        expect(counts["gather_top1"] == calls["k3"],
               f"async-serve {kind}: {counts['gather_top1']} gather_top1 launches, "
               f"{calls['k3']} staged queries at the kernel's threshold")
        expect(counts["reuse_top1_probed"] == calls["k1"] == 0,
               f"async-serve {kind}: a batch took the fused path")
        if kind == "async":
            out = counts
            log("  " + engine.loop.profiler.report(top=6).replace("\n", "\n  "))
        profile_call(f"{kind} serve of {AS_REQUESTS} requests", lambda kind=kind: _serve_run(
            kind, dev, model, reqs, arrivals, []))
    for (load, batch), want in PARITY_WANT.items():
        ops.reset_launch_counts()
        with store_query_log() as queries:
            got, res = _parity_run(dev, load, batch)
        counts, calls = ops.launch_counts(), query_calls(queries)
        # the port on the CPU scores as the reference does (held equal to the
        # JAX package in tests/test_torch_async_serving.py), and so does the
        # card: a query below use_kernel_threshold scores on the host, so
        # where no query reached it every request equals the CPU run's
        _, res_cpu = _parity_run(torch.device("cpu"), load, batch)
        flipped = [i for i, (a, b) in enumerate(zip(res, res_cpu)) if a != b]
        log(f"  virtual-clock parity load{load:.0f}/batch{batch}/strag0.1: {got}; store "
            f"queries by route (calls) {calls}; K3 launches {counts['gather_top1']}; requests "
            f"whose (reuse, replica, backup, result, latency) differ from the CPU run: "
            f"{len(flipped)} {flipped[:20]}")
        expect(counts["gather_top1"] == calls["k3"] and counts["reuse_top1_probed"] == calls["k1"],
               f"async-serve parity load{load:.0f}/batch{batch}: launches {counts}, store "
               f"queries {calls}")
        expect(calls["k3"] or calls["k1"] or not flipped,
               f"async-serve parity load{load:.0f}/batch{batch}: every query scored on the "
               f"host, yet requests {flipped} differ from the CPU run")
        expect(got == want, f"async-serve parity load{load:.0f}/batch{batch}: got {got}, "
               f"BENCH_async_serving.json has {want}; requests that differ from the CPU "
               f"run: {flipped}")
    for engine_kind in ("async", "sync"):
        log(f"  launcher: main --engine {engine_kind} --requests {AS_CLI_REQUESTS} --rate "
            f"{AS_CLI_RATE:g}")
        serve_main(["--engine", engine_kind, "--requests", str(AS_CLI_REQUESTS),
                    "--rate", str(AS_CLI_RATE)])
    return out


# ------------------------------------------------------------------ phase 9
# phase cosim: the network simulator with the reuse stores on the card.
# tests/test_cosim.py's pinned summaries of its seeded trace (500 tasks, no
# window), and the reference's summaries of the same trace's first 250 tasks
# under a 24 ms EN window (held equal to the JAX package on the CPU in
# tests/test_torch_network.py)
COSIM_GOLDEN = {
    ("direct", 0.0): {"tasks": 500, "mean_ct_scratch": 0.11743256895503866,
                      "mean_ct_cs": 0.006210639836999299, "mean_ct_en": 0.015915092919248766,
                      "reuse_pct": 84.0, "reuse_pct_cs": 28.4,
                      "reuse_pct_en": 55.60000000000001, "accuracy_pct": 100.0,
                      "fwd_error_pct": 6.800000000000001},
    ("ttc", 0.0): {"tasks": 500, "mean_ct_scratch": 0.13539679846951094,
                   "mean_ct_cs": 0.006334329121343468, "mean_ct_en": 0.015930518390692365,
                   "reuse_pct": 86.6, "reuse_pct_cs": 28.000000000000004,
                   "reuse_pct_en": 58.599999999999994, "accuracy_pct": 100.0,
                   "fwd_error_pct": 6.0},
    ("direct", 0.024): {"tasks": 250, "mean_ct_scratch": 0.1335935723290045,
                        "mean_ct_cs": 0.005994359895367318,
                        "mean_ct_en": 0.04515897744796637, "reuse_pct": 78.4,
                        "reuse_pct_cs": 20.4, "reuse_pct_en": 57.99999999999999,
                        "accuracy_pct": 100.0, "fwd_error_pct": 6.4},
    ("ttc", 0.024): {"tasks": 250, "mean_ct_scratch": 0.15320703891446097,
                     "mean_ct_cs": 0.006357606927723893, "mean_ct_en": 0.045297379177299035,
                     "reuse_pct": 83.2, "reuse_pct_cs": 22.400000000000002,
                     "reuse_pct_en": 60.8, "accuracy_pct": 100.0, "fwd_error_pct": 6.4},
}
# a record's similarity that K3 or K1 scored on the card (a dot's fp32 chain)
# vs the CPU run's; a similarity the host scored must be bit-equal
COSIM_SIM_TOL = 1e-6
# BENCH_cosim.json: benchmarks/cosim.py's sweep at load 200 req/s
BENCH_COSIM = ROOT / "BENCH_cosim.json"
BENCH_LOAD, BENCH_WINDOWS, BENCH_REPLICAS, BENCH_TASKS = 200.0, (0.0, 0.008, 0.024), (1, 2, 4), 400
COSIM_HOST_REPS = 50    # host-clock reps of one client hash / one EN search


def _record_key(r):
    return (r.t_complete, r.reuse, r.correct, r.forwarding_error, r.reuse_node)


def _golden_net(dev: torch.device, protocol: str, window: float, n_tasks: int):
    """tests/test_cosim.py::_trace on the port: the testbed, ``stanford_ar``,
    3 users, a task every 12 ms, threshold 0.9, forwarding errors measured
    (one peek a miss at the other EN's store), seed 0."""
    g, ens = testbed_topology()
    net = ReservoirNetwork(g, ens, LSHParams(dim=64, num_tables=5, num_probes=8), seed=0,
                           protocol=protocol, en_batch_window_s=window,
                           measure_fwd_errors=True, device=dev)
    spec = DATASETS["stanford_ar"]
    net.register_service(dataset_service(spec))
    for u in range(3):
        net.add_user(f"u{u}", "fwd1" if u % 2 else "fwd2")
    X, _ = make_stream(spec, n_tasks, seed=7)
    for i, x in enumerate(X):
        net.submit_task(f"u{i % 3}", spec.name, x, 0.9, at_time=0.012 * i)
    net.run()
    return net


def _bench_cosim_row(dev: torch.device, kind: str, window: float, replicas: int):
    """benchmarks/cosim.py::_run_one on the port at load 200 req/s (400 tasks,
    4 users, engine flush window from ``_engine_wait_s``, backups at 3x TTC,
    seed 0): (the row's name, us_per_call, derived fields, instant gap),
    formatted as the benchmark writes them."""
    g, ens = testbed_topology()
    be = None
    if kind == "engine":
        be = EngineBackend(n_replicas=replicas, max_batch=16,
                           max_wait_s=max(0.004, min(0.02, 8.0 / BENCH_LOAD)),
                           backup=BackupPolicy(factor=3.0, max_backups=1), seed=5)
    net = ReservoirNetwork(g, ens, LSHParams(dim=64, num_tables=5, num_probes=8, seed=11),
                           seed=0, en_batch_window_s=window, backend=be, device=dev)
    spec = DATASETS["stanford_ar"]
    net.register_service(dataset_service(spec))
    for u in range(4):
        net.add_user(f"u{u}", "fwd1" if u % 2 else "fwd2")
    X, _ = make_stream(spec, BENCH_TASKS, seed=1)
    arrivals = np.cumsum(np.random.default_rng(2).exponential(1.0 / BENCH_LOAD, BENCH_TASKS))
    for i, (t, x) in enumerate(zip(arrivals, X)):
        net.submit_task(f"u{i % 4}", spec.name, x, 0.9, at_time=float(t))
    net.run()
    m = net.metrics
    done = m.completed()
    expect(len(done) == BENCH_TASKS, f"cosim bench: {BENCH_TASKS - len(done)} tasks incomplete")
    scratch = m.mean_completion(kind=(None,))
    reuse = m.mean_completion(kind=("cs", "user", "en"))
    gap = scratch / float(np.mean([r.completion_time for r in done
                                   if r.reuse is not None and not r.aggregated]))
    p99 = float(np.percentile([r.completion_time for r in done], 99)) * 1e3
    if be is not None:
        es = be.stats()
        stats = {k: es.get(k, 0) for k in ("executed", "aggregated", "backups", "backup_wins")}
    else:
        stats = {"executed": sum(en.stats["executed"] for en in net.edge_nodes.values())}
    name = f"cosim/{kind}/load{BENCH_LOAD:.0f}/win{window * 1e3:.0f}ms"
    name += f"/rep{replicas}" if kind == "engine" else ""
    derived = (f"gap_instant={gap:.2f}x;gap_all={scratch / reuse:.2f}x;"
               f"reuse_pct={m.reuse_fraction() * 100:.1f};ct_reuse_ms={reuse * 1e3:.2f};"
               f"p99_ms={p99:.1f};" + ";".join(f"{k}={v}" for k, v in stats.items()))
    return name, round(scratch * 1e6, 2), derived, gap


@contextlib.contextmanager
def store_query_log():
    """Record what each ``ReuseStore`` query made inside launched, by the
    store's route (``scores_on_device``): a staged batch (``query_batch``,
    peeks included) with a candidate whose gather work (queries x candidate
    width) reaches ``use_kernel_threshold`` launches ``gather_top1`` (K3),
    a smaller one scores on the host (``host``); a scalar ``query`` with a
    candidate scores on the host below the threshold and with
    ``similarity_scores`` (a plain product, no kernel: ``scores``) from it;
    a fused batch launches K1's bucket route; otherwise nothing.  Observes
    only: the wrapped methods run unchanged.  Yields a list of (kind,
    queries, similarities a kernel scored or None) per call."""
    calls = []
    query, staged, fused = ReuseStore.query, ReuseStore._query_staged, ReuseStore._query_fused

    def logged_query(self, embedding, threshold=0.0):
        n0 = len(self.candidate_counts)
        out = query(self, embedding, threshold)
        c = self.candidate_counts[n0]
        kind = ("none" if c == 0 else "scores"
                if scores_on_device(self.similarity_name, c, self.use_kernel_threshold)
                else "host")
        calls.append((kind, 1, None))
        return out

    def logged_staged(self, embs):
        out = staged(self, embs)
        n, width = len(out[2]), int(out[2].max(initial=0))
        if width == 0:
            calls.append(("none", n, None))
        elif scores_on_device(self.similarity_name, n * width, self.use_kernel_threshold):
            calls.append(("k3", n, out[0].copy()))
        else:
            calls.append(("host", n, None))
        return out

    def logged_fused(self, embs, need_counts=True):
        out = fused(self, embs, need_counts)
        calls.append(("k1", len(embs), out[0].copy()))
        return out

    ReuseStore.query, ReuseStore._query_staged, ReuseStore._query_fused = (
        logged_query, logged_staged, logged_fused)
    try:
        yield calls
    finally:
        ReuseStore.query, ReuseStore._query_staged, ReuseStore._query_fused = (
            query, staged, fused)


QUERY_KINDS = ("k1", "k3", "host", "scores", "none")


def query_calls(queries) -> dict:
    """store_query_log's calls by kind."""
    return {k: sum(1 for kk, _, _ in queries if kk == k) for k in QUERY_KINDS}


def kernel_sims(queries) -> set:
    """The similarities K3 or K1 returned in store_query_log's calls."""
    return {float(v) for kind, _, vals in queries if vals is not None for v in vals}


def sims_match(name: str, pairs, scored: set) -> float:
    """Card records against their CPU run's (card, CPU similarity pairs): a
    similarity scored on the host (not among ``scored``, what K3 or K1
    returned on the card) must be bit-equal, one a kernel scored within
    COSIM_SIM_TOL.  Returns the largest gap."""
    off = [(a, b) for a, b in pairs if a != b and (a not in scored or abs(a - b) > COSIM_SIM_TOL)]
    expect(not off, f"{name}: similarities off the CPU run's (card, CPU; exact unless a kernel "
           f"scored them, else within {COSIM_SIM_TOL}): {off[:10]}")
    return max((abs(a - b) for a, b in pairs), default=0.0)


def _host_ms(fn, reps: int = COSIM_HOST_REPS) -> float:
    """Median host-clock ms of ``fn`` (which ends in a host read), after one
    warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def phase_cosim(dev: torch.device, model) -> dict:
    """The network simulator on the card: (a) the pinned seeded traces with
    stub services, held to their summaries and record by record to a CPU run;
    (b) BENCH_cosim.json's load-200 rows; (c) the launcher's co-simulation
    with ``model`` (qwen3-1.7b at full width) executing every EN miss behind
    two engine-backed ENs; (d) the launcher's ``main --engine cosim
    --trace-out`` on the reduced model.  Returns (c)'s launches."""
    cpu = torch.device("cpu")
    # (a) pinned traces: K4a per client hash and store insert, K3 per EN
    # query and per forwarding-error peek with a candidate
    for (protocol, window), want in COSIM_GOLDEN.items():
        n_tasks = want["tasks"]
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with store_query_log() as queries:
            card = _golden_net(dev, protocol, window, n_tasks)
        wall = time.perf_counter() - t0
        counts, calls = ops.launch_counts(), query_calls(queries)
        host = _golden_net(cpu, protocol, window, n_tasks)
        s = card.metrics.summary()
        bad = [k for k, v in want.items() if not math.isclose(s[k], v, rel_tol=1e-9)]
        pairs = list(zip(card.metrics.records, host.metrics.records))
        differ = [a.task_id for a, b in pairs if _record_key(a) != _record_key(b)]
        name = f"cosim golden {protocol}/{window}"
        gap = sims_match(name, [(a.similarity, b.similarity) for a, b in pairs],
                         kernel_sims(queries))
        log(f"  golden {protocol} window {window * 1e3:g} ms, {n_tasks} tasks on the card: "
            f"{wall:.3f} s wall; summary {s}; store queries by route (calls) {calls}; launches "
            f"K4a {counts['lsh_hash_mix']} K3 {counts['gather_top1']} K1 "
            f"{counts['reuse_top1_probed']}; largest similarity gap to the CPU run {gap:.3g}; "
            f"tasks whose outcome differs: {len(differ)} {differ[:20]}")
        expect(not bad, f"{name}: {bad} differ from {want}: {s}")
        expect(not differ, f"{name}: tasks {differ} differ from the CPU run")
        expect(counts["lsh_hash_mix"] > 0 and counts["gather_top1"] == calls["k3"]
               and counts["reuse_top1_probed"] == calls["k1"],
               f"{name}: launches {counts}, store queries by route {calls}")
    # (b) BENCH_cosim.json's rows at load 200 on the card
    rows = {r["name"]: r for r in json.loads(BENCH_COSIM.read_text())["rows"]}
    gaps = []
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    for window in BENCH_WINDOWS:
        for kind, replicas in [("inline", 0)] + [("engine", r) for r in BENCH_REPLICAS]:
            name, us, derived, gap = _bench_cosim_row(dev, kind, window, replicas)
            want = rows[name]
            log(f"  {name}: us_per_call {us} derived {derived}")
            expect((us, derived) == (want["us_per_call"], want["derived"]),
                   f"{name}: got {us} {derived}, BENCH_cosim.json has "
                   f"{want['us_per_call']} {want['derived']}")
            if kind == "engine":
                gaps.append(gap)
    accept = f"min_engine_gap_at_load>=100Hz={float(np.min(gaps)):.2f}x"
    log(f"  BENCH_cosim.json load200 rows on the card in {time.perf_counter() - t0:.3f} s, "
        f"launches {ops.launch_counts()}; {accept}")
    expect(rows["cosim/acceptance"]["derived"].startswith(accept + ";"),
           f"cosim acceptance: {accept}, BENCH_cosim.json has "
           f"{rows['cosim/acceptance']['derived']}")
    # (c) the launcher's co-simulation at full width
    cfg = model.cfg
    X, _ = make_stream(DATASETS[AS_DATASET], AS_REQUESTS, seed=0)
    warm = make_service(model, AS_DATASET, MS_SEQ)
    for x in X[:4]:
        warm.execute(x)
    sync()

    def build(profile=None):
        return build_cosim(model, X, dataset=AS_DATASET, rate=AS_RATE,
                           max_batch=AS_MAX_BATCH, max_wait_s=AS_MAX_WAIT_S,
                           window_s=COSIM_WINDOW_S, seq_len=MS_SEQ, profile=profile,
                           device=dev)

    net, backend = build(profile=True)      # runs the 200 untimed oracle prefills
    svc = net.services[AS_DATASET]
    executions = []
    prefill = svc.execute

    def counted(emb):
        executions.append(1)
        return prefill(emb)

    svc.execute = counted
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with store_query_log() as queries:
        makespan = net.run()
    sync()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    recs = net.metrics.records
    s = net.metrics.summary()
    stats = backend.stats()
    kinds = {str(k): sum(r.reuse == k for r in recs) for k in ("user", "cs", "en", None)}
    en_executed = sum(en.stats["executed"] for en in net.edge_nodes.values())
    admitted = sum(stats[k] for k in ("cs", "en", "executed", "aggregated"))
    by_kind = {k: sum(n for kk, n, _ in queries if kk == k) for k in QUERY_KINDS}
    calls = query_calls(queries)
    log(f"  cosim {cfg.name} (full width, {cfg.n_layers} layers) behind 2 ENs x 2 replicas: "
        f"{AS_REQUESTS} tasks in {wall:.3f} s wall, virtual makespan {makespan:.6f} s (the "
        f"loop's last event), last completion {max(r.t_complete for r in recs):.6f} s; "
        f"reuse_pct {s['reuse_pct']:.1f} (cs {s['reuse_pct_cs']:.1f}, en "
        f"{s['reuse_pct_en']:.1f}), accuracy_pct {s['accuracy_pct']:.1f} (reported: a "
        f"near-duplicate's prompt differs); records by reuse kind {kinds}; engines "
        f"{dict(sorted(stats.items()))}; model executions {len(executions)}, EN inserts "
        f"{en_executed}; store queries by route (calls/queries) "
        f"{ {k: (calls[k], by_kind[k]) for k in calls} }; launches {counts}")
    log(f"  cosim phases {net.registry.phase_summary()}")
    log("  " + net.loop.profiler.report(top=8).replace("\n", "\n  "))
    expect(all(r.t_complete >= 0 for r in recs), "cosim: a task did not complete")
    expect(sum(kinds.values()) == AS_REQUESTS, f"cosim: records by kind {kinds}")
    # K6: 28 launches a model execution (each engine request prefills alone)
    expect(counts["flash_attention"] == cfg.n_layers * len(executions),
           f"cosim: {counts['flash_attention']} flash_attention launches for "
           f"{len(executions)} executions")
    expect(stats["executed"] <= len(executions) <= stats["executed"] + stats["backups"],
           f"cosim: {len(executions)} executions, engines {stats}")
    # K4a (B=1, one launch each): the client hash of every task, the engine
    # router's hash of every admitted miss, and the EN store's insert of
    # every executed result (the replicas insert with the admission hash)
    want_k4 = AS_REQUESTS + admitted + en_executed
    expect(counts["lsh_hash_mix"] == want_k4,
           f"cosim: {counts['lsh_hash_mix']} lsh_hash_mix launches, want {AS_REQUESTS} "
           f"tasks + {admitted} admissions + {en_executed} inserts")
    # K3: one per staged store query (EN window flush, engine dispatch) whose
    # gather work reaches use_kernel_threshold; K1 one per fused query (a
    # window or dispatch of 64 or more)
    expect(counts["gather_top1"] == calls["k3"],
           f"cosim: {counts['gather_top1']} gather_top1 launches, {calls['k3']} staged "
           "queries at the kernel's threshold")
    expect(counts["reuse_top1_probed"] == calls["k1"],
           f"cosim: {counts['reuse_top1_probed']} fused launches, {calls['k1']} fused queries")
    for name in ("lsh_hash", "sim_top1", "decode_attention", "reuse_top1"):
        expect(counts[name] == 0, f"cosim: {name} launched {counts[name]} times")
    # the card's time for the delays PaperDelayModel charges
    en_store = net.edge_nodes[net.en_nodes[0]].stores[AS_DATASET]
    q = normalize(X[0].astype(np.float32))
    hash_ms = _host_ms(lambda: net.lsh.hash_one(q))
    search_ms = _host_ms(lambda: en_store.query_batch(q[None], 0.9))
    big = ReuseStore(LSH_PARAMS, capacity=COSIM_SEARCH_N, device=dev)
    big.insert_batch(_unit(np.random.default_rng(12), COSIM_SEARCH_N, 64),
                     list(range(COSIM_SEARCH_N)))
    big_ms = _host_ms(lambda: big.query_batch(q[None], 0.9))
    dm = PaperDelayModel()
    log(f"  card vs PaperDelayModel (host clock, median of {COSIM_HOST_REPS}, each ending "
        f"in a host read): client hash (K4a, B=1) {hash_ms:.4f} ms vs hash_time_s(5) "
        f"{dm.hash_time_s(5) * 1e3:.4f} ms; EN search of one task (probe, candidates, K3) "
        f"at {len(en_store)} entries {search_ms:.4f} ms vs search_time_s(5, "
        f"{len(en_store)}) {dm.search_time_s(5, len(en_store)) * 1e3:.4f} ms; at "
        f"{COSIM_SEARCH_N} entries {big_ms:.4f} ms vs "
        f"{dm.search_time_s(5, COSIM_SEARCH_N) * 1e3:.4f} ms")
    del big
    profile_call(f"cosim of {AS_REQUESTS} tasks (network run only)",
                 lambda nets=iter([build()[0]]): next(nets).run(), host=False)
    # (d) the launcher itself, as the reference runs it
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "cosim_trace.json"
        argv = ["--engine", "cosim", "--requests", str(AS_CLI_REQUESTS), "--rate",
                str(AS_CLI_RATE), "--trace-out", str(path)]
        log(f"  launcher: main {' '.join(argv)}")
        serve_main(argv)
        spans = [e for e in json.loads(path.read_text())["traceEvents"]
                 if e["name"] == "task" and e["ph"] == "X"]
        expect(sorted(e["tid"] for e in spans) == list(range(AS_CLI_REQUESTS)),
               f"cosim launcher: {len(spans)} task spans for {AS_CLI_REQUESTS} tasks")
    return counts


# phase federation: federation and faults with the reuse stores on the card.
# The rows of benchmarks/federation.py, migration.py and fault_recovery.py as
# the reference's current code gives them (us_per_call, derived); the CPU
# tests hold the port's runs equal to the reference's
# (tests/test_torch_{federation,migration,faults}.py).  BENCH_federation.json
# predates store migration; its least-loaded, reuse-affinity/load160 and
# rebalance rows differ from these.
FED_WANT = {
    "federation/local-only/load80": (432092.68, "p99_ms=432.1;mean_ms=33.3;reuse_pct=86.3;gap=19.84x;hot_share=0.60;offloads=0;remote_hits=0;rebalances=0;forward_ms=8.93;search_ms=0.37;execute_ms=84.97;aggregate_ms=nan"),
    "federation/least-loaded/load80": (219458.88, "p99_ms=219.5;mean_ms=28.7;reuse_pct=83.3;gap=13.26x;hot_share=0.52;offloads=42;remote_hits=9;rebalances=0;forward_ms=8.93;search_ms=0.37;execute_ms=85.05;aggregate_ms=nan"),
    "federation/reuse-affinity/load80": (131081.68, "p99_ms=131.1;mean_ms=22.3;reuse_pct=92.2;gap=8.17x;hot_share=0.33;offloads=133;remote_hits=121;rebalances=0;forward_ms=8.93;search_ms=0.37;execute_ms=85.98;aggregate_ms=nan"),
    "federation/local-only/load160": (899878.34, "p99_ms=899.9;mean_ms=54.4;reuse_pct=85.3;gap=33.88x;hot_share=0.60;offloads=0;remote_hits=0;rebalances=0;forward_ms=8.95;search_ms=0.37;execute_ms=84.97;aggregate_ms=nan"),
    "federation/least-loaded/load160": (305846.53, "p99_ms=305.8;mean_ms=40.8;reuse_pct=79.5;gap=16.33x;hot_share=0.46;offloads=91;remote_hits=24;rebalances=0;forward_ms=8.95;search_ms=0.37;execute_ms=84.60;aggregate_ms=nan"),
    "federation/reuse-affinity/load160": (197130.87, "p99_ms=197.1;mean_ms=24.2;reuse_pct=91.3;gap=8.71x;hot_share=0.32;offloads=147;remote_hits=124;rebalances=0;forward_ms=8.95;search_ms=0.37;execute_ms=85.71;aggregate_ms=nan"),
    "federation/rebalance/load160": (197130.87, "p99_ms=197.1;mean_ms=24.0;reuse_pct=91.3;gap=8.75x;hot_share=0.25;offloads=143;remote_hits=121;rebalances=1;forward_ms=8.94;search_ms=0.37;execute_ms=85.71;aggregate_ms=nan;en0_share=0.25;en0_share_initial=0.41"),
    "migration/baseline": (57074.70, "local_hit_pct=96.3;en_hit_pct=27.3;reuse_pct=96.3;p99_ms=57.1;mean_ms=9.4;moved_bucket_pct=0.0;migrated=0"),
    "migration/stranded": (59151.91, "local_hit_pct=89.3;en_hit_pct=20.3;reuse_pct=89.3;p99_ms=59.2;mean_ms=11.9;moved_bucket_pct=76.6;migrated=0"),
    "migration/migrate": (59033.67, "local_hit_pct=92.8;en_hit_pct=23.8;reuse_pct=92.8;p99_ms=59.0;mean_ms=10.7;moved_bucket_pct=76.6;migrated=63"),
    "migration/autoscale": (184478.37, "scale_ups=1;scale_downs=2;final_ens=2;migrated=66;events=[(0.114, 'add', 4), (0.964, 'remove', 3), (1.564, 'remove', 2)];traj=t0.01:reuse=71.7%,p99=214.2ms|t2.34:reuse=91.4%,p99=53.9ms|t4.68:reuse=100.0%,p99=16.6ms|t7.01:reuse=96.6%,p99=47.2ms|t9.34:reuse=96.8%,p99=44.8ms|t11.67:reuse=93.5%,p99=57.7ms|t14.0:reuse=88.5%,p99=65.2ms|t16.33:reuse=100.0%,p99=16.6ms"),
    "fault_recovery/loss0pct": (243281.68, "completion=100.0%;p99_ms=243.3;mean_ms=30.4;reuse_pct=86.2;retx=0;drops=0;give_ups=0"),
    "fault_recovery/loss1pct": (261865.91, "completion=100.0%;p99_ms=261.9;mean_ms=32.8;reuse_pct=86.6;retx=28;drops=28;give_ups=0"),
    "fault_recovery/loss5pct": (354512.72, "completion=100.0%;p99_ms=354.5;mean_ms=43.8;reuse_pct=88.2;retx=113;drops=113;give_ups=0"),
    "fault_recovery/crash_en0": (250000.00, "completion=100.0%;t_crash=6.25s;time_to_detect_s=0.607;reuse_pre=84.6%;reuse_dip=66.7%;time_to_recover_s=0.25;retx=36;crash_drops=36;routing_repartitioned=True"),
    "fault_recovery/zero_fault_parity": (0.00, "summaries_identical=True;chaos_events=0;reuse_pct=76.0"),
}
FED_DIM, FED_SKEW, FED_NOISE = 64, 1.1, 0.02          # the benchmarks' content stream
FED_REBALANCE_KW = {"rebalance": True, "rebalance_every_rounds": 10, "rebalance_min_tasks": 10,
                    "rebalance_skew": 1.8, "rebalance_persistence": 2}
FAULT_PLAN_SEED = zlib.crc32(b"reservoir-fault-recovery")
FAULT_RETX = {"retx_timeout_s": 0.05, "retx_backoff": 2.0, "retx_max": 6}
# phase federation (b): the launcher's co-simulation with a federator, and
# the rate it falls back to when neither policy runs a miss on the other EN
FED_POLICIES, FED_FALLBACK_RATE = ("least-loaded", "reuse-affinity"), 400.0


def _fed_stream(n: int, seed: int, centers: int, center_seed=None) -> np.ndarray:
    """The benchmarks' Zipf-popular cluster stream (centers from
    ``center_seed``'s generator, else from the picks' generator)."""
    rng = np.random.default_rng(seed)
    crng = rng if center_seed is None else np.random.default_rng(center_seed)
    base = normalize(crng.standard_normal((centers, FED_DIM)).astype(np.float32))
    p = 1.0 / np.arange(1, centers + 1) ** FED_SKEW
    picks = rng.choice(centers, n, p=p / p.sum())
    return normalize(base[picks] + FED_NOISE * rng.standard_normal(
        (n, FED_DIM)).astype(np.float32))


def _zipf_weights(n: int) -> list:
    w = 1.0 / np.arange(1, n + 1)
    return list(w / w.sum())


def _hub_net(dev, n_ens: int, exec_s, plan=None, **kw) -> ReservoirNetwork:
    """``n_ens`` ENs one 5 ms link from a hub (LSH seed 11, network seed 0),
    a chaos controller on ``plan``, then the stub service (result = the
    rounded sum of the input, ``exec_s`` of virtual time), in the
    benchmarks' order."""
    g = nx.Graph()
    ens = [f"en{i}" for i in range(n_ens)]
    for en in ens:
        g.add_edge("core", en, delay=0.005)
    net = ReservoirNetwork(g, ens, LSHParams(dim=FED_DIM, num_tables=5, num_probes=8, seed=11),
                           seed=0, device=dev, **kw)
    if plan is not None:
        ChaosController(net, plan)
    net.register_service(Service("/svc", execute=lambda x: round(float(np.sum(x)), 5),
                                 exec_time_s=exec_s, input_dim=FED_DIM))
    return net


def _add_users(net, n: int) -> None:
    for u in range(n):
        net.add_user(f"u{u}", "core")


def _submit_stream(net, X, arrivals, n_users: int) -> None:
    for i, (t, x) in enumerate(zip(arrivals, X)):
        net.submit_task(f"u{i % n_users}", "svc", x, 0.9, at_time=float(t))


def _poisson(rate: float, n: int, seed: int, t0: float = 0.0) -> np.ndarray:
    return t0 + np.cumsum(np.random.default_rng(seed).exponential(1.0 / rate, n))


def _en0_share(net) -> float:
    """en0's share of table 0's buckets in the hub's rFIB."""
    e0 = [e for e in net.forwarders["core"].rfib.entries("svc") if e.en_prefix == "/en/en0"]
    lo, hi = e0[0].ranges[0] if e0 else (0, -1)
    return (hi - lo + 1) / net.lsh_params.effective_buckets


def _fed_row(dev, policy: str, load: float):
    """benchmarks/federation.py::_run_one at full size (6 ENs, 4 users, a
    Zipf-weighted initial partition, 600 tasks at ``load`` Hz): ([net],
    the row's name, us_per_call, derived)."""
    fkw = FED_REBALANCE_KW if policy == "rebalance" else {"rebalance": False}
    net = _hub_net(dev, 6, (0.070, 0.100),
                   offload_policy="reuse-affinity" if policy == "rebalance" else policy,
                   federation_kw=fkw)
    net.rebalance_service("svc", weights=_zipf_weights(6))
    share0 = _en0_share(net)
    _add_users(net, 4)
    _submit_stream(net, _fed_stream(600, 7, 48), _poisson(load, 600, 2), 4)
    net.run()
    m = net.metrics
    done = m.completed()
    expect(len(done) == 600, f"federation/{policy}/load{load:.0f}: tasks incomplete")
    cts = np.asarray([r.completion_time for r in done])
    instant = [r.completion_time for r in done if r.reuse is not None and not r.aggregated]
    per_en = [net.edge_nodes[n].stats["executed"] + net.edge_nodes[n].stats["reused"]
              for n in net.en_nodes]
    fs = net.federator.stats
    ph = net.registry.phase_summary()
    p99 = float(np.percentile(cts, 99)) * 1e3
    derived = (f"p99_ms={p99:.1f};mean_ms={cts.mean() * 1e3:.1f};"
               f"reuse_pct={m.reuse_fraction() * 100:.1f};"
               f"gap={m.mean_completion(kind=(None,)) / float(np.mean(instant)):.2f}x;"
               f"hot_share={max(per_en) / max(sum(per_en), 1):.2f};offloads={fs['offloads']};"
               f"remote_hits={fs['remote_hits']};rebalances={fs['rebalances']};"
               + ";".join(f"{p}_ms={ph[p + '_ms']:.2f}"
                          for p in ("forward", "search", "execute", "aggregate")))
    if policy == "rebalance":   # en0's share after rebalancing, and before
        derived += f";en0_share={_en0_share(net):.2f};en0_share_initial={share0:.2f}"
    return [net], f"federation/{policy}/load{load:.0f}", round(p99 * 1e3, 2), derived


def _local_hits(records) -> dict:
    cts = np.asarray([r.completion_time for r in records])
    n = max(len(records), 1)
    return {"local_hit_pct": 100.0 * sum(r.reuse is not None and r.remote_en is None
                                         for r in records) / n,
            "en_hit_pct": 100.0 * sum(r.reuse == "en" and r.remote_en is None
                                      for r in records) / n,
            "reuse_pct": 100.0 * sum(r.reuse is not None for r in records) / n,
            "p99_ms": float(np.percentile(cts, 99)) * 1e3, "mean_ms": float(cts.mean()) * 1e3}


def _owner_cells(net) -> np.ndarray:
    entries, p = net.forwarders["core"].rfib.entries("svc"), net.lsh_params
    idx = {q: i for i, q in enumerate(sorted({e.en_prefix for e in entries}))}
    cells = np.full((p.num_tables, p.effective_buckets), -1, np.int64)
    for e in reversed(entries):
        for t, (lo, hi) in e.ranges.items():
            cells[t, lo:hi + 1] = idx[e.en_prefix]
    return cells


def _mig_row(dev, mode: str):
    """benchmarks/migration.py::_run_churn at full size (6 ENs, 400 warm
    tasks at 50 Hz on a Zipf partition, for ``stranded``/``migrate`` a
    re-partition to uniform weights with migration off/on, 600 measured)."""
    net = _hub_net(dev, 6, (0.030, 0.045), store_migration=mode == "migrate")
    _add_users(net, 2)
    net.rebalance_service("svc", weights=_zipf_weights(6))
    _submit_stream(net, _fed_stream(400, 7, 48, 42), _poisson(50.0, 400, 2), 2)
    net.run()
    moved = 0.0
    if mode != "baseline":
        before = _owner_cells(net)
        net.rebalance_service("svc")
        net.run()
        moved = float(np.mean(before != _owner_cells(net)))
    _submit_stream(net, _fed_stream(600, 9, 48, 42), _poisson(50.0, 600, 4, net.loop.now + 0.5), 2)
    net.run()
    done = [r for r in net.metrics.records if r.t_complete >= 0]
    expect(len(done) == 1000, f"migration/{mode}: tasks incomplete")
    r = _local_hits(done[400:])
    migrated = net.federator.stats["migrated_entries"] if net.federator is not None else 0
    derived = (f"local_hit_pct={r['local_hit_pct']:.1f};en_hit_pct={r['en_hit_pct']:.1f};"
               f"reuse_pct={r['reuse_pct']:.1f};p99_ms={r['p99_ms']:.1f};"
               f"mean_ms={r['mean_ms']:.1f};moved_bucket_pct={moved * 100:.1f};"
               f"migrated={migrated}")
    return [net], f"migration/{mode}", round(r["p99_ms"] * 1e3, 2), derived


def _autoscale_row(dev):
    """benchmarks/migration.py::_run_autoscale (3 ENs, least-loaded, store
    migration, ``AutoscalePolicy``; 500 tasks, a burst at 140 Hz then a
    trickle at 12 Hz)."""
    net = _hub_net(dev, 3, (0.030, 0.045), offload_policy="least-loaded",
                   federation_kw={"gossip_interval_s": 0.05, "rebalance": False})
    _add_users(net, 2)
    net.rebalance_service("svc")
    events, added = [], [0]

    def up():
        added[0] += 1
        net.add_en(f"auto{added[0]}", attach_to="core")
        events.append((round(net.loop.now, 3), "add", len(net.en_nodes)))

    def down():
        net.remove_en(net.en_nodes[-1])
        events.append((round(net.loop.now, 3), "remove", len(net.en_nodes)))

    net.federator.attach_autoscaler(
        AutoscalePolicy(high_wait_s=0.02, low_wait_s=0.004, persistence=2, cooldown_rounds=8,
                        min_ens=2, max_ens=6), up, down)
    X = _fed_stream(500, 13, 48, 42)
    burst = _poisson(140.0, 300, 5)
    _submit_stream(net, X[:300], burst, 2)
    _submit_stream(net, X[300:], _poisson(12.0, 200, 6, float(burst[-1]) + 0.2), 2)
    net.run()
    done = [r for r in net.metrics.records if r.t_complete >= 0]
    expect(len(done) == 500, "migration/autoscale: tasks incomplete")
    lo, hi = min(r.t_submit for r in done), max(r.t_submit for r in done)
    edges = np.linspace(lo, hi + 1e-9, 9)
    traj = []
    for a, b in zip(edges[:-1], edges[1:]):
        win = [r for r in done if a <= r.t_submit < b]
        if win:
            m = _local_hits(win)
            traj.append(f"t{round(float(a), 2)}:reuse={round(m['reuse_pct'], 1)}%,"
                        f"p99={round(m['p99_ms'], 1)}ms")
    fs = net.federator.stats
    derived = (f"scale_ups={fs['scale_ups']};scale_downs={fs['scale_downs']};"
               f"final_ens={len(net.en_nodes)};migrated={fs['migrated_entries']};"
               f"events={events};traj={'|'.join(traj)}")
    return [net], "migration/autoscale", round(_local_hits(done)["p99_ms"] * 1e3, 2), derived


def _fault_net(dev, plan, policy=None, fkw=None, retx=True):
    """benchmarks/fault_recovery.py::_build: 3 ENs, 3 users, the ttc
    protocol, retransmission on, a chaos controller on ``plan``."""
    net = _hub_net(dev, 3, (0.070, 0.100), plan, protocol="ttc", offload_policy=policy,
                   federation_kw=fkw, **(FAULT_RETX if retx else {}))
    _add_users(net, 3)
    return net


def _fault_drive(net, n: int = 500) -> None:
    _submit_stream(net, _fed_stream(n, 7, 40), _poisson(40.0, n, 2), 3)
    net.run()


def _loss_row(dev, rate: float):
    """benchmarks/fault_recovery.py::_run_loss: uniform Interest/Data loss
    at ``rate`` on every link, 500 tasks at 40 Hz."""
    net = _fault_net(dev, FaultPlan.uniform_loss(rate, seed=FAULT_PLAN_SEED) if rate
                     else FaultPlan(seed=FAULT_PLAN_SEED))
    _fault_drive(net)
    m, fs = net.metrics, net.fault_stats
    cts = np.asarray([r.completion_time for r in m.completed()])
    p99 = float(np.percentile(cts, 99)) * 1e3
    derived = (f"completion={m.completion_rate() * 100:.1f}%;p99_ms={p99:.1f};"
               f"mean_ms={cts.mean() * 1e3:.1f};reuse_pct={m.reuse_fraction() * 100:.1f};"
               f"retx={fs['retx_sent']};"
               f"drops={net.chaos.stats['interest_drops'] + net.chaos.stats['data_drops']};"
               f"give_ups={fs['retx_give_ups']}")
    return [net], f"fault_recovery/loss{rate * 100:.0f}pct", round(p99 * 1e3, 2), derived


def _crash_row(dev, window: float = 0.25):
    """benchmarks/fault_recovery.py::_run_crash: en0, the Zipf-hot owner,
    crashes at 6.25 s under local-only with 50 ms gossip."""
    t_crash = round(500 / 40.0 * 0.5, 3)
    net = _fault_net(dev, FaultPlan(seed=FAULT_PLAN_SEED).with_crash("en0", t_crash),
                     policy="local-only", fkw={"gossip_interval_s": 0.05})
    net.rebalance_service("svc", weights=_zipf_weights(3))
    _fault_drive(net)
    m, fs = net.metrics, net.fault_stats
    edges = np.arange(0.0, 12.5 + window, window)
    wins = []
    for lo, hi in zip(edges, edges[1:]):
        win = [r for r in m.records if lo <= r.t_submit < hi]
        done = [r for r in win if r.t_complete >= 0]
        wins.append((lo, float("nan") if len(win) < 3
                     else sum(r.reuse is not None for r in done) / len(win)))
    pre = float(np.mean([f for t, f in wins if t + window <= t_crash and t >= 2.0
                         and np.isfinite(f)]))
    post = [(t, f) for t, f in wins if t >= t_crash and np.isfinite(f)]
    recover = next(t for t, f in post if f >= pre - 0.05) - t_crash
    derived = (f"completion={m.completion_rate() * 100:.1f}%;t_crash={t_crash:.2f}s;"
               f"time_to_detect_s={net.federator.health.dead['en0'] - t_crash:.3f};"
               f"reuse_pre={pre * 100:.1f}%;reuse_dip={min(f for _, f in post) * 100:.1f}%;"
               f"time_to_recover_s={recover:.2f};retx={fs['retx_sent']};"
               f"crash_drops={fs['crash_drops']};"
               f"routing_repartitioned={fs['crash_recoveries'] == 1}")
    return [net], "fault_recovery/crash_en0", round(recover * 1e6, 2), derived


def _parity_row(dev):
    """benchmarks/fault_recovery.py::_run_parity: 200 tasks without
    retransmission, plain and with a chaos controller on an empty plan."""
    plain, chaotic = _fault_net(dev, None, retx=False), _fault_net(
        dev, FaultPlan(seed=FAULT_PLAN_SEED), retx=False)
    for net in (plain, chaotic):
        _fault_drive(net, 200)
    derived = (f"summaries_identical={plain.metrics.summary() == chaotic.metrics.summary()};"
               f"chaos_events={sum(chaotic.chaos.stats.values())};"
               f"reuse_pct={chaotic.metrics.reuse_fraction() * 100:.1f}")
    return [plain, chaotic], "fault_recovery/zero_fault_parity", 0.0, derived


def _net_state(net) -> dict:
    """What a federated run left behind, besides its records: every
    counter, the rFIB, and each EN store's live entries in LRU order."""
    ens = {**net._departed, **net._crashed, **net.edge_nodes}
    stores = {}
    for node, en in ens.items():
        for name, store in en.stores.items():
            exp = store.export(store.live_ids())
            stores[(node, name)] = (exp.ids, exp.embeddings.tobytes(), exp.results,
                                    exp.buckets.tolist())
    return {"ens": {n: dict(en.stats) for n, en in ens.items()}, "stores": stores,
            "fault": dict(net.fault_stats),
            "federator": None if net.federator is None else dict(net.federator.stats),
            "chaos": None if net.chaos is None else dict(net.chaos.stats),
            "rfib": [(e.en_prefix, e.ranges) for e in net.forwarders["core"].rfib.entries("svc")]}


def _same_run(name: str, card: ReservoirNetwork, host: ReservoirNetwork, scored: set) -> float:
    """Hold a run with its stores on the card to the same run on the CPU:
    every record field but the similarity equal (a flipped winner fails
    here and is printed), each similarity bit-equal where the host scored
    it and within ``COSIM_SIM_TOL`` where K3 or K1 did (``scored``: what the
    kernels returned, ``sims_match``), every counter and store equal.
    Returns the largest similarity gap."""
    pairs = list(zip(card.metrics.records, host.metrics.records))
    expect(len(pairs) == len(host.metrics.records) == len(card.metrics.records),
           f"{name}: {len(card.metrics.records)} records on the card, "
           f"{len(host.metrics.records)} on the CPU")
    key = lambda r: dataclasses.astuple(dataclasses.replace(r, similarity=0.0))  # noqa: E731
    differ = [(a.task_id, a.reuse, b.reuse, a.reuse_node, b.reuse_node, a.similarity,
               b.similarity) for a, b in pairs if key(a) != key(b)]
    if differ:
        log(f"  {name}: {len(differ)} tasks differ from the CPU run (task, reuse card/cpu, "
            f"node card/cpu, similarity card/cpu): {differ[:10]}")
    expect(not differ, f"{name}: {len(differ)} tasks differ from the CPU run")
    gap = sims_match(name, [(a.similarity, b.similarity) for a, b in pairs], scored)
    card_state, host_state = _net_state(card), _net_state(host)
    bad = [k for k in host_state if card_state[k] != host_state[k]]
    expect(not bad, f"{name}: {bad} differ from the CPU run")
    return gap


def _remote_executions(net, backend):
    """Count the model executions of a co-simulation, and which of them
    ran a federated task (a miss another EN offloaded here), with the K6
    launches each made: a list of (federated, K6 launches), one an
    execution.  Observes only."""
    federated, executions = [], []
    submit, svc = backend.submit, net.services[AS_DATASET]
    prefill = svc.execute

    def noting(node, svc_name, interest, emb, lead_delay_s, defer_inserts=None):
        if interest.app_params.get("federated"):
            federated.append(emb)       # kept alive: its id names it below
        return submit(node, svc_name, interest, emb, lead_delay_s, defer_inserts)

    def counted(emb):
        k6 = ops.launch_counts()["flash_attention"]
        out = prefill(emb)
        executions.append((any(emb is f for f in federated),
                           ops.launch_counts()["flash_attention"] - k6))
        return out

    backend.submit, svc.execute = noting, counted
    return executions


def phase_federation(dev: torch.device, model) -> dict:
    """Federation and faults with the reuse stores on the card: (a) the
    stub-service arms of the federation, migration and fault-recovery
    benchmarks, each held record by record to its CPU run and to the
    reference's row; (b) the launcher's co-simulation with ``model``
    (qwen3-1.7b at full width) behind two federated engine-backed ENs, under
    least-loaded and reuse-affinity, and ``main --engine cosim
    --offload-policy reuse-affinity``.  Returns (b)'s reuse-affinity run's
    launches."""
    cpu = torch.device("cpu")
    # (a) K4a per client hash, engine-free EN insert; K3 per EN query, peek
    # and remote query with a candidate; migration inserts carry buckets
    arms = ([functools.partial(_fed_row, policy=p, load=load) for load in (80.0, 160.0)
             for p in ("local-only", "least-loaded", "reuse-affinity")]
            + [functools.partial(_fed_row, policy="rebalance", load=160.0)]
            + [functools.partial(_mig_row, mode=m) for m in ("baseline", "stranded", "migrate")]
            + [_autoscale_row] + [functools.partial(_loss_row, rate=r) for r in (0.0, 0.01, 0.05)]
            + [_crash_row, _parity_row])
    t_all = time.perf_counter()
    for arm in arms:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with store_query_log() as queries:
            nets, name, us, derived = arm(dev)
        wall = time.perf_counter() - t0
        counts, calls = ops.launch_counts(), query_calls(queries)
        host_nets, _, host_us, host_derived = arm(cpu)
        scored = kernel_sims(queries)
        gap = max(_same_run(name, a, b, scored) for a, b in zip(nets, host_nets))
        want = FED_WANT[name]
        log(f"  {name} on the card in {wall:.3f} s: {us} {derived}; reference {want[0]} "
            f"{want[1]}; store queries by route (calls) {calls}; K4a {counts['lsh_hash_mix']} "
            f"K3 {counts['gather_top1']} K1 {counts['reuse_top1_probed']}; largest similarity "
            f"gap to the CPU run {gap:.3g}")
        expect((us, derived) == (host_us, host_derived),
               f"{name}: card {us} {derived}, CPU {host_us} {host_derived}")
        expect((us, derived) == want, f"{name}: {us} {derived}, the reference gives {want}")
        expect(counts["lsh_hash_mix"] > 0 and counts["gather_top1"] == calls["k3"]
               and counts["reuse_top1_probed"] == calls["k1"],
               f"{name}: launches {counts}, store queries by route {calls}")
    log(f"  stub arms on the card and the CPU in {time.perf_counter() - t_all:.3f} s")

    # (b) the launcher's co-simulation at full width, federated
    cfg = model.cfg
    X, _ = make_stream(DATASETS[AS_DATASET], AS_REQUESTS, seed=0)
    warm = make_service(model, AS_DATASET, MS_SEQ)
    for x in X[:4]:
        warm.execute(x)
    sync()

    def build(policy, rate=AS_RATE, profile=None):
        return build_cosim(model, X, dataset=AS_DATASET, rate=rate, max_batch=AS_MAX_BATCH,
                           max_wait_s=AS_MAX_WAIT_S, window_s=COSIM_WINDOW_S, seq_len=MS_SEQ,
                           profile=profile, offload_policy=policy, device=dev)

    def run(policy, rate=AS_RATE):
        net, backend = build(policy, rate, profile=True)   # runs the oracle prefills
        executions = _remote_executions(net, backend)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with store_query_log() as queries:
            makespan = net.run()
        sync()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        recs, s, stats, fs = (net.metrics.records, net.metrics.summary(), backend.stats(),
                              net.federator.stats)
        kinds = {str(k): sum(r.reuse == k for r in recs) for k in ("user", "cs", "en", None)}
        en_executed = sum(en.stats["executed"] for en in net.edge_nodes.values())
        admitted = sum(stats[k] for k in ("cs", "en", "executed", "aggregated"))
        calls = query_calls(queries)
        remote = [k6 for fed, k6 in executions if fed]
        log(f"  cosim --offload-policy {policy} at {rate:g} req/s, {cfg.name} (full width, "
            f"{cfg.n_layers} layers) behind 2 ENs x 2 replicas: {AS_REQUESTS} tasks in "
            f"{wall:.3f} s wall, virtual makespan {makespan:.6f} s, last completion "
            f"{max(r.t_complete for r in recs):.6f} s; reuse_pct {s['reuse_pct']:.1f} (cs "
            f"{s['reuse_pct_cs']:.1f}, en {s['reuse_pct_en']:.1f}); records by reuse kind "
            f"{kinds}; federation offloads {fs['offloads']} remote_hits {fs['remote_hits']} "
            f"remote_execs {fs['remote_execs']} remote_coalesced {fs['remote_coalesced']} "
            f"rebalances {fs['rebalances']} decisions {fs['decisions']}; engines "
            f"{dict(sorted(stats.items()))}; model executions {len(executions)}, of them "
            f"for a federated task {len(remote)} (K6 launches {sum(remote)}); EN inserts "
            f"{en_executed}; store queries by route (calls) {calls}; launches "
            f"{counts}")
        log("  " + net.loop.profiler.report(top=8).replace("\n", "\n  "))
        expect(all(r.t_complete >= 0 for r in recs), f"cosim {policy}: a task did not complete")
        expect(sum(kinds.values()) == AS_REQUESTS, f"cosim {policy}: records by kind {kinds}")
        expect(fs["offloads"] == sum(en.stats["offloaded"] for en in net.edge_nodes.values()),
               f"cosim {policy}: offloads {fs['offloads']} vs the ENs' counts")
        # K6: 28 launches a model execution, a federated one included
        expect(counts["flash_attention"] == cfg.n_layers * len(executions)
               and all(k6 == cfg.n_layers for _, k6 in executions),
               f"cosim {policy}: {counts['flash_attention']} flash_attention launches for "
               f"{len(executions)} executions")
        # K4a (B=1): every client hash, every engine admission (the engine
        # router's hash; remote executions included) and every EN insert of
        # an executed result (at the EN that ran it)
        want_k4 = AS_REQUESTS + admitted + en_executed
        expect(counts["lsh_hash_mix"] == want_k4,
               f"cosim {policy}: {counts['lsh_hash_mix']} lsh_hash_mix launches, want "
               f"{AS_REQUESTS} tasks + {admitted} admissions + {en_executed} inserts")
        # K3: one a staged store query whose gather work reaches
        # use_kernel_threshold: EN window flushes, engine dispatches, the
        # federator's peeks and remote queries
        expect(counts["gather_top1"] == calls["k3"],
               f"cosim {policy}: {counts['gather_top1']} gather_top1 launches, "
               f"{calls['k3']} staged queries at the kernel's threshold")
        expect(counts["reuse_top1_probed"] == calls["k1"],
               f"cosim {policy}: {counts['reuse_top1_probed']} fused launches, "
               f"{calls['k1']} fused queries")
        for name in ("lsh_hash", "sim_top1", "decode_attention", "reuse_top1"):
            expect(counts[name] == 0, f"cosim {policy}: {name} launched {counts[name]} times")
        return counts, len(remote)

    runs = {policy: run(policy) for policy in FED_POLICIES}
    if not any(n for _, n in runs.values()):
        log(f"  no policy ran a miss on the other EN at {AS_RATE:g} req/s: least-loaded at "
            f"{FED_FALLBACK_RATE:g} req/s")
        runs["fallback"] = run("least-loaded", FED_FALLBACK_RATE)
    expect(any(n for _, n in runs.values()),
           "cosim federation: no model execution on a remote EN")
    profile_call(f"federated cosim (reuse-affinity) of {AS_REQUESTS} tasks (network run only)",
                 lambda nets=iter([build("reuse-affinity")[0]]): next(nets).run(), host=False)
    # the launcher itself, as a user runs it
    argv = ["--engine", "cosim", "--offload-policy", "reuse-affinity"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        serve_main(argv)
    text = out.getvalue()
    log(f"  launcher: main {' '.join(argv)}\n  " + text.strip().replace("\n", "\n  "))
    expect(f"{AS_REQUESTS} tasks through the co-sim" in text
           and "federation[reuse-affinity]: offloads=" in text,
           "cosim launcher: no federation line")
    return runs["reuse-affinity"][0]


# ------------------------------------------------------------------ phase 10b
# phase near-tie: the store's scoring route where a plain dot and the cosine
# order rows differently (src/repro/core/reuse_store.py's query and
# _score_batch: the host's cosine below use_kernel_threshold, the kernel from
# it; the port takes that route on every device)
NEAR_TIE_GROUPS, NEAR_TIE_GROUP, NEAR_TIE_EPS = 1000, 8, 1e-6
NEAR_TIE_BATCHES = (1, 8, 32)   # gather work ~2000 (host), ~16k and ~70k (K3)
NEAR_TIE_MIN_DISAGREE = 10


def phase_near_tie(dev: torch.device, seed: int = 15) -> dict:
    """The near-tie trace into a store on the card and one on the CPU:
    scalar ``query`` and staged ``query_batch`` (``fused = False``) at
    NEAR_TIE_BATCHES, each call's route read from the store's own rule;
    below the threshold bit-equal to the CPU, above it K3 once a batch.

    Above the threshold this phase shows the route and the launch count,
    not which row K3 picks: the 8 rows of a group are ties for any dot
    (float64 margins ~1e-12, under TIE_MARGIN), so ids may differ within a
    group there and still pass.  K3's similarities are held against the
    plain ``gather_top1_ref`` on the same candidate ids within SCORE_TOL;
    its ids are held tightly in phases top1 and serve.  Returns the trace's
    launches."""
    cpu = torch.device("cpu")
    rows, q = near_tie_trace(NEAR_TIE_GROUPS, seed, group=NEAR_TIE_GROUP, eps=NEAR_TIE_EPS)
    disagree = dot_cosine_disagree(rows, q)
    log(f"  near-tie trace: {NEAR_TIE_GROUPS} groups of {NEAR_TIE_GROUP} rows at dim 64, "
        f"{NEAR_TIE_EPS:g} around a base (seed {seed}); groups whose best row by a plain dot "
        f"is not their best by cosine: {disagree}")
    expect(disagree >= NEAR_TIE_MIN_DISAGREE,
           f"near-tie: only {disagree} groups where dot and cosine disagree")
    n = NEAR_TIE_GROUPS * NEAR_TIE_GROUP
    card, host = (ReuseStore(LSH_PARAMS, capacity=n, device=d, fused=False) for d in (dev, cpu))
    for st in (card, host):
        st.insert_batch(rows.reshape(-1, 64), list(range(n)))
    sync()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with store_query_log() as queries:
        got = {"scalar": [card.query(x, 0.9) for x in q]}
        for b in NEAR_TIE_BATCHES:
            got[b] = [card.query_batch(q[i:i + b], 0.9, peek=True) for i in range(0, len(q), b)]
        sync()
    wall = time.perf_counter() - t0
    counts, calls = ops.launch_counts(), query_calls(queries)
    want = {"scalar": [host.query(x, 0.9) for x in q]}
    for b in NEAR_TIE_BATCHES:
        want[b] = [host.query_batch(q[i:i + b], 0.9, peek=True) for i in range(0, len(q), b)]
    kinds = iter(kind for kind, _, _ in queries)
    below = above = ties = 0
    for key in ("scalar", *NEAR_TIE_BATCHES):
        outs = [[o] for o in got[key]] if key == "scalar" else got[key]
        wants = [[o] for o in want[key]] if key == "scalar" else want[key]
        for i, (a, b) in enumerate(zip(outs, wants)):
            kind = next(kinds)
            if kind in ("host", "none"):
                below += len(a)
                expect(a == b, f"near-tie {key} call {i} (scored on the host): {a} on the "
                       f"card, {b} on the CPU")
            else:
                expect(kind == "k3", f"near-tie {key} call {i}: route {kind}")
                above += len(a)
                x = q[i:i + 1] if key == "scalar" else q[i * key:(i + 1) * key]
                ties += compare_query(f"near-tie batch of {key} call {i}", host, x, a, b)
    # what K3's dot, the route a CUDA store took for small work before, picks,
    # against the plain version on the same candidate ids
    card.sync_device(ensure=True)
    cand = [host.candidates(x) for x in q]
    ids = np.full((len(q), max(map(len, cand))), -1, np.int32)
    for i, c in enumerate(cand):
        ids[i, :len(c)] = c
    q_dev, ids_dev = torch.from_numpy(q).to(dev), torch.from_numpy(ids).to(dev)
    k3 = sim_topk.gather_top1(q_dev, card._emb_dev, ids_dev)
    k3_err, k3_ties = check_top1("near-tie gather_top1", q, rows.reshape(-1, 64), k3,
                                 ref.gather_top1_ref(q_dev, card._emb_dev, ids_dev))
    k3_idx = k3[1].cpu().numpy()
    flips = int(sum(k3_idx[i] != r[2] for i, r in enumerate(want["scalar"]) if r[2] is not None))
    log(f"  near-tie on the card: {len(q)} scalar queries and staged batches of "
        f"{NEAR_TIE_BATCHES} in {wall:.3f} s; store queries by route (calls) {calls}; "
        f"{below} answers scored on the host, bit-equal to the CPU; "
        f"{above} scored by K3, ids off the CPU's at float64 near-ties {ties}; launches "
        f"{counts}; K3's dot on the {len(q)} scalar queries' candidates would answer "
        f"{flips} of them with another row than the host's cosine (against the plain "
        f"gather_top1 on the same ids: max |sim error| {k3_err:.3g}, ids off at float64 "
        f"near-ties {k3_ties})")
    expect(below > 0 and above > 0, f"near-tie: {below} answers below the threshold, {above} "
           "above it")
    expect(counts["gather_top1"] == calls["k3"] > 0 and counts["reuse_top1_probed"] == 0,
           f"near-tie: launches {counts}, store queries by route {calls}")
    return counts


# ------------------------------------------------------------------ phase 10c
# phase examples: examples/torch_*.py on the card against their CPU runs
EXAMPLES_DIR = ROOT / "examples"
EXAMPLE_TRAIN_STEPS = 5
EXAMPLE_EXEC_S = 0.05      # the cognitive assistant's virtual execution time


def load_example(name: str):
    """``examples/<name>.py`` as a module."""
    path = EXAMPLES_DIR / f"{name}.py"
    expect(path.exists(), f"examples/{name}.py is missing")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_examples(dev: torch.device) -> tuple:
    """The three examples of the port on the card, each against its CPU run
    (same seeds; the models' weights drawn on the CPU for both).  Returns
    each example's launches."""
    cpu = torch.device("cpu")
    # quickstart: the two-EN testbed, 200 cctv1 tasks
    qs = load_example("torch_quickstart")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with store_query_log() as queries:
        card = qs.run(dev)
        sync()
    wall = time.perf_counter() - t0
    quick, calls = ops.launch_counts(), query_calls(queries)
    host = qs.run(cpu)
    log(f"  torch_quickstart on the card in {wall:.3f} s: "
        + " | ".join(qs.report(card)).replace("\n", "")
        + f"; store queries by route (calls) {calls}; launches {quick}")
    expect(card == host, f"quickstart: summary {card} on the card, {host} on the CPU")
    expect(quick["gather_top1"] == calls["k3"] and quick["reuse_top1_probed"] == calls["k1"],
           f"quickstart: launches {quick}, store queries by route {calls}")
    # cognitive assistance: a reduced phi-3-vision behind 3 -> 2 replicas, at
    # a fixed virtual execution time (in wall time the hits change with the
    # host's speed, the reference's too)
    ca = load_example("torch_cognitive_assistance")

    class Fleet(ca.ServingFleet):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.engine.exec_time_fn = lambda rid, service, reqs: EXAMPLE_EXEC_S

    ca.ServingFleet = Fleet
    cfg = get_arch("phi-3-vision-4.2b").reduced()
    params = {n: p.detach() for n, p in build_model(cfg, cpu, seed=0).named_parameters()}
    prefills, prefill = [], DecoderLM.prefill

    def counted(self, *a, **k):
        prefills.append(1)
        return prefill(self, *a, **k)

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    DecoderLM.prefill = counted
    try:
        with store_query_log() as queries:
            card = ca.run(dev, params=params)
            sync()
    finally:
        DecoderLM.prefill = prefill
    wall = time.perf_counter() - t0
    cog, calls = ops.launch_counts(), query_calls(queries)
    host = ca.run(cpu, params=params)
    keys = ("events", "stats", "per_replica")
    log(f"  torch_cognitive_assistance on the card in {wall:.3f} s: "
        + " | ".join(ca.report(card)).replace("\n", "")
        + f"; stats {card['stats']}; model prefills {len(prefills)}; store queries by route "
        f"(calls) {calls}; launches {cog}")
    expect({k: card[k] for k in keys} == {k: host[k] for k in keys},
           f"cognitive assistance: {[card[k] for k in keys]} on the card, "
           f"{[host[k] for k in keys]} on the CPU")
    expect(cog["flash_attention"] == cfg.n_layers * len(prefills)
           and len(prefills) >= card["stats"]["executed"] > 0,
           f"cognitive assistance: {cog['flash_attention']} flash_attention launches for "
           f"{len(prefills)} prefills of {cfg.n_layers} layers ({card['stats']['executed']} "
           "executed)")
    expect(cog["gather_top1"] == calls["k3"] and cog["reuse_top1_probed"] == calls["k1"],
           f"cognitive assistance: launches {cog}, store queries by route {calls}")
    # train_lm at its default width (~100M parameters), 5 steps; step 1 on the CPU
    tl = load_example("torch_train_lm")
    cfg = tl.lm_config(512)
    params = {n: p.detach() for n, p in
              build_model(cfg, cpu, seed=0, trainable=True).named_parameters()}
    with tempfile.TemporaryDirectory() as tmp:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        card = tl.run(["--steps", str(EXAMPLE_TRAIN_STEPS), "--ckpt-dir", f"{tmp}/card"],
                      device=dev, params=params)
        sync()
        wall = time.perf_counter() - t0
        train = ops.launch_counts()
        t0 = time.perf_counter()
        host = tl.run(["--steps", "1", "--ckpt-dir", f"{tmp}/cpu"], device=cpu, params=params)
        cpu_s = time.perf_counter() - t0
    first, ref = card["logged"][0], host["logged"][0]
    errs = [abs(a - b) / abs(b) for a, b in zip(first[1:], ref[1:])]
    log(f"  torch_train_lm on the card, {EXAMPLE_TRAIN_STEPS} steps at width 512 in {wall:.3f} "
        f"s: " + " | ".join(card["lines"]).replace("\n", "") + f"; step 1 (loss, grad norm, "
        f"lr) card {first[1:]} vs CPU {ref[1:]} ({cpu_s:.3f} s), relative {errs}; launches "
        f"{ {k: v for k, v in train.items() if v} }")
    expect(all(np.isfinite(v) for _, *vals in card["logged"] for v in vals)
           and np.isfinite(card["final"]), f"train_lm: {card['logged']} {card['final']}")
    expect(first[0] == ref[0] == 0 and max(errs) <= TRAIN_F32_REL_TOL,
           f"train_lm step 1: card {first}, CPU {ref}")
    fwd, bwd = train_launches(cfg)
    expect_launches("train_lm", train, 2 * EXAMPLE_TRAIN_STEPS * fwd, 2 * EXAMPLE_TRAIN_STEPS * bwd)
    return quick, cog, train


# ------------------------------------------------------------------ main
# ------------------------------------------------------------------ phase 11
# phase train: K6's backward, the train step against its CPU run, checkpoint
# and restart, and launch/train.py at full width.
def grad_err(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """A backward kernel's output vs its plain version's on the same inputs:
    finite; fp32 within BWD_REL_TOL of the largest |value| (sums of up
    to S products in another order); bf16 within one bf16 ulp of the plain
    value plus that share (both round an fp32 sum to bf16).  -> max |error|."""
    g, w = got.float(), want.float()
    expect(bool(torch.isfinite(g).all()), f"{name}: non-finite output")
    err = (g - w).abs()
    lim = BWD_REL_TOL * float(w.abs().max())
    if got.dtype == torch.bfloat16:
        lim = lim + w.abs() * 2.0 ** -7
    bad = int((err > lim).sum())
    expect(bad == 0, f"{name}: {bad} values off, max |error| {err.max().item():.3g}")
    return float(err.max())


def lse_err(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """The forward's lse vs the plain lse: +inf at the same rows (no key),
    the rest within 1e-5 (the bf16 route's softmax runs in base 2)."""
    inf = torch.isinf(want)
    expect(bool(torch.equal(torch.isinf(got), inf)) and bool((got[inf] > 0).all()),
           f"{name}: lse is not +inf exactly at the rows without a key")
    err = float((got[~inf] - want[~inf]).abs().max()) if bool((~inf).any()) else 0.0
    expect(err <= 1e-5 * max(1.0, float(want[~inf].abs().max())),
           f"{name}: lse off by {err:.3g}")
    return err


def bwd_check(gen, dev, B, S, T, H, KV, D, dt, kw) -> dict:
    """K6 forward with lse, then the three backward kernels, against the
    plain versions on the same inputs -> max errors by output."""
    q = _randn(gen, B, S, H, D, dtype=dt, dev=dev)
    k, v = (_randn(gen, B, T, KV, D, dtype=dt, dev=dev) for _ in range(2))
    scale = kw.pop("scale", 1.0 / math.sqrt(D))
    qo = kw.get("q_offset", 0)
    masks = (kw.get("causal", True), kw.get("window"), kw.get("softcap"), scale)
    out, lse = flash_k.forward(q, k, v, *masks, with_lse=True, q_offset=qo)
    want_out, want_lse = ref.flash_attention_ref(q, k, v, causal=masks[0], window=masks[1],
                                                 softcap=masks[2], scale=scale, return_lse=True,
                                                 q_offset=qo)
    shape = f"B={B} S={S} T={T} H={H} KV={KV} D={D} {str(dt)[6:]} {kw}"
    errs = {"out": attn_err(f"flash_attention {shape}", out, want_out, ATTN_BF16_TOL),
            "lse": lse_err(f"lse {shape}", lse, want_lse)}
    dout = _randn(gen, B, S, H, D, dtype=dt, dev=dev)
    got = flash_k.backward(q, k, v, out, lse, dout, *masks, q_offset=qo)
    want = ref.flash_attention_bwd_ref(q, k, v, out, lse, dout, causal=masks[0],
                                       window=masks[1], softcap=masks[2], scale=scale,
                                       q_offset=qo)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        errs[name] = grad_err(f"{name} {shape}", g, w)
    log(f"  flash_attention backward {shape}: max err " + ", ".join(
        f"{k} {e:.3g}" for k, e in errs.items()))
    return errs


def profiled_device_ms(fn, reps: int, required: bool = True):
    """Device time per call in ms from torch.profiler's kernel times over
    ``reps`` calls (after a warm-up call), for a call a CUDA graph cannot
    hold: autograd runs a backward on its forward's stream, so a capture on
    another stream does not see it.  Not ``required``: None where the
    profiler saw no device time (it has seen none for a call of K6's
    forward and backward alone after the script's earlier phases), so the
    caller reports that time as not measured."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        sync()
    dev_ms = sum(getattr(e, "self_device_time_total", 0.0) for e in prof.key_averages()
                 if str(e.device_type).endswith("CUDA")) / 1e3
    if not required and dev_ms <= 0:
        return None
    expect(dev_ms > 0, "the profiler saw no device time")
    return dev_ms / reps


def bwd_rows(gen, dev) -> dict:
    """The backward kernels at qwen3-1.7b's training shape (bf16, causal),
    each entry point launched as the wrapper launches it (the route and
    launch shape of ``bwd_launch_plan``): against the plain versions, each
    timed (a call with its launch, and device time over a CUDA graph)
    beside its plain version with its bound and the TFLOP/s of the
    products it issues and of those its outputs need; the three together
    beside SDPA's backward."""
    B, S, H, KV, D = ATTN_B, ATTN_S, ATTN_H, ATTN_KV, ATTN_D
    q = _randn(gen, B, S, H, D, dev=dev)
    k, v = (_randn(gen, B, S, KV, D, dev=dev) for _ in range(2))
    dout = _randn(gen, B, S, H, D, dev=dev)
    scale = 1.0 / math.sqrt(D)
    masks = (True, None, None, scale)
    out, lse = flash_k.forward(q, k, v, *masks, with_lse=True)
    want_lse = ref.flash_attention_ref(q, k, v, scale=scale, return_lse=True)[1]
    lse_e = lse_err("lse at the training shape", lse, want_lse)
    want = ref.flash_attention_bwd_ref(q, k, v, out, lse, dout, scale=scale)
    got = flash_k.backward(q, k, v, out, lse, dout, *masks)
    errs = {n: grad_err(f"{n} at the training shape", g, w)
            for n, g, w in zip(("dq", "dk", "dv"), got, want)}
    plan = flash_k.bwd_launch_plan(q.dtype, B, S, S, H, KV, D)
    tc = plan["route"] == "wgmma"
    delta = torch.empty((B, H, S), dtype=torch.float32, device=dev)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
            delta.data_ptr())
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    dims = (B, S, S, H, KV, D, 1, -1, 0, -1.0, scale, 1)

    def run(fn, *a):   # one entry point as the wrapper launches it
        build.launch("flash_attention_bwd", fn, dev, *a)

    def k_delta():
        run("flash_attention_bwd_delta_launch", out.data_ptr(), dout.data_ptr(),
            delta.data_ptr(), B * S * H, D, S, H, 1)

    k_delta()
    want_delta = (dout.float() * out.float()).sum(-1).permute(0, 2, 1)
    errs["delta"] = float((delta - want_delta).abs().max())
    expect(errs["delta"] <= BWD_REL_TOL * float(want_delta.abs().max()),
           f"delta off by {errs['delta']:.3g}")
    fns = {"flash_attention_bwd_delta": k_delta,
           "flash_attention_bwd_dkdv": lambda: run(
               "flash_attention_bwd_dkdv_launch", *args, dk.data_ptr(), dv.data_ptr(), *dims,
               *flash_k.bwd_launch_args(plan, "dkdv")),
           "flash_attention_bwd_dq": lambda: run(
               "flash_attention_bwd_dq_launch", *args, dq.data_ptr(), *dims,
               *flash_k.bwd_launch_args(plan, "dq"))}
    plain_delta = lambda: (dout.float() * out.float()).sum(-1).permute(0, 2, 1)  # noqa: E731
    plain_bwd = lambda: ref.flash_attention_bwd_ref(q, k, v, out, lse, dout,  # noqa: E731
                                                    scale=scale)
    half = S * (S + 1) // 2                       # causal (query, key) pairs a head
    pair_flop = 2.0 * B * H * D * half            # one product over the causal half
    n_q, n_kv = 2 * q.numel(), 2 * k.numel()      # bf16 bytes of q (= dout, out) and k (= v)
    lse_b = 4 * B * H * S
    work = {"flash_attention_bwd_delta": (2 * n_q + lse_b, 2.0 * B * S * H * D),
            # reads q, k, v, dout, lse, delta; writes dk, dv; S, dP, dV, dK
            "flash_attention_bwd_dkdv": (2 * n_q + 4 * n_kv + 2 * lse_b, 4 * pair_flop),
            # reads q, k, v, dout, lse, delta; writes dq; S, dP, dQ
            "flash_attention_bwd_dq": (3 * n_q + 2 * n_kv + 2 * lse_b, 3 * pair_flop)}
    # product passes each kernel issues: on the wgmma route dV, dK and dQ
    # twice (P and dS split hi + lo), S^T in both warpgroups of dK/dV
    issued = {"flash_attention_bwd_delta": 2.0 * B * S * H * D,
              "flash_attention_bwd_dkdv": (7 if tc else 4) * pair_flop,
              "flash_attention_bwd_dq": (4 if tc else 3) * pair_flop}
    rows = {}
    for name, fn in fns.items():
        ms, dev_ms = median_ms(fn, REPS), graph_ms(fn, REPS)
        plain_ms = median_ms(plain_delta if name.endswith("delta") else plain_bwd, PLAIN_REPS)
        bms, by = bound(*work[name], BF16_FLOP_PER_S)
        err = max(errs[o] for o in {"delta": ("delta",), "dkdv": ("dk", "dv"),
                                    "dq": ("dq",)}[name.rsplit("_", 1)[1]])
        # "route" of the kernels line is the language (cuda); this is the plan's
        rows[name] = {"kernel_route": plan["route"], "max_abs_err": err, "ms": ms,
                      "device_ms": dev_ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                      "library_ms": None, "library_device_ms": None,
                      "tflops": work[name][1] / dev_ms / 1e9,
                      "issued_tflops": issued[name] / dev_ms / 1e9}
        log(f"  {name} B={B} S={S} H={H} KV={KV} D={D} bf16 causal ({plan['route']}): {ms:.4f} "
            f"ms a call, {dev_ms:.4f} ms device; {work[name][1] / dev_ms / 1e9:.2f} TFLOP/s of "
            f"the products its outputs need, {issued[name] / dev_ms / 1e9:.2f} of those it "
            f"issues; bound {bms:.5f} ms by {by}; plain {plain_ms:.4f} ms")
    # the whole backward (one wrapper call) beside SDPA's backward
    t = whole_backward_times(q, k, v, out, lse, dout, masks, want)
    log(f"  flash_attention backward (3 kernels, {plan['route']}) B={B} S={S} bf16 causal: "
        f"{t['ms']:.4f} ms a call, {t['device_ms']:.4f} ms device, {t['tflops']:.2f} TFLOP/s "
        f"of the 5 products; sdpa backward {t['library_backward_ms']:.4f} ms a call, "
        f"{t['library_backward_device_ms']:.4f} ms device (profiler) "
        f"({t['ms'] / t['library_backward_ms']:.2f}x a call, "
        f"{t['device_ms'] / t['library_backward_device_ms']:.2f}x on device, its grads "
        f"{t['library_rel']:.3g} of the max off plain, backend {t['library_backend']}); bound "
        f"{t['bound_ms']:.5f} ms by "
        f"{t['bound_by']}; lse max err {lse_e:.3g}; grads max err "
        + ", ".join(f"{k} {e:.3g}" for k, e in errs.items()))
    rows["flash_attention_bwd_dkdv"].update(
        {"whole_backward_ms": t["ms"], "whole_backward_device_ms": t["device_ms"],
         "whole_tflops": t["tflops"], "whole_bound_ms": t["bound_ms"],
         "whole_bound_by": t["bound_by"], "library_backward_ms": t["library_backward_ms"],
         "library_backward_device_ms": t["library_backward_device_ms"]})
    for name in ("flash_attention_bwd_dkdv", "flash_attention_bwd_dq"):
        # SDPA's whole backward (dq, dk and dv)
        rows[name].update({"library_ms": t["library_backward_ms"],
                           "library_device_ms": t["library_backward_device_ms"]})
    return rows


def sdpa_backend(fn) -> tuple:
    """(backend, its kernel with the most device time) of the SDPA calls in
    ``fn``, named from the kernels a profile of one call shows: cuDNN's,
    FlashAttention's (``flash``), the memory-efficient one's (``fmha``) or
    else the math route's; ("not seen", None) where the profiler saw no
    kernel (it has missed a whole call late in a run)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        sync()
    kernels = sorted(((e.duration_ns(), e.name()) for e in prof.profiler.kineto_results.events()
                      if str(e.device_type()).endswith("CUDA")), reverse=True)
    if not kernels:
        return "not seen", None
    names = " ".join(k for _, k in kernels).lower()
    backend = next((b for tag, b in (("cudnn", "cudnn"), ("flash", "flash"),
                                     ("fmha", "efficient"), ("mem_eff", "efficient"))
                    if tag in names), "math")
    return backend, kernels[0][1]


def whole_backward_times(q, k, v, out, lse, dout, masks, want) -> dict:
    """K6's whole backward (one wrapper call: delta, dK/dV, dQ) and SDPA's
    backward on the same bf16 inputs: ms a call (CUDA events), device ms
    (a CUDA graph; SDPA's from torch.profiler's kernel times, as a graph
    does not capture autograd's backward) and ms a call over a loop of
    calls (``loop_ms``, both, where the profiler may miss SDPA's kernels),
    K6's TFLOP/s of the 5 products
    and its bound (q, k, v, out, dout, lse read once, dq, dk, dv written; 5
    products at bf16 over the visible pairs), and the SDPA backend that
    ran.  SDPA's backward rounds P and dS to bf16, so its gradients are
    held to ``want`` (the plain backward's) only as the same function
    (ATTN_BF16_TOL of each's max); SDPA has no softcap and here no window,
    so with either mask it times the unmasked causal function and is not
    held to ``want`` (``library_same_function`` False)."""
    causal, window, softcap, scale = masks
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    whole = lambda: flash_k.backward(q, k, v, out, lse, dout, *masks)  # noqa: E731
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
    lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal, enable_gqa=H != KV,
                                             scale=scale)
    dout_t = dout.transpose(1, 2).contiguous()
    lib = lambda: torch.autograd.grad(lib_out, (qt, kt, vt), dout_t,  # noqa: E731
                                      retain_graph=True)
    same = softcap is None and (window is None or window >= T)
    lib_rel = None
    if same:
        lib_rel = max(float((g.transpose(1, 2).float() - w.float()).abs().max()
                            / w.float().abs().max()) for g, w in zip(lib(), want))
        expect(lib_rel <= ATTN_BF16_TOL, f"sdpa backward vs plain: {lib_rel:.3g} of the max off")
    flop = 10.0 * B * H * D * flash_k.visible_pairs(S, T, causal, window)
    n_q, n_kv = 2 * q.numel(), 2 * k.numel()
    bms, by = bound(4 * n_q + 4 * n_kv + 4 * B * H * S, flop, BF16_FLOP_PER_S)
    dev_ms = graph_ms(whole, REPS)
    backend, top = sdpa_backend(lib)
    return {"ms": median_ms(whole, REPS), "device_ms": dev_ms, "tflops": flop / dev_ms / 1e9,
            "loop_ms": loop_ms(whole, REPS), "bound_ms": bms, "bound_by": by,
            "library_backward_ms": median_ms(lib, REPS),
            "library_backward_loop_ms": loop_ms(lib, REPS),
            "library_backward_device_ms": profiled_device_ms(lib, REPS),
            "library_rel": lib_rel, "library_same_function": same,
            "library_backend": backend, "library_top_kernel": top}


def _train_pair(cfg, dev, seed: int):
    """The same seeded training model on the card and on the CPU (drawn on
    the CPU, copied to the card)."""
    cpu = build_model(cfg, "cpu", seed=seed, trainable=True)
    card = build_model(cfg, dev, seed=seed, trainable=True)
    with torch.no_grad():
        for p, c in zip(card.parameters(), cpu.parameters()):
            p.copy_(c)
    return card, cpu


def _train_batches(cfg, n: int, B: int, S: int, seed: int):
    """``n`` CPU batches of S tokens and their labels (5 pads), with a vision
    model's patch embeddings or an encoder-decoder's S // 2 frames."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        lab = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
        lab[0, :5] = -1
        batch = {"tokens": torch.from_numpy(
            rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)),
                 "labels": torch.from_numpy(lab)}
        extra = {"patch_embeds": cfg.n_frontend_tokens if cfg.frontend == "vision" else 0,
                 "frames": S // 2 if cfg.is_encdec else 0}
        for name, m in extra.items():
            if m:
                batch[name] = torch.from_numpy(
                    (rng.standard_normal((B, m, cfg.d_model)) * 0.02).astype(np.float32))
        out.append(batch)
    return out


BWD_ENTRIES = ("delta", "dkdv", "dq")


def train_launches(cfg) -> tuple:
    """(K6 forward launches, launches of each backward entry point) of one
    loss and its backward: an attention a decoder layer, a shared-block
    application (hybrid), an encoder layer, two a decoder layer (self and
    cross), none in xLSTM; the forward again in each remat recompute."""
    if cfg.is_encdec:
        n = cfg.enc_layers + 2 * cfg.dec_layers
    elif cfg.family == "hybrid":
        n = cfg.n_layers // cfg.attn_every
    elif cfg.family == "ssm":
        n = 0
    else:
        n = cfg.n_layers
    return n * (2 if cfg.remat != "none" else 1), n


def expect_launches(what: str, counts: dict, fwd: int, bwd: int) -> None:
    want = {"flash_attention": fwd, **{f"flash_attention_bwd_{e}": bwd for e in BWD_ENTRIES}}
    got = {k: counts[k] for k in want}
    expect(got == want, f"{what}: launches {got}, want {want}")


def _on(batch: dict, dev) -> dict:
    return {k: v.to(dev) for k, v in batch.items()}


def _int8_flips(card_opt: dict, cpu_opt: dict, flipped: dict) -> int:
    """Int8 moments of the card and the CPU: scales within
    TRAIN_F32_REL_TOL and q equal but for single levels (a rounding tie
    that fp32 noise decides); marks those elements in ``flipped``; -> how
    many."""
    n = 0
    for key in ("m", "v"):
        for name, a in card_opt[key].items():
            b = cpu_opt[key][name]
            dq = (a["q"].cpu().int() - b["q"].int()).abs()
            expect(int(dq.max()) <= 1, f"int8 {key} {name}: q differs by {int(dq.max())} levels")
            rel = ((a["scale"].cpu() - b["scale"]).abs() / b["scale"].abs()).max()
            expect(float(rel) <= TRAIN_F32_REL_TOL,
                   f"int8 {key} {name}: scales differ by {float(rel):.3g}")
            flipped[name] = flipped[name] | (dq > 0)
            n += int((dq > 0).sum())
    return n


def _state_on(state: dict, dev) -> dict:
    """A copy of a training state on ``dev``."""
    return {k: _state_on(v, dev) if isinstance(v, dict) else v.to(dev, copy=True)
            for k, v in state.items()}


def train_parity(cfg, dev, ocfg, microbatches: int, seed: int) -> None:
    """TRAIN_STEPS steps of the reduced model on the card against the same
    seeded run on the CPU: loss, grad norm and lr each step within
    TRAIN_F32_REL_TOL; parameters after the last within TRAIN_F32_REL_TOL of
    the larger of the largest |parameter| and their own change.  With int8
    moments each step starts the card from the CPU's state (a moment that
    lands on a rounding tie takes either side, and an element whose stored
    second moment is 0 then steps by m / |g|, g at float noise: the two
    runs part there), and those elements are counted and left out, as the
    CPU tests against the reference do."""
    card, cpu = _train_pair(cfg, dev, seed)
    sc, sh = init_state(card, ocfg), init_state(cpu, ocfg)
    fc = make_train_step(card, ocfg, microbatches=microbatches)
    fh = make_train_step(cpu, ocfg, microbatches=microbatches)
    int8 = ocfg.moment_dtype == "int8"
    flips, free, worst = 0, 0, 0.0
    for i, batch in enumerate(_train_batches(cfg, TRAIN_STEPS, 4, TRAIN_S, seed)):
        if int8 or i == 0:
            before = {n: p.clone() for n, p in sh["params"].items()}
            skip = {n: torch.zeros(p.shape, dtype=torch.bool) for n, p in before.items()}
        if int8:
            sc = _state_on(sh, dev)
            for n, m in sh["opt"]["m"].items():
                skip[n] = (sh["opt"]["v"][n]["q"] == 0) & (m["q"] != 0)
                free += int(skip[n].sum())
        sc, mc = fc(sc, _on(batch, dev))
        sh, mh = fh(sh, batch)
        for key in ("loss", "grad_norm", "lr"):
            a, b = float(mc[key]), float(mh[key])
            worst = max(worst, abs(a - b) / abs(b))
            expect(abs(a - b) <= TRAIN_F32_REL_TOL * abs(b),
                   f"train step {i + 1} ({ocfg.moment_dtype}, {microbatches} microbatches): "
                   f"{key} {a} on the card, {b} on the CPU")
        if int8:
            flips += _int8_flips(sc["opt"], sh["opt"], skip)
    top = max(float(p.abs().max()) for p in sh["params"].values())
    off = 0
    for name, p in sh["params"].items():
        lim = TRAIN_F32_REL_TOL * torch.clamp((p - before[name]).abs(), min=top)
        off += int(((sc["params"][name].cpu() - p).abs() > lim)[~skip[name]].sum())
    expect(off == 0, f"{off} parameters differ after {TRAIN_STEPS} steps")
    n = sum(p.numel() for p in before.values())
    log(f"  train steps on the card vs the CPU ({ocfg.moment_dtype} moments, {microbatches} "
        f"microbatches): loss, grad norm, lr within {worst:.3g}; parameters within "
        f"{TRAIN_F32_REL_TOL} of max(max |p| {top:.4f}, their change)"
        + (f" but {flips} moment elements at rounding ties and {free} of {TRAIN_STEPS} x {n} "
           "without a second moment (each step from the CPU's state)" if int8 else ""))


def family_train_check(name: str, dev, seed: int) -> None:
    """(b), (e): ``name``'s reduced config in float32, the same seeded model
    on the card and on the CPU: one loss and its backward with the exact K6
    launches on the card, every parameter's gradient non-zero there and
    within TRAIN_GRAD_REL_TOL of the CPU's (each relative to its largest
    |value|).  An MoE model's CPU run is routed as the card's was
    (``moe_routes(replay=...)``), after counting the routing calls whose
    picks its own routing would change."""
    cfg = get_arch(name).reduced()
    fwd, bwd = train_launches(cfg)
    card, cpu = _train_pair(cfg, dev, seed)
    batch = _train_batches(cfg, 1, 4, TRAIN_S, seed)[0]
    ops.reset_launch_counts()
    with moe_routes() as card_routes:
        card.loss(_on(batch, dev))[0].backward()
    expect_launches(f"{name} reduced, loss and backward", ops.launch_counts(), fwd, bwd)
    routed = ""
    if cfg.n_experts:
        with torch.no_grad(), moe_routes() as own:     # a forward: no recompute
            cpu.loss(batch)
        differ = sum(int(not torch.equal(a.cpu(), b)) for (a, _), (b, _) in zip(card_routes, own))
        routed = (f"; routing calls whose picks differ on the CPU: {differ} of {len(own)} "
                  "(the CPU routed as the card)")
    with moe_routes([ids.cpu() for ids, _ in card_routes] if cfg.n_experts else None):
        cpu.loss(batch)[0].backward()
    zero = [n for n, p in card.named_parameters() if p.grad is None or not bool(p.grad.any())]
    expect(not zero, f"{name}: parameters without a gradient on the card: {zero}")
    worst = 0.0
    for (pname, p), c in zip(card.named_parameters(), cpu.parameters()):
        err = float((p.grad.cpu() - c.grad).abs().max()) / float(c.grad.abs().max())
        worst = max(worst, err)
        expect(err <= TRAIN_GRAD_REL_TOL, f"{name}: gradient of {pname}: {err:.3g} of its max off")
    log(f"  {name} reduced ({type(card).__name__}, {cfg.n_layers} layers, d={cfg.d_model}, f32, "
        f"remat {cfg.remat}): every one of {sum(1 for _ in card.parameters())} parameters has a "
        f"non-zero gradient on the card, within {worst:.3g} of the CPU's (relative to each "
        f"max); K6 launches {fwd} forward, {bwd} of each backward entry point" + routed)
    del card, cpu


def restart_check(cfg, dev, ocfg, seed: int) -> None:
    """(c), (e): 2 steps, a checkpoint, a restore into a fresh state and 2
    more steps give the losses of 4 uninterrupted steps, bit for bit."""
    batches = [_on(b, dev) for b in _train_batches(cfg, 4, 4, TRAIN_S, seed + 1)]

    def fresh():
        model = build_model(cfg, dev, seed=seed, trainable=True)
        return make_train_step(model, ocfg), init_state(model, ocfg)

    step, state = fresh()
    straight = [float(step(state, b)[1]["loss"]) for b in batches]
    step, state = fresh()
    resumed = [float(step(state, b)[1]["loss"]) for b in batches[:2]]
    with tempfile.TemporaryDirectory() as d:
        save(state, d, 2)
        step, state2 = fresh()
        restore(d, state2)
    resumed += [float(step(state2, b)[1]["loss"]) for b in batches[2:]]
    expect(resumed == straight, f"{cfg.name} restart: losses {resumed} vs uninterrupted "
           f"{straight}")
    log(f"  {cfg.name} reduced: checkpoint at step 2 and restart: losses {resumed} equal the "
        "uninterrupted run's bit for bit")


def _bwd_device_ms(prof: dict) -> float:
    """K6's backward kernels' device ms in a profile (``profile_call``)."""
    return sum(t for k, (t, _) in prof["by_name"].items()
               if any(n in k for n in ("delta_kernel", "dkdv_", "dq_kernel", "dq_tc_kernel")))


def family_train_step(name: str, dev, seed: int) -> dict:
    """(f): ``name`` at full width, B = ATTN_B x S = ATTN_S synthetic tokens
    (the launcher's stream), bf16 activations, fp32 masters, AdamW with f32
    moments and the config's remat, TRAIN_FAM_STEPS steps: through
    launch/train.py's main at full depth (TRAIN_FAM_FULL), else through
    make_train_step on the config cut to TRAIN_FAM_DEPTH layers.  Exact K6
    launches, finite losses; ms a step, peak memory, then one profiled step
    (idle share, device ops, K6's backward device time a call).  -> its
    launches and measurements."""
    cfg = get_arch(name)
    depth = TRAIN_FAM_DEPTH.get(name)
    if depth:
        cfg = dataclasses.replace(cfg, n_layers=depth)
    fwd, bwd = train_launches(cfg)
    shape = ShapeSpec("cli", ATTN_S, ATTN_B, "train")
    ocfg = OptimizerConfig(total_steps=TRAIN_FAM_STEPS)      # the launcher's defaults

    def build_step():
        model = build_model(cfg, dev, seed=seed, trainable=True)
        return model, make_train_step(model, ocfg), init_state(model, ocfg)

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    if depth is None:
        argv = ["--arch", name, "--seq-len", str(ATTN_S), "--batch", str(ATTN_B),
                "--steps", str(TRAIN_FAM_STEPS), "--log-every", "1"]
        history = train_main(argv, device=dev)
        ms, losses = [h["ms"] for h in history], [h["loss"] for h in history]
        how = "launch/train.py " + " ".join(argv)
        gc.collect()
        torch.cuda.empty_cache()
        model, step, state = build_step()        # for the profiled step
    else:
        model, step, state = build_step()
        ms, losses = [], []
        for i in range(TRAIN_FAM_STEPS):
            batch = synthetic_batch(model, cfg, shape, i, dev)
            t0 = time.perf_counter()
            losses.append(float(step(state, batch)[1]["loss"]))
            ms.append((time.perf_counter() - t0) * 1e3)
        how = (f"make_train_step, depth cut to {depth} of {get_arch(name).n_layers} layers, "
               f"B={ATTN_B} S={ATTN_S}")
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    n_params = sum(p.numel() for p in model.parameters())
    expect_launches(f"{name} full-width steps", counts, fwd * TRAIN_FAM_STEPS,
                    bwd * TRAIN_FAM_STEPS)
    expect(all(np.isfinite(losses)), f"{name}: full-width losses {losses}")
    batch = synthetic_batch(model, cfg, shape, 0, dev)
    prof = profile_call(f"train step {name}", lambda: step(state, batch), host=False)
    k6_bwd = _bwd_device_ms(prof) / bwd if bwd else None
    log(f"  {name} ({type(model).__name__}, {n_params} parameters, remat {cfg.remat}) via {how}: "
        f"ms a step " + ", ".join(f"{t:.1f}" for t in ms) + f" (the first in the process "
        f"first); losses {losses}; peak memory {peak} bytes; K6 launches a step {fwd} forward, "
        f"{bwd} of each backward entry point; a profiled step: device busy "
        f"{prof['device_ms']:.3f} ms in {prof['device_ops']} device ops, idle share "
        f"{1 - prof['device_ms'] / prof['wall_ms']:.3f}"
        + (f", K6's backward {k6_bwd:.4f} ms device a call" if bwd else ""))
    del model, step, state, batch
    gc.collect()
    torch.cuda.empty_cache()
    return {"counts": counts, "ms": ms, "peak": peak, "k6_bwd_step_ms": k6_bwd,
            "bwd_calls": bwd}


# K6's backward at the families' training shapes (B = ATTN_B, S = ATTN_S,
# bf16): each model's attention (the D = 256 ones first: BWD_D256), then
# seamless's encoder and decoder
BWD_D256 = ("gemma-2b", "gemma2-9b")
BWD_FAMILY_SHAPES = BWD_D256 + ("zamba2-7b", "phi-3-vision-4.2b", "qwen2-moe-a2.7b",
                                "seamless-m4t-large-v2")


def family_bwd_rows(gen, dev, steps: dict, names=BWD_FAMILY_SHAPES) -> dict:
    """K6's backward (one wrapper call: delta, dK/dV, dQ on the route
    ``bwd_launch_plan`` picks) at the attention shapes of ``names``' full-
    width steps (B = ATTN_B, bf16, each model's masks and scale): against
    its plain version, timed (a call, and device time over a CUDA graph)
    beside its bound (5 products at bf16) and SDPA's backward (device time
    from the profiler, its backend named); with its launches a step where
    (f) took one (``steps``) and its device time a call inside the
    profiled step."""
    B = ATTN_B
    shapes = []
    for name in names:
        cfg = get_arch(name)
        if cfg.is_encdec:
            half = ATTN_S // 2
            shapes += [(f"{name} encoder self and cross", half, cfg.n_heads, cfg.n_kv_heads,
                        cfg.head_dim, (False, None, None, cfg.head_dim ** -0.5),
                        cfg.enc_layers + cfg.dec_layers),
                       (f"{name} decoder self", half, cfg.n_heads, cfg.n_kv_heads,
                        cfg.head_dim, (True, None, None, cfg.head_dim ** -0.5),
                        cfg.dec_layers)]
            continue
        D = cfg.resolved_head_dim
        scale = (cfg.query_pre_attn_scalar or D) ** -0.5
        masks = (True, cfg.sliding_window, cfg.attn_logit_softcap, scale)
        shapes.append((name, ATTN_S, cfg.n_heads, cfg.n_kv_heads, D, masks,
                       steps[name]["bwd_calls"] if name in steps else None))
    out = {}
    for name, S, H, KV, D, masks, calls in shapes:
        causal, window, softcap, scale = masks
        q = _randn(gen, B, S, H, D, dev=dev)
        k, v = (_randn(gen, B, S, KV, D, dev=dev) for _ in range(2))
        dout = _randn(gen, B, S, H, D, dev=dev)
        out_, lse = flash_k.forward(q, k, v, *masks, with_lse=True)
        plain = lambda: ref.flash_attention_bwd_ref(  # noqa: E731
            q, k, v, out_, lse, dout, causal=causal, window=window, softcap=softcap, scale=scale)
        want = plain()
        got = flash_k.backward(q, k, v, out_, lse, dout, *masks)
        errs = {n: grad_err(f"{n} at {name}'s training shape", g, w)
                for n, g, w in zip(("dq", "dk", "dv"), got, want)}
        del got
        plan = flash_k.bwd_launch_plan(q.dtype, B, S, S, H, KV, D)
        t = whole_backward_times(q, k, v, out_, lse, dout, masks, want)
        del want
        plain_ms = median_ms(plain, PLAIN_REPS)
        in_step = steps.get(name.split()[0], {}).get("k6_bwd_step_ms")
        mask_s = ("causal" if causal else "not causal") + "".join(
            f" {n} {x}" for n, x in (("window", window), ("softcap", softcap)) if x)
        out[name] = {"B": B, "S": S, "T": S, "H": H, "KV": KV, "D": D, "causal": causal,
                     "window": window, "softcap": softcap, "scale": scale,
                     "kernel_route": plan["route"], "max_abs_err": max(errs.values()),
                     "plain_ms": plain_ms, "launches_a_step": calls,
                     "in_step_device_ms": in_step, **t}
        log(f"  flash_attention backward at {name}'s training shape B={B} S=T={S} H={H} KV={KV} "
            f"D={D} bf16 {mask_s} ({plan['route']}): {t['ms']:.4f} ms a call, "
            f"{t['device_ms']:.4f} ms device, {t['tflops']:.2f} TFLOP/s of the 5 products; "
            f"bound {t['bound_ms']:.5f} ms by {t['bound_by']}; sdpa backward "
            f"({t['library_backend']}: {t['library_top_kernel']}"
            + ("" if t["library_same_function"] else "; without the softcap or window: not the "
               "same function") + f") {t['library_backward_ms']:.4f} ms a call, "
            f"{t['library_backward_device_ms']:.4f} ms device "
            f"({t['device_ms'] / t['library_backward_device_ms']:.2f}x on device); a loop of "
            f"{REPS} calls: {t['loop_ms']:.4f} ms a call, sdpa {t['library_backward_loop_ms']:.4f} "
            f"({t['loop_ms'] / t['library_backward_loop_ms']:.2f}x); plain {plain_ms:.4f} ms" + (f"; {calls} calls a step" if calls is not None else "")
            + (f" ({in_step:.4f} ms device a call inside the profiled step, the family's "
               "shapes together)" if in_step else "")
            + "; max err " + ", ".join(f"{n} {e:.3g}" for n, e in errs.items()))
        del q, k, v, dout, out_, lse
        gc.collect()
        torch.cuda.empty_cache()
    return out


# phase train (a): K6's backward against its plain version, each case in f32
# and bf16: (B, S, T, H, KV, D, masks).  D in {32, 64, 96, 112, 128, 256}, G
# in {1, 2, 3, 8}, window, softcap, S != T, ragged S, rows without a key;
# at D = 256 gemma2-9b's masks (softcap 50, a window, G = 2, its scale
# 256^-0.5) and gemma-2b's MQA (KV = 1, G = 8), at ragged S
BWD_CASES = (
    (2, 200, 200, 8, 4, 128, {}),
    (1, 130, 130, 4, 2, 256, {"softcap": 30.0}),
    (2, 96, 96, 8, 4, 32, {"window": 17}),
    (1, 70, 150, 4, 2, 128, {"causal": False, "softcap": 5.0}),
    (1, 48, 16, 4, 4, 32, {"window": 8}),       # rows that see no key
    (1, 100, 100, 8, 1, 64, {"scale": 0.3, "window": 40, "softcap": 2.0}),
    (2, 80, 80, 8, 8, 96, {}),                  # G = 1 at the padded widths
    (1, 90, 90, 8, 1, 112, {}),                 # G = 8
    (1, 203, 203, 6, 2, 64, {}),                # G = 3: 21-position tiles, ragged S
    (1, 77, 77, 4, 4, 128, {"softcap": 30.0}),
    (1, 333, 333, 4, 2, 256, {"softcap": 50.0, "window": 100, "scale": 256 ** -0.5}),
    (2, 203, 203, 8, 1, 256, {}),               # MQA: 8-position tiles, ragged S
    (1, 70, 150, 8, 1, 256, {"causal": False, "window": 60}))


def bwd_ptxas(route_check: bool = True) -> None:
    """ptxas's registers and spills of every backward kernel; the bf16
    (tensor-core) instances, D = 256's among them, must not spill."""
    report = build.ptxas_report("flash_attention_bwd")
    for r in report:
        log(f"  ptxas {r['entry']}: {r['registers']} registers, {r['smem']} bytes static "
            f"smem, spill stores {r['spill_stores']} bytes, spill loads {r['spill_loads']} bytes")
    spilled = [r["entry"] for r in report
               if "_tc_kernel" in r["entry"] and (r["spill_stores"] or r["spill_loads"])]
    expect(not spilled, f"K6's bf16 backward kernels spill registers: {spilled}")
    if route_check:
        d256 = [r["entry"] for r in report if "_tc_kernel" in r["entry"] and "Li256E" in r["entry"]]
        expect(len(d256) == 2, f"K6's bf16 backward at D = 256: tensor-core instances {d256}")


def phase_bwd_rows(dev: torch.device, seed: int = 12) -> dict:
    """``--bwd-rows``: the backward's ptxas report, phase train (a)'s D = 256
    cases and K6's backward at gemma-2b's and gemma2-9b's training shapes:
    the D = 256 route alone, whose times ``--src`` compares between two
    trees (an older tree's bf16 D = 256 route may be the CUDA cores')."""
    bwd_ptxas(route_check=False)
    gen = torch.Generator(device=dev).manual_seed(seed)
    for B, S, T, H, KV, D, kw in BWD_CASES:
        if D == 256:
            for dt in (torch.float32, torch.bfloat16):
                bwd_check(gen, dev, B, S, T, H, KV, D, dt, dict(kw))
    return family_bwd_rows(gen, dev, {}, BWD_D256)


def phase_train(dev: torch.device, seed: int = 12):
    """(a) K6's backward against its plain version; (b) the reduced qwen3 at
    f32 on the card against the CPU; (c) checkpoint and restart; (d)
    launch/train.py's main at full width; (e) every other family's reduced
    config on the card against the CPU, and a restart of the reduced zamba2;
    (f) a full-width step of each family that fits one card, and K6's
    backward at their shapes; -> (kernel rows, launches of (d), of (f))."""
    bwd_ptxas()
    gen = torch.Generator(device=dev).manual_seed(seed)
    # --- (a) the backward kernels: both dtypes (bf16 on the tensor cores)
    for B, S, T, H, KV, D, kw in BWD_CASES:
        for dt in (torch.float32, torch.bfloat16):
            bwd_check(gen, dev, B, S, T, H, KV, D, dt, dict(kw))
    rows = bwd_rows(gen, dev)

    # --- (b) the reduced model: gradients and steps, card against CPU
    cfg = get_arch(MODEL_ARCH).reduced()
    family_train_check(MODEL_ARCH, dev, seed)
    ocfg = OptimizerConfig(lr=1e-3, total_steps=10)
    train_parity(cfg, dev, ocfg, 1, seed)
    train_parity(cfg, dev, dataclasses.replace(ocfg, moment_dtype="int8"), 2, seed)

    # --- (c) checkpoint and restart: 2 + 2 steps equal 4, bit for bit
    restart_check(cfg, dev, ocfg, seed)

    # --- (d) launch/train.py at full width, then steps on one repeated batch
    full = get_arch(MODEL_ARCH)
    argv = ["--arch", MODEL_ARCH, "--seq-len", str(ATTN_S), "--batch", str(ATTN_B),
            "--steps", str(FULL_STEPS), "--log-every", "1"]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    history = train_main(argv, device=dev)
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    fwd, bwd = train_launches(full)     # forward + remat recompute, backward
    expect_launches("train.py", counts, fwd * FULL_STEPS, bwd * FULL_STEPS)
    losses = [h["loss"] for h in history]
    expect(all(np.isfinite(losses)), f"full-width losses {losses}")
    log(f"  train.py {' '.join(argv)} (remat {full.remat}): ms a step "
        + ", ".join(f"{h['ms']:.1f}" for h in history) + f"; losses {losses}; peak memory "
        f"{peak} bytes; K6 launches a step: {counts['flash_attention'] // FULL_STEPS} forward "
        f"({full.n_layers} + {full.n_layers} recomputed), "
        + ", ".join(f"{counts[f'flash_attention_bwd_{e}'] // FULL_STEPS} {e}"
                    for e in ("delta", "dkdv", "dq")))
    gc.collect()
    torch.cuda.empty_cache()
    model = build_model(full, dev, seed=seed, trainable=True)
    rep_ocfg = OptimizerConfig(lr=1e-4, warmup_steps=1, total_steps=10)
    step, state = make_train_step(model, rep_ocfg), init_state(model, rep_ocfg)
    rep = synthetic_batch(model, full, ShapeSpec("cli", ATTN_S, ATTN_B, "train"), 0, dev)
    rep_losses, rep_ms = [], []
    for _ in range(REPEAT_STEPS):
        t0 = time.perf_counter()
        rep_losses.append(float(step(state, rep)[1]["loss"]))
        rep_ms.append((time.perf_counter() - t0) * 1e3)
    expect(all(np.isfinite(rep_losses)) and rep_losses[-1] < rep_losses[0],
           f"full-width losses on a repeated batch do not decrease: {rep_losses}")
    log(f"  full width, one batch repeated: losses {rep_losses}, ms a step "
        + ", ".join(f"{t:.1f}" for t in rep_ms))
    profile_call("train step qwen3-1.7b B=4 S=2048", lambda: step(state, rep), host=False)
    del model, state, step
    gc.collect()
    torch.cuda.empty_cache()

    # --- (e) every other family's reduced config, card against CPU, and a
    # restart of the reduced zamba2
    for i, name in enumerate(FAMILIES):
        family_train_check(name, dev, seed + 1 + i)
    restart_check(get_arch("zamba2-7b").reduced(), dev, ocfg, seed)

    # --- (f) a full-width step of each family that fits, and K6's backward
    # at each of their attention shapes against its bound and SDPA's
    fam_counts = {k: 0 for k in counts}
    steps = {}
    for name in TRAIN_FAM_FULL + tuple(TRAIN_FAM_DEPTH):
        steps[name] = family_train_step(name, dev, seed)
        for k in fam_counts:
            fam_counts[k] += steps[name]["counts"][k]
    rows["flash_attention_bwd_dkdv"]["family_backward"] = family_bwd_rows(gen, dev, steps)
    return rows, counts, fam_counts


# ------------------------------------------------------------------ phase 12
# phase layout: K6 with q_offset at qwen3-1.7b's attention shape, chunks of
# LAYOUT_CHUNK rows of an ATTN_S-token prompt at LAYOUT_OFFSETS; the blocked
# prefill; launch/train.py on a 1 x 1 nccl mesh against plain tensors
LAYOUT_CHUNK, LAYOUT_OFFSETS = 512, (0, 512, 1536)
LAYOUT_TRAIN_REL_TOL = 1e-6   # mesh against plain: loss and grad norm, relative


def chunk_row(gen, dev, dt, q_offset: int, **kw) -> dict:
    """K6 (``dt``) at (B, LAYOUT_CHUNK, H, D) x (B, q_offset + LAYOUT_CHUNK,
    KV, D), causal, with ``q_offset``: against its plain version, timed
    beside SDPA with the chunk's boolean mask (none with a softcap, which
    SDPA lacks), bound over the (row, key) pairs the mask keeps."""
    B, S, H, KV, D = ATTN_B, LAYOUT_CHUNK, ATTN_H, ATTN_KV, ATTN_D
    T = q_offset + S
    q = _randn(gen, B, S, H, D, dtype=dt, dev=dev)
    k, v = (_randn(gen, B, T, KV, D, dtype=dt, dev=dev) for _ in range(2))
    kw = dict(kw, q_offset=q_offset)
    fn = lambda: flash_k.flash_attention(q, k, v, **kw)  # noqa: E731
    plain = lambda: ref.flash_attention_ref(q, k, v, **kw)  # noqa: E731
    name = f"flash_attention chunk {str(dt)[6:]} B={B} S={S} T={T} H={H} KV={KV} D={D} {kw}"
    err = attn_err(name, fn(), plain())
    mask = ref._attention_mask(S, T, True, kw.get("window"), dev, q_offset)
    pairs = int(mask.sum()) * B * H
    if kw.get("softcap") is None:
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, attn_mask=mask, enable_gqa=True, scale=1.0 / math.sqrt(D))
        attn_err(f"sdpa {name} vs plain", lib().transpose(1, 2), plain(), ATTN_BF16_TOL)
        t = attention_times(fn, plain, lib)
    else:
        t = {"ms": median_ms(fn, REPS), "plain_ms": median_ms(plain, PLAIN_REPS),
             "library_ms": None, "device_ms": graph_ms(fn, REPS), "library_device_ms": None}
    flop = 4.0 * D * pairs
    bms, by = bound(q.element_size() * (2 * q.numel() + k.numel() + v.numel()), flop,
                    BF16_FLOP_PER_S if dt == torch.bfloat16 else FP32_FLOP_PER_S)
    log(f"  {name}: {pairs} visible pairs, {flop / 1e9:.2f} GFLOP; {t['ms']:.4f} ms a call, "
        f"{t['device_ms']:.4f} ms device ({flop / t['device_ms'] / 1e9:.1f} TFLOP/s), sdpa "
        + ("none (softcap)" if t["library_ms"] is None else
           f"{t['library_ms']:.4f} ms, {t['library_device_ms']:.4f} ms device")
        + f"; plain {t['plain_ms']:.4f} ms; bound {bms:.5f} ms by {by}; max err {err:.3g}")
    return {"dtype": str(dt)[6:], "q_offset": q_offset, "S": S, "T": T, **{
        k_: kw[k_] for k_ in ("window", "softcap") if k_ in kw}, "pairs": pairs,
        "gflop": flop / 1e9, "max_abs_err": err, **t, "bound_ms": bms, "bound_by": by}


# phase layout (d): one qwen2-moe MoE block at full width on LAYOUT_MOE_B x
# LAYOUT_MOE_S tokens in LAYOUT_MOE_G dispatch groups, DTensors of the 1 x 1
# mesh in "ep" against plain tensors; (g) the same block without dispatch
# groups in "fsdp" (each rank's experts over its chunk of their hidden,
# ``moe._split_hidden``)
LAYOUT_MOE_ARCH, LAYOUT_MOE_B, LAYOUT_MOE_S, LAYOUT_MOE_G = "qwen2-moe-a2.7b", 16, 2048, 16
LAYOUT_MOE_REPS = 5


def moe_block_check(dev: torch.device, mesh, seed: int, groups: int, mode: str) -> dict:
    """(d), (g) ``moe.moe_apply`` of one full-width qwen2-moe block (bf16,
    seeded weights) with ``groups`` dispatch groups (0: none), forward and
    backward of sum(y * w) + aux, on plain tensors and on DTensors of the
    1 x 1 mesh placed as ``state_shardings`` places them in ``mode`` ("ep":
    experts over "data"), the batch over "data": y, aux and the gradients
    of x and of every weight must be bit-equal; in "ep" the DTensor call
    runs all-to-alls, without groups it splits the experts' hidden.  -> ms
    a call each way, the profiled calls' device time and idle share, the
    collectives of one DTensor call (``CommDebugMode``)."""
    from types import SimpleNamespace

    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.models import moe

    cfg = dataclasses.replace(get_arch(LAYOUT_MOE_ARCH), moe_dispatch_groups=groups)
    gen = torch.Generator(device=dev).manual_seed(seed)
    blk = moe.MoEParams(gen, cfg, device=dev, dtype=torch.bfloat16)
    weights = {n: p.detach() for n, p in blk.named_parameters()}
    del blk
    x = _randn(gen, LAYOUT_MOE_B, LAYOUT_MOE_S, cfg.d_model, dev=dev)
    w = _randn(gen, LAYOUT_MOE_B, LAYOUT_MOE_S, cfg.d_model, dev=dev)

    def call(ws: dict, xx, ww):
        """y, aux and the gradients of x and each weight."""
        leaves = [xx.requires_grad_(), *(t.requires_grad_() for t in ws.values())]
        params = SimpleNamespace(router=ws["router"], wi=ws["wi"], wo=ws["wo"], shared={
            "wi": ws["shared.wi"], "wo": ws["shared.wo"]})
        y, aux = moe.moe_apply(params, xx, cfg)
        loss = (y * ww).sum() + aux
        loss = loss.full_tensor() if isinstance(loss, DTensor) else loss
        grads = torch.autograd.grad(loss, leaves)
        return y.detach(), aux.detach(), grads

    rules = {"experts": "data"} if mode == "ep" else None
    with use_mesh(mesh, rules):
        shd = state_shardings({f"layers.0.moe.{n}": t for n, t in weights.items()}, mesh,
                              mode, cfg.family)
        xshd = batch_shardings({"x": x}, mesh)["x"]
        dt = {n: DTensor.from_local(t, mesh, shd[f"layers.0.moe.{n}"])
              for n, t in weights.items()}
        dx, dw = (DTensor.from_local(t, mesh, xshd) for t in (x, w))
        ways = {"plain": lambda: call({n: t.detach() for n, t in weights.items()},
                                      x.detach(), w),
                "dtensor": lambda: call({n: t.detach() for n, t in dt.items()},
                                        dx.detach(), dw)}
        got = {way: fn() for way, fn in ways.items()}
        comm, split, split_calls = CommDebugMode(), moe._split_hidden, []

        def counted(*args):
            split_calls.append(1)
            return split(*args)

        moe._split_hidden = counted
        try:
            with comm:
                ways["dtensor"]()
                sync()
        finally:
            moe._split_hidden = split
        t = {way: median_ms(fn, LAYOUT_MOE_REPS) for way, fn in ways.items()}
        prof = {way: profile_call(f"qwen2-moe block, {way} tensors on the 1 x 1 mesh, "
                                  f"forward and backward", fn, host=False)
                for way, fn in ways.items()}

    def local(v):
        return v.full_tensor() if isinstance(v, DTensor) else v

    (py, paux, pg), (dy, daux, dg) = got["plain"], got["dtensor"]
    names = ["x", *weights]
    same = {"y": torch.equal(local(dy), py), "aux": torch.equal(local(daux), paux),
            **{f"grad {n}": torch.equal(local(a), b) for n, a, b in zip(names, dg, pg)}}
    gaps = {k: float((local(a).float() - b.float()).abs().max())
            for k, a, b in [("y", dy, py), ("aux", daux, paux),
                            *((f"grad {n}", a, b) for n, a, b in zip(names, dg, pg))]}
    counts = {str(op): n for op, n in comm.get_comm_counts().items()}
    n_a2a = sum(n for op, n in counts.items() if "all_to_all" in op)
    expect(all(same.values()), f"MoE block on DTensors vs plain differs: {gaps}")
    if mode == "ep":
        expect(n_a2a >= 4, f"the MoE block's DTensor call ran no all-to-all: {counts}")
    else:
        expect(len(split_calls) == 1, f"the MoE block's DTensor call split the experts' "
               f"hidden {len(split_calls)} times, not once")
    expect(bool(torch.isfinite(py.float()).all()), "MoE block: non-finite output")
    idle = {way: 1 - p["device_ms"] / p["wall_ms"] if p["device_ms"] else None
            for way, p in prof.items()}
    n_group = LAYOUT_MOE_B * LAYOUT_MOE_S // max(groups, 1)
    log(f"  qwen2-moe block B={LAYOUT_MOE_B} S={LAYOUT_MOE_S} d={cfg.d_model} E={cfg.n_experts} "
        f"top-{cfg.top_k} groups {groups} (capacity {moe.capacity(n_group, cfg)} a group) "
        f"bf16, {mode} on the 1 x 1 mesh: DTensors vs plain bit-equal {same}; ms a call "
        f"(forward and backward) dtensor {t['dtensor']:.1f}, plain {t['plain']:.1f}; idle "
        f"share dtensor {idle['dtensor']}, plain {idle['plain']}; collectives of the DTensor "
        f"call {counts}")
    return {"ms": t, "idle": idle, "bit_equal": all(same.values()), "collectives": counts,
            "mode": mode, "groups": groups,
            **{f"{w}_profiled_{k}": prof[w][k] for w in prof
               for k in ("wall_ms", "device_ms", "device_ops")}}


# phase layout (e): llama4's attention at full width (B=1, S=2048, 40 q heads,
# 8 kv heads, D=128, bf16, causal) cut into the q-head slices of a 16-way
# "model" axis (DTensor's chunks: 3 heads on ranks 0-12, 1 on 13, none on
# 14-15), each through ``ops.head_slice_attention`` as a rank runs it; and
# seamless's cross entropy (d=1024, 256206 rows, 2048 bf16 tokens) cut into
# the same axis' 16 vocabulary chunks, each rank's logits h @ w[v0:v1].T
HEAD_SPLIT_ARCH, HEAD_SPLIT_M, HEAD_SPLIT_B, HEAD_SPLIT_S = "llama4-maverick-400b-a17b", 16, 1, 2048
VOCAB_SPLIT_ARCH, VOCAB_SPLIT_TOKENS = "seamless-m4t-large-v2", 2048
# lse of the chunks vs the whole logits: 1e-5 absolute (an element that a
# chunk's bf16 product rounds otherwise by one ulp moves lse by its softmax
# share of that ulp); gold: 1e-5 plus one bf16 ulp of the gold logit, the
# one element it reads
VOCAB_SPLIT_TOL = 1e-5


def head_split_check(dev: torch.device, gen) -> tuple:
    """Phase layout (e): the 16 head slices forward (no grad) and forward
    and backward against one whole K6 call on the same inputs (output
    concatenated; dQ concatenated, dK and dV summed over the slices), the
    whole call against its plain version, the slices' total ms against the
    whole call's, one SDPA call's (enable_gqa, forward and forward with
    backward) and the plain version's; then seamless's vocabulary chunks
    -> (row, K6 launches of the slices' run, counted from 0)."""
    cfg = get_arch(HEAD_SPLIT_ARCH)
    B, S, H, KV, D = HEAD_SPLIT_B, HEAD_SPLIT_S, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    spans = partitioning._spans(H, HEAD_SPLIT_M)   # each rank's heads [h0, h1)
    q, dout = (_randn(gen, B, S, H, D, dev=dev) for _ in range(2))
    k, v = (_randn(gen, B, S, KV, D, dev=dev) for _ in range(2))
    name = f"head split B={B} S={S} H={H} KV={KV} D={D} bf16 over {HEAD_SPLIT_M}"

    def slices():
        return torch.cat([ops.head_slice_attention(q[:, :, h0:h1], k, v, h0, H)
                          for h0, h1 in spans], dim=2)

    def slices_fwd_bwd():
        """-> (out, dq, each slice's dk, each slice's dv)"""
        outs, dq, dk, dv = [], [], [], []
        for h0, h1 in spans:
            ql = q[:, :, h0:h1].detach().requires_grad_()
            kl, vl = k.detach().requires_grad_(), v.detach().requires_grad_()
            out = ops.head_slice_attention(ql, kl, vl, h0, H)
            out.backward(dout[:, :, h0:h1])
            outs.append(out.detach())
            dq.append(ql.grad)
            dk.append(kl.grad)
            dv.append(vl.grad)
        return torch.cat(outs, dim=2), torch.cat(dq, dim=2), dk, dv

    def whole_fwd_bwd():
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        out = flash_k.flash_attention(*leaves)
        out.backward(dout)
        return (out.detach(), *(x.grad for x in leaves))

    ops.reset_launch_counts()
    parts = slices()
    got = slices_fwd_bwd()
    sync()
    counts = ops.launch_counts()
    calls = sum(len(ops.head_slice_calls(h0, h1, H // KV)) for h0, h1 in spans)
    expect(counts["flash_attention"] == 2 * calls and all(
        counts[f"flash_attention_bwd_{e}"] == calls for e in BWD_ENTRIES),
        f"{name}: launches {counts}, want {2 * calls} forward and {calls} of each backward "
        f"kernel (a call per run of heads in one kv head; none for an empty slice)")
    whole = flash_k.flash_attention(q, k, v)
    plain = ref.flash_attention_ref(q, k, v)
    row = {"slices": [h1 - h0 for h0, h1 in spans],
           "max_abs_err": attn_err(f"{name}: slices vs one call", parts, whole),
           "bit_equal": bool(torch.equal(parts, whole)),
           "plain_max_abs_err": attn_err(f"{name}: slices vs plain", parts, plain)}
    want = whole_fwd_bwd()
    row["fwd_bwd_out_max_abs_err"] = attn_err(f"{name}: out with grad", got[0], want[0])
    row["dq_max_abs_err"] = grad_err(f"{name}: dq", got[1], want[1])
    row["dq_bit_equal"] = bool(torch.equal(got[1], want[1]))
    # dK and dV summed over the slices (in f32, as the mesh's partial sums
    # are reduced): each slice's partial and the whole call's sum are each
    # rounded to bf16 once, so the limit is the backward's stated share plus
    # half a bf16 ulp of the whole value and of each partial
    for i, key in ((2, "dk"), (3, "dv")):
        total = sum(x.float() for x in got[i])
        err = (total - want[i].float()).abs()
        lim = BWD_REL_TOL * float(want[i].float().abs().max()) + 2.0 ** -8 * (
            want[i].float().abs() + sum(x.float().abs() for x in got[i]))
        bad = int((err > lim).sum())
        expect(bool(torch.isfinite(total).all()) and bad == 0,
               f"{name}: {key} summed over the slices: {bad} values off, max |error| "
               f"{float(err.max()):.3g}")
        row[f"{key}_max_abs_err"] = float(err.max())
    fwd = {"ms": median_ms(slices, REPS), "whole_ms": median_ms(lambda: flash_k.flash_attention(
        q, k, v), REPS), "device_ms": graph_ms(slices, REPS),
        "whole_device_ms": graph_ms(lambda: flash_k.flash_attention(q, k, v), REPS)}
    # one SDPA call (enable_gqa) computes the same function: its forward
    # held to the plain version as flash_row holds it, timed beside the
    # slices; forward and backward as one autograd pass, its device time
    # from torch.profiler (a graph does not capture autograd's backward)
    qt, kt, vt, dt = (x.transpose(1, 2).contiguous() for x in (q, k, v, dout))
    lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, is_causal=True, enable_gqa=True)
    row["library_max_abs_err"] = attn_err(f"{name}: sdpa vs plain", lib().transpose(1, 2),
                                          plain, ATTN_BF16_TOL)

    def lib_fwd_bwd():
        leaves = [x.detach().requires_grad_() for x in (qt, kt, vt)]
        F.scaled_dot_product_attention(*leaves, is_causal=True, enable_gqa=True).backward(dt)
        return [x.grad for x in leaves]

    fwd.update(plain_ms=median_ms(lambda: ref.flash_attention_ref(q, k, v), PLAIN_REPS),
               library_ms=median_ms(lib, REPS), library_device_ms=graph_ms(lib, REPS))
    both = {"fwd_bwd_ms": median_ms(slices_fwd_bwd, PLAIN_REPS),
            "whole_fwd_bwd_ms": median_ms(whole_fwd_bwd, PLAIN_REPS),
            "library_fwd_bwd_ms": median_ms(lib_fwd_bwd, REPS),
            "fwd_bwd_device_ms": profiled_device_ms(slices_fwd_bwd, PLAIN_REPS, False),
            "whole_fwd_bwd_device_ms": profiled_device_ms(whole_fwd_bwd, PLAIN_REPS, False),
            "library_fwd_bwd_device_ms": profiled_device_ms(lib_fwd_bwd, REPS, False)}

    def dev_text(key: str) -> str:
        return "not measured" if both[key] is None else f"{both[key]:.4f}"

    pairs = B * H * flash_k.visible_pairs(S, S)
    bms, by = bound(2 * (2 * q.numel() + k.numel() + v.numel()), 4.0 * D * pairs,
                    BF16_FLOP_PER_S)
    row.update(fwd, **both, bound_ms=bms, bound_by=by,
               launches={n: c for n, c in counts.items() if c})
    log(f"  {name} (slices {row['slices']}): launches {row['launches']}; vs one call max err "
        f"{row['max_abs_err']:.3g} (bit-equal {row['bit_equal']}), vs plain "
        f"{row['plain_max_abs_err']:.3g}; backward: dq {row['dq_max_abs_err']:.3g} (bit-equal "
        f"{row['dq_bit_equal']}), dk {row['dk_max_abs_err']:.3g}, dv {row['dv_max_abs_err']:.3g}; "
        f"forward: slices {fwd['ms']:.4f} ms ({fwd['device_ms']:.4f} device), one call "
        f"{fwd['whole_ms']:.4f} ms ({fwd['whole_device_ms']:.4f} device), sdpa "
        f"{fwd['library_ms']:.4f} ms ({fwd['library_device_ms']:.4f} device), plain "
        f"{fwd['plain_ms']:.4f} ms; forward and backward: slices {both['fwd_bwd_ms']:.4f} ms "
        f"(device {dev_text('fwd_bwd_device_ms')}), one call {both['whole_fwd_bwd_ms']:.4f} ms "
        f"(device {dev_text('whole_fwd_bwd_device_ms')}), sdpa {both['library_fwd_bwd_ms']:.4f} "
        f"ms (device {dev_text('library_fwd_bwd_device_ms')}); bound {bms:.5f} ms by {by}")
    row["vocab_split"] = vocab_split_check(dev, gen)
    return row, counts


def vocab_split_check(dev: torch.device, gen) -> dict:
    """seamless's cross entropy with its vocabulary cut into the 16 chunks
    of a "model" axis, each through the functions a rank of a mesh runs:
    the chunk's logits ``layers.vocab_chunk(h, w[v0:v1])`` (what
    ``layers.vocab_logits`` computes on a rank), the chunk's max
    (``layers.chunk_max``), maxed over the chunks, then its exp-sum and
    gold logit (``layers.chunk_sum_gold``), summed over the chunks (what
    ``layers.lse_gold`` reduces over the axis); against ``lse_gold`` of the
    whole logits ``vocab_logits(h, w)`` on plain tensors, and that against
    ``torch.logsumexp``: lse within VOCAB_SPLIT_TOL, gold within it plus
    one bf16 ulp of the gold logit (see there)."""
    cfg = get_arch(VOCAB_SPLIT_ARCH)
    V, d, N = cfg.vocab_size, cfg.d_model, VOCAB_SPLIT_TOKENS
    h = _randn(gen, N, d, dev=dev)
    w = (_randn(gen, V, d, dev=dev).float() * 0.02).to(torch.bfloat16)
    labels = torch.randint(0, V, (N,), generator=gen, device=dev)
    whole = layers.vocab_logits(h, w)
    lse, gold = layers.lse_gold(whole, labels)
    spans = partitioning._spans(V, HEAD_SPLIT_M)
    chunks = [layers.vocab_chunk(h, w[v0:v1]) for v0, v1 in spans]
    m = torch.stack([layers.chunk_max(c) for c in chunks]).amax(dim=0)
    parts = [layers.chunk_sum_gold(c, labels, v0, m) for c, (v0, _) in zip(chunks, spans)]
    got_lse = m + torch.log(sum(s for s, _ in parts))
    got_gold = sum(g for _, g in parts)
    errs = {"lse_max_abs_err": float((got_lse - lse).abs().max()),
            "gold_max_abs_err": float((got_gold - gold).abs().max()),
            "whole_vs_logsumexp_max_abs_err": float(
                (lse - torch.logsumexp(whole, dim=-1)).abs().max()),
            "logits_bit_equal": all(torch.equal(c, whole[:, v0:v1])
                                    for c, (v0, v1) in zip(chunks, spans))}
    gold_ok = bool(((got_gold - gold).abs() <= VOCAB_SPLIT_TOL + 2.0 ** -7 * gold.abs()).all())
    expect(errs["lse_max_abs_err"] <= VOCAB_SPLIT_TOL and gold_ok
           and errs["whole_vs_logsumexp_max_abs_err"] <= VOCAB_SPLIT_TOL
           and bool(torch.isfinite(got_lse).all()),
           f"seamless's cross entropy over {HEAD_SPLIT_M} vocabulary chunks: {errs}")
    cols = [v1 - v0 for v0, v1 in spans]
    log(f"  seamless cross entropy, {N} tokens, d={d}, V={V} in {HEAD_SPLIT_M} chunks "
        f"({cols[0]} columns a rank, {cols[-1]} on the last) vs the whole logits: lse max err "
        f"{errs['lse_max_abs_err']:.3g}, gold {errs['gold_max_abs_err']:.3g}; whole lse vs "
        f"logsumexp {errs['whole_vs_logsumexp_max_abs_err']:.3g}; chunk logits bit-equal to "
        f"the whole's {errs['logits_bit_equal']}")
    return {"chunk_columns": cols, **errs}


# phase layout (f): zamba2-7b's Mamba2 layer at published width in the head
# slices of a 16-way "model" axis (7 of 112 heads a rank), B x S tokens;
# one group (6 Mamba2 layers, then the shared block, its 32 q heads in 16
# slices of 2 through K6)
MAMBA_SPLIT_ARCH, MAMBA_SPLIT_M, MAMBA_SPLIT_B, MAMBA_SPLIT_S = "zamba2-7b", 16, 1, 2048
MAMBA_SPLIT_REPS = 5
# limits, relative to the largest |value| of the whole computation's
# result: f32 forward (only the order of fp32 sums differs, and the gated
# norm's mean is a sum of 16 slices' sums divided by d_inner); bf16 (each
# slice's out_proj product and the sum of 16 partials rounded to bf16, as
# an all-reduce in bf16 rounds them); f32 gradients (the CPU tests' limit
# against the reference), A_log's apart: it sums cancelling terms over
# every position (a 1e-7 relative perturbation upstream moves it by more
# than 1e-5 of its largest value at the reduced width:
# tests/test_torch_mamba_split.py::test_alog_gradient_amplifies_a_tiny_perturbation)
MAMBA_SPLIT_F32_TOL = 1e-5
MAMBA_SPLIT_BF16_TOL = 2e-2
# the f32 final state: a sum over the 2048 positions' decayed updates whose
# inputs (each slice's in_proj product, another shape than the whole's)
# differ in the last bits (1.05e-5 of its largest value on the H100)
MAMBA_SPLIT_STATE_TOL = 1e-4
MAMBA_SPLIT_GRAD_TOL = 1e-4
MAMBA_SPLIT_ALOG_TOL = 1e-3
# the group: f32 through 7 blocks (fp32 sums in other orders, K6's f32
# route), bf16 as DECODE_LOGIT_REL_TOL holds a bf16 model's logits
MAMBA_GROUP_F32_TOL = 1e-4


@contextlib.contextmanager
def sliced_attention(m: int):
    """``ops.flash_attention`` as the ranks of an m-way "model" axis run it:
    q's heads in DTensor's chunks, each through ``ops.head_slice_attention``
    (the rank's K6 calls), concatenated."""
    whole = ops.flash_attention

    def sliced(q, k, v, **kw):
        H = q.shape[2]
        return torch.cat([ops.head_slice_attention(q[:, :, h0:h1], k, v, h0, H, **kw)
                          for h0, h1 in partitioning._spans(H, m)], dim=2)

    ops.flash_attention = sliced
    try:
        yield
    finally:
        ops.flash_attention = whole


def _rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


def mamba_split_check(dev: torch.device, mesh, gen) -> tuple:
    """Phase layout (f): one Mamba2 layer of zamba2-7b at published width, B x
    S tokens, in the head slices of a MAMBA_SPLIT_M-way "model" axis, each
    slice's work as a rank runs it (``ssm.mamba2_slices``: its in_proj
    columns, conv channels, state and out_proj rows, the gated norm's sum
    of squares summed over the slices, the partial outputs summed) against
    the whole layer (``mamba2_apply``): forward in f32 and bf16, the f32
    backward (the input's and every weight's gradient), and one decode step
    whose conv buffer moves from the 16 even channel chunks of a cache to
    the slices' layouts and back (``partitioning.regather_local``) against
    ``mamba2_decode``; then one group (6 Mamba2 layers and the shared block,
    its attention through K6 in the 16 q-head slices) against the whole
    group, f32 and bf16, K6's launches counted from 0 around the sliced
    bf16 group; one layer through ``mamba2_sharded`` on DTensors of the 1 x
    1 mesh against plain tensors, forward and backward, bit-equal; times of
    the slices and of one slice (a rank's share) against the whole layer,
    with launches and on the device.
    -> (row, K6 launches of the sliced group)."""
    from repro_torch.models import hybrid, ssm

    cfg = get_arch(MAMBA_SPLIT_ARCH)
    f32cfg = dataclasses.replace(cfg, dtype="float32")
    d = ssm.ssm_dims(cfg)
    B, S, M = MAMBA_SPLIT_B, MAMBA_SPLIT_S, MAMBA_SPLIT_M
    spans = partitioning._spans(d.n_heads, M)
    name = f"mamba2 {d.n_heads} heads over {M} (x {spans[0][1]}) B={B} S={S}"
    w32 = ssm.mamba2_init(gen, cfg, device=dev)
    for k in ("norm", "dt_bias"):   # off their zero init, so that slicing them shows
        w32[k] = 0.1 * torch.randn(w32[k].shape, generator=gen, device=dev)
    x32 = torch.randn(B, S, cfg.d_model, generator=gen, device=dev)
    row = {"slices": [h1 - h0 for h0, h1 in spans]}

    def pair(w, x, c):
        return (lambda: ssm.mamba2_slices(w, x, c, spans, chunk=c.scan_chunk)[0],
                lambda: ssm.mamba2_apply(w, x, c, chunk=c.scan_chunk))

    bad = []     # every check's failure, raised together at the end

    def check(ok: bool, what: str) -> None:
        if not ok:
            bad.append(what)

    with torch.no_grad():
        for key, c, tol, st_tol, cast in (
                ("f32", f32cfg, MAMBA_SPLIT_F32_TOL, MAMBA_SPLIT_STATE_TOL, torch.float32),
                ("bf16", cfg, MAMBA_SPLIT_BF16_TOL, MAMBA_SPLIT_BF16_TOL, torch.bfloat16)):
            w = {k: (t.to(cast) if t.dim() == 2 else t) for k, t in w32.items()}
            sliced, whole = pair(w, x32.to(cast), c)
            got, want = sliced(), whole()
            _, st = ssm.mamba2_slices(w, x32.to(cast), c, spans, chunk=c.scan_chunk)
            _, wst = ssm.mamba2_apply(w, x32.to(cast), c, chunk=c.scan_chunk, return_state=True)
            row[f"{key}_max_rel_err"] = _rel_err(got, want)
            row[f"{key}_state_max_rel_err"] = _rel_err(st, wst)
            check(bool(torch.isfinite(got).all()) and row[f"{key}_max_rel_err"] <= tol
                  and row[f"{key}_state_max_rel_err"] <= st_tol,
                  f"{key}: slices vs whole {row[f'{key}_max_rel_err']:.3g} (limit {tol}), "
                  f"state {row[f'{key}_state_max_rel_err']:.3g} (limit {st_tol})")
            if key == "bf16":
                # one rank's share: slice 0 (its gate and partial output; the
                # sum of squares and the output's all-reduce left out)
                p0, x0 = ssm.head_slice(w, c, *spans[0]), x32.to(cast)

                def one():
                    g, _ = ssm.mamba2_gate(p0, x0, c, c.scan_chunk)
                    return ssm.gated_out(p0, g, c, ssm.sum_squares(g))

                row.update(ms=median_ms(sliced, MAMBA_SPLIT_REPS),
                           whole_ms=median_ms(whole, MAMBA_SPLIT_REPS),
                           slice_ms=median_ms(one, MAMBA_SPLIT_REPS),
                           device_ms=graph_ms(sliced, MAMBA_SPLIT_REPS),
                           whole_device_ms=graph_ms(whole, MAMBA_SPLIT_REPS),
                           slice_device_ms=graph_ms(one, MAMBA_SPLIT_REPS))
            del w, got, want
    # --- the f32 backward: every gradient of the slices against the whole's
    grads = {}
    dout = torch.randn(B, S, cfg.d_model, generator=gen, device=dev)
    for way in ("slices", "whole"):
        leaves = {k: t.clone().requires_grad_() for k, t in w32.items()}
        x = x32.clone().requires_grad_()
        out = (ssm.mamba2_slices(leaves, x, f32cfg, spans, chunk=cfg.scan_chunk)[0]
               if way == "slices" else ssm.mamba2_apply(leaves, x, f32cfg, chunk=cfg.scan_chunk))
        out.backward(dout)
        grads[way] = {"x": x.grad, **{k: t.grad for k, t in leaves.items()}}
        del out, leaves, x
    row["grad_max_rel_err"] = {k: _rel_err(grads["slices"][k], g)
                               for k, g in grads["whole"].items()}
    off = {k: e for k, e in row["grad_max_rel_err"].items()
           if not e <= (MAMBA_SPLIT_ALOG_TOL if k == "A_log" else MAMBA_SPLIT_GRAD_TOL)}
    check(not off, f"f32 gradients of the slices vs the whole layer: {off}")
    del grads
    # --- one decode step: the conv buffer from the cache's even chunks to
    # each slice's channels and back
    state = 0.1 * torch.randn(B, d.n_heads, d.head_dim, d.d_state, generator=gen, device=dev)
    buf = torch.randn(B, ssm.CONV_WIDTH - 1, d.conv_dim, generator=gen, device=dev)
    tok = x32[:, :1]
    chunks = [[c] for c in partitioning._spans(d.conv_dim, M)]
    layouts = [ssm.conv_channels(d, h0, h1) for h0, h1 in spans]
    with torch.no_grad():
        bufs = partitioning.regather_local([buf[..., a:b] for (a, b), in chunks], 2, chunks,
                                           layouts)
        out, st, new = ssm.mamba2_decode_slices(w32, tok, f32cfg, spans, state, bufs)
        back = partitioning.regather_local(new, 2, layouts, chunks)
        want = ssm.mamba2_decode(w32, tok, f32cfg, state, buf)
    got = (out, st, torch.cat(back, dim=2))
    row["decode_max_rel_err"] = {k: _rel_err(g, w) for k, g, w in zip(("out", "state", "conv"),
                                                                     got, want)}
    row["decode_conv_bit_equal"] = bool(torch.equal(got[2], want[2]))
    row["conv_chunk_channels"] = chunks[0][0][1] - chunks[0][0][0]
    check(all(e <= MAMBA_SPLIT_F32_TOL for e in row["decode_max_rel_err"].values()),
          f"decode step of the slices vs mamba2_decode {row['decode_max_rel_err']}")
    # --- one group: 6 Mamba2 layers and the shared block, K6 in 16 q-head slices
    counts = {}
    for key, c, tol in (("f32", f32cfg, MAMBA_GROUP_F32_TOL), ("bf16", cfg, DECODE_LOGIT_REL_TOL)):
        model = build_model(dataclasses.replace(c, n_layers=c.attn_every), dev, seed=27)
        x = torch.randn(B, S, c.d_model, generator=gen, device=dev).to(model.dtype)
        positions = torch.arange(S, device=dev)[None, :]
        with torch.no_grad():
            want = model._group(model.main[0], x, positions)
            ops.reset_launch_counts()
            with sliced_attention(M), mamba_layers_sliced(hybrid, spans):
                got = model._group(model.main[0], x, positions)
            sync()
            counts[key] = ops.launch_counts()
        row[f"group_{key}_max_rel_err"] = _rel_err(got, want)
        calls = sum(len(ops.head_slice_calls(h0, h1, 1)) for h0, h1 in
                    partitioning._spans(c.n_heads, M))
        check(counts[key]["flash_attention"] == calls and row[f"group_{key}_max_rel_err"] <= tol
              and bool(torch.isfinite(got).all()),
              f"the {key} group in slices: {counts[key]['flash_attention']} K6 launches "
              f"(want {calls}), vs whole {row[f'group_{key}_max_rel_err']:.3g} (limit {tol})")
        del model, x, got, want
        gc.collect()
        torch.cuda.empty_cache()
    row["group_k6_launches"] = counts["bf16"]["flash_attention"]
    # --- one layer on DTensors of the 1 x 1 mesh against plain tensors
    same = mamba_dtensor_check(dev, mesh, cfg, w32, x32, dout)
    row["dtensor_bit_equal"] = all(same.values())
    check(row["dtensor_bit_equal"], f"the layer on DTensors of the 1 x 1 mesh vs plain "
                                    f"tensors, bit-equal: {same}")
    log(f"  {name}: slices vs whole layer f32 {row['f32_max_rel_err']:.3g} (state "
        f"{row['f32_state_max_rel_err']:.3g}), bf16 {row['bf16_max_rel_err']:.3g} (state "
        f"{row['bf16_state_max_rel_err']:.3g}); f32 gradients "
        + ", ".join(f"{k} {e:.3g}" for k, e in row["grad_max_rel_err"].items())
        + f"; decode step {row['decode_max_rel_err']} (conv buffer through the "
        f"{row['conv_chunk_channels']}-channel chunks, bit-equal {row['decode_conv_bit_equal']}); "
        f"group of {cfg.attn_every} layers and the shared block: f32 "
        f"{row['group_f32_max_rel_err']:.3g}, bf16 {row['group_bf16_max_rel_err']:.3g}, K6 "
        f"launches {row['group_k6_launches']}; 1 x 1 mesh DTensors vs plain bit-equal "
        f"{row['dtensor_bit_equal']}; bf16 forward: slices {row['ms']:.4f} ms "
        f"({row['device_ms']:.4f} device), whole {row['whole_ms']:.4f} ms "
        f"({row['whole_device_ms']:.4f} device), one slice {row['slice_ms']:.4f} ms "
        f"({row['slice_device_ms']:.4f} device)")
    expect(not bad, f"{name}: " + "; ".join(bad))
    return row, counts["bf16"]


@contextlib.contextmanager
def mamba_layers_sliced(hybrid, spans):
    """``HybridModel``'s Mamba2 layers in ``spans``' head slices on one device
    (``ssm.mamba2_slices``), as the ranks of a "model" axis compute them."""
    from repro_torch.models import ssm

    whole = hybrid.mamba2_apply

    def sliced(p, x, cfg, chunk=256, initial_state=None, return_state=False):
        out, h = ssm.mamba2_slices(p, x, cfg, spans, chunk, initial_state)
        return (out, h) if return_state else out

    hybrid.mamba2_apply = sliced
    try:
        yield
    finally:
        hybrid.mamba2_apply = whole


def mamba_dtensor_check(dev, mesh, cfg, w32, x32, dout) -> dict:
    """One Mamba2 layer (f32) through ``ssm.mamba2_sharded`` on DTensors of
    the 1 x 1 mesh, the weights placed as ``state_shardings`` ("fsdp")
    places them, against ``mamba2_apply`` of the layer-normed input on
    plain tensors -> {output, and each gradient (the input's, the layer
    norm's, each weight's): bit-equal}."""
    from torch.distributed.tensor import DTensor

    from repro_torch.models import ssm

    f32cfg = dataclasses.replace(cfg, dtype="float32")
    ln32 = torch.linspace(-0.1, 0.1, cfg.d_model, device=dev)
    names = {k: f"main.0.0.mamba.{k}" for k in w32}
    shd = state_shardings({**{names[k]: t for k, t in w32.items()}, "main.0.0.ln": ln32}, mesh,
                          "fsdp", cfg.family)
    xshd = batch_shardings({"x": (tuple(x32.shape), x32.dtype)}, mesh)["x"]
    got = {}
    for way in ("plain", "dtensor"):
        leaves = {k: t.clone().requires_grad_() for k, t in w32.items()}
        ln, x = ln32.clone().requires_grad_(), x32.clone().requires_grad_()
        if way == "plain":
            y = ssm.mamba2_apply(leaves, layers.rms_norm(x, ln, cfg.norm_eps), f32cfg,
                                 chunk=cfg.scan_chunk)
            y.backward(dout)
        else:
            with use_mesh(mesh):
                dy = ssm.mamba2_sharded(
                    {k: DTensor.from_local(t, mesh, tuple(shd[names[k]]))
                     for k, t in leaves.items()},
                    DTensor.from_local(ln, mesh, tuple(shd["main.0.0.ln"])),
                    DTensor.from_local(x, mesh, tuple(xshd)), f32cfg, chunk=cfg.scan_chunk)
                dy.backward(DTensor.from_local(dout, mesh, dy.placements))
            y = dy.to_local()
        got[way] = {"out": y.detach(), "x": x.grad, "ln": ln.grad,
                    **{k: t.grad for k, t in leaves.items()}}
    return {k: bool(torch.equal(got["dtensor"][k], g)) for k, g in got["plain"].items()}


# phase layout (h): zamba2-7b's decode at batch 1, as its long_500k cell runs
# it on 16 x 16: one rank's share of the shared attention's cache (B = 1,
# 524288 slots over a 16-way "model" axis: 32768, bf16, a ragged kv_len),
# its 32 heads over a 16-way "data" axis (2 a rank); then one full-width
# decode step against a 32768-slot cache on DTensors of the 1 x 1 mesh
BATCH1_ARCH, BATCH1_T, BATCH1_LEN, BATCH1_SPLIT = "zamba2-7b", 32768, 30001, 16
BATCH1_STEPS = 3


def batch1_slices_check(dev: torch.device, gen) -> tuple:
    """(h), K7's head slices: q (1, 32, 112) f32 against the bf16 cache
    shard, in BATCH1_SPLIT slices of 2 heads, each through
    ``ops.decode_head_slice`` on strided views of its kv heads with lse (as
    a rank of "data" runs it), concatenated: bit-equal (out and lse) to one
    call on all heads at the slices' split (``n_split``: a head's result
    depends on the split alone), and within SPLIT_REL_TOL of one call at
    its own plan and of the plain version; one slice's device ms against
    the whole call's, beside the slice's bound -> (row, K7 launches of the
    sliced call)."""
    cfg = get_arch(BATCH1_ARCH)
    H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = torch.randn((1, H, D), generator=gen, device=dev)
    k, v = (_randn(gen, 1, BATCH1_T, KV, D, dev=dev) for _ in range(2))
    lens = torch.tensor([BATCH1_LEN], dtype=torch.int32, device=dev)
    scale = 1.0 / np.sqrt(D)
    spans = partitioning._spans(H, BATCH1_SPLIT)
    hl = spans[0][1] - spans[0][0]

    def one(a: int, b: int):
        return ops.decode_head_slice(q[:, a:b], k, v, lens, a, H, scale=scale, return_lse=True)

    def sliced():
        outs = [one(a, b) for a, b in spans]
        return torch.cat([o for o, _ in outs], dim=1), torch.cat([s_ for _, s_ in outs], dim=1)

    ops.reset_launch_counts()
    s_out, s_lse = sliced()
    sync()
    counts = ops.launch_counts()
    n_calls = sum(b > a for a, b in spans)
    expect(counts["decode_attention"] == n_calls,
           f"K7 head slices: {counts['decode_attention']} launches, not {n_calls}")
    slice_kv = max(1, hl * KV // H)
    slice_plan = decode_k.split_plan(1, slice_kv, BATCH1_T, H // KV, D)
    whole_plan = decode_k.split_plan(1, KV, BATCH1_T, H // KV, D)
    at_out, at_lse = decode_k.decode_attention(q, k, v, lens, scale=scale, return_lse=True,
                                               n_split=slice_plan["n_split"])
    w_out, w_lse = decode_k.decode_attention(q, k, v, lens, scale=scale, return_lse=True)
    p_out, p_lse = ref.decode_attention_ref(q, k, v, lens, scale=scale, return_lse=True)
    bit = bool(torch.equal(s_out, at_out)) and bool(torch.equal(s_lse, at_lse))
    expect(bit, "K7 head slices differ from one call at their split")
    rel = float((s_out - w_out).abs().max() / w_out.abs().max())
    lse_e = float((s_lse - w_lse).abs().max())
    expect(rel <= SPLIT_REL_TOL and lse_e <= SPLIT_REL_TOL,
           f"K7 head slices vs one call: out {rel:.3g} of max |out|, lse {lse_e:.3g}")
    err = attn_err("K7 head slices vs plain", s_out, p_out)
    plain_lse = float((s_lse - p_lse).abs().max())
    expect(plain_lse <= SPLIT_REL_TOL * max(1.0, float(p_lse.abs().max())),
           f"K7 head slices: lse off the plain version's by {plain_lse:.3g}")
    whole = lambda: decode_k.decode_attention(q, k, v, lens, scale=scale,  # noqa: E731
                                              return_lse=True)
    first = lambda: one(*spans[0])  # noqa: E731
    work = decode_k.work(1, hl, slice_kv, D, BATCH1_LEN, 4, 2, True)
    bms, by = bound(work["bytes"], work["flops"], BF16_FLOP_PER_S)
    w_work = decode_k.work(1, H, KV, D, BATCH1_LEN, 4, 2, True)
    w_bms, w_by = bound(w_work["bytes"], w_work["flops"], BF16_FLOP_PER_S)
    row = {"shape": [1, BATCH1_T, H, KV, D], "kv_len": BATCH1_LEN, "slices": len(spans),
           "slice_heads": hl, "slice_grid": list(slice_plan["grid"]),
           "whole_grid": list(whole_plan["grid"]), "bit_equal_at_split": bit,
           "bit_equal_whole": bool(torch.equal(s_out, w_out)), "max_rel_err_whole": rel,
           "lse_max_abs_err_whole": lse_e, "max_abs_err": err, "plain_lse_max_abs_err": plain_lse,
           "slice_ms": median_ms(first, REPS), "slice_device_ms": graph_ms(first, REPS),
           "whole_ms": median_ms(whole, REPS), "whole_device_ms": graph_ms(whole, REPS),
           "slices_device_ms": graph_ms(sliced, REPS), "plain_ms": median_ms(
               lambda: ref.decode_attention_ref(q, k, v, lens, scale=scale, return_lse=True),
               PLAIN_REPS),
           "slice_bound_ms": bms, "slice_bound_by": by, "whole_bound_ms": w_bms,
           "whole_bound_by": w_by}
    log(f"  decode_attention head slices B=1 T={BATCH1_T} kv_len={BATCH1_LEN} H={H} KV={KV} "
        f"D={D} (f32 q, bf16 cache), {len(spans)} slices of {hl} heads on strided views: "
        f"bit-equal to one call at their split ({slice_plan['n_split']} a kv head, grid "
        f"{tuple(slice_plan['grid'])}) {bit}; against one call at its own plan (grid "
        f"{tuple(whole_plan['grid'])}) out {rel:.3g} of max |out|, lse {lse_e:.3g} (bit-equal "
        f"{row['bit_equal_whole']}); vs plain {err:.3g}; one slice {row['slice_ms']:.4f} ms "
        f"({row['slice_device_ms']:.4f} device, bound {bms:.5f} ms by {by}), the whole call "
        f"{row['whole_ms']:.4f} ms ({row['whole_device_ms']:.4f} device, bound {w_bms:.5f} "
        f"ms by {w_by}), the {len(spans)} slices {row['slices_device_ms']:.4f} ms device; "
        f"plain {row['plain_ms']:.3f} ms")
    return row, counts


def batch1_step_check(dev: torch.device, mesh, seed: int) -> tuple:
    """(h), a full-width zamba2-7b decode step at B = 1 (bf16, seeded weights)
    against a BATCH1_T-slot cache filled with seeded values, at position
    BATCH1_LEN - 1, BATCH1_STEPS steps from one token each way: on plain
    tensors, and on DTensors of the 1 x 1 mesh (parameters as
    ``state_shardings`` places them in "fsdp", the cache as
    ``cache_shardings``): logits of every step and the cache after the last
    bit-equal; ms a step and a profiled step's idle share each way; K7's
    launches (13 a step) -> (row, launches of the DTensor steps)."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch.shardings import cache_shardings

    cfg = get_arch(BATCH1_ARCH)
    model = build_model(cfg, dev, seed=seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    cache0 = model.init_cache(1, BATCH1_T)
    for t in cache0.values():
        t.copy_(torch.randn(t.shape, generator=gen, device=dev) * 0.5)
    tokens = torch.randint(0, cfg.vocab_size, (BATCH1_STEPS + 2, 1, 1), generator=gen,
                           device=dev, dtype=torch.int32)
    pos0 = BATCH1_LEN - 1
    params = dict(model.named_parameters())
    shd = state_shardings(params, mesh, "fsdp", cfg.family)
    tshd = batch_shardings({"t": ((1, 1), torch.int32)}, mesh)["t"]

    class Call(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.model = model

        def forward(self, *args):
            return self.model.decode_step(*args)

    call = Call()
    runs, prof, counts = {}, {}, {}
    for way in ("plain", "dtensor"):
        cache = {k: t.clone() for k, t in cache0.items()}
        # both ways on the plain norm and rotary chain, which DTensors run
        # (plain bf16 tensors would take the fused kernels: other roundings)
        with use_mesh(mesh), implicit_replication(), torch.no_grad(), plain_norms():
            if way == "dtensor":
                named = {f"model.{n}": t for n, t in as_dtensors(params, shd, mesh).items()}
                cache = as_dtensors(cache, cache_shardings(cache, mesh, cfg.family), mesh)
                put = lambda t: as_dtensors({"t": t}, {"t": tshd}, mesh)["t"]  # noqa: E731
            else:
                named = {f"model.{n}": t for n, t in params.items()}
                put = lambda t: t  # noqa: E731

            def step(i: int):
                logits, _ = torch.func.functional_call(call, named,
                                                       (put(tokens[i]), cache, pos0 + i))
                return logits

            ops.reset_launch_counts()
            logits, ms = [], []
            for i in range(BATCH1_STEPS):
                t0 = time.perf_counter()
                out = step(i)
                sync()
                ms.append((time.perf_counter() - t0) * 1e3)
                logits.append(out.to_local() if partitioning.is_dtensor(out) else out)
            counts[way] = ops.launch_counts()
            final = {k: (t.to_local() if partitioning.is_dtensor(t) else t).clone()
                     for k, t in cache.items()}
            prof[way] = profile_call(f"zamba2-7b decode step B=1, {way} tensors on the 1 x 1 "
                                     f"mesh", lambda: step(BATCH1_STEPS), host=False)
        runs[way] = {"logits": logits, "ms": ms, "cache": final}
        del cache, named
        gc.collect()
        torch.cuda.empty_cache()
    del model, params, cache0
    gc.collect()
    torch.cuda.empty_cache()
    p, d = runs["plain"], runs["dtensor"]
    same_logits = all(torch.equal(a, b) for a, b in zip(p["logits"], d["logits"]))
    same_cache = all(torch.equal(p["cache"][k], d["cache"][k]) for k in p["cache"])
    rel = max(_rel_err(b, a) for a, b in zip(p["logits"], d["logits"]))
    expect(all(bool(torch.isfinite(t).all()) for t in p["logits"]),
           "zamba2 decode step B=1: non-finite logits")
    expect(same_logits and same_cache,
           f"zamba2 decode step B=1: DTensors vs plain differ (logits {same_logits}, "
           f"cache {same_cache}, logits off by {rel:.3g} of their max)")
    want = cfg.n_layers // cfg.attn_every * BATCH1_STEPS
    for way, c in counts.items():
        expect(c["decode_attention"] == want,
               f"zamba2 decode step B=1 ({way}): {c['decode_attention']} K7 launches, not "
               f"{want}")
    row = {"steps": BATCH1_STEPS, "T": BATCH1_T, "pos0": pos0, "bit_equal": same_logits,
           "cache_bit_equal": same_cache, "logits_max_rel_err": rel,
           **{f"{w}_ms": runs[w]["ms"] for w in runs},
           **{f"{w}_profiled_{k}": prof[w][k] for w in prof
              for k in ("wall_ms", "device_ms", "device_ops")}}
    log(f"  zamba2-7b decode step B=1 against a {BATCH1_T}-slot cache at position {pos0}, "
        f"{BATCH1_STEPS} steps: DTensors of the 1 x 1 mesh vs plain tensors, logits bit-equal "
        f"{same_logits}, cache bit-equal {same_cache}; ms a step plain "
        f"{', '.join(f'{x:.1f}' for x in p['ms'])}, dtensor "
        f"{', '.join(f'{x:.1f}' for x in d['ms'])}; profiled step idle share plain "
        f"{1 - prof['plain']['device_ms'] / prof['plain']['wall_ms']:.3f}, dtensor "
        f"{1 - prof['dtensor']['device_ms'] / prof['dtensor']['wall_ms']:.3f}; K7 launches "
        f"{counts['dtensor']['decode_attention']}")
    return row, counts["dtensor"]


def phase_layout(dev: torch.device, seed: int = 13):
    """(a) K6 with q_offset: chunks, a window with a softcap, the chunks of a
    prompt against one call, the backward; (b) qwen3-1.7b's prefill through
    attn_impl="blocked" against the default route; (c) launch/train.py's
    main on a 1 x 1 nccl mesh against make_train_step on plain tensors; (d)
    a full-width qwen2-moe MoE block through expert parallelism on DTensors
    of that mesh against plain tensors; (e) llama4's attention in the q-head
    slices of a 16-way model axis against one call, seamless's cross
    entropy in 16 vocabulary chunks; (f) zamba2's Mamba2 layer and a group
    in the head slices of a 16-way model axis against the whole, and a
    layer on DTensors of the 1 x 1 mesh; (g) the MoE block of (d) without
    dispatch groups in "fsdp" on DTensors of that mesh against plain
    tensors; (h) zamba2-7b's decode at batch 1: K7 in the head slices of a
    16-way "data" axis against one call, and a full-width decode step on
    DTensors of that mesh against plain tensors -> (K6 row fields, launches
    of (b), (c), (e), (f) and (h))."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    B, H, KV, D = ATTN_B, ATTN_H, ATTN_KV, ATTN_D
    # --- (a) the chunks, each dtype; the window + softcap chunk
    chunks, concat, bwd = [], {}, {}
    for dt in (torch.bfloat16, torch.float32):
        for qo in LAYOUT_OFFSETS:
            chunks.append(chunk_row(gen, dev, dt, qo))
        chunks.append(chunk_row(gen, dev, dt, LAYOUT_OFFSETS[-1], window=256, softcap=50.0))
        # a prompt's chunks, each against the keys so far, against one call
        q = _randn(gen, B, ATTN_S, H, D, dtype=dt, dev=dev)
        k, v = (_randn(gen, B, ATTN_S, KV, D, dtype=dt, dev=dev) for _ in range(2))
        whole = flash_k.flash_attention(q, k, v)
        parts = torch.cat([flash_k.flash_attention(q[:, lo:lo + LAYOUT_CHUNK],
                                                   k[:, :lo + LAYOUT_CHUNK],
                                                   v[:, :lo + LAYOUT_CHUNK], q_offset=lo)
                           for lo in range(0, ATTN_S, LAYOUT_CHUNK)], dim=1)
        name = str(dt)[6:]
        concat[name] = attn_err(f"{ATTN_S // LAYOUT_CHUNK} chunks vs one call {name}",
                                parts, whole)
        log(f"  flash_attention {name}: {ATTN_S // LAYOUT_CHUNK} chunks of {LAYOUT_CHUNK} rows "
            f"at their q_offsets vs one call at S={ATTN_S}: max err {concat[name]:.3g}, "
            f"bit-equal {bool(torch.equal(parts, whole))}")
        bwd[name] = bwd_check(gen, dev, B, LAYOUT_CHUNK, LAYOUT_OFFSETS[-1] + LAYOUT_CHUNK, H,
                              KV, D, dt, {"q_offset": LAYOUT_OFFSETS[-1]})
    rows = {"q_offset_chunks": chunks, "q_offset_concat_max_err": concat,
            "q_offset_bwd_max_err": bwd}

    # --- (b) the prefill through blocked_attention against the default route
    cfg = get_arch(MODEL_ARCH)
    tokens = torch.randint(0, cfg.vocab_size, (ATTN_B, ATTN_S), generator=gen, device=dev)
    blocked = build_model(dataclasses.replace(cfg, attn_impl="blocked"), dev, seed=7)
    ops.reset_launch_counts()
    with torch.no_grad():
        lb, cb = blocked.prefill({"tokens": tokens}, ATTN_S)
    blocked_counts = ops.launch_counts()
    expect(blocked_counts["flash_attention"] == cfg.n_layers,
           f"blocked prefill launched K6 {blocked_counts['flash_attention']} times")
    del blocked
    naive = build_model(cfg, dev, seed=7)
    with torch.no_grad():
        ln, cn = naive.prefill({"tokens": tokens}, ATTN_S)
    same = bool(torch.equal(lb, ln)) and all(torch.equal(cb[n], cn[n]) for n in cn)
    expect(same, "the blocked prefill's logits or cache differ from the default route's")
    log(f"  qwen3-1.7b prefill B={ATTN_B} S={ATTN_S} attn_impl=blocked: "
        f"{blocked_counts['flash_attention']} "
        f"K6 launches; logits and cache bit-equal to attn_impl=naive's")
    del naive, cb, cn
    gc.collect()
    torch.cuda.empty_cache()

    # --- (c) launch/train.py on the host mesh (1 x 1, nccl: ``distribute``
    # leaves the state plain), then the same steps from the same state with
    # make_train_step on plain tensors, and on DTensors of the 1 x 1 mesh
    full = get_arch(MODEL_ARCH)
    argv = ["--arch", MODEL_ARCH, "--seq-len", str(ATTN_S), "--batch", str(ATTN_B),
            "--steps", str(FULL_STEPS), "--log-every", "1"]
    ops.reset_launch_counts()
    history = train_main(argv, device=dev)
    train_counts = ops.launch_counts()
    fwd, bwd_n = train_launches(full)
    expect_launches("train.py on the host mesh", train_counts, fwd * FULL_STEPS,
                    bwd_n * FULL_STEPS)
    ocfg = OptimizerConfig(lr=3e-4, total_steps=FULL_STEPS)   # main's, from its defaults
    shape = ShapeSpec("cli", ATTN_S, ATTN_B, "train")
    mesh = make_host_mesh(device=dev)
    runs, prof = {}, {}
    for way in ("plain", "dtensor"):
        gc.collect()
        torch.cuda.empty_cache()
        model = build_model(full, dev, seed=0, trainable=True)
        state = init_state(model, ocfg)
        with use_mesh(mesh):
            shd = state_shardings(state, mesh, "tp", full.family)
            if way == "dtensor":
                state = as_dtensors(state, shd, mesh)
            step = make_train_step(model, ocfg, grad_shardings=shd["params"])
            bshd = batch_shardings(model.input_specs(shape), mesh)
            put = (lambda b: as_dtensors(b, bshd, mesh)) if way == "dtensor" else (lambda b: b)
            runs[way] = []
            for i in range(FULL_STEPS):
                t0 = time.perf_counter()
                m = step(state, put(synthetic_batch(model, full, shape, i, dev)))[1]
                runs[way].append({"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                                  "ms": (time.perf_counter() - t0) * 1e3})
            batch = put(synthetic_batch(model, full, shape, FULL_STEPS, dev))
            prof[way] = profile_call(f"train step qwen3-1.7b, {way} tensors on the 1 x 1 mesh",
                                     lambda: step(state, batch), host=False)
        del model, state, step, batch
    gaps = {w: [max(abs(h[k] - p[k]) / abs(p[k]) for k in ("loss", "grad_norm"))
                for h, p in zip(hist, runs["plain"])]
            for w, hist in (("launcher", history), ("dtensor", runs["dtensor"]))}
    for w, g in gaps.items():
        expect(max(g) <= LAYOUT_TRAIN_REL_TOL, f"{w} vs plain steps differ by {g}")
    log(f"  {FULL_STEPS} steps: train.py on the 1 x 1 mesh, make_train_step on DTensors of "
        f"that mesh, and on plain tensors: losses {[h['loss'] for h in history]}, "
        f"{[h['loss'] for h in runs['dtensor']]}, {[p['loss'] for p in runs['plain']]}; "
        f"grad norms {[h['grad_norm'] for h in history]}, "
        f"{[h['grad_norm'] for h in runs['dtensor']]}, "
        f"{[p['grad_norm'] for p in runs['plain']]}; relative gaps to plain {gaps} "
        f"(bit-equal: launcher {all(g == 0 for g in gaps['launcher'])}, dtensor "
        f"{all(g == 0 for g in gaps['dtensor'])}); ms a step "
        + "; ".join(", ".join(f"{h['ms']:.1f}" for h in hist) for hist in
                    (history, runs["dtensor"], runs["plain"])))
    rows["layout_train"] = {
        "launcher_ms": [h["ms"] for h in history],
        **{f"{w}_ms": [h["ms"] for h in runs[w]] for w in runs},
        "launcher_rel_gaps": gaps["launcher"], "dtensor_rel_gaps": gaps["dtensor"],
        **{f"{w}_profiled_{k}": prof[w][k] for w in prof
           for k in ("wall_ms", "device_ms", "device_ops")}}
    gc.collect()
    torch.cuda.empty_cache()
    # --- (d) the MoE block through expert parallelism on DTensors of the mesh
    rows["layout_moe"] = moe_block_check(dev, mesh, seed, LAYOUT_MOE_G, "ep")
    gc.collect()
    torch.cuda.empty_cache()
    # --- (e) llama4's attention split over 16 ranks' q heads; seamless's
    # vocabulary over 16 chunks
    rows["head_split"], head_counts = head_split_check(dev, gen)
    gc.collect()
    torch.cuda.empty_cache()
    # --- (f) zamba2's Mamba2 heads split over 16 ranks; a group of layers
    rows["mamba_split"], mamba_counts = mamba_split_check(dev, mesh, gen)
    gc.collect()
    torch.cuda.empty_cache()
    # --- (g) the MoE block without dispatch groups in "fsdp" on DTensors
    rows["layout_moe_fsdp"] = moe_block_check(dev, mesh, seed, 0, "fsdp")
    gc.collect()
    torch.cuda.empty_cache()
    # --- (h) zamba2's decode at batch 1: K7's head slices, a full step
    rows["batch1_slices"], slice_counts = batch1_slices_check(dev, gen)
    gc.collect()
    torch.cuda.empty_cache()
    rows["batch1_step"], step_counts = batch1_step_check(dev, mesh, seed)
    batch1_counts = {n: slice_counts[n] + step_counts[n] for n in slice_counts}
    return rows, blocked_counts, train_counts, head_counts, mamba_counts, batch1_counts


# ------------------------------------------------------------------ phase 13
# phase dryrun: K7 with lse, and qwen3-1.7b's decode cache (B = 8, H = 16,
# KV = 8, D = 128, a bf16 cache of 32768 slots) cut into DRYRUN_SPLITS
# shards as a 16-way "model" axis cuts it (rows with shards that hold no
# valid slot); the analysis of a full-width train step, fake against real;
# the dry-run CLI on qwen3's four cells with fake CUDA tensors
DRYRUN_SPLITS, DRYRUN_B, DRYRUN_T = 16, 8, 32768
DRYRUN_LENS = (32768, 20000, 1500, 7, 2048, 16385, 30000, 1)
DRYRUN_CELLS = ("qwen3-1.7b:train_4k", "qwen3-1.7b:prefill_32k", "qwen3-1.7b:decode_32k",
                "qwen3-1.7b:long_500k")
# MoE cells in "ep" with 16 dispatch groups, as the reference's optimized
# settings run them (qwen2-moe's train and long_500k and llama4's cells run
# on the CPU: see README)
DRYRUN_MOE_CELLS = ("qwen2-moe-a2.7b:prefill_32k", "qwen2-moe-a2.7b:decode_32k")
DRYRUN_MOE_ARGS = ("--mode", "ep", "--override", "moe_dispatch_groups=16")
# cells whose q heads 16 does not divide (llama4's 40, gemma-2b's 8), each
# rank computing only its own heads, with the CLI's arguments (llama4 in
# "ep" with 16 dispatch groups, as the MoE cells; without them its MoE
# routes every token on every rank): the port's FLOPs lie between the
# model's useful FLOPs a chip and DRYRUN_HEAD_LIMIT x the reference's (its
# dry run's per-device FLOPs with the same arguments on a CPU host,
# ``python -m repro.launch.dryrun``); and zamba2's prefill and decode cells,
# its Mamba2 layers split over the ranks' 7 of 112 heads
DRYRUN_HEAD_CELLS = {"llama4-maverick-400b-a17b:prefill_32k": DRYRUN_MOE_ARGS,
                     "gemma-2b:prefill_32k": (), "zamba2-7b:prefill_32k": (),
                     "zamba2-7b:decode_32k": ()}
DRYRUN_HEAD_REF_FLOPS = {"llama4-maverick-400b-a17b:prefill_32k": 2.94652194996224e14,
                         "gemma-2b:prefill_32k": 5.5817526050816e13,
                         "zamba2-7b:prefill_32k": 1.28012085286912e14,
                         "zamba2-7b:decode_32k": 1.2189442048e10}
DRYRUN_HEAD_LIMIT = 1.5
# MoE cells without dispatch groups ("fsdp", --all's default): each rank's
# experts over its chunk of their hidden, the shared MLP's contraction split
# over "model" in a decode step; held as the head cells are, to the
# reference's FLOPs with the same arguments (their own folder: qwen2-moe's
# decode_32k is an "ep" cell above too)
DRYRUN_FSDP_MOE_REF_FLOPS = {"qwen2-moe-a2.7b:decode_32k": 5.806555136e9,
                             "llama4-maverick-400b-a17b:decode_32k": 7.455014912e10}
# long_500k cells, whose batch of 1 the 16 data ranks do not divide: the
# decode under ``embed_split`` (weights kept in place, d and K7's heads split
# over "data"), held to (FLOPs, collective bytes) limits, and their FLOPs
# with fake CUDA tensors equal to the same CLI's with fake CPU tensors on a
# CPU host (``--device cpu``)
DRYRUN_B1_LIMITS = {"zamba2-7b:long_500k": (3.65e9, 2.3e7),
                    "seamless-m4t-large-v2:long_500k": (1.91e9, 1.5e7),
                    "xlstm-125m:long_500k": (1.72e8, 2.0e6)}
DRYRUN_B1_HOST_FLOPS = {"zamba2-7b:long_500k": 457411136.0,
                        "seamless-m4t-large-v2:long_500k": 210847360.0,
                        "xlstm-125m:long_500k": 147859200.0}
SPLIT_REL_TOL = 1e-5     # split-and-combine vs one call: out (of max |out|), lse
PEAK_REL_TOL = 0.10      # the analysis's peak bytes vs max_memory_allocated


def decode_lse_rows(gen, dev) -> dict:
    """(a) K7 with ``return_lse`` against its plain version at decode_row's
    shape (qwen3's heads, a ring-sized cache, ragged kv_len), then the split:
    DRYRUN_SPLITS shards of the decode cache, K7 with lse on each (q in f32,
    as ``ops.sharded_decode_attention`` runs it) merged by
    ``decode_attention.combine``, against one K7 call on the whole cache;
    K7's time with and without lse and the combine's, each beside its
    bound."""
    H, KV, D = ATTN_H, ATTN_KV, ATTN_D
    T, lens = DECODE_T, [DECODE_T, ATTN_S + 1, 1500, 7]
    B = len(lens)
    q = _randn(gen, B, H, D, dev=dev)
    k, v = (_randn(gen, B, T, KV, D, dev=dev) for _ in range(2))
    kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
    scale = 1.0 / np.sqrt(D)
    out, lse = decode_k.decode_attention(q, k, v, kv_len, scale=scale, return_lse=True)
    w_out, w_lse = ref.decode_attention_ref(q, k, v, kv_len, scale=scale, return_lse=True)
    err = attn_err("decode_attention with lse", out, w_out)
    expect(bool(torch.isfinite(lse).all()), "decode_attention: non-finite lse at kv_len > 0")
    lse_e = float((lse - w_lse).abs().max())
    expect(lse_e <= SPLIT_REL_TOL * max(1.0, float(w_lse.abs().max())),
           f"decode_attention lse off by {lse_e:.3g}")

    # --- the split of qwen3-1.7b's decode cache
    B, T = DRYRUN_B, DRYRUN_T
    q = torch.randn((B, H, D), generator=gen, device=dev)
    k, v = (_randn(gen, B, T, KV, D, dev=dev) for _ in range(2))
    kv_len = torch.tensor(DRYRUN_LENS, dtype=torch.int32, device=dev)
    tl = T // DRYRUN_SPLITS
    full = lambda: decode_k.decode_attention(q, k, v, kv_len, scale=scale,  # noqa: E731
                                             return_lse=True)
    bare = lambda: decode_k.decode_attention(q, k, v, kv_len, scale=scale)  # noqa: E731
    shards = [(k[:, r * tl:(r + 1) * tl], v[:, r * tl:(r + 1) * tl],
               (kv_len - r * tl).clamp(0, tl).to(torch.int32)) for r in range(DRYRUN_SPLITS)]
    parts = [decode_k.decode_attention(q, ks, vs, ls, scale=scale, return_lse=True)
             for ks, vs, ls in shards]
    outs, lses = torch.stack([o for o, _ in parts]), torch.stack([s_ for _, s_ in parts])
    empty = int(torch.isneginf(lses).any(-1).sum())
    merge = lambda: decode_k.combine(outs, lses, lambda x: x.amax(0, keepdim=True),  # noqa: E731
                                     lambda x: x.sum(0))
    w_out, w_lse = full()
    got = merge()
    split_err = float((got - w_out).abs().max() / w_out.abs().max())
    split_lse = float((torch.logsumexp(lses, 0) - w_lse).abs().max())
    expect(split_err <= SPLIT_REL_TOL, f"split K7: out off by {split_err:.3g} of max |out|")
    expect(split_lse <= SPLIT_REL_TOL, f"split K7: lse off by {split_lse:.3g}")
    slots = int(kv_len.clamp(0, T).sum())
    work = decode_k.work(B, H, KV, D, slots, 4, 2, True)
    bms, by = bound(work["bytes"], work["flops"], BF16_FLOP_PER_S)
    # the combine reads the stacked partials (out and lse of each shard) once
    # and writes the merged out: bytes, at most 3 operations an element
    c_bytes = 4 * (outs.numel() + lses.numel() + got.numel())
    c_bms, c_by = bound(c_bytes, 3.0 * outs.numel(), FP32_FLOP_PER_S)
    t = {"lse_ms": median_ms(full, REPS), "lse_device_ms": graph_ms(full, REPS),
         "nolse_ms": median_ms(bare, REPS), "nolse_device_ms": graph_ms(bare, REPS),
         "combine_ms": median_ms(merge, REPS), "combine_device_ms": graph_ms(merge, REPS)}
    log(f"  decode_attention with lse B={len(lens)} T={DECODE_T} kv_len={lens} H={H} KV={KV} "
        f"D={D} bf16: max err {err:.3g}, lse max err {lse_e:.3g}")
    log(f"  decode_attention split B={B} T={T} into {DRYRUN_SPLITS} shards of {tl} (f32 q, bf16 "
        f"cache, kv_len {list(DRYRUN_LENS)}; {empty} shard rows with no valid slot): out "
        f"{split_err:.3g} of max |out|, lse {split_lse:.3g} off one call; one call with lse "
        f"{t['lse_ms']:.4f} ms ({t['lse_device_ms']:.4f} device), without "
        f"{t['nolse_ms']:.4f} ({t['nolse_device_ms']:.4f} device), bound {bms:.5f} ms by {by}; "
        f"combine {t['combine_ms']:.4f} ms ({t['combine_device_ms']:.4f} device), bound "
        f"{c_bms:.5f} ms by {c_by}")
    return {"lse_max_abs_err": lse_e, "split": {
        "shape": [B, T, H, KV, D], "shards": DRYRUN_SPLITS, "kv_len": list(DRYRUN_LENS),
        "empty_shard_rows": empty, "max_rel_err": split_err, "lse_max_abs_err": split_lse,
        **t, "bound_ms": bms, "bound_by": by, "combine_bound_ms": c_bms,
        "combine_bound_by": c_by}}


def analysis_check(dev, seed: int) -> dict:
    """(b) ``hlo_analysis.analyze`` of phase train's full-width qwen3-1.7b
    step (B = ATTN_B x ATTN_S, one card, plain tensors, f32 masters and
    moments, as launch/train.py runs it) on fake CUDA tensors (the model
    built on "meta", nothing allocated) and on the card: FLOPs counted the
    same way must be equal, the fake peak (arguments + temp) within
    PEAK_REL_TOL of ``max_memory_allocated`` over the real step (less what
    was allocated before the model); the roofline terms beside the step's
    measured time."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    full = get_arch(MODEL_ARCH)
    ocfg = OptimizerConfig()
    shape = ShapeSpec("cli", ATTN_S, ATTN_B, "train")
    meta = build_model(full, "meta", trainable=True)
    meta.device = dev
    params = dict(meta.named_parameters())
    specs = {"params": params, "opt": adamw_init(params, ocfg)}

    def fake_like(tree):
        return {k: fake_like(x) if isinstance(x, dict)
                else torch.empty(tuple(x.shape), dtype=x.dtype, device=dev)
                for k, x in tree.items()}

    with FakeTensorMode():
        state = fake_like(specs)
        batch = {k: torch.empty(shp, dtype=dt, device=dev)
                 for k, (shp, dt) in meta.input_specs(shape).items()}
        fake = hlo_analysis.analyze(make_train_step(meta, ocfg), state, batch, donate=[state])
    del meta, params, specs, state, batch
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    model = build_model(full, dev, seed=seed, trainable=True)
    state = init_state(model, ocfg)
    step = make_train_step(model, ocfg)
    batch = synthetic_batch(model, full, shape, 0, dev)
    sync()
    torch.cuda.reset_peak_memory_stats()
    real = hlo_analysis.analyze(step, state, batch, donate=[state])
    sync()
    peak = torch.cuda.max_memory_allocated() - before
    t0 = time.perf_counter()
    step(state, synthetic_batch(model, full, shape, 1, dev))
    sync()
    step_ms = (time.perf_counter() - t0) * 1e3
    del model, state, step, batch
    gc.collect()
    torch.cuda.empty_cache()
    gap = fake["peak_bytes"] / peak - 1
    expect(fake["flops"] == real["flops"],
           f"analysis: fake FLOPs {fake['flops']} != real {real['flops']}")
    expect(fake["kernel_launches"] == real["kernel_launches"],
           f"analysis: fake kernels {fake['kernel_launches']} != real {real['kernel_launches']}")
    expect(abs(gap) <= PEAK_REL_TOL,
           f"analysis: fake peak {fake['peak_bytes']} vs max_memory_allocated {peak}")
    roof = dryrun.roofline_terms({"chips": 1, "hlo_flops": fake["flops"],
                                  "hlo_bytes": fake["bytes"], "collective_bytes": 0.0},
                                 dryrun.model_flops_for(full, shape))
    log(f"  analysis of the qwen3-1.7b train step B={ATTN_B} S={ATTN_S}: FLOPs fake "
        f"{fake['flops']:.6e} = real {real['flops']:.6e}; bytes fake {fake['bytes']:.6e}, real "
        f"{real['bytes']:.6e}; peak fake {fake['peak_bytes']} (arguments "
        f"{fake['argument_size_in_bytes']} + temp {fake['temp_size_in_bytes']}) vs "
        f"max_memory_allocated {peak} ({100 * gap:+.2f} %); kernels {fake['kernel_launches']}; "
        f"fake run {fake['seconds']:.1f} s, real run under the analysis {real['seconds']:.2f} s; "
        f"roofline compute {roof['compute_s'] * 1e3:.1f} ms, memory "
        f"{roof['memory_s'] * 1e3:.1f} ms ({roof['dominant']}) beside a measured step of "
        f"{step_ms:.1f} ms")
    return {"flops": fake["flops"], "bytes": fake["bytes"], "real_bytes": real["bytes"],
            "fake_peak_bytes": fake["peak_bytes"], "max_memory_allocated": peak,
            "peak_gap": gap, "fake_s": fake["seconds"], "step_ms": step_ms,
            "roofline": roof}


def phase_dryrun(dev: torch.device, seed: int = 14) -> tuple:
    """(a) K7's lse and the 16-way split, (b) the analysis against the card,
    (c) ``launch/dryrun.py`` on qwen3-1.7b's four cells and DRYRUN_MOE_CELLS
    (in "ep", 16 dispatch groups), DRYRUN_HEAD_CELLS and the MoE cells of
    DRYRUN_FSDP_MOE_REF_FLOPS ("fsdp", no groups) on the 16 x 16 mesh
    with fake CUDA tensors, in a fake world of 256 ranks (the process's
    group, if any, is ended first: the phase runs last), each cell ok and
    no real kernel launched, the "ep" MoE cells with an all-to-all, the
    head cells' and the "fsdp" MoE cells' FLOPs within DRYRUN_HEAD_LIMIT x
    the reference's.  -> (K7's extra row keys, the real launches of (a)
    and (b), the cells' figures)."""
    import torch.distributed as dist

    gen = torch.Generator(device=dev).manual_seed(seed)
    gc.collect()
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    rows = decode_lse_rows(gen, dev)
    rows["analysis"] = analysis_check(dev, seed)
    counts = ops.launch_counts()
    # --- (c) the CLI, fake CUDA tensors, no real launch
    if dist.is_initialized():
        dist.destroy_process_group()
    ops.reset_launch_counts()
    out = ROOT / "build" / "dryrun_torch"    # beside the built kernels (not tracked)
    out_fsdp = ROOT / "build" / "dryrun_torch_fsdp_moe"
    t0 = time.perf_counter()
    try:
        dryrun.main(["--cells", ",".join(DRYRUN_CELLS), "--device", "cuda", "--out", str(out)])
        dryrun.main(["--cells", ",".join(DRYRUN_MOE_CELLS), *DRYRUN_MOE_ARGS, "--device", "cuda",
                     "--out", str(out)])
        for cell, args in DRYRUN_HEAD_CELLS.items():
            dryrun.main(["--cells", cell, *args, "--device", "cuda", "--out", str(out)])
        dryrun.main(["--cells", ",".join(DRYRUN_FSDP_MOE_REF_FLOPS), "--device", "cuda",
                     "--out", str(out_fsdp)])
        dryrun.main(["--cells", ",".join(DRYRUN_B1_LIMITS), "--device", "cuda", "--out",
                     str(out)])
    except SystemExit as e:
        raise SmokeFailure(f"dryrun CLI failed ({e.code}): see {out}") from None
    cli_s = time.perf_counter() - t0
    real = ops.launch_counts()
    expect(not any(real.values()), f"the dry run launched kernels: {real}")
    cells = {}
    # (key, cell, folder, the reference's FLOPs where they are held)
    runs = [(c, c, out, DRYRUN_HEAD_REF_FLOPS.get(c))
            for c in DRYRUN_CELLS + DRYRUN_MOE_CELLS + tuple(DRYRUN_HEAD_CELLS)]
    runs += [(f"{c}:fsdp", c, out_fsdp, f) for c, f in DRYRUN_FSDP_MOE_REF_FLOPS.items()]
    runs += [(c, c, out, None) for c in DRYRUN_B1_LIMITS]
    for key, cell, folder, ref_flops in runs:
        arch, shp = cell.split(":")
        res = json.loads((folder / f"{arch}__{shp}__16x16.json").read_text())
        keys = ("lower_s", "argument_size_in_bytes", "temp_size_in_bytes",
                "alias_size_in_bytes", "output_size_in_bytes", "hlo_flops", "hlo_bytes",
                "collective_bytes")
        cells[key] = {**{k: res[k] for k in keys}, "dominant": res["roofline"]["dominant"],
                      "all_to_all_bytes": res["collectives"].get("all-to-all", 0.0)}
        if key in DRYRUN_MOE_CELLS:
            expect(cells[key]["all_to_all_bytes"] > 0, f"dryrun {key}: no all-to-all")
        if key in DRYRUN_B1_LIMITS:
            f_lim, c_lim = DRYRUN_B1_LIMITS[key]
            useful = res["roofline"]["model_flops"] / res["chips"]
            expect(res["hlo_flops"] == DRYRUN_B1_HOST_FLOPS[key],
                   f"dryrun {key}: {res['hlo_flops']!r} FLOPs with fake CUDA tensors, "
                   f"{DRYRUN_B1_HOST_FLOPS[key]!r} with fake CPU tensors")
            expect(useful <= res["hlo_flops"] <= f_lim and res["collective_bytes"] <= c_lim,
                   f"dryrun {key}: {res['hlo_flops']:.6e} FLOPs (useful {useful:.6e}, limit "
                   f"{f_lim:.6e}), {res['collective_bytes']:.6e} collective bytes (limit "
                   f"{c_lim:.6e})")
        if ref_flops is not None:
            useful = res["roofline"]["model_flops"] / res["chips"]
            limit = DRYRUN_HEAD_LIMIT * ref_flops
            cells[key]["flops_over_reference"] = res["hlo_flops"] / ref_flops
            expect(useful <= res["hlo_flops"] <= limit,
                   f"dryrun {key}: {res['hlo_flops']:.6e} FLOPs, not between the useful "
                   f"{useful:.6e} and {limit:.6e} ({DRYRUN_HEAD_LIMIT} x the reference's)")
            log(f"  dryrun {key}: FLOPs {cells[key]['flops_over_reference']:.3f} x the "
                f"reference's {ref_flops:.6e}")
        log(f"  dryrun {key} 16x16 {res['mode']} (fake cuda): ok, {res['lower_s']} s; per "
            f"device: all-to-all {cells[key]['all_to_all_bytes']:.6e} bytes, args "
            f"{res['argument_size_in_bytes']}, temp {res['temp_size_in_bytes']}, alias "
            f"{res['alias_size_in_bytes']}, flops {res['hlo_flops']:.6e}, bytes "
            f"{res['hlo_bytes']:.6e}, collective {res['collective_bytes']:.6e} "
            f"{res['collective_counts']}; dominant {res['roofline']['dominant']}")
    log(f"  dryrun CLI: {len(cells)} cells in {cli_s:.1f} s, real launches {real}")
    return rows, counts, cells


def as_dtensors(tree, shardings, mesh):
    """Every leaf of ``tree`` as a DTensor of its placements in the matching
    tree ``shardings`` on a 1 x 1 mesh, its storage kept: the DTensor path
    that ``distribute`` leaves out on one rank, timed for its host cost."""
    from torch.distributed.tensor import DTensor

    if isinstance(tree, dict):
        return {k: as_dtensors(v, shardings[k], mesh) for k, v in tree.items()}
    return DTensor.from_local(tree.detach(), mesh, tuple(shardings))


def family_names() -> tuple:
    """``--families [NAME,NAME...]``: the architectures named after the
    flag, or all of FAMILIES."""
    i = sys.argv.index("--families")
    if i + 1 < len(sys.argv) and not sys.argv[i + 1].startswith("--"):
        names = tuple(sys.argv[i + 1].split(","))
        expect(set(names) <= set(FAMILIES), f"--families takes names of {FAMILIES}")
        return names
    return FAMILIES


@contextlib.contextmanager
def timed(name: str):
    """Print a phase's start and, when it succeeds, its seconds."""
    t0 = time.perf_counter()
    log(f"phase {name} ...")
    yield
    log(f"phase {name}: {time.perf_counter() - t0:.3f} s")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available; this script runs on the card",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    with timed("env"):
        phase_env()
    log(f"port: {SRC}")
    only = [m for m in ("--model", "--top1", "--nearest", "--families", "--train", "--layout",
                        "--dryrun", "--hash", "--near-tie", "--examples", "--bwd-rows",
                        "--d256-rows", "--norm-rope")
            if m in sys.argv[1:]]
    if only:
        with timed("build"):
            build.build_all()
        for mode in only:
            with timed(mode[2:]):
                {"--model": phase_model, "--top1": phase_top1, "--nearest": phase_nearest,
                 "--families": lambda d: phase_families(d, family_names()),
                 "--train": phase_train, "--layout": phase_layout,
                 "--dryrun": phase_dryrun, "--hash": phase_hash_repeat,
                 "--near-tie": phase_near_tie, "--examples": phase_examples,
                 "--bwd-rows": phase_bwd_rows, "--d256-rows": phase_d256_rows,
                 "--norm-rope": phase_norm_rope}[mode](dev)
        return 0
    with timed("build"):
        build.build_all()
        for name in ("flash_attention", "decode_attention", "flash_attention_bwd"):
            log(f"  {name} SASS: {build.sass_count(name, 'HGMMA')} HGMMA (wgmma), "
                f"{build.sass_count(name, 'UTMALDG')} UTMALDG (TMA loads)")
            for r in build.ptxas_report(name):
                if "_tc_kernel" in r["entry"] or "decode_split_kernel" in r["entry"]:
                    log(f"  ptxas {r['entry']}: {r['registers']} registers, {r['smem']} "
                        f"bytes static smem, spill stores {r['spill_stores']} bytes, "
                        f"spill loads {r['spill_loads']} bytes")
            for line in build.ptxas_warnings(name):
                log(f"  ptxas {name}: {line}")
        # K6's bf16 forward unspilled, D = 256 on its two-warpgroup design;
        # the bf16 backward on the tensor cores, unspilled
        fwd_ptxas()
        for kern in ("dkdv_tc_kernel", "dq_tc_kernel"):
            n_mma = build.sass_count("flash_attention_bwd", "HGMMA", kern)
            n_tma = build.sass_count("flash_attention_bwd", "UTMALDG", kern)
            log(f"  flash_attention_bwd {kern}: {n_mma} HGMMA, {n_tma} UTMALDG")
            expect(n_mma > 0 and n_tma > 0, f"{kern}: no wgmma or no TMA load in its SASS")
        spilled = [r["entry"] for r in build.ptxas_report("flash_attention_bwd")
                   if "_tc_kernel" in r["entry"] and (r["spill_stores"] or r["spill_loads"])]
        expect(not spilled, f"K6's bf16 backward kernels spill registers: {spilled}")
        for name in ("sim_topk", "reuse_probed", "lsh_hash"):
            log(f"  ptxas {name}: " + "; ".join(
                f"{r['entry'].split('_cu_')[-1][8:]} {r['registers']} registers, spills "
                f"{r['spill_stores']}/{r['spill_loads']} bytes" for r in build.ptxas_report(name)))
        spilled = [r["entry"] for r in build.ptxas_report("sim_topk")
                   if r["spill_stores"] or r["spill_loads"]]
        expect(not spilled, f"sim_topk kernels spill registers: {spilled}")
    paths = {}
    with timed("kernels"):
        kern = phase_kernels(dev)
        paths["hash-ids"] = phase_hash_ids(dev)
        kern.update(phase_top1(dev))
        kern["reuse_top1_probed"] = phase_probed(dev)
        kern.update(phase_attention_kernels(dev))
        kern.update(phase_norm_rope(dev))
    with timed("serve"):
        paths["serve"] = phase_serve(dev)
    with timed("store"):
        kern["reuse_top1_probed"].update(phase_store(dev))
    with timed("nearest"):
        paths["nearest"] = phase_nearest(dev)
    with timed("model"):
        model, paths["model"] = phase_model(dev)
    with timed("model-serve"):
        paths["model-serve"] = phase_model_serve(dev, model)
    with timed("async-serve"):
        paths["async-serve"] = phase_async_serve(dev, model)
    with timed("cosim"):
        paths["cosim"] = phase_cosim(dev, model)
    with timed("federation"):
        paths["federation"] = phase_federation(dev, model)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    with timed("near-tie"):
        paths["near-tie"] = phase_near_tie(dev)
    with timed("examples"):
        paths["examples-quickstart"], paths["examples-cognitive"], paths["examples-train"] = \
            phase_examples(dev)
    gc.collect()
    torch.cuda.empty_cache()
    with timed("families"):
        paths["families"] = phase_families(dev)
    with timed("train"):
        rows, paths["train"], paths["train-families"] = phase_train(dev)
        kern.update(rows)
    with timed("layout"):
        rows, paths["layout-blocked"], paths["layout-train"], paths["layout-heads"], \
            paths["layout-mamba"], paths["layout-batch1"] = phase_layout(dev)
        kern["decode_attention"].update(
            {k: rows.pop(k) for k in ("batch1_slices", "batch1_step")})
        kern["flash_attention"].update(rows)
    with timed("dryrun"):
        rows, paths["dryrun"], dryrun_cells = phase_dryrun(dev)
        kern["decode_attention"].update(rows)
        kern["decode_attention"]["dryrun_cells"] = dryrun_cells
    for name, path in MAIN_PATH.items():
        expect(paths[path][name] > 0, f"{name} was not launched on the {path} path")
    for name in ASYNC_PATH:
        expect(paths["async-serve"][name] > 0, f"{name} was not launched on the async-serve path")
    for name in COSIM_PATH:
        expect(paths["cosim"][name] > 0, f"{name} was not launched on the cosim path")
    for name in FEDERATION_PATH:
        expect(paths["federation"][name] > 0,
               f"{name} was not launched on the federation path")
    for name in NEAR_TIE_PATH:
        expect(paths["near-tie"][name] > 0, f"{name} was not launched on the near-tie path")
    for path, names in EXAMPLES_PATH.items():
        for name in names:
            expect(paths[path][name] > 0, f"{name} was not launched on the {path} path")
    for name in FAMILIES_PATH:
        expect(paths["families"][name] > 0, f"{name} was not launched on the families path")
    for name in TRAIN_FAMILIES_PATH:
        expect(paths["train-families"][name] > 0,
               f"{name} was not launched by the families' full-width train steps")
    for path, names in LAYOUT_PATH.items():
        for name in names:
            expect(paths[path][name] > 0, f"{name} was not launched on the {path} path")
    # each kernel's launches on its own path (reuse_top1: the serve path's, 0)
    lines = [{"name": name, "route": "cuda", "source": SOURCES[name][0],
              "replaces": SOURCES[name][1],
              "launches": paths[MAIN_PATH.get(name, "serve")][name],
              "async_serve_launches": paths["async-serve"][name],
              "cosim_launches": paths["cosim"][name],
              "federation_launches": paths["federation"][name],
              "near_tie_launches": paths["near-tie"][name],
              "examples_launches": sum(paths[p][name] for p in EXAMPLES_PATH),
              "families_launches": paths["families"].get(name, 0),
              "train_launches": paths["train"][name],
              "train_families_launches": paths["train-families"].get(name, 0),
              "layout_blocked_launches": paths["layout-blocked"][name],
              "layout_train_launches": paths["layout-train"][name],
              "layout_heads_launches": paths["layout-heads"][name],
              "layout_mamba_launches": paths["layout-mamba"][name],
              "layout_batch1_launches": paths["layout-batch1"][name],
              "dryrun_launches": paths["dryrun"][name],
              "library_ms": None, **kern[name]} for name in SOURCES]
    print(json.dumps({"kernels": lines}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
