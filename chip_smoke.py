#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its wall time:

1. device: the card's name and power limit (``nvidia-smi``), then the build
   of the CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc`` per
   source, all at once, then one link; each source's seconds printed) and
   the registers and spills ``ptxas`` reported for the matmul, attention
   and wkv6 kernels;
2. kernels: ``swap_linear_q``, ``dequant_int8``, ``paged_attention``,
   ``wkv6``, ``swap_linear`` and ``flash_attention`` held against their
   plain PyTorch versions on the card at every shape the paths launch,
   plus odd and ragged shapes, the bitwise checks (rows independent of
   the batch, repeated calls equal), and timed at the main paths' shapes
   beside their plain version (one call: it is no yardstick), a library
   call where one computes the same function, and the card's bound;
   ``swap_linear_q`` at every launch shape of phases 9 and 11-13's
   int8-lazy arms in int8 and int4 too (llama4's head at N 202,048, whose
   last 64 columns a tile masks, held there alone as well), and of phase
   20's int4 granite-20b, each call's rows bitwise its 1-row calls;
   ``paged_attention`` at
   h2o-danube's hd 120 (32 / 8 heads) and granite-20b's 48 / 1 heads of
   128, fp32 and bf16, ragged, with and without the window, and their
   4,100-token rows alone == beside others;
   then ``swap_linear`` and ``flash_attention`` under autograd (their
   ``autograd.Function``s) against autograd through their plain versions
   at phase 15's shapes and ``flash_attention`` at phase 17's (h2o-danube's
   1 x 4,352 under its window too), in fp32 and bf16;
3. the swapped slice: qwen2.5-3b at its published widths with the depth
   cut from 36 to 4 layers and random weights from a seed; a swapped
   prefill of 4 requests x 128 tokens on the mmap store and on the
   quantized store (int8 lazy, int4 lazy, int8 eager), each under a budget
   below the store's resident bytes, checked against the unswapped
   forward; then greedy decode of 2 requests x 4 new tokens after
   4-token prompts on int8 lazy;
4. paged continuous-batching decode at the published widths: (A) the
   same qwen2.5-3b in float32 on mmap, 6 requests under a page pool small
   enough to preempt, every request's tokens held to a solo in-memory run;
   (B) the same workload in bf16 on int8 lazy, its step trace held to
   (A)'s and one batched step's logits to the in-memory model on the
   round-tripped weights; (C) gemma2-9b in bf16, depth cut 42 -> 2 (one
   local, one global layer), int8 lazy, a 4,200-token prompt beside a
   24-token one so the local layer's 4,096-token window skips pages;
5. rwkv6-3b (Finch) at its published widths, depth cut 32 -> 4, random
   weights from a seed: a swapped prefill of 2 x 512 tokens on mmap
   (asked for as ``quant``, which this quant-ineligible model resolves to
   mmap) in float32 and in bf16, and of one 512-token prompt in float32
   (40 rows, which ``wkv6`` splits into two column groups a row), each
   bitwise equal to the unswapped forward and launching ``wkv6`` once per
   layer; then weight-streaming
   greedy decode (2 prompts x 16 tokens, 4 new) against the in-memory
   engine on the card;
6. gemma2-9b at its published widths in bf16, depth cut 42 -> 2 (one
   local, one global layer), the same weights as (C): a full-precision
   swapped prefill of one 4,200-token prompt on the mmap store, bitwise
   equal to the unswapped forward, with ``flash_attention`` once per layer
   (window 4096 on layer 0, none on layer 1) and ``swap_linear`` seven
   times per layer;
7. the paper's multi-DNN scenario as the workstation profile serves it:
   qwen2.5-3b (phase 3's) and gemma2-9b (depth cut 42 -> 6) in one
   ``MultiModelRuntime`` on the ``directio`` store (its files under
   ``build/phase7``) under one budget, 1.1x the smallest on a 0.1 GB grid
   at which both plan with 2 executors and below the stores' resident
   bytes; one ``ServingScheduler`` with 2 executors serves 4 prefills per
   tenant at priorities 1 and 8 (a priority-8 request arrives while a
   priority-1 pass runs, and preempts it) and a paged generation of 2
   qwen prompts. Every prefill equals its unswapped forward bitwise, the
   generated tokens those served alone, the ledger stays under the
   budget and drains to the cache; then io, corrupt, torn and latency
   faults scripted on gemma's store (``faulty`` around it) are retried
   to the same logits, a fault past the retries fails its request with
   no ledger bytes left while qwen beside it stays exact; last one qwen
   pass in each ablation arm (``copy_in`` over rawio with the dispatch
   copy, ``dummy_asm``) equals the snet pass and peaks at 3x / 2x;
8. the mcu profile through the port's entry points, on phase 3's
   qwen2.5-3b cut to its first 2 layers (its embedding and tied head
   unchanged): the config resolved through its layers (the CLI layer sets
   only the budget and ``reduce``); ``calibrate_model`` by hand (9
   swapped passes on mmap at 2 x 16, one round-tripped unit a pass); the
   budget 1.1x the smallest feasible on a 0.1 GB grid over the mixed
   store's resident units and below their sum; ``MultiModelRuntime
   .from_config`` + ``add_model``, whose own calibration must give the
   same plan JSON byte for byte; the profile's workload through
   ``ServingScheduler.from_config`` (each result == a swapped pass
   bitwise, within 2e-2 of the in-memory model on the plan's round-trip,
   realized rel-L2 <= the 2e-2 target, bytes by precision summing to the
   bytes swapped, ledger peak <= budget); the same runtime and scheduler
   behind the HTTP control plane (health, models, two submits == the
   in-process forward bitwise, a cancel, /metrics == the scheduler's
   counters, a clean shutdown); where the 2e-2 plan has one quantized
   width, the plan of a further target of the same profile with both;
9. llama4-scout-17b-a16e's MoE stack at its published widths (16 routed
   experts top-1 of 8192 plus a shared one, vocab 202,048), depth cut
   48 -> 4 (layers 0-2 block-local in 8,192-token chunks, layer 3
   global), seed-0 weights drawn on the card: one 43.5 GB mmap store
   (under ``build/phase9``, removed after) under a budget 1.1x the
   smallest at which the planner packs it at m = 2 (the store over the
   budget printed, above 2), a warm and a timed swapped prefill of one
   8,704-token prompt, bitwise equal to the unswapped forward, with
   ``flash_attention`` at chunk 8192 on layers 0-2 and none on layer 3
   and ``swap_linear`` seven times a layer; then two paged generations
   (prompts of 40 and 100 tokens, 2 new each) through the batch engine
   on the same store and budget, equal to each request served alone; last
   the int8-lazy arm (the host's available memory printed first): the
   same params cut to layers 0 and 1 (both block-local), one first pass
   of the 8,704-token prompt with ``swap_linear_q`` at each layer's wq,
   wk, wv, wo and the shared expert's three and at the head (N 202,048),
   15 in all, and ``flash_attention`` once a layer at chunk 8192, the
   routed stacks, the router and the embedding widened on the host; its
   checks those of 11-13's arms below, no comparison with the fp logits
   (quantized llama4 strays from fp in both packages);
10. the paper's conv workloads (``models/vision.py``'s sims at their own
   layer lists, batch 4, random weights from a seed) through
   ``SwappedSequential``: the self-driving fleet (yolo, fcn, vgg, resnet)
   under one ``MultiDNNScheduler`` budget, 0.72 of its demand, on mmap
   with one shared ledger, each model bitwise its in-memory forward and
   its ledger peak within its budget; again after ``adapt`` shrinks the
   budget; the rsu and uav fleets once; vgg on rawio (the dispatch copy),
   eager int8 (``dequant_int8``) and fused int8 / int4 (its fc layers
   through ``swap_linear_q``), each quant arm within 1e-4 of its
   round-tripped forward (its distance from the fp forward printed); DCha (4 channel groups, within 1e-5) and TPrg
   (its cosine fidelity) in memory; ``calibrate_sequential`` twice (one
   plan JSON) and a mixed store under that plan; the 12 x 1280 fc stack
   at batch 64 on mmap (bitwise) and fused int8 / int4 (within 1e-4),
   each planned with ``DelayModel.calibrated`` on its store under half
   its resident bytes;
11. deepseek-v2-lite-16b's Multi-head Latent Attention and MoE stack at
   its published widths (MLA kv_lora_rank 512, q / k head dim 128 + 64,
   v 128; 64 routed experts top-6 of 1408 plus a shared one of 2816, vocab
   102,400), depth cut 27 -> 6, seed-0 fp32 weights drawn on the card:
   one 15.7 GB mmap store (under
   ``build/phase11``, removed after) at least 2.32x over a budget 1.1x
   the smallest at which the planner packs it at m = 2; a warm and a timed
   swapped prefill of one 4,096-token prompt, bitwise equal to the
   unswapped forward, with ``flash_attention`` once a layer at q, k 192 /
   v 128 and ``swap_linear`` five times a layer; then ``decode_loop`` (2
   prompts of 4 tokens, 2 new) on the same store and budget, each step's
   logits bitwise those of ``Model.decode_step`` on the card with the
   store's fp32 head (the in-memory bf16 head's gap printed), and the
   latent cache's bytes beside a GQA cache's; then ``ServingEngine`` on
   the same prompts in fp32, where its first new token's logits
   (``flash_attention`` over the prompt) must lie within 1e-5 of
   ``Model.decode_step``'s absorbed decode, and in bf16, where they must
   lie within 5e-2 of the fp32 engine's for each prompt whose last token
   is routed alike at every layer (each layer's flips printed; the
   absorbed decode's bf16 gap printed); last the int8-lazy arm
   (``quant_arm``): the same params cut to 2 layers on the int8 lazy
   store (``build/phase11/int8-lazy``), one first pass of the prompt with
   ``swap_linear_q`` at wq, wo and the shared expert's three a layer and
   the head (11), the routed stacks and the latent projections widened on
   the host;
12. zamba2-7b's hybrid stack at its published widths (Mamba2 d_state 64,
   head_dim 64, expand 2, chunk 128; one shared attention block of 32
   heads of 112 and d_ff 14,336; vocab 32,000, tied), depth cut 81 -> 18
   (15 Mamba2 layers, the shared block at 5, 11 and 17), seed-0 fp32
   weights drawn on the card: one 6.4 GB mmap store (under
   ``build/phase12``, removed after) holding the shared block once, at
   least 2.32x over its ledger budget: the plan budget 1.1x the smallest
   at which the planner packs it at m = 2, the ledger's that plus the
   pinned shared unit's bytes. A warm and a timed swapped prefill of one
   4,096-token prompt, bitwise equal to the unswapped forward, with
   ``flash_attention`` once a shared occurrence at hd 112 (the tensor
   cores at the padded width 128) and ``swap_linear`` at the shared
   block's 7 linears and each Mamba2 ``wo``; the shared unit read from
   the store at most once a pass, its later occurrences cache hits, only
   its bytes charged after the pass; then ``decode_loop`` (2 prompts of 4 tokens, 2 new), each step's
   logits bitwise ``Model.decode_step``'s on the card, and the state bytes
   a sequence beside the shared block's K/V a token; then
   ``ServingEngine`` on the same prompts in fp32, its first new token's
   logits within 1e-4 of ``Model.decode_step`` fed the prompt token by
   token, and in bf16 (its gap to the fp32 engine printed); last the
   int8-lazy arm: the same params cut to 6 layers (five Mamba2, the shared
   block at 5, pinned as a lazy quantized unit, the ledger given its lazy
   resident bytes), one first pass with ``swap_linear_q`` at each Mamba2
   ``wo``, the shared block's 7 and the tied head (13);
13. qwen2-vl-72b's M-RoPE and vision-embedding frontend at its published
   widths (64 / 8 heads of 128 with q / k / v bias, d_ff 29,568, vocab
   152,064 untied, M-RoPE sections (16, 24, 24), 1,024 vision tokens at
   d_frontend 1,280), depth cut 80 -> 4, seed-0 fp32 weights drawn on the
   card: one 24 GB mmap store (under ``build/phase13``, removed after) at
   least 2.32x over a budget 1.1x the smallest at which the planner packs
   it at m = 2; a warm and a timed swapped prefill of one 2,048-token
   prompt (1,024 seeded vision embeddings through the frontend, then 1,024
   text tokens; positions [1, 2048, 3] built here: the temporal stream the
   index, h and w the 32 x 32 patch grid over the vision tokens), bitwise
   equal to the unswapped forward, with ``flash_attention`` once a layer
   and ``swap_linear`` seven times a layer; the vision tokens' h and w
   streams swapped must move the logits; then two text-only paged
   generations (prompts of 40 and 100 tokens, 2 new each, [B, 1, 3]
   positions a step) equal to each request served alone; last the
   int8-lazy arm: the same params cut to 1 layer, one first pass with
   ``swap_linear_q`` at the biased q / k / v (K 8,192), wo, the MLP (N
   29,568, its wo at K 29,568) and the head (N 152,064), 8 in all, the
   embedding and the frontend widened on the host. Each arm of 11-13
   plans 1.1x the smallest budget on a 0.01 GB grid at which the planner
   packs its store at m = 2, below the store's resident bytes and in at
   least 3 blocks; its logits must equal ``forward_unswapped`` over the
   store's own lazy leaves bitwise and lie within 2e-2 of that forward
   with each quantized linear through ``swap_linear_q``'s plain version
   (the weights widened to fp32 whole; deepseek: where each layer routes
   the last token alike, the flips printed); ``swap_linear`` and
   ``dequant_int8`` launch 0 times, ``flash_attention`` once an
   attention layer;
14. hubert-xlarge's bidirectional audio encoder at its published widths
   and full depth (48 layers of 16 / 16 heads of 80, a GELU MLP of 5,120,
   vocab 504, d_frontend 512, no RoPE), seed-1 fp32 weights: one 3.8 GB
   mmap store (under ``build/phase14``, removed after) under 1.1x the
   smallest budget on a 0.01 GB grid at which the planner packs it at
   m = 2 (the floor and the plan from one planner over the store's unit
   table); a warm and a timed swapped forward of 2 x 1,500 seeded frame
   features, bitwise equal to the unswapped forward, with
   ``flash_attention`` once a layer without a causal mask (the tensor
   cores at hd 80, padded to 128) and ``swap_linear`` six times a layer;
   finite last-position logits. No decode, paged path or quant store: an
   encoder that opts out of quantized units;
15. qwen2.5-3b trained at its published widths through
   ``repro_torch.launch.train``'s loop: (a) in fp32 at depth 2, one batch
   of 8 x 256 from ``SyntheticLM``, the loss and every gradient leaf
   through ``swap_linear`` and ``flash_attention`` (their
   ``autograd.Function``s) against autograd through their plain versions
   on the card (the loss within 1e-5 relative, each leaf within 1e-4 of
   its largest |g|); (b) in bf16 at phase 3's depth of 4, 20 steps at the
   reference launcher's batch 8 and seq 256 and its schedule, every loss
   finite and the last below the first; (c) per step and layer 15
   ``swap_linear`` launches (forward, the checkpointed layer's recompute,
   wi0's act="none" recompute) and 2 ``flash_attention``, and no other
   kernel; (d) the checkpoint restored onto the card bitwise; (e) step ms,
   tok/s and peak device memory;
16. rwkv6-3b trained at its published widths (40 WKV heads of 64, d_ff
   8,960, vocab 65,536 untied) through the same loop: (a) in fp32 at
   depth 2 the loss and every gradient leaf through ``wkv6`` (``WKV6Fn``)
   and ``swap_linear`` against the plain versions, as phase 15 (a); (b)
   in bf16 at phase 5's depth of 4, 20 steps, every loss finite and the
   last below the first; (c) per step and layer 2 ``wkv6`` launches at BH
   320 (forward, remat) and 2 ``swap_linear`` (the time-mix ``wo``); (d)
   step ms, tok/s and peak device memory;
17. one training run per family that one card holds at published widths:
   gemma2-9b at 2 layers (one local, one global), deepseek-v2-lite-16b at
   2, zamba2-7b at 12 (the shared block at 5 and 11, its gradient summed
   over both), hubert-xlarge at 4 (8 x 256 masked frames), h2o-danube-3-4b
   at 2 (32 / 8 heads of 120, a 4,096 window) and granite-20b at 2 (48 / 1
   heads of 128, a GELU MLP): each the fp32 identity of phase 15 (a) at
   that depth (danube's on one sequence of 4,352 tokens, so that the
   window cuts the first keys of each layer's last 256 queries; granite's
   ``flash_attention`` in three-pass TF32 at G 48), 3 bf16 steps of the
   loop, all finite, the launches each step implies (``train_launches``),
   step ms, tok/s and peak device memory;
18. the dry run (``repro_torch.launch.dryrun``) on the card's host CPU:
   qwen2.5-3b x decode_32k at min depth through the CLI in a subprocess,
   meanwhile train_4k cut to 2 layers in this process on the single-pod
   (16, 16) and the multi-pod (2, 16, 16) mesh, and each perf variant at
   min depth: ``--flash-decode`` on qwen's decode_32k, ``--windowed-kv``
   on h2o-danube-3-4b's (its cache 1/8 of the full one's) and
   ``--seq-parallel`` on qwen's train_4k; each one step traced on
   DTensors of fake tensors over a fake process group of 256 / 512 ranks
   (the plain PyTorch versions: no kernel launches, checked); every row
   ``ok``, its argument bytes those the sharding specs give, the model's
   switches reset after it, and its memory, counted and analytic FLOPs,
   collectives, trace seconds and ``torch.__version__`` printed;
19. the mesh path on the card: a one-rank NCCL group on loopback and the
   (1, 1) ("data", "model") CUDA mesh. (a) deepseek-v2-lite-16b at its
   published widths, depth 27 -> 2 as in phase 17, params and batch placed
   by ``train_state_specs`` / ``input_pspecs``: the fp32 loss and every
   gradient leaf of the mesh step equal to the unsharded step's (phase
   17's tolerances), ``swap_linear`` and ``flash_attention`` launched as
   ``train_launches`` says (each on local tensors through ``local_map``;
   the MoE's expert-parallel dispatch over NCCL), then 3 bf16 steps of the
   port's train step on the mesh, all finite, counted as the main path;
   (b) h2o-danube-3-4b at its published widths (window 4,096), depth 24
   -> 2, fp32: a 4,000-token prompt, then 200 decode steps on the
   ring-buffer cache (``WINDOWED_KV_CACHE``) teacher-forced by the full
   4,200-slot cache's tokens, every step's logits within 1e-4 of that
   step's largest on the full cache (the worst printed); (c) one decode
   step of the same model with ``SHARDED_DECODE_AXIS`` on the mesh equal
   to the unsharded step within 1e-5; then (b)'s model paged: the ring's
   4,000-token prompt and two of 40 tokens (100, 4 and 4 new tokens)
   through the batch engine on a swapped fp32 mmap store (0.9x its
   resident bytes, 3 blocks) with pages of 16 tokens, the long request
   decoding to 4,099 tokens, past its window; every request's tokens equal
   it served alone in memory, and ``paged_attention`` launched once a
   layer a decode step, at hd 120 (the kernel's row width 128), 32 / 8
   heads, window 4096;
20. granite-20b at its published widths (d_model 6144, 48 query heads of
   128 on one KV head, a GELU MLP of 24,576, vocab 49,152), depth 52 -> 2,
   seed-0 weights drawn on the card: its ``swap_precision``'s int4 lazy
   store (under ``build/phase20``, removed after) under 1.1x the smallest
   budget on a 0.01 GB grid at which the planner packs it at m = 2, below
   its resident bytes in 3 blocks; one first pass of a 512-token prompt
   with phases 11-13's identities (bitwise the forward over the store's
   lazy leaves, within 2e-2 of it through B1's plain version, the device
   bytes the ledger's), ``swap_linear_q`` 13 times; then on the same store
   and budget three paged bf16 generations (512-token prompts, 2 new
   tokens) equal to each served alone, ``paged_attention`` at 48 / 1 heads
   (six head groups a KV head).

Every full-precision linear of phases 3 to 17 and 19 runs ``swap_linear`` and
every prefill's (and every training step's) attention
``flash_attention``; rwkv6's recurrence ``wkv6``; the quantized stores'
lazy linears run ``swap_linear_q``; every paged decode step
``paged_attention``. Every shape phases 7 to 20 launch a kernel at
is one of phase 2's rows, held against the plain version there and timed;
the script checks it. The exceptions are the fp32 gradient identities of
phases 15-17 and 19 (a), which run before each counted run: their fp32
shapes are held in phase 2 only through the Functions' gradient check
(``check_train_grads``), not timed (h2o-danube's and granite-20b's
``flash_attention`` timed too); phase 19 (b)'s ring and (c), checks of the
decode forms against the full-cache and unsharded decodes; and the
in-memory runs each paged request is held to. The phases' seconds are
printed together before the total.

Before the last line it prints one ``{"kernels": [...]}`` JSON line: per
kernel and main-path shape, the launches the paths made there, the error
against the plain version, and the times. The last line is
``{"ok": true, "device": {...}}``. Any failed check raises, and the script
then exits non-zero without that line; without CUDA it exits 2 at once.
"""
from __future__ import annotations

import os

# deterministic cuBLAS (bitwise swapped == unswapped): set before torch
# initialises CUDA
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import dataclasses  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import time  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
PEAK_OPS = {"bfloat16": 989e12,    # bf16 tensor cores, dense
            "float32": 67e12,      # fp32 outside the tensor cores
            "tf32": 495e12}        # TF32 tensor cores, dense
TF32_PASSES = 3                    # the fp32 routes' TF32 products a product
TOL = {"float32": 1e-5, "bfloat16": 2e-2}   # max |err| / max |plain|

# Device ms of the kernels at the timed shapes in their earlier design,
# recorded from this script's kernels line on an NVIDIA H100 80GB HBM3 at
# 700.00 W (PERF.md): swap_linear_q and swap_linear before their redesign
# (one 64 x 64 output tile per block on the CUDA cores in fp32, no
# split-K), flash_attention as first ported (fp32 on the CUDA cores, 8
# threads a row), paged_attention before flash-decoding (one block per
# sequence and KV head), wkv6 as first ported (one block of 4 hd threads
# per row, the chunks one after another on the CUDA cores), and
# flash_attention at bf16 hd 80 and 112 on the CUDA cores before those
# head dims took the tensor cores (PR 23 call 2, PR 24 call 4, PR 26 call
# 2), and the fp32 rows of swap_linear and flash_attention on the CUDA
# cores before they took the tensor cores in three-pass TF32 (PERF.md's
# per-shape table, in brackets, names each run). Printed
# beside a timing row's human-readable line for comparison, marked as
# recorded; never part of the kernels line, which holds only what this
# run measured.
EARLIER_MS = {
    ('swap_linear_q',
     'M=512 K=2048 N=2048 int8 x=bfloat16 act=none'): 0.3015,
    ('swap_linear_q',
     'M=2 K=2048 N=2048 int8 x=bfloat16 act=none'): 0.2016,
    ('swap_linear_q',
     'M=512 K=2048 N=256 int8 x=bfloat16 act=none'): 0.2308,
    ('swap_linear_q',
     'M=2 K=2048 N=256 int8 x=bfloat16 act=none'): 0.2001,
    ('swap_linear_q',
     'M=512 K=2048 N=11008 int8 x=bfloat16 act=silu'): 1.3431,
    ('swap_linear_q',
     'M=2 K=2048 N=11008 int8 x=bfloat16 act=silu'): 0.2767,
    ('swap_linear_q',
     'M=512 K=2048 N=11008 int8 x=bfloat16 act=none'): 1.3458,
    ('swap_linear_q',
     'M=2 K=2048 N=11008 int8 x=bfloat16 act=none'): 0.2800,
    ('swap_linear_q',
     'M=512 K=11008 N=2048 int8 x=bfloat16 act=none'): 1.6980,
    ('swap_linear_q',
     'M=2 K=11008 N=2048 int8 x=bfloat16 act=none'): 1.0623,
    ('swap_linear_q',
     'M=4 K=2048 N=151936 int8 x=float32 act=none'): 1.7777,
    ('swap_linear_q',
     'M=2 K=2048 N=151936 int8 x=float32 act=none'): 1.7804,
    ('swap_linear_q',
     'M=512 K=2048 N=2048 int4 x=bfloat16 act=none'): 0.3135,
    ('swap_linear_q',
     'M=512 K=2048 N=256 int4 x=bfloat16 act=none'): 0.2391,
    ('swap_linear_q',
     'M=512 K=2048 N=11008 int4 x=bfloat16 act=silu'): 1.4151,
    ('swap_linear_q',
     'M=512 K=2048 N=11008 int4 x=bfloat16 act=none'): 1.3917,
    ('swap_linear_q',
     'M=512 K=11008 N=2048 int4 x=bfloat16 act=none'): 1.6976,
    ('swap_linear_q',
     'M=4 K=2048 N=151936 int4 x=float32 act=none'): 1.9787,
    ('swap_linear',
     'qwen2.5-3b M=512 K=2048 N=2048 bfloat16 act=none +bias'): 0.2923,
    ('swap_linear',
     'qwen2.5-3b M=512 K=2048 N=256 bfloat16 act=none +bias'): 0.2294,
    ('swap_linear',
     'qwen2.5-3b M=512 K=2048 N=11008 bfloat16 act=silu'): 1.4085,
    ('swap_linear',
     'qwen2.5-3b M=512 K=2048 N=11008 bfloat16 act=none'): 1.3811,
    ('swap_linear',
     'qwen2.5-3b M=512 K=11008 N=2048 bfloat16 act=none'): 1.6905,
    ('swap_linear',
     'qwen2.5-3b M=2 K=2048 N=2048 float32 act=none +bias'): 0.0135,
    ('swap_linear',
     'qwen2.5-3b M=2 K=2048 N=256 float32 act=none +bias'): 0.0131,
    ('swap_linear',
     'qwen2.5-3b M=2 K=2048 N=11008 float32 act=silu'): 0.0680,
    ('swap_linear',
     'qwen2.5-3b M=2 K=2048 N=11008 float32 act=none'): 0.0679,
    ('swap_linear',
     'qwen2.5-3b M=2 K=11008 N=2048 float32 act=none'): 0.0493,
    ('swap_linear',
     'gemma2-9b M=4200 K=3584 N=4096 bfloat16 act=none'): 6.6732,
    ('swap_linear',
     'gemma2-9b M=4200 K=3584 N=2048 bfloat16 act=none'): 3.4133,
    ('swap_linear',
     'gemma2-9b M=4200 K=4096 N=3584 bfloat16 act=none'): 6.6789,
    ('swap_linear',
     'gemma2-9b M=4200 K=3584 N=14336 bfloat16 act=gelu'): 23.7566,
    ('swap_linear',
     'gemma2-9b M=4200 K=3584 N=14336 bfloat16 act=none'): 23.4063,
    ('swap_linear',
     'gemma2-9b M=4200 K=14336 N=3584 bfloat16 act=none'): 23.8633,
    ('swap_linear',
     'rwkv6-3b wo M=1024 K=2560 N=2560 float32 act=none'): 0.4697,
    ('paged_attention', 'qwen2.5-3b fp32 B=4 seq_lens=[38, 65, 101, 130] '
     'window=None softcap=None'): 0.0346,
    ('paged_attention', 'qwen2.5-3b bf16 B=1 seq_lens=[208] window=None '
     'softcap=None'): 0.0507,
    ('paged_attention', 'qwen2.5-3b bf16 B=4 seq_lens=[38, 65, 101, 130] '
     'window=None softcap=None'): 0.0357,
    ('paged_attention', 'gemma2-9b bf16 B=2 local seq_lens=[4201, 25] '
     'window=4096 softcap=50.0'): 0.5842,
    ('paged_attention', 'gemma2-9b bf16 B=2 global seq_lens=[4201, 25] '
     'window=None softcap=50.0'): 0.5976,
    ('flash_attention', 'qwen2.5-3b prefill B=4 S=128 16/2 heads hd=128 '
     'bfloat16 window=None softcap=None'): 0.0677,
    **{('flash_attention', f'qwen2.5-3b admission B=1 S={S} 16/2 heads '
        f'hd=128 {dname} window=None softcap=None'): ms
       for dname, times in (
           ("float32", (0.0107, 0.0132, 0.0155, 0.0226, 0.0273, 0.0384)),
           ("bfloat16", (0.0139, 0.0244, 0.0476, 0.0484, 0.0598, 0.0856)))
       for S, ms in zip((17, 37, 64, 100, 129, 200), times)},
    ('flash_attention', 'gemma2-9b prefill B=1 S=4200 16/8 heads hd=256 '
     'bfloat16 window=4096 softcap=50.0'): 32.6881,
    ('flash_attention', 'gemma2-9b prefill B=1 S=4200 16/8 heads hd=256 '
     'bfloat16 window=None softcap=50.0'): 32.6153,
    ('flash_attention', 'gemma2-9b prefill B=1 S=24 16/8 heads hd=256 '
     'bfloat16 window=4096 softcap=50.0'): 0.0365,
    ('flash_attention', 'gemma2-9b prefill B=1 S=24 16/8 heads hd=256 '
     'bfloat16 window=None softcap=50.0'): 0.0363,
    ('flash_attention', 'zamba2-7b prefill B=1 S=4096 32/32 heads hd=112 '
     'bfloat16 window=None softcap=None'): 7.0358,
    ('flash_attention', 'zamba2-7b engine B=2 S=4 32/32 heads hd=112 '
     'bfloat16 window=None softcap=None'): 0.0091,
    ('flash_attention', 'hubert-xlarge encoder B=2 S=1500 16/16 heads hd=80 '
     'bfloat16 window=None softcap=None non-causal'): 1.8935,
    ('flash_attention', 'zamba2-7b train B=8 S=256 32/32 heads hd=112 '
     'bfloat16 window=None softcap=None'): 0.3517,
    ('flash_attention', 'hubert-xlarge train B=8 S=256 16/16 heads hd=80 '
     'bfloat16 window=None softcap=None non-causal'): 0.2423,
    **{('swap_linear', f'h2o-danube-3-4b M={M} K={K} N={N} float32 '
        f'act={act}'): ms
       for M, times in ((4000, (3.7534, 1.0637, 9.8763, 9.8551, 9.8996)),
                        (40, (0.0726, 0.0274, 0.2620, 0.2610, 0.1793)),
                        (3, (0.0364, 0.0138, 0.1241, 0.1240, 0.0865)),
                        (1, (0.0362, 0.0138, 0.1243, 0.1240, 0.0861)))
       for (K, N, act), ms in zip(((3840, 3840, "none"), (3840, 960, "none"),
                                   (3840, 10240, "silu"),
                                   (3840, 10240, "none"),
                                   (10240, 3840, "none")), times)},
    **{('swap_linear', f'{label} M={M} K={K} N={N} float32 act=none +bias'):
       ms for label, M, K, N, ms in (
           ("vgg_sim fc", 4, 256, 4096, 0.0111),
           ("vgg_sim fc", 4, 4096, 1024, 0.0140),
           ("vgg_sim fc", 4, 1024, 100, 0.0130),
           ("resnet_sim fc", 4, 256, 100, 0.0111),
           ("vgg_sim TPrg fc", 4, 79, 4096, 0.0086),
           ("fc stack 12 x 1280", 64, 1280, 1280, 0.0195))},
    ('flash_attention', 'h2o-danube admission B=1 S=4000 32/8 heads hd=120 '
     'float32 window=4096 softcap=None'): 8.7495,
    ('flash_attention', 'h2o-danube admission B=1 S=40 32/8 heads hd=120 '
     'float32 window=4096 softcap=None'): 0.0145,
    ('flash_attention', 'h2o-danube train identity B=1 S=4352 32/8 heads '
     'hd=120 float32 window=4096 softcap=None'): 10.3063,
    ('flash_attention', 'granite-20b train identity B=8 S=256 48/1 heads '
     'hd=128 float32 window=None softcap=None'): 0.5568,
    ('wkv6', 'BH=80 S=512 hd=64 float32, zero initial state'): 0.3428,
    ('wkv6', 'BH=80 S=16 hd=64 float32, zero initial state'): 0.0132,
}
SLEEP_CYCLES_PER_S = 2.0e9         # >= the H100's SM clock: holds long enough
HOST_STAGE_BYTES = 1 << 28         # pinned buffer of host_copy

N_LAYERS = 4
BATCH, PROMPT = 4, 128
DECODE_BATCH, DECODE_PROMPT, DECODE_NEW = 2, 4, 4
BUDGET_FRACTION = 0.9              # of each store's resident bytes

# phase 4: the paged workload. 23 pages of 16 tokens force one preemption
# at these token counts (the trace depends on token counts and pages
# only, so the number was found on the CPU with the reduced config)
PAGED_PROMPTS = [37, 64, 100, 129, 17, 200]
PAGED_NEW = [2, 6, 3, 5, 4, 8]
PAGED_MAX_BATCH, PAGE_TOKENS, PAGED_MAX_PAGES = 4, 16, 23
GEMMA_LAYERS = 2                   # layer 0 local (window 4096), 1 global
GEMMA_PROMPTS, GEMMA_NEW = [4200, 24], [3, 3]
GEMMA_MAX_PAGES = 270              # 263 + 2 pages live at the first step

# phase 6: gemma2-9b full-precision swapped prefill
GEMMA_PREFILL = 4200

# phase 5: rwkv6-3b
RWKV_LAYERS = 4
RWKV_BATCH, RWKV_PROMPT = 2, 512
RWKV_DECODE_PROMPT, RWKV_DECODE_NEW = 16, 4

# phase 7: the workstation profile's runtime settings. gemma2-9b is cut to
# 6 layers here, not phase 6's 2: with 2 executors, cache and KV reserves
# of 0.2 each, the budget must give each executor's pipeline 1 / 0.95 of
# gemma's 3.67 GB embedding unit (12.9 GB in all), more than the 12.65 GB
# the two stores hold at 2 layers; at 6 they hold 15.8 GB, so the budget
# stays below the tenants' resident bytes
P7_GEMMA_LAYERS = 6
P7_PROMPT, P7_REQUESTS = 32, 4         # prefill requests per tenant
P7_GEN_PROMPTS, P7_GEN_NEW = 2, 4      # qwen's paged generation
P7_RUNTIME = dict(executors=2, prefetch_depth=3, cache_frac=0.2,
                  kv_frac=0.2, page_tokens=16, max_batch=8, delta=0.05)
P7_GRID = 10 ** 8                      # budget search step, 0.1 GB
P7_BUDGET_OVER_FLOOR = 1.1
P7_WORKDIR = ROOT / "build" / "phase7"

# phase 8: the mcu profile's workload (requests x prompt_len, which is also
# the calibration batch: calibrate.CALIB_BATCH x CALIB_SEQ) on phase 3's
# qwen2.5-3b; the budget from the calibrated plan as phase 7 finds its own
P8_BATCH, P8_SEQ = 2, 16
# 2 of phase 3's 4 layers: the calibration's passes (1 + 2 a unit) and
# each pass's bytes shrink; the widths, so the kernel shapes, stay
P8_LAYERS = 2
P8_GRID = 10 ** 8                      # budget search step, 0.1 GB
P8_BUDGET_OVER_FLOOR = 1.1
P8_WORKDIR = ROOT / "build" / "phase8"

# phase 9: llama4-scout-17b-a16e at its published widths, depth cut 48 -> 4
# (layers 0-2 attend block-locally in 8,192-token chunks, layer 3
# globally); one 8,704-token prompt (8192 + 512), so the local layers'
# chunk cuts it; the budget 1.1x the smallest on a 0.1 GB grid at which
# the planner packs the units at the paper's m = 2; two paged generations
LLAMA_LAYERS = 4
LLAMA_PROMPT, LLAMA_CHUNK = 8704, 8192
LLAMA_SCALE = 128 ** -0.5
# 2 new tokens each: one batched decode step of 43.5 GB, which keeps the
# smoke inside its time limit
LLAMA_PAGED_PROMPTS, LLAMA_PAGED_NEW = [40, 100], 2
LLAMA_MAX_PAGES = 16                   # 3 + 7 pages live at the last step
P9_M = 2
P9_GRID = 10 ** 8                      # budget search step, 0.1 GB
P9_BUDGET_OVER_FLOOR = 1.1
P9_WORKDIR = ROOT / "build" / "phase9"

# phase 11: deepseek-v2-lite-16b at its published widths, depth cut 27 -> 6
# (every layer Multi-head Latent Attention + 64 routed experts top-6 and a
# shared expert): one 4,096-token prompt swapped under a budget found as
# phase 9 finds its own, the store at least 2.32x over it (the paper's low
# end);
# then weight-streaming decode and the in-memory engine on 2 x 4 tokens
DS_LAYERS = 6
DS_PROMPT = 4096
DS_SCALE = 192 ** -0.5                 # (qk_nope + qk_rope) ** -0.5
DS_BATCH, DS_DECODE_PROMPT, DS_DECODE_NEW = 2, 4, 2
DS_MIN_RATIO = 2.32
# the bf16 engine's first-token logits against the fp32 engine's, for a
# prompt whose last token is routed alike at every layer: each bf16 path of
# this 6-layer MoE stack lies about 3% of the largest logit from its fp32
# result (PERF.md), and a routing flip moves it far more
DS_BF16_TOL = 5e-2
P11_WORKDIR = ROOT / "build" / "phase11"

# phase 12: zamba2-7b at its published widths, depth cut 81 -> 18 (15
# Mamba2 layers, the shared attention block at positions 5, 11 and 17):
# one 4,096-token prompt (32 SSD chunks of 128) swapped under a plan
# budget found as phase 9 finds its own and a ledger budget of that plus
# the pinned shared unit's bytes (what ``MultiModelRuntime.block_budget``
# reserves; a lone model's planner does not), the store at least 2.32x
# over the ledger budget; then weight-streaming decode and the in-memory
# engine on 2 x 4 tokens
Z_LAYERS = 18
Z_PROMPT = 4096
Z_SCALE = 112 ** -0.5
Z_BATCH, Z_DECODE_PROMPT, Z_DECODE_NEW = 2, 4, 2
Z_MIN_RATIO = 2.32
# the fp32 engine's first-token logits (chunked SSD, flash_attention over
# the prompt) against the step-by-step decode: the reference's own chunked
# vs naive tolerance (tests/test_ssm_reference.py)
Z_ENGINE_TOL = 1e-4
P12_WORKDIR = ROOT / "build" / "phase12"

# phase 13: qwen2-vl-72b at its published widths, depth cut 80 -> 4: one
# 2,048-token prompt (1,024 vision tokens on a 32 x 32 patch grid, then
# 1,024 text tokens) swapped under a budget found as phase 9 finds its own,
# the store at least 2.32x over it; then two text-only paged generations
VL_LAYERS = 4
VL_VISION, VL_TEXT, VL_GRID = 1024, 1024, 32
VL_PROMPT = VL_VISION + VL_TEXT
VL_SCALE = 128 ** -0.5
VL_PAGED_PROMPTS, VL_PAGED_NEW = [40, 100], 2
VL_MAX_PAGES = 16                      # 3 + 7 pages live at the last step
VL_MIN_RATIO = 2.32
P13_WORKDIR = ROOT / "build" / "phase13"

# phases 9 and 11-13's int8-lazy arms (ROADMAP A10): each phase's own
# params cut to their first layers (embedding, frontend and head
# unchanged: no weight drawn twice), stored int8 lazy under the phase's
# build/phaseN, one swapped first pass of the phase's prompt under 1.1x
# the smallest budget on a 0.01 GB grid at which the planner packs the
# store at m = 2. The depths: llama4's layers 0 and 1 (block-local: their
# chunk cuts the 8,704-token prompt; at one layer the widened embedding
# and layer, 4.17 + 8.24 GB, set an m = 2 floor whose 1.1x lies above the
# 13.44 GB store); two MLA + MoE layers; five Mamba2 layers and the shared
# block (at 5); one dense layer. Each arm's host work (the quantizer at
# build, the widening of every leaf B1 cannot stream at each read:
# llama4's routed stacks and embedding, 5.05 G values) sets its cost, not
# its kernels
LLAMA_Q_LAYERS, DS_Q_LAYERS, Z_Q_LAYERS, VL_Q_LAYERS = 2, 2, 6, 1
ARM_GRID = 10 ** 7                     # budget search step, 0.01 GB
# the arm's logits (B1 over the int8 weights) against the same forward
# with B1's plain version (the weights widened to fp32, an fp32 matmul):
# phase 3's bound, bf16's tolerance
ARM_TOL = 2e-2

# phase 19 (b): h2o-danube-3-4b's paged decode on the ring's model (32 /
# 8 heads of 120, a 4,096-token window on every layer), in fp32: the
# ring's 4,000-token prompt beside two short ones through the batch engine
# on a swapped mmap store; the long one decodes 100 tokens, to 4,099, past
# its window (B3 then skips the tokens before it), the short ones retire
# together after 3 decode steps at batch 3
DN_PAGED_PROMPTS, DN_PAGED_NEW = [4000, 40, 40], [100, 4, 4]
DN_MAX_PAGES = 270                     # 257 + 3 + 3 pages live at most
DN_SCALE = 120 ** -0.5
# its decode's seq_lens at the first step (batch 3) and the last (alone)
DN_FIRST_STEP = [n + 1 for n in DN_PAGED_PROMPTS]
DN_LAST_STEP = [DN_PAGED_PROMPTS[0] + DN_PAGED_NEW[0] - 1]

# phase 20: granite-20b at its published widths, depth cut 52 -> 2 (d_model
# 6144, 48 query heads of 128 on one KV head, a GELU MLP of 24,576, vocab
# 49,152): its swap_precision's int4 lazy store, one first pass of one
# GR_PROMPT-token prompt with quant_arm's identities, then three paged bf16
# generations on the same store and budget, equal to each served alone
GR_LAYERS = 2
GR_PROMPT = 512
GR_PAGED_PROMPTS, GR_PAGED_NEW = [GR_PROMPT] * 3, 2
GR_MAX_PAGES = 3 * 33 + 3              # 33 pages a sequence at 514 tokens
GR_SCALE = 128 ** -0.5
P20_WORKDIR = ROOT / "build" / "phase20"

# phase 14: hubert-xlarge at its published widths and full depth (48
# layers): 2 x 1,500 frames, 30 s of audio at HuBERT's 20 ms frame rate,
# swapped under 1.1x the smallest budget on a 0.01 GB grid at which the
# planner packs it at m = 2
HB_BATCH, HB_FRAMES = 2, 1500
HB_SCALE = 80 ** -0.5
P14_GRID = 10 ** 7                     # budget search step, 0.01 GB
P14_WORKDIR = ROOT / "build" / "phase14"

# phase 10: the paper's conv workloads (``repro_torch.models.vision``'s
# sims at their own layer lists). The three fleets (model i's weights from
# seed i) are ``benchmarks/common.py::scenario_models``; the batch and the
# budget, 0.72 of a fleet's demand, ``benchmarks/bench_scenarios.py``'s;
# the adaptation ``examples/multi_dnn_scheduling.py``'s; the fc stack (12
# layers of 1280 at batch 64, seed 3) ``benchmarks/bench_overhead.py``'s
P10_SCENARIOS = {
    "self_driving": ["yolo", "fcn", "vgg", "resnet"],
    "rsu": ["yolo", "yolo", "resnet", "resnet", "vgg"],
    "uav": ["yolo", "resnet"],
}
P10_BATCH = 4
P10_BUDGET_FRAC = 0.72
P10_ADAPT = 0.65                       # x available, at least 1.05 x floors
P10_GROUPS = 4                         # DCha's channel groups
P10_FIDELITY = 2e-2                    # calibrate_sequential's target
# quantized swapped vs the in-memory forward on its round-tripped weights:
# the two differ only in summation order (swap_linear_q against a widened
# weight through swap_linear), so the bound sits far under the 2e-2 that
# quantization itself costs against the fp forward
P10_RTTOL = 1e-4
P10_STACK = (12, 1280, 64, 3)          # fc layers, width, batch, seed
P10_STACK_BUDGET = 0.5                 # x the store's resident bytes
P10_WORKDIR = ROOT / "build" / "phase10"

# phase 15: qwen2.5-3b trained at its published widths through
# ``launch/train.py``'s loop, phase 3's depth cut (36 -> 4), the reference
# launcher's batch and sequence and its schedule for 20 steps; the fp32
# identity through the kernels against the plain versions at depth 2. A
# step launches, per layer, swap_linear 15 times (7 linears forward, 7 in
# backward's recompute of the checkpointed layer, 1 act="none" recompute
# of wi0 for its silu's derivative) and flash_attention twice (forward and
# recompute); the fp32 lm head is a plain matmul, as in the reference
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 256, 20
TRAIN_ID_LAYERS = 2
TRAIN_GRAD_TOL = 1e-4                  # of each leaf's largest |g|
P15_WORKDIR = ROOT / "build" / "phase15"

# phase 16: rwkv6-3b trained the same way at phase 5's depth (32 -> 4): its
# time-mix hands B6 the batch's 8 x 40 head rows of 256 steps in fp32
RWKV_TRAIN_BH = TRAIN_BATCH * 40

# phase 17: (arch, depth) of each family whose training state (fp32
# params, gradients and two AdamW moments, 16 B a param) fits one card at
# published widths with its activations: gemma2-9b one local and one
# global layer, deepseek-v2-lite two MLA + MoE layers, zamba2-7b 10 Mamba2
# layers and the shared block at 5 and 11, hubert-xlarge 4 encoder layers,
# h2o-danube-3-4b two layers under its 4,096 window (0.56 G params),
# granite-20b two layers of 48 query heads on one KV head and a GELU MLP
# of 24,576 (1.36 G params, its untied head 0.30 G of them) (llama4-scout
# and qwen2-vl do not fit at one layer: their published-width step waits
# for the sharded path)
TRAIN_FAMILIES = [("gemma2-9b", 2), ("deepseek-v2-lite-16b", 2),
                  ("zamba2-7b", 12), ("hubert-xlarge", 4),
                  ("h2o-danube-3-4b", 2), ("granite-20b", 2)]
TRAIN_FAMILY_STEPS = 3
# the fp32 identity's (batch, seq) where it is not 8 x 256: danube's one
# sequence of 4,352 tokens, 256 past its 4,096 window, so that the window
# cuts the first keys of the last 256 queries of each layer (at 8 x 256 it
# masks nothing)
DN_TRAIN_ID = (1, 4096 + 256)
TRAIN_ID_SHAPE = {"h2o-danube-3-4b": DN_TRAIN_ID}


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


PHASE_SECONDS = {}                 # phase number -> wall seconds


def phase(name: str):
    """Context manager printing a phase's wall time (and keeping it in
    PHASE_SECONDS under the phase's number)."""
    class _P:
        def __enter__(self):
            self.t0 = time.perf_counter()
            print(f"== phase {name}", flush=True)

        def __exit__(self, *exc):
            if exc[0] is None:
                sec = time.perf_counter() - self.t0
                PHASE_SECONDS[name.split()[0]] = sec
                print(f"== phase {name}: {sec:.1f} s", flush=True)
    return _P()


def time_ms(torch, fn, target_s: float = 0.1) -> float:
    """Mean device time of ``fn`` over a run of launches (CUDA events).

    A sleep kernel holds the stream while the host enqueues the whole run,
    so the events time the device alone: without it a small kernel would
    be timed at Python's launch rate."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    one = time.perf_counter() - t0          # host + device, an upper bound
    reps = int(min(50, max(3, target_s / max(one, 1e-6))))
    hold_s = min(reps * one * 1.2 + 2e-3, 0.5)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(hold_s * SLEEP_CYCLES_PER_S))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def plain_call(torch, fn):
    """(result, device ms) of a plain version at a timed row: the call whose
    result the kernel is held to, timed on the host behind a synchronize,
    sizes a sleep that holds the stream while one more call is enqueued,
    and CUDA events time that call on the device. The plain version is no
    yardstick of speed (it repeats the kernel's arithmetic), so one timed
    call serves where ``time_ms`` would run dozens."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    one = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(one * 1.2 + 2e-3, 0.5) * SLEEP_CYCLES_PER_S))
    start.record()
    fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def gemm_ptxas(log: str) -> list:
    """One line per variant of the weight-streaming matmul core
    (``csrc/sm90_gemm.cuh``: weight kind, row tile; the three-pass TF32
    core by row tile) with what ``ptxas -v`` reported for it: registers,
    spill stores and loads."""
    import re
    names = {"0": "bf16", "8": "int8", "4": "int4"}
    out, cur = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = m.group(1)
            t = re.search(r"(tc_gemm|simt_gemm)ILi(\d+)E(?:Li(\d+)E)?", name)
            f = re.search(r"tf32_gemmILi(\d+)E", name)
            cur = f"tf32_gemm<{f.group(1)} rows>" if f else None
            if t:
                rows = int(t.group(3)) * (64 if t.group(1) == "tc_gemm" else 1)
                cur = f"{t.group(1)}<{names[t.group(2)]}, {rows} rows>"
            spill = ""
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            spill = f"spills {m.group(1)} / {m.group(2)} bytes"
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out.append(f"  ptxas {cur}: {m.group(1)} registers, {spill}")
            cur = None
    return out


ATTENTION_KERNELS = [
    ("fa_tc", r"fa_tcILi(\d+)ELi(\d+)ELi(\d+)E", "HD {0} HDV {1} k16 x {2}"),
    ("fa_tf32", r"fa_tf32ILi(\d+)ELi(\d+)E", "HD {0} HDV {1}"),
    ("fa_simt", r"fa_simtI(f|13__nv_bfloat16)Li(\d+)ELi(\d+)E",
     "{0} hd {1} dv {2}"),
    ("paged_attention_kernel",
     r"paged_attention_kernelI(f|13__nv_bfloat16)Li(\d+)ELi(\d+)E",
     "{0} hd {1} G {2}"),
    ("paged_combine", r"paged_combineI(f|13__nv_bfloat16)Li(\d+)E",
     "{0} hd {1}")]
WKV6_KERNELS = [("wkv6_ring", r"wkv6_ringI(f|13__nv_bfloat16)Li(\d+)E",
                 "{0} hd {1}")]


def kernel_ptxas(log: str, fams: list) -> list:
    """One line per kernel of ``fams`` (``ATTENTION_KERNELS``:
    ``csrc/flash_attention.cu``, ``csrc/paged_attention.cu``;
    ``WKV6_KERNELS``: ``csrc/wkv6.cu``) with what ``ptxas -v`` reported
    for each of its variants: registers / spill stores / spill loads
    (bytes)."""
    import re
    found = {f[0]: [] for f in fams}
    cur, spill = None, ""
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            cur = None
            for fam, pat, fmt in fams:
                t = re.search(pat, m.group(1))
                if t:
                    g = [("fp32" if x == "f" else "bf16" if "bfloat" in x
                          else x) for x in t.groups()]
                    cur = (fam, fmt.format(*g))
            spill = ""
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            spill = f"{m.group(1)}/{m.group(2)}"
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            found[cur[0]].append(f"{cur[1]}: {m.group(1)}/{spill}")
            cur = None
    return [f"  ptxas {fam} (registers/spill stores/spill loads): "
            + "; ".join(sorted(v)) for fam, v in found.items() if v]


def earlier(row) -> str:
    """The printed suffix with the earlier design's recorded time at a
    timing row's shape, if there is one (not measured in this run)."""
    e = EARLIER_MS.get((row["name"], row["shape"]))
    return "" if e is None else f" (earlier design, recorded: {e:.4f} ms)"


def rel_err(torch, got, want) -> tuple:
    d = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    return d, d / max(scale, 1e-30)


def bound(nbytes: float, ops: float, dname: str, route: str) -> dict:
    """A timing row's bound: the larger of its bytes over the card's memory
    rate and its operations over the peak of what computes them. On the
    three-pass TF32 route (``tf32x3``) an fp32 operation is three TF32
    ones on the tensor cores; ``fp32_bound_ms`` keeps the CUDA cores' fp32
    bound beside it (printed, not in the kernels line)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    if route == "tf32x3":
        t_ops = TF32_PASSES * ops / PEAK_OPS["tf32"] * 1e3
    else:
        t_ops = ops / PEAK_OPS[dname] * 1e3
    out = {"bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    if route == "tf32x3":
        out["fp32_bound_ms"] = max(t_bytes, ops / PEAK_OPS["float32"] * 1e3)
    return out


def bound_note(r) -> str:
    """The printed bound of a timing row, with the fp32 CUDA-core bound
    beside a three-pass TF32 row's."""
    fp32 = r.get("fp32_bound_ms")
    return (f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}"
            + ("" if fp32 is None else f"; three-pass TF32, fp32 CUDA-core "
               f"bound {fp32:.4f}") + ")")


def fp32_routes(by_shape, what: str, need=()) -> str:
    """Every fp32 swap_linear launch in ``by_shape`` (kernel -> launch key
    -> count) ran the three-pass TF32 core, and every fp32 flash_attention
    launch the kernel ``path`` gives its (hd, dv): three-pass TF32 where
    the widths round up to (64, 64) or (128, 128), the CUDA cores
    elsewhere; each kernel named in ``need`` launched in fp32 on the
    three-pass route at least once. Returns a summary line."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    sl_keys = {k: n for k, n in by_shape.get("swap_linear", {}).items()
               if k[3] == "float32"}
    fa_keys = {k: n for k, n in by_shape.get("flash_attention", {}).items()
               if k[6] == "float32"}
    off = sorted((k for k in sl_keys if k[5] != "tf32x3"), key=str)
    require(not off, f"{what}: fp32 swap_linear off the TF32 core: {off}")
    off = sorted((k for k in fa_keys
                  if k[11] != fa.path(torch.float32, k[4], k[5])), key=str)
    require(not off, f"{what}: fp32 flash_attention off its path: {off}")
    got = {"swap_linear": sum(sl_keys.values()),
           "flash_attention": sum(n for k, n in fa_keys.items()
                                  if k[11] == "tf32x3")}
    for name in need:
        require(got[name] > 0, f"{what}: no fp32 {name} launch on the "
                f"three-pass TF32 route")
    simt = sum(n for k, n in fa_keys.items() if k[11] == "simt")
    return (f"{what}: fp32 launches on the three-pass TF32 route: "
            f"swap_linear {got['swap_linear']}, flash_attention "
            f"{got['flash_attention']}" + (f"; fp32 flash_attention on the "
                                           f"CUDA cores {simt}" if simt
                                           else ""))


class launch_delta:
    """The kernels' launches inside the block, by kernel and key, without
    resetting the counters (``by_shape`` after the block)."""

    def __enter__(self):
        self.before = {n: dict(c.by_shape)
                       for n, c in kernel_counters().items()}
        return self

    def __exit__(self, *exc):
        self.by_shape = {}
        for n, c in kernel_counters().items():
            d = {k: v - self.before[n].get(k, 0)
                 for k, v in c.by_shape.items()}
            self.by_shape[n] = {k: v for k, v in d.items() if v > 0}


def since(main_launches, before) -> dict:
    """What ``main_launches`` gained since the snapshot ``before``."""
    return {n: {k: v - before[n].get(k, 0) for k, v in keys.items()
                if v > before[n].get(k, 0)}
            for n, keys in main_launches.items()}


# ---------------------------------------------------------------- kernels
def slice_linear_shapes(cfg):
    """(K, N, act, x dtype, bias) of every fused linear the slice launches,
    one entry per launch key (M, K, N, bits, dtype, act): where two linears
    share a key (wq and the attention wo at qwen's widths) the first wins."""
    D, F, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    bias = cfg.attn_bias
    out = {}
    for K, N, act, dt, b in [(D, H * hd, "none", "bfloat16", bias),   # wq
                             (D, KV * hd, "none", "bfloat16", bias),  # wk, wv
                             (H * hd, D, "none", "bfloat16", False),  # attn wo
                             (D, F, "silu", "bfloat16", False),       # wi0
                             (D, F, "none", "bfloat16", False),       # wi1
                             (F, D, "none", "bfloat16", False),       # ffn wo
                             (D, V, "none", "float32", False)]:       # head
        out.setdefault((K, N, act, dt), b)
    return [k + (b,) for k, b in out.items()]


def arm_linear_shapes(cfg, M, head_rows=1):
    """(M, K, N, act, x dtype, bias) of every B1 launch key of an
    int8-lazy arm's swapped prefill of one M-token prompt: a layer's
    linears (:func:`fp_layer_linears`; a Mamba2 layer's wo too) on the
    model's dtype, and the head on the last position in fp32 (on
    ``head_rows`` rows: a decode step's batch)."""
    out = [(M, K, N, act, cfg.dtype, b)
           for K, N, act, b in fp_layer_linears(cfg)]
    if "mamba2" in cfg.layer_kinds():
        out.append((M, cfg.ssm.expand * cfg.d_model, cfg.d_model, "none",
                    cfg.dtype, False))
    return out + [(head_rows, cfg.d_model, cfg.vocab_size, "none",
                   "float32", False)]


def check_row_independence(torch, g, which):
    """B1 (``which`` "q") or B5 ("fp") on the card: the rows of a 130-row
    call (K 2048 split 8 ways at N 256, the splits summed by a second
    pass) and of an 1100-row call (N = K = 2048: the
    splits summed inside each block, against the last-block combine of the
    1-row call) equal their 1-row calls bitwise, at every dtype and,
    for B1, int8 and int4 (B5's fp32 on the three-pass TF32 core, its
    1-row calls in 16-row tiles against the 128-row tiles of the others);
    an x at data_ptr() % 16 != 0 (plain loads) gives its aligned copy's
    (TMA or cp.async) bits; one-hot rows of x
    against a weight of distinct values return its rows exactly (a
    swizzle or transpose fault cannot pass). Returns a summary line."""
    from repro_torch.kernels import dequant as dq
    from repro_torch.kernels import gemm_plan
    from repro_torch.kernels import swap_linear as sl
    from repro_torch.kernels import swap_linear_q as slq
    dev = torch.device("cuda")
    kinds = (8, 4) if which == "q" else (None,)
    if which == "fp":      # fp32 on the three-pass TF32 core, at every M
        require({gemm_plan.plan(M, N, 2048, "float32", "fp32").core
                 for M in (1, 130, 1100) for N in (256, 2048)} == {"tf32x3"},
                "swap_linear fp32 does not plan the TF32 core")
    n = 0
    for dt in (torch.float32, torch.bfloat16):
        for (M, K, N, rows) in ((130, 2048, 256, range(130)),
                                (1100, 2048, 2048, (0, 1, 127, 128, 1099))):
            x = torch.randn((M, K), generator=g, device=dev).to(dt)
            b = (torch.randn((N,), generator=g, device=dev) * 0.1).to(dt)
            for bits in kinds:
                if bits is None:
                    w = (torch.randn((K, N), generator=g, device=dev)
                         * K ** -0.5).to(dt)

                    def fn(xx):
                        return sl.swap_linear(xx, w, b, act="silu")
                else:
                    lo = -127 if bits == 8 else -128
                    q = torch.randint(lo, 128, (K if bits == 8 else K // 2, N),
                                      generator=g, device=dev,
                                      dtype=torch.int8)
                    s = torch.rand((N,), generator=g, device=dev) * 0.02

                    def fn(xx):
                        return slq.swap_linear_q(xx, q, s, b, bits=bits,
                                                 act="silu")
                full = fn(x)
                require(all(torch.equal(full[i:i + 1],
                                         fn(x[i:i + 1].contiguous()))
                            for i in rows),
                        f"{which} int{bits} {dt} M={M}: a row differs from "
                        f"its 1-row call")
                n += 1
                buf = torch.empty((M * K + 8,), dtype=dt, device=dev)
                xv = buf[1:1 + M * K].view(M, K)
                xv.copy_(x)
                require(xv.data_ptr() % 16 != 0 and torch.equal(fn(xv), full),
                        f"{which} int{bits} {dt} M={M}: the misaligned view "
                        f"differs from the aligned copy")
                n += 1
    K, N = 96, 160
    idx = torch.arange(K * N, dtype=torch.int32).reshape(K, N)
    for dt in (torch.float32, torch.bfloat16):
        ks = [(7 * m + 3) % K for m in range(130)]
        x = torch.zeros((130, K), dtype=dt, device=dev)
        x[torch.arange(130), torch.tensor(ks)] = 1
        if which == "fp":
            w = ((idx + 0x3C00).to(torch.int16).view(torch.bfloat16)
                 if dt == torch.bfloat16 else (idx + 1).float()).to(dev)
            require(torch.equal(sl.swap_linear(x, w), w[ks]),
                    f"swap_linear {dt}: one-hot rows do not return the "
                    f"weight's rows")
            n += 1
            continue
        for bits in (8, 4):
            v = ((idx * 37 + 11) % (255 if bits == 8 else 15)
                 - (127 if bits == 8 else 7)).to(torch.int8)
            q = (v if bits == 8 else torch.from_numpy(dq.pack_int4(
                v.numpy()))).to(dev)
            got = slq.swap_linear_q(x, q, torch.ones((N,), device=dev),
                                    bits=bits)
            require(torch.equal(got.float(), v[ks].float().to(dev)),
                    f"swap_linear_q int{bits} {dt}: one-hot rows do not "
                    f"return the weight's rows")
            n += 1
    torch.cuda.synchronize()
    return (f"{n} checks: the rows of 130- and 1100-row calls equal their "
            f"1-row calls bitwise, misaligned views their aligned copies, "
            f"one-hot rows the weight's rows")


def check_kernels(torch, cfg, conv_path, arms):
    """Phase 2: every kernel against its plain version on the card.
    Returns the timing rows of the main-path shapes (``conv_path``: phase
    10's, :func:`p10_kernel_shapes`; ``arms``: the B1 launch keys of
    phases 11-13's int8-lazy arms, :func:`arm_linear_shapes`)."""
    from repro_torch.kernels import dequant as dq
    from repro_torch.kernels import swap_linear_q as slq

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(1234)
    dts = {"float32": torch.float32, "bfloat16": torch.bfloat16}

    def weights(K, N, bits):
        Kq = K if bits == 8 else (K + 1) // 2
        lo = -127 if bits == 8 else -128
        q = torch.randint(lo, 128, (Kq, N), generator=g, device=dev,
                          dtype=torch.int8)
        s = torch.rand((N,), generator=g, device=dev) * (2.0 / 127) / K ** 0.5
        return q, s

    # the sweep: every shape the slice launches, at every bits x dtype x
    # act x M, plus one odd shape
    D, F, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    kn = [(D, D), (D, cfg.n_kv_heads * cfg.resolved_head_dim), (D, F), (F, D),
          (D, V)]
    n_checked, worst = 0, {"float32": 0.0, "bfloat16": 0.0}
    for (K, N) in kn + [(129, 67)]:
        for bits in (8, 4):
            q, s = weights(K, N, bits)
            for dname, dt in dts.items():
                for M in ((3,) if K == 129 else (2, 512)):
                    x = torch.randn((M, K), generator=g, device=dev).to(dt)
                    b = (torch.randn((N,), generator=g, device=dev) * 0.1).to(dt)
                    for act in ("none", "silu", "gelu"):
                        got = slq.swap_linear_q(x, q, s, b, bits=bits, act=act)
                        want = slq.swap_linear_q_plain(x, q, s, b, bits=bits,
                                                       act=act)
                        _, rel = rel_err(torch, got, want)
                        require(bool(torch.isfinite(got).all()),
                                f"swap_linear_q non-finite at {(M, K, N)}")
                        require(rel <= TOL[dname],
                                f"swap_linear_q int{bits} {dname} {act} "
                                f"{(M, K, N)}: rel err {rel:.3g} > {TOL[dname]}")
                        worst[dname] = max(worst[dname], rel)
                        n_checked += 1
            del q, s
    print(f"swap_linear_q: {n_checked} cases match the plain version "
          f"(worst rel err fp32 {worst['float32']:.3g} <= 1e-5, "
          f"bf16 {worst['bfloat16']:.3g} <= 2e-2)", flush=True)
    print(f"swap_linear_q: {check_row_independence(torch, g, 'q')}",
          flush=True)

    n_checked = 0
    for (R, C) in [(1001, 333), (D, D), (V, D)]:
        for bits in (8, 4):
            Rq = R if bits == 8 else (R + 1) // 2
            q = torch.randint(-128, 128, (Rq, C), generator=g, device=dev,
                              dtype=torch.int8)
            s = torch.rand((C,), generator=g, device=dev)
            for od in (torch.float32, torch.bfloat16):
                got = dq.dequant_int8(q, s, od, bits=bits, rows=R)
                want = dq.dequant_int8_plain(q, s, od, bits=bits, rows=R)
                require(torch.equal(got, want),
                        f"dequant int{bits} -> {od} at {(R, C)} differs")
                n_checked += 1
    print(f"dequant_int8: {n_checked} cases bitwise equal to the plain "
          f"version", flush=True)
    torch.cuda.synchronize()

    # timing at the main paths' shapes: (M of a layer's linears, M of the
    # head, which projects the last position) per width. Phase 3's prefill
    # (4 x 128) at both widths and its int8 decode (2 rows); phase 8's
    # 2 x 16 prefills of the mixed store at both widths
    rows, seen = [], set()

    def q_row(M, K, N, bits, dname, act, has_bias, q, s):
        """Hold swap_linear_q at one main-path shape against its plain
        version and time it beside cuBLAS and its bound: one row."""
        dt = dts[dname]
        x = torch.randn((M, K), generator=g, device=dev).to(dt)
        b = ((torch.randn((N,), generator=g, device=dev) * 0.1).to(dt)
             if has_bias else None)
        got = slq.swap_linear_q(x, q, s, b, bits=bits, act=act)
        want, p_ms = plain_call(torch, lambda: slq.swap_linear_q_plain(
            x, q, s, b, bits=bits, act=act))
        err, rel = rel_err(torch, got, want)
        require(rel <= TOL[dname], f"timing case {(M, K, N)} rel {rel}")
        tail = N % 128            # a last column tile the kernel masks
        if tail:
            _, trel = rel_err(torch, got[:, -tail:], want[:, -tail:])
            require(trel <= TOL[dname], f"timing case {(M, K, N)}: the last"
                    f" {tail} columns rel {trel:.3g}")
        k_ms = time_ms(torch, lambda: slq.swap_linear_q(
            x, q, s, b, bits=bits, act=act))
        # library yardstick: cuBLAS on the weight dequantized beforehand
        # (not timed), in x's dtype, + the epilogue
        vals = dq.unpack_int4_tensor(q, K) if bits == 4 else q
        w_lib = (vals.float() * s[None, :]).to(dt)
        fn = {"silu": torch.nn.functional.silu}.get(act)

        def lib():
            r = torch.addmm(b, x, w_lib) if b is not None else x @ w_lib
            return fn(r) if fn else r
        l_ms = time_ms(torch, lib)
        del w_lib
        xs = 2 if dname == "bfloat16" else 4
        shape = f"M={M} K={K} N={N} int{bits} x={dname} act={act}"
        nbytes = (M * K * xs + q.numel() + 4 * N
                  + (N * xs if b is not None else 0) + M * N * xs)
        ops = 2.0 * M * N * K
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_OPS[dname] * 1e3
        rows.append({
            "name": "swap_linear_q", "route": "cuda",
            "source": "src/repro_torch/csrc/swap_linear_q.cu",
            "replaces": "src/repro/kernels/swap_linear_q.py:44",
            "key": (M, K, N, bits, dname, act),
            "shape": shape,
            "max_abs_err": err, "ms": k_ms, "kernel_ms": k_ms,
            "plain_ms": p_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": l_ms})

    for bits, Ms in ((8, ((BATCH * PROMPT, BATCH),
                          (DECODE_BATCH, DECODE_BATCH),
                          (P8_BATCH * P8_SEQ, P8_BATCH))),
                     (4, ((BATCH * PROMPT, BATCH),
                          (P8_BATCH * P8_SEQ, P8_BATCH)))):
        for (K, N, act, dname, has_bias) in slice_linear_shapes(cfg):
            q, s = weights(K, N, bits)
            for M_layer, M_head in Ms:
                M = M_head if N == V else M_layer
                if (M, K, N, bits, dname, act) in seen:
                    continue
                seen.add((M, K, N, bits, dname, act))
                q_row(M, K, N, bits, dname, act, has_bias, q, s)
            del q, s
    # phases 11-13's int8-lazy arms and phase 20's int4 store at their
    # published widths: each launch key at its widths, held and timed, and
    # the rows of each call bitwise its 1-row calls (a head's 1-row call
    # against a 4-row one)
    n_rows = n_timed = 0
    for (M, K, N, act, dname, has_bias, widths) in arms:
        for bits in widths:
            if (M, K, N, bits, dname, act) in seen:
                continue
            seen.add((M, K, N, bits, dname, act))
            q, s = weights(K, N, bits)
            q_row(M, K, N, bits, dname, act, has_bias, q, s)
            n_timed += 1
            Mr = max(M, 4)
            x = torch.randn((Mr, K), generator=g, device=dev).to(dts[dname])
            b = ((torch.randn((N,), generator=g, device=dev) * 0.1)
                 .to(dts[dname]) if has_bias else None)
            full = slq.swap_linear_q(x, q, s, b, bits=bits, act=act)
            for i in sorted({0, 1, Mr // 2, Mr - 1}):
                require(torch.equal(full[i:i + 1], slq.swap_linear_q(
                    x[i:i + 1].contiguous(), q, s, b, bits=bits, act=act)),
                    f"swap_linear_q int{bits} {(Mr, K, N)} {dname}: row {i}"
                    f" differs from its 1-row call")
                n_rows += 1
            del q, s, x, b, full
    print(f"swap_linear_q: {n_timed} rows at the int8-lazy arms' and "
          f"granite-20b's launch keys held and timed; {n_rows} rows bitwise "
          f"their 1-row calls", flush=True)
    # phase 10: the conv workloads' fused fc layers (fp32 x, with a bias)
    for (M, K, N) in conv_path["q"]:
        for bits in (8, 4):
            q, s = weights(K, N, bits)
            q_row(M, K, N, bits, "float32", "none", True, q, s)
            del q, s
    for (R, C) in [(D, D), (D, cfg.n_kv_heads * cfg.resolved_head_dim),
                   (D, F), (F, D), (V, D), (D, V)] + conv_path["dequant"]:
        q = torch.randint(-127, 128, (R, C), generator=g, device=dev,
                          dtype=torch.int8)
        s = torch.rand((C,), generator=g, device=dev)
        got = dq.dequant_int8(q, s, torch.float32)
        want, p_ms = plain_call(torch, lambda: dq.dequant_int8_plain(
            q, s, torch.float32))
        err = (got - want).abs().max().item()
        require(err == 0.0, f"dequant timing case {(R, C)}")
        k_ms = time_ms(torch, lambda: dq.dequant_int8(q, s, torch.float32))
        l_ms = time_ms(torch, lambda: torch.mul(q, s))
        t_bytes = (R * C + 4 * C + 4 * R * C) / HBM_BYTES_PER_S * 1e3
        t_ops = R * C / PEAK_OPS["float32"] * 1e3
        rows.append({
            "name": "dequant_int8", "route": "cuda",
            "source": "src/repro_torch/csrc/dequant.cu",
            "replaces": "src/repro/kernels/dequant.py:42",
            "key": (R, C, 8, "float32"),
            "shape": f"R={R} C={C} int8 -> float32",
            "max_abs_err": err, "ms": k_ms, "kernel_ms": k_ms,
            "plain_ms": p_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": l_ms})
        del q, s
    for r in rows:
        print(f"  {r['name']:14s} {r['shape']:46s} kernel {r['ms']:.4f} ms"
              f"{earlier(r)}  plain {r['plain_ms']:.4f} ms  library "
              f"{r['library_ms']:.4f} ms  bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']})", flush=True)
    torch.cuda.empty_cache()
    return rows


# ------------------------------------------------------ paged attention
def paged_inputs(torch, seed, B, H, KV, hd, T, seq_lens, dtype, pad_cols=0):
    """q, K/V pools (page 0 the zero page, a few spare pages), a SHUFFLED
    page table with ``pad_cols`` extra columns of the padding page, and
    int32 seq_lens, on the card."""
    import numpy as np
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    n = [-(-s // T) for s in seq_lens]
    P = sum(n) + 3
    q = (torch.randn((B, H, hd), generator=g, device="cuda") * 0.5).to(dtype)
    kp = (torch.randn((P + 1, T, KV, hd), generator=g, device="cuda")
          * 0.5).to(dtype)
    vp = (torch.randn((P + 1, T, KV, hd), generator=g, device="cuda")
          * 0.5).to(dtype)
    kp[0] = 0
    vp[0] = 0
    ids = np.random.default_rng(seed).permutation(np.arange(1, P + 1))
    pt = np.zeros((B, max(n) + pad_cols), np.int32)
    used = 0
    for b, k in enumerate(n):
        pt[b, :k] = ids[used:used + k]
        used += k
    return (q, kp, vp, torch.from_numpy(pt).cuda(),
            torch.tensor(seq_lens, dtype=torch.int32, device="cuda"))


def paged_live_tokens(seq_lens, window):
    """Live in-window tokens over a batch: the K/V rows the function must
    read and the slots its softmax covers."""
    return sum(s - (0 if window is None else max(s - window, 0))
               for s in seq_lens)


# (name, dtype, B, H, KV, hd, seq_lens, scale, window, softcap): the main
# paths' decode shapes. Run A is qwen in fp32, Run B in bf16 (batches of
# 1-4, contexts up to 208 tokens), Run C gemma2-9b (a 4,201-token and a
# 25-token sequence at the first decode step)
QWEN_SCALE = 128 ** -0.5
GEMMA_SCALE = 224.0 ** -0.5
PAGED_TIMED = [
    ("qwen2.5-3b fp32 B=4", "float32", 4, 16, 2, 128, [38, 65, 101, 130],
     QWEN_SCALE, None, None),
    ("qwen2.5-3b bf16 B=1", "bfloat16", 1, 16, 2, 128, [208], QWEN_SCALE,
     None, None),
    ("qwen2.5-3b bf16 B=4", "bfloat16", 4, 16, 2, 128, [38, 65, 101, 130],
     QWEN_SCALE, None, None),
    ("gemma2-9b bf16 B=2 local", "bfloat16", 2, 16, 8, 256, [4201, 25],
     GEMMA_SCALE, 4096, 50.0),
    ("gemma2-9b bf16 B=2 global", "bfloat16", 2, 16, 8, 256, [4201, 25],
     GEMMA_SCALE, None, 50.0),
    # phase 7: qwen's two 32-token generations decode at 33 to 35 tokens
    # (a step alone at B=1 is the B=1 row's shape)
    ("qwen2.5-3b multi-tenant bf16 B=2", "bfloat16", 2, 16, 2, 128, [34, 34],
     QWEN_SCALE, None, None),
    # phase 9: llama4-scout's 40- and 100-token prompts at their first
    # decode step, batched and each served alone
    ("llama4-scout bf16 B=2", "bfloat16", 2, 40, 8, 128,
     [n + 1 for n in LLAMA_PAGED_PROMPTS], LLAMA_SCALE, None, None),
    ("llama4-scout bf16 B=1", "bfloat16", 1, 40, 8, 128,
     [LLAMA_PAGED_PROMPTS[-1] + 1], LLAMA_SCALE, None, None),
    # phase 13: qwen2-vl-72b's 40- and 100-token prompts the same way
    ("qwen2-vl bf16 B=2", "bfloat16", 2, 64, 8, 128,
     [n + 1 for n in VL_PAGED_PROMPTS], VL_SCALE, None, None),
    ("qwen2-vl bf16 B=1", "bfloat16", 1, 64, 8, 128,
     [VL_PAGED_PROMPTS[-1] + 1], VL_SCALE, None, None),
    # phase 19 (b): h2o-danube-3-4b (32 / 8 heads of 120, the kernel's row
    # width 128) in fp32 at its first decode step (the 4,000-token prompt
    # beside two of 40, window 4096) and its last (4,099 tokens alone, past
    # the window); without the window and in bf16 too
    ("h2o-danube fp32 B=3", "float32", 3, 32, 8, 120, DN_FIRST_STEP,
     DN_SCALE, 4096, None),
    ("h2o-danube fp32 B=1", "float32", 1, 32, 8, 120, DN_LAST_STEP,
     DN_SCALE, 4096, None),
    ("h2o-danube fp32 B=3", "float32", 3, 32, 8, 120, DN_FIRST_STEP,
     DN_SCALE, None, None),
    ("h2o-danube bf16 B=3", "bfloat16", 3, 32, 8, 120, DN_FIRST_STEP,
     DN_SCALE, 4096, None),
    ("h2o-danube bf16 B=1", "bfloat16", 1, 32, 8, 120, DN_LAST_STEP,
     DN_SCALE, 4096, None),
    ("h2o-danube bf16 B=3", "bfloat16", 3, 32, 8, 120, DN_FIRST_STEP,
     DN_SCALE, None, None),
    # phase 20: granite-20b (48 query heads of 128 on one KV head, six
    # groups of 8) in bf16 at its decode step, 3 sequences batched and one
    # alone; in fp32 too
    ("granite-20b bf16 B=3", "bfloat16", 3, 48, 1, 128,
     [n + 1 for n in GR_PAGED_PROMPTS], GR_SCALE, None, None),
    ("granite-20b bf16 B=1", "bfloat16", 1, 48, 1, 128,
     [GR_PAGED_PROMPTS[0] + 1], GR_SCALE, None, None),
    ("granite-20b fp32 B=3", "float32", 3, 48, 1, 128,
     [n + 1 for n in GR_PAGED_PROMPTS], GR_SCALE, None, None),
    ("granite-20b fp32 B=1", "float32", 1, 48, 1, 128,
     [GR_PAGED_PROMPTS[0] + 1], GR_SCALE, None, None),
]


def check_paged_bitwise(torch, pa, dts) -> int:
    """A sequence's output does not depend on the batch (its splits follow
    its own seq_len), two identical calls give equal bits, and the kernel's
    splits are split_bounds'. Returns the number of checks."""
    n = 0
    kw = dict(scale=GEMMA_SCALE, softcap=50.0)
    for dname in ("bfloat16", "float32"):
        solo = paged_inputs(torch, 41, 1, 16, 8, 256, PAGE_TOKENS, [4201],
                            dts[dname])
        np_long = -(-4201 // PAGE_TOKENS)
        for window in (4096, None):
            want = pa.paged_attention(*solo, window=window, **kw)
            for others in ([25], [4500, 1, 300]):
                sl = [4201] + others
                q, kp, vp, pt, lens = paged_inputs(
                    torch, 42, len(sl), 16, 8, 256, PAGE_TOKENS, sl,
                    dts[dname], pad_cols=len(others))
                q[0] = solo[0][0]          # the same row: q and its pages
                kp[pt[0, :np_long].long()] = solo[1][solo[3][0].long()]
                vp[pt[0, :np_long].long()] = solo[2][solo[3][0].long()]
                got = pa.paged_attention(q, kp, vp, pt, lens, window=window,
                                         **kw)
                require(torch.equal(got[:1], want),
                        f"paged_attention {dname} window {window}: the "
                        f"4,201-token row beside {others} differs from it "
                        f"alone")
                n += 1
    # h2o-danube's and granite-20b's geometries: a 4,100-token row (past
    # the 4,096 window) alone == beside others
    for H, KV, hd in ((32, 8, 120), (48, 1, 128)):
        for dname in ("bfloat16", "float32"):
            solo = paged_inputs(torch, 44, 1, H, KV, hd, PAGE_TOKENS, [4100],
                                dts[dname])
            np_long = -(-4100 // PAGE_TOKENS)
            for window in (4096, None):
                want = pa.paged_attention(*solo, window=window)
                for others in ([40, 40], [4500, 1, 300]):
                    sl = [4100] + others
                    q, kp, vp, pt, lens = paged_inputs(
                        torch, 45, len(sl), H, KV, hd, PAGE_TOKENS, sl,
                        dts[dname], pad_cols=len(others))
                    q[0] = solo[0][0]
                    kp[pt[0, :np_long].long()] = solo[1][solo[3][0].long()]
                    vp[pt[0, :np_long].long()] = solo[2][solo[3][0].long()]
                    got = pa.paged_attention(q, kp, vp, pt, lens,
                                             window=window)
                    require(torch.equal(got[:1], want),
                            f"paged_attention {dname} {H} / {KV} heads of "
                            f"{hd}, window {window}: the 4,100-token row "
                            f"beside {others} differs from it alone")
                    n += 1
    for B, H, KV, hd, sl, kw2 in [
            (4, 16, 2, 128, [38, 65, 101, 130], dict(scale=QWEN_SCALE)),
            (3, 32, 8, 120, DN_FIRST_STEP, dict(scale=DN_SCALE,
                                                window=4096)),
            (3, 48, 1, 128, [513, 513, 513], dict(scale=GR_SCALE)),
            (1, 16, 2, 128, [64], dict(scale=QWEN_SCALE)),
            (2, 16, 8, 256, [4201, 25], dict(scale=GEMMA_SCALE, window=4096,
                                             softcap=50.0))]:
        for dname in ("bfloat16", "float32"):
            args = paged_inputs(torch, 43, B, H, KV, hd, PAGE_TOKENS, sl,
                                dts[dname])
            require(torch.equal(pa.paged_attention(*args, **kw2),
                                pa.paged_attention(*args, **kw2)),
                    f"paged_attention {dname} {sl}: two identical calls "
                    f"differ")
            n += 1
    lens = [1, 16, 25, 64, 65, 208, 4096, 4201, 4500]
    sl = torch.tensor(lens, dtype=torch.int32, device="cuda")
    for L in (64, 128):
        for window in (None, 17, 4096):
            require(pa.kernel_split_bounds(sl, window, L, 300 * PAGE_TOKENS)
                    == [pa.split_bounds(x, window, L, 300 * PAGE_TOKENS)
                        for x in lens],
                    f"paged_attention: the kernel's splits (L {L}, window "
                    f"{window}) differ from split_bounds")
            n += 1
    torch.cuda.synchronize()
    return n


def check_paged_attention(torch):
    """Phase 2 for B3: the kernel against its plain version over the
    reference test's sweep and the main paths' shapes, then timed at the
    latter. Returns the timing rows."""
    from repro_torch.kernels import paged_attention as pa
    dts = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    cases = []
    for dname in dts:                   # the JAX package's test sweep
        for window, softcap in ((None, None), (7, None), (None, 30.0),
                                (5, 30.0)):
            cases.append((dname, 3, 8, 2, 64, 8, [5, 23, 16], None, window,
                          softcap, 0))
    for dname in dts:                   # qwen2.5-3b, B 1-4, ragged
        for sl in ([1], [1, 17], [1, 38, 101], [17, 65, 130, 208]):
            cases.append((dname, len(sl), 16, 2, 128, 16, sl, QWEN_SCALE,
                          None, None, 1))
    for window in (4096, None):         # gemma2-9b, local and global
        cases.append(("bfloat16", 2, 16, 8, 256, 16, [4201, 25], GEMMA_SCALE,
                      window, 50.0, 0))
    for dname in dts:                   # h2o-danube (hd 120), granite (G 48)
        for window in (None, 7, 4096):
            cases.append((dname, 3, 32, 8, 120, 16, [4100, 1, 300], DN_SCALE,
                          window, None, 2))
        for softcap in (None, 30.0):
            cases.append((dname, 4, 48, 1, 128, 16, [1, 40, 129, 700],
                          GR_SCALE, None, softcap, 1))
    worst = {"float32": 0.0, "bfloat16": 0.0}
    for i, (dname, B, H, KV, hd, T, sl, scale, window, softcap,
            pad) in enumerate(cases):
        args = paged_inputs(torch, 100 + i, B, H, KV, hd, T, sl, dts[dname],
                            pad)
        got = pa.paged_attention(*args, scale=scale, window=window,
                                 softcap=softcap)
        want = pa.paged_attention_plain(*args, scale=scale, window=window,
                                        softcap=softcap)
        _, rel = rel_err(torch, got, want)
        require(bool(torch.isfinite(got).all()),
                f"paged_attention non-finite at {(B, H, KV, hd, T, sl)}")
        require(rel <= TOL[dname],
                f"paged_attention {dname} {(B, H, KV, hd, T, sl)} window "
                f"{window} softcap {softcap}: rel err {rel:.3g} > "
                f"{TOL[dname]}")
        worst[dname] = max(worst[dname], rel)
    print(f"paged_attention: {len(cases)} cases match the plain version "
          f"(worst rel err fp32 {worst['float32']:.3g} <= 1e-5, bf16 "
          f"{worst['bfloat16']:.3g} <= 2e-2)", flush=True)
    n_bits = check_paged_bitwise(torch, pa, dts)
    print(f"paged_attention: {n_bits} bitwise checks pass (gemma2-9b's "
          f"4,201-token row and h2o-danube's and granite-20b's 4,100-token "
          f"rows alone == beside 2 and 3 other sequences; two identical "
          f"calls, one split and many)", flush=True)

    rows = []
    for (label, dname, B, H, KV, hd, sl, scale, window,
         softcap) in PAGED_TIMED:
        dt = dts[dname]
        T = PAGE_TOKENS
        q, kp, vp, pt, sl_t = paged_inputs(torch, 7, B, H, KV, hd, T, sl, dt)
        kw = dict(scale=scale, window=window, softcap=softcap)
        got = pa.paged_attention(q, kp, vp, pt, sl_t, **kw)
        want, p_ms = plain_call(torch, lambda: pa.paged_attention_plain(
            q, kp, vp, pt, sl_t, **kw))
        err, rel = rel_err(torch, got, want)
        require(rel <= TOL[dname], f"timing case {label}: rel {rel:.3g}")
        k_ms = time_ms(torch, lambda: pa.paged_attention(q, kp, vp, pt,
                                                         sl_t, **kw))
        # library yardstick on the K/V gathered to contiguous [B, KV, S, hd]
        # beforehand (not timed), the same mask: SDPA, or flex_attention
        # (compiled, its fused kernel) where the softcap needs a score_mod
        S = pt.shape[1] * T
        kc = kp[pt.long()].reshape(B, S, KV, hd).transpose(1, 2).contiguous()
        vc = vp[pt.long()].reshape(B, S, KV, hd).transpose(1, 2).contiguous()
        q4 = q[:, :, None, :]
        lens = sl_t.long()
        if softcap is None:
            G = H // KV
            kc = kc.repeat_interleave(G, dim=1)
            vc = vc.repeat_interleave(G, dim=1)
            tok = torch.arange(S, device="cuda")[None, :]
            mask = tok < lens[:, None]
            if window is not None:
                mask &= (lens[:, None] - 1 - tok) < window
            mask = mask[:, None, None, :]
            sdpa = torch.nn.functional.scaled_dot_product_attention

            def lib():
                return sdpa(q4, kc, vc, attn_mask=mask, scale=scale)
        else:
            from torch.nn.attention import flex_attention as fa
            flex = torch.compile(fa.flex_attention, dynamic=False)

            def capped(s, b, h, q_idx, kv_idx):
                return softcap * torch.tanh(s / softcap)

            def live(b, h, q_idx, kv_idx):
                m = kv_idx < lens[b]
                if window is not None:
                    m = m & (lens[b] - 1 - kv_idx < window)
                return m
            block_mask = fa.create_block_mask(live, B, None, 1, S,
                                              device="cuda")

            def lib():
                return flex(q4, kc, vc, score_mod=capped,
                            block_mask=block_mask, scale=scale,
                            enable_gqa=True)
        _, lrel = rel_err(torch, lib()[:, :, 0], want)
        require(lrel <= TOL[dname], f"library yardstick {label}: {lrel}")
        l_ms = time_ms(torch, lib)
        del kc, vc
        tokens = paged_live_tokens(sl, window)
        es = q.element_size()
        nbytes = (tokens * KV * hd * es * 2 + 2 * B * H * hd * es
                  + pt.numel() * 4 + B * 4)
        ops = 4.0 * H * hd * tokens
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_OPS[dname] * 1e3
        # groups of up to pa.GROUP query heads a KV head: each re-reads
        # the split's K/V rows (the bound counts them once, from HBM)
        ng = pa.groups(H // KV)
        reread = (f" (K/V rows read by {ng} head groups, {ng - 1} of them "
                  f"mostly from L2)" if ng > 1 else "")
        rows.append({
            "name": "paged_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/paged_attention.cu",
            "replaces": "src/repro/kernels/paged_attention.py:34",
            "key": (B, H, KV, hd, T, dname, window, softcap),
            "shape": f"{label} seq_lens={sl} window={window} "
                     f"softcap={softcap}{reread}",
            "max_abs_err": err, "ms": k_ms, "kernel_ms": k_ms,
            "plain_ms": p_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": l_ms, "live_tokens": tokens})
        del q, kp, vp
    for r in rows:
        print(f"  paged_attention {r['shape']:78s} kernel {r['ms']:.4f} ms"
              f"{earlier(r)}  plain {r['plain_ms']:.4f} ms  library "
              f"{r['library_ms']:.4f} ms  bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}, {r['live_tokens']} live tokens x "
              f"{r['key'][2]} KV heads)", flush=True)
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------- wkv6
# (BH, S, hd, dtype, initial state): rwkv6-3b's swapped prefill (2 x 512
# tokens x 40 heads of 64, and one 512-token prompt) and its engine prefill
# (2 x 16 tokens), in the path's fp32 and in bf16; the reduced config's
# head_dim 32 at 3 chunks; a carried state
WKV_CASES = [(80, 512, 64, "float32", False), (80, 16, 64, "float32", False),
             (40, 512, 64, "float32", False),
             (80, 512, 64, "bfloat16", False),
             (80, 16, 64, "bfloat16", False), (3, 48, 32, "float32", False),
             (3, 48, 32, "bfloat16", False), (80, 512, 64, "float32", True),
             (3, 48, 32, "float32", True), (3, 48, 32, "bfloat16", True)]
# fp32, the paths': phase 5's prefills and phase 16's training step
WKV_TIMED = [(80, 512, 64), (40, 512, 64), (80, 16, 64),
             (RWKV_TRAIN_BH, TRAIN_SEQ, 64)]
# the bitwise checks: the path's shapes, bf16 with a carried state, the
# reduced config's head_dim 32
WKV_BITWISE = [(80, 512, 64, "float32", False), (80, 16, 64, "float32", False),
               (80, 512, 64, "bfloat16", True), (3, 48, 32, "float32", True),
               (3, 48, 32, "bfloat16", False)]


def wkv6_inputs(torch, seed, BH, S, hd, dtype, state):
    """r, k, v ~ 0.5 N(0, 1), u ~ 0.1 N(0, 1), log decays uniform over the
    whole clamp range [-5, -1e-4] with row 0 at -5 (k e^-l reaches e^80),
    an fp32 initial state or None; on the card."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)

    def randn(*shape, scale):
        return torch.randn(shape, generator=g, device="cuda") * scale
    r, k, v = (randn(BH, S, hd, scale=0.5).to(dtype) for _ in range(3))
    w = -5.0 + (5.0 - 1e-4) * torch.rand((BH, S, hd), generator=g,
                                         device="cuda")
    w[0] = -5.0
    u = randn(BH, hd, scale=0.1).to(dtype)
    s0 = randn(BH, hd, hd, scale=0.3) if state else None
    return r, k, v, w.to(dtype), u, s0


def wkv6_cost(BH, S, hd, itemsize, state):
    """(bytes, operations) the function needs: r, k, v, w read and y
    written once, u, the state in (if any) and out; per chunk of Q steps
    and row, the strictly lower A (Q(Q-1) hd), the causal A v (Q(Q+1)
    hd), r S and k^T v (2 Q hd^2 each), the state's decay (2 hd^2) and
    about 11 elementwise operations per (step, channel)."""
    Q = min(16, S)
    nbytes = (5 * BH * S * hd * itemsize + BH * hd * itemsize
              + BH * hd * hd * 4 * (2 if state else 1))
    per_chunk = 2 * Q * Q * hd + 4 * Q * hd * hd + 2 * hd * hd + 11 * Q * hd
    return nbytes, float(BH * (S // Q) * per_chunk)


def check_wkv6(torch):
    """Phase 2 for B6: the kernel against its plain version, y and the
    final state, then timed at the path's shapes. Returns the rows."""
    from repro_torch.kernels import wkv6 as kw
    dts = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    worst = {"float32": 0.0, "bfloat16": 0.0}
    for i, (BH, S, hd, dname, state) in enumerate(WKV_CASES):
        args = wkv6_inputs(torch, 200 + i, BH, S, hd, dts[dname], state)
        y, s_fin = kw.wkv6(*args)
        y_p, s_p = kw.wkv6_plain(*args)
        for what, got, want in (("y", y, y_p), ("state", s_fin, s_p)):
            _, rel = rel_err(torch, got, want)
            require(bool(torch.isfinite(got).all()),
                    f"wkv6 {what} non-finite at {(BH, S, hd, dname, state)}")
            require(rel <= TOL[dname], f"wkv6 {what} {(BH, S, hd, dname)} "
                    f"state in {state}: rel err {rel:.3g} > {TOL[dname]}")
            worst[dname] = max(worst[dname], rel)
        del args, y, s_fin, y_p, s_p
    print(f"wkv6: {len(WKV_CASES)} cases (y and final state) match the plain "
          f"version (worst rel err fp32 {worst['float32']:.3g} <= 1e-5, bf16 "
          f"{worst['bfloat16']:.3g} <= 2e-2)", flush=True)
    check_wkv6_bitwise(torch, kw)

    rows = []
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    for (BH, S, hd) in WKV_TIMED:
        args = wkv6_inputs(torch, 7, BH, S, hd, torch.float32, False)
        y, _ = kw.wkv6(*args)
        (y_p, _), p_ms = plain_call(torch, lambda: kw.wkv6_plain(*args))
        err, rel = rel_err(torch, y, y_p)
        require(rel <= TOL["float32"], f"wkv6 timing case {(BH, S, hd)}")
        k_ms = time_ms(torch, lambda: kw.wkv6(*args))
        nbytes, ops = wkv6_cost(BH, S, hd, 4, False)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_OPS["float32"] * 1e3
        rows.append({
            "name": "wkv6", "route": "cuda",
            "source": "src/repro_torch/csrc/wkv6.cu",
            "replaces": "src/repro/kernels/wkv6.py:24",
            "key": (BH, S, hd, "float32", False),
            "shape": f"BH={BH} S={S} hd={hd} float32, zero initial state",
            "max_abs_err": err, "ms": k_ms, "kernel_ms": k_ms,
            "plain_ms": p_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None,
            "groups": kw.launch_plan(BH, hd, n_sm)})
        del args
    for r in rows:
        print(f"  wkv6 {r['shape']:42s} kernel {r['ms']:.4f} ms"
              f"{earlier(r)}  plain {r['plain_ms']:.4f} ms  library: no "
              f"PyTorch call computes WKV6  bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}); groups {r.pop('groups')}", flush=True)
    torch.cuda.empty_cache()
    return rows


def check_wkv6_bitwise(torch, kw):
    """B6's properties, bitwise, at ``WKV_BITWISE``: the first and the last
    three rows of a call equal a 3-row call on them; every column split
    the kernel takes at that head_dim equals the planned launch; S run in
    two halves with the state carried equals one call; a repeated call
    equals the first."""
    dts = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    n = 0
    for i, (BH, S, hd, dname, state) in enumerate(WKV_BITWISE):
        args = wkv6_inputs(torch, 300 + i, BH, S, hd, dts[dname], state)
        y, s_fin = kw.wkv6(*args)
        runs = [("a repeated call", kw.wkv6(*args), (y, s_fin))]
        runs += [(f"groups {G}", kw._wkv6(*args, G), (y, s_fin))
                 for G in kw.GROUPS if hd % (G * kw.CONSUMER_COLUMNS) == 0]
        if BH > 3:
            for rows in (slice(0, 3), slice(BH - 3, BH)):
                sub = [None if t is None else t[rows].contiguous()
                       for t in args]
                runs.append((f"rows {rows.start}-{rows.stop - 1} alone",
                             kw.wkv6(*sub), (y[rows], s_fin[rows])))
        if S % 32 == 0:
            h = S // 2
            y1, s1 = kw.wkv6(*(t[:, :h].contiguous() for t in args[:4]),
                             args[4], args[5])
            y2, s2 = kw.wkv6(*(t[:, h:].contiguous() for t in args[:4]),
                             args[4], s1)
            runs.append(("two halves of S", (torch.cat([y1, y2], dim=1), s2),
                         (y, s_fin)))
        for what, got, want in runs:
            require(torch.equal(got[0], want[0])
                    and torch.equal(got[1], want[1]),
                    f"wkv6 {(BH, S, hd, dname, state)}: {what} differs "
                    f"bitwise")
        n += len(runs)
        del args, runs
    print(f"wkv6: {n} bitwise checks at {len(WKV_BITWISE)} shapes (rows of "
          f"BH 80 == a 3-row call, every column split == the plan, two "
          f"halves of S == one call, repeated calls)", flush=True)


# ---------------------------------------------------------------- swap_linear
def fp_layer_linears(cfg):
    """(K, N, act, bias) of a layer's full-precision linears (a moe
    layer's are its attention's and its shared expert's; an MLA layer's
    attention has wq and wo only, its latent projections being plain
    matmuls; a GELU MLP's are ``wi`` and ``wo``, the GELU applied after
    the kernel), one entry per launch key (M, K, N, dtype, act): where two
    share a key (qwen's wq and attention wo) the first wins."""
    D, F = cfg.d_model, cfg.d_ff
    if cfg.moe is not None:
        F = cfg.moe.d_shared or cfg.moe.d_expert * cfg.moe.n_shared
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    gate = "silu" if cfg.act == "swiglu" else "gelu"
    if cfg.mla is not None:
        m = cfg.mla
        attn = [(D, H * (m.qk_nope_head_dim + m.qk_rope_head_dim), "none",
                 False),                                         # wq
                (H * m.v_head_dim, D, "none", False)]            # attn wo
    else:
        attn = [(D, H * hd, "none", cfg.attn_bias),              # wq
                (D, KV * hd, "none", cfg.attn_bias),             # wk, wv
                (H * hd, D, "none", False)]                      # attn wo
    if cfg.act in ("swiglu", "gelu_glu"):
        mlp = [(D, F, gate, False),                              # wi0
               (D, F, "none", False),                            # wi1
               (F, D, "none", False)]                            # ffn wo
    else:
        mlp = [(D, F, "none", False), (F, D, "none", False)]     # wi, wo
    out = {}
    for K, N, act, b in attn + mlp:
        out.setdefault((K, N, act), b)
    return [k + (b,) for k, b in out.items()]


def check_swap_linear(torch, qcfg, gcfg, rcfg, lcfg, dcfg, zcfg, vcfg,
                      hcfg, ncfg, grcfg, conv_path):
    """Phase 2 for B5: the kernel against its plain version over ragged
    shapes and qwen2.5-3b's linears at decode and prefill, then timed at
    the main paths' shapes (phase 10's from ``conv_path``). Returns the
    timing rows."""
    from repro_torch.kernels import gemm_plan
    from repro_torch.kernels import swap_linear as sl
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(4321)
    dts = {"float32": torch.float32, "bfloat16": torch.bfloat16}

    def inputs(M, K, N, dt):
        x = (torch.randn((M, K), generator=g, device=dev) * 0.5).to(dt)
        w = (torch.randn((K, N), generator=g, device=dev)
             * K ** -0.5).to(dt)
        b = (torch.randn((N,), generator=g, device=dev) * 0.1).to(dt)
        return x, w, b

    cases = [(3, 129, 67), (130, 200, 150), (1, 7, 3)]
    cases += [(M, K, N) for (K, N, _, _) in fp_layer_linears(qcfg)
              for M in (2, 512)]
    n_checked, worst = 0, {"float32": 0.0, "bfloat16": 0.0}
    for (M, K, N) in cases:
        for dname, dt in dts.items():
            x, w, b = inputs(M, K, N, dt)
            for act in ("none", "silu", "gelu"):
                for bias in (b, None):
                    got = sl.swap_linear(x, w, bias, act=act)
                    want = sl.swap_linear_plain(x, w, bias, act=act)
                    _, rel = rel_err(torch, got, want)
                    require(bool(torch.isfinite(got).all()),
                            f"swap_linear non-finite at {(M, K, N)}")
                    require(rel <= TOL[dname],
                            f"swap_linear {dname} {act} {(M, K, N)} bias "
                            f"{bias is not None}: rel err {rel:.3g} > "
                            f"{TOL[dname]}")
                    worst[dname] = max(worst[dname], rel)
                    n_checked += 1
    x, w, b = inputs(130, 2048, 256, torch.float32)
    full = sl.swap_linear(x, w, b, act="silu")
    require(all(torch.equal(full[i:i + 1], sl.swap_linear(
        x[i:i + 1].contiguous(), w, b, act="silu")) for i in range(130)),
        "swap_linear: a row of the 130-row call differs from its 1-row call")
    print(f"swap_linear: {n_checked} cases match the plain version "
          f"(worst rel err fp32 {worst['float32']:.3g} <= 1e-5, bf16 "
          f"{worst['bfloat16']:.3g} <= 2e-2); the rows of a 130-row call "
          f"equal their 1-row calls bitwise", flush=True)
    print(f"swap_linear: {check_row_independence(torch, g, 'fp')}",
          flush=True)
    torch.cuda.synchronize()

    # the main paths: qwen2.5-3b bf16 prefill (phase 3 mmap and eager),
    # its fp32 decode at batch 2 (phase 4, run A), gemma2-9b's prefill
    # (phase 6), rwkv6-3b's output projection (phase 5, fp32); phase 7's
    # 32-token prefills of both tenants and qwen's paged decode at 1 or 2
    # sequences (its two generations may start a step apart), in bf16;
    # phase 8's 2 x 16 prefills launch at the same M = 32 as phase 7's
    timed = [("qwen2.5-3b", BATCH * PROMPT, "bfloat16", s)
             for s in fp_layer_linears(qcfg)]
    timed += [("qwen2.5-3b", 2, "float32", s) for s in fp_layer_linears(qcfg)]
    timed += [("gemma2-9b", GEMMA_PREFILL, "bfloat16", s)
              for s in fp_layer_linears(gcfg)]
    timed += [(f"{c.name} multi-tenant", M, "bfloat16", s)
              for c, Ms in ((qcfg, (P7_PROMPT, 2, 1)), (gcfg, (P7_PROMPT,)))
              for M in Ms for s in fp_layer_linears(c)]
    timed += [("rwkv6-3b wo", RWKV_BATCH * RWKV_PROMPT, "float32",
               (rcfg.d_model, rcfg.d_model, "none", False))]
    # phase 9: llama4-scout's 8,704-token prefill, its paged admissions and
    # its decode steps at 2 sequences (batched) and 1 (served alone)
    timed += [(f"{lcfg.name}", M, "bfloat16", s)
              for M in (LLAMA_PROMPT, *LLAMA_PAGED_PROMPTS, 2, 1)
              for s in fp_layer_linears(lcfg)]
    # phase 11: deepseek-v2-lite's 4,096-token prefill, the engine's
    # 2 x 4-token prefill and the decode steps at 2 sequences
    timed += [(f"{dcfg.name}", M, "bfloat16", s)
              for M in (DS_PROMPT, DS_BATCH * DS_DECODE_PROMPT, DS_BATCH)
              for s in fp_layer_linears(dcfg)]
    # phase 12: zamba2-7b's 4,096-token prefill, the engine's 2 x 4-token
    # prefill and the decode steps at 2 sequences: the shared attention
    # block's linears and each Mamba2 layer's wo (d_inner 7168 -> 3584)
    z_wo = (zcfg.ssm.expand * zcfg.d_model, zcfg.d_model, "none", False)
    timed += [(f"{zcfg.name}", M, "bfloat16", s)
              for M in (Z_PROMPT, Z_BATCH * Z_DECODE_PROMPT, Z_BATCH)
              for s in fp_layer_linears(zcfg) + [z_wo]]
    # phase 13: qwen2-vl-72b's 2,048-token prefill (q / k / v with bias),
    # its paged admissions and its decode steps at 2 sequences (batched)
    # and 1 (served alone); phase 14: hubert-xlarge's 2 x 1,500 frames
    timed += [(f"{vcfg.name}", M, "bfloat16", s)
              for M in (VL_PROMPT, *VL_PAGED_PROMPTS, 2, 1)
              for s in fp_layer_linears(vcfg)]
    timed += [(f"{hcfg.name}", HB_BATCH * HB_FRAMES, "bfloat16", s)
              for s in fp_layer_linears(hcfg)]
    # phase 19 (b): h2o-danube-3-4b's paged run in fp32: its admissions
    # (4,000 and 40 tokens) and its decode steps at 3 sequences and at 1
    timed += [(f"{ncfg.name}", M, "float32", s)
              for M in (*sorted(set(DN_PAGED_PROMPTS), reverse=True),
                        len(DN_PAGED_PROMPTS), 1)
              for s in fp_layer_linears(ncfg)]
    # phase 15: qwen2.5-3b's training step at 8 x 256 tokens, forward,
    # remat and wi0's act="none" recompute (wi1's key)
    timed += [("qwen2.5-3b train", TRAIN_BATCH * TRAIN_SEQ, "bfloat16", s)
              for s in fp_layer_linears(qcfg)]
    # phases 16-17: rwkv6-3b's time-mix wo and each family's linears (a
    # Mamba2 layer's wo too; granite-20b's GELU MLP wi and wo, its GELU
    # after the kernel) at the same 8 x 256 tokens, forward, remat and the
    # gated MLP's act="none" recompute (its wi1's key)
    timed += [("rwkv6-3b train wo", TRAIN_BATCH * TRAIN_SEQ, "bfloat16",
               (rcfg.d_model, rcfg.d_model, "none", False))]
    timed += [(f"{c.name} train", TRAIN_BATCH * TRAIN_SEQ, "bfloat16", s)
              for c in (gcfg, dcfg, zcfg, hcfg, ncfg, grcfg)
              for s in fp_layer_linears(c) + ([z_wo] if c is zcfg else [])]
    # phase 10: the conv workloads' fc layers and the fc stack, fp32
    timed += [(label, M, "float32", (K, N, "none", True))
              for label, (M, K, N) in conv_path["fp"]]
    rows, seen = [], set()
    for label, M, dname, (K, N, act, has_bias) in timed:
        if (M, K, N, dname, act) in seen:   # one row a launch key: deepseek's
            continue                        # M 2 wo is qwen's M 2 wq / wo
        seen.add((M, K, N, dname, act))
        dt = dts[dname]
        x, w, b = inputs(M, K, N, dt)
        b = b if has_bias else None
        got = sl.swap_linear(x, w, b, act=act)
        want, p_ms = plain_call(torch, lambda: sl.swap_linear_plain(
            x, w, b, act=act))
        err, rel = rel_err(torch, got, want)
        require(rel <= TOL[dname], f"swap_linear timing case {(M, K, N)} "
                f"rel {rel:.3g}")
        k_ms = time_ms(torch, lambda: sl.swap_linear(x, w, b, act=act))
        fn = {"silu": torch.nn.functional.silu,
              "gelu": lambda r: torch.nn.functional.gelu(
                  r, approximate="tanh")}.get(act)

        def lib():
            r = torch.addmm(b, x, w) if b is not None else x @ w
            return fn(r) if fn else r
        _, lrel = rel_err(torch, lib(), want)
        require(lrel <= TOL[dname], f"swap_linear library yardstick "
                f"{(M, K, N)}: {lrel:.3g}")
        l_ms = time_ms(torch, lib)
        xs = x.element_size()
        shape = (f"{label} M={M} K={K} N={N} {dname} act={act}"
                 f"{' +bias' if b is not None else ''}")
        nbytes = (M * K * xs + K * N * w.element_size()
                  + (N * xs if b is not None else 0) + M * N * xs)
        core = gemm_plan.plan(M, N, K, dname, "bf16" if dname == "bfloat16"
                              else "fp32").core
        rows.append({
            "name": "swap_linear", "route": "cuda",
            "source": "src/repro_torch/csrc/swap_linear.cu",
            "replaces": "src/repro/kernels/swap_linear.py:36",
            "key": (M, K, N, dname, act, core),
            "shape": shape,
            "max_abs_err": err, "ms": k_ms, "kernel_ms": k_ms,
            "plain_ms": p_ms, **bound(nbytes, 2.0 * M * N * K, dname, core),
            "library_ms": l_ms, "path": core})
        del x, w, b, got, want
    for r in rows:
        print(f"  swap_linear {r['shape']:58s} ({r['path']}) kernel "
              f"{r['ms']:.4f} ms{earlier(r)}  plain {r['plain_ms']:.4f} ms  "
              f"library {r['library_ms']:.4f} ms  {bound_note(r)}",
              flush=True)
    torch.cuda.empty_cache()
    return rows


# ------------------------------------------------------------ flash attention
def fa_inputs(torch, seed, B, S, H, KV, hd, dtype, shuffled=False, dv=None):
    """q [B,S,H,hd], k [B,S,KV,hd], v [B,S,KV,dv] (dv None: hd) ~ 0.5 N(0,
    1) and int32 positions (an arange, or a permutation per row), on the
    card."""
    import numpy as np
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    q, k, v = ((torch.randn((B, S, n, d), generator=g, device="cuda")
                * 0.5).to(dtype) for n, d in ((H, hd), (KV, hd),
                                              (KV, dv or hd)))
    rng = np.random.default_rng(seed)
    pos = (np.stack([rng.permutation(S) for _ in range(B)]) if shuffled
           else np.broadcast_to(np.arange(S), (B, S)))
    return q, k, v, torch.tensor(pos, dtype=torch.int32, device="cuda")


def attended_pairs(S, window, chunk=None) -> int:
    """(query, key) pairs a causal prefill of S tokens attends to under a
    window and a block-local chunk (None: none), per batch row and head."""
    w = S if window is None else min(window, S)
    c = S if chunk is None else chunk
    return sum(min(i + 1, w, i % c + 1) for i in range(S))


# (label, dtype, B, S, H, KV, hd, dv, scale, window, softcap, chunk[,
# causal]; causal unless a row says): the main paths' prefills.
# qwen2.5-3b's swapped prefill (phase 3, bf16) and its paged admissions
# (phase 4: run A fp32, run B bf16, one prompt each);
# gemma2-9b's 4,200-token prefill (phases 4 C and 6) and its 24-token
# admission (4 C)
FA_TIMED = [("qwen2.5-3b prefill", "bfloat16", BATCH, PROMPT, 16, 2, 128,
             128, QWEN_SCALE, None, None, None)]
FA_TIMED += [("qwen2.5-3b admission", dname, 1, S, 16, 2, 128, 128,
              QWEN_SCALE, None, None, None)
             for dname in ("float32", "bfloat16") for S in PAGED_PROMPTS]
FA_TIMED += [("gemma2-9b prefill", "bfloat16", 1, S, 16, 8, 256, 256,
              GEMMA_SCALE, window, 50.0, None) for S in (GEMMA_PREFILL, 24)
             for window in (4096, None)]
# phase 7: both tenants' 32-token prefills (qwen's paged admissions too)
FA_TIMED += [("qwen2.5-3b multi-tenant", "bfloat16", 1, P7_PROMPT, 16, 2,
              128, 128, QWEN_SCALE, None, None, None)]
FA_TIMED += [("gemma2-9b multi-tenant", "bfloat16", 1, P7_PROMPT, 16, 8, 256,
              256, GEMMA_SCALE, window, 50.0, None) for window in (4096, None)]
# phase 8: the mcu profile's 2 x 16 prefills (calibration and serving)
FA_TIMED += [("qwen2.5-3b mcu", "bfloat16", P8_BATCH, P8_SEQ, 16, 2, 128,
              128, QWEN_SCALE, None, None, None)]
# phase 9: llama4-scout's 8,704-token prefill and its paged admissions,
# chunk 8192 on the local layers 0-2 and none on the global layer 3
FA_TIMED += [(f"llama4-scout {what}", "bfloat16", 1, S, 40, 8, 128, 128,
              LLAMA_SCALE, None, None, chunk)
             for what, S in [("prefill", LLAMA_PROMPT)]
             + [("admission", n) for n in LLAMA_PAGED_PROMPTS]
             for chunk in (LLAMA_CHUNK, None)]
# phase 11: deepseek-v2-lite's MLA (q, k at 192, v at 128, 16 heads each)
# over its 4,096-token prefill and the in-memory engine's 2 x 4 prompts
FA_TIMED += [(f"deepseek-v2-lite {what}", "bfloat16", B, S, 16, 16, 192, 128,
              DS_SCALE, None, None, None)
             for what, B, S in [("prefill", 1, DS_PROMPT),
                                ("engine", DS_BATCH, DS_DECODE_PROMPT)]]
# phase 12: zamba2-7b's shared attention block (32 / 32 heads of 112, the
# tensor cores at the padded width 128) over its 4,096-token prefill and
# the in-memory engine's 2 x 4 prompts
FA_TIMED += [(f"zamba2-7b {what}", "bfloat16", B, S, 32, 32, 112, 112,
              Z_SCALE, None, None, None)
             for what, B, S in [("prefill", 1, Z_PROMPT),
                                ("engine", Z_BATCH, Z_DECODE_PROMPT)]]
# phase 13: qwen2-vl-72b (64 / 8 heads of 128) over its 2,048-token
# prefill and its paged admissions; phase 14: hubert-xlarge's
# bidirectional encoder (16 / 16 heads of 80, the tensor cores at the
# padded width 128) over 2 x 1,500 frames
FA_TIMED += [(f"qwen2-vl {what}", "bfloat16", 1, S, 64, 8, 128, 128,
              VL_SCALE, None, None, None)
             for what, S in [("prefill", VL_PROMPT)]
             + [("admission", n) for n in VL_PAGED_PROMPTS]]
FA_TIMED += [("hubert-xlarge encoder", "bfloat16", HB_BATCH, HB_FRAMES, 16,
              16, 80, 80, HB_SCALE, None, None, None, False)]
# phase 19 (b): h2o-danube-3-4b's paged admissions in fp32 (32 / 8 heads of
# 120, window 4096; three-pass TF32); phase 20: granite-20b's first pass and
# paged admissions in bf16 (48 query heads of 128 on one KV head)
FA_TIMED += [("h2o-danube admission", "float32", 1, S, 32, 8, 120, 120,
              DN_SCALE, 4096, None, None) for S in sorted(set(
                  DN_PAGED_PROMPTS))]
FA_TIMED += [("granite-20b prefill", "bfloat16", 1, S, 48, 1, 128, 128,
              GR_SCALE, None, None, None)
             for S in sorted({GR_PROMPT, *GR_PAGED_PROMPTS})]
# phase 15: qwen2.5-3b's training step, 8 x 256 tokens (forward and remat)
FA_TIMED += [("qwen2.5-3b train", "bfloat16", TRAIN_BATCH, TRAIN_SEQ, 16, 2,
              128, 128, QWEN_SCALE, None, None, None)]
# phase 17: each family's training step at 8 x 256 (forward and remat):
# gemma2-9b's local and global layers (hd 256, softcap 50), deepseek's MLA
# (192 / 128), zamba2's shared block (hd 112) and hubert's encoder (hd 80,
# no causal mask), the last two at the padded width 128; h2o-danube's 32 /
# 8 heads of 120 (padded to 128; its window 4096 masks nothing at 256
# tokens) and granite-20b's 48 / 1 heads of 128
TRAIN_ATTN = [("gemma2-9b train", 16, 8, 256, 256, GEMMA_SCALE, window, 50.0,
               True) for window in (4096, None)]
TRAIN_ATTN += [("deepseek-v2-lite train", 16, 16, 192, 128, DS_SCALE, None,
                None, True),
               ("zamba2-7b train", 32, 32, 112, 112, Z_SCALE, None, None,
                True),
               ("hubert-xlarge train", 16, 16, 80, 80, HB_SCALE, None, None,
                False),
               ("h2o-danube train", 32, 8, 120, 120, DN_SCALE, 4096, None,
                True),
               ("granite-20b train", 48, 1, 128, 128, GR_SCALE, None, None,
                True)]
FA_TIMED += [(label, "bfloat16", TRAIN_BATCH, TRAIN_SEQ, H, KV, hd, dv, scale,
              window, cap, None, causal)
             for label, H, KV, hd, dv, scale, window, cap, causal
             in TRAIN_ATTN]
# phase 17's fp32 identities in three-pass TF32 where no other fp32 row
# holds their shape: h2o-danube's 1 x 4,352 tokens under its 4,096 window
# (the window cuts the last 256 queries' first keys) and granite-20b's 8 x
# 256 at G 48: (label, B, S, H, KV, hd, scale, window)
TRAIN_ID_ATTN = [("h2o-danube train identity", *DN_TRAIN_ID, 32, 8, 120,
                  DN_SCALE, 4096),
                 ("granite-20b train identity", TRAIN_BATCH, TRAIN_SEQ, 48, 1,
                  128, GR_SCALE, None)]
FA_TIMED += [(label, "float32", B, S, H, KV, hd, hd, scale, window, None,
              None) for label, B, S, H, KV, hd, scale, window in TRAIN_ID_ATTN]


# the pairs the tensor-core kernel takes at widths padded up to one of its
# instantiations (fa.TC_HEAD_DIMS): hubert's 80, zamba2's 112 and
# h2o-danube's 120 (to 128) and the reduced MLA's (48, 32) (to 64)
FA_PADDED = ((80, 80), (112, 112), (120, 120), (48, 32))
# the timed rows also held against compiled flex_attention beside SDPA:
# zamba2's long causal prefill at hd 112, a head dim the tensor-core kernel
# reaches only padded
FA_FLEX_TOO = {"zamba2-7b prefill"}


def fa_library(torch, q, k, v, want, label, dname, B, S, H, KV, scale,
               window, softcap, chunk, flex_too=False, causal=True):
    """(name, device ms, {name: ms}) of PyTorch calls computing a timed
    row's attention, on [B, heads, S, hd] copies made beforehand (not
    timed): SDPA, or compiled flex_attention where the softcap needs a
    score_mod or the chunk a block-local mask_mod. With a value head dim
    of its own (MLA) the first of the two that takes it and agrees with
    the plain version; (None, None) where neither does. ``flex_too`` also
    times compiled flex_attention beside SDPA, in the dict, where it takes
    the row and agrees (printed, not the row's library call)."""
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    G = H // KV

    def sdpa_call():
        kr = kt.repeat_interleave(G, dim=1)
        vr = vt.repeat_interleave(G, dim=1)
        mask = None
        if window is not None:
            i = torch.arange(S, device="cuda")
            mask = (i[None, :] <= i[:, None]) & (
                i[:, None] - i[None, :] < window)
        return lambda: sdpa(qt, kr, vr, attn_mask=mask,
                            is_causal=causal and mask is None, scale=scale)

    def flex_call():
        from torch.nn.attention import flex_attention as flex_mod
        flex = torch.compile(flex_mod.flex_attention, dynamic=False)

        def capped(s, b, h, q_idx, kv_idx):
            return softcap * torch.tanh(s / softcap)

        def live(b, h, q_idx, kv_idx):
            m = kv_idx <= q_idx if causal else kv_idx >= 0
            if window is not None:
                m = m & (q_idx - kv_idx < window)
            if chunk is not None:
                m = m & (q_idx // chunk == kv_idx // chunk)
            return m
        block_mask = flex_mod.create_block_mask(live, B, None, S, S,
                                                device="cuda")
        return lambda: flex(qt, kt, vt,
                            score_mod=capped if softcap is not None else None,
                            block_mask=block_mask, scale=scale,
                            enable_gqa=True)

    if q.shape[-1] == v.shape[-1]:
        calls = [("sdpa", sdpa_call) if softcap is None and chunk is None
                 else ("flex_attention", flex_call)]
        if flex_too and calls[0][0] == "sdpa":
            calls.append(("flex_attention", flex_call))
    else:
        calls = [("sdpa", sdpa_call), ("flex_attention", flex_call)]
    found = []
    for name, make in calls:
        extra = bool(found)         # flex_too's call: printed, never held
        try:
            lib = make()
            _, lrel = rel_err(torch, lib().transpose(1, 2), want)
        except (RuntimeError, ValueError, NotImplementedError) as e:
            require(q.shape[-1] != v.shape[-1] or extra, f"flash_attention "
                    f"library yardstick {name} {label} S={S}: {e}")
            print(f"  flash_attention {label}: {name} does not take this "
                  f"row ({type(e).__name__}: {str(e)[:120]})", flush=True)
            continue
        if (q.shape[-1] != v.shape[-1] or extra) and lrel > TOL[dname]:
            print(f"  flash_attention {label}: {name} disagrees with the "
                  f"plain version (rel {lrel:.3g})", flush=True)
            continue
        require(lrel <= TOL[dname], f"flash_attention library yardstick "
                f"{label} S={S}: {lrel:.3g}")
        found.append((name, time_ms(torch, lib)))
        if not flex_too:
            break
    if not found:
        return None, None, {}
    return found[0][0], found[0][1], dict(found[1:])


def check_flash_attention(torch):
    """Phase 2 for B4: the kernel against its plain version over the
    reference test's masks, the main paths' shapes, odd head dims, a value
    head dim of its own (MLA) and shuffled positions, then timed at the
    main paths' shapes beside SDPA (no softcap) or compiled flex_attention
    (softcap, chunk) (``fa_library``). Returns the rows."""
    from repro_torch.kernels import flash_attention as fa
    dts = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    # (causal, window, softcap, chunk); a chunk of 48 or 64 cuts S of 129
    # and more at one to 87 block-local boundaries
    masks = [(True, None, None, None), (True, 7, None, None),
             (True, None, 50.0, None), (False, None, None, None),
             (True, 64, 30.0, None), (True, None, None, 48),
             (True, 20, 50.0, 64)]
    # (B, S, H, KV, hd, dv, scale, shuffled positions); then deepseek-v2's
    # MLA (q, k at 192, v at 128), its reduced (48, 32), zamba2's shared
    # block (32 / 32 heads of 112) and hubert's encoder (16 / 16 of 80)
    shapes = [(1, 256, 4, 2, 64, 64, None, False),
              (BATCH, PROMPT, 16, 2, 128, 128, QWEN_SCALE, False),
              (1, 37, 16, 2, 128, 128, QWEN_SCALE, False),
              (1, 129, 16, 2, 128, 128, QWEN_SCALE, False),
              (1, 300, 16, 8, 256, 256, GEMMA_SCALE, False),
              (2, 37, 4, 2, 80, 80, None, False),
              (1, 100, 8, 1, 120, 120, None, False),
              (2, 129, 4, 4, 64, 64, None, True),
              (1, 300, 16, 16, 192, 128, DS_SCALE, False),
              (2, 37, 4, 4, 48, 32, None, True),
              (1, 300, 32, 32, 112, 112, Z_SCALE, False),
              (HB_BATCH, HB_FRAMES, 16, 16, 80, 80, HB_SCALE, False)]
    n_checked, worst = 0, {"float32": 0.0, "bfloat16": 0.0}
    for i, (B, S, H, KV, hd, dv, scale, shuffled) in enumerate(shapes):
        for dname, dt in dts.items():
            q, k, v, pos = fa_inputs(torch, 300 + i, B, S, H, KV, hd, dt,
                                     shuffled, dv=dv)
            for causal, window, softcap, chunk in masks:
                kw = dict(scale=hd ** -0.5 if scale is None else scale,
                          causal=causal, window=window, softcap=softcap,
                          chunk=chunk)
                got = fa.flash_attention(q, k, v, pos, **kw)
                want = fa.flash_attention_plain(q, k, v, pos, **kw)
                _, rel = rel_err(torch, got, want)
                require(bool(torch.isfinite(got).all())
                        and tuple(got.shape) == (B, S, H, dv),
                        f"flash_attention non-finite or misshapen at "
                        f"{(B, S, H, KV, hd, dv)}")
                require(rel <= TOL[dname],
                        f"flash_attention {dname} {(B, S, H, KV, hd, dv)} "
                        f"causal {causal} window {window} softcap "
                        f"{softcap} chunk {chunk}: rel err {rel:.3g} > "
                        f"{TOL[dname]}")
                worst[dname] = max(worst[dname], rel)
                n_checked += 1
    # the tensor-core kernel at S of one or two tokens, around its 64-key
    # and 128-row tiles and at gemma2-9b's 4,200, at each instantiation and
    # at the pairs it takes padded (FA_PADDED)
    for hd, dv in fa.TC_HEAD_DIMS + FA_PADDED:
        for i, S in enumerate((1, 2, 63, 64, 65, 127, 128, 129, 4200)):
            q, k, v, pos = fa_inputs(torch, 400 + i, 2 if S < 4200 else 1, S,
                                     4, 2, hd, torch.bfloat16, dv=dv)
            for causal, window, softcap, chunk in masks:
                kw = dict(scale=hd ** -0.5, causal=causal, window=window,
                          softcap=softcap, chunk=chunk)
                got = fa.flash_attention(q, k, v, pos, **kw)
                _, rel = rel_err(torch, got, fa.flash_attention_plain(
                    q, k, v, pos, **kw))
                require(rel <= TOL["bfloat16"] and
                        bool(torch.isfinite(got).all()) and
                        fa.path(torch.bfloat16, hd, dv) == "tc",
                        f"flash_attention bf16 S={S} hd={hd} dv={dv} causal "
                        f"{causal}"
                        f" window {window} softcap {softcap} chunk {chunk}: "
                        f"rel {rel:.3g}")
                worst["bfloat16"] = max(worst["bfloat16"], rel)
                n_checked += 1
    # the three-pass TF32 kernel (fp32) at S around its 64-key and 128-row
    # tiles and past them, at both instantiations and the pairs it takes
    # padded (danube's 120, zamba2's 112, the reduced MLA's (48, 32))
    for hd, dv in fa.TF32_HEAD_DIMS + ((120, 120), (112, 112), (48, 32)):
        for i, S in enumerate((1, 63, 65, 129, 700)):
            q, k, v, pos = fa_inputs(torch, 450 + i, 2, S, 4, 2, hd,
                                     torch.float32, i % 2 == 1, dv=dv)
            for causal, window, softcap, chunk in masks:
                kw = dict(scale=hd ** -0.5, causal=causal, window=window,
                          softcap=softcap, chunk=chunk)
                got = fa.flash_attention(q, k, v, pos, **kw)
                _, rel = rel_err(torch, got, fa.flash_attention_plain(
                    q, k, v, pos, **kw))
                require(rel <= TOL["float32"] and
                        bool(torch.isfinite(got).all()) and
                        fa.path(torch.float32, hd, dv) == "tf32x3",
                        f"flash_attention fp32 S={S} hd={hd} dv={dv} causal "
                        f"{causal} window {window} softcap {softcap} chunk "
                        f"{chunk}: rel {rel:.3g}")
                worst["float32"] = max(worst["float32"], rel)
                n_checked += 1
    print(f"flash_attention: {n_checked} cases match the plain version "
          f"(worst rel err fp32 {worst['float32']:.3g} <= 1e-5, bf16 "
          f"{worst['bfloat16']:.3g} <= 2e-2)", flush=True)
    # bitwise: row b of a 4-row call == the 1-row call on that row, and two
    # identical calls agree, on both kernels, with a window and softcap and
    # with llama4's heads under a block-local chunk
    n_bits = 0
    for i, (S, H, KV, hd, dv, dname, masked) in enumerate(
            [(PROMPT, 16, 2, 128, 128, "bfloat16", {}),
             (300, 16, 8, 256, 256, "bfloat16", {}),
             (200, 16, 2, 128, 128, "float32", {}),
             (37, 4, 2, 80, 80, "bfloat16", {}),
             (300, 40, 8, 128, 128, "bfloat16", {"chunk": 128}),
             (300, 40, 8, 128, 128, "float32", {"chunk": 128}),
             (200, 16, 16, 192, 128, "bfloat16", {}),
             (200, 16, 16, 192, 128, "float32", {}),
             (200, 32, 32, 112, 112, "bfloat16", {}),
             (HB_FRAMES, 16, 16, 80, 80, "bfloat16", {"causal": False}),
             (300, 32, 8, 120, 120, "bfloat16", {}),
             (300, 32, 8, 120, 120, "float32", {}),
             (256, 48, 1, 128, 128, "float32", {}),
             (200, 32, 32, 112, 112, "float32", {"causal": False})]):
        q, k, v, pos = fa_inputs(torch, 500 + i, 4, S, H, KV, hd, dts[dname],
                                 dv=dv)
        kw = dict(scale=hd ** -0.5, **(masked or {"window": 64,
                                                  "softcap": 50.0}))
        full = fa.flash_attention(q, k, v, pos, **kw)
        require(torch.equal(full, fa.flash_attention(q, k, v, pos, **kw)),
                f"flash_attention {dname} S={S} hd={hd} dv={dv}: two "
                f"identical calls differ")
        for b in range(4):
            one = fa.flash_attention(*(t[b:b + 1].contiguous()
                                       for t in (q, k, v, pos)), **kw)
            require(torch.equal(full[b:b + 1], one),
                    f"flash_attention {dname} S={S} hd={hd} dv={dv}: row {b} "
                    f"of a 4-row call differs from its 1-row call")
        n_bits += 5
    # a block-local chunk of S or more runs the tiles and the arithmetic of
    # no chunk
    for dname, hd in (("bfloat16", 128), ("float32", 128)):
        q, k, v, pos = fa_inputs(torch, 520, 1, 300, 40, 8, hd, dts[dname])
        kw = dict(scale=hd ** -0.5)
        require(torch.equal(fa.flash_attention(q, k, v, pos, chunk=300, **kw),
                            fa.flash_attention(q, k, v, pos, **kw)),
                f"flash_attention {dname}: a chunk of S differs from none")
        n_bits += 1
    print(f"flash_attention: {n_bits} bitwise checks pass (rows of 4-row "
          f"calls == their 1-row calls, repeated calls equal, a chunk of S "
          f"== no chunk; the bf16 and three-pass TF32 tensor-core kernels "
          f"and the CUDA-core kernel)", flush=True)
    torch.cuda.synchronize()

    rows, timed_library = [], {}
    for row in FA_TIMED:
        (label, dname, B, S, H, KV, hd, dv, scale, window, softcap,
         chunk), causal = row[:12], (row[12] if len(row) > 12 else True)
        dt = dts[dname]
        q, k, v, pos = fa_inputs(torch, 9, B, S, H, KV, hd, dt, dv=dv)
        kw = dict(scale=scale, causal=causal, window=window, softcap=softcap,
                  chunk=chunk)
        got = fa.flash_attention(q, k, v, pos, **kw)
        want, p_ms = plain_call(torch, lambda: fa.flash_attention_plain(
            q, k, v, pos, **kw))
        err, rel = rel_err(torch, got, want)
        require(rel <= TOL[dname], f"flash_attention timing case {label} "
                f"S={S}: rel {rel:.3g}")
        k_ms = time_ms(torch, lambda: fa.flash_attention(q, k, v, pos, **kw))
        # zamba2's long causal prefill (FA_FLEX_TOO) is also timed beside
        # compiled flex_attention (a compile of its own). A
        # window or chunk of S or more masks nothing: the library call
        # goes without it, and a row that differs from a timed one only
        # there (the same seeded inputs, the same function) takes that
        # row's library time rather than another compile
        lib_window = None if window is None or window >= S else window
        lib_chunk = None if chunk is None or chunk >= S else chunk
        lib_key = (B, S, H, KV, hd, dv, dname, causal, lib_window, softcap,
                   lib_chunk)
        if lib_key not in timed_library:
            timed_library[lib_key] = fa_library(
                torch, q, k, v, want, label, dname, B, S, H, KV, scale,
                lib_window, softcap, lib_chunk, causal=causal,
                flex_too=label in FA_FLEX_TOO)
        lib_name, l_ms, also = timed_library[lib_key]
        es = q.element_size()
        nbytes = ((B * S * H * hd + B * S * KV * hd + B * S * KV * dv
                   + B * S * H * dv) * es + B * S * 4)
        pairs = attended_pairs(S, window, chunk) if causal else S * S
        ops = 2.0 * (hd + dv) * H * B * pairs
        kernel = fa.path(dt, hd, dv)
        rows.append({
            "name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:26",
            "key": (B, S, H, KV, hd, dv, dname, causal, window, softcap,
                    chunk, kernel),
            "shape": f"{label} B={B} S={S} {H}/{KV} heads hd={hd} {dname} "
                     f"window={window} softcap={softcap}"
                     + ("" if causal else " non-causal")
                     + (f" chunk={chunk}" if chunk is not None else "")
                     + (f" dv={dv}" if dv != hd else ""),
            "max_abs_err": err, "ms": k_ms, "kernel_ms": k_ms,
            "plain_ms": p_ms, **bound(nbytes, ops, dname, kernel),
            "library_ms": l_ms, "library_call": lib_name,
            "also": also, "path": kernel})
        del q, k, v, got, want
    for r in rows:
        lib = ("none takes dv != hd" if r["library_ms"] is None else
               f"{r['library_ms']:.4f} ms ({r['library_call']})"
               + "".join(f", {n} {ms:.4f} ms" for n, ms in r["also"].items()))
        print(f"  flash_attention {r['shape']:78s} ({r['path']}) kernel "
              f"{r['ms']:.4f} ms{earlier(r)}  plain {r['plain_ms']:.4f} ms  "
              f"library {lib}  {bound_note(r)}", flush=True)
    torch.cuda.empty_cache()
    return rows


# ------------------------------------------------------------- training
def backward_grads(torch, fn, leaves, dy):
    """(fn's output, the leaves' gradients) after ``fn().backward(dy)``."""
    for t in leaves:
        t.grad = None
    out = fn()
    out.backward(dy)
    return out.detach(), [t.grad for t in leaves]


def check_train_grads(torch, qcfg):
    """Phase 2 for training: ``swap_linear`` and ``flash_attention`` under
    autograd (``SwapLinearFn``, ``FlashAttentionFn``: the kernel forward,
    the torch-op backward) against autograd through their plain versions
    on the same inputs, at phase 15's shapes (qwen2.5-3b's linears at M
    2,048, attention at 8 x 256 with 16 / 2 heads of 128) and
    ``flash_attention`` at each phase 17 family's (``TRAIN_ATTN``, and
    h2o-danube's 1 x 4,352 under its window, ``TRAIN_ID_ATTN``), in fp32
    and bf16: the output and every input's gradient within 1e-5 / 2e-2 of
    the largest value. Then ``wkv6`` under ``WKV6Fn`` at phase 16's rows
    (``check_wkv6_grads``)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import swap_linear as sl
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(2468)
    dts = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    M = TRAIN_BATCH * TRAIN_SEQ
    worst, n = {"float32": 0.0, "bfloat16": 0.0}, 0

    def rnd(shape, scale, dt):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dt)

    def hold(dname, what, got, want):
        nonlocal n
        for a, b in zip(got, want):
            _, rel = rel_err(torch, a, b)
            require(a.dtype == b.dtype and rel <= TOL[dname],
                    f"{what} {dname}: gradient rel err {rel:.3g} > "
                    f"{TOL[dname]}")
            worst[dname] = max(worst[dname], rel)
            n += 1

    attn = [(label, TRAIN_BATCH, TRAIN_SEQ, *shape) for label, *shape in
            [("qwen2.5-3b train", 16, 2, 128, 128, QWEN_SCALE, None, None,
              True)] + TRAIN_ATTN]
    attn += [(label, B, S, H, KV, hd, hd, scale, window, None, True)
             for label, B, S, H, KV, hd, scale, window in TRAIN_ID_ATTN
             if (B, S) != (TRAIN_BATCH, TRAIN_SEQ)]
    for dname, dt in dts.items():
        for K, N, act, has_bias in fp_layer_linears(qcfg):
            x, w = rnd((M, K), 0.5, dt), rnd((K, N), K ** -0.5, dt)
            b = rnd((N,), 0.1, dt) if has_bias else None
            leaves = [t.requires_grad_(True) for t in (x, w, b)
                      if t is not None]
            dy = rnd((M, N), 1.0, dt)
            y, got = backward_grads(
                torch, lambda: sl.swap_linear(x, w, b, act=act), leaves, dy)
            y0, want = backward_grads(
                torch, lambda: sl.swap_linear_plain(x, w, b, act=act),
                leaves, dy)
            hold(dname, f"SwapLinearFn {(M, K, N, act)}", [y] + got,
                 [y0] + want)
        for label, B, S, H, KV, hd, dv, scale, window, cap, causal in attn:
            q, k, v = (rnd((B, S, h, d), 1.0, dt).requires_grad_(True)
                       for h, d in ((H, hd), (KV, hd), (KV, dv)))
            pos = torch.arange(S, device=dev).expand(B, S)
            dy = rnd((B, S, H, dv), 1.0, dt)
            kw = dict(scale=scale, causal=causal, window=window, softcap=cap)
            out, got = backward_grads(torch, lambda: fa.flash_attention(
                q, k, v, pos, **kw), [q, k, v], dy)
            out0, want = backward_grads(
                torch, lambda: fa.flash_attention_plain(q, k, v, pos, **kw),
                [q, k, v], dy)
            hold(dname, f"FlashAttentionFn {label} {(B, S, H, KV, hd, dv)}",
                 [out] + got, [out0] + want)
            del q, k, v, dy, out, got, out0, want
    torch.cuda.synchronize()
    print(f"training: SwapLinearFn at phase 15's shapes and "
          f"FlashAttentionFn at phases 15 and 17's ({len(attn)} shapes, "
          f"danube's {DN_TRAIN_ID[0]} x {DN_TRAIN_ID[1]} under its window "
          f"among them) "
          f"match autograd through the plain versions in {n} outputs and "
          f"gradients (worst rel err fp32 {worst['float32']:.3g} <= 1e-5, "
          f"bf16 {worst['bfloat16']:.3g} <= 2e-2)", flush=True)
    torch.cuda.empty_cache()
    check_wkv6_grads(torch)


def check_wkv6_grads(torch):
    """``wkv6`` under autograd (``WKV6Fn``: the kernel forward,
    ``wkv6_grad``'s torch-op backward) at phase 16's rows (BH 320, S 256,
    hd 64, fp32, ``wkv6_inputs``: row 0 at the clamp) against autograd
    through ``wkv6_plain`` in float64 on the same inputs: from a zero state
    with the loss on y alone (the training path) and from a state that
    requires grad with the loss reading the final state too. y, the final
    state and every gradient within 1e-5 of the largest value. (Autograd
    through the fp32 plain version is itself 1e-5 to 3e-5 off at the
    clamp: it sums the decay's gradient as a difference of terms up to
    e^5 larger.) Then the backward alone timed at the training rows."""
    from repro_torch.kernels import wkv6 as kw
    BH, S, hd = RWKV_TRAIN_BH, TRAIN_SEQ, 64
    g = torch.Generator(device="cuda")
    g.manual_seed(1357)
    worst, n = 0.0, 0
    for state in (False, True):
        args = wkv6_inputs(torch, 610 + state, BH, S, hd, torch.float32,
                           state)
        dy = torch.randn((BH, S, hd), generator=g, device="cuda")
        ds = (torch.randn((BH, hd, hd), generator=g, device="cuda")
              if state else torch.zeros((BH, hd, hd), device="cuda"))
        outs = []
        for fn, dt in ((kw.wkv6, torch.float32),
                       (kw.wkv6_plain, torch.float64)):
            leaves = [None if t is None else
                      t.detach().to(dt).requires_grad_(True) for t in args]
            y, s_fin = fn(*leaves)
            (torch.sum(y * dy.to(dt))
             + torch.sum(s_fin * ds.to(dt))).backward()
            outs.append([y.detach(), s_fin.detach()]
                        + [t.grad for t in leaves if t is not None])
        got, want = outs
        for a, b in zip(got, want):
            _, rel = rel_err(torch, a, b.to(a.dtype))
            require(bool(torch.isfinite(a).all()) and rel <= TOL["float32"],
                    f"WKV6Fn {(BH, S, hd)} state {state}: rel err {rel:.3g}"
                    f" > {TOL['float32']}")
            worst = max(worst, rel)
            n += 1
        del args, outs, got, want
    r, k, v, w, u, _ = wkv6_inputs(torch, 612, BH, S, hd, torch.float32,
                                   False)
    dy = torch.randn((BH, S, hd), generator=g, device="cuda")
    zero = torch.zeros((BH, hd, hd), device="cuda")
    f_ms = time_ms(torch, lambda: kw.wkv6(r, k, v, w, u))
    b_ms = time_ms(torch, lambda: kw.wkv6_grad(r, k, v, w, u, None, dy,
                                               zero))
    torch.cuda.synchronize()
    print(f"training: WKV6Fn at BH {BH} S {S} hd {hd} fp32 matches autograd"
          f" through wkv6_plain in float64 in {n} outputs and gradients "
          f"(worst rel err {worst:.3g} <= 1e-5); its backward (wkv6_grad, "
          f"torch ops) {b_ms:.4f} ms against the kernel's forward "
          f"{f_ms:.4f} ms", flush=True)
    del r, k, v, w, u, dy, zero
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- slice
STORES = [
    ("mmap", dict(store_backend="mmap")),
    ("int8-lazy", dict(store_backend="quant", precision="int8")),
    ("int4-lazy", dict(store_backend="quant", precision="int4")),
    ("int8-eager", dict(store_backend="quant", precision="int8",
                        store_options={"eager": True})),
]


def run_slice(torch, cfg, model, params, main_launches):
    import numpy as np
    from repro_torch.core.cost_model import DelayModel
    from repro_torch.core.runtime import SwappedModel
    from repro_torch.kernels import dequant as dq
    from repro_torch.kernels import swap_linear_q as slq
    from repro_torch.tree import tree_map

    reset, collect = launch_counting(main_launches)
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (BATCH, PROMPT)),
                             dtype=torch.int32)
    batch = {"tokens": tokens}
    refs = {}
    results = {}
    for kind, opts in STORES:
        t_store = time.perf_counter()
        with tempfile.TemporaryDirectory() as d:
            sm = SwappedModel(model, params, d, device="cuda", **opts)
            try:
                resident = sum(sm.store.resident_nbytes(u.name)
                               for u in sm.units)
                budget = int(BUDGET_FRACTION * resident)
                sm.engine.ledger.budget = budget          # enforced
                sm.partition(budget, DelayModel(), BATCH, PROMPT)
                require(sm.plan.n_blocks >= 3,
                        f"{kind}: {sm.plan.n_blocks} blocks < 3")
                t_build = time.perf_counter() - t_store
                sm.forward(batch)                                  # warm
                sm.engine.stats.__init__()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                reset()
                logits, st = sm.forward(batch)
                counts = collect()
                max_alloc = torch.cuda.max_memory_allocated()
                es = sm.engine.stats
                require(bool(torch.isfinite(logits).all()),
                        f"{kind}: non-finite logits")
                require(tuple(logits.shape) == (BATCH, 1, cfg.vocab_size),
                        f"{kind}: logits shape {tuple(logits.shape)}")
                require(es.peak_resident <= budget,
                        f"{kind}: peak ledger {es.peak_resident} > {budget}")
                if kind == "mmap":
                    direct = sm.forward_unswapped(batch)
                    require(torch.equal(logits, direct),
                            "mmap: swapped logits != unswapped logits")
                    err = (0.0, 0.0)
                else:
                    bits = 4 if kind.startswith("int4") else 8
                    if bits not in refs:
                        refs[bits] = [tree_map(lambda a: a.cpu(), w)
                                      for w in store_weights(sm)]
                    direct = sm.forward_unswapped(batch,
                                                  unit_params=refs[bits])
                    err = rel_err(torch, logits, direct)
                    require(err[1] <= 2e-2, f"{kind}: swapped vs unswapped "
                            f"dequantized rel err {err[1]:.3g} > 2e-2")
                units_per_pass = 7 * cfg.n_layers + 1
                require(counts["flash_attention"] == cfg.n_layers,
                        f"{kind}: flash_attention launched "
                        f"{counts['flash_attention']} times, expected "
                        f"{cfg.n_layers} (one per layer)")
                fp_linears = 0 if kind.endswith("lazy") else 7 * cfg.n_layers
                require(counts["swap_linear"] == fp_linears,
                        f"{kind}: swap_linear launched "
                        f"{counts['swap_linear']} times, expected "
                        f"{fp_linears}")
                if kind.endswith("lazy"):
                    require(counts["swap_linear_q"] == units_per_pass,
                            f"{kind}: swap_linear_q launched "
                            f"{counts['swap_linear_q']} times, expected "
                            f"{units_per_pass} (1 pass x (7 x {cfg.n_layers}"
                            f" + 1))")
                if kind.endswith("eager"):
                    require(counts["dequant_int8"] > 0,
                            f"{kind}: dequant_int8 never launched")
                stage = {s: es.stage_seconds(s)
                         for s in ("read", "unpack", "dispatch", "exec",
                                   "wait")}
                results[kind] = {
                    "blocks": sm.plan.n_blocks, "points": sm.plan.points,
                    "m": sm.plan.m, "latency_s": st["latency_s"],
                    "budget": budget, "resident": resident,
                    "peak_ledger": es.peak_resident,
                    "peak_device_weights": es.peak_device_weights,
                    "max_memory_allocated": max_alloc,
                    "bytes_swapped": st["bytes_swapped"],
                    "bytes_logical": st["bytes_logical"],
                    "stage_s": stage,
                    "overlap_efficiency": st["overlap_efficiency"],
                    "launches": counts, "err_vs_unswapped": err,
                    "smem_working_set": st["smem_working_set"],
                    "build_s": t_build}
                r = results[kind]
                print(f"[{kind}] blocks={r['blocks']} {r['points']} m={r['m']}"
                      f" latency {r['latency_s'] * 1e3:.1f} ms; peak ledger "
                      f"{r['peak_ledger'] / 1e9:.3f} GB <= budget "
                      f"{budget / 1e9:.3f} GB (resident {resident / 1e9:.3f}"
                      f" GB); device bytes of the resident weights "
                      f"{r['peak_device_weights'] / 1e9:.3f} GB (peak); "
                      f"max_memory_allocated {max_alloc / 1e9:.3f} GB;"
                      f" swapped {r['bytes_swapped'] / 1e9:.3f} GB "
                      f"({r['bytes_logical'] / 1e9:.3f} GB logical)",
                      flush=True)
                print(f"[{kind}] stages s: " + ", ".join(
                    f"{k} {v:.3f}" for k, v in stage.items())
                    + f"; overlap_eff {r['overlap_efficiency']:.3f}; "
                    f"launches {counts}; err vs unswapped (abs, rel) "
                    f"{err[0]:.3g}, {err[1]:.3g}; kernel smem "
                    f"{r['smem_working_set']} B; store build "
                    f"{t_build:.1f} s", flush=True)

                if kind == "int8-lazy":
                    prompt = tokens[:DECODE_BATCH, :DECODE_PROMPT]
                    reset()
                    gen, dstats = sm.decode_loop(
                        prompt, max_new_tokens=DECODE_NEW,
                        max_len=DECODE_PROMPT + DECODE_NEW)
                    counts = collect()
                    passes = DECODE_PROMPT + DECODE_NEW - 1
                    require(counts["swap_linear_q"]
                            == passes * units_per_pass,
                            f"decode: swap_linear_q launched "
                            f"{counts['swap_linear_q']} times, expected "
                            f"{passes * units_per_pass}")
                    require(any(k[0] == DECODE_BATCH for k in
                                slq.launches.by_shape),
                            "decode: no launch at M = 2")
                    require(tuple(gen.shape) == (DECODE_BATCH, DECODE_NEW),
                            f"decode shape {tuple(gen.shape)}")
                    require(bool(((gen >= 0) & (gen < cfg.vocab_size)).all()),
                            "decode: token out of range")
                    require(dstats["peak_resident_mb"] * 1e6 <= budget,
                            "decode: peak ledger over budget")
                    results["decode"] = {"tokens": gen.tolist(),
                                         "wall_s": dstats["wall_s"],
                                         "passes": passes,
                                         "launches": counts}
                    print(f"[decode int8-lazy] {DECODE_BATCH} x {DECODE_NEW} "
                          f"tokens after a {DECODE_PROMPT}-token prompt: "
                          f"{gen.tolist()}; {passes} swapped passes in "
                          f"{dstats['wall_s']:.2f} s; launches {counts}",
                          flush=True)
            finally:
                sm.close()
        torch.cuda.empty_cache()
        print(f"[{kind}] store phase {time.perf_counter() - t_store:.1f} s",
              flush=True)
    return results


# ---------------------------------------------------------------- paged
def resident_params(torch, sm, unit_params):
    """The model's param tree (on the card) from per-unit params aligned
    with ``sm.units``, e.g. the quantized store's per-unit round trip: the
    in-memory reference of a swapped quantized model. Each scanned
    segment's layers are stacked; a shared attention block's segments hold
    ``{}`` and its params sit once under ``shared_attn``. The head unit's
    own ``lm_head`` is kept (the store quantizes the tied head per vocab
    column, not the embedding)."""
    from repro_torch.tree import tree_flatten, tree_map, tree_unflatten
    by_kind = {u.kind: p for u, p in zip(sm.units, unit_params)}
    by_lid = {u.layer_id: p for u, p in zip(sm.units, unit_params)
              if u.layer_id is not None}
    segs = []
    for seg in sm.model.plan:
        if not seg.scanned:
            segs.append({})
            continue
        flat = [tree_flatten(by_lid[lid]) for lid in seg.layer_ids]
        segs.append(tree_unflatten(flat[0][1], [
            torch.stack(ls) for ls in zip(*(f[0] for f in flat))]))
    tree = {"embed": by_kind["embed"]["embed"],
            "final_norm": by_kind["head"]["final_norm"],
            "lm_head": by_kind["head"]["lm_head"], "segments": segs}
    if "shared_attn" in by_kind:
        tree["shared_attn"] = by_kind["shared_attn"]
    return tree_map(lambda a: a.to("cuda"), tree)


def store_weights(sm):
    """Each of ``sm``'s units as its store holds it, a quantized leaf
    widened on the card (``dequant_int8``): bitwise the host round trip of
    the unit (``store.quantized_store.roundtrip``; ``tests/
    test_torch_store.py`` holds the two equal) without quantizing the
    weights on the host again."""
    from repro_torch.kernels.qtensor import materialize_tree
    return [materialize_tree(sm.store.read_unit(u.name).params)
            for u in sm.units]


def one_step_check(torch, sm, kv, ref_params, prompts, reset, collect):
    """Prefill ``prompts`` through the swapped model into the page pool,
    then ONE batched ``decode_step_paged``, held against the in-memory
    ``Model.prefill`` + ``Model.decode_step`` on ``ref_params`` fed the
    same tokens. Returns (worst rel err, launches of that step)."""
    from repro_torch.serving.kv_cache import pad_prefill_cache
    from repro_torch.serving.paged_kv import PagedBatchView
    rids = [1000 + i for i in range(len(prompts))]
    toks = []
    for rid, p in zip(rids, prompts):
        require(kv.alloc(rid, len(p)), f"one-step check: no pages for {rid}")
        state, _ = sm.forward_partial(
            {"tokens": torch.tensor([p], dtype=torch.int32)},
            collect_cache=True)
        pids, slots = kv.slots(rid, range(len(p)))
        for lid, c in state.caches.items():
            kv.write_rows(lid, pids, slots, c["k"][0], c["v"][0])
        toks.append(int(state.logits[0, -1].argmax()))
        del state
    for rid in rids:
        require(kv.extend(rid, 1), f"one-step check: cannot extend {rid}")
    view = PagedBatchView(kv, rids)
    batch = {"token": torch.tensor([[t] for t in toks], dtype=torch.int32),
             "pos": torch.tensor([len(p) for p in prompts])}
    reset()
    logits = sm.decode_step_paged(batch, view)
    counts = collect()
    for rid in rids:
        kv.free(rid)
    model = sm.model
    worst = 0.0
    for i, p in enumerate(prompts):
        tokens = torch.tensor([p], dtype=torch.int32, device="cuda")
        _, cache = model.prefill(ref_params, {"tokens": tokens})
        cache = pad_prefill_cache(model, cache, len(p) + 1, 1)
        want, _ = model.decode_step(ref_params, cache, {
            "token": torch.tensor([[toks[i]]], device="cuda"),
            "pos": torch.tensor([len(p)], device="cuda")})
        del cache
        _, rel = rel_err(torch, logits[i, -1], want[0, -1])
        require(bool(torch.isfinite(logits[i]).all()),
                "one-step check: non-finite logits")
        worst = max(worst, rel)
    torch.cuda.empty_cache()
    return worst, counts


def clipped_seconds(spans, windows) -> float:
    """Seconds of ``spans`` that fall inside ``windows`` (both lists of
    (start, end) on one clock; the windows do not overlap)."""
    return sum(max(0.0, min(e, we) - max(s, ws))
               for s, e in spans for ws, we in windows)


def drive_paged(torch, sm, kv, prompts, new, max_batch, reset, collect):
    """The batch engine over the workload; returns (requests, engine,
    launches, the decode steps' windows on the host clock, the device
    bytes allocated when the run began)."""
    from repro_torch.serving.batch_engine import BatchDecodeEngine
    from repro_torch.serving.engine import Request
    be = BatchDecodeEngine(sm, kv, max_batch=max_batch)
    reqs = [Request(i, list(p), max_new_tokens=n)
            for i, (p, n) in enumerate(zip(prompts, new))]
    for r in reqs:
        be.submit(r)
    windows = []
    step = sm.decode_step_paged

    def timed_step(batch, view):
        t0 = time.perf_counter()
        out = step(batch, view)
        windows.append((t0, time.perf_counter()))
        return out
    sm.decode_step_paged = timed_step
    sm.engine.stats.__init__()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    alloc0 = torch.cuda.memory_allocated()
    reset()
    try:
        be.run_all()
    finally:
        del sm.decode_step_paged
    return reqs, be, collect(), windows, alloc0


def report_paged(torch, tag, sm, kv, be, budget, windows, alloc0):
    st = be.stats()
    es = sm.engine.stats
    led = sm.engine.ledger
    decode_stage = {k: clipped_seconds(es.stage_spans(k), windows)
                    for k in ("read", "unpack", "dispatch", "exec", "wait")}
    n_dec = max(len(windows), 1)
    out = {"tok_per_s": st["tok_per_s"], "prefill_s": st["prefill_s"],
           "decode_s": st["decode_s"], "decode_steps": len(windows),
           "step_ms": st["decode_s"] / n_dec * 1e3,
           "mean_occupancy": st["mean_occupancy"],
           "preemptions": st["preemptions"], "ledger_peak": led.peak,
           "budget": budget, "pool_bytes": kv.pool_bytes,
           "kv_pages_peak": st["kv_pages_peak"],
           "page_bytes": kv.page_bytes,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "allocated_at_start": alloc0,
           "decode_stage_ms": {k: v / n_dec * 1e3
                               for k, v in decode_stage.items()}}
    print(f"[{tag}] {st['tokens_emitted']:.0f} tokens in "
          f"{st['prefill_s'] + st['decode_s']:.2f} s: {st['tok_per_s']:.2f} "
          f"tok/s; prefill {st['prefill_s']:.2f} s, decode "
          f"{st['decode_s']:.2f} s over {len(windows)} steps "
          f"({out['step_ms']:.1f} ms a step); mean occupancy "
          f"{st['mean_occupancy']:.3f}; preemptions {st['preemptions']:.0f}",
          flush=True)
    print(f"[{tag}] ledger peak {led.peak / 1e9:.3f} GB <= budget "
          f"{budget / 1e9:.3f} GB (KV pages peak {st['kv_pages_peak']:.0f} "
          f"x {kv.page_bytes / 1e6:.3f} MB charged); KV pools on the device "
          f"{kv.pool_bytes / 1e9:.3f} GB ({kv.max_pages} pages + the zero "
          f"page, all layers); max_memory_allocated "
          f"{out['max_memory_allocated'] / 1e9:.3f} GB (allocated when the "
          f"run began {alloc0 / 1e9:.3f} GB)", flush=True)
    print(f"[{tag}] decode step ms by stage span: " + ", ".join(
        f"{k} {v:.1f}" for k, v in out["decode_stage_ms"].items()),
        flush=True)
    return out


def check_paged_run(tag, kv, be, counts, n_layers, budget):
    """The checks every paged run shares: pages and ledger clean, peak
    within budget, B3 once per layer per decode step, B4 once per layer
    per admission's prefill."""
    led = kv.ledger
    steps = sum(1 for t in be.trace if t.batch)
    admitted = sum(len(t.admitted) for t in be.trace)
    require(counts["flash_attention"] == n_layers * admitted > 0,
            f"{tag}: flash_attention launched {counts['flash_attention']} "
            f"times, expected {n_layers} x {admitted} admissions")
    require(kv.pages_in_use == 0, f"{tag}: {kv.pages_in_use} pages in use")
    require(led.resident == 0, f"{tag}: {led.resident} bytes left on the "
            f"ledger")
    require(led.peak <= budget, f"{tag}: ledger peak {led.peak} > {budget}")
    require(counts["paged_attention"] == n_layers * steps > 0,
            f"{tag}: paged_attention launched {counts['paged_attention']} "
            f"times, expected {n_layers} x {steps}")


def paged_model(torch, model, params, d, opts, cfg, max_pages, prompt_len):
    """SwappedModel + page pool under one ledger: weights planned at 0.9x
    the store's resident bytes, the ledger enforcing that plus the pool's
    pages (the budget split of ``launch/serve.py --paged``)."""
    from repro_torch.core.cost_model import DelayModel
    from repro_torch.core.runtime import SwappedModel
    from repro_torch.serving.paged_kv import PagedKVCache, page_bytes_for
    sm = SwappedModel(model, params, d, device="cuda", **opts)
    resident = sum(sm.store.resident_nbytes(u.name) for u in sm.units)
    w_budget = int(BUDGET_FRACTION * resident)
    budget = w_budget + max_pages * page_bytes_for(cfg, PAGE_TOKENS)
    sm.engine.ledger.budget = budget                      # enforced
    sm.partition(w_budget, DelayModel(), 1, prompt_len)
    kv = PagedKVCache(cfg, sm.engine.ledger, page_tokens=PAGE_TOKENS,
                      max_pages=max_pages, device="cuda")
    print(f"[{cfg.name} {cfg.dtype} {sm.store_backend}/{sm.precision}] "
          f"blocks={sm.plan.n_blocks} {sm.plan.points} m={sm.plan.m}; "
          f"weight budget {w_budget / 1e9:.3f} GB (0.9 x resident "
          f"{resident / 1e9:.3f} GB) + {max_pages} pages = budget "
          f"{budget / 1e9:.3f} GB", flush=True)
    return sm, kv, budget


def gemma_model(torch, n_layers=GEMMA_LAYERS):
    """gemma2-9b at its published widths, depth cut to ``n_layers``, with
    fp32 weights from seed 0 drawn on the card and copied to the host: the
    source of phases 4 (C) and 6 (2 layers) and of phase 7 (6)."""
    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import Model
    gcfg = dataclasses.replace(get_arch("gemma2-9b"), n_layers=n_layers)
    print(f"model: {gcfg.name} d_model {gcfg.d_model}, {gcfg.n_heads} heads "
          f"/ {gcfg.n_kv_heads} KV heads, head_dim {gcfg.resolved_head_dim}, "
          f"d_ff {gcfg.d_ff}, vocab {gcfg.vocab_size}, window "
          f"{gcfg.sliding_window} on even layers, softcaps "
          f"{gcfg.attn_logit_softcap}/{gcfg.final_logit_softcap}, "
          f"{gcfg.dtype}; reduced: n_layers 42->{n_layers}", flush=True)
    t0 = time.perf_counter()
    gmodel = Model(gcfg)
    gparams = host_copy(torch, gmodel.init(0, device="cuda"))
    print(f"params: {sum(p.numel() for p in _leaves(gparams)) / 1e6:.1f} M "
          f"(fp32, host), init on the card and copied down in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return gmodel, gparams


def run_paged(torch, cfg, model, params, gmodel, gparams, main_launches):
    """Phase 4: paged continuous-batching decode, runs A, B and C."""
    import numpy as np
    from repro_torch.models.transformer import Model
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.kernels import swap_linear_q as slq

    reset, collect = launch_counting(main_launches)
    rng = np.random.default_rng(0)
    prompts = [list(map(int, rng.integers(0, cfg.vocab_size, n)))
               for n in PAGED_PROMPTS]
    L = cfg.n_layers
    results = {}

    # -- Run A: exactness, float32 on mmap
    cfg_a = dataclasses.replace(cfg, dtype="float32")
    model_a = Model(cfg_a)
    t0 = time.perf_counter()
    solo = ServingEngine(model_a, params, max_len=max(PAGED_PROMPTS)
                         + max(PAGED_NEW) + 1, device="cuda")
    want = []
    for p, n in zip(prompts, PAGED_NEW):
        r = Request(0, list(p), max_new_tokens=n)
        solo.generate([r])
        want.append(r.output)
    del solo
    torch.cuda.empty_cache()
    print(f"[A] solo in-memory runs: {want} ({time.perf_counter() - t0:.1f} "
          f"s)", flush=True)
    with tempfile.TemporaryDirectory() as d:
        sm, kv, budget = paged_model(torch, model_a, params, d,
                                     dict(store_backend="mmap"), cfg_a,
                                     PAGED_MAX_PAGES, max(PAGED_PROMPTS))
        try:
            require(sm.plan.n_blocks >= 3, f"A: {sm.plan.n_blocks} blocks")
            reqs, be, counts, windows, alloc0 = drive_paged(
                torch, sm, kv, prompts, PAGED_NEW, PAGED_MAX_BATCH, reset,
                collect)
            results["A"] = report_paged(torch, "A", sm, kv, be, budget,
                                        windows, alloc0)
        finally:
            sm.close()
    got = [r.output for r in reqs]
    require(got == want, f"A: batched tokens {got} != solo {want}")
    tr = be.trace
    require(any(t.admitted and t.batch for t in tr),
            "A: no admission into a running batch")
    require(any(t.retired and t.batch for t in tr), "A: no mid-run retirement")
    require(be.preemptions >= 1, "A: no preemption")
    check_paged_run("A", kv, be, counts, L, budget)
    require(counts["swap_linear"] > 0 and counts["swap_linear_q"] == 0,
            f"A: fp32 mmap linears launched swap_linear "
            f"{counts['swap_linear']} and swap_linear_q "
            f"{counts['swap_linear_q']} times")
    trace_a = [(t.batch, t.admitted, t.retired, t.preempted, t.kv_pages)
               for t in tr]
    print(f"[A] tokens equal the solo runs for all {len(reqs)} requests; "
          f"{len(tr)} steps, preemptions {be.preemptions}, launches "
          f"{counts}", flush=True)
    print(f"[A] trace (batch, admitted, retired, preempted, pages): "
          f"{trace_a}", flush=True)
    torch.cuda.empty_cache()

    # -- Run B: the published dtype, bf16 on int8 lazy
    with tempfile.TemporaryDirectory() as d:
        sm, kv, budget = paged_model(
            torch, model, params, d,
            dict(store_backend="quant", precision="int8"), cfg,
            PAGED_MAX_PAGES, max(PAGED_PROMPTS))
        try:
            require(sm.plan.n_blocks >= 3, f"B: {sm.plan.n_blocks} blocks")
            reqs, be, counts, windows, alloc0 = drive_paged(
                torch, sm, kv, prompts, PAGED_NEW, PAGED_MAX_BATCH, reset,
                collect)
            results["B"] = report_paged(torch, "B", sm, kv, be, budget,
                                        windows, alloc0)
            trace_b = [(t.batch, t.admitted, t.retired, t.preempted,
                        t.kv_pages) for t in be.trace]
            require(trace_b == trace_a, f"B: trace {trace_b} != A's")
            check_paged_run("B", kv, be, counts, L, budget)
            sizes = {len(t.batch) for t in be.trace if t.batch}
            ms = {k[0] for k in slq.launches.by_shape}
            require(sizes <= ms and sizes == {1, 2, 3, 4},
                    f"B: batch sizes {sorted(sizes)} vs swap_linear_q "
                    f"launches at M {sorted(ms)}")
            print(f"[B] trace equals A's; swap_linear_q at M "
                  f"{sorted(m for m in ms if m <= PAGED_MAX_BATCH)} in "
                  f"decode; launches {counts}", flush=True)
            ref = resident_params(torch, sm, store_weights(sm))
            err, step_counts = one_step_check(torch, sm, kv, ref,
                                              prompts[:3], reset, collect)
            del ref
            require(err <= 2e-2, f"B: one-step logits rel err {err:.3g}")
            require(step_counts["paged_attention"] == L,
                    f"B: one step launched paged_attention "
                    f"{step_counts['paged_attention']} times")
            results["B"]["one_step_rel_err"] = err
            print(f"[B] one decode_step_paged on 3 live sequences vs the "
                  f"in-memory model on round-tripped int8 weights: rel err "
                  f"{err:.3g} <= 2e-2", flush=True)
        finally:
            sm.close()
    del model_a
    torch.cuda.empty_cache()

    # -- Run C: gemma2-9b, window and softcap on the path
    gcfg = gmodel.cfg
    grng = np.random.default_rng(1)
    gprompts = [list(map(int, grng.integers(0, gcfg.vocab_size, n)))
                for n in GEMMA_PROMPTS]
    with tempfile.TemporaryDirectory() as d:
        sm, kv, budget = paged_model(
            torch, gmodel, gparams, d,
            dict(store_backend="quant", precision="int8"), gcfg,
            GEMMA_MAX_PAGES, max(GEMMA_PROMPTS))
        try:
            ref = resident_params(torch, sm, store_weights(sm))
            err, step_counts = one_step_check(torch, sm, kv, ref, gprompts,
                                              reset, collect)
            del ref
            torch.cuda.empty_cache()
            require(err <= 2e-2, f"C: one-step logits rel err {err:.3g}")
            print(f"[C] one decode_step_paged vs the in-memory model on "
                  f"round-tripped int8 weights: rel err {err:.3g} <= 2e-2; "
                  f"launches {step_counts}", flush=True)
            reqs, be, counts, windows, alloc0 = drive_paged(
                torch, sm, kv, gprompts, GEMMA_NEW, 2, reset, collect)
            results["C"] = report_paged(torch, "C", sm, kv, be, budget,
                                        windows, alloc0)
            results["C"]["one_step_rel_err"] = err
        finally:
            sm.close()
    check_paged_run("C", kv, be, counts, GEMMA_LAYERS, budget)
    from repro_torch.kernels import paged_attention as pa
    keys = pa.launches.by_shape
    local = sum(n for k, n in keys.items() if k[7] == 4096 and k[8] == 50.0)
    glob = sum(n for k, n in keys.items() if k[7] is None and k[8] == 50.0)
    steps = sum(1 for t in be.trace if t.batch)
    require(local == glob == steps > 0,
            f"C: paged_attention launches window 4096 {local}, no window "
            f"{glob}, decode steps {steps}")
    require([len(r.output) for r in reqs] == GEMMA_NEW, "C: token counts")
    print(f"[C] paged_attention at window 4096 (layer 0) x {local} and no "
          f"window (layer 1) x {glob}, softcap 50; outputs "
          f"{[r.output for r in reqs]}", flush=True)
    return results


# ---------------------------------------------------------------- rwkv6
def report_prefill(tag, sm, st, budget, resident, max_alloc):
    """Print a swapped prefill pass's row, as phase 3 prints its rows."""
    es = sm.engine.stats
    stage = {k: es.stage_seconds(k)
             for k in ("read", "unpack", "dispatch", "exec", "wait")}
    print(f"[{tag}] blocks={sm.plan.n_blocks} {sm.plan.points} "
          f"m={sm.plan.m} latency {st['latency_s'] * 1e3:.1f} ms; peak "
          f"ledger {es.peak_resident / 1e9:.3f} GB <= budget "
          f"{budget / 1e9:.3f} GB (resident {resident / 1e9:.3f} GB); "
          f"device bytes of the resident weights "
          f"{es.peak_device_weights / 1e9:.3f} GB (peak); "
          f"max_memory_allocated {max_alloc / 1e9:.3f} GB; swapped "
          f"{st['bytes_swapped'] / 1e9:.3f} GB", flush=True)
    print(f"[{tag}] stages s: " + ", ".join(
        f"{k} {v:.3f}" for k, v in stage.items())
        + f"; overlap_eff {st['overlap_efficiency']:.3f}", flush=True)
    return {"latency_s": st["latency_s"], "stage_s": stage,
            "peak_ledger": es.peak_resident, "budget": budget,
            "peak_device_weights": es.peak_device_weights,
            "max_memory_allocated": max_alloc,
            "bytes_swapped": st["bytes_swapped"],
            "overlap_efficiency": st["overlap_efficiency"]}


def run_rwkv6(torch, main_launches):
    """Phase 5: rwkv6-3b swapped prefill in float32 and bf16 (B6 on every
    layer), then weight-streaming decode against the in-memory engine."""
    import numpy as np
    from repro_torch.configs import get_arch
    from repro_torch.core.cost_model import DelayModel
    from repro_torch.core.runtime import SwappedModel
    from repro_torch.kernels import wkv6 as kw
    from repro_torch.models.ssm import rwkv6_dims
    from repro_torch.models.transformer import Model
    from repro_torch.store.mmap_store import MmapStore

    reset, collect = launch_counting(main_launches)
    base = dataclasses.replace(get_arch("rwkv6-3b"), n_layers=RWKV_LAYERS)
    nh, hd = rwkv6_dims(base)
    print(f"model: {base.name} d_model {base.d_model}, {nh} WKV heads of "
          f"{hd}, d_ff {base.d_ff}, vocab {base.vocab_size}, tied "
          f"{base.tie_embeddings}, quant_eligible {base.quant_eligible}, "
          f"{base.dtype}; reduced: n_layers 32->{RWKV_LAYERS}", flush=True)
    t0 = time.perf_counter()
    # drawn on the card, then the host holds the store's source
    params = host_copy(torch, Model(base).init(0, device="cuda"))
    print(f"params: {sum(p.numel() for p in _leaves(params)) / 1e6:.1f} M "
          f"(fp32, host), init {time.perf_counter() - t0:.1f} s", flush=True)
    rng = np.random.default_rng(2)
    tokens = torch.as_tensor(rng.integers(0, base.vocab_size,
                                          (RWKV_BATCH, RWKV_PROMPT)),
                             dtype=torch.int32)
    batch = {"tokens": tokens}
    prefill_key = (RWKV_BATCH * nh, RWKV_PROMPT, hd, "float32", False)
    results, logits_by = {}, {}
    for dname in ("float32", "bfloat16"):
        cfg = dataclasses.replace(base, dtype=dname)
        model = Model(cfg)
        tag = f"rwkv6 {dname}"
        with tempfile.TemporaryDirectory() as d:
            # asked for as quant: a quant-ineligible model serves from mmap
            sm = SwappedModel(model, params, d, device="cuda",
                              store_backend="quant")
            try:
                require(sm.store_backend == "mmap" and sm.precision == "fp"
                        and isinstance(sm.store, MmapStore),
                        f"{tag}: store_backend='quant' resolved to "
                        f"{sm.store_backend}/{sm.precision}")
                resident = sum(sm.store.resident_nbytes(u.name)
                               for u in sm.units)
                budget = int(BUDGET_FRACTION * resident)
                sm.engine.ledger.budget = budget          # enforced
                sm.partition(budget, DelayModel(), RWKV_BATCH, RWKV_PROMPT)
                require(sm.plan.n_blocks >= 3,
                        f"{tag}: {sm.plan.n_blocks} blocks < 3")
                sm.forward(batch)                                  # warm
                sm.engine.stats.__init__()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                reset()
                logits, st = sm.forward(batch)
                counts = collect()
                max_alloc = torch.cuda.max_memory_allocated()
                require(counts["wkv6"] == RWKV_LAYERS
                        and set(kw.launches.by_shape) == {prefill_key},
                        f"{tag}: wkv6 launches {kw.launches.by_shape}, "
                        f"expected {RWKV_LAYERS} at {prefill_key}")
                require(counts["swap_linear"] == RWKV_LAYERS,
                        f"{tag}: swap_linear launched "
                        f"{counts['swap_linear']} times, expected "
                        f"{RWKV_LAYERS} (the time-mix output projection)")
                require(bool(torch.isfinite(logits).all()),
                        f"{tag}: non-finite logits")
                require(tuple(logits.shape)
                        == (RWKV_BATCH, 1, cfg.vocab_size),
                        f"{tag}: logits shape {tuple(logits.shape)}")
                require(sm.engine.stats.peak_resident <= budget,
                        f"{tag}: peak ledger over budget")
                require(torch.equal(logits, sm.forward_unswapped(batch)),
                        f"{tag}: swapped logits != unswapped logits")
                print(f"[{tag}] store_backend='quant' resolved to "
                      f"{sm.store_backend}/{sm.precision}; swapped logits "
                      f"== unswapped logits bitwise; launches {counts}",
                      flush=True)
                results[dname] = report_prefill(tag, sm, st, budget,
                                                resident, max_alloc)
                logits_by[dname] = logits
                if dname == "float32":
                    results["one prompt"] = rwkv6_one_prompt(
                        torch, sm, tokens[:1], budget, resident, reset,
                        collect)
                    results["decode"] = rwkv6_decode(
                        torch, sm, model, params, tokens, reset, collect)
            finally:
                sm.close()
        torch.cuda.empty_cache()
    err = rel_err(torch, logits_by["bfloat16"], logits_by["float32"])
    results["bfloat16"]["rel_err_vs_fp32"] = err[1]
    print(f"[rwkv6 bfloat16] logits vs float32: max |err| {err[0]:.4g}, "
          f"max |err| / max |logit| {err[1]:.4g}", flush=True)
    return results


def run_gemma_prefill(torch, gmodel, gparams, main_launches):
    """Phase 6: gemma2-9b bf16, a full-precision swapped prefill of one
    4,200-token prompt on mmap; B4 once per layer (window 4096 on the local
    layer 0, none on the global layer 1), B5 seven times per layer, and the
    logits bitwise equal to the unswapped forward."""
    import numpy as np
    from repro_torch.core.cost_model import DelayModel
    from repro_torch.core.runtime import SwappedModel
    from repro_torch.kernels import flash_attention as fa

    reset, collect = launch_counting(main_launches)
    gcfg = gmodel.cfg
    rng = np.random.default_rng(3)
    tokens = torch.as_tensor(rng.integers(0, gcfg.vocab_size,
                                          (1, GEMMA_PREFILL)),
                             dtype=torch.int32)
    batch = {"tokens": tokens}
    tag = "gemma2-9b bf16 mmap"
    t_store = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        sm = SwappedModel(gmodel, gparams, d, device="cuda",
                          store_backend="mmap")
        try:
            require(sm.precision == "fp", f"{tag}: precision {sm.precision}")
            resident = sum(sm.store.resident_nbytes(u.name)
                           for u in sm.units)
            budget = int(BUDGET_FRACTION * resident)
            sm.engine.ledger.budget = budget              # enforced
            sm.partition(budget, DelayModel(), 1, GEMMA_PREFILL)
            print(f"[{tag}] store of {resident / 1e9:.3f} GB built in "
                  f"{time.perf_counter() - t_store:.1f} s", flush=True)
            sm.forward(batch)                                      # warm
            sm.engine.stats.__init__()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset()
            logits, st = sm.forward(batch)
            counts = collect()
            max_alloc = torch.cuda.max_memory_allocated()
            windows = sorted((k[8] or 0) for k in fa.launches.by_shape
                             for _ in range(fa.launches.by_shape[k]))
            require(counts["flash_attention"] == GEMMA_LAYERS
                    and windows == [0, gcfg.sliding_window],
                    f"{tag}: flash_attention launches "
                    f"{fa.launches.by_shape}, expected one at window "
                    f"{gcfg.sliding_window} and one with none")
            require(all(k[1] == GEMMA_PREFILL and k[9] == 50.0
                        for k in fa.launches.by_shape),
                    f"{tag}: flash_attention keys {fa.launches.by_shape}")
            require(counts["swap_linear"] == 7 * GEMMA_LAYERS,
                    f"{tag}: swap_linear launched {counts['swap_linear']} "
                    f"times, expected {7 * GEMMA_LAYERS}")
            require(counts["swap_linear_q"] == 0, f"{tag}: swap_linear_q "
                    f"launched {counts['swap_linear_q']} times")
            require(bool(torch.isfinite(logits).all()),
                    f"{tag}: non-finite logits")
            require(tuple(logits.shape) == (1, 1, gcfg.vocab_size),
                    f"{tag}: logits shape {tuple(logits.shape)}")
            require(sm.engine.stats.peak_resident <= budget,
                    f"{tag}: peak ledger over budget")
            require(torch.equal(logits, sm.forward_unswapped(batch)),
                    f"{tag}: swapped logits != unswapped logits")
            print(f"[{tag}] swapped logits == unswapped logits bitwise; "
                  f"flash_attention at window 4096 (layer 0) and none "
                  f"(layer 1); launches {counts}", flush=True)
            out = report_prefill(tag, sm, st, budget, resident, max_alloc)
        finally:
            sm.close()
    torch.cuda.empty_cache()
    return out


def rwkv6_one_prompt(torch, sm, tokens, budget, resident, reset, collect):
    """One 512-token prompt through the same swapped fp32 model. Its
    40 WKV rows leave SMs idle at one block a row, so ``wkv6``'s plan
    splits each row's columns across more than one block: the split runs
    on the path, once per layer, and the logits equal the unswapped
    forward's bitwise."""
    from repro_torch.kernels import wkv6 as kw
    from repro_torch.models.ssm import rwkv6_dims
    tag = "rwkv6 float32 one prompt"
    nh, hd = rwkv6_dims(sm.model.cfg)
    key = (nh, tokens.shape[1], hd, "float32", False)
    G = kw.launch_plan(nh, hd, torch.cuda.get_device_properties(0)
                       .multi_processor_count)
    require(G > 1, f"{tag}: wkv6 plans {G} column group at BH {nh}")
    batch = {"tokens": tokens}
    sm.forward(batch)                                              # warm
    sm.engine.stats.__init__()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset()
    logits, st = sm.forward(batch)
    counts = collect()
    max_alloc = torch.cuda.max_memory_allocated()
    require(counts["wkv6"] == RWKV_LAYERS
            and set(kw.launches.by_shape) == {key},
            f"{tag}: wkv6 launches {kw.launches.by_shape}, expected "
            f"{RWKV_LAYERS} at {key}")
    require(bool(torch.isfinite(logits).all()), f"{tag}: non-finite logits")
    require(tuple(logits.shape) == (1, 1, sm.model.cfg.vocab_size),
            f"{tag}: logits shape {tuple(logits.shape)}")
    require(sm.engine.stats.peak_resident <= budget,
            f"{tag}: peak ledger over budget")
    require(torch.equal(logits, sm.forward_unswapped(batch)),
            f"{tag}: swapped logits != unswapped logits")
    print(f"[{tag}] swapped logits == unswapped logits bitwise; wkv6 at BH "
          f"{nh} in {G} column groups a row; launches {counts}", flush=True)
    return report_prefill(tag, sm, st, budget, resident, max_alloc)


def rwkv6_decode(torch, sm, model, params, tokens, reset, collect):
    """(d): ``decode_loop`` (the prompt fed one token at a time, weights
    streamed per step) against the in-memory ``ServingEngine`` on the card,
    whose chunked prefill launches B6 at S = 16."""
    from repro_torch.serving.engine import Request, ServingEngine
    prompt = tokens[:, :RWKV_DECODE_PROMPT]
    max_len = 2 * RWKV_DECODE_PROMPT
    reset()
    gen, dstats = sm.decode_loop(prompt, max_new_tokens=RWKV_DECODE_NEW,
                                 max_len=max_len)
    eng = ServingEngine(model, params, max_len=max_len, device="cuda")
    reqs = [Request(i, list(map(int, p)), max_new_tokens=RWKV_DECODE_NEW)
            for i, p in enumerate(prompt.tolist())]
    estats = eng.generate(reqs)
    counts = collect()
    del eng
    want = [r.output for r in reqs]
    require(gen.tolist() == want,
            f"rwkv6 decode_loop tokens {gen.tolist()} != engine {want}")
    require(counts["wkv6"] == RWKV_LAYERS,
            f"rwkv6 decode: wkv6 launched {counts['wkv6']} times, expected "
            f"{RWKV_LAYERS} (the engine's prefill)")
    passes = RWKV_DECODE_PROMPT + RWKV_DECODE_NEW - 1
    print(f"[rwkv6 decode] decode_loop {gen.tolist()} == ServingEngine "
          f"{want}; {passes} swapped passes in {dstats['wall_s']:.2f} s "
          f"(peak ledger {dstats['peak_resident_mb'] / 1e3:.3f} GB); engine "
          f"prefill {estats['prefill_s'] * 1e3:.1f} ms, "
          f"{estats['tok_per_s']:.1f} tok/s; launches {counts}", flush=True)
    return {"tokens": gen.tolist(), "wall_s": dstats["wall_s"],
            "passes": passes, "engine_prefill_s": estats["prefill_s"]}


# ---------------------------------------------------------------- multi-DNN
def wait_until(cond, timeout: float, what: str) -> None:
    t_end = time.monotonic() + timeout
    while not cond():
        require(time.monotonic() < t_end, f"timed out waiting for {what}")
        time.sleep(0.001)


def p7_slice(budget: int) -> int:
    """One executor's block budget under ``budget``: the arithmetic of
    ``MultiModelRuntime.block_budget`` (the cache and the KV reserve off
    the top; no tenant of phase 7 pins a unit), split over the executors
    as its ``plan`` splits it."""
    rest = (budget - int(budget * P7_RUNTIME["cache_frac"])
            - int(budget * P7_RUNTIME["kv_frac"]))
    return rest // P7_RUNTIME["executors"]


def p7_fits(planners, budget: int) -> list:
    """Per tenant, whether its block plan fits one executor's slice of
    ``budget`` (each planner runs ``best_partition``, as the runtime's
    ``plan`` does through each tenant's ``partition``)."""
    fits = []
    for plan in planners:
        try:
            plan(p7_slice(budget))
            fits.append(True)
        except ValueError:
            fits.append(False)
    return fits


def p7_floor_budget(tenants, dm, batch, seq) -> int:
    """The smallest budget on a P7_GRID grid at which every tenant plans
    with 2 executors, found before any store is built: the runtime's
    planner over each tenant's unit table (a directio unit's resident
    bytes are its host tensors' bytes). ``p7_check_floor`` holds it to
    the built stores."""
    from repro_torch.core.partition import PartitionPlanner
    from repro_torch.core.runtime import split_units, unit_infos
    planners = []
    for model, params in tenants:
        pp = PartitionPlanner(unit_infos(model, split_units(model, params),
                                         batch, seq),
                              dm, m=P7_RUNTIME["prefetch_depth"])
        planners.append(lambda b, pp=pp: pp.best_partition(
            b, P7_RUNTIME["delta"]))
    b = P7_GRID
    while not all(p7_fits(planners, b)):
        b += P7_GRID
        require(b < 10 ** 12, "no feasible budget below 1 TB")
    return b


def p7_check_floor(rt, floor, batch, seq) -> None:
    """The floor against the runtime's tenants on their built stores: the
    slice arithmetic is the runtime's own, every tenant plans at the
    floor and some tenant cannot a grid step below it. Ends with the
    runtime's own ``plan``."""
    require(p7_slice(rt.budget) == rt.block_budget() // rt.executors,
            f"phase 7: slice {p7_slice(rt.budget)} != the runtime's "
            f"{rt.block_budget() // rt.executors}")
    planners = [lambda b, sm=sm: sm.partition(b, rt.dm, batch, seq,
                                              delta=rt.delta)
                for sm in rt.models.values()]
    require(all(p7_fits(planners, floor))
            and not all(p7_fits(planners, floor - P7_GRID)),
            f"phase 7: {floor / 1e9:.1f} GB is not the smallest feasible "
            f"budget on the stores")
    rt.plan(batch, seq)


def p7_check_launches(counts, by_shape) -> None:
    """Phase 7's kernels ran: B5 and B4 for both tenants (told apart by
    K and head_dim in their launch keys: the counts are global and both
    executors launch at once), B3 for qwen's paged decode only."""
    for name in ("swap_linear", "flash_attention", "paged_attention"):
        require(counts[name] > 0, f"phase 7: {name} never launched")
    for tenant, K, hd in (("qwen2.5-3b", 2048, 128), ("gemma2-9b", 3584, 256)):
        require(any(k[1] == K for k in by_shape["swap_linear"]),
                f"phase 7: no swap_linear launch of {tenant}")
        require(any(k[4] == hd for k in by_shape["flash_attention"]),
                f"phase 7: no flash_attention launch of {tenant}")
    require(all(k[3] == 128 for k in by_shape["paged_attention"]),
            "phase 7: paged_attention launched off qwen's decode")


def run_multi(torch, qmodel, qparams, gmodel, gparams, main_launches,
              device="cuda"):
    """Phase 7: the paper's multi-DNN scenario (the workstation profile):
    qwen2.5-3b and gemma2-9b in one MultiModelRuntime on the directio
    store under one budget, two executors with priorities 1 and 8 over one
    ServingScheduler (prefills and a paged generation), then scripted
    storage faults on gemma and the copy_in / dummy_asm ablation arms on
    qwen. Its stores live under ``build/phase7`` in the checkout."""
    import shutil

    import numpy as np
    from repro_torch.core.cost_model import DelayModel
    from repro_torch.core.multi_model import MultiModelRuntime
    from repro_torch.core.runtime import SwappedModel
    from repro_torch.core.serving_scheduler import ServingScheduler
    from repro_torch.errors import SwapCorruptionError, SwapIOError
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import swap_linear as sl
    from repro_torch.serving.engine import Request
    from repro_torch.store.faulty import FaultInjector

    reset, collect = launch_counting(main_launches)
    q, g = "qwen2.5-3b", "gemma2-9b"
    shutil.rmtree(P7_WORKDIR, ignore_errors=True)
    P7_WORKDIR.mkdir(parents=True)
    dm = DelayModel()
    floor = p7_floor_budget([(qmodel, qparams), (gmodel, gparams)], dm, 1,
                            P7_PROMPT)
    budget = int(P7_BUDGET_OVER_FLOOR * floor)
    t0 = time.perf_counter()
    rt = MultiModelRuntime(budget, store_backend="directio", device=device,
                           dm=dm, **P7_RUNTIME)
    try:
        rt.add_model(q, qmodel, qparams, str(P7_WORKDIR))
        rt.add_model(g, gmodel, gparams, str(P7_WORKDIR))
        qsm, gsm = rt.models[q], rt.models[g]
        t_build = time.perf_counter() - t0
        p7_check_floor(rt, floor, 1, P7_PROMPT)
        resident = sum(sm.store.resident_nbytes(n)
                       for sm in (qsm, gsm) for n in sm.store.order)
        ratio = resident / budget
        print(f"[phase7] directio stores built in {t_build:.1f} s under "
              f"{P7_WORKDIR}; direct_io: {q} "
              f"{qsm.store.direct_io}, {g} {gsm.store.direct_io}", flush=True)
        print(f"[phase7] budget {budget / 1e9:.3f} GB = "
              f"{P7_BUDGET_OVER_FLOOR} x the smallest feasible "
              f"{floor / 1e9:.1f} GB (2 executors, cache "
              f"{rt.cache.capacity / 1e9:.3f} GB, KV reserve "
              f"{rt.kv_reserve() / 1e9:.3f} GB); the stores' resident bytes "
              f"{resident / 1e9:.3f} GB, ratio {ratio:.3f}", flush=True)
        require(ratio > 1, f"phase 7: resident / budget {ratio:.3f} <= 1")
        for name, sm in rt.models.items():
            print(f"[phase7 {name}] blocks={sm.plan.n_blocks} "
                  f"{sm.plan.points} m={sm.plan.m}", flush=True)

        rng = np.random.default_rng(7)

        def prompt(cfg):
            return torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                                (1, P7_PROMPT)),
                                   dtype=torch.int32)
        batches = {name: [{"tokens": prompt(sm.cfg)}
                          for _ in range(P7_REQUESTS)]
                   for name, sm in rt.models.items()}
        gen_prompts = [list(map(int, rng.integers(0, qmodel.cfg.vocab_size,
                                                  P7_PROMPT)))
                       for _ in range(P7_GEN_PROMPTS)]
        # the unswapped forwards: every unit resident at once, built once
        # per tenant, then dropped before the traffic
        t0 = time.perf_counter()
        refs = {}
        for name, sm in rt.models.items():
            res = sm.resident_units()
            refs[name] = [sm.forward_unswapped(b, resident=res)
                          for b in batches[name]]
            del res
        torch.cuda.empty_cache()
        print(f"[phase7] unswapped references in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)

        for name in rt.models:                                   # warm
            rt.forward(name, batches[name][0])
        for sm in rt.models.values():
            sm.engine.stats.__init__()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

        # -------------------------------------------- (a)-(c) the traffic
        t0 = time.perf_counter()
        reset()
        sched = ServingScheduler(rt)
        prefills, gens = [], []
        try:
            for i in range(0, P7_REQUESTS, 2):
                # a priority-1 pair; once qwen's pass has run a block, a
                # priority-8 pair arrives while it is still running
                n_ex = len(qsm.engine.stats.t_ex)
                prefills += [sched.submit(q, batches[q][i], priority=1.0),
                             sched.submit(g, batches[g][i], priority=1.0)]
                wait_until(lambda: len(qsm.engine.stats.t_ex) > n_ex, 600,
                           "qwen's priority-1 pass to run a block")
                prefills += [
                    sched.submit(q, batches[q][i + 1], priority=8.0),
                    sched.submit(g, batches[g][i + 1], priority=8.0)]
            gen_reqs = [Request(1000 + i, p, max_new_tokens=P7_GEN_NEW)
                        for i, p in enumerate(gen_prompts)]
            gens = [sched.submit_generate(q, r, priority=1.0)
                    for r in gen_reqs]
            for r in prefills + gens:
                r.wait(timeout=600)
        finally:
            sched.shutdown(timeout=600)
        t_traffic = time.perf_counter() - t0
        by_shape = {"swap_linear": dict(sl.launches.by_shape),
                    "flash_attention": dict(fa.launches.by_shape),
                    "paged_attention": dict(pa.launches.by_shape)}
        counts = collect()
        max_alloc = torch.cuda.max_memory_allocated()
        preemptions = sched.preemptions
        # (a) exact outputs
        seen = {q: 0, g: 0}
        for r in prefills:
            idx = next(i for i, b in enumerate(batches[r.model])
                       if b is r.batch)
            require(torch.equal(r.logits, refs[r.model][idx]),
                    f"phase 7: {r.model} request {r.rid} (priority "
                    f"{r.priority:g}) logits != the unswapped forward")
            seen[r.model] += 1
        require(seen == {q: P7_REQUESTS, g: P7_REQUESTS},
                f"phase 7: served {seen}")
        be = rt.batch_engine(q)
        solo = []
        for i, p in enumerate(gen_prompts):
            r = Request(2000 + i, p, max_new_tokens=P7_GEN_NEW)
            be.submit(r)
            be.run_all()
            solo.append(r.output)
        for r, s in zip(gen_reqs, solo):
            require(r.output == s and len(s) == P7_GEN_NEW,
                    f"phase 7: generated {r.output} != alone {s}")
        # (b) the budget
        require(rt.ledger.peak <= budget,
                f"phase 7: ledger peak {rt.ledger.peak} > budget {budget}")
        require(rt.ledger.resident == rt.cache.resident_bytes
                and not rt.cache.active_leases(),
                f"phase 7: {rt.ledger.resident} bytes resident after the "
                f"drain, the cache holds {rt.cache.resident_bytes}")
        # (c) preemption
        pre = [r for r in prefills if r.stats["preemptions"]]
        require(sched.preemptions >= 1 and pre,
                f"phase 7: {sched.preemptions} preemptions, preempted "
                f"prefills {[r.rid for r in pre]}")
        p7_check_launches(counts, by_shape)
        print(f"[phase7] {len(prefills)} prefills + {len(gens)} generations"
              f" through 2 executors in {t_traffic:.1f} s: every prefill "
              f"== its unswapped forward bitwise, generated tokens == "
              f"served alone {solo}; preemptions {preemptions} "
              f"(prefills {[r.rid for r in pre]}); ledger peak "
              f"{rt.ledger.peak / 1e9:.3f} GB <= budget "
              f"{budget / 1e9:.3f} GB ({rt.ledger.peak / budget:.1%}), "
              f"drained to the cache's "
              f"{rt.cache.resident_bytes / 1e9:.3f} GB; launches {counts}",
              flush=True)
        lat = {}
        for r in prefills:
            lat.setdefault((r.model, r.priority), []).append(r.latency_s)
        tenants = {}
        for name, sm in rt.models.items():
            es = sm.engine.stats
            stage = {k: es.stage_seconds(k)
                     for k in ("read", "dispatch", "exec", "wait")}
            # two requests a class: each one's latency, not a percentile
            classes = {p: sorted(t * 1e3 for t in v)
                       for (m, p), v in lat.items() if m == name}
            rate = es.bytes_swapped / max(stage["read"], 1e-9) / 1e9
            tenants[name] = {"latency_ms_by_priority": classes,
                             "bytes_swapped": es.bytes_swapped,
                             "stage_s": stage,
                             "cache_hit_rate": es.cache_hit_rate(),
                             "peak_ledger": es.peak_resident,
                             "read_gb_s": rate,
                             "direct_io": sm.store.direct_io}
            print(f"[phase7 {name}] " + "; ".join(
                f"priority {p:g} " + ", ".join(f"{t:.1f}" for t in v)
                + f" ms (n={len(v)})"
                for p, v in sorted(classes.items(), reverse=True))
                + f"; swapped {es.bytes_swapped / 1e9:.3f} GB; s: " + ", ".join(
                f"{k} {v:.3f}" for k, v in stage.items())
                + f"; cache hit rate {es.cache_hit_rate():.3f}; ledger peak "
                f"{es.peak_resident / 1e9:.3f} GB; max_memory_allocated "
                f"{max_alloc / 1e9:.3f} GB; read {rate:.2f} GB/s; "
                f"direct_io {sm.store.direct_io}; arena host "
                f"{sm.store.arena.host_bytes / 1e9:.3f} GB", flush=True)

        # -------------------------------------------- (d) storage faults
        t0 = time.perf_counter()
        fi = FaultInjector.wrap(gsm.store, p=0.0)
        gsm.engine.store = fi
        try:
            es = gsm.engine.stats
            retries0, faults0 = es.retries, dict(es.faults)
            fi.force("io", "corrupt", None, "torn", None, "latency")
            sched = ServingScheduler(rt)
            try:
                rg = sched.submit(g, batches[g][0], priority=1.0)
                rq = sched.submit(q, batches[q][0], priority=1.0)
                for r in (rg, rq):
                    r.wait(timeout=600)
                require(torch.equal(rg.logits, refs[g][0])
                        and torch.equal(rq.logits, refs[q][0]),
                        "phase 7: logits after retried faults != the "
                        "unswapped forward")
                require(fi.injected == {"io": 1, "latency": 1, "torn": 1,
                                        "corrupt": 1}
                        and es.retries - retries0 == 3,
                        f"phase 7: injected {fi.injected}, retries "
                        f"{es.retries - retries0}")
                added = {k: v - faults0.get(k, 0)
                         for k, v in es.faults.items()
                         if v != faults0.get(k, 0)}
                require(added == {"SwapIOError": 2,
                                  "SwapCorruptionError": 1},
                        f"phase 7: faults by class {added}")
                retried = es.retries - retries0
                fi.force(*["io"] * (gsm.engine.read_retries + 1))
                rg = sched.submit(g, batches[g][1], priority=1.0)
                rq = sched.submit(q, batches[q][1], priority=1.0)
                failed = None
                try:
                    rg.wait(timeout=600)
                except (SwapIOError, SwapCorruptionError) as e:
                    failed = e
                require(failed is not None,
                        "phase 7: a read past its retries did not fail")
                rq.wait(timeout=600)
                require(torch.equal(rq.logits, refs[q][1]),
                        "phase 7: qwen beside a failed gemma request != "
                        "the unswapped forward")
            finally:
                sched.shutdown(timeout=600)
            require(rt.ledger.resident == rt.cache.resident_bytes
                    and not rt.cache.active_leases(),
                    f"phase 7: {rt.ledger.resident} bytes resident after "
                    f"the failed request, the cache holds "
                    f"{rt.cache.resident_bytes}")
        finally:
            gsm.engine.store = gsm.store
            gsm.store.verify = False
        print(f"[phase7 faults] {g} on faulty(directio): io, corrupt, torn "
              f"and latency scripted, {retried} retries, "
              f"logits == unswapped; then {gsm.engine.read_retries + 1} io "
              f"faults in a row: {type(failed).__name__} ({failed}), no "
              f"ledger bytes left, {q} beside it == unswapped; "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    finally:
        rt.close()

    # ------------------------------------------------ (e) ablation arms
    ablation = {}
    for mode, k, kw in (("copy_in", 3, {"gpu_dispatch": True}),
                        ("dummy_asm", 2, {})):
        t0 = time.perf_counter()
        sm = SwappedModel(qmodel, qparams, str(P7_WORKDIR / mode),
                          prefetch_depth=1, store_backend="mmap", mode=mode,
                          device=device, **kw)
        try:
            sm.set_plan(qsm.plan.points)
            logits, st = sm.forward(batches[q][0])
            require(torch.equal(logits, refs[q][0]),
                    f"phase 7 {mode}: logits != the snet pass")
            blocks = [sum(sm.store.nbytes(n) for n in sm.store.order[lo:hi])
                      for lo, hi in sm.plan.blocks()]
            peak = sm.engine.stats.peak_resident
            require(peak == k * max(blocks)
                    and all(sm.engine.store.resident_nbytes(n)
                            == k * sm.store.nbytes(n)
                            for n in sm.store.order),
                    f"phase 7 {mode}: ledger peak {peak}, blocks {blocks}, "
                    f"expected {k} x the largest")
            ablation[mode] = {"latency_s": st["latency_s"],
                              "peak_ledger": peak,
                              "largest_block": max(blocks)}
            print(f"[phase7 {mode}] {q} at m=1 over {sm.plan.points}: logits"
                  f" == the snet pass bitwise; ledger peak "
                  f"{peak / 1e9:.3f} GB = {k} x the largest block "
                  f"{max(blocks) / 1e9:.3f} GB; latency "
                  f"{st['latency_s'] * 1e3:.1f} ms; "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
        finally:
            sm.close()
    shutil.rmtree(P7_WORKDIR, ignore_errors=True)
    return {"budget": budget, "floor": floor, "resident": resident,
            "tenants": tenants, "ablation": ablation,
            "preemptions": preemptions, "launches": counts,
            "by_shape": by_shape}


# ---------------------------------------------------------------- mcu
def prom_samples(text: str, family: str) -> dict:
    """{tuple(sorted(label pairs)): value} of one metric family in a
    Prometheus text scrape."""
    out = {}
    for line in text.splitlines():
        if not line.startswith(family) or line.startswith("#"):
            continue
        rest = line[len(family):]
        if rest[:1] not in ("{", " "):
            continue            # a longer family name sharing the prefix
        labels = ()
        if rest.startswith("{"):
            inner, _, rest = rest[1:].partition("}")
            labels = tuple(sorted(
                (k, v.strip('"')) for k, v in
                (p.split("=", 1) for p in inner.split(",") if p)))
        out[labels] = float(rest.strip())
    return out


def http_call(base: str, path: str, body=None, timeout: float = 600.0):
    """One control-plane call: JSON (or Prometheus text) back."""
    import urllib.request
    req = urllib.request.Request(
        base + path, method="POST" if body is not None else "GET",
        data=json.dumps(body).encode() if body is not None else None,
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        raw = resp.read()
        if "text/plain" in resp.headers.get("Content-Type", ""):
            return raw.decode()
        return json.loads(raw)


def http_poll(base: str, rid: int, timeout: float = 600.0) -> dict:
    t_end = time.monotonic() + timeout
    while True:
        out = http_call(base, f"/v1/requests/{rid}")
        if out["status"] != "pending":
            return out
        require(time.monotonic() < t_end, f"rid {rid} pending after "
                f"{timeout} s")
        time.sleep(0.01)


def p8_resident_table(units, name: str, bits_map: dict) -> dict:
    """Per unit, the bytes a lazy quant store built from ``bits_map``
    holds resident (the ledger's charge): a fused-streamable 2-D weight
    its quantized payload and scales, any other leaf its logical bytes
    (the embedding is widened to fp32 on the host). Computed before the
    store exists; ``run_mcu`` holds it to the built store."""
    from repro_torch.store.quantized_store import (FUSED_STREAM_KEYS,
                                                   MIN_QUANT_SIZE, leaf_meta,
                                                   quantizable)
    from repro_torch.tree import tree_flatten_with_path
    table = {}
    for u in units:
        key = f"{name}/{u.name}"
        bits = bits_map.get(key, 0)
        total = 0
        for path, leaf in tree_flatten_with_path(u.params)[0]:
            shape, dname, nbytes = leaf_meta(leaf)
            if (bits and quantizable(shape, dname, MIN_QUANT_SIZE)
                    and len(shape) == 2 and path[-1] in FUSED_STREAM_KEYS):
                rows = shape[0] if bits == 8 else (shape[0] + 1) // 2
                total += rows * shape[1] + 4 * shape[1]
            else:
                total += nbytes
        table[key] = total
    return table


def p8_block_budget(budget: int, cfg8) -> int:
    """``MultiModelRuntime.block_budget`` of the mcu runtime: the cache
    off the top (no KV reserve, no pinned unit), one executor."""
    return budget - int(budget * cfg8.runtime.cache_frac)


def p8_floor_budget(model, units, name, table, cfg8, grid) -> int:
    """The smallest budget on a ``grid`` at which the runtime's planner
    packs the mixed store's resident unit table at the profile's
    prefetch depth, found before the store is built."""
    import types

    from repro_torch.core.cost_model import DelayModel, resident_infos
    from repro_torch.core.partition import PartitionPlanner
    from repro_torch.core.runtime import unit_infos
    wl = cfg8.workload
    infos = resident_infos(
        unit_infos(model, units, wl.requests, wl.prompt_len),
        types.SimpleNamespace(resident_nbytes=table.__getitem__),
        [f"{name}/{u.name}" for u in units])
    pp = PartitionPlanner(infos, DelayModel(), m=cfg8.runtime.prefetch_depth)
    b = grid
    while True:
        try:
            pp.best_partition(p8_block_budget(b, cfg8), 0.05)
            return b
        except ValueError:
            b += grid
            require(b < 10 ** 12, "phase 8: no feasible budget below 1 TB")


def p8_widths(plan) -> set:
    """The quantized widths a plan gives units with linears (every unit
    but the embedding, whose quantized leaf is widened on the host): the
    widths ``swap_linear_q`` launches at."""
    return {p for n, p in plan.assignments.items()
            if p != "fp" and not n.endswith("/embed")}


def p8_mixed_target(prof, fidelity: float) -> float:
    """The target nearest ``fidelity`` (steps of 5%, looser first) whose
    plan, from the same profile, gives units with linears both int4 and
    int8: the ladder's trajectory does not depend on the target, so it is
    read off the profile."""
    from repro_torch.calibrate import assign_precisions
    for i in range(1, 400):
        for t in (fidelity * 1.05 ** i, fidelity / 1.05 ** i):
            if p8_widths(assign_precisions(prof, t)) == {"int4", "int8"}:
                return t
    raise RuntimeError("phase 8: no target of the profile mixes int4 and "
                       "int8")


def p8_serve(torch, rt, sched, name, batch, plan, rounds, reset, collect):
    """The profile's workload through the scheduler (``rounds`` requests of
    one batch), counted; then held: each result equals a swapped pass of
    the runtime bitwise and is within 2e-2 of the in-memory model on the
    plan's round-tripped weights; the realized rel-L2 against the fp
    model. Returns (requests, launches, realized error, error against
    the round-tripped model, seconds, max_memory_allocated of the
    traffic: the card's allocator peak since the caller's reset, and the
    seconds of each engine span the traffic added)."""
    from repro_torch.calibrate.profiler import _rel_l2
    from repro_torch.store.quantized_store import roundtrip
    sm = rt.models[name]
    spans = ("read", "unpack", "dispatch", "exec", "wait")
    before = {k: sm.engine.stats.stage_seconds(k) for k in spans}
    t0 = time.perf_counter()
    reset()
    reqs = [sched.submit(name, batch, priority=1.0) for _ in range(rounds)]
    for r in reqs:
        r.wait(timeout=600)
    counts = collect()
    t_serve = time.perf_counter() - t0
    on_card = rt.device.type == "cuda"
    max_alloc = torch.cuda.max_memory_allocated() if on_card else 0
    stage = {k: sm.engine.stats.stage_seconds(k) - v
             for k, v in before.items()}
    again, _ = rt.forward(name, batch)
    ref = sm.forward_unswapped(batch, unit_params=[
        roundtrip(u.params, plan.bits_for(u.name)) for u in sm.units])
    fp = sm.forward_unswapped(batch)
    for r in reqs:
        require(bool(torch.isfinite(r.logits).all())
                and tuple(r.logits.shape) == tuple(fp.shape),
                f"phase 8: request {r.rid} logits shape "
                f"{tuple(r.logits.shape)}")
        require(torch.equal(r.logits, again), f"phase 8: request {r.rid} "
                f"!= a swapped pass of the runtime")
        err = rel_err(torch, r.logits, ref)
        require(err[1] <= 2e-2, f"phase 8: request {r.rid} vs the "
                f"round-tripped in-memory model rel err {err[1]:.3g} > 2e-2")
    return (reqs, counts, _rel_l2(reqs[0].logits, fp), err, t_serve,
            max_alloc, stage)


def p8_check_launches(by_shape) -> None:
    """Phase 8's kernels ran: B5 and B4 (calibration and fp units), B1 at
    int8 and at int4 (its quantized units), and no other."""
    for name in ("swap_linear", "flash_attention", "swap_linear_q"):
        require(by_shape[name], f"phase 8: {name} never launched")
    widths = {k[3] for k in by_shape["swap_linear_q"]}
    require(widths == {8, 4}, f"phase 8: swap_linear_q at bits {widths}")
    others = [n for n in ("dequant_int8", "paged_attention", "wkv6")
              if by_shape[n]]
    require(not others, f"phase 8: {others} launched")


def run_mcu(torch, model, params, main_launches, device="cuda"):
    """Phase 8: the mcu profile through the port's entry points. The config
    resolves through its layers (the CLI layer sets only budget_mb and
    reduce); a calibration by hand, the budget from its plan, then the
    runtime through ``MultiModelRuntime.from_config`` and ``add_model``
    (which calibrates again: the plans must agree byte for byte), the
    profile's workload through ``ServingScheduler.from_config``, and the
    same runtime and scheduler behind the HTTP control plane. Its store
    lives under ``build/phase8``."""
    import shutil

    import numpy as np

    import repro_torch.calibrate as calibrate
    from repro_torch.calibrate import calibrate_model, calibration_batch
    from repro_torch.calibrate.profiler import _rel_l2
    from repro_torch.config import explain_layers, resolve_config
    from repro_torch.core.multi_model import MultiModelRuntime
    from repro_torch.core.runtime import split_units
    from repro_torch.core.serving_scheduler import ServingScheduler
    from repro_torch.launch.serve import dispatch_mode
    from repro_torch.serving.control_plane import ControlPlane
    from repro_torch.serving.engine import Request, pad_prompts
    from repro_torch.serving.metrics import MetricsRegistry

    on_card = torch.device(device).type == "cuda"
    launches = {k: {} for k in main_launches}
    reset, collect = launch_counting(launches)
    name = model.cfg.name
    secs, counts = {}, {}
    shutil.rmtree(P8_WORKDIR, ignore_errors=True)
    P8_WORKDIR.mkdir(parents=True)

    # (1) the profile's config; the budget comes from the plan (3)
    cfg0 = resolve_config(profile="mcu", cli={"reduce": "full"})
    rtc, wl = cfg0.runtime, cfg0.workload
    require(rtc.precision == "mixed" and rtc.store == "quant",
            f"phase 8: mcu resolved to {rtc.store}/{rtc.precision}")
    require((wl.requests, wl.prompt_len) == (P8_BATCH, P8_SEQ),
            f"phase 8: mcu's workload {wl.requests} x {wl.prompt_len} is "
            f"not phase 2's rows' {P8_BATCH} x {P8_SEQ}")

    # (2) calibration by hand on the card
    base = 0
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()    # what earlier phases hold
    t0 = time.perf_counter()
    reset()
    prof, plan = calibrate_model(model, params, fidelity=rtc.fidelity,
                                 method="output", name=name,
                                 prefetch_depth=rtc.prefetch_depth,
                                 device="cuda")
    counts["calibration"] = collect()
    secs["calibration"] = time.perf_counter() - t0
    units = split_units(model, params)
    largest = max(sum(x.numel() * x.element_size() for x in _leaves(u.params))
                  for u in units)
    rise = torch.cuda.max_memory_allocated() - base if on_card else 0
    q = sum(1 for row in prof.units.values()
            if row["bytes_int4"] < row["bytes_fp"])
    hist = plan.histogram()
    print(f"[phase8] calibration (output, batch {prof.batch_shape}, "
          f"{1 + 2 * q} swapped passes on mmap, one unit a block at m = "
          f"{rtc.prefetch_depth}) in {secs['calibration']:.1f} s: "
          f"{json.dumps(hist)}, predicted_err {plan.predicted_err:.4g} "
          f"(target {rtc.fidelity:g}), stored {plan.stored_bytes / 1e9:.3f}"
          f" GB; max_memory_allocated rose {rise / 1e9:.3f} GB (above "
          f"the {base / 1e9:.3f} GB earlier phases hold) beside the "
          f"throwaway model's ledger peak, its largest unit "
          f"{largest / 1e9:.3f} GB; launches {counts['calibration']}",
          flush=True)
    for n, row in sorted(prof.units.items()):
        print(f"[phase8]   {n}: err int8 {row['err_int8']:.4g} int4 "
              f"{row['err_int4']:.4g}; bytes fp {row['bytes_fp']} int8 "
              f"{row['bytes_int8']} int4 {row['bytes_int4']} -> "
              f"{plan.assignments[n]}", flush=True)
    require(q == len(units), f"phase 8: {q} quantizable units of "
            f"{len(units)}")
    if on_card:
        # the substituted unit is one device copy beside the swapped one,
        # dropped after its pass: at most one unit above the ledger's
        require(rise <= 2 * largest + (64 << 20),
                f"phase 8: calibration max_memory_allocated rose {rise} > "
                f"two units ({2 * largest}) + 64 MiB")

    # (3) the budget from that plan
    table = p8_resident_table(units, name, plan.bits_map())
    grid = P8_GRID
    floor = p8_floor_budget(model, units, name, table, cfg0, grid)
    budget = int(P8_BUDGET_OVER_FLOOR * floor)
    resident = sum(table.values())
    ratio = resident / budget
    print(f"[phase8] budget {budget / 1e9:.3f} GB = {P8_BUDGET_OVER_FLOOR} "
          f"x the smallest feasible {floor / 1e9:.3f} GB at m = "
          f"{rtc.prefetch_depth} (cache {rtc.cache_frac:g} of it); the "
          f"mixed store's resident bytes {resident / 1e9:.3f} GB, ratio "
          f"{ratio:.3f}", flush=True)
    require(ratio > 1, f"phase 8: resident / budget {ratio:.3f} <= 1")

    # (4) the runtime through the config path
    cfg8 = resolve_config(profile="mcu", cli={
        "reduce": "full", "runtime": {"budget_mb": budget / 1e6}})
    require(dataclasses.replace(cfg8.runtime, budget_mb=rtc.budget_mb)
            == rtc, "phase 8: the budget override changed other fields")
    print("[phase8] config " + json.dumps({
        "resolved": cfg8.to_dict(), "mode": dispatch_mode(cfg8),
        "layers": {k: v for k, v in explain_layers(
            profile="mcu", cli={"reduce": "full", "runtime": {
                "budget_mb": budget / 1e6}}) if k != "defaults"}},
        sort_keys=True), flush=True)
    seen = []
    inner = calibrate.calibrate_model

    def spy(*a, **kw):
        t1 = time.perf_counter()
        out = inner(*a, **kw)
        seen.append((out[1], time.perf_counter() - t1))
        return out
    t0 = time.perf_counter()
    calibrate.calibrate_model = spy
    reset()
    try:
        rt = MultiModelRuntime.from_config(cfg8, device="cuda")
        sm = rt.add_model(name, model, params, str(P8_WORKDIR))
        rt.plan(batch=wl.requests, seq=wl.prompt_len)
    finally:
        calibrate.calibrate_model = inner
    counts["build"] = collect()
    secs["build"] = time.perf_counter() - t0
    try:
        require(len(seen) == 1 and seen[0][0].to_json() == plan.to_json(),
                "phase 8: add_model's plan != the calibration's: "
                f"{[p.to_json() for p, _ in seen]} vs {plan.to_json()}")
        require(sm.store.plan == plan.bits_map(),
                "phase 8: the store's plan != the calibration's")
        got = {n: sm.store.resident_nbytes(n) for n in sm.store.order}
        require(got == table, f"phase 8: resident bytes {got} != {table}")
        require(plan.stored_bytes == sum(sm.store.stored_nbytes(n)
                                         for n in sm.store.order),
                "phase 8: the plan's stored bytes != the store's")
        require(rt.block_budget() == p8_block_budget(budget, cfg8),
                "phase 8: block budget arithmetic")
        for b, fits in ((floor, True), (floor - grid, False)):
            try:
                sm.partition(p8_block_budget(b, cfg8), rt.dm, wl.requests,
                             wl.prompt_len, delta=rt.delta)
                ok = True
            except ValueError:
                ok = False
            require(ok == fits, f"phase 8: {b / 1e9:.1f} GB is "
                    f"{'' if ok else 'not '}feasible on the built store")
        rt.plan(batch=wl.requests, seq=wl.prompt_len)
        by_prec = {}
        for n, p in plan.assignments.items():
            by_prec[p] = by_prec.get(p, 0) + prof.units[n][f"bytes_{p}"]
        print(f"[phase8] runtime from_config + add_model in "
              f"{secs['build']:.1f} s (its calibration {seen[0][1]:.1f} s): "
              f"plan JSON == the calibration's byte for byte; "
              f"{json.dumps(hist)}, predicted_err {plan.predicted_err:.4g};"
              f" stored bytes by precision {json.dumps(by_prec)}; "
              f"blocks={sm.plan.n_blocks} {sm.plan.points} m={sm.plan.m}; "
              f"launches {counts['build']}", flush=True)

        # (5) the profile's workload through the scheduler
        rng = np.random.default_rng(0)
        batch = pad_prompts(model.cfg, [
            Request(i, list(map(int, rng.integers(0, model.cfg.vocab_size,
                                                  wl.prompt_len))))
            for i in range(wl.requests)])
        reset()
        rt.forward(name, batch)                                  # warm
        counts["warm"] = collect()
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        sched = ServingScheduler.from_config(rt, cfg8)
        try:
            (reqs, counts["traffic"], realized, err, secs["traffic"],
             max_alloc, stage) = p8_serve(torch, rt, sched, name, batch,
                                          plan, wl.rounds, reset, collect)
            es = sm.engine.stats
            present = {p for p, v in es.bytes_by_precision.items() if v}
            require(sum(es.bytes_by_precision.values()) == es.bytes_swapped,
                    f"phase 8: bytes by precision {es.bytes_by_precision} "
                    f"!= swapped {es.bytes_swapped}")
            require({p for p, n in hist.items() if n} <= present,
                    f"phase 8: precisions swapped {present}, plan {hist}")
            require(realized <= rtc.fidelity, f"phase 8: realized rel-L2 "
                    f"{realized:.4g} > target {rtc.fidelity:g}")
            require(rt.ledger.peak <= budget, f"phase 8: ledger peak "
                    f"{rt.ledger.peak} > budget {budget}")
            lat = sorted(r.latency_s * 1e3 for r in reqs)
            print(f"[phase8] {len(reqs)} requests of {wl.requests} x "
                  f"{wl.prompt_len} through 1 executor in "
                  f"{secs['traffic']:.1f} s (latency "
                  f"{', '.join(f'{x:.1f}' for x in lat)} ms): each == a "
                  f"swapped pass bitwise; vs the round-tripped in-memory "
                  f"model (abs, rel) {err[0]:.3g}, {err[1]:.3g} <= 2e-2; "
                  f"realized rel-L2 vs the fp model {realized:.4g} beside "
                  f"predicted_err {plan.predicted_err:.4g} (target "
                  f"{rtc.fidelity:g}); bytes swapped by precision "
                  f"{json.dumps(es.bytes_by_precision)} = "
                  f"{es.bytes_swapped}; ledger peak "
                  f"{rt.ledger.peak / 1e9:.3f} GB <= budget "
                  f"{budget / 1e9:.3f} GB ({rt.ledger.peak / budget:.1%}); "
                  f"max_memory_allocated {max_alloc / 1e9:.3f} GB; "
                  f"blocks {sm.plan.points} m={sm.plan.m}; span s: "
                  + ", ".join(f"{k} {v:.3f}" for k, v in stage.items())
                  + f"; launches {counts['traffic']}", flush=True)

            # (6) the same runtime and scheduler behind the control plane
            t0 = time.perf_counter()
            cp = ControlPlane(rt, sched, MetricsRegistry(rt, sched),
                              host="127.0.0.1", port=0,
                              plan_shape=(wl.requests, wl.prompt_len),
                              reduce=cfg8.reduce, workdir=str(P8_WORKDIR))
            cp.start()
            try:
                base = cp.url
                health = http_call(base, "/healthz")
                require(health["status"] == "ok"
                        and health["models"] == {name: True},
                        f"phase 8: /healthz {health}")
                info = http_call(base, "/v1/models")["models"][name]
                require(info["store"] == "quant"
                        and info["precision"] == "mixed"
                        and info["n_blocks"] == sm.plan.n_blocks,
                        f"phase 8: /v1/models {info}")
                rows = [[[int(t) for t in rng.integers(
                    0, model.cfg.vocab_size, wl.prompt_len)]
                    for _ in range(wl.requests)] for _ in range(2)]
                reset()
                subs = [http_call(base, "/v1/submit",
                                  {"model": name, "tokens": r})
                        for r in rows]
                extra = http_call(base, "/v1/submit", {
                    "model": name, "requests": wl.requests,
                    "prompt_len": wl.prompt_len, "seed": 5})
                cancel = http_call(
                    base, f"/v1/requests/{extra['rid']}/cancel", {})
                outs = [http_poll(base, s["rid"]) for s in subs]
                counts["http"] = collect()
                cancelled = http_poll(base, extra["rid"])
                require(cancel["cancelled"]
                        and cancelled["status"] == "cancelled",
                        f"phase 8: cancel {cancel}, then {cancelled}")
                for s, r, out in zip(subs, rows, outs):
                    require(out["status"] == "done",
                            f"phase 8: rid {s['rid']} {out}")
                    full = http_call(base, f"/v1/requests/{s['rid']}"
                                     f"?logits=1")
                    got = torch.tensor(full["logits"],
                                       dtype=torch.float64).float()
                    want, _ = rt.forward(name, pad_prompts(
                        model.cfg, [Request(i, x) for i, x in enumerate(r)]))
                    require(torch.equal(got, want.cpu()),
                            f"phase 8: HTTP rid {s['rid']} logits != the "
                            f"in-process forward")
                by_class = sched.latency_by_class()
                quant = cp.metrics.latency_quantiles()
                text = http_call(base, "/metrics")
                done = prom_samples(text, "swapnet_requests_completed_total")
                q_lat = prom_samples(text, "swapnet_request_latency_seconds")
                for prio, lats in by_class.items():
                    key = ("priority", f"{prio:g}")
                    require(done[(key,)] == float(len(lats))
                            and q_lat[(key, ("quantile", "0.5"))]
                            == quant[prio]["p50_s"]
                            and q_lat[(key, ("quantile", "0.99"))]
                            == quant[prio]["p99_s"],
                            f"phase 8: /metrics latency samples != the "
                            f"scheduler's ({prio:g})")
                for fam, want in (
                        ("swapnet_ledger_peak_bytes", float(rt.ledger.peak)),
                        ("swapnet_cache_hit_rate", rt.cache.hit_rate()),
                        ("swapnet_preemptions_total",
                         float(sched.preemptions))):
                    require(prom_samples(text, fam)[()] == want,
                            f"phase 8: /metrics {fam} != {want}")
                require(prom_samples(text, "swapnet_model_bytes_swapped_total")
                        [(("model", name),)] == float(es.bytes_swapped),
                        "phase 8: /metrics bytes swapped")
                shut = http_call(base, "/v1/shutdown", {})
                require(shut == {"shutting_down": True}
                        and cp.shutdown_requested.wait(60),
                        f"phase 8: /v1/shutdown {shut}")
            finally:
                cp.stop()
            require(cp._thread is None, "phase 8: the HTTP server thread "
                    "outlived stop()")
        finally:
            sched.shutdown(timeout=600)         # raises if an executor lives
        secs["http"] = time.perf_counter() - t0
        print(f"[phase8] HTTP on {base}: /healthz, /v1/models, 2 submits "
              f"polled to done (logits == the in-process forward bitwise), "
              f"1 cancel (cancelled), /metrics == the scheduler's counters "
              f"({len(text.splitlines())} lines), /v1/shutdown then a clean"
              f" stop, in {secs['http']:.1f} s; launches {counts['http']}",
              flush=True)
    finally:
        rt.close()
    if on_card:
        torch.cuda.empty_cache()

    # (5b) a plan with both quantized widths, where 2e-2's has one
    mixed = plan
    if p8_widths(plan) != {"int4", "int8"}:
        t0 = time.perf_counter()
        target = p8_mixed_target(prof, rtc.fidelity)
        mixed = calibrate.assign_precisions(prof, target)
        rt = MultiModelRuntime.from_config(cfg8, device="cuda")
        try:
            reset()
            sm = rt.add_model(name, model, params, str(P8_WORKDIR / "b"),
                              store_options={"plan": mixed})
            rt.plan(batch=wl.requests, seq=wl.prompt_len)
            rt.forward(name, batch)                              # warm
            counts["mixed_build"] = collect()
            sched = ServingScheduler.from_config(rt, cfg8)
            try:
                _, counts["mixed_traffic"], realized_b, err_b, _, _, _ = \
                    p8_serve(torch, rt, sched, name, batch, mixed, 1, reset,
                             collect)
            finally:
                sched.shutdown(timeout=600)
            require(rt.ledger.peak <= budget, "phase 8: second plan's ledger"
                    " peak over the budget")
            bp = sm.engine.stats.bytes_by_precision
            require({"int8", "int4"} <= {p for p, v in bp.items() if v},
                    f"phase 8: second plan swapped {bp}")
        finally:
            rt.close()
        secs["mixed"] = time.perf_counter() - t0
        print(f"[phase8] target {target:.4g} of the same profile: "
              f"{json.dumps(mixed.histogram())}, predicted_err "
              f"{mixed.predicted_err:.4g}; served 1 request == a swapped "
              f"pass bitwise, vs the round-tripped in-memory model (abs, "
              f"rel) {err_b[0]:.3g}, {err_b[1]:.3g} <= 2e-2, realized "
              f"rel-L2 {realized_b:.4g}; bytes swapped by precision "
              f"{json.dumps(bp)}; launches {counts['mixed_traffic']}; "
              f"{secs['mixed']:.1f} s", flush=True)
    shutil.rmtree(P8_WORKDIR, ignore_errors=True)
    for k, per_shape in launches.items():
        for key, n in per_shape.items():
            main_launches[k][key] = main_launches[k].get(key, 0) + n
    print(f"[phase8] wall s: " + ", ".join(f"{k} {v:.1f}"
                                           for k, v in secs.items()),
          flush=True)
    return {"budget": budget, "floor": floor, "resident": resident,
            "plan": plan, "mixed": mixed, "realized": realized,
            "seconds": secs, "launches": counts, "by_shape": launches}


# ---------------------------------------------------------------- llama4
def meminfo_gb(field: str = "MemTotal") -> float:
    """A field of the host's /proc/meminfo in GB (1e9 B)."""
    with open("/proc/meminfo") as fh:
        for line in fh:
            if line.startswith(f"{field}:"):
                return int(line.split()[1]) * 1024 / 1e9
    return float("nan")


def p9_floor_budget(model, params, batch, seq) -> int:
    """The smallest budget on a P9_GRID grid at which the planner packs
    the unit table at m = P9_M without degrading the pipeline, found
    before the store is built (an mmap unit's resident bytes are its host
    tensors' bytes)."""
    from repro_torch.core.cost_model import DelayModel
    from repro_torch.core.partition import PartitionPlanner
    from repro_torch.core.runtime import split_units, unit_infos
    infos = unit_infos(model, split_units(model, params), batch, seq)
    return grid_floor(PartitionPlanner(infos, DelayModel(), m=P9_M),
                      P9_GRID)


def grid_floor(pp, grid: int) -> int:
    """The smallest budget on a ``grid`` at which planner ``pp`` packs its
    unit table at m = P9_M without degrading the pipeline."""
    b = int(max(pp.sizes)) // grid * grid
    while True:
        try:
            pp.best_partition(b, 0.05, allow_degrade=False)
            return b
        except ValueError:
            b += grid
            require(b < 10 ** 12, "no feasible budget below 1 TB")


def plan_at_floor(torch, sm, floor, budget, seq, store_s, tag,
                  ledger_budget=None, grid=P9_GRID) -> int:
    """Plan a built store for one ``seq``-token prompt under ``budget``
    after checking ``floor`` against the store: m = P9_M there, not a
    ``grid`` step below it (where the planner degrades the pipeline or
    fails). The
    ledger enforces ``ledger_budget`` (None: ``budget``). The host copies
    of the units then go: the store is the weights' only home, so the page
    cache can hold its files. Returns the store's resident bytes (a shared
    unit's once)."""
    from repro_torch.core.cost_model import DelayModel
    from repro_torch.tree import tree_map
    names = list(dict.fromkeys(u.name for u in sm.units))
    resident = sum(sm.store.resident_nbytes(n) for n in names)
    ledger_budget = budget if ledger_budget is None else ledger_budget
    sm.engine.ledger.budget = ledger_budget
    sm.partition(floor, DelayModel(), 1, seq)
    at_floor = sm.plan.m
    try:
        sm.partition(floor - grid, DelayModel(), 1, seq)
        below = sm.plan.m
    except ValueError:
        below = 0
    sm.partition(budget, DelayModel(), 1, seq)
    print(f"[{tag}] store of {resident / 1e9:.3f} GB built in "
          f"{store_s:.1f} s; units (GB): " + ", ".join(
              f"{n} {sm.store.resident_nbytes(n) / 1e9:.3f}"
              for n in names), flush=True)
    ledger = ("" if ledger_budget == budget else
              f"; ledger budget {ledger_budget / 1e9:.3f} GB (+ the pinned "
              f"units' {(ledger_budget - budget) / 1e9:.3f} GB)")
    digits = 1 if grid >= 10 ** 8 else 2
    print(f"[{tag}] budget {budget / 1e9:.3f} GB = "
          f"{P9_BUDGET_OVER_FLOOR} x the smallest feasible "
          f"{floor / 1e9:.{digits}f} GB at m = {P9_M}{ledger}; resident / "
          f"{'ledger ' if ledger else ''}budget "
          f"{resident / ledger_budget:.3f}; blocks={sm.plan.n_blocks} "
          f"{sm.plan.points} m={sm.plan.m}", flush=True)
    require(sm.plan.m == P9_M, f"{tag}: planned m={sm.plan.m}")
    require(at_floor == P9_M and below != P9_M,
            f"{tag}: {floor / 1e9:.{digits}f} GB is not the smallest budget "
            f"at m = {P9_M} on the store (m {at_floor} there, {below} a "
            f"step below)")
    for u in sm.units:
        u.params = tree_map(lambda a: torch.empty(
            a.shape, dtype=a.dtype, device="meta"), u.params)
    return resident


def cut_params(model, params, full_plan):
    """``params`` of a deeper model of the same config (its segments laid
    out by ``full_plan``) cut to ``model``'s layers: each scanned segment
    keeps its first layers, copied where that drops some so the full
    stacks can go; the embedding, frontend, head and shared block stay the
    same tensors."""
    from repro_torch.tree import tree_map
    segs = []
    for si, seg in enumerate(model.plan):
        full = full_plan[si]
        require(full.kind == seg.kind and full.scanned == seg.scanned
                and full.layer_ids[:len(seg.layer_ids)] == seg.layer_ids,
                f"{model.cfg.name}: segment {si} of the cut is not a prefix")
        if not seg.scanned:
            segs.append({})
            continue
        n = len(seg.layer_ids)
        segs.append(tree_map(
            lambda a: a if a.shape[0] == n else a[:n].clone(),
            params["segments"][si]))
    return dict(params, segments=segs)


def leading_values(params, n_layers: int) -> list:
    """Host copies of the first 64 values of each leaf of ``params``, of
    each of the first ``n_layers`` layers of a scanned segment: a
    fingerprint of those layers and the unscanned leaves."""
    from repro_torch.tree import tree_leaves
    out = [a.reshape(-1)[:64] for k, v in params.items() if k != "segments"
           for a in tree_leaves(v)]
    out += [a[:n_layers].reshape(n_layers, -1)[:, :64]
            for seg in params["segments"] for a in tree_leaves(seg)]
    return [t.detach().cpu().clone() for t in out]


def quant_arm(torch, tag, model, cut, batch, seq, workdir, reset, collect,
              expect, precision="int8", then=None):
    """The int8-lazy arm of phases 9 and 11-13 (ROADMAP A10), and phase
    20's int4 one (``precision``): ``model`` over the
    phase's params cut to its layers (``cut``), stored lazy under
    ``workdir`` (removed after), planned under 1.1x the smallest budget on
    an ARM_GRID grid at which the planner packs the store at m = P9_M,
    below the store's resident bytes, in >= 3 blocks; a pinned shared unit
    (zamba2's) adds its lazy resident bytes to the ledger's budget. One
    swapped first pass of ``batch`` (no warm pass: phase 2 ran the kernels
    at these shapes) with the launches ``expect`` requires ({kernel:
    count}: B1's exactly); its spans, bytes and peaks printed. Each unit's
    read then puts on the card, summed over the store, within 1% above
    the ledger's charges (no payload of a host-widened leaf; the pass's
    device and ledger peaks printed beside). Then (1)
    the logits bitwise those of ``forward_unswapped`` over the store's own
    lazy leaves, each unit's ``read_unit`` tree, QuantizedTensors kept
    (the same kernels on the same inputs); (2) within ARM_TOL of the same
    forward with every quantized linear through ``swap_linear_q_plain``
    (each weight widened to fp32 whole, the store's round trip bitwise,
    then an fp32 matmul): B1 against the widened weights, held only where
    each moe layer routes the last token alike in both (ROADMAP C's MoE
    trap; the flips printed). Not the forward over the leaves widened to
    bf16 copies through B5, phase 3's yardstick: the bf16 rounding of the
    widened weights alone moves these stacks 1.2-2.0% from the arm's
    logits (PERF.md, PR 30; ``tests/test_torch_quant_families.py`` holds
    that gap to bf16's own distance from fp32). ``then(sm, budget)``, if
    given, runs on the planned store before it is closed; its result is
    the row's "then". Returns the arm's row."""
    import shutil

    from repro_torch.core.cost_model import DelayModel, resident_infos
    from repro_torch.core.partition import PartitionPlanner
    from repro_torch.core.runtime import SwappedModel, unit_infos
    from repro_torch.core.swap_engine import device_bytes
    from repro_torch.kernels import swap_linear_q as slq
    from repro_torch.models import layers, moe

    cfg = model.cfg
    shutil.rmtree(workdir, ignore_errors=True)
    t0 = time.perf_counter()
    sm = SwappedModel(model, cut, str(workdir), device="cuda",
                      store_backend="quant", precision=precision,
                      prefetch_depth=P9_M)
    quant_s = time.perf_counter() - t0
    del cut
    try:
        names = [u.name for u in sm.units]
        shared = sum(sm.store.resident_nbytes(n) for n in sm.engine.pinned)
        infos = resident_infos(unit_infos(model, sm.units, 1, seq),
                               sm.engine.store, names)
        floor = grid_floor(PartitionPlanner(infos, DelayModel(), m=P9_M),
                           ARM_GRID)
        budget = int(P9_BUDGET_OVER_FLOOR * floor)
        ledger_budget = budget + shared
        resident = plan_at_floor(torch, sm, floor, budget, seq, quant_s, tag,
                                 ledger_budget=ledger_budget, grid=ARM_GRID)
        require(budget < resident and sm.plan.n_blocks >= 3,
                f"{tag}: budget {budget} against resident {resident}, "
                f"{sm.plan.n_blocks} blocks (>= 3 and below the store's "
                f"resident bytes required)")

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset()
        logits, st = sm.forward(batch)
        counts = collect()
        max_alloc = torch.cuda.max_memory_allocated()
        es = sm.engine.stats
        require(all(counts[k] == n for k, n in expect.items()),
                f"{tag}: launches {counts}, expected {expect}")
        require(bool(torch.isfinite(logits).all())
                and tuple(logits.shape) == (1, 1, cfg.vocab_size),
                f"{tag}: logits {tuple(logits.shape)}, finite "
                f"{bool(torch.isfinite(logits).all())}")
        require(es.peak_resident <= ledger_budget,
                f"{tag}: peak ledger {es.peak_resident} over the ledger "
                f"budget {ledger_budget}")
        require(sm.engine.ledger.resident == shared,
                f"{tag}: {sm.engine.ledger.resident} B charged after the "
                f"pass, the pinned units' lazy resident bytes {shared}")
        row = report_prefill(f"{tag} first pass", sm, st, ledger_budget,
                             resident, max_alloc)

        def unswapped(resident_units, plain_b1=False):
            """forward_unswapped over ``resident_units`` (with
            ``plain_b1`` every quantized linear through swap_linear_q's
            plain version on the card), and each moe layer's experts of
            the last token, sorted."""
            routes, route = [], moe.route
            b1 = layers.swap_linear_q

            def recording(c, router, xf):
                r = route(c, router, xf)
                routes.append(r[1].reshape(-1, r[1].shape[-1])[-1].sort()
                              .values)
                return r
            moe.route = recording
            if plain_b1:
                layers.swap_linear_q = slq.swap_linear_q_plain
            try:
                out = sm.forward_unswapped(batch, resident=resident_units)
            finally:
                moe.route, layers.swap_linear_q = route, b1
            return out, routes

        t0 = time.perf_counter()
        stored = {n: sm.store.read_unit(n).params
                  for n in dict.fromkeys(names)}
        # what each unit's read puts on the card against its ledger charge
        # (C1): the sums over the store's units, each unit read alone
        dev = {n: device_bytes([p]) for n, p in stored.items()}
        charge = {n: sm.store.resident_nbytes(n) for n in stored}
        worst = max(dev[n] / charge[n] for n in stored)
        total_dev, total_charge = sum(dev.values()), sum(charge.values())
        require(total_charge <= total_dev <= 1.01 * total_charge,
                f"{tag}: the store's units hold {total_dev} B on the card "
                f"against the ledger's {total_charge} B")
        print(f"[{tag}] device bytes of each unit's read, summed "
              f"{total_dev / 1e9:.4f} GB == the ledger's charges "
              f"{total_charge / 1e9:.4f} GB x {total_dev / total_charge:.4f} "
              f"<= 1.01 (worst unit x {worst:.4f}); the pass's peaks: device "
              f"{es.peak_device_weights / 1e9:.3f} GB (swapped handles), "
              f"ledger {es.peak_resident / 1e9:.3f} GB (the pinned units' "
              f"{shared / 1e9:.3f} GB once charged)", flush=True)
        lazy = [stored[n] for n in names]
        want, routes_q = unswapped(lazy)
        require(torch.equal(logits, want), f"{tag}: swapped logits != the "
                f"unswapped forward over the store's lazy leaves")
        ref, routes_p = unswapped(lazy, plain_b1=True)
        del lazy, stored
        check_s = time.perf_counter() - t0
        flips = [int(not torch.equal(a, b))
                 for a, b in zip(routes_q, routes_p)]
        err = rel_err(torch, logits, ref)
        held = not any(flips)
        if held:
            require(err[1] <= ARM_TOL, f"{tag}: logits vs the forward over "
                    f"the widened weights rel {err[1]:.3g} > {ARM_TOL}")
        print(f"[{tag}] swapped logits == the unswapped forward over the "
              f"store's lazy leaves bitwise; vs the same forward with each "
              f"quantized linear through B1's plain version (the weights "
              f"widened to fp32 whole, an fp32 matmul) rel {err[1]:.4g} (max "
              f"abs {err[0]:.3g}) "
              + (f"<= {ARM_TOL}" if held else "not held")
              + (f", last-token routing flips by layer {flips}"
                 if routes_q else "")
              + f"; quantize and write {quant_s:.1f} s, the identities "
              f"{check_s:.1f} s; launches {counts}", flush=True)
        row.update(quant_s=quant_s, check_s=check_s, budget=budget,
                   floor=floor, resident=resident, blocks=sm.plan.n_blocks,
                   rel_err=err[1], routing_flips=flips, launches=counts)
        if then is not None:
            row["then"] = then(sm, ledger_budget)
    finally:
        sm.close()
        shutil.rmtree(workdir, ignore_errors=True)
    torch.cuda.empty_cache()
    return row


def host_copy(torch, tree):
    """Each leaf of a device tree copied to the host, the device leaf
    dropped as soon as its copy is made (the device never holds both).
    The bytes go through a pinned staging buffer of ``HOST_STAGE_BYTES``:
    a copy down into pageable memory is staged by the driver in small
    pieces, and the phases print what this one takes ("copied down in")."""
    from repro_torch.tree import tree_flatten, tree_unflatten
    leaves, treedef = tree_flatten(tree)
    del tree
    stage = torch.empty(HOST_STAGE_BYTES, dtype=torch.uint8, pin_memory=True)
    out = []
    while leaves:
        leaf = leaves.pop(0).contiguous()
        host = torch.empty(leaf.shape, dtype=leaf.dtype)
        src = leaf.reshape(-1).view(torch.uint8)
        dst = host.reshape(-1).view(torch.uint8)
        for i in range(0, src.numel(), HOST_STAGE_BYTES):
            n = min(HOST_STAGE_BYTES, src.numel() - i)
            stage[:n].copy_(src[i:i + n])
            dst[i:i + n].copy_(stage[:n])
        out.append(host)
        del leaf, src
    del stage
    torch.cuda.empty_cache()
    return tree_unflatten(treedef, out)


def run_llama4(torch, card, main_launches):
    """Phase 9: llama4-scout's MoE stack at its published widths, 4
    layers (3 block-local, 1 global), swapped from one mmap store under a
    budget less than half the store: an 8,704-token prefill bitwise equal
    to the unswapped forward (B4 at chunk 8192 on layers 0-2 and none on
    layer 3, B5 seven times a layer), then two paged generations equal to
    each request served alone; last the int8-lazy arm (``quant_arm``) on
    the same params cut to layers 0 and 1: one first pass of the prompt
    with B1 at each layer's wq, wk, wv, wo and the shared expert's three
    and the head (15), B4 once a layer at chunk 8192, the routed stacks,
    the router and the embedding widened on the host."""
    import shutil

    import numpy as np
    from repro_torch.configs import get_arch
    from repro_torch.core.runtime import SwappedModel
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.transformer import Model
    from repro_torch.serving.paged_kv import PagedKVCache

    reset, collect = launch_counting(main_launches)
    before = {name: dict(keys) for name, keys in main_launches.items()}
    cfg = dataclasses.replace(get_arch("llama4-scout-17b-a16e"),
                              n_layers=LLAMA_LAYERS)
    e = cfg.moe
    print(f"model: {cfg.name} d_model {cfg.d_model}, {cfg.n_heads} heads / "
          f"{cfg.n_kv_heads} KV heads, head_dim {cfg.resolved_head_dim}, "
          f"{e.n_routed} routed experts (top {e.top_k}) of {e.d_expert} + "
          f"{e.n_shared} shared of {e.d_shared}, capacity factor "
          f"{e.capacity_factor}, vocab {cfg.vocab_size}, attn_chunk "
          f"{cfg.attn_chunk} on layers "
          f"{[i for i in range(cfg.n_layers) if cfg.is_local_layer(i)]}, "
          f"frontend stub {cfg.d_frontend}, {cfg.dtype}; reduced: n_layers "
          f"48->{LLAMA_LAYERS}", flush=True)
    print(f"[phase9] {card}; host MemTotal {meminfo_gb():.1f} GB",
          flush=True)
    t0 = time.perf_counter()
    model = Model(cfg)
    # 10.9 B values: drawn on the card, then the host holds the store's
    # source
    params = host_copy(torch, model.init(0, device="cuda"))
    n_params = sum(p.numel() for p in _leaves(params))
    n_bytes = sum(p.numel() * p.element_size() for p in _leaves(params))
    init_s = time.perf_counter() - t0
    print(f"params: {n_params / 1e9:.3f} B, {n_bytes / 1e9:.2f} GB (fp32, "
          f"host), init on the card and copied down in {init_s:.1f} s",
          flush=True)
    floor = p9_floor_budget(model, params, 1, LLAMA_PROMPT)
    budget = int(P9_BUDGET_OVER_FLOOR * floor)
    rng = np.random.default_rng(9)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                          (1, LLAMA_PROMPT)),
                             dtype=torch.int32)
    batch = {"tokens": tokens}
    tag = "phase9 llama4-scout bf16 mmap"
    out = {"budget": budget, "floor": floor, "params": n_params}
    shutil.rmtree(P9_WORKDIR, ignore_errors=True)
    t_store = time.perf_counter()
    sm = SwappedModel(model, params, str(P9_WORKDIR), device="cuda",
                      store_backend="mmap", prefetch_depth=P9_M)
    try:
        out["store_s"] = time.perf_counter() - t_store
        resident = plan_at_floor(torch, sm, floor, budget, LLAMA_PROMPT,
                                 out["store_s"], tag)
        ratio = resident / budget
        out.update(resident=resident, ratio=ratio)
        require(ratio > 2, f"{tag}: resident / budget {ratio:.3f} <= 2")
        arm_fingerprint = leading_values(params, LLAMA_Q_LAYERS)
        del params

        t0 = time.perf_counter()
        sm.forward(batch)                                          # warm
        warm_s = time.perf_counter() - t0
        sm.engine.stats.__init__()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset()
        logits, st = sm.forward(batch)
        counts = collect()
        max_alloc = torch.cuda.max_memory_allocated()
        chunks = sorted((k[10] or 0) for k, n in fa.launches.by_shape.items()
                        for _ in range(n))
        require(counts["flash_attention"] == LLAMA_LAYERS
                and chunks == [0] + [LLAMA_CHUNK] * (LLAMA_LAYERS - 1),
                f"{tag}: flash_attention launches {fa.launches.by_shape}, "
                f"expected {LLAMA_LAYERS - 1} at chunk {LLAMA_CHUNK} and "
                f"one with none")
        require(counts["swap_linear"] == 7 * LLAMA_LAYERS,
                f"{tag}: swap_linear launched {counts['swap_linear']} times, "
                f"expected {7 * LLAMA_LAYERS}")
        require(counts["swap_linear_q"] == 0, f"{tag}: swap_linear_q "
                f"launched {counts['swap_linear_q']} times")
        require(bool(torch.isfinite(logits).all()),
                f"{tag}: non-finite logits")
        require(tuple(logits.shape) == (1, 1, cfg.vocab_size),
                f"{tag}: logits shape {tuple(logits.shape)}")
        require(sm.engine.stats.peak_resident <= budget,
                f"{tag}: peak ledger {sm.engine.stats.peak_resident} over "
                f"budget {budget}")
        t0 = time.perf_counter()
        torch.cuda.empty_cache()
        units = [sm.store.read_unit(u.name).params for u in sm.units]
        want = sm.forward_unswapped(batch, resident=units)
        del units
        torch.cuda.empty_cache()
        unswapped_s = time.perf_counter() - t0
        require(torch.equal(logits, want),
                f"{tag}: swapped logits != unswapped logits")
        print(f"[{tag}] swapped logits == unswapped logits bitwise (1 x "
              f"{LLAMA_PROMPT} tokens, {LLAMA_LAYERS} layers at published "
              f"widths, the "
              f"unswapped model holding all {resident / 1e9:.1f} GB; "
              f"{unswapped_s:.1f} s); flash_attention at chunk "
              f"{LLAMA_CHUNK} x {LLAMA_LAYERS - 1} (layers 0-2) and none x "
              f"1 (layer 3); warm pass {warm_s:.1f} s; launches {counts}",
              flush=True)
        out["prefill"] = report_prefill(tag, sm, st, budget, resident,
                                        max_alloc)
        out["prefill"]["warm_s"] = warm_s

        # two paged generations on the same store and budget, then each
        # request alone
        prompts = [list(map(int, rng.integers(0, cfg.vocab_size, n)))
                   for n in LLAMA_PAGED_PROMPTS]
        new = [LLAMA_PAGED_NEW] * len(prompts)
        kv = PagedKVCache(cfg, sm.engine.ledger, page_tokens=PAGE_TOKENS,
                          max_pages=LLAMA_MAX_PAGES, device="cuda")
        t0 = time.perf_counter()
        reqs, be, pcounts, windows, alloc0 = drive_paged(
            torch, sm, kv, prompts, new, len(prompts), reset, collect)
        out["paged"] = report_paged(torch, "phase9 paged", sm, kv, be,
                                    budget, windows, alloc0)
        check_paged_run("phase9 paged", kv, be, pcounts, LLAMA_LAYERS,
                        budget)
        paged_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        solo = []
        for p, n in zip(prompts, new):
            sreqs, sbe, scounts, _, _ = drive_paged(
                torch, sm, kv, [p], [n], 1, reset, collect)
            check_paged_run("phase9 alone", kv, sbe, scounts, LLAMA_LAYERS,
                            budget)
            solo.append(sreqs[0].output)
        solo_s = time.perf_counter() - t0
        got = [r.output for r in reqs]
        require(got == solo and all(len(t) == LLAMA_PAGED_NEW for t in got),
                f"{tag}: paged tokens {got} != served alone {solo}")
        steps = sum(1 for t in be.trace if t.batch)
        print(f"[phase9 paged] {len(prompts)} requests (prompts "
              f"{LLAMA_PAGED_PROMPTS}, {LLAMA_PAGED_NEW} new tokens each) "
              f"== each served alone: {got}; {steps} decode steps, "
              f"paged_attention x {pcounts['paged_attention']} "
              f"({LLAMA_LAYERS} layers x {steps}); batched {paged_s:.1f} s, alone {solo_s:.1f} s; "
              f"launches {pcounts}", flush=True)
        out["paged"].update(tokens=got, batched_s=paged_s, solo_s=solo_s)
    finally:
        sm.close()
        shutil.rmtree(P9_WORKDIR, ignore_errors=True)
    torch.cuda.empty_cache()

    # ---- the int8-lazy arm: B1 at the attention's four linears, the
    # shared expert's three and the head; the routed stacks, the router
    # and the embedding widened on the host. Its params are drawn again on
    # the card from the same seed, cut there and copied down (their leading
    # values checked against the first draw's): a copy kept from
    # ``params`` would hold 26 GB of the host through the passes above and
    # evict the store's pages, which they would then read from disk again;
    # reading the store's files back is slower than drawing them again
    t0 = time.perf_counter()
    qmodel = Model(dataclasses.replace(cfg, n_layers=LLAMA_Q_LAYERS))
    full = model.init(0, device="cuda")
    cut = host_copy(torch, cut_params(qmodel, full, model.plan))
    del full
    torch.cuda.empty_cache()
    require(all(torch.equal(a, b) for a, b in zip(
        leading_values(cut, LLAMA_Q_LAYERS), arm_fingerprint)),
        "phase9 int8-lazy: the params drawn again differ from the first "
        "draw")
    n_cut = sum(p.numel() for p in _leaves(cut))
    print(f"[phase9] host MemAvailable {meminfo_gb('MemAvailable'):.1f} GB "
          f"before the int8-lazy arm, its {n_cut / 1e9:.3f} B fp32 params "
          f"drawn again on the card and copied down in "
          f"{time.perf_counter() - t0:.1f} s (their leading values == the "
          f"first draw's)", flush=True)
    fa_before = dict(main_launches["flash_attention"])
    try:
        out["int8_lazy"] = quant_arm(
            torch, f"phase9 {cfg.name} bf16 int8-lazy, {LLAMA_Q_LAYERS} "
            f"layers", qmodel, cut, batch, LLAMA_PROMPT,
            P9_WORKDIR / "int8-lazy", reset, collect,
            {"swap_linear_q": 7 * LLAMA_Q_LAYERS + 1, "swap_linear": 0,
             "flash_attention": LLAMA_Q_LAYERS, "dequant_int8": 0})
        del cut
    finally:
        shutil.rmtree(P9_WORKDIR, ignore_errors=True)
    arm_s = time.perf_counter() - t0
    arm_fa = {k[10] for k, n in main_launches["flash_attention"].items()
              if n > fa_before.get(k, 0)}
    require(arm_fa == {LLAMA_CHUNK}, f"phase9 int8-lazy: flash_attention at "
            f"chunks {arm_fa}, not {LLAMA_CHUNK} alone (layers 0 and 1 are "
            f"block-local)")
    print(f"[phase9] wall s: init {init_s:.1f}, store {out['store_s']:.1f}"
          f", warm pass {warm_s:.1f}, timed pass {st['latency_s']:.1f}, "
          f"unswapped {unswapped_s:.1f}, paged {paged_s:.1f}, alone "
          f"{solo_s:.1f}, int8-lazy arm {arm_s:.1f}", flush=True)
    # every shape the phase's main-path runs launched a kernel at
    out["by_shape"] = since(main_launches, before)
    return out


# ---------------------------------------------------------------- deepseek
def run_deepseek(torch, main_launches):
    """Phase 11: deepseek-v2-lite's MLA stack at its published widths, 6
    layers, swapped from one fp32 mmap store at least 2.32x over its
    budget: (a) a 4,096-token prefill bitwise equal to the unswapped
    forward (B4 once a layer at q, k 192 / v 128, B5 at wq, wo and the
    shared expert's three); (b) ``decode_loop`` on the same store, each
    step's logits bitwise those of ``Model.decode_step`` on the card;
    (c) ``ServingEngine`` on the same prompts (B4 over the prompt, then
    the absorbed decode): in fp32 the absorption's identity, its first
    new token's logits within 1e-5 of ``Model.decode_step``'s absorbed
    decode; in bf16 its first-token logits within DS_BF16_TOL of the fp32
    engine's for each prompt whose last token is routed alike at every
    layer, each layer's routing flips and the bf16 gap to (b) printed."""
    import shutil

    import numpy as np
    from repro_torch.configs import get_arch
    from repro_torch.core.runtime import SwappedModel
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import moe
    from repro_torch.models.transformer import Model
    from repro_torch.serving.engine import Request, ServingEngine

    reset, collect = launch_counting(main_launches)
    before = {name: dict(keys) for name, keys in main_launches.items()}
    cfg = dataclasses.replace(get_arch("deepseek-v2-lite-16b"),
                              n_layers=DS_LAYERS)
    m, e = cfg.mla, cfg.moe
    print(f"model: {cfg.name} d_model {cfg.d_model}, {cfg.n_heads} heads, "
          f"MLA kv_lora_rank {m.kv_lora_rank}, qk_nope {m.qk_nope_head_dim}"
          f", qk_rope {m.qk_rope_head_dim}, v {m.v_head_dim}; "
          f"{e.n_routed} routed experts (top {e.top_k}) of {e.d_expert} + "
          f"a shared expert of {e.d_shared}, vocab {cfg.vocab_size}, tied "
          f"{cfg.tie_embeddings}, {cfg.dtype}; reduced: n_layers "
          f"27->{DS_LAYERS}", flush=True)
    t0 = time.perf_counter()
    model = Model(cfg)
    params = host_copy(torch, model.init(0, device="cuda"))
    n_params = sum(p.numel() for p in _leaves(params))
    n_bytes = sum(p.numel() * p.element_size() for p in _leaves(params))
    init_s = time.perf_counter() - t0
    P11_WORKDIR.parent.mkdir(parents=True, exist_ok=True)
    free = shutil.disk_usage(P11_WORKDIR.parent).free
    print(f"params: {n_params / 1e9:.3f} B, {n_bytes / 1e9:.2f} GB (fp32, "
          f"host), init on the card and copied down in {init_s:.1f} s; "
          f"{free / 1e9:.1f} GB free under build/", flush=True)
    require(free > 1.1 * n_bytes, f"phase 11: {free / 1e9:.1f} GB free, the "
            f"store needs {n_bytes / 1e9:.1f} GB")
    floor = p9_floor_budget(model, params, 1, DS_PROMPT)
    budget = int(P9_BUDGET_OVER_FLOOR * floor)
    rng = np.random.default_rng(11)
    batch = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (1, DS_PROMPT)), dtype=torch.int32)}
    prompts = rng.integers(0, cfg.vocab_size,
                           (DS_BATCH, DS_DECODE_PROMPT)).astype(np.int32)
    tag = "phase11 deepseek-v2-lite bf16 mmap"
    out = {"budget": budget, "floor": floor, "params": n_params}
    shutil.rmtree(P11_WORKDIR, ignore_errors=True)
    t_store = time.perf_counter()
    sm = SwappedModel(model, params, str(P11_WORKDIR), device="cuda",
                      store_backend="mmap", prefetch_depth=P9_M)
    try:
        out["store_s"] = time.perf_counter() - t_store
        resident = plan_at_floor(torch, sm, floor, budget, DS_PROMPT,
                                 out["store_s"], tag)
        ratio = resident / budget
        out.update(resident=resident, ratio=ratio)
        require(ratio >= DS_MIN_RATIO, f"{tag}: resident / budget "
                f"{ratio:.3f} < {DS_MIN_RATIO}")
        qmodel = Model(dataclasses.replace(cfg, n_layers=DS_Q_LAYERS))
        cut = cut_params(qmodel, params, model.plan)
        del params

        # ---- (a) the swapped prefill
        t0 = time.perf_counter()
        sm.forward(batch)                                          # warm
        warm_s = time.perf_counter() - t0
        sm.engine.stats.__init__()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset()
        logits, st = sm.forward(batch)
        counts = collect()
        max_alloc = torch.cuda.max_memory_allocated()
        want_key = (1, DS_PROMPT, cfg.n_heads, cfg.n_heads,
                    m.qk_nope_head_dim + m.qk_rope_head_dim, m.v_head_dim,
                    cfg.dtype, True, None, None, None,
                    fa.path(getattr(torch, cfg.dtype),
                            m.qk_nope_head_dim + m.qk_rope_head_dim,
                            m.v_head_dim))
        require(counts["flash_attention"] == DS_LAYERS
                and dict(fa.launches.by_shape) == {want_key: DS_LAYERS},
                f"{tag}: flash_attention launches {fa.launches.by_shape}, "
                f"expected {DS_LAYERS} at {want_key}")
        require(counts["swap_linear"] == 5 * DS_LAYERS,
                f"{tag}: swap_linear launched {counts['swap_linear']} times, "
                f"expected {5 * DS_LAYERS} (wq, wo, the shared expert's 3)")
        require(counts["swap_linear_q"] == 0, f"{tag}: swap_linear_q "
                f"launched {counts['swap_linear_q']} times")
        require(bool(torch.isfinite(logits).all())
                and tuple(logits.shape) == (1, 1, cfg.vocab_size),
                f"{tag}: logits {tuple(logits.shape)}, finite "
                f"{bool(torch.isfinite(logits).all())}")
        require(sm.engine.stats.peak_resident <= budget,
                f"{tag}: peak ledger {sm.engine.stats.peak_resident} over "
                f"budget {budget}")
        t0 = time.perf_counter()
        units = [sm.store.read_unit(u.name).params for u in sm.units]
        want = sm.forward_unswapped(batch, resident=units)
        unswapped_s = time.perf_counter() - t0
        require(torch.equal(logits, want),
                f"{tag}: swapped logits != unswapped logits")
        print(f"[{tag}] swapped logits == unswapped logits bitwise (1 x "
              f"{DS_PROMPT} tokens, {DS_LAYERS} layers at published widths,"
              f" the unswapped model holding all {resident / 1e9:.1f} GB; "
              f"{unswapped_s:.1f} s); flash_attention x {DS_LAYERS} at "
              f"{want_key[:6]}; warm pass {warm_s:.1f} s; launches {counts}",
              flush=True)
        out["prefill"] = report_prefill(tag, sm, st, budget, resident,
                                        max_alloc)
        out["prefill"]["warm_s"] = warm_s
        dev_params = resident_params(torch, sm, units)
        del units

        # ---- (b) weight-streaming decode, each step's logits recorded
        steps = []
        head = sm._head_logits

        def recording(uparams, h):
            r = head(uparams, h)
            steps.append(r)
            return r
        sm._head_logits = recording
        t0 = time.perf_counter()
        reset()
        try:
            gen, dstats = sm.decode_loop(
                torch.from_numpy(prompts), max_new_tokens=DS_DECODE_NEW,
                max_len=DS_DECODE_PROMPT + DS_DECODE_NEW)
        finally:
            del sm._head_logits
        dcounts = collect()
        decode_s = time.perf_counter() - t0
        passes = DS_DECODE_PROMPT + DS_DECODE_NEW - 1
        require(tuple(gen.shape) == (DS_BATCH, DS_DECODE_NEW)
                and len(steps) == passes,
                f"{tag}: decode {tuple(gen.shape)}, {len(steps)} steps")
        require(dcounts["flash_attention"] == 0
                and dcounts["swap_linear"] == 5 * DS_LAYERS * passes,
                f"{tag}: decode launches {dcounts}")
        require(dstats["peak_resident_mb"] * 1e6 <= budget,
                f"{tag}: decode peak ledger over budget")
        fed = np.concatenate([prompts, gen[:, :-1].cpu().numpy()], axis=1)
        cache = model.alloc_cache(DS_BATCH, DS_DECODE_PROMPT + DS_DECODE_NEW,
                                  device="cuda")
        for t in range(passes):
            step_logits, cache = model.decode_step(dev_params, cache, {
                "token": torch.as_tensor(fed[:, t:t + 1]).to("cuda"),
                "pos": torch.full((DS_BATCH,), t, dtype=torch.long,
                                  device="cuda")})
            require(torch.equal(step_logits, steps[t]),
                    f"{tag}: decode step {t} logits != Model.decode_step's")
        latent = sum(n * torch.empty((), dtype=dt).element_size()
                     for seg in model.cache_struct(
                         DS_BATCH, DS_DECODE_PROMPT + DS_DECODE_NEW)
                     for shape, dt in seg.values()
                     for n in [int(np.prod(shape))])
        hd = cfg.resolved_head_dim
        gqa = (DS_LAYERS * DS_BATCH * (DS_DECODE_PROMPT + DS_DECODE_NEW)
               * 2 * cfg.n_heads * hd * 2)
        print(f"[phase11 decode] {DS_BATCH} prompts x {DS_DECODE_PROMPT} "
              f"tokens, {DS_DECODE_NEW} new: {gen.tolist()}; {passes} "
              f"swapped passes in {decode_s:.1f} s, each step's logits == "
              f"Model.decode_step's bitwise; latent cache {latent} B "
              f"({latent // (DS_LAYERS * DS_BATCH * (passes + 1))}"
              f" B a token a layer) against {gqa} B for K and V of "
              f"{cfg.n_heads} heads x {hd} ({gqa / latent:.2f}x); launches "
              f"{dcounts}", flush=True)
        out["decode"] = {"tokens": gen.tolist(), "wall_s": decode_s,
                         "latent_cache_bytes": latent,
                         "gqa_cache_bytes": gqa, "launches": dcounts}

        # ---- (c) the in-memory engine: flash_attention over the prompt,
        # then the absorbed decode. The absorption's identity is held in
        # fp32: the engine's first-token logits (flash_attention on the
        # CUDA cores at q, k 192 / v 128) against Model.decode_step's
        # absorbed decode over the prompt, within 1e-5. The bf16 engine
        # (flash_attention on the tensor cores) is held to the fp32 one
        # within DS_BF16_TOL on each prompt whose last token takes the same
        # top-k experts at every layer in both runs; a flip is printed.
        L = DS_DECODE_PROMPT + DS_DECODE_NEW

        def engine_first(mdl):
            """The engine's first-token logits [B, 1, V], its tokens, and
            per layer the sorted experts of each prompt's last token
            [B, top_k] in its prefill."""
            first, routes = [], []
            prefill, route = mdl.prefill, moe.route

            def recording_route(c, router, xf):
                r = route(c, router, xf)
                routes.append(r[1])
                return r

            def recording_prefill(p, b):
                moe.route = recording_route
                try:
                    r = prefill(p, b)
                finally:
                    moe.route = route
                first.append(r[0])
                return r
            mdl.prefill = recording_prefill
            reqs = [Request(i, list(map(int, p)),
                            max_new_tokens=DS_DECODE_NEW)
                    for i, p in enumerate(prompts)]
            try:
                ServingEngine(mdl, dev_params, max_len=L,
                              device="cuda").generate(reqs)
            finally:
                del mdl.prefill
            require(len(first) == 1 and len(routes) == DS_LAYERS,
                    f"{tag}: {len(first)} engine prefills, {len(routes)} "
                    f"routings")
            last = [e.view(DS_BATCH, DS_DECODE_PROMPT, -1)[:, -1].sort(-1)
                    .values for e in routes]
            return first[0], [r.output for r in reqs], last

        t0 = time.perf_counter()
        reset()
        first16, etokens, routes16 = engine_first(model)
        ecounts = collect()
        engine_s = time.perf_counter() - t0
        require(ecounts["flash_attention"] == DS_LAYERS
                and bool(torch.isfinite(first16).all())
                and tuple(first16.shape) == (DS_BATCH, 1, cfg.vocab_size),
                f"{tag}: engine launches {ecounts}, logits "
                f"{tuple(first16.shape)}")
        model32 = Model(dataclasses.replace(cfg, dtype="float32"))
        with launch_delta() as eng32:
            first32, etokens32, routes32 = engine_first(model32)
        print(fp32_routes(eng32.by_shape, f"{tag} fp32 engine",
                          ("swap_linear",)), flush=True)
        cache = model32.alloc_cache(DS_BATCH, L, device="cuda")
        for t in range(DS_DECODE_PROMPT):
            absorbed32, cache = model32.decode_step(dev_params, cache, {
                "token": torch.as_tensor(prompts[:, t:t + 1]).to("cuda"),
                "pos": torch.full((DS_BATCH,), t, dtype=torch.long,
                                  device="cuda")})
        ierr = rel_err(torch, first32, absorbed32)
        require(ierr[1] <= TOL["float32"], f"{tag}: fp32 engine first-token "
                f"logits vs the absorbed decode's: rel {ierr[1]:.3g} > "
                f"{TOL['float32']}")
        # flips[b][l]: prompt b's last token takes other experts at layer l
        flips = [[int(not torch.equal(a[b], c[b]))
                  for a, c in zip(routes16, routes32)]
                 for b in range(DS_BATCH)]
        gaps = [rel_err(torch, first16[b], first32[b])[1]
                for b in range(DS_BATCH)]
        held = [b for b in range(DS_BATCH) if not any(flips[b])]
        require(held, f"{tag}: every prompt's last token routed otherwise "
                f"in bf16 than in fp32 (flips by layer {flips}); no bf16 "
                f"engine logits held")
        for b in held:
            require(gaps[b] <= DS_BF16_TOL, f"{tag}: bf16 engine first-token "
                    f"logits of prompt {b} vs the fp32 engine's: rel "
                    f"{gaps[b]:.4g} > {DS_BF16_TOL}")
        ref = steps[DS_DECODE_PROMPT - 1]
        gap16 = rel_err(torch, first16, ref)[1]
        print(f"[phase11 engine] bf16 ServingEngine tokens {etokens} "
              f"(decode_loop's {gen.tolist()}); fp32 {etokens32}; "
              f"first-token logits, flash_attention over the prompt vs the "
              f"absorbed decode: fp32 rel {ierr[1]:.3g} <= "
              f"{TOL['float32']} (max abs {ierr[0]:.3g}); bf16 vs fp32 "
              f"engine by prompt rel {[float(f'{g:.4g}') for g in gaps]}, "
              f"held <= {DS_BF16_TOL} on prompts {held} (last-token routing "
              f"flips by prompt and layer {flips}); bf16 engine vs bf16 "
              f"absorbed decode rel {gap16:.4g} (printed); bf16 engine "
              f"{engine_s:.2f} s; launches {ecounts}", flush=True)
        out["engine"] = {"tokens": etokens, "tokens_fp32": etokens32,
                         "fp32_rel_err": ierr[1], "bf16_vs_fp32": gaps,
                         "routing_flips": flips, "bf16_rel_gap": gap16,
                         "launches": ecounts}
        del dev_params, cache
    finally:
        sm.close()
        shutil.rmtree(P11_WORKDIR, ignore_errors=True)
    torch.cuda.empty_cache()

    # ---- (d) the int8-lazy arm: wq, wo and the shared expert's three
    # through B1 a layer, and the head; the routed stacks, the router and
    # the latent projections widened on the host
    t0 = time.perf_counter()
    out["int8_lazy"] = quant_arm(
        torch, f"phase11 {cfg.name} bf16 int8-lazy, {DS_Q_LAYERS} layers",
        qmodel, cut, batch, DS_PROMPT, P11_WORKDIR / "int8-lazy", reset,
        collect, {"swap_linear_q": 5 * DS_Q_LAYERS + 1, "swap_linear": 0,
                  "flash_attention": DS_Q_LAYERS, "dequant_int8": 0})
    del cut
    arm_s = time.perf_counter() - t0
    print(f"[phase11] wall s: init {init_s:.1f}, store "
          f"{out['store_s']:.1f}, warm pass {warm_s:.1f}, timed pass "
          f"{st['latency_s']:.1f}, unswapped {unswapped_s:.1f}, decode "
          f"{decode_s:.1f}, engine {engine_s:.1f}, int8-lazy arm "
          f"{arm_s:.1f}", flush=True)
    out["by_shape"] = since(main_launches, before)
    return out


# ---------------------------------------------------------------- zamba2
def run_zamba2(torch, main_launches):
    """Phase 12: zamba2-7b's hybrid stack at its published widths, 18
    layers (15 Mamba2, the shared attention block at 5, 11 and 17),
    swapped from one fp32 mmap store at least 2.32x over its ledger
    budget: (a) a 4,096-token prefill bitwise equal to the unswapped
    forward (B4 once a shared occurrence at hd 112, B5 at the shared
    block's 7 linears and each Mamba2 ``wo``), the shared unit read from
    the store at most once a pass and pinned, its later occurrences cache
    hits, only its bytes charged after the pass; (b) ``decode_loop`` on
    the same store, each step's logits bitwise those of
    ``Model.decode_step`` on the card; (c) ``ServingEngine`` on the same
    prompts: in fp32 its first new token's logits (chunked SSD and B4 over
    the prompt) within 1e-4 of ``Model.decode_step`` fed the prompt token
    by token; in bf16 its gap to the fp32 engine printed."""
    import shutil

    import numpy as np
    from repro_torch.configs import get_arch
    from repro_torch.core.runtime import SwappedModel
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.ssm import mamba2_dims
    from repro_torch.models.transformer import Model
    from repro_torch.serving.engine import Request, ServingEngine

    reset, collect = launch_counting(main_launches)
    before = {name: dict(keys) for name, keys in main_launches.items()}
    cfg = dataclasses.replace(get_arch("zamba2-7b"), n_layers=Z_LAYERS)
    s = cfg.ssm
    d_inner, nh, ds = mamba2_dims(cfg)
    kinds = cfg.layer_kinds()
    n_shared = kinds.count("shared_attn")
    n_mamba = kinds.count("mamba2")
    hd = cfg.resolved_head_dim
    print(f"model: {cfg.name} d_model {cfg.d_model}, shared attention "
          f"{cfg.n_heads} heads / {cfg.n_kv_heads} KV heads of {hd}, d_ff "
          f"{cfg.d_ff} at positions "
          f"{[i for i, k in enumerate(kinds) if k == 'shared_attn']}; "
          f"Mamba2 d_state {ds}, head_dim {s.head_dim} ({nh} heads, "
          f"d_inner {d_inner}), d_conv {s.d_conv}, chunk {s.chunk}; vocab "
          f"{cfg.vocab_size}, tied {cfg.tie_embeddings}, {cfg.dtype}; "
          f"reduced: n_layers 81->{cfg.n_layers}", flush=True)
    t0 = time.perf_counter()
    model = Model(cfg)
    params = host_copy(torch, model.init(0, device="cuda"))
    n_params = sum(p.numel() for p in _leaves(params))
    n_bytes = sum(p.numel() * p.element_size() for p in _leaves(params))
    init_s = time.perf_counter() - t0
    P12_WORKDIR.parent.mkdir(parents=True, exist_ok=True)
    free = shutil.disk_usage(P12_WORKDIR.parent).free
    print(f"params: {n_params / 1e9:.3f} B, {n_bytes / 1e9:.2f} GB (fp32, "
          f"host; the shared block once), init on the card and copied down "
          f"in {init_s:.1f} s; {free / 1e9:.1f} GB free under build/",
          flush=True)
    require(free > 1.1 * n_bytes, f"phase 12: {free / 1e9:.1f} GB free, the "
            f"store needs {n_bytes / 1e9:.1f} GB")
    floor = p9_floor_budget(model, params, 1, Z_PROMPT)
    budget = int(P9_BUDGET_OVER_FLOOR * floor)
    rng = np.random.default_rng(12)
    batch = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (1, Z_PROMPT)), dtype=torch.int32)}
    prompts = rng.integers(0, cfg.vocab_size,
                           (Z_BATCH, Z_DECODE_PROMPT)).astype(np.int32)
    tag = "phase12 zamba2-7b bf16 mmap"
    out = {"budget": budget, "floor": floor, "params": n_params}
    shutil.rmtree(P12_WORKDIR, ignore_errors=True)
    t_store = time.perf_counter()
    sm = SwappedModel(model, params, str(P12_WORKDIR), device="cuda",
                      store_backend="mmap", prefetch_depth=P9_M)
    try:
        out["store_s"] = time.perf_counter() - t_store
        pinned = sorted(sm.engine.pinned)
        require(pinned == ["shared_attn"], f"{tag}: pinned units {pinned}")
        shared = sm.store.resident_nbytes("shared_attn")
        ledger_budget = budget + shared
        resident = plan_at_floor(torch, sm, floor, budget, Z_PROMPT,
                                 out["store_s"], tag,
                                 ledger_budget=ledger_budget)
        ratio = resident / ledger_budget
        stored = len(sm.store.skeletons)
        out.update(resident=resident, ratio=ratio, shared=shared,
                   ledger_budget=ledger_budget)
        require(stored == len(sm.units) - n_shared + 1,
                f"{tag}: {stored} units stored for {len(sm.units)} "
                f"({n_shared} shared occurrences)")
        require(ratio >= Z_MIN_RATIO, f"{tag}: resident / ledger budget "
                f"{ratio:.3f} < {Z_MIN_RATIO}")
        qmodel = Model(dataclasses.replace(cfg, n_layers=Z_Q_LAYERS))
        cut = cut_params(qmodel, params, model.plan)
        del params

        # ---- (a) the swapped prefill; every store read counted by unit
        reads = {}
        read_unit = sm.store.read_unit

        def counted(name):
            reads[name] = reads.get(name, 0) + 1
            return read_unit(name)
        sm.store.read_unit = counted
        try:
            t0 = time.perf_counter()
            sm.forward(batch)                                      # warm
            warm_s = time.perf_counter() - t0
            warm_reads = dict(reads)
            reads.clear()
            sm.engine.stats.__init__()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset()
            logits, st = sm.forward(batch)
            counts = collect()
        finally:
            del sm.store.read_unit
        max_alloc = torch.cuda.max_memory_allocated()
        es = sm.engine.stats
        want_key = (1, Z_PROMPT, cfg.n_heads, cfg.n_kv_heads, hd, hd,
                    cfg.dtype, True, None, None, None,
                    fa.path(getattr(torch, cfg.dtype), hd))
        launched = dict(fa.launches.by_shape)
        require(counts["flash_attention"] == n_shared
                and launched == {want_key: n_shared}
                and fa.path(torch.bfloat16, hd) == "tc",
                f"{tag}: flash_attention launches {launched}, expected "
                f"{n_shared} at {want_key} on the tensor cores")
        require(counts["swap_linear"] == 7 * n_shared + n_mamba,
                f"{tag}: swap_linear launched {counts['swap_linear']} times, "
                f"expected {7 * n_shared + n_mamba} (the shared block's 7 "
                f"x {n_shared}, Mamba2 wo x {n_mamba})")
        require(counts["swap_linear_q"] == 0, f"{tag}: swap_linear_q "
                f"launched {counts['swap_linear_q']} times")
        require(warm_reads.get("shared_attn") == 1
                and reads.get("shared_attn", 0) <= 1,
                f"{tag}: the shared unit read {warm_reads.get('shared_attn')}"
                f" times in the warm pass, {reads.get('shared_attn', 0)} in "
                f"the timed one")
        require(es.cache_hits >= n_shared - reads.get("shared_attn", 0)
                and st["cache_hit_rate"] > 0,
                f"{tag}: {es.cache_hits} cache hits, rate "
                f"{st['cache_hit_rate']:.3f}")
        require(es.peak_resident <= ledger_budget,
                f"{tag}: peak ledger {es.peak_resident} over the ledger "
                f"budget {ledger_budget}")
        require(sm.engine.ledger.resident == shared,
                f"{tag}: {sm.engine.ledger.resident} B charged after the "
                f"pass, the shared unit holds {shared}")
        require(bool(torch.isfinite(logits).all())
                and tuple(logits.shape) == (1, 1, cfg.vocab_size),
                f"{tag}: logits {tuple(logits.shape)}, finite "
                f"{bool(torch.isfinite(logits).all())}")
        t0 = time.perf_counter()
        stored_params = {n: sm.store.read_unit(n).params
                         for n in dict.fromkeys(u.name for u in sm.units)}
        units = [stored_params[u.name] for u in sm.units]
        want = sm.forward_unswapped(batch, resident=units)
        unswapped_s = time.perf_counter() - t0
        require(torch.equal(logits, want),
                f"{tag}: swapped logits != unswapped logits")
        print(f"[{tag}] swapped logits == unswapped logits bitwise (1 x "
              f"{Z_PROMPT} tokens, {cfg.n_layers} layers at published "
              f"widths,"
              f" the unswapped model holding all {resident / 1e9:.1f} GB; "
              f"{unswapped_s:.1f} s); flash_attention x {n_shared} at "
              f"{want_key[:7]}; the shared unit read "
              f"{warm_reads['shared_attn']} x in the warm pass and {reads.get('shared_attn', 0)}"
              f" x in the timed one, {es.cache_hits} cache hits (rate "
              f"{st['cache_hit_rate']:.3f}), {sm.engine.ledger.resident} B "
              f"charged after the pass (the shared unit's {shared}); warm "
              f"pass {warm_s:.1f} s; launches {counts}", flush=True)
        out["prefill"] = report_prefill(tag, sm, st, ledger_budget,
                                        resident, max_alloc)
        out["prefill"].update(warm_s=warm_s, reads=reads,
                              cache_hits=es.cache_hits)
        dev_params = resident_params(torch, sm, units)
        del units, stored_params

        # ---- (b) weight-streaming decode, each step's logits recorded
        steps = []
        head = sm._head_logits

        def recording(uparams, h):
            r = head(uparams, h)
            steps.append(r)
            return r
        sm._head_logits = recording
        L = Z_DECODE_PROMPT + Z_DECODE_NEW
        t0 = time.perf_counter()
        reset()
        try:
            gen, dstats = sm.decode_loop(
                torch.from_numpy(prompts), max_new_tokens=Z_DECODE_NEW,
                max_len=L)
        finally:
            del sm._head_logits
        dcounts = collect()
        decode_s = time.perf_counter() - t0
        passes = L - 1
        require(tuple(gen.shape) == (Z_BATCH, Z_DECODE_NEW)
                and len(steps) == passes,
                f"{tag}: decode {tuple(gen.shape)}, {len(steps)} steps")
        require(dcounts["flash_attention"] == 0
                and dcounts["swap_linear"]
                == (7 * n_shared + n_mamba) * passes,
                f"{tag}: decode launches {dcounts}")
        require(dstats["peak_resident_mb"] * 1e6 <= ledger_budget,
                f"{tag}: decode peak ledger over the ledger budget")
        fed = np.concatenate([prompts, gen[:, :-1].cpu().numpy()], axis=1)
        cache = model.alloc_cache(Z_BATCH, L, device="cuda")
        for t in range(passes):
            step_logits, cache = model.decode_step(dev_params, cache, {
                "token": torch.as_tensor(fed[:, t:t + 1]).to("cuda"),
                "pos": torch.full((Z_BATCH,), t, dtype=torch.long,
                                  device="cuda")})
            require(torch.equal(step_logits, steps[t]),
                    f"{tag}: decode step {t} logits != Model.decode_step's")
        structs = model.cache_struct(1, 1)
        mamba = next(c for c, seg in zip(structs, model.plan)
                     if seg.kind == "mamba2")
        attn = next(c for c, seg in zip(structs, model.plan)
                    if seg.kind == "shared_attn")

        def nbytes(shape, dt):
            return int(np.prod(shape)) * torch.empty(
                (), dtype=dt).element_size()
        h_b = nbytes(mamba["h"][0][1:], mamba["h"][1])       # one layer
        conv_b = nbytes(mamba["conv"][0][1:], mamba["conv"][1])
        kv_b = sum(nbytes(*attn[k]) for k in ("k", "v"))      # a token
        print(f"[phase12 decode] {Z_BATCH} prompts x {Z_DECODE_PROMPT} "
              f"tokens, {Z_DECODE_NEW} new: {gen.tolist()}; {passes} "
              f"swapped passes in {decode_s:.1f} s, each step's logits == "
              f"Model.decode_step's bitwise; state a sequence: {h_b} B of h "
              f"and {conv_b} B of conv per Mamba2 layer ({n_mamba} layers: "
              f"{n_mamba * (h_b + conv_b)} B, whatever the length) against "
              f"{kv_b} B of K/V a token per shared occurrence ({n_shared}: "
              f"{n_shared * kv_b} B a token); launches {dcounts}", flush=True)
        out["decode"] = {"tokens": gen.tolist(), "wall_s": decode_s,
                         "h_bytes": h_b, "conv_bytes": conv_b,
                         "kv_bytes_a_token": kv_b, "launches": dcounts}

        # ---- (c) the in-memory engine: chunked SSD and flash_attention over
        # the prompt, held in fp32 to the step-by-step decode of the prompt
        def engine_first(mdl):
            """The engine's first-token logits [B, 1, V] and its tokens."""
            first = []
            prefill = mdl.prefill

            def recording_prefill(p, b):
                r = prefill(p, b)
                first.append(r[0])
                return r
            mdl.prefill = recording_prefill
            reqs = [Request(i, list(map(int, p)),
                            max_new_tokens=Z_DECODE_NEW)
                    for i, p in enumerate(prompts)]
            try:
                ServingEngine(mdl, dev_params, max_len=L,
                              device="cuda").generate(reqs)
            finally:
                del mdl.prefill
            require(len(first) == 1, f"{tag}: {len(first)} engine prefills")
            return first[0], [r.output for r in reqs]

        t0 = time.perf_counter()
        reset()
        first16, etokens = engine_first(model)
        ecounts = collect()
        engine_s = time.perf_counter() - t0
        require(ecounts["flash_attention"] == n_shared
                and bool(torch.isfinite(first16).all())
                and tuple(first16.shape) == (Z_BATCH, 1, cfg.vocab_size),
                f"{tag}: engine launches {ecounts}, logits "
                f"{tuple(first16.shape)}")
        model32 = Model(dataclasses.replace(cfg, dtype="float32"))
        with launch_delta() as eng32:
            first32, etokens32 = engine_first(model32)
        print(fp32_routes(eng32.by_shape, f"{tag} fp32 engine",
                          ("swap_linear", "flash_attention")), flush=True)
        cache = model32.alloc_cache(Z_BATCH, L, device="cuda")
        for t in range(Z_DECODE_PROMPT):
            stepped32, cache = model32.decode_step(dev_params, cache, {
                "token": torch.as_tensor(prompts[:, t:t + 1]).to("cuda"),
                "pos": torch.full((Z_BATCH,), t, dtype=torch.long,
                                  device="cuda")})
        ierr = rel_err(torch, first32, stepped32)
        require(ierr[1] <= Z_ENGINE_TOL, f"{tag}: fp32 engine first-token "
                f"logits vs the step-by-step decode's: rel {ierr[1]:.3g} > "
                f"{Z_ENGINE_TOL}")
        gap16 = rel_err(torch, first16, first32)[1]
        print(f"[phase12 engine] bf16 ServingEngine tokens {etokens} "
              f"(decode_loop's {gen.tolist()}); fp32 {etokens32}; "
              f"first-token logits, chunked SSD and flash_attention over "
              f"the prompt vs the step-by-step decode: fp32 rel "
              f"{ierr[1]:.3g} <= {Z_ENGINE_TOL} (max abs {ierr[0]:.3g}); "
              f"bf16 engine vs fp32 engine rel {gap16:.4g} (printed); "
              f"bf16 engine {engine_s:.2f} s; launches {ecounts}",
              flush=True)
        out["engine"] = {"tokens": etokens, "tokens_fp32": etokens32,
                         "fp32_rel_err": ierr[1], "bf16_rel_gap": gap16,
                         "launches": ecounts}
        del dev_params, cache
    finally:
        sm.close()
        shutil.rmtree(P12_WORKDIR, ignore_errors=True)
    torch.cuda.empty_cache()

    # ---- (d) the int8-lazy arm: each Mamba2 wo and the shared block's 7
    # through B1, the block pinned as a lazy quantized unit, and the tied
    # head (embed.T, quantized per vocab column); in_proj and the
    # embedding widened on the host
    qkinds = qmodel.cfg.layer_kinds()
    t0 = time.perf_counter()
    out["int8_lazy"] = quant_arm(
        torch, f"phase12 {cfg.name} bf16 int8-lazy, {Z_Q_LAYERS} layers",
        qmodel, cut, batch, Z_PROMPT, P12_WORKDIR / "int8-lazy", reset,
        collect, {"swap_linear_q": qkinds.count("mamba2")
                  + 7 * qkinds.count("shared_attn") + 1,
                  "swap_linear": 0,
                  "flash_attention": qkinds.count("shared_attn"),
                  "dequant_int8": 0})
    del cut
    arm_s = time.perf_counter() - t0
    print(f"[phase12] wall s: init {init_s:.1f}, store "
          f"{out['store_s']:.1f}, warm pass {warm_s:.1f}, timed pass "
          f"{st['latency_s']:.1f}, unswapped {unswapped_s:.1f}, decode "
          f"{decode_s:.1f}, engine {engine_s:.1f}, int8-lazy arm "
          f"{arm_s:.1f}", flush=True)
    out["by_shape"] = since(main_launches, before)
    return out


# ---------------------------------------------------------------- qwen2-vl
def vl_positions(np, B, S, nv, grid):
    """[B, S, 3] M-RoPE positions, built here as the caller's input (the
    package builds none): the temporal stream is the token index, so the
    mask, which reads that stream, is the index mask; h and w carry the
    ``grid`` x ``grid`` patch grid (``i // grid``, ``i % grid``) over the
    ``nv`` vision tokens and the index over the text."""
    i = np.arange(S)
    pos = np.stack([i, np.where(i < nv, i // grid, i),
                    np.where(i < nv, i % grid, i)], axis=-1)
    return np.broadcast_to(pos, (B, S, 3)).astype(np.int32).copy()


def run_qwen2_vl(torch, main_launches):
    """Phase 13: qwen2-vl-72b at its published widths, 4 layers, swapped
    from one fp32 mmap store at least 2.32x over its budget: a 2,048-token
    prefill (1,024 seeded vision embeddings through the frontend, then
    1,024 text tokens, M-RoPE on the patch grid) bitwise equal to the
    unswapped forward, B4 once a layer at 64 / 8 heads of 128 and B5 seven
    times a layer (q / k / v with bias); moving only the vision tokens'
    h / w streams moves the logits; then two text-only paged generations
    (B3 with [B, 1, 3] positions) equal to each request served alone."""
    import shutil

    import numpy as np
    from repro_torch.configs import get_arch
    from repro_torch.core.runtime import SwappedModel
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.transformer import Model
    from repro_torch.serving.paged_kv import PagedKVCache

    reset, collect = launch_counting(main_launches)
    before = {name: dict(keys) for name, keys in main_launches.items()}
    cfg = dataclasses.replace(get_arch("qwen2-vl-72b"), n_layers=VL_LAYERS)
    hd = cfg.resolved_head_dim
    require(cfg.n_vision_tokens == VL_VISION and VL_GRID ** 2 == VL_VISION,
            f"phase 13: {cfg.n_vision_tokens} vision tokens")
    print(f"model: {cfg.name} d_model {cfg.d_model}, {cfg.n_heads} heads / "
          f"{cfg.n_kv_heads} KV heads of {hd}, q/k/v bias {cfg.attn_bias}, "
          f"d_ff {cfg.d_ff} ({cfg.act}), vocab {cfg.vocab_size}, tied "
          f"{cfg.tie_embeddings}, M-RoPE sections {cfg.mrope_sections} "
          f"theta {cfg.rope_theta:g}, {cfg.n_vision_tokens} vision tokens "
          f"at d_frontend {cfg.d_frontend}, {cfg.dtype}; reduced: n_layers "
          f"80->{VL_LAYERS}", flush=True)
    t0 = time.perf_counter()
    model = Model(cfg)
    params = host_copy(torch, model.init(0, device="cuda"))
    n_params = sum(p.numel() for p in _leaves(params))
    n_bytes = sum(p.numel() * p.element_size() for p in _leaves(params))
    init_s = time.perf_counter() - t0
    P13_WORKDIR.parent.mkdir(parents=True, exist_ok=True)
    free = shutil.disk_usage(P13_WORKDIR.parent).free
    print(f"params: {n_params / 1e9:.3f} B, {n_bytes / 1e9:.2f} GB (fp32, "
          f"host), init on the card and copied down in {init_s:.1f} s; "
          f"{free / 1e9:.1f} GB free under build/", flush=True)
    require(free > 1.1 * n_bytes, f"phase 13: {free / 1e9:.1f} GB free, the "
            f"store needs {n_bytes / 1e9:.1f} GB")
    floor = p9_floor_budget(model, params, 1, VL_PROMPT)
    budget = int(P9_BUDGET_OVER_FLOOR * floor)
    rng = np.random.default_rng(13)
    positions = vl_positions(np, 1, VL_PROMPT, VL_VISION, VL_GRID)
    batch = {"tokens": torch.as_tensor(
                 rng.integers(0, cfg.vocab_size, (1, VL_PROMPT)),
                 dtype=torch.int32),
             "vision_embeds": torch.from_numpy(rng.standard_normal(
                 (1, VL_VISION, cfg.d_frontend)).astype(np.float32)),
             "positions": torch.from_numpy(positions)}
    tag = "phase13 qwen2-vl-72b bf16 mmap"
    out = {"budget": budget, "floor": floor, "params": n_params}
    shutil.rmtree(P13_WORKDIR, ignore_errors=True)
    t_store = time.perf_counter()
    sm = SwappedModel(model, params, str(P13_WORKDIR), device="cuda",
                      store_backend="mmap", prefetch_depth=P9_M)
    try:
        out["store_s"] = time.perf_counter() - t_store
        resident = plan_at_floor(torch, sm, floor, budget, VL_PROMPT,
                                 out["store_s"], tag)
        ratio = resident / budget
        out.update(resident=resident, ratio=ratio)
        require(ratio >= VL_MIN_RATIO, f"{tag}: resident / budget "
                f"{ratio:.3f} < {VL_MIN_RATIO}")
        qmodel = Model(dataclasses.replace(cfg, n_layers=VL_Q_LAYERS))
        cut = cut_params(qmodel, params, model.plan)
        del params

        t0 = time.perf_counter()
        sm.forward(batch)                                          # warm
        warm_s = time.perf_counter() - t0
        sm.engine.stats.__init__()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset()
        logits, st = sm.forward(batch)
        counts = collect()
        max_alloc = torch.cuda.max_memory_allocated()
        want_key = (1, VL_PROMPT, cfg.n_heads, cfg.n_kv_heads, hd, hd,
                    cfg.dtype, True, None, None, None,
                    fa.path(getattr(torch, cfg.dtype), hd))
        launched = dict(fa.launches.by_shape)
        require(counts["flash_attention"] == VL_LAYERS
                and launched == {want_key: VL_LAYERS},
                f"{tag}: flash_attention launches {launched}, expected "
                f"{VL_LAYERS} at {want_key}")
        require(counts["swap_linear"] == 7 * VL_LAYERS,
                f"{tag}: swap_linear launched {counts['swap_linear']} times, "
                f"expected {7 * VL_LAYERS}")
        require(counts["swap_linear_q"] == 0, f"{tag}: swap_linear_q "
                f"launched {counts['swap_linear_q']} times")
        require(bool(torch.isfinite(logits).all())
                and tuple(logits.shape) == (1, 1, cfg.vocab_size),
                f"{tag}: logits {tuple(logits.shape)}, finite "
                f"{bool(torch.isfinite(logits).all())}")
        require(sm.engine.stats.peak_resident <= budget,
                f"{tag}: peak ledger {sm.engine.stats.peak_resident} over "
                f"budget {budget}")
        t0 = time.perf_counter()
        units = [sm.store.read_unit(u.name).params for u in sm.units]
        want = sm.forward_unswapped(batch, resident=units)
        unswapped_s = time.perf_counter() - t0
        require(torch.equal(logits, want),
                f"{tag}: swapped logits != unswapped logits")
        # the vision tokens' h and w streams swapped (the patch grid
        # transposed), nothing else: only M-RoPE's h / w sections change
        moved = positions.copy()
        moved[0, :VL_VISION, 1:] = positions[0, :VL_VISION, :0:-1]
        reset()
        moved_logits = sm.forward_unswapped(
            dict(batch, positions=torch.from_numpy(moved)), resident=units)
        mcounts = collect()
        del units
        torch.cuda.empty_cache()
        moved_rel = rel_err(torch, moved_logits, logits)[1]
        require(mcounts["flash_attention"] == VL_LAYERS and moved_rel > 1e-3,
                f"{tag}: the transposed grid moved the logits by rel "
                f"{moved_rel:.3g}; launches {mcounts}")
        print(f"[{tag}] swapped logits == unswapped logits bitwise (1 x "
              f"{VL_PROMPT} tokens, {VL_VISION} of them vision embeddings "
              f"through the frontend, {VL_LAYERS} layers at published "
              f"widths, the unswapped model holding all "
              f"{resident / 1e9:.1f} GB; {unswapped_s:.1f} s); "
              f"flash_attention x {VL_LAYERS} at {want_key[:7]}; the vision "
              f"tokens' h / w streams transposed move the logits by rel "
              f"{moved_rel:.4g}; warm pass {warm_s:.1f} s; launches "
              f"{counts}", flush=True)
        out["prefill"] = report_prefill(tag, sm, st, budget, resident,
                                        max_alloc)
        out["prefill"].update(warm_s=warm_s, moved_rel=moved_rel)

        # two text-only paged generations on the same store and budget,
        # then each request alone
        prompts = [list(map(int, rng.integers(0, cfg.vocab_size, n)))
                   for n in VL_PAGED_PROMPTS]
        new = [VL_PAGED_NEW] * len(prompts)
        kv = PagedKVCache(cfg, sm.engine.ledger, page_tokens=PAGE_TOKENS,
                          max_pages=VL_MAX_PAGES, device="cuda")
        t0 = time.perf_counter()
        reqs, be, pcounts, windows, alloc0 = drive_paged(
            torch, sm, kv, prompts, new, len(prompts), reset, collect)
        out["paged"] = report_paged(torch, "phase13 paged", sm, kv, be,
                                    budget, windows, alloc0)
        check_paged_run("phase13 paged", kv, be, pcounts, VL_LAYERS, budget)
        paged_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        solo = []
        for p, n in zip(prompts, new):
            sreqs, sbe, scounts, _, _ = drive_paged(
                torch, sm, kv, [p], [n], 1, reset, collect)
            check_paged_run("phase13 alone", kv, sbe, scounts, VL_LAYERS,
                            budget)
            solo.append(sreqs[0].output)
        solo_s = time.perf_counter() - t0
        got = [r.output for r in reqs]
        require(got == solo and all(len(t) == VL_PAGED_NEW for t in got),
                f"{tag}: paged tokens {got} != served alone {solo}")
        steps = sum(1 for t in be.trace if t.batch)
        print(f"[phase13 paged] {len(prompts)} text requests (prompts "
              f"{VL_PAGED_PROMPTS}, {VL_PAGED_NEW} new tokens each, M-RoPE "
              f"positions [B, 1, 3] a step) == each served alone: {got}; "
              f"{steps} decode steps, paged_attention x "
              f"{pcounts['paged_attention']} ({VL_LAYERS} layers x {steps});"
              f" batched {paged_s:.1f} s, alone {solo_s:.1f} s; launches "
              f"{pcounts}", flush=True)
        out["paged"].update(tokens=got, batched_s=paged_s, solo_s=solo_s)
    finally:
        sm.close()
        shutil.rmtree(P13_WORKDIR, ignore_errors=True)
    torch.cuda.empty_cache()

    # ---- the int8-lazy arm: the biased wq / wk / wv at K 8,192, wo, the
    # MLP at N 29,568 and its wo at K 29,568, and the head at N 152,064
    # through B1; the embedding and the frontend widened on the host
    t0 = time.perf_counter()
    out["int8_lazy"] = quant_arm(
        torch, f"phase13 {cfg.name} bf16 int8-lazy, {VL_Q_LAYERS} layer",
        qmodel, cut, batch, VL_PROMPT, P13_WORKDIR / "int8-lazy", reset,
        collect, {"swap_linear_q": 7 * VL_Q_LAYERS + 1, "swap_linear": 0,
                  "flash_attention": VL_Q_LAYERS, "dequant_int8": 0})
    del cut
    arm_s = time.perf_counter() - t0
    print(f"[phase13] wall s: init {init_s:.1f}, store "
          f"{out['store_s']:.1f}, warm pass {warm_s:.1f}, timed pass "
          f"{st['latency_s']:.1f}, unswapped and moved grid "
          f"{unswapped_s:.1f}, paged {paged_s:.1f}, alone {solo_s:.1f}, "
          f"int8-lazy arm {arm_s:.1f}", flush=True)
    out["by_shape"] = since(main_launches, before)
    return out


# ---------------------------------------------------------------- hubert
def run_hubert(torch, main_launches):
    """Phase 14: hubert-xlarge's bidirectional audio encoder at its
    published widths and full depth (48 layers), swapped from one fp32
    mmap store under 1.1x the smallest budget on a 0.01 GB grid at which
    the planner packs it at m = 2: a forward of 2 x 1,500 seeded frame
    features (the conv extractor's output, which the stub stands for)
    bitwise equal to the unswapped forward, B4 once a layer without a
    causal mask at 16 / 16 heads of 80 (the CUDA-core kernel) and B5 six
    times a layer. No decode, no paged path, no quant store: the model is
    an encoder and opts out of quantized units."""
    import shutil

    import numpy as np
    from repro_torch.configs import get_arch
    from repro_torch.core.cost_model import DelayModel, resident_infos
    from repro_torch.core.partition import PartitionPlanner
    from repro_torch.core.runtime import SwappedModel, unit_infos
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.transformer import Model
    from repro_torch.tree import tree_map

    reset, collect = launch_counting(main_launches)
    before = {name: dict(keys) for name, keys in main_launches.items()}
    cfg = get_arch("hubert-xlarge")
    hd = cfg.resolved_head_dim
    print(f"model: {cfg.name} d_model {cfg.d_model}, {cfg.n_heads} heads / "
          f"{cfg.n_kv_heads} KV heads of {hd}, d_ff {cfg.d_ff} "
          f"({cfg.act}), vocab {cfg.vocab_size}, d_frontend "
          f"{cfg.d_frontend}, rope {cfg.rope_type}, encoder "
          f"{cfg.is_encoder}, quant_eligible {cfg.quant_eligible}, "
          f"{cfg.dtype}; every layer ({cfg.n_layers})", flush=True)
    t0 = time.perf_counter()
    model = Model(cfg)
    params = host_copy(torch, model.init(1, device="cuda"))
    n_params = sum(p.numel() for p in _leaves(params))
    init_s = time.perf_counter() - t0
    print(f"params: {n_params / 1e9:.3f} B (fp32, host), init on the card "
          f"and copied down in {init_s:.1f} s", flush=True)
    rng = np.random.default_rng(14)
    batch = {"features": torch.from_numpy(rng.standard_normal(
        (HB_BATCH, HB_FRAMES, cfg.d_frontend)).astype(np.float32))}
    tag = "phase14 hubert-xlarge bf16 mmap"
    out = {"params": n_params}
    shutil.rmtree(P14_WORKDIR, ignore_errors=True)
    P14_WORKDIR.parent.mkdir(parents=True, exist_ok=True)
    t_store = time.perf_counter()
    sm = SwappedModel(model, params, str(P14_WORKDIR), device="cuda",
                      store_backend="mmap", prefetch_depth=P9_M)
    try:
        out["store_s"] = time.perf_counter() - t_store
        # the floor, the plan and the check a grid step below on ONE
        # planner over the store's resident unit table (what ``partition``
        # builds): its lookup tables are built once, not per budget, which
        # at ~48 blocks of 50 units costs seconds a block count
        t0 = time.perf_counter()
        names = [u.name for u in sm.units]
        pp = PartitionPlanner(resident_infos(
            unit_infos(model, sm.units, HB_BATCH, HB_FRAMES),
            sm.engine.store, names), DelayModel(), m=P9_M)
        floor = grid_floor(pp, P14_GRID)
        budget = int(P9_BUDGET_OVER_FLOOR * floor)
        plan, _ = pp.best_partition(budget, 0.05)
        require(plan.m == P9_M, f"{tag}: planned m={plan.m} at "
                f"{budget / 1e9:.3f} GB")
        sm.set_plan(plan.points)
        sm.engine.ledger.budget = budget
        for u in sm.units:          # the store is the weights' only home
            u.params = tree_map(lambda a: torch.empty(
                a.shape, dtype=a.dtype, device="meta"), u.params)
        resident = sum(sm.store.resident_nbytes(n) for n in names)
        ratio = resident / budget
        out.update(resident=resident, ratio=ratio, budget=budget,
                   floor=floor, plan_s=time.perf_counter() - t0)
        print(f"[{tag}] store of {resident / 1e9:.3f} GB built in "
              f"{out['store_s']:.1f} s ({len(names)} units: a layer "
              f"{sm.store.resident_nbytes(names[1]) / 1e6:.2f} MB, embed "
              f"{sm.store.resident_nbytes(names[0]) / 1e6:.2f} MB, head "
              f"{sm.store.resident_nbytes(names[-1]) / 1e6:.2f} MB); budget "
              f"{budget / 1e9:.3f} GB = {P9_BUDGET_OVER_FLOOR} x the "
              f"smallest feasible {floor / 1e9:.2f} GB at m = {P9_M} on a "
              f"{P14_GRID / 1e9:.2f} GB grid; resident / budget "
              f"{ratio:.3f} (the paper's 2.32-5.81); blocks="
              f"{sm.plan.n_blocks} m={sm.plan.m}; planned in "
              f"{out['plan_s']:.1f} s", flush=True)
        require(ratio > 5.81, f"{tag}: resident / budget {ratio:.3f}, not "
                f"above the paper's 5.81")
        del params

        t0 = time.perf_counter()
        sm.forward(batch)                                          # warm
        warm_s = time.perf_counter() - t0
        sm.engine.stats.__init__()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset()
        logits, st = sm.forward(batch)
        counts = collect()
        max_alloc = torch.cuda.max_memory_allocated()
        want_key = (HB_BATCH, HB_FRAMES, cfg.n_heads, cfg.n_kv_heads, hd,
                    hd, cfg.dtype, False, None, None, None,
                    fa.path(getattr(torch, cfg.dtype), hd))
        launched = dict(fa.launches.by_shape)
        require(counts["flash_attention"] == cfg.n_layers
                and launched == {want_key: cfg.n_layers}
                and fa.path(torch.bfloat16, hd) == "tc",
                f"{tag}: flash_attention launches {launched}, expected "
                f"{cfg.n_layers} at {want_key} on the tensor cores")
        require(counts["swap_linear"] == 6 * cfg.n_layers,
                f"{tag}: swap_linear launched {counts['swap_linear']} times, "
                f"expected {6 * cfg.n_layers}")
        require(counts["swap_linear_q"] == 0, f"{tag}: swap_linear_q "
                f"launched {counts['swap_linear_q']} times")
        require(bool(torch.isfinite(logits).all())
                and tuple(logits.shape) == (HB_BATCH, 1, cfg.vocab_size),
                f"{tag}: logits {tuple(logits.shape)}, finite "
                f"{bool(torch.isfinite(logits).all())}")
        require(sm.engine.stats.peak_resident <= budget,
                f"{tag}: peak ledger {sm.engine.stats.peak_resident} over "
                f"budget {budget}")
        t0 = time.perf_counter()
        units = [sm.store.read_unit(u.name).params for u in sm.units]
        want = sm.forward_unswapped(batch, resident=units)
        del units
        unswapped_s = time.perf_counter() - t0
        require(torch.equal(logits, want),
                f"{tag}: swapped logits != unswapped logits")
        print(f"[{tag}] swapped logits == unswapped logits bitwise "
              f"({HB_BATCH} x {HB_FRAMES} frames, {cfg.n_layers} layers at "
              f"published widths, the unswapped model holding all "
              f"{resident / 1e9:.2f} GB; {unswapped_s:.1f} s); "
              f"flash_attention x {cfg.n_layers} non-causal at "
              f"{want_key[:7]} (tensor cores); warm pass {warm_s:.1f} s; "
              f"launches {counts}", flush=True)
        out["prefill"] = report_prefill(tag, sm, st, budget, resident,
                                        max_alloc)
        out["prefill"]["warm_s"] = warm_s
        print(f"[phase14] wall s: init {init_s:.1f}, store "
              f"{out['store_s']:.1f}, warm pass {warm_s:.1f}, timed pass "
              f"{st['latency_s']:.1f}, unswapped {unswapped_s:.1f}",
              flush=True)
    finally:
        sm.close()
        shutil.rmtree(P14_WORKDIR, ignore_errors=True)
    torch.cuda.empty_cache()
    out["by_shape"] = since(main_launches, before)
    return out


# ---------------------------------------------------------------- conv nets
def p10_infos(layers, hw: int, batch: int):
    """The info rows of a conv net from its layer list alone (the rows of
    ``benchmarks/common.py::vision_infos``: a layer's fp32 bytes, its leaf
    count or 1, ``layer_flops_conv`` at its input size)."""
    from repro_torch.core.cost_model import LayerInfo
    from repro_torch.models.vision import layer_flops_conv, trace_hw
    rows = []
    for i, (l, h) in enumerate(zip(layers, trace_hw(layers, hw))):
        n = {"conv": l.k * l.k * l.cin * l.cout, "res": l.k * l.k * l.cin
             * l.cout, "fc": l.cin * l.cout}.get(l.kind, 0)
        rows.append(LayerInfo(f"{l.kind}{i:02d}", 4 * (n + l.cout) if n else 0,
                              2 if n else 1, layer_flops_conv(l, h, batch)))
    return rows


def p10_scheduler(kinds, planners: dict):
    """``MultiDNNScheduler`` over a fleet under P10_BUDGET_FRAC of its
    demand: model i is ``f"{kind}{i}"`` (its weights from seed i, as
    ``bench_scenarios.py`` builds them). Models of one kind share one
    ``PartitionPlanner`` from ``planners``: the same rows, so the same
    lookup tables, each built once for all fleets. Returns (scheduler,
    demand bytes)."""
    from repro_torch.core.cost_model import DelayModel
    from repro_torch.core.partition import PartitionPlanner
    from repro_torch.core.scheduler import MultiDNNScheduler, ScheduledModel
    from repro_torch.models import vision
    models = []
    for i, kind in enumerate(kinds):
        if kind not in planners:
            _, layers, hw = vision.MODELS[kind]()
            planners[kind] = PartitionPlanner(
                p10_infos(layers, hw, P10_BATCH), DelayModel())
        models.append(ScheduledModel(f"{kind}{i}", planners[kind]))
    total = sum(float(sum(m.planner.sizes)) for m in models)
    return MultiDNNScheduler(models, total * P10_BUDGET_FRAC), total


def p10_vgg(sched):
    """(seed, budget) of the self-driving fleet's vgg as planned."""
    (i, m), = [(i, m) for i, m in enumerate(sched.models)
               if m.name.startswith("vgg")]
    return i, m.budget


def p10_tprg_keep(sched) -> float:
    """TPrg's keep fraction at vgg's budget (``bench_scenarios.py``)."""
    i, budget = p10_vgg(sched)
    total = float(sum(sched.models[i].planner.sizes))
    return max(0.25, min(1.0, budget / (total * 2.2)))


def p10_kernel_shapes(sched) -> dict:
    """Every shape phase 10 launches a matmul or dequant kernel at, from
    the layer lists: ``fp``: (label, (M, K, N)) of B5 (vgg's and resnet's
    fc layers, TPrg's first fc, the fc stack); ``q``: (M, K, N) of B1 at
    int8 and int4 (vgg's fc layers, the fc stack); ``dequant``: (R, C) of
    B2 (vgg's quantized leaves, conv weights as k * k * cin rows)."""
    from repro_torch.models import vision
    from repro_torch.store.quantized_store import MIN_QUANT_SIZE
    _, vgg, _ = vision.vgg_sim()
    _, resnet, _ = vision.resnet_sim()
    n, dim, batch, _ = P10_STACK
    vfc = [(P10_BATCH, l.cin, l.cout) for l in vgg if l.kind == "fc"]
    rfc = [(P10_BATCH, l.cin, l.cout) for l in resnet if l.kind == "fc"]
    last = [l for l in vgg if l.kind == "conv"][-1].cout
    kept = max(1, int(round(last * p10_tprg_keep(sched))))
    stack = (batch, dim, dim)
    fp = ([("vgg_sim fc", s) for s in vfc]
          + [("resnet_sim fc", s) for s in rfc if s not in vfc]
          + [("vgg_sim TPrg fc", (P10_BATCH, kept, vfc[0][2]))]
          + [(f"fc stack {n} x {dim}", stack)])
    deq = []
    for l in vgg:
        rows = l.k * l.k * l.cin if l.kind in ("conv", "res") else l.cin
        if l.kind in ("conv", "res", "fc") and rows * l.cout >= MIN_QUANT_SIZE:
            deq.append((rows, l.cout))
    return {"fp": fp, "q": vfc + [stack], "dequant": deq}


def p10_resident(torch, params, dev):
    """Every unit on the device, each one flat buffer cut as a swap-in
    cuts it (``SwappedModel.resident_units``): the in-memory model."""
    from repro_torch.core.skeleton import assemble, flatten_params
    out = []
    for p in params:
        buf, skel = flatten_params(p)
        out.append(assemble(skel, torch.from_numpy(buf).to(dev)))
    return out


def p10_pass(sw, x, reset, collect):
    """A warm swapped pass, then the counted one with fresh stats.
    Returns (output, stats, launches)."""
    sw.forward(x)
    sw.engine.stats.__init__()
    reset()
    out, st = sw.forward(x)
    return out, st, collect()


P10_SPANS = ("read", "unpack", "dispatch", "exec", "wait")


def p10_row(tag, sw, st, budget) -> dict:
    """Print one swapped pass's row and return it (``budget`` None: the
    engine enforced none)."""
    es = sw.engine.stats
    row = {"tag": tag, "blocks": sw.plan.n_blocks, "m": sw.plan.m,
           "points": list(sw.plan.points), "budget": budget and int(budget),
           "peak": int(es.peak_resident),
           "latency_ms": st["latency_s"] * 1e3,
           "spans_ms": {k: es.stage_seconds(k) * 1e3 for k in P10_SPANS},
           "overlap": st["overlap_efficiency"],
           "swapped": st["bytes_swapped"],
           "by_precision": st["bytes_by_precision"]}
    print(f"[phase10 {tag}] {row['blocks']} blocks at m={row['m']} "
          f"{tuple(row['points'])}; latency {row['latency_ms']:.3f} ms ("
          + ", ".join(f"{k} {v:.3f}" for k, v in row["spans_ms"].items())
          + f" ms); overlap {row['overlap']:.3f}; peak ledger "
          f"{row['peak'] / 1e6:.3f} MB of "
          + (f"budget {budget / 1e6:.3f} MB; " if budget else "no budget; ")
          + f"swapped {row['swapped'] / 1e6:.3f} MB {row['by_precision']}",
          flush=True)
    return row


def run_conv(torch, sd_sched, planners, main_launches, device="cuda"):
    """Phase 10: the paper's conv workloads through ``SwappedSequential``.
    The three application scenarios under ``MultiDNNScheduler`` on mmap
    (self-driving before and after ``adapt``), vgg's store arms, DCha and
    TPrg, ``calibrate_sequential`` and a mixed store, then the fc stack.
    Stores live under ``build/phase10``. Returns launches per counted
    run and every launched shape (``by_shape``)."""
    import shutil

    import numpy as np
    from repro_torch.calibrate import calibrate_sequential
    from repro_torch.calibrate.profiler import _rel_l2
    from repro_torch.core.cost_model import (DelayModel, LayerInfo,
                                             packing_density)
    from repro_torch.core.runtime import SwappedSequential
    from repro_torch.core.swap_engine import MemoryLedger
    from repro_torch.models import vision
    from repro_torch.store.quantized_store import quantizable_leaf, roundtrip
    from repro_torch.tree import tree_leaves

    dev = torch.device(device)
    reset, collect = launch_counting(main_launches)
    before = {k: dict(v) for k, v in main_launches.items()}
    out = {"counts": {}, "rows": []}
    nets = {}
    dm = DelayModel()

    def net(kind, seed):
        """(layers, host params, in-memory params, x, in-memory output)
        of one sim: weights from a torch.Generator at ``seed`` on the host
        (the store's source), x from a numpy seed."""
        if (kind, seed) not in nets:
            _, layers, hw = vision.MODELS[kind]()
            g = torch.Generator()
            g.manual_seed(seed)
            params = vision.init_convnet(layers, g)
            got = [sum(a.numel() * 4 for a in tree_leaves(p)) for p in params]
            want = [r.size for r in p10_infos(layers, hw, P10_BATCH)]
            require(got == want, f"phase 10: {kind} unit bytes {got} != "
                    f"the planner's rows {want}")
            x = torch.from_numpy(np.random.default_rng(seed + 99)
                                 .standard_normal((P10_BATCH, hw, hw, 3))
                                 .astype(np.float32)).to(dev)
            resident = p10_resident(torch, params, dev)
            nets[(kind, seed)] = (layers, params, resident, x,
                                  vision.apply_convnet(layers, resident, x))
        return nets[(kind, seed)]

    def seq(layers, units, workdir, **kw):
        return SwappedSequential(
            units, lambda i, p, xx: vision.apply_layer(layers[i], p, xx),
            str(P10_WORKDIR / workdir), device=dev, **kw)

    def conv_seq(kind, seed, workdir, **kw):
        layers, params, _, _, _ = net(kind, seed)
        return seq(layers, [(f"{kind}{seed}_{i:02d}", p)
                            for i, p in enumerate(params)], workdir, **kw)

    def run_fleet(scen, sched, stage, ledger):
        """Every model of ``sched`` swapped on mmap at its allotted budget
        and plan, on one shared ledger: bitwise the in-memory forward,
        its ledger peak within its budget. The executors stay open in
        ``sws`` for a later stage."""
        demand = sum(float(sum(m.planner.sizes)) for m in sched.models)
        print(f"[phase10 {scen} {stage}] demand {demand / 1e6:.3f} MB over "
              f"the budget {sched.available / 1e6:.3f} MB: "
              f"{demand / sched.available:.3f}x", flush=True)
        for i, (kind, m) in enumerate(zip(P10_SCENARIOS[scen],
                                          sched.models)):
            key = f"{scen}/{m.name}"
            if key not in sws:
                sws[key] = conv_seq(kind, i, key, ledger=ledger)
            sw = sws[key]
            # the scheduler's plan, with its own m: a budget at a model's
            # floor (vgg's, yolo's) degrades it to m = 1
            sw.plan = m.plan
            _, _, _, x, ref = net(kind, i)
            y, st, counts = p10_pass(sw, x, reset, collect)
            out["counts"][f"{scen} {stage} {m.name}"] = counts
            require(torch.equal(y, ref), f"phase 10: {scen} {stage} "
                    f"{m.name} swapped != in-memory")
            require(sw.engine.stats.peak_resident <= m.budget,
                    f"phase 10: {scen} {stage} {m.name} peak "
                    f"{sw.engine.stats.peak_resident} > budget {m.budget}")
            out["rows"].append(p10_row(f"{scen} {stage} {m.name}", sw, st,
                                       m.budget))
        require(ledger.peak <= sched.available, f"phase 10: {scen} ledger "
                f"peak {ledger.peak} > {sched.available}")
        return demand / sched.available

    shutil.rmtree(P10_WORKDIR, ignore_errors=True)
    sws = {}
    try:
        # 1. self-driving, as planned, then adapted to a smaller budget
        seed, budget = p10_vgg(sd_sched)
        keep = p10_tprg_keep(sd_sched)
        ledger = MemoryLedger(int(sd_sched.available))
        ratio = run_fleet("self_driving", sd_sched, "planned", ledger)
        floors = sum(m.planner.min_feasible_budget()
                     for m in sd_sched.models)
        avail = max(sd_sched.available * P10_ADAPT, floors * 1.05)
        t_adapt = sd_sched.adapt(avail)
        ledger.budget = int(avail)
        print(f"[phase10 self_driving] adapt to {avail / 1e6:.3f} MB "
              f"(max of {P10_ADAPT} x available, 1.05 x the floors "
              f"{floors / 1e6:.3f} MB) in {t_adapt * 1e3:.1f} ms", flush=True)
        ratio_adapted = run_fleet("self_driving", sd_sched, "adapted",
                                  ledger)
        require(ratio_adapted > ratio > 1, f"phase 10: demand over budget "
                f"{ratio:.3f}, adapted {ratio_adapted:.3f}")
        # 2. the two other scenarios, each planned and run once
        for scen in ("rsu", "uav"):
            sched, _ = p10_scheduler(P10_SCENARIOS[scen], planners)
            run_fleet(scen, sched, "planned",
                      MemoryLedger(int(sched.available)))
        for sw in sws.values():
            sw.close()
        sws.clear()

        # 3. vgg's store arms at its self-driving budget
        layers, params, resident, x, ref = net("vgg", seed)
        _, _, hw = vision.vgg_sim()
        infos = p10_infos(layers, hw, P10_BATCH)
        floor = planners["vgg"].min_feasible_budget()
        n_quant = sum(quantizable_leaf(a) for p in params
                      for a in tree_leaves(p))
        rt = {bits: p10_resident(torch, [roundtrip(p, bits) for p in params],
                                 dev) for bits in (8, 4)}
        for arm, opts in (("rawio", dict(store_backend="rawio",
                                         gpu_dispatch=True)),
                          ("int8 eager", dict(store_backend="quant",
                                              precision="int8")),
                          ("int8 fused", dict(store_backend="quant",
                                              precision="int8", fused=True)),
                          ("int4 fused", dict(store_backend="quant",
                                              precision="int4", fused=True))):
            raw = arm == "rawio"
            # rawio holds three copies with the dispatch copy: plan a third
            # of the budget, lifted to the floor (bench_scenarios.py)
            sw = conv_seq("vgg", seed, f"vgg_{arm.replace(' ', '_')}",
                     budget=None if raw else int(budget), **opts)
            try:
                sw.partition_with(infos, max(budget / 3, floor) if raw
                                  else budget, dm)
                y, st, counts = p10_pass(sw, x, reset, collect)
                out["counts"][f"vgg {arm}"] = counts
                if raw:
                    require(torch.equal(y, ref), "phase 10: vgg rawio != "
                            "in-memory")
                else:
                    bits = 4 if arm.startswith("int4") else 8
                    want = vision.apply_convnet(layers, rt[bits], x)
                    err = rel_err(torch, y, want)
                    require(err[1] <= P10_RTTOL, f"phase 10: vgg {arm} vs "
                            f"the round-tripped forward {err[1]:.3g}")
                    print(f"[phase10 vgg {arm}] vs the round-tripped "
                          f"in-memory forward: max abs {err[0]:.3g}, rel "
                          f"{err[1]:.3g} <= {P10_RTTOL}; vs the fp forward "
                          f"rel {rel_err(torch, y, ref)[1]:.3g}", flush=True)
                out["rows"].append(p10_row(f"vgg {arm}", sw, st,
                                           None if raw else budget))
            finally:
                sw.close()
        out["vgg_quant_leaves"] = n_quant
        out["vgg_fc"] = sum(l.kind == "fc" for l in layers)

        # 4. DCha and TPrg in memory
        reset()
        dcha = vision.apply_convnet_channel_split(layers, resident, x,
                                                  P10_GROUPS)
        pl, pp = vision.prune_convnet(layers, resident, keep)
        tprg = vision.apply_convnet(pl, pp, x)
        out["counts"]["vgg DCha + TPrg"] = collect()
        err = rel_err(torch, dcha, ref)
        require(err[1] <= 1e-5, f"phase 10: DCha vs the full forward "
                f"{err[1]:.3g} > 1e-5")
        a = tprg.double().flatten()
        b = ref.double().flatten()
        cos = float(a @ b / (a.norm() * b.norm()).clamp_min(1e-30))
        print(f"[phase10 vgg DCha] {P10_GROUPS} channel groups: rel err "
              f"{err[1]:.3g} <= 1e-5; [TPrg] keep {keep:.4f} ("
              f"{pl[-3].cin} of {layers[-3].cin} channels into fc): cosine "
              f"fidelity {cos:.6f}", flush=True)

        # 5. calibrate_sequential twice on mmap, then the mixed store
        sw = conv_seq("vgg", seed, "vgg_calib", budget=int(budget))
        try:
            sw.partition_with(infos, budget, dm)
            reset()
            t0 = time.perf_counter()
            runs = [calibrate_sequential(sw, x, P10_FIDELITY)
                    for _ in range(2)]
            t_cal = time.perf_counter() - t0
            out["counts"]["vgg calibration"] = collect()
        finally:
            sw.close()
        prof, plan = runs[0]
        require(runs[1][1].to_json() == plan.to_json()
                and runs[1][0].to_json() == prof.to_json(),
                "phase 10: two calibrations gave two plans")
        sw = conv_seq("vgg", seed, "vgg_mixed", budget=int(budget),
                 store_backend="quant", precision="mixed", fused=True,
                 store_options={"plan": plan})
        try:
            sw.partition_with(infos, budget, dm)
            y, st, counts = p10_pass(sw, x, reset, collect)
            out["counts"]["vgg mixed"] = counts
            bm = plan.bits_map()
            want = vision.apply_convnet(layers, p10_resident(torch, [
                roundtrip(p, bm.get(n, 0)) for n, p in sw.named_units],
                dev), x)
            err = rel_err(torch, y, want)
            realized = _rel_l2(y, ref)
            require(err[1] <= P10_RTTOL, f"phase 10: mixed vs its round "
                    f"trip {err[1]:.3g}")
            require(realized <= plan.fidelity_target, f"phase 10: mixed "
                    f"realized rel-L2 {realized:.4g} > "
                    f"{plan.fidelity_target}")
            require(sum(st["bytes_by_precision"].values())
                    == st["bytes_swapped"], "phase 10: bytes by precision")
            print(f"[phase10 vgg calibration] 2 x calibrate_sequential "
                  f"(output, {1 + 2 * n_quant} passes each) in {t_cal:.1f} "
                  f"s: the same plan JSON; plan {plan.histogram()}, "
                  f"predicted rel-L2 {plan.predicted_err:.4g}, realized "
                  f"{realized:.4g} <= target {plan.fidelity_target:g}; vs "
                  f"its round trip rel {err[1]:.3g} <= {P10_RTTOL}",
                  flush=True)
            out["rows"].append(p10_row("vgg mixed", sw, st, budget))
            out["mixed"] = {"predicted": plan.predicted_err,
                            "realized": realized,
                            "histogram": plan.histogram()}
        finally:
            sw.close()

        # 6. the fc stack on mmap and int8 / int4 fused
        n, dim, batch, sseed = P10_STACK
        layers = [vision.Layer("fc", dim, dim) for _ in range(n)]
        g = torch.Generator()
        g.manual_seed(sseed)
        params = vision.init_convnet(layers, g)
        units = [(f"fc{i:02d}", p) for i, p in enumerate(params)]
        infos = [LayerInfo(f"mlp{i:02d}", sum(a.numel() * 4
                                              for a in tree_leaves(p)),
                           len(tree_leaves(p)), 2.0 * batch * dim * dim)
                 for i, p in enumerate(params)]
        x = torch.from_numpy(np.random.default_rng(sseed + 99)
                             .standard_normal((batch, dim))
                             .astype(np.float32)).to(dev)
        resident = p10_resident(torch, params, dev)
        full = vision.apply_convnet(layers, resident, x)
        rt = {bits: vision.apply_convnet(layers, p10_resident(
            torch, [roundtrip(p, bits) for p in params], dev), x)
              for bits in (8, 4)}
        for arm, opts in (("mmap", {}),
                          ("int8 fused", dict(store_backend="quant",
                                              precision="int8", fused=True)),
                          ("int4 fused", dict(store_backend="quant",
                                              precision="int4", fused=True))):
            sw = seq(layers, units, f"stack_{arm.replace(' ', '_')}", **opts)
            try:
                resident_bytes = sum(sw.store.resident_nbytes(u)
                                     for u, _ in units)
                budget = int(resident_bytes * P10_STACK_BUDGET)
                sw.engine.ledger.budget = budget
                cdm = DelayModel().calibrated(sw.store)
                sw.partition_with(infos, budget, cdm)
                y, st, counts = p10_pass(sw, x, reset, collect)
                out["counts"][f"stack {arm}"] = counts
                if arm == "mmap":
                    require(torch.equal(y, full), "phase 10: fc stack mmap "
                            "!= in-memory")
                else:
                    err = rel_err(torch, y, rt[4 if "int4" in arm else 8])
                    require(err[1] <= P10_RTTOL, f"phase 10: fc stack {arm} "
                            f"vs the round-tripped forward {err[1]:.3g}")
                    print(f"[phase10 fc stack {arm}] vs the round-tripped "
                          f"in-memory forward: max abs {err[0]:.3g}, rel "
                          f"{err[1]:.3g} <= {P10_RTTOL}; vs the fp forward "
                          f"rel {rel_err(torch, y, full)[1]:.3g}", flush=True)
                print(f"[phase10 fc stack {arm}] {n} x {dim} at batch "
                      f"{batch}: resident {resident_bytes / 1e6:.3f} MB over "
                      f"the budget {budget / 1e6:.3f} MB "
                      f"({resident_bytes / budget:.3f}x); calibrated alpha "
                      f"{cdm.alpha:.4g} s/B; packing density "
                      f"{packing_density(sw.plan):.3f} layers a block",
                      flush=True)
                row = p10_row(f"fc stack {arm}", sw, st, budget)
                row["packing_density"] = packing_density(sw.plan)
                out["rows"].append(row)
            finally:
                sw.close()
        out["stack_layers"] = n
    finally:
        for sw in sws.values():
            sw.close()
        shutil.rmtree(P10_WORKDIR, ignore_errors=True)
    out["by_shape"] = since(main_launches, before)
    return out


def p10_check_launches(p10) -> None:
    """Phase 10's kernels ran where its paths put them: fused int8 streams
    vgg's fc weights through B1 once each a pass and widens nothing on the
    card; eager int8 widens every quantized leaf with B2 and runs its fc
    through B5; the fc stack's fused arms run B1 once a layer; mmap passes
    run B5 and no other matmul."""
    c = p10["counts"]
    nfc, nq, nst = p10["vgg_fc"], p10["vgg_quant_leaves"], p10["stack_layers"]
    for key, want in (("vgg int8 fused", {"swap_linear_q": nfc,
                                          "dequant_int8": 0,
                                          "swap_linear": 0}),
                      ("vgg int4 fused", {"swap_linear_q": nfc,
                                          "dequant_int8": 0,
                                          "swap_linear": 0}),
                      ("vgg int8 eager", {"swap_linear_q": 0,
                                          "dequant_int8": nq,
                                          "swap_linear": nfc}),
                      ("vgg rawio", {"swap_linear": nfc}),
                      ("stack mmap", {"swap_linear": nst,
                                      "swap_linear_q": 0}),
                      ("stack int8 fused", {"swap_linear_q": nst,
                                            "swap_linear": 0}),
                      ("stack int4 fused", {"swap_linear_q": nst,
                                            "swap_linear": 0})):
        got = {k: c[key][k] for k in want}
        require(got == want, f"phase 10: {key} launched {got}, not {want}")
    for name in ("swap_linear", "swap_linear_q", "dequant_int8"):
        require(p10["by_shape"].get(name), f"phase 10: {name} never "
                "launched")
    for name in ("paged_attention", "flash_attention", "wkv6"):
        require(not p10["by_shape"].get(name), f"phase 10: {name} launched")


def _leaves(tree):
    from repro_torch.tree import tree_leaves
    return tree_leaves(tree)


def rounded_linear(x, w, b=None, *, act="none"):
    """``swap_linear``'s function with the product accumulated in float64
    and rounded once to fp32, then the bias and activation in fp32:
    the fp32 linear free of any summation order, the reference linear of
    the fp32 gradient identities (``plain_kernels``). cuBLAS's fp32 order
    is no reference for a kernel that sums otherwise: on zamba2-7b's 12
    layers the identity moves 1.37e-4 of a leaf's largest |g| between two
    fp32 orders of the same products, past its 1e-4, even for a GEMM
    exact to float64 (an NVIDIA H100, ``tools/torch_identity_probe.py``)."""
    from repro_torch.kernels.swap_linear_q import activation
    r = x.double() @ w.double()
    if b is not None:
        r = r + b.double()
    return activation(r.float(), act).to(x.dtype)


class plain_kernels:
    """Within the block the models' linears, prefill attention and rwkv6
    recurrence run the plain versions of ``flash_attention`` and ``wkv6``
    and :func:`rounded_linear` on the card (autograd differentiates them
    as it does any torch op): the reference for the gradient through the
    kernels in phases 15-17. ``models/ssm.py`` imports ``wkv6`` by name,
    so the name is swapped there."""

    def __enter__(self):
        from repro_torch.kernels import flash_attention as fa
        from repro_torch.kernels import wkv6 as kw
        from repro_torch.models import attention, layers, ssm
        self.saved = layers.swap_linear, attention.flash_attention, ssm.wkv6
        layers.swap_linear = rounded_linear
        attention.flash_attention = fa.flash_attention_plain
        ssm.wkv6 = kw.wkv6_plain

    def __exit__(self, *exc):
        from repro_torch.models import attention, layers, ssm
        layers.swap_linear, attention.flash_attention, ssm.wkv6 = self.saved


def loss_and_grads(torch, model, params, batch):
    """(loss, every param leaf's gradient, zeros where the loss reads none)
    of ``Model.loss`` on the card."""
    leaves = _leaves(params)
    for p in leaves:
        p.grad = None
    loss, _ = model.loss(params, batch)
    loss.backward()
    torch.cuda.synchronize()
    return float(loss.detach()), [torch.zeros_like(p) if p.grad is None
                                  else p.grad for p in leaves]


def train_launches(cfg) -> dict:
    """The kernel launches one training step of ``cfg`` implies, by name.
    Each layer is checkpointed, so it runs its forward twice (the step's,
    and backward's recompute), and ``SwapLinearFn`` launches a gated MLP's
    gate once more at act "none" for its activation's derivative. The
    linears through B5: an attention layer's wq, wk, wv, wo (MLA's wq, wo)
    and its MLP's wi0, wi1, wo (a GELU MLP's wi, wo; a moe layer's shared
    expert's); a Mamba2 or rwkv6 layer's wo. B4 once an attention layer,
    B6 once an rwkv6 layer. The head, the routed experts and the other
    projections are plain matmuls, as in the reference (the CPU tests count
    the same on the reduced configs)."""
    from repro_torch.models.transformer import build_plan
    n = dict.fromkeys(KERNEL_NAMES, 0)
    gated = cfg.act in ("swiglu", "gelu_glu")
    for seg in build_plan(cfg):
        if seg.kind in ("mamba2", "rwkv6"):
            fwd, recompute = 1, 0
            n["wkv6"] += 2 * seg.n * (seg.kind == "rwkv6")
        else:
            if seg.kind == "moe":
                mlp = 3 if cfg.moe.n_shared else 0
            else:
                mlp = 3 if gated else 2
            fwd = (2 if cfg.mla is not None else 4) + mlp
            recompute = int(gated and mlp == 3)
            n["flash_attention"] += 2 * seg.n
        n["swap_linear"] += (2 * fwd + recompute) * seg.n
    return n


def describe(cfg, depth: int, id_depth: int) -> str:
    """A model line: the published widths and the depth cuts."""
    from repro_torch.models.ssm import rwkv6_dims
    if cfg.ssm is not None and cfg.ssm.kind == "rwkv6":
        kind = "{} WKV heads of {}".format(*rwkv6_dims(cfg))
    else:
        kind = (f"{cfg.n_heads} heads / {cfg.n_kv_heads} KV heads, head_dim "
                f"{cfg.resolved_head_dim}")
    return (f"model: {cfg.name} d_model {cfg.d_model}, {kind}, d_ff "
            f"{cfg.d_ff}, vocab {cfg.vocab_size}, tied {cfg.tie_embeddings},"
            f" {cfg.dtype}; reduced: n_layers {cfg.n_layers}->{depth} "
            f"({cfg.n_layers}->{id_depth} for the fp32 identity); batch "
            f"{TRAIN_BATCH} x seq {TRAIN_SEQ}")


def train_identity(torch, cfg, tag: str, batch_size: int = TRAIN_BATCH,
                   seq: int = TRAIN_SEQ) -> None:
    """The fp32 loss and every gradient leaf of ``Model.loss`` on one
    ``SyntheticLM`` batch of ``batch_size`` x ``seq`` through the kernels
    (their ``autograd.Function``s, each launching as often as
    ``train_launches`` says) == through the plain versions, the linears
    rounded once from float64 (``plain_kernels``, which launch nothing):
    the loss within 1e-5
    relative, each leaf within ``TRAIN_GRAD_TOL`` of its largest |g|. Runs
    before the counted run."""
    import math
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models.transformer import Model
    t0 = time.perf_counter()
    cfg = dataclasses.replace(cfg, dtype="float32")
    model = Model(cfg)
    params = model.init(0, device="cuda")
    for p in _leaves(params):
        p.requires_grad_(True)
    batch = {k: v.cuda() for k, v in SyntheticLM(
        cfg, seq, batch_size).sample(0).items()}
    counters = kernel_counters()
    n0 = {k: c.count for k, c in counters.items()}
    with launch_delta() as fp32_launches:
        loss, grads = loss_and_grads(torch, model, params, batch)
    n1 = {k: c.count for k, c in counters.items()}
    launched = {k: n1[k] - n0[k] for k in n0}
    require(launched == train_launches(cfg), f"{tag} (a): launches "
            f"{launched} != {train_launches(cfg)}")
    with plain_kernels():
        loss0, grads0 = loss_and_grads(torch, model, params, batch)
    require({k: c.count for k, c in counters.items()} == n1,
            f"{tag} (a): the plain run launched a kernel")
    rel = abs(loss - loss0) / abs(loss0)
    require(math.isfinite(loss) and rel <= 1e-5,
            f"{tag} (a): loss {loss} vs plain {loss0} (rel {rel:.3g})")
    worst = 0.0
    for g, g0 in zip(grads, grads0):
        err = float((g - g0).abs().max())
        scale = float(g0.abs().max())
        require(err <= TRAIN_GRAD_TOL * scale,
                f"{tag} (a): a gradient leaf {tuple(g.shape)} off by "
                f"{err:.3g} of {scale:.3g}")
        worst = max(worst, err / max(scale, 1e-30))
    from repro_torch.kernels import flash_attention as fa
    pair = ((cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim,
             cfg.mla.v_head_dim) if cfg.mla is not None
            else (cfg.resolved_head_dim, cfg.resolved_head_dim))
    tf32_attn = (train_launches(cfg)["flash_attention"] > 0
                 and fa.path(torch.float32, *pair) == "tf32x3")
    routes = fp32_routes(fp32_launches.by_shape, f"{tag} (a)",
                         ("swap_linear",)
                         + (("flash_attention",) if tf32_attn else ()))
    window = cfg.sliding_window if cfg.layer_pattern == "swa" else None
    cut = (f", the window {window} cutting the first keys of the last "
           f"{seq - window} queries a layer"
           if window is not None and seq > window else "")
    print(f"[{tag} fp32] {cfg.n_layers} layers, "
          f"{sum(p.numel() for p in _leaves(params)) / 1e6:.1f} M params, "
          f"{batch_size} x {seq} tokens{cut}: "
          f"loss {loss:.6f} through the kernels vs {loss0:.6f} through the "
          f"plain versions, linears rounded from float64 (rel {rel:.3g} <= "
          f"1e-5); {len(grads)} gradient "
          f"leaves, worst {worst:.3g} of the leaf's largest |g| <= "
          f"{TRAIN_GRAD_TOL}; launches {launched}; "
          f"{time.perf_counter() - t0:.1f} s; {routes}", flush=True)
    del model, params, grads, grads0, batch
    torch.cuda.empty_cache()


def train_counted(torch, card, cfg, steps, main_launches, tag, ckpt=None):
    """``steps`` steps of ``launch/train.py``'s loop on ``cfg`` at 8 x 256
    with the launcher's schedule, counted: every loss finite, the launches
    ``train_launches`` implies per step and no other; prints the step ms
    (median of steps 1 on, each logged step ending in a wait for the card,
    so the host's launches of the next step do not overlap its work),
    tok/s and peak device memory. Returns (the loop's result, launches by
    kernel and shape, the losses)."""
    import math
    from repro_torch.launch.train import train
    reset, collect = launch_counting(main_launches)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset()
    t0 = time.perf_counter()
    out = train(cfg, steps=steps, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                log_every=1, ckpt=ckpt, device="cuda")
    wall = time.perf_counter() - t0
    counts = collect()
    by_shape = {name: dict(c.by_shape)
                for name, c in kernel_counters().items() if c.by_shape}
    peak = torch.cuda.max_memory_allocated()
    losses = [loss for _, loss, _ in out["logged"]]
    require(len(losses) == steps and all(math.isfinite(x) for x in losses),
            f"{tag}: losses {losses}")
    per_step = train_launches(cfg)
    want = {name: n * steps for name, n in per_step.items()}
    require(counts == want, f"{tag}: launches {counts} != {want}")
    stamps = [dt for _, _, dt in out["logged"]]
    steps_s = [b - a for a, b in zip(stamps, stamps[1:])]
    step_s = sorted(steps_s)[len(steps_s) // 2]
    n = sum(p.numel() for p in _leaves(out["state"]["params"]))
    print(f"[{tag} bf16] losses {[round(x, 4) for x in losses]}", flush=True)
    print(f"[{tag}] launches {counts} == per step "
          f"{ {k: v for k, v in per_step.items() if v} } x {steps} steps",
          flush=True)
    print(f"[{tag}] {card}: {cfg.n_layers} layers, {n / 1e6:.1f} M params; "
          f"step {step_s * 1e3:.1f} ms (median of steps 1-{steps - 1}, "
          f"synced every step; step 0 {stamps[0] * 1e3:.1f} ms), "
          f"{TRAIN_BATCH * TRAIN_SEQ / step_s:,.0f} tok/s; "
          f"max_memory_allocated {peak / 1e9:.3f} GB; the loop "
          f"{wall:.1f} s", flush=True)
    return out, by_shape, losses


def run_train(torch, card, main_launches):
    """Phase 15: qwen2.5-3b trained at its published widths: (a) the fp32
    gradient through the kernels == through the plain versions at depth 2;
    (b) 20 bf16 steps of ``launch/train.py``'s loop at depth 4, a finite
    and falling loss; (c) the launches a step implies; (d) the checkpoint
    restored onto the card bitwise; (e) step ms, tok/s, peak memory."""
    import shutil
    from repro_torch.configs import get_arch
    from repro_torch.training import checkpoint
    from repro_torch.tree import tree_map

    cfg = dataclasses.replace(get_arch("qwen2.5-3b"), n_layers=N_LAYERS)
    print(describe(get_arch("qwen2.5-3b"), N_LAYERS, TRAIN_ID_LAYERS)
          + f"; qkv bias {cfg.attn_bias}", flush=True)
    train_identity(torch, dataclasses.replace(cfg, n_layers=TRAIN_ID_LAYERS),
                   "phase15")

    P15_WORKDIR.mkdir(parents=True, exist_ok=True)
    ckpt = P15_WORKDIR / "ckpt"
    out, by_shape, losses = train_counted(torch, card, cfg, TRAIN_STEPS,
                                          main_launches, "phase15",
                                          ckpt=str(ckpt))
    require(losses[-1] < losses[0], f"phase 15 (b): the loss did not fall: "
            f"{losses[0]} -> {losses[-1]}")

    # (d) the checkpoint, restored onto the card into a zeroed tree
    params = out["state"]["params"]
    like = tree_map(torch.zeros_like, params)
    back = checkpoint.restore(str(ckpt), like)
    pairs = list(zip(_leaves(back), _leaves(params)))
    require(all(a.device == b.device and torch.equal(a, b.detach())
                for a, b in pairs),
            "phase 15 (d): the restored checkpoint differs")
    nbytes = sum(p.numel() * p.element_size() for p in _leaves(params))
    print(f"[phase15] checkpoint of {len(pairs)} tensors, {nbytes / 1e9:.3f} "
          f"GB: restored onto the card bitwise", flush=True)
    del like, back, pairs, out, params
    shutil.rmtree(P15_WORKDIR, ignore_errors=True)
    torch.cuda.empty_cache()
    return by_shape


def run_train_rwkv6(torch, card, main_launches):
    """Phase 16: rwkv6-3b trained at its published widths: (a) the fp32
    gradient through ``wkv6`` (``WKV6Fn``) and ``swap_linear`` == through
    the plain versions at depth 2; (b) 20 bf16 steps of the loop at phase
    5's depth of 4, a finite and falling loss; (c) 2 ``wkv6`` and 2
    ``swap_linear`` launches per step and layer; (d) step ms, tok/s,
    peak memory."""
    from repro_torch.configs import get_arch
    from repro_torch.models.ssm import rwkv6_dims
    base = get_arch("rwkv6-3b")
    print(describe(base, RWKV_LAYERS, TRAIN_ID_LAYERS), flush=True)
    cfg = dataclasses.replace(base, n_layers=RWKV_LAYERS)
    train_identity(torch, dataclasses.replace(cfg, n_layers=TRAIN_ID_LAYERS),
                   "phase16")
    out, by_shape, losses = train_counted(torch, card, cfg, TRAIN_STEPS,
                                          main_launches, "phase16")
    require(losses[-1] < losses[0], f"phase 16 (b): the loss did not fall: "
            f"{losses[0]} -> {losses[-1]}")
    nh, hd = rwkv6_dims(cfg)
    rows = (TRAIN_BATCH * nh, TRAIN_SEQ, hd, "float32", False)
    require(set(by_shape.get("wkv6", {})) == {rows},
            f"phase 16: wkv6 launched at {by_shape.get('wkv6')}, not {rows}")
    del out
    torch.cuda.empty_cache()
    return by_shape


def run_train_families(torch, card, main_launches):
    """Phase 17: each family of ``TRAIN_FAMILIES`` at its published widths
    and the depth there: the fp32 identity at that depth (phase 15 (a);
    at ``TRAIN_ID_SHAPE``'s batch where one is given: h2o-danube's window
    cutting keys), then 3 bf16 steps of the loop, all finite, with the
    launches each step implies, step ms, tok/s and peak memory."""
    from repro_torch.configs import get_arch
    by_shape = {}
    for arch, depth in TRAIN_FAMILIES:
        base = get_arch(arch)
        print(describe(base, depth, depth), flush=True)
        cfg = dataclasses.replace(base, n_layers=depth)
        tag = f"phase17 {arch}"
        train_identity(torch, cfg, tag, *TRAIN_ID_SHAPE.get(
            arch, (TRAIN_BATCH, TRAIN_SEQ)))
        out, shapes, _ = train_counted(torch, card, cfg, TRAIN_FAMILY_STEPS,
                                       main_launches, tag)
        for name, keys in shapes.items():
            for key, k in keys.items():
                by_shape.setdefault(name, {})[key] = (
                    by_shape.get(name, {}).get(key, 0) + k)
        del out
        torch.cuda.empty_cache()
    return by_shape


def held_key(name: str, key: tuple) -> tuple:
    """A launch key as phase 2's rows key it: a paged_attention row
    stands for its shape at any page-table width."""
    return key[:5] + key[6:] if name == "paged_attention" else key


def check_held(rows, by_shape, what: str) -> None:
    """Every shape ``what`` launched a kernel at is a phase 2 row: held
    against the plain version there, and timed."""
    held = {(r["name"], r["key"]) for r in rows}
    missing = sorted({(name, held_key(name, k))
                      for name, keys in by_shape.items() for k in keys
                      if (name, held_key(name, k)) not in held}, key=str)
    require(not missing, f"{what} launched kernels at shapes phase 2 did "
            f"not hold against their plain versions: {missing}")


# phase 18: the dry run's rows (arch, shape, multi_pod, depth cut or None
# for the CLI's --min-depth, perf variant or None): each variant at min
# depth on its row
DRYRUN_ROWS = [("qwen2.5-3b", "decode_32k", False, None, None),
               ("qwen2.5-3b", "train_4k", False, 2, None),
               ("qwen2.5-3b", "train_4k", True, 2, None),
               ("qwen2.5-3b", "decode_32k", False, 1, "flash_decode"),
               ("h2o-danube-3-4b", "decode_32k", False, 1, "windowed_kv"),
               ("qwen2.5-3b", "train_4k", False, 1, "seq_parallel")]


def dryrun_argument_bytes(cfg, shape, multi_pod: bool) -> int:
    """What a dry-run row's ``argument_size_in_bytes`` must be: every leaf
    of the train state (fp32 params and moments by ``train_state_specs``;
    the step is a host int) or of the serving params (``cfg.dtype``) and
    decode cache, and of the batch (``input_pspecs``), at its bytes over
    the extents of the mesh axes its spec names."""
    import math
    from repro_torch.core.skeleton import torch_dtype
    from repro_torch.distributed.sharding import filter_spec, is_spec
    from repro_torch.models.transformer import (Model, input_pspecs,
                                                input_specs)
    from repro_torch.training.train_loop import train_state_specs
    from repro_torch.tree import tree_leaves
    sizes = ({"pod": 2, "data": 16, "model": 16} if multi_pod
             else {"data": 16, "model": 16})

    def nbytes(shp, itemsize, spec):
        ext = 1
        for e in filter_spec(spec, sizes):
            for ax in ((e,) if isinstance(e, str) else e or ()):
                ext *= sizes[ax]
        return math.prod(shp) * itemsize // ext

    model = Model(cfg)
    total = 0
    if shape.mode == "train":
        specs = train_state_specs(model)
        leaves = tree_leaves(model.param_struct())
        for part in ("params", "mu", "nu"):
            total += sum(nbytes(t.shape, 4, sp) for t, sp in zip(
                leaves, tree_leaves(specs[part], is_leaf=is_spec)))
    else:
        isz = torch_dtype(cfg.dtype).itemsize
        total += sum(nbytes(t.shape, isz, sp) for t, sp in zip(
            tree_leaves(model.param_struct()),
            tree_leaves(model.param_specs(), is_leaf=is_spec)))
        if shape.mode == "decode":
            cache = model.cache_struct(shape.global_batch, shape.seq_len)
            cspecs = model.cache_specs(shape, sizes)
            for seg, sseg in zip(cache, cspecs):
                total += sum(nbytes(shp, dt.itemsize, sseg[k])
                             for k, (shp, dt) in seg.items())
    ispecs = input_pspecs(cfg, shape, sizes)
    total += sum(nbytes(shp, dt.itemsize, ispecs[k])
                 for k, (shp, dt) in input_specs(cfg, shape).items())
    return total


def run_dryrun(torch) -> list:
    """Phase 18: ``launch/dryrun`` on the card's host. qwen2.5-3b x
    decode_32k through the CLI (``--all --min-depth``: 1 layer) in a
    subprocess, meanwhile
    train_4k cut to 2 layers in this process on 16 x 16 and 2 x 16 x 16,
    and each perf variant at min depth on its row: ``--flash-decode`` on
    qwen's decode_32k, ``--windowed-kv`` on h2o-danube's (its cache 8x
    under the full one's: 32,768 / 4,096) and ``--seq-parallel`` on qwen's
    train_4k. Each a step traced on DTensors of fake tensors over a fake
    256- or 512-rank group (the plain PyTorch versions on the CPU: no
    kernel launches, checked). Every row must be ``ok``, its argument
    bytes what the specs give (:func:`dryrun_argument_bytes`), and the
    model's switches back at their defaults after it."""
    from repro_torch.configs import get_arch, get_shape
    from repro_torch.launch import dryrun
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import transformer as tmod
    reset, collect = launch_counting({name: {} for name in KERNEL_NAMES})
    out_dir = ROOT / "build" / "phase18"
    reset()
    cli = [r for r in DRYRUN_ROWS if r[3] is None]
    walls, rows = {}, {}
    procs = []
    try:
        for arch, shape_name, multi_pod, _, _ in cli:  # as a user runs it
            env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
            procs.append((time.perf_counter(), subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
                 "--min-depth", "--arch", arch, "--shape", shape_name,
                 "--out", str(out_dir)]
                + (["--multi-pod"] if multi_pod else []),
                env=env, cwd=ROOT, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)))
        for row in DRYRUN_ROWS:
            arch, shape_name, multi_pod, depth, variant = row
            if depth is not None:
                t0 = time.perf_counter()
                rows[row] = dryrun.run_one(
                    arch, shape_name, multi_pod, n_layers=depth,
                    verbose=False, **({variant: True} if variant else {}))
                walls[row] = time.perf_counter() - t0
                require((attn_mod.SHARDED_DECODE_AXIS,
                         tmod.WINDOWED_KV_CACHE, tmod.SEQ_PARALLEL_RESIDUAL)
                        == (None, False, False),
                        f"dryrun {row}: a switch was left set")
        for row, (t0, proc) in zip(cli, procs):
            arch, shape_name, multi_pod, _, _ = row
            log, _ = proc.communicate(timeout=300)
            walls[row] = time.perf_counter() - t0
            require(proc.returncode == 0, f"dryrun CLI {arch} x {shape_name} "
                    f"exited {proc.returncode}: {log[-3000:]}")
            tag = "2x16x16" if multi_pod else "16x16"
            rows[row] = json.loads(
                (out_dir / f"{arch}__{shape_name}__{tag}.json").read_text())
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for row in DRYRUN_ROWS:
        arch, shape_name, multi_pod, depth, variant = row
        r = rows[row]
        require(r["status"] == "ok", f"dryrun {arch} x {shape_name} x "
                f"{r['mesh']} {variant or ''}: {r.get('error')}")
        cfg = get_arch(arch)
        cfg = dataclasses.replace(cfg, n_layers=depth or dryrun.min_depth(cfg))
        shape = get_shape(shape_name)
        tmod.WINDOWED_KV_CACHE = variant == "windowed_kv"
        try:
            want = dryrun_argument_bytes(cfg, shape, multi_pod)
        finally:
            tmod.WINDOWED_KV_CACHE = False
        mem = r["memory_analysis"]
        require(mem["argument_size_in_bytes"] == want,
                f"dryrun {arch} x {shape_name} x {r['mesh']}: argument "
                f"bytes {mem['argument_size_in_bytes']} != {want} from the "
                f"specs")
        extra = ""
        if variant == "windowed_kv":
            # the full cache's bytes: the windowed row's plus what the
            # specs' arguments lose with the window
            full = r["cache_size_in_bytes"] + (
                dryrun_argument_bytes(cfg, shape, multi_pod) - want)
            require(full == 8 * r["cache_size_in_bytes"],
                    f"--windowed-kv: cache {r['cache_size_in_bytes']} B "
                    f"against the full cache's {full} B, not 1 / 8")
            extra = f" (the full cache {full} B: 8x)"
        print(f"[phase18] {arch} x {shape_name} x {r['mesh']} "
              f"({r['n_layers']} layers{', CLI' if depth is None else ''}"
              f"{', --' + variant.replace('_', '-') if variant else ''}): "
              f"ok, torch {r['torch']}, trace {r['trace_s']} s (wall "
              f"{walls[row]:.1f} s); per device: argument "
              f"{mem['argument_size_in_bytes']} B (== specs; cache "
              f"{r['cache_size_in_bytes']} B{extra}), output "
              f"{mem['output_size_in_bytes']} B, temp "
              f"{mem['temp_size_in_bytes']} B; flops counted "
              f"{r['cost_analysis']['flops']:.6e} vs analytic "
              f"{r['flops_analytic_per_dev']:.6e}; collectives "
              + ", ".join(f"{k} {v['count']} x / {v['bytes']} B"
                          for k, v in r["collectives"].items())
              + "; largest all-gather "
              f"{r['collective_max_bytes']['all-gather']} B", flush=True)
    got = collect()
    require(not any(got.values()), f"the dry run launched kernels: {got}")
    return [rows[r] for r in DRYRUN_ROWS]


# phase 19: the mesh path on one card over a one-rank NCCL group: a train
# step of (arch, depth) on the (1, 1) mesh, then MESH_STEPS bf16 steps;
# the ring-buffer decode of (arch, depth, prompt, decode steps) past its
# window; one flash-decode step of the same model
MESH_TRAIN = ("deepseek-v2-lite-16b", 2)
MESH_STEPS = 3
RING = ("h2o-danube-3-4b", 2, DN_PAGED_PROMPTS[0], 200)
RING_TOL = 1e-4                        # of each step's largest |logit|


def nccl_mesh(torch):
    """A one-rank NCCL group on loopback (a free port) and the (1, 1)
    ("data", "model") CUDA mesh over it. A failed init raises."""
    import socket
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_smoke_mesh
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    return make_smoke_mesh("cuda")


def mesh_train(torch, card, mesh, main_launches):
    """Phase 19 (a): ``MESH_TRAIN`` at published widths, its params and
    batch placed by ``train_state_specs`` / ``input_pspecs``: the fp32
    loss and every gradient leaf of the mesh step == the unsharded step's
    (phase 17's tolerances), with B5 and B4 launched as
    ``train_launches`` says (each call on local tensors through
    ``local_map``; the MoE's expert-parallel dispatch over NCCL); then
    ``MESH_STEPS`` bf16 steps of the port's train step on the mesh, all
    finite, counted. Returns the launches by kernel and shape."""
    import math
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.distributed.sharding import (distribute, full_tensor,
                                                  set_mesh)
    from repro_torch.launch.train import default_opt
    from repro_torch.models.transformer import Model, input_pspecs
    from repro_torch.training.train_loop import (TrainState, make_train_step,
                                                 train_state_specs)
    arch, depth = MESH_TRAIN
    base = dataclasses.replace(get_arch(arch), n_layers=depth)
    print(describe(get_arch(arch), depth, depth) + "; mesh (1, 1) "
          "(\"data\", \"model\") over NCCL", flush=True)
    shape = ShapeConfig("train", seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                        mode="train")
    t0 = time.perf_counter()
    cfg = dataclasses.replace(base, dtype="float32")
    model = Model(cfg)
    specs = train_state_specs(model)["params"]
    params = model.init(0, device="cuda")
    for p in _leaves(params):
        p.requires_grad_(True)
    batch = {k: v.cuda() for k, v in SyntheticLM(
        cfg, TRAIN_SEQ, TRAIN_BATCH).sample(0).items()}
    loss0, grads0 = loss_and_grads(torch, model, params, batch)
    dparams = distribute(params, specs, mesh)
    del params
    counters = kernel_counters()
    n0 = {k: c.count for k, c in counters.items()}
    set_mesh(mesh)
    try:
        with implicit_replication():
            # the loss alone: the metrics' graph would keep every leaf
            # (its AccumulateGrad nodes) and its gradient past ``del``
            loss = model.loss(dparams, distribute(
                batch, input_pspecs(cfg, shape, mesh), mesh))[0]
            loss.backward()
    finally:
        set_mesh(None)
    torch.cuda.synchronize()
    launched = {k: c.count - n0[k] for k, c in counters.items()}
    require(launched == train_launches(cfg), f"phase 19 (a): launches "
            f"{launched} != {train_launches(cfg)}")
    loss = float(full_tensor(loss.detach()))
    rel = abs(loss - loss0) / abs(loss0)
    require(math.isfinite(loss) and rel <= 1e-5,
            f"phase 19 (a): mesh loss {loss} vs {loss0} (rel {rel:.3g})")
    worst = 0.0
    for p, g0 in zip(_leaves(dparams), grads0):
        g = torch.zeros_like(g0) if p.grad is None else full_tensor(p.grad)
        err = float((g - g0).abs().max())
        scale = float(g0.abs().max())
        require(err <= TRAIN_GRAD_TOL * scale, f"phase 19 (a): a gradient "
                f"leaf {tuple(g0.shape)} off by {err:.3g} of {scale:.3g}")
        worst = max(worst, err / max(scale, 1e-30))
    print(f"[phase19 fp32] {cfg.name} {depth} layers: mesh loss {loss:.6f} "
          f"vs unsharded {loss0:.6f} (rel {rel:.3g} <= 1e-5); "
          f"{len(grads0)} gradient leaves, worst {worst:.3g} of the leaf's "
          f"largest |g| <= {TRAIN_GRAD_TOL}; launches {launched}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    del dparams, grads0, batch
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    model = Model(base)
    state = TrainState(distribute(model.init(0, device="cuda"), specs, mesh))
    step = make_train_step(model, default_opt(MESH_STEPS, 3e-4))
    ds = SyntheticLM(base, TRAIN_SEQ, TRAIN_BATCH)
    reset, collect = launch_counting(main_launches)
    torch.cuda.reset_peak_memory_stats()
    losses, stamps = [], []
    reset()
    set_mesh(mesh)
    try:
        with implicit_replication():
            for i in range(MESH_STEPS):
                b = distribute({k: v.cuda() for k, v in ds.sample(i).items()},
                               input_pspecs(base, shape, mesh), mesh)
                state, m = step(state, b)
                losses.append(float(full_tensor(m["loss"])))
                stamps.append(time.perf_counter())
    finally:
        set_mesh(None)
    counts = collect()
    by_shape = {name: dict(c.by_shape)
                for name, c in kernel_counters().items() if c.by_shape}
    require(all(math.isfinite(x) for x in losses),
            f"phase 19 (a): bf16 mesh losses {losses}")
    want = {k: n * MESH_STEPS for k, n in train_launches(base).items()}
    require(counts == want, f"phase 19 (a): launches {counts} != {want}")
    steps_ms = [1e3 * (b - a) for a, b in zip(stamps, stamps[1:])]
    print(f"[phase19 bf16] {MESH_STEPS} mesh steps, losses "
          f"{[round(x, 4) for x in losses]}; launches {counts}; steps 1-"
          f"{MESH_STEPS - 1} {[round(x, 1) for x in steps_ms]} ms (synced "
          f"by the loss's read); max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB; "
          f"{time.perf_counter() - t0:.1f} s on {card}", flush=True)
    del state
    torch.cuda.empty_cache()
    return by_shape


def ring_decode(torch):
    """Phase 19 (b): ``RING``'s model at published widths in fp32: a
    prompt prefilled into a ring-buffer cache (``WINDOWED_KV_CACHE``: the
    window's 4,096 slots) and into a full cache of prompt + steps slots;
    the decode steps teacher-forced by the full run's greedy tokens, past
    the ring's wrap; every step's logits on the ring within ``RING_TOL``
    of that step's largest on the full cache (its window's mask). Returns
    (model, params, the prefill's cache, the prompt) for (c)."""
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tmod
    from repro_torch.models.transformer import Model
    arch, depth, P, steps = RING
    base = get_arch(arch)
    cfg = dataclasses.replace(base, n_layers=depth, dtype="float32")
    W = cfg.sliding_window
    print(f"model: {base.name} d_model {cfg.d_model}, {cfg.n_heads} heads / "
          f"{cfg.n_kv_heads} KV heads, head_dim {cfg.resolved_head_dim}, "
          f"window {W} ({cfg.layer_pattern}), vocab {cfg.vocab_size}, fp32; "
          f"reduced: n_layers {base.n_layers}->{depth}", flush=True)
    t0 = time.perf_counter()
    model = Model(cfg)
    params = model.init(0, device="cuda")
    prompt = torch.randint(0, cfg.vocab_size, (1, P),
                           generator=torch.Generator().manual_seed(0)).cuda()
    with torch.no_grad():
        _, pre = model.prefill(params, {"tokens": prompt})
        full = model.alloc_cache(1, P + steps, device="cuda")
        tmod.WINDOWED_KV_CACHE = True
        try:
            ring = model.alloc_cache(1, P + steps, device="cuda")
        finally:
            tmod.WINDOWED_KV_CACHE = False
        require(ring[0]["k"].shape[2] == W and P + steps > W,
                f"phase 19 (b): the ring holds {ring[0]['k'].shape[2]} slots")
        for cache in (full, ring):
            for seg, p in zip(cache, pre):
                for k in seg:
                    seg[k][:, :, :P] = p[k]
        tok, worst, at = prompt[:, -1:], 0.0, 0
        for i in range(steps):
            b = {"token": tok, "pos": torch.tensor([P + i], device="cuda")}
            want, _ = model.decode_step(params, full, b)
            got, _ = model.decode_step(params, ring, b)
            err = float((got - want).abs().max() / want.abs().max())
            if err > worst:
                worst, at = err, P + i
            tok = want.argmax(-1).reshape(1, 1)
    torch.cuda.synchronize()
    require(worst <= RING_TOL, f"phase 19 (b): ring logits off by {worst:.3g}"
            f" of the largest at position {at}")
    print(f"[phase19 ring] a {P}-token prompt, {steps} decode steps "
          f"(positions {P}-{P + steps - 1}; the ring of {W} slots wraps at "
          f"{W}) == the {P + steps}-slot cache: worst {worst:.3g} of the "
          f"step's largest |logit| (at {at}) <= {RING_TOL}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return model, params, pre, prompt


def flash_decode_step(torch, mesh, model, params, pre, prompt):
    """Phase 19 (c): one decode step with ``SHARDED_DECODE_AXIS`` on the
    mesh (batch 1: ("pod", "data", "model"), as the dry run sets it), the
    params, a full cache holding the prompt and the batch placed by their
    specs, == the unsharded step: logits and the written cache within
    1e-5 of their largest value, ``_flash_decode_sharded`` once a layer."""
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed.sharding import (distribute, full_tensor,
                                                  set_mesh)
    from repro_torch.models import attention as attn_mod
    from repro_torch.models.transformer import input_pspecs
    from repro_torch.tree import tree_map
    cfg = model.cfg
    P = prompt.shape[1]
    L = P + RING[3]
    shape = ShapeConfig("decode", seq_len=L, global_batch=1, mode="decode")
    cache = model.alloc_cache(1, L, device="cuda")
    for seg, p in zip(cache, pre):
        for k in seg:
            seg[k][:, :, :P] = p[k]
    batch = {"token": prompt[:, -1:].to(torch.int32),
             "pos": torch.full((1,), P, dtype=torch.int32, device="cuda")}
    dcache = distribute(tree_map(torch.clone, cache),
                        model.cache_specs(shape, mesh), mesh)
    dparams = distribute(params, model.param_specs(), mesh)
    dbatch = distribute(batch, input_pspecs(cfg, shape, mesh), mesh)
    calls = [0]
    fd = attn_mod._flash_decode_sharded

    def counted(*a, **k):
        calls[0] += 1
        return fd(*a, **k)
    with torch.no_grad():
        want, cache = model.decode_step(params, cache, batch)
        attn_mod._flash_decode_sharded = counted
        attn_mod.SHARDED_DECODE_AXIS = ("pod", "data", "model")
        set_mesh(mesh)
        try:
            with implicit_replication():
                got, dcache = model.decode_step(dparams, dcache, dbatch)
            got = full_tensor(got)
        finally:
            set_mesh(None)
            attn_mod.SHARDED_DECODE_AXIS = None
            attn_mod._flash_decode_sharded = fd
    err = float((got - want).abs().max() / want.abs().max())
    cerr = max(float((full_tensor(g[k]) - w[k]).abs().max()
                     / w[k].abs().max())
               for g, w in zip(dcache, cache) for k in w)
    require(calls[0] == cfg.n_layers and err <= 1e-5 and cerr <= 1e-5,
            f"phase 19 (c): flash-decode x {calls[0]}, logits off by "
            f"{err:.3g}, cache by {cerr:.3g}")
    print(f"[phase19 flash-decode] one step at position {P} on the mesh, "
          f"the {L}-slot cache's sequence over (\"data\", \"model\"): "
          f"_flash_decode_sharded x {calls[0]}; logits within {err:.3g} and "
          f"the written cache within {cerr:.3g} of the unsharded step's "
          f"(<= 1e-5)", flush=True)


def danube_paged(torch, model, params, prompt, main_launches):
    """Phase 19 (b), paged: the ring's h2o-danube-3-4b (fp32, published
    widths, 2 layers; ``params`` on the card) serving ``DN_PAGED_PROMPTS``
    (the ring's own 4,000-token ``prompt`` and two of 40 tokens) through
    the batch engine on a swapped mmap store planned at 0.9x its resident
    bytes in >= 3 blocks, beside a pool of PAGE_TOKENS-token pages; the
    long request decodes past its 4,096-token window. Every request's
    tokens equal it served alone in memory (``ServingEngine``, as phase 4's
    run A); B3 ran once a layer a decode step, every launch at hd 120 (the
    kernel's row width 128), 32 / 8 heads and window 4096. Returns the
    run's launches by kernel and shape."""
    import numpy as np
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.serving.engine import Request, ServingEngine

    cfg = model.cfg
    reset, collect = launch_counting(main_launches)
    before = {name: dict(keys) for name, keys in main_launches.items()}
    rng = np.random.default_rng(19)
    prompts = [prompt[0].tolist()] + [
        list(map(int, rng.integers(0, cfg.vocab_size, n)))
        for n in DN_PAGED_PROMPTS[1:]]
    require([len(p) for p in prompts] == DN_PAGED_PROMPTS,
            f"phase 19 (b): prompts of {[len(p) for p in prompts]} tokens")
    longest = DN_PAGED_PROMPTS[0] + DN_PAGED_NEW[0] - 1
    require(longest > cfg.sliding_window, f"phase 19 (b): the long request "
            f"ends at {longest} tokens, inside its {cfg.sliding_window} "
            f"window")
    t0 = time.perf_counter()
    solo = ServingEngine(model, params, max_len=longest + 2, device="cuda")
    want = []
    for p, n in zip(prompts, DN_PAGED_NEW):
        r = Request(0, list(p), max_new_tokens=n)
        solo.generate([r])
        want.append(r.output)
    del solo
    torch.cuda.empty_cache()
    solo_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        sm, kv, budget = paged_model(torch, model, params, d,
                                     dict(store_backend="mmap"), cfg,
                                     DN_MAX_PAGES, max(DN_PAGED_PROMPTS))
        try:
            require(sm.plan.n_blocks >= 3,
                    f"phase 19 (b): {sm.plan.n_blocks} blocks")
            reqs, be, counts, windows, alloc0 = drive_paged(
                torch, sm, kv, prompts, DN_PAGED_NEW, len(prompts), reset,
                collect)
            out = report_paged(torch, "phase19 paged", sm, kv, be, budget,
                               windows, alloc0)
        finally:
            sm.close()
    paged_s = time.perf_counter() - t0
    check_paged_run("phase19 paged", kv, be, counts, cfg.n_layers, budget)
    got = [r.output for r in reqs]
    require(got == want, f"phase 19 (b): paged tokens {got} != served "
            f"alone {want}")
    keys = dict(pa.launches.by_shape)
    at = {(k[0], k[1], k[2], k[3], k[6], k[7], k[8]) for k in keys}
    require(all(k[1:] == (32, 8, 120, "float32", 4096, None) for k in at),
            f"phase 19 (b): paged_attention launched at {sorted(at)}")
    steps = sum(1 for t in be.trace if t.batch)
    sizes = sorted({len(t.batch) for t in be.trace if t.batch})
    print(f"[phase19 paged] {len(prompts)} requests (prompts "
          f"{DN_PAGED_PROMPTS}, {DN_PAGED_NEW} new tokens; the long one "
          f"to {longest} tokens, past its {cfg.sliding_window}-token "
          f"window) == each served alone in memory; {steps} decode steps "
          f"at batch {sizes}, paged_attention x {counts['paged_attention']}"
          f" ({cfg.n_layers} layers x {steps}) at hd 120, 32 / 8 heads, "
          f"window 4096; batched {paged_s:.1f} s, alone in memory "
          f"{solo_s:.1f} s; launches {counts}", flush=True)
    out.update(tokens=[len(t) for t in got], batched_s=paged_s,
               solo_s=solo_s)
    return since(main_launches, before)


def run_mesh(torch, card, main_launches):
    """Phase 19: the mesh path on one card: (a) :func:`mesh_train`, (b)
    :func:`ring_decode`, (c) :func:`flash_decode_step`, on a one-rank NCCL
    group destroyed after; then (b)'s model paged, :func:`danube_paged`.
    Returns (a)'s and the paged run's counted launches by shape."""
    import torch.distributed as dist
    t0 = time.perf_counter()
    mesh = nccl_mesh(torch)
    print(f"[phase19] NCCL group of 1 rank, mesh {tuple(mesh.shape)} "
          f"{tuple(mesh.mesh_dim_names)} on {mesh.device_type}, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    try:
        by_shape = mesh_train(torch, card, mesh, main_launches)
        model, params, pre, prompt = ring_decode(torch)
        flash_decode_step(torch, mesh, model, params, pre, prompt)
    finally:
        dist.destroy_process_group()
    del pre
    torch.cuda.empty_cache()
    paged = danube_paged(torch, model, params, prompt, main_launches)
    del model, params
    torch.cuda.empty_cache()
    return {name: {**by_shape.get(name, {}), **paged.get(name, {})}
            for name in set(by_shape) | set(paged)}


# ---------------------------------------------------------------- granite
def run_granite(torch, main_launches):
    """Phase 20: granite-20b at its published widths, ``GR_LAYERS``
    layers, seed-0 fp32 weights drawn on the card and copied to the host,
    served in bf16 from its ``swap_precision``'s int4 lazy store
    (:func:`quant_arm`: planned under 1.1x the smallest budget at m = 2,
    below the store's resident bytes in >= 3 blocks; one first pass of a
    ``GR_PROMPT``-token prompt, bitwise the forward over the store's lazy
    leaves and within ARM_TOL of the forward through B1's plain version;
    the device bytes the ledger's); then on the same store and budget three
    paged generations, B3 at 48 query heads of 128 on one KV head, equal
    to each request served alone."""
    import numpy as np
    from repro_torch.configs import get_arch
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models.transformer import Model
    from repro_torch.serving.paged_kv import PagedKVCache

    reset, collect = launch_counting(main_launches)
    before = {name: dict(keys) for name, keys in main_launches.items()}
    base = get_arch("granite-20b")
    cfg = dataclasses.replace(base, n_layers=GR_LAYERS)
    hd = cfg.resolved_head_dim
    print(f"model: {cfg.name} d_model {cfg.d_model}, {cfg.n_heads} heads / "
          f"{cfg.n_kv_heads} KV head of {hd}, d_ff {cfg.d_ff} ({cfg.act}), "
          f"vocab {cfg.vocab_size}, tied {cfg.tie_embeddings}, swap "
          f"precision {cfg.swap_precision}, {cfg.dtype}; reduced: n_layers "
          f"{base.n_layers}->{GR_LAYERS}", flush=True)
    require(cfg.swap_precision == "int4", f"phase 20: {cfg.name} swaps at "
            f"{cfg.swap_precision}")
    t0 = time.perf_counter()
    model = Model(cfg)
    params = host_copy(torch, model.init(0, device="cuda"))
    n_params = sum(p.numel() for p in _leaves(params))
    init_s = time.perf_counter() - t0
    print(f"params: {n_params / 1e9:.3f} B, {4 * n_params / 1e9:.2f} GB "
          f"(fp32, host), init on the card and copied down in "
          f"{init_s:.1f} s", flush=True)
    rng = np.random.default_rng(20)
    batch = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (1, GR_PROMPT)), dtype=torch.int32)}
    prompts = [list(map(int, rng.integers(0, cfg.vocab_size, n)))
               for n in GR_PAGED_PROMPTS]
    new = [GR_PAGED_NEW] * len(prompts)
    out = {"params": n_params, "init_s": init_s}

    def paged(sm, budget):
        """The three generations on the arm's store and ledger, batched,
        then each alone."""
        kv = PagedKVCache(cfg, sm.engine.ledger, page_tokens=PAGE_TOKENS,
                          max_pages=GR_MAX_PAGES, device="cuda")
        t0 = time.perf_counter()
        reqs, be, pcounts, windows, alloc0 = drive_paged(
            torch, sm, kv, prompts, new, len(prompts), reset, collect)
        res = report_paged(torch, "phase20 paged", sm, kv, be, budget,
                           windows, alloc0)
        check_paged_run("phase20 paged", kv, be, pcounts, GR_LAYERS, budget)
        at = {(k[1], k[2], k[3], k[6], k[7])
              for k in pa.launches.by_shape}
        require(at == {(48, 1, 128, "bfloat16", None)},
                f"phase 20: paged_attention launched at {sorted(at)}")
        require(pcounts["swap_linear_q"] > 0 and pcounts["swap_linear"] == 0,
                f"phase 20: launches {pcounts}")
        paged_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        solo = []
        for p, n in zip(prompts, new):
            sreqs, sbe, scounts, _, _ = drive_paged(
                torch, sm, kv, [p], [n], 1, reset, collect)
            check_paged_run("phase20 alone", kv, sbe, scounts, GR_LAYERS,
                            budget)
            solo.append(sreqs[0].output)
        solo_s = time.perf_counter() - t0
        got = [r.output for r in reqs]
        require(got == solo and all(len(t) == GR_PAGED_NEW for t in got),
                f"phase 20: paged tokens {got} != served alone {solo}")
        steps = sum(1 for t in be.trace if t.batch)
        print(f"[phase20 paged] {len(prompts)} requests (prompts "
              f"{GR_PAGED_PROMPTS}, {GR_PAGED_NEW} new tokens each) == "
              f"each served alone: {got}; {steps} decode steps, "
              f"paged_attention x {pcounts['paged_attention']} at 48 / 1 "
              f"heads of 128 ({pa.groups(48)} head groups a KV head); "
              f"batched {paged_s:.1f} s, alone {solo_s:.1f} s; launches "
              f"{pcounts}", flush=True)
        res.update(tokens=got, batched_s=paged_s, solo_s=solo_s)
        return res

    P20_WORKDIR.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    out["int4_lazy"] = quant_arm(
        torch, f"phase20 {cfg.name} bf16 int4-lazy, {GR_LAYERS} layers",
        model, params, batch, GR_PROMPT, P20_WORKDIR / "int4-lazy", reset,
        collect, {"swap_linear_q": 6 * GR_LAYERS + 1, "swap_linear": 0,
                  "flash_attention": GR_LAYERS, "dequant_int8": 0},
        precision="int4", then=paged)
    arm_s = time.perf_counter() - t0
    del params
    print(f"[phase20] wall s: init {init_s:.1f}, int4-lazy arm and paged "
          f"{arm_s:.1f}", flush=True)
    out["by_shape"] = since(main_launches, before)
    return out


KERNEL_NAMES = ("swap_linear_q", "dequant_int8", "paged_attention", "wkv6",
                "swap_linear", "flash_attention")


def kernel_counters() -> dict:
    """The six kernels' launch counters, by name."""
    from repro_torch.kernels import dequant as dq
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import swap_linear as sl
    from repro_torch.kernels import swap_linear_q as slq
    from repro_torch.kernels import wkv6 as kw
    return dict(zip(KERNEL_NAMES, (slq.launches, dq.launches, pa.launches,
                                   kw.launches, sl.launches, fa.launches)))


def launch_counting(main_launches):
    """(reset, collect) over the kernels' launch counters: reset sets every
    count to 0 before a main-path run; collect reads the counts after it
    and adds the per-shape launches to ``main_launches``."""
    counters = kernel_counters()

    def reset():
        for c in counters.values():
            c.reset()

    def collect():
        got = {k: c.count for k, c in counters.items()}
        for k, c in counters.items():
            for key, n in c.by_shape.items():
                main_launches[k][key] = main_launches[k].get(key, 0) + n
        return got
    return reset, collect


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    # what torch.compile builds (the flex_attention yardstick) stays in the
    # checkout's build/
    for var, sub in (("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, str(ROOT / "build" / "compile_cache" / sub))
    # each timed row recompiles flex_attention for its shape and mask: past
    # dynamo's default limit of 8 a function runs uncompiled
    torch._dynamo.config.recompile_limit = 64
    from repro_torch.configs import get_arch
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # phase 10 holds swapped conv nets to their in-memory forward bitwise:
    # cuDNN must pick the same algorithm for the same shapes every call,
    # and none whose sums depend on a race or a timing run
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    t_all = time.perf_counter()

    with phase("1 device"):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()
        card = smi[torch.cuda.current_device()].strip()
        print(card, flush=True)
        print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
              f"{torch.cuda.get_device_name(0)}; devices "
              f"{torch.cuda.device_count()}", flush=True)
        t0 = time.perf_counter()
        path = _build.build()
        _build.library()
        regs = [ln.strip() for ln in _build.build_log.splitlines()
                if "registers" in ln]
        print(f"kernels built in {time.perf_counter() - t0:.1f} s: "
              f"{path.name}; ptxas: {regs[:2]} ... ({len(regs)} variants)",
              flush=True)
        print("nvcc s by source (all started together): " + ", ".join(
            f"{name} {sec:.1f}" for name, sec in sorted(
                _build.build_seconds.items(), key=lambda kv: -kv[1])),
            flush=True)
        for line in (gemm_ptxas(_build.build_log)
                     + kernel_ptxas(_build.build_log, ATTENTION_KERNELS)
                     + kernel_ptxas(_build.build_log, WKV6_KERNELS)):
            print(line, flush=True)

    cfg = dataclasses.replace(get_arch("qwen2.5-3b"), n_layers=N_LAYERS)
    gcfg = dataclasses.replace(get_arch("gemma2-9b"), n_layers=GEMMA_LAYERS)
    # phase 10's self-driving plans, from the layer lists alone: they fix
    # TPrg's kept channels, so the shapes phase 2 must hold
    t0 = time.perf_counter()
    p10_planners = {}
    sd_sched, _ = p10_scheduler(P10_SCENARIOS["self_driving"], p10_planners)
    conv_path = p10_kernel_shapes(sd_sched)
    print(f"phase 10's self-driving fleet planned in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    # phases 9 and 11-13's int8-lazy arms: their configs cut to the arms'
    # depths, held in int8 and int4 (llama4's head at N 202,048, not a
    # multiple of 128, at every column); phase 20's int4 granite-20b, its
    # first pass and its paged decode (admissions, steps at 3 sequences
    # and at 1)
    arms = [k + ((8, 4),) for name, d, M in (
        ("llama4-scout-17b-a16e", LLAMA_Q_LAYERS, LLAMA_PROMPT),
        ("deepseek-v2-lite-16b", DS_Q_LAYERS, DS_PROMPT),
        ("zamba2-7b", Z_Q_LAYERS, Z_PROMPT),
        ("qwen2-vl-72b", VL_Q_LAYERS, VL_PROMPT))
        for k in arm_linear_shapes(dataclasses.replace(
            get_arch(name), n_layers=d), M)]
    grcfg = dataclasses.replace(get_arch("granite-20b"), n_layers=GR_LAYERS)
    arms += [k + ((4,),) for M in sorted({GR_PROMPT, *GR_PAGED_PROMPTS,
                                          len(GR_PAGED_PROMPTS), 1})
             for k in arm_linear_shapes(grcfg, M, head_rows=(
                 M if M <= len(GR_PAGED_PROMPTS) else 1))]
    with phase("2 kernels against their plain versions"):
        secs = {}

        def timed(name, fn, *args):
            t0 = time.perf_counter()
            out = fn(*args)
            secs[name] = time.perf_counter() - t0
            return out
        rows = timed("swap_linear_q, dequant_int8", check_kernels, torch,
                     cfg, conv_path, arms)
        rows += timed("paged_attention", check_paged_attention, torch)
        rows += timed("wkv6", check_wkv6, torch)
        rows += timed("swap_linear", check_swap_linear, torch, cfg, gcfg,
                      get_arch("rwkv6-3b"), get_arch("llama4-scout-17b-a16e"),
                      get_arch("deepseek-v2-lite-16b"), get_arch("zamba2-7b"),
                      get_arch("qwen2-vl-72b"), get_arch("hubert-xlarge"),
                      get_arch("h2o-danube-3-4b"), get_arch("granite-20b"),
                      conv_path)
        rows += timed("flash_attention", check_flash_attention, torch)
        timed("gradients", check_train_grads, torch, cfg)
        print("[phase2] s: " + ", ".join(f"{k} {v:.1f}"
                                         for k, v in secs.items()),
              flush=True)

    from repro_torch.models.transformer import Model
    main_launches = {name: {} for name in KERNEL_NAMES}
    with phase("3 the slice at full width"):
        print(f"model: {cfg.name} d_model {cfg.d_model}, {cfg.n_heads} heads "
              f"/ {cfg.n_kv_heads} KV heads, head_dim "
              f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab "
              f"{cfg.vocab_size}, qkv bias {cfg.attn_bias}, tied "
              f"{cfg.tie_embeddings}, {cfg.dtype}", flush=True)
        print(f"reduced: n_layers 36->{N_LAYERS}", flush=True)
        t0 = time.perf_counter()
        model = Model(cfg)
        params = model.init(0, device="cpu")     # host: the store's source
        print(f"params: {sum(p.numel() for p in _leaves(params)) / 1e6:.1f} "
              f"M (fp32, host), init {time.perf_counter() - t0:.1f} s",
              flush=True)
        run_slice(torch, cfg, model, params, main_launches)

    with phase("4 paged continuous-batching decode at full width"):
        gmodel, gparams = gemma_model(torch)
        before = {name: dict(keys) for name, keys in main_launches.items()}
        run_paged(torch, cfg, model, params, gmodel, gparams, main_launches)
        print(fp32_routes(since(main_launches, before), "phase 4",
                          ("swap_linear", "flash_attention")), flush=True)
    torch.cuda.empty_cache()

    with phase("5 rwkv6-3b swapped at full width"):
        before = {name: dict(keys) for name, keys in main_launches.items()}
        run_rwkv6(torch, main_launches)
        print(fp32_routes(since(main_launches, before), "phase 5",
                          ("swap_linear",)), flush=True)

    with phase("6 gemma2-9b full-precision swapped prefill at full width"):
        run_gemma_prefill(torch, gmodel, gparams, main_launches)
    del gmodel, gparams

    with phase("7 two tenants under one budget: the multi-DNN scenario"):
        gmodel7, gparams7 = gemma_model(torch, P7_GEMMA_LAYERS)
        print(f"with {cfg.name} of phase 3", flush=True)
        p7 = run_multi(torch, model, params, gmodel7, gparams7,
                       main_launches)
        check_held(rows, p7["by_shape"], "phase 7")
        print("phase 7 launches by held shape: " + "; ".join(
            f"{name} {held_key(name, k)} x{n}"
            for name, keys in p7["by_shape"].items()
            for k, n in sorted(keys.items(), key=str)), flush=True)
    del gmodel7, gparams7

    with phase("8 the mcu profile: calibration, mixed store, config, HTTP"):
        from repro_torch.tree import tree_map
        model8 = Model(dataclasses.replace(cfg, n_layers=P8_LAYERS))
        params8 = dict(params, segments=[tree_map(
            lambda a: a[:P8_LAYERS], params["segments"][0])])
        print(f"model: {cfg.name} of phase 3, its first {P8_LAYERS} layers "
              f"(n_layers 36->{P8_LAYERS}, seed 0)", flush=True)
        p8 = run_mcu(torch, model8, params8, main_launches)
        p8_check_launches(p8["by_shape"])
        check_held(rows, p8["by_shape"], "phase 8")
        print("phase 8 launches by held shape: " + "; ".join(
            f"{name} {k} x{n}" for name, keys in p8["by_shape"].items()
            for k, n in sorted(keys.items(), key=str)), flush=True)
    del model, params
    torch.cuda.empty_cache()

    with phase("9 llama4-scout's MoE stack at full width, 2x over budget"):
        p9 = run_llama4(torch, card, main_launches)
        check_held(rows, p9["by_shape"], "phase 9")
        print("phase 9 launches by held shape: " + "; ".join(
            f"{name} {held_key(name, k)} x{n}"
            for name, keys in p9["by_shape"].items()
            for k, n in sorted(keys.items(), key=str)), flush=True)

    with phase("10 the paper's conv workloads: three scenarios, vgg's "
               "store arms, the fc stack"):
        p10 = run_conv(torch, sd_sched, p10_planners, main_launches)
        p10_check_launches(p10)
        print(fp32_routes(p10["by_shape"], "phase 10", ("swap_linear",)),
              flush=True)
        check_held(rows, p10["by_shape"], "phase 10")
        print("phase 10 launches by held shape: " + "; ".join(
            f"{name} {k} x{n}" for name, keys in p10["by_shape"].items()
            for k, n in sorted(keys.items(), key=str)), flush=True)
        print("[phase10] rows " + json.dumps(p10["rows"]), flush=True)

    with phase("11 deepseek-v2-lite's MLA stack at full width, 3x over "
               "budget"):
        p11 = run_deepseek(torch, main_launches)
        check_held(rows, p11["by_shape"], "phase 11")
        print("phase 11 launches by held shape: " + "; ".join(
            f"{name} {held_key(name, k)} x{n}"
            for name, keys in p11["by_shape"].items()
            for k, n in sorted(keys.items(), key=str)), flush=True)

    with phase("12 zamba2-7b's hybrid stack at full width, the shared "
               "block pinned, 2.7x over budget"):
        p12 = run_zamba2(torch, main_launches)
        check_held(rows, p12["by_shape"], "phase 12")
        print("phase 12 launches by held shape: " + "; ".join(
            f"{name} {held_key(name, k)} x{n}"
            for name, keys in p12["by_shape"].items()
            for k, n in sorted(keys.items(), key=str)), flush=True)

    with phase("13 qwen2-vl-72b's M-RoPE and vision frontend at full "
               "width, 2.5x over budget"):
        p13 = run_qwen2_vl(torch, main_launches)
        check_held(rows, p13["by_shape"], "phase 13")
        print("phase 13 launches by held shape: " + "; ".join(
            f"{name} {held_key(name, k)} x{n}"
            for name, keys in p13["by_shape"].items()
            for k, n in sorted(keys.items(), key=str)), flush=True)

    with phase("14 hubert-xlarge's bidirectional encoder at full width "
               "and depth"):
        p14 = run_hubert(torch, main_launches)
        check_held(rows, p14["by_shape"], "phase 14")
        print("phase 14 launches by held shape: " + "; ".join(
            f"{name} {held_key(name, k)} x{n}"
            for name, keys in p14["by_shape"].items()
            for k, n in sorted(keys.items(), key=str)), flush=True)

    for num, title, run in (
            ("15", "qwen2.5-3b trained at full width", run_train),
            ("16", "rwkv6-3b trained at full width through WKV6Fn",
             run_train_rwkv6),
            ("17", "gemma2, deepseek, zamba2, hubert, h2o-danube and "
             "granite trained at full width", run_train_families)):
        with phase(f"{num} {title}"):
            shapes = run(torch, card, main_launches)
            check_held(rows, shapes, f"phase {num}")
            print(f"phase {num} launches by held shape: " + "; ".join(
                f"{name} {k} x{n}" for name, keys in shapes.items()
                for k, n in sorted(keys.items(), key=str)), flush=True)

    with phase("18 the dry run: DTensor on a fake 256- / 512-rank group"):
        run_dryrun(torch)

    with phase("19 the mesh path on one card: a one-rank NCCL group; "
               "h2o-danube-3-4b paged past its window"):
        shapes = run_mesh(torch, card, main_launches)
        check_held(rows, shapes, "phase 19")
        print(fp32_routes(shapes, "phase 19",
                          ("swap_linear", "flash_attention")), flush=True)
        print("phase 19 launches by held shape: " + "; ".join(
            f"{name} {held_key(name, k)} x{n}"
            for name, keys in shapes.items()
            for k, n in sorted(keys.items(), key=str)), flush=True)

    with phase("20 granite-20b's MQA at full width on its int4 lazy store, "
               "paged"):
        p20 = run_granite(torch, main_launches)
        check_held(rows, p20["by_shape"], "phase 20")
        print("phase 20 launches by held shape: " + "; ".join(
            f"{name} {held_key(name, k)} x{n}"
            for name, keys in p20["by_shape"].items()
            for k, n in sorted(keys.items(), key=str)), flush=True)

    for name, per_shape in main_launches.items():
        require(sum(per_shape.values()) > 0,
                f"{name} was never launched on the main path")
    print("main-path launches (phases 3 to 17, 19, 20): " + ", ".join(
        f"{name} {sum(per_shape.values())}"
        for name, per_shape in main_launches.items()), flush=True)
    out = []
    for r in rows:
        r = dict(r)
        key = r.pop("key")
        r["launches"] = sum(n for k, n in main_launches[r["name"]].items()
                            if held_key(r["name"], k) == key)
        r.pop("live_tokens", None)
        r.pop("path", None)
        r.pop("fp32_bound_ms", None)
        r.pop("library_call", None)
        r.pop("also", None)
        out.append(r)
    print("phase s: " + ", ".join(f"{k} {v:.1f}"
                                  for k, v in PHASE_SECONDS.items()),
          flush=True)
    print(f"total {time.perf_counter() - t_all:.1f} s", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": out}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
