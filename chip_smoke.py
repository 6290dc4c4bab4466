"""Drive the PyTorch port's serving, runahead, training, MoE, SSM,
encoder-decoder and cache-reconfiguration paths, its sweep service,
sharding layer and dry run on one CUDA card and check them.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and skipped):

1. require a CUDA card; print its name and power limit; turn TF32 off;
2. build the hand-written kernels from ``src/repro_torch/kernels/*/csrc``;
3. hold the paged-attention kernel against its plain PyTorch version and,
   elementwise, its kernel-order split version on the card at the decode
   shapes of the main path and at 8 rows of 4,096 tokens, and time kernel,
   plain version and a library yardstick against the bytes bound;
4. serve full-width qwen2-1.5b (random weights from a seed) through
   ``repro_torch.serve.ServeEngine``: 12 requests on 8 slots, checking
   completion, page accounting and that every decode step's attention went
   through the paged-attention kernel;
5. hold the kernel read path against the gather read path on one prompt,
   in bfloat16 (reported) and float32 (held to 5e-2);
6. drive the paper's runahead path through its entry points at full size,
   with every launch counter set to 0 just before and read just after:
   ``ops.gather`` (runahead at depths 1, 2, 4, 8 and pipelined) over an
   OGBN-Arxiv-shaped table (169,343 x 128, float32 and bfloat16) for the
   destinations of a seeded power-law graph and for uniform indices, each
   bit-identical to ``table[idx]``, each runahead launch on the route
   ``gather_runahead.route`` names (counted by route), and then
   ``runahead_gather`` on both routes (``use="bulk"`` and
   ``"cp_async"``) bit-identical at every one of those depths;
   ``ops.gather_bag`` over the graph's
   padded CSR at depths 1, 2, 4 within its stated tolerance of the plain
   version and bit-identical to its kernel-order plain version; and
   ``cache_grid.hit_series`` over the §3.4 profiling grid (132
   configurations, 4 (line, sets) groups, 60 stack chains) for four
   16,384-address windows of Listing 1's feature loads, equal to the plain
   version (window 0 on the card, the last on the host), equal on every
   window to the stack version in the kernels' order (host), and holding
   the LRU stack property;
7. time each of those kernels against its plain version and library call
   (the gathers, the bag and the profiler by graph replay, eager beside:
   the runahead gather on both routes at each depth, and at one block per
   SM, Fig. 14's sweep, whose time must fall with the depth on both; the
   bag's row fetches against the padded bag's and its warps per SM, and
   each profiler window's longest chain, computed on the host);
8. hold the flash-attention kernel against its plain version at the
   training shape (B 4 x H 12 x S 4,096 x D 128, causal, bf16 and f32) and
   at non-causal, window-96, GQA 12/2, query-offset and ragged-tail
   shapes, the last three at D 80 too (h2o-danube's width: the
   tensor-core route in bf16), each launch counted on the route
   ``flash_attention.route`` names; hold blocked attention's grads
   (kernel forward, chunked backward) against autograd through the plain
   reference attention at S 2,048; time kernel, plain version and SDPA
   against the bound;
9. train full-width qwen2-1.5b (random weights from seed 0) through
   ``repro_torch.launch.train_lm``'s pieces: ``synthetic_batch`` ->
   ``RunaheadLoader`` (depth 2) -> ``train_step`` (AdamW) ->
   ``TrainDriver`` with a ``Checkpointer`` every 4 steps, 8 steps at
   B 4 x S 4,096, the flash launch counter set to 0 just before and read
   just after (exactly 8 x 28 layers x 2, the forward and its per-layer
   recompute); step 0's loss within 2e-2 of the same loss through the
   plain attention and within 0.5 of ln V; a restore of step 4 equal bit
   for bit to the state saved; then 6 steps on one repeated batch must
   lower its loss;
10. hold the MoE dispatch and combine kernels against their plain versions
    (dispatch bit-identical, combine within one bf16 rounding) at dbrx's
    serving shapes (decode 8 tokens, prefill chunk 64) and 4 groups of
    1,024 tokens, with the slots of dbrx's own top-4 routing at capacity
    factor 1.25; time them and ``index_copy_`` / ``embedding_bag`` by
    CUDA-graph replay (eager events beside) against the bound, and print
    the blocks combine splits each row into;
11. serve full-width dbrx-132b, 8 of its 40 layers, through the engine as
    in phase 4, with the paged-attention, dispatch and combine counters
    set to 0 just before and read just after (dispatch and combine once a
    layer per decode step and prefill chunk); hold the MoE kernels' logits
    against their plain versions at one prefill chunk and one decode step
    in float32 (2 layers, 1e-4 of the logit std) and report bfloat16;
12. hold the SSD kernel's tensor-core (mma) route against the plain
    chunked scan at mamba2's head shape (B 4 x S 4,096 x H 80 x P 64 x N
    128, bf16 in, f32 y) within 1e-4 |want| + 1e-5 max|want| elementwise,
    against its split-bf16 plain version in the kernel's order, and
    against the per-token recurrence at a small shape; time the mma and
    the scalar (simt) route by graph replay and eager events against the
    bound (bytes at 3.35 TB/s or flops at 989 TFLOP/s); the mma route must
    be the faster;
13. run full-width, full-depth mamba2-2.7b: ``api.prefill`` at B 4 x S
    4,096 with exactly 64 SSD launches, all on the mma route, then 32
    greedy lockstep
    ``api.decode`` steps of 8 sequences; hold prefill against 512 decode
    steps in float32 at 4 layers (1e-3 of the logit std) and report the
    bfloat16 full-depth gap;
14. serve full-width, full-depth whisper-small (12 + 12 layers, random
    weights, seeded N(0, 1) frame embeddings): ``api.prefill`` at B 8 x
    4,096 frames x 448 decoder tokens with exactly 12 flash launches (one
    an encoder layer, on the wgmma route), then ``encode`` (12 more),
    ``precompute_cross`` into an ``api.init_cache(cfg, 8, 448)`` cache and
    32 greedy lockstep ``api.decode`` steps; time the flash kernel at the
    encoder's shape against its plain version, SDPA and the bound; hold
    the card's float32 prefill against the CPU path's (2 + 2 layers, B 1,
    1e-4 of the logit std) and prefill against 64 teacher-forced decode
    steps (float32, 2 + 2 layers, 1e-4 of the logit std), and report the
    bfloat16 full-depth gap;
15. run the paper's §3.4 loop, ``reconfig.reconfigure`` at
    ``presets.RECONFIG``, for the ten Table-1 kernels with its profile on
    the card, at window 8,192 and over whole per-cache streams: the
    ``cache_grid_scan`` counter set to 0 just before and read just after
    must equal the non-empty streams, and ``h_curves`` must equal the CPU
    route's bit for bit, allocations, lines, profit and configuration
    too; time one reconfigure's profile (wall, and the kernels by graph
    replay) against the CPU route, and simulate the base and reconfigured
    systems, runahead off and on, against the paper's Fig. 17 averages.
    Then Algorithm 1 as an operand allocator at dbrx-132b's published
    width (block 0's router and the 100,352 x 6,144 embedding, random,
    seed 0; 8 x 4,096 seeded tokens): ``core.runahead.allocate`` on the
    card must equal the CPU route's plan, and ``ops.gather`` at the plan's
    depth must be bit-identical to ``embed[tokens]``, with exactly 2
    profiler launches and 1 gather, on the bulk route; the gather (and
    its cp_async route, bit-identical too) timed by graph replay in turns
    with ``index_select``, against its bound;
16. run the crash-safe sweep service (``repro_torch.core.cgra.sweep``),
    whose worker pool forks before anything initializes CUDA (the
    script's first act on the card's machine): the ten Table-1 kernels
    under ``examples/simulate_cgra.py``'s four single-cache rows and
    phase 15's four Fig. 17 configurations (80 points) into a fresh
    temporary store, every point computed and the 40 Fig. 17 points equal
    to phase 15's ``simulate_batch`` Stats field for field; again into
    the same store, none computed and the same results; into a second
    store under a seeded ``mixed`` chaos plan (worker crashes, task hangs,
    torn records, a dropped index), where the crash's pool rebuild must
    degrade to inline work (CUDA is initialized by then), the results
    must be the cold run's bit for bit and a re-read must recompute
    exactly the torn records; then ``reconfigure_cached`` for the ten
    kernels at window 8,192, its profile on the card: cold, the
    ``cache_grid_scan`` counter set to 0 just before and read just after
    must equal phase 15's non-empty streams, with phase 15's allocations,
    lines, profit and configuration; warm, no launch, the same results
    and no ``h_curves``.  Sweep times, points per second and
    ``reconfigure_cached`` cold vs warm ms are printed beside the card;
17. run the sharding layer (``repro_torch.sharding``) on a one-rank NCCL
    group (a ``FileStore``, no TCP port) over ``make_host_mesh(1, 1)``:
    ``build_train_step`` under ``MeshRules`` at its defaults (the
    residual stream's sequence sharded over ``model``) for 2 steps of
    full-width
    qwen2-1.5b at phase 9's B 4 x S 4,096 on a state placed by
    ``state_specs`` (DTensor parameters and moments), the flash counter
    set to 0 just before and read just after (exactly 2 x 56), then the
    same 2 steps unsharded from the same seed (the sharded state is
    copied to the host and freed first); each loss within 1e-4 relative;
    printed: whether losses and every leaf came out bit-identical, the
    largest leaf difference and step ms both ways.  Then the full-width
    ``ServeEngine`` without rules and with them (params placed by
    ``param_specs``, the paged pools replicated on the mesh), 4 greedy
    requests of phase 4's first 4 prompts, 32 new tokens each: equal
    tokens, paged launches = decode steps x 28 with rules, 0 page leaks;
    decode-step ms both ways (the gap is DTensor's host dispatch);
18. in the same group and mesh, every other model family through the
    same entry points, each run on the mesh against the plain run from
    the same seed, with the launch counters of its kernels set to 0 just
    before and read just after each run on the mesh (in training each
    kernel launches twice a layer a step: the forward and its per-layer
    recompute): full-width dbrx-132b at phase 11's 8 layers through the
    ``ServeEngine`` without and with rules on phase 4's first 4 prompts
    (equal greedy tokens; dispatch = combine = 8 x (decode steps +
    prefill chunks) and paged = decode steps x 8 on the mesh, the paged
    read and the MoE regions in ``local_map``); dbrx-132b at 1 layer and
    one microbatch, 2 ``build_train_step`` steps at B 1 x S 2,048 against
    2 plain ``train_step``s (losses within 1e-4 relative, leaves compared
    by digests of their bits computed on the card); full-width, full-depth
    mamba2-2.7b ``build_step`` prefill at B 4 x S 4,096 (bit-identical
    logits, exactly 64 ``ssd_scan`` launches, all on the mma route), 8
    lockstep decode steps (bit-identical) and 2 training steps at the
    largest of B 4, 2, 1 x S 4,096 whose plain step fits (as dbrx's);
    jamba-1.5-large-398b at full width cut to its first 4 layers (SSM,
    attention and MoE blocks) prefill at B 2 x S 4,096 and 8 lockstep
    decode steps (bit-identical); whisper-small at full width and depth,
    32 ``build_step`` decode steps on phase 14's B 8 x 4,096 frames'
    cross K/V, teacher-forced with the plain run's greedy tokens
    (bit-identical).
19. the production-mesh dry run (``repro_torch.launch.dryrun``): (a) in a
    subprocess with its own time limit and fake 512-rank default group,
    started beside (b) and (c), ``run_cell`` for qwen2-1.5b x decode_32k
    x pod16x16 and dbrx-132b (phase 11's 8 layers) x train_4k x
    pod2x16x16 twice, on the rules' defaults (sequence parallelism on)
    and with ``sequence_parallel`` off, printing each cell's per-rank
    peak GiB, TFLOPs, collective bytes by kind and trace seconds; (b) on the
    one-rank mesh, ``build_train_step`` of qwen2-1.5b (phase 17's B 4 x
    S 4,096), dbrx-132b (1 layer, one microbatch, B 1 x S 2,048) and
    mamba2-2.7b (8 layers, B 4 x S 4,096) traced on meta through
    ``dryrun.trace_step``, then one step run on the card under the same
    counters, with the launch counters set to 0 just before and read
    just after: per-rank FLOPs equal, collective calls by kind equal,
    each kernel's fake calls equal to its launches, the predicted peak
    within 25% of ``max_memory_allocated``; (c) each custom op's fake
    against its kernel at phases 8, 10 and 12's shapes (output shapes,
    dtypes and strides equal), and each op's eager host µs a call
    against the direct call of its kernel wrapper.  The group is
    destroyed at the end of (b, c);
20. serve and train, at published width and with every kernel counter
    set to 0 just before each run and read just after, the five archs
    that no earlier phase ran at their own head geometry, and train
    whisper: internlm2-1.8b at full depth (``ServeEngine`` on phase 4's
    first 4 prompts, 32 greedy tokens each: 4/4 finished, 0 page leaks,
    paged = decode steps x 24; 2 ``train_step``s at B 4 x S 4,096, flash
    = 2 x 24 x 2, step 0 within 2e-2 of the loss through the flash
    kernel's plain version); phi3-medium-14b served at its 40 layers
    (10 KV heads) and trained at 8 (B 2, its 2 microbatches);
    h2o-danube-1.8b at full depth: prefill at B 2 x S 8,192 past its
    4,096 window (24 flash launches, all on the tensor-core route at its
    heads of 80, the kernel timed there against its plain version, SDPA
    and the bound), 8 greedy
    lockstep decode steps on its ring cache, 2 training steps, and in
    float32 at 2 layers prefill vs 5,120 decode steps within 1e-3 of the
    logit std; llama4-scout-17b-a16e served at 8 of 48 layers (top-1
    routing and a shared expert; dispatch = combine = 8 x (decode steps +
    prefill chunks)), its MoE kernels against their plain versions in
    float32 at 2 layers (1e-4 of the logit std) and trained at 1 layer,
    B 1 x S 2,048; internvl2-76b served on token prompts at 24 of 80
    layers and trained at 4 on embeddings inputs with bf16 moments and 4
    microbatches; whisper-small's ``encdec_loss`` through 2 training
    steps at the largest of B 8, 4, 2 x 4,096 frames that fits, flash =
    steps x 12 x 2, step 0 within 2e-2 of the plain-attention loss.  For
    each of the four token archs (``TOKEN_ARCHS``), phase 5's float32
    gate at 2 layers (the paged kernel's read within 5e-2 of the gather
    read, greedy streams equal) and the flash kernel against its plain
    version at the training step's attention shape.  Each arch prints its
    parameters, peak memory, step times, tokens/s and the bf16 logit gap
    of its kernel path against the plain one;
21. sequence parallelism on this machine's torch, the rules' default:
    in a subprocess (``chip_smoke.py --sp-ranks OUT``, 4 gloo ranks on
    the CPU through a ``FileStore``, ``CUDA_VISIBLE_DEVICES=""``) started
    beside phase 19's and collected after phase 20, the smoke configs of
    qwen2, dbrx, mamba2, jamba (its first 4 layers, one microbatch) and
    whisper at (2, 2), and qwen2 at (1, 4), each under ``MeshRules`` at
    its defaults: one float32 ``build_train_step`` step against the
    unsharded ``train_step`` (loss and grad norm within 1e-4 relative,
    each AdamW moment within 1e-4 in relative norm, 2**-8 for the MoE
    archs, each parameter within 2 lr) and one float32 ``build_step``
    prefill against ``prefill_step`` (within 1e-5 of the largest plain
    logit, 2**-8 for the MoE archs), the residual stream ``Shard(1)``
    over ``model`` at every block boundary of the sharded runs; printed
    with ``torch.__version__``, each error and the seconds;
22. serve Poisson traffic through ``repro_torch.launch.serve_traffic``'s
    ``run_traffic`` (the engine under ``serve.drive``'s virtual clock) at
    full-width qwen2-1.5b, the ``--full`` workload (32 requests, seed 7,
    500 virtual requests/s, prompts of 32-384 and outputs of 16-128
    tokens, half sampled) on 8 slots, max_len 512, pages of 16, chunks of
    64, with a pool of 97 pages (preemption of the youngest, re-prefill of
    prompt and generated tokens, pages reused with their last owner's K/V
    in them) and a full one, in bfloat16 at 28 layers and in float32 on
    the first 16 requests with the logits captured; every kernel counter
    set to 0 just before each run and read just after: every request
    finished with its ``max_new_tokens``, 0 page leaks, paged launches =
    decode steps x 28 and no other launch, each run's schedule (steps,
    decode steps, prefill chunks, preemptions, each request's preemptions)
    equal to that of the same requests through a 1-layer smoke engine on
    the host, both pressured runs preempting, and in float32 every stream,
    greedy and sampled, equal between the pressured and the full pool
    unless it flips where the full pool's top-two gap is below 10 x the
    largest logit difference at the positions before (each flip printed);
    bfloat16's equal streams and first divergences are reported.  Printed:
    wall tokens/s, decode-step and prefill-chunk ms p50 / p99, the extra
    prefill chunks preemption cost, virtual TTFT and ITL p50 / p99, peak
    memory.

The second-to-last line is a JSON object describing each kernel, the last
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import gc
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
MEM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
F32_FLOPS_PER_S = 67e12        # H100 SXM, float32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12      # H100 SXM, dense bf16 on the tensor cores
TOL = {torch.bfloat16: 3e-2, torch.float32: 1e-4}   # f32: summation order
KERNEL_SOURCE = "src/repro_torch/kernels/paged_attention/csrc/paged_attention.cu"
KERNEL_REPLACES = "src/repro/kernels/paged_attention/paged_attention.py:87"
GATHER_SOURCE = ("src/repro_torch/kernels/gather_runahead/csrc/"
                 "gather_runahead.cu")
GATHER_REPLACES = "src/repro/kernels/gather_runahead/gather_runahead.py"
GRID_SOURCE = "src/repro_torch/core/cgra/csrc/cache_grid.cu"
GRID_REPLACES = "src/repro/core/cgra/jaxcache.py:56"
# OGBN-Arxiv (Hu et al., OGB, arXiv:2005.00687): nodes, edges, feature width
ARXIV_NODES, ARXIV_EDGES, ARXIV_FEATURES = 169_343, 1_166_243, 128
BLOCK_ROWS = 8
GATHER_N = ARXIV_EDGES // BLOCK_ROWS * BLOCK_ROWS   # 1,166,240: cut to 8s
GATHER_DEPTHS = (1, 2, 4, 8)
BAG_DEPTHS = (1, 2, 4)
WINDOW_EDGES = 8_192          # 2 feature loads per edge: 16,384 addresses
N_WINDOWS = 4
FLASH_SOURCE = ("src/repro_torch/kernels/flash_attention/csrc/"
                "flash_attention.cu")
FLASH_REPLACES = "src/repro/kernels/flash_attention/flash_attention.py:86"
# the training cell: train_4k's sequence (models/types.py) at batch 4
TRAIN_B, TRAIN_S = 4, 4_096
TRAIN_STEPS, CKPT_EVERY, REPEAT_STEPS = 8, 4, 6
MOE_SOURCE = "src/repro_torch/kernels/moe_dispatch/csrc/moe_dispatch.cu"
MOE_REPLACES = "src/repro/kernels/moe_dispatch/moe_dispatch.py"
SSD_SOURCE = "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu"
SSD_REPLACES = "src/repro/kernels/ssd_scan/ssd_scan.py:73"
# dbrx-132b's 40 layers are 261 GB in bf16; 8 (54.6 GB) fit one card
DBRX_LAYERS = 8
# whisper-small at train_4k's 4,096 frames (models/api.py input_specs): its
# own 1,500 fail blocked attention's chunk assertion in both packages
WHISPER_B, WHISPER_FRAMES, WHISPER_DECODE = 8, 4_096, 32
WHISPER_CHECK_TOKENS = 64
# the paper's Table-1 kernels in its figures' order (benchmarks/common.py)
PAPER_KERNELS = ("gcn_citeseer", "gcn_cora", "gcn_pubmed", "gcn_ogbn_arxiv",
                 "grad", "perm_sort", "radix_hist", "radix_update", "rgb",
                 "src2dest")
FIG17_WINDOW = 8_192           # benchmarks/fig17_reconfig.py's window
# Fig. 17's average gains, %: real / random data, without / with runahead
FIG17_PAPER = {"real_nora": 4.59, "real_ra": 3.22, "rand_nora": 2.10,
               "rand_ra": 1.58}
# the allocator's batch (tokens) and budget (32 KiB tiles), as in
# examples/autotune_vmem.py but at train_4k's sequence
ALLOC_B, ALLOC_S, ALLOC_BUDGET = 8, 4_096, 16
# phase 16's chaos plan: the sweep's "mixed" profile under a fixed seed
CHAOS_SEED = 16
# phase 17: sharded training steps, and greedy requests through the engine
SHARDED_STEPS, SHARDED_REQUESTS = 2, 4
# phase 18: dbrx trains one layer at one microbatch (its 4 would leave
# B 1 nothing to split); mamba2 trains at the largest batch of these whose
# plain step fits; jamba's first 4 layers (a period of 4 keeps its
# pattern's first 4 positions) hold its SSM, attention and MoE blocks
DBRX_TRAIN_B, DBRX_TRAIN_S = 1, 2_048
MAMBA_TRAIN_BATCHES, MAMBA_TRAIN_S = (4, 2, 1), 4_096
JAMBA_LAYERS, JAMBA_B, JAMBA_S = 4, 2, 4_096
FAMILY_DECODE_STEPS = 8
DIGEST_CHUNK = 2**24
# phase 19: the dry run's cells on the card machine's torch, in a
# subprocess of their own (a fake 512-rank default group); dbrx's on the
# rules' defaults (sequence parallelism on) and with it off
DRYRUN_CELLS = (("qwen2-1.5b", "decode_32k", False, None, None),
                ("dbrx-132b", "train_4k", True, None,
                 {"n_layers": DBRX_LAYERS}),
                ("dbrx-132b", "train_4k", True, {"sequence_parallel": False},
                 {"n_layers": DBRX_LAYERS}))
DRYRUN_TIMEOUT_S = 300
PEAK_GATE = 0.25                 # predicted vs measured peak bytes
OVERHEAD_CALLS = 200
# phase 20: the five archs served and trained at their own width (depths
# reckoned at bf16 weights and 12 B a trained parameter; internvl2 8 with
# its bf16 moments, + 4 for its f32 accumulators), and whisper's training
# at the largest batch that fits
# token archs: name, served and trained layers (None: all), training
# B x S, microbatches (None: the arch's own) and whether step 0 is held
# against the plain attention
TOKEN_ARCHS = (
    ("internlm2-1.8b", None, None, (TRAIN_B, TRAIN_S), None, True),
    ("phi3-medium-14b", None, 8, (2, TRAIN_S), None, False),
    # one microbatch: llama4's own 2 would leave B 1 nothing to split
    ("llama4-scout-17b-a16e", 8, 1, (DBRX_TRAIN_B, DBRX_TRAIN_S), 1, False),
    ("internvl2-76b", 24, 4, (TRAIN_B, TRAIN_S), None, False),
)
READ_CHECK_LAYERS = 2              # the float32 kernel-vs-gather read gate
DANUBE_B, DANUBE_S = 2, 8_192      # past the 4,096 window, so it masks
DANUBE_CHECK_S = 5_120             # f32 prefill vs decode past the window
WHISPER_TRAIN_BATCHES = (8, 4, 2)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def time_ms(fn, flush: torch.Tensor, iters: int = 50) -> float:
    """Median milliseconds of one call by CUDA events, with the L2 cache
    overwritten before each call (the decode path finds its pools cold:
    28 layers of pools and weights pass through L2 between two reads of one
    layer's pool)."""
    for _ in range(5):
        fn()
    pairs = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def graph_ms(fn, flush: torch.Tensor, iters: int = 50) -> float:
    """Median device milliseconds of one call replayed from a CUDA graph,
    L2 overwritten before each (``time_ms``).  The host's enqueue of the
    call is not timed: for a call of a few microseconds an eager call's
    events time mostly the Python wrapper, the flush notwithstanding."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        fn()
    return time_ms(graph.replay, flush, iters)


def split_gate(out, args, n_split: int) -> float:
    """Worst ratio of |kernel - split plain version| to its tolerance: the
    two differ by float32 summation order only, which can move the
    output's rounding by an ulp (2^-7 |y| in bf16, 2^-20 |y| in f32); 1e-5
    absolute beside it."""
    from repro_torch.kernels.paged_attention import ref

    want = ref.paged_attention_split(*args, n_split).float()
    ulp = 2.0 ** -7 if out.dtype == torch.bfloat16 else 2.0 ** -20
    return ((out.float() - want).abs()
            / (ulp * want.abs() + 1e-5)).max().item()


def phase_kernel(flush: torch.Tensor) -> dict:
    from repro_torch.kernels.paged_attention import paged_attention as kernel
    from repro_torch.kernels.paged_attention import ref

    b, h, d, page = 8, 12, 128, 16
    # (name, pages a row, lengths): the serving path's table and lengths;
    # 8 rows of 4,096 tokens, where the old single-block rows ran 256 pages
    # one after another on one SM each
    shapes = [("decode", 32, [0, 1, 15, 16, 17, 255, 511, 512]),
              ("long-context", 256, [4096] * b)]
    gen = torch.Generator(device="cuda").manual_seed(1)
    results = {}
    for sname, pps, lengths_list in shapes:
        n_pages = 1 + b * pps
        table = (torch.randperm(n_pages - 1, generator=gen,
                                device="cuda")[:b * pps]
                 + 1).reshape(b, pps).to(torch.int32)
        lengths = torch.tensor(lengths_list, dtype=torch.int32,
                               device="cuda")
        for dtype in (torch.bfloat16, torch.float32):
            for hkv in ((2, h) if sname == "decode" else (2,)):
                q = torch.randn(b, h, d, generator=gen,
                                device="cuda").to(dtype)
                kp = torch.randn(n_pages, page, hkv, d, generator=gen,
                                 device="cuda").to(dtype)
                vp = torch.randn(n_pages, page, hkv, d, generator=gen,
                                 device="cuda").to(dtype)
                args = (q, kp, vp, table, lengths)
                n_split = kernel.n_splits(b, hkv, pps, page)
                out = kernel.paged_attention(*args)
                torch.cuda.synchronize()
                plain = ref.paged_attention_ref(*args)
                err = (out.float() - plain.float()).abs().max().item()
                if not torch.isfinite(out.float()).all() \
                        or err > TOL[dtype]:
                    raise AssertionError(
                        f"paged_attention {dtype} Hkv={hkv} {sname}: max "
                        f"abs err {err} > {TOL[dtype]}")
                worst = split_gate(out, args, n_split)
                if not worst <= 1.0:
                    raise AssertionError(
                        f"paged_attention {dtype} Hkv={hkv} {sname}: "
                        f"differs from the split plain version by "
                        f"{worst:.3f} x its elementwise tolerance")
                for i, n in enumerate(lengths_list):
                    if n == 0 and out[i].abs().max().item() != 0.0:
                        raise AssertionError("paged_attention: zero-length "
                                             "row is not zero")
                del plain
                # the library yardstick: SDPA over KV already gathered
                # dense (the gather is not timed); the port never calls it
                kd = kp[table.long()].reshape(b, pps * page, hkv, d) \
                    .transpose(1, 2).contiguous()
                vd = vp[table.long()].reshape(b, pps * page, hkv, d) \
                    .transpose(1, 2).contiguous()
                mask = (torch.arange(pps * page, device="cuda")[None, :]
                        < lengths[:, None])[:, None, None, :]
                q4 = q[:, :, None, :]

                def sdpa():
                    return torch.nn.functional.scaled_dot_product_attention(
                        q4, kd, vd, attn_mask=mask, enable_gqa=hkv != h)

                # device time from graph replays; the eager call's time,
                # host enqueue included, beside it
                ms = graph_ms(lambda: kernel.paged_attention(*args), flush)
                eager_ms = time_ms(lambda: kernel.paged_attention(*args),
                                   flush)
                plain_ms = time_ms(lambda: ref.paged_attention_ref(*args),
                                   flush)
                library_ms = graph_ms(sdpa, flush)
                del kd, vd
                elt = q.element_size()
                tokens = sum(min(n, pps * page) for n in lengths_list)
                pages_read = sum(-(-min(n, pps * page) // page)
                                 for n in lengths_list)
                n_bytes = (tokens * hkv * d * 2 * elt + 2 * q.numel() * elt
                           + 4 * b + 4 * pages_read)
                flops = 4 * h * d * tokens
                t_bytes = n_bytes / MEM_BYTES_PER_S * 1e3
                t_ops = flops / F32_FLOPS_PER_S * 1e3
                bound = max(t_bytes, t_ops)
                name = f"{str(dtype).split('.')[-1]} Hkv={hkv} {sname}"
                results[(dtype, hkv, sname)] = dict(
                    max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    bound_ms=bound,
                    bound_by="bytes" if t_bytes >= t_ops else "operations",
                    library_ms=library_ms)
                print(f"phase 3: paged_attention {name} (B {b}, H {h}, D "
                      f"{d}, page {page}, {pps} pages a row, n_split "
                      f"{n_split}: grid {b} x {hkv} x {n_split}): "
                      f"max_abs_err={err:.3e} (tol {TOL[dtype]}); vs split "
                      f"plain version: worst {worst:.3f} of the elementwise "
                      f"tol; ms={ms:.4f} (graph replay, L2 cold; eager "
                      f"call {eager_ms:.4f}) plain_ms={plain_ms:.4f} "
                      f"library_ms={library_ms:.4f} (SDPA on pre-gathered "
                      f"KV, graph replay) bound_ms={bound:.6f} "
                      f"({n_bytes} bytes, {flops} flops) "
                      f"{results[(dtype, hkv, sname)]['bound_by']}-bound, "
                      f"{bound / ms:.1%} of the bound", flush=True)
    # the main path's shape and type
    return results[(torch.bfloat16, 2, "decode")]


def summarize(xs) -> str:
    return (f"p50={np.percentile(xs, 50):.3f} p99={np.percentile(xs, 99):.3f}"
            if xs else "n/a")


def phase_serve(cfg, params, phase: str = "4") -> dict:
    """Serve 12 requests on 8 slots through the engine with every launch
    counter of the path set to 0 just before and read just after; returns
    the launches by kernel, with the decode steps and prefill chunks."""
    from repro_torch.kernels.moe_dispatch import moe_dispatch as moe_kernel
    from repro_torch.kernels.paged_attention import paged_attention as kernel
    from repro_torch.serve import ServeEngine
    from repro_torch.serve.scheduler import RequestState

    has_moe = any(spec.ffn == "moe" for spec in cfg.pattern())
    counters = {"paged_attention": kernel.paged_attention}
    if has_moe:
        counters.update(moe_dispatch=moe_kernel.dispatch,
                        moe_combine=moe_kernel.combine)

    engine_kw = dict(slots=8, max_len=512, page_size=16, prefill_chunk=64,
                     attn_read="kernel")
    warm = ServeEngine(cfg, params, **engine_kw)       # cuBLAS / allocator
    warm.submit(list(range(1, 80)), max_new_tokens=4)
    warm.run()
    warm.assert_no_leaks()
    del warm

    rng = np.random.default_rng(0)
    prompt_lens = rng.integers(32, 385, size=12)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist()
               for n in prompt_lens]
    eng = ServeEngine(cfg, params, **engine_kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.monotonic()
    reqs = [eng.submit(p, max_new_tokens=32,
                       temperature=0.8 if i % 2 else 0.0, seed=i)
            for i, p in enumerate(prompts)]
    step_ms = {"decode": [], "prefill": []}
    while eng.sched.has_work():
        before = eng.metrics.decode_steps
        s0 = time.monotonic()
        if not eng.step():
            break
        torch.cuda.synchronize()
        kind = "decode" if eng.metrics.decode_steps > before else "prefill"
        step_ms[kind].append((time.monotonic() - s0) * 1e3)
    wall = time.monotonic() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    eng.assert_no_leaks()
    for r in reqs:
        if r.state is not RequestState.FINISHED or len(r.out_tokens) != 32:
            raise AssertionError(f"request {r.rid}: {r.state} with "
                                 f"{len(r.out_tokens)} tokens")
    decode_steps = eng.metrics.decode_steps
    chunks = len(step_ms["prefill"])
    expect = {"paged_attention": decode_steps * cfg.n_layers}
    if has_moe:
        n_moe = sum(spec.ffn == "moe" for spec in cfg.pattern()) \
            * cfg.n_groups
        expect.update(moe_dispatch=n_moe * (decode_steps + chunks),
                      moe_combine=n_moe * (decode_steps + chunks))
    if launches != expect or 0 in launches.values():
        raise AssertionError(f"launches {launches} != {expect} for "
                             f"{decode_steps} decode steps and {chunks} "
                             f"prefill chunks x {cfg.n_layers} layers")
    tokens = sum(len(r.out_tokens) for r in reqs)
    ttft = [r.metrics.ttft * 1e3 for r in reqs]
    print(f"phase {phase}: served {len(reqs)} requests (prompts "
          f"{int(prompt_lens.min())}-{int(prompt_lens.max())} tokens, "
          f"{int(prompt_lens.sum())} in all; 32 new tokens each; odd "
          f"requests at temperature 0.8) on 8 slots: {tokens} tokens in "
          f"{wall:.3f} s = {tokens / wall:.2f} tokens/s", flush=True)
    print(f"phase {phase}: TTFT ms {summarize(ttft)}; decode step ms mean "
          f"{statistics.mean(step_ms['decode']):.3f} over "
          f"{len(step_ms['decode'])}; prefill chunk ms mean "
          f"{statistics.mean(step_ms['prefill']):.3f} over {chunks}; peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; "
          f"launches {json.dumps(launches)} = {decode_steps} decode steps "
          + (f"(+ {chunks} prefill chunks for the MoE kernels) " if has_moe
             else "") +
          f"x {cfg.n_layers} layers; page leaks 0; engine "
          f"{json.dumps(eng.metrics.summary())}; {card_line()}", flush=True)
    return launches


def read_paths(cfg, params, prompt) -> dict:
    """Greedy tokens and logits of one prompt under each attention read."""
    from repro_torch.serve import ServeEngine

    runs = {}
    for attn_read in ("kernel", "gather"):
        eng = ServeEngine(cfg, params, slots=8, max_len=512, page_size=16,
                          prefill_chunk=64, attn_read=attn_read,
                          capture_logits=True)
        r = eng.submit(prompt, max_new_tokens=8)
        eng.run()
        eng.assert_no_leaks()
        logits = np.stack(r.logits_log)
        if not (np.isfinite(logits).all()
                and logits.shape == (8, cfg.vocab_size)):
            raise AssertionError(f"{attn_read} read: logits shape "
                                 f"{logits.shape}, finite "
                                 f"{np.isfinite(logits).all()}")
        runs[attn_read] = (r.out_tokens, logits)
    (tk, lk), (tg, lg) = runs["kernel"], runs["gather"]
    # logits at position i come from identical inputs while the greedy
    # streams agree before i; past a split the two runs feed other tokens
    same = next((i for i, (a, b) in enumerate(zip(tk, tg)) if a != b),
                len(tk))
    n = min(same + 1, len(tk))
    return dict(err=float(np.abs(lk[:n] - lg[:n]).max()), positions=n,
                streams_equal=tk == tg, logit_std=float(lk.std()))


def read_prompt(cfg) -> list:
    """Phase 5's 200-token greedy prompt."""
    return np.random.default_rng(1).integers(0, cfg.vocab_size,
                                             size=200).tolist()


def f32_read_gate(cfg, prompt) -> dict:
    """Kernel read vs gather read in float32 on fresh weights from seed 0:
    within 5e-2 over the positions both streams share, and equal greedy
    streams."""
    f32_cfg = dataclasses.replace(cfg, dtype="float32")
    f32_params = api_init(f32_cfg)
    f32 = read_paths(f32_cfg, f32_params, prompt)
    del f32_params
    free_card()
    if f32["err"] > 5e-2 or not f32["streams_equal"]:
        raise AssertionError(f"{cfg.name} ({cfg.n_layers} layers) float32 "
                             f"kernel vs gather logits differ by "
                             f"{f32['err']}; streams equal "
                             f"{f32['streams_equal']}")
    return f32


def phase_reads(cfg, params) -> None:
    """Kernel read vs gather read at full width.  The 5e-2 check is made in
    float32: in bfloat16 the two reads round differently (the kernel keeps
    P.V in float32, the gather path casts P to bfloat16 as the reference
    does) and the random-weight 28-layer model amplifies that to logit
    differences near 0.1, which the bfloat16 line reports without a bound."""
    prompt = read_prompt(cfg)
    bf16 = read_paths(cfg, params, prompt)
    print(f"phase 5: bfloat16 kernel vs gather read, 200-token greedy "
          f"prompt: max abs logit diff {bf16['err']:.3e} over "
          f"{bf16['positions']} positions (logit std "
          f"{bf16['logit_std']:.3f}); streams equal {bf16['streams_equal']}",
          flush=True)
    f32 = f32_read_gate(cfg, prompt)
    print(f"phase 5: float32 kernel vs gather read, same prompt and seed: "
          f"max abs logit diff {f32['err']:.3e} over {f32['positions']} "
          f"positions (tol 5e-2); streams equal {f32['streams_equal']}",
          flush=True)


def powerlaw_graph(n_nodes: int, n_edges: int, rng: np.random.Generator,
                   alpha: float = 1.5) -> tuple[np.ndarray, np.ndarray]:
    """CSR-ordered edge list with Zipf-distributed destinations (a copy of
    the JAX package's ``core/cgra/trace.py`` ``_powerlaw_graph``)."""
    src = np.sort(rng.integers(0, n_nodes, size=n_edges))
    ranks = rng.zipf(alpha, size=n_edges) % n_nodes
    perm = rng.permutation(n_nodes)  # detach hub ids from low addresses
    dst = perm[ranks]
    return src.astype(np.int64), dst.astype(np.int64)


def runahead_inputs() -> dict:
    """The runahead path's data, from seeds: an OGBN-Arxiv-shaped feature
    table, two index streams, the graph's padded CSR, and the profiler's
    address windows."""
    src, dst = powerlaw_graph(ARXIV_NODES, ARXIV_EDGES,
                              np.random.default_rng(0))
    # the pattern of trace.py's random_access: uniform over the table
    uniform = np.random.default_rng(7).integers(0, ARXIV_NODES,
                                                 size=GATHER_N)
    streams = {name: torch.from_numpy(a.astype(np.int32)).cuda()
               for name, a in (("graph", dst[:GATHER_N]),
                               ("uniform", uniform))}
    gen = torch.Generator(device="cuda").manual_seed(3)
    f32 = torch.randn(ARXIV_NODES, ARXIV_FEATURES, generator=gen,
                      device="cuda")
    tables = {torch.float32: f32, torch.bfloat16: f32.to(torch.bfloat16)}
    # padded CSR by source: row s lists s's out-edges, padded with index 0
    # and weight 0 up to the largest out-degree
    deg = np.bincount(src, minlength=ARXIV_NODES)
    fanin = int(deg.max())
    pos = np.arange(ARXIV_EDGES) - np.concatenate(([0], np.cumsum(deg)))[src]
    bag_idx = np.zeros((ARXIV_NODES, fanin), np.int32)
    bag_w = np.zeros((ARXIV_NODES, fanin), np.float32)
    bag_idx[src, pos] = dst
    bag_w[src, pos] = np.random.default_rng(1).random(ARXIV_EDGES,
                                                      dtype=np.float32)
    # Listing 1's feature loads (trace.py gcn_aggregate, feat_dim 2):
    # 4 * (dst[i] * 2 + d) for d in 0, 1, in edge order
    feat = (4 * (dst[:, None] * 2 + np.arange(2))).reshape(-1)
    windows = [feat[w * 2 * WINDOW_EDGES:(w + 1) * 2 * WINDOW_EDGES]
               for w in range(N_WINDOWS)]
    return dict(streams=streams, tables=tables,
                bag_idx=torch.from_numpy(bag_idx).cuda(),
                bag_w=torch.from_numpy(bag_w).cuda(), fanin=fanin,
                windows=windows)


def bag_tolerance(table, idx, w) -> torch.Tensor:
    """Elementwise bound on |kernel - plain| for the bag.  Two orders of a
    K-term float32 sum of rounded products differ by at most
    K * 2**-23 * sum_k |w x| (each is within (K - 1) u + u of the exact
    sum, u = 2**-24).  A bfloat16 output adds one bfloat16 rounding of
    each sum: 2**-7 of its magnitude."""
    from repro_torch.kernels.gather_runahead import ref

    fanin = idx.shape[1]
    abs_sum = ref.gather_bag_ref(table.float().abs(), idx, w.float().abs())
    order = fanin * 2.0**-23 * abs_sum
    if table.dtype == torch.float32:
        return order
    exact = ref.gather_bag_ref(table.float(), idx, w)
    return order + 2.0**-7 * (exact.abs() + order)


def bit_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.view(torch.uint8), b.view(torch.uint8))


def phase_runahead(inp: dict, grid) -> dict:
    """The runahead path through its entry points, launch counters set to 0
    just before and read just after; every output is checked against the
    plain version (which launches no kernel).  Returns the launches and
    the measured errors."""
    from repro_torch.core.cgra import cache_grid
    from repro_torch.kernels.gather_runahead import gather_runahead as kernel
    from repro_torch.kernels.gather_runahead import ops, ref

    counters = {"runahead_gather": kernel.runahead_gather,
                "pipelined_gather": kernel.pipelined_gather,
                "gather_bag": kernel.gather_bag,
                "cache_grid_scan": cache_grid.cache_grid_scan}
    errs = dict.fromkeys(counters, 0.0)
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    kernel.runahead_gather.route_launches = dict.fromkeys(kernel.ROUTES, 0)
    for dtype, table in inp["tables"].items():
        name = str(dtype).split(".")[-1]
        for sname, idx in inp["streams"].items():
            want = ref.gather_ref(table, idx)
            runs = [("runahead_gather", "runahead", d) for d in GATHER_DEPTHS]
            for kname, impl, depth in runs + [("pipelined_gather",
                                               "pipelined", 2)]:
                out = ops.gather(table, idx, impl=impl, block_rows=BLOCK_ROWS,
                                 depth=depth)
                err = (out.float() - want.float()).abs().max().item()
                errs[kname] = max(errs[kname], err)
                if not bit_equal(out, want):
                    raise AssertionError(f"{impl} gather {name} {sname} "
                                         f"depth {depth}: not bit-identical "
                                         f"to table[idx] (max abs err {err})")
            print(f"phase 6: gather {name} {sname} n={idx.shape[0]}: "
                  f"runahead at depths {GATHER_DEPTHS} and pipelined "
                  f"bit-identical to table[idx]", flush=True)
        tol = bag_tolerance(table, inp["bag_idx"], inp["bag_w"])
        want = ref.gather_bag_ref(table, inp["bag_idx"], inp["bag_w"])
        ordered = ref.gather_bag_ordered_ref(table, inp["bag_idx"],
                                             inp["bag_w"])
        for depth in BAG_DEPTHS:
            out = ops.gather_bag(table, inp["bag_idx"], inp["bag_w"],
                                 depth=depth)
            diff = (out.float() - want.float()).abs()
            errs["gather_bag"] = max(errs["gather_bag"], diff.max().item())
            if not (torch.isfinite(out.float()).all() and out.shape
                    == want.shape and bool((diff <= tol).all())):
                raise AssertionError(f"gather_bag {name} depth {depth}: max "
                                     f"abs err {diff.max().item()}, worst "
                                     f"excess {(diff - tol).max().item()}")
            if not bit_equal(out, ordered):
                wrong = int((out.view(torch.uint8) != ordered.view(
                    torch.uint8)).sum().item())
                raise AssertionError(f"gather_bag {name} depth {depth}: "
                                     f"{wrong} bytes differ from the "
                                     f"kernel-order plain version")
        print(f"phase 6: gather_bag {name} S={table.shape[0]} "
              f"K={inp['fanin']} (largest out-degree) at depths "
              f"{BAG_DEPTHS}: max abs err {errs['gather_bag']:.3e} within "
              f"K * 2**-23 * sum|w x|"
              + ("" if dtype == torch.float32
                 else " + one bfloat16 rounding (2**-7 |sum|)")
              + "; bit-identical to the kernel-order plain version "
              "(rounded f32 products added in k order)", flush=True)
        del tol, want, ordered, out
    hits = [cache_grid.hit_series(a, grid) for a in inp["windows"]]
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    routes = dict(kernel.runahead_gather.route_launches)
    expect = {"runahead_gather": 2 * 2 * len(GATHER_DEPTHS),
              "pipelined_gather": 2 * 2, "gather_bag": 2 * len(BAG_DEPTHS),
              "cache_grid_scan": N_WINDOWS}
    if launches != expect:
        raise AssertionError(f"runahead path launches {launches} != {expect}")
    expect_routes = dict.fromkeys(kernel.ROUTES, 0)
    for table in inp["tables"].values():
        row = table.shape[1] * table.element_size()
        for depth in GATHER_DEPTHS:
            expect_routes[kernel.route(row, BLOCK_ROWS, depth)] += 2
    if routes != expect_routes:
        raise AssertionError(f"runahead gather routes {routes} != the route "
                             f"rule's {expect_routes}")
    print(f"phase 6: launches on the path: {json.dumps(launches)}; "
          f"runahead_gather by route {json.dumps(routes)}", flush=True)
    # both routes, whichever the rule takes, at every depth the path ran
    for dtype, table in inp["tables"].items():
        for sname, idx in inp["streams"].items():
            want = ref.gather_ref(table, idx)
            for depth in GATHER_DEPTHS:
                for use in kernel.ROUTES:
                    out = kernel.runahead_gather(table, idx,
                                                 block_rows=BLOCK_ROWS,
                                                 depth=depth, use=use)
                    if not bit_equal(out, want):
                        raise AssertionError(
                            f"runahead gather {dtype} {sname} depth {depth} "
                            f"route {use}: not bit-identical to table[idx]")
    print(f"phase 6: runahead_gather on routes {kernel.ROUTES} at depths "
          f"{GATHER_DEPTHS}, f32 and bf16, both streams: bit-identical to "
          f"table[idx]", flush=True)

    t_len, n_cfg = len(inp["windows"][0]), len(grid)
    misses = []
    for w, (a, h) in enumerate(zip(inp["windows"], hits)):
        m = (~h).sum(dim=1).cpu().numpy().reshape(33, -1)   # [ways, lines]
        misses.append(m)
        if h.shape != (n_cfg, t_len) or (m[0] != t_len).any() \
                or (np.diff(m, axis=0) > 0).any():
            raise AssertionError(f"window {w}: misses not monotone in ways "
                                 f"at fixed line, or ways 0 hits: {m}")
    # the plain loop on the card is ~130k launches: once, on window 0; the
    # last window is held against the plain loop on the host
    a = cache_grid.as_int32(inp["windows"][0], "cuda")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    want = cache_grid.hit_series_ref(a, grid)
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
    host = cache_grid.hit_series(inp["windows"][-1], grid, device="cpu")
    # the plain version in the kernels' order (one capped LRU stack per
    # (line, sets) group and set), on the host, for every window
    stack = [(w, cache_grid.hit_series_stack_ref(
        cache_grid.as_int32(a, "cpu"), grid))
        for w, a in enumerate(inp["windows"])]
    for w, other in [(0, want), (N_WINDOWS - 1, host)] + stack:
        wrong = int((hits[w].cpu() != other.cpu()).sum().item())
        errs["cache_grid_scan"] = max(errs["cache_grid_scan"], float(wrong))
        if wrong:
            raise AssertionError(f"cache_grid_scan window {w}: {wrong} of "
                                 f"{n_cfg * t_len} hits differ from the "
                                 f"plain version on {other.device}")
    groups = cache_grid.config_groups(grid)
    print(f"phase 6: cache grid {n_cfg} configurations x {t_len} accesses "
          f"x {N_WINDOWS} windows ({len(groups)} (line, sets) groups, "
          f"{groups.chains} (group, set) chains): misses monotone in ways at "
          f"every line size; kernel == plain exactly on window 0 (plain on "
          f"the card) and window {N_WINDOWS - 1} (plain on the host), and == "
          f"the stack version (kernel order, host) on all {N_WINDOWS} "
          f"windows; misses at 8 ways (lines 16, 32, 64, 128) per window "
          f"{[m[8].tolist() for m in misses]}", flush=True)
    return dict(launches=launches, errs=errs, grid_plain_ms=plain_ms,
                grid_misses=misses, routes=routes)


def mshr_sweep(table, idx, flush) -> dict:
    """The runahead gather at one block per SM, where the ring is the only
    source of rows in flight (SMs x depth x block_rows): the paper's
    runahead-vs-MSHR sweep (Fig. 14) on the card, on each route, by graph
    replay with eager events beside.  Outputs are checked, and each
    route's time must fall as the depth grows: no depth more than 2%
    (replay noise) above the one before, the deepest below the first."""
    from repro_torch.kernels.gather_runahead import gather_runahead as kernel

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    want = table[idx.long()]
    out = {}
    for use in kernel.ROUTES:
        graph, eager = {}, {}
        for depth in GATHER_DEPTHS:
            def run():
                return kernel.runahead_gather(table, idx,
                                              block_rows=BLOCK_ROWS,
                                              depth=depth, grid_blocks=sms,
                                              use=use)
            if not bit_equal(run(), want):
                raise AssertionError(f"runahead gather at {sms} blocks, "
                                     f"depth {depth}, route {use}: not "
                                     f"bit-identical to table[idx]")
            graph[depth] = round(graph_ms(run, flush), 4)
            eager[depth] = round(time_ms(run, flush), 4)
        ms = [graph[d] for d in GATHER_DEPTHS]
        if any(b > 1.02 * a for a, b in zip(ms, ms[1:])) or ms[-1] >= ms[0]:
            raise AssertionError(f"runahead gather at {sms} blocks, route "
                                 f"{use}: ms by depth {graph} does not fall "
                                 f"as the depth grows")
        out[use] = dict(graph=graph, eager=eager)
    return out


def bag_fetches(idx: np.ndarray) -> int:
    """Rows the bag kernel copies for idx [S, K] (host numpy): the distinct
    indices of each batch of 32 entries of each output row."""
    n = 0
    for k0 in range(0, idx.shape[1], 32):
        part = np.sort(idx[:, k0:k0 + 32], axis=1)
        n += part.shape[0] + int((part[:, 1:] != part[:, :-1]).sum())
    return n


def phase_runahead_times(inp: dict, grid, stats: dict,
                         flush: torch.Tensor) -> dict:
    """Kernel, plain and library times of the runahead path's kernels, with
    their bounds; returns the kernels-line entries."""
    from repro_torch.core.cgra import cache_grid
    from repro_torch.kernels.gather_runahead import gather_runahead as kernel
    from repro_torch.kernels.gather_runahead import ref

    card = card_line()
    entries = {}
    d = ARXIV_FEATURES
    for dtype, table in inp["tables"].items():
        name, elt = str(dtype).split(".")[-1], table.element_size()
        for sname, idx in inp["streams"].items():
            n = idx.shape[0]
            distinct = torch.unique(idx).numel()
            n_bytes = distinct * d * elt + n * 4 + n * d * elt
            bound = n_bytes / MEM_BYTES_PER_S * 1e3
            plain_ms = time_ms(lambda: ref.gather_ref(table, idx), flush)
            library_ms = graph_ms(lambda: torch.index_select(table, 0, idx),
                                  flush)
            library_eager = time_ms(
                lambda: torch.index_select(table, 0, idx), flush)
            # each route's ms by depth, by graph replay and eager events
            route_ms, route_eager = {}, {}
            for use in kernel.ROUTES:
                route_ms[use], route_eager[use] = {}, {}
                for depth in GATHER_DEPTHS:
                    def run():
                        return kernel.runahead_gather(
                            table, idx, block_rows=BLOCK_ROWS, depth=depth,
                            use=use)
                    route_ms[use][depth] = round(graph_ms(run, flush), 4)
                    route_eager[use][depth] = round(time_ms(run, flush), 4)
            row = d * elt
            rule = {depth: kernel.route(row, BLOCK_ROWS, depth)
                    for depth in GATHER_DEPTHS}
            pipe_ms = graph_ms(lambda: kernel.pipelined_gather(table, idx),
                               flush)
            pipe_eager = time_ms(lambda: kernel.pipelined_gather(table, idx),
                                 flush)
            if dtype == torch.float32:
                capped = mshr_sweep(table, idx, flush)
                print(f"phase 7: gather {name} {sname} at one block per SM "
                      f"({BLOCK_ROWS} rows a tile): runahead ms by route and "
                      f"depth (graph replay) "
                      f"{json.dumps({u: c['graph'] for u, c in capped.items()})}"
                      f" (eager "
                      f"{json.dumps({u: c['eager'] for u, c in capped.items()})}"
                      f"), falling with depth on both; {card}", flush=True)
            print(f"phase 7: gather {name} {sname} n={n} distinct rows "
                  f"{distinct}: runahead ms by route and depth (graph replay)"
                  f" {json.dumps(route_ms)} (eager {json.dumps(route_eager)});"
                  f" the route rule's by depth {json.dumps(rule)}; "
                  f"pipelined_ms={pipe_ms:.4f} (eager {pipe_eager:.4f}) "
                  f"plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
                  f"(index_select, graph replay; eager {library_eager:.4f}) "
                  f"bound_ms={bound:.4f} ({n_bytes} bytes) bytes-bound; "
                  f"{card}", flush=True)
            if dtype == torch.float32 and sname == "graph":
                common = dict(plain_ms=plain_ms, bound_ms=bound,
                              bound_by="bytes", library_ms=library_ms)
                entries["runahead_gather"] = dict(
                    ms=route_ms[rule[2]][2], eager_ms=route_eager[rule[2]][2],
                    kernel_route=rule[2],
                    route_ms={u: m[2] for u, m in route_ms.items()},
                    route_ms_by_depth=route_ms, mshr_sweep=capped, **common)
                entries["pipelined_gather"] = dict(
                    ms=pipe_ms, eager_ms=pipe_eager, **common)

        idx, w = inp["bag_idx"], inp["bag_w"]
        s, k = idx.shape
        distinct = torch.unique(idx).numel()
        n_bytes = distinct * d * elt + s * k * 4 * 2 + s * d * elt
        flops = 2 * s * k * d
        t_bytes = n_bytes / MEM_BYTES_PER_S * 1e3
        t_ops = flops / F32_FLOPS_PER_S * 1e3
        idx64, w_lib = idx.long(), w.to(dtype)
        plain_ms = time_ms(lambda: ref.gather_bag_ref(table, idx, w), flush)

        def library():
            return torch.nn.functional.embedding_bag(
                idx64, table, per_sample_weights=w_lib, mode="sum")

        library_ms, library_eager = graph_ms(library, flush), time_ms(
            library, flush)
        depth_ms, eager_ms = {}, {}
        for depth in BAG_DEPTHS:
            def bag():
                return kernel.gather_bag(table, idx, w, depth=depth)
            depth_ms[depth] = graph_ms(bag, flush)
            eager_ms[depth] = time_ms(bag, flush)
        warps = {depth: kernel.bag_warps_per_sm(table, k, depth)
                 for depth in BAG_DEPTHS}
        fetches = bag_fetches(inp["bag_idx"].cpu().numpy())
        print(f"phase 7: gather_bag {name} S={s} K={k} distinct rows "
              f"{distinct}: row fetches {fetches} (the padded bag's {s * k}: "
              f"{s * k / fetches:.2f}x fewer); warps per SM by depth "
              f"{json.dumps(warps)}; ms by depth "
              f"{json.dumps({k_: round(v, 4) for k_, v in depth_ms.items()})}"
              f" (graph replay, L2 cold; eager "
              f"{json.dumps({k_: round(v, 4) for k_, v in eager_ms.items()})})"
              f" plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
              f"(embedding_bag, sum, per-sample weights, graph replay; eager "
              f"{library_eager:.4f}) "
              f"bound_ms={max(t_bytes, t_ops):.4f} ({n_bytes} bytes, {flops} "
              f"flops) {'bytes' if t_bytes >= t_ops else 'operations'}-bound; "
              f"{card}", flush=True)
        if dtype == torch.float32:
            entries["gather_bag"] = dict(
                ms=depth_ms[2], plain_ms=plain_ms,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=library_ms)

    windows = [cache_grid.as_int32(w, "cuda") for w in inp["windows"]]
    a = windows[0]
    t_len, n_cfg = a.shape[0], len(grid)
    window_ms = [graph_ms(lambda: cache_grid.cache_grid_scan(w, grid), flush)
                 for w in windows]
    ms = window_ms[0]
    eager_ms = time_ms(lambda: cache_grid.cache_grid_scan(a, grid), flush)
    groups = cache_grid.config_groups(grid)
    chains = [cache_grid.longest_chain(w, grid) for w in inp["windows"]]
    # the same call on a one-address window (a chain of 1): what a call
    # costs besides its chain, so (ms - floor) / chain is a step's cost
    one = torch.full_like(a, 4096)
    floor_ms = graph_ms(lambda: cache_grid.cache_grid_scan(one, grid), flush)
    # each step compares the tag against n_ways ways, and on a miss the
    # stamps of n_ways ways; bytes: the addresses in, one byte per hit out
    ways = grid.ways.astype(np.int64)
    m0 = stats["grid_misses"][0].reshape(-1)
    ops_count = int((ways * (t_len + m0)).sum())
    n_bytes = t_len * 4 + n_cfg * t_len
    t_bytes = n_bytes / MEM_BYTES_PER_S * 1e3
    t_ops = ops_count / F32_FLOPS_PER_S * 1e3
    plain_ms = stats["grid_plain_ms"]
    print(f"phase 7: cache_grid_scan T={t_len} x C={n_cfg}: ms={ms:.4f} "
          f"(graph replay, window 0; eager {eager_ms:.4f}) ms by window "
          f"{[round(x, 4) for x in window_ms]} (graph replay) "
          f"plain_ms={plain_ms:.4f} (one run, phase 6) "
          f"bound_ms={max(t_bytes, t_ops):.6f} ({n_bytes} bytes, "
          f"{ops_count} compares) "
          f"{'bytes' if t_bytes >= t_ops else 'operations'}-bound; "
          f"{len(groups)} groups, {groups.chains} chains; longest chain by "
          f"window {chains} steps (non-repeat accesses of one (group, set) "
          f"stack; one configuration's scan was {t_len}); a one-address "
          f"window (chain 1) {floor_ms:.4f} ms (graph replay), so "
          f"{(ms - floor_ms) * 1e6 / chains[0]:.1f} ns a step of window 0's "
          f"chain; {card}", flush=True)
    entries["cache_grid_scan"] = dict(
        ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        library_ms=None)
    return entries


def flash_bound(elt: int, peak: float) -> tuple[float, str, int, int]:
    """(bound ms, what bounds it, flops, bytes) of the causal forward at
    the training shape: 4 D flops for each of the S (S + 1) / 2 visible
    (query, key) pairs (Q.K and P.V); q, k, v read once, y and the f32 lse
    written once."""
    b, h, s, d = TRAIN_B, 12, TRAIN_S, 128
    flops = 4 * b * h * d * s * (s + 1) // 2
    n_bytes = 4 * s * b * h * d * elt + 4 * b * h * s
    t_ops, t_bytes = flops / peak * 1e3, n_bytes / MEM_BYTES_PER_S * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes", flops, n_bytes)


def tiled_gate(y, q, k, v, causal, window, q_offset, what) -> str:
    """Hold a bf16 output elementwise to the plain version that rounds p
    where the kernel does (``ref.attention_tiled`` at the key tile of the
    kernel's route).  The two then differ
    only by float32 summation order, which can move the output's rounding
    by an ulp (2^-7 |y| at most) and the rounding of one p by an ulp (2^-7
    p_max |v|); the gate allows two of each, plus 1e-4.  On the long rows
    of the training shape, where |y| is about 0.03, that is about 1e-3, so
    an error in the later V tiles cannot hide under the 3e-2 abs gate."""
    from repro_torch.kernels.flash_attention import flash_attention as kernel
    from repro_torch.kernels.flash_attention import ref

    tile = ref.KEY_TILES[kernel.route(q.dtype, q.shape[-1])]
    want, _, p_max = ref.attention_tiled(q, k, v, causal=causal,
                                         window=window, q_offset=q_offset,
                                         key_tile=tile)
    want = want.float()
    tol = 2.0 ** -6 * (want.abs() + p_max[..., None]
                       * v.float().abs().max()) + 1e-4
    diff = (y.float() - want).abs()
    worst = (diff / tol).max().item()
    half = want.shape[2] // 2
    late = (f"rows {half}+: max err {diff[:, :, half:].max().item():.3e}, "
            f"mean tol {tol[:, :, half:].mean().item():.3e}")
    if not worst <= 1.0:
        raise AssertionError(f"flash_attention {what}: y differs from the "
                             f"kernel-order plain version by {worst:.3f} x "
                             f"its elementwise tolerance ({late})")
    return (f"; vs kernel-order plain version ({tile}-key tiles): worst "
            f"{worst:.3f} of the "
            f"elementwise tol 2^-6 (|y| + p_max max|v|) + 1e-4 ({late})")


def phase_flash(flush: torch.Tensor) -> dict:
    """The flash kernel against its plain version at the training shape
    and at the edges of its masks; grads of the blocked-attention
    Function; times and bounds.  Returns the kernels-line numbers."""
    from repro_torch.kernels.flash_attention import flash_attention as kernel
    from repro_torch.kernels.flash_attention import ops, ref
    from repro_torch.models import layers

    gen = torch.Generator(device="cuda").manual_seed(11)

    def qkv(b, h, hkv, sq, sk, d, dtype):
        return [torch.randn(b, n, s, d, generator=gen, device="cuda")
                .to(dtype) for n, s in ((h, sq), (hkv, sk), (hkv, sk))]

    cases = [  # (name, b, h, hkv, sq, sk, d, causal, window, q_offset)
        ("training shape", TRAIN_B, 12, 12, TRAIN_S, TRAIN_S, 128, True,
         None, 0),
        ("non-causal", 2, 12, 12, 1024, 1024, 128, False, None, 0),
        ("window 96", 2, 12, 12, 1024, 1024, 128, True, 96, 0),
        ("GQA 12/2", 2, 12, 2, 1024, 1024, 128, True, None, 0),
        ("query offset 700", 2, 12, 12, 324, 1024, 128, True, 96, 700),
        ("tail S 1000", 2, 12, 12, 1000, 1000, 128, True, None, 0),
        ("tail S 1000, D 72 (scalar route)", 2, 12, 12, 1000, 1000, 72,
         True, None, 0),
        # h2o-danube's width: two 64-column halves, the second zero-filled
        ("window 96, D 80", 2, 12, 12, 1024, 1024, 80, True, 96, 0),
        ("tail S 1000, D 80", 2, 12, 12, 1000, 1000, 80, True, None, 0),
        ("query offset 700, D 80", 2, 12, 12, 324, 1024, 80, True, 96, 700),
    ]
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        for cname, b, h, hkv, sq, sk, d, causal, window, off in cases:
            q, k, v = qkv(b, h, hkv, sq, sk, d, dtype)
            routes = dict(kernel.flash_attention.route_launches)
            y, lse = ops.attention(q, k, v, causal=causal, window=window,
                                   q_offset=off, return_lse=True)
            torch.cuda.synchronize()
            route = kernel.route(dtype, d)
            routes[route] += 1
            if kernel.flash_attention.route_launches != routes:
                raise AssertionError(
                    f"flash_attention {name} {cname}: launches by route "
                    f"{kernel.flash_attention.route_launches} != {routes}")
            ke = k.repeat_interleave(h // hkv, dim=1)
            ve = v.repeat_interleave(h // hkv, dim=1)
            want_y, want_lse = ref.attention_ref(q, ke, ve, causal=causal,
                                                 window=window, q_offset=off)
            err = (y.float() - want_y.float()).abs().max().item()
            lse_err = (lse - want_lse).abs().max().item()
            errs[(dtype, cname)] = err
            if not (torch.isfinite(y.float()).all() and err <= TOL[dtype]
                    and lse_err <= 1e-4):
                raise AssertionError(f"flash_attention {name} {cname}: y err "
                                     f"{err} (tol {TOL[dtype]}), lse err "
                                     f"{lse_err} (tol 1e-4)")
            del want_y, want_lse
            tiled = ""
            if dtype == torch.bfloat16:
                tiled = " " + tiled_gate(y, q, ke, ve, causal, window, off,
                                         f"{name} {cname}")
            print(f"phase 8: flash_attention {name} {cname} (B {b}, H "
                  f"{h}/{hkv}, Sq {sq}, Sk {sk}, D {d}, causal {causal}, "
                  f"window {window}, q_offset {off}; route "
                  f"{route}): y max abs err {err:.3e} "
                  f"(tol {TOL[dtype]}), lse {lse_err:.3e} (tol 1e-4)"
                  f"{tiled}", flush=True)
            del q, k, v, ke, ve, y, lse

    # grads: the Function (kernel forward, chunked f32 backward) against
    # autograd through the plain reference attention, f32 at S 2,048
    q, k, v = qkv(1, 12, 2, 2048, 2048, 128, torch.float32)
    grads = []
    for fn in (lambda *a: layers.reference_attention(*a, causal=True),
               lambda *a: layers.blocked_attention(*a, causal=True)):
        args = [t.detach().requires_grad_(True) for t in (q, k, v)]
        torch.sin(fn(*args)).sum().backward()
        grads.append([a.grad for a in args])
    grad_err = max((a - b).abs().max().item() for a, b in zip(*grads))
    if grad_err > 2e-4:
        raise AssertionError(f"blocked_attention grads differ from autograd "
                             f"through reference_attention by {grad_err}")
    print(f"phase 8: blocked_attention grads of sum(sin(y)), f32, B 1, H "
          f"12/2, S 2048, q_chunk 512, k_chunk 1024: max abs err "
          f"{grad_err:.3e} against autograd through reference_attention "
          f"(tol 2e-4)", flush=True)
    del q, k, v, grads, args

    card = card_line()
    out = {}
    for dtype, peak in ((torch.bfloat16, BF16_FLOPS_PER_S),
                        (torch.float32, F32_FLOPS_PER_S)):
        name = str(dtype).split(".")[-1]
        q, k, v = qkv(TRAIN_B, 12, 12, TRAIN_S, TRAIN_S, 128, dtype)
        ms = time_ms(lambda: kernel.flash_attention(q, k, v, causal=True),
                     flush)
        plain_ms = time_ms(lambda: ref.attention_ref(q, k, v, causal=True),
                           flush)
        library_ms = time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=True), flush)
        bound, by, flops, n_bytes = flash_bound(q.element_size(), peak)
        print(f"phase 8: flash_attention {name} at the training shape: "
              f"ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms="
              f"{library_ms:.4f} (SDPA, is_causal) bound_ms={bound:.4f} "
              f"({flops} flops at {peak / 1e12:.0f} TFLOP/s, {n_bytes} "
              f"bytes) {by}-bound: {flops / ms / 1e9:.1f} TFLOP/s = "
              f"{bound / ms:.1%} of the bound; {card}", flush=True)
        out[dtype] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                          bound_by=by, library_ms=library_ms)
        del q, k, v
    return dict(max_abs_err=errs[(torch.bfloat16, "training shape")],
                **out[torch.bfloat16])


class _TimedKernel:
    """Stands in for the flash kernel module inside ``ops``: the same
    launch, bracketed by CUDA events."""

    def __init__(self, module):
        self.module, self.events = module, []

    def flash_attention(self, *args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = self.module.flash_attention(*args, **kwargs)
        end.record()
        self.events.append((start, end))
        return out


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and torch.equal(
        a.detach().reshape(-1).view(torch.uint8),
        b.detach().reshape(-1).view(torch.uint8))


def state_leaves(state: dict) -> list:
    return ([p for _, p in state["params"].named_parameters()]
            + list(state["m"].values()) + list(state["v"].values())
            + [state["step"]])


def phase_train(cfg) -> int:
    """Full-width training through train_lm's pieces; returns the flash
    launches of the 8-step run."""
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.kernels.flash_attention import flash_attention as kernel
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.launch import steps, train_lm
    from repro_torch.models import api, lm
    from repro_torch.models.types import ShapeConfig
    from repro_torch.runtime.fault_tolerance import StragglerWatchdog

    shape = ShapeConfig("train_4k", "train", TRAIN_S, TRAIN_B)
    opt = steps.make_optimizer(cfg)
    t0 = time.monotonic()
    state = train_lm.init_state(cfg, opt, "cuda", seed=0)
    torch.cuda.synchronize()
    print(f"phase 9: {cfg.name} at full width ({cfg.n_layers} layers, d "
          f"{cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.dtype}, attn_impl "
          f"{cfg.attn_impl}): {lm.param_count(state['params'])} random "
          f"parameters (seed 0) and AdamW moments ({opt.moment_dtype}) in "
          f"{time.monotonic() - t0:.2f} s; batch {TRAIN_B} x {TRAIN_S}",
          flush=True)
    # step 0's loss through the plain attention, on the same weights and
    # batch, before any update: what the kernel path's step 0 must give
    with torch.no_grad():
        plain0 = lm.lm_loss(state["params"], api.batch_to(synthetic_batch(
            cfg, shape, seed=0, step=0), "cuda"), cfg,
            attn_impl="reference").item()
    ckpt_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_"))
    loader = train_lm.make_loader(cfg, shape, "cuda", seed=0, depth=2)
    driver = train_lm.make_driver(cfg, opt, loader, ckpt_dir, "cuda",
                                  checkpoint_every=CKPT_EVERY,
                                  watchdog=StragglerWatchdog())
    step_ms, inner = [], driver.step_fn

    def timed_step(state, batch):
        torch.cuda.synchronize()
        s0 = time.perf_counter()
        out = inner(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - s0) * 1e3)
        return out

    driver.step_fn = timed_step
    try:
        torch.cuda.reset_peak_memory_stats()
        kernel.flash_attention.launches = 0
        state, hist = driver.run(state, CKPT_EVERY)
        torch.cuda.synchronize()
        # the peak of training alone: the restore check below holds a
        # second full state, so the peak is read before it and again after
        peak = torch.cuda.max_memory_allocated()
        # the checkpoint of step 4, restored, is the state that was saved
        t0 = time.monotonic()
        target = train_lm.init_state(cfg, opt, "cuda", seed=1)
        restored = driver.checkpointer.restore(CKPT_EVERY, target)
        same = all(bits_equal(a, b) for a, b in
                   zip(state_leaves(state), state_leaves(restored)))
        n_leaves = len(state_leaves(state))
        del target, restored
        torch.cuda.reset_peak_memory_stats()
        if not same:
            raise AssertionError("the restored step-4 checkpoint differs "
                                 "from the state that was saved")
        size = sum(f.stat().st_size for f in ckpt_dir.rglob("*")
                   if f.is_file())
        print(f"phase 9: checkpoint of step {CKPT_EVERY} ({size} bytes, "
              f"{n_leaves} leaves) restored bit for bit equal to the "
              f"saved state in {time.monotonic() - t0:.2f} s", flush=True)
        state, hist_b = driver.run(state, TRAIN_STEPS, start_step=CKPT_EVERY)
        torch.cuda.synchronize()
        launches = kernel.flash_attention.launches
        peak = max(peak, torch.cuda.max_memory_allocated())
        hist += hist_b

        # the flash kernel's share of a step, by CUDA events around each
        # launch (two more steps, outside the counted run)
        timed = _TimedKernel(flash_ops.kernel)
        flash_ops.kernel = timed
        try:
            share_ms = []
            for step in (TRAIN_STEPS, TRAIN_STEPS + 1):
                timed.events.clear()
                state, _ = driver.step_fn(state, loader.get(step))
                share_ms.append(sum(s.elapsed_time(e)
                                    for s, e in timed.events))
        finally:
            flash_ops.kernel = timed.module
        share_steps = step_ms[-2:]
        del step_ms[-2:]

        # six steps on one repeated batch at full lr must lower its loss
        opt1 = dataclasses.replace(opt, warmup_steps=1)
        batch = synthetic_batch(cfg, shape, seed=0, step=0)
        repeat = []
        for _ in range(REPEAT_STEPS):
            state, m = steps.train_step(state, batch, cfg, opt1,
                                        device="cuda")
            repeat.append(m["loss"].item())
    finally:
        loader.close()
        driver.checkpointer.wait()
        shutil.rmtree(ckpt_dir, ignore_errors=True)

    losses = [h["loss"] for h in hist]
    norms = [h["grad_norm"] for h in hist]
    expect = TRAIN_STEPS * cfg.n_layers * 2 * max(1, cfg.accum_steps)
    if not all(math.isfinite(x) for x in losses + norms + repeat):
        raise AssertionError(f"non-finite losses {losses} or grad norms "
                             f"{norms} or repeat losses {repeat}")
    # bf16 attention rounds at other points in the two paths (p before or
    # after normalisation); averaged over 16,384 tokens that is ~1e-3
    if abs(losses[0] - plain0) > 2e-2:
        raise AssertionError(f"step 0 loss {losses[0]} is not within 2e-2 "
                             f"of the plain-attention loss {plain0}")
    # random weights predict near-uniformly: the tied head's logits have
    # variance 0.02^2 d after the unit-RMS final norm
    if abs(losses[0] - math.log(cfg.vocab_size)) > 0.5:
        raise AssertionError(f"step 0 loss {losses[0]} is not within 0.5 "
                             f"of ln V = {math.log(cfg.vocab_size)}")
    if launches != expect:
        raise AssertionError(f"flash_attention launched {launches} times in "
                             f"{TRAIN_STEPS} steps; want {expect}")
    if not repeat[-1] < repeat[0]:
        raise AssertionError(f"repeated-batch losses did not fall: {repeat}")
    tokens = TRAIN_B * TRAIN_S
    steady = step_ms[1:]                  # step 0 pays one-time set-up
    mean_ms = statistics.mean(steady)
    share = [f / s for f, s in zip(share_ms, share_steps)]
    print(f"phase 9: {TRAIN_STEPS} steps, losses "
          f"{[round(x, 4) for x in losses]} (step 0 through the plain "
          f"attention: {plain0:.4f}, tol 2e-2; ln V = "
          f"{math.log(cfg.vocab_size):.4f}, tol 0.5), grad norms "
          f"{[round(x, 4) for x in norms]}", flush=True)
    print(f"phase 9: step ms {[round(x, 1) for x in step_ms]}; steps 1-"
          f"{TRAIN_STEPS - 1}: mean {mean_ms:.1f}, min {min(steady):.1f}, "
          f"max {max(steady):.1f}, stdev {statistics.stdev(steady):.1f}; "
          f"{tokens / mean_ms * 1e3:.1f} tokens/s; peak memory "
          f"{peak / 2**30:.3f} GiB (training steps; the restore check "
          f"excluded); flash_attention launches {launches} = "
          f"{TRAIN_STEPS} steps x {cfg.n_layers} layers x 2 (forward + "
          f"recompute); flash kernel {share_ms[0]:.1f} / {share_ms[1]:.1f} "
          f"ms of steps of {share_steps[0]:.1f} / {share_steps[1]:.1f} ms "
          f"= {share[0]:.1%} / {share[1]:.1%} of the step; {card_line()}",
          flush=True)
    print(f"phase 9: {REPEAT_STEPS} steps on one repeated batch, warmup 1: "
          f"losses {[round(x, 4) for x in repeat]}", flush=True)
    return launches


def moe_slots(t: int, group: int, d: int, gen) -> tuple:
    """Slots of T tokens in groups of ``group`` under dbrx's own routing
    (16 experts, top 4, capacity factor 1.25) with a random N(0, 0.02)
    router over N(0, 1) tokens: (slot [T, 4] int32, n_slots, drop share)."""
    from types import SimpleNamespace

    from repro_torch.configs import registry
    from repro_torch.models import moe

    cfg = dataclasses.replace(registry.get("dbrx-132b"),
                              moe_group_size=group)
    router = torch.randn(d, cfg.n_experts, generator=gen, device="cuda") \
        * 0.02
    x = torch.randn(t // group, group, d, generator=gen, device="cuda")
    _, _, _, slot = moe._route(SimpleNamespace(router=router), x, cfg)
    n_slots = cfg.n_experts * (t // group) * moe.moe_capacity(cfg, group)
    drop = (slot < 0).float().mean().item()
    return slot, n_slots, drop


def phase_moe_kernels(flush: torch.Tensor) -> dict:
    """Dispatch and combine against their plain versions at the dbrx
    serving shapes (decode: 8 tokens; prefill chunk: 64 tokens) and a
    grouped shape (4 groups of 1,024 tokens), slots from the router's own
    top-4 routing at capacity factor 1.25; times (graph replay, eager
    beside) against the bound and one PyTorch call each.  Returns the kernels-line numbers (decode
    shape, bf16)."""
    from repro_torch.kernels.moe_dispatch import moe_dispatch as kernel
    from repro_torch.kernels.moe_dispatch import ref

    d, k = 6144, 4
    gen = torch.Generator(device="cuda").manual_seed(21)
    card = card_line()
    one = flush[:1]
    print(f"phase 10: graph-replay floor: a one-element fill kernel "
          f"{graph_ms(lambda: one.fill_(1), flush):.4f} ms; {card}",
          flush=True)
    out = {}
    for sname, t, group in (("decode", 8, 8), ("prefill chunk", 64, 64),
                            ("grouped", 4096, 1024)):
        slot, n_slots, drop = moe_slots(t, group, d, gen)
        kept = slot >= 0
        n_kept = int(kept.sum().item())
        n_tok_kept = int(kept.any(1).sum().item())   # tokens dispatch reads
        w = torch.rand(t, k, generator=gen, device="cuda")
        tok = torch.arange(t, device="cuda")[:, None].expand(t, k)[kept]
        dest = slot[kept].long()
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[-1]
            x = torch.randn(t, d, generator=gen, device="cuda").to(dtype)
            xe = kernel.dispatch(x, slot, n_slots)
            torch.cuda.synchronize()
            if not bit_equal(xe, ref.dispatch_ref(x, slot, n_slots)):
                raise AssertionError(f"moe dispatch {name} {sname}: not "
                                     f"bit-identical to the plain version")
            ye = torch.randn(n_slots, d, generator=gen,
                             device="cuda").to(dtype)
            y = kernel.combine(ye, slot, w)
            torch.cuda.synchronize()
            want = ref.combine_ref(ye, slot, w).float()
            # both round each product, then each sum, in k order: f32 within
            # K 2^-23 sum|w x|, plus one bf16 rounding (2^-8 |y|) in bf16
            tol = k * 2.0**-23 * ref.combine_ref(ye.float().abs(), slot,
                                                 w).float()
            if dtype == torch.bfloat16:
                tol = tol + 2.0**-8 * want.abs()
            diff = (y.float() - want).abs()
            err = diff.max().item()
            if not (torch.isfinite(y.float()).all()
                    and bool((diff <= tol).all())):
                raise AssertionError(f"moe combine {name} {sname}: max abs "
                                     f"err {err}, worst excess "
                                     f"{(diff - tol).max().item()}")
            elt = x.element_size()
            row = d * elt
            src = x[tok]                          # library call's operand
            lib_out = torch.zeros(n_slots, d, dtype=dtype, device="cuda")
            ye_pad = torch.cat([ye, torch.zeros(1, d, dtype=dtype,
                                                device="cuda")])
            bag_idx = torch.where(kept, slot, n_slots).long()
            w_lib = w.to(dtype)
            parts = kernel.combine_parts(t, d * x.element_size())
            kern = {"dispatch": lambda: kernel.dispatch(x, slot, n_slots),
                    "combine": lambda: kernel.combine(ye, slot, w)}
            lib = {"dispatch": lambda: lib_out.index_copy_(0, dest, src),
                   "combine": lambda: torch.nn.functional.embedding_bag(
                       bag_idx, ye_pad, per_sample_weights=w_lib,
                       mode="sum")}
            plain = {"dispatch": lambda: ref.dispatch_ref(x, slot, n_slots),
                     "combine": lambda: ref.combine_ref(ye, slot, w)}
            # each token read once, however many of its choices are kept;
            # its slots; every output row written once
            work = {"dispatch": (n_tok_kept * row + t * k * 4
                                 + n_slots * row, 0),
                    "combine": (n_kept * row + t * k * 8 + t * row,
                                2 * n_kept * d)}
            for kname, (n_bytes, flops) in work.items():
                # device time from graph replays (a call of ~10 us timed by
                # eager events times the Python wrapper); eager beside it
                ms = graph_ms(kern[kname], flush)
                eager_ms = time_ms(kern[kname], flush)
                lib_ms = graph_ms(lib[kname], flush)
                lib_eager_ms = time_ms(lib[kname], flush)
                plain_ms = time_ms(plain[kname], flush)
                t_bytes = n_bytes / MEM_BYTES_PER_S * 1e3
                t_ops = flops / F32_FLOPS_PER_S * 1e3
                bound = max(t_bytes, t_ops)
                by = "bytes" if t_bytes >= t_ops else "operations"
                lib_name = ("index_copy_ of the pre-gathered kept rows"
                            if kname == "dispatch" else
                            "embedding_bag, sum, per-sample weights, drops "
                            "on a zero row")
                print(f"phase 10: moe {kname} {name} {sname} (T {t}, K {k}, "
                      f"D {d}, group {group}, {n_slots} slots, {n_kept} "
                      f"kept, drop share {drop:.4f}): max abs err "
                      f"{0.0 if kname == 'dispatch' else err:.3e} "
                      f"({'bit-identical' if kname == 'dispatch' else 'within one bf16 rounding' if dtype == torch.bfloat16 else 'within K 2^-23 sum|w x|'}) "
                      f"ms={ms:.4f} (graph replay; eager {eager_ms:.4f}) "
                      f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
                      f"(graph replay; eager {lib_eager_ms:.4f}; {lib_name})"
                      f" bound_ms={bound:.6f} ({n_bytes} bytes, {flops} "
                      f"flops) {by}-bound: {bound / ms:.1%} of the bound; "
                      f"kernel / library {ms / lib_ms:.3f}"
                      + (f"; {parts} parts a row ({t * parts} blocks)"
                         if kname == "combine" else "") + f"; {card}",
                      flush=True)
                if sname == "decode" and dtype == torch.bfloat16:
                    out[f"moe_{kname}"] = dict(
                        max_abs_err=0.0 if kname == "dispatch" else err,
                        ms=ms, plain_ms=plain_ms, bound_ms=bound,
                        bound_by=by, library_ms=lib_ms)
            del x, xe, ye, y, want, tol, diff, src, lib_out, ye_pad
    return out


class _PlainMoE:
    """Stands in for the MoE kernel module inside ``ops``: the plain
    versions, on the same tensors."""

    @staticmethod
    def dispatch(x, slot, n_slots):
        from repro_torch.kernels.moe_dispatch import ref
        return ref.dispatch_ref(x, slot, n_slots)

    @staticmethod
    def combine(ye, slot, weights):
        from repro_torch.kernels.moe_dispatch import ref
        return ref.combine_ref(ye, slot, weights)


def serve_logits(cfg, params) -> tuple:
    """Logits of 8 prefill chunks of 64 tokens (one a slot) and then one
    decode step of all 8 slots, on a fresh paged cache through the kernel
    read, under the MoE kernels and then under their plain versions:
    ((kernel chunk, kernel decode), (plain chunk, plain decode))."""
    from repro_torch.kernels.moe_dispatch import ops as moe_ops
    from repro_torch.models import api

    rng = np.random.default_rng(2)
    chunks = rng.integers(0, cfg.vocab_size, (8, 64))
    runs = []
    for module in (None, _PlainMoE()):
        kernel = moe_ops.kernel
        if module is not None:
            moe_ops.kernel = module
        try:
            cache = api.init_serve_cache(cfg, slots=8, max_len=128,
                                         device="cuda")
            # each slot its own pages (the engine's pool assigns them; a
            # zero table would send every write to the null page)
            pps = cache["page_table"].shape[1]
            cache["page_table"].copy_(torch.arange(
                1, 1 + 8 * pps, dtype=torch.int32).reshape(8, pps))
            keys = np.zeros((8, 2), np.uint32)
            for slot in range(8):
                _, chunk_logits, _ = api.serve_prefill(
                    params, chunks[slot], 64, slot, 0.0, keys[0], cache, cfg,
                    sampling=False, return_logits=True)
            _, dec_logits, _ = api.serve_decode(
                params, chunks[:, -1], np.ones(8, bool), np.zeros(8),
                keys, cache, cfg, attn_read="kernel", sampling=False,
                return_logits=True)
            torch.cuda.synchronize()
            runs.append((chunk_logits.float(), dec_logits.float()))
        finally:
            moe_ops.kernel = kernel
    return runs


def phase_moe_logits(cfg, params, phase: str = "11") -> str:
    """Kernel vs plain MoE path at one prefill chunk and one decode step:
    bf16 at the served depth (reported), float32 at 2 layers (gated at
    1e-4 of the logit std)."""
    (kc, kd), (pc, pd) = serve_logits(cfg, params)
    bf16 = max((kc - pc).abs().max().item(), (kd - pd).abs().max().item())
    std = kd.std().item()
    print(f"phase {phase}: {cfg.name} bfloat16 {cfg.n_layers} layers, MoE "
          f"kernels vs plain versions: max abs logit diff {bf16:.3e} over "
          f"one 64-token prefill chunk and one 8-slot decode step (logit std "
          f"{std:.4f})", flush=True)
    return f"{bf16:.3e}"


def phase_moe_logits_f32(cfg, phase: str = "11") -> None:
    cfg2 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    params = api_init(cfg2)
    (kc, kd), (pc, pd) = serve_logits(cfg2, params)
    del params
    std = kd.std().item()
    err = max((kc - pc).abs().max().item(), (kd - pd).abs().max().item())
    if not (math.isfinite(err) and err <= 1e-4 * std):
        raise AssertionError(f"float32 MoE kernel vs plain logits differ by "
                             f"{err} (> 1e-4 x logit std {std})")
    print(f"phase {phase}: {cfg.name} float32 2 layers, MoE kernels vs "
          f"plain versions: max abs logit diff {err:.3e} (tol 1e-4 x logit "
          f"std {std:.4f} = {1e-4 * std:.3e})", flush=True)


def ssd_inputs(b, s, h, p, n, gen) -> list:
    """mamba2's scan operands: x, B, C ~ N(0, 1) in bf16; dt =
    softplus(N(0, 0.25)) ~ 0.7 as the model's zero-init bias gives; A_log 0
    (A = -1, its init); D ~ N(0, 1)."""
    f = lambda *shape: torch.randn(*shape, generator=gen, device="cuda")
    dt = torch.nn.functional.softplus(0.5 * f(b, s, h))
    return [f(b, s, h, p).to(torch.bfloat16), dt,
            torch.zeros(h, device="cuda"), f(b, s, n).to(torch.bfloat16),
            f(b, s, n).to(torch.bfloat16), f(h)]


def ssd_bound(b, s, h, p, n) -> dict:
    """The least time of the scan at bf16 x/B/C in and f32 y out: flops of
    the chunked form at the kernels' 64-row chunks (per batch row and chunk
    C.B^T over the causal half, shared by the heads; per head the causal
    half of att.x and the inter-chunk and state products, 2 Q N P flops
    each); bytes of x, B, C (bf16), dt (f32), A_log and D read once and y
    (f32) written once.  The bound is the larger of bytes at 3.35 TB/s and
    flops at the tensor cores' 989 TFLOP/s (bf16); ``simt_ops_ms`` is the
    flops at the CUDA cores' f32 67 TFLOP/s, the scalar route's floor."""
    q = 64
    nc = -(-s // q)
    pairs = q * (q + 1) // 2
    flops = b * nc * (2 * pairs * n + h * (2 * pairs * p + 4 * q * n * p))
    n_bytes = (b * s * h * p * 2 + 2 * b * s * n * 2 + b * s * h * 4
               + 2 * h * 4 + b * s * h * p * 4)
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    t_bytes = n_bytes / MEM_BYTES_PER_S * 1e3
    return dict(bound=max(t_ops, t_bytes),
                by="operations" if t_ops >= t_bytes else "bytes",
                flops=flops, n_bytes=n_bytes, ops_ms=t_ops,
                simt_ops_ms=flops / F32_FLOPS_PER_S * 1e3)


def ssd_gate(y, want) -> float:
    """Worst |y - want| / (1e-4 |want| + 1e-5 max|want|), elementwise."""
    tol = 1e-4 * want.abs() + 1e-5 * want.abs().max()
    return ((y.float() - want).abs() / tol).max().item()


def phase_ssd_kernel(flush: torch.Tensor) -> dict:
    """The SSD kernel's mma route (bf16 tensor cores) against its plain
    versions at mamba2's head shape and a small one, and elementwise
    against the plain version in its own order (``ssd_chunked_split``);
    both routes timed against the bound in one run.  Returns the
    kernels-line numbers (the mma route's)."""
    from repro_torch.kernels.ssd_scan import ref
    from repro_torch.kernels.ssd_scan import ssd_scan as kernel

    gen = torch.Generator(device="cuda").manual_seed(31)
    small = ssd_inputs(1, 256, 4, 64, 128, gen)
    if kernel.route(small[0].dtype, 64, 128) != "mma":
        raise AssertionError("ssd_scan: mamba2's head does not take the mma "
                             "route")
    y = kernel.ssd_scan(*small, out_dtype=torch.float32)
    naive, _ = ref.ssd_ref(*small)
    worst_small = ssd_gate(y, naive)
    if not worst_small <= 1.0:
        raise AssertionError(f"ssd_scan vs the per-token recurrence: "
                             f"{worst_small:.3f} x the elementwise tol")
    b, s, h, p, n = 4, 4096, 80, 64, 128
    args = ssd_inputs(b, s, h, p, n, gen)
    y = kernel.ssd_scan(*args, out_dtype=torch.float32)
    torch.cuda.synchronize()
    want = ref.ssd_chunked_ref(*args, chunk=256)
    worst = ssd_gate(y, want)
    err = (y - want).abs().max().item()
    max_y = want.abs().max().item()
    del want
    split = ssd_gate(y, ref.ssd_chunked_split(*args, pieces=2))
    y_simt = kernel.ssd_scan(*args, out_dtype=torch.float32, use="simt")
    simt_vs_mma = ssd_gate(y, y_simt)
    del y_simt
    if not (torch.isfinite(y).all() and worst <= 1.0 and split <= 1.0):
        raise AssertionError(f"ssd_scan at B {b} x S {s} x H {h} x P {p} x N "
                             f"{n}: {worst:.3f} x the elementwise tol 1e-4 "
                             f"|want| + 1e-5 max|want| of the chunked form, "
                             f"{split:.3f} x of the split form (max abs err "
                             f"{err})")
    print(f"phase 12: ssd_scan mma route (bf16 in, f32 y) at B {b} x S {s} x"
          f" H {h} x P {p} x N {n} against the plain chunked form at chunk "
          f"256: max abs err {err:.3e} (max|y| {max_y:.3f}), worst "
          f"{worst:.3f} of the elementwise tol 1e-4 |want| + 1e-5 max|want|;"
          f" against the split-bf16 plain version in the kernel's order: "
          f"worst {split:.3f}; at B 1 x S 256 x H 4 against the per-token "
          f"recurrence: worst {worst_small:.3f}; the simt route differs from"
          f" it by {simt_vs_mma:.3f} of the tol (reported)", flush=True)
    del naive, small
    bound = ssd_bound(b, s, h, p, n)
    times = {}
    for use in ("mma", "simt"):
        call = lambda: kernel.ssd_scan(*args, out_dtype=torch.float32,
                                       use=use)
        times[use] = (graph_ms(call, flush, iters=20),
                      time_ms(call, flush, iters=20))
    plain_ms = time_ms(lambda: ref.ssd_chunked_ref(*args, chunk=64), flush,
                       iters=10)
    ms = times["mma"][0]
    for use, (g_ms, e_ms) in times.items():
        floor = bound["bound"] if use == "mma" else bound["simt_ops_ms"]
        print(f"phase 12: ssd_scan route {use}: ms={g_ms:.4f} (graph replay, "
              f"median of 20; eager {e_ms:.4f}); {bound['flops']} flops = "
              f"{bound['flops'] / g_ms / 1e9:.1f} TFLOP/s; "
              f"{bound['n_bytes'] / g_ms / 1e6:.1f} GB/s; "
              f"{floor / g_ms:.1%} of its floor {floor:.4f} ms "
              f"({'the bound' if use == 'mma' else 'f32 CUDA-core operations at 67 TFLOP/s'})",
              flush=True)
    print(f"phase 12: ssd_scan bound_ms={bound['bound']:.4f} "
          f"{bound['by']}-bound ({bound['n_bytes']} bytes at 3.35 TB/s; "
          f"{bound['flops']} flops take {bound['ops_ms']:.4f} ms at 989 "
          f"TFLOP/s bf16, {bound['simt_ops_ms']:.4f} ms at 67 TFLOP/s f32); "
          f"plain_ms={plain_ms:.4f} (the chunked form at the kernel's 64-row "
          f"chunks, median of 10) library_ms=none; mma {ms:.4f} ms vs simt "
          f"{times['simt'][0]:.4f} ms: {times['simt'][0] / ms:.2f}x; "
          f"{card_line()}", flush=True)
    if not ms < times["simt"][0]:
        raise AssertionError(f"ssd_scan: the mma route ({ms:.4f} ms) is not "
                             f"faster than the simt route "
                             f"({times['simt'][0]:.4f} ms)")
    return dict(kernel_route="mma", max_abs_err=err, ms=ms,
                eager_ms=times["mma"][1], simt_ms=times["simt"][0],
                plain_ms=plain_ms, bound_ms=bound["bound"],
                bound_by=bound["by"], library_ms=None)


def phase_mamba(cfg) -> int:
    """Full-width, full-depth mamba2-2.7b: prefill at B 4 x S 4,096 (the
    SSD launch counter set to 0 just before and read just after), then the
    lockstep decode loop: 32 greedy steps of 8 sequences.  Returns the
    prefill's ssd_scan launches."""
    from repro_torch.kernels.ssd_scan import ssd_scan as kernel
    from repro_torch.models import api

    t0 = time.monotonic()
    params = api_init(cfg)
    torch.cuda.synchronize()
    print(f"phase 13: {cfg.name} at full width and depth ({cfg.n_layers} "
          f"layers, d {cfg.d_model}, d_inner {cfg.d_inner}, {cfg.ssm_heads} "
          f"heads of {cfg.ssm_d_head}, N {cfg.ssm_state}, chunk "
          f"{cfg.ssm_chunk}, vocab {cfg.vocab_size}, {cfg.dtype}): "
          f"{sum(p.numel() for p in params.parameters())} random parameters "
          f"drawn in {time.monotonic() - t0:.2f} s", flush=True)
    b, s = 4, 4096
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (b, s))
    batch = {"tokens": tokens}
    with torch.no_grad():
        api.prefill(params, batch, cfg, device="cuda")     # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernel.ssd_scan.launches = 0
        kernel.ssd_scan.route_launches.update(simt=0, mma=0)
        t0 = time.perf_counter()
        logits = api.prefill(params, batch, cfg, device="cuda")
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        launches = kernel.ssd_scan.launches
        by_route = dict(kernel.ssd_scan.route_launches)
        peak = torch.cuda.max_memory_allocated()
        again = []
        for _ in range(2):
            t0 = time.perf_counter()
            api.prefill(params, batch, cfg, device="cuda")
            torch.cuda.synchronize()
            again.append((time.perf_counter() - t0) * 1e3)
    if launches != cfg.n_layers or by_route["mma"] != cfg.n_layers:
        raise AssertionError(f"ssd_scan launched {launches} times "
                             f"({by_route}) in one prefill of "
                             f"{cfg.n_layers} layers; want all on the mma "
                             f"route")
    if not (torch.isfinite(logits).all()
            and logits.shape == (b, cfg.vocab_size)):
        raise AssertionError(f"prefill logits {tuple(logits.shape)}, finite "
                             f"{bool(torch.isfinite(logits).all())}")
    ms = [prefill_ms] + again
    print(f"phase 13: prefill B {b} x S {s}: ms {[round(x, 1) for x in ms]} "
          f"(median {statistics.median(ms):.1f}) = "
          f"{b * s / statistics.median(ms) * 1e3:.1f} tokens/s; ssd_scan "
          f"launches {launches} = {cfg.n_layers} layers, by route "
          f"{by_route}; logits finite, "
          f"std {logits.std().item():.4f}; peak memory "
          f"{peak / 2**30:.3f} GiB; {card_line()}", flush=True)

    cache = api.init_cache(cfg, 8, 256)
    tok = torch.as_tensor(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (8, 1)), dtype=torch.int32, device="cuda")
    step_ms, seq = [], [tok]
    for _ in range(32):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lo, cache = api.decode(params, tok, cache, cfg)
        tok = lo.argmax(-1).to(torch.int32)[:, None]
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        seq.append(tok)
    if cache["pos"] != 32 or not torch.isfinite(lo).all():
        raise AssertionError(f"lockstep decode: position {cache['pos']}, "
                             f"finite {bool(torch.isfinite(lo).all())}")
    steady = step_ms[1:]
    print(f"phase 13: lockstep decode (api.init_cache(cfg, 8, 256), 32 "
          f"greedy api.decode steps): ms per token mean "
          f"{statistics.mean(steady):.2f} (steps 1-31; min {min(steady):.2f},"
          f" max {max(steady):.2f}; step 0 {step_ms[0]:.2f}); position "
          f"{cache['pos']}; first sequence "
          f"{torch.cat(seq, 1)[0, :12].tolist()}", flush=True)
    gap, std = prefill_vs_decode(cfg, params, 512)
    print(f"phase 13: bfloat16 {cfg.n_layers} layers, prefill vs 512 decode "
          f"steps: last-position max abs logit diff {gap:.3e} (logit std "
          f"{std:.4f}), reported without a bound", flush=True)
    del params, cache
    cfg4 = dataclasses.replace(cfg, n_layers=4, dtype="float32")
    params4 = api_init(cfg4)
    gap, std = prefill_vs_decode(cfg4, params4, 512)
    del params4
    if not (math.isfinite(gap) and gap <= 1e-3 * std):
        raise AssertionError(f"float32 prefill vs decode: last logits differ "
                             f"by {gap} (> 1e-3 x logit std {std})")
    print(f"phase 13: float32 4 layers, prefill (two 256-row chunks carry "
          f"the state) vs 512 decode steps: last-position max abs logit "
          f"diff {gap:.3e} (tol 1e-3 x logit std {std:.4f} = "
          f"{1e-3 * std:.3e})", flush=True)
    return launches


def prefill_vs_decode(cfg, params, s: int) -> tuple[float, float]:
    """Last-position logits of one ``s``-token prompt by prefill and by
    ``s`` lockstep decode steps: (max abs diff, logit std)."""
    from repro_torch.models import api

    prompt = np.random.default_rng(5).integers(0, cfg.vocab_size, (1, s))
    with torch.no_grad():
        want = api.prefill(params, {"tokens": prompt}, cfg, device="cuda")
        cache = api.init_cache(cfg, 1, s)
        for t in range(s):
            lo, cache = api.decode(params, prompt[:, t:t + 1], cache, cfg)
    return (lo - want).abs().max().item(), want.std().item()


def whisper_batch(cfg, b: int, t: int, seed: int) -> dict:
    """Seeded N(0, 1) frame embeddings [b, 4,096, d] (the stubbed conv
    frontend's output) and ``t`` decoder tokens, as host arrays."""
    rng = np.random.default_rng(seed)
    return {"frames": rng.standard_normal(
                (b, WHISPER_FRAMES, cfg.d_model), dtype=np.float32),
            "dec_tokens": rng.integers(0, cfg.vocab_size, (b, t),
                                       dtype=np.int32)}


def whisper_cross_cache(params, cfg, frames: torch.Tensor, seq_len: int):
    """``api.init_cache`` with the cross K/V of ``encode(frames)`` in it."""
    from repro_torch.models import api, encdec

    cache = api.init_cache(cfg, frames.shape[0], seq_len, device="cuda")
    cache["cross_k"], cache["cross_v"] = encdec.precompute_cross(
        params, encdec.encode(params, frames, cfg), cfg)
    return cache


def whisper_prefill_vs_decode(params, cfg, batch: dict
                              ) -> tuple[float, float]:
    """Last-position logits of a 64-token decoder prompt by prefill and by
    64 teacher-forced lockstep decode steps on the same frames' cross K/V:
    (max abs diff, logit std)."""
    from repro_torch.models import api

    prompt = batch["dec_tokens"][:, :WHISPER_CHECK_TOKENS]
    with torch.no_grad():
        want = api.prefill(params, {"frames": batch["frames"],
                                    "dec_tokens": prompt}, cfg,
                           device="cuda")
        cache = whisper_cross_cache(params, cfg, batch["frames"],
                                    WHISPER_CHECK_TOKENS)
        for t in range(WHISPER_CHECK_TOKENS):
            lo, cache = api.decode(params, prompt[:, t:t + 1], cache, cfg)
    return (lo - want).abs().max().item(), want.std().item()


def flash_times(phase: str, what: str, shape: tuple, flush: torch.Tensor,
                *, causal: bool, window: int | None = None, seed: int,
                iters: int = 50, plain_iters: int = 10) -> dict:
    """The flash kernel at one model's attention shape (B, H, S, D; bf16)
    against its plain version (y 3e-2, lse 1e-4, and elementwise against
    the kernel-order plain version), SDPA with the same mask and the
    bound: 4 D flops for each (query, key) pair the mask keeps at 989
    TFLOP/s, or q, k, v read and y, the f32 lse written once."""
    from repro_torch.kernels.flash_attention import flash_attention as kernel
    from repro_torch.kernels.flash_attention import ops, ref

    b, h, s, d = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(b, h, s, d, generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    mask = dict(causal=causal, window=window)
    y, lse = kernel.flash_attention(q, k, v, **mask)
    want_y, want_lse = ref.attention_ref(q, k, v, **mask)
    err = (y.float() - want_y.float()).abs().max().item()
    lse_err = (lse - want_lse).abs().max().item()
    del want_y, want_lse
    if not (err <= TOL[torch.bfloat16] and lse_err <= 1e-4):
        raise AssertionError(f"flash_attention at {what}: y err {err}, lse "
                             f"err {lse_err}")
    tiled = tiled_gate(y, q, k, v, causal, window, 0, what)
    del y, lse
    ms = time_ms(lambda: kernel.flash_attention(q, k, v, **mask), flush,
                 iters)
    plain_ms = time_ms(lambda: ref.attention_ref(q, k, v, **mask), flush,
                       iters=plain_iters)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if window is None:
        library_ms = time_ms(lambda: sdpa(q, k, v, is_causal=causal), flush,
                             iters)
    else:
        pos = torch.arange(s, device="cuda")
        keep = (pos[:, None] - pos[None, :] < window) \
            & ((pos[:, None] >= pos[None, :]) if causal else True)
        library_ms = time_ms(lambda: sdpa(q, k, v, attn_mask=keep), flush,
                             iters)
        del keep
    flops = 4 * b * h * d * ops.kept_pairs(s, s, causal, window, 0)
    n_bytes = 4 * b * h * s * d * q.element_size() + 4 * b * h * s
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    t_bytes = n_bytes / MEM_BYTES_PER_S * 1e3
    bound, by = max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                      else "bytes")
    route = kernel.route(q.dtype, d)
    print(f"phase {phase}: flash_attention bfloat16 at {what} (B {b}, H {h}, "
          f"S {s}, D {d}, {'causal' if causal else 'non-causal'}"
          + (f", window {window}" if window is not None else "")
          + f"; route {route}): y max abs err {err:.3e} (tol "
          f"{TOL[torch.bfloat16]}), lse {lse_err:.3e} (tol 1e-4){tiled}; "
          f"ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms="
          f"{library_ms:.4f} (SDPA"
          + (", boolean mask" if window is not None else "")
          + f") bound_ms={bound:.4f} ({flops} flops, {n_bytes} bytes) "
          f"{by}-bound: {flops / ms / 1e9:.1f} TFLOP/s = {bound / ms:.1%} "
          f"of the bound; {card_line()}", flush=True)
    del q, k, v
    free_card()
    return dict(route=route, shape=list(shape), window=window,
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=by, library_ms=library_ms)


def whisper_flash_times(cfg, flush: torch.Tensor) -> dict:
    """The flash kernel at whisper's encoder self-attention (B 8 x H 12 x
    S 4,096 x D 64, non-causal)."""
    return flash_times("14", "whisper's encoder shape", (
        WHISPER_B, cfg.n_heads, WHISPER_FRAMES, cfg.head_dim), flush,
        causal=False, seed=14)


def phase_whisper(cfg, flush: torch.Tensor) -> tuple[int, dict]:
    """Full-width, full-depth whisper-small: prefill at B 8 x 4,096 frames
    x 448 decoder tokens (the flash counter set to 0 just before and read
    just after), the lockstep decode on the frames' cross K/V, the flash
    kernel at the encoder's shape, and the float32 gates.  Returns the
    prefill's flash launches and the kernel's numbers at that shape."""
    from repro_torch.kernels.flash_attention import flash_attention as kernel
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.models import api, encdec

    if kernel.route(torch.bfloat16, cfg.head_dim) != "mma":
        raise AssertionError(f"flash route for bf16 D {cfg.head_dim} is "
                             f"{kernel.route(torch.bfloat16, cfg.head_dim)}"
                             f"; want mma")
    t0 = time.monotonic()
    params = api_init(cfg)
    torch.cuda.synchronize()
    print(f"phase 14: {cfg.name} at full width and depth "
          f"({cfg.n_encoder_layers} + {cfg.n_decoder_layers} layers, d "
          f"{cfg.d_model}, {cfg.n_heads} heads of {cfg.head_dim}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.norm_kind} norm, GELU, "
          f"{cfg.dtype}, untied): "
          f"{sum(p.numel() for p in params.parameters())} random "
          f"parameters drawn in {time.monotonic() - t0:.2f} s", flush=True)
    b, t = WHISPER_B, cfg.decoder_len
    batch = api.batch_to(whisper_batch(cfg, b, t, seed=14), "cuda")
    with torch.no_grad():
        api.prefill(params, batch, cfg, device="cuda")      # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernel.flash_attention.launches = 0
        logits = api.prefill(params, batch, cfg, device="cuda")
        torch.cuda.synchronize()
        launches = kernel.flash_attention.launches
        peak = torch.cuda.max_memory_allocated()
        ms = []
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            api.prefill(params, batch, cfg, device="cuda")
            end.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(end))
        # the flash kernel's share of one more prefill, by CUDA events
        # around each launch
        timed = flash_ops.kernel = _TimedKernel(flash_ops.kernel)
        try:
            api.prefill(params, batch, cfg, device="cuda")
            torch.cuda.synchronize()
            flash_ms = [s.elapsed_time(e) for s, e in timed.events]
        finally:
            flash_ops.kernel = timed.module
    if launches != cfg.n_encoder_layers:
        raise AssertionError(f"flash_attention launched {launches} times in "
                             f"one prefill; want {cfg.n_encoder_layers}, one "
                             f"an encoder layer")
    if not (logits.shape == (b, cfg.vocab_size)
            and torch.isfinite(logits).all()):
        raise AssertionError(f"prefill logits {tuple(logits.shape)}, finite "
                             f"{bool(torch.isfinite(logits).all())}")
    med = statistics.median(ms)
    print(f"phase 14: prefill B {b} x {WHISPER_FRAMES} frames x {t} decoder "
          f"tokens: ms {[round(x, 2) for x in ms]} (CUDA events, median "
          f"{med:.2f}) = {b * WHISPER_FRAMES / med * 1e3:.1f} frames/s; "
          f"flash_attention launches {launches} = {cfg.n_encoder_layers} "
          f"encoder layers, route mma; flash "
          f"{sum(flash_ms):.2f} ms of the prefill ({sum(flash_ms) / med:.1%}"
          f"; per launch {[round(x, 3) for x in flash_ms]}); logits "
          f"{tuple(logits.shape)} finite, std {logits.std().item():.4f}; "
          f"peak memory {peak / 2**30:.3f} GiB; {card_line()}", flush=True)

    with torch.no_grad():
        kernel.flash_attention.launches = 0
        cache = whisper_cross_cache(params, cfg, batch["frames"], t)
        torch.cuda.synchronize()
        enc_launches = kernel.flash_attention.launches
        tok = batch["dec_tokens"][:, :1]
        step_ms, seq = [], [tok]
        for _ in range(WHISPER_DECODE):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lo, cache = api.decode(params, tok, cache, cfg)
            tok = lo.argmax(-1).to(torch.int32)[:, None]
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            seq.append(tok)
    if enc_launches != cfg.n_encoder_layers:
        raise AssertionError(f"encode launched flash_attention "
                             f"{enc_launches} times; want "
                             f"{cfg.n_encoder_layers}")
    if cache["pos"] != WHISPER_DECODE or not torch.isfinite(lo).all():
        raise AssertionError(f"lockstep decode: position {cache['pos']}, "
                             f"finite {bool(torch.isfinite(lo).all())}")
    steady = step_ms[1:]
    print(f"phase 14: encode ({enc_launches} flash launches) + "
          f"precompute_cross into api.init_cache(cfg, {b}, {t}) (cross K/V "
          f"{tuple(cache['cross_k'].shape)}), {WHISPER_DECODE} greedy "
          f"api.decode steps: ms per step mean {statistics.mean(steady):.2f}"
          f" (steps 1-{WHISPER_DECODE - 1}; min {min(steady):.2f}, max "
          f"{max(steady):.2f}; step 0 {step_ms[0]:.2f}); position "
          f"{cache['pos']}; logits finite; first sequence "
          f"{torch.cat(seq, 1)[0, :12].tolist()}", flush=True)
    del cache, logits, lo
    torch.cuda.empty_cache()

    times = whisper_flash_times(cfg, flush)

    one = api.batch_to(whisper_batch(cfg, 1, t, seed=15), "cuda")
    gap, std = whisper_prefill_vs_decode(params, cfg, one)
    print(f"phase 14: bfloat16 {cfg.n_encoder_layers} + "
          f"{cfg.n_decoder_layers} layers, B 1 x {WHISPER_FRAMES} frames, "
          f"prefill vs {WHISPER_CHECK_TOKENS} teacher-forced decode steps: "
          f"last-position max abs logit diff {gap:.3e} (logit std "
          f"{std:.4f}), reported without a bound", flush=True)
    del params, batch
    torch.cuda.empty_cache()

    cfg2 = dataclasses.replace(cfg, n_layers=4, n_encoder_layers=2,
                               n_decoder_layers=2, dtype="float32")
    cpu = api.init_params(cfg2, torch.Generator().manual_seed(0), "cpu")
    gpu = copy.deepcopy(cpu).to("cuda")
    host = whisper_batch(cfg2, 1, t, seed=15)
    with torch.no_grad():
        want = api.prefill(cpu, host, cfg2, device="cpu")
        got = api.prefill(gpu, host, cfg2, device="cuda").cpu()
    err, std = (got - want).abs().max().item(), want.std().item()
    if not (math.isfinite(err) and err <= 1e-4 * std):
        raise AssertionError(f"float32 prefill on the card differs from the "
                             f"CPU path by {err} (> 1e-4 x logit std {std})")
    print(f"phase 14: float32 2 + 2 layers, B 1 x {WHISPER_FRAMES} frames x "
          f"{t} tokens, prefill on the card (flash kernel, simt route) vs "
          f"the CPU path (its plain version): max abs logit diff {err:.3e} "
          f"(tol 1e-4 x logit std {std:.4f} = {1e-4 * std:.3e})",
          flush=True)
    del cpu
    gap, std = whisper_prefill_vs_decode(gpu, cfg2,
                                         api.batch_to(host, "cuda"))
    if not (math.isfinite(gap) and gap <= 1e-4 * std):
        raise AssertionError(f"float32 prefill vs decode: last logits differ "
                             f"by {gap} (> 1e-4 x logit std {std})")
    print(f"phase 14: float32 2 + 2 layers, prefill vs "
          f"{WHISPER_CHECK_TOKENS} teacher-forced decode steps on the same "
          f"cross K/V: last-position max abs logit diff {gap:.3e} (tol 1e-4 "
          f"x logit std {std:.4f} = {1e-4 * std:.3e})", flush=True)
    return launches, times



def reconfig_gate(name: str, window, got, want) -> float:
    """The card's reconfiguration against the CPU route's: ``h_curves``
    bit for bit, and allocations, lines, profit and configuration equal.
    Returns the largest |card - CPU| over ``h_curves`` (0 when it passes)."""
    err = float(np.abs(got.h_curves - want.h_curves).max())
    same = (got.h_curves.dtype == want.h_curves.dtype
            and got.h_curves.shape == want.h_curves.shape
            and got.h_curves.tobytes() == want.h_curves.tobytes()
            and got.allocations == want.allocations
            and got.lines == want.lines and got.profit == want.profit
            and got.config == want.config)
    if not same:
        raise AssertionError(
            f"reconfigure {name} window {window}: the card's result differs "
            f"from the CPU route's (h_curves max abs diff {err}; allocations "
            f"{got.allocations} vs {want.allocations}, lines {got.lines} vs "
            f"{want.lines}, profit {got.profit} vs {want.profit})")
    return err


def profile_times(streams, flush) -> dict:
    """One reconfigure's profile (``profile_curves`` over
    ``reconfigure``'s grid for ``presets.RECONFIG``): host wall ms on the
    card and on the CPU route, and the card's kernels, one launch per
    non-empty stream, by graph replay."""
    from repro_torch.core.cgra import cache_grid
    from repro_torch.core.cgra.reconfig import profile_curves

    ways, lines, way_bytes = list(range(33)), (16, 32, 64, 128), 512

    def wall_ms(dev: str, reps: int) -> float:
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            profile_curves(streams, ways, lines, way_bytes, device=dev)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    grid = cache_grid.ConfigGrid.build(way_bytes, ways, lines)
    kernel_ms = []
    for addrs, _ in streams:
        if addrs.size:
            a = cache_grid.as_int32(addrs, "cuda")
            kernel_ms.append(graph_ms(
                lambda: cache_grid.cache_grid_scan(a, grid), flush, 20))
    wall_ms("cuda", 2)                                   # warm-up
    return dict(card_wall_ms=wall_ms("cuda", 5), cpu_wall_ms=wall_ms("cpu", 3),
                kernel_ms=sum(kernel_ms), launches=len(kernel_ms),
                accesses=int(sum(a.size for a, _ in streams)))


def phase_reconfig(flush: torch.Tensor) -> dict:
    """Fig. 17's loop through ``reconfig.reconfigure`` for the ten Table-1
    kernels at ``presets.RECONFIG``, its profile on the card, at window
    8,192 and over whole per-cache streams (window None): the
    ``cache_grid_scan`` counter set to 0 just before and read just after
    each window's ten calls, held to the number of non-empty streams; each
    result held to the CPU route's.  Then one reconfigure's profile timed,
    and the base and reconfigured systems simulated, runahead off and on."""
    from repro_torch.core.cgra import cache_grid, presets, simulator
    from repro_torch.core.cgra.reconfig import reconfigure, sample_streams
    from repro_torch.core.cgra.trace import KERNELS, REAL_DATA_KERNELS

    t0 = time.monotonic()
    traces = {name: KERNELS[name]() for name in PAPER_KERNELS}
    base = presets.RECONFIG
    print(f"phase 15: the ten Table-1 traces ({sum(map(len, traces.values()))}"
          f" accesses) built on the host in {time.monotonic() - t0:.2f} s",
          flush=True)
    launches, results, err, nonempty = {}, {}, 0.0, {}
    for window in (FIG17_WINDOW, None):
        sizes = [a.size for tr in traces.values()
                 for a, _ in sample_streams(tr, base, window)]
        expect = nonempty[window] = sum(n > 0 for n in sizes)
        torch.cuda.synchronize()
        cache_grid.cache_grid_scan.launches = 0
        t0 = time.perf_counter()
        card = {name: reconfigure(tr, base, window=window, device="cuda")
                for name, tr in traces.items()}
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        launches[window] = cache_grid.cache_grid_scan.launches
        if launches[window] != expect:
            raise AssertionError(f"reconfigure window {window}: "
                                 f"{launches[window]} cache_grid_scan "
                                 f"launches, want one per non-empty stream "
                                 f"({expect})")
        t0 = time.perf_counter()
        host = {name: reconfigure(tr, base, window=window, device="cpu")
                for name, tr in traces.items()}
        host_s = time.perf_counter() - t0
        for name in traces:
            err = max(err, reconfig_gate(name, window, card[name],
                                         host[name]))
        results[window] = card
        print(f"phase 15: reconfigure, window {window}: "
              f"{launches[window]} cache_grid_scan launches = the non-empty "
              f"streams of {len(sizes)} ({min(n for n in sizes if n)}-"
              f"{max(sizes)} addresses, {sum(sizes)} in all); h_curves bit-"
              f"identical to the CPU route's and allocations, lines, profit "
              f"and config equal for all ten; wall {card_s:.3f} s on the "
              f"card vs {host_s:.3f} s on the CPU route (ten kernels, "
              f"sampling and DP included); allocations "
              f"{json.dumps({n: r.allocations for n, r in card.items()})}",
              flush=True)
    card_line_ = card_line()
    times = {}
    for window in (FIG17_WINDOW, None):
        streams = sample_streams(traces["gcn_cora"], base, window)
        times[window] = profile_times(streams, flush)
        t = times[window]
        print(f"phase 15: one reconfigure's profile (gcn_cora, window "
              f"{window}, {t['accesses']} addresses, 4 streams x 132 "
              f"configurations): wall {t['card_wall_ms']:.3f} ms on the card "
              f"vs {t['cpu_wall_ms']:.3f} ms on the CPU route "
              f"({t['cpu_wall_ms'] / t['card_wall_ms']:.1f}x); its "
              f"{t['launches']} cache_grid_scan launches "
              f"{t['kernel_ms']:.4f} ms by graph replay; {card_line_}",
              flush=True)

    gains = {key: [] for key in FIG17_PAPER}
    fig17 = {}
    t0 = time.monotonic()
    for name, tr in traces.items():
        res = results[FIG17_WINDOW][name]
        cfgs = [dataclasses.replace(c, runahead=ra)
                for c in (base, res.config) for ra in (False, True)]
        b0, b1, n0, n1 = simulator.simulate_batch(tr, cfgs)
        fig17[name] = dict(result=res, cfgs=cfgs, stats=[b0, b1, n0, n1])
        kind = "real" if name in REAL_DATA_KERNELS else "rand"
        g0 = (b0.cycles - n0.cycles) / b0.cycles
        g1 = (b1.cycles - n1.cycles) / b1.cycles
        gains[f"{kind}_nora"].append(g0)
        gains[f"{kind}_ra"].append(g1)
        print(f"phase 15: fig 17 {name}: ways {res.allocations} lines "
              f"{res.lines}: cycles {b0.cycles} -> {n0.cycles} ({g0:+.2%}) "
              f"no runahead, {b1.cycles} -> {n1.cycles} ({g1:+.2%}) "
              f"runahead", flush=True)
    avg = {key: 100 * statistics.fmean(v) for key, v in gains.items()}
    print(f"phase 15: fig 17 average gains, % (simulated on the host in "
          f"{time.monotonic() - t0:.2f} s): "
          + "; ".join(f"{key} {avg[key]:+.2f} (paper {FIG17_PAPER[key]:+.2f})"
                      for key in FIG17_PAPER), flush=True)
    return dict(launches=sum(launches.values()), err=err,
                profile=times[FIG17_WINDOW], profile_whole=times[None],
                gains=avg, fig17=fig17, streams=nonempty[FIG17_WINDOW])


def phase_allocator(flush: torch.Tensor) -> dict:
    """Algorithm 1 as an operand allocator at dbrx-132b's published width:
    block 0's MoE and the embedding on the card (random, seed 0), a seeded
    batch of 8 x 4,096 tokens, the reference example's two streams
    (embedding rows and expert-weight rows), ``allocate`` on the card
    (held to the CPU route's plan), then the embedding gather at the
    plan's depth through ``ops.gather`` (bit-identical to ``embed[tokens]``),
    with the profiler and gather counters set to 0 just before and read
    just after; the gather timed against ``index_select`` and its bound."""
    from repro_torch.configs import registry
    from repro_torch.core.cgra import cache_grid
    from repro_torch.core.runahead import allocate
    from repro_torch.kernels.gather_runahead import gather_runahead as kernel
    from repro_torch.kernels.gather_runahead import ops, ref
    from repro_torch.models import layers, moe

    cfg = registry.get("dbrx-132b")
    gen = torch.Generator(device="cuda").manual_seed(0)
    block = moe.MoE(cfg, device="cuda")
    block.reset_parameters(gen)
    embed = torch.empty((cfg.vocab_size, cfg.d_model),
                        dtype=getattr(torch, cfg.dtype), device="cuda")
    layers.dense_init_(embed, gen)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (ALLOC_B, ALLOC_S)).astype(np.int32)).cuda()
    flat = tokens.reshape(-1)
    with torch.no_grad():
        routing = moe.routing_trace(block, embed[flat.long()], cfg)
    del block
    torch.cuda.empty_cache()
    streams = {"vocab_embedding": flat.cpu().numpy(),
               "moe_expert_rows": routing.reshape(-1).cpu().numpy()}
    row_bytes = {"vocab_embedding": cfg.d_model * 2,     # bf16 rows
                 "moe_expert_rows": cfg.d_ff * 2}
    top = max(int(streams[k].max()) * row_bytes[k] for k in streams)
    counters = {"cache_grid_scan": cache_grid.cache_grid_scan,
                "runahead_gather": kernel.runahead_gather}
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    kernel.runahead_gather.route_launches = dict.fromkeys(kernel.ROUTES, 0)
    t0 = time.perf_counter()
    plan = allocate(streams, budget_tiles=ALLOC_BUDGET, row_bytes=row_bytes)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    n, row = flat.shape[0], cfg.d_model * embed.element_size()
    block_rows = next(b for b in (8, 4, 2, 1) if min(plan.depth, n // b)
                      * b * row <= kernel.MAX_SMEM_BYTES)
    out = ops.gather(embed, flat, impl="runahead", block_rows=block_rows,
                     depth=plan.depth)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    routes = dict(kernel.runahead_gather.route_launches)
    if launches != {"cache_grid_scan": 2, "runahead_gather": 1}:
        raise AssertionError(f"allocator path launches {launches}; want 2 "
                             f"profiles and 1 gather")
    if routes["bulk"] != 1:
        raise AssertionError(f"the plan's gather took routes {routes}; want "
                             f"the bulk route")
    t0 = time.perf_counter()
    host = allocate(streams, budget_tiles=ALLOC_BUDGET, row_bytes=row_bytes,
                    device="cpu")
    host_s = time.perf_counter() - t0
    if plan != host:
        raise AssertionError(f"allocate on the card {plan} != on the CPU "
                             f"route {host}")
    want = embed[flat.long()]
    err = (out.float() - want.float()).abs().max().item()
    if not bit_equal(out, want):
        raise AssertionError(f"runahead gather at depth {plan.depth}, "
                             f"block_rows {block_rows}: not bit-identical to "
                             f"embed[tokens] (max abs err {err})")
    print(f"phase 15: {cfg.name} at published width (embedding "
          f"{cfg.vocab_size} x {cfg.d_model} {cfg.dtype}, block 0's router "
          f"over {cfg.n_experts} experts top-{cfg.top_k}), tokens "
          f"{ALLOC_B} x {ALLOC_S}: streams "
          f"{ {k: int(v.size) for k, v in streams.items()} } (largest address "
          f"{top}); plan on the card == the CPU route's: "
          + ", ".join(f"{p.name} {p.tiles} tiles / {p.dma_bytes} B lines / "
                      f"hit rate {p.hit_rate:.6f}" for p in plan.streams)
          + f", depth {plan.depth}, profit {plan.total_profit:.6f}; allocate "
          f"wall {card_s * 1e3:.1f} ms on the card vs {host_s * 1e3:.1f} ms "
          f"on the CPU route; launches {json.dumps(launches)}, the gather "
          f"by route {json.dumps(routes)}; gather at depth {plan.depth}, "
          f"block_rows {block_rows} bit-identical to embed[tokens]",
          flush=True)

    def run(use=None, rows=block_rows, depth=plan.depth):
        return kernel.runahead_gather(embed, flat, block_rows=rows,
                                      depth=depth, use=use)

    if not bit_equal(run("cp_async"), want):
        raise AssertionError(f"runahead gather at depth {plan.depth} on the "
                             f"cp_async route: not bit-identical")
    # in turns: the library call, the plan's route, the other, and back
    library = [graph_ms(lambda: torch.index_select(embed, 0, flat), flush)]
    ms = [graph_ms(run, flush)]
    cp_ms = [graph_ms(lambda: run("cp_async"), flush) for _ in range(2)]
    ms.append(graph_ms(run, flush))
    library.append(graph_ms(lambda: torch.index_select(embed, 0, flat),
                            flush))
    ms, cp_ms = statistics.mean(ms), statistics.mean(cp_ms)
    library_ms = statistics.mean(library)
    eager_ms = time_ms(run, flush)
    depth2_ms = graph_ms(lambda: run(None, BLOCK_ROWS, 2), flush)
    plain_ms = time_ms(lambda: ref.gather_ref(embed, flat), flush)
    distinct = torch.unique(flat).numel()
    n_bytes = distinct * row + n * 4 + n * row
    bound = n_bytes / MEM_BYTES_PER_S * 1e3
    print(f"phase 15: gather {n} rows of {row} B at the plan's depth "
          f"{plan.depth} (block_rows {block_rows}, route bulk): ms={ms:.4f} "
          f"(graph replay, mean of two turns; eager {eager_ms:.4f}), "
          f"{bound / ms:.1%} of its bound, {ms / library_ms:.3f}x "
          f"index_select; the cp_async route {cp_ms:.4f}; depth 2 x "
          f"{BLOCK_ROWS} rows (route {kernel.route(row, BLOCK_ROWS, 2)}) "
          f"{depth2_ms:.4f}; plain_ms={plain_ms:.4f} library_ms="
          f"{library_ms:.4f} (index_select, graph replay, mean of "
          f"{[round(t, 4) for t in library]}) bound_ms={bound:.4f} "
          f"({n_bytes} bytes: {distinct} distinct rows read, {n} written) "
          f"bytes-bound; {card_line()}", flush=True)
    return dict(launches=launches, routes=routes, err=err, depth=plan.depth,
                block_rows=block_rows, ms=ms, eager_ms=eager_ms,
                kernel_route="bulk", route_ms={"bulk": ms, "cp_async": cp_ms},
                plain_ms=plain_ms, bound_ms=bound, bound_by="bytes",
                library_ms=library_ms, depth2_ms=depth2_ms)


def sweep_grid(fig17: dict) -> tuple[list, dict]:
    """Phase 16's 80 points: each Table-1 kernel at its default size under
    ``examples/simulate_cgra.py``'s four single-cache rows and under phase
    15's four Fig. 17 configurations (base and reconfigured, runahead off
    and on).  Returns the points and, by point index, phase 15's Stats."""
    from repro_torch.core.cgra import presets

    rows = (presets.SPM_ONLY_4K, presets.SPM_ONLY_133K, presets.CACHE_SPM,
            presets.RUNAHEAD)
    points, want = [], {}
    for name in PAPER_KERNELS:
        points += [(name, cfg) for cfg in rows]
        for cfg, stats in zip(fig17[name]["cfgs"], fig17[name]["stats"]):
            want[len(points)] = stats
            points.append((name, cfg))
    return points, want


def same_results(got, want, what: str) -> None:
    """Stats (field for field) and trace metadata of two sweeps' results
    of one grid, in order."""
    for g, w in zip(got, want, strict=True):
        if g.stats != w.stats or g.trace_meta != w.trace_meta:
            raise AssertionError(f"{what}: {g.point[0]} "
                                 f"{g.point[1]} gives {g.stats} "
                                 f"(meta {g.trace_meta}), want {w.stats} "
                                 f"(meta {w.trace_meta})")


def timed_sweep(sw, points, root: Path, workers: int, chaos) -> tuple:
    t0 = time.perf_counter()
    res = sw.sweep(points, store=sw.SimCache(root), workers=workers,
                   chaos=chaos)
    return res, time.perf_counter() - t0


def phase_sweep(sw, workers: int, reconf: dict) -> dict:
    """The crash-safe sweep service on the card's machine: phase 16's grid
    into a fresh store (every point computed; the Fig. 17 points equal to
    phase 15's ``simulate_batch`` Stats), again into the same store (none
    computed, the same results), and into a second store under a seeded
    ``mixed`` chaos plan (worker crashes, torn records, a dropped index)
    with CUDA initialized: the pool's rebuild degrades to inline work,
    the results are the cold run's bit for bit, and a re-read recomputes
    exactly the torn records.  Then ``reconfigure_cached`` for the ten
    kernels, its profile on the card: cold, ``cache_grid_scan`` launched
    once per non-empty stream and phase 15's result; warm, no launch."""
    from repro_torch.core.cgra import cache_grid, presets
    from repro_torch.runtime import chaos

    points, want = sweep_grid(reconf["fig17"])
    pool = sw._executor
    mode = (f"{workers} forked workers" if pool is not None
            else "inline (one CPU: no pool)")
    print(f"phase 16: {len(points)} points (10 Table-1 kernels x 8 "
          f"configurations), sweep {mode}", flush=True)
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_simcache_") as tmp:
        tmp = Path(tmp)
        cold, cold_s = timed_sweep(sw, points, tmp / "cold", workers, None)
        computed = sum(not r.cached for r in cold)
        if computed != len(points):
            raise AssertionError(f"cold sweep: {computed} of {len(points)} "
                                 f"points computed into a fresh store")
        for i, stats in want.items():
            if cold[i].stats != stats:
                raise AssertionError(
                    f"cold sweep: {cold[i].point[0]} {cold[i].point[1]} "
                    f"gives {cold[i].stats}, phase 15's simulate_batch "
                    f"{stats}")
        warm, warm_s = timed_sweep(sw, points, tmp / "cold", workers, None)
        if any(not r.cached for r in warm):
            raise AssertionError(f"warm sweep computed "
                                 f"{sum(not r.cached for r in warm)} points")
        same_results(warm, cold, "warm sweep")
        engines = {}
        for r in cold:
            engines[r.engine] = engines.get(r.engine, 0) + 1
        print(f"phase 16: cold sweep {cold_s:.3f} s "
              f"({len(points) / cold_s:.2f} points/s, {computed} computed, "
              f"engines "
              f"{json.dumps(engines, sort_keys=True)}; the 40 Fig. 17 "
              f"points equal phase 15's simulate_batch Stats); warm "
              f"{warm_s:.3f} s ({len(points) / warm_s:.1f} points/s, 0 "
              f"computed, results equal); {card_line()}", flush=True)

        plan = chaos.ChaosPlan(CHAOS_SEED, "mixed", chaos.PROFILES["mixed"])
        hit, hit_s = timed_sweep(sw, points, tmp / "chaos", workers, plan)
        rep = sw.LAST_REPORT
        same_results(hit, cold, "chaos sweep")
        if rep is None or rep.retries < 1 or not rep.ok():
            raise AssertionError(f"chaos sweep: want at least one retry and "
                                 f"no quarantine, got "
                                 f"{rep and rep.counters()}")
        if pool is not None and (rep.crashes < 1 or rep.pool_rebuilds < 1
                                 or sw._executor is not None):
            raise AssertionError(
                f"chaos sweep: want a worker crash and the pool's rebuild "
                f"declined after CUDA (inline work), got {rep.counters()}, "
                f"pool {sw._executor}")
        store = sw.SimCache(tmp / "chaos")
        reread = sw.sweep(points, store=store, workers=workers, chaos=None)
        same_results(reread, cold, "re-read of the chaos store")
        recomputed = sum(not r.cached for r in reread)
        if recomputed != store.quarantined:
            raise AssertionError(
                f"re-read of the chaos store: {recomputed} points "
                f"recomputed, {store.quarantined} torn records quarantined;"
                f" every other point must be durable")
        print(f"phase 16: chaos sweep (seed {CHAOS_SEED}, mixed) "
              f"{hit_s:.3f} s: {json.dumps(rep.counters(), sort_keys=True)}"
              f"; {'degraded to inline after the crash' if pool else 'inline'}"
              f"; results bit-identical to the cold sweep; a re-read "
              f"quarantined {store.quarantined} torn records and recomputed "
              f"exactly those", flush=True)
        out.update(points=len(points), workers=workers if pool else 1,
                   cold_s=cold_s, warm_s=warm_s, chaos_s=hit_s,
                   chaos=rep.counters(), torn=store.quarantined)

        store = sw.SimCache(tmp / "reconfig")
        fig17 = reconf["fig17"]
        ms = {}
        for phase_name in ("cold", "warm"):
            torch.cuda.synchronize()
            cache_grid.cache_grid_scan.launches = 0
            ms[phase_name] = {}
            for name in PAPER_KERNELS:
                t0 = time.perf_counter()
                res = sw.reconfigure_cached(name, presets.RECONFIG,
                                            window=FIG17_WINDOW, store=store)
                torch.cuda.synchronize()
                ms[phase_name][name] = (time.perf_counter() - t0) * 1e3
                ref = fig17[name]["result"]
                if (res.allocations, res.lines, res.profit, res.config) != (
                        ref.allocations, ref.lines, ref.profit, ref.config):
                    raise AssertionError(
                        f"reconfigure_cached {name} ({phase_name}): "
                        f"{res.allocations} {res.lines} {res.profit}, phase "
                        f"15's {ref.allocations} {ref.lines} {ref.profit}")
                if (res.h_curves is None) != (phase_name == "warm"):
                    raise AssertionError(f"reconfigure_cached {name} "
                                         f"({phase_name}): h_curves "
                                         f"{type(res.h_curves).__name__}")
            launches = cache_grid.cache_grid_scan.launches
            expect = reconf["streams"] if phase_name == "cold" else 0
            if launches != expect:
                raise AssertionError(
                    f"reconfigure_cached ({phase_name}): {launches} "
                    f"cache_grid_scan launches, want {expect}")
            out[f"{phase_name}_launches"] = launches
        print(f"phase 16: reconfigure_cached, ten kernels at window "
              f"{FIG17_WINDOW}: cold {out['cold_launches']} cache_grid_scan "
              f"launches (= phase 15's non-empty streams), warm 0, results "
              f"phase 15's; ms cold vs warm (trace build, sampling, profile,"
              f" DP and store write vs a store read): "
              + "; ".join(f"{n} {ms['cold'][n]:.2f} vs {ms['warm'][n]:.3f}"
                          for n in PAPER_KERNELS)
              + f"; {card_line()}", flush=True)
        out.update(reconfigure_cached_ms={
            k: round(sum(v.values()), 4) for k, v in ms.items()})
    return out


def host_leaves(state: dict) -> list:
    """Every leaf of a (DTensor) state, whole, copied to the host."""
    from repro_torch import sharding

    return [sharding.full(t).detach().to("cpu", copy=True)
            for t in state_leaves(state)]


def sharded_train(cfg, rules, sharded: bool) -> tuple[list, list, list]:
    """``SHARDED_STEPS`` steps of phase 9's shape from seed 0, through
    ``build_train_step`` under ``rules`` or the plain ``train_step``:
    (losses, step ms, the final state's leaves on the host)."""
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.launch import steps, train_lm
    from repro_torch.models.types import ShapeConfig

    shape = ShapeConfig("train_4k", "train", TRAIN_S, TRAIN_B)
    opt = steps.make_optimizer(cfg)
    state = train_lm.init_state(cfg, opt, "cuda", seed=0)
    if sharded:
        step_fn = steps.build_train_step(cfg, shape, rules).fn
    else:
        def step_fn(state, batch):
            return steps.train_step(state, batch, cfg, opt, device="cuda")
    losses, ms = [], []
    for i in range(SHARDED_STEPS):
        batch = synthetic_batch(cfg, shape, seed=0, step=i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        losses.append(metrics["loss"].item())
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    leaves = host_leaves(state)
    del state, metrics
    torch.cuda.empty_cache()
    return losses, ms, leaves


def first_prompts(cfg) -> tuple[list, list]:
    """Phase 4's first 4 prompts, drawn in ``cfg``'s vocabulary: (their
    lengths, the prompts)."""
    rng = np.random.default_rng(0)
    lens = rng.integers(32, 385, size=12)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist()
               for n in lens][:SHARDED_REQUESTS]
    return lens[:SHARDED_REQUESTS].tolist(), prompts


def sharded_serve(cfg, params, prompts, rules, counters=None) -> dict:
    """Greedy requests through the engine (with ``rules``: params placed
    on the mesh in place, cache replicated there); the launch counters
    (paged attention's when None) set to 0 just before and read just
    after the measured run."""
    from repro_torch.kernels.paged_attention import paged_attention as kernel
    from repro_torch.serve import ServeEngine
    from repro_torch.serve.scheduler import RequestState

    counters = counters or {"paged_attention": kernel.paged_attention}

    kw = dict(slots=8, max_len=512, page_size=16, prefill_chunk=64,
              attn_read="kernel", rules=rules)
    warm = ServeEngine(cfg, params, **kw)   # DTensor's propagation caches
    warm.submit(prompts[0][:70], max_new_tokens=4)
    warm.run()
    warm.assert_no_leaks()
    del warm
    eng = ServeEngine(cfg, params, **kw)
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    reqs = [eng.submit(p, max_new_tokens=32) for p in prompts]
    step_ms = {"decode": [], "prefill": []}
    while eng.sched.has_work():
        before = eng.metrics.decode_steps
        s0 = time.monotonic()
        if not eng.step():
            break
        torch.cuda.synchronize()
        kind = "decode" if eng.metrics.decode_steps > before else "prefill"
        step_ms[kind].append((time.monotonic() - s0) * 1e3)
    launches = {name: fn.launches for name, fn in counters.items()}
    eng.assert_no_leaks()
    for r in reqs:
        if r.state is not RequestState.FINISHED or len(r.out_tokens) != 32:
            raise AssertionError(f"request {r.rid}: {r.state} with "
                                 f"{len(r.out_tokens)} tokens")
    return {"tokens": [list(r.out_tokens) for r in reqs],
            "launches": launches, "decode_steps": eng.metrics.decode_steps,
            "decode_ms": step_ms["decode"], "prefill_ms": step_ms["prefill"],
            "dtensor": type(eng.params.embed).__name__}


@contextlib.contextmanager
def one_rank_mesh():
    """A one-rank NCCL group (a ``FileStore``, no TCP port) and the rules
    of phases 17-18 over ``make_host_mesh(1, 1)``; the group is destroyed
    on the way out."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding.rules import MeshRules

    store_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_pg_"))
    t0 = time.monotonic()
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.FileStore(
        str(store_dir / "store"), 1), rank=0, world_size=1,
        device_id=torch.device("cuda", 0))
    try:
        rules = MeshRules(make_host_mesh(1, 1))
        print(f"phase 17: one-rank NCCL group and mesh "
              f"{rules.mesh.mesh_dim_names} {tuple(rules.mesh.shape)} on "
              f"{rules.mesh.device_type} in {time.monotonic() - t0:.2f} s",
              flush=True)
        yield rules
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store_dir, ignore_errors=True)


def phase_sharded(cfg, rules) -> dict:
    """Phase 17: the sharding layer on a one-rank NCCL mesh (1, 1)."""
    from repro_torch.kernels.flash_attention import flash_attention as fa

    fa.flash_attention.launches = 0
    losses, ms, leaves = sharded_train(cfg, rules, sharded=True)
    flash = fa.flash_attention.launches
    plain_losses, plain_ms, plain_leaves = sharded_train(cfg, rules,
                                                         sharded=False)
    want = SHARDED_STEPS * cfg.n_layers * 2
    if flash != want:
        raise AssertionError(f"flash_attention launched {flash} times in "
                             f"{SHARDED_STEPS} sharded steps; want {want}")
    for a, b in zip(losses, plain_losses):
        if not (math.isfinite(a) and abs(a - b) <= 1e-4 * abs(b)):
            raise AssertionError(f"sharded losses {losses} vs plain "
                                 f"{plain_losses}: not within 1e-4")
    same = [bits_equal(a, b) for a, b in zip(leaves, plain_leaves)]
    worst = max(float((a.float() - b.float()).abs().max())
                for a, b in zip(leaves, plain_leaves))
    del leaves, plain_leaves
    print(f"phase 17: {SHARDED_STEPS} steps of {cfg.name} at B "
          f"{TRAIN_B} x {TRAIN_S} through build_train_step on the mesh "
          f"(state by state_specs) vs plain train_step, seed 0: losses "
          f"{losses} vs {plain_losses}, bit-identical "
          f"{losses == plain_losses}; leaves bit-identical "
          f"{sum(same)}/{len(same)}, largest leaf difference {worst!r}; "
          f"step ms sharded {[round(x, 1) for x in ms]} vs plain "
          f"{[round(x, 1) for x in plain_ms]}; flash_attention launches "
          f"{flash} = {SHARDED_STEPS} steps x {cfg.n_layers} layers x 2; "
          f"{card_line()}", flush=True)

    lens, prompts = first_prompts(cfg)
    params = api_init(cfg)
    plain = sharded_serve(cfg, params, prompts, None)
    mesh = sharded_serve(cfg, params, prompts, rules)
    del params
    torch.cuda.empty_cache()
    if mesh["tokens"] != plain["tokens"]:
        raise AssertionError(f"greedy tokens on the mesh {mesh['tokens']} "
                             f"!= plain {plain['tokens']}")
    paged = mesh["launches"]["paged_attention"]
    want = mesh["decode_steps"] * cfg.n_layers
    if paged != want or mesh["dtensor"] != "DTensor":
        raise AssertionError(f"paged launches {paged} != {want} on the "
                             f"mesh ({mesh['dtensor']} params)")
    print(f"phase 17: ServeEngine with rules ({mesh['dtensor']} params "
          f"by param_specs, replicated pools) vs without: "
          f"{SHARDED_REQUESTS} greedy requests of {lens} "
          f"tokens, 32 new each: tokens equal; decode-step ms mean "
          f"{statistics.mean(mesh['decode_ms']):.3f} (median "
          f"{statistics.median(mesh['decode_ms']):.3f}) vs plain "
          f"{statistics.mean(plain['decode_ms']):.3f} (median "
          f"{statistics.median(plain['decode_ms']):.3f}) over "
          f"{len(mesh['decode_ms'])} steps; prefill-chunk ms mean "
          f"{statistics.mean(mesh['prefill_ms']):.3f} vs "
          f"{statistics.mean(plain['prefill_ms']):.3f}; paged launches "
          f"{paged} = {mesh['decode_steps']} decode steps x "
          f"{cfg.n_layers}; page leaks 0; {card_line()}", flush=True)
    return {"flash": flash, "paged": paged,
            "train_ms": ms, "plain_train_ms": plain_ms,
            "decode_ms": statistics.mean(mesh["decode_ms"]),
            "plain_decode_ms": statistics.mean(plain["decode_ms"])}


def free_card() -> None:
    """Return freed tensors to the card: an engine's reference cycles keep
    a model's weights alive until the collector runs."""
    gc.collect()
    torch.cuda.empty_cache()


def kernel_counters() -> dict:
    """The launch counter of every kernel phase 18's paths run, by the
    kernels line's names."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.moe_dispatch import moe_dispatch as moe
    from repro_torch.kernels.paged_attention import paged_attention as pa
    from repro_torch.kernels.ssd_scan import ssd_scan as ssd

    return {"paged_attention": pa.paged_attention,
            "flash_attention": fa.flash_attention,
            "moe_dispatch": moe.dispatch, "moe_combine": moe.combine,
            "ssd_scan": ssd.ssd_scan}


class Launches:
    """Counters set to 0 on entry and read on exit (``.n``, by name); the
    SSD and flash kernels' launches by route beside (``.routes``,
    ``.flash_routes``).  Every read is added to ``total``, the phase's sum
    by kernel."""

    def __init__(self, total: dict):
        self.total = total

    def __enter__(self):
        self.counters = kernel_counters()
        for fn in self.counters.values():
            fn.launches = 0
        self.counters["ssd_scan"].route_launches.update(simt=0, mma=0)
        self.counters["flash_attention"].route_launches.update(simt=0,
                                                               mma=0)
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.n = {k: fn.launches for k, fn in self.counters.items()}
        self.routes = dict(self.counters["ssd_scan"].route_launches)
        self.flash_routes = dict(
            self.counters["flash_attention"].route_launches)
        for k, v in self.n.items():
            self.total[k] = self.total.get(k, 0) + v
        return False

    def expect(self, what: str, **want) -> None:
        """Every counter named in ``want`` at its value, the rest 0."""
        full = {k: want.get(k, 0) for k in self.n}
        if self.n != full:
            raise AssertionError(f"{what}: launches {self.n} != {full}")


def leaf_digest(t: torch.Tensor, weights: torch.Tensor) -> int:
    """A digest of a leaf's bits computed on the card: its elements as
    integers of their width times fixed random int64 weights, summed
    mod 2**64 in chunks (integer sums, so the order does not matter)."""
    from repro_torch import sharding

    bits = sharding.full(t).detach().contiguous().reshape(-1)
    bits = bits.view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                      8: torch.int64}[bits.element_size()])
    total = torch.zeros((), dtype=torch.int64, device=bits.device)
    for i in range(0, bits.numel(), weights.numel()):
        chunk = bits[i:i + weights.numel()]
        total += (chunk.long() * weights[:chunk.numel()]).sum()
    return int(total)


def digest_weights() -> torch.Tensor:
    gen = torch.Generator(device="cuda").manual_seed(18)
    return torch.randint(-2**62, 2**62, (DIGEST_CHUNK,), generator=gen,
                         dtype=torch.int64, device="cuda")


def family_train(cfg, shape, rules, sharded: bool, total: dict) -> dict:
    """2 steps of ``shape`` from seed 0 through ``build_train_step`` on
    the mesh (``sharded``) or the plain ``train_step``: losses, step ms,
    launches on the mesh, peak memory and a digest of every leaf of the
    final state (computed on the card, then the state is freed)."""
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.launch import steps, train_lm
    from repro_torch.runtime.elastic import reshard_state

    opt = steps.make_optimizer(cfg)
    state = train_lm.init_state(cfg, opt, "cuda", seed=0)
    if sharded:
        # placed before the first step, so the plain moments are dropped
        # rather than held beside their DTensors through it
        state = reshard_state(state, rules)
        step_fn = steps.build_train_step(cfg, shape, rules).fn
    else:
        def step_fn(state, batch):
            return steps.train_step(state, batch, cfg, opt, device="cuda")
    losses, ms = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with Launches(total if sharded else {}) as n:
        for i in range(SHARDED_STEPS):
            batch = synthetic_batch(cfg, shape, seed=0, step=i)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            losses.append(metrics["loss"].item())
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    weights = digest_weights()
    digests = [leaf_digest(t, weights) for t in state_leaves(state)]
    n_params = sum(p.numel() for p in state["params"].parameters())
    moments = sorted({str(t.dtype) for t in state["m"].values()})
    del state, metrics, weights
    free_card()
    return {"losses": losses, "ms": ms, "launches": n.n, "routes": n.routes,
            "peak": peak, "digests": digests, "params": n_params,
            "moments": moments}


def train_gates(cfg, shape, mesh: dict, plain: dict, **want) -> str:
    """Phase 18's training gates: each sharded loss within 1e-4 relative
    of the plain one; launches on the mesh as ``want`` (per layer a step,
    twice: the forward and its recompute).  Returns the line's text."""
    for a, b in zip(mesh["losses"], plain["losses"]):
        if not (math.isfinite(a) and abs(a - b) <= 1e-4 * abs(b)):
            raise AssertionError(f"{cfg.name}: sharded losses "
                                 f"{mesh['losses']} vs plain "
                                 f"{plain['losses']}: not within 1e-4")
    full = {k: want.get(k, 0) * SHARDED_STEPS * cfg.n_layers * 2
            for k in mesh["launches"]}
    if mesh["launches"] != full:
        raise AssertionError(f"{cfg.name} training on the mesh: launches "
                             f"{mesh['launches']} != {full}")
    same = sum(a == b for a, b in zip(mesh["digests"], plain["digests"]))
    return (f"{SHARDED_STEPS} steps of {cfg.name} ({cfg.n_layers} layers) "
            f"at B {shape.global_batch} x {shape.seq_len} through "
            f"build_train_step on the mesh vs plain train_step, seed 0: "
            f"losses {mesh['losses']} vs {plain['losses']}, bit-identical "
            f"{mesh['losses'] == plain['losses']}; leaves bit-identical (by "
            f"digest) {same}/{len(plain['digests'])}; step ms sharded "
            f"{[round(x, 1) for x in mesh['ms']]} vs plain "
            f"{[round(x, 1) for x in plain['ms']]}; peak memory "
            f"{mesh['peak'] / 2**30:.3f} vs {plain['peak'] / 2**30:.3f} GiB; "
            f"launches {json.dumps(mesh['launches'])} = {SHARDED_STEPS} "
            f"steps x {cfg.n_layers} layers x 2 (forward and recompute) per "
            f"kernel's layer; {card_line()}")


def lockstep(params, cache, tokens, step_fn) -> list:
    """Logits of teacher-forced lockstep decode steps: ``tokens`` [n, B, 1]
    on the card, one a step, through ``step_fn(params, tokens, cache)``."""
    out = []
    with torch.no_grad():
        for tok in tokens:
            logits, cache = step_fn(params, tok, cache)
            out.append(logits)
    return out


def plain_lockstep(params, cfg, cache, first, n: int) -> tuple:
    """``n`` greedy ``api.decode`` steps from ``first`` [B, 1]: (the
    inputs, [n, B, 1] on the card, and each step's logits)."""
    from repro_torch.models import api

    toks, logits = [first], []
    with torch.no_grad():
        for i in range(n):
            lo, cache = api.decode(params, toks[-1], cache, cfg)
            logits.append(lo)
            if i + 1 < n:
                toks.append(lo.argmax(-1).to(torch.int32)[:, None])
    return toks, logits


def whole(t: torch.Tensor) -> torch.Tensor:
    from repro_torch import sharding

    return sharding.full(t)


def all_equal(got: list, want: list) -> bool:
    return len(got) == len(want) and all(
        bits_equal(whole(a), b) for a, b in zip(got, want))


def dbrx_family(rules, total: dict) -> dict:
    """dbrx-132b at phase 11's depth through the engine without and with
    rules, then at 1 layer through 2 training steps both ways."""
    from repro_torch.configs import registry
    from repro_torch.models.types import ShapeConfig

    cfg = dataclasses.replace(registry.get("dbrx-132b"), n_layers=DBRX_LAYERS)
    lens, prompts = first_prompts(cfg)      # phase 11's (phase 4's)
    counters = {k: fn for k, fn in kernel_counters().items()
                if k in ("paged_attention", "moe_dispatch", "moe_combine")}
    params = api_init(cfg)
    plain = sharded_serve(cfg, params, prompts, None, counters)
    mesh = sharded_serve(cfg, params, prompts, rules, counters)
    del params
    free_card()
    if mesh["tokens"] != plain["tokens"]:
        raise AssertionError(f"dbrx greedy tokens on the mesh "
                             f"{mesh['tokens']} != plain {plain['tokens']}")
    chunks = len(mesh["prefill_ms"])
    want = {"paged_attention": mesh["decode_steps"] * cfg.n_layers,
            "moe_dispatch": cfg.n_layers * (mesh["decode_steps"] + chunks),
            "moe_combine": cfg.n_layers * (mesh["decode_steps"] + chunks)}
    if mesh["launches"] != want or mesh["dtensor"] != "DTensor":
        raise AssertionError(f"dbrx on the mesh: launches {mesh['launches']}"
                             f" != {want} ({mesh['dtensor']} params)")
    for k, v in mesh["launches"].items():
        total[k] = total.get(k, 0) + v
    print(f"phase 18: {cfg.name} ({cfg.n_layers} of 40 layers) ServeEngine "
          f"with rules vs without, {len(prompts)} greedy requests of "
          f"{lens} tokens (phase 11's first), 32 "
          f"new each: tokens equal; decode-step ms "
          f"mean {statistics.mean(mesh['decode_ms']):.3f} (median "
          f"{statistics.median(mesh['decode_ms']):.3f}) vs plain "
          f"{statistics.mean(plain['decode_ms']):.3f} (median "
          f"{statistics.median(plain['decode_ms']):.3f}) over "
          f"{len(mesh['decode_ms'])} steps; prefill-chunk ms mean "
          f"{statistics.mean(mesh['prefill_ms']):.3f} vs "
          f"{statistics.mean(plain['prefill_ms']):.3f} over {chunks}; "
          f"launches on the mesh {json.dumps(mesh['launches'])} (dispatch = "
          f"combine = {cfg.n_layers} x ({mesh['decode_steps']} decode steps "
          f"+ {chunks} prefill chunks), paged = decode steps x "
          f"{cfg.n_layers}); page leaks 0; {card_line()}", flush=True)

    tcfg = dataclasses.replace(registry.get("dbrx-132b"), n_layers=1,
                               accum_steps=1)
    shape = ShapeConfig("train_2k", "train", DBRX_TRAIN_S, DBRX_TRAIN_B)
    train = family_train(tcfg, shape, rules, True, total)
    plain_train = family_train(tcfg, shape, rules, False, {})
    print("phase 18: " + train_gates(
        tcfg, shape, train, plain_train, moe_dispatch=1, moe_combine=1,
        flash_attention=1), flush=True)
    return {"decode_ms": statistics.mean(mesh["decode_ms"]),
            "plain_decode_ms": statistics.mean(plain["decode_ms"]),
            "train_ms": train["ms"], "plain_train_ms": plain_train["ms"]}


def mamba_family(rules, total: dict) -> dict:
    """Full mamba2-2.7b: ``build_step`` prefill and lockstep decode on the
    mesh vs plain (params placed in place after the plain runs), then 2
    training steps both ways."""
    from repro_torch.configs import registry
    from repro_torch.launch import steps
    from repro_torch.models import api
    from repro_torch.models.types import ShapeConfig

    cfg = registry.get("mamba2-2.7b")
    params = api_init(cfg)
    b, s = 4, 4096
    batch = {"tokens": np.random.default_rng(3).integers(
        0, cfg.vocab_size, (b, s))}
    first = torch.as_tensor(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (8, 1)), dtype=torch.int32, device="cuda")
    with torch.no_grad():
        want = api.prefill(params, batch, cfg, device="cuda")
    toks, ref = plain_lockstep(params, cfg, api.init_cache(cfg, 8, 256),
                               first, FAMILY_DECODE_STEPS)
    prefill = steps.build_step(
        cfg, ShapeConfig("prefill_4k", "prefill", s, b), rules)
    with Launches(total) as n, torch.no_grad():
        t0 = time.perf_counter()
        got = prefill.fn(params, batch)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
    n.expect("mamba2 prefill on the mesh", ssd_scan=cfg.n_layers)
    if n.routes["mma"] != cfg.n_layers or not bits_equal(
            whole(got), want):
        raise AssertionError(f"mamba2 prefill on the mesh: routes "
                             f"{n.routes}, bit-identical "
                             f"{bits_equal(whole(got), want)}")
    decode = steps.build_step(cfg, ShapeConfig("decode_256", "decode", 256, 8),
                              rules)
    with Launches(total) as nd:
        out = lockstep(params, api.init_cache(cfg, 8, 256), toks, decode.fn)
    nd.expect("mamba2 lockstep decode on the mesh")
    if not all_equal(out, ref):
        raise AssertionError("mamba2 lockstep decode on the mesh: logits "
                             "differ from the plain steps'")
    print(f"phase 18: {cfg.name} ({cfg.n_layers} layers) build_step prefill "
          f"on the mesh at B {b} x S {s}: logits bit-identical to "
          f"api.prefill, ssd_scan launches {n.n['ssd_scan']} by route "
          f"{n.routes}, {prefill_ms:.1f} ms (first call on the mesh); "
          f"{FAMILY_DECODE_STEPS} build_step lockstep decode steps (8 "
          f"sequences, greedy inputs of the plain run): logits "
          f"bit-identical; {card_line()}", flush=True)
    del params, want, ref, out, got
    free_card()

    for tb in MAMBA_TRAIN_BATCHES:
        free_card()
        shape = ShapeConfig("train_4k", "train", MAMBA_TRAIN_S, tb)
        try:
            plain = family_train(cfg, shape, rules, False, {})
            break
        except torch.cuda.OutOfMemoryError:
            print(f"phase 18: {cfg.name} plain training at B {tb} x "
                  f"{MAMBA_TRAIN_S} does not fit; trying a smaller batch",
                  flush=True)
    free_card()
    train = family_train(cfg, shape, rules, True, total)
    print("phase 18: " + train_gates(cfg, shape, train, plain, ssd_scan=1),
          flush=True)
    return {"train_ms": train["ms"], "plain_train_ms": plain["ms"],
            "train_batch": shape.global_batch}


def jamba_family(rules, total: dict) -> None:
    """jamba-1.5-large-398b at full width, its first 4 layers: prefill and
    lockstep decode on the mesh vs plain, bit for bit."""
    from repro_torch.configs import registry
    from repro_torch.launch import steps
    from repro_torch.models import api
    from repro_torch.models.types import ShapeConfig

    cfg = dataclasses.replace(registry.get("jamba-1.5-large-398b"),
                              n_layers=JAMBA_LAYERS, period=JAMBA_LAYERS)
    kinds = {(spec.mixer, spec.ffn) for spec in cfg.pattern()}
    t0 = time.monotonic()
    params = api_init(cfg)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    batch = {"tokens": np.random.default_rng(6).integers(
        0, cfg.vocab_size, (JAMBA_B, JAMBA_S))}
    first = torch.as_tensor(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (8, 1)), dtype=torch.int32, device="cuda")
    with torch.no_grad():
        want = api.prefill(params, batch, cfg, device="cuda")
    toks, ref = plain_lockstep(params, cfg, api.init_cache(cfg, 8, 256),
                               first, FAMILY_DECODE_STEPS)
    prefill = steps.build_step(
        cfg, ShapeConfig("prefill", "prefill", JAMBA_S, JAMBA_B), rules)
    n_ssm = sum(spec.mixer == "ssm" for spec in cfg.pattern())
    n_moe = sum(spec.ffn == "moe" for spec in cfg.pattern())
    with Launches(total) as n, torch.no_grad():
        got = prefill.fn(params, batch)
    n.expect("jamba prefill on the mesh", ssd_scan=n_ssm,
             flash_attention=cfg.n_layers - n_ssm, moe_dispatch=n_moe,
             moe_combine=n_moe)
    if not bits_equal(whole(got), want):
        raise AssertionError("jamba prefill on the mesh: logits differ from "
                             "api.prefill's")
    decode = steps.build_step(cfg, ShapeConfig("decode_256", "decode", 256, 8),
                              rules)
    with Launches(total) as nd:
        out = lockstep(params, api.init_cache(cfg, 8, 256), toks, decode.fn)
    nd.expect("jamba lockstep decode on the mesh",
              moe_dispatch=n_moe * FAMILY_DECODE_STEPS,
              moe_combine=n_moe * FAMILY_DECODE_STEPS)
    if not all_equal(out, ref):
        raise AssertionError("jamba lockstep decode on the mesh: logits "
                             "differ from the plain steps'")
    print(f"phase 18: {cfg.name} at full width, its first {cfg.n_layers} "
          f"layers (blocks {sorted(kinds)}; {n_params} random parameters "
          f"drawn and both runs in {time.monotonic() - t0:.1f} s): "
          f"build_step prefill on the mesh at B {JAMBA_B} x S {JAMBA_S} "
          f"bit-identical to api.prefill, launches {json.dumps(n.n)}; "
          f"{FAMILY_DECODE_STEPS} lockstep decode steps (8 sequences) "
          f"bit-identical, launches {json.dumps(nd.n)}; {card_line()}",
          flush=True)
    del params, want, ref, out, got
    free_card()


def whisper_family(rules, total: dict) -> None:
    """whisper-small: 32 ``build_step`` decode steps on phase 14's frames'
    cross K/V on the mesh vs plain, bit for bit."""
    from repro_torch.configs import registry
    from repro_torch.launch import steps
    from repro_torch.models import api
    from repro_torch.models.types import ShapeConfig

    cfg = registry.get("whisper-small")
    params = api_init(cfg)
    frames = torch.as_tensor(whisper_batch(cfg, WHISPER_B, 1, seed=14)[
        "frames"], device="cuda")
    with torch.no_grad():
        plain_cache = whisper_cross_cache(params, cfg, frames, 64)
    cross = (plain_cache["cross_k"], plain_cache["cross_v"])
    first = torch.as_tensor(np.random.default_rng(8).integers(
        0, cfg.vocab_size, (WHISPER_B, 1)), dtype=torch.int32, device="cuda")
    toks, ref = plain_lockstep(params, cfg, plain_cache, first,
                               WHISPER_DECODE)

    def cache():
        c = api.init_cache(cfg, WHISPER_B, 64, device="cuda")
        c["cross_k"], c["cross_v"] = (t.clone() for t in cross)
        return c

    decode = steps.build_step(
        cfg, ShapeConfig("decode_64", "decode", 64, WHISPER_B), rules)
    with Launches(total) as n:
        t0 = time.perf_counter()
        out = lockstep(params, cache(), toks, decode.fn)
        ms = (time.perf_counter() - t0) * 1e3 / len(toks)
    n.expect("whisper decode on the mesh")
    if not all_equal(out, ref):
        raise AssertionError("whisper lockstep decode on the mesh: logits "
                             "differ from the plain steps'")
    print(f"phase 18: {cfg.name} at full width and depth, {WHISPER_DECODE} "
          f"build_step decode steps on the mesh (B {WHISPER_B}, cross K/V "
          f"of {WHISPER_FRAMES} frames, teacher-forced with the plain run's "
          f"greedy tokens): logits bit-identical to api.decode's, "
          f"{ms:.2f} ms a step; no kernel on this path; {card_line()}",
          flush=True)
    del params, ref, out, cross, plain_cache
    free_card()


def phase_families(rules) -> dict:
    """Phase 18: every other model family on the one-rank mesh; returns the
    launches on the mesh by kernel, with dbrx's and mamba2's times."""
    total: dict = {}
    t0 = time.monotonic()
    dbrx = dbrx_family(rules, total)
    mamba = mamba_family(rules, total)
    jamba_family(rules, total)
    whisper_family(rules, total)
    print(f"phase 18: every family on the mesh in "
          f"{time.monotonic() - t0:.1f} s; launches on the mesh "
          f"{json.dumps(total)}", flush=True)
    return {"launches": total, "dbrx": dbrx, "mamba": mamba}


def dryrun_cells(out: str) -> int:
    """``chip_smoke.py --dryrun-cells OUT``: phase 19's production-mesh
    cells through ``dryrun.run_cell`` in this process's own fake world,
    their records written to OUT as JSON.  Touches no card."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch import dryrun

    records = []
    for arch, shape, multi_pod, overrides, cuts in DRYRUN_CELLS:
        t0 = time.monotonic()
        rec = dryrun.run_cell(arch, shape, multi_pod, overrides,
                              cfg_overrides=cuts)
        rec["seconds"] = time.monotonic() - t0
        records.append(rec)
    Path(out).write_text(json.dumps(records))
    return 0


@contextlib.contextmanager
def subprocesses():
    """``started(t)`` returns ``t`` (a ``start_*`` tuple, its process
    first); on the way out, by an error too, every process so passed
    that is still running is killed."""
    procs = []

    def started(t: tuple) -> tuple:
        procs.append(t[0])
        return t

    try:
        yield started
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def start_dryrun_cells() -> tuple:
    """Phase 19 (a), started: the dry run's three cells on this machine's
    torch, in a subprocess (a process holds one default group, and this
    one holds phases 17-19's NCCL group) that runs beside (b) and (c)."""
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_dryrun_"))
    out = tmp / "cells.json"
    proc = subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--dryrun-cells",
         str(out)], stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    return proc, tmp, out, time.monotonic()


def phase_dryrun_cells(started: tuple) -> dict:
    """Phase 19 (a), collected within ``DRYRUN_TIMEOUT_S`` of its start:
    each cell's per-rank peak, TFLOPs, collective bytes by kind and trace
    seconds."""
    proc, tmp, out, t0 = started
    try:
        try:
            _, err = proc.communicate(
                timeout=max(1.0, DRYRUN_TIMEOUT_S - (time.monotonic() - t0)))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            raise AssertionError(f"phase 19: the dry-run cells took over "
                                 f"{DRYRUN_TIMEOUT_S} s")
        if proc.returncode != 0 or not out.exists():
            raise AssertionError(f"phase 19: the dry-run cells failed (rc "
                                 f"{proc.returncode}):\n{err[-3000:]}")
        records = json.loads(out.read_text())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    cells = {}
    for rec, (arch, shape, _, overrides, cuts) in zip(records, DRYRUN_CELLS):
        if rec.get("status") != "ok":
            raise AssertionError(f"phase 19: {arch} x {shape}: {rec}")
        sp = rec["rules"]["sequence_parallel"]
        cells[f"{arch}__{shape}__{rec['mesh']}__sp_{'on' if sp else 'off'}"] \
            = {k: rec[k] for k in ("peak_device_bytes", "flops",
                                   "collectives", "trace_seconds")}
        coll = {k: round(v / 1e9, 3) for k, v in rec["collectives"].items()}
        print(f"phase 19: dry run {arch}{'' if not cuts else f' {cuts}'} "
              f"x {shape} x {rec['mesh']}, sequence_parallel {sp}: "
              f"{rec['chips']} ranks, per rank peak "
              f"{rec['peak_device_bytes'] / 2**30:.3f} GiB, "
              f"{rec['flops'] / 1e12:.3f} TFLOPs, collective GB by kind "
              f"{json.dumps(coll)} (calls "
              f"{json.dumps(rec['collective_counts'])}), kernel fakes "
              f"{json.dumps(rec['kernel_calls'])}; trace "
              f"{rec['trace_seconds']} s, cell {rec['seconds']:.1f} s on "
              f"torch {torch.__version__}", flush=True)
    on, off = (cells[f"dbrx-132b__train_4k__pod2x16x16__sp_{k}"]
               for k in ("on", "off"))
    print("phase 19: dbrx train_4k pod2x16x16, sequence parallelism on vs "
          "off: " + ", ".join(
              f"{kind} {on['collectives'].get(kind, 0) / 1e9:.3f} vs "
              f"{off['collectives'].get(kind, 0) / 1e9:.3f} GB"
              for kind in sorted({*on["collectives"], *off["collectives"]}))
          + f"; peak {on['peak_device_bytes'] / 2**30:.3f} vs "
          f"{off['peak_device_bytes'] / 2**30:.3f} GiB; trace "
          f"{on['trace_seconds']} vs {off['trace_seconds']} s", flush=True)
    print(f"phase 19: dry-run subprocess done "
          f"{time.monotonic() - t0:.1f} s after its start", flush=True)
    return cells


# phase 21: the sequence-parallel checks' names (tests/
# torch_host_mesh_checks.py's ``sequence_parallel_card`` group), their time
# limit from the start of their subprocess, and the gates
SP_CASES = ("qwen2", "dbrx", "mamba2", "jamba", "whisper", "qwen2_1x4")
SP_TIMEOUT_S = 600
SP_STEP_TOL, SP_PREFILL_TOL, SP_MOE_TOL = 1e-4, 1e-5, 2.0 ** -8


def sp_ranks(out: str) -> int:
    """``chip_smoke.py --sp-ranks OUT``: phase 21's 4 gloo ranks on the
    CPU (``tests/torch_host_mesh_checks.py``'s ``sequence_parallel_card``
    group, a ``FileStore`` beside OUT, 120 s a collective), rank 0's
    results written to OUT as JSON.  Touches no card."""
    import torch.multiprocessing as mp

    sys.path[:0] = [str(ROOT / "src"), str(ROOT / "tests")]
    import torch_host_mesh_checks as checks

    with tempfile.TemporaryDirectory(dir=os.path.dirname(out)) as d:
        mp.spawn(checks._rank, args=("sequence_parallel_card",
                                     os.path.join(d, "store"), out),
                 nprocs=checks.GROUPS["sequence_parallel_card"][0])
    return 0


def start_sp_ranks() -> tuple:
    """Phase 21, started beside phase 19's subprocess."""
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_sp_"))
    out = tmp / "sp.json"
    proc = subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--sp-ranks",
         str(out)], stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    return proc, tmp, out, time.monotonic()


def sp_failures(name: str, r: dict) -> list[str]:
    """Phase 21's gates on one check's results."""
    if "error" in r:
        return [r["error"]]
    moe = r["moe"]
    rel = {k: abs(r[f"f32_{k}"] - r[f"f32_plain_{k}"])
           / abs(r[f"f32_plain_{k}"]) for k in ("loss", "grad_norm")}
    gates = {
        "loss": rel["loss"] <= SP_STEP_TOL,
        "grad norm": rel["grad_norm"] <= SP_STEP_TOL,
        "moments": r["moment_max_rel_norm"]
        <= (SP_MOE_TOL if moe else SP_STEP_TOL),
        "parameters": r["param_max_abs"] <= 2 * r["lr"],
        "prefill": r["prefill_err"]
        <= (SP_MOE_TOL if moe else SP_PREFILL_TOL) * r["prefill_scale"],
        "Shard(1) at every block boundary":
            r["boundaries"] > 0 and not r["off_sequence"],
        "cross K/V": r.get("cross_err", 0.0)
        <= SP_PREFILL_TOL * r.get("cross_scale", 0.0),
        "placed": r["placed"] and r["step_equal"]}
    return [f"{name}: {gate} ({json.dumps(r)[:1500]})"
            for gate, ok in gates.items() if not ok]


def phase_sp_ranks(started: tuple) -> dict:
    """Phase 21, collected after phase 20 (within ``SP_TIMEOUT_S`` of its
    start): each arch's errors against the unsharded step and prefill."""
    proc, tmp, out, t0 = started
    try:
        try:
            _, err = proc.communicate(
                timeout=max(1.0, SP_TIMEOUT_S - (time.monotonic() - t0)))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            raise AssertionError(f"phase 21: the sequence-parallel ranks "
                                 f"took over {SP_TIMEOUT_S} s")
        results = json.loads(out.read_text()) if out.exists() else {}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    failures = [] if proc.returncode == 0 else [
        f"rc {proc.returncode}: {err[-3000:]}"]
    for name in SP_CASES:
        r = results.get(f"sp_card_{name}", {"error": "did not run"})
        failures += sp_failures(name, r)
        if "error" in r:
            continue
        print(f"phase 21: {name} at {tuple(r['mesh'])}, sequence_parallel "
              f"on (4 gloo ranks, torch {torch.__version__}): float32 loss "
              f"{r['f32_loss']:.7f} vs unsharded {r['f32_plain_loss']:.7f}, "
              f"grad norm {r['f32_grad_norm']:.7f} vs "
              f"{r['f32_plain_grad_norm']:.7f}, moments max rel. norm "
              f"{r['moment_max_rel_norm']:.3e}, params max abs "
              f"{r['param_max_abs']:.3e} (lr {r['lr']:.1e}); prefill max "
              f"abs err {r['prefill_err']:.3e} of scale "
              f"{r['prefill_scale']:.4f}; stream Shard(1) over model at "
              f"{r['boundaries']} block boundaries (off: "
              f"{r['off_sequence']}); {r['seconds']:.1f} s", flush=True)
    print(f"phase 21: sequence-parallel subprocess done "
          f"{time.monotonic() - t0:.1f} s after its start", flush=True)
    if failures:
        raise AssertionError("phase 21: " + "\n".join(failures))
    return {name: results[f"sp_card_{name}"] for name in SP_CASES}


# phase 19 (b): (arch, its cuts, the training shape), traced on meta and
# then run on the card through the same counters
DRYRUN_CARD = (("qwen2-1.5b", {}, (TRAIN_B, TRAIN_S)),
               ("dbrx-132b", {"n_layers": 1, "accum_steps": 1},
                (DBRX_TRAIN_B, DBRX_TRAIN_S)),
               ("mamba2-2.7b", {"n_layers": 8}, (TRAIN_B, TRAIN_S)))


def dryrun_against_card(arch: str, cuts: dict, bs: tuple, rules,
                        total: dict) -> dict:
    """One ``build_train_step`` step traced on meta through
    ``dryrun.trace_step`` (as ``run_cell`` traces), then run for real on
    the card under the same counters; gates: equal per-rank FLOPs, equal
    collective calls by kind, each kernel's fake calls equal to its
    launches, predicted peak bytes within ``PEAK_GATE`` of
    ``max_memory_allocated``."""
    from repro_torch.configs import registry
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.launch import dryrun, steps, train_lm
    from repro_torch.models.types import ShapeConfig

    cfg = dataclasses.replace(registry.get(arch), **cuts)
    shape = ShapeConfig("train", "train", bs[1], bs[0])
    built = steps.build_train_step(cfg, shape, rules)
    pred = dryrun.trace_step(built, dryrun.place(built))
    del built
    opt = steps.make_optimizer(cfg)
    state = train_lm.init_state(cfg, opt, "cuda", seed=0)
    built = steps.build_train_step(cfg, shape, rules)
    args = dryrun.place(built, (state, synthetic_batch(cfg, shape, seed=0,
                                                       step=0)))
    del state
    free_card()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with Launches(total) as n:
        t0 = time.perf_counter()
        real = dryrun.trace_step(built, args)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated()
    del args, built
    free_card()
    names = {"repro_torch.flash_attention": "flash_attention",
             "repro_torch.moe_dispatch": "moe_dispatch",
             "repro_torch.moe_combine": "moe_combine",
             "repro_torch.ssd_scan": "ssd_scan"}
    fakes = {names[k]: v for k, v in pred["kernel_calls"].items()}
    n.expect(f"phase 19: {arch} on the card", **fakes)
    ratio = pred["peak_device_bytes"] / peak
    if pred["flops"] != real["flops"] or \
            pred["collective_counts"] != real["collective_counts"] or \
            pred["kernel_calls"] != real["kernel_calls"] or \
            abs(ratio - 1) > PEAK_GATE:
        raise AssertionError(
            f"phase 19: {arch} traced on meta vs run on the card: flops "
            f"{pred['flops']} vs {real['flops']}, collectives "
            f"{pred['collective_counts']} vs {real['collective_counts']}, "
            f"kernels {pred['kernel_calls']} vs {real['kernel_calls']}, "
            f"peak {pred['peak_device_bytes']} vs {peak} (ratio {ratio})")
    print(f"phase 19: {arch} ({cfg.n_layers} layers) build_train_step at B "
          f"{bs[0]} x {bs[1]} on the one-rank mesh, traced on meta vs run "
          f"on the card: FLOPs {pred['flops']:.6e} = {real['flops']:.6e}; "
          f"collectives {json.dumps(pred['collective_counts'])} equal; "
          f"kernel fakes {json.dumps(fakes)} = launches {json.dumps(n.n)}; "
          f"peak predicted {pred['peak_device_bytes'] / 2**30:.3f} GiB vs "
          f"max_memory_allocated {peak / 2**30:.3f} GiB (ratio "
          f"{ratio:.4f}, gate {PEAK_GATE}); meta trace "
          f"{pred['trace_seconds']} s, card step {ms:.1f} ms (under the "
          f"counters); {card_line()}", flush=True)
    return {"flops": pred["flops"], "peak_ratio": ratio,
            "predicted_peak": pred["peak_device_bytes"], "peak": peak,
            "ms": ms}


def layout(out) -> list:
    outs = out if isinstance(out, tuple) else (out,)
    return [(tuple(t.shape), t.dtype, t.stride()) for t in outs]


def fake_cases() -> dict:
    """Each custom op's CUDA operands at the shapes phases 8, 10 and 12
    time, and its non-tensor arguments."""
    gen = torch.Generator(device="cuda").manual_seed(19)
    q, k, v = (torch.randn(TRAIN_B, 12, TRAIN_S, 128, generator=gen,
                           device="cuda", dtype=torch.bfloat16)
               for _ in range(3))
    slot, n_slots, _ = moe_slots(4096, 1024, 6144, gen)
    x = torch.randn(4096, 6144, generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    ye = torch.randn(n_slots, 6144, generator=gen, device="cuda",
                     dtype=torch.bfloat16)
    w = torch.rand(4096, 4, generator=gen, device="cuda")
    return {"flash_attention": ((q, k, v), (True, None, 0)),
            "moe_dispatch": ((x, slot), (n_slots,)),
            "moe_combine": ((ye, slot, w), ()),
            "ssd_scan": (tuple(ssd_inputs(4, 4096, 80, 64, 128, gen)),
                         (64, torch.float32))}


def op_overhead() -> dict:
    """Eager host µs a call of each custom op against the direct call of
    its kernel wrapper, at a decode-sized shape, in turns (op, direct,
    direct, op), each over ``OVERHEAD_CALLS`` calls ended by a
    synchronise."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.moe_dispatch import moe_dispatch as moe
    from repro_torch.kernels.ssd_scan import ssd_scan as ssd

    gen = torch.Generator(device="cuda").manual_seed(20)
    bf = dict(device="cuda", dtype=torch.bfloat16)
    q, k, v = (torch.randn(8, 12, 64, 128, generator=gen, **bf)
               for _ in range(3))
    slot, n_slots, _ = moe_slots(8, 8, 6144, gen)
    x = torch.randn(8, 6144, generator=gen, **bf)
    ye = torch.randn(n_slots, 6144, generator=gen, **bf)
    w = torch.rand(8, 4, generator=gen, device="cuda")
    xs = ssd_inputs(1, 64, 80, 64, 128, gen)
    ops = torch.ops.repro_torch
    pairs = {
        "flash_attention": (
            lambda: ops.flash_attention(q, k, v, True, None, 0),
            lambda: fa.flash_attention(fa_ops._operand(q), fa_ops._operand(k),
                                       fa_ops._operand(v), causal=True)),
        "moe_dispatch": (lambda: ops.moe_dispatch(x, slot, n_slots),
                         lambda: moe.dispatch(x, slot, n_slots)),
        "moe_combine": (lambda: ops.moe_combine(ye, slot, w),
                        lambda: moe.combine(ye, slot, w.float())),
        "ssd_scan": (
            lambda: ops.ssd_scan(*xs, 64, torch.float32),
            lambda: ssd.ssd_scan(xs[0], xs[1].float(), xs[2].float(), xs[3],
                                 xs[4], xs[5].float(),
                                 out_dtype=torch.float32))}

    def us(fn) -> float:
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(OVERHEAD_CALLS):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / OVERHEAD_CALLS * 1e6

    out = {}
    for name, (op, direct) in pairs.items():
        a, b, c, d = us(op), us(direct), us(direct), us(op)
        out[name] = {"op_us": (a + d) / 2, "direct_us": (b + c) / 2}
    return out


def phase_dryrun(cfg, rules) -> dict:
    """Phase 19 (b) and (c) on the one-rank mesh, and the custom ops'
    host cost; (a), the production-mesh cells, runs beside them in a
    subprocess (:func:`start_dryrun_cells`)."""
    from repro_torch.launch import hlo  # noqa: F401 (the FLOP formulas)

    t0 = time.monotonic()
    total: dict = {}
    card = {arch: dryrun_against_card(arch, cuts, bs, rules, total)
            for arch, cuts, bs in DRYRUN_CARD}
    fakes = {}
    for name, (tensors, rest) in fake_cases().items():
        op = getattr(torch.ops.repro_torch, name)
        got = op(*tensors, *rest)
        fake = op(*(t.to("meta") for t in tensors), *rest)
        torch.cuda.synchronize()
        if layout(fake) != layout(got):
            raise AssertionError(f"phase 19: {name}'s fake {layout(fake)} "
                                 f"!= its kernel's {layout(got)}")
        fakes[name] = [[list(sh), str(dt), list(st)]
                       for sh, dt, st in layout(got)]
        del got
    print(f"phase 19: each fake's output shape, dtype and strides equal "
          f"its kernel's at phases 8, 10 and 12's shapes: "
          f"{json.dumps(fakes)}; {card_line()}", flush=True)
    free_card()
    over = op_overhead()
    print(f"phase 19: custom-op host cost, eager µs a call (op vs direct "
          f"wrapper call, {OVERHEAD_CALLS} calls, decode-sized shapes): "
          + "; ".join(f"{k} {v['op_us']:.2f} vs {v['direct_us']:.2f} "
                      f"(+{v['op_us'] - v['direct_us']:.2f})"
                      for k, v in over.items()) + f"; {card_line()}",
          flush=True)
    print(f"phase 19 (b, c) on the mesh in {time.monotonic() - t0:.1f} s; "
          f"launches {json.dumps(total)}", flush=True)
    return {"launches": total, "card": card, "overhead": over}


class _PlainFlash:
    """Stands in for the flash kernel module inside ``ops``: the plain
    version, on the same tensors."""

    @staticmethod
    def flash_attention(q, k, v, **mask):
        from repro_torch.kernels.flash_attention import ref
        return ref.attention_ref(q, k, v, **mask)


@contextlib.contextmanager
def plain_flash():
    """Every flash launch inside the block replaced by its plain version
    (the blocked attention's forward through ``ref.attention_ref``)."""
    from repro_torch.kernels.flash_attention import ops as flash_ops

    kernel = flash_ops.kernel
    flash_ops.kernel = _PlainFlash()
    try:
        yield
    finally:
        flash_ops.kernel = kernel


def arch_line(cfg, n_params: int, what: str) -> None:
    print(f"phase 20: {cfg.name} at full width, {what} (d {cfg.d_model}, "
          f"heads {cfg.n_heads}/{cfg.n_kv_heads} of {cfg.head_dim}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size}"
          + (f", {cfg.n_experts} experts top-{cfg.top_k} + "
             f"{cfg.n_shared_experts} shared" if cfg.n_experts else "")
          + (f", window {cfg.window}" if cfg.attention_kind == "swa" else "")
          + f", {cfg.dtype}): {n_params} random parameters (seed 0)",
          flush=True)


def arch_serve(cfg, params, total: dict) -> None:
    """Phase 4's first 4 prompts, greedy, 32 new tokens each, through the
    ``ServeEngine`` with every kernel counter set to 0 just before the
    measured run and read just after: 4/4 requests, 0 page leaks, paged
    launches = decode steps x layers, dispatch = combine = MoE layers x
    (decode steps + prefill chunks), nothing else."""
    lens, prompts = first_prompts(cfg)
    counters = kernel_counters()
    free_card()
    torch.cuda.reset_peak_memory_stats()
    run = sharded_serve(cfg, params, prompts, None, counters)
    peak = torch.cuda.max_memory_allocated()
    steps_, chunks = run["decode_steps"], len(run["prefill_ms"])
    n_moe = sum(spec.ffn == "moe" for spec in cfg.pattern()) * cfg.n_groups
    want = {k: 0 for k in counters}
    want.update(paged_attention=steps_ * cfg.n_layers,
                moe_dispatch=n_moe * (steps_ + chunks),
                moe_combine=n_moe * (steps_ + chunks))
    if run["launches"] != want or 0 in (want["paged_attention"], steps_):
        raise AssertionError(f"{cfg.name} served: launches "
                             f"{run['launches']} != {want} for {steps_} "
                             f"decode steps and {chunks} prefill chunks")
    for k, v in run["launches"].items():
        total[k] = total.get(k, 0) + v
    tokens = sum(len(t) for t in run["tokens"])
    print(f"phase 20: {cfg.name} ({cfg.n_layers} layers) ServeEngine, "
          f"{len(prompts)} greedy requests of {lens} tokens (phase 4's "
          f"first), 32 new each: {len(prompts)}/{len(prompts)} finished, "
          f"{tokens} tokens; decode-step ms mean "
          f"{statistics.mean(run['decode_ms']):.3f} (median "
          f"{statistics.median(run['decode_ms']):.3f}) over {steps_}; "
          f"prefill-chunk ms mean {statistics.mean(run['prefill_ms']):.3f} "
          f"over {chunks}; peak memory {peak / 2**30:.3f} GiB; launches "
          f"{json.dumps(run['launches'])} (paged = {steps_} decode steps x "
          f"{cfg.n_layers} layers"
          + (f"; dispatch = combine = {n_moe} x ({steps_} + {chunks})"
             if n_moe else "") + f"); page leaks 0; {card_line()}",
          flush=True)


def arch_read_gap(cfg, params) -> None:
    """The bf16 logit gap of the kernel read against the gather read on
    phase 5's prompt (reported)."""
    gap = read_paths(cfg, params, read_prompt(cfg))
    print(f"phase 20: {cfg.name} bfloat16 kernel vs gather read, 200-token "
          f"greedy prompt, 8 new: max abs logit diff {gap['err']:.3e} over "
          f"{gap['positions']} positions (logit std {gap['logit_std']:.3f}); "
          f"streams equal {gap['streams_equal']}", flush=True)


def arch_read_gate(cfg) -> None:
    """Phase 5's float32 gate at the arch's head geometry, cut to
    ``READ_CHECK_LAYERS`` layers: the paged kernel's read against the
    gather read within 5e-2, greedy streams equal."""
    cut = dataclasses.replace(cfg, n_layers=READ_CHECK_LAYERS)
    f32 = f32_read_gate(cut, read_prompt(cut))
    print(f"phase 20: {cfg.name} float32 {cut.n_layers} layers, kernel vs "
          f"gather read (heads {cfg.n_heads}/{cfg.n_kv_heads}, "
          f"{cfg.n_heads // cfg.n_kv_heads} query heads a KV head), same "
          f"prompt: max abs logit diff {f32['err']:.3e} over "
          f"{f32['positions']} positions (tol 5e-2; logit std "
          f"{f32['logit_std']:.3f}); streams equal {f32['streams_equal']}",
          flush=True)


def plain_step0_loss(cfg, shape) -> float:
    """Step 0's loss of ``shape`` from seed 0's weights, through the flash
    kernel's plain version."""
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.models import api

    params = api_init(cfg)
    with torch.no_grad(), plain_flash():
        loss = api.train_loss(params, synthetic_batch(cfg, shape, seed=0,
                                                      step=0), cfg,
                              device="cuda").item()
    del params
    free_card()
    return loss


def arch_train(cfg, shape, total: dict, *, plain_check: bool = False
               ) -> None:
    """Phase 18's plain run (``family_train``: 2 ``train_step``s of
    ``shape`` from seed 0, every kernel counter set to 0 just before and
    read just after): finite losses, the moments in the arch's dtype,
    each kernel of a layer launched twice a layer (the forward and its
    recompute) a microbatch a step.  With ``plain_check``, step 0's loss
    within 2e-2 of the same loss through the flash kernel's plain
    version (phase 9's gate)."""
    plain0 = plain_step0_loss(cfg, shape) if plain_check else None
    run = family_train(cfg, shape, None, False, {})
    losses, ms, launches = run["losses"], run["ms"], run["launches"]
    if cfg.family == "encdec":
        n_attn, n_moe = cfg.n_encoder_layers, 0
    else:
        n_attn = sum(s.mixer == "attn" for s in cfg.pattern()) * cfg.n_groups
        n_moe = sum(s.ffn == "moe" for s in cfg.pattern()) * cfg.n_groups
    accum = max(1, cfg.accum_steps)
    per = SHARDED_STEPS * 2 * accum
    want = {k: 0 for k in launches}
    want.update(flash_attention=per * n_attn, moe_dispatch=per * n_moe,
                moe_combine=per * n_moe)
    if launches != want:
        raise AssertionError(f"{cfg.name} training: launches {launches} != "
                             f"{want}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{cfg.name} training: losses {losses}")
    if run["moments"] != [f"torch.{cfg.adam_dtype}"]:
        raise AssertionError(f"{cfg.name} training: moments "
                             f"{run['moments']}, want {cfg.adam_dtype}")
    # bf16 attention rounds at other points in the two paths; averaged
    # over the batch's tokens that is ~1e-3 (phase 9)
    if plain0 is not None and abs(losses[0] - plain0) > 2e-2:
        raise AssertionError(f"{cfg.name} step 0 loss {losses[0]} is not "
                             f"within 2e-2 of the plain-attention loss "
                             f"{plain0}")
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v
    tokens = shape.global_batch * (min(cfg.decoder_len, shape.seq_len)
                                   if cfg.family == "encdec"
                                   else shape.seq_len)
    print(f"phase 20: {cfg.name} training, {cfg.n_layers} layers "
          f"({run['params']} parameters, AdamW moments {run['moments']}), "
          f"{SHARDED_STEPS} train_steps at B {shape.global_batch} x S "
          f"{shape.seq_len}"
          + (f" ({cfg.decoder_len} decoder tokens)"
             if cfg.family == "encdec" else "")
          + f", {accum} microbatch(es): losses "
          f"{[round(x, 4) for x in losses]}"
          + (f" (step 0 through the plain attention {plain0:.4f}, gap "
             f"{abs(losses[0] - plain0):.3e}, tol 2e-2)" if plain_check
             else "")
          + f"; step ms {[round(x, 1) for x in ms]} = "
          f"{tokens / ms[-1] * 1e3:.1f} tokens/s at the last; peak memory "
          f"{run['peak'] / 2**30:.3f} GiB; launches {json.dumps(launches)} "
          f"= {SHARDED_STEPS} steps x {accum} x 2 (forward and recompute) "
          f"per kernel's layer; {card_line()}", flush=True)


def token_arch(name: str, serve_layers, train_layers, bs: tuple, accum,
               plain_check: bool, total: dict) -> dict:
    """One row of ``TOKEN_ARCHS`` at published width: served through the
    ``ServeEngine`` (``arch_serve``) with its bf16 kernel-vs-gather read gap
    reported, its MoE kernels held against their plain versions, the
    paged kernel's read held to the gather read in float32
    (``arch_read_gate``), trained (``arch_train``), and the flash kernel
    held against its plain version at the training step's attention shape
    (a microbatch's B, the query heads: GQA is widened before the kernel);
    returns those flash numbers."""
    from repro_torch.configs import registry
    from repro_torch.models.types import ShapeConfig

    full = registry.get(name)
    cfg = dataclasses.replace(full, n_layers=serve_layers or full.n_layers)
    params = api_init(cfg)
    arch_line(cfg, sum(p.numel() for p in params.parameters()),
              f"{cfg.n_layers} of {full.n_layers} layers")
    arch_serve(cfg, params, total)
    arch_read_gap(cfg, params)
    if cfg.n_experts:
        phase_moe_logits(cfg, params, phase="20")
    del params
    free_card()
    arch_read_gate(cfg)
    if cfg.n_experts:
        phase_moe_logits_f32(cfg, phase="20")
        free_card()
    b, s = bs
    tcfg = dataclasses.replace(full, n_layers=train_layers or full.n_layers,
                               accum_steps=accum or full.accum_steps)
    micro = b // max(1, tcfg.accum_steps)
    print(f"phase 20: {name} trains at {tcfg.n_layers} of {full.n_layers} "
          f"layers"
          + (" (a cut of depth: one card does not hold the whole model's "
             "training state)" if tcfg.n_layers < full.n_layers else "")
          + f", {max(1, tcfg.accum_steps)} microbatch(es) of B {micro}, "
          f"{tcfg.adam_dtype} moments"
          + (", on embeds inputs" if tcfg.input_mode == "embeddings"
             else ""), flush=True)
    arch_train(tcfg, ShapeConfig(f"train_{s // 1024}k", "train", s, b),
               total, plain_check=plain_check)
    return flash_times(
        "20", f"{name}'s training shape",
        (micro, cfg.n_heads, s, cfg.head_dim),
        torch.empty(64 * 2**20, dtype=torch.int32, device="cuda"),
        causal=True, seed=20, iters=10, plain_iters=3)


def danube_arch(total: dict) -> dict:
    """h2o-danube-1.8b: full-depth prefill past its window (flash on the
    tensor-core route at D 80), the lockstep loop on its ring cache,
    training, and prefill vs decode in f32 past the window (the scalar
    route); returns the flash kernel's times at the prefill's attention
    shape and the prefill's launches by route."""
    from repro_torch.configs import registry
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.models import api
    from repro_torch.models.types import ShapeConfig

    cfg = registry.get("h2o-danube-1.8b")
    route = fa.route(torch.bfloat16, cfg.head_dim)
    if route != "mma":
        raise AssertionError(f"flash route for bf16 D {cfg.head_dim} is "
                             f"{route}; want mma")
    params = api_init(cfg)
    n_params = sum(p.numel() for p in params.parameters())
    arch_line(cfg, n_params, f"full depth ({cfg.n_layers} layers)")
    batch = api.batch_to({"tokens": np.random.default_rng(20).integers(
        0, cfg.vocab_size, (DANUBE_B, DANUBE_S))}, "cuda")
    free_card()
    torch.cuda.reset_peak_memory_stats()
    timed = flash_ops.kernel = _TimedKernel(flash_ops.kernel)
    try:
        with Launches(total) as n, torch.no_grad():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            logits = api.prefill(params, batch, cfg, device="cuda")
            end.record()
    finally:
        flash_ops.kernel = timed.module
    prefill_ms = start.elapsed_time(end)
    flash_ms = [s.elapsed_time(e) for s, e in timed.events]
    peak = torch.cuda.max_memory_allocated()
    n.expect("danube prefill", flash_attention=cfg.n_layers)
    if n.flash_routes != {"mma": cfg.n_layers, "simt": 0}:
        raise AssertionError(f"danube prefill: flash launches by route "
                             f"{n.flash_routes}; want all {cfg.n_layers} "
                             f"on mma")
    if not (logits.shape == (DANUBE_B, cfg.vocab_size)
            and torch.isfinite(logits).all()):
        raise AssertionError(f"danube prefill logits {tuple(logits.shape)}, "
                             f"finite {bool(torch.isfinite(logits).all())}")
    print(f"phase 20: {cfg.name} prefill B {DANUBE_B} x S {DANUBE_S} "
          f"(window {cfg.window} masks): {prefill_ms:.2f} ms (CUDA events) "
          f"= {DANUBE_B * DANUBE_S / prefill_ms * 1e3:.1f} tokens/s; "
          f"flash_attention launches {n.n['flash_attention']} = "
          f"{cfg.n_layers} layers, by route {n.flash_routes}; flash "
          f"{sum(flash_ms):.2f} ms of the prefill (per launch median "
          f"{statistics.median(flash_ms):.3f}, min {min(flash_ms):.3f}, max "
          f"{max(flash_ms):.3f}); logits finite, std "
          f"{logits.std().item():.4f}; peak memory {peak / 2**30:.3f} GiB; "
          f"{card_line()}", flush=True)
    del logits, batch
    free_card()

    # the bf16 gap of the kernel path against the plain path: one row
    one = {"tokens": np.random.default_rng(21).integers(
        0, cfg.vocab_size, (1, DANUBE_S))}
    with torch.no_grad():
        got = api.prefill(params, one, cfg, device="cuda")
        with plain_flash():
            want = api.prefill(params, one, cfg, device="cuda")
    gap = (got - want).abs().max().item()
    print(f"phase 20: {cfg.name} bfloat16 prefill B 1 x S {DANUBE_S}, flash "
          f"kernel vs its plain version: max abs logit diff {gap:.3e} "
          f"(logit std {want.std().item():.4f}), reported without a bound",
          flush=True)
    del got, want
    free_card()

    cache = api.init_cache(cfg, 8, DANUBE_S)
    tok = torch.as_tensor(np.random.default_rng(22).integers(
        0, cfg.vocab_size, (8, 1)), dtype=torch.int32, device="cuda")
    step_ms = []
    with Launches(total) as nd:
        for _ in range(FAMILY_DECODE_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lo, cache = api.decode(params, tok, cache, cfg)
            tok = lo.argmax(-1).to(torch.int32)[:, None]
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
    nd.expect("danube lockstep decode")
    ring = cache["layers"][0]["k"].shape[2]
    if (cache["pos"] != FAMILY_DECODE_STEPS or ring != cfg.window
            or not torch.isfinite(lo).all()):
        raise AssertionError(f"danube lockstep decode: position "
                             f"{cache['pos']}, ring {ring}, finite "
                             f"{bool(torch.isfinite(lo).all())}")
    print(f"phase 20: {cfg.name} {FAMILY_DECODE_STEPS} greedy api.decode "
          f"steps of 8 sequences on the ring cache ({ring} slots = the "
          f"window): ms per step mean {statistics.mean(step_ms[1:]):.2f} "
          f"(steps 1-{FAMILY_DECODE_STEPS - 1}; step 0 {step_ms[0]:.2f}); "
          f"no kernel on this path; {card_line()}", flush=True)
    del params, cache, lo
    free_card()

    arch_train(cfg, ShapeConfig("train_4k", "train", TRAIN_S, TRAIN_B),
               total)

    cfg2 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    params2 = api_init(cfg2)
    t0 = time.monotonic()
    err, std = prefill_vs_decode(cfg2, params2, DANUBE_CHECK_S)
    del params2
    free_card()
    if not (math.isfinite(err) and err <= 1e-3 * std):
        raise AssertionError(f"danube float32 prefill vs decode: last logits "
                             f"differ by {err} (> 1e-3 x logit std {std})")
    print(f"phase 20: {cfg.name} float32 2 layers, prefill of "
          f"{DANUBE_CHECK_S} tokens (flash, simt) vs {DANUBE_CHECK_S} decode "
          f"steps on the {cfg.window}-slot ring: last-position max abs "
          f"logit diff {err:.3e} (tol 1e-3 x logit std {std:.4f} = "
          f"{1e-3 * std:.3e}) in {time.monotonic() - t0:.1f} s", flush=True)
    times = flash_times(
        "20", "danube's prefill shape",
        (DANUBE_B, cfg.n_heads, DANUBE_S, cfg.head_dim),
        torch.empty(64 * 2**20, dtype=torch.int32, device="cuda"),
        causal=True, window=cfg.window, seed=20, iters=10, plain_iters=5)
    return dict(times, prefill_route_launches=n.flash_routes,
                prefill_ms=prefill_ms)


def whisper_train(total: dict) -> None:
    """whisper-small's ``encdec_loss`` through 2 ``train_step``s at the
    largest of B 8, 4, 2 x 4,096 frames x 448 tokens whose first try
    fits (as phase 18 chooses mamba2's batch)."""
    from repro_torch.configs import registry
    from repro_torch.models.types import ShapeConfig

    cfg = registry.get("whisper-small")
    for b in WHISPER_TRAIN_BATCHES:
        free_card()
        shape = ShapeConfig("train_4k", "train", WHISPER_FRAMES, b)
        try:
            arch_train(cfg, shape, total, plain_check=True)
            return
        except torch.cuda.OutOfMemoryError:
            print(f"phase 20: {cfg.name} training at B {b} x "
                  f"{WHISPER_FRAMES} frames does not fit; trying a "
                  f"smaller batch", flush=True)
    raise AssertionError(f"{cfg.name} training fits at none of B "
                         f"{WHISPER_TRAIN_BATCHES}")


def phase_archs() -> dict:
    """Phase 20: the five archs not yet run at their own geometry, served
    and trained at published width, and whisper's training; returns the
    launches by kernel, danube's flash times and the flash kernel's at
    each token arch's training shape."""
    t0 = time.monotonic()
    total: dict = {}
    shapes = {row[0]: token_arch(*row, total) for row in TOKEN_ARCHS}
    danube = danube_arch(total)
    whisper_train(total)
    print(f"phase 20: five archs and whisper's training in "
          f"{time.monotonic() - t0:.1f} s; launches {json.dumps(total)}; "
          f"{card_line()}", flush=True)
    return {"launches": total, "danube_flash": danube,
            "train_shapes": shapes}


# phase 22: launch/serve_traffic.py's --full workload (32 requests, seed 7,
# 500 virtual requests/s) through the engine, its page pool undersized
# (1 + 8 x 12 = 97 pages) and fully provisioned
TRAFFIC_F32_SPECS = 16             # the float32 pair's first specs
FLIP_FACTOR = 10.0


def cpu_schedule(cfg, specs, n_pages) -> dict:
    """The schedule of ``specs`` through a 1-layer float32 smoke engine on
    the host, their tokens taken into its vocabulary: with no stop token it
    depends on the requests' lengths and arrivals only."""
    from repro_torch.configs import registry
    from repro_torch.launch import serve_traffic as st
    from repro_torch.models import api

    smoke = dataclasses.replace(registry.smoke(cfg.name), n_layers=1,
                                dtype="float32")
    params = api.init_params(smoke, torch.Generator().manual_seed(0), "cpu")
    specs = [dataclasses.replace(
        s, prompt=[t % smoke.vocab_size for t in s.prompt]) for s in specs]
    return st.schedule(st.run_traffic(smoke, params, specs, st.FULL,
                                      n_pages=n_pages, device="cpu"))


def traffic_run(cfg, params, specs, n_pages, total: dict,
                capture: bool = False) -> dict:
    """``serve_traffic.run_traffic`` at the card's geometry with every
    kernel counter set to 0 just before and read just after.  Gates: each
    request finished with its ``max_new_tokens``, 0 page leaks (checked by
    ``run_traffic``), paged launches = decode steps x layers and nothing
    else, and the schedule equal to the host's (``cpu_schedule``)."""
    from repro_torch.launch import serve_traffic as st
    from repro_torch.serve.scheduler import RequestState

    free_card()
    torch.cuda.reset_peak_memory_stats()
    with Launches(total) as n:
        out = st.run_traffic(cfg, params, specs, st.FULL, n_pages=n_pages,
                             capture_logits=capture)
    out["peak"] = torch.cuda.max_memory_allocated()
    sched = st.schedule(out)
    pool = n_pages or "all"
    what = (f"phase 22: {cfg.name} {cfg.dtype}, {len(specs)} requests, "
            f"{pool} pages")
    if sched["decode_steps"] == 0:
        raise AssertionError(f"{what}: no decode step")
    n.expect(what, paged_attention=sched["decode_steps"] * cfg.n_layers)
    if len(out["requests"]) != len(specs):
        raise AssertionError(f"{what}: {len(out['requests'])} of "
                             f"{len(specs)} requests submitted")
    for r, s in zip(out["requests"], specs):
        if (r.state is not RequestState.FINISHED
                or len(r.out_tokens) != s.max_new_tokens):
            raise AssertionError(f"{what}: request {r.rid} {r.state} with "
                                 f"{len(r.out_tokens)} of "
                                 f"{s.max_new_tokens} tokens")
    t0 = time.monotonic()
    want = cpu_schedule(cfg, specs, n_pages)
    if sched != want:
        raise AssertionError(f"{what}: schedule {sched} != the host's "
                             f"{want}")
    ms, m = out["step_ms"], out["metrics"]
    print(f"{what}: {m['steps']} engine steps ({sched['steps']} drive "
          f"steps) = {m['decode_steps']} decode + {m['prefill_chunks']} "
          f"prefill chunks, {m['preemptions']} preemptions over "
          f"{sum(p > 0 for p, _ in sched['requests'])} requests, "
          f"{m['tokens_sampled']} tokens, all finished; schedule equal to a "
          f"1-layer smoke engine's on the host (its run "
          f"{time.monotonic() - t0:.2f} s); wall {out['wall_s']:.3f} s = "
          f"{m['tokens_sampled'] / out['wall_s']:.2f} tokens/s; decode-step "
          f"ms {summarize(ms['decode'])}, prefill-chunk ms "
          f"{summarize(ms['prefill'])}; virtual TTFT ms p50/p99 "
          f"{out['ttft_ms']['p50']:.1f}/{out['ttft_ms']['p99']:.1f}, ITL "
          f"{out['itl_ms']['p50']:.1f}/{out['itl_ms']['p99']:.1f}; peak "
          f"memory {out['peak'] / 2**30:.3f} GiB; paged launches "
          f"{n.n['paged_attention']} = {m['decode_steps']} x {cfg.n_layers}; "
          f"page leaks 0; {card_line()}", flush=True)
    out["schedule"] = sched
    return out


def first_divergence(a: list, b: list) -> int | None:
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)


def flip_gaps(pressured: list, plain: list) -> list:
    """Each request whose float32 streams differ between the two runs: (rid,
    position, temperature, the plain run's top-two gap there, the largest
    logit difference at the positions before it).  The gap is that of the
    scores the sampler takes the argmax of, in logits: at temperature T,
    logits / T + the request's Gumbel noise for that token, times T."""
    from repro_torch.models import paged_lm
    from repro_torch.serve.engine import _key_data

    flips = []
    for a, b in zip(pressured, plain):
        i = first_divergence(a.out_tokens, b.out_tokens)
        if i is None:
            continue
        la, lb = np.stack(a.logits_log), np.stack(b.logits_log)
        noise = float(np.abs(la[:i] - lb[:i]).max()) if i else 0.0
        t = b.params.temperature
        scores = torch.from_numpy(lb[i]).double()
        if t > 0:
            scores = scores / t + paged_lm._gumbel(
                _key_data(b.params.seed, i), scores.numel(), "cuda"
            ).double().cpu()
        top = torch.topk(scores, 2).values
        gap = float(top[0] - top[1]) * (t if t > 0 else 1.0)
        flips.append((b.rid, i, t, gap, noise))
    return flips


def phase_traffic(cfg) -> dict:
    """Phase 22: Poisson traffic through the engine at full width, the page
    pool undersized (preemption, re-prefill, page reuse) and fully
    provisioned; bfloat16 at full depth, then float32 on the first
    ``TRAFFIC_F32_SPECS`` specs with the logits captured.  Returns the
    paged launches."""
    from repro_torch.launch import serve_traffic as st
    from repro_torch.serve import ServeEngine

    t0 = time.monotonic()
    total: dict = {}
    specs = st.workload(cfg, st.FULL)
    n_pages = st.pressure_pages(st.FULL, 8)
    print(f"phase 22: launch/serve_traffic.py's --full workload: "
          f"{len(specs)} requests (seed 7, 500 virtual requests/s; prompts "
          f"{min(len(s.prompt) for s in specs)}-"
          f"{max(len(s.prompt) for s in specs)} tokens, outputs "
          f"{min(s.max_new_tokens for s in specs)}-"
          f"{max(s.max_new_tokens for s in specs)}; "
          f"{sum(s.temperature > 0 for s in specs)} at temperature 0.8) on "
          f"8 slots, max_len 512, pages of 16, chunks of 64; pools of "
          f"{n_pages} pages (pressured) and 257 (all)", flush=True)
    params = api_init(cfg)
    warm = ServeEngine(cfg, params, slots=8, max_len=512, page_size=16,
                       prefill_chunk=64, n_pages=n_pages)
    warm.submit(list(range(1, 80)), max_new_tokens=4)
    warm.run()
    warm.assert_no_leaks()
    del warm
    bf16 = {pool: traffic_run(cfg, params, specs, pool, total)
            for pool in (n_pages, None)}
    del params
    pressed, plain = bf16[n_pages], bf16[None]
    if pressed["metrics"]["preemptions"] == 0:
        raise AssertionError("phase 22: the pressured bfloat16 run did not "
                             "preempt")
    diverged = [(a.rid, first_divergence(a.out_tokens, b.out_tokens))
                for a, b in zip(pressed["requests"], plain["requests"])
                if a.out_tokens != b.out_tokens]
    preempted = [r.rid for r in pressed["requests"] if r.preemptions]
    extra = (pressed["metrics"]["prefill_chunks"]
             - plain["metrics"]["prefill_chunks"])
    print(f"phase 22: bfloat16 streams pressured vs all pages: "
          f"{len(specs) - len(diverged)}/{len(specs)} equal (reported, no "
          f"gate: a re-prefill writes the generated tokens' K/V through "
          f"the 64-row prefill GEMMs, first written by 8-row decode steps); "
          f"first divergence (request, token) {diverged}; preempted "
          f"requests {preempted}; preemption cost {extra} extra prefill "
          f"chunks and {pressed['wall_s'] - plain['wall_s']:.3f} s of wall",
          flush=True)

    f32_cfg = dataclasses.replace(cfg, dtype="float32")
    f32_specs = specs[:TRAFFIC_F32_SPECS]
    free_card()
    params = api_init(f32_cfg)
    # the full pool first here, the pressured one first in bf16: a pair's
    # second run is slower in both orders or the pool sets the step time
    f32 = {pool: traffic_run(f32_cfg, params, f32_specs, pool, total,
                             capture=True) for pool in (None, n_pages)}
    del params
    free_card()
    if f32[n_pages]["metrics"]["preemptions"] == 0:
        raise AssertionError("phase 22: the pressured float32 run did not "
                             "preempt")
    reqs = [f32[pool]["requests"] for pool in (n_pages, None)]
    noise = max((float(np.abs(np.stack(a.logits_log)
                              - np.stack(b.logits_log)).max())
                 for a, b in zip(*reqs) if a.out_tokens == b.out_tokens),
                default=0.0)
    flips = flip_gaps(*reqs)
    for rid, i, t, gap, before in flips:
        ok = gap < FLIP_FACTOR * before
        print(f"phase 22: float32 request {rid} (temperature {t}) flips at "
              f"token {i}: the unpressured top-two gap {gap:.3e} vs "
              f"{FLIP_FACTOR:g} x the largest logit difference before it "
              f"{before:.3e}: {'accepted' if ok else 'REFUSED'}", flush=True)
        if not ok:
            raise AssertionError(f"phase 22: float32 request {rid} flips at "
                                 f"token {i} on a gap of {gap:.3e}")
    f32_extra = (f32[n_pages]["metrics"]["prefill_chunks"]
                 - f32[None]["metrics"]["prefill_chunks"])
    print(f"phase 22: float32 streams pressured vs all pages, "
          f"{len(f32_specs)} requests (greedy and sampled): "
          f"{len(f32_specs) - len(flips)}/{len(f32_specs)} equal, "
          f"{len(flips)} accepted flips; largest logit difference over the "
          f"equal streams {noise:.3e}; preemption cost {f32_extra} extra "
          f"prefill chunks", flush=True)
    print(f"phase 22: Poisson traffic in {time.monotonic() - t0:.1f} s; "
          f"launches {json.dumps(total)}; {card_line()}", flush=True)

    return {"launches": total["paged_attention"]}


def api_init(cfg):
    """Full-width random weights drawn on the card from seed 0."""
    from repro_torch.models import api

    return api.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           "cuda")


def main() -> int:
    start = time.monotonic()
    if sys.argv[1:2] == ["--dryrun-cells"]:
        return dryrun_cells(sys.argv[2])
    if sys.argv[1:2] == ["--sp-ranks"]:
        return sp_ranks(sys.argv[2])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.cgra import sweep

    # phase 16's sweep workers fork now, before anything initializes CUDA
    workers = len(os.sched_getaffinity(0))
    pool = sweep.ensure_pool(workers)
    print(f"phase 16 (set up before phase 1): "
          + (f"{workers} sweep workers forked" if pool is not None else
             "one CPU: the sweep runs inline"), flush=True)
    try:
        return phases(sweep, workers, start)
    finally:
        sweep.shutdown_pool()


def phases(sweep, workers: int, start: float) -> int:
    """Phases 1-22 (the sweep's pool is already forked)."""
    from repro_torch.configs import registry
    from repro_torch.kernels import _build

    card = card_line()
    print(f"phase 1: card {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"phase 1: matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32}", flush=True)

    t0 = time.monotonic()
    report = _build.build()
    print(f"phase 2: built {sorted(report)} in {time.monotonic() - t0:.2f} s",
          flush=True)
    for name, log in report.items():
        kernel = "?"   # the entry function, as ptxas names it (mangled)
        for line in log.splitlines():
            if "Compiling entry function" in line:
                kernel = line.split("'")[1] if "'" in line else line.strip()
            elif "registers" in line or "spill" in line or "C751" in line:
                print(f"phase 2: {name}: {kernel}: {line.strip()}")

    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")
    kstats = phase_kernel(flush)
    del flush

    cfg = registry.get("qwen2-1.5b")
    t0 = time.monotonic()
    params = api_init(cfg)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    print(f"phase 4: {cfg.name} at full width ({cfg.n_layers} layers, d "
          f"{cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads}, d_head "
          f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
          f"{cfg.dtype}): {n_params} random parameters drawn in "
          f"{time.monotonic() - t0:.2f} s", flush=True)
    launches = phase_serve(cfg, params)["paged_attention"]
    phase_reads(cfg, params)
    del params

    from repro_torch.core.cgra import cache_grid
    t0 = time.monotonic()
    inp = runahead_inputs()
    # reconfig.reconfigure's default profiling grid for presets.RECONFIG:
    # ways 0..32 (4 caches x 8 ways) x lines (16, 32, 64, 128), 512 B ways
    grid = cache_grid.ConfigGrid.build(512, range(33), (16, 32, 64, 128))
    print(f"phase 6: OGBN-Arxiv-shaped inputs ({ARXIV_NODES} x "
          f"{ARXIV_FEATURES} table; power-law graph of {ARXIV_EDGES} edges, "
          f"seed 0, alpha 1.5; gather streams cut to n={GATHER_N}; "
          f"{len(grid)} cache configurations) made in "
          f"{time.monotonic() - t0:.2f} s", flush=True)
    stats = phase_runahead(inp, grid)
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")
    times = phase_runahead_times(inp, grid, stats, flush)
    del inp

    flash = phase_flash(flush)
    del flush
    torch.cuda.empty_cache()
    flash_launches = phase_train(cfg)
    torch.cuda.empty_cache()

    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")
    moe_times = phase_moe_kernels(flush)
    ssd = phase_ssd_kernel(flush)
    del flush
    torch.cuda.empty_cache()

    dbrx = dataclasses.replace(registry.get("dbrx-132b"),
                               n_layers=DBRX_LAYERS)
    t0 = time.monotonic()
    params = api_init(dbrx)
    torch.cuda.synchronize()
    print(f"phase 11: {dbrx.name} at full width, {dbrx.n_layers} of its 40 "
          f"layers (d {dbrx.d_model}, heads {dbrx.n_heads}/"
          f"{dbrx.n_kv_heads}, d_head {dbrx.head_dim}, {dbrx.n_experts} "
          f"experts top-{dbrx.top_k} of d_ff {dbrx.d_ff}, vocab "
          f"{dbrx.vocab_size}, {dbrx.dtype}): "
          f"{sum(p.numel() for p in params.parameters())} random parameters "
          f"drawn in {time.monotonic() - t0:.2f} s", flush=True)
    moe_launches = phase_serve(dbrx, params, phase="11")
    phase_moe_logits(dbrx, params)
    del params
    torch.cuda.empty_cache()
    phase_moe_logits_f32(dbrx)
    torch.cuda.empty_cache()
    ssd_launches = phase_mamba(registry.get("mamba2-2.7b"))
    torch.cuda.empty_cache()
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")
    whisper_launches, whisper_flash = phase_whisper(
        registry.get("whisper-small"), flush)
    torch.cuda.empty_cache()
    reconf = phase_reconfig(flush)
    alloc = phase_allocator(flush)
    del flush
    swept = phase_sweep(sweep, workers, reconf)
    torch.cuda.empty_cache()
    with subprocesses() as started:
        with one_rank_mesh() as rules:
            sharded = phase_sharded(cfg, rules)
            free_card()
            families = phase_families(rules)
            free_card()
            cells = started(start_dryrun_cells())
            sp_started = started(start_sp_ranks())
            dry = phase_dryrun(cfg, rules)
        fam = families["launches"]
        free_card()
        dry["cells"] = phase_dryrun_cells(cells)
        p19 = dry["launches"]
        archs = phase_archs()
        p20 = archs["launches"]
        free_card()
        phase_sp_ranks(sp_started)
    p22 = phase_traffic(cfg)["launches"]

    kernels = [{
        "name": "paged_attention", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES,
        "launches": launches + sharded["paged"] + fam["paged_attention"]
        + p20["paged_attention"] + p22,
        "launches_by_phase": {"4": launches, "17": sharded["paged"],
                              "18": fam["paged_attention"],
                              "20": p20["paged_attention"], "22": p22},
        **kstats}]
    replaces = {"runahead_gather": f"{GATHER_REPLACES}:91",
                "pipelined_gather": f"{GATHER_REPLACES}:117",
                "gather_bag": f"{GATHER_REPLACES}:177",
                "cache_grid_scan": GRID_REPLACES}
    # phase 15's launches and numbers beside phase 6-7's
    later = {"runahead_gather": (alloc["launches"]["runahead_gather"],
                                 alloc["err"], "allocator_gather", {
                                     k: alloc[k] for k in (
                                         "ms", "eager_ms", "kernel_route",
                                         "route_ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms", "depth",
                                         "block_rows", "depth2_ms")}),
             "cache_grid_scan": (reconf["launches"]
                                 + alloc["launches"]["cache_grid_scan"],
                                 reconf["err"], "reconfig_profile", {
                                     "window_8192": reconf["profile"],
                                     "window_none": reconf["profile_whole"]})}
    # phase 16's launches (reconfigure_cached, cold) beside phase 6 and 15's
    for name, where in replaces.items():
        entry = {
            "name": name, "route": "cuda",
            "source": GRID_SOURCE if name == "cache_grid_scan"
            else GATHER_SOURCE,
            "replaces": where, "launches": stats["launches"][name],
            "max_abs_err": stats["errs"][name], **times[name]}
        if name == "runahead_gather":
            entry["route_launches"] = {"6": stats["routes"],
                                       "15": alloc["routes"]}
        if name in later:
            n15, err15, key, extra = later[name]
            entry["launches_by_phase"] = {"6": entry["launches"], "15": n15}
            entry["launches"] += n15
            if name == "cache_grid_scan":
                entry["launches_by_phase"]["16"] = swept["cold_launches"]
                entry["launches"] += swept["cold_launches"]
                entry["sweep_service"] = swept
            entry["max_abs_err"] = max(entry["max_abs_err"], err15)
            entry[key] = extra
        kernels.append(entry)
    kernels.append({
        "name": "flash_attention", "route": "cuda", "source": FLASH_SOURCE,
        "replaces": FLASH_REPLACES,
        "launches": flash_launches + whisper_launches + sharded["flash"]
        + fam["flash_attention"] + p19["flash_attention"]
        + p20["flash_attention"],
        "launches_by_phase": {"9": flash_launches, "14": whisper_launches,
                              "17": sharded["flash"],
                              "18": fam["flash_attention"],
                              "19": p19["flash_attention"],
                              "20": p20["flash_attention"]},
        **flash, "whisper_encoder": whisper_flash,
        "danube_flash": archs["danube_flash"],
        "phase20_training_shapes": archs["train_shapes"],
        "custom_op_us": dry["overhead"]["flash_attention"]})
    for name, line in (("moe_dispatch", 45), ("moe_combine", 106)):
        kernels.append({
            "name": name, "route": "cuda", "source": MOE_SOURCE,
            "replaces": f"{MOE_REPLACES}:{line}",
            "launches": moe_launches[name] + fam[name] + p19[name]
            + p20[name],
            "launches_by_phase": {"11": moe_launches[name], "18": fam[name],
                                  "19": p19[name], "20": p20[name]},
            **moe_times[name], "custom_op_us": dry["overhead"][name]})
    kernels.append({
        "name": "ssd_scan", "route": "cuda", "source": SSD_SOURCE,
        "replaces": SSD_REPLACES,
        "launches": ssd_launches + fam["ssd_scan"] + p19["ssd_scan"],
        "launches_by_phase": {"13": ssd_launches, "18": fam["ssd_scan"],
                              "19": p19["ssd_scan"]},
        **ssd, "custom_op_us": dry["overhead"]["ssd_scan"]})
    print(f"phases 1-22 passed in {time.monotonic() - start:.1f} s",
          flush=True)
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
