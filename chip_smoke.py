#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    PYTHONPATH=src python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. Setup: needs CUDA; turns TF32 off for matmuls and cuDNN; builds the
   CUDA kernels from ``src/repro_torch/csrc`` (into ``build/kernels``)
   and prints the build time, each kernel's register and spill report
   (and any ptxas warning that it serialised wgmma instructions) and the
   card's name and power limit (``nvidia-smi``).
2. Kernels: each CUDA kernel against its plain PyTorch version on the
   card, at the main path's shapes and at edge cases, with the stated
   tolerance; prints kernel, plain and library-call times and the
   least time the card could take (bytes over the memory rate or flops
   over the f32 rate, whichever is larger). The aggregation kernel (K1,
   K3, and K4 for each wire dtype int8, bf16, f32) runs every case of
   AGG_CASES as a one-leaf launch, then the four CNN leaves of an edge
   hop (M=5, H=50) and of the cloud hop (M=1 over 5 edges) as one
   launch each (the hop lines), and K1 and int8 K4 over the sweep's
   edge and cloud hops (4 lanes x the four leaves, one launch each):
   graph-replay, eager and cold-L2 times (COLD_BYTES written before
   each call, each call timed alone) beside the plain version, one
   torch.bmm a leaf and the bound. Then K6, the CNN's fused conv ->
   ReLU -> max-pool (``conv_pool_phase``), at CONV_CASES (FashionMNIST's
   two blocks over 50 and 200 devices, CIFAR's conv 1 over 50, x 700
   samples): y, idx, dW and dx against the plain block, CUDA-graph,
   eager and plain ms and the share of the bound.
3. Main paths: one Table-I world at full width (N=100 devices, M=5
   edges, D_n in [400, 700], the paper CNN of 457 532 bytes, H=50,
   K=10, IKC scheduling, geo assignment, 200-step allocation) through
   ``HFLFramework``, with the kernels on:
   a. uncompressed: the Algorithm-2 clustering and 2 rounds;
   b. the int8 codec for 2 rounds from the same init and clustering
      (same cohorts): msg_bits must fall by more than 3.9x and T_i, E_i
      must fall against the uncompressed rounds;
   c. one bf16_delta round and one topk round;
   d. ``aggregate_pytrees`` over H copies of the trained params with
      round 2's normalised edge panel.
   Before each path every launch counter is zeroed; just after it they
   are read and must match the counts the path implies: one
   aggregation launch a hop over every leaf, Q + 1 = 6 a round (K1 12
   over a, K4 12 over b, 6 for each round of c), K3 1 for d, K2 480;
   K6 a round 2 forward, 2 dW and 1 dx launches for each of the Q*L =
   25 local steps and 2 forward launches for each of the evaluation's
   4 batches (116, 100 and 50 over a and b, half that over each of c).
   Every phase below that trains or evaluates the CNN expects K6's
   launches the same way (``k6_launches``; the async engine's L steps a
   dispatch from its records). Every output must be finite.
4. Oracle rounds, from forks of the same state: a third uncompressed
   round with the kernel aggregation against the plain matmul
   (``agg_kernel=False``; T_i and E_i equal, params within PARAM_TOL)
   and against ``engine="sequential"`` (T_i/E_i to rtol 1e-5, params
   within PARAM_TOL); a third int8 round with the kernel against the
   plain decode-and-matmul (same noise; T_i and E_i equal; params and
   both error-feedback residuals held by the share of elements that
   differ, within two int8 quanta; the shares and the fraction of
   differing q printed).
5. Assignment, the paper's methods, on the same world and on round
   1's IKC cohort (H=50):
   a. HFEL (``HFELAssigner(sp)``: HFEL-100/300, K=16, 200-step solves):
      wall time and J, which must be below the J of the geo (nearest
      edge) assignment of the same cohort, both priced by one 200-step
      solve; ``assign_batch`` over 4 populations (this one and seeds
      1-3) must equal 4 separate ``assign`` calls (assignments, J to
      rel 1e-6);
   b. D3QN training (Algorithm 5) at the trainer's full width
      (``D3QNTrainer(sp, H=50, hidden=256)``: M=5, HFEL-100/300
      targets, ``alloc_steps=120``, ``wave_size=8``), D3QN_WAVES=2
      waves (16 episodes; the episode count is the only cut): losses finite,
      params moved, seconds a wave split into target search and
      updates, episodes/s; then one update wave on the card against the
      same wave run on the CPU from the same params and minibatches
      (losses within UPDATE_LOSS_RTOL, every param leaf within
      UPDATE_ATOL);
   c. one ``HFLFramework`` round each with ``assigner="hfel"`` and
      ``assigner="drl"`` (the trained params), kernels on and the
      clustering's labels injected: round 1's cohort again, K1 6
      launches a round and no K2; the assign phase's seconds
      (``seconds["assign"]``, host clock) of geo, DRL and HFEL on that
      cohort.
6. Where the time goes: the setup once more (without PyTorch's one-off
   imports) and a fourth uncompressed round under ``torch.profiler``:
   device busy time against wall time, and the kernels that took the
   most.

The HFL frameworks are then released, and the sweep runs on the same
world:

7. The multi-lane sweep, ``SweepRunner`` over SWEEP_LANES=4 lanes of the
   Table-I world (lane seeds 0-3, H=50, IKC schedulers built by
   ``build_scheduler(use_kernel=True)``, 200-step allocations,
   ``agg_kernel=True``), the launch counters zeroed before and checked
   after each path:
   a. a 3-round geo host loop: K1 6 launches a round for all lanes (18,
      not 72), K2 4 clusterings x 480; wall a round, lane-rounds/s and
      peak memory (must stay below 70 GB; above it the phase would need
      ``lane_chunk``), then one more round under ``torch.profiler``;
   b. lane 0 of a 2-round kernel sweep against ``HFLFramework`` on that
      world alone, from lane 0's init and clustering: T_i and E_i equal,
      params within PARAM_TOL;
   c. that kernel sweep against a plain-matmul one (``agg_kernel=
      False``): T_i and E_i equal, params within PARAM_TOL;
   d. ``run(fused=True)`` against ``fused="oracle"``, geo for 2 rounds
      and hfel for 1 (the round cut for time): the fused window
      (``sweep_scan``) runs under ``torch.cuda.set_sync_debug_mode(
      "error")``, one window for the fused run and one a round for the
      oracle, records equal, params within PARAM_TOL; the fused HFEL
      search (HFEL-40/80, K=16, 4 lanes) inside each hfel round is timed
      by CUDA events;
   e. a 2-round int8 sweep: K4 6 launches a round for all lanes, 12.

Then the dense decoder's serving path runs (chatglm3-6b, f32 weights
drawn on the card from a seed, bf16 compute):

8. Flash attention: the kernel against its plain version at the
   prefill's shape (B=2, S=4096, 32 q heads, 2 KV heads, d=128, bf16)
   and at edge cases (ragged S, windows, head dims 16/48/80, MHA, f32,
   layouts that TMA cannot read as they lie, a 16 384-token sequence),
   each on the kernel its layout selects (wgmma, wgmma_staged or
   tf32x3: checked), timed at the prefill's shape against the bound,
   the kernel's own floor (1.5x the bound: P V runs twice, P's bf16 head
   and remainder), the plain version and PyTorch's SDPA; the same at the
   prefill's shape on wgmma_staged (the wgmma kernel on copies that TMA
   can read, the copies' time included and printed on its own), with
   v's base one element off (FA_SHIFTED) and with q, k, v sliced out of
   132-wide buffers (FA_STAGED), each bit for bit the output of the
   same kernel on clones, their library time SDPA's on clones (the
   clones' time printed beside it), and the f32
   (tf32x3) path on f32 inputs (FA_F32; its bound three TF32 products a
   pair at the TF32 rate, the f32 FMA rate's figure printed beside it).
9. A': two layers at full width in f32: the prefill through the kernel
   (2 launches, tf32x3) against the plain prefill within LM_F32_TOL of the
   largest logit, and the serving loop's teacher-forced decode logits
   against the kernel prefill of the same prompt, within the same.
10. A: all 28 layers, bf16: the prefill through the kernel (28
   launches, every one on the wgmma kernel) against the plain prefill (0), by the largest difference
   relative to the largest logit and by the share of positions whose
   argmax agrees (limits LM_BF16_REL, LM_BF16_AGREE); both against an
   f32 plain prefill, printed.
11. B: the ``serve_lm`` loop on the full model (batch 8, prompt 32, 64
   greedy tokens; no kernel launch), its tokens in range, its
   teacher-forced logits against the kernel prefill of the prompt (the
   same limits as A); prefill and decode seconds and tokens/s. Then one
   kernel prefill and one decode step under ``torch.profiler``.
12. The event-driven async engine (``AsyncHFLEngine``) and the streaming
   serve CLI, which run no kernel (the reference's async path has no
   Pallas call), on the Table-I world at full CNN width (N=100, M=5,
   D_n in [400, 700], H=50, fedavg cohort, geo assignment, 200-step
   allocations), the launch counters zeroed before a and read after c
   (every count 0):
   a. one always-on async round against ``round_step_core`` on the same
      cohort and assignment from the same params: b and f equal, T_i
      and E_i to rtol 1e-5, params within PARAM_TOL, Q·H = 250 updates,
      no stale update and no forced flush; wall, dispatches;
   b. ASYNC_ROUNDS rounds of that world under the serve CLI's
      ``stationary`` availability (10 % offline at t=0, sessions of
      900 s, gaps of 120 s, 20 % 4x stragglers) with 5-slot buffers:
      n_updates <= Q·H, aborted tasks and wasted energy >= 0, the
      virtual clock moving forward; dispatches and wall a round;
   c. ``run_serve`` at the CLI's defaults (40 devices, 5 edges, H=20,
      stationary, 3 rounds) checkpointing every round into a temporary
      directory: one JSON line a round, the last checkpoint restored
      bit for bit equal to the engine's params; then one int8 round;
   d. one more always-on round under ``torch.profiler``.
13. The registry's decoders as HFL sequence payloads on the Table-I
   world (``seqcls_syn`` 20 000/2 000 with ``vocab_size = min(257,
   smoke vocab)``, D_n in [400, 700], H=50, K=10, IKC, geo, 200-step
   allocations, ``agg_kernel=True``, ``use_kernel=True``): for each
   arch of ``HFL_SMOKE_ARCHS`` but the CNN (mistral-nemo, mamba2,
   qwen3-moe smoke configs in f32), the clustering and one round, K1
   ceil(n/64) launches a hop over its n leaves and K2 480, every output
   finite; qwen3-moe's second round against ``agg_kernel=False`` (T_i,
   E_i equal, params within PARAM_TOL); mamba2's 2-lane ``SweepRunner``
   round (one lane at a time: a lane's vmapped training holds ~50 GB),
   ``fused=True`` against ``"oracle"`` (records equal, params within
   PARAM_TOL). Wall and phase seconds of each round.
14. The LM families, f32 weights drawn on the card, bf16 compute:
   a. mamba2-2.7b at full width and depth (64 layers): a 2-layer f32 A'
      with the ``serve_lm`` teacher-forced decode against the prefill
      (LM_F32_TOL); ``ssd_chunked`` against ``ssd_reference`` on layer
      0's own f32 inputs (SSD_SEQ tokens, SSD_REL); the 64-layer prefill
      at B=2, S=4096 (16 chunks of 256), profiled; ``serve_lm`` (batch
      8, prompt 32, 64 tokens).
   b. qwen3-moe-235b-a22b at full width, MOE_LAYERS=4 of its 94 layers
      (the depth is the only cut): a 2-layer f32 A' (kernel vs plain
      prefill, decode vs prefill, LM_F32_TOL, on the positions before
      each sequence's first token that lost a choice or was routed
      differently: capacity is per forward, so decode and prefill drop
      different tokens); the 4-layer bf16 prefill (B=2, S=2048) through
      K5 (4 launches, all wgmma) against the plain prefill, and the
      ``serve_lm`` loop's decode against the kernel prefill, each with
      the second run replaying the first one's routing
      (``forced_routing``: in bf16 near-ties of the 128 router
      probabilities flip experts between any two runs) and held by
      LM_BF16_REL and LM_BF16_AGREE; drops and flips of the free runs
      printed; one profiled prefill.
   c. jamba at its smoke config (attention + SSM + MoE; its full width
      needs four cards): kernel vs plain prefill in f32 (2 K5 launches,
      tf32x3) and in bf16 (wgmma, routing replayed), and the f32 decode
      with KV and SSM caches side by side against the prefill.
15. LM training (``launch.steps.make_train_step`` and
   ``make_hfl_train_step``, ``launch.train``), no kernel (the plain
   attention: K5 has no backward):
   a. chatglm3-6b at full width, TRAIN_LAYERS=4 of its 28 layers,
      batch TRAIN_BATCH=8 x 4096 (train_4k's length), 8 microbatches,
      bf16 compute, adam: TRAIN_STEPS=4 steps on the
      ``token_batch_iterator`` stream (losses finite, every leaf moved),
      then step wall, tokens/s, peak memory, a profiled step's device
      busy share and the model-flops share 6·N·tokens/(t·989e12); one
      step from one state and batch with remat on (the path's own),
      off (equal, REMAT_*; the remat peak lower) and at 2 microbatches
      (MB_*: loss, mean gradient in norm, params after adam);
   b. the two-tier step on TRAIN_PODS=2 replicas (8 sequences each,
      SGD): the pods differ after a step without the cloud sync and,
      after one with it (a device bool), are equal and the mean of the
      same step's unsynced pods (HFL_REL);
   c. one smoke-config f32 step per family (dense, vlm, audio, moe,
      ssm, hybrid) and one adafactor step (``BIG_MODEL_PARAMS`` patched
      in memory) on the card against the CPU, at the CPU parity tests'
      tolerances;
   d. ``launch.train.main`` on the card (smoke), checkpointing every 2
      steps, then a run that resumes from step 4;
   e. no launch counter moved in a-d; ``make_train_step(impl="kernel")``
      raises, and K5 raises on CUDA inputs that require grad.
16. The multi-device layer (``launch.mesh``, ``parallel``, the mesh
   steps, ``SweepRunner(shard=True)``) on the one card:
   a. a one-rank NCCL group (``file://`` store) and ``sweep_mesh()``:
      ``SweepRunner(shard=True)`` over phase 7's SWEEP_LANES lanes, the
      IKC clustering (K2 1 920, its labels equal to phase 7a's) and 2
      host rounds (K1 12), then 2 fused rounds (K1 12), each held bitwise to
      phase 7's ``shard=False`` runs (7b, 7d geo) in records and params;
      wall a round next to phase 7a's;
   b. two ranks of this script (``--lanes-child``) sharing the card over
      a gloo host group: MESH_LANES=3 lanes padded to 4 (one dead lane),
      2 host rounds with phase 7a's labels, against phase 7b's lanes 0-2
      (iters and H exact, T_i/E_i rtol 1e-4 atol 1e-6, accuracy within
      SHARD_ACC_SAMPLES test samples: tests/test_sweep_shard.py's); wall
      a round and each rank's peak memory;
   c. ``make_train_step(cfg, mesh=make_debug_mesh())`` on phase 15's
      chatglm3-6b (full width, TRAIN_LAYERS layers, B=8 x 4096, 8
      microbatches, bf16, adam, remat) against the unsharded step from
      the same init and batch (held on the host; REMAT_* limits), then
      step wall, tokens/s and peak next to phase 15a's: DTensor's cost
      on one rank; no kernel;
   d. ``make_prefill_step(full, "kernel", mesh=...)`` on chatglm3-6b at
      full width and depth, B=2 x 4096: K5 through ``local_map``, 28
      ``wgmma`` launches, logits bitwise equal to the unsharded kernel
      prefill; wall next to it;
   e. with two or more cards, two ranks (``--steps-child``) on a (1, 2)
      NCCL mesh: chatglm3's smoke train step and kernel prefill against
      one rank's; with one card a line says that they were not run.
17. The examples and the dry run. The dry runs of b and c start first,
   each a process of its own on the host (a ``fake`` group must not meet
   phase 16's NCCL group; they need no card), and run while a does:
   a. the examples on the card, through their ``main``, each with the
      launch counters zeroed before and checked after and its lap
      printed: ``quickstart_torch`` at full size (40 devices, IKC K=10,
      up to 6 rounds: K1 Q + 1 = 6 a round run, K2 480);
      ``assignment_demo_torch --H 20`` (geo's and HFEL-100/300's J
      printed, HFEL's at most geo's; no launch);
      ``train_hfl_e2e_torch`` with E2E_ARGS, a depth cut (2 of 8 rounds,
      8 of 80 D3QN episodes: K1 6 a round of both frameworks, K2 480);
      ``model_zoo_launcher_torch --smoke`` (K1 or, for the int8 and
      top-k jobs, K4 ceil(n/64) launches a hop over a payload's n
      leaves, K2 480 for the IKC job). Over these four, every launch of
      K1/K4 and every K2 call is held against its plain version on the
      same inputs at phase 2's tolerances (``HeldToPlain``), every
      counted launch must have been held, and the aggregation launches
      are tallied by entry: K4's int8 launches must be the int8 job's
      and its f32 launches the top-k job's. Then
      ``serve_demo_torch --smoke``: the serve CLI in a process of its
      own on the card, whose launches are not counted;
   b. ``python -m repro_torch.launch.dryrun`` at full width: chatglm3-6b
      x train_4k on 16x16 (256 fake ranks) and ``--hfl-step`` on
      2x16x16 (512): each record's per-rank argument, output and temp
      bytes, flops and collectives printed; the HFL step must all-reduce
      over ``pod``;
   c. the dry run of phase 16c's train step on a one-rank fake group
      (``--dryrun-child``): its argument bytes must equal what 16c held
      on the card (params, moments, batch), and its predicted peak
      (argument + temp bytes) is printed beside 16c's measured peak.
Each phase prints its peak device memory.

The line before the last is a JSON object with one entry per kernel
(the decode-aggregate kernel once per wire dtype; the aggregation
kernels' times from their edge hop line; K1's and int8 K4's entries
also carry the sweep's edge hop and their launches in phases 7a and 7e,
K1's the sweep's figures; K1's and K2's the launches of phase 13 by
arch; K5's the launches of phases 14 and 15 and the f32 path's row;
K1's, K2's and K5's the launches of phase 16, whose K5 launches also
count in K5's ``launches``; K1's, K2's and int8 and f32 K4's those of
phase 17a, K4's by the entry launched; each ``max_abs_err`` also covers
phase 17a's launches; K6's the launches of 3a by kernel); the last
line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import gc
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

AGG_TOL = 1e-5          # |kernel - plain| <= AGG_TOL * (1 + |plain|)
DIST_TOL = 1e-5         # |kernel - plain| <= DIST_TOL * (max|plain| + |plain|)
PARAM_TOL = 1e-4        # kernel vs plain-matmul round: max |Δparam|
# int8 kernel vs plain-decode round: at most FLIP_SHARE of the elements
# of the params and of each error-feedback residual may differ by more
# than FLIP_ATOL, none by two int8 quanta. The two aggregations differ by
# ~1e-8, which training grows to ~1e-7 (below FLIP_ATOL), but a flipped q
# moves its residual by one scale (~1e-4) and its edge model element by
# ~scale/10 (> FLIP_ATOL): with ~1e-3 of q flipped per hop, Q=5 hops and
# ~10 devices an edge, up to 5 x 10 x 1e-3 = 5e-2 of the elements can
# see a flip. A wrong aggregation moves nearly all of them.
FLIP_ATOL, FLIP_SHARE = 1e-5, 5e-2
# one D3QN update wave (8 Adam steps, hidden 256) on the card against the
# same wave on the CPU: both f32, summed in other orders. Two H100 runs
# of this check read a max param difference of 1.19e-7 (no param off by
# more than 1e-5) and losses equal to ~1e-7 relative; each leaf is held
# to 1e-5, the card test's limit at hidden 16, and a wrong gradient in
# any leaf (v_head's 257 elements included) moves it by ~lr = 1e-3.
UPDATE_LOSS_RTOL, UPDATE_ATOL = 1e-4, 1e-5
F32_FLOPS = 67e12       # H100/H200 SXM f32 rate outside the tensor cores
# K6 (conv -> ReLU -> max-pool) at the CNN blocks the benchmark runs,
# (tag, H, C, O, groups, dx): FashionMNIST's two over the round's H = 50
# devices and the sweep's 4 lanes x 50, CIFAR's conv 1 over 50; D_max =
# 700 samples a device; dx where the block's input needs a gradient
# (conv 2's, a pooled activation; conv 1's is data). Forward to AGG_TOL
# of the plain block (the kernel sums its 25*C taps in another order
# than cuBLAS); dW and dx to CONV_GRAD_TOL of the plain backward's
# largest value; idx equal wherever no window has a near-tie, its top
# two conv outputs (or its top one and 0) within CONV_TIE (the
# tolerance of tests/test_torch_cuda.py's K6 tests).
CONV_CASES = (("fmnist-conv1", 28, 1, 15, (50, 200), False),
              ("fmnist-conv2", 12, 15, 28, (50, 200), True),
              ("cifar-conv1", 32, 3, 15, (50,), False))
CONV_SAMPLES = 700
CONV_GRAD_TOL, CONV_TIE = 1e-4, 5e-5
EVAL_BATCH = 512        # evaluate_in_batches' and sweep_eval's batch
BF16_FLOPS = 989e12     # H100/H200 SXM bf16 tensor-core rate, dense
TF32_FLOPS = 495e12     # H100/H200 SXM TF32 tensor-core rate, dense
# flash attention vs its plain version: f32 to 2e-5 (the reference's own
# kernel-vs-oracle figure: the kernel scales q before the dot, the plain
# version divides the scores); bf16: both compute in f32 from the same
# inputs (the kernel's P enters its tensor-core product as two bf16
# parts, ~2^-16 apart from f32) and round once, so they differ by at most
# one bf16 ulp of the value (2^-7 relative), plus 1e-5 for f32 noise on
# outputs near zero
FA_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (2 ** -7, 1e-5)}
FA_MAIN = ("prefill", 2, 4096, 32, 2, 128, 0, "bfloat16")
# the wgmma_staged path (copies TMA can read of the tensors it cannot,
# then the wgmma kernel) timed at the prefill's shape on two layouts: v's
# base one bf16 element past an alignment (FA_SHIFTED: v copied), and q,
# k, v the first 128 columns of (B, S, H, 132) buffers, an h stride of
# 264 bytes (FA_STAGED: all three copied)
FA_SHIFTED = ("shifted prefill",) + FA_MAIN[1:]
FA_STAGED = ("staged prefill",) + FA_MAIN[1:]
FA_STAGED_WIDTH = 132
# the f32 (split-TF32) path timed at the prefill's shape, on f32 inputs
FA_F32 = ("f32 prefill", 2, 4096, 32, 2, 128, 0, "float32")
FA_CASES = (FA_MAIN,
            ("ragged S", 1, 200, 4, 2, 64, 0, "bfloat16"),
            ("window 96 G=4", 1, 256, 8, 2, 64, 96, "bfloat16"),
            ("hd 80 window 50", 1, 128, 2, 1, 80, 50, "bfloat16"),
            ("window 8 < tile", 1, 200, 4, 2, 64, 8, "bfloat16"),
            ("hd 16", 2, 64, 8, 2, 16, 0, "bfloat16"),
            ("hd 48", 2, 64, 4, 2, 48, 0, "bfloat16"),
            ("MHA G=1", 2, 256, 4, 4, 32, 0, "bfloat16"),
            ("f32 S=1024", 1, 1024, 32, 2, 128, 0, "float32"),
            ("f32 window 96", 1, 256, 8, 2, 64, 96, "float32"),
            ("f32 hd 80", 1, 200, 2, 1, 80, 50, "float32"),
            ("f32 hd 20", 1, 200, 4, 2, 20, 0, "float32"),
            ("hd 20 (no TMA)", 1, 200, 4, 2, 20, 0, "bfloat16"),
            ("long", 1, 16384, 2, 1, 128, 0, "bfloat16"),
            FA_SHIFTED, FA_STAGED, FA_F32)
# the f32 kernel's products: each operand is split into two TF32 parts
# and a pair costs three TF32 products, so its bound is 3x the flops at
# TF32_FLOPS
FA_F32_PRODUCTS = 3
# the factor of the kernel's own arithmetic floor over the function's
# bound: P enters P V as two bf16 operands (head and remainder), so it
# computes Q K^T once and P V twice, 6d flops a pair for the bound's 4d
FA_FLOOR = 1.5
LM_ARCH, LM_SEED = "chatglm3-6b", 0
LM_BATCH, LM_SEQ = 2, 4096                      # prefill batch
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 8, 32, 64
# 2-layer f32 model: kernel vs plain prefill and decode vs prefill within
# LM_F32_TOL x max|logits| (f32 sums in another order, ~1e-6 relative)
LM_F32_TOL = 1e-4
# 28-layer bf16 model, kernel vs plain prefill and decode vs prefill. The
# plain attention rounds its scores and probabilities to bf16 (as the
# reference's does), the kernel keeps them in f32; 28 random layers grow
# that difference. A CPU rehearsal at 28 layers and widths 512-1024 gave
# 0.085 of max|logits| and 85-88 % argmax agreement (decode vs prefill:
# 0.055, 89-94 %). A wrong mask, head mapping or scale moves the logits by
# about max|logits| and leaves ~0 % agreement.
LM_BF16_REL, LM_BF16_AGREE = 0.25, 0.6
LEAVES = (375, 10500, 101248, 2260)               # conv1, conv2, fc1, fc2
AGG_CASES = ([("edge", 1, 5, 50, P, ()) for P in LEAVES]
             + [("cloud", 1, 1, 5, P, ()) for P in LEAVES]
             + [("empty-edges", 1, 5, 50, 10500, (1, 3)),
                ("unaligned", 1, 3, 13, 257, ()),
                ("lanes", 3, 5, 50, 10500, ()),
                ("large-H", 1, 5, 4096, 10500, ()),
                ("M>8", 1, 12, 50, 2260, (4,))])
WIRE = (("int8", "i8"), ("bfloat16", "bf16"), ("float32", "f32"))
# the hops timed as one launch over the four leaves: (tag, M, H)
HOPS = (("edge", 5, 50), ("cloud", 1, 5))
COLD_BYTES = 128 * 2 ** 20   # written before a cold-L2 call (L2: 50 MB)
COLD_SPIN = 1_000_000        # cycles (~0.5 ms) spun before each such call
SWEEP_LANES, SWEEP_ROUNDS = 4, 3   # the sweep phase's lanes and host rounds
# the depth cut that keeps the script near 400 s once the sweep phase
# runs: D3QN waves (3 before the sweep phase)
D3QN_WAVES = 2
ASYNC_ROUNDS = 2        # phase 12b's rounds under the stationary preset
# phase 14: the LM families at full width (bf16 compute, f32 weights)
ZOO_SSM, ZOO_MOE, ZOO_HYBRID = ("mamba2-2.7b", "qwen3-moe-235b-a22b",
                                "jamba-1.5-large-398b")
MOE_LAYERS = 4          # qwen3-moe's depth cut: 4 of its 94 layers
MOE_BATCH, MOE_SEQ = 2, 2048     # qwen3-moe prefill (4096 tokens, as A's)
# ssd_chunked against ssd_reference on one full-width layer's inputs, f32:
# max |chunked - recurrence| <= SSD_REL x max |recurrence| (sums over
# 256-token chunks and 4 chunk states in another order than 1 024 steps)
SSD_REL, SSD_SEQ = 1e-4, 1024
# phase 15: training chatglm3-6b at full width (bf16 compute, f32 weights
# and adam moments), cut to TRAIN_LAYERS of its 28 layers (at 28, 6.24e9
# parameters with their gradients and two moments take ~100 GB), on
# TRAIN_BATCH of train_4k's 256 sequences at its length: one sequence a
# microbatch (the config's 8), 32 768 tokens a step
TRAIN_LAYERS, TRAIN_STEPS, TRAIN_LR = 4, 4, 1e-4
TRAIN_BATCH, TRAIN_SEQ = 8, 4096
TRAIN_PODS, HFL_LR = 2, 1e-2     # the two-tier step: SGD on 2 replicas
# the step with remat on against off runs the same kernels on the same
# inputs (the recompute repeats the forward): equal up to ordering noise
REMAT_LOSS_REL, REMAT_FAR = 1e-6, 1e-4
# microbatches 2 against 8 (bf16 GEMMs of 4x the rows may take other
# cuBLAS kernels and round elsewhere): the loss to MB_LOSS_REL, the mean
# gradient to MB_GRAD_REL in norm, and at most MB_FAR of the params more
# than lr/2 apart after the adam step (near-zero gradients flip their
# update's sign). Summing only one microbatch's gradient would put the
# gradient ~1 away in norm and move most params by ~lr.
MB_LOSS_REL, MB_GRAD_REL, MB_FAR = 1e-3, 2e-2, 5e-2
# the synced pods against the mean of the same step's unsynced pods, as a
# share of how far apart the unsynced pods are
HFL_REL = 1e-3
# card against CPU, one smoke-config step per family, f32 (TF32 off): the
# tolerances of tests/test_torch_train.py (f32 sums in another order)
TRAIN_FAMILIES = (("dense", "chatglm3-6b"), ("vlm", "internvl2-26b"),
                  ("audio", "musicgen-medium"),
                  ("moe", "qwen3-moe-235b-a22b"), ("ssm", "mamba2-2.7b"),
                  ("hybrid", "jamba-1.5-large-398b"))
SMOKE_LR = 1e-3
# phase 16b: lanes over 2 ranks sharing the card (3, padded to 4), and
# the accuracy tolerance of tests/test_sweep_shard.py ("a couple of test
# samples"; costs rtol 1e-4, atol 1e-6)
MESH_LANES, SHARD_ACC_SAMPLES = 3, 2
# phase 17: train_hfl_e2e_torch cut in depth (its defaults: 8 rounds, 80
# D3QN episodes); the dry runs of 17b, each a process: (tag, CLI flags)
E2E_ARGS = ["--rounds", "2", "--episodes", "8"]
DRYRUNS = (("train", ["--arch", LM_ARCH, "--shape", "train_4k"]),
           ("hfl", ["--hfl-step", "--arch", LM_ARCH]))


def check(cond, msg):
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def memory_rate(name: str) -> float:
    """Bytes/s of device memory, by the card nvidia-smi names."""
    return 4.8e12 if "H200" in name else 3.35e12


def time_ms(fn, reps: int):
    """(graph_ms, eager_ms) per call of ``fn``: replayed from a CUDA graph
    of ``reps`` calls (the device time, launch gaps inside the graph
    only), and as ``reps`` back-to-back eager calls (what a caller pays,
    host launch overhead included), both timed with CUDA events."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    eager = start.elapsed_time(end) / reps
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps, eager


def time_cold(torch, fn, reps: int = 20) -> float:
    """ms of one call of ``fn`` with a cold L2: COLD_BYTES written before
    each call, each call timed alone by CUDA events; the mean. The card
    first spins for COLD_SPIN cycles, so that the host has queued the
    call before the write ends and the events time the device alone."""
    flush = torch.empty(COLD_BYTES // 4, device="cuda")
    fn()
    torch.cuda.synchronize()
    marks = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for i, (start, end) in enumerate(marks):
        torch.cuda._sleep(COLD_SPIN)
        flush.fill_(float(i))
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in marks) / reps


def agg_case(torch, dev, rng, S, M, H, P, empty=()):
    assign = rng.integers(0, M, (S, H))
    for m in empty:
        assign[assign == m] = (m + 1) % M
    mask = assign[:, None, :] == np.arange(M)[None, :, None]
    sizes = rng.integers(400, 701, (S, H))
    deltas = rng.normal(0, 0.1, (S, H, P))        # weights of order 0.1
    return tuple(torch.tensor(a, dtype=torch.float32, device=dev)
                 for a in (mask, sizes, deltas))


def wire(torch, deltas, dtype):
    """(scales, q) as the codecs emit them: int8 levels with absmax/127
    scales, bf16 deltas, or dense-masked f32 (top-k) with unit scales."""
    if dtype == torch.int8:
        scales = deltas.abs().amax(2) / 127.0
        q = torch.clamp(torch.floor(deltas / scales[..., None]
                                    + torch.rand_like(deltas)),
                        -127, 127).to(torch.int8)
        return scales, q
    scales = torch.ones(deltas.shape[:2], device=deltas.device)
    return scales, (deltas.to(dtype) if dtype == torch.bfloat16 else
                    deltas * (torch.rand_like(deltas) < 0.05))


def panel(mask, sizes):
    """K1's normalised panel, as the plain version builds it."""
    w = mask * sizes[:, None, :]
    return w / w.sum(2, keepdim=True).clamp_min(1.0)


def agg_bytes(S, M, H, widths, itemsize, n_rows):
    """Bytes an aggregation must move: the (S, M, H) panel, ``n_rows``
    (S, H) vectors (sizes, scales), the operand at its itemsize and the
    f32 output, each once."""
    P = sum(widths)
    return 4 * (S * M * H + n_rows * S * H + S * M * P) + itemsize * S * H * P


def bench_agg(torch, rate, label, case, run, plain, library, nbytes, acc):
    """Check one per-leaf aggregation call against its plain version,
    time kernel, plain and library call, print a line and add an
    edge-hop case into ``acc`` (sums over the four leaves of one edge
    iteration, launched one by one)."""
    tag, S, M, H, P, empty = case
    got, ref = run(), plain()
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    check(bool(((got - ref).abs() <= AGG_TOL * (1 + ref.abs())).all()),
          f"{label} {tag} S={S} M={M} H={H} P={P}: max_abs_err {err}")
    for m in empty:
        check(bool((got[:, m] == 0).all()), f"{label}: empty edge {m} not 0")
    reps = 50 if H * P > 1e7 else 200
    t_k, e_k = time_ms(run, reps)
    t_p, e_p = time_ms(plain, reps)
    t_l, e_l = time_ms(library, reps)
    flops = 2 * S * M * H * P
    bound = max(nbytes / rate, flops / F32_FLOPS) * 1e3
    print(f"{label} {tag:11s} S={S} M={M:2d} H={H:4d} P={P:6d}: "
          f"kernel_ms={t_k:.5f} plain_ms={t_p:.5f} library_ms={t_l:.5f} "
          f"bound_us={bound * 1e3:.3f} max_abs_err={err:.3e} | eager "
          f"kernel/plain/library_ms={e_k:.5f}/{e_p:.5f}/{e_l:.5f}")
    acc["err"] = max(acc.get("err", 0.0), err)
    if tag == "edge":                           # one edge iteration
        for k, v in (("ms", t_k), ("eager_ms", e_k)):
            acc[k] = acc.get(k, 0) + v


def bench_hop(torch, rate, label, tag, M, H, run, plain, library, nbytes,
              counter, leaf_sum, S=1):
    """One grouped launch over the four CNN leaves of a hop of ``S``
    lanes: each output against its plain version, the launch counted
    once, then graph, eager and cold-L2 times beside the plain version
    (leaf by leaf), the library calls (one torch.bmm a leaf) and the
    bound. Returns the kernel's figures for the result line."""
    got, ref = run(), plain()
    torch.cuda.synchronize()
    err = 0.0
    for g, r in zip(got, ref):
        err = max(err, float((g - r).abs().max()))
        check(bool(((g - r).abs() <= AGG_TOL * (1 + r.abs())).all()),
              f"{label} {tag} hop M={M} H={H}: max_abs_err {err}")
    n0 = counter.launches
    run()
    check(counter.launches == n0 + 1,
          f"{label} {tag} hop: {counter.launches - n0} launches, not 1")
    t_k, e_k = time_ms(run, 200)
    t_p, e_p = time_ms(plain, 200)
    t_l, e_l = time_ms(library, 200)
    cold = time_cold(torch, run)
    flops = 2 * S * M * H * sum(LEAVES)
    by_bytes, by_flops = nbytes / rate, flops / F32_FLOPS
    bound = max(by_bytes, by_flops) * 1e3
    print(f"{label} {tag} hop, one launch over {len(LEAVES)} leaves, S={S} "
          f"M={M} H={H}: kernel_ms={t_k:.5f} cold_l2_ms={cold:.5f} "
          f"eager_ms={e_k:.5f} plain_ms={t_p:.5f} library_ms={t_l:.5f} "
          f"(eager {e_l:.5f}) bound_ms={bound:.5f} "
          f"({nbytes / 1e6:.3f} MB) max_abs_err={err:.3e}"
          + (f" | {len(LEAVES)} per-leaf launches: kernel_ms="
             f"{leaf_sum['ms']:.5f} eager_ms={leaf_sum['eager_ms']:.5f}"
             if leaf_sum else ""))
    return {"ms": t_k, "eager_ms": e_k, "cold_ms": cold, "plain_ms": t_p,
            "library_ms": t_l, "bound_ms": bound, "err": err,
            "bound_by": "bytes" if by_bytes >= by_flops else "operations"}


def kernel_phase(torch, rate):
    from repro_torch.kernels.hier_agg import ops as ha
    from repro_torch.kernels.kmeans_dist import ops as kd

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    out = {}

    # ---- K1 masked_aggregate and K3 weighted_aggregate: eq. (2) leaves
    #      of one edge iteration, the eq. (3) cloud call, edge cases, each
    #      launched alone; then the edge and cloud hops as one launch
    k1, k3 = {}, {}
    for case in AGG_CASES:
        _, S, M, H, P, _ = case
        mask, sizes, deltas = agg_case(torch, dev, rng, S, M, H, P, case[5])
        w = panel(mask, sizes)
        bench_agg(torch, rate, "masked_aggregate", case,
                  lambda: ha.masked_aggregate_batched(mask, sizes, deltas),
                  lambda: ha.masked_aggregate_batched_ref(mask, sizes, deltas),
                  lambda: torch.bmm(w, deltas),
                  agg_bytes(S, M, H, [P], 4, 1), k1)
        bench_agg(torch, rate, "weighted_aggregate", case,
                  lambda: ha.weighted_aggregate_batched(w, deltas),
                  lambda: ha.weighted_aggregate_batched_ref(w, deltas),
                  lambda: torch.bmm(w, deltas),
                  agg_bytes(S, M, H, [P], 4, 0), k3)
    for tag, M, H in HOPS:
        mask, sizes, _ = agg_case(torch, dev, rng, 1, M, H, 1)
        leaves = [agg_case(torch, dev, rng, 1, M, H, P)[2] for P in LEAVES]
        w = panel(mask, sizes)
        r1 = bench_hop(
            torch, rate, "masked_aggregate", tag, M, H,
            lambda: ha.masked_aggregate_leaves_batched(mask, sizes, leaves),
            lambda: ha.masked_aggregate_leaves_batched_ref(mask, sizes,
                                                           leaves),
            lambda: [torch.bmm(w, x) for x in leaves],
            agg_bytes(1, M, H, LEAVES, 4, 1),
            ha.masked_aggregate_leaves_batched_cuda, k1 if tag == "edge"
            else None)
        r3 = bench_hop(
            torch, rate, "weighted_aggregate", tag, M, H,
            lambda: ha.weighted_aggregate_leaves_batched(w, leaves),
            lambda: ha.weighted_aggregate_leaves_batched_ref(w, leaves),
            lambda: [torch.bmm(w, x) for x in leaves],
            agg_bytes(1, M, H, LEAVES, 4, 0),
            ha.weighted_aggregate_leaves_batched_cuda, k3 if tag == "edge"
            else None)
        if tag == "edge":
            r1["err"] = max(r1["err"], k1["err"])
            r3["err"] = max(r3["err"], k3["err"])
            out["masked_aggregate"], out["weighted_aggregate"] = r1, r3
    # the sweep's hops: one launch over SWEEP_LANES lanes x 4 leaves
    S = SWEEP_LANES
    for tag, M, H in HOPS:
        mask, sizes, _ = agg_case(torch, dev, rng, S, M, H, 1)
        leaves = [agg_case(torch, dev, rng, S, M, H, P)[2] for P in LEAVES]
        w = panel(mask, sizes)
        r1 = bench_hop(
            torch, rate, "masked_aggregate", f"{S}-lane {tag}", M, H,
            lambda: ha.masked_aggregate_leaves_batched(mask, sizes, leaves),
            lambda: ha.masked_aggregate_leaves_batched_ref(mask, sizes,
                                                           leaves),
            lambda: [torch.bmm(w, x) for x in leaves],
            agg_bytes(S, M, H, LEAVES, 4, 1),
            ha.masked_aggregate_leaves_batched_cuda, None, S=S)
        out["masked_aggregate"]["err"] = max(out["masked_aggregate"]["err"],
                                             r1["err"])
        if tag == "edge":
            out["masked_aggregate_lanes"] = r1

    # ---- K4 masked_decode_aggregate, per wire dtype as the codecs emit
    #      it: int8 levels with absmax/127 scales, bf16 deltas and
    #      dense-masked f32 (top-k) with unit scales
    for dtype_name, short in WIRE:
        dtype = getattr(torch, dtype_name)
        label = f"masked_decode_aggregate[{dtype_name}]"
        k4 = {}
        for case in AGG_CASES:
            _, S, M, H, P, _ = case
            mask, sizes, deltas = agg_case(torch, dev, rng, S, M, H, P,
                                           case[5])
            scales, q = wire(torch, deltas, dtype)
            wsc = panel(mask, sizes) * scales[:, None, :]
            bench_agg(torch, rate, label, case,
                      lambda: ha.masked_decode_aggregate_batched(
                          mask, sizes, scales, q),
                      lambda: ha.masked_decode_aggregate_batched_ref(
                          mask, sizes, scales, q),
                      lambda: torch.bmm(wsc, q.float()),
                      agg_bytes(S, M, H, [P], q.element_size(), 2), k4)
        for tag, M, H in HOPS:
            mask, sizes, _ = agg_case(torch, dev, rng, 1, M, H, 1)
            sq = [wire(torch, agg_case(torch, dev, rng, 1, M, H, P)[2],
                       dtype) for P in LEAVES]
            scs, qs = [a for a, _ in sq], [b for _, b in sq]
            w = panel(mask, sizes)
            wscs = [w * sc[:, None, :] for sc in scs]
            r4 = bench_hop(
                torch, rate, label, tag, M, H,
                lambda: ha.masked_decode_aggregate_leaves_batched(
                    mask, sizes, scs, qs),
                lambda: ha.masked_decode_aggregate_leaves_batched_ref(
                    mask, sizes, scs, qs),
                lambda: [torch.bmm(a, q.float()) for a, q in zip(wscs, qs)],
                agg_bytes(1, M, H, LEAVES, qs[0].element_size(), 5),
                ha.masked_decode_aggregate_leaves_batched_cuda,
                k4 if tag == "edge" else None)
            if tag == "edge":
                r4["err"] = max(r4["err"], k4["err"])
                out[f"masked_decode_aggregate_{short}"] = r4
        if dtype != torch.int8:
            continue
        # the int8 sweep's hops: one launch over SWEEP_LANES lanes x 4
        # leaves
        S = SWEEP_LANES
        for tag, M, H in HOPS:
            mask, sizes, _ = agg_case(torch, dev, rng, S, M, H, 1)
            sq = [wire(torch, agg_case(torch, dev, rng, S, M, H, P)[2],
                       dtype) for P in LEAVES]
            scs, qs = [a for a, _ in sq], [b for _, b in sq]
            w = panel(mask, sizes)
            wscs = [w * sc[:, None, :] for sc in scs]
            r4 = bench_hop(
                torch, rate, label, f"{S}-lane {tag}", M, H,
                lambda: ha.masked_decode_aggregate_leaves_batched(
                    mask, sizes, scs, qs),
                lambda: ha.masked_decode_aggregate_leaves_batched_ref(
                    mask, sizes, scs, qs),
                lambda: [torch.bmm(a, q.float()) for a, q in zip(wscs, qs)],
                agg_bytes(S, M, H, LEAVES, 1, 5),
                ha.masked_decode_aggregate_leaves_batched_cuda, None, S=S)
            row = out[f"masked_decode_aggregate_{short}"]
            row["err"] = max(row["err"], r4["err"])
            if tag == "edge":
                out[f"masked_decode_aggregate_{short}_lanes"] = r4

    # ---- K2 pairwise_sq_dists: the clustering's shape and K > 128
    k2 = {}
    for tag, N, P, K in (("clustering", 100, 1640, 10),
                         ("K>128", 1000, 1000, 200),
                         ("unaligned", 37, 130, 3)):
        x = torch.randn(N, P, device=dev)
        c = torch.randn(K, P, device=dev)
        got = kd.pairwise_sq_dists(x, c)
        ref = kd.pairwise_sq_dists_ref(x, c)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        check(bool(((got - ref).abs()
                    <= DIST_TOL * (ref.abs().max() + ref.abs())).all()),
              f"pairwise_sq_dists {tag} N={N} P={P} K={K}: "
              f"max_abs_err {err}")
        t_k, e_k = time_ms(lambda: kd.pairwise_sq_dists(x, c), 200)
        t_p, e_p = time_ms(lambda: kd.pairwise_sq_dists_ref(x, c), 200)
        t_l, e_l = time_ms(lambda: torch.cdist(x, c).square_(), 200)
        nbytes = 4 * (N * P + K * P + N * K)
        flops = 2 * N * K * P + 2 * (N + K) * P + 3 * N * K
        bound = max(nbytes / rate, flops / F32_FLOPS) * 1e3
        by = "bytes" if nbytes / rate >= flops / F32_FLOPS else "operations"
        plan = kd.launch_plan(N, K, P, kd.sm_count(x.device))
        print(f"pairwise_sq_dists {tag:10s} N={N:4d} P={P:4d} K={K:3d} "
              f"[{plan.row_tiles}x{plan.col_tiles} tiles of 32x"
              f"{plan.col_tile}, {plan.splits} splits of {plan.chunk}]: "
              f"kernel_ms={t_k:.5f} plain_ms={t_p:.5f} library_ms={t_l:.5f} "
              f"bound_us={bound * 1e3:.3f} ({by}) max_abs_err={err:.3e} | "
              f"eager kernel/plain/library_ms={e_k:.5f}/{e_p:.5f}/{e_l:.5f}")
        k2["err"] = max(k2.get("err", 0.0), err)
        if tag == "clustering":
            k2.update(ms=t_k, plain_ms=t_p, library_ms=t_l, eager_ms=e_k,
                      bound_ms=bound, bound_by=by)
    out["pairwise_sq_dists"] = k2
    return out


def k6_launches(steps: int, evals: int = 0, n_test: int = 0) -> dict:
    """K6's launches by counter for ``steps`` local steps of the CNN (each
    a forward of both blocks, their dW and conv 2's dx, one launch each
    over every vmapped device and lane) and ``evals`` evaluations of
    ``n_test`` samples (a forward of both blocks a batch of EVAL_BATCH)."""
    batches = evals * -(-n_test // EVAL_BATCH)
    return {"conv_relu_pool": 2 * (steps + batches),
            "conv_pool_dw": 2 * steps, "conv_pool_dx": steps}


def k6_rounds(sp, rounds: int, n_test: int) -> dict:
    """K6's launches for ``rounds`` HFL rounds of the CNN (Q edge
    iterations of L local steps) with an evaluation after each."""
    return k6_launches(rounds * sp.Q * sp.L, rounds, n_test)


def conv_pool_phase(torch, rate):
    """K6 against the plain block at CONV_CASES: forward y to AGG_TOL of
    ``conv_relu_pool_ref`` under vmap (the im2col path the CNN took
    before it), and idx equal to the plain conv outputs' first maximum
    wherever no window has a near-tie; backward dW, and dx where the
    block needs it, to CONV_GRAD_TOL of the largest value of the plain
    backward routed by the kernel's own idx (``conv_pool_dw_ref``,
    ``conv_pool_dx_ref``: the plain autograd backward routes by the
    plain forward's argmax, which may side the other way at a near-tie).
    Each direction is timed as CUDA-graph and eager ms beside the plain
    block's eager ms (its ``torch.func.vjp`` for the backward) and the
    bound: bytes at ``rate`` (x, w, y and idx; x, dy, idx, dW and dx) or
    the flops these inputs need at F32_FLOPS (the forward's dense conv;
    the backward's 25*C FMAs a tap for each pooled element that idx
    routes a gradient to), whichever is larger."""
    from repro_torch.kernels.conv_pool import ops as cp

    def chunked(fn, *args, chunk=25):
        """``fn`` over the group axis in chunks of groups: the plain
        maths of 200 groups at once would hold all their patches."""
        outs = [fn(*(a[i:i + chunk] for a in args))
                for i in range(0, args[0].shape[0], chunk)]
        return torch.cat(outs)

    def clear_windows(x, w):
        """True at each pooling window whose plain conv outputs have no
        near-tie: top two within CONV_TIE (both above -CONV_TIE), or
        the top one within CONV_TIE of 0."""
        z = torch.stack([cp.im2col_conv(a, b) for a, b in zip(x, w)])
        G, B, Ho, Wo, O = z.shape
        top = z.reshape(G, B, Ho // 2, 2, Wo // 2, 2, O).permute(
            0, 1, 2, 4, 6, 3, 5).reshape(G, B, Ho // 2, Wo // 2, O, 4
                                         ).topk(2, dim=-1).values
        tie = ((top[..., 0] - top[..., 1] < CONV_TIE)
               & (top[..., 0] > -CONV_TIE)) | (top[..., 0].abs() < CONV_TIE)
        return ~tie

    rows = []
    for tag, H, C, O, groups, dx_too in CONV_CASES:
        for G in groups:
            B, Ho = CONV_SAMPLES, H - 4
            g = torch.Generator(device="cuda").manual_seed(G)
            x = torch.rand((G, B, H, H, C), device="cuda", generator=g)
            w = torch.randn((G, 5, 5, C, O), device="cuda", generator=g) \
                * (2.0 / (25 * C)) ** 0.5
            y, idx = cp.conv_relu_pool_cuda(x, w)
            dy = torch.randn(y.shape, device="cuda", generator=g)
            plain = torch.func.vmap(cp.conv_relu_pool_ref)
            with torch.no_grad():
                ref = plain(x, w)
                err = float((y - ref).abs().max())
                check(bool(((y - ref).abs()
                            <= AGG_TOL * (1 + ref.abs())).all()),
                      f"conv_relu_pool {tag} G={G}: max_abs_err {err}")
                del ref
                clear = chunked(clear_windows, x, w)
                idx_ref = chunked(
                    lambda a, b: cp.conv_relu_pool_groups_ref(a, b)[1], x, w)
                share = float(clear.float().mean())
                check(share > 0.99
                      and torch.equal(idx[clear], idx_ref[clear]),
                      f"conv_relu_pool {tag} G={G}: idx differs from the "
                      f"plain first maximum away from near-ties "
                      f"({100 * share:.3f} % of the windows clear)")
                del clear, idx_ref
            grads = {"dW": (cp.conv_pool_dw_cuda(x, dy, idx),
                            chunked(cp.conv_pool_dw_ref, x, dy, idx))}
            if dx_too:
                grads["dx"] = (cp.conv_pool_dx_cuda(w, dy, idx),
                               chunked(cp.conv_pool_dx_ref, w, dy, idx))
            gerr = {}
            for name, (got, want) in grads.items():
                scale = float(want.abs().max())
                gerr[name] = float((got - want).abs().max()) / scale
                check(gerr[name] <= CONV_GRAD_TOL,
                      f"conv_pool {tag} G={G}: {name} differs from the "
                      f"plain backward by {gerr[name]:.3e} of its largest "
                      f"value {scale:.3e}")
            del grads

            def backward():
                cp.conv_pool_dw_cuda(x, dy, idx)
                if dx_too:
                    cp.conv_pool_dx_cuda(w, dy, idx)
            if dx_too:
                _, pull = torch.func.vjp(plain, x, w)
            else:
                _, pull = torch.func.vjp(lambda w_: plain(x, w_), w)
            routed = int((idx != cp.NONE).sum())
            sizes = {"x": x.numel() * 4, "w": w.numel() * 4,
                     "y": y.numel() * 4, "idx": idx.numel()}
            work = {"forward": (2 * G * B * Ho * Ho * O * 25 * C,
                                sizes["x"] + sizes["w"] + sizes["y"]
                                + sizes["idx"]),
                    "backward": (2 * routed * 25 * C * (2 if dx_too else 1),
                                 sizes["x"] + 2 * sizes["w"] + sizes["y"]
                                 + sizes["idx"]
                                 + (sizes["x"] if dx_too else 0))}
            runs = {"forward": (lambda: cp.conv_relu_pool_cuda(x, w),
                                lambda: plain(x, w)),
                    "backward": (backward, lambda: pull(dy))}
            dw_ms = time_ms(lambda: cp.conv_pool_dw_cuda(x, dy, idx), 10)[0]
            for way, (kernel, plain_fn) in runs.items():
                ms, eager = time_ms(kernel, 10)
                with torch.no_grad() if way == "forward" else \
                        contextlib.nullcontext():
                    plain_ms = time_events(torch, plain_fn, 3)
                flops, nbytes = work[way]
                by_b, by_f = nbytes / rate * 1e3, flops / F32_FLOPS * 1e3
                row = dict(block=tag, G=G, B=B, way=way, ms=ms,
                           eager_ms=eager, plain_ms=plain_ms,
                           bound_ms=max(by_b, by_f),
                           bound_by="bytes" if by_b >= by_f else "operations",
                           bound_share=max(by_b, by_f) / ms)
                if way == "forward":
                    row.update(err=err, idx_clear_share=share)
                else:
                    row.update(dw_ms=dw_ms, **{f"{k}_rel_err": v
                                               for k, v in gerr.items()})
                print(f"conv_relu_pool {tag} G={G:3d} B={B} {way:8s}: "
                      f"ms={ms:.4f} "
                      + (f"(dW {dw_ms:.4f}) " if way == "backward" else "")
                      + f"eager_ms={eager:.4f} "
                      f"plain_ms={plain_ms:.4f} bound_ms="
                      f"{row['bound_ms']:.4f} ({row['bound_by']}) "
                      f"{100 * row['bound_share']:.1f} % of the bound; "
                      + (f"max_abs_err {err:.3e}, idx checked on "
                         f"{100 * share:.3f} % of the windows"
                         if way == "forward" else "errors of the largest "
                         "value " + ", ".join(f"{k} {v:.3e}"
                                              for k, v in gerr.items())))
                rows.append(row)
            del x, w, y, idx, dy, pull
            torch.cuda.empty_cache()
    return rows


def fork(fw, **cfg_changes):
    """A framework sharing ``fw``'s world, with its own copy of the
    round state (params, codec residuals, scheduler, rng), so two rounds
    can start from the same state."""
    twin = copy.copy(fw)
    twin.cfg = dataclasses.replace(fw.cfg, **cfg_changes)
    twin.scheduler = copy.deepcopy(fw.scheduler)
    twin.rng = copy.deepcopy(fw.rng)
    twin.model_params = {k: v.clone() for k, v in fw.model_params.items()}
    if fw.codec_state is not None:
        twin.codec_state = tuple({k: v.clone() for k, v in part.items()}
                                 for part in fw.codec_state)
    twin.history = list(fw.history)
    return twin


def differing(got, want, atol):
    """(share of the elements of two dicts of tensors that differ by more
    than atol, largest |difference|)."""
    bad = n = 0
    dmax = 0.0
    for k, w in want.items():
        d = (got[k] - w).abs()
        bad += int((d > atol).sum())
        n += w.numel()
        dmax = max(dmax, float(d.max()))
    return bad / n, dmax


def record_assignments(fw):
    """Wrap ``fw.assigner.assign`` to log each round's (cohort,
    assignment); forks share the assigner, so they log into it too."""
    log, real = [], fw.assigner.assign

    def spy(pop, sched, rng=None):
        out = real(pop, sched, rng)
        log.append((np.array(sched), np.array(out[0])))
        return out
    fw.assigner.assign = spy
    return log


def run_rounds(torch, fw, rounds, label):
    recs = []
    for i in rounds:
        t0 = time.perf_counter()
        rec = fw.run_round(i)
        rec["wall_s"] = time.perf_counter() - t0
        rec["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        split = " ".join(f"{k}={v:.4f}" for k, v in rec["seconds"].items())
        print(f"{label} round {i}: acc={rec['acc']:.4f} T_i={rec['T_i']:.4f} "
              f"E_i={rec['E_i']:.4f} msg_bits={rec['msg_bits']:.0f} "
              f"wall_s={rec['wall_s']:.4f} [{split}] "
              f"max_memory_allocated={rec['max_memory_allocated']}")
        check(all(math.isfinite(rec[k]) for k in ("acc", "T_i", "E_i")),
              f"{label} round {i} record not finite: {rec}")
        recs.append(rec)
    check(all(bool(torch.isfinite(v).all())
              for v in fw.model_params.values()),
          f"{label}: non-finite params")
    return recs


def assignment_phase(torch, sp, pop, fed, cfg, fw, labels, geo_rec,
                     geo_cohort, zero_counts, read_counts):
    """Phase 5: HFEL, D3QN training and the hfel/drl framework rounds."""
    from repro_torch.core import cost_model as cm
    from repro_torch.core.assignment.hfel import (HFELAssigner,
                                                  total_objective)
    from repro_torch.core.framework import HFLFramework
    from repro_torch.drl.train import D3QNTrainer
    from repro_torch.utils import tree_leaves, tree_map

    sched, geo_assign = geo_cohort
    # ---- a. HFEL on round 1's cohort
    hfel = HFELAssigner(fw.sp)
    (a_h, J_h), secs = timed(torch, lambda: hfel.assign(
        pop, sched, np.random.default_rng(0)))
    J_geo, _, _ = total_objective(fw.sp, pop, sched, geo_assign, 200)
    J_hr, _, _ = total_objective(fw.sp, pop, sched, a_h, 200)
    moved = int((a_h != geo_assign).sum())
    print(f"HFEL-{hfel.n_transfer}/{hfel.n_exchange} K={hfel.n_candidates} "
          f"alloc_steps={hfel.alloc_steps} H={len(sched)} M={sp.n_edges}: "
          f"{secs:.3f} s, J={J_h:.6f} (one 200-step solve: {J_hr:.6f}); "
          f"geo J={J_geo:.6f}; {moved} devices not on their nearest edge")
    check(math.isfinite(J_h) and J_hr < J_geo,
          f"HFEL J {J_hr} is not below the geo assignment's {J_geo}")
    pops = [pop] + [cm.sample_population(sp, seed=s) for s in (1, 2, 3)]
    (A, J), secs_b = timed(torch, lambda: hfel.assign_batch(
        cm.PopulationBatch.stack(pops), sched, [0, 1, 2, 3]))
    t0 = time.perf_counter()
    singles = [(a_h, J_h)] + [hfel.assign(pops[e], sched,
                                          np.random.default_rng(e))
                              for e in (1, 2, 3)]
    secs_s = time.perf_counter() - t0 + secs
    for e, (a, j) in enumerate(singles):
        check(np.array_equal(A[e], a) and abs(J[e] - j) <= 1e-6 * abs(j),
              f"HFEL assign_batch population {e} differs from assign: "
              f"J {J[e]} vs {j}, {int((A[e] != a).sum())} devices")
    dJ = max(abs(float(J[e]) - j) for e, (_, j) in enumerate(singles))
    print(f"HFEL assign_batch over 4 populations: {secs_b:.3f} s, equal to "
          f"4 assign calls ({secs_s:.3f} s; max |J diff| {dJ:.3e}); "
          f"J={np.round(J, 6).tolist()}")

    # ---- b. D3QN training, D3QN_WAVES waves at full width
    torch.cuda.reset_peak_memory_stats()
    tr = D3QNTrainer(sp, H=50, hidden=256, alloc_steps=120, wave_size=8)
    split = {"search": 0.0, "update": 0.0}

    def timing(name, fn):
        def wrapped(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            split[name] += time.perf_counter() - t
            return out
        return wrapped
    tr.hfel.assign_batch = timing("search", tr.hfel.assign_batch)
    tr._update_wave = timing("update", tr._update_wave)
    p0 = [x.clone() for x in tree_leaves(tr.params)]
    walls, losses = [], []
    for w in range(D3QN_WAVES):
        (rets, loss), secs = timed(torch, tr.run_wave)
        walls.append(secs)
        losses.append(loss.cpu().numpy())
        print(f"D3QN wave {w + 1}: {secs:.3f} s, returns "
              f"{rets.astype(int).tolist()}, td losses "
              f"{np.round(losses[-1], 4).tolist()}")
    n_ep = D3QN_WAVES * tr.wave_size
    print(f"D3QN H={tr.H} hidden={tr.hidden} M={sp.n_edges} HFEL-"
          f"{tr.hfel_transfer}/{tr.hfel_exchange} alloc_steps="
          f"{tr.alloc_steps} wave_size={tr.wave_size}: "
          f"{sum(walls) / D3QN_WAVES:.3f} s a wave (target search "
          f"{split['search'] / D3QN_WAVES:.3f} s, updates "
          f"{split['update'] / D3QN_WAVES:.3f} s, the rest "
          f"{(sum(walls) - split['search'] - split['update']) / D3QN_WAVES:.3f}"
          f" s), "
          f"{n_ep / sum(walls):.3f} episodes/s, {tr.step} updates, peak "
          f"memory {peak_gb(torch)}")
    check(tr.episode == n_ep and tr.step == n_ep, "D3QN: episode/step count")
    check(all(np.isfinite(x).all() for x in losses), "D3QN: loss not finite")
    dp = max(float((a - b).abs().max())
             for a, b in zip(tree_leaves(tr.params), p0))
    check(dp > 0 and all(bool(torch.isfinite(x).all())
                         for x in tree_leaves(tr.params)),
          f"D3QN params did not move or are not finite (max move {dp})")
    # one update wave, card against CPU, from the same state
    mbs = tr.replay.sample_updates(np.random.default_rng(1), tr.wave_size,
                                   tr.minibatch)

    def cpu(tree):
        return tree_map(lambda v: v.cpu() if torch.is_tensor(v) else v, tree)
    (pg, _, _, _), lg = tr._update_wave(tr.params, tr.opt_state,
                                        tr.target_params, tr.step, *mbs)
    (pc, _, _, _), lc = tr._update_wave(
        cpu(tr.params), cpu(tr.opt_state), cpu(tr.target_params), tr.step,
        *cpu(mbs))
    lg, lc = lg.cpu().numpy(), lc.numpy()
    names = [".".join(k) for k in _paths(pg)]
    d = [float((a.cpu() - b).abs().max())
         for a, b in zip(tree_leaves(pg), tree_leaves(pc))]
    worst = int(np.argmax(d))
    lrel = float(np.abs(lg - lc).max() / np.abs(lc).max())
    print(f"D3QN update wave card vs CPU: losses rel {lrel:.3e} (limit "
          f"{UPDATE_LOSS_RTOL:g}), max param difference {d[worst]:.3e} in "
          f"{names[worst]} (limit {UPDATE_ATOL:g} in every one of "
          f"{len(d)} leaves)")
    check(lrel <= UPDATE_LOSS_RTOL and max(d) <= UPDATE_ATOL,
          "D3QN update wave: card and CPU differ beyond the limits")

    # ---- c. framework rounds with the paper's assigners
    lat = {"geo": geo_rec["seconds"]["assign"]}
    for assigner in ("hfel", "drl"):
        zero_counts()
        fa = HFLFramework(sp, pop, fed, dataclasses.replace(
            cfg, assigner=assigner), labels=labels,
            drl_params=tr.params if assigner == "drl" else None)
        log = record_assignments(fa)
        rec = run_rounds(torch, fa, (1,), assigner)[0]
        read_counts(f"{assigner} round", {
            "masked_aggregate": sp.Q + 1,
            **k6_rounds(sp, 1, len(fed.y_test))})
        check(np.array_equal(log[0][0], sched),
              f"{assigner} round: another cohort than the geo round's")
        lat[assigner] = rec["seconds"]["assign"]
        print(f"{assigner} round 1: {int((log[0][1] != geo_assign).sum())} "
              f"of {len(sched)} devices off their nearest edge; T_i "
              f"{rec['T_i']:.4f} (geo {geo_rec['T_i']:.4f}), E_i "
              f"{rec['E_i']:.4f} (geo {geo_rec['E_i']:.4f})")
        del fa
    print(f"assign seconds on round 1's cohort (H={len(sched)}): "
          + ", ".join(f"{k} {v:.6f}" for k, v in lat.items()))


def sweep_phase(torch, sp, pop, fed, zero_counts, read_counts, H=50, K=10):
    """Phase 7: the multi-lane sweep (``SweepRunner``) on the Table-I
    world at full CNN width, SWEEP_LANES lanes (lane seeds 0-3), H=50,
    IKC schedulers, 200-step allocations, the kernels on. Returns the
    figures for the result line."""
    from repro_torch.core import compression as comp
    from repro_torch.core import sweep as sw
    from repro_torch.core.framework import FrameworkConfig, HFLFramework

    S = SWEEP_LANES
    seeds = list(range(S))
    worlds = [(pop, fed)] * S
    kw = dict(lr=0.01, alloc_steps=200, agg_kernel=True)
    per_round = sp.Q + 1
    n_test = len(fed.y_test)
    out = {}

    def schedulers(labels=None):
        return [sw.build_scheduler(
            "ikc", fed, sp, H, K=K, seed=s, use_kernel=True,
            labels=None if labels is None else labels[s])
            for s in seeds]

    def lanes_close(a, b):
        return max(float((a[k] - b[k]).abs().max()) for k in a)

    t_phase = time.perf_counter()

    def lap(step):
        torch.cuda.synchronize()
        print(f"sweep {step} done at {time.perf_counter() - t_phase:.1f} s "
              "into the phase")

    # ---- a. a 3-round geo host loop: one K1 launch a hop for all lanes
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    (runner, scheds), setup_s = timed(torch, lambda: (
        sw.SweepRunner(sp, worlds, **kw), schedulers()))
    labels = [s.state.clusters.copy() for s in scheds]
    res, wall = timed(torch, lambda: runner.run(scheds, SWEEP_ROUNDS,
                                                seeds=seeds))
    out["launches"] = read_counts(
        f"sweep a ({S} lanes, {SWEEP_ROUNDS} geo rounds)", {
        "masked_aggregate": SWEEP_ROUNDS * per_round,
        "pairwise_sq_dists": S * 8 * ((K - 1) + 50 + 1),
        **k6_rounds(sp, SWEEP_ROUNDS, n_test)}
    )["masked_aggregate"]
    peak = torch.cuda.max_memory_allocated()
    per = wall / SWEEP_ROUNDS
    print(f"sweep a: setup {setup_s:.3f} s ({S} IKC clusterings); "
          f"{SWEEP_ROUNDS} rounds {wall:.3f} s, {per:.3f} s a round, "
          f"{S / per:.3f} lane-rounds/s; H={res['H']}; acc "
          f"{np.round(res['acc'], 4).tolist()}; T_i "
          f"{np.round(res['T_i'], 3).tolist()}; peak memory "
          f"{peak / 1e9:.2f} GB")
    check(res["acc"].shape == (S, SWEEP_ROUNDS)
          and np.isfinite(res["acc"]).all()
          and np.isfinite(res["T_i"]).all() and (res["T_i"] > 0).all(),
          "sweep a: records not finite")
    check(peak < 70e9, f"sweep a: peak memory {peak / 1e9:.2f} GB: use "
          "lane_chunk")
    out.update(round_s=per, lane_rounds_s=S / per, peak_gb=peak / 1e9,
               setup_s=setup_s)
    profiled(torch, f"sweep round ({S} lanes, geo)",
             lambda: runner.run(schedulers(labels), 1, seeds=seeds),
             warm_up=False)
    del runner
    lap("a")

    # ---- b/c. the kernel sweep against the plain one and lane 0 against
    #      HFLFramework, 2 rounds from the same init and clustering
    zero_counts()
    kern = sw.SweepRunner(sp, worlds, **kw)
    rk = kern.run(schedulers(labels), 2, seeds=seeds)
    read_counts("sweep b (kernel sweep, 2 rounds)",
                {"masked_aggregate": 2 * per_round,
                 **k6_rounds(sp, 2, n_test)})
    plain = sw.SweepRunner(sp, worlds, **{**kw, "agg_kernel": False})
    rp = plain.run(schedulers(labels), 2, seeds=seeds)
    dmax = lanes_close(kern.params_b, plain.params_b)
    print(f"sweep c: kernel vs plain sweep, 2 rounds: T_i "
          f"{rk['T_i'].tolist()} vs {rp['T_i'].tolist()}, max |dparam| "
          f"{dmax:.3e} (tolerance {PARAM_TOL})")
    check(np.array_equal(rk["T_i"], rp["T_i"])
          and np.array_equal(rk["E_i"], rp["E_i"]),
          "sweep c: T_i/E_i differ between the aggregation backends")
    check(dmax <= PARAM_TOL, f"sweep c: params differ by {dmax}")
    # phase 16a runs the same 2 rounds lane-sharded and is held to these
    out["p16"] = {"labels": labels, "host": (rk, {
        k: v.cpu() for k, v in kern.params_b.items()})}
    del plain
    zero_counts()
    cfg = FrameworkConfig(H=H, K=K, scheduler="ikc", assigner="geo",
                          agg_kernel=True, alloc_steps=200, seed=seeds[0])
    fw = HFLFramework(sp, pop, fed, cfg, labels=labels[0],
                      init_params={k: v[0] for k, v in
                                   kern.params0.items()})
    recs = [fw.run_round(i) for i in (1, 2)]
    read_counts("sweep b (HFLFramework, lane 0's world, 2 rounds)",
                {"masked_aggregate": 2 * per_round,
                 **k6_rounds(sp, 2, n_test)})
    d0 = max(float((kern.params_b[k][0] - v).abs().max())
             for k, v in fw.model_params.items())
    fT = [r["T_i"] for r in recs]
    fE = [r["E_i"] for r in recs]
    print(f"sweep b: lane 0 vs HFLFramework: T_i {rk['T_i'][0].tolist()} "
          f"vs {fT}, E_i {rk['E_i'][0].tolist()} vs {fE}, acc "
          f"{rk['acc'][0].tolist()} vs {[r['acc'] for r in recs]}, max "
          f"|dparam| {d0:.3e} (tolerance {PARAM_TOL}); framework round "
          f"walls {[round(sum(r['seconds'].values()), 3) for r in recs]} s")
    check(np.array_equal(rk["T_i"][0], np.float32(fT))
          and np.array_equal(rk["E_i"][0], np.float32(fE)),
          "sweep b: lane 0's T_i/E_i differ from the framework's")
    check(d0 <= PARAM_TOL, f"sweep b: lane 0's params differ by {d0}")
    del fw
    lap("b/c")

    # ---- d. fused against oracle, geo (2 rounds) and hfel (1 round): the
    #      fused window runs with every host synchronisation an error; the
    #      HFEL search inside it is timed by CUDA events, read afterwards
    real_scan, real_search = sw.sweep_scan, sw.hfel_search_traced
    windows, marks = [], []

    def guarded(*a, **kw_):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            res_ = real_scan(*a, **kw_)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        windows.append(kw_["n_rounds"])
        return res_

    def timed_search(*a, **kw_):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        res_ = real_search(*a, **kw_)
        ev[1].record()
        marks.append(ev)
        return res_

    sw.sweep_scan, sw.hfel_search_traced = guarded, timed_search
    runner = kern                    # the kernel sweep's runner, reused
    try:
        for assign, R in (("geo", 2), ("hfel", 1)):
            zero_counts()
            windows.clear()
            rf, wf = timed(torch, lambda: runner.run(
                schedulers(labels), R, assign=assign, seeds=seeds,
                fused=True))
            pf = runner.params_b
            ro, wo = timed(torch, lambda: runner.run(
                schedulers(labels), R, assign=assign, seeds=seeds,
                fused="oracle"))
            read_counts(f"sweep d ({assign}: fused + oracle, {R} rounds "
                        "each)", {"masked_aggregate": 2 * R * per_round,
                                  **k6_rounds(sp, 2 * R, n_test)})
            dmax = lanes_close(pf, runner.params_b)
            print(f"sweep d {assign}: fused {wf:.3f} s (n_dispatches "
                  f"{rf['n_dispatches']}), oracle {wo:.3f} s "
                  f"(n_dispatches {ro['n_dispatches']}); T_i "
                  f"{rf['T_i'].tolist()}; max |dparam| {dmax:.3e}; sync "
                  f"debug windows {windows}")
            check(windows == [R] + [1] * R and rf["n_dispatches"] == 1
                  and ro["n_dispatches"] == R,
                  f"sweep d {assign}: windows {windows}")
            for k in ("acc", "T_i", "E_i", "iters"):
                check(np.array_equal(rf[k], ro[k]),
                      f"sweep d {assign}: fused {k} differs from oracle")
            check(dmax <= PARAM_TOL, f"sweep d {assign}: params {dmax}")
            out[f"fused_{assign}_s"], out[f"oracle_{assign}_s"] = wf, wo
            if assign == "geo":
                out["p16"]["fused"] = (rf, {k: v.cpu()
                                            for k, v in pf.items()})
    finally:
        sw.sweep_scan, sw.hfel_search_traced = real_scan, real_search
    torch.cuda.synchronize()
    searches = [a.elapsed_time(b) / 1e3 for a, b in marks]
    check(len(searches) == 2, f"sweep d: {len(searches)} HFEL searches")
    print(f"sweep d: hfel_search_traced, {S} lanes x HFEL-40/80 K=16, "
          f"200-step cold and 80-step warm solves, inside the fused and the "
          f"oracle round (CUDA events): {[round(t, 3) for t in searches]} s")
    out["hfel_search_s"] = searches
    del runner, kern
    lap("d")

    # ---- e. a 2-round int8 sweep: one K4 launch a hop for all lanes
    zero_counts()
    r8 = sw.SweepRunner(sp, worlds, **kw, compression=comp.CompressionConfig(
        codec="int8"))
    res8, w8 = timed(torch, lambda: r8.run(schedulers(labels), 2,
                                           seeds=seeds))
    out["int8_launches"] = read_counts(
        "sweep e (int8, 2 rounds)",
        {"masked_decode_aggregate": 2 * per_round,
         **k6_rounds(sp, 2, n_test)})["masked_decode_aggregate"]
    print(f"sweep e int8: {w8:.3f} s for 2 rounds; msg_bits "
          f"{res8['msg_bits_per_round']:.0f} vs {rk['msg_bits_per_round']:.0f}"
          f"; T_i {res8['T_i'].tolist()}; acc {res8['acc'].tolist()}")
    check(np.isfinite(res8["acc"]).all() and np.isfinite(res8["T_i"]).all()
          and res8["msg_bits_per_round"] * 3.9 < rk["msg_bits_per_round"],
          "sweep e: int8 records")
    check(all(bool(torch.isfinite(v).all()) for v in r8.params_b.values()),
          "sweep e: non-finite params")
    del r8
    lap("e")
    torch.cuda.empty_cache()
    print(f"sweep phase: peak memory {peak_gb(torch)}")
    return out


def attention_pairs(S: int, causal: bool, window: int) -> int:
    """Unmasked (query, key) pairs of one (batch, head): the work these
    inputs need."""
    q = np.arange(S)
    hi = q + 1 if causal else np.full(S, S)
    lo = np.maximum(0, q - window + 1) if window > 0 else np.zeros(S)
    return int((hi - lo).sum())


def time_events(torch, fn, reps: int) -> float:
    """Eager ms per call of ``fn`` by CUDA events, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def flash_phase(torch, rate):
    """K5 against its plain version at FA_CASES; times at FA_MAIN."""
    from repro_torch.kernels.flash_attention import ops as fa
    sdpa = torch.nn.functional.scaled_dot_product_attention
    g = torch.Generator(device="cuda").manual_seed(1)
    res = {"err": 0.0}
    for tag, B, S, Hq, Hkv, d, window, dtype_name in FA_CASES:
        dtype = getattr(torch, dtype_name)
        width = FA_STAGED_WIDTH if tag == FA_STAGED[0] else d
        q, k, v = (torch.randn(B, S, h, width, generator=g, device="cuda")
                   .to(dtype)[..., :d] for h in (Hq, Hkv, Hkv))
        if tag == FA_SHIFTED[0]:
            v = torch.cat([v.new_zeros(1), v.flatten()])[1:].view(v.shape)
        path = ("tf32x3" if dtype == torch.float32 else "wgmma_staged"
                if tag in ("hd 20 (no TMA)", FA_SHIFTED[0], FA_STAGED[0])
                else "wgmma")
        by0 = dict(fa.flash_attention_cuda.launches_by_path)
        got = fa.flash_attention(q, k, v, causal=True, window=window)
        by0[path] += 1
        check(fa.kernel_path(q, k, v) == path
              and fa.flash_attention_cuda.launches_by_path == by0,
              f"flash_attention {tag}: not launched on the {path} kernel")
        ref = fa.flash_attention_ref(q, k, v, causal=True, window=window)
        torch.cuda.synchronize()
        diff = (got.float() - ref.float()).abs()
        err = float(diff.max())
        rtol, atol = FA_TOL[dtype_name]
        check(bool((diff <= atol + rtol * ref.float().abs()).all()),
              f"flash_attention {tag} B={B} S={S} Hq={Hq} Hkv={Hkv} d={d} "
              f"window={window} {dtype_name}: max_abs_err {err}")
        res["err"] = max(res["err"], err)
        line = (f"flash_attention {tag:16s} B={B} S={S:5d} Hq={Hq:2d} "
                f"Hkv={Hkv} d={d:3d} window={window:2d} {dtype_name} "
                f"[{path}]: max_abs_err={err:.3e} (rtol {rtol:.3g}, atol "
                f"{atol:g})")
        timed = ("prefill", FA_SHIFTED[0], FA_STAGED[0], FA_F32[0])
        if tag in timed + ("long",):
            t_k, e_k = time_ms(lambda: fa.flash_attention(q, k, v),
                               10 if dtype == torch.float32 else 20)
            line += f" kernel_ms={t_k:.4f} eager_ms={e_k:.4f}"
        if tag in timed:
            t_p = time_events(torch, lambda: fa.flash_attention_ref(q, k, v),
                              2)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            lib = sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)
            lib_err = float((lib.transpose(1, 2).float()
                             - ref.float()).abs().max())
            extra = {}
            if tag in (FA_SHIFTED[0], FA_STAGED[0]):
                check(torch.equal(got, fa.flash_attention(
                    q.clone(), k.clone(), v.clone())),
                      f"flash_attention {tag}: differs from the wgmma "
                      "kernel on clones of its inputs")
                t_copy = time_events(torch, lambda: [fa.tma_ready(x)
                                                     for x in (q, k, v)], 5)
                # SDPA on the layout as it lies is no yardstick (at
                # FA_SHIFTED its answer is wrong): the library time is
                # SDPA's on clones (clone, unlike contiguous, also moves
                # a misaligned view), the clones' own time beside it
                t_c = time_events(torch, lambda: [x.clone()
                                                  for x in (q, k, v)], 5)
                qt, kt, vt = (x.clone().transpose(1, 2) for x in (q, k, v))
                clone_err = float((sdpa(qt, kt, vt, is_causal=True,
                                        enable_gqa=True).transpose(1, 2)
                                   .float() - ref.float()).abs().max())
                print(f"flash_attention {tag}: its copies (tma_ready) "
                      f"{t_copy:.4f} ms of kernel_ms; q, k, v .clone() "
                      f"{t_c:.4f} ms; sdpa on the clones max_abs_err vs "
                      f"plain {clone_err:.3e}, on the view as it lies "
                      f"{lib_err:.3e}")
                extra = dict(copy_ms=t_copy, clone_ms=t_c,
                             library_err=clone_err,
                             library_err_on_view=lib_err)
                lib_err = clone_err
            t_l = time_events(torch, lambda: sdpa(
                qt, kt, vt, is_causal=True, enable_gqa=True), 5)
            flops = 4 * d * attention_pairs(S, True, window) * B * Hq
            nbytes = (2 * B * S * Hq * d + 2 * B * S * Hkv * d) \
                * q.element_size()
            by_bytes = nbytes / rate
            by_flops = (flops / BF16_FLOPS if dtype == torch.bfloat16
                        else FA_F32_PRODUCTS * flops / TF32_FLOPS)
            row = dict(ms=t_k, eager_ms=e_k, plain_ms=t_p, library_ms=t_l,
                       bound_ms=max(by_bytes, by_flops) * 1e3,
                       bound_by="bytes" if by_bytes >= by_flops
                       else "operations", **extra)
            line += (f" plain_ms={t_p:.4f} library_ms={t_l:.4f} (sdpa "
                     f"max_abs_err vs plain {lib_err:.3e}) bound_ms="
                     f"{row['bound_ms']:.4f} ({row['bound_by']}: "
                     f"{flops:.4g} flops, {nbytes / 1e6:.1f} MB)")
            if dtype == torch.bfloat16:
                floor = max(by_bytes, FA_FLOOR * by_flops) * 1e3
                line += f" kernel_floor_ms={floor:.4f}"
            else:
                line += (f" ({FA_F32_PRODUCTS} TF32 products a pair; at "
                         f"the f32 FMA rate {flops / F32_FLOPS * 1e3:.4f} "
                         "ms)")
            if tag == "prefill":
                res.update(row)
            else:
                res[tag.replace(" ", "_")] = row
        print(line)
        del q, k, v, got, ref, diff
    return res


def logits_gap(a, b):
    """(max |a - b| / max |b|, share of positions whose argmax agrees)."""
    a, b = a.float(), b.float()
    rel = float((a - b).abs().max()) / float(b.abs().max())
    return rel, float((a.argmax(-1) == b.argmax(-1)).float().mean())


def timed(torch, fn):
    """(fn(), host seconds ending in a device synchronise)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def peak_gb(torch) -> str:
    return f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB"


def lm_phases(torch, rate, zero_counts, read_counts):
    """Phases 8-11: K5, then chatglm3-6b's prefill and serving paths."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.launch import serve_lm
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import transformer as T

    torch.cuda.reset_peak_memory_stats()
    out = {"kernel": flash_phase(torch, rate)}
    print(f"flash_attention phase: peak memory {peak_gb(torch)}")
    full = get_config(LM_ARCH)
    V = full.vocab_size
    g = torch.Generator(device="cuda").manual_seed(LM_SEED)

    def prefill(cfg, params, tokens, impl, expect):
        zero_counts()
        logits, secs = timed(torch, lambda: make_prefill_step(cfg, impl)(
            params, {"tokens": tokens}))
        label = (f"{cfg.name} n_layers={cfg.n_layers} {cfg.dtype} prefill "
                 f"impl={impl}")
        read_counts(label, {"flash_attention": expect})
        by_path = dict.fromkeys(fa.PATHS, 0)
        by_path["tf32x3" if cfg.dtype == "float32" else "wgmma"] = expect
        got = fa.flash_attention_cuda.launches_by_path
        print(f"{label} flash_attention launches by path: {got} (expected "
              f"{by_path})")
        check(got == by_path, f"{label}: K5 launches by path {got}")
        check(bool(torch.isfinite(logits).all()),
              f"{impl} prefill logits not finite")
        print(f"  prefill impl={impl} B={tokens.shape[0]} "
              f"S={tokens.shape[1]}: {secs:.4f} s, peak memory "
              f"{peak_gb(torch)}")
        return logits

    def serve(cfg, params, prompt, gen):
        zero_counts()
        res = serve_lm.serve(params, cfg, prompt, gen,
                             keep_prompt_logits=True)
        read_counts(f"{cfg.name} n_layers={cfg.n_layers} serve_lm loop", {})
        step_ms = res["decode_s"] / gen * 1e3
        print(f"  serve_lm B={prompt.shape[0]} prompt={prompt.shape[1]} "
              f"gen={gen}: prefill {res['prefill_s']:.4f} s, decode "
              f"{res['decode_s']:.4f} s ({step_ms:.2f} ms a step), "
              f"{res['tok_s']:.1f} tok/s, peak memory {peak_gb(torch)}")
        toks = res["tokens"]
        check(toks.shape == (prompt.shape[0], gen)
              and int(toks.min()) >= 0 and int(toks.max()) < V,
              "serve_lm tokens out of range")
        check(bool(torch.isfinite(res["prompt_logits"]).all()),
              "serve_lm prompt logits not finite")
        return res

    # ---- A': two layers at full width, f32 (the tight oracle)
    torch.cuda.reset_peak_memory_stats()
    cfg2 = dataclasses.replace(full, n_layers=2, dtype="float32")
    params, secs = timed(torch, lambda: T.init(g, cfg2, device="cuda"))
    print(f"A' {cfg2.name} n_layers=2 f32: init {secs:.3f} s")
    tokens = torch.randint(0, V, (LM_BATCH, LM_SEQ), generator=g,
                           device="cuda")
    lk = prefill(cfg2, params, tokens, "kernel", cfg2.n_layers)
    lp = prefill(cfg2, params, tokens, "plain", 0)
    rel, agree = logits_gap(lk, lp)
    print(f"A' kernel vs plain prefill: max|diff|/max|logits| {rel:.3e} "
          f"(limit {LM_F32_TOL:g}), argmax agreement {agree:.4f}, "
          f"max|logits| {float(lp.abs().max()):.3f}")
    check(rel <= LM_F32_TOL, f"A': kernel vs plain prefill {rel}")
    del lk, lp
    prompt = torch.randint(0, V, (SERVE_BATCH, SERVE_PROMPT), generator=g,
                           device="cuda")
    res = serve(cfg2, params, prompt, 8)
    pre = prefill(cfg2, params, prompt, "kernel", cfg2.n_layers)
    rel, agree = logits_gap(res["prompt_logits"], pre)
    print(f"A' decode vs kernel prefill over the prompt: max|diff|/"
          f"max|logits| {rel:.3e} (limit {LM_F32_TOL:g}), argmax "
          f"agreement {agree:.4f}")
    check(rel <= LM_F32_TOL, f"A': decode vs prefill {rel}")
    del params, res, pre
    torch.cuda.empty_cache()

    # ---- A: all 28 layers, bf16
    torch.cuda.reset_peak_memory_stats()
    params, secs = timed(torch, lambda: T.init(g, full, device="cuda"))
    n_params = sum(x.numel() for x in _leaves(params))
    check(n_params == full.param_count(), f"{n_params} parameters")
    print(f"A {full.name} n_layers={full.n_layers} {full.dtype}: "
          f"{n_params} f32 parameters drawn on the card in {secs:.3f} s, "
          f"peak memory {peak_gb(torch)}")
    tokens = torch.randint(0, V, (LM_BATCH, LM_SEQ), generator=g,
                           device="cuda")
    prefill(full, params, tokens, "kernel", full.n_layers)   # warm-up
    lk = prefill(full, params, tokens, "kernel", full.n_layers)
    out["launches"] = full.n_layers
    lp = prefill(full, params, tokens, "plain", 0)
    lp = prefill(full, params, tokens, "plain", 0)
    rel, agree = logits_gap(lk, lp)
    print(f"A kernel vs plain prefill: max|diff|/max|logits| {rel:.3e} "
          f"(limit {LM_BF16_REL:g}), argmax agreement {agree:.4f} (limit "
          f"{LM_BF16_AGREE:g}), max|logits| {float(lp.abs().max()):.3f}")
    check(rel <= LM_BF16_REL and agree >= LM_BF16_AGREE,
          f"A: kernel vs plain prefill {rel}, {agree}")
    f32 = prefill(dataclasses.replace(full, dtype="float32"), params,
                  tokens, "plain", 0)
    for impl, lg in (("kernel", lk), ("plain", lp)):
        rel, agree = logits_gap(lg, f32)
        print(f"A bf16 {impl} prefill vs f32 plain prefill: max|diff|/"
              f"max|logits| {rel:.3e}, argmax agreement {agree:.4f}")
    del lk, lp, f32
    torch.cuda.empty_cache()

    # ---- B: the serving loop on the full model
    torch.cuda.reset_peak_memory_stats()
    prompt = torch.randint(0, V, (SERVE_BATCH, SERVE_PROMPT), generator=g,
                           device="cuda")
    res = serve(full, params, prompt, SERVE_GEN)
    pre = prefill(full, params, prompt, "kernel", full.n_layers)
    rel, agree = logits_gap(res["prompt_logits"], pre)
    print(f"B decode vs kernel prefill over the prompt: max|diff|/"
          f"max|logits| {rel:.3e} (limit {LM_BF16_REL:g}), argmax "
          f"agreement {agree:.4f} (limit {LM_BF16_AGREE:g})")
    check(rel <= LM_BF16_REL and agree >= LM_BF16_AGREE,
          f"B: decode vs prefill {rel}, {agree}")
    del res, pre

    # ---- where the time goes: one kernel prefill, one decode step
    cache = T.init_cache(full, SERVE_BATCH, SERVE_PROMPT, device="cuda")
    step = make_serve_step(full)
    zero_counts()
    profiled(torch, "A kernel prefill B=2 S=4096", lambda: make_prefill_step(
        full, "kernel")(params, {"tokens": tokens}))
    profiled(torch, "B decode step B=8", lambda: step(
        params, cache, prompt[:, :1], 0))
    read_counts("profiled prefill and decode step (each run twice)",
                {"flash_attention": 2 * full.n_layers})
    del params, cache
    torch.cuda.empty_cache()
    return out


def profiled(torch, label, fn, warm_up=True):
    """Run ``fn`` under torch.profiler (after one warm-up call unless the
    caller's code is warm already); print wall, device busy time and the
    kernels that took the most, and return the busy share of the wall.
    Only the CUDA activity is recorded: the
    kernels' times are the same, and on a 4-lane sweep round recording
    the CPU activity too made the profile's post-processing ~30 s
    longer."""
    from torch.profiler import ProfilerActivity, profile
    if warm_up:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, wall = timed(torch, fn)
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kern) / 1e6
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:6]
    print(f"profiled {label}: wall {wall:.4f} s, device busy {busy:.4f} s "
          f"({busy / wall:.1%}); top device time: " + "; ".join(
              f"{e.key[:60]} {e.self_device_time_total / 1e3:.2f} ms "
              f"x{e.count}" for e in top))
    return busy / wall


def _paths(tree, prefix=()):
    """Key paths of a params tree, in ``tree_leaves``' order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in _paths(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree)
                for p in _paths(v, prefix + (str(i),))]
    return [prefix]


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def async_phase(torch, sp, pop, fed, zero_counts, read_counts, H=50):
    """Phase 12: the async engine and the serve CLI on the world (sp,
    pop, fed) with cohorts of H; of the kernels only K6 may launch, L
    local steps of the CNN a dispatch and an evaluation a round."""
    import tempfile

    from repro_torch.checkpoint import ckpt
    from repro_torch.core.async_engine import AsyncConfig, AsyncHFLEngine
    from repro_torch.core.framework import round_step_core
    from repro_torch.launch import serve

    cfg = AsyncConfig(H=H, scheduler="fedavg", alloc_steps=200, seed=0,
                      device=pop.u.device.type)
    out = {}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    k6 = dict.fromkeys(k6_launches(0), 0)

    def tally(recs, eng):
        """Add K6's launches of async rounds ``recs`` of ``eng``."""
        add(k6_launches(eng.sp.L * sum(r["n_dispatches"] for r in recs),
                        sum(r["acc"] is not None for r in recs),
                        len(eng.fed.y_test)))

    def add(launches):
        for k, v in launches.items():
            k6[k] += v

    def timed_round(eng, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rec = eng.step_round(**kw)
        torch.cuda.synchronize()
        rec["wall_s"] = time.perf_counter() - t0
        print(f"  async round {rec['round']}: " + json.dumps(rec))
        return rec

    # ---- a. always-on async round against the synchronous round
    eng = AsyncHFLEngine(sp, pop, fed, cfg)
    params = {k: v.clone() for k, v in eng.model_params.items()}
    rec = timed_round(eng)
    s = torch.from_numpy(eng.last_sched.astype(np.int64)).to(eng.device)
    a = torch.from_numpy(eng.last_assign.astype(np.int64)).to(eng.device)
    params, (T, E, _, _, b, f) = round_step_core(
        eng.apply_fn, eng.sp, params, pop.u[s], pop.D[s], pop.p[s],
        pop.g[s], pop.g_cloud, pop.B_m, eng.X[s], eng.y[s], eng.mask[s],
        pop.D[s], a, cfg.lr, M=sp.n_edges, L=sp.L, Q=sp.Q,
        alloc_steps=cfg.alloc_steps)
    tally([rec], eng)
    add(k6_launches(sp.Q * sp.L))                     # the sync round
    rel = [abs(rec["T_i"] - float(T)) / float(T),
           abs(rec["E_i"] - float(E)) / float(E)]
    dmax = max(float((eng.model_params[k] - params[k]).abs().max())
               for k in params)
    print(f"12a always-on async vs sync round: T_i {rec['T_i']} vs "
          f"{float(T)}, E_i {rec['E_i']} vs {float(E)} (relative "
          f"{rel[0]:.2e}, {rel[1]:.2e}), max |dparam| {dmax:.3e} (tolerance "
          f"{PARAM_TOL}), {rec['n_dispatches']} dispatches, wall "
          f"{rec['wall_s']:.3f} s")
    check(torch.equal(eng.last_alloc[0], b) and
          torch.equal(eng.last_alloc[1], f), "12a: b/f differ from sync")
    check(max(rel) <= 1e-5, f"12a: T_i/E_i differ by {rel}")
    check(dmax <= PARAM_TOL, f"12a: params differ by {dmax}")
    check(rec["n_updates"] == sp.Q * cfg.H and rec["n_stale"] == 0
          and rec["forced_flushes"] == 0, f"12a: accounting {rec}")
    check(math.isfinite(rec["acc"]), "12a: accuracy not finite")
    out["a"] = {k: rec[k] for k in ("wall_s", "n_dispatches", "T_i",
                                    "E_i", "acc")}
    out["a"]["max_dparam"] = dmax

    # ---- b. the stationary preset, 5-slot buffers
    trace = serve.build_trace("stationary", sp.n_devices, seed=0)
    engb = AsyncHFLEngine(sp, pop, fed,
                          dataclasses.replace(cfg, buffer_size=5),
                          trace=trace)
    recs, t_prev = [], 0.0
    for _ in range(ASYNC_ROUNDS):
        r = timed_round(engb)
        check(r["n_updates"] <= sp.Q * cfg.H and r["n_aborted"] >= 0
              and r["wasted_j"] >= 0 and r["t"] > t_prev
              and all(math.isfinite(r[k]) for k in ("acc", "T_i", "E_i")),
              f"12b: inconsistent record {r}")
        t_prev = r["t"]
        recs.append(r)
    check(all(bool(torch.isfinite(v).all())
              for v in engb.model_params.values()), "12b: params")
    out["b"] = [{k: r[k] for k in ("wall_s", "n_dispatches", "n_updates",
                                   "n_stale", "n_aborted", "T_i")}
                for r in recs]
    tally(recs, engb)
    print("12b stationary, buffer 5: " + "; ".join(
        f"round {i + 1}: {r['n_dispatches']} dispatches, {r['n_updates']} "
        f"updates ({r['n_stale']} stale, {r['n_aborted']} aborted), wall "
        f"{r['wall_s']:.3f} s" for i, r in enumerate(recs)))
    del engb

    # ---- c. the serve CLI at its defaults, checkpointing every round
    with tempfile.TemporaryDirectory() as d:
        lines, engines = [], []
        t0 = time.perf_counter()
        summary = serve.run_serve(traffic="stationary", rounds=3,
                                  ckpt_every=1, ckpt_dir=d,
                                  log=lines.append, engine_out=engines,
                                  device=cfg.device)
        serve_s = time.perf_counter() - t0
        recs_c = [json.loads(line) for line in lines]
        check([r["round"] for r in recs_c] == [1, 2, 3]
              and summary["n_checkpoints"] == 3
              and ckpt.latest_step(d) == 3, "12c: rounds or checkpoints")
        params_c = engines[0].model_params
        back = ckpt.restore_pytree(params_c, d)
        check(all(np.array_equal(back[k], v.cpu().numpy())
                  for k, v in params_c.items()),
              "12c: the restored checkpoint differs from the params")
    lines8, engines8 = [], []
    serve.run_serve(traffic="stationary", rounds=1, codec="int8",
                    log=lines8.append, engine_out=engines8,
                    device=cfg.device)
    r8 = json.loads(lines8[0])
    tally(recs_c, engines[0])
    tally([r8], engines8[0])

    def bits_a_message(r):          # (updates + one upload an edge) msgs
        return r["msg_bits"] / (r["n_updates"] + engines[0].pop.n_edges)
    ratio = bits_a_message(recs_c[0]) / bits_a_message(r8)
    print(f"12c run_serve (40 devices, H=20, stationary, 3 rounds, "
          f"checkpoint a round): {serve_s:.3f} s, final acc "
          f"{summary['final_acc']:.4f}, updates {summary['n_updates']}; "
          f"checkpoint restored bit for bit; int8 round: {r8['n_updates']} "
          f"updates, bits a message {ratio:.3f}x fewer")
    check(ratio > 3.9, f"12c: int8 message ratio {ratio}")
    out["c"] = {"serve_s": serve_s, "final_acc": summary["final_acc"],
                "int8_msg_ratio": ratio}

    read_counts("async phase (12a-c)", k6)
    print(f"async phase: peak memory {peak_gb(torch)}")

    # ---- d. one profiled always-on round
    profiled(torch, "async round (always-on, N=100, H=50)",
             lambda: eng.step_round(), warm_up=False)
    return out


class MoERouting:
    """While active, records the routing of every MoE forward: each
    choice's expert (T, k) and whether it got a slot (T, k), in the
    forward's flattened token order, on the device. With ``replay`` (a
    list of such (experts, kept) pairs, one a forward in call order)
    the forwards take those decisions instead of their own while the
    list lasts (see ``forced_routing``)."""

    def __init__(self, replay=()):
        import torch
        from repro_torch.models import moe
        self.torch, self.moe, self.real = torch, moe, moe.moe_route
        self.calls, self.replay = [], list(replay)

    def __enter__(self):
        def spy(params, xf, cfg, gd=1):
            r = self.real(params, xf, cfg, gd)
            if self.replay:
                r = forced_routing(r, *self.replay.pop(0))
            self.calls.append((r.top_idx, r.keep.reshape(r.top_idx.shape)))
            return r
        self.moe.moe_route = spy
        return self

    def __exit__(self, *exc):
        self.moe.moe_route = self.real

    def prefill(self, B, S):
        """(experts, kept), each (layers, B, S, k), of one forward."""
        return tuple(self.torch.stack([c[i] for c in self.calls])
                     .reshape(len(self.calls), B, S, -1) for i in (0, 1))

    def decode(self, B, steps, n_moe):
        """(experts, kept), each (n_moe, B, steps, k), of the first
        ``steps`` decode steps (n_moe layers a step, B tokens each)."""
        calls = self.calls[:steps * n_moe]
        return tuple(self.torch.stack([c[i] for c in calls])
                     .reshape(steps, n_moe, B, -1).permute(1, 2, 0, 3)
                     for i in (0, 1))

    def drops(self):
        """Token-layers that lost a choice, over every forward seen."""
        return sum(int((~c[1]).any(1).sum()) for c in self.calls)

    def as_decode_replay(self, B, S):
        """This prefill's routing as a decode loop's replay list: step t
        of the first S, layer by layer, its B tokens at position t."""
        idx, keep = self.prefill(B, S)
        return [(idx[layer, :, t], keep[layer, :, t]) for t in range(S)
                for layer in range(idx.shape[0])]


def forced_routing(r, idx, keep):
    """Routing ``r`` (from ``moe_route``) with the experts ``idx`` (T, k)
    and the kept choices ``keep`` (T, k) of another run: each kept
    choice gets its own slot (the buffer grows if more than the forward's
    capacity chose one expert) and the weights are renormalised from
    this run's own router probabilities at those experts. Two runs that
    differ only in their numerics then dispatch every token alike, so
    their outputs can be held position by position, which a near-tie of
    two router probabilities would otherwise prevent."""
    import torch
    E = r.probs.shape[1]
    flat, kf = idx.reshape(-1), keep.reshape(-1)
    oh = ((flat[:, None] == torch.arange(E, device=flat.device))
          & kf[:, None]).to(torch.int32)
    pos = (torch.cumsum(oh, 0) - 1).gather(1, flat[:, None])[:, 0]
    w = r.probs.gather(1, idx)
    return r._replace(top_w=w / w.sum(-1, keepdim=True), top_idx=idx,
                      pos=pos, keep=kf,
                      capacity=max(1, int(oh.sum(0).max())))


def routing_diverged(a, b):
    """(B, S) bool: tokens that lost a choice in either routing ``a``,
    ``b`` (from ``MoERouting.prefill``/``decode``), or whose experts
    differ between them, in any layer."""
    (ea, ka), (eb, kb) = a, b
    return ((ea != eb).any(-1) | ~ka.all(-1) | ~kb.all(-1)).any(0)


def undiverged(diverged):
    """(B, S) bool: positions before each sequence's first diverged
    token. A dropped choice, or another expert, changes that token's
    hidden state and, through attention or the SSM state, every later
    one of its sequence, but nothing before it; so two runs agree there
    as two runs of a dense model do."""
    import torch
    S = diverged.shape[1]
    pos = torch.arange(S, device=diverged.device)
    first = torch.where(diverged, pos, S).min(dim=1).values
    return pos[None, :] < first[:, None]


def moe_gap(a, b, ra, rb, label):
    """logits_gap of ``a`` and ``b`` on the positions before each
    sequence's first token routed differently by ``ra`` and ``rb``;
    prints what was excluded. Returns (rel, agree, positions)."""
    div = routing_diverged(ra, rb)
    keep = undiverged(div)
    drops = int((~ra[1].all(-1) | ~rb[1].all(-1)).any(0).sum())
    flips = int((ra[0] != rb[0]).any(-1).any(0).sum())
    rel, agree = logits_gap(a[keep], b[keep])
    print(f"{label}: {drops} tokens lost a choice and {flips} were routed "
          f"to other experts (either side, any layer); compared on the "
          f"{int(keep.sum())} of {keep.numel()} positions before each "
          f"sequence's first: max|diff|/max|logits| {rel:.3e}, argmax "
          f"agreement {agree:.4f}")
    return rel, agree, int(keep.sum())


def seq_payload_phase(torch, sp, pop, zero_counts, read_counts, H=50, K=10,
                      size_range=(400, 700)):
    """Phase 13: the registry's decoders as HFL sequence payloads on the
    Table-I world (N=100, M=5, D_n in [400, 700], H=50, K=10, IKC, geo,
    200-step allocations, the kernels on)."""
    from repro_torch.configs.registry import HFL_SMOKE_ARCHS, get_smoke_config
    from repro_torch.core import sweep as sw
    from repro_torch.core.framework import FrameworkConfig, HFLFramework
    from repro_torch.data import make_seq_dataset, partition_noniid
    from repro_torch.kernels.hier_agg.ops import LEAF_CAPACITY

    per_round = sp.Q + 1
    out = {"k1": {}, "k2": {}}
    for arch in HFL_SMOKE_ARCHS[1:]:
        t_arch = time.perf_counter()
        vocab = min(257, get_smoke_config(arch).vocab_size)
        X, y, Xt, yt = make_seq_dataset(n_train=20_000, n_test=2_000, seed=0,
                                        vocab_size=vocab)
        fed = partition_noniid(X, y, Xt, yt, n_devices=sp.n_devices,
                               size_range=size_range, seed=0)
        cfg = FrameworkConfig(arch=arch, H=H, K=K, scheduler="ikc",
                              assigner="geo", agg_kernel=True,
                              use_kernel=True, alloc_steps=200)
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        fw, setup_s = timed(torch, lambda: HFLFramework(sp, pop, fed, cfg))
        n = len(fw.model_params)
        widths = sorted(v.numel() for v in fw.model_params.values())
        k1 = -(-n // LEAF_CAPACITY) * per_round
        recs = run_rounds(torch, fw, (1,), f"13 {arch}")
        got = read_counts(f"13 {arch} (clustering + 1 round)", {
            "masked_aggregate": k1,
            "pairwise_sq_dists": 8 * ((K - 1) + 50 + 1)})
        out["k1"][arch] = got["masked_aggregate"]
        out["k2"][arch] = got["pairwise_sq_dists"]
        mini = fw.clustering_stats["aux_bits"] / 32
        print(f"13 {arch}: {n} leaves (widths {widths[0]}..{widths[-1]}), "
              f"{fw.model_bits / 8:.0f} bytes a model, xi P={mini:.0f}, "
              f"setup {setup_s:.3f} s (clustering "
              f"{fw.setup_seconds['cluster']:.3f} s), ari "
              f"{fw.clustering_stats['ari']:.3f}, round wall "
              f"{recs[0]['wall_s']:.3f} s, peak memory {peak_gb(torch)}")
        if arch == ZOO_MOE:
            # a second round, kernel aggregation against the plain matmul
            plain = fork(fw, agg_kernel=False)
            rk, rp = fw.run_round(2), plain.run_round(2)
            dmax = max(float((fw.model_params[k] - plain.model_params[k])
                             .abs().max()) for k in fw.model_params)
            print(f"13 {arch} round 2 kernel vs plain matmul: T_i "
                  f"{rk['T_i']} vs {rp['T_i']}, E_i {rk['E_i']} vs "
                  f"{rp['E_i']}, max |dparam| {dmax:.3e} (tolerance "
                  f"{PARAM_TOL}), seconds {rk['seconds']}")
            check(rk["T_i"] == rp["T_i"] and rk["E_i"] == rp["E_i"],
                  f"13 {arch}: T_i/E_i differ between the backends")
            check(dmax <= PARAM_TOL, f"13 {arch}: params differ by {dmax}")
            del plain
        if arch == ZOO_SSM:
            # a 2-lane sweep round, fused against the per-round oracle;
            # one lane at a time (lane_chunk=1): the vmapped training of
            # one lane's cohort holds ~50 GB of activations
            labels = fw.scheduler.state.clusters
            runner = sw.SweepRunner(sp, [(pop, fed)] * 2, lr=cfg.lr,
                                    alloc_steps=200, agg_kernel=True,
                                    arch=arch, lane_chunk=1)

            def scheds():
                return [sw.build_scheduler("ikc", fed, sp, H, K=K, seed=s,
                                           arch=arch, labels=labels)
                        for s in (0, 1)]
            zero_counts()
            rf, wf = timed(torch, lambda: runner.run(
                scheds(), 1, seeds=[0, 1], fused=True))
            pf = runner.params_b
            ro, wo = timed(torch, lambda: runner.run(
                scheds(), 1, seeds=[0, 1], fused="oracle"))
            read_counts(f"13 {arch} sweep (2 lanes one at a time, fused "
                        "+ oracle)", {"masked_aggregate": 2 * 2 * k1})
            dmax = max(float((pf[k] - runner.params_b[k]).abs().max())
                       for k in pf)
            print(f"13 {arch} sweep 2 lanes: fused {wf:.3f} s, oracle "
                  f"{wo:.3f} s; T_i {rf['T_i'].tolist()} vs "
                  f"{ro['T_i'].tolist()}; acc {rf['acc'].tolist()}; max "
                  f"|dparam| {dmax:.3e}; peak memory {peak_gb(torch)}")
            for k in ("acc", "T_i", "E_i", "iters"):
                check(np.array_equal(rf[k], ro[k]),
                      f"13 {arch} sweep: fused {k} differs from oracle")
            check(dmax <= PARAM_TOL, f"13 {arch} sweep: params {dmax}")
            del runner
        print(f"13 {arch}: {time.perf_counter() - t_arch:.1f} s")
        del fw
        torch.cuda.empty_cache()
    return out


def zoo_lm_phase(torch, zero_counts, read_counts):
    """Phase 14: the SSM, MoE and hybrid LM families (bf16 compute, f32
    weights drawn on the card from a seed)."""
    from repro_torch.configs.registry import get_config, get_smoke_config
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.launch import serve_lm
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import mamba2 as m2
    from repro_torch.models import transformer as T

    g = torch.Generator(device="cuda").manual_seed(LM_SEED)
    out = {"flash_attention": 0}

    def init(cfg):
        torch.cuda.reset_peak_memory_stats()
        params, secs = timed(torch, lambda: T.init(g, cfg, device="cuda"))
        n = sum(x.numel() for x in _leaves(params))
        print(f"14 {cfg.name} n_layers={cfg.n_layers} {cfg.dtype}: {n} f32 "
              f"parameters (analytic count {cfg.param_count()}) drawn on "
              f"the card in {secs:.3f} s")
        return params

    def prefill(cfg, params, tokens, impl):
        n_attn = sum(cfg.layer_kind(i) == "attn"
                     for i in range(cfg.n_layers))
        expect = n_attn if impl == "kernel" else 0
        zero_counts()
        logits, secs = timed(torch, lambda: make_prefill_step(cfg, impl)(
            params, {"tokens": tokens}))
        label = f"14 {cfg.name} {cfg.dtype} prefill impl={impl}"
        read_counts(label, {"flash_attention": expect})
        if expect:
            q = torch.empty((1, 1, cfg.n_heads, cfg.hd), device="cuda",
                            dtype=cfg.compute_dtype)
            path = fa.kernel_path(q, q, q)
            by_path = dict.fromkeys(fa.PATHS, 0)
            by_path[path] = expect
            got = fa.flash_attention_cuda.launches_by_path
            print(f"{label}: K5 launches by path {got} (expected {by_path})")
            check(got == by_path, f"{label}: K5 launches by path {got}")
            out["flash_attention"] += expect
        check(bool(torch.isfinite(logits).all()), f"{label}: not finite")
        print(f"  {label} B={tokens.shape[0]} S={tokens.shape[1]}: "
              f"{secs:.4f} s, peak memory {peak_gb(torch)}")
        return logits

    def serve(cfg, params, prompt, gen):
        zero_counts()
        res = serve_lm.serve(params, cfg, prompt, gen,
                             keep_prompt_logits=True)
        read_counts(f"14 {cfg.name} serve_lm loop", {})
        print(f"  14 {cfg.name} serve_lm B={prompt.shape[0]} prompt="
              f"{prompt.shape[1]} gen={gen}: prefill {res['prefill_s']:.4f}"
              f" s, decode {res['decode_s']:.4f} s "
              f"({res['decode_s'] / gen * 1e3:.2f} ms a step), "
              f"{res['tok_s']:.1f} tok/s, peak memory {peak_gb(torch)}")
        toks = res["tokens"]
        check(toks.shape == (prompt.shape[0], gen)
              and int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_size,
              f"14 {cfg.name}: serve_lm tokens out of range")
        check(bool(torch.isfinite(res["prompt_logits"]).all()),
              f"14 {cfg.name}: serve_lm prompt logits not finite")
        return res

    def prompt_of(cfg, B=SERVE_BATCH, S=SERVE_PROMPT):
        return torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                             device="cuda")

    # ---- a. mamba2-2.7b: f32 A' (2 layers), then all 64 layers in bf16
    t0 = time.perf_counter()
    full = get_config(ZOO_SSM)
    cfg2 = dataclasses.replace(full, n_layers=2, dtype="float32")
    params = init(cfg2)
    prompt = prompt_of(cfg2)
    res = serve(cfg2, params, prompt, 8)
    pre = prefill(cfg2, params, prompt, "plain")
    rel, agree = logits_gap(res["prompt_logits"], pre)
    print(f"14a A' decode vs prefill over the prompt: max|diff|/max|logits|"
          f" {rel:.3e} (limit {LM_F32_TOL:g}), argmax agreement "
          f"{agree:.4f}")
    check(rel <= LM_F32_TOL, f"14a A': decode vs prefill {rel}")
    # ssd_chunked against the recurrence on layer 0's own inputs
    seen = []
    real_chunked = m2.ssd_chunked

    def spy(*a):
        seen.append(a)
        return real_chunked(*a)
    m2.ssd_chunked = spy
    try:
        prefill(cfg2, params, prompt_of(cfg2, 1, SSD_SEQ), "plain")
    finally:
        m2.ssd_chunked = real_chunked
    x, dt, A, Bm, Cm, chunk = seen[0][:6]
    (yc, tc), (yr, tr) = (timed(torch, lambda: m2.ssd_chunked(
        x, dt, A, Bm, Cm, chunk)), timed(torch, lambda: m2.ssd_reference(
            x, dt, A, Bm, Cm)))
    err = float((yc - yr).abs().max())
    scale = float(yr.abs().max())
    print(f"14a ssd_chunked vs ssd_reference, layer 0 of {full.name} f32, "
          f"x {tuple(x.shape)} chunk {chunk}: max|diff| {err:.3e}, "
          f"max|y| {scale:.3e} (limit {SSD_REL:g} x max|y|); chunked "
          f"{tc:.4f} s, recurrence {tr:.4f} s")
    check(err <= SSD_REL * scale, f"14a ssd_chunked vs reference {err}")
    del params, res, pre, seen, x, dt, Bm, Cm, yc, yr
    torch.cuda.empty_cache()
    params = init(full)
    n = sum(x.numel() for x in _leaves(params))
    # the analytic count holds a second norm a layer and one per-head
    # vector less than the Mamba-2 block has (ROADMAP Queue 3)
    check(abs(n - full.param_count()) <= full.n_layers * full.d_model,
          f"14a: {n} parameters against {full.param_count()}")
    tokens = torch.randint(0, full.vocab_size, (LM_BATCH, LM_SEQ),
                           generator=g, device="cuda")
    prefill(full, params, tokens, "plain")                  # warm-up
    lp = prefill(full, params, tokens, "plain")
    del lp
    prompt = prompt_of(full)
    res = serve(full, params, prompt, SERVE_GEN)
    pre = prefill(full, params, prompt, "plain")
    rel, agree = logits_gap(res["prompt_logits"], pre)
    print(f"14a {full.name} bf16 decode vs prefill over the prompt "
          f"(printed): max|diff|/max|logits| {rel:.3e}, argmax agreement "
          f"{agree:.4f}")
    profiled(torch, f"14a {full.name} prefill B={LM_BATCH} S={LM_SEQ}",
             lambda: make_prefill_step(full, "plain")(
                 params, {"tokens": tokens}), warm_up=False)
    print(f"14a {full.name}: peak memory {peak_gb(torch)}, "
          f"{time.perf_counter() - t0:.1f} s")
    del params, res, pre, tokens
    torch.cuda.empty_cache()

    # ---- b. qwen3-moe-235b-a22b at full width: f32 A' (2 layers), then
    #      MOE_LAYERS of its 94 layers in bf16
    t0 = time.perf_counter()
    full = dataclasses.replace(get_config(ZOO_MOE), n_layers=MOE_LAYERS)
    cfg2 = dataclasses.replace(full, n_layers=2, dtype="float32")
    params = init(cfg2)
    prompt = prompt_of(cfg2)
    with MoERouting() as rk:
        lk = prefill(cfg2, params, prompt, "kernel")
    with MoERouting() as rp:
        lp = prefill(cfg2, params, prompt, "plain")
    rel, _, n = moe_gap(lk, lp, rk.prefill(SERVE_BATCH, SERVE_PROMPT),
                        rp.prefill(SERVE_BATCH, SERVE_PROMPT),
                        f"14b A' {cfg2.name} f32 kernel vs plain prefill")
    check(n > 0 and rel <= LM_F32_TOL, f"14b A': kernel vs plain {rel}")
    with MoERouting() as rd:
        res = serve(cfg2, params, prompt, 8)
    rel, _, n = moe_gap(res["prompt_logits"], lk,
                        rd.decode(SERVE_BATCH, SERVE_PROMPT, cfg2.n_layers),
                        rk.prefill(SERVE_BATCH, SERVE_PROMPT),
                        f"14b A' {cfg2.name} f32 decode vs kernel prefill")
    check(n > 0 and rel <= LM_F32_TOL, f"14b A': decode vs prefill {rel}")
    del params, lk, lp, res
    torch.cuda.empty_cache()

    params = init(full)
    tokens = torch.randint(0, full.vocab_size, (MOE_BATCH, MOE_SEQ),
                           generator=g, device="cuda")
    with MoERouting() as rk:
        lk = prefill(full, params, tokens, "kernel")
    with MoERouting() as rp:
        lp = prefill(full, params, tokens, "plain")
    moe_gap(lk, lp, rk.prefill(MOE_BATCH, MOE_SEQ),
            rp.prefill(MOE_BATCH, MOE_SEQ),
            f"14b {full.name} bf16 kernel vs plain prefill (printed)")
    print(f"  whole prefill (printed): {logits_gap(lk, lp)}")
    with MoERouting(replay=rk.calls):
        lp = prefill(full, params, tokens, "plain")
    rel, agree = logits_gap(lk, lp)
    print(f"14b {full.name} bf16 kernel vs plain prefill, the plain one on "
          f"the kernel run's routing: max|diff|/max|logits| {rel:.3e} "
          f"(limit {LM_BF16_REL:g}), argmax agreement {agree:.4f} (limit "
          f"{LM_BF16_AGREE:g})")
    check(rel <= LM_BF16_REL and agree >= LM_BF16_AGREE,
          f"14b: kernel vs plain prefill {rel}, {agree}")
    del lk, lp
    torch.cuda.empty_cache()
    prompt = prompt_of(full)
    with MoERouting() as rd:
        res = serve(full, params, prompt, SERVE_GEN)
    with MoERouting() as rk:
        pre = prefill(full, params, prompt, "kernel")
    print(f"14b serve_lm: {rd.drops()} token-layers lost a choice over "
          f"{SERVE_PROMPT + SERVE_GEN} decode steps x {full.n_layers} "
          f"layers (capacity 4 slots an expert a step)")
    moe_gap(res["prompt_logits"], pre,
            rd.decode(SERVE_BATCH, SERVE_PROMPT, full.n_layers),
            rk.prefill(SERVE_BATCH, SERVE_PROMPT),
            f"14b {full.name} bf16 decode vs kernel prefill (printed)")
    with MoERouting(replay=rk.as_decode_replay(SERVE_BATCH, SERVE_PROMPT)):
        res = serve_lm.serve(params, full, prompt, 1,
                             keep_prompt_logits=True)
    rel, agree = logits_gap(res["prompt_logits"], pre)
    print(f"14b {full.name} bf16 decode on the prefill's routing vs kernel "
          f"prefill: max|diff|/max|logits| {rel:.3e} (limit "
          f"{LM_BF16_REL:g}), argmax agreement {agree:.4f} (limit "
          f"{LM_BF16_AGREE:g})")
    check(rel <= LM_BF16_REL and agree >= LM_BF16_AGREE,
          f"14b: decode vs prefill {rel}, {agree}")
    del res, pre
    zero_counts()
    profiled(torch, f"14b {full.name} kernel prefill B={MOE_BATCH} "
             f"S={MOE_SEQ}", lambda: make_prefill_step(full, "kernel")(
                 params, {"tokens": tokens}))
    read_counts("14b profiled prefill (run twice)",
                {"flash_attention": 2 * full.n_layers})
    out["flash_attention"] += 2 * full.n_layers
    print(f"14b {full.name} ({MOE_LAYERS} layers): peak memory "
          f"{peak_gb(torch)}, {time.perf_counter() - t0:.1f} s")
    del params, tokens
    torch.cuda.empty_cache()

    # ---- c. jamba at its smoke config: attention + SSM + MoE
    t0 = time.perf_counter()
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(get_smoke_config(ZOO_HYBRID), dtype=dtype)
        params = init(cfg)
        tokens = torch.randint(0, cfg.vocab_size, (LM_BATCH, 256),
                               generator=g, device="cuda")
        with MoERouting() as rk:
            lk = prefill(cfg, params, tokens, "kernel")
        with MoERouting() as rp:
            lp = prefill(cfg, params, tokens, "plain")
        rel, agree, n = moe_gap(lk, lp, rk.prefill(LM_BATCH, 256),
                                rp.prefill(LM_BATCH, 256),
                                f"14c {cfg.name} {dtype} kernel vs plain "
                                "prefill")
        if dtype == "bfloat16":
            with MoERouting(replay=rk.calls):
                lp = prefill(cfg, params, tokens, "plain")
            rel, agree = logits_gap(lk, lp)
            print(f"14c {cfg.name} bf16 kernel vs plain prefill on the "
                  f"kernel run's routing: max|diff|/max|logits| {rel:.3e}"
                  f", argmax agreement {agree:.4f}")
        if dtype == "float32":
            check(n > 0 and rel <= LM_F32_TOL,
                  f"14c f32: kernel vs plain prefill {rel}")
            prompt = prompt_of(cfg)
            with MoERouting() as rd:
                res = serve(cfg, params, prompt, 8)
            with MoERouting() as rk:
                pre = prefill(cfg, params, prompt, "kernel")
            cache = T.init_cache(cfg, SERVE_BATCH, 8, device="cuda")
            kinds = [sorted(c) for c in cache]
            n_moe = sum(cfg.mlp_kind(i) == "moe" for i in range(cfg.n_layers))
            rel, _, n = moe_gap(res["prompt_logits"], pre,
                                rd.decode(SERVE_BATCH, SERVE_PROMPT, n_moe),
                                rk.prefill(SERVE_BATCH, SERVE_PROMPT),
                                f"14c f32 decode (caches {kinds}) vs kernel "
                                "prefill")
            check(n > 0 and rel <= LM_F32_TOL,
                  f"14c: decode vs prefill {rel}")
            check(kinds == [["k", "v"], ["conv", "ssm"]],
                  f"14c: cache kinds {kinds}")
            del res, pre, cache
        else:
            check(rel <= LM_BF16_REL and agree >= LM_BF16_AGREE,
                  f"14c bf16: kernel vs plain prefill {rel}, {agree}")
        del params, lk, lp
    print(f"14c {ZOO_HYBRID} smoke: peak memory {peak_gb(torch)}, "
          f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    return out


def update_gap(torch, a, b, lr):
    """(max |a - b| / lr, share of elements more than lr/2 apart) over two
    parameter trees (a's leaves are moved to b's device one at a time):
    after an adam step a wrong gradient moves most elements by about lr,
    bf16 noise a few."""
    from repro_torch.utils import tree_leaves
    worst, far, n = 0.0, 0, 0
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        d = (x.to(y.device) - y).abs()
        worst = max(worst, float(d.max()))
        far += int((d > lr / 2).sum())
        n += d.numel()
    return worst / lr, far / n


def grad_gap(torch, a, b):
    """||a - b|| / ||b|| over every leaf of two gradient trees."""
    from repro_torch.utils import tree_leaves
    num = sum(float((x - y).double().square().sum())
              for x, y in zip(tree_leaves(a), tree_leaves(b)))
    den = sum(float(y.double().square().sum()) for y in tree_leaves(b))
    return math.sqrt(num / den)


def raises(exc, fn) -> bool:
    try:
        fn()
    except exc:
        return True
    return False


def train_phase(torch, zero_counts, read_counts):
    """Phase 15: LM training (no kernel: the plain attention, as the
    reference trains)."""
    import os
    import tempfile

    from repro_torch.checkpoint import latest_step, restore_pytree
    from repro_torch.configs.registry import get_config, get_smoke_config
    from repro_torch.data import token_batch_iterator
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.launch import steps as S
    from repro_torch.launch import train as train_cli
    from repro_torch.models import transformer as T
    from repro_torch.utils import tree_leaves, tree_map

    out = {}
    zero_counts()
    t0 = time.perf_counter()

    # ---- a. chatglm3-6b at full width, TRAIN_LAYERS of its 28 layers
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated() / 1e9
    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=TRAIN_LAYERS)
    check(cfg.dtype == "bfloat16" and cfg.remat and cfg.microbatches == 8,
          f"15a: {cfg.name} is not the bf16, remat, 8-microbatch config")
    g = torch.Generator(device="cuda").manual_seed(LM_SEED)
    params = T.init(g, cfg, device="cuda")
    n_params = sum(x.numel() for x in tree_leaves(params))
    check(n_params == cfg.param_count(), f"15a: {n_params} parameters")
    step, opt = S.make_train_step(cfg, lr=TRAIN_LR)
    opt_state = opt.init(params)
    check("m" in opt_state, "15a: make_optimizer did not choose adam")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    print(f"15a {cfg.name} n_layers={TRAIN_LAYERS} of 28, {cfg.dtype} "
          f"compute, {n_params} f32 parameters, adam, microbatches "
          f"{cfg.microbatches}, batch {TRAIN_BATCH} x {TRAIN_SEQ} "
          f"({tokens} tokens a step), remat {cfg.remat}")
    it = token_batch_iterator(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ,
                              seed=LM_SEED)

    def next_batch(source=it, shape=None):
        return {k: torch.from_numpy(v).cuda().reshape(shape or v.shape)
                for k, v in next(source).items()}

    probe = [x.flatten()[:4096].clone() for x in tree_leaves(params)]
    walls, losses = [], []
    for i in range(TRAIN_STEPS):
        batch = next_batch()
        (params, opt_state, m), secs = timed(
            torch, lambda: step(params, opt_state, batch))
        losses.append(float(m["loss"]))
        walls.append(secs)
        print(f"15a step {i + 1}: loss {losses[-1]:.4f}, {secs:.3f} s"
              + (" (the first call)" if i == 0 else ""))
    check(all(math.isfinite(x) for x in losses), f"15a losses {losses}")
    check(all(not torch.equal(p.flatten()[:4096], q)
              for p, q in zip(tree_leaves(params), probe)),
          "15a: a parameter leaf did not move")
    wall = float(np.median(walls[1:]))
    peak = torch.cuda.max_memory_allocated() / 1e9
    mfu = 6 * n_params * tokens / (wall * BF16_FLOPS)
    busy = profiled(torch, f"15a train step (B={TRAIN_BATCH}, "
                    f"S={TRAIN_SEQ}, mb={cfg.microbatches})",
                    lambda: step(params, opt_state, batch), warm_up=False)
    print(f"15a step wall {wall:.4f} s (median of steps 2-{TRAIN_STEPS}), "
          f"{tokens / wall:,.0f} tokens/s, peak memory {peak:.2f} GB "
          f"({resident:.2f} GB resident before), "
          f"device busy {busy:.1%}, model-flops share 6*N*tokens/(t*989e12)"
          f" {mfu:.1%}")
    out["a"] = {"step_s": wall, "walls": walls, "losses": losses,
                "tok_s": tokens / wall, "peak_gb": peak,
                "resident_gb": resident, "busy": busy,
                "mfu": mfu, "n_params": n_params}

    # the path's own step (mb 8, remat on) against remat off and mb 2,
    # from one state and batch
    batch = next_batch()

    def one_step(c):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        p, _, m = S.make_train_step(c, lr=TRAIN_LR)[0](params, opt_state,
                                                       batch)
        torch.cuda.synchronize()
        return p, float(m["loss"]), torch.cuda.max_memory_allocated() / 1e9

    p8, l8, peak_on = one_step(cfg)
    # kept on the host: the 2-microbatch step below peaks at ~62 GB
    p8 = tree_map(lambda x: x.cpu(), p8)
    p_off, l_off, peak_off = one_step(dataclasses.replace(cfg, remat=False))
    worst, far = update_gap(torch, p8, p_off, TRAIN_LR)
    del p_off
    print(f"15a remat on vs off: loss {l8:.6f} vs {l_off:.6f}, params max "
          f"|diff| {worst:.3e} lr, {far:.3e} of the elements more than "
          f"lr/2 apart (limits: loss rel {REMAT_LOSS_REL:g}, "
          f"{REMAT_FAR:g}); peak memory {peak_on:.2f} vs "
          f"{peak_off:.2f} GB")
    check(abs(l8 - l_off) <= REMAT_LOSS_REL * abs(l_off)
          and far <= REMAT_FAR and worst <= 2,
          "15a: remat changed the step")
    check(peak_on < peak_off, "15a: remat did not lower the peak")
    p2, l2, peak2 = one_step(dataclasses.replace(cfg, microbatches=2))
    worst, far = update_gap(torch, p8, p2, TRAIN_LR)
    del p2, p8
    g2, _ = S.accumulate_grads(dataclasses.replace(cfg, microbatches=2),
                               params, batch)
    g8, _ = S.accumulate_grads(cfg, params, batch)
    ggap = grad_gap(torch, tree_map(lambda x: x.div_(2), g2),
                    tree_map(lambda x: x.div_(8), g8))
    del g8, g2
    print(f"15a microbatches 2 vs 8: loss {l2:.6f} vs {l8:.6f}, mean "
          f"gradient ||diff||/||g|| {ggap:.3e}, params max |diff| "
          f"{worst:.3e} lr, {far:.3e} of the elements more than lr/2 "
          f"apart (limits: loss rel {MB_LOSS_REL:g}, gradient "
          f"{MB_GRAD_REL:g}, {MB_FAR:g}); peak memory {peak2:.2f} GB")
    check(abs(l2 - l8) <= MB_LOSS_REL * abs(l8) and ggap <= MB_GRAD_REL
          and far <= MB_FAR and worst <= 2,
          "15a: the microbatch split changed the step")
    out["a"].update(remat_peak_gb=peak_on, no_remat_peak_gb=peak_off,
                    mb_grad_rel=ggap)
    del params, opt_state
    torch.cuda.empty_cache()

    # ---- b. the two-tier step: TRAIN_PODS replicas of the model
    torch.cuda.reset_peak_memory_stats()
    params = T.init(g, cfg, device="cuda")
    pods = tree_map(lambda x: x[None].repeat(TRAIN_PODS, *([1] * x.dim())),
                    params)
    del params
    hfl = S.make_hfl_train_step(cfg, lr=HFL_LR)
    pit = token_batch_iterator(cfg.vocab_size, TRAIN_PODS * TRAIN_BATCH,
                               TRAIN_SEQ, seed=LM_SEED + 1)
    shape = (TRAIN_PODS, TRAIN_BATCH, TRAIN_SEQ)
    batch = next_batch(pit, shape)
    pods, secs1 = timed(torch, lambda: hfl(pods, batch, False))
    check(any(not torch.equal(x[0], x[1]) for x in tree_leaves(pods)),
          "15b: the pods did not diverge without the cloud sync")
    batch = next_batch(pit, shape)
    unsynced = hfl(pods, batch, False)
    synced, secs2 = timed(torch, lambda: hfl(
        pods, batch, torch.ones((), dtype=torch.bool, device="cuda")))
    spread = max(float((x[0] - x[1]).abs().max())
                 for x in tree_leaves(unsynced))
    gap = max(float((s[0] - u.mean(dim=0)).abs().max())
              for s, u in zip(tree_leaves(synced), tree_leaves(unsynced)))
    print(f"15b {TRAIN_PODS} pods x {TRAIN_BATCH} x {TRAIN_SEQ}, SGD lr "
          f"{HFL_LR:g}: step {secs1:.3f} s unsynced, {secs2:.3f} s synced; "
          f"pods {spread:.3e} apart before the sync; synced vs the mean of "
          f"the unsynced step {gap:.3e} (limit {HFL_REL:g} of that); peak "
          f"memory {peak_gb(torch)}")
    check(all(torch.equal(x[0], x[1]) for x in tree_leaves(synced)),
          "15b: the pods differ after the cloud sync")
    check(spread > 0 and gap <= HFL_REL * spread,
          "15b: the synced pods are not the mean of the unsynced ones")
    out["b"] = {"unsynced_s": secs1, "synced_s": secs2, "spread": spread,
                "gap": gap}
    del pods, unsynced, synced, batch
    torch.cuda.empty_cache()

    # ---- c. one smoke-config train step per family, card vs CPU, f32
    def card_vs_cpu(arch, label):
        c = dataclasses.replace(get_smoke_config(arch), microbatches=2)
        rng = np.random.default_rng(LM_SEED)
        books = (c.n_codebooks,) if c.n_codebooks > 1 else ()
        raw = {k: rng.integers(0, c.vocab_size, (4, 16, *books))
               for k in ("tokens", "labels")}
        if c.n_prefix_embeds:
            raw["prefix_embeds"] = rng.standard_normal(
                (4, c.n_prefix_embeds, c.d_model)).astype(np.float32)
        cpu_p = T.init(torch.Generator().manual_seed(LM_SEED), c,
                       device="cpu")
        res = {}
        for dev in ("cpu", "cuda"):
            st, o = S.make_train_step(c, lr=SMOKE_LR)
            p = tree_map(lambda x: x.to(dev), cpu_p)
            b = {k: torch.from_numpy(v).to(dev) for k, v in raw.items()}
            p, state, m = st(p, o.init(p), b)
            res[dev] = (tree_map(lambda x: x.cpu(), p),
                        tree_map(lambda x: x.cpu() if torch.is_tensor(x)
                                 else x, state), float(m["loss"]))
        (pc, sc, lc), (pg, sg, lg) = res["cpu"], res["cuda"]
        loss_rel = abs(lg - lc) / abs(lc)
        check(loss_rel <= 1e-5, f"15c {label}: loss {lg} vs {lc}")
        if "m" in sc:
            worst, far = update_gap(torch, pg, pc, SMOKE_LR)
            dm = max(float((x - y).abs().max()) for x, y in
                     zip(tree_leaves(sg["m"]), tree_leaves(sc["m"])))
            dv = max(float((x - y).abs().max()) for x, y in
                     zip(tree_leaves(sg["v"]), tree_leaves(sc["v"])))
            print(f"15c {label}: loss rel {loss_rel:.2e}, m {dm:.2e}, v "
                  f"{dv:.2e}, params max {worst:.3e} lr, {far:.2e} more "
                  f"than lr/2 apart")
            check(dm <= 2e-6 and dv <= 1e-7 and worst <= 2 and far <= 1e-3,
                  f"15c {label}: the card's adam step differs")
        else:
            dp = max(float((x - y).abs().max()) for x, y in
                     zip(tree_leaves(pg), tree_leaves(pc)))
            # a factored moment is a mean of g^2, so an element whose
            # gradients nearly cancel has no relative precision: each
            # leaf is held relative to its largest element
            dm = max(float((x - y).abs().max() / y.abs().max())
                     for x, y in zip(tree_leaves(sg["mom"]),
                                     tree_leaves(sc["mom"])))
            print(f"15c {label}: loss rel {loss_rel:.2e}, params "
                  f"{dp:.2e}, moments {dm:.2e} of each leaf's largest")
            check(dp <= 1e-5 and dm <= 1e-4,
                  f"15c {label}: the card's adafactor step differs")

    for family, arch in TRAIN_FAMILIES:
        card_vs_cpu(arch, f"{family} ({arch} smoke)")
    big = S.BIG_MODEL_PARAMS
    S.BIG_MODEL_PARAMS = 0
    try:
        card_vs_cpu(LM_ARCH, "adafactor (BIG_MODEL_PARAMS patched to 0)")
    finally:
        S.BIG_MODEL_PARAMS = big

    # ---- d. the CLI on the card: checkpoints, then a resumed run
    with tempfile.TemporaryDirectory() as d:
        argv = ["--arch", LM_ARCH, "--smoke", "--device", "cuda",
                "--batch", "8", "--seq", "64", "--log-every", "1",
                "--ckpt-every", "2", "--ckpt-dir", d]
        first = train_cli.main(argv + ["--steps", "4"])
        check(sorted(os.listdir(d)) == ["step_00000002", "step_00000004"]
              and len(first["log"]) == 4, "15d: steps or checkpoints")
        second = train_cli.main(argv + ["--steps", "6"])
        check([s for s, _, _ in second["log"]] == [5, 6]
              and latest_step(d) == 6, "15d: the resumed run")
        back = restore_pytree(second["params"], d)
        check(all(np.array_equal(b, p.cpu().numpy()) for b, p in
                  zip(tree_leaves(back), tree_leaves(second["params"]))),
              "15d: the checkpoint differs from the params")
        check(all(math.isfinite(x) for _, x, _ in first["log"]
                  + second["log"]), "15d: losses not finite")

    # ---- e. no kernel ran, and none can run under grad
    out["k5_launches"] = read_counts("15 training (a-d)",
                                     {})["flash_attention"]
    check(raises(NotImplementedError,
                 lambda: S.make_train_step(cfg, impl="kernel")),
          "15e: make_train_step(impl='kernel') did not raise")
    q, k, v = (torch.randn(1, 128, h, 64, device="cuda",
                           dtype=torch.bfloat16) for h in (4, 2, 2))
    check(raises(RuntimeError, lambda: fa.flash_attention(
        q.requires_grad_(), k, v)),
        "15e: flash_attention ran under grad")
    read_counts("15e the K5 guard", {})
    out["phase_s"] = time.perf_counter() - t0
    print(f"15 training phase: {out['phase_s']:.1f} s; " + json.dumps(out))
    return out


# ------------------------------------------------------------ phase 16

def _world(sp):
    """The Table-I world of phases 3-7 (population and partition of seed
    0, fmnist_syn 20 000/2 000, 400-700 samples a device)."""
    from repro_torch.core.cost_model import sample_population
    from repro_torch.data import make_dataset, partition_noniid
    pop = sample_population(sp, seed=0)
    X, y, Xt, yt = make_dataset("fmnist_syn")
    return pop, partition_noniid(X, y, Xt, yt, n_devices=sp.n_devices,
                                 size_range=(400, 700), seed=0)


def _ikc(sw, sp, fed, seeds, labels=None, H=50, K=10):
    return [sw.build_scheduler("ikc", fed, sp, H, K=K, seed=s,
                               use_kernel=True,
                               labels=None if labels is None else labels[s])
            for s in seeds]


def _children(job, world, out, timeout):
    """``world`` processes of this script running ``job`` (one a rank),
    joined through a file store under ``out``; all of them are stopped
    before this returns. Returns their exit codes and output tails."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), f"--{job}", str(r),
         str(world), str(out)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0].decode()[-3000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [p.returncode for p in procs], logs


def lanes_child(rank: int, world: int, out: str) -> None:
    """Phase 16b's rank: MESH_LANES lanes of the Table-I world padded to
    ``world`` ranks over a gloo (host) group, every rank on cuda:0 (the
    lanes need no device collective), 2 geo host rounds with the IKC
    labels of phase 7a; rank 0 writes the records, walls and every
    rank's peak memory."""
    import torch
    import torch.distributed as dist

    from repro_torch.core import sweep as sw
    from repro_torch.core.cost_model import SystemParams
    from repro_torch.kernels.hier_agg import ops as ha
    from repro_torch.launch.mesh import sweep_mesh

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method="file://" + os.path.join(
        out, "group"), rank=rank, world_size=world)
    try:
        sp = SystemParams()
        pop, fed = _world(sp)
        labels = np.load(os.path.join(out, "labels.npy"))
        seeds = list(range(MESH_LANES))
        runner = sw.SweepRunner(sp, [(pop, fed)] * MESH_LANES, lr=0.01,
                                alloc_steps=200, agg_kernel=True, shard=True,
                                mesh=sweep_mesh(device_type="cpu"),
                                device="cuda")
        scheds = _ikc(sw, sp, fed, seeds, labels)
        torch.cuda.reset_peak_memory_stats()
        ha.masked_aggregate_leaves_batched_cuda.launches = 0
        res, wall = timed(torch, lambda: runner.run(scheds, 2, seeds=seeds))
        peaks = [None] * world
        dist.all_gather_object(peaks, torch.cuda.max_memory_allocated())
        if rank == 0:
            np.savez(os.path.join(out, "lanes.npz"), wall=wall,
                     peaks=np.array(peaks), S_pad=runner.S_pad,
                     lanes=np.array(runner.lanes),
                     k1=ha.masked_aggregate_leaves_batched_cuda.launches,
                     **{k: np.asarray(res[k]) for k in
                        ("acc", "T_i", "E_i", "iters", "H")})
    finally:
        dist.destroy_process_group()


def steps_child(rank: int, world: int, out: str) -> None:
    """Phase 16e's rank (run only with two or more cards): chatglm3-6b's
    smoke config through ``make_train_step`` and the kernel prefill on a
    (1, world) data x model NCCL mesh, each rank on its own card; rank 0
    writes the sharded and the one-rank results."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.launch import steps as S
    from repro_torch.models import transformer as T
    from repro_torch.parallel import sharding as shd
    from repro_torch.utils import tree_leaves

    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", init_method="file://" + os.path.join(
        out, "group"), rank=rank, world_size=world)
    try:
        mesh = init_device_mesh("cuda", (1, world),
                                mesh_dim_names=("data", "model"))
        cfg = dataclasses.replace(get_smoke_config(LM_ARCH), microbatches=2)
        params = T.init(torch.Generator(device="cuda").manual_seed(LM_SEED),
                        cfg, device="cuda")
        g = torch.Generator(device="cuda").manual_seed(1)
        tok = torch.randint(0, cfg.vocab_size, (4, 64), generator=g,
                            device="cuda")
        batch = {"tokens": tok, "labels": tok.roll(-1, 1)}
        step, opt = S.make_train_step(cfg, lr=SMOKE_LR)
        p1, _, m1 = step(params, opt.init(params), batch)
        mstep, mopt = S.make_train_step(cfg, mesh=mesh, lr=SMOKE_LR)
        dp = S.shard_tree(params, shd.param_shardings(params, cfg, mesh))
        p2, _, m2 = mstep(dp, mopt.init(dp), S.shard_tree(
            batch, S.input_shardings(batch, mesh)))
        worst = max(float((a - b.full_tensor()).abs().max())
                    for a, b in zip(tree_leaves(p1), tree_leaves(p2)))
        with torch.no_grad():
            want = S.make_prefill_step(cfg, "kernel")(params,
                                                      {"tokens": tok})
            got = S.make_prefill_step(cfg, "kernel", mesh=mesh)(
                dp, S.shard_tree({"tokens": tok}, S.input_shardings(
                    {"tokens": tok}, mesh))).full_tensor()
        if rank == 0:
            np.savez(os.path.join(out, "steps.npz"),
                     loss=[float(m1["loss"]), float(m2["loss"])],
                     worst_lr=worst / SMOKE_LR,
                     prefill=[float((want - got).abs().max()),
                              float(want.abs().max())])
    finally:
        dist.destroy_process_group()


def mesh_phase(torch, sp, ref7, round7_s, train15, zero_counts,
               read_counts):
    """Phase 16: the multi-device layer on one card (see the module
    docstring)."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.configs.registry import get_config
    from repro_torch.core import sweep as sw
    from repro_torch.data import token_batch_iterator
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.launch import steps as S
    from repro_torch.launch.dryrun import tree_local_bytes
    from repro_torch.launch.mesh import make_debug_mesh, sweep_mesh
    from repro_torch.models import transformer as T
    from repro_torch.parallel import sharding as shd
    from repro_torch.utils import tree_leaves, tree_map

    out = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method="file://" + os.path.join(
        tmp, "group"), rank=0, world_size=1)
    try:
        # ---- a. SweepRunner(shard=True) on a one-rank NCCL lane mesh
        pop, fed = _world(sp)
        S_ = SWEEP_LANES
        seeds = list(range(S_))
        kw = dict(lr=0.01, alloc_steps=200, agg_kernel=True)
        per_round = sp.Q + 1
        mesh = sweep_mesh()
        zero_counts()
        runner = sw.SweepRunner(sp, [(pop, fed)] * S_, shard=True, mesh=mesh,
                                **kw)
        scheds = _ikc(sw, sp, fed, seeds)
        labels = [sc.state.clusters.copy() for sc in scheds]
        res, wall = timed(torch, lambda: runner.run(scheds, 2, seeds=seeds))
        k1 = read_counts("16a (lane mesh, 1 rank: IKC clustering + 2 host "
                         "rounds)", {"masked_aggregate": 2 * per_round,
                                     "pairwise_sq_dists":
                                         S_ * 8 * (10 - 1 + 50 + 1),
                                     **k6_rounds(sp, 2, len(fed.y_test))})
        out["a_k1"] = k1["masked_aggregate"]
        out["a_k2"] = k1["pairwise_sq_dists"]
        check(all(np.array_equal(a, b) for a, b in
                  zip(labels, ref7["labels"])),
              "16a: the IKC labels differ from phase 7a's")

        def held(tag, got, params, want, want_params):
            gaps = {k: float(np.abs(np.asarray(got[k], np.float64)
                                    - np.asarray(want[k], np.float64)).max())
                    for k in ("acc", "T_i", "E_i", "iters")}
            dp = max(float((params[k].cpu() - v).abs().max())
                     for k, v in want_params.items())
            print(f"16a {tag}: shard=True vs phase 7's shard=False, 2 "
                  f"rounds: max |diff| {gaps}, params {dp:.3e} (bitwise "
                  "expected)")
            check(all(v <= 0 for v in gaps.values()) and dp <= PARAM_TOL,
                  f"16a {tag}: sharded sweep differs: {gaps}, {dp}")
            return max(list(gaps.values()) + [dp])

        out["a_host_gap"] = held("host loop", res, runner.params_b,
                                 *ref7["host"])
        per = wall / 2
        print(f"16a host loop: {per:.3f} s a round ({S_} lanes, 1 rank) vs "
              f"phase 7a's {round7_s:.3f} s; H={res['H']}")
        zero_counts()
        rf, wf = timed(torch, lambda: runner.run(
            _ikc(sw, sp, fed, seeds, labels), 2, seeds=seeds, fused=True))
        read_counts("16a fused (2 rounds)",
                    {"masked_aggregate": 2 * per_round,
                     **k6_rounds(sp, 2, len(fed.y_test))})
        out["a_k1"] += 2 * per_round
        out["a_fused_gap"] = held("fused", rf, runner.params_b,
                                  *ref7["fused"])
        print(f"16a fused: {wf / 2:.3f} s a round")
        out.update(a_round_s=per, a_fused_round_s=wf / 2,
                   round7_s=round7_s)
        del runner
        # the two ranks below share the card: hand this process's cached
        # blocks back first
        torch.cuda.empty_cache()

        # ---- b. two ranks on the one card over a gloo host group
        np.save(os.path.join(tmp, "labels.npy"), np.stack(labels))
        codes, logs = _children("lanes-child", 2, tmp, timeout=600)
        for r, (c, log) in enumerate(zip(codes, logs)):
            print(f"16b rank {r}: exit {c}" + ("" if c == 0 else
                                                f"\n{log}"))
        check(codes == [0, 0], f"16b: rank exits {codes}")
        got = np.load(os.path.join(tmp, "lanes.npz"))
        want, _ = ref7["host"]
        n_test = len(fed.y_test)
        gaps = {k: float(np.abs(got[k] - np.asarray(want[k])[:MESH_LANES])
                         .max()) for k in ("acc", "T_i", "E_i")}
        print(f"16b {MESH_LANES} lanes padded to {int(got['S_pad'])} over 2 "
              f"ranks on one card: {float(got['wall']) / 2:.3f} s a round; "
              f"peaks {np.round(got['peaks'] / 1e9, 2).tolist()} GB; K1 "
              f"{int(got['k1'])} launches on rank 0; vs phase 7's lanes "
              f"0-{MESH_LANES - 1}: max |diff| {gaps} (T_i/E_i rtol 1e-4 "
              f"atol 1e-6, acc {SHARD_ACC_SAMPLES} test samples)")
        check(np.array_equal(got["iters"], np.asarray(want["iters"])[
            :MESH_LANES]) and int(got["H"]) == want["H"], "16b: iters/H")
        for k in ("T_i", "E_i"):
            check(np.allclose(got[k], np.asarray(want[k])[:MESH_LANES],
                              rtol=1e-4, atol=1e-6), f"16b: {k} differs")
        check(gaps["acc"] <= SHARD_ACC_SAMPLES / n_test + 1e-9,
              f"16b: accuracy {gaps['acc']}")
        out.update(b_round_s=float(got["wall"]) / 2,
                   b_peaks_gb=(got["peaks"] / 1e9).tolist(), b_gaps=gaps)
        del pop, fed
        torch.cuda.empty_cache()

        # ---- c. the train step on a one-rank debug mesh
        cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=TRAIN_LAYERS)
        it = token_batch_iterator(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ,
                                  seed=LM_SEED)
        batch = {k: torch.from_numpy(v).cuda() for k, v in next(it).items()}

        def fresh():
            g = torch.Generator(device="cuda").manual_seed(LM_SEED)
            return T.init(g, cfg, device="cuda")

        params = fresh()
        step, opt = S.make_train_step(cfg, lr=TRAIN_LR)
        p1, state1, m1 = step(params, opt.init(params), batch)
        p1 = tree_map(lambda x: x.cpu(), p1)
        l1 = float(m1["loss"])
        # its moments too: kept, they would add 10.8 GB to the mesh step's
        # peak below
        del params, state1, m1
        torch.cuda.empty_cache()
        dmesh = make_debug_mesh()
        zero_counts()
        gc.collect()
        torch.cuda.reset_peak_memory_stats()      # as phase 15a's
        resident = torch.cuda.memory_allocated() / 1e9
        params = S.shard_tree(fresh(), shd.param_shardings(
            S.params_struct(cfg), cfg, dmesh))
        dbatch = S.shard_tree(batch, S.input_shardings(batch, dmesh))
        mstep, mopt = S.make_train_step(cfg, mesh=dmesh, lr=TRAIN_LR)
        state = mopt.init(params)
        # what the step's arguments hold on the card (phase 17c's account)
        held = {k: tree_local_bytes(v) for k, v in
                (("params", params), ("opt_state", state),
                 ("batch", dbatch))}
        # each step's result rebinds the params and moments, as in 15a
        (params, state, m2), first = timed(
            torch, lambda: mstep(params, state, dbatch))
        l2 = float(m2["loss"])
        p2_first = tree_map(lambda x: x.to_local().cpu(), params)
        walls = []
        for _ in range(TRAIN_STEPS - 1):
            (params, state, m2), secs = timed(
                torch, lambda: mstep(params, state, dbatch))
            walls.append(secs)
        read_counts("16c (mesh train steps)", {})
        peak = torch.cuda.max_memory_allocated() / 1e9
        p2 = params
        worst, far = update_gap(torch, p1, p2_first, TRAIN_LR)
        del p1, p2_first
        wall = float(np.median(walls))
        tokens = TRAIN_BATCH * TRAIN_SEQ
        a15 = train15["a"]
        print(f"16c {cfg.name} n_layers={TRAIN_LAYERS} on make_debug_mesh() "
              f"(1 rank, DTensor): loss {l2:.6f} vs unsharded {l1:.6f}, "
              f"params max |diff| {worst:.3e} lr, {far:.3e} of the elements "
              f"more than lr/2 apart (limits: loss rel {REMAT_LOSS_REL:g}, "
              f"{REMAT_FAR:g}); step {wall:.4f} s (first {first:.3f} s), "
              f"{tokens / wall:,.0f} tokens/s, peak {peak:.2f} GB "
              f"({resident:.2f} GB resident before) vs phase 15a's "
              f"{a15['step_s']:.4f} s, {a15['tok_s']:,.0f} tokens/s, "
              f"{a15['peak_gb']:.2f} GB ({a15['resident_gb']:.2f} GB)")
        check(abs(l2 - l1) <= REMAT_LOSS_REL * abs(l1) and far <= REMAT_FAR
              and worst <= 2, "16c: the mesh step differs from the "
              "unsharded one")
        check(all(isinstance(x, torch.distributed.tensor.DTensor)
                  for x in tree_leaves(p2)), "16c: params left the mesh")
        out.update(c_step_s=wall, c_tok_s=tokens / wall, c_peak_gb=peak,
                   c_held=held, c_resident_gb=resident,
                   c_loss_gap=abs(l2 - l1),
                   c_worst_lr=worst, c_far=far, c_first_s=first)
        del params, p2, state, m2, dbatch
        torch.cuda.empty_cache()

        # ---- d. the kernel prefill on the one-rank mesh: K5 per rank
        full = get_config(LM_ARCH)
        g = torch.Generator(device="cuda").manual_seed(LM_SEED)
        params = T.init(g, full, device="cuda")
        tokens = torch.randint(0, full.vocab_size, (LM_BATCH, LM_SEQ),
                               generator=g, device="cuda")
        with torch.no_grad():
            plain_step = S.make_prefill_step(full, "kernel")
            plain_step(params, {"tokens": tokens})              # warm-up
            want, want_s = timed(torch, lambda: plain_step(
                params, {"tokens": tokens}))
            dparams = S.shard_tree(params, shd.param_shardings(
                params, full, dmesh))
            dtok = S.shard_tree({"tokens": tokens},
                                S.input_shardings({"tokens": tokens}, dmesh))
            mesh_step = S.make_prefill_step(full, "kernel", mesh=dmesh)
            mesh_step(dparams, dtok)                           # warm-up
            zero_counts()
            got, got_s = timed(torch, lambda: mesh_step(dparams, dtok))
            k5 = read_counts("16d (mesh kernel prefill)",
                             {"flash_attention": full.n_layers})
            by_path = fa.flash_attention_cuda.launches_by_path
            check(by_path["wgmma"] == full.n_layers,
                  f"16d: K5 paths {by_path}")
            diff = float((want - got.full_tensor()).abs().max())
        print(f"16d {full.name} (28 layers, bf16) kernel prefill B="
              f"{LM_BATCH} S={LM_SEQ} on the one-rank mesh: {got_s:.4f} s vs "
              f"{want_s:.4f} s unsharded in this run (0.225 s in PERF.md); "
              f"K5 {by_path}; logits max |diff| {diff:.3e} (bitwise "
              "expected)")
        check(diff == 0.0, f"16d: mesh prefill differs by {diff}")
        out.update(d_prefill_s=got_s, d_plain_prefill_s=want_s,
                   d_k5=k5["flash_attention"], d_diff=diff)
        del params, dparams, want, got
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()

    # ---- e. model sharding over cards
    n = torch.cuda.device_count()
    if n < 2:
        print(f"16e: not run: the 2-rank model steps over NCCL need two "
              f"cards, this machine has {n}")
        out["e"] = "not run: one card"
    else:
        d = tempfile.mkdtemp(prefix="chip_smoke_steps_")
        codes, logs = _children("steps-child", 2, d, timeout=600)
        check(codes == [0, 0], f"16e: rank exits {codes}: {logs}")
        got = np.load(os.path.join(d, "steps.npz"))
        (l1, l2), (diff, scale) = got["loss"], got["prefill"]
        print(f"16e chatglm3 smoke (f32) on a (1, 2) data x model NCCL "
              f"mesh over 2 cards: loss {l2:.6f} vs {l1:.6f} on one, adam "
              f"params max |diff| {float(got['worst_lr']):.3e} lr; kernel "
              f"prefill max |diff| {diff:.3e} of {scale:.3f}")
        check(abs(l2 - l1) <= 1e-5 * abs(l1) and got["worst_lr"] <= 2
              and diff <= LM_F32_TOL * scale, "16e: 2-card steps differ")
        out["e"] = "run"
    return out


# ------------------------------------------------------------ phase 17

def example(name: str):
    """``examples/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def dryrun_child(out: str) -> None:
    """Phase 17c's dry run: phase 16c's train step (chatglm3-6b at full
    width, TRAIN_LAYERS layers, TRAIN_BATCH x TRAIN_SEQ, adam) on a
    one-rank ``make_debug_mesh`` over a one-rank fake group."""
    import torch

    from repro_torch.configs.base import InputShape
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_debug_mesh

    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=TRAIN_LAYERS)
    with D.fake_group(1):
        rec = D.dryrun_step(
            cfg, InputShape("train_16c", TRAIN_SEQ, TRAIN_BATCH, "train"),
            make_debug_mesh(device_type="cpu"))
    rec["cuda_initialized"] = torch.cuda.is_initialized()
    with open(os.path.join(out, "dryrun_16c.json"), "w") as f:
        json.dump(rec, f)


def start_dryruns(out: str) -> dict:
    """Phase 17b/c's dry runs, each in its own process (a fake group must
    not meet phase 16's NCCL group), on the host while 17a runs."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    cmds = {tag: [sys.executable, "-m", "repro_torch.launch.dryrun",
                  *flags, "--out", os.path.join(out, f"{tag}.json")]
            for tag, flags in DRYRUNS}
    cmds["16c"] = [sys.executable, str(Path(__file__).resolve()),
                   "--dryrun-child", out]
    return {tag: (subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                   stderr=subprocess.STDOUT),
                  time.perf_counter()) for tag, cmd in cmds.items()}


def wait_dryrun(procs: dict, tag: str, timeout: float = 900):
    """(exit code, seconds from start, output tail) of one dry run."""
    p, t0 = procs[tag]
    log = p.communicate(timeout=timeout)[0].decode()
    return p.returncode, time.perf_counter() - t0, log[-3000:]


def dry_summary(rec: dict) -> str:
    m, c = rec["memory"], rec["collectives"]
    cols = ", ".join(f"{k} {v['count']} x / {v['bytes']:,} B {v['by_axis']}"
                     for k, v in c.items() if v["count"])
    return (f"per rank: arguments {m['argument_bytes']:,} B "
            f"{m['argument_parts']}, outputs {m['output_bytes']:,} B, temp "
            f"{m['temp_bytes']:,} B, flops {rec['cost']['flops']:.4e}; "
            f"collectives: {cols}; traced in {rec['trace_s']} s")


class HeldToPlain:
    """Phase 17a's witness of the kernels' outputs. While it is on, every
    launch of the aggregation kernels (``hier_agg.ops._launch``: K1, K3,
    K4) and every K2 call of the clustering (``clustering._kernel``) is
    held against its plain version on the same inputs at phase 2's
    tolerances, and the aggregation launches are tallied by entry, so
    K4's by the q dtype it read. The plain versions launch nothing."""

    def __init__(self, torch):
        from repro_torch.core import clustering
        from repro_torch.kernels.hier_agg import ops as ha
        from repro_torch.kernels.kmeans_dist import ops as kd
        self.torch, self.ha, self.kd, self.cl = torch, ha, kd, clustering
        self.entries, self.err, self.k2_calls = {}, {}, 0

    def __enter__(self):
        self._launch, self._k2 = self.ha._launch, self.cl._kernel
        self.ha._launch, self.cl._kernel = self.launch, self.k2
        return self

    def __exit__(self, *exc):
        self.ha._launch, self.cl._kernel = self._launch, self._k2

    def reset(self):
        self.entries, self.k2_calls = {}, 0

    def _hold(self, name, got, ref, tol):
        d = (got - ref).abs()
        err = float(d.max()) if d.numel() else 0.0
        self.err[name] = max(self.err.get(name, 0.0), err)
        check(bool((d <= tol).all()), f"17a {name}: a launch differs from "
              f"its plain version (max_abs_err {err:.3e})")

    def launch(self, name, head, leaves, scales, dtype, counter):
        n0 = counter.launches
        outs = self._launch(name, head, leaves, scales, dtype, counter)
        self.entries[name] = self.entries.get(name, 0) + counter.launches - n0
        ha = self.ha
        for i, (x, got) in enumerate(zip(leaves, outs)):
            if "weights" in head:
                ref = ha.weighted_aggregate_batched_ref(head["weights"], x)
            elif scales is None:
                ref = ha.masked_aggregate_batched_ref(head["mask"],
                                                      head["sizes"], x)
            else:
                ref = ha.masked_decode_aggregate_batched_ref(
                    head["mask"], head["sizes"], scales[i], x)
            self._hold(name, got, ref, AGG_TOL * (1 + ref.abs()))
        return outs

    def k2(self, x, c):
        got = self._k2(x, c)
        if got.is_cuda:
            self.k2_calls += 1
            ref = self.kd.pairwise_sq_dists_ref(x.float(), c.float())
            self._hold("pairwise_sq_dists_f32", got, ref,
                       DIST_TOL * (ref.abs().max() + ref.abs()))
        return got

    def read(self, label, got, want):
        """Check that every launch of ``got`` (the counters' reading) was
        held, and the tally by entry against ``want``."""
        print(f"{label} held to plain: launches by entry {self.entries}, "
              f"K2 calls {self.k2_calls}; max_abs_err so far "
              f"{ {k: f'{v:.3e}' for k, v in self.err.items()} }")
        check(sum(self.entries.values()) == got["masked_aggregate"]
              + got["masked_decode_aggregate"] + got["weighted_aggregate"]
              and self.k2_calls == got["pairwise_sq_dists"],
              f"{label}: a launch went unheld")
        check({k: v for k, v in self.entries.items() if v} == want,
              f"{label}: launches by entry {self.entries}, expected {want}")


# the aggregation kernel's entry that each uplink codec's wire dtype takes
CODEC_ENTRY = {"none": "masked_aggregate_f32",
               "bf16_delta": "masked_decode_aggregate_bf16",
               "int8": "masked_decode_aggregate_i8",
               "topk": "masked_decode_aggregate_f32"}
# a kernel entry's key in the result line, where the two differ
ENTRY_KEY = {"masked_aggregate_f32": "masked_aggregate",
             "weighted_aggregate_f32": "weighted_aggregate",
             "pairwise_sq_dists_f32": "pairwise_sq_dists"}


def example_phase(torch, mesh16, zero_counts, read_counts):
    """Phase 17: the examples on the card, the dry run at full width and
    its memory account against phase 16c (see the module docstring)."""
    import shutil
    import tempfile

    from repro_torch.core.cost_model import SystemParams
    from repro_torch.kernels.hier_agg.ops import LEAF_CAPACITY

    tmp = tempfile.mkdtemp(prefix="chip_smoke_17_")
    procs = start_dryruns(tmp)
    out = {"laps": {}, "k4": {}}
    per_round = SystemParams().Q + 1
    witness = HeldToPlain(torch)

    def clustering(K):            # K2: 8 restarts x (K-1 + 50 + 1) passes
        return 8 * ((K - 1) + 50 + 1)

    def cnn_rounds(s, rounds):     # K6 of an example's CNN rounds
        return k6_launches(rounds * s["Q"] * s["L"], rounds, s["n_test"])

    def start():
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        witness.reset()
        return time.perf_counter()

    def lap(tag, t0):
        out["laps"][tag] = time.perf_counter() - t0
        print(f"17a {tag}: {out['laps'][tag]:.1f} s, peak memory "
              f"{peak_gb(torch)}")

    try:
        # ---- a. the examples on the card
        with witness:
            t0 = start()
            qs = example("quickstart_torch").main([])
            label = f"17a quickstart_torch ({qs['iters']} rounds)"
            got = read_counts(label, {
                "masked_aggregate": (qs["Q"] + 1) * qs["iters"],
                "pairwise_sq_dists": clustering(qs["K"]),
                **cnn_rounds(qs, qs["iters"])})
            witness.read(label, got, {"masked_aggregate_f32":
                                      got["masked_aggregate"]})
            check(np.isfinite(qs["objective"])
                  and 0 <= qs["final_acc"] <= 1,
                  "17a quickstart: a summary out of range")
            out["k1"] = got["masked_aggregate"]
            out["k2"] = got["pairwise_sq_dists"]
            lap("quickstart_torch", t0)

            t0 = start()
            ad = example("assignment_demo_torch").main(["--H", "20"])
            got = read_counts("17a assignment_demo_torch", {})
            witness.read("17a assignment_demo_torch", got, {})
            objs = {k: v["obj"] for k, v in ad.items()}
            lat = {k: round(v["latency_s"], 3) for k, v in ad.items()}
            print(f"17a assignment_demo_torch H=20: J {objs}; search "
                  f"latency {lat} s")
            check(all(objs[k] <= objs["geo"]
                      for k in ("hfel-100", "hfel-300")),
                  f"17a: HFEL's J above geo's: {objs}")
            out["assignment_J"] = objs
            lap("assignment_demo_torch", t0)

            t0 = start()
            e2e = example("train_hfl_e2e_torch").main(E2E_ARGS)
            iters = {k: v["iters"] for k, v in e2e["results"].items()}
            label = (f"17a train_hfl_e2e_torch {' '.join(E2E_ARGS)} "
                     f"(rounds {iters})")
            got = read_counts(label, {
                "masked_aggregate": (e2e["Q"] + 1) * sum(iters.values()),
                "pairwise_sq_dists": clustering(10),
                **cnn_rounds(e2e, sum(iters.values()))})
            witness.read(label, got, {"masked_aggregate_f32":
                                      got["masked_aggregate"]})
            out["k1"] += got["masked_aggregate"]
            out["k2"] += got["pairwise_sq_dists"]
            out["e2e"] = {k: {"iters": v["iters"],
                              "final_acc": v["final_acc"],
                              "objective": v["objective"]}
                          for k, v in e2e["results"].items()}
            lap("train_hfl_e2e_torch", t0)

            t0 = start()
            recs = example("model_zoo_launcher_torch").main(
                ["--smoke", "--out", os.path.join(tmp, "zoo.jsonl")])
            want = {"masked_aggregate": 0, "masked_decode_aggregate": 0,
                    "pairwise_sq_dists": 0, **k6_launches(0)}
            by_entry = {}
            sp0 = SystemParams()          # the launcher's L and Q
            for r in recs:
                if r["arch"] == "hfl-cnn":
                    for k, v in cnn_rounds({"Q": sp0.Q, "L": sp0.L, **r},
                                           r["rounds"]).items():
                        want[k] += v
                n = (r["rounds"] * per_round
                     * -(-r["n_leaves"] // LEAF_CAPACITY))
                want["masked_aggregate" if r["codec"] == "none"
                     else "masked_decode_aggregate"] += n
                entry = CODEC_ENTRY[r["codec"]]
                by_entry[entry] = by_entry.get(entry, 0) + n
                if r["scheduler"] in ("ikc", "vkc"):
                    want["pairwise_sq_dists"] += clustering(10)
            label = (f"17a model_zoo_launcher_torch --smoke ({len(recs)} "
                     f"jobs)")
            got = read_counts(label, want)
            witness.read(label, got, by_entry)
            out["k1"] += got["masked_aggregate"]
            out["k2"] += got["pairwise_sq_dists"]
            out["k4"] = {k: v for k, v in witness.entries.items()
                         if k.startswith("masked_decode")}
            for r in recs:
                print(f"  {r['run_name']}: {r['n_leaves']} leaves, acc "
                      f"{r['final_acc']:.3f}, T {r['T_total']:.1f} s, E "
                      f"{r['E_total']:.1f} J, uplink "
                      f"{r['uplink_bits_per_msg']:.0f} b, "
                      f"{r['wall_s']:.2f} s")
            lap("model_zoo_launcher_torch", t0)

        out["held_err"] = dict(witness.err)

        # the serve CLI runs in a process of its own: its launches are
        # not counted here
        t0 = start()
        ran = example("serve_demo_torch").main(["--smoke"])
        check(len(ran) == 1, "17a serve demo")
        lap("serve_demo_torch", t0)

        # ---- b. the dry run at full width
        for tag, _ in DRYRUNS:
            code, secs, log = wait_dryrun(procs, tag)
            check(code == 0, f"17b {tag}: exit {code}\n{log}")
            with open(os.path.join(tmp, f"{tag}.json")) as f:
                (rec,) = json.load(f)
            check("error" not in rec and all(
                k in rec for k in ("memory", "cost", "collectives")),
                f"17b {tag}: {rec.get('error')}")
            print(f"17b dry run {rec['arch']} x {rec['shape']} on "
                  f"{rec['mesh']} ({secs:.1f} s with the process): "
                  + dry_summary(rec))
            check(rec["collectives"]["all-gather"]["count"] > 0,
                  f"17b {tag}: no all-gather")
            out[f"dry_{tag}"] = {"memory": rec["memory"],
                                 "flops": rec["cost"]["flops"],
                                 "collectives": rec["collectives"],
                                 "trace_s": rec["trace_s"], "wall_s": secs}
        check(out["dry_hfl"]["collectives"]["all-reduce"]["by_axis"]
              .get("pod", 0) > 0, "17b: the HFL step has no pod all-reduce")

        # ---- c. the memory account against the card (phase 16c)
        code, secs, log = wait_dryrun(procs, "16c")
        check(code == 0, f"17c: exit {code}\n{log}")
        with open(os.path.join(tmp, "dryrun_16c.json")) as f:
            rec = json.load(f)
        check(not rec["cuda_initialized"], "17c: the dry run used the card")
        held = mesh16["c_held"]
        mem = rec["memory"]
        pred = (mem["argument_bytes"] + mem["temp_bytes"]) / 1e9
        peak, resident = mesh16["c_peak_gb"], mesh16["c_resident_gb"]
        print(f"17c dry run of 16c's step ({secs:.1f} s with the process): "
              + dry_summary(rec))
        print(f"17c argument bytes: dry run {mem['argument_parts']} = "
              f"{mem['argument_bytes']:,} vs held on the card in 16c "
              f"{held} = {sum(held.values()):,}; predicted peak "
              f"(arguments + temp) {pred:.3f} GB vs 16c's measured peak "
              f"{peak:.3f} GB ({resident:.3f} GB resident before): ratio "
              f"{pred / peak:.4f} (to the peak less the resident: "
              f"{pred / (peak - resident):.4f}); no bound set")
        check(mem["argument_parts"] == held,
              f"17c: argument bytes {mem['argument_parts']} vs {held}")
        out["c"] = {"argument_bytes": mem["argument_bytes"],
                    "temp_bytes": mem["temp_bytes"], "predicted_gb": pred,
                    "peak_gb": peak, "resident_gb": resident,
                    "ratio": pred / peak}
    finally:
        for p, _ in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a card",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    from repro_torch.core import compression as comp
    from repro_torch.core.cost_model import SystemParams, sample_population
    from repro_torch.core.framework import FrameworkConfig, HFLFramework
    from repro_torch.data import make_dataset, partition_noniid
    from repro_torch.kernels import build
    from repro_torch.kernels.conv_pool import ops as cp
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.hier_agg import ops as ha
    from repro_torch.kernels.kmeans_dist import ops as kd

    counters = {"masked_aggregate": ha.masked_aggregate_leaves_batched_cuda,
                "pairwise_sq_dists": kd.pairwise_sq_dists_cuda,
                "masked_decode_aggregate":
                    ha.masked_decode_aggregate_leaves_batched_cuda,
                "weighted_aggregate":
                    ha.weighted_aggregate_leaves_batched_cuda,
                "flash_attention": fa.flash_attention_cuda,
                "conv_relu_pool": cp.conv_relu_pool_cuda,
                "conv_pool_dw": cp.conv_pool_dw_cuda,
                "conv_pool_dx": cp.conv_pool_dx_cuda}

    def zero_counts():
        for fn in counters.values():
            fn.launches = 0
        fa.flash_attention_cuda.launches_by_path = dict.fromkeys(fa.PATHS, 0)

    def read_counts(label, expect):
        got = {k: fn.launches for k, fn in counters.items()}
        expect = {k: expect.get(k, 0) for k in counters}
        print(f"{label} launches: {got} (expected {expect})")
        check(got == expect, f"{label}: launch counts differ from the path's")
        return got

    # ------------------------------------------------------------ setup
    t_start = t0 = time.perf_counter()
    logs = build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s for "
          f"{sorted(logs) or 'nothing (cached)'} "
          f"({' '.join(a for a in build.NVCC_FLAGS if 'sm_' in a)})")
    for name, log in sorted(logs.items()):
        for line in log.splitlines():
            if ("registers" in line or "spill" in line
                    or "Compiling entry" in line or "serialized" in line):
                print(f"  ptxas {name}: {line.strip()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi)
    name = torch.cuda.get_device_name(0)
    rate = memory_rate(name)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; bound "
          f"rates: {rate / 1e12:.2f} TB/s, {F32_FLOPS / 1e12:.0f} TFLOP/s "
          f"f32")

    # ---------------------------------------------------------- kernels
    kres = kernel_phase(torch, rate)
    conv_rows = conv_pool_phase(torch, rate)

    # ------------------------------------------- main path: uncompressed
    sp = SystemParams()
    pop = sample_population(sp, seed=0)
    X, y, Xt, yt = make_dataset("fmnist_syn")
    fed = partition_noniid(X, y, Xt, yt, n_devices=sp.n_devices,
                           size_range=(400, 700), seed=0)
    cfg = FrameworkConfig(H=50, K=10, scheduler="ikc", assigner="geo",
                          agg_kernel=True, use_kernel=True, alloc_steps=200)
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    fw = HFLFramework(sp, pop, fed, cfg)
    setup_s = time.perf_counter() - t0
    check(fw.model_bits == 457532 * 8, f"model bytes {fw.model_bits / 8}")
    print(f"setup: {setup_s:.3f} s (clustering "
          f"{fw.setup_seconds['cluster']:.3f} s), ari="
          f"{fw.clustering_stats['ari']:.3f}, clustering delay="
          f"{fw.clustering_stats['delay_s']:.3f} s energy="
          f"{fw.clustering_stats['energy_j']:.3f} J")
    assigned = record_assignments(fw)
    recs = run_rounds(torch, fw, (1, 2), "uncompressed")
    # K1: per round Q edge aggregations + 1 cloud one, each one launch
    # over every leaf; K2: per restart (8) K-1 kmeans++ passes, 50 Lloyd
    # steps and the labels
    n_leaves = len(fw.model_params)
    per_round = sp.Q + 1
    # K6: per round Q*L local steps (2 forward, 2 dW and 1 dx launches
    # each) and the evaluation's batches (2 forward launches each)
    n_test = len(fed.y_test)
    launches = read_counts("uncompressed path", {
        "masked_aggregate": 2 * per_round,
        "pairwise_sq_dists": 8 * ((cfg.K - 1) + 50 + 1),
        **k6_rounds(sp, 2, n_test)})
    labels = fw.scheduler.state.clusters

    # ---------------------------------------------- main path: int8 codec
    def codec_cfg(codec):
        return dataclasses.replace(
            cfg, compression=comp.CompressionConfig(codec=codec))

    zero_counts()
    fw8 = HFLFramework(sp, pop, fed, codec_cfg("int8"), labels=labels)
    assigned8 = record_assignments(fw8)
    recs8 = run_rounds(torch, fw8, (1, 2), "int8")
    launches["masked_decode_aggregate_i8"] = read_counts(
        "int8 path", {"masked_decode_aggregate": 2 * per_round,
                      **k6_rounds(sp, 2, n_test)}
    )["masked_decode_aggregate"]
    for i, (r, r8) in enumerate(zip(recs, recs8)):
        check(all(np.array_equal(a, b)
                  for a, b in zip(assigned[i], assigned8[i])),
              f"int8 round {i + 1}: another cohort than the uncompressed")
        ratio = r["msg_bits"] / r8["msg_bits"]
        print(f"round {i + 1} uncompressed vs int8: msg_bits ratio "
              f"{ratio:.4f}, T_i {r['T_i']:.4f} -> {r8['T_i']:.4f}, E_i "
              f"{r['E_i']:.4f} -> {r8['E_i']:.4f}")
        check(ratio > 3.9, f"int8 msg_bits ratio {ratio} <= 3.9")
        check(r8["T_i"] < r["T_i"] and r8["E_i"] < r["E_i"],
              "the int8 round is not cheaper than the uncompressed one")
    check(any(bool(v.abs().max() > 0) for v in fw8.codec_state[0].values()),
          "int8: the device residuals stayed zero")

    # ------------------------------------ main path: bf16_delta and topk
    for codec, short in (("bf16_delta", "bf16"), ("topk", "f32")):
        zero_counts()
        fwc = HFLFramework(sp, pop, fed, codec_cfg(codec), labels=labels)
        run_rounds(torch, fwc, (1,), codec)
        launches[f"masked_decode_aggregate_{short}"] = read_counts(
            f"{codec} path", {"masked_decode_aggregate": per_round,
                              **k6_rounds(sp, 1, n_test)}
        )["masked_decode_aggregate"]
        del fwc

    # ------------------------------- main path: K3 aggregate_pytrees
    sched, assign = assigned[1]                   # round 2's cohort
    s_t = torch.from_numpy(sched.astype(np.int64)).cuda()
    onehot = torch.nn.functional.one_hot(
        torch.from_numpy(assign.astype(np.int64)).cuda(), sp.n_edges).float()
    tot = onehot.T @ pop.D[s_t]
    w_edge = (onehot.T * pop.D[s_t][None, :]) / tot.clamp_min(1.0)[:, None]
    copies = {k: v[None].expand((len(sched),) + v.shape)
              for k, v in fw.model_params.items()}
    zero_counts()
    edge_models = ha.aggregate_pytrees(w_edge, copies)
    torch.cuda.synchronize()
    launches["weighted_aggregate"] = read_counts(
        "aggregate_pytrees path", {"weighted_aggregate": 1}
    )["weighted_aggregate"]
    err3 = 0.0
    for k, v in copies.items():
        ref = ha.weighted_aggregate_batched_ref(
            w_edge[None], v.reshape(1, len(sched), -1))[0]
        got = edge_models[k].reshape(sp.n_edges, -1)
        err3 = max(err3, float((got - ref).abs().max()))
        check(bool(((got - ref).abs() <= AGG_TOL * (1 + ref.abs())).all()),
              f"aggregate_pytrees {k}: kernel differs from plain")
        full = tot > 0        # identical copies: each edge gets the params
        check(bool(((got[full] - fw.model_params[k].reshape(1, -1)).abs()
                    <= AGG_TOL * (1 + ref[full].abs())).all()),
              f"aggregate_pytrees {k}: an edge model is not the params")
        check(bool((got[~full] == 0).all()), "empty edge row not zero")
    print(f"aggregate_pytrees: {n_leaves} leaves, H={len(sched)}, "
          f"M={sp.n_edges}, max_abs_err vs plain {err3:.3e}")
    kres["weighted_aggregate"]["err"] = max(
        kres["weighted_aggregate"]["err"], err3)
    del copies, edge_models

    # ---------------------------------------------------- oracle rounds
    plain = fork(fw, agg_kernel=False)
    seq = fork(fw, engine="sequential")
    rk, rp, rs = fw.run_round(3), plain.run_round(3), seq.run_round(3)
    dmax = max(float((fw.model_params[k] - plain.model_params[k]).abs().max())
               for k in fw.model_params)
    print(f"round 3 kernel vs plain matmul: T_i {rk['T_i']} vs {rp['T_i']}, "
          f"E_i {rk['E_i']} vs {rp['E_i']}, acc {rk['acc']} vs {rp['acc']}, "
          f"max |dparam| {dmax:.3e} (tolerance {PARAM_TOL})")
    check(rk["T_i"] == rp["T_i"] and rk["E_i"] == rp["E_i"],
          "T_i/E_i differ between the aggregation backends")
    check(dmax <= PARAM_TOL, f"params differ by {dmax}")
    dseq = max(float((seq.model_params[k] - plain.model_params[k])
                     .abs().max()) for k in fw.model_params)
    rel = [abs(rs[k] - rp[k]) / abs(rp[k]) for k in ("T_i", "E_i")]
    print(f"round 3 sequential vs fused (plain matmul): T_i {rs['T_i']} vs "
          f"{rp['T_i']}, E_i {rs['E_i']} vs {rp['E_i']} (relative "
          f"{rel[0]:.2e}, {rel[1]:.2e}), max |dparam| {dseq:.3e} "
          f"(tolerance {PARAM_TOL}), seconds {rs['seconds']}")
    check(max(rel) <= 1e-5, "sequential T_i/E_i differ beyond rtol 1e-5")
    check(dseq <= PARAM_TOL, f"sequential params differ by {dseq}")
    del plain, seq

    plain8 = fork(fw8, agg_kernel=False)
    sent = {}
    real_encode = comp.encode_leaf

    def spy(cfg_, delta, resid, u=None):
        out = real_encode(cfg_, delta, resid, u)
        sent.setdefault(tag, []).append(out[:2])
        return out
    comp.encode_leaf = spy
    try:
        tag = "kernel"
        rk8 = fw8.run_round(3)
        tag = "plain"
        rp8 = plain8.run_round(3)
    finally:
        comp.encode_leaf = real_encode
    quantum = max(float(sc.max()) for _, sc in sent["kernel"] + sent["plain"])
    flips = sum(int((a[0] != b[0]).sum())
                for a, b in zip(sent["kernel"], sent["plain"]))
    n_q = sum(a[0].numel() for a in sent["kernel"])
    print(f"int8 round 3 kernel vs plain decode+matmul: T_i {rk8['T_i']} vs "
          f"{rp8['T_i']}, E_i {rk8['E_i']} vs {rp8['E_i']}, differing q "
          f"{flips} of {n_q} ({flips / n_q:.2e}); cap 2 x largest int8 "
          f"scale = {2 * quantum:.3e}")
    check(len(sent["kernel"]) == len(sent["plain"]) == per_round * n_leaves,
          "int8 oracle: another number of messages")
    check(rk8["T_i"] == rp8["T_i"] and rk8["E_i"] == rp8["E_i"],
          "int8: T_i/E_i differ between the aggregation backends")
    shares = {}
    for what, got, want in (
            ("params", fw8.model_params, plain8.model_params),
            ("device residuals", fw8.codec_state[0], plain8.codec_state[0]),
            ("edge residuals", fw8.codec_state[1], plain8.codec_state[1])):
        shares[what] = differing(got, want, FLIP_ATOL)
        print(f"  int8 {what}: {shares[what][0]:.3e} of the elements "
              f"differ by more than {FLIP_ATOL:g} (limit {FLIP_SHARE:g}), "
              f"max |diff| {shares[what][1]:.3e}")
    for what, (frac, dmax) in shares.items():
        check(frac <= FLIP_SHARE, f"int8 {what}: {frac:.3e} of the "
              f"elements differ")
        check(dmax <= 2 * quantum, f"int8 {what} differ by {dmax}")
    del plain8, sent

    # ------------------------------------------ assignment (phase 5)
    torch.cuda.empty_cache()
    assignment_phase(torch, sp, pop, fed, cfg, fw, labels, recs[0],
                     assigned[0], zero_counts, read_counts)

    # ------------------------------------------------ where time goes
    # setup again: the first construction also paid PyTorch's one-off
    # lazy imports (torch.func pulls in torch._dynamo and sympy)
    t0 = time.perf_counter()
    again = HFLFramework(sp, pop, fed, cfg)
    print(f"setup again: {time.perf_counter() - t0:.3f} s (clustering "
          f"{again.setup_seconds['cluster']:.3f} s)")
    del again
    profiled(torch, "round 4", lambda: fw.run_round(4), warm_up=False)

    # ------------------------------------- release the HFL frameworks
    del fw, fw8
    torch.cuda.empty_cache()

    # ------------------------------------------------ sweep (phase 7)
    t0 = time.perf_counter()
    sweep = sweep_phase(torch, sp, pop, fed, zero_counts, read_counts)
    ref7 = sweep.pop("p16")
    sweep["phase_s"] = time.perf_counter() - t0
    print(f"sweep phase: {sweep['phase_s']:.1f} s")
    del X, y, Xt, yt, fed, pop, labels
    torch.cuda.empty_cache()
    lm = lm_phases(torch, rate, zero_counts, read_counts)
    kres["flash_attention"] = lm.pop("kernel")
    launches["flash_attention"] = lm["launches"]

    # ------------------------------------------------ async (phase 12)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    pop = sample_population(sp, seed=0)
    X, y, Xt, yt = make_dataset("fmnist_syn")
    fed = partition_noniid(X, y, Xt, yt, n_devices=sp.n_devices,
                           size_range=(400, 700), seed=0)
    async_out = async_phase(torch, sp, pop, fed, zero_counts, read_counts)
    async_out["phase_s"] = time.perf_counter() - t0
    print(f"async phase: {async_out['phase_s']:.1f} s; "
          + json.dumps(async_out))
    del fed, X, y, Xt, yt
    torch.cuda.empty_cache()

    # ------------------------------- model-zoo payloads (phase 13)
    t0 = time.perf_counter()
    seq = seq_payload_phase(torch, sp, pop, zero_counts, read_counts)
    print(f"seq payload phase: {time.perf_counter() - t0:.1f} s")
    del pop
    torch.cuda.empty_cache()

    # --------------------------- LM families at full width (phase 14)
    t0 = time.perf_counter()
    zoo = zoo_lm_phase(torch, zero_counts, read_counts)
    print(f"zoo LM phase: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()

    # ------------------------------------------- LM training (phase 15)
    train = train_phase(torch, zero_counts, read_counts)
    torch.cuda.empty_cache()

    # ---------------------------------- the multi-device layer (phase 16)
    t0 = time.perf_counter()
    mesh = mesh_phase(torch, sp, ref7, sweep["round_s"], train, zero_counts,
                      read_counts)
    mesh["phase_s"] = time.perf_counter() - t0
    print(f"mesh phase: {mesh['phase_s']:.1f} s; " + json.dumps(mesh))
    launches["flash_attention"] += mesh["d_k5"]

    # --------------------- examples and the dry run (phase 17)
    t0 = time.perf_counter()
    ex = example_phase(torch, mesh, zero_counts, read_counts)
    ex["phase_s"] = time.perf_counter() - t0
    for entry, err in ex["held_err"].items():     # 17a's launches
        key = ENTRY_KEY.get(entry, entry)
        kres[key]["err"] = max(kres[key]["err"], err)
    print(f"example phase: {ex['phase_s']:.1f} s; " + json.dumps(ex))

    # ----------------------------------------------------------- result
    src = "src/repro_torch/csrc/hier_agg.cu"
    hier = "src/repro/kernels/hier_agg/hier_agg.py"
    edge_work = "one edge iteration: one launch over 4 leaves, H=50, " \
                "M=5, P=375+10500+101248+2260"
    routes = {
        "masked_aggregate": ("masked_aggregate", src, f"{hier}:111",
                             edge_work),
        "pairwise_sq_dists": ("pairwise_sq_dists",
                              "src/repro_torch/csrc/kmeans_dist.cu",
                              "src/repro/kernels/kmeans_dist/"
                              "kmeans_dist.py:50",
                              "one launch, N=100, P=1640, K=10"),
        "weighted_aggregate": ("weighted_aggregate", src, f"{hier}:62",
                               edge_work),
    }
    for dtype_name, short in WIRE:
        routes[f"masked_decode_aggregate_{short}"] = (
            f"masked_decode_aggregate[{dtype_name}]", src, f"{hier}:180",
            f"{edge_work}, q {dtype_name}")
    routes["flash_attention"] = (
        "flash_attention", "src/repro_torch/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/flash_attention.py:86",
        "one launch, B=2, S=4096, Hq=32, Hkv=2, d=128, causal, bf16")
    def sweep_hop(key):
        lanes = kres[f"{key}_lanes"]
        return {"work": f"one sweep edge hop: one launch over {SWEEP_LANES} "
                        "lanes x 4 leaves, H=50, M=5",
                **{k: lanes[k] for k in ("ms", "eager_ms", "cold_ms",
                                         "plain_ms", "library_ms",
                                         "bound_ms", "bound_by")}}
    extra = {"masked_aggregate": {
                 "sweep_launches": sweep.pop("launches"),
                 "sweep_hop": sweep_hop("masked_aggregate")},
             "masked_decode_aggregate_i8": {
                 "sweep_launches": sweep.pop("int8_launches"),
                 "sweep_hop": sweep_hop("masked_decode_aggregate_i8")}}
    extra["masked_aggregate"]["sweep"] = sweep
    extra["masked_aggregate"]["seq_payload_launches"] = seq["k1"]
    extra["masked_aggregate"]["mesh_launches"] = mesh["a_k1"]
    extra["masked_aggregate"]["example_launches"] = ex["k1"]
    extra["pairwise_sq_dists"] = {"seq_payload_launches": seq["k2"],
                                  "mesh_launches": mesh["a_k2"],
                                  "example_launches": ex["k2"]}
    extra["masked_decode_aggregate_i8"]["example_launches"] = \
        ex["k4"].get("masked_decode_aggregate_i8", 0)
    extra["masked_decode_aggregate_f32"] = {
        "example_launches": ex["k4"].get("masked_decode_aggregate_f32", 0)}
    extra["flash_attention"] = {
        "mesh_launches": mesh["d_k5"],
        "zoo_launches": zoo["flash_attention"],
        "train_launches": train["k5_launches"],
        "f32_prefill": {"work": "one launch, B=2, S=4096, Hq=32, Hkv=2, "
                                "d=128, causal, f32 (tf32x3)",
                        **kres["flash_attention"].pop("f32_prefill")},
        "shifted_prefill": {"work": "a copy of v and one launch, B=2, "
                                    "S=4096, Hq=32, Hkv=2, d=128, causal, "
                                    "bf16, v's base one element off "
                                    "(wgmma_staged)",
                            **kres["flash_attention"].pop("shifted_prefill")},
        "staged_prefill": {"work": "copies of q, k, v and one launch, "
                                   "B=2, S=4096, Hq=32, Hkv=2, d=128, "
                                   "causal, bf16, q, k, v the first 128 "
                                   "columns of (B, S, H, 132) buffers "
                                   "(wgmma_staged)",
                           **kres["flash_attention"].pop("staged_prefill")}}
    kernels = []
    for key, (kname, source, replaces, work) in routes.items():
        r = kres[key]
        kernels.append({
            "name": kname, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[key],
            "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "eager_ms": r["eager_ms"],
            "work": work, **({"cold_l2_ms": r["cold_ms"]}
                             if "cold_ms" in r else {}),
            **extra.get(key, {})})
    kernels.append({
        "name": "conv_relu_pool", "route": "cuda",
        "source": "src/repro_torch/csrc/conv_pool.cu", "replaces": None,
        "launches": {k: launches[k] for k in k6_launches(0)},
        "work": "the CNN's conv blocks (FashionMNIST's two at H=50 and "
                "200 devices, CIFAR's conv 1 at 50) x 700 samples, forward "
                "and backward", "rows": conv_rows})
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--dryrun-child":
        dryrun_child(sys.argv[2])
        sys.exit(0)
    if len(sys.argv) == 5 and sys.argv[1] in ("--lanes-child",
                                              "--steps-child"):
        {"--lanes-child": lanes_child, "--steps-child": steps_child}[
            sys.argv[1]](int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
        sys.exit(0)
    sys.exit(main())
