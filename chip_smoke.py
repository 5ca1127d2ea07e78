#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Each phase prints its own lines:

  [0] device   the card's name and power limit, torch and CUDA versions
  [1] build    nvcc builds the six CUDA kernels from the repository's
               sources, one nvcc per source, all at once
  [2] kernels  each kernel against its plain PyTorch version on the card
               (B4 also at hd 112 and hd 192, with its registers),
               then its time beside the plain version's, a PyTorch
               yardstick's and the least time the card could take (the
               sampler at the generator's 16 rows and the engine's 32,
               with its instructions a logit from cuobjdump and the
               time they take at the card's issue rate); B1 and B2
               also at a misaligned [16, 15, 50310] view that splits its
               rows, B1 against the split plain version at its plan at
               every shape, each with its split plan and its body loop's
               instructions a logit beside the bytes bound's budget; the
               attention gradient against chunked_attention's; paged
               attention also on an arena whose unread slots are NaN,
               for all four (q, arena) dtype pairs and at the edges of
               its context splits
  [3] serve    GeneratorExecutor -> RefPolicyExecutor -> RewardExecutor
               through their ports, two steps of full-depth bf16
               llama31-8b from a seeded random init; the kernels' launch
               counts over those two steps are asserted
  [9] int8     (run right after [3], on its params) kernel B6 through
               dispatch.int8_matmul: against its plain version at the
               JAX suite's shapes, at M = 1 and ragged N, and at layer
               0's wq, wk, w_gate and w_down quantized by
               ddma.quantize_int8, at decode (16) and prefill (8192) M,
               and at its tile edges (M 1 to 129, ragged K and N);
               against the generator's own numerics, x times the
               dequantized bf16 weight; then its time at w_gate beside
               its time before the redesign
  [4] long     four 2048-id prompts: prefill and one 16-step decode chunk
  [5] fp32     llama31-8b widths with 2 layers in fp32: the behaviour and
               reference log-probs agree within 1e-3
  [6] train    llama31-8b widths with 8 layers, bf16 params and fp32
               Adam: three steps of the async schedule (staleness 1) of
               generator -> reference -> reward -> trainer -> weight sync
               through SyncExecutorController, with the staleness,
               snapshot and launch counts asserted, then one profiled
               train step
  [7] numerics llama31-8b widths with 2 layers in fp32: one train step
               through the kernels against the same step through the
               plain versions under autograd, within 1e-4 relative
  [8] engine   (run right after [4], on its params) the continuous-
               batching engine through GeneratorExecutor.engine_configure
               (kv_layout="paged") / engine_enqueue / engine_round: three
               batches of 48-token prompts, straggler budgets, rows
               admitted mid-decode from the radix cache; the launch
               counts of its rounds, radix hits, staleness and page
               leaks asserted; the emitted batches scored by
               RefPolicyExecutor and RewardExecutor; decode time and
               device-busy share beside the dense layout's decode time;
               then the same engine at 2 layers in fp32, its behaviour
               log-probs within 1e-3 of the reference's
  [10] pool    llama31-8b widths with 2 layers, bf16 params, fp32 Adam,
               KL 0.1: the threaded AsyncExecutorController.  (a) a pool
               of 1, chunk scheduling, 3 steps, bit-equal to
               run_sequential of a controller built the same way (tokens,
               metrics, versions); (b) an engine-mode pool of 2 on paged
               KV (build_generator_pool, PoolConfig(engine=True,
               kv_layout="paged")), 4 steps: batch order, versions,
               alternating workers, pins, pages and launch counts
               asserted; its stats (overlap_s, busy shares), peak memory
               and the most weight versions alive at once printed; its
               trace exported to build/pool_trace.json, validated and
               summarized; the first call of each shape it gave a kernel
               held against the plain version
  [11] quickstart  quickstart.build("cuda", 20) on the threaded
               controller: weight versions and launch counts asserted;
               every kernel call of the run held against its plain
               version on the same inputs; each step's loss, mean
               log-prob and gradient norm held against the CPU port
               re-scoring the card's own batch from the card's params,
               within 1e-4 relative (+1e-6)
  [12] processes  the async loop with its actors in spawned children (own
               interpreter, CUDA context and default stream), the reward
               in this process; every child's launch counts, peak memory
               and modules read through a ``probe`` endpoint.  (a)
               ``proc`` on llama31-8b's smoke config, a pool of 1 (chunk
               scheduling, the child pinning each job's params), each
               child on a (1, 1) mesh of its own (DeviceSpec.mesh_shape:
               an NCCL world of one, the trainer stepping sharded on
               it, each probe reporting its mesh): bit-equal to the
               same loop threaded in process, its launch counts summed
               over the children equal to that run's; (b) an engine
               pool of 2 on paged KV on the smoke config, 3 steps,
               threaded in process and then over
               ``shm``, both traced: decode ms a token per worker, the stats, each
               weight hop's ms and GB/s, spawn seconds, peak memory per
               process (CUDA and resident set), staged slots, the most
               /dev/shm bytes the run held, each process's device
               timeline (torch.profiler) and how much of the trainer's
               device time fell into the generators' gaps, and none of
               the run's /dev/shm segments left after
               ``close_all_actors()``; (c) the quickstart with
               ``REPRO_TRANSPORT=socket`` (self-hosted), bit-equal to [11]
  [13] launcher  (i) ``python -m repro_torch.launch.train --arch
               llama31-8b --smoke --steps 3 --transport shm
               --n-generators 2 --kl-coef 0.1 --child-mesh 1x1`` with
               the paged engine, traced, as a process of its own, each
               child on a mesh of its own: exit 0, 3 history rows,
               spans from every child; (ii) meanwhile the launcher's
               build_controller with the same flags in this process,
               its children probed: B1-B5 launched in the children, the
               first call of each shape each child gave a kernel held
               against its plain version there
  [14] supervise  llama31-8b's smoke config, bf16 params, fp32 Adam,
               KL 0.1, under a ``Supervisor``.  (a) an engine pool of 2
               on paged KV in ``shm`` children, staleness 2, 4 steps,
               ``kill:generator1@batch=3`` while generator1's engine
               holds batch 1 (it stalls at version 0): steps in order,
               generator1 respawned, batch 1 re-admitted and emitted by
               the second life, staleness, engine stats and radix hits,
               the respawned child's first call of each shape held
               against the plain version, the corpse's segments gone,
               the card's memory before the kill, once the corpse exited
               and after the recovery, spawn, replay and recovery
               seconds; (b) the generator and the trainer threaded here,
               the frozen reference in a ``proc`` child killed at the
               consumer's batch 2: bit-equal to the same controller's run
               without the fault (its reference in this process), the
               respawned reference replaying its
               version-0 seed and running B1, the first kernel call of
               each shape here and in the reference's second life held
               against the plain version; (c) ``python -m
               repro_torch.launch.train ... --supervise --chaos`` twice as
               processes of their own (a mid-decode kill respawned; with
               ``--max-restarts 0`` generator1 lost and its batches on
               generator0); (d) ``repro_torch.train_arithmetic_rl --steps
               50 --eval-every 25``, its last checkpoint restored bit-equal
               to the trainer's params, the first kernel call of each
               shape held against the plain version
  [15] windowed  the windowed dense family.  (a) starcoder2-3b at full
               width and depth, bf16, prompts of 4160 ids past its
               4096-token window: a batch rollout scored by the
               reference (windowed prefill and scoring through
               chunked_attention, as the reference routes them; the
               rings wrap), prefill and decode times, the plain
               attention's share of the prefill, the device-busy share
               and peak memory; then the paged engine, rows joining
               mid-decode, paged_attention with window 4096 every step;
               (b) two steps of the async loop at full width and depth,
               sequences inside the window (merged segments: flash and
               the log-prob backward); (c) 2 layers in fp32: decode
               through the wrapped ring against the windowed forward
               (2e-3) and the paged engine's behaviour log-probs against
               the reference's (1e-3); (d) command-r-35b, deepseek-67b and
               nemotron-4-340b at their published widths cut to 2
               layers: a batch rollout scored by the reference and a
               paged engine round each (fused_sample at V 256000,
               paged_attention at hd 192, flash_attention at hd 192 in
               nemotron's scoring).  Every kernel call of (b)-(d), and
               the first of each shape of (a), is held against its plain
               version ([2] times B3 at [16, 49152] and at V 256000, and
               B4 and B5 at hd 192)
  [16] moe     the MoE family, llama4-scout-17b-a16e at its published
               widths (d 5120, 40/8 heads, 16 experts of d 8192, top-1
               sigmoid, a shared expert, V 202048).  (a) 4 layers, one
               iRoPE period (layers 0-2 windowed at 8192, layer 3
               global), bf16: a batch rollout of 4 x 4 prompts of 256
               ids, 32 new tokens, scored by the reference; prefill and
               decode times, the device-busy share and the MoE FFN's
               share of a profiled decode chunk, the prefill choices
               capacity drops, peak memory; then the paged engine, rows
               joining mid-decode; (b) two steps of the async loop at 1
               layer (4.27 B params), the MoE aux in the loss, KL 0.1
               against a reference fed the trainer's weights, so the
               router and the experts move; (c) the smoke config in
               fp32: decode through wrapped rings against the windowed
               forward (2e-3), the paged engine's behaviour log-probs
               against the reference's (1e-3), and moe_forward on the
               card against the CPU (routing and drops equal, y within
               1e-5).  The first kernel call of each shape of (a) and
               every call of (b) and (c) are held against the plain
               versions ([2] times B3 and B1 at V 202048)
  [17] mla     the MLA + MTP family, deepseek-v3-671b at its published
               widths (d 7168, 128 heads, q rank 1536, kv rank 512, qk
               128+64, v 128, 3 dense layers of d_ff 18432, then 256
               experts of d 2048, top-8 sigmoid, a shared expert, an MTP
               head, V 129280).  (a) 4 layers, the 3 dense and the first
               MoE, bf16: a batch rollout of 4 x 4 prompts of 256 ids, 32
               new tokens, scored by the reference; prefill (expanded
               MLA through chunked_attention, as the reference routes
               asymmetric heads) with the plain attention's and the MoE
               FFN's shares, decode (absorbed MLA over the latent cache)
               with the device-busy and MoE FFN shares, the capacity
               drops, the latent cache's bytes against an expanded K/V
               cache's, peak memory; (b) two steps of the async loop at
               2 layers and 16 experts, MTP loss and MoE aux in the loss,
               KL 0.1 against a reference fed the trainer's weights:
               every MLA matrix, mtp.proj and the MTP block move; (c) the
               smoke config in fp32: prefill + decode against the
               forward, the absorbed decode against the expanded
               forward, mtp_logits on the card against the CPU (1e-3
               each), and a batch rollout's mu against the reference's
               log-probs (1e-3).  B1, B2 and B3 must launch and B4 and
               B5 must not; the first kernel call of each shape of (a)
               and every call of (b) and (c) are held against the plain
               versions ([2] times B1, B2 and B3 at V 129280)
  [18] vlm     the VLM family, qwen2-vl-7b at its published widths (28
               layers, d 3584, 28/4 heads of 128 with qkv bias and
               M-RoPE, d_ff 18944, V 152064, 256 patch embeddings ahead
               of the tokens, drawn at scale 0.02 from a seed).  (a) full
               depth, bf16: a batch rollout of 4 x 4 prompts of 256 ids,
               32 new tokens, through start_rollout(extra=) and
               rollout_chunk (the executors carry no patch embeddings, in
               either package), scored by forward_train with the same
               patches; prefill and decode times, the device-busy share,
               |mu - ref|, peak memory; (b) two make_train_step steps at
               8 layers with the patches in the batch, each on a rollout
               of its own params scored by a frozen reference, KL 0.1:
               every matrix and bias moves; (c) the smoke config in fp32:
               logits card against CPU, prefill across the patch prefix +
               decode against the forward, and a batch rollout's mu
               against the reference's log-probs (1e-3 each)
  [19] hybrid  the hybrid family, zamba2-7b at its published widths (81
               Mamba2 layers, d 3584, 112 SSM heads of 64, state 64,
               chunk 128; one shared attention block, 32 heads of 112 and
               d_ff 14336, before every 6 Mamba layers: 14 applications;
               V 32000).  (a) full depth, bf16: a batch rollout of 4 x 4
               prompts of 256 ids (two SSD chunks), 32 new tokens,
               through GeneratorExecutor and RefPolicyExecutor:
               flash_attention at hd 112, 14 launches a forward; prefill
               and decode times with the Mamba2 mixers' share of each
               (a profiler range around mamba2_forward and
               mamba2_decode), the recurrent state's bytes against a KV
               cache of the same depth, peak memory; (b) two steps of the
               async loop at 24 layers (4 applications), KL 0.1, through
               the executors and SyncExecutorController: B4 at hd 112
               forward, its gradient recomputed through
               chunked_attention; (c) the smoke config in fp32: logits
               card against CPU, prefill + decode against the forward,
               the chunked SSD against the stepwise recurrence, and a
               batch rollout's mu against the reference's (1e-3 each).
               In [18] and [19] B1, B3 and B4 (and B2 in (b)) must
               launch and B5 must not; the first kernel call of each
               shape of (a) and every call of (b) and (c) are held
               against the plain versions ([2] times B4 at hd 112)
  [20] ssm     the SSM family, xlstm-350m at its published widths (24
               blocks, sLSTM at 5, 11 and 17 and mLSTM elsewhere; d 1024,
               4 heads, mLSTM inner width 2048; V 50304 tied).  (a) full
               depth, bf16: a batch rollout of 4 x 4 prompts of 256 ids
               (four mLSTM chunks of 64), 64 new tokens, through
               GeneratorExecutor and RefPolicyExecutor (scored at
               [16, 320]); prefill and decode times with the mLSTM's and
               the sLSTM's shares (profiler ranges around their forward
               and decode), the recurrent state's bytes; (b) two steps of
               the async loop at full depth through the executors and
               SyncExecutorController, sequences of 32 (longer, the
               gradient through the reference's chaotic sLSTM init
               swamps the rest, in both packages), KL 0.1: the list
               of layers through Adam, weight sync and the generator,
               every leaf but the norms moves; (c) the smoke config in
               fp32: logits card against CPU, prefill + decode against
               the forward, the chunked mLSTM across two chunks against
               its stepwise decode, a batch rollout's mu against the
               reference's (1e-3 each).  B1, B2 and B3 must launch, B4
               and B5 must not (the family has no attention)
  [21] audio   the audio encoder-decoder family, seamless-m4t-medium at
               its published widths (12 encoder and 12 decoder layers, d
               1024, 16/16 heads of 64, d_ff 4096 SiLU-gated, V 256206
               untied, 1024 frame embeddings a row from the stub front
               end).  (a) full depth, bf16: a batch rollout of 4 x 4
               prompts of 64 ids behind the frames, 64 new tokens,
               through start_rollout(extra=) and rollout_chunk (the
               executors carry no frames, in either package), scored at
               [16, 128] with the frames: B4 at hd 64 in the decoder's
               prefill and scoring, 12 launches a forward; the encoder
               and the cross attention run the plain chunked_attention,
               as the reference routes them; the encoder's share of the
               prefill, the cross attention's share of decode, the
               cross-K/V cache's bytes; (b) two make_train_step steps at
               full depth with the frames in the batch, each on a rollout
               of its own params (64 + 32 ids), KL 0.1: every leaf but
               the norms moves;
               (c) the smoke config in fp32: logits card against CPU,
               prefill + decode against the forward, a batch rollout's mu
               against the reference's (1e-3 each).  B1-B4 must launch,
               B5 must not.  In [20] and [21] the first kernel call of
               each shape of (a) and every call of (b) and (c) are held
               against the plain versions ([2] times B4 at hd 64 and B1-B3
               at V 50304 and 256206)
  [22] sharded the mesh-bound pieces on a (data 1, model 1) cuda mesh of
               an NCCL group of one rank (file:// rendezvous under
               build/).  (a) llama31-8b at full width with 2 layers in
               fp32 from [7]'s seed, two steps on [7]'s batch: the
               one-card make_train_step first (params, m and v kept on
               the card), then make_sharded_train_step on shard_state's
               DTensors, once as it is and once with remat_layers (each
               layer under a checkpoint, its slice of each stacked leaf
               gathered again in the recompute: B4 twice a layer a
               step); params and moments within [7]'s 1e-4, the largest
               difference, bit-equality, the three runs' step times and
               peak memory (the steps', and through the loss and
               backward) printed; (b) llama4-scout at full width
               with 1 layer in bf16: forward_train with moe_mode
               'ep_shmap' on the installed mesh against the gathered mode;
               (c) (a)'s params saved and restored onto the mesh with
               restore_checkpoint(shardings=), bit for bit; (d) the
               dry run (launch/dryrun.py) predicts each of (a)'s
               sharded runs from the meta device -- bytes allocated as
               it starts, its peak, FLOPs a step -- and is held to what
               (a) measured: torch.cuda.max_memory_allocated of the
               sharded steps and a FlopCounterMode count of one more,
               plus the FLOPs of B1, B2 and B4, which it cannot see.
               B1, B2 and B4 must launch on this path ("sharded"), and
               (a)'s first kernel call of each shape is held against the
               plain version
  [23] tp      tensor-parallel serving and training: B3 in its partial
               mode on a rank's [16, V/2] vocabulary shard (col0 V/2) and
               B1 and B2 on a rank's [16, 80, V/2] logits at llama31-8b's,
               llama4-scout's and deepseek-v3's vocabularies, B4 on a
               rank's heads [4, 2048, 16, 4, 128] and [4, 2048, 20, 4,
               128], held against their plain versions and timed here;
               then two spawned processes share
               the card as a (data 1, model 2) mesh of a gloo group over
               CUDA tensors (NCCL refuses two ranks on one device), each
               building llama31-8b at full depth in bf16 from a seed in
               turn and keeping its shard (16 q heads, 4 KV heads, d_ff
               7168, V 64128; rank 0 first runs the one-card path on the
               whole tree): (a) a prefill of 16 prompts of 16, TP logits
               against one card; (b) 16 new tokens, the TP step's log-probs
               of the one-card tokens (teacher-forced) against the
               one-card behaviour log-probs within 0.05 nats on average,
               and the share of equal sampled tokens; (c) B3 on each shard
               with col0 against fused_sample_split_plain, merged over the
               ranks against B3 on the whole row (tokens bit for bit,
               log-probs within 1e-5 relative); (d) 2 layers in fp32 at
               full width, logits within 1e-4 and tokens identical; (e)
               the dry run's prediction of a rank's TP prefill at (d)'s
               config held to the card (bytes, FLOPs, all-reduce bytes).
               Then at (d)'s config, on a [16, 80] batch, each rank in
               turn builds the whole train state and runs the one-card
               reference scoring and two make_train_step steps at lr
               1e-3, KL 0.1, keeping its blocks: (h) a RefPolicyExecutor
               on the mesh (its TP shard) against the one-card one within
               1e-5; (f) two TP sharded train steps, each from the
               one-card state before it (metrics within 1e-5, m 1e-5
               and v 2e-5 of a leaf's largest, updates 99% within 1e-4
               of the largest and all within 2 of it: the comment at
               TP_TRAIN_ROWS says why the card needs more than the sharded
               tests' 1e-5 and 0.2), their step times beside the one
               card's (gloo-bound);
               (i) the dry run's prediction of that step held to one more
               (held bytes within 1 MB, the peak within its band, FLOPs,
               all-reduce and all-gather bytes exactly); (g) B1 on each
               rank's [16, 80, 64128] slice merged over the ranks against
               B1 on the whole rows (1e-6 relative), B2 on the slice
               against the whole row's columns (one bf16 ulp; bit for bit
               with the whole row's stats).  Then the MoE family on the
               same ranks: (j) llama4-scout (4 layers) and (k)
               deepseek-v3 (4 layers: 3 dense and a MoE layer) at their
               published widths and capacity factor in bf16, rank 0
               building the model whole and running the one-card
               prefill, rollout and reference scoring: every shard the
               plan's block with E/2 experts a rank, the TP prefill
               logits against one card, a 32-token TP rollout, the TP
               step's log-probs of the one-card tokens and a reference
               executor on the mesh scoring them (mean |d| within 0.05
               each, or within one card's own spread where that is
               larger: the same checks of the model with its embedding
               moved by a bf16 ulp, TP_WITNESS), the choices the
               capacity drops on each side, deepseek-v3's latent cache
               whole and equal on both ranks, the TP and one-card
               times; (l) each at one layer in fp32 (experts and
               vocabulary cut, ``tp_moe_train_cfg``, no choice dropped):
               (h) also at the published capacity factor, dropping on
               the ranks' own experts what one card drops, (f) and (i)
               as above (m and v within three times one card's own
               spread where that is larger than (f)'s bounds), the MTP
               loss vocabulary-parallel; (m) the dry run's prediction of
               (k)'s decode step held to the card.  Rank 0 builds every
               model
               and runs every one-card twin, and hands rank 1 its blocks
               over CUDA IPC.  B3 and B4 are counted on the "tp" path
               (each rank's prefill and rollout), B1, B2 and B4 in (f)'s
               and (l)'s steps, and the first B4 call of each serving
               shape is held against chunked_attention

A random policy at llama31-8b's vocabulary almost never writes a number,
so every reward is 0, every advantage is 0 and so is the policy-gradient
term.  Phases 6 and 7 therefore add the KL term (kl_coef 0.1) against a
frozen reference drawn from another seed: its advantage, -0.1 (log pi -
log pi_ref), is not zero, and the params move.

The last three lines are the kernels' JSON record, the card's name and
power limit as nvidia-smi gives them, and
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without
``src/repro_torch`` beside this file, the script exits 2 and prints no
result.  Any failed check raises, so the script exits non-zero.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import datetime
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# NVIDIA's data sheet for the H100 SXM at its 700 W limit (dense rates)
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
FP32_FLOPS = 67e12              # fp32 outside the tensor cores

# floating-point operations each kernel needs per logit: online max, the
# shifted exp and its sum; the sampler adds the temperature scale, two
# logs and two negations for the Gumbel noise, the add and the compare
SAMPLE_OPS_PER_LOGIT = 10
LOGPROB_OPS_PER_LOGIT = 4

V_LLAMA = 128256
# llama4-scout-17b-a16e's vocabulary ([16]) and deepseek-v3-671b's ([17])
V_SCOUT = 202048
V_DSV3 = 129280
# flash attention's hd-192 timing shape (nemotron-4-340b's head dim),
# and its hd-112 one (zamba2-7b's shared block: MHA, 32 heads of 112)
HD192 = (4, 2048, 16, 8, 192)
HD112 = (4, 2048, 32, 32, 112)
# and its hd-64 one (seamless-m4t-medium's decoder: MHA, 16 heads of 64)
HD64 = (4, 2048, 16, 16, 64)
# xlstm-350m's vocabulary ([20], GPT-NeoX) and seamless-m4t-medium's ([21])
V_XLSTM = 50304
V_SEAMLESS = 256206
# the serve and train phases' generator: 4 prompts x 4 samples, 64 new
# tokens decoded in chunks of 16
N_PROMPTS, N_PER, MAX_NEW, CHUNK = 4, 4, 64, 16
# the train phase keeps the published widths and cuts the depth: bf16
# params and grads and fp32 Adam moments take 12 bytes a param, 96 GB at
# the full 32 layers, more than one 80 GB card holds
TRAIN_LAYERS = 8
# the KL coefficient of phases 6 and 7 (see the docstring)
KL_COEF = 0.1
# floating-point operations of the log-prob backward per logit: two
# subtractions, the exp, the one-hot compare, the difference and the scale
LOGPROB_BWD_OPS_PER_LOGIT = 6
# the engine phase: prompts of 48 tokens, so 3 of 4 siblings reuse two
# radix-cached pages of 16; straggler budgets (in chunks) cycling over the
# rows; three batches into the default pool of 2 x 16 rows, so rows are
# admitted mid-decode at divergent cursors
ENGINE_PROMPT, ENGINE_PAGE, ENGINE_BATCHES = 48, 16, 3
ENGINE_BUDGETS = [1, 2, 4, 4]
# the pool phase keeps the published widths and cuts the depth to 2
# layers (1.49 B params, 2.97 GB a bf16 weight version, 17.8 GB of
# trainer state): in-process subscribers share each version's tensors,
# and at bound 1 with 2 workers the fabric and channels may hold up to
# 2 bound + workers + 4 = 8 versions, which at 8 layers (5.59 GB each)
# would not fit beside the trainer on an 80 GB card
POOL_LAYERS = 2
# B6 against its plain version: |d| <= INT8_TOL max(1, |plain|).  Both
# widen the same x and int8 values exactly, so every product is equal;
# only the order of the fp32 sum differs (over K up to 14336, about 1e-6
# relative to the outputs' size of 1 at these widths)
INT8_TOL = 1e-4
# B5's and B6's times before their Hopper redesign (one block per row and
# kv head; mma.sync tiles) at the shapes timed below, ms a call (kernel
# only), from PERF.md's kernel table (H100 80GB HBM3, 700 W): printed
# beside the redesigned kernels' times
EARLIER_INT8 = {(16, "bfloat16"): (0.0900, 0.0435),
             (8192, "bfloat16"): (4.0657, 4.0731),
             (16, "float32"): (0.5026, 0.4280)}
EARLIER_PAGED = {("timing", "float32", 0): (0.3452, 0.2977),
              ("engine", "float32", 0): (0.0654, 0.0218)}
# B3's time before its redesign (one block per row), ms a call (kernel
# only) at [16, 128256] bf16, from the same table
EARLIER_SAMPLE = {16: (0.0880, 0.0533)}
# warp instructions an SM issues a clock (four schedulers, one each)
ISSUE_PER_SM_CLOCK = 4
KERNELS = ("fused_sample", "fused_logprob", "fused_logprob_bwd",
           "flash_attention", "paged_attention", "int8_matmul")


def log(msg: str = "") -> None:
    print(msg, flush=True)


def require(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def leaves(tree):
    """The leaves of nested dicts, lists and tuples, in order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from leaves(v)
    else:
        yield tree


def leaves_by_path(tree, path=()) -> dict:
    """{key path: leaf} of nested dicts and lists (a list's index is its
    items' key, as a string)."""
    items = tree.items() if isinstance(tree, dict) \
        else ((str(i), v) for i, v in enumerate(tree))
    out = {}
    for k, v in items:
        if isinstance(v, (dict, list, tuple)):
            out.update(leaves_by_path(v, path + (k,)))
        else:
            out[path + (k,)] = v
    return out


def cloned(tree):
    """A copy of nested dicts, lists and tuples of tensors (other values
    shared)."""
    if isinstance(tree, dict):
        return {k: cloned(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cloned(v) for v in tree)
    return tree.clone() if hasattr(tree, "clone") else tree


# decode steps a profile of an eager many-layer decode covers: the
# profiler's own cost grows with the host operations it records (a
# 16-step chunk of zamba2's 81 layers took over a minute)
PROFILED_STEPS = 2


def profiled_decode(torch, profile, params, cfg, cache, tokens):
    """``profile`` (device_profile, or a range_profile partial) over
    PROFILED_STEPS ``decode_step`` calls on a copy of ``cache`` (the
    rollout's own cache is left as it was).  Returns what ``profile``
    returns."""
    from repro_torch.models import decode_step
    probe = cloned(cache)

    def steps():
        with torch.no_grad():
            for _ in range(PROFILED_STEPS):
                decode_step(params, cfg, probe, tokens)
    return profile(torch, steps)


def param_total(cfg) -> int:
    """A config's params at its published depth."""
    from repro_torch.configs import param_count
    return param_count(cfg)[0]


# ---------------------------------------------------------------- timing ---

def cuda_ms(torch, fn, iters: int) -> float:
    """Median time of one call from CUDA events, after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def kernel_only_ms(torch, fn, n: int, kernel: str):
    """Device time of one call from torch.profiler over ``n`` calls: the
    device time of every kernel the calls launched (a merge or split-K
    pass included), divided by the launches the profiler recorded of
    ``kernel``, the one kernel each call launches exactly once; None when
    the profiler saw no device time.  The profiler may record only some
    of the launches in its window (2 of 3 long launches in one run), so
    the time is divided by the launches it recorded, not by ``n``."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    us = sum(e.self_device_time_total for e in events)
    count = sum(e.count for e in events if kernel in e.key)
    return us / 1e3 / count if us > 0 and count else None


def bound(n_bytes: float, flops: float, peak_flops: float):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate for their type."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, b) -> float:
    """max |a - b| in fp32; equal infinities count as agreeing."""
    import torch
    a, b = a.float(), b.float()
    d = torch.where(a == b, torch.zeros_like(a), (a - b).abs())
    require(not torch.isnan(d).any().item(), "NaN in a comparison")
    return d.max().item()


def bwd_excess(torch, got, want, g, toks, rtol, atol=1e-12) -> float:
    """The largest ratio of |got - want| to its tolerance, rtol |want| +
    atol per element, with rtol |g| more at each row's token column, where
    want = g (1 - p) cancels.  got, want: [N, V]; g, toks: [N].  Equal
    infinities agree; at most 1 where every element holds."""
    a, b = got.float(), want.float()
    d = torch.where(a == b, torch.zeros_like(a), (a - b).abs())
    require(not torch.isnan(d).any().item(), "NaN in a comparison")
    tol = torch.where(torch.isfinite(b), b.abs() * rtol,
                      torch.zeros_like(b)) + atol
    tol.scatter_add_(1, toks.long()[:, None], (g.float().abs() * rtol)[:, None])
    return (d / tol).max().item()


# ---------------------------------------------------------------- phases ---

def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    require(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0].strip()


def max_sm_clock_mhz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60)
    require(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return float(out.stdout.strip().splitlines()[0])


def sass_loop_instructions(name: str, parts, must=None):
    """(instructions, function, matches): the static SASS instructions,
    NOPs left out, of the longest loop (a backward branch back to its
    target) of the first kernel in ``csrc/<name>.cu``'s built library
    whose mangled name holds every string of ``parts``, from ``cuobjdump
    -sass``; with ``must``, a regex, only loops with an instruction it
    matches count, and ``matches`` is their number in that loop (0
    without ``must``).  None where the toolkit has no cuobjdump or the
    listing does not parse."""
    from repro_torch.kernels import build
    tool = Path(build.nvcc()).with_name("cuobjdump")
    if not tool.exists():
        return None
    out = subprocess.run([str(tool), "-sass", str(build._out(name))],
                         capture_output=True, text=True, timeout=120)
    if out.returncode != 0:
        return None
    for text in re.split(r"\n\s*Function : ", out.stdout)[1:]:
        func = text.split("\n", 1)[0].strip()
        if not all(p in func for p in parts):
            continue
        # (address, instruction without its predicate)
        ins = [(int(a, 16), re.sub(r"^@!?\w+\s+", "", op.strip())) for a, op
               in re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", text)]
        longest, matches = 0, 0
        for addr, op in ins:
            m = re.match(r"BRA\b.*?(0x[0-9a-f]+)", op)
            if m and int(m.group(1), 16) < addr:
                lo = int(m.group(1), 16)
                body = [o for a, o in ins if lo <= a <= addr
                        and not o.startswith("NOP")]
                hits = sum(1 for o in body if must and re.match(must, o))
                if (hits or not must) and len(body) > longest:
                    longest, matches = len(body), hits
        return (longest, func, matches) if longest else None
    return None


def ptxas_usage(name: str, parts) -> list:
    """[(function, registers, spill store bytes)] from the ``ptxas -v``
    lines of ``csrc/<name>.cu``'s build, for every kernel whose mangled
    name holds every string of ``parts``."""
    from repro_torch.kernels import build
    out = []
    for sec in build.BUILD_LOG.get(name, "").split(
            "Compiling entry function '")[1:]:
        func = sec.split("'", 1)[0]
        if all(p in func for p in parts):
            regs = re.search(r"Used (\d+) registers", sec)
            spill = re.search(r"(\d+) bytes spill stores", sec)
            out.append((func, int(regs.group(1)) if regs else None,
                        int(spill.group(1)) if spill else 0))
    return out


def phase_build() -> None:
    from repro_torch.kernels import build
    log("[1] build (one nvcc per source, all at once)")
    t0 = time.perf_counter()
    build.build_all(KERNELS)
    for name in KERNELS:
        build.library(name)
        text = build.BUILD_LOG.get(name, "")
        regs = [int(x) for x in re.findall(r"Used (\d+) registers", text)]
        spill = sum(int(x) for x in
                    re.findall(r"(\d+) bytes spill stores", text))
        secs = build.BUILD_SECONDS.get(name)
        log(f"  {name}: " + (f"{secs:.1f} s" if secs is not None
                             else "already built")
            + (f", registers {min(regs)}..{max(regs)}, spill stores "
               f"{spill} bytes" if regs else ""))
    log(f"  build total {time.perf_counter() - t0:.1f} s")


def logprob_split_check(torch, view, toks, lp, m):
    """B1's result (lp, m) on ``view`` against ``fused_logprob_split_plain``
    at the kernel's own plan: m bit for bit, the log-prob within 1e-4.
    Returns ((span, n_splits), max|dlogp|)."""
    from repro_torch.kernels import build, fused_logprob
    V = view.shape[-1]
    plan = fused_logprob.split_plan(toks.numel(), V,
                                    build.sm_count(view.device))
    lp_s, m_s, _ = fused_logprob.fused_logprob_split_plain(view, toks,
                                                           plan[0])
    err = max_err(lp, lp_s)
    require(err <= 1e-4 and torch.equal(m, m_s),
            f"fused_logprob {list(view.shape)} against the split plain "
            f"version at {plan}: error {err:.3e}")
    return plan, err


def edge_tokens(torch, view, span, n_splits):
    """Tokens for ``view``'s rows, one a row, taking in turn column 0, the
    row's last head column and its first body column (its head is the
    columns before its first 16-byte boundary), both sides of each split
    border, the first tail column and column V - 1."""
    from repro_torch.kernels.fused_logprob import row_heads
    V = view.shape[-1]
    vec = 16 // view.element_size()
    out = []
    for r, h in enumerate(row_heads(view).reshape(-1).tolist()):
        cols = [0, max(h - 1, 0), h, h + (V - h) // vec * vec, V - 1]
        cols += [h + i * span + d for i in range(1, n_splits) for d in (-1, 0)]
        out.append(min(V - 1, cols[r % len(cols)]))
    return torch.tensor(out, dtype=torch.int32,
                        device=view.device).reshape(view.shape[:-1])


def check_logprob_misaligned(torch, dev, gen):
    """B1 and B2 at a small misaligned shape that splits its rows: the
    [16, 15, 50310] view of [16, 16, 50310] logits (V % 8 = 6, so the rows
    start at every 2-byte phase), with tokens in the heads, the tails and
    on the split borders, a +1e30, a -1e30 and a tied row, in bf16 and
    fp32.  B1 against the plain version (m bit for bit) and the split
    plain version at its plan, B2 against the plain version, element by
    element, and zero in the last position."""
    from repro_torch.kernels import build, fused_logprob
    V = 50310
    for dtype, tol, rtol in ((torch.bfloat16, 1e-4, 2.0 ** -7),
                             (torch.float32, 1e-5, 1e-6)):
        x = torch.randn(16, 16, V, generator=gen, device=dev) * 2
        x[3, 0, 5], x[3, 1], x[3, 2, 3], x[3, 2, 99] = 1e30, -1e30, 9.0, 9.0
        x = x.to(dtype)
        view = x[:, :-1]
        span, n = fused_logprob.split_plan(240, V, build.sm_count(dev))
        require(n > 1, f"[16, 15, {V}] does not split: {span}, {n}")
        toks = edge_tokens(torch, view, span, n)
        lp, m, s = fused_logprob.fused_logprob_cuda(view, toks)
        lp_p, m_p, _ = fused_logprob.fused_logprob_plain(
            view.reshape(-1, V), toks.reshape(-1))
        err = max_err(lp.reshape(-1), lp_p)
        require(err <= tol and torch.equal(m.reshape(-1), m_p),
                f"fused_logprob [16, 15, {V}] {dtype}: error {err:.3e}")
        _, split_err = logprob_split_check(torch, view, toks, lp, m)
        g = torch.randn(16, 15, generator=gen, device=dev)
        dl = fused_logprob.fused_logprob_bwd_cuda(x, toks, m, torch.log(s), g,
                                                  n_valid=15)
        want = fused_logprob.fused_logprob_bwd_plain(
            view.reshape(-1, V), toks.reshape(-1), m.reshape(-1),
            torch.log(s).reshape(-1), g.reshape(-1))
        require(bool((dl[:, -1] == 0).all().item()),
                f"fused_logprob_bwd [16, 15, {V}]: last position not zero")
        excess = bwd_excess(torch, dl[:, :-1].reshape(-1, V), want,
                            g.reshape(-1), toks.reshape(-1), rtol)
        require(excess <= 1.0, f"fused_logprob_bwd [16, 15, {V}] {dtype}: "
                f"an element is {excess:.3g} times its tolerance")
        bwd_plan = fused_logprob.bwd_plan(V)
        log(f"  fused_logprob [16, 15, {V}] misaligned view "
            f"{str(dtype)[6:]} with +-1e30 and tied rows, tokens in heads, "
            f"tails and on split borders, plan {n} splits of {span}: "
            f"max|dlogp| {err:.3e}, m equal, split plain {split_err:.3e}; "
            f"fused_logprob_bwd, plan {bwd_plan[1]} splits of "
            f"{bwd_plan[0]}: worst element {excess:.3g} of its tolerance "
            f"({rtol:.3g} relative), last position zero")


def logprob_sass(name: str, bytes_per_logit: int, n_sm: int, clock: float):
    """B1's or B2's bf16 body loop from cuobjdump: its instructions a logit
    (the loop's instructions over the logits of its 16-byte loads),
    logged beside the budget the bytes bound leaves at the card's issue
    rate; None where not measured."""
    sass = sass_loop_instructions(name, (f"{name}_kernel", "__nv_bfloat16"),
                                  must=r"LDG\S*\.128")
    budget = (ISSUE_PER_SM_CLOCK * 32 * n_sm * clock * 1e6 * bytes_per_logit
              / HBM_BYTES_PER_S)
    if sass is None:
        log(f"  {name} SASS: not measured (no cuobjdump); budget "
            f"{budget:.1f} instructions a logit")
        return None
    per_logit = sass[0] / (sass[2] * 8)
    log(f"  {name} SASS: {sass[0]} instructions in the body loop of "
        f"{sass[1]} ({sass[2]} 16-byte loads, {sass[2] * 8} logits), "
        f"{per_logit:.1f} a logit against a budget of {budget:.1f} ("
        f"{bytes_per_logit} bytes a logit at {HBM_BYTES_PER_S / 1e12:.2f} "
        f"TB/s, {ISSUE_PER_SM_CLOCK} warp instructions a clock on each of "
        f"{n_sm} SMs at {clock:.0f} MHz)")
    return per_logit


def timed_logprob_at(torch, dev, gen, V, T=288):
    """B1 at the reference-scoring shape of [16] (V 202048), [17] (V
    129280), [20] (V 50304, T 320) or [21] (V 256206, T 128): the
    [16, T - 1, V] view of [16, T] bf16 logits, held against the plain
    version and timed."""
    import torch.nn.functional as F

    from repro_torch.kernels.fused_logprob import fused_logprob_cuda, \
        fused_logprob_plain
    logits = (torch.randn(16, T, V, generator=gen, device=dev)
              * 2).to(torch.bfloat16)
    view = logits[:, :-1]
    toks = torch.randint(0, V, (16, T - 1), generator=gen, device=dev,
                         dtype=torch.int32)
    lp, m, _ = fused_logprob_cuda(view, toks)
    lp_p, m_p, _ = fused_logprob_plain(view.reshape(-1, V),
                                       toks.reshape(-1))
    err = max_err(lp.reshape(-1), lp_p)
    require(err <= 1e-4 and torch.equal(m.reshape(-1), m_p),
            f"fused_logprob [16, {T - 1}, {V}] error {err:.3e}")
    t0 = time.perf_counter()
    plan, split_err = logprob_split_check(torch, view, toks, lp, m)
    split_s = time.perf_counter() - t0
    del lp_p, m_p

    def run():
        return fused_logprob_cuda(view, toks)
    flat = view.reshape(-1, V).contiguous()
    flat_toks = toks.reshape(-1).long()
    n_rows = toks.numel()
    b_ms, b_by = bound(view.numel() * 2 + n_rows * 4 + 3 * n_rows * 4,
                       view.numel() * LOGPROB_OPS_PER_LOGIT, FP32_FLOPS)
    rec = {"shape": [16, T - 1, V], "max_abs_err": err, "splits": plan[1],
           "split_plain_err": split_err, "split_check_s": split_s,
           "ms": cuda_ms(torch, run, 10),
           "kernel_only_ms": kernel_only_ms(torch, run, 5,
                                            "fused_logprob_kernel"),
           "plain_ms": cuda_ms(torch, lambda: fused_logprob_plain(
               view.reshape(-1, V), toks.reshape(-1)), 2),
           "library_ms": cuda_ms(torch, lambda: F.cross_entropy(
               flat, flat_toks, reduction="none"), 10),
           "bound_ms": b_ms, "bound_by": b_by}
    ko = rec["kernel_only_ms"]
    log(f"  fused_logprob [16, {T - 1}, {V}] strided view bf16, plan "
        f"{plan[1]} splits of {plan[0]}: max|dlogp| {err:.3e}, m equal, "
        f"split plain {split_err:.3e}; {rec['ms']:.4f} ms per call ("
        + ("not measured" if ko is None else f"{ko:.4f} ms")
        + f" in the kernel), plain {rec['plain_ms']:.4f} ms, library "
        f"(F.cross_entropy) {rec['library_ms']:.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by})")
    del logits, view, flat
    return rec


def timed_logprob_bwd_at(torch, dev, gen, V, T=80):
    """B2 at a trainer's shape ([17] (b): V 129280, T 80; [20] (b) and
    [21] (b): V 50304 and 256206, T 128): the gradient of [16, T, V]
    bf16 logits from their [16, T - 1, V] view (n_valid T - 1), held
    against the plain version and timed."""
    import torch.nn.functional as F

    from repro_torch.kernels import build, fused_logprob
    from repro_torch.kernels.fused_logprob import fused_logprob_bwd_cuda, \
        fused_logprob_bwd_plain, fused_logprob_cuda
    logits = (torch.randn(16, T, V, generator=gen, device=dev)
              * 2).to(torch.bfloat16)
    view = logits[:, :-1]
    n = T - 1
    toks = torch.randint(0, V, (16, n), generator=gen, device=dev,
                         dtype=torch.int32)
    g_out = torch.randn(16, n, generator=gen, device=dev)
    _, m, s = fused_logprob_cuda(view, toks)
    log_s = torch.log(s)

    def run():
        return fused_logprob_bwd_cuda(logits, toks, m, log_s, g_out,
                                      n_valid=n)

    def plain():
        return fused_logprob_bwd_plain(
            view.reshape(-1, V), toks.reshape(-1), m.reshape(-1),
            log_s.reshape(-1), g_out.reshape(-1))
    got, want = run()[:, :-1].reshape(-1, V), plain()
    err = max_err(got, want)
    excess = bwd_excess(torch, got, want, g_out.reshape(-1),
                        toks.reshape(-1), 2.0 ** -7)
    require(excess <= 1.0, f"fused_logprob_bwd [16, {n}, {V}]: an element "
            f"is {excess:.3g} times its tolerance")
    require(bool((run()[:, -1] == 0).all().item()),
            f"fused_logprob_bwd [16, {n}, {V}]: last position not zero")
    plan = fused_logprob.bwd_plan(V)
    del got, want
    flat = view.reshape(-1, V).contiguous().requires_grad_()
    ce = F.cross_entropy(flat, toks.reshape(-1).long(), reduction="none")
    n_rows = toks.numel()
    b_ms, b_by = bound(view.numel() * 2 + logits.numel() * 2 + 4 * n_rows * 4,
                       view.numel() * LOGPROB_BWD_OPS_PER_LOGIT, FP32_FLOPS)
    rec = {"shape": [16, n, V], "max_abs_err": err, "splits": plan[1],
           "ms": cuda_ms(torch, run, 10),
           "kernel_only_ms": kernel_only_ms(torch, run, 5,
                                            "fused_logprob_bwd_kernel"),
           "plain_ms": cuda_ms(torch, plain, 2),
           "library_ms": cuda_ms(torch, lambda: torch.autograd.grad(
               ce, flat, g_out.reshape(-1), retain_graph=True), 10),
           "bound_ms": b_ms, "bound_by": b_by}
    ko = rec["kernel_only_ms"]
    log(f"  fused_logprob_bwd [16, {n}, {V}] strided view bf16, plan "
        f"{plan[1]} splits of {plan[0]}: max|ddl| {err:.3e}, worst element "
        f"{excess:.3g} of its tolerance, last position zero; "
        f"{rec['ms']:.4f} ms per call ("
        + ("not measured" if ko is None else f"{ko:.4f} ms")
        + f" in the kernel), plain {rec['plain_ms']:.4f} ms, library "
        f"(backward of F.cross_entropy) {rec['library_ms']:.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by})")
    del logits, view, flat, ce
    return rec


def phase_kernels(torch, dev):
    """Each kernel against its plain version; returns the JSON records."""
    import torch.nn.functional as F

    from repro_torch.kernels import build, dispatch, fused_logprob, \
        fused_sample
    from repro_torch.kernels.flash_attention import chunked_attention, \
        flash_attention_cuda
    from repro_torch.kernels.fused_logprob import fused_logprob_bwd_cuda, \
        fused_logprob_bwd_plain, fused_logprob_cuda, fused_logprob_plain
    from repro_torch.kernels.fused_sample import fused_sample_cuda, \
        fused_sample_plain
    from repro_torch.rl import prng
    from repro_torch.rl.data import ArithmeticTasks

    log("[2] kernels against their plain versions on the card")
    gen = torch.Generator(device=dev).manual_seed(0)
    bf16 = torch.bfloat16
    records = []

    # ---- fused_sample: tokens equal, log-prob within 1e-4
    def sample_logits(B, V=V_LLAMA):
        x = torch.randn(B, V, generator=gen, device=dev) * 3
        x[0, 5] = 1e30              # one dominating logit
        x[1] = -1e30                # a row of tiny logits
        x[2, 3] = x[2, 99] = 40.0   # a duplicate maximum
        return x.to(bf16)

    key = prng.split(prng.PRNGKey(0), 3)[1]
    sample_err = 0.0
    for B in (16, 32, 64):
        x = sample_logits(B)
        for T in (0.0, 0.7, 1.0):
            tok, lp = fused_sample_cuda(x, key, T)
            tok_p, lp_p = fused_sample_plain(x, key, T)
            require(torch.equal(tok, tok_p),
                    f"fused_sample [{B}, {V_LLAMA}] T={T}: tokens differ "
                    f"at rows {(tok != tok_p).nonzero().flatten().tolist()}")
            if T == 0.0:
                require(tok[2].item() == 3, "greedy tie not to the lower "
                        "column")
            err = max_err(lp, lp_p)
            require(err <= 1e-4, f"fused_sample log-prob error {err:.3e}")
            if B == 16:
                sample_err = max(sample_err, err)
            log(f"  fused_sample [{B}, {V_LLAMA}] bf16 T={T}: tokens equal, "
                f"max|dlogp| {err:.3e}")
    counters = build.scratch("fused_sample counters", dev, 1, torch.int32)
    require(int(counters.abs().sum().item()) == 0,
            "fused_sample left a merge counter non-zero")

    # the instructions a logit of the noisy bf16 instance's column loop,
    # and the time they take at the card's issue rate
    sass = sass_loop_instructions("fused_sample", (
        "fused_sample_kernel", "__nv_bfloat16", "Li8E", "Lb1E"))
    n_sm = build.sm_count(dev)
    clock = max_sm_clock_mhz()
    per_logit = None if sass is None else sass[0] / 8

    def timed_sample(B, V=V_LLAMA):
        x = sample_logits(B, V)

        def run():
            return fused_sample_cuda(x, key, 1.0)
        b_ms, b_by = bound(x.numel() * 2 + B * 8,
                           x.numel() * SAMPLE_OPS_PER_LOGIT, FP32_FLOPS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):      # the host's side alone: the card keeps up
            run()
        host_ms = (time.perf_counter() - t0) / 200 * 1e3
        torch.cuda.synchronize()
        rec = {"ms": cuda_ms(torch, run, 50),
               "kernel_only_ms": kernel_only_ms(torch, run, 20,
                                                "fused_sample_kernel"),
               "host_ms": host_ms,
               "plain_ms": cuda_ms(torch, lambda: fused_sample_plain(
                   x, key, 1.0), 3),
               "bound_ms": b_ms, "bound_by": b_by,
               "splits": fused_sample.split_plan(B, V, n_sm)[1]}
        # an estimate from the SASS count, for the log line only
        issue_ms = None if per_logit is None else (
            per_logit * x.numel() / 32 / (ISSUE_PER_SM_CLOCK * n_sm)
            / (clock * 1e3))
        ko = rec["kernel_only_ms"]
        was = EARLIER_SAMPLE.get(B) if V == V_LLAMA else None
        log(f"  time fused_sample [{B}, {V}] bf16, {rec['splits']} "
            f"splits a row: {rec['ms']:.4f} ms per call ("
            + ("not measured" if ko is None else f"{ko:.4f} ms")
            + " in the kernel"
            + (f"; before the redesign {was[0]} ({was[1]})" if was else "")
            + f"), host {host_ms:.4f} ms a call back to back, plain "
            f"{rec['plain_ms']:.4f} ms, bound {b_ms:.4f} ms "
            f"({b_by}), issue "
            + ("not measured" if issue_ms is None
               else f"{issue_ms:.4f} ms"))
        return rec

    log("  fused_sample SASS: " + (
        "not measured (no cuobjdump)" if sass is None else
        f"{sass[0]} instructions in the column loop of {sass[1]}, "
        f"{per_logit:.1f} a logit; issue time at {ISSUE_PER_SM_CLOCK} warp "
        f"instructions a clock on each of {n_sm} SMs at {clock:.0f} MHz"))
    main = timed_sample(16)
    pool = timed_sample(32)
    # the windowed archs' vocabularies ([15]): starcoder2-3b's at the
    # generator's 16 rows, command-r's and nemotron's at 4 and 16; and
    # llama4-scout's ([16]) and deepseek-v3's ([17]) at 16; xlstm-350m's
    # ([20]) and seamless-m4t-medium's ([21]) at 16
    vocabs = {f"{B}x{V}": timed_sample(B, V)
              for B, V in ((16, 49152), (4, 256000), (16, 256000),
                           (16, V_SCOUT), (16, V_DSV3), (16, V_XLSTM),
                           (16, V_SEAMLESS))}
    # what the launch-count lock adds to every wrapper call, host clock
    t0 = time.perf_counter()
    for _ in range(100000):
        with build._LAUNCH_LOCK:
            pass
    log(f"  the launch-count lock: "
        f"{(time.perf_counter() - t0) / 100000 * 1e6:.3f} us a call, "
        "taken and released with no other thread waiting (host clock)")
    records.append({
        "name": "fused_sample", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_sample.cu",
        "replaces": "src/repro/kernels/fused_sample.py:65",
        "launches": 0, "max_abs_err": sample_err, "ms": main["ms"],
        "kernel_only_ms": main["kernel_only_ms"],
        "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": None,
        "shape": [16, V_LLAMA], "dtype": "bfloat16",
        "sass_per_logit": per_logit, "host_ms": main["host_ms"],
        "pool32": {k: pool[k] for k in ("ms", "kernel_only_ms", "host_ms",
                                        "plain_ms", "bound_ms")},
        "vocabularies": {n: {k: r[k] for k in ("ms", "kernel_only_ms",
                                               "plain_ms", "bound_ms",
                                               "splits")}
                         for n, r in vocabs.items()}})

    # ---- fused_logprob: the reference scorer's strided view, read in place
    t_new = time.perf_counter()    # the checks the B1/B2 redesign added
    logits = (torch.randn(16, 80, V_LLAMA, generator=gen, device=dev)
              * 2).to(bf16)
    view = logits[:, :-1]
    toks = torch.randint(0, V_LLAMA, (16, 79), generator=gen, device=dev,
                         dtype=torch.int32)
    lp, m, s = fused_logprob_cuda(view, toks)
    lp_p, m_p, s_p = fused_logprob_plain(view.reshape(-1, V_LLAMA),
                                         toks.reshape(-1))
    logprob_err = max_err(lp.reshape(-1), lp_p)
    require(logprob_err <= 1e-4, f"fused_logprob error {logprob_err:.3e}")
    require(torch.equal(m.reshape(-1), m_p), "fused_logprob m differs")
    t0 = time.perf_counter()
    plan, split_err = logprob_split_check(torch, view, toks, lp, m)
    new_s = time.perf_counter() - t0
    log(f"  fused_logprob [16, 79, {V_LLAMA}] strided view bf16, plan "
        f"{plan[1]} splits of {plan[0]}: max|dlogp| {logprob_err:.3e}, m "
        f"equal, max|ds|/s "
        f"{((s.reshape(-1) - s_p).abs() / s_p).max().item():.3e}, split "
        f"plain {split_err:.3e}")
    small = torch.randn(33, 257, generator=gen, device=dev) * 4
    small[0, 5], small[1], small[2, 3], small[2, 99] = 1e30, -1e30, 9.0, 9.0
    stoks = torch.randint(0, 257, (33,), generator=gen, device=dev)
    err = max_err(fused_logprob_cuda(small, stoks)[0],
                  fused_logprob_plain(small, stoks)[0])
    require(err <= 1e-5, f"fused_logprob [33, 257] error {err:.3e}")
    log(f"  fused_logprob [33, 257] fp32 with +-1e30 and tied rows: "
        f"max|dlogp| {err:.3e}")
    t0 = time.perf_counter()
    check_logprob_misaligned(torch, dev, gen)
    new_s += time.perf_counter() - t0

    def run_logprob():
        return fused_logprob_cuda(view, toks)
    flat = view.reshape(-1, V_LLAMA).contiguous()
    flat_toks = toks.reshape(-1).long()
    ms = cuda_ms(torch, run_logprob, 20)
    plain_ms = cuda_ms(torch, lambda: fused_logprob_plain(
        view.reshape(-1, V_LLAMA), toks.reshape(-1)), 3)
    lib_ms = cuda_ms(torch, lambda: F.cross_entropy(
        flat, flat_toks, reduction="none"), 20)
    del flat
    n_rows = toks.numel()
    b_ms, b_by = bound(view.numel() * 2 + n_rows * 4 + 3 * n_rows * 4,
                       view.numel() * LOGPROB_OPS_PER_LOGIT, FP32_FLOPS)
    ko = kernel_only_ms(torch, run_logprob, 10, "fused_logprob_kernel")
    t0 = time.perf_counter()
    per_logit = logprob_sass("fused_logprob", 2, n_sm, clock)
    new_s += time.perf_counter() - t0
    log(f"  fused_logprob [16, 79, {V_LLAMA}] strided view bf16, plan "
        f"{plan[1]} splits of {plan[0]}: {ms:.4f} ms per call ("
        + ("not measured" if ko is None else f"{ko:.4f} ms")
        + f" in the kernel), plain {plain_ms:.4f} ms, library "
        f"(F.cross_entropy) {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    records.append({
        "name": "fused_logprob", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_logprob.cu",
        "replaces": "src/repro/kernels/fused_logprob.py:31",
        "launches": 0, "max_abs_err": logprob_err, "ms": ms,
        "kernel_only_ms": ko,
        "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": lib_ms, "shape": [16, 79, V_LLAMA],
        "dtype": "bfloat16", "splits": plan[1], "sass_per_logit": per_logit})
    records[-1]["scout"] = timed_logprob_at(torch, dev, gen, V_SCOUT)
    records[-1]["deepseek_v3"] = timed_logprob_at(torch, dev, gen, V_DSV3)
    records[-1]["xlstm"] = timed_logprob_at(torch, dev, gen, V_XLSTM,
                                            T=XLSTM_PROMPT + XLSTM_NEW)
    records[-1]["seamless"] = timed_logprob_at(torch, dev, gen, V_SEAMLESS,
                                               T=AUDIO_PROMPT + AUDIO_NEW)
    new_s += sum(r["split_check_s"] for r in records[-1].values()
                 if isinstance(r, dict) and "split_check_s" in r)

    # ---- fused_logprob_bwd: the trainer's strided view, with the gradient
    # of the whole [16, 80, V] written (zeros in the last position).  The
    # +-1e30 and tied rows sit in batches 0 and 13, so a wrong outer stride
    # shows.  Each element is held to the rounding of its own dtype: one
    # bf16 ulp, and 1e-6 relative in fp32
    g_out = torch.randn(16, 79, generator=gen, device=dev)
    bwd_err = None
    for dtype, rtol in ((bf16, 2.0 ** -7), (torch.float32, 1e-6)):
        xb = logits.to(dtype, copy=True)
        for b in (0, 13):
            xb[b, b, 5], xb[b, b + 1] = 1e30, -1e30
            xb[b, b + 2, 3] = xb[b, b + 2, 99] = 9.0
        _, bm, bs = fused_logprob_cuda(xb[:, :-1], toks)
        dl = fused_logprob_bwd_cuda(xb, toks, bm, torch.log(bs), g_out,
                                    n_valid=79)
        dl_p = fused_logprob_bwd_plain(
            xb[:, :-1].reshape(-1, V_LLAMA), toks.reshape(-1),
            bm.reshape(-1), torch.log(bs).reshape(-1), g_out.reshape(-1))
        require(dl.shape == xb.shape and dl.dtype == dtype, "bwd output")
        require(bool((dl[:, -1] == 0).all().item()), "bwd: last row not zero")
        got = dl[:, :-1].reshape(-1, V_LLAMA)
        err = max_err(got, dl_p)
        excess = bwd_excess(torch, got, dl_p, g_out.reshape(-1),
                            toks.reshape(-1), rtol)
        require(excess <= 1.0, f"fused_logprob_bwd {dtype}: an element is "
                f"{excess:.3g} times its tolerance (max|ddl| {err:.3e})")
        if dtype == bf16:
            bwd_err = err
        log(f"  fused_logprob_bwd [16, 79, {V_LLAMA}] strided view "
            f"{str(dtype)[6:]} with +-1e30 and tied rows in batches 0 and "
            f"13: max|ddl| {err:.3e}, worst element {excess:.3g} of its "
            f"tolerance ({rtol:.3g} relative, +1e-12), last position zero")
        del xb, dl, dl_p, got
    _, sm, ss = fused_logprob_cuda(small, stoks)
    sg = torch.randn(33, generator=gen, device=dev)
    got = fused_logprob_bwd_cuda(small, stoks, sm, torch.log(ss), sg)
    want = fused_logprob_bwd_plain(small, stoks, sm, torch.log(ss), sg)
    err = max_err(got, want)
    excess = bwd_excess(torch, got, want, sg, stoks, 1e-6)
    require(err <= 1e-5 and excess <= 1.0, f"fused_logprob_bwd [33, 257] "
            f"error {err:.3e}, worst element {excess:.3g} of its tolerance")
    log(f"  fused_logprob_bwd [33, 257] fp32 (rows at every phase) with "
        f"+-1e30 and tied rows: max|ddl| {err:.3e} (tolerance 1e-5), worst "
        f"element {excess:.3g} of 1e-6 relative")

    log_s = torch.log(s)

    def run_bwd():
        return fused_logprob_bwd_cuda(logits, toks, m, log_s, g_out,
                                      n_valid=79)
    ms = cuda_ms(torch, run_bwd, 20)
    plain_ms = cuda_ms(torch, lambda: fused_logprob_bwd_plain(
        view.reshape(-1, V_LLAMA), toks.reshape(-1), m.reshape(-1),
        log_s.reshape(-1), g_out.reshape(-1)), 3)
    flat = view.reshape(-1, V_LLAMA).contiguous().requires_grad_()
    ce = F.cross_entropy(flat, flat_toks, reduction="none")
    lib_ms = cuda_ms(torch, lambda: torch.autograd.grad(
        ce, flat, g_out.reshape(-1), retain_graph=True), 20)
    del flat, ce
    b_ms, b_by = bound(view.numel() * 2 + logits.numel() * 2 + 4 * n_rows * 4,
                       view.numel() * LOGPROB_BWD_OPS_PER_LOGIT, FP32_FLOPS)
    ko = kernel_only_ms(torch, run_bwd, 10, "fused_logprob_bwd_kernel")
    plan = fused_logprob.bwd_plan(V_LLAMA)
    t0 = time.perf_counter()
    per_logit = logprob_sass("fused_logprob_bwd", 4, n_sm, clock)
    new_s += time.perf_counter() - t0
    log(f"  fused_logprob_bwd [16, 79, {V_LLAMA}] strided view bf16, plan "
        f"{plan[1]} splits of {plan[0]}: {ms:.4f} ms per call ("
        + ("not measured" if ko is None else f"{ko:.4f} ms")
        + f" in the kernel), plain {plain_ms:.4f} ms, library (backward of "
        f"F.cross_entropy) {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    records.append({
        "name": "fused_logprob_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_logprob_bwd.cu",
        "replaces": "src/repro/kernels/fused_logprob.py:111",
        "launches": 0, "max_abs_err": bwd_err, "ms": ms,
        "kernel_only_ms": ko,
        "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": lib_ms, "shape": [16, 79, V_LLAMA],
        "dtype": "bfloat16", "splits": plan[1], "sass_per_logit": per_logit})
    del logits, view
    records[-1]["deepseek_v3"] = timed_logprob_bwd_at(torch, dev, gen, V_DSV3)
    records[-1]["xlstm"] = timed_logprob_bwd_at(
        torch, dev, gen, V_XLSTM, T=XLSTM_TRAIN_PROMPT + XLSTM_TRAIN_NEW)
    records[-1]["seamless"] = timed_logprob_bwd_at(
        torch, dev, gen, V_SEAMLESS, T=AUDIO_TRAIN_SEQ)
    # and at [21] (b)'s view before its cut to AUDIO_TRAIN_SEQ
    t0 = time.perf_counter()
    records[-1]["seamless_t128"] = timed_logprob_bwd_at(
        torch, dev, gen, V_SEAMLESS, T=128)
    new_s += time.perf_counter() - t0
    log(f"  B1 and B2: the checks and timings their redesign added took "
        f"{new_s:.1f} s of the {time.perf_counter() - t_new:.1f} s of "
        "theirs")

    # ---- flash_attention: fp32 on peaked attention, bf16, ragged, small
    def qkv(B, S, H, K, hd, dtype, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        return tuple(torch.randn(B, S, n, hd, generator=g, device=dev)
                     .to(dtype) for n in (H, K, K))

    # q_scale 4 makes the scores' spread 4 and the attention sharply
    # peaked, so |o| nears |v| and an error cannot hide under averaging
    flash_err = None
    main = (4, 2048, 32, 8, 128)
    # the serve phase's own shapes: prefill of the prompts, and the
    # reference forward_train over prompt and completion
    sp = ArithmeticTasks(seed=0).prompt_len
    serve_shapes = [(N_PROMPTS * N_PER, s, 32, 8, 128)
                    for s in (sp, sp + MAX_NEW)]
    cases = [(main, torch.float32, 1.0, 1e-4, False),
             (main, torch.float32, 4.0, 1e-4, False),
             (main, bf16, 1.0, 3e-2, True),
             (main, bf16, 4.0, 3e-2, True),
             ((1, 1000, 32, 8, 128), bf16, 1.0, 3e-2, True),
             ((2, 200, 8, 2, 64), torch.float32, 1.0, 1e-5, False)]
    # the tensor-core kernel's head dims (one k-step at 16) and ragged S
    cases += [((2, S, H, K, hd), bf16, 4.0, 3e-2, True)
              for S, H, K, hd in ((128, 8, 2, 32), (100, 4, 4, 64),
                                  (77, 8, 1, 16), (130, 4, 2, 128))]
    for shape in serve_shapes:
        cases += [(shape, torch.float32, 4.0, 1e-4, False),
                  (shape, bf16, 1.0, 3e-2, True)]
    # hd 192 (nemotron-4-340b) at its timing shape and ragged: fp32 within
    # 1e-5 of max(1, |o|), and peaked (q x 4) within hd 128's 1e-4 at the
    # main shape; bf16 within 3e-2; and llama4-scout's g = 5 (40 / 8 heads)
    cases += [(HD192, torch.float32, 1.0, 1e-5, True),
              (HD192, torch.float32, 4.0, 1e-4, False),
              (HD192, bf16, 4.0, 3e-2, True),
              ((2, 130, 10, 2, 192), torch.float32, 1.0, 1e-5, True),
              ((2, 130, 10, 2, 192), bf16, 4.0, 3e-2, True),
              ((2, 300, 40, 8, 128), bf16, 4.0, 3e-2, True)]
    # hd 112 (zamba2-7b's shared block, MHA) at its timing shape and
    # ragged, at hd 192's tolerances
    cases += [(HD112, torch.float32, 1.0, 1e-5, True),
              (HD112, torch.float32, 4.0, 1e-4, False),
              (HD112, bf16, 4.0, 3e-2, True),
              ((2, 130, 8, 8, 112), torch.float32, 1.0, 1e-5, True),
              ((2, 130, 8, 8, 112), bf16, 4.0, 3e-2, True)]
    # hd 64 (seamless-m4t-medium's decoder, MHA) at its timing shape and
    # at [21]'s own: the prefill of the prompts and the scoring, in fp32
    # (the SIMT instance) and bf16 (the wgmma instance)
    for shape in ((N_PROMPTS * N_PER, AUDIO_PROMPT, 16, 16, 64),
                  (N_PROMPTS * N_PER, AUDIO_PROMPT + AUDIO_NEW, 16, 16, 64)):
        cases += [(shape, torch.float32, 4.0, 1e-4, False),
                  (shape, bf16, 4.0, 3e-2, True)]
    cases += [(HD64, torch.float32, 1.0, 1e-5, True),
              (HD64, bf16, 4.0, 3e-2, True)]
    for shape, dtype, q_scale, tol, rel in cases:
        q, k, v = qkv(*shape, dtype, seed=sum(shape))
        q = q * q_scale
        o = flash_attention_cuda(q, k, v)
        o_p = chunked_attention(q, k, v)
        require(o.dtype == dtype and o.shape == q.shape, "flash output")
        d = (o.float() - o_p.float()).abs()
        err = d.max().item()
        err_rel = (d / o_p.float().abs().clamp(min=1.0)).max().item()
        require((err_rel if rel else err) <= tol,
                f"flash_attention {list(shape)} {dtype}: error {err:.3e}")
        if shape == main and dtype == bf16:
            flash_err = max(flash_err or 0.0, err)
        log(f"  flash_attention {list(shape)} {str(dtype)[6:]} q x{q_scale:g}:"
            f" max|do| "
            f"{err:.3e}, max|do|/max(1,|o|) {err_rel:.3e} "
            f"(tolerance {tol:g}{' relative' if rel else ''}; mean|o| "
            f"{o_p.float().abs().mean().item():.3f}, max|o| "
            f"{o_p.float().abs().max().item():.3f})")
        del q, k, v, o, o_p, d

    B, S, H, K, hd = 4, 2048, 32, 8, 128
    q, k, v = qkv(B, S, H, K, hd, bf16, seed=7)

    def run_flash():
        return flash_attention_cuda(q, k, v)
    ms = cuda_ms(torch, run_flash, 10)
    plain_ms = cuda_ms(torch, lambda: chunked_attention(q, k, v), 3)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), 10)
    flops = 4 * B * H * hd * S * (S + 1) / 2     # QK^T and PV, causal
    b_ms, b_by = bound((q.numel() * 2 + k.numel() * 2) * 2, flops,
                       BF16_TENSOR_FLOPS)
    records.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:21",
        "launches": 0, "max_abs_err": flash_err, "ms": ms,
        "kernel_only_ms": kernel_only_ms(torch, run_flash, 3,
                                         "flash_fwd_wgmma_kernel"),
        "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": lib_ms, "shape": [B, S, H, K, hd],
        "dtype": "bfloat16"})
    del q, k, v, qt, kt, vt

    # hd 192: two warpgroups a block (see csrc/flash_attention.cu)
    B, S, H, K, hd = HD192
    q, k, v = qkv(B, S, H, K, hd, bf16, seed=8)

    def run_flash():
        return flash_attention_cuda(q, k, v)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    b_ms, b_by = bound((q.numel() * 2 + k.numel() * 2) * 2,
                       4 * B * H * hd * S * (S + 1) / 2, BF16_TENSOR_FLOPS)
    records[-1]["hd192"] = {
        "shape": list(HD192), "ms": cuda_ms(torch, run_flash, 10),
        "kernel_only_ms": kernel_only_ms(torch, run_flash, 3,
                                         "flash_fwd_wgmma_kernel"),
        "plain_ms": cuda_ms(torch, lambda: chunked_attention(q, k, v), 3),
        "library_ms": cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), 10),
        "bound_ms": b_ms, "bound_by": b_by}
    h = records[-1]["hd192"]
    ko = h["kernel_only_ms"]
    log(f"  time flash_attention {list(HD192)} bf16: {h['ms']:.4f} ms per "
        f"call ({'not measured' if ko is None else f'{ko:.4f} ms'} in the "
        f"kernel), plain {h['plain_ms']:.4f} ms, library (SDPA) "
        f"{h['library_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    del q, k, v, qt, kt, vt

    # hd 112: three warpgroups a block, m64n112k16 for P V
    B, S, H, K, hd = HD112
    q, k, v = qkv(B, S, H, K, hd, bf16, seed=9)

    def run_flash():
        return flash_attention_cuda(q, k, v)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    b_ms, b_by = bound((q.numel() * 2 + k.numel() * 2) * 2,
                       4 * B * H * hd * S * (S + 1) / 2, BF16_TENSOR_FLOPS)
    usage = {kind: ptxas_usage("flash_attention", parts) for kind, parts in
             (("bf16", ("wgmma", "Li112E")),
              ("fp32", ("flash_fwd_kernelIf", "Li112E")))}
    require(all(len(u) == 1 for u in usage.values()),
            f"ptxas lines of the hd-112 instances: {usage}")
    records[-1]["hd112"] = {
        "shape": list(HD112), "ms": cuda_ms(torch, run_flash, 10),
        "kernel_only_ms": kernel_only_ms(torch, run_flash, 3,
                                         "flash_fwd_wgmma_kernel"),
        "plain_ms": cuda_ms(torch, lambda: chunked_attention(q, k, v), 3),
        "library_ms": cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True), 10),
        "bound_ms": b_ms, "bound_by": b_by,
        "registers": {kind: u[0][1] for kind, u in usage.items()},
        "spill_bytes": {kind: u[0][2] for kind, u in usage.items()}}
    h = records[-1]["hd112"]
    ko = h["kernel_only_ms"]
    log(f"  time flash_attention {list(HD112)} bf16: {h['ms']:.4f} ms per "
        f"call ({'not measured' if ko is None else f'{ko:.4f} ms'} in the "
        f"kernel), plain {h['plain_ms']:.4f} ms, library (SDPA) "
        f"{h['library_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}, "
        f"{4 * B * H * hd * S * (S + 1) / 2 / 1e9:.1f} GFLOP); ptxas: "
        + ", ".join(f"{kind} {h['registers'][kind]} registers, "
                    f"{h['spill_bytes'][kind]} bytes spilled"
                    for kind in ("bf16", "fp32")))
    del q, k, v, qt, kt, vt

    # hd 64: seamless-m4t-medium's decoder ([21])
    B, S, H, K, hd = HD64
    q, k, v = qkv(B, S, H, K, hd, bf16, seed=10)

    def run_flash():
        return flash_attention_cuda(q, k, v)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    flops = 4 * B * H * hd * S * (S + 1) / 2
    b_ms, b_by = bound((q.numel() * 2 + k.numel() * 2) * 2, flops,
                       BF16_TENSOR_FLOPS)
    usage = {kind: ptxas_usage("flash_attention", parts) for kind, parts in
             (("bf16", ("wgmma", "Li64E")),
              ("fp32", ("flash_fwd_kernelIf", "Li64E")))}
    records[-1]["hd64"] = {
        "shape": list(HD64), "ms": cuda_ms(torch, run_flash, 10),
        "kernel_only_ms": kernel_only_ms(torch, run_flash, 3,
                                         "flash_fwd_wgmma_kernel"),
        "plain_ms": cuda_ms(torch, lambda: chunked_attention(q, k, v), 3),
        "library_ms": cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True), 10),
        "bound_ms": b_ms, "bound_by": b_by, "gflop": flops / 1e9,
        "registers": {kind: [r for _, r, _ in u] for kind, u in usage.items()},
        "spill_bytes": {kind: [b for _, _, b in u]
                        for kind, u in usage.items()}}
    h = records[-1]["hd64"]
    ko = h["kernel_only_ms"]
    log(f"  time flash_attention {list(HD64)} bf16: {h['ms']:.4f} ms per "
        f"call ({'not measured' if ko is None else f'{ko:.4f} ms'} in the "
        f"kernel), plain {h['plain_ms']:.4f} ms, library (SDPA) "
        f"{h['library_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}, "
        f"{flops / 1e9:.1f} GFLOP); ptxas: "
        + ", ".join(f"{kind} registers {h['registers'][kind]}, spilled "
                    f"{h['spill_bytes'][kind]} bytes"
                    for kind in ("bf16", "fp32")))
    del q, k, v, qt, kt, vt

    # ---- the attention gradient: the flash forward's recompute backward
    # against chunked_attention's, at the trainer's [16, 80] shape, at
    # zamba2-7b's hd 112 ([19] (b)'s shared block) and at
    # seamless-m4t-medium's hd 64 ([21] (b)'s decoder)
    for shape in ((16, 80, 32, 8, 128), (16, 80, 32, 32, 112),
                  (16, AUDIO_TRAIN_SEQ, 16, 16, 64)):
        for dtype, tol in ((torch.float32, 1e-4), (bf16, 3e-2)):
            q, k, v = qkv(*shape, dtype, seed=11)
            go = torch.randn(*shape[:3], shape[4], generator=gen,
                             device=dev).to(dtype)
            grads = []
            for fn in (dispatch.attention, chunked_attention):
                leaves = [t.clone().requires_grad_() for t in (q, k, v)]
                grads.append(torch.autograd.grad(fn(*leaves), leaves, go))
            err = max(max_err(a, b) for a, b in zip(*grads))
            require(err <= tol, f"attention gradient {list(shape)} {dtype} "
                    f"error {err:.3e}")
            log(f"  attention gradient {list(shape)} {str(dtype)[6:]}: "
                f"max|d(dq, dk, dv)| {err:.3e} against chunked_attention's "
                f"(tolerance {tol:g})")
            del q, k, v, go, grads

    records.append(check_paged_attention(torch, dev))

    for r in records:
        ko = r["kernel_only_ms"]
        log(f"  time {r['name']} {r['shape']} {r['dtype']}: kernel {r['ms']:.4f} ms "
            f"per call ({'not measured' if ko is None else f'{ko:.4f} ms'}"
            f" of it in the kernel, profiler), plain {r['plain_ms']:.4f} ms,"
            f" library " + ("n/a" if r["library_ms"] is None
                            else f"{r['library_ms']:.4f} ms")
            + f", bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    return records


def rel_excess(got, want, tol: float) -> float:
    """The largest |got - want| / (tol max(1, |want|)): at most 1 where
    every element holds."""
    d = (got.float() - want.float()).abs()
    return (d / (tol * want.float().abs().clamp(min=1.0))).max().item()


def phase_int8(torch, dev, params):
    """Kernel B6 through ``dispatch.int8_matmul``, its only path.  Returns
    (the JSON record, the launch counts of the path's run)."""
    from repro_torch.core.ddma import dequantize_int8, quantize_int8
    from repro_torch.kernels import build, dispatch
    from repro_torch.kernels.int8_matmul import int8_matmul_cuda, \
        int8_matmul_plain
    from repro_torch.kernels.ref import int8_matmul_ref

    bf16, f32 = torch.bfloat16, torch.float32
    log("[9] int8 matmul (B6) through dispatch.int8_matmul, on the serve "
        "phase's layer-0 weights")
    gen = torch.Generator(device=dev).manual_seed(15)

    def randn(*shape, dtype=bf16):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    # ---- the JAX suite's shapes and N(0, 1) weights (tests/test_kernels.py)
    # at its 1e-3; then M = 1 with N not a multiple of 16, and views whose
    # rows are not 16-byte aligned (the kernel's byte-by-byte edge path),
    # with weights at the model's init scale 1 / sqrt(K); fp32 and bf16 x
    # and the redesign's tile edges (tests/test_torch_cuda.py's
    # test_cuda_int8_matmul_tile_edges): M around the decode kernel's 16
    # rows and the wgmma kernel's 64- and 128-row tiles, K and N not
    # multiples of its 64 x 128 tiles, K deep enough to split at M <= 16
    edges = [(M, K, N, view) for M in (1, 15, 16, 17, 64, 65, 128, 129)
             for K, N, view in ((1000, 300, False), (200, 130, True))]
    for M, K, N, view in [(64, 128, 96, False), (50, 70, 90, False),
                          (8, 512, 8, False), (1, 4096, 1000, False),
                          (1, 4096, 14336, False), (33, 300, 200, True)] \
            + edges:
        w_std = 1.0 if K <= 512 and not view else K ** -0.5
        q, sc = quantize_int8(randn(K, N + 3 * view, dtype=f32) * w_std)
        q, sc = q[:, 3 * view:], sc[:, 3 * view:]
        for dtype in (f32, bf16):
            x = randn(M, K + view, dtype=dtype)[:, view:]
            got = int8_matmul_cuda(x, q, sc)
            ex = rel_excess(got, int8_matmul_plain(x, q, sc), INT8_TOL)
            err_ref = max_err(got, int8_matmul_ref(x, q, sc[0]))
            require(ex <= 1.0 and err_ref <= 1e-3,
                    f"int8_matmul [{M}, {K}] x [{K}, {N}] {dtype}: "
                    f"{ex:.3g} of the tolerance, |d| to the oracle "
                    f"{err_ref:.3e}")
            counts = build.scratch("int8_matmul counters", x.device, 1,
                                   torch.int32)
            require(int(counts.abs().sum().item()) == 0,
                    "int8_matmul left a split-K counter set")
            log(f"  int8_matmul [{M}, {K}] x [{K}, {N}] {str(dtype)[6:]}"
                f"{' unaligned views' if view else ''}: worst element "
                f"{ex:.3g} of {INT8_TOL:g} max(1, |plain|); max|d| to the "
                f"dequantize-first oracle {err_ref:.3e} (tolerance 1e-3)")

    # ---- the path's run: layer 0's matrices at the published widths,
    # quantized as GeneratorExecutor(quantize=True) would, at decode and
    # prefill M
    layers = params["layers"]
    mats = {"wq": layers["attn"]["wq"][0], "wk": layers["attn"]["wk"][0],
            "w_gate": layers["mlp"]["w_gate"][0],
            "w_down": layers["mlp"]["w_down"][0]}
    quant = {n: quantize_int8(w) for n, w in mats.items()}
    xs = {(M, w.shape[0]): randn(M, w.shape[0]) for M in (16, 8192)
          for w in mats.values()}
    build.reset_launches()          # the int8 path's run starts here
    outs = {(n, M): dispatch.int8_matmul(xs[M, mats[n].shape[0]], *quant[n])
            for n in mats for M in (16, 8192)}
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)  # ... and ends here
    require(launches == {"int8_matmul": len(outs)},
            f"int8 launches {launches}, want {len(outs)}")
    worst = 0.0
    for (n, M), got in outs.items():
        x, (q, sc) = xs[M, mats[n].shape[0]], quant[n]
        want = int8_matmul_plain(x, q, sc)
        ex = rel_excess(got, want, INT8_TOL)
        err = max_err(got, want)
        worst = max(worst, err)
        # the generator's numerics: quantize_dequant hands it the weight
        # dequantized to bf16, and x @ w rounds the product to bf16.  bf16
        # rounds a value by at most 2^-8 of itself, so the weights move the
        # sum by at most 2^-8 sum_k |x w| and the output rounds by at most
        # 2^-8 |y|: |d| <= 2^-8 (sum_k |x w| + |y|)
        w_deq = dequantize_int8(q, sc, bf16)
        y = (x @ w_deq).float()
        bound_gen = 2.0 ** -8 * ((x.float().abs() @ w_deq.float().abs())
                                 + y.abs())
        ex_gen = ((got - y).abs() / bound_gen.clamp(min=1e-30)).max().item()
        require(ex <= 1.0 and ex_gen <= 1.0,
                f"int8_matmul {n} M={M}: {ex:.3g} of the tolerance to the "
                f"plain version, {ex_gen:.3g} of the bound to x @ "
                "dequantize_int8(q, s, bf16)")
        log(f"  int8_matmul {n} [{M}, {q.shape[0]}] x {list(q.shape)} bf16:"
            f" max|d| {err:.3e}, worst element {ex:.3g} of {INT8_TOL:g} "
            f"max(1, |plain|); against x @ dequantize_int8(q, s, bf16) "
            f"(the quantized generator's product) {ex_gen:.3g} of 2^-8 "
            f"(sum|x w| + |y|) (mean|y| {y.abs().mean().item():.3f})")
        del want, w_deq, y, bound_gen
    del outs
    torch.cuda.empty_cache()

    # ---- time at w_gate [4096, 14336]: decode and prefill M, bf16 x; and
    # decode M with fp32 x
    q, sc = quant["w_gate"]
    K, N = q.shape

    def timed(M, dtype):
        x = xs[M, K].to(dtype)
        w_deq = dequantize_int8(q, sc, dtype)    # the yardstick's weight

        def run():
            return dispatch.int8_matmul(x, q, sc)
        n = 50 if M == 16 else 10
        # fp32 x runs on the tensor cores as three exact bf16 parts
        # (csrc/int8_matmul.cu), three times the bf16 operations
        parts = 3 if dtype == f32 else 1
        b_ms, b_by = bound(K * N + x.numel() * x.element_size() + N * 4
                           + M * N * 4, parts * 2 * M * K * N,
                           BF16_TENSOR_FLOPS)
        rec = {"ms": cuda_ms(torch, run, n),
               "kernel_only_ms": kernel_only_ms(torch, run, n // 2,
                                                "int8_matmul_"),
               "plain_ms": cuda_ms(torch, lambda: int8_matmul_plain(
                   x, q, sc), 3),
               "library_ms": cuda_ms(torch, lambda: torch.matmul(x, w_deq), n),
               "bound_ms": b_ms, "bound_by": b_by,
               "shape": [M, K, N], "dtype": str(dtype)[6:]}
        ko = rec["kernel_only_ms"]
        was_call, was_kernel = EARLIER_INT8[M, rec["dtype"]]
        log(f"  time int8_matmul [{M}, {K}] x [{K}, {N}] {str(dtype)[6:]}: "
            f"{rec['ms']:.4f} ms per call ("
            + ("not measured" if ko is None else f"{ko:.4f} ms")
            + f" in the kernel; before the redesign {was_call} "
            f"({was_kernel})), plain "
            f"{rec['plain_ms']:.4f} ms, library "
            f"(torch.matmul on the weight dequantized to {str(dtype)[6:]}) "
            f"{rec['library_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
        return rec

    decode = timed(16, bf16)
    prefill = timed(8192, bf16)
    decode_f32 = timed(16, f32)
    del xs, quant
    torch.cuda.empty_cache()
    return {"name": "int8_matmul", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/int8_matmul.cu",
            "replaces": "src/repro/kernels/int8_matmul.py:18",
            "launches": 0, "max_abs_err": worst, **decode,
            "prefill": prefill, "decode_fp32": decode_f32}, launches


def paged_problem(torch, dev, B, H, K, hd, P, mb, n_pages, pos, q_dtype,
                  kv_dtype, seed, perm=True):
    """q [B, H, hd], arenas [n_pages + 1, P, K, hd], a table whose pages
    are a random permutation (or, with ``perm`` False, random ids as in
    the reference suite's arena_problem) and whose last column is the
    trash page, and the cursors ``pos``."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, H, hd, generator=g, device=dev).to(q_dtype)
    ak, av = (torch.randn(n_pages + 1, P, K, hd, generator=g, device=dev)
              .to(kv_dtype) for _ in range(2))
    pages = torch.randperm(n_pages, generator=g, device=dev)[:B * mb] \
        .reshape(B, mb) if perm else \
        torch.randint(0, n_pages, (B, mb), generator=g, device=dev)
    table = torch.cat([pages, torch.full((B, 1), n_pages, device=dev)],
                      1).int()
    return q, ak, av, table, torch.tensor(pos, dtype=torch.int32,
                                          device=dev)


def attended_slots(torch, arena, table, pos, window):
    """[n_pages + 1, P] bool: the arena slots some row attends to (its
    columns max(0, pos - window + 1) .. min(pos, mb P - 1)); and the
    number of (row, column) pairs, the columns the work needs."""
    P, mb = arena.shape[1], table.shape[1] - 1
    need = torch.zeros(arena.shape[:2], dtype=torch.bool,
                       device=table.device)
    n_cols = 0
    for r, p in enumerate(pos.tolist()):
        lo = max(0, p - window + 1) if window else 0
        cols = torch.arange(lo, min(p, mb * P - 1) + 1, device=table.device)
        need[table[r, cols // P].long(), cols % P] = True
        n_cols += cols.numel()
    return need, n_cols


def check_paged_attention(torch, dev):
    """B5 against ``paged_attention_plain`` at the reference suite's
    arena_problem, the engine's shape and a 2048-token context; windows
    0, 6 and 100; then its time at the 2048-token shape.  Returns the
    JSON record."""
    from repro_torch.kernels import build
    from repro_torch.kernels.paged_attention import paged_attention_cuda, \
        paged_attention_plain, split_plan

    bf16, f32 = torch.bfloat16, torch.float32
    # the split kernel's edges at its own span on this card: contexts of
    # span - 1, span and span + 1 columns and the same around two spans,
    # the last column and the clamp (tests/test_torch_cuda.py's
    # test_cuda_paged_attention_split_edges)
    span, n_splits = split_plan(8, 8, 8, 16, build.sm_count(dev))
    require(n_splits > 2, f"the split-edge shape does not split ({span})")
    shapes = {
        "arena_problem": (3, 4, 2, 16, 5, 4, 16, [3, 11, 19], False),
        "arena_problem pos 0": (3, 4, 2, 16, 5, 4, 16, [0, 0, 0], False),
        # 32 slots of prompt 48 + 64 new tokens at page 16; the last row a
        # zombie at the clamp mb * P
        "engine": (32, 32, 8, 128, 16, 7, 224,
                   [48 + 5 * i % 64 for i in range(31)] + [112], True),
        # 16 rows of up to 2048 tokens: ragged cursors with 0, P - 1, P
        # and 2047, and 64 unmapped pages
        "timing": (16, 32, 8, 128, 16, 128, 2112,
                   [0, 15, 16, 2047]
                   + [2047 - 13 * i for i in range(1, 13)], True),
        "split edges": (8, 32, 8, 128, 16, 8, 68,
                        [span - 2, span - 1, span, 2 * span - 2,
                         2 * span - 1, 2 * span, 127, 128], True),
        # head dim 192 (nemotron-4-340b) at the 2048-token shape, and at
        # nemotron's own heads, 96 on 8 kv heads (g = 12)
        "timing hd192": (16, 32, 8, 192, 16, 128, 2112,
                         [0, 15, 16, 2047]
                         + [2047 - 13 * i for i in range(1, 13)], True),
        "nemotron": (4, 96, 8, 192, 16, 8, 40, [0, 17, 64, 128], True),
        # llama4-scout's heads, 40 on 8 kv heads (g = 5), at [16] (a)'s
        # engine: 16 rows of a 256-id prompt and up to 32 new tokens
        "scout": (16, 40, 8, 128, 16, 19, 320,
                  [256 + 2 * i for i in range(15)] + [288], True),
    }
    worst = 0.0
    for name, (*dims, pos, perm) in shapes.items():
        # windows 0, 6 and 100; at the split edges also windows of one
        # span and one more, which empty whole splits below the cursor
        windows = (0, 6, 100) + ((span, span + 1) if name == "split edges"
                                 else ())
        for q_dtype, kv_dtype, tol in ((f32, f32, 2e-5), (bf16, f32, 2e-5),
                                       (f32, bf16, 3e-2), (bf16, bf16, 3e-2)):
            q, ak, av, table, pos_t = paged_problem(torch, dev, *dims, pos,
                                                    q_dtype, kv_dtype, 10,
                                                    perm)
            for window in windows:
                got = paged_attention_cuda(q, ak, av, table, pos_t,
                                           window=window)
                want = paged_attention_plain(q, ak, av, table, pos_t,
                                             window=window)
                require(got.dtype == kv_dtype and got.shape == q.shape,
                        "paged_attention output")
                err = max_err(got, want)
                # poison every slot no row attends to; the kernel must not
                # read one: it equals the plain version on the zeroed arena
                need, _ = attended_slots(torch, ak, table, pos_t, window)
                poisoned, zeroed = [], []
                for a in (ak, av):
                    pa, za = a.clone(), a.clone()
                    pa[~need] = float("nan")
                    za[~need] = 0.0
                    poisoned.append(pa)
                    zeroed.append(za)
                got_p = paged_attention_cuda(q, *poisoned, table, pos_t,
                                             window=window)
                err_p = max_err(got_p, paged_attention_plain(
                    q, *zeroed, table, pos_t, window=window))
                counts = build.scratch("paged_attention counters", q.device,
                                       1, torch.int32)
                require(int(counts.abs().sum().item()) == 0,
                        "paged_attention left a merge counter set")
                require(err <= tol and err_p <= tol,
                        f"paged_attention {name} q {q_dtype} arena "
                        f"{kv_dtype} window {window}: error {err:.3e}, "
                        f"on the poisoned arena {err_p:.3e}")
                if kv_dtype == f32:
                    worst = max(worst, err, err_p)
                log(f"  paged_attention {name} {dims[:7]} q "
                    f"{str(q_dtype)[6:]} arena {str(kv_dtype)[6:]} window "
                    f"{window}: max|do| {err:.3e}, {err_p:.3e} with unread "
                    f"slots NaN (tolerance {tol:g})")
            del q, ak, av, poisoned, zeroed

    def timed(name, kv_dtype, window=0):
        *dims, pos, perm = shapes[name]
        q, ak, av, table, pos_t = paged_problem(torch, dev, *dims, pos, bf16,
                                                kv_dtype, 11, perm)

        def run():
            return paged_attention_cuda(q, ak, av, table, pos_t,
                                        window=window)
        B, H, K, hd = dims[0], dims[1], dims[2], dims[3]
        _, n_cols = attended_slots(torch, ak, table, pos_t, window)
        esize = ak.element_size()
        n_bytes = (2 * n_cols * K * hd * esize + q.numel() * 2
                   + B * H * hd * esize + table.numel() * 4 + B * 4)
        flops = 4 * n_cols * H * hd          # q.k and p v, every head
        b_ms, b_by = bound(n_bytes, flops, FP32_FLOPS)
        rec = {"ms": cuda_ms(torch, run, 50),
               "kernel_only_ms": kernel_only_ms(torch, run, 20,
                                                "paged_attention_kernel"),
               "plain_ms": cuda_ms(torch, lambda: paged_attention_plain(
                   q, ak, av, table, pos_t, window=window), 5),
               "bound_ms": b_ms, "bound_by": b_by, "bytes": n_bytes}
        ko = rec["kernel_only_ms"]
        was = EARLIER_PAGED.get((name, str(kv_dtype)[6:], window))
        log(f"  time paged_attention {name} arena {str(kv_dtype)[6:]} "
            f"window {window}: {rec['ms']:.4f} ms per call ("
            + ("not measured" if ko is None else f"{ko:.4f} ms")
            + " in the kernel"
            + (f"; before the redesign {was[0]} ({was[1]})" if was else "")
            + f"), plain {rec['plain_ms']:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}: {n_bytes / 1e6:.1f} MB)")
        return rec

    main = timed("timing", f32)
    timed("timing", bf16)
    timed("timing", f32, window=100)
    hd192 = timed("timing hd192", f32)
    timed("timing hd192", bf16)
    engine = timed("engine", f32)
    timed("engine", bf16)
    scout = timed("scout", f32)
    return {"name": "paged_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
            "replaces": "src/repro/kernels/paged_attention.py:72",
            "launches": 0, "max_abs_err": worst, "ms": main["ms"],
            "kernel_only_ms": main["kernel_only_ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": None,
            "shape": list(shapes["timing"][:7]),
            "dtype": "bfloat16 q, float32 arena",
            "engine": {k: engine[k] for k in ("ms", "kernel_only_ms",
                                             "plain_ms", "bound_ms")},
            "hd192": {k: hd192[k] for k in ("ms", "kernel_only_ms",
                                            "plain_ms", "bound_ms")},
            "scout": {k: scout[k] for k in ("ms", "kernel_only_ms",
                                            "plain_ms", "bound_ms")}}


def _pipeline_step(torch, gen, ref, rew):
    """One generator -> reference -> reward step through the ports, as the
    controller wires them.  Returns (reward output, timings in s)."""
    t0 = time.perf_counter()
    comp = gen.step()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    ref.put_input("completions", comp)
    ref.step()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    rew.put_input("completions_with_ref",
                  ref.get_output("completions_with_ref"))
    rew.step()
    t3 = time.perf_counter()
    return rew.get_output("completions_with_reward"), (t1 - t0, t2 - t1,
                                                       t3 - t2)


def _check_outputs(torch, out, V):
    """Tokens in [0, V); log-probs finite and <= 0; returns |mu - ref| at
    the action positions."""
    tokens, mask = out["tokens"], out["mask"] > 0
    require(tokens.min().item() >= 0 and tokens.max().item() < V,
            "tokens outside [0, V)")
    blp, rlp = out["behavior_logp"], out["ref_logp"]
    require(torch.isfinite(blp).all().item()
            and (blp[mask] <= 0).all().item(), "behaviour log-probs")
    require(torch.isfinite(rlp).all().item()
            and (rlp[:, 1:] <= 0).all().item(), "reference log-probs")
    require(mask.any().item(), "no action positions")
    return (blp - rlp)[mask].abs()


def phase_serve(torch, dev):
    """Two full-width steps; returns (params, cfg, launch counts)."""
    from repro_torch.configs.llama_paper import LLAMA31_8B
    from repro_torch.core.executor import GeneratorExecutor, \
        RefPolicyExecutor, RewardExecutor
    from repro_torch.kernels import build
    from repro_torch.models import init_params
    from repro_torch.rl.data import ArithmeticTasks

    cfg = LLAMA31_8B
    log(f"[3] serve {cfg.name} at full width ({cfg.n_layers} layers, bf16)")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in leaves(params))
    # init draws each stacked weight in fp32 before the cast to bf16
    log(f"  init: {n / 1e9:.3f} B params, {2 * n / 1e9:.2f} GB, "
        f"{time.perf_counter() - t0:.1f} s, peak memory allocated "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    torch.cuda.reset_peak_memory_stats()
    n_prompts, n_per, max_new, chunk = N_PROMPTS, N_PER, MAX_NEW, CHUNK
    B = n_prompts * n_per
    gen = GeneratorExecutor(cfg, ArithmeticTasks(seed=0),
                            n_prompts=n_prompts, n_per_prompt=n_per,
                            max_new=max_new, chunk=chunk, temperature=1.0,
                            seed=0, device=dev)
    gen.set_weights(params, version=0)
    ref = RefPolicyExecutor(cfg)
    ref.set_weights(params)
    rew = RewardExecutor(n_per_prompt=n_per, leave_one_out=True)

    build.reset_launches()          # the main path's run starts here
    outs = []
    for step in range(2):
        out, (t_gen, t_ref, t_rew) = _pipeline_step(torch, gen, ref, rew)
        outs.append(out)
        log(f"  step {step}: generator {t_gen:.3f} s ({B * max_new / t_gen:.1f}"
            f" generated tokens/s, {B} rows x {max_new}), reference "
            f"{t_ref * 1e3:.1f} ms, reward {t_rew * 1e3:.1f} ms, "
            f"mean_reward {out['mean_reward']:.3f}")
    launches = dict(build.LAUNCHES)  # ... and ends here
    log(f"  launches over the two steps: {launches}")
    want = {"fused_sample": 2 * max_new,
            "flash_attention": 2 * cfg.n_layers + 2 * cfg.n_layers,
            "fused_logprob": 2}
    require(launches == want, f"launch counts {launches}, want {want}")
    for out in outs:
        d = _check_outputs(torch, out, cfg.vocab)
        log(f"  |behavior_logp - ref_logp| at {d.numel()} actions (bf16, "
            f"T=1): mean {d.mean().item():.4f}, max {d.max().item():.4f}")
    log(f"  peak memory allocated over the two steps: "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

    # prefill and decode apart, then PROFILED_STEPS profiled decode steps
    t0 = time.perf_counter()
    job, state = gen.begin_batch()
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    state = gen.advance_chunk(job, state)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3 / chunk
    log(f"  prefill [{B}, {state.prompt_len}]: {prefill_ms:.1f} ms; decode "
        f"{decode_ms:.2f} ms per token (batch {B})")
    busy_share(torch, lambda: profiled_decode(
        torch, lambda _, steps: steps(), params, cfg, state.cache,
        state.tokens[:, -1:]), PROFILED_STEPS, decode_ms)
    del gen, ref, job, state, outs
    return params, cfg, launches


def device_profile(torch, fn):
    """Device time of one profiled call of ``fn`` (ms, summed over the
    device operations) and its device operations, largest first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev_ops = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in dev_ops) / 1e3
    return busy, sorted(dev_ops, key=lambda e: -e.self_device_time_total)


def busy_share(torch, fn, n_tokens: int, wall_ms_per_token: float) -> None:
    """Device-busy share of ``n_tokens`` profiled decode steps, and their
    top device operations."""
    busy, ops = device_profile(torch, fn)
    busy /= n_tokens
    log(f"  {n_tokens} profiled decode steps: device busy {busy:.2f} ms "
        f"per token = "
        f"{100 * busy / wall_ms_per_token:.1f}% of the unprofiled "
        f"{wall_ms_per_token:.2f} ms; top device operations (ms per token): "
        + ", ".join(f"{e.key[:48]} {e.self_device_time_total / 1e3 / n_tokens:.3f}"
                    for e in ops[:6]))


def phase_long(torch, dev, params, cfg) -> None:
    import numpy as np

    from repro_torch.kernels import build
    from repro_torch.rl import prng
    from repro_torch.rl.rollout import rollout_chunk, start_rollout

    log("[4] long prompts: 4 x 2048 ids, prefill and one 16-step chunk")
    ids = np.random.default_rng(0).integers(0, cfg.vocab, (4, 2048))
    prompts = torch.as_tensor(ids, dtype=torch.int32, device=dev)
    build.reset_launches()
    t0 = time.perf_counter()
    state = start_rollout(params, cfg, prompts, 2048 + 16)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    state = rollout_chunk(params, cfg, state, prng.split(prng.PRNGKey(1))[1],
                          n_steps=16, temperature=1.0)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = dict(build.LAUNCHES)
    require(launches.get("flash_attention") == cfg.n_layers
            and launches.get("fused_sample") == 16, f"launches {launches}")
    gen_toks = state.tokens[:, 2048:]
    require(gen_toks.min().item() >= 0 and gen_toks.max().item() < cfg.vocab
            and torch.isfinite(state.behavior_logp).all().item(),
            "long-prompt outputs")
    log(f"  prefill [4, 2048]: {(t1 - t0) * 1e3:.1f} ms; decode "
        f"{(t2 - t1) * 1e3 / 16:.2f} ms per token (batch 4, cache 2064); "
        f"launches {launches}")


class timed_decode:
    """Within the block, the engine's ``rollout_rows_chunk`` is timed on
    the host clock between synchronizes, call by call; the call numbered
    ``profile_call`` runs under the profiler instead and its device time
    is kept.  Nothing in the port has such a hook."""

    def __init__(self, torch, engine_mod, profile_call=None):
        self.torch, self.mod, self.profile_call = torch, engine_mod, \
            profile_call
        self.wall, self.profiled = [], None

    def __enter__(self):
        self.real = self.mod.rollout_rows_chunk

        def run(*args, **kwargs):
            torch = self.torch
            if self.rounds == self.profile_call:
                box = []
                self.profiled = device_profile(
                    torch, lambda: box.append(self.real(*args, **kwargs)))
                return box[0]
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = self.real(*args, **kwargs)
            torch.cuda.synchronize()
            self.wall.append(time.perf_counter() - t)
            return out
        self.mod.rollout_rows_chunk = run
        return self

    def __exit__(self, *exc):
        self.mod.rollout_rows_chunk = self.real

    @property
    def rounds(self) -> int:
        return len(self.wall) + (self.profiled is not None)


def run_engine(torch, dev, params, cfg, layout, profile_call=None):
    """ENGINE_BATCHES batches through the generator's engine hooks, as a
    caller drives them.  Returns (emitted batches, engine stats, the
    decode timer, the launch counts of the rounds, the generator)."""
    from repro_torch.core.executor import GeneratorExecutor
    from repro_torch.kernels import build
    from repro_torch.rl import engine as engine_mod
    from repro_torch.rl.data import ArithmeticTasks

    gen = GeneratorExecutor(cfg, ArithmeticTasks(prompt_len=ENGINE_PROMPT,
                                                 seed=0),
                            n_prompts=N_PROMPTS, n_per_prompt=N_PER,
                            max_new=MAX_NEW, chunk=CHUNK, temperature=1.0,
                            seed=0, device=dev)
    gen.set_weights(params, version=0)
    gen.engine_configure(kv_layout=layout, kv_page_size=ENGINE_PAGE,
                         row_budgets=ENGINE_BUDGETS)
    for b in range(ENGINE_BATCHES):
        gen.engine_enqueue(b, bound=0)
    items = []
    with timed_decode(torch, engine_mod, profile_call) as timer:
        build.reset_launches()          # the engine path's run starts here
        for _ in range(50):
            items += gen.engine_round(["completions"])
            if len(items) == ENGINE_BATCHES:
                break
        torch.cuda.synchronize()
        launches = dict(build.LAUNCHES)  # ... and ends here
    require(len(items) == ENGINE_BATCHES,
            f"{layout} engine emitted {len(items)} of {ENGINE_BATCHES}")
    outs = [it["snapshot"]["completions"] for it in items]
    return outs, gen.engine_stats(), timer, launches, gen


def score_engine(torch, cfg, params, outs):
    """The emitted batches through RefPolicyExecutor and RewardExecutor;
    returns |mu - ref| at every action position."""
    from repro_torch.core.executor import RefPolicyExecutor, RewardExecutor
    ref = RefPolicyExecutor(cfg)
    ref.set_weights(params)
    rew = RewardExecutor(n_per_prompt=N_PER)
    diffs = []
    for out in outs:
        ref.put_input("completions", out)
        scored = ref.step()
        rew.put_input("completions_with_ref", scored)
        adv = rew.step()["advantages"]
        want = torch.as_tensor(out["group_advantages"], device=adv.device)
        require(torch.equal(adv, want.float()[:, None] * out["mask"]),
                "reward advantages differ from the engine's group ones")
        diffs.append(_check_outputs(torch, scored, cfg.vocab))
    return torch.cat(diffs)


def phase_engine(torch, dev, params, cfg):
    """The continuous-batching engine, paged layout, at full depth; then
    the same engine at 2 layers in fp32 against the reference, and the
    dense layout's decode time on the same work.  Returns the launch
    counts of the paged engine's rounds."""
    from repro_torch.configs.llama_paper import LLAMA31_8B
    from repro_torch.models import init_params

    log(f"[8] engine: {cfg.name} at full width ({cfg.n_layers} layers, "
        f"bf16), kv_layout paged, page {ENGINE_PAGE}; {ENGINE_BATCHES} "
        f"batches of {N_PROMPTS} prompts x {N_PER} samples, prompts of "
        f"{ENGINE_PROMPT}, {MAX_NEW} new tokens in chunks of {CHUNK}, row "
        f"budgets {ENGINE_BUDGETS} chunks, a pool of "
        f"{2 * N_PROMPTS * N_PER} rows")
    t0 = time.perf_counter()
    outs, st, timer, launches, gen = run_engine(torch, dev, params, cfg,
                                                "paged", profile_call=2)
    wall = time.perf_counter() - t0
    rounds = timer.rounds
    want = {"paged_attention": cfg.n_layers * CHUNK * rounds,
            "fused_sample": CHUNK * rounds,
            "flash_attention": cfg.n_layers * st["radix_misses"]}
    log(f"  {rounds} decode rounds in {wall:.2f} s; launches {launches}; "
        f"stats: admitted {st['rows_admitted']}, harvested "
        f"{st['rows_harvested']}, radix hits {st['radix_hits']} / misses "
        f"{st['radix_misses']} ({st['prefix_tokens_reused']} prompt tokens "
        f"reused), backpressure {st['admission_backpressure']}, staleness "
        f"violations {st['staleness_violations']}, pages in use "
        f"{st['pages_in_use']} of {st['pages_total']} (radix nodes "
        f"{st['radix_nodes']})")
    require(launches == want, f"engine launch counts {launches}, want {want}"
            " (per decode round: paged_attention n_layers x chunk, "
            "fused_sample chunk; per radix miss: flash_attention n_layers)")
    require(st["radix_hits"] > 0, "no radix hit")
    require(st["staleness_violations"] == 0, "staleness violations")
    require(st["rows_harvested"] == ENGINE_BATCHES * N_PROMPTS * N_PER
            and st["running"] == 0 and st["waiting"] == 0, "rows left")
    require(st["pages_in_use"] == st["radix_nodes"],
            "pages held past harvest besides the radix tree's")
    gen.engine_abort()              # drops the radix; asserts no page leak
    require(gen._engine.page_pool.pages_in_use == 0, "page leak")
    per_tok = [w / CHUNK * 1e3 for w in timer.wall]
    decode_ms = statistics.median(per_tok)
    busy, ops = timer.profiled
    busy /= CHUNK
    log(f"  decode {decode_ms:.2f} ms per token (median of {len(per_tok)} "
        f"unprofiled rounds, {min(per_tok):.2f}..{max(per_tok):.2f}; "
        f"{2 * N_PROMPTS * N_PER} rows a step); profiled round: device "
        f"busy {busy:.2f} ms per token = {100 * busy / decode_ms:.1f}%; top "
        "device operations (ms per token): "
        + ", ".join(f"{e.key[:48]} {e.self_device_time_total / 1e3 / CHUNK:.3f}"
                    for e in ops[:6]))
    d = score_engine(torch, cfg, params, outs)
    log(f"  emitted batches scored by RefPolicyExecutor and RewardExecutor: "
        f"|behavior_logp - ref_logp| at {d.numel()} actions (bf16, T=1): "
        f"mean {d.mean().item():.4f}, max {d.max().item():.4f}")
    del gen, outs

    _, _, dense_timer, _, gen = run_engine(torch, dev, params, cfg, "dense")
    dense_ms = statistics.median(w / CHUNK * 1e3 for w in dense_timer.wall)
    log(f"  dense layout on the same work: decode {dense_ms:.2f} ms per "
        f"token ({dense_timer.rounds} rounds) beside paged {decode_ms:.2f} "
        "ms")
    gen.engine_abort()
    del gen
    gc.collect()
    torch.cuda.empty_cache()

    cfg2 = LLAMA31_8B.replace(name="llama31-8b-2l", n_layers=2)
    p2 = init_params(cfg2, seed=1, dtype=torch.float32, device=dev)
    outs, st, _, _, gen = run_engine(torch, dev, p2, cfg2, "paged")
    d = score_engine(torch, cfg2, p2, outs)
    log(f"  fp32 2-layer engine (radix hits {st['radix_hits']}): "
        f"|behavior_logp - ref_logp| at {d.numel()} actions: mean "
        f"{d.mean().item():.2e}, max {d.max().item():.2e} (tolerance 1e-3)")
    require(d.max().item() <= 1e-3, "fp32 engine mu vs reference")
    gen.engine_abort()
    del gen, p2, outs
    # a generator and its engine refer to each other: only the cycle
    # collector frees the generator's params and the engine's pool
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_fp32(torch, dev) -> None:
    from repro_torch.configs.llama_paper import LLAMA31_8B
    from repro_torch.core.executor import GeneratorExecutor, \
        RefPolicyExecutor, RewardExecutor
    from repro_torch.models import init_params
    from repro_torch.rl.data import ArithmeticTasks

    log("[5] fp32 consistency at llama31-8b widths, 2 layers")
    cfg = LLAMA31_8B.replace(name="llama31-8b-2l", n_layers=2)
    params = init_params(cfg, seed=1, dtype=torch.float32, device=dev)
    gen = GeneratorExecutor(cfg, ArithmeticTasks(seed=1), n_prompts=4,
                            n_per_prompt=4, max_new=16, chunk=16,
                            temperature=1.0, seed=1, device=dev)
    gen.set_weights(params, version=0)
    ref = RefPolicyExecutor(cfg)
    ref.set_weights(params)
    rew = RewardExecutor(n_per_prompt=4, leave_one_out=True)
    out, _ = _pipeline_step(torch, gen, ref, rew)
    d = _check_outputs(torch, out, cfg.vocab)
    log(f"  fp32 2-layer: |behavior_logp - ref_logp| at {d.numel()} "
        f"actions: mean {d.mean().item():.2e}, max {d.max().item():.2e} "
        f"(tolerance 1e-3)")
    require(d.max().item() <= 1e-3, "fp32 behaviour vs reference log-probs")


def fingerprint(torch, params):
    """fp64 sums of every 16th element of each leaf: an optimizer step
    changes nearly every element, so a step shows in them."""
    return [x.reshape(-1)[::16].double().sum().item() for x in leaves(params)]


def phase_train(torch, dev):
    """Three async-schedule steps at full width, 8 layers; returns the
    launch counts of the run."""
    import collections

    from repro_torch.configs.llama_paper import LLAMA31_8B
    from repro_torch.core.channels import CommType, CommunicationChannel, \
        WeightsCommunicationChannel
    from repro_torch.core.controller import SyncExecutorController
    from repro_torch.core.executor import GeneratorExecutor, \
        RefPolicyExecutor, RewardExecutor, TrainerExecutor
    from repro_torch.kernels import build
    from repro_torch.models import init_params
    from repro_torch.rl.data import ArithmeticTasks

    cfg = LLAMA31_8B.replace(name=f"llama31-8b-{TRAIN_LAYERS}l",
                             n_layers=TRAIN_LAYERS)
    n_steps = 3
    log(f"[6] train {cfg.name}: published widths, {cfg.n_layers} of 32 "
        f"layers, bf16 params, fp32 Adam; {n_steps} steps of the async "
        f"schedule, staleness 1; KL {KL_COEF} to a frozen reference")
    torch.cuda.reset_peak_memory_stats()
    gen = GeneratorExecutor(cfg, ArithmeticTasks(seed=0),
                            n_prompts=N_PROMPTS, n_per_prompt=N_PER,
                            max_new=MAX_NEW, chunk=CHUNK, temperature=1.0,
                            seed=0, device=dev)
    ref = RefPolicyExecutor(cfg)
    ref.set_weights(init_params(cfg, seed=1, dtype=torch.bfloat16,
                                device=dev))
    rew = RewardExecutor(n_per_prompt=N_PER, leave_one_out=True)
    trn = TrainerExecutor(cfg, dtype=torch.bfloat16, kl_coef=KL_COEF,
                          seed=0, device=dev)
    ctl = SyncExecutorController(
        [gen, ref, rew, trn],
        [WeightsCommunicationChannel("policy_model", trn, gen),
         CommunicationChannel("completions", gen, ref, CommType.BROADCAST),
         CommunicationChannel("completions_with_ref", ref, rew,
                              CommType.GATHER),
         CommunicationChannel("completions_with_reward", rew, trn,
                              CommType.SCATTER)],
        max_steps=n_steps, mode="async", staleness=1)
    t0 = time.perf_counter()
    ctl.init()
    torch.cuda.synchronize()
    n = sum(t.numel() for t in leaves(trn.get_model()))
    log(f"  init: {n / 1e9:.3f} B params, trainer state "
        f"{12 * n / 1e9:.1f} GB (bf16 params + grads, fp32 m + v), "
        f"{time.perf_counter() - t0:.1f} s")
    fp_init = fingerprint(torch, trn.get_model())

    times = collections.defaultdict(dict)
    seen = {}

    def timed(key, fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            times[key][ctl._tick] = time.perf_counter() - t
            return out
        return run

    def sync_and_look(tick):
        sync(tick)
        if tick == n_steps - 1:
            # the generator now holds version tick - 1, the trainer tick
            seen["gen"] = fingerprint(torch, gen.params)
            seen["trainer"] = fingerprint(torch, trn.get_model())
    gen.step = timed("generate", gen.step)
    trn.step = timed("train", trn.step)
    sync = timed("sync", ctl._sync_weights)
    ctl._sync_weights = sync_and_look

    build.reset_launches()          # the train path's run starts here
    history = ctl.run()
    launches = dict(build.LAUNCHES)  # ... and ends here
    for h in history:
        st = h["step"]
        sync_ms = times["sync"].get(st)
        log(f"  step {st}: generator {times['generate'][st]:.3f} s, trainer "
            f"step {times['train'][st] * 1e3:.1f} ms, weight sync "
            + ("none (step 0)" if sync_ms is None else f"{sync_ms * 1e3:.3f} ms")
            + f", loss {h['loss']:.5f}, grad_norm {h['grad_norm']:.4f}, "
            f"mean_ratio {h['mean_ratio']:.4f}, weight_version "
            f"{h['weight_version']}, mean_reward {h['mean_reward']:.3f}")
        require(h["weight_version"] == max(0, st - 1),
                f"step {st}: weight_version {h['weight_version']}")
        require(all(math.isfinite(h[k]) for k in ("loss", "grad_norm")),
                f"step {st}: loss or grad_norm not finite")
    require(fingerprint(torch, trn.get_model()) != fp_init,
            "the params did not move")
    require(seen["gen"] != seen["trainer"],
            f"the generator's version {n_steps - 2} equals the trainer's "
            f"version {n_steps - 1}")
    require(fingerprint(torch, gen.params) == seen["gen"],
            "a trainer step changed the generator's snapshot")
    log(f"  launches over the {n_steps} steps: {launches}")
    want = {"fused_sample": n_steps * MAX_NEW,
            "flash_attention": n_steps * 3 * cfg.n_layers,
            "fused_logprob": 2 * n_steps, "fused_logprob_bwd": n_steps}
    require(launches == want, f"launch counts {launches}, want {want} (per "
            "train step: fused_logprob 1, fused_logprob_bwd 1, "
            "flash_attention n_layers; per generator step: fused_sample "
            "max_new, flash_attention n_layers; per reference step: "
            "fused_logprob 1, flash_attention n_layers)")
    log(f"  weight versions {[h['weight_version'] for h in history]}; the "
        f"generator's version {n_steps - 2} differs from the trainer's "
        f"version {n_steps - 1} and stayed as it was through step "
        f"{n_steps - 1}; peak memory allocated "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

    # the first step also pays the backward's first-call set-up; the
    # last one is the steady state
    train_ms = times["train"][n_steps - 1] * 1e3
    busy, ops = device_profile(torch, trn.step)
    log(f"  profiled train step: device busy {busy:.1f} ms = "
        f"{100 * busy / train_ms:.1f}% of the unprofiled step {n_steps - 1} "
        f"({train_ms:.1f} ms); top device operations (ms): "
        + ", ".join(f"{e.key.replace('void at::native::', '')[:110]} "
                    f"{e.self_device_time_total / 1e3:.2f}"
                    for e in ops[:8]))
    del ctl, gen, ref, rew, trn
    return launches


class plain_kernels:
    """Within the block, the dispatch layer's log-prob and attention are
    the plain versions under plain autograd (the card's reference for the
    train step); nothing in the port has such a switch."""

    def __init__(self, dispatch, token_logprob, attention):
        self.dispatch = dispatch
        self.plain = (token_logprob, attention)

    def __enter__(self):
        self.saved = (self.dispatch.token_logprob, self.dispatch.attention)
        self.dispatch.token_logprob, self.dispatch.attention = self.plain

    def __exit__(self, *exc):
        self.dispatch.token_logprob, self.dispatch.attention = self.saved


def phase_train_numerics(torch, dev):
    """[7].  Returns its batch, on the host, for [22]."""
    from repro_torch.configs.llama_paper import LLAMA31_8B
    from repro_torch.core.executor import GeneratorExecutor, \
        RefPolicyExecutor, RewardExecutor
    from repro_torch.kernels import build, dispatch
    from repro_torch.kernels.flash_attention import chunked_attention
    from repro_torch.kernels.fused_logprob import fused_logprob_plain
    from repro_torch.models import init_params
    from repro_torch.rl.data import ArithmeticTasks
    from repro_torch.train.optimizer import adam_init, global_norm
    from repro_torch.train.trainstep import TrainState, make_loss_fn, \
        make_train_step, value_and_grad

    log("[7] train numerics at llama31-8b widths, 2 layers, fp32: kernels "
        "against plain versions under autograd")
    cfg = LLAMA31_8B.replace(name="llama31-8b-2l", n_layers=2)
    params = init_params(cfg, seed=2, dtype=torch.float32, device=dev)
    gen = GeneratorExecutor(cfg, ArithmeticTasks(seed=2), n_prompts=4,
                            n_per_prompt=4, max_new=16, chunk=16,
                            temperature=1.0, seed=2, device=dev)
    gen.set_weights(params, version=0)
    ref = RefPolicyExecutor(cfg)
    ref.set_weights(init_params(cfg, seed=3, dtype=torch.float32,
                                device=dev))
    rew = RewardExecutor(n_per_prompt=4, leave_one_out=True)
    ref.put_input("completions", gen.step())
    rew.put_input("completions_with_ref", ref.step())
    scored = rew.step()
    batch = {k: scored[k] for k in ("tokens", "behavior_logp", "advantages",
                                    "mask", "ref_logp")}
    del gen, ref

    def plain_logprob(logits, tokens, n_valid=None):
        if n_valid is not None:
            logits = logits[:, :n_valid]
        return fused_logprob_plain(logits.reshape(-1, logits.shape[-1]),
                                   tokens.reshape(-1))[0].reshape(
                                       tokens.shape)
    plain = plain_kernels(dispatch, plain_logprob, chunked_attention)

    loss_fn = make_loss_fn(cfg, kl_coef=KL_COEF)
    build.reset_launches()
    (loss_k, _), g_k = value_and_grad(loss_fn, params, batch)
    launches = dict(build.LAUNCHES)
    with plain:
        (loss_p, _), g_p = value_and_grad(loss_fn, params, batch)
    require(launches == {"fused_logprob": 1, "fused_logprob_bwd": 1,
                         "flash_attention": cfg.n_layers},
            f"kernel-path launches {launches}")
    gn_k, gn_p = global_norm(g_k).item(), global_norm(g_p).item()
    g_rel = max((a - b).abs().max().item() / b.abs().max().clamp(
        min=1e-30).item() for a, b in zip(leaves(g_k), leaves(g_p)))
    del g_k, g_p
    torch.cuda.empty_cache()

    new = {}
    metrics = {}
    for path in ("kernels", "plain"):
        state = TrainState(params, adam_init(params))
        step = make_train_step(cfg, kl_coef=KL_COEF)   # the paper's lr
        if path == "plain":
            with plain:
                out, metrics[path] = step(state, batch)
        else:
            out, metrics[path] = step(state, batch)
        new[path] = out.params
        del state, out
        torch.cuda.empty_cache()
    p_max = max(x.abs().max().item() for x in leaves(params))
    dp = max((a - b).abs().max().item() for a, b in
             zip(leaves(new["kernels"]), leaves(new["plain"])))
    moved = max((a - b).abs().max().item() for a, b in
                zip(leaves(new["kernels"]), leaves(params)))
    rel = {
        "loss": abs(loss_k.item() - loss_p.item()) / abs(loss_p.item()),
        "grad_norm": abs(gn_k - gn_p) / gn_p,
        "max|dgrad| / max|grad| (worst leaf)": g_rel,
        "step loss": abs(float(metrics["kernels"]["loss"])
                         - float(metrics["plain"]["loss"]))
        / abs(float(metrics["plain"]["loss"])),
        "step grad_norm": abs(float(metrics["kernels"]["grad_norm"])
                              - float(metrics["plain"]["grad_norm"]))
        / float(metrics["plain"]["grad_norm"]),
        "max|dparam| / max|param|": dp / p_max,
    }
    log(f"  loss {loss_k.item():.7f} vs {loss_p.item():.7f}, grad_norm "
        f"{gn_k:.6f} vs {gn_p:.6f}, mean_reward {scored['mean_reward']:.3f}; "
        f"the step moved params by up to {moved:.3e}")
    log("  relative differences (tolerance 1e-4): "
        + ", ".join(f"{k} {v:.2e}" for k, v in rel.items()))
    for k, v in rel.items():
        require(v <= 1e-4, f"train numerics: {k} {v:.3e} > 1e-4")
    return {k: v.cpu() for k, v in batch.items()}


class KernelCalls:
    """Records the calls a main path makes to the kernel wrappers that
    ``dispatch`` routes to -- copies of their inputs and outputs, from
    whichever thread -- so that ``replay`` can hold each recorded call
    against its plain version afterwards.  The wrappers count their own
    launches; recording adds none.  ``per_shape`` keeps only the first
    calls of each (wrapper, shapes, dtypes); None keeps every call.
    ``names`` are the wrappers recorded: the dense paths' four, or with
    ``ENGINE`` the paged decode's too.  With ``host`` the copies wait in
    host memory and go back to the card one call at a time in ``replay``
    (a path that leaves no room on the card for them)."""

    NAMES = ("fused_sample_cuda", "fused_logprob_cuda",
             "fused_logprob_bwd_cuda", "flash_attention_cuda")
    ENGINE = NAMES + ("paged_attention_cuda",)

    def __init__(self, torch, per_shape=None, names=NAMES, host=False):
        import threading
        self.torch, self.per_shape, self.names = torch, per_shape, names
        self.host, self.device = host, None
        self.calls = {n: [] for n in names}
        self._seen = collections.Counter()
        self._lock = threading.Lock()

    def _copy(self, x):
        if isinstance(x, self.torch.Tensor):
            if not self.host:
                return x.detach().clone()
            self.device = x.device
            return x.detach().to("cpu", copy=True)
        if isinstance(x, tuple):
            return tuple(self._copy(t) for t in x)
        return x

    def _back(self, x):
        if isinstance(x, self.torch.Tensor):
            return x.to(self.device)
        if isinstance(x, tuple):
            return tuple(self._back(t) for t in x)
        return x

    def _iter(self, name):
        """The recorded calls of ``name``, on the card."""
        for args, kw, out in self.calls.get(name, ()):
            if self.host:
                args, out = self._back(args), self._back(out)
            yield args, kw, out

    def _wrap(self, name, fn):
        def recorded(*args, **kwargs):
            out = fn(*args, **kwargs)
            sig = (name,) + tuple((tuple(a.shape), a.dtype) for a in args
                                  if isinstance(a, self.torch.Tensor)) \
                + tuple(sorted(kwargs.items()))
            with self._lock:
                self._seen[sig] += 1
                keep = self.per_shape is None or \
                    self._seen[sig] <= self.per_shape
            if keep:
                self.calls[name].append(
                    (self._copy(args), dict(kwargs), self._copy(out)))
            return out
        return recorded

    def __enter__(self):
        from repro_torch.kernels import dispatch
        self._saved = {n: getattr(dispatch, n) for n in self.names}
        for n, fn in self._saved.items():
            setattr(dispatch, n, self._wrap(n, fn))
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import dispatch
        for n, fn in self._saved.items():
            setattr(dispatch, n, fn)
        return False

    def replay(self, label: str, expect=None) -> list:
        """Every recorded call against its plain version on the same
        inputs, at phase [2]'s tolerances for the dtype: B3 tokens equal
        and log-probs within 1e-5 (fp32) or 1e-4 (bf16); B1 log-probs
        within 1e-5 / 1e-4 and m equal; B2 every element within 1e-6 /
        2^-7 relative of the plain gradient (bwd_excess), zero past
        n_valid; B4 |do| / max(1, |o|) within 1e-5 / 3e-2; B5 max|do|
        within 2e-5 on an fp32 arena, 3e-2 on bf16.  A wrapper in
        ``expect`` (default: every recorded one) must have been called;
        one outside it must not.  Returns the lines to log."""
        torch = self.torch
        from repro_torch.kernels.flash_attention import chunked_attention
        from repro_torch.kernels.fused_logprob import \
            fused_logprob_bwd_plain, fused_logprob_plain
        from repro_torch.kernels.fused_sample import fused_sample_plain
        from repro_torch.kernels.paged_attention import \
            paged_attention_plain

        def fp32(t):
            return t.dtype == torch.float32
        worst = collections.defaultdict(float)
        shapes = collections.defaultdict(set)
        for (x, key, T), _, (tok, lp) in self._iter("fused_sample_cuda"):
            tok_p, lp_p = fused_sample_plain(x, key, T)
            require(torch.equal(tok, tok_p), f"{label}: fused_sample "
                    f"{list(x.shape)} tokens differ from the plain version "
                    f"at rows {(tok != tok_p).nonzero().flatten().tolist()}")
            err = max_err(lp, lp_p)
            require(err <= (1e-5 if fp32(x) else 1e-4),
                    f"{label}: fused_sample log-prob error {err:.3e}")
            worst["fused_sample"] = max(worst["fused_sample"], err)
            shapes["fused_sample"].add((tuple(x.shape), x.dtype))
        for (view, toks), _, (lp, m, s) in self._iter("fused_logprob_cuda"):
            V = view.shape[-1]
            lp_p, m_p, _ = fused_logprob_plain(view.reshape(-1, V),
                                               toks.reshape(-1))
            err = max_err(lp.reshape(-1), lp_p)
            require(err <= (1e-5 if fp32(view) else 1e-4) and torch.equal(
                m.reshape(-1), m_p), f"{label}: fused_logprob "
                f"{list(view.shape)} error {err:.3e} or m differs")
            worst["fused_logprob"] = max(worst["fused_logprob"], err)
            shapes["fused_logprob"].add((tuple(view.shape), view.dtype))
        for args, kw, d in self._iter("fused_logprob_bwd_cuda"):
            base, toks, m, log_s, g = args
            n, V = kw.get("n_valid") or base.shape[1], base.shape[-1]
            d_p = fused_logprob_bwd_plain(
                base[:, :n].reshape(-1, V), toks.reshape(-1), m.reshape(-1),
                log_s.reshape(-1), g.reshape(-1))
            got = d[:, :n].reshape(-1, V)
            excess = bwd_excess(torch, got, d_p, g.reshape(-1),
                                toks.reshape(-1),
                                1e-6 if fp32(base) else 2.0 ** -7)
            require(excess <= 1.0 and bool((d[:, n:] == 0).all().item()),
                    f"{label}: fused_logprob_bwd {list(base.shape)}: an "
                    f"element is {excess:.3g} times its tolerance, or the "
                    "rows past n_valid are not zero")
            worst["fused_logprob_bwd"] = max(worst["fused_logprob_bwd"],
                                             excess)
            shapes["fused_logprob_bwd"].add((tuple(base.shape), base.dtype))
        for (q, k, v), _, o in self._iter("flash_attention_cuda"):
            o_p = chunked_attention(q, k, v)
            err = ((o.float() - o_p.float()).abs()
                   / o_p.float().abs().clamp(min=1.0)).max().item()
            require(err <= (1e-5 if fp32(q) else 3e-2), f"{label}: "
                    f"flash_attention {list(q.shape)} error {err:.3e}")
            worst["flash_attention"] = max(worst["flash_attention"], err)
            shapes["flash_attention"].add((tuple(q.shape), q.dtype))
        for (q, ak, av, table, pos), kw, o in self._iter(
                "paged_attention_cuda"):
            err = max_err(o, paged_attention_plain(
                q, ak, av, table, pos, window=kw.get("window", 0)))
            require(err <= (2e-5 if fp32(ak) else 3e-2), f"{label}: "
                    f"paged_attention q {list(q.shape)} arena "
                    f"{list(ak.shape)} error {err:.3e}")
            worst["paged_attention"] = max(worst["paged_attention"], err)
            shapes["paged_attention"].add(
                (tuple(q.shape) + tuple(ak.shape), ak.dtype))
        expect = set(self.calls if expect is None else expect)
        lines = []
        for n, calls in self.calls.items():
            name = n[:-len("_cuda")]
            require(bool(calls) == (n in expect),
                    f"{label}: {len(calls)} calls of {name} recorded, "
                    f"expected {'some' if n in expect else 'none'}")
            if not calls:
                continue
            what = ("worst element / its tolerance"
                    if name == "fused_logprob_bwd" else
                    "max|do|/max(1,|o|)" if name == "flash_attention"
                    else "max|do|" if name == "paged_attention"
                    else "max|dlogp|")
            lines.append(
                f"  {label}: {len(calls)} recorded {name} calls at "
                + ", ".join(f"{list(s)} {str(t)[6:]}"
                            for s, t in sorted(shapes[name], key=str))
                + f" against the plain version: {what} {worst[name]:.3e}"
                + (", tokens equal" if name == "fused_sample" else ""))
        return lines


class RssPeak:
    """This process's peak resident set since ``reset()``, sampled every
    ``period`` seconds from /proc/self/statm on a thread of its own (the
    chip machine's /proc keeps no VmHWM, and a spawned child's
    ``getrusage`` peak starts from its parent's).  One per process:
    ``RSS``."""

    def __init__(self, period: float = 0.1):
        self.period, self.peak, self._thread = period, 0, None

    @staticmethod
    def now():
        try:
            with open("/proc/self/statm") as f:
                return int(f.read().split()[1]) * PAGE_BYTES
        except (OSError, ValueError, IndexError):
            return None

    def _run(self):
        while True:
            now = self.now()
            if now is None:
                self.peak = None
                return
            if self.peak is not None:
                self.peak = max(self.peak, now)
            time.sleep(self.period)

    def reset(self):
        import threading
        self.peak = self.now()
        if self._thread is None and self.peak is not None:
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name="rss")
            self._thread.start()

    def gb(self):
        """The peak since the reset in GB; None where /proc has no
        statm."""
        return self.peak / 1e9 if self.peak else None


PAGE_BYTES = os.sysconf("SC_PAGE_SIZE")
RSS = RssPeak()


class DeviceTimeline:
    """torch.profiler over CUDA activity only, in one process: while it
    runs, the kernels this process puts on the card.  ``stop()`` returns
    their merged [start, end) intervals in ns on the profiler's clock,
    which is one clock for every process on the machine, with the number
    of kernels and the seconds of its copies and memsets; None and the
    error when the profiler could not run."""

    def __init__(self):
        self.prof = None

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        try:
            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.start()
        except Exception as e:          # noqa: BLE001 - report, not fail
            self.prof = f"{type(e).__name__}: {e}"
        return self.prof is not None and not isinstance(self.prof, str)

    def stop(self):
        import torch
        from torch.autograd import DeviceType
        if not hasattr(self.prof, "stop"):
            return None, self.prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        try:
            with warnings.catch_warnings():
                # torch warns that events of earlier cycles are cleared:
                # there is one cycle
                warnings.simplefilter("ignore", UserWarning)
                self.prof.stop()
            ops, copy_ns = [], 0
            for e in self.prof.profiler.kineto_results.events():
                if e.device_type() != DeviceType.CUDA \
                        or e.end_ns() <= e.start_ns():
                    continue
                if e.name().startswith(("Memcpy", "Memset")):
                    copy_ns += e.end_ns() - e.start_ns()
                else:
                    ops.append((e.start_ns(), e.end_ns()))
        except Exception as e:          # noqa: BLE001 - report, not fail
            return None, f"{type(e).__name__}: {e}", 0
        finally:
            self.prof = None
        return merged(ops), len(ops), copy_ns / 1e9


def merged(intervals) -> list:
    """Sorted, overlapping [start, end) intervals merged into disjoint
    ones."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def measure(intervals) -> float:
    return float(sum(b - a for a, b in intervals))


def probed_executor(kind, *args, ref_init=None, record=None, stall=None,
                    **kwargs):
    """The executors of [10] and [12]-[14], built where the actor lives
    (in this process or in a spawned child): ``kind`` ("trainer",
    "generator" or "reference") with endpoints more.  ``probe()``
    reports the process's kernel launch counts, its pid, peak and
    current CUDA memory and peak resident set, any ``jax`` or ``repro``
    module it imported, the kernels it compiled itself, the batches the
    trainer took, the most params the generator held pinned and staged
    at once, and the (version, fingerprint) of each weight delivery the
    reference received after construction; ``probe(reset=True)`` then
    zeroes the counts and the peaks.  ``timeline(True)`` starts a
    ``DeviceTimeline`` of the process, ``timeline(False)`` stops it and
    returns its intervals.  With ``record`` (wrapper names) the process
    records its kernel calls (``KernelCalls``, the first of each shape)
    for its whole life, and ``replay(label)`` holds them against their
    plain versions there and returns the lines.  A reference built with
    ``ref_init=(seed, dtype, device)`` holds frozen weights of that
    seed.  The trainer's probe gives the fingerprint of its version 0
    (``first_print``).  The engine of the generator named ``stall``
    decodes one round at version 0 and then stalls, decoding nothing,
    until a newer version lands: its first batch is still in flight when
    the next one is admitted."""
    import torch
    from repro_torch.core import executor
    from repro_torch.kernels import build
    base = {"trainer": executor.TrainerExecutor,
            "generator": executor.GeneratorExecutor,
            "reference": executor.RefPolicyExecutor}[kind]

    class Probed(base):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.batches, self.most_pinned, self.most_staged = [], 0, 0
            self.delivered = []
            self._timeline = DeviceTimeline()
            self._calls = None
            if record:
                self._calls = KernelCalls(torch, per_shape=1, names=record)
                self._calls.__enter__()

        def probe(self, reset=False):
            cuda = torch.cuda.is_initialized()
            rss = RSS.gb()
            out = {"pid": os.getpid(), "launches": dict(build.LAUNCHES),
                   "stray": sorted(m for m in sys.modules
                                   if m.split(".")[0] in ("jax", "repro")),
                   "peak_gb": torch.cuda.max_memory_allocated() / 1e9
                   if cuda else 0.0,
                   "reserved_gb": torch.cuda.max_memory_reserved() / 1e9
                   if cuda else 0.0,
                   "reserved_now_gb": torch.cuda.memory_reserved() / 1e9
                   if cuda else 0.0,
                   "rss_gb": rss,
                   "batches": list(self.batches),
                   "most_pinned": self.most_pinned,
                   "delivered": list(self.delivered),
                   # kernels this process compiled (nvcc) rather than
                   # loaded from the parent's build
                   "built": sorted(build.BUILD_SECONDS),
                   "first_print": getattr(self, "first_print", None),
                   "most_staged": self.most_staged,
                   "mesh": list(self.mesh.shape)
                   if self.mesh is not None else None}
            if reset:
                build.reset_launches()
                RSS.reset()
                if cuda:
                    torch.cuda.reset_peak_memory_stats()
            return out

        def timeline(self, on):
            return self._timeline.start() if on else self._timeline.stop()

        def replay(self, label):
            launched = {f"{n}_cuda" for n, c in build.LAUNCHES.items() if c}
            return self._calls.replay(label, expect=launched
                                      & set(self._calls.names))

    if kind == "trainer":
        def step(self):
            self.batches.append(
                self.get_input("completions_with_reward")["tokens"].cpu())
            return base.step(self)

        def init(self):
            base.init(self)
            self.first_print = params_print(self.get_output("policy_model"))
        Probed.step = step
        Probed.init = init
    if kind == "generator":
        def begin_batch_pinned(self, batch_index=None):
            out = base.begin_batch_pinned(self, batch_index)
            self.most_pinned = max(self.most_pinned, self.pinned_count())
            return out

        def stage_weights(self, params, version):
            base.stage_weights(self, params, version)
            self.most_staged = max(self.most_staged,
                                   len(self.staged_versions()))

        def engine_round(self, names):
            if self.name == stall and self.weight_version == 0:
                self.rounds_at_v0 = getattr(self, "rounds_at_v0", 0) + 1
                if self.rounds_at_v0 > 1:
                    time.sleep(0.2)
                    return []
            return base.engine_round(self, names)
        Probed.begin_batch_pinned = begin_batch_pinned
        Probed.stage_weights = stage_weights
        Probed.engine_round = engine_round
    if kind == "reference":
        def set_weights(self, params, version=None):
            # (version, a fingerprint of the delivered params)
            self.delivered.append(
                (version, params_print(params)))
            base.set_weights(self, params, version)
        Probed.set_weights = set_weights
    ex = Probed(*args, **kwargs)
    if ref_init is not None:
        from repro_torch.models import init_params
        seed, dtype, device = ref_init
        ex.set_weights(init_params(ex.cfg, seed=seed, dtype=dtype,
                                   device=device))
    ex.delivered = []               # the deliveries after construction
    return ex


def pool_controller(torch, dev, cfg, *, n_gens, pool, steps, prompt_len=16,
                    transport="inproc", staleness=1, supervise=None,
                    record=None, stall=None, device_spec=None):
    """Generator pool -> frozen reference -> reward -> trainer behind the
    threaded controller, staleness 1 unless told, KL to a reference from
    another seed (as in [6]); the reward stays in this process, the other
    actors go where ``transport`` puts them (``probed_executor``s, the
    generators recording the kernel calls of ``record``, the one named
    ``stall`` stalling at version 0), each spawned child with
    ``device_spec``.  Returns
    (controller, generator handles, trainer, reference, seconds each
    actor took to spawn)."""
    import functools

    from repro_torch.core import (CommType, CommunicationChannel,
                                  ExecutorController, RewardExecutor,
                                  WeightsCommunicationChannel,
                                  build_generator_pool, spawn_actor,
                                  spawn_all)
    from repro_torch.rl.data import ArithmeticTasks

    def timed(job):
        def run():
            t0 = time.perf_counter()
            out = job()
            return out, time.perf_counter() - t0
        return run

    def make_tasks(g):
        return ArithmeticTasks(prompt_len=prompt_len, seed=g)

    jobs = [functools.partial(
        spawn_actor, probed_executor, "reference", cfg,
        ref_init=(1, torch.bfloat16, dev), transport=transport,
        device_spec=device_spec), functools.partial(
        spawn_actor, probed_executor, "trainer", cfg, dtype=torch.bfloat16,
        kl_coef=KL_COEF, seed=0, device=dev, transport=transport,
        device_spec=device_spec), functools.partial(
        build_generator_pool, cfg, None, make_tasks, n_generators=n_gens,
        generator_cls=functools.partial(probed_executor, "generator",
                                        record=record, stall=stall),
        n_prompts=N_PROMPTS, n_per_prompt=N_PER, max_new=MAX_NEW,
        chunk=CHUNK, temperature=1.0, device=dev, transport=transport,
        device_spec=device_spec)]
    # spawned children start at once (the pool's workers on threads of
    # their own): a child takes 10-15 s to import torch and open its CUDA
    # context, and none of them waits on another
    (ref, ref_s), (trn, trn_s), ((gens, _), gens_s) = spawn_all(
        [timed(j) for j in jobs], at_once=transport != "inproc")
    rew = RewardExecutor(n_per_prompt=N_PER, leave_one_out=True)
    spawn_s = {"generators" if len(gens) > 1 else gens[0].name: gens_s,
               ref.name: ref_s, trn.name: trn_s}
    chans = [WeightsCommunicationChannel("policy_model", trn, g)
             for g in gens] + [
        CommunicationChannel("completions", gens[0], ref, CommType.BROADCAST),
        CommunicationChannel("completions_with_ref", ref, rew,
                             CommType.GATHER),
        CommunicationChannel("completions_with_reward", rew, trn,
                             CommType.SCATTER)]
    ctl = ExecutorController(gens + [ref, rew, trn], chans, max_steps=steps,
                             mode="async", staleness=staleness,
                             timeout=900.0, pool=pool, supervise=supervise)
    return ctl, gens, trn, ref, spawn_s


def phase_pool(torch, dev):
    """[10]: the threaded controller at the published widths, POOL_LAYERS
    layers.  (a) a pool of 1, chunk scheduling, against run_sequential of a
    controller built the same way; (b) an engine-mode pool of 2 on paged
    KV, traced.  Returns the launch counts of (b)."""
    import threading

    from repro_torch.configs.llama_paper import LLAMA31_8B
    from repro_torch.core import AsyncExecutorController, PoolConfig
    from repro_torch.kernels import build
    from repro_torch.obs import trace as obs_trace
    from repro_torch.obs.__main__ import summary_lines

    cfg = LLAMA31_8B.replace(name=f"llama31-8b-{POOL_LAYERS}l",
                             n_layers=POOL_LAYERS)
    L = cfg.n_layers
    steps_a, steps_b = 3, 4
    # an executor and its handle refer to each other: only the cycle
    # collector frees the earlier phases' trainers
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[10] pool {cfg.name}: published widths, {L} of 32 layers, bf16 "
        f"params, fp32 Adam, KL {KL_COEF}; the threaded "
        "AsyncExecutorController, staleness 1, every thread on the "
        "default stream; "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated before it")
    tracer = obs_trace.enable("controller")
    tracer.clear()

    # (a) threaded pool of 1 against the sequential schedule, same seed
    runs = {}
    for mode in ("threaded", "sequential"):
        ctl, gens, trn, ref, _ = pool_controller(
            torch, dev, cfg, n_gens=1, pool=PoolConfig(), steps=steps_a)
        require(isinstance(ctl, AsyncExecutorController), type(ctl))
        t0 = time.perf_counter()
        if mode == "threaded":
            build.reset_launches()      # the threaded run starts here
            hist = ctl.run()
            torch.cuda.synchronize()
            launches = dict(build.LAUNCHES)  # ... and ends here
        else:
            hist = ctl.run_sequential()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs[mode] = (hist, trn.call("probe")["batches"], wall)
        del ctl, gens, trn, ref
        gc.collect()
        torch.cuda.empty_cache()
    (ht, bt, wt), (hs, bs, ws) = runs["threaded"], runs["sequential"]
    chunk_s = [e[6] for e in tracer.events()
               if e[2] == "X" and e[4] == "scheduler" and e[3] == "chunk"]
    chunks = len(chunk_s)
    for h in ht:
        log(f"  (a) step {h['step']}: loss {h['loss']:.6f}, grad_norm "
            f"{h['grad_norm']:.5f}, mean_ratio {h['mean_ratio']:.5f}, "
            f"weight_version {h['weight_version']}")
    keys = ("loss", "grad_norm", "mean_ratio", "mean_logp", "mean_reward")
    diff = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-30)
               for a, b in zip(ht, hs) for k in keys)
    same_tokens = len(bt) == len(bs) == steps_a and all(
        torch.equal(a, b) for a, b in zip(bt, bs))
    bit_equal = same_tokens and all(
        a[k] == b[k] for a, b in zip(ht, hs) for k in keys)
    log(f"  (a) pool of 1, chunk scheduling, {steps_a} steps: threaded "
        f"{wt:.2f} s, run_sequential {ws:.2f} s; tokens equal "
        f"{same_tokens}, metrics bit-equal {bit_equal} (largest relative "
        f"difference {diff:.3e}); launches {launches}; decode "
        f"{1e3 * sum(chunk_s) / (chunks * CHUNK):.2f} ms per token over the "
        f"threaded run's {chunks} chunks of {CHUNK} (host clock, "
        f"{N_PROMPTS * N_PER} rows)")
    require([h["weight_version"] for h in ht]
            == [h["weight_version"] for h in hs]
            == [max(0, n - 1) for n in range(steps_a)],
            "pool-of-1 weight versions")
    require(bit_equal, "the threaded pool of 1 differs from run_sequential")
    want = {"fused_sample": CHUNK * chunks,
            "flash_attention": 3 * L * steps_a,
            "fused_logprob": 2 * steps_a, "fused_logprob_bwd": steps_a}
    require(launches == want, f"(a) launch counts {launches}, want {want} "
            "(per chunk: fused_sample chunk; per step: flash_attention "
            "n_layers each for the prefill, the reference and the trainer, "
            "fused_logprob for the reference and the trainer, "
            "fused_logprob_bwd 1)")

    # (b) an engine-mode pool of 2 on paged KV, traced
    tracer.clear()
    torch.cuda.reset_peak_memory_stats()
    ctl, gens, trn, ref, _ = pool_controller(
        torch, dev, cfg, n_gens=2, steps=steps_b, prompt_len=ENGINE_PROMPT,
        pool=PoolConfig(engine=True, kv_layout="paged",
                        kv_page_size=ENGINE_PAGE))
    most, done = [0], threading.Event()

    def live_versions():
        # versions a run keeps alive: queued in the weight channels,
        # held by a generator, the trainer's own, the fabric's latest,
        # and any pinned by a job (none in process)
        while not done.wait(0.002):
            vs = {ctl._tick}
            for ch in ctl._live_weight_channels:
                vs.update(ch.queued_versions())
            vs.update(g.call("weight_version") for g in gens)
            latest = ctl._fabric.latest()
            if latest is not None:
                vs.add(latest[0])
            n = len(vs) + sum(g.call("pinned_count") for g in gens)
            most[0] = max(most[0], n)
    monitor = threading.Thread(target=live_versions, name="versions")
    monitor.start()
    t0 = time.perf_counter()
    build.reset_launches()          # the pool path's run starts here
    try:
        with KernelCalls(torch, per_shape=1,
                         names=KernelCalls.ENGINE) as recorded:
            hist = ctl.run()
        torch.cuda.synchronize()
        launches = dict(build.LAUNCHES)  # ... and ends here
    finally:
        done.set()
        monitor.join()
    wall = time.perf_counter() - t0
    st = ctl.stats
    events = tracer.events()
    obs_trace.disable()
    round_s = [e[6] for e in events
               if e[2] == "X" and e[4] == "engine" and e[3] == "decode-round"]
    rounds = len(round_s)
    stats = [g.call("engine_stats") for g in gens]
    misses = sum(e["radix_misses"] for e in stats)
    for h in hist:
        log(f"  (b) step {h['step']}: {h['generator']}, weight_version "
            f"{h['weight_version']}, loss {h['loss']:.6f}, queue_depth "
            f"{h['queue_depth']}, train_idle {h['train_idle_s']:.3f} s")
    require([h["step"] for h in hist] == list(range(steps_b)),
            "batches not consumed in index order")
    require([h["weight_version"] for h in hist]
            == [max(0, n - 1) for n in range(steps_b)],
            f"weight versions {[h['weight_version'] for h in hist]}")
    require(all(h["sample_staleness"] <= 1 for h in hist), "staleness")
    require([h["generator"] for h in hist]
            == [f"generator{n % 2}" for n in range(steps_b)],
            "the generator field does not alternate")
    require(all(math.isfinite(h["loss"]) for h in hist), "loss not finite")
    for g, e in zip(gens, stats):
        # in process a job keeps its params, so nothing pins (a remote
        # generator pins, [12]): this holds by design
        require(g.call("pinned_count") == 0, f"{g.name}: pinned params")
        require(e["staleness_violations"] == 0 and e["running"] == 0
                and e["waiting"] == 0, f"{g.name}: engine rows left")
        pool_ = g.transport.executor._engine.page_pool
        require(pool_.pages_in_use == 0, f"{g.name}: page leak")
    want = {"fused_sample": CHUNK * rounds,
            "paged_attention": L * CHUNK * rounds,
            "flash_attention": L * (misses + 2 * steps_b),
            "fused_logprob": 2 * steps_b, "fused_logprob_bwd": steps_b}
    require(launches == want, f"(b) launch counts {launches}, want {want} "
            "(per decode round: fused_sample chunk, paged_attention "
            "n_layers x chunk; per radix miss: flash_attention n_layers; "
            "per step: flash_attention n_layers each for the reference and "
            "the trainer, fused_logprob for both, fused_logprob_bwd 1)")
    log(f"  (b) engine pool of 2, paged KV, {steps_b} steps in {wall:.2f} s: "
        f"{rounds} decode rounds, radix misses {misses}, hits "
        f"{sum(e['radix_hits'] for e in stats)}; decode "
        f"{1e3 * sum(round_s) / (rounds * CHUNK):.2f} ms per token over its "
        f"rounds (host clock, two workers); launches {launches}")
    log(f"  (b) stats: wall_s {st['wall_s']:.3f}, gen_busy_s "
        f"{st['gen_busy_s']:.3f} ({100 * st['gen_busy_s'] / st['wall_s']:.1f}"
        f"%), train_busy_s {st['train_busy_s']:.3f} "
        f"({100 * st['train_busy_s'] / st['wall_s']:.1f}%), overlap_s "
        f"{st['overlap_s']:.3f}, gen_idle_s {st['gen_idle_s']:.3f}, "
        f"train_idle_s {st['train_idle_s']:.3f}, publish_s "
        f"{st['publish_s']:.4f}, publish_wait_s {st['publish_wait_s']:.4f}")
    log(f"  (b) peak memory allocated "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; most weight "
        f"versions alive at once {most[0]}")
    path = ROOT / "build" / "pool_trace.json"
    path.parent.mkdir(exist_ok=True)
    doc = obs_trace.export(str(path), events=events,
                           metadata={"phase": "chip_smoke [10] (b)"})
    problems = obs_trace.validate_chrome(doc)
    log(f"  (b) trace: {len(events)} events exported to "
        f"{path.relative_to(ROOT)}; validate_chrome: {problems}")
    require(problems == [], "invalid Chrome trace")
    for line in summary_lines(events):
        log("  " + line)
    del ctl, gens, trn, ref
    gc.collect()
    torch.cuda.empty_cache()
    # the first call of each shape (b) gave a kernel, against its plain
    # version on the same inputs
    for line in recorded.replay("(b)"):
        log(line)
    del recorded
    torch.cuda.empty_cache()
    return launches


def phase_quickstart(torch, dev):
    """[11]: ``quickstart.build("cuda", 20)`` on the threaded controller.
    Every kernel call of the run is recorded and held against its plain
    version on the same inputs; each step's loss, teacher-forced mean
    log-prob and gradient norm are held against the CPU port re-scoring
    the card's own batch from the card's params of that step, through
    the plain versions.  Returns the launch counts of the run."""
    from repro_torch import quickstart
    from repro_torch.kernels import build
    from repro_torch.train.optimizer import global_norm, tree_map
    from repro_torch.train.trainstep import make_loss_fn, value_and_grad

    steps = 20
    ctl = quickstart.build("cuda", steps)
    log(f"[11] quickstart: {type(ctl).__name__}, {steps} steps, staleness "
        f"{ctl.staleness}, the quickstart's ~1M-param policy on the card")
    trn = ctl.trainer.transport.executor
    seen = []
    step = trn.step

    def recording_step():
        batch = trn.get_input("completions_with_reward")
        seen.append((tree_map(lambda t: t.detach().cpu(), trn.state.params),
                     {k: batch[k].cpu() for k in
                      ("tokens", "behavior_logp", "advantages", "mask")}))
        return step()
    trn.step = recording_step
    t0 = time.perf_counter()
    build.reset_launches()          # the quickstart's run starts here
    with KernelCalls(torch) as recorded:
        hist = ctl.run()
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)  # ... and ends here
    wall = time.perf_counter() - t0
    require([h["weight_version"] for h in hist]
            == [max(0, n - 1) for n in range(steps)],
            f"weight versions {[h['weight_version'] for h in hist]}")
    L, gen = trn.cfg.n_layers, ctl.generator.transport.executor
    want = {"fused_sample": steps * gen.max_new,
            "flash_attention": 2 * L * steps,
            "fused_logprob": steps, "fused_logprob_bwd": steps}
    require(launches == want, f"quickstart launch counts {launches}, want "
            f"{want} (per step: fused_sample max_new, flash_attention "
            "n_layers for the prefill and for the trainer, fused_logprob "
            "and fused_logprob_bwd 1)")
    require({n: len(c) for n, c in recorded.calls.items()} == {
        f"{n}_cuda": c for n, c in want.items()}, "recorded calls differ "
        "from the launch counts")
    st = ctl.stats
    log(f"  {steps} steps in {wall:.2f} s (wall_s {st['wall_s']:.3f}, "
        f"overlap_s {st['overlap_s']:.3f}, gen_busy_s {st['gen_busy_s']:.3f}"
        f", train_busy_s {st['train_busy_s']:.3f}); weight versions "
        f"{[h['weight_version'] for h in hist]}; rewards "
        f"{[round(h['mean_reward'], 3) for h in hist]}; launches {launches}")
    for line in recorded.replay("every call"):
        log(line)
    # the CPU port on the card's own batch and params, through the plain
    # versions: |card - cpu| <= 1e-4 |cpu| + 1e-6 for each metric (a step
    # whose rewards are all equal has zero advantages, and its loss and
    # gradient are 0 on both sides)
    loss_fn = make_loss_fn(trn.cfg, rho=4.0, clip_mode="aipo")
    worst = dict.fromkeys(("loss", "mean_logp", "grad_norm"), 0.0)
    at = {}                         # metric -> (step, card, cpu) of its worst
    for n, (h, (params, batch)) in enumerate(zip(hist, seen)):
        (_, metrics), grads = value_and_grad(loss_fn, params, batch)
        cpu = {"loss": metrics["loss"], "mean_logp": metrics["mean_logp"],
               "grad_norm": global_norm(grads)}
        for k, v in cpu.items():
            v = float(v)
            r = abs(h[k] - v) / (1e-4 * abs(v) + 1e-6)
            if r != r:              # a NaN on either side fails the check
                r = float("inf")
            if r >= worst[k]:
                worst[k], at[k] = r, (n, h[k], v)
    zero = sum(1 for h in hist if h["grad_norm"] == 0.0)
    log(f"  each step's metrics against the CPU port on the card's own "
        f"batch and params (plain versions), worst |d| / (1e-4 |cpu| + "
        f"1e-6): " + ", ".join(f"{k} {v:.3g}" for k, v in worst.items())
        + f"; {zero} of {steps} steps have zero advantages and a zero "
        "gradient; at (step, card, cpu): " + ", ".join(
            f"{k} ({n}, {c!r}, {v!r})" for k, (n, c, v) in at.items()))
    require(len(seen) == steps and max(worst.values()) <= 1.0,
            f"quickstart metrics against the CPU port: {len(seen)} steps "
            f"recorded of {steps}; worst {worst} at (step, card, cpu) {at}")
    del ctl, trn, gen, seen, recorded
    gc.collect()
    return launches, hist


class SmiMemory:
    """The card's most used memory while the block ran, sampled every
    ``period`` seconds on a thread of its own (nvidia-smi's
    ``memory.used``)."""

    def __init__(self, period: float = 0.5):
        import threading
        self.period, self.most_mib = period, 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name="smi")

    def _run(self):
        while True:
            try:
                used = subprocess.run(
                    ["nvidia-smi", "--query-gpu=memory.used",
                     "--format=csv,noheader,nounits"], capture_output=True,
                    text=True, timeout=10).stdout.split()
            except (OSError, subprocess.TimeoutExpired):
                used = []
            if used and used[0].isdigit():
                self.most_mib = max(self.most_mib, int(used[0]))
            if self._stop.wait(self.period):
                return

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=30)
        return False

    def line(self) -> str:
        return f"card memory.used peak {self.most_mib} MiB"


class ShmSegments:
    """The shared-memory segments this process creates while the block
    runs (every segment of the shm transport is created and unlinked by
    the controller's process): their names, and the most bytes they held
    in /dev/shm at once."""

    def __enter__(self):
        from repro_torch.core import actors
        self._actors, self.names = actors, []
        self.live, self.peak = {}, 0
        create, unlink = actors._shm_create, actors._shm_unlink

        def created(size):
            seg = create(size)
            self.names.append(seg.name)
            self.live[seg.name] = seg.size
            self.peak = max(self.peak, sum(self.live.values()))
            return seg

        def unlinked(seg):
            self.live.pop(seg.name, None)
            return unlink(seg)
        self._saved = (create, unlink)
        actors._shm_create, actors._shm_unlink = created, unlinked
        return self

    def __exit__(self, *exc):
        self._actors._shm_create, self._actors._shm_unlink = self._saved
        return False

    def left(self) -> list:
        """The block's segments still in /dev/shm."""
        return [n for n in self.names if os.path.exists(f"/dev/shm/{n}")]


def spans(events, name, proc=None, actor=None):
    """The complete spans called ``name`` (of ``proc``, on ``actor``)."""
    return [e for e in events if e[2] == "X" and e[3] == name
            and (proc is None or e[0] == proc)
            and (actor is None or (e[7] or {}).get("actor") == actor)]


def inside(events, outer, name):
    """The spans called ``name`` on ``outer``'s process and thread that
    lie inside ``outer``."""
    t0, t1 = outer[5], outer[5] + outer[6]
    return [e for e in spans(events, name, proc=outer[0])
            if e[1] == outer[1] and e[5] >= t0 and e[5] + e[6] <= t1 + 1e-9]


def weight_hops(events, trainer, gens):
    """Per weight version, the bytes and seconds of each hop, from the
    run's trace: trainer -> controller is the controller's
    ``rpc:get_output`` on the trainer (the child serializes, the reply
    crosses, the controller copies it to its card); controller ->
    generator is the controller's ``cast:stage_weights`` (serialize into
    the frame or slot, send) plus the generator's ``deserialize`` of that
    message (to its card).  Returns (up, down) lists of (bytes, s)."""
    up = []
    for sp in spans(events, "rpc:get_output", proc="controller",
                    actor=trainer):
        got = [(d[7] or {}).get("bytes", 0)
               for d in inside(events, sp, "deserialize")]
        if got and max(got) > 1 << 20:
            up.append((max(got), sp[6]))
    down = []
    for g in gens:
        casts = spans(events, "cast:stage_weights", proc="controller",
                      actor=g)
        serves = spans(events, "serve:stage_weights", proc=g)
        reads = spans(events, "deserialize", proc=g)
        for c, sv in zip(casts, serves):
            ser = inside(events, c, "serialize")
            before = [d for d in reads if d[5] + d[6] <= sv[5] + 1e-6]
            if ser and before:
                down.append(((ser[0][7] or {}).get("bytes", 0),
                             c[6] + before[-1][6]))
    return up, down


def hop_line(label, hops) -> str:
    if not hops:
        return f"{label}: none"
    ms = [1e3 * s for _, s in hops]
    gbs = [b / s / 1e9 for b, s in hops]
    return (f"{label}: {len(hops)} x {hops[0][0] / 1e9:.3f} GB, "
            f"{statistics.median(ms):.1f} ms median "
            f"({min(ms):.1f}-{max(ms):.1f}), "
            f"{statistics.median(gbs):.2f} GB/s median "
            f"({min(gbs):.2f}-{max(gbs):.2f})")


def decode_by_worker(events):
    """Decode ms a token of each engine worker (process/thread), from its
    ``engine/decode-round`` spans (host clock), with its round count."""
    by = collections.defaultdict(list)
    for e in spans(events, "decode-round"):
        if e[4] == "engine":
            by[f"{e[0]}/{e[1]}"].append(e[6])
    return {k: (1e3 * sum(v) / (len(v) * CHUNK), len(v))
            for k, v in sorted(by.items())}


def summed(counts) -> dict:
    out = collections.Counter()
    for c in counts:
        out.update(c)
    return dict(out)


def rss_line(probes, rss_here) -> str:
    """The peak resident set of each probed process and of this one over
    the run (sampled)."""
    def gb(rss):
        return "not measured" if rss is None else f"{rss:.2f}"
    return ("peak resident set GB by process over the run: "
            + ", ".join(f"{k} {gb(p['rss_gb'])}" for k, p in probes.items())
            + f", controller {gb(rss_here)}")


def device_overlap(timelines, started) -> str:
    """What the processes' device timelines (``DeviceTimeline.stop()``
    of each, by actor) show over the run: the share of it with no kernel
    in flight, each process's kernel seconds, and how much of the
    trainer's kernel time fell into the generators' gaps rather than
    beside a generator's kernel (time-sliced or concurrent)."""
    bad = {k: v[1] for k, v in timelines.items() if v[0] is None}
    if bad or not all(started.values()):
        return f"device timeline: not measured ({bad or started})"
    everything = merged([iv for v, _, _ in timelines.values() for iv in v])
    if not everything:
        return "device timeline: not measured (no kernel seen)"
    window = everything[-1][1] - everything[0][0]
    out = (f"device timeline over {window / 1e9:.3f} s (first to last "
           f"kernel, torch.profiler CUDA activity): no kernel in flight "
           f"{100 * (1 - measure(everything) / window):.1f}% of it; kernel "
           "s (kernels; copy and memset s) by process " + ", ".join(
               f"{k} {measure(v) / 1e9:.3f} ({n}; {c:.3f})"
               for k, (v, n, c) in timelines.items()))
    gens = [k for k in timelines if k.startswith("generator")]
    if gens and "trainer" in timelines:
        g = merged([iv for k in gens for iv in timelines[k][0]])
        t = timelines["trainer"][0]
        both = measure(g) + measure(t) - measure(merged(g + t))
        out += (f"; generators together busy {measure(g) / 1e9:.3f} s, "
                f"idle {(window - measure(g)) / 1e9:.3f} s; of the "
                f"trainer's {measure(t) / 1e9:.3f} s, "
                f"{(measure(t) - both) / 1e9:.3f} s in the generators' "
                f"gaps and {both / 1e9:.3f} s beside a generator's "
                "kernel")
    return out


def phase_proc(torch, dev, quick_hist):
    """[12]: the async loop with its actors in spawned processes.  (a)
    ``proc`` on llama31-8b's smoke config, a pool of 1 (chunk
    scheduling), each child on a (1, 1) mesh of its own (an NCCL world of
    one; the trainer steps sharded on it), against the same loop threaded
    in process bit for bit; (b) an engine pool of 2 on paged KV, threaded
    in process and then over ``shm``, traced; (c) the quickstart with
    every actor on a self-hosted ``socket``, against [11] bit for bit.
    Every loop runs llama31-8b's smoke config: at its published widths a
    weight version is 2.5 GB a layer and more, each hop of it took 2-6 s
    (0.2-1.2 GB/s) and the hops paced the script.  Returns the children's
    launch counts of (a) and (b)."""
    from repro_torch import quickstart
    from repro_torch.configs.llama_paper import smoke
    from repro_torch.core import DeviceSpec, PoolConfig, close_all_actors
    from repro_torch.kernels import build
    from repro_torch.obs import trace as obs_trace

    gc.collect()
    torch.cuda.empty_cache()
    keys = ("loss", "grad_norm", "mean_ratio", "mean_logp", "mean_reward")
    tracer = obs_trace.enable("controller")
    cfg = smoke()
    parts = [("", time.perf_counter())]

    def part(label):
        """Closes the part of the phase called ``label``."""
        parts.append((label, time.perf_counter()))
    log(f"[12] processes: the async loop with the reference, the trainer "
        f"and the generators each in a spawned child (own interpreter, "
        f"CUDA context and default stream), the reward in this process; "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated here "
        "before it")

    # (a) proc, a pool of 1, each child on a (1, 1) mesh, against the same
    # loop threaded here
    ctl, gens, trn, ref, _ = pool_controller(torch, dev, cfg, n_gens=1,
                                             pool=PoolConfig(), steps=3)
    build.reset_launches()          # the threaded twin's run starts here
    ha = ctl.run()
    torch.cuda.synchronize()
    want_a = dict(build.LAUNCHES)   # ... and ends here
    ta = trn.call("probe")["batches"]
    del ctl, gens, trn, ref
    gc.collect()
    torch.cuda.empty_cache()
    part("(a)'s twin")
    tracer.clear()
    ctl, gens, trn, ref, spawn_s = pool_controller(
        torch, dev, cfg, n_gens=1, pool=PoolConfig(), steps=len(ha),
        transport="proc", device_spec=DeviceSpec(mesh_shape=(1, 1)))
    actors = gens + [ref, trn]
    for h in actors:
        h.call("probe", reset=True)
    build.reset_launches()          # (a)'s run starts here
    torch.cuda.reset_peak_memory_stats()
    RSS.reset()
    with SmiMemory() as smi:
        t0 = time.perf_counter()
        hist = ctl.run()
        wall = time.perf_counter() - t0
    probes = {h.name: h.call("probe") for h in actors}  # ... and ends here
    parent = dict(build.LAUNCHES)
    peak_here = torch.cuda.max_memory_allocated() / 1e9
    reserved_here = torch.cuda.max_memory_reserved() / 1e9
    rss_here = RSS.gb()
    gen = gens[0]
    pinned_after = gen.call("pinned_count")
    # versions published after the generator's last admission stay
    # staged, their commit markers queued in its channel
    staged_after = (gen.call("staged_versions"),
                    ctl._channels_by_gen[gen.name][0].queued_versions())
    subs = ctl._fabric.subscriber_stats()
    events = tracer.events()
    close_all_actors()
    del ctl, gens, trn, ref, gen, actors, h
    gc.collect()
    torch.cuda.empty_cache()
    launches_a = summed(p["launches"] for p in probes.values())
    tokens = probes["trainer"]["batches"]
    same_tokens = len(tokens) == len(ta) and all(
        torch.equal(a, b) for a, b in zip(tokens, ta))
    bit_equal = same_tokens and all(
        a[k] == b[k] for a, b in zip(hist, ha) for k in keys)
    for h in hist:
        log(f"  (a) step {h['step']}: loss {h['loss']:.6f}, grad_norm "
            f"{h['grad_norm']:.5f}, mean_ratio {h['mean_ratio']:.5f}, "
            f"weight_version {h['weight_version']}")
    chunk_s = [e[6] for e in spans(events, "chunk") if e[4] == "scheduler"]
    up, down = weight_hops(events, "trainer", ["generator"])
    log(f"  (a) proc, {cfg.name}, pool of 1, chunk scheduling, {len(hist)} "
        f"steps in {wall:.2f} s: tokens equal to the threaded twin's "
        f"{same_tokens}, metrics "
        f"bit-equal {bit_equal}; versions "
        f"{[h['weight_version'] for h in hist]}; decode "
        f"{1e3 * sum(chunk_s) / (len(chunk_s) * CHUNK):.2f} ms a token over "
        f"{len(chunk_s)} chunks (host clock, the job and its KV state "
        "crossing the socket every chunk)")
    log(f"  (a) spawn s: " + ", ".join(f"{k} {v:.2f}"
                                      for k, v in spawn_s.items())
        + "; meshes: " + ", ".join(f"{k} {p['mesh']}"
                                   for k, p in probes.items()))
    log(f"  (a) {hop_line('trainer -> controller (socket pair)', up)}")
    log(f"  (a) {hop_line('controller -> generator (socket pair)', down)}")
    log(f"  (a) launches: " + ", ".join(
        f"{k} {p['launches']}" for k, p in probes.items())
        + f", this process {parent}")
    log(f"  (a) peak GB allocated (reserved) by process: " + ", ".join(
        f"{k} {p['peak_gb']:.2f} ({p['reserved_gb']:.2f})"
        for k, p in probes.items()) + f", controller {peak_here:.2f} "
        f"({reserved_here:.2f}); {smi.line()}")
    log(f"  (a) {rss_line(probes, rss_here)}")
    log(f"  (a) generator: most params pinned at once "
        f"{probes['generator']['most_pinned']}, pinned_count() after "
        f"{pinned_after}; most staged slots {probes['generator']['most_staged']}"
        f", staged after the run {staged_after[0]} (commit markers queued "
        f"{staged_after[1]}); fabric {subs}")
    require(all(p["mesh"] == [1, 1] for p in probes.values()),
            f"(a) meshes {[p['mesh'] for p in probes.values()]}")
    require([h["weight_version"] for h in hist] == [0, 0, 1],
            "(a) weight versions")
    require(bit_equal, "(a) the process-placed loop differs from its "
            "threaded twin")
    require(launches_a == want_a and not parent, f"(a) launches {launches_a}"
            f" in the children and {parent} here, want {want_a} there")
    require(all(not p["stray"] for p in probes.values()),
            f"a child imported {[p['stray'] for p in probes.values()]}")
    require(probes["generator"]["most_pinned"] > 0 and pinned_after == 0,
            "(a) the remote generator's pins")
    require(probes["generator"]["most_staged"] > 0
            and staged_after[0] == staged_after[1]
            and all(r["published"] > 0 for r in subs.values()),
            "(a) staged slots not used, or one neither committed nor queued")

    part("(a)")
    # (b) an engine pool of 2 on paged KV: in process, then shm
    L, steps_b = cfg.n_layers, 3
    proc_launches = [launches_a]
    for transport in ("inproc", "shm"):
        tracer.clear()
        remote = transport != "inproc"
        with ShmSegments() as shm:
            ctl, gens, trn, ref, spawn_s = pool_controller(
                torch, dev, cfg, n_gens=2, steps=steps_b,
                prompt_len=ENGINE_PROMPT, transport=transport,
                pool=PoolConfig(engine=True, kv_layout="paged",
                                kv_page_size=ENGINE_PAGE))
            actors = gens + [ref, trn]
            for h in actors:
                h.call("probe", reset=True)
            # device timelines of every process that launches kernels:
            # each child, or this process for the threaded run
            timelines = {h.name: h for h in actors} if remote else \
                {"controller": DeviceTimeline()}
            started = {k: (t.call("timeline", True) if remote else t.start())
                       for k, t in timelines.items()}
            build.reset_launches()      # (b)'s run starts here
            torch.cuda.reset_peak_memory_stats()
            RSS.reset()
            with SmiMemory() as smi:
                t0 = time.perf_counter()
                hist = ctl.run()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            timelines = {k: (t.call("timeline", False) if remote
                             else t.stop()) for k, t in timelines.items()}
            probes = {h.name: h.call("probe") for h in actors}  # ... ends
            parent = dict(build.LAUNCHES)
            peak_here = torch.cuda.max_memory_allocated() / 1e9
            reserved_here = torch.cuda.max_memory_reserved() / 1e9
            rss_here = RSS.gb()
            stats = [g.call("engine_stats") for g in gens]
            after = [(g.call("pinned_count"), g.call("staged_versions"),
                      ctl._channels_by_gen[g.name][0].queued_versions())
                     for g in gens]
            live = len(shm.live)
            st = ctl.stats
            events = tracer.events()
            close_all_actors()
            # the in-process run's executors live while a handle does
            del ctl, gens, trn, ref, actors, h
            gc.collect()
            torch.cuda.empty_cache()
        left = shm.left()
        launches = summed(p["launches"] for p in probes.values()) \
            if remote else parent
        rounds = len([e for e in spans(events, "decode-round")
                      if e[4] == "engine"])
        misses = sum(e["radix_misses"] for e in stats)
        tag = f"(b) {transport}"
        require([h["step"] for h in hist] == list(range(steps_b))
                and [h["weight_version"] for h in hist]
                == [max(0, n - 1) for n in range(steps_b)]
                and [h["generator"] for h in hist]
                == [f"generator{n % 2}" for n in range(steps_b)]
                and all(math.isfinite(h["loss"]) for h in hist),
                f"{tag}: order, versions, workers or losses")
        require(all(e["staleness_violations"] == 0 and e["running"] == 0
                    and e["waiting"] == 0 and e["pages_in_use"] == 0
                    for e in stats), f"{tag}: engine rows or pages left")
        want = {"fused_sample": CHUNK * rounds,
                "paged_attention": L * CHUNK * rounds,
                "flash_attention": L * (misses + 2 * steps_b),
                "fused_logprob": 2 * steps_b, "fused_logprob_bwd": steps_b}
        require(launches == want and (not remote or not parent),
                f"{tag}: launches {launches} (here {parent}), want {want}")
        decode = decode_by_worker(events)
        log(f"  {tag}: {steps_b} steps in {wall:.2f} s; versions "
            f"{[h['weight_version'] for h in hist]}; decode ms a token by "
            "worker (host clock): " + ", ".join(
                f"{k} {v:.2f} over {n} rounds" for k, (v, n) in
                decode.items()) + f"; launches {launches}")
        log(f"  {tag} stats: wall_s {st['wall_s']:.3f}, gen_busy_s "
            f"{st['gen_busy_s']:.3f}, train_busy_s {st['train_busy_s']:.3f},"
            f" overlap_s {st['overlap_s']:.3f}, train_idle_s "
            f"{st['train_idle_s']:.3f}, publish_s {st['publish_s']:.4f}")
        log(f"  {tag} {device_overlap(timelines, started)}")
        log(f"  {tag} {rss_line(probes if remote else {}, rss_here)}; "
            f"/dev/shm: {len(shm.names)} segments created, "
            f"{shm.peak / 1e9:.3f} GB at most at once")
        if remote:
            up, down = weight_hops(events, "trainer",
                                   ["generator0", "generator1"])
            log(f"  {tag} {hop_line('trainer -> controller (socket pair, '
                                    'inline)', up)}")
            log(f"  {tag} {hop_line('controller -> generator (shm)', down)}")
            log(f"  {tag} spawn s: " + ", ".join(
                f"{k} {v:.2f}" for k, v in spawn_s.items()))
            log(f"  {tag} peak GB allocated (reserved) by process: "
                + ", ".join(f"{k} {p['peak_gb']:.2f} ({p['reserved_gb']:.2f})"
                            for k, p in probes.items())
                + f", controller {peak_here:.2f} ({reserved_here:.2f}); "
                + smi.line())
            log(f"  {tag} most staged slots a generator held at once "
                + ", ".join(f"{k} {probes[k]['most_staged']}"
                            for k in ("generator0", "generator1"))
                + f"; most pinned {[probes[k]['most_pinned'] for k in ('generator0', 'generator1')]}"
                " (engine rows decode under the current params and pin "
                "nothing); (pinned_count, staged, commit markers queued) "
                f"after the run {after}; {live} of the run's shm segments "
                f"live before close_all_actors, still in /dev/shm after "
                f"it: {left}")
            require(all(not p["stray"] for p in probes.values()),
                    f"{tag}: a child imported jax or repro")
            require(all(p == 0 and staged == queued
                        for p, staged, queued in after),
                    f"{tag}: pins left, or a staged slot neither committed "
                    f"nor queued {after}")
            require(all(probes[k]["most_staged"] > 0
                        for k in ("generator0", "generator1")),
                    f"{tag}: no staged slot used")
            require(live and not left, f"{tag}: shm segments left {left}")
            proc_launches.append(launches)
        else:
            log(f"  {tag}: weights shared by reference (no hop); peak "
                f"{peak_here:.2f} GB allocated ({reserved_here:.2f} "
                f"reserved) in one process; {smi.line()}")
        part(tag)

    # (c) the quickstart with its actors on self-hosted sockets
    os.environ["REPRO_TRANSPORT"] = "socket"
    try:
        t0 = time.perf_counter()
        ctl = quickstart.build("cuda", len(quick_hist))
        spawn = time.perf_counter() - t0
    finally:
        del os.environ["REPRO_TRANSPORT"]
    kinds = sorted(type(h.transport).__name__
                   for h in ctl.executors.values())
    t0 = time.perf_counter()
    hist = ctl.run()
    wall = time.perf_counter() - t0
    close_all_actors()
    del ctl
    gc.collect()
    equal = len(hist) == len(quick_hist) and all(
        a[k] == b[k] for a, b in zip(hist, quick_hist)
        for k in keys + ("weight_version",))
    log(f"  (c) socket: the quickstart's {len(hist)} steps with {kinds} in "
        f"{wall:.2f} s (+{spawn:.2f} s building); bit-equal to [11] "
        f"in process: {equal}")
    require(equal, "(c) the socket-placed quickstart differs from [11]")
    part("(c)")
    log("  [12] by part (spawns and teardown included): " + ", ".join(
        f"{k} {t - parts[n][1]:.1f} s" for n, (k, t) in enumerate(parts[1:])))
    obs_trace.disable()
    return summed(proc_launches)


LAUNCH_FLAGS = ["--arch", "llama31-8b", "--smoke", "--steps", "3",
                "--transport", "shm", "--n-generators", "2", "--kl-coef",
                "0.1", "--engine", "--rollout-chunk", "4", "--kv-layout",
                "paged"]


def phase_launch(torch) -> dict:
    """[13]: the launcher with the trainer, two engine generators on
    paged KV and the reference in ``shm`` children.  (i) ``python -m
    repro_torch.launch.train`` as a user runs it, a process of its own,
    with ``--child-mesh 1x1`` (each child on a mesh of its own): exit 0,
    3 history rows, spans from every child in its trace.  (ii)
    meanwhile, in this process, the launcher's ``build_controller`` with
    the same flags and ``probed_executor`` factories: the children count
    their launches and record their kernel calls, which each child then
    holds against the plain versions.  Returns (ii)'s children's launch
    counts."""
    import functools

    from repro_torch.core import close_all_actors
    from repro_torch.kernels import build
    from repro_torch.launch import train

    build_dir = ROOT / "build"
    build_dir.mkdir(exist_ok=True)
    out, trace = build_dir / "launch.json", build_dir / "launch_trace.json"
    for f in (out, trace):
        if f.exists():
            f.unlink()
    cmd = [sys.executable, "-m", "repro_torch.launch.train"] + LAUNCH_FLAGS \
        + ["--child-mesh", "1x1", "--trace", str(trace.relative_to(ROOT)),
           "--out", str(out.relative_to(ROOT))]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    log(f"[13] launcher: (i) {' '.join(cmd[1:])} as a process of its own; "
        "(ii) meanwhile its build_controller with the same flags here, "
        "the children probed")
    t0 = time.perf_counter()
    with open(build_dir / "launch.stdout", "w") as so, \
            open(build_dir / "launch.stderr", "w") as se:
        proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=so, stderr=se)
        try:
            # (ii) the same flags through the launcher's own wiring
            args = train.parse_args(LAUNCH_FLAGS)
            probe = {kind: functools.partial(probed_executor, kind,
                                             record=KernelCalls.ENGINE)
                     for kind in ("trainer", "generator", "reference")}
            t1 = time.perf_counter()
            ctl = train.build_controller(
                train.config_for(args), args, trainer_cls=probe["trainer"],
                generator_cls=probe["generator"],
                ref_cls=probe["reference"])
            spawn = time.perf_counter() - t1
            actors = [h for h in ctl.executors.values() if h.remote]
            for h in actors:
                h.call("probe", reset=True)
            build.reset_launches()      # (ii)'s run starts here
            hist = ctl.run()
            probes = {h.name: h.call("probe") for h in actors}  # ... ends
            parent = dict(build.LAUNCHES)
            replays = {h.name: h.call("replay", f"(ii) {h.name}")
                       for h in actors}
            close_all_actors()
            del ctl, actors, h
        finally:
            rc = proc.wait(timeout=600)
    wall = time.perf_counter() - t0
    stdout = (build_dir / "launch.stdout").read_text()
    log(f"  (i) exit {rc}; (i) and (ii) together {wall:.1f} s, (ii) "
        f"spawned its children in {spawn:.1f} s")
    if rc != 0:
        log(stdout[-4000:])
        log((build_dir / "launch.stderr").read_text()[-4000:])
    require(rc == 0, "the launcher failed")
    doc = json.loads(out.read_text())
    events = json.loads(trace.read_text())["traceEvents"]
    named = {e["pid"]: e["args"]["name"] for e in events
             if e.get("ph") == "M" and e["name"] == "process_name"}
    spanned = {named.get(e["pid"]) for e in events if e.get("ph") == "X"}
    children = {"trainer", "generator0", "generator1", "ref"}
    log(f"  (i) {len(doc['history'])} history rows, versions "
        f"{[h['weight_version'] for h in doc['history']]}; processes with "
        f"spans in the trace {sorted(map(str, spanned))}")
    for line in stdout.splitlines():
        if line.startswith("stats:"):
            log("  (i) " + line)
    require(len(doc["history"]) == 3, "the launcher's history")
    require(children <= spanned, f"spans only from {sorted(spanned)}")
    launches = {k: p["launches"] for k, p in probes.items()}
    log(f"  (ii) {len(hist)} history rows, versions "
        f"{[h['weight_version'] for h in hist]}; launches " + ", ".join(
            f"{k} {v}" for k, v in launches.items())
        + f", this process {parent}")
    for lines in replays.values():
        for line in lines:
            log(line)
    require(len(hist) == 3 and set(probes) == children,
            f"(ii): {len(hist)} rows, children {sorted(probes)}")
    require(not parent, f"(ii): kernels launched here {parent}")
    require(all(not p["stray"] for p in probes.values()),
            "(ii): a child imported jax or repro")
    return summed(launches.values())


# [14] runs llama31-8b's smoke config, as the launcher runs in (c): what
# it checks (a kill, a respawn, the replay, the batch re-admitted, a
# recovery bit-equal to the run without the fault) does not depend on the
# width, and at llama31-8b's widths each weight hop of 2.5 GB (0.2-0.5
# GB/s, which [12] measures) paced the phase to about 250 s
# the least card memory a CUDA context holds beside its allocator's
CONTEXT_GB = 0.25
SUPERVISE_FLAGS = ["--arch", "llama31-8b", "--smoke", "--steps", "6",
                   "--transport", "proc", "--n-generators", "2",
                   "--rollout-chunk", "2", "--supervise"]


def params_print(params) -> float:
    """A fingerprint of a weight version: the sum of its output head,
    which every train step moves (the embedding's row 0 may not)."""
    return float(params["lm_head"].float().sum())


def card_used_gb(torch) -> float:
    free, total = torch.cuda.mem_get_info()
    return (total - free) / 1e9


def phase_supervise(torch, dev) -> dict:
    """[14]: supervision on llama31-8b's smoke config.
    (a) an shm engine pool of 2 whose generator1 is killed at batch 3 with batch 1
    in flight, respawned, and batch 1 re-admitted; (b) the frozen reference in a proc child killed at
    the consumer's batch 2, bit-equal to the same controller's run
    without the fault and with the reference here; (c) the launcher with --supervise --chaos as a
    process of its own, respawning and then degrading; (d) the
    train_arithmetic_rl twin with checkpoints.  Returns the launch
    counts of (a), (b) and (d)."""
    from repro_torch import train_arithmetic_rl
    from repro_torch.configs.llama_paper import smoke
    from repro_torch.core import (FaultPlan, PoolConfig, Supervisor,
                                  close_all_actors)
    from repro_torch.kernels import build
    from repro_torch.train.checkpoint import restore_checkpoint

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = smoke()
    launches = []
    log(f"[14] supervise: {cfg.name} ({cfg.n_layers} layers, d "
        f"{cfg.d_model}, V {cfg.vocab}), bf16 params, fp32 Adam, KL "
        f"{KL_COEF}; "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated here "
        "before it")

    class Measured(FaultPlan):
        """The fault plan, reading the card and the victim just before
        each fault and the card just after it (the corpse joined)."""

        def __init__(self, spec):
            super().__init__(FaultPlan.parse(spec).faults)
            self.before = {}

        def _execute(self, fault, handle):
            t = handle.transport
            self.before[handle.name] = {
                "used_gb": card_used_gb(torch),
                "probe": handle.call("probe"),
                "inflight": handle.call("engine_inflight")
                if handle.role == "generator" else [],
                "segments": list(t.segment_names())
                if hasattr(t, "segment_names") else []}
            super()._execute(fault, handle)
            self.before[handle.name]["after_kill_gb"] = card_used_gb(torch)

    class MeasuredSupervisor(Supervisor):
        """Reads the card once a recovery returns."""

        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.after = {}

        def recover(self, handle, error):
            out = super().recover(handle, error)
            self.after[handle.name] = card_used_gb(torch)
            return out

    # (a) generator1 killed at the admission of batch 3 while its batch 1
    # is in flight, in an shm engine pool of 2
    t0 = time.perf_counter()
    chaos = Measured("kill:generator1@batch=3")
    sup = MeasuredSupervisor(chaos=chaos)
    with ShmSegments() as shm:
        ctl, gens, trn, ref, spawn_s = pool_controller(
            torch, dev, cfg, n_gens=2, steps=4, prompt_len=ENGINE_PROMPT,
            transport="shm", staleness=2, supervise=sup,
            record=KernelCalls.ENGINE, stall="generator1",
            pool=PoolConfig(engine=True, kv_layout="paged",
                            kv_page_size=ENGINE_PAGE))
        actors = gens + [ref, trn]
        for h in actors:
            h.call("probe", reset=True)
        build.reset_launches()          # (a)'s run starts here
        hist = ctl.run()
        probes = {h.name: h.call("probe") for h in actors}  # ... ends
        parent = dict(build.LAUNCHES)
        stats = {g.name: g.call("engine_stats") for g in gens}
        replay = gens[1].call("replay", "(a) generator1, second life")
        events = sup.events()
        close_all_actors()
        del ctl, gens, trn, ref, actors, h
        gc.collect()
        torch.cuda.empty_cache()
    wall_a = time.perf_counter() - t0
    victim = chaos.before["generator1"]
    first_life = victim["probe"]
    respawned = [e for e in events if e["event"] == "respawned"]
    readmitted = [e for e in events if e["event"] == "readmitted"]
    corpse_left = [n for n in victim["segments"]
                   if os.path.exists(f"/dev/shm/{n}")]
    launches.append(summed([p["launches"] for p in probes.values()]
                           + [first_life["launches"]]))
    second = probes["generator1"]
    for h in hist:
        log(f"  (a) step {h['step']}: {h['generator']}, weight_version "
            f"{h['weight_version']}, loss {h['loss']:.6f}")
    e = respawned[0] if respawned else {}
    nan = float("nan")
    log(f"  (a) {len(hist)} steps in {wall_a:.1f} s (spawning included); "
        f"spawn s " + ", ".join(f"{k} {v:.2f}" for k, v in spawn_s.items()))
    log(f"  (a) generator1 (pid {first_life['pid']}) killed at the "
        f"admission of batch 3 with batches {victim['inflight']} in its "
        f"engine: respawned in {e.get('spawn_s', nan):.2f} s, init "
        f"{e.get('init_s', nan):.3f} s; the replay of version "
        f"{e.get('version')}, {e.get('replay_gb', nan):.3f} GB, took "
        f"{e.get('replay_s', nan):.2f} s until the child answered "
        f"({e.get('replay_gb', nan) / e.get('replay_s', nan):.2f} GB/s); "
        f"recovery_s {e.get('recovery_s', nan):.2f}; readmitted "
        f"{[r.get('batches') for r in readmitted]}")
    log(f"  (a) card memory used: {victim['used_gb']:.2f} GB before the "
        f"kill (the victim's caching allocator {first_life['reserved_now_gb']:.2f}"
        f" GB), {victim['after_kill_gb']:.2f} GB once it exited, "
        f"{sup.after.get('generator1', nan):.2f} GB after the "
        f"recovery (the new child's {second['reserved_now_gb']:.2f} GB at "
        "the end); " + nvidia_smi())
    log(f"  (a) engine stats: " + "; ".join(
        f"{k}: batches_emitted {v['batches_emitted']}, radix_hits "
        f"{v['radix_hits']}, radix_misses {v['radix_misses']}, "
        f"staleness_violations {v['staleness_violations']}"
        for k, v in stats.items()))
    log(f"  (a) launches: first life of generator1 "
        f"{first_life['launches']}, then " + ", ".join(
            f"{k} {p['launches']}" for k, p in probes.items())
        + f", this process {parent}; events "
        + str([(ev["event"], ev["actor"]) for ev in events]))
    for line in replay:
        log(line)
    require([h["step"] for h in hist] == list(range(4)), "(a) step order")
    require(chaos.unfired() == [], "(a) the fault did not fire")
    require([r["actor"] for r in respawned] == ["generator1"]
            and [r["actor"] for r in readmitted] == ["generator1"]
            and respawned[0]["recovery_s"] > 0,
            f"(a) respawned {respawned}, readmitted {readmitted}")
    # the batch in flight at the kill is re-enqueued into the new engine
    # and emitted by the second life (1 again, then 3)
    require(victim["inflight"] == [1]
            and readmitted[0]["batches"] == "[1]"
            and hist[1]["generator"] == "generator1"
            and stats["generator1"]["batches_emitted"] == 2,
            f"(a) in flight at the kill {victim['inflight']}, readmitted "
            f"{readmitted}, the second life's stats {stats['generator1']}")
    require(max(h["sample_staleness"] for h in hist) <= 2,
            "(a) staleness above 2")
    require(all(v["staleness_violations"] == 0 and v["waiting"] == 0
                and v["running"] == 0 for v in stats.values())
            and stats["generator1"]["radix_hits"] > 0,
            f"(a) engine stats {stats}")
    require(all(second["launches"].get(k, 0) > 0 for k in
                ("fused_sample", "flash_attention", "paged_attention")),
            f"(a) generator1's second life launched {second['launches']}")
    require(not parent, f"(a) kernels launched here {parent}")
    require(not second["built"], f"(a) the respawned child ran nvcc for "
            f"{second['built']}")
    require(victim["segments"] and not corpse_left,
            f"(a) the corpse's shm segments left: {corpse_left}")
    # the corpse's caching allocator and its CUDA context (about 0.7 GB
    # on an H100) leave the card when it exits
    require(victim["used_gb"] - victim["after_kill_gb"]
            >= first_life["reserved_now_gb"] + CONTEXT_GB,
            "(a) the corpse's memory was not returned when it exited")
    # after the recovery the card holds at most 1 GB more than before the
    # kill, and the new child holds at least the version replayed into it
    require(sup.after["generator1"] <= victim["used_gb"] + 1.0,
            "(a) the card holds more than 1 GB above its level before "
            "the kill after the recovery")
    require(e.get("replay_gb", 0) > 0
            and second["reserved_now_gb"] >= e["replay_gb"],
            f"(a) the new child holds {second['reserved_now_gb']:.2f} GB, "
            f"less than the {e.get('replay_gb')} GB replayed into it")
    require(all(not p["stray"] for p in probes.values()),
            "(a) a child imported jax or repro")
    require(not shm.left(), f"(a) shm segments left {shm.left()}")

    # (c) the launcher, twice, as processes of their own, while (b) and
    # (d) run here
    build_dir = ROOT / "build"
    build_dir.mkdir(exist_ok=True)
    runs = {"respawn": ["--chaos", "kill:generator1@batch=3,chunk=1"],
            "degrade": ["--max-restarts", "0", "--chaos",
                        "kill:generator1@batch=3"]}
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = {}
    for k, extra in runs.items():
        out = build_dir / f"supervise_{k}.json"
        if out.exists():
            out.unlink()
        cmd = [sys.executable, "-m", "repro_torch.launch.train"] \
            + SUPERVISE_FLAGS + extra + ["--out", str(out.relative_to(ROOT))]
        so = open(build_dir / f"supervise_{k}.stdout", "w")
        se = open(build_dir / f"supervise_{k}.stderr", "w")
        procs[k] = (subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=so,
                                     stderr=se), so, se, out, cmd)

    # (b) the reference killed at the consumer's batch 2, against the
    # same controller's run without the fault and with the reference here
    # ([12] (a) holds a proc child bit-equal to its threaded twin); the
    # fault run records its kernel calls here and in the reference's
    # second life, and only its launches count
    keys = ("loss", "grad_norm", "mean_ratio", "mean_reward")
    runs_b = {}
    build.reset_launches()
    for label in ("fault", "clean"):
        fault = label == "fault"
        plan = Measured("kill:ref@consume=2") if fault else None
        t0 = time.perf_counter()
        ctl, gens, trn, ref = ref_child_controller(
            torch, dev, cfg, plan, record=KernelCalls.NAMES if fault else None,
            ref_transport="proc" if fault else "inproc")
        if fault:
            ref.call("probe", reset=True)
            with KernelCalls(torch, per_shape=1) as rec_b:
                hist = ctl.run()
            parent_b = dict(build.LAUNCHES)
            replay_b = ref.call("replay", "(b) the reference, second life") \
                + rec_b.replay("(b) in process, the fault run", expect={
                    f"{n}_cuda" for n, c in parent_b.items() if c})
            del rec_b
        else:
            hist = ctl.run()
        runs_b[label] = (hist, ref.call("probe"), trn.call("probe"),
                         plan.before.get("ref") if plan else None,
                         ctl.supervisor.events())
        log(f"  (b) {label}: {len(hist)} steps in "
            f"{time.perf_counter() - t0:.1f} s: " + "; ".join(
                f"step {h['step']} loss {h['loss']:.6f} grad_norm "
                f"{h['grad_norm']:.5f}" for h in hist))
        close_all_actors()
        del ctl, gens, trn, ref
        gc.collect()
        torch.cuda.empty_cache()
    (hf, pf, tf, victim_b, ev_b), (hc, _, _, _, _) = \
        runs_b["fault"], runs_b["clean"]
    seed_print = tf["first_print"]
    launches.append(summed([parent_b, pf["launches"],
                            victim_b["probe"]["launches"]]))
    resp_b = [e for e in ev_b if e["event"] == "respawned"]
    log(f"  (b) the reference respawned in "
        f"{resp_b[0]['spawn_s'] if resp_b else float('nan'):.2f} s, "
        f"recovery_s {resp_b[0]['recovery_s'] if resp_b else float('nan'):.2f}"
        f", replayed version {resp_b[0].get('version') if resp_b else None}; "
        f"its second life's deliveries {pf['delivered']} (the trainer's "
        f"version-0 fingerprint {seed_print}); its launches "
        f"{pf['launches']}, the first life's {victim_b['probe']['launches']}"
        f", here {parent_b}")
    for line in replay_b:
        log(line)
    require([e["actor"] for e in resp_b] == ["ref"], f"(b) respawned {resp_b}")
    require(len(hf) == len(hc) == 3 and all(
        a[k] == b[k] for a, b in zip(hf, hc) for k in keys),
        "(b) the faulty run differs from the clean run")
    require(pf["delivered"] and pf["delivered"][0] == (0, seed_print),
            "(b) the respawned reference's first delivery is not the "
            "version-0 seed")
    require(pf["launches"].get("fused_logprob", 0) > 0,
            "(b) B1 did not run in the reference's second life")
    require(not pf["built"], f"(b) the respawned reference ran nvcc for "
            f"{pf['built']}")

    # (d) train_arithmetic_rl on the card, with checkpoints; every kernel
    # call of the first of its shapes held against its plain version
    ck = build_dir / "supervise_ckpt"
    if ck.exists():
        for f in ck.iterdir():
            f.unlink()
    build.reset_launches()
    t0 = time.perf_counter()
    with KernelCalls(torch, per_shape=1, names=KernelCalls.ENGINE) as rec_d:
        out = train_arithmetic_rl.main(["--steps", "50", "--eval-every",
                                        "25", "--device", str(dev),
                                        "--checkpoint-path", str(ck)])
    wall_d = time.perf_counter() - t0
    launched_d = dict(build.LAUNCHES)
    launches.append(launched_d)
    replay_d = rec_d.replay("(d)", expect={f"{n}_cuda" for n, c in
                                           launched_d.items() if c})
    del rec_d
    last = restore_checkpoint(str(ck / "trainer_49"), out["model"])
    same = all(torch.equal(a, b) for a, b in
               zip(leaves(last), leaves(out["model"])))
    log(f"  (d) train_arithmetic_rl --steps 50 --eval-every 25: "
        f"{wall_d:.1f} s; evals {out['evals']}; checkpoints "
        f"{sorted(p.name for p in ck.iterdir())}; the last restored "
        f"bit-equal to get_model: {same}; launches {launched_d}")
    for line in replay_d:
        log(line)
    require(len(out["evals"]) == 2 and len(out["history"]) == 50,
            "(d) eval lines or history")
    require(same, "(d) the last checkpoint differs from the trainer's model")
    require(all(math.isfinite(h["loss"]) for h in out["history"]),
            "(d) a loss is not finite")

    # (c) read the launcher runs
    for k, (proc, so, se, path, cmd) in procs.items():
        rc = proc.wait(timeout=600)
        so.close()
        se.close()
        stdout = (build_dir / f"supervise_{k}.stdout").read_text()
        if rc != 0:
            log(stdout[-4000:])
            log((build_dir / f"supervise_{k}.stderr").read_text()[-4000:])
        require(rc == 0, f"(c) {k}: the launcher exited {rc}")
        doc = json.loads(path.read_text())
        evs = [(e["event"], e["actor"]) for e in doc["events"]]
        producers = [h["generator"] for h in doc["history"]]
        printed = [ln for ln in stdout.splitlines()
                   if ln.startswith("supervisor:")]
        log(f"  (c) {k}: {' '.join(cmd[3:])}: exit {rc}; producers "
            f"{producers}; events {evs}")
        for ln in printed:
            log(f"  (c) {k} printed {ln}")
        require([h["step"] for h in doc["history"]] == list(range(6))
                and printed, f"(c) {k}: history or printed events")
        if k == "respawn":
            require(("respawned", "generator1") in evs
                    and producers == [f"generator{n % 2}"
                                      for n in range(6)],
                    f"(c) {k}: {evs}, {producers}")
        else:
            require(("lost", "generator1") in evs and producers ==
                    ["generator0", "generator1"] + ["generator0"] * 4
                    and [e["n_workers"] for e in doc["events"]
                         if e["event"] == "pool-resized"] == [1],
                    f"(c) {k}: {evs}, {producers}")
    log(f"  [14] {time.perf_counter() - t_phase:.1f} s")
    return summed(launches)


def ref_child_controller(torch, dev, cfg, plan, record=None,
                         ref_transport="proc"):
    """[14] (b)'s loop, the launcher's ``--kl-coef`` wiring: the generator
    (chunk scheduling) and the trainer threaded here, the frozen
    reference (seed 1) where ``ref_transport`` puts it with its weight
    channel, staleness 1, 3 steps, supervised with the fault plan
    ``plan``; the reference records the kernel calls of ``record``."""
    import functools

    from repro_torch.core import (CommType, CommunicationChannel,
                                  ExecutorController, RewardExecutor,
                                  Supervisor, WeightsCommunicationChannel,
                                  build_generator_pool, spawn_actor)
    from repro_torch.rl.data import ArithmeticTasks

    ref = spawn_actor(probed_executor, "reference", cfg,
                      ref_init=(1, torch.bfloat16, dev), record=record,
                      transport=ref_transport)
    rew = RewardExecutor(n_per_prompt=N_PER, leave_one_out=True)
    trn = spawn_actor(probed_executor, "trainer", cfg, dtype=torch.bfloat16,
                      kl_coef=KL_COEF, seed=0, device=dev,
                      transport="inproc")
    gens, chans = build_generator_pool(
        cfg, trn, lambda g: ArithmeticTasks(prompt_len=16, seed=g),
        n_generators=1,
        generator_cls=functools.partial(probed_executor, "generator"),
        n_prompts=N_PROMPTS, n_per_prompt=N_PER, max_new=MAX_NEW,
        chunk=CHUNK, temperature=1.0, device=dev, transport="inproc")
    chans += [
        WeightsCommunicationChannel("policy_model", trn, ref),
        CommunicationChannel("completions", gens[0], ref, CommType.BROADCAST),
        CommunicationChannel("completions_with_ref", ref, rew,
                             CommType.GATHER),
        CommunicationChannel("completions_with_reward", rew, trn,
                             CommType.SCATTER)]
    ctl = ExecutorController(gens + [ref, rew, trn], chans, max_steps=3,
                             mode="async", staleness=1, timeout=900.0,
                             supervise=Supervisor(chaos=plan))
    return ctl, gens, trn, ref


# ---------------------------------------------------- [15] windowed family --

# [15]: starcoder2-3b serves prompts past its native 4096-token window
WINDOW_ARCH = "starcoder2-3b"
WINDOW_PROMPT = 4160
# the paged engine's pool in (a): 2 batches of 16 rows through 16 slots, so
# rows join mid-decode
WINDOW_ENGINE_ROWS = 16
# (d): the windowed archs with beyond-paper windows, at their published
# widths and 2 layers each (none fits one card at full depth)
WINDOW_OTHERS = ("command-r-35b", "deepseek-67b", "nemotron-4-340b")
OTHER_LAYERS = 2
OTHER_PROMPT, OTHER_NEW = 64, 16


def cut_line(cfg_full, cfg_cut) -> str:
    """The params and bf16 bytes of a config at its published depth and
    at the depth it was cut to."""
    from repro_torch.configs import param_count
    full, cut = param_count(cfg_full)[0], param_count(cfg_cut)[0]
    return (f"{cfg_full.n_layers} layers {full / 1e9:.2f} B params "
            f"({2 * full / 1e9:.1f} GB bf16) cut to {cfg_cut.n_layers}: "
            f"{cut / 1e9:.2f} B ({2 * cut / 1e9:.1f} GB)")


def windowed_serve(torch, dev, calls):
    """[15] (a): starcoder2-3b at full width and depth, bf16, prompts of
    WINDOW_PROMPT ids: batch rollouts scored by the reference, then the
    paged engine.  Returns the launch counts of its runs."""
    from repro_torch import configs
    from repro_torch.core.executor import GeneratorExecutor, \
        RefPolicyExecutor, RewardExecutor
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import chunked_attention
    from repro_torch.models import init_params
    from repro_torch.rl import engine as engine_mod
    from repro_torch.rl.data import ArithmeticTasks

    cfg = configs.get_config(WINDOW_ARCH)
    W, L = cfg.window, cfg.n_layers
    B = N_PROMPTS * N_PER
    log(f"  (a) serve {cfg.name} at full width and depth ({L} layers, d "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, hd {cfg.hd},"
        f" V {cfg.vocab}, window {W}), bf16; {N_PROMPTS} prompts x {N_PER}"
        f" samples of {WINDOW_PROMPT} ids, {MAX_NEW} new tokens in chunks "
        f"of {CHUNK}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in leaves(params))
    log(f"  init: {n / 1e9:.3f} B params, {2 * n / 1e9:.2f} GB, "
        f"{time.perf_counter() - t0:.1f} s")
    tasks = ArithmeticTasks(prompt_len=WINDOW_PROMPT, seed=0)
    gen = GeneratorExecutor(cfg, tasks, n_prompts=N_PROMPTS,
                            n_per_prompt=N_PER, max_new=MAX_NEW,
                            chunk=CHUNK, temperature=1.0, seed=0,
                            device=dev)
    gen.set_weights(params, version=0)
    ref = RefPolicyExecutor(cfg)
    ref.set_weights(params)
    rew = RewardExecutor(n_per_prompt=N_PER, leave_one_out=True)
    total = collections.Counter()

    # one batch through the generator's own hooks (what ``step`` and the
    # pool run), timed apart: the prefill wraps the rings, every decode
    # chunk wraps them further; the last chunk runs under the profiler
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()          # the batch rollout's run starts here
    t0 = time.perf_counter()
    job, state = gen.begin_batch()
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    ring = state.cache["segments"][0]
    sp = ring["slot_pos"]
    require(len(state.cache["segments"]) == 1 and ring["k"].shape[2] == W,
            f"ring of {ring['k'].shape[2]} slots, want {W}")
    require(sp.min().item() == WINDOW_PROMPT - W
            and sp.max().item() == WINDOW_PROMPT - 1
            and sp[0].item() == W, "the prefilled ring does not hold the "
            "last W positions at pos % W")
    walls = []
    for c in range(job.n_chunks):
        t0 = time.perf_counter()
        state = gen.advance_chunk(job, state)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    decode_ms = statistics.median(walls) * 1e3 / CHUNK
    # PROFILED_STEPS decode steps on a copy of the wrapped rings, not a
    # whole chunk: the profiler's bookkeeping grows with the host
    # operations it records
    busy_share(torch, lambda: profiled_decode(
        torch, lambda _, steps: steps(), params, cfg, state.cache,
        state.tokens[:, -1:]), PROFILED_STEPS, decode_ms)
    end = WINDOW_PROMPT + MAX_NEW
    require(sp[(end - 1) % W].item() == end - 1 and sp.min().item() == end - W,
            "decode did not wrap the rings")
    out = gen.emit_batch(job, state)
    t0 = time.perf_counter()
    ref.put_input("completions", out)
    ref.step()
    torch.cuda.synchronize()
    t_ref = time.perf_counter() - t0
    rew.put_input("completions_with_ref", ref.get_output("completions_with_ref"))
    out = rew.step()
    launches = dict(build.LAUNCHES)  # ... and ends here
    total.update(launches)
    want = {"fused_sample": MAX_NEW, "fused_logprob": 1}
    require(launches == want, f"windowed rollout launch counts {launches}, "
            f"want {want} (windowed prefill and the reference's windowed "
            "forward go to chunked_attention, as the reference routes "
            "them)")
    d = _check_outputs(torch, out, cfg.vocab)
    # the plain windowed attention's share of the prefill: the layers'
    # chunked_attention at the prefill's shapes, timed alone
    g = torch.Generator(device=dev).manual_seed(3)
    q = torch.randn(B, WINDOW_PROMPT, cfg.n_heads, cfg.hd, generator=g,
                    device=dev).to(torch.bfloat16)
    k = torch.randn(B, WINDOW_PROMPT, cfg.n_kv_heads, cfg.hd, generator=g,
                    device=dev).to(torch.bfloat16)
    attn_ms = cuda_ms(torch, lambda: chunked_attention(q, k, k, window=W),
                      2)
    del q, k
    log(f"  prefill [{B}, {WINDOW_PROMPT}]: {prefill_ms:.1f} ms, of which "
        f"the plain windowed chunked_attention takes about {L} x "
        f"{attn_ms:.1f} = {L * attn_ms:.1f} ms "
        f"({100 * L * attn_ms / prefill_ms:.1f}%); decode {decode_ms:.2f} "
        f"ms per token (batch {B}, median of {len(walls)} unprofiled "
        f"chunks; rings of {W} slots wrapped: slot 0 holds position "
        f"{sp[0].item()}); reference {t_ref * 1e3:.1f} ms over [{B}, "
        f"{end}] (windowed); |behavior_logp - ref_logp| at {d.numel()} "
        f"actions (bf16): mean {d.mean().item():.4f}, max "
        f"{d.max().item():.4f}; launches {launches}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del job, state, ring, sp, out

    # the paged engine: 2 batches through WINDOW_ENGINE_ROWS slots
    torch.cuda.reset_peak_memory_stats()
    gen.engine_configure(kv_layout="paged", kv_page_size=ENGINE_PAGE,
                         max_running_rows=WINDOW_ENGINE_ROWS,
                         row_budgets=ENGINE_BUDGETS)
    for b in range(2):
        gen.engine_enqueue(b, bound=0)
    items = []
    t0 = time.perf_counter()
    with timed_decode(torch, engine_mod) as timer:
        build.reset_launches()      # the engine's run starts here
        for _ in range(40):
            items += gen.engine_round(["completions"])
            if len(items) == 2:
                break
        torch.cuda.synchronize()
        launches = dict(build.LAUNCHES)  # ... and ends here
    wall = time.perf_counter() - t0
    total.update(launches)
    st = gen.engine_stats()
    rounds = timer.rounds
    want = {"paged_attention": L * CHUNK * rounds,
            "fused_sample": CHUNK * rounds}
    require(len(items) == 2 and launches == want,
            f"windowed engine: {len(items)} batches, launches {launches}, "
            f"want {want} (radix misses prefill through chunked_attention)")
    require(st["rows_admitted"] == 2 * B and st["radix_hits"] > 0
            and st["staleness_violations"] == 0 and st["running"] == 0
            and rounds > max(ENGINE_BUDGETS), f"engine stats {st}, "
            f"{rounds} rounds")
    decode = statistics.median(w / CHUNK * 1e3 for w in timer.wall)
    log(f"  paged engine (page {ENGINE_PAGE}, {WINDOW_ENGINE_ROWS} slots, "
        f"2 batches, budgets {ENGINE_BUDGETS}): {rounds} rounds in "
        f"{wall:.2f} s, decode {decode:.2f} ms per token (median); "
        f"admitted {st['rows_admitted']}, radix hits {st['radix_hits']} / "
        f"misses {st['radix_misses']}, pages in use {st['pages_in_use']} of"
        f" {st['pages_total']}; launches {launches}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    windows = {kw.get("window") for _, kw, _ in
               calls.calls["paged_attention_cuda"]}
    require(windows == {W}, f"paged_attention windows {windows}, want {W}")
    d = score_engine(torch, cfg, params, [items[0]["snapshot"]
                                          ["completions"]])
    log(f"  the first engine batch scored: |behavior_logp - ref_logp| at "
        f"{d.numel()} actions (bf16): mean {d.mean().item():.4f}, max "
        f"{d.max().item():.4f}")
    gen.engine_abort()
    del gen, ref, rew, items, params
    gc.collect()
    torch.cuda.empty_cache()
    return total


def windowed_train(torch, dev):
    """[15] (b): two steps of the sequential async loop for starcoder2-3b
    at full width; sequences inside the window, so the segments merge and
    the trainer and the reference run B4, B1 and B2.  Returns the launch
    counts."""
    from repro_torch import configs
    from repro_torch.core.channels import CommType, CommunicationChannel, \
        WeightsCommunicationChannel
    from repro_torch.core.controller import SyncExecutorController
    from repro_torch.core.executor import GeneratorExecutor, \
        RefPolicyExecutor, RewardExecutor, TrainerExecutor
    from repro_torch.kernels import build
    from repro_torch.models import init_params
    from repro_torch.rl.data import ArithmeticTasks

    cfg = configs.get_config(WINDOW_ARCH)
    n_steps = 2
    torch.cuda.reset_peak_memory_stats()
    gen = GeneratorExecutor(cfg, ArithmeticTasks(seed=0),
                            n_prompts=N_PROMPTS, n_per_prompt=N_PER,
                            max_new=MAX_NEW, chunk=CHUNK, temperature=1.0,
                            seed=0, device=dev)
    ref = RefPolicyExecutor(cfg)
    ref.set_weights(init_params(cfg, seed=1, dtype=torch.bfloat16,
                                device=dev))
    rew = RewardExecutor(n_per_prompt=N_PER, leave_one_out=True)
    trn = TrainerExecutor(cfg, dtype=torch.bfloat16, kl_coef=KL_COEF,
                          seed=0, device=dev)
    ctl = SyncExecutorController(
        [gen, ref, rew, trn],
        [WeightsCommunicationChannel("policy_model", trn, gen),
         CommunicationChannel("completions", gen, ref, CommType.BROADCAST),
         CommunicationChannel("completions_with_ref", ref, rew,
                              CommType.GATHER),
         CommunicationChannel("completions_with_reward", rew, trn,
                              CommType.SCATTER)],
        max_steps=n_steps, mode="async", staleness=1)
    ctl.init()
    n = sum(t.numel() for t in leaves(trn.get_model()))
    seq = gen.tasks.prompt_len + MAX_NEW
    log(f"  (b) train {cfg.name} at full width and depth ({cfg.n_layers} "
        f"layers): {n / 1e9:.3f} B params, trainer state {12 * n / 1e9:.1f}"
        f" GB; {n_steps} steps of the async schedule, staleness 1, KL "
        f"{KL_COEF}; sequences of {seq} <= window {cfg.window}")
    fp_init = fingerprint(torch, trn.get_model())
    t0 = time.perf_counter()
    build.reset_launches()          # the train path's run starts here
    history = ctl.run()
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)  # ... and ends here
    wall = time.perf_counter() - t0
    for h in history:
        log(f"  step {h['step']}: loss {h['loss']:.5f}, grad_norm "
            f"{h['grad_norm']:.4f}, weight_version {h['weight_version']}")
        require(h["weight_version"] == max(0, h["step"] - 1)
                and math.isfinite(h["loss"])
                and math.isfinite(h["grad_norm"]), f"step {h}")
    require(fingerprint(torch, trn.get_model()) != fp_init,
            "the params did not move")
    L = cfg.n_layers
    want = {"fused_sample": n_steps * MAX_NEW,
            "flash_attention": n_steps * 2 * L,
            "fused_logprob": 2 * n_steps, "fused_logprob_bwd": n_steps}
    require(launches == want, f"windowed train launch counts {launches}, "
            f"want {want} (per step: the reference's and the trainer's "
            "merged forward through flash_attention; the generator's "
            "windowed prefill through chunked_attention)")
    log(f"  {n_steps} steps in {wall:.1f} s; launches {launches}; peak "
        f"memory allocated {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del ctl, gen, ref, rew, trn
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def windowed_numerics(torch, dev):
    """[15] (c): starcoder2-3b widths, 2 layers, fp32, window 4096:
    decode through the wrapped ring against the teacher-forced windowed
    forward_train (2e-3), then the paged engine's behaviour log-probs
    against the reference's (1e-3).  Returns the engine's launch
    counts."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.core.executor import GeneratorExecutor
    from repro_torch.kernels import build
    from repro_torch.models import decode_step, forward_train, \
        init_params, prefill
    from repro_torch.rl.data import ArithmeticTasks

    full = configs.get_config(WINDOW_ARCH)
    cfg = full.replace(name=f"{full.name}-2l", n_layers=2)
    W = cfg.window
    params = init_params(cfg, seed=5, dtype=torch.float32, device=dev)
    S, n = W + 6, 8
    ids = np.random.default_rng(5).integers(0, cfg.vocab, (2, S + n))
    toks = torch.as_tensor(ids, dtype=torch.int32, device=dev)
    with torch.no_grad():
        full_logits, _ = forward_train(params, cfg, {"tokens": toks})
        _, cache = prefill(params, cfg, {"tokens": toks[:, :S]},
                           cache_len=S + n, dtype=torch.float32)
        require(cache["segments"][0]["k"].shape[2] == W, "ring size")
        err = 0.0
        for i in range(n):
            lg, cache = decode_step(params, cfg, cache, toks[:, S + i:S + i + 1])
            err = max(err, max_err(lg, full_logits[:, S + i]))
    del full_logits
    log(f"  (c) {cfg.name} fp32, window {W}: decode of {n} tokens through "
        f"the wrapped ring after a {S}-token prefill against the "
        f"teacher-forced windowed forward_train: max|dlogits| {err:.3e} "
        "(tolerance 2e-3)")
    require(err <= 2e-3, "ring decode against the windowed forward")

    # one prompt x 4 samples: the reference's fp32 logits of [4, 4224,
    # 49152] take 3.3 GB, and every kernel call is recorded
    gen = GeneratorExecutor(cfg, ArithmeticTasks(prompt_len=WINDOW_PROMPT,
                                                 seed=5),
                            n_prompts=1, n_per_prompt=N_PER,
                            max_new=MAX_NEW, chunk=CHUNK, temperature=1.0,
                            seed=5, device=dev)
    gen.set_weights(params, version=0)
    gen.engine_configure(kv_layout="paged", kv_page_size=ENGINE_PAGE,
                         row_budgets=ENGINE_BUDGETS)
    gen.engine_enqueue(0, bound=0)
    items = []
    build.reset_launches()          # the engine's run starts here
    for _ in range(40):
        items += gen.engine_round(["completions"])
        if items:
            break
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)  # ... and ends here
    require(len(items) == 1 and launches.get("paged_attention", 0) > 0,
            f"fp32 windowed engine: {len(items)} batches, {launches}")
    d = score_engine(torch, cfg, params, [items[0]["snapshot"]
                                          ["completions"]])
    log(f"  fp32 paged engine, prompts of {WINDOW_PROMPT}: "
        f"|behavior_logp - ref_logp| at {d.numel()} actions: max "
        f"{d.max().item():.2e} (tolerance 1e-3); launches {launches}")
    require(d.max().item() <= 1e-3, "fp32 windowed engine mu vs reference")
    gen.engine_abort()
    del gen, params, items
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def windowed_others(torch, dev):
    """[15] (d): command-r-35b, deepseek-67b and nemotron-4-340b at their
    published widths, 2 layers, bf16: one batch rollout and one paged
    engine round each; the reference scores every rollout (nemotron's
    merged forward runs B4 at hd 192).  Returns the launch counts."""
    from repro_torch import configs
    from repro_torch.core.executor import GeneratorExecutor, \
        RefPolicyExecutor
    from repro_torch.kernels import build
    from repro_torch.models import init_params
    from repro_torch.rl.data import ArithmeticTasks

    total = collections.Counter()
    for arch in WINDOW_OTHERS:
        full = configs.get_config(arch)
        cfg = full.replace(name=f"{arch}-{OTHER_LAYERS}l",
                           n_layers=OTHER_LAYERS)
        t0 = time.perf_counter()
        params = init_params(cfg, seed=7, dtype=torch.bfloat16, device=dev)
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
        gen = GeneratorExecutor(cfg, ArithmeticTasks(prompt_len=OTHER_PROMPT,
                                                     seed=7),
                                n_prompts=1, n_per_prompt=4,
                                max_new=OTHER_NEW, chunk=OTHER_NEW,
                                temperature=1.0, seed=7, device=dev)
        gen.set_weights(params, version=0)
        build.reset_launches()      # this arch's run starts here
        out = gen.step()
        ref = RefPolicyExecutor(cfg)
        ref.set_weights(params)
        ref.put_input("completions", out)
        out = ref.step()
        gen.engine_configure(kv_layout="paged", kv_page_size=ENGINE_PAGE)
        gen.engine_enqueue(0, bound=0)
        items = gen.engine_round(["completions"])
        torch.cuda.synchronize()
        launches = dict(build.LAUNCHES)  # ... and ends here
        total.update(launches)
        want = {"fused_sample": 2 * OTHER_NEW,
                "paged_attention": OTHER_LAYERS * OTHER_NEW,
                "fused_logprob": 1, "flash_attention": OTHER_LAYERS}
        require(len(items) == 1 and launches == want,
                f"{cfg.name}: {len(items)} batches, launches {launches}, "
                f"want {want}")
        d = _check_outputs(torch, out, cfg.vocab)
        scored = f"|mu - ref| max {d.max().item():.4f} (bf16)"
        log(f"  (d) {arch}: {cut_line(full, cfg)}; hd {cfg.hd}, "
            f"{cfg.n_heads}/{cfg.n_kv_heads} heads, V {cfg.vocab}"
            + (", tied head" if cfg.tie_embeddings else "")
            + f", act {cfg.act}; init {t_init:.1f} s; rollout [4, "
            f"{OTHER_PROMPT} + {OTHER_NEW}] and one engine round: "
            f"launches {launches}; {scored}")
        gen.engine_abort()
        del gen, ref, params, out, items
        gc.collect()
        torch.cuda.empty_cache()
    return total


def phase_windowed(torch, dev):
    """[15]: the windowed dense family.  Returns the launch counts of its
    main-path runs."""
    log(f"[15] windowed: {WINDOW_ARCH} past its window, and "
        f"{', '.join(WINDOW_OTHERS)} at {OTHER_LAYERS} layers; "
        f"{nvidia_smi()}")
    t0 = time.perf_counter()
    launches = collections.Counter()
    with KernelCalls(torch, per_shape=1, names=KernelCalls.ENGINE) as calls:
        launches.update(windowed_serve(torch, dev, calls))
    for line in calls.replay("[15] (a)", expect=(
            "fused_sample_cuda", "fused_logprob_cuda",
            "paged_attention_cuda")):
        log(line)
    del calls
    with KernelCalls(torch, per_shape=1) as calls:
        launches.update(windowed_train(torch, dev))
    for line in calls.replay("[15] (b)"):
        log(line)
    del calls
    with KernelCalls(torch, names=KernelCalls.ENGINE) as calls:
        launches.update(windowed_numerics(torch, dev))
    for line in calls.replay("[15] (c)", expect=(
            "fused_sample_cuda", "fused_logprob_cuda",
            "paged_attention_cuda")):
        log(line)
    del calls
    with KernelCalls(torch, names=KernelCalls.ENGINE) as calls:
        launches.update(windowed_others(torch, dev))
    for line in calls.replay("[15] (d)", expect=(
            "fused_sample_cuda", "fused_logprob_cuda",
            "flash_attention_cuda", "paged_attention_cuda")):
        log(line)
    shapes = {tuple(args[0].shape) for args, _, _ in
              calls.calls["paged_attention_cuda"]}
    require(any(s[-1] == 192 for s in shapes), "B5 never ran at hd 192")
    shapes = {tuple(args[0].shape) for args, _, _ in
              calls.calls["flash_attention_cuda"]}
    require(any(s[-1] == 192 for s in shapes), "B4 never ran at hd 192")
    V = {args[0].shape[-1] for args, _, _ in
         calls.calls["fused_sample_cuda"]}
    require(256000 in V, "B3 never ran at V 256000")
    del calls
    launches = dict(launches)
    for name in KERNELS[:5]:
        require(launches.get(name, 0) > 0, f"{name} never ran in [15]")
    log(f"  [15] launches {launches}; {time.perf_counter() - t0:.1f} s")
    return launches


# --------------------------------------------------------- [16] MoE family --

# [16]: llama4-scout-17b-a16e at its published widths
MOE_ARCH = "llama4-scout-17b-a16e"
# (a): one iRoPE period, layers 0-2 windowed at 8192 and layer 3 global
MOE_LAYERS = 4
MOE_PROMPT, MOE_NEW = 256, 32
# (b): one layer, 4.27 B params, 51.2 GB of bf16 params and grads and
# fp32 Adam moments
MOE_TRAIN_LAYERS = 1
# (c): prompts past the smoke config's 64-token window
MOE_SMOKE_PROMPT = 80


def flash_layers(cfg, seq_len: int = 0) -> int:
    """The layers whose attention goes to the flash kernel: unwindowed
    ones, and with ``seq_len`` (a merged forward) those whose window is
    no shorter than the sequence."""
    from repro_torch.models import backbone as bb
    return sum(j - i for _, n, off in bb.layer_stacks(cfg)
               for i, j, w in bb._segment_windows(cfg, n, off, seq_len)
               if not w)


def ranges_profile(torch, fn, labelled):
    """One profiled call of ``fn``, every call of each ``(module, function
    name)`` of ``labelled[label]`` inside a ``label`` range.  Returns
    (device busy ms, {label: the range's device ms}, device operations
    largest first)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    real = [(label, mod, name, getattr(mod, name))
            for label, targets in labelled.items() for mod, name in targets]

    def ranged(f, label):
        def call(*args, **kwargs):
            with record_function(label):
                return f(*args, **kwargs)
        return call
    for label, mod, name, f in real:
        setattr(mod, name, ranged(f, label))
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    finally:
        for _, mod, name, f in real:
            setattr(mod, name, f)
    ops = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA
           and e.self_device_time_total > 0 and e.key not in labelled]
    busy = sum(e.self_device_time_total for e in ops) / 1e3
    ranged_ms = {label: sum(e.device_time_total for e in prof.events()
                            if e.name == label
                            and e.device_type == DeviceType.CPU) / 1e3
                 for label in labelled}
    return busy, ranged_ms, sorted(ops,
                                   key=lambda e: -e.self_device_time_total)


def range_profile(torch, fn, label: str, targets):
    """``ranges_profile`` with one range: (device busy ms, the range's
    device ms, device operations largest first)."""
    busy, ranged_ms, ops = ranges_profile(torch, fn, {label: targets})
    return busy, ranged_ms[label], ops


def moe_profile(torch, fn):
    """One profiled call of ``fn``, every MoE FFN call (router, dispatch,
    expert products, combine, shared expert) inside a ``moe_ffn`` range.
    Returns (device busy ms, the MoE FFN's device ms, device operations
    largest first)."""
    from repro_torch.models import ffn
    return range_profile(torch, fn, "moe_ffn", [(ffn, "moe_forward")])


def moe_serve(torch, dev, calls):
    """[16] (a): llama4-scout at full width, MOE_LAYERS layers, bf16: a
    batch rollout scored by the reference, then the paged engine.
    Returns the launch counts of its runs."""
    from repro_torch import configs
    from repro_torch.core.executor import GeneratorExecutor, \
        RefPolicyExecutor, RewardExecutor
    from repro_torch.kernels import build
    from repro_torch.models import ffn, init_params
    from repro_torch.rl import engine as engine_mod
    from repro_torch.rl.data import ArithmeticTasks

    full = configs.get_config(MOE_ARCH)
    cfg = full.replace(name=f"{MOE_ARCH}-{MOE_LAYERS}l", n_layers=MOE_LAYERS)
    m, L, W = cfg.moe, cfg.n_layers, cfg.window
    n_global = flash_layers(cfg)
    B = N_PROMPTS * N_PER
    C = max(int(MOE_PROMPT * m.top_k / m.n_experts * m.capacity_factor), 1)
    log(f"  (a) serve {MOE_ARCH} at full width (d {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads, hd {cfg.hd}, "
        f"{m.n_experts} experts of d {m.d_expert}, top-{m.top_k} "
        f"{m.router}, {m.n_shared} shared, V {cfg.vocab}, window {W} in "
        f"{cfg.window_pattern - 1} of every {cfg.window_pattern} layers): "
        f"{cut_line(full, cfg)}; bf16; {N_PROMPTS} prompts x {N_PER} "
        f"samples of {MOE_PROMPT} ids, {MOE_NEW} new tokens in chunks of "
        f"{CHUNK}; prefill capacity {C} a group and expert")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in leaves(params))
    log(f"  init: {n / 1e9:.3f} B params, {2 * n / 1e9:.2f} GB, "
        f"{time.perf_counter() - t0:.1f} s, peak memory allocated "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB (each expert "
        "leaf drawn in fp32 before the cast)")
    gen = GeneratorExecutor(cfg, ArithmeticTasks(prompt_len=MOE_PROMPT,
                                                 seed=0),
                            n_prompts=N_PROMPTS, n_per_prompt=N_PER,
                            max_new=MOE_NEW, chunk=CHUNK, temperature=1.0,
                            seed=0, device=dev)
    gen.set_weights(params, version=0)
    ref = RefPolicyExecutor(cfg)
    ref.set_weights(params)
    rew = RewardExecutor(n_per_prompt=N_PER, leave_one_out=True)
    total = collections.Counter()

    # one batch through the generator's own hooks, timed apart: a first
    # prefill (the new shapes' first launches), whose dispatch masks give
    # the share capacity drops, then the timed one that decodes
    valid = []
    real_dispatch = ffn._dispatch_group

    def kept(*args, **kwargs):
        out = real_dispatch(*args, **kwargs)
        valid.append(out[2])
        return out
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()          # the batch rollout's run starts here
    ffn._dispatch_group = kept
    try:
        t0 = time.perf_counter()
        job, state = gen.begin_batch()
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
    finally:
        ffn._dispatch_group = real_dispatch
    require(len(valid) == L and all(v.shape == (B, MOE_PROMPT)
                                    for v in valid),
            f"prefill dispatches {[tuple(v.shape) for v in valid]}")
    dropped = [1.0 - v.float().mean().item() for v in valid]
    del valid, job, state
    t0 = time.perf_counter()
    job, state = gen.begin_batch()
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    state = gen.advance_chunk(job, state)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3 / CHUNK
    box = []
    busy, moe_ms, ops = moe_profile(
        torch, lambda: box.append(gen.advance_chunk(job, state)))
    state = box[0]
    out = gen.emit_batch(job, state)
    t0 = time.perf_counter()
    ref.put_input("completions", out)
    ref.step()
    torch.cuda.synchronize()
    t_ref = time.perf_counter() - t0
    rew.put_input("completions_with_ref", ref.get_output("completions_with_ref"))
    out = rew.step()
    launches = dict(build.LAUNCHES)  # ... and ends here
    total.update(launches)
    want = {"fused_sample": MOE_NEW, "fused_logprob": 1,
            "flash_attention": 2 * n_global
            + flash_layers(cfg, MOE_PROMPT + MOE_NEW)}
    require(launches == want, f"moe rollout launch counts {launches}, "
            f"want {want} (each of two prefills: flash_attention in the "
            "global layer only, the windowed layers through "
            "chunked_attention; the "
            "reference's merged forward: flash_attention in every layer)")
    d = _check_outputs(torch, out, cfg.vocab)
    log(f"  prefill [{B}, {MOE_PROMPT}]: {prefill_ms:.1f} ms (the first "
        f"{first_ms:.1f} ms); capacity "
        f"dropped {', '.join(f'{100 * x:.2f}' for x in dropped)}% of the "
        f"prefill's choices in layers 0-{L - 1}; decode {decode_ms:.2f} ms "
        f"per token (batch {B}, one unprofiled chunk); reference "
        f"{t_ref * 1e3:.1f} ms over [{B}, {MOE_PROMPT + MOE_NEW}]; "
        f"|behavior_logp - ref_logp| at {d.numel()} actions (bf16): mean "
        f"{d.mean().item():.4f}, max {d.max().item():.4f}; launches "
        f"{launches}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    busy /= CHUNK
    log(f"  profiled chunk: device busy {busy:.2f} ms per token = "
        f"{100 * busy / decode_ms:.1f}% of the unprofiled {decode_ms:.2f} "
        f"ms; the MoE FFN (router, dispatch, expert products, combine, "
        f"shared expert) {moe_ms / CHUNK:.2f} ms per token = "
        + (f"{100 * moe_ms / CHUNK / busy:.1f}%" if busy else "not measured")
        + " of the device time; top device operations (ms per token): "
        + ", ".join(f"{e.key[:48]} {e.self_device_time_total / 1e3 / CHUNK:.3f}"
                    for e in ops[:6]))
    del job, state, out, box

    # the paged engine: 2 batches through B slots, rows joining mid-decode
    torch.cuda.reset_peak_memory_stats()
    gen.engine_configure(kv_layout="paged", kv_page_size=ENGINE_PAGE,
                         max_running_rows=B, row_budgets=ENGINE_BUDGETS)
    for b in range(2):
        gen.engine_enqueue(b, bound=0)
    items = []
    t0 = time.perf_counter()
    with timed_decode(torch, engine_mod) as timer:
        build.reset_launches()      # the engine's run starts here
        for _ in range(40):
            items += gen.engine_round(["completions"])
            if len(items) == 2:
                break
        torch.cuda.synchronize()
        launches = dict(build.LAUNCHES)  # ... and ends here
    wall = time.perf_counter() - t0
    total.update(launches)
    st = gen.engine_stats()
    rounds = timer.rounds
    want = {"paged_attention": L * CHUNK * rounds,
            "fused_sample": CHUNK * rounds,
            "flash_attention": n_global * st["radix_misses"]}
    require(len(items) == 2 and launches == want,
            f"moe engine: {len(items)} batches, launches {launches}, want "
            f"{want} (a radix miss prefills its global layer through "
            "flash_attention, a hit's suffix and the windowed layers "
            "through chunked_attention)")
    require(st["rows_admitted"] == 2 * B and st["radix_hits"] > 0
            and st["staleness_violations"] == 0 and st["running"] == 0,
            f"engine stats {st}")
    decode = statistics.median(w / CHUNK * 1e3 for w in timer.wall)
    log(f"  paged engine (page {ENGINE_PAGE}, {B} slots, 2 batches, "
        f"budgets {ENGINE_BUDGETS}): {rounds} rounds in {wall:.2f} s, "
        f"decode {decode:.2f} ms per token (median); admitted "
        f"{st['rows_admitted']}, radix hits {st['radix_hits']} / misses "
        f"{st['radix_misses']}; launches {launches}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    windows = {kw.get("window") for _, kw, _ in
               calls.calls["paged_attention_cuda"]}
    require(windows == {W, 0}, f"paged_attention windows {windows}, want "
            f"{W} and 0")
    d = score_engine(torch, cfg, params, [items[0]["snapshot"]
                                          ["completions"]])
    log(f"  the first engine batch scored: |behavior_logp - ref_logp| at "
        f"{d.numel()} actions (bf16): mean {d.mean().item():.4f}, max "
        f"{d.max().item():.4f}")
    gen.engine_abort()
    del gen, ref, rew, items, params
    gc.collect()
    torch.cuda.empty_cache()
    return total


def moe_train(torch, dev):
    """[16] (b): two steps of the sequential async loop at full width and
    MOE_TRAIN_LAYERS layer, sequences inside the window (merged segments:
    B4, B1 and B2), the MoE aux in the loss.  KL 0.1 against a reference
    that takes the trainer's weights through a weights channel of its
    own, as the launcher wires it, so it shares the generator's version
    and adds no copy.  Returns the launch counts."""
    from repro_torch import configs
    from repro_torch.core.channels import CommType, CommunicationChannel, \
        WeightsCommunicationChannel
    from repro_torch.core.controller import SyncExecutorController
    from repro_torch.core.executor import GeneratorExecutor, \
        RefPolicyExecutor, RewardExecutor, TrainerExecutor
    from repro_torch.kernels import build
    from repro_torch.rl.data import ArithmeticTasks

    full = configs.get_config(MOE_ARCH)
    cfg = full.replace(name=f"{MOE_ARCH}-{MOE_TRAIN_LAYERS}l",
                       n_layers=MOE_TRAIN_LAYERS)
    n_steps = 2
    torch.cuda.reset_peak_memory_stats()
    gen = GeneratorExecutor(cfg, ArithmeticTasks(seed=0),
                            n_prompts=N_PROMPTS, n_per_prompt=N_PER,
                            max_new=MAX_NEW, chunk=CHUNK, temperature=1.0,
                            seed=0, device=dev)
    ref = RefPolicyExecutor(cfg)
    rew = RewardExecutor(n_per_prompt=N_PER, leave_one_out=True)
    trn = TrainerExecutor(cfg, dtype=torch.bfloat16, kl_coef=KL_COEF,
                          seed=0, device=dev)
    ctl = SyncExecutorController(
        [gen, ref, rew, trn],
        [WeightsCommunicationChannel("policy_model", trn, gen),
         WeightsCommunicationChannel("policy_model", trn, ref),
         CommunicationChannel("completions", gen, ref, CommType.BROADCAST),
         CommunicationChannel("completions_with_ref", ref, rew,
                              CommType.GATHER),
         CommunicationChannel("completions_with_reward", rew, trn,
                              CommType.SCATTER)],
        max_steps=n_steps, mode="async", staleness=1)
    ctl.init()
    params = trn.get_model()
    n = sum(t.numel() for t in leaves(params))
    big = max(t.numel() for t in leaves(params))
    seq = gen.tasks.prompt_len + MAX_NEW
    log(f"  (b) train {MOE_ARCH} at full width, {MOE_TRAIN_LAYERS} of "
        f"{full.n_layers} layers: {n / 1e9:.3f} B params; reckoned peak "
        f"{12 * n / 1e9:.1f} GB of trainer state + {2 * n / 1e9:.1f} GB "
        f"for the version the generator and the reference share + "
        f"{2 * n / 1e9:.1f} GB for the version Adam builds + "
        f"{3 * 4 * big / 1e9:.1f} GB of Adam's fp32 temporaries on the "
        f"largest leaf = {(16 * n + 12 * big) / 1e9:.1f} GB; {n_steps} "
        f"steps of the async schedule, staleness 1, KL {KL_COEF}; "
        f"sequences of {seq} <= window {cfg.window}")
    moe = params["moe_layers"]["moe"]
    router0 = moe["w_router"].clone()
    experts0 = {k: fingerprint(torch, {k: moe[k]})
                for k in ("w_gate", "w_up", "w_down")}
    del params, moe
    t0 = time.perf_counter()
    build.reset_launches()          # the train path's run starts here
    history = ctl.run()
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)  # ... and ends here
    wall = time.perf_counter() - t0
    for h in history:
        log(f"  step {h['step']}: loss {h['loss']:.5f}, moe_aux "
            f"{h['moe_aux']:.6f}, grad_norm {h['grad_norm']:.4f}, "
            f"weight_version {h['weight_version']}")
        require(h["weight_version"] == max(0, h["step"] - 1)
                and math.isfinite(h["loss"]) and h["moe_aux"] > 0
                and math.isfinite(h["grad_norm"]), f"step {h}")
    moe = trn.get_model()["moe_layers"]["moe"]
    moved = [k for k in experts0
             if fingerprint(torch, {k: moe[k]}) != experts0[k]]
    router_moved = (moe["w_router"] - router0).abs().max().item()
    require(router_moved > 0 and moe["w_router"].dtype == torch.float32,
            "the router did not move, or is not fp32")
    require(moved, "no expert leaf moved")
    want = {k: v for k, v in (
        ("fused_sample", n_steps * MAX_NEW),
        ("flash_attention", n_steps * 2 * flash_layers(cfg, seq)),
        ("fused_logprob", 2 * n_steps), ("fused_logprob_bwd", n_steps)) if v}
    require(launches == want, f"moe train launch counts {launches}, want "
            f"{want} (per step: the reference's and the trainer's merged "
            "forward through flash_attention; the generator's windowed "
            "prefill through chunked_attention)")
    log(f"  {n_steps} steps in {wall:.1f} s; router moved by up to "
        f"{router_moved:.3e}, expert leaves moved: {moved}; launches "
        f"{launches}; peak memory allocated "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del ctl, gen, ref, rew, trn, moe, router0
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def moe_numerics(torch, dev):
    """[16] (c): the smoke config (window 64 every other layer), fp32:
    decode through the wrapped ring against the windowed forward_train
    (2e-3), the paged engine's behaviour log-probs against the
    reference's (1e-3), and moe_forward on the card against the same
    call on the CPU with capacity factor 1 (routing, dest, valid and
    order equal; y within 1e-5 of max(1, max|y|)).  Returns the launch
    counts."""
    import dataclasses

    import numpy as np

    from repro_torch import configs
    from repro_torch.core.executor import GeneratorExecutor
    from repro_torch.kernels import build
    from repro_torch.models import backbone as bb
    from repro_torch.models import decode_step, ffn, forward_train, \
        init_params, prefill
    from repro_torch.rl.data import ArithmeticTasks

    cfg = configs.get_smoke(MOE_ARCH)
    W = cfg.window
    params = init_params(cfg, seed=5, dtype=torch.float32, device=dev)
    S, n = MOE_SMOKE_PROMPT, 8
    ids = np.random.default_rng(5).integers(0, cfg.vocab, (2, S + n))
    toks = torch.as_tensor(ids, dtype=torch.int32, device=dev)
    with torch.no_grad():
        full_logits, _ = forward_train(params, cfg, {"tokens": toks})
        _, cache = prefill(params, cfg, {"tokens": toks[:, :S]},
                           cache_len=S + n, dtype=torch.float32)
        require(cache["segments"][0]["k"].shape[2] == W, "ring size")
        err = 0.0
        for i in range(n):
            lg, cache = decode_step(params, cfg, cache,
                                    toks[:, S + i:S + i + 1])
            err = max(err, max_err(lg, full_logits[:, S + i]))
    sp = cache["segments"][0]["slot_pos"]
    require(sp.min().item() == S + n - W, "decode did not wrap the ring")
    log(f"  (c) {cfg.name} smoke fp32 ({cfg.moe.n_experts} experts, "
        f"window {W} every other layer): decode of {n} tokens through the "
        f"wrapped ring after a {S}-token prefill against the "
        f"teacher-forced windowed forward_train: max|dlogits| {err:.3e} "
        "(tolerance 2e-3)")
    require(err <= 2e-3, "ring decode against the windowed forward")
    del full_logits, cache

    gen = GeneratorExecutor(cfg, ArithmeticTasks(prompt_len=S, seed=5),
                            n_prompts=1, n_per_prompt=N_PER,
                            max_new=MAX_NEW, chunk=CHUNK, temperature=1.0,
                            seed=5, device=dev)
    gen.set_weights(params, version=0)
    gen.engine_configure(kv_layout="paged", kv_page_size=ENGINE_PAGE,
                         row_budgets=ENGINE_BUDGETS)
    gen.engine_enqueue(0, bound=0)
    items = []
    build.reset_launches()          # the engine's run starts here
    for _ in range(40):
        items += gen.engine_round(["completions"])
        if items:
            break
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)  # ... and ends here
    require(len(items) == 1 and launches.get("paged_attention", 0) > 0,
            f"fp32 moe engine: {len(items)} batches, {launches}")
    d = score_engine(torch, cfg, params, [items[0]["snapshot"]
                                          ["completions"]])
    log(f"  fp32 paged engine, prompts of {S}: |behavior_logp - ref_logp| "
        f"at {d.numel()} actions: max {d.max().item():.2e} (tolerance "
        f"1e-3); launches {launches}")
    require(d.max().item() <= 1e-3, "fp32 moe engine mu vs reference")
    gen.engine_abort()
    del gen, items

    # the same MoE layer on the card and on the CPU, with drops
    mcfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=1.0))
    m = mcfg.moe
    layer = bb.unstack(params["moe_layers"], cfg.n_layers)[0]["moe"]
    x = torch.as_tensor(np.random.default_rng(6).standard_normal(
        (4, S, cfg.d_model)), dtype=torch.float32)
    Cm = max(int(S * m.top_k / m.n_experts * m.capacity_factor), 1)

    def run(where):
        p = {k: (v.to(where) if torch.is_tensor(v)
                 else {n_: t.to(where) for n_, t in v.items()})
             for k, v in layer.items()}
        xd = x.to(where)
        _, _, idx = ffn._route(p, xd, m)
        buf, dest, valid, order = ffn._dispatch_group(xd, idx, m.n_experts,
                                                      Cm)
        y, aux = ffn.moe_forward(p, xd, mcfg)
        return [t.cpu() for t in (idx, buf, dest, valid, order, y)] \
            + [float(aux)]
    card, cpu = run(dev), run(torch.device("cpu"))
    for name, a, b in zip(("routing", "buffer", "dest", "valid", "order"),
                          card, cpu):
        require(torch.equal(a, b) if name != "buffer"
                else max_err(a, b) == 0.0,
                f"moe_forward on the card: {name} differs from the CPU's")
    scale = max(1.0, cpu[5].abs().max().item())
    y_err = max_err(card[5], cpu[5]) / scale
    require(y_err <= 1e-5 and abs(card[6] - cpu[6]) <= 1e-6,
            f"moe_forward card vs CPU: y {y_err:.3e} of max|y|, aux "
            f"{abs(card[6] - cpu[6]):.3e}")
    log(f"  moe_forward [4, {S}, {cfg.d_model}] fp32, capacity {Cm} "
        f"({100 * (1 - cpu[3].float().mean().item()):.1f}% of choices "
        f"dropped): the card's routing, buffer, dest, valid and order "
        f"equal the CPU's; y {y_err:.3e} of max|y| {scale:.1f}, aux "
        f"{abs(card[6] - cpu[6]):.1e}")
    del params, layer
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_moe(torch, dev):
    """[16]: the MoE family.  Returns the launch counts of its main-path
    runs."""
    log(f"[16] moe: {MOE_ARCH} at full width, {MOE_LAYERS} layers served "
        f"and {MOE_TRAIN_LAYERS} trained, its smoke config in fp32; "
        f"{nvidia_smi()}")
    t0 = time.perf_counter()
    launches = collections.Counter()
    with KernelCalls(torch, per_shape=1, names=KernelCalls.ENGINE) as calls:
        launches.update(moe_serve(torch, dev, calls))
    for line in calls.replay("[16] (a)", expect=(
            "fused_sample_cuda", "fused_logprob_cuda",
            "flash_attention_cuda", "paged_attention_cuda")):
        log(line)
    V = {args[0].shape[-1] for args, _, _ in calls.calls["fused_sample_cuda"]}
    heads = {args[0].shape[2:4] for args, _, _ in
             calls.calls["flash_attention_cuda"]}
    paged = {args[0].shape[1:] for args, _, _ in
             calls.calls["paged_attention_cuda"]}
    from repro_torch import configs
    cfg = configs.get_config(MOE_ARCH)
    want = (cfg.n_heads, cfg.hd)
    require(V == {cfg.vocab} and heads == {want} and paged == {want},
            f"[16] (a) shapes: V {V}, flash heads {heads}, paged {paged}")
    del calls
    gc.collect()
    torch.cuda.empty_cache()
    with KernelCalls(torch, host=True) as calls:
        launches.update(moe_train(torch, dev))
    for line in calls.replay("[16] (b)"):
        log(line)
    del calls
    with KernelCalls(torch, names=KernelCalls.ENGINE) as calls:
        launches.update(moe_numerics(torch, dev))
    for line in calls.replay("[16] (c)", expect=(
            "fused_sample_cuda", "fused_logprob_cuda",
            "flash_attention_cuda", "paged_attention_cuda")):
        log(line)
    del calls
    launches = dict(launches)
    for name in KERNELS[:5]:
        require(launches.get(name, 0) > 0, f"{name} never ran in [16]")
    log(f"  [16] launches {launches}; {time.perf_counter() - t0:.1f} s")
    return launches


# ------------------------------------------------ [17] MLA + MTP family --

# [17]: deepseek-v3-671b at its published widths
MLA_ARCH = "deepseek-v3-671b"
# (a): the 3 leading dense layers and the first MoE layer, so both stacks
# and both FFN kinds run: 15.8 B params, 31.6 GB in bf16
MLA_LAYERS = 4
MLA_PROMPT, MLA_NEW = 256, 32
# (b): 2 layers (first_k_dense 1) and 16 of the 256 experts, top-8 kept:
# one full MoE layer is 11.5 B params, 138 GB of trainer state at 12
# bytes a param, and the reference builds no config without a MoE layer
MLA_TRAIN_LAYERS, MLA_TRAIN_EXPERTS = 2, 16
# (c): the smoke config's prompts and decoded tokens
MLA_SMOKE_PROMPT, MLA_SMOKE_NEW = 48, 8


def mla_serve(torch, dev):
    """[17] (a): deepseek-v3-671b at full width, MLA_LAYERS layers, bf16:
    a batch rollout (prefill in the expanded form through the plain
    chunked_attention, decode in the absorbed form over the latent
    cache) scored by the reference.  The engine refuses MLA, as the
    reference's does.  Returns the launch counts of the run."""
    from repro_torch import configs
    from repro_torch.core.executor import GeneratorExecutor, \
        RefPolicyExecutor, RewardExecutor
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import chunked_attention
    from repro_torch.models import ffn, init_params
    from repro_torch.rl.data import ArithmeticTasks

    full = configs.get_config(MLA_ARCH)
    cfg = full.replace(name=f"{MLA_ARCH}-{MLA_LAYERS}l", n_layers=MLA_LAYERS)
    m, a, L, H = cfg.moe, cfg.mla, cfg.n_layers, cfg.n_heads
    qk = a.qk_nope_dim + a.qk_rope_dim
    B = N_PROMPTS * N_PER
    C = max(int(MLA_PROMPT * m.top_k / m.n_experts * m.capacity_factor), 1)
    log(f"  (a) serve {MLA_ARCH} at full width (d {cfg.d_model}, {H} heads,"
        f" q rank {a.q_lora_rank}, kv rank {a.kv_lora_rank}, qk "
        f"{a.qk_nope_dim}+{a.qk_rope_dim}, v {a.v_head_dim}; "
        f"{m.first_k_dense} dense layers of d_ff {cfg.d_ff}, then "
        f"{m.n_experts} experts of d {m.d_expert}, top-{m.top_k} "
        f"{m.router}, {m.n_shared} shared; MTP head; V {cfg.vocab}): "
        f"{cut_line(full, cfg)}; bf16; {N_PROMPTS} prompts x {N_PER} "
        f"samples of {MLA_PROMPT} ids, {MLA_NEW} new tokens in chunks of "
        f"{CHUNK}; prefill capacity {C} a group and expert")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in leaves(params))
    log(f"  init: {n / 1e9:.3f} B params, {2 * n / 1e9:.2f} GB, "
        f"{time.perf_counter() - t0:.1f} s, peak memory allocated "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB (each expert "
        "leaf drawn in fp32 before the cast)")
    gen = GeneratorExecutor(cfg, ArithmeticTasks(prompt_len=MLA_PROMPT,
                                                 seed=0),
                            n_prompts=N_PROMPTS, n_per_prompt=N_PER,
                            max_new=MLA_NEW, chunk=CHUNK, temperature=1.0,
                            seed=0, device=dev)
    gen.set_weights(params, version=0)
    ref = RefPolicyExecutor(cfg)
    ref.set_weights(params)
    rew = RewardExecutor(n_per_prompt=N_PER, leave_one_out=True)

    # a first prefill (the new shapes' first launches), whose dispatch
    # masks give the share capacity drops; then a timed one, a profiled
    # one, and the timed one decodes
    valid = []
    real_dispatch = ffn._dispatch_group

    def kept(*args, **kwargs):
        out = real_dispatch(*args, **kwargs)
        valid.append(out[2])
        return out
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()          # the batch rollout's run starts here
    ffn._dispatch_group = kept
    try:
        t0 = time.perf_counter()
        job, state = gen.begin_batch()
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
    finally:
        ffn._dispatch_group = real_dispatch
    n_moe = L - m.first_k_dense
    require(len(valid) == n_moe and all(
        v.shape == (B, MLA_PROMPT * m.top_k) for v in valid),
        f"prefill dispatches {[tuple(v.shape) for v in valid]}")
    dropped = [1.0 - v.float().mean().item() for v in valid]
    segs = state.cache["segments"]
    require([sorted(sg) for sg in segs] == [["ckv", "krope", "slot_pos"]] * 2
            and segs[0]["ckv"].shape == (m.first_k_dense, B,
                                         MLA_PROMPT + MLA_NEW,
                                         a.kv_lora_rank)
            and segs[1]["krope"].shape == (n_moe, B, MLA_PROMPT + MLA_NEW,
                                           a.qk_rope_dim),
            f"latent cache {[{k: tuple(v.shape) for k, v in sg.items()} for sg in segs]}")
    latent = sum(sg[k].nbytes for sg in segs for k in ("ckv", "krope"))
    per_pos = a.kv_lora_rank + a.qk_rope_dim
    expanded_per_pos = H * (qk + a.v_head_dim)
    del valid, job, state, segs
    t0 = time.perf_counter()
    job, state = gen.begin_batch()
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    prefill_peak = torch.cuda.max_memory_allocated() / 1e9
    busy_p, moe_p, _ = moe_profile(torch, gen.begin_batch)
    # the plain expanded attention's share: one layer's chunked_attention
    # at the prefill's shapes (qk 192 against v 128, 128 heads), alone
    g = torch.Generator(device=dev).manual_seed(3)
    q = torch.randn(B, MLA_PROMPT, H, qk, generator=g, device=dev
                    ).to(torch.bfloat16)
    k = torch.randn(B, MLA_PROMPT, H, qk, generator=g, device=dev
                    ).to(torch.bfloat16)
    v = k[..., :a.v_head_dim].contiguous()
    attn_ms = cuda_ms(torch, lambda: chunked_attention(q, k, v), 3)
    del q, k, v
    t0 = time.perf_counter()
    state = gen.advance_chunk(job, state)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3 / CHUNK
    box = []
    busy, moe_ms, ops = moe_profile(
        torch, lambda: box.append(gen.advance_chunk(job, state)))
    state = box[0]
    out = gen.emit_batch(job, state)
    t0 = time.perf_counter()
    ref.put_input("completions", out)
    ref.step()
    torch.cuda.synchronize()
    t_ref = time.perf_counter() - t0
    rew.put_input("completions_with_ref", ref.get_output("completions_with_ref"))
    out = rew.step()
    launches = dict(build.LAUNCHES)  # ... and ends here
    want = {"fused_sample": MLA_NEW, "fused_logprob": 1}
    require(launches == want, f"mla rollout launch counts {launches}, "
            f"want {want} (MLA's asymmetric heads go to chunked_attention "
            "in prefill and scoring, as the reference routes them; decode "
            "is plain torch over the latent cache)")
    d = _check_outputs(torch, out, cfg.vocab)
    log(f"  prefill [{B}, {MLA_PROMPT}]: {prefill_ms:.1f} ms (the first "
        f"{first_ms:.1f} ms); profiled: device busy {busy_p:.1f} ms, of "
        f"which the MoE FFN {moe_p:.1f} ms "
        + (f"({100 * moe_p / busy_p:.1f}%)" if busy_p else "(not measured)")
        + f"; the plain chunked_attention at [{B}, {MLA_PROMPT}, {H}, "
        f"{qk}/{a.v_head_dim}] {attn_ms:.2f} ms a layer (CUDA events, "
        f"alone), {L} x {attn_ms:.2f} = {L * attn_ms:.1f} ms "
        f"({100 * L * attn_ms / prefill_ms:.1f}% of the prefill); peak "
        f"memory through the prefills {prefill_peak:.2f} GB; capacity "
        f"dropped {', '.join(f'{100 * x:.2f}' for x in dropped)}% of the "
        f"prefill's choices in the MoE layer(s) {m.first_k_dense}-{L - 1}")
    log(f"  latent cache (fp32, the rollout's): {latent / 1e6:.1f} MB for "
        f"{B} rows x {MLA_PROMPT + MLA_NEW} positions x {L} layers, "
        f"{per_pos} values a position a layer ({a.kv_lora_rank} + "
        f"{a.qk_rope_dim}) against {expanded_per_pos} for expanded K "
        f"({H} x {qk}) and V ({H} x {a.v_head_dim}): "
        f"{expanded_per_pos / per_pos:.1f}x fewer bytes, "
        f"{latent * expanded_per_pos / per_pos / 1e9:.2f} GB expanded")
    busy /= CHUNK
    log(f"  decode {decode_ms:.2f} ms per token (batch {B}, one "
        f"unprofiled chunk); profiled chunk: device busy {busy:.2f} ms per "
        f"token = {100 * busy / decode_ms:.1f}% of it; the MoE FFN "
        f"{moe_ms / CHUNK:.2f} ms per token = "
        + (f"{100 * moe_ms / CHUNK / busy:.1f}%" if busy else "not measured")
        + " of the device time; top device operations (ms per token): "
        + ", ".join(f"{e.key[:48]} {e.self_device_time_total / 1e3 / CHUNK:.3f}"
                    for e in ops[:6]))
    log(f"  reference {t_ref * 1e3:.1f} ms over [{B}, "
        f"{MLA_PROMPT + MLA_NEW}] (with the MTP head's logits); "
        f"|behavior_logp - ref_logp| at {d.numel()} actions (bf16): mean "
        f"{d.mean().item():.4f}, max {d.max().item():.4f}; launches "
        f"{launches}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del job, state, out, box, gen, ref, rew, params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def mla_train(torch, dev):
    """[17] (b): two steps of the sequential async loop at full width,
    MLA_TRAIN_LAYERS layers and MLA_TRAIN_EXPERTS experts, sequences of
    80, the MTP loss and the MoE aux in the loss; KL 0.1 against a
    reference fed the trainer's weights by its own weights channel, as
    in [16] (b).  Returns the launch counts."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.core.channels import CommType, CommunicationChannel, \
        WeightsCommunicationChannel
    from repro_torch.core.controller import SyncExecutorController
    from repro_torch.core.executor import GeneratorExecutor, \
        RefPolicyExecutor, RewardExecutor, TrainerExecutor
    from repro_torch.kernels import build
    from repro_torch.rl.data import ArithmeticTasks

    full = configs.get_config(MLA_ARCH)
    cfg = full.replace(
        name=f"{MLA_ARCH}-{MLA_TRAIN_LAYERS}l-{MLA_TRAIN_EXPERTS}e",
        n_layers=MLA_TRAIN_LAYERS, moe=dataclasses.replace(
            full.moe, first_k_dense=1, n_experts=MLA_TRAIN_EXPERTS))
    n_steps = 2
    torch.cuda.reset_peak_memory_stats()
    gen = GeneratorExecutor(cfg, ArithmeticTasks(seed=0),
                            n_prompts=N_PROMPTS, n_per_prompt=N_PER,
                            max_new=MAX_NEW, chunk=CHUNK, temperature=1.0,
                            seed=0, device=dev)
    ref = RefPolicyExecutor(cfg)
    rew = RewardExecutor(n_per_prompt=N_PER, leave_one_out=True)
    trn = TrainerExecutor(cfg, dtype=torch.bfloat16, kl_coef=KL_COEF,
                          seed=0, device=dev)
    ctl = SyncExecutorController(
        [gen, ref, rew, trn],
        [WeightsCommunicationChannel("policy_model", trn, gen),
         WeightsCommunicationChannel("policy_model", trn, ref),
         CommunicationChannel("completions", gen, ref, CommType.BROADCAST),
         CommunicationChannel("completions_with_ref", ref, rew,
                              CommType.GATHER),
         CommunicationChannel("completions_with_reward", rew, trn,
                              CommType.SCATTER)],
        max_steps=n_steps, mode="async", staleness=1)
    ctl.init()
    params = trn.get_model()
    n = sum(t.numel() for t in leaves(params))
    big = max(t.numel() for t in leaves(params))
    seq = gen.tasks.prompt_len + MAX_NEW
    log(f"  (b) train {MLA_ARCH} at full width, cut to {MLA_TRAIN_LAYERS} "
        f"of {full.n_layers} layers (first_k_dense 1) and "
        f"{MLA_TRAIN_EXPERTS} of {full.moe.n_experts} experts (top-"
        f"{cfg.moe.top_k} kept; one full MoE layer would be 138 GB of "
        f"trainer state): {n / 1e9:.3f} B params; reckoned peak "
        f"{12 * n / 1e9:.1f} GB of trainer state + {2 * n / 1e9:.1f} GB "
        f"for the version the generator and the reference share + "
        f"{2 * n / 1e9:.1f} GB for the version Adam builds + "
        f"{3 * 4 * big / 1e9:.1f} GB of Adam's fp32 temporaries on the "
        f"largest leaf = {(16 * n + 12 * big) / 1e9:.1f} GB; {n_steps} "
        f"steps of the async schedule, staleness 1, KL {KL_COEF}, MTP "
        f"weight 0.1; sequences of {seq}")
    # every MLA matrix of both stacks, mtp.proj and the MTP block's
    # matrices, by key path
    watched = [(key, "attn", k) for key in ("dense_layers", "moe_layers")
               for k in params[key]["attn"] if not k.endswith("norm")]
    watched += [("mtp", "proj")] + [
        ("mtp", "block", part, k) for part in ("attn", "mlp")
        for k in params["mtp"]["block"][part] if not k.endswith("norm")]

    def prints(tree):
        out = {}
        for path in watched:
            t = tree
            for k in path:
                t = t[k]
            out[path] = fingerprint(torch, {"": t})
        return out
    before = prints(params)
    del params
    t0 = time.perf_counter()
    build.reset_launches()          # the train path's run starts here
    history = ctl.run()
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)  # ... and ends here
    wall = time.perf_counter() - t0
    for h in history:
        log(f"  step {h['step']}: loss {h['loss']:.5f}, mtp_loss "
            f"{h['mtp_loss']:.5f}, moe_aux {h['moe_aux']:.6f}, grad_norm "
            f"{h['grad_norm']:.4f}, weight_version {h['weight_version']}")
        require(h["weight_version"] == max(0, h["step"] - 1)
                and math.isfinite(h["loss"]) and h["moe_aux"] > 0
                and math.isfinite(h["mtp_loss"]) and h["mtp_loss"] > 0
                and math.isfinite(h["grad_norm"]), f"step {h}")
    after = prints(trn.get_model())
    still = [".".join(p) for p in watched if after[p] == before[p]]
    require(not still, f"leaves that did not move: {still}")
    want = {"fused_sample": n_steps * MAX_NEW,
            "fused_logprob": 3 * n_steps, "fused_logprob_bwd": 2 * n_steps}
    require(launches == want, f"mla train launch counts {launches}, want "
            f"{want} (per step: the reference's log-probs, the trainer's "
            "main and MTP log-probs and their two backwards; attention "
            "through chunked_attention)")
    log(f"  {n_steps} steps in {wall:.1f} s; moved: every MLA matrix of "
        f"both stacks, mtp.proj and the MTP block's matrices ({len(watched)}"
        f" leaves; the norms, all 1.0 in bf16, move by less than half a "
        f"bf16 ulp at lr 1e-3); launches {launches}; peak memory "
        f"allocated {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del ctl, gen, ref, rew, trn
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def mla_numerics(torch, dev):
    """[17] (c): the smoke config in fp32 on the card against the CPU:
    prefill + decode against the teacher-forced forward, the absorbed
    ``mla_decode`` against the expanded ``mla_forward``'s last position,
    and ``mtp_logits`` on the card against the CPU's, all within the
    reference's 1e-3 (``tests/test_arch_smoke.py``); then a batch rollout
    scored by the reference, mu within 1e-3 of the reference's log-probs.
    Returns the launch counts of the rollout."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.core.executor import GeneratorExecutor, \
        RefPolicyExecutor, RewardExecutor
    from repro_torch.kernels import build
    from repro_torch.models import attention as attn
    from repro_torch.models import backbone as bb
    from repro_torch.models import decode_step, forward_train, \
        init_params, prefill
    from repro_torch.rl.data import ArithmeticTasks
    from repro_torch.train.optimizer import tree_map

    cfg = configs.get_smoke(MLA_ARCH)
    params = init_params(cfg, seed=5, dtype=torch.float32, device=dev)
    host = tree_map(lambda t: t.cpu(), params)
    S, n = MLA_SMOKE_PROMPT, MLA_SMOKE_NEW
    rng = np.random.default_rng(5)
    ids = torch.as_tensor(rng.integers(0, cfg.vocab, (2, S + n)),
                          dtype=torch.int32)
    toks = ids.to(dev)
    with torch.no_grad():
        full, aux = forward_train(params, cfg, {"tokens": toks})
        full_cpu, aux_cpu = forward_train(host, cfg, {"tokens": ids})
        mtp_err = max_err(aux["mtp_logits"].cpu(), aux_cpu["mtp_logits"])
        fwd_err = max_err(full.cpu(), full_cpu)
        last, cache = prefill(params, cfg, {"tokens": toks[:, :S]},
                              cache_len=S + n, dtype=torch.float32)
        dec_err = max_err(last, full[:, S - 1])
        for i in range(n):
            lg, cache = decode_step(params, cfg, cache,
                                    toks[:, S + i:S + i + 1])
            dec_err = max(dec_err, max_err(lg, full[:, S + i]))
        # one layer's absorbed decode against its expanded forward
        p = bb.unstack(params["dense_layers"], cfg.moe.first_k_dense)[0]
        x = torch.as_tensor(rng.standard_normal((2, S + 1, cfg.d_model)),
                            dtype=torch.float32, device=dev)
        y, (ckv, kr) = attn.mla_forward(p["attn"], x, cfg)
        sp = torch.full((S + 1,), -1, dtype=torch.int32, device=dev)
        sp[:S] = torch.arange(S, dtype=torch.int32, device=dev)
        cache_ckv, cache_kr = ckv.clone(), kr.clone()
        cache_ckv[:, S] = cache_kr[:, S] = 0
        y_dec = attn.mla_decode(p["attn"], x[:, S:], cache_ckv, cache_kr,
                                sp, S, cfg)
        abs_err = max_err(y_dec[:, 0], y[:, S])
    log(f"  (c) {cfg.name} smoke fp32 ({cfg.n_layers} layers, d "
        f"{cfg.d_model}, kv rank {cfg.mla.kv_lora_rank}, "
        f"{cfg.moe.n_experts} experts top-{cfg.moe.top_k}): prefill of "
        f"{S} + decode of {n} against the teacher-forced forward: "
        f"max|dlogits| {dec_err:.3e}; the absorbed mla_decode against the "
        f"expanded mla_forward's position {S}: max|dy| {abs_err:.3e}; "
        f"card against CPU: logits {fwd_err:.3e}, mtp_logits "
        f"{mtp_err:.3e} (tolerance 1e-3 each)")
    require(max(dec_err, abs_err, fwd_err, mtp_err) <= 1e-3,
            "[17] (c) numerics")
    del full, aux, full_cpu, aux_cpu, cache, host

    gen = GeneratorExecutor(cfg, ArithmeticTasks(seed=5), n_prompts=1,
                            n_per_prompt=N_PER, max_new=MAX_NEW,
                            chunk=CHUNK, temperature=1.0, seed=5, device=dev)
    gen.set_weights(params, version=0)
    ref = RefPolicyExecutor(cfg)
    ref.set_weights(params)
    rew = RewardExecutor(n_per_prompt=N_PER, leave_one_out=True)
    build.reset_launches()          # the rollout's run starts here
    ref.put_input("completions", gen.step())
    ref.step()
    rew.put_input("completions_with_ref", ref.get_output("completions_with_ref"))
    out = rew.step()
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)  # ... and ends here
    want = {"fused_sample": MAX_NEW, "fused_logprob": 1}
    require(launches == want, f"fp32 mla rollout launches {launches}, "
            f"want {want}")
    d = _check_outputs(torch, out, cfg.vocab)
    log(f"  fp32 batch rollout, {N_PER} samples of {MAX_NEW} tokens: "
        f"|behavior_logp - ref_logp| at {d.numel()} actions (absorbed "
        f"decode against the expanded forward): max {d.max().item():.2e} "
        f"(tolerance 1e-3); launches {launches}")
    require(d.max().item() <= 1e-3, "fp32 mla rollout mu vs reference")
    del gen, ref, rew, params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_mla(torch, dev):
    """[17]: the MLA + MTP family.  Returns the launch counts of its
    main-path runs."""
    log(f"[17] mla: {MLA_ARCH} at full width, {MLA_LAYERS} layers served "
        f"and {MLA_TRAIN_LAYERS} layers of {MLA_TRAIN_EXPERTS} experts "
        f"trained, its smoke config in fp32; {nvidia_smi()}")
    from repro_torch import configs
    V = configs.get_config(MLA_ARCH).vocab
    t0 = time.perf_counter()
    launches = collections.Counter()
    dense = ("fused_sample_cuda", "fused_logprob_cuda")
    with KernelCalls(torch, per_shape=1, names=KernelCalls.ENGINE) as calls:
        launches.update(mla_serve(torch, dev))
    for line in calls.replay("[17] (a)", expect=dense):
        log(line)
    sample = {tuple(args[0].shape) for args, _, _ in
              calls.calls["fused_sample_cuda"]}
    scored = {tuple(args[0].shape) for args, _, _ in
              calls.calls["fused_logprob_cuda"]}
    B = N_PROMPTS * N_PER
    require(sample == {(B, V)} and scored == {(B, MLA_PROMPT + MLA_NEW - 1,
                                               V)},
            f"[17] (a) shapes: fused_sample {sample}, fused_logprob "
            f"{scored}")
    del calls
    gc.collect()
    torch.cuda.empty_cache()
    with KernelCalls(torch, host=True, names=KernelCalls.ENGINE) as calls:
        launches.update(mla_train(torch, dev))
    for line in calls.replay("[17] (b)", expect=dense + (
            "fused_logprob_bwd_cuda",)):
        log(line)
    del calls
    with KernelCalls(torch, names=KernelCalls.ENGINE) as calls:
        launches.update(mla_numerics(torch, dev))
    for line in calls.replay("[17] (c)", expect=dense):
        log(line)
    del calls
    launches = dict(launches)
    for name in KERNELS[:3]:
        require(launches.get(name, 0) > 0, f"{name} never ran in [17]")
    # the reference's routing: MLA's qk 192 against v 128 never reaches
    # the flash kernel, and the engine (paged attention) refuses MLA
    for name in ("flash_attention", "paged_attention"):
        require(launches.get(name, 0) == 0, f"{name} ran in [17]")
    log(f"  [17] launches {launches}; {time.perf_counter() - t0:.1f} s")
    return launches


VLM_ARCH = "qwen2-vl-7b"
# (a): full width and depth (7.62 B params, 15.2 GB in bf16): prompts of
# 256 ids after the 256 patch embeddings, so prefill attends over 512
VLM_PROMPT, VLM_NEW = 256, 32
# (b): 8 of 28 layers, 2.95 B params, 35 GB of bf16 params and grads and
# fp32 Adam moments (91 GB at full depth); sequences of 80, as 64 prompt
# ids and 16 new tokens: every sampler call of (b) is replayed through
# the plain version, about 0.1 s each at V 152064
VLM_TRAIN_LAYERS = 8
VLM_TRAIN_PROMPT, VLM_TRAIN_NEW = 64, 16
# (c): the smoke config's prompts and decoded tokens
VLM_SMOKE_PROMPT, VLM_SMOKE_NEW = 24, 8


def vlm_patches(torch, cfg, B, dev, seed):
    """Patch embeddings [B, P, D] at scale 0.02 from a seeded generator,
    as tests/test_arch_smoke.py draws them (the vision tower is a stub in
    both packages)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(B, cfg.frontend_tokens, cfg.d_model, generator=g,
                       device=dev) * 0.02


def vlm_score(torch, params, cfg, tokens, extra):
    """The reference's log-probs of ``tokens`` (0 at position 0), through
    forward_train with ``extra`` (a VLM's patch prefix, an audio model's
    frames) and B1."""
    import torch.nn.functional as F

    from repro_torch.core.aipo import token_logprobs
    from repro_torch.models import forward_train
    with torch.no_grad():
        logits, _ = forward_train(params, cfg, {"tokens": tokens, **extra})
        return F.pad(token_logprobs(logits[:, :-1], tokens[:, 1:]), (1, 0))


def vlm_serve(torch, dev):
    """[18] (a): qwen2-vl-7b at full width and depth, bf16: a batch rollout
    through ``start_rollout(extra=)`` and ``rollout_chunk`` (the
    executors carry no patch embeddings, in either package) scored by
    forward_train with the same patches.  Returns the launch counts."""
    from repro_torch import configs
    from repro_torch.kernels import build
    from repro_torch.models import init_params
    from repro_torch.models.common import mrope_sections
    from repro_torch.rl import prng
    from repro_torch.rl.data import ArithmeticTasks
    from repro_torch.rl.rollout import action_mask, finalize_rollout, \
        rollout_chunk, start_rollout

    cfg = configs.get_config(VLM_ARCH)
    L, P, B = cfg.n_layers, cfg.frontend_tokens, N_PROMPTS * N_PER
    log(f"  (a) serve {VLM_ARCH} at full width and depth ({L} layers, d "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.hd}, "
        f"qkv bias, d_ff {cfg.d_ff}, M-RoPE sections "
        f"{mrope_sections(cfg.hd)}, V {cfg.vocab}); bf16; {N_PROMPTS} "
        f"prompts x {N_PER} samples of {VLM_PROMPT} ids after {P} patch "
        f"embeddings, {VLM_NEW} new tokens in chunks of {CHUNK}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in leaves(params))
    log(f"  init: {n / 1e9:.3f} B params, {2 * n / 1e9:.2f} GB, "
        f"{time.perf_counter() - t0:.1f} s, peak memory allocated "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    prompts = torch.as_tensor(ArithmeticTasks(
        prompt_len=VLM_PROMPT, seed=0).sample(N_PROMPTS, N_PER).prompts,
        device=dev)
    extra = {"patch_embeds": vlm_patches(torch, cfg, B, dev, seed=0)}
    total = VLM_PROMPT + VLM_NEW
    k1, k2 = prng.split(prng.PRNGKey(0))
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()          # the rollout's run starts here
    t0 = time.perf_counter()
    start_rollout(params, cfg, prompts, total, extra=extra)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    state = start_rollout(params, cfg, prompts, total, extra=extra)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    require(state.cache["pos"] == P + VLM_PROMPT
            and state.cache["segments"][0]["k"].shape[2] == P + total,
            f"cache pos {state.cache['pos']}")
    busy, ops = profiled_decode(torch, device_profile, params, cfg,
                                state.cache, prompts[:, -1:])
    t0 = time.perf_counter()
    state = rollout_chunk(params, cfg, state, k1, n_steps=CHUNK)
    state = rollout_chunk(params, cfg, state, k2, n_steps=CHUNK)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3 / (2 * CHUNK)
    state = finalize_rollout(state, VLM_NEW)
    t0 = time.perf_counter()
    ref = vlm_score(torch, params, cfg, state.tokens, extra)
    torch.cuda.synchronize()
    t_ref = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)  # ... and ends here
    want = {"flash_attention": 3 * L, "fused_sample": VLM_NEW,
            "fused_logprob": 1}
    require(launches == want, f"vlm rollout launch counts {launches}, want "
            f"{want} (two prefills of the {P} patches and the prompt and "
            "one scoring, flash_attention each layer; fused_sample a "
            "decoded token; decode attention is plain torch)")
    d = _check_outputs(torch, {"tokens": state.tokens,
                               "mask": action_mask(state),
                               "behavior_logp": state.behavior_logp,
                               "ref_logp": ref}, cfg.vocab)
    busy /= PROFILED_STEPS
    log(f"  prefill [{B}, {P} + {VLM_PROMPT}]: {prefill_ms:.1f} ms (the "
        f"first {first_ms:.1f} ms); decode {decode_ms:.2f} ms per token "
        f"(batch {B}, two unprofiled chunks); {PROFILED_STEPS} profiled "
        f"decode steps: device busy {busy:.2f} ms per token = "
        f"{100 * busy / decode_ms:.1f}% of it; top device operations (ms "
        "per token): "
        + ", ".join(f"{e.key[:48]} "
                    f"{e.self_device_time_total / 1e3 / PROFILED_STEPS:.3f}"
                    for e in ops[:6]))
    log(f"  reference {t_ref * 1e3:.1f} ms over [{B}, {P} + {total}]; "
        f"|behavior_logp - ref_logp| at {d.numel()} actions (bf16): mean "
        f"{d.mean().item():.4f}, max {d.max().item():.4f}; launches "
        f"{launches}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del state, ref, params, extra
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def vlm_train(torch, dev):
    """[18] (b): two ``make_train_step`` steps at full width cut to
    VLM_TRAIN_LAYERS layers, ``patch_embeds`` in the batch: each step's
    batch is a rollout of the current params (prompts of 64, 16 new
    tokens, so sequences of 80 after the patches) scored by a frozen
    reference from another seed, KL 0.1 (a random policy earns no
    reward).  Returns the launch counts."""
    from repro_torch import configs
    from repro_torch.kernels import build
    from repro_torch.models import init_params
    from repro_torch.rl import prng
    from repro_torch.rl.data import ArithmeticTasks
    from repro_torch.rl.rollout import action_mask, generate
    from repro_torch.train.optimizer import adam_init
    from repro_torch.train.trainstep import TrainState, make_train_step

    full = configs.get_config(VLM_ARCH)
    cfg = full.replace(name=f"{VLM_ARCH}-{VLM_TRAIN_LAYERS}l",
                       n_layers=VLM_TRAIN_LAYERS)
    L, B, n_steps = cfg.n_layers, N_PROMPTS * N_PER, 2
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    ref_params = init_params(cfg, seed=1, dtype=torch.bfloat16, device=dev)
    state = TrainState(params, adam_init(params))
    step = make_train_step(cfg, lr=1e-3, kl_coef=KL_COEF)
    tasks = ArithmeticTasks(prompt_len=VLM_TRAIN_PROMPT, seed=0)
    extra = {"patch_embeds": vlm_patches(torch, cfg, B, dev, seed=1)}
    n = sum(t.numel() for t in leaves(params))
    seq = VLM_TRAIN_PROMPT + VLM_TRAIN_NEW
    log(f"  (b) train {VLM_ARCH} at full width, {cut_line(full, cfg)}: "
        f"{n / 1e9:.3f} B params, trainer state {12 * n / 1e9:.1f} GB "
        f"({12 * param_total(full) / 1e9:.1f} GB at full depth); "
        f"{n_steps} make_train_step steps, KL {KL_COEF}, sequences of "
        f"{seq} after {cfg.frontend_tokens} patches")
    # every leaf but the norms (1.0, which bf16 steps of 1e-3 do not move)
    # and b_up, which the gated MLP does not read (as in the reference)
    watched = [k for k in leaves_by_path(params)
               if k[-1] not in ("ln1", "ln2", "final_norm", "b_up")]
    before = {k: fingerprint(torch, {"": t})
              for k, t in leaves_by_path(params).items() if k in watched}
    key = prng.PRNGKey(1)
    t0 = time.perf_counter()
    build.reset_launches()          # the train path's run starts here
    for i in range(n_steps):
        key, sub = prng.split(key)
        prompts = torch.as_tensor(tasks.sample(N_PROMPTS, N_PER).prompts,
                                  device=dev)
        roll = generate(state.params, cfg, prompts, max_new=VLM_TRAIN_NEW,
                        key=sub, chunk=CHUNK, extra=extra)
        mask = action_mask(roll)
        batch = {"tokens": roll.tokens, "behavior_logp": roll.behavior_logp,
                 "advantages": torch.zeros_like(mask), "mask": mask,
                 "ref_logp": vlm_score(torch, ref_params, cfg, roll.tokens,
                                       extra), **extra}
        state, m = step(state, batch)
        log(f"  step {i}: loss {float(m['loss']):.5f}, grad_norm "
            f"{float(m['grad_norm']):.4f}")
        require(math.isfinite(float(m["loss"]))
                and math.isfinite(float(m["grad_norm"]))
                and float(m["grad_norm"]) > 0, f"step {i}: {m}")
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)  # ... and ends here
    wall = time.perf_counter() - t0
    after = leaves_by_path(state.params)
    still = [".".join(k) for k in watched
             if fingerprint(torch, {"": after[k]}) == before[k]]
    require(not still, f"leaves that did not move: {still}")
    want = {"fused_sample": n_steps * VLM_TRAIN_NEW,
            "flash_attention": n_steps * 3 * L,
            "fused_logprob": 2 * n_steps, "fused_logprob_bwd": n_steps}
    require(launches == want, f"vlm train launch counts {launches}, want "
            f"{want} (per step: the rollout's prefill, the reference's and "
            "the trainer's forward through flash_attention; the "
            "reference's and the trainer's log-probs; one backward)")
    log(f"  {n_steps} steps in {wall:.1f} s (rollouts and scoring "
        f"included); moved: {len(watched)} leaves (every matrix and bias "
        "but the unread b_up); "
        f"launches {launches}; peak memory allocated "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del state, params, ref_params, batch, roll, after
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def vlm_numerics(torch, dev):
    """[18] (c): the smoke config in fp32 on the card against the CPU
    port: logits, then prefill across the patch prefix + decode against
    the teacher-forced forward (the reference's 1e-3), then a batch
    rollout with the patches whose mu is within 1e-3 of the reference's
    log-probs.  Returns the launch counts of the rollout."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.kernels import build
    from repro_torch.models import decode_step, forward_train, \
        init_params, prefill
    from repro_torch.rl import prng
    from repro_torch.rl.data import ArithmeticTasks
    from repro_torch.rl.rollout import action_mask, generate
    from repro_torch.train.optimizer import tree_map

    cfg = configs.get_smoke(VLM_ARCH)
    params = init_params(cfg, seed=5, dtype=torch.float32, device=dev)
    host = tree_map(lambda t: t.cpu(), params)
    S, n, P = VLM_SMOKE_PROMPT, VLM_SMOKE_NEW, cfg.frontend_tokens
    rng = np.random.default_rng(5)
    ids = torch.as_tensor(rng.integers(0, cfg.vocab, (2, S + n)),
                          dtype=torch.int32)
    pe = torch.as_tensor(rng.standard_normal((2, P, cfg.d_model)) * 0.02,
                         dtype=torch.float32)
    toks, pe_dev = ids.to(dev), pe.to(dev)
    with torch.no_grad():
        full, _ = forward_train(params, cfg, {"tokens": toks,
                                              "patch_embeds": pe_dev})
        full_cpu, _ = forward_train(host, cfg, {"tokens": ids,
                                                "patch_embeds": pe})
        fwd_err = max_err(full.cpu(), full_cpu)
        last, cache = prefill(params, cfg, {"tokens": toks[:, :S],
                                            "patch_embeds": pe_dev},
                              cache_len=P + S + n, dtype=torch.float32)
        dec_err = max_err(last, full[:, S - 1])
        for i in range(n):
            lg, cache = decode_step(params, cfg, cache,
                                    toks[:, S + i:S + i + 1])
            dec_err = max(dec_err, max_err(lg, full[:, S + i]))
    log(f"  (c) {cfg.name} smoke fp32 ({cfg.n_layers} layers, d "
        f"{cfg.d_model}, {P} patches): card against CPU logits "
        f"{fwd_err:.3e}; prefill of {P} + {S} and {n} decode steps against "
        f"the teacher-forced forward: max|dlogits| {dec_err:.3e} "
        "(tolerance 1e-3 each)")
    require(max(fwd_err, dec_err) <= 1e-3, "[18] (c) numerics")
    prompts = torch.as_tensor(ArithmeticTasks(seed=5).sample(1, N_PER)
                              .prompts, device=dev)
    extra = {"patch_embeds": vlm_patches(torch, cfg, N_PER, dev, seed=5)}
    build.reset_launches()          # the rollout's run starts here
    roll = generate(params, cfg, prompts, max_new=MAX_NEW,
                    key=prng.PRNGKey(5), chunk=CHUNK, extra=extra)
    ref = vlm_score(torch, params, cfg, roll.tokens, extra)
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)  # ... and ends here
    L = cfg.n_layers
    want = {"flash_attention": 2 * L, "fused_sample": MAX_NEW,
            "fused_logprob": 1}
    require(launches == want, f"fp32 vlm rollout launches {launches}, want "
            f"{want}")
    d = _check_outputs(torch, {"tokens": roll.tokens,
                               "mask": action_mask(roll),
                               "behavior_logp": roll.behavior_logp,
                               "ref_logp": ref}, cfg.vocab)
    log(f"  fp32 batch rollout with patches, {N_PER} samples of {MAX_NEW} "
        f"tokens: |behavior_logp - ref_logp| at {d.numel()} actions: max "
        f"{d.max().item():.2e} (tolerance 1e-3); launches {launches}")
    require(d.max().item() <= 1e-3, "fp32 vlm rollout mu vs reference")
    del params, host, cache, roll
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_vlm(torch, dev):
    """[18]: the VLM family.  Returns the launch counts of its main-path
    runs."""
    log(f"[18] vlm: {VLM_ARCH} at full width and depth served, "
        f"{VLM_TRAIN_LAYERS} layers trained, its smoke config in fp32; "
        f"{nvidia_smi()}")
    from repro_torch import configs
    cfg = configs.get_config(VLM_ARCH)
    V, P, B = cfg.vocab, cfg.frontend_tokens, N_PROMPTS * N_PER
    t0 = time.perf_counter()
    launches = collections.Counter()
    dense = ("fused_sample_cuda", "fused_logprob_cuda",
             "flash_attention_cuda")
    parts = [time.perf_counter()]
    with KernelCalls(torch, per_shape=1, names=KernelCalls.ENGINE) as calls:
        launches.update(vlm_serve(torch, dev))
    for line in calls.replay("[18] (a)", expect=dense):
        log(line)
    got = {n: {tuple(args[0].shape) for args, _, _ in calls.calls[n]}
           for n in dense}
    want = {"fused_sample_cuda": {(B, V)},
            "fused_logprob_cuda": {(B, VLM_PROMPT + VLM_NEW - 1, V)},
            "flash_attention_cuda": {
                (B, P + VLM_PROMPT, cfg.n_heads, cfg.hd),
                (B, P + VLM_PROMPT + VLM_NEW, cfg.n_heads, cfg.hd)}}
    require(got == want, f"[18] (a) shapes {got}, want {want}")
    del calls
    gc.collect()
    torch.cuda.empty_cache()
    parts.append(time.perf_counter())
    with KernelCalls(torch, host=True, names=KernelCalls.ENGINE) as calls:
        launches.update(vlm_train(torch, dev))
    for line in calls.replay("[18] (b)", expect=dense + (
            "fused_logprob_bwd_cuda",)):
        log(line)
    del calls
    parts.append(time.perf_counter())
    with KernelCalls(torch, names=KernelCalls.ENGINE) as calls:
        launches.update(vlm_numerics(torch, dev))
    for line in calls.replay("[18] (c)", expect=dense):
        log(line)
    del calls
    parts.append(time.perf_counter())
    launches = dict(launches)
    for name in KERNELS[:4]:
        require(launches.get(name, 0) > 0, f"{name} never ran in [18]")
    # both packages' engines refuse the VLM family
    require(launches.get("paged_attention", 0) == 0,
            "paged_attention ran in [18]")
    log(f"  [18] launches {launches}; {time.perf_counter() - t0:.1f} s "
        f"((a), (b), (c) with their replays: "
        + ", ".join(f"{b - a:.1f}" for a, b in zip(parts, parts[1:]))
        + " s)")
    return launches


HYBRID_ARCH = "zamba2-7b"
# (a): full width and depth (6.75 B params, 13.5 GB in bf16): prompts of
# 256 ids, two SSD chunks of 128
HYBRID_PROMPT, HYBRID_NEW = 256, 32
# (b): 24 of 81 layers (4 applications of the shared block), 2.31 B
# params, 27.7 GB of trainer state (81 GB at full depth)
HYBRID_TRAIN_LAYERS = 24
# (c): the smoke config's prompts (past one SSD chunk of 32) and decoded
# tokens, and the chunked SSD's sequence against the stepwise recurrence
HYBRID_SMOKE_PROMPT, HYBRID_SMOKE_NEW, HYBRID_SSD_SEQ = 40, 8, 45


def mamba_profile(torch, fn):
    """range_profile with every Mamba2 mixer call (``mamba2_forward`` and
    ``mamba2_decode``: projections, convolution, SSD or recurrence, gate
    and norm) inside a ``mamba2`` range."""
    from repro_torch.models import ssm
    return range_profile(torch, fn, "mamba2", [(ssm, "mamba2_forward"),
                                               (ssm, "mamba2_decode")])


def hybrid_serve(torch, dev):
    """[19] (a): zamba2-7b at full width and depth, bf16: a batch rollout
    through GeneratorExecutor scored by RefPolicyExecutor; prefill and
    decode times, the Mamba2 mixer's share of each, the recurrent state's
    bytes against a KV cache of the same depth.  Returns the launch
    counts of the run."""
    from repro_torch import configs
    from repro_torch.core.executor import GeneratorExecutor, \
        RefPolicyExecutor, RewardExecutor
    from repro_torch.kernels import build
    from repro_torch.models import backbone as bb
    from repro_torch.models import init_params
    from repro_torch.models.ssm import _mamba_dims
    from repro_torch.rl.data import ArithmeticTasks

    cfg = configs.get_config(HYBRID_ARCH)
    s, L, B = cfg.ssm, cfg.n_layers, N_PROMPTS * N_PER
    G = len(bb.hybrid_groups(cfg))
    d_in, H, Ph, N = _mamba_dims(cfg)
    log(f"  (a) serve {HYBRID_ARCH} at full width and depth ({L} Mamba2 "
        f"layers, d {cfg.d_model}, d_inner {d_in}, {H} SSM heads of {Ph}, "
        f"state {N}, chunk {s.chunk}; one shared attention block of "
        f"{cfg.n_heads} heads of {cfg.hd} and d_ff {cfg.d_ff} before every "
        f"{cfg.shared_attn_every}: {G} applications; V {cfg.vocab}); bf16;"
        f" {N_PROMPTS} prompts x {N_PER} samples of {HYBRID_PROMPT} ids, "
        f"{HYBRID_NEW} new tokens in chunks of {CHUNK}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in leaves(params))
    log(f"  init: {n / 1e9:.3f} B params, {2 * n / 1e9:.2f} GB, "
        f"{time.perf_counter() - t0:.1f} s, peak memory allocated "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    gen = GeneratorExecutor(cfg, ArithmeticTasks(prompt_len=HYBRID_PROMPT,
                                                 seed=0),
                            n_prompts=N_PROMPTS, n_per_prompt=N_PER,
                            max_new=HYBRID_NEW, chunk=CHUNK, temperature=1.0,
                            seed=0, device=dev)
    gen.set_weights(params, version=0)
    ref = RefPolicyExecutor(cfg)
    ref.set_weights(params)
    rew = RewardExecutor(n_per_prompt=N_PER, leave_one_out=True)
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()          # the batch rollout's run starts here
    t0 = time.perf_counter()
    gen.begin_batch()
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    job, state = gen.begin_batch()
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    prefill_peak = torch.cuda.max_memory_allocated() / 1e9
    busy_p, mamba_p, _ = mamba_profile(torch, gen.begin_batch)
    cache = state.cache
    T = cache["attn"]["k"].shape[2]
    require(cache["pos"] == HYBRID_PROMPT and T == HYBRID_PROMPT + HYBRID_NEW
            and cache["attn"]["k"].shape[0] == G
            and cache["mamba"]["ssm"].shape == (L, B, H, Ph, N),
            f"hybrid cache {cache['pos']}, "
            f"{ {k: tuple(v.shape) for k, v in cache['attn'].items()} }")
    state_bytes = sum(t.nbytes for t in cache["mamba"].values())
    ring_bytes = sum(cache["attn"][k].nbytes for k in ("k", "v"))
    kv_per_layer = ring_bytes // G
    busy, mamba_ms, ops = profiled_decode(
        torch, mamba_profile, params, cfg, cache,
        state.tokens[:, HYBRID_PROMPT - 1:HYBRID_PROMPT])
    t0 = time.perf_counter()
    for _ in range(job.n_chunks):
        state = gen.advance_chunk(job, state)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3 / HYBRID_NEW
    out = gen.emit_batch(job, state)
    t0 = time.perf_counter()
    ref.put_input("completions", out)
    ref.step()
    torch.cuda.synchronize()
    t_ref = time.perf_counter() - t0
    rew.put_input("completions_with_ref", ref.get_output("completions_with_ref"))
    out = rew.step()
    launches = dict(build.LAUNCHES)  # ... and ends here
    want = {"flash_attention": 4 * G, "fused_sample": HYBRID_NEW,
            "fused_logprob": 1}
    require(launches == want, f"hybrid rollout launch counts {launches}, "
            f"want {want} (three prefills and one scoring, the shared "
            f"block's {G} applications each through flash_attention at hd "
            f"{cfg.hd}; fused_sample a decoded token)")
    d = _check_outputs(torch, out, cfg.vocab)
    log(f"  prefill [{B}, {HYBRID_PROMPT}]: {prefill_ms:.1f} ms (the first "
        f"{first_ms:.1f} ms); profiled: device busy {busy_p:.1f} ms, of "
        f"which the Mamba2 mixers {mamba_p:.1f} ms "
        + (f"({100 * mamba_p / busy_p:.1f}%)" if busy_p else "(not measured)")
        + f"; peak memory through the prefills {prefill_peak:.2f} GB")
    log(f"  recurrent state (the rollout's, fp32): {state_bytes / 1e6:.1f} "
        f"MB for {L} layers x {B} rows, whatever the length (conv "
        f"{s.d_conv - 1} x {d_in + 2 * N} and SSM {H} x {Ph} x {N} values "
        f"a row a layer); the shared block's ring {ring_bytes / 1e6:.1f} MB "
        f"({G} x {T} positions); a KV cache of the same depth ({L} layers "
        f"of {cfg.n_kv_heads} heads of {cfg.hd}) would hold "
        f"{L * kv_per_layer / 1e9:.2f} GB at {T} positions, "
        f"{L * kv_per_layer / state_bytes:.1f}x the state")
    busy, mamba_ms = busy / PROFILED_STEPS, mamba_ms / PROFILED_STEPS
    log(f"  decode {decode_ms:.2f} ms per token (batch {B}, "
        f"{job.n_chunks} unprofiled chunks); {PROFILED_STEPS} profiled "
        f"decode steps: device busy {busy:.2f} ms per token = "
        f"{100 * busy / decode_ms:.1f}% of it; the Mamba2 mixers "
        f"{mamba_ms:.2f} ms per token = "
        + (f"{100 * mamba_ms / busy:.1f}%" if busy else "not measured")
        + " of the device time; top device operations (ms per token): "
        + ", ".join(f"{e.key[:48]} "
                    f"{e.self_device_time_total / 1e3 / PROFILED_STEPS:.3f}"
                    for e in ops[:6]))
    log(f"  reference {t_ref * 1e3:.1f} ms over [{B}, "
        f"{HYBRID_PROMPT + HYBRID_NEW}]; |behavior_logp - ref_logp| at "
        f"{d.numel()} actions (bf16): mean {d.mean().item():.4f}, max "
        f"{d.max().item():.4f}; launches {launches}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del job, state, cache, out, gen, ref, rew, params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def hybrid_train(torch, dev):
    """[19] (b): two steps of the sequential async loop at full width cut
    to HYBRID_TRAIN_LAYERS layers, sequences of 80, KL 0.1 against a
    frozen reference from another seed, through the executors and
    SyncExecutorController as [15] (b).  Returns the launch counts."""
    from repro_torch import configs
    from repro_torch.core.channels import CommType, CommunicationChannel, \
        WeightsCommunicationChannel
    from repro_torch.core.controller import SyncExecutorController
    from repro_torch.core.executor import GeneratorExecutor, \
        RefPolicyExecutor, RewardExecutor, TrainerExecutor
    from repro_torch.kernels import build
    from repro_torch.models import backbone as bb
    from repro_torch.models import init_params
    from repro_torch.rl.data import ArithmeticTasks

    full = configs.get_config(HYBRID_ARCH)
    cfg = full.replace(name=f"{HYBRID_ARCH}-{HYBRID_TRAIN_LAYERS}l",
                       n_layers=HYBRID_TRAIN_LAYERS)
    G, n_steps = len(bb.hybrid_groups(cfg)), 2
    torch.cuda.reset_peak_memory_stats()
    gen = GeneratorExecutor(cfg, ArithmeticTasks(seed=0),
                            n_prompts=N_PROMPTS, n_per_prompt=N_PER,
                            max_new=MAX_NEW, chunk=CHUNK, temperature=1.0,
                            seed=0, device=dev)
    ref = RefPolicyExecutor(cfg)
    ref.set_weights(init_params(cfg, seed=1, dtype=torch.bfloat16,
                                device=dev))
    rew = RewardExecutor(n_per_prompt=N_PER, leave_one_out=True)
    trn = TrainerExecutor(cfg, dtype=torch.bfloat16, kl_coef=KL_COEF,
                          seed=0, device=dev)
    ctl = SyncExecutorController(
        [gen, ref, rew, trn],
        [WeightsCommunicationChannel("policy_model", trn, gen),
         CommunicationChannel("completions", gen, ref, CommType.BROADCAST),
         CommunicationChannel("completions_with_ref", ref, rew,
                              CommType.GATHER),
         CommunicationChannel("completions_with_reward", rew, trn,
                              CommType.SCATTER)],
        max_steps=n_steps, mode="async", staleness=1)
    ctl.init()
    params = trn.get_model()
    n = sum(t.numel() for t in leaves(params))
    seq = gen.tasks.prompt_len + MAX_NEW
    log(f"  (b) train {HYBRID_ARCH} at full width, {cut_line(full, cfg)} "
        f"({G} applications of the shared block): {n / 1e9:.3f} B params, "
        f"trainer state {12 * n / 1e9:.1f} GB ({12 * param_total(full) / 1e9:.1f}"
        f" GB at full depth); {n_steps} steps of the async schedule, "
        f"staleness 1, KL {KL_COEF}; sequences of {seq}")
    # every leaf but the norms (1.0, which bf16 steps of 1e-3 do not move)
    watched = [k for k in leaves_by_path(params)
               if k[-1] not in ("ln1", "ln2", "final_norm", "gate_norm")]
    before = {k: fingerprint(torch, {"": t})
              for k, t in leaves_by_path(params).items() if k in watched}
    del params
    t0 = time.perf_counter()
    build.reset_launches()          # the train path's run starts here
    history = ctl.run()
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)  # ... and ends here
    wall = time.perf_counter() - t0
    for h in history:
        log(f"  step {h['step']}: loss {h['loss']:.5f}, grad_norm "
            f"{h['grad_norm']:.4f}, weight_version {h['weight_version']}")
        require(h["weight_version"] == max(0, h["step"] - 1)
                and math.isfinite(h["loss"])
                and math.isfinite(h["grad_norm"]), f"step {h}")
    after = leaves_by_path(trn.get_model())
    still = [".".join(k) for k in watched
             if fingerprint(torch, {"": after[k]}) == before[k]]
    require(not still, f"leaves that did not move: {still}")
    mamba = after[("mamba_layers", "mamba", "A_log")]
    require(mamba.dtype == torch.float32, f"A_log became {mamba.dtype}")
    want = {"fused_sample": n_steps * MAX_NEW,
            "flash_attention": n_steps * 3 * G,
            "fused_logprob": 2 * n_steps, "fused_logprob_bwd": n_steps}
    require(launches == want, f"hybrid train launch counts {launches}, "
            f"want {want} (per step: the generator's prefill, the "
            "reference's and the trainer's forward, the shared block's "
            f"{G} applications each through flash_attention, whose "
            "gradient recomputes through chunked_attention)")
    log(f"  {n_steps} steps in {wall:.1f} s; moved: {len(watched)} leaves "
        f"(A_log, D_skip and dt_bias fp32 among bf16); launches "
        f"{launches}; peak memory allocated "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del ctl, gen, ref, rew, trn, after
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def hybrid_numerics(torch, dev):
    """[19] (c): the smoke config in fp32 on the card against the CPU
    port: logits; prefill + decode against the teacher-forced forward;
    one layer's chunked SSD against its stepwise recurrence
    (``mamba2_decode`` a token at a time), at a length no multiple of
    the chunk; each within the reference's 1e-3; then a batch rollout
    whose mu is within 1e-3 of the reference's log-probs.  Returns the
    launch counts of the rollout."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.core.executor import GeneratorExecutor, \
        RefPolicyExecutor, RewardExecutor
    from repro_torch.kernels import build
    from repro_torch.models import backbone as bb
    from repro_torch.models import decode_step, forward_train, \
        init_params, prefill, ssm
    from repro_torch.rl.data import ArithmeticTasks
    from repro_torch.train.optimizer import tree_map

    cfg = configs.get_smoke(HYBRID_ARCH)
    params = init_params(cfg, seed=5, dtype=torch.float32, device=dev)
    host = tree_map(lambda t: t.cpu(), params)
    S, n = HYBRID_SMOKE_PROMPT, HYBRID_SMOKE_NEW
    rng = np.random.default_rng(5)
    ids = torch.as_tensor(rng.integers(0, cfg.vocab, (2, S + n)),
                          dtype=torch.int32)
    toks = ids.to(dev)
    with torch.no_grad():
        full, _ = forward_train(params, cfg, {"tokens": toks})
        full_cpu, _ = forward_train(host, cfg, {"tokens": ids})
        fwd_err = max_err(full.cpu(), full_cpu)
        last, cache = prefill(params, cfg, {"tokens": toks[:, :S]},
                              cache_len=S + n, dtype=torch.float32)
        dec_err = max_err(last, full[:, S - 1])
        for i in range(n):
            lg, cache = decode_step(params, cfg, cache,
                                    toks[:, S + i:S + i + 1])
            dec_err = max(dec_err, max_err(lg, full[:, S + i]))
        p = bb.unstack(params["mamba_layers"], cfg.n_layers)[0]["mamba"]
        x = torch.as_tensor(rng.standard_normal(
            (2, HYBRID_SSD_SEQ, cfg.d_model)) * 0.3, dtype=torch.float32,
            device=dev)
        y = ssm.mamba2_forward(p, x, cfg)
        st = ssm.mamba2_init_state(cfg, 2, device=dev)
        steps = []
        for t in range(HYBRID_SSD_SEQ):
            yt, st = ssm.mamba2_decode(p, x[:, t:t + 1], st, cfg)
            steps.append(yt)
        ssd_err = max_err(y, torch.cat(steps, dim=1))
    log(f"  (c) {cfg.name} smoke fp32 ({cfg.n_layers} layers, d "
        f"{cfg.d_model}, SSD chunk {cfg.ssm.chunk}): card against CPU "
        f"logits {fwd_err:.3e}; prefill of {S} + {n} decode steps against "
        f"the teacher-forced forward: max|dlogits| {dec_err:.3e}; the "
        f"chunked SSD against {HYBRID_SSD_SEQ} mamba2_decode steps: max|dy| "
        f"{ssd_err:.3e} (tolerance 1e-3 each)")
    require(max(fwd_err, dec_err, ssd_err) <= 1e-3, "[19] (c) numerics")
    del full, full_cpu, cache, host

    gen = GeneratorExecutor(cfg, ArithmeticTasks(seed=5), n_prompts=1,
                            n_per_prompt=N_PER, max_new=MAX_NEW,
                            chunk=CHUNK, temperature=1.0, seed=5, device=dev)
    gen.set_weights(params, version=0)
    ref = RefPolicyExecutor(cfg)
    ref.set_weights(params)
    rew = RewardExecutor(n_per_prompt=N_PER, leave_one_out=True)
    build.reset_launches()          # the rollout's run starts here
    ref.put_input("completions", gen.step())
    ref.step()
    rew.put_input("completions_with_ref", ref.get_output("completions_with_ref"))
    out = rew.step()
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)  # ... and ends here
    G = len(bb.hybrid_groups(cfg))
    want = {"flash_attention": 2 * G, "fused_sample": MAX_NEW,
            "fused_logprob": 1}
    require(launches == want, f"fp32 hybrid rollout launches {launches}, "
            f"want {want}")
    d = _check_outputs(torch, out, cfg.vocab)
    log(f"  fp32 batch rollout, {N_PER} samples of {MAX_NEW} tokens: "
        f"|behavior_logp - ref_logp| at {d.numel()} actions (stepwise decode "
        f"against the chunked forward): max {d.max().item():.2e} "
        f"(tolerance 1e-3); launches {launches}")
    require(d.max().item() <= 1e-3, "fp32 hybrid rollout mu vs reference")
    del gen, ref, rew, params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_hybrid(torch, dev):
    """[19]: the hybrid family.  Returns the launch counts of its
    main-path runs."""
    log(f"[19] hybrid: {HYBRID_ARCH} at full width and depth served, "
        f"{HYBRID_TRAIN_LAYERS} layers trained, its smoke config in fp32; "
        f"{nvidia_smi()}")
    from repro_torch import configs
    cfg = configs.get_config(HYBRID_ARCH)
    V, B, T = cfg.vocab, N_PROMPTS * N_PER, HYBRID_PROMPT + HYBRID_NEW
    t0 = time.perf_counter()
    launches = collections.Counter()
    dense = ("fused_sample_cuda", "fused_logprob_cuda",
             "flash_attention_cuda")
    parts = [time.perf_counter()]
    with KernelCalls(torch, per_shape=1, names=KernelCalls.ENGINE) as calls:
        launches.update(hybrid_serve(torch, dev))
    for line in calls.replay("[19] (a)", expect=dense):
        log(line)
    got = {n: {tuple(args[0].shape) for args, _, _ in calls.calls[n]}
           for n in dense}
    want = {"fused_sample_cuda": {(B, V)},
            "fused_logprob_cuda": {(B, T - 1, V)},
            "flash_attention_cuda": {(B, HYBRID_PROMPT, cfg.n_heads, cfg.hd),
                                     (B, T, cfg.n_heads, cfg.hd)}}
    require(got == want, f"[19] (a) shapes {got}, want {want}")
    del calls
    gc.collect()
    torch.cuda.empty_cache()
    parts.append(time.perf_counter())
    with KernelCalls(torch, host=True, names=KernelCalls.ENGINE) as calls:
        launches.update(hybrid_train(torch, dev))
    for line in calls.replay("[19] (b)", expect=dense + (
            "fused_logprob_bwd_cuda",)):
        log(line)
    del calls
    parts.append(time.perf_counter())
    with KernelCalls(torch, names=KernelCalls.ENGINE) as calls:
        launches.update(hybrid_numerics(torch, dev))
    for line in calls.replay("[19] (c)", expect=dense):
        log(line)
    del calls
    parts.append(time.perf_counter())
    launches = dict(launches)
    for name in KERNELS[:4]:
        require(launches.get(name, 0) > 0, f"{name} never ran in [19]")
    # both packages' engines refuse the hybrid family
    require(launches.get("paged_attention", 0) == 0,
            "paged_attention ran in [19]")
    log(f"  [19] launches {launches}; {time.perf_counter() - t0:.1f} s "
        f"((a), (b), (c) with their replays: "
        + ", ".join(f"{b - a:.1f}" for a, b in zip(parts, parts[1:]))
        + " s)")
    return launches


XLSTM_ARCH = "xlstm-350m"
# (a): full width and depth (467 M params in the tree, 0.93 GB in bf16):
# prompts of 256 ids (4 mLSTM chunks of 64) and 64 new tokens, scored at
# [16, 320] (5 chunks): a length above 64 must be a multiple of 64, in
# both packages
XLSTM_PROMPT, XLSTM_NEW = 256, 64
# (b): prompts of 16 ids and 16 new tokens, sequences of 32.  At full
# width the reference's sLSTM init (r_h with H as its fan-in: a
# recurrent gain near 8) makes the recurrence chaotic: the gradient
# through it grows about 1.6x a step, and it swamps the rest once
# clipped.  Over 128 steps the square of its norm passes fp32's range,
# the global norm reads inf in both packages (tests/test_torch_xlstm.py)
# and clipping zeroes the step; over 64 the norm is 1.4e14-1.7e14 and,
# clipped to 1, the gradients of the layers after the last sLSTM fall
# below Adam's eps, so those 19 leaves do not move; over 32 it is about
# 1e8 and every leaf moves
XLSTM_TRAIN_PROMPT, XLSTM_TRAIN_NEW = 16, 16
# (c): the smoke config's prompt and decoded tokens, the reference's own
# 16 + 4 (the sLSTM at its init amplifies rounding about tenfold every 20
# steps, tests/test_torch_xlstm.py), the rollout's 16 + 16, and the
# mLSTM's sequence across two chunks against its stepwise decode
XLSTM_SMOKE_PROMPT, XLSTM_SMOKE_NEW, XLSTM_ROLL_NEW = 16, 4, 16
XLSTM_MLSTM_SEQ = 128


def xlstm_profile(torch, fn):
    """ranges_profile with every mLSTM call (``mlstm_forward`` and
    ``mlstm_decode``: projections, chunked core or recurrence, norm) in
    an ``mlstm`` range and every sLSTM call in an ``slstm`` range."""
    from repro_torch.models import ssm
    return ranges_profile(torch, fn, {
        "mlstm": [(ssm, "mlstm_forward"), (ssm, "mlstm_decode")],
        "slstm": [(ssm, "slstm_forward"), (ssm, "slstm_decode")]})


def shares(busy, ranged) -> str:
    """Each range's device ms and its share of ``busy``."""
    return ", ".join(
        f"{k} {v:.2f} ms ("
        + (f"{100 * v / busy:.1f}%" if busy else "not measured") + ")"
        for k, v in ranged.items())


def xlstm_serve(torch, dev):
    """[20] (a): xlstm-350m at full width and depth, bf16: a batch rollout
    through GeneratorExecutor scored by RefPolicyExecutor at [16, 320];
    prefill and decode times, the mLSTM and sLSTM ranges' shares of each,
    the recurrent state's bytes.  Returns the launch counts of the run."""
    from repro_torch import configs
    from repro_torch.core.executor import GeneratorExecutor, \
        RefPolicyExecutor, RewardExecutor
    from repro_torch.kernels import build
    from repro_torch.models import init_params
    from repro_torch.models.ssm import _mlstm_dims
    from repro_torch.rl.data import ArithmeticTasks

    cfg = configs.get_config(XLSTM_ARCH)
    L, B = cfg.n_layers, N_PROMPTS * N_PER
    d_in, H, Ph = _mlstm_dims(cfg)
    sl = cfg.xlstm.slstm_layers
    log(f"  (a) serve {XLSTM_ARCH} at full width and depth ({L} blocks, "
        f"sLSTM at {list(sl)} and mLSTM elsewhere; d {cfg.d_model}, "
        f"{H} heads, mLSTM inner width {d_in} (head dim {Ph}), V "
        f"{cfg.vocab} tied); bf16; {N_PROMPTS} prompts x {N_PER} samples "
        f"of {XLSTM_PROMPT} ids, {XLSTM_NEW} new tokens in chunks of "
        f"{CHUNK}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in leaves(params))
    log(f"  init: {n / 1e9:.3f} B params ({param_total(cfg) / 1e9:.3f} B by "
        f"param_count), {2 * n / 1e9:.2f} GB, "
        f"{time.perf_counter() - t0:.1f} s, peak memory allocated "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    gen = GeneratorExecutor(cfg, ArithmeticTasks(prompt_len=XLSTM_PROMPT,
                                                 seed=0),
                            n_prompts=N_PROMPTS, n_per_prompt=N_PER,
                            max_new=XLSTM_NEW, chunk=CHUNK, temperature=1.0,
                            seed=0, device=dev)
    gen.set_weights(params, version=0)
    ref = RefPolicyExecutor(cfg)
    ref.set_weights(params)
    rew = RewardExecutor(n_per_prompt=N_PER, leave_one_out=True)
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()          # the batch rollout's run starts here
    t0 = time.perf_counter()
    gen.begin_batch()
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    job, state = gen.begin_batch()
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    prefill_peak = torch.cuda.max_memory_allocated() / 1e9
    busy_p, ranged_p, _ = xlstm_profile(torch, gen.begin_batch)
    cache = state.cache
    states = cache["xlstm"]
    require(cache["pos"] == XLSTM_PROMPT and len(states) == L
            and all(isinstance(states[i], dict) == (i in sl)
                    for i in range(L))
            and states[0][0].shape == (B, H, Ph, Ph),
            f"xlstm cache pos {cache['pos']}, {len(states)} states")
    state_bytes = sum(t.nbytes for t in leaves(states))
    c_bytes = sum(states[i][0].nbytes for i in range(L) if i not in sl)
    busy, ranged, ops = profiled_decode(
        torch, xlstm_profile, params, cfg, cache,
        state.tokens[:, XLSTM_PROMPT - 1:XLSTM_PROMPT])
    t0 = time.perf_counter()
    for _ in range(job.n_chunks):
        state = gen.advance_chunk(job, state)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3 / XLSTM_NEW
    out = gen.emit_batch(job, state)
    t0 = time.perf_counter()
    ref.put_input("completions", out)
    ref.step()
    torch.cuda.synchronize()
    t_ref = time.perf_counter() - t0
    rew.put_input("completions_with_ref", ref.get_output("completions_with_ref"))
    out = rew.step()
    launches = dict(build.LAUNCHES)  # ... and ends here
    want = {"fused_sample": XLSTM_NEW, "fused_logprob": 1}
    require(launches == want, f"xlstm rollout launch counts {launches}, "
            f"want {want} (fused_sample a decoded token, fused_logprob the "
            "scoring; no attention anywhere)")
    d = _check_outputs(torch, out, cfg.vocab)
    log(f"  prefill [{B}, {XLSTM_PROMPT}]: {prefill_ms:.1f} ms (the first "
        f"{first_ms:.1f} ms); profiled: device busy {busy_p:.1f} ms, "
        f"{shares(busy_p, ranged_p)}; peak memory through the prefills "
        f"{prefill_peak:.2f} GB")
    log(f"  recurrent state (fp32, whatever the length): "
        f"{state_bytes / 1e9:.3f} GB for {B} rows, of which the "
        f"{L - len(sl)} mLSTM memories C ({H} x {Ph} x {Ph} a row) "
        f"{c_bytes / 1e9:.3f} GB, {c_bytes / B / 1e6:.1f} MB a row")
    busy /= PROFILED_STEPS
    ranged = {k: v / PROFILED_STEPS for k, v in ranged.items()}
    log(f"  decode {decode_ms:.2f} ms per token (batch {B}, "
        f"{job.n_chunks} unprofiled chunks); {PROFILED_STEPS} profiled "
        f"decode steps: device busy {busy:.2f} ms per token = "
        f"{100 * busy / decode_ms:.1f}% of it; {shares(busy, ranged)} per "
        "token; top device operations (ms per token): "
        + ", ".join(f"{e.key[:48]} "
                    f"{e.self_device_time_total / 1e3 / PROFILED_STEPS:.3f}"
                    for e in ops[:6]))
    log(f"  reference {t_ref * 1e3:.1f} ms over [{B}, "
        f"{XLSTM_PROMPT + XLSTM_NEW}]; |behavior_logp - ref_logp| at "
        f"{d.numel()} actions (bf16; the sLSTM amplifies the stepwise and "
        f"chunked forms' rounding): mean {d.mean().item():.4f}, max "
        f"{d.max().item():.4f}; launches {launches}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del job, state, cache, states, out, gen, ref, rew, params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def xlstm_train(torch, dev):
    """[20] (b): two steps of the sequential async loop (staleness 1) at
    full width and depth, bf16 params and fp32 Adam, sequences of 32, KL
    0.1 against a frozen reference from another seed, through the
    executors and SyncExecutorController: the list of xLSTM layers
    through Adam, weight sync and the generator.  Every leaf but the
    norms must move (a whole-leaf compare: the optimizer builds new
    tensors).  Sequences of 32: see XLSTM_TRAIN_PROMPT.  Returns the
    launch counts."""
    from repro_torch import configs
    from repro_torch.core.channels import CommType, CommunicationChannel, \
        WeightsCommunicationChannel
    from repro_torch.core.controller import SyncExecutorController
    from repro_torch.core.executor import GeneratorExecutor, \
        RefPolicyExecutor, RewardExecutor, TrainerExecutor
    from repro_torch.kernels import build
    from repro_torch.models import init_params
    from repro_torch.rl.data import ArithmeticTasks

    cfg = configs.get_config(XLSTM_ARCH)
    n_steps = 2
    torch.cuda.reset_peak_memory_stats()
    gen = GeneratorExecutor(cfg, ArithmeticTasks(
        prompt_len=XLSTM_TRAIN_PROMPT, seed=0), n_prompts=N_PROMPTS,
        n_per_prompt=N_PER, max_new=XLSTM_TRAIN_NEW, chunk=CHUNK,
        temperature=1.0, seed=0, device=dev)
    ref = RefPolicyExecutor(cfg)
    ref.set_weights(init_params(cfg, seed=1, dtype=torch.bfloat16,
                                device=dev))
    rew = RewardExecutor(n_per_prompt=N_PER, leave_one_out=True)
    trn = TrainerExecutor(cfg, dtype=torch.bfloat16, kl_coef=KL_COEF,
                          seed=0, device=dev)
    ctl = SyncExecutorController(
        [gen, ref, rew, trn],
        [WeightsCommunicationChannel("policy_model", trn, gen),
         CommunicationChannel("completions", gen, ref, CommType.BROADCAST),
         CommunicationChannel("completions_with_ref", ref, rew,
                              CommType.GATHER),
         CommunicationChannel("completions_with_reward", rew, trn,
                              CommType.SCATTER)],
        max_steps=n_steps, mode="async", staleness=1)
    ctl.init()
    before = {k: t for k, t in leaves_by_path(trn.get_model()).items()
              if "norm" not in k[-1] and not k[-1].startswith("ln")}
    n = sum(t.numel() for t in leaves(trn.get_model()))
    log(f"  (b) train {XLSTM_ARCH} at full width and depth: {n / 1e9:.3f} B "
        f"params, trainer state {12 * n / 1e9:.1f} GB; {n_steps} steps of "
        f"the async schedule, staleness 1, KL {KL_COEF}; sequences of "
        f"{XLSTM_TRAIN_PROMPT + XLSTM_TRAIN_NEW} (longer, the gradient "
        "through the reference's chaotic sLSTM init swamps the rest)")
    t0 = time.perf_counter()
    build.reset_launches()          # the train path's run starts here
    history = ctl.run()
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)  # ... and ends here
    wall = time.perf_counter() - t0
    for h in history:
        log(f"  step {h['step']}: loss {h['loss']:.5f}, grad_norm "
            f"{h['grad_norm']:.4g}, weight_version {h['weight_version']}")
        require(h["weight_version"] == max(0, h["step"] - 1)
                and math.isfinite(h["loss"])
                and math.isfinite(h["grad_norm"]), f"[20] step {h}")
    after = leaves_by_path(trn.get_model())
    still = [".".join(k) for k, t in before.items()
             if torch.equal(after[k], t)]
    require(not still, f"[20] (b) leaves that did not move: {still}")
    want = {"fused_sample": n_steps * XLSTM_TRAIN_NEW,
            "fused_logprob": 2 * n_steps, "fused_logprob_bwd": n_steps}
    require(launches == want, f"xlstm train launch counts {launches}, want "
            f"{want} (per step: the reference's and the trainer's log-probs "
            "and one backward)")
    log(f"  {n_steps} steps in {wall:.1f} s; moved: all {len(before)} "
        f"leaves but the norms (every cell's matrices, r_h included); "
        f"launches {launches}; peak memory allocated "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del ctl, gen, ref, rew, trn, after, before
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def xlstm_numerics(torch, dev):
    """[20] (c): the smoke config in fp32 on the card against the CPU port:
    logits; prefill + decode against the teacher-forced forward; one
    mLSTM layer's chunked form across two chunks against its stepwise
    decode; each within the reference's 1e-3; then a batch rollout whose
    mu is within 1e-3 of the reference's log-probs.  Returns the launch
    counts of the rollout."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.core.executor import GeneratorExecutor, \
        RefPolicyExecutor, RewardExecutor
    from repro_torch.kernels import build
    from repro_torch.models import decode_step, forward_train, \
        init_params, prefill, ssm
    from repro_torch.rl.data import ArithmeticTasks
    from repro_torch.train.optimizer import tree_map

    cfg = configs.get_smoke(XLSTM_ARCH)
    params = init_params(cfg, seed=5, dtype=torch.float32, device=dev)
    host = tree_map(lambda t: t.cpu(), params)
    S, n = XLSTM_SMOKE_PROMPT, XLSTM_SMOKE_NEW
    rng = np.random.default_rng(5)
    ids = torch.as_tensor(rng.integers(0, cfg.vocab, (2, S + n)),
                          dtype=torch.int32)
    toks = ids.to(dev)
    with torch.no_grad():
        full, _ = forward_train(params, cfg, {"tokens": toks})
        full_cpu, _ = forward_train(host, cfg, {"tokens": ids})
        fwd_err = max_err(full.cpu(), full_cpu)
        last, cache = prefill(params, cfg, {"tokens": toks[:, :S]},
                              cache_len=S + n, dtype=torch.float32)
        dec_err = max_err(last, full[:, S - 1])
        for i in range(n):
            lg, cache = decode_step(params, cfg, cache,
                                    toks[:, S + i:S + i + 1])
            dec_err = max(dec_err, max_err(lg, full[:, S + i]))
        p = params["xlstm_layers"][0]["cell"]
        x = torch.as_tensor(rng.standard_normal(
            (2, XLSTM_MLSTM_SEQ, cfg.d_model)) * 0.5, dtype=torch.float32,
            device=dev)
        y, _ = ssm.mlstm_forward(p, x, cfg)
        st = ssm.mlstm_init_state(cfg, 2, device=dev)
        steps = []
        for t in range(XLSTM_MLSTM_SEQ):
            yt, st = ssm.mlstm_decode(p, x[:, t:t + 1], st, cfg)
            steps.append(yt)
        mlstm_err = max_err(y, torch.cat(steps, dim=1))
    log(f"  (c) {cfg.name} smoke fp32 ({cfg.n_layers} blocks, sLSTM at "
        f"{list(cfg.xlstm.slstm_layers)}, d {cfg.d_model}): card against "
        f"CPU logits {fwd_err:.3e}; prefill of {S} + {n} decode steps "
        f"against the teacher-forced forward: max|dlogits| {dec_err:.3e}; "
        f"the chunked mLSTM against {XLSTM_MLSTM_SEQ} mlstm_decode steps "
        f"(two chunks of 64): max|dy| {mlstm_err:.3e} (tolerance 1e-3 each)")
    require(max(fwd_err, dec_err, mlstm_err) <= 1e-3, "[20] (c) numerics")
    del full, full_cpu, cache, host

    gen = GeneratorExecutor(cfg, ArithmeticTasks(seed=5), n_prompts=1,
                            n_per_prompt=N_PER, max_new=XLSTM_ROLL_NEW,
                            chunk=CHUNK, temperature=1.0, seed=5, device=dev)
    gen.set_weights(params, version=0)
    ref = RefPolicyExecutor(cfg)
    ref.set_weights(params)
    rew = RewardExecutor(n_per_prompt=N_PER, leave_one_out=True)
    build.reset_launches()          # the rollout's run starts here
    ref.put_input("completions", gen.step())
    ref.step()
    rew.put_input("completions_with_ref", ref.get_output("completions_with_ref"))
    out = rew.step()
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)  # ... and ends here
    want = {"fused_sample": XLSTM_ROLL_NEW, "fused_logprob": 1}
    require(launches == want, f"fp32 xlstm rollout launches {launches}, "
            f"want {want}")
    d = _check_outputs(torch, out, cfg.vocab)
    log(f"  fp32 batch rollout, {N_PER} samples of "
        f"{gen.tasks.prompt_len} + {XLSTM_ROLL_NEW} tokens: "
        f"|behavior_logp - ref_logp| at {d.numel()} actions (stepwise "
        f"decode against the chunked forward): max {d.max().item():.2e} "
        f"(tolerance 1e-3); launches {launches}")
    require(d.max().item() <= 1e-3, "fp32 xlstm rollout mu vs reference")
    del gen, ref, rew, params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def family_checks(label, launches, must, must_not):
    """The launch rules of a family's phase: every kernel of ``must``
    launched, none of ``must_not``."""
    for name in must:
        require(launches.get(name, 0) > 0, f"{name} never ran in [{label}]")
    for name in must_not:
        require(launches.get(name, 0) == 0, f"{name} ran in [{label}]")


def phase_xlstm(torch, dev):
    """[20]: the SSM family.  Returns the launch counts of its main-path
    runs."""
    log(f"[20] ssm: {XLSTM_ARCH} at full width and depth served and "
        f"trained, its smoke config in fp32; {nvidia_smi()}")
    from repro_torch import configs
    cfg = configs.get_config(XLSTM_ARCH)
    V, B = cfg.vocab, N_PROMPTS * N_PER
    t0 = time.perf_counter()
    launches = collections.Counter()
    dense = ("fused_sample_cuda", "fused_logprob_cuda")
    parts = [time.perf_counter()]
    with KernelCalls(torch, per_shape=1, names=KernelCalls.ENGINE) as calls:
        launches.update(xlstm_serve(torch, dev))
    for line in calls.replay("[20] (a)", expect=dense):
        log(line)
    got = {n: {tuple(args[0].shape) for args, _, _ in calls.calls[n]}
           for n in dense}
    want = {"fused_sample_cuda": {(B, V)},
            "fused_logprob_cuda": {(B, XLSTM_PROMPT + XLSTM_NEW - 1, V)}}
    require(got == want, f"[20] (a) shapes {got}, want {want}")
    del calls
    gc.collect()
    torch.cuda.empty_cache()
    parts.append(time.perf_counter())
    with KernelCalls(torch, host=True, names=KernelCalls.ENGINE) as calls:
        launches.update(xlstm_train(torch, dev))
    for line in calls.replay("[20] (b)", expect=dense + (
            "fused_logprob_bwd_cuda",)):
        log(line)
    del calls
    parts.append(time.perf_counter())
    with KernelCalls(torch, names=KernelCalls.ENGINE) as calls:
        launches.update(xlstm_numerics(torch, dev))
    for line in calls.replay("[20] (c)", expect=dense):
        log(line)
    del calls
    parts.append(time.perf_counter())
    launches = dict(launches)
    # no attention in the family; both packages' engines refuse it
    family_checks("20", launches, KERNELS[:3],
                  ("flash_attention", "paged_attention"))
    log(f"  [20] launches {launches}; {time.perf_counter() - t0:.1f} s "
        f"((a), (b), (c) with their replays: "
        + ", ".join(f"{b - a:.1f}" for a, b in zip(parts, parts[1:]))
        + " s)")
    return launches


AUDIO_ARCH = "seamless-m4t-medium"
# (a): full width and depth (978 M params, 1.96 GB in bf16): prompts of
# 64 ids behind 1024 frame embeddings a row, 64 new tokens, scored at
# [16, 128] with the frames
AUDIO_PROMPT, AUDIO_NEW = 64, 64
# (b): prompts of 64 ids and 32 new tokens, sequences of 96: each of
# (b)'s sampler calls is replayed through the plain version, about 0.16 s
# a call at V 256206
AUDIO_TRAIN_PROMPT, AUDIO_TRAIN_NEW = 64, 32
AUDIO_TRAIN_SEQ = AUDIO_TRAIN_PROMPT + AUDIO_TRAIN_NEW
# (c): the smoke config's prompt and decoded tokens
AUDIO_SMOKE_PROMPT, AUDIO_SMOKE_NEW = 24, 8


def audio_frames(torch, cfg, B, dev, seed):
    """Frame embeddings [B, F, D] at scale 0.02 from a seeded generator,
    as tests/test_arch_smoke.py draws them (the speech front end is a
    stub in both packages)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(B, cfg.frontend_tokens, cfg.d_model, generator=g,
                       device=dev) * 0.02


def audio_profile(torch, fn):
    """ranges_profile with the encoder (``backbone._encode``) in an
    ``encoder`` range and every cross attention (``gqa_cross_forward``:
    the query and output projections and the unmasked attention over the
    frames) in a ``cross`` range."""
    from repro_torch.models import attention, backbone
    return ranges_profile(torch, fn, {
        "encoder": [(backbone, "_encode")],
        "cross": [(attention, "gqa_cross_forward")]})


def audio_serve(torch, dev):
    """[21] (a): seamless-m4t-medium at full width and depth, bf16: a
    batch rollout through ``start_rollout(extra=)`` and ``rollout_chunk``
    (the executors carry no frame embeddings, in either package) scored by
    forward_train with the same frames; the encoder's share of the
    prefill, the cross attention's share of decode, the cross K/V
    cache's bytes.  Returns the launch counts."""
    from repro_torch import configs
    from repro_torch.kernels import build
    from repro_torch.models import init_params
    from repro_torch.rl import prng
    from repro_torch.rl.data import ArithmeticTasks
    from repro_torch.rl.rollout import action_mask, finalize_rollout, \
        rollout_chunk, start_rollout

    cfg = configs.get_config(AUDIO_ARCH)
    L, F, B = cfg.n_layers, cfg.frontend_tokens, N_PROMPTS * N_PER
    K, hd = cfg.n_kv_heads, cfg.hd
    log(f"  (a) serve {AUDIO_ARCH} at full width and depth "
        f"({cfg.n_enc_layers} encoder and {L} decoder layers, d "
        f"{cfg.d_model}, {cfg.n_heads}/{K} heads of {hd}, d_ff {cfg.d_ff} "
        f"SiLU-gated, V {cfg.vocab} untied); bf16; {N_PROMPTS} prompts x "
        f"{N_PER} samples of {AUDIO_PROMPT} ids behind {F} frame "
        f"embeddings a row, {AUDIO_NEW} new tokens in chunks of {CHUNK}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in leaves(params))
    log(f"  init: {n / 1e9:.3f} B params ({param_total(cfg) / 1e9:.3f} B by "
        f"param_count), {2 * n / 1e9:.2f} GB, "
        f"{time.perf_counter() - t0:.1f} s, peak memory allocated "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    prompts = torch.as_tensor(ArithmeticTasks(
        prompt_len=AUDIO_PROMPT, seed=0).sample(N_PROMPTS, N_PER).prompts,
        device=dev)
    extra = {"frame_embeds": audio_frames(torch, cfg, B, dev, seed=0)
             .to(torch.bfloat16)}
    total = AUDIO_PROMPT + AUDIO_NEW
    keys = prng.split(prng.PRNGKey(0), AUDIO_NEW // CHUNK)
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()          # the rollout's run starts here
    t0 = time.perf_counter()
    start_rollout(params, cfg, prompts, total, extra=extra)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    state = start_rollout(params, cfg, prompts, total, extra=extra)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    prefill_peak = torch.cuda.max_memory_allocated() / 1e9
    busy_p, ranged_p, _ = audio_profile(torch, lambda: start_rollout(
        params, cfg, prompts, total, extra=extra))
    cache = state.cache
    require(cache["pos"] == AUDIO_PROMPT
            and cache["self"]["k"].shape == (L, B, total, K, hd)
            and cache["cross_k"].shape == (L, B, F, K, hd)
            and cache["cross_k"].dtype == torch.bfloat16,
            f"audio cache pos {cache['pos']}, self "
            f"{tuple(cache['self']['k'].shape)}, cross "
            f"{tuple(cache['cross_k'].shape)} {cache['cross_k'].dtype}")
    cross_bytes = cache["cross_k"].nbytes + cache["cross_v"].nbytes
    ring_bytes = cache["self"]["k"].nbytes + cache["self"]["v"].nbytes
    busy, ranged, ops = profiled_decode(torch, audio_profile, params, cfg,
                                        cache, prompts[:, -1:])
    t0 = time.perf_counter()
    for k in keys:
        state = rollout_chunk(params, cfg, state, k, n_steps=CHUNK)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3 / AUDIO_NEW
    state = finalize_rollout(state, AUDIO_NEW)
    t0 = time.perf_counter()
    ref = vlm_score(torch, params, cfg, state.tokens, extra)
    torch.cuda.synchronize()
    t_ref = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)  # ... and ends here
    want = {"flash_attention": 4 * L, "fused_sample": AUDIO_NEW,
            "fused_logprob": 1}
    require(launches == want, f"audio rollout launch counts {launches}, "
            f"want {want} (three prefills and one scoring, the decoder's "
            f"causal self-attention through flash_attention at hd {hd} in "
            "each layer; the encoder's and the cross attention plain "
            "chunked_attention, as the reference routes them; fused_sample "
            "a decoded token)")
    d = _check_outputs(torch, {"tokens": state.tokens,
                               "mask": action_mask(state),
                               "behavior_logp": state.behavior_logp,
                               "ref_logp": ref}, cfg.vocab)
    log(f"  prefill [{B}, {F} frames + {AUDIO_PROMPT}]: {prefill_ms:.1f} ms "
        f"(the first {first_ms:.1f} ms); profiled: device busy "
        f"{busy_p:.1f} ms, {shares(busy_p, ranged_p)}; peak memory through "
        f"the prefills {prefill_peak:.2f} GB")
    log(f"  cache: the cross attention's K and V {cross_bytes / 1e6:.1f} MB "
        f"(bf16, {L} layers x {B} rows x {F} frames x {K} heads x {hd}, "
        f"written once by the prefill); the decoder's ring "
        f"{ring_bytes / 1e6:.1f} MB (fp32, {total} positions)")
    busy /= PROFILED_STEPS
    ranged = {k: v / PROFILED_STEPS for k, v in ranged.items()}
    log(f"  decode {decode_ms:.2f} ms per token (batch {B}, "
        f"{len(keys)} unprofiled chunks); {PROFILED_STEPS} profiled decode "
        f"steps: device busy {busy:.2f} ms per token = "
        f"{100 * busy / decode_ms:.1f}% of it; {shares(busy, ranged)} per "
        "token; top device operations (ms per token): "
        + ", ".join(f"{e.key[:48]} "
                    f"{e.self_device_time_total / 1e3 / PROFILED_STEPS:.3f}"
                    for e in ops[:6]))
    log(f"  reference {t_ref * 1e3:.1f} ms over [{B}, {total}] with the "
        f"frames; |behavior_logp - ref_logp| at {d.numel()} actions (bf16): "
        f"mean {d.mean().item():.4f}, max {d.max().item():.4f}; launches "
        f"{launches}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del state, cache, ref, params, extra
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def audio_train(torch, dev):
    """[21] (b): two ``make_train_step`` steps at full width and depth,
    ``frame_embeds`` in the batch: each step's batch is a rollout of the
    current params (prompts of 64 ids, 32 new tokens) scored by a frozen
    reference from another seed, KL 0.1.  Returns the launch counts."""
    from repro_torch import configs
    from repro_torch.kernels import build
    from repro_torch.models import init_params
    from repro_torch.rl import prng
    from repro_torch.rl.data import ArithmeticTasks
    from repro_torch.rl.rollout import action_mask, generate
    from repro_torch.train.optimizer import adam_init
    from repro_torch.train.trainstep import TrainState, make_train_step

    cfg = configs.get_config(AUDIO_ARCH)
    L, B, n_steps = cfg.n_layers, N_PROMPTS * N_PER, 2
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    ref_params = init_params(cfg, seed=1, dtype=torch.bfloat16, device=dev)
    state = TrainState(params, adam_init(params))
    step = make_train_step(cfg, lr=1e-3, kl_coef=KL_COEF)
    tasks = ArithmeticTasks(prompt_len=AUDIO_TRAIN_PROMPT, seed=0)
    extra = {"frame_embeds": audio_frames(torch, cfg, B, dev, seed=1)
             .to(torch.bfloat16)}
    n = sum(t.numel() for t in leaves(params))
    log(f"  (b) train {AUDIO_ARCH} at full width and depth: {n / 1e9:.3f} B "
        f"params, trainer state {12 * n / 1e9:.1f} GB; {n_steps} "
        f"make_train_step steps, KL {KL_COEF}, sequences of "
        f"{AUDIO_TRAIN_SEQ} "
        f"behind {cfg.frontend_tokens} frames")
    before = {k: t for k, t in leaves_by_path(params).items()
              if "norm" not in k[-1] and not k[-1].startswith("ln")}
    del params
    key = prng.PRNGKey(1)
    t0 = time.perf_counter()
    build.reset_launches()          # the train path's run starts here
    for i in range(n_steps):
        key, sub = prng.split(key)
        prompts = torch.as_tensor(tasks.sample(N_PROMPTS, N_PER).prompts,
                                  device=dev)
        roll = generate(state.params, cfg, prompts, max_new=AUDIO_TRAIN_NEW,
                        key=sub, chunk=CHUNK, extra=extra)
        mask = action_mask(roll)
        batch = {"tokens": roll.tokens, "behavior_logp": roll.behavior_logp,
                 "advantages": torch.zeros_like(mask), "mask": mask,
                 "ref_logp": vlm_score(torch, ref_params, cfg, roll.tokens,
                                       extra), **extra}
        del roll
        state, m = step(state, batch)
        log(f"  step {i}: loss {float(m['loss']):.5f}, grad_norm "
            f"{float(m['grad_norm']):.4f}")
        require(math.isfinite(float(m["loss"]))
                and math.isfinite(float(m["grad_norm"]))
                and float(m["grad_norm"]) > 0, f"step {i}: {m}")
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)  # ... and ends here
    wall = time.perf_counter() - t0
    after = leaves_by_path(state.params)
    still = [".".join(k) for k, t in before.items()
             if torch.equal(after[k], t)]
    require(not still, f"[21] (b) leaves that did not move: {still}")
    want = {"fused_sample": n_steps * AUDIO_TRAIN_NEW,
            "flash_attention": n_steps * 3 * L,
            "fused_logprob": 2 * n_steps, "fused_logprob_bwd": n_steps}
    require(launches == want, f"audio train launch counts {launches}, want "
            f"{want} (per step: the rollout's prefill, the reference's and "
            "the trainer's forward through flash_attention in each decoder "
            "layer; the reference's and the trainer's log-probs; one "
            "backward)")
    log(f"  {n_steps} steps in {wall:.1f} s (rollouts and scoring "
        f"included); moved: all {len(before)} leaves but the norms "
        f"(encoder, decoder, cross attention, untied head); launches "
        f"{launches}; peak memory allocated "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del state, ref_params, batch, after, before
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def audio_numerics(torch, dev):
    """[21] (c): the smoke config in fp32 on the card against the CPU
    port: logits with the frames, then prefill + decode against the
    teacher-forced forward (the reference's 1e-3), then a batch rollout
    with the frames whose mu is within 1e-3 of the reference's log-probs.
    Returns the launch counts of the rollout."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.kernels import build
    from repro_torch.models import decode_step, forward_train, \
        init_params, prefill
    from repro_torch.rl import prng
    from repro_torch.rl.data import ArithmeticTasks
    from repro_torch.rl.rollout import action_mask, generate
    from repro_torch.train.optimizer import tree_map

    cfg = configs.get_smoke(AUDIO_ARCH)
    params = init_params(cfg, seed=5, dtype=torch.float32, device=dev)
    host = tree_map(lambda t: t.cpu(), params)
    S, n, F = AUDIO_SMOKE_PROMPT, AUDIO_SMOKE_NEW, cfg.frontend_tokens
    rng = np.random.default_rng(5)
    ids = torch.as_tensor(rng.integers(0, cfg.vocab, (2, S + n)),
                          dtype=torch.int32)
    fr = torch.as_tensor(rng.standard_normal((2, F, cfg.d_model)) * 0.02,
                         dtype=torch.float32)
    toks, fr_dev = ids.to(dev), fr.to(dev)
    with torch.no_grad():
        full, _ = forward_train(params, cfg, {"tokens": toks,
                                              "frame_embeds": fr_dev})
        full_cpu, _ = forward_train(host, cfg, {"tokens": ids,
                                                "frame_embeds": fr})
        fwd_err = max_err(full.cpu(), full_cpu)
        last, cache = prefill(params, cfg, {"tokens": toks[:, :S],
                                            "frame_embeds": fr_dev},
                              cache_len=S + n, dtype=torch.float32)
        dec_err = max_err(last, full[:, S - 1])
        for i in range(n):
            lg, cache = decode_step(params, cfg, cache,
                                    toks[:, S + i:S + i + 1])
            dec_err = max(dec_err, max_err(lg, full[:, S + i]))
    log(f"  (c) {cfg.name} smoke fp32 ({cfg.n_enc_layers} + {cfg.n_layers} "
        f"layers, d {cfg.d_model}, {F} frames): card against CPU logits "
        f"{fwd_err:.3e}; prefill of {S} and {n} decode steps against the "
        f"teacher-forced forward: max|dlogits| {dec_err:.3e} (tolerance "
        "1e-3 each)")
    require(max(fwd_err, dec_err) <= 1e-3, "[21] (c) numerics")
    prompts = torch.as_tensor(ArithmeticTasks(seed=5).sample(1, N_PER)
                              .prompts, device=dev)
    extra = {"frame_embeds": audio_frames(torch, cfg, N_PER, dev, seed=5)}
    build.reset_launches()          # the rollout's run starts here
    roll = generate(params, cfg, prompts, max_new=MAX_NEW,
                    key=prng.PRNGKey(5), chunk=CHUNK, extra=extra)
    ref = vlm_score(torch, params, cfg, roll.tokens, extra)
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)  # ... and ends here
    L = cfg.n_layers
    want = {"flash_attention": 2 * L, "fused_sample": MAX_NEW,
            "fused_logprob": 1}
    require(launches == want, f"fp32 audio rollout launches {launches}, "
            f"want {want}")
    d = _check_outputs(torch, {"tokens": roll.tokens,
                               "mask": action_mask(roll),
                               "behavior_logp": roll.behavior_logp,
                               "ref_logp": ref}, cfg.vocab)
    log(f"  fp32 batch rollout with frames, {N_PER} samples of {MAX_NEW} "
        f"tokens: |behavior_logp - ref_logp| at {d.numel()} actions: max "
        f"{d.max().item():.2e} (tolerance 1e-3); launches {launches}")
    require(d.max().item() <= 1e-3, "fp32 audio rollout mu vs reference")
    del params, host, cache, roll
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_audio(torch, dev):
    """[21]: the audio encoder-decoder family.  Returns the launch counts
    of its main-path runs."""
    log(f"[21] audio: {AUDIO_ARCH} at full width and depth served and "
        f"trained, its smoke config in fp32; {nvidia_smi()}")
    from repro_torch import configs
    cfg = configs.get_config(AUDIO_ARCH)
    V, B = cfg.vocab, N_PROMPTS * N_PER
    t0 = time.perf_counter()
    launches = collections.Counter()
    dense = ("fused_sample_cuda", "fused_logprob_cuda",
             "flash_attention_cuda")
    parts = [time.perf_counter()]
    with KernelCalls(torch, per_shape=1, names=KernelCalls.ENGINE) as calls:
        launches.update(audio_serve(torch, dev))
    for line in calls.replay("[21] (a)", expect=dense):
        log(line)
    got = {n: {tuple(args[0].shape) for args, _, _ in calls.calls[n]}
           for n in dense}
    want = {"fused_sample_cuda": {(B, V)},
            "fused_logprob_cuda": {(B, AUDIO_PROMPT + AUDIO_NEW - 1, V)},
            "flash_attention_cuda": {
                (B, AUDIO_PROMPT, cfg.n_heads, cfg.hd),
                (B, AUDIO_PROMPT + AUDIO_NEW, cfg.n_heads, cfg.hd)}}
    require(got == want, f"[21] (a) shapes {got}, want {want}")
    del calls
    gc.collect()
    torch.cuda.empty_cache()
    parts.append(time.perf_counter())
    with KernelCalls(torch, host=True, names=KernelCalls.ENGINE) as calls:
        launches.update(audio_train(torch, dev))
    for line in calls.replay("[21] (b)", expect=dense + (
            "fused_logprob_bwd_cuda",)):
        log(line)
    del calls
    parts.append(time.perf_counter())
    with KernelCalls(torch, names=KernelCalls.ENGINE) as calls:
        launches.update(audio_numerics(torch, dev))
    for line in calls.replay("[21] (c)", expect=dense):
        log(line)
    del calls
    parts.append(time.perf_counter())
    launches = dict(launches)
    # both packages' engines refuse the audio family
    family_checks("21", launches, KERNELS[:4], ("paged_attention",))
    log(f"  [21] launches {launches}; {time.perf_counter() - t0:.1f} s "
        f"((a), (b), (c) with their replays: "
        + ", ".join(f"{b - a:.1f}" for a, b in zip(parts, parts[1:]))
        + " s)")
    return launches


# ------------------------------------------- [22] the sharded trainer --

SHARD_LAYERS = 2        # [22] (a): llama31-8b at full width, fp32, as [7]
SHARD_STEPS = 2
EP_TOKENS = (4, 256)    # [22] (b): rows x ids through forward_train


SHARD_PATHS = ("one card", "sharded", "sharded, remat_layers")


def sharded_step_check(torch, dev, mesh, batch):
    """[22] (a): llama31-8b at full width with SHARD_LAYERS layers in fp32
    from [7]'s seed, SHARD_STEPS steps on [7]'s batch at [7]'s settings
    (the paper's lr, KL 0.1): first the one-card ``make_train_step`` (its
    params, m and v kept on the card, where the comparisons read them),
    then
    ``make_sharded_train_step`` on the state ``shard_state`` placed on
    ``mesh``, once as it is and once with ``remat_layers`` (each layer
    under a checkpoint, its slice of each stacked leaf gathered again in
    the recompute).  Each sharded run's params and moments within [7]'s
    1e-4 of the one-card run's, each relative to its largest |value| (the
    moments hold the gradients); the largest difference against the
    steps' largest update is printed beside.  Each run's peak memory is
    printed twice: through the loss and backward (``value_and_grad``) and
    over the whole steps (Adam too).  Returns (the launches of the
    sharded runs, the last sharded state's params, per sharded run what
    [22] (d) holds the dry run to: the bytes allocated as the steps start
    and their peak, each less what the process held before the sharded
    state was built, and the FLOPs ``FlopCounterMode`` counted in one
    more sharded step)."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs.llama_paper import LLAMA31_8B
    from repro_torch.kernels import build
    from repro_torch.models import init_params
    from repro_torch.train import sharded, trainstep
    from repro_torch.train.optimizer import adam_init
    from repro_torch.train.sharded import make_sharded_train_step, \
        shard_state
    from repro_torch.train.trainstep import TrainState, make_train_step

    cfg = LLAMA31_8B.replace(name="llama31-8b-2l", n_layers=SHARD_LAYERS)
    batch = {k: v.to(dev) for k, v in batch.items()}
    kw = dict(kl_coef=KL_COEF)
    # the peak through each step's loss and backward, and the peak before
    # it, which the reset below would drop from the step's own
    held, bwd = [0], [0]
    real_vg = trainstep.value_and_grad

    def peaked_vg(*args):
        held[0] = max(held[0], torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()
        out = real_vg(*args)
        torch.cuda.synchronize()
        bwd[0] = max(bwd[0], torch.cuda.max_memory_allocated())
        return out

    runs, launches, measured = {}, collections.Counter(), {}
    trainstep.value_and_grad = sharded.value_and_grad = peaked_vg
    try:
        for path in SHARD_PATHS:
            remat = path.endswith("remat_layers")
            c = cfg.replace(remat_layers=remat)
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            # what earlier phases left allocated, outside (d)'s comparison
            base = torch.cuda.memory_allocated()
            params = init_params(c, seed=2, dtype=torch.float32, device=dev)
            n = sum(t.numel() for t in leaves(params))
            state = TrainState(params, adam_init(params))
            if path != "one card":
                state = shard_state(state, mesh)
                step = make_sharded_train_step(c, mesh, **kw)
            else:
                p0 = {k: t.clone() for k, t in
                      leaves_by_path(params).items()}
                step = make_train_step(c, **kw)
            del params
            ms = []
            gc.collect()
            torch.cuda.synchronize()
            init_peak = torch.cuda.max_memory_allocated()
            held[0] = bwd[0] = 0
            torch.cuda.reset_peak_memory_stats()
            got = {"argument_bytes": torch.cuda.memory_allocated() - base}
            build.reset_launches()      # this path's run starts here
            for _ in range(SHARD_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, m = step(state, batch)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            run_launches = dict(build.LAUNCHES)  # ... and ends here
            top = max(held[0], torch.cuda.max_memory_allocated())
            got["peak_bytes"] = top - base
            log(f"  (a) {path}: {n / 1e9:.3f} B params, {SHARD_STEPS} steps "
                "of " + ", ".join(f"{t:.1f}" for t in ms) + f" ms, loss "
                f"{float(m['loss']):.6f}, grad_norm "
                f"{float(m['grad_norm']):.6f}, peak memory allocated "
                f"{max(init_peak, top) / 1e9:.2f} GB; in the steps "
                f"{got['peak_bytes'] / 1e9:.3f} GB, through the loss and "
                f"backward {(bwd[0] - base) / 1e9:.3f} GB, each above the "
                f"{base / 1e9:.3f} GB held before")
            if path == "one card":
                big = max((t - p0[k]).abs().max().item()
                          for k, t in leaves_by_path(state.params).items())
                del p0
                runs[path] = {part: leaves_by_path(tree)
                              for part, tree in (("params", state.params),
                                                 ("m", state.opt.m),
                                                 ("v", state.opt.v))}
                del state
                continue
            require(state.opt.step == SHARD_STEPS,
                    f"Adam step {state.opt.step}")
            err, worst, equal = against_one_card(torch, state,
                                                 runs["one card"])
            log(f"  (a) {path} against one card: largest difference "
                + ", ".join(f"{k} {worst[k]:.3e} ({v:.2e} of the largest)"
                            for k, v in err.items())
                + f" (tolerance 1e-4); params {worst['params'] / big:.2e} of "
                f"the largest update {big:.3e}; bit-equal: {equal}; "
                f"launches {run_launches}")
            for k, v in err.items():
                require(v <= 1e-4, f"[22] (a) {path}: {k} {v:.3e} > 1e-4")
            # B4 once a layer in each forward and once more in each
            # layer's recompute under remat_layers
            want = {"fused_logprob": SHARD_STEPS,
                    "fused_logprob_bwd": SHARD_STEPS,
                    "flash_attention": SHARD_STEPS * c.n_layers
                    * (2 if remat else 1)}
            require(run_launches == want,
                    f"[22] (a) {path}: launches {run_launches}, want {want}")
            launches.update(run_launches)
            # one more sharded step, counted for (d): a dispatch mode
            # around a step changes its bits on the card (m moved by
            # 1.5e-6 of its largest), so the compared steps run without it
            with FlopCounterMode(display=False) as fc:
                state, _ = step(state, batch)
            got["card_flops"] = fc.get_total_flops()
            measured[path] = got
            # only the last run's params stay, for (c): what a run keeps
            # would count in the next one's bytes
            params = state.params if path == SHARD_PATHS[-1] else None
            del state
    finally:
        trainstep.value_and_grad = sharded.value_and_grad = real_vg
    del runs, batch
    return dict(launches), params, measured


def against_one_card(torch, state, one):
    """A sharded ``state``'s params, m and v against the one-card run's
    (``one``): per part (the largest difference relative to
    the part's largest |value|, the largest difference) and whether every
    leaf is bit-equal."""
    err, worst, equal = {}, {}, True
    for part, tree in (("params", state.params), ("m", state.opt.m),
                       ("v", state.opt.v)):
        worst[part] = 0.0
        for k, t in leaves_by_path(tree).items():
            got, want = t.to_local(), one[part][k]
            equal = equal and torch.equal(got, want)
            worst[part] = max(worst[part], (got - want).abs().max().item())
        err[part] = worst[part] / max(
            t.abs().max().item() for t in one[part].values())
    return err, worst, equal


DRYRUN_FLOP_TOL = 1e-3      # [22] (d): the card's count plus the kernels'
                            # own FLOPs against the meta count, relative
DRYRUN_BYTES_BAND = (0.9, 1.1)  # [22] (d): measured / predicted peak bytes


def dryrun_check(torch, mesh, batch, measured, remat: bool):
    """[22] (d): the dry run (``launch/dryrun.py``) predicts one of (a)'s
    sharded runs on ``mesh`` from the ``meta`` device -- llama31-8b at
    full width with SHARD_LAYERS layers, fp32, KL 0.1, on [7]'s batch
    shape, with ``remat`` (``remat_layers``) or without -- and the
    prediction is held to what (a) measured on the card: the bytes
    allocated as the steps start against ``argument_bytes``, the steps'
    peak against ``peak_bytes_per_device`` (within DRYRUN_BYTES_BAND),
    and FLOPs.  ``FlopCounterMode`` on the card cannot see B1, B2 and B4,
    ``ctypes`` launches; the meta run counts their plain versions (B1's
    and B2's count no product, the plain attention's forward is counted
    where the card runs B4, again in each recompute under ``remat``, and
    then recomputed in the backward).  So the card's count gains the
    kernels' own FLOPs, as ``bound`` reckons them, before it is held to
    the prediction within DRYRUN_FLOP_TOL.  Returns the phase's
    seconds."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.configs.llama_paper import LLAMA31_8B
    from repro_torch.launch import dryrun

    t0 = time.perf_counter()
    cfg = LLAMA31_8B.replace(name="llama31-8b-2l", n_layers=SHARD_LAYERS)
    B, T = batch["tokens"].shape
    amesh = dryrun.production_mesh(mesh_shape=tuple(mesh.shape))
    c, shape, lowered = dryrun.lower_combo(
        cfg, ShapeSpec("numerics", T, B, "train"), amesh,
        dtype=torch.float32, remat=remat, kl_coef=KL_COEF)
    rec = dryrun.analyse(c, shape, lowered, amesh)
    H, hd, V = cfg.n_heads, cfg.hd, cfg.vocab
    forwards = 2 if remat else 1        # B4 again in each recompute
    own = {"fused_logprob": B * (T - 1) * V * LOGPROB_OPS_PER_LOGIT,
           "fused_logprob_bwd": B * (T - 1) * V * LOGPROB_BWD_OPS_PER_LOGIT,
           "flash_attention": forwards * cfg.n_layers * 4 * B * H * hd * T
           * (T + 1) / 2}
    card = measured["card_flops"] + sum(own.values())
    pred = rec["flops_per_device"]
    flop_err = abs(card - pred) / pred
    # the plain attention's forwards, which the meta run counts and the
    # card runs as B4: every key of every query
    plain_fwd = forwards * cfg.n_layers * 4 * B * H * hd * T * T
    got_arg, got_peak = measured["argument_bytes"], measured["peak_bytes"]
    ratio = got_peak / rec["peak_bytes_per_device"]
    log(f"  (d) dry run of (a){' with remat_layers' if remat else ''} on a "
        f"{list(amesh.shape.values())} mesh "
        f"(meta, {rec['count_s']} s): predicted argument "
        f"{rec['argument_bytes'] / 1e9:.3f} GB, temp "
        f"{rec['temp_bytes'] / 1e9:.3f} GB (saved activations "
        f"{rec['saved_bytes'] / 1e9:.3f} GB), all-gather "
        f"{rec['collectives'].get('all-gather', 0) / 1e9:.3f} GB, peak "
        f"{rec['peak_bytes_per_device'] / 1e9:.3f} GB, "
        f"{pred / 1e12:.4f} TFLOP a step; roofline compute "
        f"{rec['roofline']['compute_s'] * 1e3:.2f} ms, memory "
        f"{rec['roofline']['memory_s'] * 1e3:.2f} ms; {nvidia_smi()}")
    log(f"  (d) measured in (a): {got_arg / 1e9:.3f} GB allocated as the "
        f"steps start, peak {got_peak / 1e9:.3f} GB ({ratio:.3f} of the "
        f"prediction, band {DRYRUN_BYTES_BAND}); FlopCounterMode "
        f"{measured['card_flops'] / 1e12:.4f} TFLOP + the kernels' own "
        + ", ".join(f"{k} {v / 1e9:.3f}" for k, v in own.items())
        + f" GFLOP = {card / 1e12:.4f} TFLOP against the predicted "
        f"{pred / 1e12:.4f} (relative {flop_err:.2e}, tolerance "
        f"{DRYRUN_FLOP_TOL:g}); the count plus the plain attention's "
        f"forward ({plain_fwd / 1e9:.3f} GFLOP) less the prediction: "
        f"{measured['card_flops'] + plain_fwd - pred:.0f} FLOP; "
        f"{time.perf_counter() - t0:.1f} s")
    require(flop_err <= DRYRUN_FLOP_TOL, f"(d) FLOPs off by {flop_err:.2e}")
    require(DRYRUN_BYTES_BAND[0] <= ratio <= DRYRUN_BYTES_BAND[1],
            f"(d) peak {got_peak / 1e9:.3f} GB against the predicted "
            f"{rec['peak_bytes_per_device'] / 1e9:.3f}")
    require(abs(got_arg - rec["argument_bytes"])
            <= 0.01 * rec["argument_bytes"],
            f"(d) argument bytes {got_arg} against {rec['argument_bytes']}")
    return time.perf_counter() - t0


def ep_check(torch, dev, mesh):
    """[22] (b): llama4-scout at full width with 1 layer, bf16:
    ``forward_train`` with moe_mode 'ep_shmap' on the installed mesh (its
    experts split over the model axis, the EP path counted) against the
    gathered mode.  Returns the launches of the EP forward."""
    from repro_torch import configs
    from repro_torch.kernels import build
    from repro_torch.models import ffn, forward_train, init_params
    from repro_torch.models.sharding import activation_sharding

    cfg = configs.get_config(MOE_ARCH).replace(n_layers=1)
    params = init_params(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    B, S = EP_TOKENS
    toks = torch.randint(0, cfg.vocab, (B, S), device=dev,
                         generator=torch.Generator(dev).manual_seed(0))
    calls = []
    real = ffn.moe_forward_shmap
    ffn.moe_forward_shmap = lambda *a: calls.append(1) or real(*a)
    try:
        with torch.no_grad():
            want, waux = forward_train(params, cfg, {"tokens": toks})
            build.reset_launches()      # the EP path's run starts here
            with activation_sharding(mesh):
                got, aux = forward_train(params,
                                         cfg.replace(moe_mode="ep_shmap"),
                                         {"tokens": toks})
            torch.cuda.synchronize()
            launches = dict(build.LAUNCHES)  # ... and ends here
    finally:
        ffn.moe_forward_shmap = real
    d = (got.float() - want.float()).abs().max().item()
    da = abs(float(aux["moe_aux"]) - float(waux["moe_aux"]))
    log(f"  (b) {MOE_ARCH} at full width, 1 layer, bf16, [{B}, {S}] ids: "
        f"ep_shmap against gathered: max|dlogits| {d:.3e} (of "
        f"{want.float().abs().max().item():.3e}), |dmoe_aux| {da:.3e}; EP "
        f"calls {len(calls)}; launches {launches}")
    require(calls == [1] and d <= 1e-4 * max(
        1.0, want.float().abs().max().item()) and da <= 1e-6,
        "[22] (b) ep_shmap against gathered")
    want = {"flash_attention": flash_layers(cfg, S)}
    require(launches == want, f"[22] (b) launches {launches}, want {want}")
    del params, got, want
    return launches


def checkpoint_check(torch, mesh, params):
    """[22] (c): (a)'s sharded params, gathered and saved, restored onto
    the mesh with ``restore_checkpoint(shardings=)``, bit for bit."""
    from repro_torch.models.sharding import params_shardings
    from repro_torch.train.checkpoint import restore_checkpoint, \
        save_checkpoint
    from repro_torch.train.optimizer import tree_map

    path = str(ROOT / "build" / "sharded_ckpt")
    host = tree_map(lambda t: t.full_tensor().cpu(), params)
    t0 = time.perf_counter()
    save_checkpoint(path, host)
    t1 = time.perf_counter()
    got = restore_checkpoint(path, host, params_shardings(host, mesh),
                             mesh=mesh)
    t2 = time.perf_counter()
    bad = [k for k, t in leaves_by_path(got).items()
           if not torch.equal(t.to_local(),
                              leaves_by_path(params)[k].to_local())]
    n = os.path.getsize(path + ".npz")
    os.remove(path + ".npz")
    os.remove(path + ".json")
    log(f"  (c) checkpoint of (a)'s params: {n / 1e9:.2f} GB saved in "
        f"{t1 - t0:.1f} s, restored onto the mesh in {t2 - t1:.1f} s; leaves "
        f"not bit-equal: {bad}")
    require(not bad, f"[22] (c) restored leaves differ: {bad}")


def phase_sharded(torch, dev, batch):
    """[22]: the sharded trainer, expert parallelism and sharded
    checkpoints on a (data 1, model 1) mesh of an NCCL group of one rank.
    Returns the launch counts of its sharded runs."""
    import torch.distributed as dist

    from repro_torch.launch import mesh as meshmod
    log(f"[22] sharded: a process group of 1, a (1, 1) {dev.type} mesh; "
        f"{nvidia_smi()}")
    t0 = time.perf_counter()
    rdv = ROOT / "build" / f"rendezvous_{os.getpid()}"
    rdv.parent.mkdir(exist_ok=True)
    if rdv.exists():
        rdv.unlink()
    meshmod.join("file://" + str(rdv), 0, 1, device_type=dev.type)
    try:
        mesh = meshmod.make_dev_mesh(device_type=dev.type)
        require(tuple(mesh.shape) == (1, 1)
                and mesh.device_type == dev.type, f"mesh {mesh}")
        parts = [time.perf_counter()]
        launches = collections.Counter()
        with KernelCalls(torch, per_shape=1, host=True) as calls:
            a, params, measured = sharded_step_check(torch, dev, mesh, batch)
        launches.update(a)
        for line in calls.replay("[22] (a)", expect=(
                "fused_logprob_cuda", "fused_logprob_bwd_cuda",
                "flash_attention_cuda")):
            log(line)
        del calls
        parts.append(time.perf_counter())
        checkpoint_check(torch, mesh, params)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        parts.append(time.perf_counter())
        launches.update(ep_check(torch, dev, mesh))
        parts.append(time.perf_counter())
        for path, got in measured.items():
            dryrun_check(torch, mesh, batch, got,
                         remat=path.endswith("remat_layers"))
        parts.append(time.perf_counter())
    finally:
        dist.destroy_process_group()
        if rdv.exists():
            rdv.unlink()
    gc.collect()
    torch.cuda.empty_cache()
    launches = dict(launches)
    family_checks("22", launches, ("fused_logprob", "fused_logprob_bwd",
                                   "flash_attention"), ())
    log(f"  [22] launches {launches}; {time.perf_counter() - t0:.1f} s "
        "((a), (c), (b), (d): "
        + ", ".join(f"{b - a:.1f}" for a, b in zip(parts, parts[1:]))
        + " s)")
    return launches


# --------------------------------- [23] tensor-parallel serving (TP) ---

TP_RANKS = 2                # a (data 1, model 2) mesh on the one card
TP_ROWS, TP_PROMPT, TP_NEW = 16, 16, 32
# (a)-(b): llama31-8b's rollout and its teacher-forced replay: at 32
# layers each token is 66 gloo collectives through the host
TP_LLAMA_NEW = 16
TP_FP32_LAYERS = 2          # (d) and (e): [7]'s depth and dtype
TP_FP32_NEW = 16
TP_LP_MEAN = 0.05           # (b): mean |dlogp| of the teacher-forced TP
TP_FP32_TOL = 1e-4          # (d): [7]'s bound, relative to max(1, |logit|)
TP_SAMPLE_REL = 1e-5        # (c): merged log-prob against the whole row's
TP_B4 = (4, 2048, 16, 4, 128)   # B4 on a rank's heads (llama31-8b, TP 2)
TP_SEED, TP_KEY = 3, 23
TP_TIMEOUT_S = 600
# (f)-(i): the TP train step and reference scoring at (d)'s config, on a
# [16, 80] batch as [7]'s, at tests/_sharded_ranks.py's lr.  Its bounds
# are the sharded tests' (metrics 1e-5, m 1e-5 of a leaf's largest)
# where the card holds them.  The first step starts from zero moments,
# so its m is a tenth of the clipped gradient: m's bound holds the
# gradient itself, before Adam, to the tests' 1e-5.  At full width fp32
# sums over 1264 to 14336 terms in another order (partial products
# all-reduced, the merged vocabulary stats, cuBLAS's kernels for other
# shapes) move a gradient element by up to about 1e-5 of its leaf's
# largest, and Adam's step divides each element by its own size: an
# element far below its leaf's rms gradient carries its rounding into
# its update.  So v (the gradient squared) holds to twice m's bound, 99%
# of an update to 1e-4 of the leaf's largest (2% of a leaf's elements
# lay past 1e-5 on the card, 0.55% past 1e-4), and the worst element to
# 0.5 of it (0.270 on the card).  The log gives, of the elements past
# 1e-4, their one-card |m| over their leaf's rms |m|, the size that
# decides how far Adam lifts their rounding
TP_TRAIN_ROWS, TP_TRAIN_T, TP_TRAIN_PROMPT = 16, 80, 16
TP_TRAIN_LR = 1e-3
TP_TRAIN_STEPS = 2
TP_METRIC_TOL = 1e-5        # metrics, relative to max(1, |value|)
TP_MOMENT_TOL = {"m": 1e-5, "v": 2e-5}  # of each leaf's largest
TP_UPDATE_TOL = 1e-4        # 99% of an update within it of the largest
TP_UPDATE_WORST = 0.5       # and all within this share of it
TP_REF_TOL = 1e-5           # (h): ref_logp, relative to max(1, |logp|)
TP_LOGPROB_REL = 1e-6       # (g): merged B1 against the whole row's
# the one-card gradient below which an element's update is held to
# TP_UPDATE_WORST alone, as tests/test_torch_sharded.py's G_SIGN: Adam's
# first step moves an element by lr g / (|g| + 1e-8), which turns on the
# gradient's last bits where g is rounding noise.  A key bias
# (starcoder2's, (n)) reaches the scores through RoPE: on a pair that
# turns little over the window it shifts every score of a query by
# nearly the same q . b_k, which softmax ignores, so its gradient falls
# with the pair's frequency and the lowest pairs' is mostly rounding.
# m and v are held as every leaf's
TP_G_SIGN = 1e-6
# (j)-(m): the MoE family on the same two ranks.  (j) llama4-scout and
# (k) deepseek-v3 at their published widths in bf16, [16]'s and [17]'s
# depths (10.9 B and 15.8 B params, 21.7 and 31.6 GB whole, half of it a
# rank), served (j, k), scored and trained in fp32 at one layer (l), the
# dry run held to (k)'s decode and (l)'s steps (m)
TP_MOE_ARCHS = (MOE_ARCH, MLA_ARCH)
TP_MOE_LAYERS = {MOE_ARCH: MOE_LAYERS, MLA_ARCH: MLA_LAYERS}
# (l): (experts, vocabulary) each keeps (``tp_moe_train_cfg``): 1.28 B
# and 1.74 B params
TP_MOE_TRAIN = {MOE_ARCH: (8, 8192), MLA_ARCH: (16, 8192)}
# B4 on a rank's heads of llama4-scout (40 query and 8 KV heads, TP 2)
TP_B4_MOE = (4, 2048, 20, 4, 128)
# One card's own spread (``_ulp_moved``): the same one-card checks with
# the embedding moved by an ulp of its dtype, so that every activation of
# the forward differs in its last bits, as the TP forward's partial sums
# make it differ.  (j)-(k), bf16: the mean |dlogp| of the TP step's
# teacher-forced log-probs and of the TP reference's against one card's
# are held to (b)'s bound or to the witness's own, the larger: each of
# the TP forward's all-reduces rounds its sum to bf16 once, as one
# card's product does, while the witness moves every input element by a
# whole bf16 ulp (at the published capacity factor a route that rounding
# flips moves which choices the capacity drops).  (l) and (n), fp32: m
# and v are held to (f)'s bounds or TP_WITNESS times the larger of the
# witness's steps (``_ulp_witness``): the witness moves the input by one fp32
# ulp, a TP step reorders sums of thousands of terms at about ten points
# (each layer's two all-reduces, the embedding's, the vocabulary merge,
# and as many in the backward), and independent differences of one size
# add as the square root of their count
TP_WITNESS = 3.0
# (n): starcoder2-3b at its published widths on a (data 1, model 4) mesh
# of four ranks on the one card.  Its 2 KV heads do not divide 4, so a
# rank computes its quarter of wq wk wv by columns and of wo by rows
# around a whole attention core ([23]'s (1, 2) meshes split every
# model's heads).  Served in bf16 at TP4_LAYERS of its 30 layers (a
# [4, 64] prefill, 8 new tokens), trained in fp32 at one layer, one step.
# Its m and v are held as (l)'s, with a second witness: the vocabulary
# split four ways moves final_norm's m by 1.25e-05 and v by 2.49e-05 of
# their largest, past (f)'s 1e-5 and 2e-5, while with the vocabulary
# whole (``--tp4-vocab``: 49154) the TP step holds (f)'s bounds; the ulp
# witness (3.63e-06) does not reach that arithmetic, so rank 0 also steps
# one card with its head and log-probs cut into the ranks' four slices
# (``_split_witness``, 2.53e-06 on final_norm), and the bound is
# TP_WITNESS times the two witnesses' moves summed: the TP step makes
# the activations' partial sums and the split's arithmetic at once
TP4_RANKS = 4
TP4_ARCH = "starcoder2-3b"
TP4_LAYERS = 4
TP4_ROWS, TP4_PROMPT, TP4_NEW = 4, 64, 8
# ``--tp4-vocab``: a vocabulary 4 does not divide (starcoder2-3b's + 2)
TP4_VOCAB_WHOLE = 49154


def _tp_whole(torch, x, tp):
    """A rank's [rows, V/m] logits gathered whole (the checks only; the
    sampling path never gathers them)."""
    import torch.distributed as dist
    parts = [torch.empty_like(x) for _ in range(tp.size)]
    dist.all_gather(parts, x.contiguous(), group=tp.group)
    return torch.cat(parts, dim=-1)


class _Drops:
    """While entered, counts the (token, choice) pairs this process's MoE
    dispatches (``ffn._dispatch_group_local``) route to its own experts
    (``routed``; every expert on one card, a rank's E/m on the mesh) and
    those of them the capacity drops (``dropped``)."""

    def __enter__(self):
        from repro_torch.models import ffn
        self.routed = self.dropped = 0
        self._inner = inner = ffn._dispatch_group_local

        def counted(x, idx, n_local, capacity):
            buf, dest, valid, order = inner(x, idx, n_local, capacity)
            own = int(((idx >= 0) & (idx < n_local)).sum())
            self.routed += own
            self.dropped += own - int(valid.sum())
            return buf, dest, valid, order
        ffn._dispatch_group_local = counted
        return self

    def __exit__(self, *exc):
        from repro_torch.models import ffn
        ffn._dispatch_group_local = self._inner

    def summed(self, torch, group):
        """[routed, dropped] summed over ``group``'s ranks."""
        import torch.distributed as dist
        t = torch.tensor([self.routed, self.dropped], dtype=torch.int64)
        dist.all_reduce(t, group=group)
        return t.tolist()


def _model_block(t, spec, r: int, m: int):
    """Rank ``r``'s block of the leaf ``t`` under ``spec`` on a (1, m)
    mesh (a view): its 1/m slice of each dim ``spec`` puts on
    ``model``."""
    idx = []
    for d, ax in enumerate(spec):
        if ax == "model":
            w = t.shape[d] // m
            idx.append(slice(r * w, (r + 1) * w))
        else:
            idx.append(slice(None))
    return t[tuple(idx)]


def _hand_over(torch, queues, rank, group, blocks):
    """One tensor from rank 0 to each other rank of a [23] mesh over
    ``queues``, one spawn-context queue a receiving rank (CUDA IPC for a
    tensor on the card): rank 0 puts ``blocks[r - 1]`` on
    ``queues[r - 1]``, rank r copies the shared tensor, and all pass a
    barrier, after which rank 0 may free them.  Returns rank r's copy
    (None on rank 0)."""
    import torch.distributed as dist
    out = None
    if rank == 0:
        for q, block in zip(queues, blocks):
            q.put(block)
    else:
        shared = queues[rank - 1].get()
        out = shared.clone()
        del shared
        if out.is_cuda:
            torch.cuda.synchronize()
    dist.barrier(group=group)
    return out


def _cut_and_hand(torch, queues, rank, group, t, spec, keep):
    """This rank's block of the leaf ``t`` (whole on rank 0, None on the
    others) under ``spec`` on a (1, m) mesh of m = len(queues) + 1
    ranks, on ``keep``: rank 0 cuts every rank's block and hands the
    others theirs (``_hand_over``)."""
    m = len(queues) + 1
    if rank != 0:
        return _hand_over(torch, queues, rank, group, None).to(keep)
    _hand_over(torch, queues, rank, group,
               [_model_block(t, spec, r, m).contiguous()
                for r in range(1, m)])
    return _model_block(t, spec, 0, m).to(keep, copy=True)


def _tp_build(torch, cfg, dtype, rank, mesh, dev, yardstick, queues):
    """Rank 0 builds ``cfg`` whole on the card from TP_SEED, runs
    ``yardstick(params)`` on it, keeps its TP shard (``tp_plan``) and
    hands each other rank its shard leaf by leaf (``_cut_and_hand``),
    freeing each whole leaf once it is cut; the others keep what they
    get.  Only one whole tree is ever on the card, and it is alone there
    while it is drawn (a deepseek-v3 init draws expert leaves in fp32).
    Returns
    (shard, TPRank, what the yardstick returned on rank 0)."""
    import torch.distributed as dist

    from repro_torch.models import init_params
    from repro_torch.models.sharding import tp_plan
    from repro_torch.models.tp import tp_rank
    from repro_torch.train.optimizer import tree_leaves, tree_unflatten
    tp = tp_rank(cfg, mesh)
    meta = init_params(cfg, 0, dtype, device="meta")
    specs = tree_leaves(tp_plan(cfg, mesh, meta))
    got = None
    if rank == 0:
        params = init_params(cfg, seed=TP_SEED, dtype=dtype, device=dev)
        torch.cuda.empty_cache()        # the init's fp32 draws
        got = yardstick(params)
        whole = tree_leaves(params)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        local = []
        for i, sp in enumerate(specs):
            local.append(_cut_and_hand(torch, queues, rank, tp.group,
                                       whole[i], sp, dev))
            whole[i] = None             # each whole leaf freed once cut
    else:
        local = [_cut_and_hand(torch, queues, rank, tp.group, None, sp, dev)
                 for sp in specs]
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    return tree_unflatten(meta, local), tp, got


def _tp_prompts(torch, cfg, rows, dev, prompt=TP_PROMPT):
    g = torch.Generator().manual_seed(TP_KEY)
    return torch.randint(3, cfg.vocab, (rows, prompt), generator=g,
                         dtype=torch.int32).to(dev)


def tp_rank_main(rank, rdv, out_path, queues, dev_type="cuda"):
    """One rank of [23]'s (1, 2) mesh on the one card: a gloo group over
    CUDA tensors (NCCL refuses two ranks on one device), and ``queues``
    (one), over which rank 0 hands rank 1 its blocks (``_hand_over``).
    Writes
    its results to ``out_path``_<rank>.json.  (``dev_type`` "cpu" runs the
    same on the CPU, for a rehearsal with the kernels faked.)"""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.configs.llama_paper import LLAMA31_8B
    from repro_torch.kernels import build, dispatch
    from repro_torch.kernels.flash_attention import chunked_attention
    from repro_torch.kernels.fused_sample import fused_sample_cuda, \
        fused_sample_partial_cuda, fused_sample_split_plain, \
        merge_partials, split_plan
    from repro_torch.launch import dryrun
    from repro_torch.models import decode_step, prefill
    from repro_torch.models.tp import TPRank
    from repro_torch.rl import prng
    from repro_torch.rl.rollout import action_mask, generate

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if dev_type == "cuda":
        torch.cuda.set_device(0)
    dev = torch.device(dev_type, 0) if dev_type == "cuda" \
        else torch.device(dev_type)
    dist.init_process_group("gloo", init_method=rdv, rank=rank,
                            world_size=TP_RANKS,
                            timeout=datetime.timedelta(seconds=TP_TIMEOUT_S))
    res = {"backend": dist.get_backend()}
    times = [("", time.perf_counter())]

    def mark(label: str):
        times.append((label, time.perf_counter()))

    try:
        mesh = DeviceMesh(dev_type,
                          torch.arange(TP_RANKS).reshape(1, TP_RANKS),
                          mesh_dim_names=("data", "model"))
        cfg = LLAMA31_8B
        key = prng.PRNGKey(TP_KEY)
        prompts = _tp_prompts(torch, cfg, TP_ROWS, dev)
        cache_len = TP_PROMPT + TP_LLAMA_NEW

        def one_card(params):
            with torch.no_grad():
                logits, _ = prefill(params, cfg, {"tokens": prompts},
                                    cache_len, torch.float32)
                st = generate(params, cfg, prompts, max_new=TP_LLAMA_NEW,
                              key=key, temperature=1.0)
            torch.cuda.synchronize()
            return logits, st

        shard, tp, yard = _tp_build(torch, cfg, torch.bfloat16, rank, mesh,
                                    dev, one_card, queues)
        res["held_gb"] = sum(t.numel() * t.element_size()
                             for t in leaves(shard)) / 1e9
        res["wq"] = list(shard["layers"]["attn"]["wq"].shape)
        res["splits"] = [tp.heads, tp.ffn, tp.vocab]
        mark("build")

        # B4's calls on this rank's heads, the first of each shape kept
        flash_calls = {}
        real_flash = dispatch.flash_attention_cuda

        def recorded(q, k, v):
            out = real_flash(q, k, v)
            if tuple(q.shape) not in flash_calls:
                flash_calls[tuple(q.shape)] = (q.clone(), k.clone(),
                                               v.clone(), out.clone())
            return out
        dispatch.flash_attention_cuda = recorded
        # (a) + (b): the main path, this phase's launches counted
        torch.cuda.synchronize()
        build.reset_launches()
        t0 = time.perf_counter()
        with torch.no_grad():
            local, _ = prefill(shard, cfg, {"tokens": prompts}, cache_len,
                               torch.float32, tp=tp)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            st = generate(shard, cfg, prompts, max_new=TP_LLAMA_NEW,
                          key=key, temperature=1.0, tp=tp)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        res["launches"] = dict(build.LAUNCHES)
        dispatch.flash_attention_cuda = real_flash
        res["prefill_ms"] = (t1 - t0) * 1e3
        res["decode_ms"] = (t2 - t1) * 1e3 / TP_LLAMA_NEW
        res["b4"] = {}
        for s, (q, k, v, o) in flash_calls.items():
            o_p = chunked_attention(q, k, v).float()
            res["b4"][str(list(s))] = ((o.float() - o_p).abs()
                                       / o_p.abs().clamp(min=1.0)).max() \
                .item()
        del flash_calls
        whole = _tp_whole(torch, local, tp)
        if rank == 0:
            want, one = yard
            d = (whole.float() - want.float()).abs()
            res["a"] = {"max": d.max().item(), "mean": d.mean().item(),
                        "finite": bool(torch.isfinite(whole).all()),
                        "scale": want.float().abs().max().item()}
            res["b_equal"] = (st.tokens == one.tokens)[:, TP_PROMPT:] \
                .float().mean().item()
        # (b) teacher-forced: the TP step's log-prob of the one-card tokens
        toks = torch.empty((TP_ROWS, TP_PROMPT + TP_LLAMA_NEW),
                           dtype=torch.int32, device=dev)
        if rank == 0:
            toks.copy_(yard[1].tokens)
        dist.broadcast(toks, src=0, group=tp.group)
        lps = []
        with torch.no_grad():
            logits, cache = prefill(shard, cfg, {"tokens": prompts},
                                    cache_len, torch.float32, tp=tp)
            for j in range(TP_LLAMA_NEW):
                full = _tp_whole(torch, logits, tp).float()
                t = toks[:, TP_PROMPT + j].long()
                lps.append(torch.log_softmax(full, dim=-1)
                           .gather(1, t[:, None])[:, 0])
                logits, cache = decode_step(shard, cfg, cache,
                                            toks[:, TP_PROMPT + j:
                                                 TP_PROMPT + j + 1], tp=tp)
        if rank == 0:
            one = yard[1]
            mask = action_mask(one)[:, TP_PROMPT:].bool()
            d = (torch.stack(lps, 1) - one.behavior_logp[:, TP_PROMPT:]).abs()
            res["b"] = {"mean": d[mask].mean().item(),
                        "max": d[mask].max().item(), "n": int(mask.sum())}
        del cache, logits, lps, st
        mark("(a)-(b)")

        # (c) B3 on each shard with col0, merged, against the whole row
        V = local.shape[1]
        col0 = tp.rank * V
        span, _ = split_plan(TP_ROWS, V, build.sm_count(dev))
        c = {"shape": list(local.shape), "col0": col0}
        for T in (0.0, 0.7, 1.0):
            part = fused_sample_partial_cuda(local, key, T, col0=col0)
            plain = fused_sample_split_plain(local, key, T, span, col0=col0,
                                             partial=True)
            c[f"T{T}"] = {
                "col": bool(torch.equal(part[:, 3], plain[:, 3])),
                "mx": bool(torch.equal(part[:, [0, 4]], plain[:, [0, 4]])),
                "z": max_err(part[:, 2], plain[:, 2]),
                "s": ((part[:, 1] - plain[:, 1]).abs()
                      / plain[:, 1].abs()).max().item()}
            parts = [torch.empty_like(part) for _ in range(tp.size)]
            dist.all_gather(parts, part, group=tp.group)
            tok, lp = merge_partials(torch.stack(parts))
            if rank == 0:
                tok_w, lp_w = fused_sample_cuda(whole, key, T)
                c[f"T{T}"].update(
                    tokens=bool(torch.equal(tok, tok_w)),
                    lp=((lp - lp_w).abs() / lp_w.abs().clamp(min=1e-30))
                    .max().item())
        res["c"] = c
        del local, whole, shard
        gc.collect()
        torch.cuda.empty_cache()
        mark("(c)")

        # (d) 2 layers in fp32 at full width: TP against one card
        cfg2 = cfg.replace(name="llama31-8b-2l", n_layers=TP_FP32_LAYERS)

        def one_card2(params):
            with torch.no_grad():
                logits, _ = prefill(params, cfg2, {"tokens": prompts},
                                    TP_PROMPT, torch.float32)
                st = generate(params, cfg2, prompts, max_new=TP_FP32_NEW,
                              key=key, temperature=1.0)
            return logits, st.tokens

        shard, tp, yard = _tp_build(torch, cfg2, torch.float32, rank, mesh,
                                    dev, one_card2, queues)
        with torch.no_grad():
            local, _ = prefill(shard, cfg2, {"tokens": prompts}, TP_PROMPT,
                               torch.float32, tp=tp)
            st = generate(shard, cfg2, prompts, max_new=TP_FP32_NEW, key=key,
                          temperature=1.0, tp=tp)
        whole = _tp_whole(torch, local, tp)
        if rank == 0:
            want, tokens = yard
            res["d"] = {"max": (whole - want).abs().max().item(),
                        "scale": want.abs().max().item(),
                        "tokens": bool(torch.equal(st.tokens, tokens))}
        del local, whole, st, yard
        gc.collect()
        torch.cuda.empty_cache()
        mark("(d)")

        # (e) the dry run's meta prediction of this rank's TP prefill at
        # (d)'s config, held to the card: bytes, FLOPs and all-reduces
        shape = ShapeSpec("tp", TP_PROMPT, TP_ROWS, "prefill")
        amesh = dryrun.production_mesh(mesh_shape=(1, TP_RANKS))
        c2, sh, lowered = dryrun.lower_combo(cfg2, shape, amesh,
                                             dtype=torch.float32)
        rec = dryrun.analyse(c2, sh, lowered, amesh)
        counted = {"all-reduce": 0}

        class Counted(TPRank):
            def reduce(self, x):
                counted["all-reduce"] += x.numel() * x.element_size()
                return super().reduce(x)
        ctp = Counted(**{f.name: getattr(tp, f.name)
                         for f in dataclasses.fields(TPRank)})
        held = sum(t.numel() * t.element_size() for t in leaves(shard)) \
            + prompts.numel() * prompts.element_size()
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            out = prefill(shard, cfg2, {"tokens": prompts}, TP_PROMPT,
                          torch.float32, tp=ctp)
        torch.cuda.synchronize()
        temp = torch.cuda.max_memory_allocated() - base
        del out
        with torch.no_grad(), FlopCounterMode(display=False) as fc:
            prefill(shard, cfg2, {"tokens": prompts}, TP_PROMPT,
                    torch.float32, tp=tp)
        H, hd, S, L = cfg2.n_heads // tp.size, cfg2.hd, TP_PROMPT, \
            cfg2.n_layers
        own = L * 4 * TP_ROWS * H * hd * S * (S + 1) / 2     # B4, causal
        plain_fwd = L * 4 * TP_ROWS * H * hd * S * S
        res["e"] = {"pred": {k: rec[k] for k in (
                        "argument_bytes", "held_bytes", "temp_bytes",
                        "peak_bytes_per_device", "flops_per_device",
                        "collectives", "count_s")},
                    "held": held, "temp": temp, "card_flops":
                    fc.get_total_flops(), "own": own, "plain_fwd": plain_fwd,
                    "all_reduce": counted["all-reduce"]}
        del shard
        gc.collect()
        torch.cuda.empty_cache()
        mark("(e)")

        # (f)-(i): the TP train step and reference scoring at (d)'s config
        res["train"] = tp_train_rank(torch, rank, mesh, cfg2, dev, mark,
                                     queues)
        # (g): the vocabulary-parallel B1 and B2 against the whole row's
        res["g"] = tp_logprob_merge(torch, tp, dev)
        mark("(i)-(g)")
        # (j), (k) and (m): the MoE family served at full width
        res["moe"] = {arch: tp_moe_serve(torch, rank, mesh, dev, arch, mark,
                                         queues)
                      for arch in TP_MOE_ARCHS}
        # (l) and (m): scored and trained in fp32 at one layer
        res["moe_train"] = {}
        for arch in TP_MOE_ARCHS:
            cfg_l = tp_moe_train_cfg(torch, arch)
            pub = dataclasses.replace(cfg_l.moe, capacity_factor=configs_full(
                arch).moe.capacity_factor)
            res["moe_train"][arch] = tp_train_rank(
                torch, rank, mesh, cfg_l, dev, mark, queues,
                first_on_card=False, pub=cfg_l.replace(moe=pub),
                witness=True)
            mark("(i)")
        res["seconds"] = [(b[0], b[1] - a[1])
                          for a, b in zip(times, times[1:])]
    finally:
        with open(f"{out_path}_{rank}.json", "w") as f:
            json.dump(res, f)
        dist.destroy_process_group()


def _tp_train_batch(torch, cfg, dev):
    """A [TP_TRAIN_ROWS, TP_TRAIN_T] training batch from TP_KEY, the same
    on every rank: random tokens, a prompt of TP_TRAIN_PROMPT, behaviour
    and reference log-probs and advantages on the actions."""
    g = torch.Generator().manual_seed(TP_KEY)
    B, T = TP_TRAIN_ROWS, TP_TRAIN_T
    mask = torch.zeros(B, T)
    mask[:, TP_TRAIN_PROMPT:] = (torch.rand(B, T - TP_TRAIN_PROMPT,
                                            generator=g) > 0.1).float()
    batch = {"tokens": torch.randint(3, cfg.vocab, (B, T), generator=g,
                                     dtype=torch.int32),
             "behavior_logp": -8 + 4 * torch.rand(B, T, generator=g),
             "advantages": torch.randn(B, 1, generator=g).expand(B, T),
             "ref_logp": -8 + 4 * torch.rand(B, T, generator=g),
             "mask": mask}
    for k in ("behavior_logp", "advantages", "ref_logp"):
        batch[k] = batch[k] * mask
    return {k: v.to(dev) for k, v in batch.items()}


def _tp_slices(torch, tree, specs, mesh, dev):
    """This rank's blocks of the whole ``tree`` under ``specs`` (a tree
    of ``Spec``), copied to ``dev``."""
    from repro_torch.models.sharding import shard_of
    from repro_torch.train.optimizer import tree_map
    return tree_map(lambda t, sp: shard_of(t, sp, mesh).to(dev, copy=True),
                    tree, specs)


def _tp_state(torch, mesh, specs, params, m, v, step):
    """A sharded ``TrainState`` of this rank's blocks (DTensors placed by
    ``specs``, a ``state_shardings`` tree; nothing is sent)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.models.sharding import to_placements
    from repro_torch.train.optimizer import AdamState, tree_map
    from repro_torch.train.trainstep import TrainState

    def placed(tree, sp):
        return tree_map(lambda t, s: DTensor.from_local(
            t, mesh, to_placements(mesh, s), run_check=False), tree, sp)
    return TrainState(placed(params, specs.params),
                      AdamState(step, placed(m, specs.opt.m),
                                placed(v, specs.opt.v)))


TP_CHUNK = 1 << 24          # elements a pass of ``_tp_against`` holds


def _tp_against(torch, state, want, before, before_m=None):
    """A TP step's ``state`` against the one-card step's blocks ``want``
    ((params, m, v)) from params ``before`` and m ``before_m`` (None:
    zeros): per part the worst share -- params: an update's error past
    one fp32 ulp over the leaf's largest update (the worst, and the share
    of elements past TP_UPDATE_TOL, and of those elements the one-card
    |m| over the leaf's rms |m|: the median and the largest, ``m_rms``);
    m and v: the largest difference over the leaf's largest |value|.
    ``update_past``, the share of a leaf past TP_UPDATE_TOL, counts only
    the elements whose one-card gradient (from m, Adam's b1 0.9) is at
    least TP_G_SIGN; a leaf with elements below it records its largest
    |gradient| and their share.  Every leaf is read TP_CHUNK elements at
    a time: the card holds the ranks and the twin's blocks beside it."""
    out = {"update_worst": 0.0, "update_past": 0.0, "m": 0.0, "v": 0.0,
           "leaves": {}, "m_rms": []}
    got = (state.params, state.opt.m, state.opt.v)
    want_m = list(leaves(want[1]))
    prev_m = None if before_m is None else list(leaves(before_m))

    def chunks(*ts):
        flat = [None if t is None else t.reshape(-1) for t in ts]
        n = flat[0].numel()
        for a in range(0, n, TP_CHUNK):
            yield [None if t is None else t[a:a + TP_CHUNK] for t in flat]

    def most(fn, *ts):
        return max(fn(*c).max().item() for c in chunks(*ts))
    for part, g_tree, w_tree in zip(("params", "m", "v"), got, want):
        for j, ((k, t), w) in enumerate(zip(leaves_by_path(g_tree).items(),
                                            leaves(w_tree))):
            t = t.to_local()
            leaf = out["leaves"].setdefault("/".join(k), {})
            if part != "params":
                leaf[part] = most(lambda t, w: (t - w).abs(), t, w) / max(
                    most(torch.abs, w), 1e-30)
                out[part] = max(out[part], leaf[part])
                continue
            b = leaves_by_path(before)[k]
            m = want_m[j]
            big = max(most(lambda w, b: (w - b).abs(), w, b), 1e-30)
            rms = math.sqrt(sum(c.float().square().sum().item()
                                for c, in chunks(m)) / m.numel())
            n = dict(past=0, past_1e5=0, past_1e3=0, below=0, held_past=0)
            worst = g_max = 0.0
            for tc, wc, mc, pc in chunks(
                    t, w, m, None if prev_m is None else prev_m[j]):
                a = wc.abs()
                ulp = torch.nextafter(a, torch.full_like(a, float("inf"))) - a
                err = ((tc - wc).abs() - ulp).clamp(min=0) / big
                del a, ulp
                worst = max(worst, err.max().item())
                past = err > TP_UPDATE_TOL
                n["past"] += past.sum().item()
                n["past_1e5"] += (err > 1e-5).sum().item()
                n["past_1e3"] += (err > 1e-3).sum().item()
                del err
                # a tenth of the one-card gradient
                mc = mc.float()
                gm = mc.abs() if pc is None else \
                    (mc - 0.9 * pc.to(mc.device)).abs()
                held = gm >= 0.1 * TP_G_SIGN
                n["below"] += (~held).sum().item()
                n["held_past"] += (past & held).sum().item()
                g_max = max(g_max, 10 * gm.max().item())
                rel = mc.abs()[past] / max(rms, 1e-30)
                if rel.numel():
                    out["m_rms"].append(rel.cpu())
                del past, gm, held, rel
            size = t.numel()
            leaf.update(worst=worst, past=n["past"] / size,
                        past_1e5=n["past_1e5"] / size,
                        past_1e3=n["past_1e3"] / size)
            if n["below"]:
                leaf.update(g_max=g_max, below=n["below"] / size)
            out["update_worst"] = max(out["update_worst"], worst)
            out["update_past"] = max(out["update_past"],
                                     n["held_past"] / size)
    rel = torch.cat(out["m_rms"]) if out["m_rms"] else torch.zeros(1)
    out["m_rms"] = {"n": len(rel), "median": rel.median().item(),
                    "max": rel.max().item()}
    return out


def _ulp_moved(torch, t):
    """``t`` with each element moved by one ulp of its dtype, up or down
    at random (from TP_KEY)."""
    up = torch.rand(t.shape, generator=torch.Generator(device=t.device)
                    .manual_seed(TP_KEY), device=t.device) < 0.5
    inf = torch.full_like(t, float("inf"))
    return torch.where(up, torch.nextafter(t, inf), torch.nextafter(t, -inf))


def _ulp_witness(torch, step, state, batch):
    """One card's own spread for [23] (l): ``step`` from ``state`` with
    the embedding moved by an ulp (``_ulp_moved``), so every activation
    of the forward differs from the twin's in its last bits, as a TP
    step's partial sums make them differ.  It steps copies of the
    moments (Adam updates them in place) and returns its (m, v)."""
    from repro_torch.train.optimizer import AdamState, tree_map
    from repro_torch.train.trainstep import TrainState
    p = dict(state.params, embed=_ulp_moved(torch, state.params["embed"]))
    st, _ = step(TrainState(p, AdamState(
        state.opt.step, tree_map(torch.clone, state.opt.m),
        tree_map(torch.clone, state.opt.v))), batch)
    return st.opt.m, st.opt.v


def _split_witness(torch, step, state, batch, parts: int):
    """One card's own spread from a vocabulary split ((n)): ``step`` from
    ``state`` with the head and the log-probs cut into ``parts`` column
    slices, as a TP step's ranks compute them: each slice's product of
    the normed hidden state (whose gradient then sums the slices'), B1 on
    each slice with their partials merged in slice order
    (``dispatch.token_logprob_vocab_parallel``) and B2 on each slice with
    the merged statistics.  It steps copies of the moments and returns
    its (m, v)."""
    from repro_torch.core import aipo
    from repro_torch.kernels import dispatch
    from repro_torch.models import backbone as bb
    from repro_torch.models.common import norm
    from repro_torch.train.optimizer import AdamState, tree_map
    from repro_torch.train.trainstep import TrainState

    def logits(params, cfg, x):
        x = norm(x, params["final_norm"], cfg.norm)
        head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
        return torch.cat([x @ w for w in head.chunk(parts, dim=-1)], dim=-1)

    def logprobs(logits, tokens, n_valid=None):
        n = logits.shape[-1] // parts
        cuts = [c.contiguous() for c in logits.split(n, dim=-1)]
        stats = []

        def record(part):
            stats.append(part)
            return part[None]
        with torch.no_grad():
            for r, c in enumerate(cuts):
                dispatch.token_logprob_vocab_parallel(
                    c, tokens, r * n, None, n_valid, gather=record)
        merged = torch.stack(stats)
        lps = [dispatch.token_logprob_vocab_parallel(
            c, tokens, r * n, None, n_valid, gather=lambda part: merged)
            for r, c in enumerate(cuts)]
        # each slice's B2 takes the whole gradient, as on its rank
        return lps[0].detach() + sum(lp - lp.detach() for lp in lps)

    real = bb._logits, aipo.token_logprobs
    bb._logits, aipo.token_logprobs = logits, logprobs
    try:
        st, _ = step(TrainState(state.params, AdamState(
            state.opt.step, tree_map(torch.clone, state.opt.m),
            tree_map(torch.clone, state.opt.v))), batch)
    finally:
        bb._logits, aipo.token_logprobs = real
    return st.opt.m, st.opt.v


def _moments_apart(mv, opt):
    """The largest difference of the moments ``mv`` ((m, v)) from
    ``opt``'s, over each leaf's largest |value|: per part the worst and
    its leaf."""
    out = {}
    for part, a, b in zip(("m", "v"), mv, (opt.m, opt.v)):
        worst = (0.0, "")
        for (k, x), y in zip(leaves_by_path(a).items(), leaves(b)):
            e = ((x - y).abs().max() / y.abs().max().clamp(min=1e-30)).item()
            worst = max(worst, (e, "/".join(k)))
        out[part], out[part + "_leaf"] = worst
    return out


def tp_train_rank(torch, rank, mesh, cfg, dev, mark, queues,
                  first_on_card=True, pub=None, steps=TP_TRAIN_STEPS,
                  witness=False, split=0):
    """[23] (h), (f) and (i) on this rank of a (1, m) mesh: ``cfg``
    (llama31-8b at (d)'s config, (l)'s, or (n)'s) in fp32 from TP_SEED
    on a ``_tp_train_batch``.  Rank 0 builds the whole state on the
    card, scores the batch with the one-card ``RefPolicyExecutor`` and
    runs ``steps`` one-card ``make_train_step`` steps; each rank keeps
    its blocks of the initial params and of each step's state (rank 0
    sends the others theirs; the first step's on the card where
    ``first_on_card``, else on the host too; the second's on the host
    until it is compared).  Then (h) a
    ``RefPolicyExecutor`` on the mesh scores the batch on its TP shard;
    (f) ``make_sharded_train_step`` steps tensor-parallel, each step from
    the one-card state before it, its launches counted; (i) the dry
    run's prediction of that step, held to one more step: the bytes it
    starts with and its peak, its FLOPs and its collective bytes.  With
    ``pub`` ((l): ``cfg`` at its published capacity factor, which drops
    choices) the batch is scored by both references at ``pub`` too,
    their drops counted.  With ``witness`` ((l), (n)) rank 0 also steps
    one card from each state with its embedding moved by an ulp
    (``_ulp_witness``): how far that moves the moments; with ``split``
    ((n)) also with its head and log-probs cut into that many vocabulary
    slices (``_split_witness``).  Returns what the parent holds to its
    bounds."""
    import torch.distributed as dist
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.core.executor import RefPolicyExecutor
    from repro_torch.kernels import build
    from repro_torch.launch import dryrun
    from repro_torch.models import init_params
    from repro_torch.models.sharding import state_shardings
    from repro_torch.models.tp import TPRank
    from repro_torch.train.optimizer import adam_init, tree_map
    from repro_torch.train.optimizer import tree_leaves, tree_unflatten
    from repro_torch.train.sharded import MeshWay, make_sharded_train_step
    from repro_torch.train.trainstep import TrainState, make_train_step

    out = {}
    batch = _tp_train_batch(torch, cfg, dev)
    kw = dict(lr=TP_TRAIN_LR, kl_coef=KL_COEF)
    meta = init_params(cfg, 0, torch.float32, device="meta")
    specs = state_shardings(TrainState(meta, adam_init(meta)), mesh)
    group = mesh.get_group("model")

    n_leaves = len(tree_leaves(meta))

    def blocks(tree, sp, keep):
        """This rank's blocks of ``tree`` under ``sp`` on ``keep``: cut
        by rank 0 from the one-card run, which hands the others theirs
        (``_cut_and_hand``)."""
        return tree_unflatten(meta, [
            _cut_and_hand(torch, queues, rank, group, t, s, keep)
            for t, s in zip(tree_leaves(tree) if rank == 0
                            else [None] * n_leaves, tree_leaves(sp))])

    # the one-card twin runs once, on rank 0 (its gradients' atomics make
    # two runs differ in the last bits, and the ranks' blocks of a whole
    # leaf must come from one run)
    params = state = None
    if rank == 0:
        params = init_params(cfg, seed=TP_SEED, dtype=torch.float32,
                             device=dev)
        state = TrainState(params, adam_init(params))
    p0 = blocks(params, specs.params, dev)
    ref_lp = torch.empty(batch["tokens"].shape, dtype=torch.float32,
                         device=dev)
    pub_lp = torch.empty_like(ref_lp)
    one = [None, None]
    pub_drops = [None]
    if rank == 0:
        ref = RefPolicyExecutor(cfg)
        ref.set_weights(params)
        ref.put_input("completions", {"tokens": batch["tokens"]})
        ref_lp.copy_(ref.step()["ref_logp"])
        del ref
        if pub is not None:
            ref = RefPolicyExecutor(pub)
            ref.set_weights(params)
            ref.put_input("completions", {"tokens": batch["tokens"]})
            with _Drops() as d:
                pub_lp.copy_(ref.step()["ref_logp"])
            pub_drops = [[d.routed, d.dropped]]
            del ref
        step = make_train_step(cfg, **kw)
    dist.broadcast(ref_lp, src=0, group=group)
    if pub is not None:
        dist.broadcast(pub_lp, src=0, group=group)
        dist.broadcast_object_list(pub_drops, src=0, group=group)
    out_ref = ref_lp
    yard, one_ms, one_metrics = [], [], []
    if witness:
        out["witness"] = []
    if split:
        out["split_witness"] = []
    for i in range(steps):
        if rank == 0:
            moved = _ulp_witness(torch, step, state, batch) \
                if witness else None
            cut = _split_witness(torch, step, state, batch, split) \
                if split else None
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            torch.cuda.synchronize()
            one_ms.append((time.perf_counter() - t0) * 1e3)
            one_metrics.append({k: float(v) for k, v in metrics.items()})
            if moved is not None:
                out["witness"].append(_moments_apart(moved, state.opt))
            if cut is not None:
                out["split_witness"].append(_moments_apart(cut, state.opt))
            del moved, cut
            torch.cuda.empty_cache()
        keep = dev if i == 0 and first_on_card else "cpu"
        yard.append(tuple(blocks(t, sp, keep) for t, sp in (
            (state.params if state else None, specs.params),
            (state.opt.m if state else None, specs.opt.m),
            (state.opt.v if state else None, specs.opt.v))))
    if rank == 0:
        one = [one_ms, one_metrics]
        del step, metrics
    dist.broadcast_object_list(one, src=0, group=group)
    one_ms, one_metrics = one
    del state, params
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    out["one_ms"], out["one_metrics"] = one_ms, one_metrics
    mark("one-card run")

    # (h) reference scoring on the mesh, on the TP shard of the init
    zeros = tree_map(torch.zeros_like, p0)
    init = _tp_state(torch, mesh, specs, p0, zeros, tree_map(
        torch.zeros_like, p0), 0)
    ref = RefPolicyExecutor(cfg, mesh=mesh)
    ref.set_weights(init.params)
    ref.put_input("completions", {"tokens": batch["tokens"]})
    got = ref.step()["ref_logp"]
    out["h"] = {"tp": ref.tp is not None,
                "err": ((got - out_ref).abs() / out_ref.abs().clamp(
                    min=1.0)).max().item(),
                "scale": out_ref.abs().max().item()}
    del ref, got, out_ref
    if pub is not None:
        # (h) at the published capacity factor: the ranks' own experts
        # drop what one card drops
        ref = RefPolicyExecutor(pub, mesh=mesh)
        ref.set_weights(init.params)
        ref.put_input("completions", {"tokens": batch["tokens"]})
        with _Drops() as d:
            got = ref.step()["ref_logp"]
        out["h_pub"] = {"cf": pub.moe.capacity_factor, "err": (
            (got - pub_lp).abs() / pub_lp.abs().clamp(min=1.0)).max().item(),
            "one": pub_drops[0], "tp": d.summed(torch, group)}
        del ref, got
    del pub_lp, zeros

    # (f) TP steps, each from the one-card state before it, counted
    step = make_sharded_train_step(cfg, mesh, **kw)
    starts = [(init, p0)] + [(None, None)] * (steps - 1)
    out["f"], tp_ms = [], []
    torch.cuda.synchronize()
    build.reset_launches()          # the TP train path's run starts here
    for i in range(steps):
        st, before = starts[i]
        if st is None:
            # the one-card state before this step, on the card
            start = tuple(tree_map(lambda t: t.to(dev), tree)
                          for tree in yard[i - 1])
            st, before = _tp_state(torch, mesh, specs, *start, i), start[0]
            # m on the host: Adam moves the step's m in place
            before_m = tree_map(lambda t: t.cpu(), yard[i - 1][1])
            yard[i - 1] = None
            del start
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        new, metrics = step(st, batch)
        torch.cuda.synchronize()
        tp_ms.append((time.perf_counter() - t0) * 1e3)
        del st
        starts[i] = None
        want = tuple(tree_map(lambda t: t.to(dev), tree) for tree in yard[i])
        check = _tp_against(torch, new, want, before,
                            before_m if i else None)
        check["metrics"] = {k: float(v) for k, v in metrics.items()}
        check["step"] = new.opt.step
        out["f"].append(check)
        del want, before
        before_m = None
        if i < steps - 1:
            del new
        gc.collect()
    torch.cuda.synchronize()
    out["launches"] = dict(build.LAUNCHES)      # ... and ends here
    out["tp_ms"] = tp_ms
    del yard, p0, init, starts
    gc.collect()
    torch.cuda.empty_cache()
    mark("(h)-(f)")

    # (i) the dry run's prediction of one TP step, held to one more step
    amesh = dryrun.production_mesh(mesh_shape=(1, len(queues) + 1))
    c2, sh, lowered = dryrun.lower_combo(
        cfg, ShapeSpec("tp_train", TP_TRAIN_T, TP_TRAIN_ROWS, "train"),
        amesh, dtype=torch.float32, remat=False, kl_coef=KL_COEF)
    rec = dryrun.analyse(c2, sh, lowered, amesh)
    counted = {"all-reduce": 0, "all-gather": 0}
    real = TPRank.all_reduce, TPRank.gather_partials

    def all_reduce(self, x):
        counted["all-reduce"] += x.numel() * x.element_size()
        return real[0](self, x)

    def gather_partials(self, part):
        got = real[1](self, part)
        counted["all-gather"] += got.numel() * got.element_size()
        return got

    def reduce(self, grad):
        # a sliced bias's gradient, summed over ``model`` by DTensor
        if self.role == "sum":
            counted["all-reduce"] += grad.numel() * grad.element_size()
        return real_reduce(self, grad)
    held = sum(t.to_local().numel() * t.to_local().element_size()
               for tree in (new.params, new.opt.m, new.opt.v)
               for t in leaves(tree)) \
        + sum(t.numel() * t.element_size() for t in batch.values())
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    real_reduce = MeshWay.reduce
    TPRank.all_reduce, TPRank.gather_partials = all_reduce, gather_partials
    MeshWay.reduce = reduce
    try:
        new, _ = step(new, batch)
    finally:
        TPRank.all_reduce, TPRank.gather_partials = real
        MeshWay.reduce = real_reduce
    torch.cuda.synchronize()
    temp = torch.cuda.max_memory_allocated() - base
    with FlopCounterMode(display=False) as fc:
        new, _ = step(new, batch)
    own, plain_fwd = tp_train_own_flops(cfg, mesh)
    out["i"] = {"pred": {k: rec[k] for k in (
                    "argument_bytes", "held_bytes", "temp_bytes",
                    "saved_bytes", "peak_bytes_per_device",
                    "flops_per_device", "collectives", "count_s")},
                "held": held, "temp": temp, "card_flops":
                fc.get_total_flops(), "own": own, "plain_fwd": plain_fwd,
                # the global norm's all-reduce of one fp32 over ``model``
                "all_reduce": counted["all-reduce"] + 4,
                "all_gather": counted["all-gather"]}
    del new
    gc.collect()
    torch.cuda.empty_cache()
    return out


def tp_train_own_flops(cfg, mesh):
    """The FLOPs a rank's kernels do in one TP train step of ``cfg`` on
    [TP_TRAIN_ROWS, TP_TRAIN_T], which ``FlopCounterMode`` cannot see (a
    ``ctypes`` launch): B1 and B2 on its vocabulary slice of the loss's
    and, with an MTP head, the MTP loss's rows, B4 (causal) on its heads
    of each layer whose attention goes to the flash kernel (none for
    MLA, whose asymmetric heads go to ``chunked_attention``).  Returns
    (those FLOPs by kernel, the plain attention's forward FLOPs over the
    same layers, which the meta count holds in their place)."""
    from repro_torch.models.sharding import _axis_size, tp_splits
    sp = tp_splits(cfg, mesh)
    m = _axis_size(mesh, "model")
    T, B = TP_TRAIN_T, TP_TRAIN_ROWS
    Vl = cfg.vocab // m if sp["vocab"] else cfg.vocab
    n_rows = B * (T - 1) + (B * (T - 2) if cfg.mtp else 0)
    H = cfg.n_heads // m if sp["heads"] else cfg.n_heads
    n_flash = 0 if cfg.attn_kind == "mla" else flash_layers(cfg, T)
    own = {"fused_logprob": n_rows * Vl * LOGPROB_OPS_PER_LOGIT,
           "fused_logprob_bwd": n_rows * Vl * LOGPROB_BWD_OPS_PER_LOGIT}
    if n_flash:
        own["flash_attention"] = n_flash * 4 * B * H * cfg.hd * T * (T + 1) \
            / 2
    return own, n_flash * 4 * B * H * cfg.hd * T * T


def tp_moe_cfg(torch, arch):
    """(j) and (k): ``arch`` at its published widths and capacity factor
    (1.25: a prefill of 16 gives each of llama4-scout's experts one slot
    a row and deepseek-v3's one, so the capacity drops choices), cut to
    TP_MOE_LAYERS layers (llama4-scout: one iRoPE period; deepseek-v3:
    its 3 dense layers and the first MoE layer)."""
    from repro_torch import configs
    n = TP_MOE_LAYERS[arch]
    return configs.get_config(arch).replace(name=f"{arch}-{n}l", n_layers=n)


def tp_moe_train_cfg(torch, arch):
    """(l): ``arch`` at its published widths, cut to one layer (a MoE
    layer; deepseek-v3 keeps its MTP head, whose block has the dense
    MLP), to TP_MOE_TRAIN's experts (top-k kept) at a capacity factor
    of E / k, so that no expert's capacity drops a choice, and to
    TP_MOE_TRAIN's vocabulary: in fp32 the one-card twin's step peaks
    near 28 bytes a param (params, moments, gradients and Adam's new
    state) beside the other rank's shards, and the full vocabularies'
    embedding and head alone (2.07 B and 1.85 B params) do not fit the
    card so."""
    import dataclasses as dc

    from repro_torch import configs
    full = configs.get_config(arch)
    E, V = TP_MOE_TRAIN[arch]
    moe = dc.replace(full.moe, n_experts=E, first_k_dense=0,
                     capacity_factor=E / full.moe.top_k)
    return full.replace(name=f"{arch}-1l-{E}e-v{V}", n_layers=1, vocab=V,
                        moe=moe)


def _teacher_forced(torch, params, cfg, toks, cache_len, tp=None,
                    drops=None, prompt=TP_PROMPT):
    """The log-probs [rows, n] of ``toks``'s last n tokens, fed one by one
    after a prefill of the first ``prompt``: by one card, or by this rank
    on its shard where ``tp`` is given (its logits gathered whole).
    ``drops`` (a ``_Drops``) counts the prefill's."""
    from repro_torch.models import decode_step, prefill
    lps = []
    with torch.no_grad():
        with drops or contextlib.nullcontext():
            logits, cache = prefill(params, cfg,
                                    {"tokens": toks[:, :prompt]},
                                    cache_len, torch.float32, tp=tp)
        for j in range(toks.shape[1] - prompt):
            row = (logits if tp is None else _tp_whole(torch, logits, tp))
            t = toks[:, prompt + j].long()
            lps.append(torch.log_softmax(row.float(), dim=-1)
                       .gather(1, t[:, None])[:, 0])
            logits, cache = decode_step(params, cfg, cache,
                                        toks[:, prompt + j:
                                             prompt + j + 1], tp=tp)
    return torch.stack(lps, 1)


def tp_moe_serve(torch, rank, mesh, dev, arch, mark, queues):
    """[23] (j) or (k) on this rank: ``tp_moe_cfg(arch)`` in bf16 from
    TP_SEED, rank 0 building it whole and running the one-card
    yardstick (prefill logits, a TP_NEW-token rollout, the reference's
    scoring of it, the drops, and the teacher-forced log-probs and
    scoring of the model with its embedding moved by a bf16 ulp), then
    each rank keeping its TP shard (``_tp_build``).  The TP prefill and
    rollout (this phase's launches counted), the TP step's log-probs of
    the one-card rollout's tokens (teacher-forced), a reference executor
    on the mesh scoring them, the ranks' drops; deepseek-v3's latent
    cache whole and equal on both ranks and (m) the dry run's
    prediction of its TP decode step held to one on the card.  Returns
    what the parent holds to its bounds."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.core.executor import RefPolicyExecutor
    from repro_torch.kernels import build
    from repro_torch.models import init_params, prefill
    from repro_torch.launch.dryrun import shard_shape
    from repro_torch.models.sharding import to_placements, tp_plan
    from repro_torch.rl import prng
    from repro_torch.rl.rollout import action_mask, generate
    from repro_torch.train.optimizer import tree_map
    cfg = tp_moe_cfg(torch, arch)
    key = prng.PRNGKey(TP_KEY)
    prompts = _tp_prompts(torch, cfg, TP_ROWS, dev)
    cache_len = TP_PROMPT + TP_NEW
    out = {"arch": arch}

    def one_card(params):
        with torch.no_grad():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, _ = prefill(params, cfg, {"tokens": prompts}, cache_len,
                                torch.float32)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            st = generate(params, cfg, prompts, max_new=TP_NEW, key=key,
                          temperature=1.0)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            with _Drops() as d:         # the drops of an untimed prefill
                prefill(params, cfg, {"tokens": prompts}, cache_len,
                        torch.float32)
        ref = RefPolicyExecutor(cfg)
        ref.set_weights(params)
        ref.put_input("completions", {"tokens": st.tokens})
        with _Drops() as dr:
            lp = ref.step()["ref_logp"]
        # one card's own spread: the same checks of the model with its
        # embedding moved by a bf16 ulp
        moved = dict(params, embed=_ulp_moved(torch, params["embed"]))
        mask = action_mask(st)[:, TP_PROMPT:].bool()
        w_b = (_teacher_forced(torch, moved, cfg, st.tokens, cache_len)
               - st.behavior_logp[:, TP_PROMPT:]).abs()[mask].mean().item()
        ref = RefPolicyExecutor(cfg)
        ref.set_weights(moved)
        ref.put_input("completions", {"tokens": st.tokens})
        w_ref = (ref.step()["ref_logp"] - lp)[:, 1:].abs().mean().item()
        del ref, moved
        return logits, st, lp, (t1 - t0) * 1e3, (t2 - t1) * 1e3 / TP_NEW, \
            [[d.routed, d.dropped], [dr.routed, dr.dropped]], [w_b, w_ref]

    gc.collect()
    torch.cuda.empty_cache()
    out["card_gb_before"] = [torch.cuda.memory_allocated() / 1e9,
                             torch.cuda.memory_reserved() / 1e9]
    shard, tp, yard = _tp_build(torch, cfg, torch.bfloat16, rank, mesh, dev,
                                one_card, queues)
    plan = tp_plan(cfg, mesh)
    full = init_params(cfg, 0, torch.bfloat16, device="meta")
    got_shapes = {k: list(t.shape) for k, t in leaves_by_path(shard).items()}
    want_shapes = {k: list(shard_shape(t.shape, sp, mesh))
                   for (k, t), sp in zip(leaves_by_path(full).items(),
                                         leaves(plan))}
    stack = "moe_layers"
    out.update(held_gb=sum(t.numel() * t.element_size()
                           for t in leaves(shard)) / 1e9,
               splits=[tp.heads, tp.experts, tp.shared, tp.vocab],
               shapes_ok=got_shapes == want_shapes,
               experts=got_shapes[(stack, "moe", "w_gate")][1])
    del full
    mark("build and yardstick")
    # the main path: TP prefill and rollout, this rank's launches counted
    torch.cuda.synchronize()
    build.reset_launches()
    t0 = time.perf_counter()
    with torch.no_grad():
        local, cache = prefill(shard, cfg, {"tokens": prompts}, cache_len,
                               torch.float32, tp=tp)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        st = generate(shard, cfg, prompts, max_new=TP_NEW, key=key,
                      temperature=1.0, tp=tp)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    out["launches"] = dict(build.LAUNCHES)
    out["prefill_ms"], out["decode_ms"] = (t1 - t0) * 1e3, \
        (t2 - t1) * 1e3 / TP_NEW
    if cfg.attn_kind == "mla":
        # the latent cache: whole ([L, rows, Sc, r]) and equal on both
        # ranks, as every rank computes it from the whole wkv_a
        same = []
        for seg in cache["segments"]:
            for name in ("ckv", "krope"):
                parts = [torch.empty_like(seg[name])
                         for _ in range(tp.size)]
                dist.all_gather(parts, seg[name].contiguous(),
                                group=tp.group)
                same.append(all(torch.equal(parts[0], q) for q in parts))
        out["latent"] = {"equal": all(same), "shape": list(
            cache["segments"][0]["ckv"].shape)}
    whole = _tp_whole(torch, local, tp)
    if rank == 0:
        want, one, one_lp, one_prefill_ms, one_decode_ms = yard[:5]
        out["witness"] = yard[6]
        d = (whole.float() - want.float()).abs()
        out["a"] = {"max": d.max().item(), "mean": d.mean().item(),
                    "finite": bool(torch.isfinite(whole).all()),
                    "scale": want.float().abs().max().item()}
        out["b_equal"] = (st.tokens == one.tokens)[:, TP_PROMPT:] \
            .float().mean().item()
        out["one_prefill_ms"], out["one_decode_ms"] = one_prefill_ms, \
            one_decode_ms
    del local, whole, cache, st
    # teacher-forced: the TP step's log-probs of the one-card tokens
    toks = torch.empty((TP_ROWS, cache_len), dtype=torch.int32, device=dev)
    if rank == 0:
        toks.copy_(yard[1].tokens)
    dist.broadcast(toks, src=0, group=tp.group)
    d = _Drops()
    lps = _teacher_forced(torch, shard, cfg, toks, cache_len, tp, drops=d)
    drops = [d.summed(torch, tp.group)]
    # a reference executor on the mesh, its weights carried by DDMA from
    # this rank's blocks as DTensors of the plan's placements (nothing
    # moves), scoring the one-card rollout's tokens
    placed = tree_map(lambda t, sp: DTensor.from_local(
        t, mesh, to_placements(mesh, sp), run_check=False), shard, plan)
    ref = RefPolicyExecutor(cfg, mesh=mesh)
    ref.set_weights(placed)
    ref.put_input("completions", {"tokens": toks})
    with _Drops() as d:
        ref_lp = ref.step()["ref_logp"]
    drops.append(d.summed(torch, tp.group))
    out["ref_tp"] = ref.tp is not None
    del ref, placed
    if rank == 0:
        # [routed, dropped] choices of the prefill and of the scoring:
        # one card's and the ranks' summed
        out["drops"] = {"one": yard[5], "tp": drops}
        one, one_lp = yard[1], yard[2]
        mask = action_mask(one)[:, TP_PROMPT:].bool()
        d = (lps - one.behavior_logp[:, TP_PROMPT:]).abs()
        out["b"] = {"mean": d[mask].mean().item(),
                    "max": d[mask].max().item(), "n": int(mask.sum())}
        d = (ref_lp - one_lp)[:, 1:].abs()
        out["ref"] = {"mean": d.mean().item(), "max": d.max().item()}
    del lps, ref_lp, yard
    gc.collect()
    torch.cuda.empty_cache()
    mark("TP runs")
    if cfg.attn_kind == "mla":
        out["m"] = tp_decode_prediction(torch, cfg, mesh, shard, tp,
                                            prompts, cache_len, dev)
        mark("(m)")
    del shard
    gc.collect()
    torch.cuda.empty_cache()
    return out


def tp_decode_prediction(torch, cfg, mesh, shard, tp, prompts, cache_len,
                         dev):
    """[23] (m) and (n): the dry run's meta prediction of this rank's TP
    decode step of ``cfg`` over a cache of ``cache_len`` (the rows of
    ``prompts``, bf16), held to one decode step on the card after a
    prefill: the bytes it starts with (its shards, its cache, the tokens)
    and its peak, its FLOPs (no kernel runs in a dense decode, so the
    counts meet) and its all-reduces and all-gathers."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.models import decode_step, prefill
    from repro_torch.models.tp import TPRank
    shape = ShapeSpec("tp_decode", cache_len, prompts.shape[0], "decode")
    amesh = dryrun.production_mesh(mesh_shape=(1, tp.size))
    c, sh, lowered = dryrun.lower_combo(cfg, shape, amesh,
                                        dtype=torch.bfloat16)
    rec = dryrun.analyse(c, sh, lowered, amesh)
    counted = {"all-reduce": 0, "all-gather": 0}

    class Counted(TPRank):
        def all_reduce(self, x):
            counted["all-reduce"] += x.numel() * x.element_size()
            return super().all_reduce(x)

        def gather_partials(self, part):
            got = super().gather_partials(part)
            counted["all-gather"] += got.numel() * got.element_size()
            return got
    ctp = Counted(**{f.name: getattr(tp, f.name)
                     for f in dataclasses.fields(TPRank)})
    with torch.no_grad():
        _, cache = prefill(shard, cfg, {"tokens": prompts}, cache_len,
                           torch.bfloat16, tp=tp)
    tok = prompts[:, -1:].contiguous()
    held = sum(t.numel() * t.element_size() for t in leaves(shard)) \
        + sum(t.numel() * t.element_size() for t in leaves(cache)
              if torch.is_tensor(t)) \
        + tok.numel() * tok.element_size()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        logits, cache = decode_step(shard, cfg, cache, tok, tp=ctp)
    torch.cuda.synchronize()
    temp = torch.cuda.max_memory_allocated() - base
    del logits
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        decode_step(shard, cfg, cache, tok, tp=tp)
    out = {"pred": {k: rec[k] for k in (
               "argument_bytes", "held_bytes", "temp_bytes",
               "peak_bytes_per_device", "flops_per_device", "collectives",
               "count_s")},
           "held": held, "temp": temp, "card_flops": fc.get_total_flops(),
           "all_reduce": counted["all-reduce"],
           "all_gather": counted["all-gather"], "cache_len": cache_len}
    del cache
    return out


def tp_logprob_merge(torch, tp, dev):
    """[23] (g): ``dispatch.token_logprob_vocab_parallel`` on this rank's
    [TP_TRAIN_ROWS, TP_TRAIN_T, V/2] bf16 slice of logits that every rank
    draws whole from one seed, scored over the prefix TP_TRAIN_T - 1, and
    its backward, against B1 and B2 on the whole rows: the merged
    log-probs relative to max(1, |logp|), the slice's gradient against
    the whole row's columns in bf16 ulps (the merged log s differs from
    the whole row's in its last bits), and B2 on the slice with the
    whole row's own stats bit for bit against them."""
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.fused_logprob import fused_logprob_bwd_cuda, \
        fused_logprob_cuda
    g = torch.Generator(device=dev).manual_seed(TP_KEY)
    B, T, V = TP_TRAIN_ROWS, TP_TRAIN_T, V_LLAMA
    whole = (torch.randn(B, T, V, generator=g, device=dev) * 2) \
        .to(torch.bfloat16)
    toks = torch.randint(0, V, (B, T - 1), generator=g, device=dev,
                         dtype=torch.int32)
    g_out = torch.randn(B, T - 1, generator=g, device=dev)
    n = V // tp.size
    col0 = tp.rank * n
    local = whole[..., col0:col0 + n].contiguous().requires_grad_()
    with torch.enable_grad():
        lp = dispatch.token_logprob_vocab_parallel(local, toks, col0,
                                                   tp.group, n_valid=T - 1)
        (d_local,) = torch.autograd.grad(lp, local, g_out)
    lp_w, m_w, s_w = fused_logprob_cuda(whole[:, :-1], toks)
    log_s = torch.log(s_w)
    d_w = fused_logprob_bwd_cuda(whole, toks, m_w, log_s, g_out,
                                 n_valid=T - 1)[..., col0:col0 + n]
    d_own = fused_logprob_bwd_cuda(local.detach(), toks.long() - col0, m_w,
                                   log_s, g_out, n_valid=T - 1)
    want = d_w.float()
    ulps = ((d_local.float() - want).abs()
            / (want.abs() * 2.0 ** -7).clamp(min=1e-38)).max().item()
    out = {"shape": list(local.shape), "col0": col0,
           "lp_rel": ((lp.detach() - lp_w).abs()
                      / lp_w.abs().clamp(min=1.0)).max().item(),
           "grad_ulps": ulps, "own_stats_equal": bool(torch.equal(d_own,
                                                                  d_w)),
           "last_zero": bool((d_local[:, -1] == 0).all().item())}
    del whole, local, d_local, d_w, d_own, want
    torch.cuda.empty_cache()
    return out


def tp_b3_partial(torch, dev, gen, V):
    """B3 in its partial mode on a rank's [TP_ROWS, V] bf16 shard (col0
    V), against its plain version, then timed beside it."""
    from repro_torch.kernels import build
    from repro_torch.kernels.fused_sample import fused_sample_partial_cuda, \
        fused_sample_split_plain, split_plan
    from repro_torch.rl import prng
    B = TP_ROWS
    x = (torch.randn(B, V, generator=gen, device=dev) * 3).to(torch.bfloat16)
    key = prng.PRNGKey(TP_KEY)
    span, n = split_plan(B, V, build.sm_count(dev))
    part = fused_sample_partial_cuda(x, key, 1.0, col0=V)
    plain = fused_sample_split_plain(x, key, 1.0, span, col0=V, partial=True)
    require(torch.equal(part[:, 3], plain[:, 3])
            and torch.equal(part[:, [0, 4]], plain[:, [0, 4]]),
            f"[23] B3 partial [{B}, {V}]: column, max or logit differ")
    s_err = ((part[:, 1] - plain[:, 1]).abs() / plain[:, 1]).max().item()
    require(s_err <= 1e-4, f"[23] B3 partial [{B}, {V}]: s off by "
            f"{s_err:.2e}")

    def run():
        return fused_sample_partial_cuda(x, key, 1.0, col0=V)
    b_ms, b_by = bound(x.numel() * 2 + B * 20,
                       x.numel() * SAMPLE_OPS_PER_LOGIT, FP32_FLOPS)
    rec = {"shape": [B, V], "col0": V, "splits": n,
           "ms": cuda_ms(torch, run, 50),
           "kernel_only_ms": kernel_only_ms(torch, run, 20,
                                            "fused_sample_kernel"),
           "plain_ms": cuda_ms(torch, lambda: fused_sample_split_plain(
               x, key, 1.0, span, col0=V, partial=True), 3),
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
           "s_rel_err": s_err}
    del x, part, plain
    return rec


def tp_b4(torch, dev, shape):
    """B4 on a rank's heads ``shape`` ([B, S, H, K, hd] bf16, causal),
    against ``chunked_attention``, then timed beside it and beside
    ``scaled_dot_product_attention``."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import chunked_attention, \
        flash_attention_cuda
    Bq, S, H, K, hd = shape
    g = torch.Generator(device=dev).manual_seed(sum(shape))
    q, k, v = (torch.randn(Bq, S, h, hd, generator=g, device=dev)
               .to(torch.bfloat16) for h in (H, K, K))
    o = flash_attention_cuda(q, k, v)
    o_p = chunked_attention(q, k, v)
    err = ((o.float() - o_p.float()).abs()
           / o_p.float().abs().clamp(min=1.0)).max().item()
    require(err <= 3e-2, f"[23] B4 at {list(shape)}: error {err:.3e}")

    def run_flash():
        return flash_attention_cuda(q, k, v)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    b_ms, b_by = bound((q.numel() * 2 + k.numel() * 2) * 2,
                       4 * Bq * H * hd * S * (S + 1) / 2, BF16_TENSOR_FLOPS)
    rec = {"shape": list(shape), "ms": cuda_ms(torch, run_flash, 10),
           "kernel_only_ms": kernel_only_ms(torch, run_flash, 3,
                                            "flash_fwd_wgmma_kernel"),
           "plain_ms": cuda_ms(torch, lambda: chunked_attention(q, k, v), 3),
           "library_ms": cuda_ms(torch, lambda: F.scaled_dot_product_attention(
               qt, kt, vt, is_causal=True, enable_gqa=True), 10),
           "bound_ms": b_ms, "bound_by": b_by, "max_rel_err": err}
    del q, k, v, o, o_p, qt, kt, vt
    return rec


def tp_time_shards(torch, dev, records):
    """B3 in its partial mode on a rank's [16, V/2] bf16 shard (col0 V/2)
    of llama31-8b's, llama4-scout's and deepseek-v3's vocabularies, B4 on
    a rank's heads of llama31-8b [4, 2048, 16, 4, 128] and of
    llama4-scout [4, 2048, 20, 4, 128], and B1 and B2 on a rank's [16,
    80, V/2] bf16 logits of a TP train step at the three vocabularies,
    each against its plain version, then timed beside it (and B4 beside
    scaled_dot_product_attention, B1 and B2 beside F.cross_entropy and
    its backward); added to the kernels' records, under ``tp_shard``
    (llama31-8b's), ``tp_scout`` and ``tp_dsv3``."""
    gen = torch.Generator(device=dev).manual_seed(23)
    shards = (("tp_shard", V_LLAMA, TP_B4), ("tp_scout", V_SCOUT, TP_B4_MOE),
              ("tp_dsv3", V_DSV3, None))
    for label, V, b4_shape in shards:
        Vl = V // TP_RANKS
        got = {"fused_sample": tp_b3_partial(torch, dev, gen, Vl)}
        if b4_shape is not None:
            got["flash_attention"] = tp_b4(torch, dev, b4_shape)
        # B1 and B2 on a rank's vocabulary slice of a TP train step's
        # logits ([16, 80, V/2] bf16, scored over the first 79 positions)
        for name, timed in (("fused_logprob", timed_logprob_at),
                            ("fused_logprob_bwd", timed_logprob_bwd_at)):
            got[name] = timed(torch, dev, gen, Vl, T=TP_TRAIN_T)
        for name, r in got.items():
            next(x for x in records if x["name"] == name)[label] = r
            if name in ("fused_logprob", "fused_logprob_bwd"):
                continue
            log(f"  time {name} on a rank's shard {r['shape']} ({label})"
                + (f" (partial mode, col0 {r['col0']}, {r['splits']} "
                   "splits)" if name == "fused_sample" else "")
                + f": {r['ms']:.4f} ms per call ("
                + ("not measured" if r["kernel_only_ms"] is None
                   else f"{r['kernel_only_ms']:.4f} ms") + " in the "
                "kernel), "
                f"plain {r['plain_ms']:.4f} ms, "
                + ("" if r["library_ms"] is None
                   else f"library {r['library_ms']:.4f} ms, ")
                + f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}); "
                + nvidia_smi())


def tp4_cfg(layers: int):
    """(n): starcoder2-3b at its published widths, cut to ``layers``."""
    return configs_full(TP4_ARCH).replace(name=f"{TP4_ARCH}-{layers}l",
                                          n_layers=layers)


def tp4_rank_main(rank, rdv, out_path, queues, dev_type="cuda"):
    """One rank of [23] (n)'s (1, 4) mesh on the one card, a gloo group
    over CUDA tensors, rank 0 handing the others their blocks over
    ``queues``: starcoder2-3b at TP4_LAYERS layers in bf16 from TP_SEED,
    rank 0 running the one-card yardstick (prefill logits, a TP4_NEW-token
    rollout, the teacher-forced log-probs of the model with its embedding
    moved by a bf16 ulp); each rank's shards against the plan, the TP
    prefill and rollout (launches counted), the TP step's log-probs of
    the one-card tokens (teacher-forced), the dry run's prediction of a
    TP decode step held to the card; then one fp32 TP train step at one
    layer (``tp_train_rank``: (h), (f), (i)).  Writes its results to
    ``out_path``_<rank>.json."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.kernels import build
    from repro_torch.launch.dryrun import shard_shape
    from repro_torch.models import init_params, prefill
    from repro_torch.models.sharding import tp_plan
    from repro_torch.rl import prng
    from repro_torch.rl.rollout import action_mask, generate

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if dev_type == "cuda":
        torch.cuda.set_device(0)
    dev = torch.device(dev_type, 0) if dev_type == "cuda" \
        else torch.device(dev_type)
    dist.init_process_group("gloo", init_method=rdv, rank=rank,
                            world_size=TP4_RANKS,
                            timeout=datetime.timedelta(seconds=TP_TIMEOUT_S))
    res = {"backend": dist.get_backend()}
    times = [("", time.perf_counter())]

    def mark(label: str):
        times.append((label, time.perf_counter()))

    try:
        mesh = DeviceMesh(dev_type,
                          torch.arange(TP4_RANKS).reshape(1, TP4_RANKS),
                          mesh_dim_names=("data", "model"))
        cfg = tp4_cfg(TP4_LAYERS)
        key = prng.PRNGKey(TP_KEY)
        prompts = _tp_prompts(torch, cfg, TP4_ROWS, dev, prompt=TP4_PROMPT)
        cache_len = TP4_PROMPT + TP4_NEW

        def one_card(params):
            with torch.no_grad():
                logits, _ = prefill(params, cfg, {"tokens": prompts},
                                    cache_len, torch.float32)
                st = generate(params, cfg, prompts, max_new=TP4_NEW,
                              key=key, temperature=1.0)
            # one card's own spread: its embedding moved by a bf16 ulp
            moved = dict(params, embed=_ulp_moved(torch, params["embed"]))
            mask = action_mask(st)[:, TP4_PROMPT:].bool()
            w_b = (_teacher_forced(torch, moved, cfg, st.tokens, cache_len,
                                   prompt=TP4_PROMPT)
                   - st.behavior_logp[:, TP4_PROMPT:]).abs()[mask] \
                .mean().item()
            return logits, st, w_b

        shard, tp, yard = _tp_build(torch, cfg, torch.bfloat16, rank, mesh,
                                    dev, one_card, queues)
        full = init_params(cfg, 0, torch.bfloat16, device="meta")
        got = {"/".join(k): list(t.shape)
               for k, t in leaves_by_path(shard).items()}
        want = {"/".join(k): list(shard_shape(t.shape, sp, mesh))
                for (k, t), sp in zip(leaves_by_path(full).items(),
                                      leaves(tp_plan(cfg, mesh)))}
        res.update(
            held_gb=sum(t.numel() * t.element_size()
                        for t in leaves(shard)) / 1e9,
            whole_gb=sum(t.numel() * t.element_size()
                         for t in leaves(full)) / 1e9,
            splits=[tp.heads, tp.proj, tp.ffn, tp.vocab],
            shapes_ok=got == want,
            attn={w: [list(full["layers"]["attn"][w].shape),
                      got[f"layers/attn/{w}"]]
                  for w in ("wq", "wk", "wv", "wo")})
        del full
        mark("build and yardstick")
        # the main path: TP prefill and rollout, this rank's launches
        torch.cuda.synchronize()
        build.reset_launches()
        t0 = time.perf_counter()
        with torch.no_grad():
            local, _ = prefill(shard, cfg, {"tokens": prompts}, cache_len,
                               torch.float32, tp=tp)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            st = generate(shard, cfg, prompts, max_new=TP4_NEW, key=key,
                          temperature=1.0, tp=tp)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        res["launches"] = dict(build.LAUNCHES)
        res["prefill_ms"] = (t1 - t0) * 1e3
        res["decode_ms"] = (t2 - t1) * 1e3 / TP4_NEW
        whole = _tp_whole(torch, local, tp)
        toks = torch.empty((TP4_ROWS, cache_len), dtype=torch.int32,
                           device=dev)
        if rank == 0:
            want_logits, one, res["witness"] = yard
            d = (whole.float() - want_logits.float()).abs()
            res["a"] = {"max": d.max().item(), "mean": d.mean().item(),
                        "finite": bool(torch.isfinite(whole).all()),
                        "scale": want_logits.float().abs().max().item()}
            res["b_equal"] = (st.tokens == one.tokens)[:, TP4_PROMPT:] \
                .float().mean().item()
            toks.copy_(one.tokens)
        del local, whole, st
        # teacher-forced: the TP step's log-probs of the one-card tokens
        dist.broadcast(toks, src=0, group=tp.group)
        lps = _teacher_forced(torch, shard, cfg, toks, cache_len, tp,
                              prompt=TP4_PROMPT)
        if rank == 0:
            one = yard[1]
            mask = action_mask(one)[:, TP4_PROMPT:].bool()
            d = (lps - one.behavior_logp[:, TP4_PROMPT:]).abs()
            res["b"] = {"mean": d[mask].mean().item(),
                        "max": d[mask].max().item(), "n": int(mask.sum())}
        del lps, yard
        mark("TP runs")
        res["m"] = tp_decode_prediction(torch, cfg, mesh, shard, tp, prompts,
                                        cache_len, dev)
        del shard
        gc.collect()
        torch.cuda.empty_cache()
        mark("dry run")
        res["train"] = tp_train_rank(torch, rank, mesh, tp4_cfg(1), dev,
                                     mark, queues, steps=1, witness=True,
                                     split=TP4_RANKS)
        res["seconds"] = [(b[0], b[1] - a[1])
                          for a, b in zip(times, times[1:])]
    finally:
        with open(f"{out_path}_{rank}.json", "w") as f:
            json.dump(res, f)
        dist.destroy_process_group()


def tp4_vocab_rank_main(rank, rdv, out_path, queues, dev_type="cuda"):
    """One rank of ``python3 chip_smoke.py --tp4-vocab``: (n)'s fp32 TP
    train step at one layer (``tp_train_rank`` with one card's ulp
    witness) on the (1, 4) mesh twice, at starcoder2-3b's vocabulary
    (split four ways) and at TP4_VOCAB_WHOLE (which 4 does not divide, so
    the embedding, the head and the loss stay whole on every rank), to
    show how much of the step's spread the vocabulary split makes.
    Writes its results to ``out_path``_<rank>.json."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if dev_type == "cuda":
        torch.cuda.set_device(0)
    dev = torch.device(dev_type, 0) if dev_type == "cuda" \
        else torch.device(dev_type)
    dist.init_process_group("gloo", init_method=rdv, rank=rank,
                            world_size=TP4_RANKS,
                            timeout=datetime.timedelta(seconds=TP_TIMEOUT_S))
    res = {}
    try:
        mesh = DeviceMesh(dev_type,
                          torch.arange(TP4_RANKS).reshape(1, TP4_RANKS),
                          mesh_dim_names=("data", "model"))
        for V in (tp4_cfg(1).vocab, TP4_VOCAB_WHOLE):
            res[str(V)] = tp_train_rank(
                torch, rank, mesh, tp4_cfg(1).replace(vocab=V), dev,
                lambda label: None, queues, steps=1, witness=True)
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        with open(f"{out_path}_{rank}.json", "w") as f:
            json.dump(res, f)
        dist.destroy_process_group()


def tp4_vocab(torch):
    """``--tp4-vocab``: (n)'s train checks (``tp_train_checks``, m and v
    at the witness rule) at each vocabulary of ``tp4_vocab_rank_main``,
    every reading printed, none of them failing the run.  Returns 0."""
    phase_build()
    ranks = _spawn_ranks(tp4_vocab_rank_main, TP4_RANKS, "tp4v")
    for V in ranks[0]:
        cfg = tp4_cfg(1).replace(vocab=int(V))
        tag = f" {cfg.name} vocabulary {V}"
        trains = [r[V] for r in ranks]
        log(f"[tp4-vocab]{tag}: split over model "
            f"{cfg.vocab % TP4_RANKS == 0}; {nvidia_smi()}")
        try:
            m_tol, v_tol = _witness_tols(trains[0]["witness"], "(n)" + tag)
            tp_train_checks(trains, tag, f"[16, 80, {cfg.d_model}]",
                            m_tol=(m_tol,), v_tol=(v_tol,))
        except RuntimeError as e:
            log(f"  outside the bounds: {e}")
    return 0


def _spawn_ranks(fn, n: int, name: str) -> list:
    """``fn(rank, rendezvous, out, queues)`` in ``n`` spawned processes
    (a ``file://`` rendezvous under build/, one spawn-context queue a
    rank past the first), within TP_TIMEOUT_S; every rank's results."""
    import torch.multiprocessing as mp
    d = ROOT / "build"
    d.mkdir(exist_ok=True)
    rdv = d / f"rendezvous_{name}_{os.getpid()}"
    out = str(d / f"{name}_rank_{os.getpid()}")
    for p in [rdv] + [Path(f"{out}_{r}.json") for r in range(n)]:
        if p.exists():
            p.unlink()
    queues = [mp.get_context("spawn").Queue() for _ in range(n - 1)]
    ctx = mp.start_processes(fn, nprocs=n, join=False, start_method="spawn",
                             args=("file://" + str(rdv), out, queues))
    try:
        deadline = time.monotonic() + TP_TIMEOUT_S
        while not ctx.join(timeout=5):
            require(time.monotonic() < deadline, f"[23] {name} ranks timed "
                    "out")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
        if rdv.exists():
            rdv.unlink()
    ranks = []
    for r in range(n):
        path = Path(f"{out}_{r}.json")
        ranks.append(json.loads(path.read_text()))
        path.unlink()
    return ranks


def phase_tp(torch, dev, records):
    """[23]: llama31-8b, llama4-scout and deepseek-v3 served and trained
    tensor-parallel by two spawned ranks sharing the one card as a (data
    1, model 2) mesh, then (n) starcoder2-3b by four as a (data 1, model
    4) mesh.  Returns the launch counts of the ranks' main-path runs,
    summed."""
    log(f"[23] tp: llama31-8b, llama4-scout and deepseek-v3 served and "
        f"trained on a (data 1, model 2) mesh of two processes on the one "
        f"card, then starcoder2-3b on a (data 1, model 4) mesh of four; "
        f"{nvidia_smi()}")
    t0 = time.perf_counter()
    tp_time_shards(torch, dev, records)
    t1 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    ranks = _spawn_ranks(tp_rank_main, TP_RANKS, "tp")
    t2 = time.perf_counter()
    ranks4 = _spawn_ranks(tp4_rank_main, TP4_RANKS, "tp4")
    t3 = time.perf_counter()
    r0 = ranks[0]
    smi = nvidia_smi()
    require(all(r["backend"] == "gloo" for r in ranks), "[23] backend")
    log(f"  process group: {r0['backend']} over CUDA tensors, {TP_RANKS} "
        f"ranks on one card; each rank holds {r0['held_gb']:.3f} GB (wq "
        f"{r0['wq']}), splits heads/ffn/vocab {r0['splits']}")
    require(r0["splits"] == [True, True, True], "[23] llama31-8b splits")
    a = r0["a"]
    log(f"  (a) prefill [{TP_ROWS}, {TP_PROMPT}] bf16, TP logits against one "
        f"card: max|d| {a['max']:.4f}, mean|d| {a['mean']:.5f} (max|logit| "
        f"{a['scale']:.2f}); TP prefill {r0['prefill_ms']:.1f} ms, decode "
        f"{r0['decode_ms']:.2f} ms a token on gloo; {smi}")
    require(a["finite"], "[23] (a) TP logits not finite")
    b = r0["b"]
    log(f"  (b) {TP_LLAMA_NEW} new tokens: the TP step's log-probs of the "
        f"one-card rollout's tokens (teacher-forced) against its behaviour "
        f"log-probs at {b['n']} actions: mean|d| {b['mean']:.4f} (bound {TP_LP_MEAN}), "
        f"max|d| {b['max']:.4f}; the TP rollout's own tokens equal to the "
        f"one card's: {100 * r0['b_equal']:.1f}%")
    require(b["mean"] <= TP_LP_MEAN, f"[23] (b) mean|dlogp| {b['mean']:.4f}")
    for r, res in enumerate(ranks):
        c = res["c"]
        for T in ("T0.0", "T0.7", "T1.0"):
            ct = c[T]
            require(ct["col"] and ct["mx"] and ct["z"] <= 1e-5
                    and ct["s"] <= 1e-4,
                    f"[23] (c) rank {r} {T}: B3 partial against the plain "
                    f"split version: {ct}")
            if r == 0:
                require(ct["tokens"] and ct["lp"] <= TP_SAMPLE_REL,
                        f"[23] (c) {T}: merged against the whole row {ct}")
        log(f"  (c) rank {r}: B3 partial on {c['shape']} with col0 "
            f"{c['col0']} against fused_sample_split_plain: columns, max "
            f"and logits equal, |dz| <= "
            f"{max(c[T]['z'] for T in ('T0.0', 'T0.7', 'T1.0')):.2e}, s "
            f"within {max(c[T]['s'] for T in ('T0.0', 'T0.7', 'T1.0')):.2e}"
            + ("" if r else
               "; merged over the ranks against B3 on the whole row: tokens "
               "bit-equal, log-probs within "
               f"{max(c[T]['lp'] for T in ('T0.0', 'T0.7', 'T1.0')):.2e} "
               f"relative (bound {TP_SAMPLE_REL:g})"))
        for s, err in res["b4"].items():
            require(err <= 3e-2, f"[23] rank {r} B4 {s}: {err:.3e}")
        log(f"  rank {r}: B4 on its heads {list(res['b4'])} against "
            f"chunked_attention: max|do|/max(1,|o|) "
            f"{max(res['b4'].values()):.3e} (tolerance 3e-2); launches "
            f"{res['launches']}")
    dd = r0["d"]
    log(f"  (d) {TP_FP32_LAYERS} layers fp32 at full width: TP logits max|d| "
        f"{dd['max']:.3e} (max|logit| {dd['scale']:.2f}, bound "
        f"{TP_FP32_TOL:g} of max(1, |logit|)); tokens of {TP_FP32_NEW} under "
        f"the same key identical: {dd['tokens']}")
    require(dd["max"] <= TP_FP32_TOL * max(1.0, dd["scale"]) and dd["tokens"],
            f"[23] (d) {dd}")
    e = r0["e"]
    p = e["pred"]
    card = e["card_flops"] + e["own"]
    flop_err = abs(card - p["flops_per_device"]) / p["flops_per_device"]
    peak = e["held"] + e["temp"]
    ratio = peak / p["peak_bytes_per_device"]
    log(f"  (e) dry run of rank 0's TP prefill at (d)'s config (meta, "
        f"{p['count_s']} s): held {p['held_bytes'] / 1e6:.0f} MB (argument "
        f"bytes by the reference's rules {p['argument_bytes'] / 1e6:.0f} MB), "
        f"temp {p['temp_bytes'] / 1e6:.0f} MB, peak "
        f"{p['peak_bytes_per_device'] / 1e6:.0f} MB, all-reduce "
        f"{p['collectives'].get('all-reduce', 0) / 1e6:.3f} MB, "
        f"{p['flops_per_device'] / 1e9:.3f} GFLOP; on the card: held "
        f"{e['held'] / 1e6:.0f} MB, {e['temp'] / 1e6:.0f} MB above it, peak "
        f"{peak / 1e6:.0f} MB ({ratio:.3f} of the prediction, band "
        f"{DRYRUN_BYTES_BAND}), gloo all-reduce {e['all_reduce'] / 1e6:.3f} "
        f"MB, FlopCounterMode {e['card_flops'] / 1e9:.3f} + B4's own "
        f"{e['own'] / 1e9:.4f} GFLOP (relative {flop_err:.2e}, tolerance "
        f"{DRYRUN_FLOP_TOL:g}); the count plus the plain attention's forward "
        f"less the prediction: "
        f"{e['card_flops'] + e['plain_fwd'] - p['flops_per_device']:.0f} "
        "FLOP")
    require(flop_err <= DRYRUN_FLOP_TOL, f"[23] (e) FLOPs off {flop_err:.2e}")
    require(DRYRUN_BYTES_BAND[0] <= ratio <= DRYRUN_BYTES_BAND[1],
            f"[23] (e) peak {peak} against {p['peak_bytes_per_device']}")
    require(e["all_reduce"] == p["collectives"].get("all-reduce"),
            "[23] (e) all-reduce bytes")
    tp_train_report(ranks)
    moe_launches = tp_moe_report(torch, ranks)
    from repro_torch.configs.llama_paper import LLAMA31_8B
    launches = collections.Counter(moe_launches)
    for res in ranks:
        want = {"flash_attention": 2 * LLAMA31_8B.n_layers,
                "fused_sample": TP_LLAMA_NEW}
        require(res["launches"] == want,
                f"[23] launches {res['launches']}, want {want}")
        # (f): B1 and B2 once a step, B4 once a layer (no remat_layers)
        want = {"fused_logprob": TP_TRAIN_STEPS,
                "fused_logprob_bwd": TP_TRAIN_STEPS,
                "flash_attention": TP_TRAIN_STEPS * TP_FP32_LAYERS}
        got = res["train"]["launches"]
        require(got == want, f"[23] (f) launches {got}, want {want}")
        launches.update(res["launches"])
        launches.update(got)
    launches.update(tp4_report(ranks4))
    log(f"  [23] launches {dict(launches)}; {time.perf_counter() - t0:.1f} s "
        f"(shard timings {t1 - t0:.1f} s, ranks {t2 - t1:.1f} s: "
        + ", ".join(f"{label} {s:.1f}" for label, s in r0["seconds"])
        + " s; (j), (k), then (l)'s two configs in turn; (n)'s four ranks "
        f"{t3 - t2:.1f} s: "
        + ", ".join(f"{label} {s:.1f}" for label, s in ranks4[0]["seconds"])
        + " s)")
    return dict(launches)


def tp4_report(ranks):
    """[23] (n) of every rank, printed and held to its bounds.  Returns
    the launch counts of its main-path runs, summed."""
    smi = nvidia_smi()
    cfg, cfg1 = tp4_cfg(TP4_LAYERS), tp4_cfg(1)
    require(all(r["backend"] == "gloo" for r in ranks), "[23] (n) backend")
    log(f"  (n) {cfg.name}: {cut_line(configs_full(TP4_ARCH), cfg)}; "
        f"{cfg.n_heads} query and {cfg.n_kv_heads} KV heads of {cfg.hd} on "
        f"a (data 1, model {TP4_RANKS}) mesh of {TP4_RANKS} processes, gloo "
        f"over CUDA tensors")
    launches = collections.Counter()
    for r, o in enumerate(ranks):
        log(f"  (n) rank {r}: holds {o['held_gb']:.4f} GB of "
            f"{o['whole_gb']:.4f} bf16, splits heads/proj/ffn/vocab "
            f"{o['splits']}, every leaf the plan's block: {o['shapes_ok']}; "
            "wq wk wv wo whole and held: "
            + ", ".join(f"{w} {a} {b}" for w, (a, b) in o["attn"].items())
            + f"; launches {o['launches']}")
        quarter = all(
            b[:d] + b[d + 1:] == a[:d] + a[d + 1:] and b[d] * TP4_RANKS == a[d]
            for w, (a, b) in o["attn"].items()
            for d in [len(a) - (2 if w == "wo" else 1)])
        require(o["shapes_ok"] and quarter
                and o["splits"] == [False, True, True, True],
                f"[23] (n) rank {r}: shards {o['splits']}, {o['attn']}")
        want = {"fused_sample": TP4_NEW}
        if flash_layers(cfg):
            want["flash_attention"] = 2 * flash_layers(cfg)
        require(o["launches"] == want,
                f"[23] (n) launches {o['launches']}, want {want}")
        launches.update(o["launches"])
    o = ranks[0]
    a, b = o["a"], o["b"]
    bound_b = max(TP_LP_MEAN, o["witness"])
    log(f"  (n) prefill [{TP4_ROWS}, {TP4_PROMPT}] bf16, TP logits against "
        f"one card: max|d| {a['max']:.4f}, mean|d| {a['mean']:.5f} "
        f"(max|logit| {a['scale']:.2f}); {TP4_NEW} new tokens, the TP "
        f"step's log-probs of the one-card rollout's tokens against its "
        f"behaviour log-probs at {b['n']} actions: mean|d| {b['mean']:.4f} "
        f"(bound {bound_b:.4f}: (b)'s {TP_LP_MEAN} or one card's own with "
        f"its embedding moved by a bf16 ulp, {o['witness']:.4f}, the "
        f"larger), max|d| {b['max']:.4f}; the TP rollout's own tokens equal "
        f"to the one card's: {100 * o['b_equal']:.1f}%; TP prefill "
        f"{o['prefill_ms']:.1f} ms, decode {o['decode_ms']:.2f} ms a token "
        f"on gloo; {smi}")
    require(a["finite"] and b["mean"] <= bound_b,
            f"[23] (n) TP against one card: {a}, {b}")
    tp_decode_report(o["m"], "(n)", cfg.name, smi)
    trains = [res["train"] for res in ranks]
    m_tol, v_tol = _witness_tols(trains[0]["witness"], f"(n) {cfg1.name}",
                                 split=trains[0]["split_witness"])
    tp_train_checks(trains, f" {cfg1.name}", f"[16, 80, {cfg1.d_model}]",
                    m_tol=(m_tol,), v_tol=(v_tol,))
    want = {"fused_logprob": 1, "fused_logprob_bwd": 1}
    if flash_layers(cfg1, TP_TRAIN_T):
        want["flash_attention"] = flash_layers(cfg1, TP_TRAIN_T)
    for tr in trains:
        require(tr["launches"] == want,
                f"[23] (n) train launches {tr['launches']}, want {want}")
        launches.update(tr["launches"])
    return launches


def tp_moe_report(torch, ranks):
    """[23] (j)-(m) of every rank, printed and held to their bounds.
    Returns the launch counts of their main-path runs, summed."""
    smi = nvidia_smi()
    launches = collections.Counter()
    for arch in TP_MOE_ARCHS:
        cfg = tp_moe_cfg(torch, arch)
        tag = "(j)" if arch == MOE_ARCH else "(k)"
        E = cfg.moe.n_experts
        log(f"  {tag} {cfg.name}: {cut_line(configs_full(arch), cfg)}; "
            f"capacity factor {cfg.moe.capacity_factor:g}, as published")
        for r, res in enumerate(ranks):
            o = res["moe"][arch]
            log(f"  {tag} {cfg.name} bf16, rank {r} (card memory "
                f"allocated and reserved as it starts "
                f"{o['card_gb_before'][0]:.3f}, "
                f"{o['card_gb_before'][1]:.3f} GB): holds "
                f"{o['held_gb']:.3f} GB, {o['experts']} of {E} experts, "
                f"splits heads/experts/shared/vocab {o['splits']}, every "
                f"leaf the plan's block: {o['shapes_ok']}; launches "
                f"{o['launches']}")
            require(o["shapes_ok"] and o["experts"] == E // TP_RANKS
                    and o["splits"] == [True] * 4,
                    f"[23] {tag} rank {r}: shards {o['splits']}, "
                    f"{o['experts']} experts")
            want = {"fused_sample": TP_NEW}
            if cfg.attn_kind != "mla" and flash_layers(cfg):
                want["flash_attention"] = 2 * flash_layers(cfg)
            require(o["launches"] == want,
                    f"[23] {tag} launches {o['launches']}, want {want}")
            require(o["ref_tp"], f"[23] {tag} reference not on its TP shard")
            launches.update(o["launches"])
            if "latent" in o:
                log(f"  {tag} rank {r}: the latent cache "
                    f"{o['latent']['shape']} per segment's ckv, whole and "
                    f"equal on both ranks: {o['latent']['equal']}")
                require(o["latent"]["equal"] and o["latent"]["shape"][-1]
                        == cfg.mla.kv_lora_rank,
                        f"[23] {tag} latent cache {o['latent']}")
        o = ranks[0]["moe"][arch]
        a, b, ref = o["a"], o["b"], o["ref"]
        w_b, w_ref = o["witness"]
        bound_b, bound_ref = max(TP_LP_MEAN, w_b), max(TP_LP_MEAN, w_ref)
        log(f"  {tag} prefill [{TP_ROWS}, {TP_PROMPT}], TP logits against "
            f"one card: max|d| {a['max']:.4f}, mean|d| {a['mean']:.5f} "
            f"(max|logit| "
            f"{a['scale']:.2f}); {TP_NEW} new tokens, the TP step's log-probs "
            f"of the one-card rollout's tokens against its behaviour "
            f"log-probs at {b['n']} actions: mean|d| {b['mean']:.4f} (bound "
            f"{bound_b:.4f}), max|d| {b['max']:.4f}; the TP "
            f"rollout's own tokens equal to the one card's: "
            f"{100 * o['b_equal']:.1f}%; a reference executor on the mesh "
            f"scoring them against the one-card one: mean|d ref_logp| "
            f"{ref['mean']:.4f} (bound {bound_ref:.4f}), max "
            f"{ref['max']:.4f}")
        log(f"  {tag} one card's own spread, its embedding moved by a bf16 "
            f"ulp: teacher-forced mean|d| {w_b:.4f}, reference mean|d| "
            f"{w_ref:.4f}; the TP runs held to that or (b)'s {TP_LP_MEAN}, "
            f"the larger")
        (pr, sc), (tpr, tsc) = o["drops"]["one"], o["drops"]["tp"]
        log(f"  {tag} choices the capacity drops, one card's and the ranks' "
            f"summed (bf16 routes may flip between them): the prefill "
            f"{pr[1]} and {tpr[1]} of {pr[0]} and {tpr[0]}, the scoring "
            f"{sc[1]} and {tsc[1]} of {sc[0]} and {tsc[0]}")
        require(a["finite"] and b["mean"] <= bound_b
                and ref["mean"] <= bound_ref
                and pr[0] == tpr[0] and sc[0] == tsc[0],
                f"[23] {tag} TP against one card: {a}, {b}, {ref}, "
                f"drops {o['drops']}")
        log(f"  {tag} times: TP prefill {o['prefill_ms']:.1f} ms, decode "
            f"{o['decode_ms']:.2f} ms a token on gloo; one card "
            f"{o['one_prefill_ms']:.1f} ms, {o['one_decode_ms']:.2f} ms a "
            f"token; {smi}")
        if "m" in o:
            tp_decode_report(o["m"], "(m)", tag, smi)
    for arch in TP_MOE_ARCHS:
        cfg = tp_moe_train_cfg(torch, arch)
        tag = f" {cfg.name}"
        full = configs_full(arch)
        from repro_torch.configs import param_count
        n = param_count(cfg)[0]
        log(f"  (l) {cfg.name}, cut where two ranks and the one-card twin "
            f"must fit the card: {full.n_layers} layers to 1 (a MoE layer; "
            f"first_k_dense {full.moe.first_k_dense} to 0), "
            f"{full.moe.n_experts} experts to {cfg.moe.n_experts} (top "
            f"{cfg.moe.top_k} kept, capacity factor "
            f"{cfg.moe.capacity_factor:g}, so no choice is dropped), "
            f"vocabulary {full.vocab} to {cfg.vocab}; {n / 1e9:.2f} B "
            f"params, {16 * n / 1e9:.1f} GB of fp32 params, gradients and "
            f"moments")
        trains = [res["moe_train"][arch] for res in ranks]
        m_tol, v_tol = _witness_tols(trains[0]["witness"], "(l)" + tag)
        tp_train_checks(trains, tag, f"[16, 80, {cfg.d_model}]",
                        m_tol=(m_tol,) * TP_TRAIN_STEPS,
                        v_tol=(v_tol,) * TP_TRAIN_STEPS)
        steps = TP_TRAIN_STEPS * (2 if cfg.mtp else 1)
        want = {"fused_logprob": steps, "fused_logprob_bwd": steps}
        n_flash = 0 if cfg.attn_kind == "mla" else flash_layers(
            cfg, TP_TRAIN_T)
        if n_flash:
            want["flash_attention"] = TP_TRAIN_STEPS * n_flash
        for tr in trains:
            require(tr["launches"] == want,
                    f"[23] (l){tag} launches {tr['launches']}, want {want}")
            launches.update(tr["launches"])
    return launches


def configs_full(arch):
    """``arch``'s published config."""
    from repro_torch import configs
    return configs.get_config(arch)


def tp_decode_report(m, label, tag, smi):
    """[23] (m) of (k)'s decode or (n)'s (``label``): the dry run's
    prediction against the card, printed and held to its bounds."""
    p = m["pred"]
    flop_err = abs(m["card_flops"] - p["flops_per_device"]) \
        / p["flops_per_device"]
    peak = m["held"] + m["temp"]
    ratio = peak / p["peak_bytes_per_device"]
    colls = p["collectives"]
    log(f"  {label} dry run of rank 0's TP decode step at {tag}'s config "
        f"over a cache of {m['cache_len']} (meta, {p['count_s']} s): held "
        f"{p['held_bytes'] / 1e6:.3f} MB (argument bytes by the reference's "
        f"rules {p['argument_bytes'] / 1e6:.3f} MB), temp "
        f"{p['temp_bytes'] / 1e6:.1f} MB, peak "
        f"{p['peak_bytes_per_device'] / 1e6:.0f} MB, "
        f"{p['flops_per_device'] / 1e9:.4f} GFLOP, collectives "
        + ", ".join(f"{k} {v} B" for k, v in colls.items())
        + f"; on the card: held {m['held'] / 1e6:.3f} MB, "
        f"{m['temp'] / 1e6:.1f} MB above it, peak {peak / 1e6:.0f} MB "
        f"({ratio:.4f} of the prediction, band {DRYRUN_BYTES_BAND}), gloo "
        f"all-reduce {m['all_reduce']} B, all-gather {m['all_gather']} B, "
        f"FlopCounterMode {m['card_flops'] / 1e9:.4f} GFLOP (relative "
        f"{flop_err:.2e}, tolerance {DRYRUN_FLOP_TOL:g}); {smi}")
    require(abs(m["held"] - p["held_bytes"]) <= 1e6,
            f"[23] {label} held {m['held']} against {p['held_bytes']}")
    require(flop_err <= DRYRUN_FLOP_TOL,
            f"[23] {label} FLOPs off {flop_err:.2e}")
    require(DRYRUN_BYTES_BAND[0] <= ratio <= DRYRUN_BYTES_BAND[1],
            f"[23] {label} peak {peak} against {p['peak_bytes_per_device']}")
    require(m["all_reduce"] == colls.get("all-reduce", 0)
            and m["all_gather"] == colls.get("all-gather", 0),
            f"[23] {label} collective bytes {m['all_reduce']}, "
            f"{m['all_gather']} against {colls}")


def _witness_tols(ws, tag: str, split=()):
    """(m, v) bounds of a TP step's moments from one card's own spread
    ``ws`` (``_ulp_witness``'s moves, a step each) and ``split``
    (``_split_witness``'s): (f)'s bounds, or TP_WITNESS times the larger
    ulp move plus the larger split move (the TP step makes both kinds of
    difference at once), the larger; logged after ``tag``."""
    def top(part):
        return max(w[part] for w in ws) + max(
            (w[part] for w in split), default=0.0)
    m_tol = max(TP_MOMENT_TOL["m"], TP_WITNESS * top("m"))
    v_tol = max(TP_MOMENT_TOL["v"], TP_WITNESS * top("v"))

    def moves(part, group):
        return ", ".join(f"{w[part]:.2e} ({w[part + '_leaf']})"
                         for w in group)
    log(f"  {tag} one card's own spread: its steps with the embedding "
        f"moved by an ulp move m by {moves('m', ws)} and v by "
        f"{moves('v', ws)}"
        + (f"; with the head and log-probs cut into {TP4_RANKS} vocabulary "
           f"slices m by {moves('m', split)} and v by {moves('v', split)}"
           if split else "")
        + " of the leaf's largest; the TP steps' m and v held to "
        f"{TP_WITNESS:g}x the larger" + (" of each, summed" if split else "")
        + f", at least (f)'s: {m_tol:.2e}, {v_tol:.2e}")
    return m_tol, v_tol


def tp_train_report(ranks):
    """[23] (f)-(i) of every rank, printed and held to their bounds."""
    tp_train_checks([res["train"] for res in ranks], "", "[16, 80, 4096]")
    for r, res in enumerate(ranks):
        g = res["g"]
        log(f"  (g) rank {r}: B1 on its slice {g['shape']} (col0 "
            f"{g['col0']}), merged over the ranks, against B1 on the whole "
            f"rows: max|dlogp|/max(1, |logp|) {g['lp_rel']:.3e} (bound "
            f"{TP_LOGPROB_REL:g}); B2 on the slice with the merged stats "
            f"against the whole row's columns: {g['grad_ulps']:.3f} bf16 "
            f"ulps at most (bound 1), with the whole row's stats bit-equal: "
            f"{g['own_stats_equal']}; last position zero: {g['last_zero']}")
        require(g["lp_rel"] <= TP_LOGPROB_REL and g["grad_ulps"] <= 1.0
                and g["own_stats_equal"] and g["last_zero"],
                f"[23] (g) rank {r}: {g}")


def tp_train_checks(trains, tag: str, act: str,
                    m_tol=(TP_MOMENT_TOL["m"],) * TP_TRAIN_STEPS,
                    v_tol=(TP_MOMENT_TOL["v"],) * TP_TRAIN_STEPS):
    """(h), (f) and (i) of each rank's ``tp_train_rank`` results
    ``trains``, printed (each line after ``tag``, the config's label;
    ``act`` the shape of an all-reduced activation) and held to their
    bounds (m and v of step i to ``m_tol[i]`` and ``v_tol[i]`` of a
    leaf's largest)."""
    smi = nvidia_smi()
    for r, tr in enumerate(trains):
        h = tr["h"]
        log(f"  (h){tag} rank {r}: reference scoring on the mesh (its TP "
            f"shard) against the one-card RefPolicyExecutor, "
            f"[{TP_TRAIN_ROWS}, {TP_TRAIN_T}] fp32: max|d ref_logp|/max(1, "
            f"|ref_logp|) {h['err']:.3e} (bound {TP_REF_TOL:g}; "
            f"max|ref_logp| {h['scale']:.2f})")
        require(h["tp"] and h["err"] <= TP_REF_TOL,
                f"[23] (h){tag} rank {r}: {h}")
        h = tr.get("h_pub")
        if h is not None:
            log(f"  (h){tag} rank {r} at the published capacity factor "
                f"{h['cf']:g}: max|d ref_logp|/max(1, |ref_logp|) "
                f"{h['err']:.3e} (bound {TP_REF_TOL:g}); choices dropped "
                f"{h['one'][1]} of {h['one'][0]} on one card, {h['tp'][1]} "
                f"of {h['tp'][0]} by the ranks' own experts, summed")
            require(h["err"] <= TP_REF_TOL and h["one"] == h["tp"]
                    and h["one"][1] > 0, f"[23] (h){tag} rank {r}: {h}")
        for i, f in enumerate(tr["f"]):
            want = tr["one_metrics"][i]
            names = ("loss", "grad_norm", "mean_ratio", "mean_logp",
                     "total_loss") + tuple(
                         k for k in ("mtp_loss", "moe_aux") if k in want)
            worst = max(abs(f["metrics"][k] - want[k]) / max(1.0,
                                                               abs(want[k]))
                        for k in names)
            log(f"  (f){tag} rank {r} step {i + 1} from the one-card state "
                f"before it: metrics ({', '.join(names)}) within "
                f"{worst:.2e} relative (bound {TP_METRIC_TOL:g}; loss "
                f"{f['metrics']['loss']:.6f}, grad_norm "
                f"{f['metrics']['grad_norm']:.6f}); updates: worst "
                f"{f['update_worst']:.3e} of the leaf's largest (bound "
                f"{TP_UPDATE_WORST:g}), {100 * f['update_past']:.3f}% past "
                f"{TP_UPDATE_TOL:g} (bound 1%); m within {f['m']:.2e}, v "
                f"within {f['v']:.2e} of the leaf's largest (bounds "
                f"{m_tol[i]:.2e}, {v_tol[i]:.2e}); the "
                f"{f['m_rms']['n']} elements past {TP_UPDATE_TOL:g}: one-card "
                f"|m| over the leaf's rms |m|, median "
                f"{f['m_rms']['median']:.3g}, largest "
                f"{f['m_rms']['max']:.3g}")
            lv = f["leaves"]
            log("    worst leaves: " + "; ".join(
                f"{key} {k} {lv[k][key]:.3g}" for key in (
                    "worst", "past_1e5", "past", "past_1e3", "m", "v")
                for k in [max(lv, key=lambda n: lv[n][key])]))
            low = sorted((k for k in lv if "below" in lv[k]),
                         key=lambda n: -lv[n]["below"])
            if low:
                log(f"    one-card |gradient| below {TP_G_SIGN:g}, updates "
                    "held to the worst bound alone (the share of the leaf, "
                    "its largest |gradient|, its share past "
                    f"{TP_UPDATE_TOL:g}): " + "; ".join(
                        f"{k} {lv[k]['below']:.3g}, {lv[k]['g_max']:.3g}, "
                        f"{lv[k]['past']:.3g}" for k in low[:4])
                    + (f"; {len(low) - 4} more leaves" if len(low) > 4
                       else ""))
            require(f["step"] == i + 1 and worst <= TP_METRIC_TOL
                    and f["update_worst"] <= TP_UPDATE_WORST
                    and f["update_past"] <= 0.01
                    and f["m"] <= m_tol[i] and f["v"] <= v_tol[i],
                    f"[23] (f){tag} rank {r} step {i + 1}: {f['metrics']}, "
                    f"want {want}")
        log(f"  (f){tag} rank {r}: TP step "
            + ", ".join(f"{t:.1f}" for t in tr["tp_ms"])
            + f" ms (gloo-bound: each all-reduce of {act} fp32 crosses the "
            "host) against the one-card step "
            + ", ".join(f"{t:.1f}" for t in tr["one_ms"])
            + f" ms; launches {tr['launches']}; {smi}")
    i = trains[0]["i"]
    p = i["pred"]
    card = i["card_flops"] + sum(i["own"].values())
    flop_err = abs(card - p["flops_per_device"]) / p["flops_per_device"]
    peak = i["held"] + i["temp"]
    ratio = peak / p["peak_bytes_per_device"]
    colls = p["collectives"]
    log(f"  (i){tag} peak on the card less the prediction: "
        f"{peak - p['peak_bytes_per_device']} B, held less the prediction: "
        f"{i['held'] - p['held_bytes']} B")
    log(f"  (i){tag} dry run of rank 0's TP train step at (f)'s config "
        f"(meta, {p['count_s']} s): held {p['held_bytes'] / 1e6:.0f} MB, "
        f"temp {p['temp_bytes'] / 1e6:.0f} MB (saved activations "
        f"{p['saved_bytes'] / 1e6:.0f} MB), peak "
        f"{p['peak_bytes_per_device'] / 1e6:.0f} MB, "
        f"{p['flops_per_device'] / 1e12:.4f} TFLOP, collectives "
        + ", ".join(f"{k} {v} B" for k, v in colls.items())
        + f"; on the card: held {i['held'] / 1e6:.0f} MB, "
        f"{i['temp'] / 1e6:.0f} MB above it, peak {peak / 1e6:.0f} MB "
        f"({ratio:.3f} of the prediction, band {DRYRUN_BYTES_BAND}), gloo "
        f"all-reduce {i['all_reduce']} B, all-gather {i['all_gather']} B, "
        f"FlopCounterMode {i['card_flops'] / 1e12:.4f} TFLOP + the kernels' "
        "own " + ", ".join(f"{k} {v / 1e9:.3f}" for k, v in i["own"].items())
        + f" GFLOP (relative {flop_err:.2e}, tolerance {DRYRUN_FLOP_TOL:g}); "
        "the count plus the plain attention's forward less the prediction: "
        f"{i['card_flops'] + i['plain_fwd'] - p['flops_per_device']:.0f} "
        f"FLOP; {smi}")
    require(abs(i["held"] - p["held_bytes"]) <= 1e6,
            f"[23] (i){tag} held {i['held']} against {p['held_bytes']}")
    require(flop_err <= DRYRUN_FLOP_TOL,
            f"[23] (i){tag} FLOPs off {flop_err:.2e}")
    require(DRYRUN_BYTES_BAND[0] <= ratio <= DRYRUN_BYTES_BAND[1],
            f"[23] (i){tag} peak {peak} against {p['peak_bytes_per_device']}")
    require(i["all_reduce"] == colls.get("all-reduce")
            and i["all_gather"] == colls.get("all-gather"),
            f"[23] (i){tag} collective bytes {i['all_reduce']}, "
            f"{i['all_gather']} against {colls}")


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: no src/repro_torch beside chip_smoke.py",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    # fp32 tolerances below hold only without TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    if sys.argv[1:] == ["--tp4-vocab"]:
        return tp4_vocab(torch)
    smi = nvidia_smi()
    log(f"[0] device: {smi}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    marks = [time.perf_counter()]

    def mark(label):
        """The seconds since the previous mark, on a line of their own."""
        marks.append(time.perf_counter())
        log(f"  {label}: {marks[-1] - marks[-2]:.1f} s")

    phase_build()
    records = phase_kernels(torch, dev)
    mark("[1]-[2]")
    params, cfg, launches = phase_serve(torch, dev)
    int8_record, int8_launches = phase_int8(torch, dev, params)
    records.append(int8_record)
    phase_long(torch, dev, params, cfg)
    engine_launches = phase_engine(torch, dev, params, cfg)
    del params
    torch.cuda.empty_cache()
    mark("[3], [9], [4], [8]")
    phase_fp32(torch, dev)
    torch.cuda.empty_cache()
    train_launches = phase_train(torch, dev)
    torch.cuda.empty_cache()
    numerics_batch = phase_train_numerics(torch, dev)
    torch.cuda.empty_cache()
    mark("[5]-[7]")
    pool_launches = phase_pool(torch, dev)
    quick_launches, quick_hist = phase_quickstart(torch, dev)
    mark("[10]-[11]")
    proc_launches = phase_proc(torch, dev, quick_hist)
    mark("[12]")
    launch_launches = phase_launch(torch)
    mark("[13]")
    supervise_launches = phase_supervise(torch, dev)
    mark("[14]")
    gc.collect()
    torch.cuda.empty_cache()
    windowed_launches = phase_windowed(torch, dev)
    mark("[15]")
    gc.collect()
    torch.cuda.empty_cache()
    moe_launches = phase_moe(torch, dev)
    mark("[16]")
    gc.collect()
    torch.cuda.empty_cache()
    mla_launches = phase_mla(torch, dev)
    mark("[17]")
    gc.collect()
    torch.cuda.empty_cache()
    vlm_launches = phase_vlm(torch, dev)
    mark("[18]")
    gc.collect()
    torch.cuda.empty_cache()
    hybrid_launches = phase_hybrid(torch, dev)
    mark("[19]")
    gc.collect()
    torch.cuda.empty_cache()
    ssm_launches = phase_xlstm(torch, dev)
    mark("[20]")
    gc.collect()
    torch.cuda.empty_cache()
    audio_launches = phase_audio(torch, dev)
    mark("[21]")
    gc.collect()
    torch.cuda.empty_cache()
    sharded_launches = phase_sharded(torch, dev, numerics_batch)
    mark("[22]")
    gc.collect()
    torch.cuda.empty_cache()
    tp_launches = phase_tp(torch, dev, records)
    mark("[23]")

    stray = sorted(m for m in sys.modules
                   if m.split(".")[0] in ("jax", "repro"))
    require(not stray, f"imported {stray}")
    for r in records:
        by_path = {"serve": launches.get(r["name"], 0),
                   "train": train_launches.get(r["name"], 0),
                   "engine": engine_launches.get(r["name"], 0),
                   "int8": int8_launches.get(r["name"], 0),
                   "pool": pool_launches.get(r["name"], 0),
                   "quickstart": quick_launches.get(r["name"], 0),
                   "proc": proc_launches.get(r["name"], 0),
                   "launch": launch_launches.get(r["name"], 0),
                   "supervise": supervise_launches.get(r["name"], 0),
                   "windowed": windowed_launches.get(r["name"], 0),
                   "moe": moe_launches.get(r["name"], 0),
                   "mla": mla_launches.get(r["name"], 0),
                   "vlm": vlm_launches.get(r["name"], 0),
                   "hybrid": hybrid_launches.get(r["name"], 0),
                   "ssm": ssm_launches.get(r["name"], 0),
                   "audio": audio_launches.get(r["name"], 0),
                   "sharded": sharded_launches.get(r["name"], 0),
                   "tp": tp_launches.get(r["name"], 0)}
        r["launches"] = sum(by_path.values())
        r["launches_by_path"] = by_path
        require(r["launches"] > 0, f"{r['name']} never ran on a main path")
        if r["name"] != "int8_matmul":
            require(by_path["proc"] > 0 and by_path["launch"] > 0,
                    f"{r['name']} never ran in a child process")
            require(by_path["supervise"] > 0,
                    f"{r['name']} never ran in the supervised runs")
            require(by_path["windowed"] > 0,
                    f"{r['name']} never ran on the windowed path")
            require(by_path["moe"] > 0,
                    f"{r['name']} never ran on the MoE path")
        if r["name"] in KERNELS[:3]:
            require(by_path["mla"] > 0,
                    f"{r['name']} never ran on the MLA path")
        if r["name"] in KERNELS[:4]:
            require(by_path["vlm"] > 0 and by_path["hybrid"] > 0
                    and by_path["audio"] > 0,
                    f"{r['name']} never ran on the VLM, hybrid or audio "
                    "path")
        if r["name"] in KERNELS[:3]:
            require(by_path["ssm"] > 0,
                    f"{r['name']} never ran on the SSM path")
        if r["name"] in ("flash_attention", "paged_attention"):
            require(by_path["ssm"] == 0, f"{r['name']} ran on the SSM path")
        if r["name"] == "paged_attention":
            require(by_path["audio"] == 0,
                    "paged_attention ran on the audio path")
        if r["name"] in ("fused_logprob", "fused_logprob_bwd",
                         "flash_attention"):
            require(by_path["sharded"] > 0,
                    f"{r['name']} never ran on the sharded path")
        if r["name"] in KERNELS[:4]:
            require(by_path["tp"] > 0,
                    f"{r['name']} never ran on the tensor-parallel path")
    log(f"  total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": records}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
