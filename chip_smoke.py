#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths (the GPT, MoE,
encoder and vision families, the runtime, Serve, the trainer, the
HTTP front door, batch inference over a Dataset, Tune sweeps and RL) on one
NVIDIA H100 and hold its CUDA kernels against their plain PyTorch
versions.

    python3 chip_smoke.py

Run from the root of a checkout: it builds the port's kernels from
``ray_tpu_torch/csrc/`` with nvcc (into ``ray_tpu_torch/_build/``, one
nvcc per source, all at once) and imports nothing of JAX or of the JAX
package.  Phases, one JSON line each:

  1. device   the card's name and power limit, the kernel builds.
  2. kernel   paged_attention at llama3-8b decode shapes (9 rows, and
              64 rows of 268-1024 positions) and at gptj-6b's against
              paged_attention_ref: error, the share of bf16 outputs that
              differ from the plain version on fp32 copies, and kernel /
              plain / SDPA time beside the least time the card could
              take; the kernel's registers, local memory, blocks per SM
              and shared memory at head_dim 64, 128 and 256.
  3. slice    llama3-8b at full width and depth, random bf16 weights
              from a seed, served by the paged LLMEngine: 16 requests
              from threads; every request's token count, the kernel's
              launch count against n_layers x decode steps, the kernel
              against the plain version on the engine's own pool, and
              a teacher-forced check of the greedy tokens against the
              model's dense prefill path.
     dense_slice  the same model and requests on the dense slot-mode
              engine (the reference's default): two requests stream
              and must yield their results' tokens, every greedy
              request passes the teacher-forced check, the paged
              kernel is never launched; Generator.generate on four of
              the prompts and its agreement with the engine; decode
              tokens/s, TTFT, decode step ms beside the paged slice's.
     prefix_handoff  the same model on the paged engine: 8 requests
              sharing a 256-token prefix hit the prompt-prefix cache
              (teacher-forced, TTFT with the cache and without), and 4
              prefill handoffs exported by one engine decode on a
              second as a colocated submit does (tokens equal).
     runtime  the port's task, actor and object runtime
              (ray_tpu_torch.init): the raylet finds the GPU without
              starting CUDA; a task that leases no GPU sees
              CUDA_VISIBLE_DEVICES="" and no CUDA, and its worker holds
              nothing of JAX or ray_tpu; llama3-8b at full width, depth
              cut to 2, goes into the object store once, and an actor
              with num_gpus=1 takes it, builds the model on the card and
              serves 8 requests on the paged engine: K4 launches
              n_layers x decode steps there, and the greedy tokens pass
              the teacher-forced check on the driver's copy; put and get
              GB/s, where the store's segment lies, the actor's start
              (fork, CUDA, weights on the card), its decode tokens/s
              beside the same requests on an engine in the driver; no
              process of the runtime is left after shutdown().
     serve    Serve and LLMServer on the port's runtime, in a session of
              its own: llama3-8b at full width and depth on one replica
              leasing the card (build_app, num_gpus=1, the slice
              phase's engine settings) serves 16 requests through a
              DeploymentHandle, two of them streamed; every request
              completes, K4 launches n_layers x decode steps in the
              replica (a subclass of LLMServer with one read-only
              method reads its count), the engine holds bf16 weights
              and the fp32 ones are gone, and after serve.shutdown()
              the greedy tokens pass the teacher-forced check on a copy
              the driver builds through LLMServer._load_params; then a
              disaggregated prefill / decode pair at depth 2 on two
              half-card replicas serves 8 streams through
              disagg_handle: the pools' prefill, export, import and
              step counts, K4 only in the decode replica, the handoffs'
              bytes on the timeline, the teacher-forced check; replica
              start (CUDA, fp32 init, cast, warmup), TTFT, decode
              tokens/s, memory; no process is left after shutdown().
  4. flash    the flash kernels K1 (forward), K2 (dQ) and K3 (dK, dV)
              against their plain versions at gpt-small training shapes
              (16 x 1024, 12 heads of 64, causal, bf16), at gptj-6b's
              (2 x 1024, 16 heads of 256), at ViT-B/16's (128 x 196,
              non-causal), gpt-large's and mixtral's (all timed), at
              BERT's (16 x 512, non-causal), T5's cross-attention (16 x
              q 128 over kv 512, non-causal) and T5's decoder (16 x 128,
              causal), at a GQA 32/8 head_dim-128
              shape, at head_dim-256 GQA / ragged / full shapes, fp32 at
              head_dim 256 (all three kernels, timed), at
              fp32 / full / ragged shapes, with
              the Decision Transformer's [64, 60, 4, 32] causal in fp32
              and in bf16 (timed), q, k and v as strided views of one fused [B, S, H + 2 KVH,
              D] tensor, at S = 64 (one tile) and at 1 x 4096 (a long
              ring of kv tiles), and with rows whose logits all lie far
              below the exponent's range; kernel / plain / SDPA time
              beside the bound, each kernel's TFLOP/s, registers, local
              memory (spills) and blocks per SM at head_dim 64, 128 and
              256, the backward's sum beside SDPA's backward; the share
              of bf16 o, dQ, dK and dV elements that differ from the
              plain versions at all.
  5. splash   the splash kernels K5-fwd, K5-dQ and K5-dKV in the same
              way at the same training shapes, at GQA 32/8 head_dim 128
              (2 x 2048), with a full mask (q 512, kv 1024), in fp32,
              from a fused tensor, at S = 128 (the library's shortest
              length), at 1 x 4096, with rows of very low logits, at
              head_dim 256 and at head_dim 32 (DT's batch and heads at
              S = 128, fp32 and bf16, timed; DT's 60 tokens raise the
              library's block-rule ValueError); the tiles the mask table
              visits against the dense count.
  6. train    gpt-small at full width and depth with bench.py's
              settings (batch 16 x 1024, remat "dots", AdamW warmup 10 /
              decay 1000, attention_impl "flash"), random weights from
              the seed and a fixed batch: one step with the plain
              attention and one with the kernels from the same weights
              must agree; then 20 kernel steps, whose losses must be
              finite and fall, and whose launch counts must equal the
              config's (remat recomputes the forward) while the splash
              counters stay at 0; step ms, tokens/s, MFU, peak memory,
              and device time by kernel group.
     air      the AIR path on the port's runtime, in a session of its
              own: (a) JaxTrainer trains gpt-small at full width and
              depth with the train phase's settings, seed and batch in a
              worker leasing the card, 20 steps reported through
              session.report with the worker's own kernel launches
              (24 / 12 / 12 K1 / K2 / K3 per step, K4 and K5 at 0), the
              first loss against the train phase's first kernel step,
              the losses falling, fp32 torch checkpoints at steps 7, 14
              and 20 of which CheckpointConfig(num_to_keep=2) keeps the
              last two; (b) LLMServer serves the step-20 checkpoint
              behind the HTTP proxy (serve.run with HTTPOptions): 8 SSE
              streams and 2 JSON requests from threads, /-/healthz and
              /-/echo, one stream the client closes halfway (the
              replica's busy slots return to 0), one request to a
              deployment that does not exist (a 500 with the JSON error
              shape); each stream's tokens match its done event, K4
              launches n_layers x decode steps in the replica, the
              greedy tokens pass the teacher-forced check on a copy the
              driver loads from the checkpoint; client-side TTFT and
              decode tokens/s beside the serve phase's; (c) two workers
              on half the card each train gpt-small at depth 2 (batch
              8 x 1024 per rank, 5 steps), their gradients averaged by
              sync_gradients on the host collective: the ranks'
              parameters bitwise equal after every step, 4 / 2 / 2
              K1 / K2 / K3 per step on each rank, the grad_allreduce ms
              per step; no process is left after shutdown().
     air_batch  batch inference and a sweep on the port's runtime, in a
              session of its own: (a) ViT-B/16 at full size, random
              weights from the seed in a directory checkpoint
              (predictor_checkpoint), scores 4096 random 224 px images
              (from_numpy, 16 blocks of 256; a BatchMapper scales them
              to fp32 in [0, 1]) through BatchPredictor.predict in two
              actors on half the card each: every row comes back, K1
              launches 12 x 16 times in the actors at [256, 196, 12,
              64] non-causal and no other kernel launches, the first
              256 rows' logits equal the driver's forward on the same
              images, and a scoring actor that leases no card raises;
              images/s beside the driver's, each actor's start (fork,
              CUDA, weights) and its stream busy share; (b) Tuner runs
              JaxTrainer on gpt-small at depth 2 once for each of four
              learning rates under ASHA (grace 2, reduction 2, max_t 8),
              two trials at a time on half the card each, reading batch
              8 x 1024 from a Dataset shard: 4 / 2 / 2 K1 / K2 / K3 per
              step in every trial's worker, every first loss equal to
              the driver's make_train step, two trials overlapping and
              never three, the later trials starting once ASHA freed a
              half card, the best trial's checkpoint reproducing its
              loss in the driver; no process is left after shutdown().
     rl       RL on the port's runtime, in a session of its own: (a)
              PPO on CartPole-v1 at benchmarks/rl_perf.py's settings (2
              rollout actors x 4 envs, fragment 125, batch 1000,
              minibatch 250, 8 SGD iterations, lr 3e-4, entropy 0.01,
              seed 0) with the learner on the card: episode_reward_mean
              reaches 150 within 100,000 env steps, the first minibatch
              step equals the same step on CPU copies (fp32, TF32 off),
              the actors lease no GPU, start no CUDA and hold nothing of
              JAX, save then restore gives the state back bit for bit,
              no attention kernel launches; env steps to 150, wall,
              sample and SGD ms per iteration; (b) IMPALA at the same
              file's CartPole settings for 10 train() calls: every loss
              finite, V-trace on the card equal to the CPU's on a
              recorded fragment, env steps/s; (c) the Decision
              Transformer at DTConfig's widths (d_model 128, 3 layers, 4
              heads of 32, 60 tokens, batch 64, fp32) on a dataset that
              collect_dataset writes and JsonReader reads back: the
              first loss through K1-K3 equal to the plain attention's
              from the same weights, K1, K2 and K3 n_layers times per
              SGD step (K1 also n_layers per evaluate() forward), K4
              and K5 never, the loss falling over two train() calls,
              evaluate() finite; no process is left after shutdown().
     rl_replay  the replay and asynchronous families on the runtime, in
              a session of their own, each at its config's widths: (a)
              DQN (256 x 256, dueling, double-Q, Adam 5e-4; 2 actors x 2
              envs, fragment 64) reaches episode_reward_mean 150 within
              100,000 env steps, its first TD step equals the same step
              on CPU copies, its target holds still between syncs; (b)
              Ape-X (4 actors, PER) for 10 calls: the epsilon ladder,
              priorities that move, finite losses, the cost of the
              per-step priority fetch; (c) R2D2 (LSTM 64, sequences of
              40, burn-in 8) with its first TD step against the CPU and
              steps trained; (d) APPO with its first step against the
              CPU and mean_ratio > 0; (e) IMPALA and PPO through
              .podracer() at benchmarks/rl_podracer.py's fleet, the
              learner actor on a leased card: zero driver task
              submissions in steady state, every actor adopting a
              published version, a killed actor replaced, a bit-equal
              save / restore; (f) Tuner(PPO.as_trainable(cfg)) over two
              learning rates on half-card trials, each reporting 3
              iterations and a checkpoint.  Rollout actors start no
              CUDA, no attention kernel launches, and no process is
              left after shutdown().
     rl_continuous  the continuous-control, actor-critic and offline
              families on the runtime, in a session of their own, at
              their configs' widths (256 x 256): (a) SAC on Pendulum-v1
              with tests/test_rl.py's settings for 44 calls, the best of
              the last 8 episode_reward_mean 250 above the first, alpha
              > 0; (b) DDPG and TD3 for 8 calls, TD3's actor, its Adam
              state and target actor bit-equal across skipped steps;
              (c) PG, A2C and A3C on CartPole-v1 (A3C: 3 calls of 8
              fragments, each worker holding the weights pushed to it);
              (d) CQL and CRR on a 10,000-step dataset for 3 calls,
              cql_loss and mean_weight > 0, a save after call 1 restored
              bit for bit.  Every first update (TD3's first two) equals
              the same update on CPU copies of the state, the batch and
              the recorded noise within 1e-5 and its card replay bit for
              bit; update ms (median, p90), env steps/s, walls; no
              attention kernel launches; no process left.
  7. splash_train  the same run with attention_impl "splash": its first
              step against one flash step from the same weights, then
              20 steps through K5 while the flash counters stay at 0.
     lean_train  bench.py's memory-lean run: gpt-large (36 layers,
              1.07 B parameters) at full width and depth, remat
              "nothing", the chunked CE head over parameters cast to
              bf16 once per step, Adafactor, batch 10 x 1024: the train
              phase's gates, 72 / 36 / 36 kernel launches per step, the
              optimizer state within 1 KB of JAX's bytes; then 3 steps
              without the hoisted cast.
  8. gptj     gptj-6b (16 heads of 256) at full width, depth cut to 2:
              the train runs of phases 6 and 7 at batch 2 x 1024 for 3
              steps each, and the engine of phase 3 serving 4 requests.
  9. moe_slice  mixtral-8x7b (8 experts of 14336, top-2, GQA 32/8) at
              full width, depth cut to 8, random bf16 weights from the
              seed, served by the paged engine and then the dense one
              with the slice phase's settings and requests: every
              request completes, K4 launches n_layers x decode steps
              (paged) and 0 times (dense), and every greedy request
              passes a teacher-forced check that prefills the prompt
              padded as the engine pads it, then feeds the tokens one at
              a time; decode tokens/s, TTFT, decode step ms (device ms
              with the experts' GEMMs apart), peak memory, and the share
              of (token, choice) pairs the prefills dropped.
 10. moe_train  mixtral-8x7b at full width, depth cut to 2: Adafactor,
              remat "dots", batch 8 x 1024 through K1-K3 for 5 steps
              under the train phase's gates (the MoE aux loss finite and
              positive), the optimizer state within 1 KB of JAX's; MFU
              from the active parameters (attention, top-2 experts,
              router, head).
 11. vision_train  make_vision_train at full width, random weights and
              a fixed batch from the seed: ViT-B/16 (224 px, 1000
              classes, batch 128, AdamW), its first step through the
              plain attention against one through the kernels from the
              same weights, then 10 kernel steps under the train phase's
              gates (12 K1, K2 and K3 launches per step, every other
              kernel at 0); ResNet-50 at benchmarks/vision_perf.py's two
              settings (32 px / 10 classes, batch 1024; 224 px / 1000
              classes, batch 256) for 10 steps each, no kernel launched,
              the BatchNorm statistics finite and moved; img/s, step ms,
              peak memory, device time by group (GEMMs and convolutions,
              attention, the optimizer, the rest).
 12. encoder_train  BERT and T5 at gpt-small's widths (remat "dots"),
              through make_train with mlm_loss_fn (batch 16 x 512,
              masked_batch corruption) and seq2seq_loss_fn (encoder 512,
              decoder 128, batch 16) under the same gates; K1-K3 calls
              by shape, so T5's cross-attention (q 128 over kv 512) shows;
              a BERT forward with a padding mask launches no kernel; T5's
              greedy_decode of 32 tokens on 4 prompts, from fresh random
              weights whose query and key projections are scaled by 3,
              equals a teacher-forced forward's argmax token for token,
              and every row holds more than one distinct token.
 13. loss     chunked_lm_loss on bf16 tensors of the card against the
              same call on the CPU.
 14. kernels  one line listing every kernel of the port, with its
              launches on each training and serving path.

The last line is ``{"ok": true, "device": {...}}``.  Without a CUDA
device, or outside a checkout, it exits non-zero and prints no result.
Full results also go to ``chiprun_out/chip_smoke.json``.

    python3 chip_smoke.py --ab DIR [DIR ...]

times the paged kernel of each checkout at DIR (for example the parent
commit, unpacked with ``git archive``; its kernel and its wrapper) against
this checkout's, in turns (each DIR, this twice, each DIR in reverse) at
the kernel phase's three timed shapes, and writes
``chiprun_out/paged_ab.json``.
"""

from __future__ import annotations

import asyncio
import json
import math
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
RUN_T0 = time.perf_counter()     # the run's start, for its wall
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and dense bf16 flop/s
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
# Kernel and plain version both accumulate in fp32 and round the output
# to bf16 (2^-8 relative); the plain version also rounds the softmax
# probabilities to bf16 before P.V.  2e-2 is ~5x that rounding.
ATOL = RTOL = 2e-2
# The paged kernel keeps _tpu_kernel's fp32 arithmetic (P to ~16 bits as
# two bf16 terms), so at most this share of its bf16 outputs may differ
# from the plain version computed on fp32 copies of its inputs.  The plain
# version on the bf16 tensors rounds P to bf16, as paged_attention_xla
# does, and differs from that in far more (checked at the timed shapes).
PAGED_BF16_DIFFERING = 0.01
# teacher-forced check: the greedy token's logit under the dense prefill
# path must sit within GAP_TOL of that path's best logit (a wrong kernel
# picks tokens ~4.5 logit std below the best), and at least AGREE of the
# tokens must be that path's argmax (bf16 rounding may flip near-ties)
GAP_TOL = 1.0
AGREE = 0.75
KERNEL_SOURCE = "ray_tpu_torch/csrc/paged_attention.cu"
KERNEL_REPLACES = "ray_tpu/ops/paged_attention.py:74"
FLASH_SOURCE = "ray_tpu_torch/csrc/flash_attention.cu"
FLASH_REPLACES = {"flash_fwd": "ray_tpu/ops/flash_attention.py:49",
                  "flash_bwd_dq": "ray_tpu/ops/flash_attention.py:127",
                  "flash_bwd_dkv": "ray_tpu/ops/flash_attention.py:167"}
SPLASH_SOURCE = "ray_tpu_torch/csrc/splash_attention.cu"
_SPLASH_LIB = ("jax/experimental/pallas/ops/tpu/splash_attention/"
               "splash_attention_kernel.py")
SPLASH_REPLACES = {
    "splash_fwd": f"ray_tpu/ops/splash.py:19 -> {_SPLASH_LIB}:696 "
                  "flash_attention_kernel",
    "splash_bwd_dq": f"ray_tpu/ops/splash.py:19 -> {_SPLASH_LIB}:1307 "
                     "_flash_attention_dq_kernel",
    "splash_bwd_dkv": f"ray_tpu/ops/splash.py:19 -> {_SPLASH_LIB}:1669 "
                      "_flash_attention_dkv_kernel"}
# float32 outside the tensor cores (the flash kernels' fp32 inputs)
FP32_FLOPS = 67e12
# The bf16 forwards (tensor-core K1 and K5-fwd) against their plain
# versions: both sum in fp32 and round o to bf16, so they may differ by
# one bf16 ulp where the two fp32 values straddle a rounding boundary:
# at most 2^-7 = 0.0078125 for |o| < 2, and one ulp of the element
# (2^-6 in [2, 4)) above.  The split P.V keeps P to ~16 bits, so the
# fp32 values agree to ~1e-5 relative and a flip at |o| >= 2 is rare; it
# does occur where a row's softmax sits on one key of |v| >= 2 (the
# low-logit case at head_dim 256).
FWD_BF16_MAX_ERR = 2.0 ** -7
# ... and at most this share of the bf16 o elements may differ from the
# plain version at all (the CPU tests' SPLIT_DIFFERING): a forward that
# keeps P to ~16 bits differs in ~0.2-0.3% of them, one that rounds P to
# bf16 before P.V in ~40%.  At the training shape the script checks that
# such a forward (emulated in plain torch) fails this gate.
FWD_BF16_DIFFERING = 0.01
# The bf16 tensor-core K3 against its plain version: the reference keeps
# P and dS in fp32 for P^T.dO and dS^T.q, and the kernel splits each into
# hi + lo bf16 terms (~16 bits), so at most this share of the bf16 dK and
# dV elements may differ at all.  A CPU estimate at [1, 1024, 4, 64] bf16
# causal (seed 0, against a float64 reference rounded to bf16): 0.24% of
# dK and dV differ with the split, 41.7% with P and dS rounded to bf16
# alone (max abs error 0.0156, inside ATOL: only this gate can tell).  At
# the training shape the script checks that such a K3 (emulated in plain
# torch) fails this gate.  The same gate holds bf16 K2's dQ: its reference
# keeps dS in fp32 for dS.K and the kernel splits dS into hi + lo; a K2
# with dS rounded to bf16 (emulated at the training shape) must fail it.
# K5-dQ rounds dS as the library does: its share is reported.  Causal row
# 0 of dQ is left out of both shares: it sees key 0 alone, where P = 1 and
# dP - delta is the rounding residue of dO.v0 - rowsum(dO o O) (~1e-8),
# noise in every version (1/64 of the elements at S = 64).  So are, in
# the low-logit cases, the low rows (every 7th): their logits and LSE lie
# near -190 (head_dim 64) to -380 (256), where fp32 rounds each by
# ~1e-5, so their P = exp(s - LSE) differs between any two versions by
# that much relative; their share is reported.
BWD_BF16_DIFFERING = 0.01
# Flash kernels against their plain versions: both sum in fp32.  In bf16
# both round the outputs to bf16 (2^-8 relative), so ATOL = RTOL = 2e-2
# as for paged attention.  In fp32 the gap is summation order over
# <= 2048 keys, ~1e-6; 1e-4 leaves headroom.
FLASH_FP32_TOL = 1e-4
# The plain and the kernel train step round at different places in bf16
# (the plain attention rounds P to bf16 before P.V, the kernel keeps it
# in fp32), through 12 layers: the first loss within 2e-3 relative and
# the gradient norm within 3e-2.  A wrong kernel moves the gradient norm
# by far more (the attention's gradients would be wrong in every layer).
LOSS_RTOL = 2e-3
GRAD_NORM_RTOL = 3e-2
TRAIN_STEPS = 20
# gptj-6b (16 heads of 256) at full width: 2 of its 28 layers (950 M
# parameters) keep the fp32 masters, grads and AdamW state near 15 GB
# and the phase short
GPTJ_LAYERS = 2
GPTJ_STEPS = 3
# The Adafactor state of bench.py's memory-lean gpt-large run, as JAX
# counts it (jax.eval_shape of OptimizerConfig(optimizer="adafactor")
# .make().init over gpt-large's parameter tree; a few bytes of it are
# optax placeholders); tests/test_torch_train.py pins the same number
ADAFACTOR_STATE_BYTES = 711_708_752
# mixtral-8x7b at full width: serving keeps 8 of its 32 layers (11.87 B
# parameters, 23.7 GB in bf16; all 32 are 93 GB), training 2 (3.16 B
# fp32 parameters, 12.7 GB, as much again for the gradients, and 3.8 GB
# for each temporary of Adafactor's update of a [2, 8, 4096, 14336]
# expert stack)
MOE_SERVE_LAYERS = 8
MOE_TRAIN_LAYERS = 2
MOE_TRAIN_STEPS = 5
# The Adafactor state of the moe_train run as JAX counts it (jax.eval_shape
# of OptimizerConfig(optimizer="adafactor").make().init over mixtral-8x7b's
# tree at depth 2, max_seq_len 1024, remat "dots"); tests/test_torch_moe.py
# pins the same number
MIXTRAL_ADAFACTOR_STATE_BYTES = 5_859_404


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def time_ms(fn, arg_sets, reps: int = 10) -> tuple:
    """(device ms, host ms) per call over ``arg_sets``.

    Host ms: wall time of one synchronised pass, so it holds the host's
    Python and launch cost.  Device ms: ``reps`` passes timed with CUDA
    events.  A spin kernel keeps the card busy while the host queues
    every call, so the events time the calls back to back and not the
    host's overhead.  Cycling through input copies larger than the 50 MB
    L2 cache makes every call find its inputs cold, as a decode step
    finds a layer's pool."""
    import torch
    for a in arg_sets:
        fn(*a)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for a in arg_sets:
        fn(*a)
    torch.cuda.synchronize()
    host_s = (time.perf_counter() - t0) * reps
    host_ms = host_s * 1e3 / (reps * len(arg_sets))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # spin at least twice the host's queueing time (at up to 2 GHz)
    torch.cuda._sleep(int(4e9 * host_s) + 1000)
    start.record()
    for _ in range(reps):
        for a in arg_sets:
            fn(*a)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * len(arg_sets)), host_ms


def paged_bound(q, kv_pages, lengths, block_tables) -> dict:
    """Least time for one paged decode attention call: the K|V bytes of
    each row's valid positions, q, the output, tables and lengths, each
    moved once, over HBM bandwidth; against 4*hd flops per (query head,
    position) over the bf16 tensor rate."""
    rows, heads, hd = q.shape
    _, kvh, ps, _ = kv_pages.shape
    total = int(lengths.sum())
    esize = kv_pages.element_size()
    nbytes = (total * kvh * 2 * hd * esize + 2 * q.numel() * esize
              + block_tables.numel() * 4 + lengths.numel() * 4)
    pages = int(((lengths + ps - 1) // ps).sum())
    page_bytes = pages * kvh * ps * 2 * hd * esize
    flops = 4 * total * heads * hd
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / BF16_FLOPS * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bytes": nbytes, "flops": flops,
            "occupied_page_bytes": page_bytes,
            "occupied_page_bound_ms": page_bytes / HBM_BYTES_PER_S * 1e3}


def tc_usage(family: str) -> dict:
    """{"fwd" | "bwd_dq" | "bwd_dkv": {head_dim: {"registers",
    "local_bytes", "blocks_per_sm"}}} of the tensor-core forward, dQ and
    dK/dV kernels of ``family`` ("flash" or "splash") at head_dim 64, 128
    and 256 (and 32 for flash), as the CUDA runtime reports them:
    registers and local memory (spills and stack) per thread, and
    resident blocks per SM."""
    import ctypes
    from ray_tpu_torch.ops import flash_attention, splash
    lib = (flash_attention if family == "flash" else splash)._lib()
    hds = (32, 64, 128, 256) if family == "flash" else (64, 128, 256)
    out = {}
    for kind, sym in (("fwd", "fwd"), ("bwd_dq", "dq"), ("bwd_dkv", "dkv")):
        out[kind] = {}
        for hd in hds:
            u = (ctypes.c_int * 3)()
            err = getattr(lib, f"rt_{family}_{sym}_usage")(hd, u)
            check(err == 0, f"{family} {kind} usage query: cudaError {err}")
            out[kind][str(hd)] = dict(zip(("registers", "local_bytes",
                                           "blocks_per_sm"), u))
    return out


def compare(got, want, atol: float = ATOL, rtol: float = RTOL) -> dict:
    import torch
    g, w = got.float(), want.float()
    err = (g - w).abs()
    ok = bool(torch.all(err <= atol + rtol * w.abs()))
    return {"max_abs_err": float(err.max()),
            "max_rel_err": float((err / w.abs().clamp_min(1e-3)).max()),
            "max_abs_want": float(w.abs().max()),
            "frac_differing": float((err > 0).float().mean()),
            "finite": bool(torch.isfinite(g).all()), "within_tol": ok}


def paged_check(got, q, kv, tables, lengths, where: str) -> dict:
    """The paged kernel's output ``got`` against the plain version: within
    ATOL / RTOL of it on the bf16 tensors, and at most PAGED_BF16_DIFFERING
    of its elements different from it on fp32 copies (rounded to bf16);
    beside that share, the bf16 plain version's (P rounded to bf16)."""
    import torch
    from ray_tpu_torch.ops.paged_attention import paged_attention_ref
    ref = paged_attention_ref(q, kv, tables, lengths)
    fp32 = paged_attention_ref(q.float(), kv.float(), tables, lengths)
    res = compare(got, ref)
    r32 = fp32.to(torch.bfloat16)
    res.update(max_abs_err_vs_fp32=float((got.float() - fp32).abs().max()),
               frac_differing_fp32=float((got != r32).float().mean()),
               bf16_p_frac_differing_fp32=float((ref != r32).float().mean()))
    check(res["finite"] and res["within_tol"],
          f"paged kernel disagrees with the plain version {where}: {res}")
    check(res["frac_differing_fp32"] <= PAGED_BF16_DIFFERING,
          f"paged kernel differs from the fp32 plain version in "
          f"{res['frac_differing_fp32']} of its outputs {where}, over "
          f"{PAGED_BF16_DIFFERING}: {res}")
    return res


def paged_usage() -> dict:
    """{head_dim: {"registers", "local_bytes", "blocks_per_sm",
    "smem_bytes"}} of the paged kernel, as the CUDA runtime reports them."""
    import ctypes
    from ray_tpu_torch.ops import paged_attention
    lib = paged_attention._lib()
    out = {}
    for hd in (64, 128, 256):
        u = (ctypes.c_int * 4)()
        err = lib.rt_paged_attention_usage(hd, u)
        check(err == 0, f"paged usage query: cudaError {err}")
        out[str(hd)] = dict(zip(("registers", "local_bytes",
                                 "blocks_per_sm", "smem_bytes"), u))
    return out


def coverage(dev, gen) -> list:
    """The kernel against the plain version at the other shapes it takes
    (head_dim 64, 128 and 256, GQA groups 1, 4, 8, 16 and 32, pages of 1,
    16, 24, 32, 64 and 128 positions, head_dim 256 with 128-token pages,
    rows split over several blocks and not), random lengths >= 1."""
    import torch
    from ray_tpu_torch.ops.paged_attention import paged_attention_cuda
    out = []
    for rows, heads, kvh, hd, ps, max_pages in (
            (5, 12, 12, 64, 16, 8), (3, 32, 4, 128, 128, 4),
            (64, 8, 1, 64, 32, 6), (40, 32, 8, 128, 64, 16),
            (3, 8, 2, 256, 16, 8), (6, 16, 4, 256, 32, 6),
            (3, 16, 2, 256, 128, 4), (4, 16, 1, 64, 24, 6),
            (3, 64, 2, 128, 64, 4), (2, 8, 2, 128, 1, 200)):
        num_pages = 1 + rows * max_pages
        perm = torch.randperm(num_pages - 1, generator=gen, device=dev) + 1
        tables = perm.reshape(rows, max_pages).to(torch.int32)
        lengths = torch.randint(1, max_pages * ps + 1, (rows,),
                                generator=gen, device=dev,
                                dtype=torch.int32)
        q = torch.randn(rows, heads, hd, generator=gen, device=dev
                        ).to(torch.bfloat16)
        kv = torch.randn(num_pages, kvh, ps, 2 * hd, generator=gen,
                         device=dev).to(torch.bfloat16)
        shape = [rows, heads, kvh, hd, ps, max_pages]
        c = paged_check(paged_attention_cuda(q, kv, tables, lengths), q, kv,
                        tables, lengths, f"at {shape}")
        c["shape"] = shape
        out.append(c)
    return out


def paged_sets(dev, gen, rows: int, heads: int, kvh: int, hd: int,
               ps: int, max_pages: int, lengths_l: list,
               n_sets: int = 8) -> list:
    """n_sets argument sets (q, pool, tables, lengths) of one decode shape:
    the given lengths on shuffled pages, a pool copy per set so that timed
    calls do not hit in L2 (38 MB each at llama3-8b's 9-row shape)."""
    import torch
    num_pages = 1 + rows * max_pages
    perm = torch.randperm(num_pages - 1, generator=gen, device=dev) + 1
    tables = torch.zeros(rows, max_pages, dtype=torch.int32, device=dev)
    used = 0
    for r, n in enumerate(lengths_l):
        np_ = -(-n // ps)
        tables[r, :np_] = perm[used:used + np_].to(torch.int32)
        used += np_
    lengths = torch.tensor(lengths_l, dtype=torch.int32, device=dev)
    sets = []
    for _ in range(n_sets):
        q = torch.randn(rows, heads, hd, generator=gen, device=dev
                        ).to(torch.bfloat16)
        kv = torch.randn(num_pages, kvh, ps, 2 * hd, generator=gen,
                         device=dev).to(torch.bfloat16)
        sets.append((q, kv, tables, lengths))
    return sets


def paged_timed(dev, gen, rows: int, heads: int, kvh: int, hd: int,
                ps: int, max_pages: int, lengths_l: list) -> dict:
    """paged_attention on one decode shape, shuffled pages and the given
    lengths: the kernel against the plain version (paged_check; the bf16
    plain version's own share must exceed the gate), kernel / plain / SDPA
    time beside the bound."""
    import torch
    import torch.nn.functional as F
    from ray_tpu_torch.ops.paged_attention import (paged_attention_cuda,
                                                   paged_attention_ref)
    sets = paged_sets(dev, gen, rows, heads, kvh, hd, ps, max_pages,
                      lengths_l)
    q, kv, tables, lengths = sets[0]
    got = paged_attention_cuda(q, kv, tables, lengths)
    torch.cuda.synchronize()
    shape = [rows, heads, kvh, hd, ps, max_pages]
    res = paged_check(got, q, kv, tables, lengths, f"at {shape}")
    check(res["bf16_p_frac_differing_fp32"] > PAGED_BF16_DIFFERING,
          f"the plain version with P in bf16 differs in only "
          f"{res['bf16_p_frac_differing_fp32']} of its outputs at {shape}, "
          f"within the {PAGED_BF16_DIFFERING} gate that should catch it")
    fp32 = paged_attention_ref(q.float(), kv.float(), tables, lengths)
    torch.cuda.empty_cache()

    span = max_pages * ps
    mask = (torch.arange(span, device=dev)[None, :] < lengths[:, None]
            )[:, None, None, :]

    def gathered(q, kv):
        g = kv[tables.long()].movedim(2, 3).reshape(rows, span, kvh, 2 * hd)
        return (q[:, :, None], g[..., :hd].transpose(1, 2).contiguous(),
                g[..., hd:].transpose(1, 2).contiguous())

    sdpa_sets = [gathered(q_, kv_) for q_, kv_, _, _ in sets]

    def sdpa(q, k, v):
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                              enable_gqa=True)
    lib_out = sdpa(*sdpa_sets[0])[:, :, 0]
    res["library_max_abs_err"] = float((lib_out.float() - fp32).abs().max())
    kernel_ms, kernel_host_ms = time_ms(paged_attention_cuda, sets)
    res.update(
        kernel_ms=kernel_ms, kernel_host_ms=kernel_host_ms,
        ref_ms=time_ms(paged_attention_ref, sets, reps=3)[0],
        library_ms=time_ms(sdpa, sdpa_sets)[0],
        library_note="SDPA over the pre-gathered span; gather not timed",
        shapes=dict(rows=rows, heads=heads, kv_heads=kvh, head_dim=hd,
                    page_size=ps, max_pages=max_pages, lengths=lengths_l),
        **paged_bound(q, kv, lengths, tables))
    res["bound_share"] = res["bound_ms"] / kernel_ms
    del sets, sdpa_sets
    torch.cuda.empty_cache()
    return res


# The kernel phase's timed shapes: (label, paged_timed's shape arguments)
PAGED_TIMED = (
    # llama3-8b decode: 8 slots + the scratch row, 32 heads over 8 kv
    # heads of 128, 64-token pages, 16-page tables (max_seq_len 1024),
    # lengths at page edges
    ("llama3-8b", (9, 32, 8, 128, 64, 16,
                   [1, 63, 64, 65, 300, 1024, 511, 129, 700])),
    # the same model with the engine full: 64 rows of 268-1024 positions
    ("rows64", (64, 32, 8, 128, 64, 16, [1024 - 12 * r for r in range(64)])),
    # gptj-6b decode: 4 slots + the scratch row, 16 heads of 256, no GQA
    ("hd256", (5, 16, 16, 256, 64, 16, [1, 65, 300, 1024, 700])),
)


def kernel_phase(dev) -> dict:
    """paged_attention at the PAGED_TIMED shapes (llama3-8b's first, at
    the top level) and at the coverage shapes; the kernel's usage."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(SEED)
    res = paged_timed(dev, gen, *PAGED_TIMED[0][1])
    for label, args in PAGED_TIMED[1:]:
        res[label] = paged_timed(dev, gen, *args)
    res["coverage"] = coverage(dev, gen)
    res["usage"] = paged_usage()
    return res


def paged_ab(dev, others: list) -> dict:
    """The paged kernels of the checkouts at ``others`` (each one's
    csrc/paged_attention.cu, built here, and its wrapper) against this
    checkout's at the PAGED_TIMED shapes: outputs within ATOL of this
    one's, device ms of each in turns (the others, this twice, the others
    in reverse)."""
    import ctypes
    import importlib.util
    import torch
    from ray_tpu_torch.ops import _build, paged_attention
    fns = {}
    for i, other in enumerate(others):
        so = _build.BUILD_DIR / "ab" / f"libpaged_attention_{i}.so"
        so.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
             str(other / "ray_tpu_torch/csrc/paged_attention.cu")],
            check=True, capture_output=True)
        spec = importlib.util.spec_from_file_location(
            f"paged_attention_{i}",
            other / "ray_tpu_torch/ops/paged_attention.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        lib = ctypes.CDLL(str(so))
        # the other wrapper's _lib types the library it is handed
        saved = _build._loaded.get("paged_attention")
        _build._loaded["paged_attention"] = lib
        try:
            mod._lib()
        finally:
            if saved is None:
                del _build._loaded["paged_attention"]
            else:
                _build._loaded["paged_attention"] = saved
        mod._lib = lambda lib=lib: lib
        fns[str(other)] = mod.paged_attention_cuda
    names = list(fns)
    fns["this"] = paged_attention.paged_attention_cuda
    gen = torch.Generator(device=dev).manual_seed(SEED)
    out = {}
    for label, args in PAGED_TIMED:
        sets = paged_sets(dev, gen, *args)
        want = fns["this"](*sets[0])
        res = {"ms": {name: [] for name in fns}, "vs_this": {}}
        for name in names:
            c = res["vs_this"][name] = compare(fns[name](*sets[0]), want)
            check(c["finite"] and c["within_tol"],
                  f"the paged kernel of {name} disagrees with this one's "
                  f"at {label}: {c}")
        for name in names + ["this", "this"] + names[::-1]:
            res["ms"][name].append(time_ms(fns[name], sets)[0])
        q, kv, tables, lengths = sets[0]
        out[label] = {**res, **paged_bound(q, kv, lengths, tables)}
        del sets
        torch.cuda.empty_cache()
    return out


def make_requests(vocab: int, n: int = 16, new: tuple = (32, 64)):
    """n requests from the seed: prompts of 17-300 tokens (the first two
    17 and 300), new-token counts in [new[0], new[1]], request 5 (if any)
    sampled at temperature 0.8 and the rest greedy."""
    import numpy as np
    rng = np.random.default_rng(SEED)
    lens = rng.integers(17, 301, size=n)
    lens[0], lens[1] = 17, 300
    news = rng.integers(new[0], new[1] + 1, size=n)
    reqs = []
    for i in range(n):
        reqs.append(dict(prompt=rng.integers(0, vocab, size=int(lens[i])
                                             ).tolist(),
                         max_new_tokens=int(news[i]),
                         temperature=0.8 if i == 5 else 0.0))
    return reqs


def teacher_forced(engine, prompt, tokens) -> dict:
    """Re-run prompt + generated tokens through the model's dense prefill
    path (no paged kernel) and read where each greedy token stands."""
    import torch
    from ray_tpu_torch.models.generate import init_decode_cache
    cfg, dev, ps = engine.cfg, engine.device, engine.page_size
    seq = prompt + tokens[:-1]
    n_pg = -(-len(seq) // ps)
    pools = init_decode_cache(cfg, n_pg + 1, ps, device=dev)
    table = torch.arange(1, n_pg + 1, dtype=torch.int32, device=dev)[None]
    toks = torch.tensor([seq], dtype=torch.int32, device=dev)
    pos = torch.arange(len(seq), device=dev)[None]
    with torch.no_grad():
        logits = engine.model(toks, pos, block_tables=table,
                              kv_pools=pools)[0, len(prompt) - 1:]
    return forced_gaps(logits, tokens)


def forced_gaps(logits, tokens) -> dict:
    """Where each greedy token stands in the logits [len(tokens), vocab]
    that predict it: the largest gap to the best logit, and the share of
    tokens that are the argmax (a logit equal to the best one)."""
    import torch
    dev = logits.device
    chosen = logits[torch.arange(len(tokens), device=dev),
                    torch.tensor(tokens, device=dev)]
    gaps = logits.max(dim=-1).values - chosen
    return {"max_gap": float(gaps.max()),
            "agree": float((gaps == 0).float().mean())}


def gemm_kernel(name: str) -> bool:
    """Whether a kernel's name is that of a cuBLAS / CUTLASS GEMM or a
    cuDNN convolution (forward, data and weight gradients)."""
    key = name.lower()
    return ("nvjet" in key or "gemm" in key or "splitk" in key
            or "cutlass" in key or "fprop" in key or "dgrad" in key
            or "wgrad" in key or ("conv" in key and "convert" not in key))


# the profiler ranges the port opens (``train/step.py``, ``ops/moe.py``):
# each also shows on the device timeline as a span over its kernels,
# which is not a kernel itself
RANGES = ("optimizer", "moe_experts")


def kernel_events(prof):
    """The trace's kernels (device events that are not a range's span)."""
    from torch.autograd import DeviceType
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and e.name not in RANGES
            and not getattr(e, "is_user_annotation", False)]


def span_device_ms(prof, name: str, kernel=lambda name: True) -> float:
    """Device ms of the kernels (those whose name passes ``kernel``)
    inside the device-timeline spans of the profiler range ``name``.  A
    range's kernels run in order on one stream, so its spans hold them
    and no others.  The CPU side's links from ops to kernels are not
    used: in a trace of a train step they attach kernels to more than
    one op, so a range's ``device_time_total`` can exceed the step."""
    from torch.autograd import DeviceType
    spans = [e.time_range for e in prof.events()
             if e.name == name and e.device_type == DeviceType.CUDA]
    return sum(k.time_range.elapsed_us() for k in kernel_events(prof)
               if kernel(k.name) and any(
                   s.start <= k.time_range.start and k.time_range.end <= s.end
                   for s in spans)) / 1e3


def decode_step(engine) -> tuple:
    """One block of decode steps over all rows, on the state the run left
    (finished requests' tables and lengths): wall ms per step from CUDA
    events, and device ms per step by kernel group from torch.profiler
    (with experts, their GEMMs apart from the other GEMMs)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    k_steps = engine.block_size
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with torch.no_grad():
        start.record()
        engine._block_step()
        end.record()
        end.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            engine._block_step()
            torch.cuda.synchronize()
    groups = {"paged_attention": 0.0, "gemm": 0.0, "other": 0.0}
    for e in kernel_events(prof):
        if "paged_attention_kernel" in e.name:
            group = "paged_attention"
        elif gemm_kernel(e.name):
            group = "gemm"
        else:
            group = "other"
        groups[group] += e.device_time_total / 1e3 / k_steps
    if engine.cfg.moe_experts:
        # the experts' products run under MoEMLP's "moe_experts" range
        groups["expert_gemm"] = span_device_ms(
            prof, "moe_experts", gemm_kernel) / k_steps
        groups["gemm"] -= groups["expert_gemm"]
    return start.elapsed_time(end) / k_steps, groups


def make_model(dev, name: str, n_layers=None) -> tuple:
    """``name`` at full width (depth cut to ``n_layers`` where given) in
    bf16 with random weights from the seed: (model, seconds taken)."""
    import torch
    from ray_tpu_torch.models.configs import get_config
    from ray_tpu_torch.models.convert import init_weights
    from ray_tpu_torch.models.gpt import GPT
    cfg = get_config(name, **({} if n_layers is None
                              else dict(n_layers=n_layers)))
    t0 = time.perf_counter()
    model = GPT(cfg, device=dev, dtype=torch.bfloat16)
    init_weights(model, torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    return model, time.perf_counter() - t0


def serve(engine, reqs, streamed=()) -> tuple:
    """Submit ``reqs`` at once, each from its own thread; those at the
    indices ``streamed`` go through ``engine.stream`` on one event-loop
    thread instead.  (results, {index: streamed tokens}, wall seconds)."""
    import asyncio
    results = [None] * len(reqs)
    tokens = {}

    def go(i):
        r = reqs[i]
        results[i] = engine.submit(
            r["prompt"], max_new_tokens=r["max_new_tokens"],
            temperature=r["temperature"])

    async def streams():
        async def one(i):
            r = reqs[i]
            items = [x async for x in engine.stream(
                r["prompt"], max_new_tokens=r["max_new_tokens"],
                temperature=r["temperature"])]
            tokens[i], results[i] = items[:-1], items[-1]
        await asyncio.gather(*(one(i) for i in streamed))

    threads = [threading.Thread(target=go, args=(i,))
               for i in range(len(reqs)) if i not in streamed]
    if streamed:
        threads.append(threading.Thread(target=asyncio.run,
                                        args=(streams(),)))
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    check(not any(t.is_alive() for t in threads), "requests hung")
    return results, tokens, wall


def one_wave(engine, call, args_list) -> list:
    """``call(*args)`` for each of ``args_list`` while the engine's loop
    waits on its lock, so that one loop iteration takes them all; the
    results, in order."""
    import asyncio

    async def go():
        with engine._lock:
            futs = [call(*a) for a in args_list]
        return await asyncio.wait_for(asyncio.gather(*futs), 600)
    return asyncio.run(go())


def check_results(reqs, results, vocab: int) -> None:
    """Every request returned all its tokens, by length, in range."""
    for i, (r, res) in enumerate(zip(reqs, results)):
        check(res is not None, f"request {i} returned nothing")
        check(len(res.tokens) == r["max_new_tokens"],
              f"request {i}: {len(res.tokens)} tokens, wanted "
              f"{r['max_new_tokens']}")
        check(res.finish_reason == "length",
              f"request {i} finished by {res.finish_reason}")
        check(res.prompt_len == len(r["prompt"]),
              f"request {i} prompt_len {res.prompt_len}")
        check(all(0 <= t < vocab for t in res.tokens),
              f"request {i} token out of range")


def check_forced(forced) -> None:
    for f in forced:
        check(f["max_gap"] <= GAP_TOL and f["agree"] >= AGREE,
              f"greedy tokens disagree with the dense prefill path: {f}")


def serving_metrics(engine, results, wall: float, num_slots: int) -> dict:
    ttfts = sorted(r.time_to_first_token_s for r in results)
    return {"wall_s": wall, "decode_steps": engine.stats.steps,
            "decode_tokens": engine.stats.step_tokens,
            "tokens_generated": engine.stats.tokens_generated,
            "decode_tok_s": engine.stats.step_tokens / wall,
            "tok_s": engine.stats.tokens_generated / wall,
            "ttft_p50_s": statistics.median(ttfts),
            "ttft_max_s": ttfts[-1],
            "latency_p50_s": statistics.median(r.latency_s
                                               for r in results),
            "batch_occupancy": engine.stats.occupancy(num_slots)}


def slice_phase(dev, model, name: str = "llama3-8b",
                n_requests: int = 16, new: tuple = (32, 64),
                num_slots: int = 8) -> tuple:
    """The paged LLMEngine serving ``model`` (``name`` at full width,
    random bf16 weights): n_requests requests from threads, checked as
    the module docstring says."""
    import torch
    from ray_tpu_torch.ops.paged_attention import paged_attention_cuda
    from ray_tpu_torch.serve.llm_engine import LLMEngine

    cfg = model.cfg
    engine = LLMEngine(cfg, model, paged=True, num_slots=num_slots,
                       page_size=64, max_seq_len=1024, block_size=16,
                       top_k=50, seed=SEED, device=dev)
    try:
        reqs = make_requests(cfg.vocab_size, n_requests, new)
        t0 = time.perf_counter()
        engine.warmup(prompt_lens=[len(r["prompt"]) for r in reqs])
        warm_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats(dev)
        paged_attention_cuda.launches = 0
        results, _, wall = serve(engine, reqs)
        launches = paged_attention_cuda.launches
        steps = engine.stats.steps
        check_results(reqs, results, cfg.vocab_size)
        check(launches == cfg.n_layers * steps,
              f"kernel launches {launches} != n_layers {cfg.n_layers} x "
              f"decode steps {steps}")
        check(launches > 0, "the main path never launched the kernel")
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9

        # the kernel against the plain version on the engine's own pool,
        # tables and lengths (those of the last decode block)
        layer = cfg.n_layers // 2
        pool = engine._cache[layer]
        tables = engine._tables.clone()
        lengths = engine._positions.clamp(min=1).to(torch.int32)
        q = torch.randn(engine._rows, cfg.n_heads, cfg.head_dim,
                        generator=torch.Generator(device=dev).manual_seed(1),
                        device=dev).to(torch.bfloat16)
        real = paged_check(paged_attention_cuda(q, pool, tables, lengths),
                           q, pool, tables, lengths, "on the engine's pool")
        real.update(layer=layer, lengths=lengths.tolist())

        forced = [teacher_forced(engine, reqs[i]["prompt"],
                                 results[i].tokens) for i in (0, 1)]

        step_ms, step_device = decode_step(engine)
    finally:
        engine.close()

    out = {
        "phase": "slice", "model": name, "params": cfg.num_params(),
        "n_layers": cfg.n_layers, "d_model": cfg.d_model,
        "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
        "head_dim": cfg.head_dim,
        "vocab": cfg.vocab_size, "num_slots": num_slots, "page_size": 64,
        "max_seq_len": 1024, "block_size": 16,
        "kv_pool_pages": engine.kv_pool_pages,
        "requests": len(reqs), "kernel_launches": launches,
        **serving_metrics(engine, results, wall, num_slots),
        "decode_step_ms": step_ms, "decode_step_device_ms": step_device,
        "device_busy_share": sum(step_device.values()) / step_ms,
        "peak_mem_gb": peak_gb, "warmup_s": warm_s,
        "real_pool_check": real, "teacher_forced": forced,
    }
    check_forced(forced)
    return out, launches, real["max_abs_err"]


def dense_slice_phase(dev, model, paged: dict,
                      name: str = "llama3-8b") -> dict:
    """The dense slot-mode LLMEngine (the reference's default) serving
    ``model`` with the slice phase's settings and requests: requests 2
    and 3 stream, and their tokens must equal their results'; every
    greedy request passes the teacher-forced check; the paged kernel is
    never launched.  Then Generator.generate, greedy, on four of the
    prompts one at a time: its tokens pass the teacher-forced check, and
    their agreement with the engine's is reported.
    ``paged``: the slice phase's output, reported beside."""
    import torch
    from ray_tpu_torch.models.generate import Generator
    from ray_tpu_torch.ops.paged_attention import paged_attention_cuda
    from ray_tpu_torch.serve.llm_engine import LLMEngine

    cfg = model.cfg
    num_slots = 8
    engine = LLMEngine(cfg, model, num_slots=num_slots, max_seq_len=1024,
                       block_size=16, top_k=50, seed=SEED, device=dev)
    check(not engine.paged, "the engine's default is not the dense mode")
    try:
        reqs = make_requests(cfg.vocab_size)
        t0 = time.perf_counter()
        engine.warmup(prompt_lens=[len(r["prompt"]) for r in reqs])
        warm_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats(dev)
        paged_attention_cuda.launches = 0
        results, streamed, wall = serve(engine, reqs, streamed=(2, 3))
        launches = paged_attention_cuda.launches
        check_results(reqs, results, cfg.vocab_size)
        check(launches == 0, f"dense mode launched the paged kernel "
                             f"{launches} times")
        for i, toks in streamed.items():
            check(toks == results[i].tokens,
                  f"request {i} streamed {toks}, its result holds "
                  f"{results[i].tokens}")
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        greedy = [i for i, r in enumerate(reqs) if r["temperature"] == 0]
        forced = [teacher_forced(engine, reqs[i]["prompt"],
                                 results[i].tokens) for i in greedy]
        gen = Generator(engine.cfg, engine.model)
        agreement = []
        t0 = time.perf_counter()
        for i in greedy[:4]:
            r = reqs[i]
            got = gen.generate([r["prompt"]],
                               max_new_tokens=r["max_new_tokens"],
                               temperature=0.0)[0].tolist()
            want = results[i].tokens
            first = next((j for j, (a, b) in enumerate(zip(got, want))
                          if a != b), None)
            agreement.append({"request": i, "first_divergence": first,
                              "agree": sum(a == b for a, b in
                                           zip(got, want)) / len(want),
                              "teacher_forced": teacher_forced(
                                  engine, r["prompt"], got)})
        generator_s = time.perf_counter() - t0
        # near-ties of random weights flip under bf16 rounding, after
        # which the two continuations part; each must still be greedy
        check_forced([a["teacher_forced"] for a in agreement])
        step_ms, step_device = decode_step(engine)
    finally:
        engine.close()
    out = {"model": name, "params": cfg.num_params(),
           "n_layers": cfg.n_layers, "num_slots": num_slots,
           "max_seq_len": 1024, "block_size": 16,
           "dense_cache_bytes": sum(c.numel() * c.element_size()
                                    for c in engine._cache),
           "requests": len(reqs), "streamed": sorted(streamed),
           "paged_kernel_launches": launches,
           **serving_metrics(engine, results, wall, num_slots),
           "decode_step_ms": step_ms, "decode_step_device_ms": step_device,
           "device_busy_share": sum(step_device.values()) / step_ms,
           "peak_mem_gb": peak_gb, "warmup_s": warm_s,
           "teacher_forced": forced,
           "generator_agreement": agreement, "generator_s": generator_s,
           "paged": {k: paged[k] for k in (
               "decode_tok_s", "ttft_p50_s", "decode_step_ms",
               "decode_step_device_ms", "peak_mem_gb")}}
    check_forced(forced)
    return out


def prefix_handoff_phase(dev, model) -> dict:
    """The paged engine's prompt-prefix cache and prefill handoffs on
    ``model``.  Prefix: one request seeds the cache, then 8 requests
    sharing its 256-token prefix (4 pages of 64) with suffixes of 17-100
    tokens must all hit it and pass the teacher-forced check; the same
    requests on an engine without the cache give the TTFT beside.
    Handoff: 4 prompts exported by one engine and imported by a second
    on the same weights must decode the greedy tokens of a colocated
    submit on the first."""
    import numpy as np
    import torch
    from ray_tpu_torch.ops.paged_attention import paged_attention_cuda
    from ray_tpu_torch.serve.llm_engine import LLMEngine

    cfg = model.cfg
    kw = dict(paged=True, num_slots=8, page_size=64, max_seq_len=1024,
              block_size=16, top_k=50, seed=SEED, device=dev)
    rng = np.random.default_rng(SEED + 1)
    prefix = rng.integers(0, cfg.vocab_size, 256).tolist()
    suffixes = [int(n) for n in rng.integers(17, 101, 9)]
    reqs = [dict(prompt=prefix + rng.integers(0, cfg.vocab_size, n
                                                ).tolist(),
                 max_new_tokens=32, temperature=0.0) for n in suffixes]
    out = {"prefix_tokens": 256, "suffix_tokens": suffixes[1:]}
    for label, pages in (("with_cache", 64), ("without_cache", 0)):
        engine = LLMEngine(cfg, model, prefix_cache_pages=pages, **kw)
        try:
            engine.warmup(prompt_lens=[len(r["prompt"]) for r in reqs]
                          + suffixes)
            engine.submit(reqs[0]["prompt"], max_new_tokens=32)
            # the seed's last block was dispatched (and counted) before
            # its result came back, and nothing runs after it
            st = engine.stats
            steps0 = st.steps
            paged_attention_cuda.launches = 0
            results, _, wall = serve(engine, reqs[1:])
            launches = paged_attention_cuda.launches
            check_results(reqs[1:], results, cfg.vocab_size)
            check(launches == cfg.n_layers * (st.steps - steps0),
                  f"{label}: paged kernel launches {launches} != "
                  f"n_layers x decode steps {st.steps - steps0}")
            res = {"prefix_cache_pages": engine.prefix_cache_pages,
                   "prefix_hits": st.prefix_hits,
                   "prefix_misses": st.prefix_misses,
                   "prefix_tokens_saved": st.prefix_tokens_saved,
                   "prefilled_tokens": sum(len(r["prompt"]) for r in reqs)
                   - st.prefix_tokens_saved,
                   "paged_kernel_launches": launches,
                   "tokens": [r.tokens for r in results],
                   **serving_metrics(engine, results, wall, 8)}
            if pages:
                check(st.prefix_hits == 8 and st.prefix_tokens_saved
                      == 8 * 256, f"prefix hits {st.prefix_hits}, tokens "
                      f"saved {st.prefix_tokens_saved}: wanted 8 and 2048")
                res["teacher_forced"] = [
                    teacher_forced(engine, r["prompt"], res_.tokens)
                    for r, res_ in zip(reqs[1:], results)]
                check_forced(res["teacher_forced"])
        finally:
            engine.close()
        out[label] = res
    a, b = out["with_cache"].pop("tokens"), out["without_cache"].pop(
        "tokens")
    out["agree_with_and_without_cache"] = float(np.mean(
        [x == y for ra, rb in zip(a, b) for x, y in zip(ra, rb)]))

    # handoffs: 4 prompts of 100-300 tokens, greedy, 32 new tokens
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist()
               for n in rng.integers(100, 301, 4)]
    exporter = LLMEngine(cfg, model, **kw)
    importer = LLMEngine(cfg, model, **kw)
    admit_ms = []
    importer.on_import_admit = admit_ms.append
    try:
        for eng in (exporter, importer):
            eng.warmup(prompt_lens=[len(p) for p in prompts])
        paged_attention_cuda.launches = 0
        colocated = one_wave(exporter, lambda p: exporter.submit(
            p, max_new_tokens=32), [(p,) for p in prompts])
        colocated_launches = paged_attention_cuda.launches
        t0 = time.perf_counter()
        handoffs = one_wave(exporter, lambda p: exporter.export_prefill(
            p, max_new_tokens=32), [(p,) for p in prompts])
        export_s = time.perf_counter() - t0
        paged_attention_cuda.launches = 0
        t0 = time.perf_counter()
        imported = one_wave(importer, importer.import_prefill,
                            [(h,) for h in handoffs])
        import_s = time.perf_counter() - t0
        import_launches = paged_attention_cuda.launches
        check(import_launches == cfg.n_layers * importer.stats.steps,
              f"import: paged kernel launches {import_launches} != "
              f"n_layers x decode steps {importer.stats.steps}")
        for i, (got, want) in enumerate(zip(imported, colocated)):
            check(got.tokens == want.tokens,
                  f"handoff {i} decoded {got.tokens[:8]}..., the colocated "
                  f"submit {want.tokens[:8]}...")
    finally:
        exporter.close()
        importer.close()
    out["handoff"] = {
        "prompt_tokens": [len(p) for p in prompts],
        "npages": [h.npages for h in handoffs],
        "bytes": [h.nbytes for h in handoffs],
        "kv_shape": list(handoffs[0].kv.shape),
        "export_ms_per_request": [h.export_ms for h in handoffs],
        "import_admit_ms_per_request": admit_ms,
        "export_wall_s": export_s, "import_wall_s": import_s,
        "colocated_paged_kernel_launches": colocated_launches,
        "import_paged_kernel_launches": import_launches,
        "import_decode_steps": importer.stats.steps,
        "tokens_equal_colocated": True}
    return out


# llama3-8b at full width served by an actor of the port's runtime: 2 of
# its 32 layers keep the weights the driver puts into the object store
# near 3 GB (two 1.05 GB embedding tables and 0.44 GB per layer)
RUNTIME_LAYERS = 2
RUNTIME_REQUESTS = 8
RUNTIME_FORBIDDEN = ("jax", "jaxlib", "flax", "ray_tpu", "cloudpickle",
                     "msgpack", "psutil")


def _no_gpu_probe():
    """What a worker that leased no GPU sees."""
    import os
    import sys

    import torch

    from ray_tpu_torch.runtime import worker_main
    return {"cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "cuda_available": torch.cuda.is_available(),
            "forbidden_loaded": sorted({m.split(".")[0] for m in sys.modules}
                                       & set(RUNTIME_FORBIDDEN)),
            "worker_main": worker_main.__file__, "pid": os.getpid()}


class ServeActor:
    """A worker that leases the card, builds ``name`` from the weights in
    the object store and serves requests on the paged LLMEngine: the
    pattern of a Serve replica's engine."""

    def __init__(self):
        import os
        self.created_at = time.time()
        self.pid = os.getpid()

    def serve(self, refs, reqs, name: str, n_layers: int):
        """Build the model on the card from ``refs[0]`` (a state dict in
        the object store; nested, so the ref arrives unresolved and the
        fetch is timed here) and serve ``reqs``."""
        import os

        import torch

        import ray_tpu_torch
        from ray_tpu_torch._private.device import resolve_device
        from ray_tpu_torch.models.configs import get_config
        from ray_tpu_torch.models.gpt import GPT
        from ray_tpu_torch.ops.paged_attention import paged_attention_cuda
        from ray_tpu_torch.serve.llm_engine import LLMEngine

        t0 = time.time()
        dev = resolve_device(None)      # the card, which this worker leased
        torch.cuda.init()
        torch.empty(1, device=dev)       # the context, now
        torch.cuda.synchronize(dev)
        t_cuda = time.time()
        state = ray_tpu_torch.get(refs[0])
        t_get = time.time()
        nbytes = sum(v.numel() * v.element_size() for v in state.values())
        cfg = get_config(name, n_layers=n_layers)
        model = GPT(cfg, dtype=torch.bfloat16)
        model.load_state_dict(state)
        torch.cuda.synchronize(dev)
        t_loaded = time.time()
        del state
        engine = LLMEngine(cfg, model, paged=True, num_slots=8,
                           page_size=64, max_seq_len=1024, block_size=16,
                           top_k=50, seed=SEED)
        try:
            engine.warmup(prompt_lens=[len(r["prompt"]) for r in reqs])
            paged_attention_cuda.launches = 0
            results, _, wall = serve(engine, reqs)
            launches = paged_attention_cuda.launches
            stats = engine.stats
        finally:
            engine.close()
        return {
            "pid": self.pid, "device": str(next(model.parameters()).device),
            "device_name": torch.cuda.get_device_name(dev),
            "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
            "tokens": [r.tokens for r in results],
            "finish": [r.finish_reason for r in results],
            "prompt_lens": [r.prompt_len for r in results],
            "launches": launches, "decode_steps": stats.steps,
            "n_layers": cfg.n_layers, "wall_s": wall,
            "decode_tok_s": stats.step_tokens / wall,
            "start": {"created_at": self.created_at, "loaded_at": t_loaded,
                      "cuda_s": t_cuda - t0, "get_s": t_get - t_cuda,
                      "get_gb_s": nbytes / 1e9 / max(t_get - t_cuda, 1e-9),
                      "weights_to_card_s": t_loaded - t_get},
            "weight_bytes": nbytes}


def _runtime_processes(session_dir=None) -> list:
    """Live processes of the port's runtime (its GCS, raylets, zygotes
    and workers) that belong to this script: those under this process,
    and those whose command line names ``session_dir`` (every daemon,
    the zygote by its socket, and the workers it forks, which keep its
    command line).  Another checkout's runtime on the machine is not
    counted."""
    import os
    me = os.getpid()
    parent, cmds = {}, {}
    for pid in os.listdir("/proc"):
        if not pid.isdigit() or int(pid) == me:
            continue
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
            with open(f"/proc/{pid}/stat") as f:
                # the field after the parenthesised name is the state,
                # then the parent's pid
                parent[int(pid)] = int(f.read().rsplit(")", 1)[1].split()[1])
        except (OSError, IndexError, ValueError):
            continue
        if "ray_tpu_torch.runtime." in cmd:
            cmds[int(pid)] = cmd.strip()

    def mine(pid: int) -> bool:
        seen = set()
        while pid > 1 and pid not in seen:
            seen.add(pid)
            pid = parent.get(pid, 0)
            if pid == me:
                return True
        return False

    return [(pid, cmd) for pid, cmd in sorted(cmds.items())
            if mine(pid) or (session_dir and session_dir in cmd)]


def runtime_phase(dev, name: str = "llama3-8b",
                  n_layers: int = RUNTIME_LAYERS) -> dict:
    """The port's task, actor and object runtime on the card: the
    requests served first by an engine in this process; then a cluster
    whose raylet finds the GPU without starting CUDA; a task that leases
    no GPU and sees none; an actor that leases the card, takes ``name``
    (full width, depth ``n_layers``) through the object store and serves
    the same RUNTIME_REQUESTS requests on the paged engine, checked
    against this process's copy of the weights; then a shutdown that
    leaves no process of the session behind."""
    import os

    import torch

    import ray_tpu_torch
    from ray_tpu_torch.runtime.node import session_base
    from ray_tpu_torch.serve.llm_engine import LLMEngine

    torch.cuda.empty_cache()
    before = _runtime_processes()
    check(not before, f"runtime processes left from before: {before}")
    model, _ = make_model(dev, name, n_layers=n_layers)
    cfg = model.cfg
    reqs = make_requests(cfg.vocab_size, RUNTIME_REQUESTS)

    # the same requests on an engine in this process, before the
    # runtime starts (the actor's run comes second, in a fresh process)
    engine = LLMEngine(cfg, model, paged=True, num_slots=8,
                       page_size=64, max_seq_len=1024, block_size=16,
                       top_k=50, seed=SEED, device=dev)
    try:
        engine.warmup(prompt_lens=[len(r["prompt"]) for r in reqs])
        local, _, wall = serve(engine, reqs)
        in_process = {"decode_tok_s": engine.stats.step_tokens / wall,
                      "wall_s": wall, "decode_steps": engine.stats.steps}
    finally:
        engine.close()

    state = {k: v.detach().to("cpu", torch.bfloat16)
             for k, v in model.state_dict().items()}
    nbytes = sum(v.numel() * v.element_size() for v in state.values())
    store_bytes = int(nbytes * 1.25) + (1 << 30)
    t0 = time.perf_counter()
    ray_tpu_torch.init(num_cpus=4, object_store_memory=store_bytes)
    init_s = time.perf_counter() - t0
    node = ray_tpu_torch.api._node
    out = {"model": name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "params": cfg.num_params(), "init_s": init_s,
           "session_dir": node.session_dir, "store_path": node.store_path,
           "store_bytes": store_bytes,
           "store_in_dev_shm": node.store_path.startswith("/dev/shm/")}
    try:
        res = ray_tpu_torch.cluster_resources()
        out["cluster_resources"] = res
        check(res.get("GPU") == 1.0,
              f"the raylet found {res.get('GPU')} GPUs, wanted 1")
        check(node.session_dir.startswith(session_base() + os.sep),
              f"session dir {node.session_dir} is not under "
              f"{session_base()}")

        probe = ray_tpu_torch.get(
            ray_tpu_torch.remote(_no_gpu_probe).remote(), timeout=300)
        out["no_gpu_task"] = probe
        check(probe["cuda_visible_devices"] == "",
              f"a task without a GPU sees CUDA_VISIBLE_DEVICES="
              f"{probe['cuda_visible_devices']!r}")
        check(not probe["cuda_available"], "a task without a GPU has CUDA")
        check(probe["forbidden_loaded"] == [],
              f"a worker loaded {probe['forbidden_loaded']}")
        check(os.sep + os.path.join("ray_tpu_torch", "runtime",
                                    "worker_main.py") in probe["worker_main"],
              f"the worker runs {probe['worker_main']}")

        t0 = time.perf_counter()
        ref = ray_tpu_torch.put(state)
        put_s = time.perf_counter() - t0
        del state
        out.update(weight_bytes=nbytes, put_s=put_s,
                   put_gb_s=nbytes / 1e9 / put_s)

        t0 = time.time()
        actor = ray_tpu_torch.remote(ServeActor).options(num_gpus=1).remote()
        got = ray_tpu_torch.get(actor.serve.remote([ref], reqs, name,
                                                   n_layers), timeout=900)
        start = got["start"]
        out["actor"] = {k: v for k, v in got.items() if k != "tokens"}
        # host wall clocks of one machine: the driver's and the actor's
        out["actor"]["start"] = {
            "fork_s": start["created_at"] - t0,
            **{k: start[k] for k in ("cuda_s", "get_s", "get_gb_s",
                                     "weights_to_card_s")},
            "total_s": start["loaded_at"] - t0}
        check(got["pid"] != os.getpid(), "the actor ran in the driver")
        check(got["device_name"] == torch.cuda.get_device_name(dev),
              f"the actor ran on {got['device_name']}")
        check(got["cuda_visible_devices"] not in (None, ""),
              f"the GPU actor sees CUDA_VISIBLE_DEVICES="
              f"{got['cuda_visible_devices']!r}")
        check(got["weight_bytes"] == nbytes,
              f"the actor got {got['weight_bytes']} B of {nbytes}")
        for i, (r, toks) in enumerate(zip(reqs, got["tokens"])):
            check(len(toks) == r["max_new_tokens"]
                  and got["finish"][i] == "length"
                  and got["prompt_lens"][i] == len(r["prompt"])
                  and all(0 <= t < cfg.vocab_size for t in toks),
                  f"actor request {i}: {len(toks)} tokens, "
                  f"{got['finish'][i]}")
        check(got["launches"] > 0, "the actor never launched K4")
        check(got["launches"] == got["n_layers"] * got["decode_steps"],
              f"actor K4 launches {got['launches']} != n_layers "
              f"{got['n_layers']} x decode steps {got['decode_steps']}")
        ray_tpu_torch.kill(actor)

        # the actor's greedy tokens teacher-forced through this copy
        greedy = [i for i, r in enumerate(reqs) if r["temperature"] == 0.0]
        forced = [teacher_forced(engine, reqs[i]["prompt"], got["tokens"][i])
                  for i in greedy]
        in_process.update(
            greedy_tokens_equal=sum(local[i].tokens == got["tokens"][i]
                                    for i in greedy), greedy=len(greedy))
        out["in_process"] = in_process
        out["teacher_forced"] = forced
        check_forced(forced)
    finally:
        ray_tpu_torch.shutdown()
        deadline = time.monotonic() + 30
        left = _runtime_processes(node.session_dir)
        while left and time.monotonic() < deadline:
            time.sleep(0.5)
            left = _runtime_processes(node.session_dir)
    out["left_after_shutdown"] = left
    check(not left, f"processes left after shutdown: {left}")
    return out


# Serve on the port's runtime: one llama3-8b replica at full width and
# depth, then a disaggregated prefill / decode pair at depth 2 sharing
# the card; both with the slice phase's engine settings
SERVE_ENGINE = dict(paged=True, num_slots=8, page_size=64,
                    max_seq_len=1024, block_size=16, top_k=50, seed=SEED)
SERVE_STREAMED = (2, 3)
DISAGG_LAYERS = 2
DISAGG_REQUESTS = 8


def counted_server_class():
    """``LLMServer`` with one read-only method, ``probe``: what the
    replica's K4 wrapper (and every other kernel's) counted since the
    replica became ready (the counts are set to 0 at the end of
    ``__init__``, after the warmup), its engine's slot counts, and
    how the replica started (host clock: CUDA, the fp32 weights on the
    card, the engine's cast copy, the warmup) and its memory."""
    import os

    import torch

    from ray_tpu_torch.ops.paged_attention import paged_attention_cuda
    from ray_tpu_torch.serve import llm_engine
    from ray_tpu_torch.serve.llm import LLMServer

    class CountedLLMServer(LLMServer):
        _times: dict = {}

        def __init__(self, *args, **kwargs):
            times = CountedLLMServer._times
            times["init_at"] = time.time()
            warmup = llm_engine.LLMEngine.warmup

            def timed_warmup(engine, *a, **kw):
                times["warmup_at"] = time.time()
                warmup(engine, *a, **kw)

            llm_engine.LLMEngine.warmup = timed_warmup
            try:
                super().__init__(*args, **kwargs)
            finally:
                llm_engine.LLMEngine.warmup = warmup
            dev = self.engine.device
            torch.cuda.synchronize(dev)
            times.update(ready_at=time.time(),
                         allocated_gb=torch.cuda.memory_allocated(dev) / 1e9,
                         init_peak_gb=torch.cuda.max_memory_allocated(dev)
                         / 1e9)
            torch.cuda.reset_peak_memory_stats(dev)
            for kernel in kernel_counters().values():
                kernel.launches = 0

        @staticmethod
        def _load_params(cfg, checkpoint, seed, device):
            times = CountedLLMServer._times
            torch.empty(1, device=device)      # the context, now
            torch.cuda.synchronize(device)
            times["cuda_at"] = time.time()
            params = LLMServer._load_params(cfg, checkpoint, seed, device)
            torch.cuda.synchronize(device)
            times["params_at"] = time.time()
            tensors = (params.values() if isinstance(params, dict)
                       else params.parameters())
            times["param_bytes"] = sum(
                p.numel() * p.element_size() for p in tensors)
            return params

        def probe(self) -> dict:
            dev = self.engine.device
            return {"k4_launches": paged_attention_cuda.launches,
                    "launches": {n: k.launches
                                 for n, k in kernel_counters().items()},
                    "pid": os.getpid(),
                    "cuda_visible_devices":
                        os.environ.get("CUDA_VISIBLE_DEVICES"),
                    "device": str(dev),
                    "device_name": torch.cuda.get_device_name(dev),
                    "dtype": str(next(self.engine.model.parameters()).dtype),
                    "kv_dtype": str(self.engine._cache[0].dtype),
                    "n_layers": self.engine.cfg.n_layers,
                    "kv_pool_pages": self.engine.kv_pool_pages,
                    "serving_peak_gb":
                        torch.cuda.max_memory_allocated(dev) / 1e9,
                    "load": self.engine.load_snapshot(),
                    "start": dict(CountedLLMServer._times)}

    return CountedLLMServer


def counted(app, cls):
    """``app`` (from ``build_app``) with ``cls`` in place of LLMServer
    and the same deployment options, its upstream pool included."""
    from ray_tpu_torch.serve import Application, Deployment
    kwargs = {k: counted(v, cls) if isinstance(v, Application) else v
              for k, v in app.init_kwargs.items()}
    dep = app.deployment
    return Deployment(cls, dep.name, dep.config).bind(*app.init_args,
                                                      **kwargs)


def _wait_gone(pids, timeout: float = 120.0) -> None:
    """Wait until the processes ``pids`` (killed replicas) have exited,
    so their card memory is free."""
    import os
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline and any(
            os.path.exists(f"/proc/{p}") for p in pids):
        time.sleep(0.2)
    left = [p for p in pids if os.path.exists(f"/proc/{p}")]
    check(not left, f"replica processes {left} outlived serve.shutdown()")


def _pct(values, q: float) -> float:
    """Nearest-rank percentile."""
    v = sorted(values)
    return v[min(len(v) - 1, max(0, math.ceil(q * len(v)) - 1))]


def _driver_engine(dev, name: str, n_layers=None, checkpoint=None):
    """The driver's checking copy: ``LLMServer._load_params`` (fp32 from
    the seed, or ``checkpoint``'s, as a replica builds it) cast into a
    paged engine."""
    from ray_tpu_torch.models.configs import get_config
    from ray_tpu_torch.serve.llm import LLMServer
    from ray_tpu_torch.serve.llm_engine import LLMEngine
    cfg = get_config(name, **({} if n_layers is None
                              else dict(n_layers=n_layers)))
    params = LLMServer._load_params(cfg, checkpoint, SEED, dev)
    engine = LLMEngine(cfg, params, device=dev, **SERVE_ENGINE)
    del params
    return engine


def _check_probe(probe, dev, n_layers: int, steps: int, label: str,
                 fp32_on_card: bool = True) -> None:
    import torch
    check(probe["device_name"] == torch.cuda.get_device_name(dev),
          f"{label} ran on {probe['device_name']}")
    check(probe["cuda_visible_devices"] not in (None, ""),
          f"{label} sees CUDA_VISIBLE_DEVICES="
          f"{probe['cuda_visible_devices']!r}")
    check(probe["dtype"] == "torch.bfloat16",
          f"{label}'s engine holds {probe['dtype']} weights")
    check(probe["n_layers"] == n_layers,
          f"{label} has {probe['n_layers']} layers")
    check(probe["k4_launches"] == n_layers * steps,
          f"{label}: K4 launches {probe['k4_launches']} != n_layers "
          f"{n_layers} x decode steps {steps}")
    # the engine keeps its bf16 copy; the fp32 weights are gone
    check(not fp32_on_card or probe["start"]["allocated_gb"] * 1e9
          < probe["start"]["param_bytes"],
          f"{label} holds {probe['start']['allocated_gb']:.2f} GB after "
          f"start, the fp32 weights were "
          f"{probe['start']['param_bytes'] / 1e9:.2f} GB")


def _start_times(probe, t_run: float) -> dict:
    s = probe["start"]
    return {"run_to_init_s": s["init_at"] - t_run,
            "cuda_s": s["cuda_at"] - s["init_at"],
            "fp32_init_s": s["params_at"] - s["cuda_at"],
            "cast_s": s["warmup_at"] - s["params_at"],
            "warmup_s": s["ready_at"] - s["warmup_at"],
            "total_s": s["ready_at"] - t_run,
            "fp32_param_gb": s["param_bytes"] / 1e9,
            "allocated_after_start_gb": s["allocated_gb"],
            "start_peak_gb": s["init_peak_gb"]}


def serve_phase(dev, name: str = "llama3-8b") -> dict:
    """Serve and LLMServer on the port's runtime, as the module
    docstring says: a colocated replica at full depth, then a
    disaggregated pair at depth DISAGG_LAYERS; shutdown leaves no
    process of the session."""
    import os

    import torch

    import ray_tpu_torch
    from ray_tpu_torch import serve
    from ray_tpu_torch.models.configs import get_config
    from ray_tpu_torch.serve import DeploymentHandle
    from ray_tpu_torch.serve.llm import build_app, disagg_handle

    torch.cuda.empty_cache()
    before = _runtime_processes()
    check(not before, f"runtime processes left from before: {before}")
    cfg = get_config(name)
    reqs = make_requests(cfg.vocab_size)
    lens = [len(r["prompt"]) for r in reqs]
    cls = counted_server_class()
    t0 = time.perf_counter()
    ray_tpu_torch.init(num_cpus=4, object_store_memory=1 << 30)
    node = ray_tpu_torch.api._node
    out = {"model": name, "init_s": time.perf_counter() - t0,
           "session_dir": node.session_dir}
    try:
        check(ray_tpu_torch.cluster_resources().get("GPU") == 1.0,
              "the raylet did not find the GPU")

        # 1. colocated, full depth, on one replica leasing the card
        app = build_app(name, num_gpus=1, warmup_prompt_lens=lens,
                        **SERVE_ENGINE)
        check(app.deployment.config.ray_actor_options == {"num_gpus": 1},
              f"build_app gave {app.deployment.config.ray_actor_options}")
        t_run = time.time()
        handle = serve.run(counted(app, cls))
        probe0 = ray_tpu_torch.get(handle.probe.remote(), timeout=900)
        check(probe0["k4_launches"] == 0,
              f"K4 launched {probe0['k4_launches']} times before serving")
        t0 = time.perf_counter()
        refs = {i: handle.remote(r) for i, r in enumerate(reqs)
                if i not in SERVE_STREAMED}
        streams = {i: handle.stream.remote_streaming(reqs[i])
                   for i in SERVE_STREAMED}
        items = {}

        def consume(i):
            items[i] = [ray_tpu_torch.get(ref, timeout=600)
                        for ref in streams[i]]
        threads = [threading.Thread(target=consume, args=(i,))
                   for i in SERVE_STREAMED]
        for t in threads:
            t.start()
        results = {i: ray_tpu_torch.get(ref, timeout=600)
                   for i, ref in refs.items()}
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        check(not any(t.is_alive() for t in threads), "streams hung")
        tokens = {i: r["tokens"] for i, r in results.items()}
        for i in SERVE_STREAMED:
            toks = [x["token"] for x in items[i][:-1]]
            summary = items[i][-1]
            check(len(toks) == summary["num_tokens"],
                  f"request {i} streamed {len(toks)} tokens, its summary "
                  f"counts {summary['num_tokens']}")
            tokens[i], results[i] = toks, summary
        for i, r in enumerate(reqs):
            check(len(tokens[i]) == r["max_new_tokens"]
                  and results[i]["finish_reason"] == "length"
                  and results[i]["prompt_len"] == len(r["prompt"])
                  and all(0 <= t < cfg.vocab_size for t in tokens[i]),
                  f"request {i}: {len(tokens[i])} tokens, "
                  f"{results[i]['finish_reason']}")
        stats = ray_tpu_torch.get(handle.stats.remote(), timeout=60)
        probe = ray_tpu_torch.get(handle.probe.remote(), timeout=60)
        check(stats["steps"] > 0, "the replica never stepped")
        check(stats["requests_completed"] == len(reqs),
              f"the replica completed {stats['requests_completed']}")
        _check_probe(probe, dev, cfg.n_layers, stats["steps"], "replica")
        check(probe["pid"] != os.getpid(), "the replica ran in the driver")
        ttfts = [results[i]["time_to_first_token_s"]
                 for i in range(len(reqs))]
        out["colocated"] = {
            "n_layers": cfg.n_layers, "params": cfg.num_params(),
            "requests": len(reqs), "streamed": list(SERVE_STREAMED),
            "ray_actor_options": app.deployment.config.ray_actor_options,
            "start": _start_times(probe, t_run),
            "wall_s": wall, "stats": stats,
            "k4_launches": probe["k4_launches"],
            "decode_tok_s": (stats["tokens_generated"] - stats["prefills"])
            / wall,
            "ttft_p50_s": _pct(ttfts, 0.5), "ttft_p90_s": _pct(ttfts, 0.9),
            "latency_p50_s": _pct([results[i]["latency_s"]
                                   for i in range(len(reqs))], 0.5),
            "serving_peak_gb": probe["serving_peak_gb"],
            "replica_pid": probe["pid"],
            "cuda_visible_devices": probe["cuda_visible_devices"]}
        serve.shutdown()
        _wait_gone([probe["pid"]])

        # the driver's copy, built as the replica built its own
        t0 = time.perf_counter()
        engine = _driver_engine(dev, name)
        out["colocated"]["driver_copy_s"] = time.perf_counter() - t0
        greedy = [i for i, r in enumerate(reqs) if r["temperature"] == 0.0]
        try:
            forced = [teacher_forced(engine, reqs[i]["prompt"], tokens[i])
                      for i in greedy]
        finally:
            engine.close()
            del engine
            torch.cuda.empty_cache()
        out["colocated"]["teacher_forced"] = forced
        check_forced(forced)

        # 2. disaggregated, depth DISAGG_LAYERS, two half-card replicas
        dreqs = make_requests(cfg.vocab_size, DISAGG_REQUESTS)
        app = build_app(name, disaggregated=True, prefill_replicas=1,
                        num_replicas=1, num_gpus=0.5,
                        config_overrides={"n_layers": DISAGG_LAYERS},
                        warmup_prompt_lens=[len(r["prompt"]) for r in dreqs],
                        **SERVE_ENGINE)
        t_run = time.time()
        serve.run(counted(app, cls))
        pools = {role: DeploymentHandle(f"llm-{name}-{role}")
                 for role in ("prefill", "decode")}
        probes0 = {role: ray_tpu_torch.get(h.probe.remote(), timeout=900)
                   for role, h in pools.items()}
        dh = disagg_handle(name)

        async def one(req):
            got = [x async for x in dh.stream(req)]
            return [x["token"] for x in got if "token" in x], got[-1]

        async def streams_all():
            return await asyncio.gather(*(one(r) for r in dreqs))
        t0 = time.perf_counter()
        streamed = asyncio.run(asyncio.wait_for(streams_all(), 600))
        dwall = time.perf_counter() - t0
        for i, ((toks, summary), r) in enumerate(zip(streamed, dreqs)):
            check(summary.get("finish_reason") == "length"
                  and summary.get("num_tokens") == r["max_new_tokens"]
                  and len(toks) == r["max_new_tokens"]
                  and all(0 <= t < cfg.vocab_size for t in toks),
                  f"disagg request {i}: {len(toks)} tokens, {summary}")
        dstats = {role: ray_tpu_torch.get(h.stats.remote(), timeout=60)
                  for role, h in pools.items()}
        dprobe = {role: ray_tpu_torch.get(h.probe.remote(), timeout=60)
                  for role, h in pools.items()}
        pre, dec = dstats["prefill"], dstats["decode"]
        n = len(dreqs)
        check(pre["prefills"] == pre["exports"] == n and pre["steps"] == 0,
              f"prefill pool: {pre}")
        check(dec["imports"] == n and dec["prefills"] == 0,
              f"decode pool: {dec}")
        for role, steps in (("prefill", 0), ("decode", dec["steps"])):
            _check_probe(dprobe[role], dev, DISAGG_LAYERS, steps,
                         f"{role} replica")
        check(dprobe["prefill"]["cuda_visible_devices"]
              == dprobe["decode"]["cuda_visible_devices"],
              "the half-card replicas hold different cards")
        # the handoffs as the timeline records them: one export and one
        # import per request, of the prompt's pages
        from ray_tpu_torch.experimental.state.api import timeline
        ps = SERVE_ENGINE["page_size"]
        kv_dtype = dprobe["prefill"]["kv_dtype"].removeprefix("torch.")
        page_bytes = (DISAGG_LAYERS * cfg.n_kv_heads * ps * 2
                      * cfg.head_dim * getattr(torch, kv_dtype).itemsize)
        want_bytes = sum(-(-len(r["prompt"]) // ps) * page_bytes
                         for r in dreqs)
        events, deadline = [], time.monotonic() + 60
        while time.monotonic() < deadline:
            events = [e for e in timeline() if e.get("cat") == "handoff"]
            if len(events) >= 2 * n:
                break
            time.sleep(0.5)
        by_stage = {s: [(e["args"]["bytes"], e["dur"] / 1e3)
                        for e in events if e["args"]["stage"] == s]
                    for s in ("export", "import")}
        for stage, evs in by_stage.items():
            got = sum(b for b, _ in evs)
            check(len(evs) == n and got == want_bytes,
                  f"{stage} handoffs: {len(evs)} of {got} B in all, "
                  f"wanted {n} of {want_bytes} B")
        out["disagg"] = {
            "n_layers": DISAGG_LAYERS, "requests": n,
            "ray_actor_options": app.deployment.config.ray_actor_options,
            "start": {role: _start_times(p, t_run)
                      for role, p in dprobe.items()},
            "wall_s": dwall, "stats": dstats,
            "k4_launches": {role: p["k4_launches"]
                            for role, p in dprobe.items()},
            "decode_tok_s": (dec["tokens_generated"]) / dwall,
            "handoff_bytes": want_bytes,
            "handoff_bytes_per_request": [b for b, _ in by_stage["export"]],
            "export_ms": [ms for _, ms in by_stage["export"]],
            "import_pull_ms": [ms for _, ms in by_stage["import"]],
            "handoff_pull_ms": [s["handoff_pull_ms"] for _, s in streamed],
            "ttft_p50_s": _pct([s["time_to_first_token_s"]
                                for _, s in streamed], 0.5),
            "cards": dprobe["decode"]["cuda_visible_devices"],
            "probes_before_serving": {role: p["k4_launches"]
                                      for role, p in probes0.items()}}
        check(all(p["k4_launches"] == 0 for p in probes0.values()),
              f"K4 launched before serving: {out['disagg']['probes_before_serving']}")
        serve.shutdown()
        _wait_gone([p["pid"] for p in dprobe.values()])
        engine = _driver_engine(dev, name, DISAGG_LAYERS)
        try:
            forced = [teacher_forced(engine, dreqs[i]["prompt"],
                                     streamed[i][0])
                      for i, r in enumerate(dreqs)
                      if r["temperature"] == 0.0]
        finally:
            engine.close()
            del engine
            torch.cuda.empty_cache()
        out["disagg"]["teacher_forced"] = forced
        check_forced(forced)
    finally:
        serve.shutdown()
        ray_tpu_torch.shutdown()
        deadline = time.monotonic() + 30
        left = _runtime_processes(node.session_dir)
        while left and time.monotonic() < deadline:
            time.sleep(0.5)
            left = _runtime_processes(node.session_dir)
    out["left_after_shutdown"] = left
    check(not left, f"processes left after shutdown: {left}")
    return out


# The AIR path on the port's runtime: JaxTrainer trains gpt-small in a GPU
# worker and reports a torch checkpoint, LLMServer serves that checkpoint
# behind the HTTP proxy, and a two-worker gang shares the card
AIR_STEPS = TRAIN_STEPS
AIR_BATCH, AIR_SEQ = 16, 1024           # the train phase's batch
AIR_CKPT_STEPS = (7, 14, AIR_STEPS)      # three reported, two kept
AIR_STREAMS = 8
AIR_JSON = 2
GANG_LAYERS = 2
GANG_BATCH = 8
GANG_STEPS = 5
# per step under remat "dots": K1 twice per layer, K2 and K3 once
AIR_PER_STEP = {"flash_fwd": 2, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}


def air_train_loop(config):
    """The train loop of phase air, in a trainer worker: gpt-small from
    the seed (``n_layers`` cut where given) on the worker's card, the
    train phase's batch for rank 0 (the seed plus the rank for the
    others), ``make_train`` with AdamW, gradients averaged across the
    gang (``train.sync_gradients``) when there is one.  Each step it
    reports the loss, gradient norm, step ms and this process's kernel
    launches; in a gang also whether every rank's parameters are bitwise
    equal (a SHA-256 over their bytes, gathered on the host collective),
    every rank's launches and the step's ``grad_allreduce`` ms from the
    step clock; ``history`` holds every step's report so far.  At the
    steps ``ckpt_steps`` it reports a torch checkpoint of the fp32
    parameters in ``ckpt_dir``."""
    import hashlib
    import os

    import numpy as np
    import torch

    from ray_tpu_torch import train
    from ray_tpu_torch._private import step_stats
    from ray_tpu_torch.air import Checkpoint, session
    from ray_tpu_torch.models.configs import get_config
    from ray_tpu_torch.models.convert import init_weights
    from ray_tpu_torch.models.gpt import GPT
    from ray_tpu_torch.train.step import OptimizerConfig, make_train
    from ray_tpu_torch.util import collective as col

    dev = train.get_device()
    rank, world = session.get_world_rank(), session.get_world_size()
    batch, seq = config["batch"], config["seq"]
    over = dict(max_seq_len=seq, remat=True, remat_policy="dots",
                attention_impl="flash")
    if config.get("n_layers"):
        over["n_layers"] = config["n_layers"]
    cfg = get_config("gpt-small", **over)
    model = GPT(cfg, device=dev)
    init_weights(model, torch.Generator(device=dev).manual_seed(
        config["seed"]))
    rng = np.random.default_rng(config["seed"] + rank)
    data = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (batch, seq + 1))).to(dev)}
    init_fn, step_fn = make_train(
        model, OptimizerConfig(warmup_steps=10, decay_steps=1000),
        grad_sync=train.sync_gradients if world > 1 else None)
    state = init_fn()
    group = os.environ.get("RAY_TPU_TORCH_TRAIN_COLLECTIVE_GROUP")
    kernels = kernel_counters()
    clock = train.step_clock()
    history = []
    run = step_stats.current_run()

    def synced_ms():
        return (run.ledger.phase_ms.get("grad_allreduce", 0.0)
                if run is not None else 0.0)

    for step in range(1, config["steps"] + 1):
        before = {n: k.launches for n, k in kernels.items()}
        sync_before = synced_ms()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        clock.begin()
        state, m = step_fn(state, data)
        loss, grad_norm = float(m["loss"]), float(m["grad_norm"])
        torch.cuda.synchronize(dev)
        step_ms = (time.perf_counter() - t0) * 1e3
        clock.end(tokens=batch * seq)
        out = {"step": step, "loss": loss, "grad_norm": grad_norm,
               "step_ms": step_ms,
               "launches": {n: k.launches - before[n]
                            for n, k in kernels.items()},
               "pid": os.getpid(),
               "device_name": torch.cuda.get_device_name(dev),
               "cuda_visible_devices":
                   os.environ.get("CUDA_VISIBLE_DEVICES")}
        if world > 1:
            digest = hashlib.sha256()
            for p in model.parameters():
                digest.update(p.detach().cpu().numpy().tobytes())
            digests = col.allgather(
                np.frombuffer(digest.digest(), np.uint8), group)
            counts = col.allgather(np.array(
                [out["launches"][n] for n in sorted(kernels)], np.int64),
                group)
            out.update(
                params_equal=all(np.array_equal(d, digests[0])
                                 for d in digests),
                rank_launches=[dict(zip(sorted(kernels), c.tolist()))
                               for c in counts],
                grad_sync_ms=synced_ms() - sync_before)
        ckpt = None
        if step in config["ckpt_steps"]:
            t0 = time.perf_counter()
            ckpt = Checkpoint.from_torch(
                {"params": {k: v.detach().float()
                            for k, v in model.state_dict().items()}},
                metrics={"step": step, "loss": loss},
                path=os.path.join(config["ckpt_dir"], f"step_{step}"))
            out["checkpoint_save_s"] = time.perf_counter() - t0
        history.append(out)
        session.report(dict(out, history=list(history)), checkpoint=ckpt)


def _air_fit(scaling, loop_config: dict, storage: str, name: str):
    """One JaxTrainer fit of ``air_train_loop``; (result, every step's
    report, the fit's wall seconds)."""
    from ray_tpu_torch.air import CheckpointConfig, RunConfig
    from ray_tpu_torch.train import JaxTrainer
    t0 = time.perf_counter()
    result = JaxTrainer(air_train_loop, train_loop_config=loop_config,
                        scaling_config=scaling,
                        run_config=RunConfig(
                            name=name, storage_path=storage,
                            checkpoint_config=CheckpointConfig(
                                num_to_keep=2))).fit()
    return (result, result.metrics.get("history", []),
            time.perf_counter() - t0)


def _http(host: str, port: int, method: str, path: str, body=None,
          timeout: float = 600.0) -> tuple:
    """(status, content type, parsed body) of one request."""
    import http.client
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        conn.request(method, path, body=None if body is None
                     else json.dumps(body),
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        data = r.read()
        ctype = (r.getheader("Content-Type") or "").split(";")[0]
        return (r.status, ctype, json.loads(data)
                if ctype == "application/json" else data.decode())
    finally:
        conn.close()


def _sse_stream(host: str, port: int, path: str, req: dict) -> dict:
    """One SSE request as a client reads it: the token events with their
    arrival times, the ``done`` summary, any other event."""
    import http.client
    conn = http.client.HTTPConnection(host, port, timeout=600)
    out = {"tokens": [], "times": [], "done": None, "other": []}
    try:
        t0 = time.perf_counter()
        conn.request("POST", path, body=json.dumps(req),
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        out.update(status=r.status, ctype=r.getheader("Content-Type"),
                   chunked=r.getheader("Transfer-Encoding"), sent=t0)
        event = None
        while True:
            line = r.readline()
            if not line:
                break
            line = line.decode().rstrip("\n")
            if line.startswith("event: "):
                event = line[len("event: "):]
            elif line.startswith("data: "):
                data = json.loads(line[len("data: "):])
                if event is None and "token" in data:
                    out["tokens"].append(data["token"])
                    out["times"].append(time.perf_counter())
                elif event == "done":
                    out["done"] = data
                else:
                    out["other"].append((event, data))
            elif not line:
                event = None
    finally:
        conn.close()
    return out


def _sse_hang_up(host: str, port: int, path: str, req: dict,
                 after: int) -> int:
    """Read ``after`` token events of a stream, then close the socket;
    the count of events read."""
    import socket
    body = json.dumps(req).encode()
    with socket.create_connection((host, port), timeout=600) as s:
        s.sendall(f"POST {path} HTTP/1.1\r\nHost: {host}\r\n"
                  f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
        got = b""
        while got.count(b"data: {\"token\"") < after:
            chunk = s.recv(65536)
            check(chunk != b"", "the stream ended before the hang-up")
            got += chunk
    return got.count(b"data: {\"token\"")


def air_launches(air: dict, kind: str) -> dict:
    """The air phase's launches of kernel ``kind`` by path: the trainer
    worker, the replica behind the proxy, the gang (both ranks)."""
    return {path: air[part]["launches"][kind] for path, part in (
        ("air_train", "train"), ("air_serve", "serve"),
        ("air_gang", "gang"))}


def air_phase(dev, train: dict, served: dict) -> dict:
    """The AIR path on the port's runtime, in a session of its own, as
    the module docstring says: (a) JaxTrainer trains gpt-small in a
    worker leasing the card, (b) LLMServer serves its checkpoint behind
    the HTTP proxy, (c) a two-worker gang on half a card each syncs its
    gradients over the host collective.  ``train`` and ``served`` are
    the train and serve phases' results, to stand beside."""
    import os
    import shutil
    import socket
    import tempfile

    import torch

    import ray_tpu_torch
    from ray_tpu_torch import serve
    from ray_tpu_torch.air import ScalingConfig
    from ray_tpu_torch.models.configs import get_config
    from ray_tpu_torch.serve import DeploymentHandle, HTTPOptions
    from ray_tpu_torch.serve.llm import build_app

    torch.cuda.empty_cache()
    before = _runtime_processes()
    check(not before, f"runtime processes left from before: {before}")
    work = tempfile.mkdtemp(prefix="chip_smoke_air_")
    name = "gpt-small"
    cfg = get_config(name)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    host = "127.0.0.1"
    t0 = time.perf_counter()
    ray_tpu_torch.init(num_cpus=4, object_store_memory=1 << 30)
    node = ray_tpu_torch.api._node
    out = {"init_s": time.perf_counter() - t0,
           "session_dir": node.session_dir, "http_port": port}
    unknown = {}
    try:
        check(ray_tpu_torch.cluster_resources().get("GPU") == 1.0,
              "the raylet did not find the GPU")
        # the proxy first: a request to a deployment nobody made waits
        # out the handle's 60 s backpressure before its 500, so it runs
        # beside the training
        serve.start(http_options=HTTPOptions(host=host, port=port))

        def ask_unknown():
            t = time.perf_counter()
            unknown["reply"] = _http(host, port, "POST",
                                     "/no-such-deployment", {"x": 1})
            unknown["s"] = time.perf_counter() - t
        unknown_thread = threading.Thread(target=ask_unknown)
        unknown_thread.start()

        # (a) gpt-small at full width and depth through JaxTrainer
        result, reports, fit_s = _air_fit(
            ScalingConfig(num_workers=1, use_gpu=True),
            dict(seed=SEED, batch=AIR_BATCH, seq=AIR_SEQ, steps=AIR_STEPS,
                 ckpt_steps=AIR_CKPT_STEPS, ckpt_dir=work),
            work, "air_train")
        check(result.error is None, f"the trainer failed: {result.error}")
        check(result.metrics.get("training_iteration") == AIR_STEPS
              and len(reports) == AIR_STEPS,
              f"{len(reports)} reports, training_iteration "
              f"{result.metrics.get('training_iteration')}")
        want = {n: 0 for n in kernel_counters()}
        want.update({n: v * cfg.n_layers for n, v in AIR_PER_STEP.items()})
        for r in reports:
            check(r["launches"] == want,
                  f"air_train step {r['step']}: launches {r['launches']} "
                  f"!= {want}")
        losses = [r["loss"] for r in reports]
        check(all(math.isfinite(x) for x in losses)
              and losses[-1] < losses[0],
              f"air_train losses {losses}: not finite and falling")
        first = train["parity"]["flash"]["loss"]
        check(abs(losses[0] - first) / abs(first) <= LOSS_RTOL,
              f"air_train's first loss {losses[0]} against the train "
              f"phase's {first}")
        kept = [c.metrics()["step"] for c, _ in result.best_checkpoints]
        check(kept == list(AIR_CKPT_STEPS[-2:]),
              f"kept checkpoints of steps {kept}")
        check(reports[0]["device_name"] == torch.cuda.get_device_name(dev)
              and reports[0]["cuda_visible_devices"] not in (None, ""),
              f"the trainer worker ran on {reports[0]['device_name']} "
              f"seeing {reports[0]['cuda_visible_devices']!r}")
        timed = reports[1:]
        air_tok_s = (AIR_BATCH * AIR_SEQ * len(timed)
                     / (sum(r["step_ms"] for r in timed) / 1e3))
        out["train"] = {
            "model": name, "n_layers": cfg.n_layers, "batch": AIR_BATCH,
            "seq": AIR_SEQ, "steps": AIR_STEPS, "fit_s": fit_s,
            "losses": losses, "first_loss": losses[0],
            "train_phase_first_loss": first,
            "step_ms": [r["step_ms"] for r in reports],
            "launches_per_step": reports[-1]["launches"],
            "launches": {n: sum(r["launches"][n] for r in reports)
                         for n in want},
            "tokens_s": air_tok_s, "train_phase_tokens_s":
                train["tokens_s"],
            "checkpoints_reported": list(AIR_CKPT_STEPS),
            "checkpoints_kept": kept,
            "checkpoint_save_s": [r["checkpoint_save_s"] for r in reports
                                  if "checkpoint_save_s" in r],
            "checkpoint_bytes": sum(
                os.path.getsize(os.path.join(dp, f)) for dp, _, fs in
                os.walk(os.path.join(work, f"step_{AIR_STEPS}"))
                for f in fs),
            "worker_pid": reports[0]["pid"]}
        _wait_gone([reports[0]["pid"]])

        # (b) that checkpoint behind the proxy
        ckpt_dir = result.checkpoint.to_directory(
            os.path.join(work, "served"))
        reqs = make_requests(cfg.vocab_size, AIR_STREAMS + AIR_JSON + 1)
        lens = [len(r["prompt"]) for r in reqs]
        app = build_app(name, checkpoint=ckpt_dir, num_gpus=1,
                        warmup_prompt_lens=lens, **SERVE_ENGINE)
        t_run = time.time()
        handle = serve.run(counted(app, counted_server_class()),
                           http_options=HTTPOptions(host=host, port=port))
        dep = app.deployment.name
        probe0 = ray_tpu_torch.get(handle.probe.remote(), timeout=900)
        check(probe0["k4_launches"] == 0,
              f"K4 launched {probe0['k4_launches']} times before serving")
        check(_http(host, port, "GET", "/-/healthz") == (200, "text/plain",
                                                         "ok"),
              "/-/healthz did not answer ok")
        echo = {"echo": [1, 2.5, None]}
        check(_http(host, port, "POST", "/-/echo", echo)
              == (200, "application/json", echo), "/-/echo did not echo")
        streams, answers = {}, {}

        def stream(i):
            streams[i] = _sse_stream(host, port, f"/-/stream/{dep}",
                                     reqs[i])

        def ask(i):
            answers[i] = _http(host, port, "POST", f"/{dep}", reqs[i])
        threads = ([threading.Thread(target=stream, args=(i,))
                    for i in range(AIR_STREAMS)]
                   + [threading.Thread(target=ask, args=(i,))
                      for i in range(AIR_STREAMS, AIR_STREAMS + AIR_JSON)])
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        check(not any(t.is_alive() for t in threads), "HTTP requests hung")
        tokens = {}
        for i, st in streams.items():
            check(st["status"] == 200
                  and st["ctype"] == "text/event-stream"
                  and st["chunked"] == "chunked" and not st["other"],
                  f"stream {i}: {st['status']} {st['ctype']} "
                  f"{st['chunked']} {st['other']}")
            check(st["done"] is not None
                  and st["done"]["num_tokens"] == len(st["tokens"])
                  == reqs[i]["max_new_tokens"]
                  and st["done"]["finish_reason"] == "length",
                  f"stream {i}: {len(st['tokens'])} tokens, done "
                  f"{st['done']}")
            tokens[i] = st["tokens"]
        for i, (status, ctype, body) in answers.items():
            check(status == 200 and ctype == "application/json"
                  and len(body["tokens"]) == reqs[i]["max_new_tokens"]
                  and body["finish_reason"] == "length",
                  f"JSON request {i}: {status} {ctype} {body}")
            tokens[i] = body["tokens"]
        # one more stream, left by its client halfway
        hang = reqs[-1]
        read = _sse_hang_up(host, port, f"/-/stream/{dep}", hang,
                            hang["max_new_tokens"] // 2)
        busy, deadline = None, time.monotonic() + 120
        while busy != 0 and time.monotonic() < deadline:
            probe = ray_tpu_torch.get(handle.probe.remote(), timeout=60)
            busy = probe["load"]["busy_slots"]
            time.sleep(0.2)
        check(busy == 0, f"{busy} slots still busy after the hang-up")
        stats = ray_tpu_torch.get(handle.stats.remote(), timeout=60)
        probe = ray_tpu_torch.get(handle.probe.remote(), timeout=60)
        # the checkpoint's fp32 weights never reach the card
        _check_probe(probe, dev, cfg.n_layers, stats["steps"],
                     "air replica", fp32_on_card=False)
        check(stats["requests_completed"] == len(reqs),
              f"the replica completed {stats['requests_completed']} of "
              f"{len(reqs)}")
        firsts = [st["times"][0] - st["sent"] for st in streams.values()]
        decoded = sum(len(st["tokens"]) - 1 for st in streams.values())
        t_first = min(st["sent"] for st in streams.values())
        t_last = max(st["times"][-1] for st in streams.values())
        out["serve"] = {
            "model": name, "deployment": dep, "checkpoint": ckpt_dir,
            "requests": len(reqs), "streams": AIR_STREAMS,
            "json_requests": AIR_JSON, "hang_up_after": read,
            "start": _start_times(probe, t_run), "wall_s": wall,
            "stats": stats, "k4_launches": probe["k4_launches"],
            "launches": probe["launches"],
            "client_ttft_p50_s": _pct(firsts, 0.5),
            "client_ttft_p90_s": _pct(firsts, 0.9),
            "client_decode_tok_s": decoded / (t_last - t_first),
            "serve_phase_ttft_p50_s": served["colocated"]["ttft_p50_s"],
            "serve_phase_decode_tok_s":
                served["colocated"]["decode_tok_s"],
            "serving_peak_gb": probe["serving_peak_gb"],
            "replica_pid": probe["pid"]}
        serve.delete(dep)
        _wait_gone([probe["pid"]])
        t0 = time.perf_counter()
        engine = _driver_engine(dev, name, checkpoint=ckpt_dir)
        out["serve"]["driver_copy_s"] = time.perf_counter() - t0
        try:
            forced = [teacher_forced(engine, reqs[i]["prompt"], tokens[i])
                      for i in sorted(tokens)
                      if reqs[i]["temperature"] == 0.0]
        finally:
            engine.close()
            del engine
            torch.cuda.empty_cache()
        out["serve"]["teacher_forced"] = forced
        check_forced(forced)

        # (c) two workers on half a card each, gradients synced on the
        # host collective
        gang, greports, gang_s = _air_fit(
            ScalingConfig(num_workers=2, use_gpu=True,
                          devices_per_worker=0.5),
            dict(seed=SEED, batch=GANG_BATCH, seq=AIR_SEQ, steps=GANG_STEPS,
                 n_layers=GANG_LAYERS, ckpt_steps=(), ckpt_dir=work),
            work, "air_gang")
        check(gang.error is None, f"the gang failed: {gang.error}")
        check(len(greports) == GANG_STEPS, f"{len(greports)} gang reports")
        gwant = {n: 0 for n in kernel_counters()}
        gwant.update({n: v * GANG_LAYERS for n, v in AIR_PER_STEP.items()})
        for r in greports:
            check(r["params_equal"],
                  f"gang step {r['step']}: the ranks' parameters differ")
            check(r["rank_launches"] == [gwant, gwant],
                  f"gang step {r['step']}: launches {r['rank_launches']}")
            check(r["grad_sync_ms"] > 0,
                  f"gang step {r['step']}: no grad_allreduce phase")
        glosses = [r["loss"] for r in greports]
        check(all(math.isfinite(x) for x in glosses)
              and glosses[-1] < glosses[0],
              f"gang losses {glosses}: not finite and falling")
        out["gang"] = {
            "model": name, "n_layers": GANG_LAYERS, "workers": 2,
            "gpu_per_worker": 0.5, "batch_per_rank": GANG_BATCH,
            "seq": AIR_SEQ, "steps": GANG_STEPS, "fit_s": gang_s,
            "losses_rank0": glosses,
            "step_ms": [r["step_ms"] for r in greports],
            "grad_sync_ms": [r["grad_sync_ms"] for r in greports],
            "params_equal": [r["params_equal"] for r in greports],
            "launches_per_step_per_rank": greports[-1]["rank_launches"],
            # both ranks, every step
            "launches": {n: sum(rl[n] for r in greports
                                for rl in r["rank_launches"])
                         for n in gwant},
            "grad_bytes_per_step": 4 * get_config(
                name, n_layers=GANG_LAYERS).num_params()}
        unknown_thread.join(timeout=300)
        check(not unknown_thread.is_alive(),
              "the unknown deployment's request hung")
        status, ctype, body = unknown["reply"]
        check(status == 500 and ctype == "application/json"
              and set(body) == {"error", "message"},
              f"unknown deployment: {status} {ctype} {body}")
        out["unknown_deployment"] = {"status": status, "body": body,
                                     "s": unknown["s"]}
    finally:
        serve.shutdown()
        ray_tpu_torch.shutdown()
        shutil.rmtree(work, ignore_errors=True)
        deadline = time.monotonic() + 30
        left = _runtime_processes(node.session_dir)
        while left and time.monotonic() < deadline:
            time.sleep(0.5)
            left = _runtime_processes(node.session_dir)
    out["left_after_shutdown"] = left
    check(not left, f"processes left after shutdown: {left}")
    return out


# Batch inference and sweeps on the port's runtime: BatchPredictor scores
# ViT-B/16 over a Dataset in a pool of half-card actors, and Tuner runs
# JaxTrainer once per trial with ASHA
PREDICT_MODEL = "vit-b16"
PREDICT_IMAGES, PREDICT_BLOCKS = 4096, 16
PREDICT_BATCH = 256
PREDICT_WORKERS = 2
PREDICT_TIMED = 4                        # driver batches timed
TUNE_LAYERS = 2
TUNE_LRS = (3e-3, 1e-3, 3e-4, 1e-4)     # the grid's order of trials
TUNE_ROWS, TUNE_BATCH = 64, 8            # 8 steps of 8 x 1024 an epoch
TUNE_ASHA = dict(grace_period=2, reduction_factor=2, max_t=8)
TUNE_CKPT_STEPS = (2, 4, 8)              # ASHA's rungs and its max_t
TUNE_CONCURRENT = 2
# the sweep's loss gates (every trial's first loss against the driver's
# step, the best checkpoint's loss against its trial's): the same kernels
# on the same batch from the same seed, so a few fp32 ulps at most
# (equal bit for bit on the card so far); far tighter than the closest
# two losses of one trial (5e-5 relative apart), so a checkpoint of
# another step or trial, or another batch, fails
TUNE_LOSS_RTOL = 1e-6


def counted_predictor_class():
    """``JaxPredictor`` that reports, beside each batch's logits, what
    the scoring actor did: its pid, each kernel's launches during the
    batch (K1's at the ViT shape apart), the batch's stream time between
    two CUDA events and its host span, and how the actor started (host
    clock: ``from_checkpoint`` entered, CUDA up, the weights on the
    card).  The counts are set to 0 once the predictor is built.  It
    drops the input column, so the output holds logits, not images."""
    import os

    import numpy as np
    import torch

    from ray_tpu_torch._private.device import resolve_device
    from ray_tpu_torch.train import JaxPredictor

    class CountedPredictor(JaxPredictor):
        _times: dict = {}

        @classmethod
        def from_checkpoint(cls, checkpoint, **kwargs):
            times = cls._times
            times["init_at"] = time.time()
            times["process_start_at"] = _process_start()
            dev = resolve_device(kwargs.get("device"))  # raises: no card
            torch.empty(1, device=dev)       # the context, now
            torch.cuda.synchronize(dev)
            times["cuda_at"] = time.time()
            p = super().from_checkpoint(checkpoint, **kwargs)
            torch.cuda.synchronize(dev)
            times["weights_at"] = time.time()
            for kernel in kernel_counters().values():
                kernel.launches = 0
            return p

        def predict(self, batch, **kwargs):
            kernels = kernel_counters()
            before = {n: k.launches for n, k in kernels.items()}
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.time()
            with FlashShapes() as shapes:
                start.record()
                out = super().predict(batch, **kwargs)
                end.record()
            end.synchronize()
            t1 = time.time()
            logits = out[self.output_column]
            delta = {n: k.launches - before[n] for n, k in kernels.items()}
            seq = self.model.cfg.num_patches
            cols = {"pid": os.getpid(), "t0": t0, "t1": t1,
                    "stream_ms": start.elapsed_time(end),
                    "k1_at_shape": shapes.calls.get(
                        f"fwd q{seq} kv{seq} full", 0),
                    "rows_in_batch": len(logits),
                    **{f"launches_{n}": v for n, v in delta.items()},
                    **{f"start_{k}": v for k, v in self._times.items()}}
            return {self.output_column: logits,
                    **{k: np.full(len(logits), v) for k, v in cols.items()}}

    return CountedPredictor


def _process_start() -> float:
    """This process's start on the host clock (``/proc``, in clock
    ticks since boot)."""
    import os
    with open("/proc/self/stat") as f:
        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/stat") as f:
        boot = next(int(ln.split()[1]) for ln in f
                    if ln.startswith("btime"))
    return boot + ticks / os.sysconf("SC_CLK_TCK")


def _scale_images(batch):
    """The BatchMapper's function: uint8 images to fp32 in [0, 1]."""
    import numpy as np
    return {"features": batch["data"].astype(np.float32) / 255.0}


def air_tune_config(n_layers: int = TUNE_LAYERS):
    from ray_tpu_torch.models.configs import get_config
    return get_config("gpt-small", n_layers=n_layers, max_seq_len=1024,
                      remat=True, remat_policy="dots",
                      attention_impl="flash")


def air_tune_optimizer(lr: float):
    from ray_tpu_torch.train.step import OptimizerConfig
    # no warmup: from the first update on, the trials' losses part, so
    # ASHA has something to cut at its first rung
    return OptimizerConfig(learning_rate=lr, warmup_steps=0,
                           decay_steps=1000)


def air_tune_loop(config):
    """One trial's train loop, in its trainer's worker on half a card:
    gpt-small at ``n_layers`` from the seed, AdamW at the trial's ``lr``,
    batches of ``batch`` rows read from the ``train`` dataset shard.
    Each step reports the loss, this process's kernel launches, its
    host span and ``history`` (every report so far).  At the steps
    ``ckpt_steps`` the report carries a torch checkpoint of the fp32
    parameters the step's loss was computed with (saved before the
    step)."""
    import os

    import numpy as np
    import torch

    from ray_tpu_torch import train
    from ray_tpu_torch.air import Checkpoint, session
    from ray_tpu_torch.models.convert import init_weights
    from ray_tpu_torch.models.gpt import GPT
    from ray_tpu_torch.train.step import make_train

    dev = train.get_device()
    lr = config["lr"]
    cfg = air_tune_config(config["n_layers"])
    model = GPT(cfg, device=dev)
    init_weights(model, torch.Generator(device=dev).manual_seed(
        config["seed"]))
    init_fn, step_fn = make_train(model, air_tune_optimizer(lr))
    state = init_fn()
    kernels = kernel_counters()
    history = []
    shard = session.get_dataset_shard("train")
    batches = shard.iter_batches(batch_size=config["batch"],
                                 batch_format="numpy", drop_last=True)
    for step, batch in enumerate(batches, start=1):
        tokens = torch.from_numpy(np.array(batch["data"])).to(dev)
        ckpt = None
        if step in config["ckpt_steps"]:
            ckpt = Checkpoint.from_torch(
                {"params": {k: v.detach().float()
                            for k, v in model.state_dict().items()}},
                metrics={"step": step, "lr": lr},
                path=os.path.join(config["ckpt_dir"], f"lr_{lr:g}",
                                  f"step_{step}"))
        before = {n: k.launches for n, k in kernels.items()}
        torch.cuda.synchronize(dev)
        t0 = time.time()
        state, m = step_fn(state, {"tokens": tokens})
        loss = float(m["loss"])
        torch.cuda.synchronize(dev)
        out = {"step": step, "loss": loss, "lr": lr, "t0": t0,
               "t1": time.time(),
               "launches": {n: k.launches - before[n]
                            for n, k in kernels.items()},
               "pid": os.getpid(),
               "device_name": torch.cuda.get_device_name(dev),
               "cuda_visible_devices":
                   os.environ.get("CUDA_VISIBLE_DEVICES")}
        history.append(out)
        session.report(dict(out, history=list(history)), checkpoint=ckpt)


def air_batch_launches(ab: dict, kind: str) -> dict:
    """Phase air_batch's launches of kernel ``kind`` by path: the scoring
    actors, and every trial's trainer worker together."""
    return {"air_predict": ab["predict"]["launches"][kind],
            "air_tune": ab["tune"]["launches"][kind]}


def _predict_phase(dev, work: str) -> dict:
    """Part (a) of phase air_batch, in a running session."""
    import functools
    import os

    import numpy as np
    import torch

    from ray_tpu_torch import data as rd
    from ray_tpu_torch.data import BatchMapper
    from ray_tpu_torch.models.convert import init_weights
    from ray_tpu_torch.models.vit import ViT, get_vit_config
    from ray_tpu_torch.train import (BatchPredictor, JaxPredictor,
                                     predictor_checkpoint)

    cfg = get_vit_config(PREDICT_MODEL)
    model = ViT(cfg, device=dev)
    init_weights(model, torch.Generator(device=dev).manual_seed(SEED))
    t0 = time.perf_counter()
    ckpt = predictor_checkpoint(functools.partial(ViT, cfg),
                                model.state_dict(),
                                path=os.path.join(work, "vit"))
    save_s = time.perf_counter() - t0
    del model
    torch.cuda.empty_cache()
    rng = np.random.default_rng(SEED)
    images = rng.integers(0, 256, (PREDICT_IMAGES, cfg.image_size,
                                   cfg.image_size, 3), dtype=np.uint8)
    t0 = time.perf_counter()
    ds = rd.from_numpy(np.split(images, PREDICT_BLOCKS))
    put_s = time.perf_counter() - t0
    prep = BatchMapper(_scale_images)
    cls = counted_predictor_class()
    out = {"model": PREDICT_MODEL, "images": PREDICT_IMAGES,
           "blocks": PREDICT_BLOCKS, "batch_size": PREDICT_BATCH,
           "workers": PREDICT_WORKERS, "gpu_per_worker": 0.5,
           "checkpoint_save_s": save_s, "from_numpy_s": put_s,
           "checkpoint_bytes": sum(
               os.path.getsize(os.path.join(dp, f)) for dp, _, fs in
               os.walk(ckpt.to_directory()) for f in fs)}

    # a scoring actor that leases no card refuses to score on the CPU
    tiny = rd.from_numpy([images[:2]])
    try:
        BatchPredictor.from_checkpoint(ckpt, cls).predict(
            prep.transform(tiny), batch_size=2, min_scoring_workers=1,
            max_scoring_workers=1).to_numpy()
        refused = None
    except Exception as e:     # the actor's error, raised here
        refused = f"{type(e).__name__}: {e}"
    check(refused is not None and "no CUDA device" in refused,
          f"a scoring actor without a GPU lease scored: {refused}")
    out["no_gpu_refused"] = refused.splitlines()[-1][:300]

    t_predict = time.time()
    t0 = time.perf_counter()
    scored = BatchPredictor.from_checkpoint(ckpt, cls).predict(
        prep.transform(ds), batch_size=PREDICT_BATCH,
        min_scoring_workers=PREDICT_WORKERS,
        max_scoring_workers=PREDICT_WORKERS, num_gpus_per_worker=0.5)
    got = scored.to_numpy()
    wall = time.perf_counter() - t0
    logits = got.get("predictions")
    check(logits is not None and logits.shape == (PREDICT_IMAGES,
                                                  cfg.num_classes),
          f"predict returned {None if logits is None else logits.shape}")
    check(bool(np.isfinite(logits).all()), "non-finite logits")
    firsts = np.arange(0, PREDICT_IMAGES, PREDICT_BATCH)
    batches = [{k: got[k][i] for k in got if k != "predictions"}
               for i in firsts]
    check(all(b["rows_in_batch"] == PREDICT_BATCH for b in batches),
          f"batch rows {[b['rows_in_batch'] for b in batches]}")
    launches = {n: int(sum(b[f"launches_{n}"] for b in batches))
                for n in kernel_counters()}
    want = {n: 0 for n in launches}
    want["flash_fwd"] = cfg.n_layers * len(batches)
    check(launches == want,
          f"scoring actors' launches {launches} != {want}")
    at_shape = int(sum(b["k1_at_shape"] for b in batches))
    check(at_shape == want["flash_fwd"],
          f"K1 at [{PREDICT_BATCH}, {cfg.num_patches}, {cfg.n_heads}, "
          f"{cfg.d_model // cfg.n_heads}] non-causal: {at_shape} of "
          f"{want['flash_fwd']}")
    pids = sorted({int(b["pid"]) for b in batches})
    check(len(pids) == PREDICT_WORKERS, f"scoring actors {pids}")

    # the same model in the driver, on the same images
    driver = JaxPredictor.from_checkpoint(ckpt, device=dev)
    first = _scale_images({"data": images[:PREDICT_BATCH]})
    want_logits = driver.predict(first)["predictions"]
    cmp_ = compare(torch.from_numpy(logits[:PREDICT_BATCH]),
                   torch.from_numpy(want_logits))
    check(cmp_["within_tol"] and cmp_["finite"],
          f"scored logits against the driver's: {cmp_}")
    timed = [_scale_images({"data": images[i * PREDICT_BATCH:
                                           (i + 1) * PREDICT_BATCH]})
             for i in range(PREDICT_TIMED)]
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for b in timed:
        driver.predict(b)
    driver_s = time.perf_counter() - t0
    del driver
    torch.cuda.empty_cache()

    actors = {}
    for pid in pids:
        mine = [b for b in batches if int(b["pid"]) == pid]
        span = max(b["t1"] for b in mine) - min(b["t0"] for b in mine)
        s = mine[0]
        actors[str(pid)] = {
            "batches": len(mine),
            "stream_ms": [float(b["stream_ms"]) for b in mine],
            "busy_share": sum(b["stream_ms"] for b in mine) / 1e3 / span,
            "span_s": span,
            # from predict(): the process's start (fork; negative for a
            # worker the raylet kept from an earlier lease), then its
            # imports and the first scaled block, CUDA, the weights
            "start": {
                "process_start_s": s["start_process_start_at"] - t_predict,
                "to_first_block_s":
                    s["start_init_at"] - s["start_process_start_at"],
                "cuda_s": s["start_cuda_at"] - s["start_init_at"],
                "weights_s": s["start_weights_at"] - s["start_cuda_at"],
                "ready_s": s["start_weights_at"] - t_predict}}
    out.update(wall_s=wall, images_s=PREDICT_IMAGES / wall,
               driver_images_s=PREDICT_TIMED * PREDICT_BATCH / driver_s,
               launches=launches, k1_at_shape=at_shape,
               logits_vs_driver=cmp_, actors=actors)
    return out


def _tune_phase(dev, work: str) -> dict:
    """Part (b) of phase air_batch, in a running session."""
    import numpy as np
    import torch

    from ray_tpu_torch import data as rd
    from ray_tpu_torch import tune
    from ray_tpu_torch.air import RunConfig, ScalingConfig
    from ray_tpu_torch.models.convert import init_weights
    from ray_tpu_torch.models.gpt import GPT
    from ray_tpu_torch.train import JaxTrainer
    from ray_tpu_torch.train.step import lm_loss_fn, make_train

    cfg = air_tune_config()
    rng = np.random.default_rng(SEED)
    tokens = rng.integers(0, cfg.vocab_size, (TUNE_ROWS, 1025))
    steps = TUNE_ROWS // TUNE_BATCH
    ds = rd.from_numpy(np.split(tokens, steps))
    trainer = JaxTrainer(
        air_tune_loop,
        train_loop_config=dict(seed=SEED, n_layers=TUNE_LAYERS,
                               batch=TUNE_BATCH, ckpt_dir=work,
                               ckpt_steps=TUNE_CKPT_STEPS),
        scaling_config=ScalingConfig(num_workers=1, use_gpu=True,
                                     devices_per_worker=0.5),
        datasets={"train": ds})
    tuner = tune.Tuner(
        trainer, param_space={"lr": tune.grid_search(list(TUNE_LRS))},
        tune_config=tune.TuneConfig(
            metric="loss", mode="min",
            max_concurrent_trials=TUNE_CONCURRENT,
            scheduler=tune.ASHAScheduler(metric="loss", mode="min",
                                         **TUNE_ASHA)),
        run_config=RunConfig(name="air_tune", storage_path=work))
    t0 = time.perf_counter()
    grid = tuner.fit()
    sweep_s = time.perf_counter() - t0
    check(not grid.errors, f"trials failed: {grid.errors}")
    check(len(grid) == len(TUNE_LRS), f"{len(grid)} trials")
    trials = []
    for r in grid:
        hist = r.metrics["history"]
        check([h["step"] for h in hist] == list(range(1, len(hist) + 1))
              and hist[-1]["step"] == r.metrics["step"],
              f"trial lr {r.metrics['lr']}: steps "
              f"{[h['step'] for h in hist]}")
        trials.append({
            "lr": r.metrics["lr"], "steps": len(hist),
            "stop": "max_t" if len(hist) == TUNE_ASHA["max_t"] else "asha",
            "start": hist[0]["t0"], "end": hist[-1]["t1"],
            "losses": [h["loss"] for h in hist],
            "pid": hist[0]["pid"], "hist": hist})
    trials.sort(key=lambda t: t["start"])
    check(all(t["steps"] >= 1 for t in trials)
          and {t["lr"] for t in trials} == set(TUNE_LRS),
          f"trials {[(t['lr'], t['steps']) for t in trials]}")
    kernels = kernel_counters()
    per_step = {n: 0 for n in kernels}
    per_step.update({n: v * TUNE_LAYERS for n, v in AIR_PER_STEP.items()})
    for t in trials:
        for h in t["hist"]:
            check(h["launches"] == per_step,
                  f"trial lr {t['lr']} step {h['step']}: launches "
                  f"{h['launches']} != {per_step}")
        check(t["hist"][0]["device_name"] == torch.cuda.get_device_name(dev)
              and t["hist"][0]["cuda_visible_devices"] not in (None, ""),
              f"trial lr {t['lr']} ran on {t['hist'][0]['device_name']} "
              f"seeing {t['hist'][0]['cuda_visible_devices']!r}")
    # concurrency: two trials overlap, never more; a later trial starts
    # only once an earlier one has ended (ASHA freed its half card)
    events = sorted([(t["start"], 1) for t in trials]
                    + [(t["end"], -1) for t in trials])
    live, most = 0, 0
    for _, d in events:
        live += d
        most = max(most, live)
    check(most == TUNE_CONCURRENT,
          f"at most {most} trials ran at once, not {TUNE_CONCURRENT}")
    for t in trials[TUNE_CONCURRENT:]:
        check(any(o["end"] <= t["start"] for o in trials if o is not t),
              f"trial lr {t['lr']} started before any trial ended")
    check(any(t["stop"] == "asha" for t in trials),
          f"ASHA stopped no trial: "
          f"{[(t['lr'], t['losses']) for t in trials]}")
    _wait_gone([t["pid"] for t in trials])

    # the first step is the same for every lr, and the driver's
    model = GPT(cfg, device=dev)
    init_weights(model, torch.Generator(device=dev).manual_seed(SEED))
    batch = {"tokens": torch.from_numpy(tokens[:TUNE_BATCH]).to(dev)}
    init_fn, step_fn = make_train(model, air_tune_optimizer(TUNE_LRS[0]))
    _, m = step_fn(init_fn(), batch)
    first = float(m["loss"])
    del init_fn, step_fn, m
    firsts = [t["losses"][0] for t in trials]
    check(all(abs(x - first) / abs(first) <= TUNE_LOSS_RTOL
              for x in firsts),
          f"first losses {firsts} against the driver's {first}")

    # the best trial's checkpoint reproduces its loss in the driver
    best = grid.get_best_result()
    k = best.metrics["step"]
    ckpt_step = best.checkpoint.metrics().get("step")
    check(ckpt_step == k, f"best result at step {k}, checkpoint of step "
                          f"{ckpt_step}")
    model.load_state_dict(best.checkpoint.to_torch()["params"])
    rows = tokens[(k - 1) * TUNE_BATCH:k * TUNE_BATCH]
    with torch.no_grad():
        loss, _ = lm_loss_fn(model, {"tokens": torch.from_numpy(
            rows).to(dev)}, model.cfg.z_loss)
    again = float(loss)
    check(abs(again - best.metrics["loss"]) / abs(again)
          <= TUNE_LOSS_RTOL,
          f"best checkpoint's loss {again} against the trial's "
          f"{best.metrics['loss']}")
    del model
    torch.cuda.empty_cache()
    t_first = trials[0]["start"]
    launches = {n: sum(h["launches"][n] for t in trials for h in t["hist"])
                for n in kernels}
    return {
        "model": "gpt-small", "n_layers": TUNE_LAYERS, "rows": TUNE_ROWS,
        "batch": TUNE_BATCH, "seq": 1024, "lrs": list(TUNE_LRS),
        "asha": TUNE_ASHA, "concurrent": TUNE_CONCURRENT,
        "gpu_per_trial": 0.5, "sweep_s": sweep_s,
        "trials": [{"lr": t["lr"], "steps": t["steps"], "stop": t["stop"],
                    "start_s": t["start"] - t_first,
                    "end_s": t["end"] - t_first, "losses": t["losses"],
                    "step_ms": [(h["t1"] - h["t0"]) * 1e3
                                for h in t["hist"]]} for t in trials],
        "driver_first_loss": first, "best": {
            "lr": best.metrics["lr"], "step": k,
            "loss": best.metrics["loss"], "driver_loss": again},
        "launches": launches, "launches_per_step": per_step}


def air_batch_phase(dev) -> dict:
    """Batch inference and a sweep on the port's runtime, in a session of
    its own, as the module docstring says: (a) BatchPredictor scores
    ViT-B/16 over a Dataset in two half-card actors, (b) Tuner runs
    JaxTrainer on gpt-small once per learning rate under ASHA, two
    half-card trials at a time."""
    import shutil
    import tempfile

    import torch

    import ray_tpu_torch

    torch.cuda.empty_cache()
    before = _runtime_processes()
    check(not before, f"runtime processes left from before: {before}")
    work = tempfile.mkdtemp(prefix="chip_smoke_air_batch_")
    t0 = time.perf_counter()
    ray_tpu_torch.init(num_cpus=8, object_store_memory=6 << 30)
    node = ray_tpu_torch.api._node
    out = {"init_s": time.perf_counter() - t0,
           "session_dir": node.session_dir}
    try:
        check(ray_tpu_torch.cluster_resources().get("GPU") == 1.0,
              "the raylet did not find the GPU")
        out["predict"] = _predict_phase(dev, work)
        out["tune"] = _tune_phase(dev, work)
    finally:
        ray_tpu_torch.shutdown()
        shutil.rmtree(work, ignore_errors=True)
        deadline = time.monotonic() + 30
        left = _runtime_processes(node.session_dir)
        while left and time.monotonic() < deadline:
            time.sleep(0.5)
            left = _runtime_processes(node.session_dir)
    out["left_after_shutdown"] = left
    out["phase_s"] = time.perf_counter() - t0
    check(not left, f"processes left after shutdown: {left}")
    return out


# Phase rl (see the module docstring): PPO on CartPole-v1 at
# benchmarks/rl_perf.py's settings, the north-star row of RLlib's tuned
# cartpole-ppo.yaml (episode_reward_mean >= 150 within 100k env steps);
# IMPALA at the same file's CartPole settings for RL_IMPALA_ITERS train()
# calls; the Decision Transformer at DTConfig's own widths (d_model 128,
# 3 layers of 4 heads of 32, context 20 = 60 tokens, batch 64, fp32) on
# DT_DATA_STEPS env steps of collect_dataset
RL_PPO = dict(num_rollout_workers=2, num_envs_per_worker=4,
              rollout_fragment_length=125, train_batch_size=1000,
              sgd_minibatch_size=250, num_sgd_iter=8, lr=3e-4,
              entropy_coeff=0.01, gamma=0.99)
RL_IMPALA = dict(num_rollout_workers=2, num_envs_per_worker=4,
                 rollout_fragment_length=50, lr=5e-4, entropy_coeff=0.01,
                 gamma=0.99)
RL_TARGET = 150.0
RL_MAX_STEPS = 100_000
RL_IMPALA_ITERS = 10
# one PPO minibatch step on the card against the same step on CPU copies
# of the weights, the optimizer state and the minibatch, fp32 with TF32
# off: the two differ by summation order alone (~1e-7 relative), and a
# wrong loss or update moves the loss or the weights by far more.  The
# loss relative to the CPU's, each gradient tensor's error relative to
# its largest element, the parameters after the step as one vector
# (_step_check says why not per element), for the learner's real
# step and for a replay of it on the card that also yields the
# gradients.  V-trace on the card against the CPU: fp32 over a 50-step
# recursion, atol and rtol 1e-5
RL_STEP_RTOL = 1e-5
VTRACE_TOL = 1e-5
# DT's first loss through K1-K3 against the plain attention from the same
# weights: each kernel output lies within FLASH_FP32_TOL of its plain
# version (~1e-6 in practice), and the loss averages ~1000 tokens' NLL
# through 3 layers; 1e-4 relative leaves room above the rounding
DT_LOSS_RTOL = 1e-4
DT_DATA_STEPS = 4000
DT_TRAIN_CALLS = 2
DT_BATCH, DT_CONTEXT, DT_HEADS, DT_HEAD_DIM = 64, 20, 4, 32


def _timed(obj, name: str, bucket: list) -> None:
    """Wrap ``obj.name`` (on the instance) to append each call's wall
    seconds to ``bucket``."""
    fn = getattr(obj, name)

    def wrapper(*a, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            bucket.append(time.perf_counter() - t0)
    setattr(obj, name, wrapper)


def _record_first(algo, rec: dict, name: str = "_sgd_step") -> None:
    """Make ``algo.<name>`` (a step ``(opt_state, batch) -> (opt_state,
    aux)``) keep host copies of its first call's weights (and its target
    network's, where the learner has one), optimizer state and batch,
    and of the weights and the 0-d aux it produced (the real step runs
    unchanged)."""
    from ray_tpu_torch.rl.algorithm import to_host
    from ray_tpu_torch.rl.policy import module_weights
    real = getattr(algo, name)

    def step(opt_state, batch):
        if rec:
            return real(opt_state, batch)
        rec.update(weights=algo.get_weights(), opt=to_host(opt_state),
                   batch={k: v.cpu() for k, v in batch.items()})
        if getattr(algo, "target_model", None) is not None:
            rec["target"] = module_weights(algo.target_model)
        opt_state, aux = real(opt_state, batch)
        rec.update(after=algo.get_weights(),
                   aux={k: float(v) for k, v in aux.items() if v.dim() == 0})
        return opt_state, aux
    setattr(algo, name, step)


def _step_replay(algo, rec: dict, device, make_step,
                 make_tx=None) -> dict:
    """The recorded first step again on copies of the network (and the
    target network), the optimizer state and the batch on ``device``,
    through ``make_step(model, target, tx)`` with the learner's optimizer
    (``make_tx(config)``; default ``make_ppo_optimizer``: clip, then
    Adam): its 0-d aux, its gradients and the weights it gives, as host
    numpy."""
    import copy

    from ray_tpu_torch.rl.algorithm import to_device
    from ray_tpu_torch.rl.policy import load_weights, module_weights
    from ray_tpu_torch.rl.ppo import make_ppo_optimizer
    model = copy.deepcopy(algo.model).to(device)
    load_weights(model, rec["weights"])
    target = None
    if "target" in rec:
        target = copy.deepcopy(algo.target_model).to(device)
        load_weights(target, rec["target"])
    tx, grads = (make_tx or make_ppo_optimizer)(algo.config), {}
    update = tx.update

    def capture(params, g, state):
        grads.update({n: t.detach().cpu().numpy() for n, t in g.items()})
        return update(params, g, state)
    tx.update = capture
    step = make_step(model, target, tx)
    _, aux = step(to_device(rec["opt"], device),
                  {k: v.to(device) for k, v in rec["batch"].items()})
    return {"aux": {k: float(v) for k, v in aux.items() if v.dim() == 0},
            "grads": grads, "after": module_weights(model)}


def _step_check(algo, rec: dict, dev, make_step,
                loss_key: str = "total_loss", make_tx=None) -> dict:
    """The learner's real first step, and a replay of it on the card
    that also yields the gradients, against CPU copies: the loss
    relative to the CPU's; each gradient tensor's largest error relative
    to its largest element; the parameters after the step as one vector,
    ||card - cpu|| / ||cpu||.  Per element, Adam's first step is
    lr * g / (|g| + eps): an element whose gradient is near eps can take
    any update in [-lr, lr], and the rounding of its gradient picks it,
    so the parameters are compared as a whole.  Whether the real step
    equals its card replay bit for bit is reported.  The aux values are
    reported too (some sit near 0 at the first step, where relative
    errors say nothing)."""
    import numpy as np
    card = _step_replay(algo, rec, dev, make_step, make_tx)
    cpu = _step_replay(algo, rec, "cpu", make_step, make_tx)
    cpu_loss = cpu["aux"][loss_key]
    norm = sum(float(np.sum(w ** 2)) for w in cpu["after"].values())

    def param_rel_err(after):
        diff = sum(float(np.sum((after[n] - w) ** 2))
                   for n, w in cpu["after"].items())
        return (diff / norm) ** 0.5

    out = {
        "rows": int(rec["batch"]["obs"].shape[0]),
        "card_loss": rec["aux"][loss_key],
        "replay_card_loss": card["aux"][loss_key],
        "cpu_loss": cpu_loss,
        "real_loss_rel_err": abs(rec["aux"][loss_key] - cpu_loss)
        / abs(cpu_loss),
        "loss_rel_err": abs(card["aux"][loss_key] - cpu_loss)
        / abs(cpu_loss),
        "aux_abs_err": {k: abs(card["aux"][k] - v)
                        for k, v in cpu["aux"].items()},
        "grad_rel_err": max(
            float(np.abs(card["grads"][n] - g).max()
                  / max(float(np.abs(g).max()), 1e-30))
            for n, g in cpu["grads"].items()),
        "real_param_rel_err": param_rel_err(rec["after"]),
        "param_rel_err": param_rel_err(card["after"]),
        "param_max_abs_err": max(
            float(np.abs(card["after"][n] - w).max())
            for n, w in cpu["after"].items()),
        "real_equals_card_replay": all(
            np.array_equal(rec["after"][n], w)
            for n, w in card["after"].items())}
    out["max_rel_err"] = max(out[k] for k in (
        "real_loss_rel_err", "loss_rel_err", "grad_rel_err",
        "real_param_rel_err", "param_rel_err"))
    return out


def _ppo_step_check(algo, rec: dict, dev) -> dict:
    """PPO's first minibatch step against CPU copies (``_step_check``)."""
    from ray_tpu_torch.rl import models as M
    from ray_tpu_torch.rl.ppo import make_ppo_sgd_step
    return _step_check(algo, rec, dev, lambda model, _, tx: make_ppo_sgd_step(
        model, M.categorical_logp, M.categorical_entropy, tx, algo.config))


def _check_host(info: dict) -> dict:
    """A rollout actor's ``host_info()``: it leases no GPU, never starts
    CUDA, keeps its policy on the CPU and holds nothing of JAX or
    ray_tpu.  Returns ``info`` with its modules cut to the forbidden
    ones."""
    bad = sorted(set(info.pop("modules")) & set(RUNTIME_FORBIDDEN))
    info["forbidden_loaded"] = bad
    check(info["cuda_visible_devices"] == "" and
          not info["cuda_initialized"] and
          info["policy_device"] == "cpu" and not bad,
          f"a rollout actor reaches CUDA or JAX: {info}")
    return info


def _check_rollout_hosts(algo) -> list:
    """``_check_host`` on every rollout actor of ``algo``."""
    import ray_tpu_torch as rt
    return [_check_host(info) for info in
            rt.get([w.host_info.remote() for w in algo.workers.workers])]


def _ppo_phase(dev) -> dict:
    import math
    import numpy as np
    import torch
    from ray_tpu_torch.rl import PPOConfig
    counters = kernel_counters()
    for c in counters.values():
        c.launches = 0
    t_build = time.perf_counter()
    algo = (PPOConfig().environment("CartPole-v1")
            .rollouts(**{k: RL_PPO[k] for k in (
                "num_rollout_workers", "num_envs_per_worker",
                "rollout_fragment_length")})
            .training(**{k: v for k, v in RL_PPO.items() if k not in (
                "num_rollout_workers", "num_envs_per_worker",
                "rollout_fragment_length")})
            .debugging(seed=SEED).build())
    out = {"build_s": time.perf_counter() - t_build}
    try:
        check(all(p.device.type == dev.type
                  for p in algo.model.parameters()),
              f"the PPO learner is not on {dev}")
        rec, sample_s, sync_s, step_s = {}, [], [], []
        _record_first(algo, rec)
        _timed(algo, "gather_on_policy_batch", sample_s)
        _timed(algo.workers, "sync_weights", sync_s)
        _timed(algo, "training_step", step_s)
        iters, best, reached, t0 = [], -math.inf, None, time.perf_counter()
        while True:
            r = algo.train()
            reward = r["episode_reward_mean"]
            best = max(best, reward)
            iters.append({"timesteps_total": r["timesteps_total"],
                          "episode_reward_mean": reward,
                          "iter_ms": r["time_this_iter_s"] * 1e3,
                          "sample_ms": sample_s[-1] * 1e3,
                          "sgd_ms": (step_s[-1] - sample_s[-1]
                                     - sync_s[-1]) * 1e3,
                          "sync_ms": sync_s[-1] * 1e3,
                          "total_loss": r["info"]["total_loss"]})
            if reward >= RL_TARGET:
                reached = r["timesteps_total"]
                break
            if r["timesteps_total"] >= RL_MAX_STEPS:
                break
        wall = time.perf_counter() - t0
        out.update(
            env_steps_to_target=reached, best_reward=best,
            wall_s=wall, train_iters=len(iters),
            env_steps_per_s=iters[-1]["timesteps_total"] / wall,
            sample_ms_median=statistics.median(i["sample_ms"] for i in iters),
            sgd_ms_median=statistics.median(i["sgd_ms"] for i in iters),
            sync_ms_median=statistics.median(i["sync_ms"] for i in iters),
            iters=iters)
        check(reached is not None and reached <= RL_MAX_STEPS,
              f"PPO did not reach episode_reward_mean {RL_TARGET} within "
              f"{RL_MAX_STEPS} env steps (best {best})")
        out["launches"] = {n: c.launches for n, c in counters.items()}
        check(not any(out["launches"].values()),
              f"a kernel launched on the PPO path: {out['launches']}")
        tf32 = torch.backends.cuda.matmul.allow_tf32
        check(not tf32, "TF32 matmuls are on: the step gate needs fp32")
        out["first_step"] = step = _ppo_step_check(algo, rec, dev)
        check(max(step["real_loss_rel_err"], step["loss_rel_err"],
                  step["grad_rel_err"], step["real_param_rel_err"],
                  step["param_rel_err"]) <= RL_STEP_RTOL,
              f"PPO's first step on the card disagrees with the CPU: "
              f"{step}")
        out["rollout_actors"] = _check_rollout_hosts(algo)
        # save, then other weights and moments, then restore: bit-equal
        t1 = time.perf_counter()
        ckpt = algo.save()
        out["save_s"] = time.perf_counter() - t1
        saved = algo.get_full_state()
        algo.set_weights({n: v + 1 for n, v in algo.get_weights().items()})
        algo.opt_state["mu"]["pi_0.weight"].add_(1.0)
        algo.restore(ckpt)
        back = algo.get_full_state()
        same = all(np.array_equal(back["params"][n], v)
                   for n, v in saved["params"].items()) and all(
            np.array_equal(back["opt_state"][m][n], v)
            for m in ("mu", "nu") for n, v in saved["opt_state"][m].items())
        out["restore_bit_equal"] = same
        check(same and back["opt_state"]["count"]
              == saved["opt_state"]["count"],
              "PPO's restore does not give back the saved state")
    finally:
        algo.stop()
    return out


def _impala_phase(dev) -> dict:
    import math
    import torch
    from ray_tpu_torch.rl import ImpalaConfig, vtrace
    from ray_tpu_torch.rl import models as M
    counters = kernel_counters()
    for c in counters.values():
        c.launches = 0
    split = ("num_rollout_workers", "num_envs_per_worker",
             "rollout_fragment_length")
    algo = (ImpalaConfig().environment("CartPole-v1")
            .rollouts(**{k: RL_IMPALA[k] for k in split})
            .training(**{k: v for k, v in RL_IMPALA.items()
                         if k not in split})
            .debugging(seed=SEED).build())
    try:
        check(all(p.device.type == dev.type
                  for p in algo.model.parameters()),
              f"the IMPALA learner is not on {dev}")
        frag = {}
        real = algo._sgd_step

        def step(opt_state, batch):
            if not frag:
                frag.update({k: v.clone() for k, v in batch.items()})
            return real(opt_state, batch)
        algo._sgd_step = step
        losses, rewards, t0 = [], [], time.perf_counter()
        for _ in range(RL_IMPALA_ITERS):
            r = algo.train()
            losses.append(r["info"]["total_loss"])
            rewards.append(r["episode_reward_mean"])
        wall = time.perf_counter() - t0
        out = {"train_iters": RL_IMPALA_ITERS, "wall_s": wall,
               "timesteps_total": r["timesteps_total"],
               "env_steps_per_s": r["timesteps_total"] / wall,
               "total_losses": losses, "episode_reward_mean": rewards}
        check(all(math.isfinite(x) for x in losses),
              f"an IMPALA loss is not finite: {losses}")
        out["launches"] = {n: c.launches for n, c in counters.items()}
        check(not any(out["launches"].values()),
              f"a kernel launched on the IMPALA path: {out['launches']}")
        # V-trace on the card against the CPU on the first fragment, with
        # the learner's current network
        with torch.no_grad():
            T, B = frag["rewards"].shape
            logits, values = algo.model(frag["obs"].reshape(T * B, -1))
            _, boot = algo.model(frag["bootstrap_obs"])
            target = M.categorical_logp(logits.reshape(T, B, -1),
                                        frag["actions"])
            disc = RL_IMPALA["gamma"] * (1.0 - frag["terminateds"].float())
            args = (target, frag["action_logp"], frag["rewards"],
                    values.reshape(T, B), boot, disc)
            card = vtrace(*args)
            host = vtrace(*(a.cpu() for a in args))
        errs = [compare(c.cpu(), h, atol=VTRACE_TOL, rtol=VTRACE_TOL)
                for c, h in zip(card, host)]
        out["vtrace"] = {"shape": [T, B], "vs": errs[0], "pg_adv": errs[1]}
        check(all(e["finite"] and e["within_tol"] for e in errs),
              f"V-trace on the card disagrees with the CPU: {errs}")
        out["rollout_actors"] = _check_rollout_hosts(algo)
    finally:
        algo.stop()
    return out


def _dt_phase(dev, work: str) -> dict:
    import math
    import torch
    from ray_tpu_torch.rl import DTConfig, JsonReader, collect_dataset
    from ray_tpu_torch.rl.algorithm import to_device
    from ray_tpu_torch.rl.dt import _DTModel, dt_loss
    t0 = time.perf_counter()
    path = str(Path(work) / "dt_data")
    collect_dataset("CartPole-v1", path, n_steps=DT_DATA_STEPS, seed=SEED)
    data = JsonReader(path).read_all()
    out = {"dataset_rows": data.count, "collect_s": time.perf_counter() - t0,
           "episodes": len(data.split_by_episode())}
    check(data.count >= DT_DATA_STEPS, f"the dataset holds {data.count} rows")
    cfg = (DTConfig().environment("CartPole-v1").offline_data(
        input_path=path).debugging(seed=SEED))
    dt = cfg.build()
    mcfg, n_layers = dt.model.cfg, cfg.n_layers
    check(all(p.device.type == dev.type
              for p in dt.model.parameters()),
          f"the DT learner is not on {dev}")
    check((cfg.train_batch_size, cfg.context_len, mcfg.n_heads,
           mcfg.head_dim) == (DT_BATCH, DT_CONTEXT, DT_HEADS, DT_HEAD_DIM),
          f"DT's widths moved: {mcfg}")
    counters = kernel_counters()
    for c in counters.values():
        c.launches = 0
    # the first step's loss through the kernels against the plain
    # attention from the same weights
    batch = to_device(dt._sample_batch(cfg.train_batch_size), dev)
    plain = _DTModel(dt.obs_dim, dt.act_dim, cfg.d_model, n_layers,
                     cfg.n_heads, cfg.context_len, attention_impl="xla",
                     device=dev)
    plain.load_state_dict(dt.model.state_dict())
    with torch.no_grad():
        plain_loss = float(dt_loss(plain, *batch)[0])
    check(not any(c.launches for c in counters.values()),
          "the plain DT forward launched a kernel")
    del plain
    kernel_loss = float(dt.sgd_step(*batch)[0])
    first = {n: c.launches for n, c in counters.items()}
    out["first_step"] = {"kernel_loss": kernel_loss, "plain_loss": plain_loss,
                         "rel_err": abs(kernel_loss - plain_loss)
                         / abs(plain_loss), "launches": first}
    check(out["first_step"]["rel_err"] <= DT_LOSS_RTOL,
          f"DT's first loss through the kernels is {kernel_loss}, the plain "
          f"attention's {plain_loss}")
    want = {n: n_layers if n.startswith("flash_") else 0 for n in first}
    check(first == want, f"one DT step launched {first}, not {want}")
    # two train() calls: K2 and K3 n_layers per SGD step, K1 n_layers per
    # SGD step and per evaluate() forward, K4 and K5 never
    for c in counters.values():
        c.launches = 0
    losses, forwards, eval_k1, evals = [], [0], [], []
    real_step, real_eval = dt.sgd_step, dt.evaluate

    def sgd_step(*a):
        loss, acc = real_step(*a)
        losses.append(loss)
        return loss, acc

    def evaluate(*a, **kw):
        k1 = counters["flash_fwd"].launches
        t1 = time.perf_counter()
        res = real_eval(*a, **kw)
        evals.append(time.perf_counter() - t1)
        eval_k1.append(counters["flash_fwd"].launches - k1)
        return res
    hook = dt.model.register_forward_hook(
        lambda *a: forwards.__setitem__(0, forwards[0] + 1))
    dt.sgd_step, dt.evaluate = sgd_step, evaluate
    results, t1 = [], time.perf_counter()
    try:
        for _ in range(DT_TRAIN_CALLS):
            results.append(dt.train())
    finally:
        hook.remove()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    steps = DT_TRAIN_CALLS * cfg.num_sgd_iter
    launches = {n: c.launches for n, c in counters.items()}
    eval_forwards = forwards[0] - steps
    losses = [float(x) for x in losses]
    head, tail = losses[:10], losses[-10:]
    out.update(
        train_calls=DT_TRAIN_CALLS, sgd_steps=steps, wall_s=wall,
        sgd_ms=(wall - sum(evals)) / steps * 1e3,
        eval_s=evals, eval_forwards=eval_forwards, launches=launches,
        loss_first10=sum(head) / len(head), loss_last10=sum(tail) / len(tail),
        losses=losses,
        results=[{"loss": r["info"]["loss"],
                  "action_accuracy": r["info"]["action_accuracy"],
                  "target_return": r["info"]["target_return"],
                  "episode_reward_mean": r["episode_reward_mean"]}
                 for r in results])
    want = {n: 0 for n in launches}
    want.update(flash_fwd=n_layers * (steps + eval_forwards),
                flash_bwd_dq=n_layers * steps,
                flash_bwd_dkv=n_layers * steps)
    check(launches == want, f"DT's train() calls launched {launches}, "
                            f"not {want}")
    check(all(k > 0 for k in eval_k1) and eval_forwards > 0,
          f"evaluate() launched K1 {eval_k1} times")
    check(all(math.isfinite(r["episode_reward_mean"]) for r in results),
          "DT's evaluate() reward is not finite")
    check(all(math.isfinite(x) for x in losses) and
          out["loss_last10"] < out["loss_first10"],
          f"DT's loss did not fall: {out['loss_first10']} -> "
          f"{out['loss_last10']}")
    return out


def rl_phase(dev) -> dict:
    """RL on the port's runtime, in a session of its own, as the module
    docstring says: (a) PPO to the CartPole-v1 target, (b) IMPALA, (c)
    the Decision Transformer through K1-K3 at head_dim 32."""
    import shutil
    import tempfile

    import torch

    import ray_tpu_torch

    torch.cuda.empty_cache()
    before = _runtime_processes()
    check(not before, f"runtime processes left from before: {before}")
    work = tempfile.mkdtemp(prefix="chip_smoke_rl_")
    t0 = time.perf_counter()
    ray_tpu_torch.init(num_cpus=8)
    node = ray_tpu_torch.api._node
    out = {"init_s": time.perf_counter() - t0,
           "session_dir": node.session_dir}
    try:
        out["ppo"] = _ppo_phase(dev)
        out["impala"] = _impala_phase(dev)
        out["dt"] = _dt_phase(dev, work)
    finally:
        ray_tpu_torch.shutdown()
        shutil.rmtree(work, ignore_errors=True)
        deadline = time.monotonic() + 30
        left = _runtime_processes(node.session_dir)
        while left and time.monotonic() < deadline:
            time.sleep(0.5)
            left = _runtime_processes(node.session_dir)
    out["left_after_shutdown"] = left
    out["phase_s"] = time.perf_counter() - t0
    check(not left, f"processes left after shutdown: {left}")
    return out


def rl_launches(rl: dict, kind: str) -> dict:
    """A kernel's launches on the rl phase's three paths."""
    return {f"rl_{part}": rl[part]["launches"][kind]
            for part in ("ppo", "impala", "dt")}


# Phase rl_replay (see the module docstring): the replay and asynchronous
# families on CartPole-v1 at each algorithm's own config widths, uncut,
# in a runtime session of their own.  (a) DQN at DQNConfig's defaults
# (hidden 256 x 256, dueling, double-Q, Adam 5e-4), rollouts as
# tests/test_rl.py's DQN case (2 actors x 2 envs, fragment 64) and these
# training settings: TD steps of 256 rows, 128 of them per 256 sampled
# env steps, the target synced every 256 env steps (each iteration),
# epsilon from 1 to 0.02 over 2,500 env steps, the global-norm clip at 10
# (the config's default 0.5 is PPO's); the target is RLlib's
# cartpole-dqn.yaml row (150 within 100,000 env steps).  Half the TD
# steps, of 128 rows, fell short on the card once (best 121.48) and in
# two of five seeds on the CPU (PERF.md, Findings).  (b) Ape-X at
# ApexDQNConfig's defaults (4 actors, PER) for RR_APEX_ITERS train()
# calls.  (c) R2D2 at R2D2Config's
# defaults (LSTM 64, sequences of 40, burn-in 8) with 2 actors x 4 envs
# for RR_R2D2_ITERS calls.  (d) APPO at APPOConfig's defaults with 2
# actors x 4 envs for RR_APPO_ITERS calls.  (e) IMPALA and PPO through
# .podracer() at benchmarks/rl_podracer.py's fleet.  (f)
# Tuner(PPO.as_trainable(cfg)) over RR_TUNE_LRS at phase rl's PPO
# settings, two half-card trials of RR_TUNE_ITERS iterations.
RR_DQN = dict(num_rollout_workers=2, num_envs_per_worker=2,
              rollout_fragment_length=64, train_batch_size=256,
              n_updates_per_iter=128, target_update_freq=256,
              epsilon_timesteps=2500, grad_clip=10.0)
RR_APEX_ITERS = 10
RR_R2D2 = dict(num_rollout_workers=2, num_envs_per_worker=4)
RR_R2D2_ITERS = 12
RR_APPO = dict(num_rollout_workers=2, num_envs_per_worker=4)
RR_APPO_ITERS = 10
RR_PODRACER = {
    "impala": dict(num_rollout_workers=2, rollout_fragment_length=10,
                   batches_per_step=16),
    "ppo": dict(num_rollout_workers=2, rollout_fragment_length=40,
                train_batch_size=160, sgd_minibatch_size=80,
                num_sgd_iter=2)}
RR_PODRACER_ITERS = 10
RR_PODRACER_KILL_AT = 4          # IMPALA: kill actor 0 after this call
RR_TUNE_LRS = (3e-4, 1e-4)
RR_TUNE_ITERS = 3
# Ape-X's ladder, the JAX package's formula: eps^(1 + i alpha / (N - 1))
RR_APEX_LADDER = [0.4 ** (1.0 + i * 7.0 / 3) for i in range(4)]
_ROLLOUT_KEYS = ("num_rollout_workers", "num_envs_per_worker",
                 "rollout_fragment_length")


def _rl_config(cls, settings: dict, env: str = "CartPole-v1"):
    """``cls()`` on ``env`` with ``settings`` split into rollout and
    training settings, seed SEED."""
    return (cls().environment(env)
            .rollouts(**{k: v for k, v in settings.items()
                         if k in _ROLLOUT_KEYS})
            .training(**{k: v for k, v in settings.items()
                         if k not in _ROLLOUT_KEYS})
            .debugging(seed=SEED))


def _zeroed_counters() -> dict:
    counters = kernel_counters()
    for c in counters.values():
        c.launches = 0
    return counters


def _on_card(algo, dev, name: str) -> None:
    check(all(p.device.type == dev.type for p in algo.model.parameters()),
          f"the {name} learner is not on {dev}")


def _no_launches(counters: dict, name: str) -> dict:
    launches = {n: c.launches for n, c in counters.items()}
    check(not any(launches.values()),
          f"a kernel launched on the {name} path: {launches}")
    return launches


def _flat(module):
    import torch
    return torch.cat([p.detach().reshape(-1) for p in module.parameters()])


def _dqn_part(dev) -> dict:
    import math

    import torch
    from ray_tpu_torch.rl import DQNConfig
    from ray_tpu_torch.rl.dqn import make_dqn_td_step
    counters = _zeroed_counters()
    t_build = time.perf_counter()
    algo = _rl_config(DQNConfig, RR_DQN).build()
    out = {"build_s": time.perf_counter() - t_build}
    try:
        _on_card(algo, dev, "DQN")
        cfg = algo.config
        check((tuple(cfg.hidden), cfg.dueling, cfg.double_q, cfg.lr) ==
              ((256, 256), True, True, 5e-4),
              f"DQN's config widths moved: {cfg.to_dict()}")
        rec, td_s, sync_s, step_s = {}, [], [], []
        _record_first(algo, rec, "_td_step")
        _timed(algo, "_replay_updates", td_s)
        _timed(algo.workers, "sync_weights", sync_s)
        _timed(algo, "training_step", step_s)
        # the target holds still over the TD steps between two syncs, and
        # a sync makes it an equal copy of the online network
        real_sync, held = algo.sync_target, []
        last = [_flat(algo.target_model).clone()]

        def sync_target():
            held.append(torch.equal(last[0], _flat(algo.target_model)))
            real_sync()
            check(torch.equal(_flat(algo.target_model), _flat(algo.model)),
                  "DQN's target differs from the online network right "
                  "after a sync")
            last[0] = _flat(algo.target_model).clone()
        algo.sync_target = sync_target
        iters, best, reached = [], -math.inf, None
        t0 = time.perf_counter()
        while True:
            n_td = len(td_s)
            r = algo.train()
            reward = r["episode_reward_mean"]
            if not math.isnan(reward):
                best = max(best, reward)
            trained = len(td_s) > n_td
            td = td_s[-1] if trained else 0.0
            iters.append({"timesteps_total": r["timesteps_total"],
                          "episode_reward_mean": reward,
                          "iter_ms": r["time_this_iter_s"] * 1e3,
                          "td_ms": td * 1e3,
                          "sync_ms": sync_s[-1] * 1e3 if trained else 0.0,
                          "sample_ms": (step_s[-1] - td - (
                              sync_s[-1] if trained else 0.0)) * 1e3,
                          "loss": r["info"].get("loss")})
            if reward >= RL_TARGET:
                reached = r["timesteps_total"]
                break
            if r["timesteps_total"] >= RL_MAX_STEPS:
                break
        wall = time.perf_counter() - t0
        trained = [i for i in iters if i["td_ms"]]
        out.update(
            env_steps_to_target=reached, best_reward=best, wall_s=wall,
            train_iters=len(iters), target_syncs=len(held),
            env_steps_per_s=iters[-1]["timesteps_total"] / wall,
            td_steps=len(trained) * cfg.n_updates_per_iter,
            td_ms_per_step=statistics.median(
                i["td_ms"] for i in trained) / cfg.n_updates_per_iter,
            sample_ms_median=statistics.median(
                i["sample_ms"] for i in iters),
            sync_ms_median=statistics.median(i["sync_ms"] for i in trained),
            iters=iters)
        check(reached is not None and reached <= RL_MAX_STEPS,
              f"DQN did not reach episode_reward_mean {RL_TARGET} within "
              f"{RL_MAX_STEPS} env steps (best {best})")
        out["target_held"] = sum(held)
        check(held and all(held), f"DQN's target moved between two syncs "
                                  f"({held.count(False)} of {len(held)})")
        out["launches"] = _no_launches(counters, "DQN")
        check(not torch.backends.cuda.matmul.allow_tf32,
              "TF32 matmuls are on: the step gate needs fp32")
        out["first_step"] = step = _step_check(
            algo, rec, dev, lambda model, target, tx: make_dqn_td_step(
                model, target, tx, cfg), loss_key="loss")
        check(step["max_rel_err"] <= RL_STEP_RTOL,
              f"DQN's first TD step on the card disagrees with the CPU: "
              f"{step}")
        out["rollout_actors"] = _check_rollout_hosts(algo)
    finally:
        algo.stop()
    return out


def _per_sync_cost(algo, reps: int = 50) -> dict:
    """What the PER priority fetch costs a TD step: ``reps`` steps of the
    learner's TD step on copies of its networks and optimizer state,
    fetching ``|td_error|`` to the host after each (as the learner does)
    or only once at the end, in turns (without, with, with, without)."""
    import copy

    import numpy as np
    import torch
    from ray_tpu_torch.rl.algorithm import to_device, to_host
    from ray_tpu_torch.rl.dqn import DQN_KEYS, make_dqn_td_step
    from ray_tpu_torch.rl.ppo import make_ppo_optimizer
    model = copy.deepcopy(algo.model)
    target = copy.deepcopy(algo.target_model)
    tx = make_ppo_optimizer(algo.config)
    opt = to_device(to_host(algo.opt_state), algo.device)
    step = make_dqn_td_step(model, target, tx, algo.config)
    batch = algo.stage_batch(algo.buffer.sample(
        algo.round_minibatch(algo.config.train_batch_size)), DQN_KEYS)
    opt, _ = step(opt, batch)
    torch.cuda.synchronize()
    times = {False: [], True: []}
    for fetch in (False, True, True, False):
        t0 = time.perf_counter()
        for _ in range(reps):
            opt, aux = step(opt, batch)
            if fetch:
                np.abs(aux["td_error"].cpu().numpy())
        torch.cuda.synchronize()
        times[fetch].append((time.perf_counter() - t0) / reps * 1e3)
    no_fetch, fetch = min(times[False]), min(times[True])
    return {"reps": reps, "td_ms_no_fetch": no_fetch,
            "td_ms_fetch_each": fetch, "fetch_ms": fetch - no_fetch,
            "runs": {"no_fetch": times[False], "fetch_each": times[True]}}


def _apex_part(dev) -> dict:
    import math

    import numpy as np
    from ray_tpu_torch.rl import ApexDQNConfig
    counters = _zeroed_counters()
    algo = (ApexDQNConfig().environment("CartPole-v1")
            .debugging(seed=SEED).build())
    try:
        _on_card(algo, dev, "Ape-X")
        eps = algo._epsilons
        out = {"epsilons": eps, "formula": RR_APEX_LADDER}
        check(eps == RR_APEX_LADDER and all(
            a > b for a, b in zip(eps, eps[1:])),
            f"Ape-X's epsilon ladder {eps} is not {RR_APEX_LADDER}, "
            "strictly falling")
        td_s, pri_s, losses = [], [], []
        _timed(algo, "_replay_updates", td_s)
        _timed(algo.buffer, "update_priorities", pri_s)
        t0 = time.perf_counter()
        for _ in range(RR_APEX_ITERS):
            r = algo.train()
            if "loss" in r["info"]:
                losses.append(r["info"]["loss"])
        wall = time.perf_counter() - t0
        buf = algo.buffer
        leaves = buf._tree[buf._tree_size:][:len(buf)]
        n_upd = algo.config.n_updates_per_iter
        out.update(
            train_iters=RR_APEX_ITERS, wall_s=wall,
            timesteps_total=r["timesteps_total"],
            env_steps_per_s=r["timesteps_total"] / wall,
            buffer_size=len(buf), losses=losses,
            distinct_priorities=int(len(np.unique(leaves))),
            td_iters=len(td_s),
            td_ms_per_step=statistics.median(td_s) / n_upd * 1e3
            if td_s else None,
            priority_update_ms_per_step=statistics.median(pri_s) * 1e3
            if pri_s else None)
        check(losses and all(math.isfinite(x) for x in losses),
              f"Ape-X's losses are not finite (or none): {losses}")
        check(out["distinct_priorities"] > 1, "Ape-X's priorities never "
                                              "moved from the initial one")
        out["launches"] = _no_launches(counters, "Ape-X")
        out["per_sync"] = _per_sync_cost(algo)
        out["rollout_actors"] = _check_rollout_hosts(algo)
    finally:
        algo.stop()
    return out


def _r2d2_part(dev) -> dict:
    import math

    from ray_tpu_torch.rl import R2D2Config
    from ray_tpu_torch.rl.r2d2 import make_r2d2_td_step
    counters = _zeroed_counters()
    algo = _rl_config(R2D2Config, RR_R2D2).build()
    try:
        _on_card(algo, dev, "R2D2")
        cfg = algo.config
        check((cfg.lstm_size, cfg.rollout_fragment_length, cfg.burn_in) ==
              (64, 40, 8), f"R2D2's config widths moved: {cfg.to_dict()}")
        rec, td_s, infos = {}, [], []
        _record_first(algo, rec, "_td_step")
        _timed(algo, "_replay_updates", td_s)
        t0 = time.perf_counter()
        for _ in range(RR_R2D2_ITERS):
            r = algo.train()
            infos.append(r["info"])
        wall = time.perf_counter() - t0
        trained = [i for i in infos if "trained_steps" in i]
        out = {"train_iters": RR_R2D2_ITERS, "wall_s": wall,
               "timesteps_total": r["timesteps_total"],
               "env_steps_per_s": r["timesteps_total"] / wall,
               "td_iters": len(td_s),
               "td_ms_per_step": statistics.median(td_s)
               / cfg.n_updates_per_iter * 1e3 if td_s else None,
               "trained_steps": [i["trained_steps"] for i in trained],
               "losses": [i["loss"] for i in trained]}
        check(trained and all(i["trained_steps"] > 0 for i in trained)
              and all(math.isfinite(i["loss"]) for i in trained),
              f"R2D2 trained on no step, or a loss is not finite: {out}")
        out["launches"] = _no_launches(counters, "R2D2")
        out["first_step"] = step = _step_check(
            algo, rec, dev, lambda model, target, tx: make_r2d2_td_step(
                model, target, tx, cfg), loss_key="loss")
        check(step["max_rel_err"] <= RL_STEP_RTOL,
              f"R2D2's first TD step on the card disagrees with the CPU: "
              f"{step}")
        out["rollout_actors"] = _check_rollout_hosts(algo)
    finally:
        algo.stop()
    return out


def _appo_part(dev) -> dict:
    import math

    from ray_tpu_torch.rl import APPOConfig
    from ray_tpu_torch.rl import models as M
    from ray_tpu_torch.rl.appo import make_appo_sgd_step
    counters = _zeroed_counters()
    algo = _rl_config(APPOConfig, RR_APPO).build()
    try:
        _on_card(algo, dev, "APPO")
        cfg = algo.config
        rec, infos = {}, []
        _record_first(algo, rec, "_appo_step")
        t0 = time.perf_counter()
        for _ in range(RR_APPO_ITERS):
            infos.append(algo.train()["info"])
        wall = time.perf_counter() - t0
        r = algo.iteration
        out = {"train_iters": r, "wall_s": wall,
               "timesteps_total": algo._timesteps_total,
               "env_steps_per_s": algo._timesteps_total / wall,
               "learner_steps": algo._learner_steps,
               "mean_ratio": [i["mean_ratio"] for i in infos],
               "total_losses": [i["total_loss"] for i in infos]}
        check(all(x > 0 for x in out["mean_ratio"]) and all(
            math.isfinite(x) for x in out["total_losses"]),
            f"APPO's mean_ratio or loss is off: {out}")
        out["launches"] = _no_launches(counters, "APPO")
        out["first_step"] = step = _step_check(
            algo, rec, dev, lambda model, target, tx: make_appo_sgd_step(
                model, target, M.categorical_logp, M.categorical_entropy,
                tx, cfg))
        check(step["max_rel_err"] <= RL_STEP_RTOL,
              f"APPO's first step on the card disagrees with the CPU: "
              f"{step}")
        out["rollout_actors"] = _check_rollout_hosts(algo)
    finally:
        algo.stop()
    return out


def counted_learner_class():
    """The podracer's LearnerActor with one read-only method, ``probe``:
    its process's kernel launches, the cards it may see, its device and
    where its parameters live."""
    from ray_tpu_torch.rl.podracer.learner import LearnerActor

    class CountedLearner(LearnerActor):
        def probe(self) -> dict:
            import os
            return {"launches": {n: c.launches
                                 for n, c in kernel_counters().items()},
                    "cuda_visible_devices":
                        os.environ.get("CUDA_VISIBLE_DEVICES"),
                    "device": str(self.device),
                    "param_devices": sorted({p.device.type for p in
                                             self.model.parameters()})}
    return CountedLearner


def _podracer_run(dev, name: str) -> dict:
    import numpy as np

    import ray_tpu_torch
    from ray_tpu_torch.rl import ImpalaConfig, PPOConfig
    from ray_tpu_torch.rl.podracer import learner as podracer_learner
    cls = counted_learner_class()
    real = podracer_learner.learner_actor_class

    def counted(num_cpus: float = 1.0, num_gpus: float = 0.0):
        return ray_tpu_torch.remote(num_cpus=num_cpus,
                                    num_gpus=num_gpus)(cls)
    podracer_learner.learner_actor_class = counted
    try:
        cfg = _rl_config(ImpalaConfig if name == "impala" else PPOConfig,
                         RR_PODRACER[name]).podracer()
        t_build = time.perf_counter()
        algo = cfg.build()
    finally:
        podracer_learner.learner_actor_class = real
    out = {"build_s": time.perf_counter() - t_build}
    ex = algo.podracer
    # each stream's first fragment reports its actor's process (the
    # actor runs its stream and takes no other call)
    hosts, observe = {}, ex._observe_result

    def observe_hosts(result, meta):
        if "host" in meta:
            hosts.setdefault(meta["worker_index"], []).append(meta["host"])
        return observe(result, meta)
    ex._observe_result = observe_hosts
    try:
        probe = ray_tpu_torch.get(ex.learner.probe.remote())
        check(probe["device"].startswith(dev.type) and
              probe["param_devices"] == [dev.type] and
              probe["cuda_visible_devices"] not in (None, ""),
              f"the podracer learner is not on a leased card: {probe}")
        iters, killed = [], None
        t0 = time.perf_counter()
        for i in range(RR_PODRACER_ITERS):
            r = algo.train()
            iters.append({"timesteps_total": r["timesteps_total"],
                          "iter_ms": r["time_this_iter_s"] * 1e3,
                          "weight_version": r["info"]["weight_version"],
                          "replacements": r["info"]["replacements"]})
            if name == "impala" and i + 1 == RR_PODRACER_KILL_AT:
                killed = ex._slots[0]["actor"]
                ray_tpu_torch.kill(killed)
        if killed is not None:
            # the replacement streams: its first fragment reports its host
            while len(hosts.get(0, ())) < 2 and \
                    len(iters) < 2 * RR_PODRACER_ITERS:
                r = algo.train()
                iters.append({"timesteps_total": r["timesteps_total"],
                              "iter_ms": r["time_this_iter_s"] * 1e3,
                              "weight_version": r["info"]["weight_version"],
                              "replacements": r["info"]["replacements"]})
        wall = time.perf_counter() - t0
        tel = ex.telemetry
        out.update(
            train_iters=len(iters), wall_s=wall, iters=iters,
            frames=tel["frames"], env_frames_per_s=tel["frames"] / wall,
            learner_steps=tel["learner_steps"],
            versions_published=tel["versions_published"],
            classic_submits_steady=tel["classic_submits_steady"],
            slot_versions=[s["version"] for s in ex._slots],
            weight_publish_ms_median=statistics.median(
                tel["weight_publish_ms"]),
            weight_pull_ms_median=statistics.median(tel["weight_pull_ms"]),
            weight_pulls=len(tel["weight_pull_ms"]),
            weight_adoption_s_median=statistics.median(
                tel["weight_adoption_s"]),
            replacements=tel["replacements"],
            total_loss=r["info"]["total_loss"])
        check(tel["classic_submits_steady"] == 0,
              f"the podracer's steady state submitted classic tasks: "
              f"{tel['classic_submits_steady']}")
        check(all(v >= 2 for v in out["slot_versions"]),
              f"an actor never adopted a published weight version: "
              f"{out['slot_versions']}")
        if killed is not None:
            before = [it["iter_ms"] for it in iters[:RR_PODRACER_KILL_AT]]
            after = [it["iter_ms"] for it in iters[RR_PODRACER_KILL_AT:]]
            out["kill"] = {"after_iter": RR_PODRACER_KILL_AT,
                           "largest_gap_ms": max(after),
                           "median_before_ms": statistics.median(before)}
            check(tel["replacements"] >= 1 and ex._slots[0]["actor"]
                  is not killed, "the killed rollout actor was not replaced")
        out["rollout_actors"] = hosts
        check(sorted(hosts) == list(range(len(ex._slots))) and (
            killed is None or len(hosts[0]) >= 2),
            f"streams reported hosts {sorted(hosts)} for "
            f"{len(ex._slots)} slots (the replacement's too)")
        for reports in hosts.values():
            for info in reports:
                _check_host(info)
        # save, then other weights, then restore: bit-equal
        ckpt = algo.save()
        saved = algo.get_full_state()
        algo.set_weights({n: v + 1 for n, v in algo.get_weights().items()})
        algo.restore(ckpt)
        back = algo.get_full_state()
        same = all(np.array_equal(back["params"][n], v)
                   for n, v in saved["params"].items()) and all(
            np.array_equal(back["opt_state"][m][n], v)
            for m in saved["opt_state"] if m != "count"
            for n, v in saved["opt_state"][m].items()) and all(
            back[k] == saved[k] for k in ("_step_no", "_frames"))
        out["restore_bit_equal"] = same
        check(same and back["opt_state"]["count"]
              == saved["opt_state"]["count"],
              f"the podracer {name} restore does not give back the saved "
              "state")
        probe = ray_tpu_torch.get(ex.learner.probe.remote())
        out["launches"] = probe["launches"]
        check(not any(probe["launches"].values()),
              f"a kernel launched in the podracer learner: {probe}")
    finally:
        algo.stop()
    return out


def counted_ppo_class():
    """PPO whose ``train()`` result also carries its process's kernel
    launches, the cards it may see, its learner's device and its pid."""
    from ray_tpu_torch.rl import PPO

    class CountedPPO(PPO):
        def train(self):
            import os
            result = super().train()
            result["probe"] = {
                "launches": {n: c.launches
                             for n, c in kernel_counters().items()},
                "cuda_visible_devices":
                    os.environ.get("CUDA_VISIBLE_DEVICES"),
                "device": str(self.device), "pid": os.getpid()}
            return result
    return CountedPPO


def _as_trainable_part(dev, work: str) -> dict:
    from ray_tpu_torch import tune
    from ray_tpu_torch.air import RunConfig
    from ray_tpu_torch.rl import PPOConfig
    cls = counted_ppo_class()
    cfg = _rl_config(PPOConfig, RL_PPO)
    cfg.algo_class = cls
    tuner = tune.Tuner(
        cls.as_trainable(cfg),
        param_space={"lr": tune.grid_search(list(RR_TUNE_LRS))},
        tune_config=tune.TuneConfig(
            metric="episode_reward_mean", mode="max",
            trial_resources={"CPU": 1, "GPU": 0.5}),
        run_config=RunConfig(name="rl_as_trainable", storage_path=work,
                             stop={"training_iteration": RR_TUNE_ITERS}))
    t0 = time.perf_counter()
    grid = tuner.fit()
    out = {"sweep_s": time.perf_counter() - t0}
    check(not grid.errors, f"as_trainable trials failed: {grid.errors}")
    check(len(grid) == len(RR_TUNE_LRS), f"{len(grid)} trials")
    trials = []
    for r in grid:
        m, probe = r.metrics, r.metrics["probe"]
        trials.append({"lr": r.config["lr"],
                       "training_iteration": m["training_iteration"],
                       "timesteps_total": m["timesteps_total"],
                       "episode_reward_mean": m["episode_reward_mean"],
                       "checkpoint": r.checkpoint is not None, **probe})
        ckpt = r.checkpoint.to_dict() if r.checkpoint is not None else {}
        check(m["training_iteration"] == RR_TUNE_ITERS
              and ckpt.get("iteration") == RR_TUNE_ITERS,
              f"trial lr {r.config['lr']} reported {m['training_iteration']}"
              f" iterations, checkpoint {ckpt.get('iteration')}")
        check(probe["device"].startswith(dev.type) and
              probe["cuda_visible_devices"] not in (None, "") and
              not any(probe["launches"].values()),
              f"trial lr {r.config['lr']}: {probe}")
    check({t["lr"] for t in trials} == set(RR_TUNE_LRS),
          f"trials {[t['lr'] for t in trials]}")
    out["trials"] = trials
    out["launches"] = {n: sum(t["launches"][n] for t in trials)
                       for n in kernel_counters()}
    return out


def rl_replay_phase(dev) -> dict:
    """The replay and asynchronous RL families on the port's runtime, in a
    session of its own, as the module docstring says: (a) DQN to the
    CartPole-v1 target, (b) Ape-X, (c) R2D2, (d) APPO, (e) IMPALA and
    PPO through the podracer executor, (f) Tuner(PPO.as_trainable)."""
    import shutil
    import tempfile

    import torch

    import ray_tpu_torch

    torch.cuda.empty_cache()
    before = _runtime_processes()
    check(not before, f"runtime processes left from before: {before}")
    work = tempfile.mkdtemp(prefix="chip_smoke_rl_replay_")
    t0 = time.perf_counter()
    ray_tpu_torch.init(num_cpus=8)
    node = ray_tpu_torch.api._node
    out = {"init_s": time.perf_counter() - t0,
           "session_dir": node.session_dir}
    try:
        for part, run in (("dqn", _dqn_part), ("apex", _apex_part),
                          ("r2d2", _r2d2_part), ("appo", _appo_part)):
            t1 = time.perf_counter()
            out[part] = run(dev)
            out[part]["part_s"] = time.perf_counter() - t1
        for name in RR_PODRACER:
            t1 = time.perf_counter()
            out[f"podracer_{name}"] = _podracer_run(dev, name)
            out[f"podracer_{name}"]["part_s"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        out["as_trainable"] = _as_trainable_part(dev, work)
        out["as_trainable"]["part_s"] = time.perf_counter() - t1
    finally:
        ray_tpu_torch.shutdown()
        shutil.rmtree(work, ignore_errors=True)
        deadline = time.monotonic() + 30
        left = _runtime_processes(node.session_dir)
        while left and time.monotonic() < deadline:
            time.sleep(0.5)
            left = _runtime_processes(node.session_dir)
    out["left_after_shutdown"] = left
    out["phase_s"] = time.perf_counter() - t0
    check(not left, f"processes left after shutdown: {left}")
    return out


RR_PARTS = ("dqn", "apex", "r2d2", "appo", "podracer_impala",
            "podracer_ppo", "as_trainable")


def rl_replay_launches(rr: dict, kind: str) -> dict:
    """A kernel's launches on the rl_replay phase's paths."""
    return {f"rl_{part}": rr[part]["launches"][kind] for part in RR_PARTS}


# ---------------------------------------------------------- rl_continuous
# (a) SAC with tests/test_rl.py:268-279's settings at SACConfig's widths
# (256 x 256; the test narrows them to 64 x 64) and that test's gate
# (:286): the best of the last 8 iterations' episode_reward_mean above
# the first by RC_SAC_GAIN.  (b) DDPG and TD3 at DDPGConfig's widths, 2
# actors x 1 env, fragment 64, RC_DDPG_ITERS calls.  (c) PG, A2C and A3C
# at their configs' defaults with 2 actors x 2 envs on CartPole-v1, A3C
# for RC_A3C_ITERS calls of 8 fragments.  (d) CQL and CRR at their
# defaults (batch 256, 64 updates a call, 4 sampled actions) on an
# RC_OFFLINE_STEPS-step Pendulum-v1 dataset of collect_dataset.  Every
# first update is replayed on the card and on the CPU from copies of the
# state, the batch and the recorded noise, and held at RL_STEP_RTOL.
RC_SAC = dict(num_rollout_workers=2, num_envs_per_worker=1,
              rollout_fragment_length=128, lr=1e-3, train_batch_size=128,
              buffer_size=50_000, learning_starts=500,
              n_updates_per_iter=128)
RC_SAC_ITERS = 44
RC_SAC_GAIN = 250.0
RC_DDPG = dict(num_rollout_workers=2, num_envs_per_worker=1,
               rollout_fragment_length=64, learning_starts=256,
               train_batch_size=256, n_updates_per_iter=32)
RC_DDPG_ITERS = 8
RC_AC = dict(num_rollout_workers=2, num_envs_per_worker=2)
RC_AC_ITERS = 5
RC_A3C_ITERS = 3
RC_OFFLINE_STEPS = 10_000
RC_OFFLINE_SEED = 2
RC_OFFLINE_CALLS = 3
RC_PARTS = ("sac", "ddpg", "td3", "pg", "a2c", "a3c", "cql", "crr")


def _timed_sync(obj, name: str, bucket: list) -> None:
    """Wrap ``obj.name`` to append each call's wall seconds, up to the
    end of its device work (a synchronize after each call), to
    ``bucket``."""
    import torch
    fn = getattr(obj, name)

    def wrapper(*a, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            torch.cuda.synchronize()
            bucket.append(time.perf_counter() - t0)
    setattr(obj, name, wrapper)


def _ms_stats(seconds: list) -> dict:
    """Median and 90th percentile of a list of seconds, in ms."""
    ms = sorted(x * 1e3 for x in seconds)
    return {"n": len(ms), "median": statistics.median(ms),
            "p90": ms[min(len(ms) - 1, int(0.9 * len(ms)))]}


def _state_weights(state: dict) -> dict:
    """The modules and parameters of a learner's ``state`` as host numpy
    (module name -> state-dict name -> array; a parameter as one array
    under its own name)."""
    import torch
    from ray_tpu_torch.rl.policy import module_weights
    out = {}
    for k, v in state.items():
        if isinstance(v, torch.nn.Module):
            out[k] = module_weights(v)
        elif isinstance(v, torch.Tensor):
            out[k] = {k: v.detach().cpu().numpy().copy()}
    return out


def _same_tree(a, b) -> bool:
    """Two snapshots (nested dicts of arrays and numbers) equal bit for
    bit, key for key."""
    import numpy as np
    if isinstance(b, dict):
        return isinstance(a, dict) and set(a) == set(b) and all(
            _same_tree(a[k], v) for k, v in b.items())
    if isinstance(b, np.ndarray):
        return isinstance(a, np.ndarray) and a.dtype == b.dtype and \
            np.array_equal(a, b)
    return a == b


def _state_on_card(algo, dev, name: str) -> None:
    import torch
    check(all(t.device.type == dev.type for v in algo.state.values()
              if isinstance(v, (torch.nn.Module, torch.Tensor))
              for t in (v.parameters() if isinstance(v, torch.nn.Module)
                        else [v])),
          f"the {name} learner is not on {dev}")


def _state_to(state: dict, device) -> dict:
    """A copy of a learner's ``state`` dict on ``device``: modules
    deep-copied, parameters and optimizer states copied."""
    import copy

    import torch
    from ray_tpu_torch.rl.algorithm import to_device

    def one(v):
        if isinstance(v, torch.nn.Module):
            return copy.deepcopy(v).to(device)
        if isinstance(v, torch.nn.Parameter):
            return torch.nn.Parameter(v.detach().to(device, copy=True))
        return to_device(v, device)
    return {k: one(v) for k, v in state.items()}


def _record_updates(algo, recs: list, n: int = 1) -> None:
    """Make ``algo._update`` (``update(state, batch, noise, *rest) ->
    aux``) keep CPU copies of its first ``n`` calls' state, batch,
    noise and other arguments, and of the weights and 0-d aux they gave
    (the real updates run unchanged)."""
    from ray_tpu_torch.rl.algorithm import to_device
    real = algo._update

    def update(state, batch, noise, *rest):
        if len(recs) >= n:
            return real(state, batch, noise, *rest)
        rec = {"state": _state_to(state, "cpu"),
               "batch": to_device(batch, "cpu"),
               "noise": to_device(noise, "cpu"), "rest": rest}
        aux = real(state, batch, noise, *rest)
        rec.update(after=_state_weights(state),
                   aux={k: float(v) for k, v in aux.items()})
        recs.append(rec)
        return aux
    algo._update = update


def _update_replay(rec: dict, device, make_update) -> dict:
    """A recorded update again on copies of its state, batch and noise on
    ``device`` through ``make_update(device)``: its aux and the weights
    it gives."""
    from ray_tpu_torch.rl.algorithm import to_device
    state = _state_to(rec["state"], device)
    aux = make_update(device)(state, to_device(rec["batch"], device),
                              to_device(rec["noise"], device),
                              *rec["rest"])
    return {"aux": {k: float(v) for k, v in aux.items()},
            "after": _state_weights(state)}


def _update_check(rec: dict, dev, make_update,
                  loss_key: str = "critic_loss") -> dict:
    """A learner's real update, and a replay of it on the card, against
    the same update on CPU copies of its state, batch and noise: the
    loss relative to the CPU's, and each network (the targets and the
    log temperature too) after the update as one vector, ||card - cpu||
    / ||cpu|| (``_step_check`` says why not per element); whether the
    real update equals its card replay bit for bit.  The other aux
    values are reported as absolute errors (some sit near 0 at the first
    update)."""
    import numpy as np
    card = _update_replay(rec, dev, make_update)
    cpu = _update_replay(rec, "cpu", make_update)

    def rel_errs(after):
        out = {}
        for net, want in cpu["after"].items():
            norm = sum(float(np.sum(w.astype(np.float64) ** 2))
                       for w in want.values())
            diff = sum(float(np.sum((after[net][n].astype(np.float64)
                                     - w) ** 2)) for n, w in want.items())
            out[net] = (diff / max(norm, 1e-30)) ** 0.5
        return out

    cpu_loss = cpu["aux"][loss_key]
    out = {"rows": int(rec["batch"]["obs"].shape[0]),
           "rest": list(rec["rest"]),
           "card_loss": rec["aux"][loss_key],
           "replay_card_loss": card["aux"][loss_key], "cpu_loss": cpu_loss,
           "real_loss_rel_err": abs(rec["aux"][loss_key] - cpu_loss)
           / abs(cpu_loss),
           "loss_rel_err": abs(card["aux"][loss_key] - cpu_loss)
           / abs(cpu_loss),
           "aux_abs_err": {k: abs(card["aux"][k] - v)
                           for k, v in cpu["aux"].items()},
           "real_param_rel_err": rel_errs(rec["after"]),
           "param_rel_err": rel_errs(card["after"]),
           "real_equals_card_replay": all(
               np.array_equal(rec["after"][net][n], w)
               for net, ws in card["after"].items() for n, w in ws.items())}
    out["max_rel_err"] = max(
        [out["real_loss_rel_err"], out["loss_rel_err"]]
        + list(out["real_param_rel_err"].values())
        + list(out["param_rel_err"].values()))
    return out


def _gate_step(step: dict, name: str) -> None:
    check(step["max_rel_err"] <= RL_STEP_RTOL,
          f"{name}'s first update on the card disagrees with the CPU: "
          f"{step}")
    check(step["real_equals_card_replay"],
          f"{name}'s real update differs from its card replay: {step}")


def _run_iters(algo, iters: int) -> tuple:
    """``iters`` train() calls: (results' rewards and infos, wall s)."""
    rows, t0 = [], time.perf_counter()
    for _ in range(iters):
        r = algo.train()
        rows.append({"timesteps_total": r["timesteps_total"],
                     "episode_reward_mean": r["episode_reward_mean"],
                     "iter_ms": r["time_this_iter_s"] * 1e3,
                     "info": r["info"]})
    return rows, time.perf_counter() - t0


def _sac_part(dev) -> dict:
    import torch
    from ray_tpu_torch.rl import SACConfig
    from ray_tpu_torch.rl.sac import Rescale, make_sac_update
    counters = _zeroed_counters()
    t_build = time.perf_counter()
    algo = _rl_config(SACConfig, RC_SAC, "Pendulum-v1").build()
    out = {"build_s": time.perf_counter() - t_build}
    try:
        _state_on_card(algo, dev, "SAC")
        cfg = algo.config
        check(tuple(cfg.hidden) == (256, 256),
              f"SAC's config widths moved: {cfg.hidden}")
        recs, upd_s = [], []
        _timed_sync(algo, "_update", upd_s)
        _record_updates(algo, recs)
        iters, wall = _run_iters(algo, RC_SAC_ITERS)
        rewards = [i["episode_reward_mean"] for i in iters
                   if not math.isnan(i["episode_reward_mean"])]
        info = iters[-1]["info"]
        out.update(
            wall_s=wall, train_iters=len(iters), rewards=rewards,
            timesteps_total=iters[-1]["timesteps_total"],
            env_steps_per_s=iters[-1]["timesteps_total"] / wall,
            updates=len(upd_s), update_ms=_ms_stats(upd_s),
            update_s_total=sum(upd_s), critic_loss=info["critic_loss"],
            alpha=info["alpha"], entropy=info["entropy"],
            iter_ms=[i["iter_ms"] for i in iters])
        check(rewards and max(rewards[-8:]) > rewards[0] + RC_SAC_GAIN,
              f"SAC's best of the last 8 iterations is not {RC_SAC_GAIN} "
              f"above its first: {rewards}")
        check(math.isfinite(info["critic_loss"]) and info["alpha"] > 0,
              f"SAC's critic loss or alpha is off: {info}")
        out["launches"] = _no_launches(counters, "SAC")
        check(not torch.backends.cuda.matmul.allow_tf32,
              "TF32 matmuls are on: the step gate needs fp32")
        out["first_step"] = step = _update_check(
            recs[0], dev, lambda d: make_sac_update(
                cfg, algo.txs, Rescale(algo.rescale.low, algo.rescale.high,
                                       d), algo.target_entropy))
        _gate_step(step, "SAC")
        out["rollout_actors"] = _check_rollout_hosts(algo)
    finally:
        algo.stop()
    return out


def _ddpg_part(dev, td3: bool) -> dict:
    import torch
    from ray_tpu_torch.rl import DDPGConfig, TD3Config
    from ray_tpu_torch.rl.ddpg import make_ddpg_update
    from ray_tpu_torch.rl.sac import Rescale
    name = "TD3" if td3 else "DDPG"
    counters = _zeroed_counters()
    algo = _rl_config(TD3Config if td3 else DDPGConfig, RC_DDPG,
                      "Pendulum-v1").build()
    try:
        _state_on_card(algo, dev, name)
        cfg = algo.config
        recs, upd_s, held = [], [], []
        _timed_sync(algo, "_update", upd_s)
        _record_updates(algo, recs, n=2 if td3 else 1)
        real = algo._update

        def actor_side(state):
            opt = state["actor_opt"]
            return (opt["count"], [
                _flat(state["actor"]).clone(),
                _flat(state["target_actor"]).clone(),
                torch.cat([t.reshape(-1) for m in ("mu", "nu")
                           for t in opt[m].values()])])

        def update(state, batch, noise, do_actor):
            # a step that skips the actor leaves the actor, its Adam
            # state and count, and the target actor as they were
            if do_actor:
                return real(state, batch, noise, do_actor)
            count, before = actor_side(state)
            aux = real(state, batch, noise, do_actor)
            count_after, after = actor_side(state)
            held.append(count_after == count and all(
                torch.equal(a, b) for a, b in zip(before, after)))
            return aux
        algo._update = update
        iters, wall = _run_iters(algo, RC_DDPG_ITERS)
        losses = [(i["info"]["critic_loss"], i["info"]["actor_loss"])
                  for i in iters if "critic_loss" in i["info"]]
        out = {"wall_s": wall, "train_iters": len(iters),
               "timesteps_total": iters[-1]["timesteps_total"],
               "env_steps_per_s": iters[-1]["timesteps_total"] / wall,
               "updates": len(upd_s), "update_ms": _ms_stats(upd_s),
               "losses": losses,
               "rewards": [i["episode_reward_mean"] for i in iters]}
        check(losses and all(math.isfinite(x) for pair in losses
                             for x in pair),
              f"{name}'s losses are off: {losses}")
        out["launches"] = _no_launches(counters, name)
        check(not torch.backends.cuda.matmul.allow_tf32,
              "TF32 matmuls are on: the step gate needs fp32")

        def make(d):
            return make_ddpg_update(cfg, algo.txs, Rescale(
                algo.rescale.low, algo.rescale.high, d))
        out["first_steps"] = steps = [_update_check(r, dev, make)
                                      for r in recs]
        for step in steps:
            _gate_step(step, name)
        if td3:
            check([s["rest"] for s in steps] == [[False], [True]],
                  f"TD3's first two updates are not critic-only, then "
                  f"actor: {[s['rest'] for s in steps]}")
            out["skipped_actor_steps"] = len(held)
            check(held and all(held),
                  f"TD3's actor moved on a skipped step "
                  f"({held.count(False)} of {len(held)})")
        out["rollout_actors"] = _check_rollout_hosts(algo)
    finally:
        algo.stop()
    return out


def _ac_part(dev, kind: str) -> dict:
    """PG, A2C or A3C on CartPole-v1 at RC_AC."""
    import numpy as np
    import torch
    import ray_tpu_torch as rt
    from ray_tpu_torch.rl import A2CConfig, A3CConfig, PGConfig
    from ray_tpu_torch.rl import models as M
    from ray_tpu_torch.rl.a2c import make_a2c_optimizer
    from ray_tpu_torch.rl.pg import make_pg_sgd_step
    from ray_tpu_torch.rl.policy import module_weights
    from ray_tpu_torch.rl.ppo import make_ppo_optimizer
    cfg_cls = {"pg": PGConfig, "a2c": A2CConfig, "a3c": A3CConfig}[kind]
    counters = _zeroed_counters()
    algo = _rl_config(cfg_cls, RC_AC).build()
    try:
        _on_card(algo, dev, kind)
        cfg = algo.config
        rec, sgd_s, pushed = {}, [], {}
        _timed_sync(algo, "_sgd_step", sgd_s)
        _record_first(algo, rec)
        if kind == "a3c":
            # what each worker was last sent: the learner's weights when
            # its next fragment is requested (the push, or the initial
            # sync, precedes the request)
            submit = algo._submit

            def _submit(idx):
                pushed[idx] = module_weights(algo.model)
                submit(idx)
            algo._submit = _submit
        iters, wall = _run_iters(algo, RC_A3C_ITERS if kind == "a3c"
                                 else RC_AC_ITERS)
        infos = [i["info"] for i in iters]
        out = {"wall_s": wall, "train_iters": len(iters),
               "timesteps_total": iters[-1]["timesteps_total"],
               "env_steps_per_s": iters[-1]["timesteps_total"] / wall,
               "sgd_steps": len(sgd_s), "sgd_ms": _ms_stats(sgd_s),
               "total_losses": [i["total_loss"] for i in infos],
               "rewards": [i["episode_reward_mean"] for i in iters]}
        check(all(math.isfinite(x) for x in out["total_losses"]),
              f"{kind}'s losses are off: {out['total_losses']}")
        if kind == "a3c":
            out["batches_processed"] = [i["batches_processed"]
                                        for i in infos]
            check(all(n >= 1 for n in out["batches_processed"]),
                  f"A3C processed no fragment in an iteration: "
                  f"{out['batches_processed']}")
            held = rt.get([w.get_weights.remote()
                           for w in algo.workers.workers])
            out["workers_adopted"] = adopted = [
                all(np.array_equal(h[n], w) for n, w in pushed[i].items())
                for i, h in enumerate(held)]
            check(all(adopted), f"an A3C worker does not hold the weights "
                                f"pushed to it: {adopted}")
        out["launches"] = _no_launches(counters, kind)
        check(not torch.backends.cuda.matmul.allow_tf32,
              "TF32 matmuls are on: the step gate needs fp32")
        out["first_step"] = step = _step_check(
            algo, rec, dev, lambda model, _, tx: make_pg_sgd_step(
                model, M.categorical_logp, M.categorical_entropy, tx, cfg,
                normalize_advantages=kind == "pg"),
            make_tx=make_ppo_optimizer if kind == "pg"
            else make_a2c_optimizer)
        _gate_step(step, kind)
        out["rollout_actors"] = _check_rollout_hosts(algo)
    finally:
        algo.stop()
    return out


def _offline_part(dev, kind: str, data: str) -> dict:
    """CQL or CRR over ``data`` for RC_OFFLINE_CALLS train() calls, saved
    after the first and restored after the last."""
    import numpy as np
    import torch
    from ray_tpu_torch.rl import CQLConfig, CRRConfig
    from ray_tpu_torch.rl.algorithm import full_training_state
    from ray_tpu_torch.rl.cql import make_cql_update
    from ray_tpu_torch.rl.crr import make_crr_update
    from ray_tpu_torch.rl.sac import Rescale
    cfg_cls, make_update, key = {
        "cql": (CQLConfig, make_cql_update, "cql_loss"),
        "crr": (CRRConfig, make_crr_update, "mean_weight")}[kind]
    counters = _zeroed_counters()
    t_build = time.perf_counter()
    algo = (cfg_cls().environment("Pendulum-v1")
            .offline_data(input_path=data).debugging(seed=SEED).build())
    out = {"build_s": time.perf_counter() - t_build,
           "dataset_rows": algo.dataset.count}
    _state_on_card(algo, dev, kind)
    cfg = algo.config
    recs, upd_s, infos, saved, ckpt = [], [], [], None, None
    _timed_sync(algo, "_update", upd_s)
    _record_updates(algo, recs)
    t0 = time.perf_counter()
    for call in range(RC_OFFLINE_CALLS):
        infos.append(algo.train()["info"])
        if call == 0:
            ckpt = algo.save()
            saved = full_training_state(algo)
    wall = time.perf_counter() - t0
    algo.restore(ckpt)
    back = full_training_state(algo)
    out.update(wall_s=wall, updates=len(upd_s),
               update_ms=_ms_stats(upd_s),
               rows_per_s=algo._timesteps_total / wall,
               infos=infos, key=[i[key] for i in infos])
    check(all(i[key] > 0 and all(math.isfinite(v) for v in i.values())
              for i in infos),
          f"{kind}'s {key} is not positive or a loss is off: {infos}")
    out["restore_bit_equal"] = same = _same_tree(back, saved)
    check(same and algo.iteration == 1,
          f"{kind}'s restore does not give back the saved state")
    out["launches"] = _no_launches(counters, kind)
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 matmuls are on: the step gate needs fp32")
    out["first_step"] = step = _update_check(
        recs[0], dev, lambda d: make_update(
            cfg, algo.txs, Rescale(algo.rescale.low, algo.rescale.high, d)))
    _gate_step(step, kind)
    return out


def rl_continuous_phase(dev) -> dict:
    """The continuous-control, actor-critic and offline families on the
    port's runtime, in a session of its own, as the module docstring
    says: (a) SAC, (b) DDPG and TD3, (c) PG, A2C and A3C, (d) CQL and
    CRR."""
    import shutil
    import tempfile

    import torch

    import ray_tpu_torch
    from ray_tpu_torch.rl import collect_dataset

    torch.cuda.empty_cache()
    before = _runtime_processes()
    check(not before, f"runtime processes left from before: {before}")
    work = tempfile.mkdtemp(prefix="chip_smoke_rl_continuous_")
    t0 = time.perf_counter()
    ray_tpu_torch.init(num_cpus=8)
    node = ray_tpu_torch.api._node
    out = {"init_s": time.perf_counter() - t0,
           "session_dir": node.session_dir}
    try:
        parts = (("sac", _sac_part),
                 ("ddpg", lambda d: _ddpg_part(d, td3=False)),
                 ("td3", lambda d: _ddpg_part(d, td3=True)),
                 ("pg", lambda d: _ac_part(d, "pg")),
                 ("a2c", lambda d: _ac_part(d, "a2c")),
                 ("a3c", lambda d: _ac_part(d, "a3c")))
        for part, run in parts:
            t1 = time.perf_counter()
            out[part] = run(dev)
            out[part]["part_s"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        data = collect_dataset("Pendulum-v1", work + "/pendulum",
                               n_steps=RC_OFFLINE_STEPS,
                               seed=RC_OFFLINE_SEED)
        out["collect_s"] = time.perf_counter() - t1
        for part in ("cql", "crr"):
            t1 = time.perf_counter()
            out[part] = _offline_part(dev, part, data)
            out[part]["part_s"] = time.perf_counter() - t1
    finally:
        ray_tpu_torch.shutdown()
        shutil.rmtree(work, ignore_errors=True)
        deadline = time.monotonic() + 30
        left = _runtime_processes(node.session_dir)
        while left and time.monotonic() < deadline:
            time.sleep(0.5)
            left = _runtime_processes(node.session_dir)
    out["left_after_shutdown"] = left
    out["phase_s"] = time.perf_counter() - t0
    out["run_s_so_far"] = time.perf_counter() - RUN_T0
    check(not left, f"processes left after shutdown: {left}")
    return out


def rl_continuous_launches(rc: dict, kind: str) -> dict:
    """A kernel's launches on the rl_continuous phase's paths."""
    return {f"rl_{part}": rc[part]["launches"][kind] for part in RC_PARTS}


def attn_bound(kind: str, q, k, causal: bool) -> dict:
    """Least time for one flash or splash kernel call (``kind`` ends in
    fwd, bwd_dq or bwd_dkv): each input read once and each output
    written once over HBM bandwidth, against the products' flops over
    the peak rate of the inputs' type.  Only the (query, key) pairs the
    mask lets through count: S(S+1)/2 per head when causal.  Per pair
    the forward does 2 products of head_dim (q.k, p.v), dQ 3 (q.k, dO.v,
    dS.k) and dK/dV 4 (q.k, dO.v, P^T.dO, dS^T.q), 2 flops per
    multiply-add."""
    import torch
    b, sq, h, d = q.shape
    skv = k.shape[1]
    esize = q.element_size()
    qb = q.numel() * esize
    kvb = 2 * k.numel() * esize
    vec = b * h * sq * 4                     # lse or delta, fp32
    pairs = b * h * (sq * (sq + 1) // 2 if causal else sq * skv)
    nbytes, products = {
        "fwd": (qb + kvb + qb + vec, 2),
        "bwd_dq": (qb + kvb + qb + 2 * vec + qb, 3),
        "bwd_dkv": (qb + kvb + qb + 2 * vec + kvb, 4),
    }[kind.split("_", 1)[1]]
    flops = 2 * products * d * pairs
    rate = BF16_FLOPS if q.dtype == torch.bfloat16 else FP32_FLOPS
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / rate * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bytes": nbytes, "flops": flops}


def kernel_fns(family: str, causal: bool, scale: float, h: int, sq: int,
               skv: int) -> tuple:
    """The three kernels of ``family`` ("flash" or "splash") and their
    plain versions, each with one signature: fwd(q, k, v) -> (o, lse);
    dq and dkv(q, k, v, do, lse, delta); ref_fwd(q, k, v); ref_dq and
    ref_dkv(q, k, v, o, lse, do).  Splash runs the mask that
    ops/splash.py builds for ``causal``."""
    if family == "flash":
        from ray_tpu_torch.ops import flash_attention as mod
        how = causal

        def cuda(fn):
            return lambda *a: fn(*a, causal=causal, sm_scale=scale)
    else:
        from ray_tpu_torch.ops import splash as mod
        how = mod.make_mask(h, sq, skv, causal)

        def cuda(fn):
            return lambda *a: fn(*a, how, sm_scale=scale)

    def ref(fn):
        return lambda *a: fn(*a, how, scale)

    names = ("fwd", "bwd_dq", "bwd_dkv")
    return (*(cuda(getattr(mod, f"{family}_{n}_cuda")) for n in names),
            *(ref(getattr(mod, f"{family}_{n}_ref")) for n in names))


def bf16_p_share(family, q, k, v, causal, scale, o_r) -> float:
    """The share of o elements in which a forward that rounds P to bf16
    before P.V (plain torch on the plain version's scores) differs from
    the plain version's o_r: what FWD_BF16_DIFFERING has to catch."""
    import torch
    if family == "flash":
        from ray_tpu_torch.ops import flash_attention as mod
        k_, v_, _ = mod._expand(q, k, v)
        s = mod._scores(q, k_, causal, scale)
    else:
        from ray_tpu_torch.ops import splash as mod
        k_, v_, _ = mod._expand(q, k, v)
        mask = mod.make_mask(q.shape[2], q.shape[1], k.shape[1], causal)
        s = mod._scores(q * mod.dtype_scale(scale, q.dtype), k_, mask)
    p = torch.exp(s - torch.logsumexp(s, dim=-1, keepdim=True))
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(torch.bfloat16).float(),
                     v_.float()).to(q.dtype)
    return float((o != o_r).float().mean())


def share_differing(*pairs) -> float:
    """The share of elements, over every (got, want) pair, that differ
    at all."""
    import torch
    return float(torch.cat([(g != w).flatten() for g, w in pairs])
                 .float().mean())


def bf16_pds_share(q, k, v, o, lse, do, causal, scale, dk_r,
                   dv_r) -> float:
    """The share of dK and dV elements in which a K3 that rounds P and dS
    to bf16 before its products (plain torch on the plain version's P and
    dS) differs from the plain version's dk_r, dv_r: what
    BWD_BF16_DIFFERING has to catch."""
    import torch
    from ray_tpu_torch.ops import flash_attention as mod
    _, _, g, p, ds = mod._bwd_common(q, k, v, o, lse, do, causal, scale)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(torch.bfloat16).float(),
                      q.float()) * scale
    del ds
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(torch.bfloat16).float(),
                      do.float())
    del p
    return share_differing((mod._fold(dk, g).to(k.dtype), dk_r),
                           (mod._fold(dv, g).to(v.dtype), dv_r))


def dq_pair(got, want, causal: bool) -> tuple:
    """(got, want) dQ [B, S, H, D] without causal row 0, whose values are
    noise in every version (see BWD_BF16_DIFFERING)."""
    return (got[:, 1:], want[:, 1:]) if causal else (got, want)


def bf16_ds_share(q, k, v, o, lse, do, causal, scale, dq_r) -> float:
    """The share of dQ elements in which a K2 that rounds dS to bf16
    before dS.K (plain torch on the plain version's dS) differs from the
    plain version's dq_r: what BWD_BF16_DIFFERING has to catch."""
    import torch
    from ray_tpu_torch.ops import flash_attention as mod
    k_, _, _, _, ds = mod._bwd_common(q, k, v, o, lse, do, causal, scale)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(torch.bfloat16).float(),
                      k_.float()) * scale
    del ds
    return share_differing(dq_pair(dq.to(q.dtype), dq_r, causal))


def attention_case(dev, gen, family, b, sq, h, kvh, d, dtype, causal,
                   skv=None, timed: bool = False, fused: bool = False,
                   low: bool = False) -> dict:
    """The three flash or splash kernels on one shape against their plain
    versions (and, when ``timed``, kernel / plain / SDPA times beside the
    bounds).  ``fused``: q, k and v are strided views of one [B, S,
    H + 2 KVH, D] tensor, as a fused qkv projection leaves them.
    ``low``: every key gets +1 in every element and every 7th query row
    is -24 in every element, so that all the logits of those rows lie
    near -24 x 64 x scale (-192 at head_dim 64): a row's first tile then
    has its max far below the exponent's range."""
    import torch
    import torch.nn.functional as F
    skv = sq if skv is None else skv
    scale = d ** -0.5
    fwd, dq_k, dkv_k, ref_fwd, ref_dq, ref_dkv = kernel_fns(
        family, causal, scale, h, sq, skv)
    kinds = [f"{family}_{n}" for n in ("fwd", "bwd_dq", "bwd_dkv")]
    tol = {} if dtype == torch.bfloat16 else dict(atol=FLASH_FP32_TOL,
                                                  rtol=FLASH_FP32_TOL)

    def inputs():
        if fused:
            qkv = torch.randn(b, sq, h + 2 * kvh, d, generator=gen,
                              device=dev).to(dtype)
            q, k, v = qkv.split([h, kvh, kvh], dim=2)
            do = torch.randn(b, sq, h, d, generator=gen, device=dev
                             ).to(dtype)
        else:
            q, k, v, do = (torch.randn(*shape, generator=gen, device=dev
                                       ).to(dtype)
                           for shape in ((b, sq, h, d), (b, skv, kvh, d),
                                         (b, skv, kvh, d), (b, sq, h, d)))
        if low:
            q[:, ::7] = -24.0
            k += 1.0
        return q, k, v, do

    # two input sets (4 x 25 MB each at gpt-small shapes) so that timed
    # calls find their inputs cold in the 50 MB L2, as a layer does
    sets = [inputs() for _ in range(2 if timed else 1)]
    q, k, v, do = sets[0]
    if low:
        # rows whose first tile's max logit, in units of log2, is below
        # -128: there a rescale of 2^(0 - max) from "no key seen yet"
        # overflows, and inf * 0 gives NaN
        first = torch.einsum("bqhd,bkhd->bhqk", q.float(), k[:, :64].float()
                             .repeat_interleave(h // kvh, 2)) * scale
        if causal:
            first = first.masked_fill(torch.ones(
                sq, first.shape[-1], dtype=torch.bool, device=dev
            ).triu(1), -math.inf)
        low_rows = int((first.amax(-1) * math.log2(math.e) < -128).sum())
        check(low_rows > 0, f"no row of the low-logit case at {[b, sq, h]} "
                            "has its first tile's max below -128 in log2")
    o, lse = fwd(q, k, v)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    dq = dq_k(q, k, v, do, lse, delta)
    dk, dv = dkv_k(q, k, v, do, lse, delta)
    torch.cuda.synchronize()
    o_r, lse_r = ref_fwd(q, k, v)
    dq_r = ref_dq(q, k, v, o, lse, do)
    dk_r, dv_r = ref_dkv(q, k, v, o, lse, do)
    res = {"shape": [b, sq, skv, h, kvh, d], "dtype": str(dtype),
           "causal": causal, "fused": fused,
           "low_rows": low_rows if low else 0,
           kinds[0]: {"o": compare(o, o_r, **tol),
                      "lse": compare(lse, lse_r, atol=FLASH_FP32_TOL,
                                     rtol=FLASH_FP32_TOL)},
           kinds[1]: {"dq": compare(dq, dq_r, **tol)},
           kinds[2]: {"dk": compare(dk, dk_r, **tol),
                      "dv": compare(dv, dv_r, **tol)}}
    for kind in kinds:
        for name, c in res[kind].items():
            check(c["finite"] and c["within_tol"],
                  f"{kind} {name} disagrees with the plain version at "
                  f"{res['shape']} {dtype} causal={causal}: {c}")
        res[kind]["max_abs_err"] = max(c["max_abs_err"]
                                       for c in res[kind].values())
    if dtype == torch.bfloat16:
        err = res[kinds[0]]["o"]["max_abs_err"]
        # one bf16 ulp of each element, and at least 2^-7
        ulp = torch.exp2(torch.floor(torch.log2(
            o_r.float().abs().clamp_min(2.0 ** -126))) - 7)
        over = float(((o.float() - o_r.float()).abs()
                      - ulp.clamp_min(FWD_BF16_MAX_ERR)).max())
        check(over <= 0,
              f"{kinds[0]} o is {err} from the plain version at "
              f"{res['shape']} causal={causal}, over {FWD_BF16_MAX_ERR} "
              f"(or one bf16 ulp of the element) by {over}")
        share = res[kinds[0]]["o"]["frac_differing"]
        check(share <= FWD_BF16_DIFFERING,
              f"{kinds[0]} o differs from the plain version in {share} of "
              f"its elements at {res['shape']} causal={causal}, over "
              f"{FWD_BF16_DIFFERING}")
        # the share of dQ, and of dK and dV, elements that differ at all:
        # gated for K2 and K3 (fp32-faithful through the split), reported
        # for K5-dQ and K5-dKV (which round dS, and P, to bf16 as the
        # library does).  With ``low``, dQ's share is gated on the other
        # rows and reported for the low rows (see BWD_BF16_DIFFERING)
        dq_g, dq_rg = dq_pair(dq, dq_r, causal)
        if low:
            rows = torch.ones(dq.shape[1], dtype=torch.bool, device=dev)
            rows[::7] = False
            res[kinds[1]]["frac_differing_low_rows"] = share_differing(
                (dq[:, ~rows], dq_r[:, ~rows]))
            rows = rows[1:] if causal else rows
            dq_g, dq_rg = dq_g[:, rows], dq_rg[:, rows]
        for kind, pairs in ((kinds[1], ((dq_g, dq_rg),)),
                            (kinds[2], ((dk, dk_r), (dv, dv_r)))):
            share = share_differing(*pairs)
            res[kind]["frac_differing"] = share
            if family == "flash":
                check(share <= BWD_BF16_DIFFERING,
                      f"{kind} differs from the plain version in {share} "
                      f"of its elements at {res['shape']} causal={causal}, "
                      f"over {BWD_BF16_DIFFERING}")
    if family == "splash":
        from ray_tpu_torch.ops.splash import BLOCK, TILE, make_mask, \
            mask_table
        mask = make_mask(h, sq, skv, causal)
        t, blocks = mask_table(mask, TILE), mask_table(mask, BLOCK)
        res["tiles"] = {"tile": TILE, "visited": b * t.visited,
                        "partial": b * t.partial, "dense": b * t.dense,
                        "library_block": BLOCK,
                        "library_visited": b * blocks.visited,
                        "library_dense": b * blocks.dense}
    if not timed:
        return res

    if dtype == torch.bfloat16:
        share = bf16_p_share(family, q, k, v, causal, scale, o_r)
        res[kinds[0]]["o"]["bf16_p_frac_differing"] = share
        check(share > FWD_BF16_DIFFERING,
              f"a forward with P in bf16 differs in only {share} of o, "
              f"within the {FWD_BF16_DIFFERING} gate that should catch it")
        torch.cuda.empty_cache()
        if family == "flash":
            share = bf16_pds_share(q, k, v, o, lse, do, causal, scale,
                                   dk_r, dv_r)
            res[kinds[2]]["bf16_pds_frac_differing"] = share
            check(share > BWD_BF16_DIFFERING,
                  f"a K3 with P and dS in bf16 differs in only {share} of "
                  f"dK and dV, within the {BWD_BF16_DIFFERING} gate that "
                  "should catch it")
            torch.cuda.empty_cache()
            share = bf16_ds_share(q, k, v, o, lse, do, causal, scale, dq_r)
            res[kinds[1]]["bf16_ds_frac_differing"] = share
            check(share > BWD_BF16_DIFFERING,
                  f"a K2 with dS in bf16 differs in only {share} of dQ, "
                  f"within the {BWD_BF16_DIFFERING} gate that should catch "
                  "it")
            torch.cuda.empty_cache()

    outs = [fwd(q_, k_, v_) for q_, k_, v_, _ in sets]
    bwd_sets = [(q_, k_, v_, do_, lse_, (do_.float() * o_.float()).sum(-1)
                 .transpose(1, 2).contiguous())
                for (q_, k_, v_, do_), (o_, lse_) in zip(sets, outs)]
    ref_bwd_sets = [(q_, k_, v_, o_, lse_, do_)
                    for (q_, k_, v_, do_), (o_, lse_) in zip(sets, outs)]

    def fwd4(q_, k_, v_, _):
        return fwd(q_, k_, v_)

    def ref_fwd4(q_, k_, v_, _):
        return ref_fwd(q_, k_, v_)

    # the library yardstick: SDPA on contiguous [B, H, S, D] copies
    lib_sets = [tuple(t.transpose(1, 2).contiguous().requires_grad_()
                      for t in (q_, k_, v_)) + (do_.transpose(1, 2),)
                for q_, k_, v_, do_ in sets]

    def sdpa(q_, k_, v_, *_):
        return F.scaled_dot_product_attention(q_, k_, v_, is_causal=causal,
                                              scale=scale,
                                              enable_gqa=kvh != h)

    graphs = [(sdpa(*a), a) for a in lib_sets]

    def sdpa_bwd(i):
        out, a = graphs[i]
        return torch.autograd.grad(out, a[:3], a[3], retain_graph=True)

    with torch.no_grad():
        lib_fwd = time_ms(sdpa, lib_sets)[0]
    lib_bwd = time_ms(sdpa_bwd, [(0,), (1,)])[0]
    for kind, fn, ref, args, ref_args, lib in (
            (kinds[0], fwd4, ref_fwd4, sets, sets, lib_fwd),
            (kinds[1], dq_k, ref_dq, bwd_sets, ref_bwd_sets, lib_bwd),
            (kinds[2], dkv_k, ref_dkv, bwd_sets, ref_bwd_sets, lib_bwd)):
        ms, host_ms = time_ms(fn, args)
        bound = attn_bound(kind, q, k, causal)
        res[kind].update(ms=ms, host_ms=host_ms,
                         plain_ms=time_ms(ref, ref_args, reps=2)[0],
                         library_ms=lib, tflop_s=bound["flops"] / ms / 1e9,
                         **bound)
    # the whole backward (dQ + dK/dV) against SDPA's, which computes all
    # three gradients in one call
    bwd_ms = res[kinds[1]]["ms"] + res[kinds[2]]["ms"]
    res["backward"] = {"ms": bwd_ms, "library_ms": lib_bwd,
                       "vs_library": bwd_ms / lib_bwd}
    res["library_note"] = ("SDPA forward for the forward kernel; SDPA "
                           "backward (dq, dk and dv together) for the dQ "
                           "and dK/dV kernels, and beside their sum")
    return res


def fp32_wide_case(dev, gen, family: str, b: int = 2, sq: int = 256,
                   h: int = 4, d: int = 256) -> dict:
    """fp32 at head_dim 256, causal: the CUDA-core forward, dQ and dK/dV
    kernels (whose backward blocks own 32-row tiles there) against their
    plain versions at FLASH_FP32_TOL; each kernel's time beside its
    bound, its plain version's and SDPA's (forward, or backward for the
    two backward kernels), and its registers, local memory, blocks per SM
    and shared memory per block."""
    import torch
    import torch.nn.functional as F
    scale = d ** -0.5
    fwd, dq_k, dkv_k, ref_fwd, ref_dq, ref_dkv = kernel_fns(
        family, True, scale, h, sq, sq)
    kinds = [f"{family}_{n}" for n in ("fwd", "bwd_dq", "bwd_dkv")]
    q, k, v, do = (torch.randn(b, sq, h, d, generator=gen, device=dev)
                   for _ in range(4))
    o, lse = fwd(q, k, v)
    delta = (do * o).sum(-1).transpose(1, 2).contiguous()
    dq = dq_k(q, k, v, do, lse, delta)
    dk, dv = dkv_k(q, k, v, do, lse, delta)
    torch.cuda.synchronize()
    o_r, lse_r = ref_fwd(q, k, v)
    dq_r = ref_dq(q, k, v, o, lse, do)
    dk_r, dv_r = ref_dkv(q, k, v, o, lse, do)
    tol = dict(atol=FLASH_FP32_TOL, rtol=FLASH_FP32_TOL)
    res = {"shape": [b, sq, sq, h, h, d], "dtype": "torch.float32",
           kinds[0]: {"o": compare(o, o_r, **tol),
                      "lse": compare(lse, lse_r, **tol)},
           kinds[1]: {"dq": compare(dq, dq_r, **tol)},
           kinds[2]: {"dk": compare(dk, dk_r, **tol),
                      "dv": compare(dv, dv_r, **tol)}}
    for kind in kinds:
        for name, c in res[kind].items():
            check(c["finite"] and c["within_tol"],
                  f"fp32 {kind} {name} at head_dim {d} disagrees with the "
                  f"plain version: {c}")
        res[kind]["max_abs_err"] = max(c["max_abs_err"]
                                       for c in res[kind].values())
    # the library yardstick: SDPA on contiguous [B, H, S, D] fp32 copies,
    # its backward computing dq, dk and dv together
    lq, lk, lv = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    with torch.no_grad():
        lib_fwd = time_ms(lambda *a: F.scaled_dot_product_attention(
            *a, is_causal=True, scale=scale), [(lq, lk, lv)])[0]
    lout = F.scaled_dot_product_attention(lq, lk, lv, is_causal=True,
                                          scale=scale)
    ldo = do.transpose(1, 2)
    lib_bwd = time_ms(lambda: torch.autograd.grad(
        lout, (lq, lk, lv), ldo, retain_graph=True), [()])[0]
    usage = fp32_usage(family, d)
    for kind, fn, args, ref, ref_args, lib_ms in (
            (kinds[0], fwd, (q, k, v), ref_fwd, (q, k, v), lib_fwd),
            (kinds[1], dq_k, (q, k, v, do, lse, delta), ref_dq,
             (q, k, v, o, lse, do), lib_bwd),
            (kinds[2], dkv_k, (q, k, v, do, lse, delta), ref_dkv,
             (q, k, v, o, lse, do), lib_bwd)):
        ms = time_ms(fn, [args])[0]
        res[kind].update(plain_ms=time_ms(ref, [ref_args], reps=2)[0],
                         library_ms=lib_ms)
        bound = attn_bound(kind, q, k, True)
        res[kind].update(ms=ms, tflop_s=bound["flops"] / ms / 1e9, **bound,
                         **usage[kind])
    return res


def fp32_usage(family: str, d: int) -> dict:
    """Registers, local memory, blocks per SM and shared memory of the
    fp32 kernels of ``family`` at head_dim ``d``, by kernel."""
    import ctypes
    from ray_tpu_torch.ops import flash_attention, splash
    lib = (flash_attention if family == "flash" else splash)._lib()
    out = {}
    for i, n in enumerate(("fwd", "bwd_dq", "bwd_dkv")):
        u = (ctypes.c_int * 3)()
        err = getattr(lib, f"rt_{family}_fp32_usage")(i, d, u)
        check(err == 0, f"fp32 {family}_{n} usage query at head_dim {d}: "
                        f"cudaError {err}")
        out[f"{family}_{n}"] = {
            **dict(zip(("registers", "local_bytes", "blocks_per_sm"), u)),
            "smem_bytes": getattr(lib, f"rt_{family}_smem_bytes")(i, 0, d)}
    return out


def flash_phase(dev) -> dict:
    """The flash kernels at the training slice's shapes and at gptj-6b's
    (16 heads of 256, batch 2 x 1024), ViT-B/16's (VIT_BATCH x 196, 12
    heads of 64, non-causal), gpt-large's and mixtral's, all timed; at
    BERT's and T5's shapes and the air_batch phase's (PATH_SHAPES),
    untimed; at a GQA 32/8
    head_dim-128 shape with S not a multiple of the 64-row tiles, at fp32
    / non-causal / q_len != kv_len shapes, and at head_dim 256 (GQA and
    ragged, non-causal, low logits, and fp32)."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(SEED)
    bf16, fp32 = torch.bfloat16, torch.float32
    at_slice = attention_case(dev, gen, "flash", 16, 1024, 12, 12, 64, bf16,
                              True, timed=True)
    at_hd256 = attention_case(dev, gen, "flash", 2, 1024, 16, 16, 256, bf16,
                              True, timed=True)
    torch.cuda.empty_cache()
    # the shapes of the other training paths, timed: ViT-B/16's 196
    # patches (non-causal, 3 x 64 + 4 rows), gpt-large's lean run and
    # mixtral's GQA 32/8 at head_dim 128; untimed: BERT's, T5's
    # cross-attention (q DECODER_SEQ over kv ENCODER_SEQ, non-causal) and
    # T5's decoder self-attention, and the air_batch phase's: ViT-B/16
    # scored in batches of PREDICT_BATCH, gpt-small's sweep in batches
    # of TUNE_BATCH
    at_path = {label: attention_case(dev, gen, "flash", *shape, bf16,
                                     causal, skv, timed=timed)
               for label, shape, causal, skv, timed in (
                   ("vit", (VIT_BATCH, 196, 12, 12, 64), False, None, True),
                   ("large", (10, 1024, 20, 20, 64), True, None, True),
                   ("mixtral", (8, 1024, 32, 8, 128), True, None, True),
                   ("bert", (ENCODER_BATCH, ENCODER_SEQ, 12, 12, 64), False,
                    None, False),
                   ("t5_cross", (ENCODER_BATCH, DECODER_SEQ, 12, 12, 64),
                    False, ENCODER_SEQ, False),
                   ("t5_self", (ENCODER_BATCH, DECODER_SEQ, 12, 12, 64),
                    True, None, False),
                   ("air_predict", (PREDICT_BATCH, 196, 12, 12, 64), False,
                    None, False),
                   ("air_tune", (TUNE_BATCH, 1024, 12, 12, 64), True, None,
                    False))}
    # the Decision Transformer's attention (phase rl), timed: fp32 at
    # head_dim 32 through the CUDA-core kernels, 60 tokens in one ragged
    # tile, with each kernel's registers, local memory, blocks per SM and
    # shared memory there; and the same shape in bf16 through the
    # tensor-core kernels, whose tiles are 4 chunks of 16 bytes a row there
    dt_shape = (DT_BATCH, 3 * DT_CONTEXT, DT_HEADS, DT_HEADS, DT_HEAD_DIM)
    at_path["dt"] = attention_case(dev, gen, "flash", *dt_shape, fp32, True,
                                   timed=True)
    at_path["dt"]["usage"] = fp32_usage("flash", DT_HEAD_DIM)
    at_path["dt_bf16"] = attention_case(dev, gen, "flash", *dt_shape, bf16,
                                        True, timed=True)
    torch.cuda.empty_cache()
    coverage = [attention_case(dev, gen, "flash", *c) for c in (
        (2, 2000, 32, 8, 128, bf16, True),
        (2, 200, 4, 2, 64, fp32, False, 137),
        (2, 130, 4, 2, 128, fp32, True),
        (3, 100, 6, 3, 64, bf16, False, 300),
        (2, 512, 12, 4, 64, bf16, True, None, False, True),
        (2, 64, 4, 2, 64, bf16, True),
        (1, 4096, 12, 12, 64, bf16, True),
        (2, 512, 4, 2, 64, bf16, True, None, False, False, True),
        (2, 256, 8, 2, 128, bf16, False, None, False, False, True),
        (2, 200, 8, 2, 256, bf16, True),
        (1, 256, 4, 4, 256, bf16, False, 320),
        (2, 256, 4, 2, 256, bf16, True, None, False, False, True),
        (2, 200, 4, 2, 32, bf16, False, 137),
        (2, 256, 4, 4, 32, bf16, True, None, False, False, True))]
    return {"slice_shape": at_slice, "hd256_shape": at_hd256,
            **{f"{label}_shape": res for label, res in at_path.items()},
            "coverage": coverage,
            "fp32_hd256": fp32_wide_case(dev, gen, "flash"),
            "tc_kernel": tc_usage("flash")}


def splash_phase(dev) -> dict:
    """The splash kernels (K5) at the training slice's shapes and at
    gptj-6b's (timed), at a GQA 32/8 head_dim-128 shape, with a full mask
    and q_len != kv_len, in fp32, and at head_dim 256 as the flash phase
    runs it; with the tiles the mask table visits."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(SEED)
    bf16, fp32 = torch.bfloat16, torch.float32
    at_slice = attention_case(dev, gen, "splash", 16, 1024, 12, 12, 64,
                              bf16, True, timed=True)
    at_hd256 = attention_case(dev, gen, "splash", 2, 1024, 16, 16, 256,
                              bf16, True, timed=True)
    torch.cuda.empty_cache()
    # head_dim 32 (the Decision Transformer's heads) at DT's batch and
    # heads, causal, timed, in fp32 (CUDA cores) and bf16 (tensor cores).
    # DT's 60 tokens are not a multiple of the library's 128-row blocks,
    # which the port refuses before any launch as the JAX function does,
    # so the cases run at the shortest length splash takes
    from ray_tpu_torch.ops.splash import BLOCK, splash_attention
    hd32 = {label: attention_case(dev, gen, "splash", DT_BATCH, BLOCK,
                                  DT_HEADS, DT_HEADS, DT_HEAD_DIM, dtype,
                                  True, timed=True)
            for label, dtype in (("hd32_shape", fp32),
                                 ("hd32_bf16_shape", bf16))}
    q = torch.randn(DT_BATCH, 3 * DT_CONTEXT, DT_HEADS, DT_HEAD_DIM,
                    generator=gen, device=dev)
    try:
        splash_attention(q, q, q, causal=True)
        refused = None
    except ValueError as e:
        refused = str(e)
    check(refused is not None and "should divide" in refused,
          f"splash at {list(q.shape)} was not refused by the block rule: "
          f"{refused}")
    torch.cuda.empty_cache()
    coverage = [attention_case(dev, gen, "splash", *c) for c in (
        (2, 2048, 32, 8, 128, bf16, True),
        (2, 512, 8, 8, 64, bf16, False, 1024),
        (2, 256, 4, 4, 64, fp32, True),
        (2, 512, 12, 4, 64, bf16, True, None, False, True),
        (2, 128, 4, 2, 64, bf16, True),
        (1, 4096, 12, 12, 64, bf16, True),
        (2, 512, 4, 2, 64, bf16, True, None, False, False, True),
        (2, 256, 8, 2, 128, bf16, False, None, False, False, True),
        (2, 512, 8, 2, 256, bf16, True),
        (1, 256, 4, 4, 256, bf16, False, 512),
        (2, 256, 4, 2, 256, bf16, True, None, False, False, True))]
    return {"slice_shape": at_slice, "hd256_shape": at_hd256, **hd32,
            "dt_len_refused": refused, "coverage": coverage,
            "fp32_hd256": fp32_wide_case(dev, gen, "splash"),
            "tc_kernel": tc_usage("splash")}


def step_groups(prof, impl: str) -> tuple:
    """Device ms of one profiled step by group (the attention kernels of
    ``impl``, cuBLAS GEMMs, the optimizer, the rest), the attention
    kernels' (ms, launches) each, and the top kernels.  Kernels are
    grouped by name; the optimizer's time is that of the kernels inside
    its profiler range's span (``train/step.py``).  With experts, the
    GEMMs of their forward and of remat's recompute of it (MoEMLP's
    ``moe_experts`` range) stand apart from the other GEMMs, among which
    their gradients' stay."""
    attention = {n: [0.0, 0] for n in ("fwd", "bwd_dq", "bwd_dkv")}
    by_name = {impl: 0.0, "gemm": 0.0, "rest": 0.0}
    optimizer = span_device_ms(prof, "optimizer")
    kernels: dict = {}
    for e in kernel_events(prof):
        key, ms = e.name.lower(), e.device_time_total / 1e3
        k = kernels.setdefault(e.name[:80], [0.0, 0])
        k[0] += ms
        k[1] += 1
        for n, a in attention.items():
            if f"{impl}_{n}" in key:
                a[0] += ms
                a[1] += 1
        if f"{impl}_" in key:
            by_name[impl] += ms
        elif gemm_kernel(key):
            by_name["gemm"] += ms
        else:
            by_name["rest"] += ms
    top = sorted(((n, ms, c) for n, (ms, c) in kernels.items()),
                 key=lambda t: -t[1])[:15]
    groups = {impl: by_name[impl], "gemm": by_name["gemm"],
              "optimizer": optimizer,
              # the optimizer launches no GEMM or attention kernel
              "other": by_name["rest"] - optimizer}
    experts = span_device_ms(prof, "moe_experts", gemm_kernel)
    if experts:
        groups.update(expert_gemm_fwd=experts,
                      gemm=by_name["gemm"] - experts)
    return groups, attention, top


def active_params(cfg) -> int:
    """Parameters one token's forward multiplies through: bench.py's
    ``num_params()`` (``6N``) for a dense model.  With experts,
    ``num_params()`` counts one expert's MLP and no router, so they are
    counted here: attention, top_k experts and the router per layer, and
    the head (the embedding lookup multiplies nothing)."""
    if not cfg.moe_experts:
        return cfg.num_params()
    d, hd = cfg.d_model, cfg.head_dim
    layer = (d * hd * (2 * cfg.n_heads + 2 * cfg.n_kv_heads)
             + cfg.moe_top_k * 3 * d * cfg.d_ff + d * cfg.moe_experts)
    return cfg.n_layers * layer + cfg.vocab_size * d


def train_phase(dev, impl: str = "flash", ref_impl: str = "xla",
                name: str = "gpt-small", batch: int = 16, seq: int = 1024,
                steps: int = TRAIN_STEPS, n_layers=None, warmup: int = 0,
                optimizer: str = "adamw", remat_policy: str = "dots",
                chunked: bool = False, param_cast=None,
                nocast_steps: int = 0) -> dict:
    """bench.py's training runs on the port with ``attention_impl=impl``:
    make_train over GPT at full width and depth (depth cut to
    ``n_layers`` where given), one fixed batch, the dense lm_loss_fn
    head or (``chunked``) lm_loss_chunked_fn with ``param_cast``, under
    ``family_train``'s gates: its first step must agree with one step of
    ``ref_impl`` from the same weights and batch; ``warmup`` more untimed
    steps, then ``steps`` timed ones (K1 launched twice per layer and
    step under remat, K2 and K3 once), one profiled, and
    ``nocast_steps`` timed ones with the chunked head's cast left inside
    the projections."""
    import functools
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from ray_tpu_torch.models.configs import get_config
    from ray_tpu_torch.models.gpt import GPT
    from ray_tpu_torch.train.step import (OptimizerConfig,
                                          lm_loss_chunked_fn, lm_loss_fn,
                                          make_train, state_nbytes)

    over = dict(max_seq_len=seq, remat=True, remat_policy=remat_policy)
    if n_layers is not None:
        over["n_layers"] = n_layers
    cfg = get_config(name, attention_impl=impl, **over)
    opt = OptimizerConfig(warmup_steps=10, decay_steps=1000,
                          optimizer=optimizer)

    def loss_fn(cast):
        if not chunked:
            return lm_loss_fn
        return functools.partial(lm_loss_chunked_fn, param_cast=cast)

    rng = np.random.default_rng(SEED)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (batch, seq + 1))).to(dev)
    L = cfg.n_layers
    res, model, state = family_train(
        dev, name, lambda attn: GPT(get_config(name, attention_impl=attn,
                                               **over), device=dev),
        lambda m: make_train(m, opt, loss_fn(param_cast)),
        {"tokens": tokens}, batch * seq,
        {f"{impl}_fwd": L * (2 if cfg.remat else 1),
         f"{impl}_bwd_dq": L, f"{impl}_bwd_dkv": L},
        steps=steps, impl=impl, ref_impl=ref_impl, warmup=warmup)
    aux_losses = res["moe_aux_losses"]
    check(len(aux_losses) == (steps if cfg.moe_experts else 0)
          and all(math.isfinite(a) and a > 0 for a in aux_losses),
          f"MoE aux losses {aux_losses}: wanted one per step, finite and "
          "positive")
    tokens_s = res.pop("items_per_s")
    flops_per_token = 6 * active_params(cfg) + 12 * L * cfg.d_model * seq
    out = {"model": name, "attention_impl": impl,
           "active_params": active_params(cfg), "n_layers": L,
           "d_model": cfg.d_model, "n_heads": cfg.n_heads,
           "vocab": cfg.vocab_size, "batch": batch, "seq": seq,
           "remat_policy": cfg.remat_policy, "optimizer": optimizer,
           "loss_head": "chunked" if chunked else "dense",
           "param_cast": str(param_cast), "warmup_steps": 1 + warmup,
           "optimizer_state_bytes": state_nbytes(state.opt_state), **res,
           "tokens_s": tokens_s, "flops_per_token": flops_per_token,
           "flops_per_token_formula": "6 * active_params + 12 * L * d * S",
           "mfu": flops_per_token * tokens_s / BF16_FLOPS}
    if nocast_steps:
        data = {"tokens": tokens}
        _, step_nocast = make_train(model, opt, loss_fn(None))
        state, _ = step_nocast(state, data)      # untimed first call
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        for _ in range(nocast_steps):
            state, m = step_nocast(state, data)
        check(math.isfinite(float(m["loss"])),
              f"non-finite loss without the hoisted cast: {m}")
        wall = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            state, _ = step_nocast(state, data)
            torch.cuda.synchronize()
        out["without_param_cast"] = {
            "steps": nocast_steps, "step_ms": wall / nocast_steps * 1e3,
            "tokens_s": batch * seq * nocast_steps / wall,
            "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
            "step_device_ms": step_groups(prof, impl)[0]}
    return out


def lean_train_phase(dev) -> dict:
    """bench.py's memory-lean run (gpt-large, 36 layers, 1.07 B
    parameters, at full width and depth): remat "nothing", the chunked
    CE head over a bf16 copy of the parameters cast once per step,
    Adafactor (warmup 10 / decay 1000), batch 10 x 1024; 3 warmup steps
    (the first held against the plain attention), 10 timed, then 3
    without the hoisted cast.  72 K1, 36 K2 and 36 K3 launches per step;
    the optimizer state within 1 KB of JAX's count for the same run
    (ADAFACTOR_STATE_BYTES); each kernel's device ms per launch at this
    shape beside its bound."""
    import torch
    res = train_phase(dev, name="gpt-large", batch=10, seq=1024, steps=10,
                      warmup=2, optimizer="adafactor",
                      remat_policy="nothing", chunked=True,
                      param_cast=torch.bfloat16, nocast_steps=3)
    got = res["optimizer_state_bytes"]
    check(abs(got - ADAFACTOR_STATE_BYTES) <= 1024,
          f"Adafactor state {got} B, JAX's {ADAFACTOR_STATE_BYTES} B: the "
          "statistics are not grouped as the JAX tree's leaves")
    per_step = {k: v // res["steps"] for k, v in res["launches"].items()}
    check(per_step["flash_fwd"] == 72 and per_step["flash_bwd_dq"] == 36
          and per_step["flash_bwd_dkv"] == 36,
          f"launches per step {per_step}, wanted 72 / 36 / 36")
    q = torch.empty(10, 1024, 20, 64, dtype=torch.bfloat16, device=dev)
    res["kernels_at_shape"] = {}
    for n, (ms, calls) in res["attention_device_ms_calls"].items():
        res["kernels_at_shape"][f"flash_{n}"] = {
            "shape": [10, 1024, 20, 64], "launches_per_step": calls,
            "ms": ms / calls if calls else None,
            **attn_bound(f"flash_{n}", q, q, True)}
    res["launches_per_step"] = per_step
    return res


def gptj_phase(dev) -> dict:
    """gptj-6b at full width (d_model 4096, 16 heads of 256, vocab 50400)
    and depth GPTJ_LAYERS: a batch of 2 x 1024 trained through K1-K3
    against the plain attention and through K5 against K1-K3 (each
    GPTJ_STEPS steps after the parity step, under the train phase's
    gates and launch counts), and the paged engine serving 4 requests
    (prompts 17-300 tokens, 16-32 new tokens) through K4 at head_dim
    256."""
    import torch
    out = {}
    for impl, ref in (("flash", "xla"), ("splash", "flash")):
        out[impl] = train_phase(dev, impl=impl, ref_impl=ref, name="gptj-6b",
                                batch=2, seq=1024, steps=GPTJ_STEPS,
                                n_layers=GPTJ_LAYERS)
        torch.cuda.empty_cache()
    model, _ = make_model(dev, "gptj-6b", n_layers=GPTJ_LAYERS)
    out["serve"], _, _ = slice_phase(dev, model, "gptj-6b", n_requests=4,
                                     new=(16, 32), num_slots=4)
    return out


def teacher_forced_moe(engine, prompt, tokens) -> dict:
    """The teacher-forced check for a model with experts, on the dense
    cache path (no paged kernel): the prompt prefilled padded as the
    engine pads it (its bucket, pad id 0), then the generated tokens fed
    one at a time (one token per row: capacity 1, nothing dropped).  A
    prefill's drops depend on its window, so one window over prompt +
    tokens (``teacher_forced``) would route them otherwise than the
    engine did.  Also counts the (token, choice) pairs the prefill
    dropped, over its whole window and over the prompt's own tokens."""
    import torch
    from ray_tpu_torch.models.generate import init_dense_cache
    cfg, dev, n = engine.cfg, engine.device, len(prompt)
    bucket = engine._bucket(n)
    cache = init_dense_cache(cfg, 1, device=dev,
                             seq_len=max(bucket, n + len(tokens)))
    dropped = []

    def count(moe, args, _out):
        x = args[0]
        _, _, _, pos = moe.route(x)
        over = pos >= moe.capacity(x.shape[1])
        dropped.append((int(over.sum()), int(over[:, :n].sum())))
    toks = torch.zeros(1, bucket, dtype=torch.int32, device=dev)
    toks[0, :n] = torch.tensor(prompt, device=dev)
    pos = torch.arange(bucket, device=dev)[None]
    hooks = [blk.moe.register_forward_hook(count)
             for blk in engine.model.blocks]
    try:
        with torch.no_grad():
            logits = [engine.model(toks, pos, kv_cache=cache)[0, n - 1]]
    finally:
        for h in hooks:
            h.remove()
    with torch.no_grad():
        for i, t in enumerate(tokens[:-1]):
            logits.append(engine.model(
                torch.tensor([[t]], dtype=torch.int32, device=dev),
                torch.tensor([[n + i]], device=dev), kv_cache=cache)[0, -1])
    pairs = cfg.moe_top_k * cfg.n_layers
    return {**forced_gaps(torch.stack(logits), tokens),
            "bucket": bucket, "window_pairs": bucket * pairs,
            "window_dropped": sum(d[0] for d in dropped),
            "prompt_pairs": n * pairs,
            "prompt_dropped": sum(d[1] for d in dropped)}


def moe_slice_phase(dev) -> dict:
    """mixtral-8x7b at full width (8 experts of d_ff 14336, top-2,
    capacity 1.25, GQA 32/8), depth MOE_SERVE_LAYERS, random bf16
    weights from the seed, served by the paged engine and then by the
    dense one with the slice phase's settings and 16 requests: every
    request completes; K4 launches n_layers x decode steps on the paged
    engine and never on the dense one; every greedy request passes the
    teacher-forced check (``teacher_forced_moe``).  Reports decode
    tokens/s, TTFT, decode step ms (wall; device ms by group, the
    experts' GEMMs apart), the busy share, peak memory and the share of
    (token, choice) pairs the prefills dropped."""
    import torch
    from ray_tpu_torch.ops.paged_attention import paged_attention_cuda
    from ray_tpu_torch.serve.llm_engine import LLMEngine

    model, init_s = make_model(dev, "mixtral-8x7b",
                               n_layers=MOE_SERVE_LAYERS)
    cfg = model.cfg
    reqs = make_requests(cfg.vocab_size)
    greedy = [i for i, r in enumerate(reqs) if r["temperature"] == 0]
    out = {"model": "mixtral-8x7b", "n_layers": cfg.n_layers,
           "params": sum(p.numel() for p in model.parameters()),
           "weight_bytes": sum(p.numel() * p.element_size()
                               for p in model.parameters()),
           "experts": cfg.moe_experts, "top_k": cfg.moe_top_k,
           "capacity_factor": cfg.moe_capacity_factor,
           "num_slots": 8, "max_seq_len": 1024, "block_size": 16,
           "page_size": 64, "requests": len(reqs), "init_s": init_s}
    for mode in ("paged", "dense"):
        paged = mode == "paged"
        engine = LLMEngine(cfg, model, paged=paged, num_slots=8,
                           page_size=64, max_seq_len=1024, block_size=16,
                           top_k=50, seed=SEED, device=dev)
        try:
            t0 = time.perf_counter()
            engine.warmup(prompt_lens=[len(r["prompt"]) for r in reqs])
            warm_s = time.perf_counter() - t0
            torch.cuda.reset_peak_memory_stats(dev)
            for kernel in kernel_counters().values():
                kernel.launches = 0
            results, _, wall = serve(engine, reqs)
            launches = paged_attention_cuda.launches
            steps = engine.stats.steps
            check_results(reqs, results, cfg.vocab_size)
            want = cfg.n_layers * steps if paged else 0
            check(launches == want and (launches > 0) == paged,
                  f"{mode}: paged kernel launches {launches}, wanted "
                  f"{want} (n_layers x decode steps {steps} when paged)")
            peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
            forced = [teacher_forced_moe(engine, reqs[i]["prompt"],
                                         results[i].tokens)
                      for i in greedy]
            step_ms, step_device = decode_step(engine)
        finally:
            engine.close()
        window = sum(f["window_pairs"] for f in forced)
        prompt = sum(f["prompt_pairs"] for f in forced)
        out[mode] = {
            "paged_kernel_launches": launches,
            **serving_metrics(engine, results, wall, 8),
            "decode_step_ms": step_ms, "decode_step_device_ms": step_device,
            "device_busy_share": sum(step_device.values()) / step_ms,
            "peak_mem_gb": peak_gb, "warmup_s": warm_s,
            "prefill_drop_share": sum(f["window_dropped"] for f in forced)
            / window,
            "prompt_drop_share": sum(f["prompt_dropped"] for f in forced)
            / prompt,
            "teacher_forced": forced}
        check_forced(forced)
    return out


def moe_train_phase(dev) -> dict:
    """mixtral-8x7b at full width, depth MOE_TRAIN_LAYERS, trained for
    MOE_TRAIN_STEPS steps after the parity step: Adafactor (warmup 10 /
    decay 1000), remat "dots", the dense lm_loss_fn head, attention
    "flash", batch 8 x 1024, under the train phase's gates (its first
    step against the plain attention's, losses falling, the MoE aux loss
    finite and positive, 2 K1, 1 K2 and 1 K3 launches per layer and
    step); the Adafactor state within 1 KB of JAX's
    (MIXTRAL_ADAFACTOR_STATE_BYTES)."""
    res = train_phase(dev, name="mixtral-8x7b", batch=8, seq=1024,
                      steps=MOE_TRAIN_STEPS, n_layers=MOE_TRAIN_LAYERS,
                      optimizer="adafactor")
    got = res["optimizer_state_bytes"]
    check(abs(got - MIXTRAL_ADAFACTOR_STATE_BYTES) <= 1024,
          f"Adafactor state {got} B, JAX's {MIXTRAL_ADAFACTOR_STATE_BYTES} "
          "B: the statistics are not grouped as the JAX tree's leaves")
    return res


# The encoder and vision families at full width (vision_train and
# encoder_train): steps per run after the parity step, and each run's
# batch
FAMILY_STEPS = 10
VIT_BATCH = 128
# benchmarks/vision_perf.py:89-93: ResNet-50 at CIFAR-10's 32 px / 10
# classes (batch 1024, the CIFAR stem) and at 224 px / 1000 classes
# (batch 256)
RESNET_RUNS = (("resnet50_cifar10", 32, 10, 1024),
               ("resnet50_imagenet_shape", 224, 1000, 256))
# BERT and T5 at gpt-small's widths (768, 12 layers of 12 heads, vocab
# 50304; ray_tpu/models/configs.py:86-87): sequences of 512 (T5's
# decoder 128), batch 16; greedy decoding of 32 tokens on 4 prompts
ENCODER_BATCH, ENCODER_SEQ, DECODER_SEQ = 16, 512, 128
# flash_phase's shapes of the training paths, as the kernel rows name
# them (the first three timed)
PATH_SHAPES = ("vit", "large", "mixtral", "bert", "t5_cross", "t5_self",
               "air_predict", "air_tune", "dt", "dt_bf16", "hd32",
               "hd32_bf16")
GREEDY_PROMPTS, GREEDY_TOKENS = 4, 32
# the greedy decode's query and key projections are scaled by this over
# init_weights' draw (attention logits by its square), see
# encoder_train_phase
GREEDY_QK_SCALE = 3.0


def kernel_counters() -> dict:
    """Every kernel wrapper of the port by kernel name; each counts its
    launches in ``.launches``."""
    from ray_tpu_torch.ops import flash_attention, paged_attention, splash
    out = {f"{fam}_{n}": getattr(mod, f"{fam}_{n}_cuda")
           for fam, mod in (("flash", flash_attention), ("splash", splash))
           for n in ("fwd", "bwd_dq", "bwd_dkv")}
    out["paged_attention"] = paged_attention.paged_attention_cuda
    return out


class _ShapeTally:
    """A flash kernel wrapper that tallies its calls by (kind, q_len,
    kv_len, causal) in ``calls`` and calls the wrapper it stands for.
    ``launches`` is that wrapper's own counter, which the wrapper adds
    to through the module's name for it (this object, while it stands
    there)."""

    def __init__(self, fn, kind: str, calls: dict):
        self.fn, self.kind, self.calls = fn, kind, calls

    @property
    def launches(self):
        return self.fn.launches

    @launches.setter
    def launches(self, value):
        self.fn.launches = value

    def __call__(self, q, k, *args, **kw):
        key = (f"{self.kind} q{q.shape[1]} kv{k.shape[1]} "
               + ("causal" if kw["causal"] else "full"))
        self.calls[key] = self.calls.get(key, 0) + 1
        return self.fn(q, k, *args, **kw)


class FlashShapes:
    """Within the ``with``, every flash kernel launch is tallied by
    (kind, q_len, kv_len, causal) in ``.calls`` (``_ShapeTally`` stands
    in ``ops.flash_attention`` for each wrapper; the launch counts stay
    the wrappers' own)."""

    def __enter__(self):
        from ray_tpu_torch.ops import flash_attention as mod
        self.calls, self.saved = {}, {}
        for n in ("fwd", "bwd_dq", "bwd_dkv"):
            name = f"flash_{n}_cuda"
            self.saved[name] = getattr(mod, name)
            setattr(mod, name, _ShapeTally(self.saved[name], n, self.calls))
        return self

    def __exit__(self, *exc):
        from ray_tpu_torch.ops import flash_attention as mod
        for name, fn in self.saved.items():
            setattr(mod, name, fn)


def family_train(dev, label: str, build, make_step, data, items: int,
                 expected_per_step: dict, *, steps: int = FAMILY_STEPS,
                 impl: str = "flash", ref_impl="xla", warmup: int = 0,
                 shapes: bool = False) -> tuple:
    """Train one model on the card at full width: ``build(impl)`` makes it
    (random weights from the seed are drawn here), ``make_step(model)``
    returns its ``(init_fn, step_fn)``, ``data`` is one fixed batch of
    ``items`` images or tokens.  The first step must agree with one step
    of the same weights through ``ref_impl`` attention (None for a model
    without attention): loss within LOSS_RTOL, gradient norm within
    GRAD_NORM_RTOL.  Then ``warmup`` untimed steps and ``steps`` timed
    ones, whose losses must be finite and fall and whose launch counts
    must be ``expected_per_step`` x steps (every other kernel at 0); with
    ``shapes``, the flash launches by shape (``FlashShapes``).  Then one
    profiled step, split by ``step_groups(prof, impl)``.  Returns (the
    run's results, the model, the train state)."""
    import contextlib
    import torch
    from torch.profiler import ProfilerActivity, profile
    from ray_tpu_torch.models.convert import init_weights
    model = build(impl)
    init_weights(model, torch.Generator(device=dev).manual_seed(SEED))
    parity = None
    if ref_impl is not None:
        ref = build(ref_impl)
        ref.load_state_dict(model.state_dict())
        init_r, step_r = make_step(ref)
        _, mr = step_r(init_r(), data)
        ref_m = {k: float(v) for k, v in mr.items()}
        del ref, init_r, step_r, mr
        torch.cuda.empty_cache()
    init_fn, step_fn = make_step(model)
    state = init_fn()
    state, m1 = step_fn(state, data)
    first = {k: float(v) for k, v in m1.items()}
    if ref_impl is not None:
        parity = {"reference": ref_impl, ref_impl: ref_m, impl: first,
                  "loss_rel": abs(first["loss"] - ref_m["loss"])
                  / abs(ref_m["loss"]),
                  "grad_norm_rel": abs(first["grad_norm"]
                                       - ref_m["grad_norm"])
                  / abs(ref_m["grad_norm"])}
        check(parity["loss_rel"] <= LOSS_RTOL
              and parity["grad_norm_rel"] <= GRAD_NORM_RTOL,
              f"{label}: the {impl} step disagrees with the {ref_impl} "
              f"step: {parity}")
    for _ in range(warmup):
        state, _ = step_fn(state, data)
    kernels = kernel_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for kfn in kernels.values():
        kfn.launches = 0
    metrics = []
    with (FlashShapes() if shapes else contextlib.nullcontext()) as tally:
        t0 = time.perf_counter()
        for _ in range(steps):
            state, m = step_fn(state, data)
            metrics.append(m)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {n: kfn.launches for n, kfn in kernels.items()}
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    losses = [float(m["loss"]) for m in metrics]
    grad_norms = [float(m["grad_norm"]) for m in metrics]
    expected = dict.fromkeys(kernels, 0)
    expected.update({k: v * steps for k, v in expected_per_step.items()})
    check(launches == expected,
          f"{label}: kernel launches {launches} != expected {expected}")
    check(all(math.isfinite(x) for x in losses + grad_norms),
          f"{label}: non-finite loss or grad norm: {losses} {grad_norms}")
    check(losses[-1] < losses[0], f"{label}: the loss did not fall: "
                                  f"{losses}")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, _ = step_fn(state, data)
        torch.cuda.synchronize()
    groups, attention, top = step_groups(prof, impl)
    step_s = wall / steps
    out = {"params": sum(p.numel() for p in model.parameters()),
           "steps": steps, "parity": parity, "losses": losses,
           "grad_norms": grad_norms,
           "moe_aux_losses": [float(m["moe_aux_loss"]) for m in metrics
                              if "moe_aux_loss" in m],
           "last_metrics": {k: float(v) for k, v in metrics[-1].items()},
           "launches": launches, "expected_launches": expected,
           "step_ms": step_s * 1e3, "items_per_s": items / step_s,
           "peak_mem_gb": peak_gb, "step_device_ms": groups,
           "attention_device_ms_calls": attention,
           "top_kernels_ms_calls": top,
           "device_busy_share": sum(groups.values()) / (step_s * 1e3)}
    if shapes:
        out["flash_calls_by_shape"] = {
            k: v // steps for k, v in sorted(tally.calls.items())}
    return out, model, state


def vision_train_phase(dev) -> dict:
    """ViT-B/16 (vit.py:63; 224 px, 1000 classes, batch VIT_BATCH, AdamW
    warmup 10 / decay 1000) through make_vision_train: its first step
    with attention "xla" against one with "flash" from the same weights,
    then FAMILY_STEPS flash steps, 12 K1, 12 K2 and 12 K3 launches per
    step (no remat) and none of the other kernels.  Then ResNet-50 at
    benchmarks/vision_perf.py's two settings (RESNET_RUNS) for
    FAMILY_STEPS steps each under the same loss gates, no kernel
    launched, and its BatchNorm statistics finite and moved from their
    init (mean 0, var 1).  Images N(0, 1) and labels from the seed."""
    import torch
    from ray_tpu_torch.models.resnet import ResNet50
    from ray_tpu_torch.models.vit import ViT, get_vit_config
    from ray_tpu_torch.train.step import OptimizerConfig, make_vision_train
    opt = OptimizerConfig(warmup_steps=10, decay_steps=1000)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def images(b, px, classes):
        return {"image": torch.randn(b, px, px, 3, generator=gen,
                                     device=dev),
                "label": torch.randint(0, classes, (b,), generator=gen,
                                       device=dev)}

    def make_step(model):
        return make_vision_train(model, opt)

    def build_vit(impl):
        return ViT(get_vit_config("vit-b16", attention_impl=impl),
                   device=dev)

    out = {}
    t0 = time.perf_counter()
    cfg = get_vit_config("vit-b16")
    per_step = {f"flash_{n}": cfg.n_layers
                for n in ("fwd", "bwd_dq", "bwd_dkv")}
    res, vit, _ = family_train(dev, "vit-b16", build_vit, make_step,
                               images(VIT_BATCH, 224, 1000), VIT_BATCH,
                               per_step, shapes=True)
    del vit
    torch.cuda.empty_cache()
    out["vit_b16"] = {"image_px": 224, "num_classes": 1000,
                      "batch": VIT_BATCH, "patches": cfg.num_patches,
                      "img_per_s": res.pop("items_per_s"), **res,
                      "phase_s": time.perf_counter() - t0}
    for label, px, classes, batch in RESNET_RUNS:
        t0 = time.perf_counter()

        def build_resnet(_impl, px=px, classes=classes):
            return ResNet50(num_classes=classes, small_inputs=px <= 64,
                            device=dev)

        res, model, _ = family_train(dev, label, build_resnet, make_step,
                                     images(batch, px, classes), batch, {},
                                     ref_impl=None)
        stats = dict(model.named_buffers())
        moved = {"mean": max(float(b.abs().max()) for n, b in
                             stats.items() if n.endswith("mean")),
                 "var": max(float((b - 1).abs().max()) for n, b in
                            stats.items() if n.endswith("var"))}
        check(all(bool(torch.isfinite(b).all()) for b in stats.values())
              and moved["mean"] > 0 and moved["var"] > 0,
              f"{label}: BatchNorm statistics not finite or not moved: "
              f"{moved}")
        del model
        torch.cuda.empty_cache()
        out[label] = {"image_px": px, "num_classes": classes,
                      "batch": batch, "small_inputs": px <= 64,
                      "img_per_s": res.pop("items_per_s"), **res,
                      "batch_stats_moved": moved,
                      "phase_s": time.perf_counter() - t0}
    return out


def encoder_train_phase(dev) -> dict:
    """BERT and T5 at gpt-small's widths (12 layers of 12 heads of 64,
    d_model 768, vocab 50304; remat "dots"), AdamW warmup 10 / decay
    1000, through make_train: the family_train gates, with K1 launched
    twice per attention layer and step (remat recomputes the forward)
    and K2 and K3 once.  BERT: batch ENCODER_BATCH x ENCODER_SEQ with
    masked_batch's 80/10/10 corruption, then one forward with a padding
    mask, which must launch no kernel (a mask sends attention to
    dense_attention).  T5: encoder ENCODER_SEQ, decoder DECODER_SEQ; the
    kernels' calls by shape must show the cross-attention (q
    DECODER_SEQ over kv ENCODER_SEQ, non-causal); then greedy_decode of
    GREEDY_TOKENS tokens on GREEDY_PROMPTS prompts, from fresh random
    weights with the query and key projections scaled by GREEDY_QK_SCALE,
    must equal, token for token, the argmax of one teacher-forced forward
    over the tokens it chose (the same fixed-shape buffer, so the same
    arithmetic), and no row may be one token repeated."""
    import numpy as np
    import torch
    from ray_tpu_torch.models.bert import BERT, masked_batch, mlm_loss_fn
    from ray_tpu_torch.models.configs import get_config
    from ray_tpu_torch.models.convert import init_weights
    from ray_tpu_torch.models.t5 import T5, greedy_decode, seq2seq_loss_fn
    from ray_tpu_torch.train.step import OptimizerConfig, make_train
    opt = OptimizerConfig(warmup_steps=10, decay_steps=1000)
    rng = np.random.default_rng(SEED)
    out = {}

    def builder(cls):
        return lambda impl: cls(get_config(
            "gpt-small", max_seq_len=ENCODER_SEQ, attention_impl=impl),
            device=dev)

    def maker(loss_fn):
        return lambda model: make_train(model, opt, loss_fn)

    cfg = get_config("gpt-small")
    L, vocab = cfg.n_layers, cfg.vocab_size
    t0 = time.perf_counter()
    toks = rng.integers(0, vocab - 1, (ENCODER_BATCH, ENCODER_SEQ))
    mb = masked_batch(toks, vocab, mask_token=vocab - 1, seed=SEED)
    data = {k: torch.as_tensor(v, device=dev) for k, v in mb.items()}
    res, bert, _ = family_train(
        dev, "bert", builder(BERT), maker(mlm_loss_fn), data,
        ENCODER_BATCH * ENCODER_SEQ,
        {"flash_fwd": 2 * L, "flash_bwd_dq": L, "flash_bwd_dkv": L})
    kernels = kernel_counters()
    for kfn in kernels.values():
        kfn.launches = 0
    mask = torch.ones_like(data["tokens"])
    mask[:, ENCODER_SEQ // 2:] = 0
    with torch.no_grad():
        logits = bert(data["tokens"], mask)
    torch.cuda.synchronize()
    masked = {n: kfn.launches for n, kfn in kernels.items()}
    check(not any(masked.values()) and bool(torch.isfinite(logits).all()),
          f"bert: a forward with a padding mask launched {masked} or is "
          "not finite")
    del bert, logits
    torch.cuda.empty_cache()
    out["bert"] = {"batch": ENCODER_BATCH, "seq": ENCODER_SEQ,
                   "masked_tokens": int((mb["labels"] >= 0).sum()),
                   "tokens_per_s": res.pop("items_per_s"), **res,
                   "padding_mask_forward_launches": masked,
                   "phase_s": time.perf_counter() - t0}

    t0 = time.perf_counter()
    data = {"enc_tokens": torch.as_tensor(rng.integers(
                0, vocab, (ENCODER_BATCH, ENCODER_SEQ)), device=dev),
            "dec_tokens": torch.as_tensor(rng.integers(
                0, vocab, (ENCODER_BATCH, DECODER_SEQ + 1)), device=dev)}
    res, t5, _ = family_train(
        dev, "t5", builder(T5), maker(seq2seq_loss_fn), data,
        ENCODER_BATCH * (ENCODER_SEQ + DECODER_SEQ),
        {"flash_fwd": 6 * L, "flash_bwd_dq": 3 * L,
         "flash_bwd_dkv": 3 * L}, shapes=True)
    cross = {k: v for k, v in res["flash_calls_by_shape"].items()
             if f"q{DECODER_SEQ} kv{ENCODER_SEQ} full" in k}
    check(cross == {f"{n} q{DECODER_SEQ} kv{ENCODER_SEQ} full": c
                    for n, c in (("fwd", 2 * L), ("bwd_dq", L),
                                 ("bwd_dkv", L))},
          f"t5: cross-attention calls per step {cross}, wanted 2L / L / L "
          f"at q {DECODER_SEQ} over kv {ENCODER_SEQ}")
    # decode from fresh random weights: ten steps on one fixed batch
    # collapse the model onto a single token.  At the reference's init the
    # attention over 512 keys is near uniform, so every decoder position
    # sees about the same average of the memory and most rows repeat one
    # token; GREEDY_QK_SCALE on every query and key projection sharpens it
    # so that the tokens vary along each row
    del t5
    torch.cuda.empty_cache()
    t5 = builder(T5)("flash")
    init_weights(t5, torch.Generator(device=dev).manual_seed(SEED))
    with torch.no_grad():
        for name, param in t5.named_parameters():
            if name.endswith(("attn.wq.weight", "attn.wk.weight")):
                param.mul_(GREEDY_QK_SCALE)
    t0_dec = time.perf_counter()
    prompts = data["enc_tokens"][:GREEDY_PROMPTS]
    tokens = greedy_decode(t5, prompts, max_len=GREEDY_TOKENS, bos_id=1)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0_dec
    buf = torch.cat([torch.ones_like(tokens[:, :1]), tokens], dim=1)
    with torch.no_grad():
        forced = t5(prompts, buf).argmax(-1)[:, :GREEDY_TOKENS]
    agree = float((forced == tokens).float().mean())
    distinct = [len(set(row)) for row in tokens.tolist()]
    check(tuple(tokens.shape) == (GREEDY_PROMPTS, GREEDY_TOKENS)
          and agree == 1.0 and min(distinct) > 1,
          f"t5: greedy_decode's tokens and the teacher-forced argmax "
          f"agree in {agree} of {tuple(tokens.shape)}, distinct tokens "
          f"per row {distinct}")
    del t5
    torch.cuda.empty_cache()
    out["t5"] = {"batch": ENCODER_BATCH, "enc_seq": ENCODER_SEQ,
                 "dec_seq": DECODER_SEQ,
                 "tokens_per_s": res.pop("items_per_s"), **res,
                 "greedy": {"prompts": GREEDY_PROMPTS,
                            "tokens": GREEDY_TOKENS, "decode_s": decode_s,
                            "agree": agree, "distinct_per_row": distinct,
                            "first_row": tokens[0, :8].tolist()},
                 "phase_s": time.perf_counter() - t0}
    return out


def loss_check(dev) -> dict:
    """chunked_lm_loss on bf16 CUDA tensors, whose chunk logits come from
    torch.mm(..., out_dtype=torch.float32), against the same call on the
    CPU (operands taken to fp32): hidden [2, 256, 128] bf16, a tied fp32
    weight of a 4096-token vocab, z-loss 1e-4, chunks of 128, from the
    seed.  The CPU test's bounds against JAX: the loss within 1e-5
    relative, the weight gradient within 1e-3 of the largest, the hidden
    gradient within 1e-3 of the largest plus 2^-7 of each element."""
    import numpy as np
    import torch
    from ray_tpu_torch.ops.losses import chunked_lm_loss
    rng = np.random.default_rng(SEED)
    hidden = torch.from_numpy(rng.standard_normal((2, 256, 128)).astype(
        np.float32)).to(torch.bfloat16)
    w = torch.from_numpy((rng.standard_normal((4096, 128)) * 0.05).astype(
        np.float32))
    labels = torch.from_numpy(rng.integers(0, 4096, (2, 256)))
    mask = torch.from_numpy((rng.random((2, 256)) < 0.8).astype(np.float32))
    out = []
    for d in (dev, torch.device("cpu")):
        h = hidden.to(d, copy=True).requires_grad_()
        wt = w.to(d, copy=True).requires_grad_()
        loss, _ = chunked_lm_loss(h, wt, labels.to(d), mask.to(d), 1e-4, 128,
                                  transpose_weight=True)
        loss.backward()
        out.append((loss.item(), h.grad.float().cpu(), wt.grad.cpu()))
    (lg, gh, gw), (lw, wh, ww) = out
    res = {"loss_rel": abs(lg - lw) / abs(lw),
           "grad_w_rel": float((gw - ww).abs().max() / ww.abs().max()),
           "grad_h_over": float(((gh - wh).abs() - 2.0 ** -7 * wh.abs()
                                 ).max() / wh.abs().max())}
    check(res["loss_rel"] <= 1e-5 and res["grad_w_rel"] <= 1e-3
          and res["grad_h_over"] <= 1e-3,
          f"chunked_lm_loss on the card disagrees with the CPU: {res}")
    return res


def main() -> int:
    if not (ROOT / "ray_tpu_torch" / "csrc").is_dir():
        print("chip_smoke.py runs from a checkout that holds ray_tpu_torch/",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py needs the card",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = smi_line()
    print(smi, flush=True)

    from ray_tpu_torch.ops import _build
    libs = ("paged_attention", "flash_attention", "splash_attention")
    t0 = time.perf_counter()
    _build.build(libs)
    build_s = time.perf_counter() - t0
    device = {"phase": "device", "nvidia_smi": smi,
              "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count(),
              "torch": torch.__version__, "cuda": torch.version.cuda,
              "build_s": build_s,
              "nvcc_s": {n: _build.build_log[n][0] for n in libs},
              "ptxas": {n: [ln.strip() for ln in _build.build_log[n][1]
                            .splitlines()
                            if "registers" in ln or "spill" in ln]
                        for n in libs}}
    emit(device)

    if sys.argv[1:2] == ["--ab"]:
        ab = paged_ab(dev, [Path(a).resolve() for a in sys.argv[2:]])
        out_dir = ROOT / "chiprun_out"
        out_dir.mkdir(exist_ok=True)
        (out_dir / "paged_ab.json").write_text(json.dumps(
            {"device": device, "paged_ab": ab}, indent=1))
        emit({"phase": "paged_ab", **ab})
        print(smi_line(), flush=True)
        return 0

    kern = kernel_phase(dev)
    emit({"phase": "kernel", "name": "paged_attention", **kern})

    llama, init_s = make_model(dev, "llama3-8b")
    sl, launches, real_err = slice_phase(dev, llama)
    sl["init_s"] = init_s
    emit(sl)
    torch.cuda.empty_cache()

    dense = dense_slice_phase(dev, llama, sl)
    emit({"phase": "dense_slice", **dense})
    torch.cuda.empty_cache()

    prefix = prefix_handoff_phase(dev, llama)
    emit({"phase": "prefix_handoff", **prefix})
    del llama
    torch.cuda.empty_cache()

    runtime = runtime_phase(dev)
    emit({"phase": "runtime", **runtime})
    torch.cuda.empty_cache()

    served = serve_phase(dev)
    emit({"phase": "serve", **served})
    torch.cuda.empty_cache()

    flash = flash_phase(dev)
    emit({"phase": "flash", **flash})
    torch.cuda.empty_cache()

    splash = splash_phase(dev)
    emit({"phase": "splash", **splash})
    torch.cuda.empty_cache()

    train = train_phase(dev)
    emit({"phase": "train", **train})
    torch.cuda.empty_cache()

    air = air_phase(dev, train, served)
    emit({"phase": "air", **air})
    torch.cuda.empty_cache()

    air_batch = air_batch_phase(dev)
    emit({"phase": "air_batch", **air_batch})
    torch.cuda.empty_cache()

    rl = rl_phase(dev)
    emit({"phase": "rl", **rl})
    torch.cuda.empty_cache()

    rl_replay = rl_replay_phase(dev)
    emit({"phase": "rl_replay", **rl_replay})
    torch.cuda.empty_cache()

    rl_continuous = rl_continuous_phase(dev)
    emit({"phase": "rl_continuous", **rl_continuous})
    torch.cuda.empty_cache()

    splash_train = train_phase(dev, impl="splash", ref_impl="flash")
    emit({"phase": "splash_train", **splash_train})
    torch.cuda.empty_cache()

    lean = lean_train_phase(dev)
    emit({"phase": "lean_train", **lean})
    torch.cuda.empty_cache()

    gptj = gptj_phase(dev)
    emit({"phase": "gptj", **gptj})
    torch.cuda.empty_cache()

    moe_slice = moe_slice_phase(dev)
    emit({"phase": "moe_slice", **moe_slice})
    torch.cuda.empty_cache()

    moe_train = moe_train_phase(dev)
    emit({"phase": "moe_train", **moe_train})
    torch.cuda.empty_cache()

    vision = vision_train_phase(dev)
    emit({"phase": "vision_train", **vision})
    torch.cuda.empty_cache()

    encoder = encoder_train_phase(dev)
    emit({"phase": "encoder_train", **encoder})
    torch.cuda.empty_cache()
    family_runs = {"vit_train": vision["vit_b16"], "bert_train":
                   encoder["bert"], "t5_train": encoder["t5"]}

    loss = loss_check(dev)
    emit({"phase": "loss", **loss})

    timed = [kern] + [kern[label] for label, _ in PAGED_TIMED[1:]]
    rows = [{
        "name": "paged_attention", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": KERNEL_REPLACES,
        "launches": launches,
        "max_abs_err": max([real_err] + [c["max_abs_err"] for c in
                                         timed + kern["coverage"]]),
        "ms": kern["kernel_ms"], "plain_ms": kern["ref_ms"],
        "bound_ms": kern["bound_ms"], "bound_by": kern["bound_by"],
        "library_ms": kern["library_ms"],
        "frac_differing_fp32": max(c["frac_differing_fp32"] for c in
                                   timed + kern["coverage"]),
        "launches_by_path": {
            "slice": launches,
            "dense_slice": dense["paged_kernel_launches"],
            "prefix_cache": prefix["with_cache"]["paged_kernel_launches"],
            "handoff_import":
                prefix["handoff"]["import_paged_kernel_launches"],
            "runtime_actor": runtime["actor"]["launches"],
            "serve_colocated": served["colocated"]["k4_launches"],
            "serve_disagg_decode": served["disagg"]["k4_launches"]["decode"],
            "serve_disagg_prefill":
                served["disagg"]["k4_launches"]["prefill"],
            "moe_slice": moe_slice["paged"]["paged_kernel_launches"],
            "moe_slice_dense": moe_slice["dense"]["paged_kernel_launches"],
            **{path: run["launches"]["paged_attention"]
               for path, run in family_runs.items()},
            **air_launches(air, "paged_attention"),
            **air_batch_launches(air_batch, "paged_attention"),
            **rl_launches(rl, "paged_attention"),
            **rl_replay_launches(rl_replay, "paged_attention"),
            **rl_continuous_launches(rl_continuous, "paged_attention")},
        **{label: {"ms": kern[label]["kernel_ms"],
                   "plain_ms": kern[label]["ref_ms"],
                   "bound_ms": kern[label]["bound_ms"],
                   "library_ms": kern[label]["library_ms"]}
           for label, _ in PAGED_TIMED[1:]},
        **{key: {hd: u[key] for hd, u in kern["usage"].items()}
           for key in ("registers", "local_bytes", "blocks_per_sm",
                       "smem_bytes")}}]
    for phase, run, source, replaced in (
            (flash, train, FLASH_SOURCE, FLASH_REPLACES),
            (splash, splash_train, SPLASH_SOURCE, SPLASH_REPLACES)):
        at_slice = phase["slice_shape"]
        for kind, replaces in replaced.items():
            r, w = at_slice[kind], phase["hd256_shape"][kind]
            rows.append({
                "name": kind, "route": "cuda", "source": source,
                "replaces": replaces, "launches": run["launches"][kind],
                "max_abs_err": max([r["max_abs_err"], w["max_abs_err"]] + [
                    c[kind]["max_abs_err"] for c in phase["coverage"]]),
                "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": r["library_ms"],
                "hd256": {key: w[key] for key in (
                    "ms", "plain_ms", "bound_ms", "library_ms", "tflop_s")},
                "fp32_hd256": {key: phase["fp32_hd256"][kind][key]
                               for key in ("ms", "bound_ms", "tflop_s",
                                           "plain_ms", "library_ms")}})
            rows[-1]["launches_by_path"] = {
                "train" if run is train else "splash_train":
                    run["launches"][kind],
                "moe_train": moe_train["launches"][kind],
                **{path: fam["launches"][kind]
                   for path, fam in family_runs.items()},
                **air_launches(air, kind),
                **air_batch_launches(air_batch, kind),
                **rl_launches(rl, kind),
                **rl_replay_launches(rl_replay, kind),
                **rl_continuous_launches(rl_continuous, kind)}
            for label in PATH_SHAPES:
                at = phase.get(f"{label}_shape")
                if at is not None:
                    rows[-1][label] = {"shape": at["shape"], **{
                        key: at[kind][key] for key in (
                            "ms", "plain_ms", "bound_ms", "bound_by",
                            "library_ms", "tflop_s", "max_abs_err",
                            "frac_differing") if key in at[kind]}}
                    rows[-1]["max_abs_err"] = max(rows[-1]["max_abs_err"],
                                                  at[kind]["max_abs_err"])
            if kind in lean["kernels_at_shape"]:
                rows[-1]["lean_train"] = {
                    "launches": lean["launches"][kind],
                    **{key: lean["kernels_at_shape"][kind][key] for key in (
                        "shape", "launches_per_step", "ms", "bound_ms",
                        "bound_by")}}
            tc = phase["tc_kernel"].get(kind.split("_", 1)[1])
            if tc is not None:
                rows[-1].update(tflop_s=r["tflop_s"], **{
                    key: {hd: u[key] for hd, u in tc.items()}
                    for key in ("registers", "local_bytes",
                                "blocks_per_sm")})
            if "frac_differing" in r:
                rows[-1]["frac_differing"] = r["frac_differing"]
    kernels = {"kernels": rows}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"device": device, "kernel": kern, "slice": sl,
         "dense_slice": dense, "prefix_handoff": prefix,
         "runtime": runtime, "serve": served, "flash": flash,
         "splash": splash, "train": train, "air": air,
         "air_batch": air_batch, "rl": rl, "rl_replay": rl_replay,
         "rl_continuous": rl_continuous, "run_s": time.perf_counter() - RUN_T0,
         "splash_train": splash_train,
         "lean_train": lean, "gptj": gptj, "moe_slice": moe_slice,
         "moe_train": moe_train, "vision_train": vision,
         "encoder_train": encoder, "loss": loss, **kernels},
        indent=1))
    emit({"phase": "run", "run_s": time.perf_counter() - RUN_T0})
    emit(kernels)
    print(smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
