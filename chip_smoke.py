#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (ray_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py                     # one card, every phase
    python3 chip_smoke.py rl_offpolicy ...    # the named phases only

It runs every phase, each printing one JSON line; any failure ends the
run with a nonzero exit code and no result line:

  device   the card (nvidia-smi name and power limit), torch/CUDA versions,
           then every kernel of the port built from csrc/ with nvcc, one
           nvcc per source, all started together.
  kernels  the paged-decode kernel (K4, split-context: one partial per
           context split, then a merge) against its plain PyTorch version
           on the same inputs at the serving paths' shapes (gpt2-small
           decode: 32 lanes, 12 heads of 64, block 16, ragged contexts up
           to 1024, bf16 and f32; llama-1b decode: 32 lanes, 4 kv heads x
           q_per_kv 8 of 64, ragged contexts up to 2048, bf16), at 4
           lanes of the gpt2 shape, and at GQA shapes (q_per_kv 2, 4, 7,
           8 and 12), at llama2-7b's decode shape (32 lanes, 32 kv
           heads of 128, contexts up to 4096) and at the serve cell's
           decode dispatch (32 lanes, 32 heads of 128) with 32, 9 and 4
           lanes decoding after prompts of its mix and the rest riding
           at ctx_len 1, then timed with CUDA
           events (median over launches, L2 flushed and the device held
           busy by a spin before each, so the host's launch is not timed)
           beside its bound, its plain version and one PyTorch library
           call; and once more without the spin, the host's enqueue
           included (ms_with_launch).  Each case names its split count
           and split length.  Then the paged-prefill kernel (K5, bf16)
           against the same plain version (paged_attention_reference),
           timed the same way beside its bound, the plain version and SDPA
           over the gathered context: the serve cell's prefill dispatch
           (32 lanes, T 32, 32 heads of 128, block 16, a 128-block table;
           contexts drawn from the serve-longprompt mix's prompt lengths,
           one lane at the full 2048 and 23 riders at ctx_len 1), llama-1b's
           (q_per_kv 8 of 64, 256 query rows a kv head, a lane with no
           context, whose rows must be zeros), a speculative verify step at
           T 5, q_per_kv 4 at head dim 128 and head dim 256.  K4 and K5
           with a sliding window as well: Mellum's window layers (32 query
           heads over 4 kv heads of 128, window 1024; K4 over contexts up
           to 4096 in bf16 and f32, K5 at its chunk of 240) and a window
           that is no multiple of a split (200 in K4, 100 in K5).  Then
           Mellum's expert layer at its published widths (64 experts of
           896 over 2304, top 8): the grouped products against the plain
           loop over the experts on the same routing, a decode step of 32
           tokens and a prefill dispatch with masked slots, which must get
           no expert work; timed beside their bound.  The seconds of the
           window and expert cases are reported (window_and_expert_s).
  flash    the flash-attention kernels K1 (forward), K2 (dq) and K3
           (dk, dv) against their plain versions at the train shape
           (B 24, L 1024, 12 heads of 64, causal; bf16 and f32), at the
           llama-1b train shape (B 4, L 2048, 32 heads of 64, causal,
           bf16), at D 128 and 256, non-causal with q_len != kv_len, at
           a length that is no multiple of a tile, at one rank's
           shard of each mesh phase (B 2, L 1024, 6 heads; B 2, L 2048,
           16 heads), at a block of the seq phases' ring (B 4, L 256,
           12 heads; B 4, L 1024, 16 heads; causal and full) and at a
           rank's row at 7B (L 4096 and 8192, 32 heads of 128); then timed
           the same way, beside
           scaled_dot_product_attention's forward (K1) and backward (K2
           and K3 together).  Each case names the design K1-K3 ran (bf16
           at D 64/128: the tensor cores, with P and dS rounded to bf16,
           held to TENSOR_CORE_TOLERANCE, 2**-7 of each row's largest
           value + 2**-7 relative, and for dq an absolute floor).
           Three faults planted on late rows of the train shape's plain
           outputs (K1's O, K2's dq, K3's dk and dv) must break that
           limit.
  serve    the serving path: InferenceEngine("gpt", "gpt2-small") at full
           width, random bf16 weights from a seed, 32 lanes, answering 24
           streamed requests (greedy and seeded, a shared prefix).  The
           kernel launch counts are set to 0 just before and read just
           after; the decode kernel must have run once per layer per
           decode step, the prefill kernel (K5) once per layer per
           prefill dispatch (and per verify step, in serve_spec).
  train    the training path: gpt.make_train_step(gpt2-small, adamw(1e-4))
           at full width (bf16 activations, fp32 params, random weights
           from a seed) on one repeated batch of 24 x 1024 random tokens,
           as bench.py drives the reference: 2 warm-up steps, then timed
           steps.  K1, K2 and K3 must each have run 12 times per timed
           step, every loss must be finite, the last below the first, and
           each within 0.02 of the trajectory recorded before K1 and K3
           moved to the tensor cores.
  parity   gpt2-small in float32: the same greedy requests through the
           engine on the card and on the CPU must give the same tokens.
  train_parity  gpt2-small widths in float32 at 2 layers, batch 2 x 256:
           one train step on the card and one on the CPU from the same
           weights and tokens; the losses and every gradient must agree.
  serve_llama  the Llama serving path: InferenceEngine("llama",
           "llama-1b") at full width and depth (22 layers, 32 query heads
           over 4 kv heads of 64), random bf16 weights drawn on the card
           from a seed, 32 lanes, 24 streamed requests as in serve; K4
           must have run once per layer per decode step, at q_per_kv 8.
  train_llama  llama.make_train_step(llama-1b, adamw(1e-4)) at full width
           and depth on one repeated batch of 4 x 2048 random tokens: 2
           warm-up steps, then 6 timed steps; K1, K2 and K3 (over the
           repeated kv heads) must each have run 22 times per timed step,
           the losses must be finite and falling, each within 0.02 of the
           trajectory recorded on the first run.
  llama_parity  llama-1b widths in float32 at 2 layers: the same greedy
           requests through the engine on the card and on the CPU (K4 at
           q_per_kv 8 in f32) must give the same tokens; one train step on
           2 x 128 tokens must give the same loss and gradients; and
           llama-tiny (head dim 16, whose decode step takes the
           masked-dense route) must give the same greedy tokens.
  serve_spec  speculative decoding at llama-1b (bf16, weights drawn on the
           card from seed 1234), spec_k 4 with the n-gram proposer, 32
           lanes, block 16: serve's 24 requests plus 8 greedy ones whose
           prompts repeat a 16-token pattern four times.  Every stream
           must finish with its count, the proposer must have drafted and
           verify steps run, K4 must have run 22 times per T=1 decode
           step and K5 22 times per prefill dispatch and per verify step
           (T > 1).
  spec_parity  gpt2-small in float32: greedy and seeded requests through
           the plain engine and the spec engine on the card and the spec
           engine on the CPU must give the same tokens.  llama-1b in bf16:
           one greedy request through the plain engine, then through a
           spec engine whose oracle proposer drafts that output (full
           k + 1 bursts); where the two streams first differ, the plain
           logits must be a near-tie (top-2 margin <= 2e-2 x max|logit|);
           K5 must have run 22 times per prefill dispatch and verify
           step of each llama engine.
  spec_model_draft  gpt2-small in bf16 drafting for itself
           (ModelDraftProposer on the target's weights, window 64,
           spec_k 3, 4 lanes): K1 must have run 12 times per draft
           forward and K5 12 times per prefill dispatch and verify step
           of the target engine (and of the plain engine), acceptance
           must be >= 0.9, the output the plain engine's but at
           near-ties; ms per propose is reported.
  logp     capture_logp=True with greedy, seeded and verify steps, each
           log-prob against log_softmax of a plain forward over the same
           tokens at the same temperature: gpt2-small in float32 within
           1e-4, llama-1b in bf16 within 2 x 2e-2 x max|logit| / temp,
           with K5 22 times per T > 1 dispatch of each llama engine.
  serve_disagg  disaggregated serving at llama-1b (bf16, full width, the
           weights of serve_llama): a PrefillLLMDeployment and a
           DecodeLLMDeployment, 32 lanes each, serve's 24 requests from
           concurrent client threads (prefill hop -> KV frame -> decode
           hop).  Every frame must be a v2 bf16 frame of 360,448 bytes of
           K/V per block; the decode side must import each distinct chain
           link once and hit >= 16 tokens per imported block; K4 must have
           run 22 times per decode step of the decode replica and never
           for the prefill replica, K5 22 times per prefill dispatch of
           either replica; each stream must equal serve_llama's
           for the request or part from it at a near-tie (for a sampled
           stream, of logits / temp + its Gumbel noise).  Prints frame
           bytes, export + encode and decode + import ms, TTFT (end to end
           and of the decode hop) beside serve_llama's, decode tokens/s.
  disagg_parity  f32 on the card, gpt2-small and llama-1b widths at 2
           layers: prefill replica -> v1 frame -> a fresh decode replica,
           greedy and seeded, token-exact against a monolithic
           LLMDeployment; a second import installs nothing; a bf16 pool's
           v2 frame, installed and exported again, is bit-exact.
  kv_tier  llama-1b bf16 with kv_tier=True, 8 lanes, a pool of 1.5x one
           round's worst case, 16 host blocks (the rest spills to files):
           three rounds of 8 distinct 160-token prompts, then round one
           again.  Blocks must spill and restore, the restored chains
           must hold the bits exported before eviction, the repeat's
           streams must equal a tier-less engine's (or part at a
           near-tie), K4 must have run 22 times per decode step and K5
           22 times per prefill dispatch; ms per spilled and per
           restored block are printed.
  rl_rollout  EngineRolloutActor("llama", "llama-1b") at full width and
           depth (bf16, weights drawn on the card, 32 lanes, block 16,
           temperature 1.0): two rollouts of 64 prompts of 48-96 tokens
           sharing a 32-token template, 32 new tokens each, with
           adopt(1, a second weight set) between them, then an adopt
           mid-flight after 5 steps of 32 live lanes.  Each batch must be
           [32, 64] time-major, its valid log-probs finite, <= 0 and the
           handles' own, tagged version 0 then 1; no lane may drop; K4
           must have run 22 times per decode step and K5 22 times per
           prefill dispatch.  Prints rollout
           tokens/s, decode step ms, prefix hit tokens, and two adopt
           times: adopt(1) from the host numpy tree that a publish
           delivers (copy to the card and bf16 cast), and the mid-flight
           adopt from weights already on the card (the cast alone).
  rl_learner  the V-trace learner (_VTraceLearner) on the Nature-CNN:
           fragments of 16 SyntheticPixel-v0 envs x 64 steps (1,024 uint8
           frames of 84x84x4) from a RolloutWorker on the card, IMPALA's
           defaults; 3 warm-up and 20 timed updates, losses finite.
           Prints update ms, updates/s, frames/s, peak memory.
  rl_podracer  PodracerConfig().build() with an in-process runtime (2
           EnvRolloutActors on CartPole-v1, 16 envs x 32 steps; actor
           calls run in order), the learner on the card, at staleness
           bounds 0, 1 and 2: updates/s, accepted and stale-dropped.  At
           k=0 the checkpoint at update 20 restores into a fresh learner
           bit for bit.  Then PPO with no remote workers, 3 iterations.
  rl_parity  f32, TF32 off: one V-trace update (MLP and Nature-CNN) on
           the card and on the CPU from the same weights and batch (loss
           within 1e-5 relative, every update within 0.05 x lr); greedy
           rollouts at llama-1b widths, 2 layers, on the card (K4) and on
           the CPU: actions token-exact, log-probs within 1e-4.
  rl_continuous  PPO with the Gaussian actor-critic on Pendulum-v1 at the
           reference's own test settings (16 envs x 128 steps, train
           batch 4096, minibatch 512, 10 SGD iterations, lr 1e-3, gamma
           0.95, hidden (64, 64)), policy and learner on the card: up to
           150 train() calls, stopping once episode_reward_mean > -400,
           and failing if it never gets there.  Then A2C and APPO on
           CartPole-v1 at their configs' defaults (2 rollout actors of
           the in-process runtime): 5 timed train() calls each, losses
           finite.  Prints iterations, ms per SGD minibatch, env frames/s.
  rl_offpolicy  SAC and TD3 on Pendulum-v1 and DQN on CartPole-v1 at
           their configs' defaults (SAC / TD3: (256, 256), batch 256, 32
           updates a step, replay 100k, warm-up 1,000, learning from
           1,500; 2 rollout actors of the in-process runtime): train()
           past learning_starts, then 10 timed rounds each; ms per
           update, updates/s, launches per update and the device's busy
           share (torch.profiler over 5 updates); SAC's alpha; DQN's
           target net must equal the params at its last sync after every
           round.
  rl_recurrent  the LSTM half of the reference's memory gate on
           RepeatPrev-v0 (32 envs x 24 steps, hidden (32,), lstm 32, 60
           iterations of TorchLearner(model="lstm") on the card): it must
           score > 40 of 48 (the feed-forward half, < 26, is a CPU test);
           launches per LSTM minibatch.  Then the recurrent V-trace
           learner at lstm 64 on 16 x 64 RepeatPrev fragments: ms per
           update and launches per update.
  rl_breadth_parity  f32, TF32 off: one update of each new learner (PPO
           Gaussian and LSTM, A2C, the recurrent V-trace, APPO, DQN, SAC,
           and TD3's two updates over its delay) on the card and on the
           CPU from the same weights, batch and noise: metrics within
           1e-5 relative + 1e-6, every update within 0.05 x lr; deterministic
           continuous actions within 1e-5, greedy recurrent actions
           equal.
  rl_offline, rl_multi_agent, rl_tune, rl_offline_parity  the offline
           gates (BC, MARWIL, CQL, FQE into DM / DR), multi-agent PPO,
           QMIX and VDN to their gates and the policy server, a PPO
           checkpoint restored bit for bit, and one update of each
           learner card vs CPU.
  rl_es    ES (24 directions, horizon 300, sigma 0.08, lr 0.05, seed 0)
           and ARS (16 directions, top 8, sigma 0.1, seed 1) on
           CartPole-v1 at the reference's learning tests' configs, 2
           evaluation workers of the in-process runtime, the population
           forward on the card: each must pass 150 within 30 / 35
           train() calls, ES's checkpoint must restore theta bit for
           bit, ARS's filter must have seen > 1000 observations.  ES at
           its defaults (32 directions, 64 lanes): 3 timed calls and one
           worker's evaluate profiled, which must run one batched
           product per layer per env step.  LinUCB and LinTS at their
           defaults: 15 calls, then the reference's near-oracle gate.
  rl_es_parity  f32, TF32 off, card against CPU: one ES evaluate (24
           directions) with equal returns and lengths and every step's
           forward within 1e-5; LinUCB's arms equal over 3 calls, A^-1
           and b within 1e-12.
  pipeline gpt2-small with an untied head (fp32 params, bf16
           activations) in four stage-chunks (embeddings + blocks 0-2,
           3-5, 6-8, 9-11 + final LayerNorm and head) through the port's
           PipelineTrainer on an in-process runtime (_PumpRuntime: every
           gang on this thread and this card), 6 microbatches of 4 x 1024
           a step, SGD, one warm-up and 3 timed steps: (a) 1F1B, (b)
           GPipe, (c) interleave 2 with prefetch, (d) (a) with gang 1
           killed mid-step 2 and replayed from its committed checkpoint.
           All four must give the same losses and params bit for bit;
           step 0 must agree with the single-program SGD step
           (`gpt.loss_fn`) on the same weights and batch; K1, K2 and K3
           must each run 72 times a step.  Prints ms a step for each and
           for the single-program step, the bytes and host ms of the
           chunk-boundary copies (one more step of (a)), the pump's
           bubble fraction, peak memory.
  pipeline_parity  the same pipeline at gpt2-small widths with 2 layers
           in f32, 2 steps, on the card and on the CPU: losses within
           1e-4 relative, each leaf's update within 2e-4 of its largest
           after one step and 4e-4 after two; K1-K3 8 launches each.
  train_mesh  gpt2-small at full width, 4 of its 12 layers (bf16
           activations, fp32 params, the single-device init on seed 0) on
           MeshConfig(data=2, fsdp=2, tensor=2): eight ranks spawned by
           the port's launcher, sharing card 0 over gloo (NCCL, one card
           each, where there are enough cards), a global batch of 8 x
           1024, 3 AdamW(1e-4) steps.  Against the single-device train
           step on the same weights and batches: every rank's losses
           (and one more step's on the last batch) within 3e-3, and
           each leaf's update on each rank's shard within 0.35 of the
           single device's in L2 norm (the limits sit between the sound
           runs' readings and those of runs with a fault injected,
           scripts/mesh_controls.py); with_logical_constraint's round
           trip of the token table exact; K1, K2 and K3 must each have
           run once per layer per step on every rank (counts set to 0 just
           before the steps and read just after, in each rank).  Prints
           the backend, the median step ms, the share of a step spent in
           collectives (one more step with a synchronize around each
           collective) and peak memory per rank.
  train_mesh_llama  llama-1b's widths at 2 layers on MeshConfig(data=2,
           tensor=2): four ranks, each with 16 query heads over 2 kv
           heads, a global batch of 4 x 2048, 3 AdamW steps; the same
           checks (K1-K3 2 launches per step per rank).
  train_mesh_seq  gpt2-small at full width, 4 layers, on MeshConfig(
           seq=4): four ranks, each with a quarter of every row, a
           global batch of 4 x 1024, 3 AdamW steps; attention is the
           ring (ops/ring_attention.py: K1 per block held, K2 and K3 per
           block in the backward).  The same checks, with K1-K3 held to
           r + 1 launches per layer per step on seq rank r (the causal
           ring skips later blocks).  First, in the same ranks, the ring
           on bf16 inputs at the run's shape (4 x 1024, 12 heads) against
           flash attention on the whole sequence on one card and
           against the plain ring in f32 (RING_TOLERANCE); the rotations'
           bytes and ms a step are printed apart.
  train_mesh_seq_llama  llama-1b's widths at 2 layers on MeshConfig(
           tensor=2, seq=2): four ranks, 16 query heads (the repeated
           kv heads ride the ring) and half of every row each, 4 x 2048,
           3 AdamW steps; the ring checked first at 4 x 2048, 32 heads.
  train_mesh_moe  gpt2-small's widths at 4 layers with 8 Switch experts
           on MeshConfig(data=2, expert=2): four ranks, 4 experts each,
           the global capacity and queue order, 8 x 1024, 3 AdamW steps;
           the same checks (K1-K3 4 launches per step per rank).
  pipeline_spmd  gpt2-small at full width and depth through
           pipeline_loss_dryrun on MeshConfig(stage=4): four ranks of 3
           blocks each, 4 microbatches of 2 x 1024 a step, the
           embeddings before the stages and the final LayerNorm, tied
           head and fused_cross_entropy after them fixed, 3 AdamW steps
           on the stage params, against the 12 blocks in turn on one
           device (the same function with no mesh): the losses within
           3e-3, each stage leaf's update within 0.35; K1-K3 3 x 4
           launches per step on every rank (a stage skips its blocks in
           the bubble).  Prints the hops' and the final all-reduce's
           bytes and ms.
  train_mesh_stage  gpt2-small at 4 layers on MeshConfig(data=2,
           stage=2): four ranks, 4 x 1024, 3 AdamW steps; the mesh
           checks, and the two stage ranks of each data rank equal to
           the bit (losses and a sha256 of their params).
  rl_learner_dp  PPO's TorchLearner (512 rows, obs 6, 3 actions, 4
           epochs of 128) and the V-trace learner (T 16, B 8) on two
           data-parallel ranks against one device, f32, two updates:
           the weights within rtol 1e-4, atol 1e-5; then one PPO.train()
           with learner_mesh MeshConfig(data=2), a LearnerGroup, against
           one device's.
  train_mesh_uneven  global batches that the row ranks do not divide
           (GSPMD's split: ceil(B / ranks) rows a rank, the pads
           masked), on the 4-rank gang, 3 AdamW steps each against one
           device: gpt2-small (4 of 12 layers) at 3 x 1024 on
           MeshConfig(data=2, tensor=2) and MeshConfig(data=4) (the last
           rank holds a pad row only and must still run K1-K3 4 times
           a step, its losses and params the others'), with each rank's
           first summed gradients within UNEVEN_GRAD_TOL of one device's
           and a rank_means control (each row rank normalised by its own
           count) beyond it; gpt2-small with 8 experts at 3 x 1024 on
           MeshConfig(data=2, expert=2): capacity 480 in every layer on
           every rank (a capacity_from_padded control reads 640), the
           dropped tokens per layer one device's; resnet50 at 63 x 224 x
           224 x 3 on MeshConfig(data=2) against one device taking the
           same 32 / 31 halves (equal to the bit) and the whole batch,
           with a rank_means control that must fail against the halves.
  train_7b  llama2-7b at full width, 2 of its 32 layers, with remat
           (each block gathers its layer over fsdp inside the recomputed
           function), on MeshConfig(fsdp=4): the four ranks on card 0
           over gloo, 4 x 4096, params drawn on the card from seed 0, 3
           AdamW steps against one device: the mesh checks, K1 twice per
           layer a step (forward and recompute), K2 and K3 once; each
           rank's measured step gathers every block leaf over fsdp twice
           a layer and reduce-scatters it once; each rank's peak within
           the arithmetic printed beside it (shards, one layer gathered,
           the head, activations).  A control without remat (one step)
           must equal the remat run's first loss and gradients to the
           bit (the recompute gives the same values) and fail the
           gathers count.
  train_resnet_mesh  resnet50 at train_resnet's batch (64 x 224 x 224 x
           3, bf16) on MeshConfig(data=2), 3 AdamW steps, against one
           device: losses within 0.05, each leaf's update within 0.85,
           the two ranks' params equal to the bit; the same run with
           each rank's gradients left its own must fail those checks.

Named on the command line only (not in the default run):

  train_7b_cards  on four cards, one rank each over NCCL: llama2-7b (8 x
           4096), llama3-8b (4 x 8192) and gpt 7b (8 x 4096) at full
           depth and width with remat on MeshConfig(fsdp=4), 3 AdamW
           steps on one repeated batch: the first loss against the
           port's single-device loss on card 0 on the same weights and
           rows (for llama2-7b the first summed gradients too, per leaf),
           finite falling losses, the launches and gathers counts of
           train_7b, each rank's peak within 40, 45 and 34 GiB and its
           printed bound; step ms, tokens/s per card, MFU, the
           collective share, the init's seconds and host memory.  Raises
           with fewer than four cards.

    python3 chip_smoke.py train_7b_cards train_mesh_llama train_mesh_seq \
        train_mesh_seq_llama train_mesh_moe pipeline_spmd \
        train_mesh_stage train_mesh_uneven rl_learner_dp train_resnet_mesh

runs it with the 2- and 4-rank mesh phases, whose gangs then take NCCL
(train_mesh's 8 ranks stay on gloo).

The mesh phases keep one RankGang up across phases of as many ranks.
Each phase's wall seconds follow it on a line of their own.  Then, on
lines of their own: the kernels' JSON record, the card's name and power
limit, and last {"ok": true, "device": {...}}.  Exits nonzero without a
card, and when the ray_tpu_torch package is not beside it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import types

import torch

# NVIDIA's H100 SXM data sheet: HBM3 rate; dense bf16 tensor-core and
# f32 (non-tensor) peaks, at the full 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# Kernel vs plain on the same inputs.  f32: the sums run in another
# order.  bf16: both sides compute in f32 and round once to bf16, so they
# may differ by one bf16 ulp (2**-7 relative at most).
TOLERANCE = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (1e-3, 2 ** -7)}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


# ---------------------------------------------------------------- kernels

def _decode_case(gen, *, b, kh, q_per_kv, d, bs, max_ctx, dtype,
                 ctx=None, window=None):
    h = kh * q_per_kv
    mb = max_ctx // bs
    nb = b * mb + 8
    if ctx is None:
        ctx = torch.randint(1, max_ctx + 1, (b,), generator=gen)
        ctx[:4] = torch.tensor([1, max_ctx, bs, bs + 1])  # tiling's edges
    else:
        ctx = torch.tensor(ctx)
    tables = torch.randperm(nb, generator=gen)[:b * mb].view(b, mb)

    def rand(*shape):
        return torch.randn(*shape, generator=gen).to(dtype).cuda()

    out = dict(q=rand(b, h, d), k_pool=rand(nb, bs, kh, d),
               v_pool=rand(nb, bs, kh, d),
               block_tables=tables.to(torch.int32).cuda(),
               ctx_lens=ctx.to(torch.int32).cuda())
    if window is not None:
        out["window"] = window
    return out


# About a millisecond of device time at the H100's clock: queued before
# each timed call, it keeps the device busy while the host enqueues the
# call, so the events time the device's work and not the host's launch.
SPIN_CYCLES = 2_000_000


def _time_ms(fn, reps: int = 40, spin: bool = True) -> float:
    """Median time of one call, L2 flushed before each.  With `spin`
    the device time; without it the events also take in the host's
    enqueue of the call, wherever that is longer than the device's
    work."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        flush.zero_()
        if spin:
            torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def _decode_bound(c) -> tuple:
    """Least time for this call's work on an H100: each input byte the
    call needs read once (the context's K/V rows, q, the table entries it
    reads, ctx_lens), the output written once; or its QK and PV flops at
    the peak for the input type.  Returns (ms, "bytes"|"operations")."""
    q, k = c["q"], c["k_pool"]
    b, h, d = q.shape
    _, bs, kh, _ = k.shape
    ctx = c["ctx_lens"].long()
    if c.get("window") is not None:     # a window reads its last positions
        ctx = ctx.clamp(max=c["window"])
    sz = q.element_size()
    kv_bytes = int(ctx.sum()) * kh * d * 2 * sz
    table_bytes = int(((ctx + bs - 1) // bs).sum()) * 4 + b * 4
    nbytes = kv_bytes + 2 * q.numel() * sz + table_bytes
    flops = 4 * int(ctx.sum()) * h * d
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[q.dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _gathered(c, pool):
    """[B, H, MB * BS, D]: each lane's whole table of `pool`, contiguous,
    its kv heads repeated over their query heads."""
    b, h, d = c["q"].shape[0], c["q"].shape[-2], c["q"].shape[-1]
    _, bs, kh, _ = pool.shape
    tables = c["block_tables"].long()
    x = pool[tables].reshape(b, tables.shape[1] * bs, kh, d).transpose(1, 2)
    return x.repeat_interleave(h // kh, dim=1).contiguous()


def _sdpa_inputs(c):
    """The contiguous, pre-gathered context for the library yardstick."""
    max_ctx = c["block_tables"].shape[1] * c["k_pool"].shape[1]
    pos = torch.arange(max_ctx, device=c["q"].device)[None]
    mask = pos < c["ctx_lens"][:, None]
    if c.get("window") is not None:
        mask &= pos >= c["ctx_lens"][:, None] - c["window"]
    mask = mask[:, None, None, :]
    return (c["q"][:, :, None], _gathered(c, c["k_pool"]),
            _gathered(c, c["v_pool"]), mask)


def _serve_decode_case(rng, live):
    """K4's operands at the serve cell's decode dispatch
    (cerebras-gpt-6.7b: 32 lanes, 32 heads of 128, block 16, a 128-block
    table): `live` lanes decoding after a prompt of the serve-longprompt
    mix (a context of prompt + 1-64 tokens), the rest riding along at
    ctx_len 1, as the engine's fixed-shape batch carries them."""
    ctx = [p + int(rng.integers(1, 65)) for p in _mix_prompts(rng, live)]
    return dict(b=32, kh=32, q_per_kv=1, d=128, bs=16, max_ctx=2048,
                dtype=torch.bfloat16, ctx=ctx + [1] * (32 - live))


def phase_kernels(report: dict) -> None:
    import numpy as np
    import torch.nn.functional as F

    from ray_tpu_torch.ops import attention as A

    gen = torch.Generator().manual_seed(0)
    serve_rng = np.random.default_rng(20)
    cases = {
        "gpt2-small-bf16": dict(b=32, kh=12, q_per_kv=1, d=64, bs=16,
                                max_ctx=1024, dtype=torch.bfloat16),
        "gpt2-small-f32": dict(b=32, kh=12, q_per_kv=1, d=64, bs=16,
                               max_ctx=1024, dtype=torch.float32),
        # Few lanes: one block per (lane, kv head) would be 48 blocks on
        # 132 SMs; the splits fill the card.
        "4-lane-bf16": dict(b=4, kh=12, q_per_kv=1, d=64, bs=16,
                            max_ctx=1024, dtype=torch.bfloat16),
        "gqa4-d128-bf16": dict(b=16, kh=8, q_per_kv=4, d=128, bs=16,
                               max_ctx=1024, dtype=torch.bfloat16),
        # q_per_kv 2: one block of two query heads per kv head.
        "gqa2-d128-bf16": dict(b=8, kh=4, q_per_kv=2, d=128, bs=16,
                               max_ctx=1024, dtype=torch.bfloat16),
        # q_per_kv 7 (Qwen2-7B: 28 query heads over 4): seven blocks of
        # one query head each per kv head.
        "gqa7-d128-bf16": dict(b=8, kh=4, q_per_kv=7, d=128, bs=16,
                               max_ctx=1024, dtype=torch.bfloat16),
        # q_per_kv 12: three blocks of four query heads per kv head.
        "gqa12-d64-f32": dict(b=4, kh=2, q_per_kv=12, d=64, bs=16,
                              max_ctx=512, dtype=torch.float32),
        # A 1 KB row: one warp per position, two 16-byte loads a thread.
        "gqa8-d256-f32": dict(b=4, kh=2, q_per_kv=8, d=256, bs=32,
                              max_ctx=256, dtype=torch.float32),
        # The llama-1b decode step: 32 query heads over 4 kv heads, one
        # block of eight query heads per kv head.
        "llama-1b-bf16": dict(b=32, kh=4, q_per_kv=8, d=64, bs=16,
                              max_ctx=2048, dtype=torch.bfloat16),
        # The llama2-7b decode step: 32 kv heads of 128, one query head
        # each, ragged contexts up to its 4096.
        "llama2-7b-bf16": dict(b=32, kh=32, q_per_kv=1, d=128, bs=16,
                               max_ctx=4096, dtype=torch.bfloat16),
        # The serve cell's decode dispatch with every lane decoding, and
        # with the 9 and the 4 live lanes its traced window held with K5
        # in the prefill path: the share of K4's bound at few live lanes.
        **{f"serve-6.7b-{n}live": _serve_decode_case(serve_rng, n)
           for n in (32, 9, 4)},
        # Mellum's window layers (32 query heads over 4 kv heads of 128,
        # a window of 1024): contexts up to 4096 read their last 1024
        # positions; a lane short of the window, one at it, one past it
        # by one, and the f32 kernel at the same window.
        **{f"mellum-window-{name}": dict(
            b=32, kh=4, q_per_kv=8, d=128, bs=16, max_ctx=4096, dtype=dt,
            window=1024, ctx=[1, 1023, 1024, 1025] + _window_ctx(
                serve_rng, 28))
           for name, dt in (("bf16", torch.bfloat16),
                            ("f32", torch.float32))},
        # A window that is not a multiple of the split: its first split
        # starts mid-split.
        "window-200-gqa2-bf16": dict(b=8, kh=4, q_per_kv=2, d=64, bs=16,
                                     max_ctx=1024, dtype=torch.bfloat16,
                                     window=200),
    }
    results = {}
    t_window = 0.0
    for name, spec in cases.items():
        t_case = time.perf_counter()
        c = _decode_case(gen, **spec)
        out = A.paged_decode_attention(**c)
        plain = A.paged_decode_attention_plain(**c)
        torch.cuda.synchronize()
        atol, rtol = TOLERANCE[spec["dtype"]]
        err = (out.float() - plain.float()).abs()
        ok = bool((err <= atol + rtol * plain.float().abs()).all())
        check(bool(torch.isfinite(out.float()).all()),
              f"{name}: kernel output not finite")
        check(ok, f"{name}: kernel disagrees with its plain version "
                  f"(max abs err {float(err.max())}, atol {atol}, "
                  f"rtol {rtol})")
        sdpa = _sdpa_inputs(c)
        bound_ms, bound_by = _decode_bound(c)
        results[name] = dict(
            max_abs_err=float(err.max()), atol=atol, rtol=rtol,
            ms=_time_ms(lambda: A.paged_decode_attention(**c)),
            ms_with_launch=_time_ms(lambda: A.paged_decode_attention(**c),
                                    spin=False),
            plain_ms=_time_ms(lambda: A.paged_decode_attention_plain(**c)),
            library_ms=_time_ms(lambda: F.scaled_dot_product_attention(
                sdpa[0], sdpa[1], sdpa[2], attn_mask=sdpa[3])),
            bound_ms=bound_ms, bound_by=bound_by,
            ctx_tokens=int(c["ctx_lens"].long().sum()),
            q_per_kv=spec["q_per_kv"], split_len=A.DECODE_SPLIT_LEN,
            splits=A.decode_splits(c["block_tables"].shape[1], spec["bs"],
                                   spec.get("window")),
            window=spec.get("window"))
        if spec.get("window") is not None:
            t_window += time.perf_counter() - t_case
    emit("kernels", cases=results)
    keys = ("max_abs_err", "ms", "ms_with_launch", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    report["paged_decode_attention"] = dict(
        name="paged_decode_attention", route="cuda",
        source="ray_tpu_torch/ops/csrc/paged_decode.cu",
        replaces="ray_tpu/ops/attention.py:291",
        **{k: results["gpt2-small-bf16"][k] for k in keys},
        llama_1b={k: results["llama-1b-bf16"][k] for k in keys},
        llama2_7b={k: results["llama2-7b-bf16"][k] for k in keys},
        serve_6_7b={n: {k: results[f"serve-6.7b-{n}live"][k] for k in keys}
                    for n in (32, 9, 4)})
    prefill = _prefill_kernel_cases(F, A)
    for r in prefill.values():
        case_s = r.pop("case_s")
        if r["window"] is not None:
            t_window += case_s
    emit("kernels", prefill_cases=prefill)
    t_case = time.perf_counter()
    experts = _expert_cases()
    emit("kernels", expert_cases=experts,
         window_and_expert_s=t_window + time.perf_counter() - t_case)
    report["paged_prefill_attention"] = dict(
        name="paged_prefill_attention", route="cuda",
        source="ray_tpu_torch/ops/csrc/paged_prefill.cu", replaces=None,
        **{k: prefill["serve-6.7b"][k] for k in keys},
        llama_1b={k: prefill["llama-1b"][k] for k in keys},
        verify_t5={k: prefill["verify-t5-llama-1b"][k] for k in keys},
        mellum_window={k: prefill["mellum-window"][k] for k in keys})
    report["paged_decode_attention"]["mellum_window"] = {
        k: results["mellum-window-bf16"][k] for k in keys}
    report["grouped_experts"] = dict(
        name="grouped_experts", route="cuda",
        source="torch._grouped_mm (ray_tpu_torch/models/mellum.py)",
        replaces=None, **{k: experts["decode-32"][k] for k in keys},
        prefill=experts["prefill-2x240"])


def _window_ctx(rng, n):
    """n contexts up to 4096, uniform."""
    return [int(x) for x in rng.integers(1, 4097, n)]


# Mellum's expert layer at its published widths: 64 experts of SwiGLU
# width 896 over d_model 2304, top 8, weights N(0, 0.02) in bf16.  The
# grouped products (torch._grouped_mm, one a projection) against the
# plain loop over the experts on the same tokens and routing.  Each
# product computes in f32 and rounds to bf16, and the grouped path sums
# a token's 8 outputs in one product with the weights rounded to bf16
# (2**-9 of each), terms of mixed sign: so the difference scales with
# the token's row, and the tolerance is tensor_core_limit's (2**-7 of the
# row's largest |plain| + 2**-7 of |plain|).
EXPERT_CASES = {
    # A decode step of 32 lanes: 256 routed pairs.
    "decode-32": dict(tokens=32, valid=32),
    # A prefill dispatch of 2 live lanes at chunk 240 in a batch of 8
    # lanes: 1920 slots, 480 of them valid.
    "prefill-2x240": dict(tokens=1920, valid=480),
}


def _expert_bound(pairs, loads, d=2304, f=896) -> tuple:
    """Least time of the grouped products on an H100 in bf16: each loaded
    expert's three matrices read once, each product's input read and
    output written once, or their FLOPs at the peak."""
    nbytes = loads * 3 * d * f * 2 + pairs * 3 * (d + f) * 2
    flops = pairs * 3 * 2 * d * f
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[torch.bfloat16]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _expert_cases() -> dict:
    from ray_tpu_torch.models import mellum
    from ray_tpu_torch.ops import attention as A

    gen = torch.Generator(device="cuda").manual_seed(24)
    cfg = mellum.CONFIGS["mellum2-12b-a2.5b"]
    e, d, f, k = cfg.n_experts, cfg.d_model, cfg.d_expert, \
        cfg.experts_per_token

    def rand(*shape, std=0.02):
        return (torch.randn(*shape, generator=gen, device="cuda") * std).to(
            torch.bfloat16)

    p = {"router": rand(d, e), "w_gate": rand(e, d, f),
         "w_up": rand(e, d, f), "w_down": rand(e, f, d)}
    results = {}
    for name, spec in EXPERT_CASES.items():
        n = spec["tokens"]
        h = rand(n, d, std=1.0)
        valid = torch.arange(n, device="cuda") % (n // spec["valid"]) == 0
        probs = torch.softmax(h.float() @ p["router"].float(), dim=-1)
        weight, expert = probs.topk(k, dim=-1)
        weight = weight / weight.sum(-1, keepdim=True)
        expert = torch.where(valid[:, None], expert, e)
        got, per = mellum._grouped_experts(h, p, expert, weight, e)
        plain, per_plain = mellum._looped_experts(h, p, expert, weight, e)
        torch.cuda.synchronize()
        check(torch.equal(per, per_plain), f"experts {name}: counts differ")
        got, plain = got.to(torch.bfloat16).float(), \
            plain.to(torch.bfloat16).float()
        atol, rtol = A.TENSOR_CORE_TOLERANCE
        err = (got - plain).abs()
        check(bool(torch.isfinite(got).all()), f"experts {name}: not finite")
        share = _share(err, A.tensor_core_limit(plain, "O"))
        check(share <= 1.0, f"experts {name}: grouped products disagree "
              f"with the loop (max abs err {float(err.max())}, "
              f"{share} of tensor_core_limit)")
        check(not got[~valid].any(), f"experts {name}: a masked slot got "
              f"expert work")
        pairs, loads = int(per[:e].sum()), int((per[:e] > 0).sum())
        bound_ms, bound_by = _expert_bound(pairs, loads)
        results[name] = dict(
            max_abs_err=float(err.max()), atol=atol, rtol=rtol,
            limit_share=share,
            ms=_time_ms(lambda: mellum._grouped_experts(
                h, p, expert, weight, e)),
            ms_with_launch=_time_ms(lambda: mellum._grouped_experts(
                h, p, expert, weight, e), spin=False),
            plain_ms=_time_ms(lambda: mellum._looped_experts(
                h, p, expert, weight, e), reps=5),
            library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
            pairs=pairs, loads=loads)
    return results


def _mix_prompts(rng, n):
    """n prompt lengths of the serve-longprompt mix (benchmark/traffic):
    lognormal, median 1024, sigma 0.5, in [256, 1792]."""
    return [int(x) for x in rng.lognormal(math.log(1024), 0.5, n)
            .round().clip(256, 1792)]


PREFILL_CASES = {
    # The serve cell's prefill dispatch (cerebras-gpt-6.7b): one lane at
    # the full table, 8 lanes in their last chunk of a prompt from the
    # mix, 23 riders.
    "serve-6.7b": dict(kh=32, q_per_kv=1, d=128, bs=16, mb=128, t=32,
                       ctx=lambda rng: [2048] + _mix_prompts(rng, 8)
                       + [1] * 23, chunked=True),
    # llama-1b's prefill: 256 query rows a kv head (4 row blocks); the
    # last lane has no context and must come out as zeros.
    "llama-1b": dict(kh=4, q_per_kv=8, d=64, bs=16, mb=128, t=32,
                     ctx=lambda rng: _mix_prompts(rng, 8) + [1] * 23 + [0],
                     chunked=True),
    # A speculative verify step (1 + spec_k 4) over 31 decoding lanes.
    "verify-t5-llama-1b": dict(
        kh=4, q_per_kv=8, d=64, bs=16, mb=128, t=5,
        ctx=lambda rng: rng.integers(5, 2049, 31).tolist() + [0],
        chunked=False),
    # q_per_kv 4 at head dim 128 (llama3-8b's grouping): 128 rows.
    "gqa4-d128": dict(kh=8, q_per_kv=4, d=128, bs=16, mb=128, t=32,
                      ctx=lambda rng: _mix_prompts(rng, 8), chunked=True),
    # Head dim 256: key tiles of 32.
    "d256": dict(kh=2, q_per_kv=2, d=256, bs=32, mb=16, t=16,
                 ctx=lambda rng: rng.integers(1, 513, 4).tolist(),
                 chunked=True),
    # Mellum's window layers at its prefill chunk (240) and window (1024):
    # lanes in their last chunk of a prompt up to 4096, one lane inside
    # its first window, riders at ctx_len 1.
    "mellum-window": dict(kh=4, q_per_kv=8, d=128, bs=16, mb=256, t=240,
                          ctx=lambda rng: [4096, 700, 1300]
                          + _window_ctx(rng, 3) + [1, 1], chunked=True,
                          window=1024),
    # A window below the chunk, not a multiple of the split, at head dim
    # 64: the rows of one chunk read splits that start at different keys.
    "window-100-d64": dict(kh=2, q_per_kv=4, d=64, bs=16, mb=128, t=64,
                           ctx=lambda rng: rng.integers(1, 2049, 6).tolist(),
                           chunked=True, window=100),
}


def _prefill_case(rng, *, kh, q_per_kv, d, bs, mb, t, ctx, chunked,
                  window=None):
    """K5's operands: lanes at contexts `ctx(rng)`, each lane's queries at
    its last chunk of t (positions past ctx_len in an overhang, as the
    engine's last prefill chunk) or, not `chunked`, at its last t
    positions; bf16 values drawn from the seed."""
    ctx = torch.tensor(ctx(rng), dtype=torch.int64)
    b, h = len(ctx), kh * q_per_kv
    nb = b * mb + 8
    start = ((ctx - 1).clamp(min=0) // t * t if chunked
             else (ctx - t).clamp(min=0))
    pos = start[:, None] + torch.arange(t)[None]
    gen = torch.Generator().manual_seed(int(rng.integers(1 << 31)))
    tables = torch.randperm(nb, generator=gen)[:b * mb].view(b, mb)

    def rand(*shape):
        return torch.randn(*shape, generator=gen).to(torch.bfloat16).cuda()

    out = dict(q=rand(b, t, h, d), k_pool=rand(nb, bs, kh, d),
               v_pool=rand(nb, bs, kh, d),
               block_tables=tables.to(torch.int32).cuda(),
               ctx_lens=ctx.to(torch.int32).cuda(), q_positions=pos.cuda())
    if window is not None:
        out["window"] = window
    return out


def _prefill_limits(c):
    """[B, T]: query (b, t) sees keys [0, limit)."""
    width = c["block_tables"].shape[1] * c["k_pool"].shape[1]
    return torch.minimum(c["ctx_lens"].long().clamp(max=width)[:, None],
                         c["q_positions"] + 1).clamp(min=0)


def _prefill_firsts(c):
    """[B, T]: query (b, t) sees keys from this one on (0 without a
    window), at most its limit."""
    lim = _prefill_limits(c)
    if c.get("window") is None:
        return torch.zeros_like(lim)
    return torch.minimum((c["q_positions"] - c["window"] + 1).clamp(min=0),
                         lim)


def _prefill_bound(c) -> tuple:
    """Least time for K5's work on an H100: each lane's visible K/V rows
    (up to its last visible key) read once, q, the positions, ctx_lens
    and the table entries read, the output written once; or the QK and
    PV flops of every visible (query, key) pair at the bf16 peak.
    Returns (ms, "bytes"|"operations")."""
    q, k = c["q"], c["k_pool"]
    b, t, h, d = q.shape
    _, bs, kh, _ = k.shape
    lim, first = _prefill_limits(c), _prefill_firsts(c)
    span = (lim.amax(1) - first.amin(1)).clamp(min=0)
    sz = q.element_size()
    kv_bytes = int(span.sum()) * kh * d * 2 * sz
    small = int(((span + bs - 1) // bs).sum()) * 4 + b * 4 + b * t * 8
    nbytes = kv_bytes + 2 * q.numel() * sz + small
    flops = 4 * int((lim - first).sum()) * h * d
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[q.dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _prefill_sdpa_inputs(c):
    """q [B, H, T, D], the pre-gathered context and the visibility mask,
    for the library yardstick."""
    width = c["block_tables"].shape[1] * c["k_pool"].shape[1]
    pos = torch.arange(width, device=c["q"].device)[None, None]
    mask = ((pos < _prefill_limits(c)[..., None])
            & (pos >= _prefill_firsts(c)[..., None]))[:, None]
    return (c["q"].transpose(1, 2).contiguous(), _gathered(c, c["k_pool"]),
            _gathered(c, c["v_pool"]), mask)


def _prefill_kernel_cases(F, A) -> dict:
    """K5 against `paged_attention_reference` at PREFILL_CASES, within
    TOLERANCE for bf16 on every row that sees a key; the rows that see
    none must be zeros.  Timed as the decode cases are."""
    import numpy as np

    rng = np.random.default_rng(22)
    results = {}
    for name, spec in PREFILL_CASES.items():
        t_case = time.perf_counter()
        c = _prefill_case(rng, **spec)
        before = A.paged_prefill_attention.launches
        out = A.paged_prefill_attention(**c)
        check(A.paged_prefill_attention.launches == before + 1,
              f"{name}: the prefill kernel did not launch")
        plain = A.paged_attention_reference(**c)
        torch.cuda.synchronize()
        seen = _prefill_limits(c) > _prefill_firsts(c)          # [B, T]
        atol, rtol = TOLERANCE[torch.bfloat16]
        err = (out.float() - plain.float()).abs()[seen]
        check(bool(torch.isfinite(out.float()).all()),
              f"{name}: kernel output not finite")
        check(bool((err <= atol + rtol * plain.float().abs()[seen]).all()),
              f"{name}: kernel disagrees with its plain version "
              f"(max abs err {float(err.max())}, atol {atol}, rtol {rtol})")
        check(not out[~seen].any(), f"{name}: a row that sees no key is "
              f"not zeros")
        sdpa = _prefill_sdpa_inputs(c)
        bound_ms, bound_by = _prefill_bound(c)
        results[name] = dict(
            max_abs_err=float(err.max()), atol=atol, rtol=rtol,
            ms=_time_ms(lambda: A.paged_prefill_attention(**c)),
            ms_with_launch=_time_ms(lambda: A.paged_prefill_attention(**c),
                                    spin=False),
            plain_ms=_time_ms(lambda: A.paged_attention_reference(**c)),
            library_ms=_time_ms(lambda: F.scaled_dot_product_attention(
                sdpa[0], sdpa[1], sdpa[2], attn_mask=sdpa[3])),
            bound_ms=bound_ms, bound_by=bound_by,
            ctx_tokens=int((_prefill_limits(c).amax(1)
                            - _prefill_firsts(c).amin(1)).sum()),
            zero_rows=int((~seen).sum()) * spec["kh"] * spec["q_per_kv"],
            t=spec["t"], q_per_kv=spec["q_per_kv"], d=spec["d"],
            split_len=A.PREFILL_SPLIT_LEN,
            splits=A.prefill_splits(spec["mb"], spec["bs"],
                                    window=spec.get("window"),
                                    q_len=spec["t"]),
            window=spec.get("window"),
            case_s=time.perf_counter() - t_case)
        del sdpa, c
    return results


# ------------------------------------------------------------------ flash

# Flash kernels vs plain on the same inputs, as (atol, rtol).  f32: both
# sides compute in f32 and sum up to L * D products in another order.
# bf16 on the f32 kernels (D 256): both compute in f32 and round once, so
# they may differ by one bf16 ulp (2**-7 relative at most).  LSE and
# delta are f32 for either input type.  O (K1), dq (K2) and dk, dv (K3)
# from the tensor-core kernels are held to ops.attention.tensor_core_limit
# instead: there P and dS are rounded to bf16 before the products that
# take them.
FLASH_TOLERANCE = {torch.float32: (1e-4, 1e-4),
                   torch.bfloat16: (1e-3, 2 ** -7)}
FLASH_CASES = {
    "train-bf16": dict(b=24, lq=1024, lk=1024, h=12, d=64, causal=True,
                       dtype=torch.bfloat16),
    "train-f32": dict(b=24, lq=1024, lk=1024, h=12, d=64, causal=True,
                      dtype=torch.float32),
    # The llama-1b train step: 32 query heads over the repeated kv heads.
    "llama-1b-train-bf16": dict(b=4, lq=2048, lk=2048, h=32, d=64,
                                causal=True, dtype=torch.bfloat16),
    "d128-bf16": dict(b=4, lq=1024, lk=1024, h=8, d=128, causal=True,
                      dtype=torch.bfloat16),
    "d256-f32": dict(b=2, lq=512, lk=512, h=4, d=256, causal=True,
                     dtype=torch.float32),
    "d256-bf16": dict(b=2, lq=512, lk=512, h=4, d=256, causal=True,
                      dtype=torch.bfloat16),
    # Non-causal with q_len != kv_len, neither a multiple of a tile.
    "full-ragged-bf16": dict(b=4, lq=500, lk=1000, h=12, d=64, causal=False,
                             dtype=torch.bfloat16),
    # Causal at a length that is no multiple of the 64-row tile.
    "causal-ragged-f32": dict(b=3, lq=1000, lk=1000, h=12, d=64,
                              causal=True, dtype=torch.float32),
    # The draft path of spec_model_draft (gpt2-small bf16, one sequence
    # of at most 64 tokens): one causal tile that is only partly filled,
    # near its end and below one warp's 16 rows.
    "draft-62-bf16": dict(b=1, lq=62, lk=62, h=12, d=64, causal=True,
                          dtype=torch.bfloat16),
    "draft-12-bf16": dict(b=1, lq=12, lk=12, h=12, d=64, causal=True,
                          dtype=torch.bfloat16),
    # The pipeline phase's microbatch: gpt2-small, 4 x 1024.
    "pipeline-bf16": dict(b=4, lq=1024, lk=1024, h=12, d=64, causal=True,
                          dtype=torch.bfloat16),
    # One rank's shard in the mesh phases: gpt2-small's 8 x 1024 over
    # data x fsdp = 4 with 12 heads over tensor = 2; llama-1b's 4 x 2048
    # over data = 2 with 32 (repeated) heads over tensor = 2.
    "mesh-bf16": dict(b=2, lq=1024, lk=1024, h=6, d=64, causal=True,
                      dtype=torch.bfloat16),
    "mesh-llama-bf16": dict(b=2, lq=2048, lk=2048, h=16, d=64, causal=True,
                            dtype=torch.bfloat16),
    # A block of the ring in the seq phases (ops/ring_attention.py):
    # gpt2-small's 4 x 1024 over seq = 4, llama-1b's 4 x 2048 over seq =
    # 2 with 32 (repeated) heads over tensor = 2.  The rank's own block
    # is causal, the earlier ones full.  (train_mesh_moe's shard, 4 x
    # 1024 with 12 heads, is pipeline-bf16's.)
    "ring-bf16": dict(b=4, lq=256, lk=256, h=12, d=64, causal=True,
                      dtype=torch.bfloat16),
    "ring-full-bf16": dict(b=4, lq=256, lk=256, h=12, d=64, causal=False,
                           dtype=torch.bfloat16),
    "ring-llama-bf16": dict(b=4, lq=1024, lk=1024, h=16, d=64, causal=True,
                            dtype=torch.bfloat16),
    "ring-llama-full-bf16": dict(b=4, lq=1024, lk=1024, h=16, d=64,
                                 causal=False, dtype=torch.bfloat16),
    # One rank's rows at 7B under fsdp = 4 (32 heads of 128): a row of
    # 4096 (train_7b's 4 x 4096; llama2-7b and gpt 7b), and llama3-8b's
    # row of 8192, its 8 kv heads repeated to 32.
    "7b-bf16": dict(b=1, lq=4096, lk=4096, h=32, d=128, causal=True,
                    dtype=torch.bfloat16),
    "8b-bf16": dict(b=1, lq=8192, lk=8192, h=32, d=128, causal=True,
                    dtype=torch.bfloat16),
}
# Every length the draft forward can give K1 (window 64), checked at
# the draft path's shape beside the two timed cases above.
DRAFT_WINDOW = 64


def _flash_bounds(c) -> dict:
    """Least time of each kernel's work at case c on an H100, as
    (ms, "bytes"|"operations"): each operand it reads once, each output
    written once; 2 flops per multiply-add of its products (K1: S and
    PV; K2: S, dP and dQ; K3: S, dP, dV and dK) over the visible (q, k)
    pairs only, at the peak for the input type."""
    b, lq, lk, h, d = c["b"], c["lq"], c["lk"], c["h"], c["d"]
    sz = torch.empty((), dtype=c["dtype"]).element_size()
    pairs = b * h * (lq * (lq + 1) // 2 if c["causal"] else lq * lk)
    row_q, row_k, lens = b * lq * h * d * sz, b * lk * h * d * sz, b * h * lq * 4
    work = {  # name: (bytes, flops)
        "K1": (2 * row_q + 2 * row_k + lens, 4 * d * pairs),  # q,k,v -> o, lse
        "K2": (4 * row_q + 2 * row_k + 2 * lens, 6 * d * pairs),
        "K3": (2 * row_q + 4 * row_k + 2 * lens, 8 * d * pairs),
    }
    out = {}
    for name, (nbytes, flops) in work.items():
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = flops / PEAK_FLOPS[c["dtype"]]
        out[name] = (max(t_bytes, t_ops) * 1e3,
                     "bytes" if t_bytes >= t_ops else "operations")
    return out


def _flash_errors(name, dtype, pairs, tensor_cores) -> tuple:
    """Check each (what, kernel, plain) pair: O, dq, dk and dv from the
    tensor-core kernels against ops.attention.tensor_core_limit, anything
    else against FLASH_TOLERANCE for its dtype.  Returns the largest abs
    error and the largest share of its limit that an entry used."""
    from ray_tpu_torch.ops import attention as A

    worst, used = 0.0, 0.0
    for what, got, want in pairs:
        out_dtype = got.dtype
        got, want = got.float(), want.float()
        check(bool(torch.isfinite(got).all()), f"{name} {what}: not finite")
        err = (got - want).abs()
        if tensor_cores and what in ("O", "dq", "dk", "dv"):
            limit = A.tensor_core_limit(want, what)
            rule = "TENSOR_CORE_TOLERANCE (2**-7 of the row's max|plain| " \
                   "+ 2**-7 * |plain|, for dq + 2**-14 * max|plain|)"
        else:
            atol, rtol = FLASH_TOLERANCE[torch.float32 if out_dtype ==
                                         torch.float32 else dtype]
            limit = atol + rtol * want.abs()
            rule = f"{atol} + {rtol} * |plain|"
        share = _share(err, limit)
        check(share <= 1.0, f"{name} {what}: kernel disagrees with its plain "
                            f"version (max abs err {float(err.max())}, "
                            f"tolerance {rule})")
        worst, used = max(worst, float(err.max())), max(used, share)
    return worst, used


def _share(err, limit) -> float:
    """The largest err / limit over the entries (<= 1 passes)."""
    return float((err / limit.clamp_min(1e-30)).max())


def _planted_faults(q, k, v, do, lse, delta, po, pdq, pdk, pdv,
                    scale) -> dict:
    """The share of tensor_core_limit that three faults limited to late
    rows would use at the train shape, built from the plain outputs: K1
    skipping kv tile 0 for q tiles >= 8 (O rows 512+ lose those keys
    from both sums), K2 skipping the same tile (dq rows 512+ lose
    scale * sum_{j<64} dS_ij k_j), and K3 skipping q tile 15 for kv tiles
    8-14 (dk and dv rows 512-959 lose that tile's terms).  Each must
    exceed 1."""
    from ray_tpu_torch.ops.attention import tensor_core_limit

    f = lambda x: x.float()  # noqa: E731
    out = {}
    # K1: O_i = (O_i - sum_{j<64} p_ij v_j) / (1 - sum_{j<64} p_ij).
    qs = f(q[:, 512:])
    p = torch.exp(torch.einsum("bihd,bjhd->bhij", qs, f(k[:, :64])) * scale
                  - lse[:, :, 512:, None])
    part = torch.einsum("bhij,bjhd->bihd", p, f(v[:, :64]))
    kept = (1 - p.sum(-1)).transpose(1, 2)[..., None]
    o = f(po).clone()
    o[:, 512:] = (o[:, 512:] - part) / kept
    o = o.to(po.dtype).float()
    out["O"] = _share((o - f(po)).abs(), tensor_core_limit(po, "O"))
    # K2: dq_i -= scale * sum_{j<64} dS_ij k_j over q rows 512+.
    ds = p * (torch.einsum("bihd,bjhd->bhij", f(do[:, 512:]), f(v[:, :64]))
              - delta[:, :, 512:, None])
    dq = f(pdq).clone()
    dq[:, 512:] -= torch.einsum("bhij,bjhd->bihd", ds, f(k[:, :64])) * scale
    dq = dq.to(pdq.dtype).float()
    out["dq"] = _share((dq - f(pdq)).abs(), tensor_core_limit(pdq, "dq"))
    # K3: dv_j -= sum_i p_ij dO_i, dk_j -= scale * sum_i dS_ij q_i over
    # q rows 960-1023 and kv rows 512-959.
    qi, doi, kj, vj = f(q[:, 960:]), f(do[:, 960:]), f(k[:, 512:960]), \
        f(v[:, 512:960])
    p = torch.exp(torch.einsum("bihd,bjhd->bhij", qi, kj) * scale
                  - lse[:, :, 960:, None])
    ds = p * (torch.einsum("bihd,bjhd->bhij", doi, vj)
              - delta[:, :, 960:, None])
    for what, plain, drop in (
            ("dv", pdv, torch.einsum("bhij,bihd->bjhd", p, doi)),
            ("dk", pdk, torch.einsum("bhij,bihd->bjhd", ds, qi) * scale)):
        got = f(plain).clone()
        got[:, 512:960] -= drop
        got = got.to(plain.dtype).float()
        out[what] = _share((got - f(plain)).abs(), tensor_core_limit(plain, what))
    for what, share in out.items():
        check(share > 1.0, f"a planted late-row fault in {what} used only "
                           f"{share} of TENSOR_CORE_TOLERANCE")
    return out


def phase_flash(report: dict) -> None:
    import torch.nn.functional as F

    from ray_tpu_torch.ops import attention as A

    gen = torch.Generator().manual_seed(1)
    results = {}
    for name, c in FLASH_CASES.items():
        b, lq, lk, h, d, causal = (c[k] for k in
                                   ("b", "lq", "lk", "h", "d", "causal"))

        def rand(l):
            return torch.randn(b, l, h, d, generator=gen).to(
                c["dtype"]).cuda()

        q, k, v, do = rand(lq), rand(lk), rand(lk), rand(lq)
        scale = d ** -0.5
        o, lse = A.flash_forward(q, k, v, causal, scale)
        po, plse = A.flash_forward_plain(q, k, v, causal, scale)
        dq, delta = A.flash_dq(q, k, v, o, lse, do, causal, scale)
        pdq, pdelta = A.flash_dq_plain(q, k, v, o, lse, do, causal, scale)
        dk, dv = A.flash_dkv(q, k, v, do, lse, delta, causal, scale)
        pdk, pdv = A.flash_dkv_plain(q, k, v, do, lse, pdelta, causal, scale)
        torch.cuda.synchronize()
        design = A.flash_design(c["dtype"], d)
        tc = design.startswith("tensor cores")
        err = {
            "K1": _flash_errors(name, c["dtype"], [("O", o, po),
                                                   ("LSE", lse, plse)], tc),
            "K2": _flash_errors(name, c["dtype"], [("dq", dq, pdq),
                                                   ("delta", delta, pdelta)],
                                tc),
            "K3": _flash_errors(name, c["dtype"], [("dk", dk, pdk),
                                                   ("dv", dv, pdv)], tc),
        }
        if name == "train-bf16":
            faults = _planted_faults(q, k, v, do, plse, pdelta, po, pdq, pdk,
                                     pdv, scale)
        del po, plse, pdq, pdelta, pdk, pdv
        # The library yardstick: SDPA on [B, H, L, D] views (never called
        # by the port); its backward is K2 and K3 together.
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        dot = do.transpose(1, 2)

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt,
                                                  is_causal=causal)

        def sdpa_fwd_bwd():
            torch.autograd.grad(sdpa(), (qt, kt, vt), dot)

        lib_fwd = _time_ms(sdpa, reps=20)
        lib_bwd = _time_ms(sdpa_fwd_bwd, reps=20) - lib_fwd
        bounds = _flash_bounds(c)
        times = {
            "K1": (lambda: A.flash_forward(q, k, v, causal, scale),
                   lambda: A.flash_forward_plain(q, k, v, causal, scale),
                   lib_fwd),
            "K2": (lambda: A.flash_dq(q, k, v, o, lse, do, causal, scale),
                   lambda: A.flash_dq_plain(q, k, v, o, lse, do, causal,
                                            scale), lib_bwd),
            "K3": (lambda: A.flash_dkv(q, k, v, do, lse, delta, causal,
                                       scale),
                   lambda: A.flash_dkv_plain(q, k, v, do, lse, delta, causal,
                                             scale), lib_bwd),
        }
        results[name] = {
            kern: dict(max_abs_err=err[kern][0], tolerance_used=err[kern][1],
                       design=design,
                       ms=_time_ms(fn, reps=20),
                       plain_ms=_time_ms(plain, reps=5), library_ms=lib,
                       bound_ms=bounds[kern][0], bound_by=bounds[kern][1])
            for kern, (fn, plain, lib) in times.items()}
        del q, k, v, do, o, lse, dq, delta, dk, dv, qt, kt, vt, dot
        torch.cuda.empty_cache()
    sweep = _draft_lengths(gen)
    atol = {str(t).replace("torch.", ""): FLASH_TOLERANCE[t]
            for t in FLASH_TOLERANCE}
    emit("flash", tolerance_atol_rtol=atol,
         tensor_core_tolerance_of_rowmax_and_rel=A.TENSOR_CORE_TOLERANCE,
         planted_late_row_faults_tolerance_used=faults, cases=results,
         draft_lengths=sweep)
    train, llama_train = results["train-bf16"], results["llama-1b-train-bf16"]
    for kern, fn, line in (("K1", "flash_forward", 53),
                           ("K2", "flash_dq", 414), ("K3", "flash_dkv", 457)):
        report[fn] = dict(
            name=fn, route="cuda",
            source="ray_tpu_torch/ops/csrc/flash_attention.cu",
            replaces=f"ray_tpu/ops/attention.py:{line}", **train[kern],
            llama_1b=dict(llama_train[kern]),
            pipeline=dict(results["pipeline-bf16"][kern]),
            train_mesh=dict(results["mesh-bf16"][kern]),
            train_mesh_llama=dict(results["mesh-llama-bf16"][kern]),
            train_mesh_seq=dict(causal=results["ring-bf16"][kern],
                                full=results["ring-full-bf16"][kern]),
            train_mesh_seq_llama=dict(
                causal=results["ring-llama-bf16"][kern],
                full=results["ring-llama-full-bf16"][kern]),
            train_mesh_moe=dict(results["pipeline-bf16"][kern]),
            train_7b=dict(results["7b-bf16"][kern]),
            llama3_8b=dict(results["8b-bf16"][kern]))
        if kern != "K1":
            report[fn]["library_note"] = (
                "scaled_dot_product_attention backward: dq, dk and dv "
                "together (K2 + K3)")
    # spec_model_draft adds the draft path's launches beside these.
    report["flash_forward"]["spec_model_draft"] = dict(
        **{f"L{c['lq']}": results[n]["K1"]
           for n, c in FLASH_CASES.items() if n.startswith("draft-")},
        lengths_checked=sweep)


def _draft_lengths(gen) -> dict:
    """K1 against flash_forward_plain at the draft path's shape (B 1, 12
    heads of 64, causal, bf16) at every length 1..DRAFT_WINDOW: O to
    tensor_core_limit, LSE to FLASH_TOLERANCE."""
    from ray_tpu_torch.ops import attention as A

    tc = A.flash_design(torch.bfloat16, 64).startswith("tensor cores")
    check(tc, "bf16 at head dim 64 no longer runs K1 on the tensor cores")
    worst, used = 0.0, 0.0
    for n in range(1, DRAFT_WINDOW + 1):
        q, k, v = (torch.randn(1, n, 12, 64, generator=gen)
                   .to(torch.bfloat16).cuda() for _ in range(3))
        o, lse = A.flash_forward(q, k, v, True, 0.125)
        po, plse = A.flash_forward_plain(q, k, v, True, 0.125)
        err, share = _flash_errors(f"draft L {n}", torch.bfloat16,
                                   [("O", o, po), ("LSE", lse, plse)], tc)
        worst, used = max(worst, err), max(used, share)
    return dict(lengths=f"1-{DRAFT_WINDOW}", max_abs_err=worst,
                tolerance_used=used)


# ------------------------------------------------------------------ serve

def _serve_requests(vocab: int, rng_seed: int = 0):
    import numpy as np

    rng = np.random.default_rng(rng_seed)
    shared = rng.integers(0, vocab, 64).tolist()           # four blocks

    def req(prompt, i):
        kw = dict(max_new_tokens=int(rng.integers(32, 65)))
        if i % 2:
            kw.update(temperature=0.8, seed=1000 + i)
        if i % 7 == 3:
            kw.update(eos_id=int(rng.integers(0, vocab)))
        return prompt, kw

    first = [req(shared + rng.integers(0, vocab, 8).tolist(), 0)]
    first += [req(rng.integers(0, vocab, int(rng.integers(16, 161))).tolist(),
                  i) for i in range(1, 16)]
    second = [req(shared + rng.integers(0, vocab,
                                        int(rng.integers(1, 40))).tolist(), i)
              for i in range(16, 24)]
    return first, second


class _Consumer(threading.Thread):
    """Streams one handle: submit-to-first-token time and the tokens."""

    def __init__(self, handle, t_submit: float):
        super().__init__(daemon=True)
        self.handle, self.t_submit = handle, t_submit
        self.first = threading.Event()
        self.tokens: list = []
        self.ttft = None

    def run(self):
        for tok in self.handle:
            if self.ttft is None:
                self.ttft = time.perf_counter() - self.t_submit
                self.first.set()
            self.tokens.append(tok)
        self.first.set()


def _prefill_dispatches(before: dict, after: dict) -> int:
    """An engine's T > 1 dispatches between two stats(): prefill chunks
    and speculative verify steps, each one K5 launch a layer where the
    engine runs in bf16 at head dim 64, 128 or 256."""
    return sum(after[k] - before[k] for k in ("prefill_steps",
                                              "verify_steps"))


def _check_prefill_launches(label, launches, dispatches, n_layers) -> None:
    check(launches == dispatches * n_layers and launches > 0,
          f"{label}: K5 launched {launches} times for {dispatches} prefill "
          f"dispatches and verify steps x {n_layers} layers")


def _drain_counted(label, eng, reqs, n_layers) -> tuple:
    """`_drain` through a bf16 engine with K5's count set to 0 just
    before and read just after, and held to the engine's T > 1
    dispatches x n_layers.  Returns the handles and the launches."""
    from ray_tpu_torch.ops import attention as A

    before = eng.stats()
    A.paged_prefill_attention.launches = 0
    handles = _drain(eng, reqs)
    launches = A.paged_prefill_attention.launches
    _check_prefill_launches(label, launches,
                            _prefill_dispatches(before, eng.stats()),
                            n_layers)
    return handles, launches


def _serve(family: str, config_name: str, params=None, extra=(),
           **engine_kw) -> tuple:
    """Serve the 24 requests of `_serve_requests` (and `extra` ones in the
    first wave) through InferenceEngine(family, config_name, **engine_kw)
    at 32 lanes, block 16, with the decode and prefill kernels' counts
    set to 0 just before and read just after; check every stream and the
    counts: K4 once per layer per T=1 decode step, K5 once per layer per
    prefill dispatch and per speculative verify step (T > 1).  Returns
    the phase's metrics and each request's tokens (first wave, `extra`,
    second wave)."""
    from ray_tpu_torch.inference import InferenceEngine
    from ray_tpu_torch.ops import attention as A

    t0 = time.perf_counter()
    eng = InferenceEngine(family, config_name, params=params, device="cuda",
                          seed=1234, max_lanes=32, block_size=16,
                          **engine_kw)
    n_layers, vocab = eng.config.n_layers, eng.config.vocab_size
    try:
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        eng.generate(list(range(40)), max_new_tokens=4)         # warm-up
        torch.cuda.synchronize()
        before = eng.stats()
        first, second = _serve_requests(vocab)

        A.paged_decode_attention.launches = 0
        A.paged_prefill_attention.launches = 0
        t_start = time.perf_counter()

        def submit(batch):
            out = []
            for prompt, kw in batch:
                c = _Consumer(eng.submit(prompt, **kw), time.perf_counter())
                c.start()
                out.append((kw, c))
            return out

        streams = submit(first + list(extra))
        # Wave two shares wave one's first prompt's sealed prefix.
        check(streams[0][1].first.wait(timeout=300),
              "first request produced no token")
        streams += submit(second)
        for _, c in streams:
            c.join(timeout=600)
            check(not c.is_alive(), "a request did not finish")
        wall = time.perf_counter() - t_start
        launches = A.paged_decode_attention.launches
        prefill_launches = A.paged_prefill_attention.launches
        after = eng.stats()
    finally:
        eng.shutdown()

    def delta(key):
        return after[key] - before[key]

    decode_steps, decode_s = delta("decode_steps"), delta("decode_seconds")
    verify_steps, verify_s = delta("verify_steps"), delta("verify_seconds")
    hits = delta("prefix_hits")
    for kw, c in streams:
        reason = c.handle.finish_reason
        check(reason in ("length", "eos"), f"finish_reason {reason!r}")
        check(len(c.tokens) == kw["max_new_tokens"] or reason == "eos",
              "a request stopped short")
        check(all(0 <= t < vocab for t in c.tokens), "token out of range")
    check(launches == decode_steps * n_layers,
          f"decode kernel launched {launches} times for {decode_steps} "
          f"decode steps x {n_layers} layers")
    check(launches > 0, "the decode kernel never ran")
    prefill_steps = delta("prefill_steps")
    _check_prefill_launches(config_name, prefill_launches,
                            _prefill_dispatches(before, after), n_layers)
    check(hits >= 1, "no prefix-cache hit")
    generated = sum(len(c.tokens) for _, c in streams)
    ttfts = sorted(c.ttft for _, c in streams)
    decode_tokens = generated - len(streams)     # first tokens: prefill
    out = dict(
        config=config_name, requests=len(streams),
        generated_tokens=generated,
        wall_s=wall, engine_setup_s=setup_s,
        output_tokens_per_s=generated / wall,
        decode_tokens_per_s=decode_tokens / (decode_s + verify_s),
        decode_steps=decode_steps,
        decode_step_ms=decode_s / decode_steps * 1e3,
        prefill_steps=prefill_steps,
        prefill_step_ms=delta("prefill_seconds") / prefill_steps * 1e3,
        ttft_p50_ms=statistics.median(ttfts) * 1e3,
        ttft_max_ms=ttfts[-1] * 1e3,
        prefix_hits=hits,
        prefix_hit_tokens=(after["prefix_hit_tokens"]
                           - before["prefix_hit_tokens"]),
        finish_reasons={r: sum(c.handle.finish_reason == r
                               for _, c in streams)
                        for r in ("length", "eos")},
        decode_kernel_launches=launches,
        prefill_kernel_launches=prefill_launches)
    if engine_kw.get("spec_k"):
        out.update(verify_steps=verify_steps,
                   verify_step_ms=(verify_s / verify_steps * 1e3
                                   if verify_steps else None),
                   **{k: delta(k) for k in (
                       "spec_drafted_tokens", "spec_accepted_tokens",
                       "spec_emitted_tokens", "spec_steps")},
                   spec_accepted_per_step=after["spec_accepted_per_step"])
    return out, [c.tokens for _, c in streams]


def phase_serve(report: dict) -> None:
    out, _ = _serve("gpt", "gpt2-small")
    report["paged_decode_attention"]["launches"] = \
        out["decode_kernel_launches"]
    report["paged_prefill_attention"]["gpt2_small_launches"] = \
        out["prefill_kernel_launches"]
    emit("serve", **out)


# serve_llama's streams and latencies, which serve_disagg is held to.
SERVE_LLAMA: dict = {}


def phase_serve_llama(report: dict) -> None:
    """llama-1b at full width and depth; the 1.1B random weights are
    drawn on the card (a CPU draw costs seconds), and the engine is shut
    down and freed before training."""
    from ray_tpu_torch.models import llama

    t0 = time.perf_counter()
    params = _llama_1b_params()
    torch.cuda.synchronize()
    params_s = time.perf_counter() - t0
    out, SERVE_LLAMA["streams"] = _serve("llama", "llama-1b", params)
    del params
    SERVE_LLAMA.update({k: out[k] for k in (
        "ttft_p50_ms", "ttft_max_ms", "decode_tokens_per_s", "decode_step_ms",
        "prefill_step_ms")})
    report["paged_decode_attention"]["llama_1b"]["launches"] = \
        out["decode_kernel_launches"]
    report["paged_prefill_attention"]["llama_1b"]["launches"] = \
        out["prefill_kernel_launches"]
    emit("serve_llama", params_s=params_s,
         q_per_kv=llama.CONFIGS["llama-1b"].q_per_kv, **out)


# ----------------------------------------------------------------- parity

def _f32_exact() -> None:
    """Plain f32 products on the card (TF32 off), as on the CPU."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _greedy_parity(phase: str, family: str, config, params, label: str,
                   **engine_kw) -> None:
    """The same 4 greedy requests through the engine on the card and on
    the CPU, from the same weights, must give the same tokens."""
    from ray_tpu_torch.inference import InferenceEngine

    vocab = config.vocab_size
    prompts = [[(37 * i + 11 * j) % vocab for j in range(n)]
               for i, n in enumerate((5, 17, 33, 48))]
    outs = {}
    for device in ("cuda", "cpu"):
        eng = InferenceEngine(family, config, params=params, device=device,
                              max_lanes=4, block_size=16, max_seq_len=128,
                              auto_start=False, **engine_kw)
        handles = [eng.submit(p, max_new_tokens=16) for p in prompts]
        while eng.step():
            pass
        outs[device] = [h.tokens(timeout=60) for h in handles]
    same = outs["cuda"] == outs["cpu"]
    emit(phase, config=label, requests=len(prompts), new_tokens=16,
         tokens_equal=same,
         mismatched=[i for i, (a, b) in enumerate(zip(outs["cuda"],
                                                      outs["cpu"]))
                     if a != b])
    check(same, f"{label}: CUDA and CPU greedy tokens differ")


def phase_parity() -> None:
    from ray_tpu_torch.models import gpt

    _f32_exact()
    config = dataclasses.replace(gpt.CONFIGS["gpt2-small"],
                                 dtype=torch.float32)
    params = gpt.init_params(config, torch.Generator().manual_seed(7),
                             device="cpu")
    _greedy_parity("parity", "gpt", config, params, "gpt2-small float32")


# ------------------------------------------------------------------ train

TRAIN_WARMUP, TRAIN_STEPS = 2, 6
# The 8 losses of this run (2 warm-up + 6 timed steps, same seeds) as
# recorded in PERF.md when every flash product ran in f32 on the CUDA
# cores.  With P and dS rounded to bf16 on the tensor cores each must
# stay within LOSS_DRIFT of them.
F32_FLASH_LOSSES = (10.974, 10.857, 10.749, 10.684, 10.628, 10.557, 10.431,
                    10.359)
# llama-1b's 8 losses (train_llama: 4 x 2048, weights drawn on the card
# from seed 0, tokens from seed 1) as recorded on their first run.
LLAMA_1B_LOSSES = (10.888, 10.359, 10.130, 9.796, 9.691, 9.395, 9.594,
                   9.142)
LOSS_DRIFT = 0.02


def _train(model, config, batch: int, seq: int, key, after=None) -> dict:
    """TRAIN_WARMUP + TRAIN_STEPS AdamW(1e-4) steps of
    `model.make_train_step(config)` on one repeated batch of random
    tokens (seed 1), the flash kernels' counts set to 0 just before the
    timed steps and read just after.  `key` seeds the weights (a torch
    Generator draws them on its own device).  Checks the losses are
    finite and falling and that K1, K2 and K3 each ran once per layer
    per timed step.  `after(state, tokens)`, when given, runs once the
    counts are read and adds its dict to the result."""
    from ray_tpu_torch.models._functional import adamw
    from ray_tpu_torch.ops import attention as A

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    init_state, train_step = model.make_train_step(config, adamw(1e-4),
                                                   device="cuda")
    state = init_state(key)
    tokens = torch.randint(0, config.vocab_size, (batch, seq),
                           generator=torch.Generator().manual_seed(1)).cuda()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    losses = []
    for _ in range(TRAIN_WARMUP):
        state, metrics = train_step(state, {"tokens": tokens})
        losses.append(metrics["loss"])
    torch.cuda.synchronize()

    kernels = (A.flash_forward, A.flash_dq, A.flash_dkv)
    for fn in kernels:
        fn.launches = 0
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        state, metrics = train_step(state, {"tokens": tokens})
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in kernels}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    extra = after(state, tokens) if after is not None else {}
    del state

    losses = [float(x) for x in losses]
    check(all(math.isfinite(x) for x in losses), f"train loss {losses}")
    check(losses[-1] < losses[0], f"train loss did not fall: {losses}")
    want = TRAIN_STEPS * config.n_layers
    for name, n in launches.items():
        check(n == want, f"{name} launched {n} times for {TRAIN_STEPS} "
                         f"steps x {config.n_layers} layers")
    tokens_per_s = batch * seq * TRAIN_STEPS / dt
    n_params = model.num_params(config)
    return dict(batch=batch, seq=seq, params=n_params, setup_s=setup_s,
                warmup_steps=TRAIN_WARMUP, steps=TRAIN_STEPS,
                step_ms=dt / TRAIN_STEPS * 1e3, tokens_per_s=tokens_per_s,
                mfu=6 * n_params * tokens_per_s / PEAK_FLOPS[torch.bfloat16],
                peak_memory_gib=peak, losses=losses,
                kernel_launches=launches, **extra)


def _check_drift(label: str, losses, recorded) -> float:
    drift = max(abs(a - b) for a, b in zip(losses, recorded))
    check(drift <= LOSS_DRIFT, f"{label} losses {losses} drift {drift} from "
                               f"{recorded}")
    return drift


def phase_train(report: dict) -> None:
    from ray_tpu_torch.models import gpt

    out = _train(gpt, gpt.CONFIGS["gpt2-small"], 24, 1024, 0)
    drift = _check_drift("gpt2-small", out["losses"], F32_FLASH_LOSSES)
    for name, n in out["kernel_launches"].items():
        report[name]["launches"] = n
    emit("train", config="gpt2-small",
         gpt2_125m_train_tokens_per_sec_per_chip=out.pop("tokens_per_s"),
         f32_flash_losses=F32_FLASH_LOSSES, max_loss_diff=drift, **out)


def phase_train_llama(report: dict) -> None:
    """llama-1b at full width and depth, remat off as in the reference
    config; the weights are drawn on the card."""
    from ray_tpu_torch.models import llama

    out = _train(llama, llama.CONFIGS["llama-1b"], 4, 2048,
                 torch.Generator(device="cuda").manual_seed(0))
    drift = _check_drift("llama-1b", out["losses"], LLAMA_1B_LOSSES)
    for name, n in out["kernel_launches"].items():
        report[name]["llama_1b"]["launches"] = n
    emit("train_llama", config="llama-1b",
         llama_1b_train_tokens_per_sec_per_chip=out.pop("tokens_per_s"),
         recorded_losses=LLAMA_1B_LOSSES, max_loss_diff=drift, **out)


# Per leaf, max |g_cuda - g_cpu| / max |g_cpu|.  Both sides compute in
# f32 (TF32 off) and sum in other orders: cuBLAS and the flash kernels on
# the card, the CPU's BLAS and the plain versions on the host, over 256
# positions and a 50304-way softmax.  2e-4 leaves room for that, while a
# wrong mask, layout or missing term moves a gradient by O(1).
GRAD_TOLERANCE = 2e-4


def _train_parity(phase: str, model, config, params, tokens,
                  label: str) -> None:
    """One train step on the card and one on the CPU from the same
    weights and tokens: the losses within 1e-4 relative, every gradient
    within GRAD_TOLERANCE of its leaf's largest."""
    from ray_tpu_torch.models._functional import adamw

    out = {}
    for device in ("cuda", "cpu"):
        init_state, train_step = model.make_train_step(config, adamw(1e-4),
                                                       device=device)
        state, metrics = train_step(init_state(params=params),
                                    {"tokens": tokens})
        grads = model._map(state["params"], lambda t: t.grad.cpu())
        out[device] = (float(metrics["loss"]), grads)
        del state
    loss_rel = abs(out["cuda"][0] - out["cpu"][0]) / abs(out["cpu"][0])
    worst, worst_leaf = 0.0, None

    def compare(a, b, path):
        nonlocal worst, worst_leaf
        for key in b:
            if isinstance(b[key], dict):
                compare(a[key], b[key], f"{path}{key}/")
                continue
            rel = float((a[key] - b[key]).abs().max()
                        / b[key].abs().max().clamp_min(1e-30))
            if rel >= worst:
                worst, worst_leaf = rel, path + key

    compare(out["cuda"][1], out["cpu"][1], "")
    emit(phase, config=label, batch=list(tokens.shape),
         loss_cuda=out["cuda"][0], loss_cpu=out["cpu"][0],
         loss_rel_err=loss_rel, max_grad_rel_err=worst,
         worst_leaf=worst_leaf, grad_tolerance=GRAD_TOLERANCE)
    check(loss_rel <= 1e-4, f"{label}: train loss CUDA {out['cuda'][0]} vs "
                            f"CPU {out['cpu'][0]}")
    check(worst <= GRAD_TOLERANCE, f"{label}: gradient {worst_leaf}: CUDA "
                                   f"vs CPU relative error {worst}")


def phase_train_parity() -> None:
    from ray_tpu_torch.models import gpt

    _f32_exact()
    config = dataclasses.replace(gpt.CONFIGS["gpt2-small"], n_layers=2,
                                 dtype=torch.float32)
    params = gpt.init_params(config, torch.Generator().manual_seed(5),
                             device="cpu")
    tokens = torch.randint(0, config.vocab_size, (2, 256),
                           generator=torch.Generator().manual_seed(6))
    _train_parity("train_parity", gpt, config, params, tokens,
                  "gpt2-small widths, 2 layers, float32")


def phase_llama_parity() -> None:
    """llama-1b widths at 2 layers in f32: greedy tokens (K4 at q_per_kv
    8 in f32 on the card) and one train step (K1-K3 over the repeated kv
    heads); then llama-tiny's greedy tokens, whose head dim 16 takes the
    masked-dense decode route on the card as in the reference."""
    from ray_tpu_torch.models import llama

    _f32_exact()
    config = dataclasses.replace(llama.CONFIGS["llama-1b"], n_layers=2,
                                 dtype=torch.float32)
    params = llama.init_params(config, torch.Generator().manual_seed(7),
                               device="cpu")
    label = "llama-1b widths, 2 layers, float32"
    _greedy_parity("llama_parity", "llama", config, params, label)
    tokens = torch.randint(0, config.vocab_size, (2, 128),
                           generator=torch.Generator().manual_seed(6))
    _train_parity("llama_train_parity", llama, config, params, tokens, label)
    tiny = llama.CONFIGS["llama-tiny"]
    _greedy_parity("llama_tiny_parity", "llama", tiny,
                   llama.init_params(tiny, torch.Generator().manual_seed(8),
                                     device="cpu"),
                   "llama-tiny (head dim 16), float32")


# ------------------------------------------------------------ speculative

# Where a bf16 speculative stream first differs from the plain engine's,
# the plain path's logits there must be a near-tie: top-2 margin at most
# this share of the row's largest |logit|, the bf16 bound the CPU tests
# hold the port's cached logits to (test_torch_llama,
# test_torch_gpt_cached).  The verify step's attention (K5) and K4 (or
# K1, for a draft) round differently in bf16, so a near-tie may fall
# either way.
NEAR_TIE = 2e-2
# capture_logp in f32 against log_softmax of a plain forward over the
# same tokens: the same function of logits that agree to ~1e-6.
LOGP_F32_TOLERANCE = 1e-4
SPEC_K = 4


def _llama_1b_params(seed: int = 1234) -> dict:
    """llama-1b's 1.1B random fp32 weights, drawn on the card."""
    from ray_tpu_torch.models import llama

    return llama.init_params(llama.CONFIGS["llama-1b"],
                             torch.Generator(device="cuda").manual_seed(seed),
                             device="cuda")


def _tree_leaves(tree: dict) -> list:
    """The leaves of a nested dict of arrays."""
    return [leaf for v in tree.values()
            for leaf in (_tree_leaves(v) if isinstance(v, dict) else [v])]


def _oracle(continuations: dict):
    """A DraftProposer that drafts, for a context starting with one of
    the prompts in `continuations`, the tokens that a plain run produced
    after it (full k + 1 bursts while the streams agree); nothing for any
    other context."""
    from ray_tpu_torch.inference import DraftProposer

    class Oracle(DraftProposer):
        def propose(self, context, k):
            for prompt, cont in continuations.items():
                if tuple(context[:len(prompt)]) == prompt:
                    pos = len(context) - len(prompt)
                    return list(cont[pos:pos + k])
            return []

    return Oracle()


def _drain(eng, reqs) -> list:
    """Submit (prompt, kwargs) requests to an engine built with
    auto_start=False, step it to idle; returns the handles."""
    handles = [eng.submit(p, **kw) for p, kw in reqs]
    while eng.step():
        pass
    for h in handles:
        check(h.finish_reason in ("length", "eos"),
              f"finish_reason {h.finish_reason!r}")
    return handles


def _plain_attention(q, k, v, *, causal=True, scale=None):
    """flash_attention's signature over K1's plain version."""
    from ray_tpu_torch.ops import attention as A

    scale = scale if scale is not None else q.shape[-1] ** -0.5
    return A.flash_forward_plain(q, k, v, causal, scale)[0]


def _logits(model, config, wparams, tokens) -> torch.Tensor:
    """f32 logits [L, V] of a plain forward over one sequence, its
    attention through flash_forward_plain: the reference that near-ties
    and captured log-probs are held to must not run K1, the kernel that
    the draft path checks."""
    from ray_tpu_torch.models import _functional
    from ray_tpu_torch.ops import attention as A

    # The families attend through the plan (`OneDevice.attend`).
    x = torch.tensor([list(tokens)], dtype=torch.int64, device="cuda")
    launches, kernel = A.flash_forward.launches, _functional.flash_attention
    _functional.flash_attention = _plain_attention
    try:
        with torch.no_grad():
            out = model.forward(wparams, x, config)
    finally:
        _functional.flash_attention = kernel
    check(A.flash_forward.launches == launches,
          "the reference forward launched K1")
    return (out[0] if isinstance(out, tuple) else out)[0].float()


def _near_tie(label, model, config, wparams, prompt, want, got,
              temperature: float = 0.0, seed=None) -> dict:
    """Where `got` first differs from the plain stream `want`, the plain
    path's logits there (a plain forward over the prompt and the common
    prefix) must have a top-2 margin <= NEAR_TIE * max|logit|.  For a
    sampled stream (`temperature` > 0) the margin is that of the scores
    the draw took the argmax of, logits / temperature + the request's
    Gumbel noise at that position, against NEAR_TIE * max|logit| /
    temperature: a logit moved by eps moves its score by eps /
    temperature."""
    from ray_tpu_torch.inference import sampling

    n = next((i for i, (a, b) in enumerate(zip(want, got)) if a != b), None)
    if n is None:
        check(len(want) == len(got), f"{label}: streams of other lengths")
        return dict(diverged_at=None)
    row = _logits(model, config, wparams, list(prompt) + want[:n])[-1]
    limit = NEAR_TIE * float(row.abs().max())
    if temperature > 0:
        key = sampling.fold_in(
            sampling.key(torch.tensor(seed, device=row.device)),
            torch.tensor(n, device=row.device))
        row = row / temperature + sampling.gumbel(key, row.shape[-1])
        limit /= temperature
    top2 = row.topk(2).values
    margin = float(top2[0] - top2[1])
    check(margin <= limit, f"{label}: streams differ at token {n}, where the "
                           f"plain logits' top-2 margin {margin} exceeds "
                           f"{NEAR_TIE} x max|logit| = {limit}")
    return dict(diverged_at=n, top2_margin=margin, limit=limit)


def phase_serve_spec(report: dict) -> None:
    """llama-1b at full width and depth with spec_k=4 and the n-gram
    proposer: serve's 24 requests plus 8 greedy ones whose prompts repeat
    a 16-token pattern four times.  K4 must have run 22 times per T=1
    decode step, K5 22 times per prefill dispatch and per verify step
    (T > 1)."""
    import numpy as np

    from ray_tpu_torch.models import llama

    t0 = time.perf_counter()
    params = _llama_1b_params()
    torch.cuda.synchronize()
    params_s = time.perf_counter() - t0
    rng = np.random.default_rng(3)
    vocab = llama.CONFIGS["llama-1b"].vocab_size
    extra = [(rng.integers(0, vocab, 16).tolist() * 4,
              dict(max_new_tokens=48)) for _ in range(8)]
    out, _ = _serve("llama", "llama-1b", params, extra=extra, spec_k=SPEC_K,
                    draft_proposer="ngram")
    del params
    check(out["spec_drafted_tokens"] > 0, "the n-gram proposer never drafted")
    check(out["spec_steps"] > 0, "no verify step ran")
    report["paged_decode_attention"]["llama_1b"]["serve_spec"] = dict(
        launches=out["decode_kernel_launches"])
    report["paged_prefill_attention"]["verify_t5"]["serve_spec"] = dict(
        launches=out["prefill_kernel_launches"])
    emit("serve_spec", params_s=params_s, spec_k=SPEC_K, **out)


def phase_spec_parity() -> None:
    """gpt2-small in f32: the same greedy and seeded requests through the
    plain engine and the spec engine on the card and the spec engine on
    the CPU, token for token.  llama-1b in bf16: one greedy request
    through the plain engine, then through a spec engine whose oracle
    drafts that output (full k + 1 bursts); where the streams first
    differ, a near-tie (NEAR_TIE)."""
    from ray_tpu_torch.inference import InferenceEngine
    from ray_tpu_torch.models import gpt, llama

    _f32_exact()
    config = dataclasses.replace(gpt.CONFIGS["gpt2-small"],
                                 dtype=torch.float32)
    params = gpt.init_params(config, torch.Generator().manual_seed(7),
                             device="cpu")
    vocab = config.vocab_size
    reqs = []
    for i in range(4):
        kw = dict(max_new_tokens=24)
        if i % 2:
            kw.update(temperature=0.8, seed=500 + i)
        reqs.append(([(37 * i + 11 * j) % vocab for j in range(8)] * 3, kw))
    outs, stats = {}, {}
    for label, device, spec_k in (("plain_cuda", "cuda", 0),
                                  ("spec_cuda", "cuda", SPEC_K),
                                  ("spec_cpu", "cpu", SPEC_K)):
        eng = InferenceEngine("gpt", config, params=params, device=device,
                              max_lanes=4, block_size=16, max_seq_len=128,
                              auto_start=False, spec_k=spec_k)
        outs[label] = [h.tokens(timeout=60) for h in _drain(eng, reqs)]
        stats[label] = eng.stats()
    same = outs["plain_cuda"] == outs["spec_cuda"] == outs["spec_cpu"]
    st = stats["spec_cuda"]
    emit("spec_parity", config="gpt2-small float32", requests=len(reqs),
         tokens_equal=same, verify_steps=st["verify_steps"],
         spec_drafted_tokens=st["spec_drafted_tokens"],
         spec_accepted_tokens=st["spec_accepted_tokens"],
         spec_accepted_per_step=st["spec_accepted_per_step"])
    check(same, "gpt2-small f32: plain (CUDA), spec (CUDA) and spec (CPU) "
                "tokens differ")
    check(st["verify_steps"] > 0 and st["spec_drafted_tokens"] > 0,
          "gpt2-small f32: no verify step ran")

    lconfig = llama.CONFIGS["llama-1b"]
    lparams = _llama_1b_params()
    prompt = tuple((101 * j + 7) % lconfig.vocab_size for j in range(24))
    kw = dict(max_new_tokens=48)
    runs, launches = {}, {}
    for label, spec_kw in (("plain", {}), ("spec", None)):
        if spec_kw is None:
            spec_kw = dict(spec_k=SPEC_K,
                           draft_proposer=_oracle({prompt: runs["plain"]}))
        eng = InferenceEngine("llama", lconfig, params=lparams,
                              device="cuda", max_lanes=4, block_size=16,
                              max_seq_len=256, auto_start=False, **spec_kw)
        (h,), launches[label] = _drain_counted(
            f"spec_parity llama-1b {label}", eng, [(list(prompt), kw)],
            lconfig.n_layers)
        runs[label] = h.tokens(timeout=60)
        stats[label] = eng.stats()
        del eng
    wparams = llama.working_params(lparams, lconfig, "cuda")
    del lparams
    tie = _near_tie("llama-1b bf16 spec", llama, lconfig, wparams, prompt,
                    runs["plain"], runs["spec"])
    st = stats["spec"]
    emit("spec_parity_llama", config="llama-1b bf16", new_tokens=48,
         verify_steps=st["verify_steps"],
         spec_accepted_per_step=st["spec_accepted_per_step"],
         prefill_kernel_launches=launches, near_tie_share=NEAR_TIE, **tie)
    check(st["verify_steps"] > 0, "llama-1b: no verify step ran")
    del wparams
    torch.cuda.empty_cache()


def phase_spec_model_draft(report: dict) -> None:
    """gpt2-small in bf16 drafting for itself: ModelDraftProposer on the
    target's own weights (window 64, spec_k 3) over 4 greedy lanes whose
    whole context fits the window.  Every draft forward runs K1 12 times
    (this is K1 on the serving path); acceptance must be >= 0.9; the
    output must equal the plain engine's but at near-ties."""
    import numpy as np

    from ray_tpu_torch.inference import InferenceEngine, ModelDraftProposer
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.ops import attention as A

    class TimedDraft(ModelDraftProposer):
        """Counts proposes, their seconds, and draft forwards: one per
        token asked for."""
        calls, forwards, seconds = 0, 0, 0.0

        def propose(self, context, k):
            t0 = time.perf_counter()
            out = super().propose(context, k)
            self.calls += 1
            self.forwards += k
            self.seconds += time.perf_counter() - t0
            return out

    config = gpt.CONFIGS["gpt2-small"]
    params = gpt.init_params(config,
                             torch.Generator(device="cuda").manual_seed(4321),
                             device="cuda")
    rng = np.random.default_rng(11)
    reqs = [(rng.integers(0, config.vocab_size, 12).tolist(),
             dict(max_new_tokens=48)) for _ in range(4)]
    kw = dict(device="cuda", max_lanes=4, block_size=16, max_seq_len=128,
              auto_start=False)
    handles, plain_launches = _drain_counted(
        "spec_model_draft plain", InferenceEngine("gpt", config,
                                                   params=params, **kw),
        reqs, config.n_layers)
    plain = [h.tokens(timeout=60) for h in handles]
    draft = TimedDraft("gpt", config, params=params, window=64,
                       device="cuda")
    eng = InferenceEngine("gpt", config, params=params, spec_k=3,
                          draft_proposer=draft, **kw)
    torch.cuda.synchronize()
    before = eng.stats()
    A.flash_forward.launches = 0
    A.paged_prefill_attention.launches = 0
    draft.forwards = 0
    t0 = time.perf_counter()
    handles = _drain(eng, reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = A.flash_forward.launches
    prefill_launches = A.paged_prefill_attention.launches
    st = eng.stats()
    _check_prefill_launches("spec_model_draft", prefill_launches,
                            _prefill_dispatches(before, st),
                            config.n_layers)
    got = [h.tokens(timeout=60) for h in handles]
    check(launches > 0, "K1 never ran on the draft path")
    check(launches == draft.forwards * config.n_layers,
          f"K1 launched {launches} times for {draft.forwards} draft "
          f"forwards x {config.n_layers} layers")
    acceptance = st["spec_accepted_tokens"] / max(st["spec_drafted_tokens"], 1)
    check(acceptance >= 0.9, f"self-draft acceptance {acceptance} < 0.9")
    ties = [_near_tie(f"gpt2-small self-draft request {i}", gpt, config,
                      draft.params, prompt, want, out)
            for i, ((prompt, _), want, out) in enumerate(zip(reqs, plain,
                                                             got))]
    report["flash_forward"]["spec_model_draft"]["launches"] = launches
    emit("spec_model_draft", config="gpt2-small bf16", window=64, spec_k=3,
         requests=len(reqs), wall_s=wall,
         generated_tokens=sum(len(t) for t in got),
         draft_forwards=draft.forwards, proposes=draft.calls,
         propose_ms=draft.seconds / draft.calls * 1e3,
         forwards_per_propose=draft.forwards / draft.calls,
         flash_forward_launches=launches,
         prefill_kernel_launches=dict(plain=plain_launches,
                                      spec=prefill_launches),
         spec_drafted_tokens=st["spec_drafted_tokens"],
         spec_accepted_tokens=st["spec_accepted_tokens"],
         acceptance=acceptance,
         spec_accepted_per_step=st["spec_accepted_per_step"],
         verify_steps=st["verify_steps"],
         verify_step_ms=st["verify_seconds"] / max(st["verify_steps"], 1)
         * 1e3,
         diverged=[t["diverged_at"] for t in ties])
    del eng, draft, params
    torch.cuda.empty_cache()


def _streams(handles) -> list:
    """(tokens, captured log-probs) of each finished handle."""
    return [(h.tokens(timeout=60), h.logps) for h in handles]


def _check_logps(label, model, config, wparams, reqs, streams,
                 bound) -> dict:
    """Each captured log-prob against log_softmax of a plain forward over
    the request's prompt and tokens, at the request's temperature:
    |err| <= bound(logit rows, temp).  Returns the largest error and the
    largest share of the bound used."""
    worst, used, n = 0.0, 0.0, 0
    for (prompt, kw), (toks, lps) in zip(reqs, streams):
        check(len(lps) == len(toks), f"{label}: {len(lps)} log-probs for "
                                     f"{len(toks)} tokens")
        rows = _logits(model, config, wparams,
                       list(prompt) + toks)[len(prompt) - 1:-1]
        temp = kw.get("temperature", 0.0)
        z = rows / temp if temp > 0 else rows
        want = torch.log_softmax(z, -1)[torch.arange(len(toks)),
                                        torch.tensor(toks)]
        err = (torch.tensor(lps, device="cuda") - want).abs()
        limit = bound(rows, temp)
        share = float((err / limit).max())
        check(share <= 1.0, f"{label}: captured log-prob off by "
                            f"{float(err.max())} (bound share {share})")
        worst, used, n = max(worst, float(err.max())), max(used, share), \
            n + len(toks)
    return dict(log_probs=n, max_abs_err=worst, bound_share_used=used)


def phase_logp() -> None:
    """capture_logp=True with greedy, seeded and verify steps: gpt2-small
    in f32 (n-gram drafts), within LOGP_F32_TOLERANCE; llama-1b in bf16
    (plain steps, then verify steps drafted by an oracle), within
    2 * NEAR_TIE * max|logit| / temp: if every logit of a row moves by at
    most eps, a log-softmax entry moves by at most 2 * eps, divided by
    the temperature where the row is."""
    from ray_tpu_torch.inference import InferenceEngine
    from ray_tpu_torch.models import gpt, llama

    _f32_exact()
    config = dataclasses.replace(gpt.CONFIGS["gpt2-small"],
                                 dtype=torch.float32)
    params = gpt.init_params(config, torch.Generator().manual_seed(7),
                             device="cpu")
    vocab = config.vocab_size
    reqs = [([(53 * i + 5 * j) % vocab for j in range(8)] * 3,
             dict(max_new_tokens=24, **(dict(temperature=0.8, seed=90 + i)
                                        if i % 2 else {})))
            for i in range(4)]
    eng = InferenceEngine("gpt", config, params=params, device="cuda",
                          max_lanes=4, block_size=16, max_seq_len=128,
                          auto_start=False, spec_k=SPEC_K, capture_logp=True)
    streams = _streams(_drain(eng, reqs))
    st = eng.stats()
    del eng
    check(st["verify_steps"] > 0 and st["decode_steps"] > 0,
          f"gpt2-small f32: verify {st['verify_steps']}, plain "
          f"{st['decode_steps']} steps")
    f32 = _check_logps("gpt2-small f32", gpt, config,
                       gpt.working_params(params, config, "cuda"), reqs,
                       streams, lambda rows, temp: LOGP_F32_TOLERANCE)
    emit("logp", config="gpt2-small float32", tolerance=LOGP_F32_TOLERANCE,
         verify_steps=st["verify_steps"], decode_steps=st["decode_steps"],
         **f32)

    lconfig = llama.CONFIGS["llama-1b"]
    lparams = _llama_1b_params()
    greedy = tuple((211 * j + 3) % lconfig.vocab_size for j in range(20))
    reqs = [(list(greedy), dict(max_new_tokens=32)),
            ([(13 * j + 9) % lconfig.vocab_size for j in range(20)],
             dict(max_new_tokens=32, temperature=0.8, seed=7))]
    kw = dict(device="cuda", max_lanes=4, block_size=16, max_seq_len=256,
              auto_start=False, capture_logp=True)

    def bf16_bound(rows, temp):
        return (2 * NEAR_TIE * rows.abs().amax(-1)
                / (temp if temp > 0 else 1.0))

    wparams = llama.working_params(lparams, lconfig, "cuda")
    out = {}
    launches = {}
    eng = InferenceEngine("llama", lconfig, params=lparams, **kw)
    handles, launches["plain"] = _drain_counted("logp llama-1b plain", eng,
                                                reqs, lconfig.n_layers)
    plain = _streams(handles)
    del eng
    out["plain"] = _check_logps("llama-1b bf16 plain", llama, lconfig,
                                wparams, reqs, plain, bf16_bound)
    eng = InferenceEngine("llama", lconfig, params=lparams, spec_k=SPEC_K,
                          draft_proposer=_oracle({greedy: plain[0][0]}), **kw)
    handles, launches["spec"] = _drain_counted("logp llama-1b spec", eng,
                                               reqs, lconfig.n_layers)
    spec = _streams(handles)
    st = eng.stats()
    del eng
    check(st["verify_steps"] > 0, "llama-1b: no verify step ran")
    out["spec"] = _check_logps("llama-1b bf16 spec", llama, lconfig,
                               wparams, reqs, spec, bf16_bound)
    del lparams, wparams
    torch.cuda.empty_cache()
    emit("logp_llama", config="llama-1b bf16",
         bound="2 * 2e-2 * max|logit| / temp",
         verify_steps=st["verify_steps"], prefill_kernel_launches=launches,
         **out)


# --------------------------------------------------------- disaggregation

# The K/V of one llama-1b block in bf16: 22 layers x 16 positions x 4 kv
# heads x 64 dims x 2 bytes, for K and for V.
LLAMA_1B_BLOCK_BYTES = 22 * 16 * 4 * 64 * 2 * 2


def _span_timer():
    """An Observer that keeps the milliseconds of each span by (thread,
    plane/kind): a request's export and import run in its own client
    thread.  Every other hook records nothing."""
    from ray_tpu_torch.util.observe import Observer

    class SpanTimer(Observer):
        def __init__(self):
            self.ms: dict = {}

        def begin(self, plane, kind, **fields):
            return (threading.get_ident(), f"{plane}/{kind}",
                    time.perf_counter())

        def end(self, token, **fields):
            if token is not None:
                self.ms[token[:2]] = (time.perf_counter() - token[2]) * 1e3

    return SpanTimer()


class _DisaggClient(threading.Thread):
    """One request through the disaggregated path, as DisaggLLMHandle
    drives it: the prefill hop returns a frame, then the decode hop
    streams tokens from it.  Keeps the frame, the tokens, the prefill
    hop's seconds, TTFT from the prefill call and from the decode call,
    and any error."""

    def __init__(self, prefill, decode, prompt, kw):
        super().__init__(daemon=True)
        self.prefill, self.decode, self.prompt, self.kw = (prefill, decode,
                                                           prompt, kw)
        self.first = threading.Event()
        self.frame, self.tokens, self.error = None, [], None
        self.ttft = self.ttft_decode = self.prefill_hop = None

    def run(self):
        try:
            t0 = time.perf_counter()
            self.frame = self.prefill.prefill(self.prompt,
                                              seed=self.kw.get("seed"))
            t1 = time.perf_counter()
            self.prefill_hop = t1 - t0
            for tok in self.decode.generate(self.prompt,
                                            kv_handoff=self.frame, **self.kw):
                if self.ttft is None:
                    now = time.perf_counter()
                    self.ttft, self.ttft_decode = now - t0, now - t1
                    self.first.set()
                self.tokens.append(tok)
        except Exception as exc:     # re-raised by the phase's check
            self.error = exc
        finally:
            self.first.set()


def _chain_keys(chain) -> list:
    """The content-addressed chain keys of a frame's token blocks."""
    keys, parent = [], 0
    for blk in chain:
        keys.append((parent, tuple(int(t) for t in blk)))
        parent = hash(keys[-1])
    return keys


def _ms_stats(values) -> dict:
    return dict(p50=statistics.median(values), max=max(values))


def phase_serve_disagg(report: dict) -> None:
    """llama-1b, bf16, full width, one card: a PrefillLLMDeployment and a
    DecodeLLMDeployment on one set of weights, 32 lanes, block 16,
    serving serve's 24 requests from concurrent client threads (prefill
    hop, frame, decode hop).  Every frame is v2 bf16 and decodes; the
    decode side imports each distinct chain link once and hits >= 16
    tokens per imported block; K4 ran 22 times per decode step of the
    decode engine and never for the prefill engine; K5 22 times per
    prefill dispatch of either engine (both run in this process, so one
    count holds their sum); each stream equals serve_llama's for the
    request or parts from it at a near-tie."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops import attention as A
    from ray_tpu_torch.serve import (DecodeLLMDeployment, KVBlockCodec,
                                     PrefillLLMDeployment)

    config = llama.CONFIGS["llama-1b"]
    params = _llama_1b_params()
    kw = dict(max_lanes=32, block_size=16, seed=1234)
    timers = {"prefill": _span_timer(), "decode": _span_timer()}
    prefill = PrefillLLMDeployment("llama", "llama-1b", params,
                                   observer=timers["prefill"], **kw)
    decode = DecodeLLMDeployment("llama", "llama-1b", params,
                                 observer=timers["decode"], **kw)
    replicas = {"prefill": prefill, "decode": decode}
    try:
        warm = list(range(40))
        decode(warm, 4, kv_handoff=prefill.prefill(warm))        # warm-up
        torch.cuda.synchronize()
        before = {r: d.stats() for r, d in replicas.items()}
        first, second = _serve_requests(config.vocab_size)

        A.paged_decode_attention.launches = 0
        A.paged_prefill_attention.launches = 0
        t_start = time.perf_counter()
        clients = [_DisaggClient(prefill, decode, p, k) for p, k in first]
        for c in clients:
            c.start()
        # Wave two shares wave one's first prompt's prefix.
        check(clients[0].first.wait(timeout=300),
              "first request produced no token")
        wave2 = [_DisaggClient(prefill, decode, p, k) for p, k in second]
        for c in wave2:
            c.start()
        clients += wave2
        for c in clients:
            c.join(timeout=600)
            check(not c.is_alive(), "a request did not finish")
            check(c.error is None, f"a request failed: {c.error!r}")
        wall = time.perf_counter() - t_start
        launches = A.paged_decode_attention.launches
        prefill_launches = A.paged_prefill_attention.launches
        after = {r: d.stats() for r, d in replicas.items()}
        dispatches = {r: _prefill_dispatches(before[r], after[r])
                      for r in replicas}

        def delta(role, key):
            return after[role][key] - before[role][key]

        reqs = first + second
        for (prompt, k), c in zip(reqs, clients):
            check(len(c.tokens) == k["max_new_tokens"]
                  or c.tokens[-1] == k.get("eos_id"),
                  "a request stopped short")
        # The frames: v2 bf16, decoded, timed through the codec.
        links, blocks, frame_bytes, enc_ms, dec_ms = set(), 0, 0, [], []
        handoff = []            # (export + encode, decode + import) ms
        for c in clients:
            if c.frame is None:
                continue        # prompt shorter than one full block + 1
            t0 = time.perf_counter()
            payload = KVBlockCodec.try_decode(c.frame)
            t1 = time.perf_counter()
            check(payload is not None and payload["v"] == 2
                  and payload["dtype"] == "bfloat16",
                  "a frame is not a v2 bf16 frame")
            KVBlockCodec.encode(payload)
            t2 = time.perf_counter()
            n = len(payload["chain"])
            check(payload["k"].nbytes + payload["v_pool"].nbytes
                  == n * LLAMA_1B_BLOCK_BYTES, "frame K/V bytes per block")
            links.update(_chain_keys(payload["chain"]))
            blocks += n
            frame_bytes += len(c.frame)
            export = timers["prefill"].ms[(c.ident, "kv/export")]
            imp = timers["decode"].ms[(c.ident, "kv/import")]
            handoff.append((export + (t2 - t1) * 1e3,
                            (t1 - t0) * 1e3 + imp))
        imported = delta("decode", "imported_blocks")
        hit_tokens = delta("decode", "prefix_hit_tokens")
        decode_steps = delta("decode", "decode_steps")
        check(imported == len(links),
              f"decode side imported {imported} blocks for {len(links)} "
              f"distinct chain links shipped")
        check(hit_tokens >= 16 * imported,
              f"prefix_hit_tokens {hit_tokens} < 16 x {imported}")
        check(delta("prefill", "decode_steps") == 0
              and delta("prefill", "verify_steps") == 0,
              "the prefill replica ran a decode step")
        check(launches == decode_steps * config.n_layers,
              f"K4 launched {launches} times for {decode_steps} decode "
              f"steps x {config.n_layers} layers")
        check(launches > 0, "K4 never ran on the decode side")
        _check_prefill_launches("serve_disagg", prefill_launches,
                                sum(dispatches.values()), config.n_layers)
        check(dispatches["prefill"] > 0, "the prefill replica never "
                                         "dispatched a prefill chunk")
        # Each stream against serve_llama's stream of the same request.
        wparams = decode._engine._work_params
        ties = [_near_tie(f"serve_disagg request {i}", llama, config,
                          wparams, prompt, want, c.tokens,
                          k.get("temperature", 0.0), k.get("seed"))
                for i, ((prompt, k), want, c) in enumerate(
                    zip(reqs, SERVE_LLAMA["streams"], clients))]
    finally:
        for d in replicas.values():
            d._engine.shutdown()
    del prefill, decode, replicas, params, wparams
    torch.cuda.empty_cache()
    report["paged_decode_attention"]["llama_1b"]["serve_disagg"] = dict(
        launches=launches)
    report["paged_prefill_attention"]["llama_1b"]["serve_disagg"] = dict(
        launches=prefill_launches, dispatches=dispatches)
    generated = sum(len(c.tokens) for c in clients)
    ttfts = sorted(c.ttft for c in clients)
    ttfts_decode = sorted(c.ttft_decode for c in clients)
    emit("serve_disagg", config="llama-1b", requests=len(clients),
         generated_tokens=generated, wall_s=wall,
         frames=len(handoff), frame_blocks=blocks, frame_bytes=frame_bytes,
         frame_bytes_per_block=frame_bytes / blocks,
         kv_bytes_per_block=LLAMA_1B_BLOCK_BYTES,
         distinct_links=len(links), imported_blocks=imported,
         prefix_hit_tokens=hit_tokens,
         export_encode_ms=_ms_stats([h[0] for h in handoff]),
         decode_import_ms=_ms_stats([h[1] for h in handoff]),
         prefill_hop_ms=_ms_stats([c.prefill_hop * 1e3 for c in clients]),
         ttft_p50_ms=statistics.median(ttfts) * 1e3,
         ttft_max_ms=ttfts[-1] * 1e3,
         ttft_decode_hop_p50_ms=statistics.median(ttfts_decode) * 1e3,
         ttft_decode_hop_max_ms=ttfts_decode[-1] * 1e3,
         decode_tokens_per_s=(generated - len(clients))
         / delta("decode", "decode_seconds"),
         decode_steps=decode_steps,
         decode_step_ms=delta("decode", "decode_seconds") / decode_steps
         * 1e3,
         **{f"{role}_side_{key}": value for role in ("prefill", "decode")
            for key, value in (
                ("prefill_steps", delta(role, "prefill_steps")),
                ("prefill_step_ms", delta(role, "prefill_seconds")
                 / delta(role, "prefill_steps") * 1e3))},
         decode_kernel_launches=launches,
         prefill_kernel_launches=prefill_launches,
         prefill_kernel_dispatches=dispatches,
         serve_llama={k: v for k, v in SERVE_LLAMA.items()
                      if k != "streams"},
         diverged=[t["diverged_at"] for t in ties],
         near_ties=[t for t in ties if t["diverged_at"] is not None])


def phase_disagg_parity() -> None:
    """f32 on the card: gpt2-small and llama-1b widths at 2 layers.  Each
    request is prefilled by a PrefillLLMDeployment (a v1 frame) and
    decoded from the frame by a fresh DecodeLLMDeployment; greedy and
    seeded T 0.8 must be token-exact against a monolithic LLMDeployment,
    and a second import of a frame installs nothing.  Then a bf16 pool's
    v2 frame, installed and exported again, gives the same bits."""
    from ray_tpu_torch.models import gpt, llama
    from ray_tpu_torch.serve import (DecodeLLMDeployment, KVBlockCodec,
                                     LLMDeployment, PrefillLLMDeployment)

    _f32_exact()
    kw = dict(max_lanes=4, block_size=16, max_seq_len=256)
    models = (
        ("gpt2-small float32", "gpt",
         dataclasses.replace(gpt.CONFIGS["gpt2-small"], dtype=torch.float32),
         gpt),
        ("llama-1b widths, 2 layers, float32", "llama",
         dataclasses.replace(llama.CONFIGS["llama-1b"], n_layers=2,
                             dtype=torch.float32), llama))
    for label, family, config, module in models:
        params = module.init_params(config, torch.Generator().manual_seed(7),
                                    device="cpu")
        vocab = config.vocab_size
        reqs = [([(29 * i + 13 * j + 5) % vocab for j in range(n)],
                 dict(max_new_tokens=16, **(dict(temperature=0.8, seed=600 + i)
                                            if i % 2 else {})))
                for i, n in enumerate((40, 57, 70, 33))]
        replicas = [cls(family, config, params, **kw) for cls in (
            PrefillLLMDeployment, DecodeLLMDeployment, LLMDeployment)]
        pre, dec, mono = replicas
        try:
            same, blocks = [], 0
            for prompt, rkw in reqs:
                frame = pre.prefill(prompt, seed=rkw.get("seed"))
                payload = KVBlockCodec.decode(frame)
                check(payload["v"] == 1 and payload["k"].dtype.name
                      == "float32", f"{label}: not a v1 float32 frame")
                n0 = dec.stats()["imported_blocks"]
                got = dec(prompt, kv_handoff=frame, **rkw)
                check(dec.stats()["imported_blocks"] - n0
                      == len(payload["chain"]), f"{label}: import count")
                check(dec._engine.import_prefix(payload) == 0,
                      f"{label}: a second import installed blocks")
                same.append(got == mono(prompt, **rkw))
                blocks += len(payload["chain"])
        finally:
            for r in replicas:
                r._engine.shutdown()
        emit("disagg_parity", config=label, requests=len(reqs),
             imported_blocks=blocks, tokens_equal=same)
        check(all(same), f"{label}: disaggregated and monolithic tokens "
                         f"differ")
        del replicas, pre, dec, mono, params

    bconfig = dataclasses.replace(llama.CONFIGS["llama-1b"], n_layers=2)
    params = llama.init_params(bconfig, torch.Generator().manual_seed(7),
                               device="cpu")
    prompt = [(31 * j + 2) % bconfig.vocab_size for j in range(70)]
    pre = PrefillLLMDeployment("llama", bconfig, params, **kw)
    dec = DecodeLLMDeployment("llama", bconfig, params, **kw)
    try:
        frame = pre.prefill(prompt)
        payload = KVBlockCodec.decode(frame)
        check(payload["v"] == 2 and payload["k"].dtype.name == "uint16",
              "bf16 pool: not a v2 frame of uint16 bits")
        check(dec._engine.import_prefix(payload) == len(payload["chain"]),
              "bf16 pool: import count")
        again = dec._engine.export_prefix(prompt)
        exact = all(bool((again[n] == payload[n]).all())
                    for n in ("k", "v_pool"))
    finally:
        pre._engine.shutdown()
        dec._engine.shutdown()
    emit("disagg_parity_bf16", config="llama-1b widths, 2 layers, bf16",
         frame_bytes=len(frame), blocks=len(payload["chain"]),
         bit_exact=exact)
    check(exact, "bf16 frame round trip is not bit-exact on the card")
    del pre, dec, params
    torch.cuda.empty_cache()


def phase_kv_tier(report: dict) -> None:
    """llama-1b bf16 with kv_tier=True, 8 lanes, a pool of 1.5x one
    round's worst case and 16 host blocks (so the overflow reaches the
    spill files): three rounds of 8 distinct 160-token prompts, then
    round one again.  Blocks spill and restore; the restored chains hold
    the bits exported before their eviction; the repeat's streams equal a
    tier-less engine's or part at a near-tie; K4 ran 22 times per decode
    step and K5 22 times per prefill dispatch.  Times each spill (the device -> host copy inside `alloc`) and
    each restoring admission."""
    import numpy as np

    from ray_tpu_torch.inference import InferenceEngine
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops import attention as A

    config = llama.CONFIGS["llama-1b"]
    params = _llama_1b_params()
    lanes, plen, new, bs = 8, 160, 16, 16
    rng = np.random.default_rng(5)
    rounds = [[(rng.integers(0, config.vocab_size, plen).tolist(),
                dict(max_new_tokens=new, **(dict(temperature=0.8,
                                                 seed=700 + 10 * r + i)
                                            if i % 2 else {})))
               for i in range(lanes)] for r in range(3)]
    num_blocks = lanes * -(-(plen + new) // bs) * 3 // 2
    kw = dict(device="cuda", max_lanes=lanes, block_size=bs, seed=1234,
              auto_start=False)
    with tempfile.TemporaryDirectory() as spill_dir:
        eng = InferenceEngine("llama", config, params, num_blocks=num_blocks,
                              kv_tier=True, kv_tier_host_blocks=16,
                              spill_dir=spill_dir, **kw)
        cache = eng.cache
        spill_s, restore_s = [], []
        evict, adopt = cache.allocator.on_evict, cache.adopt_prefix

        def timed_evict(block):
            t0 = time.perf_counter()
            evict(block)
            spill_s.append(time.perf_counter() - t0)

        def timed_adopt(lane, tokens):
            n0, t0 = cache.stats["restored_blocks"], time.perf_counter()
            out = adopt(lane, tokens)
            torch.cuda.synchronize()
            if cache.stats["restored_blocks"] > n0:
                restore_s.append(time.perf_counter() - t0)
            return out

        cache.allocator.on_evict, cache.adopt_prefix = timed_evict, timed_adopt
        A.paged_decode_attention.launches = 0
        A.paged_prefill_attention.launches = 0
        st0 = eng.stats()
        steps0 = st0["decode_steps"]
        streams = [[h.tokens(timeout=60) for h in _drain(eng, rounds[0])]]
        snapshot = [eng.export_prefix(p) for p, _ in rounds[0]]
        for r in rounds[1:]:
            streams.append([h.tokens(timeout=60) for h in _drain(eng, r)])
        repeat = [h.tokens(timeout=60) for h in _drain(eng, rounds[0])]
        restored = [eng.export_prefix(p) for p, _ in rounds[0]]
        st = eng.stats()
        launches = A.paged_decode_attention.launches
        prefill_launches = A.paged_prefill_attention.launches
        spill_files = len(os.listdir(spill_dir))
        eng.shutdown()
        del eng, cache
    exact = all(a["chain"] == b["chain"] and all(
        bool((a[n] == b[n]).all()) for n in ("k", "v_pool"))
        for a, b in zip(snapshot, restored))
    check(exact, "restored blocks differ from their contents before "
                 "eviction")
    check(launches == (st["decode_steps"] - steps0) * config.n_layers,
          f"K4 launched {launches} times for {st['decode_steps'] - steps0} "
          f"decode steps")
    _check_prefill_launches("kv_tier", prefill_launches,
                            _prefill_dispatches(st0, st), config.n_layers)
    check(st["kv_tier_spilled_blocks"] > 0 and st["restored_blocks"] > 0
          and st["kv_tier_dropped_blocks"] >= 0, f"tier counters {st}")
    plain = InferenceEngine("llama", config, params, **kw)
    want = [h.tokens(timeout=60) for h in _drain(plain, rounds[0])]
    wparams = plain._work_params
    ties = [_near_tie(f"kv_tier request {i}", llama, config, wparams,
                      prompt, w, g, k.get("temperature", 0.0), k.get("seed"))
            for i, ((prompt, k), w, g) in enumerate(zip(rounds[0], want,
                                                        repeat))]
    del plain, wparams, params
    torch.cuda.empty_cache()
    emit("kv_tier", config="llama-1b", lanes=lanes, num_blocks=num_blocks,
         host_blocks=16, prompt_tokens=plen, rounds=len(rounds) + 1,
         spilled_blocks=st["kv_tier_spilled_blocks"],
         restored_blocks=st["restored_blocks"],
         tier_restored_blocks=st["kv_tier_restored_blocks"],
         dropped_blocks=st["kv_tier_dropped_blocks"],
         blocks_evicted=st["blocks_evicted"], spill_files_left=spill_files,
         spill_ms_per_block=sum(spill_s) / len(spill_s) * 1e3,
         restore_ms_per_block=sum(restore_s) * 1e3 / st["restored_blocks"],
         restoring_admissions=len(restore_s), restored_bit_exact=exact,
         repeat_equals_round_one=repeat == streams[0],
         diverged=[t["diverged_at"] for t in ties],
         decode_kernel_launches=launches,
         prefill_kernel_launches=prefill_launches)


# ------------------------------------------------------ training fabric

MOE_EXPERTS = 8


def _moe_probe(config):
    """An `after` hook for `_train`: one forward of the trained state
    with `gpt._moe_mlp` wrapped to keep each layer's aux and the share of
    its tokens dropped at capacity."""
    from ray_tpu_torch.models import gpt

    def probe(state, tokens):
        aux, dropped = [], []
        original = gpt._moe_mlp

        def record(x, router, w_up, w_down, c, *plan):
            _, _, _, rank, cap = gpt._route(x.reshape(-1, x.shape[-1]),
                                            router, c)
            dropped.append(float((rank >= cap).float().mean()))
            out, layer_aux = original(x, router, w_up, w_down, c, *plan)
            aux.append(float(layer_aux))
            return out, layer_aux

        gpt._moe_mlp = record
        try:
            with torch.no_grad():
                _, total = gpt.forward_trunk(state["params"], tokens, config)
        finally:
            gpt._moe_mlp = original
        return dict(aux_per_layer=aux, aux_total=float(total),
                    dropped_share_per_layer=dropped)

    return probe


def phase_train_moe(report: dict) -> None:
    """gpt2-small's widths and depth with 8 Switch experts per layer
    (the reference's GPTConfig takes any n_experts; its only preset is
    nano-moe), bf16, 8 x 1024 random tokens, weights drawn on the card:
    K1-K3 12 times per timed step, losses finite and falling, each
    layer's load-balancing aux within [1, e]."""
    from ray_tpu_torch.models import gpt

    config = dataclasses.replace(gpt.CONFIGS["gpt2-small"],
                                 n_experts=MOE_EXPERTS)
    out = _train(gpt, config, 8, 1024,
                 torch.Generator(device="cuda").manual_seed(0),
                 after=_moe_probe(config))
    aux = out["aux_per_layer"]
    check(len(aux) == config.n_layers and
          all(1.0 <= a <= MOE_EXPERTS for a in aux),
          f"train_moe: per-layer aux {aux} outside [1, {MOE_EXPERTS}]")
    check(abs(sum(aux) - out["aux_total"]) <= 1e-3 * out["aux_total"],
          f"train_moe: aux total {out['aux_total']} != sum {sum(aux)}")
    for name, n in out["kernel_launches"].items():
        report[name]["train_moe"] = dict(launches=n)
    emit("train_moe", config=f"gpt2-small, n_experts={MOE_EXPERTS}",
         moe_train_tokens_per_sec_per_chip=out.pop("tokens_per_s"), **out)


def phase_moe_parity() -> None:
    """gpt2-small widths at 2 layers with 8 experts in f32 (TF32 off),
    batch 2 x 256: the aux on the card and on the CPU within
    GRAD_TOLERANCE, then one train step each from the same weights: the
    losses and every gradient agree as train_parity's do."""
    from ray_tpu_torch.models import gpt

    _f32_exact()
    config = dataclasses.replace(gpt.CONFIGS["gpt2-small"], n_layers=2,
                                 dtype=torch.float32, n_experts=MOE_EXPERTS)
    params = gpt.init_params(config, torch.Generator().manual_seed(5),
                             device="cpu")
    tokens = torch.randint(0, config.vocab_size, (2, 256),
                           generator=torch.Generator().manual_seed(6))
    aux = {}
    with torch.no_grad():
        for device in ("cuda", "cpu"):
            aux[device] = float(gpt.forward_trunk(
                gpt._map(params, lambda t: t.to(device)), tokens.to(device),
                config)[1])
    rel = abs(aux["cuda"] - aux["cpu"]) / abs(aux["cpu"])
    label = f"gpt2-small widths, 2 layers, {MOE_EXPERTS} experts, float32"
    emit("moe_parity_aux", config=label, aux_cuda=aux["cuda"],
         aux_cpu=aux["cpu"], aux_rel_err=rel, tolerance=GRAD_TOLERANCE)
    check(rel <= GRAD_TOLERANCE, f"moe aux CUDA {aux['cuda']} vs CPU "
                                 f"{aux['cpu']}")
    _train_parity("moe_parity", gpt, config, params, tokens, label)


FABRIC_STEPS, FABRIC_SAVE_EVERY, FABRIC_BATCH, FABRIC_BLOCK = 10, 4, 24, 12


def _fabric_blocks(vocab: int, first_batch: int = 0):
    """Distinct blocks of FABRIC_BLOCK x 1024 random tokens, block i drawn
    from seed 100 + i by numpy when the feed's producer thread pulls it;
    two blocks make a batch."""
    import numpy as np

    per = FABRIC_BATCH // FABRIC_BLOCK
    for i in range(first_batch * per, FABRIC_STEPS * per):
        rng = np.random.default_rng(100 + i)
        yield {"tokens": rng.integers(0, vocab, (FABRIC_BLOCK, 1024),
                                      dtype=np.int32)}


class _OneWorker:
    """The worker-group contract of CudaBackend, for this process alone
    (chip_smoke imports no runtime)."""

    def __init__(self):
        import types

        self.workers = [types.SimpleNamespace(pid=os.getpid())]

    def execute(self, fn, *args):
        return [fn(*args)]

    def execute_single(self, rank, fn, *args):
        return fn(*args)

    def local_ranks(self):
        return [(0, 1)]


def _ckpt_timer():
    """An Observer keeping each save's stage span (ms) and the time from
    its end to the commit on the writer thread (ms)."""
    from ray_tpu_torch.util.observe import Observer

    class CkptTimer(Observer):
        def __init__(self):
            self.stage_ms, self.write_ms, self.staged_at = [], [], None

        def begin(self, plane, kind, **fields):
            return (plane, kind, time.perf_counter())

        def end(self, token, **fields):
            if token[:2] == ("ckpt", "stage"):
                self.staged_at = time.perf_counter()
                self.stage_ms.append((self.staged_at - token[2]) * 1e3)

        def record(self, plane, kind, **fields):
            if (plane, kind) == ("ckpt", "commit"):
                self.write_ms.append(
                    (time.perf_counter() - self.staged_at) * 1e3)

    return CkptTimer()


def _nccl_one_rank() -> dict:
    """CudaBackend's worker hook on this process: a one-rank nccl group,
    an all-reduce of a CUDA tensor, the group destroyed."""
    from ray_tpu_torch.train import CudaBackend, CudaConfig

    group, config = _OneWorker(), CudaConfig()
    backend = config.backend_cls()()
    infos = backend.on_start(group, config)
    try:
        name = torch.distributed.get_backend()
        t = torch.arange(4.0, device="cuda")
        torch.distributed.all_reduce(t)
        torch.cuda.synchronize()
        check(name == "nccl" and torch.equal(t.cpu(), torch.arange(4.0)),
              f"nccl group {name}: all_reduce gave {t.tolist()}")
    finally:
        backend.on_shutdown(group, config)
    check(not torch.distributed.is_initialized(), "nccl group not destroyed")
    return dict(backend=name, infos=infos)


def phase_train_fabric(report: dict) -> None:
    """gpt2-small (dense), bf16, 24 x 1024, fed by the port's device feed
    (numpy blocks drawn on the producer thread, pinned staging, a side
    stream): FABRIC_STEPS steps with a CheckpointManager save every
    FABRIC_SAVE_EVERY steps into a temporary directory; K1-K3 12 times
    per step.  Then a fresh state restored from the latest step steps
    again over the same batches: its losses must equal the
    uninterrupted run's, bit for bit.  Times the fed steps against steps
    on a resident batch, the save at the step boundary (the host copy),
    the write on the writer thread and the restore; then a one-rank nccl
    group through CudaBackend's worker hook."""
    from ray_tpu_torch.checkpoint import CheckpointManager
    from ray_tpu_torch.data import iter_device_batches
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.models._functional import adamw
    from ray_tpu_torch.models.convert import (train_state_from_numpy,
                                              train_state_to_tree)
    from ray_tpu_torch.ops import attention as A

    config = gpt.CONFIGS["gpt2-small"]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    init_state, train_step = gpt.make_train_step(config, adamw(1e-4),
                                                 device="cuda")
    state = init_state(torch.Generator(device="cuda").manual_seed(0))
    kernels = (A.flash_forward, A.flash_dq, A.flash_dkv)
    timer = _ckpt_timer()
    with tempfile.TemporaryDirectory() as root:
        mgr = CheckpointManager(root, observer=timer)
        feed = iter_device_batches(_fabric_blocks(config.vocab_size),
                                   device="cuda", batch_size=FABRIC_BATCH,
                                   drop_last=True)
        losses, step_ms, save_ms = [], [], []
        for fn in kernels:
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for batch in feed:
            state, metrics = train_step(state, batch)
            losses.append(metrics["loss"])
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            step_ms.append((t1 - t0) * 1e3)
            if state["step"] % FABRIC_SAVE_EVERY == 0:
                mgr.save(state["step"], train_state_to_tree(state))
                t0 = time.perf_counter()
                save_ms.append((t0 - t1) * 1e3)
            else:
                t0 = t1
        launches = {fn.__name__: fn.launches for fn in kernels}
        feed_stats = feed.stats()
        resident_ms = []
        for _ in range(4):
            t0 = time.perf_counter()
            state, _ = train_step(state, batch)
            torch.cuda.synchronize()
            resident_ms.append((time.perf_counter() - t0) * 1e3)
        mgr.wait_until_finished()
        step = mgr.latest_step()
        path = mgr.latest_checkpoint()
        saved_bytes = sum(os.path.getsize(os.path.join(path, f))
                          for f in os.listdir(path))
        del state, batch, feed
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        state = train_state_from_numpy(mgr.restore(step, device="cuda"),
                                       config, adamw(1e-4), device="cuda")
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        resumed = []
        for batch in iter_device_batches(
                _fabric_blocks(config.vocab_size, step), device="cuda",
                batch_size=FABRIC_BATCH, drop_last=True):
            state, metrics = train_step(state, batch)
            resumed.append(float(metrics["loss"]))
        steps_saved = mgr.steps()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del state, batch
    losses = [float(x) for x in losses]
    nccl = _nccl_one_rank()
    emit("train_fabric", config="gpt2-small", batch=FABRIC_BATCH, seq=1024,
         steps=FABRIC_STEPS, fed_step_ms=statistics.median(step_ms[1:]),
         resident_step_ms=statistics.median(resident_ms),
         step_ms=step_ms, feed=feed_stats, saves=steps_saved,
         save_call_ms=save_ms, stage_span_ms=timer.stage_ms,
         write_ms=timer.write_ms, saved_bytes=saved_bytes,
         restored_step=step, restore_ms=restore_ms, losses=losses,
         resumed_losses=resumed, peak_memory_gib=peak,
         kernel_launches=launches, nccl=nccl)
    check(all(math.isfinite(x) for x in losses), f"fabric loss {losses}")
    check(len(losses) == FABRIC_STEPS, f"fabric fed {len(losses)} batches")
    for name, n in launches.items():
        check(n == FABRIC_STEPS * config.n_layers,
              f"{name} launched {n} times for {FABRIC_STEPS} fed steps")
        report[name]["train_fabric"] = dict(launches=n)
    check(steps_saved == list(range(FABRIC_SAVE_EVERY, FABRIC_STEPS + 1,
                                    FABRIC_SAVE_EVERY)),
          f"fabric saves {steps_saved}")
    check(resumed == losses[step:],
          f"resumed losses {resumed} != uninterrupted {losses[step:]}")


def phase_train_resnet() -> None:
    """resnet50 at full width: bf16 convolutions and norms, fp32 params,
    a repeated batch of 64 random 224 x 224 x 3 images over 1000 classes,
    AdamW(1e-4), 2 warm-up + 6 timed steps; the loss finite and
    falling."""
    from ray_tpu_torch.models import resnet
    from ray_tpu_torch.models._functional import adamw

    config = resnet.CONFIGS["resnet50"]
    batch = 64
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    init_state, train_step = resnet.make_train_step(config, adamw(1e-4),
                                                    device="cuda")
    state = init_state(torch.Generator(device="cuda").manual_seed(0))
    gen = torch.Generator(device="cuda").manual_seed(1)
    data = {"images": torch.randn((batch, 224, 224, 3), generator=gen,
                                  device="cuda"),
            "labels": torch.randint(0, config.num_classes, (batch,),
                                    generator=gen, device="cuda")}
    losses = []
    for _ in range(TRAIN_WARMUP):
        state, metrics = train_step(state, data)
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        state, metrics = train_step(state, data)
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del state, data
    losses = [float(x) for x in losses]
    emit("train_resnet", config="resnet50", batch=batch, image=[224, 224, 3],
         params=resnet.num_params(config), warmup_steps=TRAIN_WARMUP,
         steps=TRAIN_STEPS, step_ms=dt / TRAIN_STEPS * 1e3,
         images_per_s=batch * TRAIN_STEPS / dt, peak_memory_gib=peak,
         losses=losses)
    check(all(math.isfinite(x) for x in losses), f"resnet loss {losses}")
    check(losses[-1] < losses[0], f"resnet loss did not fall: {losses}")


# --------------------------------------------------------------------- RL

RL_PROMPTS, RL_NEW_TOKENS, RL_TEMPLATE = 64, 32, 32


def _rl_prompts(vocab: int) -> list:
    """RL_PROMPTS prompts of 48-96 tokens, each starting with one shared
    RL_TEMPLATE-token template (the prefix cache's case on this path)."""
    import numpy as np

    rng = np.random.default_rng(5)
    template = rng.integers(0, vocab, RL_TEMPLATE).tolist()
    return [template + rng.integers(
        0, vocab, int(rng.integers(48, 97)) - RL_TEMPLATE).tolist()
        for _ in range(RL_PROMPTS)]


def _check_rl_batch(label, batch, handles, version, vocab) -> None:
    """A rollout batch against the handles it was built from (whose
    token streams rollout() has drained): time-major [T, B], each lane's
    full budget valid, the handle's log-probs where valid (each finite
    and <= 0), ids in the vocabulary, one version tag throughout."""
    import numpy as np

    T, B = batch["actions"].shape
    check(B == len(handles) and T == RL_NEW_TOKENS,
          f"{label}: batch [{T}, {B}], expected [{RL_NEW_TOKENS}, "
          f"{len(handles)}]")
    for b, h in enumerate(handles):
        lps = np.asarray(h.logps, np.float32)
        n = len(lps)
        check(h.finish_reason == "length" and n == RL_NEW_TOKENS,
              f"{label}: lane {b} stopped at {n} ({h.finish_reason})")
        check(batch["valid"][:, b].sum() == n, f"{label}: valid mask")
        check(np.array_equal(batch["action_logp"][:n, b], lps),
              f"{label}: log-probs differ from the handle's")
        check(bool(np.isfinite(lps).all() and (lps <= 0).all()),
              f"{label}: a log-prob is not finite or above 0")
    check(bool(((batch["actions"] >= 0) & (batch["actions"] < vocab)).all()),
          f"{label}: token id out of range")
    check((batch["policy_version"] == version).all(),
          f"{label}: policy_version is not {version}")


def phase_rl_rollout(report: dict) -> None:
    """EngineRolloutActor("llama", "llama-1b") at full width and depth:
    bf16, 32 lanes, block 16, temperature 1.0, weights drawn on the card.
    Two rollouts of RL_PROMPTS prompts x RL_NEW_TOKENS tokens with an
    adopt(1) of a second weight set between them, then an adopt
    mid-flight (after 5 steps of 32 lanes) that must keep every lane.
    K4 must have run 22 times per decode step of the whole drive, K5 22
    times per prefill dispatch."""
    from ray_tpu_torch.models import convert, llama
    from ray_tpu_torch.ops import attention as A
    from ray_tpu_torch.rl import EngineRolloutActor

    config = llama.CONFIGS["llama-1b"]
    params = _llama_1b_params()
    # The second weight set crosses as a publish delivers it on the RL
    # path: the reference's param tree of host numpy arrays.
    params2 = convert.params_to_numpy(_llama_1b_params(seed=4321))
    adopt_bytes = sum(leaf.nbytes for leaf in _tree_leaves(params2))
    actor = EngineRolloutActor("llama", "llama-1b", params=params,
                               max_lanes=32, block_size=16, temperature=1.0,
                               seed=0, device="cuda")
    eng = actor.engine
    handles: list = []
    submit = eng.submit

    def recording_submit(*args, **kwargs):
        handles.append(submit(*args, **kwargs))
        return handles[-1]

    eng.submit = recording_submit
    prompts = _rl_prompts(config.vocab_size)
    try:
        actor.rollout(prompts[:2], max_new_tokens=4, seed=1)    # warm-up
        torch.cuda.synchronize()
        before = eng.stats()
        handles.clear()
        A.paged_decode_attention.launches = 0
        A.paged_prefill_attention.launches = 0
        t0 = time.perf_counter()
        batch0, v0, m0 = actor.rollout(prompts, RL_NEW_TOKENS, seed=100)
        wall0 = time.perf_counter() - t0
        first = list(handles)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        actor.adopt(1, params2)
        torch.cuda.synchronize()
        adopt_ms = (time.perf_counter() - t1) * 1e3
        handles.clear()
        t2 = time.perf_counter()
        batch1, v1, m1 = actor.rollout(prompts, RL_NEW_TOKENS, seed=200)
        wall1 = time.perf_counter() - t2
        second = list(handles)
        # An adopt mid-flight: 32 live lanes keep going under the new
        # weights and finish their budgets.
        handles.clear()
        live = [eng.submit(p, RL_NEW_TOKENS, temperature=1.0, seed=300 + i)
                for i, p in enumerate(prompts[:32])]
        for _ in range(5):
            eng.step()
        active = eng.num_active
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        actor.adopt(2, params)
        torch.cuda.synchronize()
        adopt_on_card_ms = (time.perf_counter() - t3) * 1e3
        check(eng.num_active == active == 32,
              f"lanes live across the adopt: {active} -> {eng.num_active}")
        while eng.step():
            pass
        torch.cuda.synchronize()
        launches = A.paged_decode_attention.launches
        prefill_launches = A.paged_prefill_attention.launches
        after = eng.stats()
    finally:
        eng.shutdown()
    del params, params2, actor, eng
    torch.cuda.empty_cache()

    _check_rl_batch("rl_rollout v0", batch0, first, 0, config.vocab_size)
    _check_rl_batch("rl_rollout v1", batch1, second, 1, config.vocab_size)
    check(v0 == 0 and v1 == 1, f"versions {v0}, {v1}")
    for h in live:
        check(h.finish_reason == "length" and len(h.tokens())
              == RL_NEW_TOKENS == len(h.logps), "a mid-flight lane dropped")
    check(after["policy_version"] == 2, "engine version after the adopts")

    def delta(key):
        return after[key] - before[key]

    decode_steps = delta("decode_steps")
    check(launches == decode_steps * config.n_layers and launches > 0,
          f"K4 launched {launches} times for {decode_steps} decode steps x "
          f"{config.n_layers} layers")
    _check_prefill_launches("rl_rollout", prefill_launches,
                            _prefill_dispatches(before, after),
                            config.n_layers)
    hit_tokens = delta("prefix_hit_tokens")
    check(hit_tokens >= RL_TEMPLATE, "no prefix-cache hit on the template")
    tokens = m0["tokens"] + m1["tokens"]
    report["paged_decode_attention"]["llama_1b"]["rl_rollout"] = dict(
        launches=launches)
    report["paged_prefill_attention"]["llama_1b"]["rl_rollout"] = dict(
        launches=prefill_launches)
    emit("rl_rollout", config="llama-1b", lanes=32, prompts=RL_PROMPTS,
         new_tokens=RL_NEW_TOKENS, batch=list(batch0["actions"].shape),
         rollout_tokens=tokens, rollout_wall_s=wall0 + wall1,
         rollout_tokens_per_s=tokens / (wall0 + wall1),
         tokens_per_s_by_rollout=[m0["tokens"] / wall0,
                                  m1["tokens"] / wall1],
         decode_steps=decode_steps,
         decode_step_ms=delta("decode_seconds") / decode_steps * 1e3,
         prefill_steps=delta("prefill_steps"),
         prefill_step_ms=(delta("prefill_seconds") / delta("prefill_steps")
                          * 1e3),
         adopt_ms=adopt_ms, adopt_from="host numpy tree (fp32)",
         adopt_bytes=adopt_bytes,
         adopt_host_to_card_gb_per_s=adopt_bytes / adopt_ms / 1e6,
         adopt_on_card_ms=adopt_on_card_ms,
         adopt_params=llama.num_params(config),
         prefix_hit_tokens=hit_tokens, versions=[v0, v1, 2],
         mid_flight_lanes=active, decode_kernel_launches=launches,
         prefill_kernel_launches=prefill_launches)


RL_LEARNER_WARMUP, RL_LEARNER_STEPS = 3, 20


def phase_rl_learner() -> None:
    """IMPALA's V-trace learner on the Nature-CNN at full width: two
    fragments from RolloutWorker("SyntheticPixel-v0", 16 envs x 64 steps,
    postprocess=False) on the card, each 1,024 uint8 frames of 84x84x4
    (28.9 MB), the reference's IMPALA defaults (lr 6e-4, grad clip 40);
    3 warm-up and 20 timed updates, each ending in its metrics' host
    copy.  Every loss must be finite."""
    import numpy as np

    from ray_tpu_torch.rllib import IMPALAConfig, RolloutWorker
    from ray_tpu_torch.rllib.impala import _VTraceLearner

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = IMPALAConfig()
    worker = RolloutWorker("SyntheticPixel-v0", num_envs=16,
                           rollout_fragment_length=64, postprocess=False,
                           seed=0, device="cuda")
    learner = _VTraceLearner((84, 84, 4), 4, cfg, cfg.model_hidden, seed=0,
                             device="cuda")
    worker.set_weights(learner.get_weights())
    t0 = time.perf_counter()
    fragments = [worker.sample()[0] for _ in range(2)]
    sample_s = (time.perf_counter() - t0) / 2
    frames = fragments[0]["obs"]
    check(frames.shape == (64, 16, 84, 84, 4) and frames.dtype == np.uint8,
          f"fragment obs {frames.shape} {frames.dtype}")
    metrics = [learner.update(fragments[i % 2])
               for i in range(RL_LEARNER_WARMUP)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(RL_LEARNER_STEPS):
        metrics.append(learner.update(fragments[i % 2]))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [m["total_loss"] for m in metrics]
    check(all(math.isfinite(x) for x in losses), f"V-trace losses {losses}")
    n_frames = frames.shape[0] * frames.shape[1]
    emit("rl_learner", model="nature_cnn",
         params=sum(p.numel() for p in learner.model.parameters()),
         fragment=list(frames.shape), fragment_bytes=int(frames.nbytes),
         lr=cfg.lr, grad_clip=cfg.grad_clip, warmup=RL_LEARNER_WARMUP,
         updates=RL_LEARNER_STEPS, update_ms=dt / RL_LEARNER_STEPS * 1e3,
         updates_per_s=RL_LEARNER_STEPS / dt,
         frames_per_s=n_frames * RL_LEARNER_STEPS / dt,
         sample_s_per_fragment=sample_s,
         rollout_frames_per_s=n_frames / sample_s,
         peak_memory_gib=peak, losses=losses)


class _InlineRuntime:
    """The runtime handle's five calls, run in this process: an actor's
    method calls queue in order and run when a result is asked for (so an
    adopt published behind an in-flight sample lands after it, as on a
    cluster); `wait` hands back the oldest pending call, or nothing when
    it may not block; `put` wraps a value whose refs resolve when a call
    runs."""

    class Ref:
        def __init__(self, actor=None, call=None, value=None):
            self.actor, self.call, self.value = actor, call, value
            self.done = call is None

        def resolve(self):
            while not self.done:
                ref = self.actor.pending.pop(0)
                name, args = ref.call
                args = [a.resolve() if isinstance(a, _InlineRuntime.Ref)
                        else a for a in args]
                ref.value, ref.done = getattr(self.actor.obj, name)(*args), \
                    True
            return self.value

    class Actor:
        def __init__(self, obj):
            self.obj, self.pending = obj, []

        def __getattr__(self, name):
            actor = self

            class Method:
                @staticmethod
                def remote(*args):
                    ref = _InlineRuntime.Ref(actor, (name, args))
                    actor.pending.append(ref)
                    return ref
            return Method

    def remote(self, **_):
        def bind(cls):
            class Factory:
                @staticmethod
                def remote(**kwargs):
                    return _InlineRuntime.Actor(cls(**kwargs))
            return Factory
        return bind

    def put(self, value):
        return self.Ref(value=value)

    def get(self, ref, timeout=None):
        if isinstance(ref, list):
            return [r.resolve() for r in ref]
        return ref.resolve()

    def wait(self, refs, num_returns=1, timeout=None):
        ready = list(refs[:1]) if timeout else []
        return ready, [r for r in refs if r not in ready]

    def kill(self, actor):
        actor.pending.clear()


RL_PODRACER_UPDATES, RL_CKPT_AT = 30, 20


def phase_rl_podracer() -> None:
    """The Podracer loop in one process: PodracerConfig().build() with
    `_InlineRuntime` as the runtime, 2 EnvRolloutActors ("CartPole-v1",
    16 envs x 32 steps) and the stale-tolerant V-trace learner on the
    card: Podracer.training_step calls sample_versioned, then
    TrajectoryQueue.put, StaleTolerantLearner.update and
    publish_boundary, then adopt, in that order.  At staleness bounds 0,
    1 and 2: updates/s, accepted, stale-dropped (RL_BENCH.json's
    learner_by_staleness_bound).  At k=0 a checkpoint at update 20
    through the port's CheckpointManager, restored by restore_latest()
    into a fresh learner: the same params and Adam state, bit for bit.
    Then PPOConfig().rollouts(num_rollout_workers=0), 3 iterations on
    the card."""
    import numpy as np

    from ray_tpu_torch.rl import PodracerConfig, StaleTolerantLearner
    from ray_tpu_torch.rllib import PPOConfig

    def leaves(tree):
        if isinstance(tree, dict):
            return [x for k in sorted(tree) for x in leaves(tree[k])]
        if isinstance(tree, (tuple, list)):
            return [x for v in tree for x in leaves(v)]
        return [np.asarray(tree.cpu() if hasattr(tree, "cpu") else tree)]

    rows, saved = [], {}
    with tempfile.TemporaryDirectory() as root:
        for k in (0, 1, 2):
            algo = (PodracerConfig().environment("CartPole-v1")
                    .rollouts(num_rollout_workers=2, num_envs_per_worker=16,
                              rollout_fragment_length=32)
                    .training(staleness_bound=k, publish_interval=1,
                              min_updates_per_step=2,
                              ckpt_dir=root if k == 0 else None,
                              ckpt_interval=RL_CKPT_AT)
                    .resources(runtime=_InlineRuntime())
                    .debugging(seed=0).build())
            if k == 0:
                learner, save = algo.learner, algo.learner.checkpoint

                def checkpoint(**kw):
                    saved[learner.num_updates] = learner.state_tree()
                    save(**kw)

                learner.checkpoint = checkpoint
            algo.train()                       # warm-up
            u0 = algo.learner.num_updates
            t0 = time.perf_counter()
            while algo.learner.num_updates - u0 < RL_PODRACER_UPDATES:
                r = algo.train()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            st = r["queue"]
            losses_ok = math.isfinite(r["learner/total_loss"])
            rows.append(dict(
                staleness_bound=k,
                updates_per_s=(algo.learner.num_updates - u0) / dt,
                updates=algo.learner.num_updates, accepted=st["accepted"],
                stale_dropped=st["stale_dropped"],
                backpressured=st["backpressured"],
                fragments_per_s=st["accepted"] / dt,
                last_trained_staleness=r["learner/staleness"]))
            check(losses_ok, f"k={k}: loss not finite")
            algo.stop()
        check(RL_CKPT_AT in saved, f"no checkpoint at update {RL_CKPT_AT}")
        fresh = StaleTolerantLearner(4, 2, seed=99, ckpt_dir=root,
                                     device="cuda")
        restored = fresh.restore_latest()
        check(restored == RL_CKPT_AT, f"latest checkpoint {restored}")
        want = saved[restored]
        got = fresh.state_tree()
        same = all(np.array_equal(a, b) for a, b in zip(
            leaves(got), leaves(want)))
        check(same, f"restored state at update {restored} differs")

    algo = (PPOConfig().rollouts(num_rollout_workers=0)
            .debugging(seed=0).build())
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        r = algo.train()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    algo.stop()
    check(math.isfinite(r["learner/total_loss"]), "PPO loss not finite")
    emit("rl_podracer", env="CartPole-v1", actors=2, envs_per_actor=16,
         fragment_length=32, learner_by_staleness_bound=rows,
         checkpoint_step=restored, restored_bit_exact=same,
         ppo_iterations=3, ppo_s_per_iteration=times,
         ppo_sampled_rows=r["sampled_rows"],
         ppo_episode_reward_mean=r["episode_reward_mean"])


def phase_rl_parity() -> None:
    """The same work on the card and on the CPU, f32 with TF32 off: one
    _VTraceLearner update (MLP and Nature-CNN, same weights and batch,
    terminations and truncations in it): loss within 1e-5 relative and
    every parameter's update within 0.05 * lr; EngineRolloutActor at
    llama-1b widths, 2 layers, greedy (K4 on the card, its plain version
    on the CPU): actions token-exact, log-probs within 1e-4."""
    import numpy as np

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.rl import EngineRolloutActor
    from ray_tpu_torch.rllib import IMPALAConfig, SampleBatch
    from ray_tpu_torch.rllib.impala import _VTraceLearner

    _f32_exact()
    rng = np.random.default_rng(11)
    cfg = IMPALAConfig()
    out = {}
    for name, obs_dim, (T, B) in (("mlp", 4, (32, 16)),
                                  ("nature_cnn", (84, 84, 4), (16, 8))):
        shape = (obs_dim,) if isinstance(obs_dim, int) else obs_dim
        if name == "mlp":
            obs = rng.normal(size=(T + 1, B) + shape).astype(np.float32)
        else:
            obs = rng.integers(0, 256, (T + 1, B) + shape).astype(np.uint8)
        term, trunc = rng.random((T, B)) < 0.05, rng.random((T, B)) < 0.05
        batch = SampleBatch({
            "obs": obs[:T], "bootstrap_obs": obs[T],
            "actions": rng.integers(0, 4, (T, B)).astype(np.int32),
            "action_logp": rng.uniform(-2.0, -0.8, (T, B)).astype(
                np.float32),
            "rewards": rng.normal(size=(T, B)).astype(np.float32),
            "terminateds": term, "truncateds": trunc})
        res = {}
        for device in ("cuda", "cpu"):
            ln = _VTraceLearner(obs_dim, 4, cfg, cfg.model_hidden, seed=3,
                                device=device)
            before = [p.detach().cpu().clone() for p in ln.opt.params]
            m = ln.update(batch)
            res[device] = (m["total_loss"], [
                p.detach().cpu() - b for p, b in zip(ln.opt.params,
                                                     before)])
        loss_rel = abs(res["cuda"][0] - res["cpu"][0]) / abs(res["cpu"][0])
        upd_err = max(float((a - b).abs().max())
                      for a, b in zip(res["cuda"][1], res["cpu"][1]))
        out[name] = dict(batch=[T, B], loss_cuda=res["cuda"][0],
                         loss_cpu=res["cpu"][0], loss_rel_err=loss_rel,
                         max_update_err=upd_err, limit=0.05 * cfg.lr,
                         has_terminal=bool(term.any()),
                         has_truncation=bool(trunc.any()))
        check(loss_rel <= 1e-5, f"rl_parity {name}: loss {res}")
        check(upd_err <= 0.05 * cfg.lr,
              f"rl_parity {name}: update error {upd_err}")

    config = dataclasses.replace(llama.CONFIGS["llama-1b"], n_layers=2,
                                 dtype=torch.float32)
    params = llama.init_params(config, torch.Generator().manual_seed(7),
                               device="cpu")
    prompts = [[(37 * i + 11 * j) % config.vocab_size for j in range(n)]
               for i, n in enumerate((5, 17, 33, 48, 64, 9))]
    rolls = {}
    for device in ("cuda", "cpu"):
        actor = EngineRolloutActor("llama", config, params=params,
                                   max_lanes=4, block_size=16,
                                   max_seq_len=128, temperature=0.0,
                                   device=device)
        rolls[device] = actor.rollout(prompts, max_new_tokens=16)[0]
    same = np.array_equal(rolls["cuda"]["actions"], rolls["cpu"]["actions"])
    lp_err = float(np.abs(rolls["cuda"]["action_logp"]
                          - rolls["cpu"]["action_logp"]).max())
    emit("rl_parity", learner=out,
         engine=dict(config="llama-1b widths, 2 layers, float32",
                     prompts=len(prompts), new_tokens=16,
                     actions_equal=same, max_logp_err=lp_err))
    check(same, "rl_parity: CUDA and CPU rollout actions differ")
    check(lp_err <= 1e-4, f"rl_parity: log-prob error {lp_err}")


class _Profiled:
    """Device time and launches of a call, read by torch.profiler over
    `n` calls after an untraced timing of the same calls: device ms per
    call, launches per call (kernels and copies), and the busy share,
    device ms over the untraced call's host ms."""

    def __init__(self, fn, n: int = 5):
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        self.host_ms = (time.perf_counter() - t0) / n * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type.name == "CUDA"]
        self.device_ms = sum(e.self_device_time_total
                             for e in events) / n / 1e3
        self.ops = {e.key: e.count / n for e in prof.key_averages()
                    if e.device_type.name == "CPU"}
        self.launches = sum(e.count for e in events) / n
        self.busy = self.device_ms / self.host_ms

    def fields(self, prefix: str) -> dict:
        return {f"{prefix}_host_ms": self.host_ms,
                f"{prefix}_device_ms": self.device_ms,
                f"{prefix}_launches": self.launches,
                f"{prefix}_busy_share": self.busy}


PENDULUM_TARGET, PENDULUM_MAX_ITERS = -400.0, 150
RL_TIMED_CALLS = 5


def phase_rl_continuous() -> None:
    """PPO with GaussianActorCritic on Pendulum-v1 at the reference's
    `test_ppo_continuous_pendulum` settings (tests/test_rllib.py), on the
    card, until episode_reward_mean > -400 (at most 150 train() calls);
    then A2C and APPO on CartPole-v1 at their configs' defaults with the
    in-process runtime's 2 rollout actors, 5 timed train() calls each."""
    import numpy as np

    from ray_tpu_torch.rllib import A2CConfig, APPOConfig, PPOConfig

    algo = (PPOConfig().environment("Pendulum-v1")
            .rollouts(num_rollout_workers=0, num_envs_per_worker=16,
                      rollout_fragment_length=128)
            .training(train_batch_size=4096, sgd_minibatch_size=512,
                      num_sgd_iter=10, lr=1e-3, entropy_coeff=0.0,
                      clip_param=0.2, vf_clip_param=1e6, gamma=0.95,
                      grad_clip=1.0)
            .debugging(seed=0).build())
    learner = algo.learner
    sgd_s = [0.0]
    step = learner.update

    def timed_update(batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(batch)              # ends in the metrics' host copy
        sgd_s[0] += time.perf_counter() - t0
        return out

    learner.update = timed_update
    best, curve = -math.inf, []
    t0 = time.perf_counter()
    for _ in range(PENDULUM_MAX_ITERS):
        r = algo.train()
        curve.append(r["episode_reward_mean"])
        best = max(best, r["episode_reward_mean"])
        if best > PENDULUM_TARGET:
            break
    wall = time.perf_counter() - t0
    batch, _ = algo.workers.local_worker.sample()
    algo.stop()
    iters = len(curve)
    minibatches = iters * 10 * (4096 // 512)
    frames = r["timesteps_total"]
    emit("rl_continuous", algo="PPO", env="Pendulum-v1",
         model="GaussianActorCritic (64, 64)", iterations=iters,
         best_reward_mean=best, target=PENDULUM_TARGET,
         reward_curve=curve[::5] + [curve[-1]],
         ms_per_sgd_minibatch=sgd_s[0] / minibatches * 1e3,
         sgd_share_of_wall=sgd_s[0] / wall,
         env_frames_per_s=frames / wall, frames=frames, wall_s=wall,
         actions=[list(batch["actions"].shape), str(batch["actions"].dtype)])
    check(best > PENDULUM_TARGET,
          f"rl_continuous: PPO on Pendulum-v1 reached only {best}")
    check(batch["actions"].dtype == np.float32
          and batch["actions"].shape[-1] == 1, "continuous action plumbing")

    for name, cfg in (("A2C", A2CConfig()), ("APPO", APPOConfig())):
        algo = (cfg.environment("CartPole-v1")
                .resources(runtime=_InlineRuntime()).debugging(seed=0)
                .build())
        algo.train()                                   # warm-up
        times, losses = [], []
        for _ in range(RL_TIMED_CALLS):
            t0 = time.perf_counter()
            r = algo.train()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(r["learner/total_loss"])
        algo.stop()
        emit("rl_continuous", algo=name, env="CartPole-v1",
             s_per_train_call=times, losses=losses,
             timesteps_total=r["timesteps_total"],
             episode_reward_mean=r["episode_reward_mean"])
        check(all(math.isfinite(x) for x in losses),
              f"rl_continuous: {name} losses {losses}")


RL_OFFPOLICY_ROUNDS = 10


def phase_rl_offpolicy() -> None:
    """SAC and TD3 on Pendulum-v1, DQN on CartPole-v1, each at its
    config's defaults with the in-process runtime's 2 rollout actors and
    the learner on the card: train() until updates start (the buffer
    past learning_starts), then 20 timed rounds; 32 learner updates
    timed alone and 5 profiled.  DQN's target net must, after every
    round, equal the params at its last sync (syncs every 250 updates)
    and differ from the current params."""
    from ray_tpu_torch.rllib import DQNConfig, SACConfig, TD3Config

    for name, cfg in (("SAC", SACConfig().environment("Pendulum-v1")),
                      ("TD3", TD3Config().environment("Pendulum-v1")),
                      ("DQN", DQNConfig().environment("CartPole-v1"))):
        algo = cfg.resources(runtime=_InlineRuntime()).debugging(
            seed=0).build()
        learner = algo.learner
        syncs = []
        if name == "DQN":
            sync = learner.sync_target

            def recording_sync(sync=sync, learner=learner):
                sync()
                syncs.append((learner.num_updates, [
                    p.detach().clone() for p in learner.model.parameters()]))

            learner.sync_target = recording_sync
            initial = [p.detach().clone() for p in learner.target.parameters()]
        warm = 0
        while algo.train()["updates_this_iter"] == 0:
            warm += 1
        target_ok = True
        times = []
        for _ in range(RL_OFFPOLICY_ROUNDS):
            t0 = time.perf_counter()
            r = algo.train()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            if name == "DQN":
                want = syncs[-1][1] if syncs else initial
                target_ok &= all(torch.equal(a, b) for a, b in zip(
                    learner.target.parameters(), want))
                target_ok &= not all(torch.equal(a, b) for a, b in zip(
                    learner.target.parameters(), learner.model.parameters()))

        rounds_updates = learner.num_updates

        def one_update(algo=algo):
            algo.learner.update(algo.buffer.sample(cfg.train_batch_size))

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(32):
            one_update()
        torch.cuda.synchronize()
        update_ms = (time.perf_counter() - t0) / 32 * 1e3
        prof = _Profiled(one_update)
        losses = {k: v for k, v in r.items() if k.startswith("learner/")}
        fields = dict(
            algo=name, env=cfg.env, hidden=list(cfg.model_hidden),
            batch=cfg.train_batch_size, updates_per_step=cfg.updates_per_step,
            warmup_calls=warm + 1, rounds=RL_OFFPOLICY_ROUNDS,
            s_per_round=times, updates=rounds_updates,
            ms_per_update=update_ms, updates_per_s=1e3 / update_ms,
            buffer_size=r["buffer_size"],
            episode_reward_mean=r["episode_reward_mean"], **losses,
            **prof.fields("update"))
        if name == "SAC":
            fields["alpha"] = r["learner/alpha"]
        if name == "DQN":
            fields.update(target_syncs=[u for u, _ in syncs],
                          target_moved_only_at_syncs=target_ok)
        algo.stop()
        emit("rl_offpolicy", **fields)
        check(all(math.isfinite(v) for v in losses.values()),
              f"rl_offpolicy: {name} metrics {losses}")
        if name == "DQN":
            check(target_ok and syncs and all(
                u % cfg.target_update_freq == 0 for u, _ in syncs),
                f"rl_offpolicy: DQN target syncs {[u for u, _ in syncs]}")


MEMORY_ITERS = 60


def _memory_task() -> dict:
    """The LSTM half of the reference's gate (tests/test_rllib.py
    test_recurrent_ppo_solves_memory_task_feedforward_cannot) on the
    card: mean return of 4 fragments after MEMORY_ITERS iterations
    (the reference's test takes 120, where the LSTM read 47.98 of 48 on
    the card; cut for the run's time)."""
    from ray_tpu_torch.rllib import (RolloutWorker, TorchLearner,
                                     ppo_loss_recurrent)
    from ray_tpu_torch.rllib.learner import batch_tensors

    w = RolloutWorker("RepeatPrev-v0", num_envs=32,
                      rollout_fragment_length=24, hidden=(32,), seed=0,
                      gamma=0.5, lam=0.9, device="cuda",
                      policy_kind="recurrent", lstm_size=32)
    ln = TorchLearner(3, 3, hidden=(32,), model="lstm", lstm_size=32,
                      loss_fn=ppo_loss_recurrent,
                      config={"lr": 5e-3, "num_sgd_iter": 8,
                              "sgd_minibatch_size": 16,
                              "entropy_coeff": 0.01}, device="cuda")
    t0 = time.perf_counter()
    for _ in range(MEMORY_ITERS):
        w.set_weights(ln.get_weights())
        b, _ = w.sample()
        ln.update(b)
    wall = time.perf_counter() - t0
    rets = []
    for _ in range(4):
        _, m = w.sample()
        rets += m["episode_returns"]
    out = {"lstm_return": sum(rets) / max(len(rets), 1),
           "lstm_wall_s": wall}
    mb = {k: v[:16] for k, v in batch_tensors(b, ln.device).items()}
    out.update(_Profiled(lambda: ln.minibatch_step(mb)).fields(
        "lstm_minibatch"))
    return out


def phase_rl_recurrent() -> None:
    """The memory gate's LSTM half (> 40 of 48) with the LSTM's launches
    per minibatch (T 24, 16 sequences); then the
    recurrent V-trace learner at IMPALA's defaults with use_lstm (lstm
    64, hidden (64, 64)) on two RepeatPrev-v0 fragments of 16 envs x 64
    steps: 3 warm-up and 20 timed updates, 5 profiled."""
    from ray_tpu_torch.rllib import IMPALAConfig, RolloutWorker
    from ray_tpu_torch.rllib.impala import _VTraceLearner

    memory = _memory_task()
    cfg = IMPALAConfig().training(use_lstm=True)
    worker = RolloutWorker("RepeatPrev-v0", num_envs=16,
                           rollout_fragment_length=64, postprocess=False,
                           policy_kind="recurrent", lstm_size=cfg.lstm_size,
                           hidden=cfg.model_hidden, seed=0, device="cuda")
    learner = _VTraceLearner(3, 3, cfg, cfg.model_hidden, seed=0,
                             device="cuda")
    worker.set_weights(learner.get_weights())
    frags = [worker.sample()[0] for _ in range(2)]
    losses = [learner.update(frags[i % 2])["total_loss"] for i in range(3)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(RL_LEARNER_STEPS):
        losses.append(learner.update(frags[i % 2])["total_loss"])
    torch.cuda.synchronize()
    update_ms = (time.perf_counter() - t0) / RL_LEARNER_STEPS * 1e3
    prof = _Profiled(lambda: learner.update(frags[0]))
    emit("rl_recurrent", memory_task=dict(
        env="RepeatPrev-v0", envs=32, fragment=24, hidden=[32], lstm=32,
        iterations=MEMORY_ITERS, **memory),
        vtrace=dict(lstm=cfg.lstm_size, hidden=list(cfg.model_hidden),
                    fragment=list(frags[0]["obs"].shape),
                    resets=int(frags[0]["resets"].sum()),
                    update_ms=update_ms, updates_per_s=1e3 / update_ms,
                    losses=losses, **prof.fields("update")))
    check(memory["lstm_return"] > 40,
          f"rl_recurrent: LSTM scored {memory['lstm_return']} of 48")
    check(all(math.isfinite(x) for x in losses),
          f"rl_recurrent: V-trace losses {losses}")


def _parity_batches(rng):
    """Numpy batches for rl_breadth_parity, by learner."""
    import numpy as np

    from ray_tpu_torch.rllib import SampleBatch

    def f32(*shape, scale=1.0):
        return (scale * rng.normal(size=shape)).astype(np.float32)

    def transitions(n, obs_dim, discrete=0):
        return SampleBatch({
            "obs": f32(n, obs_dim), "next_obs": f32(n, obs_dim),
            "actions": (rng.integers(0, discrete, n).astype(np.int32)
                        if discrete else
                        rng.uniform(-2, 2, (n, 1)).astype(np.float32)),
            "rewards": f32(n), "dones": rng.random(n) < 0.1})

    def fragment(T, B, obs_dim, lstm=0):
        out = {"obs": f32(T, B, obs_dim), "bootstrap_obs": f32(B, obs_dim),
               "actions": rng.integers(0, 3, (T, B)).astype(np.int32),
               "action_logp": rng.uniform(-1.6, -0.6, (T, B)).astype(
                   np.float32),
               "rewards": f32(T, B), "terminateds": rng.random((T, B)) < 0.03,
               "truncateds": rng.random((T, B)) < 0.03}
        if lstm:
            out.update(state_in=f32(2, B, lstm, scale=0.3),
                       bootstrap_state=f32(2, B, lstm, scale=0.3),
                       resets=rng.random((T, B)) < 0.05)
        return SampleBatch(out)

    n = 512
    gaussian = SampleBatch({
        "obs": f32(n, 3), "actions": f32(n, 1), "action_logp": f32(n) - 1.0,
        "advantages": f32(n), "value_targets": f32(n, scale=3.0)})
    b, T = 16, 24
    seqs = SampleBatch({
        "obs": f32(b, T, 3), "actions": rng.integers(0, 3, (b, T)).astype(
            np.int32), "action_logp": rng.uniform(-1.6, -0.6, (b, T)).astype(
            np.float32), "advantages": f32(b, T),
        "value_targets": f32(b, T), "resets": rng.random((b, T)) < 0.1,
        "state_in": f32(b, 2, 32, scale=0.3)})
    m = 2048
    a2c = SampleBatch({
        "obs": f32(m, 4), "actions": rng.integers(0, 2, m).astype(np.int32),
        "action_logp": f32(m) - 1.0, "advantages": f32(m),
        "value_targets": f32(m, scale=3.0)})
    return {"ppo_gaussian": gaussian, "ppo_lstm": seqs, "a2c": a2c,
            "vtrace_lstm": fragment(64, 16, 3, lstm=64),
            "appo": fragment(64, 16, 4), "dqn": transitions(128, 4, 2),
            "sac": transitions(256, 3), "td3": transitions(256, 3)}


def _parity_learner(name: str, device: str):
    """A new learner of each kind, its weights drawn on the CPU from one
    seed (so equal on both devices), and its lr."""
    from ray_tpu_torch.rllib import (A2CConfig, APPOConfig, DQNConfig,
                                     IMPALAConfig, SACConfig, TD3Config,
                                     TorchLearner, a2c_loss,
                                     ppo_loss_continuous, ppo_loss_recurrent)
    from ray_tpu_torch.rllib.dqn import _QLearner
    from ray_tpu_torch.rllib.impala import _VTraceLearner
    from ray_tpu_torch.rllib.sac import _SACLearner
    from ray_tpu_torch.rllib.td3 import _TD3Learner

    ppo = {"lr": 1e-3, "grad_clip": 1.0, "num_sgd_iter": 1,
           "sgd_minibatch_size": 4096, "clip_param": 0.2,
           "vf_clip_param": 10.0, "vf_loss_coeff": 0.5, "entropy_coeff": 0.01}
    if name == "ppo_gaussian":
        return TorchLearner(3, 0, action_dim=1, loss_fn=ppo_loss_continuous,
                            config=ppo, seed=3, device=device), 1e-3
    if name == "ppo_lstm":
        return TorchLearner(3, 3, model="lstm", lstm_size=32, hidden=(32,),
                            loss_fn=ppo_loss_recurrent, config=ppo, seed=3,
                            device=device), 1e-3
    if name == "a2c":
        cfg = A2CConfig()
        return TorchLearner(4, 2, loss_fn=a2c_loss, config={
            "lr": cfg.lr, "grad_clip": cfg.grad_clip, "num_sgd_iter": 1,
            "sgd_minibatch_size": 2048, "entropy_coeff": cfg.entropy_coeff},
            seed=3, device=device), cfg.lr
    if name == "vtrace_lstm":
        cfg = IMPALAConfig().training(use_lstm=True)
        return _VTraceLearner(3, 3, cfg, cfg.model_hidden, 3,
                              device=device), cfg.lr
    if name == "appo":
        cfg = APPOConfig()
        return _VTraceLearner(4, 3, cfg, cfg.model_hidden, 3,
                              device=device), cfg.lr
    if name == "dqn":
        cfg = DQNConfig()
        return _QLearner(4, 2, cfg, cfg.model_hidden, 3,
                         device=device), cfg.lr
    if name == "sac":
        cfg = SACConfig()
        return _SACLearner(3, 1, cfg, -2.0, 2.0, 3, device=device), \
            cfg.actor_lr
    cfg = TD3Config()
    return _TD3Learner(3, 1, cfg, -2.0, 2.0, 3, device=device), cfg.actor_lr


def _parity_params(learner) -> list:
    nets = [getattr(learner, n) for n in ("model", "actor", "q1", "q2",
                                          "q1_t", "q2_t", "actor_t")
            if hasattr(learner, n)]
    out = [p.detach().cpu().clone() for m in nets for p in m.parameters()]
    if hasattr(learner, "log_alpha"):
        out.append(learner.log_alpha.detach().cpu().clone())
    return out


def phase_rl_breadth_parity() -> None:
    """One update of each new learner on the card and on the CPU, f32
    with TF32 off, from the same weights, batch and noise (TD3: two
    updates, so its delayed actor step and polyak run): every metric
    within 1e-5 relative + 1e-6, every parameter's update within
    0.05 * lr.
    Deterministic continuous actions (the Gaussian policy's clipped
    mean, TD3's actor without noise, SAC's tanh(mean)) within 1e-5;
    greedy recurrent actions over 8 threaded steps equal."""
    import numpy as np

    from ray_tpu_torch.rllib import (DeterministicNoiseRolloutPolicy,
                                     RecurrentTorchPolicy,
                                     SquashedGaussianRolloutPolicy,
                                     TorchPolicy)

    _f32_exact()
    rng = np.random.default_rng(17)
    batches = _parity_batches(rng)
    noise = {"sac": (rng.normal(size=(256, 1)).astype(np.float32),
                     rng.normal(size=(256, 1)).astype(np.float32)),
             "td3": rng.normal(size=(256, 1)).astype(np.float32)}
    rows = {}
    for name, batch in batches.items():
        res = {}
        for device in ("cuda", "cpu"):
            ln, lr = _parity_learner(name, device)
            before = _parity_params(ln)
            kw = {"noise": noise[name]} if name in noise else {}
            metrics = ln.update(batch, **kw)
            if name == "td3":
                metrics.update(ln.update(batch, **kw))
            res[device] = (metrics, [a - b for a, b in zip(
                _parity_params(ln), before)])
        (mc, uc), (mp, up) = res["cuda"], res["cpu"]
        # Metrics within 1e-5 relative, with a 1e-6 floor for those near
        # zero (a policy loss over normalized advantages).
        over = max(abs(mc[k] - mp[k]) - 1e-5 * abs(mp[k]) for k in mp)
        err = max(float((a - b).abs().max()) for a, b in zip(uc, up))
        moved = max(float(b.abs().max()) for b in up)
        rows[name] = dict(
            max_metric_abs_err=max(abs(mc[k] - mp[k]) for k in mp),
            loss_rel_err=max(abs(mc[k] - mp[k]) / abs(mp[k]) for k in mp
                             if k in ("total_loss", "loss", "critic_loss")),
            max_update_err=err, limit=0.05 * lr, max_update=moved)
        check(over <= 1e-6 and err <= 0.05 * lr and moved > 0,
              f"rl_breadth_parity {name}: {rows[name]}")

    x = rng.normal(size=(64, 3)).astype(np.float32)
    acts = {}
    for name, make in (
            ("gaussian_mean", lambda d: TorchPolicy(
                3, 0, action_dim=1, action_low=-2.0, action_high=2.0,
                seed=5, device=d)),
            ("td3_actor", lambda d: DeterministicNoiseRolloutPolicy(
                3, 1, seed=5, action_low=-2.0, action_high=2.0, device=d)),
            ("sac_tanh_mean", lambda d: SquashedGaussianRolloutPolicy(
                3, 1, seed=5, action_low=-2.0, action_high=2.0, device=d))):
        a, b = (make(d).compute_actions(x, explore=False)[0]
                for d in ("cuda", "cpu"))
        acts[name] = float(np.abs(a - b).max())
        check(acts[name] <= 1e-5, f"rl_breadth_parity {name}: {acts[name]}")
    greedy = {}
    for d in ("cuda", "cpu"):
        pol = RecurrentTorchPolicy(3, 3, (64,), 64, seed=5, device=d)
        state, seq = pol.initial_state(64), []
        for t in range(8):
            obs = np.eye(3, dtype=np.float32)[(np.arange(64) + t) % 3]
            a, _, _, _, state = pol.compute_actions(obs, state,
                                                    explore=False)
            seq.append(a)
        greedy[d] = np.stack(seq)
    same = bool(np.array_equal(greedy["cuda"], greedy["cpu"]))
    emit("rl_breadth_parity", learners=rows, continuous_action_err=acts,
         recurrent_greedy_equal=same)
    check(same, "rl_breadth_parity: greedy recurrent actions differ")


# ------------------------------------------------- offline and multi-agent

def _mixed_quality_log(n_episodes=60, ep_len=10, seed=0):
    """tests/test_rllib_offline_eval.py's log: 40% expert episodes (the
    right action, reward 1 a step), 60% anti-expert (the wrong one,
    reward 0), so imitation by majority learns the wrong action."""
    import numpy as np

    from ray_tpu_torch.rllib import SampleBatch

    rng = np.random.default_rng(seed)
    obs, acts, rews, terms = [], [], [], []
    for ep in range(n_episodes):
        expert = ep % 5 < 2
        for t in range(ep_len):
            s = rng.uniform(-1, 1, 4).astype(np.float32)
            correct = int(s[2] > 0)
            obs.append(s)
            acts.append(correct if expert else 1 - correct)
            rews.append(1.0 if expert else 0.0)
            terms.append(t == ep_len - 1)
    return SampleBatch({"obs": np.stack(obs),
                        "actions": np.array(acts, np.int64),
                        "rewards": np.array(rews, np.float32),
                        "terminateds": np.array(terms)})


# The enumerated two-step MDP of tests/test_rllib_offline_eval.py: s0 ->
# s1, r(s0, a) = a, r(s1, a) = (2, 5)[a], behaviour uniform, target
# pi(s0) = (0.2, 0.8), pi(s1) = (0.7, 0.3); every behaviour trajectory
# once, so unbiased estimators hit the true value exactly.
OPE_GAMMA = 0.9
OPE_V_TRUE = 0.8 + OPE_GAMMA * (0.7 * 2 + 0.3 * 5)


def _enumerated_batch():
    import numpy as np

    from ray_tpu_torch.rllib import SampleBatch

    obs = {0: [1.0, 0.0], 1: [0.0, 1.0]}
    rows = []
    for a0 in (0, 1):
        for a1 in (0, 1):
            rows += [(obs[0], a0, float(a0), False),
                     (obs[1], a1, (2.0, 5.0)[a1], True)]
    o, a, r, d = zip(*rows)
    n = len(rows)
    return SampleBatch({
        "obs": np.array(o, np.float32), "actions": np.array(a, np.int64),
        "rewards": np.array(r, np.float32),
        "action_logp": np.full(n, np.log(0.5), np.float32),
        "terminateds": np.array(d), "truncateds": np.zeros(n, bool)})


def _ope_target_probs(obs):
    import numpy as np
    return np.where(np.asarray(obs)[:, :1] == 1.0, [0.2, 0.8], [0.7, 0.3])


def _ope_exact_q(obs):
    import numpy as np
    v_s1 = 0.7 * 2 + 0.3 * 5
    return np.where(np.asarray(obs)[:, :1] == 1.0,
                    [OPE_GAMMA * v_s1, 1.0 + OPE_GAMMA * v_s1], [2.0, 5.0])


def phase_rl_offline() -> None:
    """The reference's offline gates on the card: BC on a JSON-logged
    expert (BCConfig() defaults, 640 rows, 30 train_on calls, agreement
    > 0.95 on 200 held-out states); MARWIL at beta 0 and 2 on the
    mixed-quality log (40 epochs, seed 5: beta 2 > 0.9, beta 0 < 0.5);
    CQL at alpha 1 against 0 on the 2-state log (the unlogged action's
    Q below every logged action's, and a wider gap than plain TD);
    fit_fqe at its defaults (hidden (64,), lr 1e-2, 200 iterations) into
    DM and DR on a logged CartPole batch, and the closed forms of
    tests/test_rllib_offline_eval.py (IS, WIS, DM, DR exact; FQE-fed DM
    within 0.4).  Ms, launches and busy share per update (one train_on
    of train_batch_size rows) and per FQE iteration."""
    import numpy as np

    from ray_tpu_torch.rllib import (BC, CQL, ESTIMATORS, MARWIL, BCConfig,
                                     CQLConfig, JsonReader, JsonWriter,
                                     MARWILConfig, SampleBatch, fit_fqe,
                                     make_vector_env)

    out = {}
    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory() as root:
        writer = JsonWriter(root)
        for _ in range(40):
            obs = rng.uniform(-0.2, 0.2, size=(16, 4)).astype(np.float32)
            writer.write(SampleBatch({"obs": obs, "actions": (
                obs[:, 2] > 0).astype(np.int64)}))
        writer.close()
        log = JsonReader(root).read_all()
    bc = BC(4, 2, BCConfig())
    t0 = time.perf_counter()
    for _ in range(30):
        m = bc.train_on(log)
    bc_s = time.perf_counter() - t0
    held = rng.uniform(-0.2, 0.2, size=(200, 4)).astype(np.float32)
    bc_acc = float((bc.compute_actions(held) == (held[:, 2] > 0)).mean())
    one = SampleBatch({k: v[:256] for k, v in log.items()})
    out["bc"] = dict(rows=log.count, calls=30, updates=90, wall_s=bc_s,
                     agreement=bc_acc, loss=m["bc_loss"],
                     **_Profiled(lambda: bc.train_on(one)).fields("update"))
    check(bc_acc > 0.95, f"rl_offline: BC agreement {bc_acc}")

    mixed = _mixed_quality_log()
    test_obs = np.random.default_rng(42).uniform(-1, 1, (400, 4)).astype(
        np.float32)
    expert = (test_obs[:, 2] > 0).astype(np.int64)
    acc = {}
    for beta in (0.0, 2.0):
        cfg = MARWILConfig()
        cfg.beta, cfg.num_epochs, cfg.seed = beta, 40, 5
        algo = MARWIL(4, 2, cfg)
        t0 = time.perf_counter()
        algo.train_on(mixed)
        acc[beta] = (float((algo.compute_actions(test_obs)
                            == expert).mean()), time.perf_counter() - t0)
    cfg.num_epochs = 1
    one = SampleBatch({k: v[:256] for k, v in mixed.items()})
    out["marwil"] = dict(agreement_beta0=acc[0.0][0],
                         agreement_beta2=acc[2.0][0],
                         wall_s=acc[0.0][1] + acc[2.0][1],
                         updates=2 * 40 * 3, adv_norm_sq=algo.adv_norm_sq,
                         **_Profiled(lambda: algo.train_on(one)).fields(
                             "update"))
    check(acc[2.0][0] > 0.9 and acc[0.0][0] < 0.5,
          f"rl_offline: MARWIL agreement {acc}")

    rng3 = np.random.default_rng(3)
    n = 600
    s0 = np.eye(2, dtype=np.float32)[0]
    acts = rng3.integers(0, 2, n)
    bandit = SampleBatch({
        "obs": np.tile(s0, (n, 1)), "actions": acts.astype(np.int64),
        "rewards": np.where(acts == 0, 1.0, 0.2).astype(np.float32),
        "terminateds": np.ones(n, bool)})
    qs = {}
    for alpha in (1.0, 0.0):
        cfg = CQLConfig()
        cfg.cql_alpha, cfg.num_epochs, cfg.seed = alpha, 30, 7
        cql = CQL(2, 3, cfg)
        t0 = time.perf_counter()
        cql.train_on(bandit)
        qs[alpha] = (cql.q_values(s0[None])[0], time.perf_counter() - t0)
    q, q_td = qs[1.0][0], qs[0.0][0]
    cfg.num_epochs = 1
    one = SampleBatch({k: v[:256] for k, v in bandit.items()})
    out["cql"] = dict(q_alpha1=q.tolist(), q_alpha0=q_td.tolist(),
                      wall_s=qs[1.0][1] + qs[0.0][1], updates=2 * 30 * 3,
                      **_Profiled(lambda: cql.train_on(one)).fields(
                          "update"))
    check(q.argmax() == 0 and q[2] < q[1] < q[0]
          and (q.max() - q[2]) > (q_td.max() - q_td[2]) + 0.2,
          f"rl_offline: CQL Q-values {q} against TD's {q_td}")

    enum = _enumerated_batch()
    exact = {}
    for key in ("is", "wis", "dm", "dr"):
        est = ESTIMATORS[key](_ope_target_probs, gamma=OPE_GAMMA,
                              q_fn=_ope_exact_q)
        exact[key] = est.estimate(enum)["v_target"]
    wrong = ESTIMATORS["dr"](_ope_target_probs, gamma=OPE_GAMMA,
                             q_fn=lambda o: _ope_exact_q(o) + 1.7)
    exact["dr_wrong_model"] = wrong.estimate(enum)["v_target"]
    big = SampleBatch.concat_samples([enum] * 16)
    q_fn = fit_fqe(big, _ope_target_probs, num_actions=2, gamma=OPE_GAMMA,
                   iterations=400, lr=3e-2, hidden=(32,), seed=0)
    fqe_dm = ESTIMATORS["dm"](_ope_target_probs, gamma=OPE_GAMMA,
                              q_fn=q_fn).estimate(big)["v_target"]
    check(all(abs(v - OPE_V_TRUE) < 1e-5 for v in exact.values())
          and abs(fqe_dm - OPE_V_TRUE) < 0.4,
          f"rl_offline: closed forms {exact}, FQE-fed DM {fqe_dm}, "
          f"truth {OPE_V_TRUE}")

    # A logged CartPole batch: 16 envs x 64 steps of a uniform behaviour
    # policy; the target leans on the pole's angle.
    env = make_vector_env("CartPole-v1", 16, seed=1)
    o = env.reset_all(1)
    acts_rng = np.random.default_rng(2)
    cols = {k: [] for k in ("obs", "actions", "rewards", "terminateds",
                            "truncateds")}
    for _ in range(64):
        a = acts_rng.integers(0, 2, 16)
        cols["obs"].append(o)
        cols["actions"].append(a)
        o, r, term, trunc = env.step(a)
        cols["rewards"].append(r)
        cols["terminateds"].append(term)
        cols["truncateds"].append(trunc)
    # Env-major rows: each env's steps in order, its last step truncated.
    rows = {k: np.stack(v, 1).reshape((16 * 64,) + np.asarray(v[0]).shape[1:])
            for k, v in cols.items()}
    rows["truncateds"] = rows["truncateds"].reshape(16, 64)
    rows["truncateds"][:, -1] = True
    rows["truncateds"] = rows["truncateds"].reshape(-1)
    cart = SampleBatch(dict(rows, action_logp=np.full(16 * 64, np.log(0.5),
                                                       np.float32)))

    def lean(obs):
        p1 = 1.0 / (1.0 + np.exp(-10.0 * np.asarray(obs)[:, 2]))
        return np.stack([1.0 - p1, p1], -1)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    q_cart = fit_fqe(cart, lean, num_actions=2)
    fqe_ms = (time.perf_counter() - t0) / 200 * 1e3
    ests = {k: ESTIMATORS[k](lean, gamma=0.99, q_fn=q_cart).estimate(cart)
            for k in ESTIMATORS}
    behaviour = ESTIMATORS["is"](lambda obs: np.full((len(obs), 2), 0.5),
                                gamma=0.99).estimate(cart)
    prof = _Profiled(lambda: fit_fqe(cart, lean, num_actions=2,
                                     iterations=20), n=2)
    out["fqe"] = dict(
        closed_form=exact, fqe_dm_enumerated=fqe_dm, truth=OPE_V_TRUE,
        cartpole_rows=cart.count,
        cartpole_episodes=ests["dm"]["episodes"],
        cartpole_v_behavior=ests["dm"]["v_behavior"],
        cartpole_v_target={k: v["v_target"] for k, v in ests.items()},
        ms_per_iteration=fqe_ms,
        iteration_launches=prof.launches / 20,
        iteration_device_ms=prof.device_ms / 20,
        iteration_busy_share=prof.busy)
    emit("rl_offline", **out)
    # The behaviour policy evaluated as the target: every ratio 1 (to
    # float32's rounding of log 0.5), so IS returns v_behavior.
    check(all(math.isfinite(v["v_target"]) for v in ests.values())
          and abs(behaviour["v_target"] - behaviour["v_behavior"])
          <= 1e-5 * abs(behaviour["v_behavior"]),
          f"rl_offline: CartPole estimates {out['fqe']}")


def _coop_split(agent_id: str) -> str:
    return {"a0": "p0", "a1": "p1"}[agent_id]


MA_PPO_MAX_ITERS, MA_TARGET = 12, 12.0
QMIX_MAX_CALLS, QMIX_TARGET = 20, 7.9


def phase_rl_multi_agent() -> None:
    """Multi-agent PPO on coop-match at the reference test's config (16
    envs x 32, batch 1024, minibatch 256, 6 SGD iterations, lr 5e-3,
    seed 7), policies and learners on the card: both policies at 12 or
    more within 12 iterations.  QMIX and VDN at QMixConfig()'s defaults
    on the two-step game: evaluate_greedy >= 7.9 within 20 train() calls.
    A PolicyServer with its policy on the card, driven by a PolicyClient
    over localhost for 3 episodes of 10 steps, into one PPO learner
    update on the card."""
    import numpy as np

    from ray_tpu_torch.rllib import (PolicyClient, PolicyServer, PPOConfig,
                                     QMixConfig, TorchLearner, VDNConfig,
                                     ppo_loss)
    from ray_tpu_torch.rllib.learner import batch_tensors

    algo = (PPOConfig().environment("coop-match")
            .rollouts(num_rollout_workers=0, num_envs_per_worker=16,
                      rollout_fragment_length=32)
            .multi_agent(policies=["p0", "p1"],
                         policy_mapping_fn=_coop_split)
            .training(train_batch_size=1024, sgd_minibatch_size=256,
                      num_sgd_iter=6, lr=5e-3, entropy_coeff=0.003)
            .debugging(seed=7).build())
    learner = algo.learners["p0"]
    curve, t0 = [], time.perf_counter()
    for _ in range(MA_PPO_MAX_ITERS):
        r = algo.train()
        curve.append((r["policy_reward_mean/p0"],
                      r["policy_reward_mean/p1"]))
        if min(curve[-1]) >= MA_TARGET:
            break
    wall = time.perf_counter() - t0
    batch, _ = algo.workers.local_worker.sample()
    mb = {k: v[:256] for k, v in batch_tensors(
        batch.policy_batches["p0"], learner.device).items()}
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(20):
        learner.minibatch_step(mb)
    torch.cuda.synchronize()
    mb_ms = (time.perf_counter() - t1) / 20 * 1e3
    prof = _Profiled(lambda: learner.minibatch_step(mb))
    algo.stop()
    ma = dict(env="coop-match", calls=len(curve), curve=curve, wall_s=wall,
              ms_per_minibatch=mb_ms, **prof.fields("minibatch"))
    check(min(curve[-1]) >= MA_TARGET,
          f"rl_multi_agent: PPO policies reached only {curve[-1]}")

    qmix = {}
    for name, cls in (("QMIX", QMixConfig), ("VDN", VDNConfig)):
        q = cls().build()
        calls, best, t0 = 0, 0.0, time.perf_counter()
        for calls in range(1, QMIX_MAX_CALLS + 1):
            q.train()
            best = q.evaluate_greedy()
            if best >= QMIX_TARGET:
                break
        wall = time.perf_counter() - t0
        replay = q.sample_replay()

        def step(q=q, replay=replay):
            float(q.train_step(*replay))

        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(20):
            step()
        step_ms = (time.perf_counter() - t1) / 20 * 1e3
        qmix[name] = dict(calls_to_gate=calls, evaluate_greedy=best,
                          wall_s=wall, ms_per_train_step=step_ms,
                          **_Profiled(step).fields("train_step"))
        check(best >= QMIX_TARGET,
              f"rl_multi_agent: {name} reached only {best} in {calls}")

    server = PolicyServer(4, 2, seed=0)
    try:
        client = PolicyClient(server.address)
        rng = np.random.default_rng(0)
        t0 = time.perf_counter()
        for _ in range(3):
            eid = client.start_episode()
            obs = rng.normal(size=4)
            for _ in range(10):
                a = client.get_action(eid, obs)
                client.log_returns(eid, 1.0 if a == 0 else 0.0)
                obs = rng.normal(size=4)
            client.end_episode(eid, obs)
        rt_ms = (time.perf_counter() - t0) / 30 * 1e3
        got = server.to_sample_batch(min_rows=30)
        check(got is not None and got[0].count == 30 and len(got[1]) == 3,
              "rl_multi_agent: the policy server drained no 30 rows")
        ln = TorchLearner(4, 2, loss_fn=ppo_loss,
                          config={"lr": 1e-3, "num_sgd_iter": 2,
                                  "sgd_minibatch_size": 16})
        metrics = ln.update(got[0])
        server.set_weights(ln.get_weights())
        check(math.isfinite(metrics["total_loss"])
              and server.to_sample_batch(min_rows=1) is None,
              f"rl_multi_agent: policy server update {metrics}")
    finally:
        server.stop()
    emit("rl_multi_agent", ppo=ma, qmix=qmix,
         policy_server=dict(episodes=3, steps=30, ms_per_step=rt_ms,
                            returns=got[1],
                            total_loss=metrics["total_loss"]))


def phase_rl_tune() -> None:
    """PPO on CartPole-v1 (tests/test_rllib.py's checkpoint config) on the
    card: train, save(), restore into a fresh PPO on the card and one on
    the CPU; weights and iteration bit-equal.  Then as_trainable with
    stop_iters=3 and a list-appending report: 3 results, each with
    episode_reward_mean."""
    from ray_tpu_torch.rllib import PPO, PPOConfig

    def config(device):
        return (PPOConfig().environment("CartPole-v1")
                .rollouts(num_rollout_workers=0, num_envs_per_worker=4,
                          rollout_fragment_length=16)
                .training(train_batch_size=64, sgd_minibatch_size=32,
                          num_sgd_iter=2)
                .resources(device=device, rollout_device=device))

    algo = config(None).build()
    algo.train()
    algo.train()
    ckpt = algo.save()
    saved = [p.detach().cpu() for p in algo.learner.model.parameters()]
    same = {}
    for device in ("cuda", "cpu"):
        other = config(device).build()
        other.restore(ckpt)
        params = [p.detach().cpu() for p in other.learner.model.parameters()]
        same[device] = (all(torch.equal(a, b) for a, b in zip(saved, params))
                        and other.iteration == algo.iteration == 2
                        and other.learner.opt.count == algo.learner.opt.count)
        other.stop()
    algo.stop()
    results = []
    PPO.as_trainable(config(None), stop_iters=3, report=results.append)({})
    emit("rl_tune", restore_bit_equal=same, iteration=2,
         trainable_results=len(results),
         episode_reward_mean=[r["episode_reward_mean"] for r in results])
    check(all(same.values()), f"rl_tune: restore {same}")
    check(len(results) == 3 and all("episode_reward_mean" in r
                                    for r in results),
          f"rl_tune: as_trainable reported {len(results)} results")


def phase_rl_offline_parity() -> None:
    """One update each of BC, MARWIL, CQL, QMIX, VDN and the two
    learners of multi-agent PPO on the card and on the CPU, f32 with
    TF32 off, from the same weights (drawn on the CPU from one seed) and
    the same batch: every metric within 1e-5 relative + 1e-6, every
    parameter's update within 0.05 x lr."""
    import numpy as np

    from ray_tpu_torch.rllib import (BC, CQL, MARWIL, BCConfig, CQLConfig,
                                     MARWILConfig, MultiAgentBatch, PPOConfig,
                                     QMixConfig, SampleBatch, VDNConfig)

    _f32_exact()
    rng = np.random.default_rng(23)
    n = 256
    offline = SampleBatch({
        "obs": rng.normal(size=(n, 4)).astype(np.float32),
        "actions": rng.integers(0, 2, n).astype(np.int64),
        "rewards": rng.normal(size=n).astype(np.float32),
        "terminateds": rng.random(n) < 0.1})
    replay = (np.repeat(np.eye(3, dtype=np.float32)[rng.integers(0, 3, 128)]
                        [:, None], 2, 1), rng.integers(0, 2, (128, 2)),
              (4 * rng.normal(size=128)).astype(np.float32),
              np.repeat(np.eye(3, dtype=np.float32)[rng.integers(0, 3, 128)]
                        [:, None], 2, 1),
              (rng.random(128) < 0.5).astype(np.float32))
    ma_rows = None

    def run(name, device):
        """(metrics, [parameter updates]) of one update on `device`."""
        if name in ("bc", "marwil", "cql"):
            cls, cfg_cls = {"bc": (BC, BCConfig), "marwil": (MARWIL,
                                                            MARWILConfig),
                            "cql": (CQL, CQLConfig)}[name]
            ln = cls(4, 2, cfg_cls(), device=device)
            nets = [ln.model]
            step = lambda: {k: v for k, v in ln.train_on(offline).items()
                            if k != "samples"}
            lr = ln.config.lr
        elif name in ("qmix", "vdn"):
            ln = (QMixConfig() if name == "qmix" else VDNConfig()).resources(
                device=device).build()
            nets = [ln.model]
            step = lambda: {"td_loss": float(ln.train_step(*replay))}
            lr = ln.config.lr
        else:
            algo = (PPOConfig().environment("coop-match")
                    .rollouts(num_rollout_workers=0, num_envs_per_worker=16,
                              rollout_fragment_length=32)
                    .multi_agent(policies=["p0", "p1"],
                                 policy_mapping_fn=_coop_split)
                    .training(train_batch_size=512, sgd_minibatch_size=512,
                              num_sgd_iter=1, lr=5e-3)
                    .resources(device=device, rollout_device="cpu")
                    .debugging(seed=7).build())
            ln = algo
            nets = [algo.learners[p].model for p in ("p0", "p1")]
            step = lambda: {f"{p}/{k}": v for p in ("p0", "p1")
                            for k, v in algo.learners[p].update(
                                ma_rows.policy_batches[p]).items()}
            lr = 5e-3
        before = [p.detach().cpu().clone() for m in nets
                  for p in m.parameters()]
        metrics = step()
        after = [p.detach().cpu() for m in nets for p in m.parameters()]
        if hasattr(ln, "stop"):
            ln.stop()
        return metrics, [a - b for a, b in zip(after, before)], lr

    from ray_tpu_torch.rllib import MultiAgentRolloutWorker
    worker = MultiAgentRolloutWorker(
        "coop-match", num_envs=16, rollout_fragment_length=32, seed=3,
        policies={"p0": None, "p1": None}, policy_mapping_fn=_coop_split,
        device="cpu")
    ma_rows = MultiAgentBatch.concat_samples([worker.sample()[0]])
    rows = {}
    for name in ("bc", "marwil", "cql", "qmix", "vdn", "ma_ppo"):
        (mc, uc, lr), (mp, up, _) = run(name, "cuda"), run(name, "cpu")
        over = max(abs(mc[k] - mp[k]) - 1e-5 * abs(mp[k]) for k in mp)
        err = max(float((a - b).abs().max()) for a, b in zip(uc, up))
        moved = max(float(b.abs().max()) for b in up)
        rows[name] = dict(
            max_metric_abs_err=max(abs(mc[k] - mp[k]) for k in mp),
            max_update_err=err, limit=0.05 * lr, max_update=moved)
        check(over <= 1e-6 and err <= 0.05 * lr and moved > 0,
              f"rl_offline_parity {name}: {rows[name]}")
    emit("rl_offline_parity", learners=rows)


ES_MAX_CALLS, ARS_MAX_CALLS, ES_TARGET = 30, 35, 150.0
ES_TIMED_CALLS, BANDIT_ITERS = 3, 15


def _es_config(cfg, seed: int, **settings):
    """CartPole-v1, 2 workers of the in-process runtime, the card."""
    cfg = (cfg.environment("CartPole-v1")
           .rollouts(num_rollout_workers=2)
           .resources(runtime=_InlineRuntime()).debugging(seed=seed))
    for k, v in settings.items():
        setattr(cfg, k, v)
    return cfg.build()


def _to_gate(algo, max_calls: int) -> dict:
    """train() until episode_reward_mean > ES_TARGET: calls, best, the
    curve, ms per call and env frames/s."""
    best, curve = -math.inf, []
    t0 = time.perf_counter()
    for _ in range(max_calls):
        r = algo.train()
        curve.append(r["episode_reward_mean"])
        best = max(best, r["episode_reward_mean"])
        if best > ES_TARGET:
            break
    wall = time.perf_counter() - t0
    return dict(calls=len(curve), best=best, target=ES_TARGET,
                reward_curve=curve, ms_per_train_call=wall / len(curve) * 1e3,
                env_frames_per_s=r["timesteps_total"] / wall)


def _eval_profile(worker, theta, seeds, sigma) -> dict:
    """One worker's evaluate under _Profiled: per env step its host ms,
    device ms, launches and batched products (aten::baddbmm)."""
    steps = []

    def run():
        steps.append(int(worker.evaluate(theta, seeds, sigma)["lengths"]
                         .max()))
    prof = _Profiled(run, n=2)
    n = steps[-1]
    return dict(lanes=2 * len(seeds), steps_per_evaluate=n,
                step_host_ms=prof.host_ms / n,
                step_device_ms=prof.device_ms / n,
                launches_per_step=prof.launches / n,
                products_per_step=prof.ops.get("aten::baddbmm", 0) / n,
                busy_share=prof.busy)


def _near_oracle(algo) -> tuple:
    """tests/test_rllib.py's bandit gate: 50 fresh batches of contexts;
    (oracle, random, chosen) mean expected reward."""
    import numpy as np

    env = algo.env
    oracle, rnd, mine = [], [], []
    for _ in range(50):
        exp = env.expected_rewards()
        oracle.append(exp.max(-1).mean())
        rnd.append(exp.mean())
        arms = algo.compute_actions(algo._obs)
        mine.append(exp[np.arange(exp.shape[0]), arms].mean())
        algo._obs, _, _, _ = env.step(arms)
    return tuple(float(np.mean(x)) for x in (oracle, rnd, mine))


def phase_rl_es() -> None:
    """ES and ARS on CartPole-v1 at the reference's learning tests'
    configs (tests/test_rllib.py: ES 24 directions, horizon 300, sigma
    0.08, lr 0.05, seed 0, up to 30 calls; ARS 16 directions, top 8,
    sigma 0.1, seed 1, up to 35 calls), 2 evaluation workers of the
    in-process runtime, the population forward on the card: each must
    pass 150; ES's checkpoint restores theta bit for bit, ARS's filter
    must have seen > 1000 observations.  ES at ESConfig's defaults (32
    directions, 64 lanes over 2 workers, hidden (32, 32), horizon 500):
    3 timed train() calls and one worker's evaluate profiled (launches
    and batched products per env step, busy share).  LinUCB and LinTS at
    their defaults on the card: 15 calls, then the near-oracle gate."""
    import numpy as np

    from ray_tpu_torch.rllib import (ARSConfig, ESConfig, LinTSConfig,
                                     LinUCBConfig)

    algo = _es_config(ESConfig(), 0, episodes_per_batch=24,
                      episode_horizon=300, noise_stdev=0.08, lr=0.05)
    es = _to_gate(algo, ES_MAX_CALLS)
    ckpt = algo.save()
    theta = algo.theta.copy()
    algo.train()
    algo.restore(ckpt)
    es["restore_bit_equal"] = bool((algo.theta == theta).all()
                                   and algo.theta.dtype == theta.dtype)
    algo.stop()
    emit("rl_es", algo="ES", config="tests/test_rllib.py:751", **es)
    check(es["best"] > ES_TARGET, f"rl_es: ES reached only {es['best']}")
    check(es["restore_bit_equal"], "rl_es: ES restore changed theta")

    algo = _es_config(ARSConfig(), 1, episodes_per_batch=16,
                      top_directions=8, episode_horizon=300,
                      noise_stdev=0.1, lr=0.05)
    ars = _to_gate(algo, ARS_MAX_CALLS)
    ars["obs_n"] = float(algo._obs_n)
    algo.stop()
    emit("rl_es", algo="ARS", config="tests/test_rllib.py:782", **ars)
    check(ars["best"] > ES_TARGET, f"rl_es: ARS reached only {ars['best']}")
    check(ars["obs_n"] > 1000, f"rl_es: ARS filter saw {ars['obs_n']}")

    algo = _es_config(ESConfig(), 0)
    warm = algo.train()["timesteps_total"]
    times = []
    for _ in range(ES_TIMED_CALLS):
        t0 = time.perf_counter()
        r = algo.train()
        times.append(time.perf_counter() - t0)
    frames = r["timesteps_total"] - warm
    worker = algo.workers[0].obj
    seeds = [int(s) for s in np.random.default_rng(0).integers(
        0, 2 ** 31 - 1, size=algo.config.episodes_per_batch // 2)]
    evals = _eval_profile(worker, algo.theta, seeds,
                          algo.config.noise_stdev)
    layers = len(algo.config.model_hidden) + 1
    algo.stop()
    emit("rl_es", algo="ES", config="ESConfig defaults",
         directions=algo.config.episodes_per_batch,
         lanes=2 * algo.config.episodes_per_batch,
         ms_per_train_call=[t * 1e3 for t in times],
         env_frames_per_s=frames / sum(times), frames=frames,
         evaluate=evals,
         episode_reward_mean=r["episode_reward_mean"])
    check(evals["products_per_step"] == layers,
          f"rl_es: {evals['products_per_step']} batched products per step "
          f"for {layers} layers")

    # The reference tests' seeds and gates (tests/test_rllib.py:810, :847).
    for name, cfg, seed, share in (("LinUCB", LinUCBConfig(), 7, 0.7),
                                   ("LinTS", LinTSConfig(), 11, 0.6)):
        algo = cfg.debugging(seed=seed).build()
        t0 = time.perf_counter()
        for _ in range(BANDIT_ITERS):
            algo.train()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / BANDIT_ITERS * 1e3
        prof = _Profiled(algo.train, n=2)
        oracle, rnd, mine = _near_oracle(algo)
        algo.stop()
        emit("rl_es", algo=name, config=f"{name}Config defaults",
             ms_per_train_call=ms, oracle=oracle, random=rnd, chosen=mine,
             gate=rnd + share * (oracle - rnd), **prof.fields("train"))
        check(mine > rnd + share * (oracle - rnd),
              f"rl_es: {name} chose {mine} (random {rnd}, oracle {oracle})")


def phase_rl_es_parity() -> None:
    """f32 with TF32 off, the card against the CPU: one ES evaluate on
    the same theta and seeds (CartPole-v1, 24 directions, hidden (32,
    32)) gives the same returns and lengths, every step's forward within
    1e-5; LinUCB makes the same arms for 3 calls, A_inv and b within
    1e-12."""
    import numpy as np

    from ray_tpu_torch.rllib import LinUCBConfig
    from ray_tpu_torch.rllib import es as pes

    _f32_exact()
    outs = {"cuda": [], "cpu": []}
    forward = pes.population_forward
    theta = pes._init_flat(4, (32, 32), 2, seed=0)
    seeds = [int(s) for s in
             np.random.default_rng(0).integers(0, 2 ** 31 - 1, size=24)]
    res = {}
    try:
        for dev in ("cuda", "cpu"):
            pes.population_forward = (
                lambda layers, x, out=outs[dev]:
                out.append(forward(layers, x).cpu()) or out[-1])
            res[dev] = pes.EvalWorker("CartPole-v1", (32, 32), 7919, 500,
                                      device=dev).evaluate(theta, seeds, 0.08)
    finally:
        pes.population_forward = forward
    same = all(np.array_equal(res["cuda"][k], res["cpu"][k])
               for k in ("r_plus", "r_minus", "lengths", "obs_n"))
    fwd_err = max(float((a - b).abs().max())
                  for a, b in zip(outs["cuda"], outs["cpu"]))
    steps = (len(outs["cuda"]), len(outs["cpu"]))

    arms, algos = {}, {}
    for dev in ("cuda", "cpu"):
        algo = algos[dev] = (LinUCBConfig().resources(device=dev)
                             .debugging(seed=7).build())
        chosen, choose = arms.setdefault(dev, []), algo._choose
        algo._choose = lambda obs, c=choose, out=chosen: (
            out.append(c(obs)) or out[-1])
        for _ in range(3):
            algo.train()
    arms_same = all(np.array_equal(a, b)
                    for a, b in zip(arms["cuda"], arms["cpu"]))
    state = {k: float(np.abs(algos["cuda"].save_to_dict()[k]
                             - algos["cpu"].save_to_dict()[k]).max())
             for k in ("A_inv", "b")}
    emit("rl_es_parity", evaluate_equal=same, forward_max_abs_err=fwd_err,
         steps=steps, bandit_arms_equal=arms_same,
         bandit_decisions=len(arms["cuda"]) * 16, bandit_state_err=state)
    check(same and steps[0] == steps[1],
          f"rl_es_parity: evaluate differs ({steps})")
    check(fwd_err <= 1e-5, f"rl_es_parity: forward error {fwd_err}")
    check(arms_same, "rl_es_parity: LinUCB arms differ")
    check(max(state.values()) <= 1e-12, f"rl_es_parity: state {state}")


# ---------------------------------------------------------------- pipeline

class _PumpRuntime:
    """The runtime calls the MPMD pipeline pump makes (the module
    docstring of ray_tpu_torch/train/pipeline_stage.py), run in this
    process: an actor method runs when it is called, on the caller's
    thread, so every gang shares one thread and one card; its refs hold
    the result, or the error of a dead actor or a method that raised.
    `wait` hands back refs in order (all are done), `prefetch` runs in
    line, and placement groups reserve nothing.  `kill_when(ordinal,
    name, args)`, asked before each actor call, kills that actor
    (ordinal: 1-based creation order) the way a lost worker dies: the
    call and every later one fail with ActorDiedError, and the actor's
    state (its graphs, banked gradients and params) is dropped."""

    class ObjectRef:
        def __init__(self, value=None, error=None):
            self.value, self.error = value, error

    class exceptions:
        class RayTpuError(Exception):
            pass

        class RayTpuTimeoutError(RayTpuError, TimeoutError):
            pass

        class TaskError(RayTpuError):
            pass

        class WorkerCrashedError(RayTpuError):
            pass

        class ActorError(RayTpuError):
            pass

        class ActorDiedError(ActorError):
            pass

        class ObjectLostError(RayTpuError):
            pass

    class util:
        class _Reservation:
            @staticmethod
            def wait(timeout=None):
                return True

        @staticmethod
        def placement_group(bundles, strategy="PACK"):
            return _PumpRuntime.util._Reservation()

        @staticmethod
        def remove_placement_group(pg):
            pass

    class Actor:
        def __init__(self, rt, obj, ordinal):
            self.rt, self.obj, self.ordinal = rt, obj, ordinal

        def __getattr__(self, name):
            return _PumpRuntime.Method(self, name, 1)

    class Method:
        def __init__(self, actor, name, num_returns):
            self.actor, self.name, self.n = actor, name, num_returns

        def options(self, num_returns=1, **_):
            return _PumpRuntime.Method(self.actor, self.name, num_returns)

        def remote(self, *args):
            return self.actor.rt._call(self.actor, self.name, args, self.n)

    def __init__(self, kill_when=None):
        self.kill_when = kill_when
        self.created = 0
        self.killed: list = []

    def remote(self, **_):
        rt = self

        def bind(cls):
            class Bound:
                @staticmethod
                def options(**_):
                    return Bound

                @staticmethod
                def remote(*args, **kwargs):
                    rt.created += 1
                    return rt.Actor(rt, cls(*args, **kwargs), rt.created)
            return Bound
        return bind

    def _refs(self, n, values=None, error=None):
        if n == 1:
            return self.ObjectRef(values, error)
        return tuple(self.ObjectRef(None if values is None else v, error)
                     for v in (values if values is not None else [None] * n))

    def _call(self, actor, name, args, n):
        if actor.obj is not None and self.kill_when is not None \
                and self.kill_when(actor.ordinal, name, args):
            self.killed.append((actor.ordinal, name, args[:3]))
            self.kill(actor)
        if actor.obj is None:
            return self._refs(n, error=self.exceptions.ActorDiedError(
                f"actor {actor.ordinal} is dead ({name})"))
        try:
            args = [self.get(a) if isinstance(a, self.ObjectRef) else a
                    for a in args]
            return self._refs(n, getattr(actor.obj, name)(*args))
        except Exception as e:
            err = self.exceptions.TaskError(f"{name}: {e!r}")
            err.__cause__ = e
            return self._refs(n, error=err)

    def get(self, refs, timeout=None):
        if isinstance(refs, list):
            return [self.get(r) for r in refs]
        if refs.error is not None:
            raise refs.error
        return refs.value

    def wait(self, refs, num_returns=1, timeout=None):
        return list(refs[:num_returns]), list(refs[num_returns:])

    def put(self, value):
        return self.ObjectRef(value)

    def kill(self, actor):
        actor.obj = None


# gpt2-small in four stage-chunks: the embeddings and blocks 0-2, blocks
# 3-5, 6-8, then 9-11 with the final LayerNorm and the (untied) head.
PP_BOUNDS = ((0, 3), (3, 6), (6, 9), (9, 12))
PP_MICRO, PP_MICRO_BATCH, PP_SEQ = 6, 4, 1024
PP_STEPS, PP_LR = 4, 0.1               # one warm-up step, then 3 timed
# (a)-(d) against the single-program step from the same weights and
# batch: the first loss within 1e-3 relative, and each leaf's first
# update within 2**-5 of its largest.  Both run bf16 activations; the
# pipeline's weight gradients are rounded to bf16 once per microbatch
# and summed, the single program's once over the batch, and the loss's
# bf16 dlogits carry another scale (1 / (4 x 1023) against
# 1 / (24 x 1023)), so the two part by a few bf16 ulps of a gradient.
PP_LOSS_TOL, PP_UPDATE_TOL = 1e-3, 2 ** -5
# (d): gang 1 dies as its backward for microbatch 2 of step 2 is sent.
PP_KILL = dict(ordinal=2, method="backward", step=2, mb=2)


def _gpt_chunk_params(params: dict, bounds) -> list:
    """One param tree per stage-chunk: chunk c holds blocks
    bounds[c][0]:bounds[c][1] (views of the stacked leaves), chunk 0
    also the embeddings, the last chunk the final LayerNorm and the
    head."""
    last = len(bounds) - 1
    chunks = []
    for c, (lo, hi) in enumerate(bounds):
        p = {}
        if c == 0:
            p["tok_embed"], p["pos_embed"] = (params["tok_embed"],
                                              params["pos_embed"])
        if hi > lo:
            p["blocks"] = {k: v[lo:hi] for k, v in params["blocks"].items()}
        if c == last:
            p.update(final_ln_scale=params["final_ln_scale"],
                     final_ln_bias=params["final_ln_bias"],
                     lm_head=params["lm_head"])
        chunks.append(p)
    return chunks


def _gpt_join(chunks: list) -> dict:
    """The chunks' params as one gpt param tree (blocks concatenated)."""
    params = {k: v for p in chunks for k, v in p.items() if k != "blocks"}
    blocks = [p["blocks"] for p in chunks if "blocks" in p]
    params["blocks"] = {k: torch.cat([b[k] for b in blocks])
                        for k in blocks[0]}
    return params


def _gpt_stage_fns(config, device):
    """The stage quartet of the four-chunk gpt: a chunk embeds the
    tokens (chunk 0) or casts the f32 it receives back to the
    activation dtype (exact for bf16), runs its blocks through
    `gpt._block`, and the last chunk hands the loss (final LayerNorm
    output, head); the loss is `fused_cross_entropy` on the rolled
    tokens with the last position masked, as `gpt.loss_fn` computes
    it."""
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.ops.cross_entropy import fused_cross_entropy
    from ray_tpu_torch.train import torch_stage_fns

    c = config

    def stage_fn(p, x):
        if "tok_embed" in p:
            x = p["tok_embed"][x.long()].to(c.dtype) + \
                p["pos_embed"][:x.shape[1]][None].to(c.dtype)
        else:
            x = x.to(c.dtype)
        if "blocks" in p:
            layers = {k: v.unbind(0) for k, v in p["blocks"].items()}
            for i in range(len(layers["wq"])):
                x, _ = gpt._block(x, {k: v[i] for k, v in layers.items()},
                                  c)
        if "lm_head" in p:
            return (gpt._layernorm(x, p["final_ln_scale"],
                                   p["final_ln_bias"]),
                    p["lm_head"].to(c.dtype))
        return x

    def loss_fn(y, tokens):
        x, head = y
        targets = torch.roll(tokens, -1, dims=1)
        valid = torch.ones(tokens.shape, dtype=torch.float32,
                           device=tokens.device)
        valid[:, -1] = 0.0
        b, l, d = x.shape
        return fused_cross_entropy(x.reshape(b * l, d), head,
                                   targets.reshape(-1), valid.reshape(-1))

    return torch_stage_fns(stage_fn, loss_fn, device=device)


def _pp_data(n_micro: int, batch: int, seq: int, vocab: int):
    """data_fn(step): n_micro microbatches of random tokens from a seed
    per step; the targets are the tokens (the loss rolls them)."""
    import numpy as np

    def data_fn(step):
        rng = np.random.default_rng(7000 + step)
        xs = [rng.integers(0, vocab, (batch, seq)) for _ in range(n_micro)]
        return xs, xs
    return data_fn


def _actor_params(trainer) -> list:
    """Every chunk's params, read from the gangs' leaders (the in-process
    runtime's actors), in chunk order."""
    out = {}
    for grp in trainer.groups:
        out.update(grp.members[0].obj.params)
    return [out[c] for c in sorted(out)]


def _flash_launches() -> dict:
    from ray_tpu_torch.ops import attention as A
    return {fn.__name__: fn.launches
            for fn in (A.flash_forward, A.flash_dq, A.flash_dkv)}


def _zero_flash_launches() -> None:
    from ray_tpu_torch.ops import attention as A
    for fn in (A.flash_forward, A.flash_dq, A.flash_dkv):
        fn.launches = 0


class _CrossingMeter:
    """Times what crosses a chunk boundary: the producer's copy to a
    numpy array (`pipeline_stage.to_host`, after a synchronize, so only
    the cast and the copy are timed) and the consumer's copy of a
    floating array back to the card (`pipeline_trainer._leaf`), with
    their bytes.  Installed around one step, then taken out."""

    def __init__(self):
        from ray_tpu_torch.train import pipeline_stage, pipeline_trainer

        self.mods = (pipeline_stage, pipeline_trainer)
        self.orig = (pipeline_stage.to_host, pipeline_trainer._leaf)
        self.d2h_bytes = self.h2d_bytes = 0
        self.d2h_s = self.h2d_s = 0.0
        self.copies = 0

    def __enter__(self):
        import numpy as np

        to_host, leaf = self.orig

        def timed_to_host(x):
            if not isinstance(x, torch.Tensor):
                return to_host(x)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = to_host(x)
            self.d2h_s += time.perf_counter() - t0
            self.d2h_bytes += out.nbytes
            self.copies += 1
            return out

        def timed_leaf(x, device, grad):
            if not (isinstance(x, np.ndarray) and x.dtype.kind == "f"
                    and torch.device(device).type == "cuda"):
                return leaf(x, device, grad)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = leaf(x, device, grad)
            torch.cuda.synchronize()
            self.h2d_s += time.perf_counter() - t0
            self.h2d_bytes += x.nbytes
            return out

        self.mods[0].to_host = timed_to_host
        self.mods[1]._leaf = timed_leaf
        return self

    def __exit__(self, *exc):
        self.mods[0].to_host, self.mods[1]._leaf = self.orig


def _pp_fit(fns, chunks, data_fn, steps, *, runtime, meter_last=False,
            **kw) -> dict:
    """PipelineTrainer over `chunks` on `runtime`: `steps` steps, the
    first a warm-up.  The flash counts are set to 0 and the clock
    started once step 0 is done (data_fn asks for step 1's batch then)
    and read when the last timed step is done; with `meter_last` one
    more step runs after that under a _CrossingMeter.  Returns the
    losses, the params after step 0 and at the end of the timed steps,
    ms a step, launches, peak memory and the pump's bubble fractions."""
    from ray_tpu_torch.train import PipelineTrainer

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out: dict = {}
    meter = _CrossingMeter() if meter_last else None

    def stop():
        out["seconds"] = time.perf_counter() - out["t1"]
        out["launches"] = _flash_launches()
        out["final"] = _clone(_actor_params(tr))

    def fed(step):
        if step in (1, steps):
            torch.cuda.synchronize()
            if step == 1:
                out["after_one"] = _clone(_actor_params(tr))
                _zero_flash_launches()
                out["t1"] = time.perf_counter()
            else:
                stop()
                meter.__enter__()
        return data_fn(step)

    tr = PipelineTrainer(fns, chunks, runtime=runtime, lr=PP_LR, **kw)
    try:
        hist = tr.fit(fed, steps + (meter is not None))
        torch.cuda.synchronize()
        if meter is None:
            stop()
        recoveries = tr._recoveries
    finally:
        if meter is not None:
            meter.__exit__()
        tr.shutdown()
    timed = steps - 1
    return dict(losses=[h["loss"] for h in hist[:steps]],
                after_one=out["after_one"], final=out["final"],
                step_ms=out["seconds"] / timed * 1e3,
                launches=out["launches"], timed_steps=timed,
                peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                bubble_fraction=[h["bubble_fraction"] for h in hist],
                recoveries=recoveries, meter=meter)


def _flat_items(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat_items(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


def _clone(chunks: list) -> list:
    from ray_tpu_torch.models import gpt
    return [gpt._map(p, lambda t: t.detach().clone()) for p in chunks]


def _bit_equal(a: list, b: list) -> bool:
    return all(torch.equal(x, y) for pa, pb in zip(a, b)
               for x, y in zip(_tree_leaves(pa), _tree_leaves(pb)))


def _update_errors(start: dict, got: dict, want: dict) -> tuple:
    """Per leaf, max |(got - start) - (want - start)| over
    max |want - start|; returns (worst, its leaf)."""
    worst, where = 0.0, None
    s, g, w = (dict(_flat_items(t)) for t in (start, got, want))
    for k in w:
        dw = (w[k] - s[k]).float()
        dg = (g[k] - s[k]).float()
        rel = float((dg - dw).abs().max() / dw.abs().max().clamp_min(1e-30))
        if rel >= worst:
            worst, where = rel, k
    return worst, where


def _single_program_sgd(params: dict, config, tokens, steps: int) -> dict:
    """The port's single-program step on the same weights and batch:
    `gpt.loss_fn` (the untied config) and SGD with PP_LR.  Returns the
    first loss, the params after one step and ms a step over the steps
    after the first."""
    from ray_tpu_torch.models import gpt

    p = gpt._map(params, lambda t: t.detach().clone().requires_grad_())
    leaves = _tree_leaves(p)
    losses = []
    after_one = None
    for step in range(steps):
        if step == 1:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        loss = gpt.loss_fn(p, {"tokens": tokens}, config)
        loss.backward()
        with torch.no_grad():
            for t in leaves:
                t.sub_(PP_LR * t.grad)
                t.grad = None
        losses.append(loss.detach())
        if step == 0:
            after_one = gpt._map(p, lambda t: t.detach().clone())
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / (steps - 1) * 1e3
    return dict(loss=float(losses[0]), after_one=after_one, step_ms=ms)


def phase_pipeline(report: dict) -> None:
    """gpt2-small (untied head), fp32 params, bf16 activations, in four
    stage-chunks through the port's PipelineTrainer on _PumpRuntime:
    6 microbatches of 4 x 1024 a step, SGD at PP_LR, one warm-up step
    and 3 timed.  (a) 1F1B over 4 gangs, (b) GPipe, (c) interleave=2
    with prefetch, (d) (a) with gang 1 killed in step 2 and replayed
    from its committed checkpoint: the same losses and params bit for
    bit.  Step 0 against the single-program SGD step on the same
    weights and batch; K1-K3 launched 12 x 6 times a pipelined step;
    one more step of (a) measures the chunk-boundary copies."""
    import dataclasses

    import numpy as np

    from ray_tpu_torch.models import gpt

    config = dataclasses.replace(gpt.CONFIGS["gpt2-small"],
                                 tie_embeddings=False)
    params = gpt.init_params(config, torch.Generator(
        device="cuda").manual_seed(13), device="cuda")
    chunks = _gpt_chunk_params(params, PP_BOUNDS)
    fns = _gpt_stage_fns(config, "cuda")
    data_fn = _pp_data(PP_MICRO, PP_MICRO_BATCH, PP_SEQ, config.vocab_size)

    runs = {"1f1b": _pp_fit(fns, chunks, data_fn, PP_STEPS,
                            runtime=_PumpRuntime(), meter_last=True,
                            n_microbatches=PP_MICRO)}
    runs["gpipe"] = _pp_fit(fns, chunks, data_fn, PP_STEPS,
                            runtime=_PumpRuntime(), n_microbatches=PP_MICRO,
                            schedule="gpipe")
    runs["interleave2_prefetch"] = _pp_fit(
        fns, chunks, data_fn, PP_STEPS, runtime=_PumpRuntime(),
        n_microbatches=PP_MICRO, interleave=2, prefetch=True)
    k = PP_KILL
    killer = _PumpRuntime(kill_when=lambda ordinal, name, args: (
        ordinal == k["ordinal"] and name == k["method"]
        and args[0] == k["step"] and args[2] == k["mb"]))
    with tempfile.TemporaryDirectory() as root:
        runs["1f1b_killed"] = _pp_fit(
            fns, chunks, data_fn, PP_STEPS, runtime=killer,
            n_microbatches=PP_MICRO, storage_path=root, ckpt_every=1)
    check(killer.killed and runs["1f1b_killed"]["recoveries"] == 1,
          f"pipeline: the kill {PP_KILL} did not happen or recover once "
          f"({killer.killed}, {runs['1f1b_killed']['recoveries']})")
    base = runs["1f1b"]
    for name, run in runs.items():
        check(run["losses"] == base["losses"],
              f"pipeline {name}: losses {run['losses']} != 1f1b's "
              f"{base['losses']}")
        check(_bit_equal(run["final"], base["final"]),
              f"pipeline {name}: final params differ from 1f1b's")
    check(all(math.isfinite(x) for x in base["losses"])
          and base["losses"][-1] < base["losses"][0],
          f"pipeline losses {base['losses']}")
    want = PP_MICRO * config.n_layers
    for name, n in base["launches"].items():
        check(n == want * base["timed_steps"],
              f"pipeline: {name} launched {n} times in "
              f"{base['timed_steps']} steps, want {want} a step")

    xs, _ = data_fn(0)
    tokens = torch.from_numpy(np.concatenate(xs)).cuda()
    single = _single_program_sgd(params, config, tokens, PP_STEPS)
    loss_rel = abs(base["losses"][0] - single["loss"]) / abs(single["loss"])
    start = _gpt_join(_gpt_chunk_params(params, PP_BOUNDS))
    pipe_one = _gpt_join(base["after_one"])
    upd_err, upd_leaf = _update_errors(start, pipe_one, single["after_one"])
    check(loss_rel <= PP_LOSS_TOL,
          f"pipeline step 0 loss {base['losses'][0]} vs single program "
          f"{single['loss']} (rel {loss_rel})")
    check(upd_err <= PP_UPDATE_TOL,
          f"pipeline step 0 update of {upd_leaf} vs single program: "
          f"{upd_err} of its largest")

    meter = base["meter"]
    for name, n in base["launches"].items():
        entry = report.setdefault(name, {}).setdefault("pipeline", {})
        entry.update(launches=n, launches_per_step=n // base["timed_steps"],
                     timed_steps=base["timed_steps"])
    emit("pipeline", config="gpt2-small, tie_embeddings=False",
         chunks=[list(b) for b in PP_BOUNDS], n_microbatches=PP_MICRO,
         micro_batch=[PP_MICRO_BATCH, PP_SEQ], lr=PP_LR,
         timed_steps=base["timed_steps"],
         step_ms={name: run["step_ms"] for name, run in runs.items()},
         single_program_sgd_step_ms=single["step_ms"],
         losses=base["losses"], single_program_loss=single["loss"],
         loss_rel_err=loss_rel, loss_tolerance=PP_LOSS_TOL,
         max_update_err_of_leaf_max=upd_err, worst_leaf=upd_leaf,
         update_tolerance=PP_UPDATE_TOL, bit_equal_across_runs=True,
         kill=dict(PP_KILL, at=[list(map(str, c)) for c in killer.killed],
                   recoveries=runs["1f1b_killed"]["recoveries"]),
         crossing=dict(d2h_bytes=meter.d2h_bytes, d2h_ms=meter.d2h_s * 1e3,
                       h2d_bytes=meter.h2d_bytes, h2d_ms=meter.h2d_s * 1e3,
                       copies=meter.copies,
                       note="one step of (a), each copy after a "
                            "synchronize"),
         bubble_fraction={name: run["bubble_fraction"]
                          for name, run in runs.items()},
         bubble_note="every gang shares one thread and one card here: "
                     "1 - busy / (gangs x wall), not a pipeline's bubble",
         peak_memory_gib={name: run["peak_memory_gib"]
                          for name, run in runs.items()},
         flash_launches_per_step={n: v // base["timed_steps"]
                                  for n, v in base["launches"].items()})


# gpt2-small widths at 2 layers in four chunks: the embeddings; block 0;
# block 1; the final LayerNorm and the head.
PP_PARITY_BOUNDS = ((0, 0), (0, 1), (1, 2), (2, 2))


def phase_pipeline_parity() -> None:
    """gpt2-small widths at 2 layers in f32 (TF32 off), untied, in four
    chunks through PipelineTrainer on _PumpRuntime: 2 microbatches of
    2 x 256 a step, 2 steps, on the card (K1-K3, counted) and on the CPU
    (their plain versions).  The losses within 1e-4 relative; each
    leaf's update within GRAD_TOLERANCE of its largest after the first
    step (train_parity's bound on one gradient) and within twice that
    after the second (two gradients, the second taken at params that
    already differ)."""
    import dataclasses

    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.train import PipelineTrainer

    _f32_exact()
    config = dataclasses.replace(gpt.CONFIGS["gpt2-small"], n_layers=2,
                                 dtype=torch.float32, tie_embeddings=False)
    params = gpt.init_params(config, torch.Generator().manual_seed(8),
                             device="cpu")
    data_fn = _pp_data(2, 2, 256, config.vocab_size)
    out = {}
    for device in ("cuda", "cpu"):
        chunks = [gpt._map(p, lambda t: t.to(device))
                  for p in _gpt_chunk_params(params, PP_PARITY_BOUNDS)]
        _zero_flash_launches()
        tr = PipelineTrainer(_gpt_stage_fns(config, device), chunks,
                             runtime=_PumpRuntime(), lr=PP_LR,
                             n_microbatches=2)
        snaps = []

        def snapshot():
            # A copy: the CPU run's params are updated in place.
            snaps.append(_gpt_join([
                gpt._map(p, lambda t: t.to("cpu", copy=True))
                for p in _actor_params(tr)]))

        def fed(step):
            snapshot()
            return data_fn(step)
        try:
            losses = [h["loss"] for h in tr.fit(fed, 2)]
            snapshot()
        finally:
            tr.shutdown()
        out[device] = (losses, snaps, _flash_launches())
    (cuda_losses, cuda_snaps, launches), (cpu_losses, cpu_snaps, _) = \
        out["cuda"], out["cpu"]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(cuda_losses,
                                                       cpu_losses))
    start = cpu_snaps[0]
    errs = [_update_errors(start, cuda_snaps[s], cpu_snaps[s]) + (
        s * GRAD_TOLERANCE,) for s in (1, 2)]
    emit("pipeline_parity", config="gpt2-small widths, 2 layers, float32",
         chunks=[list(b) for b in PP_PARITY_BOUNDS], n_microbatches=2,
         micro_batch=[2, 256], steps=2, losses_cuda=cuda_losses,
         losses_cpu=cpu_losses, loss_rel_err=loss_rel,
         update_err_of_leaf_max=[dict(after_steps=s, err=e, leaf=leaf,
                                      tolerance=tol)
                                 for s, (e, leaf, tol) in zip((1, 2), errs)],
         flash_launches=launches)
    check(loss_rel <= 1e-4, f"pipeline_parity losses CUDA {cuda_losses} vs "
                            f"CPU {cpu_losses}")
    for s, (err, leaf, tol) in zip((1, 2), errs):
        check(err <= tol, f"pipeline_parity update of {leaf} after {s} "
                          f"steps: CUDA vs CPU {err} of its largest")
    for name, n in launches.items():
        check(n == 2 * 2 * config.n_layers,
              f"pipeline_parity: {name} launched {n} times, want "
              f"{2 * 2 * config.n_layers}")


# The mesh phases: ranks spawned by the port's launcher, each on card 0
# over gloo (or one card each over NCCL where there are enough).  One
# RankGang at a time stays up across phases (`_ranks`), so a phase that
# runs on as many ranks as the one before it starts none.
MESH_TIMEOUT_S = 420


class _Gang:
    """`_ranks(world)`: the RankGang of `world` ranks on the card,
    started on first use; a gang of another size (or a closed one) is
    ended first.  `_ranks.close()` ends it."""

    def __init__(self):
        self._stack = contextlib.ExitStack()
        self._gang = None

    def __call__(self, world: int):
        from ray_tpu_torch.parallel.launch import RankGang

        if self._gang is not None and (self._gang.closed
                                       or self._gang.world_size != world):
            self.close()
        if self._gang is None:
            init_dir = self._stack.enter_context(
                tempfile.TemporaryDirectory(prefix="chip_smoke_ranks-"))
            self._gang = self._stack.enter_context(RankGang(
                world, device="cuda", init_dir=init_dir,
                timeout_s=MESH_TIMEOUT_S))
        return self._gang

    def close(self) -> None:
        self._gang = None
        self._stack.close()


_ranks = _Gang()


MESH_LR = 1e-4
# Each rank against the single-device run on the same weights and
# batches, bf16: its losses (the three steps' and one more step's on
# the last batch, the first that sees the third update) within
# MESH_LOSS_TOL, and each leaf's update (final - start) on its shard
# within MESH_UPDATE_TOL of the single device's in L2 norm.  Set from
# the sound runs' readings and those of the same runs with a fault
# injected (scripts/mesh_controls.py; both in PERF.md): the limits sit
# above the first and below the second.
MESH_LOSS_TOL = 3e-3
MESH_UPDATE_TOL = 0.35


def _seed0(generator: str) -> torch.Generator:
    """The init's generator seeded 0: on the CPU (the tests' stream) or
    on the current card ("cuda"), which the ranks of a mesh use alike."""
    return torch.Generator(generator).manual_seed(0)


def _single_reference(family: str, config, batches: list, path: str,
                      grads: bool = False, generator: str = "cpu") -> tuple:
    """The port's single-device train step on the card from the family's
    init on seed 0 (a generator on `generator`), one AdamW(MESH_LR) step
    per batch and one more on the last: (its losses, the host seconds of
    its parts); its start and final params (after the batches) saved to
    `path`, with `grads` its first step's gradients too ("grad"), as
    `rank_bodies.train` reads them."""
    from ray_tpu_torch.models import gpt, llama
    from ray_tpu_torch.models._functional import adamw
    from ray_tpu_torch.parallel import rank_bodies

    model = {"gpt": gpt, "llama": llama}[family]

    def host(params):
        return {k: v.detach().cpu().clone()
                for k, v in rank_bodies._flat(params).items()}

    seconds, lap = {}, time.perf_counter()

    def clock(name):
        nonlocal lap
        now = time.perf_counter()
        seconds[name] = now - lap
        lap = now

    gc.collect()
    torch.cuda.empty_cache()
    clock("collect")
    init_state, train_step = model.make_train_step(config, adamw(MESH_LR),
                                                   device="cuda")
    state = init_state(_seed0(generator))
    clock("init")
    saved = {"start": host(state["params"])}
    single = []
    for b in batches + batches[-1:]:
        if len(single) == len(batches):
            saved["final"] = host(state["params"])
        state, metrics = train_step(state, {"tokens": torch.from_numpy(b)})
        single.append(float(metrics["loss"]))
        if grads and "grad" not in saved:
            saved["grad"] = {k: v.grad.detach().cpu().clone() for k, v in
                             rank_bodies._flat(state["params"]).items()}
    clock("steps")
    del state, init_state, train_step
    torch.save(saved, path)
    clock("save")
    del saved
    gc.collect()
    torch.cuda.empty_cache()
    clock("collect_after")
    return single, seconds


def _mesh_run(family: str, config, sizes: dict, batches: list,
              control=None, ring=None, digest: bool = False,
              grad_controls: tuple = (), reference=None,
              generator: str = "cpu") -> dict:
    """`rank_bodies.train` on every rank of a `sizes` mesh (with
    `control`, a fault injected there), against the port's single-device
    train step on the card from the same weights on the same global
    batches (`_single_reference`, or `reference` made already), its
    params handed to the ranks in a file.  With
    `ring` (a global [B, L, H, D]), the ranks first run
    `rank_bodies.ring` on bf16 inputs of that shape, held by
    `_ring_check`.  With `digest`, each rank also hands back a sha256 of
    its params' shards (replicas must agree to the bit).  With
    `grad_controls` (the reference made with its first gradients), each
    rank reads its first summed gradients against one device's
    (`max_grad_rel_err`), and those of each control named
    (`grad_controls_read`).  `reference` is `_single_reference`'s
    result and its path.  `generator` is where both sides draw the
    seed-0 init.  Returns the readings; `_mesh_faults` judges them."""
    from ray_tpu_torch.parallel import rank_bodies
    from ray_tpu_torch.parallel.mesh import AXES

    world = math.prod(sizes.values())
    with tempfile.TemporaryDirectory() as tmp:
        if reference is None:
            path = os.path.join(tmp, "single.pt")
            reference = _single_reference(family, config, batches, path,
                                          bool(grad_controls),
                                          generator) + (path,)
        single, single_s, path = reference
        calls = [("train", (family, config, sizes, None, batches, MESH_LR,
                            "cuda", False, None, path, control, digest,
                            grad_controls, generator))]
        if ring is not None:
            calls.insert(0, ("ring", (sizes,) + _ring_inputs(ring)
                             + (True, "cuda", "bfloat16")))
        t0 = time.perf_counter()
        ranks = _ranks(world).run(rank_bodies.sequence, calls)
        wall_s = time.perf_counter() - t0
    ring_check = None if ring is None else _ring_check(
        ring, [r[0] for r in ranks])
    ranks = [r[-1] for r in ranks]
    controls_read = {c: _max_grad_err(ranks, c) for c in grad_controls}
    loss_diff = max(abs(a - b) for r in ranks
                    for a, b in zip(r["losses"] + [r["final_loss"]], single))
    update_err, update_leaf = max(
        (err, f"rank {rank} {leaf}") for rank, r in enumerate(ranks)
        for leaf, err in r["update_rel_err"].items())
    shares = [r["collectives"]["share"] for r in ranks]
    return dict(
        mesh=sizes, ranks=world, control=control,
        backend=ranks[0]["backend"], devices=torch.cuda.device_count(),
        global_batch=list(batches[0].shape), steps=len(batches),
        lr=MESH_LR, losses=ranks[0]["losses"] + [ranks[0]["final_loss"]],
        single_device_losses=single, max_loss_diff=loss_diff,
        loss_tolerance=MESH_LOSS_TOL, max_update_rel_err=update_err,
        max_update_rel_err_at=update_leaf,
        update_tolerance=MESH_UPDATE_TOL,
        constraint_round_trip=all(r["constraint_round_trip"]
                                  for r in ranks),
        median_step_ms=statistics.median(r["median_step_ms"]
                                         for r in ranks),
        step_ms_by_rank=[r["median_step_ms"] for r in ranks],
        collective_share_median=statistics.median(shares),
        collective_share_by_rank=shares,
        collectives_rank0=ranks[0]["collectives"],
        peak_memory_gib_by_rank=[r["peak_memory_gib"] for r in ranks],
        launches_by_rank=[r["launches"] for r in ranks],
        layer_gathers_by_rank=[_layer_ops(r["collectives"]) for r in ranks],
        init_seconds_by_rank=[r["init_seconds"] for r in ranks],
        host_rss_gib_by_rank=[r["host_rss_gib"] for r in ranks],
        grad_digest_by_rank=[r.get("grad_digest") for r in ranks],
        seq_rank_by_rank=[r["coordinate"][AXES.index("seq")]
                          for r in ranks],
        coordinate_by_rank=[dict(zip(AXES, r["coordinate"]))
                            for r in ranks],
        losses_by_rank=[r["losses"] + [r["final_loss"]] for r in ranks],
        digest_by_rank=[r.get("params_digest") for r in ranks],
        real_rows_by_rank=[r["real_rows"] for r in ranks],
        max_grad_rel_err=_max_grad_err(ranks) if grad_controls else None,
        grad_controls_read=controls_read,
        ring_check=ring_check,
        ranks_wall_s=wall_s, single_device_seconds=single_s,
        rank0_host_seconds=ranks[0]["host_seconds"],
        note=("ranks share card 0 over gloo: every collective passes "
              "through host memory" if ranks[0]["backend"] == "gloo" else
              "one card per rank over NCCL") + "; collective share from "
             "one extra step with a synchronize around each collective")


def _layer_ops(collectives: dict) -> dict:
    """The measured step's fsdp gathers of block leaves and their
    backward's reduce-scatters (calls, bytes and ms of each)."""
    return {op: collectives["by_op"].get(f"layer_{op}",
                                         {"calls": 0, "bytes": 0, "ms": 0.0})
            for op in ("all_gather", "reduce_scatter")}


def _max_grad_err(ranks: list, control=None) -> list:
    """[the largest first-step gradient error over the ranks' leaves
    (of the sound run, or of `control`'s), where]."""
    err, at = max((err, f"rank {rank} {leaf}")
                  for rank, r in enumerate(ranks)
                  for leaf, err in (r["grad_rel_err"] if control is None
                                    else r["grad_controls"][control]).items())
    return [err, at]


def _mesh_faults(out: dict, n_layers: int, remat: bool = False) -> list:
    """What `_mesh_run`'s readings fail of the mesh phases' checks (under
    `remat` K1 runs twice per layer, once more in the recompute)."""
    faults = []
    if not out["max_loss_diff"] <= MESH_LOSS_TOL:
        faults.append(f"losses {out['losses']} vs one device "
                      f"{out['single_device_losses']}: "
                      f"{out['max_loss_diff']} apart")
    if not out["max_update_rel_err"] <= MESH_UPDATE_TOL:
        faults.append(f"update of {out['max_update_rel_err_at']} "
                      f"{out['max_update_rel_err']} of one device's")
    if not out["constraint_round_trip"]:
        faults.append("with_logical_constraint's round trip differs")
    # Under the causal ring seq rank r attends r + 1 blocks of every
    # layer: K1, K2 and K3 once each per block (r = 0 off a seq axis).
    for rank, (launches, r) in enumerate(zip(out["launches_by_rank"],
                                             out["seq_rank_by_rank"])):
        for name, n in launches.items():
            want = out["steps"] * n_layers * (r + 1) * (
                2 if remat and name == "flash_forward" else 1)
            if n != want:
                faults.append(f"rank {rank} (seq rank {r}): {name} "
                              f"launched {n} times, want {want}")
    for what, used in ((out["ring_check"] or {}).get("used") or {}).items():
        if not used <= 1.0:
            faults.append(f"ring {what}: {used} of its tolerance")
    return faults


# The ring on the card (bf16, K1-K3 per block, partial outputs merged in
# f32) against flash attention (K1-K3) on the whole sequence on one
# device, and against the plain ring (the reference's block functions
# in f32 on the same bf16 values: the exact function), in units of
# `tensor_core_limit` of the plain ring's value, for out, dq, dk and dv:
# - against flash, within 3: one limit for each side's tensor-core
#   rounding, one for the ring's merge of partials that K1 (or K2, K3)
#   rounded to bf16 once each;
# - against the plain ring, no further than flash on one device is, plus
#   2 (the tensor cores and the merge).  Flash's own distance from the
#   exact gradients is not bounded by the limit: K2 and K3 take delta =
#   rowsum(dO * O) from O rounded to bf16 (the reference's residual),
#   which moves dq rows whose terms cancel (the CPU rehearsal at head
#   dim 64, with the kernels' plain versions, read up to 8 limits), and
#   the ring takes delta alike.
RING_TOLERANCE = {"plain": 2.0, "flash": 3.0}


def _ring_inputs(shape) -> tuple:
    import numpy as np

    rng = np.random.default_rng(15)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for _ in range(4))


def _ring_check(shape, results: list) -> dict:
    """Each rank's kernel ring (`results`, `rank_bodies.ring`'s) against
    its plain ring and against flash attention on the gathered
    sequence: the largest abs error and share of the limit used, per
    output."""
    from ray_tpu_torch.ops import attention as A

    q, k, v, dout = (torch.from_numpy(a).to("cuda", torch.bfloat16)
                     for a in _ring_inputs(shape))
    qkv = [t.requires_grad_() for t in (q, k, v)]
    o = A.flash_attention(*qkv, causal=True)
    whole = [t.float().cpu() for t in
             [o.detach()] + list(torch.autograd.grad(o, qkv, dout))]
    del q, k, v, dout, qkv, o
    torch.cuda.empty_cache()
    err: dict = {}
    used: dict = {}
    for r in results:
        index = tuple(slice(a, b) for a, b in r["index"])
        for i, what in enumerate(("O", "dq", "dk", "dv")):
            got = torch.from_numpy(r["kernel"][i])
            plain = torch.from_numpy(r["plain"][i])
            limit = A.tensor_core_limit(plain, what)
            flash = whole[i][index]
            for against, diff, over in (
                    ("flash", (got - flash).abs(), 0.0),
                    ("plain", (got - plain).abs(),
                     (flash - plain).abs())):
                key = f"{what} vs {against}"
                err[key] = max(err.get(key, 0.0), float(diff.max()))
                used[key] = max(used.get(key, 0.0), _share(
                    (diff - over).clamp_min(0.0),
                    RING_TOLERANCE[against] * limit))
    return dict(shape=list(shape), tolerance=dict(
        times_tensor_core_limit_of_the_plain_ring=RING_TOLERANCE,
        against_plain="beyond flash's own distance from it"),
        max_abs_err=err, used=used)


def _mesh_batches(vocab: int, batch: int, seq: int, steps: int) -> list:
    import numpy as np

    rng = np.random.default_rng(14)
    return [rng.integers(0, vocab, (batch, seq)).astype(np.int32)
            for _ in range(steps)]


# The depth the gpt2-small mesh phases run at (of its 12 layers): the
# widths are whole, and the one-card run's time is mostly gloo moving
# each step's gradients, which the layers' count scales.
MESH_GPT_LAYERS = 4


def _gpt_mesh_config(**kw):
    from ray_tpu_torch.models import gpt

    return dataclasses.replace(gpt.CONFIGS["gpt2-small"],
                               n_layers=MESH_GPT_LAYERS, **kw)


def _gpt_mesh_run():
    config = _gpt_mesh_config()
    return (config, dict(data=2, fsdp=2, tensor=2),
            _mesh_batches(config.vocab_size, 8, 1024, 3))


def _llama_mesh_run():
    from ray_tpu_torch.models import llama

    config = dataclasses.replace(llama.CONFIGS["llama-1b"], n_layers=2)
    return (config, dict(data=2, tensor=2),
            _mesh_batches(config.vocab_size, 4, 2048, 3))


def _gpt_seq_run():
    config = _gpt_mesh_config()
    return (config, dict(seq=4), _mesh_batches(config.vocab_size, 4, 1024,
                                               3))


def _llama_seq_run():
    from ray_tpu_torch.models import llama

    config = dataclasses.replace(llama.CONFIGS["llama-1b"], n_layers=2)
    return (config, dict(tensor=2, seq=2),
            _mesh_batches(config.vocab_size, 4, 2048, 3))


def _moe_mesh_run():
    config = _gpt_mesh_config(n_experts=MOE_EXPERTS)
    return (config, dict(data=2, expert=2),
            _mesh_batches(config.vocab_size, 8, 1024, 3))


# (config, mesh sizes, global batches) of each mesh phase.
MESH_RUNS = {"gpt": _gpt_mesh_run, "llama": _llama_mesh_run,
             "gpt_seq": _gpt_seq_run, "llama_seq": _llama_seq_run,
             "moe": _moe_mesh_run}


# Which outputs of the ring check each kernel's entry carries.
_RING_OUTPUTS = {"flash_forward": ("O",), "flash_dq": ("dq",),
                 "flash_dkv": ("dk", "dv")}


def _mesh_report(report: dict, key: str, out: dict) -> None:
    for name in out["launches_by_rank"][0]:
        entry = report.setdefault(name, {}).setdefault(key, {})
        entry.update(launches_by_rank=[r[name]
                                       for r in out["launches_by_rank"]],
                     steps=out["steps"])
        ring = out["ring_check"]
        if ring is not None:
            entry["ring_check"] = {
                k: dict(max_abs_err=ring["max_abs_err"][k],
                        tolerance_used=ring["used"][k])
                for k in ring["used"]
                if k.split(" ")[0] in _RING_OUTPUTS[name]}


def phase_train_mesh(report: dict) -> None:
    """gpt2-small at full width, MESH_GPT_LAYERS layers (bf16, fp32
    params) on MeshConfig(data=2, fsdp=2, tensor=2): eight ranks, a
    global batch of 8 x 1024, 3 AdamW steps."""
    config, sizes, batches = MESH_RUNS["gpt"]()
    out = _mesh_run("gpt", config, sizes, batches)
    _mesh_report(report, "train_mesh", out)
    emit("train_mesh", config=f"gpt2-small, {config.n_layers} layers",
         **out)
    for fault in _mesh_faults(out, config.n_layers):
        check(False, f"train_mesh: {fault}")


def phase_train_mesh_llama(report: dict) -> None:
    """llama-1b's widths at 2 layers (bf16, fp32 params) on
    MeshConfig(data=2, tensor=2): four ranks, each with 16 query heads
    over 2 kv heads, a global batch of 4 x 2048, 3 AdamW steps."""
    config, sizes, batches = MESH_RUNS["llama"]()
    out = _mesh_run("llama", config, sizes, batches)
    _mesh_report(report, "train_mesh_llama", out)
    emit("train_mesh_llama", config="llama-1b widths, 2 layers", **out)
    for fault in _mesh_faults(out, config.n_layers):
        check(False, f"train_mesh_llama: {fault}")


def phase_train_mesh_seq(report: dict) -> None:
    """gpt2-small at full width, MESH_GPT_LAYERS layers (bf16, fp32 params) on
    MeshConfig(seq=4): four ranks, each with a quarter of every row's
    1024 positions, a global batch of 4 x 1024, 3 AdamW steps; attention
    is the ring (K1-K3 per block), checked first at the run's own block
    shape."""
    config, sizes, batches = MESH_RUNS["gpt_seq"]()
    out = _mesh_run("gpt", config, sizes, batches,
                    ring=(4, 1024, config.n_heads, config.head_dim))
    _mesh_report(report, "train_mesh_seq", out)
    emit("train_mesh_seq", config=f"gpt2-small, {config.n_layers} layers",
         **out)
    for fault in _mesh_faults(out, config.n_layers):
        check(False, f"train_mesh_seq: {fault}")


def phase_train_mesh_seq_llama(report: dict) -> None:
    """llama-1b's widths at 2 layers (bf16, fp32 params) on
    MeshConfig(tensor=2, seq=2): four ranks, each with 16 query heads
    over 2 kv heads and half of every row's 2048 positions, a global
    batch of 4 x 2048, 3 AdamW steps; the ring carries the repeated kv
    heads, as the reference's does."""
    config, sizes, batches = MESH_RUNS["llama_seq"]()
    out = _mesh_run("llama", config, sizes, batches,
                    ring=(4, 2048, config.n_heads, config.head_dim))
    _mesh_report(report, "train_mesh_seq_llama", out)
    emit("train_mesh_seq_llama", config="llama-1b widths, 2 layers", **out)
    for fault in _mesh_faults(out, config.n_layers):
        check(False, f"train_mesh_seq_llama: {fault}")


def phase_train_mesh_moe(report: dict) -> None:
    """gpt2-small's widths at MESH_GPT_LAYERS layers with train_moe's 8
    Switch experts per layer (bf16,
    fp32 params) on MeshConfig(data=2, expert=2): four ranks, each with
    4 experts, routing its rows against all 8 with the global capacity
    and queue order, a global batch of 8 x 1024, 3 AdamW steps."""
    config, sizes, batches = MESH_RUNS["moe"]()
    out = _mesh_run("gpt", config, sizes, batches)
    _mesh_report(report, "train_mesh_moe", out)
    emit("train_mesh_moe", config=f"gpt2-small, {config.n_layers} layers, "
         f"{config.n_experts} experts",
         **out)
    for fault in _mesh_faults(out, config.n_layers):
        check(False, f"train_mesh_moe: {fault}")


# The stage axis: gpt2-small's 12 blocks as 4 pipeline stages of
# 3 over 4 ranks (`pipeline_loss_dryrun`), 4 microbatches of 2 x 1024 a
# step, against the 12 blocks in turn on one device.
PP_SPMD_STAGES, PP_SPMD_MICRO, PP_SPMD_MICRO_BATCH = 4, 4, 2
# The first step's gradient of each stage leaf (before AdamW, whose
# update barely moves when every gradient takes one common scale) within
# PP_SPMD_GRAD_TOL of one device's in L2 norm.  On the card (PERF.md)
# the sound run reads 0 (the stages run one device's kernels on one
# device's shapes); the same run with the final all-reduce summing in
# the backward too ("sum_backward", which the phase makes as well) hands
# every stage 4x its gradient and reads 3.0 on every leaf, while its
# losses (3e-5 apart) and updates (0.048) pass the mesh phases' limits,
# which the losses and updates keep.
PP_SPMD_GRAD_TOL = 0.05


def _pp_spmd_batches(vocab: int) -> list:
    return [b.reshape(PP_SPMD_MICRO, PP_SPMD_MICRO_BATCH, -1) for b in
            _mesh_batches(vocab, PP_SPMD_MICRO * PP_SPMD_MICRO_BATCH, 1024,
                          3)]


def phase_pipeline_spmd(report: dict) -> None:
    """gpt2-small at full width and depth (bf16, fp32 params) through
    `pipeline_loss_dryrun` on MeshConfig(stage=4): four ranks, each
    holding 3 blocks, 4 microbatches of 2 x 1024 a step, the embeddings
    before the stages and the final LayerNorm, tied head and
    `fused_cross_entropy` after them fixed, 3 AdamW steps on the stage
    params; against the 12 blocks in turn on one device (the same
    function with no mesh) on the same weights and batches.  A stage
    skips its block calls in the bubble, so K1-K3 run 3 x 4 times a
    step on every rank.  The hops' and the final all-reduce's bytes and
    ms come from one more step under `collectives.measure()`.  The same
    ranks then run it again with the final all-reduce summing in the
    backward too, which the gradient check must catch."""
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.parallel import rank_bodies
    from ray_tpu_torch.parallel.launch import choose_backend

    config = gpt.CONFIGS["gpt2-small"]
    batches = _pp_spmd_batches(config.vocab_size)
    per = config.n_layers // PP_SPMD_STAGES
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "single.pt")
        single = rank_bodies.pipeline_gpt(
            0, 1, None, config, batches, MESH_LR, "cuda", PP_SPMD_STAGES,
            save=path)
        gc.collect()
        torch.cuda.empty_cache()
        args = (dict(stage=PP_SPMD_STAGES), config, batches, MESH_LR,
                "cuda", PP_SPMD_STAGES, path)
        t0 = time.perf_counter()
        runs = _ranks(PP_SPMD_STAGES).run(rank_bodies.sequence, [
            ("pipeline_gpt", args),
            ("pipeline_gpt", args + (None, "sum_backward"))])
        wall_s = time.perf_counter() - t0
    ranks, controls = [r[0] for r in runs], [r[1] for r in runs]

    def worst(rs, key):
        return max((err, f"rank {rank} {leaf}") for rank, r in enumerate(rs)
                   for leaf, err in r[key].items())
    want = single["losses"] + [single["final_loss"]]
    loss_diff = max(abs(a - b) for r in ranks
                    for a, b in zip(r["losses"] + [r["final_loss"]], want))
    update_err, update_leaf = worst(ranks, "update_rel_err")
    grad_err, grad_leaf = worst(ranks, "grad_rel_err")
    control_grad_err = worst(controls, "grad_rel_err")
    control_update_err = worst(controls, "update_rel_err")[0]
    steps = len(batches)
    launches_want = steps * per * PP_SPMD_MICRO
    collectives = [r["collectives"] for r in ranks]
    out = dict(
        mesh=dict(stage=PP_SPMD_STAGES), ranks=PP_SPMD_STAGES,
        blocks_per_stage=per, microbatches=PP_SPMD_MICRO,
        micro_batch=[PP_SPMD_MICRO_BATCH, 1024], steps=steps, lr=MESH_LR,
        losses=ranks[0]["losses"] + [ranks[0]["final_loss"]],
        single_device_losses=want, max_loss_diff=loss_diff,
        loss_tolerance=MESH_LOSS_TOL, max_update_rel_err=update_err,
        max_update_rel_err_at=update_leaf, update_tolerance=MESH_UPDATE_TOL,
        max_grad_rel_err=grad_err, max_grad_rel_err_at=grad_leaf,
        grad_tolerance=PP_SPMD_GRAD_TOL,
        bit_equal=loss_diff == update_err == grad_err == 0.0,
        sum_backward=dict(
            max_grad_rel_err=control_grad_err[0],
            max_grad_rel_err_at=control_grad_err[1],
            min_grad_rel_err=min(err for r in controls
                                 for err in r["grad_rel_err"].values()),
            max_update_rel_err=control_update_err,
            max_loss_diff=max(abs(a - b) for r in controls for a, b in
                              zip(r["losses"] + [r["final_loss"]], want))),
        median_step_ms=statistics.median(r["median_step_ms"] for r in ranks),
        step_ms_by_rank=[r["median_step_ms"] for r in ranks],
        single_device_step_ms=single["median_step_ms"],
        collective_share_by_rank=[c["share"] for c in collectives],
        hops_rank0=collectives[0]["by_op"].get("rotate"),
        final_all_reduce_rank0=collectives[0]["by_op"].get("all_reduce"),
        collectives_rank0=collectives[0],
        peak_memory_gib_by_rank=[r["peak_memory_gib"] for r in ranks],
        single_device_peak_memory_gib=single["peak_memory_gib"],
        launches_by_rank=[r["launches"] for r in ranks],
        single_device_launches=single["launches"],
        launches_want_per_rank=launches_want, ranks_wall_s=wall_s,
        note=("ranks share card 0 over gloo" if choose_backend(
            PP_SPMD_STAGES) == "gloo" else "one card per rank over NCCL")
        + "; collectives from one extra step with a synchronize around "
          "each")
    for name in out["launches_by_rank"][0]:
        report.setdefault(name, {})["pipeline_spmd"] = dict(
            launches_by_rank=[r[name] for r in out["launches_by_rank"]],
            steps=steps)
    emit("pipeline_spmd", config="gpt2-small", **out)
    check(loss_diff <= MESH_LOSS_TOL,
          f"pipeline_spmd: losses {out['losses']} vs one device {want}")
    check(update_err <= MESH_UPDATE_TOL,
          f"pipeline_spmd: update of {update_leaf} {update_err}")
    check(grad_err <= PP_SPMD_GRAD_TOL,
          f"pipeline_spmd: first gradient of {grad_leaf} {grad_err}")
    check(out["sum_backward"]["max_grad_rel_err"] > PP_SPMD_GRAD_TOL,
          f"pipeline_spmd: the sum_backward control passed the gradient "
          f"check: {out['sum_backward']}")
    check(not any(r["start_differs"] for r in ranks),
          "pipeline_spmd: a rank started from other weights")
    for rank, r in enumerate(ranks):
        for name, n in r["launches"].items():
            check(n == launches_want, f"pipeline_spmd: rank {rank} {name} "
                  f"launched {n} times, want {launches_want}")
    for name, n in single["launches"].items():
        check(n == steps * config.n_layers * PP_SPMD_MICRO,
              f"pipeline_spmd: one device's {name} launched {n} times")


def _gpt_stage_run():
    config = _gpt_mesh_config()
    return (config, dict(data=2, stage=2),
            _mesh_batches(config.vocab_size, 4, 1024, 3))


MESH_RUNS["gpt_stage"] = _gpt_stage_run


def phase_train_mesh_stage(report: dict) -> None:
    """gpt2-small at full width, MESH_GPT_LAYERS layers (bf16, fp32 params) on
    MeshConfig(data=2, stage=2): four ranks, a global batch of 4 x 1024
    split over data, 3 AdamW steps.  The reference maps no leaf and no
    batch dim to stage, so the two stage ranks of a data rank are
    replicas: their losses and params (a sha256 of them) must agree to
    the last bit, beside the mesh phases' checks."""
    config, sizes, batches = MESH_RUNS["gpt_stage"]()
    out = _mesh_run("gpt", config, sizes, batches, digest=True)
    _mesh_report(report, "train_mesh_stage", out)
    replicas: dict = {}
    for c, losses, digest in zip(out["coordinate_by_rank"],
                                 out["losses_by_rank"],
                                 out["digest_by_rank"]):
        replicas.setdefault(c["data"], []).append((losses, digest))
    out["stage_replicas_equal"] = all(
        len(set((tuple(l), d) for l, d in group)) == 1 and len(group) == 2
        for group in replicas.values())
    emit("train_mesh_stage", config=f"gpt2-small, {config.n_layers} layers",
         **out)
    for fault in _mesh_faults(out, config.n_layers):
        check(False, f"train_mesh_stage: {fault}")
    check(out["stage_replicas_equal"],
          f"train_mesh_stage: stage replicas differ: {replicas}")


# Uneven rows: global batches whose rows the row ranks (data x fsdp) do
# not divide, split as GSPMD pads them (each row rank holds
# ceil(B / ranks) rows, its pad rows masked), against the port's
# single-device step on the same weights and rows.  Beside the mesh
# phases' checks, each rank's first summed gradients (before AdamW,
# whose update barely moves under a common scale) within
# UNEVEN_GRAD_TOL of one device's in L2 norm, per leaf.  The limit sits
# between the sound runs' readings and those of the "rank_means"
# control (each row rank's loss normalised by its own count, then the
# ranks averaged: what an uneven split must not do), both in PERF.md.
UNEVEN_GRAD_TOL = 0.05
UNEVEN_BATCH = 3
# gpt2-small with 8 experts on 3 x 1024 tokens: ceil(3072 / 8 * 1.25).
# Counting the pad row's tokens too ("capacity_from_padded") gives 640.
UNEVEN_MOE_CAPACITY = 480


def _uneven_rows(out: dict, n: int) -> list:
    """Each rank's real rows of `n` under GSPMD's split, by its
    coordinate: what `real_rows_by_rank` must read."""
    sizes = out["mesh"]
    parts = sizes.get("data", 1) * sizes.get("fsdp", 1)
    chunk = -(-n // parts)
    want = []
    for c in out["coordinate_by_rank"]:
        i = c["data"] * sizes.get("fsdp", 1) + c["fsdp"]
        want.append(max(0, min(n, (i + 1) * chunk) - i * chunk))
    return want


def _uneven_lm(report: dict, name: str, config, sizes: dict,
               batches: list, reference: tuple) -> list:
    """One LM run of train_mesh_uneven: `_mesh_run` against `reference`
    with the first gradients and the rank_means control; its faults."""
    out = _mesh_run("gpt", config, sizes, batches, digest=True,
                    grad_controls=("rank_means",), reference=reference)
    _mesh_report(report, f"train_mesh_uneven_{name}", out)
    out["want_real_rows"] = _uneven_rows(out, batches[0].shape[0])
    out["grad_tolerance"] = UNEVEN_GRAD_TOL
    emit("train_mesh_uneven", run=name,
         config=f"gpt2-small, {config.n_layers} layers", **out)
    faults = _mesh_faults(out, config.n_layers)
    err, at = out["max_grad_rel_err"]
    if not err <= UNEVEN_GRAD_TOL:
        faults.append(f"first gradient of {at} {err} of one device's")
    bad = out["grad_controls_read"]["rank_means"]
    if not bad[0] > UNEVEN_GRAD_TOL:
        faults.append(f"the rank_means control passed the gradient "
                      f"check: {bad}")
    if out["real_rows_by_rank"] != out["want_real_rows"]:
        faults.append(f"real rows {out['real_rows_by_rank']}, want "
                      f"{out['want_real_rows']}")
    replicas = {}
    for c, d in zip(out["coordinate_by_rank"], out["digest_by_rank"]):
        replicas.setdefault(c["tensor"], set()).add(d)
    if any(len(d) != 1 for d in replicas.values()):
        faults.append("the row ranks' replicated params differ")
    if any(l != out["losses_by_rank"][0] for l in out["losses_by_rank"]):
        faults.append(f"the ranks' losses differ: {out['losses_by_rank']}")
    return [f"{name}: {f}" for f in faults]


def phase_train_mesh_uneven(report: dict) -> None:
    """Global batches that the row ranks do not divide, at full width:
    - gpt2-small (MESH_GPT_LAYERS of its 12 layers, bf16, fp32 params)
      on MeshConfig(data=2, tensor=2), 3 x 1024 tokens a step: real rows
      [2, 1] by data rank;
    - the same on MeshConfig(data=4): the last rank holds a pad row
      only, yet runs K1-K3 and joins every collective, its losses and
      params those of the others;
    - gpt2-small with train_moe's 8 experts (12 layers) on
      MeshConfig(data=2, expert=2), 3 x 1024: the capacity counts the
      3,072 real tokens (480 in every layer on every rank) and the
      dropped tokens per layer are one device's (on weights drawn on the
      card from seed 0), with the capacity_from_padded control reading
      640;
    - resnet50 on MeshConfig(data=2), 63 images of 224 x 224: 32 and 31
      a rank, against one device taking the same halves (each image
      weighted alike) and the whole batch, with the rank_means control
      (run first, on the two ranks the phases before leave up).
    Each LM run takes 3 AdamW steps against the port's single-device
    step on the same seed-0 weights and rows (`_mesh_run`)."""
    from ray_tpu_torch.models import gpt
    from ray_tpu_torch.parallel import rank_bodies

    # ResNet's two ranks first: the gang of the phases before is of two.
    res = _resnet_mesh(dict(seed=1, steps=3, batch=63, image=[224, 224, 3]),
                       "rank_means")
    emit("train_mesh_uneven", run="resnet", **res)
    faults = [f"resnet: {f}" for f in _resnet_faults(res, "rank_means",
                                                     ("split",))]
    config = _gpt_mesh_config()
    batches = _mesh_batches(config.vocab_size, UNEVEN_BATCH, 1024, 3)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "single.pt")
        reference = _single_reference("gpt", config, batches, path,
                                      True) + (path,)
        for name, sizes in (("dense", dict(data=2, tensor=2)),
                            ("empty_rank", dict(data=4))):
            faults += _uneven_lm(report, name, config, sizes, batches,
                                 reference)
    moe = dataclasses.replace(gpt.CONFIGS["gpt2-small"],
                              n_experts=MOE_EXPERTS)
    sizes = dict(data=2, expert=2)
    out = _mesh_run("gpt", moe, sizes, batches)
    _mesh_report(report, "train_mesh_uneven_moe", out)
    faults += [f"moe: {f}" for f in _mesh_faults(out, moe.n_layers)]
    single = rank_bodies.routing(0, 1, None, moe, batches[0], "cuda")
    gc.collect()
    torch.cuda.empty_cache()
    routed = _ranks(4).run(rank_bodies.sequence, [
        ("routing", (sizes, moe, batches[0], "cuda")),
        ("routing", (sizes, moe, batches[0], "cuda", None,
                     "capacity_from_padded"))])
    sound, padded = [r[0] for r in routed], [r[1] for r in routed]
    want_cap = [UNEVEN_MOE_CAPACITY] * moe.n_layers
    for rank, (r, p) in enumerate(zip(sound, padded)):
        if r["capacity"] != want_cap:
            faults.append(f"moe: rank {rank} capacity {r['capacity']}")
        if r["dropped"] != single["dropped"]:
            faults.append(f"moe: rank {rank} dropped {r['dropped']}, one "
                          f"device {single['dropped']}")
        if p["capacity"] == want_cap:
            faults.append(f"moe: capacity_from_padded read {p['capacity']}")
    emit("train_mesh_uneven", run="moe",
         config=f"gpt2-small, {moe.n_layers} layers, {MOE_EXPERTS} experts",
         **out,
         capacity_by_rank=[r["capacity"] for r in sound],
         capacity_from_padded_by_rank=[p["capacity"] for p in padded],
         dropped_by_rank=[r["dropped"] for r in sound],
         single_device_dropped=single["dropped"],
         aux_by_rank=[r["aux"] for r in sound],
         single_device_aux=single["aux"],
         routing_real_rows_by_rank=[r["real_rows"] for r in sound])
    for fault in faults:
        check(False, f"train_mesh_uneven: {fault}")


# The 7B configs under fsdp with remat: each block gathers its layer's
# leaves over fsdp inside the recomputed function (the module docstring
# of models/_functional.py), so a rank holds its shards and one layer
# gathered at a time.  The params are drawn on the card (a CUDA
# generator seeded 0, leaf by leaf, each rank keeping its shard), as the
# single-device runs they are held against draw them.
SEVEN_B_SIZES = {"fsdp": 4}
# train_7b's depth of llama2-7b's 32 layers (the widths whole).
SEVEN_B_LAYERS = 2
# train_7b_cards: (run, family, config, global rows, row length, the
# peak GiB a rank may reach), each at full depth and width.
SEVEN_B_CARDS = (("llama2-7b", "llama", "llama2-7b", 8, 4096, 40.0),
                 ("llama3-8b", "llama", "llama3-8b", 4, 8192, 45.0),
                 ("gpt-7b", "gpt", "7b", 8, 4096, 34.0))
SEVEN_B_CARDS_STEPS = 3


def _shard_numel(model, config, sizes: dict) -> dict:
    """{leaf path: its elements on one rank} under `sizes` (fsdp is the
    only axis above 1 in these runs, so a leaf is split by it or
    whole)."""
    from ray_tpu_torch.parallel import rank_bodies
    from ray_tpu_torch.parallel.sharding import logical_to_spec, spec_axes

    mesh = types.SimpleNamespace(shape=sizes)
    specs = rank_bodies._flat(model.param_specs(config))
    return {path: math.prod(shape) // (
        sizes.get("fsdp", 1) if "fsdp" in spec_axes(
            logical_to_spec(specs[path], mesh=mesh)) else 1)
        for path, shape in rank_bodies._flat(
            model.param_shapes(config)).items()}


def _gathered_leaves(model, config, sizes: dict) -> int:
    """The block leaves a layer gathers over fsdp under `sizes`."""
    own = _shard_numel(model, config, sizes)
    whole = _shard_numel(model, config, {})
    return sum(own[p] != whole[p] for p in own if p.startswith("blocks/"))


def _peak_bound(model, config, sizes: dict, tokens: int) -> dict:
    """What a rank may hold at its peak under fsdp with remat, in GiB by
    part, `tokens` its rows x length:
    - shards: its params, gradients and AdamW's two moments (4 x 4 bytes
      an element of its shards);
    - stacked: its block gradients once more (unbind's backward holds
      every layer's gradient and then stacks them);
    - layer: one layer gathered, 2.5 x its f32 bytes (the weights, their
      bf16 copies and their whole f32 gradient before the
      reduce-scatter);
    - head: the gathered head, f32, bf16 and its f32 gradient (10
      bytes an element of vocab x d_model);
    - activations: each block's saved input (bf16), one block's
      recompute and backward (tokens x (32 d + 12 f) bytes), the
      embedding lookup's rows of the fsdp group (bf16, and its
      gradient) and three f32 copies of a cross-entropy chunk
      (tokens / 4 rows of the vocab).
    `held_layers` is what the order that gathers outside the recomputed
    block would add: every other layer gathered (f32) from the forward
    to the backward."""
    own = _shard_numel(model, config, sizes)
    whole = _shard_numel(model, config, {})
    blocks = [p for p in own if p.startswith("blocks/")]
    layer = 4 * sum(whole[p] for p in blocks) / config.n_layers
    d, f, v = config.d_model, config.d_ff, config.vocab_size
    fsdp = sizes.get("fsdp", 1)
    act = (config.n_layers * tokens * d * 2 + tokens * (32 * d + 12 * f)
           + 2 * fsdp * tokens * d * 2 + 3 * (tokens // 4) * v * 4)
    parts = {"shards": 16 * sum(own.values()),
             "stacked": 4 * sum(own[p] for p in blocks),
             "layer": 2.5 * layer, "head": 10 * v * d,
             "activations": act}
    out = {k: b / 2 ** 30 for k, b in parts.items()}
    out["total"] = sum(out.values())
    out["held_layers"] = (config.n_layers - 1) * layer / 2 ** 30
    return out


def _gather_faults(out: dict, n_layers: int, leaves: int,
                   per_layer: int) -> list:
    """Each rank's measured step must have gathered each of the `leaves`
    block leaves over fsdp `per_layer` times a layer (2 under remat: the
    forward's and the recompute's) and reduce-scattered it once."""
    faults = []
    for rank, ops in enumerate(out["layer_gathers_by_rank"]):
        for op, want in (("all_gather", per_layer * n_layers * leaves),
                         ("reduce_scatter", n_layers * leaves)):
            if ops[op]["calls"] != want:
                faults.append(f"rank {rank}: {ops[op]['calls']} fsdp "
                              f"{op}s of block leaves, want {want}")
    return faults


def _peak_faults(out: dict, bound: dict, limit=None) -> list:
    faults = []
    for rank, peak in enumerate(out["peak_memory_gib_by_rank"]):
        for what, most in (("the bound", bound["total"]), ("the limit",
                                                           limit)):
            if most is not None and not peak <= most:
                faults.append(f"rank {rank}: peak {peak} GiB over {what} "
                              f"{most}")
    return faults


def phase_train_7b(report: dict) -> None:
    """llama2-7b at full width (d 4096, 32 heads of 128, d_ff 11008,
    vocab 32000), SEVEN_B_LAYERS of its 32 layers with remat, on
    MeshConfig(fsdp=4): the shared four ranks on card 0 over gloo, a
    global batch of 4 x 4096, bf16, f32 params drawn on the card from
    seed 0, 3 AdamW(MESH_LR) steps against the port's single-device step
    on the same weights and rows (`_mesh_run`'s checks, K1 twice per
    layer a step and K2, K3 once); each rank's measured step gathers
    every block leaf over fsdp twice a layer and reduce-scatters it
    once; each rank's peak within `_peak_bound`.  Then, on the same
    ranks, one step of the same run without remat, a control: its first
    loss and first gradients on every rank must equal the remat run's to
    the bit (so it passes the value checks that run passes; the
    recompute gives the same values), K1-K3 must run once per layer, and
    it must fail the gathers count (it gathers once a layer)."""
    from ray_tpu_torch.parallel import rank_bodies

    llama = rank_bodies._family("llama")
    config = dataclasses.replace(llama.CONFIGS["llama2-7b"],
                                 n_layers=SEVEN_B_LAYERS)
    sizes = dict(SEVEN_B_SIZES)
    batches = _mesh_batches(config.vocab_size, 4, 4096, 3)
    leaves = _gathered_leaves(llama, config, sizes)
    bound = _peak_bound(llama, config, sizes, 4096)
    out = _mesh_run("llama", config, sizes, batches, digest=True,
                    generator="cuda")
    t0 = time.perf_counter()
    control = [r[0] for r in _ranks(len(out["losses_by_rank"])).run(
        rank_bodies.sequence, [("train", (
            "llama", dataclasses.replace(config, remat=False), sizes, None,
            batches[:1], MESH_LR, "cuda", False, None, None, None, True,
            (), "cuda"))])]
    control_s = time.perf_counter() - t0
    control = dict(
        steps=1, ranks_wall_s=control_s, ring_check=None,
        losses_by_rank=[r["losses"] for r in control],
        grad_digest_by_rank=[r["grad_digest"] for r in control],
        launches_by_rank=[r["launches"] for r in control],
        layer_gathers_by_rank=[_layer_ops(r["collectives"])
                               for r in control],
        median_step_ms=statistics.median(r["median_step_ms"]
                                         for r in control),
        collectives_rank0=control[0]["collectives"],
        peak_memory_gib_by_rank=[r["peak_memory_gib"] for r in control],
        seq_rank_by_rank=[0] * len(control))
    _mesh_report(report, "train_7b", out)
    faults = _mesh_faults(out, config.n_layers, remat=True)
    faults += _gather_faults(out, config.n_layers, leaves, 2)
    faults += _peak_faults(out, bound)
    for rank, (got, want) in enumerate(zip(control["losses_by_rank"],
                                           out["losses_by_rank"])):
        if got[0] != want[0]:
            faults.append(f"control: rank {rank} first loss {got[0]}, the "
                          f"remat run's {want[0]}")
    if control["grad_digest_by_rank"] != out["grad_digest_by_rank"]:
        faults.append("control: first gradients differ from the remat "
                      "run's")
    faults += [f"control: {f}" for f in _mesh_faults(dict(
        control, max_loss_diff=0.0, max_update_rel_err=0.0,
        constraint_round_trip=True), config.n_layers)]
    control_count = _gather_faults(control, config.n_layers, leaves, 2)
    if not control_count:
        faults.append("the no-remat control passed the gathers count")
    emit("train_7b", config=f"llama2-7b, {config.n_layers} of 32 layers, "
         "remat", gathered_leaves=leaves, gathers_per_layer_wanted=2,
         peak_bound_gib=bound, **out)
    emit("train_7b", run="control without remat, one step",
         gathers_count_fails=control_count, **control)
    for fault in faults:
        check(False, f"train_7b: {fault}")


def _one_card_loss(model, config, tokens, path=None) -> dict:
    """The port's single-device loss on card 0 for the global batch
    `tokens`, the params drawn leaf by leaf from a CUDA generator seeded
    0 (as the ranks draw them): forward only; with `path`, its
    gradients too, saved there as {"grad": flat tree in bf16}, which
    `rank_bodies.train` reads slice by slice.  For the gradients the
    leaves are held as the bf16 values of the f32 draws: the forward
    then takes the same operands to the bit (each leaf is a weight or
    table it casts to bf16 where used, or a norm scale or bias of ones
    or zeros), and llama2-7b's f32 params and gradients (54 GB), its
    stacked block gradients twice at the end of the backward, would not
    fit one card."""
    from ray_tpu_torch.parallel import rank_bodies

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    grads = path is not None
    dtype = torch.bfloat16 if grads else torch.float32
    t0 = time.perf_counter()
    params = model.init_params(config, _seed0("cuda"), keep=lambda _, t:
                               t.to("cuda", dtype).requires_grad_(grads))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    with torch.set_grad_enabled(grads):
        loss = model.loss_fn(params, {"tokens": torch.from_numpy(
            tokens).to("cuda")}, config)
        if grads:
            loss.backward()
    loss = float(loss)
    out = dict(loss=loss, init_seconds=init_s,
               seconds=time.perf_counter() - t0,
               peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               grad_dtype=None if not grads else "bfloat16")
    if grads:
        torch.save({"grad": {k: v.grad.cpu() for k, v in
                             rank_bodies._flat(params).items()}}, path)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    out["with_save_seconds"] = time.perf_counter() - t0
    return out


def _cards_run(report: dict, run: str, family: str, name: str, rows: int,
               length: int, limit: float, tmp: str) -> list:
    """One run of train_7b_cards: the one-card reference, then the four
    ranks (NCCL, a card each) for SEVEN_B_CARDS_STEPS AdamW steps on one
    repeated batch; its readings emitted, its faults returned."""
    from ray_tpu_torch.parallel import rank_bodies

    model = rank_bodies._family(family)
    config = model.CONFIGS[name]
    sizes = dict(SEVEN_B_SIZES)
    world = math.prod(sizes.values())
    tokens = _mesh_batches(config.vocab_size, rows, length, 1)[0]
    grads = run == "llama2-7b"
    path = os.path.join(tmp, f"{run}.pt") if grads else None
    single = _one_card_loss(model, config, tokens, path)
    t0 = time.perf_counter()
    ranks = [r[0] for r in _ranks(world).run(rank_bodies.sequence, [(
        "train", (family, config, sizes, None,
                  [tokens] * SEVEN_B_CARDS_STEPS, MESH_LR, "cuda", False,
                  None, path, None, True, (), "cuda"))])]
    wall_s = time.perf_counter() - t0
    if path is not None:
        os.remove(path)
    out = dict(
        backend_by_rank=[r["backend"] for r in ranks],
        losses_by_rank=[r["losses"] + [r["final_loss"]] for r in ranks],
        launches_by_rank=[r["launches"] for r in ranks],
        layer_gathers_by_rank=[_layer_ops(r["collectives"]) for r in ranks],
        peak_memory_gib_by_rank=[r["peak_memory_gib"] for r in ranks],
        peak_memory_gib_by_step_rank0=ranks[0]["peak_memory_gib_by_step"],
        step_ms_by_rank=[r["step_ms"] for r in ranks],
        init_seconds_by_rank=[r["init_seconds"] for r in ranks],
        host_rss_gib_by_rank=[r["host_rss_gib"] for r in ranks],
        collectives_rank0=ranks[0]["collectives"],
        collective_share_by_rank=[r["collectives"]["share"] for r in ranks],
        digest_by_rank=[r["params_digest"] for r in ranks],
        grad_digest_by_rank=[r["grad_digest"] for r in ranks],
        rank0_host_seconds=ranks[0]["host_seconds"], ranks_wall_s=wall_s,
        steps=SEVEN_B_CARDS_STEPS)
    step_ms = statistics.median(r["median_step_ms"] for r in ranks)
    tokens_s_card = rows * length / world / (step_ms / 1e3)
    n_params = model.num_params(config)
    bound = _peak_bound(model, config, sizes, rows * length // world)
    losses = out["losses_by_rank"][0]
    first_diff = max(abs(r[0] - single["loss"])
                     for r in out["losses_by_rank"])
    grad_err = None if not grads else max(
        (err, f"rank {i} {leaf}") for i, r in enumerate(ranks)
        for leaf, err in r["grad_rel_err"].items())
    leaves = _gathered_leaves(model, config, sizes)
    emit("train_7b_cards", run=run, config=f"{name}, {config.n_layers} "
         f"layers, remat, fsdp4", global_batch=[rows, length],
         num_params=n_params, median_step_ms=step_ms,
         tokens_per_s_per_card=tokens_s_card,
         mfu=6 * n_params * tokens_s_card / PEAK_FLOPS[torch.bfloat16],
         collective_share_median=statistics.median(
             out["collective_share_by_rank"]),
         one_card=single, first_loss_diff=first_diff,
         loss_tolerance=MESH_LOSS_TOL, max_grad_rel_err=grad_err,
         grad_tolerance=UNEVEN_GRAD_TOL if grads else None,
         peak_limit_gib=limit, peak_bound_gib=bound,
         gathered_leaves=leaves, **out)
    for name_k, by_rank in zip(("flash_forward", "flash_dq", "flash_dkv"),
                               zip(*[[r[k] for k in ("flash_forward",
                                                     "flash_dq",
                                                     "flash_dkv")]
                                     for r in out["launches_by_rank"]])):
        report.setdefault(name_k, {}).setdefault("train_7b_cards", {})[
            run] = dict(launches_by_rank=list(by_rank),
                        steps=SEVEN_B_CARDS_STEPS)
    faults = []
    if set(out["backend_by_rank"]) != {"nccl"}:
        faults.append(f"backends {out['backend_by_rank']}, want nccl")
    if not first_diff <= MESH_LOSS_TOL:
        faults.append(f"first loss {first_diff} from one card's "
                      f"{single['loss']}")
    if grads and not grad_err[0] <= UNEVEN_GRAD_TOL:
        faults.append(f"first gradient of {grad_err[1]} {grad_err[0]} of "
                      f"one card's")
    if any(l != losses for l in out["losses_by_rank"]):
        faults.append(f"the ranks' losses differ: {out['losses_by_rank']}")
    if not (all(math.isfinite(l) for l in losses)
            and losses[-1] < losses[0]):
        faults.append(f"losses {losses} not finite and falling")
    faults += _mesh_faults(dict(out, steps=SEVEN_B_CARDS_STEPS,
                                max_loss_diff=0.0, max_update_rel_err=0.0,
                                constraint_round_trip=True, ring_check=None,
                                seq_rank_by_rank=[0] * world),
                           config.n_layers, remat=True)
    faults += _gather_faults(out, config.n_layers, leaves, 2)
    faults += _peak_faults(out, bound, limit)
    return [f"{run}: {f}" for f in faults]


def phase_train_7b_cards(report: dict) -> None:
    """Opt-in (named on the command line; not in the default run), on
    four cards: each of SEVEN_B_CARDS at full depth and width with remat
    on MeshConfig(fsdp=4), four ranks over NCCL with a card each, 3
    AdamW(MESH_LR) steps on one repeated batch: the first loss within
    MESH_LOSS_TOL of the port's single-device loss on card 0 on the same
    weights (drawn alike on the card) and rows, and for llama2-7b each
    rank's first summed gradients within UNEVEN_GRAD_TOL of one card's
    per leaf; finite, falling losses, equal on every rank; K1 twice per
    layer a step and K2, K3 once on every rank; every block leaf
    gathered over fsdp twice a layer; each rank's peak within its limit
    and `_peak_bound`.  Prints step ms, tokens/s per card, MFU (6 x
    params x tokens/s over 989 TFLOP/s), the collective share, the init's
    seconds and host memory, and peak GiB by rank.  Raises with fewer
    than four cards."""
    world = math.prod(SEVEN_B_SIZES.values())
    check(torch.cuda.device_count() >= world,
          f"train_7b_cards: needs {world} cards, found "
          f"{torch.cuda.device_count()}")
    _ranks.close()              # a fresh gang: each rank's host peak its own
    faults = []
    with tempfile.TemporaryDirectory() as tmp:
        for run in SEVEN_B_CARDS:
            faults += _cards_run(report, *run, tmp=tmp)
    for fault in faults:
        check(False, f"train_7b_cards: {fault}")


# The RL learners' learner group and ResNet under a mesh: data = 2
# against one device on the card.  Summation orders differ (a batched
# product over half the rows, a mean of two means), so the weights are
# held as the reference's own dp test holds them on the CPU.
DP_RTOL, DP_ATOL = 1e-4, 1e-5
RL_DP_PPO = {"lr": 3e-3, "grad_clip": 0.5, "num_sgd_iter": 4,
             "sgd_minibatch_size": 128, "clip_param": 0.2}


def _rl_dp_batches():
    """tests/test_rllib_dp.py's shapes: a PPO batch of 512 rows (obs 6,
    3 actions) and a V-trace fragment T 16 x B 8 (obs 4, 2 actions)."""
    import numpy as np

    from ray_tpu_torch.rllib import SampleBatch

    rng = np.random.default_rng(0)
    n = 512
    ppo = SampleBatch({
        "obs": rng.normal(size=(n, 6)).astype(np.float32),
        "actions": rng.integers(0, 3, size=n).astype(np.int32),
        "action_logp": rng.normal(size=n).astype(np.float32) * 0.1 - 1.0,
        "advantages": rng.normal(size=n).astype(np.float32),
        "value_targets": rng.normal(size=n).astype(np.float32)})
    rng = np.random.default_rng(1)
    t, b = 16, 8
    vtrace = SampleBatch({
        "obs": rng.normal(size=(t, b, 4)).astype(np.float32),
        "actions": rng.integers(0, 2, size=(t, b)).astype(np.int32),
        "action_logp": (rng.normal(size=(t, b)) * 0.1 - 0.7).astype(
            np.float32),
        "rewards": rng.normal(size=(t, b)).astype(np.float32),
        "terminateds": np.zeros((t, b), bool),
        "truncateds": np.zeros((t, b), bool),
        "bootstrap_obs": rng.normal(size=(b, 4)).astype(np.float32)})
    return ppo, vtrace


def _weights_apart(got, want) -> float:
    """The largest |got - want| / (DP_ATOL + DP_RTOL |want|) over the
    leaves: at most 1 within the tolerance."""
    import numpy as np

    def leaves(tree):
        if isinstance(tree, dict):
            return [x for k in sorted(tree) for x in leaves(tree[k])]
        return [np.asarray(tree, np.float64)]
    return max(float(np.max(np.abs(g - w) / (DP_ATOL + DP_RTOL * np.abs(w))))
               for g, w in zip(leaves(got), leaves(want)))


def phase_rl_learner_dp() -> None:
    """PPO's `TorchLearner` (tests/test_rllib_dp.py's shape: 512 rows,
    4 epochs of 128) and the V-trace learner (T 16, B 8) data-parallel
    on two ranks against one device, f32, the same weights (seeds) and
    batches, two updates each; then one `PPO.train()` with
    `learner_mesh` of data 2 (a `LearnerGroup`) against one device's,
    and its `save()` / `restore()` to and from one device."""
    from ray_tpu_torch.parallel import rank_bodies
    from ray_tpu_torch.parallel.mesh import MeshConfig
    from ray_tpu_torch.rllib import IMPALAConfig, PPOConfig
    from ray_tpu_torch.rllib.impala import _VTraceLearner
    from ray_tpu_torch.rllib.learner import TorchLearner, ppo_loss

    ppo, vtrace = _rl_dp_batches()
    specs = {"ppo": ((6, 3), dict(loss_fn=ppo_loss, config=RL_DP_PPO,
                                  seed=7), ppo),
             "vtrace": ((4, 2, IMPALAConfig(), (32,), 3), {}, vtrace)}
    make = {"ppo": TorchLearner, "vtrace": _VTraceLearner}
    single, single_ms = {}, {}
    for kind, (args, kwargs, batch) in specs.items():
        learner = make[kind](*args, device="cuda", **kwargs)
        learner.update(batch)            # two updates, the second timed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = learner.update(batch)
        single_ms[kind] = (time.perf_counter() - t0) * 1e3
        single[kind] = (metrics, learner.get_weights())
    calls = [("learner", (kind, args, kwargs, None, [batch, batch], None,
                          "cuda"))
             for kind, (args, kwargs, batch) in specs.items()]
    t0 = time.perf_counter()
    ranks = _ranks(2).run(rank_bodies.sequence, calls)
    ranks_wall_s = time.perf_counter() - t0
    out = {"ranks": 2, "tolerance": dict(rtol=DP_RTOL, atol=DP_ATOL),
           "single_device_update_ms": single_ms, "ranks_wall_s": ranks_wall_s}
    for i, kind in enumerate(specs):
        metrics, weights = single[kind]
        runs = [r[i] for r in ranks]
        out[kind] = dict(
            total_loss=[r["metrics"][1]["total_loss"] for r in runs],
            single_device_total_loss=metrics["total_loss"],
            weights_apart=[_weights_apart(r["weights"], weights)
                           for r in runs],
            ranks_agree=_weights_apart(runs[0]["weights"],
                                       runs[1]["weights"]) == 0.0)
    # The algorithm's own entry: PPO with a learner group of 2.
    def ppo_cfg(mesh=None):
        cfg = (PPOConfig().rollouts(num_rollout_workers=0,
                                    num_envs_per_worker=8,
                                    rollout_fragment_length=64)
               .training(train_batch_size=512, sgd_minibatch_size=128,
                         num_sgd_iter=4)
               .resources(device="cuda", rollout_device="cuda"))
        return cfg if mesh is None else cfg.resources(learner_mesh=mesh)
    t0 = time.perf_counter()
    group = ppo_cfg(MeshConfig(data=2)).build()
    build_s = time.perf_counter() - t0
    alone = ppo_cfg().build()
    try:
        t0 = time.perf_counter()
        rg = group.train()
        train_s = time.perf_counter() - t0
        ra = alone.train()
        out["ppo_train"] = dict(
            learner_group=type(group.learner).__name__, build_s=build_s,
            train_s=train_s, sampled_rows=[rg["sampled_rows"],
                                           ra["sampled_rows"]],
            total_loss=[rg["learner/total_loss"], ra["learner/total_loss"]],
            weights_apart=_weights_apart(group.learner.get_weights(),
                                         alone.learner.get_weights()))
        # The group's checkpoint restores one device, and one device's
        # restores the group (after another train()), to the bit.
        weights = group.learner.get_weights()
        alone.restore(group.save())
        group.train()
        group.restore(alone.save())
        out["ppo_train"]["restored_apart"] = [
            _weights_apart(ln.get_weights(), weights)
            for ln in (alone.learner, group.learner)]
    finally:
        group.stop()
        alone.stop()
    emit("rl_learner_dp", **out)
    for kind in specs:
        check(max(out[kind]["weights_apart"]) <= 1.0,
              f"rl_learner_dp: {kind} weights {out[kind]['weights_apart']} "
              f"of the tolerance")
        check(out[kind]["ranks_agree"], f"rl_learner_dp: {kind} ranks differ")
    check(out["ppo_train"]["learner_group"] == "LearnerGroup",
          "rl_learner_dp: PPO's learner is not a learner group")
    check(out["ppo_train"]["weights_apart"] <= 1.0,
          f"rl_learner_dp: PPO.train() weights "
          f"{out['ppo_train']['weights_apart']} of the tolerance")
    check(out["ppo_train"]["restored_apart"] == [0.0, 0.0],
          f"rl_learner_dp: save() / restore() across the learner group: "
          f"{out['ppo_train']['restored_apart']}")


# Two one-device references, on the same weights and batches.  "split"
# does the mesh step's arithmetic in one place (each half batch's bf16
# forward and backward alone, their f32 gradients averaged:
# rank_bodies._split_resnet_step), so the mesh is held to it tightly:
# RESNET_SPLIT_LOSS_TOL on the losses, RESNET_SPLIT_UPDATE_TOL on each
# leaf's update in L2 norm.  "whole" takes the 64 images at once; the
# half batches round apart from it in bf16, and AdamW's first steps move
# an element by about lr x sign(gradient), so elements whose gradient is
# below that rounding flip.  The split reference's own distance from
# the whole one measures that gap on one device, and the mesh is held
# to the whole one at RESNET_MESH_LOSS_TOL / RESNET_MESH_UPDATE_TOL,
# above that gap.  The same ranks then run with each rank's gradients
# left its own ("no_grad_sync"), which must break both sets of limits'
# loss or update check.  The card's readings (PERF.md), losses apart /
# largest leaf's update error: the mesh against split 0 / 0 (equal to
# the bit), against whole 0.0057 / 0.682, as far as split itself is
# from whole (to the last digit); the control 0.357 / 1.216 against
# split and 0.351 / 1.276 against whole (median leaf 0.87-0.91).
RESNET_SPLIT_LOSS_TOL = 1e-3
RESNET_SPLIT_UPDATE_TOL = 0.05
RESNET_MESH_LOSS_TOL = 0.05
RESNET_MESH_UPDATE_TOL = 0.85


def _resnet_readings(ranks: list, losses: list, ref: str) -> dict:
    """The readings of `ranks` (rank_bodies.resnet's outputs) against the
    one-device reference `ref` whose losses are `losses`."""
    loss_diff = max(abs(a - b) for r in ranks
                    for a, b in zip(r["losses"], losses))
    update_err, update_leaf = max(
        (err, f"rank {rank} {leaf}") for rank, r in enumerate(ranks)
        for leaf, err in r["update_rel_err"][ref].items())
    errs = sorted(((err, leaf) for leaf, err in
                   ranks[0]["update_rel_err"][ref].items()), reverse=True)
    kinds: dict = {}
    for err, leaf in errs:
        kinds.setdefault(leaf.split(".")[-1], []).append(err)
    return dict(losses=ranks[0]["losses"], max_loss_diff=loss_diff,
                max_update_rel_err=update_err,
                max_update_rel_err_at=update_leaf,
                rank0_update_rel_err_top=errs[:6],
                rank0_update_rel_err_by_kind={
                    k: dict(n=len(v), max=max(v),
                            median=statistics.median(v))
                    for k, v in kinds.items()})


def _resnet_mesh(data: dict, control: str) -> dict:
    """resnet50 (bf16 convolutions and norms, fp32 params) on
    MeshConfig(data=2) against one device on the same weights and the
    batches `data` draws, taking the two row halves apart as the ranks
    split them ("split", `rank_bodies._split_resnet_step`) and the whole
    batch at once ("whole"); then the same ranks again with `control`,
    which the checks must catch.  Returns the readings."""
    from ray_tpu_torch.models import resnet
    from ray_tpu_torch.parallel import rank_bodies

    config = resnet.CONFIGS["resnet50"]
    singles = {}
    with tempfile.TemporaryDirectory() as tmp:
        paths = {ref: os.path.join(tmp, f"{ref}.pt")
                 for ref in ("whole", "split")}
        for ref, split, refs in (("whole", 1, None),
                                 ("split", 2, {"whole": paths["whole"]})):
            gc.collect()
            torch.cuda.empty_cache()
            singles[ref] = rank_bodies.resnet(
                0, 1, None, config, data, 1e-4, "cuda", None, refs,
                paths[ref], None, split)
        gc.collect()
        torch.cuda.empty_cache()
        args = (dict(data=2), config, data, 1e-4, "cuda", None, paths)
        t0 = time.perf_counter()
        ranks = _ranks(2).run(rank_bodies.sequence, [
            ("resnet", args), ("resnet", args + (None, control))])
        wall_s = time.perf_counter() - t0
    sound, faulted = [r[0] for r in ranks], [r[1] for r in ranks]
    limits = {"split": (RESNET_SPLIT_LOSS_TOL, RESNET_SPLIT_UPDATE_TOL),
              "whole": (RESNET_MESH_LOSS_TOL, RESNET_MESH_UPDATE_TOL)}
    readings = {ref: dict(
        loss_tolerance=limits[ref][0], update_tolerance=limits[ref][1],
        losses=singles[ref]["losses"],
        sound=_resnet_readings(sound, singles[ref]["losses"], ref),
        **{control: _resnet_readings(faulted, singles[ref]["losses"], ref)})
        for ref in ("split", "whole")}
    return dict(
        config="resnet50", mesh=dict(data=2), global_batch=data["batch"],
        image=data["image"], steps=data["steps"],
        losses=sound[0]["losses"], vs=readings,
        split_vs_whole=_resnet_readings([singles["split"]],
                                        singles["whole"]["losses"], "whole"),
        ranks_agree=sound[0]["digest"] == sound[1]["digest"],
        started_alike=not any(r["start_differs"] for r in sound),
        median_step_ms=statistics.median(r["median_step_ms"]
                                         for r in sound),
        single_device_step_ms=singles["whole"]["median_step_ms"],
        split_step_ms=singles["split"]["median_step_ms"],
        peak_memory_gib_by_rank=[r["peak_memory_gib"] for r in sound],
        single_device_peak_memory_gib=singles["whole"]["peak_memory_gib"],
        ranks_wall_s=wall_s)


def _resnet_faults(out: dict, control: str, against=("split", "whole")):
    """What `_resnet_mesh`'s readings fail: the sound run within both
    limits, the control outside those of each reference in `against`."""
    faults = []
    for ref, r in out["vs"].items():
        got = r["sound"]
        if not got["max_loss_diff"] <= r["loss_tolerance"]:
            faults.append(f"losses {got['losses']} vs one device ({ref}) "
                          f"{r['losses']}")
        if not got["max_update_rel_err"] <= r["update_tolerance"]:
            faults.append(f"update of {got['max_update_rel_err_at']} "
                          f"{got['max_update_rel_err']} vs one device "
                          f"({ref})")
        bad = r[control]
        if ref in against and not (
                bad["max_update_rel_err"] > r["update_tolerance"]
                or bad["max_loss_diff"] > r["loss_tolerance"]):
            faults.append(f"the {control} control passed against one "
                          f"device ({ref}): {bad}")
    if not out["started_alike"]:
        faults.append("a rank started from other weights")
    if not out["ranks_agree"]:
        faults.append("the replicas differ")
    return faults


def phase_train_resnet_mesh() -> None:
    """resnet50 at train_resnet's batch (64 x 224 x 224 x 3, bf16
    convolutions and norms, fp32 params) on MeshConfig(data=2): two
    ranks of 32 images each, 3 AdamW(1e-4) steps on batches drawn from
    a seed, against one device on the same weights and batches, taking
    the two half batches apart ("split") and the 64 images at once
    ("whole"): the losses and each leaf's update (L2 norm) within the
    limits above, and the two ranks' params equal to the bit (a
    sha256).  The same ranks then run it again with each rank's
    gradients left its own, which the checks must catch."""
    out = _resnet_mesh(dict(seed=1, steps=3, batch=64, image=[224, 224, 3]),
                       "no_grad_sync")
    emit("train_resnet_mesh", **out)
    for fault in _resnet_faults(out, "no_grad_sync"):
        check(False, f"train_resnet_mesh: {fault}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 1
    from ray_tpu_torch.ops import _build

    smi = smi_line()
    t0 = time.perf_counter()
    built = _build.build_all()
    emit("device", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(),
         built=[p.name for p in built], build_s=time.perf_counter() - t0)
    report: dict = {}
    phases = (("kernels", phase_kernels), ("flash", phase_flash),
              ("serve", phase_serve), ("train", phase_train),
              ("parity", lambda _: phase_parity()),
              ("train_parity", lambda _: phase_train_parity()),
              ("serve_llama", phase_serve_llama),
              ("train_llama", phase_train_llama),
              ("llama_parity", lambda _: phase_llama_parity()),
              ("serve_spec", phase_serve_spec),
              ("spec_parity", lambda _: phase_spec_parity()),
              ("spec_model_draft", phase_spec_model_draft),
              ("logp", lambda _: phase_logp()),
              ("serve_disagg", phase_serve_disagg),
              ("disagg_parity", lambda _: phase_disagg_parity()),
              ("kv_tier", phase_kv_tier),
              ("train_moe", phase_train_moe),
              ("moe_parity", lambda _: phase_moe_parity()),
              ("train_fabric", phase_train_fabric),
              ("train_resnet", lambda _: phase_train_resnet()),
              ("rl_rollout", phase_rl_rollout),
              ("rl_learner", lambda _: phase_rl_learner()),
              ("rl_podracer", lambda _: phase_rl_podracer()),
              ("rl_parity", lambda _: phase_rl_parity()),
              ("rl_continuous", lambda _: phase_rl_continuous()),
              ("rl_offpolicy", lambda _: phase_rl_offpolicy()),
              ("rl_recurrent", lambda _: phase_rl_recurrent()),
              ("rl_breadth_parity", lambda _: phase_rl_breadth_parity()),
              ("rl_offline", lambda _: phase_rl_offline()),
              ("rl_multi_agent", lambda _: phase_rl_multi_agent()),
              ("rl_tune", lambda _: phase_rl_tune()),
              ("rl_offline_parity", lambda _: phase_rl_offline_parity()),
              ("rl_es", lambda _: phase_rl_es()),
              ("rl_es_parity", lambda _: phase_rl_es_parity()),
              ("pipeline", phase_pipeline),
              ("pipeline_parity", lambda _: phase_pipeline_parity()),
              # The mesh phases by rank count, 8, then 2, then 4: a gang
              # stays up across phases of its size, and a fresh one takes
              # ~30 s (spawn, imports, CUDA contexts, lazy kernel loads).
              ("train_mesh", phase_train_mesh),
              ("rl_learner_dp", lambda _: phase_rl_learner_dp()),
              ("train_resnet_mesh", lambda _: phase_train_resnet_mesh()),
              ("train_mesh_uneven", phase_train_mesh_uneven),
              ("train_mesh_llama", phase_train_mesh_llama),
              ("train_mesh_seq", phase_train_mesh_seq),
              ("train_mesh_seq_llama", phase_train_mesh_seq_llama),
              ("train_mesh_moe", phase_train_mesh_moe),
              ("pipeline_spmd", phase_pipeline_spmd),
              ("train_mesh_stage", phase_train_mesh_stage),
              ("train_7b", phase_train_7b))
    # Run only when named: they need four cards.
    opt_in = (("train_7b_cards", phase_train_7b_cards),)
    wanted = sys.argv[1:]
    if wanted:
        phases += opt_in
    unknown = set(wanted) - {name for name, _ in phases}
    if unknown:
        print(f"chip_smoke: no phase {sorted(unknown)}", file=sys.stderr)
        return 2
    start = time.perf_counter()
    try:
        for name, phase in phases:
            if wanted and name not in wanted:
                continue
            t0 = time.perf_counter()
            phase(report)
            emit("wall", of=name, seconds=time.perf_counter() - t0)
    finally:
        _ranks.close()
    emit("wall", of="all phases", seconds=time.perf_counter() - start)
    print(json.dumps({"kernels": list(report.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
