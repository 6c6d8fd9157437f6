#!/usr/bin/env python3
"""Runs the PyTorch port (src/repro_torch) on one NVIDIA GPU and checks it.

    python3 chip_smoke.py [--seed N]

Phases, in order; any failure ends the run with a non-zero exit:

1. Build the CUDA kernels from src/repro_torch/kernels/csrc for sm_90a (one
   nvcc per source, in parallel), print each kernel's registers and spills
   as ptxas reports them and mla_decode's dynamic shared memory, and print
   the card's name and power limit.
2. Hold each kernel against its plain PyTorch version on the card, in bf16
   and f32: score_ce at gpt2-base's shapes (T = 272 and 7952, D = 768,
   V = 50257), at T = 1 and 273 (one row; one past a 128-row tile), at
   rwkv6-7b's (D = 4096, V = 65536) and deepseek-v2's (D = 5120, V = 102400)
   at T = 272 and 7952, with labels 0, V - 1 and inside the ragged last
   vocabulary tile; flash_attention at the scoring shapes and at the edges of its
   64-row tiles (S = 1, 65 and 513, q_offset > 0, a window edge inside a
   tile, GQA, non-causal with a short kv_len); flash_decode at qwen2-7b's
   serve shape (the whole cache and a ragged kv_len), at kv_len 1, 63, 64
   and 65, at G = 1, 4, 7, 8 and 16, hd = 64 and 128, with windows, with
   q_pos < kv_len - 1, and with empty partitions; rwkv6_wkv at B*H = 1 and
   1024, T = 1, 15, 16, 17, 33 and 513 (the bf16 kernel's 16-token
   sub-chunk and its edges), from a zero and a given state, with the
   model's decays, none (logw = 0) and steep ones (logw = -e^4 in every
   step), and with rows not 16 bytes aligned. At head dim 112 (zamba2-7b)
   too: flash_attention at its lookup shapes (B = 16, MHA 32 heads, S = 33
   and 513), S = 1 and 65, q_offset > 0, a window edge inside a tile,
   G = 4, non-causal; flash_decode at its serve shape (B = 8, G = 1, the
   whole cache and ragged), kv_len 1, 63, 64 and 65, G = 4 and 8, a
   window, q_pos < kv_len - 1 and empty partitions; score_ce at D = 3584,
   V = 32000, T = 272 and 7952. The last three dense configs' shapes:
   score_ce at (D, V) = (6144, 92544), (5120, 100352) and (12288, 256000),
   T = 272 and 7952; flash_attention at GQA groups 4, 6 and 12 (hd 128),
   and at B = 1, H = 28, Hkv = 4, S = L = 32768 held in slices of 1024
   queries. seamless-m4t-medium's: score_ce at D = 1024, V = 256206 (a
   ragged last vocabulary tile), T = 272 and 7952; flash_attention not
   causal over 1024 frames and at 33, 513 and 70 queries against 1024 and
   1000 rows. bf16 flash_attention is held to flash_decode's bound (rtol
   1e-2, atol 1e-3 x max |plain|). (2t) Timed apart: flash_attention at
   the GQA groups 6, 4 and 12 at B = 16, S = 33 and 513, and score_ce at
   one 2048-position chunk of prefill_32k (D = 3584, V = 152064), each
   beside its plain version, the library call and the bound.
   tools/flash_attention_variants.py compares the kernel with its one-term
   P·V variant (one bf16 P, the kernel before P was split). (2v) Head dim
   256 (paligemma-3b: 8 query heads over one kv-head), in bf16 and f32,
   each case held against its plain version and timed beside it, one SDPA
   call and the bound: flash_attention causal at B = 16 and the lookups'
   own lengths (289 and 769: 256 image patches, 16 prompt positions, 17 or
   497 tokens), S = L = 127 and 129, kv_len and a window edge inside a
   tile, not causal with S > L; flash_decode at decode_32k (B = 16, kv_len
   32767) with auto_splits and with one split, and at kv_len 937 of 1000.
3. The Prompt Bank lookup at full width: gpt2-base in bf16 with weights from
   --seed, 48 tasks x 4 jittered seed prompts = 192 candidates, activation
   features, a bank of 48 clusters, then three lookup requests (33, 33 and
   513 positions). Each kernel's launch count over this phase must be > 0;
   the counts are kept by request shape (here and in phases 7 and 8e).
4. Rescore a few candidates through the port on the CPU in f32 (plain
   versions) and hold the card's scores against them.
5. Time score_ce and flash_attention with CUDA events beside their plain
   versions, one PyTorch library call computing the same function, and
   their bounds (score_ce also beside the bare h @ E.T product, cuBLAS, as
   a yardstick for its main loop), with the grid, block, registers and
   shared memory of what each launches; then profile one Eqn-1 evaluation
   (host wall clock against device busy time).
6. The serve step on qwen2-7b at full width, bf16, weights from --seed:
   (a) teacher-forced decode of 32 tokens from an empty cache against the
   forward pass; (b) the decode_32k cache cut from batch 128 to 16, its
   first 32760 slots filled with seeded K/V, then 8 serve steps, with
   flash_decode launched 28 times a step; flash_decode's times at that
   shape and the profile of one step; (c) a 2-layer cut of the same weights
   in f32, card against CPU, on 4 decode steps.
7. rwkv6-7b at full width, bf16, weights from --seed: a bank of 24 tasks x
   2 variants = 48 candidates in 12 clusters and three lookups (33, 33 and
   513 positions), with rwkv6_wkv and score_ce launched; rwkv6_wkv's and
   score_ce's times at the lookup's shapes and what they launch, and the
   profile of one evaluation; 16 teacher-forced decode steps against the
   forward in f32: at 32 layers layer by layer (each layer fed
   the forward's input), beside how a WKV summation-order difference grows
   with depth; end to end on a 2-layer cut; that 2-layer cut, card against
   CPU, on Eqn-1 scores.
8. deepseek-v2-236b (MLA + MoE) at full width, bf16, weights from --seed,
   cut in depth to 1 dense + 8 MoE layers (7 if 8 leave under 6 GiB free):
   (a) mla_decode against its plain version in bf16 and f32 at H = 128, 64,
   40 and 16, B = 1, 2, 3 and 16, kv_len 1, 37, ragged and whole, at the
   bf16 kernel's 64-row tile's edges (63, 64, 65) and over both of its ring
   stages in one split, with every split one row, with q_pos < kv_len - 1,
   and with ckv and kpe as views of one wider row; a view TMA cannot load
   refused; its times, beside the plain version, one SDPA call and the
   bound, and what it launches, at the decode_32k (B = 16) and long_500k
   (B = 1) shapes; (b) the
   decode_32k cache cut from batch 128 to 16, its first 32760 slots seeded,
   then 8 serve steps with mla_decode launched once a layer, and the profile
   of one step; (c) teacher-forced decode of 32 tokens against the forward,
   the pairs dropped at the real capacity factor, and the routing flips;
   (e) one Eqn-1 Prompt Bank lookup (48 candidates, 12 clusters, 33
   positions) through score_ce, and score_ce's times at 33 and 513
   positions' shapes (T = 272 and 7952); (d) a
   2-layer f32 cut of the same weights, card against CPU, on 4 decode
   steps.
9. Tuning (run after phase 7 and before phase 8's model is drawn):
   (a) the backward kernels of score_ce and flash_attention against their
   plain versions in bf16 and f32 (flash_attention: GQA 28/4 at hd 128 and
   MHA at hd 64, causal, windowed, q_offset > 0, kv_len < L, S not a tile
   multiple, rows with nothing live, vicuna-7b's 4112 positions, and the
   bf16 kernel's edges: S = L = 127, 128, 129, 257 around its 128-row KV
   tile, a GQA group of 7, a window and kv_len ending inside a KV tile; at
   head dim 112 (zamba2-7b, the bf16 kernel padded to 128) its tuning
   shape B = 8, H = 32, S = 33, S = L = 513 and 4112, and S = 127, 129, 257
   and a window and kv_len ending inside a tile; seamless-m4t-medium's
   cross attention, not causal, B = 2, H = 16, S = 4112 against L = 1024
   and S = 33 against L = 1000 with kv_len 937, each of these also timed
   beside SDPA's backward; score_ce: gpt2-base's, vicuna-7b's and deepseek-v2's (D, V), T = 1, 64,
   65, 128, 129, 136, 272, 273, 512 and 8192, masked tokens, two and four
   vocabulary chunks), each twice: dk, dv, f32 dq and score_ce's gradient
   must be bitwise equal between the two calls, and the largest bf16 dq
   difference (atomic adds in a scheduling-dependent order) is printed; the
   forwards' log-sum-exp against the plain one and their output unchanged
   by writing it; both backward kernels' times beside their plain versions,
   the library's backward and their bounds, and the kernels each bf16
   backward launches, which must all be the port's own (no cuBLAS, cuDNN or
   CUTLASS kernel); (b) ten Adam steps of a 2-layer f32 cut of gpt2-base, card
   against CPU from one state; (c) gpt2-base at full width (bf16, weights
   from --seed): PromptTuner.tune for 40 iterations at TuneConfig's
   defaults, then from the tuned prompt with a target above the first
   evaluation, which must end at 0 iterations, and one step profiled;
   (d) vicuna-7b at full width: 3 make_train_step steps at train_4k (4096
   tokens + 16 prompt positions) with the global batch cut from 256 to 2 (2
   microbatches), its peak memory and one step profiled, and the first
   microbatch's prompt gradient in bf16 against f32 on a 4-layer cut; (e)
   run inside phase 7, on its rwkv6-7b before that model is freed:
   rwkv6_wkv_bwd against its plain version in bf16 and f32 (B*H = 1 and the
   tuning shape 8 x 64, T = 1, 15, 16, 17, 31, 32, 33 and 529, with and
   without a start state and dS_T, the model's decays, none, steep ones,
   steep in half the channels and ones just inside the bf16 kernel's guard,
   rows not 16 bytes apart), each twice and bitwise equal, its kernels all
   its own, and its times beside the plain version and the bound; ten Adam steps of a
   2-layer f32 cut, card against CPU; PromptTuner.tune at full width for 10
   iterations at TuneConfig's defaults, every iteration finite and
   rwkv6_wkv_bwd launched 32 times a step, its peak memory and one step
   profiled; (f) gpt2-base at full width (bf16, tied), after (c): score_ce's
   embedding gradient dE against its plain version in bf16 and f32 (T = 1,
   136, 512, 544 and 8192, masked tokens, two, four and seven vocabulary
   chunks), bitwise repeatable, its kernels all the port's, its time beside
   the plain version, the library's backward and the bound; five joint
   pretraining steps of a 2-layer f32 cut, card against CPU; pretrain for
   20 steps at the reference's batch 32 and prompt_len 8, its peak memory
   and one step profiled; a checkpoint written and read back bitwise; the
   Prompt Bank built from the result and one lookup. On (c), (d), (e) and
   (f) every kernel of the path must be launched and no plain version may
   run.
10. The service's front door (run after phase 5, on phase 3's model and
   bank; examples/quickstart.py, steps 2-5): a PromptTunerService (two
   shards, the elastic control plane) over phase 3's bank less the
   requested tasks' own candidates, its scorer make_score_fn on the card;
   a first wave of gpt2-base requests from two tenants in three classes:
   the routed ones' lookups against direct lookups and the CPU f32 path,
   one SLO below the latency budget (not routed, no kernel launched), one
   unknown LLM (KeyError); PromptTuner.tune from two routed requests' bank
   prompts and from manual ones to one target; follow-ups carrying the
   tuned prompts, their activation features and measured ITAs; after
   run_until_idle the bank must have grown by the completed follow-ups
   (origins ".../online") and a lookup on it runs on the card; the
   simulated schedule (telemetry on) must equal a second service's on the
   CPU with no bank and telemetry off; (e) the telemetry plane's record of
   the run: completed jobs counted, each routed handle's timeline done with
   queued and running spans, the SLO-attainment report and the forensics
   printed, the Chrome trace and JSONL exports written to a temporary
   directory, the trace validated by `python -m repro_torch.obs --validate`
   and the JSONL export rendering the same report and forensics; then one
   routed submit on a second service, its host wall against device busy.
   score_ce and flash_attention must be launched on the lookups, and
   their backward kernels on the tuning, with no plain version run. The
   simulated summaries and reports come from LLM_PROFILES, the paper's A100
   figures.

11. zamba2-7b (run last, after phase 8) at full width and depth, bf16,
   weights from --seed: 81 Mamba2 layers in 14 segments, one shared
   attention + MLP block (32 heads of 112) applied after each of the first
   13, 6.64 B parameters. (a) A bank of 24 tasks x 2 variants = 48
   candidates in 12 clusters and three lookups (33, 33 and 513 positions),
   flash_attention launched 13 times an evaluation and score_ce at
   D = 3584, V = 32000, no plain version run; one evaluation profiled;
   flash_attention and score_ce timed at its shapes. (e) Three
   PromptTuner.steps at TuneConfig's defaults (batch 8 x 33 positions) from
   a bank prompt: flash_attention_bwd (hd 112) launched 13 times a step,
   the Mamba2 blocks' backward through autograd, no plain version run; the
   first step's backward calls held against the plain backward; one step
   profiled; the first batch's prompt gradient in bf16 against the same
   weights in f32, within HYBRID_PLAIN_FACTOR of the same gap with the
   attention's forward and backward replaced by their plain versions.
   (b) Teacher-forced decode of 32
   tokens against the forward: block by block in bf16 and f32, end to end
   in f32, and end to end in bf16 within HYBRID_PLAIN_FACTOR of the same
   gap with both attention kernels replaced by their plain versions. (c) decode_32k with
   the batch cut from 128 to 8 (13 K/V caches of 32768 tokens, 48.9 GB),
   its first 32760 slots and the Mamba2 states seeded, 8 serve steps with
   flash_decode launched 13 times a step and no plain version run;
   flash_decode timed at that shape; one step profiled. (d) A 7-layer f32
   cut (6 + 1 Mamba2 layers, one shared application), card against CPU:
   Eqn-1 scores of 4 candidates, 4 decode steps, the tuning batch's loss
   and prompt gradient.

12. The last three dense configs at full width, bf16, weights from --seed
   (after phase 11): internlm2-20b (48 layers) and phi3-medium-14b (40) at
   full depth, command-r-plus-104b (LayerNorm, parallel block, tied) cut
   from 64 to 16 layers. Each: a bank of 48 candidates in 12 clusters,
   lookups at 33 and 513 positions with flash_attention launched once a
   layer per evaluation and no plain version run, one evaluation profiled,
   peak memory, score_ce timed at its (D, V), and a 2-layer f32 cut, card
   against CPU, on Eqn-1 scores.
13. qwen2-7b at full width and depth, bf16: (a) prefill_32k through
   make_prefill_step with the batch cut from 32 to 4 (32768 tokens and a
   16-position prompt a row): flash_attention once a layer, the
   per-example losses, example 0 held against the same step with its
   attention through the f32 kernel, the step profiled, its peak memory,
   and flash_attention at B = 1, S = L = 32768 held in slices and timed;
   (b) long_500k through model_for_shape (an 8192-token window): the ring
   seeded with K/V at the positions it holds at cache_len 524280, 8 serve
   steps to position 524287 on the masked path (no attention kernel), each
   layer's masked attention held against flash_attention (window 8192,
   q_offset, 64 stale rows before the window) on the same K/V in position
   order, one step profiled.

14. seamless-m4t-medium (after phase 13) at full width and depth, bf16,
   weights from --seed: 12 encoder + 12 decoder layers with cross
   attention, d = 1024, 16 heads of 64, V = 256206 tied, an audio frontend
   stub of 1024 frames x 1024, 0.62 B parameters. (a) flash_attention not
   causal (the encoder, S = L = 1024; the cross attention, S = 33 and 513
   against 1024), flash_decode (decode_32k at B = 16, and against the 1024
   cross rows) and score_ce (T = 272 and 7952) held against their plain
   versions and timed beside them, the library call and the bound; (b) a
   bank of 48 candidates in 12 clusters (features on the reference's zero
   frontend) and two select_score lookups (33 and 513 positions), each
   evaluation's batch carrying a seeded frontend: flash_attention launched
   36 times an evaluation (encoder, self and cross), no plain version run,
   each distinct call held against the plain version at its strides, one
   evaluation profiled; (c) 8 serve steps at decode_32k with the batch cut
   from 128 to 16, the self-attention cache seeded and the cross cache
   filled from encode + encode_cross_kv on a seeded frontend, flash_decode
   launched 24 times a step (self and cross) and the cross cache left
   unwritten; one step profiled; one step on the zero cross cache the
   reference leaves; teacher-forced decode of 32 tokens against the
   forward, held layer by layer and end to end; (d) make_train_step at
   train_4k (256 rows of 4096 tokens + 16 prompt positions, microbatches of
   8, a seeded 1024 x 1024 f32 frontend in every row), a warm-up and two
   steps, and three PromptTuner.steps at batch 8 x 33: flash_attention_bwd
   launched 24 times a microbatch (self and cross, the cross attention not
   causal at S = 4112 against L = 1024), never at the encoder's S = L =
   1024, no plain version run; each first step's backward calls held
   against the plain backward; the first microbatch's prompt gradient in
   bf16 against f32 on a 4 + 4-layer cut; a 2 + 2-layer f32 cut, card
   against CPU, on the Eqn-1 loss with a seeded frontend, 4 decode steps,
   and the loss and prompt gradient of a train_4k row's first 1024 tokens
   and of the tuning batch.

15. paligemma-3b (after phase 14) at full width and depth, bf16, weights
   from --seed: 18 layers, d = 2048, 8 heads of 256 over one kv-head, GELU,
   V = 257216 tied, a vision frontend stub of 256 patches x 1152 prepended
   to the sequence; 1.907 B parameters. (a) score_ce at (D, V) = (2048,
   257216), T = 272 and 7952, timed beside its plain version, the library
   call and the bound (the hd-256 attention kernels are held and timed in
   2v); (c) teacher-forced decode of 32 text tokens against the forward;
   (d) a bank of 48 candidates in 12 clusters (features on the reference's
   zero frontend) and two select_score lookups (33 and 513 positions after
   the image) whose evaluations carry a seeded (16, 256, 1152) f32 image:
   flash_attention launched 18 times an evaluation, no plain version run,
   each distinct call held against the plain version at its strides; the
   Eqn-1 scores of two entries at full depth against the CPU's f32 path on
   2 eval rows with their image rows; (g) one evaluation profiled; (f) 8
   serve steps at decode_32k's full batch of 128 (77.3 GB of K/V, the
   first 32760 slots seeded): flash_decode launched 18 times a step, no
   plain version run, layer 0's own call of the last step held against the
   plain version on 8 batch rows, one step profiled, the peak memory, and
   flash_decode timed at that shape; (e) a 2-layer f32 cut, card against
   CPU: the logits of one row of [image][prompt][tokens] and 4 decode
   steps.

Each model is freed before the next is drawn. The line before the last is
{"kernels": [...]}, each kernel's numbers at the first shape of its paths
(the others under "shapes") and its launches in all and by path and shape;
the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent

# H100 SXM published dense peaks (NVIDIA data sheet) at the 700 W limit.
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12       # f32 on the CUDA cores, outside the tensor cores
PEAK_TF32_FLOPS = 495e12     # TF32 on the tensor cores
PEAK_BYTES = 3.35e12

TOL = {torch.bfloat16: 3e-2, torch.float32: 2e-5}   # tolerances of tests/test_kernels.py
# flash_decode in bf16 against its plain version. Both widen bf16 exactly, sum
# in f32 and round the output to bf16 once, so they differ by about one unit
# in its last place (2^-7 relative) beyond f32 noise. An output averages up to
# 32768 rows, so |out| is near 0.01 at the serve shape and an absolute 3e-2
# would pass a lost split; the bound is scaled to the output instead.
DECODE_BF16_RTOL = 1e-2
DECODE_BF16_ATOL = 1e-3        # times max |plain output|
# flash_attention in bf16 is held to the same bound. The kernel keeps P in f32
# to 2^-16 (P_hi + P_lo, csrc/flash_attention.cu), so it and the plain version
# differ by f32 rounding before each rounds its output to bf16 once: at most
# one unit in the last place, 2^-7 relative, below DECODE_BF16_RTOL. One bf16
# P (2^-8 of each probability) left gaps of 1.6e-2 on outputs near 1 at 513
# positions.
# Eqn-1 scores, card against the CPU f32 path with the same weights (phase 4).
# bf16 rounds every activation, so it is held loosely; the kernels keep logits
# and softmax in f32, so the gap is set by the bf16 residual stream.
BF16_SCORE_RTOL = 1e-3
F32_SCORE_RTOL = 1e-5    # card f32 (kernels) against CPU f32 (plain versions)
# rwkv6_wkv against its plain version, for bf16 and f32 inputs alike: bf16 is
# widened exactly and both compute in f32, but the kernel sums a token's 64
# keys in another order and carries its state through up to 513 tokens.
WKV_TOL = {torch.bfloat16: 1e-4, torch.float32: 1e-4}
# Teacher-forced decode against the forward pass, bounded on
# ||decode - forward|| / ||forward|| over all logits. In bf16 (qwen2-7b) the
# two round to 8 bits at other places (one-row against 32-row products, P in
# f32 against bf16) and 28 random layers compound that. A random RWKV6
# stack amplifies a perturbation layer by layer, so its end-to-end check is
# held on the 2-layer cut in f32, and at full depth layer by layer.
DECODE_REL_TOL = {torch.bfloat16: 0.05, torch.float32: 1e-3}
# rwkv6-7b at full depth in f32: each layer's one-token decode steps, fed
# the forward's input to that layer, against the layer's forward output,
# bounded on ||decode - forward|| / ||layer increment||. Nothing carries from
# layer to layer, so only f32 summation order separates the two.
LAYER_DECODE_TOL = 1e-4
# zamba2-7b's decode against its forward (phase 11b). tools/hybrid_depth_growth.py,
# in f32 on the CPU at 81 layers: the decode's and the forward's hidden states
# part by 3.0e-6 after all 94 blocks at d_model 512 and by 6.5e-6 at 1024,
# 10 to 60 times one block's gap (5e-8 and 6.6e-7), which stays below 9e-7 in
# every block. bf16 rounds each block's output to 2^-8, and that gap grows
# alike through the 94 blocks: the bf16 logits part by about 0.05 on an H100
# 80GB HBM3, too near DECODE_REL_TOL to be held end to end. So each block is
# held, fed the forward's own input (LAYER_DECODE_BF16_TOL in bf16,
# LAYER_DECODE_TOL in f32), and the teacher-forced decode end to end in f32 at
# DECODE_REL_TOL, 150 times the gap measured at d_model 1024. The bf16 gap end
# to end is held against a witness: the same decode and forward with
# flash_attention and flash_decode replaced by their plain versions (f32
# softmax, P never rounded to bf16) must part by at least 1 / HYBRID_PLAIN_FACTOR
# of the kernels' gap. Rounding noise that the Mamba2 blocks add (the chained
# gap is about 9e-3 after the first six blocks, before any attention runs)
# leaves the two within a factor of each other; a fault of a kernel widens it.
HYBRID_PLAIN_FACTOR = 2.0
# Decode logits of the 2-layer f32 cut, card against CPU: both f32, sums of
# up to 18944 terms in another order.
F32_LOGIT_TOL = 1e-4
# deepseek-v2 decode against the forward in bf16 (phase 8c), with a capacity
# factor of E / k so that nothing drops in either. A bf16 difference between
# the two can flip a near-tie in a token's top-6 of 160 router
# probabilities, which changes that token's layer output by far more than
# rounding does, so both checks are held on the tokens whose routing
# matched. Layer by layer (each layer fed the forward's own input, so no
# difference carries between layers): ||decode - forward|| over the layer's
# increment, at most LAYER_DECODE_BF16_TOL in every layer. End to end:
# DECODE_REL_TOL on the logits of the tokens whose routing matched in every
# MoE layer, which must be at least MIN_CLEAN_TOKENS of the tokens, and at
# most MAX_FLIP_SHARE of the (token, layer) routings may differ (a decode
# that routed on wrong inputs would differ in nearly all). bf16 rounding
# flips about a fifth of the routings by layer 9 (PERF.md).
LAYER_DECODE_BF16_TOL = 0.05
MIN_CLEAN_TOKENS = 0.1
MAX_FLIP_SHARE = 0.5
# The backward kernels against their plain versions (phase 9a). bf16: the
# kernels round P and dS (flash_attention) or G = g·(softmax - onehot)
# (score_ce) to bf16 before their products, as the reference's XLA backward
# rounds to the operands' type, and the plain versions stay in f32; a
# gradient element that sums to near 0 keeps an absolute error set by its
# row's scale, so atol is scaled to the largest gradient element. f32: the
# same arithmetic in another order (sums of up to 7 heads x 4112 rows, or
# 32000 vocabulary columns).
BWD_RTOL = {torch.bfloat16: 3e-2, torch.float32: 2e-5}
BWD_ATOL = {torch.bfloat16: 1e-2, torch.float32: 2e-5}   # times max |plain gradient|
# Ten Adam steps of the 2-layer f32 cut of gpt2-base, card against CPU (phase
# 9b): the losses at the f32 scoring tolerance, the prompt after each step
# by relative norm at the port's CPU parity tolerance for gradients (sums
# of up to 50257 terms in another order; Adam scales each element by its
# own running gradient size, which carries that rounding into the update).
TUNE_F32_LOSS_RTOL = 1e-5
TUNE_F32_PROMPT_TOL = 1e-4
# The rwkv6_wkv backward against its plain version (phase 9e), relative to
# the plain gradient's largest element: f32 sums in another order; bf16
# rounds dr, dk and dv to bf16 once (dlogw, du and dS_0 stay f32).
WKV_BWD_TOL = {torch.bfloat16: 3e-2, torch.float32: 2e-5}
# Five joint pretraining steps of the 2-layer f32 cut of gpt2-base, card
# against CPU (phase 9f): the losses at the f32 scoring tolerance, every
# weight and the prompt table after each step by relative norm at the
# tuning tolerance (Adam moves every weight, each by its own scale). The
# key biases are the exception: a shift of every key's score leaves the
# softmax unchanged, so their gradient is exactly 0 and what each package
# computes for it is rounding; Adam scales that to steps of about lr in
# either sign. They are held only to differ by less than twice the sum of
# the learning rates.
PRETRAIN_F32_LOSS_RTOL = 1e-5
PRETRAIN_F32_WEIGHT_TOL = 1e-4
ZERO_GRADIENT_LEAVES = (".bk",)
# vicuna-7b's first train_4k step (phase 9d): the prompt gradient in bf16
# against the same step in f32 on a depth cut, by relative norm. bf16 rounds
# every activation and every saved tensor of 4112 positions to 8 bits, a
# few dozen roundings a layer that add up like a random walk.
GRAD_BF16_REL_TOL = 0.05


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


SPIN_CYCLES = 20_000_000   # ~10 ms of GPU clock: longer than any call's host-side work


def time_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median device time of one call over ``reps`` CUDA-event timings.

    A spin kernel holds the stream busy while the host enqueues the start
    event, the call and the end event, so the events bracket the device
    work alone and not the host's launch overhead (which phase 5's
    per-evaluation profile reports)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def check_close(name: str, out: torch.Tensor, ref: torch.Tensor, tol: float,
                atol: float | None = None) -> float:
    """Max abs error of ``out`` against ``ref``; raises past rtol = tol and
    atol (= tol unless given)."""
    out, ref = out.float(), ref.float()
    atol = tol if atol is None else atol
    err = (out - ref).abs()
    if not torch.isfinite(out).all() or (err > atol + tol * ref.abs()).any():
        raise AssertionError(f"{name}: kernel disagrees with its plain version "
                             f"(max abs err {err.max().item():.3e}, rtol {tol}, atol {atol:.2e})")
    return err.max().item()


# -- phase 1 --------------------------------------------------------------------

def phase_build() -> str:
    """Returns the card's name and power limit."""
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    libs = _build.build()
    print(f"[1] built {sorted(libs)} for sm_90a in {time.perf_counter() - t0:.1f} s")
    for name, so in sorted(libs.items()):
        log = so.with_suffix(".log").read_text() if so.with_suffix(".log").exists() else ""
        entry = ""
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]                 # the mangled kernel name
            elif "registers" in line or "spill" in line:
                print(f"[1] ptxas {name} {entry}: {line.strip()}")
    mla = _build.load("mla_decode")
    print(f"[1] mla_decode dynamic shared memory: bf16 {mla.mla_decode_smem_bytes(1)} B, "
          f"f32 {mla.mla_decode_smem_bytes(0)} B a block")
    card = gpu_line()
    print(card)
    return card


def fa_bf16_bound(ref: torch.Tensor):
    """flash_attention's bf16 bound: DECODE_BF16_RTOL and DECODE_BF16_ATOL
    times the plain output's largest element."""
    return DECODE_BF16_RTOL, DECODE_BF16_ATOL * ref.float().abs().max().item()


SLICE_ROWS = 1024
# The plain version's f32 scores of one hold_recorded chunk: at most 2 GiB.
PLAIN_SCORE_BYTES = 1 << 31


def sliced_attention_check(label: str, q, k, v, out=None) -> dict:
    """flash_attention, causal at S = L, against its plain version over
    slices of SLICE_ROWS queries (the plain version's (S, L) scores of 32768
    positions do not fit), each slice at its q_offset against the keys up to
    its last row; bf16 at each slice's fa_bf16_bound, f32 at TOL. ``out`` is
    the kernel's output on q, k and v where a main path already made it.
    Returns the largest error and the time of the plain slices together."""
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain

    if out is None:
        out = flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    S, worst, plain_s = q.shape[2], 0.0, 0.0
    for s0 in range(0, S, SLICE_ROWS):
        s1 = min(S, s0 + SLICE_ROWS)
        t = time.perf_counter()
        ref = flash_attention_plain(q[:, :, s0:s1], k[:, :, :s1], v[:, :, :s1], causal=True,
                                    q_offset=s0)
        torch.cuda.synchronize()
        plain_s += time.perf_counter() - t
        rtol, atol = (fa_bf16_bound(ref) if q.dtype == torch.bfloat16
                      else (TOL[q.dtype], TOL[q.dtype]))
        worst = max(worst, check_close(f"{label} rows {s0}..{s1 - 1}", out[:, :, s0:s1], ref,
                                       rtol, atol))
        del ref
    print(f"{label}: {-(-S // SLICE_ROWS)} slices of {SLICE_ROWS} queries, max abs err "
          f"{worst:.3e}; plain slices {plain_s * 1e3:.1f} ms of host wall")
    return {"err": worst, "plain_ms": plain_s * 1e3}


# -- phase 2 --------------------------------------------------------------------

SCORE_CE_CASES = [  # T, D, V of phase 2's score_ce checks
    (272, 768, 50257), (16 * 497, 768, 50257),       # gpt2-base at 33 and 513 positions
    (1, 768, 50257), (273, 768, 50257),              # one row; one row past a 128-row tile
    (272, 4096, 65536), (16 * 497, 4096, 65536),    # rwkv6-7b
    (272, 5120, 102400), (16 * 497, 5120, 102400),  # deepseek-v2
    (272, 3584, 32000), (16 * 497, 3584, 32000),    # zamba2-7b
    (272, 6144, 92544), (16 * 497, 6144, 92544),    # internlm2-20b
    (272, 5120, 100352), (16 * 497, 5120, 100352),  # phi3-medium-14b
    (272, 12288, 256000), (16 * 497, 12288, 256000),  # command-r-plus-104b
    (272, 1024, 256206), (16 * 497, 1024, 256206),    # seamless-m4t-medium: V % 128 = 78
]
# flash_attention's checks: B, H, Hkv, S, L, hd, kwargs (causal unless they
# say otherwise). Then GQA groups 4, 6 and 12 at hd 128 (phi3-medium-14b,
# internlm2-20b, command-r-plus-104b); S = L = 32768 is held apart, in
# slices (sliced_attention_check).
FLASH_CASES = [
    (16, 12, 12, 33, 33, 64, {}),
    (16, 12, 12, 513, 513, 64, {}),
    (2, 28, 4, 513, 513, 128, {}),
    (2, 28, 4, 513, 513, 128, {"window": 128, "kv_len": 400}),
    (2, 28, 4, 64, 513, 128, {"q_offset": 449}),
    (4, 12, 12, 1, 1, 64, {}),                               # S = 1
    (4, 12, 12, 65, 65, 64, {}),                             # one row past a tile
    (2, 28, 4, 1, 513, 128, {"q_offset": 512}),              # one row at the end
    (2, 12, 4, 65, 200, 64, {"q_offset": 135, "window": 70}),  # window edge inside a tile
    (2, 28, 4, 513, 513, 128, {"window": 100}),
    (2, 12, 12, 65, 130, 64, {"causal": False, "kv_len": 100}),
    # hd 112: zamba2-7b's shared attention (MHA) at its lookup shapes,
    # and the 64-row tiles' edges, a window, q_offset and G = 4
    (16, 32, 32, 33, 33, 112, {}),
    (16, 32, 32, 513, 513, 112, {}),
    (4, 32, 32, 1, 1, 112, {}),                              # S = 1
    (4, 32, 32, 65, 65, 112, {}),                            # one row past a tile
    (2, 32, 8, 1, 513, 112, {"q_offset": 512}),              # G = 4, one row at the end
    (2, 32, 8, 64, 513, 112, {"q_offset": 449}),
    (2, 32, 32, 65, 200, 112, {"q_offset": 135, "window": 70}),  # window edge in a tile
    (2, 32, 8, 513, 513, 112, {"window": 100}),
    (2, 32, 32, 65, 130, 112, {"causal": False, "kv_len": 100}),
    (2, 32, 32, 513, 513, 112, {"causal": False}),
    (2, 40, 10, 513, 513, 128, {}),                          # G = 4 (phi3-medium-14b)
    (2, 48, 8, 513, 513, 128, {}),                           # G = 6 (internlm2-20b)
    (1, 96, 8, 513, 513, 128, {}),                           # G = 12 (command-r-plus)
    # the three at their lookup shapes (phase 12)
    (16, 40, 10, 33, 33, 128, {}), (16, 40, 10, 513, 513, 128, {}),
    (16, 48, 8, 33, 33, 128, {}), (16, 48, 8, 513, 513, 128, {}),
    (16, 96, 8, 33, 33, 128, {}), (16, 96, 8, 513, 513, 128, {}),
    (2, 96, 8, 65, 200, 128, {"q_offset": 135, "window": 70}),  # G = 12, window edge
    # seamless-m4t-medium (hd 64, MHA 16 heads), not causal: its encoder over
    # 1024 frames, and the cross attention of 33 and 513 positions against them
    (2, 16, 16, 1024, 1024, 64, {"causal": False}),
    (2, 16, 16, 33, 1024, 64, {"causal": False}),
    (2, 16, 16, 513, 1024, 64, {"causal": False}),
    (2, 16, 8, 70, 1000, 64, {"causal": False}),             # ragged tiles, G = 2
]
# rwkv6_wkv's checks: B, H, T, decay, start state. The bf16 kernel's
# sub-chunk is C = 16 tokens: T = 1, C - 1, C, C + 1 and 2C + 1. Decay
# "drawn" is -exp(N(0, 1) - 1.5) clamped at -12 as the model's; "none" is
# logw = 0; "steep" is logw = -exp(4), about -55, in every step.
WKV_CASES = [
    (16, 64, 33, "drawn", False), (16, 64, 33, "drawn", True), (16, 64, 513, "drawn", True),
    (1, 1, 1, "drawn", True), (1, 1, 15, "drawn", False), (1, 1, 16, "none", True),
    (1, 1, 17, "steep", True), (1, 1, 33, "drawn", True),
    (16, 64, 1, "drawn", True), (16, 64, 15, "steep", False), (16, 64, 16, "drawn", False),
    (16, 64, 17, "none", False), (16, 64, 33, "steep", True), (16, 64, 33, "none", True),
    (4, 8, 513, "steep", True),
]

# timed apart (2t): flash_attention at the last dense configs' GQA groups
# (B, H, Hkv, S, hd; causal at S = L: their lookups' evaluations), and
# score_ce at one 2048-position chunk of qwen2-7b's prefill_32k step
GQA_TIMED = [(16, 48, 8, 33, 128), (16, 48, 8, 513, 128),    # internlm2-20b, G = 6
             (16, 40, 10, 33, 128), (16, 40, 10, 513, 128),  # phi3-medium-14b, G = 4
             (16, 96, 8, 33, 128), (16, 96, 8, 513, 128)]    # command-r-plus-104b, G = 12
PREFILL_CHUNK_SCORE = (2048, 3584, 152064)                    # T, D, V
# Head dim 256 (paligemma-3b: 8 query heads over one kv-head), held and
# timed in bf16 and f32 (2v). flash_attention at the lookups' own lengths
# (256 image patches + 16 prompt positions + 17 or 497 tokens: 289 and 769,
# neither a multiple of the 64-row tile), at the tile's edges, with kv_len
# and a window edge inside a tile, and not causal with S > L: B, H, Hkv, S,
# L, hd, kwargs (causal unless they say otherwise).
VLM_FLASH_CASES = [
    (16, 8, 1, 289, 289, 256, {}),
    (16, 8, 1, 769, 769, 256, {}),
    (4, 8, 1, 127, 127, 256, {}),
    (4, 8, 1, 129, 129, 256, {}),
    (2, 8, 1, 129, 200, 256, {"q_offset": 71, "kv_len": 170}),
    (2, 8, 1, 65, 200, 256, {"q_offset": 135, "window": 70}),
    (2, 8, 1, 300, 200, 256, {"causal": False, "kv_len": 180}),
]
# flash_decode at decode_32k (B = 16 of its 128; the whole batch runs in
# phase 15) with auto_splits and with one split, and over 937 of 1000 rows:
# B, H, Hkv, L, hd, kwargs
VLM_DECODE_CASES = [
    (16, 8, 1, 32768, 256, {"kv_len": 32767}),
    (16, 8, 1, 32768, 256, {"kv_len": 32767, "splits": 1}),
    (16, 8, 1, 1000, 256, {"kv_len": 937}),
]


def decode_row(label: str, B: int, H: int, Hkv: int, L: int, hd: int, kw: dict, dtype, gen,
               dev) -> dict:
    """flash_decode at one case in ``dtype`` on a drawn (B, L, Hkv, hd)
    cache, the model's layout, read through transposed views, held against its
    plain version (bf16 at DECODE_BF16_RTOL and DECODE_BF16_ATOL x max
    |plain|, f32 at TOL), then timed beside the plain version, one SDPA
    call over the live rows and the bound. Returns the row, its error under
    "err"."""
    from repro_torch.kernels.flash_decode import (auto_splits, flash_decode, flash_decode_plain,
                                                  live_range)

    q = torch.randn(B, H, hd, generator=gen, device=dev).to(dtype)
    k, v = (torch.randn(B, L, Hkv, hd, generator=gen, device=dev).to(dtype).transpose(1, 2)
            for _ in range(2))
    out = flash_decode(q, k, v, **kw)
    torch.cuda.synchronize()
    ref = flash_decode_plain(q, k, v, **kw)
    top = ref.float().abs().max().item()
    rtol, atol = ((DECODE_BF16_RTOL, DECODE_BF16_ATOL * top) if dtype == torch.bfloat16
                  else (TOL[dtype], TOL[dtype]))
    lo, hi = live_range(L, kw.get("kv_len"), kw.get("q_pos"), kw.get("window", 0))
    splits = kw.get("splits") or auto_splits(
        B, Hkv, H // Hkv, hi - lo, torch.cuda.get_device_properties(dev).multi_processor_count)
    shape = f"B={B} H={H} Hkv={Hkv} hd={hd} L={L} {kw} {dtype}, {splits} splits"
    err = check_close(f"{label} flash_decode {shape}", out, ref, rtol, atol)
    del out, ref
    b_ms, b_by = decode_bound(B, H, Hkv, hd, hi - lo, q.element_size(),
                              PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS)
    row = {"shape": shape, "ms": time_ms(lambda: flash_decode(q, k, v, **kw)), "err": err,
           "plain_ms": time_ms(lambda: flash_decode_plain(q, k, v, **kw), reps=5),
           "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
               q[:, :, None], k[:, :, lo:hi], v[:, :, lo:hi], enable_gqa=H != Hkv)),
           "bound_ms": b_ms, "bound_by": b_by}
    print(f"{label} flash_decode {shape}: max abs err {err:.3e} (rtol {rtol}, atol {atol:.2e}; "
          f"max |out| {top:.3e}); kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
          f"library (SDPA over the live rows) {row['library_ms']:.4f} ms, bound {b_ms:.4f} ms "
          f"({b_by})")
    return row


def hd256_kernel_rows(dev: torch.device, gen) -> tuple:
    """2v: VLM_FLASH_CASES and VLM_DECODE_CASES in bf16 and f32, each held
    and timed. Returns the rows and the largest errors."""
    rows = {"flash_attention": [], "flash_decode": []}
    for dtype in (torch.bfloat16, torch.float32):
        for B, H, Hkv, S, L, hd, kw in VLM_FLASH_CASES:
            rows["flash_attention"].append(attention_row("[2v]", B, H, Hkv, S, hd, gen, dev, L=L,
                                                         dtype=dtype, trace=False, **kw))
        for B, H, Hkv, L, hd, kw in VLM_DECODE_CASES:
            rows["flash_decode"].append(decode_row("[2v]", B, H, Hkv, L, hd, kw, dtype, gen, dev))
    return rows, {name: max(r["err"] for r in rs) for name, rs in rows.items()}


def phase_kernels(dev: torch.device, seed: int) -> tuple:
    """Returns each kernel's largest error, and the rows timed in 2t and
    2v."""
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain
    from repro_torch.kernels.flash_decode import flash_decode, flash_decode_plain
    from repro_torch.kernels.rwkv_wkv import rwkv6_wkv, rwkv6_wkv_plain
    from repro_torch.kernels.score_ce import score_ce, score_ce_plain

    gen = torch.Generator(device=dev).manual_seed(seed)
    worst = {"score_ce": 0.0, "flash_attention": 0.0, "flash_decode": 0.0, "rwkv6_wkv": 0.0}
    for dtype in (torch.bfloat16, torch.float32):
        for T, D, V in SCORE_CE_CASES:
            h = torch.randn(T, D, generator=gen, device=dev).to(dtype)
            e = (torch.randn(V, D, generator=gen, device=dev) * 0.05).to(dtype)
            lab = torch.randint(0, V, (T,), generator=gen, device=dev, dtype=torch.int32)
            edges = torch.tensor([0, V - 1, V - 5], device=dev, dtype=torch.int32)
            lab[:3] = edges[:T]                       # the vocabulary's edges, the ragged tile
            out = score_ce(h, e, lab)
            torch.cuda.synchronize()
            err = check_close(f"score_ce T={T} D={D} V={V} {dtype}", out,
                              score_ce_plain(h, e, lab), TOL[dtype])
            worst["score_ce"] = max(worst["score_ce"], err)
            print(f"[2] score_ce T={T} D={D} V={V} {dtype}: max abs err {err:.3e} (tol {TOL[dtype]})")
            del h, e
        for B, H, Hkv, S, L, hd, kw in FLASH_CASES:
            kw = {"causal": True, **kw}
            q = torch.randn(B, H, S, hd, generator=gen, device=dev).to(dtype)
            k = torch.randn(B, Hkv, L, hd, generator=gen, device=dev).to(dtype)
            v = torch.randn(B, Hkv, L, hd, generator=gen, device=dev).to(dtype)
            out = flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            ref = flash_attention_plain(q, k, v, **kw)
            name = f"flash_attention B={B} H={H} Hkv={Hkv} S={S} L={L} hd={hd} {kw} {dtype}"
            rtol, atol = (fa_bf16_bound(ref) if dtype == torch.bfloat16
                          else (TOL[dtype], TOL[dtype]))
            err = check_close(name, out, ref, rtol, atol)
            worst["flash_attention"] = max(worst["flash_attention"], err)
            print(f"[2] {name}: max abs err {err:.3e} (rtol {rtol}, atol {atol:.2e})")
            del q, k, v, out, ref
        # qwen2-7b's heads at prefill_32k's length, held in slices
        q = torch.randn(1, 28, 32768, 128, generator=gen, device=dev).to(dtype)
        k, v = (torch.randn(1, 4, 32768, 128, generator=gen, device=dev).to(dtype)
                for _ in range(2))
        res = sliced_attention_check(f"[2] flash_attention B=1 H=28 Hkv=4 S=L=32768 hd=128 "
                                     f"causal {dtype}", q, k, v)
        worst["flash_attention"] = max(worst["flash_attention"], res["err"])
        del q, k, v
        decode_cases = [  # B, H, Hkv, L, hd, kwargs
            (16, 28, 4, 32768, 128, {"kv_len": 32768}),              # qwen2-7b serve shape
            (16, 28, 4, 32768, 128, {"kv_len": 20001}),              # ragged
            (4, 12, 12, 1000, 64, {"kv_len": 777}),                  # G = 1, hd = 64
            (2, 28, 4, 4096, 128, {"kv_len": 3000, "window": 1024}),  # sliding window
            (2, 28, 4, 4096, 128, {"kv_len": 5, "q_pos": 3, "splits": 8}),  # 4 of 8 splits empty
            (3, 28, 4, 512, 128, {"kv_len": 1}),                     # one live row
            (3, 28, 4, 512, 128, {"kv_len": 63}),                    # one chunk short of a tile
            (3, 28, 4, 512, 128, {"kv_len": 64}),                    # one whole tile
            (3, 32, 4, 512, 64, {"kv_len": 65}),                     # G = 8, one row past a tile
            (3, 16, 4, 4096, 128, {"kv_len": 4000, "q_pos": 2500}),  # G = 4, q_pos < kv_len - 1
            (2, 28, 4, 4096, 128, {"kv_len": 3000, "window": 1000}),  # window edge inside a tile
            (2, 32, 2, 1000, 128, {"kv_len": 900}),                  # G = 16: two head groups
            # hd 112: zamba2-7b's serve shape (B = 8, MHA: G = 1), the whole
            # cache and ragged, the chunk and tile edges, G = 4 and 8
            (8, 32, 32, 32768, 112, {"kv_len": 32768}),
            (8, 32, 32, 32768, 112, {"kv_len": 20001}),
            (3, 32, 32, 512, 112, {"kv_len": 1}),
            (3, 32, 32, 512, 112, {"kv_len": 63}),
            (3, 32, 32, 512, 112, {"kv_len": 64}),
            (3, 32, 4, 512, 112, {"kv_len": 65}),                    # G = 8
            (3, 32, 8, 4096, 112, {"kv_len": 4000, "q_pos": 2500}),  # G = 4, q_pos < kv_len - 1
            (2, 32, 32, 4096, 112, {"kv_len": 3000, "window": 1000}),  # window edge in a tile
            (2, 32, 32, 4096, 112, {"kv_len": 5, "q_pos": 3, "splits": 8}),  # empty partitions
        ]
        for B, H, Hkv, L, hd, kw in decode_cases:
            q = torch.randn(B, H, hd, generator=gen, device=dev).to(dtype)
            # the model's (B, L, Hkv, hd) cache, read through transposed views
            k, v = (torch.randn(B, L, Hkv, hd, generator=gen, device=dev).to(dtype)
                    .transpose(1, 2) for _ in range(2))
            out = flash_decode(q, k, v, **kw)
            torch.cuda.synchronize()
            ref = flash_decode_plain(q, k, v, **kw)
            top = ref.float().abs().max().item()
            rtol, atol = ((DECODE_BF16_RTOL, DECODE_BF16_ATOL * top)
                          if dtype == torch.bfloat16 else (TOL[dtype], TOL[dtype]))
            err = check_close(f"flash_decode {(B, H, Hkv, L, hd)} {kw} {dtype}", out, ref,
                              rtol, atol)
            worst["flash_decode"] = max(worst["flash_decode"], err)
            print(f"[2] flash_decode B={B} H={H} Hkv={Hkv} L={L} hd={hd} {kw} {dtype}: "
                  f"max abs err {err:.3e} (rtol {rtol}, atol {atol:.2e}; max |out| {top:.3e})")
            del k, v
        hd = 64
        for B, H, T, decay, with_state in WKV_CASES:
            r, k, v = (torch.randn(B, T, H, hd, generator=gen, device=dev).to(dtype)
                       .transpose(1, 2) for _ in range(3))
            noise = torch.randn(B, T, H, hd, generator=gen, device=dev)
            logw = {"drawn": (-torch.exp(noise - 1.5)).clamp_min(-12.0),
                    "none": torch.zeros_like(noise),
                    "steep": torch.full_like(noise, -float(np.exp(4.0)))}[decay].transpose(1, 2)
            u = 0.5 * torch.randn(H, hd, generator=gen, device=dev)
            s0 = (0.5 * torch.randn(B, H, hd, hd, generator=gen, device=dev)
                  if with_state else None)
            y, s1 = rwkv6_wkv(r, k, v, logw, u, s0)
            torch.cuda.synchronize()
            py, ps1 = rwkv6_wkv_plain(r, k, v, logw, u, s0)
            name = f"rwkv6_wkv B*H={B * H} T={T} {decay} decay state={with_state} {dtype}"
            err = max(check_close(name + " y", y, py, WKV_TOL[dtype]),
                      check_close(name + " state", s1, ps1, WKV_TOL[dtype]))
            worst["rwkv6_wkv"] = max(worst["rwkv6_wkv"], err)
            print(f"[2] rwkv6_wkv B*H={B * H} T={T} hd={hd} logw {decay} "
                  f"state0={'given' if with_state else 'zero'} {dtype} inputs: "
                  f"max abs err (y and state) {err:.3e} (rtol {WKV_TOL[dtype]}, "
                  f"atol {WKV_TOL[dtype]:.2e})")
            del r, k, v, logw, noise
        # rows that are not 16-byte multiples apart, as a [..., :H·hd] view of
        # wider rows gives: the bf16 kernel copies them element by element
        # instead of by cp.async
        B, H, T = 2, 4, 37
        def strided(dt, fn=lambda x: x):
            wide = fn(torch.randn(B, T, H * hd + 2, generator=gen, device=dev)).to(dt)
            return wide[..., :H * hd].view(B, T, H, hd).transpose(1, 2)
        r, k, v = (strided(dtype) for _ in range(3))
        logw = strided(torch.float32, lambda x: -torch.exp(x - 1.5))
        u = 0.5 * torch.randn(H, hd, generator=gen, device=dev)
        y, s1 = rwkv6_wkv(r, k, v, logw, u, None)
        torch.cuda.synchronize()
        py, ps1 = rwkv6_wkv_plain(r, k, v, logw, u, None)
        name = f"rwkv6_wkv T={T} row stride {r.stride(2)} {dtype}"
        err = max(check_close(name + " y", y, py, WKV_TOL[dtype]),
                  check_close(name + " state", s1, ps1, WKV_TOL[dtype]))
        worst["rwkv6_wkv"] = max(worst["rwkv6_wkv"], err)
        print(f"[2] rwkv6_wkv B*H={B * H} T={T} hd={hd}, rows {r.stride(2)} elements apart, "
              f"{dtype} inputs: max abs err (y and state) {err:.3e} (rtol {WKV_TOL[dtype]}, "
              f"atol {WKV_TOL[dtype]:.2e})")

    # 2t: timed apart at shapes that the main paths run and no other phase times
    rows = {"flash_attention": [attention_row("[2t]", B, H, Hkv, S, hd, gen, dev, trace=False)
                                for B, H, Hkv, S, hd in GQA_TIMED]}
    T, D, V = PREFILL_CHUNK_SCORE
    emb = (torch.randn(V, D, generator=gen, device=dev) * 0.05).bfloat16()
    rows["score_ce"] = score_ce_rows("[2t]", "qwen2-7b prefill_32k chunk", emb, (T,), gen)
    del emb
    # 2v: head dim 256, held and timed
    hd256, errs = hd256_kernel_rows(dev, gen)
    rows["flash_attention"] += hd256["flash_attention"]
    rows["flash_decode"] = hd256["flash_decode"]
    for name, err in errs.items():
        worst[name] = max(worst[name], err)
    return worst, rows


def eval_shape(score_fn, positions: int) -> str:
    """The shape label of one Eqn-1 evaluation: its positions and the rows
    it hands score_ce (eval rows × token positions, the prompt's left out)."""
    rows, tokens = score_fn.eval_batch["tokens"].shape
    return f"{positions} positions (score_ce T={rows * tokens})"


@contextlib.contextmanager
def counted(kernels: dict, by_shape: dict, label: str):
    """Adds each kernel's launches inside the block to by_shape[name][label]."""
    before = {name: fn.launches for name, fn in kernels.items()}
    yield
    for name, fn in kernels.items():
        n = fn.launches - before[name]
        if n:
            by_shape[name][label] = by_shape[name].get(label, 0) + n


# -- phase 3 --------------------------------------------------------------------

def phase_slice(dev: torch.device, seed: int):
    from repro_torch.config import TuneConfig
    from repro_torch.configs import get_config
    from repro_torch.core import build_bank, make_score_fn
    from repro_torch.data import make_tasks
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.score_ce import score_ce
    from repro_torch.models import Model

    cfg = get_config("gpt2-base")                      # full width, bf16
    model = Model(cfg, device=dev, seed=seed)
    tune_cfg = TuneConfig(prompt_len=16)
    tasks = make_tasks(vocab=32, partitions=4)         # 12 families x 4 = 48 tasks
    rng = np.random.default_rng(seed)
    d = cfg.d_model
    seed_prompts = {t.task_id: rng.normal(0, 0.5 / np.sqrt(d), (tune_cfg.prompt_len, d))
                    .astype(np.float32) for t in tasks}
    requests = [tasks[5], tasks[30],
                make_tasks(input_len=248, target_len=248)[9]]   # 33, 33, 513 positions
    print(f"[3] {cfg.name}: {cfg.num_layers} layers, d={d}, H={cfg.num_heads}, "
          f"V={cfg.vocab_size}, {cfg.dtype}, weights from seed {seed}")

    kernels = {"score_ce": score_ce, "flash_attention": flash_attention}
    by_shape = {name: {} for name in kernels}
    score_ce.launches = flash_attention.launches = 0
    t0 = time.perf_counter()
    with counted(kernels, by_shape, "bank build"):
        bank = build_bank(model, seed_prompts, variants_per_prompt=4, seed=seed)
    torch.cuda.synchronize()
    print(f"[3] bank: {len(bank.entries)} candidates, {len(bank.medoid_ids)} clusters, "
          f"features + clustering {time.perf_counter() - t0:.3f} s")
    if len(bank.entries) != 192 or len(bank.medoid_ids) != 48:
        raise AssertionError("bank does not hold 192 candidates in 48 clusters")
    results = []
    for task in requests:
        score_fn = make_score_fn(model, task, tune_cfg)
        positions = tune_cfg.prompt_len + score_fn.eval_batch["tokens"].shape[1]
        with counted(kernels, by_shape, eval_shape(score_fn, positions)):
            res = bank.lookup(score_fn)
        if not np.isfinite(res.score) or res.evaluations < len(bank.medoid_ids):
            raise AssertionError(f"lookup for {task.task_id} gave {res}")
        print(f"[3] request {task.task_id} ({positions} positions): origin={res.entry.origin} "
              f"score={res.score:.6f} evaluations={res.evaluations} "
              f"latency={res.latency_s:.3f} s")
        results.append((task, res))
    launches = {"score_ce": score_ce.launches, "flash_attention": flash_attention.launches}
    print(f"[3] kernel launches on the lookup path: {launches}; by shape {by_shape}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was never launched on the lookup path")
    return model, bank, results, {"total": launches, "by_shape": by_shape}


# -- phase 4 --------------------------------------------------------------------

def phase_rescore(model, bank, results, seed: int):
    from repro_torch.config import TuneConfig
    from repro_torch.core import make_score_fn
    from repro_torch.models import Model

    tune_cfg = TuneConfig(prompt_len=16)
    f32 = model.cfg.with_overrides(dtype="float32", param_dtype="float32")
    ref_cpu = Model(f32, device="cpu", seed=seed)
    ref_cpu.load_state_dict(model.state_dict())        # the same (bf16) weights, widened
    f32_gpu = Model(f32, device=model.device, seed=seed)
    f32_gpu.load_state_dict(model.state_dict())
    failed = []
    for task, res in results[:2]:
        entries = [res.entry, bank.entries[bank.medoid_ids[0]]]
        for entry in entries:
            cpu = make_score_fn(ref_cpu, task, tune_cfg)(entry)
            bf16 = make_score_fn(model, task, tune_cfg)(entry)
            f32k = make_score_fn(f32_gpu, task, tune_cfg)(entry)
            r_bf16, r_f32 = abs(bf16 - cpu) / abs(cpu), abs(f32k - cpu) / abs(cpu)
            print(f"[4] {task.task_id} {entry.origin}: cpu f32 {cpu:.6f}, card bf16 {bf16:.6f} "
                  f"(rel {r_bf16:.2e}), card f32 {f32k:.6f} (rel {r_f32:.2e})")
            if not r_bf16 <= BF16_SCORE_RTOL or not r_f32 <= F32_SCORE_RTOL:
                failed.append(f"{task.task_id} {entry.origin}")
    if failed:
        raise AssertionError(f"card scores disagree with the CPU f32 path for {failed} "
                             f"(relative tolerance {BF16_SCORE_RTOL} bf16, {F32_SCORE_RTOL} f32)")
    del f32_gpu
    return ref_cpu


# -- phase 5 --------------------------------------------------------------------

def bound(flops: float, nbytes: float, peak_flops: float):
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_times(model, seed: int) -> dict:
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain

    dev, gen = model.device, torch.Generator(device=model.device).manual_seed(seed)
    emb = model.embedding.detach()                     # (V, D) bf16, 77 MB
    rows = {"score_ce": score_ce_rows("[5]", model.cfg.name, emb, (16 * 17, 16 * 497), gen,
                                      gemm=True)}
    cfg = model.cfg
    B, H, hd = 16, cfg.num_heads, cfg.resolved_head_dim()
    for S in (33, 513):
        q, k, v = (torch.randn(B, H, S, hd, generator=gen, device=dev).to(emb.dtype)
                   for _ in range(3))
        pairs = S * (S + 1) // 2                      # live (query, key) pairs, causal
        flops = 4.0 * B * H * pairs * hd
        nbytes = 4 * B * H * S * hd * q.element_size()
        b_ms, b_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
        row = {"shape": f"B={B} H={H} S=L={S} hd={hd} causal bf16",
               "ms": time_ms(lambda: flash_attention(q, k, v, causal=True)),
               "lse_ms": time_ms(lambda: flash_attention(q, k, v, causal=True,
                                                         return_lse=True)),
               "plain_ms": time_ms(lambda: flash_attention_plain(q, k, v, causal=True)),
               "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                   q, k, v, is_causal=True)),
               "bound_ms": b_ms, "bound_by": b_by}
        rows.setdefault("flash_attention", []).append(row)
    sdpa = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True)
    library_yardstick(f"[5] flash_attention {rows['flash_attention'][-1]['shape']}",
                      lambda: flash_attention(q, k, v, causal=True), sdpa)
    for r in rows["flash_attention"]:
        print(f"[5] flash_attention {r['shape']}: kernel {r['ms']:.4f} ms (writing the "
              f"lse too {r['lse_ms']:.4f} ms), plain "
              f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
    return rows


def score_ce_rows(label: str, model_name: str, emb: torch.Tensor, Ts, gen,
                  gemm: bool = False) -> list:
    """score_ce at (T, D, V) for each T against ``emb`` (V, D): the kernel,
    its plain version, the library call (``F.cross_entropy`` of the bf16
    ``h @ E.T`` in f32) and the bound; with ``gemm`` also the bare
    ``h @ E.T`` (cuBLAS: a yardstick for the main loop, not the library
    column). Prints the kernels each launch runs."""
    from repro_torch.kernels.score_ce import score_ce, score_ce_plain

    V, D = emb.shape
    rows = []
    for T in Ts:
        h = torch.randn(T, D, generator=gen, device=emb.device).to(emb.dtype)
        lab = torch.randint(0, V, (T,), generator=gen, device=emb.device, dtype=torch.int32)
        flops = 2.0 * T * V * D
        nbytes = (T * D + V * D) * emb.element_size() + T * 4 + T * 4
        b_ms, b_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
        row = {"shape": f"{model_name}: T={T} D={D} V={V} bf16",
               "ms": time_ms(lambda: score_ce(h, emb, lab)),
               "lse_ms": time_ms(lambda: score_ce(h, emb, lab, return_lse=True)),
               "plain_ms": time_ms(lambda: score_ce_plain(h, emb, lab), reps=5),
               "library_ms": time_ms(lambda: F.cross_entropy(
                   (h @ emb.T).float(), lab.long(), reduction="none"), reps=5),
               "bound_ms": b_ms, "bound_by": b_by}
        extra = ""
        if gemm:
            row["gemm_ms"] = time_ms(lambda: h @ emb.T)
            extra = f", bare h @ E.T (cuBLAS) {row['gemm_ms']:.4f} ms"
        print(f"{label} score_ce {row['shape']}: kernel {row['ms']:.4f} ms (writing the lse "
              f"too {row['lse_ms']:.4f} ms), plain "
              f"{row['plain_ms']:.4f} ms, library {row['library_ms']:.4f} ms{extra}, bound "
              f"{b_ms:.4f} ms ({b_by})")
        kernel_launches(f"{label} score_ce T={T} D={D} V={V}", lambda: score_ce(h, emb, lab))
        rows.append(row)
        del h, lab
    return rows


TRACED_CALL = "chip_smoke traced call "
PROFILER_ATTEMPTS = 12
SPACER_LAUNCHES = 256


def traced_kernels(label: str, fn, calls: int, attempts: int = PROFILER_ATTEMPTS) -> dict:
    """What one call of ``fn`` runs on the card, in launch order, from
    profiler traces of ``calls`` calls each (written under build/).

    The profiler keeps the runtime's record of every launch but can lose the
    device's record of the kernel, a few or all of a trace's, more often the
    longer the process has run (on the H100 machines, after two minutes
    most traces of tools/profiler_record_loss.py hold none). So no single
    trace is taken at its word. Each call runs in a named range; the launches
    whose runtime records fall in it are numbered in order; the launch with
    one number runs the same kernel in every call, so it is named by any call
    and any trace that kept the record its correlation id points to. Traces
    are taken until every kernel launch is named, at most ``attempts``.
    Copies and sets are numbered the same way and kept where recorded.
    The records lost are the first ones of a trace, or of a call after the
    card fell idle: a count that grows as the process ages
    (tools/profiler_record_loss.py). So each call comes after
    SPACER_LAUNCHES launches of an empty kernel, outside its range, whose
    records may be lost in its stead. The offset of the device's clock from
    the launches' (the least gap from a launch to its kernel in the last
    trace that kept any) is printed beside the count of traces, and the
    launches left unnamed with their named neighbours.
    Returns {"launches": [{"name", "cat", "grid", "block", "registers",
    "shared", "us": [device times]} or None for each launch], "missing":
    kernel launches left unnamed, "traces": traces taken}."""
    from torch.profiler import ProfilerActivity, profile, record_function

    path = ROOT / "build" / "launches.trace.json"
    path.parent.mkdir(exist_ok=True)
    slots, offset_us = None, None
    for attempt in range(1, attempts + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(calls):
                for _ in range(SPACER_LAUNCHES):
                    torch.cuda._sleep(1)
                with record_function(f"{TRACED_CALL}{i}"):
                    fn()
                    torch.cuda.synchronize()
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
        ranges = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                        if e.get("cat") == "user_annotation"
                        and str(e.get("name")).startswith(TRACED_CALL))
        runtime = sorted((e["ts"], e["args"]["correlation"], "LaunchKernel" in e["name"]
                          or "LaunchCooperativeKernel" in e["name"], e["name"]) for e in events
                         if e.get("cat") in ("cuda_runtime", "cuda_driver")
                         and any(x in e["name"] for x in ("LaunchKernel",
                                                          "LaunchCooperativeKernel",
                                                          "Memcpy", "Memset")))
        device = {e["args"]["correlation"]: e for e in events
                  if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
                  and "correlation" in e.get("args", {})}
        gaps = [device[c]["ts"] - ts for ts, c, k, _ in runtime if k and c in device]
        if gaps:
            offset_us = min(gaps)
        per_call = [[(c, k, api) for ts, c, k, api in runtime if lo <= ts <= hi]
                    for lo, hi in ranges]
        if len(per_call) != calls:
            raise AssertionError(f"{label}: the trace holds {len(per_call)} of the {calls} "
                                 "named call ranges")
        counts = [len(p) for p in per_call]
        if slots is None:
            n = statistics.mode(counts)
            kinds = next(p for p in per_call if len(p) == n)
            slots = [None] * n
        if any(c != len(slots) for c in counts):
            print(f"{label}: calls launched {counts} times (first trace: {len(slots)}); "
                  "only calls of that count are read")
        for launches in per_call:
            if len(launches) != len(slots):
                continue
            for j, (corr, _, _) in enumerate(launches):
                e = device.get(corr)
                if e is None:
                    continue
                a = e["args"]
                if slots[j] is None:
                    slots[j] = {"name": e["name"], "cat": e["cat"], "grid": a.get("grid"),
                                "block": a.get("block"),
                                "registers": a.get("registers per thread"),
                                "shared": a.get("shared memory"), "us": []}
                elif slots[j]["name"] != e["name"]:
                    raise AssertionError(f"{label}: launch {j} ran {slots[j]['name'][:60]} in "
                                         f"one call and {e['name'][:60]} in another")
                slots[j]["us"].append(e["dur"])
        unnamed = [j for j, (s, (_, kernel, _)) in enumerate(zip(slots, kinds))
                   if kernel and s is None]
        missing = len(unnamed)
        if not missing:
            break
    if attempt > 1 or missing:
        offset = "none read" if offset_us is None else f"{offset_us / 1e3:+.3f} ms"
        print(f"{label}: {len(slots)} launches a call, named from {attempt} traces "
              f"(the profiler lost kernel records; device clock against launches: {offset}); "
              f"{missing} kernel launches left unnamed")

    def near(js):
        return next((slots[k]["name"][:70] for k in js if slots[k] is not None), None)
    for j in unnamed[:5]:
        print(f"{label}: launch {j} ({kinds[j][2]}) unnamed, between {near(range(j - 1, -1, -1))} "
              f"and {near(range(j + 1, len(slots)))}")
    return {"launches": slots, "missing": missing, "traces": attempt}


def kernel_launches(label: str, fn, calls: int = 3) -> list:
    """The kernels a call of ``fn`` launches (traced_kernels), each listed
    once with its launch shape and device time. Fails if a launch stays
    unnamed. Returns the kernels' names."""
    fn()
    torch.cuda.synchronize()
    traced = traced_kernels(label, fn, calls)
    if traced["missing"]:
        raise AssertionError(f"{label}: {traced['missing']} kernel launches stayed unnamed "
                             f"after {traced['traces']} traces")
    seen = set()
    for s in traced["launches"]:
        if s is None or s["cat"] != "kernel" or (s["name"], str(s["grid"])) in seen:
            continue
        seen.add((s["name"], str(s["grid"])))
        print(f"{label}: {statistics.mean(s['us']):.1f} us grid {s['grid']} block {s['block']} "
              f"{s['registers']} registers {s['shared']} B shared  {s['name'][:90]}")
    return sorted({name for name, _ in seen})


def library_yardstick(label: str, kernel, call) -> None:
    """The kernels the port's call and the library call launch (the library
    dispatches by shape and card, so its time may be another design's), and
    the library call's time with the FlashAttention-2 backend forced, the
    mma.sync design the port's kernels share."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    def forced():
        with sdpa_kernel([SDPBackend.FLASH_ATTENTION]):
            return call()
    kernel_launches(f"{label}, port", kernel)
    kernel_launches(f"{label}, SDPA", call)
    print(f"{label}: SDPA with the FlashAttention-2 backend forced: {time_ms(forced):.4f} ms")


def profile_calls(label: str, fn, warm: int = 3, reps: int = 10, traced: int = 5) -> dict:
    """Where one call's time goes: host wall clock per call of ``fn`` against
    the device time of the kernels, copies and sets it runs (traced_kernels).
    Device busy and the idle share are "not measured" (None) where a kernel
    launch stayed unnamed."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / reps * 1e3
    launches = traced_kernels(label, fn, traced)
    seen = [s for s in launches["launches"] if s is not None]
    kernels = sum(1 for s in seen if s["cat"] == "kernel")
    if launches["missing"]:
        print(f"{label}: host wall {wall_ms:.3f} ms, device busy not measured "
              f"({launches['missing']} kernel launches unnamed), {len(launches['launches'])} "
              "launches")
        return {"wall_ms": wall_ms, "device_ms": None, "idle_share": None, "kernels": kernels}
    unrecorded = len(launches["launches"]) - len(seen)
    dev_ms = sum(statistics.mean(s["us"]) for s in seen) / 1e3
    print(f"{label}: host wall {wall_ms:.3f} ms, device busy {dev_ms:.3f} ms "
          f"(idle share {1 - dev_ms / wall_ms:.3f}), {kernels} kernels"
          + (f" ({unrecorded} copies or sets unrecorded)" if unrecorded else ""))
    by_name: dict = {}
    for s in seen:
        t = by_name.setdefault(s["name"], [0.0, 0])
        t[0] += statistics.mean(s["us"])
        t[1] += 1
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]:
        print(f"{label}   {us / 1e3:.4f} ms  x{n:<4d} {name[:90]}")
    return {"wall_ms": wall_ms, "device_ms": dev_ms, "idle_share": 1 - dev_ms / wall_ms,
            "kernels": kernels}


def phase_profile(model, bank, results) -> None:
    """One Eqn-1 evaluation of gpt2-base at 33 and at 513 positions."""
    from repro_torch.config import TuneConfig
    from repro_torch.core import make_score_fn

    entry = bank.entries[0]
    for task, _ in (results[0], results[-1]):
        fn = make_score_fn(model, task, TuneConfig(prompt_len=16))
        positions = 16 + fn.eval_batch["tokens"].shape[1]
        profile_calls(f"[5] one evaluation at {positions} positions", lambda: fn(entry))


# -- phase 10 (after phase 5, on phase 3's model and bank) -----------------------

# A lookup through the service against a direct lookup of the same scorer:
# the same kernels on the same inputs, so the scores should be bitwise equal.
SERVICE_SCORE_RTOL = 1e-6
SERVICE_TUNE_ITERS = 40


def phase_service(model, bank, ref_cpu, card: str, seed: int) -> dict:
    """examples/quickstart.py's steps 2-5 through the port's PromptTunerService,
    at gpt2-base full width on the card. Returns the launches by label."""
    from repro_torch.api import PromptTunerService, SubmitRequest
    from repro_torch.cluster import ElasticConfig, SimConfig
    from repro_torch.config import TuneConfig
    from repro_torch.core import PromptBank, make_score_fn, select_manual
    from repro_torch.core.jobs import LLM_PROFILES
    from repro_torch.data import LoaderConfig, TaskLoader, make_tasks
    from repro_torch.models import prompt_from_arrays
    from repro_torch.tuning import PromptTuner, activation_features

    t_phase = time.perf_counter()
    dev = model.device
    tune_cfg = TuneConfig(prompt_len=16)
    tasks = {t.task_id: t for t in make_tasks(vocab=32, partitions=4)}   # phase 3's tasks
    prof = LLM_PROFILES["gpt2-base"]
    budget_slo = prof.bank_lookup_s / SimConfig().latency_budget_frac    # 26.5 s
    # (task, tenant, class, SLO in s); premium's multiplier is 0.75, best-effort's
    # above 1; the last is below the latency budget and must not be routed
    wave = [("copy:1", "acme", "premium", 60.0), ("xor:2", "globex", "standard", 90.0),
            ("shift:3", "acme", "best-effort", 40.0), ("negate:0", "globex", "premium", 300.0),
            ("prev:2", "acme", "standard", 0.5 * budget_slo)]
    requested = {tid for tid, *_ in wave}
    holdout = PromptBank(capacity=bank.capacity, num_clusters=bank.num_clusters, seed=bank.seed)
    holdout.add_candidates([e for e in bank.entries if e.origin.split("/")[0] not in requested])
    holdout.build()
    evaluations = [0]

    def score_factory(req):
        """Eqn 1 on the request's task's eval set, on the card."""
        fn = make_score_fn(model, tasks[req.task_id], tune_cfg)

        def score(entry):
            evaluations[0] += 1
            return fn(entry)
        return score

    def service(bank_, factory, telemetry=None):
        return PromptTunerService(SimConfig(max_gpus=16), bank=bank_, score_fn_factory=factory,
                                  shards=2, elastic=ElasticConfig(), telemetry=telemetry)

    svc = service(holdout, score_factory, telemetry=True)
    print(f"[10] PromptTunerService (prompttuner, SimConfig(max_gpus=16), 2 shards, elastic, "
          f"telemetry on) "
          f"over phase 3's bank less {sorted(requested)}'s own candidates: {len(holdout)} of "
          f"{len(bank.entries)}, {len(holdout.medoid_ids)} clusters; scorer make_score_fn on "
          f"{model.cfg.name} ({model.cfg.num_layers} layers, d={model.cfg.d_model}, "
          f"{model.cfg.dtype}), P={tune_cfg.prompt_len}, {tune_cfg.eval_samples} eval samples; "
          f"latency budget: SLO x class multiplier >= {budget_slo:.1f} s (bank_lookup_s "
          f"{prof.bank_lookup_s} s, the paper's A100 figure)")

    kernels = {n: k for n, k in training_kernels().items() if n in ATTENTION_TUNING}
    by_label = {name: {} for name in kernels}
    calls: dict = {}
    for k in kernels.values():
        k.launches = 0
    requests, submitted = [], []

    def submit(req):
        requests.append(req)
        t0 = time.perf_counter()
        handle = svc.submit(req)
        torch.cuda.synchronize()
        return handle, time.perf_counter() - t0

    # (a) the first wave
    lookups = "gpt2-base, service: first wave's routed lookups"
    for tid, tenant, cls, slo in wave:
        req = SubmitRequest(task_id=tid, llm="gpt2-base", slo=slo, iters_manual=400,
                            iters_bank=120, tenant=tenant, slo_class=cls)
        before, n0 = {n: k.launches for n, k in kernels.items()}, evaluations[0]
        with plain_calls(calls), counted(kernels, by_label, lookups):
            handle, wall = submit(req)
        fired = {n: k.launches - before[n] for n, k in kernels.items()}
        submitted.append((handle, wall, evaluations[0] - n0, fired))
    bad = SubmitRequest(task_id="copy:1", llm="gpt-5", slo=300.0, iters_manual=400,
                        iters_bank=120, tenant="acme")
    before = {n: k.launches for n, k in kernels.items()}
    try:
        svc.submit(bad)
    except KeyError as exc:
        print(f"[10a] unknown LLM: KeyError {exc}")
    else:
        raise AssertionError("[10a] a request for an unknown LLM was accepted")
    if any(k.launches != before[n] for n, k in kernels.items()):
        raise AssertionError("[10a] the unknown-LLM request launched a kernel")

    routed = [(h, w, e, f) for h, w, e, f in submitted if h.routed_through_bank]
    for handle, wall, evals, fired in submitted:
        eff = f"effective SLO {handle.effective_slo:.1f} s"
        if not handle.routed_through_bank:
            print(f"[10a] {handle.task_id} ({handle.tenant}, {handle.slo_class}, {eff}): not "
                  f"routed, shard {handle.shard}, {evals} evaluations, launches {fired}")
            if any(fired.values()) or evals or handle.bank_origin is not None:
                raise AssertionError(f"[10a] the unrouted request {handle.task_id} looked up")
            continue
        direct_fn = make_score_fn(model, tasks[handle.task_id], tune_cfg)
        t0 = time.perf_counter()
        direct = holdout.lookup(direct_fn)
        torch.cuda.synchronize()
        direct_wall = time.perf_counter() - t0
        rel = abs(handle.bank_score - direct.score) / abs(direct.score)
        cpu = make_score_fn(ref_cpu, tasks[handle.task_id], tune_cfg)(direct.entry)
        rel_cpu = abs(handle.bank_score - cpu) / abs(cpu)
        print(f"[10a] {handle.task_id} ({handle.tenant}, {handle.slo_class}, {eff}): routed, "
              f"shard {handle.shard}, {handle.bank_origin} score {handle.bank_score:.6f}; "
              f"through the service {wall * 1e3:.3f} ms for {evals} evaluations "
              f"({evals / wall:.1f} evaluations/s), directly {direct_wall * 1e3:.3f} ms "
              f"({direct.evaluations}): {direct.entry.origin} {direct.score:.6f} (rel "
              f"{rel:.1e}); cpu f32 {cpu:.6f} (rel {rel_cpu:.2e}); on {card}")
        if (handle.bank_origin != direct.entry.origin or not rel <= SERVICE_SCORE_RTOL
                or evals != direct.evaluations):
            raise AssertionError(f"[10a] {handle.task_id}: the service's lookup differs from "
                                 f"a direct one (rtol {SERVICE_SCORE_RTOL})")
        if not rel_cpu <= BF16_SCORE_RTOL:
            raise AssertionError(f"[10a] {handle.task_id}: the card's score disagrees with the "
                                 f"CPU f32 path (rtol {BF16_SCORE_RTOL})")
        if fired["score_ce"] <= 0 or fired["flash_attention"] <= 0:
            raise AssertionError(f"[10a] {handle.task_id}'s lookup launched {fired}")
    if len(routed) != len(wave) - 1:
        raise AssertionError("[10a] the requests within the budget were not all routed")
    walls = [w for _, w, _, _ in routed]
    evals = sum(e for _, _, e, _ in routed)
    print(f"[10a] {len(routed)} routed submits: mean {statistics.mean(walls) * 1e3:.3f} ms, "
          f"{evals / sum(walls):.1f} Eqn-1 evaluations/s on {card}; the simulator charges "
          f"bank_lookup_s {prof.bank_lookup_s} s, the paper's A100 figure")

    # (b) tune from the bank's prompt and from a manual one, to one target each
    tuner = PromptTuner(model, tune_cfg)
    tuned = []
    label = (f"gpt2-base, service: tune 2 requests from the bank's and a manual prompt "
             f"(at most {SERVICE_TUNE_ITERS} iterations each)")
    for handle, *_ in routed[:2]:
        task = tasks[handle.task_id]
        target = 0.98 * handle.bank_score
        runs = {}
        for init, prompt in (("bank", handle.initial_prompt),
                             ("manual", select_manual(model.cfg.d_model, tune_cfg.prompt_len,
                                                      seed=7))):
            loader = TaskLoader(task, LoaderConfig(batch_size=tune_cfg.batch_size, seed=seed))
            pp = prompt_from_arrays({"soft_prompt": prompt}, dev)
            t0 = time.perf_counter()
            with plain_calls(calls), counted(kernels, by_label, label):
                res = tuner.tune(loader, pp, target_loss=target, max_iters=SERVICE_TUNE_ITERS)
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            runs[init] = res
            per_iter = f"{wall / res['iters'] * 1e3:.3f} ms an iteration" if res["iters"] else "-"
            hist = [(it, round(l, 6), round(e, 6)) for it, l, e in res["history"]]
            print(f"[10b] {handle.task_id} {init:6s} init: ITA={res['iters']} (reached "
                  f"{res['reached']}, target {target:.6f} = 0.98 x the bank prompt's score) in "
                  f"{wall:.3f} s, {per_iter} with its share of the evaluations, on {card}; "
                  f"history {hist}")
            # the bank's prompt starts at its score, above the target: it must tune
            if (not all(np.isfinite([e for _, _, e in res["history"]]))
                    or (init == "bank" and res["iters"] < 1)):
                raise AssertionError(f"[10b] {handle.task_id} {init}: tuning did not run")
        tuned.append((handle, runs))

    # (c) follow-ups carrying the tuned prompts: online insertion (Fig 5b)
    size0 = len(holdout)
    follow = "gpt2-base, service: follow-ups' lookups and a lookup on the grown bank"
    follow_ids = []
    for handle, runs in tuned:
        prompt = runs["bank"]["prompt"]["soft_prompt"].detach().float().cpu().numpy()
        feature = activation_features(model, prompt)
        req = SubmitRequest(task_id=handle.task_id, llm="gpt2-base", slo=120.0,
                            iters_manual=runs["manual"]["iters"], iters_bank=runs["bank"]["iters"],
                            tenant=handle.tenant, slo_class=handle.slo_class, prompt=prompt,
                            feature=feature)
        with plain_calls(calls), counted(kernels, by_label, follow):
            h, _ = submit(req)
        follow_ids.append(h.job_id)
    results = svc.run_until_idle()
    done = [r for r in results if r.handle.job_id in follow_ids and r.completed]
    online = [e.origin for e in holdout.entries[len(holdout.entries) - len(done):]]
    print(f"[10c] run_until_idle: {len(results)} jobs, {len(done)} follow-ups completed and "
          f"inserted {[r.inserted_to_bank for r in done]}; bank {size0} -> {len(holdout)} "
          f"entries, the new ones {online}")
    if (not done or not all(r.inserted_to_bank for r in done)
            or any(r.inserted_to_bank for r in results if r.handle.job_id not in follow_ids)
            or len(holdout) != size0 + len(done)
            or not all(o.endswith("/online") for o in online)):
        raise AssertionError("[10c] online insertion did not grow the bank by the completed "
                             "follow-ups")
    before = {n: k.launches for n, k in kernels.items()}
    with plain_calls(calls), counted(kernels, by_label, follow):
        after = holdout.lookup(score_factory(requests[0]))
        torch.cuda.synchronize()
    fired = {n: k.launches - before[n] for n, k in kernels.items()}
    print(f"[10c] lookup for {requests[0].task_id} on the grown bank: {after.entry.origin} "
          f"score {after.score:.6f}, {after.evaluations} evaluations, launches {fired}")
    if fired["score_ce"] <= 0 or fired["flash_attention"] <= 0 or not np.isfinite(after.score):
        raise AssertionError("[10c] the lookup on the grown bank did not run on the card")

    # (d) the schedule: the same requests through a second service, CPU only, no bank
    cpu_svc = service(None, None)
    for req in requests:
        cpu_svc.submit(req)
    key = lambda rs: [(r.handle.job_id, r.start, r.finish, r.gpus, r.violated) for r in rs]
    cpu_results = cpu_svc.run_until_idle()
    if key(cpu_results) != key(results) or cpu_svc.summary() != svc.summary():
        raise AssertionError("[10d] the schedule differs from the bankless service's")
    print(f"[10d] simulated schedule (job, start s, finish s, GPUs, violated), equal to a "
          f"second service's on the CPU with no bank and telemetry off: {key(results)}")
    print(f"[10d] simulated by the cluster model from LLM_PROFILES (the paper's A100 "
          f"figures; seconds and dollars of that model, not of this card): summary "
          f"{svc.summary()}; by tenant {svc.summary_by_tenant()}")

    phase_telemetry(svc, results, routed, card)

    # one routed submit, profiled on a second card-backed service with telemetry
    # on (outside the launch counts: the path was counted above)
    probe = service(holdout, score_factory, telemetry=True)
    req, probed = requests[0], []
    with plain_calls(calls):
        submit_profile = profile_calls(
            f"[10] one routed submit ({req.task_id}, {len(holdout)} entries)",
            lambda: probed.append(probe.submit(req)), warm=1, reps=3, traced=2)
    if not all(h.routed_through_bank for h in probed):
        raise AssertionError("[10] the profiled submit was not routed through the bank")
    busy = ("not measured" if submit_profile["device_ms"] is None else
            f"{submit_profile['device_ms']:.3f} ms (idle share "
            f"{submit_profile['idle_share']:.3f})")
    print(f"[10] one routed submit: host wall {submit_profile['wall_ms']:.3f} ms, device busy "
          f"{busy}, on {card}")

    launches = {n: sum(by_label[n].values()) for n in kernels}
    print(f"[10] kernel launches by the service's path: {by_label}; plain-version calls "
          f"{calls}")
    if any(n <= 0 for n in launches.values()) or any(calls.values()):
        raise AssertionError(f"[10] a kernel of the service's path was never launched, or a "
                             f"plain version ran: {launches} {calls}")
    print(f"[10] front door: {time.perf_counter() - t_phase:.3f} s on {card}")
    return {"by_label": by_label}


def phase_telemetry(svc, results, routed, card: str) -> None:
    """Phase 10e: the telemetry plane's record of the service's own run (counters,
    each routed handle's timeline, the SLO-attainment report, forensics), its
    exports written to a temporary directory, the Chrome trace validated by
    ``python -m repro_torch.obs`` and the JSONL export rendering the same report."""
    from repro_torch.obs import analyze, read_jsonl, render_report
    from repro_torch.obs.spans import QUEUED, RUNNING

    t0 = time.perf_counter()
    tel = svc.telemetry
    counters = tel.summary_counters()
    completed = sum(1 for r in results if r.completed)
    print(f"[10e] telemetry counters: {counters}")
    if counters["jobs_completed"] != completed or counters["jobs_submitted"] != len(results):
        raise AssertionError(f"[10e] telemetry counted {counters['jobs_completed']} completed of "
                             f"{counters['jobs_submitted']} submitted; the run completed "
                             f"{completed} of {len(results)}")
    for handle, *_ in routed:
        tl = handle.timeline()
        phases = {s.phase for s in tl.spans}
        print(f"[10e] {handle.task_id} timeline: "
              f"{[(s.phase, s.shard, s.start, s.end) for s in tl.spans]}")
        if not tl.done or not {QUEUED, RUNNING} <= phases:
            raise AssertionError(f"[10e] {handle.task_id}'s timeline is not done or lacks the "
                                 f"queued and running spans: {sorted(phases)}")
    report = svc.report()
    print(report)
    if "attainment" not in report:
        raise AssertionError("[10e] the report does not state the SLO attainment")
    forensics = svc.forensics_report()
    print(forensics.render())
    with tempfile.TemporaryDirectory(prefix="chip_smoke_obs_") as tmp:
        trace = tel.export_chrome_trace(str(Path(tmp) / "service.trace.json"))
        jsonl = tel.export_jsonl(str(Path(tmp) / "service.jsonl"))
        sizes = {Path(p).name: Path(p).stat().st_size for p in (trace, jsonl)}
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [str(ROOT / "src")] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
        proc = subprocess.run([sys.executable, "-m", "repro_torch.obs", "--validate", trace],
                              capture_output=True, text=True, env=env, timeout=300)
        print(f"[10e] python -m repro_torch.obs --validate: exit {proc.returncode}, "
              f"{proc.stdout.strip()} {proc.stderr.strip()}")
        if proc.returncode != 0 or "OK" not in proc.stdout:
            raise AssertionError("[10e] the exported Chrome trace did not validate")
        loaded = read_jsonl(jsonl)
    replay = render_report(loaded["timelines"], loaded["metrics"], bucket=tel.metrics.window)
    offline = analyze(loaded["timelines"], loaded["audit"])
    as_json = lambda rep: json.dumps(rep.to_dict(), sort_keys=True, default=float)  # noqa: E731
    if replay != svc.report() or as_json(offline) != as_json(forensics):
        raise AssertionError("[10e] the JSONL export renders another report or forensics")
    print(f"[10e] exports {sizes} bytes; the JSONL export renders the same report and "
          f"forensics; the report's seconds are simulated by the cluster model from "
          f"LLM_PROFILES (the paper's A100 figures), not this card's; telemetry read and "
          f"exported in {time.perf_counter() - t0:.3f} s of host time on {card}")


def cut_state(model, layers: int):
    """The config and the weights, copied to the CPU, of the first ``layers``
    layers of ``model`` (in layer order across its segments) with its
    embeddings and final norm, in f32; an encoder-decoder's encoder is cut
    to its first ``layers`` layers too."""
    over = dict(num_layers=layers, dtype="float32", param_dtype="float32")
    if model.cfg.encdec is not None:
        over["encdec"] = dataclasses.replace(model.cfg.encdec, num_encoder_layers=layers)
    cut = model.cfg.with_overrides(**over)
    kept, i = set(), 0
    for seg in model.segments:
        for j in range(seg.count):
            if i < layers:
                kept.add(f"{seg.name}.{j}")
            i += 1
    names = {seg.name for seg in model.segments}

    def keep(key: str) -> bool:
        p = key.split(".")
        if p[:2] == ["encoder", "blocks"]:
            return int(p[2]) < layers
        return p[0] not in names or ".".join(p[:2]) in kept
    state = {k: v.cpu() for k, v in model.state_dict().items() if keep(k)}
    return cut, state


def depth_cut(cut_and_state, dev):
    """The cut that ``cut_state`` made, as two models: one on the card and
    one on the CPU (the caller may free the full model in between)."""
    from repro_torch.models import Model

    cut, state = cut_and_state
    pair = []
    for device in (dev, "cpu"):
        m = Model(cut, device=device, seed=None)
        m.load_state_dict(state)             # the same (bf16) weights, widened
        pair.append(m)
    return pair


def teacher_forced_logits(model, tokens: torch.Tensor):
    """(decode, forward) logits: ``tokens`` decoded one step at a time from
    an empty cache, and the forward pass over the same tokens."""
    B, S = tokens.shape
    with torch.no_grad():
        full = model(tokens)
    cache = model.init_cache(B, S)
    dec = torch.stack([model.decode_step(cache, tokens[:, t:t + 1], t)[0][:, 0]
                       for t in range(S)], dim=1)
    return dec, full


def rel_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a - b).norm() / b.norm()).item()


def teacher_forced(label: str, model, tokens: torch.Tensor) -> float:
    """Hold teacher-forced decode logits against the forward pass."""
    dec, full = teacher_forced_logits(model, tokens)
    rel = rel_gap(dec, full)
    agree = (dec.argmax(-1) == full.argmax(-1)).float().mean().item()
    tol = DECODE_REL_TOL[model.dtype]
    print(f"{label} teacher-forced decode of {tokens.shape[1]} tokens x {tokens.shape[0]} rows "
          f"in {model.dtype} against the forward: ||dec - fwd|| / ||fwd|| = {rel:.3e} "
          f"(tol {tol}), max abs diff {(dec - full).abs().max().item():.3e}, "
          f"argmax agreement {agree:.3f}")
    if not torch.isfinite(dec).all() or not rel <= tol:
        raise AssertionError(f"{label} decode disagrees with the forward pass")
    return rel


@contextlib.contextmanager
def plain_attention(bwd=None):
    """Routes the model's flash_attention and flash_decode calls through
    their plain versions, on the card too: full f32 softmax and P·V, P
    never rounded to bf16. Under autograd the attention's backward is
    ``bwd(q, k, v, out, dout, lse, **kw)``, flash_attention_bwd_plain (f32
    P and dS) unless given."""
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import flash_decode as fd_mod
    from repro_torch.kernels import ops

    if bwd is None:
        bwd = lambda *a, **kw: fa_mod.flash_attention_bwd_plain(*a, **kw)   # noqa: E731

    class PlainAttention(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, kw):
            out, lse = fa_mod.flash_attention_plain(q, k, v, return_lse=True, **kw)
            ctx.save_for_backward(q, k, v, out, lse)
            ctx.kw = kw
            return out

        @staticmethod
        def backward(ctx, dout):
            q, k, v, out, lse = ctx.saved_tensors
            return (*bwd(q, k, v, out, dout, lse, **ctx.kw), None)

    def attention(q, k, v, **kw):
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
            return PlainAttention.apply(q, k, v, kw)
        return fa_mod.flash_attention_plain(q, k, v, **kw)

    def decode(q, k, v, *, splits=None, **kw):
        return fd_mod.flash_decode_plain(
            q, k, v, splits=fd_mod.DEFAULT_SPLITS if splits is None else splits, **kw)

    saved = ops.flash_attention, ops.flash_decode
    ops.flash_attention = attention
    ops.flash_decode = decode
    try:
        yield
    finally:
        ops.flash_attention, ops.flash_decode = saved


@contextlib.contextmanager
def plain_wkv():
    """Routes ``rwkv6_forward``'s WKV through the plain recurrence, on the
    card too: a forward that differs from the kernel's only in the order of
    its f32 sums."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.rwkv_wkv import rwkv6_wkv_plain

    kernel, ops.wkv = ops.wkv, rwkv6_wkv_plain
    try:
        yield
    finally:
        ops.wkv = kernel


def rwkv_depth_witness(model, tokens: torch.Tensor) -> dict:
    """Separates a fault in the full-depth decode from amplified rounding.

    Held: each layer's one-token decode steps, fed the forward's own input
    to that layer, against that layer's forward output (LAYER_DECODE_TOL),
    so no difference carries from one layer to the next. Read, not held:
    how a difference of f32 summation order alone grows with depth (the
    hidden state of a forward through the plain WKV against the kernel's,
    layer by layer) and the end-to-end gaps it leads to."""
    from repro_torch.models.transformer import block_cache, block_decode

    cfg, (B, S) = model.cfg, tokens.shape
    layer_gaps, drift = [], []
    with torch.no_grad():
        x, positions = model.embed_inputs(tokens)
        xp = x
        kind = model.segments[0].kind
        for block in model.blocks:
            y = block(x, positions)
            cache = block_cache(cfg, kind, B, S, model.device)
            dec = torch.cat([block_decode(cfg, kind, block, x[:, t:t + 1], cache, t)
                             for t in range(S)], dim=1)
            layer_gaps.append(((dec - y).norm() / (y - x).norm()).item())
            with plain_wkv():
                xp = block(xp, positions)
            drift.append(rel_gap(xp, y))
            x = y
        with plain_wkv():
            fwd_plain = model(tokens)
    dec, full = teacher_forced_logits(model, tokens)
    out = {"layer_gap_max": max(layer_gaps), "layer_gaps": layer_gaps, "drift": drift,
           "logits_kernel_vs_plain": rel_gap(fwd_plain, full), "logits_decode": rel_gap(dec, full)}
    n = len(layer_gaps)
    marks = [i for i in (1, 2, 4, 8, 16, 24, 32) if i <= n]
    print(f"[7w] {n} layers, f32, {S} tokens x {B} rows. Per-layer decode against forward, "
          f"||dec - fwd|| / ||increment||: max {out['layer_gap_max']:.3e} "
          f"(tol {LAYER_DECODE_TOL}); at layers {marks}: "
          f"{[f'{layer_gaps[i - 1]:.2e}' for i in marks]}")
    print(f"[7w] forward through the plain WKV against the kernel's, hidden state "
          f"||plain - kernel|| / ||kernel|| after layers {marks}: "
          f"{[f'{drift[i - 1]:.2e}' for i in marks]}")
    print(f"[7w] logits, relative norm: forward (plain WKV) against forward (kernel) "
          f"{out['logits_kernel_vs_plain']:.3e}; teacher-forced decode against forward "
          f"{out['logits_decode']:.3e}")
    if not all(np.isfinite(layer_gaps)) or not out["layer_gap_max"] <= LAYER_DECODE_TOL:
        raise AssertionError(f"rwkv6 decode disagrees with the forward within a layer: "
                             f"{layer_gaps}")
    return out


def free_card() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def decode_bound(B: int, H: int, Hkv: int, hd: int, live: int, elt: int,
                 peak_flops: float = PEAK_BF16_FLOPS):
    """Least time of one flash_decode call: K and V live rows read once, q
    read and the output written once; 4 operations per (head, row, dim)."""
    nbytes = 2 * B * live * Hkv * hd * elt + 2 * B * H * hd * elt
    return bound(4.0 * B * H * live * hd, nbytes, peak_flops)


def wkv_bound(B: int, H: int, T: int, hd: int, elt: int):
    """Least time of one rwkv6_wkv call: r, k, v (elt bytes), logw and y
    (f32), u and the final state; 4·hd² f32 operations per token and head."""
    nbytes = B * H * T * hd * (3 * elt + 4 + 4) + H * hd * 4 + B * H * hd * hd * 4
    return bound(4.0 * B * H * T * hd * hd, nbytes, PEAK_F32_FLOPS)


# -- phase 6 --------------------------------------------------------------------

def phase_serve(dev: torch.device, seed: int) -> dict:
    from repro_torch.config import INPUT_SHAPES
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_decode import auto_splits, flash_decode, flash_decode_plain
    from repro_torch.launch import make_serve_step
    from repro_torch.models import Model

    cfg = get_config("qwen2-7b")                       # full width, bf16
    t0 = time.perf_counter()
    model = Model(cfg, device=dev, seed=seed)
    torch.cuda.synchronize()
    H, Hkv, hd, V = cfg.num_heads, cfg.kv_heads(), cfg.resolved_head_dim(), cfg.vocab_size
    print(f"[6] {cfg.name}: {cfg.num_layers} layers, d={cfg.d_model}, H={H}, Hkv={Hkv}, "
          f"hd={hd}, V={V}, {cfg.dtype}; weights drawn on the card from seed {seed} in "
          f"{time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device=dev).manual_seed(seed + 1)

    # (a) teacher-forced decode against the forward pass
    tokens = torch.randint(3, V, (2, 32), generator=gen, device=dev)
    decode_rel = teacher_forced("[6a]", model, tokens)

    # (b) serve steps against a full decode_32k cache
    shape = INPUT_SHAPES["decode_32k"]
    B, L = 16, shape.seq_len
    per_row = cfg.num_layers * 2 * L * Hkv * hd * 2
    print(f"[6b] {shape.name}: cache of {L} tokens, batch {shape.global_batch} -> {B} to "
          f"fit 80 GB ({per_row * B / 1e9:.1f} GB of K/V at batch {B}, "
          f"{per_row * shape.global_batch / 1e9:.0f} GB at {shape.global_batch})")
    cache = model.init_cache(B, L)
    kv = cache["blocks"]["kv"]
    filled = L - 8                                     # a fixture: seeded K/V at positions 0..32759
    for i in range(cfg.num_layers):
        kv["k"][i, :, :filled].normal_(generator=gen)
        kv["v"][i, :, :filled].normal_(generator=gen)
    kv["pos"][:, :, :filled] = torch.arange(filled, device=dev, dtype=torch.int32)
    serve = make_serve_step(model)
    tok = torch.randint(3, V, (B, 1), generator=gen, device=dev, dtype=torch.int32)
    torch.cuda.synchronize()
    n_steps = L - filled
    flash_decode.launches = 0
    step_s = []
    for i in range(n_steps):
        t = time.perf_counter()
        tok, cache = serve(cache, tok, filled + i)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
    launches = flash_decode.launches
    if launches != cfg.num_layers * n_steps:
        raise AssertionError(f"flash_decode launched {launches} times in {n_steps} serve "
                             f"steps, not {cfg.num_layers} a step")
    if not ((tok >= 0) & (tok < V)).all():
        raise AssertionError("serve step produced tokens outside the vocabulary")
    med = statistics.median(step_s[1:])
    print(f"[6b] {n_steps} serve steps at cache_len {filled}..{L - 1}: "
          f"{[round(x * 1e3, 2) for x in step_s]} ms; median (steps 2..) {med * 1e3:.2f} ms "
          f"per step, {B / med:.0f} tokens/s; flash_decode launches {launches} "
          f"({launches // n_steps} per step)")

    # flash_decode at this shape, on layer 0's cache
    live = L - 1
    k, v = kv["k"][0].transpose(1, 2), kv["v"][0].transpose(1, 2)
    q = torch.randn(B, H, hd, generator=gen, device=dev).to(k.dtype)
    b_ms, b_by = decode_bound(B, H, Hkv, hd, live, k.element_size())
    splits = auto_splits(B, Hkv, H // Hkv, live,
                         torch.cuda.get_device_properties(dev).multi_processor_count)
    row = {"shape": f"B={B} H={H} Hkv={Hkv} hd={hd} L={L} kv_len={live} {cfg.dtype}, "
                    f"{splits} splits",
           "ms": time_ms(lambda: flash_decode(q, k, v, kv_len=live)),
           "plain_ms": time_ms(lambda: flash_decode_plain(q, k, v, kv_len=live), reps=5),
           "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
               q[:, :, None], k, v, enable_gqa=True)),
           "bound_ms": b_ms, "bound_by": b_by, "launches": launches,
           "launches_per_step": launches // n_steps}
    print(f"[6b] flash_decode {row['shape']}: kernel {row['ms']:.4f} ms, plain "
          f"{row['plain_ms']:.4f} ms, library (SDPA over all {L} rows) {row['library_ms']:.4f} ms, "
          f"bound {b_ms:.4f} ms ({b_by})")
    sdpa = lambda: F.scaled_dot_product_attention(q[:, :, None], k, v, enable_gqa=True)
    library_yardstick(f"[6b] flash_decode {row['shape']}",
                      lambda: flash_decode(q, k, v, kv_len=live), sdpa)
    row["profile"] = profile_calls("[6b] one serve step at batch 16, cache 32767",
                                   lambda: serve(cache, tok, L - 1), warm=2, reps=5, traced=3)
    row["step_ms"], row["tokens_per_s"], row["decode_rel"] = med * 1e3, B / med, decode_rel
    del cache, kv, k, v
    free_card()

    # (c) a 2-layer cut in f32, card against CPU
    card, cpu = depth_cut(cut_state(model, 2), dev)
    del model
    free_card()
    tokens = torch.randint(3, V, (2, 4), generator=gen, device=dev)
    cc, gcache = cpu.init_cache(2, 8), card.init_cache(2, 8)
    worst = 0.0
    for t in range(tokens.shape[1]):
        lg, _ = card.decode_step(gcache, tokens[:, t:t + 1], t)
        lc, _ = cpu.decode_step(cc, tokens[:, t:t + 1].cpu(), t)
        worst = max(worst, check_close(f"[6c] decode step {t}, card f32 against CPU f32",
                                       lg.cpu(), lc, F32_LOGIT_TOL))
    print(f"[6c] 2-layer f32 cut: 4 decode steps, card (kernels) against CPU (plain "
          f"versions): max abs logit diff {worst:.3e} (tol {F32_LOGIT_TOL})")
    del card, cpu
    free_card()
    return row


# -- phase 7 --------------------------------------------------------------------

def phase_rwkv(dev: torch.device, seed: int) -> dict:
    from repro_torch.config import TuneConfig
    from repro_torch.configs import get_config
    from repro_torch.core import build_bank, make_score_fn
    from repro_torch.data import make_tasks
    from repro_torch.kernels.rwkv_wkv import rwkv6_wkv, rwkv6_wkv_plain
    from repro_torch.kernels.score_ce import score_ce
    from repro_torch.models import Model

    cfg = get_config("rwkv6-7b")                        # full width, bf16
    t0 = time.perf_counter()
    model = Model(cfg, device=dev, seed=seed)
    torch.cuda.synchronize()
    print(f"[7] {cfg.name}: {cfg.num_layers} layers, d={cfg.d_model}, "
          f"{cfg.d_model // cfg.ssm.state_size} heads of {cfg.ssm.state_size}, "
          f"d_ff={cfg.d_ff}, V={cfg.vocab_size}, {cfg.dtype}; weights drawn on the card "
          f"from seed {seed} in {time.perf_counter() - t0:.1f} s")
    tune_cfg = TuneConfig(prompt_len=16)
    tasks = make_tasks(vocab=32, partitions=2)         # 12 families x 2 = 24 tasks
    rng = np.random.default_rng(seed)
    d = cfg.d_model
    seed_prompts = {t.task_id: rng.normal(0, 0.5 / np.sqrt(d), (tune_cfg.prompt_len, d))
                    .astype(np.float32) for t in tasks}
    requests = [tasks[3], tasks[14],
                make_tasks(input_len=248, target_len=248)[9]]   # 33, 33, 513 positions

    kernels = {"rwkv6_wkv": rwkv6_wkv, "score_ce": score_ce}
    by_shape = {name: {} for name in kernels}
    rwkv6_wkv.launches = score_ce.launches = 0
    t0 = time.perf_counter()
    with counted(kernels, by_shape, "bank build"):
        bank = build_bank(model, seed_prompts, variants_per_prompt=2, seed=seed)
    torch.cuda.synchronize()
    print(f"[7] bank: {len(bank.entries)} candidates (24 tasks x 2 variants), "
          f"{len(bank.medoid_ids)} clusters, features + clustering "
          f"{time.perf_counter() - t0:.3f} s")
    if len(bank.entries) != 48 or len(bank.medoid_ids) != 12:
        raise AssertionError("bank does not hold 48 candidates in 12 clusters")
    results = []
    for task in requests:
        score_fn = make_score_fn(model, task, tune_cfg)
        positions = tune_cfg.prompt_len + score_fn.eval_batch["tokens"].shape[1]
        with counted(kernels, by_shape, eval_shape(score_fn, positions)):
            res = bank.lookup(score_fn)
        if not np.isfinite(res.score) or res.evaluations < len(bank.medoid_ids):
            raise AssertionError(f"lookup for {task.task_id} gave {res}")
        print(f"[7] request {task.task_id} ({positions} positions): origin={res.entry.origin} "
              f"score={res.score:.6f} evaluations={res.evaluations} "
              f"latency={res.latency_s:.3f} s")
        results.append((task, res, score_fn))
    launches = {"rwkv6_wkv": rwkv6_wkv.launches, "score_ce": score_ce.launches}
    print(f"[7] kernel launches on the lookup path: {launches}; by shape {by_shape}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was never launched on the rwkv6 lookup path")

    # rwkv6_wkv at the lookup's shapes: (B, T, H, hd) projections read in place
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    B, H, hd = 16, cfg.d_model // cfg.ssm.state_size, cfg.ssm.state_size
    rows = []
    for T in (33, 513):
        r, k, v = (torch.randn(B, T, H, hd, generator=gen, device=dev).to(torch.bfloat16)
                   .transpose(1, 2) for _ in range(3))
        logw = (-torch.exp(torch.randn(B, T, H, hd, generator=gen, device=dev) - 1.5)
                ).transpose(1, 2)
        u = 0.02 * torch.randn(H, hd, generator=gen, device=dev)
        b_ms, b_by = wkv_bound(B, H, T, hd, 2)
        rows.append({"shape": f"B={B} H={H} T={T} hd={hd} bf16 r/k/v, zero start state",
                     "ms": time_ms(lambda: rwkv6_wkv(r, k, v, logw, u, None)),
                     "plain_ms": time_ms(lambda: rwkv6_wkv_plain(r, k, v, logw, u, None),
                                         reps=5),
                     "library_ms": None, "bound_ms": b_ms, "bound_by": b_by})
        print(f"[7] rwkv6_wkv {rows[-1]['shape']}: kernel {rows[-1]['ms']:.4f} ms, plain "
              f"{rows[-1]['plain_ms']:.4f} ms, no library call, bound {b_ms:.4f} ms ({b_by})")
        kernel_launches(f"[7] rwkv6_wkv T={T}", lambda: rwkv6_wkv(r, k, v, logw, u, None))
        del r, k, v, logw
    score_rows = score_ce_rows("[7]", cfg.name, model.output_embedding().detach(),
                               (16 * 17, 16 * 497), gen)
    task, res, score_fn = results[0]
    before = rwkv6_wkv.launches
    score_fn(res.entry)
    per_eval = rwkv6_wkv.launches - before
    rows[0].update(launches=launches["rwkv6_wkv"], launches_per_eval=per_eval)
    print(f"[7] rwkv6_wkv launches per evaluation: {per_eval}")
    profiles = []
    for task, res, score_fn in (results[0], results[-1]):
        positions = 16 + score_fn.eval_batch["tokens"].shape[1]
        profiles.append(profile_calls(f"[7] one rwkv6-7b evaluation at {positions} positions",
                                      lambda: score_fn(res.entry)))

    tune = phase_rwkv_tune(model, seed)

    # decode against the forward pass: at full depth in f32 (the same
    # weights, widened) layer by layer; end to end on the 2-layer cut
    tokens = torch.randint(3, cfg.vocab_size, (2, 16), generator=gen, device=dev)
    f32 = Model(cfg.with_overrides(dtype="float32", param_dtype="float32"), device=dev,
                seed=None)
    f32.load_state_dict(model.state_dict())
    del model
    free_card()
    rows[0]["witness"] = rwkv_depth_witness(f32, tokens)
    card, cpu = depth_cut(cut_state(f32, 2), dev)
    del f32
    free_card()
    rows[0]["decode_rel"] = teacher_forced("[7] 2-layer cut", card, tokens)

    # the 2-layer cut in f32: Eqn-1 scores, card against CPU
    task, res = results[0][0], results[0][1]
    other = next(bank.entries[i] for i in bank.medoid_ids if bank.entries[i] is not res.entry)
    failed = []
    for entry in (res.entry, other):
        c = make_score_fn(cpu, task, tune_cfg)(entry)
        g = make_score_fn(card, task, tune_cfg)(entry)
        rel = abs(g - c) / abs(c)
        print(f"[7] 2-layer f32 cut, {task.task_id} {entry.origin}: cpu {c:.6f}, card {g:.6f} "
              f"(rel {rel:.2e}, tol {F32_SCORE_RTOL})")
        if not rel <= F32_SCORE_RTOL:
            failed.append(entry.origin)
    del card, cpu
    free_card()
    if failed:
        raise AssertionError(f"rwkv6 card scores disagree with the CPU f32 path for {failed}")
    return {"rows": rows, "profiles": profiles, "launches": launches, "by_shape": by_shape,
            "score_rows": score_rows, "tune": tune}


# The rwkv6_wkv backward's checks (phase 9e): B, H, T, decay, start state,
# dS_T. B·H = 1 and the tuning shape (8 rows of 64 heads); T around the f32
# kernel's 8-token interval and the bf16 kernel's 16-token sub-chunk, and
# 529 (a 513-token lookup's tokens and 16 prompt positions). Decays as
# phase 2 draws them, but "steep" (logw = -e^4, w about 1e-24) on every
# other step only, so that the state and its gradient span many orders of
# magnitude instead of being reset every step; "mixed" is steep in every
# step of half the channels (past the bf16 kernel's guard: its scores go
# element by element) and "edge" is logw = -3.7 throughout (a sub-chunk's
# decay e^-59.2, just inside the guard: factors up to e^59).
WKV_BWD_CASES = [
    (8, 64, 33, "drawn", False, False),         # the tuning path's call
    (8, 64, 33, "drawn", True, True), (8, 64, 529, "drawn", True, True),
    (1, 1, 1, "drawn", True, True), (1, 1, 15, "steep", False, True),
    (1, 1, 16, "none", True, False), (1, 1, 17, "steep", True, True),
    (1, 1, 33, "drawn", False, False), (8, 64, 1, "drawn", True, False),
    (8, 64, 15, "steep", False, False), (8, 64, 16, "drawn", False, True),
    (8, 64, 17, "none", True, True), (8, 64, 33, "steep", True, True),
    (8, 64, 529, "steep", False, True),
    (8, 64, 31, "drawn", True, True), (8, 64, 32, "edge", False, True),
    (8, 64, 33, "mixed", True, True), (1, 1, 32, "mixed", True, False),
    (1, 1, 31, "edge", False, False), (8, 64, 529, "mixed", True, True),
]
WKV_GRADS = ("dr", "dk", "dv", "dlogw", "du", "dS0")


def check_rel_max(name: str, out: torch.Tensor, ref: torch.Tensor, tol: float) -> float:
    """max |out - ref| / max |ref|; raises past ``tol`` or on a non-finite out."""
    out, ref = out.float(), ref.float()
    err = (out - ref).abs().max().item() / max(ref.abs().max().item(), 1e-30)
    if not torch.isfinite(out).all() or not err <= tol:
        raise AssertionError(f"{name}: kernel disagrees with its plain version (max abs err "
                             f"{err:.3e} of the largest element, tol {tol})")
    return err


def wkv_bwd_inputs(gen, dev, B: int, H: int, T: int, decay: str, with_state: bool,
                   with_ds: bool, dtype, hd: int = 64, wide: bool = False) -> tuple:
    """(r, k, v, logw, u, state0, dy, dS_T) of one backward call: r, k, v,
    logw and dy as (B, T, H, hd) tensors seen as (B, H, T, hd), as the model
    hands them (with ``wide``, views of rows 2 elements wider, so not 16
    bytes apart)."""
    def view(dt, fn=lambda x: x):
        extra = 2 if wide else 0
        x = fn(torch.randn(B, T, H * hd + extra, generator=gen, device=dev)).to(dt)
        return x[..., :H * hd].view(B, T, H, hd).transpose(1, 2)
    r, k, v = (view(dtype, lambda x: 0.5 * x) for _ in range(3))
    drawn = lambda x: (-torch.exp(x - 1.5)).clamp_min(-12.0)
    logw = view(torch.float32, torch.zeros_like if decay == "none" else drawn)
    if decay == "steep":
        logw[:, :, ::2] = -float(np.exp(4.0))
    elif decay == "mixed":
        logw[..., ::2] = -float(np.exp(4.0))
    elif decay == "edge":
        logw.fill_(-3.7)
    u = 0.5 * torch.randn(H, hd, generator=gen, device=dev)
    s0 = 0.5 * torch.randn(B, H, hd, hd, generator=gen, device=dev) if with_state else None
    dy = view(torch.float32)
    ds = torch.randn(B, H, hd, hd, generator=gen, device=dev) if with_ds else None
    return r, k, v, logw, u, s0, dy, ds


def wkv_bwd_bound(B: int, H: int, T: int, hd: int, elt: int):
    """Least time of one rwkv6_wkv_bwd call without the end states: r, k, v
    (elt bytes), logw and dy (f32) read once, dr, dk, dv (elt) and dlogw
    (f32) written once, u and du; 12·hd² operations per token and head (dr,
    dk, dv, dlogw, the G update and the forward state again) at the TF32
    tensor-core peak, where the bf16 kernel runs them. Returns (ms, "bytes"
    or "operations", the operations' time on the CUDA cores in ms)."""
    nbytes = B * H * T * hd * (6 * elt + 3 * 4) + 2 * H * hd * 4
    flops = 12.0 * B * H * T * hd * hd
    return (*bound(flops, nbytes, PEAK_TF32_FLOPS), flops / PEAK_F32_FLOPS * 1e3)


def phase_rwkv_tune(model, seed: int) -> dict:
    """9e on phase 7's rwkv6-7b (bf16, full width): (i) rwkv6_wkv_bwd against
    its plain version, bitwise repeatable, launching its own kernels only,
    and its times; (ii) ten Adam steps of a 2-layer f32 cut, card against
    CPU; (iii) PromptTuner.tune at full width for 10 iterations."""
    from repro_torch.config import TuneConfig
    from repro_torch.data import LoaderConfig, TaskLoader
    from repro_torch.kernels.rwkv_wkv import rwkv6_wkv_bwd, rwkv6_wkv_bwd_plain
    from repro_torch.models import prompt_from_arrays
    from repro_torch.tuning import PromptTuner

    dev = model.device
    gen = torch.Generator(device=dev).manual_seed(seed + 19)
    worst = 0.0
    cases = [(c, False) for c in WKV_BWD_CASES] + [((2, 4, 37, "drawn", True, True), True)]
    for dtype in (torch.bfloat16, torch.float32):
        for (B, H, T, decay, with_state, with_ds), wide in cases:
            args = wkv_bwd_inputs(gen, dev, B, H, T, decay, with_state, with_ds, dtype,
                                  wide=wide)
            out = rwkv6_wkv_bwd(*args)
            again = rwkv6_wkv_bwd(*args)
            torch.cuda.synchronize()
            ref = rwkv6_wkv_bwd_plain(*args)
            name = (f"rwkv6_wkv_bwd B*H={B * H} T={T} {decay} decay state0={with_state} "
                    f"dS_T={with_ds}{' rows 2 elements wider' if wide else ''} {dtype}")
            errs = {g: check_rel_max(f"{name} {g}", a, b, WKV_BWD_TOL[dtype])
                    for g, a, b in zip(WKV_GRADS, out, ref) if a is not None}
            if not all(a is None or torch.equal(a, c) for a, c in zip(out, again)):
                raise AssertionError(f"{name}: the gradients changed between two calls")
            if (out[5] is None) == with_state:
                raise AssertionError(f"{name}: dS_0 given without a start state, or missing")
            worst = max(worst, *errs.values())
            print(f"[9e] {name}: max abs err / max |plain| "
                  f"{', '.join(f'{g} {e:.2e}' for g, e in errs.items())} "
                  f"(tol {WKV_BWD_TOL[dtype]}); bitwise equal between two calls")
            del args, out, again, ref
    rows = []
    for T in (33, 529):                  # the tuning shape, and a 513-token lookup's length
        r, k, v, logw, u, _, dy, _ = wkv_bwd_inputs(gen, dev, 8, 64, T, "drawn", False, False,
                                                    torch.bfloat16)
        call = lambda: rwkv6_wkv_bwd(r, k, v, logw, u, None, dy, None, need_du=False)
        b_ms, b_by, cuda_core_ms = wkv_bwd_bound(8, 64, T, 64, 2)
        rows.append({"shape": f"B=8 H=64 T={T} hd=64 bf16 r/k/v, zero start state, no dS_T",
                     "ms": time_ms(call),
                     "plain_ms": time_ms(lambda: rwkv6_wkv_bwd_plain(r, k, v, logw, u, None, dy),
                                         reps=3, warmup=1),
                     "library_ms": None, "bound_ms": b_ms, "bound_by": b_by})
        print(f"[9e] rwkv6_wkv_bwd {rows[-1]['shape']}: kernel {rows[-1]['ms']:.4f} ms, plain "
              f"{rows[-1]['plain_ms']:.4f} ms, library: none (no single PyTorch call computes "
              f"WKV's backward), bound {b_ms:.4f} ms ({b_by}; the operations on the CUDA cores "
              f"would take {cuda_core_ms:.4f} ms)")
        own_kernels("rwkv6_wkv_bwd", kernel_launches(f"[9e] rwkv6_wkv_bwd T={T}", call))
        del r, k, v, logw, dy
    free_card()

    # (ii) ten Adam steps of the 2-layer f32 cut, card against CPU
    tune_cfg = TuneConfig()                            # P=16, batch 8, lr 0.3, eval 10, 16 samples
    task = synthetic_task()
    d = model.cfg.d_model
    prompt0 = np.random.default_rng(seed).normal(
        0, 0.5 / np.sqrt(d), (tune_cfg.prompt_len, d)).astype(np.float32)
    cut = tune_cut_card_vs_cpu("[9e]", model, task, tune_cfg, prompt0, seed, chaotic=True)

    # (iii) PromptTuner.tune at full width, 10 iterations at TuneConfig's defaults
    tuner = PromptTuner(model, tune_cfg)
    losses, step = [], tuner.step

    def recording_step(*a):                            # every iteration's loss, read at the end
        out = step(*a)
        losses.append(out[2])
        return out

    tuner.step = recording_step
    loader = TaskLoader(task, LoaderConfig(batch_size=tune_cfg.batch_size, seed=seed))
    torch.cuda.reset_peak_memory_stats(dev)
    iters = 10
    t0 = time.perf_counter()
    res, launches = main_path(f"[9e] tune, {iters} iterations", lambda: tuner.tune(
        loader, prompt_from_arrays({"soft_prompt": prompt0}, dev), max_iters=iters), RWKV_TUNING)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    tuner.step = step
    losses = torch.stack(losses).tolist()
    evals = [(it, round(l, 6), round(e, 6)) for it, l, e in res["history"]]
    layers = model.cfg.num_layers
    print(f"[9e] {model.cfg.name} tune, {iters} iterations in {wall:.3f} s ({wall / iters * 1e3:.3f} "
          f"ms an iteration with its share of {len(evals)} evaluation); losses "
          f"{[round(l, 6) for l in losses]}; history {evals}; max_memory_allocated {peak:.2f} GiB")
    if (res["iters"] != iters or len(losses) != iters or not np.isfinite(losses).all()
            or not torch.isfinite(res["prompt"]["soft_prompt"]).all()):
        raise AssertionError(f"[9e] tune did not run {iters} finite iterations: {losses}")
    if launches["rwkv6_wkv_bwd"] != layers * iters:
        raise AssertionError(f"[9e] rwkv6_wkv_bwd launched {launches['rwkv6_wkv_bwd']} times in "
                             f"{iters} steps, not {layers} a step")
    pp = prompt_from_arrays({"soft_prompt": prompt0}, dev)
    holder = {"pp": pp, "opt": tuner.init_opt(pp)}
    batch = next(loader)
    positions = batch["tokens"].size + tune_cfg.batch_size * tune_cfg.prompt_len

    def one_step():
        holder["pp"], holder["opt"], _ = tuner.step(holder["pp"], holder["opt"], batch)

    main_path("[9e] one step", one_step, RWKV_TUNING)
    profile = step_profile(f"[9e] one {model.cfg.name} PromptTuner.step, batch 8 x 33 positions",
                           one_step, positions)
    del tuner, holder
    free_card()
    return {"rows": rows, "worst": worst, "launches": launches, "iters": iters,
            "peak_gib": peak, "profile": profile, "cut": cut}


# -- phase 8 --------------------------------------------------------------------

def mla_bound(B: int, H: int, live: int, elt: int):
    """Least time of one mla_decode call: the live latent rows (r + rd wide)
    read once, q read and the output written once; per (head, live row)
    2·(r + rd) operations for the score and 2·r for P·ckv, at the bf16
    tensor-core rate."""
    r, rd = 512, 64
    nbytes = B * live * (r + rd) * elt + B * H * (2 * r + rd) * elt
    return bound(2.0 * B * H * live * (2 * r + rd), nbytes, PEAK_BF16_FLOPS)


def sdpa_mla(q_lat, q_pe, ckv, kpe, live: int, scale: float):
    """The nearest single PyTorch call to mla_decode: one
    ``scaled_dot_product_attention`` with a row's H heads as the query
    sequence of one head, keys [ckv | kpe] (576 wide) and values ckv of the
    live rows, no mask (the concatenation is made once, outside the call).
    Returns (call, backend) for the first backend that takes it, trying
    flash, memory-efficient, cuDNN, then the math backend."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    q = torch.cat([q_lat, q_pe], dim=-1)[:, None]                  # (B, 1, H, 576)
    k = torch.cat([ckv[:, :live], kpe[:, :live]], dim=-1)[:, None]  # (B, 1, live, 576)
    v = ckv[:, None, :live]
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        def call(backend=backend):
            with sdpa_kernel([backend]):
                return F.scaled_dot_product_attention(q, k, v, scale=scale)[:, 0]
        try:
            call()
            torch.cuda.synchronize()
        except RuntimeError:
            continue
        return call, backend.name
    raise AssertionError("no SDPA backend computes the MLA decode call")


MLA_DECODE_CASES = [  # B, H, L, kwargs of phase 8a's parity checks, cache layout
    (16, 128, 32768, {"kv_len": 32768}, "apart"),             # deepseek-v2 serve shape, whole cache
    (16, 128, 32768, {"kv_len": 20001}, "apart"),             # ragged against the 64-row tile
    (2, 64, 4096, {"kv_len": 37}, "apart"),                   # kimi-k2's 64 heads
    (1, 16, 4096, {"kv_len": 1, "splits": 8}, "apart"),       # one live row: 7 of 8 splits empty
    (2, 128, 4096, {"kv_len": 1001, "q_pos": 500}, "apart"),  # q_pos < kv_len - 1
    (1, 64, 2000, {"kv_len": 2000}, "apart"),
    (16, 16, 1000, {"kv_len": 999}, "apart"),
    # the edges of the bf16 kernel's 64-row tile and its 2-stage ring, in one split
    (2, 128, 256, {"kv_len": 63, "splits": 1}, "apart"),
    (2, 128, 256, {"kv_len": 64, "splits": 1}, "apart"),
    (2, 128, 256, {"kv_len": 65, "splits": 1}, "apart"),
    (1, 128, 512, {"kv_len": 321, "splits": 1}, "apart"),     # 6 tiles: each stage thrice
    (3, 40, 1000, {"kv_len": 700}, "apart"),                  # H = 40: 24 heads of TMA's zeros
    (1, 128, 4096, {"kv_len": 3, "splits": 3}, "apart"),      # every split one row
    # ckv and kpe as views of one (B, L, 584) row, 8 elements in: bases and
    # strides stay 16-byte multiples, so the kernel takes them
    (2, 128, 3000, {"kv_len": 2999}, "fused"),
]


def latent_cache(B: int, L: int, dtype, gen, dev, layout: str):
    """(ckv (B, L, 512), kpe (B, L, 64)) drawn from N(0, 1): two tensors
    ("apart"), or views of one wider row ("fused")."""
    if layout == "fused":
        row = torch.randn(B, L, 584, generator=gen, device=dev).to(dtype)
        return row[..., 8:520], row[..., 520:]
    return tuple(torch.randn(B, L, d, generator=gen, device=dev).to(dtype) for d in (512, 64))


def phase_mla_kernel(dev: torch.device, seed: int) -> dict:
    """8a: mla_decode against its plain version, then its times."""
    from repro_torch.config import INPUT_SHAPES
    from repro_torch.kernels.mla_decode import auto_splits, mla_decode, mla_decode_plain

    gen = torch.Generator(device=dev).manual_seed(seed + 3)
    scale = 1.0 / (128 + 64) ** 0.5
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for B, H, L, kw, layout in MLA_DECODE_CASES:
            ql, qp = (torch.randn(B, H, d, generator=gen, device=dev).to(dtype) for d in (512, 64))
            ckv, kpe = latent_cache(B, L, dtype, gen, dev, layout)
            out = mla_decode(ql, qp, ckv, kpe, scale=scale, **kw)
            torch.cuda.synchronize()
            ref = mla_decode_plain(ql, qp, ckv, kpe, scale=scale, **kw)
            top = ref.float().abs().max().item()
            rtol, atol = ((DECODE_BF16_RTOL, DECODE_BF16_ATOL * top)
                          if dtype == torch.bfloat16 else (TOL[dtype], TOL[dtype]))
            err = check_close(f"mla_decode {(B, H, L)} {kw} {layout} {dtype}", out, ref, rtol, atol)
            worst = max(worst, err)
            print(f"[8a] mla_decode B={B} H={H} L={L} {kw} cache {layout} {dtype} "
                  f"({kw.get('splits') or auto_splits(B, H, min(L, kw['kv_len']), sms, dtype)} splits): "
                  f"max abs err "
                  f"{err:.3e} (rtol {rtol}, atol {atol:.2e}; max |out| {top:.3e})")
            del ql, qp, ckv, kpe, out, ref
        # a view whose base is not 16-byte aligned is refused before any launch
        ql, qp = (torch.randn(1, 64, d, generator=gen, device=dev).to(dtype) for d in (512, 64))
        row = torch.randn(1, 256, 584, generator=gen, device=dev).to(dtype)
        try:
            mla_decode(ql, qp, row[..., 1:513], row[..., 520:], scale=scale, kv_len=200)
        except ValueError as e:
            print(f"[8a] mla_decode refuses a ckv view 1 element in ({dtype}): {e}")
        else:
            raise AssertionError("mla_decode took a ckv base that TMA cannot load")
    rows = []
    for shape_name, B in (("decode_32k", 16), ("long_500k", INPUT_SHAPES["long_500k"].global_batch)):
        L, H = INPUT_SHAPES[shape_name].seq_len, 128
        live = L - 1
        ql, qp = (torch.randn(B, H, d, generator=gen, device=dev).bfloat16() for d in (512, 64))
        ckv, kpe = (torch.randn(B, L, d, generator=gen, device=dev).bfloat16() for d in (512, 64))
        library, backend = sdpa_mla(ql, qp, ckv, kpe, live, scale)
        b_ms, b_by = mla_bound(B, H, live, 2)
        row = {"shape": f"{shape_name}: B={B} H={H} r=512 rd=64 L={L} kv_len={live} bf16, "
                        f"{auto_splits(B, H, live, sms)} splits",
               "ms": time_ms(lambda: mla_decode(ql, qp, ckv, kpe, scale=scale, kv_len=live)),
               "plain_ms": time_ms(lambda: mla_decode_plain(ql, qp, ckv, kpe, scale=scale,
                                                            kv_len=live), reps=5),
               "library_ms": time_ms(library, reps=5), "library": f"SDPA, {backend} backend",
               "bound_ms": b_ms, "bound_by": b_by}
        print(f"[8a] mla_decode {row['shape']}: kernel {row['ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f} ms, library ({row['library']}) {row['library_ms']:.4f} ms, "
              f"bound {b_ms:.4f} ms ({b_by})")
        kernel_launches(f"[8a] mla_decode {shape_name} launches",
                        lambda: mla_decode(ql, qp, ckv, kpe, scale=scale, kv_len=live))
        rows.append(row)
        del ql, qp, ckv, kpe, library
        free_card()
    return {"worst": worst, "rows": rows}


@contextlib.contextmanager
def recorded_routes(no_drops: bool = False):
    """Records the expert ids (T, k) of every MoE routing, in call order;
    with ``no_drops`` the capacity factor is num_experts / top_k, so every
    expert has a slot for every token and no pair drops."""
    import dataclasses

    from repro_torch.models import moe

    route, capacity, calls = moe.route, moe.capacity, []

    def recording(m, router_w, x_flat):
        out = route(m, router_w, x_flat)
        calls.append(out[1])
        return out

    def roomy(m, tokens):
        return capacity(dataclasses.replace(m, capacity_factor=m.num_experts / m.top_k), tokens)

    moe.route = recording
    if no_drops:
        moe.capacity = roomy
    try:
        yield calls
    finally:
        moe.route, moe.capacity = route, capacity


def routing_flips(fwd_ids: list, dec_ids: list, layers: int, B: int, S: int) -> torch.Tensor:
    """(B, S, layers) bool: whether a token's set of experts in a layer
    differs between the forward (one routing of B·S tokens per layer) and
    teacher-forced decode (one routing of B tokens per layer and step)."""
    fwd = torch.stack([f.reshape(B, S, -1) for f in fwd_ids], dim=2)
    dec = torch.stack([torch.stack(dec_ids[t * layers:(t + 1) * layers], dim=1)
                       for t in range(S)], dim=1)
    return (fwd.sort(dim=-1).values != dec.sort(dim=-1).values).any(dim=-1)


def moe_layer_witness(model, tokens: torch.Tensor) -> dict:
    """Each layer's one-token decode steps, fed the forward's own input to
    that layer, against the layer's forward output, in the model's dtype and
    with nothing dropped: ||decode - forward|| / ||layer increment|| over
    the tokens whose routing in that layer matched, held at
    LAYER_DECODE_BF16_TOL, and the share of tokens whose routing differed."""
    from repro_torch.models.transformer import block_cache, block_decode

    cfg, (B, S) = model.cfg, tokens.shape
    gaps, flips = [], []
    with torch.no_grad(), recorded_routes(no_drops=True) as calls:
        x, positions = model.embed_inputs(tokens)
        for seg in model.segments:
            for block in getattr(model, seg.name):
                first = len(calls)
                y = block(x, positions)
                y = y[0] if seg.kind == "moe" else y
                cache = block_cache(cfg, seg.kind, B, S, model.device)
                dec = torch.cat([block_decode(cfg, seg.kind, block, x[:, t:t + 1], cache, t)
                                 for t in range(S)], dim=1)
                flipped = (routing_flips(calls[first:first + 1], calls[first + 1:], 1, B, S)[..., 0]
                           if seg.kind == "moe" else torch.zeros(B, S, dtype=torch.bool,
                                                                 device=x.device))
                keep = ~flipped
                gaps.append(((dec - y)[keep].float().norm() / (y - x)[keep].float().norm()).item())
                flips.append(flipped.float().mean().item())
                x = y
    print(f"[8c] {len(gaps)} layers in bf16, each fed the forward's input: ||dec - fwd|| / "
          f"||increment|| over tokens whose routing matched {[f'{g:.2e}' for g in gaps]} (tol "
          f"{LAYER_DECODE_BF16_TOL}); share of tokens whose routing differed "
          f"{[round(f, 3) for f in flips]}")
    if not all(np.isfinite(gaps)) or max(gaps) > LAYER_DECODE_BF16_TOL:
        raise AssertionError(f"[8c] deepseek-v2 decode disagrees with the forward within a "
                             f"layer: {gaps}")
    return {"layer_gaps": gaps, "layer_flips": flips}


def phase_mla_serve(dev: torch.device, seed: int) -> dict:
    """8b-8e on deepseek-v2-236b at full width, cut in depth to fit the card."""
    from repro_torch.config import INPUT_SHAPES, TuneConfig
    from repro_torch.configs import get_config
    from repro_torch.core import build_bank, make_score_fn
    from repro_torch.data import make_tasks
    from repro_torch.kernels.mla_decode import mla_decode
    from repro_torch.kernels.score_ce import score_ce
    from repro_torch.launch import make_serve_step
    from repro_torch.models import Model
    from repro_torch.models.moe import assign_slots, capacity

    shape = INPUT_SHAPES["decode_32k"]
    B, L = 16, shape.seq_len
    full = get_config("deepseek-v2-236b")
    m = full.mla
    for moe_layers in (8, 7):                        # 7 only if 8 leave under 6 GiB free
        cfg = full.with_overrides(num_layers=1 + moe_layers)
        t0 = time.perf_counter()
        model = Model(cfg, device=dev, seed=seed)
        cache = model.init_cache(B, L)
        torch.cuda.synchronize()
        free = torch.cuda.mem_get_info(dev)[0] / 2 ** 30
        if free >= 6.0 or moe_layers == 7:
            break
        print(f"[8b] {free:.1f} GiB free with 8 MoE layers and the cache: cutting to 7")
        del model, cache
        free_card()
    n_layers = cfg.num_layers
    params = sum(p.numel() * p.element_size() for p in model.parameters()) / 2 ** 30
    cache_gib = sum(t.numel() * t.element_size() for seg in cache.values()
                    for t in seg["kv"].values()) / 2 ** 30
    print(f"[8b] {cfg.name}: {n_layers} of {full.num_layers} layers (1 dense + {moe_layers} MoE), "
          f"d={cfg.d_model}, H={cfg.num_heads}, MLA r={m.kv_lora_rank} q_lora={m.q_lora_rank} "
          f"nope/rope/v {m.qk_nope_head_dim}/{m.qk_rope_head_dim}/{m.v_head_dim}, "
          f"{cfg.moe.num_experts} experts top-{cfg.moe.top_k} + {cfg.moe.num_shared_experts} "
          f"shared of {cfg.moe.d_ff_expert}, V={cfg.vocab_size}, {cfg.dtype}; weights "
          f"({params:.1f} GiB, the (V, d) output copy included) drawn on the card from seed "
          f"{seed}; {shape.name} cache {cache_gib:.2f} GiB at batch {B} (batch "
          f"{shape.global_batch}: {cache_gib * shape.global_batch / B:.1f} GiB); "
          f"{free:.1f} GiB free; {time.perf_counter() - t0:.1f} s")

    # (b) serve steps against a full decode_32k latent cache
    gen = torch.Generator(device=dev).manual_seed(seed + 4)
    filled = L - 8                                     # a fixture: seeded latents at 0..32759
    for seg in cache.values():
        kv = seg["kv"]
        for i in range(kv["c_kv"].shape[0]):
            kv["c_kv"][i, :, :filled].normal_(generator=gen)
            kv["k_rope"][i, :, :filled].normal_(generator=gen)
        kv["pos"][:, :, :filled] = torch.arange(filled, device=dev, dtype=torch.int32)
    serve = make_serve_step(model)
    V = cfg.vocab_size
    tok = torch.randint(3, V, (B, 1), generator=gen, device=dev, dtype=torch.int32)
    torch.cuda.synchronize()
    n_steps = L - filled
    mla_decode.launches = 0
    step_s = []
    for i in range(n_steps):
        t = time.perf_counter()
        tok, cache = serve(cache, tok, filled + i)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
    launches = mla_decode.launches
    if launches != n_layers * n_steps:
        raise AssertionError(f"mla_decode launched {launches} times in {n_steps} serve steps, "
                             f"not {n_layers} a step")
    if not ((tok >= 0) & (tok < V)).all():
        raise AssertionError("serve step produced tokens outside the vocabulary")
    med = statistics.median(step_s[1:])
    print(f"[8b] {n_steps} serve steps at cache_len {filled}..{L - 1}: "
          f"{[round(x * 1e3, 2) for x in step_s]} ms; median (steps 2..) {med * 1e3:.2f} ms "
          f"per step, {B / med:.0f} tokens/s; mla_decode launches {launches} "
          f"({launches // n_steps} per step)")
    out = {"launches": launches, "step_ms": med * 1e3, "tokens_per_s": B / med,
           "layers": n_layers, "free_gib": free}
    out["profile"] = profile_calls("[8b] one serve step at batch 16, cache 32767",
                                   lambda: serve(cache, tok, L - 1), warm=2, reps=5, traced=3)
    del cache
    free_card()

    # (c) teacher-forced decode against the forward, bf16
    S = 32
    tokens = torch.randint(3, V, (2, S), generator=gen, device=dev)
    moe_layers = n_layers - cfg.moe.first_dense_layers
    with torch.no_grad(), recorded_routes() as calls:
        model(tokens)
    T = tokens.numel()
    cap = capacity(cfg.moe, T)
    dropped = sum(int((~assign_slots(ids, cfg.moe.num_experts, cap)[1]).sum()) for ids in calls)
    print(f"[8c] forward of {T} tokens at capacity_factor {cfg.moe.capacity_factor} "
          f"(capacity {cap}): {dropped} of {T * cfg.moe.top_k * moe_layers} (token, expert) "
          f"pairs dropped over {moe_layers} MoE layers; a decode step routes 2 tokens "
          f"(capacity {capacity(cfg.moe, 2)}) and drops none")
    witness = moe_layer_witness(model, tokens)
    with recorded_routes(no_drops=True) as calls:
        dec, fwd = teacher_forced_logits(model, tokens)
    flips = routing_flips(calls[:moe_layers], calls[moe_layers:], moe_layers, 2, S)
    clean = ~flips.any(dim=-1)                       # (B, S): no flipped routing in any layer
    flip_share, clean_share = flips.float().mean().item(), clean.float().mean().item()
    rel_all = rel_gap(dec, fwd)
    rel_clean = rel_gap(dec[clean], fwd[clean]) if clean.any() else float("inf")
    agree = (dec.argmax(-1) == fwd.argmax(-1)).float().mean().item()
    print(f"[8c] teacher-forced decode of {S} tokens x 2 rows in bf16 against the forward, "
          f"capacity_factor {cfg.moe.num_experts}/{cfg.moe.top_k} (no drops): routings whose "
          f"expert set differs {flip_share:.4f} of {flips.numel()} (token, layer) (at most "
          f"{MAX_FLIP_SHARE}); tokens with none {clean_share:.3f} (at least {MIN_CLEAN_TOKENS}); "
          f"||dec - fwd|| / ||fwd|| over those tokens {rel_clean:.3e} (tol "
          f"{DECODE_REL_TOL[torch.bfloat16]}), over all {rel_all:.3e}; argmax agreement "
          f"{agree:.3f}")
    if (not torch.isfinite(dec).all() or flip_share > MAX_FLIP_SHARE
            or clean_share < MIN_CLEAN_TOKENS
            or not rel_clean <= DECODE_REL_TOL[torch.bfloat16]):
        raise AssertionError("[8c] deepseek-v2 decode disagrees with the forward pass")
    out.update(decode_rel=rel_clean, decode_rel_all=rel_all, flip_share=flip_share,
               clean_share=clean_share, dropped=dropped, witness=witness)

    # (e) one Eqn-1 Prompt Bank lookup on the cut
    tune_cfg = TuneConfig(prompt_len=16)
    tasks = make_tasks(vocab=32, partitions=2)         # 12 families x 2 = 24 tasks
    rng = np.random.default_rng(seed)
    seed_prompts = {t.task_id: rng.normal(0, 0.5 / np.sqrt(cfg.d_model),
                                          (tune_cfg.prompt_len, cfg.d_model)).astype(np.float32)
                    for t in tasks}
    kernels, by_shape = {"score_ce": score_ce}, {"score_ce": {}}
    score_ce.launches = 0
    t0 = time.perf_counter()
    with counted(kernels, by_shape, "bank build"):
        bank = build_bank(model, seed_prompts, variants_per_prompt=2, seed=seed)
    torch.cuda.synchronize()
    bank_s = time.perf_counter() - t0
    if len(bank.entries) != 48 or len(bank.medoid_ids) != 12:
        raise AssertionError("bank does not hold 48 candidates in 12 clusters")
    score_fn = make_score_fn(model, tasks[7], tune_cfg)
    positions = tune_cfg.prompt_len + score_fn.eval_batch["tokens"].shape[1]
    with counted(kernels, by_shape, eval_shape(score_fn, positions)):
        res = bank.lookup(score_fn)
    if not np.isfinite(res.score) or res.evaluations < len(bank.medoid_ids):
        raise AssertionError(f"lookup for {tasks[7].task_id} gave {res}")
    print(f"[8e] bank of {len(bank.entries)} candidates in {len(bank.medoid_ids)} clusters "
          f"(features + clustering {bank_s:.3f} s); request "
          f"{tasks[7].task_id} ({positions} positions): origin={res.entry.origin} "
          f"score={res.score:.6f} evaluations={res.evaluations} latency={res.latency_s:.3f} s; "
          f"score_ce launches {score_ce.launches} (V={V}, untied)")
    if score_ce.launches <= 0:
        raise AssertionError("score_ce was never launched on the deepseek-v2 lookup")
    out.update(lookup_s=res.latency_s, lookup_evals=res.evaluations,
               score_ce_launches=score_ce.launches, score_ce_by_shape=by_shape["score_ce"],
               score_rows=score_ce_rows("[8e]", cfg.name, model.output_embedding().detach(),
                                        (16 * 17, 16 * 497), gen))

    # (d) a 2-layer cut of the same weights in f32, card against CPU
    state = cut_state(model, 2)
    del model, serve, bank, score_fn             # every holder of the 9-layer model
    free_card()
    card, cpu = depth_cut(state, dev)
    del state
    tokens = torch.randint(3, V, (2, 4), generator=gen, device=dev)
    cc, gcache = cpu.init_cache(2, 8), card.init_cache(2, 8)
    worst = 0.0
    for t in range(tokens.shape[1]):
        lg, _ = card.decode_step(gcache, tokens[:, t:t + 1], t)
        lc, _ = cpu.decode_step(cc, tokens[:, t:t + 1].cpu(), t)
        worst = max(worst, check_close(f"[8d] decode step {t}, card f32 against CPU f32",
                                       lg.cpu(), lc, F32_LOGIT_TOL))
    print(f"[8d] 2-layer f32 cut (dense0 + 1 MoE layer): 4 decode steps, card (kernels) "
          f"against CPU (plain versions): max abs logit diff {worst:.3e} (tol {F32_LOGIT_TOL})")
    del card, cpu
    free_card()
    return out


# -- phase 11 -------------------------------------------------------------------

# decode_32k's batch of 128 cut to 8: each of zamba2-7b's 13 shared-attention
# applications keeps its own K/V cache, 2 x 32768 x 32 x 112 x 2 B = 470 MB a
# row, 48.9 GB at batch 8 beside 13.3 GB of weights (98 GB at batch 16).
HYBRID_SERVE_BATCH = 8
HYBRID_CUT_LAYERS = 7          # 6 + 1 Mamba2 layers: one shared-attention application


def attention_row(label: str, B: int, H: int, Hkv: int, S: int, hd: int, gen, dev, *,
                  L: int | None = None, causal: bool = True, trace: bool = True,
                  dtype=torch.bfloat16, **masks) -> dict:
    """flash_attention in ``dtype``, S queries against L keys (S = L unless
    given) with ``masks`` (window, q_offset, kv_len), held against its plain
    version (bf16 at fa_bf16_bound, f32 at TOL), then timed: the kernel, its
    plain version, one SDPA call (``is_causal`` where only causality masks,
    the live mask where more does) and the bound (4·hd operations a live
    pair; q and the output moved once, and the K and V rows some live pair
    reads); with ``trace`` also what it launches. Returns the row, its error
    under "err"."""
    from repro_torch.kernels.flash_attention import (_live_mask, flash_attention,
                                                     flash_attention_plain)

    L = S if L is None else L
    kw = dict(causal=causal, **masks)
    q = torch.randn(B, H, S, hd, generator=gen, device=dev).to(dtype)
    k, v = (torch.randn(B, Hkv, L, hd, generator=gen, device=dev).to(dtype) for _ in range(2))
    bf16 = dtype == torch.bfloat16
    shape = (f"B={B} H={H} Hkv={Hkv} {f'S=L={S}' if S == L else f'S={S} L={L}'} hd={hd} "
             f"{'causal' if causal else 'not causal'}{f' {masks}' if masks else ''} "
             f"{'bf16' if bf16 else 'f32'}")
    call = lambda: flash_attention(q, k, v, **kw)   # noqa: E731
    out = call()
    torch.cuda.synchronize()
    ref = flash_attention_plain(q, k, v, **kw)
    rtol, atol = fa_bf16_bound(ref) if bf16 else (TOL[dtype], TOL[dtype])
    err = check_close(f"{label} flash_attention {shape}", out, ref, rtol, atol)
    del out, ref
    live = _live_mask(S, L, causal=causal, window=masks.get("window", 0),
                      q_offset=masks.get("q_offset", 0), kv_len=masks.get("kv_len"), device=dev)
    pairs, cols = int(live.sum()), int(live.any(0).sum())
    only_causal = S == L and not any(masks.values())
    sdpa = dict(is_causal=causal) if only_causal or not (causal or masks) else dict(attn_mask=live)
    b_ms, b_by = bound(4.0 * B * H * pairs * hd,
                       (2 * B * H * S + 2 * B * Hkv * cols) * hd * q.element_size(),
                       PEAK_BF16_FLOPS if bf16 else PEAK_F32_FLOPS)
    row = {"shape": shape, "ms": time_ms(call), "err": err,
           "plain_ms": time_ms(lambda: flash_attention_plain(q, k, v, **kw), reps=5),
           "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
               q, k, v, enable_gqa=H != Hkv, **sdpa)),
           "bound_ms": b_ms, "bound_by": b_by}
    print(f"{label} flash_attention {shape}: max abs err {err:.3e} (rtol {rtol}, atol "
          f"{atol:.2e}); kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, library "
          f"(SDPA{', the live mask' if 'attn_mask' in sdpa else ''}) {row['library_ms']:.4f} ms, "
          f"bound {b_ms:.4f} ms ({b_by})")
    if trace:
        kernel_launches(f"{label} flash_attention S={S} hd={hd}", call)
    return row


def bank_and_lookups(label: str, model, requests, seed: int, score_fn_for=None) -> dict:
    """Phases 11a, 12 and 14b: a bank of 24 tasks x 2 variants = 48
    candidates in 12 clusters on ``model`` (bf16, on the card), then one
    two-layer lookup (``select_score``) for each task of ``requests``, its
    scorer ``score_fn_for(task, tune_cfg)`` (``make_score_fn`` by default),
    with flash_attention and score_ce counted by request shape; then one
    more evaluation of the first request, whose flash_attention launches
    are ``per_eval``. Fails if either kernel was never launched or a plain
    version ran."""
    from repro_torch.config import TuneConfig
    from repro_torch.core import build_bank, make_score_fn, select_score
    from repro_torch.data import make_tasks
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.score_ce import score_ce

    if score_fn_for is None:
        score_fn_for = lambda task, tc: make_score_fn(model, task, tc)   # noqa: E731
    tune_cfg = TuneConfig(prompt_len=16)
    rng = np.random.default_rng(seed)
    d = model.cfg.d_model
    seed_prompts = {t.task_id: rng.normal(0, 0.5 / np.sqrt(d), (tune_cfg.prompt_len, d))
                    .astype(np.float32) for t in make_tasks(vocab=32, partitions=2)}
    kernels = {"flash_attention": flash_attention, "score_ce": score_ce}
    by_shape = {name: {} for name in kernels}
    flash_attention.launches = score_ce.launches = 0
    calls: dict = {}
    t0 = time.perf_counter()
    with plain_calls(calls):
        with counted(kernels, by_shape, "bank build"):
            bank = build_bank(model, seed_prompts, variants_per_prompt=2, seed=seed)
        torch.cuda.synchronize()
        print(f"{label} bank: {len(bank.entries)} candidates (24 tasks x 2 variants), "
              f"{len(bank.medoid_ids)} clusters, features + clustering "
              f"{time.perf_counter() - t0:.3f} s")
        if len(bank.entries) != 48 or len(bank.medoid_ids) != 12:
            raise AssertionError(f"{label} the bank does not hold 48 candidates in 12 clusters")
        results = []
        for task in requests:
            score_fn = score_fn_for(task, tune_cfg)
            positions = tune_cfg.prompt_len + score_fn.eval_batch["tokens"].shape[1]
            with counted(kernels, by_shape, eval_shape(score_fn, positions)):
                res = select_score(bank, score_fn)
            if not np.isfinite(res.score) or res.evaluations < len(bank.medoid_ids):
                raise AssertionError(f"{label} lookup for {task.task_id} gave {res}")
            print(f"{label} request {task.task_id} ({positions} positions): "
                  f"origin={res.entry.origin} score={res.score:.6f} "
                  f"evaluations={res.evaluations} latency={res.latency_s:.3f} s")
            results.append((task, res, score_fn))
        task, res, score_fn = results[0]
        before = flash_attention.launches
        score_fn(res.entry)
        per_eval = flash_attention.launches - before
    launches = {"flash_attention": flash_attention.launches, "score_ce": score_ce.launches}
    print(f"{label} kernel launches on the lookup path: {launches}; by shape {by_shape}; "
          f"flash_attention launches per evaluation {per_eval}; plain-version calls {calls}")
    if any(n <= 0 for n in launches.values()) or any(calls.values()):
        raise AssertionError(f"{label} a kernel was never launched on the lookup path, or a "
                             f"plain version ran: {launches} {calls}")
    return {"bank": bank, "results": results, "by_shape": by_shape, "launches": launches,
            "per_eval": per_eval, "tune_cfg": tune_cfg, "seed_prompts": seed_prompts}


def hybrid_depth_witness(label: str, model, tokens: torch.Tensor) -> dict:
    """Decode against the forward through a hybrid's depth, block by block
    (each Mamba2 layer, then each shared-attention application).

    Per block: its one-token decode steps fed the forward's own input to
    that block, against its forward output, as ||dec - fwd|| / ||the
    block's increment||; nothing carries from block to block. Through
    depth: the teacher-forced decode chained block after block (each fed
    the previous block's decode), against the forward's hidden state after
    the same block, as ||dec - fwd|| / ||fwd||: how the two computations'
    difference of summation order and rounding grows with depth. At the
    end the logits of the chained decode (the whole teacher-forced decode)
    against the forward's."""
    from repro_torch.models.common import unembed
    from repro_torch.models.transformer import block_cache, block_decode

    cfg, (B, S) = model.cfg, tokens.shape

    def decoder(kind: str, block):
        if kind == "mamba":
            cache = block_cache(cfg, "mamba", B, S, model.device)
            return lambda xt, t: block_decode(cfg, "mamba", block, xt, cache, t)
        cache = block_cache(cfg, "dense", B, S, model.device)
        return lambda xt, t: block.decode(xt, cache, t)

    def steps(step, x):
        return torch.cat([step(x[:, t:t + 1], t) for t in range(S)], dim=1)

    names, layer_gaps, depth = [], [], []
    with torch.no_grad():
        x, positions = model.embed_inputs(tokens)
        xd = x
        for si, seg in enumerate(model.segments):
            blocks = [(f"{seg.name}.{i}", "mamba", b)
                      for i, b in enumerate(getattr(model, seg.name))]
            if model._shared_after(si):
                blocks.append((f"shared_attn/app{si}", "shared", model.shared_attn))
            for name, kind, block in blocks:
                y = block(x, positions)
                layer_gaps.append(((steps(decoder(kind, block), x) - y).norm()
                                   / (y - x).norm()).item())
                xd = steps(decoder(kind, block), xd)
                depth.append(rel_gap(xd, y))
                names.append(name)
                x = y
        head = lambda h: unembed(cfg, model.embedding, model.unembed, model.final_norm(h))
        logits_gap = rel_gap(head(xd), head(x))
    worst = int(np.argmax(layer_gaps))
    marks = [i for i in (1, 2, 6, 7, 12, 24, 48, 72, len(names)) if i <= len(names)]
    print(f"{label} {len(names)} blocks ({cfg.num_layers} Mamba2 layers, "
          f"{len(names) - cfg.num_layers} shared-attention applications), {model.dtype}, {S} "
          f"tokens x {B} rows. Per block, decode fed the forward's input against the forward, "
          f"||dec - fwd|| / ||increment||: max {layer_gaps[worst]:.3e} at {names[worst]}; "
          f"after blocks {marks}: {[f'{layer_gaps[i - 1]:.2e}' for i in marks]}")
    print(f"{label} chained decode against the forward, hidden state ||dec - fwd|| / ||fwd|| "
          f"after blocks {marks}: {[f'{depth[i - 1]:.2e}' for i in marks]}; logits "
          f"{logits_gap:.3e}")
    return {"layer_gap_max": layer_gaps[worst], "layer_gaps": layer_gaps, "depth": depth,
            "names": names, "logits_gap": logits_gap}


def prompt_loss_grad(model, prompt0: np.ndarray, batch: dict, chunked: bool = False):
    """(mean loss, the prompt's gradient in f32) of one batch on ``model``
    from the soft prompt ``prompt0``: through lpt_loss, as PromptTuner.step
    takes it, or lpt_loss_chunked, as make_train_step does. The batch's
    tensors are moved to the model's device."""
    from repro_torch.models import prompt_from_arrays
    from repro_torch.train import lpt_loss, lpt_loss_chunked

    p = prompt_from_arrays({"soft_prompt": prompt0}, model.device)["soft_prompt"]
    batch = {k: torch.as_tensor(v, device=model.device) for k, v in batch.items()}
    tot, (loss, _) = (lpt_loss_chunked if chunked else lpt_loss)(model, p, batch)
    (g,) = torch.autograd.grad(tot, p)
    return float(loss.detach()), g.detach().float()


def grad_card_vs_cpu(label: str, card, cpu, prompt0: np.ndarray, batch: dict, loss_tol: float,
                     chunked: bool = False) -> dict:
    """An f32 depth cut's loss and prompt gradient, card (kernels) against
    CPU (plain versions), on the same batch and prompt: the loss at
    ``loss_tol`` relative, the gradient at TUNE_F32_PROMPT_TOL in relative
    norm."""
    lc, gc = prompt_loss_grad(cpu, prompt0, batch, chunked)
    lg, gg = prompt_loss_grad(card, prompt0, batch, chunked)
    rel_l, rel_g = abs(lg - lc) / abs(lc), rel_gap(gg.cpu(), gc)
    print(f"{label}, card f32 against CPU f32: loss card {lg:.7f} cpu {lc:.7f} (rel {rel_l:.2e}, "
          f"tol {loss_tol}); prompt gradient ||card - cpu|| / ||cpu|| = {rel_g:.2e} (tol "
          f"{TUNE_F32_PROMPT_TOL}, ||cpu|| {gc.norm().item():.3e})")
    if not (rel_l <= loss_tol and rel_g <= TUNE_F32_PROMPT_TOL):
        raise AssertionError(f"{label}: the card's f32 loss or prompt gradient left the CPU's")
    return {"loss": rel_l, "grad": rel_g}


TUNING_STEPS = 3   # PromptTuner.steps at the service's tuning shape (11e, 14d)


def tuner_steps(label: str, model, prompt0: np.ndarray, batches: list, per_step: int) -> dict:
    """PromptTuner.steps at TuneConfig's defaults on ``batches`` from the
    soft prompt ``prompt0``, as a main path (main_path): flash_attention_bwd
    launched ``per_step`` times a step, every loss and the prompt finite;
    the first step's backward calls recorded and held against the plain
    backward (hold_recorded_bwd); then one step profiled. Returns the
    launches, the losses, the (q, k) shapes of the first step's backward
    calls, the profile and the largest held error."""
    from repro_torch.config import TuneConfig
    from repro_torch.models import prompt_from_arrays
    from repro_torch.tuning import PromptTuner

    tuner = PromptTuner(model, TuneConfig())
    B, S = batches[0]["tokens"].shape
    positions = tuner.tune_cfg.prompt_len + S
    seen, kept_bwd = [], {}

    def run():
        pp = prompt_from_arrays({"soft_prompt": prompt0}, model.device)
        st, losses = tuner.init_opt(pp), []
        for i, b in enumerate(batches):
            with (recorded_attention(seen, None, kept_bwd) if i == 0 else contextlib.nullcontext()):
                pp, st, loss = tuner.step(pp, st, b)
            losses.append(float(loss))
        return pp, losses

    n = len(batches)
    (pp, losses), launches = main_path(f"{label} {n} PromptTuner.steps, batch {B} x {positions} "
                                       "positions", run)
    shapes = sorted({(c["q"][0], c["k"][0]) for c in seen if c.get("bwd")})
    print(f"{label} losses {[round(x, 6) for x in losses]}; flash_attention_bwd launches "
          f"{launches['flash_attention_bwd']} ({per_step} a step expected), the first step's "
          f"backward calls at (q, k) shapes {shapes}")
    if (launches["flash_attention_bwd"] != per_step * n or not np.isfinite(losses).all()
            or not torch.isfinite(pp["soft_prompt"]).all()):
        raise AssertionError(f"{label} the tuning steps launched flash_attention_bwd "
                             f"{launches['flash_attention_bwd']} times, not {per_step} a step, "
                             f"or gave a non-finite loss or prompt: {losses}")
    held = hold_recorded_bwd(label, kept_bwd)
    del kept_bwd
    holder = {"pp": pp, "st": tuner.init_opt(pp)}

    def one_step():
        holder["pp"], holder["st"], _ = tuner.step(holder["pp"], holder["st"], batches[0])

    profile = step_profile(f"{label} one {model.cfg.name} PromptTuner.step, batch {B} x "
                           f"{positions} positions", one_step, B * positions, warm=1, reps=3,
                           traced=1)
    del holder
    free_card()
    return {"launches": launches, "losses": losses, "bwd_shapes": shapes, "profile": profile,
            "held": held}


def hybrid_tune(model, prompt0: np.ndarray, seed: int, apps: int) -> dict:
    """11e: TUNING_STEPS PromptTuner.steps of zamba2-7b (tuner_steps; batch
    8, 16 prompt positions, a 17-token task) from a bank prompt:
    flash_attention_bwd launched once a shared-attention application (hd
    112), the Mamba2 blocks' backward through autograd. Then the first
    batch's prompt gradient in bf16 against the same weights in f32 on the
    card, beside the same bf16 gradient through the plain attention
    (plain_attention: f32 P and dS): Mamba2's rounding compounds over
    depth, so the kernels' gap is held within HYBRID_PLAIN_FACTOR of the
    plain route's."""
    from repro_torch.config import TuneConfig
    from repro_torch.data import LoaderConfig, TaskLoader
    from repro_torch.models import Model

    t0 = time.perf_counter()
    loader = TaskLoader(synthetic_task(), LoaderConfig(batch_size=TuneConfig().batch_size,
                                                       seed=seed))
    batches = [next(loader) for _ in range(TUNING_STEPS)]
    prompt0 = np.asarray(prompt0, np.float32)
    steps = tuner_steps("[11e]", model, prompt0, batches, apps)

    grads, calls = {}, {}
    for route in ("kernels", "plain"):
        with plain_calls(calls), (plain_attention() if route == "plain"
                                  else contextlib.nullcontext()):
            _, grads[route] = prompt_loss_grad(model, prompt0, batches[0])
        if (calls["flash_attention_bwd_plain"] > 0) != (route == "plain"):
            raise AssertionError(f"[11e] the {route} route ran the wrong backward: {calls}")
        calls.clear()
    f32 = Model(model.cfg.with_overrides(dtype="float32", param_dtype="float32"),
                device=model.device, seed=None)
    f32.load_state_dict(model.state_dict())               # the same weights, widened
    _, grads["f32"] = prompt_loss_grad(f32, prompt0, batches[0])
    del f32
    free_card()
    gap = {route: rel_gap(grads[route], grads["f32"]) for route in ("kernels", "plain")}
    print(f"[11e] the first batch's prompt gradient at {model.cfg.num_layers} layers, bf16 against "
          f"f32 (f32 kernels, the same weights): ||bf16 - f32|| / ||f32|| kernels "
          f"{gap['kernels']:.3e}, plain attention (f32 P and dS) {gap['plain']:.3e}: ratio "
          f"{gap['kernels'] / max(gap['plain'], 1e-30):.3f} (tol {HYBRID_PLAIN_FACTOR})")
    if not (np.isfinite(list(gap.values())).all()
            and gap["kernels"] <= HYBRID_PLAIN_FACTOR * gap["plain"]):
        raise AssertionError(f"[11e] zamba2-7b's bf16 prompt gradient parts from f32 by "
                             f"{gap['kernels']:.3e} with the kernels, more than "
                             f"{HYBRID_PLAIN_FACTOR} x the plain route's {gap['plain']:.3e}")
    return {**steps, "steps": len(batches), "gap": gap, "prompt0": prompt0,
            "batch": batches[0], "seconds": time.perf_counter() - t0}


def phase_hybrid(dev: torch.device, seed: int) -> dict:
    """zamba2-7b (Mamba2 + one shared attention block) at full width and
    depth, bf16, weights from --seed."""
    from repro_torch.config import INPUT_SHAPES
    from repro_torch.configs import get_config
    from repro_torch.core import make_score_fn
    from repro_torch.data import make_tasks
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_decode import auto_splits, flash_decode, flash_decode_plain
    from repro_torch.launch import make_serve_step
    from repro_torch.models import Model
    from repro_torch.models.ssm import mamba2_dims

    t_phase = time.perf_counter()
    cfg = get_config("zamba2-7b")                       # full width and depth, bf16
    t0 = time.perf_counter()
    model = Model(cfg, device=dev, seed=seed)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    weight_gb = sum(p.numel() * p.element_size() for p in model.parameters()) / 1e9
    H, Hkv, hd, V = cfg.num_heads, cfg.kv_heads(), cfg.resolved_head_dim(), cfg.vocab_size
    d_inner, mh, mhd = mamba2_dims(cfg)
    apps = len(model.segments) - 1
    print(f"[11] {cfg.name}: {cfg.num_layers} Mamba2 layers in {len(model.segments)} segments "
          f"(d={cfg.d_model}, d_inner {d_inner}, {mh} heads of {mhd}, state "
          f"{cfg.ssm.state_size}, chunk {cfg.ssm.chunk_size}, conv {cfg.ssm.conv_width}), "
          f"shared attention ({H} heads of {hd}, Hkv={Hkv}, SwiGLU d_ff {cfg.d_ff}) applied "
          f"{apps} times, V={V} tied, {cfg.dtype}; {n_params / 1e9:.3f} B parameters, "
          f"{weight_gb:.2f} GB of weights, {torch.cuda.memory_allocated(dev) / 1e9:.2f} GB "
          f"allocated on the card; drawn from seed {seed} in {time.perf_counter() - t0:.1f} s")

    # (a) the Prompt Bank lookup
    tasks = make_tasks(vocab=32, partitions=2)          # 12 families x 2 = 24 tasks
    requests = [tasks[3], tasks[14],
                make_tasks(input_len=248, target_len=248)[9]]   # 33, 33, 513 positions
    look = bank_and_lookups("[11a]", model, requests, seed)
    bank, results, by_shape, launches, per_eval, tune_cfg, seed_prompts = (
        look[k] for k in ("bank", "results", "by_shape", "launches", "per_eval", "tune_cfg",
                          "seed_prompts"))
    task, res, score_fn = results[0]
    if per_eval != apps:
        raise AssertionError(f"[11a] flash_attention launched {per_eval} times an evaluation, "
                             f"not {apps}")
    profiles = [profile_calls(f"[11a] one {cfg.name} evaluation at "
                              f"{16 + sf.eval_batch['tokens'].shape[1]} positions",
                              lambda: sf(r.entry), warm=2, reps=5, traced=2)
                for _, r, sf in results[:1]]
    gen = torch.Generator(device=dev).manual_seed(seed + 5)
    fa_rows = [attention_row("[11a]", 16, H, Hkv, S, hd, gen, dev) for S in (33, 513)]
    fa_rows[0].update(launches_per_eval=per_eval)
    score_rows = score_ce_rows("[11a]", cfg.name, model.output_embedding().detach(),
                               (16 * 17, 16 * 497), gen)

    # (e) prompt tuning: PromptTuner.step at the service's tuning shape from
    # the first request's bank prompt, held in bf16 against f32
    tune = hybrid_tune(model, res.entry.prompt, seed, apps)
    free_card()

    # (b) decode against the forward pass: block by block in bf16 and f32, end
    # to end in f32, and end to end in bf16 against the plain attention's gap
    # (see the note above F32_LOGIT_TOL)
    tokens = torch.randint(3, V, (2, 32), generator=gen, device=dev)
    decode_rel, witness, calls = {}, {}, {}
    for route in ("kernels", "plain"):
        before = flash_attention.launches, flash_decode.launches
        with plain_calls(calls), (plain_attention() if route == "plain"
                                  else contextlib.nullcontext()):
            dec, full = teacher_forced_logits(model, tokens)
            decode_rel[route] = rel_gap(dec, full)
            witness[route] = hybrid_depth_witness(f"[11b] {route}:", model, tokens)
        ran = (flash_attention.launches - before[0], flash_decode.launches - before[1],
               calls["flash_attention_plain"], calls["flash_decode_plain"])
        print(f"[11b] {route}: teacher-forced decode of {tokens.shape[1]} tokens x "
              f"{tokens.shape[0]} rows in bf16 against the forward, end to end: ||dec - fwd|| / "
              f"||fwd|| = {decode_rel[route]:.3e}, argmax agreement "
              f"{(dec.argmax(-1) == full.argmax(-1)).float().mean().item():.3f}; launches "
              f"(flash_attention, flash_decode) {ran[:2]}, plain calls {ran[2:]}")
        kernels, plain = ran[:2], ran[2:]
        if route == "plain":
            kernels, plain = plain, kernels
        if min(kernels) <= 0 or max(plain) > 0:
            raise AssertionError(f"[11b] the {route} route ran the wrong attention: {ran}")
        calls.clear()
        del dec, full
    shared = {route: max(g for n, g in zip(w["names"], w["layer_gaps"])
                         if n.startswith("shared_attn")) for route, w in witness.items()}
    print(f"[11b] bf16 end to end, kernels {decode_rel['kernels']:.3e} against plain "
          f"{decode_rel['plain']:.3e}: ratio {decode_rel['kernels'] / decode_rel['plain']:.3f} "
          f"(tol {HYBRID_PLAIN_FACTOR}); shared-attention blocks, largest per-block gap: "
          f"kernels {shared['kernels']:.3e}, plain {shared['plain']:.3e}")
    if not (torch.isfinite(torch.tensor(list(decode_rel.values()))).all()
            and decode_rel["kernels"] <= HYBRID_PLAIN_FACTOR * decode_rel["plain"]):
        raise AssertionError(f"[11b] zamba2-7b's bf16 decode parts from the forward by "
                             f"{decode_rel['kernels']:.3e} with the kernels, more than "
                             f"{HYBRID_PLAIN_FACTOR} x the plain versions' {decode_rel['plain']:.3e}")
    witness["bf16"] = witness.pop("kernels")
    f32 = Model(cfg.with_overrides(dtype="float32", param_dtype="float32"), device=dev,
                seed=None)
    f32.load_state_dict(model.state_dict())               # the same weights, widened
    witness["f32"] = hybrid_depth_witness("[11b]", f32, tokens)
    witness["f32_decode_rel"] = teacher_forced("[11b] f32", f32, tokens)
    del f32
    free_card()
    if not (witness["bf16"]["layer_gap_max"] <= LAYER_DECODE_BF16_TOL
            and witness["f32"]["layer_gap_max"] <= LAYER_DECODE_TOL):
        raise AssertionError(f"[11b] zamba2-7b decode disagrees with the forward within a block "
                             f"(bf16 {witness['bf16']['layer_gap_max']:.3e}, tol "
                             f"{LAYER_DECODE_BF16_TOL}; f32 {witness['f32']['layer_gap_max']:.3e}, "
                             f"tol {LAYER_DECODE_TOL})")

    # (c) serve steps against a full decode_32k cache, batch cut to 8
    shape = INPUT_SHAPES["decode_32k"]
    B, L = HYBRID_SERVE_BATCH, shape.seq_len
    per_row = apps * 2 * L * Hkv * hd * 2
    cache = model.init_cache(B, L)
    state_gb = sum(t.numel() * t.element_size() for seg in model.segments
                   for t in cache[seg.name]["state"].values()) / 1e9
    print(f"[11c] {shape.name}: cache of {L} tokens, batch {shape.global_batch} -> {B} "
          f"(cut: {apps} shared-attention K/V caches of {per_row / 1e9:.3f} GB a row, "
          f"{per_row * B / 1e9:.1f} GB at batch {B}, {per_row * 16 / 1e9:.1f} GB at 16, "
          f"{per_row * shape.global_batch / 1e9:.0f} GB at {shape.global_batch}); Mamba2 states "
          f"{state_gb:.2f} GB; {torch.cuda.memory_allocated(dev) / 1e9:.1f} GB allocated")
    filled = L - 8                                      # a fixture: seeded K/V at 0..32759
    for app in cache["shared_attn"].values():
        kv = app["kv"]
        kv["k"][:, :filled].normal_(generator=gen)
        kv["v"][:, :filled].normal_(generator=gen)
        kv["pos"][:, :filled] = torch.arange(filled, device=dev, dtype=torch.int32)
    for seg in model.segments:                          # and seeded Mamba2 states
        for t in cache[seg.name]["state"].values():
            t.normal_(generator=gen)
    serve = make_serve_step(model)
    tok = torch.randint(3, V, (B, 1), generator=gen, device=dev, dtype=torch.int32)
    torch.cuda.synchronize()
    n_steps, step_s, calls = L - filled, [], {}
    flash_decode.launches = 0
    with plain_calls(calls):
        for i in range(n_steps):
            t = time.perf_counter()
            tok, cache = serve(cache, tok, filled + i)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t)
    dlaunches = flash_decode.launches
    if dlaunches != apps * n_steps or any(calls.values()):
        raise AssertionError(f"[11c] flash_decode launched {dlaunches} times in {n_steps} serve "
                             f"steps, not {apps} a step, or a plain version ran: {calls}")
    if not ((tok >= 0) & (tok < V)).all():
        raise AssertionError("[11c] serve step produced tokens outside the vocabulary")
    med = statistics.median(step_s[1:])
    print(f"[11c] {n_steps} serve steps at cache_len {filled}..{L - 1}: "
          f"{[round(x * 1e3, 2) for x in step_s]} ms; median (steps 2..) {med * 1e3:.2f} ms "
          f"per step, {B / med:.0f} tokens/s; flash_decode launches {dlaunches} "
          f"({dlaunches // n_steps} per step); plain-version calls {calls}")
    live = L - 1
    kv = cache["shared_attn"]["app0"]["kv"]
    k, v = kv["k"].transpose(1, 2), kv["v"].transpose(1, 2)
    q = torch.randn(B, H, hd, generator=gen, device=dev).to(k.dtype)
    b_ms, b_by = decode_bound(B, H, Hkv, hd, live, k.element_size())
    splits = auto_splits(B, Hkv, H // Hkv, live,
                         torch.cuda.get_device_properties(dev).multi_processor_count)
    decode_row = {
        "shape": f"B={B} H={H} Hkv={Hkv} hd={hd} L={L} kv_len={live} {cfg.dtype}, "
                 f"{splits} splits",
        "ms": time_ms(lambda: flash_decode(q, k, v, kv_len=live)),
        "plain_ms": time_ms(lambda: flash_decode_plain(q, k, v, kv_len=live), reps=5),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            q[:, :, None], k, v, enable_gqa=H != Hkv)),
        "bound_ms": b_ms, "bound_by": b_by, "launches": dlaunches,
        "launches_per_step": dlaunches // n_steps}
    print(f"[11c] flash_decode {decode_row['shape']}: kernel {decode_row['ms']:.4f} ms, plain "
          f"{decode_row['plain_ms']:.4f} ms, library (SDPA over all {L} rows) "
          f"{decode_row['library_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    kernel_launches(f"[11c] flash_decode {decode_row['shape']}",
                    lambda: flash_decode(q, k, v, kv_len=live))
    serve_profile = profile_calls(f"[11c] one serve step at batch {B}, cache {live}",
                                  lambda: serve(cache, tok, live), warm=1, reps=3, traced=1)
    decode_row.update(step_ms=med * 1e3, tokens_per_s=B / med, decode_rel=decode_rel,
                      witness=witness)
    del cache, kv, k, v, q
    free_card()

    # (d) a 7-layer cut of the same weights in f32, card against CPU
    state = cut_state(model, HYBRID_CUT_LAYERS)
    entries = [res.entry] + [bank.entries[i] for i in bank.medoid_ids
                             if bank.entries[i] is not res.entry][:3]
    del model, serve, bank, results, score_fn
    free_card()
    card, cpu = depth_cut(state, dev)
    del state
    print(f"[11d] {HYBRID_CUT_LAYERS}-layer f32 cut: segments "
          f"{[(s.name, s.count) for s in card.segments]}, shared attention applied "
          f"{len(card.segments) - 1} time(s)")
    failed, worst_score = [], 0.0
    for entry in entries:
        c = make_score_fn(cpu, task, tune_cfg)(entry)
        g = make_score_fn(card, task, tune_cfg)(entry)
        rel = abs(g - c) / abs(c)
        worst_score = max(worst_score, rel)
        print(f"[11d] {task.task_id} {entry.origin}: cpu f32 {c:.6f}, card f32 {g:.6f} "
              f"(rel {rel:.2e}, tol {F32_SCORE_RTOL})")
        if not rel <= F32_SCORE_RTOL:
            failed.append(entry.origin)
    tokens = torch.randint(3, V, (2, 4), generator=gen, device=dev)
    cc, gcache = cpu.init_cache(2, 8), card.init_cache(2, 8)
    worst = 0.0
    for t in range(tokens.shape[1]):
        lg, _ = card.decode_step(gcache, tokens[:, t:t + 1], t)
        lc, _ = cpu.decode_step(cc, tokens[:, t:t + 1].cpu(), t)
        worst = max(worst, check_close(f"[11d] decode step {t}, card f32 against CPU f32",
                                       lg.cpu(), lc, F32_LOGIT_TOL))
    print(f"[11d] {HYBRID_CUT_LAYERS}-layer f32 cut: 4 decode steps, card (kernels) against CPU "
          f"(plain versions): max abs logit diff {worst:.3e} (tol {F32_LOGIT_TOL})")
    cut_grad = grad_card_vs_cpu(f"[11d] {HYBRID_CUT_LAYERS}-layer f32 cut, PromptTuner's loss",
                                card, cpu, tune["prompt0"], tune["batch"], TUNE_F32_LOSS_RTOL)
    del card, cpu
    free_card()
    if failed:
        raise AssertionError(f"[11d] zamba2-7b card scores disagree with the CPU f32 path for "
                             f"{failed}")
    print(f"[11] {cfg.name}: {time.perf_counter() - t_phase:.1f} s, of which tuning (11e) "
          f"{tune['seconds']:.1f} s")
    return {"by_shape": by_shape, "launches": launches, "profiles": profiles,
            "fa_rows": fa_rows, "score_rows": score_rows, "decode_row": decode_row,
            "serve_profile": serve_profile, "cut_score_rel": worst_score, "cut_logit": worst,
            "tune_launches": tune["launches"], "tune_steps": tune["steps"],
            "tune_profile": tune["profile"], "grad_gap": tune["gap"], "cut_grad": cut_grad,
            "bwd_held": tune["held"]}


# -- phase 12 -------------------------------------------------------------------

# The dense family's last three configs (phase 12): arch and layers run. At 64
# layers command-r-plus-104b is 1.573 B parameters a layer (3.15 GB in bf16)
# and a 6.29 GB tied embedding, 208 GB in all; cut to 16 layers, 56.6 GB.
# Drawing the embedding takes a 12.6 GB f32 temporary beside the bf16
# weights, so 20 layers (69.2 GB) would not leave room for it.
DENSE_FAMILY = [("internlm2-20b", None), ("phi3-medium-14b", None),
                ("command-r-plus-104b", 16)]
DENSE_CUT_LAYERS = 2


def dense_lookup(arch: str, layers, dev: torch.device, seed: int) -> dict:
    """One dense config at full width (``layers`` deep, or its own depth),
    bf16, weights from ``seed``: a bank of 48 candidates in 12 clusters,
    lookups at 33 and 513 positions with flash_attention launched once a
    layer per evaluation and no plain version run, one evaluation profiled,
    score_ce timed at its (D, V), peak memory; then a 2-layer f32 cut of the
    same weights, card against CPU, on Eqn-1 scores."""
    from repro_torch.configs import get_config
    from repro_torch.core import make_score_fn
    from repro_torch.data import make_tasks
    from repro_torch.models import Model

    full = get_config(arch)
    cfg = full if layers is None else full.with_overrides(num_layers=layers)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model = Model(cfg, device=dev, seed=seed)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    weight_gb = sum(p.numel() * p.element_size() for p in model.parameters()) / 1e9
    H, Hkv, hd, V = cfg.num_heads, cfg.kv_heads(), cfg.resolved_head_dim(), cfg.vocab_size
    free_gb = torch.cuda.mem_get_info(dev)[0] / 1e9
    depth = (f"{cfg.num_layers} layers" if layers is None
             else f"{cfg.num_layers} of its {full.num_layers} layers")
    print(f"[12] {cfg.name}: {depth}, d={cfg.d_model}, H={H}, Hkv={Hkv} (group {H // Hkv}), "
          f"hd={hd}, d_ff {cfg.d_ff}, V={V}, {cfg.norm}, parallel_block={cfg.parallel_block}, "
          f"tied={cfg.tie_embeddings}, {cfg.dtype}; {n_params / 1e9:.3f} B parameters, "
          f"{weight_gb:.2f} GB of weights, {torch.cuda.memory_allocated(dev) / 1e9:.2f} GB "
          f"allocated, {free_gb:.1f} GB of the card free; drawn from seed {seed} in "
          f"{time.perf_counter() - t0:.1f} s")

    tasks = make_tasks(vocab=32, partitions=2)          # 12 families x 2 = 24 tasks
    requests = [tasks[3], make_tasks(input_len=248, target_len=248)[9]]   # 33, 513 positions
    kept: dict = {}
    with recorded_attention([], kept):
        look = bank_and_lookups(f"[12] {cfg.name}", model, requests, seed)
    bank, results, by_shape, launches, per_eval, tune_cfg = (
        look[k] for k in ("bank", "results", "by_shape", "launches", "per_eval", "tune_cfg"))
    task, res, score_fn = results[0]
    if per_eval != cfg.num_layers:
        raise AssertionError(f"[12] {cfg.name}: flash_attention launched {per_eval} times an "
                             f"evaluation, not {cfg.num_layers}")
    profile = profile_calls(f"[12] one {cfg.name} evaluation at "
                            f"{16 + score_fn.eval_batch['tokens'].shape[1]} positions",
                            lambda: score_fn(res.entry), warm=2, reps=5, traced=2)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 2**30
    print(f"[12] {cfg.name}: peak memory {peak_gb:.2f} GiB over the draw, the bank build and "
          f"the lookups")
    gen = torch.Generator(device=dev).manual_seed(seed + 12)
    score_rows = score_ce_rows("[12]", cfg.name, model.output_embedding().detach(),
                               (16 * 17, 16 * 497), gen)

    # a 2-layer cut of the same weights in f32, card against CPU
    state = cut_state(model, DENSE_CUT_LAYERS)
    entries = [res.entry, next(bank.entries[i] for i in bank.medoid_ids
                               if bank.entries[i] is not res.entry)]
    del model, bank, results, score_fn
    free_card()
    held_err = hold_recorded(f"[12] {cfg.name}", kept)
    del kept
    free_card()
    card, cpu = depth_cut(state, dev)
    del state
    failed, worst = [], 0.0
    for entry in entries:
        c = make_score_fn(cpu, task, tune_cfg)(entry)
        g = make_score_fn(card, task, tune_cfg)(entry)
        rel = abs(g - c) / abs(c)
        worst = max(worst, rel)
        print(f"[12] {cfg.name} {DENSE_CUT_LAYERS}-layer f32 cut, {task.task_id} {entry.origin}: "
              f"cpu f32 {c:.6f}, card f32 {g:.6f} (rel {rel:.2e}, tol {F32_SCORE_RTOL})")
        if not rel <= F32_SCORE_RTOL:
            failed.append(entry.origin)
    del card, cpu
    free_card()
    if failed:
        raise AssertionError(f"[12] {cfg.name}: card f32 scores disagree with the CPU for "
                             f"{failed}")
    return {"by_shape": by_shape, "launches": launches, "per_eval": per_eval,
            "profile": profile, "peak_gib": peak_gb, "score_rows": score_rows,
            "cut_score_rel": worst, "layers": cfg.num_layers, "held_err": held_err}


def phase_dense(dev: torch.device, seed: int) -> dict:
    out = {}
    for arch, layers in DENSE_FAMILY:
        t0 = time.perf_counter()
        out[arch] = dense_lookup(arch, layers, dev, seed)
        free_card()
        print(f"[12] {arch}: {time.perf_counter() - t0:.1f} s")
    return out


# -- phase 13 -------------------------------------------------------------------

# prefill_32k's batch of 32 cut to 4 (qwen2-7b, 32784 positions a row with the
# soft prompt): the step's activations, not the weights, set the size.
PREFILL_BATCH = 4
# long_500k's serve steps against the ring of its 8192-token window.
LONG_STEPS = 8
# The masked path against flash_attention (window 8192, q_offset) on the same
# K/V, each layer by ||masked - flash|| / ||flash||. A bf16 rounding (unit
# roundoff u = 2^-8) errs by about 0.42 u = 1.66e-3 of the value, rms over
# the mantissas. The masked path rounds three times, as the reference's XLA
# path does: q·k (its einsum's bf16 output), which moves each logit s by
# about 1.66e-3 |s| and so each probability by as much relative, P, and its
# output; flash_attention rounds only its output. Over random V these add in
# quadrature, each as a share of the output's norm, so the gap is about
# 1.66e-3 · sqrt(3 + E[s²]) with E[s²] weighted toward the largest scores by
# P: 4.98e-3 measured at most over qwen2-7b's layers puts that E[s²] near 6.
# The limit allows E[s²] up to 33; phase 13b prints each term apart
# (masked_f32) against the attention in f32.
LONG_MASKED_REL_TOL = 1e-2
# 64 rows laid out before the ring's oldest position, which the window must
# leave out of flash_attention's sum
STALE_ROWS = 64


@contextlib.contextmanager
def f32_attention():
    """Routes the model's flash_attention calls through the f32 kernel: q, k
    and v widened (exactly), the output rounded back to their dtype."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention

    saved = ops.flash_attention
    ops.flash_attention = lambda q, k, v, **kw: flash_attention(
        q.float(), k.float(), v.float(), **kw).to(q.dtype)
    try:
        yield
    finally:
        ops.flash_attention = saved


def strided_copy(x: torch.Tensor) -> torch.Tensor:
    """A copy of ``x`` with its shape and strides (clone may make a view of
    a wider tensor contiguous); a broadcast (a stride 0) comes back dense."""
    if 0 in x.stride():
        return x.detach().contiguous()
    return x.new_empty_strided(x.shape, x.stride()).copy_(x.detach())


@contextlib.contextmanager
def recorded_attention(seen: list, kept: dict | None = None, kept_bwd: dict | None = None):
    """Keeps the shape and strides of each flash_attention call's q, k and
    v in ``seen``; and in ``kept``, for each distinct shape, strides and
    keywords, copies of the first such call's q, k, v, keywords and output,
    at their strides (hold_recorded holds them against the plain version).
    The backward's own calls (FlashAttention.backward, which runs
    flash_attention_bwd) go into ``seen`` too, marked "bwd", and into
    ``kept_bwd``: q, k, v, the output, its gradient, the log-sum-exp,
    keywords and (dq, dk, dv)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import FlashAttention

    saved, saved_bwd = ops.flash_attention, FlashAttention.backward

    def key_of(q, k, v, kw, *more):
        return (tuple(q.shape), q.stride(), tuple(k.shape), k.stride(), v.stride(),
                *(t.stride() for t in more), tuple(sorted(kw.items())))

    def rec(q, k, v, **kw):
        out = saved(q, k, v, **kw)
        seen.append({"q": (tuple(q.shape), q.stride()), "k": (tuple(k.shape), k.stride())})
        key = key_of(q, k, v, kw)
        if kept is not None and key not in kept:
            kept[key] = (*(strided_copy(t) for t in (q, k, v)), dict(kw), strided_copy(out))
        return out

    def rec_bwd(ctx, dout):
        grads = saved_bwd(ctx, dout)
        q, k, v, out, lse = ctx.saved_tensors
        seen.append({"bwd": True, "q": (tuple(q.shape), q.stride()),
                     "k": (tuple(k.shape), k.stride())})
        key = key_of(q, k, v, ctx.kw, dout)
        if kept_bwd is not None and key not in kept_bwd:
            kept_bwd[key] = (*(strided_copy(t) for t in (q, k, v, out, dout, lse)),
                             dict(ctx.kw), tuple(strided_copy(g) for g in grads[:3]))
        return grads
    ops.flash_attention, FlashAttention.backward = rec, staticmethod(rec_bwd)
    try:
        yield
    finally:
        ops.flash_attention, FlashAttention.backward = saved, staticmethod(saved_bwd)


def hold_recorded(label: str, kept: dict) -> float:
    """Holds each call that recorded_attention kept, the kernel's own output
    on the main path, against flash_attention_plain on the same inputs at
    their strides: bf16 at fa_bf16_bound, f32 at TOL. A causal S = L call
    longer than 4 SLICE_ROWS is held batch row by batch row in slices
    (sliced_attention_check); any other in chunks of batch rows whose plain
    f32 scores take at most PLAIN_SCORE_BYTES. Returns the largest error."""
    from repro_torch.kernels.flash_attention import flash_attention_plain

    worst = 0.0
    for (q_shape, q_strides, k_shape, k_strides, _, _), (q, k, v, kw, out) in kept.items():
        name = f"{label} flash_attention's call at q {q_shape} strides {q_strides}, k {k_shape} " \
               f"strides {k_strides}, {kw}, {q.dtype}"
        S, L = q.shape[2], k.shape[2]
        causal_only = (kw.get("causal", True) and not kw.get("window")
                       and not kw.get("q_offset") and kw.get("kv_len") in (None, L))
        if S == L and S > 4 * SLICE_ROWS and causal_only:
            for b in range(q.shape[0]):
                res = sliced_attention_check(f"{name}, batch row {b}", q[b:b + 1], k[b:b + 1],
                                             v[b:b + 1], out=out[b:b + 1])
                worst = max(worst, res["err"])
            continue
        rows, err = max(1, PLAIN_SCORE_BYTES // (4 * q.shape[1] * S * L)), 0.0
        for b0 in range(0, q.shape[0], rows):
            sl = slice(b0, b0 + rows)
            ref = flash_attention_plain(q[sl], k[sl], v[sl], **kw)
            rtol, atol = (fa_bf16_bound(ref) if q.dtype == torch.bfloat16
                          else (TOL[q.dtype], TOL[q.dtype]))
            err = max(err, check_close(f"{name}, batch rows {b0}..", out[sl], ref, rtol, atol))
            del ref
        worst = max(worst, err)
        chunks = -(-q.shape[0] // rows)
        print(f"{name}: the main path's output against the plain version"
              f"{f' in {chunks} batch chunks' if chunks > 1 else ''}, max abs err {err:.3e} "
              f"(rtol {rtol}, atol {atol:.2e} in the last)")
    return worst


def hold_recorded_bwd(label: str, kept_bwd: dict) -> float:
    """Holds each backward call that recorded_attention kept, the kernel's
    own (dq, dk, dv) on the main path, against flash_attention_bwd_plain on
    the same inputs at their strides, at phase 9a's bound (check_bwd), in
    chunks of batch rows whose plain f32 scores take at most
    PLAIN_SCORE_BYTES. Returns the largest error."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd_plain

    worst = 0.0
    for (q, k, v, out, dout, lse, kw, grads) in kept_bwd.values():
        B, H, S, hd = q.shape
        L = k.shape[2]
        name = (f"{label} flash_attention_bwd's call at q {tuple(q.shape)} strides {q.stride()}, "
                f"k {tuple(k.shape)} strides {k.stride()}, dout strides {dout.stride()}, {kw}, "
                f"{q.dtype}")
        rows, errs = max(1, PLAIN_SCORE_BYTES // (4 * H * S * L)), [0.0, 0.0, 0.0]
        refs = [[], [], []]
        for b0 in range(0, B, rows):
            sl = slice(b0, b0 + rows)
            ref = flash_attention_bwd_plain(q[sl], k[sl], v[sl], out[sl], dout[sl], lse[sl], **kw)
            for x, r in enumerate(ref):
                refs[x].append(r)
            del ref
        for x, g in enumerate(("dq", "dk", "dv")):
            ref = torch.cat(refs[x])
            errs[x] = check_bwd(f"{name} {g}", grads[x], ref, q.dtype)
        del refs, ref
        worst = max(worst, *errs)
        chunks = -(-B // rows)
        print(f"{name}: the main path's gradients against the plain backward"
              f"{f' in {chunks} batch chunks' if chunks > 1 else ''}, max abs err dq/dk/dv "
              f"{errs[0]:.3e}/{errs[1]:.3e}/{errs[2]:.3e} (rtol {BWD_RTOL[q.dtype]}, atol "
              f"{BWD_ATOL[q.dtype]} x max |plain|)")
    return worst


@contextlib.contextmanager
def recorded_masked_decode(calls: list):
    """Keeps each masked decode attention's inputs (copies: the cache is
    written in place by later steps) and output."""
    from repro_torch.models import attention

    saved = attention._masked_decode_attention

    def rec(q, k, v, pos, q_pos, window):
        out = saved(q, k, v, pos, q_pos, window)
        calls.append((q.clone(), k.clone(), v.clone(), pos.clone(), q_pos, window, out))
        return out
    attention._masked_decode_attention = rec
    try:
        yield
    finally:
        attention._masked_decode_attention = saved


def long_attention_row(label: str, B: int, H: int, Hkv: int, S: int, hd: int, gen, dev) -> dict:
    """flash_attention in bf16, causal at S = L too long for the plain
    version whole: held in slices (sliced_attention_check), timed beside
    the plain slices, one SDPA call and the bound."""
    from repro_torch.kernels.flash_attention import flash_attention

    q = torch.randn(B, H, S, hd, generator=gen, device=dev).to(torch.bfloat16)
    k, v = (torch.randn(B, Hkv, S, hd, generator=gen, device=dev).to(torch.bfloat16)
            for _ in range(2))
    shape = f"B={B} H={H} Hkv={Hkv} S=L={S} hd={hd} causal bf16"
    held = sliced_attention_check(f"{label} flash_attention {shape}", q, k, v)
    pairs = S * (S + 1) // 2
    b_ms, b_by = bound(4.0 * B * H * pairs * hd,
                       (2 * B * H + 2 * B * Hkv) * S * hd * q.element_size(), PEAK_BF16_FLOPS)
    row = {"shape": shape, "ms": time_ms(lambda: flash_attention(q, k, v, causal=True), reps=10),
           "plain_ms": held["plain_ms"],
           "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
               q, k, v, is_causal=True, enable_gqa=H != Hkv), reps=10),
           "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": held["err"]}
    print(f"{label} flash_attention {shape}: kernel {row['ms']:.4f} ms, plain (in "
          f"{-(-S // SLICE_ROWS)} slices) {row['plain_ms']:.1f} ms, library (SDPA) "
          f"{row['library_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    kernel_launches(f"{label} flash_attention S={S} hd={hd}",
                    lambda: flash_attention(q, k, v, causal=True), calls=1)
    return row


def masked_f32(q, k, v, pos, q_pos: int, window: int, *, round_scores=False, round_p=False):
    """The masked decode path's attention (models/attention.py
    _masked_decode_attention) in f32 on the same bf16 inputs, with q·k and
    P rounded to bf16 only where asked, and its output not rounded."""
    B, _, H, hd = q.shape
    Hkv = k.shape[2]
    s = torch.einsum("bshgd,blhd->bhgsl", q.float().reshape(B, 1, Hkv, H // Hkv, hd), k.float())
    if round_scores:
        s = s.to(torch.bfloat16).float()
    live = (pos >= 0) & (pos <= q_pos) & (pos > q_pos - window)
    p = torch.softmax((s / hd ** 0.5).masked_fill(~live[:, None, None, None, :], -float("inf")),
                      dim=-1)
    if round_p:
        p = p.to(torch.bfloat16).float()
    return torch.einsum("bhgsl,blhd->bshgd", p, v.float()).reshape(B, 1, H, hd)


def ring_positions(cache_len: int, slots: int, dev) -> torch.Tensor:
    """The position each slot of a ``slots``-slot ring holds once positions
    0 .. cache_len - 1 were written at slot position % slots."""
    s = torch.arange(slots, device=dev, dtype=torch.int64)
    return ((cache_len - 1) - ((cache_len - 1 - s) % slots)).to(torch.int32)


def phase_long_shapes(dev: torch.device, seed: int) -> dict:
    """qwen2-7b at full width and depth, bf16, weights from --seed, at the
    two input shapes no other phase runs: (a) prefill_32k through
    make_prefill_step, the batch cut to PREFILL_BATCH; (b) long_500k through
    model_for_shape's 8192-token window, at batch 1."""
    from repro_torch.config import INPUT_SHAPES
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.score_ce import score_ce
    from repro_torch.launch import make_prefill_step, make_serve_step, model_for_shape
    from repro_torch.models import Model, prompt_from_arrays

    cfg = get_config("qwen2-7b")
    t0 = time.perf_counter()
    model = Model(cfg, device=dev, seed=seed)
    torch.cuda.synchronize()
    H, Hkv, hd, V, d = (cfg.num_heads, cfg.kv_heads(), cfg.resolved_head_dim(), cfg.vocab_size,
                        cfg.d_model)
    print(f"[13] {cfg.name}: {cfg.num_layers} layers, d={d}, H={H}, Hkv={Hkv}, hd={hd}, V={V}, "
          f"{cfg.dtype}; drawn from seed {seed} in {time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device=dev).manual_seed(seed + 13)
    rng = np.random.default_rng(seed)

    # (a) prefill_32k
    shape = INPUT_SHAPES["prefill_32k"]
    B, S, P = PREFILL_BATCH, shape.seq_len, 16
    batch = {"tokens": torch.randint(3, V, (B, S), generator=gen, device=dev, dtype=torch.int32),
             "labels": torch.randint(0, V, (B, S), generator=gen, device=dev,
                                     dtype=torch.int32),
             "mask": torch.ones(B, S, device=dev)}
    prompt = prompt_from_arrays({"soft_prompt": rng.normal(0, 0.5 / np.sqrt(d), (P, d))
                                 .astype(np.float32)}, dev)
    prefill = make_prefill_step(model)
    print(f"[13a] {shape.name}: {S} tokens + a {P}-position soft prompt, batch "
          f"{shape.global_batch} -> {B} (cut: the step's activations, not the weights, set "
          f"the size)")
    flash_attention.launches = score_ce.launches = 0
    calls, seen, kept = {}, [], {}
    torch.cuda.reset_peak_memory_stats(dev)
    with plain_calls(calls), recorded_attention(seen, kept):
        t = time.perf_counter()
        per_ex = prefill(prompt, batch)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t
    launches = {"flash_attention": flash_attention.launches, "score_ce": score_ce.launches}
    peak_gb = torch.cuda.max_memory_allocated(dev) / 2**30
    q_shape, q_strides = seen[0]["q"]
    grid = (q_shape[1], q_shape[0], -(-q_shape[2] // 64))
    last = sum((n - 1) * st for n, st in zip(q_shape, q_strides))
    print(f"[13a] per-example losses {[round(x, 6) for x in per_ex.tolist()]}; first step "
          f"{first_s:.3f} s; peak memory {peak_gb:.2f} GiB; launches {launches}; plain-version "
          f"calls {calls}")
    print(f"[13a] flash_attention's q {q_shape} strides {q_strides} (elements; the kernel takes "
          f"them as long long, the last element at offset {last}, 2^31 = {2 ** 31}); bf16 grid "
          f"(H, B, S/64) = {grid}, z at most 65535")
    if (launches["flash_attention"] != cfg.num_layers or launches["score_ce"] <= 0
            or any(calls.values())):
        raise AssertionError(f"[13a] the prefill step did not launch flash_attention once a "
                             f"layer and score_ce, or a plain version ran: {launches} {calls}")
    if not torch.isfinite(per_ex).all() or per_ex.shape != (B,) or grid[2] > 65535:
        raise AssertionError(f"[13a] the prefill step gave {per_ex} (grid {grid})")
    # layer 0's call as the step made it: every batch row at its strides and
    # 32784 positions, the last 64-row tile ragged
    held_err = hold_recorded("[13a]", kept)
    del kept
    one = {k: v[:1] for k, v in batch.items()}
    with f32_attention():
        per_f32 = prefill(prompt, one)
    rel = abs(per_f32[0].item() - per_ex[0].item()) / abs(per_f32[0].item())
    print(f"[13a] example 0 with the attention in f32 (the f32 kernel): {per_f32[0].item():.6f} "
          f"against {per_ex[0].item():.6f} in bf16, rel {rel:.2e} (tol {BF16_SCORE_RTOL})")
    if not rel <= BF16_SCORE_RTOL:
        raise AssertionError("[13a] the bf16 prefill step's loss disagrees with f32 attention's")
    step = step_profile(f"[13a] one prefill step, batch {B} x {S + P} positions",
                        lambda: prefill(prompt, batch), B * (S + P), warm=0, reps=1, traced=1)
    step.update(peak_gib=peak_gb, per_example=per_ex.tolist(), f32_rel=rel, launches=launches,
                held_err=held_err)
    del batch, one, per_ex, per_f32
    free_card()
    fa_row = long_attention_row("[13a]", 1, H, Hkv, S, hd, gen, dev)
    fa_row.update(launches=launches["flash_attention"])
    free_card()

    # (b) long_500k: the same weights with model_for_shape's window
    shape = INPUT_SHAPES["long_500k"]
    lcfg = model_for_shape(cfg, shape)
    del model
    free_card()
    model = Model(lcfg, device=dev, seed=seed)
    cache = model.init_cache(1, shape.seq_len)
    kv = cache["blocks"]["kv"]
    slots = kv["k"].shape[2]
    filled = shape.seq_len - LONG_STEPS                 # the steps reach position seq_len - 1
    pos = ring_positions(filled, slots, dev)
    for i in range(cfg.num_layers):
        kv["k"][i].normal_(generator=gen)
        kv["v"][i].normal_(generator=gen)
        kv["pos"][i, 0] = pos
    print(f"[13b] {shape.name}: window {lcfg.sliding_window} (model_for_shape), ring of {slots} "
          f"slots at batch {shape.global_batch}, seeded with K/V at positions "
          f"{int(pos.min())}..{int(pos.max())} (cache_len {filled})")
    serve = make_serve_step(model)
    tok = torch.randint(3, V, (1, 1), generator=gen, device=dev, dtype=torch.int32)
    flash_decode.launches = flash_attention.launches = 0
    masked, calls, step_s = [], {}, []
    with plain_calls(calls):
        for i in range(LONG_STEPS):
            t = time.perf_counter()
            with recorded_masked_decode(masked) if i == 0 else contextlib.nullcontext():
                tok, cache = serve(cache, tok, filled + i)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t)
    if (flash_decode.launches or flash_attention.launches or any(calls.values())
            or len(masked) != cfg.num_layers):
        raise AssertionError(f"[13b] the long_500k step should take the masked path in every "
                             f"layer ({len(masked)} of {cfg.num_layers}) and launch no "
                             f"attention kernel: flash_decode {flash_decode.launches}, "
                             f"flash_attention {flash_attention.launches}, plain {calls}")
    if not ((tok >= 0) & (tok < V)).all():
        raise AssertionError("[13b] serve step produced tokens outside the vocabulary")
    gaps, terms = [], []
    for q, k, v, kpos, q_pos, window, out in masked:
        order = torch.argsort(kpos[0])
        kk, vv = (t[:, order].transpose(1, 2) for t in (k, v))    # (B, Hkv, L, hd), by position
        stale = torch.randn(1, Hkv, STALE_ROWS, hd, generator=gen, device=dev).to(kk.dtype)
        kk, vv = torch.cat([stale, kk], dim=2), torch.cat([stale, vv], dim=2)
        first = int(kpos[0, order[0]])
        if int(kpos[0, order[-1]]) != q_pos or q_pos - first + 1 != window:
            raise AssertionError(f"[13b] the ring holds positions {first}..{int(kpos[0, order[-1]])} "
                                 f"at q_pos {q_pos}, window {window}")
        ref = flash_attention(q.transpose(1, 2).contiguous(), kk, vv, causal=True, window=window,
                              q_offset=q_pos - first + STALE_ROWS)
        gaps.append(rel_gap(out.transpose(1, 2).float(), ref.float()))
        exact = masked_f32(q, k, v, kpos, q_pos, window)
        terms.append([rel_gap(x.float(), exact) for x in (
            out, ref.transpose(1, 2), masked_f32(q, k, v, kpos, q_pos, window, round_scores=True),
            masked_f32(q, k, v, kpos, q_pos, window, round_p=True), exact.to(out.dtype))])
    print(f"[13b] masked path against flash_attention (window {lcfg.sliding_window}, "
          f"q_offset, {STALE_ROWS} stale rows before the window) on the first step's K/V, "
          f"||masked - flash|| / ||flash|| per layer: max {max(gaps):.3e} (tol "
          f"{LONG_MASKED_REL_TOL}); by layer {[f'{g:.2e}' for g in gaps]}")
    worst_terms = [max(t[i] for t in terms) for i in range(5)]
    print("[13b] each against the attention in f32 on the same K/V (masked_f32), "
          "||x - f32|| / ||f32||, the largest over the layers: masked path {:.3e}, "
          "flash_attention {:.3e}; q·k rounded to bf16 alone {:.3e}, P rounded alone {:.3e}, "
          "the output rounded alone {:.3e}".format(*worst_terms))
    if not max(gaps) <= LONG_MASKED_REL_TOL:
        raise AssertionError("[13b] the masked decode path disagrees with flash_attention")
    med = statistics.median(step_s[1:])
    print(f"[13b] {LONG_STEPS} serve steps at cache_len {filled}..{shape.seq_len - 1}: "
          f"{[round(x * 1e3, 2) for x in step_s]} ms; median (steps 2..) {med * 1e3:.2f} ms, "
          f"{1 / med:.1f} tokens/s")
    prof = profile_calls(f"[13b] one {shape.name} serve step at batch 1, cache_len "
                         f"{shape.seq_len - 1}", lambda: serve(cache, tok, shape.seq_len - 1),
                         warm=1, reps=5, traced=2)
    del model, cache, kv, masked
    free_card()
    return {"prefill": step, "fa_row": fa_row,
            "long": {"step_ms": med * 1e3, "tokens_per_s": 1 / med, "profile": prof,
                     "masked_gap": max(gaps), "masked_terms": worst_terms}}


# -- phase 14 -------------------------------------------------------------------

# seamless-m4t-medium's decode_32k batch of 128 cut to 16: 12 decoder layers
# x 2 x 32768 x 16 x 64 x 2 B = 25.8 GB of self-attention K/V, and 0.8 GB of
# cross keys and values over its 1024 frames.
ENCDEC_SERVE_BATCH = 16
ENCDEC_CUT_LAYERS = 2          # 2 encoder + 2 decoder layers
# train_4k (14d): the reference's global batch of 256 in microbatches of 8,
# a warm-up step and two more; the bf16 gradient held against f32 on a
# 4 + 4-layer cut.
ENCDEC_TRAIN_BATCH = 256
ENCDEC_TRAIN_MICRO = 8
ENCDEC_TRAIN_STEPS = 3
ENCDEC_GRAD_LAYERS = 4
# The 2 + 2-layer f32 cut's loss, card against CPU (14d): both f32 through
# the same layers, the per-token NLLs summed over at most 4096 tokens a row.
ENCDEC_F32_LOSS_RTOL = 1e-6
# The train_4k row that cut is held on, cut to its first 1024 tokens (1040
# positions against the 1024 frames, still S > L for the cross attention and
# two 512-token loss chunks): the CPU's plain f32 versions take about 29 s
# for the whole row, 14 of them the vocabulary's cross-entropy, 11 the
# attention.
ENCDEC_CPU_TOKENS = 1024


def frontend_score_fn(model, task, tune_cfg, gen):
    """make_score_fn's scorer with a frontend drawn from ``gen`` in its eval
    batch (rows x frames x embed_dim, f32): the Eqn-1 score of a model with
    a frontend (an encoder-decoder's audio, a VLM's image) needs one, and
    the task loader's batches carry none."""
    from repro_torch.core import ScoreContext, make_score_fn

    base = make_score_fn(model, task, tune_cfg)
    fc = model.cfg.frontend
    fe = torch.randn(base.eval_batch["tokens"].shape[0], fc.num_embeddings, fc.embed_dim,
                     generator=gen, device=model.device)
    return ScoreContext(base.tuner, {**base.eval_batch, "frontend": fe})


def fill_cross_kv(model, cache: dict, frontend: torch.Tensor) -> None:
    """Writes each decoder layer's cross keys and values, from ``encode``
    and ``encode_cross_kv`` on ``frontend``, into ``cache["cross_kv"]``."""
    from repro_torch.models.attention import encode_cross_kv

    with torch.no_grad():
        enc = model.encode(frontend)
        for i, block in enumerate(model.decoder):
            k, v = encode_cross_kv(model.cfg, block.cross, enc)
            cache["cross_kv"]["k"][i].copy_(k)
            cache["cross_kv"]["v"][i].copy_(v)


def encdec_kernel_rows(cfg, gen, dev) -> dict:
    """14a: each kernel at seamless-m4t-medium's shapes in bf16, held against
    its plain version and timed beside it, one library call and the bound:
    flash_attention not causal over the encoder's 1024 frames (S = L) and for
    the cross attention of 33 and 513 positions against them; flash_decode at
    decode_32k (B = 16) and against the 1024 cross rows; score_ce at V =
    256206, T = 272 and 7952. Returns the rows and the largest errors."""
    B, H, Hkv, hd = 16, cfg.num_heads, cfg.kv_heads(), cfg.resolved_head_dim()
    frames = cfg.frontend.num_embeddings
    # the encoder (S = L) and the cross attention of 33 and 513 positions;
    # decode_32k's self-attention, and the cross attention with every row live
    rows = {"flash_attention": [attention_row("[14a]", B, H, Hkv, S, hd, gen, dev, L=frames,
                                              causal=False, trace=False)
                                for S in (frames, 33, 513)],
            "flash_decode": [decode_row("[14a]", B, H, Hkv, L, hd, {"kv_len": live},
                                        torch.bfloat16, gen, dev)
                             for L, live in ((32768, 32767), (frames, frames))]}
    return {"rows": rows, "worst": {name: max(r["err"] for r in rs) for name, rs in rows.items()}}


def encdec_depth_witness(model, tokens: torch.Tensor, frontend: torch.Tensor) -> dict:
    """14c: teacher-forced decode against the forward, the cross cache made
    from ``encode`` + ``encode_cross_kv`` on the forward's own frontend (at
    full width the encoder's 1024 frames fill all of its rows). Held layer
    by layer: each decoder layer's one-token steps, fed the forward's input
    to that layer and that layer's cross keys and values, against its
    forward output, as ||dec - fwd|| / ||increment|| (LAYER_DECODE_BF16_TOL
    in bf16); and end to end, the model's decode_step against its forward's
    logits (DECODE_REL_TOL)."""
    from repro_torch.models.attention import encode_cross_kv
    from repro_torch.models.transformer import block_cache, block_decode

    cfg, (B, S) = model.cfg, tokens.shape
    gaps = []
    with torch.no_grad():
        enc = model.encode(frontend)
        x, positions = model.embed_inputs(tokens)
        for block in model.decoder:
            y = block(x, positions, enc)
            kv = encode_cross_kv(cfg, block.cross, enc)
            cache = block_cache(cfg, "decoder_cross", B, S, model.device)
            dec = torch.cat([block_decode(cfg, "decoder_cross", block, x[:, t:t + 1], cache, t, kv)
                             for t in range(S)], dim=1)
            gaps.append(((dec - y).float().norm() / (y - x).float().norm()).item())
            x = y
        full = model(tokens, None, frontend)
        cache = model.init_cache(B, S)
        fill_cross_kv(model, cache, frontend)
        dec = torch.cat([model.decode_step(cache, tokens[:, t:t + 1], t)[0] for t in range(S)],
                        dim=1)
    rel = rel_gap(dec, full)
    agree = (dec.argmax(-1) == full.argmax(-1)).float().mean().item()
    tol = DECODE_REL_TOL[model.dtype]
    print(f"[14c] teacher-forced decode of {S} tokens x {B} rows, {model.dtype}: per decoder layer "
          f"||dec - fwd|| / ||increment|| max {max(gaps):.3e} (tol {LAYER_DECODE_BF16_TOL}), by "
          f"layer {[f'{g:.2e}' for g in gaps]}; end to end ||dec - fwd|| / ||fwd|| = {rel:.3e} "
          f"(tol {tol}), argmax agreement {agree:.3f}")
    if not all(np.isfinite(gaps)) or not max(gaps) <= LAYER_DECODE_BF16_TOL:
        raise AssertionError(f"[14c] decode disagrees with the forward within a layer: {gaps}")
    if not torch.isfinite(dec).all() or not rel <= tol:
        raise AssertionError(f"[14c] decode disagrees with the forward end to end: {rel}")
    return {"layer_gap_max": max(gaps), "layer_gaps": gaps, "logits_gap": rel}


def grad_bf16_vs_f32(label: str, model, layers: int, prompt0: np.ndarray, batch: dict,
                     chunked: bool) -> float:
    """The prompt gradient of one batch on a ``layers``-layer cut of
    ``model`` in bf16 against the same weights in f32, both on the card, by
    relative norm, held at GRAD_BF16_REL_TOL."""
    from repro_torch.models import Model

    cut, cut_sd = cut_state(model, layers)
    grads = {}
    for dtype in ("bfloat16", "float32"):
        m = Model(cut.with_overrides(dtype=dtype, param_dtype=dtype), device=model.device,
                  seed=None)
        m.load_state_dict(cut_sd)
        _, grads[dtype] = prompt_loss_grad(m, prompt0, batch, chunked)
        del m
        free_card()
    rel = rel_gap(grads["bfloat16"], grads["float32"])
    print(f"{label}: prompt gradient on a {layers}-layer cut, ||bf16 - f32|| / ||f32|| = "
          f"{rel:.3e} (tol {GRAD_BF16_REL_TOL})")
    if not rel <= GRAD_BF16_REL_TOL:
        raise AssertionError(f"{label}: the bf16 prompt gradient disagrees with f32")
    return rel


def encdec_tune(model, seed: int, gen) -> dict:
    """14d: make_train_step at train_4k (ENCDEC_TRAIN_BATCH rows of 4096
    tokens and 16 prompt positions, microbatches of ENCDEC_TRAIN_MICRO, each
    batch carrying a seeded (rows, 1024, 1024) f32 frontend), then
    PromptTuner.step at the service's tuning shape (batch 8 x 33 positions,
    the same frontend shape). On both: flash_attention_bwd launched twice a
    decoder layer and microbatch (self and cross attention), never for the
    encoder (S = L = 1024: it sees no prompt and keeps no graph), no plain
    version run; the backward's own calls of the first step held against
    the plain backward; the first microbatch's prompt gradient in bf16
    against f32 on a ENCDEC_GRAD_LAYERS-layer cut. Returns the batches the
    2 + 2-layer f32 cut is held on against the CPU (a train_4k row's first
    ENCDEC_CPU_TOKENS tokens with its whole frontend, the tuning batch), on
    the CPU."""
    from repro_torch.config import INPUT_SHAPES, TuneConfig
    from repro_torch.data import LoaderConfig, TaskLoader
    from repro_torch.launch import make_train_step
    from repro_torch.models import prompt_from_arrays

    cfg, dev = model.cfg, model.device
    shape, tune_cfg = INPUT_SHAPES["train_4k"], TuneConfig()
    P, S, B, micro = tune_cfg.prompt_len, shape.seq_len, ENCDEC_TRAIN_BATCH, ENCDEC_TRAIN_MICRO
    V, frames, E = cfg.vocab_size, cfg.frontend.num_embeddings, cfg.frontend.embed_dim
    per_mb = 2 * cfg.num_layers                         # self and cross, each decoder layer
    rng = np.random.default_rng(seed + 14)
    prompt0 = rng.normal(0, 0.5 / np.sqrt(cfg.d_model), (P, cfg.d_model)).astype(np.float32)

    def frontend(rows: int) -> torch.Tensor:
        return torch.randn(rows, frames, E, generator=gen, device=dev)

    def no_encoder_backward(label: str, shapes: list) -> None:
        if any(q[2] == frames and k[2] == frames for q, k in shapes):
            raise AssertionError(f"{label}: flash_attention_bwd ran at the encoder's S = L = "
                                 f"{frames}: {shapes}")

    print(f"[14d] {shape.name}: {S} tokens + P={P} = {S + P} decoder positions a row against "
          f"{frames} encoder rows; global batch {shape.global_batch} -> {B} in {B // micro} "
          f"microbatches of {micro}, each batch with a seeded frontend {B} x {frames} x {E} f32")
    batches = [{"tokens": torch.randint(3, V, (B, S), generator=gen, device=dev,
                                        dtype=torch.int32),
                "labels": torch.randint(0, V, (B, S), generator=gen, device=dev,
                                        dtype=torch.int32),
                "mask": torch.ones(B, S, device=dev), "frontend": frontend(B)}
               for _ in range(ENCDEC_TRAIN_STEPS)]
    step, opt = make_train_step(model, tune_cfg, microbatches=B // micro)
    seen, kept_bwd = [], {}
    t_tune = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)

    def run():
        cur, st, out = prompt_from_arrays({"soft_prompt": prompt0}, dev), None, []
        st = opt.init(cur)
        for i, b in enumerate(batches):
            t = time.perf_counter()
            with (recorded_attention(seen, None, kept_bwd) if i == 0 else contextlib.nullcontext()):
                cur, st, loss = step(cur, st, b)
                loss = float(loss)
            out.append((loss, time.perf_counter() - t))
        return cur, out

    (pp, steps), launches = main_path(f"[14d] {len(batches)} make_train_step steps, batch {B}",
                                      run)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    n_mb = len(batches) * (B // micro)
    shapes = sorted({(c["q"][0], c["k"][0]) for c in seen if c.get("bwd")})
    no_encoder_backward("[14d] train_4k", shapes)
    step_s = [t for _, t in steps[1:]]
    print(f"[14d] {len(batches)} steps (loss, s): {[(round(l, 6), round(t, 2)) for l, t in steps]}; "
          f"after the warm-up {statistics.mean(step_s):.2f} s a step, "
          f"{B * (S + P) / statistics.mean(step_s):.0f} positions/s; max_memory_allocated "
          f"{peak:.2f} GiB; flash_attention_bwd launches {launches['flash_attention_bwd']} "
          f"({per_mb} a microbatch expected), the first step's backward calls at (q, k) "
          f"shapes {shapes}")
    if (launches["flash_attention_bwd"] != per_mb * n_mb
            or not np.isfinite([l for l, _ in steps]).all()
            or not torch.isfinite(pp["soft_prompt"]).all()):
        raise AssertionError(f"[14d] the train steps launched flash_attention_bwd "
                             f"{launches['flash_attention_bwd']} times, not {per_mb} a "
                             f"microbatch, or gave a non-finite loss or prompt: {steps}")
    held = hold_recorded_bwd("[14d] train_4k", kept_bwd)
    first = {k: v[:micro] for k, v in batches[0].items()}
    train_row = {k: (v[:1] if k == "frontend" else v[:1, :ENCDEC_CPU_TOKENS]).cpu()
                 for k, v in batches[0].items()}
    del batches, kept_bwd, pp
    free_card()
    micro_profile = step_profile(
        f"[14d] one train_4k microbatch's loss and prompt gradient (lpt_loss_chunked, as "
        f"make_train_step takes it), {micro} x {S + P} positions",
        lambda: prompt_loss_grad(model, prompt0, first, chunked=True), micro * (S + P),
        warm=1, reps=2, traced=1)
    grad_rel = {"train_4k": grad_bf16_vs_f32(f"[14d] train_4k, the first microbatch ({micro} x "
                                             f"{S + P} positions)", model, ENCDEC_GRAD_LAYERS,
                                             prompt0, first, chunked=True)}
    del first
    free_card()

    # PromptTuner.step at the service's tuning shape, a frontend in each batch
    loader = TaskLoader(synthetic_task(), LoaderConfig(batch_size=tune_cfg.batch_size, seed=seed))
    tbatches = [{**next(loader), "frontend": frontend(tune_cfg.batch_size)}
                for _ in range(TUNING_STEPS)]
    tb, positions = tune_cfg.batch_size, P + tbatches[0]["tokens"].shape[1]
    tuning = tuner_steps("[14d]", model, prompt0, tbatches, per_mb)
    no_encoder_backward("[14d] tuning", tuning["bwd_shapes"])
    grad_rel["tuning"] = grad_bf16_vs_f32(f"[14d] tuning batch ({tb} x {positions} positions)",
                                          model, ENCDEC_GRAD_LAYERS, prompt0, tbatches[0],
                                          chunked=False)
    tune_batch = {k: torch.as_tensor(v).cpu() for k, v in tbatches[0].items()}
    del tbatches
    free_card()
    print(f"[14d] tuning on the card: {time.perf_counter() - t_tune:.1f} s")
    return {"launches": launches, "tune_launches": tuning["launches"], "steps": len(steps),
            "tune_steps": len(tuning["losses"]), "step_s": step_s, "peak_gib": peak,
            "held": max(held, tuning["held"]), "grad_rel": grad_rel,
            "profile": tuning["profile"], "micro_profile": micro_profile, "prompt0": prompt0,
            "train_row": train_row, "tune_batch": tune_batch}


def encdec_cut_vs_cpu(cut_and_state, dev, gen, tune: dict) -> float:
    """14c: the 2 + 2-layer f32 cut, card against CPU, on the same seeded
    frontend and tokens: the Eqn-1 loss with the frontend in the batch, and
    4 decode steps with each side's cross cache from its own encoder. 14d:
    the loss and prompt gradient of a train_4k row (its first
    ENCDEC_CPU_TOKENS tokens) through make_train_step's chunked loss and of
    the tuning batch through
    PromptTuner's, at ENCDEC_F32_LOSS_RTOL and TUNE_F32_PROMPT_TOL."""
    from repro_torch.train.objectives import lpt_loss

    card, cpu = depth_cut(cut_and_state, dev)
    fc, V = card.cfg.frontend, card.cfg.vocab_size
    fe = torch.randn(2, fc.num_embeddings, fc.embed_dim, generator=gen, device=dev)
    tokens = torch.randint(3, V, (2, 8), generator=gen, device=dev)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1),
             "mask": torch.ones(tokens.shape, device=dev), "frontend": fe}
    prompt = 0.02 * torch.randn(16, card.cfg.d_model, generator=gen, device=dev)
    with torch.no_grad():
        lg = lpt_loss(card, prompt, batch)[1][0].item()
        lc = lpt_loss(cpu, prompt.cpu(), {k: v.cpu() for k, v in batch.items()})[1][0].item()
    rel = abs(lg - lc) / abs(lc)
    print(f"[14c] {ENCDEC_CUT_LAYERS} + {ENCDEC_CUT_LAYERS}-layer f32 cut, Eqn-1 loss with a "
          f"seeded frontend: cpu {lc:.6f}, card {lg:.6f} (rel {rel:.2e}, tol {F32_SCORE_RTOL})")
    if not rel <= F32_SCORE_RTOL:
        raise AssertionError("[14c] card f32 Eqn-1 loss disagrees with the CPU")
    caches = [m.init_cache(2, 8) for m in (card, cpu)]
    fill_cross_kv(card, caches[0], fe)
    fill_cross_kv(cpu, caches[1], fe.cpu())
    worst = 0.0
    for t in range(4):
        g, _ = card.decode_step(caches[0], tokens[:, t:t + 1], t)
        c, _ = cpu.decode_step(caches[1], tokens[:, t:t + 1].cpu(), t)
        worst = max(worst, check_close(f"[14c] decode step {t}, card f32 against CPU f32",
                                       g.cpu(), c, F32_LOGIT_TOL))
    print(f"[14c] the cut's 4 decode steps, card (kernels) against CPU (plain versions): max abs "
          f"logit diff {worst:.3e} (tol {F32_LOGIT_TOL})")
    cut = f"[14d] {ENCDEC_CUT_LAYERS} + {ENCDEC_CUT_LAYERS}-layer f32 cut"
    grads = {"train_4k": grad_card_vs_cpu(f"{cut}, a train_4k row's first {ENCDEC_CPU_TOKENS} "
                                          "tokens, the chunked loss", card, cpu,
                                          tune["prompt0"], tune["train_row"], ENCDEC_F32_LOSS_RTOL,
                                          chunked=True),
             "tuning": grad_card_vs_cpu(f"{cut}, the tuning batch, PromptTuner's loss", card, cpu,
                                        tune["prompt0"], tune["tune_batch"], ENCDEC_F32_LOSS_RTOL)}
    del card, cpu
    return max(rel, worst), grads


def phase_encdec(dev: torch.device, seed: int) -> dict:
    """seamless-m4t-medium (12 encoder + 12 decoder layers, cross attention,
    an audio frontend stub of 1024 frames) at full width and depth, bf16,
    weights from ``seed``."""
    from repro_torch.config import INPUT_SHAPES
    from repro_torch.configs import get_config
    from repro_torch.data import make_tasks
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.score_ce import score_ce
    from repro_torch.launch import make_serve_step
    from repro_torch.models import Model

    t_phase = time.perf_counter()
    cfg = get_config("seamless-m4t-medium")
    t0 = time.perf_counter()
    model = Model(cfg, device=dev, seed=seed)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    H, Hkv, hd, V = cfg.num_heads, cfg.kv_heads(), cfg.resolved_head_dim(), cfg.vocab_size
    frames, E = cfg.frontend.num_embeddings, cfg.frontend.embed_dim
    print(f"[14] {cfg.name}: {cfg.encdec.num_encoder_layers} encoder + {cfg.num_layers} decoder "
          f"layers, d={cfg.d_model}, H={H}, Hkv={Hkv}, hd={hd}, d_ff {cfg.d_ff}, V={V}, frontend "
          f"{frames} frames x {E}, {cfg.norm}, {cfg.activation}, tied={cfg.tie_embeddings}, "
          f"{cfg.dtype}; {n_params / 1e9:.3f} B parameters, "
          f"{sum(p.numel() * p.element_size() for p in model.parameters()) / 1e9:.2f} GB; drawn "
          f"from seed {seed} in {time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device=dev).manual_seed(seed + 14)

    # (a) the kernels at the slice's shapes
    kern = encdec_kernel_rows(cfg, gen, dev)
    score_rows = score_ce_rows("[14a]", cfg.name, model.embedding.detach(), (16 * 17, 16 * 497),
                               gen)

    # (b) Prompt Bank lookups, each evaluation's batch carrying a seeded frontend
    tasks = make_tasks(vocab=32, partitions=2)
    requests = [tasks[4], make_tasks(input_len=248, target_len=248)[9]]   # 33, 513 positions
    kept: dict = {}
    with recorded_attention([], kept):
        look = bank_and_lookups("[14b]", model, requests, seed,
                                score_fn_for=lambda task, tc: frontend_score_fn(model, task, tc, gen))
    per_layer = cfg.encdec.num_encoder_layers + 2 * cfg.num_layers   # encoder, self, cross
    if look["per_eval"] != per_layer:
        raise AssertionError(f"[14b] flash_attention launched {look['per_eval']} times an "
                             f"evaluation, not {per_layer}")
    _, res, score_fn = look["results"][0]
    profile = profile_calls(f"[14b] one {cfg.name} evaluation at "
                            f"{16 + score_fn.eval_batch['tokens'].shape[1]} positions",
                            lambda: score_fn(res.entry), warm=2, reps=5, traced=2)
    del look["bank"], look["results"], score_fn, res
    free_card()
    held_err = hold_recorded("[14b]", kept)
    del kept
    free_card()

    # (c) the serve step at decode_32k, the cross cache filled from a seeded frontend
    shape = INPUT_SHAPES["decode_32k"]
    B, L = ENCDEC_SERVE_BATCH, shape.seq_len
    per_row = cfg.num_layers * 2 * L * Hkv * hd * 2
    print(f"[14c] {shape.name}: cache of {L} tokens, batch {shape.global_batch} -> {B} "
          f"({per_row * B / 1e9:.1f} GB of self-attention K/V at batch {B}, "
          f"{per_row * shape.global_batch / 1e9:.0f} GB at {shape.global_batch}); cross cache "
          f"{cfg.num_layers} x 2 x {B} x {frames} x {Hkv} x {hd}")
    cache = model.init_cache(B, L)
    kv = cache["decoder"]["kv"]
    filled = L - 8                                      # seeded K/V at positions 0..32759
    for i in range(cfg.num_layers):
        kv["k"][i, :, :filled].normal_(generator=gen)
        kv["v"][i, :, :filled].normal_(generator=gen)
    kv["pos"][:, :, :filled] = torch.arange(filled, device=dev, dtype=torch.int32)
    fill_cross_kv(model, cache, torch.randn(B, frames, E, generator=gen, device=dev))
    cross_before = cache["cross_kv"]["k"].clone()
    serve = make_serve_step(model)
    tok = torch.randint(3, V, (B, 1), generator=gen, device=dev, dtype=torch.int32)
    torch.cuda.synchronize()
    n_steps, step_s, calls = L - filled, [], {}
    kernels = {"flash_decode": flash_decode, "flash_attention": flash_attention,
               "score_ce": score_ce}
    for fn in kernels.values():
        fn.launches = 0
    with plain_calls(calls):
        for i in range(n_steps):
            t = time.perf_counter()
            tok, cache = serve(cache, tok, filled + i)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t)
    launches = {name: fn.launches for name, fn in kernels.items()}
    if launches["flash_decode"] != 2 * cfg.num_layers * n_steps or any(calls.values()):
        raise AssertionError(f"[14c] {n_steps} serve steps launched {launches}, not "
                             f"{2 * cfg.num_layers} flash_decode a step, or a plain version "
                             f"ran: {calls}")
    if not ((tok >= 0) & (tok < V)).all() or not torch.equal(cache["cross_kv"]["k"], cross_before):
        raise AssertionError("[14c] a serve step gave tokens outside the vocabulary or wrote "
                             "the cross cache")
    med = statistics.median(step_s[1:])
    print(f"[14c] {n_steps} serve steps at cache_len {filled}..{L - 1}: "
          f"{[round(x * 1e3, 2) for x in step_s]} ms; median (steps 2..) {med * 1e3:.2f} ms per "
          f"step, {B / med:.0f} tokens/s; launches {launches} "
          f"({launches['flash_decode'] // n_steps} flash_decode a step: self and cross)")
    step_profile = profile_calls(f"[14c] one serve step at batch {B}, cache {L - 1}",
                                 lambda: serve(cache, tok, L - 1), warm=2, reps=5, traced=3)
    for t in cache["cross_kv"].values():
        t.zero_()                                       # the cross cache the reference leaves
    with torch.no_grad():
        logits, _ = model.decode_step(cache, tok, L - 1)
    if not torch.isfinite(logits).all():
        raise AssertionError("[14c] the step on the zero cross cache gave non-finite logits")
    print(f"[14c] one step on the zero cross cache: logits finite, max |logit| "
          f"{logits.abs().max().item():.3e}")
    del cache, kv, cross_before, logits
    free_card()
    tokens = torch.randint(3, V, (2, 32), generator=gen, device=dev)
    witness = encdec_depth_witness(model, tokens,
                                   torch.randn(2, frames, E, generator=gen, device=dev))

    # (d) prompt tuning: make_train_step at train_4k and PromptTuner.step
    tune = encdec_tune(model, seed, gen)
    state = cut_state(model, ENCDEC_CUT_LAYERS)
    del model
    free_card()
    cut_rel, cut_grads = encdec_cut_vs_cpu(state, dev, gen, tune)
    free_card()
    wall = time.perf_counter() - t_phase
    print(f"[14] {cfg.name}: {wall:.1f} s")
    decode_rows = kern["rows"]["flash_decode"]
    decode_rows[0].update(launches=launches["flash_decode"], step_ms=med * 1e3,
                          tokens_per_s=B / med, profile=step_profile)
    return {"fa_rows": kern["rows"]["flash_attention"], "decode_rows": decode_rows,
            "score_rows": score_rows, "worst": kern["worst"], "by_shape": look["by_shape"],
            "per_eval": look["per_eval"], "decode_launches": launches["flash_decode"],
            "profile": profile, "held_err": held_err, "witness": witness, "cut_rel": cut_rel,
            "tune": {k: tune[k] for k in ("launches", "tune_launches", "steps", "tune_steps",
                                          "step_s", "peak_gib", "held", "grad_rel", "profile",
                                          "micro_profile")},
            "cut_grads": cut_grads, "seconds": wall}


# -- phase 15 -------------------------------------------------------------------

# paligemma-3b's decode_32k at the shape's full batch, no cut: 18 layers x 2 x
# 128 x 32768 x 256 x 2 B = 77.3 GB of K/V, 0.30 GB of int32 positions and
# 3.81 GB of weights, 81.4 GB of the card's 85.
VLM_SERVE_BATCH = 128
VLM_CUT_LAYERS = 2
# The full-depth Eqn-1 scores held against the CPU's f32 path (15d) take the
# first rows of the 33-position request's eval batch with their frontend
# rows: the CPU's f32 forward of 1.9 B parameters over 16 rows of 289
# positions would take minutes.
VLM_CPU_ROWS = 2
# Batch rows of one serve step's own flash_decode call held against the
# plain version (15f): its f32 copy of the whole 128-row cache would not fit.
DECODE_HOLD_ROWS = 8


@contextlib.contextmanager
def recorded_decode(calls: list):
    """Keeps each flash_decode call's q, k and v (the cache's own views, not
    copies), keywords and output in ``calls``. A layer's cache rows that a
    step read are not written again by later layers or steps, which write
    only past them."""
    from repro_torch.kernels import ops

    saved = ops.flash_decode

    def rec(q, k, v, **kw):
        out = saved(q, k, v, **kw)
        calls.append((q, k, v, dict(kw), out))
        return out
    ops.flash_decode = rec
    try:
        yield
    finally:
        ops.flash_decode = saved


def frontend_scores_vs_cpu(label: str, model, look: dict, rows: int) -> float:
    """Eqn-1 scores of the first request's picked entry and another medoid
    at full depth, the card in bf16 against the CPU's f32 path on the same
    weights (widened), on the first ``rows`` rows of the request's eval
    batch with their frontend rows, at BF16_SCORE_RTOL."""
    from repro_torch.core import ScoreContext
    from repro_torch.models import Model
    from repro_torch.tuning import PromptTuner

    bank, (task, res, score_fn) = look["bank"], look["results"][0]
    batch = {k: v[:rows] for k, v in score_fn.eval_batch.items()}
    t0 = time.perf_counter()
    cpu = Model(model.cfg.with_overrides(dtype="float32", param_dtype="float32"), device="cpu",
                seed=None)
    cpu.load_state_dict(model.state_dict())
    card_fn = ScoreContext(score_fn.tuner, batch)
    cpu_fn = ScoreContext(PromptTuner(cpu, score_fn.tuner.tune_cfg),
                          {k: v.cpu() for k, v in batch.items()})
    entries = [res.entry, next(bank.entries[i] for i in bank.medoid_ids
                               if bank.entries[i] is not res.entry)]
    worst = 0.0
    for entry in entries:
        c, g = cpu_fn(entry), card_fn(entry)
        rel = abs(g - c) / abs(c)
        worst = max(worst, rel)
        print(f"{label} {task.task_id} {entry.origin}, {rows} eval rows with the image: cpu f32 "
              f"{c:.6f}, card bf16 {g:.6f} (rel {rel:.2e}, tol {BF16_SCORE_RTOL})")
    print(f"{label} the CPU's f32 path: {time.perf_counter() - t0:.1f} s")
    del cpu, cpu_fn
    if not worst <= BF16_SCORE_RTOL:
        raise AssertionError(f"{label} card bf16 Eqn-1 scores disagree with the CPU f32 path")
    return worst


def vlm_serve(model, gen) -> dict:
    """15f: decode_32k at VLM_SERVE_BATCH rows, the cache's first 32760 slots
    seeded, 8 serve steps with flash_decode launched once a layer and no
    plain version run, one layer's own call held on DECODE_HOLD_ROWS rows,
    one step profiled, the peak memory; then flash_decode timed at the
    step's shape on one layer's fresh K/V."""
    from repro_torch.config import INPUT_SHAPES
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_decode import flash_decode, flash_decode_plain
    from repro_torch.kernels.score_ce import score_ce
    from repro_torch.launch import make_serve_step

    cfg, dev = model.cfg, model.device
    shape = INPUT_SHAPES["decode_32k"]
    B, L = VLM_SERVE_BATCH, shape.seq_len
    H, Hkv, hd, V = cfg.num_heads, cfg.kv_heads(), cfg.resolved_head_dim(), cfg.vocab_size
    kv_gb = cfg.num_layers * 2 * B * L * Hkv * hd * 2 / 1e9
    pos_gb = cfg.num_layers * B * L * 4 / 1e9
    weight_gb = sum(p.numel() * p.element_size() for p in model.parameters()) / 1e9
    free, total = torch.cuda.mem_get_info(dev)
    print(f"[15f] {shape.name}: cache of {L} tokens at batch {B} of {shape.global_batch}: "
          f"{kv_gb:.2f} GB of K/V + {pos_gb:.2f} GB of positions + {weight_gb:.2f} GB of weights "
          f"= {kv_gb + pos_gb + weight_gb:.2f} GB of the card's {total / 1e9:.2f} GB "
          f"({free / 1e9:.2f} GB free before the cache, "
          f"{torch.cuda.memory_allocated(dev) / 1e9:.2f} GB allocated)")
    torch.cuda.reset_peak_memory_stats(dev)
    cache = model.init_cache(B, L)
    kv = cache["blocks"]["kv"]
    filled = L - 8                                      # seeded K/V at positions 0..32759
    for i in range(cfg.num_layers):
        for name in ("k", "v"):
            kv[name][i].normal_(generator=gen)
            kv[name][i, :, filled:].zero_()
    kv["pos"][:, :, :filled] = torch.arange(filled, device=dev, dtype=torch.int32)
    serve = make_serve_step(model)
    tok = torch.randint(3, V, (B, 1), generator=gen, device=dev, dtype=torch.int32)
    torch.cuda.synchronize()
    n_steps, step_s, calls, seen = L - filled, [], {}, []
    kernels = {"flash_decode": flash_decode, "flash_attention": flash_attention,
               "score_ce": score_ce}
    for fn in kernels.values():
        fn.launches = 0
    with plain_calls(calls), recorded_decode(seen):
        for i in range(n_steps):
            t = time.perf_counter()
            tok, cache = serve(cache, tok, filled + i)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t)
    launches = {name: fn.launches for name, fn in kernels.items()}
    if launches["flash_decode"] != cfg.num_layers * n_steps or any(calls.values()):
        raise AssertionError(f"[15f] {n_steps} serve steps launched {launches}, not "
                             f"{cfg.num_layers} flash_decode a step, or a plain version ran: "
                             f"{calls}")
    if not ((tok >= 0) & (tok < V)).all():
        raise AssertionError("[15f] a serve step gave tokens outside the vocabulary")
    med = statistics.median(step_s[1:])
    print(f"[15f] {n_steps} serve steps at cache_len {filled}..{L - 1}: "
          f"{[round(x * 1e3, 2) for x in step_s]} ms; median (steps 2..) {med * 1e3:.2f} ms per "
          f"step, {B / med:.0f} tokens/s; launches {launches} "
          f"({launches['flash_decode'] // n_steps} flash_decode a step)")
    # layer 0's call of the last step, on its first DECODE_HOLD_ROWS rows
    q, k, v, kw, out = seen[-cfg.num_layers]
    n = DECODE_HOLD_ROWS
    ref = flash_decode_plain(q[:n], k[:n], v[:n], **{x: y for x, y in kw.items()
                                                     if x != "splits"})
    top = ref.float().abs().max().item()
    held = check_close(f"[15f] layer 0's flash_decode call of the last step, rows 0..{n - 1}",
                       out[:n], ref, DECODE_BF16_RTOL, DECODE_BF16_ATOL * top)
    print(f"[15f] layer 0's own flash_decode call of the last step (q {tuple(q.shape)}, k "
          f"{tuple(k.shape)} strides {k.stride()}, {kw}) on rows 0..{n - 1} against the plain "
          f"version: max abs err {held:.3e} (rtol {DECODE_BF16_RTOL}, atol "
          f"{DECODE_BF16_ATOL * top:.2e})")
    del seen, q, k, v, out, ref
    profile = profile_calls(f"[15f] one serve step at batch {B}, cache {L - 1}",
                            lambda: serve(cache, tok, L - 1), warm=2, reps=5, traced=3)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    print(f"[15f] peak memory over the cache and the steps: {peak_gb:.2f} GB")
    del cache, kv
    free_card()
    # flash_decode at the step's shape, on one layer's fresh K/V
    row = decode_row("[15f]", B, H, Hkv, L, hd, {"kv_len": L - 1}, torch.bfloat16, gen, dev)
    row.update(launches=launches["flash_decode"], step_ms=med * 1e3, tokens_per_s=B / med,
               profile=profile, peak_gb=peak_gb, held_err=held)
    free_card()
    return row


def vlm_cut_vs_cpu(cut_and_state, dev, gen) -> float:
    """15e: the 2-layer f32 cut at full width, card against CPU, on one row
    of [image][prompt][tokens]: the forward's logits at every position, then
    4 decode steps of text, at F32_LOGIT_TOL."""
    card, cpu = depth_cut(cut_and_state, dev)
    fc, d, V = card.cfg.frontend, card.cfg.d_model, card.cfg.vocab_size
    fe = torch.randn(1, fc.num_embeddings, fc.embed_dim, generator=gen, device=dev)
    tokens = torch.randint(3, V, (1, 8), generator=gen, device=dev)
    prompt = 0.02 * torch.randn(16, d, generator=gen, device=dev)
    with torch.no_grad():
        lg = card(tokens, prompt, fe).cpu()
        lc = cpu(tokens.cpu(), prompt.cpu(), fe.cpu())
    worst = check_close(f"[15e] {VLM_CUT_LAYERS}-layer f32 cut, logits of [image][prompt][tokens]",
                        lg, lc, F32_LOGIT_TOL)
    print(f"[15e] {VLM_CUT_LAYERS}-layer f32 cut, logits of {lg.shape[1]} positions "
          f"({fc.num_embeddings} image + 16 prompt + 8 tokens), card (kernels) against CPU "
          f"(plain versions): max abs diff {worst:.3e} (tol {F32_LOGIT_TOL})")
    del lg, lc
    caches = [m.init_cache(1, 8) for m in (card, cpu)]
    for t in range(4):
        g, _ = card.decode_step(caches[0], tokens[:, t:t + 1], t)
        c, _ = cpu.decode_step(caches[1], tokens[:, t:t + 1].cpu(), t)
        worst = max(worst, check_close(f"[15e] decode step {t}, card f32 against CPU f32",
                                       g.cpu(), c, F32_LOGIT_TOL))
    print(f"[15e] the cut's 4 decode steps and its forward: max abs logit diff {worst:.3e} "
          f"(tol {F32_LOGIT_TOL})")
    return worst


def phase_vlm(dev: torch.device, seed: int) -> dict:
    """paligemma-3b (18 layers, 8 heads of 256 over one kv-head, a vision
    frontend stub of 256 patches x 1152) at full width and depth, bf16,
    weights from ``seed``."""
    from repro_torch.configs import get_config
    from repro_torch.data import make_tasks
    from repro_torch.models import Model

    t_phase = time.perf_counter()
    cfg = get_config("paligemma-3b")
    t0 = time.perf_counter()
    model = Model(cfg, device=dev, seed=seed)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    H, Hkv, hd, V = cfg.num_heads, cfg.kv_heads(), cfg.resolved_head_dim(), cfg.vocab_size
    patches, E = cfg.frontend.num_embeddings, cfg.frontend.embed_dim
    print(f"[15] {cfg.name}: {cfg.num_layers} layers, d={cfg.d_model}, H={H}, Hkv={Hkv}, hd={hd}, "
          f"d_ff {cfg.d_ff}, V={V}, vision frontend {patches} patches x {E}, {cfg.norm}, "
          f"{cfg.activation}, tied={cfg.tie_embeddings}, {cfg.dtype}; {n_params / 1e9:.3f} B "
          f"parameters, {sum(p.numel() * p.element_size() for p in model.parameters()) / 1e9:.2f} "
          f"GB; drawn from seed {seed} in {time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device=dev).manual_seed(seed + 15)

    # (a) score_ce at (D, V) = (2048, 257216); the hd-256 attention kernels are held in 2v
    score_rows = score_ce_rows("[15a]", cfg.name, model.embedding.detach(), (16 * 17, 16 * 497),
                               gen)

    # (c) teacher-forced decode against the forward, on text
    decode_rel = teacher_forced("[15c]", model,
                                torch.randint(3, V, (2, 32), generator=gen, device=dev))

    # (d) Prompt Bank lookups, each evaluation's batch carrying a seeded image
    tasks = make_tasks(vocab=32, partitions=2)
    requests = [tasks[5], make_tasks(input_len=248, target_len=248)[9]]   # 33, 513 positions
    kept: dict = {}
    with recorded_attention([], kept):
        look = bank_and_lookups("[15d]", model, requests, seed,
                                score_fn_for=lambda task, tc: frontend_score_fn(model, task, tc,
                                                                                gen))
    if look["per_eval"] != cfg.num_layers:
        raise AssertionError(f"[15d] flash_attention launched {look['per_eval']} times an "
                             f"evaluation, not {cfg.num_layers}")
    _, res, score_fn = look["results"][0]
    # (g) one evaluation profiled
    profile = profile_calls(f"[15g] one {cfg.name} evaluation at "
                            f"{patches + 16 + score_fn.eval_batch['tokens'].shape[1]} positions",
                            lambda: score_fn(res.entry), warm=2, reps=5, traced=2)
    cpu_rel = frontend_scores_vs_cpu("[15d]", model, look, VLM_CPU_ROWS)
    del look["bank"], look["results"], score_fn, res
    free_card()
    held_err = hold_recorded("[15d]", kept)
    del kept
    free_card()

    # (f) the serve step at decode_32k's full batch
    state = cut_state(model, VLM_CUT_LAYERS)
    decode_row = vlm_serve(model, gen)
    del model
    free_card()

    # (e) the 2-layer f32 cut against the CPU
    cut_err = vlm_cut_vs_cpu(state, dev, gen)
    del state
    free_card()
    wall = time.perf_counter() - t_phase
    print(f"[15] {cfg.name}: {wall:.1f} s")
    return {"score_rows": score_rows, "decode_row": decode_row, "by_shape": look["by_shape"],
            "per_eval": look["per_eval"], "profile": profile, "held_err": held_err,
            "decode_rel": decode_rel, "cpu_score_rel": cpu_rel, "cut_err": cut_err,
            "seconds": wall}


# -- phase 9 --------------------------------------------------------------------

# flash_attention's backward checks: B, H, Hkv, S, L, hd, kwargs (causal
# unless they say otherwise). GQA 28/4 at hd 128 and MHA at hd 64; a window
# with kv_len < L; q_offset > 0; S not a multiple of the 64-row tile; rows
# with no live column (window 4, kv_len 10: rows 13-19 see nothing); the
# training shape of vicuna-7b (4112 positions, hd 128, MHA). Then the bf16
# kernel's tile edges: S = L = 127, 128, 129 and 257 around its 128-row KV
# tile, a GQA group of 7, and a window and kv_len that end inside a KV tile.
# Then FA_BWD_NEW: head dim 112 (zamba2-7b, padded to 128 in the bf16
# kernel) at its tuning shape, at 513 and 4112 positions and at the tile
# edges, and seamless-m4t-medium's cross attention, not causal, S > L.
FA_BWD_NEW = [
    (8, 32, 32, 33, 33, 112, {}),                                # zamba2-7b tuning, batch 8
    (1, 32, 32, 513, 513, 112, {}),
    (1, 32, 32, 4112, 4112, 112, {}),
    (1, 4, 4, 127, 127, 112, {}),
    (1, 4, 4, 129, 129, 112, {}),
    (1, 4, 4, 257, 257, 112, {}),
    (1, 8, 2, 300, 300, 112, {"window": 100, "kv_len": 200}),
    (2, 16, 16, 4112, 1024, 64, {"causal": False}),              # seamless train_4k, cross
    (2, 16, 16, 33, 1000, 64, {"causal": False, "kv_len": 937}),
]
FA_BWD_CASES = [
    (2, 28, 4, 513, 513, 128, {}),
    (2, 12, 12, 513, 513, 64, {}),
    (2, 28, 4, 513, 513, 128, {"window": 128, "kv_len": 400}),
    (2, 28, 4, 64, 513, 128, {"q_offset": 449}),
    (2, 12, 12, 65, 65, 64, {}),
    (2, 12, 4, 65, 200, 64, {"q_offset": 135, "window": 70}),
    (2, 12, 4, 20, 20, 64, {"window": 4, "kv_len": 10}),
    (2, 12, 12, 65, 130, 64, {"causal": False, "kv_len": 100}),
    (8, 12, 12, 33, 33, 64, {}),                                 # gpt2-base tuning, batch 8
    (1, 32, 32, 4112, 4112, 128, {}),                            # vicuna-7b train_4k
    (1, 4, 4, 127, 127, 128, {}),
    (1, 4, 4, 128, 128, 128, {}),
    (1, 4, 4, 129, 129, 64, {}),
    (1, 4, 4, 257, 257, 128, {}),
    (2, 14, 2, 129, 257, 128, {"q_offset": 128}),                 # GQA 7:1
    (1, 7, 1, 300, 300, 64, {"window": 100, "kv_len": 200}),
    (1, 4, 4, 129, 129, 128, {"causal": False, "kv_len": 100}),
    *FA_BWD_NEW,
]
# score_ce's backward checks: T, D, V. gpt2-base's tuning batch (8 rows of
# 17 tokens) and T one past a 128-row tile; vicuna-7b's at a 512-position
# chunk of one sequence, and at 8192 rows, which the wrapper splits into two
# vocabulary chunks in bf16 (four in f32), the last one ragged. Then the
# bf16 kernels' tile edges (T = 64, 65, 128, 129: the 64-row warpgroups and
# 128-row tiles) and deepseek-v2's D = 5120, V = 102400 at T = 272.
SCE_BWD_CASES = [(136, 768, 50257), (273, 768, 50257), (1, 768, 50257),
                 (512, 4096, 32000), (8192, 4096, 32000), (64, 768, 50257), (65, 768, 50257),
                 (128, 768, 50257), (129, 768, 50257), (272, 5120, 102400)]
# The kernels each bf16 backward wrapper may launch (phase 9a): its own, so
# no library kernel (cuBLAS, cuDNN, CUTLASS) runs inside it.
PORT_BWD_KERNELS = {"flash_attention_bwd": ("fa_bwd_prep", "fa_bwd_bf16", "fa_bwd_dq_out"),
                    "score_ce_bwd": ("score_ce_bwd_bf16", "score_ce_ge_bf16", "score_ce_ge_sum"),
                    "score_ce_de": ("score_ce_bwd_bf16", "score_ce_ge_bf16", "score_ce_ge_sum",
                                    "score_ce_de_bf16"),
                    "rwkv6_wkv_bwd": ("rwkv6_wkv_bwd_chunked", "rwkv6_wkv_bwd_du")}


def check_bwd(name: str, out: torch.Tensor, ref: torch.Tensor, dtype) -> float:
    return check_close(name, out, ref, BWD_RTOL[dtype],
                       BWD_ATOL[dtype] * ref.float().abs().max().item())


def fa_bwd_bound(B: int, H: int, Hkv: int, S: int, L: int, hd: int, pairs: int, elt: int):
    """Least time of one flash_attention_bwd call: q, o, dO and dq (B·H·S·hd),
    k, v, dk and dv (B·Hkv·L·hd) moved once, the f32 lse; 10·hd operations a
    live (query, key) pair and head (the scores again, dP, dV, dK, dQ)."""
    nbytes = (4 * B * H * S + 4 * B * Hkv * L) * hd * elt + B * H * S * 4
    return bound(10.0 * B * H * pairs * hd, nbytes, PEAK_BF16_FLOPS)


def sce_bwd_bound(T: int, D: int, V: int, elt: int):
    """Least time of one score_ce_bwd call: hidden and emb read once, the
    labels, lse and gradient (4 bytes a token each), dh written; the logits
    again and G·E, 4·T·V·D operations."""
    nbytes = (2 * T * D + V * D) * elt + 3 * T * 4
    return bound(4.0 * T * V * D, nbytes, PEAK_BF16_FLOPS)


def causal_pairs(S: int, L: int, q_offset: int = 0) -> int:
    return sum(min(L, q_offset + i + 1) for i in range(S))


def fa_bwd_row(B: int, H: int, Hkv: int, S: int, L: int, hd: int, kw: dict, gen, dev) -> dict:
    """flash_attention_bwd in bf16 timed beside its plain version, SDPA's
    backward (the live keys as a boolean mask where a window or kv_len cuts
    them; built once, ``retain_graph``) and the bound over this call's live
    pairs."""
    from repro_torch.kernels.flash_attention import (_live_mask, flash_attention,
                                                     flash_attention_bwd,
                                                     flash_attention_bwd_plain)

    kw = {"causal": True, "window": 0, "q_offset": 0, "kv_len": None, **kw}
    bf = torch.bfloat16
    q, dout = (torch.randn(B, H, S, hd, generator=gen, device=dev).to(bf) for _ in range(2))
    k, v = (torch.randn(B, Hkv, L, hd, generator=gen, device=dev).to(bf) for _ in range(2))
    out, lse = flash_attention(q, k, v, return_lse=True, **kw)
    live = _live_mask(S, L, device=dev, **kw)
    pairs = int(live.sum().item())
    b_ms, b_by = fa_bwd_bound(B, H, Hkv, S, L, hd, pairs, 2)
    qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))
    plain_mask = kw["causal"] and S == L and not kw.get("window") and kw.get("kv_len") in (None, L)
    sdpa_out = F.scaled_dot_product_attention(
        qg, kg, vg, is_causal=plain_mask, attn_mask=None if plain_mask or live.all() else live,
        enable_gqa=H != Hkv)
    lib = lambda: torch.autograd.grad(sdpa_out, (qg, kg, vg), dout, retain_graph=True)  # noqa: E731
    shape = (f"B={B} H={H} Hkv={Hkv} {f'S=L={S}' if S == L else f'S={S} L={L}'} hd={hd} "
             f"{'causal' if kw['causal'] else 'not causal'}"
             + "".join(f" {k_}={kw[k_]}" for k_ in ("window", "kv_len") if kw.get(k_))
             + " bf16")
    row = {"shape": shape,
           "ms": time_ms(lambda: flash_attention_bwd(q, k, v, out, dout, lse, **kw)),
           "plain_ms": time_ms(lambda: flash_attention_bwd_plain(q, k, v, out, dout, lse, **kw),
                               reps=5),
           "library_ms": time_ms(lib), "bound_ms": b_ms, "bound_by": b_by}
    print(f"[9a] flash_attention_bwd {shape}: kernel {row['ms']:.4f} ms, plain "
          f"{row['plain_ms']:.4f} ms, library (SDPA backward"
          f"{', boolean mask' if not (plain_mask or live.all()) else ''}) "
          f"{row['library_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}, {pairs} live pairs a head)")
    return row


def phase_backward_kernels(dev: torch.device, seed: int) -> dict:
    """9a: the two backward kernels against their plain versions in bf16 and
    f32, flash_attention's forward with and without its log-sum-exp output,
    and both backward kernels' times at the tuning path's shapes."""
    from repro_torch.kernels.flash_attention import (flash_attention, flash_attention_bwd,
                                                     flash_attention_bwd_plain,
                                                     flash_attention_plain)
    from repro_torch.kernels.score_ce import (score_ce, score_ce_bwd, score_ce_bwd_plain,
                                              score_ce_plain)

    gen = torch.Generator(device=dev).manual_seed(seed + 9)
    worst = {"flash_attention_bwd": 0.0, "score_ce_bwd": 0.0, "dq_run_to_run": 0.0}
    for dtype in (torch.bfloat16, torch.float32):
        for B, H, Hkv, S, L, hd, kw in FA_BWD_CASES:
            kw = {"causal": True, **kw}
            q = torch.randn(B, H, S, hd, generator=gen, device=dev).to(dtype)
            k, v = (torch.randn(B, Hkv, L, hd, generator=gen, device=dev).to(dtype)
                    for _ in range(2))
            dout = torch.randn(B, H, S, hd, generator=gen, device=dev).to(dtype)
            out, lse = flash_attention(q, k, v, return_lse=True, **kw)
            same = flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            if not torch.equal(out, same):
                raise AssertionError(f"flash_attention {kw}: the output moved when the "
                                     "log-sum-exp was written")
            pout, plse = flash_attention_plain(q, k, v, return_lse=True, **kw)
            live = plse > -1e29                         # rows with some live column
            lse_err = check_close(f"flash_attention lse {(B, H, Hkv, S, L, hd)} {kw} {dtype}",
                                  lse[live], plse[live], TOL[dtype])
            if not (lse[~live] < -1e29).all():
                raise AssertionError("flash_attention: a row with nothing live has a finite lse")
            grads = flash_attention_bwd(q, k, v, pout, dout, plse, **kw)
            again = flash_attention_bwd(q, k, v, pout, dout, plse, **kw)
            torch.cuda.synchronize()
            refs = flash_attention_bwd_plain(q, k, v, pout, dout, plse, **kw)
            name = f"flash_attention_bwd {(B, H, Hkv, S, L, hd)} {kw} {dtype}"
            errs = [check_bwd(f"{name} {g}", a, b, dtype)
                    for g, a, b in zip(("dq", "dk", "dv"), grads, refs)]
            if not (grads[0].float().abs().sum(-1)[~live] == 0).all():
                raise AssertionError(f"{name}: a row with nothing live got a gradient")
            # bf16 sums dQ over KV tiles by atomic adds, in an order that
            # changes from run to run; dK, dV and all of f32 must not move
            dq_moved = (again[0].float() - grads[0].float()).abs().max().item()
            if not (torch.equal(again[1], grads[1]) and torch.equal(again[2], grads[2])
                    and (dtype == torch.bfloat16 or dq_moved == 0)):
                raise AssertionError(f"{name}: a gradient that should not depend on "
                                     "scheduling changed between two calls")
            worst["flash_attention_bwd"] = max(worst["flash_attention_bwd"], *errs)
            worst["dq_run_to_run"] = max(worst.get("dq_run_to_run", 0.0), dq_moved)
            print(f"[9a] flash_attention_bwd B={B} H={H} Hkv={Hkv} S={S} L={L} hd={hd} {kw} "
                  f"{dtype}: max abs err dq/dk/dv {errs[0]:.3e}/{errs[1]:.3e}/{errs[2]:.3e} "
                  f"(rtol {BWD_RTOL[dtype]}, atol {BWD_ATOL[dtype]} x max |plain|); lse "
                  f"{lse_err:.3e}; {int((~live).sum())} rows with nothing live; dq between two "
                  f"calls {dq_moved:.3e} (max |dq| {grads[0].float().abs().max().item():.3e})")
            del q, k, v, dout, out, same, pout, grads, again, refs
        for T, D, V in SCE_BWD_CASES:
            h = torch.randn(T, D, generator=gen, device=dev).to(dtype)
            e = (torch.randn(V, D, generator=gen, device=dev) * 0.05).to(dtype)
            lab = torch.randint(0, V, (T,), generator=gen, device=dev, dtype=torch.int32)
            lab[:3] = torch.tensor([0, V - 1, V - 5], device=dev, dtype=torch.int32)[:T]
            g = torch.rand(T, generator=gen, device=dev) / T
            g[1::3] = 0.0                                  # masked tokens
            nll, lse = score_ce(h, e, lab, return_lse=True)
            torch.cuda.synchronize()
            if not torch.equal(nll, score_ce(h, e, lab)):
                raise AssertionError("score_ce: the output moved when the lse was written")
            _, plse = score_ce_plain(h, e, lab, return_lse=True)
            lse_err = check_close(f"score_ce lse T={T} {dtype}", lse, plse, TOL[dtype])
            dh = score_ce_bwd(h, e, lab, plse, g)
            torch.cuda.synchronize()
            ref = score_ce_bwd_plain(h, e, lab, plse, g)
            name = f"score_ce_bwd T={T} D={D} V={V} {dtype}"
            err = check_bwd(name, dh, ref, dtype)
            if (dh[1::3] != 0).any():
                raise AssertionError(f"{name}: a masked token got a gradient")
            if not torch.equal(dh, score_ce_bwd(h, e, lab, plse, g)):
                raise AssertionError(f"{name}: the gradient changed between two calls")
            worst["score_ce_bwd"] = max(worst["score_ce_bwd"], err)
            print(f"[9a] {name}: max abs err {err:.3e} (rtol {BWD_RTOL[dtype]}, atol "
                  f"{BWD_ATOL[dtype]} x max |plain|); lse {lse_err:.3e}")
            del h, e, dh, ref
        free_card()
    print(f"[9a] bf16 flash_attention_bwd: the largest dq difference between two calls on the "
          f"same inputs, over every case: {worst['dq_run_to_run']:.3e} (dk, dv and score_ce_bwd: "
          "bitwise equal)")
    return {"worst": {k: worst[k] for k in ("flash_attention_bwd", "score_ce_bwd")},
            "dq_run_to_run": worst["dq_run_to_run"], **backward_times(dev, gen)}


def own_kernels(name: str, launched: list) -> None:
    """Fails if the bf16 backward ``name`` launched any kernel that is not one
    of its own (a library GEMM, for one)."""
    foreign = [k for k in launched if not any(own in k for own in PORT_BWD_KERNELS[name])]
    print(f"[9] {name} (bf16) launched {len(launched)} kernels, all its own: {not foreign}")
    if not launched:
        raise AssertionError(f"[9] {name}: the profiler listed no kernel for it")
    if foreign:
        raise AssertionError(f"[9a] {name}: kernels that are not its own (a library's?) ran "
                             f"inside the bf16 backward: {foreign}")


def backward_times(dev: torch.device, gen) -> dict:
    """The backward kernels' times at the tuning path's shapes (bf16), beside
    their plain versions, a PyTorch library call's backward (built once,
    ``retain_graph``, so the time is the backward's alone) and their bounds;
    and the forward kernels' times at the same shapes."""
    from repro_torch.kernels.flash_attention import (flash_attention, flash_attention_bwd,
                                                     flash_attention_bwd_plain,
                                                     flash_attention_plain)
    from repro_torch.kernels.score_ce import score_ce, score_ce_bwd, score_ce_bwd_plain

    bf = torch.bfloat16
    rows = {"flash_attention_bwd": [], "score_ce_bwd": [], "flash_attention": [],
            "score_ce": []}
    for label, (B, H, S, hd) in (("gpt2-base tuning", (8, 12, 33, 64)),
                                 ("vicuna-7b train_4k", (1, 32, 4112, 128))):
        q, k, v, dout = (torch.randn(B, H, S, hd, generator=gen, device=dev).to(bf)
                         for _ in range(4))
        out, lse = flash_attention(q, k, v, return_lse=True)
        pairs = causal_pairs(S, S)
        f_ms, f_by = bound(4.0 * B * H * pairs * hd, 4 * B * H * S * hd * 2, PEAK_BF16_FLOPS)
        fwd = {"shape": f"{label}: B={B} H={H} S=L={S} hd={hd} causal bf16",
               "ms": time_ms(lambda: flash_attention(q, k, v)),
               "lse_ms": time_ms(lambda: flash_attention(q, k, v, return_lse=True)),
               "plain_ms": time_ms(lambda: flash_attention_plain(q, k, v), reps=5),
               "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                   q, k, v, is_causal=True)), "bound_ms": f_ms, "bound_by": f_by}
        rows["flash_attention"].append(fwd)
        print(f"[9a] flash_attention (forward) {fwd['shape']}: kernel {fwd['ms']:.4f} ms "
              f"(writing the lse too {fwd['lse_ms']:.4f} ms), plain {fwd['plain_ms']:.4f} ms, "
              f"library {fwd['library_ms']:.4f} ms, bound {f_ms:.4f} ms ({f_by})")
        b_ms, b_by = fa_bwd_bound(B, H, H, S, S, hd, pairs, 2)
        qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))
        sdpa_out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
        lib = lambda: torch.autograd.grad(sdpa_out, (qg, kg, vg), dout, retain_graph=True)
        row = {"shape": f"{label}: B={B} H={H} S=L={S} hd={hd} causal bf16",
               "ms": time_ms(lambda: flash_attention_bwd(q, k, v, out, dout, lse)),
               "plain_ms": time_ms(lambda: flash_attention_bwd_plain(q, k, v, out, dout, lse),
                                   reps=5),
               "library_ms": time_ms(lib), "bound_ms": b_ms, "bound_by": b_by}
        rows["flash_attention_bwd"].append(row)
        print(f"[9a] flash_attention_bwd {row['shape']}: kernel {row['ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f} ms, library (SDPA backward) {row['library_ms']:.4f} ms, "
              f"bound {b_ms:.4f} ms ({b_by})")
        own_kernels("flash_attention_bwd", kernel_launches(
            f"[9a] flash_attention_bwd {label}, port",
            lambda: flash_attention_bwd(q, k, v, out, dout, lse)))
        kernel_launches(f"[9a] flash_attention_bwd {label}, SDPA backward", lib)
        del q, k, v, dout, out, qg, kg, vg, sdpa_out
    for label, model, (T, D, V) in (
            ("gpt2-base tuning", "gpt2-base", (136, 768, 50257)),
            ("vicuna-7b train_4k, one 512-position chunk of a one-sequence microbatch",
             "vicuna-7b", (512, 4096, 32000))):
        h = torch.randn(T, D, generator=gen, device=dev).to(bf)
        e = (torch.randn(V, D, generator=gen, device=dev) * 0.05).to(bf)
        rows["score_ce"] += score_ce_rows("[9a]", model, e, (T,), gen)
        lab = torch.randint(0, V, (T,), generator=gen, device=dev, dtype=torch.int32)
        g = torch.full((T,), 1.0 / T, device=dev)
        _, lse = score_ce(h, e, lab, return_lse=True)
        b_ms, b_by = sce_bwd_bound(T, D, V, 2)
        hg = h.detach().requires_grad_(True)
        nll = F.cross_entropy((hg @ e.T).float(), lab.long(), reduction="none")
        lib = lambda: torch.autograd.grad(nll, hg, g, retain_graph=True)
        row = {"shape": f"{label}: T={T} D={D} V={V} bf16",
               "ms": time_ms(lambda: score_ce_bwd(h, e, lab, lse, g)),
               "plain_ms": time_ms(lambda: score_ce_bwd_plain(h, e, lab, lse, g), reps=5),
               "library_ms": time_ms(lib, reps=5), "bound_ms": b_ms, "bound_by": b_by}
        rows["score_ce_bwd"].append(row)
        print(f"[9a] score_ce_bwd {row['shape']}: kernel {row['ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f} ms, library (cross_entropy backward) "
              f"{row['library_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
        own_kernels("score_ce_bwd", kernel_launches(f"[9a] score_ce_bwd {label}",
                                                     lambda: score_ce_bwd(h, e, lab, lse, g)))
        del h, e, hg, nll
    for B, H, Hkv, S, L, hd, kw in FA_BWD_NEW:
        rows["flash_attention_bwd"].append(fa_bwd_row(B, H, Hkv, S, L, hd, kw, gen, dev))
        free_card()
    return {"rows": rows}


@contextlib.contextmanager
def plain_calls(calls: dict):
    """Counts the calls of the plain versions of score_ce, flash_attention,
    rwkv6_wkv and their backwards, and of flash_decode and its combine,
    inside the block, into ``calls``: on the card's main path every one must
    stay 0."""
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.kernels import flash_decode as fd_mod
    from repro_torch.kernels import rwkv_wkv as rw_mod
    from repro_torch.kernels import score_ce as sc_mod

    names = [(sc_mod, "score_ce_plain"), (sc_mod, "score_ce_bwd_plain"),
             (fa_mod, "flash_attention_plain"), (fa_mod, "flash_attention_bwd_plain"),
             (rw_mod, "rwkv6_wkv_plain"), (rw_mod, "rwkv6_wkv_bwd_plain"),
             (fd_mod, "flash_decode_plain"), (fd_mod, "combine_partials_plain")]
    saved = {name: getattr(mod, name) for mod, name in names}

    def counting(name):
        def fn(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return saved[name](*a, **k)
        return fn

    for mod, name in names:
        calls.setdefault(name, 0)
        setattr(mod, name, counting(name))
    try:
        yield
    finally:
        for mod, name in names:
            setattr(mod, name, saved[name])


def training_kernels() -> dict:
    """Every kernel a training path may launch, by name."""
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd
    from repro_torch.kernels.rwkv_wkv import rwkv6_wkv, rwkv6_wkv_bwd
    from repro_torch.kernels.score_ce import score_ce, score_ce_bwd, score_ce_de

    return {"score_ce": score_ce, "score_ce_bwd": score_ce_bwd, "score_ce_de": score_ce_de,
            "flash_attention": flash_attention, "flash_attention_bwd": flash_attention_bwd,
            "rwkv6_wkv": rwkv6_wkv, "rwkv6_wkv_bwd": rwkv6_wkv_bwd}


# the kernels each training path must launch
ATTENTION_TUNING = ("score_ce", "score_ce_bwd", "flash_attention", "flash_attention_bwd")
RWKV_TUNING = ("score_ce", "score_ce_bwd", "rwkv6_wkv", "rwkv6_wkv_bwd")
PRETRAINING = ATTENTION_TUNING + ("score_ce_de",)


def main_path(label: str, fn, names=ATTENTION_TUNING):
    """Runs ``fn`` as a main path: the count of every kernel in ``names``
    set to 0 just before, read just after; each must be > 0 and no plain
    version called. Returns (fn's result, {kernel: launches})."""
    kernels, calls = {n: k for n, k in training_kernels().items() if n in names}, {}
    for k in kernels.values():
        k.launches = 0
    with plain_calls(calls):
        out = fn()
    torch.cuda.synchronize()
    launches = {name: k.launches for name, k in kernels.items()}
    print(f"{label}: kernel launches {launches}; plain-version calls {calls}")
    if any(n <= 0 for n in launches.values()) or any(calls.values()):
        raise AssertionError(f"{label}: a training kernel was never launched, or a plain "
                             f"version ran on the card: {launches} {calls}")
    return out, launches


def step_profile(label: str, fn, positions: int, warm: int = 2, reps: int = 5,
                 traced: int = 2) -> dict:
    """Prints per step: latency (host wall, synchronised), tokens/s over the
    step's positions, device busy, idle share and kernels (profile_calls)."""
    prof = profile_calls(label, fn, warm=warm, reps=reps, traced=traced)
    wall_ms = prof["wall_ms"]
    print(f"{label}: latency {wall_ms:.3f} ms a step, {positions / (wall_ms / 1e3):.0f} "
          f"positions/s ({positions} positions a step)")
    return prof


def synthetic_task(input_len: int = 8, target_len: int = 8):
    from repro_torch.data import make_tasks
    return make_tasks(vocab=32, partitions=4, input_len=input_len, target_len=target_len)[5]


def tune_cut_card_vs_cpu(label: str, model, task, tune_cfg, prompt0: np.ndarray,
                         seed: int, steps: int = 10, chaotic: bool = False) -> dict:
    """``steps`` Adam steps of ``model``'s 2-layer f32 cut from one prompt on
    one task's batches, on the card and on the CPU. Each step is held from
    the CPU trajectory's state (the card steps from the CPU's prompt and
    optimizer state): loss and prompt at TUNE_F32_LOSS_RTOL and
    TUNE_F32_PROMPT_TOL. The card's own trajectory is held to the CPU's at
    the same tolerances, unless ``chaotic``: then it is printed beside a
    CPU trajectory from a prompt perturbed by 1e-7 (relative), which shows
    how far f32 rounding alone carries over these steps."""
    from repro_torch.data import LoaderConfig, TaskLoader
    from repro_torch.models import prompt_from_arrays
    from repro_torch.train import OptState
    from repro_torch.tuning import PromptTuner

    card, cpu = depth_cut(cut_state(model, 2), model.device)
    loader = TaskLoader(task, LoaderConfig(batch_size=tune_cfg.batch_size, seed=seed))
    batches = [next(loader) for _ in range(steps)]

    def trajectory(m, p0):
        t = PromptTuner(m, tune_cfg)
        pp = prompt_from_arrays({"soft_prompt": p0}, m.device)
        st, out = t.init_opt(pp), []
        for b in batches:
            pp, st, loss = t.step(pp, st, b)
            out.append((float(loss), pp, st))
        return out

    def on(state, dev):
        pp, st = state
        return ({k: v.detach().to(dev).requires_grad_(True) for k, v in pp.items()},
                OptState(st.step.to(dev), {k: v.to(dev) for k, v in st.mu.items()},
                         {k: v.to(dev) for k, v in st.nu.items()}))

    ref = trajectory(cpu, prompt0)
    own = trajectory(card, prompt0)
    tuner = PromptTuner(card, tune_cfg)
    start = prompt_from_arrays({"soft_prompt": prompt0}, "cpu")
    state = (start, PromptTuner(cpu, tune_cfg).init_opt(start))
    prompt = lambda pp: pp["soft_prompt"].detach().cpu()
    worst = {"loss": 0.0, "prompt": 0.0, "own_loss": 0.0, "own_prompt": 0.0}
    for i, b in enumerate(batches):
        pp, _, loss = tuner.step(*on(state, card.device), b)
        lr_, pr, st = ref[i]
        rel_l, rel_p = abs(float(loss) - lr_) / abs(lr_), rel_gap(prompt(pp), prompt(pr))
        own_l, own_p = abs(own[i][0] - lr_) / abs(lr_), rel_gap(prompt(own[i][1]), prompt(pr))
        for k, x in (("loss", rel_l), ("prompt", rel_p), ("own_loss", own_l), ("own_prompt", own_p)):
            worst[k] = max(worst[k], x)
        print(f"{label} step {i + 1} from the CPU's state: loss card {float(loss):.6f} cpu {lr_:.6f} "
              f"(rel {rel_l:.2e}), prompt rel {rel_p:.2e}; the card's own trajectory: loss rel "
              f"{own_l:.2e}, prompt rel {own_p:.2e} (||prompt|| {pr['soft_prompt'].norm().item():.3f})")
        state = (pr, st)
    held = [("loss", TUNE_F32_LOSS_RTOL), ("prompt", TUNE_F32_PROMPT_TOL)]
    if not chaotic:
        held += [("own_loss", TUNE_F32_LOSS_RTOL), ("own_prompt", TUNE_F32_PROMPT_TOL)]
    else:
        noise = np.random.default_rng(seed + 1).standard_normal(prompt0.shape)
        witness = trajectory(cpu, (prompt0 * (1 + 1e-7 * noise)).astype(np.float32))
        gaps = [rel_gap(prompt(w[1]), prompt(r[1])) for w, r in zip(witness, ref)]
        worst["witness_prompt"] = gaps[-1]
        print(f"{label} witness: the CPU from a prompt perturbed by 1e-7 against the CPU, prompt rel "
              f"after each step {[f'{g:.2e}' for g in gaps]} (read, not held: Adam at lr "
              f"{tune_cfg.lr} on this random cut carries f32 rounding that far)")
    failed = [f"{k} {worst[k]:.2e} (tol {tol})" for k, tol in held if not worst[k] <= tol]
    if failed:
        raise AssertionError(f"{label} the 2-layer f32 cut's tuning on the card left the CPU's: "
                             f"{failed}")
    print(f"{label} 2-layer f32 cut of {model.cfg.name}, {steps} Adam steps (lr {tune_cfg.lr}, "
          f"batch {tune_cfg.batch_size}, P={tune_cfg.prompt_len}), card against CPU: each step from "
          f"the CPU's state worst loss rel {worst['loss']:.2e} (tol {TUNE_F32_LOSS_RTOL}), prompt "
          f"rel {worst['prompt']:.2e} (tol {TUNE_F32_PROMPT_TOL}); the card's own trajectory worst "
          f"loss rel {worst['own_loss']:.2e}, prompt rel {worst['own_prompt']:.2e} "
          f"({'read beside the witness' if chaotic else 'held at the same tolerances'})")
    del card, cpu
    free_card()
    return worst


def phase_tune_gpt2(dev: torch.device, seed: int) -> dict:
    """9b and 9c on gpt2-base: the 2-layer f32 cut's ten Adam steps, card
    against CPU; then PromptTuner.tune at full width."""
    from repro_torch.config import TuneConfig
    from repro_torch.configs import get_config
    from repro_torch.data import LoaderConfig, TaskLoader
    from repro_torch.models import Model, prompt_from_arrays
    from repro_torch.tuning import PromptTuner

    cfg = get_config("gpt2-base")                      # full width, bf16
    model = Model(cfg, device=dev, seed=seed)
    tune_cfg = TuneConfig()                            # P=16, batch 8, lr 0.3, eval 10, 16 samples
    task = synthetic_task()
    rng = np.random.default_rng(seed)
    d = cfg.d_model
    prompt0 = rng.normal(0, 0.5 / np.sqrt(d), (tune_cfg.prompt_len, d)).astype(np.float32)

    # 9b: ten Adam steps of the 2-layer f32 cut, card against CPU, from one state
    tune_cut_card_vs_cpu("[9b]", model, task, tune_cfg, prompt0, seed)

    # 9c: PromptTuner.tune at full width, 40 iterations, then the ITA = 0 exit
    tuner = PromptTuner(model, tune_cfg)
    print(f"[9c] {cfg.name}: {cfg.num_layers} layers, d={d}, V={cfg.vocab_size}, {cfg.dtype}, "
          f"weights from seed {seed}; task {task.task_id}; TuneConfig defaults: P="
          f"{tune_cfg.prompt_len}, batch {tune_cfg.batch_size}, lr {tune_cfg.lr}, eval every "
          f"{tune_cfg.eval_every}, {tune_cfg.eval_samples} eval samples")
    loader = TaskLoader(task, LoaderConfig(batch_size=tune_cfg.batch_size, seed=seed))
    t0 = time.perf_counter()
    res, launches = main_path("[9c] tune, 40 iterations", lambda: tuner.tune(
        loader, prompt_from_arrays({"soft_prompt": prompt0}, dev), max_iters=40))
    wall = time.perf_counter() - t0
    evals = [(it, round(l, 6), round(e, 6)) for it, l, e in res["history"]]
    print(f"[9c] 40 iterations in {wall:.3f} s ({wall / 40 * 1e3:.3f} ms an iteration with "
          f"its share of 4 evaluations); history (iteration, train loss, eval loss) {evals}")
    if res["iters"] != 40 or not all(np.isfinite([l for _, l, _ in evals] +
                                                  [e for _, _, e in evals])):
        raise AssertionError(f"[9c] tune did not run 40 finite iterations: {res}")
    first_eval = res["history"][0][2]
    target = first_eval + 1e-3 * abs(first_eval)
    again = tuner.tune(TaskLoader(task, LoaderConfig(batch_size=tune_cfg.batch_size)),
                       res["prompt"], target_loss=target, max_iters=40)
    print(f"[9c] again from the tuned prompt with target_loss {target:.6f} (above the first "
          f"evaluation, {first_eval:.6f}): iters {again['iters']}, reached {again['reached']}, "
          f"its eval {again['history'][0][2]:.6f}")
    if again["iters"] != 0 or not again["reached"]:
        raise AssertionError("[9c] a prompt that meets the target did not end tuning at "
                             "0 iterations (ITA = 0)")

    # one step, profiled
    pp = prompt_from_arrays({"soft_prompt": prompt0}, dev)
    state = {"pp": pp, "opt": tuner.init_opt(pp)}
    batch = next(loader)
    positions = batch["tokens"].size + tune_cfg.batch_size * tune_cfg.prompt_len

    def one_step():
        state["pp"], state["opt"], _ = tuner.step(state["pp"], state["opt"], batch)

    main_path("[9c] one step", one_step)
    step_profile("[9c] one PromptTuner.step, batch 8 x 33 positions", one_step, positions)
    del model, tuner
    free_card()
    return {"launches": launches}


# dE's checks (phase 9f): T, D, V. gpt2-base at T = 1, its tuning batch
# (136), 512 rows, its pretraining batch (32 rows of 17 tokens) and 8192 rows
# (four vocabulary chunks in bf16, seven in f32); vicuna-7b's D and V at 8192
# rows (two chunks in bf16, four in f32).
DE_CASES = [(1, 768, 50257), (136, 768, 50257), (512, 768, 50257), (544, 768, 50257),
            (8192, 768, 50257), (8192, 4096, 32000)]


def sce_de_bound(T: int, D: int, V: int, elt: int):
    """Least time of one score_ce_bwd call with dE: hidden and emb read once,
    dh and dE written once, the labels, lse and gradient (4 bytes a token
    each); the logits again, dh and dE: 6·T·V·D operations."""
    nbytes = 2 * (T * D + V * D) * elt + 3 * T * 4
    return bound(6.0 * T * V * D, nbytes, PEAK_BF16_FLOPS)


def phase_pretrain(dev: torch.device, seed: int) -> dict:
    """9f on gpt2-base (full width, bf16, tied): (i) dE against its plain
    version, bitwise repeatable, launching the port's kernels only, and its
    times; (ii) five joint steps of a 2-layer f32 cut, card against CPU;
    (iii) pretrain for 20 steps; (iv) a checkpoint written and read back
    bitwise; (v) the Prompt Bank built from the result and one lookup."""
    from repro_torch.config import TuneConfig
    from repro_torch.configs import get_config
    from repro_torch.core import build_bank_from_pretrain, make_score_fn
    from repro_torch.data import LoaderConfig, TaskLoader, batch_to_torch, make_tasks
    from repro_torch.kernels.score_ce import (score_ce, score_ce_bwd, score_ce_bwd_plain,
                                              score_ce_plain)
    from repro_torch.models import Model, params_from_jax, params_to_jax
    from repro_torch.train import load_checkpoint, make_pretrain_step, pretrain, save_checkpoint

    gen = torch.Generator(device=dev).manual_seed(seed + 23)
    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for T, D, V in DE_CASES:
            h = torch.randn(T, D, generator=gen, device=dev).to(dtype)
            e = (torch.randn(V, D, generator=gen, device=dev) * 0.05).to(dtype)
            lab = torch.randint(0, V, (T,), generator=gen, device=dev, dtype=torch.int32)
            lab[:3] = torch.tensor([0, V - 1, V - 5], device=dev, dtype=torch.int32)[:T]
            g = torch.rand(T, generator=gen, device=dev) / T
            g[1::3] = 0.0                                  # masked tokens
            _, lse = score_ce_plain(h, e, lab, return_lse=True)
            dh, de = score_ce_bwd(h, e, lab, lse, g, with_emb=True)
            dh2, de2 = score_ce_bwd(h, e, lab, lse, g, with_emb=True)
            torch.cuda.synchronize()
            rdh, rde = score_ce_bwd_plain(h, e, lab, lse, g, with_emb=True)
            name = f"score_ce_bwd with dE T={T} D={D} V={V} {dtype}"
            errs = (check_bwd(name + " dh", dh, rdh, dtype), check_bwd(name + " dE", de, rde, dtype))
            if not (torch.equal(dh, dh2) and torch.equal(de, de2)):
                raise AssertionError(f"{name}: the gradients changed between two calls")
            if not torch.equal(dh, score_ce_bwd(h, e, lab, lse, g)):
                raise AssertionError(f"{name}: dh moved when dE was asked for")
            if (dh[1::3] != 0).any():
                raise AssertionError(f"{name}: a masked token got a gradient")
            worst = max(worst, errs[1])
            print(f"[9f] {name}: max abs err dh {errs[0]:.3e}, dE {errs[1]:.3e} (rtol "
                  f"{BWD_RTOL[dtype]}, atol {BWD_ATOL[dtype]} x max |plain|); bitwise equal "
                  "between two calls")
            del h, e, dh, de, dh2, de2, rdh, rde
        free_card()
    cfg = get_config("gpt2-base")                      # full width, bf16, tied
    tasks = make_tasks(vocab=32, partitions=4)
    batch, P = 32, 8                                   # the reference's pretraining batch and prompt
    T, D, V = batch * (tasks[0].input_len + tasks[0].target_len + 1), cfg.d_model, cfg.vocab_size
    h = torch.randn(T, D, generator=gen, device=dev).to(torch.bfloat16)
    e = (torch.randn(V, D, generator=gen, device=dev) * 0.05).to(torch.bfloat16)
    lab = torch.randint(0, V, (T,), generator=gen, device=dev, dtype=torch.int32)
    g = torch.full((T,), 1.0 / T, device=dev)
    _, lse = score_ce(h, e, lab, return_lse=True)
    b_ms, b_by = sce_de_bound(T, D, V, 2)
    hg, eg = (t.detach().requires_grad_(True) for t in (h, e))
    nll = F.cross_entropy((hg @ eg.T).float(), lab.long(), reduction="none")
    call = lambda: score_ce_bwd(h, e, lab, lse, g, with_emb=True)
    row = {"shape": f"gpt2-base pretraining: T={T} D={D} V={V} bf16, dh and dE",
           "ms": time_ms(call), "dh_only_ms": time_ms(lambda: score_ce_bwd(h, e, lab, lse, g)),
           "plain_ms": time_ms(lambda: score_ce_bwd_plain(h, e, lab, lse, g, with_emb=True),
                               reps=5),
           "library_ms": time_ms(lambda: torch.autograd.grad(nll, eg, g, retain_graph=True),
                                 reps=5),
           "library_both_ms": time_ms(lambda: torch.autograd.grad(nll, (hg, eg), g,
                                                                  retain_graph=True), reps=5),
           "bound_ms": b_ms, "bound_by": b_by}
    print(f"[9f] score_ce_bwd {row['shape']}: kernels {row['ms']:.4f} ms (dh alone "
          f"{row['dh_only_ms']:.4f} ms), plain {row['plain_ms']:.4f} ms, library "
          f"(cross_entropy backward to E) {row['library_ms']:.4f} ms (to h and E "
          f"{row['library_both_ms']:.4f} ms), bound {b_ms:.4f} ms ({b_by})")
    own_kernels("score_ce_de", kernel_launches(f"[9f] score_ce_bwd with dE T={T}", call))
    del h, e, hg, eg, nll
    free_card()

    # (ii) five joint steps of the 2-layer f32 cut, card against CPU, from one state
    full = Model(cfg, device=dev, seed=seed)
    card, cpu = depth_cut(cut_state(full, 2), dev)
    del full
    free_card()
    rng = np.random.default_rng(seed)
    table0 = (rng.normal(size=(len(tasks), P, D)) * (0.5 / np.sqrt(D))).astype(np.float32)
    picks = [int(rng.integers(len(tasks))) for _ in range(5)]
    loaders = {ti: TaskLoader(tasks[ti], LoaderConfig(batch_size=batch, seed=seed)) for ti in picks}
    batches = [next(loaders[ti]) for ti in picks]
    traj = {}
    for name, m in (("card", card), ("cpu", cpu)):
        m.train_weights()
        step, opt = make_pretrain_step(m, len(picks))
        table = torch.from_numpy(table0).to(m.device).requires_grad_(True)
        state = opt.init({**{f"params/{n}": p for n, p in m.named_parameters()}, "prompts": table})
        traj[name] = []
        for ti, b in zip(picks, batches):
            table, state, loss = step(table, state, ti, batch_to_torch(b, m.device))
            traj[name].append((float(loss), table.detach().cpu().clone(),
                               {n: p.detach().cpu().clone() for n, p in m.named_parameters()}))
        m.train_weights(False)
    worst_loss = worst_weight = worst_bias = 0.0
    lr_sum = sum(2e-3 * min(1.0, t / len(picks)) for t in range(1, len(picks) + 1))
    for i, ((lc, tc, wc), (lr_, tr, wr)) in enumerate(zip(traj["card"], traj["cpu"])):
        rel_l = abs(lc - lr_) / abs(lr_)
        held = [n for n in wr if not n.endswith(ZERO_GRADIENT_LEAVES)]
        rel_w = max([rel_gap(tc, tr)] + [rel_gap(wc[n], wr[n]) for n in held])
        bias = max([(wc[n] - wr[n]).abs().max().item() for n in wr if n not in held] + [0.0])
        worst_loss, worst_weight = max(worst_loss, rel_l), max(worst_weight, rel_w)
        worst_bias = max(worst_bias, bias)
        print(f"[9f] joint step {i + 1} (task {picks[i]}): loss card {lc:.6f} cpu {lr_:.6f} "
              f"(rel {rel_l:.2e}); worst of the table and every weight ||card - cpu|| / ||cpu|| "
              f"{rel_w:.2e}; key biases (gradient 0) max abs diff {bias:.2e}")
    if not (worst_loss <= PRETRAIN_F32_LOSS_RTOL and worst_weight <= PRETRAIN_F32_WEIGHT_TOL
            and worst_bias <= 2 * lr_sum):
        raise AssertionError(f"[9f] the 2-layer f32 cut's pretraining on the card left the CPU's: "
                             f"loss {worst_loss:.2e} (tol {PRETRAIN_F32_LOSS_RTOL}), weights "
                             f"{worst_weight:.2e} (tol {PRETRAIN_F32_WEIGHT_TOL}), key biases "
                             f"{worst_bias:.2e} (bound {2 * lr_sum:.2e})")
    print(f"[9f] 2-layer f32 cut of {cfg.name}, 5 joint steps (batch {batch}, P={P}), card against "
          f"CPU: worst loss rel {worst_loss:.2e} (tol {PRETRAIN_F32_LOSS_RTOL}), worst weight or "
          f"table rel {worst_weight:.2e} (tol {PRETRAIN_F32_WEIGHT_TOL})")
    del card, cpu, traj
    free_card()

    # (iii) pretrain at full width, 20 steps, no cache
    steps = 20
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    pre, launches = main_path(f"[9f] pretrain, {steps} steps", lambda: pretrain(
        "gpt2-base", steps=steps, prompt_len=P, batch_size=batch, partitions=4, seed=seed,
        cache=False, device=dev, cfg=cfg), PRETRAINING)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    print(f"[9f] {cfg.name} pretrain ({cfg.num_layers} layers, d={D}, V={V}, {cfg.dtype}, tied; "
          f"{len(tasks)} tasks, batch {batch}, P={P}): {steps} steps in {wall:.3f} s "
          f"({wall / steps * 1e3:.3f} ms a step with the weights' draw); losses "
          f"{[round(l, 4) for l in pre.losses]}; max_memory_allocated {peak:.2f} GiB")
    if len(pre.losses) != steps or not np.isfinite(pre.losses).all():
        raise AssertionError(f"[9f] pretrain did not run {steps} finite steps: {pre.losses}")
    model = pre.model
    model.train_weights()
    step, opt = make_pretrain_step(model, steps)
    table = torch.from_numpy(np.stack([pre.task_prompts[t.task_id] for t in tasks])).to(dev)
    holder = {"table": table.requires_grad_(True)}
    holder["opt"] = opt.init({**{f"params/{n}": p for n, p in model.named_parameters()},
                              "prompts": holder["table"]})
    b0 = batch_to_torch(next(TaskLoader(tasks[0], LoaderConfig(batch_size=batch, seed=seed))), dev)

    def one_step():
        holder["table"], holder["opt"], _ = step(holder["table"], holder["opt"], 0, b0)

    main_path("[9f] one step", one_step, PRETRAINING)
    profile = step_profile(f"[9f] one joint pretraining step, batch {batch} x "
                           f"{P + b0['tokens'].shape[1]} positions", one_step,
                           batch * (P + b0["tokens"].shape[1]))
    model.train_weights(False)
    del holder, step, opt
    free_card()

    # (iv) a checkpoint written and read back bitwise
    path = ROOT / "build" / "chip_smoke_pretrain.npz"
    table = np.stack([pre.task_prompts[t.task_id] for t in tasks])
    save_checkpoint(str(path), {"params": params_to_jax(model.state_dict()), "prompt_table": table},
                    step=steps, meta={"llm": "gpt2-base", "tasks": [t.task_id for t in tasks]})
    tree, manifest = load_checkpoint(str(path))
    back = Model(cfg, device=dev, seed=None)
    back.load_state_dict(params_from_jax(tree["params"]))
    same = all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                back.state_dict().values()))
    if not same or not np.array_equal(tree["prompt_table"], table) or manifest["step"] != steps:
        raise AssertionError("[9f] the checkpoint did not read back bitwise")
    print(f"[9f] checkpoint {path.name}: {len(manifest['keys'])} arrays, "
          f"{path.stat().st_size / 1e6:.1f} MB, read back bitwise into a fresh model")
    del back, tree
    path.unlink()
    path.with_name(path.name + ".json").unlink()

    # (v) the Prompt Bank from the result, and one lookup through score_ce
    t0 = time.perf_counter()
    bank = build_bank_from_pretrain(pre, variants_per_prompt=2, seed=seed)
    build_s = time.perf_counter() - t0
    score_fn = make_score_fn(model, tasks[5], TuneConfig(prompt_len=P))
    before = score_ce.launches
    res = bank.lookup(score_fn)
    print(f"[9f] bank from the pretrained result: {len(bank.entries)} candidates, "
          f"{len(bank.medoid_ids)} clusters in {build_s:.3f} s; lookup for {tasks[5].task_id}: "
          f"origin={res.entry.origin} score={res.score:.6f} evaluations={res.evaluations}, "
          f"score_ce launches {score_ce.launches - before}")
    if not np.isfinite(res.score) or score_ce.launches == before:
        raise AssertionError(f"[9f] the lookup on the pretrained bank gave {res}")
    del model, pre, bank
    free_card()
    return {"row": row, "worst": worst, "launches": launches, "steps": steps, "peak_gib": peak,
            "profile": profile}


def phase_train_vicuna(dev: torch.device, seed: int) -> dict:
    """9d: make_train_step on vicuna-7b at full width at the train_4k length,
    the global batch cut to what fits, with microbatches; the first step's
    prompt gradient against f32 on a depth cut."""
    from repro_torch.config import INPUT_SHAPES, TuneConfig
    from repro_torch.configs import get_config
    from repro_torch.launch import make_train_step
    from repro_torch.models import Model, prompt_from_arrays
    from repro_torch.train import lpt_loss_chunked

    shape = INPUT_SHAPES["train_4k"]
    cfg = get_config("vicuna-7b")                      # full width, bf16
    t0 = time.perf_counter()
    model = Model(cfg, device=dev, seed=seed)
    torch.cuda.synchronize()
    weights_gb = sum(p.numel() * p.element_size() for p in model.parameters()) / 1e9
    print(f"[9d] {cfg.name}: {cfg.num_layers} layers, d={cfg.d_model}, H={cfg.num_heads}, "
          f"Hkv={cfg.kv_heads()}, hd={cfg.resolved_head_dim()}, d_ff={cfg.d_ff}, V={cfg.vocab_size}, untied, "
          f"{cfg.dtype}: {weights_gb:.2f} GB of weights drawn on the card from seed {seed} in "
          f"{time.perf_counter() - t0:.1f} s")
    tune_cfg = TuneConfig()
    P, S = tune_cfg.prompt_len, shape.seq_len
    micro, microbatches = 1, 2                         # global batch 256 cut to 2
    B = micro * microbatches
    rng = np.random.default_rng(seed)
    batches = [{"tokens": rng.integers(3, cfg.vocab_size, (B, S)).astype(np.int32),
                "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
                "mask": np.ones((B, S), np.float32)} for _ in range(3)]
    prompt0 = rng.normal(0, 0.5 / np.sqrt(cfg.d_model), (P, cfg.d_model)).astype(np.float32)
    print(f"[9d] {shape.name}: {S} tokens + P={P} = {S + P} positions a sequence "
          f"({'past' if S + P > cfg.max_seq_len else 'within'} max_seq_len {cfg.max_seq_len}; "
          f"neither package checks it); global batch "
          f"{shape.global_batch} cut to {B} = {microbatches} microbatches of {micro}")
    step, opt = make_train_step(model, tune_cfg, microbatches=microbatches)
    pp = prompt_from_arrays({"soft_prompt": prompt0}, dev)
    state = opt.init(pp)
    torch.cuda.reset_peak_memory_stats(dev)

    def run():
        cur, st, out = pp, state, []
        for b in batches:
            t = time.perf_counter()
            cur, st, loss = step(cur, st, b)
            out.append((float(loss), (time.perf_counter() - t) * 1e3))
        return cur, st, out

    (pp, state, losses), launches = main_path(f"[9d] {len(batches)} train steps, batch {B}", run)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    print(f"[9d] {len(batches)} steps (loss, ms): {[(round(l, 6), round(t, 1)) for l, t in losses]}; "
          f"max_memory_allocated {peak:.2f} GiB of "
          f"{torch.cuda.get_device_properties(dev).total_memory / 2 ** 30:.1f}")
    if not np.isfinite([l for l, _ in losses]).all() or not torch.isfinite(pp["soft_prompt"]).all():
        raise AssertionError("[9d] the train step gave a non-finite loss or prompt")
    holder = {"pp": pp, "opt": state}

    def one_step():
        holder["pp"], holder["opt"], _ = step(holder["pp"], holder["opt"], batches[0])

    step_profile(f"[9d] one make_train_step step, batch {B} x {S + P} positions",
                 one_step, B * (S + P), warm=1, reps=2, traced=1)

    # the first microbatch's prompt gradient, bf16 against f32, on a depth cut
    layers = min(4, cfg.num_layers)
    mb = {k: torch.as_tensor(v[:micro], device=dev) for k, v in batches[0].items()}
    grads = {}
    cut, cut_sd = cut_state(model, layers)
    for dtype in ("bfloat16", "float32"):
        m = Model(cut.with_overrides(dtype=dtype, param_dtype=dtype), device=dev, seed=None)
        m.load_state_dict(cut_sd)
        p = prompt_from_arrays({"soft_prompt": prompt0}, dev)["soft_prompt"]
        tot, _ = lpt_loss_chunked(m, p, mb)
        (grads[dtype],) = torch.autograd.grad(tot, p)
        del m, tot
    grad_rel = rel_gap(grads["bfloat16"], grads["float32"])
    print(f"[9d] first microbatch's prompt gradient on a {layers}-layer cut at {S + P} "
          f"positions: ||bf16 - f32|| / ||f32|| = {grad_rel:.3e} (tol {GRAD_BF16_REL_TOL})")
    if not grad_rel <= GRAD_BF16_REL_TOL:
        raise AssertionError("[9d] the bf16 prompt gradient disagrees with f32")
    del model, cut_sd, grads
    free_card()
    return {"launches": launches, "batch": B}


def kernel_lines(worst: dict, rows: dict, launches: dict, serve: dict, rwkv: dict,
                 mla: dict, mla_serve: dict, bwd: dict, tune: dict, train: dict,
                 pre: dict, service: dict, hybrid: dict, dense: dict, shapes: dict,
                 timed: dict, encdec: dict, vlm: dict) -> list:
    """One entry per kernel for the {"kernels": [...]} line: its numbers at
    the first shape of the paths that launch it (the other shapes under
    "shapes"), and its launches on those paths' runs, in all and by path
    and shape."""
    replaces = {"score_ce": "src/repro/kernels/score_ce.py:101",
                "flash_attention": "src/repro/kernels/flash_attention.py:109",
                "flash_decode": "src/repro/kernels/flash_decode.py:157",
                "rwkv6_wkv": "src/repro/kernels/rwkv_wkv.py:94",
                "mla_decode": "src/repro/kernels/mla_decode.py:133",
                # no TPU kernel: the reference differentiates lpt_loss through XLA
                "score_ce_bwd": "src/repro/train/objectives.py:80",
                "flash_attention_bwd": "src/repro/train/objectives.py:80",
                # ... its chunked WKV scan, and pretraining's loss to the weights
                "rwkv6_wkv_bwd": "src/repro/models/ssm.py:87",
                "score_ce_de": "src/repro/train/pretrain.py:127"}
    sources = {"score_ce": "score_ce", "flash_attention": "flash_attention",
               "flash_decode": "flash_decode", "rwkv6_wkv": "rwkv_wkv",
               "mla_decode": "mla_decode", "score_ce_bwd": "score_ce",
               "flash_attention_bwd": "flash_attention_bwd", "rwkv6_wkv_bwd": "rwkv_wkv_bwd",
               "score_ce_de": "score_ce"}
    rtune = rwkv["tune"]
    worst = {**worst, "mla_decode": mla["worst"], **bwd["worst"], "rwkv6_wkv_bwd": rtune["worst"],
             "score_ce_de": pre["worst"]}
    for name, err in encdec["worst"].items():
        worst[name] = max(worst[name], err)
    worst["flash_attention"] = max(worst["flash_attention"], vlm["held_err"])
    worst["flash_decode"] = max(worst["flash_decode"], vlm["decode_row"]["err"],
                                vlm["decode_row"]["held_err"])
    worst["flash_attention_bwd"] = max(worst["flash_attention_bwd"], hybrid["bwd_held"],
                                       encdec["tune"]["held"])
    path = lambda model, counts: {f"{model}, {k}": n for k, n in counts.items()}
    rwkv_tune = f"rwkv6-7b, tune ({rtune['iters']} iterations, 1 evaluation)"
    pretraining = f"gpt2-base, pretrain ({pre['steps']} steps)"
    etune = encdec["tune"]
    tuning = lambda name: {
        k: n for k, n in (("gpt2-base, tune (40 iterations, 4 evaluations)",
                           tune["launches"].get(name)),
                          (f"vicuna-7b, train_4k (3 steps, batch {train['batch']})",
                           train["launches"].get(name)),
                          (rwkv_tune, rtune["launches"].get(name)),
                          (pretraining, pre["launches"].get(name)),
                          (f"zamba2-7b, PromptTuner.step ({hybrid['tune_steps']} steps, batch 8)",
                           hybrid["tune_launches"].get(name)),
                          (f"seamless-m4t-medium, train_4k ({etune['steps']} steps, batch "
                           f"{ENCDEC_TRAIN_BATCH})", etune["launches"].get(name)),
                          (f"seamless-m4t-medium, PromptTuner.step ({etune['tune_steps']} steps, "
                           "batch 8)", etune["tune_launches"].get(name))) if n is not None}
    svc = lambda name: service["by_label"].get(name, {})
    prefill = shapes["prefill"]
    prefill_path = f"qwen2-7b, prefill_32k (1 step, batch {PREFILL_BATCH})"
    family = lambda name: {k: n for arch, r in dense.items()
                           for k, n in path(arch, r["by_shape"][name]).items()}
    paths = {  # name -> (rows at the paths' shapes, launches by path and shape)
        "score_ce": (rows["score_ce"] + rwkv["score_rows"] + mla_serve["score_rows"]
                     + hybrid["score_rows"]
                     + [r for arch in dense.values() for r in arch["score_rows"]]
                     + timed["score_ce"] + encdec["score_rows"] + vlm["score_rows"]
                     + bwd["rows"]["score_ce"],
                     {**path("gpt2-base", launches["by_shape"]["score_ce"]),
                      **path("rwkv6-7b", rwkv["by_shape"]["score_ce"]),
                      **path("deepseek-v2-236b", mla_serve["score_ce_by_shape"]),
                      **path("zamba2-7b", hybrid["by_shape"]["score_ce"]),
                      **family("score_ce"), prefill_path: prefill["launches"]["score_ce"],
                      **path("seamless-m4t-medium", encdec["by_shape"]["score_ce"]),
                      **path("paligemma-3b", vlm["by_shape"]["score_ce"]),
                      **tuning("score_ce"), **svc("score_ce")}),
        "flash_attention": (rows["flash_attention"] + hybrid["fa_rows"] + [shapes["fa_row"]]
                            + timed["flash_attention"] + encdec["fa_rows"]
                            + bwd["rows"]["flash_attention"],
                            {**path("gpt2-base", launches["by_shape"]["flash_attention"]),
                             **path("zamba2-7b", hybrid["by_shape"]["flash_attention"]),
                             **family("flash_attention"),
                             **path("seamless-m4t-medium",
                                    encdec["by_shape"]["flash_attention"]),
                             **path("paligemma-3b", vlm["by_shape"]["flash_attention"]),
                             prefill_path: prefill["launches"]["flash_attention"],
                             **tuning("flash_attention"), **svc("flash_attention")}),
        "score_ce_bwd": (bwd["rows"]["score_ce_bwd"],
                         {**tuning("score_ce_bwd"), **svc("score_ce_bwd")}),
        "flash_attention_bwd": (bwd["rows"]["flash_attention_bwd"],
                                {**tuning("flash_attention_bwd"),
                                 **svc("flash_attention_bwd")}),
        "flash_decode": ([serve, hybrid["decode_row"]] + encdec["decode_rows"]
                         + [vlm["decode_row"]] + timed["flash_decode"],
                         {"qwen2-7b, serve steps": serve["launches"],
                          "zamba2-7b, serve steps": hybrid["decode_row"]["launches"],
                          "seamless-m4t-medium, serve steps (self and cross)":
                              encdec["decode_launches"],
                          f"paligemma-3b, serve steps (batch {VLM_SERVE_BATCH})":
                              vlm["decode_row"]["launches"]}),
        "rwkv6_wkv": (rwkv["rows"], {**path("rwkv6-7b", rwkv["by_shape"]["rwkv6_wkv"]),
                                     **tuning("rwkv6_wkv")}),
        "rwkv6_wkv_bwd": (rtune["rows"], tuning("rwkv6_wkv_bwd")),
        "score_ce_de": ([pre["row"]], tuning("score_ce_de")),
        "mla_decode": (mla["rows"], {"deepseek-v2-236b, serve steps": mla_serve["launches"]}),
    }
    keys = ("shape", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    return [{"name": name, "route": "cuda",
             "source": f"src/repro_torch/kernels/csrc/{sources[name]}.cu",
             "replaces": replaces[name],
             **({"counterpart": "none: the reference differentiates through XLA"}
                if name.endswith(("_bwd", "_de")) else {}),
             **({"dq_run_to_run": bwd["dq_run_to_run"]} if name == "flash_attention_bwd" else {}),
             "launches": sum(by_shape.values()),
             "launches_by_shape": by_shape, "max_abs_err": worst[name],
             **{k: rs[0][k] for k in keys}, "shapes": [{k: r[k] for k in keys} for r in rs[1:]]}
            for name, (rs, by_shape) in paths.items()]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device is available")
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False     # f32 references stay f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    card = phase_build()
    worst, timed = phase_kernels(dev, args.seed)
    model, bank, results, launches = phase_slice(dev, args.seed)
    ref_cpu = phase_rescore(model, bank, results, args.seed)
    rows = phase_times(model, args.seed)
    phase_profile(model, bank, results)
    service = phase_service(model, bank, ref_cpu, card, args.seed)
    del model, bank, results, ref_cpu
    free_card()
    serve = phase_serve(dev, args.seed)
    rwkv = phase_rwkv(dev, args.seed)
    free_card()
    bwd = phase_backward_kernels(dev, args.seed)
    tune = phase_tune_gpt2(dev, args.seed)
    pre = phase_pretrain(dev, args.seed)
    train = phase_train_vicuna(dev, args.seed)
    free_card()
    mla = phase_mla_kernel(dev, args.seed)
    mla_serve = phase_mla_serve(dev, args.seed)
    free_card()
    hybrid = phase_hybrid(dev, args.seed)
    free_card()
    dense = phase_dense(dev, args.seed)
    shapes = phase_long_shapes(dev, args.seed)
    free_card()
    encdec = phase_encdec(dev, args.seed)
    free_card()
    vlm = phase_vlm(dev, args.seed)

    kernels = kernel_lines(worst, rows, launches, serve, rwkv, mla, mla_serve, bwd, tune, train,
                           pre, service, hybrid, dense, shapes, timed, encdec, vlm)
    print(f"[done] {time.perf_counter() - t_start:.1f} s on {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
