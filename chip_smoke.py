"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's paths on the card -- LM training (`repro_torch.launch.
train` on smollm-360m at its full config: kernel K3 and its backward,
K3-bwd), the nested co-design search,
`CodesignEngine(config).run(MODEL_LAYERS["resnet"])` (kernel K1b, the cost
model's whole forward in one launch; K1 beside it), with speculation and the
prune gate, the paper's baselines, the co-design service and the process
executor; and LM serving, `repro_torch.launch.serve` on smollm-360m at its
full config, its smoke config and stablelm-12b (kernel K3; K2 on its own
entry point `kernels.ops.matmul`); and every other block kind and family
of the LM stack: MoE serving (moonshot-v1-16b-a3b at its full published
config, llama4-maverick's interleaved top-1), RG-LRU with local attention
(recurrentgemma-9b), mLSTM/sLSTM (xlstm-1.3b), the VLM's embedding inputs
with M-RoPE (qwen2-vl-72b), the encoder-decoder (seamless-m4t-large-v2) and
MoE training -- phase by phase, one JSON line per phase, each with the
seconds since the script started (`t_s`):

  1. nvidia_smi   the card's name and power limit (`nvidia-smi`)
  2. build        every CUDA kernel built from `src/repro_torch/csrc` (one
                  nvcc per source, started together), with the build seconds
                  and each kernel function's registers, static shared memory
                  and spill bytes from ptxas (`-Xptxas -v`), beside the
                  dynamic shared memory the K2 wrapper asks for at the
                  path's shapes and K3's and K3-bwd's libraries launch with
                  (which must equal `smem_bytes` and `bwd_smem_bytes`), and
                  K4's at its caps
  3. kernel       each kernel against its plain PyTorch version on the card,
                  with max error against its bar; per-call times of the
                  kernel's wrapper and of the plain version (CUDA events
                  around one call, warmed, median of 30: what a caller pays,
                  host overhead included); their device times and the
                  library call's (CUDA events around 10-200 back-to-back
                  calls, the kernel's captured in one CUDA graph so that
                  no host gap is left between them: what the card spends;
                  the others eager, so a call shorter than its host time
                  reads high); the kernel's device launches a
                  call and the device time of one torch.profiler session of
                  10 calls (`profiler_ms`, the method of earlier runs; null
                  where the session lost events, reported in a
                  `profiler_lost_event` line; a session with no device time
                  is retried, reported in a `profiler_retry` line, and the
                  run fails after five); the library call is one PyTorch
                  call computing the same function; the bound.
                  K1 (edp_reduce): float64 and float32 at the main path's
                  row counts and a ragged one, operands from real candidate
                  pools.  K1b (cost_forward): the same pools packed as the
                  forward receives them (256-row buckets of 150 rows, so
                  with padding rows), masks and inf positions exact; beside
                  it the unfused forward (prep and features in PyTorch
                  around one K1 launch) and each one's device launches a
                  call.  K3 (flash_attention): the reference sweep's shapes,
                  the serve prefill shapes (B 8, S 1024 and 1088, H 15,
                  KV 5, hd 64) and serve_parity's (B 2, S 64 and 128),
                  the shapes K3 takes through its wrapper's padding (hd 20
                  and 160 at S 100, stablelm-12b's prefill at S 1024 and hd
                  160, Sq < Sk), bf16 and f32, library
                  `scaled_dot_product_attention`; each call must launch K3
                  once;
                  bf16 is held both to the plain version and, tighter, to
                  `flash_attention_rounded_ref` (the kernels' roundings).
                  K2 (tiled_matmul): the reference sweep's shapes and the
                  serve projections at M = 8 x 1088, bf16 and f32, library
                  `torch.matmul` (TF32 off).  K2 and K3 lines name the
                  design that ran for their dtype (`path`: bf16 "wgmma_tma"
                  for K2 and "mma_sync" for K3; f32 "simt_8x8" for K2 and
                  "simt_4x8" for K3), K2's with its blocks, K3's with its
                  kernel function's registers and spill bytes (ptxas).
                  K3-bwd (flash_attention_bwd): the train shape (B 8, S
                  1024, H 15, KV 5, hd 64), train_parity's (B 2, S 128),
                  hd 20 at S 100 and hd 160 at S 1024, bf16 and f32,
                  against its plain version on K3's own output and lse
                  (K3 with the lse store bit-equal to K3 without it), a
                  second call bit-equal to the first, library the backward
                  of `scaled_dot_product_attention`, with its design
                  (`path`: bf16 "mma_sync", f32 "simt_4x8"), its device
                  launches a call (3) and its dK/dV and dQ kernels'
                  registers and spill bytes.
                  K4 (gp_fit): the GP's 80-step Adam fit of a stack at
                  4 x 64 x 14 (Woodbury form), 4 x 32 x 14 (Cholesky) and
                  8 x 16 x 11 (SE), against its algorithm in plain PyTorch
                  (`tests/gp_fit_reference.py`) on the same operands and
                  against the eager autograd fit (`measure_gp_fit` gives the
                  bars), library none.
  4. main_path    the co-design search at ResNet's full width (the paper's
                  four layers at their real dims, pool 150, 168 PEs; trial
                  counts cut from the paper's 250/30 and 50/5): wall time,
                  best log10 EDP, the forwards and K1b's launches (one each,
                  and none of K1), the row counts; then the same config on
                  the CPU, whose design, outer history and best log10 EDP
                  must be the card's
  5. profile      one lockstep inner search under torch.profiler: device
                  kernel time by name, launches, forwards and the device's
                  idle share
  6. serve        smollm-360m at full config (32 layers, bf16 compute, bf16
                  KV cache), 16 requests in batches of 8, prompt 1024, 64
                  generated tokens: wall s, tok/s, prefill and decode-step ms,
                  K3's launches (2 batches x 2 prefills x 32 layers), first
                  tokens, peak memory, and the roofline of a prefill and of
                  a decode step (`models/flops.py`) with its share of the
                  measured time
  7. prefill_vs_naive  the first batch's prefill once through K3 and once
                  with attn_impl="naive": max abs logit difference (bf16 bar
                  5e-2 of the largest logit) and argmax agreement
  8. serve_profile  one S_max prefill and 8 decode steps of the served
                  model under torch.profiler: wall and device ms, launches,
                  idle share, K3's device ms, top kernels
  9. matmul_path  K2 through `kernels.ops.matmul` on the serve projections
                  of layer 0 (the first batch's hidden states), in bf16 and
                  in f32: launches and agreement with `torch.matmul`
 10. serve_parity smollm-360m at full width, 2 layers, f32 compute and
                  cache, served on the card and on the CPU from one seed:
                  the tokens must be equal, and the card's run must launch
                  K3's f32 kernel once a prefill layer (2 batches x 2
                  prefills x 2 layers)
 11. serve_hd160  stablelm-12b at full width (hd 160), 2 layers, served on
                  the card in bf16 and in f32: K3's hd 160 instances launched
                  once a prefill layer, valid tokens
 12. serve_smoke  `serve --arch smollm-360m --smoke` (hd 20) on the card in
                  bf16; in f32 compute and cache on the card and on the CPU,
                  whose tokens must be equal; an f32 prefill of 100 tokens,
                  card against CPU
 13. prune_speculative  the search of phase 4 with strategy="speculative",
                  prune="safe", an outer GP refit every 4 trials and the
                  bound prior mean (the vectorized bounds), on the
                  card and on the CPU: the same design hash, outer history
                  and best log10 EDP; `edp_lower_bounds_device` called on the
                  card; speculation and pruning stats; whether the design is
                  phase 4's (information only)
 14. baselines    random search, the TVM-style search and relax-and-round BO
                  on ResNet's first layer, card against CPU: the same points,
                  best mapping and history; K1b launches
 15. service      `CodesignService` (fused dispatch, a design store) with
                  three concurrent requests -- the resnet paper set, the
                  llama4-maverick zoo set, a resnet+dqn portfolio -- each
                  equal to its standalone run on the card; a second pass on
                  the warm store runs no inner search
 16. executor     the speculative ResNet search through 2 spawned worker
                  processes on the card, equal to the inline run; each
                  worker booted without jax, repro or a CUDA context and
                  launched K1b; the device memory a worker adds
 17. train        `repro_torch.launch.train.main` on smollm-360m at its
                  full config (32 layers, bf16 compute over f32 masters,
                  block remat), batch 8, seq 1024, 30 steps, one save at
                  the end into a temporary directory: first and last loss
                  (the last below the first), median step ms and tokens/s,
                  K3's and K3-bwd's launches a step (64 and 32), K2's (0),
                  peak memory, the save's seconds, restarts (0), and the
                  share of `models/flops.py`'s expected hardware FLOPs at
                  the bf16 peak
 18. train_profile  one such step under torch.profiler: wall and device
                  ms, launches, idle share, K3's and K3-bwd's device ms
                  (K3-bwd's also by kernel function), top kernels
 19. train_parity smollm-360m at full width, 2 layers, f32, batch 2, seq
                  128, 5 steps on the card and on the CPU: losses and grad
                  norms within `TRAIN_BARS`; K3 and K3-bwd f32 launched
 20. train_resume the same width, 2 layers, bf16, 12 steps saving every 5,
                  with an InjectedFault at step 8: one restart, from step
                  5, and the replay bit-equal to an uninterrupted run
 21. serve_moe    moonshot-v1-16b-a3b at its full published config (48
                  layers, 64 experts top-6, vocab 163,840: 27.7B parameters,
                  drawn on the card), bf16, 16 requests in batches of 8,
                  prompt 1024, 64 generated: wall s, tok/s, prefill and
                  decode-step ms, peak memory, K3's launches (192: 2 batches
                  x 2 prefills x 48 layers), the MoE paths' calls (gathered
                  in every prefill layer, masked in every decode layer) and
                  the experts over capacity
 22. serve_moe_profile  one S_max prefill and 8 decode steps of it under
                  torch.profiler (as serve_profile)
 23. serve_moe_parity  its full width, 2 layers, f32, prompt 600 (T 1280:
                  gathered prefills, masked decode), on the card and the
                  CPU: equal tokens
 24. serve_llama4 llama4-maverick at full width, one ("attn", "moe")
                  period (2 of 48 layers), bf16, 8 requests, prompt 1024:
                  K3 in both layers, an expert over capacity in prefill
 25. serve_hybrid recurrentgemma-9b at its full config (38 layers), prompt
                  2560, 64 generated (the rolling window cache wraps), no
                  K3; serve_hybrid_parity: (rglru, rglru, local_attn) at
                  full width with the window cut to 256, card against CPU
                  in f32 over a prefill of 320 and 8 decode steps (logits,
                  states, rolling caches)
 26. serve_xlstm  xlstm-1.3b at its full config (48 layers), prompt 1024,
                  256 generated, no K3, every sLSTM layer's prefill and
                  decode steps one call of the registered op
                  `repro_torch::slstm_scan` (calls counted in a
                  `serve_xlstm_op` line); one sLSTM step's device launches
                  and time
 27. families     qwen2-vl-72b at full width, 1 of 80 layers (int8 KV cache,
                  embeddings, M-RoPE positions) and seamless-m4t-large-v2 at
                  its full config: prefill, 8 decode steps, loss and
                  backward finite, K3 and K3-bwd launches; each at 2 layers
                  in f32, card against CPU
 28. train_moe    moonshot at full width, 2 layers, f32 masters, bf16
                  compute, block remat, batch 8 x seq 1024, 10 steps: the
                  loss falls; steps 1-3 repeated bit-equal; the MoE block's
                  two calls bit-equal, forward and backward
 29. train_moe_profile  one such step under torch.profiler
 30. sharded_train  the train phase's first 5 steps again (smollm-360m at
                  its full config, bf16, batch 8 x 1024, same seed and
                  data) through the sharding layer: parameters, optimizer
                  state and batch as DTensors on a (1, 1) ("data",
                  "model") NCCL mesh, FSDP on, every `act` and the mesh
                  branches of the embedding, the cross-entropy and the
                  attention taken (the MLP has no split to make on one
                  rank): losses within 1e-5 relative of the train phase's,
                  K3's and K3-bwd's launches a step equal to its (64 and 32)
 31. sharded_moe  moonshot at full width, 2 layers, f32, on a (1, 1) mesh
                  on the card (NCCL) and on the CPU (gloo), from one draw:
                  the expert-parallel shard-map branch on 1 x 1024 tokens
                  within 1e-5 of its largest output plus one bf16 ulp (the
                  reference's bf16 combine), two card calls bit-equal; a
                  prefill through both layers takes the branch in each and
                  launches K3 f32
 32. dryrun       `python -m repro_torch.launch.dryrun` in runner processes
                  of their own, started after the kernel lines and read at
                  the end (they run on the host's CPU beside the card's
                  phases): smollm-360m x 4 shapes and moonshot-v1-16b-a3b x
                  train_4k in one runner, xlstm-1.3b x train_4k and x
                  prefill_32k (the sLSTM one op a layer; counts from depths
                  1 and 2) in one each, on the fake 16 x 16 mesh -- memory
                  GiB a device, fits_hbm, the roofline terms, the bound, the
                  MFU estimate, trace seconds
 33. autotune     `python -m repro_torch.core.autotune` the same way: smollm-
                  360m x train_4k, 6 trials with 3 warm-up, GP on the card:
                  the best TuneConfig, its estimated step time, the wall
 34. slstm_op     the registered sLSTM op pair (`repro_torch::slstm_scan`,
                  `repro_torch::slstm_scan_bwd`) at xlstm-1.3b's full width
                  (B 8, S 1024, H 4, dh 512, f32): forward bit-equal to the
                  plain loop and to a second call, backward within 1e-6 of
                  autograd through the loop in f64 (the f32 loop's own
                  distance beside it); device ms, call ms and launches of
                  one forward and one backward call
 35. train_xlstm  xlstm-1.3b at full width, one of its six periods (7 mLSTM,
                  1 sLSTM), bf16 compute over f32 masters, block remat,
                  batch 8 x seq 1024, 5 steps: the last loss below the
                  first, its first 2 steps repeated bit-equal, the sLSTM
                  op's calls (2 forwards, 1 backward a step), median step
                  ms, peak
                  memory; one step profiled (`train_xlstm_profile`: device
                  ms, launches, idle share); card against CPU in f32 at
                  batch 1 x seq 128 (mLSTM chunk 128), losses within 1e-4
 36. kernels      one line listing every ported kernel with its numbers

Phase 34 runs right after phase 3, and phases 21-29 and 35 after it, while
the card's memory is clean (serve_moe holds ~62 GB).

and ends with `{"ok": true, "device": {...}}` as its last line.  Any failure
raises with its traceback and a nonzero exit.  Exits nonzero, printing no
result, without a CUDA device or outside a checkout of the repository.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
MODELS = ("resnet", "dqn", "mlp", "transformer")
ROW_COUNTS = (256, 1024, 3072, 8192, 1000)
EDP_OPERANDS = ("fo", "relo", "tiles", "sp", "consts")
# NVIDIA H100 SXM data sheet (dense, at the 700 W limit): HBM3 bandwidth and
# the peak rates outside the tensor cores for the kernel's operand types.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float64: 34e12, torch.float32: 67e12}
BARS = {torch.float64: 1e-12, torch.float32: 1e-6}
EDP_SOURCE = "src/repro_torch/csrc/edp_reduce.cu"
EDP_REPLACES = "src/repro/kernels/edp_reduce.py:136"
GP_FIT_SOURCE = "src/repro_torch/csrc/gp_fit.cu"
GP_FIT_REPLACES = "src/repro/core/gp.py:134"
# K4's kernel lines, (runs, rows a run, features, kind, noisy): the inner
# lockstep's largest stack bucket (Woodbury form) and one below the switch
# (Cholesky form), pinned noise as the inner search fits them; the
# classifiers' SE fit over hardware features.
GP_FIT_SHAPES = ((4, 64, 14, "linear", False), (4, 32, 14, "linear", False),
                 (8, 16, 11, "se", True))
# K4 against its algorithm and the eager fit (see `measure_gp_fit`):
# hyperparameters a share of each key's largest value; posteriors relative
# to their scale, as tests/test_torch_gp.py's ILL_BAR.
GP_FIT_PARAM_BAR = 1e-9
GP_FIT_ULP_ROOM = 100.0
GP_FIT_ILL_BAR = 1e-4
FORWARD_OPERANDS = ("factors", "order_gb", "order_dram", "hwv", "layv")
FORWARD_KEYS = ("energy_pj", "delay_cycles", "edp", "utility", "features")
# Operations of K1b's prep, features and utility a row, beyond the
# reduction's (`edp_work`), a compare, divide or logarithm counted as one:
# local-buffer tiles 13, cumulative factors and global-buffer tiles 31,
# validity 34, spatial factors 21, features 15, utility 2.
FORWARD_ROW_FLOPS = 116
# Peaks for the LM kernels' operand types (the same data sheet): the bf16
# dense tensor-core rate, and float32 outside the tensor cores (both kernels
# and their references compute f32 in true FP32, never TF32).
LM_PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# (atol, rtol): |kernel - plain| <= atol + rtol * |plain|.  f32 as in
# tests/test_kernels.py.  bf16 is about one bf16 ulp of the output (at most
# 2^-7 relative) plus the spread that rounding p at the running max instead
# of the row's max adds: 5e-3 against the plain version, which does not
# round p, and 2e-3 against flash_attention_rounded_ref, which does.
ATTN_BARS = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (5e-3, 1e-2)}
ATTN_ROUNDED_BAR = (2e-3, 1e-2)
# The bf16 prefill's logits, K3 against attn_impl="naive" (which rounds the
# scores to bf16 before the softmax): a share of the largest logit.
PREFILL_BAR = 5e-2
LM_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# (B, S, H, KV, hd) or (B, Sq, H, KV, hd, Sk): tests/test_kernels.py's sweep,
# the serve prefills (the discarded one on the padded prompt, S 1024, and
# S_max 1088), serve_parity's two prefills (S 64 and S_max 128), where K3 f32
# runs; then the shapes K3 takes through its wrapper's padding: smollm-360m's
# smoke head dim 20 at S 100, stablelm-12b's hd 160 at S 100 and at its
# prefill shape (S 1024, the serve_hd160 phase's), and Sq < Sk.
ATTN_SHAPES = ((2, 64, 4, 2, 16), (1, 128, 8, 2, 32), (2, 64, 4, 4, 8),
               (1, 128, 4, 1, 64), (8, 1024, 15, 5, 64), (8, 1088, 15, 5, 64),
               (2, 64, 15, 5, 64), (2, 128, 15, 5, 64),
               (1, 100, 3, 1, 20), (2, 100, 32, 8, 160), (1, 1024, 32, 8, 160),
               (2, 100, 15, 5, 64, 192), (8, 1088, 16, 16, 128),
               (8, 1088, 40, 8, 128))
ATTN_SERVE = (8, 1088, 15, 5, 64)
ATTN_HD160 = (1, 1024, 32, 8, 160)
# moonshot-v1-16b-a3b's prefill (serve_moe, hd 128); llama4's g 5 at S 1088
ATTN_MOE = (8, 1088, 16, 16, 128)
# (M, K, N): tests/test_kernels.py's sweep, then the serve projections of
# smollm-360m at M = 8 x 1088 (wq/wo, wk/wv, the MLP's up and down).
MATMUL_SHAPES = ((128, 256, 128), (256, 128, 384), (64, 512, 256),
                 (128, 128, 128), (8704, 960, 960), (8704, 960, 320),
                 (8704, 960, 5120), (8704, 2560, 960))
MATMUL_SERVE = (8704, 960, 5120)
# K3-bwd (B, S, H, KV, hd): the train shape (smollm-360m, batch 8, seq
# 1024), train_parity's (batch 2, seq 128), the smoke config's hd 20 at
# S 100 (padded to S 128, hd 32) and stablelm-12b's hd 160 at S 1024.
BWD_SHAPES = ((8, 1024, 15, 5, 64), (2, 128, 15, 5, 64), (2, 100, 3, 1, 20),
              (1, 1024, 32, 8, 160), (8, 1024, 16, 16, 128))
BWD_TRAIN = (8, 1024, 15, 5, 64)
# train_moe's shape: moonshot's heads (hd 128), batch 8, seq 1024
BWD_MOE = (8, 1024, 16, 16, 128)
# K3-bwd against its plain version, |kernel - plain| <= share * max|plain| +
# rtol * |plain| per gradient: f32 1e-4 and 1e-4 (the f32 sums run in other
# orders); bf16 2^-7 and 0, one bf16 ulp at the gradient's scale (both round
# the same f32 sums once to bf16).  K3's lse within 1e-4 of the plain one.
BWD_BARS = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2.0 ** -7, 0.0)}
LSE_BAR = 1e-4
BWD_SOURCE = "src/repro_torch/csrc/flash_attention_bwd.cu"
# No TPU kernel: the reference differentiates flash_sdpa by autodiff.
BWD_REPLACES = "src/repro/models/layers.py:163"
# K3-bwd's kernel functions by dtype, as the profiler and ptxas name them:
# D, then dK/dV and dQ of the dtype's design.
K3_BWD_KERNELS = {torch.bfloat16: ("flash_bwd_delta_kernel",
                                   "flash_bwd_dkdv_mma_kernel",
                                   "flash_bwd_dq_mma_kernel"),
                  torch.float32: ("flash_bwd_delta_kernel",
                                  "flash_bwd_dkdv_simt_kernel",
                                  "flash_bwd_dq_simt_kernel")}
# Training: smollm-360m at its full config, batch 8, seq 1024, 30 steps, one
# save at the end; train_parity at full width, 2 layers, f32, card and CPU;
# train_resume at full width, 2 layers, bf16, a fault at step 8.
TRAIN_ARGV = ("--arch", "smollm-360m", "--steps", "30", "--batch", "8",
              "--seq", "1024", "--lr", "3e-4", "--seed", "0",
              "--log-every", "10", "--save-every", "50")
TRAIN_PARITY_ARGV = ("--arch", "smollm-360m", "--steps", "5", "--batch", "2",
                     "--seq", "128", "--seed", "0", "--save-every", "50")
TRAIN_RESUME_ARGV = ("--arch", "smollm-360m", "--steps", "12", "--batch",
                     "8", "--seq", "1024", "--seed", "0", "--save-every", "5")
TRAIN_RESUME_FAULT = 8
# Card against CPU over whole f32 steps: tests/test_torch_train.py's bars
# for the port against the reference (losses 1e-4 relative, grad norms
# 1e-3).
TRAIN_BARS = {"loss": 1e-4, "grad_norm": 1e-3}
ATTN_SOURCE = "src/repro_torch/csrc/flash_attention.cu"
ATTN_REPLACES = "src/repro/kernels/flash_attention.py:65"
MATMUL_SOURCE = "src/repro_torch/csrc/tiled_matmul.cu"
MATMUL_REPLACES = "src/repro/kernels/tiled_matmul.py:58"
# K3's kernel functions by dtype (bf16 tensor cores, f32 CUDA cores), as the
# profiler and ptxas name them.
K3_KERNELS = {torch.bfloat16: "flash_mma_kernel",
              torch.float32: "flash_simt_kernel"}
SERVE_ARGV = ("--arch", "smollm-360m", "--requests", "16", "--batch", "8",
              "--prompt-len", "1024", "--gen-len", "64", "--seed", "0")
PARITY_ARGV = ("--arch", "smollm-360m", "--requests", "4", "--batch", "2",
               "--prompt-len", "64", "--gen-len", "8", "--seed", "0")
SMOKE_ARGV = ("--arch", "smollm-360m", "--smoke", "--requests", "4",
              "--batch", "2", "--seed", "0")
# stablelm-12b at full width (hd 160), depth cut to 2 layers: one request,
# prompt 1000 and 24 generated (S_max 1024), in bf16 and in f32.
HD160_ARGV = ("--arch", "stablelm-12b", "--requests", "1", "--batch", "1",
              "--prompt-len", "1000", "--gen-len", "24", "--seed", "0")
HD160_LAYERS = 2
# The LM stack's other block kinds and families.  serve_moe is moonshot at
# its full published config (48 layers, 64 experts top-6, 27.7B parameters,
# drawn on the card); serve_moe_parity its full width at 2 layers in f32,
# prompt 600 (T = 2 x 640 > 512: the gathered path in prefill, the masked
# one in decode); llama4 at full width, one ("attn", "moe") period of its
# 48 layers (394B parameters do not fit one card); recurrentgemma at its
# full config, prompt 2560 (S_max 2624 > the 2048 window: the rolling cache
# wraps); xlstm at its full config, prompt 1024 and 256 generated (the
# mLSTM chunk of 256 divides P 1024 and S_max 1280).
MOE_ARGV = ("--arch", "moonshot-v1-16b-a3b", "--requests", "16", "--batch",
            "8", "--prompt-len", "1024", "--gen-len", "64", "--seed", "0")
MOE_PARITY_ARGV = ("--arch", "moonshot-v1-16b-a3b", "--requests", "2",
                   "--batch", "2", "--prompt-len", "600", "--gen-len", "8",
                   "--seed", "0")
MOE_PARITY_LAYERS = 2
LLAMA4_ARGV = ("--arch", "llama4-maverick-400b-a17b", "--requests", "8",
               "--batch", "8", "--prompt-len", "1024", "--gen-len", "16",
               "--seed", "0")
LLAMA4_LAYERS = 2
HYBRID_ARGV = ("--arch", "recurrentgemma-9b", "--requests", "8", "--batch",
               "8", "--prompt-len", "2560", "--gen-len", "64", "--seed", "0")
# recurrentgemma card against CPU in f32: (rglru, rglru, local_attn) at full
# width, the window cut from 2048 to 256, a prompt of 320 (the rolling cache
# holds 64..319) and 8 decode steps that overwrite its oldest slots
HYBRID_PARITY = {"window": 256, "B": 2, "S": 320, "steps": 8}
XLSTM_ARGV = ("--arch", "xlstm-1.3b", "--requests", "8", "--batch", "8",
              "--prompt-len", "1024", "--gen-len", "256", "--seed", "0")
# The card against the CPU in f32 on the new paths: the CPU tests' bar for
# the port against the reference (1e-5 of the largest value).
FAMILY_BAR = 1e-5
TRAIN_MOE_ARGV = ("--arch", "moonshot-v1-16b-a3b", "--steps", "10",
                  "--batch", "8", "--seq", "1024", "--lr", "3e-4",
                  "--seed", "0")
TRAIN_MOE_LAYERS = 2
TRAIN_MOE_REPEAT = 3
# The sharding layer on one card: the train phase's first steps on a (1, 1)
# mesh (losses 1e-5 relative to the train phase's), and moonshot's shard-map
# branch, card against CPU (1e-5 of its largest output, plus one bf16 ulp
# of each element for the reference's bf16 combine).
SHARDED_TRAIN_STEPS = 5
SHARDED_TRAIN_BAR = 1e-5
SHARDED_MOE_LAYERS = 2
SHARDED_MOE_TOKENS = (1, 1024)
SHARDED_MOE_BAR = 1e-5
# Dry-run cells (fake 16 x 16 mesh) and the autotuner's budget.
# The dry-run's cells, each group in a runner process of its own (the xlstm
# cells trace for minutes on a CPU core: the mLSTM's chunk loop).
DRYRUN_GROUPS = ((("smollm-360m", "train_4k"), ("smollm-360m", "prefill_32k"),
                  ("smollm-360m", "decode_32k"), ("smollm-360m", "long_500k"),
                  ("moonshot-v1-16b-a3b", "train_4k")),
                 (("xlstm-1.3b", "train_4k"),),
                 (("xlstm-1.3b", "prefill_32k"),))
DRYRUN_CELLS = tuple(c for group in DRYRUN_GROUPS for c in group)
# The sLSTM op at xlstm-1.3b's full width (B, S, H, dh), f32; its backward
# against autograd through the loop in f64 within 1e-6 of the largest
# gradient.
SLSTM_OP_SHAPE = (8, 1024, 4, 512)
SLSTM_GRAD_BAR = 1e-6
# xlstm-1.3b trained at full width, one of its six periods (7 mLSTM and 1
# sLSTM layer), batch 8 x seq 1024, the train phase's precision and remat;
# card against CPU in f32 at batch 1 x seq 128 (the mLSTM chunk cut to 128,
# which must divide the sequence) within TRAIN_BARS["loss"].
TRAIN_XLSTM_ARGV = ("--arch", "xlstm-1.3b", "--steps", "5", "--batch", "8",
                    "--seq", "1024", "--seed", "0", "--save-every", "50")
TRAIN_XLSTM_PARITY_ARGV = ("--arch", "xlstm-1.3b", "--steps", "2", "--batch",
                           "1", "--seq", "128", "--seed", "0",
                           "--save-every", "50")
TRAIN_XLSTM_PERIODS = 1
TRAIN_XLSTM_REPEAT = 2
AUTOTUNE_ARGV = ("--arch", "smollm-360m", "--shape", "train_4k",
                 "--trials", "6", "--warmup", "3")


START = time.perf_counter()
# One process serves and trains models from 1 to 62 GB in turn: segments
# that grow keep the allocator from fragmenting between them.  Set before
# the first CUDA allocation.
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")


def emit(**record) -> None:
    """One JSON line; a phase's line also gives the seconds since the script
    started (`t_s`), so the run's time can be read phase by phase."""
    if "phase" in record:
        record["t_s"] = time.perf_counter() - START
    print(json.dumps(record), flush=True)


def matmul_bar(dtype, k: int) -> tuple[float, float]:
    """(atol, rtol) of K2 against its plain version.  f32 as in
    tests/test_kernels.py; bf16 one bf16 ulp of the output (at most 2^-7
    relative) plus what the f32 sums' different orders move near zero."""
    if dtype == torch.bfloat16:
        return 1e-3, 1e-2
    return 1e-4 * k ** 0.5, 1e-4


def beyond_rtol(out: torch.Tensor, ref: torch.Tensor, rtol: float) -> float:
    """max(|out - ref| - rtol * |ref|): the error the bar's atol must cover."""
    ref = ref.float()
    return float(((out.float() - ref).abs() - rtol * ref.abs()).max())


def cuda_ms(fn, reps: int = 30, warmup: int = 5) -> float:
    """Median milliseconds of one call of `fn`, timed by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, graph: bool = True) -> float:
    """Milliseconds one call of `fn` keeps the card busy: CUDA events
    around back-to-back calls (as many as fill about 20 ms, 10 to 200,
    after a warm-up).  With `graph` (the kernels' own calls) the calls are
    captured in one CUDA graph and the events bracket one replay of it, so
    no host gap is left between them -- the way to time a kernel of a few
    microseconds, whose wrapper's host time exceeds it; a capture that
    fails falls back to the eager calls, reported in a `timing_fallback`
    line.  Without it (the plain versions and library calls: captures of
    their gigabytes of temporaries left the card too little for the large
    models' phases) the host issues the next call while the card runs the
    last, so only calls shorter than their host time read high."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
    start.record()
    fn()
    end.record()
    end.synchronize()
    reps = int(min(200, max(10, 20.0 / max(start.elapsed_time(end), 1e-3))))
    if graph:
        try:
            g = torch.cuda.CUDAGraph()
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                fn()
            torch.cuda.current_stream().wait_stream(side)
            with torch.cuda.graph(g, capture_error_mode="thread_local"):
                for _ in range(reps):
                    fn()
            g.replay()
            torch.cuda.synchronize()
            start.record()
            g.replay()
            end.record()
            end.synchronize()
            del g
            torch.cuda.empty_cache()
            return start.elapsed_time(end) / reps
        except RuntimeError as e:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            emit(phase="timing_fallback", reps=reps,
                 error=str(e).splitlines()[0][:200],
                 note="the calls could not be captured in a CUDA graph: "
                      "timed eagerly, host gaps included")
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _activities(device_only: bool) -> list:
    """The profiler's activities: the device's alone for sessions of tens
    of thousands of launches (the host's op events are most of a session's
    cost to record and sum), else the host's too."""
    from torch.profiler import ProfilerActivity

    return ([ProfilerActivity.CUDA] if device_only else
            [ProfilerActivity.CPU, ProfilerActivity.CUDA])


def launch_profile(fn, reps: int = 10,
                   device_only: bool = False) -> tuple[int, float | None]:
    """Device launches (kernels and copies) of one call of `fn`, from one
    torch.profiler session over `reps` calls, and that session's device
    milliseconds a call (each device function's mean duration times its
    launches a call; None where the session lost events).  A function's
    launches a call are its count over `reps` rounded up, so a session
    that lost a few events still counts whole launches; it is reported in
    a `profiler_lost_event` line.  A session that recorded no device time
    is reported in a `profiler_retry` line and run again (with the host's
    activity too, where `device_only` asked for the device's alone), up to
    five times, and then the run fails."""
    from torch.profiler import profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(1, 6):
        with profile(activities=_activities(device_only
                                            and attempt == 1)) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and e.count]
        per_call = [-(-e.count // reps) for e in events]
        us = sum(e.self_device_time_total / e.count * n
                 for e, n in zip(events, per_call))
        if us > 0:
            off = {e.key[:80]: e.count for e, n in zip(events, per_call)
                   if e.count != n * reps}
            if off:
                emit(phase="profiler_lost_event", reps=reps, counts=off)
            return sum(per_call), None if off else us / 1e3
        emit(phase="profiler_retry", attempt=attempt, reps=reps,
             note="the profiler recorded no device time for this session")
        time.sleep(1.0)
    raise AssertionError("the profiler recorded no device time in five "
                         "sessions")


@functools.lru_cache(maxsize=None)
def candidate_pools(n_rows: int):
    """Candidate pools of the four workloads' layers on Eyeriss, one 150-row
    pool per run and a 256-row bucket each, enough runs for `n_rows`
    (sampled once for K1's and K1b's records)."""
    from repro_torch.timeloop import MODEL_LAYERS, eyeriss_168
    from repro_torch.timeloop import batch as tlb

    hw = eyeriss_168()
    rng = np.random.default_rng(0)
    layers = [ly for m in MODELS for ly in MODEL_LAYERS[m]]
    runs = [layers[k % len(layers)] for k in range(-(-n_rows // 256))]
    return hw, [tlb.sample_valid_pool(rng, hw, ly, 150) for ly in runs], runs


def edp_operands(n_rows: int, dtype: str):
    """The operands the cost model's reduction receives for
    `candidate_pools(n_rows)`, cut to `n_rows`."""
    from repro_torch.timeloop import batch_torch as ttlb

    ops = ttlb.reduce_operands(*candidate_pools(n_rows), dtype, device="cuda")
    return [ops[k][:n_rows].contiguous() for k in EDP_OPERANDS]


def forward_operands(n_rows: int, dtype: str):
    """The operands `cost_forward` receives for `candidate_pools(n_rows)`,
    cut to `n_rows`."""
    from repro_torch.timeloop import batch_torch as ttlb

    ops = ttlb.forward_operands(*candidate_pools(n_rows), dtype, device="cuda")
    return [ops[k][:n_rows].contiguous() for k in FORWARD_OPERANDS]


def edp_work(ops) -> tuple[int, int]:
    """(bytes, operations) the reduction needs on these operands: each input
    read once and each output written once; the multiplies of the trip and
    pass products this data needs plus the fixed per-row arithmetic (63
    flops: accumulation, energy, delay, EDP)."""
    fo, relo = ops[0], ops[1]
    n = fo.shape[0]
    item = fo.element_size()
    n_values = sum(int(x[0].numel()) for x in ops) + 3 + 6
    pos = torch.arange(6, device=fo.device)
    flops = 63 * n
    for li in range(2):
        f = fo[:, li]
        for ti in range(3):
            rel = relo[:, li, ti] > 0.5
            active = rel & (f > 1.0)
            inner = torch.where(active, pos, -1).amax(dim=1)
            inc = (rel | (pos < inner[:, None])).sum(dim=1)
            flops += int(torch.where(active.any(dim=1), inc - 1, 0).sum())
        rel = relo[:, li, 2] > 0.5
        anchor = torch.where(rel & (f > 1.0), pos, 6).amin(dim=1)
        inc = ((~rel) & (pos < anchor[:, None])).sum(dim=1)
        flops += int((inc - 1).clamp(min=0).sum()) + 2 * n
    return n * n_values * item, flops


def phase_nvidia_smi() -> dict:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(out, flush=True)
    emit(phase="nvidia_smi", card=out)
    return {"card": out}


def phase_build() -> None:
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import (HEAD_DIMS,
                                                     built_bwd_smem_bytes,
                                                     built_smem_bytes,
                                                     bwd_smem_bytes)
    from repro_torch.kernels.flash_attention import smem_bytes as k3_smem
    from repro_torch.kernels.tiled_matmul import default_blocks
    from repro_torch.kernels.tiled_matmul import smem_bytes as k2_smem

    seconds = build.build_all()
    bf16, f32 = torch.bfloat16, torch.float32
    # K3's sizes come from the library; the wrapper's layout, which the CPU
    # tests read, must agree with them.
    k3 = {}
    for name, dt in (("bf16", bf16), ("f32", f32)):
        for hd in HEAD_DIMS:
            k3[f"{name} hd {hd}"] = built = built_smem_bytes(hd, dt)
            if k3_smem(hd, dt) != built:
                raise AssertionError(
                    f"flash_attention.smem_bytes({hd}, {name}) is "
                    f"{k3_smem(hd, dt)}; the library launches with {built}")
    k3_bwd = {}
    for name, dt in (("bf16", bf16), ("f32", f32)):
        for hd in HEAD_DIMS:
            for part, dq in (("dkdv", False), ("dq", True)):
                k3_bwd[f"{name} {part} hd {hd}"] = built = \
                    built_bwd_smem_bytes(hd, dq, dt)
                if bwd_smem_bytes(hd, dq, dt) != built:
                    raise AssertionError(
                        f"flash_attention.bwd_smem_bytes({hd}, {dq}, {name})"
                        f" is {bwd_smem_bytes(hd, dq, dt)}; the library "
                        f"launches with {built}")
    dynamic = {
        "tiled_matmul": {
            f"{name} {bm}x{bk}x{bn}": k2_smem(bm, bk, bn, dt)
            for name, dt in (("bf16", bf16), ("f32", f32))
            for bm, bk, bn in sorted({
                tuple(min(b, d) for b, d in zip(default_blocks(n, dt, m),
                                                (m, k, n)))
                for m, k, n in MATMUL_SHAPES})},
        "flash_attention": k3, "flash_attention_bwd": k3_bwd,
        "gp_fit": gp_fit_smem()}
    emit(phase="build", seconds=seconds,
         libraries=[str(build.library_path(k).relative_to(ROOT))
                    for k in build.KERNELS],
         ptxas={k: build.ptxas_report(k) for k in build.KERNELS},
         dynamic_smem_bytes=dynamic)


def gp_fit_smem() -> dict:
    """K4's shared memory a CTA at its caps, as the library launches it
    (raising past an SM's 227 KB)."""
    from repro_torch.kernels.gp_fit import (FORMS, MAX_D, MAX_ROWS,
                                            built_smem_bytes)

    out = {}
    for (kind, lowrank), form in FORMS.items():
        rows = MAX_ROWS["woodbury" if lowrank else "cholesky"]
        built = built_smem_bytes(form, rows, MAX_D)
        if built > 227 * 1024:
            raise AssertionError(f"gp_fit form {form} at {rows} rows takes "
                                 f"{built} B of shared memory")
        out[f"{kind} {'woodbury' if lowrank else 'cholesky'} {rows} rows"] = \
            built
    return out


def measure_edp(n: int, dtype_name: str) -> dict:
    """edp_reduce against its plain version on `n` rows: errors (raising
    past the bar), kernel and plain times, and the bound."""
    from repro_torch.kernels.edp_reduce import edp_reduce, reduce_edp_terms

    ops = edp_operands(n, dtype_name)
    dtype = ops[0].dtype
    ev, trips = edp_reduce(*ops)
    torch.cuda.synchronize()
    ev_p, trips_p = reduce_edp_terms(*ops)
    max_abs = max(float((ev - ev_p).abs().max()),
                  float((trips - trips_p).abs().max()))
    max_rel = float(((ev - ev_p).abs() / ev_p.abs()).max())
    if not max_rel <= BARS[dtype]:
        raise AssertionError(
            f"edp_reduce disagrees with its plain version at {n} rows "
            f"{dtype_name}: max relative error {max_rel}")
    if dtype == torch.float64 and not torch.equal(trips, trips_p):
        raise AssertionError("edp_reduce trips differ in float64")
    n_bytes, flops = edp_work(ops)
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    rec = {"rows": n, "dtype": dtype_name, "max_abs_err": max_abs,
           "max_rel_err": max_rel,
           **_kernel_ms(lambda: edp_reduce(*ops)),
           "plain_ms": device_ms(lambda: reduce_edp_terms(*ops), False),
           "call_ms": cuda_ms(lambda: edp_reduce(*ops)),
           "plain_call_ms": cuda_ms(lambda: reduce_edp_terms(*ops)),
           "bytes": n_bytes, "flops": flops, "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    emit(phase="kernel", name="edp_reduce", **rec)
    return rec


def forward_work(ops) -> tuple[int, int]:
    """(bytes, operations) K1b's forward needs on these operands: each input
    read once and each output written once; `FORWARD_ROW_FLOPS` a row plus
    the reduction's operations on the operands `prep` gives it."""
    from repro_torch.kernels.cost_forward import H_EMAC, prep

    factors, hwv = ops[0], ops[3]
    n = factors.shape[0]
    item = factors.element_size()
    n_in = sum(int(x[0].numel()) * x.element_size() for x in ops)
    n_out = 1 + (4 + 14) * item
    _, fo, relo, tl, spv, _, _ = prep(*ops)
    _, flops = edp_work([fo, relo, tl, spv, hwv[:, H_EMAC:]])
    return n * (n_in + n_out), flops + FORWARD_ROW_FLOPS * n


def measure_cost_forward(n: int, dtype_name: str) -> dict:
    """cost_forward against its plain version on `n` rows (masks and inf
    positions exact, values within the dtype's bar, raising past it), its
    times and launches a call beside the unfused forward's, and the bound."""
    from repro_torch.kernels.cost_forward import cost_forward, cost_forward_ref
    from repro_torch.kernels.edp_reduce import edp_reduce

    ops = forward_operands(n, dtype_name)
    dtype = ops[0].dtype
    got = cost_forward(*ops)
    torch.cuda.synchronize()
    want = cost_forward_ref(*ops)
    max_abs = max_rel = 0.0
    exact = torch.equal(got["valid"], want["valid"])
    for key in FORWARD_KEYS:
        g, w = got[key], want[key]
        exact &= torch.equal(torch.isinf(g), torch.isinf(w))
        exact &= torch.equal(g[torch.isinf(g)], w[torch.isinf(w)])
        fin = torch.isfinite(w)
        err = (g[fin] - w[fin]).abs()
        max_abs = max(max_abs, float(err.max()))
        max_rel = max(max_rel, float((err / w[fin].abs().clamp(
            min=torch.finfo(dtype).tiny)).max()))
    if not (exact and max_rel <= BARS[dtype]):
        raise AssertionError(
            f"cost_forward disagrees with its plain version at {n} rows "
            f"{dtype_name}: masks exact {exact}, max relative error {max_rel}")

    def unfused():
        return cost_forward_ref(*ops, reduce=edp_reduce)

    unfused_launches, unfused_profiler_ms = launch_profile(unfused)
    n_bytes, flops = forward_work(ops)
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    rec = {"rows": n, "dtype": dtype_name,
           "valid_rows": int(want["valid"].sum()), "masks_exact": exact,
           "max_abs_err": max_abs, "max_rel_err": max_rel,
           **_kernel_ms(lambda: cost_forward(*ops)),
           "plain_ms": device_ms(lambda: cost_forward_ref(*ops), False),
           "unfused_ms": device_ms(unfused, False),
           "unfused_profiler_ms": unfused_profiler_ms,
           "unfused_launches_per_call": unfused_launches,
           "call_ms": cuda_ms(lambda: cost_forward(*ops)),
           "plain_call_ms": cuda_ms(lambda: cost_forward_ref(*ops)),
           "unfused_call_ms": cuda_ms(unfused),
           "bytes": n_bytes, "flops": flops, "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    emit(phase="kernel", name="cost_forward", **rec)
    return rec


def phase_kernel() -> dict:
    return {(name, dt, n): measure(n, dt)
            for name, measure in (("edp_reduce", measure_edp),
                                  ("cost_forward", measure_cost_forward))
            for dt in ("float64", "float32") for n in ROW_COUNTS}


def gp_fit_operands(runs: int, rows: int, d: int, kind: str, noisy: bool):
    """(params, X, y, mask, lowrank, pool) of a stack of `runs` fits of
    `rows` rows each as `GPStack.fit` hands them to the fit, on the card:
    the cost model's features and utilities of sampled mappings (linear), or
    uniform hardware features and +/-1 labels (SE); `pool`, 50 more points a
    run to hold the posteriors at."""
    from repro_torch.core import gp
    from repro_torch.timeloop import MODEL_LAYERS, eyeriss_168
    from repro_torch.timeloop import batch as tlb

    rng = np.random.default_rng(rows)
    Xs, ys = [], []
    for k in range(runs):
        if kind == "linear":
            hw, layer = eyeriss_168(), MODEL_LAYERS["resnet"][k % 4]
            pool = tlb.sample_valid_pool(rng, hw, layer, rows)
            Xs.append(tlb.features_batch(pool, hw, layer)[:, :d])
            ys.append(-np.log10(tlb.evaluate_batch(hw, pool, layer)["edp"]))
        else:
            Xs.append(rng.uniform(size=(rows, d)))
            ys.append(np.where(Xs[-1][:, 0] > 0.5, 1.0, -1.0))
    pools = []
    for k in range(runs):
        if kind == "linear":
            hw, layer = eyeriss_168(), MODEL_LAYERS["resnet"][k % 4]
            pool = tlb.sample_valid_pool(rng, hw, layer, 50)
            pools.append(tlb.features_batch(pool, hw, layer)[:, :d])
        else:
            pools.append(rng.uniform(size=(50, d)))
    X, y, mask = gp._to("cuda", *gp._pad_runs(Xs, ys))
    params = gp._init_params(kind, runs, d, "cuda")
    params["mean_const"] = torch.tensor([float(v.mean()) for v in ys],
                                        dtype=torch.float64, device="cuda")
    params["log_tau"] = torch.tensor(
        [np.log(max(v.std(), 1e-3) * 0.1) for v in ys] if noisy
        else [-6.0] * runs, dtype=torch.float64, device="cuda")
    pool = torch.as_tensor(np.stack(pools), dtype=torch.float64,
                           device="cuda")
    return (params, X, y, mask, gp._stack_lowrank(kind, X.shape[1]), pool)


def _gp_fit_rel(got: dict, want: dict) -> float:
    """Largest hyperparameter difference, a share of each key's largest
    value."""
    return max(float((got[k] - want[k]).abs().max() / want[k].abs().max())
               for k in want)


def measure_gp_fit(shape) -> dict:
    """K4 against its algorithm and against the eager autograd fit it
    replaces, on one stack (80 Adam steps), raising past each bar; K4's
    device ms and launches a fit beside the eager fit's, ptxas's registers
    and spills, and its shared memory.

    Bars: K4's hyperparameters within `GP_FIT_PARAM_BAR` of its algorithm's
    (`tests/gp_fit_reference.py`, run on the same CUDA operands), or, where
    a change of one ulp in X moves the algorithm's own fit by more (the
    pinned-noise fits above the kernel's rank), within `GP_FIT_ULP_ROOM`
    times that move; within `GP_FIT_PARAM_BAR` of the eager fit's where
    that one-ulp move is under the bar (the SE fit); posteriors over a pool
    within `GP_FIT_ILL_BAR` of the eager fit's and the algorithm's
    (relative to the posterior's scale; variances to its square)."""
    from repro_torch.core import gp
    from repro_torch.kernels import build
    from repro_torch.kernels.gp_fit import (FORMS, MAX_D, MAX_ROWS, gp_fit,
                                            built_smem_bytes)

    sys.path.insert(0, str(ROOT / "tests"))
    from gp_fit_reference import gp_fit_ref

    runs, rows, d, kind, noisy = shape
    params, X, y, mask, lowrank, pool = gp_fit_operands(*shape)

    def kernel():
        return gp_fit(params, X, y, mask, kind, 80, train_tau=noisy,
                      lowrank=lowrank, rows=rows)

    def eager():
        return gp._fit(params, X, y, mask, kind, 80, 0.05, noisy,
                       lowrank=lowrank)

    def algorithm(x):
        return gp_fit_ref(params, x, y, mask, kind, 80, 0.05, noisy, lowrank)

    got, want, alg = kernel(), eager(), algorithm(X)
    g = torch.Generator(device="cuda").manual_seed(rows)
    ulp = max(_gp_fit_rel(algorithm(X * (1 + 2.0 ** -52 * torch.randint(
        -1, 2, X.shape, generator=g, device="cuda", dtype=X.dtype))), alg)
        for _ in range(2))
    torch.cuda.synchronize()
    if not all(bool(torch.isfinite(v).all()) for v in got.values()):
        raise AssertionError(f"gp_fit gave a non-finite fit at {shape}")
    vs_alg, vs_eager = _gp_fit_rel(got, alg), _gp_fit_rel(got, want)
    alg_bar = max(GP_FIT_PARAM_BAR, GP_FIT_ULP_ROOM * ulp)
    post = {}
    for name, other in (("eager", want), ("algorithm", alg)):
        mu, var = gp._posterior(got, X, y, mask, pool, kind)
        mu_o, var_o = gp._posterior(other, X, y, mask, pool, kind)
        scale = torch.maximum(mu_o.abs().amax(dim=1),
                              var_o.clamp(min=0).sqrt().amax(dim=1))
        post[name] = max(
            float(((mu - mu_o).abs().amax(dim=1) / scale).max()),
            float(((var - var_o).abs().amax(dim=1) / scale ** 2).max()))
    faults = []
    if vs_alg > alg_bar:
        faults.append(f"hyperparameters {vs_alg:.3g} from its algorithm's "
                      f"(bar {alg_bar:.3g})")
    if ulp <= GP_FIT_PARAM_BAR and vs_eager > GP_FIT_PARAM_BAR:
        faults.append(f"hyperparameters {vs_eager:.3g} from the eager fit's")
    faults += [f"posterior {v:.3g} from the {n} fit's" for n, v in
               post.items() if not v <= GP_FIT_ILL_BAR]
    if faults:
        raise AssertionError(f"gp_fit at {shape}: " + "; ".join(faults))
    form = FORMS[kind, lowrank]
    eager_launches, _ = launch_profile(eager, reps=2, device_only=True)
    rec = {"shape": [runs, rows, d], "kind": kind, "noisy": noisy,
           "form": "woodbury" if lowrank else "cholesky", "steps": 80,
           "dtype": "float64", "max_rel_param_diff_vs_algorithm": vs_alg,
           "param_bar_vs_algorithm": alg_bar,
           "algorithm_one_ulp_move": ulp,
           "max_rel_param_diff_vs_eager": vs_eager,
           "max_rel_posterior_diff": post,
           **_kernel_ms(kernel),
           "plain_ms": device_ms(eager, False),
           "plain_launches_per_call": eager_launches,
           "call_ms": cuda_ms(kernel),
           "plain_call_ms": cuda_ms(eager, reps=5, warmup=1),
           "ptxas": build.ptxas_function("gp_fit", "gp_fit_kernel", form),
           "dynamic_smem_bytes": built_smem_bytes(form, rows, d),
           "caps": {"rows": MAX_ROWS, "d": MAX_D}}
    emit(phase="kernel", name="gp_fit", **rec)
    return rec


def phase_gp_fit() -> dict:
    return {shape: measure_gp_fit(shape) for shape in GP_FIT_SHAPES}


def _randn(shape, dtype, seed: int) -> torch.Tensor:
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(shape, generator=g, device="cuda").to(dtype)


def _kernel_ms(kernel) -> dict:
    """A kernel line's device time ("ms": `device_ms`) and its launches a
    call with the device time one profiler session read ("profiler_ms",
    the method of PR 20's and earlier runs; `launch_profile`)."""
    launches, profiler_ms = launch_profile(kernel)
    return {"ms": device_ms(kernel), "profiler_ms": profiler_ms,
            "launches_per_call": launches}


def _timings(kernel, plain, library) -> dict:
    return {**_kernel_ms(kernel), "plain_ms": device_ms(plain, False),
            "library_ms": device_ms(library, False),
            "call_ms": cuda_ms(kernel),
            "plain_call_ms": cuda_ms(plain)}


def _bound(n_bytes: int, flops: float, dtype) -> dict:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / LM_PEAK_FLOPS[dtype] * 1e3
    return {"bytes": n_bytes, "flops": flops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def k3_ptxas(dtype, hd: int) -> dict:
    """Registers and spill bytes of K3's kernel function for `dtype` at head
    dim `hd`, from ptxas's report of the build."""
    from repro_torch.kernels import build

    found = build.ptxas_function("flash_attention", K3_KERNELS[dtype], hd)
    return {"function": f"{K3_KERNELS[dtype]}<{hd}>",
            "registers": found["registers"],
            "spill_bytes": found["spill_store_bytes"]
            + found["spill_load_bytes"]}


def measure_attention(shape, dtype_name: str) -> dict:
    """flash_attention against flash_attention_ref on random inputs (raising
    past the bar), its times, SDPA's time, the bound and the kernel
    function's registers and spills."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from repro_torch.kernels.flash_attention import PATHS, flash_attention
    from repro_torch.kernels.ref import (flash_attention_ref,
                                         flash_attention_rounded_ref)

    from repro_torch.kernels.flash_attention import padded_shape

    B, S, H, KV, hd = shape[:5]
    Sk = shape[5] if len(shape) > 5 else S
    dtype = LM_DTYPES[dtype_name]
    q = _randn((B, S, H, hd), dtype, 1)
    k = _randn((B, Sk, KV, hd), dtype, 2)
    v = _randn((B, Sk, KV, hd), dtype, 3)
    before = flash_attention.launches
    out = flash_attention(q, k, v)
    torch.cuda.synchronize()
    if flash_attention.launches != before + 1:
        raise AssertionError(f"flash_attention did not launch its kernel "
                             f"once at {shape} {dtype_name}")
    ref = flash_attention_ref(q, k, v).float()
    err = (out.float() - ref).abs()
    atol, rtol = ATTN_BARS[dtype]
    checks = {"plain": (ref, atol, rtol)}
    if dtype == torch.bfloat16:
        checks["rounded"] = (flash_attention_rounded_ref(q, k, v),
                             *ATTN_ROUNDED_BAR)
    held = {}
    for what, (want, a, r) in checks.items():
        beyond = beyond_rtol(out, want, r)
        held[what] = {"max_abs_err": float((out.float() - want.float())
                                           .abs().max()),
                      "max_err_beyond_rtol": beyond, "atol": a, "rtol": r}
        if not beyond <= a:
            raise AssertionError(f"flash_attention disagrees with the {what} "
                                 f"version at {shape} {dtype_name}: {held[what]}")
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

    def library():
        return sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)

    lib_err = float((library().transpose(1, 2).float() - ref).abs().max())
    # causal (query, key) pairs per head: query i sees keys 0..min(i, Sk-1)
    pairs = sum(min(i + 1, Sk) for i in range(S))
    flops = 4 * B * H * hd * pairs     # QK^T and PV, 2 flops a product
    padded = padded_shape(S, Sk, hd)
    rec = {"shape": dict(zip(("B", "S", "H", "KV", "hd", "Sk"),
                             (B, S, H, KV, hd, Sk))),
           "dtype": dtype_name, "path": PATHS[dtype],
           "padded": dict(zip(("Sq", "Sk", "hd"), padded)),
           "ptxas": k3_ptxas(dtype, padded[2]),
           "max_abs_err": float(err.max()), "bar": held,
           "library_max_abs_err": lib_err,
           **_timings(lambda: flash_attention(q, k, v),
                      lambda: flash_attention_ref(q, k, v), library),
           **_bound((2 * q.numel() + 2 * k.numel()) * q.element_size(), flops,
                    dtype)}
    emit(phase="kernel", name="flash_attention", **rec)
    return rec


def bwd_ptxas(dtype, hd: int) -> dict:
    """Registers and spill bytes of K3-bwd's dK/dV and dQ kernel functions
    for `dtype` at head dim `hd`, from ptxas's report of the build."""
    from repro_torch.kernels import build

    out = {}
    for fn in K3_BWD_KERNELS[dtype][1:]:
        found = build.ptxas_function("flash_attention_bwd", fn, hd)
        out[f"{fn}<{hd}>"] = {
            "registers": found["registers"],
            "spill_bytes": found["spill_store_bytes"]
            + found["spill_load_bytes"]}
    return out


def measure_attention_bwd(shape, dtype_name: str) -> dict:
    """K3-bwd against flash_attention_bwd_ref on K3's own output and lse for
    random q, k, v and dO (raising past `BWD_BARS`); a second call
    bit-equal to the first; K3 with the lse store bit-equal to K3 without
    it and its lse within `LSE_BAR`; the kernel's
    times and device launches a call, the plain version's and the backward
    of scaled_dot_product_attention (device time of the backward only); the
    bound (five causal products at the dtype's peak, or the bytes)."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from repro_torch.kernels.flash_attention import (PATHS_BWD,
                                                     _launch_forward,
                                                     flash_attention_bwd,
                                                     flash_attention_fwd,
                                                     pad_operands,
                                                     padded_shape)
    from repro_torch.kernels.ref import (flash_attention_bwd_ref,
                                         flash_attention_lse_ref)

    B, S, H, KV, hd = shape
    dtype = LM_DTYPES[dtype_name]
    q = _randn((B, S, H, hd), dtype, 6)
    k = _randn((B, S, KV, hd), dtype, 7)
    v = _randn((B, S, KV, hd), dtype, 8)
    do = _randn((B, S, H, hd), dtype, 9)
    # The padded problem the autograd function hands the kernels: padded dO
    # rows are zero, as the pad's backward gives them.
    qp, kp, vp = pad_operands(q, k, v)
    dop = pad_operands(do, k, v)[0]
    scale = hd ** -0.5
    out, lse = flash_attention_fwd(qp, kp, vp, scale=scale, sk_valid=S)
    served, _ = _launch_forward(qp, kp, vp, scale, S)
    torch.cuda.synchronize()
    if not torch.equal(out, served):
        raise AssertionError(f"K3 with the lse store differs from K3 without "
                             f"it at {shape} {dtype_name}")
    lse_err = float((lse - flash_attention_lse_ref(
        qp, kp, vp, scale=scale, sk_valid=S)[1]).abs().max())
    if not lse_err <= LSE_BAR:
        raise AssertionError(f"K3's lse is {lse_err} from the plain one at "
                             f"{shape} {dtype_name}")

    def kernel():
        return flash_attention_bwd(qp, kp, vp, out, lse, dop, scale=scale,
                                   sk_valid=S)

    def plain():
        return flash_attention_bwd_ref(qp, kp, vp, out, lse, dop, scale=scale,
                                       sk_valid=S)

    before = flash_attention_bwd.launches
    got = kernel()
    torch.cuda.synchronize()
    if flash_attention_bwd.launches != before + 1:
        raise AssertionError(f"flash_attention_bwd did not launch once at "
                             f"{shape} {dtype_name}")
    again = kernel()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"flash_attention_bwd gave other bits on a second "
                             f"call at {shape} {dtype_name}")
    del again
    share, rtol = BWD_BARS[dtype]
    held = {}
    for name, g, w in zip(("dq", "dk", "dv"), got, plain()):
        top = float(w.float().abs().max())
        beyond = beyond_rtol(g, w, rtol)
        held[name] = {"max_abs_err": float((g.float() - w.float()).abs().max()),
                      "max_abs": top, "max_err_beyond_rtol": beyond,
                      "atol": share * top, "rtol": rtol}
        if not beyond <= share * top:
            raise AssertionError(f"flash_attention_bwd's {name} disagrees "
                                 f"with the plain version at {shape} "
                                 f"{dtype_name}: {held[name]}")
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    lib_out = sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)
    dot = do.transpose(1, 2)

    def library():
        return torch.autograd.grad(lib_out, (qt, kt, vt), dot,
                                   retain_graph=True)

    lib_err = max(float((lg.transpose(1, 2).float() - w.float()).abs().max())
                  for lg, w in zip(library(), (g[:, :S, :, :hd] for g in got)))
    pairs = S * (S + 1) // 2
    flops = 5 * 2 * B * H * hd * pairs
    n_bytes = (4 * q.numel() + 4 * k.numel()) * q.element_size() + 4 * B * H * S
    padded = padded_shape(S, S, hd)
    rec = {"shape": dict(zip(("B", "S", "H", "KV", "hd"), shape)),
           "dtype": dtype_name, "path": PATHS_BWD[dtype],
           "padded": dict(zip(("Sq", "Sk", "hd"), padded)),
           "ptxas": bwd_ptxas(dtype, padded[2]),
           "max_abs_err": max(h["max_abs_err"] for h in held.values()),
           "bar": held, "lse_max_abs_err": lse_err, "lse_bar": LSE_BAR,
           "lse_store_bit_equal": True, "repeat_bit_equal": True,
           "library_max_abs_err": lib_err,
           **_kernel_ms(kernel),
           "plain_ms": device_ms(plain, False),
           "library_ms": device_ms(library, False),
           "call_ms": cuda_ms(kernel), "plain_call_ms": cuda_ms(plain),
           "fwd_lse_ms": device_ms(lambda: flash_attention_fwd(
               qp, kp, vp, scale=scale, sk_valid=S)),
           "fwd_ms": device_ms(lambda: _launch_forward(qp, kp, vp, scale, S)),
           **_bound(n_bytes, flops, dtype)}
    emit(phase="kernel", name="flash_attention_bwd", **rec)
    return rec


def phase_attention_bwd() -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    return {(shape, dt): measure_attention_bwd(shape, dt)
            for dt in LM_DTYPES for shape in BWD_SHAPES}


def measure_matmul(shape, dtype_name: str) -> dict:
    """tiled_matmul against matmul_ref on random inputs (raising past the
    bar), its times, torch.matmul's time and the bound."""
    from repro_torch.kernels.ref import matmul_ref
    from repro_torch.kernels.tiled_matmul import (PATHS, default_blocks,
                                                  tiled_matmul)

    m, k, n = shape
    dtype = LM_DTYPES[dtype_name]
    x = _randn((m, k), dtype, 4)
    w = _randn((k, n), dtype, 5)
    out = tiled_matmul(x, w)
    torch.cuda.synchronize()
    ref = matmul_ref(x, w).float()
    err = (out.float() - ref).abs()
    atol, rtol = matmul_bar(dtype, k)
    beyond = beyond_rtol(out, ref, rtol)
    if not beyond <= atol:
        raise AssertionError(f"tiled_matmul disagrees with its plain version "
                             f"at {shape} {dtype_name}: max abs error "
                             f"{float(err.max())}, beyond rtol {beyond}")
    rec = {"shape": {"M": m, "K": k, "N": n}, "dtype": dtype_name,
           "path": PATHS[dtype],
           "blocks": [min(b, d) for b, d in zip(default_blocks(n, dtype, m),
                                                 (m, k, n))],
           "max_abs_err": float(err.max()),
           "max_rel_err": float((err / ref.abs().clamp(min=1.0)).max()),
           "bar": {"max_err_beyond_rtol": beyond, "atol": atol, "rtol": rtol},
           **_timings(lambda: tiled_matmul(x, w), lambda: matmul_ref(x, w),
                      lambda: torch.matmul(x, w)),
           **_bound((m * k + k * n + m * n) * x.element_size(), 2 * m * n * k,
                    dtype)}
    emit(phase="kernel", name="tiled_matmul", **rec)
    return rec


def phase_lm_kernels() -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    recs = {}
    for dt in LM_DTYPES:
        for shape in ATTN_SHAPES:
            recs["flash_attention", shape, dt] = measure_attention(shape, dt)
        for shape in MATMUL_SHAPES:
            recs["tiled_matmul", shape, dt] = measure_matmul(shape, dt)
    return recs


def serve_prompts(cfg, args) -> np.ndarray:
    """The first batch's tokens as `serve` builds them for its S_max
    prefill."""
    from repro_torch.launch import serve

    reqs = serve.make_requests(cfg, args)[:args.batch]
    return serve.pad_tokens(np.stack([r.prompt for r in reqs]),
                            serve.seq_lens(args)[1])


def serve_roofline(cfg, args, stats) -> dict:
    """The least time of an S_max prefill and of a decode step of the served
    batch: the analytic FLOPs and HBM bytes of `models/flops.py` (the port
    holds its weights in the compute dtype, so they are read as such) at the
    bf16 peak and 3.35 TB/s, and their share of the measured times.  A
    decode step is counted over the whole S_max cache, which it reads."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import flops

    held = dataclasses.replace(cfg, param_dtype=cfg.compute_dtype)
    out = {}
    for kind, measured in (("prefill", stats["prefill_ms"]),
                           ("decode", stats["decode_step_ms"])):
        shape = ShapeConfig(f"serve_{kind}", stats["S_max"], args.batch, kind)
        n_flops = flops.forward_flops(cfg, shape)
        n_bytes = flops.cell_bytes(held, shape, 1, 1)["bytes_per_dev"]
        t_ops = n_flops / LM_PEAK_FLOPS[torch.bfloat16] * 1e3
        t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        bound = max(t_ops, t_bytes)
        out[kind] = {"flops": n_flops, "bytes": n_bytes, "roofline_ms": bound,
                     "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                     "measured_ms": measured, "share": bound / measured}
    return out


def phase_serve() -> dict:
    """smollm-360m at full config served on the card; K3 must be launched by
    every prefill layer."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.edp_reduce import edp_reduce
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.tiled_matmul import tiled_matmul
    from repro_torch.launch import serve

    cfg = get_config("smollm-360m")
    args = serve.parse_args([*SERVE_ARGV, "--device", "cuda"])
    torch.cuda.reset_peak_memory_stats()
    edp_reduce.launches = tiled_matmul.launches = flash_attention.launches = 0
    done, stats = serve.serve(cfg, args)
    launches = flash_attention.launches
    n_batches = -(-args.requests // args.batch)
    expected = n_batches * 2 * cfg.num_layers
    if launches <= 0:
        raise AssertionError("serving never launched flash_attention")
    tokens = [r.out_tokens for r in done]
    if not (len(done) == args.requests
            and all(len(t) == args.gen_len for t in tokens)
            and all(0 <= t[0] < cfg.padded_vocab() for t in tokens)
            and all(0 <= x < cfg.vocab_size for t in tokens for x in t[1:])):
        raise AssertionError("served tokens are not valid ids of the "
                             "expected count")
    emit(phase="serve", arch=cfg.name, layers=cfg.num_layers,
         compute_dtype=cfg.compute_dtype, kv_cache_dtype=cfg.kv_cache_dtype,
         argv=list(SERVE_ARGV), **stats,
         launches={"flash_attention": launches,
                   "tiled_matmul": tiled_matmul.launches},
         expected_flash_launches=expected,
         first_tokens={r.rid: r.out_tokens[:8] for r in done[:3]},
         peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
         roofline=serve_roofline(cfg, args, stats))
    return {"launches": launches, "cfg": cfg, "args": args}


def phase_prefill_vs_naive(cfg, args):
    """The first batch's prefill through K3 and with attn_impl="naive"."""
    from repro_torch.models.model import build_model

    model = build_model(cfg, "cuda").init(
        torch.Generator().manual_seed(args.seed))
    toks = torch.from_numpy(serve_prompts(cfg, args))
    flash, _ = model.prefill({"tokens": toks})
    model.cfg = dataclasses.replace(cfg, attn_impl="naive")
    naive, _ = model.prefill({"tokens": toks})
    model.cfg = cfg
    flash, naive = flash[:, -1].float(), naive[:, -1].float()
    diff = float((flash - naive).abs().max())
    bar = PREFILL_BAR * float(naive.abs().max())
    agree = float((flash.argmax(-1) == naive.argmax(-1)).float().mean())
    emit(phase="prefill_vs_naive", shape=list(toks.shape),
         max_abs_logit_diff=diff, bar=bar, max_abs_logit=float(naive.abs().max()),
         argmax_agreement=agree)
    if not diff <= bar:
        raise AssertionError(f"K3 prefill logits differ from the naive "
                             f"prefill's by {diff} (bar {bar})")
    return model


def phase_serve_profile(model, cfg, args, phase: str = "serve_profile"
                        ) -> None:
    """One S_max prefill and 8 decode steps of the served model under
    torch.profiler: wall and device time, launches, the device's idle share,
    K3's share of the prefill and the top device kernels."""
    from torch.profiler import ProfilerActivity, profile

    toks = torch.from_numpy(serve_prompts(cfg, args))
    logits, cache = model.prefill({"tokens": toks})
    torch.cuda.synchronize()

    def device_kernels(prof):
        return {e.key: (e.self_device_time_total, e.count)
                for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA}

    def record(what, kernels, wall, n):
        busy = sum(t for t, _ in kernels.values()) / 1e6
        top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:6]
        k3 = sum(t for k, (t, _) in kernels.items()
                 if any(n in k for n in K3_KERNELS.values())) / 1e6
        emit(phase=phase, what=what, calls=n, wall_ms=1e3 * wall / n,
             device_ms=1e3 * busy / n if kernels else None,
             launches=sum(c for _, c in kernels.values()) // n,
             idle_share=(1.0 - busy / wall) if kernels else None,
             flash_attention_ms=1e3 * k3 / n,
             top_kernels={k[:80]: {"us": t / n, "count": c // n}
                          for k, (t, c) in top},
             note=None if kernels else "the profiler reported no device "
                                       "events")

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        logits, cache = model.prefill({"tokens": toks})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    record(f"prefill B {toks.shape[0]} S {toks.shape[1]}", device_kernels(prof),
           wall, 1)
    nxt = torch.argmax(logits[:, -1, :cfg.vocab_size], dim=-1)
    steps = 8
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            logits, cache = model.decode_step(cache, {"tokens": nxt[:, None]},
                                              args.prompt_len + i)
            nxt = torch.argmax(logits[:, 0, :cfg.vocab_size], dim=-1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    record(f"decode step B {toks.shape[0]} cache {toks.shape[1]}",
           device_kernels(prof), wall, steps)


def phase_matmul_path(model, cfg, args) -> dict:
    """K2 through its entry point `kernels.ops.matmul` on layer 0's serve
    projections (the first batch's hidden states and the model's weights),
    in the model's bf16 and cast to f32."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.tiled_matmul import tiled_matmul
    from repro_torch.models import layers as L

    toks = torch.from_numpy(serve_prompts(cfg, args)).cuda()
    blk = model.blocks[0]
    with torch.no_grad():
        x = L.embed(model.embed, toks).reshape(-1, cfg.d_model)
        h = L.rmsnorm(x, blk.attn["ln"]).contiguous()
        hm = L.rmsnorm(x, blk.mlp["ln"]).contiguous()
        cases = [("wq", h, blk.attn["wq"]), ("wk", h, blk.attn["wk"]),
                 ("wi_mlp_up", hm, blk.mlp["wi_mlp_up"])]
        gate, up = torch.chunk(hm @ blk.mlp["wi_mlp_up"], 2, dim=-1)
        act = (torch.nn.functional.silu(gate) * up).contiguous()
        cases.append(("wo_mlp", act, blk.mlp["wo_mlp"]))
        launches, outs = {}, {}
        for dt in (torch.bfloat16, torch.float32):
            typed = [(name, a.to(dt).contiguous(), w.to(dt).contiguous())
                     for name, a, w in cases]
            tiled_matmul.launches = 0
            outs[dt] = [(name, a, w, ops.matmul(a, w)) for name, a, w in typed]
            torch.cuda.synchronize()
            launches[dt] = tiled_matmul.launches
    errs = {}
    for dt, results in outs.items():
        for name, a, w, out in results:
            ref = a @ w
            atol, rtol = matmul_bar(dt, a.shape[1])
            beyond = beyond_rtol(out, ref, rtol)
            key = f"{name} {str(dt).split('.')[-1]}"
            errs[key] = {"shape": [a.shape[0], a.shape[1], w.shape[1]],
                         "max_abs_err": float((out.float() - ref.float())
                                              .abs().max()),
                         "max_err_beyond_rtol": beyond, "atol": atol}
            if not beyond <= atol:
                raise AssertionError(f"ops.matmul disagrees with "
                                     f"torch.matmul on {key}: {errs[key]}")
        if launches[dt] != len(cases):
            raise AssertionError(f"ops.matmul launched tiled_matmul "
                                 f"{launches[dt]} times for {len(cases)} "
                                 f"{dt} calls")
    emit(phase="matmul_path",
         launches={"tiled_matmul": {str(dt).split(".")[-1]: n
                                    for dt, n in launches.items()}},
         projections=errs)
    return {"launches": launches}


def phase_serve_parity() -> int:
    """smollm-360m at full width, 2 layers, f32: card and CPU tokens equal,
    and K3's f32 kernel launched by every prefill layer of the card's run.
    Returns those launches."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch import serve

    cfg = dataclasses.replace(get_config("smollm-360m"), num_layers=2,
                              compute_dtype="float32",
                              kv_cache_dtype="float32")
    runs = {}
    for device in ("cuda", "cpu"):
        args = serve.parse_args([*PARITY_ARGV, "--device", device])
        flash_attention.launches = 0
        done, stats = serve.serve(cfg, args)
        runs[device] = ([r.out_tokens for r in done], stats["wall_s"],
                        flash_attention.launches)
    launches = runs["cuda"][2]
    expected = -(-args.requests // args.batch) * 2 * cfg.num_layers
    same = runs["cuda"][0] == runs["cpu"][0]
    emit(phase="serve_parity", layers=2, compute_dtype="float32",
         argv=list(PARITY_ARGV), card_wall_s=runs["cuda"][1],
         cpu_wall_s=runs["cpu"][1], same_tokens=same,
         first_tokens=runs["cuda"][0][0],
         launches={"flash_attention": launches},
         expected_flash_launches=expected)
    if launches != expected:
        raise AssertionError(f"the f32 serve launched flash_attention "
                             f"{launches} times for {expected} prefill "
                             f"layers")
    if not same:
        raise AssertionError(f"card and CPU served different tokens: "
                             f"{runs['cuda'][0]} vs {runs['cpu'][0]}")
    return launches


def smoke_config(device: str):
    from repro_torch.core import (CodesignConfig, EngineConfig,
                                  HWSearchConfig, SWSearchConfig)

    return CodesignConfig(
        sw=SWSearchConfig(n_trials=40, n_warmup=10, pool_size=150),
        hw=HWSearchConfig(n_trials=6, n_warmup=3, pool_size=150, num_pes=168),
        engine=EngineConfig(backend="torch", strategy="probe_fanout",
                            device=device),
        seed=0)


def design_hash(result) -> str:
    hw = dataclasses.astuple(result.best_hw)
    maps = sorted((n, dataclasses.astuple(m))
                  for n, m in result.best_mappings.items())
    return hashlib.sha256(repr((hw, maps)).encode()).hexdigest()


def run_search(device: str):
    from repro_torch.core import CodesignEngine
    from repro_torch.timeloop import MODEL_LAYERS

    t0 = time.perf_counter()
    result = CodesignEngine(smoke_config(device)).run(MODEL_LAYERS["resnet"])
    if device == "cuda":
        torch.cuda.synchronize()
    return result, time.perf_counter() - t0


def phase_main_path() -> dict:
    from repro_torch.kernels.cost_forward import cost_forward
    from repro_torch.kernels.edp_reduce import edp_reduce
    from repro_torch.kernels.gp_fit import gp_fit
    from repro_torch.timeloop import MODEL_LAYERS
    from repro_torch.timeloop import batch_torch as ttlb
    from repro_torch.timeloop.model import evaluate

    # Tally the forwards and the row counts the main path hands K1b (a
    # pass-through around the engine's reference to the wrapper; the
    # wrapper's own count is what proves the launches).
    rows: dict[int, int] = {}
    inner = ttlb.cost_forward

    def tally(*ops):
        rows[ops[0].shape[0]] = rows.get(ops[0].shape[0], 0) + 1
        return inner(*ops)

    ttlb.cost_forward = tally
    cost_forward.launches = edp_reduce.launches = gp_fit.launches = 0
    try:
        result, wall = run_search("cuda")
    finally:
        ttlb.cost_forward = inner
    launches = cost_forward.launches
    gp_launches = gp_fit.launches
    forwards = sum(rows.values())
    if launches <= 0 or launches != forwards or edp_reduce.launches:
        raise AssertionError(
            f"the main path's {forwards} forwards launched cost_forward "
            f"{launches} times and edp_reduce {edp_reduce.launches} times")
    log10 = float(np.log10(result.best_model_edp))
    layers = MODEL_LAYERS["resnet"]
    edps = [evaluate(result.best_hw, result.best_mappings[ly.name], ly).edp
            for ly in layers]
    if not (np.isfinite(log10) and len(result.best_mappings) == len(layers)
            and np.isclose(sum(edps), result.best_model_edp, rtol=1e-12)):
        raise AssertionError("main path result is not a valid design")
    emit(phase="main_path", device="cuda", wall_s=wall, best_log10_edp=log10,
         forwards=forwards,
         launches={"cost_forward": launches,
                   "edp_reduce": edp_reduce.launches,
                   "gp_fit": gp_launches},
         rows_per_launch={str(k): v for k, v in sorted(rows.items())},
         outer_trials=len(result.hw_result.history),
         design_hash=design_hash(result), stats=result.stats)

    result_cpu, wall_cpu = run_search("cpu")
    log10_cpu = float(np.log10(result_cpu.best_model_edp))
    same_design = design_hash(result) == design_hash(result_cpu)
    same_history = result.hw_result.history == result_cpu.hw_result.history
    emit(phase="main_path", device="cpu", wall_s=wall_cpu,
         best_log10_edp=log10_cpu, same_design_as_card=same_design,
         same_outer_history=same_history)
    if not (same_design and same_history and log10 == log10_cpu):
        raise AssertionError(
            f"card and CPU disagree: best log10 EDP {log10} vs {log10_cpu}, "
            f"same design {same_design}, same outer history {same_history}")
    return {"launches": launches, "rows": rows, "design": design_hash(result),
            "gp_fit_launches": gp_launches}


def phase_profile() -> None:
    """One lockstep inner search (the four ResNet layers on Eyeriss, 16
    trials) under torch.profiler, the device's activity alone (~84,000
    launches: the host's op events made most of the phase's minute):
    device time by kernel, launches, forwards (K1b launches) and idle
    share."""
    from torch.profiler import profile

    from repro_torch.core import SWSearchConfig, optimize_software_many
    from repro_torch.kernels.cost_forward import cost_forward
    from repro_torch.timeloop import MODEL_LAYERS, eyeriss_168

    cfg = SWSearchConfig(n_trials=16, n_warmup=10, pool_size=150)
    layers = MODEL_LAYERS["resnet"]
    optimize_software_many(eyeriss_168(), layers, cfg, device="cuda")
    torch.cuda.synchronize()
    cost_forward.launches = 0
    with profile(activities=_activities(True)) as prof:
        t0 = time.perf_counter()
        optimize_software_many(eyeriss_168(), layers, cfg, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = {}
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            kernels[evt.key] = (evt.self_device_time_total, evt.count)
    busy_s = sum(t for t, _ in kernels.values()) / 1e6
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]
    emit(phase="profile", what="optimize_software_many resnet n_trials=16",
         wall_s=wall,
         device_kernel_s=busy_s if kernels else None,
         device_launches=sum(c for _, c in kernels.values()),
         forwards=cost_forward.launches,
         idle_share=(1.0 - busy_s / wall) if kernels else None,
         top_kernels={k[:80]: {"us": t, "count": c} for k, (t, c) in top},
         note=None if kernels else "the profiler reported no device events")


def speculative_config(device: str):
    """`smoke_config` (ResNet's full width, the same budgets) with the
    speculative strategy, the safe prune gate and an outer GP refit every
    4 trials.  The safe gate bounds a selected probe on the host (the scalar
    `timeloop.bounds.lower_bound`); the outer GP's bound prior mean
    (`warm_start_bound_mean`) bounds every candidate pool through
    `batch_torch.edp_lower_bounds_device`, which puts the vectorized bounds
    on the card."""
    cfg = smoke_config(device)
    return dataclasses.replace(
        cfg, hw=dataclasses.replace(cfg.hw, prune="safe",
                                    warm_start_bound_mean=True),
        engine=dataclasses.replace(cfg.engine, strategy="speculative",
                                   hw_gp_refit_every=4))


def phase_prune_speculative(main_design: str) -> dict:
    """The co-design search with speculation and the prune gate, on the card
    and then on the CPU: the same design hash, outer history and best log10
    EDP, exactly; the prune gate's `edp_lower_bounds_device` called on the
    card; K1b's launches."""
    from repro_torch.core import CodesignEngine
    from repro_torch.kernels.cost_forward import cost_forward
    from repro_torch.timeloop import MODEL_LAYERS
    from repro_torch.timeloop import batch_torch as ttlb

    inner = ttlb.edp_lower_bounds_device
    calls = []

    def tally(*args, **kwargs):
        calls.append(1)
        return inner(*args, **kwargs)

    runs = {}
    for device in ("cuda", "cpu"):
        calls.clear()
        ttlb.edp_lower_bounds_device = tally
        cost_forward.launches = 0
        try:
            t0 = time.perf_counter()
            result = CodesignEngine(speculative_config(device)).run(
                MODEL_LAYERS["resnet"])
            if device == "cuda":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            ttlb.edp_lower_bounds_device = inner
        runs[device] = {"result": result, "wall_s": wall,
                        "bound_calls": len(calls),
                        "launches": cost_forward.launches}
    card, cpu = runs["cuda"], runs["cpu"]
    log10 = {d: float(np.log10(r["result"].best_model_edp))
             for d, r in runs.items()}
    same_design = design_hash(card["result"]) == design_hash(cpu["result"])
    same_history = (card["result"].hw_result.history
                    == cpu["result"].hw_result.history)
    stats = card["result"].stats
    emit(phase="prune_speculative", strategy="speculative", prune="safe",
         hw_gp_refit_every=4, warm_start_bound_mean=True,
         card_wall_s=card["wall_s"],
         cpu_wall_s=cpu["wall_s"], best_log10_edp=log10["cuda"],
         cpu_best_log10_edp=log10["cpu"], same_design_as_cpu=same_design,
         same_outer_history_as_cpu=same_history,
         outer_trials=len(card["result"].hw_result.history),
         stats={k: stats.get(k) for k in ("spec_evaluated", "spec_hits",
                                          "probes_gated", "prune_considered",
                                          "prune_pruned")},
         edp_lower_bounds_device_calls={"card": card["bound_calls"],
                                        "cpu": cpu["bound_calls"]},
         launches={"cost_forward": card["launches"]},
         same_design_as_main_path=design_hash(card["result"]) == main_design)
    if card["bound_calls"] <= 0 or card["launches"] <= 0:
        raise AssertionError(
            f"the speculative pruned search called edp_lower_bounds_device "
            f"{card['bound_calls']} times and launched cost_forward "
            f"{card['launches']} times on the card")
    if not (same_design and same_history and log10["cuda"] == log10["cpu"]):
        raise AssertionError(
            f"speculative pruned search: card and CPU disagree: best log10 "
            f"EDP {log10['cuda']} vs {log10['cpu']}, same design "
            f"{same_design}, same outer history {same_history}")
    return {"launches": card["launches"]}


def phase_baselines() -> dict:
    """The paper's three baselines on ResNet's first layer (its
    `SoftwareSpace` on Eyeriss-168, backend torch; the paper's budget for
    random search, cut to 80 and 50 trials for the TVM-style search and
    relax-and-round BO), on the card and on the CPU: the same points, best
    mapping and history, exactly; wall and K1b launches."""
    from repro_torch.core import (SoftwareSpace, random_search, relax_round_bo,
                                  tvm_style_search)
    from repro_torch.kernels.cost_forward import cost_forward
    from repro_torch.timeloop import MODEL_LAYERS, eyeriss_168

    cases = (("random_search", random_search, {"n_trials": 250, "seed": 0}),
             ("tvm_style_search", tvm_style_search,
              {"n_trials": 80, "n_warmup": 30, "pool_size": 150, "seed": 0}),
             ("relax_round_bo", relax_round_bo,
              {"n_trials": 50, "n_warmup": 30, "pool_size": 150, "seed": 0}))
    layer = MODEL_LAYERS["resnet"][0]
    launches = 0
    for name, fn, kwargs in cases:
        runs = {}
        for device in ("cuda", "cpu"):
            space = SoftwareSpace(eyeriss_168(), layer, backend="torch",
                                  device=device)
            cost_forward.launches = 0
            t0 = time.perf_counter()
            res = fn(space, **kwargs)
            if device == "cuda":
                torch.cuda.synchronize()
            runs[device] = (res, time.perf_counter() - t0,
                            cost_forward.launches)
        (card, card_wall, n), (cpu, cpu_wall, _) = runs["cuda"], runs["cpu"]
        same = {"points": card.points == cpu.points,
                "best": card.best_point == cpu.best_point,
                "history": card.history == cpu.history}
        emit(phase="baselines", baseline=name, layer=layer.name, **kwargs,
             card_wall_s=card_wall, cpu_wall_s=cpu_wall,
             best_log10_edp=-card.best_value, n_infeasible=card.n_infeasible,
             launches={"cost_forward": n}, same_as_cpu=same)
        if n <= 0 or not all(same.values()):
            raise AssertionError(f"{name}: launched cost_forward {n} times; "
                                 f"card against CPU: {same}")
        launches += n
    return {"launches": launches}


def service_config(device: str, executor=None):
    """The service's and the executor's requests: full widths, speculative,
    budgets cut to sw 12/6 and hw 4/2 (inside the stacked linear fit's
    Cholesky regime, where a stack's composition cannot move its sums)."""
    from repro_torch.core import (CodesignConfig, EngineConfig, ExecutorConfig,
                                  HWSearchConfig, SWSearchConfig)

    return CodesignConfig(
        sw=SWSearchConfig(n_trials=12, n_warmup=6, pool_size=150),
        hw=HWSearchConfig(n_trials=4, n_warmup=2, pool_size=150, num_pes=168),
        engine=EngineConfig(backend="torch", strategy="speculative",
                            device=device,
                            executor=executor or ExecutorConfig()),
        seed=0)


def _same_result(a, b) -> bool:
    return (a.best_hw == b.best_hw and a.best_model_edp == b.best_model_edp
            and a.best_mappings == b.best_mappings
            and a.hw_result.history == b.hw_result.history)


def phase_service() -> dict:
    """`CodesignService` on the card with fused dispatch and a design store:
    the resnet paper set, the llama4-maverick zoo set and a resnet+dqn
    portfolio, concurrently.  Each result must equal its standalone run on
    the card, and a second pass against the warm store must run no inner
    search and give the same results."""
    import tempfile

    from repro_torch.core import CodesignEngine, ServiceConfig
    from repro_torch.core import nested
    from repro_torch.kernels.cost_forward import cost_forward
    from repro_torch.service import CodesignService, ServiceRequest
    from repro_torch.timeloop import MODEL_LAYERS
    from repro_torch.workloads import (PortfolioConfig, portfolio_codesign,
                                       resolve_workload)

    cfg = service_config("cuda")
    zoo = "llama4-maverick-400b-a17b"
    portfolio = PortfolioConfig(("resnet", "dqn"))
    requests = [
        ServiceRequest(layers=tuple(MODEL_LAYERS["resnet"]), config=cfg,
                       rid="resnet"),
        ServiceRequest(layers=tuple(resolve_workload(zoo)), config=cfg,
                       rid=zoo),
        ServiceRequest(portfolio=portfolio, config=cfg, rid="portfolio")]
    searched = []
    inner = nested.optimize_software_fanout

    def spy(items, *args, **kwargs):
        searched.append(len(items))
        return inner(items, *args, **kwargs)

    passes = []
    with tempfile.TemporaryDirectory() as store_dir:
        for _ in range(2):
            searched.clear()
            nested.optimize_software_fanout = spy
            cost_forward.launches = 0
            try:
                t0 = time.perf_counter()
                with CodesignService(ServiceConfig(
                        max_slots=3, fuse=True, store_dir=store_dir)) as svc:
                    for req in requests:
                        svc.submit(req)
                    out = svc.run()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            finally:
                nested.optimize_software_fanout = inner
            passes.append({"out": out, "wall_s": wall,
                           "launches": cost_forward.launches,
                           "searches": len(searched),
                           "searched_items": sum(searched),
                           "stats": dict(svc.stats)})
    t0 = time.perf_counter()
    standalone = {
        "resnet": CodesignEngine(cfg).run(MODEL_LAYERS["resnet"]),
        zoo: CodesignEngine(cfg).run(resolve_workload(zoo)),
        "portfolio": portfolio_codesign(portfolio, cfg)}
    standalone_wall = time.perf_counter() - t0
    cold, warm = passes
    for name, p in (("cold", cold), ("warm", warm)):
        res = p["out"]
        emit(phase="service", run=name, wall_s=p["wall_s"],
             ticks=p["stats"]["ticks"],
             fused_dispatches=p["stats"]["fused_dispatches"],
             fused_items=p["stats"]["fused_items"],
             deduped_items=p["stats"]["deduped_items"],
             inner_searches=p["searches"], searched_items=p["searched_items"],
             launches={"cost_forward": p["launches"]},
             requests={rid: {"best_log10_edp": float(
                 np.log10(r.result.best_model_edp)),
                 "store_hits": r.result.stats["store_hits"],
                 "store_misses": r.result.stats["store_misses"],
                 "layers": len(r.result.best_mappings),
                 "same_as_standalone": _same_result(r.result,
                                                    standalone[rid])}
                 for rid, r in res.items()},
             standalone_wall_s=standalone_wall if name == "cold" else None)
    for name, p in (("cold", cold), ("warm", warm)):
        bad = [rid for rid, r in p["out"].items()
               if not _same_result(r.result, standalone[rid])]
        if bad or len(p["out"]) != len(requests):
            raise AssertionError(f"service {name} pass: {bad} differ from "
                                 f"their standalone runs on the card")
    if cold["launches"] <= 0 or cold["stats"]["fused_dispatches"] <= 0:
        raise AssertionError("the service's cold pass launched no "
                             "cost_forward or fused no dispatch")
    if warm["searches"] or any(r.result.stats["store_misses"]
                               for r in warm["out"].values()):
        raise AssertionError(f"the warm store pass ran {warm['searches']} "
                             f"inner searches")
    return {"launches": cold["launches"]}


def phase_executor() -> dict:
    """The speculative search of ResNet through a pool of 2 spawned workers
    on the card, against the inline run: the same design and outer history.
    Each worker booted with no jax, no repro module and no CUDA context and
    launched K1b; the device memory a worker adds is read from the card's
    free memory (`torch.cuda.mem_get_info`) before and after the pool ran."""
    from repro_torch.core import CodesignEngine, ExecutorConfig
    from repro_torch.timeloop import MODEL_LAYERS

    layers = MODEL_LAYERS["resnet"]
    t0 = time.perf_counter()
    inline = CodesignEngine(service_config("cuda")).run(layers)
    torch.cuda.synchronize()
    inline_wall = time.perf_counter() - t0
    engine = CodesignEngine(service_config(
        "cuda", ExecutorConfig(kind="process", n_workers=2)))
    torch.cuda.synchronize()
    free_before = torch.cuda.mem_get_info()[0]
    try:
        t0 = time.perf_counter()
        result = engine.run(layers)
        wall = time.perf_counter() - t0
        workers = engine.executor.probe_all()
        free_after = torch.cuda.mem_get_info()[0]
    finally:
        engine.close()
    same = _same_result(result, inline)
    emit(phase="executor", kind="process", n_workers=2,
         strategy="speculative", sw_trials=12, hw_trials=4,
         wall_s=wall, inline_wall_s=inline_wall,
         same_design_and_history_as_inline=same,
         best_log10_edp=float(np.log10(result.best_model_edp)),
         workers=[{"pid": w["pid"], "boot": w["boot"],
                   "cuda_initialized": w["cuda_initialized"],
                   "launches": {"cost_forward": w["cost_forward_launches"]},
                   "cuda_reserved_bytes": w["cuda_reserved_bytes"]}
                  for w in workers],
         device_bytes_per_worker=(free_before - free_after) / len(workers))
    if not same:
        raise AssertionError("the process executor's design or outer "
                             "history differs from the inline run's")
    for w in workers:
        boot = w["boot"]
        if (len(workers) != 2 or boot["forked"] or boot["jax_modules"]
                or boot["repro_modules"] or boot["cuda_initialized"]
                or w["cost_forward_launches"] <= 0):
            raise AssertionError(f"executor worker state: {w}")
    return {"launches": sum(w["cost_forward_launches"] for w in workers)}


def phase_serve_smoke() -> dict:
    """`serve --arch smollm-360m --smoke` (head dim 20, K3 through its
    padding) on the card in bf16; then in f32 compute and cache on the card
    and on the CPU, whose tokens must be equal; and a direct f32 prefill of
    100 tokens, card against CPU."""
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch import serve
    from repro_torch.models.model import build_model

    cfg = get_smoke_config("smollm-360m")
    flash_attention.launches = 0
    t0 = time.perf_counter()
    done = serve.main([*SMOKE_ARGV, "--device", "cuda"])
    bf16_wall = time.perf_counter() - t0
    bf16_launches = flash_attention.launches
    f32 = dataclasses.replace(cfg, compute_dtype="float32",
                              kv_cache_dtype="float32")
    tokens, launches = {}, {}
    for device in ("cuda", "cpu"):
        flash_attention.launches = 0
        tokens[device] = [r.out_tokens for r in serve.main(
            [*SMOKE_ARGV, "--device", device], config=f32)]
        launches[device] = flash_attention.launches
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 100)))
    logits = {}
    for device in ("cuda", "cpu"):
        model = build_model(f32, device).init(torch.Generator().manual_seed(0))
        logits[device] = model.prefill({"tokens": toks})[0].float().cpu()
    prefill_diff = float((logits["cuda"] - logits["cpu"]).abs().max())
    same = tokens["cuda"] == tokens["cpu"]
    emit(phase="serve_smoke", arch=cfg.name, head_dim=cfg.head_dim,
         argv=list(SMOKE_ARGV), bf16_wall_s=bf16_wall,
         bf16_requests=len(done),
         launches={"flash_attention": {"bfloat16": bf16_launches,
                                       "float32": launches["cuda"]}},
         f32_same_tokens_as_cpu=same, f32_first_tokens=tokens["cuda"][0],
         prefill_s100_max_abs_logit_diff=prefill_diff,
         prefill_bar=ATTN_BARS[torch.float32][0])
    if bf16_launches <= 0 or launches["cuda"] <= 0 or launches["cpu"]:
        raise AssertionError(f"smoke serve K3 launches: bf16 {bf16_launches}, "
                             f"f32 card {launches['cuda']}, CPU "
                             f"{launches['cpu']}")
    if not same:
        raise AssertionError(f"smoke serve f32: card and CPU tokens differ: "
                             f"{tokens['cuda']} vs {tokens['cpu']}")
    if not prefill_diff <= ATTN_BARS[torch.float32][0]:
        raise AssertionError(f"f32 prefill of 100 tokens: card and CPU "
                             f"logits differ by {prefill_diff}")
    return {"launches": bf16_launches}


def phase_serve_hd160() -> dict:
    """stablelm-12b (head dim 160) at full width, 2 layers, served on the
    card in bf16 and in f32: K3's hd 160 instances launched by every prefill
    layer, and valid tokens.  Returns the launches by dtype."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch import serve

    base = dataclasses.replace(get_config("stablelm-12b"),
                               num_layers=HD160_LAYERS)
    args = serve.parse_args([*HD160_ARGV, "--device", "cuda"])
    expected = -(-args.requests // args.batch) * 2 * base.num_layers
    launches = {}
    for name in LM_DTYPES:
        cfg = dataclasses.replace(base, compute_dtype=name,
                                  kv_cache_dtype=name)
        flash_attention.launches = 0
        done, stats = serve.serve(cfg, args)
        launches[name] = flash_attention.launches
        tokens = [r.out_tokens for r in done]
        emit(phase="serve_hd160", arch=cfg.name, layers=cfg.num_layers,
             head_dim=cfg.head_dim, compute_dtype=name,
             argv=list(HD160_ARGV), wall_s=stats["wall_s"],
             prefill_ms=stats["prefill_ms"], S_max=stats["S_max"],
             launches={"flash_attention": launches[name]},
             expected_flash_launches=expected, first_tokens=tokens[0][:8])
        if launches[name] != expected or not all(
                len(t) == args.gen_len and 0 <= t[0] < cfg.padded_vocab()
                and all(0 <= x < cfg.vocab_size for x in t[1:])
                for t in tokens):
            raise AssertionError(f"stablelm-12b {name} serve: "
                                 f"{launches[name]} K3 launches for "
                                 f"{expected} prefill layers, tokens {tokens}")
        torch.cuda.empty_cache()
    return launches


def _train_counts_reset() -> None:
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    from repro_torch.kernels.tiled_matmul import tiled_matmul

    flash_attention.launches = flash_attention_bwd.launches = 0
    tiled_matmul.launches = 0


def _train_counts() -> dict:
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    from repro_torch.kernels.tiled_matmul import tiled_matmul

    return {"flash_attention": flash_attention.launches,
            "flash_attention_bwd": flash_attention_bwd.launches,
            "tiled_matmul": tiled_matmul.launches}


def phase_train() -> dict:
    """`repro_torch.launch.train.main` on smollm-360m at its full config
    (batch 8, seq 1024, 30 steps, one save at the end into a temporary
    directory, removed after): first and last loss (the last must be below
    the first), median step ms after the first step and tokens/s, K3's and
    K3-bwd's launches a step (64 and 32: block remat runs each block's
    forward twice), K2's (0), peak memory, the save's seconds, restarts
    (none may happen), and the share of `models/flops.py`'s expected
    hardware FLOPs a step at the bf16 peak that the median step reaches."""
    import shutil
    import tempfile

    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.launch import train
    from repro_torch.models import flops

    cfg = get_config("smollm-360m")
    args = train.parse_args(list(TRAIN_ARGV))
    records = []
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_train.")
    try:
        torch.cuda.reset_peak_memory_stats()
        _train_counts_reset()
        t0 = time.perf_counter()
        losses = train.main([*TRAIN_ARGV, "--ckpt-dir", ckpt_dir,
                             "--device", "cuda"], log=records.append)
        wall = time.perf_counter() - t0
        launches = _train_counts()
        peak = torch.cuda.max_memory_allocated()
        ckpt_bytes = sum(f.stat().st_size for f in Path(ckpt_dir).rglob("*")
                         if f.is_file())
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    steps = [m for m in records if "loss" in m]
    restarts = [m for m in records if m.get("event") == "restart"]
    done = next(m for m in records if m.get("event") == "done")
    n = len(steps)
    med = statistics.median(m["dt"] for m in steps[1:])
    hw_flops = flops.cell_flops(cfg, ShapeConfig("train", args.seq,
                                                 args.batch, "train"))
    per_step = {k: v / n for k, v in launches.items()}
    emit(phase="train", arch=cfg.name, layers=cfg.num_layers,
         compute_dtype=cfg.compute_dtype, remat=cfg.remat,
         argv=list(TRAIN_ARGV), steps=n, wall_s=wall,
         first_loss=losses[0], last_loss=losses[-1],
         losses_every_10=losses[::10],
         first_step_ms=1e3 * steps[0]["dt"], median_step_ms=1e3 * med,
         tokens_per_s=args.batch * args.seq / med,
         launches=launches, launches_per_step=per_step,
         peak_memory_gib=peak / 2 ** 30,
         save_seconds=[{"step": st, "host_copy_s": c, "write_s": w}
                       for st, c, w in done["save_seconds"]],
         checkpoint_bytes=ckpt_bytes, restarts=len(restarts),
         stragglers=done["stragglers"],
         expected_hw_flops=hw_flops["expected_hw"],
         expected_hw_share_at_bf16_peak=hw_flops["expected_hw"]
         / med / LM_PEAK_FLOPS[torch.bfloat16])
    if restarts:
        raise AssertionError(f"the training run restarted: {restarts}")
    if not (n == args.steps and all(np.isfinite(losses))
            and losses[-1] < losses[0]):
        raise AssertionError(f"training ran {n} steps, losses {losses}")
    expected = {"flash_attention": 2 * cfg.num_layers * n,
                "flash_attention_bwd": cfg.num_layers * n, "tiled_matmul": 0}
    if launches != expected:
        raise AssertionError(f"training launched {launches}, expected "
                             f"{expected} (64 K3 and 32 K3-bwd a step)")
    return {"launches": launches, "median_step_ms": 1e3 * med,
            "losses": losses}


def phase_train_profile() -> None:
    """One training step of smollm-360m at its full config (batch 8, seq
    1024) under torch.profiler (`profile_train_step`)."""
    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticSource
    from repro_torch.launch import steps, train

    cfg = get_config("smollm-360m")
    args = train.parse_args(list(TRAIN_ARGV))
    opt_cfg = train.opt_config(cfg, args)
    model, step_fn = steps.make_train_step(cfg, opt_cfg, "cuda")
    state = steps.init_train_state(model, cfg, opt_cfg,
                                   torch.Generator().manual_seed(0))
    source = SyntheticSource(cfg, ShapeConfig("t", args.seq, args.batch,
                                              "train"), DataConfig(seed=0))
    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in source.batch(0).items()}
    profile_train_step(step_fn, state, batch, "train_profile",
                       f"train step B {args.batch} S {args.seq}")
    del model


def profile_train_step(step_fn, state, batch, phase: str, what: str,
                       attention: bool = True,
                       device_only: bool = False) -> None:
    """One training step under torch.profiler, after one warm step: wall
    and device ms, device launches, the device's idle share, K3's and
    K3-bwd's device ms where the model has `attention` (K3-bwd's also by
    kernel function; a kernel function that did not run fails the phase)
    and the top kernels.  A step whose profile records no device time is
    reported in a `profiler_retry` line and profiled again, up to five
    times (with the host's activity too where `device_only` asked for the
    device's alone, `_activities`)."""
    from torch.profiler import profile

    state, _ = step_fn(state, batch)
    torch.cuda.synchronize()
    for attempt in range(1, 6):
        with profile(activities=_activities(device_only
                                            and attempt == 1)) as prof:
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kernels = {e.key: (e.self_device_time_total, e.count)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA}
        if kernels:
            break
        emit(phase="profiler_retry", attempt=attempt, what=phase,
             note="the profiler recorded no device time for this step")
    else:
        raise AssertionError("the profiler recorded no device time in five "
                             f"profiled steps ({phase})")
    busy = sum(t for t, _ in kernels.values()) / 1e6

    def ms_of(name):
        found = [t for k, (t, _) in kernels.items() if name in k]
        if not found:
            raise AssertionError(f"{phase}: no kernel named {name} ran in "
                                 "the profiled step")
        return sum(found) / 1e3

    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]
    k3 = {}
    if attention:
        bwd = {name: ms_of(name) for name in K3_BWD_KERNELS[torch.bfloat16]}
        k3 = {"flash_attention_ms": ms_of("flash_mma_lse_kernel"),
              "flash_attention_bwd_ms": sum(bwd.values()),
              "flash_attention_bwd_kernels_ms": bwd}
    emit(phase=phase, what=what, loss=loss, wall_ms=1e3 * wall,
         device_ms=1e3 * busy,
         launches=sum(c for _, c in kernels.values()),
         idle_share=1.0 - busy / wall, **k3,
         top_kernels={k[:80]: {"us": t, "count": c} for k, (t, c) in top})
    del state


def phase_train_parity() -> dict:
    """smollm-360m at full width, 2 layers, f32 compute, batch 2, seq 128, 5
    steps from one seed, on the card and on the CPU: per-step losses and
    grad norms within `TRAIN_BARS`; the card launches K3's and K3-bwd's f32
    kernels (2 and 1 a layer a step), the CPU none."""
    import tempfile

    from repro_torch.configs.base import get_config
    from repro_torch.launch import train

    cfg = dataclasses.replace(get_config("smollm-360m"), num_layers=2,
                              compute_dtype="float32")
    runs, launches = {}, {}
    for device in ("cuda", "cpu"):
        with tempfile.TemporaryDirectory() as ckpt_dir:
            args = train.parse_args([*TRAIN_PARITY_ARGV, "--ckpt-dir",
                                     ckpt_dir, "--device", device])
            _train_counts_reset()
            runs[device] = train.train(cfg, args)
            launches[device] = _train_counts()
    card, cpu = runs["cuda"], runs["cpu"]
    gn = {d: [m["grad_norm"] for m in r.metrics_log] for d, r in runs.items()}
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(card.losses,
                                                        cpu.losses))
    gn_err = max(abs(a - b) / abs(b) for a, b in zip(gn["cuda"], gn["cpu"]))
    n = len(card.losses)
    expected = {"flash_attention": 2 * cfg.num_layers * n,
                "flash_attention_bwd": cfg.num_layers * n, "tiled_matmul": 0}
    emit(phase="train_parity", layers=cfg.num_layers, compute_dtype="float32",
         argv=list(TRAIN_PARITY_ARGV), card_losses=card.losses,
         cpu_losses=cpu.losses, card_grad_norms=gn["cuda"],
         cpu_grad_norms=gn["cpu"], max_loss_rel_err=loss_err,
         max_grad_norm_rel_err=gn_err, bars=TRAIN_BARS,
         card_wall_s=card.wall_s, cpu_wall_s=cpu.wall_s,
         launches=launches["cuda"], cpu_launches=launches["cpu"],
         restarts=len(card.restarts) + len(cpu.restarts))
    if card.restarts or cpu.restarts:
        raise AssertionError("a parity run restarted")
    if launches["cuda"] != expected or any(launches["cpu"].values()):
        raise AssertionError(f"train_parity launches: card {launches['cuda']}"
                             f" (expected {expected}), CPU {launches['cpu']}")
    if not (loss_err <= TRAIN_BARS["loss"]
            and gn_err <= TRAIN_BARS["grad_norm"]):
        raise AssertionError(f"card and CPU training differ: losses "
                             f"{loss_err}, grad norms {gn_err}")
    return {"launches": launches["cuda"]}


def phase_train_resume() -> dict:
    """smollm-360m at full width, 2 layers, bf16, 12 steps saving every 5,
    once without a fault and once with an InjectedFault at step 8: exactly
    one restart, from step 5, and the replayed losses and the final
    parameters and optimizer state equal the uninterrupted run's bit for
    bit."""
    import tempfile

    from repro_torch.configs.base import get_config
    from repro_torch.launch import train

    cfg = dataclasses.replace(get_config("smollm-360m"), num_layers=2)
    runs = {}
    for name, faults in (("clean", None), ("faulted", {TRAIN_RESUME_FAULT})):
        with tempfile.TemporaryDirectory() as ckpt_dir:
            args = train.parse_args([*TRAIN_RESUME_ARGV, "--ckpt-dir",
                                     ckpt_dir, "--device", "cuda"])
            runs[name] = train.train(cfg, args, fault_schedule=faults)
    clean, faulted = runs["clean"], runs["faulted"]
    last = {m["step"]: m["loss"] for m in faulted.metrics_log}
    replayed = [m["loss"] for m in faulted.metrics_log][
        TRAIN_RESUME_FAULT:]
    same_losses = [last[s] for s in range(len(clean.losses))] == clean.losses
    same_replay = replayed == clean.losses[5:]
    same_params = all(torch.equal(p, faulted.state["params"][k])
                      for k, p in clean.state["params"].items())
    same_opt = all(torch.equal(clean.state["opt"][part][k],
                               faulted.state["opt"][part][k])
                   for part in ("mu", "nu")
                   for k in clean.state["opt"][part])
    emit(phase="train_resume", layers=cfg.num_layers,
         compute_dtype=cfg.compute_dtype, argv=list(TRAIN_RESUME_ARGV),
         fault_at=TRAIN_RESUME_FAULT,
         restarts=[{"from_step": r["from_step"], "error": r["error"]}
                   for r in faulted.restarts],
         clean_restarts=len(clean.restarts), losses=clean.losses,
         replayed_losses=replayed, same_losses=same_losses,
         same_replay=same_replay, same_params=same_params,
         same_opt_state=same_opt, clean_wall_s=clean.wall_s,
         faulted_wall_s=faulted.wall_s,
         save_seconds=[{"step": st, "host_copy_s": c, "write_s": w}
                       for st, c, w in clean.save_seconds])
    if clean.restarts or [r["from_step"] for r in faulted.restarts] != [5]:
        raise AssertionError(f"restarts: clean {clean.restarts}, faulted "
                             f"{faulted.restarts} (expected one, from 5)")
    if not (same_losses and same_replay and same_params and same_opt):
        raise AssertionError(f"the replay after the fault is not bit-equal: "
                             f"losses {same_losses}, replay {same_replay}, "
                             f"params {same_params}, opt {same_opt}")
    return {"restarts": len(faulted.restarts)}


# --------------------------------------------------------- the sharding layer


@contextlib.contextmanager
def one_rank_world():
    """A default process group of one rank with gloo for CPU tensors and
    NCCL for CUDA ones (the sharded phases' (1, 1) meshes), destroyed on
    exit with its store."""
    import tempfile

    import torch.distributed as dist

    with tempfile.TemporaryDirectory(prefix="chip_smoke_pg.") as d:
        dist.init_process_group("cpu:gloo,cuda:nccl",
                                init_method=f"file://{d}/store", rank=0,
                                world_size=1)
        try:
            yield
        finally:
            dist.destroy_process_group()


def phase_sharded_train(train_losses) -> dict:
    """The train phase's first SHARDED_TRAIN_STEPS steps through the
    sharding layer on a (1, 1) NCCL mesh: the same config, optimizer
    schedule, seed and batches, with the state and batch as DTensors and
    the model's mesh branches taken.  Losses within SHARDED_TRAIN_BAR
    relative of the train phase's; K3 and K3-bwd launched as many times a
    step as there (2 and 1 a layer)."""
    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticSource
    from repro_torch.launch import steps, train
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim import adamw
    from repro_torch.parallel import sharding

    cfg = get_config("smollm-360m")
    args = train.parse_args(list(TRAIN_ARGV))
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    opt_cfg = train.opt_config(cfg, args)
    mesh = make_mesh((1, 1), ("data", "model"), "cuda")
    rules = sharding.AxisRules()
    source = SyntheticSource(cfg, shape, DataConfig(seed=args.seed))
    n = SHARDED_TRAIN_STEPS
    with sharding.use_mesh(mesh, rules):
        model, step_fn = steps.make_train_step(cfg, opt_cfg, "cuda")
        state = steps.init_train_state(
            model, cfg, opt_cfg, torch.Generator().manual_seed(args.seed))
        params = steps.distribute(state["params"], steps.state_shardings(
            model, mesh, rules)["params"], mesh)
        state = {"params": params, "opt": adamw.init_state(opt_cfg, params)}
        bshd = steps.batch_sharding(cfg, shape, mesh, rules)
        losses, gnorms, dts = [], [], []
        torch.cuda.reset_peak_memory_stats()
        _train_counts_reset()
        for i in range(n):
            batch = steps.distribute(
                {k: torch.as_tensor(v, device="cuda")
                 for k, v in source.batch(i).items()}, bshd, mesh)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step_fn(state, batch)
            losses.append(float(m["loss"].full_tensor()))
            gnorms.append(float(m["grad_norm"].full_tensor()))
            dts.append(time.perf_counter() - t0)
        launches = _train_counts()
    want = train_losses[:n]
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, want))
    expected = {"flash_attention": 2 * cfg.num_layers * n,
                "flash_attention_bwd": cfg.num_layers * n, "tiled_matmul": 0}
    emit(phase="sharded_train", arch=cfg.name, layers=cfg.num_layers,
         compute_dtype=cfg.compute_dtype, mesh={"data": 1, "model": 1},
         backend="nccl", rules=dataclasses.asdict(rules), steps=n,
         losses=losses, train_losses=want, grad_norms=gnorms,
         max_rel_loss_diff=rel, bar=SHARDED_TRAIN_BAR,
         first_step_ms=1e3 * dts[0],
         median_step_ms=1e3 * statistics.median(dts[1:]),
         launches=launches, expected=expected,
         peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    del state, model, step_fn
    torch.cuda.empty_cache()
    if not rel <= SHARDED_TRAIN_BAR:
        raise AssertionError(f"sharded_train losses {losses} differ from the "
                             f"train phase's {want} by {rel:.3e} relative")
    if launches != expected:
        raise AssertionError(f"sharded_train launched {launches}, expected "
                             f"{expected}")
    return {"launches": launches}


def phase_sharded_moe() -> dict:
    """moonshot at full width, SHARDED_MOE_LAYERS layers, f32 compute and
    cache, on a (1, 1) mesh on the card (NCCL) and on the CPU (gloo), from
    one draw (on the card, copied to the host).  The shard-map branch
    itself: layer 0's `moe_block` on one input of SHARDED_MOE_TOKENS tokens,
    card against CPU within SHARDED_MOE_BAR of the largest output plus one
    bf16 ulp of each, 2^-7 of it at most (the reference sums the experts'
    partial outputs in
    bf16, `src/repro/models/moe.py:122-124`: a last-bit difference of the
    f32 partials can round a sum to the neighbouring bf16 value), two card
    calls bit-equal.  Then a prefill of the same length through the whole
    model on each: the branch taken once a layer on each side (a gathered
    call in `moe.STATS`), K3 f32 launched once a layer on the card, the
    last-position logits' difference reported."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe
    from repro_torch.models.model import build_model
    from repro_torch.parallel import sharding

    cfg = dataclasses.replace(get_config("moonshot-v1-16b-a3b"),
                              num_layers=SHARDED_MOE_LAYERS,
                              compute_dtype="float32",
                              kv_cache_dtype="float32")
    g = torch.Generator("cuda").manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, SHARDED_MOE_TOKENS,
                           generator=g, device="cuda")
    x = torch.randn((*SHARDED_MOE_TOKENS, cfg.d_model), generator=g,
                    device="cuda")
    rules = sharding.AxisRules()
    branch, logits, stats, secs = {}, {}, {}, {}
    for dev in ("cuda", "cpu"):
        model = build_model(cfg, dev)
        if dev == "cuda":
            model.init(g)
            params_cpu = {k: p.detach().cpu()
                          for k, p in model.named_parameters()}
        mesh = make_mesh((1, 1), ("data", "model"), dev)
        with sharding.use_mesh(mesh, rules):
            params = steps.distribute(
                {k: p.to(dev) for k, p in params_cpu.items()},
                steps.state_shardings(model, mesh, rules, opt=False), mesh)
            batch_spec = sharding.logical_spec(mesh, rules, ("batch", None))
            xd = steps.distribute(x.to(dev), batch_spec + (None,), mesh)
            mp = {k[len("blocks.0.moe."):]: t for k, t in params.items()
                  if k.startswith("blocks.0.moe.")}
            with torch.no_grad():
                runs = [moe.moe_block(mp, cfg, xd).full_tensor().cpu()
                        for _ in range(2 if dev == "cuda" else 1)]
            branch[dev] = runs
            batch = steps.distribute({"tokens": tokens.to(dev)},
                                     {"tokens": batch_spec}, mesh)
            _lm_counts_reset()
            t0 = time.perf_counter()
            out, _ = model.prefill(batch, params)
            logits[dev] = out.full_tensor().float().cpu()
            secs[dev] = time.perf_counter() - t0
            stats[dev] = _lm_counts()
        del model, params, mp
        torch.cuda.empty_cache()
    card, cpu = branch["cuda"][0], branch["cpu"][0]
    diff = (card - cpu).abs()
    scale = float(cpu.abs().max())
    allowed = SHARDED_MOE_BAR * scale + 2.0 ** -7 * cpu.abs()
    beyond = int((diff > SHARDED_MOE_BAR * scale).sum())
    same = torch.equal(branch["cuda"][0], branch["cuda"][1])
    calls = {dev: stats[dev]["moe"]["gathered"] for dev in stats}
    k3 = stats["cuda"]["flash_attention"]
    lerr = float((logits["cuda"] - logits["cpu"]).abs().max())
    emit(phase="sharded_moe", arch=cfg.name, layers=cfg.num_layers,
         compute_dtype=cfg.compute_dtype, mesh={"data": 1, "model": 1},
         tokens=list(SHARDED_MOE_TOKENS), experts=cfg.num_experts,
         top_k=cfg.top_k, branch_max_abs_err=float(diff.max()),
         branch_max_abs=scale, bar=SHARDED_MOE_BAR,
         bar_note="1e-5 of the largest plus one bf16 ulp of each element "
                  "(2^-7 of it at most: the bf16 combine)",
         elements_beyond_1e5=beyond, elements=diff.numel(),
         branch_repeat_bit_equal=same,
         logits_max_abs_err=lerr,
         max_abs_logit=float(logits["cpu"].abs().max()),
         shard_map_calls=calls,
         masked_calls={dev: stats[dev]["moe"]["masked"] for dev in stats},
         flash_attention_launches=k3, card_prefill_s=secs["cuda"],
         cpu_prefill_s=secs["cpu"])
    if not bool((diff <= allowed).all()):
        raise AssertionError(f"sharded_moe: the card's branch differs from "
                             f"the CPU's by {float(diff.max()):.3e} "
                             f"(largest {scale:.3e})")
    if not same:
        raise AssertionError("sharded_moe: two card calls differ")
    if calls != {"cuda": cfg.num_layers, "cpu": cfg.num_layers}:
        raise AssertionError(f"sharded_moe: the shard-map branch ran "
                             f"{calls} times in the prefill, expected once "
                             "a layer")
    if k3 != cfg.num_layers or not torch.isfinite(logits["cuda"]).all():
        raise AssertionError(f"sharded_moe: {k3} K3 launches (expected "
                             f"{cfg.num_layers}) or non-finite logits")
    return {"launches": k3}


def _lowest_priority() -> None:
    os.nice(19)


def start_host_phases() -> dict:
    """Start the dry-run (a runner process a group of `DRYRUN_GROUPS`) and
    the autotuner, each process mostly on one of the host's CPU cores at
    the lowest priority (fake tensors; the autotuner's GP on the card),
    while the card's phases run; `phase_dryrun` and `phase_autotune` read
    them at the end."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = {}
    script = ("import json, subprocess, sys, time\n"
              "for arch, shape in json.loads(sys.argv[1]):\n"
              "    t0 = time.perf_counter()\n"
              "    p = subprocess.run([sys.executable, '-m', "
              "'repro_torch.launch.dryrun', '--arch', arch, '--shape', "
              "shape, '--json', '--strict'], capture_output=True, "
              "text=True)\n"
              "    print(json.dumps({'arch': arch, 'shape': shape, "
              "'rc': p.returncode, 'wall_s': time.perf_counter() - t0, "
              "'stdout': p.stdout[-20000:], 'stderr': p.stderr[-4000:]}), "
              "flush=True)\n")
    procs["dryrun"] = [_start_host([sys.executable, "-c", script,
                                    json.dumps(group)], env)
                       for group in DRYRUN_GROUPS]
    procs["autotune"] = _start_host(
        [sys.executable, "-m", "repro_torch.core.autotune", *AUTOTUNE_ARGV,
         "--json"], env)
    return procs


def _start_host(argv, env):
    """(start time, process, its stdout and stderr files): the output goes
    to temporary files, not pipes, so a child never blocks on a full pipe
    while the card's phases run."""
    import tempfile

    out, err = (tempfile.TemporaryFile(mode="w+") for _ in "oe")
    proc = subprocess.Popen(argv, env=env, cwd=ROOT, stdout=out, stderr=err,
                            text=True, preexec_fn=_lowest_priority)
    return time.perf_counter(), proc, out, err


def _finish(proc, out, err, timeout: float):
    """Wait for a host phase (killing it after `timeout` s) and read its
    stdout and stderr."""
    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        err.seek(0)
        raise AssertionError(f"host phase still running after {timeout} s: "
                             f"{err.read()[-2000:]}")
    texts = []
    for f in (out, err):
        f.seek(0)
        texts.append(f.read())
        f.close()
    return texts


def phase_dryrun(runners) -> dict:
    """The dry-run cells' records (`DRYRUN_CELLS`, from the runners of
    `DRYRUN_GROUPS`): memory a device, fits_hbm, roofline terms and bound,
    MFU estimate, trace seconds, whether the counts were extrapolated from
    depths 1 and 2; every applicable cell must trace and fit in HBM."""
    started = min(r[0] for r in runners)
    lines = []
    for _, proc, out, err in runners:
        out, err = _finish(proc, out, err, 900)
        if proc.returncode != 0:
            raise AssertionError(f"dryrun runner exited {proc.returncode}: "
                                 f"{err[-2000:]}")
        lines += out.splitlines()
    cells = []
    for line in lines:
        run = json.loads(line)
        rec = next((json.loads(x) for x in run["stdout"].splitlines()
                    if x.startswith("{")), None)
        skipped = next((x for x in run["stdout"].splitlines()
                        if x.startswith("SKIP")), None)
        cell = {"arch": run["arch"], "shape": run["shape"], "rc": run["rc"],
                "process_s": run["wall_s"]}
        if rec is not None:
            r = rec["roofline"]
            cell.update(
                mesh=rec["mesh"], trace_s=rec["compile_s"],
                extrapolated=rec["extrapolated"],
                memory_gib_per_dev=rec["memory"]["total_gib_per_dev"],
                fits_hbm=rec["memory"]["fits_hbm"],
                compute_s=r["compute_s"], memory_s=r["memory_s"],
                collective_s=r["collective_s"], bound=r["bound"],
                step_time_s=r["step_time_s"],
                mfu_estimate=rec["mfu_estimate"],
                useful_flops_ratio=rec["useful_flops_ratio"],
                collectives=rec["collectives"])
        elif skipped:
            cell["skipped"] = skipped
        else:
            cell["stderr"] = run["stderr"][-2000:]
        cells.append(cell)
    emit(phase="dryrun", wall_s=time.perf_counter() - started, cells=cells)
    bad = [c for c in cells if c["rc"] != 0
           or ("skipped" not in c and not c.get("fits_hbm"))]
    if bad or len(cells) != len(DRYRUN_CELLS):
        raise AssertionError(f"dryrun cells failed: {bad}")
    return {"cells": cells}


def phase_autotune(started, proc, out, err) -> dict:
    """The autotuner's result: the best TuneConfig, its estimated step time,
    every trial, the wall."""
    out, err = _finish(proc, out, err, 900)
    if proc.returncode != 0:
        raise AssertionError(f"autotune exited {proc.returncode}: "
                             f"{err[-2000:]}")
    res = json.loads(out.splitlines()[-1])
    emit(phase="autotune", process_wall_s=time.perf_counter() - started,
         argv=list(AUTOTUNE_ARGV), **res)
    if res["best"] is None or not res["best_step_time_s"] > 0:
        raise AssertionError(f"autotune found no feasible point: {res}")
    return res


# ---------------------------------------------- the block kinds and families


def _lm_counts_reset() -> None:
    from repro_torch.models import moe

    _train_counts_reset()
    moe.STATS.reset()


def _lm_counts() -> dict:
    from repro_torch.models import moe

    return {**_train_counts(), "moe": moe.STATS.read()}


def _tokens_valid(done, cfg, args) -> bool:
    tokens = [r.out_tokens for r in done]
    return (len(done) == args.requests
            and all(len(t) == args.gen_len for t in tokens)
            and all(0 <= t[0] < cfg.padded_vocab() for t in tokens)
            and all(0 <= x < cfg.vocab_size for t in tokens for x in t[1:]))


def serve_on_card(phase: str, cfg, argv, expected_k3: int, **extra) -> dict:
    """`serve.serve` of `cfg` on the card, its counts from 0: wall, prefill
    and decode-step ms, tok/s, peak memory, K3 launches against
    `expected_k3`, the MoE paths' calls and overflowing experts; the tokens
    must be valid ids of the expected count.  Weights are drawn on the card
    by a CUDA generator on the seed."""
    from repro_torch.launch import serve

    args = serve.parse_args([*argv, "--device", "cuda"])
    gen = torch.Generator("cuda").manual_seed(args.seed)
    torch.cuda.reset_peak_memory_stats()
    _lm_counts_reset()
    t0 = time.perf_counter()
    done, stats = serve.serve(cfg, args, generator=gen)
    total = time.perf_counter() - t0
    counts = _lm_counts()
    valid = _tokens_valid(done, cfg, args)
    emit(phase=phase, arch=cfg.name, layers=cfg.num_layers,
         compute_dtype=cfg.compute_dtype, kv_cache_dtype=cfg.kv_cache_dtype,
         argv=list(argv), **stats, init_and_serve_s=total,
         weights_on="card",
         launches=counts, expected_flash_launches=expected_k3,
         first_tokens={r.rid: r.out_tokens[:8] for r in done[:3]},
         valid_tokens=valid,
         peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
         **extra)
    if counts["flash_attention"] != expected_k3:
        raise AssertionError(f"{phase}: {counts['flash_attention']} K3 "
                             f"launches, expected {expected_k3}")
    if not valid:
        raise AssertionError(f"{phase}: served tokens are not valid ids of "
                             "the expected count")
    torch.cuda.empty_cache()
    return {"counts": counts, "stats": stats, "args": args,
            "tokens": [r.out_tokens for r in done]}


def phase_serve_moe() -> dict:
    """moonshot-v1-16b-a3b at its full published config served on the card
    (bf16, weights drawn on the card): K3 once a prefill layer (2 batches x
    2 prefills x 48 layers = 192), the gathered MoE path in every prefill
    layer and the masked one in every decode layer."""
    from repro_torch.configs.base import get_config

    cfg = get_config("moonshot-v1-16b-a3b")
    n_batches = 2
    out = serve_on_card("serve_moe", cfg, MOE_ARGV,
                        n_batches * 2 * cfg.num_layers)
    moe, args = out["counts"]["moe"], out["args"]
    want = {"gathered": n_batches * 2 * cfg.num_layers,
            "masked": n_batches * args.gen_len * cfg.num_layers}
    if {k: moe[k] for k in want} != want:
        raise AssertionError(f"serve_moe MoE calls {moe}, expected {want}")
    return {"launches": out["counts"]["flash_attention"], "cfg": cfg,
            "args": args}


def phase_serve_moe_profile(cfg, args) -> None:
    """One S_max prefill and 8 decode steps of moonshot at its full config
    under torch.profiler (`phase_serve_profile`), the weights drawn on the
    card again."""
    from repro_torch.models.model import build_model

    model = build_model(cfg, "cuda").init(
        torch.Generator("cuda").manual_seed(args.seed))
    phase_serve_profile(model, cfg, args, phase="serve_moe_profile")
    del model
    torch.cuda.empty_cache()


def phase_serve_moe_parity() -> dict:
    """moonshot at full width, 2 layers, f32, served on the card and on the
    CPU from one CPU seed: equal tokens; on the card K3 f32 once a prefill
    layer, the gathered path in prefill (T 1280) and the masked one in
    decode (T 2)."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import serve

    cfg = dataclasses.replace(get_config("moonshot-v1-16b-a3b"),
                              num_layers=MOE_PARITY_LAYERS,
                              compute_dtype="float32",
                              kv_cache_dtype="float32")
    runs = {}
    torch.cuda.reset_peak_memory_stats()
    for device in ("cuda", "cpu"):
        args = serve.parse_args([*MOE_PARITY_ARGV, "--device", device])
        _lm_counts_reset()
        done, stats = serve.serve(cfg, args)
        runs[device] = ([r.out_tokens for r in done], stats, _lm_counts())
    card, cpu = runs["cuda"], runs["cpu"]
    expected = {"flash_attention": 2 * cfg.num_layers,
                "gathered": 2 * cfg.num_layers,
                "masked": args.gen_len * cfg.num_layers}
    got = {"flash_attention": card[2]["flash_attention"],
           "gathered": card[2]["moe"]["gathered"],
           "masked": card[2]["moe"]["masked"]}
    same = card[0] == cpu[0]
    emit(phase="serve_moe_parity", layers=cfg.num_layers,
         compute_dtype="float32", argv=list(MOE_PARITY_ARGV),
         card_wall_s=card[1]["wall_s"], cpu_wall_s=cpu[1]["wall_s"],
         card_prefill_ms=card[1]["prefill_ms"],
         card_decode_step_ms=card[1]["decode_step_ms"],
         card_tok_s=card[1]["tok_s"],
         peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
         same_tokens=same, tokens=card[0], launches=card[2],
         cpu_launches=cpu[2], expected=expected)
    if got != expected:
        raise AssertionError(f"serve_moe_parity launches {got}, expected "
                             f"{expected}")
    if not same:
        raise AssertionError(f"card and CPU served different tokens: "
                             f"{card[0]} vs {cpu[0]}")
    torch.cuda.empty_cache()
    return {"launches": got["flash_attention"]}


def phase_serve_llama4() -> dict:
    """llama4-maverick at full width, one ("attn", "moe") period (2 of 48
    layers), bf16, weights drawn on the card: K3 in both layers of each
    prefill, top-1 routing over 128 experts with at least one expert over
    capacity in prefill."""
    from repro_torch.configs.base import get_config

    cfg = dataclasses.replace(get_config("llama4-maverick-400b-a17b"),
                              num_layers=LLAMA4_LAYERS)
    out = serve_on_card("serve_llama4", cfg, LLAMA4_ARGV, 2 * cfg.num_layers)
    moe = out["counts"]["moe"]
    if moe["gathered"] != 2 or moe["overflowed_experts"] < 1:
        raise AssertionError(f"serve_llama4: MoE calls {moe} (expected 2 "
                             "gathered prefills and an expert over capacity)")
    return {"launches": out["counts"]["flash_attention"]}


def _model_pair(cfg, generator_seed: int = 0):
    """The same f32 weights (drawn once on the CPU) on the CPU and on the
    card."""
    from repro_torch.models.model import build_model

    cpu = build_model(cfg, "cpu").init(
        torch.Generator().manual_seed(generator_seed))
    card = build_model(cfg, "cuda")
    card.load_state_dict(cpu.state_dict())
    return card, cpu


def _close(got, want) -> float:
    """max|got - want| over max|want|, on the host."""
    got, want = got.float().cpu(), want.float().cpu()
    scale = float(want.abs().max()) or 1.0
    return float((got - want).abs().max()) / scale


def hybrid_parity() -> dict:
    """(rglru, rglru, local_attn) at recurrentgemma's full width, window
    256, f32, on the card and the CPU: a prefill of 320 tokens and 8 decode
    steps past it; logits, the RG-LRU states and the rolling caches within
    `FAMILY_BAR`, pos_ids equal."""
    from repro_torch.configs.base import get_config

    hp = HYBRID_PARITY
    cfg = dataclasses.replace(get_config("recurrentgemma-9b"), num_layers=3,
                              block_pattern=("rglru", "rglru", "local_attn"),
                              local_window=hp["window"],
                              compute_dtype="float32",
                              kv_cache_dtype="float32")
    card, cpu = _model_pair(cfg)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (hp["B"], hp["S"]))
    steps = rng.integers(0, cfg.vocab_size, (hp["steps"], hp["B"], 1))
    errs, runs = {}, {}
    for name, model in (("cuda", card), ("cpu", cpu)):
        logits, cache = model.prefill({"tokens": toks})
        outs = [logits]
        for i, t in enumerate(steps):
            logits, cache = model.decode_step(cache, {"tokens": t},
                                              hp["S"] + i)
            outs.append(logits)
        runs[name] = (outs, cache)
    errs["logits"] = max(_close(a, b) for a, b in zip(runs["cuda"][0],
                                                      runs["cpu"][0]))
    for i, (a, b) in enumerate(zip(runs["cuda"][1], runs["cpu"][1])):
        for k in b:
            if k == "pos_ids":
                if not torch.equal(a[k].cpu(), b[k]):
                    raise AssertionError(f"hybrid parity: layer {i} pos_ids "
                                         "differ")
            else:
                errs[f"layer{i}.{k}"] = _close(a[k], b[k])
    del card, cpu
    torch.cuda.empty_cache()
    if not max(errs.values()) <= FAMILY_BAR:
        raise AssertionError(f"hybrid card vs CPU beyond {FAMILY_BAR}: {errs}")
    return {"cut": {"layers": 3, "window": hp["window"]}, **hp,
            "max_err": errs, "bar": FAMILY_BAR}


def phase_serve_hybrid() -> dict:
    """recurrentgemma-9b at its full config (38 layers, bf16, weights drawn
    on the card), prompt 2560, 64 generated: valid tokens, no K3 (local
    attention and RG-LRU stay plain PyTorch, as in the reference); then
    `hybrid_parity`."""
    from repro_torch.configs.base import get_config

    cfg = get_config("recurrentgemma-9b")
    out = serve_on_card("serve_hybrid", cfg, HYBRID_ARGV, 0)
    emit(phase="serve_hybrid_parity", **hybrid_parity())
    return out


def phase_serve_xlstm() -> dict:
    """xlstm-1.3b at its full config (48 layers, bf16, weights drawn on the
    card), prompt 1024, 256 generated: valid tokens, no K3, every sLSTM
    layer's prefill and decode steps through the registered op
    `repro_torch::slstm_scan` (its calls counted, none of its backward);
    and the device launches and time of one sLSTM step
    (`slstm_scan._slstm_step`) at the served batch, of which the op runs S a
    call."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import slstm_scan, xlstm

    cfg = get_config("xlstm-1.3b")
    B = 8
    carry = xlstm.init_slstm_state(cfg, B, "cuda")
    H, D = cfg.num_heads, cfg.d_model
    g = torch.Generator("cuda").manual_seed(0)
    r = {k: torch.randn((H, D // H, D // H), generator=g, device="cuda")
         for k in "ifzo"}
    gates = {k: torch.randn((B, D), generator=g, device="cuda")
             for k in "ifzo"}

    def step():
        return slstm_scan._slstm_step(r, carry, gates, H)

    launches, profiler_ms = launch_profile(step)
    ms = device_ms(step)
    n_slstm = sum(k == "slstm" for k in cfg.block_pattern) * (
        cfg.num_layers // len(cfg.block_pattern))
    slstm_scan.CALLS.update(forward=0, backward=0)
    rec = serve_on_card("serve_xlstm", cfg, XLSTM_ARGV, 0,
                        slstm_step={"device_ms": ms,
                                    "profiler_ms": profiler_ms,
                                    "launches": launches, "layers": n_slstm})
    calls = dict(slstm_scan.CALLS)
    emit(phase="serve_xlstm_op", slstm_scan_calls=calls)
    if not (calls["forward"] > 0 and calls["forward"] % n_slstm == 0
            and calls["backward"] == 0):
        raise AssertionError(f"serve_xlstm: sLSTM op calls {calls} for "
                             f"{n_slstm} sLSTM layers")
    return rec


def phase_slstm_op() -> dict:
    """The registered sLSTM op (`repro_torch::slstm_scan` and its backward)
    at xlstm-1.3b's full width (`SLSTM_OP_SHAPE`, f32, from the block's own
    zero state): its forward bit-equal to the plain loop on the card, and
    to itself on a second call; its backward within `SLSTM_GRAD_BAR` of
    the largest gradient of autograd through the loop in f64 (beside it
    the op's and the f32 loop's own distances: the f32 loop sums the
    recurrent weights' gradient step by step over S, the op in one
    product, and at S 1024 the loop is the one further from f64); device
    ms (one profiler session), call ms (CUDA events around eager calls,
    host included) and device launches of one forward and of one backward
    call, with the recurrent products' bound."""
    from repro_torch.models import slstm_scan as SS

    B, S, H, dh = SLSTM_OP_SHAPE
    D = H * dh
    t0 = time.perf_counter()
    g = torch.Generator("cuda").manual_seed(11)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device="cuda") * scale

    gates = {k: randn(B, S, D) for k in SS.GATES}
    r = {k: randn(H, dh, dh, scale=dh ** -0.5) for k in SS.GATES}
    carry = {"h": torch.zeros(B, H, dh, device="cuda"),
             "c": torch.zeros(B, H, dh, device="cuda"),
             "n": torch.zeros(B, H, dh, device="cuda"),
             "m": torch.full((B, H, dh), -1e30, device="cuda")}
    dhs = randn(B, S, H, dh)
    dcarry = {k: randn(B, H, dh) for k in SS.CARRY}
    plain = SS._slstm_scan_plain(r, carry, gates, H)
    runs = [SS.slstm_scan(r, carry, gates, H) for _ in range(2)]

    def same(a, b):
        return torch.equal(a[0], b[0]) and all(torch.equal(a[1][k], b[1][k])
                                               for k in SS.CARRY)

    bit_equal, repeat = same(runs[0], plain), same(runs[0], runs[1])
    del plain, runs

    def grads(fn, dtype=torch.float32):
        leaves = [t.to(dtype, copy=True).requires_grad_() for t in
                  (*gates.values(), *r.values(), *carry.values())]
        gg, rr = dict(zip(SS.GATES, leaves[:4])), dict(zip(SS.GATES,
                                                           leaves[4:8]))
        hs, last = fn(rr, dict(zip(SS.CARRY, leaves[8:])), gg, H)
        outs = [hs, *(last[k] for k in SS.CARRY)]
        return torch.autograd.grad(
            outs, leaves, [t.to(dtype) for t in
                           (dhs, *(dcarry[k] for k in SS.CARRY))],
            allow_unused=True)

    got = grads(SS.slstm_scan)
    loop32 = grads(SS._slstm_scan_plain)
    exact = grads(SS._slstm_scan_plain, torch.float64)

    def err_to(a, b):
        return max(float((x.double() - y.double()).abs().max())
                   for x, y in zip(a, b) if y is not None)

    parts = {"gates": slice(0, 4), "weights": slice(4, 8),
             "carry": slice(8, 12)}
    by_part = {name: {"op": err_to(got[sl], exact[sl]),
                      "f32_loop": err_to(loop32[sl], exact[sl]),
                      "max_abs": max(float(w.abs().max())
                                     for w in exact[sl] if w is not None)}
               for name, sl in parts.items()}

    top = max(float(w.abs().max()) for w in exact if w is not None)
    err, err_loop32, loop32_err = (err_to(got, exact), err_to(got, loop32),
                                   err_to(loop32, exact))
    del got, loop32, exact
    args = (*gates.values(), *r.values(), *carry.values())

    def fwd():
        return SS._scan_op(*args, H)

    def bwd():
        return SS._scan_bwd_op(*args, dhs, *dcarry.values(), H, False)

    timing = {"check_s": time.perf_counter() - t0}
    for name, fn in (("forward", fwd), ("backward", bwd)):
        t0 = time.perf_counter()
        launches, profiler_ms = launch_profile(fn, reps=1, device_only=True)
        timing[name] = {"ms": profiler_ms, "call_ms": cuda_ms(fn, reps=2,
                                                              warmup=0),
                        "launches": launches,
                        "phase_s": time.perf_counter() - t0}
    flops = SS.scan_flops(B, S, H, dh)
    n_bytes = (4 * B * S * D + 4 * H * dh * dh + 4 * B * D + B * S * D
               + 4 * B * D) * 4
    emit(phase="slstm_op", shape=dict(zip(("B", "S", "H", "dh"),
                                          SLSTM_OP_SHAPE)),
         dtype="float32", forward_bit_equal=bit_equal, repeat_bit_equal=repeat,
         grad_max_abs_err=err, grad_max_abs=top, grad_bar=SLSTM_GRAD_BAR,
         grad_vs_f32_loop_max_abs_err=err_loop32,
         f32_loop_vs_f64_max_abs_err=loop32_err, grad_errors_by_part=by_part,
         timing=timing, flops=flops, backward_flops=3 * flops - SS.scan_flops(
             B, 1, H, dh), bound=_bound(n_bytes, flops, torch.float32))
    if not (bit_equal and repeat):
        raise AssertionError(f"slstm_op: forward bit-equal to the loop "
                             f"{bit_equal}, to itself {repeat}")
    if not err <= SLSTM_GRAD_BAR * top:
        raise AssertionError(f"slstm_op: backward {err} from autograd "
                             f"through the loop in f64 (largest gradient "
                             f"{top})")
    return timing


def _xlstm_train_config(compute_dtype=None, chunk=None):
    from repro_torch.configs.base import get_config

    cfg = get_config("xlstm-1.3b")
    kw = {"num_layers": len(cfg.block_pattern) * TRAIN_XLSTM_PERIODS}
    if compute_dtype:
        kw["compute_dtype"] = compute_dtype
    if chunk:
        kw["mlstm_chunk"] = chunk
    return dataclasses.replace(cfg, **kw)


def phase_train_xlstm() -> dict:
    """xlstm-1.3b at full width, one period (8 layers: 7 mLSTM, 1 sLSTM),
    the train phase's precision and block remat, batch 8 x seq 1024, 5
    steps through `launch.train.train` (weights from the seed): the last
    loss below the first; its first `TRAIN_XLSTM_REPEAT` steps repeated
    bit-equal (losses and grad norms); the sLSTM op 2 forwards (forward and
    recompute) and 1 backward a step; median step ms; one step profiled
    (device ms, launches, idle share; the device's activity alone); and
    card against CPU in f32 at batch 1 x seq 128, losses within
    `TRAIN_BARS["loss"]`."""
    import tempfile

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticSource
    from repro_torch.launch import steps, train
    from repro_torch.models import slstm_scan

    cfg = _xlstm_train_config()
    n_slstm = sum(k == "slstm" for k in cfg.block_pattern) * \
        TRAIN_XLSTM_PERIODS
    runs, calls, seconds = [], [], {}
    torch.cuda.reset_peak_memory_stats()
    for name, steps_run in (("run", None), ("repeat", TRAIN_XLSTM_REPEAT)):
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as ckpt_dir:
            argv = [*TRAIN_XLSTM_ARGV, "--ckpt-dir", ckpt_dir, "--device",
                    "cuda"]
            args = train.parse_args(argv + (["--steps", str(steps_run)]
                                            if steps_run else []))
            slstm_scan.CALLS.update(forward=0, backward=0)
            runs.append(train.train(cfg, args))
            calls.append(dict(slstm_scan.CALLS))
        seconds[name] = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    run, rep = runs
    gn = [[m["grad_norm"] for m in r.metrics_log] for r in runs]
    dts = [m["dt"] for m in run.metrics_log]
    k = TRAIN_XLSTM_REPEAT
    same = rep.losses == run.losses[:k] and gn[1] == gn[0][:k]
    n = len(run.losses)

    def expected(steps_run):
        return {"forward": 2 * n_slstm * steps_run,
                "backward": n_slstm * steps_run}

    run.state = rep.state = None
    del runs
    torch.cuda.empty_cache()
    # one step under the profiler, from a fresh state
    t0 = time.perf_counter()
    opt_cfg = train.opt_config(cfg, args)
    model, step_fn = steps.make_train_step(cfg, opt_cfg, "cuda")
    state = steps.init_train_state(model, cfg, opt_cfg,
                                   torch.Generator().manual_seed(0))
    source = SyntheticSource(cfg, ShapeConfig("t", args.seq, args.batch,
                                              "train"), DataConfig(seed=0))
    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in source.batch(0).items()}
    profile_train_step(step_fn, state, batch, "train_xlstm_profile",
                       f"{cfg.name} {cfg.num_layers} layers train step B "
                       f"{args.batch} S {args.seq}", attention=False,
                       device_only=True)
    del model, step_fn, state
    torch.cuda.empty_cache()
    seconds["profile"] = time.perf_counter() - t0
    parity = {}
    pcfg = _xlstm_train_config("float32", chunk=128)
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as ckpt_dir:
            pargs = train.parse_args([*TRAIN_XLSTM_PARITY_ARGV, "--ckpt-dir",
                                      ckpt_dir, "--device", device])
            parity[device] = train.train(pcfg, pargs).losses
        seconds[f"parity_{device}"] = time.perf_counter() - t0
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(parity["cuda"],
                                                        parity["cpu"]))
    torch.cuda.empty_cache()
    med = statistics.median(dts[1:])
    emit(phase="train_xlstm", arch=cfg.name, layers=cfg.num_layers,
         periods=TRAIN_XLSTM_PERIODS, compute_dtype=cfg.compute_dtype,
         param_dtype=cfg.param_dtype, remat=cfg.remat,
         argv=list(TRAIN_XLSTM_ARGV), losses=run.losses, grad_norms=gn[0],
         first_step_ms=1e3 * dts[0], median_step_ms=1e3 * med,
         tokens_per_s=args.batch * args.seq / med, peak_memory_gib=peak,
         slstm_scan_calls=calls[0], expected_calls=expected(n),
         repeat_steps=k, repeat_bit_equal=same,
         restarts=len(run.restarts) + len(rep.restarts), seconds=seconds,
         parity={"argv": list(TRAIN_XLSTM_PARITY_ARGV), "mlstm_chunk": 128,
                 "compute_dtype": "float32", "card_losses": parity["cuda"],
                 "cpu_losses": parity["cpu"], "max_loss_rel_err": loss_err,
                 "bar": TRAIN_BARS["loss"]})
    if not (all(np.isfinite(run.losses)) and run.losses[-1] < run.losses[0]):
        raise AssertionError(f"train_xlstm losses {run.losses}")
    if run.restarts or rep.restarts:
        raise AssertionError("train_xlstm restarted")
    if not same or calls != [expected(n), expected(k)]:
        raise AssertionError(f"train_xlstm: repeat bit-equal {same}, sLSTM "
                             f"op calls {calls}, expected {expected(n)} and "
                             f"{expected(k)}")
    if not loss_err <= TRAIN_BARS["loss"]:
        raise AssertionError(f"train_xlstm: card and CPU losses differ by "
                             f"{loss_err}")
    return {"calls": calls[0]}


def _family_batch(cfg, B: int, S: int, rng, labels: bool = False) -> dict:
    """Inputs of a family: the encoder-decoder's source frames and tokens;
    the VLM's embeddings and M-RoPE positions (t, h, w distinct)."""
    batch = {}
    if cfg.family == "encdec":
        batch["src_embeddings"] = rng.normal(size=(B, max(S // 8, 16),
                                                   cfg.d_model))
        batch["tokens"] = rng.integers(0, cfg.vocab_size, (B, S))
    else:
        batch["embeddings"] = rng.normal(size=(B, S, cfg.d_model))
        t = np.arange(S)
        batch["positions"] = np.broadcast_to(
            np.stack([t, t // 16, t % 16])[:, None], (3, B, S)).copy()
    if labels:
        batch["labels"] = rng.integers(0, cfg.vocab_size, (B, S))
    return batch


def _family_steps(cfg, B: int, n: int, rng) -> list:
    if cfg.family == "encdec":
        return [{"tokens": rng.integers(0, cfg.vocab_size, (B, 1))}
                for _ in range(n)]
    return [{"embeddings": rng.normal(size=(B, 1, cfg.d_model))}
            for _ in range(n)]


def family_run(cfg, B: int, S: int, n_steps: int = 8) -> dict:
    """On the card, weights drawn there: a prefill, `n_steps` decode steps,
    then the loss of a train-mode model and its backward (block remat): all
    finite; K3 and K3-bwd launches, times and peak memory."""
    from repro_torch.models.model import build_model

    rng = np.random.default_rng(0)
    torch.cuda.reset_peak_memory_stats()
    _lm_counts_reset()
    model = build_model(cfg, "cuda").init(
        torch.Generator("cuda").manual_seed(0))
    batch = _family_batch(cfg, B, S, rng)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = model.prefill(batch)
    torch.cuda.synchronize()
    prefill_ms = 1e3 * (time.perf_counter() - t0)
    finite = bool(torch.isfinite(logits.float()).all())
    serve_k3 = _lm_counts()["flash_attention"]
    t0 = time.perf_counter()
    for i, step in enumerate(_family_steps(cfg, B, n_steps, rng)):
        logits, cache = model.decode_step(cache, step, S - n_steps + i)
        finite &= bool(torch.isfinite(logits.float()).all())
    torch.cuda.synchronize()
    decode_ms = 1e3 * (time.perf_counter() - t0) / n_steps
    del model, cache
    trainer = build_model(cfg, "cuda", train=True).init(
        torch.Generator("cuda").manual_seed(0))
    batch = _family_batch(cfg, B, S, rng, labels=True)
    t0 = time.perf_counter()
    loss = trainer.loss(batch)
    loss.backward()
    torch.cuda.synchronize()
    loss_ms = 1e3 * (time.perf_counter() - t0)
    grads = [p.grad for p in trainer.parameters()]
    finite &= bool(torch.isfinite(loss)) and all(
        g is not None and bool(torch.isfinite(g).all()) for g in grads)
    counts = _lm_counts()
    del trainer, grads
    torch.cuda.empty_cache()
    return {"B": B, "S": S, "prefill_ms": prefill_ms,
            "decode_step_ms": decode_ms, "loss_and_backward_ms": loss_ms,
            "loss": float(loss.detach()), "finite": finite,
            "prefill_flash_launches": serve_k3, "launches": counts,
            "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


def family_parity(cfg, B: int, S: int, n_steps: int = 2) -> dict:
    """`cfg` in f32 on the card and the CPU from one CPU draw: prefill and
    decode logits within `FAMILY_BAR` of the largest."""
    card, cpu = _model_pair(dataclasses.replace(
        cfg, compute_dtype="float32", kv_cache_dtype="float32"))
    rng = np.random.default_rng(1)
    batch = _family_batch(cfg, B, S, rng)
    steps = _family_steps(cfg, B, n_steps, rng)
    outs = {}
    for name, model in (("cuda", card), ("cpu", cpu)):
        logits, cache = model.prefill(batch)
        got = [logits]
        for i, step in enumerate(steps):
            logits, cache = model.decode_step(cache, step, S - n_steps + i)
            got.append(logits)
        outs[name] = got
    err = max(_close(a, b) for a, b in zip(outs["cuda"], outs["cpu"]))
    del card, cpu
    torch.cuda.empty_cache()
    return {"layers": cfg.num_layers, "B": B, "S": S, "max_err": err,
            "bar": FAMILY_BAR}


def phase_families() -> dict:
    """qwen2-vl-72b at full width, 1 of 80 layers (int8 KV cache, embedding
    inputs, M-RoPE positions), and seamless-m4t-large-v2 at its full config
    (24 + 24 layers), bf16 on the card: `family_run`; then each at 2 layers
    in f32, card against CPU (`family_parity`).  K3 once a prefill layer
    (the decoder's self-attention for seamless) and, in the loss, twice a
    layer (block remat) with K3-bwd once."""
    from repro_torch.configs.base import get_config

    out = {}
    for arch, layers, (B, S) in (("qwen2-vl-72b", 1, (2, 512)),
                                 ("seamless-m4t-large-v2", None, (2, 256))):
        cfg = get_config(arch)
        if layers:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        run = family_run(cfg, B, S)
        small = dataclasses.replace(cfg, num_layers=2, **(
            {"encoder_layers": 2} if cfg.family == "encdec" else {}))
        parity = family_parity(small, 1, 64)
        L = cfg.num_layers
        expected = {"prefill": L, "flash_attention": 3 * L,
                    "flash_attention_bwd": L}
        got = {"prefill": run["prefill_flash_launches"],
               "flash_attention": run["launches"]["flash_attention"],
               "flash_attention_bwd": run["launches"]["flash_attention_bwd"]}
        emit(phase="families", arch=cfg.name, layers=L,
             encoder_layers=cfg.encoder_layers,
             kv_cache_dtype=cfg.kv_cache_dtype, input_mode=cfg.input_mode,
             mrope=cfg.mrope, **run, expected=expected, parity=parity)
        if got != expected or not run["finite"]:
            raise AssertionError(f"families {arch}: launches {got} (expected "
                                 f"{expected}), finite {run['finite']}")
        if not parity["max_err"] <= FAMILY_BAR:
            raise AssertionError(f"families {arch}: card vs CPU {parity}")
        out[arch] = got
    return out


def _moe_train_setup():
    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticSource
    from repro_torch.launch import steps, train

    cfg = dataclasses.replace(get_config("moonshot-v1-16b-a3b"),
                              num_layers=TRAIN_MOE_LAYERS)
    args = train.parse_args(list(TRAIN_MOE_ARGV))
    opt_cfg = train.opt_config(cfg, args)
    model, step_fn = steps.make_train_step(cfg, opt_cfg, "cuda")
    source = SyntheticSource(cfg, ShapeConfig("t", args.seq, args.batch,
                                              "train"), DataConfig(seed=0))

    def init():
        return steps.init_train_state(model, cfg, opt_cfg,
                                      torch.Generator("cuda").manual_seed(0))

    def batch(i):
        return {k: torch.as_tensor(v, device="cuda")
                for k, v in source.batch(i).items()}

    return cfg, args, model, step_fn, init, batch


def moe_determinism(cfg) -> dict:
    """`moe_block` at moonshot's width on the prefill's T (8 x 1088, the
    gathered path) and a decode's (8, masked), bf16: two calls bit-equal,
    output and gradients."""
    from repro_torch.models import moe

    g = torch.Generator("cuda").manual_seed(1)
    p = {k: v.to("cuda", torch.bfloat16).requires_grad_()
         for k, v in moe.init_moe(g, cfg).items()}
    out = {}
    for T in (8, 8 * 1088):
        x = torch.randn((1, T, cfg.d_model), generator=g, device="cuda").to(
            torch.bfloat16).requires_grad_()
        runs = []
        for _ in range(2):
            y = moe.moe_block(p, cfg, x)
            runs.append((y, *torch.autograd.grad(y.float().square().sum(),
                                                 [*p.values(), x])))
        out[f"T{T}"] = all(torch.equal(a, b) for a, b in zip(*runs))
    del p
    torch.cuda.empty_cache()
    return out


def phase_train_moe() -> dict:
    """moonshot at full width, 2 layers, f32 masters, bf16 compute, block
    remat, batch 8 x seq 1024, 10 steps from weights drawn on the card: the
    last loss below the first, step ms, peak memory, K3 4 and K3-bwd 2 a
    step, the gathered MoE path 4 times a step (forward and recompute);
    then steps 1-3 again from the same draw, bit-equal (losses and grad
    norms), and `moe_determinism`."""
    cfg, args, model, step_fn, init, batch = _moe_train_setup()
    runs = {}
    torch.cuda.reset_peak_memory_stats()
    for name, n in (("run", args.steps), ("repeat", TRAIN_MOE_REPEAT)):
        state = init()
        _lm_counts_reset()
        losses, gnorms, dts = [], [], []
        for i in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step_fn(state, batch(i))
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
            dts.append(time.perf_counter() - t0)
        runs[name] = {"losses": losses, "grad_norms": gnorms, "dts": dts,
                      "counts": _lm_counts()}
        del state
    run, rep = runs["run"], runs["repeat"]
    n = args.steps
    same = (rep["losses"] == run["losses"][:TRAIN_MOE_REPEAT]
            and rep["grad_norms"] == run["grad_norms"][:TRAIN_MOE_REPEAT])
    med = statistics.median(run["dts"][1:])
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del model, step_fn
    torch.cuda.empty_cache()
    det = moe_determinism(cfg)
    counts = run["counts"]
    expected = {"flash_attention": 2 * cfg.num_layers * n,
                "flash_attention_bwd": cfg.num_layers * n,
                "gathered": 2 * cfg.num_layers * n}
    got = {"flash_attention": counts["flash_attention"],
           "flash_attention_bwd": counts["flash_attention_bwd"],
           "gathered": counts["moe"]["gathered"]}
    emit(phase="train_moe", arch=cfg.name, layers=cfg.num_layers,
         compute_dtype=cfg.compute_dtype, param_dtype=cfg.param_dtype,
         remat=cfg.remat, argv=list(TRAIN_MOE_ARGV), steps=n,
         losses=run["losses"], grad_norms=run["grad_norms"],
         first_step_ms=1e3 * run["dts"][0], median_step_ms=1e3 * med,
         tokens_per_s=args.batch * args.seq / med, peak_memory_gib=peak,
         launches=counts, expected=expected,
         repeat_steps=TRAIN_MOE_REPEAT, repeat_bit_equal=same,
         repeat_losses=rep["losses"], moe_bit_equal=det)
    if not (all(np.isfinite(run["losses"]))
            and run["losses"][-1] < run["losses"][0]):
        raise AssertionError(f"train_moe losses {run['losses']}")
    if got != expected:
        raise AssertionError(f"train_moe launches {got}, expected {expected}")
    if not same or not all(det.values()):
        raise AssertionError(f"train_moe not deterministic: repeat {same}, "
                             f"moe_block {det}")
    return {"launches": got}


def phase_train_moe_profile() -> None:
    """One train_moe step under torch.profiler (`profile_train_step`)."""
    cfg, args, model, step_fn, init, batch = _moe_train_setup()
    profile_train_step(step_fn, init(), batch(0), "train_moe_profile",
                       f"{cfg.name} {cfg.num_layers} layers train step B "
                       f"{args.batch} S {args.seq}")
    del model, step_fn
    torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this smoke run needs an NVIDIA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout)

    card = phase_nvidia_smi()["card"]
    phase_build()
    kern = phase_kernel()
    gp_fits = phase_gp_fit()
    lm = phase_lm_kernels()
    bwd = phase_attention_bwd()
    phase_slstm_op()
    torch.cuda.empty_cache()
    # after the kernels' timings: the autotuner's GP shares the card
    host = start_host_phases()
    # this slice's paths first, on a clean card: serve_moe holds ~62 GB
    moe = phase_serve_moe()
    phase_serve_moe_profile(moe["cfg"], moe["args"])
    moe_parity = phase_serve_moe_parity()
    llama4 = phase_serve_llama4()
    phase_serve_hybrid()
    phase_serve_xlstm()
    families = phase_families()
    train_moe = phase_train_moe()
    phase_train_moe_profile()
    phase_train_xlstm()
    main_path = phase_main_path()
    phase_profile()
    served = phase_serve()
    model = phase_prefill_vs_naive(served["cfg"], served["args"])
    phase_serve_profile(model, served["cfg"], served["args"])
    matmul_path = phase_matmul_path(model, served["cfg"], served["args"])
    del model
    torch.cuda.empty_cache()
    parity_launches = phase_serve_parity()
    hd160_launches = phase_serve_hd160()
    smoke = phase_serve_smoke()
    torch.cuda.empty_cache()
    trained = phase_train()
    phase_train_profile()
    torch.cuda.empty_cache()
    parity_train = phase_train_parity()
    phase_train_resume()
    torch.cuda.empty_cache()
    with one_rank_world():
        sharded = phase_sharded_train(trained["losses"])
        sharded_moe = phase_sharded_moe()
    torch.cuda.empty_cache()
    co_design = {"main_path": main_path["launches"],
                 "prune_speculative":
                     phase_prune_speculative(main_path["design"])["launches"],
                 "baselines": phase_baselines()["launches"],
                 "service": phase_service()["launches"],
                 "executor_workers": phase_executor()["launches"]}
    phase_dryrun(host["dryrun"])
    phase_autotune(*host["autotune"])

    # K1 and K1b report the row count carrying most of the main path's rows,
    # measured in float64 (the search's dtype); library_ms is null: no
    # single PyTorch call computes either.  K1's launches on the main path
    # are 0: K1b runs its reduction there.
    rows = main_path["rows"]
    n_main = max(rows, key=lambda n: n * rows[n])
    k1 = kern.get(("edp_reduce", "float64", n_main)) or measure_edp(
        n_main, "float64")
    k1b = kern.get(("cost_forward", "float64", n_main)) or \
        measure_cost_forward(n_main, "float64")
    edp_keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "call_ms", "plain_call_ms")
    # The LM kernels report their path's largest shape, each in both its
    # designs: K3 bf16 launched by the serve (its compute dtype) and f32 by
    # serve_parity; K2 by `ops.matmul`.
    attn = {dt: lm["flash_attention", ATTN_SERVE, dt] for dt in LM_DTYPES}
    attn_launches = {"bfloat16": served["launches"],
                     "float32": parity_launches}
    # Training launches K3 (its lse instances) twice a layer a step and
    # K3-bwd once: bf16 in `train`, f32 in `train_parity`.
    train_launches = {"bfloat16": trained["launches"],
                      "float32": parity_train["launches"]}
    bwd_rec = {dt: bwd[BWD_TRAIN, dt] for dt in LM_DTYPES}
    bwd_keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "call_ms", "plain_call_ms", "shape", "dtype",
                "path", "launches_per_call", "fwd_lse_ms", "fwd_ms")
    # K3's hd 160 instances at stablelm-12b's prefill shape, launched by the
    # serve_hd160 phase in each dtype.
    attn160 = {dt: lm["flash_attention", ATTN_HD160, dt] for dt in LM_DTYPES}
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "call_ms", "plain_call_ms", "shape", "dtype", "path")
    mm = {dt: lm["tiled_matmul", MATMUL_SERVE, dt] for dt in LM_DTYPES}
    # K3 at hd 128 (moonshot's prefill shape): bf16 launched by serve_moe,
    # llama4, qwen2-vl and train_moe (seamless's decoder is hd 64, with the
    # rows above), f32 by serve_moe_parity; K3-bwd at hd 128 by train_moe
    # (bf16)
    attn128 = {dt: lm["flash_attention", ATTN_MOE, dt] for dt in LM_DTYPES}
    bwd128 = bwd[BWD_MOE, "bfloat16"]
    emit(kernels=[{
        "name": "edp_reduce", "route": "cuda", "source": EDP_SOURCE,
        "replaces": EDP_REPLACES, "launches": 0,
        **{k: k1[k] for k in edp_keys}, "library_ms": None,
        "rows": n_main, "dtype": "float64", "card": card}, {
        "name": "cost_forward", "route": "cuda", "source": EDP_SOURCE,
        "replaces": EDP_REPLACES, "launches": main_path["launches"],
        "launches_by_path": co_design,
        **{k: k1b[k] for k in edp_keys}, "library_ms": None,
        "unfused_ms": k1b["unfused_ms"],
        "unfused_call_ms": k1b["unfused_call_ms"],
        "rows": n_main, "dtype": "float64", "card": card}, {
        "name": "gp_fit", "route": "cuda", "source": GP_FIT_SOURCE,
        "replaces": GP_FIT_REPLACES,
        "replaces_note": "no TPU kernel: the reference jit-compiles the "
                         "Adam fit into one XLA program",
        "launches": main_path["gp_fit_launches"],
        **{k: gp_fits[GP_FIT_SHAPES[0]][k]
           for k in ("shape", "kind", "form", "ms", "plain_ms", "call_ms",
                     "plain_call_ms", "launches_per_call",
                     "plain_launches_per_call", "ptxas")},
        "card": card}, *[{
        "name": "tiled_matmul", "route": "cuda", "source": MATMUL_SOURCE,
        "replaces": MATMUL_REPLACES,
        "launches": matmul_path["launches"][LM_DTYPES[dt]],
        **{k: mm[dt][k] for k in keys}, "blocks": mm[dt]["blocks"],
        "card": card} for dt in LM_DTYPES], *[{
        "name": "flash_attention", "route": "cuda", "source": ATTN_SOURCE,
        "replaces": ATTN_REPLACES, "launches": attn_launches[dt],
        **{k: attn[dt][k] for k in keys}, "ptxas": attn[dt]["ptxas"],
        "launches_by_path": (
            {"serve": served["launches"],
             "serve_smoke hd 20": smoke["launches"],
             "train": train_launches[dt]["flash_attention"],
             "sharded_train": sharded["launches"]["flash_attention"],
             "families seamless-m4t-large-v2": families[
                 "seamless-m4t-large-v2"]["flash_attention"]}
            if dt == "bfloat16" else
            {"serve_parity": parity_launches,
             "train_parity": train_launches[dt]["flash_attention"]}),
        "card": card} for dt in LM_DTYPES], *[{
        "name": "flash_attention", "route": "cuda", "source": ATTN_SOURCE,
        "replaces": ATTN_REPLACES, "launches": hd160_launches[dt],
        **{k: attn160[dt][k] for k in keys}, "ptxas": attn160[dt]["ptxas"],
        "path_run": "serve_hd160", "card": card} for dt in LM_DTYPES], {
        "name": "flash_attention", "route": "cuda", "source": ATTN_SOURCE,
        "replaces": ATTN_REPLACES, "launches": moe["launches"],
        **{k: attn128["bfloat16"][k] for k in keys},
        "ptxas": attn128["bfloat16"]["ptxas"], "path_run": "serve_moe",
        "launches_by_path": {
            "serve_moe": moe["launches"], "serve_llama4": llama4["launches"],
            "families qwen2-vl-72b": families["qwen2-vl-72b"][
                "flash_attention"],
            "train_moe": train_moe["launches"]["flash_attention"]},
        "card": card}, {
        "name": "flash_attention", "route": "cuda", "source": ATTN_SOURCE,
        "replaces": ATTN_REPLACES, "launches": moe_parity["launches"],
        **{k: attn128["float32"][k] for k in keys},
        "ptxas": attn128["float32"]["ptxas"], "path_run": "serve_moe_parity",
        "launches_by_path": {"serve_moe_parity": moe_parity["launches"],
                             "sharded_moe": sharded_moe["launches"]},
        "card": card}, {
        "name": "flash_attention_bwd", "route": "cuda", "source": BWD_SOURCE,
        "replaces": BWD_REPLACES,
        "launches": train_moe["launches"]["flash_attention_bwd"],
        "path_run": "train_moe", **{k: bwd128[k] for k in bwd_keys},
        "ptxas": bwd128["ptxas"], "card": card}, *[{
        "name": "flash_attention_bwd", "route": "cuda", "source": BWD_SOURCE,
        "replaces": BWD_REPLACES,
        "replaces_note": "no TPU kernel: the reference differentiates "
                         "flash_sdpa by autodiff",
        "launches": train_launches[dt]["flash_attention_bwd"],
        "path_run": "train" if dt == "bfloat16" else "train_parity",
        **({"launches_by_path": {
            "train": train_launches[dt]["flash_attention_bwd"],
            "sharded_train": sharded["launches"]["flash_attention_bwd"]}}
           if dt == "bfloat16" else {}),
        **{k: bwd_rec[dt][k] for k in bwd_keys},
        "ptxas": bwd_rec[dt]["ptxas"], "card": card} for dt in LM_DTYPES]])
    emit(ok=True, device={"platform": "gpu",
                          "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
