"""Drive the PyTorch port on one NVIDIA GPU, end to end, through its kernels.

    python3 chip_smoke.py

Run from the root of the repository, on a machine with a CUDA card and the
CUDA toolkit.  Each phase prints one JSON line; any failure raises and ends
the run with a non-zero exit:

1. device        the card, its power limit, and TF32 turned off for fp32
                 matmuls;
2. build         the CUDA kernels compiled from ``internevo_tpu_torch/csrc``
                 (one nvcc per source, in parallel) and the Triton AdamW and
                 dropout kernels JIT-compiled, with registers and spills; a
                 source whose ``ptxas`` log shows a spill fails the run,
                 and so does a splash (bf16, fp16 or fp32) or gmm kernel
                 whose SASS holds no ``HGMMA`` (wgmma) or any ``HMMA``
                 (legacy mma.sync);
3. kernel        the splash forward kernel against its plain version at the
                 InternLM-7B scoring shapes, bf16 on the card, five cases and
                 one planted fault the check must catch, with timings beside
                 SDPA's forward and compiled ``flex_attention``'s forward
                 with a (same segment ∧ causal) block mask;
4. scoring       InternLM-7B (``configs/7B_sft.py``, full width and depth,
                 random weights from a seed) scores two packed rows of 4096
                 tokens through ``make_eval_step``; the kernel must launch once
                 per layer, and the loss is held against a forward with the
                 plain attention;
5. serving       the same model answers 5 generation requests through
                 ``SequenceGenerator`` (4 greedy, 1 sampled batch of 4 rows);
6. kernel_bwd    the two splash backward kernels against ``plain_backward``
                 at the training shape (one packed row of 4096 tokens), five
                 cases and one planted fault the check must catch, with
                 timings beside SDPA's backward alone and beside compiled
                 ``flex_attention``'s backward with a (same segment ∧
                 causal) block mask;
7. kernel_adamw  the fused AdamW kernel against its plain version at 7B leaf
                 shapes, with timings;
8. train_grads   every param grad of a 2-layer model at 7B width through the
                 kernels, against the same model with the plain attention;
9. training      the 7B_sft configuration cut to 8 layers takes 4 steps
                 through ``initialize_*`` and ``Trainer.execute_schedule``
                 (``tools/profile_step.py::train_setup``); launches, finite
                 norms and a falling loss are held;
10. kernel_gmm   the grouped-matmul kernels (gmm, gmm with the rhs
                 transposed, tgmm) against their plain versions at the MoE
                 training shapes (8192 routed rows, 4 experts, 4096 <-> 11008,
                 both directions) in four group layouts and at the scoring
                 shape (16,384 rows) in two, tgmm's bf16 dW bit for bit
                 its fp32 dW rounded, one planted fault (group ends shifted
                 by a row) the check must catch; gmm and gmm dgrad timed in
                 both directions at 8192 balanced and skewed rows and 16,384
                 scoring rows, tgmm (bf16 dW, as training writes it) in both
                 directions at 8192 balanced, skewed and one-group rows,
                 and with fp32 dW at balanced rows, each beside its bound
                 and ``torch._grouped_mm``;
11. moe_grads    every param grad of a 1-layer MoE4 model at full width
                 (``configs/7B_MoE4_sft.py`` routed dropless,
                 ``tools/profile_step.py::moe_config``) through the kernels,
                 against the same model with the plain grouped matmul, with
                 the routing held identical;
12. moe_scoring  the MoE4 model at full width and depth scores the packed
                 rows of phase 4 through ``make_eval_step`` (3 gmm launches a
                 layer a forward); layer 0's three gmm calls (16,384 routed
                 rows) are held against ``plain_gmm`` on their own inputs,
                 with a planted fault each; the loss is held against a
                 forward with the plain grouped matmul, and routing
                 differences counted;
13. moe_training the MoE4 configuration cut to 4 layers takes 4 steps
                 through the Trainer (``moe_train_setup``);
14. moe_training_plain  the same 4 steps from the same seed with the plain
                 grouped matmul; each step's loss and ``moe_loss`` are held
                 against phase 13's.
15. kernel_dropout  the Triton residual-dropout kernel against its plain
                 version (JAX's threefry masks, ``core/random.py``) at one
                 packed 4096-token row of 7B width, bf16, forward and
                 backward, bit for bit, at rates 0.1 and 0.5; a planted
                 fault (the next layer's key) the check must refuse; timed
                 beside its bound (the larger of its bytes and its hash's
                 integer operations at SMs x 64 INT32 lanes x the SM
                 clock) and the plain version;
16. remat_grads  InternLM2 widths (``configs/7B_internlm2.py``), 2 layers,
                 residual and attention dropout at 0.1: the grads under
                 every recompute tier (``checkpoint=1`` plain, with
                 ``remat_save_mlp``, with ``remat_save_qkv``, with
                 ``activation_offload``) bit for bit ``checkpoint=0``'s, one
                 splash forward a layer under each, the peak memory of each,
                 and the grads against the plain attention under the same
                 masks;
17. internlm2_scoring  ``configs/7B_internlm2.py`` at full width and depth
                 (GQA 32/8) scores phase 4's packed rows, as phase 4;
18. internlm2_serving  the same model answers two greedy requests through
                 ``SequenceGenerator`` (the GQA decode);
19. internlm2_training  the same file at 16 layers with every layer
                 recomputed and both dropouts at 0.1 takes 4 steps through
                 the Trainer; launches (one splash forward a layer and
                 micro-batch), finite norms, a falling loss, peak memory,
                 and the step's time by kernel class and in the recompute
                 (``tools/profile_step.py::profile``).
20. gshard_scoring  ``configs/7B_MoE4_sft.py`` as the file stands (GShard
                 capacity routing, top-2, eval capacity factor 1) at full
                 width and depth scores phase 4's packed rows through
                 ``make_eval_step``: one splash forward a layer, no grouped
                 matmul, the share of routed slots each layer dropped, and
                 the loss held against a forward with the plain attention;
21. gshard_grads the same file at 2 layers, in training under one key (the
                 top-2 gumbel noise and RTS on): grads and aux loss through
                 the kernels against the plain attention, the share of
                 tokens whose (expert, slot) routing agrees, and a planted
                 fault (each layer drawing the next layer's key) the check
                 must refuse;
22. entry_training  the entry point's loop (``train/main.py::run_training``)
                 in-process on the same file with saving on
                 (``ckpt.enable_save_ckpt``, a fresh folder), the depth cut
                 to 4 layers, or 2 or 1 where two checkpoints of 4 do not
                 fit the free space or the disk write budget
                 (``checkpoint_disk`` prints ``df``, ``free``, the choice and
                 a 2 GiB write and read as a yardstick), and
                 ``data.total_steps`` to 52, the rest as shipped: the data
                 path (``RandomDataset`` -> ``PackedDatasetWithCut`` ->
                 sampler -> collater, a prefetch thread), GShard routing with
                 the gumbel noise folded from the applied step, the async
                 save of a snapshot at step 25 into ``snapshot/1`` and of
                 ``50/`` at step 50, eval of the 500-sample valid set at step
                 50 (B1 launches); the step time and tokens/s over steps
                 2-51 without the two that paid for a save, each save's
                 seconds holding the loop and to its stamp, its bytes, the
                 eval's loss, accuracy, perplexity and seconds, peak memory,
                 launches; the state each save snapshotted is fingerprinted
                 on the device (exact int64 sums of each leaf's bits);
23. checkpoint_resume  a second ``run_training`` on the same folder from
                 another init seed: it must auto-resume from ``50/`` (the
                 newest stamp), load the snapshot's fingerprints exactly,
                 refuse a planted flip of one bit in a loaded master
                 weight, and run batches 50-51 to the first run's losses,
                 grad norms and final params, masters and moments, bit for
                 bit; the load's seconds.

24. kernel_coverage  the splash kernels at every (dtype, head dim)
                 instantiation on one packed 4096-token row (segments of at
                 most 2048), GQA 32/8: B1 forward and B2's dK/dV and dQ in
                 bf16 and fp16 at head dims 16, 32, 64, 80, 96, 128 (the
                 wgmma kernels, run on the 64- or 128-wide instantiation)
                 and fp32 at 16, 32, 64, 128 (the same kernels on three
                 bf16 pieces an operand), one dropout case a dtype, each
                 against ``plain_forward`` / ``plain_backward``, refusing its
                 planted faults (kv_lo + 1, q_hi - 1) and giving the same
                 backward bits twice, each timed beside its bound (fp32:
                 the bf16 tensor-core peak / 6, and the CUDA-core bound
                 beside it), its plain version and SDPA in its dtype (fp32:
                 the math backend, and the efficient backend with the mask
                 as a float bias), one head dim a dtype also beside
                 compiled ``flex_attention``;
                 then gmm, gmm dgrad and tgmm in fp16 at the kernel_gmm
                 layouts against their plain versions, a planted fault, and
                 timed beside ``torch._grouped_mm``; then the fp32 pieces'
                 split kernel bit for bit against ``plain_split`` with a
                 planted fault (the lo piece dropped), timed beside its
                 bound and plain version;
25. demo_entry   ``python -m internevo_tpu_torch.train.main --config
                 configs/demo.py`` (``train/main.py::main``, the file
                 unmodified, no ``--device``): 20 steps at fp32 and head dim
                 16 through the splash kernels' fp32 instantiations (and
                 the pieces' split kernel) and fused AdamW, no
                 plain attention; losses and grad norms held against the
                 same run with ``--device cpu``;
26. fp16_training  ``configs/7B_sft.py`` with ``model.dtype`` fp16 and the
                 depth cut to 8 layers: a 2-layer model's first-step grads
                 (the loss scaled by the file's initial 2**16, then
                 unscaled) against the plain attention, then 4 steps of 4
                 packed 4096-token rows through the Trainer with the file's
                 dynamic loss scaler: the scale trajectory, skipped steps,
                 tokens/s, MFU, peak memory;
27. moe_fp16_grads  the dropless MoE4 (``moe_type`` MegaBlock-D) at fp16, 2
                 layers, full width: a forward and backward whose every gmm,
                 gmm dgrad and tgmm call (fp16) is held against its plain
                 version, with a planted fault each.

An argument ``--only phase[,phase]`` runs the device and build phases and
then only the named phases of 20-27 (for a first call after a change to
them; ``checkpoint_resume`` runs ``entry_training`` first); with no argument
every phase runs.

Then a ``{"kernels": [...]}`` line and, last, the run's verdict line.  With no
CUDA device the script exits non-zero before printing any result.  It imports
nothing of JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from internevo_tpu_torch.apis.inference import (SequenceGenerator, init_kv_cache, model_decode_step,
                                                 top_k_top_p_filtering)
from internevo_tpu_torch.checkpoint.checkpoint_manager import CheckpointManager
from internevo_tpu_torch.core import random as jrandom
from internevo_tpu_torch.core.config import Config
from internevo_tpu_torch.core.scheduler.no_pipeline import make_eval_step
from internevo_tpu_torch.models.base import block_forward, make_model_def
from internevo_tpu_torch.models.modeling_moe import moe_ffn
from internevo_tpu_torch.models.moe import dropless, gshard
from internevo_tpu_torch.ops.attention import flash_attention
from internevo_tpu_torch.ops.cuda import build, dropout, fused_adamw, gmm, pieces
from internevo_tpu_torch.ops.cuda import splash_attention as splash
from internevo_tpu_torch.ops.fused_ce import fused_norm_head_ce
from internevo_tpu_torch.solver.optimizer import tree_leaves, tree_leaves_with_path, tree_map
from internevo_tpu_torch.tools import profile_step
from internevo_tpu_torch.tools.profile_step import (INTERNLM2_CONFIG, gshard_config, internlm2_train_config,
                                                    moe_config,
                                                    moe_train_setup, packed_batch, packed_segments, train_config,
                                                    train_setup)
from internevo_tpu_torch.train import main as train_main
from internevo_tpu_torch.train.main import run_training
from internevo_tpu_torch.train.pipeline import build_model, initialize_model
from internevo_tpu_torch.utils.storage_manager import StorageManager
from internevo_tpu_torch.utils.common import (device_peak_bandwidth, device_peak_fp32_exact_tflops,
                                              device_peak_fp32_tflops,
                                              device_peak_tflops, get_megatron_flops)

REPO = Path(__file__).resolve().parent
SEED = 0
SCORE_B, SCORE_S, MAX_SEG, PAD = 2, 4096, 2048, 357
GREEDY_PROMPTS, NEW_TOKENS = (17, 64, 128, 300), 32
SAMPLE_ROWS, SAMPLE_PROMPT, TOP_K, TOP_P = 4, 48, 50, 0.9
# kernel vs plain, bf16 on the card: out as torch.testing's bf16 default (the
# two round p at different points before the PV product, and out once more);
# lse is fp32 in both, summed in another order
OUT_RTOL = OUT_ATOL = 1.6e-2
LSE_ATOL = 1e-3
# scoring loss, kernel path vs plain attention: both run the same bf16 model;
# only the attention's rounding differs, averaged over ~8k tokens
LOSS_GAP = 1e-2
# prefill logits, decode path (dense cached attention) vs model_forward
# (kernel): relative RMS.  The two attentions round in bf16 at different
# points and the difference compounds through 32 random-weight layers: 1.3e-2
# measured on an H100 (seed 0); the bound leaves ~4x room for other seeds
PREFILL_REL_RMS = 5e-2
# splash backward kernels vs plain_backward, bf16 on the card: elementwise as
# the forward's out (both round P∘drop and dS to bf16 at the same points, from
# fp32 scores summed in another order, then round each grad once).  With these
# inputs a typical |dq| or |dk| is a few 1e-2, so the elementwise bound alone
# is loose; the relative L2 of each grad is what holds: sound kernels read
# 7.7e-5 to 2.0e-4 on an H100, and the bound is 10x the largest.  A window
# one q tile short (the planted fault) reads far above it
GRAD_RTOL = GRAD_ATOL = 1.6e-2
BWD_REL_L2 = 2e-3
# fused AdamW vs its plain version: m, v, master within 1e-6 of each tensor's
# largest magnitude (the same fp32 expression; the kernel's compiler contracts
# multiply-adds, the plain version's separate kernels do not: 1e-7 measured).
# The bf16 param is exactly the rounding of the kernel's own master, and
# within one bf16 ulp of the plain param plus that master bound (a master
# near 0 that moves by 1e-9 crosses many ulps of its own tiny magnitude)
ADAMW_REL = 1e-6
# param grads of the kernel path vs plain attention under autograd: relative
# L2 per leaf, the bf16 grad level of doc/perf_notes.md:287-289
GRAD_REL_L2 = 2e-2
TRAIN_STEPS = 4              # training: tools/profile_step.py::train_setup's model and batch
TRAIN_B, TRAIN_S = 1, 4096   # kernel_bwd / train_grads: one packed row
HEADS, HEAD_DIM = 32, 128     # InternLM-7B attention
# kernel_adamw: 7B leaves (shape, skip flag, param dtype); the embedding leaf
# is timed
BF16, FP32 = torch.bfloat16, torch.float32
ADAMW_CASES = {"wqkv": ((12288, 4096), 0.0, BF16), "w1": ((11008, 4096), 0.0, BF16),
               "embedding": ((103168, 4096), 0.0, BF16), "norm1": ((4096,), 0.0, BF16),
               "norm_fp32": ((4096,), 0.0, FP32), "wqkv_skip": ((12288, 4096), 1.0, BF16)}
ADAMW_TIMED = "embedding"
# kernel_gmm: the MoE training shapes (one packed 4096-token row, top-2: 8192
# routed rows; hidden 4096, expert width 11008, 4 experts) in four group
# layouts, and the scoring shape (two packed rows: 16,384 routed rows) in two:
# (rows, group sizes)
GMM_H, GMM_M, GMM_E = 4096, 11008, 4
GMM_CASES = {"balanced": (8192, [2048] * 4), "skewed_empty": (8192, [6000, 0, 2000, 192]),
             "one_group": (8192, [0, 0, 8192, 0]), "rows_past_sum": (8000, [2000, 1900, 2100, 1800]),
             "scoring_balanced": (16384, [4096] * 4), "scoring_skewed_empty": (16384, [9000, 300, 0, 7084])}
# gmm kernels vs plain, on the card: both sum exact bf16 products in fp32 and
# round once, in another order.  bf16 outputs elementwise as the splash
# forward's (a sum near a rounding boundary lands one bf16 step away) and a
# relative L2 of 10x the largest sound reading (2.51e-4, the dgrad direction,
# on an H100); fp32 dW a relative L2 of 10x its largest sound reading
# (9.1e-6, one group of 8192 rows).  A group end one row off moves a whole
# row to another expert: 1.6e-2 relative L2 and thousands of elements out
GMM_REL_L2 = 2.6e-3
# the layouts timed, gmm and gmm dgrad each in both directions of the expert
# MLP: the training shape, balanced and skewed, and the 16,384-row scoring
# shape of the 96 scoring launches
GMM_TIMED = ("balanced", "skewed_empty", "scoring_balanced")
# tgmm, both directions at the training shape: balanced, skewed with an empty
# group, and one group owning every row
TGMM_TIMED = ("balanced", "skewed_empty", "one_group")
TGMM_REL_L2 = 1e-4
# moe_scoring: the loss of the kernel path vs the plain grouped matmul over
# 32 random-weight layers.  The two round expert outputs at different points,
# so near-tie tokens of later layers route to another expert; the loss moves
# by the difference those few tokens make, averaged over ~8k tokens.  10x the
# sound reading (6.9e-5 on an H100).  With random weights the loss sits near
# ln(vocab) and hardly moves with the experts' output: a planted fault (a
# group end one row off in every call) read 6.7e-5 too.  So the loss does
# not hold the kernel; layer 0's gmm calls are held one by one at this shape
MOE_LOSS_GAP = 7e-4
# moe_training_plain: step by step, the loss and moe_loss of the kernel path
# vs the plain grouped matmul from the same weights, 10x each step's reading
# on an H100 (loss 3.1e-5, 3.2e-4, 1.9e-3, 1.1e-2; moe_loss 3.1e-4, 1.5e-3,
# 0.15, 0.055).  Step 1 differs by rounding only; after it the two paths'
# weights differ, near-tie tokens route apart, and Adam grows the gap ~6-10x
# a step
MOE_TRAIN_LOSS_GAP = (3.2e-4, 3.3e-3, 1.9e-2, 0.12)
MOE_TRAIN_MOE_LOSS_GAP = (3.2e-3, 1.6e-2, 1.6, 0.55)
# the per-token path reads the bf16 logits (the JAX logits path for MoE
# models), the plain one the fused CE's fp32 logits: a few bf16 steps of
# logit rounding, averaged
MOE_TOKEN_PATH_GAP = 1e-2
# kernel_dropout: residual dropout of one packed 4096-token row at 7B width,
# bf16, at two rates; the kernel must equal its plain version bit for bit,
# forward and backward.  The planted fault (the next layer's key) must
# differ from the plain output in 2·rate·(1 − rate) of the elements, within
# this share of that
DROPOUT_SHAPE, DROPOUT_RATES = (1, 4096, 4096), (0.1, 0.5)
DROPOUT_FAULT_REL = 0.05
# internlm2_training: the step's read of the applied-step count timed
# against a host counter, in blocks of steps queued back to back, the two
# orders alternated (8 blocks of 3 16-layer steps, ~30 s)
READ_COST_BLOCKS, READ_COST_STEPS = ("read", "host", "host", "read") * 2, 3
# remat_grads: InternLM2 widths, 2 layers, both dropouts 0.1, one packed row;
# every recompute tier's grads against checkpoint=0's, largest absolute
# difference: 0, bit for bit (the recompute runs the same kernels on the same
# inputs, and the dropout masks and seeds are functions of the layer's key)
REMAT_LAYERS = 2
REMAT_TIERS = {"checkpoint_0": dict(checkpoint=0.0), "checkpoint_1": dict(checkpoint=1.0),
               "remat_save_mlp_1": dict(checkpoint=1.0, remat_save_mlp=1.0),
               "remat_save_qkv_1": dict(checkpoint=1.0, remat_save_qkv=1.0),
               "activation_offload": dict(checkpoint=1.0, activation_offload=True)}
REMAT_GRAD_MAX_ABS = 0.0
# internlm2_serving: two greedy requests
INTERNLM2_GREEDY = (64, 300)
# gshard_grads: 2 layers of the shipped MoE file in training under one key.
# Routing is discontinuous: the random gate (std 0.006) leaves near-ties
# that the attention's bf16 rounding flips, and one token routed otherwise
# moves the slots of every later token of its expert (a free plain run
# agreed on (expert, slot) for 6.3% and 1.3% of the tokens of layers 0 and
# 1, on the experts for 99.7% and 99.3%, on an H100).  So every param grad
# (relative L2 per leaf) and the aux loss (relative) are held with the plain
# run routed as the kernel run was: grads at the script's bf16 grad level
# GRAD_REL_L2 (the sound reading 1.01e-2; the kernels are deterministic, so
# it repeats), the aux loss 10x its sound 2.9e-6.  The free run's routing is
# held by the share of tokens sent to other experts, 10x the sound 7.3e-3.
# The planted fault (each layer drawing the next layer's key) redraws the
# gumbel noise of every second choice: 65% of the tokens went elsewhere
GSHARD_LAYERS = 2
GSHARD_GRAD_REL_L2 = GRAD_REL_L2
GSHARD_AUX_REL = 3e-5
GSHARD_ROUTE_DISAGREE = 7.3e-2
# entry_training: the shipped MoE file, cut only where one card forces it
# and saving on, past one valid_every (50): a snapshot at step 25, a save and
# eval at step 50.  Two checkpoints live at once and both are written, so the
# depth is the deepest of ENTRY_DEPTHS whose two checkpoints fit the free
# space and, with the disk yardstick, a budget of disk writes: the H100
# machine this script is run on accepts at most 45 GiB of disk writes a run
ENTRY_DEPTHS, ENTRY_STEPS, ENTRY_SEED = (4, 2, 1), 52, 1024
DISK_WRITE_BUDGET = 42 << 30
# checkpoint_resume: params from another seed, so that a load that did nothing
# shows (the launch seed stays: the gate noise draws its stream); bit for bit
# the first run's steps 50-51 and final state, and a planted flip of one bit
# in one loaded leaf the fingerprint check must refuse
ENTRY_SEED_RESUME, PLANTED_BIT_AT, FINGERPRINT_CHUNK = 4096, 12345, 1 << 24
DISK_YARDSTICK, DISK_CHUNK = 2 << 30, 64 << 20
# kernel_coverage: the splash instantiations (dtype: head dims) on one packed
# 4096-token row at GQA 32/8, a dropout case at one head dim a dtype, and the
# head dim whose cases are also timed beside compiled flex_attention
COVERAGE_DIMS = {"bf16": (16, 32, 64, 80, 96, 128), "f16": (16, 32, 64, 80, 96, 128), "f32": (16, 32, 64, 128)}
COVERAGE_DROPOUT = {"bf16": 80, "f16": 96, "f32": 16}
COVERAGE_KV_HEADS, COVERAGE_FLEX_D = 8, 64
# kernel vs plain a dtype: the relative L2 of out and of each grad, and lse's
# largest absolute error; 10x the largest sound reading on an H100.  bf16 and
# fp16 round P∘drop and dS to their type before the products, at the same
# points as the plain version, from fp32 scores summed in another order;
# fp32 rounds nothing.  The planted faults (every item's walk one tile short)
# read far above
# (readings: bf16 out 3.08e-3, lse 9.5e-7, grads 2.34e-4; fp16 3.85e-4,
# 1.4e-6, 6.87e-5; fp32 3.33e-7, 9.5e-7, 1.16e-6; the planted faults
# 0.11-0.75)
COVERAGE_LIMITS = {"bf16": dict(out=3.1e-2, lse=1e-5, grad=2.4e-3),
                   "f16": dict(out=3.9e-3, lse=1.4e-5, grad=7e-4),
                   "f32": dict(out=3.4e-6, lse=1e-5, grad=1.2e-5)}
# gmm in fp16 vs its plain version: relative L2, 10x the largest sound
# reading (9.1e-5, the w2 forward and w1 dgrad; the two sum exact fp16
# products in fp32 in another order and round once); a group end one row
# off reads 1.6e-2
FP16_GMM_REL_L2 = 9.1e-4
# demo_entry: configs/demo.py on the card vs --device cpu from the same
# initial params, step by step over 20 steps: losses and grad norms
# relative, both fp32 (TF32 off), 10x the largest sound reading (7.0e-8 and
# 1.0e-7, an ulp or so, on an H100); the first loss is ln(vocab) = ln(1024)
# at random init
DEMO_CONFIG, DEMO_LOSS_RTOL, DEMO_GNORM_RTOL = REPO / "configs" / "demo.py", 7e-7, 1e-6
# fp16_training: configs/7B_sft.py at fp16 (no shipped file sets fp16), cut
# to 8 layers as training; its first-step grads held at 2 layers: relative
# L2 per leaf, 10x the largest sound reading (1.23e-3 on an H100; bf16's
# train_grads reads ~10x more)
FP16_TRAIN_LAYERS, FP16_GRAD_LAYERS, FP16_GRAD_REL_L2 = 8, 2, 1.3e-2
# moe_fp16_grads: 2 layers of the dropless MoE4 at fp16
MOE_FP16_LAYERS = 2


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def attention_flops(seg: np.ndarray, heads: int, head_dim: int) -> float:
    """FLOPs of causal same-segment attention that must be done: 2 products of
    2·D flops for each (q, k) pair with k <= q in one segment run."""
    total = 0
    for row in seg:
        bounds = np.flatnonzero(np.diff(row)) + 1
        for n in np.diff(np.concatenate([[0], bounds, [len(row)]])):
            total += n * (n + 1) // 2
    return 4.0 * head_dim * heads * total


def cuda_time_ms(fn, warmup=3, reps=10) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return float(np.median(times))


def bound(flops: float, nbytes: float, peak_tflops: float | None = None) -> dict:
    """The least time the card could take: operations over the peak rate of
    their type (default the bf16 tensor-core peak) or bytes over the memory
    rate, whichever is larger."""
    ops_ms = flops / ((peak_tflops or device_peak_tflops()) * 1e12) * 1e3
    bytes_ms = nbytes / device_peak_bandwidth() * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms), "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def sdpa_inputs(q, k, v, seg):
    """(B, H, S, D) leaves and the boolean causal ∧ same-segment mask (B, 1,
    S, S) for torch's scaled_dot_product_attention, the library yardstick."""
    S = q.shape[1]
    mask = torch.tril(torch.ones(S, S, dtype=torch.bool, device=q.device))[None, None]
    mask = mask & (seg[:, None, :, None] == seg[:, None, None, :])
    return [t.transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v)], mask


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; nothing was run")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "device", "name": torch.cuda.get_device_name(0), "nvidia_smi": smi,
          "count": torch.cuda.device_count(), "torch": torch.__version__, "cuda": torch.version.cuda,
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32})
    return smi


def sass_mma_counts(source: str) -> dict:
    """{kernel: [HGMMA, HMMA]}: the wgmma and the legacy mma.sync
    instructions in each entry function of a built library, from
    ``cuobjdump -sass``; each instantiation by its name as ``cu++filt``
    gives it (mangled where the toolkit has no ``cu++filt``)."""
    tools = Path(build.find_nvcc()).parent
    sass = subprocess.run([str(tools / "cuobjdump"), "-sass", str(build.library_path(source))], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    counts, fn = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            fn = m.group(1)
            counts[fn] = [0, 0]
        elif fn is not None:
            counts[fn][0] += "HGMMA" in ln
            counts[fn][1] += " HMMA" in ln
    filt = tools / "cu++filt"
    if filt.exists() and counts:
        names = subprocess.run([str(filt)], input="\n".join(counts), capture_output=True, text=True,
                               timeout=60).stdout.splitlines()
        if len(names) == len(counts):
            counts = {re.sub(r"\(anonymous namespace\)::", "", n): v for n, v in zip(names, counts.values())}
    return counts


# the wgmma sources (every splash instantiation, fp32's included, and gmm):
# each entry must issue HGMMA and no HMMA, and no spill is taken (a spill
# serialises their mainloops)
WGMMA_SOURCES = (splash.SOURCE, splash.BWD_SOURCE, gmm.SOURCE)


def phase_build(dev):
    sources = WGMMA_SOURCES
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc per source, all at once
        logs = list(pool.map(lambda src: build.build(src)[1], sources))
    for src in sources:
        build.load(src)
    cuda_s = time.perf_counter() - t0
    spilled, legacy = [], {}
    for src, log in zip(sources, logs):
        ptxas = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        mma = sass_mma_counts(src)
        emit({"phase": "build", "source": f"internevo_tpu_torch/csrc/{src}", "seconds": cuda_s,
              "ptxas": ptxas, "sass_hgmma_hmma": mma})
        # a spill serialises the wgmma mainloop (ptxas C7514/C7518): refuse it
        if any(int(b) for ln in ptxas for b in re.findall(r"(\d+) bytes spill (?:stores|loads)", ln)):
            spilled.append(src)
        legacy.update({k: v for k, v in mma.items() if not v[0] or v[1]})
    if spilled:
        raise AssertionError(f"ptxas spilled registers in {spilled}")
    if legacy:
        raise AssertionError(f"kernels without wgmma, or with mma.sync: {legacy}")
    n = 2 * fused_adamw.BLOCK
    f32 = [torch.zeros(n, device=dev) for _ in range(4)]
    sc = fused_adamw.adamw_scalars(0, 0.9, 0.95, 1, 1, 1e-8, 0, 1, 0, dev)
    for dtype in (torch.bfloat16, torch.float16, torch.float32):  # the param dtypes of the training paths
        t0 = time.perf_counter()
        handle = fused_adamw.launch(*f32, torch.zeros(n, dtype=dtype, device=dev), sc)
        torch.cuda.synchronize()
        emit({"phase": "build", "source": "internevo_tpu_torch/ops/cuda/fused_adamw.py (Triton JIT)",
              "param_dtype": str(dtype), "seconds": time.perf_counter() - t0,
              "registers": getattr(handle, "n_regs", None), "spills": getattr(handle, "n_spills", None)})
    t0 = time.perf_counter()
    _, handle = dropout.launch(torch.zeros(n, dtype=BF16, device=dev), (0, 1), 0.1)  # the training path's dtype
    torch.cuda.synchronize()
    emit({"phase": "build", "source": "internevo_tpu_torch/ops/cuda/dropout.py (Triton JIT)", "dtype": "bf16",
          "seconds": time.perf_counter() - t0, "registers": getattr(handle, "n_regs", None),
          "spills": getattr(handle, "n_spills", None)})


def phase_kernel(dev):
    """Five cases at the scoring shapes; then a planted fault (every q item's
    kv window one tile short) that the check must refuse; timings in the
    packed MHA case.  Returns the kernels-line numbers."""
    g = torch.Generator(device=dev).manual_seed(SEED)
    rng = np.random.RandomState(SEED)

    def inputs(S, hkv):
        q = torch.randn(SCORE_B, S, 32, 128, generator=g, device=dev).to(torch.bfloat16)
        k = torch.randn(SCORE_B, S, hkv, 128, generator=g, device=dev).to(torch.bfloat16)
        v = torch.randn(SCORE_B, S, hkv, 128, generator=g, device=dev).to(torch.bfloat16)
        seg, _ = packed_segments(SCORE_B, S, MAX_SEG, PAD, rng)
        return q, k, v, torch.from_numpy(seg).to(dev)

    cases = {
        "packed_mha": dict(S=SCORE_S, hkv=32),
        "gqa_32_8": dict(S=SCORE_S, hkv=8),
        "dropout_0.1": dict(S=SCORE_S, hkv=32, dropout_rate=0.1, dropout_seed=[1234, 0, 0, 0, 0]),
        "cross_kv": dict(S=SCORE_S, hkv=32, cross=True),
        "ragged_4000": dict(S=4000, hkv=32),
    }
    worst_out = worst_lse = 0.0
    timed = None

    def outside(out, ref_out) -> int:
        return int(((out.float() - ref_out.float()).abs() > OUT_ATOL + OUT_RTOL * ref_out.float().abs()).sum())

    for name, c in cases.items():
        q, k, v, seg = inputs(c["S"], c["hkv"])
        kv_seg = torch.roll(seg, c["S"] // 3, dims=1) if c.get("cross") else None
        kw = dict(dropout_rate=c.get("dropout_rate", 0.0), dropout_seed=c.get("dropout_seed"))
        out, lse = splash.splash_attention_with_lse(q, k, v, seg, kv_seg, max_segment_len=MAX_SEG, **kw)
        torch.cuda.synchronize()
        ref_out, ref_lse = splash.plain_forward(q, k, v, seg, kv_seg, None, True, **kw)
        empty = torch.isneginf(ref_lse)
        if not torch.equal(torch.isneginf(lse), empty):
            raise AssertionError(f"{name}: kernel and plain disagree on which rows are empty")
        err_out = float((out.float() - ref_out.float()).abs().max())
        err_lse = float((lse - ref_lse)[~empty].abs().max())
        bad = outside(out, ref_out)
        emit({"phase": "kernel", "case": name, "shape_q": list(q.shape), "kv_heads": c["hkv"],
              "max_err_out": err_out, "max_err_lse": err_lse, "empty_rows": int(empty.sum()),
              "out_outside_bound": bad})
        if bad or not err_lse <= LSE_ATOL or not torch.isfinite(out.float()).all():
            raise AssertionError(f"{name}: kernel disagrees with its plain version "
                                 f"(out {err_out}, {bad} outside bound; lse {err_lse})")
        worst_out, worst_lse = max(worst_out, err_out), max(worst_lse, err_lse)
        if name == "packed_mha":
            timed, timed_want = (q, k, v, seg), ref_out
        del q, k, v, out, lse, ref_out, ref_lse
    q, k, v, seg = timed
    planted = splash.ForwardCall(q, k, v, seg, None, q.shape[-1] ** -0.5, True, False, 0.0, None)
    planted.segs[2].add_(1)  # kv_lo, in place: the kernel reads it through the same pointer
    planted.launch()
    torch.cuda.synchronize()
    caught = outside(planted.out, timed_want)
    emit({"phase": "kernel", "case": "planted fault: kv_lo + 1", "out_outside_bound": caught,
          "max_err_out": float((planted.out.float() - timed_want.float()).abs().max())})
    if not caught:
        raise AssertionError("the forward check let a kv window one tile short through")
    del planted
    call = splash.ForwardCall(q, k, v, seg, None, q.shape[-1] ** -0.5, True, False, 0.0, None)
    kernel_ms = cuda_time_ms(call.launch)
    wrapper_ms = cuda_time_ms(lambda: splash.splash_attention(q, k, v, seg, max_segment_len=MAX_SEG))
    plain_ms = cuda_time_ms(lambda: splash.plain_forward(q, k, v, seg))
    (qt, kt, vt), mask = sdpa_inputs(q, k, v, seg)
    with torch.no_grad():
        library_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask))
    del mask
    flex = flex_forward(qt.detach(), kt.detach(), vt.detach(), seg, timed_want)
    del qt, kt, vt, timed_want
    flops = attention_flops(seg.cpu().numpy(), q.shape[2], q.shape[3])
    # q, k, v and the segment ids read once; out (like q) and lse (B, Hq, S) fp32 written once
    b = bound(flops, nbytes(q, k, v, seg) + nbytes(q) + 4 * q.shape[0] * q.shape[2] * q.shape[1])
    emit({"phase": "kernel", "case": "timing packed_mha", "kernel_ms": kernel_ms, "wrapper_ms": wrapper_ms,
          "plain_ms": plain_ms,
          "library_ms": library_ms, "library": "scaled_dot_product_attention, bool mask (B, 1, S, S)",
          **flex, **b, "useful_tflop": flops / 1e12, "kernel_tflops": flops / kernel_ms / 1e9,
          "kernel_share_of_bf16_peak": flops / kernel_ms / 1e9 / device_peak_tflops()})
    return {"max_err_out": worst_out, "max_err_lse": worst_lse, "kernel_ms": kernel_ms, "wrapper_ms": wrapper_ms,
            "plain_ms": plain_ms, "library_ms": library_ms, "library_flex_ms": flex["library_flex_ms"], **b}


def flex_forward(qt, kt, vt, seg, want) -> dict:
    """The like-for-like yardstick of the splash forward: compiled
    ``flex_attention`` with a (same segment ∧ causal) block mask, which skips
    the masked blocks as the kernel does, forward only under ``no_grad``.
    (B, H, S, D) inputs; its out is held loosely against ``want``, the plain
    out, only to show it computes the same function.  The port never calls
    it."""
    from torch.nn.attention.flex_attention import create_block_mask, flex_attention

    def same_run_causal(b, h, qi, ki):
        return (qi >= ki) & (seg[b, qi] == seg[b, ki])

    S = qt.shape[2]
    t0 = time.perf_counter()
    block_mask = create_block_mask(same_run_causal, seg.shape[0], None, S, S, device=qt.device)
    flex = torch.compile(flex_attention)
    with torch.no_grad():
        o = flex(qt, kt, vt, block_mask=block_mask)
        torch.cuda.synchronize()
        compile_s = time.perf_counter() - t0
        rel = float((o.transpose(1, 2).float() - want.float()).norm() / want.float().norm())
        del o
        ms = cuda_time_ms(lambda: flex(qt, kt, vt, block_mask=block_mask))
    if not rel <= 1e-2:
        raise AssertionError(f"compiled flex_attention's out is {rel} (relative L2) from the plain out")
    return {"library_flex_ms": ms, "library_flex": "torch.compile(flex_attention) forward, no_grad, block mask "
            "(same segment ∧ causal)", "library_flex_compile_s": compile_s, "library_flex_rel_l2": rel}


def plain_attention(q, k, v, segment_ids=None, softmax_scale=None, causal=True, dropout_rate=0.0,
                    dropout_seed=None, **_):
    """``flash_attention``'s signature on the splash plain forward: dense torch,
    differentiable by plain autograd, with the kernels' dropout hash."""
    return splash.plain_forward(q, k, v, segment_ids, None, softmax_scale, causal, dropout_rate, dropout_seed)[0]


def plain_block(cfg, batch, train=False):
    """A ``block_fn`` for ``model.apply``: the model's block with the plain
    attention in place of the kernel (the same dropout masks and seeds)."""
    def block(layer, h, key):
        return block_forward(cfg, layer, h, batch["indexes"], batch["segment_ids"], key, train,
                             attention_fn=plain_attention)
    return block


def scoring_rows(vocab: int, dev) -> dict:
    """Phase 4's two packed rows of 4096 tokens (357 padding tokens a row)."""
    rng = np.random.RandomState(SEED + 1)
    seg, pos = packed_segments(SCORE_B, SCORE_S, MAX_SEG, PAD, rng)
    labels = rng.randint(0, vocab, (SCORE_B, SCORE_S))
    labels[:, SCORE_S - PAD:] = -100
    return {"input_ids": torch.from_numpy(rng.randint(0, vocab, (SCORE_B, SCORE_S))).to(dev),
            "indexes": torch.from_numpy(pos).to(dev), "segment_ids": torch.from_numpy(seg).to(dev),
            "labels": torch.from_numpy(labels).to(dev)}


def phase_scoring(model, params, dev, phase="scoring", source="configs/7B_sft.py"):
    """``source``'s model scores two packed rows of 4096 tokens through
    ``make_eval_step``, plain and per token; one splash forward a layer,
    and the loss held against a forward with the plain attention."""
    cfg = model.config
    batch = scoring_rows(cfg.vocab_size, dev)
    n_valid = SCORE_B * (SCORE_S - PAD)
    step = make_eval_step(model)
    step_tok = make_eval_step(model, per_token=True)

    splash.launches = 0
    r = step(params, batch)
    after_first = splash.launches
    rt = step_tok(params, batch)
    torch.cuda.synchronize()
    launches = splash.launches
    if (after_first, launches) != (cfg.num_layers, 2 * cfg.num_layers):
        raise AssertionError(f"kernel launches {after_first}, {launches}: want {cfg.num_layers} per forward")
    loss, loss_tok = float(r["loss"]), float(rt["loss"])
    if not (math.isfinite(loss) and math.isfinite(loss_tok)) or abs(loss - loss_tok) > 1e-3:
        raise AssertionError(f"scoring loss {loss} / per-token {loss_tok}")
    if int(r["n_tokens"]) != n_valid or tuple(rt["nll"].shape) != (SCORE_B, SCORE_S):
        raise AssertionError(f"n_tokens {int(r['n_tokens'])} != {n_valid} or nll {tuple(rt['nll'].shape)}")
    if not bool(torch.isfinite(rt["nll"]).all()):
        raise AssertionError("non-finite per-token nll")

    seconds = cuda_time_ms(lambda: step(params, batch), warmup=1, reps=5) / 1e3
    # Megatron accounting with the forward's factor 1 in place of training's 3
    fwd_tflops = get_megatron_flops(seconds, seq_len=SCORE_S, hidden_size=cfg.hidden_size,
                                    num_layers=cfg.num_layers, vocab_size=cfg.vocab_size,
                                    global_batch_size=SCORE_B, mlp_ratio=cfg.mlp_ratio) / 3

    with torch.inference_mode():
        hidden = model.apply(params, batch["input_ids"], batch["indexes"], batch["segment_ids"],
                             block_fn=plain_block(cfg, batch), return_hidden=True)
        nll_sum, n, _ = fused_norm_head_ce(hidden, params["norm"], params["head"]["weight"],
                                           batch["labels"], eps=cfg.layer_norm_epsilon,
                                           embed_grad_scale=cfg.embed_grad_scale)
    loss_plain = float(nll_sum / n)
    gap = abs(loss - loss_plain)
    emit({"phase": phase, "model": source, "layers": cfg.num_layers, "hidden": cfg.hidden_size,
          "heads_q_kv": [cfg.num_attention_heads, cfg.num_kv_attention_heads],
          "params": sum(p.numel() for p in tree_leaves(params)), "tokens": SCORE_B * SCORE_S, "valid_tokens": n_valid,
          "loss": loss, "loss_per_token_path": loss_tok, "loss_plain_attention": loss_plain,
          "gap": gap, "gap_bound": LOSS_GAP, "n_correct": int(r["n_correct"]),
          "step_s": seconds, "tokens_per_s": SCORE_B * SCORE_S / seconds,
          "fwd_tflops_megatron": fwd_tflops, "mfu": fwd_tflops / device_peak_tflops(),
          "mfu_counts": "get_megatron_flops / 3: MHA projections (an overcount under GQA)",
          "launches": launches})
    if not gap <= LOSS_GAP:
        raise AssertionError(f"kernel-path loss {loss} vs plain-attention loss {loss_plain}")
    return launches


def phase_serving(model, params, dev, phase="serving", greedy_prompts=GREEDY_PROMPTS, sampled=True):
    """Greedy requests of ``NEW_TOKENS`` new tokens for each prompt length
    in ``greedy_prompts``, each repeatable, and the prefill logits of the
    decode path held against ``model_forward``'s; with ``sampled``, one
    sampled batch whose every token lies in its step's top-k / top-p set."""
    cfg = model.config
    rng = np.random.RandomState(SEED + 2)
    gen = SequenceGenerator((model, params), eos_token_id=-1)
    new_tokens, gen_s = 0, 0.0

    def timed_generate(prompt, **kw):
        nonlocal new_tokens, gen_s
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = gen.generate(prompt, **kw)
        torch.cuda.synchronize()
        gen_s += time.perf_counter() - t0
        new_tokens += out.numel() - prompt.numel()
        return out

    for n in greedy_prompts:
        prompt = torch.from_numpy(rng.randint(3, cfg.vocab_size, (1, n))).to(dev)
        out = timed_generate(prompt, max_length=n + NEW_TOKENS)
        if out.shape != (1, n + NEW_TOKENS) or not torch.equal(gen.generate(prompt, max_length=n + NEW_TOKENS), out):
            raise AssertionError(f"greedy request of prompt {n}: shape {tuple(out.shape)} or not repeatable")
    # prefill logits: the decode path against model_forward, the kernel path
    with torch.inference_mode():
        ref = model.apply(params, prompt, torch.arange(n, device=dev)[None],
                          torch.ones(1, n, dtype=torch.int32, device=dev)).float()
        dec, _ = model_decode_step(cfg, params, prompt, init_kv_cache(cfg, 1, n, dev), 0)
    rel_rms = float((dec - ref).norm() / ref.norm())
    if not rel_rms <= PREFILL_REL_RMS:
        raise AssertionError(f"prefill logits relative RMS {rel_rms} > {PREFILL_REL_RMS}")
    if not sampled:
        emit({"phase": phase, "requests": len(greedy_prompts), "greedy_prompts": list(greedy_prompts),
              "heads_q_kv": [cfg.num_attention_heads, cfg.num_kv_attention_heads], "new_tokens": new_tokens,
              "generate_s": gen_s, "decode_tokens_per_s": new_tokens / gen_s, "prefill_rel_rms": rel_rms})
        return

    prompt = torch.from_numpy(rng.randint(3, cfg.vocab_size, (SAMPLE_ROWS, SAMPLE_PROMPT))).to(dev)
    total = SAMPLE_PROMPT + NEW_TOKENS
    out = timed_generate(prompt, max_length=total, do_sample=True, top_k=TOP_K, top_p=TOP_P, seed=SEED)
    # replay the request's decode steps (same shapes, same cache) and check that
    # every sampled token lies in its step's top-k/top-p set
    with torch.inference_mode():
        cache = init_kv_cache(cfg, SAMPLE_ROWS, total, dev)
        logits, cache = model_decode_step(cfg, params, prompt, cache, 0)
        outside = 0
        for t in range(SAMPLE_PROMPT, total):
            allowed = torch.isfinite(top_k_top_p_filtering(logits[:, -1] / 1.0, top_k=TOP_K, top_p=TOP_P))
            outside += int((~allowed.gather(1, out[:, t:t + 1])).sum())
            if t + 1 < total:
                logits, cache = model_decode_step(cfg, params, out[:, t:t + 1], cache, t)
    emit({"phase": phase, "requests": len(greedy_prompts) + 1, "greedy_prompts": list(greedy_prompts),
          "sampled_rows": SAMPLE_ROWS, "new_tokens": new_tokens, "generate_s": gen_s,
          "decode_tokens_per_s": new_tokens / gen_s, "prefill_rel_rms": rel_rms,
          "sampled_outside_filter": outside})
    if outside:
        raise AssertionError(f"{outside} sampled tokens outside their top-k/top-p set")


def rel_l2(got, want) -> float:
    return float((got.float() - want.float()).norm() / want.float().norm().clamp_min(1e-30))


def grads_close(got, want) -> dict:
    d = (got.float() - want.float()).abs()
    return {"max_abs_err": float(d.max()),
            "outside": int((d > GRAD_ATOL + GRAD_RTOL * want.float().abs()).sum()),
            "rel_l2": float((got.float() - want.float()).norm() / want.float().norm().clamp_min(1e-30)),
            "finite": bool(torch.isfinite(got.float()).all())}


def grads_fail(checks: dict) -> list:
    """The grads of a backward check that break a bound."""
    return [n for n, r in checks.items() if r["outside"] or not r["finite"] or not r["rel_l2"] <= BWD_REL_L2]


def phase_kernel_bwd(dev):
    """The two backward kernels against plain_backward at the training shape,
    five cases; then a planted fault (every kv tile's q window one tile
    short) that the check must refuse; timings in the packed MHA case."""
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    rng = np.random.RandomState(SEED + 5)
    cases = {
        "packed_mha": dict(S=TRAIN_S, hkv=HEADS),
        "gqa_32_8": dict(S=TRAIN_S, hkv=HEADS // 4),
        "dropout_0.1": dict(S=TRAIN_S, hkv=HEADS, dropout_rate=0.1, dropout_seed=[1234, 0, 0, 0, 0]),
        "cross_kv_dlse": dict(S=TRAIN_S, hkv=HEADS, cross=True),
        "ragged_4000": dict(S=TRAIN_S - 96, hkv=HEADS),
    }
    worst = {"dkdv": 0.0, "dq": 0.0}
    timed = None
    for name, c in cases.items():
        S = c["S"]
        q = torch.randn(TRAIN_B, S, HEADS, HEAD_DIM, generator=g, device=dev).to(torch.bfloat16)
        k, v = (torch.randn(TRAIN_B, S, c["hkv"], HEAD_DIM, generator=g, device=dev).to(torch.bfloat16)
                for _ in range(2))
        seg = torch.from_numpy(packed_segments(TRAIN_B, S, MAX_SEG, 0, rng)[0]).to(dev)
        kv_seg = torch.roll(seg, S // 3, dims=1) if c.get("cross") else None
        seed = splash._norm_seed(c["dropout_seed"]) if "dropout_seed" in c else None
        rate = c.get("dropout_rate", 0.0)
        out, lse = splash.splash_attention_with_lse(q, k, v, seg, kv_seg, dropout_rate=rate, dropout_seed=seed)
        do = torch.randn(q.shape, generator=g, device=dev).to(torch.bfloat16)
        dlse = torch.randn(lse.shape, generator=g, device=dev) if c.get("cross") else None
        args = (q, k, v, out, lse, do, dlse, seg, kv_seg, HEAD_DIM**-0.5, True)
        got = splash._kernel_backward(*args, kv_seg is not None, rate, seed)
        torch.cuda.synchronize()
        want = splash.plain_backward(*args, rate, seed)
        checks = {n: grads_close(a, b) for n, a, b in zip(("dq", "dk", "dv"), got, want)}
        emit({"phase": "kernel_bwd", "case": name, "shape_q": list(q.shape), "kv_heads": c["hkv"],
              "empty_rows": int(torch.isneginf(lse).sum()), **{n: r for n, r in checks.items()}})
        if grads_fail(checks):
            raise AssertionError(f"{name}: backward kernel {grads_fail(checks)} disagrees with plain_backward: "
                                 f"{checks}")
        worst["dq"] = max(worst["dq"], checks["dq"]["max_abs_err"])
        worst["dkdv"] = max(worst["dkdv"], checks["dk"]["max_abs_err"], checks["dv"]["max_abs_err"])
        if name == "packed_mha":
            timed, timed_want = args, want
        del q, k, v, out, lse, do, got, want
    q, k, v, out, lse, do, dlse, seg, kv_seg, scale, causal = timed
    planted = splash.BackwardCall(*timed, False, 0.0, None)
    planted.segs[3].sub_(1)  # q_hi, in place: the kernel reads it through the same pointer
    planted.launch_dkdv()
    torch.cuda.synchronize()
    caught = grads_fail({n: grads_close(a, b) for n, a, b in zip(("dk", "dv"), (planted.dk, planted.dv),
                                                                 timed_want[1:])})
    emit({"phase": "kernel_bwd", "case": "planted fault: q_hi - 1", "refused": caught,
          "rel_l2_dk": grads_close(planted.dk, timed_want[1])["rel_l2"]})
    if caught != ["dk", "dv"]:
        raise AssertionError(f"the backward check let a q window one tile short through: {caught}")
    del planted
    call = splash.BackwardCall(*timed, False, 0.0, None)
    dkdv_ms = cuda_time_ms(call.launch_dkdv)
    dq_ms = cuda_time_ms(call.launch_dq)
    bwd_ms = cuda_time_ms(lambda: splash._kernel_backward(*timed, False, 0.0, None))
    plain_ms = cuda_time_ms(lambda: splash.plain_backward(*timed), warmup=1, reps=3)
    (qt, kt, vt), mask = sdpa_inputs(q, k, v, seg)
    dot = do.transpose(1, 2).contiguous()

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
        torch.autograd.grad(o, (qt, kt, vt), dot)

    library_fwd_bwd_ms = cuda_time_ms(sdpa_fwd_bwd, warmup=2, reps=5)
    # the backward alone, like for like with the two kernels: one forward
    # keeps its graph and each timed call runs only its backward
    o = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
    library_ms = cuda_time_ms(lambda: torch.autograd.grad(o, (qt, kt, vt), dot, retain_graph=True), warmup=2, reps=5)
    del o, mask
    flex = flex_backward(qt, kt, vt, seg, dot, timed_want)
    del qt, kt, vt, dot, timed_want
    fwd_flops = attention_flops(seg.cpu().numpy(), q.shape[2], q.shape[3])  # 2 products
    # The backward's work: 5 products (S, dP, dV, dK, dQ), 2.5x the forward's;
    # inputs q, k, v, dO, the segment ids, lse and delta (fp32, B×Hq×S) read
    # once, dq, dk, dv written once.  It is split between the two kernels so
    # that their bounds sum to the backward's: dK/dV takes S, dP, dV and dK
    # with every read and its writes; dQ takes only the dQ product and its
    # write.  The dQ kernel's recomputation of S and dP is this design's cost,
    # not the function's, and is left out of its bound
    reads = nbytes(q, k, v, do, seg) + 2 * nbytes(lse)
    b_dkdv = bound(2 * fwd_flops, reads + nbytes(k, v))
    b_dq = bound(0.5 * fwd_flops, nbytes(q))
    b_all = bound(2.5 * fwd_flops, reads + nbytes(q, k, v))
    emit({"phase": "kernel_bwd", "case": "timing packed_mha", "dkdv_ms": dkdv_ms, "dq_ms": dq_ms,
          "backward_ms": bwd_ms, "plain_ms": plain_ms, "library_ms": library_ms,
          "library": "scaled_dot_product_attention backward alone, bool mask (B, 1, S, S)",
          "library_fwd_bwd_ms": library_fwd_bwd_ms, **flex,
          "bound_dkdv": b_dkdv, "bound_dq": b_dq, "bound_backward": b_all,
          "useful_tflop": 2.5 * fwd_flops / 1e12, "backward_tflops": 2.5 * fwd_flops / bwd_ms / 1e9})
    return {"dkdv": {"ms": dkdv_ms, "max_abs_err": worst["dkdv"], **b_dkdv},
            "dq": {"ms": dq_ms, "max_abs_err": worst["dq"], **b_dq},
            "plain_ms": plain_ms, "library_ms": library_ms, "library_fwd_bwd_ms": library_fwd_bwd_ms,
            "library_flex_ms": flex["library_flex_ms"], "backward_ms": bwd_ms}


def flex_backward(qt, kt, vt, seg, dot, want) -> dict:
    """The like-for-like yardstick of the splash backward: compiled
    ``flex_attention`` with a (same segment ∧ causal) block mask, which skips
    the masked blocks as the kernels do; its backward alone is timed, as
    SDPA's.  (B, H, S, D) leaves; its grads are held loosely against
    ``want``, the plain (dq, dk, dv), only to show it computes the same
    function (a None in ``want`` is not compared).  The port never calls it."""
    from torch.nn.attention.flex_attention import create_block_mask, flex_attention

    def same_run_causal(b, h, qi, ki):
        return (qi >= ki) & (seg[b, qi] == seg[b, ki])

    S = qt.shape[2]
    t0 = time.perf_counter()
    block_mask = create_block_mask(same_run_causal, seg.shape[0], None, S, S, device=qt.device)
    o = torch.compile(flex_attention)(qt, kt, vt, block_mask=block_mask)
    grads = torch.autograd.grad(o, (qt, kt, vt), dot, retain_graph=True)
    torch.cuda.synchronize()
    compile_s = time.perf_counter() - t0
    rel = [None if w is None else float((g.transpose(1, 2).float() - w.float()).norm() / w.float().norm())
           for g, w in zip(grads, want)]
    del grads
    ms = cuda_time_ms(lambda: torch.autograd.grad(o, (qt, kt, vt), dot, retain_graph=True), warmup=2, reps=5)
    return {"library_flex_ms": ms, "library_flex": "torch.compile(flex_attention) backward alone, block mask "
            "(same segment ∧ causal)", "library_flex_compile_s": compile_s, "library_flex_rel_l2_dq_dk_dv": rel}


def phase_kernel_adamw(dev):
    """The fused AdamW kernel against its plain version at 7B leaf shapes;
    timings on the embedding leaf."""
    g = torch.Generator(device=dev).manual_seed(SEED + 6)
    lr, b1, b2, eps, wd, t = 1e-4, 0.9, 0.95, 1e-8, 0.01, 3
    worst_err = 0.0
    timed = None
    for name, (shape, skip, dtype) in ADAMW_CASES.items():
        grad = torch.randn(shape, generator=g, device=dev) * 1e-2
        m = torch.randn(shape, generator=g, device=dev) * 1e-3
        v = torch.rand(shape, generator=g, device=dev) * 1e-5
        w = torch.randn(shape, generator=g, device=dev) * 2e-2
        p = w.to(dtype)
        sc = fused_adamw.adamw_scalars(lr, b1, b2, 1 - b1**t, 1 - b2**t, eps, wd, 0.5, skip, dev)
        ref = [x.clone() for x in (m, v, w, p)]
        fused_adamw.launch(grad, m, v, w, p, sc)
        torch.cuda.synchronize()
        fused_adamw.plain_adamw_update_(grad, *ref, sc)
        errs = {n: float((a - b).abs().max()) for n, a, b in zip(("m", "v", "master"), (m, v, w), ref)}
        rel = {n: errs[n] / float(b.abs().max()) for n, b in zip(("m", "v", "master"), ref)}
        p_plain = ref[3].float()
        ulp = torch.pow(2.0, torch.floor(torch.log2(p_plain.abs().clamp_min(1e-30))) - 7)
        p_outside = int(((p.float() - p_plain).abs() > ulp + ADAMW_REL * ref[2].abs().max()).sum())
        p_cast = bool(torch.equal(p, w.to(dtype)))
        kept = bool(torch.equal(w, ref[2]) and torch.equal(p, ref[3])) if skip else None
        emit({"phase": "kernel_adamw", "case": name, "shape": list(shape), "skip": skip, "param": str(dtype),
              "max_abs_err": errs, "max_err_over_max": rel, "param_is_cast_of_master": p_cast,
              "param_outside_one_ulp": p_outside, "skip_kept_inputs": kept})
        if max(rel.values()) > ADAMW_REL or not p_cast or p_outside or kept is False:
            raise AssertionError(f"{name}: fused AdamW disagrees with its plain version: {rel}, "
                                 f"param cast {p_cast}, {p_outside} params outside one ulp")
        worst_err = max(worst_err, errs["master"])
        del ref
        if name == ADAMW_TIMED:
            timed = (grad, m, v, w, p, sc)
        del grad, m, v, w, p
        torch.cuda.empty_cache()
    grad, m, v, w, p, sc = timed
    del timed
    kernel_ms = cuda_time_ms(lambda: fused_adamw.launch(grad, m, v, w, p, sc))
    plain_ms = cuda_time_ms(lambda: fused_adamw.plain_adamw_update_(grad, m, v, w, p, sc))
    del m, v, p
    torch.cuda.empty_cache()
    param = torch.nn.Parameter(w)
    param.grad = grad
    opt = torch.optim.AdamW([param], lr=lr, betas=(b1, b2), eps=eps, weight_decay=wd, fused=True)
    library_ms = cuda_time_ms(opt.step)
    n = grad.numel()
    # read g (fp32), m, v, master; write m, v, master and the bf16 param: 30 B an element
    b = bound(10.0 * n, n * (4 + 3 * 8 + 2))
    emit({"phase": "kernel_adamw", "case": f"timing {ADAMW_TIMED}", "elements": n, "kernel_ms": kernel_ms,
          "plain_ms": plain_ms, "library_ms": library_ms,
          "library": "torch.optim.AdamW(fused=True).step() on the fp32 leaf (writes no bf16 copy)",
          **b, "kernel_gb_per_s": n * 30 / kernel_ms / 1e6})
    del opt, param, grad, w
    torch.cuda.empty_cache()
    return {"ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms, "max_abs_err": worst_err, **b}


def phase_train_grads(dev, config=None, seed=SEED + 7, phase="train_grads", limit=GRAD_REL_L2):
    """Every param grad of a 2-layer model at 7B width (``config``, default
    ``train_config(2)``), one packed row: the kernel path against plain
    attention under autograd.  With an fp16 model the loss is scaled by the
    config's initial loss scale and the grads unscaled, as the trainer's
    first step does.  The splash kernels must launch once a layer each, at
    the model's dtype and head dim."""
    config = config if config is not None else train_config(2)
    model, params = initialize_model(config, dev, torch.Generator(device=dev).manual_seed(seed))
    cfg = model.config
    scale = float(config.grad_scaler.fp16.initial_scale) if cfg.dtype == torch.float16 else 1.0
    batch = packed_batch((TRAIN_B,), TRAIN_S, 0, cfg.vocab_size, np.random.RandomState(seed), dev)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)

    def grads(block_fn=None):
        hidden = model.apply(params, batch["input_ids"], batch["indexes"], batch["segment_ids"], train=True,
                             block_fn=block_fn, return_hidden=True)
        nll, n, _ = fused_norm_head_ce(hidden, params["norm"], params["head"]["weight"], batch["labels"],
                                       eps=cfg.layer_norm_epsilon, embed_grad_scale=cfg.embed_grad_scale)
        loss = nll / n
        (loss * scale).backward()
        out = [p.grad.float() / scale for p in leaves]
        for p in leaves:
            p.grad = None
        return float(loss.detach()), out

    splash.launches_by_case.clear()
    loss_k, g_kernel = grads()
    torch.cuda.synchronize()
    launched = dict(splash.launches_by_case)
    loss_p, g_plain = grads(plain_block(cfg, batch, train=True))
    rel = [rel_l2(a, b) for a, b in zip(g_kernel, g_plain)]
    finite = all(bool(torch.isfinite(a).all()) for a in g_kernel)
    worst = int(np.argmax(rel))
    emit({"phase": phase, "case": "first-step grads vs plain attention", "dtype": str(cfg.dtype),
          "layers": cfg.num_layers, "hidden": cfg.hidden_size, "tokens": TRAIN_S, "loss_scale": scale,
          "leaves": len(rel), "loss_kernel": loss_k, "loss_plain": loss_p, "max_rel_l2": rel[worst],
          "worst_leaf": worst, "median_rel_l2": float(np.median(rel)), "bound": limit,
          "launches_by_case": {"/".join(map(str, k)): v for k, v in launched.items()}, "finite": finite})
    D = cfg.hidden_size // cfg.num_attention_heads
    want = {(k, splash.DTYPES[cfg.dtype], D): cfg.num_layers for k in ("fwd", "bwd_dkdv", "bwd_dq")}
    if launched != want:
        raise AssertionError(f"kernel launches {launched}: want {want}")
    if not finite or not rel[worst] <= limit:
        raise AssertionError(f"kernel-path grads vs plain attention: relative L2 {rel[worst]} (leaf {worst})")
    del model, params, leaves, g_kernel, g_plain


def phase_training(dev):
    """The 7B_sft configuration at 8 layers, 4 steps through the Trainer on
    one fixed batch (``tools/profile_step.py::train_setup``)."""
    torch.cuda.reset_peak_memory_stats()
    config, model, params, trainer, batch = train_setup(dev, SEED + 8)
    cfg, data = model.config, config.data
    micro_num, tokens = data.micro_num, data.micro_num * data.micro_bsz * data.seq_len
    leaves = tree_leaves(params)
    n_params = sum(p.numel() for p in leaves)

    def counts():
        return (splash.launches, splash.launches_bwd_dkdv, splash.launches_bwd_dq, fused_adamw.launches)

    splash.launches = splash.launches_bwd_dkdv = splash.launches_bwd_dq = fused_adamw.launches = 0
    losses, times = [], []
    for step in range(1, TRAIN_STEPS + 1):
        before = counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = trainer.execute_schedule(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        launched = [a - b for a, b in zip(counts(), before)]
        groups = {k: float(v) for k, v in m["grad_norm_groups"].items()}
        rec = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]), "grad_norm_groups": groups,
               "found_inf": bool(m["found_inf"]), "lr": trainer.engine.current_lr, "acc": float(m["acc"]),
               "n_tokens": int(m["n_tokens"])}
        emit({"phase": "training", "step": step, "step_s": times[-1], "launches_fwd_dkdv_dq_adamw": launched,
              **rec})
        want = [cfg.num_layers * micro_num] * 3 + [len(leaves)]
        if launched != want:
            raise AssertionError(f"step {step}: launches {launched}, want {want}")
        if rec["found_inf"] or not all(map(math.isfinite, [rec["loss"], rec["grad_norm"], *groups.values()])):
            raise AssertionError(f"step {step}: non-finite loss or grad norms: {rec}")
        if rec["n_tokens"] != tokens:
            raise AssertionError(f"step {step}: {rec['n_tokens']} valid tokens, want {tokens}")
        losses.append(rec["loss"])
    if not all(b < a for a, b in zip(losses, losses[1:])):
        raise AssertionError(f"the loss did not fall on every step: {losses}")
    step_s = float(np.median(times[1:]))
    tflops = get_megatron_flops(step_s, checkpoint=cfg.checkpoint > 0, seq_len=data.seq_len,
                                hidden_size=cfg.hidden_size, num_layers=cfg.num_layers,
                                vocab_size=cfg.vocab_size, global_batch_size=micro_num * data.micro_bsz,
                                mlp_ratio=cfg.mlp_ratio)
    total = counts()
    emit({"phase": "training", "model": "configs/7B_sft.py", "layers": cfg.num_layers,
          "cut": "num_layers 32 -> 8 (18 bytes a parameter of state at 32 layers is ~131 GB)",
          "params": n_params, "leaves": len(leaves), "micro_num": micro_num, "tokens_per_step": tokens,
          "losses": losses, "step_s_median_2_4": step_s, "step_s": times, "tokens_per_s": tokens / step_s,
          "tflops_megatron": tflops, "mfu": tflops / device_peak_tflops(),
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
          "launches_fwd_dkdv_dq_adamw": list(total)})
    del trainer, model, params, leaves, batch
    return dict(zip(("fwd", "dkdv", "dq", "adamw"), total))


def gmm_checks(got, want, bf16: bool) -> dict:
    d = got.float() - want.float()
    out = {"max_abs_err": float(d.abs().max()),
           "rel_l2": float(d.norm() / want.float().norm().clamp_min(1e-30)),
           "finite": bool(torch.isfinite(got.float()).all())}
    if bf16:
        out["outside"] = int((d.abs() > GRAD_ATOL + GRAD_RTOL * want.float().abs()).sum())
    return out


def gmm_refused(r: dict, bf16: bool) -> bool:
    return bool(r.get("outside")) or not r["finite"] or not r["rel_l2"] <= (GMM_REL_L2 if bf16 else TGMM_REL_L2)


GROUPED_MM = "torch._grouped_mm with offs"


def library_grouped_mm(a, b, offs, out_dtype):
    """One ``torch._grouped_mm`` call with ``offs``, the yardstick, where the
    card's torch has it and takes these operands; else None."""
    fn = getattr(torch, "_grouped_mm", None)
    if fn is None:
        return None
    try:
        fn(a, b, offs=offs, out_dtype=out_dtype)
    except (RuntimeError, TypeError, ValueError):
        return None
    return lambda: fn(a, b, offs=offs, out_dtype=out_dtype)


def phase_kernel_gmm(dev):
    """gmm, gmm with the rhs transposed, and tgmm against their plain
    versions at the MoE training and scoring shapes, in both directions of
    the expert MLP (w1: 4096 -> 11008, w2: 11008 -> 4096), in ``GMM_CASES``'s
    group layouts, tgmm's bf16 dW against its own fp32 dW rounded; a planted
    fault; timings of gmm and gmm dgrad in both directions in ``GMM_TIMED``'s
    layouts, of tgmm (bf16 dW) in both directions in ``TGMM_TIMED``'s, and
    with fp32 dW at the balanced layout."""
    g = torch.Generator(device=dev).manual_seed(SEED + 9)
    H, M, E = GMM_H, GMM_M, GMM_E
    n_max = max(n for n, _ in GMM_CASES.values())
    bf = lambda *shape, scale=1.0: (torch.randn(*shape, generator=g, device=dev) * scale).to(BF16)  # noqa: E731
    x, hm, dy_m, dy_h = bf(n_max, H), bf(n_max, M), bf(n_max, M), bf(n_max, H)
    w1, w2 = bf(E, H, M, scale=0.02), bf(E, M, H, scale=0.02)
    worst = {k: {"max_abs_err": 0.0, "rel_l2": 0.0} for k in ("gmm", "gmm_dgrad", "tgmm")}
    for case, (n, sizes) in GMM_CASES.items():
        gs = torch.tensor(sizes, device=dev)
        calls = {  # name: (kernel class, kernel, plain)
            "gmm_w1": ("gmm", lambda: gmm.gmm(x[:n], w1, gs), lambda: gmm.plain_gmm(x[:n], w1, gs)),
            "gmm_w2": ("gmm", lambda: gmm.gmm(hm[:n], w2, gs), lambda: gmm.plain_gmm(hm[:n], w2, gs)),
            "dgrad_w1": ("gmm_dgrad", lambda: gmm.gmm(dy_m[:n], w1, gs, transpose_rhs=True),
                         lambda: gmm.plain_gmm(dy_m[:n], w1, gs, transpose_rhs=True)),
            "dgrad_w2": ("gmm_dgrad", lambda: gmm.gmm(dy_h[:n], w2, gs, transpose_rhs=True),
                         lambda: gmm.plain_gmm(dy_h[:n], w2, gs, transpose_rhs=True)),
            "tgmm_w1": ("tgmm", lambda: gmm.tgmm(x[:n], dy_m[:n], gs, E), lambda: gmm.plain_tgmm(x[:n], dy_m[:n], gs, E)),
            "tgmm_w2": ("tgmm", lambda: gmm.tgmm(hm[:n], dy_h[:n], gs, E), lambda: gmm.plain_tgmm(hm[:n], dy_h[:n], gs, E)),
        }
        bf16_dw = {"tgmm_w1": lambda: gmm.tgmm(x[:n], dy_m[:n], gs, E, out_dtype=BF16),
                   "tgmm_w2": lambda: gmm.tgmm(hm[:n], dy_h[:n], gs, E, out_dtype=BF16)}
        checks, bad = {}, []
        for name, (cls, kernel, plain) in calls.items():
            got = kernel()
            torch.cuda.synchronize()
            bf16 = cls != "tgmm"
            r = checks[name] = gmm_checks(got, plain(), bf16)
            if not bf16:  # an empty group's dW is exactly 0 (the last group also owns the rows past the sum)
                r["empty_groups_zero"] = all(bool((got[e] == 0).all()) for e in range(E - 1) if sizes[e] == 0)
                # the bf16 dW of the training path is the fp32 dW rounded once, bit for bit
                r["bf16_equals_fp32_cast"] = bool(torch.equal(bf16_dw[name](), got.to(BF16)))
            if gmm_refused(r, bf16) or False in (r.get("empty_groups_zero"), r.get("bf16_equals_fp32_cast")):
                bad.append(name)
            for k in ("max_abs_err", "rel_l2"):
                worst[cls][k] = max(worst[cls][k], r[k])
            del got
        emit({"phase": "kernel_gmm", "case": case, "rows": n, "group_sizes": sizes, **checks})
        if bad:
            raise AssertionError(f"{case}: gmm kernels {bad} disagree with their plain versions: {checks}")

    n, sizes = GMM_CASES["balanced"]
    x_all, dy_m_all = x, dy_m
    x, dy_m = x[:n], dy_m[:n]  # the planted fault: the training shape
    gs = torch.tensor(sizes, device=dev)
    planted = {}
    for name, call, plain in (("gmm", gmm.GmmCall(x, w1, gs), lambda: gmm.plain_gmm(x, w1, gs)),
                              ("gmm_dgrad", gmm.GmmCall(dy_m, w1, gs, transpose_rhs=True),
                               lambda: gmm.plain_gmm(dy_m, w1, gs, transpose_rhs=True)),
                              ("tgmm", gmm.TgmmCall(x, dy_m, gs, E), lambda: gmm.plain_tgmm(x, dy_m, gs, E))):
        call.ends[0] += 1  # in place: the kernel reads it through the same pointer
        call.launch()
        torch.cuda.synchronize()
        bf16 = name != "tgmm"
        r = gmm_checks(call.out, plain(), bf16)
        planted[name] = {"refused": gmm_refused(r, bf16), **r}
    emit({"phase": "kernel_gmm", "case": "planted fault: first group end + 1", **planted})
    if not all(r["refused"] for r in planted.values()):
        raise AssertionError(f"the gmm check let a group end one row off through: {planted}")

    out = {name: {"timed": []} for name in ("gmm", "gmm_dgrad", "tgmm")}

    def timed(name, case, weight, flops, moved, kernel, plain, library, **shape):
        """One kernel timing beside its bound, plain version and library call;
        the balanced w1 timing is the kernels line's headline."""
        ms = cuda_time_ms(kernel)
        r = {"layout": case, "weight": weight, **shape, "ms": ms,
             "plain_ms": cuda_time_ms(plain, warmup=1, reps=3),
             "library_ms": cuda_time_ms(library) if library is not None else None, **bound(flops, moved),
             "tflops": flops / ms / 1e9, "share_of_bf16_peak": flops / ms / 1e9 / device_peak_tflops()}
        emit({"phase": "kernel_gmm", "case": f"timing {name}", "library": GROUPED_MM if library else None, **r})
        out[name]["timed"].append(r)
        if (case, weight) == ("balanced", "w1") and shape.get("out_dtype", "bf16") == "bf16":
            out[name].update({k: r[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")})

    for case in GMM_TIMED:
        n, sizes = GMM_CASES[case]
        gs = torch.tensor(sizes, device=dev)
        offs = torch.cumsum(gs, 0, dtype=torch.int32)
        experts = sum(1 for s in gmm._host_sizes(gs, n) if s)  # the weights a run must read
        for name, weight, a, w, trans in (("gmm", "w1", x_all, w1, False), ("gmm", "w2", hm, w2, False),
                                          ("gmm_dgrad", "w1", dy_m_all, w1, True),
                                          ("gmm_dgrad", "w2", dy_h, w2, True)):
            a = a[:n]
            Kc, F = a.shape[1], (w.shape[1] if trans else w.shape[2])
            timed(name, case, weight, 2.0 * n * Kc * F, nbytes(a) + experts * Kc * F * 2 + n * F * 2,
                  gmm.GmmCall(a, w, gs, transpose_rhs=trans).launch,
                  lambda: gmm.plain_gmm(a, w, gs, transpose_rhs=trans),
                  library_grouped_mm(a, w.transpose(1, 2) if trans else w, offs, BF16),
                  rows=n, contraction=Kc, columns=F)
    # tgmm with the training path's bf16 dW; at the balanced layout also with
    # the fp32 dW of the default API, the output PR 5's kernel wrote
    for case in TGMM_TIMED:
        n, sizes = GMM_CASES[case]
        gs = torch.tensor(sizes, device=dev)
        offs = torch.cumsum(gs, 0, dtype=torch.int32)
        for weight, a, b in (("w1", x_all, dy_m_all), ("w2", hm, dy_h)):
            a, b = a[:n], b[:n]
            K, N = a.shape[1], b.shape[1]
            for dt in (BF16, torch.float32) if case == "balanced" else (BF16,):
                timed("tgmm", case, weight, 2.0 * n * K * N, nbytes(a, b) + E * K * N * dt.itemsize,
                      gmm.TgmmCall(a, b, gs, E, dt).launch, lambda: gmm.plain_tgmm(a, b, gs, E, dt),
                      library_grouped_mm(a.t(), b, offs, dt), rows=n, k=K, n=N,
                      out_dtype="bf16" if dt == BF16 else "fp32")
    for name in out:
        out[name].update(worst[name], library=GROUPED_MM if out[name]["library_ms"] is not None else None)
    del x, x_all, hm, dy_m, dy_m_all, dy_h, w1, w2
    torch.cuda.empty_cache()
    return out


def moe_block(cfg, batch, grouped_dot=None, routes=None, first_ffn_input=None):
    """A ``block_fn`` for the MoE ``model.apply``: the model's block, with
    ``grouped_dot`` in place of the kernels if given, appending each layer's
    top-k expert ids to ``routes`` and the first layer's FFN input to
    ``first_ffn_input``."""
    def block(layer, h, key):
        def ffn(hh):
            if routes is not None:
                with torch.no_grad():
                    routes.append(dropless.route(layer["moe"]["gate"], hh.reshape(-1, hh.shape[-1]),
                                                 cfg.top_k)[2])
            if first_ffn_input is not None and not first_ffn_input:
                first_ffn_input.append(hh)
            return moe_ffn(cfg, layer, hh, grouped_dot=grouped_dot)
        return block_forward(cfg, layer, h, batch["indexes"], batch["segment_ids"], key, ffn=ffn)
    return block


def held_gmm(records: list):
    """A ``grouped_dot`` that launches the gmm kernel, holds each call against
    ``plain_gmm`` on the same inputs under the kernel_gmm bounds, and holds a
    planted fault (the first group end one row on) to be refused by the same
    check; appends one record a call and returns the kernel's output."""
    def dot(x, w, group_sizes):
        got = gmm.gmm(x, w, group_sizes)
        want = gmm.plain_gmm(x, w, group_sizes)
        r = gmm_checks(got, want, True)
        planted = gmm.GmmCall(x, w, group_sizes)
        planted.ends[0] += 1
        planted.launch()
        f = gmm_checks(planted.out, want, True)
        records.append({"rows": x.shape[0], "k": x.shape[1], "n": w.shape[2],
                        "group_sizes": group_sizes.tolist(), **r, "held": not gmm_refused(r, True),
                        "planted_rel_l2": f["rel_l2"], "planted_outside": f["outside"],
                        "planted_refused": gmm_refused(f, True)})
        return got
    return dot


def gmm_counts() -> tuple:
    return gmm.launches_gmm, gmm.launches_gmm_dgrad, gmm.launches_tgmm


def moe_loss_of(model, params, batch, block_fn, moe_loss_coeff, train=False, dropout_rng=None):
    """(CE + moe_loss_coeff * aux, CE) over ``batch`` through ``block_fn``
    (the model's own block if None), the layers' keys from ``dropout_rng``."""
    cfg = model.config
    hidden, aux = model.apply(params, batch["input_ids"], batch["indexes"], batch["segment_ids"], train=train,
                              block_fn=block_fn, return_hidden=True, dropout_rng=dropout_rng)
    nll, n, _ = fused_norm_head_ce(hidden, params["norm"], params["head"]["weight"], batch["labels"],
                                   eps=cfg.layer_norm_epsilon, embed_grad_scale=cfg.embed_grad_scale)
    ce = nll / n
    return ce + moe_loss_coeff * aux["moe"], ce


def phase_moe_grads(dev, config=None):
    """Every param grad of a 1-layer MoE4 model at full width over one packed
    row, through the kernels, against the same model with the plain grouped
    matmul; the routing of the two runs must be identical."""
    config = config if config is not None else moe_config(1)
    model, params = initialize_model(config, dev, torch.Generator(device=dev).manual_seed(SEED + 10))
    cfg = model.config
    batch = packed_batch((TRAIN_B,), TRAIN_S, 0, cfg.vocab_size, np.random.RandomState(SEED + 10), dev)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)

    def grads(grouped_dot):
        routes = []
        loss, _ = moe_loss_of(model, params, batch, moe_block(cfg, batch, grouped_dot, routes),
                              config.loss.moe_loss_coeff, train=True)
        loss.backward()
        out = [p.grad for p in leaves]
        for p in leaves:
            p.grad = None
        return float(loss.detach()), out, routes

    before = gmm_counts()
    loss_k, g_kernel, r_kernel = grads(None)
    torch.cuda.synchronize()
    launched = tuple(a - b for a, b in zip(gmm_counts(), before))
    loss_p, g_plain, r_plain = grads(gmm.plain_gmm)
    same_routing = all(torch.equal(a, b) for a, b in zip(r_kernel, r_plain))
    rel = [float((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30))
           for a, b in zip(g_kernel, g_plain)]
    finite = all(bool(torch.isfinite(a.float()).all()) for a in g_kernel)
    worst = int(np.argmax(rel))
    want = (3 * cfg.num_layers,) * 3
    emit({"phase": "moe_grads", "model": "configs/7B_MoE4_sft.py (MegaBlock-D)", "layers": cfg.num_layers,
          "hidden": cfg.hidden_size, "experts": cfg.num_experts, "top_k": cfg.top_k, "tokens": TRAIN_S,
          "leaves": len(rel), "loss_kernel": loss_k, "loss_plain": loss_p, "same_routing": same_routing,
          "max_rel_l2": rel[worst], "worst_leaf": worst, "median_rel_l2": float(np.median(rel)),
          "bound": GRAD_REL_L2, "launches_gmm_dgrad_tgmm": list(launched), "finite": finite})
    if launched != want or not same_routing:
        raise AssertionError(f"gmm launches {launched} (want {want}) or routing differs ({same_routing})")
    if not finite or not rel[worst] <= GRAD_REL_L2:
        raise AssertionError(f"kernel-path MoE grads vs plain gmm: relative L2 {rel[worst]} (leaf {worst})")
    del model, params, leaves, g_kernel, g_plain


def phase_moe_scoring(dev, config=None):
    """The MoE4 model at full width and depth scores two packed rows of 4096
    tokens through ``make_eval_step``, plain and per token."""
    config = config if config is not None else moe_config()
    torch.cuda.reset_peak_memory_stats()
    model, params = initialize_model(config, dev, torch.Generator(device=dev).manual_seed(SEED))
    cfg = model.config
    batch = scoring_rows(cfg.vocab_size, dev)
    n_valid = SCORE_B * (SCORE_S - PAD)
    step = make_eval_step(model)
    step_tok = make_eval_step(model, per_token=True)

    gmm.launches_gmm = gmm.launches_gmm_dgrad = gmm.launches_tgmm = splash.launches = 0
    r = step(params, batch)
    after_first = gmm_counts()
    rt = step_tok(params, batch)
    torch.cuda.synchronize()
    launches = gmm_counts()
    L = cfg.num_layers
    if (after_first, launches, splash.launches) != ((3 * L, 0, 0), (6 * L, 0, 0), 2 * L):
        raise AssertionError(f"gmm launches {after_first}, {launches}, splash {splash.launches}: "
                             f"want {3 * L} gmm and {L} splash per forward, no backward kernels")
    loss, loss_tok = float(r["loss"]), float(rt["loss"])
    if not (math.isfinite(loss) and math.isfinite(loss_tok)) or abs(loss - loss_tok) > MOE_TOKEN_PATH_GAP:
        raise AssertionError(f"MoE scoring loss {loss} / per-token path {loss_tok}")
    if int(r["n_tokens"]) != n_valid or tuple(rt["nll"].shape) != (SCORE_B, SCORE_S):
        raise AssertionError(f"n_tokens {int(r['n_tokens'])} != {n_valid} or nll {tuple(rt['nll'].shape)}")
    if not bool(torch.isfinite(rt["nll"]).all()):
        raise AssertionError("non-finite per-token nll")
    del rt
    seconds = cuda_time_ms(lambda: step(params, batch), warmup=1, reps=3) / 1e3
    # activated flops (bench.py:73-81): the top_k experts' SwiGLU, mlp_ratio * top_k
    fwd_tflops = get_megatron_flops(seconds, seq_len=SCORE_S, hidden_size=cfg.hidden_size, num_layers=L,
                                    vocab_size=cfg.vocab_size, global_batch_size=SCORE_B,
                                    mlp_ratio=cfg.mlp_ratio * cfg.top_k) / 3
    peak = torch.cuda.max_memory_allocated() / 1e9

    with torch.inference_mode():
        r_kernel, r_plain, first = [], [], []
        coeff = config.loss.moe_loss_coeff
        _, ce_kernel = moe_loss_of(model, params, batch, moe_block(cfg, batch, None, r_kernel, first), coeff)
        _, ce_plain = moe_loss_of(model, params, batch, moe_block(cfg, batch, gmm.plain_gmm, r_plain), coeff)
        # layer 0's three gmm calls at this batch's routing (16,384 rows), each
        # held against plain_gmm on its own inputs: the kernel's check on the
        # scoring path, where the loss alone cannot tell a fault from rounding
        calls = []
        moe_ffn(cfg, params["blocks"][0], first[0], grouped_dot=held_gmm(calls))
        # the same planted fault through all 32 layers: what the loss reads for it
        shift = torch.tensor([1, -1] + [0] * (cfg.num_experts - 2), device=dev)
        fault = lambda x, w, gs: gmm.gmm(x, w, gs + shift)  # noqa: E731
        _, ce_fault = moe_loss_of(model, params, batch, moe_block(cfg, batch, fault), coeff)
    del first
    loss_plain = float(ce_plain)
    diffs = [int((a != b).any(-1).sum()) for a, b in zip(r_kernel, r_plain)]
    gap = abs(loss - loss_plain)
    emit({"phase": "moe_scoring", "case": "layer 0 gmm calls vs plain_gmm", "calls": calls})
    emit({"phase": "moe_scoring", "model": "configs/7B_MoE4_sft.py (MegaBlock-D)", "layers": L,
          "hidden": cfg.hidden_size, "experts": cfg.num_experts, "top_k": cfg.top_k,
          "params": sum(p.numel() for p in tree_leaves(params)), "tokens": SCORE_B * SCORE_S,
          "valid_tokens": n_valid, "loss": loss, "loss_per_token_path": loss_tok,
          "loss_kernel_recorded": float(ce_kernel), "loss_plain_gmm": loss_plain, "gap": gap,
          "gap_bound": MOE_LOSS_GAP, "planted_fault_loss": float(ce_fault),
          "planted_fault_gap": abs(float(ce_fault) - loss_plain), "routing_differences": sum(diffs),
          "routing_differences_by_layer": diffs,
          "routed_slots": SCORE_B * SCORE_S * cfg.top_k * L, "step_s": seconds,
          "tokens_per_s": SCORE_B * SCORE_S / seconds, "fwd_tflops_activated": fwd_tflops,
          "mfu": fwd_tflops / device_peak_tflops(), "peak_memory_gb": peak, "launches_gmm": launches[0]})
    if len(calls) != 3 or not all(c["held"] and c["planted_refused"] for c in calls):
        raise AssertionError(f"layer 0's gmm calls at the scoring shape: {calls}")
    if diffs[0] or not gap <= MOE_LOSS_GAP:
        raise AssertionError(f"kernel-path loss {loss} vs plain gmm {loss_plain}; layer-0 routing differs "
                             f"on {diffs[0]} tokens (its input is the same in both)")
    del model, params, batch
    return launches[0]


def phase_moe_training(dev, setup=moe_train_setup):
    """The MoE4 configuration at 4 layers, 4 steps through the Trainer on one
    fixed batch (``tools/profile_step.py::moe_train_setup``)."""
    torch.cuda.reset_peak_memory_stats()
    config, model, params, trainer, batch = setup(dev, SEED + 11)
    cfg, data = model.config, config.data
    micro_num, tokens = data.micro_num, data.micro_num * data.micro_bsz * data.seq_len
    leaves = tree_leaves(params)
    n_params = sum(p.numel() for p in leaves)

    def counts():
        return (*gmm_counts(), splash.launches, splash.launches_bwd_dkdv, splash.launches_bwd_dq,
                fused_adamw.launches)

    gmm.launches_gmm = gmm.launches_gmm_dgrad = gmm.launches_tgmm = 0
    splash.launches = splash.launches_bwd_dkdv = splash.launches_bwd_dq = fused_adamw.launches = 0
    losses, times, moe_losses = [], [], []
    L = cfg.num_layers
    want = [3 * L * micro_num] * 3 + [L * micro_num] * 3 + [len(leaves)]
    for step in range(1, TRAIN_STEPS + 1):
        before = counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = trainer.execute_schedule(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        launched = [a - b for a, b in zip(counts(), before)]
        groups = {k: float(v) for k, v in m["grad_norm_groups"].items()}
        rec = {"loss": float(m["loss"]), "moe_loss": float(m["moe_loss"]), "grad_norm": float(m["grad_norm"]),
               "grad_norm_groups": groups, "found_inf": bool(m["found_inf"]), "lr": trainer.engine.current_lr,
               "n_tokens": int(m["n_tokens"])}
        emit({"phase": "moe_training", "step": step, "step_s": times[-1],
              "launches_gmm_dgrad_tgmm_fwd_dkdv_dq_adamw": launched, **rec})
        if launched != want:
            raise AssertionError(f"step {step}: launches {launched}, want {want}")
        if rec["found_inf"] or not all(map(math.isfinite, [rec["loss"], rec["grad_norm"], *groups.values()])):
            raise AssertionError(f"step {step}: non-finite loss or grad norms: {rec}")
        if not (math.isfinite(rec["moe_loss"]) and rec["moe_loss"] > 0) or rec["n_tokens"] != tokens:
            raise AssertionError(f"step {step}: moe_loss {rec['moe_loss']} or {rec['n_tokens']} tokens")
        losses.append(rec["loss"])
        moe_losses.append(rec["moe_loss"])
    if not all(b < a for a, b in zip(losses, losses[1:])):
        raise AssertionError(f"the loss did not fall on every step: {losses}")
    step_s = float(np.median(times[1:]))
    tflops = get_megatron_flops(step_s, checkpoint=cfg.checkpoint > 0, seq_len=data.seq_len,
                                hidden_size=cfg.hidden_size, num_layers=L, vocab_size=cfg.vocab_size,
                                global_batch_size=micro_num * data.micro_bsz, mlp_ratio=cfg.mlp_ratio * cfg.top_k)
    total = counts()
    emit({"phase": "moe_training", "model": "configs/7B_MoE4_sft.py (MegaBlock-D)", "layers": L,
          "cut": f"num_layers 32 -> {L} (18 bytes a parameter of state at 32 layers is ~365 GB)",
          "params": n_params, "leaves": len(leaves), "micro_num": micro_num, "tokens_per_step": tokens,
          "losses": losses, "step_s_median_2_4": step_s, "step_s": times, "tokens_per_s": tokens / step_s,
          "tflops_activated": tflops, "mfu": tflops / device_peak_tflops(),
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
          "launches_gmm_dgrad_tgmm_fwd_dkdv_dq_adamw": list(total)})
    trajectory = {"loss": losses, "moe_loss": moe_losses}
    del trainer, model, params, leaves, batch
    return dict(zip(("gmm", "gmm_dgrad", "tgmm"), total[:3])), trajectory


def phase_moe_training_plain(dev, kernel_trajectory, setup=moe_train_setup):
    """``phase_moe_training``'s 4 steps again, from the same seed, with the
    plain grouped matmul in place of the kernels (``GroupedMatmul`` on
    ``plain_gmm`` / ``plain_tgmm``: the same custom backward); each step's
    loss and ``moe_loss`` held against the kernel path's."""
    use_plain = gmm._use_plain
    gmm._use_plain = lambda x: True
    try:
        config, model, params, trainer, batch = setup(dev, SEED + 11)
        before = gmm_counts()
        plain = [(float(m["loss"]), float(m["moe_loss"]))
                 for m in (trainer.execute_schedule(batch) for _ in range(TRAIN_STEPS))]
        launched = [a - b for a, b in zip(gmm_counts(), before)]
    finally:
        gmm._use_plain = use_plain
    del trainer, model, params, batch
    loss_gap = [abs(a - b[0]) for a, b in zip(kernel_trajectory["loss"], plain)]
    moe_gap = [abs(a - b[1]) for a, b in zip(kernel_trajectory["moe_loss"], plain)]
    emit({"phase": "moe_training_plain", "losses_kernel": kernel_trajectory["loss"],
          "losses_plain": [p[0] for p in plain], "moe_losses_kernel": kernel_trajectory["moe_loss"],
          "moe_losses_plain": [p[1] for p in plain], "loss_gap": loss_gap, "moe_loss_gap": moe_gap,
          "loss_gap_bound": MOE_TRAIN_LOSS_GAP, "moe_loss_gap_bound": MOE_TRAIN_MOE_LOSS_GAP,
          "gmm_launches": launched})
    if any(launched):
        raise AssertionError(f"the plain trajectory launched gmm kernels: {launched}")
    if not all(a <= b for a, b in zip(loss_gap + moe_gap, MOE_TRAIN_LOSS_GAP + MOE_TRAIN_MOE_LOSS_GAP)):
        raise AssertionError(f"the kernel path's training left the plain path's: loss {loss_gap}, "
                             f"moe_loss {moe_gap}")


def micro_key(step: int = 0, micro: int = 0) -> jrandom.Key:
    """The train step's key of one micro-batch under the launch seed 1024:
    ``rng(1024, "dropout")`` folded by the step, then the micro-batch."""
    return jrandom.fold_in(jrandom.fold_in(jrandom.rng(1024, "dropout"), step), micro)


def bitwise_equal(a, b) -> bool:
    return a.dtype == b.dtype and bool(torch.equal(a.view(torch.int16 if a.element_size() == 2 else torch.int32),
                                                   b.view(torch.int16 if b.element_size() == 2 else torch.int32)))


def phase_kernel_dropout(dev):
    """The Triton dropout kernel against its plain version at one packed
    4096-token row of 7B width, bf16, forward and backward through the
    autograd Function, bit for bit, at ``DROPOUT_RATES``; a planted fault
    (layer 4's key in place of layer 3's) the check must refuse; timings."""
    g = torch.Generator(device=dev).manual_seed(SEED + 13)
    x = torch.randn(DROPOUT_SHAPE, generator=g, device=dev).to(BF16)
    gy = torch.randn(DROPOUT_SHAPE, generator=g, device=dev).to(BF16)
    key = jrandom.fold_in(jrandom.fold_in(micro_key(), 3), 0)      # layer 3, tag 0
    planted_key = jrandom.fold_in(jrandom.fold_in(micro_key(), 4), 0)
    worst = 0.0
    for rate in DROPOUT_RATES:
        xr = x.clone().requires_grad_()
        y = dropout.dropout(xr, key, rate)
        y.backward(gy)
        planted = dropout.launch(x, planted_key, rate)[0]
        torch.cuda.synchronize()
        want_y, want_g = dropout.plain_dropout(x, key, rate), dropout.plain_dropout(gy, key, rate)
        y = y.detach()
        err = max(float((y.float() - want_y.float()).abs().max()), float((xr.grad.float() - want_g.float()).abs().max()))
        differ = float((planted.view(torch.int16) != want_y.view(torch.int16)).float().mean())
        expect = 2 * rate * (1 - rate)
        r = {"rate": rate, "forward_bitwise": bitwise_equal(y, want_y), "backward_bitwise": bitwise_equal(xr.grad, want_g),
             "max_abs_err": err, "kept_share": float((want_y != 0).float().mean()),
             "planted_refused": not bitwise_equal(planted, want_y), "planted_differ_share": differ,
             "planted_expected_share": expect}
        emit({"phase": "kernel_dropout", "case": f"rate {rate}", "shape": list(DROPOUT_SHAPE), "dtype": "bf16", **r})
        if not (r["forward_bitwise"] and r["backward_bitwise"]):
            raise AssertionError(f"rate {rate}: the dropout kernel differs from its plain version: {r}")
        if not r["planted_refused"] or not abs(differ - expect) <= DROPOUT_FAULT_REL * expect:
            raise AssertionError(f"rate {rate}: the planted fault (the next layer's key) was not refused as "
                                 f"expected: {r}")
        worst = max(worst, err)
        del xr, y, planted, want_y, want_g
    rate = DROPOUT_RATES[0]
    out = torch.empty_like(x)
    kernel_ms = cuda_time_ms(lambda: dropout.launch(x, key, rate, out))
    plain_ms = cuda_time_ms(lambda: dropout.plain_dropout(x, key, rate), warmup=1, reps=3)
    philox_ms = cuda_time_ms(lambda: F.dropout(x, rate))
    n = x.numel()
    # h read once and the output written once, and the hash's integer
    # operations at the card's INT32 rate: the larger
    b = bound(0, 2 * nbytes(x))
    rate_ops, how = int32_ops_per_s()
    int_ms = dropout.HASH_INT_OPS * n / rate_ops * 1e3
    b.update(bound_bytes_ms=b["bound_ms"], bound_int_ms=int_ms, int32_rate=how)
    if int_ms > b["bound_ms"]:
        b.update(bound_ms=int_ms, bound_by="operations")
    emit({"phase": "kernel_dropout", "case": f"timing rate {rate}", "elements": n, "kernel_ms": kernel_ms,
          "plain_ms": plain_ms, "torch_dropout_ms": philox_ms,
          "torch_dropout": "F.dropout (Philox masks: another function, a yardstick only)", **b,
          "kernel_gb_per_s": 2 * nbytes(x) / kernel_ms / 1e6})
    del x, gy, out
    return {"ms": kernel_ms, "plain_ms": plain_ms, "library_ms": None, "torch_dropout_ms": philox_ms,
            "max_abs_err": worst, **b}


def int32_ops_per_s() -> tuple:
    """The card's INT32 rate, SMs x 64 INT32 lanes an SM x the SM clock (the
    largest ``nvidia-smi`` reports), with how it was reckoned."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                               capture_output=True, text=True, check=True, timeout=60).stdout.split()[0])
    return sms * 64 * mhz * 1e6, f"{sms} SMs x 64 INT32 lanes x {mhz:g} MHz (nvidia-smi clocks.max.sm)"


def kernel_counts() -> tuple:
    return (splash.launches, splash.launches_bwd_dkdv, splash.launches_bwd_dq, dropout.launches,
            fused_adamw.launches)


def zero_counts() -> None:
    splash.launches = splash.launches_bwd_dkdv = splash.launches_bwd_dq = dropout.launches = pieces.launches = 0
    fused_adamw.launches = gmm.launches_gmm = gmm.launches_gmm_dgrad = gmm.launches_tgmm = 0


def phase_remat_grads(dev):
    """InternLM2 widths, 2 layers, residual and attention dropout at 0.1, one
    packed row through the kernels: every param grad under each recompute
    tier against checkpoint=0's, bit for bit; the launches of each (one
    splash forward a layer however the layer is recomputed); the peak memory
    of each; and checkpoint=0's grads against the plain attention under the
    same masks."""
    model, params = initialize_model(internlm2_train_config(REMAT_LAYERS), dev,
                                     torch.Generator(device=dev).manual_seed(SEED + 14))
    L = model.config.num_layers
    batch = packed_batch((TRAIN_B,), TRAIN_S, 0, model.config.vocab_size, np.random.RandomState(SEED + 14), dev)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)

    def grads(cfg, block_fn=None):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base, before = torch.cuda.memory_allocated(), kernel_counts()
        hidden = make_model_def(cfg).apply(params, batch["input_ids"], batch["indexes"], batch["segment_ids"],
                                           dropout_rng=micro_key(), train=True, block_fn=block_fn,
                                           return_hidden=True)
        nll, n, _ = fused_norm_head_ce(hidden, params["norm"], params["head"]["weight"], batch["labels"],
                                       eps=cfg.layer_norm_epsilon, embed_grad_scale=cfg.embed_grad_scale)
        loss = nll / n
        loss.backward()
        del hidden
        torch.cuda.synchronize()
        out = [p.grad for p in leaves]
        for p in leaves:
            p.grad = None
        return {"loss": float(loss.detach()), "grads": out, "peak_gb": (torch.cuda.max_memory_allocated() - base) / 1e9,
                "launches_fwd_dkdv_dq_dropout": [a - b for a, b in zip(kernel_counts()[:4], before)]}

    runs = {name: grads(dataclasses.replace(model.config, **tier)) for name, tier in REMAT_TIERS.items()}
    ref = runs["checkpoint_0"]
    bad = []
    for name, r in runs.items():
        recomputed = name != "checkpoint_0"
        want = [L, L, L, 2 * L * (3 if recomputed else 2)]
        diff = max(float((a.float() - b.float()).abs().max()) for a, b in zip(r["grads"], ref["grads"]))
        emit({"phase": "remat_grads", "tier": name, "layers": L, "loss": r["loss"], "grad_max_abs_diff": diff,
              "bound": REMAT_GRAD_MAX_ABS, "peak_gb_over_params": r["peak_gb"],
              "launches_fwd_dkdv_dq_dropout": r["launches_fwd_dkdv_dq_dropout"], "want": want})
        if r["launches_fwd_dkdv_dq_dropout"] != want or not diff <= REMAT_GRAD_MAX_ABS or r["loss"] != ref["loss"]:
            bad.append(name)
    cfg0 = dataclasses.replace(model.config, checkpoint=0.0)
    plain = grads(cfg0, plain_block(cfg0, batch, train=True))
    rel = [float((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30))
           for a, b in zip(ref["grads"], plain["grads"])]
    worst = int(np.argmax(rel))
    emit({"phase": "remat_grads", "tier": "checkpoint_0 vs plain attention, same masks", "loss_kernel": ref["loss"],
          "loss_plain": plain["loss"], "max_rel_l2": rel[worst], "worst_leaf": worst,
          "median_rel_l2": float(np.median(rel)), "bound": GRAD_REL_L2,
          "finite": all(bool(torch.isfinite(a.float()).all()) for a in ref["grads"])})
    if bad:
        raise AssertionError(f"recompute tiers {bad} differ from checkpoint=0 in grads, loss or launches")
    if not rel[worst] <= GRAD_REL_L2:
        raise AssertionError(f"kernel-path grads with dropout vs plain attention: relative L2 {rel[worst]}")
    del model, params, leaves, runs, ref, plain


def step_read_cost(engine, batch) -> dict:
    """What the train step's read of ``opt_state["step"]`` (the count of
    applied steps that the dropout stream folds, one wait for the previous
    step) costs: blocks of ``READ_COST_STEPS`` steps queued back to back, in
    the order ``READ_COST_BLOCKS``, each step reading the count from the
    device ("read", as the trainer runs it) or given it by a host counter
    ("host", no read).  Seconds a step of each block, and the medians."""
    lr = engine.lr_scheduler.get_lr(engine.step_count)
    beta2 = engine.beta2_scheduler.get_beta2(engine.step_count + 1) if engine.beta2_scheduler else None
    applied = int(engine.opt_state["step"])
    blocks = {"read": [], "host": []}
    for mode in READ_COST_BLOCKS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(READ_COST_STEPS):
            engine.params, engine.opt_state, _ = engine.train_step_fn(
                engine.params, engine.opt_state, batch, lr, beta2, step=applied if mode == "host" else None)
            applied += 1
        torch.cuda.synchronize()
        blocks[mode].append((time.perf_counter() - t0) / READ_COST_STEPS)
    return {"order": list(READ_COST_BLOCKS), "steps_a_block": READ_COST_STEPS, "step_s": blocks,
            "median_s": {k: float(np.median(v)) for k, v in blocks.items()}}


def phase_internlm2_training(dev):
    """``configs/7B_internlm2.py`` at full width and 16 layers, every layer
    recomputed, residual and attention dropout at 0.1, 4 steps through the
    Trainer on one fixed batch (``profile_step.internlm2_train_config``);
    then the step's time by kernel class from ``profile_step.profile``, and
    the cost of the step's read of the applied-step count
    (``step_read_cost``)."""
    torch.cuda.reset_peak_memory_stats()
    config, model, params, trainer, batch = train_setup(dev, SEED + 12, internlm2_train_config())
    cfg, data = model.config, config.data
    micro_num, tokens = data.micro_num, data.micro_num * data.micro_bsz * data.seq_len
    leaves = tree_leaves(params)
    L = cfg.num_layers
    want = [L * micro_num] * 3 + [2 * L * micro_num * 3, len(leaves)]
    zero_counts()
    losses, times = [], []
    for step in range(1, TRAIN_STEPS + 1):
        before = kernel_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = trainer.execute_schedule(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        launched = [a - b for a, b in zip(kernel_counts(), before)]
        groups = {k: float(v) for k, v in m["grad_norm_groups"].items()}
        rec = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]), "grad_norm_groups": groups,
               "found_inf": bool(m["found_inf"]), "lr": trainer.engine.current_lr, "n_tokens": int(m["n_tokens"])}
        emit({"phase": "internlm2_training", "step": step, "step_s": times[-1],
              "launches_fwd_dkdv_dq_dropout_adamw": launched, **rec})
        if launched != want:
            raise AssertionError(f"step {step}: launches {launched}, want {want}")
        if rec["found_inf"] or not all(map(math.isfinite, [rec["loss"], rec["grad_norm"], *groups.values()])):
            raise AssertionError(f"step {step}: non-finite loss or grad norms: {rec}")
        if rec["n_tokens"] != tokens:
            raise AssertionError(f"step {step}: {rec['n_tokens']} valid tokens, want {tokens}")
        losses.append(rec["loss"])
    total = kernel_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    if not all(b < a for a, b in zip(losses, losses[1:])):
        raise AssertionError(f"the loss did not fall on every step: {losses}")
    step_s = float(np.median(times[1:]))
    flops = dict(seq_len=data.seq_len, hidden_size=cfg.hidden_size, num_layers=L, vocab_size=cfg.vocab_size,
                 global_batch_size=micro_num * data.micro_bsz, mlp_ratio=cfg.mlp_ratio)
    tflops4 = get_megatron_flops(step_s, checkpoint=True, **flops)
    tflops3 = get_megatron_flops(step_s, checkpoint=False, **flops)
    prof = profile_step.profile(lambda: trainer.execute_schedule(batch))
    read_cost = step_read_cost(trainer.engine, batch)
    n_params = sum(p.numel() for p in leaves)
    emit({"phase": "internlm2_training", "model": "configs/7B_internlm2.py", "layers": L,
          "cut": f"num_layers 32 -> {L}; overrides checkpoint=1, drop_rate=0.1, attn_drop_rate=0.1",
          "params": n_params, "state_gb_at_18_bytes": 18 * n_params / 1e9, "leaves": len(leaves),
          "micro_num": micro_num, "tokens_per_step": tokens, "losses": losses, "step_s_median_2_4": step_s,
          "step_s": times, "step_read_cost": read_cost, "tokens_per_s": tokens / step_s,
          "tflops_megatron_factor4": tflops4, "mfu_megatron_factor4": tflops4 / device_peak_tflops(),
          "tflops_megatron_factor3": tflops3, "mfu_megatron_factor3": tflops3 / device_peak_tflops(),
          "mfu_counts": "get_megatron_flops: factor 4 counts the recompute (as bench.py with checkpoint), factor 3 "
                        "does not (the 8-layer 7B_sft phase's); both count MHA projections, an overcount under "
                        "GQA 32/8",
          "peak_memory_gb": peak, "launches_fwd_dkdv_dq_dropout_adamw": list(total), "profile": prof})
    del trainer, model, params, leaves, batch
    return dict(zip(("fwd", "dkdv", "dq", "dropout", "adamw"), total))


class GateRecord:
    """While active, wraps ``gshard.top2gating`` to keep each call's routed
    slots: the count kept (a device scalar) and, with ``masks``, the
    dispatch mask (s, E, C)."""

    def __init__(self, masks: bool = False):
        self.masks, self.kept, self.dispatch = masks, [], []

    def __enter__(self):
        self._top2 = gshard.top2gating

        def top2(*args, **kwargs):
            out = self._top2(*args, **kwargs)
            self.kept.append(out[2].sum())
            if self.masks:
                self.dispatch.append(out[2].detach())
            return out

        gshard.top2gating = top2
        return self

    def __exit__(self, *exc):
        gshard.top2gating = self._top2


def gshard_block(cfg, batch, train, attention_fn=flash_attention, next_key=None):
    """A ``block_fn`` for the GShard model: its block with ``attention_fn``
    (the kernel path by default), the gate drawing from the layer's key or,
    with ``next_key``, from the key that map gives for it."""
    def block(layer, h, key):
        key = next_key[key] if next_key is not None else key
        return block_forward(cfg, layer, h, batch["indexes"], batch["segment_ids"], key, train,
                             ffn=lambda hh: moe_ffn(cfg, layer, hh, key=key, train=train), attention_fn=attention_fn)
    return block


def phase_gshard_scoring(dev, config=None):
    """``configs/7B_MoE4_sft.py`` as the file stands, full width and depth,
    scores phase 4's packed rows through ``make_eval_step``: one splash
    forward a layer and no grouped matmul, the share of routed slots each
    layer's capacity dropped, and the loss against the plain attention."""
    config = config if config is not None else gshard_config()
    torch.cuda.reset_peak_memory_stats()
    model, params = initialize_model(config, dev, torch.Generator(device=dev).manual_seed(SEED))
    cfg = model.config
    L, S = cfg.num_layers, SCORE_B * SCORE_S
    batch = scoring_rows(cfg.vocab_size, dev)
    step = make_eval_step(model)
    zero_counts()
    with GateRecord() as rec:
        r = step(params, batch)
    torch.cuda.synchronize()
    launched = (splash.launches, *gmm_counts())
    kept = [int(k) for k in rec.kept]
    dropped = [1.0 - k / (cfg.top_k * S) for k in kept]
    loss = float(r["loss"])
    seconds = cuda_time_ms(lambda: step(params, batch), warmup=1, reps=3) / 1e3
    fwd_tflops = get_megatron_flops(seconds, seq_len=SCORE_S, hidden_size=cfg.hidden_size, num_layers=L,
                                    vocab_size=cfg.vocab_size, global_batch_size=SCORE_B,
                                    mlp_ratio=cfg.mlp_ratio * cfg.top_k) / 3
    peak = torch.cuda.max_memory_allocated() / 1e9
    with torch.inference_mode():
        _, ce_plain = moe_loss_of(model, params, batch, gshard_block(cfg, batch, False, plain_attention),
                                  config.loss.moe_loss_coeff)
    gap = abs(loss - float(ce_plain))
    capacity = gshard._capacity(S, cfg.num_experts, 2 * cfg.moe_eval_capacity_factor, cfg.moe_min_capacity)
    emit({"phase": "gshard_scoring", "model": "configs/7B_MoE4_sft.py (unmodified: GShard)", "layers": L,
          "hidden": cfg.hidden_size, "experts": cfg.num_experts, "top_k": cfg.top_k,
          "eval_capacity_factor": cfg.moe_eval_capacity_factor, "capacity": capacity,
          "params": sum(p.numel() for p in tree_leaves(params)), "tokens": S,
          "valid_tokens": int(r["n_tokens"]), "loss": loss, "loss_plain_attention": float(ce_plain), "gap": gap,
          "gap_bound": LOSS_GAP, "dropped_share_by_layer": dropped, "dropped_share_mean": float(np.mean(dropped)),
          "step_s": seconds, "tokens_per_s": S / seconds, "fwd_tflops_activated": fwd_tflops,
          "mfu": fwd_tflops / device_peak_tflops(),
          "mfu_counts": "get_megatron_flops / 3 with mlp_ratio * top_k (bench.py:73-81); the dense dispatch and "
                        "combine products are not counted",
          "peak_memory_gb": peak, "launches_fwd_gmm_dgrad_tgmm": list(launched)})
    if cfg.top_k != 2 or launched != (L, 0, 0, 0) or len(kept) != L:
        raise AssertionError(f"launches {launched}, gating calls {len(kept)}: want {L} splash forwards and "
                             f"{L} top-2 gating calls, no grouped matmul")
    if not math.isfinite(loss) or not gap <= LOSS_GAP:
        raise AssertionError(f"GShard scoring loss {loss} vs plain attention {float(ce_plain)}")
    del model, params, batch
    return launched[0]


class ChoiceRecord:
    """While active, wraps ``gshard._first_max`` (the gate's argmax choices)
    to keep each call's expert ids in call order, or, with ``replay``, to
    return those of another run instead: the same routing for both runs."""

    def __init__(self, replay=None):
        self.replay, self.choices = replay, []

    def __enter__(self):
        self._first_max = gshard._first_max
        replay = iter(self.replay) if self.replay is not None else None

        def first_max(x):
            idx = next(replay) if replay is not None else self._first_max(x)
            self.choices.append(idx)
            return idx

        gshard._first_max = first_max
        return self

    def __exit__(self, *exc):
        gshard._first_max = self._first_max


def routing_agreement(got: list, want: list) -> dict:
    """Per layer, the share of tokens routed alike in two runs' dispatch
    masks (s, E, C): to the same (expert, slot) pairs, and to the same
    experts (a token dropped by one run's capacity counts as routed
    otherwise)."""
    return {"expert_slot": [float((a == b).flatten(1).all(1).float().mean()) for a, b in zip(got, want)],
            "experts": [float((a.any(-1) == b.any(-1)).all(1).float().mean()) for a, b in zip(got, want)]}


def phase_gshard_grads(dev):
    """The shipped MoE file at ``GSHARD_LAYERS`` layers, one packed row in
    training under one key (top-2 gumbel noise and RTS on), through the
    kernels and through the plain attention.  Routing is discontinuous, so
    the grads and the aux loss are held with the plain run routed as the
    kernel run was (the gate's choices replayed; ``GSHARD_GRAD_REL_L2``,
    ``GSHARD_AUX_REL``), and the routing of a free plain run against the
    kernel run's (``GSHARD_ROUTE_DISAGREE``).  A planted fault, each layer
    drawing the next layer's key, must break the routing bound."""
    config = gshard_config(GSHARD_LAYERS)
    model, params = initialize_model(config, dev, torch.Generator(device=dev).manual_seed(SEED + 15))
    cfg, coeff = model.config, config.loss.moe_loss_coeff
    L = cfg.num_layers
    batch = packed_batch((TRAIN_B,), TRAIN_S, 0, cfg.vocab_size, np.random.RandomState(SEED + 15), dev)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    key = micro_key()

    def grads(block_fn, replay=None):
        with GateRecord(masks=True) as rec, ChoiceRecord(replay) as ch:
            hidden, aux = model.apply(params, batch["input_ids"], batch["indexes"], batch["segment_ids"],
                                      dropout_rng=key, train=True, block_fn=block_fn, return_hidden=True)
            nll, n, _ = fused_norm_head_ce(hidden, params["norm"], params["head"]["weight"], batch["labels"],
                                           eps=cfg.layer_norm_epsilon, embed_grad_scale=cfg.embed_grad_scale)
            (nll / n + coeff * aux["moe"]).backward()
        out = [p.grad for p in leaves]
        for p in leaves:
            p.grad = None
        return {"aux": float(aux["moe"].detach()), "grads": out, "dispatch": rec.dispatch, "choices": ch.choices}

    def disagree(agree: dict) -> float:
        return 1.0 - min(agree["experts"])

    zero_counts()
    kernel = grads(None)
    torch.cuda.synchronize()
    launched = list(kernel_counts()[:3])
    same = grads(gshard_block(cfg, batch, True, plain_attention), replay=kernel["choices"])
    rel = [float((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30))
           for a, b in zip(kernel["grads"], same["grads"])]
    sound = {"max_rel_l2": max(rel), "worst_leaf": int(np.argmax(rel)), "median_rel_l2": float(np.median(rel)),
             "aux_rel": abs(kernel["aux"] - same["aux"]) / abs(same["aux"]),
             "replayed_routing": routing_agreement(kernel["dispatch"], same["dispatch"]),
             "finite": all(bool(torch.isfinite(a.float()).all()) for a in kernel["grads"])}
    del same
    free = grads(gshard_block(cfg, batch, True, plain_attention))
    sound["routing_plain_vs_kernel"] = routing_agreement(free["dispatch"], kernel["dispatch"])
    sound["aux_rel_free"] = abs(kernel["aux"] - free["aux"]) / abs(free["aux"])
    del free
    next_key = {jrandom.fold_in(key, i): jrandom.fold_in(key, i + 1) for i in range(L)}
    fault = grads(gshard_block(cfg, batch, True, next_key=next_key))
    planted = {"routing_vs_kernel": routing_agreement(fault["dispatch"], kernel["dispatch"]),
               "aux_rel": abs(fault["aux"] - kernel["aux"]) / abs(kernel["aux"])}
    del fault
    held = (sound["finite"] and sound["max_rel_l2"] <= GSHARD_GRAD_REL_L2 and sound["aux_rel"] <= GSHARD_AUX_REL
            and min(sound["replayed_routing"]["expert_slot"]) == 1.0
            and disagree(sound["routing_plain_vs_kernel"]) <= GSHARD_ROUTE_DISAGREE)
    refused = disagree(planted["routing_vs_kernel"]) > GSHARD_ROUTE_DISAGREE
    emit({"phase": "gshard_grads", "model": "configs/7B_MoE4_sft.py (unmodified: GShard), train, one key",
          "layers": L, "tokens": TRAIN_S, "leaves": len(leaves), "aux_kernel": kernel["aux"],
          "bounds": {"rel_l2": GSHARD_GRAD_REL_L2, "aux_rel": GSHARD_AUX_REL,
                     "routing_disagree_experts": GSHARD_ROUTE_DISAGREE},
          "kernel_vs_plain": sound, "held": held, "planted_next_layer_key": planted, "planted_refused": refused,
          "launches_fwd_dkdv_dq": launched})
    if launched != [L, L, L]:
        raise AssertionError(f"launches {launched}, want {[L, L, L]}")
    if not held:
        raise AssertionError(f"GShard grads or routing through the kernels vs plain attention: {sound}")
    if not refused:
        raise AssertionError(f"the GShard check let the next layer's key through: {planted}")
    del model, params, leaves, kernel


def checkpoint_nbytes(layers: int) -> int:
    """Bytes of one checkpoint of the entry phases' model: the params in
    their dtypes and the fp32 master, m and v (14 bytes a bf16 param),
    counted on the meta device (no memory, no time)."""
    model = build_model(gshard_config(layers))
    leaves = tree_leaves(model.init(torch.Generator(), "meta"))
    return sum(t.numel() * (t.element_size() + 12) for t in leaves)


def host_copy_rates(dev) -> dict:
    """GB/s of a device-to-host copy of 2 GiB: into fresh pageable memory
    (``.to("cpu")``), into a pinned buffer, and the pinned buffer's
    allocation: the yardsticks of a save's snapshot."""
    x = torch.empty(DISK_YARDSTICK // 2, dtype=torch.int16, device=dev).random_()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pageable = x.to("cpu", copy=True)
    pageable_s = time.perf_counter() - t0
    del pageable
    t0 = time.perf_counter()
    pinned = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    alloc_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pinned.copy_(x, non_blocking=True)
    torch.cuda.synchronize()
    pinned_s = time.perf_counter() - t0
    del pinned, x
    gb = DISK_YARDSTICK / 1e9
    return {"bytes": DISK_YARDSTICK, "fresh_pageable_gb_per_s": gb / pageable_s, "pinned_alloc_gb_per_s": gb / alloc_s,
            "pinned_copy_gb_per_s": gb / pinned_s}


def phase_checkpoint_disk(dev, root: Path) -> dict:
    """Where the entry phases' checkpoints go, and at what depth: ``df`` and
    ``free`` of the machine, a 2 GiB write and read on the checkpoints'
    filesystem and 2 GiB device-to-host copies (``host_copy_rates``) as
    yardsticks for the save and load times, and the deepest
    of ``ENTRY_DEPTHS`` whose two checkpoints fit the free space (with 5% to
    spare) and the write budget; one that fits neither fails."""
    df = subprocess.run(["df", "-B1", str(root)], capture_output=True, text=True, timeout=60).stdout
    free_out = subprocess.run(["free", "-b"], capture_output=True, text=True, timeout=60).stdout
    free = shutil.disk_usage(root).free
    need = {L: 2 * checkpoint_nbytes(L) for L in ENTRY_DEPTHS}
    fits = [L for L in ENTRY_DEPTHS if need[L] * 1.05 <= free and need[L] + DISK_YARDSTICK <= DISK_WRITE_BUDGET]
    chunk = np.random.default_rng(SEED).integers(0, 256, DISK_CHUNK, dtype=np.uint8).tobytes()
    probe = root / "disk_yardstick.bin"
    try:
        t0 = time.perf_counter()
        with open(probe, "wb") as f:
            for _ in range(DISK_YARDSTICK // DISK_CHUNK):
                f.write(chunk)
            f.flush()
            os.fsync(f.fileno())
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        buf = bytearray(DISK_CHUNK)
        with open(probe, "rb") as f:
            while f.readinto(buf):
                pass
        read_s = time.perf_counter() - t0
    finally:
        probe.unlink(missing_ok=True)
    host_copy = host_copy_rates(dev)
    out = {"phase": "checkpoint_disk", "folder": str(root), "df": df.strip().splitlines(),
           "free": free_out.strip().splitlines(), "free_bytes": free, "write_budget_bytes": DISK_WRITE_BUDGET,
           "two_checkpoints_bytes": {str(L): n for L, n in need.items()}, "layers": fits[0] if fits else None,
           "yardstick": {"bytes": DISK_YARDSTICK, "write_s": write_s, "write_gb_per_s": DISK_YARDSTICK / write_s / 1e9,
                         "read_s": read_s, "read_gb_per_s": DISK_YARDSTICK / read_s / 1e9,
                         "how": "64 MiB random chunks written and fsync'd, then read back (the page cache may serve "
                                "the read)"},
           "host_copy": host_copy}
    emit(out)
    if not fits:
        raise AssertionError(f"{root}: {free} bytes free, a budget of {DISK_WRITE_BUDGET}; two checkpoints need {need}")
    return out


def entry_config(folder: Path, layers: int) -> tuple:
    """``configs/7B_MoE4_sft.py`` cut for the entry phases, and the cuts."""
    config = gshard_config(layers)
    cut = {"model.num_layers": f"32 -> {layers}" + ("" if layers == ENTRY_DEPTHS[0] else
                                                     f" (two {ENTRY_DEPTHS[0]}-layer checkpoints exceed the free "
                                                     "space or the write budget: phase checkpoint_disk)"),
           "data.total_steps": f"{config.data.total_steps} -> {ENTRY_STEPS}",
           "ckpt.enable_save_ckpt": f"{config.ckpt.enable_save_ckpt} -> True",
           "ckpt.save_ckpt_folder": f"{config.ckpt.save_ckpt_folder} -> local:{folder}"}
    config.data.total_steps = ENTRY_STEPS
    config.ckpt.enable_save_ckpt = True
    config.ckpt.save_ckpt_folder = f"local:{folder}"
    return config, cut


def fingerprint(tree) -> dict:
    """Per leaf, two exact int64 sums of its bits on the device: the plain
    sum (any one flipped bit changes it) and a position-weighted one (a
    moved element changes it)."""
    out = {}
    for path, t in tree_leaves_with_path(tree):
        bits = t.detach().reshape(-1).view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                                            8: torch.int64}[t.element_size()])
        plain = torch.sum(bits, dtype=torch.int64)
        weighted = torch.zeros((), dtype=torch.int64, device=t.device)
        for lo in range(0, bits.numel(), FINGERPRINT_CHUNK):
            part = bits[lo:lo + FINGERPRINT_CHUNK].to(torch.int64)
            weights = torch.arange(lo, lo + part.numel(), device=t.device, dtype=torch.int64) % 65521 + 1
            weighted += torch.sum(part * weights)
        out[path] = (int(plain), int(weighted))
    return out


def state_fingerprint(engine) -> dict:
    return {"params": fingerprint(engine.params),
            **{key: fingerprint(engine.opt_state[key]) for key in ("master", "m", "v")}}


def fingerprint_mismatch(got: dict, want: dict) -> list:
    return [(tree, path) for tree in want for path in want[tree] if got[tree].get(path) != want[tree][path]]


@contextlib.contextmanager
def record_snapshots(fingerprints: dict):
    """While active, each save records the fingerprint of the state it
    snapshots, by the save's folder (taken on the device just before the
    copy to the host, which the step does not touch until it completes)."""
    save = CheckpointManager.save_checkpoint

    def recording(self, path, train_state=None, block=True):
        fingerprints[StorageManager._parse(path)[1]] = state_fingerprint(self.engine)
        return save(self, path, train_state, block)

    CheckpointManager.save_checkpoint = recording
    try:
        yield
    finally:
        CheckpointManager.save_checkpoint = save


def phase_entry_training(dev, folder: Path, layers: int) -> dict:
    """The entry point's loop in-process (``train/main.py::run_training``)
    on ``configs/7B_MoE4_sft.py`` past one ``valid_every`` with saving on
    (``entry_config``): a snapshot at step 25 into ``snapshot/1``, a save at
    step 50 into ``50/``, eval at step 50, 52 steps in all."""
    config, cut = entry_config(folder, layers)
    fingerprints = {}
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    with record_snapshots(fingerprints):
        out = run_training(config, device=dev, seed=ENTRY_SEED)
    torch.cuda.synchronize()
    total = (*kernel_counts(), *gmm_counts())
    peak = torch.cuda.max_memory_allocated() / 1e9
    cfg, data, recs = out["model"].config, out["config"].data, out["records"]
    L, steps, mgr = cfg.num_layers, len(recs), out["ckpt_manager"]
    leaves = len(tree_leaves(out["engine"].params))
    n_params = sum(p.numel() for p in tree_leaves(out["engine"].params))
    tokens = data.micro_num * data.micro_bsz * data.seq_len
    evals = out["evals"]
    eval_batches = sum(r["batches"] for e in evals for r in e["results"].values())
    want = [steps * L * data.micro_num + eval_batches * L] + [steps * L * data.micro_num] * 2 + [0, steps * leaves,
                                                                                               0, 0, 0]
    losses = [r["loss"] for r in recs]
    paid = {b + 1 for b in out["saved_after"]}  # the step after a save waited for its snapshot
    timed = [r for r in recs[2:] if r["step"] not in paid]
    step_s = float(np.median([r["time_cost"] for r in timed]))
    tflops = get_megatron_flops(step_s, seq_len=data.seq_len, hidden_size=cfg.hidden_size, num_layers=L,
                                vocab_size=cfg.vocab_size, global_batch_size=data.micro_num * data.micro_bsz,
                                mlp_ratio=cfg.mlp_ratio * cfg.top_k)
    saves = [{**s, "path": os.path.relpath(s["path"], folder), "gb": s["bytes"] / 1e9,
              "write_gb_per_s": s["bytes"] / 1e9 / (s["stamp_s"] - s["snapshot_s"]),
              "snapshot_gb_per_s": s["bytes"] / 1e9 / s["snapshot_s"]} for s in mgr.save_records]
    emit({"phase": "entry_training", "model": "configs/7B_MoE4_sft.py", "cut": cut, "layers": L,
          "routing": {"moe_type": cfg.moe_type, "top_k": cfg.top_k, "capacity_factor": cfg.moe_capacity_factor,
                      "use_rts": cfg.moe_use_rts, "noisy_gate_policy": cfg.moe_noisy_gate_policy},
          "ckpt": {k: out["config"].ckpt[k] for k in ("checkpoint_every", "oss_snapshot_freq", "async_upload",
                                                       "auto_resume")},
          "data_path": "RandomDataset -> PackedDatasetWithCut -> StaticBatchSampler -> packed_collate_fn",
          "micro_num": data.micro_num, "micro_bsz": data.micro_bsz, "packed_length": data.packed_length,
          "valid_every": data.valid_every, "params": n_params, "checkpoint_bytes_at_14": 14 * n_params,
          "leaves": leaves, "setup_s": out["setup_s"], "staging_alloc_s": out["staging_s"], "steps": steps,
          "losses": losses,
          "moe_losses": [r["moe_loss"] for r in recs], "grad_norms": [r["grad_norm"] for r in recs],
          "lrs": [r["lr"] for r in recs], "step_s": [r["time_cost"] for r in recs],
          "steps_paying_a_save": sorted(paid), "step_s_median_2_51_without_saves": step_s,
          "tokens_per_step": tokens, "tokens_per_s": tokens / step_s, "tflops_activated": tflops,
          "mfu": tflops / device_peak_tflops(), "load_wait_s_median": float(np.median(out["load_wait_s"])),
          "saves": saves, "saves_hold_loop_s": [s["snapshot_s"] for s in saves],
          "saves_to_stamp_s": [s["stamp_s"] for s in saves],
          "evals": [{"step": e["step"], "seconds": e["seconds"], **{k: {m: r[m] for m in
                                                                         ("loss", "acc", "perplexity", "batches")}
                                                                    for k, r in e["results"].items()}}
                    for e in evals],
          "peak_memory_gb": peak, "launches_fwd_dkdv_dq_dropout_adamw_gmm_dgrad_tgmm": list(total),
          "launches_want": want})
    if steps != ENTRY_STEPS or list(total) != want:
        raise AssertionError(f"{steps} steps, launches {list(total)}: want {ENTRY_STEPS} and {want}")
    if sorted(s["path"] for s in saves) != ["50", "snapshot/1"] or [e["step"] for e in evals] != [50]:
        raise AssertionError(f"saves {saves}, evals {evals}: want snapshot/1 and 50, and eval at step 50")
    if not all((folder / s["path"] / f"{s['step']}.step").exists() for s in saves):
        raise AssertionError(f"a save has no stamp: {saves}")
    if not all(math.isfinite(x) for x in losses + [r["grad_norm"] for r in recs]) or not losses[-1] < losses[0]:
        raise AssertionError(f"entry training losses {losses}")
    if not all(r["success_update"] for r in recs) or any(r["real_tokens"] <= 0 for r in recs):
        raise AssertionError(f"a skipped step or an empty batch: {recs}")
    result = {"fwd": total[0], "dkdv": total[1], "dq": total[2], "adamw": total[4],
              "tail": [(r["step"], r["loss"], r["grad_norm"], r["moe_loss"]) for r in recs[-2:]],
              "final": state_fingerprint(out["engine"]), "saved": fingerprints[str(folder / "50")]}
    del out
    return result


def phase_checkpoint_resume(dev, folder: Path, layers: int, first: dict) -> dict:
    """A second ``run_training`` on the same folder from params drawn from
    another seed (the launch seed, whose streams the gate noise draws, is
    the first run's): it must auto-resume from ``50/`` (the newest stamp,
    not ``snapshot/1``),
    load the state the first run snapshotted there (its fingerprints),
    refuse a planted bit flip in a loaded leaf, and run batches 50 and 51 to
    the first run's losses, grad norms, params, masters and moments, bit for
    bit."""
    config, cut = entry_config(folder, layers)
    held = {}
    resume = CheckpointManager.try_resume_training

    def checked(self, train_state, current_time=""):
        resume(self, train_state, current_time)
        held["loaded"] = fingerprint_mismatch(state_fingerprint(self.engine), first["saved"])
        bits = self.engine.opt_state["master"]["embedding"]["weight"].view(-1).view(torch.int32)
        bits[PLANTED_BIT_AT] ^= 1  # the lowest mantissa bit of one master weight
        held["planted"] = fingerprint_mismatch(state_fingerprint(self.engine), first["saved"])
        bits[PLANTED_BIT_AT] ^= 1
        held["restored"] = fingerprint_mismatch(state_fingerprint(self.engine), first["saved"])

    _, params = initialize_model(config, dev, torch.Generator(device=dev).manual_seed(ENTRY_SEED_RESUME))
    zero_counts()
    CheckpointManager.try_resume_training = checked
    try:
        out = run_training(config, params=params, device=dev, seed=ENTRY_SEED)
    finally:
        CheckpointManager.try_resume_training = resume
    del params
    torch.cuda.synchronize()
    total = (*kernel_counts(), *gmm_counts())
    recs, L, micro = out["records"], out["model"].config.num_layers, out["config"].data.micro_num
    load = out["ckpt_manager"].load_record
    tail = [(r["step"], r["loss"], r["grad_norm"], r["moe_loss"]) for r in recs]
    final = fingerprint_mismatch(state_fingerprint(out["engine"]), first["final"])
    leaves = len(tree_leaves(out["engine"].params))
    want = [2 * L * micro] * 3 + [0, 2 * leaves, 0, 0, 0]
    emit({"phase": "checkpoint_resume", "model": "configs/7B_MoE4_sft.py", "cut": cut, "layers": L,
          "init_seed": ENTRY_SEED_RESUME, "loaded_from": os.path.relpath(load["path"], folder),
          "load_s": load["load_s"], "setup_s": out["setup_s"],
          "load_gb_per_s": first["bytes"] / 1e9 / load["load_s"],
          "loaded_vs_snapshot_mismatches": len(held["loaded"]),
          "planted": f"bit 0 of element {PLANTED_BIT_AT} of opt_state['master']['embedding']['weight'] flipped",
          "planted_mismatches": held["planted"], "after_unflip_mismatches": len(held["restored"]),
          "steps": tail, "first_run_steps": first["tail"], "final_state_mismatches": len(final),
          "launches_fwd_dkdv_dq_dropout_adamw_gmm_dgrad_tgmm": list(total), "launches_want": want})
    if load["path"] != str(folder / "50"):
        raise AssertionError(f"resumed from {load['path']}, want {folder / '50'} (the newest stamp)")
    if held["loaded"] or held["restored"]:
        raise AssertionError(f"the loaded state differs from the snapshot: {held['loaded'][:5]}")
    if len(held["planted"]) != 1:
        raise AssertionError(f"the fingerprint check let a flipped bit through: {held['planted']}")
    if tail != first["tail"] or final:
        raise AssertionError(f"resumed steps {tail} vs {first['tail']}; final state differs in {final[:5]}")
    if list(total) != want:
        raise AssertionError(f"launches {list(total)}, want {want}")
    del out
    return {"fwd": total[0], "dkdv": total[1], "dq": total[2], "adamw": total[4]}


# ---------------------------------------------------------------- slice 11


def coverage_peak(dtype) -> float:
    """The peak rate of a splash instantiation's operations: the tensor
    cores' for bf16 and fp16; for fp32 the fp32-exact rate of the six bf16
    products of three pieces an operand (the bf16 peak / 6)."""
    return device_peak_fp32_exact_tflops() if dtype == torch.float32 else device_peak_tflops()


def sdpa_timed(qt, kt, vt, mask, backend=None):
    """(forward ms under no_grad, backward-alone ms, out) of SDPA on one
    backend (None: torch's choice)."""
    from torch.nn.attention import sdpa_kernel

    with sdpa_kernel(backend) if backend is not None else contextlib.nullcontext():
        with torch.no_grad():
            fwd_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask), 1, 5)
        o = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
        dot = torch.randn_like(o)
        bwd_ms = cuda_time_ms(lambda: torch.autograd.grad(o, (qt, kt, vt), dot, retain_graph=True), 1, 5)
    return fwd_ms, bwd_ms, o.detach()


def sdpa_library(q, k, v, seg, dtype, want_out=None):
    """SDPA in q's dtype (fp32: the math backend) with the (causal ∧ same
    segment) bool mask, k and v repeated to q's heads: (forward ms under
    no_grad, backward-alone ms, leaves, fp32 extras), the yardstick of a
    splash case.  For fp32 the extras time the efficient backend too, the
    mask as a float bias (0 or -inf), with its out's relative L2 against
    ``want_out`` (its fp32 products may not be exact), or its refusal."""
    from torch.nn.attention import SDPBackend

    rep = q.shape[2] // k.shape[2]
    (qt, kt, vt), mask = sdpa_inputs(q, k.repeat_interleave(rep, 2), v.repeat_interleave(rep, 2), seg)
    f32 = dtype == torch.float32
    fwd_ms, bwd_ms, _ = sdpa_timed(qt, kt, vt, mask, SDPBackend.MATH if f32 else None)
    extras = {}
    if f32:
        bias = torch.zeros(mask.shape, device=q.device).masked_fill_(~mask, -math.inf)
        try:
            e_fwd, e_bwd, o = sdpa_timed(qt, kt, vt, bias, SDPBackend.EFFICIENT_ATTENTION)
            extras = {"library_efficient_ms": [e_fwd, e_bwd],
                      "library_efficient_out_rel_l2": rel_l2(o.transpose(1, 2), want_out)}
        except RuntimeError as e:  # the yardstick only: the port never calls SDPA
            extras = {"library_efficient_ms": None, "library_efficient_refused": str(e)[:300]}
        del bias
    return fwd_ms, bwd_ms, (qt.detach(), kt.detach(), vt.detach()), extras


def coverage_case(dev, g, seg, name, D, rate) -> dict:
    """One splash instantiation: B1 and B2 against the plain versions, the
    planted faults refused, and (without dropout) timings beside the bound,
    the plain versions and SDPA."""
    dtype = {v: k for k, v in splash.DTYPES.items()}[name]
    lim = COVERAGE_LIMITS[name]
    S = seg.shape[1]
    q = torch.randn(TRAIN_B, S, HEADS, D, generator=g, device=dev).to(dtype)
    k, v = (torch.randn(TRAIN_B, S, COVERAGE_KV_HEADS, D, generator=g, device=dev).to(dtype) for _ in range(2))
    do = torch.randn(q.shape, generator=g, device=dev).to(dtype)
    seed = splash._norm_seed([1234, 0, 0, 0, 0]) if rate else None
    scale = D**-0.5
    fwd_args = (q, k, v, seg, None, scale, True, False, rate, seed)
    call = splash.ForwardCall(*fwd_args)
    call.launch()
    torch.cuda.synchronize()
    ro, rl = splash.plain_forward(q, k, v, seg, None, scale, True, rate, seed)
    empty = torch.isneginf(rl)
    r = {"dtype": name, "head_dim": D, "dropout": rate,
         "out_rel_l2": rel_l2(call.out, ro), "out_max_abs_err": float((call.out.float() - ro.float()).abs().max()),
         "lse_max_abs_err": float((call.lse - rl)[~empty].abs().max()),
         "empty_rows_agree": bool(torch.equal(torch.isneginf(call.lse), empty)),
         "finite": bool(torch.isfinite(call.out.float()).all())}
    planted = splash.ForwardCall(*fwd_args)
    planted.segs[2].add_(1)  # kv_lo: every item's walk starts a tile late
    planted.launch()
    torch.cuda.synchronize()
    r["planted_kv_lo_rel_l2"] = rel_l2(planted.out, ro)
    del planted, call
    bwd_args = (q, k, v, ro, rl, do, None, seg, None, scale, True)
    bwd = splash.BackwardCall(*bwd_args, False, rate, seed)
    bwd.launch_dkdv()
    bwd.launch_dq()
    torch.cuda.synchronize()
    want = splash.plain_backward(*bwd_args, rate, seed)
    got = (bwd.dq, bwd.dk, bwd.dv)
    for n, a, b in zip(("dq", "dk", "dv"), got, want):
        r[f"{n}_rel_l2"] = rel_l2(a, b)
        r[f"{n}_max_abs_err"] = float((a.float() - b.float()).abs().max())
        r["finite"] = r["finite"] and bool(torch.isfinite(a.float()).all())
    again = splash.BackwardCall(*bwd_args, False, rate, seed)  # no atomics: the same bits twice
    again.launch_dkdv()
    again.launch_dq()
    torch.cuda.synchronize()
    r["backward_repeats_bitwise"] = all(torch.equal(a, b) for a, b in zip(got, (again.dq, again.dk, again.dv)))
    del again
    planted = splash.BackwardCall(*bwd_args, False, rate, seed)
    planted.segs[2].add_(1)  # kv_lo: dQ's walk starts a tile late
    planted.segs[3].sub_(1)  # q_hi: dK/dV's walk ends a tile early
    planted.launch_dkdv()
    planted.launch_dq()
    torch.cuda.synchronize()
    for n, a, b in zip(("dq", "dk", "dv"), (planted.dq, planted.dk, planted.dv), want):
        r[f"planted_{n}_rel_l2"] = rel_l2(a, b)
    del planted
    r["held"] = (r["out_rel_l2"] <= lim["out"] and r["lse_max_abs_err"] <= lim["lse"] and r["empty_rows_agree"]
                 and r["finite"] and all(r[f"{n}_rel_l2"] <= lim["grad"] for n in ("dq", "dk", "dv"))
                 and r["backward_repeats_bitwise"])
    r["planted_refused"] = (r["planted_kv_lo_rel_l2"] > lim["out"]
                            and all(r[f"planted_{n}_rel_l2"] > lim["grad"] for n in ("dq", "dk", "dv")))
    if not rate:
        flops = attention_flops(seg.cpu().numpy(), HEADS, D)  # the function's work at its own head dim
        peak = coverage_peak(dtype)
        lse_bytes = 4 * TRAIN_B * HEADS * S
        f32 = dtype == torch.float32
        # fp32: the forward's ms includes its launch's split of q, k, v into
        # pieces, dK/dV's the backward's split of q, k, v, dO
        r["fwd"] = {"ms": cuda_time_ms(splash.ForwardCall(*fwd_args).launch),
                    "plain_ms": cuda_time_ms(lambda: splash.plain_forward(q, k, v, seg, None, scale), 1, 3),
                    **bound(flops, nbytes(q, k, v, seg) + nbytes(q) + lse_bytes, peak)}
        timed = splash.BackwardCall(*bwd_args, False, 0.0, None)
        plain_bwd_ms = cuda_time_ms(lambda: splash.plain_backward(*bwd_args), 1, 3)
        reads = nbytes(q, k, v, do, seg) + 2 * lse_bytes
        dkdv = (lambda: (timed.split(), timed.launch_dkdv())) if f32 else timed.launch_dkdv
        r["bwd_dkdv"] = {"ms": cuda_time_ms(dkdv), "plain_ms": plain_bwd_ms,
                         **bound(2 * flops, reads + nbytes(k, v), peak)}
        r["bwd_dq"] = {"ms": cuda_time_ms(timed.launch_dq), "plain_ms": plain_bwd_ms,
                       **bound(0.5 * flops, nbytes(q), peak)}
        if f32:
            r["split_ms"] = {"fwd": cuda_time_ms(lambda: pieces.split_pieces(q, k, v)),
                             "bwd": cuda_time_ms(timed.split),
                             "fwd_plain": cuda_time_ms(lambda: [pieces.plain_split(t) for t in (q, k, v)])}
            for kname, work in (("fwd", flops), ("bwd_dkdv", 2 * flops), ("bwd_dq", 0.5 * flops)):
                r[kname].update(bound_peak="bf16 tensor-core peak / 6 (fp32-exact)",
                                bound_cuda_core_ms=bound(work, 0, device_peak_fp32_tflops())["bound_ms"])
        del timed
        lib_fwd, lib_bwd, sdpa_leaves, extras = sdpa_library(q, k, v, seg, dtype, ro)
        r["fwd"]["library_ms"], r["bwd_dkdv"]["library_ms"] = lib_fwd, lib_bwd
        r["bwd_dq"]["library_ms"] = lib_bwd
        r["library"] = ("scaled_dot_product_attention" + (" (math backend)" if f32 else "")
                        + " with a bool mask, k/v repeated to 32 heads; backward alone")
        if f32:
            eff = extras.get("library_efficient_ms")
            for i, kname in ((0, "fwd"), (1, "bwd_dkdv"), (1, "bwd_dq")):
                r[kname]["library_efficient_ms"] = eff[i] if eff else None
            r.update(extras)
        if D == COVERAGE_FLEX_D:
            qt, kt, vt = sdpa_leaves
            r["fwd"].update(flex_forward(qt, kt, vt, seg, ro))
            qt, kt, vt = (t.clone().requires_grad_() for t in sdpa_leaves)
            # k and v repeated to the q heads: only dq compares with the plain grads
            flex = flex_backward(qt, kt, vt, seg, do.transpose(1, 2).contiguous(), (want[0], None, None))
            r["bwd_dkdv"]["library_flex_ms"] = r["bwd_dq"]["library_flex_ms"] = flex["library_flex_ms"]
            r["library_flex_compile_s"] = [r["fwd"].pop("library_flex_compile_s"), flex["library_flex_compile_s"]]
        del sdpa_leaves
    return r


def coverage_gmm(dev) -> dict:
    """gmm, gmm dgrad and tgmm with fp16 operands against their plain
    versions at ``GMM_CASES``'s layouts in both directions of the expert MLP;
    a planted fault (the first group end one row on) each must refuse; the
    balanced w1 calls timed beside their bound, plain version and
    ``torch._grouped_mm`` in fp16 where it takes fp16."""
    g = torch.Generator(device=dev).manual_seed(SEED + 21)
    H, M, E = GMM_H, GMM_M, GMM_E
    f16 = torch.float16
    n_max = max(n for n, _ in GMM_CASES.values())
    hf = lambda *shape, scale=1.0: (torch.randn(*shape, generator=g, device=dev) * scale).to(f16)  # noqa: E731
    x, hm, dy_m, dy_h = hf(n_max, H), hf(n_max, M), hf(n_max, M), hf(n_max, H)
    w1, w2 = hf(E, H, M, scale=0.02), hf(E, M, H, scale=0.02)
    worst = {k: 0.0 for k in ("gmm", "gmm_dgrad", "tgmm")}
    worst_abs = dict(worst)
    for case, (n, sizes) in GMM_CASES.items():
        gs = torch.tensor(sizes, device=dev)
        calls = {"gmm_w1": ("gmm", lambda: gmm.gmm(x[:n], w1, gs), lambda: gmm.plain_gmm(x[:n], w1, gs)),
                 "gmm_w2": ("gmm", lambda: gmm.gmm(hm[:n], w2, gs), lambda: gmm.plain_gmm(hm[:n], w2, gs)),
                 "dgrad_w1": ("gmm_dgrad", lambda: gmm.gmm(dy_m[:n], w1, gs, transpose_rhs=True),
                              lambda: gmm.plain_gmm(dy_m[:n], w1, gs, transpose_rhs=True)),
                 "dgrad_w2": ("gmm_dgrad", lambda: gmm.gmm(dy_h[:n], w2, gs, transpose_rhs=True),
                              lambda: gmm.plain_gmm(dy_h[:n], w2, gs, transpose_rhs=True)),
                 "tgmm_w1": ("tgmm", lambda: gmm.tgmm(x[:n], dy_m[:n], gs, E, f16),
                             lambda: gmm.plain_tgmm(x[:n], dy_m[:n], gs, E, f16)),
                 "tgmm_w2": ("tgmm", lambda: gmm.tgmm(hm[:n], dy_h[:n], gs, E, f16),
                             lambda: gmm.plain_tgmm(hm[:n], dy_h[:n], gs, E, f16))}
        checks = {}
        for cname, (cls, kernel, plain) in calls.items():
            got = kernel()
            torch.cuda.synchronize()
            want = plain()
            checks[cname] = {"rel_l2": rel_l2(got, want), "max_abs_err": float((got.float() - want.float()).abs().max()),
                             "finite": bool(torch.isfinite(got.float()).all()), "dtype": str(got.dtype)}
            worst[cls] = max(worst[cls], checks[cname]["rel_l2"])
            worst_abs[cls] = max(worst_abs[cls], checks[cname]["max_abs_err"])
            del got, want
        emit({"phase": "kernel_coverage", "case": f"gmm fp16 {case}", "rows": n, "group_sizes": sizes, **checks})
        bad = [c for c, r in checks.items() if not r["finite"] or not r["rel_l2"] <= FP16_GMM_REL_L2
               or r["dtype"] != str(f16)]
        if bad:
            raise AssertionError(f"fp16 {case}: gmm kernels {bad} disagree with their plain versions: {checks}")
    n, sizes = GMM_CASES["balanced"]
    xb, dyb = x[:n], dy_m[:n]
    gs = torch.tensor(sizes, device=dev)
    planted = {}
    for cname, call, plain in (("gmm", gmm.GmmCall(xb, w1, gs), lambda: gmm.plain_gmm(xb, w1, gs)),
                               ("gmm_dgrad", gmm.GmmCall(dyb, w1, gs, transpose_rhs=True),
                                lambda: gmm.plain_gmm(dyb, w1, gs, transpose_rhs=True)),
                               ("tgmm", gmm.TgmmCall(xb, dyb, gs, E, f16), lambda: gmm.plain_tgmm(xb, dyb, gs, E, f16))):
        call.ends[0] += 1
        call.launch()
        torch.cuda.synchronize()
        rl = rel_l2(call.out, plain())
        planted[cname] = {"rel_l2": rl, "refused": not rl <= FP16_GMM_REL_L2}
    emit({"phase": "kernel_coverage", "case": "gmm fp16 planted fault: first group end + 1", **planted})
    if not all(r["refused"] for r in planted.values()):
        raise AssertionError(f"the fp16 gmm check let a group end one row off through: {planted}")
    offs = torch.cumsum(gs, 0, dtype=torch.int32)
    out = {}
    for cname, a, w, trans in (("gmm", xb, w1, False), ("gmm_dgrad", dyb, w1, True)):
        Kc, Fo = a.shape[1], (w.shape[1] if trans else w.shape[2])
        lib = library_grouped_mm(a, w.transpose(1, 2) if trans else w, offs, f16)
        out[cname] = {"ms": cuda_time_ms(gmm.GmmCall(a, w, gs, transpose_rhs=trans).launch),
                      "plain_ms": cuda_time_ms(lambda: gmm.plain_gmm(a, w, gs, transpose_rhs=trans), 1, 3),
                      "library_ms": cuda_time_ms(lib) if lib is not None else None,
                      **bound(2.0 * n * Kc * Fo, nbytes(a) + E * Kc * Fo * 2 + n * Fo * 2)}
    lib = library_grouped_mm(xb.t(), dyb, offs, f16)
    out["tgmm"] = {"ms": cuda_time_ms(gmm.TgmmCall(xb, dyb, gs, E, f16).launch),
                   "plain_ms": cuda_time_ms(lambda: gmm.plain_tgmm(xb, dyb, gs, E, f16), 1, 3),
                   "library_ms": cuda_time_ms(lib) if lib is not None else None,
                   **bound(2.0 * n * H * M, nbytes(xb, dyb) + E * H * M * 2)}
    for cname, r in out.items():
        r.update(rel_l2=worst[cname], max_abs_err=worst_abs[cname],
                 library=(GROUPED_MM + " (fp16)") if r["library_ms"] is not None
                 else "none: torch._grouped_mm did not take fp16 operands here")
        emit({"phase": "kernel_coverage", "case": f"timing {cname} fp16 balanced w1", **r})
    del x, hm, dy_m, dy_h, w1, w2
    torch.cuda.empty_cache()
    return out


def coverage_split(dev) -> dict:
    """The fp32 pieces' split kernel (one launch for q, k, v and dO) bit for
    bit against ``plain_split`` at the D = 128 coverage shapes, the inputs
    spread over 1e-20 to 1e20 and put on bf16 rounding ties, and a planted
    fault (the lo piece dropped: a two-piece split) the check must refuse;
    timed beside its
    bound (10 bytes an element) and the plain version."""
    g = torch.Generator(device=dev).manual_seed(SEED + 22)
    D, S = 128, TRAIN_S
    shapes = [(TRAIN_B, S, HEADS, D), (TRAIN_B, S, COVERAGE_KV_HEADS, D), (TRAIN_B, S, COVERAGE_KV_HEADS, D),
              (TRAIN_B, S, HEADS, D)]
    xs = [torch.randn(sh, generator=g, device=dev) for sh in shapes]
    spread = torch.logspace(-20, 20, xs[0].numel(), device=dev).view(shapes[0])
    xs[0] = xs[0] * spread  # scales from 1e-20 to 1e20
    ties = xs[3].to(BF16).float()
    xs[3] = ties + torch.ldexp(torch.ones_like(ties), torch.frexp(ties).exponent - 9)  # bf16 value + half its ulp
    got = pieces.split_pieces(*xs)
    torch.cuda.synchronize()
    want = [pieces.plain_split(x) for x in xs]
    bitwise = [bitwise_equal(a, b) for a, b in zip(got, want)]
    sums_back = [bitwise_equal((a[0].float() + a[1].float()) + a[2].float(), x) for a, x in zip(got, xs)]
    planted = got[1].clone()
    planted[2] = 0
    refused = not bitwise_equal(planted, want[1])
    n = sum(x.numel() for x in xs)
    r = {"elements": n, "bitwise": bitwise, "sums_back_bitwise": sums_back, "planted_refused": refused,
         "ms": cuda_time_ms(lambda: pieces.split_pieces(*xs)),
         "plain_ms": cuda_time_ms(lambda: [pieces.plain_split(x) for x in xs], 1, 3),
         **bound(0, 10 * n), "library_ms": None, "max_abs_err": 0.0 if all(bitwise) else float("nan")}
    emit({"phase": "kernel_coverage", "case": "split_pieces fp32 -> 3 x bf16 (q, k, v, dO at D = 128)", **r})
    if not all(bitwise) or not refused:
        raise AssertionError(f"the split kernel differs from plain_split, or its planted fault went through: {r}")
    # the inputs at 1e-20 have normal pieces; the sums come back exactly
    if not all(sums_back):
        raise AssertionError(f"the pieces do not sum back to their inputs: {sums_back}")
    del xs, got, want
    return r


def phase_kernel_coverage(dev) -> dict:
    """Every splash instantiation of ``COVERAGE_DIMS`` (and the dropout
    cases) on one packed 4096-token row, then gmm/tgmm in fp16.  Returns
    {(kernel, dtype, D): numbers} for the kernels line."""
    g = torch.Generator(device=dev).manual_seed(SEED + 20)
    seg = torch.from_numpy(packed_segments(TRAIN_B, TRAIN_S, MAX_SEG, 0, np.random.RandomState(SEED + 20))[0]).to(dev)
    out = {}
    for name, dims in COVERAGE_DIMS.items():
        for D in dims:
            for rate in (0.0, 0.1) if D == COVERAGE_DROPOUT[name] else (0.0,):
                r = coverage_case(dev, g, seg, name, D, rate)
                emit({"phase": "kernel_coverage", "case": f"splash {name} D={D} dropout {rate}",
                      "shape_q": [TRAIN_B, TRAIN_S, HEADS, D], "kv_heads": COVERAGE_KV_HEADS,
                      "limits": COVERAGE_LIMITS[name], **r})
                if not r["held"]:
                    raise AssertionError(f"splash {name} D={D} dropout {rate}: kernels disagree with the plain "
                                         f"versions: {r}")
                if not r["planted_refused"]:
                    raise AssertionError(f"splash {name} D={D} dropout {rate}: a planted fault got through: {r}")
                for kname, err in (("fwd", r["out_max_abs_err"]), ("bwd_dkdv", max(r["dk_max_abs_err"],
                                                                                   r["dv_max_abs_err"])),
                                   ("bwd_dq", r["dq_max_abs_err"])):
                    entry = out.setdefault((kname, name, D), {"max_abs_err": 0.0})
                    entry["max_abs_err"] = max(entry["max_abs_err"], err)
                    if kname in r:
                        entry.update(r[kname])
        gc.collect()
        torch.cuda.empty_cache()
    for kname, r in coverage_gmm(dev).items():
        out[(kname, "f16", None)] = r
    out[("split_pieces", "f32", None)] = coverage_split(dev)
    return out


def phase_demo_entry(dev) -> dict:
    """``python -m internevo_tpu_torch.train.main --config configs/demo.py``
    in-process (``train/main.py::main``, no ``--device``): 20 steps through
    the fp32 splash kernels at head dim 16 and fused AdamW on fp32 leaves,
    the plain attention never called; then the same run with ``--device
    cpu`` from the card run's initial params (the card's and the CPU's
    generators draw different numbers from one seed), and the two held
    step by step."""
    runs, initial = [], {}
    init = train_main.initialize_model

    def recorded(*args, **kw):
        runs.append(run_training(*args, **kw))
        return runs[-1]

    def captured(config, device, generator):
        model, params = init(config, device, generator)
        initial["params"] = tree_map(lambda t: t.detach().to("cpu", copy=True), params)
        return model, params

    plain_calls = {"plain_forward": 0, "plain_backward": 0}
    originals = {n: getattr(splash, n) for n in plain_calls}

    def counting(n):
        def call(*args, **kw):
            plain_calls[n] += 1
            return originals[n](*args, **kw)
        return call

    zero_counts()
    splash.launches_by_case.clear()
    train_main.run_training, train_main.initialize_model = recorded, captured
    for n in plain_calls:
        setattr(splash, n, counting(n))
    t0 = time.perf_counter()
    try:
        train_main.main(["--config", str(DEMO_CONFIG)])
        torch.cuda.synchronize()
    finally:
        train_main.run_training, train_main.initialize_model = run_training, init
        for n, f in originals.items():
            setattr(splash, n, f)
    card_s = time.perf_counter() - t0
    by_case = dict(splash.launches_by_case)
    total = kernel_counts()
    splits = pieces.launches
    card = runs[0]
    t0 = time.perf_counter()
    cpu = run_training(DEMO_CONFIG, params=initial["params"], device="cpu")
    cpu_s = time.perf_counter() - t0
    cfg = card["model"].config
    D = cfg.hidden_size // cfg.num_attention_heads
    lc, lp = [r["loss"] for r in card["records"]], [r["loss"] for r in cpu["records"]]
    gn_card, gn_cpu = [r["grad_norm"] for r in card["records"]], [r["grad_norm"] for r in cpu["records"]]
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(lc, lp)]
    gnorm_rel = [abs(a - b) / abs(b) for a, b in zip(gn_card, gn_cpu)]
    steps = len(lc)
    leaves = len(tree_leaves(card["engine"].params))
    micro = card["config"].data.micro_num
    want = {("fwd", "f32", D): steps * cfg.num_layers * micro, ("bwd_dkdv", "f32", D): steps * cfg.num_layers * micro,
            ("bwd_dq", "f32", D): steps * cfg.num_layers * micro}
    emit({"phase": "demo_entry", "command": "python -m internevo_tpu_torch.train.main --config configs/demo.py",
          "dtype": str(cfg.dtype), "layers": cfg.num_layers, "hidden": cfg.hidden_size,
          "heads": cfg.num_attention_heads, "head_dim": D, "steps": steps, "losses_card": lc, "losses_cpu": lp,
          "grad_norms_card": gn_card, "grad_norms_cpu": gn_cpu, "loss_rel_diff": loss_rel,
          "grad_norm_rel_diff": gnorm_rel,
          "limits": {"loss_rtol": DEMO_LOSS_RTOL, "grad_norm_rtol": DEMO_GNORM_RTOL},
          "first_loss_minus_ln_vocab": lc[0] - math.log(cfg.vocab_size), "card_s": card_s, "cpu_s": cpu_s,
          "launches_by_case": {"/".join(map(str, k)): v for k, v in by_case.items()},
          "launches_fwd_dkdv_dq_dropout_adamw": list(total), "launches_split_pieces": splits,
          "plain_calls": plain_calls,
          "tokens_per_s_card": float(np.median([r["tgs"] for r in card["records"][1:]]))})
    if steps != 20 or {k: by_case.get(k, 0) for k in want} != want or total[4] != steps * leaves:
        raise AssertionError(f"demo: {steps} steps, launches {by_case}, adamw {total[4]}: want 20, {want}, "
                             f"{steps * leaves}")
    if any(plain_calls.values()) or set(by_case) != set(want):
        raise AssertionError(f"demo: the plain attention ran {plain_calls} or other kernels launched {by_case}")
    if splits != 2 * steps * cfg.num_layers * micro:  # one for each forward's q, k, v and backward's q, k, v, dO
        raise AssertionError(f"demo: {splits} split launches, want {2 * steps * cfg.num_layers * micro}")
    if not abs(lc[0] - math.log(cfg.vocab_size)) < 0.05 or not lc[-1] < lc[0]:
        raise AssertionError(f"demo losses {lc}: the first is not ln(vocab) or the loss did not fall")
    if not (max(loss_rel) <= DEMO_LOSS_RTOL and max(gnorm_rel) <= DEMO_GNORM_RTOL):
        raise AssertionError(f"demo on the card left the CPU run: losses {loss_rel}, grad norms {gnorm_rel}")
    del runs, card, cpu
    return {"by_case": by_case, "adamw": total[4], "split": splits}


def fp16_config(layers: int) -> Config:
    config = train_config(layers)
    config.model.dtype = "torch.float16"
    return config


def expected_scales(found_inf: list, scaler) -> list:
    """The loss scale at each step under the dynamic scaler's rules (backoff
    once an overflow brings the hysteresis count to its limit, growth after
    ``growth_interval`` clean steps, which resets the hysteresis count), from
    the first step's scale: ``solver/optimizer.py``'s rules replayed on the
    host."""
    scale, hyst, growth, out = float(scaler.fp16.initial_scale), 0, 0, []
    for inf in found_inf:
        out.append(scale)
        if inf:
            hyst, growth = hyst + 1, 0
            if hyst >= scaler.hysteresis:
                scale = max(scale * scaler.backoff_factor, float(scaler.fp16.min_scale))
        else:
            growth += 1
            if growth >= scaler.fp16.growth_interval:
                scale, growth, hyst = min(scale * scaler.growth_factor, float(scaler.max_scale)), 0, 0
    return out


def phase_fp16_training(dev) -> dict:
    """``configs/7B_sft.py`` at fp16: the first step's grads of a 2-layer
    model (scaled by the file's initial loss scale, unscaled) through the
    kernels against the plain attention; then the 8-layer model, 4 steps of
    4 packed 4096-token rows through the Trainer with the dynamic scaler."""
    phase_train_grads(dev, fp16_config(FP16_GRAD_LAYERS), SEED + 22, "fp16_training", FP16_GRAD_REL_L2)
    gc.collect()
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    config, model, params, trainer, batch = train_setup(dev, SEED + 23, fp16_config(FP16_TRAIN_LAYERS))
    cfg, data = model.config, config.data
    micro_num, tokens = data.micro_num, data.micro_num * data.micro_bsz * data.seq_len
    leaves = tree_leaves(params)
    zero_counts()
    splash.launches_by_case.clear()
    recs, times = [], []
    for step in range(1, TRAIN_STEPS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = trainer.execute_schedule(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        recs.append({"step": step, "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                     "loss_scale": float(m["loss_scale"]), "found_inf": bool(m["found_inf"]),
                     "n_tokens": int(m["n_tokens"]), "step_s": times[-1]})
        emit({"phase": "fp16_training", **recs[-1]})
    by_case = dict(splash.launches_by_case)
    total = kernel_counts()
    L = cfg.num_layers
    clean = [r for r in recs if not r["found_inf"]]
    step_s = float(np.median(times[1:]))
    tflops = get_megatron_flops(step_s, checkpoint=cfg.checkpoint > 0, seq_len=data.seq_len,
                                hidden_size=cfg.hidden_size, num_layers=L, vocab_size=cfg.vocab_size,
                                global_batch_size=micro_num * data.micro_bsz, mlp_ratio=cfg.mlp_ratio)
    scales = [r["loss_scale"] for r in recs]
    want_scales = expected_scales([r["found_inf"] for r in recs], config.grad_scaler)
    emit({"phase": "fp16_training", "model": "configs/7B_sft.py", "dtype": str(cfg.dtype), "layers": L,
          "cut": "num_layers 32 -> 8 (as training); model.dtype bf16 -> fp16 (no shipped file trains in fp16)",
          "params": sum(p.numel() for p in leaves), "micro_num": micro_num, "tokens_per_step": tokens,
          "losses": [r["loss"] for r in recs], "loss_scales": scales, "expected_loss_scales": want_scales,
          "skipped_steps": [r["step"] for r in recs if r["found_inf"]], "step_s": times,
          "step_s_median_2_4": step_s, "tokens_per_s": tokens / step_s, "tflops_megatron": tflops,
          "mfu": tflops / device_peak_tflops(), "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
          "launches_by_case": {"/".join(map(str, k)): v for k, v in by_case.items()},
          "launches_fwd_dkdv_dq_dropout_adamw": list(total)})
    per = TRAIN_STEPS * L * micro_num
    want = {("fwd", "f16", 128): per, ("bwd_dkdv", "f16", 128): per, ("bwd_dq", "f16", 128): per}
    if by_case != want or total[4] != TRAIN_STEPS * len(leaves):
        raise AssertionError(f"fp16 training launches {by_case}, adamw {total[4]}: want {want}, "
                             f"{TRAIN_STEPS * len(leaves)}")
    if scales != want_scales or not clean or not all(math.isfinite(r["loss"]) for r in recs):
        raise AssertionError(f"fp16 training: scales {scales} (want {want_scales}), records {recs}")
    if any(r["n_tokens"] != tokens for r in recs) or not all(math.isfinite(r["grad_norm"]) for r in clean):
        raise AssertionError(f"fp16 training records {recs}")
    if len(clean) > 1 and not clean[-1]["loss"] < clean[0]["loss"]:
        raise AssertionError(f"fp16 training: the loss did not fall over the clean steps {clean}")
    del trainer, model, params, leaves, batch
    return {"by_case": by_case, "adamw": total[4]}


def phase_moe_fp16_grads(dev) -> dict:
    """The dropless MoE4 at fp16, 2 layers, full width, one packed row: a
    forward and backward through the kernels (the launches counted), then the
    same pass with every gmm, gmm dgrad and tgmm call held against its plain
    version on its own inputs, with a planted fault each."""
    config = moe_config(MOE_FP16_LAYERS)
    config.model.dtype = "torch.float16"
    scale = float(config.grad_scaler.fp16.initial_scale)
    model, params = initialize_model(config, dev, torch.Generator(device=dev).manual_seed(SEED + 24))
    cfg = model.config
    batch = packed_batch((TRAIN_B,), TRAIN_S, 0, cfg.vocab_size, np.random.RandomState(SEED + 24), dev)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)

    def step():
        loss, _ = moe_loss_of(model, params, batch, None, config.loss.moe_loss_coeff, train=True)
        (loss * scale).backward()
        out = [p.grad for p in leaves]
        for p in leaves:
            p.grad = None
        return out

    zero_counts()
    gmm.launches_by_case.clear()
    grads = step()
    torch.cuda.synchronize()
    by_case = dict(gmm.launches_by_case)
    finite = all(bool(torch.isfinite(x.float()).all()) for x in grads)
    del grads

    records = []
    kernel_gmm, kernel_tgmm = gmm.gmm, gmm.tgmm

    def held(kind, got, want, planted_call):
        planted_call.ends[0] += 1
        planted_call.launch()
        records.append({"kind": kind, "shape": list(got.shape), "dtype": str(got.dtype),
                        "rel_l2": rel_l2(got, want), "planted_rel_l2": rel_l2(planted_call.out, want)})

    def held_gmm_call(x, w, group_sizes, *, transpose_rhs=False, out_dtype=None):
        got = kernel_gmm(x, w, group_sizes, transpose_rhs=transpose_rhs, out_dtype=out_dtype)
        held("gmm_dgrad" if transpose_rhs else "gmm", got,
             gmm.plain_gmm(x, w, group_sizes, transpose_rhs=transpose_rhs, out_dtype=out_dtype),
             gmm.GmmCall(x, w, group_sizes, transpose_rhs, out_dtype))
        return got

    def held_tgmm_call(x, dy, group_sizes, E, out_dtype=torch.float32):
        got = kernel_tgmm(x, dy, group_sizes, E, out_dtype)
        held("tgmm", got, gmm.plain_tgmm(x, dy, group_sizes, E, out_dtype),
             gmm.TgmmCall(x, dy.contiguous(), group_sizes, E, out_dtype))
        return got

    gmm.gmm, gmm.tgmm = held_gmm_call, held_tgmm_call
    try:
        step()
        torch.cuda.synchronize()
    finally:
        gmm.gmm, gmm.tgmm = kernel_gmm, kernel_tgmm
    L = cfg.num_layers
    want = {("gmm", "f16"): 3 * L, ("gmm_dgrad", "f16"): 3 * L, ("tgmm", "f16"): 3 * L}
    ok = [r for r in records if r["dtype"] == str(torch.float16) and r["rel_l2"] <= FP16_GMM_REL_L2
          and r["planted_rel_l2"] > FP16_GMM_REL_L2]
    emit({"phase": "moe_fp16_grads", "model": "configs/7B_MoE4_sft.py (MegaBlock-D)", "dtype": str(cfg.dtype),
          "layers": L, "hidden": cfg.hidden_size, "experts": cfg.num_experts, "tokens": TRAIN_S,
          "loss_scale": scale, "grads_finite": finite, "bound": FP16_GMM_REL_L2,
          "launches_by_case": {"/".join(map(str, k)): v for k, v in by_case.items()}, "calls": records})
    if by_case != want or not finite:
        raise AssertionError(f"fp16 MoE launches {by_case} (want {want}), finite grads {finite}")
    if len(records) != 9 * L or len(ok) != len(records):
        raise AssertionError(f"fp16 MoE: {len(ok)} of {len(records)} gmm calls held (want {9 * L}): {records}")
    del model, params, leaves, batch
    return {"by_case": by_case}


SLICE11_PHASES = ("kernel_coverage", "demo_entry", "fp16_training", "moe_fp16_grads")
KERNEL_REPLACES = {
    "fwd": "internevo_tpu/ops/pallas/splash_attention.py:558 (_fwd_kernel_bsd), :457 (_fwd_kernel)",
    "bwd_dkdv": "internevo_tpu/ops/pallas/splash_attention.py:984 (_bwd_kernel_bsd), :787 (_bwd_kernel)",
    "bwd_dq": "internevo_tpu/ops/pallas/splash_attention.py:984 (_bwd_kernel_bsd), :787 (_bwd_kernel)",
    "gmm": "internevo_tpu/ops/pallas/gmm.py:122 (_gmm_kernel)",
    "gmm_dgrad": "internevo_tpu/ops/pallas/gmm.py:122 (_gmm_kernel, transpose_rhs)",
    "tgmm": "internevo_tpu/ops/pallas/gmm.py:151 (_tgmm_kernel)",
    "split_pieces": "internevo_tpu/ops/pallas/splash_attention.py:513, :528 (the f32 dots' operands, which "
                    "the TPU's matrix unit splits itself; no TPU kernel)"}


def coverage_entries(slice11: dict) -> list:
    """The kernels-line entries of this slice's new instantiations: every
    (kernel, dtype, head dim) of kernel_coverage but bf16 at 128 (the
    training and scoring kernels' own entries), and gmm, gmm dgrad and tgmm
    in fp16; their launches are the main paths' of demo_entry,
    fp16_training and moe_fp16_grads (0, and ``main_path`` false, for an
    instantiation that only kernel_coverage runs), their numbers
    kernel_coverage's."""
    paths = {name: slice11[name]["by_case"] for name in ("demo_entry", "fp16_training", "moe_fp16_grads")}
    entries = []
    for (kname, dt, D), r in slice11["kernel_coverage"].items():
        if (dt, D) == ("bf16", 128):
            continue
        if kname == "split_pieces":
            entries.append({"name": kname, "route": "triton", "source": "internevo_tpu_torch/ops/cuda/pieces.py",
                            "replaces": KERNEL_REPLACES[kname], "launches": slice11["demo_entry"]["split"],
                            "main_path": True, **{k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                                                    "bound_by", "library_ms")}})
            continue
        key = (kname, dt) if D is None else (kname, dt, D)
        launches = {f"launches_{p}": counts[key] for p, counts in paths.items() if counts.get(key)}
        source = gmm.SOURCE if D is None else splash.SOURCE if kname == "fwd" else splash.BWD_SOURCE
        name = f"{kname}_{dt}" if D is None else f"splash_attention_{kname}_{dt}_d{D}"
        entries.append({"name": name, "route": "cuda", "source": f"internevo_tpu_torch/csrc/{source}",
                        "replaces": KERNEL_REPLACES[kname], "launches": sum(launches.values()), **launches,
                        "main_path": bool(launches),
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                        **{key: r[key] for key in ("library_flex_ms", "bound_peak", "bound_cuda_core_ms",
                                                   "library_efficient_ms") if key in r}})
    return entries


def run_slice11_phases(dev, only=SLICE11_PHASES) -> dict:
    out = {}
    for name, phase in (("kernel_coverage", phase_kernel_coverage), ("demo_entry", phase_demo_entry),
                        ("fp16_training", phase_fp16_training), ("moe_fp16_grads", phase_moe_fp16_grads)):
        if name in only:
            out[name] = phase(dev)
            gc.collect()
            torch.cuda.empty_cache()
    return out


GSHARD_PHASES = ("gshard_scoring", "gshard_grads", "entry_training", "checkpoint_resume")


def run_gshard_phases(dev, only=GSHARD_PHASES) -> dict:
    out = {}
    if "gshard_scoring" in only:
        out["gshard_scoring"] = phase_gshard_scoring(dev)
        gc.collect()
        torch.cuda.empty_cache()
    if "gshard_grads" in only:
        phase_gshard_grads(dev)
        gc.collect()
        torch.cuda.empty_cache()
    if "entry_training" in only or "checkpoint_resume" in only:
        # a fresh folder on every call: auto-resume would load one left behind
        base = max((REPO, Path(tempfile.gettempdir())), key=lambda p: shutil.disk_usage(p).free)
        folder = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_", dir=base))
        try:
            layers = phase_checkpoint_disk(dev, folder)["layers"]
            first = phase_entry_training(dev, folder, layers)
            out["entry_training"] = first
            gc.collect()
            torch.cuda.empty_cache()
            if "checkpoint_resume" in only:
                first["bytes"] = sum(p.stat().st_size for p in (folder / "50").rglob("*") if p.is_file())
                out["checkpoint_resume"] = phase_checkpoint_resume(dev, folder, layers, first)
                gc.collect()
                torch.cuda.empty_cache()
        finally:
            shutil.rmtree(folder, ignore_errors=True)
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    only = None
    if argv:
        if len(argv) != 2 or argv[0] != "--only" or not set(argv[1].split(",")) <= {*GSHARD_PHASES,
                                                                                     *SLICE11_PHASES}:
            raise SystemExit(f"usage: chip_smoke.py [--only {','.join(GSHARD_PHASES + SLICE11_PHASES)}]")
        only = tuple(argv[1].split(","))
    phase_device()
    dev = torch.device("cuda")
    phase_build(dev)
    if only is not None:
        if set(only) & set(GSHARD_PHASES):
            run_gshard_phases(dev, only)
        run_slice11_phases(dev, only)
        emit({"only": list(only), "ok": True})
        return 0
    kernel = phase_kernel(dev)
    torch.cuda.empty_cache()

    config = Config.from_file(REPO / "configs" / "7B_sft.py")
    model, params = initialize_model(config, "cuda", torch.Generator(device=dev).manual_seed(SEED))
    launches = phase_scoring(model, params, dev)
    phase_serving(model, params, dev)
    del model, params
    gc.collect()
    torch.cuda.empty_cache()  # training starts from an empty card

    bwd = phase_kernel_bwd(dev)
    adamw = phase_kernel_adamw(dev)
    phase_train_grads(dev)
    gc.collect()
    torch.cuda.empty_cache()
    trained = phase_training(dev)
    gc.collect()
    torch.cuda.empty_cache()

    gmm_kernels = phase_kernel_gmm(dev)
    phase_moe_grads(dev)
    gc.collect()
    torch.cuda.empty_cache()
    moe_scored = phase_moe_scoring(dev)
    gc.collect()
    torch.cuda.empty_cache()
    moe_trained, trajectory = phase_moe_training(dev)
    gc.collect()
    torch.cuda.empty_cache()
    phase_moe_training_plain(dev, trajectory)
    gc.collect()
    torch.cuda.empty_cache()

    dropout_kernel = phase_kernel_dropout(dev)
    phase_remat_grads(dev)
    gc.collect()
    torch.cuda.empty_cache()
    model, params = initialize_model(Config.from_file(INTERNLM2_CONFIG), "cuda",
                                     torch.Generator(device=dev).manual_seed(SEED))
    internlm2_scored = phase_scoring(model, params, dev, "internlm2_scoring", "configs/7B_internlm2.py")
    phase_serving(model, params, dev, "internlm2_serving", INTERNLM2_GREEDY, sampled=False)
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    internlm2 = phase_internlm2_training(dev)
    gc.collect()
    torch.cuda.empty_cache()
    gshard_run = run_gshard_phases(dev)
    entry, resumed = gshard_run["entry_training"], gshard_run["checkpoint_resume"]
    slice11 = run_slice11_phases(dev)
    demo, fp16 = slice11["demo_entry"], slice11["fp16_training"]

    gmm_source = f"internevo_tpu_torch/csrc/{gmm.SOURCE}"
    bwd_source = f"internevo_tpu_torch/csrc/{splash.BWD_SOURCE}"
    bwd_replaces = "internevo_tpu/ops/pallas/splash_attention.py:984 (_bwd_kernel_bsd), :787 (_bwd_kernel)"
    bwd_common = {"plain_ms": bwd["plain_ms"], "plain": "plain_backward (dq, dk, dv together)",
                  "library_ms": bwd["library_ms"],
                  "library": "scaled_dot_product_attention backward alone, bool mask (yardstick)",
                  "library_fwd_bwd_ms": bwd["library_fwd_bwd_ms"], "library_flex_ms": bwd["library_flex_ms"],
                  "backward_ms": bwd["backward_ms"]}
    emit({"kernels": [
        {"name": "splash_attention_fwd", "route": "cuda", "source": f"internevo_tpu_torch/csrc/{splash.SOURCE}",
         "replaces": "internevo_tpu/ops/pallas/splash_attention.py:558 (_fwd_kernel_bsd), :457 (_fwd_kernel)",
         "launches": launches, "launches_training": trained["fwd"], "launches_internlm2_scoring": internlm2_scored,
         "launches_internlm2_training": internlm2["fwd"], "launches_gshard_scoring": gshard_run["gshard_scoring"],
         "launches_entry_training": entry["fwd"], "launches_checkpoint_resume": resumed["fwd"],
         "max_abs_err": kernel["max_err_out"],
         "max_err_lse": kernel["max_err_lse"], "ms": kernel["kernel_ms"], "wrapper_ms": kernel["wrapper_ms"],
         "plain_ms": kernel["plain_ms"], "bound_ms": kernel["bound_ms"], "bound_by": kernel["bound_by"],
         "library_ms": kernel["library_ms"], "library_flex_ms": kernel["library_flex_ms"]},
        {"name": "splash_attention_bwd_dkdv", "route": "cuda", "source": bwd_source, "replaces": bwd_replaces,
         "launches": trained["dkdv"], "launches_internlm2_training": internlm2["dkdv"],
         "launches_entry_training": entry["dkdv"], "launches_checkpoint_resume": resumed["dkdv"],
         **bwd["dkdv"], **bwd_common},
        {"name": "splash_attention_bwd_dq", "route": "cuda", "source": bwd_source, "replaces": bwd_replaces,
         "launches": trained["dq"], "launches_internlm2_training": internlm2["dq"],
         "launches_entry_training": entry["dq"], "launches_checkpoint_resume": resumed["dq"], **bwd["dq"],
         **bwd_common},
        {"name": "fused_adamw", "route": "triton", "source": "internevo_tpu_torch/ops/cuda/fused_adamw.py",
         "replaces": "internevo_tpu/ops/pallas/fused_adamw.py:37 (_kernel)", "launches": trained["adamw"],
         "launches_internlm2_training": internlm2["adamw"], "launches_entry_training": entry["adamw"],
         "launches_checkpoint_resume": resumed["adamw"], "launches_demo_entry": demo["adamw"],
         "launches_fp16_training": fp16["adamw"], **adamw},
        {"name": "dropout", "route": "triton", "source": "internevo_tpu_torch/ops/cuda/dropout.py",
         "replaces": "internevo_tpu/models/base.py:412 (dropout: jax.random.bernoulli, no TPU kernel)",
         "launches": internlm2["dropout"], **dropout_kernel},
        {"name": "gmm", "route": "cuda", "source": gmm_source,
         "replaces": "internevo_tpu/ops/pallas/gmm.py:122 (_gmm_kernel)", "launches": moe_trained["gmm"],
         "launches_scoring": moe_scored, **gmm_kernels["gmm"]},
        {"name": "gmm_dgrad", "route": "cuda", "source": gmm_source,
         "replaces": "internevo_tpu/ops/pallas/gmm.py:122 (_gmm_kernel, transpose_rhs)",
         "launches": moe_trained["gmm_dgrad"], **gmm_kernels["gmm_dgrad"]},
        {"name": "tgmm", "route": "cuda", "source": gmm_source,
         "replaces": "internevo_tpu/ops/pallas/gmm.py:151 (_tgmm_kernel)", "launches": moe_trained["tgmm"],
         **gmm_kernels["tgmm"]},
        *coverage_entries(slice11),
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
