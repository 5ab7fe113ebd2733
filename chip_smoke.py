#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (tfmq_dm_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each with a time budget (the script raises and exits non-zero
when one is exceeded):

1. device   - a CUDA card must be present; prints its name and power limit.
2. build    - compiles the four CUDA sources cold (nvcc, sm_90a), the
              nvcc processes at once; prints each kernel's registers and
              shared memory.
3. kernels  - every distinct conv and linear geometry of the CIFAR-10
              (batch 8), cin256 (batch 2 x CFG), SD v1.4 (batch 1 x
              CFG), phase uncond's (batch 2: lsun_churches256,
              lsun_beds256, ddim_celeba64) and phase text's (batch 1 x
              CFG: txt2img_1p4b, text2img_256) int4-serving paths plus odd
              shapes, the first three paths' geometries on the int8 GEMM (``int8_matmul_pre``, and the
              int8 conv on its im2col, sym and asym grids), and the four
              flash-attention kernels at the cin256 and SD shapes (fqk
              with and without the softmax quantizer, with int8_pv, over
              two key blocks), the fused int8 GEMM
              (``int8_matmul_fused``) on the linear geometries and the
              fused GroupNorm + SiLU + int8 quantization
              (``gn_swish_quant_int8``) at the cin256 and CIFAR-10
              GroupNorms and SD's resblock shapes: each CUDA kernel
              against its plain PyTorch version on the same inputs (and
              ``int4_linear``, ``flash_int8`` with the softmax quantizer
              and ``gn_swish_quant_int8`` against themselves: two calls
              bit-identical; the fqk pre-pass bit-equal to its plain
              version; ``gn_swish_quant_int8``'s plan printed a shape);
              then
              times kernel, plain version and one PyTorch library call on
              the device (calls captured in a CUDA graph), and the
              kernel's wall time per eager call, beside the card's bound:
              ``int4_conv2d`` and cuDNN's bf16 conv at every conv geometry
              of both int4-serving paths with its launches per forward (a
              walk of the model's layers, held after the last phase
              against the launches the int4-serving runs counted) and the
              launch-weighted sums per forward (``int4_conv2d`` is
              also checked for two bit-identical calls: split K adds its
              partial sums in a fixed order),
              ``int4_linear`` at every distinct cin256 geometry and
              CIFAR-10's, ``flash_fqk`` in its three modes, ``flash_fp``,
              ``flash_pquant`` (8- and 16-bit softmax grids) and
              ``flash_int8`` (with and without the softmax quantizer) at
              cin256, SD's 64x64 and 32x32, the 32x32 AttentionBlocks
              of phase uncond (T 1024, D 24 and 32) and phase text's
              32x32 self-attentions (T 1024: B*H 16, D 40; B*H 24, D 32;
              the f32 kernels also beside SDPA on their f32 operands),
              with the sums per forward of ``int4_linear`` (every linear
              geometry of SD and of phases uncond's and text's paths, by
              launches), ``flash_int8`` and ``flash_fp`` (SD and those
              paths), each
              printed beside its earlier
              design's device time where one was taken (``EARLIER_MS``;
              not in the
              ``kernels`` line, which holds this run's numbers only).
              No model path of the JAX package reaches the last two
              kernels (tests and ``scripts/micro_gn.py`` only): their
              launches are counted over this phase's timing runs, which
              include the port's twin of ``scripts/micro_gn.py``.
4. main     - the full-width CIFAR-10 w4a8 int4-serving path: the port's
              CLI calibrates the trained weights of runs/cifar10_ddpm.npz
              on the card (``cli.main --ptq --cali``: a ``CALI_STEPS``-step
              harvest of 16 samples a step, TIAR/AdaRound reconstruction
              of all 32 units with ``CALI_ITERS`` iterations each,
              running-stat FSC,
              the artifact in a temporary directory); the phase prints the
              calibration's seconds, each unit's first and last loss and
              the guard's decisions, and fails unless every layer that
              reconstruction trains carries an alpha and at least one unit
              kept its trained alphas. Then ``cli.main`` samples 8 images
              in 10 DDIM steps from that artifact with the packed-int4
              kernels; launch counts are read around that call. The same
              sampling with the plain versions gives the kernel-vs-plain
              PSNR; the FP sampling gives the quantized-vs-FP PSNR, printed
              beside that of an artifact of minmax grids and the FSC init
              pass only (information). The deploy phase's CIFAR-10
              artifacts (w4a8 with symmetric grids, and w8a8) are of that
              second kind, calibrated here on a 10-step harvest at batch 8:
              no reconstruction.
5. recon    - the rest of reconstruction at CIFAR-10 width on the
              trained weights, on phase main's harvest (drawn again with
              its seed), each cut printed: (a) ``recon.reconstruct`` of a
              few units with ``resume_dir`` and short segments, under
              ``torch.use_deterministic_algorithms``, twice uninterrupted,
              then crashed by an injected failure after a partial save
              inside a unit that is not the first and run again: the unit
              and iteration it resumed at, the resumed alphas bit-equal to
              the uninterrupted run's (or, where an op has no
              deterministic algorithm, named, within twice the difference
              of the two uninterrupted runs), no partial file left, and
              the seconds of one partial save at the largest unit; (b)
              ``capture_unit_grads`` of mid.block_1 on the card against
              the CPU on the same rows, its seconds over the harvest, and
              a fisher_diag ``reconstruct_unit`` of it whose losses must
              fall; (c) ``reconstruct_act`` over every unit on one FSC
              group of phase main's artifact (every site kept, zero
              points unchanged, a delta moved; the guard's kept and
              reverted counts), its seconds per iteration under the CUDA
              graph, and that group's trained deltas written back into an
              artifact sampled by ``cli.main --int-kernels
              --int4-serving`` with the kernels and with the plain
              versions (PSNR >= 30 dB). Prints the phase's seconds split
              into resume, Fisher and act.
6. ldm      - the full-width class-conditional LDM (cin256_v2) w4a8
              int4-serving path: a seeded random-init checkpoint in the
              reference's Lightning layout (UNet, VQ-f4 decoder, class
              embedding) in a temporary directory, a ``LDM_STEPS``-step
              calibration harvest at batch 2 x CFG (flash fp), the FSC
              init pass, then
              ``cli.main --ptq --cali`` calibrates the checkpoint at full
              width on the card (a CFG harvest of ``LDM_CALI_STEPS`` steps
              x ``LDM_CALI_N`` samples, flash fp counted around it;
              TIAR/AdaRound reconstruction of all 74 units with
              ``LDM_CALI_ITERS`` iterations each; running-stat FSC),
              printing the calibration's seconds, each unit's first and
              last loss, the guard's and the residency decisions, and
              failing unless every trained layer carries an alpha, one
              unit at least keeps its trained alphas and the running-stat
              pass ran. ``cli.main`` samples 2 images in ``LDM_STEPS``
              DDIM steps with the int4 and flash int8 kernels from the
              init-only artifact and from the reconstructed one; the
              same with the plain versions (latents >= 30 dB) and in FP
              (quantized vs FP latents printed for both artifacts); one
              deployed UNet forward, kernels against plain versions; and
              a 4-step sample with a 16-bit softmax grid (flash pquant). Launch
              counts are read around each run.
7. sd       - the full-width Stable Diffusion v1.4 w4a8 int4-serving path
              (512 x 512, 1 image x CFG at 7.5, PLMS cut to ``SD_STEPS``
              steps, one more UNet evaluation than steps): a seeded
              random-init checkpoint in the reference's Lightning layout
              (UNet, KL-f8 decoder, CLIP ViT-L/14 text tower) and a
              token-id file (the stub tokenizer's ids of a prompt at CLIP's
              vocabulary, whose BPE files are not in the repository) in a
              temporary directory; an init-only artifact (PLMS harvest,
              flash fp counted; minmax grids, FSC init pass); ``cli.main
              --token_ids`` with the int4 and flash int8 kernels, with the
              plain versions (latents >= 30 dB) and in FP, launch counts
              held against a walk of the layers (``flash_int8`` 10 a UNet
              evaluation: 5 at T 4096 / D 40, 5 at T 1024 / D 80); one
              deployed forward kernels vs plain; the device profile of a
              deployed sample; then ``cli.main --ptq --cali`` at full width
              (a harvest of ``SD_CALI_STEPS`` steps x ``SD_CALI_N`` x CFG,
              ``SD_CALI_ITERS`` iterations a unit, each cut printed) with
              the checks of phase ldm and the peak device memory, and that
              artifact sampled with the kernels and the plain versions.
8. deploy   - the int8 and bf16 deployments through ``cli.main``: cin256_v2
              ``--int-kernels --deploy_dtype bfloat16`` (``LDM_STEPS``, the ldm
              phase's checkpoint and artifact; fqk, int8_matmul_pre and the
              int8 conv), the CIFAR-10 bench configuration (w4a8
              ``--w_sym``, int8 deploy, bf16) and CIFAR-10 exact w8a8
              (f32), calibrated in phase main. Each runs with the kernels
              and with the plain versions on the same noise (PSNR >= 30 dB:
              cin256 latents, CIFAR images), with launch counts read around
              the run and around one UNet forward, PSNR against the FP
              sample (information) and the device-busy share of a
              profiled sample.
9. uncond   - the unconditional tasks at full width, each from a seeded
              random-init checkpoint in the reference's layout written in
              a temporary directory: lsun_churches256 (LDM-8: scale-shift
              norm, res blocks that resample, KL-f8 at scale_factor 1.0;
              Lightning), lsun_beds256 (LDM-4, VQ-f4, LitEma weights
              swapped in; DDIM at eta 1) and ddim_celeba64 (the DDIM
              trainer's list with ``module.`` names and its EMA shadow).
              Each gets an init-only artifact (a ``UNCOND_STEPS``-step
              harvest of ``UNCOND_N``, minmax grids, FSC init pass) and
              ``cli.main`` int4-serving samples of ``UNCOND_N`` images in
              ``UNCOND_STEPS`` DDIM steps with the kernels and with the
              plain versions from one seed (so eta 1 draws the same step
              noise): latents (images for ddim_celeba64) >= 30 dB, the
              launches equal to a walk of the layers (``flash_int8`` 5 a
              forward at T 1024 on both LDMs, D 24 and D 32), the EMA
              swap's count printed and held; lsun_churches256 also in FP,
              one deployed forward kernels vs plain, and ``cli.main
              --ptq --cali`` cut to ``UNCOND_CALI_STEPS`` x
              ``UNCOND_CALI_N`` and ``UNCOND_CALI_ITERS`` iterations a
              unit, held as phase ldm's, then that artifact sampled with
              the kernels and the plain versions. The device profile of
              each deployed sample, and each kernel's time per forward
              beside cuDNN / SDPA and the bound.

10. text    - the BERT-conditioned LDM text2img tasks at full width
              from seeded random-init checkpoints in the reference's
              Lightning layout (UNet, first stage, BERT tower under
              ``cond_stage_model.transformer.``) and token-id files (the
              stub tokenizer's ids at bert-base-uncased's vocabulary,
              whose WordPiece file is not in the repository), 1 image x
              CFG at 5.0, DDIM cut to ``TEXT_STEPS`` of 50 steps:
              txt2img_1p4b (KL-f8 to 256 x 256, BERT 1280 x 32) from an
              init-only artifact (DDIM harvest, flash fp counted; minmax
              grids, FSC init pass) through ``cli.main --token_ids`` with
              the kernels, with the plain versions (latents >= 30 dB) and
              in FP, launches held against a walk of the layers
              (``flash_int8`` 5 a forward at T 1024 / D 40, the K/V
              projections once a rollout), one deployed forward kernels
              vs plain and the device profile of a deployed sample;
              text2img_256 (VQ-f4, BERT 640 x 32) through ``cli.main
              --ptq --cali`` cut as phase sd's (``TEXT_CALI_STEPS`` x
              ``TEXT_CALI_N`` x CFG, ``TEXT_CALI_ITERS`` iterations a
              unit) with phase ldm's checks, that artifact sampled with
              the kernels and the plain versions (latents >= 30 dB,
              ``flash_int8`` 5 a forward at T 1024 / D 32); each task's
              kernel times per forward beside cuDNN / ``torch.matmul`` /
              SDPA and the bound.

11. samplers - the remaining samplers on earlier phases' models,
              int4-serving through ``cli.main`` (the task's sampler
              replaced, as the JAX tests reach these samplers: no task
              samples them): CIFAR-10 DDPM (``ddpm_noisy``) from phase
              main's artifact, 8 images x ``STEPS`` steps, with the kernels
              and the plain versions from one seed (images >= 30 dB), and
              a deployed DDIM rollout's x0 trace (``collect="x0"``) bit-
              equal at its end to the rollout without it;
              lsun_churches256 from phase uncond's checkpoint, an
              init-only artifact on the DPM-Solver++ 2M scan's
              ``DPM_STEPS`` evaluation times (float model times through
              the harvest and the FSC init pass), then ``DPM_N`` images
              from it with the 2M scan and the general engine (``DPM_RUNS``:
              multistep order 3 on logSNR steps, singlestep order 2) with
              the kernels and the plain versions (latents >= 30 dB), and
              the adaptive method (``ADAPTIVE_ORDER``) with the kernels:
              its evaluations and seconds printed. Every run's (step, FSC
              group) pairs are read from the deployed model function and
              held against the artifact's group map, and its launches
              equal to the walk of the layers times its evaluations; the
              device-busy share of a 2M deployed sample.

The profiled samples of every phase and the one-forward checks of phases
ldm, sd, deploy and text run ``PROFILE_STEPS`` steps, cut from their
samples' 10 (main) and 4 (the other phases).

Prints a ``{"kernels": [...]}`` JSON line, the card's name and power limit,
and last ``{"ok": true, "device": {...}}``. Any failure exits non-zero
without those lines.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))
# cuBLAS is deterministic under phase recon's
# torch.use_deterministic_algorithms only with a fixed workspace, set
# before its first handle
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

from tfmq_dm_tpu_torch.utils.timing import device_ms, wall_ms  # noqa: E402

PHASE_BUDGET_S = {"device": 60, "build": 180, "kernels": 240, "main": 180,
                  "recon": 120, "ldm": 420, "sd": 300, "deploy": 360,
                  "uncond": 150, "text": 180, "samplers": 120}

# kernel vs plain version: they round at the same points and differ only
# in how the f32 sums are taken; the conv's tensor cores do not round to
# nearest after every addition, so the difference grows with the depth K
# of the sum (measured on an H100: 6.6e-6 at K = 4608, 2.1e-5 at
# K = 17280). Limit relative to the output's largest magnitude, for sums
# up to K_REF deep and in proportion to K beyond.
KERNEL_REL_TOL, K_REF = 2e-5, 4608
# deployed sampling, kernels vs plain versions on the card: summation
# order flips an occasional bf16 / 8-bit activation rounding
MIN_PSNR_KERNEL_VS_PLAIN_DB = 30.0

# flash kernels vs plain versions: without a softmax quantizer the same
# limit; with one, the JAX tests' one-level rule (tests/
# test_flash_attention.py:71-79): under 0.5% of outputs off by more than
# 1e-5, none by more than 6 levels of the softmax grid (the denominator is
# summed in another order, so a probability at a rounding boundary flips)
ONE_LEVEL_SHARE, ONE_LEVEL_MAX = 0.005, 6.0
# one deployed cin256 UNet forward, kernels vs plain versions on the same
# inputs: summation order flips an occasional bf16 / 8-bit activation
# rounding or softmax level, which later layers spread. The random-init
# quantized UNet amplifies such flips: a relative input perturbation of
# 1e-7 moved the plain versions' output by 7.7% on average on an H100, as
# much as the kernels did. So the limit is relative to that sensitivity,
# measured in the same run with the plain versions: FORWARD_NOISE_FACTOR
# times the effect of a FORWARD_NOISE perturbation, never below the floors
FORWARD_MAX_REL, FORWARD_MEAN_REL = 5e-2, 5e-3
FORWARD_NOISE, FORWARD_NOISE_FACTOR = 1e-7, 5.0
# sampled cin256 latents, kernels vs plain versions; PSNR against the
# plain latents' largest magnitude
MIN_LATENT_PSNR_DB = 30.0

# dense bf16, int8 and TF32 tensor-core peaks, the f32 rate outside the
# tensor cores and the HBM rate (NVIDIA data sheet, SXM part)
CARD_PEAKS = {"H100": {"bf16": 989e12, "int8": 1979e12, "tf32": 495e12,
                       "f32": 67e12, "hbm": 3.35e12}}
# the fused GroupNorm's codes against its plain version: the statistics
# are summed in another order, so a code at a rounding boundary may move
# one level (the JAX package's own rule, tests/test_pallas_kernels.py)
GN_MAX_LEVELS, GN_MAX_SHARE = 1, 1e-4

# device ms of the kernels before their redesign for the tensor cores
# (PERF.md section 6: chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W; the
# int4_conv2d geometries from ab_kernels.py against the tree before the
# redesign, the same inputs), at the shapes where they were taken;
# printed for reading only
EARLIER_MS = {("int4_linear", 8, 512, 256): 0.0123,
              ("int4_linear", 4096, 384, 3072): 0.7676,
              ("flash_fqk", "cin256", "p levels"): 1.6757,
              ("flash_pquant", "cin256", "f32, 8-bit grid"): 0.8766,
              ("int8", "linear"): 0.1824, ("int8", "conv_gemm"): 0.2506,
              ("flash_int8", "cin256", "8-bit p"): 0.6829,
              ("flash_fp", "cin256", "f32"): 0.5694,
              ("int8_matmul_fused", 4096, 384, 3072): 0.2053,
              ("gn_swish_quant_int8", 8, 64, 64, 320): 0.0474,
              ("gn_swish_quant_int8", 8, 32, 32, 640): 0.0334,
              ("gn_swish_quant_int8", 8, 16, 16, 1280): 0.0216,
              ("int4_conv2d", 8, 4, 1, 256, 256): 0.0208,
              ("int4_conv2d", 8, 4, 3, 256, 256): 0.1404,
              ("int4_conv2d", 8, 4, 3, 512, 256): 0.3177,
              ("int4_conv2d", 8, 8, 3, 256, 256): 0.1298,
              ("int4_conv2d", 8, 8, 3, 512, 256): 0.3002,
              ("int4_conv2d", 8, 16, 1, 256, 256): 0.0210,
              ("int4_conv2d", 8, 16, 3, 128, 256): 0.0684,
              ("int4_conv2d", 8, 16, 3, 256, 256): 0.1301,
              ("int4_conv2d", 8, 16, 3, 384, 256): 0.2195,
              ("int4_conv2d", 8, 16, 3, 512, 256): 0.3109,
              ("int4_conv2d", 8, 32, 3, 128, 128): 0.0680,
              ("int4_conv2d", 8, 32, 3, 256, 128): 0.1260,
              ("int4_conv2d", 8, 32, 3, 256, 256): 0.1694,
              ("int4_conv2d", 8, 32, 3, 384, 128): 0.2011,
              ("int4_conv2d", 4, 8, 1, 960, 960): 0.0655,
              ("int4_conv2d", 4, 8, 3, 576, 960): 0.3533,
              ("int4_conv2d", 4, 8, 3, 960, 960): 0.5792,
              ("int4_conv2d", 4, 8, 3, 1536, 960): 0.9273,
              ("int4_conv2d", 4, 8, 3, 1920, 960): 1.1612,
              ("int4_conv2d", 4, 16, 1, 576, 576): 0.0412,
              ("int4_conv2d", 4, 16, 3, 384, 576): 0.2245,
              ("int4_conv2d", 4, 16, 3, 576, 576): 0.3427,
              ("int4_conv2d", 4, 16, 3, 960, 576): 0.5674,
              ("int4_conv2d", 4, 16, 3, 960, 960): 0.5576,
              ("int4_conv2d", 4, 16, 3, 1152, 576): 0.6797,
              ("int4_conv2d", 4, 16, 3, 1536, 576): 0.9146,
              ("int4_conv2d", 4, 32, 1, 384, 384): 0.0354,
              ("int4_conv2d", 4, 32, 3, 192, 384): 0.1212,
              ("int4_conv2d", 4, 32, 3, 384, 384): 0.2540,
              ("int4_conv2d", 4, 32, 3, 576, 384): 0.3797,
              ("int4_conv2d", 4, 32, 3, 576, 576): 0.4075,
              ("int4_conv2d", 4, 32, 3, 768, 384): 0.4989,
              ("int4_conv2d", 4, 32, 3, 960, 384): 0.6184,
              ("int4_conv2d", 4, 64, 3, 192, 192): 0.1377,
              ("int4_conv2d", 4, 64, 3, 384, 192): 0.2768,
              ("int4_conv2d", 4, 64, 3, 384, 384): 0.5764,
              ("int4_conv2d", 4, 64, 3, 576, 192): 0.4127}

STEPS, BATCH, SEED = 10, 8, 1234
# phase main's calibration through the CLI: sampler steps of its harvest
# (10 until phase uncond came; the task's 100), samples a step (at least
# the FSC running-stat pass's batch of 16, so that the pass runs) and
# reconstruction iterations a unit (300 until phase uncond came)
CALI_STEPS, CALI_N, CALI_ITERS = 4, 16, 100
# phase recon, the rest of reconstruction at CIFAR-10 width on the trained
# weights and phase main's harvest settings: (a) mid-unit resume over
# RESUME_UNITS (4 of the 33 units) at RESUME_ITERS iterations a unit (the
# task's 20000) in segments of RESUME_SEG (recon.RESUME_SEG_ITERS, 2500),
# crashed after the RESUME_CRASH-th partial save (inside the third
# unit); (b) the Fisher weights of FISHER_UNIT on the card against the
# CPU on FISHER_CPU_ROWS rows, timed on the harvest's rows, and a
# fisher_diag reconstruction of it at FISHER_ITERS iterations; (c) the
# act phase over every unit on FSC group ACT_GROUP's act state at
# ACT_ITERS iterations a unit (the task's 20000), its per-iteration time
# from two runs of one unit's loop (ACT_TIME_ITERS and three times that)
RESUME_UNITS = ("tib", "down.0.block.0", "down.1.block.0", "down.1.attn.0")
RESUME_ITERS, RESUME_SEG, RESUME_CRASH = 30, 10, 8
FISHER_UNIT, FISHER_CPU_ROWS, FISHER_ITERS = "mid.block_1", 8, 100
# the Fisher gradient is softmax(quantized) - softmax(FP) carried back
# through the model: a difference of nearly equal f32 values, held to
# this share of its largest magnitude (tests/test_torch_recon_extras.py)
FISHER_REL = 2e-3
ACT_GROUP, ACT_ITERS, ACT_TIME_ITERS = 2, 20, 50
NO_MODEL_PATH = ("no model path (JAX: tests/test_pallas_kernels.py, "
                 "scripts/micro_gn.py); launches of the kernels phase's "
                 "timing runs, the micro_gn twin's included")
# cin256 images per batch (the UNet sees twice as many: CFG), and the
# DDIM steps of its samples in phases ldm and deploy (the task's 20, cut
# to 10 for the script's time when phase sd came, to 4 when phase text
# came)
CIN_N, LDM_STEPS = 2, 4
# phase ldm's full-width calibration through the CLI, cut to the phase's
# time: sampler steps of the harvest (the task's 20), samples a step (the
# task's 512; with CFG twice as many rows, 16: the FSC running-stat
# pass's batch, so that the pass runs) and reconstruction iterations a
# unit (the task's 20000; 30 until phase uncond came); 74 units train
# (the TIB and 73 blocks and layers; the input conv is kept out by the
# policy)
LDM_CALI_STEPS, LDM_CALI_N, LDM_CALI_ITERS = 2, 8, 10
LDM_UNITS = 74
# phase sd: SD v1.4 at full width (512 x 512, 64 x 64 latents), 1 image
# x CFG, PLMS cut from the task's 50 steps to SD_STEPS (10 until phase
# text came; SD_STEPS + 1 UNet evaluations: step 0 evaluates twice); its
# calibration cut as phase
# ldm's (a harvest of SD_CALI_STEPS steps x SD_CALI_N prompts, 16 rows
# with CFG, and SD_CALI_ITERS iterations a unit); as cin256_v2, 74 of
# its 75 units train
SD_N, SD_STEPS = 1, 4
SD_CALI_STEPS, SD_CALI_N, SD_CALI_ITERS = 1, 8, 10
SD_UNITS = 74
SD_PROMPT = "a photograph of an astronaut riding a horse"
# phase uncond: the unconditional tasks at full width, UNCOND_N images
# each, DDIM cut to UNCOND_STEPS steps (the tasks' 400 -> 500 by the
# reference's uniform spacing, 200, 100); lsun_churches256's calibration
# cut to a harvest of UNCOND_CALI_STEPS steps x UNCOND_CALI_N samples (the
# task's 500 x 256; 16 rows, the FSC running-stat pass's batch) and
# UNCOND_CALI_ITERS iterations a unit (the task's 20000; 57 units train)
UNCOND_TASKS = ("lsun_churches256", "lsun_beds256", "ddim_celeba64")
UNCOND_N, UNCOND_STEPS = 2, 4
# the profiled samples (device-busy share, top kernels) of every phase and
# the one-forward checks of phases ldm, sd and deploy: steps cut from
# their sampling runs' 10 (phase uncond's 4) when phase uncond came (a
# profile took 20-60 s at 10 steps, 8-28 s at 4); 2 divides the LDM
# family's 1000 timesteps
PROFILE_STEPS = 2
UNCOND_CALI_STEPS, UNCOND_CALI_N, UNCOND_CALI_ITERS = 2, 16, 10
UNCOND_UNITS = 57
# phase text: the BERT-conditioned LDM text2img tasks at full width, 1
# image x CFG at the tasks' 5.0, DDIM cut from 50 steps to TEXT_STEPS;
# text2img_256's calibration cut as phase sd's (a harvest of
# TEXT_CALI_STEPS steps x TEXT_CALI_N prompts, 16 rows with CFG, and
# TEXT_CALI_ITERS iterations a unit); 74 of their 75 units train
TEXT_TASKS = ("txt2img_1p4b", "text2img_256")
TEXT_N, TEXT_STEPS = 1, 4
TEXT_CALI_STEPS, TEXT_CALI_N, TEXT_CALI_ITERS = 1, 8, 10
TEXT_UNITS = 74
TEXT_PROMPT = "a painting of a lighthouse on a cliff at sunset"
# phase samplers: the remaining samplers on earlier phases' models. DDPM
# on phase main's CIFAR-10 artifact at its STEPS steps, batch 8; DPM-Solver
# on phase uncond's lsun_churches256 checkpoint, batch DPM_N, DPM_STEPS
# steps (the task's DDIM samples 200): the dedicated 2M scan, then the
# general engine as multistep order 3 with logSNR steps and as singlestep
# order 2 (two blocks of two evaluations, each carrying its block's index
# to the FSC lookup), and the adaptive method at ADAPTIVE_ORDER
DPM_N, DPM_STEPS = 2, 4
DPM_RUNS = (("2m", []),
            ("multistep_o3_logsnr", ["--dpm_method", "multistep",
                                     "--dpm_order", "3", "--dpm_skip",
                                     "logSNR"]),
            ("singlestep_o2", ["--dpm_method", "singlestep", "--dpm_order",
                               "2"]))
ADAPTIVE_ORDER = 2


class PhaseTimeout(Exception):
    pass


@contextlib.contextmanager
def phase(name: str):
    budget = PHASE_BUDGET_S[name]

    def on_alarm(signum, frame):
        raise PhaseTimeout(f"phase {name} exceeded its {budget} s budget")

    old = signal.signal(signal.SIGALRM, on_alarm)
    signal.setitimer(signal.ITIMER_REAL, budget)
    t0 = time.perf_counter()
    print(f"== phase {name} (budget {budget} s)", flush=True)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)
    print(f"== phase {name} done in {time.perf_counter() - t0:.2f} s",
          flush=True)


def nvidia_smi() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30, check=True)
    return res.stdout.strip().splitlines()[0]


def psnr(a, b) -> float:
    import numpy as np
    mse = float(np.mean((np.asarray(a, np.float64) - b) ** 2))
    return math.inf if mse == 0 else 10 * math.log10(1.0 / mse)


def cifar_geometries(cfg):
    """Distinct (res, k, cin, cout) of the packed convs and (k, n) of the
    packed linears on the CIFAR-10 int4-serving path, with counts."""
    from tfmq_dm_tpu_torch.models import ddim_unet
    from tfmq_dm_tpu_torch.quant.policy import build_policy
    pol = build_policy(ddim_unet.layer_infos(cfg))
    quantized = {n for n in pol.weight_layers() if pol.get(n).wq}
    res, convs, linears = cfg.resolution, {}, {}
    for kind, name, shape in ddim_unet.iter_layers(cfg):
        if name.endswith("downsample.conv"):
            res //= 2
            continue
        if name.endswith("upsample.conv"):
            res *= 2
        if name not in quantized:
            continue
        if kind == "linear":
            key = (shape[0], shape[1])
            linears[key] = linears.get(key, 0) + 1
        else:
            key = (res, shape[0], shape[2], shape[3])
            convs[key] = convs.get(key, 0) + 1
    return convs, linears


def random_packed(g, shape_codes, n, dev):
    import torch
    from tfmq_dm_tpu_torch.ops.int4_kernels import pack_int4
    wp = pack_int4(torch.randint(-8, 8, shape_codes, generator=g,
                                 dtype=torch.int8))
    delta = torch.rand(n, generator=g) * 0.05 + 0.01
    zp_c = torch.randint(-8, 8, (n,), generator=g).float()
    bias = torch.randn(n, generator=g)
    return [t.to(dev) for t in (wp, delta, zp_c, bias)]


def check_close(label, got, ref, errors, depth: int = K_REF):
    import torch
    torch.cuda.synchronize()
    scale = max(1.0, float(ref.abs().max()))
    err = float((got - ref).abs().max())
    print(f"   {label:48s} max_abs_err {err:.3e}  max_rel_err "
          f"{err / scale:.3e}", flush=True)
    tol = KERNEL_REL_TOL * max(1.0, depth / K_REF)
    if not (err <= tol * scale):
        raise AssertionError(f"{label}: kernel disagrees with its plain "
                             f"version ({err:.3e} > {tol:.3g} * "
                             f"{scale:.3g})")
    errors.append(err)


def conv_case(g, b, res, k, cin, n, dev):
    import torch
    x = torch.randn(b, res, res, cin, generator=g).to(torch.bfloat16).to(dev)
    wp, d, z, bias = random_packed(g, (k * k, cin, n), n, dev)
    pad = "SAME" if k == 3 else "VALID"
    return (x, wp, d, z, k, k, bias, pad)


def linear_case(g, m, k, n, dev):
    import torch
    x = torch.randn(m, k, generator=g).to(dev)
    wp, d, z, bias = random_packed(g, (k, n), n, dev)
    return (x, wp, d, z, bias)


def timings(kernel, plain, library, flops, nbytes, peaks,
            rate: str = "bf16") -> dict:
    """Device ms per call of the kernel, its plain version and the library
    call; the kernel's wall ms per eager call; the bound: the larger of the
    operations over the tensor-core peak for their type (``rate``) and
    the bytes over the memory rate. ``flops`` may be {type: operations}
    for work of several types, each over its own peak."""
    ops = flops if isinstance(flops, dict) else {rate: flops}
    t_ops = sum(f / peaks[r] for r, f in ops.items()) * 1e3
    t_bytes = nbytes / peaks["hbm"] * 1e3
    return {"ms": device_ms(kernel), "wall_ms": wall_ms(kernel),
            "plain_ms": device_ms(plain, 5),
            "library_ms": device_ms(library),
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def timing_line(t: dict) -> str:
    return (f"{t['ms']:.4f} / {t['plain_ms']:.4f} / {t['library_ms']:.4f}; "
            f"{t['wall_ms']:.4f}; {t['bound_ms']:.6f} ({t['bound_by']})")


def time_conv(case, peaks) -> dict:
    """The kernel, its plain version and the library conv (bf16 cuDNN on
    weights dequantized ahead of time)."""
    import torch
    import torch.nn.functional as F
    from tfmq_dm_tpu_torch.ops import int4_kernels as K
    x, wp, d, z, kh, kw, bias, pad = case
    b, h, w, cin = x.shape
    n = d.shape[0]
    wd = (K.unpack_int4(wp, n).float() - z) * d
    wd = wd.to(torch.bfloat16).reshape(kh, kw, cin, n).permute(3, 2, 0, 1)
    wd = wd.contiguous(memory_format=torch.channels_last)
    bd = bias.to(torch.bfloat16)
    xn = x.permute(0, 3, 1, 2)                  # NHWC memory: channels_last
    p = kh // 2 if pad == "SAME" else 0
    flops = 2 * b * h * w * n * kh * kw * cin
    nbytes = x.numel() * 2 + wp.numel() + 3 * n * 4 + b * h * w * n * 4
    return timings(lambda: K.int4_conv2d(*case),
                   lambda: K.int4_conv2d_plain(*case),
                   lambda: F.conv2d(xn, wd, bd, padding=p),
                   flops, nbytes, peaks)


def timed_linear_shapes(cin_linears) -> list:
    """(M, K, N) of the timed ``int4_linear`` runs: CIFAR-10 at batch 64
    and 8, and every distinct cin256 geometry at batch 2 x CFG."""
    return [(64, 512, 256), (BATCH, 512, 256)] + sorted(
        {(2 * CIN_N * m, k, n) for (m, k, n) in cin_linears})


def time_linear(case, peaks) -> dict:
    """The kernel, its plain version and a bf16 ``torch.matmul`` on weights
    dequantized ahead of time."""
    import torch
    from tfmq_dm_tpu_torch.ops import int4_kernels as K
    x, wp, d, z, bias = case
    m, k = x.shape
    n = d.shape[0]
    wd = ((K.unpack_int4(wp, n).float() - z) * d).to(torch.bfloat16)
    xb = x.to(torch.bfloat16)
    flops = 2 * m * n * k
    nbytes = x.numel() * 4 + wp.numel() + 3 * n * 4 + m * n * 4
    return timings(lambda: K.int4_linear(*case),
                   lambda: K.int4_linear_plain(*case),
                   lambda: torch.matmul(xb, wd), flops, nbytes, peaks)


@contextlib.contextmanager
def plain_kernels():
    """Route every kernel wrapper to its plain version (on the card), for
    the kernel-vs-plain comparison of a whole path."""
    from tfmq_dm_tpu_torch.ops import flash_attention as FA
    from tfmq_dm_tpu_torch.ops import int4_kernels as K
    from tfmq_dm_tpu_torch.ops import int8_kernels as I8
    names = [(K, "int4_linear"), (K, "int4_conv2d"), (FA, "flash_fp"),
             (FA, "flash_pquant"), (FA, "flash_int8"), (FA, "flash_fqk"),
             (I8, "int8_matmul_pre"), (I8, "int8_conv_acc"),
             (I8, "int8_bmm_acc")]
    saved = [(m, n, getattr(m, n)) for m, n in names]
    for m, n in names:
        setattr(m, n, getattr(m, f"{n}_plain"))
    try:
        yield
    finally:
        for m, n, f in saved:
            setattr(m, n, f)


def kernel_modules():
    from tfmq_dm_tpu_torch.ops import flash_attention as FA
    from tfmq_dm_tpu_torch.ops import gn_kernels as G
    from tfmq_dm_tpu_torch.ops import int4_kernels as K
    from tfmq_dm_tpu_torch.ops import int8_kernels as I8
    return K, FA, I8, G


def reset_all_counts() -> None:
    for mod in kernel_modules():
        mod.reset_launch_counts()


def all_counts() -> dict:
    return {k: v for mod in kernel_modules() for k, v in mod.LAUNCHES.items()}


def sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize()


def profile_device(run_once, label: str, top: int = 8) -> dict:
    """Device time by kernel over one ``run_once()`` under torch.profiler,
    after a warm-up call and an unprofiled timed call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t_start = time.perf_counter()
    run_once()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_once()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    # the device's activity only: the host-side op events would repeat
    # their kernels' time, and processing them took most of a profile's
    # 10-30 s
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run_once()
        torch.cuda.synchronize()
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)
    if not rows:
        raise AssertionError(f"profile {label}: no device time recorded")
    busy_ms = sum(r[0] for r in rows)
    print(f"   profile: {label} {wall:.2f} ms wall (unprofiled), device "
          f"busy {busy_ms:.2f} ms ({100 * busy_ms / wall:.1f}%); kernels "
          "by device time:", flush=True)
    for ms, count, key in rows[:top]:
        print(f"     {ms:9.3f} ms  {100 * ms / busy_ms:5.1f}%  x{count:<5d} "
              f"{key[:70]}", flush=True)
    print(f"   profile: {label}: {time.perf_counter() - t_start:.2f} s in "
          "all (three runs and the trace's processing)", flush=True)
    return {"wall_ms": wall, "busy_ms": busy_ms}


def profile_sampling(cfg, dev, argv: list, steps: int) -> dict:
    """The CIFAR-10 deployed sample (batch 8, ``steps`` DDIM steps); the
    model is built by the CLI from the same arguments as the sampling
    run."""
    import torch
    from tfmq_dm_tpu_torch import cli
    from tfmq_dm_tpu_torch.convert import load_params
    from tfmq_dm_tpu_torch.samplers.ddim import generalized_scan

    args = cli.build_argparser().parse_args(argv)
    params, _ = load_params(args.ckpt, device=dev)
    betas, seq = cli.cifar10_schedule(steps)
    fn = cli.build_model_fn(args, params, cfg, seq[::-1], dev)
    x = torch.randn((BATCH, 32, 32, 3),
                    generator=torch.Generator().manual_seed(3)).to(dev)
    return profile_device(lambda: generalized_scan(fn, betas, seq, x),
                          f"{steps}-step sample")


def check_calibration(adapter, art: str, dev, n_units: int) -> dict:
    """Read the CLI's artifact: per-unit losses and guard decisions, the
    residency decisions, an alpha for every layer that reconstruction
    trains, at least one unit on its trained alphas, and an FSC state for
    every step, with the running-stat pass run where the artifact says
    it ran."""
    from tfmq_dm_tpu_torch.quant.calibrate import load_cali_model

    wstate, astate, meta = load_cali_model(art, device=dev)
    units = meta["recon"]["units"]
    for name, u in units.items():
        print(f"   recon {name:24s} loss {u['loss_first']:.6f} -> "
              f"{u['loss_last']:.6f}; hard loss nearest "
              f"{u['hard_nearest']:.6f}, trained {u['hard_trained']:.6f}: "
              f"keep {u['kept']}", flush=True)
    kept = sum(u["kept"] == "trained" for u in units.values())
    res = meta["recon"]["residency"]
    print(f"   guard: {kept} of {len(units)} units kept their trained "
          f"alphas, {len(units) - kept} reverted to nearest rounding; "
          f"residency: FP outputs {res['fp_out_cache']} "
          f"({res['fp_out_gib']:.3f} GiB float16), units cached on the "
          f"host {res['host'] or 'none'}; FSC {meta['fsc']}", flush=True)
    trained = [full for u in adapter.units for role, full in u.layers
               if role in adapter.default_train_roles(u)]
    missing = [n for n in trained if "alpha" not in wstate.get(n, {})]
    if missing or len(units) != n_units:
        raise AssertionError(f"reconstruction: {len(units)} units, no "
                             f"alpha for {missing}")
    if kept == 0:
        raise AssertionError("the guard reverted every unit: no trained "
                             "alpha reached the artifact")
    groups = {st["delta"].shape[0] for st in astate.values()}
    if groups != {len(meta["cali_t"])}:
        raise AssertionError(f"FSC groups {groups}, expected "
                             f"{len(meta['cali_t'])}")
    if not meta["fsc"]["ema_batches"] > 0:
        raise AssertionError(f"the running-stat FSC pass did not run: "
                             f"{meta['fsc']}")
    return {"units": len(units), "kept_trained": kept,
            "layers_with_alpha": len(trained), "residency": res,
            "fsc": meta["fsc"]}


def drive_main_path(cfg, dev, tmp: Path, steps: int = STEPS) -> dict:
    """Calibrate the full-width model on the card through the port's CLI
    (reconstruction and running-stat FSC), then sample from that artifact
    through the CLI with the packed-int4 kernels; launch counts are read
    around that one call. Also writes, into ``tmp``, the artifacts of
    minmax grids and the FSC init pass of the deploy phase's CIFAR-10 runs
    (w4a8 with symmetric weight grids, and w8a8) and of an init-only w4a8
    for comparison, and keeps the FP samples. Returns counts, seconds,
    PSNRs and paths."""
    import numpy as np
    import torch
    from tfmq_dm_tpu_torch import cli
    from tfmq_dm_tpu_torch.convert import load_params
    from tfmq_dm_tpu_torch.models import ddim_unet, ddim_units
    from tfmq_dm_tpu_torch.quant.calibrate import cali_model
    from tfmq_dm_tpu_torch.samplers.ddim import harvest_trajectory

    tmp = tmp / "c10"
    tmp.mkdir()
    ckpt = ROOT / "runs" / "cifar10_ddpm.npz"
    art = str(tmp / "cali_w4a8_recon.npz")
    t0 = time.perf_counter()
    rc = cli.main(["--task", "cifar10", "--ckpt", str(ckpt), "--ptq",
                   "--cali", "--wq", "4", "--aq", "8", "--use_aq",
                   "--timesteps", str(CALI_STEPS), "--cali_n", str(CALI_N),
                   "--interval_length", "1", "--cali_iters",
                   str(CALI_ITERS), "--cali_save_path", art, "--seed",
                   str(SEED), "--device", dev.type])
    sync(dev)
    cali_s = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"cli.main --cali returned {rc}")
    print(f"   cli.main --ptq --cali (harvest {CALI_STEPS} steps x {CALI_N}, "
          f"reconstruction of every unit at {CALI_ITERS} iterations, "
          f"running-stat FSC): {cali_s:.2f} s", flush=True)
    recon = check_calibration(ddim_units.build_adapter(cfg, w_bits=4,
                                                       a_bits=8),
                              art, dev, n_units=32)

    t0 = time.perf_counter()
    params, _ = load_params(str(ckpt), device=dev)
    betas, seq = cli.cifar10_schedule(steps)
    x_cali = torch.randn((BATCH, 32, 32, 3),
                         generator=torch.Generator().manual_seed(1))
    xs, ts = harvest_trajectory(
        lambda x, t, s: ddim_unet.apply(params, cfg, x, t), betas, seq,
        x_cali.to(dev))
    # minmax grids and the FSC init pass only: w4a8 (for comparison), and
    # the deploy phase's bench configuration (w4a8, symmetric weight
    # grids) and w8a8
    arts = {}
    for name, wq, sym in (("w4a8_init", 4, False), ("bench", 4, True),
                          ("w8a8", 8, False)):
        arts[name] = str(tmp / f"cali_{name}.npz")
        cali_model(ddim_units.build_adapter(cfg, w_bits=wq, a_bits=8,
                                            w_sym=sym),
                   params, None, (xs, ts), hp=None, use_aq=True,
                   running_stat=False,
                   generator=torch.Generator().manual_seed(2),
                   path=arts[name], w_scaler="minmax",
                   act_scaler="minmax", init_samples=BATCH,
                   meta={"wq": wq, "aq": 8,
                         "cali_t": [float(v) for v in seq[::-1]]})
    sync(dev)
    print(f"   init-only calibrations (harvest {steps} steps x {BATCH}, "
          f"minmax grids and the FSC init pass of w4a8, w4a8 symmetric "
          f"and w8a8): {time.perf_counter() - t0:.2f} s", flush=True)
    del params, xs, ts

    common = ["--task", "cifar10", "--ckpt", str(ckpt), "--timesteps",
              str(steps), "-n", str(BATCH), "--batch", str(BATCH),
              "--seed", str(SEED), "--device", dev.type]
    quant = ["--ptq", "--cali_ckpt", art, "--use_aq", "--int-kernels",
             "--int4-serving"]
    reset_all_counts()
    t0 = time.perf_counter()
    rc = cli.main(common + quant + ["--out", str(tmp / "q")])
    sync(dev)
    e2e_s = time.perf_counter() - t0
    launches = all_counts()
    if rc != 0:
        raise RuntimeError(f"cli.main returned {rc}")
    print(f"   cli.main int4-serving sampling ({BATCH} images, {steps} "
          f"steps; load + deploy + sample): {e2e_s:.2f} s; launches "
          f"{launches}", flush=True)
    if dev.type == "cuda":
        need = {"int4_conv2d": 71 * steps, "int4_linear": 23 * steps}
        for name, n in need.items():
            if launches[name] < n:
                raise AssertionError(f"{name}: {launches[name]} "
                                     f"launches, expected >= {n}")
    q = np.load(tmp / "q" / "samples.npy")
    if q.shape != (BATCH, 32, 32, 3) or not np.all(np.isfinite(q)):
        raise AssertionError(f"bad samples: {q.shape}")
    if q.min() < 0 or q.max() > 1:
        raise AssertionError("samples outside [0, 1]")

    with plain_kernels():
        t0 = time.perf_counter()
        cli.main(common + quant + ["--out", str(tmp / "plain")])
        sync(dev)
        plain_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cli.main(common + ["--out", str(tmp / "fp")])
    sync(dev)
    fp_s = time.perf_counter() - t0
    cli.main(common + ["--ptq", "--cali_ckpt", arts["w4a8_init"],
                       "--use_aq", "--int-kernels", "--int4-serving",
                       "--out", str(tmp / "init")])
    plain = np.load(tmp / "plain" / "samples.npy")
    fp = np.load(tmp / "fp" / "samples.npy")
    init = np.load(tmp / "init" / "samples.npy")
    p_kp, p_qf = psnr(q, plain), psnr(q, fp)
    p_init = psnr(init, fp)
    print(f"   plain-version sampling {plain_s:.2f} s, FP sampling "
          f"{fp_s:.2f} s", flush=True)
    print(f"   PSNR kernels vs plain versions: {p_kp:.2f} dB; quantized "
          f"vs FP (information): {p_qf:.2f} dB from the reconstructed "
          f"artifact, {p_init:.2f} dB from minmax grids and the FSC init "
          "pass", flush=True)
    if not p_kp >= MIN_PSNR_KERNEL_VS_PLAIN_DB:
        raise AssertionError(f"kernel vs plain PSNR {p_kp:.2f} dB < "
                             f"{MIN_PSNR_KERNEL_VS_PLAIN_DB}")
    if dev.type == "cuda":
        profile_sampling(cfg, dev, common + quant + ["--out", "-"],
                         PROFILE_STEPS)
    return {"launches": launches, "e2e_s": e2e_s, "plain_s": plain_s,
            "fp_s": fp_s, "psnr_kernel_vs_plain": p_kp,
            "psnr_quant_vs_fp": p_qf, "psnr_init_only_vs_fp": p_init,
            "cali_s": cali_s, "recon": recon, "arts": arts,
            "ckpt": str(ckpt), "fp_img": fp, "art": art}


class InjectedCrash(RuntimeError):
    """The failure phase recon injects after a partial save."""


def _max_alpha_diff(a: dict, b: dict) -> float:
    """The largest |alpha| difference of two reconstructions (NaN
    propagates, and fails any limit)."""
    keys = {k for k, st in a.items() if "alpha" in st}
    if keys != {k for k, st in b.items() if "alpha" in st} or not keys:
        raise AssertionError("the runs trained different layers")
    return max(float((a[k]["alpha"] - b[k]["alpha"]).abs().max())
               for k in keys)


def drive_recon_path(cfg, dev, tmp: Path, main_path: dict) -> dict:
    """The rest of reconstruction at CIFAR-10 width (the trained weights;
    phase main's harvest, drawn again with its seed): (a) mid-unit resume
    under deterministic algorithms, a crash injected after a partial save
    inside a unit that is not the first, the resumed alphas held to an
    uninterrupted run's; the cost of one partial save at the largest
    unit; (b) the Fisher weights of one unit on the card against the CPU,
    their seconds on the card, and a fisher_diag reconstruction of the
    unit; (c) the act phase over every unit on one FSC group of phase
    main's artifact, its seconds per iteration, and the artifact with
    that group's trained deltas sampled through ``cli.main`` with the
    int4 kernels against the plain versions."""
    import dataclasses
    import warnings

    import numpy as np
    import torch
    from tfmq_dm_tpu_torch import cli
    from tfmq_dm_tpu_torch.configs.tasks import get_task
    from tfmq_dm_tpu_torch.convert import load_params
    from tfmq_dm_tpu_torch.models import ddim_unet, ddim_units
    from tfmq_dm_tpu_torch.pipelines import ptq
    from tfmq_dm_tpu_torch.quant import recon as R
    from tfmq_dm_tpu_torch.quant.artifact import save_artifact
    from tfmq_dm_tpu_torch.quant.calibrate import load_cali_model
    from tfmq_dm_tpu_torch.quant.fsc import slice_fsc

    tmp = tmp / "recon"
    tmp.mkdir()
    ckpt = main_path["ckpt"]
    task = get_task("cifar10")
    params, _ = load_params(ckpt, device=dev)
    adapter = ddim_units.build_adapter(cfg, w_bits=4, a_bits=8)
    _, a_cali, cali_t = ptq.generate_cali_data(
        task, lambda x, t, c: ddim_unet.apply(params, cfg, x, t),
        torch.Generator().manual_seed(SEED), n_per_t=CALI_N,
        steps=CALI_STEPS, device=dev)
    w_cali = tuple(x.reshape((-1,) + x.shape[2:]) for x in a_cali)
    wstate0 = R.init_weight_qparams(adapter.policy, params, scaler="minmax")
    seconds = {}
    print(f"   cuts: (a) {len(RESUME_UNITS)} of {len(adapter.units)} units "
          f"{RESUME_UNITS}, {RESUME_ITERS} iterations a unit (the task's "
          f"20000) in segments of {RESUME_SEG} (RESUME_SEG_ITERS "
          f"{R.RESUME_SEG_ITERS}); (b) {FISHER_UNIT}, card vs CPU on "
          f"{FISHER_CPU_ROWS} rows, timed on {w_cali[0].shape[0]}, "
          f"{FISHER_ITERS} iterations; (c) FSC group {ACT_GROUP} of "
          f"{CALI_STEPS}, {a_cali[0].shape[1]} rows, {ACT_ITERS} "
          "iterations a unit (the task's 20000), sampled in "
          f"{CALI_STEPS} steps", flush=True)

    # (a) mid-unit resume
    t0 = time.perf_counter()
    sub = dataclasses.replace(adapter, units=tuple(
        adapter.unit_by_name(n) for n in RESUME_UNITS))
    hp = R.ReconHP(iters=RESUME_ITERS, batch_size=task.recon_batch)

    def run(d):
        return R.reconstruct(sub, params, w_cali, dict(wstate0), hp,
                             torch.Generator().manual_seed(SEED),
                             capture_batch_size=64, resume_dir=str(d))

    seg, save = R.RESUME_SEG_ITERS, R._save_partial
    saves = [0]

    def bomb(*a, **k):
        save(*a, **k)
        saves[0] += 1
        if saves[0] == RESUME_CRASH:
            raise InjectedCrash(f"injected after partial save {saves[0]}")

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        R.RESUME_SEG_ITERS = RESUME_SEG
        try:
            first, second = run(tmp / "a1"), run(tmp / "a2")
            R._save_partial = bomb
            try:
                run(tmp / "a3")
            except InjectedCrash as e:
                print(f"   (a) {e}", flush=True)
            else:
                raise AssertionError("the injected failure did not fire")
            finally:
                R._save_partial = save
            partial = sorted((tmp / "a3").glob("*.partial"))
            if len(partial) != 1:
                raise AssertionError(f"partial files {partial}")
            with np.load(partial[0]) as z:
                it0 = int(z["__it0"])
            at = partial[0].name.removesuffix(".npz.partial")
            print(f"   (a) resuming {at} (unit "
                  f"{RESUME_UNITS.index(at) + 1} of {len(RESUME_UNITS)}) "
                  f"at iteration {it0} of {RESUME_ITERS}", flush=True)
            if at == RESUME_UNITS[0] or not 0 < it0 < RESUME_ITERS:
                raise AssertionError("the failure did not land inside a "
                                     "unit after the first")
            resumed = run(tmp / "a3")
        finally:
            R.RESUME_SEG_ITERS = seg
            torch.use_deterministic_algorithms(False)
    left = sorted(p.name for p in (tmp / "a3").glob("*.partial"))
    nondet = sorted({str(w.message).splitlines()[0] for w in caught
                     if "determinis" in str(w.message)})
    d_runs = _max_alpha_diff(first, second)
    d_res = _max_alpha_diff(first, resumed)
    print(f"   (a) max |alpha| difference: resumed vs uninterrupted "
          f"{d_res:.3g}, two uninterrupted runs {d_runs:.3g}; ops without "
          f"a deterministic algorithm: {nondet or 'none'}; partial files "
          f"left {left or 'none'}", flush=True)
    if left:
        raise AssertionError(f"partial files left: {left}")
    if not d_res <= (2 * d_runs if nondet else 0.0):
        raise AssertionError(f"resumed alphas differ by {d_res} (two "
                             f"uninterrupted runs: {d_runs})")
    big = max((u for u in adapter.units if adapter.default_train_roles(u)),
              key=lambda u: sum(params[f]["w"].numel() for r, f in u.layers
                                if r in adapter.default_train_roles(u)))
    alphas = {r: torch.zeros_like(params[f]["w"]) for r, f in big.layers
              if r in adapter.default_train_roles(big)}
    moments = tuple({r: torch.zeros_like(a) for r, a in alphas.items()}
                    for _ in range(2))
    path = str(tmp / "big.npz.partial")
    save_s = []
    for _ in range(3):
        sync(dev)
        t1 = time.perf_counter()
        R._save_partial(path, alphas, moments, 10000,
                        torch.zeros(10000, device=dev))
        save_s.append(time.perf_counter() - t1)
    save_s = sorted(save_s)[1]
    print(f"   (a) one _save_partial at the largest unit, {big.name} "
          f"({sum(a.numel() for a in alphas.values())} alphas, "
          f"{os.path.getsize(path) / 2 ** 20:.1f} MiB): {save_s:.4f} s "
          "(median of 3)", flush=True)
    seconds["resume"] = time.perf_counter() - t0

    # (b) Fisher
    t0 = time.perf_counter()
    unit = adapter.unit_by_name(FISHER_UNIT)
    rows = tuple(x[:FISHER_CPU_ROWS] for x in w_cali)
    cpu = torch.device("cpu")
    cpu_params = load_params(ckpt, device=cpu)[0]
    cpu_rows = tuple(x.cpu() for x in rows)
    cpu_w = {k: {f: v.cpu() for f, v in st.items()}
             for k, st in wstate0.items()}
    got = R.capture_unit_grads(adapter, unit, params, rows, wstate0,
                               batch_size=FISHER_CPU_ROWS).cpu()
    ref = R.capture_unit_grads(adapter, unit, cpu_params, cpu_rows, cpu_w,
                               batch_size=FISHER_CPU_ROWS)
    # |g| + 1 keeps only the top bits of a small gradient: the gradient
    # itself is held too
    g_card = R._grad_batch(adapter, FISHER_UNIT, False, params,
                           R.wstate_upto(adapter, unit, wstate0), {},
                           rows).cpu()
    g_cpu = R._grad_batch(adapter, FISHER_UNIT, False, cpu_params,
                          R.wstate_upto(adapter, unit, cpu_w), {}, cpu_rows)
    err = float((g_card - g_cpu).abs().max())
    scale = float(g_cpu.abs().max())
    w_err = float((got - ref).abs().max())
    print(f"   (b) Fisher gradient of {FISHER_UNIT}, card vs CPU: max "
          f"|difference| {err:.3g} against a largest |gradient| of "
          f"{scale:.3g} (limit {FISHER_REL} of it); the weights |g| + 1 "
          f"{w_err:.3g} apart (limit 2^-22)", flush=True)
    if not (err <= FISHER_REL * scale and w_err <= 2 ** -22):
        raise AssertionError(f"Fisher gradient card vs CPU: {err}, "
                             f"weights {w_err}")
    sync(dev)
    t1 = time.perf_counter()
    fgrads = R.capture_unit_grads(adapter, unit, params, w_cali, wstate0)
    sync(dev)
    fisher_s = time.perf_counter() - t1
    print(f"   (b) capture_unit_grads of {FISHER_UNIT}: {fisher_s:.3f} s for "
          f"{w_cali[0].shape[0]} rows at batch 32 (a full forward and "
          "backward a batch)", flush=True)
    inputs, outputs = R.capture_unit_io(adapter, unit, params, w_cali,
                                        wstate0, batch_size=64)
    stats = {}
    _, losses = R.reconstruct_unit(
        adapter, unit, params, wstate0, inputs, outputs,
        R.ReconHP(iters=FISHER_ITERS, batch_size=task.recon_batch,
                  rloss="fisher_diag"),
        torch.Generator().manual_seed(SEED), fgrads, stats=stats)
    del inputs, outputs, fgrads
    ls = losses.cpu().numpy()
    fisher_guard = stats[FISHER_UNIT]
    print(f"   (b) fisher_diag reconstruction of {FISHER_UNIT}: loss "
          f"{ls[:10].mean():.6g} (first 10) -> {ls[-10:].mean():.6g} (last "
          f"10); guard {fisher_guard}", flush=True)
    if not (np.isfinite(ls).all() and ls[-10:].mean() < ls[:10].mean()):
        raise AssertionError("the fisher_diag losses did not fall")
    seconds["fisher"] = time.perf_counter() - t0

    # (c) the act phase
    t0 = time.perf_counter()
    wstate, batched, meta = load_cali_model(main_path["art"], device=dev)
    if [float(v) for v in cali_t] != meta["cali_t"]:
        raise AssertionError("phase main's groups are not this harvest's")
    ast = slice_fsc(batched, ACT_GROUP)
    data = (a_cali[0][ACT_GROUP], a_cali[1][ACT_GROUP])
    hp = R.ReconHP(iters=ACT_ITERS, batch_size=task.recon_batch)
    stats = {}
    new = R.reconstruct_act(adapter, params, data, wstate, ast, hp,
                            torch.Generator().manual_seed(SEED),
                            capture_batch_size=64, stats=stats)
    sync(dev)
    act_s = time.perf_counter() - t0
    moved = sum(not torch.equal(new[k]["delta"], ast[k]["delta"])
                for k in ast)
    kept = sum(r["kept"] == "trained" for r in stats.values())
    print(f"   (c) reconstruct_act over {len(stats)} units "
          f"({ACT_ITERS} iterations each): {act_s:.2f} s; guard kept the "
          f"trained deltas of {kept} units, reverted {len(stats) - kept}; "
          f"{moved} of {len(ast)} deltas moved", flush=True)
    if set(new) != set(ast) or any(
            not torch.equal(new[k]["zp"], ast[k]["zp"]) for k in ast):
        raise AssertionError("the act phase lost a site or moved a zero "
                             "point")
    if moved == 0:
        raise AssertionError("the act phase moved no delta")
    # seconds per iteration under the CUDA graph: two lengths of one
    # unit's loop, the difference over the extra iterations
    unit = adapter.unit_by_name(FISHER_UNIT)
    inputs, outputs = R.capture_unit_io(adapter, unit, params, data, wstate,
                                        ast, use_aq=True, batch_size=64)
    roles = [(r, f) for r, f in tuple(unit.layers) + tuple(unit.act_sites)
             if f in ast]
    n = data[0].shape[0]
    times = []
    for iters in (ACT_TIME_ITERS, 3 * ACT_TIME_ITERS):
        idx = R.draw_indices(torch.Generator().manual_seed(0), n,
                             min(task.recon_batch, n), iters).to(dev)
        sync(dev)
        t1 = time.perf_counter()
        R._act_run(adapter.unit_fwd, unit.kind,
                   adapter.role_cfgs(unit, frozenset()), unit.extra,
                   dataclasses.replace(hp, iters=iters),
                   adapter.extract_uparams(params, unit),
                   {r: wstate[f] for r, f in unit.layers if f in wstate},
                   {r: ast[f]["zp"] for r, f in roles},
                   {r: ast[f]["delta"] for r, f in roles}, inputs, outputs,
                   idx)
        sync(dev)
        times.append(time.perf_counter() - t1)
    per_iter_ms = (times[1] - times[0]) / (2 * ACT_TIME_ITERS) * 1e3
    print(f"   (c) act phase of {FISHER_UNIT}, {n} rows a minibatch of "
          f"{min(task.recon_batch, n)}: {per_iter_ms:.3f} ms an iteration "
          f"under its CUDA graph ({ACT_TIME_ITERS} and "
          f"{3 * ACT_TIME_ITERS} iterations: {times[0]:.3f} / "
          f"{times[1]:.3f} s)", flush=True)
    del inputs, outputs
    for site, st in new.items():
        batched[site]["delta"][ACT_GROUP] = st["delta"]
    art = str(tmp / "cali_act.npz")
    save_artifact(art, wstate, batched, meta)
    common = ["--task", "cifar10", "--ckpt", ckpt, "--timesteps",
              str(CALI_STEPS), "-n", str(BATCH), "--batch", str(BATCH),
              "--seed", str(SEED), "--device", dev.type, "--ptq",
              "--cali_ckpt", art, "--use_aq", "--int-kernels",
              "--int4-serving"]
    reset_all_counts()
    if cli.main(common + ["--out", str(tmp / "q")]) != 0:
        raise RuntimeError("cli.main returned non-zero")
    launches = {k: v for k, v in all_counts().items() if v}
    with plain_kernels():
        cli.main(common + ["--out", str(tmp / "plain")])
    q = np.load(tmp / "q" / "samples.npy")
    p_kp = psnr(q, np.load(tmp / "plain" / "samples.npy"))
    print(f"   (c) cli.main int4-serving from the artifact with group "
          f"{ACT_GROUP}'s trained deltas ({BATCH} images, {CALI_STEPS} "
          f"steps): PSNR kernels vs plain versions {p_kp:.2f} dB; launches "
          f"{launches}", flush=True)
    if not (np.isfinite(q).all() and p_kp >= MIN_PSNR_KERNEL_VS_PLAIN_DB):
        raise AssertionError(f"act-phase artifact: kernel vs plain PSNR "
                             f"{p_kp:.2f} dB")
    for name in ("int4_conv2d", "int4_linear"):
        if dev.type == "cuda" and not launches.get(name):
            raise AssertionError(f"{name} did not launch")
    seconds["act"] = time.perf_counter() - t0
    print("   seconds: " + ", ".join(f"{k} {v:.2f}"
                                     for k, v in seconds.items()),
          flush=True)
    return {"seconds": seconds, "resume": {
        "unit": at, "it0": it0,
        "max_alpha_diff_resumed": d_res, "max_alpha_diff_runs": d_runs,
        "nondeterministic": nondet, "save_partial_s": save_s,
        "save_partial_unit": big.name},
        "fisher": {"max_abs_err": err, "max_grad": scale,
                   "weights_max_abs_err": w_err,
                   "capture_s": fisher_s, "rows": int(w_cali[0].shape[0]),
                   "guard": fisher_guard},
        "act": {"units": len(stats), "kept_trained": kept,
                "deltas_moved": moved, "ms_per_iter": per_iter_ms,
                "s": act_s, "psnr_kernel_vs_plain_db": p_kp,
                "launches": launches}}


def cin_geometries(cfg):
    """Distinct (res, k, cin, cout) of the packed convs and (m_per_batch
    row, k, n) of the packed linears on the cin256 int4-serving path;
    ``m`` is the tokens per image (1 for the embedding projections)."""
    from tfmq_dm_tpu_torch.models import ldm_unet
    inputs, middle, outputs = ldm_unet.build_structure(cfg)
    convs, linears = set(), set()
    ted = cfg.time_embed_dim
    linears.add((1, ted, ted))
    res = cfg.image_size
    for group in list(inputs) + [middle] + list(outputs):
        for s in group:
            if s.kind == "res":
                convs |= {(res, 3, s.c_in, s.c_out),
                          (res, 3, s.c_out, s.c_out)}
                linears.add((1, ted, s.c_out))
            elif s.kind == "strans":
                inner = s.heads * s.d_head
                convs |= {(res, 1, s.c_in, inner), (res, 1, inner, s.c_in)}
                linears |= {(res * res, inner, inner),
                            (res * res, inner, 8 * inner),
                            (res * res, 4 * inner, inner),
                            (1, cfg.context_dim, inner)}
            elif s.kind == "down":
                res //= 2
            elif s.kind == "up":
                res *= 2
                convs.add((res, 3, s.c_in, s.c_out))
    return sorted(convs), sorted(linears)


def cin_conv_counts(cfg) -> dict:
    """Launches per UNet forward of each packed-conv geometry (res, k, cin,
    cout) of ``cin_geometries``: the quantized convs of ``iter_layers``."""
    from tfmq_dm_tpu_torch.models import ldm_unet
    from tfmq_dm_tpu_torch.quant.policy import build_policy
    pol = build_policy(ldm_unet.layer_infos(cfg))
    quantized = {n for n in pol.weight_layers() if pol.get(n).wq}
    counts = {}
    for kind, name, shape, res in ldm_unet.iter_layers_with_res(cfg):
        if kind == "conv" and name in quantized:
            key = (res, shape[0], shape[2], shape[3])
            counts[key] = counts.get(key, 0) + 1
    return counts


def conv_geometry_cases(paths) -> list:
    """(path, batch, res, k, cin, cout, launches per forward) of every
    distinct packed conv of the int4-serving paths, ``paths`` a list of
    (path, batch, {(res, k, cin, cout): launches per forward}): CIFAR-10
    at batch 8, cin256 at batch 2 x CFG, SD v1.4 at batch 1 x CFG, and
    the unconditional paths of phase uncond at batch 2."""
    return [(path, b, *key, c) for path, b, counts in paths
            for key, c in sorted(counts.items())]


def linear_counts(cfg) -> dict:
    """{(m, k, n): launches per forward} of the packed linears of an LDM
    UNet (AttentionBlocks' qkv and proj_out included), ``m`` the rows a
    batch row feeds (tokens, or 1 for the embedding projections), a walk
    of ``iter_layers``; the cross-attention K/V projections of the
    constant context are left out (they run once a rollout, the K/V
    cache)."""
    from tfmq_dm_tpu_torch.models import ldm_unet
    from tfmq_dm_tpu_torch.quant.policy import build_policy
    pol = build_policy(ldm_unet.layer_infos(cfg))
    quantized = {n for n in pol.weight_layers() if pol.get(n).wq}
    counts = {}
    for kind, name, shape, res in ldm_unet.iter_layers_with_res(cfg):
        if not (kind.startswith("linear") or kind == "conv1d") or \
                name not in quantized or \
                ".attn2.to_k" in name or ".attn2.to_v" in name:
            continue
        m = 1 if name.startswith("time_embed") or "emb_layers" in name \
            else res * res
        key = (m, shape[0], shape[1])
        counts[key] = counts.get(key, 0) + 1
    return counts


def time_linear_geometries(g, dev, peaks, path: str, batch: int,
                           counts: dict) -> tuple:
    """``int4_linear`` at every geometry of a path (``counts``: {(m, k, n):
    launches per forward}, ``m`` the rows a batch row feeds) -> (rows,
    the launch-weighted sums per forward)."""
    rows = []
    for (m, k, n), per_fwd in sorted(counts.items()):
        t = time_linear(linear_case(g, batch * m, k, n, dev), peaks)
        rows.append({"shape": [batch * m, k, n],
                     "launches_per_forward": per_fwd, **t})
        print(f"   int4_linear {path} M{batch * m} {k}->{n} x{per_fwd}: "
              + timing_line(t), flush=True)
    per = {key: sum(x[key] * x["launches_per_forward"] for x in rows)
           for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    print(f"   int4_linear {path} per forward "
          f"({sum(x['launches_per_forward'] for x in rows)} launches"
          + (", the K/V cache's once a rollout left out"
             if path == "sd" or path in TEXT_TASKS else "") + "): "
          + ", ".join(f"{k} {v:.4f}" for k, v in per.items()), flush=True)
    return rows, per


def time_conv_geometries(g, dev, peaks, cases) -> list:
    """``int4_conv2d``, its plain version and cuDNN's bf16 conv (weights
    dequantized ahead of time) at every conv geometry of the int4-serving
    paths, device ms per call beside the bound and the launches per
    forward; then the launch-weighted sums per forward of each path."""
    import torch
    import torch.nn.functional as F
    from tfmq_dm_tpu_torch.ops import int4_kernels as K
    rows = []
    for path, b, r, k, ci, co, per_fwd in cases:
        case = conv_case(g, b, r, k, ci, co, dev)
        x, wp, d, z, kh, kw, bias, pad = case
        wd = ((K.unpack_int4(wp, co).float() - z) * d).to(torch.bfloat16)
        wd = wd.reshape(kh, kw, ci, co).permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        xn, bd, p = x.permute(0, 3, 1, 2), bias.to(torch.bfloat16), kh // 2
        flops = 2 * b * r * r * co * kh * kw * ci
        nbytes = x.numel() * 2 + wp.numel() + 3 * co * 4 + b * r * r * co * 4
        t_ops, t_bytes = flops / peaks["bf16"] * 1e3, nbytes / peaks["hbm"] \
            * 1e3
        row = {"path": path, "shape": [b, r, k, ci, co],
               "launches_per_forward": per_fwd,
               "plan": list(K.conv_plan(b * r * r, co, k * k, ci)),
               "ms": device_ms(lambda: K.int4_conv2d(*case)),
               "plain_ms": device_ms(lambda: K.int4_conv2d_plain(*case)),
               "library_ms": device_ms(lambda: F.conv2d(xn, wd, bd,
                                                        padding=p)),
               "bound_ms": max(t_ops, t_bytes),
               "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
        e = EARLIER_MS.get(("int4_conv2d", b, r, k, ci, co))
        rows.append(row)
        print(f"   int4_conv2d {path} b{b} {r}x{r} {k}x{k} {ci}->{co} "
              f"x{per_fwd}: {row['ms']:.4f} / plain {row['plain_ms']:.4f}"
              f" / cuDNN {row['library_ms']:.4f}"
              f"; bound {row['bound_ms']:.6f} ({row['bound_by']}); plan "
              f"{row['plan']}" + ("" if e is None else
                                  f"; earlier design {e:.4f} "
                                  f"({e / row['ms']:.2f}x this)"),
              flush=True)
        del case, x, wp, wd, xn
    for path in dict.fromkeys(x["path"] for x in rows):
        sel = [x for x in rows if x["path"] == path]

        def wsum(key, sel=sel):
            return sum(x[key] * x["launches_per_forward"] for x in sel)
        line = (f"   int4_conv2d {path} per forward "
                f"({sum(x['launches_per_forward'] for x in sel)} launches):"
                f" kernel {wsum('ms'):.4f} ms, plain {wsum('plain_ms'):.4f}"
                f", cuDNN {wsum('library_ms'):.4f}, bound "
                f"{wsum('bound_ms'):.4f}")
        earlier = [EARLIER_MS.get(("int4_conv2d", *x["shape"])) for x in sel]
        if None not in earlier:      # for reading only, not in the report
            line += ", earlier design " + format(sum(
                e * x["launches_per_forward"]
                for e, x in zip(earlier, sel)), ".4f")
        print(line, flush=True)
    torch.cuda.empty_cache()
    return rows


def check_conv_counts(rows, measured) -> None:
    """Hold the launches per forward that ``time_conv_geometries`` weighs
    by (a walk of each model's layers) against those the int4-serving
    runs counted: ``measured`` maps a path to (launches, forwards)."""
    for path, (n, forwards) in measured.items():
        walked = sum(x["launches_per_forward"] for x in rows
                     if x["path"] == path)
        if n != walked * forwards:
            raise AssertionError(
                f"int4_conv2d {path}: {n} launches in {forwards} forwards, "
                f"but the geometry walk counts {walked} per forward")
        print(f"   int4_conv2d {path}: {n} launches in {forwards} forwards "
              f"= {walked} per forward, as the geometry walk counts",
              flush=True)


def check_one_level(label, got, ref, level, errors):
    """The one-level rule for kernels with a softmax quantizer."""
    import torch
    torch.cuda.synchronize()
    diff = (got - ref).abs()
    share = float((diff > 1e-5).float().mean())
    err = float(diff.max())
    print(f"   {label:48s} max_abs_err {err:.3e}  share>1e-5 {share:.2e}  "
          f"(level {level:.3e})", flush=True)
    if not (share < ONE_LEVEL_SHARE and err <= ONE_LEVEL_MAX * level):
        raise AssertionError(f"{label}: kernel disagrees with its plain "
                             f"version beyond one level ({share:.3e} of "
                             f"outputs, max {err:.3e})")
    errors.append(err)


# (label, B*H, Tq, Tk, D): cin256 at batch 2 x CFG; SD v1.4 (8 heads) at
# its 64x64, 32x32 and 16x16 latents; ragged T; Tk != Tq; the 32x32
# AttentionBlocks of phase uncond at batch 2: LSUN-Churches (8 heads of
# 24) and the LDM-4 UNet (14 heads of 32)
FLASH_SHAPES = [("cin256", 4, 1024, 1024, 384),
                ("sd 64x64", 16, 4096, 4096, 40),
                ("txt2img 32x32", 16, 1024, 1024, 40),
                ("sd 32x32", 16, 1024, 1024, 80),
                ("sd 16x16", 16, 256, 256, 160),
                ("ragged", 4, 100, 100, 40), ("ragged", 4, 130, 130, 40),
                ("tk != tq", 2, 130, 77, 64),
                ("churches 32x32", 2 * 8, 1024, 1024, 24),
                ("ldm4 32x32", 2 * 14, 1024, 1024, 32),
                ("text256 32x32", 2 * 12, 1024, 1024, 32)]
# the flash_int8 / flash_fp shape of each path of phases uncond and text,
# all at key length 1024 (txt2img_1p4b: 1 x CFG, 8 heads of D 40;
# text2img_256: 1 x CFG, 12 heads of D 32)
UNCOND_FLASH = {"lsun_churches256": "churches 32x32",
                "lsun_beds256": "ldm4 32x32"}
PATH_FLASH = {**UNCOND_FLASH, "txt2img_1p4b": "txt2img 32x32",
              "text2img_256": "text256 32x32"}
INT8_GRIDS = ((0.031, 130.0), (0.029, 120.0), (0.033, 125.0))
P_GRIDS = ((1 / 255.0, 0.0), (0.004, 3.0))
# the 16-bit softmax grid (--softmax_a_bit 16, always zero): levels up to
# 65535, and one with a non-zero zero point
P16_GRID, P16_GRID_ZP = (1 / 65535.0, 0.0), (1.5e-5, 3.0)


def flash_case(g, bh, tq, tk, d, dev):
    import torch
    return [torch.randn(bh, t, d, generator=g).to(dev) for t in (tq, tk, tk)]


def int8_case(q, k, v, pw, dev):
    import torch
    from tfmq_dm_tpu_torch.ops import flash_attention as FA
    qkv = tuple(tuple(torch.tensor(a, device=dev) for a in p)
                for p in INT8_GRIDS)
    ops = FA.int8_operands(q, k, v, qkv, ((0, 255),) * 3)
    dw, zw = pw if pw is not None else (1.0, 0.0)
    sc = torch.tensor([a for p in INT8_GRIDS for a in p] + [dw, zw],
                      device=dev)
    return ops, sc


def check_flash(g, dev, errs) -> None:
    import torch
    from tfmq_dm_tpu_torch.ops import flash_attention as FA
    for label, bh, tq, tk, d in FLASH_SHAPES:
        q, k, v = flash_case(g, bh, tq, tk, d, dev)
        sm = d ** -0.5
        tag = f"{label} bh{bh} {tq}x{tk} d{d}"
        check_close(f"flash_fp {tag}", FA.flash_fp(q, k, v, sm),
                    FA.flash_fp_plain(q, k, v, sm), errs["flash_fp"])
        for dz in P_GRIDS:
            dzt = torch.tensor(dz, device=dev)
            zz = dz[1] == 0.0
            check_one_level(
                f"flash_pquant zp {dz[1]:g} {tag}",
                FA.flash_pquant(q, k, v, sm, dzt, (0, 255), zz),
                FA.flash_pquant_plain(q, k, v, sm, dzt, (0, 255), zz),
                dz[0], errs["flash_pquant"])
        for pw in (None, P_GRIDS[0]):
            ops, sc = int8_case(q, k, v, pw, dev)
            qr = None if pw is None else (0, 255)
            got = FA.flash_int8(*ops, sc, sm, qr)
            ref = FA.flash_int8_plain(*ops, sc, sm, qr)
            if pw is None:
                check_close(f"flash_int8 {tag}", got, ref, errs["flash_int8"])
            else:
                check_one_level(f"flash_int8 p-quant {tag}", got, ref,
                                pw[0], errs["flash_int8"])
                if not torch.equal(got, FA.flash_int8(*ops, sc, sm, qr)):
                    raise AssertionError(f"flash_int8 p-quant {tag}: two "
                                         "calls differ")
        del q, k, v
        torch.cuda.empty_cache()


def check_pquant16(g, dev, errs) -> None:
    """``flash_pquant`` at the 16-bit softmax grid (the cin256
    ``--softmax_a_bit 16`` path's) at cin256 and SD's 64x64, zp_zero and a
    non-zero zero point. A level there is 1/65535, so a one-level flip
    moves an output by more than 1e-5, and the plain version's own f32
    arithmetic flips levels against the same function in float64. So the
    share is taken against the float64 plain version: the kernel's share
    of outputs off by more than 1e-5 at most the larger of the one-level
    rule's and twice the f32 plain version's (measured here); none more
    than 6 levels off the f32 plain version. The one-level rule's share
    against the f32 plain version is printed beside it."""
    import torch
    from tfmq_dm_tpu_torch.ops import flash_attention as FA
    for label, bh, tq, tk, d in (FLASH_SHAPES[0], FLASH_SHAPES[1]):
        q, k, v = flash_case(g, bh, tq, tk, d, dev)
        sm = d ** -0.5
        for dz_ in (P16_GRID, P16_GRID_ZP):
            dz = torch.tensor(dz_, device=dev)
            zz = dz_[1] == 0.0
            args = (sm, dz, (0, 65535), zz)
            got = FA.flash_pquant(q, k, v, *args)
            ref = FA.flash_pquant_plain(q, k, v, *args)
            exact = FA.flash_pquant_plain(q.double(), k.double(), v.double(),
                                          sm, dz.double(), (0, 65535),
                                          zz).float()
            torch.cuda.synchronize()

            def share(a, b):
                return float(((a - b).abs() > 1e-5).float().mean())

            noise, off = share(ref, exact), share(got, exact)
            err = float((got - ref).abs().max())
            lim = max(ONE_LEVEL_SHARE, 2.0 * noise)
            name = f"flash_pquant 16-bit zp {dz_[1]:g} {label} bh{bh} d{d}"
            print(f"   {name:48s} max_abs_err {err:.3e}  share>1e-5 vs "
                  f"f64 {off:.2e} (limit {lim:.2e}; f32 plain vs f64 "
                  f"{noise:.2e}; vs f32 plain {share(got, ref):.2e})  "
                  f"(level {dz_[0]:.3e})", flush=True)
            if not (off <= lim and err <= ONE_LEVEL_MAX * dz_[0]):
                raise AssertionError(f"{name}: kernel disagrees with its "
                                     "plain version")
            errs["flash_pquant"].append(err)
            del got, ref, exact
        del q, k, v
        torch.cuda.empty_cache()


def sdpa_backend(q, k, v) -> str:
    """The backend PyTorch's dispatcher picks for these bf16 inputs."""
    import torch
    from torch.nn.attention import SDPBackend
    names = {int(v): k for k, v in SDPBackend.__members__.items()}
    idx = int(torch._fused_sdp_choice(q, k, v))
    return names.get(idx, f"backend {idx}")


def time_flash(g, dev, peaks) -> dict:
    """Each flash kernel at the cin256 shape (B*H 4, T 1024, D 384), at
    SD's 64x64 (B*H 16, T 4096, D 40) and 32x32 (B*H 16, T 1024, D 80,
    the head dim padded to 96), at the 32x32 AttentionBlocks of
    LSUN-Churches (B*H 16, T 1024, D 24) and the LDM-4 UNet (B*H 28, T
    1024, D 32), and at the text2img tasks' 32x32 (txt2img_1p4b: B*H 16,
    T 1024, D 40; text2img_256: B*H 24, T 1024, D 32): the kernel, its
    plain version and
    ``scaled_dot_product_attention`` on bf16 q/k/v of the same shape
    (dequantized for int8), timed only; for the f32 kernels also SDPA on
    the f32 operands (``library_f32_ms``: the same function at the
    kernels' precision, TF32 off by ``exact_f32``). The f32 kernels' bound
    is one S and one P @ V at the TF32 tensor rate (or their bytes);
    ``flash_int8``'s S at the int8 rate and its P @ V at the int8 rate
    with the softmax quantizer, else at the TF32 rate. ``flash_pquant``
    at the 8- and 16-bit grids (the latter the cin256 ``--softmax_a_bit
    16`` path's), ``flash_int8`` with the 8-bit softmax quantizer (the
    cin256 int4-serving path's) and without. Returns {name: timings of
    the cin256 row, with the other shapes and modes under "grids"}."""
    import torch
    import torch.nn.functional as F
    from tfmq_dm_tpu_torch.ops import flash_attention as FA
    rows = {}
    for label, bh, t, _, d in (FLASH_SHAPES[0], FLASH_SHAPES[1],
                               FLASH_SHAPES[2], FLASH_SHAPES[3],
                               FLASH_SHAPES[8], FLASH_SHAPES[9],
                               FLASH_SHAPES[10]):
        q, k, v = flash_case(g, bh, t, t, d, dev)
        sm = d ** -0.5
        qb, kb, vb = (x.to(torch.bfloat16)[:, None] for x in (q, k, v))
        q4, k4, v4 = (x[:, None] for x in (q, k, v))
        products = 2 * bh * t * t * d
        f32_bytes = 4 * 4 * bh * t * d
        backend = sdpa_backend(qb, kb, vb)

        def lib(qb=qb, kb=kb, vb=vb, sm=sm):
            return F.scaled_dot_product_attention(qb, kb, vb, scale=sm)

        lib_f32 = device_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, scale=sm))
        f32_lib = (f"scaled_dot_product_attention bf16 ({backend}); f32 "
                   f"({sdpa_backend(q4, k4, v4)}, TF32 off)")

        def add(name, mode, tm, library):
            tm["shape"] = f"(B*H {bh}, T {t}, D {d}), {mode}"
            tm["library"] = library
            rows[(name, label, mode)] = tm
            f32_note = "" if "library_f32_ms" not in tm else \
                f"; f32 SDPA {tm['library_f32_ms']:.4f}"
            print(f"   {name} {label} bh{bh} T{t} d{d} {mode}: "
                  + timing_line(tm) + f32_note
                  + earlier_note(tm, (name, label, mode)), flush=True)

        tm = timings(lambda: FA.flash_fp(q, k, v, sm),
                     lambda: FA.flash_fp_plain(q, k, v, sm), lib,
                     2 * products, f32_bytes, peaks, rate="tf32")
        tm["library_f32_ms"] = lib_f32
        add("flash_fp", "f32", tm, f32_lib)
        for bits, dz_, qr in ((8, P_GRIDS[0], (0, 255)),
                              (16, P16_GRID, (0, 65535))):
            args = (q, k, v, sm, torch.tensor(dz_, device=dev), qr, True)
            tm = timings(lambda: FA.flash_pquant(*args),
                         lambda: FA.flash_pquant_plain(*args), lib,
                         2 * products, f32_bytes + 8, peaks, rate="tf32")
            tm["library_f32_ms"] = lib_f32
            add("flash_pquant", f"f32, {bits}-bit grid", tm, f32_lib)
        i8_bytes = 3 * bh * t * d + 4 * (2 * bh * t + bh * d + 8) \
            + 4 * bh * t * d
        for pw, mode in ((P_GRIDS[0], "8-bit p"), (None, "no p")):
            ops, sc = int8_case(q, k, v, pw, dev)
            qr = None if pw is None else (0, 255)
            deq = [((x.float() + 128.0 - z) * dl).to(torch.bfloat16)[:, None]
                   for x, (dl, z) in zip(ops[:3], INT8_GRIDS)]
            flops = {"int8": 2 * products} if pw is not None else \
                {"int8": products, "tf32": products}
            tm = timings(lambda: FA.flash_int8(*ops, sc, sm, qr),
                         lambda: FA.flash_int8_plain(*ops, sc, sm, qr),
                         lambda: F.scaled_dot_product_attention(*deq,
                                                                scale=sm),
                         flops, i8_bytes, peaks)
            add("flash_int8", mode, tm,
                f"scaled_dot_product_attention bf16 ({backend}) on the "
                "dequantized q/k/v")
            del ops, deq
        del q, k, v, qb, kb, vb, q4, k4, v4
        torch.cuda.empty_cache()
    out = {}
    for name, head in (("flash_fp", "f32"),
                       ("flash_pquant", "f32, 8-bit grid"),
                       ("flash_int8", "8-bit p")):
        out[name] = dict(rows[(name, "cin256", head)])
        out[name]["grids"] = {f"{lb} {mode}": tm for (n, lb, mode), tm
                              in rows.items() if n == name and
                              (lb, mode) != ("cin256", head)}
    return out


def latent_psnr(a, ref) -> float:
    """PSNR of latents against the reference's largest magnitude."""
    import numpy as np
    peak = float(np.abs(ref).max())
    mse = float(np.mean((np.asarray(a, np.float64) - ref) ** 2))
    return math.inf if mse == 0 else 10 * math.log10(peak ** 2 / mse)


def make_ldm_checkpoint(path: str, task, dev, n_classes: int = 0,
                        seed: int = 0, ema: bool = False) -> None:
    """A seeded random-init checkpoint of an LDM task in the reference's
    Lightning layout, through the port's export: UNet, first stage (VQ
    decoder with codebook, or KL decoder), and the class embedding
    (cin256_v2: 1001 x 512) or the text tower (SD v1.4: CLIP ViT-L/14;
    the LDM text2img tasks: BERT; under ``cond_stage_model.transformer.``)
    where the task is conditioned. ``ema``: LitEma weights under
    ``model_ema.`` (names without their dots, ldm/modules/ema.py), a
    second random init, so that the loader's swap changes the weights it
    returns."""
    import torch
    from tfmq_dm_tpu_torch.configs.tasks import text_encoder
    from tfmq_dm_tpu_torch.models import ldm_unet, vae
    from tfmq_dm_tpu_torch.utils.torch_convert import export_state_dict
    g = torch.Generator(device=dev).manual_seed(seed)
    sd = {}
    up = ldm_unet.init_params(g, task.unet)
    sd.update({f"model.diffusion_model.{k}": v for k, v in
               export_state_dict(up, ldm_unet.iter_layers(task.unet))
               .items()})
    del up
    vp = vae.init_params(g, task.vae)
    sd.update({f"first_stage_model.{k}": v for k, v in
               export_state_dict(vp, vae.iter_layers(task.vae)).items()})
    if ema:
        ep = ldm_unet.init_params(g, task.unet)
        sd.update({"model_ema." + f"diffusion_model.{k}".replace(".", ""): v
                   for k, v in export_state_dict(
                       ep, ldm_unet.iter_layers(task.unet)).items()})
        sd["model_ema.decay"] = torch.tensor(0.9999)
        sd["model_ema.num_updates"] = torch.tensor(0, dtype=torch.int32)
        del ep
    if task.cond == "text":
        enc, ecfg = text_encoder(task)
        cp = enc.init_params(g, ecfg)
        sd.update({f"cond_stage_model.transformer.{k}": v for k, v in
                   export_state_dict(cp, enc.iter_layers(ecfg)).items()})
        del cp
    elif task.cond == "class":
        sd["cond_stage_model.embedding.weight"] = torch.randn(
            (n_classes, task.unet.context_dim), generator=g,
            device=dev).cpu()
    torch.save({"state_dict": sd}, path)


def make_ddim_checkpoint(path: str, task, dev, seed: int = 0) -> None:
    """A seeded random-init checkpoint of a ddim-family task in the layout
    of the reference's DDIM trainer (ddim/runners/diffusion.py:205-243):
    ``[state_dict, optimizer state, epoch, step, ema shadow]``, every name
    under DataParallel's ``module.``; the EMA shadow is a second random
    init, so that the loader's swap changes the weights it returns."""
    import torch
    from tfmq_dm_tpu_torch.models import ddim_unet
    from tfmq_dm_tpu_torch.utils.torch_convert import export_state_dict
    g = torch.Generator(device=dev).manual_seed(seed)
    raw, shadow = ({f"module.{k}": v for k, v in export_state_dict(
        ddim_unet.init_params(g, task.unet),
        ddim_unet.iter_layers(task.unet)).items()} for _ in range(2))
    opt = {"state": {}, "param_groups": [{"lr": 2e-4, "params": list(
        range(len(raw)))}]}
    torch.save([raw, opt, 1, 1000, shadow], path)


def calibrate_ldm(task, ckpt: str, tmp: Path, dev, cond_argv: list,
                  steps: int, cali_n: int, iters: int,
                  flash_fp_least: int, n_units: int) -> dict:
    """Calibrate the full-width checkpoint on the card through the port's
    CLI (``cli.main --ptq --cali`` with ``cond_argv``, the classes or the
    token ids; none for an unconditional task, whose harvest has no CFG):
    a CFG harvest of ``steps`` sampler steps x ``cali_n``
    (flash fp, the only hand-written kernel of the calibration:
    reconstruction and FSC run plain PyTorch, as the JAX package's run
    plain XLA; at least ``flash_fp_least`` launches), TIAR/AdaRound
    reconstruction of every unit with ``iters`` iterations, running-stat
    FSC; launch counts and the peak device memory are read around the
    call. The artifact holds ``n_units`` reconstructed units, the count
    the JAX package's adapter gives the task, and the port's adapter
    agrees. Returns the check's record and the artifact's path."""
    import torch
    from tfmq_dm_tpu_torch import cli
    from tfmq_dm_tpu_torch.models import ldm_units

    art = str(tmp / "cali_recon.npz")
    reset_all_counts()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rc = cli.main(["--task", task.name, "--ckpt", ckpt, "--ptq", "--cali",
                   "--wq", "4", "--aq", "8", "--use_aq", *cond_argv,
                   "--timesteps", str(steps), "--cali_n", str(cali_n),
                   "--cali_iters", str(iters), "--cali_save_path", art,
                   "--seed", str(SEED), "--device", dev.type])
    sync(dev)
    cali_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    counts = all_counts()
    if rc != 0:
        raise RuntimeError(f"cli.main --cali ({task.name}) returned {rc}")
    cfg_note = "" if task.cond == "none" else " x CFG"
    print(f"   cli.main --ptq --cali {task.name} at full width (cuts: "
          f"harvest {steps} steps x {cali_n}{cfg_note}, not the task's "
          f"{task.steps} x {task.cali_n}; {iters} iterations a unit, not "
          f"20000): {cali_s:.2f} s, peak device memory {peak:.2f} GiB; "
          f"launches {counts}", flush=True)
    if counts["flash_fp"] < flash_fp_least:
        raise AssertionError(f"harvest: flash_fp launched "
                             f"{counts['flash_fp']} times, expected >= "
                             f"{flash_fp_least}")
    adapter = ldm_units.build_adapter(task.unet, w_bits=4, a_bits=8,
                                      use_aq=True)
    trained = sum(1 for u in adapter.units
                  if u.recon and adapter.default_train_roles(u))
    if trained != n_units:
        raise AssertionError(f"adapter: {trained} units train at "
                             f"{task.name}, expected {n_units}")
    return {"art": art, "seconds": cali_s, "launches": counts,
            "peak_gib": peak,
            **check_calibration(adapter, art, dev, n_units=n_units)}


def cli_sample(tmp: Path, name: str, argv: list, img_shape: tuple, dev,
               plain: bool = False) -> dict:
    """``cli.main`` sampling (load + deploy + sample + decode) into
    ``tmp / name``, with the kernels or their plain versions; launch
    counts read around the call; the images checked for shape, finite
    values and range. -> {"s", "launches", "img", "lat"} ("lat" None for
    the ddim family, which samples images)."""
    import numpy as np
    from tfmq_dm_tpu_torch import cli
    reset_all_counts()
    t0 = time.perf_counter()
    with plain_kernels() if plain else contextlib.nullcontext():
        rc = cli.main(argv + ["--out", str(tmp / name)])
    sync(dev)
    sec = time.perf_counter() - t0
    counts = all_counts()
    if rc != 0:
        raise RuntimeError(f"cli.main ({name}) returned {rc}")
    img = np.load(tmp / name / "samples.npy")
    lat = np.load(tmp / name / "latents.npy") \
        if (tmp / name / "latents.npy").exists() else None
    if img.shape != img_shape or not np.all(np.isfinite(img)):
        raise AssertionError(f"{name}: bad images {img.shape}")
    if img.min() < 0 or img.max() > 1:
        raise AssertionError(f"{name}: images outside [0, 1]")
    cfg_note = "" if "--classes" not in argv and "--token_ids" not in argv \
        else " x CFG"
    print(f"   cli.main {name} ({img_shape[0]} images{cfg_note}; load + "
          f"deploy + sample + decode): {sec:.2f} s; launches {counts}",
          flush=True)
    return {"s": sec, "launches": counts, "img": img, "lat": lat}


def forward_check(fn, x, t_value: int, dev) -> tuple:
    """One deployed UNet forward (CFG-doubled) at step 0, kernels against
    plain versions, within ``FORWARD_NOISE_FACTOR`` times the plain
    forward's own change on inputs moved by ``FORWARD_NOISE`` (never below
    the floors). -> (max rel, mean rel, the noise's mean rel)."""
    import torch
    n = x.shape[0]
    t = torch.full((n,), t_value, dtype=torch.int32, device=dev)
    noise = torch.randn(x.shape, generator=torch.Generator()
                        .manual_seed(6)).to(dev)
    got = fn(x, t, 0)
    with plain_kernels():
        ref = fn(x, t, 0)
        ref_noisy = fn(x * (1.0 + FORWARD_NOISE * noise), t, 0)
    sync(dev)

    def rel(a, b):
        d = (a - b).abs()
        return (float(d.max() / b.abs().max()),
                float(d.mean() / b.abs().mean()))

    f_max, f_mean = rel(got, ref)
    n_max, n_mean = rel(ref_noisy, ref)
    lim_max = max(FORWARD_MAX_REL, FORWARD_NOISE_FACTOR * n_max)
    lim_mean = max(FORWARD_MEAN_REL, FORWARD_NOISE_FACTOR * n_mean)
    print(f"   one deployed forward, kernels vs plain: max rel "
          f"{f_max:.3e} (limit {lim_max:.3e}), mean rel {f_mean:.3e} "
          f"(limit {lim_mean:.3e}); plain vs plain on inputs moved by "
          f"{FORWARD_NOISE:g}: max rel {n_max:.3e}, mean rel "
          f"{n_mean:.3e}", flush=True)
    if not (f_max <= lim_max and f_mean <= lim_mean):
        raise AssertionError("deployed forward: kernels disagree with "
                             "the plain versions")
    return f_max, f_mean, n_mean


def drive_ldm_path(dev, tmp: Path, steps: int = LDM_STEPS,
                   pq_steps: int = 4) -> dict:
    """The cin256_v2 w4a8 int4-serving path at full width: checkpoint,
    calibration on the card, then the port's CLI with the kernels, with
    the plain versions and in FP; one deployed forward kernels vs plain;
    and a 16-bit-softmax sample. Launch counts are read around each CLI
    run. The checkpoint, the 8-bit-softmax artifact and the FP sample stay
    in ``tmp`` for the deploy phase."""
    import numpy as np
    import torch
    from tfmq_dm_tpu_torch import cli
    from tfmq_dm_tpu_torch.configs.tasks import get_task
    from tfmq_dm_tpu_torch.models import ldm_unet, ldm_units
    from tfmq_dm_tpu_torch.pipelines import ptq
    from tfmq_dm_tpu_torch.pipelines.loading import load_ldm_checkpoint
    from tfmq_dm_tpu_torch.quant.calibrate import cali_model

    task_name = "cin256_v2"
    task = get_task(task_name)
    n = CIN_N
    res, img_res = task.unet.image_size, task.vae.resolution
    print(f"   cut: samples of {steps} DDIM steps, the task's {task.steps} "
          "(10 until phase text came)", flush=True)
    tmp = tmp / "cin"
    tmp.mkdir()
    t0 = time.perf_counter()
    ckpt = str(tmp / f"{task_name}_random.ckpt")
    make_ldm_checkpoint(ckpt, task, dev, n_classes=1001)
    print(f"   random-init {task_name} checkpoint "
          f"{os.path.getsize(ckpt) / 2 ** 30:.2f} GiB: "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    t0 = time.perf_counter()
    params, _, cond = load_ldm_checkpoint(ckpt, task, device=dev)
    ctx, uc = cli.class_context(cond, "1,2", n, dev)
    reset_all_counts()
    _, a_cali, cali_t = ptq.generate_cali_data(
        task, lambda x, t, c: ldm_unet.apply(params, task.unet, x, t,
                                             context=c),
        torch.Generator().manual_seed(1), n_per_t=n, context=ctx,
        uncond=uc, steps=steps, device=dev)
    sync(dev)
    harvest = all_counts()
    arts = {}
    for bits in (8, 16):
        adapter = ldm_units.build_adapter(task.unet, w_bits=4, a_bits=8,
                                          softmax_a_bit=bits,
                                          use_aq=True)
        arts[bits] = str(tmp / f"cali_sm{bits}.npz")
        cali_model(adapter, params, None, a_cali, hp=None, use_aq=True,
                   running_stat=False,
                   generator=torch.Generator().manual_seed(2),
                   path=arts[bits], w_scaler="minmax", act_scaler="minmax",
                   init_samples=2 * n,
                   meta={"task": task.name, "wq": 4, "aq": 8,
                         "softmax_a_bit": bits, "use_aq": True,
                         "cali_t": [float(v) for v in cali_t]})
    sync(dev)
    print(f"   calibration (harvest {steps} steps x {n} x CFG, FSC init "
          f"with 8- and 16-bit softmax grids): "
          f"{time.perf_counter() - t0:.2f} s; harvest launches "
          f"{harvest}", flush=True)
    del params, a_cali
    recon = calibrate_ldm(task, ckpt, tmp, dev, ["--classes", "1,2"],
                          LDM_CALI_STEPS, LDM_CALI_N, LDM_CALI_ITERS,
                          5 * LDM_CALI_STEPS, LDM_UNITS)

    common = ["--task", task_name, "--ckpt", ckpt, "--classes", "1,2",
              "-n", str(n), "--batch", str(n), "--seed", str(SEED),
              "--device", "cuda"]
    quant = ["--ptq", "--cali_ckpt", arts[8], "--use_aq",
             "--int-kernels", "--int4-serving"]
    runs = {}

    def run(name, argv, plain=False):
        runs[name] = cli_sample(tmp, name, argv, (n, img_res, img_res, 3),
                                dev, plain)

    run("deployed", common + quant + ["--timesteps", str(steps)])
    run("plain", common + quant + ["--timesteps", str(steps)],
        plain=True)
    run("fp", common + ["--timesteps", str(steps)])
    run("softmax16", common + ["--ptq", "--cali_ckpt", arts[16],
                               "--use_aq", "--int-kernels",
                               "--int4-serving", "--softmax_a_bit",
                               "16", "--timesteps", str(pq_steps)])
    # the reconstructed artifact, sampled as the init-only one above
    quant_recon = ["--ptq", "--cali_ckpt", recon["art"], "--use_aq",
                   "--int-kernels", "--int4-serving"]
    run("recon", common + quant_recon + ["--timesteps", str(steps)])
    run("recon_plain", common + quant_recon + ["--timesteps", str(steps)],
        plain=True)
    for kern in ("int4_conv2d", "int4_linear", "flash_int8"):
        got, ref = (runs[r]["launches"][kern] for r in ("recon",
                                                         "deployed"))
        if got != ref:
            raise AssertionError(f"recon: {kern} launched {got} times, "
                                 f"the init-only artifact's run {ref}")
    p_rec = latent_psnr(runs["recon"]["lat"], runs["recon_plain"]["lat"])
    p_rec_fp = latent_psnr(runs["recon"]["lat"], runs["fp"]["lat"])
    print(f"   reconstructed artifact: latents kernels vs plain versions "
          f"{p_rec:.2f} dB; quantized vs FP latents (information) "
          f"{p_rec_fp:.2f} dB reconstructed, "
          f"{latent_psnr(runs['deployed']['lat'], runs['fp']['lat']):.2f}"
          f" dB minmax grids and the FSC init pass", flush=True)
    if not p_rec >= MIN_LATENT_PSNR_DB:
        raise AssertionError(f"reconstructed artifact: latent PSNR "
                             f"kernels vs plain {p_rec:.2f} dB < "
                             f"{MIN_LATENT_PSNR_DB}")
    need = [("deployed", "flash_int8", 5 * steps),
            ("deployed", "int4_conv2d", 1),
            ("deployed", "int4_linear", 1),
            ("fp", "flash_fp", 5 * steps),
            ("softmax16", "flash_pquant", 5 * pq_steps)]
    for name, kern, least in need:
        got = runs[name]["launches"][kern]
        if got < least:
            raise AssertionError(f"{name}: {kern} launched {got} "
                                 f"times, expected >= {least}")
    p_lat = latent_psnr(runs["deployed"]["lat"], runs["plain"]["lat"])
    p_img = psnr(runs["deployed"]["img"], runs["plain"]["img"])
    p_qf = psnr(runs["deployed"]["img"], runs["fp"]["img"])
    p_qf_lat = latent_psnr(runs["deployed"]["lat"], runs["fp"]["lat"])
    print(f"   PSNR kernels vs plain versions: latents {p_lat:.2f} dB, "
          f"decoded images {p_img:.2f} dB (information); quantized vs "
          f"FP (information): latents {p_qf_lat:.2f} dB, images "
          f"{p_qf:.2f} dB", flush=True)
    if not p_lat >= MIN_LATENT_PSNR_DB:
        raise AssertionError(f"latent PSNR kernels vs plain {p_lat:.2f}"
                             f" dB < {MIN_LATENT_PSNR_DB}")

    # one deployed UNet forward (CFG-doubled), kernels vs plain, and
    # the device profile of a deployed sample
    args = cli.build_argparser().parse_args(
        common + quant + ["--timesteps", str(PROFILE_STEPS), "--out", "-"])
    params, _, cond = load_ldm_checkpoint(ckpt, task, device=dev)
    sampler_fn, sample_t = ptq.make_schedule(task, steps=PROFILE_STEPS)
    fn = cli.build_ldm_model_fn(args, task, params, cond, sample_t, dev)
    x = torch.randn((n, res, res, task.unet.in_channels),
                    generator=torch.Generator().manual_seed(5)).to(dev)
    f_max, f_mean, n_mean = forward_check(fn, x, int(sample_t[0]), dev)
    prof = profile_device(lambda: sampler_fn(fn, x),
                          f"{task_name} {PROFILE_STEPS}-step deployed sample"
                          f" (batch {n} x CFG, no decode)", top=12)
    return {"runs": {k: {"s": v["s"], "launches": v["launches"]}
                     for k, v in runs.items()},
            "psnr_latents_kernel_vs_plain": p_lat,
            "psnr_images_kernel_vs_plain": p_img,
            "psnr_quant_vs_fp": p_qf, "forward_max_rel": f_max,
            "forward_mean_rel": f_mean, "noise_mean_rel": n_mean,
            "profile": prof, "ckpt": ckpt, "art": arts[8], "steps": steps,
            "calibration": {k: v for k, v in recon.items() if k != "art"},
            "psnr_latents_recon_kernel_vs_plain": p_rec,
            "psnr_latents_recon_vs_fp": p_rec_fp,
            "fp_lat": runs["fp"]["lat"], "fp_img": runs["fp"]["img"]}


def flash_sites(cfg) -> dict:
    """{key length: self-attentions per UNet forward} of the attentions
    whose key length reaches the flash gate
    (``ops.attention.MIN_FLASH_KV``): a walk of the layers (a
    transformer block's attn1, an AttentionBlock's qkv)."""
    from tfmq_dm_tpu_torch.models import ldm_unet
    from tfmq_dm_tpu_torch.ops.attention import MIN_FLASH_KV
    sites = {}
    for _, name, _, res in ldm_unet.iter_layers_with_res(cfg):
        if (name.endswith(".attn1.to_q") or name.endswith(".qkv")) and \
                res * res >= MIN_FLASH_KV:
            sites[res * res] = sites.get(res * res, 0) + 1
    return sites


def cond_walk(task, forwards: int) -> dict:
    """Launches of a conditioned task's int4-serving sample of
    ``forwards`` UNet evaluations, a walk of its layers: ``flash_int8`` at
    each self-attention whose key length reaches the flash gate,
    ``int4_conv2d`` at every packed conv, ``int4_linear`` at every packed
    linear, and the cross-attention K/V projections of the constant
    context once a rollout."""
    from tfmq_dm_tpu_torch.models import ldm_unet
    return {"flash_int8": sum(flash_sites(task.unet).values()) * forwards,
            "int4_linear": sum(linear_counts(task.unet).values()) * forwards
            + 2 * len(ldm_unet.cross_attn_prefixes(task.unet)),
            "int4_conv2d": sum(cin_conv_counts(task.unet).values())
            * forwards}


def drive_sd_path(dev, tmp: Path, steps: int = SD_STEPS) -> dict:
    """The SD v1.4 w4a8 int4-serving path at full width: a seeded
    random-init checkpoint (UNet, KL-f8 decoder, CLIP ViT-L/14 text tower),
    a token-id file, an init-only artifact (PLMS harvest with CFG, minmax
    grids, FSC init pass), then ``cli.main --token_ids`` with the kernels,
    with the plain versions and in FP; launch counts held against a walk
    of the layers; one deployed forward kernels vs plain; the device
    profile of a deployed sample; then ``cli.main --ptq --cali`` at full
    width and that artifact sampled with the kernels and the plain
    versions."""
    import numpy as np
    import torch
    from tfmq_dm_tpu_torch import cli
    from tfmq_dm_tpu_torch.configs.tasks import get_task
    from tfmq_dm_tpu_torch.models import clip_text, ldm_unet, ldm_units
    from tfmq_dm_tpu_torch.pipelines import ptq
    from tfmq_dm_tpu_torch.pipelines.loading import load_ldm_checkpoint
    from tfmq_dm_tpu_torch.quant.calibrate import cali_model

    task = get_task("sd_v1_4")
    n, res = SD_N, task.unet.image_size
    img_res = res * 2 ** (len(task.vae.ch_mult) - 1)
    forwards = steps + 1
    print(f"   cut: samples and the init-only harvest of {steps} PLMS steps"
          f", the task's {task.steps} (10 until phase text came)",
          flush=True)
    tmp = tmp / "sd"
    tmp.mkdir()
    t0 = time.perf_counter()
    ckpt = str(tmp / "sd_v1_4_random.ckpt")
    make_ldm_checkpoint(ckpt, task, dev)
    print(f"   random-init sd_v1_4 checkpoint (UNet, KL-f8 decoder, CLIP "
          f"ViT-L/14) {os.path.getsize(ckpt) / 2 ** 30:.2f} GiB: "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    ids = str(tmp / "token_ids.npy")
    np.save(ids, clip_text.stub_tokenize([SD_PROMPT], task.clip).numpy())
    cond_argv = ["--token_ids", ids]

    t0 = time.perf_counter()
    params, _, cond = load_ldm_checkpoint(ckpt, task, device=dev)
    ctx, uc = cli.conditioning(cli.build_argparser().parse_args(
        ["--task", task.name] + cond_argv), task, cond, n, dev)
    reset_all_counts()
    _, a_cali, cali_t = ptq.generate_cali_data(
        task, lambda x, t, c: ldm_unet.apply(params, task.unet, x, t,
                                             context=c),
        torch.Generator().manual_seed(1), n_per_t=n, context=ctx,
        uncond=uc, steps=steps, device=dev)
    sync(dev)
    harvest = all_counts()
    sites = sum(flash_sites(task.unet).values())
    if harvest["flash_fp"] != sites * forwards:
        raise AssertionError(f"harvest: flash_fp launched "
                             f"{harvest['flash_fp']} times, expected "
                             f"{sites} x {forwards}")
    adapter = ldm_units.build_adapter(task.unet, w_bits=4, a_bits=8,
                                      use_aq=True)
    art = str(tmp / "cali_init.npz")
    cali_model(adapter, params, None, a_cali, hp=None, use_aq=True,
               running_stat=False, generator=torch.Generator().manual_seed(2),
               path=art, w_scaler="minmax", act_scaler="minmax",
               init_samples=2 * n,
               meta={"task": task.name, "wq": 4, "aq": 8,
                     "softmax_a_bit": 8, "use_aq": True,
                     "cali_t": [float(v) for v in cali_t]})
    sync(dev)
    print(f"   init-only artifact (PLMS harvest {steps} steps x {n} x CFG, "
          f"{forwards} UNet evaluations; minmax grids, FSC init pass): "
          f"{time.perf_counter() - t0:.2f} s; harvest launches {harvest}",
          flush=True)
    del params, cond, a_cali, ctx, uc
    torch.cuda.empty_cache()

    common = ["--task", task.name, "--ckpt", ckpt, *cond_argv, "-n", str(n),
              "--batch", str(n), "--seed", str(SEED), "--device", dev.type,
              "--timesteps", str(steps)]
    quant = ["--use_aq", "--int-kernels", "--int4-serving"]
    img_shape = (n, img_res, img_res, 3)
    runs = {}
    for name, argv, plain in (
            ("deployed", ["--ptq", "--cali_ckpt", art] + quant, False),
            ("plain", ["--ptq", "--cali_ckpt", art] + quant, True),
            ("fp", [], False)):
        runs[name] = cli_sample(tmp, name, common + argv, img_shape, dev,
                                plain)
    walk = cond_walk(task, forwards)
    got = {k: runs["deployed"]["launches"][k] for k in walk}
    print(f"   launches against the layer walk ({forwards} UNet "
          f"evaluations; {sites} self-attentions a forward at T >= 1024): "
          f"{got}, walk {walk}", flush=True)
    if got != walk:
        raise AssertionError(f"sd deployed: launches {got}, the walk of "
                             f"the layers {walk}")
    if runs["fp"]["launches"]["flash_fp"] != sites * forwards:
        raise AssertionError(f"sd fp: flash_fp launched "
                             f"{runs['fp']['launches']['flash_fp']} times")
    p_lat = latent_psnr(runs["deployed"]["lat"], runs["plain"]["lat"])
    p_img = psnr(runs["deployed"]["img"], runs["plain"]["img"])
    p_qf_lat = latent_psnr(runs["deployed"]["lat"], runs["fp"]["lat"])
    p_qf = psnr(runs["deployed"]["img"], runs["fp"]["img"])
    print(f"   PSNR kernels vs plain versions: latents {p_lat:.2f} dB, "
          f"decoded images {p_img:.2f} dB (information); quantized vs FP "
          f"(information): latents {p_qf_lat:.2f} dB, images {p_qf:.2f} dB",
          flush=True)
    if not p_lat >= MIN_LATENT_PSNR_DB:
        raise AssertionError(f"sd: latent PSNR kernels vs plain "
                             f"{p_lat:.2f} dB < {MIN_LATENT_PSNR_DB}")

    t0 = time.perf_counter()
    args = cli.build_argparser().parse_args(
        common + ["--ptq", "--cali_ckpt", art] + quant + ["--out", "-"])
    params, _, cond = load_ldm_checkpoint(ckpt, task, device=dev)
    sampler_fn, sample_t = ptq.make_schedule(task, steps=PROFILE_STEPS)
    fn = cli.build_ldm_model_fn(args, task, params, cond, sample_t, dev)
    x = torch.randn((n, res, res, task.unet.in_channels),
                    generator=torch.Generator().manual_seed(5)).to(dev)
    f_max, f_mean, n_mean = forward_check(fn, x, int(sample_t[0]), dev)
    prof = profile_device(lambda: sampler_fn(fn, x),
                          f"sd_v1_4 {PROFILE_STEPS}-step deployed sample "
                          f"(batch {n} x CFG, {PROFILE_STEPS + 1} "
                          "evaluations, no decode)", top=12)
    print(f"   one forward and the profile: {time.perf_counter() - t0:.2f} "
          "s", flush=True)
    del params, cond, fn
    torch.cuda.empty_cache()

    recon = calibrate_ldm(task, ckpt, tmp, dev, cond_argv, SD_CALI_STEPS,
                          SD_CALI_N, SD_CALI_ITERS,
                          sites * (SD_CALI_STEPS + 1), SD_UNITS)
    print(f"   units: {recon['units']} reconstructed (the JAX package's "
          f"ldm_units.build_units at sd_v1_config: 74 of 75 train, "
          f"tests/test_torch_sd_modules.py)", flush=True)
    quant_recon = ["--ptq", "--cali_ckpt", recon["art"]] + quant
    for name, plain in (("recon", False), ("recon_plain", True)):
        runs[name] = cli_sample(tmp, name, common + quant_recon, img_shape,
                                dev, plain)
    for kern in walk:
        if runs["recon"]["launches"][kern] != walk[kern]:
            raise AssertionError(f"sd recon: {kern} launched "
                                 f"{runs['recon']['launches'][kern]} times,"
                                 f" the walk {walk[kern]}")
    p_rec = latent_psnr(runs["recon"]["lat"], runs["recon_plain"]["lat"])
    p_rec_fp = latent_psnr(runs["recon"]["lat"], runs["fp"]["lat"])
    print(f"   reconstructed artifact: latents kernels vs plain versions "
          f"{p_rec:.2f} dB; quantized vs FP latents (information) "
          f"{p_rec_fp:.2f} dB reconstructed, {p_qf_lat:.2f} dB minmax "
          "grids and the FSC init pass", flush=True)
    if not p_rec >= MIN_LATENT_PSNR_DB:
        raise AssertionError(f"sd reconstructed artifact: latent PSNR "
                             f"kernels vs plain {p_rec:.2f} dB < "
                             f"{MIN_LATENT_PSNR_DB}")
    return {"runs": {k: {"s": v["s"], "launches": v["launches"]}
                     for k, v in runs.items()},
            "steps": steps, "forwards": forwards, "walk": walk,
            "psnr_latents_kernel_vs_plain": p_lat,
            "psnr_images_kernel_vs_plain": p_img,
            "psnr_latents_quant_vs_fp": p_qf_lat, "psnr_quant_vs_fp": p_qf,
            "forward_max_rel": f_max, "forward_mean_rel": f_mean,
            "noise_mean_rel": n_mean, "profile": prof,
            "calibration": {k: v for k, v in recon.items() if k != "art"},
            "psnr_latents_recon_kernel_vs_plain": p_rec,
            "psnr_latents_recon_vs_fp": p_rec_fp}


# ---------------------------------------------------------------------------
# phase uncond: the unconditional LDMs and ddim_celeba64
# ---------------------------------------------------------------------------

def uncond_walk(task) -> dict:
    """Launches per UNet forward of an unconditional task's int4-serving
    path, a walk of its layers: ``int4_conv2d`` at every packed conv,
    ``int4_linear`` at every packed linear (the time embedding, each res
    block's ``emb_layers``, the AttentionBlocks' qkv and proj_out),
    ``flash_int8`` at each self-attention whose key length reaches the
    flash gate (the ddim family's 16x16 attention stays materialized)."""
    convs, linears = uncond_geometries(task)
    return {"int4_conv2d": sum(convs.values()),
            "int4_linear": sum(linears.values()),
            "flash_int8": 0 if task.family == "ddim"
            else sum(flash_sites(task.unet).values())}


def uncond_geometries(task):
    """({(res, k, cin, cout): launches}, {(m, k, n): launches}) per forward
    of an unconditional task's packed convs and linears, ``m`` the rows a
    batch row feeds."""
    if task.family == "ddim":
        convs, linears = cifar_geometries(task.unet)
        return convs, {(1, k, n): c for (k, n), c in linears.items()}
    return cin_conv_counts(task.unet), linear_counts(task.unet)


@contextlib.contextmanager
def ema_swaps():
    """The checkpoint loaders' ``EMA swap: n/m tensors`` records, collected
    while the block runs."""
    import logging
    records = []

    class Collect(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    log = logging.getLogger("tfmq_dm_tpu_torch.pipelines.loading")
    handler, level = Collect(), log.level
    log.addHandler(handler)
    log.setLevel(logging.INFO)
    try:
        yield records
    finally:
        log.removeHandler(handler)
        log.setLevel(level)


def per_forward_line(measured, name: str) -> str:
    """Device ms per UNet forward of each kernel of a path of phases
    uncond and text beside its library call and its bound, from the
    kernels phase's timings at the path's shapes, weighted by launches
    per forward."""
    rows = [x for x in measured["conv_geometries"] if x["path"] == name]
    conv = {k: sum(x[k] * x["launches_per_forward"] for x in rows)
            for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    lin = measured[f"{name} linear_per_forward"]
    line = (f"int4_conv2d {conv['ms']:.4f} ms / plain {conv['plain_ms']:.4f}"
            f" / cuDNN {conv['library_ms']:.4f} / bound "
            f"{conv['bound_ms']:.4f}; "
            f"int4_linear {lin['ms']:.4f} / torch.matmul "
            f"{lin['library_ms']:.4f} / bound {lin['bound_ms']:.4f}")
    for kern in ("flash_int8", "flash_fp"):
        per = measured[kern]["path_per_forward"].get(name)
        if per:
            line += (f"; {kern} {per['ms']:.4f} / SDPA "
                     f"{per['library_ms']:.4f} / bound "
                     f"{per['bound_ms']:.4f}")
    return line


def drive_uncond_path(dev, tmp: Path, measured: dict,
                      steps: int = UNCOND_STEPS) -> dict:
    """The unconditional tasks at full width, each from a seeded
    random-init checkpoint in the reference's layout through the port's
    export: lsun_churches256 (Lightning: UNet and KL-f8; FP, init-only and
    calibrated int4-serving samples), lsun_beds256 (Lightning: UNet,
    VQ-f4 and LitEma weights; int4-serving at eta 1) and ddim_celeba64
    (the DDIM trainer's list with ``module.`` names and its EMA shadow;
    int4-serving). Each init-only artifact comes from a harvest of
    ``steps`` steps, minmax grids and the FSC init pass. Every sample runs
    through ``cli.main`` with the kernels and with their plain versions
    from one seed (so eta 1 draws the same step noise); launches are held
    equal to the walk of the layers; one deployed forward of
    lsun_churches256 kernels vs plain; the device profile of each
    deployed sample; the per-forward kernel times of the kernels phase
    printed beside cuDNN / SDPA."""
    import torch
    from tfmq_dm_tpu_torch import cli
    from tfmq_dm_tpu_torch.configs.tasks import get_task
    from tfmq_dm_tpu_torch.models import ddim_unet, ldm_unet
    from tfmq_dm_tpu_torch.pipelines import ptq
    from tfmq_dm_tpu_torch.pipelines.loading import (load_ddim_checkpoint,
                                                     load_ldm_checkpoint)
    from tfmq_dm_tpu_torch.quant.calibrate import cali_model

    n = UNCOND_N
    out = {}
    for name in UNCOND_TASKS:
        task = get_task(name)
        ddim = task.family == "ddim"
        ttmp = tmp / "uncond" / name
        ttmp.mkdir(parents=True)
        t0 = time.perf_counter()
        ckpt = str(ttmp / f"{name}_random.{'pth' if ddim else 'ckpt'}")
        if ddim:
            make_ddim_checkpoint(ckpt, task, dev)
        else:
            make_ldm_checkpoint(ckpt, task, dev, ema=name == "lsun_beds256")
        ck_s = time.perf_counter() - t0
        with ema_swaps() as swaps:
            if ddim:
                params = load_ddim_checkpoint(ckpt, task.unet, device=dev)
            else:
                params = load_ldm_checkpoint(ckpt, task, device=dev)[0]
        # the EMA weights (lsun_beds256, ddim_celeba64) replace every UNet
        # tensor; lsun_churches256's checkpoint has none
        n_t = sum(len(fields) for fields in params.values())
        want = [f"EMA swap: {n_t}/{n_t} tensors"] \
            if ddim or name == "lsun_beds256" else []
        if swaps != want:
            raise AssertionError(f"{name}: EMA swap {swaps}, expected "
                                 f"{want}")
        res = task.unet.resolution if ddim else task.unet.image_size
        img_res = res if ddim else \
            res * 2 ** (len(task.vae.ch_mult) - 1)

        def fp_apply(x, t, c, params=params, task=task):
            if task.family == "ddim":
                return ddim_unet.apply(params, task.unet, x, t)
            return ldm_unet.apply(params, task.unet, x, t)

        t0 = time.perf_counter()
        reset_all_counts()
        _, a_cali, cali_t = ptq.generate_cali_data(
            task, fp_apply, torch.Generator().manual_seed(1), n_per_t=n,
            steps=steps, device=dev)
        sync(dev)
        harvest = all_counts()
        art = str(ttmp / "cali_init.npz")
        cali_model(ptq.build_adapter(task, ptq.QuantArgs(use_aq=True)),
                   params, None, a_cali, hp=None, use_aq=True,
                   running_stat=False,
                   generator=torch.Generator().manual_seed(2), path=art,
                   w_scaler="minmax", act_scaler="minmax", init_samples=n,
                   meta={"task": name, "wq": 4, "aq": 8,
                         "softmax_a_bit": 8, "use_aq": True,
                         "cali_t": [float(v) for v in cali_t]})
        sync(dev)
        walk = uncond_walk(task)
        print(f"   {name}: random-init checkpoint "
              f"{os.path.getsize(ckpt) / 2 ** 30:.2f} GiB in {ck_s:.2f} s"
              f"; EMA swap {swaps or 'none (no EMA weights)'}; init-only "
              f"artifact (harvest {steps} steps x {n}, eta {task.eta:g}; "
              f"minmax grids, FSC init pass) "
              f"{time.perf_counter() - t0:.2f} s; harvest launches "
              f"{harvest}; walk per forward {walk}", flush=True)
        if harvest["flash_fp"] != walk["flash_int8"] * steps:
            raise AssertionError(f"{name} harvest: flash_fp launched "
                                 f"{harvest['flash_fp']} times, the walk "
                                 f"{walk['flash_int8']} x {steps}")
        del params, a_cali
        torch.cuda.empty_cache()

        common = ["--task", name, "--ckpt", ckpt, "-n", str(n), "--batch",
                  str(n), "--seed", str(SEED), "--device", dev.type,
                  "--timesteps", str(steps)]
        quant = ["--ptq", "--cali_ckpt", art, "--use_aq", "--int-kernels",
                 "--int4-serving"]
        img_shape = (n, img_res, img_res, 3)
        runs = {}
        plan = [("deployed", quant, False), ("plain", quant, True)]
        if name == "lsun_churches256":
            plan.append(("fp", [], False))
        for run_name, argv, plain in plan:
            runs[run_name] = cli_sample(ttmp, run_name, common + argv,
                                        img_shape, dev, plain)
        if "fp" in runs and runs["fp"]["launches"]["flash_fp"] != \
                walk["flash_int8"] * steps:
            raise AssertionError(f"{name} fp: flash_fp launched "
                                 f"{runs['fp']['launches']['flash_fp']} "
                                 "times")

        def held(run_name, a="deployed", b="plain"):
            got = {k: runs[a]["launches"][k] for k in walk}
            want = {k: v * steps for k, v in walk.items()}
            if got != want:
                raise AssertionError(f"{name} {a}: launches {got}, the "
                                     f"walk of the layers {want}")
            if ddim:
                p = psnr(runs[a]["img"], runs[b]["img"])
                lim = MIN_PSNR_KERNEL_VS_PLAIN_DB
            else:
                p = latent_psnr(runs[a]["lat"], runs[b]["lat"])
                lim = MIN_LATENT_PSNR_DB
            print(f"   {name} {run_name}: launches {got} equal to the walk "
                  f"({steps} forwards); PSNR kernels vs plain "
                  f"{'images' if ddim else 'latents'} {p:.2f} dB (gate "
                  f"{lim:g})", flush=True)
            if not p >= lim:
                raise AssertionError(f"{name} {run_name}: PSNR kernels vs "
                                     f"plain {p:.2f} dB < {lim}")
            return p if math.isfinite(p) else "bit-identical"

        rec = {"walk": walk, "psnr_kernel_vs_plain": held("init-only")}
        if not ddim and "fp" in runs:
            rec["psnr_latents_quant_vs_fp"] = latent_psnr(
                runs["deployed"]["lat"], runs["fp"]["lat"])

        # one deployed forward kernels vs plain (churches), the device
        # profile of a deployed sample
        args = cli.build_argparser().parse_args(common + quant +
                                                ["--out", "-"])
        sampler_fn, sample_t = ptq.make_schedule(task, steps=PROFILE_STEPS)
        if ddim:
            params = load_ddim_checkpoint(ckpt, task.unet, device=dev)
            fn = cli.build_model_fn(args, params, task.unet, sample_t, dev)
        else:
            params = load_ldm_checkpoint(ckpt, task, device=dev)[0]
            fn = cli.build_ldm_model_fn(args, task, params, None, sample_t,
                                        dev)
        x = torch.randn((n, res, res, task.unet.in_channels),
                        generator=torch.Generator().manual_seed(5)).to(dev)
        if name == "lsun_churches256":
            rec["forward"] = forward_check(fn, x, int(sample_t[0]), dev)
        rec["profile"] = profile_device(
            lambda: sampler_fn(fn, x, torch.Generator().manual_seed(4)),
            f"{name} {PROFILE_STEPS}-step deployed sample (batch {n}, eta "
            f"{task.eta:g}, no decode)", top=10)
        del params, fn
        torch.cuda.empty_cache()

        if name == "lsun_churches256":
            recon = calibrate_ldm(task, ckpt, ttmp, dev, [],
                                  UNCOND_CALI_STEPS, UNCOND_CALI_N,
                                  UNCOND_CALI_ITERS,
                                  walk["flash_int8"] * UNCOND_CALI_STEPS,
                                  UNCOND_UNITS)
            quant_recon = ["--ptq", "--cali_ckpt", recon["art"], "--use_aq",
                           "--int-kernels", "--int4-serving"]
            for run_name, plain in (("recon", False), ("recon_plain", True)):
                runs[run_name] = cli_sample(ttmp, run_name,
                                            common + quant_recon, img_shape,
                                            dev, plain)
            rec["psnr_recon_kernel_vs_plain"] = held(
                "calibrated", "recon", "recon_plain")
            rec["calibration"] = {k: v for k, v in recon.items()
                                  if k != "art"}
        print(f"   {name} per forward (batch {n}; the kernels phase's "
              f"times): " + per_forward_line(measured, name), flush=True)
        rec["runs"] = {k: {"s": v["s"], "launches": v["launches"]}
                       for k, v in runs.items()}
        rec["ema_swap"] = swaps
        out[name] = rec
    return out


# ---------------------------------------------------------------------------
# phase text: the BERT-conditioned LDM text2img tasks
# ---------------------------------------------------------------------------

def text_checkpoint(task, tmp: Path, dev) -> tuple:
    """A seeded random-init checkpoint of a text2img task (UNet, first
    stage, BERT tower) and a token-id file (the stub tokenizer's ids of
    ``TEXT_PROMPT`` at bert-base-uncased's vocabulary, whose WordPiece
    file is not in the repository) -> (ckpt, the CLI's conditioning
    arguments)."""
    import numpy as np
    t0 = time.perf_counter()
    ckpt = str(tmp / f"{task.name}_random.ckpt")
    make_ldm_checkpoint(ckpt, task, dev)
    print(f"   random-init {task.name} checkpoint (UNet, "
          f"{'VQ-f4' if task.vae.vq else 'KL-f8'} decoder, BERT "
          f"{task.bert.dim} x {task.bert.depth}) "
          f"{os.path.getsize(ckpt) / 2 ** 30:.2f} GiB: "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    from tfmq_dm_tpu_torch.models import bert_text
    ids = str(tmp / "token_ids.npy")
    np.save(ids, bert_text.stub_tokenize([TEXT_PROMPT], task.bert).numpy())
    return ckpt, ["--token_ids", ids]


def check_text_runs(name: str, runs: dict, walk: dict, a: str,
                    b: str) -> float:
    """Run ``a``'s launches equal to the walk and its latents within
    ``MIN_LATENT_PSNR_DB`` of run ``b``'s (the plain versions')."""
    got = {k: runs[a]["launches"][k] for k in walk}
    p = latent_psnr(runs[a]["lat"], runs[b]["lat"])
    print(f"   {name} {a}: launches {got}, the walk {walk}; latents "
          f"kernels vs plain versions {p:.2f} dB (gate "
          f"{MIN_LATENT_PSNR_DB:g})", flush=True)
    if got != walk:
        raise AssertionError(f"{name} {a}: launches {got}, the walk of "
                             f"the layers {walk}")
    if not p >= MIN_LATENT_PSNR_DB:
        raise AssertionError(f"{name} {a}: latent PSNR kernels vs plain "
                             f"{p:.2f} dB < {MIN_LATENT_PSNR_DB}")
    return p


def drive_text_path(dev, tmp: Path, measured: dict,
                    steps: int = TEXT_STEPS) -> dict:
    """The BERT-conditioned LDM text2img tasks at full width, 1 image x
    CFG at 5.0, DDIM cut to ``steps`` steps, token ids in place of
    prompts. txt2img_1p4b (KL-f8, BERT 1280 x 32): a seeded random-init
    checkpoint, an init-only artifact (DDIM harvest with CFG, flash fp
    counted; minmax grids, FSC init pass), then ``cli.main --token_ids``
    with the int4 and flash int8 kernels, with the plain versions and in
    FP, decoded to 256 x 256; launches held against a walk of the layers;
    one deployed forward kernels vs plain; the device profile of a
    deployed sample. text2img_256 (VQ-f4, BERT 640 x 32): ``cli.main
    --ptq --cali`` at full width, cut as phase sd's, held as phase ldm's,
    and that artifact sampled with the kernels and the plain versions.
    Each task's kernel times per forward from the kernels phase."""
    import torch
    from tfmq_dm_tpu_torch import cli
    from tfmq_dm_tpu_torch.configs.tasks import get_task
    from tfmq_dm_tpu_torch.models import ldm_unet, ldm_units
    from tfmq_dm_tpu_torch.pipelines import ptq
    from tfmq_dm_tpu_torch.pipelines.loading import load_ldm_checkpoint
    from tfmq_dm_tpu_torch.quant.calibrate import cali_model

    n = TEXT_N
    out = {}
    quant = ["--use_aq", "--int-kernels", "--int4-serving"]

    # txt2img_1p4b: init-only artifact, kernels / plain / FP, forward,
    # profile
    task = get_task("txt2img_1p4b")
    ttmp = tmp / "text" / task.name
    ttmp.mkdir(parents=True)
    ckpt, cond_argv = text_checkpoint(task, ttmp, dev)
    res = task.unet.image_size
    img_res = res * 2 ** (len(task.vae.ch_mult) - 1)
    walk = cond_walk(task, steps)
    t0 = time.perf_counter()
    params, _, cond = load_ldm_checkpoint(ckpt, task, device=dev)
    ctx, uc = cli.conditioning(cli.build_argparser().parse_args(
        ["--task", task.name] + cond_argv), task, cond, n, dev)
    reset_all_counts()
    _, a_cali, cali_t = ptq.generate_cali_data(
        task, lambda x, t, c: ldm_unet.apply(params, task.unet, x, t,
                                             context=c),
        torch.Generator().manual_seed(1), n_per_t=n, context=ctx,
        uncond=uc, steps=steps, device=dev)
    sync(dev)
    harvest = all_counts()
    if harvest["flash_fp"] != walk["flash_int8"]:
        raise AssertionError(f"{task.name} harvest: flash_fp launched "
                             f"{harvest['flash_fp']} times, the walk "
                             f"{walk['flash_int8']}")
    adapter = ldm_units.build_adapter(task.unet, w_bits=4, a_bits=8,
                                      use_aq=True)
    art = str(ttmp / "cali_init.npz")
    cali_model(adapter, params, None, a_cali, hp=None, use_aq=True,
               running_stat=False, generator=torch.Generator().manual_seed(2),
               path=art, w_scaler="minmax", act_scaler="minmax",
               init_samples=2 * n,
               meta={"task": task.name, "wq": 4, "aq": 8,
                     "softmax_a_bit": 8, "use_aq": True,
                     "cali_t": [float(v) for v in cali_t]})
    sync(dev)
    print(f"   {task.name} init-only artifact (DDIM harvest {steps} steps x "
          f"{n} x CFG {task.cfg_scale:g}; minmax grids, FSC init pass): "
          f"{time.perf_counter() - t0:.2f} s; harvest launches {harvest}",
          flush=True)
    del params, cond, a_cali, ctx, uc
    torch.cuda.empty_cache()

    common = ["--task", task.name, "--ckpt", ckpt, *cond_argv, "-n", str(n),
              "--batch", str(n), "--seed", str(SEED), "--device", dev.type,
              "--timesteps", str(steps)]
    img_shape = (n, img_res, img_res, 3)
    runs = {}
    for name, argv, plain in (
            ("deployed", ["--ptq", "--cali_ckpt", art] + quant, False),
            ("plain", ["--ptq", "--cali_ckpt", art] + quant, True),
            ("fp", [], False)):
        runs[name] = cli_sample(ttmp, name, common + argv, img_shape, dev,
                                plain)
    if runs["fp"]["launches"]["flash_fp"] != walk["flash_int8"]:
        raise AssertionError(f"{task.name} fp: flash_fp launched "
                             f"{runs['fp']['launches']['flash_fp']} times")
    rec = {"walk": walk,
           "psnr_latents_kernel_vs_plain": check_text_runs(
               task.name, runs, walk, "deployed", "plain"),
           "psnr_images_kernel_vs_plain": psnr(runs["deployed"]["img"],
                                               runs["plain"]["img"]),
           "psnr_latents_quant_vs_fp": latent_psnr(runs["deployed"]["lat"],
                                                   runs["fp"]["lat"])}
    print(f"   {task.name} quantized vs FP latents (information) "
          f"{rec['psnr_latents_quant_vs_fp']:.2f} dB; decoded images "
          f"kernels vs plain {rec['psnr_images_kernel_vs_plain']:.2f} dB",
          flush=True)
    args = cli.build_argparser().parse_args(
        common + ["--ptq", "--cali_ckpt", art] + quant + ["--out", "-"])
    params, _, cond = load_ldm_checkpoint(ckpt, task, device=dev)
    sampler_fn, sample_t = ptq.make_schedule(task, steps=PROFILE_STEPS)
    fn = cli.build_ldm_model_fn(args, task, params, cond, sample_t, dev)
    x = torch.randn((n, res, res, task.unet.in_channels),
                    generator=torch.Generator().manual_seed(5)).to(dev)
    rec["forward"] = forward_check(fn, x, int(sample_t[0]), dev)
    rec["profile"] = profile_device(
        lambda: sampler_fn(fn, x), f"{task.name} {PROFILE_STEPS}-step "
        f"deployed sample (batch {n} x CFG, no decode)", top=10)
    del params, cond, fn
    torch.cuda.empty_cache()
    rec["runs"] = {k: {"s": v["s"], "launches": v["launches"]}
                   for k, v in runs.items()}
    print(f"   {task.name} per forward (1 x CFG; the kernels phase's "
          f"times): " + per_forward_line(measured, task.name), flush=True)
    out[task.name] = rec
    shutil.rmtree(ttmp, ignore_errors=True)

    # text2img_256: the CLI's calibration at full width, its artifact
    # sampled with the kernels and the plain versions
    task = get_task("text2img_256")
    ttmp = tmp / "text" / task.name
    ttmp.mkdir(parents=True)
    ckpt, cond_argv = text_checkpoint(task, ttmp, dev)
    res = task.unet.image_size
    img_res = res * 2 ** (len(task.vae.ch_mult) - 1)
    walk = cond_walk(task, steps)
    sites = sum(flash_sites(task.unet).values())
    recon = calibrate_ldm(task, ckpt, ttmp, dev, cond_argv, TEXT_CALI_STEPS,
                          TEXT_CALI_N, TEXT_CALI_ITERS,
                          sites * TEXT_CALI_STEPS, TEXT_UNITS)
    common = ["--task", task.name, "--ckpt", ckpt, *cond_argv, "-n", str(n),
              "--batch", str(n), "--seed", str(SEED), "--device", dev.type,
              "--timesteps", str(steps), "--ptq", "--cali_ckpt",
              recon["art"]] + quant
    runs = {name: cli_sample(ttmp, name, common, (n, img_res, img_res, 3),
                             dev, plain)
            for name, plain in (("recon", False), ("recon_plain", True))}
    out[task.name] = {
        "walk": walk,
        "psnr_latents_recon_kernel_vs_plain": check_text_runs(
            task.name, runs, walk, "recon", "recon_plain"),
        "calibration": {k: v for k, v in recon.items() if k != "art"},
        "runs": {k: {"s": v["s"], "launches": v["launches"]}
                 for k, v in runs.items()}}
    print(f"   {task.name} per forward (1 x CFG; the kernels phase's "
          f"times): " + per_forward_line(measured, task.name), flush=True)
    shutil.rmtree(ttmp, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# phase samplers: DDPM, DDIM's x0 trace and DPM-Solver
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def task_sampler(name: str, sampler: str):
    """The port CLI's ``get_task`` answering ``name`` with ``sampler``. No
    task samples ddpm_noisy or dpm; the JAX package reaches them on a task
    so replaced (tests/test_dpm_general.py:416-443)."""
    import dataclasses
    from unittest import mock
    from tfmq_dm_tpu_torch import cli
    real = cli.get_task

    def get(n):
        t = real(n)
        return dataclasses.replace(t, sampler=sampler) if n == name else t

    with mock.patch.object(cli, "get_task", get):
        yield


@contextlib.contextmanager
def fsc_lookups():
    """(step, FSC group) of every deployed UNet evaluation, in order (the
    deployed model function's ``step_group`` calls), while the block
    runs."""
    from tfmq_dm_tpu_torch.quant import deploy
    real, seen = deploy.step_group, []

    def spy(step, gmap, n):
        seen.append((step, real(step, gmap, n)))
        return seen[-1][1]

    deploy.step_group = spy
    try:
        yield seen
    finally:
        deploy.step_group = real


def check_walk(label: str, launches: dict, walk: dict, nfe: int,
               dev) -> dict:
    """A run's launches equal to the walk of the layers times its UNet
    evaluations (on the card; the CPU runs the plain versions)."""
    got = {k: launches[k] for k in walk}
    want = {k: v * nfe for k, v in walk.items()}
    if dev.type == "cuda" and got != want:
        raise AssertionError(f"{label}: launches {got}, the walk x NFE "
                             f"{want}")
    return got


def check_psnr(label: str, got, ref, limit: float, latents: bool) -> float:
    p = latent_psnr(got, ref) if latents else psnr(got, ref)
    print(f"   {label}: kernels vs plain versions {p:.2f} dB "
          f"({'latents' if latents else 'images'}; gate {limit:g})",
          flush=True)
    if not p >= limit:
        raise AssertionError(f"{label}: PSNR kernels vs plain {p:.2f} dB "
                             f"< {limit}")
    return p if math.isfinite(p) else "bit-identical"


def drive_samplers_path(dev, tmp: Path, main_path: dict,
                        dpm_ckpt: str, ddpm_task: str = "cifar10",
                        dpm_task: str = "lsun_churches256") -> dict:
    """The remaining samplers on earlier phases' models, int4-serving.
    ``ddpm_task`` (CIFAR-10, phase main's trained weights and artifact,
    batch 8, its ``STEPS`` steps) samples with DDPM through ``cli.main``
    with the kernels and with the plain versions from one seed (so the
    step noise is the same draws), and a deployed DDIM rollout's x0 trace
    (``collect="x0"``) ends bit-equal to the rollout without it.
    ``dpm_task`` (lsun_churches256, phase uncond's random-init checkpoint
    ``dpm_ckpt``, batch ``DPM_N``) gets an init-only artifact on the
    DPM-Solver++ 2M scan's ``DPM_STEPS`` evaluation times, then
    ``cli.main`` samples from it with each of ``DPM_RUNS`` (``--dpm_*``
    flags) with the kernels and the plain versions, and once with the
    adaptive method (order ``ADAPTIVE_ORDER``) with the kernels only: its
    accept decisions branch on the data. Every evaluation's step and FSC
    group are read from the deployed model function and held against the
    group map of the artifact's times; launches are held equal to the walk
    of the layers times the evaluations."""
    import dataclasses
    import torch
    from tfmq_dm_tpu_torch import cli
    from tfmq_dm_tpu_torch.configs.tasks import get_task
    from tfmq_dm_tpu_torch.models import ldm_unet
    from tfmq_dm_tpu_torch.pipelines import ptq
    from tfmq_dm_tpu_torch.pipelines.loading import load_ldm_checkpoint
    from tfmq_dm_tpu_torch.quant.calibrate import cali_model
    from tfmq_dm_tpu_torch.samplers.ldm import group_of_step_from_t

    ttmp = tmp / "samplers"
    ttmp.mkdir()
    quant = ["--ptq", "--use_aq", "--int-kernels", "--int4-serving"]
    out = {}

    # DDPM and the x0 trace
    task = get_task(ddpm_task)
    res = task.unet.resolution
    walk = uncond_walk(task)
    common = ["--task", ddpm_task, "--ckpt", main_path["ckpt"],
              "--timesteps", str(STEPS), "-n", str(BATCH), "--batch",
              str(BATCH), "--seed", str(SEED), "--device", dev.type,
              "--cali_ckpt", main_path["art"]]
    runs = {}
    with task_sampler(ddpm_task, "ddpm_noisy"):
        with fsc_lookups() as seen:
            runs["ddpm"] = cli_sample(ttmp, "ddpm", common + quant,
                                      (BATCH, res, res, 3), dev)
        runs["ddpm_plain"] = cli_sample(ttmp, "ddpm_plain", common + quant,
                                        (BATCH, res, res, 3), dev, True)
    if [s for s, _ in seen] != list(range(STEPS)):
        raise AssertionError(f"{ddpm_task} DDPM: evaluation steps "
                             f"{[s for s, _ in seen]}")
    rec = {"nfe": len(seen), "s": runs["ddpm"]["s"],
           "plain_s": runs["ddpm_plain"]["s"],
           "launches": check_walk(f"{ddpm_task} DDPM",
                                  runs["ddpm"]["launches"], walk, STEPS,
                                  dev)}
    rec["psnr_kernel_vs_plain"] = check_psnr(
        f"{ddpm_task} DDPM ({STEPS} steps, {BATCH} images)",
        runs["ddpm"]["img"], runs["ddpm_plain"]["img"],
        MIN_PSNR_KERNEL_VS_PLAIN_DB, latents=False)
    args = cli.build_argparser().parse_args(common + quant + ["--out", "-"])
    sampler_fn, sample_t = ptq.make_schedule(task, steps=STEPS)
    fn = cli.build_model_fn(args, cli.load_ddim(args, task, dev), task.unet,
                            sample_t, dev)
    x = torch.randn((BATCH, res, res, 3),
                    generator=torch.Generator().manual_seed(3)).to(dev)
    reset_all_counts()
    z = sampler_fn(fn, x)
    z_x0, x0s = sampler_fn(fn, x, collect="x0")
    sync(dev)
    if not torch.equal(z, z_x0):
        raise AssertionError(f"{ddpm_task}: collect='x0' changed the sample "
                             f"by {float((z - z_x0).abs().max()):.3e}")
    if tuple(x0s.shape) != (STEPS,) + tuple(x.shape) or \
            not bool(torch.isfinite(x0s).all()):
        raise AssertionError(f"{ddpm_task}: x0 trace {tuple(x0s.shape)}")
    rec["x0_trace"] = {"shape": list(x0s.shape), "launches": check_walk(
        f"{ddpm_task} x0 trace", all_counts(), walk, 2 * STEPS, dev)}
    print(f"   {ddpm_task} DDIM x0 trace: {tuple(x0s.shape)}, the final "
          f"sample bit-equal to collect='none'; launches "
          f"{rec['x0_trace']['launches']} over both rollouts", flush=True)
    out[ddpm_task] = rec
    del fn
    torch.cuda.empty_cache()

    # DPM-Solver: an init-only artifact on the 2M scan's times
    task = get_task(dpm_task)
    dtask = dataclasses.replace(task, sampler="dpm")
    walk = uncond_walk(task)
    t0 = time.perf_counter()
    params = load_ldm_checkpoint(dpm_ckpt, task, device=dev)[0]
    reset_all_counts()
    _, a_cali, cali_t = ptq.generate_cali_data(
        dtask, lambda x, t, c: ldm_unet.apply(params, task.unet, x, t),
        torch.Generator().manual_seed(1), n_per_t=DPM_N, steps=DPM_STEPS,
        device=dev)
    sync(dev)
    harvest = all_counts()
    if a_cali[1].dtype != torch.float32:
        raise AssertionError(f"DPM harvest times {a_cali[1].dtype}")
    art = str(ttmp / "cali_dpm.npz")
    cali_model(ptq.build_adapter(task, ptq.QuantArgs(use_aq=True)), params,
               None, a_cali, hp=None, use_aq=True, running_stat=False,
               generator=torch.Generator().manual_seed(2), path=art,
               w_scaler="minmax", act_scaler="minmax", init_samples=DPM_N,
               meta={"task": dpm_task, "wq": 4, "aq": 8, "softmax_a_bit": 8,
                     "use_aq": True, "cali_t": [float(v) for v in cali_t]})
    sync(dev)
    del a_cali
    print(f"   {dpm_task} DPM-Solver++ 2M init-only artifact (harvest "
          f"{DPM_STEPS} evaluations x {DPM_N} at model times "
          f"{[round(float(v), 2) for v in cali_t]}; minmax grids, FSC init "
          f"pass): {time.perf_counter() - t0:.2f} s; harvest launches "
          f"{harvest}", flush=True)
    if dev.type == "cuda" and \
            harvest["flash_fp"] != walk["flash_int8"] * DPM_STEPS:
        raise AssertionError(f"DPM harvest: flash_fp {harvest['flash_fp']}")

    common = ["--task", dpm_task, "--ckpt", dpm_ckpt, "-n", str(DPM_N),
              "--batch", str(DPM_N), "--seed", str(SEED), "--device",
              dev.type, "--timesteps", str(DPM_STEPS), "--cali_ckpt", art]
    img_res = task.unet.image_size * 2 ** (len(task.vae.ch_mult) - 1)
    img_shape = (DPM_N, img_res, img_res, 3)
    rec = {"walk": walk, "harvest_launches": harvest,
           "cali_t": [float(v) for v in cali_t]}
    for name, flags in DPM_RUNS:
        args = cli.build_argparser().parse_args(common + quant + flags
                                                + ["--out", "-"])
        _, sample_t = ptq.make_schedule(dtask, steps=DPM_STEPS,
                                        dpm_cfg=cli.dpm_config(args))
        gos = group_of_step_from_t(cali_t, sample_t)
        with task_sampler(dpm_task, "dpm"):
            with fsc_lookups() as seen:
                k = cli_sample(ttmp, name, common + quant + flags, img_shape,
                               dev)
            p = cli_sample(ttmp, f"{name}_plain", common + quant + flags,
                           img_shape, dev, True)
        want = [int(gos[min(s, len(gos) - 1)]) for s, _ in seen]
        if [g for _, g in seen] != want or len(seen) != DPM_STEPS:
            raise AssertionError(f"{dpm_task} {name}: (step, group) "
                                 f"{seen}, the map {want}")
        print(f"   {dpm_task} {name}: {len(seen)} evaluations, (step, FSC "
              f"group) {seen}", flush=True)
        rec[name] = {"nfe": len(seen), "steps_groups": seen, "s": k["s"],
                     "plain_s": p["s"], "launches": check_walk(
                         f"{dpm_task} {name}", k["launches"], walk,
                         len(seen), dev),
                     "psnr_kernel_vs_plain": check_psnr(
                         f"{dpm_task} {name}", k["lat"], p["lat"],
                         MIN_LATENT_PSNR_DB, latents=True)}
    flags = ["--dpm_method", "adaptive", "--dpm_order", str(ADAPTIVE_ORDER)]
    with task_sampler(dpm_task, "dpm"), fsc_lookups() as seen:
        k = cli_sample(ttmp, "adaptive", common + quant + flags, img_shape,
                       dev)
    if {g for g in seen} != {(0, 0)}:
        raise AssertionError(f"adaptive: (step, group) {set(seen)}")
    rec["adaptive"] = {"order": ADAPTIVE_ORDER, "nfe": len(seen),
                       "s": k["s"], "launches": check_walk(
                           f"{dpm_task} adaptive", k["launches"], walk,
                           len(seen), dev)}
    print(f"   {dpm_task} adaptive order {ADAPTIVE_ORDER} (kernels only: its "
          f"accept decisions branch on the data): {len(seen)} evaluations "
          f"in {k['s']:.2f} s, launches {rec['adaptive']['launches']} = the "
          f"walk x NFE", flush=True)

    # the device-busy share of the 2M scan's deployed sample
    args = cli.build_argparser().parse_args(common + quant + ["--out", "-"])
    sampler_fn, sample_t = ptq.make_schedule(dtask, steps=PROFILE_STEPS)
    fn = cli.build_ldm_model_fn(args, dtask, params, None, sample_t, dev)
    x = torch.randn((DPM_N, task.unet.image_size, task.unet.image_size,
                     task.unet.in_channels),
                    generator=torch.Generator().manual_seed(5)).to(dev)
    if dev.type == "cuda":
        rec["profile"] = profile_device(
            lambda: sampler_fn(fn, x),
            f"{dpm_task} 2M deployed sample ({PROFILE_STEPS} of the "
            f"{DPM_STEPS} steps, batch {DPM_N}, no decode)", top=6)
    out[dpm_task] = rec
    del params, fn
    torch.cuda.empty_cache()
    shutil.rmtree(ttmp, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# the int8 GEMM and mode fqk
# ---------------------------------------------------------------------------

def int8_weight(g, k, n, sym: bool, dev, kh: int = 0):
    """A deployed IntWeight of random 8-bit codes: (K, N), or HWIO
    (kh, kh, K, N) when ``kh``."""
    import torch
    from tfmq_dm_tpu_torch.ops import int_ops
    from tfmq_dm_tpu_torch.quant.quantizer import QCfg
    shape = (kh, kh, k, n) if kh else (k, n)
    w = torch.randn(shape, generator=g) * 0.05
    cfg = QCfg(bits=8, symmetric=sym, channel_wise=True)
    delta = torch.rand(n, generator=g) * 1e-3 + 5e-4
    zp = torch.zeros(n) if sym else \
        torch.randint(100, 156, (n,), generator=g).float()
    iw = int_ops.quantize_weight_int(w.to(dev), delta.to(dev), zp.to(dev),
                                     cfg)
    return iw


def int8_act(g, shape, dev):
    """Centered int8 activation codes, their grid (zp_xc, dx)."""
    import torch
    x = torch.randint(-128, 128, shape, generator=g, dtype=torch.int8)
    return x.to(dev), torch.tensor(-3.0, device=dev), \
        torch.tensor(0.02, device=dev)


def check_int8(g, dev, errs, linears, convs) -> None:
    """``int8_linear`` (int8_matmul_pre) and ``int8_conv2d`` (the GEMM on
    the im2col) with the kernels against the same with the plain versions:
    equal bit for bit (exact int32 sums; the same epilogue order)."""
    import torch
    from tfmq_dm_tpu_torch.ops import int8_kernels as I8
    from tfmq_dm_tpu_torch.ops import int_ops
    for (m, k, n) in linears:
        for sym in (False, True):
            iw = int8_weight(g, k, n, sym, dev)
            x, zx, dx = int8_act(g, (m, k), dev)
            b = torch.randn(n, generator=g).to(dev)
            for od in (torch.float32, torch.bfloat16):
                got = int_ops.int8_linear(x, zx, dx, iw, b, out_dtype=od)
                with plain_kernels():
                    ref = int_ops.int8_linear(x, zx, dx, iw, b, out_dtype=od)
                check_equal(f"int8_matmul_pre M{m} {k}->{n} sym {sym} "
                            f"{str(od)[6:]}", got, ref,
                            errs["int8_matmul_pre"])
    for (b, res, kh, cin, n) in convs:
        for sym in (False, True):
            iw = int8_weight(g, cin, n, sym, dev, kh)
            x, zx, dx = int8_act(g, (b, res, res, cin), dev)
            pads = ((kh // 2, kh // 2),) * 2
            got = int_ops.int8_conv2d(x, zx, dx, iw, None, pads=pads)
            with plain_kernels():
                ref = int_ops.int8_conv2d(x, zx, dx, iw, None, pads=pads)
            check_equal(f"int8_conv2d b{b} {res}x{res} {kh}x{kh} {cin}->{n} "
                        f"sym {sym}", got, ref, errs["int8_matmul_pre"])
    # batched products (attention above the f32-exact depth: Tk 4096)
    a = torch.randint(-128, 128, (16, 64, 4096), generator=g,
                      dtype=torch.int8).to(dev)
    bm = torch.randint(-128, 128, (16, 4096, 40), generator=g,
                       dtype=torch.int8).to(dev)
    check_equal("int8_bmm_acc 16 x 64x4096 @ 4096x40",
                I8.int8_bmm_acc(a, bm), I8.int8_bmm_acc_plain(a, bm),
                errs["int8_matmul_pre"])


def check_equal(label, got, ref, errors) -> None:
    import torch
    torch.cuda.synchronize()
    err = float((got.float() - ref.float()).abs().max())
    print(f"   {label:48s} max_abs_err {err:.3e} (bit-equal: "
          f"{torch.equal(got, ref)})", flush=True)
    if not torch.equal(got, ref):
        raise AssertionError(f"{label}: kernel differs from its plain "
                             f"version ({err:.3e})")
    errors.append(err)


# (label, B*H, T, D): cin256 at batch 2 x CFG, and SD's 64x64
# self-attention over two key blocks (the default block_k 2048)
FQK_SHAPES = [("cin256", 4, 1024, 384), ("sd 64x64", 16, 4096, 40)]


def fqk_sc(pw, dev):
    import torch
    dw, zw = pw if pw is not None else (1.0, 0.0)
    return torch.tensor([a for p in INT8_GRIDS for a in p] + [dw, zw],
                        device=dev)


def check_fqk(g, dev, errs) -> None:
    """Mode fqk on bf16 q/k/v against its plain version: without the
    softmax quantizer the bf16 outputs may differ by one bf16 ulp (2^-7 of
    the largest) in under 0.5% of outputs; with it, the one-level rule."""
    import torch
    from tfmq_dm_tpu_torch.ops import flash_attention as FA
    for label, bh, t, d in FQK_SHAPES:
        q, k, v = (x.to(torch.bfloat16)
                   for x in flash_case(g, bh, t, t, d, dev))
        tag = f"{label} bh{bh} T{t} d{d}"
        for pv in (False, True):
            sc = fqk_sc(P_GRIDS[0], dev)
            got = FA.fqk_prepass(k, v, sc, ((0, 255),) * 3, pv)
            ref = FA.fqk_prepass_plain(k, v, sc, ((0, 255),) * 3, pv)
            torch.cuda.synchronize()
            if not all(torch.equal(a.contiguous(), b)
                       for a, b in zip(got, ref)):
                raise AssertionError(f"fqk pre-pass int8_pv {pv} {tag}: "
                                     "differs from its plain version")
        print(f"   fqk pre-pass {tag}: bit-equal to its plain version "
              "(bf16 k/v; v codes transposed and their column sums)",
              flush=True)
        for pw, zz, pv in ((None, False, False), (P_GRIDS[0], True, False),
                           (P_GRIDS[1], False, False),
                           (P_GRIDS[0], True, True)):
            qr = None if pw is None else (0, 255)
            args = (q, k, v, fqk_sc(pw, dev), d ** -0.5, ((0, 255),) * 3, qr,
                    zz, pv)
            got = FA.flash_fqk(*args).float()
            ref = FA.flash_fqk_plain(*args).float()
            name = f"flash_fqk {'p ' + str(pw[1]) if pw else 'no p'}" \
                f"{' int8_pv' if pv else ''} {tag}"
            if pw is None:
                torch.cuda.synchronize()
                diff = (got - ref).abs()
                share = float((diff > 1e-5).float().mean())
                err = float(diff.max())
                lim = 2.0 ** -7 * float(ref.abs().max())
                print(f"   {name:48s} max_abs_err {err:.3e}  share>1e-5 "
                      f"{share:.2e}  (bf16 ulp limit {lim:.3e})", flush=True)
                if not (share < ONE_LEVEL_SHARE and err <= lim):
                    raise AssertionError(f"{name}: kernel disagrees with its "
                                         "plain version")
                errs["flash_fqk"].append(err)
            else:
                check_one_level(name, got, ref, pw[0], errs["flash_fqk"])
        del q, k, v
        torch.cuda.empty_cache()


def time_int8(g, dev, peaks) -> dict:
    """``int8_matmul_pre`` at cin256's ``ff.net.0.proj`` (M 4096 tokens of
    batch 2 x CFG, 384 -> 3072, bf16 out, as in the fast deploy) with its
    deployed K-major weights, and its conv route at the 64x64 3x3 192 ->
    192 conv: the GEMM on the im2col (bound by the im2col's codes, the
    weights and the int32 out), and the whole conv (im2col, GEMM,
    corrections; bound by x, w and the f32 out). Library calls:
    ``torch._int_mm`` alone, and with the epilogue in PyTorch ops."""
    import torch
    from tfmq_dm_tpu_torch.ops import int8_kernels as I8
    from tfmq_dm_tpu_torch.ops import int_ops
    m, k, n = 2 * CIN_N * 1024, 384, 3072
    iw = int8_weight(g, k, n, False, dev)
    x, zx, dx = int8_act(g, (m, k), dev)
    b = torch.randn(n, generator=g).to(dev)
    xs = x.to(torch.int32).sum(-1, keepdim=True).float()
    ws = iw.wsum.float()
    args = (x, xs, iw.w_q, iw.delta, iw.zp_c, ws, dx, zx, b)
    w_cm = iw.w_q.t().contiguous().t()       # column-major for cuBLASLt

    def library():
        acc = torch._int_mm(x, w_cm).float()
        corr = acc - iw.zp_c * xs - zx * ws + (k * zx) * iw.zp_c
        return ((dx * iw.delta) * corr + b).to(torch.bfloat16)

    flops = 2 * m * n * k
    nbytes = m * k + k * n + 4 * m + 4 * 4 * n + 2 * m * n
    out = {"linear": timings(
        lambda: I8.int8_matmul_pre(*args, out_dtype=torch.bfloat16,
                                   w_t=iw.w_t),
        lambda: I8.int8_matmul_pre_plain(*args, out_dtype=torch.bfloat16),
        library, flops, nbytes, peaks, rate="int8")}
    out["linear"]["library"] = "torch._int_mm + epilogue"
    out["linear"]["int_mm_ms"] = device_ms(lambda: torch._int_mm(x, w_cm))
    # the conv route at cin256's 64x64 3x3 192 -> 192 (batch 2 x CFG)
    bb, res, c = 2 * CIN_N, 64, 192
    iw = int8_weight(g, c, c, False, dev, 3)
    x, zx, dx = int8_act(g, (bb, res, res, c), dev)
    cols = I8.im2col(x, 3, 3, 1, ((1, 1), (1, 1)))
    mc, kc = cols.shape
    w2_cm = iw.w_t.t()                         # (Kp, N), column-major
    flops = 2 * mc * c * 9 * c
    nbytes = cols.numel() + iw.w_t.numel() + 4 * mc * c
    out["conv_gemm"] = timings(
        lambda: I8._launch("int8_conv2d", cols, iw.w_t, mc, kc, c, 1, None),
        lambda: I8._acc_plain(cols, w2_cm),
        lambda: torch._int_mm(cols, w2_cm), flops, nbytes, peaks,
        rate="int8")
    out["conv_gemm"]["library"] = "torch._int_mm on the im2col"
    conv_bytes = x.numel() + iw.w_t.numel() + 4 * 3 * c + 4 * mc * c
    t_conv = {"ms": device_ms(lambda: int_ops.int8_conv2d(x, zx, dx, iw,
                                                         None)),
              "bound_ms": max(flops / peaks["int8"],
                              conv_bytes / peaks["hbm"]) * 1e3}
    out["conv_total"] = t_conv
    for name in ("linear", "conv_gemm"):
        print(f"   int8 {name}: " + timing_line(out[name])
              + earlier_note(out[name], ("int8", name)), flush=True)
    print(f"   int8 linear: torch._int_mm alone "
          f"{out['linear']['int_mm_ms']:.4f} ms device", flush=True)
    print(f"   int8_conv2d 64x64 3x3 192->192 b{bb} whole (im2col + GEMM "
          f"+ corrections): {t_conv['ms']:.4f} ms device, bound "
          f"{t_conv['bound_ms']:.6f}", flush=True)
    return out


def time_gemm_shapes(shapes: dict, dev, peaks) -> list:
    """The int8 GEMM at each distinct shape a deploy path ran (``shapes``:
    (wrapper, M, K, N, batch, out dtype) -> launches per forward), on
    random codes and K-major weights: device ms against ``torch._int_mm``
    and the bound (int32 / f32 / bf16 out as the path had it)."""
    import torch
    from tfmq_dm_tpu_torch.ops import int8_kernels as I8
    g = torch.Generator().manual_seed(9)
    rows = []
    for (name, m, k, n, batch, od), count in sorted(shapes.items()):
        if batch != 1:
            continue
        x = torch.randint(-128, 128, (m, k), generator=g,
                          dtype=torch.int8).to(dev)
        w_t = I8.kmajor(torch.randint(-128, 128, (k, n), generator=g,
                                      dtype=torch.int8)).to(dev)
        out_dtype = None if od == "None" else getattr(torch, od[6:])
        ones = torch.ones(n, device=dev)
        xs = x.to(torch.int32).sum(-1, keepdim=True).float()
        sc = torch.tensor([0.02, -3.0], device=dev)
        ms = device_ms(lambda: I8._launch(
            name, x, w_t, m, k, n, 1, out_dtype, xs, ones, ones, ones, None,
            sc))
        w_cm = w_t[:, :k].t()
        # torch._int_mm takes M > 16 and K, N multiples of 8
        lib = device_ms(lambda: torch._int_mm(x, w_cm)) \
            if m > 16 and k % 8 == 0 and n % 8 == 0 else None
        out_b = {"None": 4, "torch.float32": 4, "torch.bfloat16": 2}[od]
        t_ops = 2 * m * n * k / peaks["int8"] * 1e3
        t_bytes = (m * k + n * w_t.shape[1] + out_b * m * n) / peaks["hbm"] \
            * 1e3
        rows.append({"wrapper": name, "shape": [m, k, n], "out": od,
                     "launches_per_forward": count,
                     "plan": list(I8.gemm_plan(m, n, k)), "ms": ms,
                     "library_ms": lib, "bound_ms": max(t_ops, t_bytes),
                     "bound_by": "operations" if t_ops >= t_bytes
                     else "bytes"})
        r = rows[-1]
        kind = "int32" if od == "None" else od[6:]
        lib_s = "-" if lib is None else f"{lib:.4f}"
        print(f"     {name:15s} M{m} {k}->{n} {kind} x{count}/fwd plan "
              f"{r['plan']}: {ms:.4f} ms; _int_mm {lib_s}; bound "
              f"{r['bound_ms']:.6f} ({r['bound_by']})", flush=True)
        del x, w_t
    return rows


# mode label -> (softmax grid or None, zp_zero, int8_pv)
FQK_MODES = {"no p": (None, False, False),
             "p levels": (P_GRIDS[0], True, False),
             "int8_pv": (P_GRIDS[0], True, True)}


def fqk_args(g, bh, t, d, mode, dev) -> tuple:
    """``flash_fqk``'s arguments at (B*H, T, D) in one of ``FQK_MODES``:
    bf16 q/k/v, the cin256 grids, the 8-bit ranges."""
    import torch
    pw, zz, pv = FQK_MODES[mode]
    q, k, v = (x.to(torch.bfloat16) for x in flash_case(g, bh, t, t, d, dev))
    return (q, k, v, fqk_sc(pw, dev), d ** -0.5, ((0, 255),) * 3,
            None if pw is None else (0, 255), zz, pv)


def time_fqk(g, dev, peaks) -> dict:
    """``flash_fqk`` (pre-pass + main kernel) at cin256 (B*H 4, T 1024,
    D 384) and SD's 64x64 (B*H 16, T 4096, D 40), bf16, in its three
    modes: no softmax quantizer, 8-bit softmax levels (the cin256 bf16
    deploy's), int8 P @ V; kernel, plain version and bf16
    ``scaled_dot_product_attention`` on q/k/v fake-quantized ahead of
    time. Returns {(label, mode): timings}."""
    import torch
    import torch.nn.functional as F
    from tfmq_dm_tpu_torch.ops import flash_attention as FA
    out = {}
    for label, bh, t, d in FQK_SHAPES:
        # S = QK^T in bf16; P @ V in bf16, or in int8 for int8_pv
        products = 2 * bh * t * t * d
        nbytes = 2 * 4 * bh * t * d + 4 * 8
        for mode in FQK_MODES:
            args = fqk_args(g, bh, t, d, mode, dev)
            sc = args[3]
            fq = [FA.fake_quant_tile(x, sc[2 * i], sc[2 * i + 1], (0, 255),
                                     torch.bfloat16)[:, None]
                  for i, x in enumerate(args[:3])]
            flops = {"bf16": products, "int8": products} if args[-1] \
                else {"bf16": 2 * products}
            tm = timings(lambda: FA.flash_fqk(*args),
                         lambda: FA.flash_fqk_plain(*args),
                         lambda: F.scaled_dot_product_attention(
                             *fq, scale=d ** -0.5),
                         flops, nbytes, peaks)
            tm["library"] = ("scaled_dot_product_attention bf16 "
                             f"({sdpa_backend(*fq)})")
            tm["shape"] = f"(B*H {bh}, T {t}, D {d}), bf16, {mode}"
            out[(label, mode)] = tm
            print(f"   flash_fqk {label} bh{bh} T{t} d{d} {mode}: "
                  + timing_line(tm)
                  + earlier_note(tm, ("flash_fqk", label, mode)), flush=True)
            del fq, args
        torch.cuda.empty_cache()
    return out


def earlier_note(tm: dict, key) -> str:
    """The earlier design's device time at this shape, for reading."""
    e = EARLIER_MS.get(key)
    return "" if e is None else \
        f"; earlier design {e:.4f} ({e / tm['ms']:.1f}x this)"


# ---------------------------------------------------------------------------
# the fused int8 GEMM and the fused GroupNorm (no model path)
# ---------------------------------------------------------------------------

def check_fused(g, dev, errs, linears) -> None:
    """``int8_matmul_fused`` on f32 and bf16 x, f32 and bf16 out, with and
    without bias, against its plain version and against
    ``int8_matmul_pre`` on ``quantize_act_int8``'s codes: bit-equal to
    both (the same quantization, exact int32 sums, the same epilogue)."""
    import torch
    from tfmq_dm_tpu_torch.ops import int8_kernels as I8
    from tfmq_dm_tpu_torch.ops import int_ops
    from tfmq_dm_tpu_torch.quant.quantizer import QCfg
    cfg = QCfg(bits=8)
    dx, zx = torch.tensor(0.021, device=dev), torch.tensor(-3.0, device=dev)
    for (m, k, n) in linears:
        iw = int8_weight(g, k, n, False, dev)
        ws = iw.wsum.float()
        b = torch.randn(n, generator=g).to(dev)
        x32 = (torch.randn(m, k, generator=g) * 1.5).to(dev)
        for xd in (torch.float32, torch.bfloat16):
            x = x32.to(xd)
            xq, zc = int_ops.quantize_act_int8(x, dx, zx + 128.0, cfg)
            xs = xq.to(torch.int32).sum(-1, keepdim=True).float()
            for od in (torch.float32, torch.bfloat16):
                for bias in (b, None):
                    args = (x, iw.w_q, iw.delta, iw.zp_c, ws, dx, zx, bias)
                    got = I8.int8_matmul_fused(*args, out_dtype=od,
                                               w_t=iw.w_t)
                    refs = (I8.int8_matmul_fused_plain(*args, out_dtype=od),
                            I8.int8_matmul_pre(xq, xs, iw.w_q, iw.delta,
                                               iw.zp_c, ws, dx, zc, bias,
                                               out_dtype=od))
                    torch.cuda.synchronize()
                    for what, ref in zip(("plain", "quantize + pre"), refs):
                        if not torch.equal(got, ref):
                            raise AssertionError(
                                f"int8_matmul_fused M{m} {k}->{n} x {xd} "
                                f"out {od} bias {bias is not None}: differs "
                                f"from {what}")
        errs["int8_matmul_fused"].append(0.0)
        print(f"   int8_matmul_fused M{m} {k}->{n}: bit-equal to its plain "
              "version and to quantize + int8_matmul_pre (x f32/bf16, out "
              "f32/bf16, bias on/off)", flush=True)


def gn_geometries():
    """(batch, res, C, eps, dtype) of every distinct GroupNorm of the
    cin256 UNet (batch 2 x CFG, bf16 as in its fast deploy) and of the
    CIFAR-10 UNet (batch 8, f32); groups 32 throughout."""
    import torch
    from tfmq_dm_tpu_torch.configs.tasks import get_task
    from tfmq_dm_tpu_torch.models import ddim_unet, ldm_unet
    cin = get_task("cin256_v2").unet
    inputs, middle, outputs = ldm_unet.build_structure(cin)
    res, norms = cin.image_size, {(cin.image_size, cin.model_channels)}
    for group in list(inputs) + [middle] + list(outputs):
        for sub in group:
            if sub.kind == "res":
                norms |= {(res, sub.c_in), (res, sub.c_out)}
            elif sub.kind == "strans":
                norms.add((res, sub.c_in))
            elif sub.kind == "down":
                res //= 2
            elif sub.kind == "up":
                res *= 2
    out = [(2 * CIN_N, r, c, 1e-5, torch.bfloat16) for r, c in sorted(norms)]
    cfg = ddim_unet.cifar10_config()
    res, norms = cfg.resolution, set()
    for kind, name, shape in ddim_unet.iter_layers(cfg):
        if name.endswith("downsample.conv"):
            res //= 2
        elif name.endswith("upsample.conv"):
            res *= 2
        elif kind == "norm":
            norms.add((res, shape))
    out += [(BATCH, r, c, 1e-6, torch.float32) for r, c in sorted(norms)]
    return out


def gn_shapes(odd: bool = True):
    """(b, h, w, c, eps, dtype) of ``check_gn``: SD's resblock shapes (the
    micro_gn twin's, bf16), every cin256 and CIFAR-10 GroupNorm and, with
    ``odd``, two odd shapes (hw not a multiple of 512, C not a multiple of
    128)."""
    import torch
    from tfmq_dm_tpu_torch.scripts import micro_gn
    shapes = [(b, h, w, c, micro_gn.EPS, torch.bfloat16)
              for b, h, w, c in micro_gn.SHAPES]
    shapes += [(b, r, r, c, eps, dt) for b, r, c, eps, dt in gn_geometries()]
    if odd:
        shapes += [(2, 33, 17, 96, 1e-5, torch.bfloat16),
                   (3, 5, 7, 64, 1e-6, torch.float32)]
    return shapes


def gn_case(g, b, h, w, c, dt, dev):
    """x (b, h, w, c) of ``dt``, gamma, beta and the scale-shift pair."""
    import torch
    x = (torch.randn(b, h, w, c, generator=g) * 1.5 + 0.3).to(dt).to(dev)
    gamma = (1 + 0.1 * torch.randn(c, generator=g)).to(dev)
    beta = (0.1 * torch.randn(c, generator=g)).to(dev)
    ss = tuple((0.1 * torch.randn(b, c, generator=g)).to(dev)
               for _ in range(2))
    return x, gamma, beta, ss


def gn_levels(got, ref):
    """The largest code difference in levels and the share of codes that
    differ."""
    diff = (got.int() - ref.int()).abs()
    return int(diff.max()), float((diff > 0).float().mean())


def gn_plan_note(x, groups: int = 32) -> str:
    """The plan ``gn_swish_quant_int8`` takes for ``x``: route, slices,
    cluster size, and the dynamic shared memory of a block (ptxas reports
    only the static, none)."""
    from tfmq_dm_tpu_torch.ops import gn_kernels as G
    b, h, w, c = x.shape
    item = x.element_size()
    route, slices, cluster = G.gn_plan(b, h * w, c, groups, item)
    smem = G.gn_smem(route, h * w, c, groups, item, slices, cluster)
    return (f"{route}, {slices} slices of {c // slices} channels, clusters "
            f"of {cluster}, {smem} B of shared memory a block")


def check_gn(g, dev, errs) -> None:
    """``gn_swish_quant_int8`` against its plain version at ``gn_shapes``,
    with and without SiLU and the scale-shift pair: codes at most
    GN_MAX_LEVELS apart on under GN_MAX_SHARE of them, zp_c equal, one
    launch a call, and two calls bit-identical (the sums run in a fixed
    order). Prints each shape's plan."""
    import torch
    from tfmq_dm_tpu_torch.ops import gn_kernels as G
    from tfmq_dm_tpu_torch.quant.quantizer import QCfg
    cfg = QCfg(bits=8)
    shapes = gn_shapes()
    delta, zp = torch.tensor(0.02, device=dev), torch.tensor(117.0, device=dev)
    worst = (0, 0.0)
    for b, h, w, c, eps, dt in shapes:
        x, gamma, beta, ss = gn_case(g, b, h, w, c, dt, dev)
        for swish in (True, False):
            for pair in (None, ss):
                kw = dict(eps=eps, do_swish=swish, ss=pair)
                before = G.LAUNCHES["gn_swish_quant_int8"]
                got, gz = G.gn_swish_quant_int8(x, gamma, beta, delta, zp,
                                                cfg, **kw)
                if G.LAUNCHES["gn_swish_quant_int8"] != before + 1:
                    raise AssertionError("gn_swish_quant_int8: not one "
                                         "launch a call")
                again, _ = G.gn_swish_quant_int8(x, gamma, beta, delta, zp,
                                                 cfg, **kw)
                ref, rz = G.gn_swish_quant_int8_plain(x, gamma, beta, delta,
                                                      zp, cfg, **kw)
                torch.cuda.synchronize()
                levels, share = gn_levels(got, ref)
                worst = max(worst, (levels, share))
                errs["gn_swish_quant_int8"].append(levels)
                if not (levels <= GN_MAX_LEVELS and share < GN_MAX_SHARE
                        and float(gz) == float(rz)):
                    raise AssertionError(
                        f"gn_swish_quant_int8 {(b, h, w, c)} {dt} swish "
                        f"{swish} ss {pair is not None}: {levels} levels, "
                        f"{share:.2e} of codes off, zp_c {float(gz)} / "
                        f"{float(rz)}")
                if not torch.equal(got, again):
                    raise AssertionError(f"gn_swish_quant_int8 {(b, h, w, c)}"
                                         ": two calls differ")
        print(f"   gn_swish_quant_int8 {(b, h, w, c)} {str(dt)[6:]}: "
              f"{gn_plan_note(x)}", flush=True)
    print(f"   gn_swish_quant_int8 {len(shapes)} shapes x (SiLU, ss): worst "
          f"{worst[0]} level(s), {worst[1]:.2e} of codes off; two calls "
          "bit-identical", flush=True)


def time_fused(g, dev, peaks) -> dict:
    """``int8_matmul_fused`` at cin256's ``ff.net.0.proj`` (M 4096, 384 ->
    3072, bf16 x and out, the deployed K-major weights;
    ``int8_matmul_pre``'s timing shape): kernel,
    plain version, and as the library call the quantization in PyTorch
    ops, ``torch._int_mm`` and the epilogue in PyTorch ops; also the port's
    current pair, ``quantize_act_int8`` + ``int8_matmul_pre``."""
    import torch
    from tfmq_dm_tpu_torch.ops import int8_kernels as I8
    from tfmq_dm_tpu_torch.ops import int_ops
    from tfmq_dm_tpu_torch.quant.quantizer import QCfg
    cfg = QCfg(bits=8)
    m, k, n = 2 * CIN_N * 1024, 384, 3072
    iw = int8_weight(g, k, n, False, dev)
    ws = iw.wsum.float()
    x = torch.randn(m, k, generator=g).to(torch.bfloat16).to(dev)
    dx, zx = torch.tensor(0.021, device=dev), torch.tensor(-3.0, device=dev)
    b = torch.randn(n, generator=g).to(dev)
    args = (x, iw.w_q, iw.delta, iw.zp_c, ws, dx, zx, b)
    w_cm = iw.w_q.t().contiguous().t()       # column-major for cuBLASLt

    def library():
        xq = (torch.clamp(torch.round(x.float() * (1.0 / dx)) + (zx + 128.0),
                          0.0, 255.0) - 128.0).to(torch.int8)
        xs = xq.to(torch.int32).sum(-1, keepdim=True).float()
        corr = torch._int_mm(xq, w_cm).float() - iw.zp_c * xs - zx * ws \
            + (k * zx) * iw.zp_c
        return ((dx * iw.delta) * corr + b).to(torch.bfloat16)

    def pair():
        xq, zc = int_ops.quantize_act_int8(x, dx, zx + 128.0, cfg)
        xs = xq.to(torch.int32).sum(-1, keepdim=True).float()
        return I8.int8_matmul_pre(xq, xs, iw.w_q, iw.delta, iw.zp_c, ws, dx,
                                  zc, b, out_dtype=torch.bfloat16, w_t=iw.w_t)

    xq0, zc0 = int_ops.quantize_act_int8(x, dx, zx + 128.0, cfg)
    pre_args = (xq0, xq0.to(torch.int32).sum(-1, keepdim=True).float(),
                iw.w_q, iw.delta, iw.zp_c, ws, dx, zc0, b)

    flops = 2 * m * n * k
    nbytes = 2 * m * k + k * n + 4 * 4 * n + 8 + 2 * m * n
    tm = timings(lambda: I8.int8_matmul_fused(*args, out_dtype=torch.bfloat16,
                                              w_t=iw.w_t),
                 lambda: I8.int8_matmul_fused_plain(*args,
                                                    out_dtype=torch.bfloat16),
                 library, flops, nbytes, peaks, rate="int8")
    tm["library"] = "quantize in PyTorch ops + torch._int_mm + epilogue"
    tm["pair_ms"] = device_ms(pair)
    tm["pair"] = "int_ops.quantize_act_int8 + int8_matmul_pre"
    tm["pre_ms"] = device_ms(lambda: I8.int8_matmul_pre(
        *pre_args, out_dtype=torch.bfloat16, w_t=iw.w_t))
    print(f"   int8_matmul_fused M{m} {k}->{n} bf16: " + timing_line(tm)
          + f"; quantize + int8_matmul_pre {tm['pair_ms']:.4f} "
          f"({tm['pair_ms'] / tm['ms']:.2f}x the fused kernel); "
          f"int8_matmul_pre alone {tm['pre_ms']:.4f}"
          + earlier_note(tm, ("int8_matmul_fused", m, k, n)), flush=True)
    return tm


def time_gn(dev, peaks) -> list:
    """``gn_swish_quant_int8`` at SD's resblock shapes in bf16 through the
    micro_gn twin's inputs: kernel, plain version, and as the library
    call ``F.group_norm`` on the NCHW view + ``F.silu`` + the quantization
    in PyTorch ops; then the twin's own timing of the port's unfused chain
    against the kernel (``micro_gn.time_shape``)."""
    import torch
    import torch.nn.functional as F
    from tfmq_dm_tpu_torch.ops import gn_kernels as G
    from tfmq_dm_tpu_torch.scripts import micro_gn
    out = []
    for shape in micro_gn.SHAPES:
        x, gamma, beta, delta, zp = micro_gn.inputs(shape, dev)
        args = (x, gamma, beta, delta, zp, micro_gn.CFG)
        xn = x.permute(0, 3, 1, 2)      # NHWC memory: channels_last
        gb, bb = gamma.to(torch.bfloat16), beta.to(torch.bfloat16)

        def library():
            y = F.silu(F.group_norm(xn, micro_gn.GROUPS, gb, bb,
                                    micro_gn.EPS))
            return (torch.clamp(torch.round(y.float() * (1.0 / delta)) + zp,
                                0.0, 255.0) - 128.0).to(torch.int8)

        numel = x.numel()
        # per element: two sums, the affine, SiLU (~8 with exp), quantize
        tm = timings(lambda: G.gn_swish_quant_int8(*args),
                     lambda: G.gn_swish_quant_int8_plain(*args), library,
                     16 * numel, 2 * numel + numel, peaks, rate="f32")
        tm["library"] = "F.group_norm + F.silu + quantize in PyTorch ops"
        twin = micro_gn.time_shape(shape, dev)
        tm["shape"] = f"{shape} bf16"
        tm["plan"] = gn_plan_note(x)
        tm["unfused_chain_ms"] = twin["unfused_ms"]
        tm["unfused_vs_fused"] = twin["ratio"]
        print(f"   gn_swish_quant_int8 {shape} bf16 ({tm['plan']}): "
              + timing_line(tm)
              + f"; micro_gn twin: unfused chain {twin['unfused_ms']:.4f}, "
              f"fused {twin['fused_ms']:.4f} ({twin['ratio']:.2f}x)"
              + earlier_note(tm, ("gn_swish_quant_int8", *shape)),
              flush=True)
        out.append(tm)
    return out


def forward_counts(fn, args):
    """Launch counts of one call ``fn(*args)``, and its int8 GEMM launches
    by (wrapper, M, K, N, batch, out dtype)."""
    import torch
    from unittest import mock
    from tfmq_dm_tpu_torch.ops import int8_kernels as I8
    shapes = {}
    launch = I8._launch

    def recorded(name, x, w_t, m, k, n, batch, out_dtype, *rest):
        key = (name, m, k, n, batch, str(out_dtype))
        shapes[key] = shapes.get(key, 0) + 1
        return launch(name, x, w_t, m, k, n, batch, out_dtype, *rest)

    reset_all_counts()
    with mock.patch.object(I8, "_launch", recorded), torch.no_grad():
        fn(*args)
    torch.cuda.synchronize()
    return {k: v for k, v in all_counts().items() if v}, shapes


def drive_deploy_path(dev, main_path: dict, ldm: dict, peaks: dict,
                      cin_steps: int = LDM_STEPS) -> dict:
    """The int8 and bf16 deployments through ``cli.main``: cin256_v2
    ``--int-kernels --deploy_dtype bfloat16``, the CIFAR-10 bench
    configuration (w4a8 ``--w_sym``, int8 deploy, bf16) and CIFAR-10 w8a8
    (f32). Each with the kernels (counts read around the run; the int8
    GEMM must read the deployed K-major weights, making no copy per call)
    and with the plain versions on the same noise; one UNet forward's
    launches and int8 GEMM shapes, each shape timed; the device profile
    of a sample."""
    import numpy as np
    import torch
    from tfmq_dm_tpu_torch import cli
    from tfmq_dm_tpu_torch.ops import int8_kernels as I8
    from tfmq_dm_tpu_torch.configs.tasks import get_task
    from tfmq_dm_tpu_torch.convert import load_params
    from tfmq_dm_tpu_torch.models import ddim_unet
    from tfmq_dm_tpu_torch.pipelines import ptq
    from tfmq_dm_tpu_torch.pipelines.loading import load_ldm_checkpoint
    from tfmq_dm_tpu_torch.samplers.ddim import generalized_scan

    tmp = Path(ldm["ckpt"]).parent.parent / "deploy"
    tmp.mkdir()
    task = get_task("cin256_v2")
    n, res = CIN_N, task.unet.image_size
    cin_argv = ["--task", "cin256_v2", "--ckpt", ldm["ckpt"], "--classes",
                "1,2", "-n", str(n), "--batch", str(n), "--seed", str(SEED),
                "--device", "cuda", "--ptq", "--cali_ckpt", ldm["art"],
                "--use_aq", "--int-kernels", "--deploy_dtype", "bfloat16",
                "--timesteps", str(cin_steps)]
    c10 = ["--task", "cifar10", "--ckpt", main_path["ckpt"], "--timesteps",
           str(STEPS), "-n", str(BATCH), "--batch", str(BATCH), "--seed",
           str(SEED), "--device", "cuda", "--ptq", "--use_aq",
           "--int-kernels"]
    configs = [
        ("cin256_v2 bf16", cin_argv, True),
        ("cifar10 bench", c10 + ["--cali_ckpt", main_path["arts"]["bench"],
                                 "--w_sym", "--deploy_dtype", "bfloat16"],
         False),
        ("cifar10 w8a8", c10 + ["--cali_ckpt", main_path["arts"]["w8a8"],
                                "--wq", "8"], False)]
    out = {}
    for name, argv, ldm_task in configs:
        res_ = {}
        for plain in (False, True):
            d = tmp / f"{name.replace(' ', '_')}_{int(plain)}"
            reset_all_counts()
            t0 = time.perf_counter()
            with plain_kernels() if plain else contextlib.nullcontext():
                rc = cli.main(argv + ["--out", str(d)])
            sync(dev)
            sec = time.perf_counter() - t0
            if rc != 0:
                raise RuntimeError(f"cli.main ({name}) returned {rc}")
            img = np.load(d / "samples.npy")
            if not np.all(np.isfinite(img)) or img.min() < 0 or \
                    img.max() > 1:
                raise AssertionError(f"{name}: bad images")
            res_[plain] = {"s": sec, "launches": all_counts(), "img": img,
                           "kmajor_copies": dict(I8.KMAJOR_COPIES),
                           "lat": np.load(d / "latents.npy")
                           if ldm_task else None}
        k, p = res_[False], res_[True]
        if ldm_task:
            p_kp = latent_psnr(k["lat"], p["lat"])
            p_fp = latent_psnr(k["lat"], ldm["fp_lat"])
        else:
            p_kp = psnr(k["img"], p["img"])
            p_fp = psnr(k["img"], main_path["fp_img"])

        # one UNet forward's launches, and the device profile of a sample
        t0 = time.perf_counter()
        args = cli.build_argparser().parse_args(argv + ["--out", "-"])
        if ldm_task:
            params, _, cond = load_ldm_checkpoint(ldm["ckpt"], task,
                                                  device=dev)
            sampler_fn, sample_t = ptq.make_schedule(task,
                                                     steps=PROFILE_STEPS)
            fn = cli.build_ldm_model_fn(args, task, params, cond, sample_t,
                                        dev)
            x = torch.randn((n, res, res, task.unet.in_channels),
                            generator=torch.Generator().manual_seed(5)
                            ).to(dev)
            t = torch.full((n,), int(sample_t[0]), dtype=torch.int32,
                           device=dev)
            per_fwd, shapes = forward_counts(fn, (x, t, 0))
            prof = profile_device(lambda: sampler_fn(fn, x),
                                  f"{name} {PROFILE_STEPS}-step sample "
                                  f"(batch {n} x CFG, no decode)", top=10)
            steps = cin_steps
        else:
            cfg = ddim_unet.cifar10_config()
            params, _ = load_params(main_path["ckpt"], device=dev)
            betas, seq = cli.cifar10_schedule(PROFILE_STEPS)
            fn = cli.build_model_fn(args, params, cfg, seq[::-1], dev)
            x = torch.randn((BATCH, 32, 32, 3),
                            generator=torch.Generator().manual_seed(3)
                            ).to(dev)
            t = torch.full((BATCH,), int(seq[-1]), dtype=torch.int32,
                           device=dev)
            per_fwd, shapes = forward_counts(fn, (x, t, 0))
            prof = profile_device(lambda: generalized_scan(fn, betas, seq, x),
                                  f"{name} {PROFILE_STEPS}-step sample "
                                  f"(batch {BATCH})", top=8)
            steps = STEPS
        prof_s = time.perf_counter() - t0
        del params, fn
        torch.cuda.empty_cache()
        print(f"   deploy {name}: the int8 GEMM at each shape of one "
              "forward (random codes):", flush=True)
        gemm_rows = time_gemm_shapes(shapes, dev, peaks)
        print(f"   deploy {name}: model build, one forward and the profile "
              f"of three samples {prof_s:.2f} s", flush=True)
        print(f"   deploy {name}: cli.main {k['s']:.2f} s with the kernels "
              f"(launches {k['launches']}), {p['s']:.2f} s with the plain "
              f"versions; one forward launches {per_fwd}; PSNR kernels vs "
              f"plain {p_kp:.2f} dB ({'latents' if ldm_task else 'images'})"
              f", vs FP (information) {p_fp:.2f} dB", flush=True)
        if not p_kp >= MIN_PSNR_KERNEL_VS_PLAIN_DB:
            raise AssertionError(f"{name}: PSNR kernels vs plain {p_kp:.2f}"
                                 f" dB < {MIN_PSNR_KERNEL_VS_PLAIN_DB}")
        copies = {w: c for w, c in k["kmajor_copies"].items()
                  if w != "int8_bmm" and c}
        if copies:
            raise AssertionError(f"{name}: the int8 GEMM made K-major "
                                 f"weight copies per call: {copies}")
        need = {"int8_matmul_pre": 1, "int8_conv2d": 1}
        if ldm_task:
            need["flash_fqk"] = 5 * steps
        for kern, least in need.items():
            if k["launches"].get(kern, 0) < least:
                raise AssertionError(f"{name}: {kern} launched "
                                     f"{k['launches'].get(kern, 0)} times, "
                                     f"expected >= {least}")
        out[name] = {"s": k["s"], "plain_s": p["s"],
                     "launches": k["launches"], "per_forward": per_fwd,
                     "psnr_kernel_vs_plain": p_kp if math.isfinite(p_kp)
                     else "bit-identical", "psnr_vs_fp": p_fp,
                     "kmajor_copies": k["kmajor_copies"],
                     "gemm_shapes": gemm_rows,
                     "profile": prof, "profile_s": prof_s}
    return out


def run() -> None:
    import torch

    with phase("device"):
        if not torch.cuda.is_available():
            raise RuntimeError("torch.cuda.is_available() is false: this "
                               "script needs an NVIDIA card")
        smi = nvidia_smi()
        print(smi, flush=True)
        kind = torch.cuda.get_device_name(0)
        peaks = next((v for k, v in CARD_PEAKS.items() if k in kind), None)
        if peaks is None:
            raise RuntimeError(f"{kind}: no entry in CARD_PEAKS, so no "
                               "bound can be computed")
        print(f"   python {sys.version.split()[0]}, torch "
              f"{torch.__version__}, CUDA {torch.version.cuda}", flush=True)
        from tfmq_dm_tpu_torch.ops import int4_kernels as K
        from tfmq_dm_tpu_torch.ops.nn import exact_f32
        exact_f32()
        dev = torch.device("cuda")

    with phase("build"):
        from concurrent.futures import ThreadPoolExecutor
        mods = kernel_modules()
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(mods)) as pool:  # one nvcc per source
            for fut in [pool.submit(m.build, True) for m in mods]:
                fut.result()
        print(f"   nvcc builds {time.perf_counter() - t0:.2f} s ("
              + ", ".join(f"{m.SOURCE.name} {m.BUILD_LOG['seconds']:.2f} s"
                          for m in mods) + ", in parallel)", flush=True)
        for mod in mods:
            for line in mod.BUILD_LOG["ptxas"].splitlines():
                if ("registers" in line or "Compiling entry" in line
                        or "spill" in line):
                    print("   " + line.strip(), flush=True)

    with phase("kernels"):
        from tfmq_dm_tpu_torch.configs.tasks import get_task
        from tfmq_dm_tpu_torch.models import ddim_unet
        cfg = ddim_unet.cifar10_config()
        convs, linears = cifar_geometries(cfg)
        g = torch.Generator().manual_seed(0)
        errs = {"int4_conv2d": [], "int4_linear": [], "flash_fp": [],
                "flash_pquant": [], "flash_int8": [], "flash_fqk": [],
                "int8_matmul_pre": [], "int8_matmul_fused": [],
                "gn_swish_quant_int8": []}
        conv_shapes = [(BATCH, r, k, ci, co) for (r, k, ci, co) in convs]
        conv_shapes += [(2, 5, 3, 20, 37), (1, 7, 1, 48, 10)]
        cin_convs, cin_linears = cin_geometries(get_task("cin256_v2").unet)
        conv_shapes += [(2 * CIN_N, r, k, ci, co)
                        for (r, k, ci, co) in cin_convs]
        sd_unet = get_task("sd_v1_4").unet
        sd_convs = cin_conv_counts(sd_unet)
        sd_linears = linear_counts(sd_unet)
        conv_shapes += [(2 * SD_N, r, k, ci, co)
                        for (r, k, ci, co) in sorted(sd_convs)]
        # phase uncond's geometries run the int4 kernels only (the int8
        # checks below keep to the other paths' shapes)
        uncond_geo = {name: uncond_geometries(get_task(name))
                      for name in UNCOND_TASKS}
        uncond_convs = sorted({(UNCOND_N, *key) for convs_, _ in
                               uncond_geo.values() for key in convs_})
        # phase text's paths: batch 1 x CFG
        text_geo = {name: (cin_conv_counts(get_task(name).unet),
                           linear_counts(get_task(name).unet))
                    for name in TEXT_TASKS}
        text_convs = sorted({(2 * TEXT_N, *key) for convs_, _ in
                             text_geo.values() for key in convs_})
        for (b, r, k, ci, co) in conv_shapes + uncond_convs + text_convs:
            case = conv_case(g, b, r, k, ci, co, dev)
            got = K.int4_conv2d(*case)
            check_close(f"int4_conv2d b{b} {r}x{r} {k}x{k} {ci}->{co}", got,
                        K.int4_conv2d_plain(*case), errs["int4_conv2d"],
                        depth=k * k * ci)
            if not torch.equal(got, K.int4_conv2d(*case)):
                raise AssertionError(f"int4_conv2d b{b} {r}x{r} {ci}->{co}: "
                                     "two calls differ (the split-K order "
                                     "is fixed)")
        lin_shapes = [(BATCH, k, n) for (k, n) in linears]
        lin_shapes += [(1, 512, 256), (3, 100, 37), (64, 512, 256)]
        lin_shapes += [(2 * CIN_N * m, k, n) for (m, k, n) in cin_linears]
        lin_shapes += [(2 * SD_N * m, k, n)
                       for (m, k, n) in sorted(sd_linears)]
        uncond_lins = sorted({(UNCOND_N * m, k, n) for _, lins in
                              uncond_geo.values() for (m, k, n) in lins})
        text_lins = sorted({(2 * TEXT_N * m, k, n) for _, lins in
                            text_geo.values() for (m, k, n) in lins})
        for (m, k, n) in lin_shapes + uncond_lins + text_lins:
            case = linear_case(g, m, k, n, dev)
            got = K.int4_linear(*case)
            check_close(f"int4_linear M{m} {k}->{n}", got,
                        K.int4_linear_plain(*case), errs["int4_linear"],
                        depth=k)
            if not torch.equal(got, K.int4_linear(*case)):
                raise AssertionError(f"int4_linear M{m} {k}->{n}: two calls "
                                     "differ (the split-K order is fixed)")
        check_flash(g, dev, errs)
        check_pquant16(g, dev, errs)
        check_int8(g, dev, errs, lin_shapes, conv_shapes)
        check_fqk(g, dev, errs)
        check_fused(g, dev, errs, lin_shapes)
        check_gn(g, dev, errs)

        print("   timing, ms per call (device: kernel / plain / library; "
              "kernel wall per eager call; bound):", flush=True)
        measured = {"conv_geometries": time_conv_geometries(
            g, dev, peaks, conv_geometry_cases(
                [("cifar10", BATCH, convs),
                 ("cin256", 2 * CIN_N,
                  cin_conv_counts(get_task("cin256_v2").unet)),
                 ("sd", 2 * SD_N, sd_convs)]
                + [(name, UNCOND_N, uncond_geo[name][0])
                   for name in UNCOND_TASKS]
                + [(name, 2 * TEXT_N, text_geo[name][0])
                   for name in TEXT_TASKS]))}
        for b, r, ci in ((64, 16, 256), (64, 32, 128), (BATCH, 32, 128),
                         (2 * CIN_N, 64, 192), (2 * CIN_N, 32, 384)):
            measured[("conv", b, r, ci)] = t = time_conv(
                conv_case(g, b, r, 3, ci, ci, dev), peaks)
            print(f"   int4_conv2d b{b} {r}x{r} 3x3 {ci}->{ci}: "
                  + timing_line(t)
                  + earlier_note(t, ("int4_conv2d", b, r, 3, ci, ci)),
                  flush=True)
        for m, k, n in timed_linear_shapes(cin_linears):
            measured[("linear", m, k, n)] = t = time_linear(
                linear_case(g, m, k, n, dev), peaks)
            print(f"   int4_linear M{m} {k}->{n}: " + timing_line(t)
                  + earlier_note(t, ("int4_linear", m, k, n)), flush=True)
        measured["sd_linears"], measured["sd_linear_per_forward"] = \
            time_linear_geometries(g, dev, peaks, "sd", 2 * SD_N,
                                   sd_linears)
        for name, batch, lins in (
                [(t, UNCOND_N, uncond_geo[t][1]) for t in UNCOND_TASKS]
                + [(t, 2 * TEXT_N, text_geo[t][1]) for t in TEXT_TASKS]):
            measured[f"{name} linears"], \
                measured[f"{name} linear_per_forward"] = \
                time_linear_geometries(g, dev, peaks, name, batch, lins)
        measured.update(time_flash(g, dev, peaks))
        sd_sites = flash_sites(sd_unet)
        for name, head in (("flash_int8", "8-bit p"), ("flash_fp", "f32")):
            grids = measured[name]["grids"]
            per = {key: sum(c * grids[f"sd {int(t ** 0.5)}x{int(t ** 0.5)} "
                                      f"{head}"][key]
                            for t, c in sd_sites.items())
                   for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
            measured[name]["sd_per_forward"] = per
            print(f"   {name} sd per forward ({sd_sites} launches by key "
                  "length): " + ", ".join(f"{k} {v:.4f}"
                                          for k, v in per.items()),
                  flush=True)
            measured[name]["path_per_forward"] = {}
            for task_name, label in PATH_FLASH.items():
                sites = sum(flash_sites(get_task(task_name).unet).values())
                tm = measured[name]["grids"][f"{label} {head}"]
                per = {key: sites * tm[key] for key in
                       ("ms", "plain_ms", "library_ms", "bound_ms")}
                measured[name]["path_per_forward"][task_name] = per
                print(f"   {name} {task_name} per forward ({sites} launches "
                      f"at {label}): " + ", ".join(
                          f"{k} {v:.4f}" for k, v in per.items()),
                      flush=True)
        measured["int8"] = time_int8(g, dev, peaks)
        measured["flash_fqk"] = time_fqk(g, dev, peaks)
        # no model path reaches these two: their launches are those of
        # their timing runs (the micro_gn twin's included)
        reset_all_counts()
        measured["int8_matmul_fused"] = time_fused(g, dev, peaks)
        measured["gn_swish_quant_int8"] = time_gn(dev, peaks)
        no_path = all_counts()
        for name in ("int8_matmul_fused", "gn_swish_quant_int8"):
            if not no_path[name] > 0:
                raise AssertionError(f"{name}: no launch in its timing runs")

    # checkpoints, artifacts and samples shared by the phases below
    tmp = Path(tempfile.mkdtemp(prefix="tfmq_chip_smoke_"))
    try:
        with phase("main"):
            main_path = drive_main_path(cfg, dev, tmp)
        with phase("recon"):
            rec = drive_recon_path(cfg, dev, tmp, main_path)
        with phase("ldm"):
            ldm = drive_ldm_path(dev, tmp)
        with phase("sd"):
            sd = drive_sd_path(dev, tmp)
        with phase("deploy"):
            dep = drive_deploy_path(dev, main_path, ldm, peaks)
        with phase("uncond"):
            unc = drive_uncond_path(dev, tmp, measured)
        with phase("text"):
            text = drive_text_path(dev, tmp, measured)
        with phase("samplers"):
            smp = drive_samplers_path(
                dev, tmp, main_path, str(tmp / "uncond" / "lsun_churches256"
                                         / "lsun_churches256_random.ckpt"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches = main_path["launches"]
    runs = ldm["runs"]
    check_conv_counts(measured["conv_geometries"], {
        "cifar10": (launches["int4_conv2d"], STEPS),
        "cin256": (runs["deployed"]["launches"]["int4_conv2d"],
                   ldm["steps"]),
        "sd": (sd["runs"]["deployed"]["launches"]["int4_conv2d"],
               sd["forwards"]),
        **{name: (unc[name]["runs"]["deployed"]["launches"]["int4_conv2d"],
                  UNCOND_STEPS) for name in UNCOND_TASKS},
        "txt2img_1p4b": (text["txt2img_1p4b"]["runs"]["deployed"]["launches"]
                         ["int4_conv2d"], TEXT_STEPS),
        "text2img_256": (text["text2img_256"]["runs"]["recon"]["launches"]
                         ["int4_conv2d"], TEXT_STEPS)})
    sd_runs = sd["runs"]

    def launches_text(kern):
        return {t: {r: v["launches"][kern] for r, v in text[t]["runs"]
                    .items()} for t in TEXT_TASKS}

    def launches_samplers(kern):
        c10, ch = smp["cifar10"], smp["lsun_churches256"]
        by_run = {"cifar10 ddpm": c10["launches"],
                  "cifar10 x0 trace": c10["x0_trace"]["launches"],
                  **{f"lsun_churches256 {r}": ch[r]["launches"]
                     for r, _ in DPM_RUNS},
                  "lsun_churches256 adaptive": ch["adaptive"]["launches"],
                  "lsun_churches256 harvest": ch["harvest_launches"]}
        return {r: c.get(kern, 0) for r, c in by_run.items()}

    tc = measured[("conv", BATCH, 32, 128)]
    tl = measured[("linear", BATCH, 512, 256)]
    fqk = measured["flash_fqk"]
    flash_rows = [
        ("flash_fp", "tfmq_dm_tpu/ops/flash_attention.py:79", "fp",
         "fp", "q/k/v f32"),
        ("flash_pquant", "tfmq_dm_tpu/ops/flash_attention.py:109",
         "pquant", "softmax16", "q/k/v f32, 8-bit softmax grid"),
        ("flash_int8", "tfmq_dm_tpu/ops/flash_attention.py:291", "int8",
         "deployed", "q/k/v int8 codes, 8-bit softmax grid")]
    _, bh, t_cin, _, d_cin = FLASH_SHAPES[0]
    cin_dep = dep["cin256_v2 bf16"]
    report = {"kernels": [
        {"name": "int4_conv2d", "route": "cuda",
         "source": "tfmq_dm_tpu_torch/csrc/int4_kernels.cu",
         "replaces": "tfmq_dm_tpu/ops/pallas_kernels.py:548",
         "tpu": "int4_conv2d_dequant",
         "shape": f"x ({BATCH},32,32,128) bf16, 3x3 128->128",
         "launches": launches["int4_conv2d"],
         "launches_cin256": runs["deployed"]["launches"]["int4_conv2d"],
         "launches_sd": sd_runs["deployed"]["launches"]["int4_conv2d"],
         "launches_uncond": {
             name: unc[name]["runs"]["deployed"]["launches"]["int4_conv2d"]
             for name in UNCOND_TASKS},
         "launches_text": launches_text("int4_conv2d"),
         "launches_samplers": launches_samplers("int4_conv2d"),
         "max_abs_err": max(errs["int4_conv2d"]), **tc,
         "cin256": measured[("conv", 2 * CIN_N, 64, 192)],
         "geometries": measured["conv_geometries"]},
        {"name": "int4_linear", "route": "cuda",
         "source": "tfmq_dm_tpu_torch/csrc/int4_kernels.cu",
         "replaces": "tfmq_dm_tpu/ops/pallas_kernels.py:275",
         "tpu": "int4_matmul_dequant",
         "shape": f"x ({BATCH},512) f32, 512->256",
         "launches": launches["int4_linear"],
         "launches_cin256": runs["deployed"]["launches"]["int4_linear"],
         "launches_sd": sd_runs["deployed"]["launches"]["int4_linear"],
         "sd_per_forward": measured["sd_linear_per_forward"],
         "sd_shapes": measured["sd_linears"],
         "launches_uncond": {
             name: unc[name]["runs"]["deployed"]["launches"]["int4_linear"]
             for name in UNCOND_TASKS},
         "uncond_per_forward": {
             name: measured[f"{name} linear_per_forward"]
             for name in UNCOND_TASKS},
         "launches_text": launches_text("int4_linear"),
         "launches_samplers": launches_samplers("int4_linear"),
         "text_per_forward": {
             name: measured[f"{name} linear_per_forward"]
             for name in TEXT_TASKS},
         "max_abs_err": max(errs["int4_linear"]), **tl,
         "cin256": measured[("linear", 2 * CIN_N * 1024, 384, 3072)],
         "shapes": [{"shape": list(key[1:]), **v}
                    for key, v in measured.items() if key[0] == "linear"]},
    ] + [
        {"name": name, "route": "cuda",
         "source": "tfmq_dm_tpu_torch/csrc/flash_attention.cu",
         "replaces": where, "tpu": f"flash_attention mode {mode}",
         "shape": f"(B*H {bh}, T {t_cin}, D {d_cin}), {what}",
         "launches": runs[run_name]["launches"][name],
         "launches_path": f"cin256 cli.main {run_name}",
         "launches_sd": sd_runs[run_name]["launches"][name]
         if run_name in sd_runs else None,
         "launches_uncond": {
             t: unc[t]["runs"][run_name]["launches"][name]
             for t in UNCOND_FLASH if run_name in unc[t]["runs"]} or None,
         "launches_text": launches_text(name),
         "launches_samplers": launches_samplers(name),
         "max_abs_err": max(errs[name]), **measured[name]}
        for name, where, mode, run_name, what in flash_rows] + [
        {"name": "int8_matmul_pre", "route": "cuda",
         "source": "tfmq_dm_tpu_torch/csrc/int8_kernels.cu",
         "replaces": "tfmq_dm_tpu/ops/pallas_kernels.py:166",
         "tpu": "int8_matmul_pre",
         "shape": f"x ({2 * CIN_N * 1024},384) int8 codes, 384->3072, "
                  "bf16 out",
         "launches": cin_dep["launches"]["int8_matmul_pre"],
         "launches_path": "cin256 cli.main --int-kernels --deploy_dtype "
                          "bfloat16",
         "launches_int8_conv2d": cin_dep["launches"]["int8_conv2d"],
         "launches_per_forward": cin_dep["per_forward"],
         "max_abs_err": max(errs["int8_matmul_pre"]),
         **measured["int8"]["linear"],
         "conv_gemm": measured["int8"]["conv_gemm"],
         "conv_total": measured["int8"]["conv_total"],
         "gemm_shapes": {cfg_name: v["gemm_shapes"]
                         for cfg_name, v in dep.items()}},
        {"name": "flash_fqk", "route": "cuda",
         "source": "tfmq_dm_tpu_torch/csrc/flash_attention.cu",
         "replaces": "tfmq_dm_tpu/ops/flash_attention.py:175",
         "tpu": "flash_attention mode fqk",
         "launches": cin_dep["launches"]["flash_fqk"],
         "launches_path": "cin256 cli.main --int-kernels --deploy_dtype "
                          "bfloat16",
         "max_abs_err": max(errs["flash_fqk"]),
         **fqk[("cin256", "p levels")],
         "modes": {f"{label} {mode}": tm for (label, mode), tm in fqk.items()
                   if (label, mode) != ("cin256", "p levels")}},
        {"name": "int8_matmul_fused", "route": "cuda",
         "source": "tfmq_dm_tpu_torch/csrc/int8_kernels.cu",
         "replaces": "tfmq_dm_tpu/ops/pallas_kernels.py:76",
         "tpu": "int8_matmul_fused",
         "shape": f"x ({2 * CIN_N * 1024},384) bf16, 384->3072, bf16 out",
         "launches": no_path["int8_matmul_fused"],
         "launches_path": NO_MODEL_PATH,
         "max_abs_err": max(errs["int8_matmul_fused"]),
         **measured["int8_matmul_fused"]},
        {"name": "gn_swish_quant_int8", "route": "cuda",
         "source": "tfmq_dm_tpu_torch/csrc/gn_kernels.cu",
         "replaces": "tfmq_dm_tpu/ops/pallas_kernels.py:431",
         "tpu": "gn_swish_quant_int8",
         "launches": no_path["gn_swish_quant_int8"],
         "launches_path": NO_MODEL_PATH,
         "max_abs_err": max(errs["gn_swish_quant_int8"]),
         "max_abs_err_unit": "int8 levels",
         **measured["gn_swish_quant_int8"][0],
         "micro_gn": measured["gn_swish_quant_int8"][1:]}]}
    print(json.dumps({"e2e_s": main_path["e2e_s"], "images": BATCH,
                      "steps": STEPS, "psnr_kernel_vs_plain_db":
                      main_path["psnr_kernel_vs_plain"],
                      "psnr_quant_vs_fp_db": main_path["psnr_quant_vs_fp"],
                      "psnr_init_only_vs_fp_db":
                          main_path["psnr_init_only_vs_fp"],
                      "calibration_s": main_path["cali_s"],
                      "calibration": {"cali_n": CALI_N,
                                      "iters": CALI_ITERS,
                                      **main_path["recon"]}}),
          flush=True)
    print(json.dumps({"recon": rec}), flush=True)
    print(json.dumps({"ldm": {
        "task": "cin256_v2", "images": CIN_N,
        "e2e_s": {k: v["s"] for k, v in runs.items()},
        "psnr_latents_kernel_vs_plain_db":
            ldm["psnr_latents_kernel_vs_plain"],
        "psnr_images_kernel_vs_plain_db":
            ldm["psnr_images_kernel_vs_plain"],
        "psnr_quant_vs_fp_db": ldm["psnr_quant_vs_fp"],
        "calibration": ldm["calibration"],
        "psnr_latents_recon_kernel_vs_plain_db":
            ldm["psnr_latents_recon_kernel_vs_plain"],
        "psnr_latents_recon_vs_fp_db": ldm["psnr_latents_recon_vs_fp"],
        "forward_max_rel": ldm["forward_max_rel"],
        "forward_mean_rel": ldm["forward_mean_rel"],
        "forward_noise_mean_rel": ldm["noise_mean_rel"],
        "profile": ldm["profile"]}}), flush=True)
    print(json.dumps({"sd": {
        "task": "sd_v1_4", "images": SD_N, "steps": sd["steps"],
        "e2e_s": {k: v["s"] for k, v in sd["runs"].items()},
        "launches_walk": sd["walk"],
        "psnr_latents_kernel_vs_plain_db":
            sd["psnr_latents_kernel_vs_plain"],
        "psnr_images_kernel_vs_plain_db": sd["psnr_images_kernel_vs_plain"],
        "psnr_latents_quant_vs_fp_db": sd["psnr_latents_quant_vs_fp"],
        "psnr_quant_vs_fp_db": sd["psnr_quant_vs_fp"],
        "calibration": sd["calibration"],
        "psnr_latents_recon_kernel_vs_plain_db":
            sd["psnr_latents_recon_kernel_vs_plain"],
        "psnr_latents_recon_vs_fp_db": sd["psnr_latents_recon_vs_fp"],
        "forward_max_rel": sd["forward_max_rel"],
        "forward_mean_rel": sd["forward_mean_rel"],
        "forward_noise_mean_rel": sd["noise_mean_rel"],
        "profile": sd["profile"]}}), flush=True)
    print(json.dumps({"uncond": {
        name: {**rec, "steps": UNCOND_STEPS, "images": UNCOND_N}
        for name, rec in unc.items()}}), flush=True)
    print(json.dumps({"text": {
        name: {**rec, "steps": TEXT_STEPS, "images": TEXT_N}
        for name, rec in text.items()}}), flush=True)
    print(json.dumps({"samplers": smp}), flush=True)
    print(json.dumps({"deploy": {
        k: {f: x for f, x in v.items() if f != "gemm_shapes"}
        for k, v in dep.items()}}), flush=True)
    print(json.dumps(report), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def main() -> int:
    try:
        run()
    except Exception:  # noqa: BLE001 - any failure: report, exit non-zero
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr, flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
