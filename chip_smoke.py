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
              (batch 8) and cin256 (batch 2 x CFG) int4-serving paths plus
              odd shapes, the same geometries on the int8 GEMM
              (``int8_matmul_pre``, and the int8 conv on its im2col, sym
              and asym grids), and the four flash-attention kernels at the
              cin256 and SD shapes (fqk with and without the softmax
              quantizer, with int8_pv, over two key blocks), the fused
              int8 GEMM (``int8_matmul_fused``) on the linear geometries
              and the fused GroupNorm + SiLU + int8 quantization
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
              walk of the model's layers, held after phase 5 against the
              launches the int4-serving runs counted) and the
              launch-weighted sums per forward (``int4_conv2d`` is
              also checked for two bit-identical calls: split K adds its
              partial sums in a fixed order),
              ``int4_linear`` at every distinct cin256 geometry and
              CIFAR-10's, ``flash_fqk`` in its three modes, ``flash_fp``,
              ``flash_pquant`` (8- and 16-bit softmax grids) and
              ``flash_int8`` (with and without the softmax quantizer) at
              cin256 and SD's 64x64 (the f32 kernels also beside SDPA on
              their f32 operands), each printed beside its earlier
              design's device time where one was taken (``EARLIER_MS``;
              not in the
              ``kernels`` line, which holds this run's numbers only).
              No model path of the JAX package reaches the last two
              kernels (tests and ``scripts/micro_gn.py`` only): their
              launches are counted over this phase's timing runs, which
              include the port's twin of ``scripts/micro_gn.py``.
4. main     - the full-width CIFAR-10 w4a8 int4-serving path: the port's
              CLI calibrates the trained weights of runs/cifar10_ddpm.npz
              on the card (``cli.main --ptq --cali``: a 10-step harvest of
              16 samples a step, TIAR/AdaRound reconstruction of all 32
              units with ``CALI_ITERS`` iterations each, running-stat FSC,
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
5. ldm      - the full-width class-conditional LDM (cin256_v2) w4a8
              int4-serving path: a seeded random-init checkpoint in the
              reference's Lightning layout (UNet, VQ-f4 decoder, class
              embedding) in a temporary directory, a 20-step calibration
              harvest at batch 2 x CFG (flash fp), the FSC init pass, then
              ``cli.main`` samples 2 images in 20 DDIM steps with the int4
              and flash int8 kernels; the same with the plain versions and
              in FP; one deployed UNet forward, kernels against plain
              versions; and a 4-step sample with a 16-bit softmax grid
              (flash pquant). Launch counts are read around each run.
6. deploy   - the int8 and bf16 deployments through ``cli.main``: cin256_v2
              ``--int-kernels --deploy_dtype bfloat16`` (20 steps, the ldm
              phase's checkpoint and artifact; fqk, int8_matmul_pre and the
              int8 conv), the CIFAR-10 bench configuration (w4a8
              ``--w_sym``, int8 deploy, bf16) and CIFAR-10 exact w8a8
              (f32), calibrated in phase main. Each runs with the kernels
              and with the plain versions on the same noise (PSNR >= 30 dB:
              cin256 latents, CIFAR images), with launch counts read around
              the run and around one UNet forward, PSNR against the FP
              sample (information) and the device-busy share of a
              profiled sample.

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

from tfmq_dm_tpu_torch.utils.timing import device_ms, wall_ms  # noqa: E402

PHASE_BUDGET_S = {"device": 60, "build": 180, "kernels": 240, "main": 180,
                  "ldm": 420, "deploy": 360}

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
# phase main's calibration through the CLI: samples a step (at least the
# FSC running-stat pass's batch of 16, so that the pass runs) and
# reconstruction iterations a unit
CALI_N, CALI_ITERS = 16, 300
NO_MODEL_PATH = ("no model path (JAX: tests/test_pallas_kernels.py, "
                 "scripts/micro_gn.py); launches of the kernels phase's "
                 "timing runs, the micro_gn twin's included")
# cin256 images per batch (the UNet sees twice as many: CFG)
CIN_N = 2


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

    run_once()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_once()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run_once()
        torch.cuda.synchronize()
    # device-side events only: the CPU-side op entries repeat their
    # kernels' time
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)
    busy_ms = sum(r[0] for r in rows)
    print(f"   profile: {label} {wall:.2f} ms wall (unprofiled), device "
          f"busy {busy_ms:.2f} ms ({100 * busy_ms / wall:.1f}%); kernels "
          "by device time:", flush=True)
    for ms, count, key in rows[:top]:
        print(f"     {ms:9.3f} ms  {100 * ms / busy_ms:5.1f}%  x{count:<5d} "
              f"{key[:70]}", flush=True)
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


def check_calibration(cfg, art: str, dev) -> dict:
    """Read the CLI's artifact: per-unit losses and guard decisions, an
    alpha for every layer that reconstruction trains, at least one unit on
    its trained alphas, and an FSC state for every step."""
    from tfmq_dm_tpu_torch.models import ddim_units
    from tfmq_dm_tpu_torch.quant.calibrate import load_cali_model

    wstate, astate, meta = load_cali_model(art, device=dev)
    units = meta["recon"]["units"]
    for name, u in units.items():
        print(f"   recon {name:24s} loss {u['loss_first']:.6f} -> "
              f"{u['loss_last']:.6f}; hard loss nearest "
              f"{u['hard_nearest']:.6f}, trained {u['hard_trained']:.6f}: "
              f"keep {u['kept']}", flush=True)
    kept = sum(u["kept"] == "trained" for u in units.values())
    print(f"   guard: {kept} of {len(units)} units kept their trained "
          f"alphas, {len(units) - kept} reverted to nearest rounding",
          flush=True)
    adapter = ddim_units.build_adapter(cfg, w_bits=4, a_bits=8)
    trained = [full for u in adapter.units for role, full in u.layers
               if role in adapter.default_train_roles(u)]
    missing = [n for n in trained if "alpha" not in wstate.get(n, {})]
    if missing or len(units) != 32:
        raise AssertionError(f"reconstruction: {len(units)} units, no "
                             f"alpha for {missing}")
    if kept == 0:
        raise AssertionError("the guard reverted every unit: no trained "
                             "alpha reached the artifact")
    groups = {st["delta"].shape[0] for st in astate.values()}
    if groups != {len(meta["cali_t"])}:
        raise AssertionError(f"FSC groups {groups}, expected "
                             f"{len(meta['cali_t'])}")
    return {"units": len(units), "kept_trained": kept,
            "layers_with_alpha": len(trained)}


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
                   "--timesteps", str(steps), "--cali_n", str(CALI_N),
                   "--interval_length", "1", "--cali_iters",
                   str(CALI_ITERS), "--cali_save_path", art, "--seed",
                   str(SEED), "--device", dev.type])
    sync(dev)
    cali_s = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"cli.main --cali returned {rc}")
    print(f"   cli.main --ptq --cali (harvest {steps} steps x {CALI_N}, "
          f"reconstruction of every unit at {CALI_ITERS} iterations, "
          f"running-stat FSC): {cali_s:.2f} s", flush=True)
    recon = check_calibration(cfg, art, dev)

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
                         steps)
    return {"launches": launches, "e2e_s": e2e_s, "plain_s": plain_s,
            "fp_s": fp_s, "psnr_kernel_vs_plain": p_kp,
            "psnr_quant_vs_fp": p_qf, "psnr_init_only_vs_fp": p_init,
            "cali_s": cali_s, "recon": recon, "arts": arts,
            "ckpt": str(ckpt), "fp_img": fp}


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
    res, counts = cfg.image_size, {}
    for kind, name, shape in ldm_unet.iter_layers(cfg):
        if kind == "conv_ds":
            res //= 2
            continue
        if kind == "conv" and name.endswith(".conv"):    # an Upsample's
            res *= 2
        if kind == "conv" and name in quantized:
            key = (res, shape[0], shape[2], shape[3])
            counts[key] = counts.get(key, 0) + 1
    return counts


def conv_geometry_cases(cifar_counts, cin_counts) -> list:
    """(path, batch, res, k, cin, cout, launches per forward) of every
    distinct packed conv of the two int4-serving paths: CIFAR-10 at batch
    8, cin256 at batch 2 x CFG."""
    return [("cifar10", BATCH, *key, c) for key, c in
            sorted(cifar_counts.items())] + \
        [("cin256", 2 * CIN_N, *key, c) for key, c in
         sorted(cin_counts.items())]


def time_conv_geometries(g, dev, peaks, cases) -> list:
    """``int4_conv2d`` and cuDNN's bf16 conv (weights dequantized ahead of
    time) at every conv geometry of both int4-serving paths, device ms
    per call beside the bound and the launches per forward; then the
    launch-weighted sums per forward of each path (the plain version is
    not timed here)."""
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
               "library_ms": device_ms(lambda: F.conv2d(xn, wd, bd,
                                                        padding=p)),
               "bound_ms": max(t_ops, t_bytes),
               "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
        e = EARLIER_MS.get(("int4_conv2d", b, r, k, ci, co))
        rows.append(row)
        print(f"   int4_conv2d {path} b{b} {r}x{r} {k}x{k} {ci}->{co} "
              f"x{per_fwd}: {row['ms']:.4f} / cuDNN {row['library_ms']:.4f}"
              f"; bound {row['bound_ms']:.6f} ({row['bound_by']}); plan "
              f"{row['plan']}" + ("" if e is None else
                                  f"; earlier design {e:.4f} "
                                  f"({e / row['ms']:.2f}x this)"),
              flush=True)
        del case, x, wp, wd, xn
    for path in ("cifar10", "cin256"):
        sel = [x for x in rows if x["path"] == path]

        def wsum(key, sel=sel):
            return sum(x[key] * x["launches_per_forward"] for x in sel)
        line = (f"   int4_conv2d {path} per forward "
                f"({sum(x['launches_per_forward'] for x in sel)} launches):"
                f" kernel {wsum('ms'):.4f} ms, cuDNN "
                f"{wsum('library_ms'):.4f}, bound {wsum('bound_ms'):.4f}")
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
# its 64x64, 32x32 and 16x16 latents; ragged T; Tk != Tq
FLASH_SHAPES = [("cin256", 4, 1024, 1024, 384),
                ("sd 64x64", 16, 4096, 4096, 40),
                ("sd 32x32 d40", 16, 1024, 1024, 40),
                ("sd 32x32", 16, 1024, 1024, 80),
                ("sd 16x16", 16, 256, 256, 160),
                ("ragged", 4, 100, 100, 40), ("ragged", 4, 130, 130, 40),
                ("tk != tq", 2, 130, 77, 64)]
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
    """Each flash kernel at the cin256 shape (B*H 4, T 1024, D 384) and at
    SD's 64x64 (B*H 16, T 4096, D 40): the kernel, its plain version and
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
    for label, bh, t, _, d in (FLASH_SHAPES[0], FLASH_SHAPES[1]):
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


def make_ldm_checkpoint(path: str, task, dev, n_classes: int,
                        seed: int = 0) -> None:
    """A seeded random-init checkpoint of a class-conditional LDM task in
    the reference's Lightning layout: UNet, VQ decoder with codebook, and
    the class embedding (cin256_v2: 1001 x 512), through the port's
    export."""
    import torch
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
    sd["cond_stage_model.embedding.weight"] = torch.randn(
        (n_classes, task.unet.context_dim), generator=g, device=dev).cpu()
    torch.save({"state_dict": sd}, path)


def drive_ldm_path(dev, tmp: Path, steps: int = 20,
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

    common = ["--task", task_name, "--ckpt", ckpt, "--classes", "1,2",
              "-n", str(n), "--batch", str(n), "--seed", str(SEED),
              "--device", "cuda"]
    quant = ["--ptq", "--cali_ckpt", arts[8], "--use_aq",
             "--int-kernels", "--int4-serving"]
    runs = {}

    def run(name, argv, plain=False):
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
        lat = np.load(tmp / name / "latents.npy")
        if img.shape != (n, img_res, img_res, 3) or \
                not np.all(np.isfinite(img)):
            raise AssertionError(f"{name}: bad images {img.shape}")
        if img.min() < 0 or img.max() > 1:
            raise AssertionError(f"{name}: images outside [0, 1]")
        print(f"   cli.main {name} ({n} images x CFG; load + deploy + "
              f"sample + decode): {sec:.2f} s; launches {counts}",
              flush=True)
        runs[name] = {"s": sec, "launches": counts, "img": img,
                      "lat": lat}

    run("deployed", common + quant + ["--timesteps", str(steps)])
    run("plain", common + quant + ["--timesteps", str(steps)],
        plain=True)
    run("fp", common + ["--timesteps", str(steps)])
    run("softmax16", common + ["--ptq", "--cali_ckpt", arts[16],
                               "--use_aq", "--int-kernels",
                               "--int4-serving", "--softmax_a_bit",
                               "16", "--timesteps", str(pq_steps)])
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
        common + quant + ["--timesteps", str(steps), "--out", "-"])
    params, _, cond = load_ldm_checkpoint(ckpt, task, device=dev)
    sampler_fn, sample_t = ptq.make_schedule(task, steps=steps)
    fn = cli.build_ldm_model_fn(args, task, params, cond, sample_t, dev)
    x = torch.randn((n, res, res, task.unet.in_channels),
                    generator=torch.Generator().manual_seed(5)).to(dev)
    t = torch.full((n,), int(sample_t[0]), dtype=torch.int32,
                   device=dev)
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
    prof = profile_device(lambda: sampler_fn(fn, x),
                          f"{task_name} {steps}-step deployed sample "
                          f"(batch {n} x CFG, no decode)", top=12)
    return {"runs": {k: {"s": v["s"], "launches": v["launches"]}
                     for k, v in runs.items()},
            "psnr_latents_kernel_vs_plain": p_lat,
            "psnr_images_kernel_vs_plain": p_img,
            "psnr_quant_vs_fp": p_qf, "forward_max_rel": f_max,
            "forward_mean_rel": f_mean, "noise_mean_rel": n_mean,
            "profile": prof, "ckpt": ckpt, "art": arts[8], "steps": steps,
            "fp_lat": runs["fp"]["lat"], "fp_img": runs["fp"]["img"]}


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
                      cin_steps: int = 20) -> dict:
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
            sampler_fn, sample_t = ptq.make_schedule(task, steps=cin_steps)
            fn = cli.build_ldm_model_fn(args, task, params, cond, sample_t,
                                        dev)
            x = torch.randn((n, res, res, task.unet.in_channels),
                            generator=torch.Generator().manual_seed(5)
                            ).to(dev)
            t = torch.full((n,), int(sample_t[0]), dtype=torch.int32,
                           device=dev)
            per_fwd, shapes = forward_counts(fn, (x, t, 0))
            prof = profile_device(lambda: sampler_fn(fn, x),
                                  f"{name} {cin_steps}-step sample (batch "
                                  f"{n} x CFG, no decode)", top=10)
            steps = cin_steps
        else:
            cfg = ddim_unet.cifar10_config()
            params, _ = load_params(main_path["ckpt"], device=dev)
            betas, seq = cli.cifar10_schedule(STEPS)
            fn = cli.build_model_fn(args, params, cfg, seq[::-1], dev)
            x = torch.randn((BATCH, 32, 32, 3),
                            generator=torch.Generator().manual_seed(3)
                            ).to(dev)
            t = torch.full((BATCH,), int(seq[-1]), dtype=torch.int32,
                           device=dev)
            per_fwd, shapes = forward_counts(fn, (x, t, 0))
            prof = profile_device(lambda: generalized_scan(fn, betas, seq, x),
                                  f"{name} {STEPS}-step sample (batch "
                                  f"{BATCH})", top=8)
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
        for (b, r, k, ci, co) in conv_shapes:
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
        for (m, k, n) in lin_shapes:
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
                convs, cin_conv_counts(get_task("cin256_v2").unet)))}
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
        measured.update(time_flash(g, dev, peaks))
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
        with phase("ldm"):
            ldm = drive_ldm_path(dev, tmp)
        with phase("deploy"):
            dep = drive_deploy_path(dev, main_path, ldm, peaks)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches = main_path["launches"]
    runs = ldm["runs"]
    check_conv_counts(measured["conv_geometries"], {
        "cifar10": (launches["int4_conv2d"], STEPS),
        "cin256": (runs["deployed"]["launches"]["int4_conv2d"],
                   ldm["steps"])})
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
    print(json.dumps({"ldm": {
        "task": "cin256_v2", "images": CIN_N,
        "e2e_s": {k: v["s"] for k, v in runs.items()},
        "psnr_latents_kernel_vs_plain_db":
            ldm["psnr_latents_kernel_vs_plain"],
        "psnr_images_kernel_vs_plain_db":
            ldm["psnr_images_kernel_vs_plain"],
        "psnr_quant_vs_fp_db": ldm["psnr_quant_vs_fp"],
        "forward_max_rel": ldm["forward_max_rel"],
        "forward_mean_rel": ldm["forward_mean_rel"],
        "forward_noise_mean_rel": ldm["noise_mean_rel"],
        "profile": ldm["profile"]}}), flush=True)
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
