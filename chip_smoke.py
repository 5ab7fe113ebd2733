#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (tfmq_dm_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each with a time budget (the script raises and exits non-zero
when one is exceeded):

1. device   - a CUDA card must be present; prints its name and power limit.
2. build    - compiles the packed-int4 CUDA kernels cold (nvcc, sm_90a).
3. kernels  - every distinct CIFAR-10 conv and linear geometry of the
              int4-serving path (batch 8) plus odd shapes: each CUDA kernel
              against its plain PyTorch version on the same inputs; then
              times kernel, plain version and one PyTorch library call on
              the device (calls captured in a CUDA graph), and the kernel's
              wall time per eager call, beside the card's bound.
4. main     - the full-width CIFAR-10 w4a8 int4-serving path: trained
              weights from runs/cifar10_ddpm.npz, minmax weight grids, a
              10-step calibration harvest at batch 8, the FSC init pass,
              a calibration artifact in a temporary directory, then the
              port's CLI (``cli.main``) samples 8 images in 10 DDIM steps
              with the packed-int4 kernels; launch counts are read around
              that call. The same sampling with the plain versions gives
              the kernel-vs-plain PSNR; the FP sampling gives the
              quantized-vs-FP PSNR (information only).

Prints a ``{"kernels": [...]}`` JSON line, the card's name and power limit,
and last ``{"ok": true, "device": {...}}``. Any failure exits non-zero
without those lines.
"""

from __future__ import annotations

import contextlib
import json
import math
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

PHASE_BUDGET_S = {"device": 60, "build": 180, "kernels": 180, "main": 420}

# kernel vs plain version: they round at the same points and differ only
# in how the f32 sums are taken (K up to 9*512); the conv's tensor cores
# do not round to nearest after every addition (measured up to 6.6e-6 on
# an H100 at K = 4608). Limit relative to the output's largest magnitude.
KERNEL_REL_TOL = 2e-5
# deployed sampling, kernels vs plain versions on the card: summation
# order flips an occasional bf16 / 8-bit activation rounding
MIN_PSNR_KERNEL_VS_PLAIN_DB = 30.0

# dense bf16 tensor-core peak and HBM rate (NVIDIA data sheet, SXM part)
CARD_PEAKS = {"H100": (989e12, 3.35e12)}

STEPS, BATCH, SEED = 10, 8, 1234


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


def wall_ms(fn, iters: int = 20) -> float:
    """Wall time per eager call, back to back: host work (argument checks,
    allocation, launch) included."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def device_ms(fn, iters: int = 20) -> float:
    """Device time per call: ``iters`` calls captured in one CUDA graph,
    replayed and timed with CUDA events, so no host work is counted."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):       # warm-up off the capture
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (3 * iters)
    del graph
    return ms


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


def check_close(label, got, ref, errors):
    import torch
    torch.cuda.synchronize()
    scale = max(1.0, float(ref.abs().max()))
    err = float((got - ref).abs().max())
    print(f"   {label:48s} max_abs_err {err:.3e}  max_rel_err "
          f"{err / scale:.3e}", flush=True)
    if not (err <= KERNEL_REL_TOL * scale):
        raise AssertionError(f"{label}: kernel disagrees with its plain "
                             f"version ({err:.3e} > {KERNEL_REL_TOL} * "
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


def timings(kernel, plain, library, flops, nbytes, peaks) -> dict:
    """Device ms per call of the kernel, its plain version and the library
    call; the kernel's wall ms per eager call; the bound: the larger of the
    operations over the bf16 peak and the bytes over the memory rate."""
    t_ops, t_bytes = flops / peaks[0] * 1e3, nbytes / peaks[1] * 1e3
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
    """Route the deployed layers to the plain versions (on the card), for
    the kernel-vs-plain comparison of the whole sampler."""
    from tfmq_dm_tpu_torch.ops import int4_kernels as K
    saved = K.int4_linear, K.int4_conv2d
    K.int4_linear, K.int4_conv2d = K.int4_linear_plain, K.int4_conv2d_plain
    try:
        yield
    finally:
        K.int4_linear, K.int4_conv2d = saved


def sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize()


def profile_sampling(cfg, dev, argv: list, steps: int) -> dict:
    """Device time by kernel over one deployed sample (batch 8, ``steps``
    DDIM steps) under torch.profiler, after a warm-up sample. The model is
    built by the CLI from the same arguments as the sampling run."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from tfmq_dm_tpu_torch import cli
    from tfmq_dm_tpu_torch.convert import load_params
    from tfmq_dm_tpu_torch.samplers.ddim import generalized_scan

    args = cli.build_argparser().parse_args(argv)
    params, _ = load_params(args.ckpt, device=dev)
    betas, seq = cli.cifar10_schedule(steps)
    fn = cli.build_model_fn(args, params, cfg, seq[::-1], dev)
    x = torch.randn((BATCH, 32, 32, 3),
                    generator=torch.Generator().manual_seed(3)).to(dev)
    generalized_scan(fn, betas, seq, x)
    sync(dev)
    t0 = time.perf_counter()
    generalized_scan(fn, betas, seq, x)
    sync(dev)
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        generalized_scan(fn, betas, seq, x)
        sync(dev)
    # device-side events only: the CPU-side op entries repeat their
    # kernels' time
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)
    busy_ms = sum(r[0] for r in rows)
    print(f"   profile: {steps}-step sample {wall_ms:.2f} ms wall "
          f"(unprofiled), device busy {busy_ms:.2f} ms "
          f"({100 * busy_ms / wall_ms:.1f}%); kernels by device time:",
          flush=True)
    for ms, count, key in rows[:8]:
        print(f"     {ms:9.3f} ms  {100 * ms / busy_ms:5.1f}%  x{count:<5d} "
              f"{key[:70]}", flush=True)
    return {"wall_ms": wall_ms, "busy_ms": busy_ms}


def drive_main_path(cfg, dev, steps: int = STEPS) -> dict:
    """Calibrate the full-width model on the card, then sample through the
    port's CLI with the packed-int4 kernels; launch counts are read around
    that one call. Returns counts, seconds and PSNRs."""
    import numpy as np
    import torch
    from tfmq_dm_tpu_torch import cli
    from tfmq_dm_tpu_torch.convert import load_params
    from tfmq_dm_tpu_torch.models import ddim_unet, ddim_units
    from tfmq_dm_tpu_torch.ops import int4_kernels as K
    from tfmq_dm_tpu_torch.quant.calibrate import cali_model
    from tfmq_dm_tpu_torch.samplers.ddim import harvest_trajectory

    tmp = Path(tempfile.mkdtemp(prefix="tfmq_chip_smoke_"))
    try:
        ckpt = ROOT / "runs" / "cifar10_ddpm.npz"
        t0 = time.perf_counter()
        params, _ = load_params(str(ckpt), device=dev)
        adapter = ddim_units.build_adapter(cfg, w_bits=4, a_bits=8)
        betas, seq = cli.cifar10_schedule(steps)
        x_cali = torch.randn((BATCH, 32, 32, 3),
                             generator=torch.Generator().manual_seed(1))
        xs, ts = harvest_trajectory(
            lambda x, t, s: ddim_unet.apply(params, cfg, x, t), betas, seq,
            x_cali.to(dev))
        art = str(tmp / "cali.npz")
        cali_model(adapter, params, (xs, ts),
                   torch.Generator().manual_seed(2), path=art,
                   w_scaler="minmax", act_scaler="minmax", init_samples=BATCH,
                   meta={"wq": 4, "aq": 8,
                         "cali_t": [float(v) for v in seq[::-1]]})
        sync(dev)
        print(f"   calibration (harvest {steps} steps x {BATCH}, FSC init): "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        del params, xs, ts

        common = ["--task", "cifar10", "--ckpt", str(ckpt), "--timesteps",
                  str(steps), "-n", str(BATCH), "--batch", str(BATCH),
                  "--seed", str(SEED), "--device", dev.type]
        quant = ["--ptq", "--cali_ckpt", art, "--use_aq", "--int-kernels",
                 "--int4-serving"]
        K.reset_launch_counts()
        t0 = time.perf_counter()
        rc = cli.main(common + quant + ["--out", str(tmp / "q")])
        sync(dev)
        e2e_s = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)
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
        plain = np.load(tmp / "plain" / "samples.npy")
        fp = np.load(tmp / "fp" / "samples.npy")
        p_kp, p_qf = psnr(q, plain), psnr(q, fp)
        print(f"   plain-version sampling {plain_s:.2f} s, FP sampling "
              f"{fp_s:.2f} s", flush=True)
        print(f"   PSNR kernels vs plain versions: {p_kp:.2f} dB; quantized "
              f"vs FP (information): {p_qf:.2f} dB", flush=True)
        if not p_kp >= MIN_PSNR_KERNEL_VS_PLAIN_DB:
            raise AssertionError(f"kernel vs plain PSNR {p_kp:.2f} dB < "
                                 f"{MIN_PSNR_KERNEL_VS_PLAIN_DB}")
        if dev.type == "cuda":
            profile_sampling(cfg, dev, common + quant + ["--out", "-"],
                             steps)
        return {"launches": launches, "e2e_s": e2e_s, "plain_s": plain_s,
                "fp_s": fp_s, "psnr_kernel_vs_plain": p_kp,
                "psnr_quant_vs_fp": p_qf}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


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
        t0 = time.perf_counter()
        K.build(force=True)
        print(f"   nvcc build {time.perf_counter() - t0:.2f} s", flush=True)
        for line in K.BUILD_LOG["ptxas"].splitlines():
            if "registers" in line or "Compiling entry" in line:
                print("   " + line.strip(), flush=True)

    with phase("kernels"):
        from tfmq_dm_tpu_torch.models import ddim_unet
        cfg = ddim_unet.cifar10_config()
        convs, linears = cifar_geometries(cfg)
        g = torch.Generator().manual_seed(0)
        errs = {"int4_conv2d": [], "int4_linear": []}
        conv_shapes = [(BATCH, r, k, ci, co) for (r, k, ci, co) in convs]
        conv_shapes += [(2, 5, 3, 20, 37), (1, 7, 1, 48, 10)]
        for (b, r, k, ci, co) in conv_shapes:
            case = conv_case(g, b, r, k, ci, co, dev)
            check_close(f"int4_conv2d b{b} {r}x{r} {k}x{k} {ci}->{co}",
                        K.int4_conv2d(*case), K.int4_conv2d_plain(*case),
                        errs["int4_conv2d"])
        lin_shapes = [(BATCH, k, n) for (k, n) in linears]
        lin_shapes += [(1, 512, 256), (3, 100, 37), (64, 512, 256)]
        for (m, k, n) in lin_shapes:
            case = linear_case(g, m, k, n, dev)
            check_close(f"int4_linear M{m} {k}->{n}", K.int4_linear(*case),
                        K.int4_linear_plain(*case), errs["int4_linear"])

        print("   timing, ms per call (device: kernel / plain / library; "
              "kernel wall per eager call; bound):", flush=True)
        measured = {}
        for b, r, ci in ((64, 16, 256), (64, 32, 128), (BATCH, 32, 128)):
            measured[("conv", b, r, ci)] = t = time_conv(
                conv_case(g, b, r, 3, ci, ci, dev), peaks)
            print(f"   int4_conv2d b{b} {r}x{r} 3x3 {ci}->{ci}: "
                  + timing_line(t), flush=True)
        for m in (64, BATCH):
            measured[("linear", m)] = t = time_linear(
                linear_case(g, m, 512, 256, dev), peaks)
            print(f"   int4_linear M{m} 512->256: " + timing_line(t),
                  flush=True)

    with phase("main"):
        main_path = drive_main_path(cfg, dev)
    launches = main_path["launches"]
    tc = measured[("conv", BATCH, 32, 128)]
    tl = measured[("linear", BATCH)]
    report = {"kernels": [
        {"name": "int4_conv2d", "route": "cuda",
         "source": "tfmq_dm_tpu_torch/csrc/int4_kernels.cu",
         "replaces": "tfmq_dm_tpu/ops/pallas_kernels.py:548",
         "tpu": "int4_conv2d_dequant",
         "shape": f"x ({BATCH},32,32,128) bf16, 3x3 128->128",
         "launches": launches["int4_conv2d"],
         "max_abs_err": max(errs["int4_conv2d"]), **tc},
        {"name": "int4_linear", "route": "cuda",
         "source": "tfmq_dm_tpu_torch/csrc/int4_kernels.cu",
         "replaces": "tfmq_dm_tpu/ops/pallas_kernels.py:275",
         "tpu": "int4_matmul_dequant",
         "shape": f"x ({BATCH},512) f32, 512->256",
         "launches": launches["int4_linear"],
         "max_abs_err": max(errs["int4_linear"]), **tl},
    ]}
    print(json.dumps({"e2e_s": main_path["e2e_s"], "images": BATCH,
                      "steps": STEPS, "psnr_kernel_vs_plain_db":
                      main_path["psnr_kernel_vs_plain"],
                      "psnr_quant_vs_fp_db": main_path["psnr_quant_vs_fp"]}),
          flush=True)
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
