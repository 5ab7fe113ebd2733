"""Sampling CLI of the port: the ``--task cifar10`` subset of
``tfmq_dm_tpu/cli.py``.

Quantized sampling with the packed-int4 kernels, from a calibration
artifact (either package's):

  python -m tfmq_dm_tpu_torch.cli --task cifar10 --ptq --cali_ckpt cali.npz \\
      --use_aq --int-kernels --int4-serving --timesteps 100 -n 64 \\
      --batch 64 --out /tmp/c10

Without ``--int-kernels`` the quantized model runs as a fake-quant
simulation; without ``--ptq`` it runs in full precision. Runs on the card
(``--device cuda``, the default) unless asked for the CPU. Images in
[0, 1], NHWC float32, are written to ``<out>/samples.npy``.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .convert import load_params
from .models import ddim_unet, ddim_units
from .ops.nn import exact_f32
from .quant.calibrate import load_cali_model
from .quant.context import QuantCtx
from .quant.deploy import deploy_weights, make_deployed_model_fn
from .quant.fsc import slice_fsc
from .samplers.ddim import generalized_scan
from .utils.schedules import get_beta_schedule, skip_seq

DEFAULT_CKPT = Path(__file__).resolve().parent.parent / "runs" / \
    "cifar10_ddpm.npz"

# the cifar10 task (tfmq_dm_tpu/configs/tasks.py:59-65)
BETA_START, BETA_END, NUM_TIMESTEPS = 1e-4, 0.02, 1000
DEFAULT_STEPS, DEFAULT_ETA, SKIP_TYPE = 100, 0.0, "quad"


def cifar10_schedule(steps: int = DEFAULT_STEPS):
    """(betas, seq) of the cifar10 task with ``steps`` sampler steps."""
    betas = get_beta_schedule("linear", beta_start=BETA_START,
                              beta_end=BETA_END,
                              num_diffusion_timesteps=NUM_TIMESTEPS)
    return betas, skip_seq(SKIP_TYPE, NUM_TIMESTEPS, steps)


def group_of_step_from_t(cali_t, sample_t) -> np.ndarray:
    """Each sampling step's nearest calibration group by timestep
    (tfmq_dm_tpu/samplers/ldm.py:278-286)."""
    cali_t = np.asarray(cali_t, np.float64)
    sample_t = np.asarray(sample_t, np.float64)
    return np.argmin(np.abs(sample_t[:, None] - cali_t[None, :]), axis=1)


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("tfmq-torch")
    p.add_argument("--task", required=True, choices=("cifar10",))
    p.add_argument("--ckpt", default=str(DEFAULT_CKPT),
                   help="trained weights, p::<layer>::<field> npz")
    p.add_argument("--out", required=True)
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--ptq", action="store_true")
    p.add_argument("--cali_ckpt", default=None)
    p.add_argument("--use_aq", action="store_true")
    p.add_argument("--int-kernels", dest="int_kernels",
                   action="store_true",
                   help="deploy integer weights (needs --int4-serving)")
    p.add_argument("--int4-serving", dest="int4_serving",
                   action="store_true",
                   help="nibble-packed 4-bit weights, run by the "
                        "packed-int4 CUDA kernels")
    p.add_argument("--timesteps", type=int, default=DEFAULT_STEPS)
    p.add_argument("-n", "--num_images", type=int, default=64)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--device", default="cuda")
    return p


def build_model_fn(args, params, cfg, sample_t, device):
    """model_fn(x, t, step) for the requested path."""
    if not args.ptq:
        return lambda x, t, step: ddim_unet.apply(params, cfg, x, t)
    if not args.cali_ckpt:
        raise SystemExit("--ptq sampling needs --cali_ckpt")
    wstate, astate, meta = load_cali_model(args.cali_ckpt, device=device)
    if meta.get("wq", 4) != 4 or meta.get("aq", 8) != 8:
        raise SystemExit("the port samples w4a8 artifacts only")
    adapter = ddim_units.build_adapter(cfg, w_bits=4, a_bits=8)
    gos = None
    if astate is not None and "cali_t" in meta:
        gos = group_of_step_from_t(meta["cali_t"], sample_t)
    if args.int_kernels:
        if not args.int4_serving:
            raise SystemExit("--int-kernels without --int4-serving needs "
                             "the int8 deployment, not ported yet")
        deployed = deploy_weights(adapter.policy, params, wstate,
                                  int4_serving=True)
        return make_deployed_model_fn(adapter, params, deployed, astate,
                                      use_aq=args.use_aq,
                                      group_of_step=gos)

    def sim_fn(x, t, step):
        ast = {}
        if args.use_aq and astate:
            ast = slice_fsc(astate, step if gos is None else int(gos[step]))
        ctx = QuantCtx(adapter.policy, wstate=wstate, astate=ast,
                       use_wq=True, use_aq=args.use_aq)
        return ddim_unet.apply(params, cfg, x, t, ctx)

    return sim_fn


def sample(args) -> np.ndarray:
    """Run the sampler as ``args`` asks -> images (N, H, W, C) in [0, 1]."""
    log = logging.getLogger("tfmq_torch")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda, but torch.cuda.is_available() is "
                         "false (ask for --device cpu explicitly)")
    if args.int4_serving and not (args.ptq and args.int_kernels):
        log.warning("--int4-serving has no effect without --ptq "
                    "--int-kernels")
    exact_f32()
    cfg = ddim_unet.cifar10_config()
    params, _ = load_params(args.ckpt, device=device)
    betas, seq = cifar10_schedule(args.timesteps)
    model_fn = build_model_fn(args, params, cfg, seq[::-1], device)

    gen = torch.Generator().manual_seed(args.seed)
    shape = (cfg.resolution, cfg.resolution, cfg.in_channels)
    out = []
    done = 0
    while done < args.num_images:
        b = min(args.batch, args.num_images - done)
        x_t = torch.randn((args.batch,) + shape, generator=gen).to(device)
        t0 = time.perf_counter()
        x0 = generalized_scan(model_fn, betas, seq, x_t, eta=DEFAULT_ETA)
        imgs = torch.clamp((x0[:b] + 1.0) / 2.0, 0.0, 1.0).cpu().numpy()
        log.info("batch %d: %d images in %.3f s", done // args.batch, b,
                 time.perf_counter() - t0)
        out.append(imgs)
        done += b
    return np.concatenate(out)


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s: %(message)s")
    args = build_argparser().parse_args(argv)
    images = sample(args)
    os.makedirs(args.out, exist_ok=True)
    np.save(os.path.join(args.out, "samples.npy"), images)
    return 0


if __name__ == "__main__":
    sys.exit(main())
