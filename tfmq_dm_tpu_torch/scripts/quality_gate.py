"""FP-vs-quantized quality gate of the port (the twin of
``scripts/quality_gate.py``, the ddim family): the numeric agreement of the
calibrated, deployed quantized model with its FP counterpart under the
real pipeline, on identical noise:

  harvest -> ``cali_model`` (TIAR/AdaRound reconstruction, running-stat
  FSC) -> int4-serving deployment (the packed-int4 kernels on the card)
  -> a DDIM rollout beside the FP rollout.

``--deployment fake-quant`` samples from the fake-quant simulation
instead (float32, as the JAX script samples), to tell the deployment's
rounding (bf16 activations into the int4 kernels) from the
calibration's. It reports the per-step UNet-output SQNR along the FP
trajectory (the quantized model's eps against the FP model's at the same
inputs), the
final-sample PSNR, the trajectory SQNR, the do-no-harm guard's record and
the calibration's wall seconds, as one JSON object (the JAX script's keys
except its proxy FD, which is not ported). Weight grids are symmetric, as
in the JAX script (scripts/quality_gate.py:164-166).

    python -m tfmq_dm_tpu_torch.scripts.quality_gate cifar10 \\
        --ckpt runs/cifar10_ddpm.npz --wq 4 --iters 5000 --n-cali 64 \\
        --json out.json

Runs on the card unless ``--device cpu``; the CPU takes the kernels'
plain versions.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import subprocess
import sys
import time

import numpy as np
import torch

from ..configs.tasks import get_task
from ..cli import DEFAULT_CKPT, resolve_device
from ..convert import load_params
from ..models import ddim_unet
from ..ops import int4_kernels
from ..ops.nn import exact_f32
from ..pipelines import ptq
from ..quant.calibrate import cali_model, load_cali_model
from ..quant.deploy import (deploy_weights, make_deployed_model_fn,
                            specialize_maps)
from ..quant.inference import make_model_fn
from ..quant.recon import ReconHP
from ..utils.metrics import psnr, sqnr_db

log = logging.getLogger("quality_gate")


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("quality_gate")
    ap.add_argument("task", nargs="?", default="cifar10",
                    help="a ddim-family task (cifar10, tiny_ddim)")
    ap.add_argument("--ckpt", default=None,
                    help="trained ddim_unet weights, a p::<layer>::<field> "
                         "npz (default for cifar10: runs/cifar10_ddpm.npz);"
                         " its meta's architecture and schedule are used")
    ap.add_argument("--wq", type=int, default=4)
    ap.add_argument("--aq", type=int, default=8)
    ap.add_argument("--iters", type=int, default=1000,
                    help="reconstruction iterations a unit (reference "
                         "budget: 20000)")
    ap.add_argument("--n-cali", type=int, default=32,
                    help="calibration samples a sampler step")
    ap.add_argument("--batch", type=int, default=16,
                    help="images of the FP and quantized rollouts")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--no-aq", action="store_true",
                    help="weight-only quantization: no act quantizers, "
                         "no FSC")
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds the harvest and, separately, the "
                         "rollouts' noise")
    ap.add_argument("--deployment", default="int4-serving",
                    choices=("int4-serving", "fake-quant"),
                    help="the quantized model the rollout samples from")
    ap.add_argument("--json", default=None)
    ap.add_argument("--resume-dir", default=None,
                    help="per-unit reconstruction checkpoints; the finished "
                         "calibration is also kept there and reused")
    ap.add_argument("--device", default="cuda")
    return ap


def _task_and_params(args, device):
    task = get_task(args.task)
    if task.family != "ddim":
        raise SystemExit(f"{task.name}: the ddim family only")
    if args.ckpt is None and task.name != "cifar10":
        raise SystemExit(f"--task {task.name} needs --ckpt")
    ckpt = args.ckpt or str(DEFAULT_CKPT)
    params, meta = load_params(ckpt, device=device)
    if meta.get("kind") == "ddim_unet":
        # the architecture and the schedule the model was trained with
        cfg = ddim_unet.DDIMUNetConfig(
            resolution=meta["resolution"], ch=meta["ch"],
            ch_mult=tuple(meta["ch_mult"]),
            num_res_blocks=meta["num_res_blocks"],
            attn_resolutions=tuple(meta["attn_resolutions"]),
            in_channels=meta.get("in_channels", 3))
        sched = {k: meta[k] for k in ("beta_schedule", "beta_start",
                                      "beta_end") if k in meta}
        task = dataclasses.replace(task, unet=cfg,
                                   num_timesteps=meta["timesteps"], **sched)
    return task, params


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return res.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not measured"


def run(args) -> dict:
    device = resolve_device(args)
    exact_f32()
    task, params = _task_and_params(args, device)
    use_aq = not args.no_aq
    qargs = ptq.QuantArgs(wq=args.wq, aq=args.aq, use_aq=use_aq, w_sym=True,
                          iters=args.iters, cali_save_path=None)
    adapter = ptq.build_adapter(task, qargs)
    cfg = task.unet
    gen = torch.Generator().manual_seed(args.seed)

    def fp_apply(x, t, c=None):
        return ddim_unet.apply(params, cfg, x, t)

    recon_stats = {}
    cali_art = os.path.join(args.resume_dir, "cali_artifact.npz") \
        if args.resume_dir else None
    t0 = time.perf_counter()
    if cali_art and os.path.exists(cali_art):
        log.info("loading the finished calibration %s", cali_art)
        wstate, astate, meta = load_cali_model(cali_art, device=device)
        recon_stats = meta.get("recon", {}).get("units", {})
    else:
        log.info("harvesting calibration data (%d a step)", args.n_cali)
        w_cali, a_cali, _ = ptq.generate_cali_data(
            task, fp_apply, gen, n_per_t=args.n_cali, steps=args.steps,
            device=device)
        hp = ReconHP(iters=args.iters,
                     batch_size=min(task.recon_batch, args.n_cali))
        log.info("calibrating w%da%d (%d iterations a unit)", args.wq,
                 32 if args.no_aq else args.aq, args.iters)
        wstate, astate = cali_model(
            adapter, params, w_cali, a_cali if use_aq else None, hp=hp,
            use_aq=use_aq, generator=gen, resume_dir=args.resume_dir,
            path=cali_art, recon_stats=recon_stats)
        del w_cali, a_cali
    if device.type == "cuda":
        torch.cuda.synchronize()
    cali_s = time.perf_counter() - t0

    # the FP and the quantized rollouts from the same noise
    sampler_fn, _ = ptq.make_schedule(task, steps=args.steps)
    res, chans = cfg.resolution, cfg.in_channels
    noise = torch.Generator().manual_seed(args.seed)
    x0 = torch.randn((args.batch, res, res, chans),
                     generator=noise).to(device)
    if args.deployment == "int4-serving":
        deployed = deploy_weights(adapter.policy, params, wstate,
                                  int4_serving=True)
        ex = (torch.zeros((1, res, res, chans), device=device),
              torch.zeros((1,), dtype=torch.int32, device=device))
        deployed = specialize_maps(adapter, params, deployed,
                                   example_args=ex, use_aq=use_aq)
        q_fn = make_deployed_model_fn(adapter, params, deployed, astate,
                                      use_aq=use_aq)
    else:
        q_fn = make_model_fn(adapter, params, wstate, astate,
                             use_aq=use_aq)

    def fp_fn(x, t, step):
        return fp_apply(x, t)

    fp_last, (fp_xs, fp_ts) = sampler_fn(fp_fn, x0, noise, collect="traj")
    int4_kernels.reset_launch_counts()
    q_last, (q_xs, _) = sampler_fn(q_fn, x0, noise, collect="traj")
    launches = dict(int4_kernels.LAUNCHES)

    # per-step UNet-output SQNR at the FP trajectory's points
    sqnrs = []
    with torch.no_grad():
        for i in range(fp_xs.shape[0]):
            e_fp = fp_fn(fp_xs[i], fp_ts[i], i)
            e_q = q_fn(fp_xs[i], fp_ts[i], i)
            sqnrs.append(sqnr_db(e_fp.float().cpu().numpy(),
                                 e_q.float().cpu().numpy()))
    fp_img = np.clip(fp_last.float().cpu().numpy() * 0.5 + 0.5, 0, 1)
    q_img = np.clip(q_last.float().cpu().numpy() * 0.5 + 0.5, 0, 1)
    out = {
        "task": task.name,
        "setting": f"w{args.wq}a{32 if args.no_aq else args.aq}",
        "recon_iters": args.iters,
        "cali_per_step": args.n_cali,
        "unet_sqnr_db_mean": round(float(np.mean(sqnrs)), 2),
        "unet_sqnr_db_min": round(float(np.min(sqnrs)), 2),
        "sample_psnr_db": round(psnr(fp_img, q_img), 2),
        "traj_sqnr_db": round(sqnr_db(fp_xs.float().cpu().numpy(),
                                      q_xs.float().cpu().numpy()), 2),
        "weights": "trained:" + (args.ckpt or "runs/cifar10_ddpm.npz"),
        "calibration_s": round(cali_s, 2),
        "deployment": args.deployment + ", symmetric weight grids",
        "seed": args.seed,
        "kernel_launches": launches,
        "device": card() if device.type == "cuda" else "cpu",
    }
    if recon_stats:
        kept_nearest = sorted(u for u, v in recon_stats.items()
                              if v.get("kept") == "nearest")
        out["recon_guard"] = {
            "units": len(recon_stats),
            "kept_trained": len(recon_stats) - len(kept_nearest),
            "kept_nearest": kept_nearest}
        out["recon_loss_first_last"] = {
            u: (v["loss_first"], v["loss_last"])
            for u, v in recon_stats.items() if "loss_first" in v}
    return out


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s: %(message)s")
    args = build_argparser().parse_args(argv)
    out = run(args)
    print(json.dumps(out))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
