"""FP-vs-quantized quality gate of the port (the twin of
``scripts/quality_gate.py``): the numeric agreement of the calibrated,
deployed quantized model with its FP counterpart under the real
pipeline, on identical noise:

  harvest -> ``cali_model`` (TIAR/AdaRound reconstruction, running-stat
  FSC) -> int4-serving deployment (the packed-int4 kernels on the card;
  for an LDM task also the flash kernels) -> a DDIM rollout beside the FP
  rollout.

The ddim family samples trained weights (``--ckpt``, default
runs/cifar10_ddpm.npz for cifar10). An LDM task takes seeded random-init
weights, as the JAX script does (scripts/quality_gate.py:48-78, 153),
and samples with its own sampler (DDIM, or PLMS for the SD tasks) and
classifier-free guidance at the task's scale: the harvest and both
rollouts are double-batched [unconditional; conditional]. A
class-conditional task (cin256_v2, tiny_cin) takes a random
class-embedding table, classes 0, 1, ... a row; a text-conditioned one
(sd_v1_4, tiny_sd: CLIP; text2img_256, txt2img_1p4b, tiny_bert: BERT) a
random-init text tower, the prompts "a synthetic scene number {i}" and
the empty prompt through the stub tokenizer, at every vocabulary. The
harvest and the rollouts each draw their own table or tower.
``--noise-npz`` gives the harvest's starting noise ("harvest", n-cali
rows) and the rollouts' ("rollout", batch rows) in place of the script's
own draws, e.g. the JAX script's
(``tfmq_dm_tpu_torch/scripts/jax_noise_cifar10.npz``).

``--deployment fake-quant`` samples from the fake-quant simulation
instead (float32, as the JAX script samples), to tell the deployment's
rounding (bf16 activations into the int4 kernels) from the
calibration's. It reports the per-step UNet-output SQNR along the FP
trajectory (the quantized model's eps against the FP model's at the same
inputs), the final-sample PSNR, the trajectory SQNR, the do-no-harm
guard's record, the calibration's wall seconds (harvest, reconstruction
and FSC apart) and the peak device memory, as one JSON object (the JAX
script's keys except its proxy FD, which is not ported). Weight grids
are symmetric, as in the JAX script (scripts/quality_gate.py:164-166).

    python -m tfmq_dm_tpu_torch.scripts.quality_gate cifar10 \\
        --ckpt runs/cifar10_ddpm.npz --wq 4 --iters 5000 --n-cali 64 \\
        --json out.json
    python -m tfmq_dm_tpu_torch.scripts.quality_gate cin256_v2 --wq 4 \\
        --iters 5000 --n-cali 8 --json out.json
    python -m tfmq_dm_tpu_torch.scripts.quality_gate tiny_sd --wq 4 \\
        --iters 5000 --n-cali 64 --json out.json

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

from ..configs.tasks import get_task, text_encoder
from ..cli import DEFAULT_CKPT, resolve_device
from ..convert import load_params
from ..models import clip_text, ddim_unet, ldm_unet
from ..ops import flash_attention, int4_kernels
from ..ops.nn import exact_f32
from ..pipelines import ptq
from ..quant.calibrate import cali_model, load_cali_model
from ..quant.deploy import (deploy_weights, make_deployed_model_fn,
                            specialize_maps)
from ..quant.inference import make_model_fn
from ..quant.recon import ReconHP
from ..samplers.ldm import make_cfg_model_fn
from ..utils.metrics import psnr, sqnr_db

log = logging.getLogger("quality_gate")


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("quality_gate")
    ap.add_argument("task", nargs="?", default="cifar10",
                    help="cifar10, tiny_ddim, or a class- or "
                         "text-conditioned LDM task (cin256_v2, tiny_cin, "
                         "sd_v1_4, tiny_sd, text2img_256, txt2img_1p4b, "
                         "tiny_bert)")
    ap.add_argument("--ckpt", default=None,
                    help="trained ddim_unet weights, a p::<layer>::<field> "
                         "npz (default for cifar10: runs/cifar10_ddpm.npz);"
                         " its meta's architecture and schedule are used."
                         " LDM tasks take seeded random-init weights")
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
    ap.add_argument("--noise-npz", default=None,
                    help="npz with the harvest's starting noise "
                         "('harvest', n-cali rows) and the rollouts' "
                         "('rollout', batch rows), used in place of the "
                         "seeded draws")
    ap.add_argument("--deployment", default="int4-serving",
                    choices=("int4-serving", "fake-quant"),
                    help="the quantized model the rollout samples from")
    ap.add_argument("--json", default=None)
    ap.add_argument("--resume-dir", default=None,
                    help="per-unit reconstruction checkpoints; the finished "
                         "calibration is also kept there and reused")
    ap.add_argument("--device", default="cuda")
    return ap


# the JAX script's seed of the random-init LDM weights
# (scripts/quality_gate.py:153); the port draws them with its own generator
LDM_WEIGHTS_SEED = 7


def _task_and_params(args, device):
    task = get_task(args.task)
    if task.family != "ddim":
        if args.ckpt is not None:
            raise SystemExit(f"{task.name}: seeded random-init weights "
                             "only (--ckpt is for the ddim family)")
        params = ldm_unet.init_params(
            torch.Generator().manual_seed(LDM_WEIGHTS_SEED), task.unet)
        return task, {k: {f: v.to(device) for f, v in p.items()}
                      for k, p in params.items()}
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


def cond_setup(task, generator: torch.Generator, n: int, device):
    """(context, uncond) of ``n`` rows for a conditioned task
    (scripts/quality_gate.py:48-78), drawn with ``generator``: from a
    random class-embedding table (1001 x context_dim, N(0, 0.02^2)),
    classes 0, 1, ... and the table's last row unconditional; or from a
    random-init text tower (CLIP or BERT, the JAX package's init scheme)
    of the prompts "a synthetic scene number {i}" and of the empty
    prompt, both through the stub tokenizer. (None, None) for an
    unconditional task."""
    if task.cond == "none":
        return None, None
    if task.cond == "class":
        table = 0.02 * torch.randn((1001, task.unet.context_dim),
                                   generator=generator)
        y = torch.arange(n) % 1000
        return (clip_text.class_embed(table, y).to(device),
                clip_text.class_embed(table, torch.full((n,), 1000))
                .to(device))
    enc, ecfg = text_encoder(task)
    params = enc.init_params(generator, ecfg, device="cpu")
    params = {k: {f: v.to(device) for f, v in p.items()}
              for k, p in params.items()}
    prompts = [f"a synthetic scene number {i}" for i in range(n)]
    with torch.no_grad():
        return tuple(enc.apply(params, ecfg,
                               enc.stub_tokenize(texts, ecfg).to(device))
                     for texts in (prompts, [""] * n))


def _wall(device) -> float:
    if device.type == "cuda":
        torch.cuda.synchronize()
    return time.perf_counter()


def run(args) -> dict:
    device = resolve_device(args)
    exact_f32()
    task, params = _task_and_params(args, device)
    ldm = task.family != "ddim"
    use_aq = not args.no_aq
    qargs = ptq.QuantArgs(wq=args.wq, aq=args.aq, use_aq=use_aq, w_sym=True,
                          iters=args.iters, cali_save_path=None)
    adapter = ptq.build_adapter(task, qargs)
    cfg = task.unet
    gen = torch.Generator().manual_seed(args.seed)
    noise_in = None
    if args.noise_npz:
        with np.load(args.noise_npz) as z:
            noise_in = {k: torch.from_numpy(z[k]) for k in
                        ("harvest", "rollout")}
        if noise_in["harvest"].shape[0] != args.n_cali or \
                noise_in["rollout"].shape[0] != args.batch:
            raise SystemExit(f"{args.noise_npz}: harvest rows "
                             f"{noise_in['harvest'].shape[0]}, rollout "
                             f"rows {noise_in['rollout'].shape[0]}; asked "
                             f"for --n-cali {args.n_cali} --batch "
                             f"{args.batch}")

    def fp_apply(x, t, c=None):
        if ldm:
            return ldm_unet.apply(params, cfg, x, t, context=c)
        return ddim_unet.apply(params, cfg, x, t)

    recon_stats, seconds = {}, {}
    cali_art = os.path.join(args.resume_dir, "cali_artifact.npz") \
        if args.resume_dir else None
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = _wall(device)
    if cali_art and os.path.exists(cali_art):
        log.info("loading the finished calibration %s", cali_art)
        wstate, astate, meta = load_cali_model(cali_art, device=device)
        recon_stats = meta.get("recon", {}).get("units", {})
    else:
        log.info("harvesting calibration data (%d a step)", args.n_cali)
        cali_ctx, cali_uc = cond_setup(task, gen, args.n_cali, device)
        w_cali, a_cali, _ = ptq.generate_cali_data(
            task, fp_apply, gen, n_per_t=args.n_cali, steps=args.steps,
            context=cali_ctx, uncond=cali_uc,
            noise=None if noise_in is None else noise_in["harvest"],
            device=device)
        seconds["harvest"] = _wall(device) - t0
        hp = ReconHP(iters=args.iters,
                     batch_size=min(task.recon_batch, args.n_cali))
        log.info("calibrating w%da%d (%d iterations a unit)", args.wq,
                 32 if args.no_aq else args.aq, args.iters)
        wstate, astate = cali_model(
            adapter, params, w_cali, a_cali if use_aq else None, hp=hp,
            use_aq=use_aq, generator=gen, resume_dir=args.resume_dir,
            path=cali_art, recon_stats=recon_stats, seconds=seconds)
        del w_cali, a_cali
    cali_s = _wall(device) - t0
    peak = torch.cuda.max_memory_allocated() / (1 << 30) \
        if device.type == "cuda" else None

    # the FP and the quantized rollouts from the same noise
    sampler_fn, _ = ptq.make_schedule(task, steps=args.steps)
    res = cfg.image_size if ldm else cfg.resolution
    chans = cfg.in_channels
    noise = torch.Generator().manual_seed(args.seed)
    roll_ctx, roll_uc = cond_setup(task, noise, args.batch, device)
    x0 = (torch.randn((args.batch, res, res, chans), generator=noise)
          if noise_in is None else noise_in["rollout"]).to(device)
    if args.deployment == "int4-serving":
        deployed = deploy_weights(adapter.policy, params, wstate,
                                  int4_serving=True)
        ex = (torch.zeros((1, res, res, chans), device=device),
              torch.zeros((1,), dtype=torch.int32, device=device))
        if roll_ctx is not None:
            ex += (roll_ctx[:1],)
        deployed = specialize_maps(adapter, params, deployed,
                                   example_args=ex, use_aq=use_aq)
        q_once = make_deployed_model_fn(adapter, params, deployed, astate,
                                        use_aq=use_aq)
    else:
        q_once = make_model_fn(adapter, params, wstate, astate,
                               use_aq=use_aq)
    if roll_ctx is not None:
        # double-batched CFG at the task's scale (quality_gate.py:240-260)
        fp_fn = make_cfg_model_fn(lambda x, t, c, s: fp_apply(x, t, c),
                                  roll_ctx, roll_uc, task.cfg_scale)
        q_fn = make_cfg_model_fn(lambda x, t, c, s: q_once(x, t, s, c),
                                 roll_ctx, roll_uc, task.cfg_scale)
    else:
        def fp_fn(x, t, step):
            return fp_apply(x, t)
        q_fn = q_once

    fp_last, (fp_xs, fp_ts) = sampler_fn(fp_fn, x0, noise, collect="traj")
    int4_kernels.reset_launch_counts()
    flash_attention.reset_launch_counts()
    q_last, (q_xs, _) = sampler_fn(q_fn, x0, noise, collect="traj")
    launches = dict(int4_kernels.LAUNCHES)
    if ldm:
        launches.update(flash_attention.LAUNCHES)

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
    if ldm:
        weights = f"random-init (torch seed {LDM_WEIGHTS_SEED})"
    else:
        weights = "trained:" + (args.ckpt or "runs/cifar10_ddpm.npz")
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
        "weights": weights,
        "calibration_s": round(cali_s, 2),
        "calibration_split_s": {k: round(v, 2) for k, v in seconds.items()},
        "peak_device_gib": None if peak is None else round(peak, 2),
        "deployment": args.deployment + ", symmetric weight grids",
        "seed": args.seed,
        "noise": args.noise_npz or f"torch seed {args.seed}",
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
