"""Sampling CLI of the port: the ``cifar10`` and class-conditional LDM
(``cin256_v2``, and its miniature ``tiny_cin``) subset of
``tfmq_dm_tpu/cli.py``.

Quantized sampling with the hand-written kernels, from a calibration
artifact (either package's):

  python -m tfmq_dm_tpu_torch.cli --task cifar10 --ptq --cali_ckpt cali.npz \\
      --use_aq --int-kernels --int4-serving --timesteps 100 -n 64 \\
      --batch 64 --out /tmp/c10

  python -m tfmq_dm_tpu_torch.cli --task cin256_v2 --ckpt cin256-v2.ckpt \\
      --ptq --cali_ckpt cali.npz --use_aq --int-kernels --int4-serving \\
      --classes 1,2 -n 2 --batch 2 --out /tmp/cin

Without ``--int-kernels`` the quantized model runs as a fake-quant
simulation; without ``--ptq`` it runs in full precision. Class-conditional
tasks sample with classifier-free guidance (``--scale``, default the
task's) and cache the cross-attention K/V of the constant class context
(``--no_kv_cache`` recomputes them every step, as the reference does).
Runs on the card (``--device cuda``, the default) unless asked for the
CPU. Images in [0, 1], NHWC float32, are written to
``<out>/samples.npy``; LDM tasks also write the sampled latents to
``<out>/latents.npy``.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
from pathlib import Path

import numpy as np
import torch

from .configs.tasks import get_task, task_betas
from .convert import load_params
from .models import clip_text, ddim_unet, ddim_units, ldm_unet, ldm_units
from .ops.nn import exact_f32
from .pipelines import ptq
from .pipelines.loading import load_ldm_checkpoint
from .pipelines.sampling import sample_fid
from .quant.calibrate import load_cali_model
from .quant.context import QuantCtx
from .quant.deploy import deploy_weights, make_deployed_model_fn
from .quant.fsc import slice_fsc
from .samplers.ldm import group_of_step_from_t, make_cfg_model_fn
from .utils.schedules import skip_seq

DEFAULT_CKPT = Path(__file__).resolve().parent.parent / "runs" / \
    "cifar10_ddpm.npz"


def cifar10_schedule(steps: int = 100):
    """(betas, seq) of the cifar10 task with ``steps`` sampler steps."""
    task = get_task("cifar10")
    return task_betas(task), skip_seq(task.skip_type, task.num_timesteps,
                                      steps)


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("tfmq-torch")
    p.add_argument("--task", required=True,
                   choices=("cifar10", "cin256_v2", "tiny_cin"))
    p.add_argument("--ckpt", default=None,
                   help="trained weights: a p::<layer>::<field> npz "
                        "(cifar10, default runs/cifar10_ddpm.npz) or the "
                        "reference's Lightning .ckpt (LDM tasks)")
    p.add_argument("--out", required=True)
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--ptq", action="store_true")
    p.add_argument("--cali_ckpt", default=None)
    p.add_argument("--use_aq", action="store_true")
    p.add_argument("--softmax_a_bit", type=int, default=8,
                   help="bits of the attention-softmax act quantizer; "
                        "must match the artifact's")
    p.add_argument("--int-kernels", dest="int_kernels",
                   action="store_true",
                   help="deploy integer weights (needs --int4-serving)")
    p.add_argument("--int4-serving", dest="int4_serving",
                   action="store_true",
                   help="nibble-packed 4-bit weights, run by the "
                        "packed-int4 CUDA kernels")
    p.add_argument("--no_kv_cache", action="store_true",
                   help="recompute the cross-attention K/V of the "
                        "constant class context at every step")
    p.add_argument("--timesteps", type=int, default=None,
                   help="sampler steps (default: the task's)")
    p.add_argument("--eta", type=float, default=None)
    p.add_argument("--scale", type=float, default=None,
                   help="classifier-free guidance scale")
    p.add_argument("--classes", default=None,
                   help="comma-separated ImageNet class ids")
    p.add_argument("-n", "--num_images", type=int, default=64)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--device", default="cuda")
    return p


def _load_artifact(args, device):
    """(wstate, astate, meta) of ``--cali_ckpt``, checked against the
    bits this CLI samples with."""
    if not args.cali_ckpt:
        raise SystemExit("--ptq sampling needs --cali_ckpt")
    wstate, astate, meta = load_cali_model(args.cali_ckpt, device=device)
    if meta.get("wq", 4) != 4 or meta.get("aq", 8) != 8:
        raise SystemExit("the port samples w4a8 artifacts only")
    if meta.get("softmax_a_bit", 8) != args.softmax_a_bit:
        raise SystemExit(f"artifact calibrated with softmax_a_bit "
                         f"{meta.get('softmax_a_bit', 8)}, asked for "
                         f"{args.softmax_a_bit}")
    return wstate, astate, meta


def build_model_fn(args, params, cfg, sample_t, device):
    """model_fn(x, t, step) of the cifar10 task for the requested path."""
    if not args.ptq:
        return lambda x, t, step: ddim_unet.apply(params, cfg, x, t)
    wstate, astate, meta = _load_artifact(args, device)
    adapter = ddim_units.build_adapter(cfg, w_bits=4, a_bits=8,
                                       softmax_a_bit=args.softmax_a_bit)
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


def class_context(cond_params, classes, n: int, device):
    """(context, uncond) (n, 1, embed_dim) from the class embedding
    table; the unconditional class is the table's last row
    (cli.py:186-198)."""
    cls = [int(c) for c in classes.split(",")] if classes \
        else list(range(8))
    cls = (cls * ((n + len(cls) - 1) // len(cls)))[:n]
    table = cond_params["embedding"]
    y = torch.tensor(cls, dtype=torch.long, device=device)
    uy = torch.full((n,), table.shape[0] - 1, dtype=torch.long,
                    device=device)
    return clip_text.class_embed(table, y), clip_text.class_embed(table, uy)


def build_ldm_model_fn(args, task, params, cond_params, sample_t, device):
    """model_fn(x, t, step) of an LDM task: the UNet (FP, fake-quant or
    deployed), flash attention in the quantized contexts, the cached
    cross-attention K/V and double-batched CFG (cli.py:339-432)."""
    cfg = task.unet
    ctx, uc = class_context(cond_params, args.classes, args.batch, device)
    c_in = torch.cat([uc, ctx])
    scale = task.cfg_scale if args.scale is None else args.scale

    make_ctx = None
    if args.ptq:
        wstate, astate, meta = _load_artifact(args, device)
        adapter = ldm_units.build_adapter(
            cfg, w_bits=4, a_bits=8, softmax_a_bit=args.softmax_a_bit,
            use_aq=args.use_aq)
        gos = None
        if astate is not None and "cali_t" in meta:
            gos = group_of_step_from_t(meta["cali_t"], sample_t)
        deployed = None
        if args.int_kernels:
            if not args.int4_serving:
                raise SystemExit("--int-kernels without --int4-serving "
                                 "needs the int8 deployment, not ported "
                                 "yet")
            deployed = deploy_weights(adapter.policy, params, wstate,
                                      int4_serving=True)

        def make_ctx(step):
            ast = {}
            if args.use_aq and astate:
                ast = slice_fsc(astate,
                                step if gos is None else int(gos[step]))
            if deployed is not None:
                return QuantCtx(adapter.policy, wstate={}, astate=ast,
                                use_wq=True, use_aq=args.use_aq,
                                deploy=deployed, flash=True)
            return QuantCtx(adapter.policy, wstate=wstate, astate=ast,
                            use_wq=True, use_aq=args.use_aq, flash=True)

    # the class context is constant over the rollout: its to_k/to_v
    # projections run once, under the FSC group of step 0
    kv = None
    if not args.no_kv_cache:
        kv = ldm_unet.build_cross_kv(
            params, cfg, c_in, qctx=None if make_ctx is None
            else make_ctx(0))

    def apply_fn(x, t, c, step):
        qctx = None if make_ctx is None else make_ctx(step)
        return ldm_unet.apply(params, cfg, x, t, context=c, qctx=qctx,
                              kv_cache=kv)

    return make_cfg_model_fn(apply_fn, ctx, uc, scale)


def sample(args, latents: list = None) -> np.ndarray:
    """Run the sampler as ``args`` asks -> images (N, H, W, C) in [0, 1].
    ``latents``: a list that receives each batch's sampled latents."""
    log = logging.getLogger("tfmq_torch")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda, but torch.cuda.is_available() is "
                         "false (ask for --device cpu explicitly)")
    if args.int4_serving and not (args.ptq and args.int_kernels):
        log.warning("--int4-serving has no effect without --ptq "
                    "--int-kernels")
    exact_f32()
    task = get_task(args.task)
    sampler_fn, sample_t = ptq.make_schedule(task, steps=args.timesteps,
                                             eta=args.eta)
    vae_params = None
    if task.family == "ddim":
        params, _ = load_params(args.ckpt or str(DEFAULT_CKPT),
                                device=device)
        model_fn = build_model_fn(args, params, task.unet, sample_t, device)
    else:
        if not args.ckpt:
            raise SystemExit(f"--task {task.name} needs --ckpt")
        params, vae_params, cond_params = load_ldm_checkpoint(
            args.ckpt, task, device=device)
        if cond_params is None:
            raise SystemExit(f"{args.ckpt}: no cond_stage_model.embedding")
        model_fn = build_ldm_model_fn(args, task, params, cond_params,
                                      sample_t, device)
    return sample_fid(task, sampler_fn, model_fn,
                      n_images=args.num_images, batch_size=args.batch,
                      generator=torch.Generator().manual_seed(args.seed),
                      vae_params=vae_params, device=device,
                      latents=latents)


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s: %(message)s")
    args = build_argparser().parse_args(argv)
    latents = []
    images = sample(args, latents)
    os.makedirs(args.out, exist_ok=True)
    np.save(os.path.join(args.out, "samples.npy"), images)
    if get_task(args.task).family != "ddim":
        np.save(os.path.join(args.out, "latents.npy"),
                np.concatenate(latents))
    return 0


if __name__ == "__main__":
    sys.exit(main())
