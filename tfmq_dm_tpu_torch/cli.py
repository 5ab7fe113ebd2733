"""CLI of the port: the ``cifar10`` and class-conditional LDM
(``cin256_v2``) subset of ``tfmq_dm_tpu/cli.py``, with their CPU
miniatures ``tiny_ddim`` and ``tiny_cin``.

Calibrate, then exit (the reference's ``--cali``; the ddim family): harvest
``--cali_n`` samples per sampler step, reconstruct every unit with
AdaRound (``--cali_iters`` iterations each), run FSC (running-stat unless
``--no_running_stat``) and write the artifact:

  python -m tfmq_dm_tpu_torch.cli --task cifar10 --ptq --cali --wq 4 \\
      --aq 8 --use_aq --cali_save_path cali.npz

Quantized sampling with the hand-written kernels, from a calibration
artifact (either package's):

  python -m tfmq_dm_tpu_torch.cli --task cifar10 --ptq --cali_ckpt cali.npz \\
      --use_aq --int-kernels --timesteps 100 -n 64 --batch 64 --out /tmp/c10

  python -m tfmq_dm_tpu_torch.cli --task cin256_v2 --ckpt cin256-v2.ckpt \\
      --ptq --cali_ckpt cali.npz --use_aq --int-kernels \\
      --deploy_dtype bfloat16 --classes 1,2 -n 2 --batch 2 --out /tmp/cin

``--int-kernels`` deploys integer weights: int8 codes run the exact int8
conv and GEMM, and ``--int4-serving`` packs 4-bit weights for the
packed-int4 kernels instead. ``--deploy_dtype bfloat16`` (the fast deploy)
carries bf16 between the deployed layers, casts the FP parameters to bf16
and takes the ``fqk`` flash kernel; float32 keeps the deployed model exact
against its fake-quant simulation. ``--wq/--aq/--w_sym`` give the
artifact's grids. Without ``--int-kernels`` the quantized model runs as a
fake-quant simulation; without ``--ptq`` it runs in full precision.
Class-conditional tasks sample with classifier-free guidance (``--scale``,
default the task's) and cache the cross-attention K/V of the constant
class context (``--no-kv-cache`` recomputes them every step, as the
reference does).
Runs on the card (``--device cuda``, the default) unless asked for the
CPU. Images in [0, 1], NHWC float32, are written to
``<out>/samples.npy``; LDM tasks also write the sampled latents to
``<out>/latents.npy``.
"""

from __future__ import annotations

import argparse
import dataclasses
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
from .quant.deploy import (cast_fp_params, deploy_weights,
                           make_deployed_model_fn, specialize_maps)
from .quant.inference import make_model_fn
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
                   choices=("cifar10", "cin256_v2", "tiny_cin",
                            "tiny_ddim"))
    p.add_argument("--ckpt", default=None,
                   help="trained weights: a p::<layer>::<field> npz "
                        "(cifar10, default runs/cifar10_ddpm.npz) or the "
                        "reference's Lightning .ckpt (LDM tasks)")
    p.add_argument("--out", default=None,
                   help="output directory of the samples (sampling)")
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--ptq", action="store_true")
    p.add_argument("--wq", type=int, default=4,
                   help="weight bits of the artifact")
    p.add_argument("--aq", type=int, default=8,
                   help="activation bits of the artifact")
    p.add_argument("--w_sym", action="store_true",
                   help="symmetric weight grids (the int8 deployment "
                        "then skips the activation-sum correction)")
    p.add_argument("--cali", action="store_true",
                   help="calibrate (harvest, reconstruction, FSC), write "
                        "the artifact to --cali_save_path and exit")
    p.add_argument("--cali_save_path", default="cali.npz")
    p.add_argument("--cali_n", type=int, default=None,
                   help="calibration samples per sampler step (default: "
                        "the task's)")
    p.add_argument("--cali_iters", type=int, default=20000,
                   help="reconstruction iterations per unit")
    p.add_argument("--interval_length", type=int, default=None,
                   help="reconstruct on every n-th step's samples "
                        "(default: the task's)")
    p.add_argument("--no_running_stat", action="store_true",
                   help="FSC init pass only (no running-stat EMA pass)")
    p.add_argument("--resume_dir", default=None,
                   help="per-unit reconstruction checkpoints: units "
                        "found there are skipped on a re-run")
    p.add_argument("--cali_ckpt", default=None)
    p.add_argument("--use_aq", action="store_true")
    p.add_argument("--softmax_a_bit", type=int, default=8,
                   help="bits of the attention-softmax act quantizer; "
                        "must match the artifact's")
    p.add_argument("--int-kernels", dest="int_kernels",
                   action="store_true",
                   help="deploy integer weights: the exact int8 conv and "
                        "GEMM kernels")
    p.add_argument("--int4-serving", dest="int4_serving",
                   action="store_true",
                   help="nibble-packed 4-bit weights, run by the "
                        "packed-int4 CUDA kernels")
    p.add_argument("--deploy_dtype", choices=("float32", "bfloat16"),
                   default="float32",
                   help="carrier dtype between deployed layers: float32 "
                        "is exact against the fake-quant simulation; "
                        "bfloat16 (the fast deploy) runs the FP layers and "
                        "glue ops in bf16 and attention through the fqk "
                        "kernel")
    p.add_argument("--no-kv-cache", "--no_kv_cache", dest="no_kv_cache",
                   action="store_true",
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
    if meta.get("wq", args.wq) != args.wq or \
            meta.get("aq", args.aq) != args.aq:
        raise SystemExit(f"artifact calibrated w{meta.get('wq')}a"
                         f"{meta.get('aq')}, asked for w{args.wq}a"
                         f"{args.aq} (--wq/--aq)")
    if meta.get("softmax_a_bit", 8) != args.softmax_a_bit:
        raise SystemExit(f"artifact calibrated with softmax_a_bit "
                         f"{meta.get('softmax_a_bit', 8)}, asked for "
                         f"{args.softmax_a_bit}")
    return wstate, astate, meta


def deploy(args, adapter, params, wstate, example_args):
    """(deployed weights, params, carrier dtype) of ``--int-kernels``:
    integer weights with their border maps specialized to the sampled
    geometry, and under ``--deploy_dtype bfloat16`` the FP parameters in
    bf16 (cli.py:343-366)."""
    deployed = deploy_weights(adapter.policy, params, wstate,
                              int4_serving=args.int4_serving)
    deployed = specialize_maps(adapter, params, deployed,
                               example_args=example_args,
                               use_aq=args.use_aq)
    if args.deploy_dtype == "bfloat16":
        return deployed, cast_fp_params(params), torch.bfloat16
    return deployed, params, None


def build_model_fn(args, params, cfg, sample_t, device):
    """model_fn(x, t, step) of the cifar10 task for the requested path."""
    if not args.ptq:
        return lambda x, t, step: ddim_unet.apply(params, cfg, x, t)
    wstate, astate, meta = _load_artifact(args, device)
    adapter = ddim_units.build_adapter(cfg, w_bits=args.wq, a_bits=args.aq,
                                       softmax_a_bit=args.softmax_a_bit,
                                       w_sym=args.w_sym)
    gos = None
    if astate is not None and "cali_t" in meta:
        gos = group_of_step_from_t(meta["cali_t"], sample_t)
    if args.int_kernels:
        ex = (torch.zeros((1, cfg.resolution, cfg.resolution,
                           cfg.in_channels), device=device),
              torch.zeros((1,), dtype=torch.int32, device=device))
        deployed, params, act_dtype = deploy(args, adapter, params, wstate,
                                             ex)
        return make_deployed_model_fn(adapter, params, deployed, astate,
                                      use_aq=args.use_aq,
                                      group_of_step=gos,
                                      act_dtype=act_dtype)
    return make_model_fn(adapter, params, wstate, astate,
                         use_aq=args.use_aq, group_of_step=gos)


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

    if not args.ptq:
        kv = None if args.no_kv_cache else \
            ldm_unet.build_cross_kv(params, cfg, c_in)

        def apply_fn(x, t, c, step):
            return ldm_unet.apply(params, cfg, x, t, context=c, kv_cache=kv)

        return make_cfg_model_fn(apply_fn, ctx, uc, scale)

    wstate, astate, meta = _load_artifact(args, device)
    adapter = ldm_units.build_adapter(
        cfg, w_bits=args.wq, a_bits=args.aq,
        softmax_a_bit=args.softmax_a_bit, use_aq=args.use_aq,
        w_sym=args.w_sym)
    gos = None
    if astate is not None and "cali_t" in meta:
        gos = group_of_step_from_t(meta["cali_t"], sample_t)
    if args.int_kernels:
        ex = (torch.zeros((1, cfg.image_size, cfg.image_size,
                           cfg.in_channels), device=device),
              torch.zeros((1,), dtype=torch.int32, device=device), ctx[:1])
        deployed, params, act_dtype = deploy(args, adapter, params, wstate,
                                             ex)

    # the class context is constant over the rollout: its to_k/to_v
    # projections run once, in the model function's group-0 context (the
    # context-fed sites see the same input in every FSC group)
    def kv_cache_fn(qctx):
        return ldm_unet.build_cross_kv(params, cfg, c_in, qctx=qctx)

    kv_fn = None if args.no_kv_cache else kv_cache_fn
    if args.int_kernels:
        model_fn = make_deployed_model_fn(
            adapter, params, deployed, astate, use_aq=args.use_aq,
            group_of_step=gos, act_dtype=act_dtype, kv_cache_fn=kv_fn)
    else:
        model_fn = make_model_fn(adapter, params, wstate, astate,
                                 use_aq=args.use_aq, group_of_step=gos,
                                 kv_cache_fn=kv_fn)

    def apply_fn(x, t, c, step):
        return model_fn(x, t, step, c)

    return make_cfg_model_fn(apply_fn, ctx, uc, scale)


def sample(args, latents: list = None) -> np.ndarray:
    """Run the sampler as ``args`` asks -> images (N, H, W, C) in [0, 1].
    ``latents``: a list that receives each batch's sampled latents."""
    log = logging.getLogger("tfmq_torch")
    device = resolve_device(args)
    if args.int4_serving and not (args.ptq and args.int_kernels):
        log.warning("--int4-serving has no effect without --ptq "
                    "--int-kernels")
    if args.deploy_dtype == "bfloat16" and not (args.ptq
                                                and args.int_kernels):
        log.warning("--deploy_dtype bfloat16 has no effect without --ptq "
                    "--int-kernels; running the default path")
    exact_f32()
    task = get_task(args.task)
    sampler_fn, sample_t = ptq.make_schedule(task, steps=args.timesteps,
                                             eta=args.eta)
    vae_params = None
    if task.family == "ddim":
        if not args.ckpt and task.name != "cifar10":
            raise SystemExit(f"--task {task.name} needs --ckpt")
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


def resolve_device(args) -> torch.device:
    """``args.device`` as a device; refuses a card that is not there
    rather than falling back to the CPU."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda, but torch.cuda.is_available() is "
                         "false (ask for --device cpu explicitly)")
    return device


def calibrate(args) -> None:
    """The calibrate-then-exit flow (cli.py:244-314) of the ddim family:
    harvest, reconstruction and FSC, the artifact at
    ``--cali_save_path``."""
    log = logging.getLogger("tfmq_torch")
    device = resolve_device(args)
    exact_f32()
    task = get_task(args.task)
    if task.family != "ddim":
        raise SystemExit(f"--cali: calibration of {task.name} (the LDM "
                         "family) needs the LDM reconstruction units, not "
                         "ported yet (ROADMAP.md queue 1 item 5)")
    if not args.ckpt and task.name != "cifar10":
        raise SystemExit(f"--task {task.name} needs --ckpt")
    if args.interval_length is not None:
        task = dataclasses.replace(task,
                                   interval_length=args.interval_length)
    params, _ = load_params(args.ckpt or str(DEFAULT_CKPT), device=device)
    qargs = ptq.QuantArgs(
        wq=args.wq, aq=args.aq, softmax_a_bit=args.softmax_a_bit,
        use_aq=args.use_aq, w_sym=args.w_sym,
        running_stat=not args.no_running_stat, iters=args.cali_iters,
        cali_save_path=args.cali_save_path)
    adapter = ptq.build_adapter(task, qargs)
    n_per_t = args.cali_n or task.cali_n
    generator = torch.Generator().manual_seed(args.seed)
    log.info("harvesting calibration data (%d per step)", n_per_t)
    w_cali, a_cali, cali_t = ptq.generate_cali_data(
        task, lambda x, t, c: ddim_unet.apply(params, task.unet, x, t),
        generator, n_per_t=n_per_t, steps=args.timesteps, device=device)
    log.info("calibrating -> %s", args.cali_save_path)
    ptq.quantize_task(task, adapter, params, qargs, w_cali, a_cali,
                      cali_t=cali_t, generator=generator,
                      resume_dir=args.resume_dir)
    log.info("calibration done")


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s: %(message)s")
    args = build_argparser().parse_args(argv)
    if args.cali:
        if not args.ptq:
            raise SystemExit("--cali needs --ptq")
        calibrate(args)
        return 0
    if args.out is None:
        raise SystemExit("sampling needs --out")
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
