"""CLI of the port: the subset of ``tfmq_dm_tpu/cli.py`` that serves the
ddim family (``cifar10``, ``ddim_celeba64``, ``ddim_lsun_bedroom``,
``ddim_lsun_church``), the unconditional LDMs (``celeba256``,
``ffhq256``, ``lsun_beds256``, ``lsun_churches256``), the
class-conditional LDM (``cin256_v2``), Stable Diffusion v1.4
(``sd_v1_4``) and the BERT-conditioned LDM text2img models
(``text2img_256``, ``txt2img_1p4b``), with their CPU miniatures
``tiny_ddim``, ``tiny_ldm``, ``tiny_cin``, ``tiny_sd`` and ``tiny_bert``.

Calibrate, then exit (the reference's ``--cali``): harvest ``--cali_n``
samples per sampler step (class-conditional tasks with classifier-free
guidance, each step's rows unconditional and conditional), reconstruct
every unit with AdaRound (``--cali_iters`` iterations each), run FSC
(running-stat unless ``--no_running_stat``) and write the artifact:

  python -m tfmq_dm_tpu_torch.cli --task cifar10 --ptq --cali --wq 4 \\
      --aq 8 --use_aq --cali_save_path cali.npz

  python -m tfmq_dm_tpu_torch.cli --task cin256_v2 --ckpt cin256-v2.ckpt \\
      --ptq --cali --wq 4 --aq 8 --use_aq --cali_save_path cali.npz

  python -m tfmq_dm_tpu_torch.cli --task sd_v1_4 --ckpt sd-v1-4.ckpt \\
      --ptq --cali --wq 4 --aq 8 --use_aq --token_ids prompts.npy \\
      --cali_save_path cali.npz

  python -m tfmq_dm_tpu_torch.cli --task lsun_churches256 \\
      --ckpt lsun_churches256.ckpt --ptq --cali --wq 4 --aq 8 --use_aq \\
      --cali_save_path cali.npz

Quantized sampling with the hand-written kernels, from a calibration
artifact (either package's):

  python -m tfmq_dm_tpu_torch.cli --task cifar10 --ptq --cali_ckpt cali.npz \\
      --use_aq --int-kernels --timesteps 100 -n 64 --batch 64 --out /tmp/c10

  python -m tfmq_dm_tpu_torch.cli --task cin256_v2 --ckpt cin256-v2.ckpt \\
      --ptq --cali_ckpt cali.npz --use_aq --int-kernels \\
      --deploy_dtype bfloat16 --classes 1,2 -n 2 --batch 2 --out /tmp/cin

  python -m tfmq_dm_tpu_torch.cli --task sd_v1_4 --ckpt sd-v1-4.ckpt \\
      --ptq --cali_ckpt cali.npz --use_aq --int-kernels --int4-serving \\
      --token_ids prompts.npy -n 1 --batch 1 --out /tmp/sd

  python -m tfmq_dm_tpu_torch.cli --task txt2img_1p4b \\
      --ckpt txt2img-f8-large.ckpt --ptq --cali_ckpt cali.npz --use_aq \\
      --int-kernels --int4-serving --token_ids prompts.npy -n 1 \\
      --batch 1 --out /tmp/ldm_txt

  python -m tfmq_dm_tpu_torch.cli --task ddim_lsun_church \\
      --ckpt ema_lsun_church --ptq --cali_ckpt cali.npz --use_aq \\
      --int-kernels --int4-serving -n 8 --batch 8 --out /tmp/church

``--int-kernels`` deploys integer weights: int8 codes run the exact int8
conv and GEMM, and ``--int4-serving`` packs 4-bit weights for the
packed-int4 kernels instead. ``--deploy_dtype bfloat16`` (the fast deploy)
carries bf16 between the deployed layers, casts the FP parameters to bf16
and takes the ``fqk`` flash kernel; float32 keeps the deployed model exact
against its fake-quant simulation. ``--wq/--aq/--w_sym`` give the
artifact's grids. Without ``--int-kernels`` the quantized model runs as a
fake-quant simulation; without ``--ptq`` it runs in full precision.
The ddim family reads the repo's ``p::`` npz, the reference's DDIM
checkpoint (a state dict, or the trainer's list with its EMA weights) or a
pretrained-DDPM name (``ema_lsun_church``, ...) found in the local cache
with its md5 (``pipelines/ckpt_util``: nothing is downloaded). The LDM
tasks read the reference's Lightning checkpoint, LitEma weights swapped
in where the task samples EMA. Unconditional tasks sample one UNet
evaluation a step. Conditioned tasks sample with classifier-free guidance (``--scale``,
default the task's) and cache the cross-attention K/V of the constant
context (``--no-kv-cache`` recomputes them every step, as the reference
does). Class-conditional tasks take ``--classes``; text-conditioned ones
take ``--prompt`` or ``--from-file`` (one prompt a line), tokenized by
the stub tokenizer at a miniature's vocabulary, or ``--token_ids``: an
``.npy`` of token ids, (rows, 77) at CLIP's or BERT's vocabulary, whose
tokenizer files (CLIP's BPE, bert-base-uncased's WordPiece) are not in
this repository, so that prompt text is refused there. The rows, prompts
or classes repeat to fill a batch; the unconditional row is the empty
prompt's tokens, or the class table's last row.
Each task samples with its own sampler (``pipelines/ptq.make_schedule``:
DDIM, DDPM, PLMS or DPM-Solver). ``--dpm_order``, ``--dpm_method``,
``--dpm_skip``, ``--dpm_algorithm``, ``--dpm_solver_type`` and
``--dpm_denoise_to_zero`` configure the general DPM-Solver engine for a
task whose sampler is ``dpm``, and are ignored, with a warning, for any
other; an adaptive ``--dpm_method`` cannot calibrate (its times depend on
the data) and samples every evaluation with FSC group 0.
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
from typing import Optional

import numpy as np
import torch

from .configs.tasks import TASKS, get_task, task_betas, text_encoder
from .convert import load_params
from .data.prompts import prompts_from_file
from .models import (bert_text, clip_text, ddim_unet, ddim_units, ldm_unet,
                     ldm_units)
from .ops.nn import exact_f32
from .pipelines import ptq
from .pipelines import ckpt_util
from .pipelines.loading import load_ddim_checkpoint, load_ldm_checkpoint
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
    p.add_argument("--task", required=True, choices=tuple(TASKS))
    p.add_argument("--ckpt", default=None,
                   help="trained weights: the ddim family's .npz of "
                        "p::<layer>::<field> (cifar10's default "
                        "runs/cifar10_ddpm.npz), its reference DDIM "
                        "checkpoint or a pretrained-DDPM name in the "
                        "local cache (e.g. ema_lsun_church); the "
                        "reference's Lightning .ckpt for LDM tasks")
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
    # the general DPM-Solver configuration of a task whose sampler is
    # 'dpm' (dpm_solver.py:965-1113, beyond the entry flow's multistep
    # order-2 dpmsolver++ time_uniform; cli.py:99-114)
    p.add_argument("--dpm_order", type=int, default=None,
                   choices=(1, 2, 3))
    p.add_argument("--dpm_method", default=None,
                   choices=("multistep", "singlestep", "singlestep_fixed",
                            "adaptive"))
    p.add_argument("--dpm_skip", default=None,
                   choices=("time_uniform", "logSNR", "time_quadratic"))
    p.add_argument("--dpm_algorithm", default=None,
                   choices=("dpmsolver++", "dpmsolver"))
    p.add_argument("--dpm_solver_type", default=None,
                   choices=("dpm_solver", "taylor"))
    p.add_argument("--dpm_denoise_to_zero", action="store_true")
    p.add_argument("--scale", type=float, default=None,
                   help="classifier-free guidance scale")
    p.add_argument("--classes", default=None,
                   help="comma-separated ImageNet class ids")
    p.add_argument("--prompt", default=None)
    p.add_argument("--from-file", dest="from_file", default=None,
                   help="file with one prompt per line")
    p.add_argument("--token_ids", default=None,
                   help="an .npy of token ids (rows, max_len) for a "
                        "text-conditioned task, in place of prompts (at "
                        "CLIP's or BERT's vocabulary, whose tokenizer "
                        "files are not in this repository)")
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


def dpm_config(args) -> Optional[dict]:
    """The ``--dpm_*`` flags given, as ``ptq.make_schedule``'s dpm_cfg
    (cli.py:221-227), or None."""
    return {k: v for k, v in (
        ("order", args.dpm_order), ("method", args.dpm_method),
        ("skip_type", args.dpm_skip),
        ("algorithm_type", args.dpm_algorithm),
        ("solver_type", args.dpm_solver_type),
        ("denoise_to_zero", args.dpm_denoise_to_zero or None),
    ) if v is not None} or None


def fsc_groups(astate, meta, sample_t) -> Optional[np.ndarray]:
    """Each sampler evaluation's FSC group: the nearest of the artifact's
    calibration times (``group_of_step_from_t``). None without FSC state
    or calibration times, and for adaptive DPM-Solver, whose times depend
    on the data (``sample_t`` None): every evaluation then carries step 0
    and takes group 0, with a warning (cli.py:325-333)."""
    if astate is None or "cali_t" not in meta:
        return None
    if sample_t is None:
        logging.getLogger("tfmq_torch").warning(
            "adaptive DPM-Solver has no static step times; FSC uses "
            "calibration group 0 for every eval")
        return None
    return group_of_step_from_t(meta["cali_t"], sample_t)


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
    gos = fsc_groups(astate, meta, sample_t)
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


def _repeat_to(rows: list, n: int) -> list:
    """``rows`` repeated to fill n rows (cli.py:163-164)."""
    return (rows * ((n + len(rows) - 1) // len(rows)))[:n]


def class_context(cond_params, classes, n: int, device):
    """(context, uncond) (n, 1, embed_dim) from the class embedding
    table; the unconditional class is the table's last row
    (cli.py:186-198)."""
    cls = [int(c) for c in classes.split(",")] if classes \
        else list(range(8))
    table = cond_params["embedding"]
    y = torch.tensor(_repeat_to(cls, n), dtype=torch.long, device=device)
    uy = torch.full((n,), table.shape[0] - 1, dtype=torch.long,
                    device=device)
    return clip_text.class_embed(table, y), clip_text.class_embed(table, uy)


def load_token_ids(path: str, ccfg) -> np.ndarray:
    """``--token_ids``: an .npy of integer token ids, (rows, max_len),
    each in the text encoder's vocabulary."""
    ids = np.load(path)
    if ids.ndim != 2 or ids.shape[1] != ccfg.max_len or \
            not np.issubdtype(ids.dtype, np.integer) or ids.shape[0] < 1:
        raise SystemExit(f"--token_ids {path}: expected integer ids of "
                         f"shape (rows, {ccfg.max_len}), got {ids.dtype} "
                         f"{ids.shape}")
    if ids.min() < 0 or ids.max() >= ccfg.vocab_size:
        raise SystemExit(f"--token_ids {path}: ids outside the "
                         f"vocabulary [0, {ccfg.vocab_size})")
    return ids


def text_token_ids(args, ecfg, n: int) -> torch.Tensor:
    """(n, max_len) token ids of the prompts for the text encoder of
    config ``ecfg`` (CLIP's or BERT's; cli.py:148-186): from
    ``--token_ids``, checked against its vocabulary, or ``--prompt`` /
    ``--from-file`` through the stub tokenizer at a miniature's
    vocabulary; prompt text at the published vocabulary (CLIP's,
    bert-base-uncased's) is refused, since the tokenizer files are not in
    this repository."""
    enc = bert_text if isinstance(ecfg, bert_text.BERTTextConfig) \
        else clip_text
    if args.token_ids:
        if args.prompt or args.from_file:
            raise SystemExit("give --token_ids or --prompt/--from-file, "
                             "not both")
        return torch.from_numpy(np.stack(_repeat_to(
            list(load_token_ids(args.token_ids, ecfg)), n)).astype(np.int64))
    if args.from_file:
        prompts = prompts_from_file(args.from_file)
    elif args.prompt:
        prompts = [args.prompt]
    else:
        raise SystemExit("a text-conditioned task needs --prompt, "
                         "--from-file or --token_ids")
    prompts = _repeat_to(prompts, n)
    # a config's defaults are the published encoder's
    if ecfg.vocab_size == type(ecfg)().vocab_size:
        try:
            return enc.tokenize(prompts, max_length=ecfg.max_len)
        except RuntimeError as e:
            raise SystemExit(str(e)) from e
    return enc.stub_tokenize(prompts, ecfg)


def text_context(args, task, cond_params, n: int, device):
    """(context, uncond) (n, max_len, width): the task's text encoder
    (CLIP's last hidden state, or BERT's embeddings) of the prompts'
    token ids and of the empty prompt's."""
    enc, ecfg = text_encoder(task)
    ids = text_token_ids(args, ecfg, n).to(device)
    uids = enc.empty_prompt_ids(n, ecfg).to(device)
    return (enc.apply(cond_params, ecfg, ids),
            enc.apply(cond_params, ecfg, uids))


def conditioning(args, task, cond_params, n: int, device):
    """(context, uncond) of n rows for the task's conditioning; (None,
    None) for an unconditional task (cli.py:200)."""
    if task.cond == "none":
        return None, None
    if task.cond == "text":
        return text_context(args, task, cond_params, n, device)
    return class_context(cond_params, args.classes, n, device)


def load_ddim(args, task, device):
    """The ddim family's UNet parameters from ``--ckpt``: the repo's
    ``p::`` npz (cifar10's default ``runs/cifar10_ddpm.npz``), a
    pretrained-DDPM name resolved from the local cache with its md5
    (cli.py:233-239), or the reference's DDIM checkpoint."""
    if not args.ckpt and task.name != "cifar10":
        raise SystemExit(f"--task {task.name} needs --ckpt")
    path = args.ckpt or str(DEFAULT_CKPT)
    if path.endswith(".npz"):
        return load_params(path, device=device)[0]
    if not os.path.exists(path) and \
            ckpt_util.canonical_name(path) in ckpt_util.URLS:
        try:
            path = ckpt_util.get_ckpt_path(path)
        except FileNotFoundError as e:
            raise SystemExit(str(e)) from e
    return load_ddim_checkpoint(path, task.unet, use_ema=task.use_ema,
                                device=device)


def load_ldm(args, task, device):
    """(unet, vae, cond params) of ``--ckpt``, a Lightning checkpoint
    that must hold the encoder of the task's conditioning, if it has
    one."""
    if not args.ckpt:
        raise SystemExit(f"--task {task.name} needs --ckpt")
    params, vae_params, cond_params = load_ldm_checkpoint(
        args.ckpt, task, device=device)
    if cond_params is None and task.cond != "none":
        if task.cond == "text":
            key = "cond_stage_model.transformer.*"
            what = ("BERT" if task.bert is not None else "CLIP") + \
                " text encoder"
        else:
            key, what = "cond_stage_model.embedding.weight", \
                "class embedding"
        raise SystemExit(f"{args.ckpt}: no {key} (the task's {what})")
    return params, vae_params, cond_params


def build_ldm_model_fn(args, task, params, cond_params, sample_t, device):
    """model_fn(x, t, step) of an LDM task: the UNet (FP, fake-quant or
    deployed), flash attention in the quantized contexts; for a
    conditioned task the cached cross-attention K/V and double-batched CFG
    (cli.py:339-432), for an unconditional one a single evaluation."""
    cfg = task.unet
    ctx, uc = conditioning(args, task, cond_params, args.batch, device)
    c_in = None if ctx is None else torch.cat([uc, ctx])
    kv_on = c_in is not None and not args.no_kv_cache
    scale = task.cfg_scale if args.scale is None else args.scale

    def guided(apply_fn):
        if ctx is None:
            return lambda x, t, step: apply_fn(x, t, None, step)
        return make_cfg_model_fn(apply_fn, ctx, uc, scale)

    if not args.ptq:
        kv = ldm_unet.build_cross_kv(params, cfg, c_in) if kv_on else None

        def apply_fn(x, t, c, step):
            return ldm_unet.apply(params, cfg, x, t, context=c, kv_cache=kv)

        return guided(apply_fn)

    wstate, astate, meta = _load_artifact(args, device)
    adapter = ldm_units.build_adapter(
        cfg, w_bits=args.wq, a_bits=args.aq,
        softmax_a_bit=args.softmax_a_bit, use_aq=args.use_aq,
        w_sym=args.w_sym)
    gos = fsc_groups(astate, meta, sample_t)
    if args.int_kernels:
        ex = (torch.zeros((1, cfg.image_size, cfg.image_size,
                           cfg.in_channels), device=device),
              torch.zeros((1,), dtype=torch.int32, device=device))
        if ctx is not None:
            ex += (ctx[:1],)
        deployed, params, act_dtype = deploy(args, adapter, params, wstate,
                                             ex)

    # the context is constant over the rollout: its to_k/to_v
    # projections run once, in the model function's group-0 context (the
    # context-fed sites see the same input in every FSC group)
    def kv_cache_fn(qctx):
        return ldm_unet.build_cross_kv(params, cfg, c_in, qctx=qctx)

    kv_fn = kv_cache_fn if kv_on else None
    if args.int_kernels:
        model_fn = make_deployed_model_fn(
            adapter, params, deployed, astate, use_aq=args.use_aq,
            group_of_step=gos, act_dtype=act_dtype, kv_cache_fn=kv_fn)
    else:
        model_fn = make_model_fn(adapter, params, wstate, astate,
                                 use_aq=args.use_aq, group_of_step=gos,
                                 kv_cache_fn=kv_fn)

    def apply_fn(x, t, c, step):
        return model_fn(x, t, step) if c is None else model_fn(x, t, step, c)

    return guided(apply_fn)


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
    dpm_cfg = dpm_config(args)
    if dpm_cfg and task.sampler != "dpm":
        log.warning("--dpm_* flags are ignored: task %s uses the %s "
                    "sampler", task.name, task.sampler)
    sampler_fn, sample_t = ptq.make_schedule(task, steps=args.timesteps,
                                             eta=args.eta, dpm_cfg=dpm_cfg)
    vae_params = None
    if task.family == "ddim":
        params = load_ddim(args, task, device)
        model_fn = build_model_fn(args, params, task.unet, sample_t, device)
    else:
        params, vae_params, cond_params = load_ldm(args, task, device)
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
    """The calibrate-then-exit flow (cli.py:244-314): harvest (with CFG
    for a conditioned task: ``--scale`` or the task's, the classes of
    ``--classes`` or the prompts' token ids; unconditional rollouts
    otherwise), reconstruction and FSC, the artifact at
    ``--cali_save_path``."""
    log = logging.getLogger("tfmq_torch")
    device = resolve_device(args)
    exact_f32()
    task = get_task(args.task)
    if args.interval_length is not None:
        task = dataclasses.replace(task,
                                   interval_length=args.interval_length)
    n_per_t = args.cali_n or task.cali_n
    ctx = uc = None
    if task.family == "ddim":
        params = load_ddim(args, task, device)

        def fp_apply(x, t, c):
            return ddim_unet.apply(params, task.unet, x, t)
    else:
        params, _, cond_params = load_ldm(args, task, device)
        ctx, uc = conditioning(args, task, cond_params, n_per_t, device)

        def fp_apply(x, t, c):
            return ldm_unet.apply(params, task.unet, x, t, context=c)
    qargs = ptq.QuantArgs(
        wq=args.wq, aq=args.aq, softmax_a_bit=args.softmax_a_bit,
        use_aq=args.use_aq, w_sym=args.w_sym,
        running_stat=not args.no_running_stat, iters=args.cali_iters,
        cali_save_path=args.cali_save_path)
    adapter = ptq.build_adapter(task, qargs)
    generator = torch.Generator().manual_seed(args.seed)
    log.info("harvesting calibration data (%d per step)", n_per_t)
    w_cali, a_cali, cali_t = ptq.generate_cali_data(
        task, fp_apply, generator, n_per_t=n_per_t, context=ctx,
        uncond=uc, cfg_scale=args.scale, steps=args.timesteps,
        dpm_cfg=dpm_config(args), device=device)
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
