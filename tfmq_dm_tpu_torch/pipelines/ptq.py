"""PTQ pipeline (port of ``tfmq_dm_tpu/pipelines/ptq.py``): the
quantization knobs and adapter of a task, the task's sampler with its
calibration timesteps, the calibration-data harvest in O(T) rollouts
(classifier-free guidance for conditioned tasks) and ``quantize_task``,
the task's calibration with its reconstruction hyperparameters."""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..configs.tasks import TaskConfig, task_betas
from ..models import ddim_units, ldm_units
from ..quant.calibrate import cali_model
from ..quant.recon import ReconHP
from ..samplers import ddim as ddim_s
from ..samplers import ldm as ldm_s
from ..utils.schedules import skip_seq


@dataclasses.dataclass
class QuantArgs:
    """The reference CLI's quantization knobs
    (sample_diffusion_ddim.py:13-107)."""

    wq: int = 4
    aq: int = 8
    softmax_a_bit: int = 8
    use_aq: bool = False
    w_sym: bool = False
    running_stat: bool = True
    iters: int = 20000
    cali_save_path: Optional[str] = "cali.npz"


def build_adapter(task: TaskConfig, qargs: QuantArgs):
    if task.family == "ddim":
        return ddim_units.build_adapter(task.unet, w_bits=qargs.wq,
                                        a_bits=qargs.aq,
                                        softmax_a_bit=qargs.softmax_a_bit,
                                        w_sym=qargs.w_sym)
    return ldm_units.build_adapter(task.unet, w_bits=qargs.wq,
                                   a_bits=qargs.aq,
                                   softmax_a_bit=qargs.softmax_a_bit,
                                   use_aq=qargs.use_aq, w_sym=qargs.w_sym)


def make_schedule(task: TaskConfig, steps: Optional[int] = None,
                  eta: Optional[float] = None):
    """(sampler_fn, cali_t): ``sampler_fn(model_fn, x, generator,
    collect)`` runs the task's sampler; ``cali_t`` holds the timestep of
    each sampler step (the FSC groups). The ddim family's generalized
    sampler and the LDM family's DDIM sampler."""
    betas = task_betas(task)
    steps = steps or task.steps
    eta = task.eta if eta is None else eta
    if task.family == "ddim":
        if task.sampler != "generalized":
            raise NotImplementedError(f"{task.sampler} sampler")
        seq = skip_seq(task.skip_type, task.num_timesteps, steps)

        def fn(model_fn, x, generator=None, collect="none"):
            return ddim_s.generalized_scan(model_fn, betas, seq, x,
                                           generator, eta=eta,
                                           collect=collect)
        return fn, seq[::-1].copy()

    if task.sampler != "ddim":
        raise NotImplementedError(f"{task.sampler} sampler (PLMS and "
                                  "DPM-Solver++ wait for their slices)")
    ac = np.cumprod(1.0 - betas)
    sched = ldm_s.DDIMScheduleLDM(
        ac, ldm_s.make_ddim_timesteps(steps, task.num_timesteps), eta=eta)

    def fn(model_fn, x, generator=None, collect="none"):
        return ldm_s.ddim_scan_ldm(model_fn, sched, x, generator,
                                   collect=collect)
    return fn, sched.t.copy()


def latent_shape(task: TaskConfig):
    res = task.unet.resolution if task.family == "ddim" \
        else task.unet.image_size
    return (res, res, task.unet.in_channels)


@torch.no_grad()
def generate_cali_data(task: TaskConfig, fp_apply: Callable,
                       generator: torch.Generator, *, n_per_t: int,
                       context: Optional[torch.Tensor] = None,
                       uncond: Optional[torch.Tensor] = None,
                       cfg_scale: Optional[float] = None,
                       steps: Optional[int] = None,
                       rollout_batch: Optional[int] = None,
                       device="cuda"):
    """Harvest (x_t, t[, c]) at every sampler step in O(T) rollouts.

    ``fp_apply(x, t, c) -> eps`` is the FP UNet. The starting noise (and
    that of stochastic steps) is drawn with ``generator`` (a CPU
    generator), one rollout batch at a time. With conditioning, each
    rollout uses CFG and every group holds the rows [(x, t, uc);
    (x, t, c)] (data_generate.py:13-49).

    Returns (w_cali sample-major tuple, a_cali group-major tuple (G, N,
    ...), cali_t)."""
    sampler_fn, cali_t = make_schedule(task, steps=steps)
    shape = latent_shape(task)
    rollout_batch = rollout_batch or n_per_t
    xs_all, ts_all = [], []
    done = 0
    while done < n_per_t:
        b = min(rollout_batch, n_per_t - done)
        x0 = torch.randn((b,) + shape, generator=generator).to(device)
        if context is not None:
            scale = task.cfg_scale if cfg_scale is None else cfg_scale
            model_fn = ldm_s.make_cfg_model_fn(
                lambda x, t, c, s: fp_apply(x, t, c),
                context[done:done + b], uncond[done:done + b], scale)
        else:
            model_fn = lambda x, t, s: fp_apply(x, t, None)  # noqa: E731
        _, (xs, ts) = sampler_fn(model_fn, x0, generator, collect="traj")
        xs_all.append(xs)
        ts_all.append(ts)
        done += b
    xs = torch.cat(xs_all, dim=1)   # (G, N, H, W, C)
    ts = torch.cat(ts_all, dim=1)
    if context is not None:
        xs = torch.cat([xs, xs], dim=1)
        ts = torch.cat([ts, ts], dim=1)
        cs = torch.cat([uncond[:n_per_t], context[:n_per_t]])
        cs = cs[None].expand((xs.shape[0],) + cs.shape)
        a_cali = (xs, ts, cs)
    else:
        a_cali = (xs, ts)
    il = task.interval_length
    w_cali = tuple(x[::il].reshape((-1,) + x.shape[2:]) for x in a_cali)
    return w_cali, a_cali, cali_t


# calibration samples a capture forward (the JAX package's quantize_task)
CAPTURE_BATCH = 64


def quantize_task(task: TaskConfig, adapter, params, qargs: QuantArgs,
                  w_cali, a_cali, *, cali_t=None,
                  generator: Optional[torch.Generator] = None,
                  resume_dir=None):
    """The task's TFMQ calibration (reconstruction, then FSC when
    ``use_aq``) with its reconstruction hyperparameters; saves the
    artifact to ``qargs.cali_save_path`` and returns (wstate, astate).
    ``cali_t`` (each group's timestep) goes into the artifact's meta, so
    that sampling maps its steps to FSC groups at any step count
    (ptq.py:209-234). ``generator``: as ``cali_model``'s. The ddim
    family only: the LDM units wait for their slice."""
    if task.family != "ddim":
        raise NotImplementedError(
            f"{task.name}: reconstruction of the LDM family is not ported "
            "yet (ROADMAP.md queue 1 item 5)")
    hp = ReconHP(iters=qargs.iters, batch_size=task.recon_batch, w=0.01,
                 warmup=0.2)
    meta = {"task": task.name, "wq": qargs.wq, "aq": qargs.aq,
            "softmax_a_bit": qargs.softmax_a_bit, "use_aq": qargs.use_aq,
            "steps": int(a_cali[0].shape[0])}
    if cali_t is not None:
        meta["cali_t"] = [float(t) for t in np.asarray(cali_t)]
    return cali_model(adapter, params, w_cali,
                      a_cali if qargs.use_aq else None, hp=hp,
                      use_aq=qargs.use_aq, running_stat=qargs.running_stat,
                      path=qargs.cali_save_path, generator=generator,
                      meta=meta, capture_batch_size=CAPTURE_BATCH,
                      resume_dir=resume_dir)
