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
from ..samplers import dpm as dpm_s
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
                  eta: Optional[float] = None,
                  dpm_cfg: Optional[dict] = None):
    """(sampler_fn, cali_t): ``sampler_fn(model_fn, x, generator,
    collect)`` runs the task's sampler; ``cali_t`` holds the model time of
    each of its evaluations (the FSC groups), None where they depend on
    the data (adaptive DPM-Solver). The ddim family's generalized and
    ddpm_noisy samplers (both take ``noise``, their stochastic steps'
    draws); the LDM family's DDIM (also with ``noise``), PLMS and
    DPM-Solver samplers (ptq.py:63-136). With ``task.sampler == 'dpm'``,
    ``dpm_cfg`` (keys order, method, skip_type, algorithm_type,
    solver_type, denoise_to_zero) selects the general engine
    (``samplers/dpm.py``); without it the dedicated DPM-Solver++ 2M scan
    runs, the reference's entry configuration (sampler.py:82-83).
    ``dpm_cfg`` is ignored for the other samplers."""
    betas = task_betas(task)
    steps = steps or task.steps
    eta = task.eta if eta is None else eta
    if task.family == "ddim":
        seq = skip_seq(task.skip_type, task.num_timesteps, steps)
        if task.sampler == "ddpm_noisy":
            def fn(model_fn, x, generator=None, collect="none", noise=None):
                return ddim_s.ddpm_scan(model_fn, betas, seq, x, generator,
                                        collect=collect, noise=noise)
        elif task.sampler == "generalized":
            def fn(model_fn, x, generator=None, collect="none", noise=None):
                return ddim_s.generalized_scan(model_fn, betas, seq, x,
                                               generator, eta=eta,
                                               collect=collect, noise=noise)
        else:
            raise NotImplementedError(f"{task.sampler} sampler")
        return fn, seq[::-1].copy()

    ac = np.cumprod(1.0 - betas)
    if task.sampler == "dpm":
        if dpm_cfg:
            ns = dpm_s.NoiseSchedule("discrete", alphas_cumprod=ac)
            kw = dict(steps=steps, order=dpm_cfg.get("order", 2),
                      method=dpm_cfg.get("method", "multistep"),
                      skip_type=dpm_cfg.get("skip_type", "time_uniform"),
                      algorithm_type=dpm_cfg.get("algorithm_type",
                                                 "dpmsolver++"),
                      solver_type=dpm_cfg.get("solver_type", "dpm_solver"),
                      denoise_to_zero=dpm_cfg.get("denoise_to_zero", False))
            cali_t = None if kw["method"] == "adaptive" else \
                dpm_s.eval_times(ns, steps=steps, order=kw["order"],
                                 method=kw["method"],
                                 skip_type=kw["skip_type"])

            def fn(model_fn, x, generator=None, collect="none"):
                return dpm_s.dpm_solver_sample(model_fn, ns, x,
                                               collect=collect, **kw)
            return fn, cali_t

        sched = ldm_s.DPMSchedule(ac, steps)

        def fn(model_fn, x, generator=None, collect="none"):
            return ldm_s.dpm_solver_pp_2m_scan(model_fn, sched, x,
                                               collect=collect)
        return fn, sched.model_t[:-1].copy()

    if task.sampler not in ("ddim", "plms"):
        raise NotImplementedError(f"{task.sampler} sampler")
    sched = ldm_s.DDIMScheduleLDM(
        ac, ldm_s.make_ddim_timesteps(steps, task.num_timesteps), eta=eta)
    if task.sampler == "plms":
        def fn(model_fn, x, generator=None, collect="none"):
            return ldm_s.plms_scan(model_fn, sched, x, collect=collect)
    else:
        def fn(model_fn, x, generator=None, collect="none", noise=None):
            return ldm_s.ddim_scan_ldm(model_fn, sched, x, generator,
                                       collect=collect, noise=noise)
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
                       noise: Optional[torch.Tensor] = None,
                       step_noise: Optional[torch.Tensor] = None,
                       dpm_cfg: Optional[dict] = None,
                       device="cuda"):
    """Harvest (x_t, t[, c]) at every sampler step in O(T) rollouts.

    ``fp_apply(x, t, c) -> eps`` is the FP UNet. The starting noise (and
    that of stochastic steps) is drawn with ``generator`` (a CPU
    generator), one rollout batch at a time; ``noise`` (n_per_t, H, W,
    C) replaces the starting noise's draws, and ``step_noise`` (steps,
    n_per_t, H, W, C) those of the stochastic steps (DDIM at eta > 0,
    DDPM). ``dpm_cfg``: as ``make_schedule``'s; the harvest then holds
    DPM-Solver's float32 model times, and an adaptive configuration, whose
    times depend on the data, is refused before anything runs. With
    conditioning, each rollout uses CFG and every group holds the rows
    [(x, t, uc); (x, t, c)] (data_generate.py:13-49); ``context``/
    ``uncond`` are (n, 1, embed_dim) class embeddings or (n, 77, 768)
    CLIP text contexts. Without, each group holds the n_per_t rows of
    the unconditional rollouts.

    Returns (w_cali sample-major tuple, a_cali group-major tuple (G, N,
    ...), cali_t)."""
    if dpm_cfg and dpm_cfg.get("method") == "adaptive":
        raise ValueError("adaptive DPM-Solver has data-dependent eval "
                         "times: calibration needs a fixed-step method")
    sampler_fn, cali_t = make_schedule(task, steps=steps, dpm_cfg=dpm_cfg)
    shape = latent_shape(task)
    rollout_batch = rollout_batch or n_per_t
    xs_all, ts_all = [], []
    done = 0
    while done < n_per_t:
        b = min(rollout_batch, n_per_t - done)
        x0 = torch.randn((b,) + shape, generator=generator) \
            if noise is None else noise[done:done + b]
        x0 = x0.to(device)
        if context is not None:
            scale = task.cfg_scale if cfg_scale is None else cfg_scale
            model_fn = ldm_s.make_cfg_model_fn(
                lambda x, t, c, s: fp_apply(x, t, c),
                context[done:done + b], uncond[done:done + b], scale)
        else:
            model_fn = lambda x, t, s: fp_apply(x, t, None)  # noqa: E731
        kw = {} if step_noise is None else \
            {"noise": step_noise[:, done:done + b]}
        _, (xs, ts) = sampler_fn(model_fn, x0, generator, collect="traj",
                                 **kw)
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
    (ptq.py:209-234); with the task's name and the bits it holds what the
    CLI checks before it samples from the artifact. ``generator``: as
    ``cali_model``'s. For a conditioned task ``w_cali``/``a_cali`` carry
    the context (``generate_cali_data``)."""
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
