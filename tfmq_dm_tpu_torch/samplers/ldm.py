"""LDM-family DDIM sampler, classifier-free guidance and FSC step mapping
(port of the DDIM part of ``tfmq_dm_tpu/samplers/ldm.py``; the
reference's ldm/models/diffusion/ddim.py).

Schedule quantities are computed on the host per step, in float32 like
the JAX tables; the rollout is a Python loop over the steps. The model
callback receives the step index, so FSC selects its per-timestep state
by step. PLMS and DPM-Solver++ wait for their slices.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch


def make_beta_schedule(schedule: str, n_timestep: int,
                       linear_start=1e-4, linear_end=2e-2,
                       cosine_s=8e-3) -> np.ndarray:
    """diffusionmodules/util.py:21-44."""
    if schedule == "linear":
        return np.linspace(linear_start ** 0.5, linear_end ** 0.5,
                           n_timestep, dtype=np.float64) ** 2
    if schedule == "sqrt_linear":
        return np.linspace(linear_start, linear_end, n_timestep,
                           dtype=np.float64)
    if schedule == "cosine":
        ts = (np.arange(n_timestep + 1, dtype=np.float64) / n_timestep
              + cosine_s)
        alphas = np.cos(ts / (1 + cosine_s) * np.pi / 2) ** 2
        alphas = alphas / alphas[0]
        betas = 1 - alphas[1:] / alphas[:-1]
        return np.clip(betas, 0, 0.999)
    if schedule == "sqrt":
        return np.linspace(linear_start, linear_end, n_timestep,
                           dtype=np.float64) ** 0.5
    raise ValueError(schedule)


def make_ddim_timesteps(num_ddim_steps: int, num_ddpm_steps: int,
                        discr_method: str = "uniform") -> np.ndarray:
    """diffusionmodules/util.py:47-60 (note the +1 shift)."""
    if discr_method == "uniform":
        c = num_ddpm_steps // num_ddim_steps
        steps = np.asarray(list(range(0, num_ddpm_steps, c)))
    elif discr_method == "quad":
        steps = (np.linspace(0, np.sqrt(num_ddpm_steps * 0.8),
                             num_ddim_steps) ** 2).astype(int)
    else:
        raise NotImplementedError(discr_method)
    return steps + 1


class DDIMScheduleLDM:
    """Per-step DDIM quantities (make_ddim_sampling_parameters,
    util.py:63-75), in sampling order (descending t)."""

    def __init__(self, alphas_cumprod: np.ndarray,
                 ddim_timesteps: np.ndarray, eta: float = 0.0):
        ac = np.asarray(alphas_cumprod, np.float64)
        ts = np.asarray(ddim_timesteps)
        alphas = ac[ts]
        alphas_prev = np.concatenate([[ac[0]], ac[ts[:-1]]])
        sigmas = eta * np.sqrt((1 - alphas_prev) / (1 - alphas)
                               * (1 - alphas / alphas_prev))
        self.t = ts[::-1].copy()
        self.a_t = alphas[::-1].copy()
        self.a_prev = alphas_prev[::-1].copy()
        self.sigma = sigmas[::-1].copy()
        self.sqrt_1m_a = np.sqrt(1.0 - self.a_t)
        self.num_steps = len(ts)


@torch.no_grad()
def ddim_scan_ldm(model_fn, sched: DDIMScheduleLDM, x: torch.Tensor,
                  generator: Optional[torch.Generator] = None,
                  collect: str = "none"):
    """p_sample_ddim loop (ddim.py:123-175). ``collect="traj"`` also
    returns the model inputs (x_t, t) of every step, stacked.
    ``generator`` draws the noise of stochastic steps (eta > 0)."""
    if collect not in ("none", "traj"):
        raise ValueError(f"collect must be 'none' or 'traj', got {collect!r}")
    f32 = np.float32
    a_t = sched.a_t.astype(f32)
    a_prev = sched.a_prev.astype(f32)
    sigma = sched.sigma.astype(f32)
    s1ma = sched.sqrt_1m_a.astype(f32)
    if np.any(sigma > 0) and generator is None:
        raise ValueError("eta > 0 needs a torch.Generator")
    n = x.shape[0]
    xs, ts = [], []
    xt = x
    for i in range(sched.num_steps):
        t_b = torch.full((n,), int(sched.t[i]), dtype=torch.int32,
                         device=x.device)
        # a bf16 eps (the fast deploy) meets the f32 step scalars in f32,
        # as JAX promotes it
        e_t = model_fn(xt, t_b, i)
        e_t = e_t.to(torch.promote_types(e_t.dtype, xt.dtype))
        pred_x0 = (xt - float(s1ma[i]) * e_t) / float(np.sqrt(a_t[i]))
        dir_xt = float(np.sqrt(np.maximum(
            f32(1.0) - a_prev[i] - sigma[i] ** 2, f32(0.0)))) * e_t
        x_prev = float(np.sqrt(a_prev[i])) * pred_x0 + dir_xt
        if sigma[i] > 0:
            noise = torch.randn(xt.shape, generator=generator,
                                device=generator.device, dtype=xt.dtype)
            x_prev = x_prev + float(sigma[i]) * noise.to(xt.device)
        if collect == "traj":
            xs.append(xt)
            ts.append(t_b)
        xt = x_prev
    if collect == "none":
        return xt
    return xt, (torch.stack(xs), torch.stack(ts))


def make_cfg_model_fn(apply_fn: Callable, cond: torch.Tensor,
                      uncond: torch.Tensor, scale: float) -> Callable:
    """Double-batched CFG as the reference samplers (ddim.py:178-185):
    model([x;x], [t;t], [uc;c]), then e_uc + scale (e_c - e_uc).
    ``apply_fn(x, t, c, step) -> eps``."""
    c_in = torch.cat([uncond, cond])

    def model_fn(x, t, step):
        e = apply_fn(torch.cat([x, x]), torch.cat([t, t]), c_in, step)
        e_uc, e_c = e.chunk(2)
        return e_uc + scale * (e_c - e_uc)

    return model_fn


def group_of_step_from_t(cali_t, sample_t) -> np.ndarray:
    """Each sampling step's nearest calibration group by timestep
    (ldm.py:278-286; generalizes the reference's
    ``act_{t_max - (t-1)//tot}``, ddpm.py:1403-1405)."""
    cali_t = np.asarray(cali_t, np.float64)
    sample_t = np.asarray(sample_t, np.float64)
    return np.argmin(np.abs(sample_t[:, None] - cali_t[None, :]), axis=1)
