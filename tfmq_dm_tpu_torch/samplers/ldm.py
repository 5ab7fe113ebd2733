"""LDM-family DDIM, PLMS and DPM-Solver++ (2M) samplers, classifier-free
guidance and FSC step mapping (port of ``tfmq_dm_tpu/samplers/ldm.py``;
the reference's ldm/models/diffusion/{ddim,plms}.py and
dpm_solver/dpm_solver.py).

Schedule quantities are computed on the host per step, in float32 like
the JAX tables; the rollout is a Python loop over the steps. The model
callback receives the step index, so FSC selects its per-timestep state
by step. The general DPM-Solver engine is ``samplers/dpm.py``.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from .ddim import check_noise, step_noise


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
                  collect: str = "none",
                  noise: Optional[torch.Tensor] = None):
    """p_sample_ddim loop (ddim.py:123-175). ``collect="traj"`` also
    returns the model inputs (x_t, t) of every step, stacked. The noise of
    stochastic steps (eta > 0, ffhq256 / lsun_beds256) is drawn with
    ``generator``, one step at a time, or read from ``noise``, a
    (steps, N, H, W, C) tensor of unit normals (step i's at ``noise[i]``;
    JAX draws it from ``fold_in(key, i)``, samplers/ldm.py:105)."""
    if collect not in ("none", "traj"):
        raise ValueError(f"collect must be 'none' or 'traj', got {collect!r}")
    f32 = np.float32
    a_t = sched.a_t.astype(f32)
    a_prev = sched.a_prev.astype(f32)
    sigma = sched.sigma.astype(f32)
    s1ma = sched.sqrt_1m_a.astype(f32)
    check_noise(noise, sched.num_steps, x)
    if np.any(sigma > 0) and generator is None and noise is None:
        raise ValueError("eta > 0 needs a torch.Generator or the noise")
    n = x.shape[0]
    xs, ts = [], []
    xt = x
    for i in range(sched.num_steps):
        t_b = torch.full((n,), int(sched.t[i]), dtype=torch.int32,
                         device=x.device)
        e_t = _promoted(model_fn(xt, t_b, i), xt)
        pred_x0 = (xt - float(s1ma[i]) * e_t) / float(np.sqrt(a_t[i]))
        dir_xt = float(np.sqrt(np.maximum(
            f32(1.0) - a_prev[i] - sigma[i] ** 2, f32(0.0)))) * e_t
        x_prev = float(np.sqrt(a_prev[i])) * pred_x0 + dir_xt
        if sigma[i] > 0:
            x_prev = x_prev + float(sigma[i]) * step_noise(
                noise, generator, i, xt)
        if collect == "traj":
            xs.append(xt)
            ts.append(t_b)
        xt = x_prev
    if collect == "none":
        return xt
    return xt, (torch.stack(xs), torch.stack(ts))


def _promoted(e: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A bf16 eps (the fast deploy) meets the f32 step scalars in f32, as
    JAX promotes it."""
    return e.to(torch.promote_types(e.dtype, x.dtype))


@torch.no_grad()
def plms_scan(model_fn, sched: DDIMScheduleLDM, x: torch.Tensor,
              collect: str = "none"):
    """PLMS sampling loop (plms.py:120-240; ldm.py:115-172):
    Adams-Bashforth multistep on eps over a newest-first buffer of the
    three previous eps, the order (1-4) chosen by the step index. Step 0
    is a pseudo improved Euler step: it evaluates the model a second time
    at (x_prev, t_next), and that evaluation carries the step index
    min(i + 1, n - 1), so under FSC it takes the next step's group; a
    rollout of n steps is n + 1 model evaluations. ``collect="traj"``
    also returns each step's main model input (x_t, t), stacked."""
    if collect not in ("none", "traj"):
        raise ValueError(f"collect must be 'none' or 'traj', got {collect!r}")
    if sched.num_steps < 1:
        raise ValueError("PLMS needs at least one step")
    f32 = np.float32
    a_t = sched.a_t.astype(f32)
    a_prev = sched.a_prev.astype(f32)
    s1ma = sched.sqrt_1m_a.astype(f32)
    t_next = np.concatenate([sched.t[1:], sched.t[-1:]])
    last = sched.num_steps - 1
    n = x.shape[0]

    def t_batch(t):
        return torch.full((n,), int(t), dtype=torch.int32, device=x.device)

    def x_prev_from(e, xt, i):
        pred_x0 = (xt - float(s1ma[i]) * e) / float(np.sqrt(a_t[i]))
        dir_xt = float(np.sqrt(f32(1.0) - a_prev[i])) * e
        return float(np.sqrt(a_prev[i])) * pred_x0 + dir_xt

    eps = []                       # newest first, at most three
    xs, ts = [], []
    xt = x
    for i in range(sched.num_steps):
        t_b = t_batch(sched.t[i])
        e_t = _promoted(model_fn(xt, t_b, i), xt)
        if i == 0:
            e_next = _promoted(model_fn(x_prev_from(e_t, xt, i),
                                        t_batch(t_next[i]),
                                        min(i + 1, last)), xt)
            e_prime = (e_t + e_next) / 2.0
        elif i == 1:
            e_prime = (3.0 * e_t - eps[0]) / 2.0
        elif i == 2:
            e_prime = (23.0 * e_t - 16.0 * eps[0] + 5.0 * eps[1]) / 12.0
        else:
            e_prime = (55.0 * e_t - 59.0 * eps[0] + 37.0 * eps[1]
                       - 9.0 * eps[2]) / 24.0
        x_prev = x_prev_from(e_prime, xt, i)
        eps = [e_t] + eps[:2]
        if collect == "traj":
            xs.append(xt)
            ts.append(t_b)
        xt = x_prev
    if collect == "none":
        return xt
    return xt, (torch.stack(xs), torch.stack(ts))


class DPMSchedule:
    """NoiseScheduleVP('discrete') quantities sampled at uniform
    continuous times (dpm_solver.py:95-160, 410-436; ldm.py:176-197):
    S + 1 times from T = 1 to 1/N; alpha, sigma and lambda by linear
    interpolation of 0.5 log(alphas_cumprod) over t_array = linspace(0, 1,
    N + 1)[1:]; float64."""

    def __init__(self, alphas_cumprod: np.ndarray, steps: int):
        ac = np.asarray(alphas_cumprod, np.float64)
        n = len(ac)
        log_alpha = 0.5 * np.log(ac)
        t_array = np.linspace(0.0, 1.0, n + 1)[1:]
        t_cont = np.linspace(1.0, 1.0 / n, steps + 1)
        la = np.interp(t_cont, t_array, log_alpha)
        self.t_cont = t_cont
        self.model_t = (t_cont - 1.0 / n) * 1000.0   # model input times
        self.log_alpha = la
        self.alpha = np.exp(la)
        self.sigma = np.sqrt(1.0 - np.exp(2.0 * la))
        self.lam = la - 0.5 * np.log(1.0 - np.exp(2.0 * la))
        self.steps = steps


@torch.no_grad()
def dpm_solver_pp_2m_scan(model_fn, sched: DPMSchedule, x: torch.Tensor,
                          lower_order_final: bool = True,
                          collect: str = "none"):
    """DPM-Solver++ multistep order 2 on x0 predictions (dpm_solver.py:
    755-795, the sample() multistep loop :1075-1115; ldm.py:200-258).
    ``model_fn`` returns eps; one evaluation a step (NFE = steps, the
    first at t_0, none after the last update). The first update, and the
    last when ``lower_order_final`` and steps < 15, are first order. The
    step scalars are float32, computed with the JAX scan's expressions.
    ``collect="traj"`` also returns the model inputs (x, t) of the
    ``steps`` evaluations, t the float32 model times."""
    if collect not in ("none", "traj"):
        raise ValueError(f"collect must be 'none' or 'traj', got {collect!r}")
    f32 = np.float32
    steps = sched.steps
    lam = sched.lam.astype(f32)
    alpha = sched.alpha.astype(f32)
    sigma = sched.sigma.astype(f32)
    model_t = sched.model_t.astype(f32)
    w2 = np.full(steps + 1, f32(0.5), f32)
    w2[1] = 0.0
    if lower_order_final and steps < 15:
        w2[steps] = 0.0
    n = x.shape[0]
    xs, ts = [], []

    def x0_pred(xt, i):
        t_b = torch.full((n,), float(model_t[i]), dtype=torch.float32,
                         device=x.device)
        if collect == "traj":
            xs.append(xt)
            ts.append(t_b)
        eps = _promoted(model_fn(xt, t_b, i), xt)
        return (xt - float(sigma[i]) * eps) / float(alpha[i])

    m_prev = m_prev_prev = x0_pred(x, 0)
    lam_pp = lam[0]
    xt = x
    for i in range(1, steps + 1):
        h = lam[i] - lam[i - 1]
        h0 = lam[i - 1] - lam_pp
        r0 = h0 / h if h0 != 0 else f32(1.0)
        d1 = (m_prev - m_prev_prev) / float(np.maximum(r0, f32(1e-12)))
        phi = np.expm1(-h)
        xt = float(sigma[i] / sigma[i - 1]) * xt \
            - float(alpha[i] * phi) * m_prev \
            - float(w2[i] * alpha[i] * phi) * d1
        lam_pp = lam[i - 1]
        m_prev_prev = m_prev
        if i < steps:
            m_prev = x0_pred(xt, i)
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
