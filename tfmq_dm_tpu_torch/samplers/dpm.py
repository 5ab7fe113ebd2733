"""The general DPM-Solver / DPM-Solver++ sampler (port of
``tfmq_dm_tpu/samplers/dpm.py``; the reference's dpm_solver.py:6-1113).

Orders 1-3; the singlestep, multistep, singlestep_fixed and adaptive
methods; the 'dpmsolver' (noise prediction) and 'dpmsolver++' (data
prediction) algorithms; the 'dpm_solver' and 'taylor' expansions; the
time_uniform, logSNR and time_quadratic skips; lower_order_final,
denoise_to_zero and Imagen thresholding; ``model_wrapper``'s noise,
x_start, v and score parameterizations with unconditional,
classifier-free and classifier guidance.

The fixed-step methods know every time ahead, so their schedule
quantities and update coefficients are computed on the host in float64
and enter the rollout as float32 scalars of axpys, as the JAX package
bakes them into its scan; the rollout is a Python loop. The multistep
update is one uniform expression whose coefficients switch its higher
order terms off (the warm-up and the lower_order_final tail). The
adaptive method branches on the data: its schedule runs in float32
tensors (the JAX package's ``*_jnp`` variants, ``*_torch`` here) and its
error norm is read on the host once a step.

The model callback is ``model_fn(x, t_model, step) -> eps``, as in the
other samplers. ``step`` is the evaluation's index for multistep, the
block's index for every evaluation of a singlestep block, ``steps`` for
the denoise_to_zero evaluation and 0 for every adaptive evaluation, as
in the JAX package; FSC maps it to a group through ``group_of_step``,
which has one entry per evaluation (``eval_times``) and clamps an index
past its end to the last entry.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import numpy as np
import torch


class NoiseSchedule:
    """VP-SDE noise schedule: 'discrete' (piecewise-linear interpolation
    of 0.5 log(alphas_cumprod), dpm_solver.py:81-122), 'linear' (the DDPM
    closed form) or 'cosine' (improved DDPM's closed form).

    The host methods take and return numpy float64; the fixed-step
    solvers use them. The ``*_torch`` methods compute the same in float32
    tensors for the adaptive solver.
    """

    def __init__(self, schedule: str = "discrete",
                 alphas_cumprod: Optional[np.ndarray] = None,
                 beta_0: float = 0.1, beta_1: float = 20.0,
                 cosine_s: float = 0.008):
        if schedule not in ("discrete", "linear", "cosine"):
            raise ValueError(f"unsupported schedule {schedule!r}")
        self.schedule = schedule
        if schedule == "discrete":
            if alphas_cumprod is None:
                raise ValueError("discrete schedule needs alphas_cumprod")
            ac = np.asarray(alphas_cumprod, np.float64)
            self.total_N = len(ac)
            self.T = 1.0
            self.t_array = np.linspace(0.0, 1.0, self.total_N + 1)[1:]
            self.log_alpha_array = 0.5 * np.log(ac)
        else:
            self.total_N = 1000
            self.beta_0, self.beta_1 = float(beta_0), float(beta_1)
            self.cosine_s = float(cosine_s)
            self.cosine_log_alpha_0 = math.log(
                math.cos(cosine_s / (1.0 + cosine_s) * math.pi / 2.0))
            if schedule == "cosine":
                # T = 1 is numerically singular for cosine
                cosine_beta_max = 999.0
                self.cosine_t_max = (math.atan(cosine_beta_max
                                               * (1.0 + cosine_s) / math.pi)
                                     * 2.0 * (1.0 + cosine_s) / math.pi
                                     - cosine_s)
                self.T = 0.9946
            else:
                self.T = 1.0
        self._tables = {}

    # -- host (numpy, float64) --

    def log_mean_coeff(self, t):
        t = np.asarray(t, np.float64)
        if self.schedule == "discrete":
            return np.interp(t, self.t_array, self.log_alpha_array)
        if self.schedule == "linear":
            return (-0.25 * t ** 2 * (self.beta_1 - self.beta_0)
                    - 0.5 * t * self.beta_0)
        s = self.cosine_s
        return (np.log(np.cos((t + s) / (1.0 + s) * math.pi / 2.0))
                - self.cosine_log_alpha_0)

    def marginal_alpha(self, t):
        return np.exp(self.log_mean_coeff(t))

    def marginal_std(self, t):
        return np.sqrt(1.0 - np.exp(2.0 * self.log_mean_coeff(t)))

    def marginal_lambda(self, t):
        la = self.log_mean_coeff(t)
        return la - 0.5 * np.log1p(-np.exp(2.0 * la))

    def inverse_lambda(self, lam):
        lam = np.asarray(lam, np.float64)
        if self.schedule == "linear":
            tmp = (2.0 * (self.beta_1 - self.beta_0)
                   * np.logaddexp(-2.0 * lam, 0.0))
            delta = self.beta_0 ** 2 + tmp
            return tmp / (np.sqrt(delta) + self.beta_0) \
                / (self.beta_1 - self.beta_0)
        if self.schedule == "discrete":
            log_alpha = -0.5 * np.logaddexp(0.0, -2.0 * lam)
            # log_alpha_array decreases in t: interpolate on the flip
            return np.interp(log_alpha, self.log_alpha_array[::-1],
                             self.t_array[::-1])
        s = self.cosine_s
        log_alpha = -0.5 * np.logaddexp(-2.0 * lam, 0.0)
        return (np.arccos(np.exp(log_alpha + self.cosine_log_alpha_0))
                * 2.0 * (1.0 + s) / math.pi - s)

    def model_time(self, t_cont):
        """Continuous time -> the model's input time (dpm_solver.py:
        278-287): (t - 1/N) * 1000 for discrete schedules (the reference
        multiplies by 1000 whatever N is); continuous-time models take t
        unscaled."""
        t_cont = np.asarray(t_cont, np.float64)
        if self.schedule == "discrete":
            return (t_cont - 1.0 / self.total_N) * 1000.0
        return t_cont

    # -- float32 tensors, for the adaptive solver --

    def _table(self, device):
        """The discrete schedule's float32 (t_array, log_alpha_array) on
        ``device``."""
        key = str(device)
        if key not in self._tables:
            self._tables[key] = tuple(
                torch.as_tensor(np.asarray(a, np.float32), device=device)
                for a in (self.t_array, self.log_alpha_array))
        return self._tables[key]

    def log_mean_coeff_torch(self, t: torch.Tensor) -> torch.Tensor:
        if self.schedule == "discrete":
            t_array, log_alpha = self._table(t.device)
            return _interp(t, t_array, log_alpha)
        if self.schedule == "linear":
            return (-0.25 * t ** 2 * (self.beta_1 - self.beta_0)
                    - 0.5 * t * self.beta_0)
        s = self.cosine_s
        return (torch.log(torch.cos((t + s) / (1.0 + s) * math.pi / 2.0))
                - self.cosine_log_alpha_0)

    def marginal_lambda_torch(self, t: torch.Tensor) -> torch.Tensor:
        la = self.log_mean_coeff_torch(t)
        return la - 0.5 * torch.log1p(-torch.exp(2.0 * la))

    def inverse_lambda_torch(self, lam: torch.Tensor) -> torch.Tensor:
        if self.schedule == "linear":
            tmp = (2.0 * (self.beta_1 - self.beta_0)
                   * torch.logaddexp(-2.0 * lam, torch.zeros_like(lam)))
            delta = self.beta_0 ** 2 + tmp
            return tmp / (torch.sqrt(delta) + self.beta_0) \
                / (self.beta_1 - self.beta_0)
        if self.schedule == "discrete":
            log_alpha = -0.5 * torch.logaddexp(torch.zeros_like(lam),
                                               -2.0 * lam)
            t_array, la_array = self._table(lam.device)
            return _interp(log_alpha, la_array.flip(0), t_array.flip(0))
        s = self.cosine_s
        log_alpha = -0.5 * torch.logaddexp(-2.0 * lam,
                                           torch.zeros_like(lam))
        return (torch.arccos(torch.exp(log_alpha + self.cosine_log_alpha_0))
                * 2.0 * (1.0 + s) / math.pi - s)


def _interp(x: torch.Tensor, xp: torch.Tensor,
            fp: torch.Tensor) -> torch.Tensor:
    """``jnp.interp`` (constant beyond the ends) in float32 tensors, with
    its expressions."""
    xf = x.reshape(-1)
    i = torch.clamp(torch.searchsorted(xp, xf, right=True), 1,
                    len(xp) - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = xf - xp[i - 1]
    dx0 = dx.abs() <= float(np.spacing(np.finfo(np.float32).eps))
    f = torch.where(dx0, fp[i - 1],
                    fp[i - 1] + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(xf < xp[0], fp[0], f)
    f = torch.where(xf > xp[-1], fp[-1], f)
    return f.reshape(x.shape)


def _t_cont(ns: NoiseSchedule, t_model: torch.Tensor) -> torch.Tensor:
    if ns.schedule == "discrete":
        return t_model / 1000.0 + 1.0 / ns.total_N
    return t_model


def _per_row(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return v.reshape((-1,) + (1,) * (x.dim() - 1)).to(x.dtype)


def model_wrapper(apply_fn: Callable, ns: NoiseSchedule, *,
                  model_type: str = "noise",
                  guidance_type: str = "uncond",
                  condition=None, unconditional_condition=None,
                  guidance_scale: float = 1.0,
                  classifier_fn: Optional[Callable] = None,
                  classifier_scale: float = 1.0) -> Callable:
    """Wrap a model into the noise prediction the solver consumes
    (dpm_solver.py:177-349; dpm.py:178-256).

    ``apply_fn(x, t_model[, cond])`` returns the model output of
    ``model_type``: 'noise', 'x_start', 'v' or 'score'. ``guidance_type``:
    'uncond'; 'classifier' (``classifier_fn(x, t_model, cond)`` -> log
    probabilities, guided by their input gradient, taken with
    ``torch.autograd.grad``); or 'classifier-free' (one double batch,
    [unconditional; conditional]). Returns ``model_fn(x, t_model, step) ->
    eps``. The schedule's alpha and sigma at ``t_model`` are float32
    tensors, as JAX computes them on the device."""
    if model_type not in ("noise", "x_start", "v", "score"):
        raise ValueError(f"unknown model_type {model_type!r}")

    def to_noise(x, t_model, out):
        if model_type == "noise":
            return out
        la = ns.log_mean_coeff_torch(_t_cont(ns, t_model))
        alpha = _per_row(torch.exp(la), x)
        sigma = _per_row(torch.sqrt(1.0 - torch.exp(2.0 * la)), x)
        if model_type == "x_start":
            return (x - alpha * out) / sigma
        if model_type == "v":
            return alpha * out + sigma * x
        return -sigma * out

    def noise_pred(x, t_model, cond=None):
        out = apply_fn(x, t_model) if cond is None \
            else apply_fn(x, t_model, cond)
        return to_noise(x, t_model, out)

    if guidance_type == "uncond":
        def model_fn(x, t_model, step):
            return noise_pred(x, t_model)
    elif guidance_type == "classifier":
        if classifier_fn is None:
            raise ValueError("classifier guidance needs classifier_fn")

        def model_fn(x, t_model, step):
            with torch.enable_grad():
                xx = x.detach().requires_grad_(True)
                logp = classifier_fn(xx, t_model, condition).sum()
                grad, = torch.autograd.grad(logp, xx)
            eps = noise_pred(x, t_model)
            la = ns.log_mean_coeff_torch(_t_cont(ns, t_model))
            sigma = _per_row(torch.sqrt(1.0 - torch.exp(2.0 * la)), x)
            return eps - classifier_scale * sigma * grad
    elif guidance_type == "classifier-free":
        def model_fn(x, t_model, step):
            if guidance_scale == 1.0:
                return noise_pred(x, t_model, condition)
            e2 = noise_pred(torch.cat([x, x]), torch.cat([t_model, t_model]),
                            torch.cat([unconditional_condition, condition]))
            e_uc, e_c = e2.chunk(2)
            return e_uc + guidance_scale * (e_c - e_uc)
    else:
        raise ValueError(f"unknown guidance_type {guidance_type!r}")
    return model_fn


# ---------------------------------------------------------------------------
# time grids and order plans (host)
# ---------------------------------------------------------------------------

def get_time_steps(ns: NoiseSchedule, skip_type: str, t_T: float,
                   t_0: float, N: int) -> np.ndarray:
    """dpm_solver.py:410-437."""
    if skip_type == "logSNR":
        lam_T = ns.marginal_lambda(t_T)
        lam_0 = ns.marginal_lambda(t_0)
        return ns.inverse_lambda(np.linspace(lam_T, lam_0, N + 1))
    if skip_type == "time_uniform":
        return np.linspace(t_T, t_0, N + 1)
    if skip_type == "time_quadratic":
        return np.linspace(t_T ** 0.5, t_0 ** 0.5, N + 1) ** 2
    raise ValueError(f"unsupported skip_type {skip_type!r}")


def singlestep_order_plan(steps: int, order: int) -> Sequence[int]:
    """The 'DPM-Solver-fast' order of each block (dpm_solver.py:439-496)."""
    if order == 3:
        k = steps // 3 + 1
        if steps % 3 == 0:
            return [3] * (k - 2) + [2, 1]
        if steps % 3 == 1:
            return [3] * (k - 1) + [1]
        return [3] * (k - 1) + [2]
    if order == 2:
        if steps % 2 == 0:
            return [2] * (steps // 2)
        return [2] * (steps // 2) + [1]
    if order == 1:
        return [1] * steps
    raise ValueError("order must be 1, 2 or 3")


def _singlestep_blocks(ns, method, steps, order, skip_type, t_T, t_0):
    """(orders, outer times) of the singlestep methods' blocks
    (dpm.py:534-545)."""
    if method == "singlestep":
        orders = singlestep_order_plan(steps, order)
        if skip_type == "logSNR":
            ts_outer = get_time_steps(ns, skip_type, t_T, t_0, len(orders))
        else:
            ts = get_time_steps(ns, skip_type, t_T, t_0, steps)
            ts_outer = ts[np.cumsum([0] + list(orders))]
    else:
        k = steps // order
        orders = [order] * k
        ts_outer = get_time_steps(ns, skip_type, t_T, t_0, k)
    return orders, ts_outer


def _block_lambdas(ns, skip_type, s_i, t_i, od):
    """(lambdas of the block's nodes at the skip's spacing inside [s_i,
    t_i], r1, r2): the inner nodes' logSNR fractions of a block of order
    ``od``."""
    lam = ns.marginal_lambda(get_time_steps(ns, skip_type, s_i, t_i, od))
    h = lam[-1] - lam[0]
    r1 = None if od <= 1 else float((lam[1] - lam[0]) / h)
    r2 = None if od <= 2 else float((lam[2] - lam[0]) / h)
    return lam, r1, r2


# ---------------------------------------------------------------------------
# update math (every method; coefficients are host floats)
# ---------------------------------------------------------------------------

def _solver_value(pp: bool, thresholding: bool, max_val: float,
                  x, eps, alpha, sigma):
    """What the recurrences consume: eps for 'dpmsolver', the x0
    prediction (x - sigma eps) / alpha for 'dpmsolver++', optionally
    Imagen-thresholded (dpm_solver.py:386-408)."""
    if not pp:
        return eps
    x0 = (x - sigma * eps) / alpha
    if thresholding:
        s = torch.quantile(x0.abs().reshape(x0.shape[0], -1), 0.995, dim=1)
        s = _per_row(torch.clamp_min(s, max_val), x0)
        x0 = torch.minimum(torch.maximum(x0, -s), s) / s
    return x0


def _first_update_coeffs(ns, s, t, pp: bool):
    """(cx, cm): x_t = cx x + cm model_s (dpm_solver.py:504-549)."""
    lam_s, lam_t = ns.marginal_lambda(s), ns.marginal_lambda(t)
    h = lam_t - lam_s
    if pp:
        cx = ns.marginal_std(t) / ns.marginal_std(s)
        cm = -ns.marginal_alpha(t) * np.expm1(-h)
    else:
        cx = np.exp(ns.log_mean_coeff(t) - ns.log_mean_coeff(s))
        cm = -ns.marginal_std(t) * np.expm1(h)
    return float(cx), float(cm)


def _axpy(cx, x, *cms):
    out = cx * x
    for c, m in cms:
        out = out + c * m
    return out


def _singlestep_update(model_fn, ns, x, s, t, order, *, pp: bool,
                       taylor: bool, step_idx: int,
                       r1: Optional[float], r2: Optional[float],
                       taps: Optional[list], thresholding: bool = False,
                       max_val: float = 1.0):
    """One singlestep update of ``order`` from time s to t, every
    coefficient on the host (dpm_solver.py:504-753; dpm.py:335-442);
    every evaluation carries ``step_idx``. ``taps`` collects (x, t_model)
    at each evaluation when not None."""
    n = x.shape[0]

    def evals(xx, t_cont):
        tm = torch.full((n,), float(ns.model_time(t_cont)),
                        dtype=torch.float32, device=x.device)
        if taps is not None:
            taps.append((xx, tm))
        eps = model_fn(xx, tm, step_idx)
        return _solver_value(pp, thresholding, max_val, xx, eps,
                             float(ns.marginal_alpha(t_cont)),
                             float(ns.marginal_std(t_cont)))

    if order == 1:
        cx, cm = _first_update_coeffs(ns, s, t, pp)
        return _axpy(cx, x, (cm, evals(x, s)))

    lam_s, lam_t = ns.marginal_lambda(s), ns.marginal_lambda(t)
    h = lam_t - lam_s
    if order == 2:
        r1 = 0.5 if r1 is None else r1
        s1 = float(ns.inverse_lambda(lam_s + r1 * h))
        m_s = evals(x, s)
        cx1, cm1 = _first_update_coeffs(ns, s, s1, pp)
        m_s1 = evals(_axpy(cx1, x, (cm1, m_s)), s1)
        if pp:
            cx = ns.marginal_std(t) / ns.marginal_std(s)
            phi = np.expm1(-h)
            a_t = ns.marginal_alpha(t)
            cd = a_t * (np.expm1(-h) / h + 1.0) / r1 if taylor \
                else -(0.5 / r1) * a_t * phi
            return _axpy(float(cx), x, (float(-a_t * phi), m_s),
                         (float(cd), m_s1 - m_s))
        cx = np.exp(ns.log_mean_coeff(t) - ns.log_mean_coeff(s))
        phi = np.expm1(h)
        sig_t = ns.marginal_std(t)
        cd = -(1.0 / r1) * sig_t * (np.expm1(h) / h - 1.0) if taylor \
            else -(0.5 / r1) * sig_t * phi
        return _axpy(float(cx), x, (float(-sig_t * phi), m_s),
                     (float(cd), m_s1 - m_s))

    if order != 3:
        raise ValueError("order must be 1, 2 or 3")
    r1 = 1.0 / 3.0 if r1 is None else r1
    r2 = 2.0 / 3.0 if r2 is None else r2
    s1 = float(ns.inverse_lambda(lam_s + r1 * h))
    s2 = float(ns.inverse_lambda(lam_s + r2 * h))
    m_s = evals(x, s)
    cx1, cm1 = _first_update_coeffs(ns, s, s1, pp)
    m_s1 = evals(_axpy(cx1, x, (cm1, m_s)), s1)
    if pp:
        sig = ns.marginal_std
        a_s2, a_t = ns.marginal_alpha(s2), ns.marginal_alpha(t)
        phi_12 = np.expm1(-r2 * h)
        phi_22 = np.expm1(-r2 * h) / (r2 * h) + 1.0
        x_s2 = _axpy(float(sig(s2) / sig(s)), x,
                     (float(-a_s2 * phi_12), m_s),
                     (float(r2 / r1 * a_s2 * phi_22), m_s1 - m_s))
        m_s2 = evals(x_s2, s2)
        phi_1 = np.expm1(-h)
        phi_2 = phi_1 / h + 1.0
        phi_3 = phi_2 / h - 0.5
        if taylor:
            d1_0 = (1.0 / r1) * (m_s1 - m_s)
            d1_1 = (1.0 / r2) * (m_s2 - m_s)
            d1 = (r2 * d1_0 - r1 * d1_1) / (r2 - r1)
            d2 = 2.0 * (d1_1 - d1_0) / (r2 - r1)
            return _axpy(float(sig(t) / sig(s)), x,
                         (float(-a_t * phi_1), m_s),
                         (float(a_t * phi_2), d1),
                         (float(-a_t * phi_3), d2))
        return _axpy(float(sig(t) / sig(s)), x,
                     (float(-a_t * phi_1), m_s),
                     (float(a_t * phi_2 / r2), m_s2 - m_s))
    la = ns.log_mean_coeff
    sig_s2, sig_t = ns.marginal_std(s2), ns.marginal_std(t)
    phi_12 = np.expm1(r2 * h)
    phi_22 = np.expm1(r2 * h) / (r2 * h) - 1.0
    x_s2 = _axpy(float(np.exp(la(s2) - la(s))), x,
                 (float(-sig_s2 * phi_12), m_s),
                 (float(-r2 / r1 * sig_s2 * phi_22), m_s1 - m_s))
    m_s2 = evals(x_s2, s2)
    phi_1 = np.expm1(h)
    phi_2 = phi_1 / h - 1.0
    phi_3 = phi_2 / h - 0.5
    if taylor:
        d1_0 = (1.0 / r1) * (m_s1 - m_s)
        d1_1 = (1.0 / r2) * (m_s2 - m_s)
        d1 = (r2 * d1_0 - r1 * d1_1) / (r2 - r1)
        d2 = 2.0 * (d1_1 - d1_0) / (r2 - r1)
        return _axpy(float(np.exp(la(t) - la(s))), x,
                     (float(-sig_t * phi_1), m_s),
                     (float(-sig_t * phi_2), d1),
                     (float(-sig_t * phi_3), d2))
    return _axpy(float(np.exp(la(t) - la(s))), x,
                 (float(-sig_t * phi_1), m_s),
                 (float(-sig_t * phi_2 / r2), m_s2 - m_s))


def eval_times(ns: NoiseSchedule, *, steps: int = 20, order: int = 3,
               method: str = "multistep", skip_type: str = "time_uniform",
               t_start: Optional[float] = None,
               t_end: Optional[float] = None) -> np.ndarray:
    """The model times of every evaluation a fixed-step configuration
    makes, in order: the axis FSC calibrates over (one entry an
    evaluation, the ``collect='traj'`` tap times; denoise_to_zero's extra
    evaluation is not among them, dpm.py:445-486)."""
    t_0 = 1.0 / ns.total_N if t_end is None else t_end
    t_T = ns.T if t_start is None else t_start
    if method == "multistep":
        ts = get_time_steps(ns, skip_type, t_T, t_0, steps)
        return ns.model_time(ts[:steps])
    if method not in ("singlestep", "singlestep_fixed"):
        raise ValueError(f"no static eval times for method {method!r}")
    orders, ts_outer = _singlestep_blocks(ns, method, steps, order,
                                          skip_type, t_T, t_0)
    out = []
    for i, od in enumerate(orders):
        s_i, t_i = float(ts_outer[i]), float(ts_outer[i + 1])
        lam, r1, r2 = _block_lambdas(ns, skip_type, s_i, t_i, od)
        # the inner nodes from the grid's own end lambdas, as JAX's
        # eval_times places them (the update starts from lambda(s_i),
        # which a logSNR grid's inverse reproduces to rounding)
        out.append(s_i)
        for r in (r1, r2):
            if r is not None:
                out.append(float(ns.inverse_lambda(
                    lam[0] + r * (lam[-1] - lam[0]))))
    return ns.model_time(np.asarray(out))


# ---------------------------------------------------------------------------
# the sampler
# ---------------------------------------------------------------------------

@torch.no_grad()
def dpm_solver_sample(model_fn, ns: NoiseSchedule, x: torch.Tensor, *,
                      steps: int = 20, order: int = 3,
                      method: str = "multistep",
                      skip_type: str = "time_uniform",
                      algorithm_type: str = "dpmsolver++",
                      solver_type: str = "dpm_solver",
                      lower_order_final: bool = True,
                      denoise_to_zero: bool = False,
                      t_start: Optional[float] = None,
                      t_end: Optional[float] = None,
                      atol: float = 0.0078, rtol: float = 0.05,
                      thresholding: bool = False, max_val: float = 1.0,
                      collect: str = "none"):
    """Sample with any DPM-Solver configuration (``DPM_Solver.sample``,
    dpm_solver.py:965-1113; dpm.py:493-579); ``model_fn(x, t_model, step)
    -> eps``. ``collect='traj'`` (the fixed-step methods) also returns the
    (x, t_model) of every evaluation, stacked: the calibration harvest.
    With denoise_to_zero that is steps + 1 of them, one more than
    ``eval_times`` holds, as in the JAX package."""
    pp = {"dpmsolver++": True, "dpmsolver": False}[algorithm_type]
    taylor = {"taylor": True, "dpm_solver": False}[solver_type]
    if collect not in ("none", "traj"):
        raise ValueError(f"collect must be 'none' or 'traj', got {collect!r}")
    t_0 = 1.0 / ns.total_N if t_end is None else t_end
    t_T = ns.T if t_start is None else t_start
    taps = [] if collect == "traj" else None

    if method == "adaptive":
        if collect != "none":
            raise ValueError("collect is not supported for adaptive")
        x = _adaptive(model_fn, ns, x, order, t_T, t_0, pp=pp,
                      taylor=taylor, atol=atol, rtol=rtol,
                      thresholding=thresholding, max_val=max_val)
        t_last = t_0
    elif method == "multistep":
        x, t_last = _multistep(model_fn, ns, x, steps, order, skip_type,
                               pp=pp, taylor=taylor,
                               lower_order_final=lower_order_final,
                               t_T=t_T, t_0=t_0, taps=taps,
                               thresholding=thresholding, max_val=max_val)
    elif method in ("singlestep", "singlestep_fixed"):
        orders, ts_outer = _singlestep_blocks(ns, method, steps, order,
                                              skip_type, t_T, t_0)
        for i, od in enumerate(orders):
            s_i, t_i = float(ts_outer[i]), float(ts_outer[i + 1])
            _, r1, r2 = _block_lambdas(ns, skip_type, s_i, t_i, od)
            x = _singlestep_update(model_fn, ns, x, s_i, t_i, od, pp=pp,
                                   taylor=taylor, step_idx=i, r1=r1, r2=r2,
                                   taps=taps, thresholding=thresholding,
                                   max_val=max_val)
        t_last = float(ts_outer[-1])
    else:
        raise ValueError(f"unknown method {method!r}")

    if denoise_to_zero:
        # a first-order step to t = 0: the x0 prediction at t_last
        # (dpm_solver.py:498-502)
        tm = torch.full((x.shape[0],), float(ns.model_time(t_last)),
                        dtype=torch.float32, device=x.device)
        if taps is not None:
            taps.append((x, tm))
        eps = model_fn(x, tm, steps)
        x = _solver_value(True, thresholding, max_val, x, eps,
                          float(ns.marginal_alpha(t_last)),
                          float(ns.marginal_std(t_last)))

    if collect == "none":
        return x
    return x, (torch.stack([p[0] for p in taps]),
               torch.stack([p[1] for p in taps]))


def _multistep(model_fn, ns, x, steps, order, skip_type, *, pp, taylor,
               lower_order_final, t_T, t_0, taps, thresholding=False,
               max_val=1.0):
    """The multistep loop (dpm_solver.py:1075-1115; dpm.py:582-679), one
    update expression for every order, its coefficients float32 and
    computed on the host in float64:

        d10  = e_i (m0 - m1)
        diff = d10 - f_i (m1 - m2)
        x'   = a_i x + b_i m0 + c_i (d10 + g_i diff) + d_i diff

    order 1: c = d = 0; order 2 dpm_solver: c = b / 2; order 2 taylor: the
    phi_2 coefficient; order 3: c, g, d from the D1 / D2 algebra."""
    if steps < order:
        raise ValueError(f"multistep needs steps >= order, got {steps} < "
                         f"{order}")
    ts = get_time_steps(ns, skip_type, t_T, t_0, steps)
    lam = ns.marginal_lambda(ts)
    sig = ns.marginal_std(ts)
    alp = ns.marginal_alpha(ts)
    la = ns.log_mean_coeff(ts)
    A, B, C, D, E, F, G = (np.zeros(steps + 1) for _ in range(7))
    for i in range(1, steps + 1):
        if lower_order_final and steps < 15:
            od = min(order, min(i, steps + 1 - i))
        else:
            od = min(order, i)
        h = lam[i] - lam[i - 1]
        if pp:
            A[i] = sig[i] / sig[i - 1]
            B[i] = -alp[i] * np.expm1(-h)
        else:
            A[i] = np.exp(la[i] - la[i - 1])
            B[i] = -sig[i] * np.expm1(h)
        if od < 2:
            continue
        r0 = (lam[i - 1] - lam[i - 2]) / h
        E[i] = 1.0 / r0
        phi2 = (alp[i] * (np.expm1(-h) / h + 1.0) if pp
                else -sig[i] * (np.expm1(h) / h - 1.0))
        if od == 2:
            C[i] = phi2 if taylor else 0.5 * B[i]
            continue
        r1 = (lam[i - 2] - lam[i - 3]) / h
        F[i] = 1.0 / r1
        G[i] = r0 / (r0 + r1)
        C[i] = phi2
        phi3 = ((np.expm1(-h) + h) / h ** 2 - 0.5 if pp
                else (np.expm1(h) - h) / h ** 2 - 0.5)
        D[i] = (-alp[i] if pp else -sig[i]) * phi3 / (r0 + r1)
    A, B, C, D, E, F, G, tm, alp32, sig32 = (
        [float(v) for v in np.asarray(a, np.float32)]
        for a in (A, B, C, D, E, F, G, ns.model_time(ts), alp, sig))
    n = x.shape[0]

    def eval_model(xx, i):
        t_b = torch.full((n,), tm[i], dtype=torch.float32, device=x.device)
        if taps is not None:
            taps.append((xx, t_b))
        eps = model_fn(xx, t_b, i)
        return _solver_value(pp, thresholding, max_val, xx, eps, alp32[i],
                             sig32[i])

    m0 = eval_model(x, 0)
    m1 = m2 = m0
    for i in range(1, steps + 1):
        d10 = E[i] * (m0 - m1)
        diff = d10 - F[i] * (m1 - m2)
        x = (A[i] * x + B[i] * m0 + C[i] * (d10 + G[i] * diff)
             + D[i] * diff)
        if i < steps:      # no evaluation after the last update
            m0, m1, m2 = eval_model(x, i), m0, m1
    return x, float(ts[-1])


def _adaptive(model_fn, ns, x, order, t_T, t_0, *, pp, taylor, atol, rtol,
              h_init=0.05, theta=0.9, t_err=1e-5, thresholding=False,
              max_val=1.0):
    """The adaptive step size solver (dpm_solver.py:909-963; dpm.py:
    682-803): order 2 pairs DPM-Solver-1 with singlestep-2, order 3
    singlestep-2 with singlestep-3. Its schedule runs in float32 tensors
    on x's device as JAX's does on its device; the error norm decides on
    the host whether a step is taken. The number of evaluations depends on
    the data; each carries step 0."""
    if order not in (2, 3):
        raise ValueError("adaptive solver needs order 2 or 3")
    n = x.shape[0]
    dev = x.device

    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=dev)

    lam_0 = ns.marginal_lambda_torch(f32(t_0))

    def tmodel(t_cont):
        tc = (t_cont - 1.0 / ns.total_N) * 1000.0 \
            if ns.schedule == "discrete" else t_cont
        return tc.expand(n).contiguous()

    def sched(t):
        la = ns.log_mean_coeff_torch(t)
        alpha = torch.exp(la)
        sigma = torch.sqrt(1.0 - torch.exp(2.0 * la))
        lam = la - 0.5 * torch.log1p(-torch.exp(2.0 * la))
        return la, alpha, sigma, lam

    def mval(xx, t_cont):
        _, alpha, sigma, _ = sched(t_cont)
        eps = model_fn(xx, tmodel(t_cont), 0)
        return _solver_value(pp, thresholding, max_val, xx, eps, alpha,
                             sigma)

    def first_update(x, s, t, m_s):
        la_s, _, sig_s, lam_s = sched(s)
        la_t, a_t, sig_t, lam_t = sched(t)
        h = lam_t - lam_s
        if pp:
            return (sig_t / sig_s) * x - a_t * torch.expm1(-h) * m_s
        return torch.exp(la_t - la_s) * x - sig_t * torch.expm1(h) * m_s

    def second_update(x, s, t, m_s, r1=0.5):
        la_s, _, sig_s, lam_s = sched(s)
        la_t, a_t, sig_t, lam_t = sched(t)
        h = lam_t - lam_s
        s1 = ns.inverse_lambda_torch(lam_s + r1 * h)
        m_s1 = mval(first_update(x, s, s1, m_s), s1)
        if pp:
            phi = torch.expm1(-h)
            cd = a_t * (torch.expm1(-h) / h + 1.0) / r1 if taylor \
                else -(0.5 / r1) * a_t * phi
            return ((sig_t / sig_s) * x - a_t * phi * m_s
                    + cd * (m_s1 - m_s)), m_s1
        phi = torch.expm1(h)
        cd = -(1.0 / r1) * sig_t * (torch.expm1(h) / h - 1.0) if taylor \
            else -(0.5 / r1) * sig_t * phi
        return (torch.exp(la_t - la_s) * x - sig_t * phi * m_s
                + cd * (m_s1 - m_s)), m_s1

    def third_update(x, s, t, m_s, m_s1, r1=1 / 3, r2=2 / 3):
        la_s, _, sig_s, lam_s = sched(s)
        la_t, a_t, sig_t, lam_t = sched(t)
        h = lam_t - lam_s
        s2 = ns.inverse_lambda_torch(lam_s + r2 * h)
        la2, a_s2, sig_s2, _ = sched(s2)
        if pp:
            phi_12 = torch.expm1(-r2 * h)
            phi_22 = torch.expm1(-r2 * h) / (r2 * h) + 1.0
            x_s2 = ((sig_s2 / sig_s) * x - a_s2 * phi_12 * m_s
                    + (r2 / r1) * a_s2 * phi_22 * (m_s1 - m_s))
            m_s2 = mval(x_s2, s2)
            phi_1 = torch.expm1(-h)
            phi_2 = phi_1 / h + 1.0
            return ((sig_t / sig_s) * x - a_t * phi_1 * m_s
                    + (a_t * phi_2 / r2) * (m_s2 - m_s))
        phi_12 = torch.expm1(r2 * h)
        phi_22 = torch.expm1(r2 * h) / (r2 * h) - 1.0
        x_s2 = (torch.exp(la2 - la_s) * x - sig_s2 * phi_12 * m_s
                - (r2 / r1) * sig_s2 * phi_22 * (m_s1 - m_s))
        m_s2 = mval(x_s2, s2)
        phi_1 = torch.expm1(h)
        phi_2 = phi_1 / h - 1.0
        return (torch.exp(la_t - la_s) * x - sig_t * phi_1 * m_s
                - (sig_t * phi_2 / r2) * (m_s2 - m_s))

    x_prev = x
    s, h = f32(t_T), f32(h_init)
    while bool(torch.abs(s - t_0) > t_err):
        t = ns.inverse_lambda_torch(ns.marginal_lambda_torch(s) + h)
        m_s = mval(x, s)
        if order == 2:
            x_lower = first_update(x, s, t, m_s)
            x_higher, _ = second_update(x, s, t, m_s)
        else:
            x_lower, m_s1 = second_update(x, s, t, m_s, r1=1 / 3)
            x_higher = third_update(x, s, t, m_s, m_s1)
        delta = torch.clamp_min(rtol * torch.maximum(x_lower.abs(),
                                                     x_prev.abs()), atol)
        err = torch.sqrt(torch.mean(
            torch.square((x_higher - x_lower) / delta).reshape(n, -1),
            dim=-1)).max()
        if bool(err <= 1.0):
            x, s, x_prev = x_higher, t, x_lower
        h = torch.minimum(theta * h * err ** (-1.0 / order),
                          lam_0 - ns.marginal_lambda_torch(s))
    return x
