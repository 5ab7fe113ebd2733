"""The port's samplers against the JAX package's, on toy model functions
(the ``_toy_jax`` of tests/test_dpm_general.py and its torch twin) and
numpy-seeded inputs, on the CPU: DDPM (``ddpm_scan``), DDIM's x0 trace
(``generalized_scan(collect="x0")``), the DPM-Solver++ 2M scan with its
taps, and the general DPM-Solver engine (``samplers/dpm.py``) over
test_dpm_general.py's grid, ``model_wrapper``'s parameterizations and
guidances, thresholding, the continuous schedules and the adaptive
method.

Every evaluation's ``step`` argument is recorded on both sides (JAX's
through an ordered ``jax.debug.callback``) and compared exactly: the
multistep evaluation index, a singlestep block's index at each of its
evaluations, ``steps`` at denoise_to_zero's evaluation and 0 at every
adaptive evaluation. The stochastic steps of both DDIM and DDPM take
JAX's own ``fold_in(key, i)`` draws.

Tolerances. The fixed-step methods use the same float64 host
coefficients rounded to float32 and the same float32 ops, so outputs and
taps are held within ``REL`` (1e-5) of the reference's largest magnitude
(measured at most 6e-7: XLA forms the axpys' FMAs, PyTorch rounds each
product; 4.6e-6 for a sample under classifier guidance of an x_start
model, where JAX's own jitted and eager samples part by 4.3e-6) and the
tap times exactly. The adaptive method's schedule runs
in float32 tensors on both sides; its accept decisions must agree, so
its number of evaluations is compared exactly and its output within
``ADAPTIVE_REL`` (1e-4; measured 6e-7 at order 2 and 5.5e-5 at order 3,
where the float32 ``inverse_lambda`` interpolation of the two
frameworks parts by an ulp and 21 evaluations compound it).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfmq_dm_tpu.samplers import ddim as JDD
from tfmq_dm_tpu.samplers import dpm as JD
from tfmq_dm_tpu.samplers import ldm as JS
from tfmq_dm_tpu.utils.schedules import get_beta_schedule, skip_seq
from tfmq_dm_tpu_torch.samplers import ddim as TDD
from tfmq_dm_tpu_torch.samplers import dpm as TD
from tfmq_dm_tpu_torch.samplers import ldm as TS
from test_dpm_general import CASES, _toy_jax

REL = 1e-5
ADAPTIVE_REL = 1e-4

BETAS_LDM = JS.make_beta_schedule("linear", 1000, linear_start=0.0015,
                                  linear_end=0.0195)
AC = np.cumprod(1 - BETAS_LDM).astype(np.float32)
BETAS_DDPM = get_beta_schedule("linear", beta_start=1e-4, beta_end=0.02,
                               num_diffusion_timesteps=1000)


def _toy_torch(x, t, step):
    tt = t.reshape(-1, 1, 1, 1) / 1000.0
    return torch.tanh(x) * (0.4 + tt) + 0.03 * torch.sin(3.0 * x)


def _x0(seed=0, shape=(2, 8, 8, 3)):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _close(got, ref, rel=REL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= rel * np.abs(ref).max()


class _JaxSteps:
    """A JAX model function that records each evaluation's ``step`` in
    order (inside jit, scans and while loops)."""

    def __init__(self, fn=_toy_jax):
        self.steps, self.fn = [], fn

    def __call__(self, x, t, step):
        jax.debug.callback(lambda s: self.steps.append(int(s)), step,
                           ordered=True)
        return self.fn(x, t, step)

    def read(self):
        jax.effects_barrier()
        return self.steps


class _TorchSteps:
    def __init__(self, fn=_toy_torch):
        self.steps, self.fn = [], fn

    def __call__(self, x, t, step):
        self.steps.append(int(step))
        return self.fn(x, t, step)


def _jax_noise(key, steps, shape):
    """JAX's per-step draws, ``normal(fold_in(key, i))`` (ddim.py:75)."""
    return np.stack([np.asarray(jax.random.normal(
        jax.random.fold_in(key, i), shape, jnp.float32))
        for i in range(steps)])


# ---------------------------------------------------------------------------
# DDPM and DDIM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("skip", ["uniform", "quad"])
def test_ddpm_scan_matches_jax(skip):
    """Fixed-large variance, x0 clipped to [-1, 1], no noise at t == 0
    (the quad sequence starts at 0, the uniform one too): final sample,
    every step's input and t, and ``harvest_trajectory``'s."""
    seq = skip_seq(skip, 1000, 10)
    x0 = _x0(1)
    key = jax.random.PRNGKey(3)
    noise = torch.from_numpy(_jax_noise(key, len(seq), x0.shape))
    jm = _JaxSteps()
    jx, (jxs, jts) = jax.jit(lambda x: JDD.ddpm_scan(
        jm, BETAS_DDPM, seq, x, key, collect="traj"))(jnp.asarray(x0))
    tm = _TorchSteps()
    tx, (txs, tts) = TDD.ddpm_scan(tm, BETAS_DDPM, seq, torch.from_numpy(x0),
                                   noise=noise, collect="traj")
    _close(tx, jx)
    _close(txs, jxs)
    np.testing.assert_array_equal(tts.numpy(), np.asarray(jts))
    assert tts.dtype == torch.int32
    assert tm.steps == jm.read() == list(range(len(seq)))
    hx, ht = TDD.harvest_trajectory(_toy_torch, BETAS_DDPM, seq,
                                    torch.from_numpy(x0),
                                    sample_type="ddpm_noisy", noise=noise)
    assert torch.equal(hx, txs) and torch.equal(ht, tts)


def test_ddpm_scan_draws_from_the_generator():
    """Without ``noise`` each step but the last (t == 0) draws from the
    generator, in step order."""
    seq = skip_seq("uniform", 1000, 5)
    x0 = torch.from_numpy(_x0(2))
    got = TDD.ddpm_scan(_toy_torch, BETAS_DDPM, seq, x0,
                        torch.Generator().manual_seed(4))
    g = torch.Generator().manual_seed(4)
    draws = [torch.randn(x0.shape, generator=g) for _ in range(len(seq) - 1)]
    noise = torch.stack(draws + [torch.full(x0.shape, float("nan"))])
    want = TDD.ddpm_scan(_toy_torch, BETAS_DDPM, seq, x0, noise=noise)
    assert torch.equal(got, want)
    with pytest.raises(ValueError):
        TDD.ddpm_scan(_toy_torch, BETAS_DDPM, seq, x0)


@pytest.mark.parametrize("eta", [0.0, 0.5])
def test_generalized_collect_x0_matches_jax(eta):
    """``collect="x0"``: one x0 prediction a step, and a final sample
    bit-equal to ``collect="none"``'s."""
    seq = skip_seq("uniform", 1000, 8)
    x0 = _x0(5)
    key = jax.random.PRNGKey(7)
    noise = torch.from_numpy(_jax_noise(key, len(seq), x0.shape))
    jx, jx0s = jax.jit(lambda x: JDD.generalized_scan(
        _toy_jax, BETAS_DDPM, seq, x, key, eta=eta, collect="x0"))(
        jnp.asarray(x0))
    tx, tx0s = TDD.generalized_scan(_toy_torch, BETAS_DDPM, seq,
                                    torch.from_numpy(x0), eta=eta,
                                    collect="x0", noise=noise)
    assert tuple(tx0s.shape) == (len(seq),) + x0.shape
    _close(tx, jx)
    _close(tx0s, jx0s)
    plain = TDD.generalized_scan(_toy_torch, BETAS_DDPM, seq,
                                 torch.from_numpy(x0), eta=eta, noise=noise)
    assert torch.equal(plain, tx)


# ---------------------------------------------------------------------------
# DPM-Solver++ 2M
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("steps", [4, 8, 16])
def test_dpm_2m_scan_matches_jax(steps):
    """The schedule, the sample and its taps: NFE = steps, the first
    evaluation at the starting noise, float32 model times; at 16 steps
    lower_order_final is off."""
    js, ts_ = JS.DPMSchedule(AC, steps), TS.DPMSchedule(AC, steps)
    for name in ("t_cont", "model_t", "alpha", "sigma", "lam"):
        np.testing.assert_array_equal(getattr(ts_, name), getattr(js, name))
    x0 = _x0(2)
    jm = _JaxSteps()
    jx, (jxs, jts) = jax.jit(lambda x: JS.dpm_solver_pp_2m_scan(
        jm, js, x, collect="traj"))(jnp.asarray(x0))
    tm = _TorchSteps()
    tx, (txs, tts) = TS.dpm_solver_pp_2m_scan(tm, ts_, torch.from_numpy(x0),
                                              collect="traj")
    _close(tx, jx)
    _close(txs, jxs)
    assert tts.dtype == torch.float32 and tuple(tts.shape) == (steps, 2)
    np.testing.assert_array_equal(tts.numpy(), np.asarray(jts))
    np.testing.assert_array_equal(txs[0].numpy(), x0)
    assert tm.steps == jm.read() == list(range(steps))
    assert torch.equal(TS.dpm_solver_pp_2m_scan(_toy_torch, ts_,
                                                torch.from_numpy(x0)), tx)


# ---------------------------------------------------------------------------
# the general engine
# ---------------------------------------------------------------------------

def _ns():
    return (JD.NoiseSchedule("discrete", alphas_cumprod=AC),
            TD.NoiseSchedule("discrete", alphas_cumprod=AC))


def _engine_pair(kw, x0, nsj, nst, jfn=_toy_jax, tfn=_toy_torch):
    """(JAX (x, (xs, ts)) and steps, port's) of one configuration with
    the taps; JAX's jitted once."""
    jm, tm = _JaxSteps(jfn), _TorchSteps(tfn)
    j = jax.jit(lambda x: JD.dpm_solver_sample(jm, nsj, x, collect="traj",
                                               **kw))(jnp.asarray(x0))
    t = TD.dpm_solver_sample(tm, nst, torch.from_numpy(x0), collect="traj",
                             **kw)
    return j, jm.read(), t, tm.steps


@pytest.mark.parametrize(
    "method,steps,order,algo,stype,skip,dtz", CASES,
    ids=[f"{m}-s{s}-o{o}-{a}-{st}-{sk}{'-dtz' if d else ''}"
         for m, s, o, a, st, sk, d in CASES])
def test_dpm_solver_matches_jax(method, steps, order, algo, stype, skip,
                                dtz):
    """test_dpm_general.py's grid: the sample, every evaluation's input
    and model time, its step argument, and ``eval_times`` equal to the tap
    times (one more tap with denoise_to_zero, as in JAX)."""
    nsj, nst = _ns()
    kw = dict(steps=steps, order=order, method=method, skip_type=skip,
              algorithm_type=algo, solver_type=stype,
              lower_order_final=not (method == "multistep" and order == 3
                                     and steps < 15),
              denoise_to_zero=bool(dtz))
    (jx, (jxs, jts)), jsteps, (tx, (txs, tts)), tsteps = _engine_pair(
        kw, _x0(), nsj, nst)
    _close(tx, jx)
    _close(txs, jxs)
    np.testing.assert_array_equal(tts.numpy(), np.asarray(jts))
    assert tsteps == jsteps
    times = TD.eval_times(nst, steps=steps, order=order, method=method,
                          skip_type=skip)
    np.testing.assert_array_equal(times, JD.eval_times(
        nsj, steps=steps, order=order, method=method, skip_type=skip))
    n_eval = len(times)
    assert len(tsteps) == n_eval + bool(dtz)
    np.testing.assert_allclose(tts[:n_eval, 0].numpy(),
                               times.astype(np.float32), rtol=0, atol=1e-4)
    if method == "multistep":
        assert tsteps[:n_eval] == list(range(steps))
    else:   # every evaluation of block i carries i
        orders = TD.singlestep_order_plan(steps, order) \
            if method == "singlestep" else [order] * (steps // order)
        assert tsteps == [i for i, od in enumerate(orders)
                          for _ in range(od)]
    if dtz:
        assert tsteps[-1] == steps


@pytest.mark.parametrize("schedule", ["discrete", "linear", "cosine"])
@pytest.mark.parametrize("method,order,skip", [
    ("multistep", 3, "time_quadratic"), ("singlestep", 3, "logSNR"),
    ("singlestep", 2, "time_uniform"), ("singlestep_fixed", 2, "logSNR")])
def test_eval_times_match_jax(schedule, method, order, skip):
    """The FSC axis of every schedule, host float64: equal to JAX's."""
    kw = {"alphas_cumprod": AC} if schedule == "discrete" else {}
    nsj = JD.NoiseSchedule(schedule, **kw)
    nst = TD.NoiseSchedule(schedule, **kw)
    np.testing.assert_array_equal(
        TD.eval_times(nst, steps=7, order=order, method=method,
                      skip_type=skip, t_end=1e-3),
        JD.eval_times(nsj, steps=7, order=order, method=method,
                      skip_type=skip, t_end=1e-3))


@pytest.mark.parametrize("schedule", ["linear", "cosine"])
def test_continuous_schedules_match_jax(schedule):
    """Continuous-time models take t unscaled (dpm_solver.py:278-287)."""
    def jfn(x, t, step):
        return jnp.tanh(x) * (0.4 + t.reshape(-1, 1, 1, 1)) \
            + 0.03 * jnp.sin(3.0 * x)

    def tfn(x, t, step):
        return torch.tanh(x) * (0.4 + t.reshape(-1, 1, 1, 1)) \
            + 0.03 * torch.sin(3.0 * x)

    nsj, nst = JD.NoiseSchedule(schedule), TD.NoiseSchedule(schedule)
    kw = dict(steps=6, order=2, method="multistep", t_end=1e-3)
    (jx, (jxs, jts)), jsteps, (tx, (txs, tts)), tsteps = _engine_pair(
        kw, _x0(3), nsj, nst, jfn, tfn)
    _close(tx, jx)
    _close(txs, jxs)
    np.testing.assert_array_equal(tts.numpy(), np.asarray(jts))
    assert tsteps == jsteps


def test_thresholding_matches_jax():
    """Imagen thresholding of the x0 predictions (dpm_solver.py:386-399):
    ``jnp.quantile`` against ``torch.quantile``, both linear."""
    nsj, nst = _ns()
    kw = dict(steps=6, order=2, method="multistep", thresholding=True,
              max_val=1.0)
    (jx, _), _, (tx, _), _ = _engine_pair(kw, _x0(4) * 3.0, nsj, nst)
    _close(tx, jx)


# ---------------------------------------------------------------------------
# model_wrapper
# ---------------------------------------------------------------------------

def _wrapped(pkg, ns, model_type, guidance, c, uc):
    """``pkg.model_wrapper`` around the toy model, with a conditioning
    term and a classifier whose log-probability depends on x, t and c."""
    lib = jnp if pkg is JD else torch
    toy = _toy_jax if pkg is JD else _toy_torch

    def apply_fn(x, t, *cond):
        out = toy(x, t, 0)
        return out if not cond else out + 0.05 * cond[0]

    def classifier_fn(x, t, cond):
        return lib.sum(lib.sin(x) * cond, axis=(1, 2, 3)) \
            * (1.0 + t / 1000.0)

    return pkg.model_wrapper(
        apply_fn, ns, model_type=model_type, guidance_type=guidance,
        condition=c, unconditional_condition=uc, guidance_scale=4.0,
        classifier_fn=classifier_fn, classifier_scale=0.5)


@pytest.mark.parametrize("guidance", ["uncond", "classifier-free",
                                      "classifier"])
@pytest.mark.parametrize("model_type", ["noise", "x_start", "v", "score"])
def test_model_wrapper_matches_jax(model_type, guidance):
    """The noise the solver consumes at three times, each parameterization
    converted through the float32 schedule (dpm_solver.py:289-311), CFG as
    one double batch, classifier guidance by the input gradient
    (``torch.autograd.grad`` for ``jax.grad``); then a sample through
    it."""
    nsj, nst = _ns()
    rng = np.random.RandomState(8)
    c = rng.randn(2, 1, 1, 1).astype(np.float32)
    uc = np.zeros_like(c)
    jf = _wrapped(JD, nsj, model_type, guidance, jnp.asarray(c),
                  jnp.asarray(uc))
    tf = _wrapped(TD, nst, model_type, guidance, torch.from_numpy(c),
                  torch.from_numpy(uc))
    x = _x0(9)
    for tv in (999.0, 480.5, 3.0):
        t = np.full((2,), tv, np.float32)
        _close(tf(torch.from_numpy(x), torch.from_numpy(t), 0),
               jf(jnp.asarray(x), jnp.asarray(t), 0))
    kw = dict(steps=5, order=2, method="multistep")
    jx = jax.jit(lambda x: JD.dpm_solver_sample(jf, nsj, x, **kw))(
        jnp.asarray(x))
    _close(TD.dpm_solver_sample(tf, nst, torch.from_numpy(x), **kw), jx)


# ---------------------------------------------------------------------------
# adaptive
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("order,algo", [(2, "dpmsolver++"),
                                        (3, "dpmsolver++"),
                                        (2, "dpmsolver")])
def test_adaptive_matches_jax(order, algo):
    """The data-dependent loop: the same number of evaluations, step 0 at
    each, the sample within ``ADAPTIVE_REL``."""
    nsj, nst = _ns()
    x0 = _x0(0)
    jm, tm = _JaxSteps(), _TorchSteps()
    jx = JD.dpm_solver_sample(jm, nsj, jnp.asarray(x0), order=order,
                              method="adaptive", algorithm_type=algo)
    tx = TD.dpm_solver_sample(tm, nst, torch.from_numpy(x0), order=order,
                              method="adaptive", algorithm_type=algo)
    jsteps = jm.read()
    assert len(tm.steps) == len(jsteps) > 2 * order
    assert set(tm.steps) == set(jsteps) == {0}
    _close(tx, jx, ADAPTIVE_REL)
    with pytest.raises(ValueError):
        TD.dpm_solver_sample(_toy_torch, nst, torch.from_numpy(x0),
                             method="adaptive", order=2, collect="traj")
