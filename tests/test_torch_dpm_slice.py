"""The remaining samplers through the port's pipeline and CLI against the
JAX package's, on the CPU at tiny_ldm (a Lightning checkpoint written by
the JAX export, loaded by both packages) and tiny_ddim. No task samples
``dpm`` or ``ddpm_noisy``: both are reached as the JAX tests reach them,
on ``dataclasses.replace(task, sampler=...)`` (test_dpm_general.py:
416-443), through ``make_schedule`` / ``generate_cali_data`` and, with
``get_task`` patched, through both CLIs.

- ``make_schedule``'s routing (DDPM, the 2M scan, four ``dpm_cfg``s,
  adaptive) and its ``cali_t`` against JAX's, each sampler run on the
  toy model of tests/test_torch_samplers.py.
- ``generate_cali_data``: the DPM harvests (float32 model times) from
  one starting noise; the DDPM one as ``harvest_trajectory``'s; the
  adaptive refusal.
- An FP DPM-Solver sample of tiny_ldm through both CLIs, ``--dpm_*``
  flags given.
- A w4a8 artifact calibrated by JAX on the 2M scan's times (minmax grids,
  random AdaRound alphas, FSC init pass) sampled by the port's CLI in
  fake-quant, each evaluation teacher-forced against JAX's rollout; the
  port's own FSC init pass on its DPM harvest (float times) against
  JAX's; each evaluation's FSC group equal to JAX's for the 2M scan and
  the general engine with singlestep blocks and denoise_to_zero, whose
  step index lies one past the group map and clamps as JAX's gather does.
- The six ``--dpm_*`` flags: parsed into JAX's ``dpm_cfg``, warned about
  and ignored for a task that does not sample with DPM-Solver, ``--cali
  --dpm_method adaptive`` refused by both CLIs, adaptive sampling with
  FSC group 0.

Tolerances: float32 forwards in both packages differ by summation order
(harvests within 1e-5, as test_torch_sd_slice.py's; FP images within
test_torch_uncond_cli.py's ``FP_IMG_ABS``); the quantized sample is held
with test_torch_sd_slice.py's teacher-forced limits and latent limits
(see that module), the FSC state with test_torch_fsc_ema.py's; integer
state, times, steps and groups exactly.
"""

import dataclasses
import logging
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfmq_dm_tpu import cli as jcli
from tfmq_dm_tpu.configs import tasks as jtasks
from tfmq_dm_tpu.models import ldm_unet as JL
from tfmq_dm_tpu.models import ldm_units as JLU
from tfmq_dm_tpu.models import vae as JV
from tfmq_dm_tpu.pipelines import loading as jload
from tfmq_dm_tpu.pipelines import ptq as jptq
from tfmq_dm_tpu.quant import artifact as jart
from tfmq_dm_tpu.quant.context import QuantCtx as JCtx
from tfmq_dm_tpu.quant.fsc import fsc_calibrate as j_fsc
from tfmq_dm_tpu.quant.fsc import slice_fsc as j_slice
from tfmq_dm_tpu.quant.recon import init_weight_qparams as j_iwq
from tfmq_dm_tpu.samplers import ldm as jldm
from tfmq_dm_tpu.utils.torch_convert import export_state_dict as j_export
from tfmq_dm_tpu_torch import cli
from tfmq_dm_tpu_torch.configs import tasks as ttasks
from tfmq_dm_tpu_torch.configs.tasks import task_betas
from tfmq_dm_tpu_torch.models import ldm_unet as TL
from tfmq_dm_tpu_torch.pipelines import loading as tload
from tfmq_dm_tpu_torch.pipelines import ptq as tptq
from tfmq_dm_tpu_torch.quant import inference as tinf
from tfmq_dm_tpu_torch.quant.calibrate import load_cali_model
from tfmq_dm_tpu_torch.quant.fsc import fsc_calibrate as t_fsc
from tfmq_dm_tpu_torch.quant.fsc import step_group
from tfmq_dm_tpu_torch.samplers.ddim import harvest_trajectory
from test_torch_fsc_ema import FSC_DELTA_REL, FSC_ZP_CODES
from test_torch_ldm_modules import random_params
from test_torch_samplers import (_JaxSteps, _TorchSteps, _close,
                                 _jax_noise, _toy_torch)
from test_torch_sd_slice import (QUANT_LATENT_MAX_REL, QUANT_LATENT_MEAN_REL,
                                 _forced_ok, _forced_stats, _within)
from test_torch_uncond_cli import FP_IMG_ABS, _jax_cli_images

N, SEED, STEPS = 2, 11, 4
HARVEST_REL = 1e-5
# the general engine's configurations of the group checks: singlestep
# blocks (every evaluation of block i carries i) and denoise_to_zero (its
# evaluation carries STEPS, one past the map)
GROUP_CFGS = [None, {"method": "singlestep", "order": 2,
                     "denoise_to_zero": True},
              {"order": 3, "denoise_to_zero": True}]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dpm(pkg_tasks, name="tiny_ldm", sampler="dpm"):
    return dataclasses.replace(pkg_tasks.get_task(name), sampler=sampler)


def _x_T():
    """The port CLI's starting noise: the first draw of a generator seeded
    SEED."""
    return torch.randn((N, 8, 8, 3),
                       generator=torch.Generator().manual_seed(SEED)).numpy()


@pytest.fixture(scope="module")
def ldm(tmp_path_factory):
    """A tiny_ldm Lightning checkpoint (UNet and VQ first stage), both
    packages' parameters."""
    tmp = tmp_path_factory.mktemp("dpm_slice")
    jt = jtasks.get_task("tiny_ldm")
    rng = np.random.default_rng(SEED)
    sd = {}
    for prefix, layers in (("model.diffusion_model.", JL.iter_layers(jt.unet)),
                           ("first_stage_model.",
                            JV.iter_layers(jt.vae, encoder=False))):
        layers = list(layers)
        sd.update({prefix + k: torch.from_numpy(np.array(v)) for k, v in
                   j_export(random_params(layers, rng), layers).items()})
    ckpt = str(tmp / "tiny_ldm.ckpt")
    torch.save({"state_dict": sd}, ckpt)
    jp = jload.load_ldm_checkpoint(ckpt, jt)[0]
    tp = tload.load_ldm_checkpoint(ckpt, ttasks.get_task("tiny_ldm"),
                                   device="cpu")[0]
    return dict(tmp=tmp, ckpt=ckpt, jp=jp, tp=tp)


# ---------------------------------------------------------------------------
# make_schedule and generate_cali_data
# ---------------------------------------------------------------------------

ROUTES = [("tiny_ddim", "ddpm_noisy", None), ("tiny_ldm", "dpm", None),
          ("tiny_ldm", "dpm", {"method": "singlestep", "order": 3}),
          ("tiny_ldm", "dpm", {"order": 3}),
          ("tiny_ldm", "dpm", {"solver_type": "taylor"}),
          ("tiny_ldm", "dpm", {"skip_type": "logSNR",
                               "denoise_to_zero": True}),
          ("tiny_ldm", "dpm", {"method": "adaptive"})]


@pytest.mark.parametrize("name,sampler,cfg", ROUTES,
                         ids=[f"{s}-{c}" for _, s, c in ROUTES])
def test_make_schedule_routes_as_jax(name, sampler, cfg):
    """The sampler and the FSC axis (``cali_t``: the DDPM steps' t, the
    2M scan's model times but the last, ``eval_times`` of the general
    engine, None for adaptive) of each route, run on the toy model: the
    sample, its taps and their steps."""
    jt, tt = _dpm(jtasks, name, sampler), _dpm(ttasks, name, sampler)
    jfn, jcali = jptq.make_schedule(jt, steps=6, dpm_cfg=cfg)
    tfn, tcali = tptq.make_schedule(tt, steps=6, dpm_cfg=cfg)
    x0 = np.random.RandomState(1).randn(2, 8, 8, 3).astype(np.float32)
    key = jax.random.PRNGKey(5)
    jm, tm = _JaxSteps(), _TorchSteps()
    if cfg and cfg.get("method") == "adaptive":
        assert jcali is None and tcali is None
        jx = jfn(jm, jnp.asarray(x0), key)
        _close(tfn(tm, torch.from_numpy(x0)), jx, 1e-4)
        assert tm.steps == jm.read()
        return
    np.testing.assert_array_equal(tcali, jcali)
    kw = {"noise": torch.from_numpy(_jax_noise(key, len(tcali), x0.shape))} \
        if sampler == "ddpm_noisy" else {}
    jx, (jxs, jts) = jax.jit(lambda x: jfn(jm, x, key, collect="traj"))(
        jnp.asarray(x0))
    tx, (txs, tts) = tfn(tm, torch.from_numpy(x0), collect="traj", **kw)
    _close(tx, jx)
    _close(txs, jxs)
    np.testing.assert_array_equal(tts.numpy(), np.asarray(jts))
    assert tm.steps == jm.read()
    n = len(tcali)
    np.testing.assert_allclose(tts[:n, 0].numpy(), tcali.astype(np.float32),
                               rtol=0, atol=1e-4)
    # denoise_to_zero's extra tap (dpm.py:568-569): steps + 1 of them
    assert tts.shape[0] == n + bool(cfg and cfg.get("denoise_to_zero"))


def _jax_harvest(task, apply_fn, x_T, **kw):
    """JAX's ``generate_cali_data`` with its starting noise replaced by
    ``x_T`` (drawn without a dtype; the step noise passes one)."""
    real = jax.random.normal

    def normal(key, shape, dtype=None):
        return jnp.asarray(x_T) if dtype is None else real(key, shape, dtype)

    with mock.patch.object(jax.random, "normal", normal):
        return jptq.generate_cali_data(task, apply_fn, jax.random.PRNGKey(0),
                                       n_per_t=N, **kw)


@pytest.fixture(scope="module")
def jax_2m(ldm):
    """JAX's harvest on the 2M scan's times from ``_x_T()``."""
    jt = _dpm(jtasks)
    return _jax_harvest(jt, lambda x, t, c: JL.apply(ldm["jp"], jt.unet, x,
                                                     t), _x_T(), steps=STEPS)


@pytest.mark.parametrize("cfg", [None, {"method": "singlestep",
                                        "order": 2}])
def test_dpm_harvest_matches_jax(ldm, jax_2m, cfg):
    """(xs, ts) of the 2M scan and of singlestep blocks: float32 model
    times, equal; the rows within HARVEST_REL."""
    x_T = _x_T()
    jt, tt = _dpm(jtasks), _dpm(ttasks)
    jw, (jxs, jts), jcali = jax_2m if cfg is None else _jax_harvest(
        jt, lambda x, t, c: JL.apply(ldm["jp"], jt.unet, x, t), x_T,
        steps=STEPS, dpm_cfg=cfg)
    tw, (txs, tts), tcali = tptq.generate_cali_data(
        tt, lambda x, t, c: TL.apply(ldm["tp"], tt.unet, x, t),
        torch.Generator(), n_per_t=N, steps=STEPS, dpm_cfg=cfg,
        noise=torch.from_numpy(x_T), device="cpu")
    np.testing.assert_array_equal(tcali, jcali)
    assert tts.dtype == torch.float32 and tts.shape == (STEPS, N)
    np.testing.assert_array_equal(tts.numpy(), np.asarray(jts))
    np.testing.assert_allclose(txs.numpy(), np.asarray(jxs),
                               rtol=HARVEST_REL, atol=HARVEST_REL)
    for t, j in zip(tw, jw):
        assert tuple(t.shape) == np.asarray(j).shape


def test_ddpm_harvest_is_the_ddpm_trajectory():
    """tiny_ddim's DDPM harvest (make_schedule's route is held against
    JAX above): each step's input and t as ``harvest_trajectory``'s with
    ``sample_type="ddpm_noisy"`` on the same noise, ints."""
    tt = _dpm(ttasks, "tiny_ddim", "ddpm_noisy")
    x_T = torch.from_numpy(np.random.RandomState(4).randn(
        N, 8, 8, 3).astype(np.float32))
    fn, cali_t = tptq.make_schedule(tt)
    noise = torch.from_numpy(_jax_noise(jax.random.PRNGKey(6), len(cali_t),
                                        tuple(x_T.shape)))
    _, (xs, ts), got_t = tptq.generate_cali_data(
        tt, lambda x, t, c: _toy_torch(x, t, 0), torch.Generator(),
        n_per_t=N, noise=x_T, step_noise=noise, device="cpu")
    want = harvest_trajectory(
        _toy_torch, task_betas(tt), cali_t[::-1].copy(), x_T,
        sample_type="ddpm_noisy", noise=noise)
    np.testing.assert_array_equal(got_t, cali_t)
    assert torch.equal(xs, want[0]) and torch.equal(ts, want[1])
    assert ts.dtype == torch.int32
    np.testing.assert_array_equal(ts[:, 0].numpy(), cali_t)


def test_adaptive_harvest_is_refused():
    """Before anything runs (ptq.py:158-160), for any task."""
    def never(*a):
        raise AssertionError("the model ran")

    for task in (_dpm(ttasks), ttasks.get_task("tiny_ldm")):
        with pytest.raises(ValueError, match="adaptive"):
            tptq.generate_cali_data(task, never, torch.Generator(),
                                    n_per_t=N, dpm_cfg={"method": "adaptive"},
                                    device="cpu")


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

def _patched_tasks(sampler="dpm"):
    """Both packages' ``get_task`` answering tiny_ldm with ``sampler``."""
    jreal, treal = jtasks.get_task, ttasks.get_task

    def jget(name):
        t = jreal(name)
        return dataclasses.replace(t, sampler=sampler) \
            if name == "tiny_ldm" else t

    def tget(name):
        t = treal(name)
        return dataclasses.replace(t, sampler=sampler) \
            if name == "tiny_ldm" else t

    return (mock.patch.object(jtasks, "get_task", jget),
            mock.patch.object(cli, "get_task", tget))


def _common(ldm):
    return ["--task", "tiny_ldm", "--ckpt", ldm["ckpt"], "-n", str(N),
            "--batch", str(N), "--seed", str(SEED), "--timesteps",
            str(STEPS)]


def test_fp_dpm_sample_matches_the_jax_cli(ldm):
    """The general engine (singlestep order 2, denoise_to_zero) through
    both CLIs from one noise: images within FP_IMG_ABS."""
    flags = _common(ldm) + ["--dpm_method", "singlestep", "--dpm_order",
                            "2", "--dpm_denoise_to_zero"]
    jpatch, tpatch = _patched_tasks()
    with jpatch:
        ref = _jax_cli_images(flags + ["--out", str(ldm["tmp"] / "jfp")],
                              _x_T())
    with tpatch:
        assert cli.main(flags + ["--device", "cpu", "--out",
                                 str(ldm["tmp"] / "tfp")]) == 0
    got = np.load(ldm["tmp"] / "tfp" / "samples.npy")
    assert got.shape == ref.shape == (N, 16, 16, 3)
    assert np.abs(got - ref).max() <= FP_IMG_ABS


@pytest.fixture(scope="module")
def quant(ldm, jax_2m):
    """JAX's w4a8 artifact on the 2M scan's times (its harvest, minmax
    grids, random AdaRound alphas, the FSC init pass), JAX's fake-quant
    2M sample with every evaluation's (x, t, step, output), and the port
    CLI's sample of that artifact with its model function and groups."""
    jt = _dpm(jtasks)
    x_T = _x_T()
    jp = ldm["jp"]
    _, ja_cali, cali_t = jax_2m
    ja = JLU.build_adapter(jt.unet, w_bits=4, a_bits=8, use_aq=True)
    jw = j_iwq(ja.policy, jp, scaler="minmax")
    rng = np.random.default_rng(SEED + 1)
    for n in jw:
        jw[n]["alpha"] = jnp.asarray(rng.standard_normal(
            jp[n]["w"].shape).astype(np.float32))
    jast = j_fsc(ja, jp, jw, ja_cali, jax.random.PRNGKey(1),
                 running_stat=False, init_samples=N, act_scaler="minmax")
    art = str(ldm["tmp"] / "cali_dpm.npz")
    jart.save_artifact(art, jw, jast, {
        "task": "tiny_ldm", "wq": 4, "aq": 8, "softmax_a_bit": 8,
        "use_aq": True, "cali_t": [float(v) for v in cali_t]})

    # JAX: the 2M sample at the artifact's groups (cli.py:385-432)
    sampler_fn, sample_t = jptq.make_schedule(jt, steps=STEPS)
    gos = jnp.asarray(jldm.group_of_step_from_t(np.asarray(cali_t),
                                                sample_t), jnp.int32)
    evals = []

    def record(*a):
        evals.append(tuple(np.array(v) for v in a))

    def model_fn(x, t, step):
        q = JCtx(ja.policy, wstate=jw, astate=j_slice(jast, gos[step]),
                 use_wq=True, use_aq=True, flash=True)
        e = JL.apply(jp, jt.unet, x, t, qctx=q)
        jax.debug.callback(record, x, t, step, e, ordered=True)
        return e

    jz = np.asarray(jax.jit(lambda x: sampler_fn(model_fn, x,
                                                 jax.random.PRNGKey(0)))(
        jnp.asarray(x_T)))
    jax.effects_barrier()

    # the port's CLI, its model function and its groups spied on
    spied, groups = {}, []
    real_make, real_group = cli.make_model_fn, tinf.step_group

    def make(*a, **kw):
        spied["fn"] = real_make(*a, **kw)
        return spied["fn"]

    def group(step, gmap, n):
        groups.append((step, real_group(step, gmap, n)))
        return groups[-1][1]

    _, tpatch = _patched_tasks()
    out = ldm["tmp"] / "tq"
    with tpatch, mock.patch.object(cli, "make_model_fn", make), \
            mock.patch.object(tinf, "step_group", group):
        rc = cli.main(_common(ldm) + ["--ptq", "--cali_ckpt", art,
                                      "--use_aq", "--device", "cpu",
                                      "--out", str(out)])
    return dict(art=art, ja=ja, jw=jw, jast=jast, ja_cali=ja_cali,
                cali_t=cali_t, evals=evals, jz=jz, rc=rc,
                tz=np.load(out / "latents.npy"), fn=spied["fn"],
                groups=groups, gos=np.asarray(gos), x_T=x_T)


def test_cli_2m_sample_teacher_forced_matches_jax(quant):
    """Each of the 2M scan's STEPS evaluations of JAX's rollout fed at the
    same (x, t, step) to the port CLI's model function: the artifact's
    group, the fake-quant UNet (test_torch_sd_slice.py's limits); the
    latents within its loose limits; the groups the port's rollout took
    equal to JAX's map."""
    assert quant["rc"] == 0
    ev = quant["evals"]
    assert [int(st) for _, _, st, _ in ev] == list(range(STEPS))
    pairs = []
    for x, t, st, ref in ev:
        with torch.no_grad():
            got = quant["fn"](torch.from_numpy(x), torch.from_numpy(t),
                              int(st)).numpy()
        pairs.append((got, ref))
    assert _forced_ok(_forced_stats(pairs)), _forced_stats(pairs)
    _within(quant["tz"], quant["jz"], QUANT_LATENT_MAX_REL,
            QUANT_LATENT_MEAN_REL)
    assert quant["groups"] == [(s, int(quant["gos"][s]))
                               for s in range(STEPS)]
    # negative control: every evaluation at the next step's group
    shifted = []
    for x, t, st, ref in ev:
        with torch.no_grad():
            shifted.append((quant["fn"](torch.from_numpy(x),
                                        torch.from_numpy(t),
                                        (int(st) + 1) % STEPS).numpy(), ref))
    assert not _forced_ok(_forced_stats(shifted))


def test_fsc_init_pass_on_dpm_times_matches_jax(ldm, quant):
    """The port's FSC init pass on its own DPM harvest (float32 model
    times) with JAX's weight state, against JAX's on its harvest: deltas
    within FSC_DELTA_REL, zero points within FSC_ZP_CODES."""
    tt = _dpm(ttasks)
    _, a_cali, _ = tptq.generate_cali_data(
        tt, lambda x, t, c: TL.apply(ldm["tp"], tt.unet, x, t),
        torch.Generator(), n_per_t=N, steps=STEPS,
        noise=torch.from_numpy(quant["x_T"]), device="cpu")
    assert a_cali[1].dtype == torch.float32
    jw = {n: {k: torch.from_numpy(np.array(v)) for k, v in st.items()}
          for n, st in quant["jw"].items()}
    tast = t_fsc(tptq.build_adapter(tt, tptq.QuantArgs(use_aq=True)),
                 ldm["tp"], jw, a_cali, torch.Generator(),
                 running_stat=False, init_samples=N, act_scaler="minmax")
    jast = quant["jast"]
    assert set(tast) == set(jast)
    for site in jast:
        jd, td = np.asarray(jast[site]["delta"]), tast[site]["delta"].numpy()
        assert td.shape == jd.shape == (STEPS,) + jd.shape[1:]
        assert np.all(np.abs(td - jd) <= FSC_DELTA_REL * np.abs(jd)), site
        assert np.all(np.abs(tast[site]["zp"].numpy()
                             - np.asarray(jast[site]["zp"]))
                      <= FSC_ZP_CODES), site


def test_cli_calibrates_on_dpm_times(ldm, quant):
    """``cli.main --ptq --cali`` on a DPM task: the harvest's float32
    times through every calibration unit and FSC, the artifact's
    ``cali_t`` the 2M scan's, one FSC group each."""
    _, tpatch = _patched_tasks()
    art = str(ldm["tmp"] / "port_dpm.npz")
    with tpatch:
        assert cli.main(_common(ldm) + [
            "--ptq", "--cali", "--use_aq", "--cali_iters", "1",
            "--cali_n", str(N), "--no_running_stat", "--cali_save_path",
            art, "--device", "cpu"]) == 0
    _, astate, meta = load_cali_model(art, device="cpu")
    np.testing.assert_array_equal(meta["cali_t"], quant["cali_t"])
    assert all(v.shape[0] == STEPS for st in astate.values()
               for v in st.values())
    assert all(np.all(np.isfinite(v.numpy())) for st in astate.values()
               for v in st.values())


@pytest.mark.parametrize("cfg", GROUP_CFGS, ids=["2m", "singlestep-dtz",
                                                 "multistep-o3-dtz"])
def test_fsc_groups_match_jax(ldm, quant, cfg):
    """Each evaluation's FSC group through the port CLI's model function
    on the artifact of the 2M times against JAX's lookup (the map of
    ``group_of_step_from_t`` indexed by the evaluation's step inside jit,
    which clamps): singlestep's block index and denoise_to_zero's step
    past the map as JAX has them."""
    tt, jt = _dpm(ttasks), _dpm(jtasks)
    jfn, jsample_t = jptq.make_schedule(jt, steps=STEPS, dpm_cfg=cfg)
    jm = _JaxSteps()
    x0 = jnp.asarray(quant["x_T"])
    jax.jit(lambda x: jfn(jm, x, jax.random.PRNGKey(0)))(x0)
    jgos = jnp.asarray(jldm.group_of_step_from_t(
        np.asarray(quant["cali_t"]), jsample_t), jnp.int32)
    lookup = jax.jit(lambda g, s: g[s])
    want = [(s, int(lookup(jgos, s))) for s in jm.read()]

    flags = _common(ldm) + ["--ptq", "--cali_ckpt", quant["art"], "--use_aq",
                            "--out", "-"]
    for k, v in (cfg or {}).items():
        flags += {"method": ["--dpm_method", str(v)],
                  "order": ["--dpm_order", str(v)],
                  "denoise_to_zero": ["--dpm_denoise_to_zero"]}[k]
    args = cli.build_argparser().parse_args(flags)
    sampler_fn, sample_t = tptq.make_schedule(tt, steps=STEPS,
                                              dpm_cfg=cli.dpm_config(args))
    np.testing.assert_array_equal(sample_t, jsample_t)
    fn = cli.build_ldm_model_fn(args, tt, ldm["tp"], None, sample_t, "cpu")
    got, real = [], tinf.step_group

    def group(step, gmap, n):
        got.append((step, real(step, gmap, n)))
        return got[-1][1]

    with mock.patch.object(tinf, "step_group", group):
        sampler_fn(fn, torch.from_numpy(quant["x_T"]))
    assert got == want
    if cfg and cfg.get("denoise_to_zero"):
        assert len(sample_t) == STEPS and got[-1][0] == STEPS
        assert got[-1][1] == int(jgos[-1])


def test_group_of_step_clamps_as_jax(ldm, quant):
    """The repaired fault: a step past the map (or, without one, past the
    groups) takes the last entry, as JAX's gather does, where the port
    raised IndexError; the fake-quant and int8-deployed model functions
    at such a step equal themselves at the last one."""
    lookup = jax.jit(lambda flat, g, s: flat[g[s]])
    flat = jnp.arange(STEPS)
    for gmap in ([0, 1, 3], [2, 2, 0, 1]):
        for s in range(6):
            assert step_group(s, np.asarray(gmap), STEPS) == \
                int(lookup(flat, jnp.asarray(gmap), s))
    for s in range(6):
        assert step_group(s, None, STEPS) == \
            int(jax.jit(lambda f, s: f[s])(flat, s))
    x = torch.from_numpy(quant["x_T"])
    t = torch.full((N,), 500.0)
    for extra in ([], ["--int-kernels"]):
        args = cli.build_argparser().parse_args(
            _common(ldm) + ["--ptq", "--cali_ckpt", quant["art"],
                            "--use_aq", "--out", "-"] + extra)
        fn = cli.build_ldm_model_fn(args, _dpm(ttasks), ldm["tp"], None,
                                    quant["cali_t"][:3], "cpu")
        with torch.no_grad():
            last = fn(x, t, 2)
            assert torch.equal(fn(x, t, 3), last)
            assert torch.equal(fn(x, t, 9), last)
            assert not torch.equal(fn(x, t, 0), last)


FLAG_SETS = [[], ["--dpm_order", "3"],
             ["--dpm_method", "singlestep", "--dpm_skip", "logSNR",
              "--dpm_algorithm", "dpmsolver", "--dpm_solver_type",
              "taylor", "--dpm_denoise_to_zero"]]


class _Stop(Exception):
    pass


@pytest.mark.parametrize("flags", FLAG_SETS, ids=["none", "order",
                                                  "all"])
def test_cli_dpm_flags_parse_as_jax(ldm, flags):
    """The dict each CLI hands ``make_schedule`` from the same flags."""
    seen = {}

    def capture(pkg):
        def fn(task, steps=None, eta=None, dpm_cfg=None):
            seen[pkg] = dpm_cfg
            raise _Stop
        return fn

    argv = _common(ldm) + flags + ["--out", str(ldm["tmp"] / "flags")]
    with mock.patch.object(jptq, "make_schedule", capture("jax")), \
            pytest.raises(_Stop):
        jcli.main(argv)
    with mock.patch.object(tptq, "make_schedule", capture("port")), \
            pytest.raises(_Stop):
        cli.main(argv + ["--device", "cpu"])
    assert seen["port"] == seen["jax"]
    assert (seen["port"] is None) == (not flags)


def test_cli_dpm_flags_ignored_for_a_ddim_task(ldm, caplog):
    """tiny_ldm samples with DDIM: the flags are warned about and the
    sample is the one without them."""
    out = ldm["tmp"]
    with caplog.at_level(logging.WARNING):
        assert cli.main(_common(ldm) + ["--dpm_order", "3", "--device",
                                        "cpu", "--out", str(out / "w")]) == 0
    assert any("--dpm_* flags are ignored" in r.getMessage()
               for r in caplog.records)
    assert cli.main(_common(ldm) + ["--device", "cpu", "--out",
                                    str(out / "nw")]) == 0
    np.testing.assert_array_equal(np.load(out / "w" / "samples.npy"),
                                  np.load(out / "nw" / "samples.npy"))


def test_cli_cali_adaptive_is_refused(ldm):
    """``--cali --dpm_method adaptive`` raises ValueError in both CLIs,
    whatever the task's sampler."""
    argv = _common(ldm) + ["--ptq", "--cali", "--use_aq", "--dpm_method",
                           "adaptive", "--cali_save_path",
                           str(ldm["tmp"] / "never.npz")]
    with pytest.raises(ValueError, match="adaptive"):
        jcli.main(argv)
    with pytest.raises(ValueError, match="adaptive"):
        cli.main(argv + ["--device", "cpu"])


def test_cli_adaptive_sample_uses_group_0(ldm, quant, caplog):
    """Adaptive DPM-Solver has no static times: the CLI warns, passes no
    group map, and every evaluation (step 0) takes group 0."""
    _, tpatch = _patched_tasks()
    got, real = [], tinf.step_group

    def group(step, gmap, n):
        got.append((step, gmap, real(step, gmap, n)))
        return got[-1][2]

    with tpatch, mock.patch.object(tinf, "step_group", group), \
            caplog.at_level(logging.WARNING):
        assert cli.main(_common(ldm) + [
            "--ptq", "--cali_ckpt", quant["art"], "--use_aq",
            "--dpm_method", "adaptive", "--dpm_order", "3", "--device",
            "cpu", "--out", str(ldm["tmp"] / "adaptive")]) == 0
    assert any("no static step times" in r.getMessage()
               for r in caplog.records)
    assert len(got) > 3 and all(g == (0, None, 0) for g in got)
    lat = np.load(ldm["tmp"] / "adaptive" / "latents.npy")
    assert lat.shape == (N, 8, 8, 3) and np.all(np.isfinite(lat))
