"""The port's calibrate-then-exit CLI on the text-conditioned family
against the JAX CLI's, on the CPU, at ``tiny_sd``: ``cli.main --task
tiny_sd --ptq --cali --use_aq --from-file`` on both packages from one
Lightning checkpoint (tests/test_torch_sd_slice.py's) and one harvest (the
port's PLMS harvest with classifier-free guidance at 7.5 and the CLIP
text contexts, handed to both CLIs), the port drawing its minibatches and
FSC subsets from the JAX CLI's keys (as tests/test_torch_ldm_cali_cli.py
does for tiny_cin).

Tolerances. The CLIs' text contexts: 1e-5 (float32 forwards). The
artifacts: the same keys and meta, equal zero points, and equal
hard-rounded codes of every trained weight in every output channel whose
weight grid is the same on both sides. The mse weight scaler picks each
channel's grid from 80 candidates by an f32 loss that XLA, compiling the
JAX CLI's loop, computes with an FMA and a reciprocal (ROADMAP.md section
3, settled findings): two near-equal candidates can then be picked
differently. That happened in 1 of 6304 channels here (its delta 1% apart,
one candidate step; every other delta within 2e-7); at most 0.1% of the
channels may do so.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfmq_dm_tpu import cli as jcli
from tfmq_dm_tpu.configs import tasks as jtasks
from tfmq_dm_tpu.models import ldm_units as JLU
from tfmq_dm_tpu.pipelines import ptq as jptq
from tfmq_dm_tpu.quant.calibrate import load_cali_model as j_load
from tfmq_dm_tpu_torch import cli
from tfmq_dm_tpu_torch.configs import tasks as ttasks
from tfmq_dm_tpu_torch.models import ldm_unet as TL
from tfmq_dm_tpu_torch.pipelines import ptq as tptq
from tfmq_dm_tpu_torch.quant import calibrate as tcal
from tfmq_dm_tpu_torch.quant.calibrate import load_cali_model as t_load

from test_torch_fsc_ema import jax_fsc_indices
from test_torch_ldm_cali_cli import _codes, _jax_cli_keys, _same_harvest
from test_torch_ldm_recon import jax_rows
from test_torch_sd_slice import CTX_REL, SCALE, SEED, _args
from test_torch_sd_slice import setup  # noqa: F401 - the shared fixture

# harvest steps (of the task's 4), samples a step (x 2 for CFG: one batch
# of the FSC running-stat pass) and iterations a unit
CALI_STEPS, CALI_N, ITERS = 2, 8, 12
# channels whose mse weight grid may differ (a near tie, see above)
OTHER_GRID_SHARE, SAME_GRID_REL = 1e-3, 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Long loops of small CPU ops run on one intra-op thread (see
    test_torch_ldm_cali_cli.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cali_runs(setup):
    """``--ptq --cali`` on both CLIs from one harvest (the port's, of
    CALI_STEPS PLMS steps x CALI_N prompts x CFG), the port drawing its
    minibatches and FSC subsets from the JAX CLI's keys."""
    s = setup
    ttask = ttasks.get_task("tiny_sd")
    ctx, uc = cli.text_context(_args(from_file=s["prompts"]), ttask,
                               s["tc"], CALI_N, "cpu")
    harvest = tptq.generate_cali_data(
        ttask, lambda x, t, c: TL.apply(s["tp"], ttask.unet, x, t,
                                        context=c),
        torch.Generator().manual_seed(3), n_per_t=CALI_N, context=ctx,
        uncond=uc, steps=CALI_STEPS, device="cpu")
    flags = ["--task", "tiny_sd", "--ptq", "--cali", "--wq", "4", "--aq",
             "8", "--use_aq", "--cali_iters", str(ITERS), "--cali_n",
             str(CALI_N), "--seed", str(SEED), "--ckpt", s["ckpt"],
             "--from-file", s["prompts"]]
    port, ref = str(s["tmp"] / "port.npz"), str(s["tmp"] / "jax.npz")
    jcalls, tcalls = [], []
    with mock.patch.object(jptq, "generate_cali_data", _same_harvest(
            harvest, lambda x: jnp.asarray(x.numpy()), jcalls)):
        assert jcli.main(flags + ["--cali_save_path", ref, "--out",
                                  str(s["tmp"] / "jax")]) == 0
    k_recon, k_fsc = _jax_cli_keys(SEED)
    ja = JLU.build_adapter(jtasks.get_task("tiny_sd").unet, use_aq=True)
    rows, k = {}, k_recon
    for u in ja.units:
        if u.recon and ja.default_train_roles(u):
            k, uk = jax.random.split(k)
            rows[u.name] = jax_rows(uk)
    real_recon, real_fsc = tcal.reconstruct, tcal.fsc_calibrate
    a_cali = harvest[1]

    def recon(*a, **kw):
        kw["indices"] = lambda u, n, bs, it: rows[u](u, n, bs, it)
        return real_recon(*a, **kw)

    def fsc(*a, **kw):
        return real_fsc(*a, **kw, indices=jax_fsc_indices(
            k_fsc, a_cali[0].shape[0], a_cali[0].shape[1], 16))

    with mock.patch.object(tptq, "generate_cali_data", _same_harvest(
            harvest, lambda x: x, tcalls)), \
            mock.patch.object(tcal, "reconstruct", recon), \
            mock.patch.object(tcal, "fsc_calibrate", fsc):
        assert cli.main(flags + ["--cali_save_path", port, "--device",
                                 "cpu"]) == 0
    return dict(port=port, ref=ref, jcalls=jcalls, tcalls=tcalls)


def test_cli_cali_harvests_with_the_jax_clis_text_context(cali_runs):
    (jkw,), (tkw,) = cali_runs["jcalls"], cali_runs["tcalls"]
    assert jkw["n_per_t"] == tkw["n_per_t"] == CALI_N
    for f in ("context", "uncond"):
        j, t = np.asarray(jkw[f]), tkw[f].numpy()
        assert t.shape == j.shape == (CALI_N, 16, 32)
        assert np.abs(t - j).max() <= CTX_REL * np.abs(j).max()
    assert jkw["cfg_scale"] == SCALE and tkw["cfg_scale"] is None


def test_cli_cali_artifact_matches_the_jax_clis(setup, cali_runs):
    """Keys, meta, zero points, and every trained weight's hard-rounded
    codes equal to the JAX CLI's; the running-stat FSC pass ran."""
    tw, tast, tmeta = t_load(cali_runs["port"], device="cpu")
    jw, jast, jmeta = j_load(cali_runs["ref"])
    with np.load(cali_runs["port"]) as p, np.load(cali_runs["ref"]) as r:
        assert sorted(p.files) == sorted(r.files)
    assert set(tmeta) - set(jmeta) == {"recon", "fsc"}
    assert all(tmeta[k] == jmeta[k] for k in jmeta)
    assert jmeta["task"] == "tiny_sd"
    assert len(tmeta["recon"]["units"]) == 22
    assert tmeta["fsc"] == {"groups": CALI_STEPS, "rows": 2 * CALI_N,
                            "ema_batches": 1}
    params = setup["tp"]
    n_alpha = n_channels = other_grid = 0
    for name, jst in jw.items():
        assert set(tw[name]) == set(jst), name
        np.testing.assert_array_equal(tw[name]["zp"].numpy(),
                                      np.asarray(jst["zp"]), err_msg=name)
        jd, td = np.asarray(jst["delta"]), tw[name]["delta"].numpy()
        same = np.abs(td - jd) <= SAME_GRID_REL * jd
        n_channels += same.size
        other_grid += int((~same).sum())
        if "alpha" not in jst:
            continue
        n_alpha += 1
        w = params[name]["w"].numpy()
        j = _codes(w, {k: np.asarray(v) for k, v in jst.items()})
        t = _codes(w, {k: v.numpy() for k, v in tw[name].items()})
        np.testing.assert_array_equal(t[..., same], j[..., same],
                                      err_msg=name)
    assert n_alpha == 66
    assert other_grid <= OTHER_GRID_SHARE * n_channels
    assert sorted(tast) == sorted(jast)
