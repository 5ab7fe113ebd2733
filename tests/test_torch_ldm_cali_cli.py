"""The port's calibrate-then-exit CLI on the class-conditional LDM family
against the JAX CLI's, on the CPU, at ``tiny_cin``; the quality gate's
twin on ``tiny_cin``, ``tiny_sd`` and ``tiny_bert``; the JAX script's
exported noise draws.

- ``cli.main --task tiny_cin --ptq --cali --use_aq`` on both packages,
  from one Lightning checkpoint and one harvest (the port's CFG harvest
  from its FP model, handed to both CLIs), the port drawing its
  minibatches, FSC subsets and EMA orders from the JAX CLI's keys
  (cli.py:268-301, calibrate.py:69-84, replayed and passed in as index
  sources): every weight's hard-rounded codes equal, the FSC grids within
  the limits of test_torch_fsc_ema.py (the unit-level agreement is
  tests/test_torch_ldm_recon.py's), the JAX CLI's meta plus the port's
  reconstruction and FSC records; the port then samples from its
  artifact with the int4-serving deployment.
- The twin of scripts/quality_gate.py end to end on tiny_cin (class
  table), tiny_sd (CLIP tower, PLMS) and tiny_bert (BERT tower, DDIM), and
  on tiny_cin with ``--noise-npz``.
- ``tfmq_dm_tpu_torch/scripts/jax_noise_cifar10.npz`` holds the noise
  that scripts/quality_gate.py draws for the cifar10 row at its default
  key (the harvest's starting noise, quality_gate.py:178 through
  ptq.py:175-176, and the rollout's, :232-233); recomputed here with
  JAX, equal.
"""

import json
from pathlib import Path
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
from tfmq_dm_tpu.pipelines import ptq as jptq
from tfmq_dm_tpu.quant.calibrate import load_cali_model as j_load
from tfmq_dm_tpu.utils.torch_convert import export_state_dict as j_export
from tfmq_dm_tpu_torch import cli
from tfmq_dm_tpu_torch.configs import tasks as ttasks
from tfmq_dm_tpu_torch.models import ldm_unet as TL
from tfmq_dm_tpu_torch.pipelines import loading as tload
from tfmq_dm_tpu_torch.pipelines import ptq as tptq
from tfmq_dm_tpu_torch.quant import calibrate as tcal
from tfmq_dm_tpu_torch.quant.calibrate import load_cali_model as t_load
from test_torch_fsc_ema import (FSC_DELTA_MEDIAN_REL, FSC_DELTA_REL,
                                FSC_ZP_CODES, jax_fsc_indices)
from test_torch_ldm_modules import random_params
from test_torch_ldm_recon import jax_rows

ITERS, SEED, CALI_N = 24, 5, 8
NOISE_NPZ = Path(__file__).resolve().parent.parent / "tfmq_dm_tpu_torch" \
    / "scripts" / "jax_noise_cifar10.npz"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Long loops of small CPU ops run on one intra-op thread: the test
    workers share the CPU, and idle threads spinning at every op's
    barrier cost more than the threads gain."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """A tiny_cin Lightning checkpoint and the port's CFG harvest of it
    (the task's 4 steps x CALI_N samples: 16 rows a group, one batch of
    the FSC running-stat pass)."""
    tmp = tmp_path_factory.mktemp("ldm_cali")
    jtask, ttask = jtasks.get_task("tiny_cin"), ttasks.get_task("tiny_cin")
    rng = np.random.default_rng(21)
    up = random_params(JL.iter_layers(jtask.unet), rng)
    vp = random_params(JV.iter_layers(jtask.vae, encoder=False), rng)
    sd = {f"model.diffusion_model.{k}": torch.from_numpy(np.array(v))
          for k, v in j_export(up, JL.iter_layers(jtask.unet)).items()}
    sd.update({f"first_stage_model.{k}": torch.from_numpy(np.array(v))
               for k, v in j_export(
                   vp, JV.iter_layers(jtask.vae, encoder=False)).items()})
    sd["cond_stage_model.embedding.weight"] = torch.from_numpy(
        rng.standard_normal((11, 16)).astype(np.float32))
    ckpt = str(tmp / "tiny_cin.ckpt")
    torch.save({"state_dict": sd}, ckpt)
    tp, _, cond = tload.load_ldm_checkpoint(ckpt, ttask, device="cpu")
    ctx, uc = cli.class_context(cond, None, CALI_N, "cpu")
    harvest = tptq.generate_cali_data(
        ttask, lambda x, t, c: TL.apply(tp, ttask.unet, x, t, context=c),
        torch.Generator().manual_seed(3), n_per_t=CALI_N,
        context=ctx, uncond=uc, device="cpu")
    return dict(tmp=tmp, ckpt=ckpt, harvest=harvest, ctx=ctx, uc=uc)


def _same_harvest(harvest, to, calls):
    """generate_cali_data for a CLI: records the CLI's arguments and hands
    back the fixture's harvest in the CLI's array type."""
    def fn(task, fp_apply, key, **kw):
        calls.append(kw)
        w_cali, a_cali, cali_t = harvest
        return (tuple(to(x) for x in w_cali), tuple(to(x) for x in a_cali),
                cali_t)
    return fn


def _jax_cli_keys(seed):
    """The keys the JAX CLI's calibration draws from ``--seed``: a split
    for the harvest, one for quantize_task (cli.py:268-301), which
    cali_model splits into the reconstruction's and FSC's
    (calibrate.py:69); reconstruct splits one a unit (recon.py:1010)."""
    key = jax.random.PRNGKey(seed)
    key, _ = jax.random.split(key)
    key, k = jax.random.split(key)
    _, k_recon, k_fsc = jax.random.split(k, 3)
    return k_recon, k_fsc


FLAGS = ["--task", "tiny_cin", "--ptq", "--cali", "--wq", "4", "--aq", "8",
         "--use_aq", "--cali_iters", str(ITERS), "--cali_n", str(CALI_N),
         "--seed", str(SEED)]


@pytest.fixture(scope="module")
def cli_runs(setup):
    s = setup
    port, ref = str(s["tmp"] / "port.npz"), str(s["tmp"] / "jax.npz")
    jcalls, tcalls = [], []
    with mock.patch.object(jptq, "generate_cali_data", _same_harvest(
            s["harvest"], lambda x: jnp.asarray(x.numpy()), jcalls)):
        assert jcli.main(FLAGS + ["--ckpt", s["ckpt"], "--cali_save_path",
                                  ref, "--out", str(s["tmp"] / "jax")]) == 0

    k_recon, k_fsc = _jax_cli_keys(SEED)
    ja = JLU.build_adapter(jtasks.get_task("tiny_cin").unet, use_aq=True)
    unit_keys, k = {}, k_recon
    for u in ja.units:
        if u.recon and ja.default_train_roles(u):
            k, unit_keys[u.name] = jax.random.split(k)
    rows = {u: jax_rows(uk) for u, uk in unit_keys.items()}
    real_recon, real_fsc = tcal.reconstruct, tcal.fsc_calibrate
    a_cali = s["harvest"][1]
    stats = {}

    def recon(*a, **kw):
        kw["indices"] = lambda u, n, bs, it: rows[u](u, n, bs, it)
        stats.clear()
        out = real_recon(*a, **kw)
        stats.update(kw["stats"])
        return out

    def fsc(*a, **kw):
        return real_fsc(*a, **kw, indices=jax_fsc_indices(
            k_fsc, a_cali[0].shape[0], a_cali[0].shape[1], 16))

    resume = s["tmp"] / "resume"
    rerun = str(s["tmp"] / "rerun.npz")
    with mock.patch.object(tptq, "generate_cali_data", _same_harvest(
            s["harvest"], lambda x: x, tcalls)), \
            mock.patch.object(tcal, "reconstruct", recon), \
            mock.patch.object(tcal, "fsc_calibrate", fsc):
        for path in (port, rerun):
            assert cli.main(FLAGS + ["--ckpt", s["ckpt"], "--cali_save_path",
                                     path, "--resume_dir", str(resume),
                                     "--device", "cpu"]) == 0
            if path == port:
                # an interrupted run: the last three units' checkpoints
                # are gone, the re-run reconstructs them again
                done = sorted(resume.glob("*.npz"),
                              key=lambda f: f.stat().st_mtime)
                for f in done[-3:]:
                    f.unlink()
                rows = {u: jax_rows(k) for u, k in unit_keys.items()}
    return dict(port=port, ref=ref, rerun=rerun, jcalls=jcalls,
                tcalls=tcalls, stats=stats)


def test_cli_harvests_with_the_jax_clis_conditioning(setup, cli_runs):
    """Both CLIs ask for the same harvest: --cali_n rows a step, the
    class context and the unconditional row of the checkpoint's table,
    CFG at the task's scale (the port passes None: the task's)."""
    (jkw,), (tkw, _) = cli_runs["jcalls"], cli_runs["tcalls"]
    assert jkw["n_per_t"] == tkw["n_per_t"] == CALI_N
    np.testing.assert_array_equal(np.asarray(jkw["context"]),
                                  tkw["context"].numpy())
    np.testing.assert_array_equal(np.asarray(jkw["uncond"]),
                                  tkw["uncond"].numpy())
    np.testing.assert_array_equal(tkw["context"].numpy(),
                                  setup["ctx"].numpy())
    assert jkw["cfg_scale"] == 3.0 and tkw["cfg_scale"] is None


def _codes(w, st):
    """Hard-rounded integer codes of a weight: floor(w / delta) + (alpha
    >= 0) + zp, clipped to 4 bits (the grid ``adaround_fq`` rounds to)."""
    d = st["delta"].reshape((1,) * (w.ndim - 1) + (-1,))
    z = st["zp"].reshape(d.shape)
    return np.clip(np.floor(w / d) + (st["alpha"] >= 0) + z, 0, 15)


def test_cli_artifact_matches_the_jax_clis(setup, cli_runs):
    tw, tast, tmeta = t_load(cli_runs["port"], device="cpu")
    jw, jast, jmeta = j_load(cli_runs["ref"])
    with np.load(cli_runs["port"]) as p, np.load(cli_runs["ref"]) as r:
        assert sorted(p.files) == sorted(r.files)
    assert set(tmeta) - set(jmeta) == {"recon", "fsc"}
    assert all(tmeta[k] == jmeta[k] for k in jmeta)
    units = tmeta["recon"]["units"]
    assert len(units) == 22 and units == cli_runs["stats"]
    res = tmeta["recon"]["residency"]
    assert res["fp_out_cache"] == "shared" and res["host"] == []
    assert tmeta["fsc"] == {"groups": 4, "rows": 16, "ema_batches": 1}
    params = tload.load_ldm_checkpoint(setup["ckpt"],
                                       ttasks.get_task("tiny_cin"),
                                       device="cpu")[0]
    n_alpha = 0
    for name, jst in jw.items():
        assert set(tw[name]) == set(jst), name
        np.testing.assert_array_equal(tw[name]["zp"].numpy(),
                                      np.asarray(jst["zp"]), err_msg=name)
        if "alpha" not in jst:
            continue
        n_alpha += 1
        w = params[name]["w"].numpy()
        j = _codes(w, {k: np.asarray(v) for k, v in jst.items()})
        t = _codes(w, {k: v.numpy() for k, v in tw[name].items()})
        np.testing.assert_array_equal(t, j, err_msg=name)
    assert n_alpha == 66
    rel, zp = [], []
    assert sorted(tast) == sorted(jast)
    for site in jast:
        jd, td = np.asarray(jast[site]["delta"]), tast[site]["delta"].numpy()
        assert td.shape == jd.shape
        rel.append(np.abs(td - jd).ravel() / jd.ravel())
        zp.append(np.abs(tast[site]["zp"].numpy()
                         - np.asarray(jast[site]["zp"])).ravel())
    rel, zp = np.concatenate(rel), np.concatenate(zp)
    assert rel.max() <= FSC_DELTA_REL
    assert np.median(rel) <= FSC_DELTA_MEDIAN_REL
    assert zp.max() <= FSC_ZP_CODES


def test_cli_resumes_an_interrupted_ldm_calibration(cli_runs):
    """``--resume_dir`` on an LDM task: a re-run after the last three
    units' checkpoints were lost writes the same alphas, grids and
    per-unit records, and reconstructs only those three units."""
    with np.load(cli_runs["port"]) as p, np.load(cli_runs["rerun"]) as r:
        assert sorted(p.files) == sorted(r.files)
        for k in p.files:
            if k != "__meta__":
                np.testing.assert_array_equal(p[k], r[k], err_msg=k)
    first = t_load(cli_runs["port"], device="cpu")[2]
    again = t_load(cli_runs["rerun"], device="cpu")[2]
    assert again["recon"]["units"] == first["recon"]["units"]
    assert again["fsc"] == first["fsc"]
    # the re-run's FP-output cache holds the three pending units only
    assert 0 < again["recon"]["residency"]["fp_out_gib"] < \
        first["recon"]["residency"]["fp_out_gib"]


def test_cli_samples_from_its_ldm_artifact(setup, cli_runs, tmp_path):
    out = tmp_path / "samples"
    assert cli.main(["--task", "tiny_cin", "--ckpt", setup["ckpt"],
                     "--ptq", "--cali_ckpt", cli_runs["port"], "--use_aq",
                     "--int-kernels", "--int4-serving", "--classes", "1,2",
                     "-n", "2", "--batch", "2", "--device", "cpu", "--out",
                     str(out)]) == 0
    img, lat = np.load(out / "samples.npy"), np.load(out / "latents.npy")
    assert img.shape == (2, 16, 16, 3) and lat.shape == (2, 8, 8, 3)
    assert np.all(np.isfinite(img)) and np.all(np.isfinite(lat))
    assert img.min() >= 0 and img.max() <= 1


@pytest.mark.parametrize("task", ["tiny_cin", "tiny_sd", "tiny_bert"])
def test_quality_gate_twin_runs(tmp_path, task):
    """The twin on the LDM family: seeded random-init weights, a random
    class table (tiny_cin) or a random-init text tower (tiny_sd: CLIP,
    PLMS; tiny_bert: BERT, DDIM), CFG harvest and rollouts; every unit
    in the guard's record and finite numbers; no kernel launches on the
    CPU."""
    from tfmq_dm_tpu_torch.scripts import quality_gate
    out = tmp_path / "gate.json"
    assert quality_gate.main([task, "--iters", "2", "--n-cali", "4",
                              "--batch", "2", "--device", "cpu", "--json",
                              str(out)]) == 0
    r = json.loads(out.read_text())
    assert r["task"] == task
    for k in ("unet_sqnr_db_mean", "unet_sqnr_db_min", "sample_psnr_db",
              "traj_sqnr_db", "calibration_s"):
        assert np.isfinite(r[k]), k
    assert set(r["calibration_split_s"]) == {"harvest", "reconstruction",
                                             "fsc"}
    assert r["recon_guard"]["units"] == 22
    assert r["weights"].startswith("random-init")
    assert set(r["kernel_launches"]) >= {"int4_linear", "int4_conv2d",
                                         "flash_int8"}
    assert not any(r["kernel_launches"].values())
    with pytest.raises(SystemExit):
        quality_gate.main([task, "--ckpt", "x.npz", "--device", "cpu"])


def test_quality_gate_twin_takes_noise_npz(tmp_path):
    """``--noise-npz`` replaces the harvest's and the rollouts' draws
    (rows checked against --n-cali and --batch)."""
    from tfmq_dm_tpu_torch.scripts import quality_gate
    rng = np.random.default_rng(0)
    npz = tmp_path / "noise.npz"
    np.savez(npz, harvest=rng.standard_normal((4, 8, 8, 3)).astype(
        np.float32), rollout=rng.standard_normal((2, 8, 8, 3)).astype(
        np.float32))
    flags = ["tiny_cin", "--iters", "2", "--n-cali", "4", "--device",
             "cpu", "--noise-npz", str(npz)]
    out = tmp_path / "gate.json"
    assert quality_gate.main(flags + ["--batch", "2", "--json",
                                      str(out)]) == 0
    r = json.loads(out.read_text())
    assert r["noise"] == str(npz) and np.isfinite(r["sample_psnr_db"])
    with pytest.raises(SystemExit):
        quality_gate.main(flags + ["--batch", "3"])


def test_jax_noise_npz_matches_jax():
    """The exported noise is what scripts/quality_gate.py draws for the
    cifar10 row (64 calibration samples a step, 16 images) at its
    default key, recomputed here on JAX's CPU: equal."""
    key = jax.random.PRNGKey(0)
    key, _, k_harvest, _ = jax.random.split(key, 4)
    _, k1, _ = jax.random.split(k_harvest, 3)
    harvest = np.asarray(jax.random.normal(k1, (64, 32, 32, 3)))
    _, kx, _ = jax.random.split(key, 3)
    rollout = np.asarray(jax.random.normal(kx, (16, 32, 32, 3)))
    with np.load(NOISE_NPZ) as z:
        assert sorted(z.files) == ["harvest", "rollout"]
        assert z["harvest"].dtype == z["rollout"].dtype == np.float32
        np.testing.assert_array_equal(z["harvest"], harvest)
        np.testing.assert_array_equal(z["rollout"], rollout)
