"""The port's reconstruction over every unit of the tiny DDIM model and its
calibrate-then-exit CLI, against the JAX package's, on the CPU.

- ``reconstruct`` runs on both sides from the same numpy parameters,
  inputs and weight grids, the port on JAX's per-unit keys
  (recon.py:1010): every unit's guard decision identical, loss traces
  within 1e-4 relative, hardened alphas equal on >= 99.9% of elements
  (the limits of test_torch_recon.py, which holds the pieces).
- With ``resume_dir`` a re-run after an interruption reloads the finished
  units and ends with the same alphas.
- ``--ptq --cali`` on ``tiny_ddim`` writes an artifact that both packages
  load, with the keys (and the meta) of the artifact the JAX CLI writes
  at the same flags, plus the port's reconstruction record; the port then
  samples from it with the int4-serving deployment; ``--cali`` on an LDM
  task without a checkpoint exits non-zero (the LDM family's calibration
  is test_torch_ldm_cali_cli.py's).

The reconstruction comparison runs at the CLI's shapes and settings (20
samples, minibatches of 4, 32 iterations, captures in one batch), so that
the JAX CLI reuses the programs JAX compiled for it.
"""

import json
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfmq_dm_tpu import cli as jcli
from tfmq_dm_tpu.models import ddim_unet as J
from tfmq_dm_tpu.models import ddim_units as JU
from tfmq_dm_tpu.pipelines.training import save_params
from tfmq_dm_tpu.quant import recon as JR
from tfmq_dm_tpu.quant.calibrate import load_cali_model as j_load
from tfmq_dm_tpu.utils.torch_convert import export_state_dict
from tfmq_dm_tpu_torch import cli
from tfmq_dm_tpu_torch.convert import params_from_numpy
from tfmq_dm_tpu_torch.models import ddim_unet as T
from tfmq_dm_tpu_torch.models import ddim_units as TU
from tfmq_dm_tpu_torch.quant import recon as TR
from tfmq_dm_tpu_torch.quant.calibrate import load_cali_model as t_load
from test_torch_ddim_slice import random_params
from test_torch_recon import (HARD_EQUAL, LOSS_REL, _hard_equal_share,
                              jax_indices, to_torch)

CFG = J.tiny_config()
N, ITERS, BATCH, CAPTURE = 20, 32, 4, 64


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
    tmp = tmp_path_factory.mktemp("cali")
    rng = np.random.default_rng(4)
    np_p = random_params(CFG, rng)
    npz = str(tmp / "tiny.npz")
    save_params(npz, np_p)
    pth = str(tmp / "tiny.pth")
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in
                export_state_dict(np_p, J.iter_layers(CFG)).items()}, pth)
    jp = jax.tree.map(jnp.asarray, np_p)
    x = rng.standard_normal((N, 16, 16, 3)).astype(np.float32)
    t = rng.integers(0, 100, N).astype(np.int32)
    ja = JU.build_adapter(CFG, w_bits=4, a_bits=8)
    jw = JR.init_weight_qparams(ja.policy, jp, scaler="minmax")
    return dict(tmp=tmp, npz=npz, pth=pth, jp=jp,
                tp=params_from_numpy(np_p, "cpu"), ja=ja,
                ta=TU.build_adapter(T.tiny_config(), w_bits=4, a_bits=8),
                jw=jw, tw=to_torch(jw),
                jcali=(jnp.asarray(x), jnp.asarray(t)),
                tcali=(torch.from_numpy(x), torch.from_numpy(t)))


@pytest.fixture(scope="module")
def full_runs(setup):
    """``reconstruct`` over every unit, both packages."""
    s = setup
    key = jax.random.PRNGKey(7)
    keys, k = {}, key
    for u in s["ja"].units:
        if u.recon and s["ja"].default_train_roles(u):
            k, keys[u.name] = jax.random.split(k)
    # the port's capture is always JAX's asym one
    hp = dict(iters=ITERS, batch_size=BATCH, w=0.01, warmup=0.2)
    jst, tst, jl, tl = {}, {}, {}, {}
    jw2 = JR.reconstruct(s["ja"], s["jp"], s["jcali"], dict(s["jw"]),
                         JR.ReconHP(**hp, asym=True), key,
                         capture_batch_size=CAPTURE,
                         stats=jst, log=lambda u, l: jl.__setitem__(u, l))
    tw2 = TR.reconstruct(
        s["ta"], s["tp"], s["tcali"], dict(s["tw"]), TR.ReconHP(**hp),
        capture_batch_size=CAPTURE, stats=tst,
        log=lambda u, l: tl.__setitem__(u, l),
        indices=lambda u, n, bs, it: jax_indices(keys[u], n, bs, it))
    return dict(jw=jw2, tw=tw2, jst=jst, tst=tst, jl=jl, tl=tl, keys=keys)


def test_reconstruct_matches_jax_over_all_units(setup, full_runs):
    r = full_runs
    assert set(r["tst"]) == set(r["jst"]) == set(r["keys"])
    assert len(r["tst"]) == 14
    for u in r["jst"]:
        assert r["tst"][u]["kept"] == r["jst"][u]["kept"], u
        jl, tl = np.asarray(r["jl"][u]), r["tl"][u].numpy()
        assert tl.shape == jl.shape == (ITERS,)
        assert np.all(np.abs(tl - jl) <= LOSS_REL * np.abs(jl)), u
    assert _hard_equal_share(r["jw"], r["tw"], list(r["jw"])) >= HARD_EQUAL
    # every layer that trains in some unit carries an alpha
    ta = setup["ta"]
    trained = {full for u in ta.units for role, full in u.layers
               if role in ta.default_train_roles(u)}
    assert trained and all("alpha" in r["tw"][n] for n in trained)


def test_reconstruct_resumes_finished_units(setup, tmp_path):
    """With ``resume_dir``, a re-run after an interruption (the last
    units' checkpoints gone) loads the finished units, reconstructs the
    rest, and ends with the same alphas and the same per-unit records
    (losses, guard) as the uninterrupted run."""
    s = setup
    hp = TR.ReconHP(iters=8, batch_size=BATCH)

    def run(log, stats):
        return TR.reconstruct(s["ta"], s["tp"], s["tcali"], dict(s["tw"]),
                              hp, torch.Generator().manual_seed(3),
                              capture_batch_size=CAPTURE,
                              resume_dir=str(tmp_path), stats=stats,
                              log=lambda u, l: log.append((u, l is None)))
    first, second, st1, st2 = [], [], {}, {}
    w1 = run(first, st1)
    assert first and not any(resumed for _, resumed in first)
    names = [u for u, _ in first]
    for u in names[-3:]:
        (tmp_path / f"{u}.npz").unlink()
    w2 = run(second, st2)
    assert second == [(u, u not in names[-3:]) for u in names]
    assert st2 == st1 and len(st1) == len(names)
    assert all({"kept", "hard_nearest", "loss_first", "loss_last"} <= set(r)
               for r in st1.values())
    for full, st in w1.items():
        if "alpha" in st:
            assert torch.equal(st["alpha"], w2[full]["alpha"]), full


# ---------------------------------------------------------------------------
# the calibrate-then-exit CLI
# ---------------------------------------------------------------------------

FLAGS = ["--task", "tiny_ddim", "--ptq", "--cali", "--wq", "4", "--aq", "8",
         "--use_aq", "--cali_iters", str(ITERS), "--seed", "5"]


def _same_adapter(ja):
    """JU.build_adapter for the JAX CLI: builds the adapter its flags ask
    for, checks that its policy is the test's, and hands back the test's
    adapter, whose compiled programs JAX then reuses (JAX keys them on the
    adapter's identity)."""
    build = JU.build_adapter

    def fn(*args, **kwargs):
        own = build(*args, **kwargs)
        assert own.policy.order == ja.policy.order
        assert own.policy.layers == ja.policy.layers
        assert [u.name for u in own.units] == [u.name for u in ja.units]
        return ja
    return fn


@pytest.fixture(scope="module")
def cli_artifacts(setup, full_runs):
    s = setup
    port, ref = str(s["tmp"] / "port.npz"), str(s["tmp"] / "jax.npz")
    assert cli.main(FLAGS + ["--ckpt", s["npz"], "--cali_save_path", port,
                             "--device", "cpu"]) == 0
    with mock.patch.object(JU, "build_adapter", _same_adapter(s["ja"])):
        assert jcli.main(FLAGS + ["--ckpt", s["pth"], "--cali_save_path",
                                  ref, "--out", str(s["tmp"] / "jax")]) == 0
    return dict(tmp=s["tmp"], npz=s["npz"], port=port, ref=ref)


def test_cli_cali_artifact_has_the_jax_clis_keys(cli_artifacts):
    a = cli_artifacts
    with np.load(a["port"]) as p, np.load(a["ref"]) as r:
        assert sorted(p.files) == sorted(r.files)
        for k in r.files:
            if k != "__meta__":
                assert p[k].shape == r[k].shape and p[k].dtype == \
                    r[k].dtype, k
    assert any(k.endswith("::alpha") for k in np.load(a["port"]).files)
    # loads in both packages, with the same state keys
    jw, jast, jmeta = j_load(a["port"])
    tw, tast, tmeta = t_load(a["port"], device="cpu")
    rw, rast, rmeta = j_load(a["ref"])
    assert {k: sorted(v) for k, v in jw.items()} == \
        {k: sorted(v) for k, v in tw.items()} == \
        {k: sorted(v) for k, v in rw.items()}
    assert sorted(jast) == sorted(tast) == sorted(rast)
    assert tmeta == jmeta
    # the JAX CLI's meta, plus the port's reconstruction and FSC records
    assert set(tmeta) - set(rmeta) == {"recon", "fsc"}
    for k in rmeta:
        assert tmeta[k] == rmeta[k], k
    units = tmeta["recon"]["units"]
    assert len(units) == 14
    assert all(u["kept"] in ("trained", "nearest") and "loss_last" in u
               for u in units.values())
    json.dumps(tmeta)


def test_cli_samples_from_its_calibrated_artifact(cli_artifacts):
    a = cli_artifacts
    out = a["tmp"] / "samples"
    assert cli.main(["--task", "tiny_ddim", "--ckpt", a["npz"], "--ptq",
                     "--cali_ckpt", a["port"], "--use_aq", "--int-kernels",
                     "--int4-serving", "-n", "2", "--batch", "2",
                     "--device", "cpu", "--out", str(out)]) == 0
    img = np.load(out / "samples.npy")
    assert img.shape == (2, 16, 16, 3) and np.all(np.isfinite(img))
    assert img.min() >= 0 and img.max() <= 1


def test_cli_cali_refuses_an_ldm_task(tmp_path):
    """An LDM task calibrates from its Lightning checkpoint only: without
    ``--ckpt`` the CLI refuses it."""
    with pytest.raises(SystemExit) as e:
        cli.main(["--task", "tiny_cin", "--ptq", "--cali", "--device",
                  "cpu"])
    assert "needs --ckpt" in str(e.value.code)
    with pytest.raises(SystemExit) as e:
        cli.main(["--task", "tiny_ddim", "--cali", "--device", "cpu"])
    assert "--ptq" in str(e.value.code)


def test_quality_gate_twin_runs_on_the_cpu(setup, tmp_path):
    """The port's quality gate end to end at the tiny config: the JAX
    script's keys (but its proxy FD) with finite numbers, a guard record
    over every unit."""
    from tfmq_dm_tpu_torch.scripts import quality_gate
    out, sim = tmp_path / "gate.json", tmp_path / "sim.json"
    flags = ["tiny_ddim", "--ckpt", setup["npz"], "--iters", "2",
             "--n-cali", "4", "--batch", "2", "--device", "cpu",
             "--resume-dir", str(tmp_path / "resume")]
    assert quality_gate.main(flags + ["--json", str(out)]) == 0
    # the second run loads the finished calibration and samples from the
    # fake-quant simulation on the same noise
    assert quality_gate.main(flags + ["--deployment", "fake-quant",
                                      "--json", str(sim)]) == 0
    r, q = json.loads(out.read_text()), json.loads(sim.read_text())
    assert q["recon_guard"] == r["recon_guard"]
    assert q["deployment"].startswith("fake-quant")
    assert abs(q["sample_psnr_db"] - r["sample_psnr_db"]) < 10
    for k in ("unet_sqnr_db_mean", "unet_sqnr_db_min", "sample_psnr_db",
              "traj_sqnr_db", "calibration_s"):
        assert np.isfinite(r[k]), k
    assert r["setting"] == "w4a8" and r["recon_iters"] == 2
    assert r["recon_guard"]["units"] == 14
    # the plain versions ran: a wrapper counts launches of its kernel only
    assert r["kernel_launches"] == {"int4_linear": 0, "int4_conv2d": 0}
