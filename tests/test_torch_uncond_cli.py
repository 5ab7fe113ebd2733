"""Both CLIs on the unconditional tasks, on the CPU: ``tiny_ldm`` from one
Lightning checkpoint (the JAX export's), and ``tiny_ddim`` from the
reference's DDIM trainer checkpoint and by a pretrained-DDPM name in the
local cache.

- Sampling: ``cli.main`` of both packages from one checkpoint and one
  starting noise (the port's first draw, handed to the JAX CLI's
  ``sample_fid``): FP images within ``FP_IMG_ABS``, f32 summation order.
- ``--ptq --cali --use_aq`` on both CLIs, unconditional harvests: the
  port's harvest handed to both, the port drawing its minibatches, FSC
  subsets and EMA orders from the JAX CLI's keys (as
  test_torch_ldm_cali_cli.py does for the class-conditional family):
  every weight's hard-rounded codes and the zero points equal, the FSC
  deltas within test_torch_fsc_ema.py's limits (10% at every (site,
  group), median 5e-3), the FSC zero points within ``FSC_ZP_CODES``
  (one code), the meta equal (measured at ``ITERS``: deltas within 1.2%,
  median 3.3e-4; zero points off by one code at 12 of 192 pairs). Then both
  CLIs sample int4-serving from the JAX artifact on one noise: decoded
  images within test_torch_ldm_slice.py's limit (``IMG_MEAN_REL``, 5% of
  the mean magnitude, measured 0.97%; the port rounds the int4 operands
  to bf16 as the TPU kernels do, JAX's CPU dispatch keeps f32), and the
  port samples from its own artifact.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfmq_dm_tpu import cli as jcli
from tfmq_dm_tpu.configs import tasks as jtasks
from tfmq_dm_tpu.models import ddim_unet as JD
from tfmq_dm_tpu.models import ldm_unet as JL
from tfmq_dm_tpu.models import ldm_units as JLU
from tfmq_dm_tpu.models import vae as JV
from tfmq_dm_tpu.pipelines import ckpt_util as jck
from tfmq_dm_tpu.pipelines import ptq as jptq
from tfmq_dm_tpu.pipelines import sampling as jsampling
from tfmq_dm_tpu.quant.calibrate import load_cali_model as j_load
from tfmq_dm_tpu.utils.torch_convert import export_state_dict as j_export
from tfmq_dm_tpu_torch import cli
from tfmq_dm_tpu_torch.configs import tasks as ttasks
from tfmq_dm_tpu_torch.models import ldm_unet as TL
from tfmq_dm_tpu_torch.pipelines import ckpt_util as tck
from tfmq_dm_tpu_torch.pipelines import loading as tload
from tfmq_dm_tpu_torch.pipelines import ptq as tptq
from tfmq_dm_tpu_torch.quant import calibrate as tcal
from tfmq_dm_tpu_torch.quant.calibrate import load_cali_model as t_load
from test_torch_fsc_ema import (FSC_DELTA_MEDIAN_REL, FSC_DELTA_REL,
                                FSC_ZP_CODES, jax_fsc_indices)
from test_torch_ldm_cali_cli import _codes, _jax_cli_keys, _same_harvest
from test_torch_ldm_modules import random_params
from test_torch_ldm_recon import jax_rows
from test_torch_ldm_slice import IMG_MEAN_REL

ITERS, SEED, CALI_N, N = 6, 5, 16, 2
# FP images in [0, 1], the two CLIs: f32 summation order through 4 (LDM)
# or 5 (DDIM) sampler steps and the decoder (measured 1.9e-6 and 5.4e-7)
FP_IMG_ABS = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_cli_images(argv, x_T):
    """The JAX CLI's sampled images (``sample_fid``'s return) with its
    starting noise replaced by ``x_T`` (drawn without a dtype,
    sampling.py:140; the sampler's step noise passes one)."""
    real_normal, real_fid, got = jax.random.normal, jsampling.sample_fid, []

    def normal(key, shape, dtype=None):
        return jnp.asarray(x_T) if dtype is None else \
            real_normal(key, shape, dtype)

    def fid(*a, **kw):
        got.append(np.asarray(real_fid(*a, **kw)))
        return got[-1]

    with mock.patch.object(jax.random, "normal", normal), \
            mock.patch.object(jsampling, "sample_fid", fid):
        assert jcli.main(argv) == 0
    return got[0]


def _port_images(argv, out):
    assert cli.main(argv + ["--device", "cpu", "--out", str(out)]) == 0
    return np.load(out / "samples.npy")


def _first_draw(shape):
    """The port CLI's starting noise: the first draw of a generator seeded
    ``--seed``."""
    return torch.randn((N,) + shape, generator=torch.Generator()
                       .manual_seed(SEED)).numpy()


# ---------------------------------------------------------------------------
# tiny_ldm: sampling and calibration through both CLIs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ldm(tmp_path_factory):
    """A tiny_ldm Lightning checkpoint (UNet and VQ first stage, no
    conditioning stage) and the port's unconditional harvest of it (4
    steps x CALI_N: 16 rows a group, one batch of the FSC running-stat
    pass)."""
    tmp = tmp_path_factory.mktemp("uncond_cli")
    jt = jtasks.get_task("tiny_ldm")
    rng = np.random.default_rng(31)
    up = random_params(JL.iter_layers(jt.unet), rng)
    vp = random_params(JV.iter_layers(jt.vae, encoder=False), rng)
    sd = {f"model.diffusion_model.{k}": torch.from_numpy(np.array(v))
          for k, v in j_export(up, JL.iter_layers(jt.unet)).items()}
    sd.update({f"first_stage_model.{k}": torch.from_numpy(np.array(v))
               for k, v in j_export(
                   vp, JV.iter_layers(jt.vae, encoder=False)).items()})
    ckpt = str(tmp / "tiny_ldm.ckpt")
    torch.save({"state_dict": sd}, ckpt)
    tt = ttasks.get_task("tiny_ldm")
    tp = tload.load_ldm_checkpoint(ckpt, tt, device="cpu")[0]
    harvest = tptq.generate_cali_data(
        tt, lambda x, t, c: TL.apply(tp, tt.unet, x, t),
        torch.Generator().manual_seed(3), n_per_t=CALI_N, device="cpu")
    return dict(tmp=tmp, ckpt=ckpt, harvest=harvest,
                x_T=_first_draw((8, 8, 3)))


def test_fp_sample_matches_the_jax_cli(ldm):
    common = ["--task", "tiny_ldm", "--ckpt", ldm["ckpt"], "-n", str(N),
              "--batch", str(N), "--seed", str(SEED)]
    ref = _jax_cli_images(common + ["--out", str(ldm["tmp"] / "jfp")],
                          ldm["x_T"])
    got = _port_images(common, ldm["tmp"] / "tfp")
    assert got.shape == ref.shape == (N, 16, 16, 3)
    assert np.abs(got - ref).max() <= FP_IMG_ABS
    lat = np.load(ldm["tmp"] / "tfp" / "latents.npy")
    assert lat.shape == (N, 8, 8, 3) and np.all(np.isfinite(lat))


FLAGS = ["--task", "tiny_ldm", "--ptq", "--cali", "--wq", "4", "--aq", "8",
         "--use_aq", "--cali_iters", str(ITERS), "--cali_n", str(CALI_N),
         "--seed", str(SEED)]


@pytest.fixture(scope="module")
def cali_runs(ldm):
    s = ldm
    port, ref = str(s["tmp"] / "port.npz"), str(s["tmp"] / "jax.npz")
    jcalls, tcalls = [], []
    with mock.patch.object(jptq, "generate_cali_data", _same_harvest(
            s["harvest"], lambda x: jnp.asarray(x.numpy()), jcalls)):
        assert jcli.main(FLAGS + ["--ckpt", s["ckpt"], "--cali_save_path",
                                  ref, "--out", str(s["tmp"] / "jax")]) == 0
    k_recon, k_fsc = _jax_cli_keys(SEED)
    ja = JLU.build_adapter(jtasks.get_task("tiny_ldm").unet, use_aq=True)
    unit_keys, k = {}, k_recon
    for u in ja.units:
        if u.recon and ja.default_train_roles(u):
            k, unit_keys[u.name] = jax.random.split(k)
    rows = {u: jax_rows(uk) for u, uk in unit_keys.items()}
    real_recon, real_fsc = tcal.reconstruct, tcal.fsc_calibrate
    a_cali = s["harvest"][1]

    def recon(*a, **kw):
        kw["indices"] = lambda u, n, bs, it: rows[u](u, n, bs, it)
        return real_recon(*a, **kw)

    def fsc(*a, **kw):
        return real_fsc(*a, **kw, indices=jax_fsc_indices(
            k_fsc, a_cali[0].shape[0], a_cali[0].shape[1], 16))

    with mock.patch.object(tptq, "generate_cali_data", _same_harvest(
            s["harvest"], lambda x: x, tcalls)), \
            mock.patch.object(tcal, "reconstruct", recon), \
            mock.patch.object(tcal, "fsc_calibrate", fsc):
        assert cli.main(FLAGS + ["--ckpt", s["ckpt"], "--cali_save_path",
                                 port, "--device", "cpu"]) == 0
    return dict(port=port, ref=ref, jcalls=jcalls, tcalls=tcalls)


def test_cli_harvests_unconditionally(cali_runs):
    """Both CLIs ask for the harvest without a context: --cali_n rows a
    step, no CFG."""
    (jkw,), (tkw,) = cali_runs["jcalls"], cali_runs["tcalls"]
    assert jkw["n_per_t"] == tkw["n_per_t"] == CALI_N
    assert jkw["context"] is None and jkw["uncond"] is None
    assert tkw["context"] is None and tkw["uncond"] is None


def test_cli_artifact_matches_the_jax_clis(ldm, cali_runs):
    tw, tast, tmeta = t_load(cali_runs["port"], device="cpu")
    jw, jast, jmeta = j_load(cali_runs["ref"])
    with np.load(cali_runs["port"]) as p, np.load(cali_runs["ref"]) as r:
        assert sorted(p.files) == sorted(r.files)
    assert set(tmeta) - set(jmeta) == {"recon", "fsc"}
    assert all(tmeta[k] == jmeta[k] for k in jmeta)
    assert jmeta["task"] == "tiny_ldm" and len(jmeta["cali_t"]) == 4
    assert len(tmeta["recon"]["units"]) == 14
    assert tmeta["fsc"] == {"groups": 4, "rows": CALI_N, "ema_batches": 1}
    params = tload.load_ldm_checkpoint(ldm["ckpt"],
                                       ttasks.get_task("tiny_ldm"),
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
        np.testing.assert_array_equal(
            _codes(w, {k: v.numpy() for k, v in tw[name].items()}),
            _codes(w, {k: np.asarray(v) for k, v in jst.items()}),
            err_msg=name)
    assert n_alpha > 0
    assert sorted(tast) == sorted(jast)
    rel, zp = [], []
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


def test_int4_serving_samples_match_the_jax_cli(ldm, cali_runs):
    """Both CLIs sample the JAX artifact with the int4-serving deployment
    from one noise; the port also samples its own artifact."""
    common = ["--task", "tiny_ldm", "--ckpt", ldm["ckpt"], "-n", str(N),
              "--batch", str(N), "--seed", str(SEED), "--ptq", "--use_aq",
              "--int-kernels", "--int4-serving"]
    art = ["--cali_ckpt", cali_runs["ref"]]
    ref = _jax_cli_images(common + art + ["--out", str(ldm["tmp"] / "jq")],
                          ldm["x_T"])
    got = _port_images(common + art, ldm["tmp"] / "tq")
    assert got.shape == ref.shape == (N, 16, 16, 3)
    assert np.all(np.isfinite(got)) and got.min() >= 0 and got.max() <= 1
    assert np.abs(got - ref).mean() <= IMG_MEAN_REL * np.abs(ref).mean()
    own = _port_images(common + ["--cali_ckpt", cali_runs["port"]],
                       ldm["tmp"] / "tq_own")
    assert own.shape == (N, 16, 16, 3) and np.all(np.isfinite(own))
    assert own.min() >= 0 and own.max() <= 1


# ---------------------------------------------------------------------------
# tiny_ddim from the reference's DDIM checkpoint
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ddim(tmp_path_factory):
    """The DDIM trainer's ``[state, optimizer, epoch, step, ema]`` list
    under DataParallel's ``module.`` names, its EMA shadow other weights
    than the raw ones."""
    tmp = tmp_path_factory.mktemp("ddim_cli")
    cfg = JD.tiny_config()
    rng = np.random.default_rng(41)
    raw, ema = ({f"module.{k}": torch.from_numpy(np.array(v))
                 for k, v in j_export(random_params(JD.iter_layers(cfg),
                                                    rng),
                                      JD.iter_layers(cfg)).items()}
                for _ in range(2))
    ckpt = tmp / "ckpt.pth"
    torch.save([raw, {"state": {}, "param_groups": [{"lr": 2e-4}]}, 7,
                1000, ema], ckpt)
    return dict(tmp=tmp, ckpt=str(ckpt), x_T=_first_draw((16, 16, 3)))


def test_ddim_reference_checkpoint_samples_as_the_jax_cli(ddim):
    """FP sampling from the trainer's checkpoint (EMA weights) through
    both CLIs; the port then calibrates from it and samples its artifact
    with the int4-serving deployment."""
    common = ["--task", "tiny_ddim", "--ckpt", ddim["ckpt"], "-n", str(N),
              "--batch", str(N), "--seed", str(SEED)]
    ref = _jax_cli_images(common + ["--out", str(ddim["tmp"] / "j")],
                          ddim["x_T"])
    got = _port_images(common, ddim["tmp"] / "t")
    assert got.shape == ref.shape == (N, 16, 16, 3)
    assert np.abs(got - ref).max() <= FP_IMG_ABS
    art = str(ddim["tmp"] / "cali.npz")
    assert cli.main(common + ["--ptq", "--cali", "--use_aq", "--cali_iters",
                              "2", "--cali_n", "4", "--cali_save_path", art,
                              "--device", "cpu"]) == 0
    q = _port_images(common + ["--ptq", "--cali_ckpt", art, "--use_aq",
                               "--int-kernels", "--int4-serving"],
                     ddim["tmp"] / "q")
    assert q.shape == (N, 16, 16, 3) and np.all(np.isfinite(q))


def test_ddim_checkpoint_name_resolves_from_the_cache(ddim, monkeypatch):
    """``--ckpt ema_lsun_church`` (or the reference's church_outdoor
    alias): both CLIs read the file from the local cache once its md5
    holds; the port refuses a missing file and never downloads."""
    cache = ddim["tmp"] / "cache"
    monkeypatch.setenv("XDG_CACHE_HOME", str(cache))
    monkeypatch.delenv("TFMQ_ALLOW_DOWNLOAD", raising=False)
    common = ["--task", "tiny_ddim", "-n", str(N), "--batch", str(N),
              "--seed", str(SEED)]
    with pytest.raises(SystemExit, match="never downloads"):
        cli.main(common + ["--ckpt", "ema_lsun_church_outdoor", "--device",
                           "cpu", "--out", str(ddim["tmp"] / "miss")])
    name = "ema_lsun_church"
    path = cache / "diffusion_models_converted" / tck.CACHE_PATHS[name]
    path.parent.mkdir(parents=True)
    path.write_bytes(open(ddim["ckpt"], "rb").read())
    digest = tck.md5_of(str(path))
    monkeypatch.setitem(tck.MD5S, name, digest)
    monkeypatch.setitem(jck.MD5S, name, digest)
    ref = _jax_cli_images(common + ["--ckpt", name, "--out",
                                    str(ddim["tmp"] / "jn")], ddim["x_T"])
    got = _port_images(common + ["--ckpt", "ema_lsun_church_outdoor"],
                       ddim["tmp"] / "tn")
    assert np.abs(got - ref).max() <= FP_IMG_ABS


def test_cli_takes_the_new_tasks_and_refuses_a_missing_card():
    """``--task`` takes the eight tasks of the slice; the entry point runs
    on the card unless asked for the CPU."""
    for name in ("tiny_ldm", "celeba256", "ffhq256", "lsun_beds256",
                 "lsun_churches256", "ddim_celeba64", "ddim_lsun_bedroom",
                 "ddim_lsun_church"):
        args = cli.build_argparser().parse_args(["--task", name])
        assert args.device == "cuda" and ttasks.get_task(name).name == name
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="cuda"):
            cli.main(["--task", "tiny_ldm", "--ckpt", "x.ckpt", "--out",
                      "-"])
