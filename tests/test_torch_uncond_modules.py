"""The port's unconditional LDM tasks (CelebA-HQ, FFHQ, LSUN-Bedrooms,
LSUN-Churches) and the other ddim tasks against the JAX package, on the
CPU: the task and UNet configs, the layer walk with resolutions, the
``diffusion_wrapper`` dispatch, a tiny scale-shift / up-down UNet (FP,
fake-quant and int4-serving through the plain versions) with its units
and policy, both checkpoint loaders, ``ckpt_util``'s registry and md5
check, and the stochastic DDIM sampler (eta 1) on JAX's noise.

Tolerances. FP forwards and the samplers differ in f32 summation order
only: ``FP_RTOL`` (1e-5) of the output's largest magnitude. The quantized
forwards keep the limits of test_torch_ldm_modules.py (fake-quant 5e-2,
int4-serving 0.1 of the largest magnitude: an 8-bit code at a rounding
boundary flips, and the port rounds the int4 operands to bf16 as the TPU
kernels do). Configs, walks, units, policies and loaded parameters are
compared exactly.
"""

import dataclasses
import hashlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfmq_dm_tpu.configs import tasks as jtasks
from tfmq_dm_tpu.models import ddim_unet as JD
from tfmq_dm_tpu.models import ldm_unet as JL
from tfmq_dm_tpu.models import ldm_units as JLU
from tfmq_dm_tpu.models import vae as JV
from tfmq_dm_tpu.pipelines import ckpt_util as jck
from tfmq_dm_tpu.pipelines import loading as jload
from tfmq_dm_tpu.pipelines import ptq as jptq
from tfmq_dm_tpu.quant import deploy as jdep
from tfmq_dm_tpu.quant.context import QuantCtx as JCtx
from tfmq_dm_tpu.quant.recon import init_weight_qparams as j_iwq
from tfmq_dm_tpu.samplers import ldm as jldm
from tfmq_dm_tpu.utils.torch_convert import export_state_dict as j_export
from tfmq_dm_tpu_torch.configs import tasks as ttasks
from tfmq_dm_tpu_torch.convert import params_from_numpy
from tfmq_dm_tpu_torch.models import ldm_unet as TL
from tfmq_dm_tpu_torch.models import ldm_units as TLU
from tfmq_dm_tpu_torch.pipelines import ckpt_util as tck
from tfmq_dm_tpu_torch.pipelines import loading as tload
from tfmq_dm_tpu_torch.pipelines import ptq as tptq
from tfmq_dm_tpu_torch.quant import deploy as tdep
from tfmq_dm_tpu_torch.quant import qfunc
from tfmq_dm_tpu_torch.quant.context import QuantCtx as TCtx
from tfmq_dm_tpu_torch.quant.fsc import fsc_calibrate as t_fsc
from tfmq_dm_tpu_torch.samplers import ldm as tldm

from test_torch_ldm_modules import (assert_fp_close, random_params,
                                    rel_err, tree_torch)
from test_torch_sd_modules import _policy_spec

UNCOND_TASKS = ("tiny_ldm", "celeba256", "ffhq256", "lsun_beds256",
                "lsun_churches256", "ddim_celeba64", "ddim_lsun_bedroom",
                "ddim_lsun_church")
# the tiny UNet with LSUN-Churches' options: scale-shift norm, res blocks
# that resample, AttentionBlocks by head count
SS_UD = dict(use_scale_shift_norm=True, resblock_updown=True,
             num_head_channels=-1, num_heads=2)


# ---------------------------------------------------------------------------
# configs and the layer walk
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", UNCOND_TASKS)
def test_task_configs_match_jax(name):
    """Every field the port's TaskConfig has, the UNet's and the first
    stage's configs field by field, the beta schedule, and the sampler's
    timesteps at the task's steps (400 gives the reference's 500)."""
    jt, tt = jtasks.get_task(name), ttasks.get_task(name)
    for f in dataclasses.fields(tt):
        if f.name not in ("unet", "vae", "clip"):
            assert getattr(tt, f.name) == getattr(jt, f.name), f.name
    assert dataclasses.asdict(tt.unet) == dataclasses.asdict(jt.unet)
    assert type(tt.unet).__name__ == type(jt.unet).__name__
    if jt.vae is None:
        assert tt.vae is None
    else:
        assert dataclasses.asdict(tt.vae) == dataclasses.asdict(jt.vae)
    assert tt.cond == "none" and tt.use_ema == jt.use_ema
    np.testing.assert_array_equal(ttasks.task_betas(tt),
                                  jtasks.task_betas(jt))
    _, jt_t = jptq.make_schedule(jt)
    _, tt_t = tptq.make_schedule(tt)
    np.testing.assert_array_equal(tt_t, jt_t)


@pytest.mark.parametrize("kw", [
    {}, dict(resblock_updown=True), dict(conv_resample=False),
    dict(SS_UD, conv_resample=False, channel_mult=(1, 2, 2),
         attention_resolutions=(1, 2, 4))],
    ids=["plain", "updown", "no_conv_resample", "scale_shift_updown"])
def test_layer_res_walk_matches_the_forward(kw):
    """``iter_layers_with_res`` gives each quantized conv and each
    AttentionBlock qkv / proj_out the spatial size that the port's forward feeds it
    (read at ``qfunc``'s call sites); the walk's layer names equal
    JAX's ``iter_layers``."""
    cfg = TL.tiny_ldm_config(**kw)
    assert [n for _, n, _, _ in TL.iter_layers_with_res(cfg)] == \
        [n for _, n, _ in JL.iter_layers(JL.tiny_ldm_config(**kw))]
    seen = {}
    real_conv, real_lin = qfunc.qconv2d, qfunc.qlinear

    def conv(qctx, name, x, p, **k):
        seen[name] = x.shape[1]
        return real_conv(qctx, name, x, p, **k)

    def lin(qctx, name, x, p, **k):
        if x.ndim == 3:
            seen[name] = int(round(x.shape[1] ** 0.5))
        return real_lin(qctx, name, x, p, **k)

    g = torch.Generator().manual_seed(0)
    params = TL.init_params(g, cfg)
    x = torch.randn((1, cfg.image_size, cfg.image_size, cfg.in_channels),
                    generator=g)
    with mock.patch.object(qfunc, "qconv2d", conv), \
            mock.patch.object(qfunc, "qlinear", lin):
        TL.apply(params, cfg, x, torch.tensor([3]))
    walked = {name: res for kind, name, _, res in TL.iter_layers_with_res(cfg)
              if kind in ("conv", "conv1d")}
    assert walked == seen
    assert any(name.endswith(".qkv") for name in walked)


def test_layer_res_walk_counts_the_flash_attentions():
    """LSUN-Churches attends at 32x32 (T 1024, the flash gate) in 5
    AttentionBlocks, not in the 21 a walk blind to its resampling res
    blocks reported; the LDM-4 UNet in 5 too."""
    for cfg, n_blocks in ((TL.lsun_churches_config(), 21),
                          (TL.celeba_config(), 16)):
        at = [res for _, name, _, res in TL.iter_layers_with_res(cfg)
              if name.endswith(".qkv")]
        assert len(at) == n_blocks
        assert sum(r * r == 1024 for r in at) == 5


# ---------------------------------------------------------------------------
# diffusion_wrapper and the tiny scale-shift / up-down UNet
# ---------------------------------------------------------------------------

def _wrapper_case(mode, rng):
    """(JAX config, wrapper kwargs as numpy) of DiffusionWrapper's five
    keys, as tests/test_ldm_unet.py:172-224 builds them."""
    x = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
    cc = rng.standard_normal((2, 8, 8, 2)).astype(np.float32)
    c1 = rng.standard_normal((2, 3, 24)).astype(np.float32)
    c2 = rng.standard_normal((2, 2, 24)).astype(np.float32)
    if mode == "none":
        return JL.tiny_ldm_config(), x, {}
    if mode == "concat":
        return JL.tiny_ldm_config(in_channels=5), x, {"c_concat": [cc]}
    if mode == "crossattn":
        return JL.tiny_sd_config(), x, {"c_crossattn": [c1, c2]}
    if mode == "hybrid":
        return JL.tiny_sd_config(in_channels=5), x, \
            {"c_concat": [cc], "c_crossattn": [c1]}
    return JL.tiny_ldm_config(num_classes=7), x, \
        {"c_crossattn": [np.array([1, 4], np.int32)]}


@pytest.mark.parametrize("mode", ["none", "concat", "crossattn", "hybrid",
                                  "adm"])
def test_diffusion_wrapper_matches_jax(mode):
    rng = np.random.default_rng(7)
    jcfg, x, kw = _wrapper_case(mode, rng)
    tcfg = TL.LDMUNetConfig(**jcfg.__dict__)
    np_p = random_params(JL.iter_layers(jcfg), rng)
    t = np.array([5, 9], np.int32)
    key = None if mode == "none" else mode
    jkw = {k: [jnp.asarray(a) for a in v] for k, v in kw.items()}
    ref = np.asarray(jax.jit(lambda p, x_, t_, kw_: JL.diffusion_wrapper(
        p, jcfg, key, x_, t_, **kw_))(jax.tree.map(jnp.asarray, np_p),
                                      jnp.asarray(x), jnp.asarray(t), jkw))
    tp = params_from_numpy(np_p, "cpu")
    tkw = {k: [torch.from_numpy(a) for a in v] for k, v in kw.items()}
    got = TL.diffusion_wrapper(tp, tcfg, key, torch.from_numpy(x),
                               torch.from_numpy(t), **tkw).numpy()
    assert_fp_close(got, ref)
    if mode in ("concat", "hybrid"):
        xin = torch.cat([torch.from_numpy(x)] + tkw["c_concat"], -1)
    else:
        xin = torch.from_numpy(x)
    direct = dict(
        context=torch.cat(tkw["c_crossattn"], 1)
        if mode in ("crossattn", "hybrid") else None,
        y=tkw["c_crossattn"][0] if mode == "adm" else None)
    np.testing.assert_array_equal(
        got, TL.apply(tp, tcfg, xin, torch.from_numpy(t), **direct).numpy())
    with pytest.raises(ValueError, match="conditioning key"):
        TL.diffusion_wrapper(tp, tcfg, "film", torch.from_numpy(x),
                             torch.from_numpy(t))


@pytest.fixture(scope="module")
def ss_setup():
    """The tiny scale-shift / up-down UNet: parameters, minmax weight
    grids (JAX's) and FSC act grids of one timestep group (the port's
    init pass): one state feeds both packages."""
    jcfg = JL.tiny_ldm_config(**SS_UD)
    rng = np.random.default_rng(12)
    np_p = random_params(JL.iter_layers(jcfg), rng)
    jp = jax.tree.map(jnp.asarray, np_p)
    ja = JLU.build_adapter(jcfg, w_bits=4, a_bits=8, use_aq=True)
    jw = j_iwq(ja.policy, jp, scaler="minmax")
    x = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
    t = np.array([37, 901], np.int32)
    tcfg = TL.tiny_ldm_config(**SS_UD)
    ta = TLU.build_adapter(tcfg, w_bits=4, a_bits=8, use_aq=True)
    tp = params_from_numpy(np_p, "cpu")
    tast = t_fsc(ta, tp, tree_torch(jw),
                 tuple(torch.from_numpy(a)[None] for a in (x, t)),
                 torch.Generator().manual_seed(0), running_stat=False,
                 init_samples=2, act_scaler="minmax")
    jast = jax.tree.map(lambda a: jnp.asarray(a[0].numpy()), tast)
    xs = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp, tp=tp, ja=ja, ta=ta, jw=jw,
                jast=jast, x=xs, t=np.array([11, 640], np.int32))


@pytest.mark.parametrize("path", ["fp", "fake_quant", "int4_serving"])
def test_scale_shift_updown_unet_matches_jax(ss_setup, path):
    """FP within FP_RTOL; fake-quant w4a8 within 5e-2 and the deployed
    packed-int4 model (plain versions against JAX's f32 CPU dispatch)
    within 0.1 of the output's largest magnitude."""
    s = ss_setup
    x, t = s["x"], s["t"]
    jctx = tctx = None
    if path == "fake_quant":
        jctx = JCtx(s["ja"].policy, wstate=s["jw"], astate=s["jast"],
                    use_wq=True, use_aq=True, flash=True)
        tctx = TCtx(s["ta"].policy, wstate=tree_torch(s["jw"]),
                    astate=tree_torch(s["jast"]), use_wq=True, use_aq=True,
                    flash=True)
    elif path == "int4_serving":
        jd = jdep.deploy_weights(s["ja"].policy, s["jp"], s["jw"],
                                 int4_serving=True)
        td = tdep.deploy_weights(s["ta"].policy, s["tp"],
                                 tree_torch(s["jw"]), int4_serving=True)
        jctx = JCtx(s["ja"].policy, astate=s["jast"], use_wq=True,
                    use_aq=True, deploy=jd, flash=True)
        tctx = TCtx(s["ta"].policy, astate=tree_torch(s["jast"]),
                    use_wq=True, use_aq=True, deploy=td, flash=True)
    ref = np.asarray(jax.jit(lambda x_, t_: JL.apply(
        s["jp"], s["jcfg"], x_, t_, qctx=jctx))(jnp.asarray(x),
                                                jnp.asarray(t)))
    got = TL.apply(s["tp"], s["tcfg"], torch.from_numpy(x),
                   torch.from_numpy(t), qctx=tctx).numpy()
    assert np.all(np.isfinite(got))
    if path == "fp":
        assert_fp_close(got, ref)
    else:
        assert rel_err(got, ref) <= (5e-2 if path == "fake_quant" else 0.1)


@pytest.mark.parametrize("use_aq", [False, True])
@pytest.mark.parametrize("cfg_name", ["tiny_ss_ud", "lsun_churches_config",
                                      "celeba_config"])
def test_units_and_policy_match_jax(cfg_name, use_aq):
    """Layer inventory, policy and reconstruction units (names, kinds,
    layers, act sites, ``extra``: scale-shift and up/down for the res
    units, heads for the AttentionBlocks) equal JAX's, at the tiny
    scale-shift / up-down UNet and the two full-width configs."""
    if cfg_name == "tiny_ss_ud":
        jc, tc = JL.tiny_ldm_config(**SS_UD), TL.tiny_ldm_config(**SS_UD)
    else:
        jc, tc = getattr(JL, cfg_name)(), getattr(TL, cfg_name)()
    assert list(TL.iter_layers(tc)) == list(JL.iter_layers(jc))
    assert [dataclasses.astuple(i) for i in TL.layer_infos(tc, use_aq)] \
        == [(i.name, i.kind, i.quant_emb, i.softmax, i.unit)
            for i in JL.layer_infos(jc, use_aq)]
    ta = TLU.build_adapter(tc, w_bits=4, a_bits=8, use_aq=use_aq)
    ja = JLU.build_adapter(jc, w_bits=4, a_bits=8, use_aq=use_aq)
    assert _policy_spec(ta.policy) == _policy_spec(ja.policy)

    def spec(adapter):
        return [(u.name, u.kind, u.layers, u.act_sites, u.extra, u.recon,
                 sorted(adapter.default_train_roles(u)))
                for u in adapter.units]
    assert spec(ta) == spec(ja)
    kinds = {u.kind for u in ta.units}
    assert {"res_ldm", "attn_ldm", "tib_ldm"} <= kinds
    if cfg_name != "celeba_config":
        assert {u.extra for u in ta.units if u.kind == "res_ldm"} == \
            {(True, 0), (True, 1), (True, 2)}


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _bit_equal(ttree, jtree):
    assert set(ttree) == set(jtree)
    for name in jtree:
        assert set(ttree[name]) == set(jtree[name]), name
        for f in jtree[name]:
            np.testing.assert_array_equal(ttree[name][f].numpy(),
                                          np.asarray(jtree[name][f]),
                                          err_msg=name)


@pytest.mark.parametrize("vae_kind", ["vq", "kl"])
def test_ldm_loader_unconditional_matches_jax(tmp_path, vae_kind):
    """An unconditional Lightning checkpoint (no conditioning stage; VQ-f4
    with its codebook or KL-f8 at scale_factor 1.0) with LitEma weights:
    both loaders give bit-equal parameters with and without the EMA
    swap, and no conditioning parameters."""
    jt = jtasks.get_task("tiny_ldm")
    if vae_kind == "kl":
        jt = dataclasses.replace(jt, vae=JV.tiny_vae_config(
            vq=False, z_channels=4, embed_dim=4, double_z=True))
    tt = dataclasses.replace(ttasks.get_task("tiny_ldm"),
                             vae=type(ttasks.get_task("tiny_ldm").vae)(
                                 **dataclasses.asdict(jt.vae)))
    rng = np.random.default_rng(3)
    usd = j_export(random_params(JL.iter_layers(jt.unet), rng),
                   JL.iter_layers(jt.unet))
    vsd = j_export(random_params(JV.iter_layers(jt.vae, encoder=False),
                                 rng), JV.iter_layers(jt.vae, encoder=False))
    esd = j_export(random_params(JL.iter_layers(jt.unet), rng),
                   JL.iter_layers(jt.unet))
    sd = {f"model.diffusion_model.{k}": torch.from_numpy(np.array(v))
          for k, v in usd.items()}
    sd.update({f"first_stage_model.{k}": torch.from_numpy(np.array(v))
               for k, v in vsd.items()})
    sd.update({"model_ema." + f"diffusion_model.{k}".replace(".", ""):
               torch.from_numpy(np.array(v)) for k, v in esd.items()})
    sd["model_ema.num_updates"] = torch.tensor(7, dtype=torch.int32)
    path = str(tmp_path / "uncond.ckpt")
    torch.save({"state_dict": sd}, path)
    for use_ema in (False, True):
        ju, jv, jc = jload.load_ldm_checkpoint(path, jt, use_ema=use_ema)
        tu, tv, tc = tload.load_ldm_checkpoint(path, tt, use_ema=use_ema,
                                               device="cpu")
        _bit_equal(tu, ju)
        _bit_equal(tv, jv)
        assert jc is None and tc is None
        w = tu["input_blocks.0.0"]["w"].permute(3, 2, 0, 1).numpy()
        np.testing.assert_array_equal(
            w, np.asarray((esd if use_ema else usd)
                          ["input_blocks.0.0.weight"]))


def _ddim_state(seed):
    cfg = JD.tiny_config()
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy(np.array(v)) for k, v in j_export(
        random_params(JD.iter_layers(cfg), rng),
        JD.iter_layers(cfg)).items()}


@pytest.mark.parametrize("layout", ["bare", "module_list", "state_dict"])
def test_ddim_loader_matches_jax(tmp_path, layout):
    """The reference's DDIM checkpoints: a bare state dict, the trainer's
    ``[state, optimizer, epoch, step, ema]`` list under DataParallel's
    ``module.`` names, and ``{"state_dict": ...}``; both loaders give
    bit-equal parameters, with the EMA shadow swapped in where there is
    one and asked for."""
    raw, ema = _ddim_state(4), _ddim_state(5)
    if layout == "bare":
        obj = raw
    elif layout == "state_dict":
        obj = {"state_dict": raw}
    else:
        obj = [{f"module.{k}": v for k, v in raw.items()},
               {"state": {}, "param_groups": [{"lr": 2e-4}]}, 3, 1000,
               {f"module.{k}": v for k, v in ema.items()}]
    path = str(tmp_path / "ckpt.pth")
    torch.save(obj, path)
    for use_ema in (False, True):
        j = jload.load_ddim_checkpoint(path, JD.tiny_config(),
                                       use_ema=use_ema)
        t = tload.load_ddim_checkpoint(path, ttasks.get_task(
            "tiny_ddim").unet, use_ema=use_ema, device="cpu")
        _bit_equal(t, j)
        want = ema if (use_ema and layout == "module_list") else raw
        np.testing.assert_array_equal(
            t["conv_in"]["w"].permute(3, 2, 0, 1).numpy(),
            want["conv_in.weight"].numpy())


def test_ckpt_util_matches_jax(tmp_path, monkeypatch):
    """The registry and ``md5_of`` equal JAX's; a cached file resolves by
    name and by the church_outdoor alias when its md5 holds, and a missing
    or corrupt file raises with where to put it: nothing is fetched."""
    assert tck.URLS == jck.URLS and tck.MD5S == jck.MD5S
    assert tck.CACHE_PATHS == jck.CACHE_PATHS
    blob = tmp_path / "blob.bin"
    blob.write_bytes(b"tfmq" * 70000)
    assert tck.md5_of(str(blob)) == jck.md5_of(str(blob)) == \
        hashlib.md5(b"tfmq" * 70000).hexdigest()
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    name = "ema_lsun_church"
    with pytest.raises(FileNotFoundError, match="never downloads"):
        tck.get_ckpt_path("ema_lsun_church_outdoor")
    with pytest.raises(KeyError):
        tck.get_ckpt_path("nope")
    path = tmp_path / "cache" / "diffusion_models_converted" / \
        tck.CACHE_PATHS[name]
    path.parent.mkdir(parents=True)
    path.write_bytes(b"not the published weights")
    with pytest.raises(FileNotFoundError, match="md5"):
        tck.get_ckpt_path(name)
    monkeypatch.setitem(tck.MD5S, name, tck.md5_of(str(path)))
    assert tck.get_ckpt_path("ema_lsun_church_outdoor") == str(path)


# ---------------------------------------------------------------------------
# stochastic DDIM (eta 1) on JAX's noise
# ---------------------------------------------------------------------------

def _toy_eps(lib, x, t):
    tt = t.astype(jnp.float32) if lib is jnp else t.float()
    return lib.tanh(0.7 * x + 1e-3 * tt.reshape(-1, 1, 1, 1))


def _jax_step_noise(key, steps, shape):
    """The draws of JAX's ``ddim_scan_ldm`` (samplers/ldm.py:105): step
    i's from ``fold_in(key, i)``."""
    return np.stack([np.asarray(jax.random.normal(
        jax.random.fold_in(key, i), shape, jnp.float32))
        for i in range(steps)])


def test_ddim_scan_ldm_eta1_matches_jax_on_its_noise():
    """ffhq256 / lsun_beds256's sampler (eta 1) at 4 steps: the port fed
    JAX's per-step draws gives JAX's trajectory; without a generator or
    noise it refuses, and a noise tensor of the wrong shape is refused."""
    task = jtasks.get_task("ffhq256")
    assert task.eta == 1.0
    ac = np.cumprod(1.0 - jtasks.task_betas(task))
    ts = jldm.make_ddim_timesteps(4, task.num_timesteps)
    jsched = jldm.DDIMScheduleLDM(ac, ts, eta=1.0)
    tsched = tldm.DDIMScheduleLDM(ac, ts, eta=1.0)
    assert np.all(tsched.sigma > 0)
    x = np.random.default_rng(9).standard_normal((2, 8, 8, 3)).astype(
        np.float32)
    key = jax.random.PRNGKey(3)
    jx, (jxs, jts) = jldm.ddim_scan_ldm(
        lambda x_, t_, s: _toy_eps(jnp, x_, t_), jsched, jnp.asarray(x),
        key, collect="traj")
    noise = torch.from_numpy(_jax_step_noise(key, 4, x.shape))
    tx, (txs, tts) = tldm.ddim_scan_ldm(
        lambda x_, t_, s: _toy_eps(torch, x_, t_), tsched,
        torch.from_numpy(x), collect="traj", noise=noise)
    assert_fp_close(tx.numpy(), np.asarray(jx))
    assert_fp_close(txs.numpy(), np.asarray(jxs))
    np.testing.assert_array_equal(tts.numpy(), np.asarray(jts))
    with pytest.raises(ValueError, match="eta > 0"):
        tldm.ddim_scan_ldm(lambda x_, t_, s: x_, tsched,
                           torch.from_numpy(x))
    with pytest.raises(ValueError, match="noise"):
        tldm.ddim_scan_ldm(lambda x_, t_, s: x_, tsched,
                           torch.from_numpy(x), noise=noise[:3])


def test_generate_cali_data_uncond_eta1_matches_jax():
    """The harvest of an unconditional task at eta 1 (lsun_beds256's
    sampler on a toy model, 4 steps, 3 samples in rollouts of 2): no CFG
    doubling, groups of n_per_t rows; the port is handed JAX's starting
    noise and its per-step draws (the keys of ptq.py:173-176)."""
    jt = dataclasses.replace(jtasks.get_task("lsun_beds256"), steps=4)
    tt = dataclasses.replace(ttasks.get_task("lsun_beds256"), steps=4)
    key = jax.random.PRNGKey(11)
    ws, x0s, noise = [], [], []
    k = key
    for b in (2, 1):
        k, k1, k2 = jax.random.split(k, 3)
        x0s.append(np.asarray(jax.random.normal(k1, (b, 64, 64, 3))))
        noise.append(_jax_step_noise(k2, 4, (b, 64, 64, 3)))
    jw, ja, jt_t = jptq.generate_cali_data(
        jt, lambda x, t, c: _toy_eps(jnp, x, t), key, n_per_t=3,
        rollout_batch=2)
    tw, ta, tt_t = tptq.generate_cali_data(
        tt, lambda x, t, c: _toy_eps(torch, x, t),
        torch.Generator().manual_seed(0), n_per_t=3, rollout_batch=2,
        noise=torch.from_numpy(np.concatenate(x0s)),
        step_noise=torch.from_numpy(np.concatenate(noise, axis=1)),
        device="cpu")
    np.testing.assert_array_equal(tt_t, jt_t)
    assert len(ta) == 2 and ta[0].shape == (4, 3, 64, 64, 3)
    for a, b in zip(ta + tw, ja + jw):
        assert_fp_close(a.numpy(), np.asarray(b))
