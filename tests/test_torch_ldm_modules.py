"""Modules of the port's class-conditional LDM slice against the JAX
package on the same numpy inputs: the LDM UNet (FP, fake-quant and the
deployed packed-int4 model, with the cross-attention K/V hoist), the
VQ first-stage decoder, the LDM DDIM sampler with classifier-free
guidance, the calibration-data harvest of a class-conditioned task, and
the checkpoint round trip.

Flash attention is forced on both sides (``set_flash("on")``): the JAX
side runs its Pallas kernels in interpret mode, the port its plain
versions (the CPU tensors' dispatch). The deployed JAX model runs its CPU
dispatch (the packed int4 weights dequantized to f32, qfunc.py:62,129):
its Pallas int4 kernels take some 30 s per interpreted forward here, and
test_torch_int4_kernels.py already holds the port's int4 plain versions
against them.

Tolerances. FP forwards differ in f32 summation order only: 1e-5 of the
output's largest magnitude. The quantized forwards round activations to
8-bit codes, and an f32 summation-order difference flips a rounding now
and then; the deployed port also rounds the int4 operands to bf16 as the
TPU kernels do, where the JAX CPU dispatch keeps f32. The limits are
stated at each test, about 3x above what was measured on three data
seeds.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfmq_dm_tpu.configs import tasks as jtasks
from tfmq_dm_tpu.models import ldm_unet as JL
from tfmq_dm_tpu.models import ldm_units as JLU
from tfmq_dm_tpu.models import vae as JV
from tfmq_dm_tpu.ops import attention as j_attn
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
from tfmq_dm_tpu_torch.models import vae as TV
from tfmq_dm_tpu_torch.ops import attention as t_attn
from tfmq_dm_tpu_torch.pipelines import loading as tload
from tfmq_dm_tpu_torch.pipelines import ptq as tptq
from tfmq_dm_tpu_torch.quant import deploy as tdep
from tfmq_dm_tpu_torch.quant.context import QuantCtx as TCtx
from tfmq_dm_tpu_torch.quant.fsc import fsc_calibrate as t_fsc
from tfmq_dm_tpu_torch.samplers import ldm as tldm
from tfmq_dm_tpu_torch.utils.torch_convert import export_state_dict

FP_RTOL = 1e-5
SD_CFG = dict(context_dim=16)


def assert_fp_close(got, ref):
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, rtol=0, atol=FP_RTOL * scale)


def rel_err(got, ref):
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def random_params(layer_iter, rng):
    """Parameters in the JAX layout, drawn with numpy (the scale of the
    JAX init; norms get non-trivial affines)."""
    params = {}
    for kind, name, shape in layer_iter:
        if kind in ("norm", "lnorm"):
            params[name] = {
                "scale": (1 + 0.1 * rng.standard_normal(shape)
                          ).astype(np.float32),
                "bias": (0.1 * rng.standard_normal(shape)).astype(
                    np.float32)}
        elif kind == "embed":
            params[name] = {"w": rng.standard_normal(shape).astype(
                np.float32)}
        else:
            fan_in = shape[0] if kind in ("linear", "linear_nb", "conv1d") \
                else int(np.prod(shape[:-1]))
            bound = 1.0 / np.sqrt(fan_in)
            params[name] = {"w": rng.uniform(-bound, bound, shape).astype(
                np.float32)}
            if kind != "linear_nb":
                params[name]["b"] = rng.uniform(
                    -bound, bound, shape[-1:]).astype(np.float32)
    return params


@pytest.fixture
def flash_on():
    j_attn.set_flash("on")
    t_attn.set_flash("on")
    try:
        yield
    finally:
        j_attn.set_flash("auto")
        t_attn.set_flash("auto")


def tree_torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def unet_inputs(cfg, rng, b=2):
    x = rng.standard_normal((b, cfg.image_size, cfg.image_size,
                             cfg.in_channels)).astype(np.float32)
    t = np.array([37, 901][:b], np.int32)
    c = rng.standard_normal((b, 1, cfg.context_dim)).astype(np.float32) \
        if cfg.context_dim else None
    return x, t, c


# ---------------------------------------------------------------------------
# UNet
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cfg_fn,hoist", [
    (lambda: JL.tiny_sd_config(**SD_CFG), False),
    (lambda: JL.tiny_sd_config(**SD_CFG), True),
    (lambda: JL.tiny_ldm_config(), False),
    (lambda: JL.tiny_ldm_config(use_scale_shift_norm=True,
                                resblock_updown=True), False)])
def test_ldm_unet_fp_matches_jax(flash_on, cfg_fn, hoist):
    jcfg = cfg_fn()
    tcfg = TL.LDMUNetConfig(**jcfg.__dict__)
    rng = np.random.default_rng(1)
    np_p = random_params(JL.iter_layers(jcfg), rng)
    assert [n for _, n, _ in JL.iter_layers(jcfg)] == \
        [n for _, n, _ in TL.iter_layers(tcfg)]
    x, t, c = unet_inputs(jcfg, rng)
    jp, tp = jax.tree.map(jnp.asarray, np_p), params_from_numpy(np_p, "cpu")
    jc = None if c is None else jnp.asarray(c)
    tc = None if c is None else torch.from_numpy(c)
    jkv = JL.build_cross_kv(jp, jcfg, jc) if hoist else None
    tkv = TL.build_cross_kv(tp, tcfg, tc) if hoist else None
    ref = np.asarray(JL.apply(jp, jcfg, jnp.asarray(x), jnp.asarray(t),
                              context=jc, kv_cache=jkv))
    got = TL.apply(tp, tcfg, torch.from_numpy(x), torch.from_numpy(t),
                   context=tc, kv_cache=tkv).numpy()
    assert_fp_close(got, ref)


@pytest.fixture(scope="module")
def quant_setup(request):
    """Weights, minmax weight grids (the JAX package's), and FSC act grids
    of one timestep group (the port's init pass, which
    test_torch_ldm_slice.py holds against JAX's): one state feeds both."""
    jcfg = JL.tiny_sd_config(**SD_CFG)
    rng = np.random.default_rng(getattr(request, "param", 2))
    np_p = random_params(JL.iter_layers(jcfg), rng)
    jp = jax.tree.map(jnp.asarray, np_p)
    ja = JLU.build_adapter(jcfg, w_bits=4, a_bits=8, use_aq=True)
    jw = j_iwq(ja.policy, jp, scaler="minmax")
    x, t, c = unet_inputs(jcfg, rng, b=2)
    ta = TLU.build_adapter(TL.tiny_sd_config(**SD_CFG), w_bits=4, a_bits=8,
                           use_aq=True)
    tast = t_fsc(ta, params_from_numpy(np_p, "cpu"), tree_torch(jw),
                 tuple(torch.from_numpy(a)[None] for a in (x, t, c)),
                 torch.Generator().manual_seed(0), init_samples=2,
                 act_scaler="minmax")
    jast = jax.tree.map(lambda a: jnp.asarray(a[0].numpy()), tast)
    return dict(jcfg=jcfg, np_p=np_p, jp=jp, ja=ja, jw=jw, jast=jast,
                inputs=unet_inputs(jcfg, np.random.default_rng(3)))


def _both_forwards(qs, deploy):
    jcfg, jp, ja = qs["jcfg"], qs["jp"], qs["ja"]
    tcfg = TL.tiny_sd_config(**SD_CFG)
    tp = params_from_numpy(qs["np_p"], "cpu")
    ta = TLU.build_adapter(tcfg, w_bits=4, a_bits=8, use_aq=True)
    tw, tast = tree_torch(qs["jw"]), tree_torch(qs["jast"])
    x, t, c = qs["inputs"]
    if deploy:
        jd = jdep.deploy_weights(ja.policy, jp, qs["jw"], int4_serving=True)
        td = tdep.deploy_weights(ta.policy, tp, tw, int4_serving=True)
        jctx = JCtx(ja.policy, astate=qs["jast"], use_wq=True, use_aq=True,
                    deploy=jd, flash=True)
        tctx = TCtx(ta.policy, astate=tast, use_wq=True, use_aq=True,
                    deploy=td, flash=True)
    else:
        jctx = JCtx(ja.policy, wstate=qs["jw"], astate=qs["jast"],
                    use_wq=True, use_aq=True, flash=True)
        tctx = TCtx(ta.policy, wstate=tw, astate=tast, use_wq=True,
                    use_aq=True, flash=True)
    jkv = JL.build_cross_kv(jp, jcfg, jnp.asarray(c), qctx=jctx)
    ref = np.asarray(JL.apply(jp, jcfg, jnp.asarray(x), jnp.asarray(t),
                              context=jnp.asarray(c), qctx=jctx,
                              kv_cache=jkv))
    tkv = TL.build_cross_kv(tp, tcfg, torch.from_numpy(c), qctx=tctx)
    got = TL.apply(tp, tcfg, torch.from_numpy(x), torch.from_numpy(t),
                   context=torch.from_numpy(c), qctx=tctx,
                   kv_cache=tkv).numpy()
    return got, ref


def test_ldm_unet_fake_quant_matches_jax(flash_on, quant_setup):
    """Fake-quant w4a8 (flash mode int8 in attention): within 5e-2 of the
    output's largest magnitude (measured 4.7e-7, 6.8e-7 and, with one
    flipped code, 1.7e-2 on three seeds)."""
    got, ref = _both_forwards(quant_setup, deploy=False)
    assert np.all(np.isfinite(got))
    assert rel_err(got, ref) <= 5e-2


def test_ldm_unet_deployed_int4_matches_jax(flash_on, quant_setup):
    """Deployed packed-int4 w4a8 (int4 conv/linear plain versions, flash
    int8) against JAX's f32 CPU dispatch: within 0.1 of the output's
    largest magnitude (measured 2.7e-2 to 3.3e-2 on three seeds: the port
    rounds the int4 operands to bf16 as the TPU kernels do, JAX's CPU
    dispatch does not)."""
    got, ref = _both_forwards(quant_setup, deploy=True)
    assert np.all(np.isfinite(got))
    assert rel_err(got, ref) <= 0.1


# ---------------------------------------------------------------------------
# first stage, sampler, harvest
# ---------------------------------------------------------------------------

def test_vae_decode_matches_jax():
    jcfg = JV.tiny_vae_config()
    tcfg = TV.tiny_vae_config()
    rng = np.random.default_rng(4)
    np_p = random_params(JV.iter_layers(jcfg, encoder=False), rng)
    assert [n for _, n, _ in JV.iter_layers(jcfg, encoder=False)] == \
        [n for _, n, _ in TV.iter_layers(tcfg)]
    z = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
    ref = np.asarray(JV.decode(jax.tree.map(jnp.asarray, np_p), jcfg,
                               jnp.asarray(z)))
    got = TV.decode(params_from_numpy(np_p, "cpu"), tcfg,
                    torch.from_numpy(z)).numpy()
    assert got.shape == (2, 16, 16, 3)
    assert_fp_close(got, ref)


def _toy_eps(lib, x, t, c):
    """A cheap conditioned eps model written for both frameworks."""
    tt = lib.reshape(t, (-1, 1, 1, 1)).astype("float32") \
        if lib is jnp else t.float().reshape(-1, 1, 1, 1)
    cm = c.mean(axis=(1, 2)) if lib is jnp else c.mean(dim=(1, 2))
    return lib.tanh(0.7 * x + 1e-3 * tt + cm.reshape(-1, 1, 1, 1))


@pytest.mark.parametrize("eta", [0.0])
def test_ddim_scan_ldm_with_cfg_matches_jax(eta):
    task = jtasks.get_task("tiny_cin")
    ac = np.cumprod(1.0 - jtasks.task_betas(task))
    jsched = jldm.DDIMScheduleLDM(
        ac, jldm.make_ddim_timesteps(4, task.num_timesteps), eta=eta)
    tsched = tldm.DDIMScheduleLDM(
        ac, tldm.make_ddim_timesteps(4, task.num_timesteps), eta=eta)
    np.testing.assert_array_equal(tsched.t, jsched.t)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
    c = rng.standard_normal((2, 1, 16)).astype(np.float32)
    uc = rng.standard_normal((2, 1, 16)).astype(np.float32)
    jfn = jldm.make_cfg_model_fn(
        lambda x_, t_, c_, s: _toy_eps(jnp, x_, t_, c_), jnp.asarray(c),
        jnp.asarray(uc), 3.0)
    tfn = tldm.make_cfg_model_fn(
        lambda x_, t_, c_, s: _toy_eps(torch, x_, t_, c_),
        torch.from_numpy(c), torch.from_numpy(uc), 3.0)
    jx, (jxs, jts) = jldm.ddim_scan_ldm(jfn, jsched, jnp.asarray(x),
                                        collect="traj")
    tx, (txs, tts) = tldm.ddim_scan_ldm(tfn, tsched, torch.from_numpy(x),
                                        collect="traj")
    assert_fp_close(tx.numpy(), np.asarray(jx))
    assert_fp_close(txs.numpy(), np.asarray(jxs))
    np.testing.assert_array_equal(tts.numpy(), np.asarray(jts))


def test_generate_cali_data_class_cond_matches_jax():
    """Rollouts with CFG, groups doubled [uncond; cond]; the JAX side is
    handed the port's starting noise."""
    jtask, ttask = jtasks.get_task("tiny_cin"), ttasks.get_task("tiny_cin")
    rng = np.random.default_rng(6)
    ctx = rng.standard_normal((3, 1, 16)).astype(np.float32)
    uc = rng.standard_normal((3, 1, 16)).astype(np.float32)
    g = torch.Generator().manual_seed(7)
    noise = iter([torch.randn((2, 8, 8, 3), generator=g).numpy(),
                  torch.randn((1, 8, 8, 3), generator=g).numpy()])
    real_normal = jax.random.normal

    def fake_normal(key, shape, dtype=None):
        # the starting noise is drawn without a dtype (ptq.py:185); the
        # sampler's step noise (times sigma = 0) passes one
        if dtype is None:
            return jnp.asarray(next(noise))
        return real_normal(key, shape, dtype)

    with mock.patch.object(jax.random, "normal", fake_normal):
        jw, ja, jt = jptq.generate_cali_data(
            jtask, lambda x, t, c: _toy_eps(jnp, x, t, c),
            jax.random.PRNGKey(0), n_per_t=3, context=jnp.asarray(ctx),
            uncond=jnp.asarray(uc), rollout_batch=2)
    tw, ta, tt = tptq.generate_cali_data(
        ttask, lambda x, t, c: _toy_eps(torch, x, t, c),
        torch.Generator().manual_seed(7), n_per_t=3,
        context=torch.from_numpy(ctx), uncond=torch.from_numpy(uc),
        rollout_batch=2, device="cpu")
    np.testing.assert_array_equal(tt, jt)
    assert ta[0].shape == (4, 6, 8, 8, 3) and ta[2].shape == (4, 6, 1, 16)
    for a, b in zip(ta, ja):
        assert_fp_close(a.numpy(), np.asarray(b))
    for a, b in zip(tw, jw):
        assert_fp_close(a.numpy(), np.asarray(b))


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_checkpoint_round_trip(tmp_path):
    """A tiny_cin checkpoint written by the JAX export (Lightning layout,
    with LitEma weights) loads into equal tensors through both loaders,
    and the port's export writes the JAX export's tensors."""
    task = jtasks.get_task("tiny_cin")
    rng = np.random.default_rng(8)
    up = random_params(JL.iter_layers(task.unet), rng)
    vp = random_params(JV.iter_layers(task.vae, encoder=False), rng)
    usd = j_export(up, JL.iter_layers(task.unet))
    sd = {f"model.diffusion_model.{k}": torch.from_numpy(np.array(v))
          for k, v in usd.items()}
    sd.update({f"first_stage_model.{k}": torch.from_numpy(np.array(v))
               for k, v in j_export(
                   vp, JV.iter_layers(task.vae, encoder=False)).items()})
    emb = rng.standard_normal((11, 16)).astype(np.float32)
    sd["cond_stage_model.embedding.weight"] = torch.from_numpy(emb)
    ema_key = "input_blocks.0.0.weight"
    sd["model_ema.diffusion_model" + ema_key.replace(".", "")] = \
        torch.from_numpy(np.array(usd[ema_key]) + 1.0)
    path = str(tmp_path / "tiny_cin.ckpt")
    torch.save({"state_dict": sd}, path)

    for use_ema in (False, True):
        ju, jv, jc = jload.load_ldm_checkpoint(path, task, use_ema=use_ema)
        tu, tv, tc = tload.load_ldm_checkpoint(
            path, ttasks.get_task("tiny_cin"), use_ema=use_ema,
            device="cpu")
        for jtree, ttree in ((ju, tu), (jv, tv)):
            assert set(jtree) == set(ttree)
            for name in jtree:
                for f in jtree[name]:
                    np.testing.assert_array_equal(
                        ttree[name][f].numpy(), np.asarray(jtree[name][f]),
                        err_msg=name)
        np.testing.assert_array_equal(tc["embedding"].numpy(),
                                      np.asarray(jc["embedding"]))
    tsd = export_state_dict(params_from_numpy(up, "cpu"),
                            TL.iter_layers(ttasks.get_task("tiny_cin").unet))
    assert set(tsd) == set(usd)
    for k in usd:
        np.testing.assert_array_equal(tsd[k].numpy(), np.asarray(usd[k]))


# ---------------------------------------------------------------------------
# the CLI's checks
# ---------------------------------------------------------------------------

def test_cli_ldm_checks(tmp_path):
    """The CLI runs on the card unless asked for the CPU, and refuses an
    artifact calibrated with another softmax width."""
    from tfmq_dm_tpu_torch import cli
    from tfmq_dm_tpu_torch.quant.artifact import save_artifact
    task = ttasks.get_task("tiny_cin")
    g = torch.Generator().manual_seed(0)
    sd = {f"model.diffusion_model.{k}": v for k, v in export_state_dict(
        TL.init_params(g, task.unet), TL.iter_layers(task.unet)).items()}
    sd.update({f"first_stage_model.{k}": v for k, v in export_state_dict(
        TV.init_params(g, task.vae), TV.iter_layers(task.vae)).items()})
    sd["cond_stage_model.embedding.weight"] = torch.randn(11, 16)
    ckpt = str(tmp_path / "tiny_cin.ckpt")
    torch.save({"state_dict": sd}, ckpt)
    art = str(tmp_path / "cali.npz")
    save_artifact(art, {}, None, {"wq": 4, "aq": 8, "softmax_a_bit": 16})
    common = ["--task", "tiny_cin", "--ckpt", ckpt, "-n", "1", "--batch",
              "1", "--out", str(tmp_path / "o")]
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="cuda"):
            cli.main(common)
    with pytest.raises(SystemExit, match="softmax_a_bit 16"):
        cli.main(common + ["--device", "cpu", "--ptq", "--cali_ckpt", art])
    assert cli.main(common + ["--device", "cpu", "--timesteps", "2"]) == 0
    assert np.load(tmp_path / "o" / "samples.npy").shape == (1, 16, 16, 3)
    assert np.load(tmp_path / "o" / "latents.npy").shape == (1, 8, 8, 3)
