"""The port's class-conditional LDM w4a8 int4-serving slice against the JAX
package, end to end at ``tiny_cin``: a Lightning checkpoint written by the
JAX export, the calibration harvest with classifier-free guidance, minmax
weight grids, the FSC init pass, a calibration artifact (written by JAX,
with AdaRound ``alpha`` as reconstruction would leave it), the
int4-serving deployment, and a 4-step deployed sample through the port's
CLI (``cli.main``, on the CPU) from that checkpoint and artifact.

Flash attention is forced on both sides (``set_flash("on")``, as the CLI's
quantized contexts take it on the card): JAX runs its Pallas kernels in
interpret mode, the port its plain versions. The JAX reference sample
runs the JAX CLI's model function (cli.py:385-432) through its DDIM scan,
with the int4 layers on JAX's CPU dispatch (f32 dequantized weights);
test_torch_ldm_modules.py holds one deployed forward of the port against
JAX's interpreted int4 kernels.

Tolerances. Integer state is compared exactly: weight grids and the
deployed codes. The harvest is an FP rollout: f32 summation order only.
The FSC grids are calibrated on activations that carry 8-bit rounding
flips, as in the DDIM slice (tests/test_torch_ddim_slice.py): delta within
10%, zero points within 2 codes and equal at 75% of (site, group) pairs.
The deployed samples differ by the bf16 rounding of the int4 operands
(the port rounds as the TPU kernels; JAX's CPU dispatch keeps f32) and
by flipped codes downstream; the limits on the latents and the decoded
images are stated below, about 3x above what was measured on three data
seeds.
"""

import os

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
from tfmq_dm_tpu.quant import artifact as jart
from tfmq_dm_tpu.quant import deploy as jdep
from tfmq_dm_tpu.quant.context import QuantCtx as JCtx
from tfmq_dm_tpu.quant.fsc import fsc_calibrate as j_fsc
from tfmq_dm_tpu.quant.fsc import slice_fsc as j_slice
from tfmq_dm_tpu.quant.recon import init_weight_qparams as j_iwq
from tfmq_dm_tpu.samplers import ldm as jldm
from tfmq_dm_tpu.utils.torch_convert import export_state_dict as j_export
from tfmq_dm_tpu_torch import cli
from tfmq_dm_tpu_torch.configs import tasks as ttasks
from tfmq_dm_tpu_torch.models import ldm_unet as TL
from tfmq_dm_tpu_torch.models import ldm_units as TLU
from tfmq_dm_tpu_torch.ops import attention as t_attn
from tfmq_dm_tpu_torch.ops.int4_kernels import unpack_int4
from tfmq_dm_tpu_torch.pipelines import loading as tload
from tfmq_dm_tpu_torch.pipelines import ptq as tptq
from tfmq_dm_tpu_torch.quant import deploy as tdep
from tfmq_dm_tpu_torch.quant.calibrate import load_cali_model
from tfmq_dm_tpu_torch.quant.fsc import fsc_calibrate as t_fsc
from tfmq_dm_tpu_torch.quant.recon import init_weight_qparams as t_iwq

from test_torch_ddim_slice import _jax_layout_codes
from test_torch_ldm_modules import random_params

N, CLASSES, SCALE, SEED = 2, (3, 5), 3.0, 11
# measured on data seeds 11, 12, 13: latents max 1.0e-2 / 1.6e-2 / 1.2e-2,
# mean 1.0e-2 / 1.0e-2 / 0.9e-2; images mean 6.1e-3 / 1.7e-2 / 4.8e-7
LATENT_MAX_REL = 0.05     # max |diff| / max |ref| of the sampled latents
LATENT_MEAN_REL = 0.03    # mean |diff| / mean |ref|
IMG_MEAN_REL = 0.05       # decoded images: mean |diff| / mean |ref|
FSC_DELTA_REL = 0.1
FSC_ZP_EQUAL_SHARE = 0.75


def _jax_sample(task, jp, jv, emb, jw, jast, cali_t, x_T):
    """The JAX CLI's deployed class-conditional sampling (cli.py:385-432)
    through ``ddim_scan_ldm``, decoded by ``vae.decode``."""
    ja = JLU.build_adapter(task.unet, w_bits=4, a_bits=8, use_aq=True)
    jd = jdep.deploy_weights(ja.policy, jp, jw, int4_serving=True)
    sampler_fn, sample_t = jptq.make_schedule(task)
    gos = jldm.group_of_step_from_t(np.asarray(cali_t), sample_t)
    y = jnp.asarray(CLASSES, jnp.int32)
    ctx = emb[y][:, None, :]
    uc = emb[jnp.full((N,), emb.shape[0] - 1, jnp.int32)][:, None, :]

    def qctx(g):
        return JCtx(ja.policy, wstate={}, astate=j_slice(jast, g),
                    use_wq=True, use_aq=True, deploy=jd, flash=True)

    kv = JL.build_cross_kv(jp, task.unet, jnp.concatenate([uc, ctx]),
                           qctx=qctx(int(gos[0])))
    gos_a = jnp.asarray(gos, jnp.int32)

    def apply_fn(x, t, c, step):
        return JL.apply(jp, task.unet, x, t, context=c,
                        qctx=qctx(gos_a[step]), kv_cache=kv)

    model_fn = jldm.make_cfg_model_fn(apply_fn, ctx, uc, SCALE)
    z = jax.jit(lambda x: sampler_fn(model_fn, x, jax.random.PRNGKey(0)))(
        jnp.asarray(x_T))
    img = jnp.clip((JV.decode(jv, task.vae, z) + 1.0) / 2.0, 0.0, 1.0)
    return np.asarray(z), np.asarray(img)


@pytest.fixture(scope="module")
def slice_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cin")
    jtask, ttask = jtasks.get_task("tiny_cin"), ttasks.get_task("tiny_cin")
    rng = np.random.default_rng(SEED)
    up = random_params(JL.iter_layers(jtask.unet), rng)
    vp = random_params(JV.iter_layers(jtask.vae, encoder=False), rng)
    emb = rng.standard_normal((11, 16)).astype(np.float32)
    sd = {f"model.diffusion_model.{k}": torch.from_numpy(np.array(v))
          for k, v in j_export(up, JL.iter_layers(jtask.unet)).items()}
    sd.update({f"first_stage_model.{k}": torch.from_numpy(np.array(v))
               for k, v in j_export(
                   vp, JV.iter_layers(jtask.vae, encoder=False)).items()})
    sd["cond_stage_model.embedding.weight"] = torch.from_numpy(emb)
    ckpt = str(tmp / "tiny_cin.ckpt")
    torch.save({"state_dict": sd}, ckpt)

    j_attn.set_flash("on")
    t_attn.set_flash("on")
    try:
        # JAX: load, harvest (CFG, the port's starting noise), grids with
        # synthetic AdaRound alpha, FSC init, artifact, deployed sample
        jp, jv, jc = jload.load_ldm_checkpoint(ckpt, jtask)
        y = jnp.asarray(CLASSES, jnp.int32)
        jctx = jc["embedding"][y][:, None, :]
        juc = jc["embedding"][jnp.full((N,), 10, jnp.int32)][:, None, :]
        # the first draw of a generator seeded SEED: the port's harvest
        # and its CLI each start from it, so JAX is handed it for both
        x_T = torch.randn((N, 8, 8, 3), generator=torch.Generator()
                          .manual_seed(SEED)).numpy()
        ja = JLU.build_adapter(jtask.unet, w_bits=4, a_bits=8, use_aq=True)
        real_normal = jax.random.normal

        def cali_noise(key, shape, dtype=None):
            # the harvest's starting noise is drawn without a dtype
            # (ptq.py:185); the sampler's step noise passes one
            return jnp.asarray(x_T) if dtype is None else \
                real_normal(key, shape, dtype)

        jax.random.normal = cali_noise
        try:
            _, ja_cali, cali_t = jptq.generate_cali_data(
                jtask, lambda x, t, c: JL.apply(jp, jtask.unet, x, t,
                                                context=c),
                jax.random.PRNGKey(0), n_per_t=N, context=jctx,
                uncond=juc, cfg_scale=SCALE)
        finally:
            jax.random.normal = real_normal
        jw = j_iwq(ja.policy, jp, scaler="minmax")
        alpha = {n: rng.standard_normal(jp[n]["w"].shape).astype(np.float32)
                 for n in jw}
        for n in jw:
            jw[n]["alpha"] = jnp.asarray(alpha[n])
        jast = j_fsc(ja, jp, jw, ja_cali, jax.random.PRNGKey(1),
                     running_stat=False, init_samples=2 * N,
                     act_scaler="minmax")
        art = str(tmp / "cali.npz")
        jart.save_artifact(art, jw, jast, {
            "task": "tiny_cin", "wq": 4, "aq": 8, "softmax_a_bit": 8,
            "use_aq": True, "cali_t": [float(v) for v in cali_t]})
        jz, jimg = _jax_sample(jtask, jp, jv, jc["embedding"], jw, jast,
                               cali_t, x_T)
        jd = jdep.deploy_weights(ja.policy, jp, jw, int4_serving=True)

        # port, independently: harvest, grids, FSC from the same inputs
        tp, _, tc = tload.load_ldm_checkpoint(ckpt, ttask, device="cpu")
        ty = torch.tensor(CLASSES)
        tctx = tc["embedding"][ty][:, None, :]
        tuc = tc["embedding"][torch.full((N,), 10)][:, None, :]
        _, ta_cali, tcali_t = tptq.generate_cali_data(
            ttask, lambda x, t, c: TL.apply(tp, ttask.unet, x, t,
                                            context=c),
            torch.Generator().manual_seed(SEED), n_per_t=N, context=tctx,
            uncond=tuc, cfg_scale=SCALE, device="cpu")
        ta = TLU.build_adapter(ttask.unet, w_bits=4, a_bits=8, use_aq=True)
        tw = t_iwq(ta.policy, tp, scaler="minmax")
        for n in tw:
            tw[n]["alpha"] = torch.from_numpy(alpha[n])
        tast = t_fsc(ta, tp, tw, ta_cali, torch.Generator().manual_seed(1),
                     init_samples=2 * N, act_scaler="minmax")

        # port CLI, from the JAX checkpoint and the JAX artifact
        aw, _, _ = load_cali_model(art, device="cpu")
        ad = tdep.deploy_weights(ta.policy, tp, aw, int4_serving=True)
        out = str(tmp / "q")
        rc = cli.main(["--task", "tiny_cin", "--ckpt", ckpt, "--ptq",
                       "--cali_ckpt", art, "--use_aq", "--int-kernels",
                       "--int4-serving", "--classes",
                       ",".join(map(str, CLASSES)), "--scale", str(SCALE),
                       "-n", str(N), "--batch", str(N), "--seed",
                       str(SEED), "--device", "cpu", "--out", out])
    finally:
        j_attn.set_flash("auto")
        t_attn.set_flash("auto")
    return dict(rc=rc, jw=jw, tw=tw, ja_cali=ja_cali, ta_cali=ta_cali,
                cali_t=cali_t, tcali_t=tcali_t, jast=jast, tast=tast,
                jd=jd, ad=ad, jz=jz, jimg=jimg,
                tz=np.load(os.path.join(out, "latents.npy")),
                timg=np.load(os.path.join(out, "samples.npy")))


def test_weight_grids_bit_equal(slice_runs):
    jw, tw = slice_runs["jw"], slice_runs["tw"]
    assert set(jw) == set(tw)
    for name in jw:
        for f in ("delta", "zp"):
            np.testing.assert_array_equal(tw[name][f].numpy(),
                                          np.asarray(jw[name][f]),
                                          err_msg=name)


def test_harvest_matches(slice_runs):
    """FP rollouts with CFG, groups doubled [uncond; cond]."""
    np.testing.assert_array_equal(slice_runs["tcali_t"],
                                  slice_runs["cali_t"])
    for t, j in zip(slice_runs["ta_cali"], slice_runs["ja_cali"]):
        assert tuple(t.shape) == np.shape(j)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-5)


def test_fsc_init_matches(slice_runs):
    jast, tast = slice_runs["jast"], slice_runs["tast"]
    assert set(jast) == set(tast)
    zp_equal = []
    for site in jast:
        np.testing.assert_allclose(tast[site]["delta"].numpy(),
                                   np.asarray(jast[site]["delta"]),
                                   rtol=FSC_DELTA_REL, err_msg=site)
        dz = np.abs(tast[site]["zp"].numpy() - np.asarray(jast[site]["zp"]))
        assert dz.max() <= 2, site
        zp_equal.append(dz == 0)
    assert np.mean(zp_equal) >= FSC_ZP_EQUAL_SHARE


def test_jax_artifact_deploys_identically(slice_runs):
    jd, ad = slice_runs["jd"], slice_runs["ad"]
    assert set(jd) == set(ad)
    assert {type(v).__name__ for v in ad.values()} == \
        {"Int4Weight", "Int4ConvWeight"}
    for name, jv in jd.items():
        av = ad[name]
        codes = _jax_layout_codes(jv.w_packed, jv.block_n)[..., :av.n]
        np.testing.assert_array_equal(unpack_int4(av.w_packed, av.n).numpy(),
                                      codes, err_msg=name)
        np.testing.assert_array_equal(av.delta.numpy(),
                                      np.asarray(jv.delta)[:av.n])
        np.testing.assert_array_equal(av.zp_c.numpy(),
                                      np.asarray(jv.zp_c)[:av.n])


def test_cli_deployed_sample_matches_jax(slice_runs):
    """The port's CLI sample from the JAX checkpoint and artifact against
    the JAX deployed sample from the same noise."""
    assert slice_runs["rc"] == 0
    tz, jz = slice_runs["tz"], slice_runs["jz"]
    assert tz.shape == jz.shape == (N, 8, 8, 3) and np.all(np.isfinite(tz))
    d = np.abs(tz - jz)
    assert d.max() <= LATENT_MAX_REL * np.abs(jz).max()
    assert d.mean() <= LATENT_MEAN_REL * np.abs(jz).mean()
    timg, jimg = slice_runs["timg"], slice_runs["jimg"]
    assert timg.shape == jimg.shape == (N, 16, 16, 3)
    assert np.all(np.isfinite(timg)) and timg.min() >= 0 and timg.max() <= 1
    assert np.abs(timg - jimg).mean() <= IMG_MEAN_REL * np.abs(jimg).mean()
