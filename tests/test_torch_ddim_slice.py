"""The port's DDIM w4a8 int4-serving slice against the JAX package, end to
end at the tiny config: weight grids, calibration harvest, FSC init pass,
a calibration artifact with AdaRound ``alpha``, int4-serving deployment
and 4 deployed DDIM steps.

The JAX side runs its kernel path: ``jax.default_backend`` reports "tpu"
(which only the two int4 dispatches, qfunc.py:54,114, consult on this
path; attention stays below the flash gate at T = 64) and Pallas runs in
interpret mode. The port runs on the CPU, where its kernels take their
plain versions (held against the Pallas kernels in
test_torch_int4_kernels.py).

Tolerances. Integer state is compared exactly: weight grids and the
deployed codes. Everything downstream of an activation quantizer is not:
the int4 path rounds activations to bf16 and to 8-bit codes, and an
f32 summation-order difference of one ulp flips a rounding now and then.
A flipped code moves that element by one grid step, and GroupNorm spreads
a small share of it over its group. Measured over three data seeds, the
sampled images differ by at most 4.4e-3 of their largest magnitude, on
average by 3.2e-3 of their mean magnitude, and 5-21% of elements by more
than 1e-3 of the largest magnitude; the limits below sit about 3x above.
The FSC grids, calibrated on data that already carries such flips,
differ by up to 3.3% in delta, and by one code in zero point at up to
13% of (site, group) pairs.
"""

import functools
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from tfmq_dm_tpu.models import ddim_unet as J
from tfmq_dm_tpu.models import ddim_units as JU
from tfmq_dm_tpu.quant import artifact as jart
from tfmq_dm_tpu.quant import deploy as jdep
from tfmq_dm_tpu.quant.fsc import fsc_calibrate as j_fsc
from tfmq_dm_tpu.quant.recon import init_weight_qparams as j_iwq
from tfmq_dm_tpu.samplers.ddim import generalized_scan as j_scan
from tfmq_dm_tpu.samplers.ddim import harvest_trajectory as j_harvest
from tfmq_dm_tpu.utils.schedules import get_beta_schedule, skip_seq
from tfmq_dm_tpu_torch.convert import params_from_numpy
from tfmq_dm_tpu_torch.models import ddim_unet as T
from tfmq_dm_tpu_torch.models import ddim_units as TU
from tfmq_dm_tpu_torch.ops.int4_kernels import unpack_int4
from tfmq_dm_tpu_torch.quant import deploy as tdep
from tfmq_dm_tpu_torch.quant.calibrate import load_cali_model
from tfmq_dm_tpu_torch.quant.fsc import fsc_calibrate as t_fsc
from tfmq_dm_tpu_torch.quant.recon import init_weight_qparams as t_iwq
from tfmq_dm_tpu_torch.samplers.ddim import generalized_scan as t_scan
from tfmq_dm_tpu_torch.samplers.ddim import harvest_trajectory as t_harvest

CFG = J.tiny_config()
BETAS = get_beta_schedule("linear", beta_start=1e-4, beta_end=0.02,
                          num_diffusion_timesteps=100)
SEQ = skip_seq("uniform", 100, 4)
BATCH = 8

IMG_MAX_REL = 1.5e-2      # max |diff| / max |ref|
IMG_MEAN_REL = 1e-2       # mean |diff| / mean |ref|
IMG_FLIP_SHARE = 0.6      # share of elements with |diff| > 1e-3 max|ref|
FSC_DELTA_REL = 0.1
FSC_ZP_EQUAL_SHARE = 0.75


def _jax_kernel_path():
    """JAX's int4 dispatch on its Pallas kernels, interpreted on the CPU."""
    stack = mock.patch.multiple(jax, default_backend=lambda: "tpu")
    interp = mock.patch.object(
        pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    return stack, interp


def _jax_layout_codes(packed, block_n: int) -> np.ndarray:
    """Codes of JAX's tile-concat packing (pallas_kernels.py:223-266),
    decoded in numpy: per block_n tile, low nibbles then high nibbles."""
    p = np.asarray(packed).astype(np.int32)
    half = block_n // 2
    tiles = []
    for j in range(p.shape[-1] // half):
        t = p[..., j * half:(j + 1) * half]
        tiles += [((t & 15) ^ 8) - 8, t >> 4]
    return np.concatenate(tiles, axis=-1)


def random_params(cfg, rng):
    """Random parameters in the JAX layout, drawn with numpy (the scale
    of ``ddim_unet.init_params``; norms get non-trivial affines)."""
    params = {}
    for kind, name, shape in J.iter_layers(cfg):
        if kind == "norm":
            params[name] = {
                "scale": (1 + 0.1 * rng.standard_normal(shape)
                          ).astype(np.float32),
                "bias": (0.1 * rng.standard_normal(shape)).astype(
                    np.float32)}
            continue
        bound = 1.0 / np.sqrt(np.prod(shape[:-1]))
        params[name] = {
            "w": rng.uniform(-bound, bound, shape).astype(np.float32),
            "b": rng.uniform(-bound, bound, shape[-1:]).astype(np.float32)}
    return params


@pytest.fixture(scope="module")
def slice_runs(tmp_path_factory):
    rng = np.random.default_rng(0)
    np_params = random_params(CFG, rng)
    jparams = jax.tree.map(jnp.asarray, np_params)
    tparams = params_from_numpy(np_params, "cpu")
    x_cali = rng.standard_normal((BATCH, 16, 16, 3)).astype(np.float32)
    x_T = rng.standard_normal((BATCH, 16, 16, 3)).astype(np.float32)

    # JAX: weight grids + synthetic AdaRound alpha (as reconstruction
    # would leave), harvest, FSC init, artifact, deploy, sample
    ja = JU.build_adapter(CFG, w_bits=4, a_bits=8)
    jw = j_iwq(ja.policy, jparams, scaler="minmax")
    alpha = {name: rng.standard_normal(np_params[name]["w"].shape)
             .astype(np.float32) for name in jw}
    for name in jw:
        jw[name]["alpha"] = jnp.asarray(alpha[name])
    xs, ts = j_harvest(lambda x, t, s: J.apply(jparams, CFG, x, t), BETAS,
                       SEQ, jnp.asarray(x_cali), jax.random.PRNGKey(2))
    jast = j_fsc(ja, jparams, jw, (xs, ts), jax.random.PRNGKey(3),
                 running_stat=False, init_samples=8, act_scaler="minmax")
    art = os.path.join(tmp_path_factory.mktemp("art"), "cali.npz")
    jart.save_artifact(art, jw, jast, {"wq": 4, "aq": 8})
    jd = jdep.deploy_weights(ja.policy, jparams, jw, int4_serving=True)
    jfn = jdep.make_deployed_model_fn(ja, jparams, jd, jast, use_aq=True)
    backend, interp = _jax_kernel_path()
    with backend, interp:
        jimg = np.asarray(j_scan(jfn, BETAS, SEQ, jnp.asarray(x_T)))

    # port, independently: the same steps from the same numpy inputs
    tcfg = T.tiny_config()
    ta = TU.build_adapter(tcfg, w_bits=4, a_bits=8)
    tw = t_iwq(ta.policy, tparams, scaler="minmax")
    for name in tw:
        tw[name]["alpha"] = torch.from_numpy(alpha[name])
    txs, tts = t_harvest(lambda x, t, s: T.apply(tparams, tcfg, x, t),
                         BETAS, SEQ, torch.from_numpy(x_cali))
    tast = t_fsc(ta, tparams, tw, (txs, tts), torch.Generator().manual_seed(3),
                 init_samples=8, act_scaler="minmax")
    td = tdep.deploy_weights(ta.policy, tparams, tw, int4_serving=True)
    tfn = tdep.make_deployed_model_fn(ta, tparams, td, tast, use_aq=True)
    timg = t_scan(tfn, BETAS, SEQ, torch.from_numpy(x_T)).numpy()

    # port, driven by the artifact JAX wrote
    aw, aast, meta = load_cali_model(art, device="cpu")
    ad = tdep.deploy_weights(ta.policy, tparams, aw, int4_serving=True)
    afn = tdep.make_deployed_model_fn(ta, tparams, ad, aast, use_aq=True)
    aimg = t_scan(afn, BETAS, SEQ, torch.from_numpy(x_T)).numpy()
    return dict(jw=jw, tw=tw, xs=np.asarray(xs), txs=txs.numpy(),
                jast=jast, tast=tast, jd=jd, td=td, ad=ad, meta=meta,
                jimg=jimg, timg=timg, aimg=aimg)


def test_weight_grids_bit_equal(slice_runs):
    jw, tw = slice_runs["jw"], slice_runs["tw"]
    assert set(jw) == set(tw)
    for name in jw:
        for f in ("delta", "zp"):
            np.testing.assert_array_equal(np.asarray(jw[name][f]),
                                          tw[name][f].numpy(), err_msg=name)


def test_harvest_matches(slice_runs):
    """FP rollout: f32 summation order only."""
    np.testing.assert_allclose(slice_runs["txs"], slice_runs["xs"],
                               rtol=1e-5, atol=1e-5)


def test_fsc_init_matches(slice_runs):
    jast, tast = slice_runs["jast"], slice_runs["tast"]
    assert set(jast) == set(tast)
    zp_equal = []
    for site in jast:
        d_j = np.asarray(jast[site]["delta"])
        d_t = tast[site]["delta"].numpy()
        assert d_t.shape == d_j.shape == (len(SEQ),)
        np.testing.assert_allclose(d_t, d_j, rtol=FSC_DELTA_REL,
                                   err_msg=site)
        dz = np.abs(tast[site]["zp"].numpy() - np.asarray(jast[site]["zp"]))
        assert dz.max() <= 2, site
        zp_equal.append(dz == 0)
    assert np.mean(zp_equal) >= FSC_ZP_EQUAL_SHARE


def test_jax_artifact_deploys_identically(slice_runs):
    """Codes (AdaRound-hardened), scales and zero points of every packed
    layer are equal; the layouts differ, so codes compare unpacked."""
    jd, ad = slice_runs["jd"], slice_runs["ad"]
    assert slice_runs["meta"]["wq"] == 4
    assert set(jd) == set(ad)
    kinds = {type(v).__name__ for v in ad.values()}
    assert kinds == {"Int4Weight", "Int4ConvWeight"}
    for name, jv in jd.items():
        av = ad[name]
        codes = _jax_layout_codes(jv.w_packed, jv.block_n)[..., :av.n]
        np.testing.assert_array_equal(unpack_int4(av.w_packed, av.n).numpy(),
                                      codes, err_msg=name)
        np.testing.assert_array_equal(av.delta.numpy(),
                                      np.asarray(jv.delta)[:av.n])
        np.testing.assert_array_equal(av.zp_c.numpy(),
                                      np.asarray(jv.zp_c)[:av.n])


def _assert_images_close(got, ref):
    assert got.shape == ref.shape and np.all(np.isfinite(got))
    d = np.abs(got - ref)
    scale = np.abs(ref).max()
    assert d.max() <= IMG_MAX_REL * scale
    assert d.mean() <= IMG_MEAN_REL * np.abs(ref).mean()
    assert (d > 1e-3 * scale).mean() <= IMG_FLIP_SHARE


def test_sampling_from_jax_artifact_matches(slice_runs):
    _assert_images_close(slice_runs["aimg"], slice_runs["jimg"])


def test_independent_slice_matches(slice_runs):
    _assert_images_close(slice_runs["timg"], slice_runs["jimg"])
