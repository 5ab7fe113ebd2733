"""The port's int8 and bf16 deployments against the JAX package, whole
samples at tiny widths on the CPU, from checkpoints and calibration
artifacts that JAX writes:

- ``tiny_cin`` with ``--int-kernels --deploy_dtype bfloat16`` (the fast
  deploy: int8 codes, bf16 carriers, flash mode fqk) through the port's
  CLI, against the JAX CLI's model function (cli.py:343-432);
- ``tiny_ddim`` in ``bench.py``'s configuration (w4a8, symmetric weight
  grids, int8 deploy, ``specialize_maps``, bf16 carriers) and
- ``tiny_ddim`` exact w8a8 (f32 carriers, AdaRound ``alpha``), both
  through the port's CLI, against JAX's ``make_deployed_model_fn``;
- one ``tiny_ddim`` forward with ``--int4-serving --deploy_dtype
  bfloat16`` (packed 4-bit weights, bf16 carriers), whole and layer by
  layer.

Flash attention is forced on for tiny_cin on both sides (``set_flash
("on")``, as the quantized contexts take it on the card; JAX interprets
its Pallas kernels); tiny DDIM's attention (T 64) stays materialized, as
on the card.

Tolerances. Integer state is compared exactly: deployed codes, weight
sums, scales and border maps. Everything downstream of an activation
quantizer is not: the JAX reference runs its compiled sampler (no excess
precision, so bf16 intermediates round as in the port; the weight-only
4-bit linears on the interpreted Pallas int4 kernel, whose rounding the
port's ``int4_linear`` follows), and the two differ in the order of f32
sums (GroupNorm statistics, products, XLA's fusions), which flips an
8-bit code or a bf16 rounding now and then; the random-init models spread
a flip. One deployed tiny_cin bf16 forward was measured bit-equal to JAX
op by op. Measured over data seeds 7-10: tiny DDIM images, bench
configuration max 5.7e-3..1.2e-2 / mean 0.7e-3..1.9e-3 of their largest /
mean magnitude, w8a8 max 5.7e-3..9.2e-3 / mean 0.8e-3..1.1e-3; tiny_cin
latents max 1e-7..1.1e-2 / mean 3e-8..5.4e-3, decoded images mean
<= 5.0e-7. The limits below sit about 3x above.
"""

import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from tfmq_dm_tpu.configs import tasks as jtasks
from tfmq_dm_tpu.models import ddim_unet as J
from tfmq_dm_tpu.models import ddim_units as JU
from tfmq_dm_tpu.models import ldm_unet as JL
from tfmq_dm_tpu.models import ldm_units as JLU
from tfmq_dm_tpu.models import vae as JV
from tfmq_dm_tpu.ops import attention as j_attn
from tfmq_dm_tpu.ops import int_ops as jio
from tfmq_dm_tpu.pipelines import loading as jload
from tfmq_dm_tpu.pipelines import ptq as jptq
from tfmq_dm_tpu.pipelines.training import save_params
from tfmq_dm_tpu.quant import artifact as jart
from tfmq_dm_tpu.quant import deploy as jdep
from tfmq_dm_tpu.quant.context import QuantCtx as JCtx
from tfmq_dm_tpu.quant import qfunc as jqf
from tfmq_dm_tpu.quant.fsc import fsc_calibrate as j_fsc
from tfmq_dm_tpu.quant.fsc import slice_fsc as j_slice
from tfmq_dm_tpu.quant.recon import init_weight_qparams as j_iwq
from tfmq_dm_tpu.samplers import ldm as jldm
from tfmq_dm_tpu.samplers.ddim import harvest_trajectory as j_harvest
from tfmq_dm_tpu.utils.torch_convert import export_state_dict as j_export
from tfmq_dm_tpu_torch import cli
from tfmq_dm_tpu_torch.configs import tasks as ttasks
from tfmq_dm_tpu_torch.convert import params_from_numpy
from tfmq_dm_tpu_torch.models import ddim_units as TU
from tfmq_dm_tpu_torch.ops import attention as t_attn
from tfmq_dm_tpu_torch.ops import int_ops as tio
from tfmq_dm_tpu_torch.quant import deploy as tdep
from tfmq_dm_tpu_torch.quant import qfunc as tqf
from tfmq_dm_tpu_torch.quant.calibrate import load_cali_model

from test_torch_ddim_slice import random_params as ddim_random_params
from test_torch_ldm_modules import random_params

B, SEED = 4, 7
IMG_MAX_REL, IMG_MEAN_REL = 3e-2, 5e-3           # tiny DDIM images
CIN_LAT_MAX_REL, CIN_LAT_MEAN_REL = 3e-2, 1.5e-2  # tiny_cin latents
CIN_IMG_MEAN_REL = 2e-6                           # tiny_cin images
INT4_MAX_REL, INT4_MEAN_REL = 6e-2, 4e-2          # int4-serving forward
INT4_LAYER_ABS, INT4_LAYER_EQ = 1e-6, 0.999        # int4-serving layers
N, CLASSES, SCALE = 2, (3, 5), 3.0

# (name, weight bits, symmetric weight grids, AdaRound alpha, carrier)
DDIM_CONFIGS = [("bench", 4, True, False, "bfloat16"),
                ("w8a8", 8, False, True, "float32")]


def _jax_kernel_run(fn, x):
    """``fn(x)`` on JAX's kernel path, compiled with
    ``xla_allow_excess_precision`` off so that XLA rounds every bf16
    intermediate as the port does. The kernel path: ``default_backend``
    reports "tpu", which only the packed-int4 dispatches of the
    weight-only linears consult here (qfunc.py:113-114; the port's
    ``int4_linear`` rounds as that Pallas kernel does), and every Pallas
    call runs in interpret mode."""
    real = pl.pallas_call

    def interpreted(*a, **k):
        return real(*a, **{**k, "interpret": True})

    x = jnp.asarray(x)
    with mock.patch.object(jax, "default_backend", lambda: "tpu"), \
            mock.patch.object(pl, "pallas_call", interpreted):
        return jax.jit(fn).lower(x).compile(
            {"xla_allow_excess_precision": False})(x)


def _noise(shape, seed):
    """The CLI's first draw from a generator seeded ``seed``."""
    return torch.randn(shape, generator=torch.Generator()
                       .manual_seed(seed)).numpy()


def _ddim_run(tmp, seed, name, wq, sym, alpha, dtype):
    jtask = jtasks.get_task("tiny_ddim")
    cfg = jtask.unet
    rng = np.random.default_rng(seed)
    np_params = ddim_random_params(cfg, rng)
    ckpt = str(tmp / f"{name}.npz")
    save_params(ckpt, np_params)
    jparams = jax.tree.map(jnp.asarray, np_params)
    ja = JU.build_adapter(cfg, w_bits=wq, a_bits=8, w_sym=sym)
    jw = j_iwq(ja.policy, jparams, scaler="minmax")
    if alpha:
        for n in jw:
            jw[n]["alpha"] = jnp.asarray(rng.standard_normal(
                np_params[n]["w"].shape).astype(np.float32))
    sampler_fn, cali_t = jptq.make_schedule(jtask)
    x_cali = rng.standard_normal((B, 16, 16, 3)).astype(np.float32)
    xs, ts = j_harvest(lambda x, t, s: J.apply(jparams, cfg, x, t),
                       jtasks.task_betas(jtask),
                       np.asarray(cali_t)[::-1], jnp.asarray(x_cali),
                       jax.random.PRNGKey(2))
    jast = j_fsc(ja, jparams, jw, (xs, ts), jax.random.PRNGKey(3),
                 running_stat=False, init_samples=B, act_scaler="minmax")
    art = str(tmp / f"{name}_cali.npz")
    jart.save_artifact(art, jw, jast, {"wq": wq, "aq": 8})

    # JAX: bench.py's / the exact deployment
    jd = jdep.deploy_weights(ja.policy, jparams, jw)
    jd = jdep.specialize_maps(ja, jparams, jd, example_args=(
        jnp.zeros((1, 16, 16, 3)), jnp.zeros((1,), jnp.int32)))
    act = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jp = jdep.cast_fp_params(jparams) if dtype == "bfloat16" else jparams
    jfn = jdep.make_deployed_model_fn(ja, jp, jd, jast, use_aq=True,
                                      act_dtype=act)
    x_T = _noise((B, 16, 16, 3), seed)
    z = _jax_kernel_run(
        lambda x: sampler_fn(jfn, x, jax.random.PRNGKey(0)), x_T)
    jimg = np.asarray(jnp.clip((z + 1.0) / 2.0, 0.0, 1.0))

    # port: the deployment of the same artifact, and the CLI's sample
    tparams = params_from_numpy(np_params, "cpu")
    ta = TU.build_adapter(ttasks.get_task("tiny_ddim").unet, w_bits=wq,
                          a_bits=8, w_sym=sym)
    aw, _, _ = load_cali_model(art, device="cpu")
    td = tdep.deploy_weights(ta.policy, tparams, aw)
    td = tdep.specialize_maps(ta, tparams, td, example_args=(
        torch.zeros((1, 16, 16, 3)), torch.zeros((1,), dtype=torch.int32)))
    out = str(tmp / name)
    argv = ["--task", "tiny_ddim", "--ckpt", ckpt, "--ptq", "--cali_ckpt",
            art, "--use_aq", "--int-kernels", "--wq", str(wq), "--aq", "8",
            "--deploy_dtype", dtype, "-n", str(B), "--batch", str(B),
            "--seed", str(seed), "--device", "cpu", "--out", out]
    rc = cli.main(argv + (["--w_sym"] if sym else []))
    return dict(rc=rc, jd=jd, td=td, jimg=jimg,
                timg=np.load(os.path.join(out, "samples.npy")),
                np_params=np_params, jw=jw, jast=jast, art=art)


@pytest.fixture(scope="module")
def ddim_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ddim_deploy")
    return {c[0]: _ddim_run(tmp, SEED, *c) for c in DDIM_CONFIGS}


def _assert_int_state_equal(jd, td):
    assert set(jd) == set(td)
    n_maps = 0
    for name, jv in jd.items():
        tv = td[name]
        assert type(tv).__name__ == type(jv).__name__, name
        if not isinstance(jv, jio.IntWeight):
            continue
        assert isinstance(tv, tio.IntWeight) and tv.sym == jv.sym
        np.testing.assert_array_equal(tv.w_q.numpy(), np.asarray(jv.w_q),
                                      err_msg=name)
        np.testing.assert_array_equal(tv.wsum.numpy(), np.asarray(jv.wsum))
        np.testing.assert_array_equal(tv.delta.numpy(), np.asarray(jv.delta))
        np.testing.assert_array_equal(tv.zp_c.numpy(), np.asarray(jv.zp_c))
        for f in ("w_map", "v_map"):
            a, b = getattr(tv, f), getattr(jv, f)
            assert (a is None) == (b is None), (name, f)
            if a is not None:
                n_maps += 1
                np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                              err_msg=f"{name}.{f}")
    assert n_maps > 0


@pytest.mark.parametrize("config", [c[0] for c in DDIM_CONFIGS])
def test_ddim_deployed_state_bit_equal(ddim_runs, config):
    """Codes, weight sums, scales and the specialized border maps."""
    _assert_int_state_equal(ddim_runs[config]["jd"], ddim_runs[config]["td"])


@pytest.mark.parametrize("config", [c[0] for c in DDIM_CONFIGS])
def test_ddim_deployed_kmajor_copy_matches_jax(ddim_runs, config):
    """Each int8 weight's K-major copy, the layout the int8 GEMM reads, is
    JAX's deployed codes w_q flattened to (K, N), transposed and
    zero-padded to a multiple of 16."""
    jd, td = ddim_runs[config]["jd"], ddim_runs[config]["td"]
    n = 0
    for name, jv in jd.items():
        if not isinstance(jv, jio.IntWeight):
            continue
        w2 = np.asarray(jv.w_q).reshape(-1, np.asarray(jv.w_q).shape[-1])
        want = np.zeros((w2.shape[1], -(-w2.shape[0] // 16) * 16), np.int8)
        want[:, :w2.shape[0]] = w2.T
        np.testing.assert_array_equal(td[name].w_t.numpy(), want,
                                      err_msg=name)
        n += 1
    assert n > 0


@pytest.mark.parametrize("config", [c[0] for c in DDIM_CONFIGS])
def test_ddim_cli_sample_matches_jax(ddim_runs, config):
    run = ddim_runs[config]
    assert run["rc"] == 0
    timg, jimg = run["timg"], run["jimg"]
    assert timg.shape == jimg.shape == (B, 16, 16, 3)
    assert np.all(np.isfinite(timg))
    d = np.abs(timg - jimg)
    assert d.max() <= IMG_MAX_REL * np.abs(jimg).max()
    assert d.mean() <= IMG_MEAN_REL * np.abs(jimg).mean()


def _jax_cin_sample(task, jp, jv, emb, jw, jast, cali_t, x_T):
    """The JAX CLI's ``--int-kernels --deploy_dtype bfloat16`` sampling
    (cli.py:343-432): int8 deploy, border maps, bf16 FP parameters, the
    deployed K/V cache context and the per-step contexts with bf16
    carriers, through ``ddim_scan_ldm``, decoded by ``vae.decode``."""
    ja = JLU.build_adapter(task.unet, w_bits=4, a_bits=8, use_aq=True)
    y = jnp.asarray(CLASSES, jnp.int32)
    ctx = emb[y][:, None, :]
    uc = emb[jnp.full((N,), emb.shape[0] - 1, jnp.int32)][:, None, :]
    jd = jdep.deploy_weights(ja.policy, jp, jw)
    res = task.unet.image_size
    jd = jdep.specialize_maps(ja, jp, jd, example_args=(
        jnp.zeros((1, res, res, task.unet.in_channels)),
        jnp.zeros((1,), jnp.int32), ctx[:1]))
    jpc = jdep.cast_fp_params(jp)
    sampler_fn, sample_t = jptq.make_schedule(task)
    gos = jldm.group_of_step_from_t(np.asarray(cali_t), sample_t)

    def qctx(g):
        return JCtx(ja.policy, wstate={}, astate=j_slice(jast, g),
                    use_wq=True, use_aq=True, deploy=jd, flash=True,
                    act_out_dtype=jnp.bfloat16)

    kv = JL.build_cross_kv(jpc, task.unet, jnp.concatenate([uc, ctx]),
                           qctx=qctx(int(gos[0])))
    gos_a = jnp.asarray(gos, jnp.int32)

    def apply_fn(x, t, c, step):
        return JL.apply(jpc, task.unet, x, t, context=c,
                        qctx=qctx(gos_a[step]), kv_cache=kv)

    model_fn = jldm.make_cfg_model_fn(apply_fn, ctx, uc, SCALE)
    z = _jax_kernel_run(
        lambda x: sampler_fn(model_fn, x, jax.random.PRNGKey(0)), x_T)
    img = jnp.clip((JV.decode(jv, task.vae, z) + 1.0) / 2.0, 0.0, 1.0)
    return jd, np.asarray(z), np.asarray(img)


@pytest.fixture(scope="module")
def cin_run(tmp_path_factory):
    return _cin_run(tmp_path_factory.mktemp("cin_deploy"), SEED)


def _cin_run(tmp, seed):
    jtask = jtasks.get_task("tiny_cin")
    rng = np.random.default_rng(seed)
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
        jp, jv, jc = jload.load_ldm_checkpoint(ckpt, jtask)
        y = jnp.asarray(CLASSES, jnp.int32)
        jctx = jc["embedding"][y][:, None, :]
        juc = jc["embedding"][jnp.full((N,), 10, jnp.int32)][:, None, :]
        ja = JLU.build_adapter(jtask.unet, w_bits=4, a_bits=8, use_aq=True)
        _, ja_cali, cali_t = jptq.generate_cali_data(
            jtask, lambda x, t, c: JL.apply(jp, jtask.unet, x, t,
                                            context=c),
            jax.random.PRNGKey(0), n_per_t=N, context=jctx, uncond=juc,
            cfg_scale=SCALE)
        jw = j_iwq(ja.policy, jp, scaler="minmax")
        jast = j_fsc(ja, jp, jw, ja_cali, jax.random.PRNGKey(1),
                     running_stat=False, init_samples=2 * N,
                     act_scaler="minmax")
        art = str(tmp / "cali.npz")
        jart.save_artifact(art, jw, jast, {
            "task": "tiny_cin", "wq": 4, "aq": 8, "softmax_a_bit": 8,
            "use_aq": True, "cali_t": [float(v) for v in cali_t]})
        x_T = _noise((N, 8, 8, 3), seed)
        jd, jz, jimg = _jax_cin_sample(jtask, jp, jv, jc["embedding"], jw,
                                       jast, cali_t, x_T)
        out = str(tmp / "q")
        rc = cli.main(["--task", "tiny_cin", "--ckpt", ckpt, "--ptq",
                       "--cali_ckpt", art, "--use_aq", "--int-kernels",
                       "--deploy_dtype", "bfloat16", "--classes",
                       ",".join(map(str, CLASSES)), "--scale", str(SCALE),
                       "-n", str(N), "--batch", str(N), "--seed",
                       str(seed), "--device", "cpu", "--out", out])
    finally:
        j_attn.set_flash("auto")
        t_attn.set_flash("auto")
    return dict(rc=rc, jd=jd, jz=jz, jimg=jimg,
                tz=np.load(os.path.join(out, "latents.npy")),
                timg=np.load(os.path.join(out, "samples.npy")))


def test_cin_fast_deploy_cli_matches_jax(cin_run):
    """tiny_cin ``--int-kernels --deploy_dtype bfloat16`` through the
    port's CLI against the JAX CLI's sampling, from the same checkpoint,
    artifact and noise."""
    assert cin_run["rc"] == 0
    tz, jz = cin_run["tz"], cin_run["jz"]
    assert tz.shape == jz.shape == (N, 8, 8, 3) and np.all(np.isfinite(tz))
    d = np.abs(tz - jz)
    assert d.max() <= CIN_LAT_MAX_REL * np.abs(jz).max()
    assert d.mean() <= CIN_LAT_MEAN_REL * np.abs(jz).mean()
    timg, jimg = cin_run["timg"], cin_run["jimg"]
    assert timg.shape == jimg.shape == (N, 16, 16, 3)
    assert np.all(np.isfinite(timg)) and timg.min() >= 0 and timg.max() <= 1
    assert np.abs(timg - jimg).mean() <= CIN_IMG_MEAN_REL * np.abs(jimg).mean()


def test_cli_parses_the_deploy_flags():
    """--wq/--aq/--w_sym/--deploy_dtype, and the K/V-cache flag in the JAX
    package's spelling (cli.py:80) beside the port's older one."""
    p = cli.build_argparser()
    base = ["--task", "tiny_ddim", "--out", "o"]
    a = p.parse_args(base)
    assert (a.wq, a.aq, a.w_sym, a.deploy_dtype, a.no_kv_cache) == \
        (4, 8, False, "float32", False)
    a = p.parse_args(base + ["--wq", "8", "--aq", "8", "--w_sym",
                             "--deploy_dtype", "bfloat16", "--no-kv-cache"])
    assert (a.wq, a.aq, a.w_sym, a.deploy_dtype, a.no_kv_cache) == \
        (8, 8, True, "bfloat16", True)
    assert p.parse_args(base + ["--no_kv_cache"]).no_kv_cache
    with pytest.raises(SystemExit):
        p.parse_args(base + ["--deploy_dtype", "float16"])


@pytest.fixture(scope="module")
def int4_bf16(ddim_runs):
    """``--int4-serving --deploy_dtype bfloat16`` from the bench
    configuration's grids: both packages' deployed tiny DDIM model
    functions (packed 4-bit weights, bf16 carriers), JAX's forward on its
    interpreted Pallas int4 kernels, and the port's forward with every
    deployed layer's input and output recorded."""
    run = ddim_runs["bench"]
    cfg = jtasks.get_task("tiny_ddim").unet
    x = np.random.default_rng(7).standard_normal(
        (2, 16, 16, 3)).astype(np.float32)
    t = np.full((2,), 40, np.int32)
    ja = JU.build_adapter(cfg, w_bits=4, a_bits=8, w_sym=True)
    jp = jax.tree.map(jnp.asarray, run["np_params"])
    jd = jdep.deploy_weights(ja.policy, jp, run["jw"], int4_serving=True)
    jp = jdep.cast_fp_params(jp)
    jfn = jdep.make_deployed_model_fn(ja, jp, jd, run["jast"], use_aq=True,
                                      act_dtype=jnp.bfloat16)
    j = np.asarray(_jax_kernel_run(
        lambda xx: jfn(xx, jnp.asarray(t), 2), x).astype(jnp.float32))
    ta = TU.build_adapter(ttasks.get_task("tiny_ddim").unet, w_bits=4,
                          a_bits=8, w_sym=True)
    tp = params_from_numpy(run["np_params"], "cpu")
    aw, aast, _ = load_cali_model(run["art"], device="cpu")
    td = tdep.deploy_weights(ta.policy, tp, aw, int4_serving=True)
    tfn = tdep.make_deployed_model_fn(ta, tdep.cast_fp_params(tp), td, aast,
                                      use_aq=True, act_dtype=torch.bfloat16)
    calls = []

    def recording(real):
        def op(qctx, name, xx, params, *a, **k):
            out = real(qctx, name, xx, params, *a, **k)
            if qctx is not None and qctx.deploy is not None \
                    and name in qctx.deploy:
                calls.append((real.__name__, name, xx, a, k, out))
            return out
        return op

    with mock.patch.object(tqf, "qconv2d", recording(tqf.qconv2d)), \
            mock.patch.object(tqf, "qlinear", recording(tqf.qlinear)):
        out = tfn(torch.from_numpy(x), torch.from_numpy(t), 2)
    jctx = JCtx(ja.policy, wstate={}, astate=j_slice(run["jast"], 2),
                use_wq=True, use_aq=True, deploy=jd, flash=True,
                act_out_dtype=jnp.bfloat16)
    return dict(j=j, out=out, calls=calls, jctx=jctx, jp=jp, jd=jd, td=td)


def test_int4_serving_bf16_forward_matches_jax(int4_bf16):
    """One deployed tiny DDIM forward against JAX's. The two int4 convs
    sum in another f32 order, so a bf16 output of one conv now and then
    rounds the other way, and the random-init model spreads the flip;
    measured over inputs drawn with seeds 5, 6, 7: max 1.6e-2..2.3e-2 of
    the output's largest magnitude, mean 1.1e-2..1.6e-2 of its mean
    magnitude (seed 7 here, the largest max). Planted in a copy of the
    port, a dropped int4 bias fails this limit, but a skipped act
    fake-quant or f32 int4 outputs pass it: the per-layer test below holds
    the layers."""
    j, out = int4_bf16["j"], int4_bf16["out"]
    assert out.dtype == torch.bfloat16
    d = np.abs(out.float().numpy() - j)
    assert d.max() <= INT4_MAX_REL * np.abs(j).max()
    assert d.mean() <= INT4_MEAN_REL * np.abs(j).mean()


def _bf16_ulp(a: np.ndarray) -> np.ndarray:
    """The spacing of bf16 values at |a| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(a), np.finfo(np.float32).tiny)))
    return np.exp2(e - 7)


def test_int4_serving_bf16_layers_match_jax(int4_bf16):
    """Every deployed layer of the forward above, one at a time: the port's
    qconv2d/qlinear against JAX's on the same bf16 input (the one that
    layer saw in the port's forward), with the same act grid, bias and
    packed weights, JAX on its interpreted Pallas int4 kernels. Both round
    one f32 result per element to bf16, and the f32 sums differ only in
    their order, so each element may differ by one bf16 ulp of the larger
    of the two values, plus ``INT4_LAYER_ABS`` of the layer's largest
    output where the sum cancels to near zero. Measured: every layer
    within it (one element 6 ulp at 4.8e-7, where the sum cancels), the
    int4 linears bit-equal, at least 99.98% of each conv's elements
    bit-equal (``INT4_LAYER_EQ``). Planted in a copy of the port, each of
    these faults fails this test: no act fake-quant before
    ``int4_linear``, none before ``int4_conv2d``, a dropped int4-linear
    bias, f32 int4-linear outputs where bf16 is asked for."""
    calls, jctx, jp = int4_bf16["calls"], int4_bf16["jctx"], int4_bf16["jp"]
    kinds = {type(int4_bf16["td"][c[1]]).__name__ for c in calls}
    assert {"Int4ConvWeight", "Int4Weight"} <= kinds
    assert len({c[1] for c in calls}) == len(int4_bf16["td"])
    for kind, name, x, a, k, out in calls:
        jop = getattr(jqf, kind)
        jx = jnp.asarray(x.float().numpy(), jnp.bfloat16)
        j = np.asarray(_jax_kernel_run(
            lambda xx: jop(jctx, name, xx, jp[name], *a, **k), jx)
            .astype(jnp.float32))
        assert out.dtype == torch.bfloat16, name
        got = out.float().numpy()
        assert got.shape == j.shape, name
        d = np.abs(got - j)
        lim = _bf16_ulp(np.maximum(np.abs(got), np.abs(j))) + \
            INT4_LAYER_ABS * np.abs(j).max()
        assert np.all(d <= lim), (name, float(d.max()))
        assert np.mean(d == 0) >= INT4_LAYER_EQ, (name, np.mean(d == 0))
