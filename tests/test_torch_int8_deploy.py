"""The port's exact int8 deployment module by module against the JAX
package on the CPU, on inputs made from a numpy seed: integer state
(codes, weight sums, border maps, int32 accumulators) bit for bit; the f32
outputs of ``int8_conv2d`` / ``int8_linear`` within 1e-6 of the output's
largest magnitude (the port's linear sums its correction terms in the
order of the Pallas ``int8_matmul_pre``, JAX's ``int8_linear`` in
another); the plain ``int8_matmul_pre`` against the JAX kernel in
interpret mode (measured bit-equal); ``cast_fp_params``; and two faults of
the port that this slice repairs: ``make_deployed_model_fn`` now takes
the flash kernels, the conditioning and the K/V cache (as does
``make_model_fn``, the CLI's fake-quant model function), and
``_int8_materialized`` sums its code products exactly above the f32-exact
depth of 1024. ``specialize_maps`` is held against JAX in
test_torch_deploy_slice.py (border maps bit-equal on whole models).
"""

import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.experimental import pallas as pl

from tfmq_dm_tpu.ops import attention as j_attn
from tfmq_dm_tpu.ops import int_ops as ji
from tfmq_dm_tpu.ops import pallas_kernels as pk
from tfmq_dm_tpu.quant import deploy as jdep
from tfmq_dm_tpu.quant.context import QuantCtx as JCtx
from tfmq_dm_tpu.quant.policy import LayerPolicy as JLP
from tfmq_dm_tpu.quant.policy import QuantPolicy as JPol
from tfmq_dm_tpu.quant.quantizer import QCfg as JQCfg
from tfmq_dm_tpu.quant.quantizer import init_qparams as j_init
from tfmq_dm_tpu_torch.configs import tasks as ttasks
from tfmq_dm_tpu_torch.models import ldm_unet as TL
from tfmq_dm_tpu_torch.models import ldm_units as TLU
from tfmq_dm_tpu_torch.ops import attention as t_attn
from tfmq_dm_tpu_torch.ops import flash_attention as TF
from tfmq_dm_tpu_torch.ops import int8_kernels as I8
from tfmq_dm_tpu_torch.ops import int_ops as ti
from tfmq_dm_tpu_torch.pipelines import ptq as tptq
from tfmq_dm_tpu_torch.quant import deploy as tdep
from tfmq_dm_tpu_torch.quant.context import QuantCtx as TCtx
from tfmq_dm_tpu_torch.quant.fsc import fsc_calibrate as t_fsc
from tfmq_dm_tpu_torch.quant.fsc import slice_fsc as t_slice
from tfmq_dm_tpu_torch.quant.inference import make_model_fn
from tfmq_dm_tpu_torch.quant.policy import LayerPolicy as TLP
from tfmq_dm_tpu_torch.quant.policy import QuantPolicy as TPol
from tfmq_dm_tpu_torch.quant.quantizer import QCfg as TQCfg
from tfmq_dm_tpu_torch.quant.recon import init_weight_qparams as t_iwq

REL_TOL = 1e-6
A8 = dict(bits=8, symmetric=False, channel_wise=False)


def _t(a):
    return torch.from_numpy(np.array(a))


def _quantized(rng, x_shape, w_shape, bits, sym, alpha=False):
    """The same weights, activations and grids on both sides: JAX
    (IntWeight, x_q, zp_xc, dx, b) and the port's."""
    x = rng.standard_normal(x_shape).astype(np.float32) * 2
    w = (rng.standard_normal(w_shape) * 0.2).astype(np.float32)
    b = rng.standard_normal(w_shape[-1]).astype(np.float32)
    wkw = dict(bits=bits, symmetric=sym, channel_wise=True)
    dw, zw = j_init(jnp.asarray(w), JQCfg(**wkw), scaler="minmax")
    dx, zx = j_init(jnp.asarray(x), JQCfg(**A8), scaler="minmax")
    al = rng.standard_normal(w_shape).astype(np.float32) if alpha else None
    jw = ji.quantize_weight_int(jnp.asarray(w), dw, zw, JQCfg(**wkw),
                                alpha=None if al is None else jnp.asarray(al))
    jx, jz = ji.quantize_act_int8(jnp.asarray(x), dx, zx, JQCfg(**A8))
    tw = ti.quantize_weight_int(_t(w), _t(dw), _t(zw), TQCfg(**wkw),
                                alpha=None if al is None else _t(al))
    tx, tz = ti.quantize_act_int8(_t(x), _t(dx), _t(zx), TQCfg(**A8))
    return (jw, jx, jz, dx, b), (tw, tx, tz, _t(dx), _t(b))


def _assert_rel(got, ref, tol=REL_TOL):
    scale = max(1e-30, float(np.abs(ref).max()))
    assert np.abs(got - ref).max() <= tol * scale


@pytest.mark.parametrize("bits,sym,alpha", [(8, False, True), (4, False,
                                                               False),
                                            (8, True, False)])
def test_deployed_codes_and_sums_bit_equal(bits, sym, alpha):
    rng = np.random.default_rng(bits + sym)
    (jw, jx, jz, _, _), (tw, tx, tz, _, _) = _quantized(
        rng, (2, 5, 5, 12), (3, 3, 12, 20), bits, sym, alpha)
    np.testing.assert_array_equal(tw.w_q.numpy(), np.asarray(jw.w_q))
    np.testing.assert_array_equal(tw.wsum.numpy(), np.asarray(jw.wsum))
    np.testing.assert_array_equal(tw.zp_c.numpy(), np.asarray(jw.zp_c))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    assert float(tz) == float(jz) and tw.sym == jw.sym and tw.k == jw.k


# (x shape, kernel, stride, padding): SAME/VALID, stride 2 with the DDIM
# downsample's explicit pads, and 3x3 inputs that are all border
CONVS = [((2, 6, 6, 12), 3, 1, "SAME"), ((2, 6, 5, 12), 1, 1, "VALID"),
         ((2, 7, 7, 12), 3, 2, ((0, 1), (0, 1))),
         ((1, 3, 3, 12), 3, 1, "SAME"), ((2, 6, 6, 12), 3, 1, "VALID")]


@pytest.mark.parametrize("xs,k,stride,padding", CONVS)
def test_conv_accumulator_and_border_maps_bit_equal(xs, k, stride, padding):
    rng = np.random.default_rng(k + stride + xs[1])
    (jw, jx, _, _, _), (tw, tx, _, _, _) = _quantized(
        rng, xs, (k, k, xs[3], 20), 8, False)
    pads = I8.conv_pads(padding, k, k)
    dn = ("NHWC", "HWIO", "NHWC")
    acc = lax.conv_general_dilated(jx, jw.w_q, (stride, stride), list(pads),
                                   dimension_numbers=dn,
                                   preferred_element_type=jnp.int32)
    got = I8.int8_conv_acc(tx, tw.w_q, stride, pads)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(acc))
    w_map, v_map = ti.border_maps(tw.w_q, xs[1:3], stride, pads)
    ones = jnp.ones((1,) + xs[1:3] + (xs[3],), jnp.int8)
    j_w = lax.conv_general_dilated(ones, jw.w_q, (stride, stride),
                                   list(pads), dimension_numbers=dn,
                                   preferred_element_type=jnp.int32)
    j_v = lax.conv_general_dilated(
        jnp.ones((1,) + xs[1:3] + (1,), jnp.int32),
        jnp.ones((k, k, 1, 1), jnp.int32), (stride, stride), list(pads),
        dimension_numbers=dn, preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(w_map.numpy(), np.asarray(j_w, np.float32))
    np.testing.assert_array_equal(v_map.numpy(), np.asarray(j_v, np.float32))


@pytest.mark.parametrize("sym", [False, True])
@pytest.mark.parametrize("xs,k,stride,padding", CONVS)
@pytest.mark.parametrize("maps", [False, True])
def test_int8_conv2d_matches_jax(xs, k, stride, padding, sym, maps):
    """With the border maps computed per call, and specialized ahead."""
    rng = np.random.default_rng(k + stride + xs[1] + 7 * sym)
    (jw, jx, jz, jdx, jb), (tw, tx, tz, tdx, tb) = _quantized(
        rng, xs, (k, k, xs[3], 20), 8, sym)
    pads = I8.conv_pads(padding, k, k)
    if maps:
        w_map, v_map = ti.border_maps(tw.w_q, xs[1:3], stride, pads)
        tw = ti.IntWeight(**{**tw.__dict__, "w_map": w_map,
                             "v_map": None if sym else v_map})
    ref = np.asarray(ji.int8_conv2d(jx, jz, jdx, jw, jnp.asarray(jb),
                                    stride=stride, pads=pads))
    got = ti.int8_conv2d(tx, tz, tdx, tw, tb, stride=stride,
                         pads=pads).numpy()
    assert got.shape == ref.shape
    _assert_rel(got, ref)


@pytest.mark.parametrize("sym", [False, True])
@pytest.mark.parametrize("lead,k,n", [((3,), 100, 37), ((1,), 64, 16),
                                      ((2, 5), 96, 40)])
def test_int8_linear_matches_jax(lead, k, n, sym):
    rng = np.random.default_rng(k + n + sym)
    (jw, jx, jz, jdx, jb), (tw, tx, tz, tdx, tb) = _quantized(
        rng, lead + (k,), (k, n), 8, sym)
    ref = np.asarray(ji.int8_linear(jx, jz, jdx, jw, jnp.asarray(jb)))
    got = ti.int8_linear(tx, tz, tdx, tw, tb).numpy()
    assert got.shape == ref.shape
    _assert_rel(got, ref)
    acc = np.asarray(jnp.dot(jx.reshape(-1, k), jw.w_q,
                             preferred_element_type=jnp.int32))
    np.testing.assert_array_equal(
        I8.int8_bmm_acc(tx.reshape(1, -1, k), tw.w_q[None])[0].numpy(), acc)


# (m, k, n, Pallas blocks): the Pallas kernel tiles K exactly, so odd
# shapes take one K block; (96, 192, 320) is tests/test_pallas_kernels.py's
@pytest.mark.parametrize("m,k,n,blocks", [(3, 100, 37, {}),
                                          (1, 64, 128, {}),
                                          (96, 192, 320, dict(
                                              block_m=32, block_n=128,
                                              block_k=64))])
@pytest.mark.parametrize("bias", [True, False])
def test_int8_matmul_pre_plain_matches_pallas(m, k, n, blocks, bias):
    """The plain version against JAX's ``int8_matmul_pre`` in interpret
    mode (tests/test_pallas_kernels.py:21-26, 88), odd shapes included;
    and its bf16 output, the f32 one rounded once."""
    rng = np.random.default_rng(m + k)
    (jw, jx, jz, jdx, jb), (tw, tx, tz, tdx, tb) = _quantized(
        rng, (m, k), (k, n), 8, False)
    jxs = jnp.sum(jx.astype(jnp.int32), axis=-1,
                  keepdims=True).astype(jnp.float32)
    with mock.patch.object(pl, "pallas_call",
                           functools.partial(pl.pallas_call,
                                             interpret=True)):
        ref = np.asarray(pk.int8_matmul_pre(
            jx, jxs, jw.w_q, jw.delta, jw.zp_c, jw.wsum, jdx, jz,
            jnp.asarray(jb) if bias else None, **blocks))
    txs = tx.to(torch.int32).sum(-1, keepdim=True).float()
    got = I8.int8_matmul_pre(tx, txs, tw.w_q, tw.delta, tw.zp_c,
                             tw.wsum.float(), tdx, tz,
                             tb if bias else None).numpy()
    _assert_rel(got, ref)
    bf = I8.int8_matmul_pre(tx, txs, tw.w_q, tw.delta, tw.zp_c,
                            tw.wsum.float(), tdx, tz, tb if bias else None,
                            out_dtype=torch.bfloat16)
    assert bf.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        bf.float().numpy(),
        torch.from_numpy(got).to(torch.bfloat16).float().numpy())


def test_cast_fp_params_matches_jax():
    rng = np.random.default_rng(0)
    tree = {"a": {"w": rng.standard_normal((3, 4)).astype(np.float32),
                  "b": rng.standard_normal(4).astype(np.float32)},
            "codes": {"w": rng.integers(-8, 8, (4,)).astype(np.int8)},
            "n": {"idx": np.arange(3, dtype=np.int32)}}
    j = jdep.cast_fp_params(jax.tree.map(jnp.asarray, tree))
    t = tdep.cast_fp_params({k: {f: _t(v) for f, v in d.items()}
                             for k, d in tree.items()})
    for k, d in tree.items():
        for f in d:
            assert str(t[k][f].dtype).split(".")[-1] == str(j[k][f].dtype)
            np.testing.assert_array_equal(
                t[k][f].float().numpy(),
                np.asarray(j[k][f].astype(jnp.float32)))


# ---------------------------------------------------------------------------
# fault 1: make_deployed_model_fn takes flash, conditioning and the cache
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_cin_deploy():
    task = ttasks.get_task("tiny_cin")
    g = torch.Generator().manual_seed(0)
    params = TL.init_params(g, task.unet)
    emb = torch.randn((3, 1, 16), generator=g)
    c = torch.cat([emb[:1], emb[:1], emb[1:2], emb[2:3]])
    _, a_cali, _ = tptq.generate_cali_data(
        task, lambda x, t, cc: TL.apply(params, task.unet, x, t,
                                        context=cc),
        torch.Generator().manual_seed(1), n_per_t=2, context=c[2:],
        uncond=c[:2], cfg_scale=3.0, device="cpu")
    adapter = TLU.build_adapter(task.unet, w_bits=4, a_bits=8, use_aq=True)
    wstate = t_iwq(adapter.policy, params, scaler="minmax")
    astate = t_fsc(adapter, params, wstate, a_cali,
                   torch.Generator().manual_seed(2), init_samples=4,
                   act_scaler="minmax")
    deployed = tdep.deploy_weights(adapter.policy, params, wstate)
    x = torch.randn((4, 8, 8, 3), generator=g)
    t = torch.full((4,), 50, dtype=torch.int32)
    return task, adapter, params, wstate, deployed, astate, x, t, c


@pytest.mark.parametrize("act_dtype,plain", [
    (torch.float32, "flash_int8_plain"), (torch.bfloat16,
                                          "flash_fqk_plain")])
def test_deployed_model_fn_takes_flash_and_kv_cache(tiny_cin_deploy,
                                                    act_dtype, plain):
    task, adapter, params, _, deployed, astate, x, t, c = tiny_cin_deploy
    if act_dtype == torch.bfloat16:
        params = tdep.cast_fp_params(params)
    t_attn.set_flash("on")
    try:
        fn = tdep.make_deployed_model_fn(adapter, params, deployed, astate,
                                         use_aq=True, act_dtype=act_dtype)
        with mock.patch.object(TF, plain,
                               wraps=getattr(TF, plain)) as spy:
            out = fn(x, t, 0, c)
        assert spy.call_count > 0          # self- and cross-attention
        assert out.dtype == act_dtype and torch.isfinite(out).all()
        cached = tdep.make_deployed_model_fn(
            adapter, params, deployed, astate, use_aq=True,
            act_dtype=act_dtype,
            kv_cache_fn=lambda q: TL.build_cross_kv(params, task.unet, c,
                                                    qctx=q))
        torch.testing.assert_close(cached(x, t, 0, c), out, rtol=0, atol=0)
    finally:
        t_attn.set_flash("auto")


def test_model_fn_takes_flash_groups_and_kv_cache(tiny_cin_deploy):
    """``make_model_fn``, the CLI's fake-quant model function: its contexts
    take flash, each step runs its FSC group (``group_of_step``) as a
    context built from ``slice_fsc`` would, and the K/V cache changes
    nothing."""
    task, adapter, params, wstate, _, astate, x, t, c = tiny_cin_deploy
    n_groups = next(iter(astate.values()))["delta"].shape[0]
    assert n_groups > 1
    gos = list(range(n_groups))[::-1]
    t_attn.set_flash("on")
    try:
        fn = make_model_fn(adapter, params, wstate, astate, use_aq=True,
                           group_of_step=gos)
        with mock.patch.object(TF, "flash_int8_plain",
                               wraps=TF.flash_int8_plain) as spy:
            out = fn(x, t, 0, c)
        assert spy.call_count > 0
        ref = TL.apply(params, task.unet, x, t, context=c, qctx=TCtx(
            adapter.policy, wstate=wstate, astate=t_slice(astate, gos[0]),
            use_wq=True, use_aq=True, flash=True))
        torch.testing.assert_close(out, ref, rtol=0, atol=0)
        cached = make_model_fn(
            adapter, params, wstate, astate, use_aq=True, group_of_step=gos,
            kv_cache_fn=lambda q: TL.build_cross_kv(params, task.unet, c,
                                                    qctx=q))
        torch.testing.assert_close(cached(x, t, 0, c), out, rtol=0, atol=0)
    finally:
        t_attn.set_flash("auto")


# ---------------------------------------------------------------------------
# fault 4: _int8_materialized is exact above the f32 bound
# ---------------------------------------------------------------------------

def _attn_ctxs(grids):
    """Deployed JAX and port contexts over act sites q/k/v/w."""
    out = []
    for QC, LP, Pol, Ctx, cast in (
            (JQCfg, JLP, JPol, JCtx, jnp.float32),
            (TQCfg, TLP, TPol, TCtx,
             lambda v: torch.tensor(v, dtype=torch.float32))):
        pol = Pol({s: LP(w_cfg=None, a_cfg=QC(**A8), wq=False, aq=True)
                   for s in grids}, order=[])
        ast = {s: {"delta": cast(d), "zp": cast(z)}
               for s, (d, z) in grids.items()}
        out.append(Ctx(pol, astate=ast, use_aq=True, deploy={}))
    return out


def _deployed_attention(q, k, v, grids, sm):
    jctx, tctx = _attn_ctxs(grids)
    sites = {s: s for s in grids}
    j = np.asarray(j_attn.qsm_attention(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), sm, jctx, sites))
    t = t_attn.qsm_attention(_t(q), _t(k), _t(v), sm, tctx, sites).numpy()
    return j, t


def test_int8_materialized_matches_jax_at_cin256_width():
    """cin256's 8x8 transformer: D 960 at T 64, inside the f32 bound."""
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((2, 64, 1, 960)).astype(np.float32)
               for _ in range(3))
    grids = {"q": (0.031, 130.0), "k": (0.029, 120.0),
             "v": (0.033, 125.0), "w": (1 / 255.0, 0.0)}
    j, t = _deployed_attention(q, k, v, grids, 960 ** -0.5)
    _assert_rel(t, j)


def test_int8_materialized_exact_above_f32_bound():
    """Tk 4099 > 1024: uniform attention (q = 0) quantizes every p to
    level 1 on a 1/4099 grid, and v to odd codes, so the P @ V sums of
    codes pass 2^24 with odd partial sums that an f32 product rounds (JAX
    sums them in int32)."""
    tk, d = 4099, 8
    rng = np.random.default_rng(1)
    q = np.zeros((1, 4, 1, d), np.float32)
    k = rng.standard_normal((1, tk, 1, d)).astype(np.float32)
    dv = 0.05
    v = (dv * rng.choice([1.0, 3.0], (1, tk, 1, d))).astype(np.float32)
    grids = {"q": (0.031, 128.0), "k": (0.029, 128.0), "v": (dv, 0.0),
             "w": (1.0 / tk, 0.0)}
    j, t = _deployed_attention(q, k, v, grids, d ** -0.5)
    np.testing.assert_array_equal(t, j)



# ---------------------------------------------------------------------------
# the int8 GEMM's K-major weights and its tile plan
# ---------------------------------------------------------------------------

def _kmajor_np(w_q):
    """w_q (..., N) flattened to (K, N), transposed, zero-padded to 16."""
    w2 = np.asarray(w_q).reshape(-1, np.asarray(w_q).shape[-1])
    kp = -(-w2.shape[0] // 16) * 16
    out = np.zeros((w2.shape[1], kp), np.int8)
    out[:, :w2.shape[0]] = w2.T
    return out


def test_tiny_cin_deployed_kmajor_copies(tiny_cin_deploy):
    """Every int8 weight of the tiny_cin deployment carries its codes
    K-major, (N, K padded to 16), equal to w_q (K, N) transposed and
    zero-padded; no K-major copy is made per call on the CPU path."""
    deployed = tiny_cin_deploy[4]
    iws = [iw for iw in deployed.values() if isinstance(iw, ti.IntWeight)]
    assert any(iw.w_q.ndim == 4 for iw in iws)
    assert any(iw.w_q.ndim == 2 for iw in iws)
    for iw in iws:
        assert iw.w_t.dtype == torch.int8 and iw.w_t.is_contiguous()
        np.testing.assert_array_equal(iw.w_t.numpy(), _kmajor_np(iw.w_q))


@pytest.mark.parametrize("kind", ["conv", "linear"])
def test_tiny_cin_deployed_int8_layers_match_jax(tiny_cin_deploy, kind):
    """The tiny_cin deployment's int8 layers (weights with their K-major
    copy) through ``int_ops.int8_conv2d`` / ``int8_linear`` against the
    JAX ``int_ops`` on the same codes: the int32 conv accumulators bit for
    bit, the f32 outputs within REL_TOL."""
    deployed = tiny_cin_deploy[4]
    rng = np.random.default_rng(3)
    names = [n for n, iw in deployed.items()
             if isinstance(iw, ti.IntWeight)
             and iw.w_q.ndim == (4 if kind == "conv" else 2)]
    for name in names[:6]:
        tw = deployed[name]
        jw = ji.IntWeight(w_q=jnp.asarray(tw.w_q.numpy()),
                          delta=jnp.asarray(tw.delta.numpy()),
                          zp_c=jnp.asarray(tw.zp_c.numpy()),
                          wsum=jnp.asarray(tw.wsum.numpy()), k=tw.k,
                          bits=tw.bits, sym=tw.sym)
        cin = tw.w_q.shape[-2]
        shape = (2, 6, 6, cin) if kind == "conv" else (5, cin)
        x = rng.integers(-128, 128, shape).astype(np.int8)
        zx, dx = np.float32(-3.0), np.float32(0.02)
        if kind == "conv":
            kh = tw.w_q.shape[0]
            pads = ((kh // 2, kh // 2),) * 2
            acc = I8.int8_conv_acc(_t(x), tw.w_q, 1, pads, w_t=tw.w_t)
            j_acc = lax.conv_general_dilated(
                jnp.asarray(x), jw.w_q, (1, 1), list(pads),
                dimension_numbers=("NHWC", "HWIO", "NHWC"),
                preferred_element_type=jnp.int32)
            np.testing.assert_array_equal(acc.numpy(), np.asarray(j_acc))
            got = ti.int8_conv2d(_t(x), _t(zx), _t(dx), tw, pads=pads)
            ref = ji.int8_conv2d(jnp.asarray(x), zx, dx, jw, pads=pads)
        else:
            got = ti.int8_linear(_t(x), _t(zx), _t(dx), tw)
            ref = ji.int8_linear(jnp.asarray(x), zx, dx, jw)
        _assert_rel(got.numpy(), np.asarray(ref))


# the int8 GEMM shapes of the cin256 bf16 deploy and the CIFAR-10 int8
# deploys (M, K, N), and ragged ones
PLAN_SHAPES = [(16384, 1728, 192), (4096, 384, 3072), (4096, 1536, 384),
               (4096, 3456, 384), (1024, 5184, 576), (256, 8640, 960),
               (4, 768, 960), (8192, 1152, 128), (2048, 2304, 256),
               (3, 100, 37), (4100, 1100, 70)]


@pytest.mark.parametrize("m,k,n", PLAN_SHAPES)
def test_gemm_plan_tiles_and_splits(m, k, n):
    """A plan the kernel takes: a compiled route and tile (wgmma for long
    K), K ranges of whole 128-byte steps that cover K with none empty, K
    split only for one product whose tiles fill under half of the card,
    at most 16 ways."""
    route, bm, bn, split, kchunk = I8.gemm_plan(m, n, k)
    assert (route, bm, bn) in {("wgmma", 128, 192), ("wgmma", 128, 128),
                               ("mma", 128, 128), ("mma", 64, 128)}
    assert (route == "wgmma") == (k >= I8.WGMMA_MIN_K)
    assert kchunk % I8.GEMM_KB == 0 and 1 <= split <= 16
    assert kchunk * (split - 1) < k <= kchunk * split
    tiles = -(-m // bm) * -(-n // bn)
    assert split == 1 or 2 * tiles < I8.GEMM_SMS
    assert I8.gemm_plan(m, n, k, batch=3)[3] == 1


# the fused GEMM's shapes: cin256's linears at batch 2 x CFG (K 384,
# 1536, 3840), the card tests' K 1152 and 2304, the last K whose 64-row
# panel fits (3072) and the first that does not, and ragged ones
FUSED_PLAN_SHAPES = [(4096, 384, 3072), (4096, 384, 384), (4096, 1536, 384),
                     (4096, 1152, 384), (256, 3840, 960), (1024, 576, 4608),
                     (3, 100, 37), (130, 1100, 70), (77, 1536, 960),
                     (1, 64, 128), (97, 2304, 300), (1024, 2304, 576),
                     (4096, 3072, 384), (4096, 3073, 384)]


@pytest.mark.parametrize("m,k,n", FUSED_PLAN_SHAPES)
def test_fused_plan_routes_and_groups(m, k, n):
    """``int8_matmul_fused``'s plan: an A panel of 128 or 64 rows where it
    fits in shared memory beside the weight ring and either shares its N
    tiles or runs in one wave, else the streamed panel; its N tiles cut
    into groups that each hold at least one tile (one tile a group when
    streamed)."""
    route, bm, bn, groups = I8.fused_plan(m, n, k)
    kp = -(-k // I8.FUSED_KB) * I8.FUSED_KB
    assert bm in (64, 128) and bn == I8.FUSED_BN
    assert bm == 64 or kp <= I8.FUSED_PANEL128_K or route == "stream"
    smem = I8.fused_smem(route, bm, k)
    assert smem <= I8.SMEM_PER_SM
    ntiles = -(-n // bn)
    tpg = -(-ntiles // groups)
    assert 1 <= groups <= ntiles and (groups - 1) * tpg < ntiles
    blocks = -(-m // bm) * groups
    if route == "panel":
        assert bm * kp + 4 * bn * I8.FUSED_KB + 4 * bm == smem
        per_sm = 2 if 2 * smem <= I8.SMEM_PER_SM else 1
        assert tpg > 1 or blocks <= per_sm * I8.GEMM_SMS
    else:
        assert groups == ntiles
        fits = 64 * kp + 4 * bn * I8.FUSED_KB + 4 * 64 <= I8.SMEM_PER_SM
        assert not fits or -(-m // 64) * ntiles > I8.GEMM_SMS
    # cin256's ff.net.0.proj: 128-row panels, each shared by 3 N tiles
    assert I8.fused_plan(4096, 3072, 384) == ("panel", 128, 128, 8)


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_int8_matmul_fused_plain_ignores_kmajor_copy(x_dtype):
    """The plain version takes the kernel's K-major weights ``w_t`` and
    does not read them: the same output with and without."""
    rng = np.random.default_rng(5)
    m, k, n = 7, 100, 37
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    x = x.to(x_dtype)
    w = torch.from_numpy(rng.integers(-128, 128, (k, n)).astype(np.int8))
    d = torch.from_numpy(rng.uniform(1e-3, 1e-2, n).astype(np.float32))
    z = torch.from_numpy(rng.integers(-10, 10, n).astype(np.float32))
    ws = w.to(torch.int32).sum(0).float()
    b = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    args = (x, w, d, z, ws, torch.tensor(0.021), torch.tensor(-3.0), b)
    for od in (torch.float32, torch.bfloat16):
        ref = I8.int8_matmul_fused_plain(*args, out_dtype=od)
        got = I8.int8_matmul_fused_plain(*args, out_dtype=od,
                                         w_t=I8.kmajor(w))
        assert torch.equal(got, ref)
        assert torch.equal(I8.int8_matmul_fused(*args, out_dtype=od,
                                                w_t=I8.kmajor(w)), ref)
