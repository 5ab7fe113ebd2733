"""The port's packed-int4 kernels (tfmq_dm_tpu_torch/ops/int4_kernels.py)
against the JAX Pallas kernels they replace, run in interpret mode on the
CPU. On a CPU tensor each wrapper takes its plain PyTorch version, which
repeats the CUDA kernel's rounding points; the CUDA kernels themselves are
held against the plain versions on the card (test_torch_cuda_kernels.py
and chip_smoke.py).

The JAX linear reference is compiled with ``xla_allow_excess_precision``
off: with it on (XLA's default), XLA on the CPU rewrites the one-row
product (M = 1) as a multiply-reduce and keeps the dequantized weight in
f32 instead of rounding it to bf16 — an artifact of interpret mode, since
the TPU kernel feeds bf16 operands to its matrix unit.

Tolerances: the plain versions and the Pallas kernels round at the same
points (x and dequantized weights to bf16), and products of bf16 values
are exact in f32, so they differ only in the f32 summation order: 1e-5
relative to the output's largest magnitude.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from tfmq_dm_tpu.ops import int_ops as jint
from tfmq_dm_tpu.ops import pallas_kernels as pk
from tfmq_dm_tpu.quant import deploy as jdeploy
from tfmq_dm_tpu.quant.quantizer import QCfg as JQCfg
from tfmq_dm_tpu_torch.ops import int4_kernels as K
from tfmq_dm_tpu_torch.ops import int_ops as tint
from tfmq_dm_tpu_torch.quant import deploy as tdeploy
from tfmq_dm_tpu_torch.quant.quantizer import QCfg

W4 = QCfg(bits=4, channel_wise=True)
JW4 = JQCfg(bits=4, channel_wise=True)
SUM_ORDER_RTOL = 1e-5


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def _assert_close(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=SUM_ORDER_RTOL * scale)


def _weights(shape, seed):
    """Calibrated 4-bit weights in both packages: (jax IntWeight, torch
    IntWeight) from one numpy draw and minmax per-channel grids."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal(shape) * 0.2).astype(np.float32)
    wmin = np.minimum(w.reshape(-1, shape[-1]).min(0), 0)
    wmax = np.maximum(w.reshape(-1, shape[-1]).max(0), 0)
    delta = np.maximum((wmax - wmin) / 15, 1e-8).astype(np.float32)
    zp = np.round(-wmin / delta).astype(np.float32)
    jw = jint.quantize_weight_int(jnp.asarray(w), jnp.asarray(delta),
                                  jnp.asarray(zp), JW4)
    tw = tint.quantize_weight_int(torch.from_numpy(w),
                                  torch.from_numpy(delta),
                                  torch.from_numpy(zp), W4)
    return jw, tw


def _jax_codes(packed: np.ndarray, block_n: int) -> np.ndarray:
    """JAX's unpack of its tile-concat layout, tile by tile."""
    half = block_n // 2
    tiles = [np.asarray(pk._unpack_int4(jnp.asarray(
        packed[..., j * half:(j + 1) * half])))
        for j in range(packed.shape[-1] // half)]
    return np.concatenate(tiles, axis=-1)


@pytest.mark.parametrize("k,n", [(16, 256), (8, 512), (5, 64)])
def test_pack_unpack_matches_jax_layout(k, n):
    codes = np.random.default_rng(0).integers(-8, 8, (k, n)).astype(np.int8)
    bn = min(256, n)
    jax_codes = _jax_codes(np.asarray(pk.pack_int4(codes, block_n=bn)), bn)
    packed = K.pack_int4(torch.from_numpy(codes))
    assert packed.dtype == torch.uint8 and packed.shape == (k, n // 2)
    port_codes = K.unpack_int4(packed, n).numpy()
    np.testing.assert_array_equal(port_codes, jax_codes)
    np.testing.assert_array_equal(port_codes, codes)


def test_pack_odd_channel_count_roundtrips():
    codes = torch.randint(-8, 8, (3, 4, 37), dtype=torch.int8)
    packed = K.pack_int4(codes)
    assert packed.shape == (3, 4, 19)
    assert torch.equal(K.unpack_int4(packed, 37), codes)


@pytest.mark.parametrize("m,k,n", [(8, 128, 256), (1, 64, 96),
                                   (3, 96, 300)])
def test_int4_linear_plain_matches_pallas(interpret, m, k, n):
    """M = batch rows (1 included), N not a multiple of the tile."""
    jw, tw = _weights((k, n), seed=m + n)
    np.testing.assert_array_equal(tint.dequant_weight(tw).numpy(),
                                  np.asarray(jint.dequant_weight(jw)))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    j4 = jdeploy._pack_linear_int4(jw)
    bias = jnp.pad(jnp.asarray(b), (0, j4.delta.shape[0] - n))
    fn = jax.jit(lambda xx: pk.int4_matmul_dequant(
        xx, j4.w_packed, j4.delta, j4.zp_c, bias=bias, block_n=j4.block_n))
    ref = fn.lower(jnp.asarray(x)).compile(
        {"xla_allow_excess_precision": False})(jnp.asarray(x))[:, :n]
    t4 = tdeploy._pack_linear_int4(tw)
    got = K.int4_linear(torch.from_numpy(x), t4.w_packed, t4.delta,
                        t4.zp_c, torch.from_numpy(b))
    _assert_close(got.numpy(), ref)


@pytest.mark.parametrize("kh,padding,cin,n", [(3, "SAME", 32, 48),
                                              (1, "VALID", 64, 64),
                                              (3, "SAME", 20, 37)])
def test_int4_conv2d_plain_matches_pallas(interpret, kh, padding, cin, n):
    jw, tw = _weights((kh, kh, cin, n), seed=cin + n)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 6, 6, cin)).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    j4 = jdeploy._pack_conv_int4(jw)
    pads = ((kh // 2,) * 2,) * 2 if padding == "SAME" else ((0, 0),) * 2
    bias = jnp.pad(jnp.asarray(b), (0, j4.delta.shape[0] - n))
    ref = pk.int4_conv2d_dequant(
        jnp.asarray(x, jnp.bfloat16), j4.w_packed, j4.delta, j4.zp_c,
        kh, kh, bias=bias, pads=pads, block_n=j4.block_n)[..., :n]
    t4 = tdeploy._pack_conv_int4(tw)
    got = K.int4_conv2d(torch.from_numpy(x).to(torch.bfloat16),
                        t4.w_packed, t4.delta, t4.zp_c, kh, kh,
                        torch.from_numpy(b), padding=padding)
    _assert_close(got.numpy(), ref)


def test_wrappers_refuse_other_devices():
    """Dispatch is by device: CPU -> plain version, CUDA -> kernel, and
    anything else raises (no silent fallback)."""
    x = torch.zeros(2, 4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        K.int4_linear(x, x, x, x)
    with pytest.raises(ValueError, match="unsupported device"):
        K.int4_conv2d(torch.zeros(1, 2, 2, 4, device="meta"), x, x, x, 1, 1)


# every distinct geometry of chip_smoke.py's int4_linear checks (CIFAR-10
# at batch 8, cin256 at batch 2 x CFG, odd shapes) and the card tests'
PLAN_SHAPES = [(8, 512, 256), (1, 512, 256), (3, 100, 37), (64, 512, 256),
               (4, 768, 768), (4, 512, 384), (4, 768, 960), (4096, 384, 384),
               (4096, 384, 3072), (4096, 1536, 384), (1024, 576, 4608),
               (256, 960, 960), (256, 3840, 960), (13, 1100, 70),
               (4100, 1100, 7680), (4, 1536, 70)]


@pytest.mark.parametrize("m,k,n", PLAN_SHAPES)
def test_int4_linear_plan_partitions_k(m, k, n):
    """The split-K plan: the small tile for M <= 64; K cut into whole
    32-deep steps, every split non-empty; splits only where the output
    tiles fill under half the card, and then enough blocks for at least
    half of it where K allows."""
    small, chunk, splits = K.linear_plan(m, k, n, sms=132)
    assert small == (m <= 64)
    assert chunk % 32 == 0 and (splits - 1) * chunk < k <= splits * chunk
    bm, bn, min_chunk = K._TILES[small]
    tiles = -(-m // bm) * -(-n // bn)
    if 2 * tiles >= 132:
        assert splits == 1
    else:
        assert splits <= K.MAX_SPLITS
        assert 2 * tiles * splits >= min(
            132, tiles * min(k // min_chunk, K.MAX_SPLITS))


# (batch, res, k, cin, cout) of every distinct packed conv of the CIFAR-10
# (batch 8) and cin256 (batch 2 x CFG) int4-serving paths, and the two
# ragged shapes of chip_smoke.py's conv checks
CONV_PLAN_SHAPES = [
    (8, 4, 1, 256, 256), (8, 4, 3, 256, 256), (8, 4, 3, 512, 256),
    (8, 8, 3, 256, 256), (8, 8, 3, 512, 256), (8, 16, 1, 256, 256),
    (8, 16, 3, 128, 256), (8, 16, 3, 256, 256), (8, 16, 3, 384, 256),
    (8, 16, 3, 512, 256), (8, 32, 3, 128, 128), (8, 32, 3, 256, 128),
    (8, 32, 3, 256, 256), (8, 32, 3, 384, 128),
    (4, 8, 1, 960, 960), (4, 8, 3, 576, 960), (4, 8, 3, 960, 960),
    (4, 8, 3, 1536, 960), (4, 8, 3, 1920, 960), (4, 16, 1, 576, 576),
    (4, 16, 3, 384, 576), (4, 16, 3, 576, 576), (4, 16, 3, 960, 576),
    (4, 16, 3, 960, 960), (4, 16, 3, 1152, 576), (4, 16, 3, 1536, 576),
    (4, 32, 1, 384, 384), (4, 32, 3, 192, 384), (4, 32, 3, 384, 384),
    (4, 32, 3, 576, 384), (4, 32, 3, 576, 576), (4, 32, 3, 768, 384),
    (4, 32, 3, 960, 384), (4, 64, 3, 192, 192), (4, 64, 3, 384, 192),
    (4, 64, 3, 384, 384), (4, 64, 3, 576, 192),
    (2, 5, 3, 20, 37), (1, 7, 1, 48, 10)]


@pytest.mark.parametrize("b,r,k,cin,n", CONV_PLAN_SHAPES)
def test_int4_conv2d_plan_partitions_k(b, r, k, cin, n):
    """The conv's plan: one of its route's block tiles; the K steps (k*k
    taps x channel chunks of the route) cut into whole steps, every split
    non-empty; splits only where the output tiles fill under half the
    blocks the card holds, never more than 16; wgmma only where Cin comes
    in whole 64-channel steps."""
    m = b * r * r
    route, bm, bn, splits, spc = K.conv_plan(m, n, k * k, cin, sms=132)
    assert (bm, bn) in K.CONV_TILES[route]
    steps = K.conv_steps(route, k * k, cin)
    assert spc >= 1 and (splits - 1) * spc < steps <= splits * spc
    tiles = -(-m // bm) * -(-n // bn)
    if 2 * tiles >= 132 * K.CONV_BLOCKS_PER_SM[route]:
        assert splits == 1
    assert 1 <= splits <= max(K.CONV_SPLITS)
    assert route == "mma" or cin % K.CONV_WG_BK == 0
