"""The port's CUDA kernels (packed-int4 conv and linear, flash attention)
against their plain PyTorch versions, on the card. Skips where
torch.cuda.is_available() is false. The file imports no JAX, so that it
runs on a machine without it:

    python -m pytest --noconftest -q tests/test_torch_cuda_kernels.py

(tests/conftest.py imports JAX.) Tolerance: the kernel and its plain
version round at the same points and differ only in how the f32 sums are
taken; the conv's tensor cores do not round to nearest after every
addition. 2e-5 of the output's largest magnitude.
"""

import pytest
import torch

from tfmq_dm_tpu_torch.ops import int4_kernels as K
from tfmq_dm_tpu_torch.ops.nn import exact_f32

REL_TOL = 2e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel)")
    exact_f32()
    return torch.device("cuda")


def _assert_close(got, ref):
    torch.cuda.synchronize()
    scale = max(1.0, float(ref.abs().max()))
    assert float((got - ref).abs().max()) <= REL_TOL * scale


def _weights(g, shape, n, dev):
    wp = K.pack_int4(torch.randint(-8, 8, shape + (n,), generator=g,
                                   dtype=torch.int8))
    d = torch.rand(n, generator=g) * 0.05 + 0.01
    z = torch.randint(-8, 8, (n,), generator=g).float()
    b = torch.randn(n, generator=g)
    return [t.to(dev) for t in (wp, d, z, b)]


@pytest.mark.parametrize("m,k,n", [(8, 512, 256), (1, 512, 128),
                                   (13, 1100, 70)])
def test_cuda_int4_linear_matches_plain(cuda, m, k, n):
    g = torch.Generator().manual_seed(m)
    wp, d, z, b = _weights(g, (k,), n, cuda)
    x = torch.randn(m, k, generator=g).to(cuda)
    before = K.LAUNCHES["int4_linear"]
    got = K.int4_linear(x, wp, d, z, b)
    assert K.LAUNCHES["int4_linear"] == before + 1
    _assert_close(got, K.int4_linear_plain(x, wp, d, z, b))


@pytest.mark.parametrize("b,h,cin,n,kk,padding", [
    (8, 16, 256, 256, 3, "SAME"), (8, 16, 256, 256, 1, "VALID"),
    (2, 5, 20, 37, 3, "SAME")])
def test_cuda_int4_conv2d_matches_plain(cuda, b, h, cin, n, kk, padding):
    g = torch.Generator().manual_seed(cin)
    wp, d, z, bias = _weights(g, (kk * kk, cin), n, cuda)
    x = torch.randn(b, h, h, cin, generator=g).to(torch.bfloat16).to(cuda)
    before = K.LAUNCHES["int4_conv2d"]
    got = K.int4_conv2d(x, wp, d, z, kk, kk, bias, padding)
    assert K.LAUNCHES["int4_conv2d"] == before + 1
    _assert_close(got, K.int4_conv2d_plain(x, wp, d, z, kk, kk, bias,
                                           padding))


def test_cuda_wrappers_reject_bad_inputs(cuda):
    """The wrapper checks type, shape and contiguity before it launches."""
    g = torch.Generator().manual_seed(0)
    wp, d, z, b = _weights(g, (64,), 32, cuda)
    with pytest.raises(ValueError, match="x: expected"):
        K.int4_linear(torch.randn(4, 64, device=cuda).half(), wp, d, z, b)
    with pytest.raises(ValueError, match="w_packed: expected"):
        K.int4_linear(torch.randn(4, 64, device=cuda), wp[:, :8], d, z, b)
    x = torch.randn(1, 4, 4, 64, device=cuda).to(torch.bfloat16)
    with pytest.raises(ValueError, match="x: expected"):
        K.int4_conv2d(x.transpose(1, 2), wp.reshape(1, 64, 16), d, z, 1, 1)


# ---------------------------------------------------------------------------
# flash attention: each kernel against its plain version
# ---------------------------------------------------------------------------
# Shapes: cin256 (B*H = 4, T = 1024, D = 384), SD (8 heads: T = 4096 and
# 1024 at D = 40, 1024 at D = 80, 256 at D = 160), ragged T, and Tk != Tq.
# Tolerances: without a softmax quantizer, 2e-5 of the output's largest
# magnitude (f32 sums in another order); with one, the JAX tests' one-level
# rule (tests/test_flash_attention.py:71-79): a quantized probability at a
# rounding boundary may flip by one level, since the kernel sums the
# softmax denominator in another order than the plain version.

FLASH_SHAPES = [(4, 1024, 1024, 384), (16, 4096, 4096, 40),
                (16, 1024, 1024, 40), (16, 1024, 1024, 80),
                (16, 256, 256, 160), (4, 100, 100, 40), (4, 130, 130, 40),
                (2, 130, 77, 64)]
A8 = (0, 255)


def _qkv(seed, bh, tq, tk, d, dev):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(bh, t, d, generator=g).to(dev)
            for t in (tq, tk, tk)]


def _assert_one_level(got, ref, level):
    torch.cuda.synchronize()
    diff = (got - ref).abs()
    assert float((diff > 1e-5).float().mean()) < 0.005
    assert float(diff.max()) <= 6.0 * level


def _int8_ops(q, k, v, dev, pw):
    from tfmq_dm_tpu_torch.ops import flash_attention as FA
    grids = ((0.031, 130.0), (0.029, 120.0), (0.033, 125.0))
    qkv_quant = tuple(tuple(torch.tensor(a, device=dev) for a in p)
                      for p in grids)
    ops = FA.int8_operands(q, k, v, qkv_quant, (A8,) * 3)
    dw, zw = pw if pw is not None else (1.0, 0.0)
    sc = torch.tensor([a for p in grids for a in p] + [dw, zw],
                      device=dev)
    return ops, sc


@pytest.mark.parametrize("bh,tq,tk,d", FLASH_SHAPES)
def test_cuda_flash_fp_matches_plain(cuda, bh, tq, tk, d):
    from tfmq_dm_tpu_torch.ops import flash_attention as FA
    q, k, v = _qkv(d + tq, bh, tq, tk, d, cuda)
    before = FA.LAUNCHES["flash_fp"]
    got = FA.flash_fp(q, k, v, d ** -0.5)
    assert FA.LAUNCHES["flash_fp"] == before + 1
    _assert_close(got, FA.flash_fp_plain(q, k, v, d ** -0.5))


@pytest.mark.parametrize("bh,tq,tk,d", FLASH_SHAPES)
@pytest.mark.parametrize("pw", [(1 / 255.0, 0.0), (0.004, 3.0)])
def test_cuda_flash_pquant_matches_plain(cuda, bh, tq, tk, d, pw):
    from tfmq_dm_tpu_torch.ops import flash_attention as FA
    q, k, v = _qkv(d + tk, bh, tq, tk, d, cuda)
    dz = torch.tensor(pw, device=cuda)
    zp_zero = pw[1] == 0.0
    before = FA.LAUNCHES["flash_pquant"]
    got = FA.flash_pquant(q, k, v, d ** -0.5, dz, A8, zp_zero)
    assert FA.LAUNCHES["flash_pquant"] == before + 1
    _assert_one_level(got, FA.flash_pquant_plain(q, k, v, d ** -0.5, dz,
                                                 A8, zp_zero), pw[0])


@pytest.mark.parametrize("bh,tq,tk,d", FLASH_SHAPES)
@pytest.mark.parametrize("pw", [None, (1 / 255.0, 0.0)])
def test_cuda_flash_int8_matches_plain(cuda, bh, tq, tk, d, pw):
    from tfmq_dm_tpu_torch.ops import flash_attention as FA
    q, k, v = _qkv(d + 7, bh, tq, tk, d, cuda)
    ops, sc = _int8_ops(q, k, v, cuda, pw)
    qrange = None if pw is None else A8
    before = FA.LAUNCHES["flash_int8"]
    got = FA.flash_int8(*ops, sc, d ** -0.5, qrange)
    assert FA.LAUNCHES["flash_int8"] == before + 1
    ref = FA.flash_int8_plain(*ops, sc, d ** -0.5, qrange)
    if pw is None:
        _assert_close(got, ref)
    else:
        _assert_one_level(got, ref, pw[0])


def test_cuda_flash_rejects_wide_head_dim(cuda):
    from tfmq_dm_tpu_torch.ops import flash_attention as FA
    q, k, v = _qkv(0, 1, 64, 64, 576, cuda)
    with pytest.raises(ValueError, match="head dim 576"):
        FA.flash_fp(q, k, v, 0.05)
