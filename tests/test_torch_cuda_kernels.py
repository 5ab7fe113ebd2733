"""The port's CUDA kernels (packed-int4 conv and linear, flash attention,
the exact int8 GEMM and its fused-quantization variant, the fused
GroupNorm + SiLU + int8 quantization) against their plain PyTorch
versions, on the card. Skips where
torch.cuda.is_available() is false. The file imports no JAX, so that it
runs on a machine without it:

    python -m pytest --noconftest -q tests/test_torch_cuda_kernels.py

(tests/conftest.py imports JAX.) Tolerance: the kernel and its plain
version round at the same points and differ only in how the f32 sums are
taken; the tensor cores (the conv, the linear) do not round to nearest
after every addition. 2e-5 of the output's largest magnitude. The int8
GEMMs are bit-equal (exact int32 sums). The fused GroupNorm's codes may
move one level where its statistics, summed in another order, put a
value at a rounding boundary: at most 1 level, on under 1e-4 of the
codes.
"""

import contextlib
from unittest import mock

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


@pytest.mark.parametrize("m", [4, 4096, 4100])
@pytest.mark.parametrize("k", [384, 1536, 1100])
@pytest.mark.parametrize("n", [70, 3072, 7680])
def test_cuda_int4_linear_tile_shapes(cuda, m, k, n):
    """The tensor-core linear at both tile variants, with and without
    split K, ragged M, K and N."""
    g = torch.Generator().manual_seed(m + k + n)
    wp, d, z, b = _weights(g, (k,), n, cuda)
    x = torch.randn(m, k, generator=g).to(cuda)
    before = K.LAUNCHES["int4_linear"]
    got = K.int4_linear(x, wp, d, z, b)
    assert K.LAUNCHES["int4_linear"] == before + 1
    _assert_close(got, K.int4_linear_plain(x, wp, d, z, b))


@pytest.mark.parametrize("m,k,n", [(8, 512, 256), (4, 768, 960),
                                   (256, 3840, 960), (4096, 384, 3072)])
def test_cuda_int4_linear_reruns_bit_identical(cuda, m, k, n):
    """Split-K partial sums are added in a fixed order (no atomics): two
    calls give the same bits."""
    g = torch.Generator().manual_seed(k)
    wp, d, z, b = _weights(g, (k,), n, cuda)
    x = torch.randn(m, k, generator=g).to(cuda)
    first = K.int4_linear(x, wp, d, z, b)
    assert torch.equal(first, K.int4_linear(x, wp, d, z, b))


# (batch, res, cin, cout, k, padding): ragged Cin (20: the scalar A
# route; 48: K steps past Cin), ragged N (37, 10, 70), a ragged image (9x9,
# M 243), CIFAR's 4x4 512 -> 256, cin256's 8x8 960 -> 960 (K 8640) and
# 64x64 192 -> 192 (M 16384)
CONV_ROUTE_SHAPES = [(2, 5, 20, 37, 3, "SAME"), (1, 7, 48, 10, 1, "VALID"),
                     (3, 9, 64, 70, 3, "SAME"), (8, 4, 512, 256, 3, "SAME"),
                     (4, 8, 960, 960, 3, "SAME"),
                     (4, 64, 192, 192, 3, "SAME")]


def _conv_args(b, h, cin, n, kk, padding, dev):
    g = torch.Generator().manual_seed(b * h + cin + n)
    wp, d, z, bias = _weights(g, (kk * kk, cin), n, dev)
    x = torch.randn(b, h, h, cin, generator=g).to(torch.bfloat16).to(dev)
    return (x, wp, d, z, kk, kk, bias, padding)


def _conv_close(got, ref, depth):
    """The conv's rule: 2e-5 of the largest output, in proportion to the
    depth K of the sum beyond 4608 (the tensor cores' sums)."""
    torch.cuda.synchronize()
    scale = max(1.0, float(ref.abs().max()))
    tol = REL_TOL * max(1.0, depth / 4608)
    assert float((got - ref).abs().max()) <= tol * scale


@pytest.mark.parametrize("b,h,cin,n,kk,padding,route,tile", [
    (*shape, route, tile) for shape in CONV_ROUTE_SHAPES
    for route, tiles in K.CONV_TILES.items() for tile in tiles
    if route == "mma" or shape[2] % K.CONV_WG_BK == 0])
@pytest.mark.parametrize("splits", [1, 3])
def test_cuda_int4_conv2d_routes_match_plain(cuda, b, h, cin, n, kk,
                                             padding, route, tile, splits):
    """Each route and block tile of the conv (wgmma where Cin comes in
    whole 64-channel steps, as it requires), with K whole and split three
    ways (the plan forced), against the plain version."""
    steps = K.conv_steps(route, kk * kk, cin)
    spc = -(-steps // splits)
    plan = (route, *tile, -(-steps // spc), spc)
    args = _conv_args(b, h, cin, n, kk, padding, cuda)
    with mock.patch.object(K, "conv_plan", lambda *a, **k: plan):
        before = K.LAUNCHES["int4_conv2d"]
        got = K.int4_conv2d(*args)
        assert K.LAUNCHES["int4_conv2d"] == before + 1
    _conv_close(got, K.int4_conv2d_plain(*args), kk * kk * cin)


@pytest.mark.parametrize("b,h,cin,n,kk,padding", [
    (8, 4, 512, 256, 3, "SAME"), (4, 8, 960, 960, 3, "SAME"),
    (8, 8, 256, 256, 3, "SAME")])
def test_cuda_int4_conv2d_split_k_reruns_bit_identical(cuda, b, h, cin, n,
                                                       kk, padding):
    """Shapes whose plan splits K: the partial sums are added in split
    order (no atomics), so two calls give the same bits."""
    m = b * h * h
    assert K.conv_plan(m, n, kk * kk, cin)[3] > 1
    args = _conv_args(b, h, cin, n, kk, padding, cuda)
    first = K.int4_conv2d(*args)
    assert torch.equal(first, K.int4_conv2d(*args))


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


@pytest.mark.parametrize("bh,tq,tk,d", FLASH_SHAPES)
@pytest.mark.parametrize("pw,zp_zero,int8_pv", [
    (None, False, False), ((1 / 255.0, 0.0), True, False),
    ((0.004, 3.0), False, False), ((1 / 255.0, 0.0), True, True)])
def test_cuda_flash_fqk_matches_plain(cuda, bh, tq, tk, d, pw, zp_zero,
                                      int8_pv):
    """Mode fqk on bf16 q/k/v: without a softmax quantizer the bf16
    outputs may differ by one bf16 ulp (2^-7 of the largest), in under
    0.5% of outputs; with one, the one-level rule."""
    from tfmq_dm_tpu_torch.ops import flash_attention as FA
    q, k, v = (x.to(torch.bfloat16) for x in _qkv(d + 3, bh, tq, tk, d,
                                                  cuda))
    dw, zw = pw if pw is not None else (1.0, 0.0)
    sc = torch.tensor([0.031, 130.0, 0.029, 120.0, 0.033, 125.0, dw, zw],
                      device=cuda)
    qrange = None if pw is None else A8
    args = (q, k, v, sc, d ** -0.5, (A8,) * 3, qrange, zp_zero, int8_pv)
    before = FA.LAUNCHES["flash_fqk"]
    got = FA.flash_fqk(*args)
    assert FA.LAUNCHES["flash_fqk"] == before + 1 and \
        got.dtype == torch.bfloat16
    ref = FA.flash_fqk_plain(*args).float()
    got = got.float()
    if pw is None:
        torch.cuda.synchronize()
        diff = (got - ref).abs()
        assert float((diff > 1e-5).float().mean()) < 0.005
        assert float(diff.max()) <= 2.0 ** -7 * float(ref.abs().max())
    else:
        _assert_one_level(got, ref, pw[0])


FQK_SC = [0.031, 130.0, 0.029, 120.0, 0.033, 125.0]


@pytest.mark.parametrize("d", [40, 80, 384])
@pytest.mark.parametrize("tk", [1000, 4096])
@pytest.mark.parametrize("pw,zp_zero,int8_pv", [
    (None, False, False), ((1 / 255.0, 0.0), True, False),
    ((0.004, 3.0), False, False), ((1 / 255.0, 0.0), True, True)])
def test_cuda_flash_fqk_tiles_match_plain(cuda, d, tk, pw, zp_zero,
                                          int8_pv):
    """The pre-pass + tensor-core fqk kernel at each padded head dim
    (40 -> 48, 80, 384), a ragged Tk and Tk 4096 over two key blocks, in
    the four mode / zp_zero / int8_pv combinations; the same rules as
    above."""
    from tfmq_dm_tpu_torch.ops import flash_attention as FA
    q, k, v = (x.to(torch.bfloat16)
               for x in _qkv(d + tk, 2, 512, tk, d, cuda))
    dw, zw = pw if pw is not None else (1.0, 0.0)
    sc = torch.tensor(FQK_SC + [dw, zw], device=cuda)
    qrange = None if pw is None else A8
    args = (q, k, v, sc, d ** -0.5, (A8,) * 3, qrange, zp_zero, int8_pv)
    before = FA.LAUNCHES["flash_fqk"]
    got = FA.flash_fqk(*args).float()
    assert FA.LAUNCHES["flash_fqk"] == before + 1
    ref = FA.flash_fqk_plain(*args).float()
    if pw is None:
        torch.cuda.synchronize()
        diff = (got - ref).abs()
        assert float((diff > 1e-5).float().mean()) < 0.005
        assert float(diff.max()) <= 2.0 ** -7 * float(ref.abs().max())
    else:
        _assert_one_level(got, ref, pw[0])


@pytest.mark.parametrize("d", [40, 80, 384])
@pytest.mark.parametrize("int8_pv", [False, True])
def test_cuda_fqk_prepass_matches_plain(cuda, d, int8_pv):
    """The pre-pass kernel against ``fqk_prepass_plain``, bit for bit, at
    a ragged Tk: bf16 K/V, or the transposed v codes and their column
    sums over the real keys."""
    from tfmq_dm_tpu_torch.ops import flash_attention as FA
    _, k, v = (x.to(torch.bfloat16) for x in _qkv(d, 3, 8, 1000, d, cuda))
    sc = torch.tensor(FQK_SC + [1 / 255.0, 0.0], device=cuda)
    ranges = ((0, 255), (10, 240), (3, 200))
    got = FA.fqk_prepass(k, v, sc, ranges, int8_pv)
    ref = FA.fqk_prepass_plain(k, v, sc, ranges, int8_pv)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert torch.equal(a.contiguous(), b)


@pytest.mark.parametrize("mode", ["pquant", "int8", "fqk"])
def test_cuda_flash_key_blocks_match_plain(cuda, mode):
    """Several key blocks (Tk 1024 at block_k 256): each rounded against
    its block's running max, then rebased, in kernel and plain version."""
    from tfmq_dm_tpu_torch.ops import flash_attention as FA
    q, k, v = _qkv(11, 4, 1024, 1024, 64, cuda)
    pw = (1 / 255.0, 0.0)
    if mode == "pquant":
        dz = torch.tensor(pw, device=cuda)
        args = (q, k, v, 0.125, dz, A8, True, 256)
        got, ref = FA.flash_pquant(*args), FA.flash_pquant_plain(*args)
    elif mode == "int8":
        ops, sc = _int8_ops(q, k, v, cuda, pw)
        got = FA.flash_int8(*ops, sc, 0.125, A8, 256)
        ref = FA.flash_int8_plain(*ops, sc, 0.125, A8, 256)
    else:
        sc = torch.tensor([0.031, 130.0, 0.029, 120.0, 0.033, 125.0, *pw],
                          device=cuda)
        args = (q.bfloat16(), k.bfloat16(), v.bfloat16(), sc, 0.125,
                (A8,) * 3, A8, True, False, 256)
        got, ref = FA.flash_fqk(*args).float(), \
            FA.flash_fqk_plain(*args).float()
    _assert_one_level(got, ref, pw[0])


# The 16-bit softmax grid (--softmax_a_bit 16): a level is 1/65535, so a
# one-level flip moves an output by more than 1e-5, and the plain
# version's own f32 arithmetic flips levels against the same function in
# float64 in 0.4-1.1% of outputs at these shapes (seeded CPU emulation;
# an exact S flips as many against the f32 plain version). So the share
# is taken against the float64 plain version: the kernel's share of
# outputs off by more than 1e-5 at most the larger of the one-level
# rule's 0.5% and twice the f32 plain version's; none more than 6 levels
# off the f32 plain version (unchanged).
P16 = (0, 65535)


def _share(a, b) -> float:
    return float(((a - b).abs() > 1e-5).float().mean())


def _assert_16bit(got, q, k, v, sm, dz, zp_zero):
    from tfmq_dm_tpu_torch.ops import flash_attention as FA
    ref = FA.flash_pquant_plain(q, k, v, sm, dz, P16, zp_zero)
    exact = FA.flash_pquant_plain(q.double(), k.double(), v.double(), sm,
                                  dz.double(), P16, zp_zero).float()
    torch.cuda.synchronize()
    assert _share(got, exact) <= max(0.005, 2.0 * _share(ref, exact))
    assert float((got - ref).abs().max()) <= 6.0 * float(dz[0])


@pytest.mark.parametrize("d", [40, 80, 384])
@pytest.mark.parametrize("tk", [1000, 4096])
@pytest.mark.parametrize("pw", [(1 / 65535.0, 0.0), (1.5e-5, 3.0)])
def test_cuda_flash_pquant_16bit_grid_matches_plain(cuda, d, tk, pw):
    """The tensor-core pquant kernel at the cin256 --softmax_a_bit 16 grid
    (levels up to 65535: split hi + lo for P @ V), at each padded head dim
    (40, 80, 384), a ragged Tk and Tk 4096, zp_zero and a non-zero zp."""
    from tfmq_dm_tpu_torch.ops import flash_attention as FA
    q, k, v = _qkv(d + tk + 3, 2, 256, tk, d, cuda)
    dz = torch.tensor(pw, device=cuda)
    zp_zero = pw[1] == 0.0
    before = FA.LAUNCHES["flash_pquant"]
    got = FA.flash_pquant(q, k, v, d ** -0.5, dz, P16, zp_zero)
    assert FA.LAUNCHES["flash_pquant"] == before + 1
    _assert_16bit(got, q, k, v, d ** -0.5, dz, zp_zero)


def test_cuda_flash_pquant_reruns_bit_identical(cuda):
    """Two passes over the same keys in a fixed order: two calls agree bit
    for bit, at both grids."""
    from tfmq_dm_tpu_torch.ops import flash_attention as FA
    q, k, v = _qkv(3, 4, 1024, 1024, 384, cuda)
    for pw, qr in (((1 / 255.0, 0.0), A8), ((1 / 65535.0, 0.0), P16)):
        dz = torch.tensor(pw, device=cuda)
        a = FA.flash_pquant(q, k, v, 384 ** -0.5, dz, qr, True)
        b = FA.flash_pquant(q, k, v, 384 ** -0.5, dz, qr, True)
        torch.cuda.synchronize()
        assert torch.equal(a, b)


# The tensor-core flash_int8 and flash_fp at every head-dim template they
# instantiate (int8: d padded to 64, 96, 160, 384; fp: 40, 80, 160, 384),
# at a Tk that is no multiple of the key tile (1000) and at Tk 4096; with
# the softmax quantizer over several key blocks (block_k 256). The same
# rules as above.

@pytest.mark.parametrize("d", [40, 64, 80, 160, 384])
@pytest.mark.parametrize("tk", [1000, 4096])
@pytest.mark.parametrize("pw,zv", [(None, 125.0), (None, 125.37),
                                   ((1 / 255.0, 0.0), 125.0),
                                   ((0.004, 3.0), 125.0)])
def test_cuda_flash_int8_tiles_match_plain(cuda, d, tk, pw, zv):
    """Without the quantizer at an integer and a fractional v zero point
    (two and three TF32 products in P @ V); with it at block_k 256."""
    from tfmq_dm_tpu_torch.ops import flash_attention as FA
    q, k, v = _qkv(d + tk + 5, 2, 256, tk, d, cuda)
    ops, sc = _int8_ops(q, k, v, cuda, pw)
    sc[5] = zv
    qrange = None if pw is None else A8
    args = (*ops, sc, d ** -0.5, qrange, 256)
    before = FA.LAUNCHES["flash_int8"]
    got = FA.flash_int8(*args)
    assert FA.LAUNCHES["flash_int8"] == before + 1
    ref = FA.flash_int8_plain(*args)
    if pw is None:
        _assert_close(got, ref)
    else:
        _assert_one_level(got, ref, pw[0])


@pytest.mark.parametrize("d", [40, 64, 80, 160, 384])
@pytest.mark.parametrize("tk", [1000, 4096])
def test_cuda_flash_fp_tiles_match_plain(cuda, d, tk):
    from tfmq_dm_tpu_torch.ops import flash_attention as FA
    q, k, v = _qkv(d + tk + 6, 2, 256, tk, d, cuda)
    before = FA.LAUNCHES["flash_fp"]
    got = FA.flash_fp(q, k, v, d ** -0.5)
    assert FA.LAUNCHES["flash_fp"] == before + 1
    _assert_close(got, FA.flash_fp_plain(q, k, v, d ** -0.5))


@pytest.mark.parametrize("d", [36, 77])
@pytest.mark.parametrize("mode", ["fp", "int8", "int8 p-quant"])
def test_cuda_flash_odd_head_dims_match_plain(cuda, d, mode):
    """Head dims that are no multiple of 8 (int8 codes copied in 4-byte
    granules) or of 4 (bytewise; f32 rows by 4-byte copies)."""
    from tfmq_dm_tpu_torch.ops import flash_attention as FA
    q, k, v = _qkv(d + 8, 3, 200, 300, d, cuda)
    if mode == "fp":
        _assert_close(FA.flash_fp(q, k, v, d ** -0.5),
                      FA.flash_fp_plain(q, k, v, d ** -0.5))
        return
    pw = (1 / 255.0, 0.0) if mode == "int8 p-quant" else None
    ops, sc = _int8_ops(q, k, v, cuda, pw)
    qrange = None if pw is None else A8
    got = FA.flash_int8(*ops, sc, d ** -0.5, qrange)
    ref = FA.flash_int8_plain(*ops, sc, d ** -0.5, qrange)
    if pw is None:
        _assert_close(got, ref)
    else:
        _assert_one_level(got, ref, pw[0])


def test_cuda_flash_int8_reruns_bit_identical(cuda):
    """Integer S, fixed summation orders: two calls agree bit for bit,
    with and without the softmax quantizer."""
    from tfmq_dm_tpu_torch.ops import flash_attention as FA
    q, k, v = _qkv(4, 4, 1024, 1024, 384, cuda)
    for pw in ((1 / 255.0, 0.0), None):
        ops, sc = _int8_ops(q, k, v, cuda, pw)
        qr = None if pw is None else A8
        a = FA.flash_int8(*ops, sc, 384 ** -0.5, qr)
        b = FA.flash_int8(*ops, sc, 384 ** -0.5, qr)
        torch.cuda.synchronize()
        assert torch.equal(a, b)


@pytest.mark.parametrize("tk,d", [(1000, 40), (77, 80), (4096, 160),
                                  (1024, 384)])
def test_cuda_int8_vt_matches_plain(cuda, tk, d):
    """flash_int8's pre-pass: the v codes transposed and zero-padded, bit
    for bit."""
    from tfmq_dm_tpu_torch.ops import flash_attention as FA
    g = torch.Generator().manual_seed(tk + d)
    v8 = torch.randint(-128, 128, (3, tk, d), generator=g,
                       dtype=torch.int8).to(cuda)
    got = FA.int8_vt(v8)
    torch.cuda.synchronize()
    assert torch.equal(got, FA.int8_vt_plain(v8))


# ---------------------------------------------------------------------------
# the exact int8 GEMM: bit-equal to its plain version (exact int32 sums,
# the same epilogue order)
# ---------------------------------------------------------------------------

def _codes(g, shape, dev):
    return torch.randint(-128, 128, shape, generator=g,
                         dtype=torch.int8).to(dev)


@pytest.mark.parametrize("m,k,n", [(3, 100, 37), (1, 512, 256),
                                   (8, 512, 256), (4096, 384, 1536),
                                   (77, 17280, 960)])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_cuda_int8_matmul_pre_matches_plain(cuda, m, k, n, out_dtype):
    from tfmq_dm_tpu_torch.ops import int8_kernels as I8
    g = torch.Generator().manual_seed(m + n)
    x, w = _codes(g, (m, k), cuda), _codes(g, (k, n), cuda)
    xs = x.to(torch.int32).sum(-1, keepdim=True).float()
    d = (torch.rand(n, generator=g) * 0.01 + 1e-3).to(cuda)
    z = torch.randint(-10, 10, (n,), generator=g).float().to(cuda)
    ws = w.to(torch.int32).sum(0).float()
    b = torch.randn(n, generator=g).to(cuda)
    args = (x, xs, w, d, z, ws, torch.tensor(0.02, device=cuda),
            torch.tensor(-3.0, device=cuda), b)
    before = I8.LAUNCHES["int8_matmul_pre"]
    got = I8.int8_matmul_pre(*args, out_dtype=out_dtype)
    assert I8.LAUNCHES["int8_matmul_pre"] == before + 1
    ref = I8.int8_matmul_pre_plain(*args, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert got.dtype == out_dtype and torch.equal(got, ref)


@pytest.mark.parametrize("b,h,cin,n,kk,stride,pads", [
    (8, 32, 128, 128, 3, 1, ((1, 1), (1, 1))),
    (4, 8, 1920, 960, 3, 1, ((1, 1), (1, 1))),
    (2, 5, 20, 37, 3, 1, ((1, 1), (1, 1))),
    (2, 9, 16, 24, 3, 2, ((0, 1), (0, 1))),
    (4, 32, 384, 384, 1, 1, ((0, 0), (0, 0)))])
def test_cuda_int8_conv_acc_matches_plain(cuda, b, h, cin, n, kk, stride,
                                          pads):
    from tfmq_dm_tpu_torch.ops import int8_kernels as I8
    g = torch.Generator().manual_seed(cin + n)
    x, w = _codes(g, (b, h, h, cin), cuda), _codes(g, (kk, kk, cin, n), cuda)
    before = I8.LAUNCHES["int8_conv2d"]
    got = I8.int8_conv_acc(x, w, stride, pads)
    assert I8.LAUNCHES["int8_conv2d"] == before + 1
    ref = I8.int8_conv_acc_plain(x, w, stride, pads)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


def test_cuda_int8_bmm_acc_matches_plain(cuda):
    from tfmq_dm_tpu_torch.ops import int8_kernels as I8
    g = torch.Generator().manual_seed(5)
    a, b = _codes(g, (3, 64, 4099), cuda), _codes(g, (3, 4099, 40), cuda)
    before = I8.LAUNCHES["int8_bmm"]
    got = I8.int8_bmm_acc(a, b)
    assert I8.LAUNCHES["int8_bmm"] == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got, I8.int8_bmm_acc_plain(a, b))


# (M, K, N) at the plan's tiles: wgmma 128 x 192 (the cin256 64x64 conv
# GEMM, N 192), wgmma 128 x 128 with K split (the 16x16 and 8x8 convs,
# CIFAR's 16x16 conv), mma.sync 128 x 128 (ff.net.0.proj) and 64 x 128
# (N 384; M 4 with K split: the embedding projections), and ragged M, N
# and K
GEMM_SHAPES = [(16384, 1728, 192), (4096, 384, 3072), (4096, 384, 384),
               (1024, 5184, 576), (256, 8640, 960), (2048, 2304, 256),
               (4, 768, 960), (3, 100, 37), (4100, 1100, 70),
               (4100, 70, 1100)]


@pytest.mark.parametrize("m,k,n", GEMM_SHAPES)
@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("route", ["plan", "wgmma", "mma"])
def test_cuda_int8_gemm_tiles_match_plain(cuda, m, k, n, mode, route):
    """The redesigned GEMM at each shape with its plan's route and tile,
    and forced onto each tensor-core route (wgmma 128 x 128, mma.sync
    64 x 128, the plan's K split), in its three modes (int32 through
    ``int8_bmm_acc``; f32 and bf16 epilogues through ``int8_matmul_pre``
    with the K-major copy given, as deployed): bit for bit."""
    from tfmq_dm_tpu_torch.ops import int8_kernels as I8
    real = I8.gemm_plan

    def forced(m_, n_, k_, batch=1, sms=I8.GEMM_SMS):
        split, kchunk = real(m_, n_, k_, batch, sms)[3:]
        return (route, 128 if route == "wgmma" else 64, 128, split, kchunk)

    with mock.patch.object(I8, "gemm_plan",
                           real if route == "plan" else forced):
        _gemm_matches_plain(cuda, m, k, n, mode)


def _gemm_matches_plain(cuda, m, k, n, mode):
    from tfmq_dm_tpu_torch.ops import int8_kernels as I8
    g = torch.Generator().manual_seed(m + k + n)
    x, w = _codes(g, (m, k), cuda), _codes(g, (k, n), cuda)
    if mode == 0:
        got = I8.int8_bmm_acc(x[None], w[None])
        ref = I8.int8_bmm_acc_plain(x[None], w[None])
    else:
        od = torch.float32 if mode == 1 else torch.bfloat16
        xs = x.to(torch.int32).sum(-1, keepdim=True).float()
        d = (torch.rand(n, generator=g) * 0.01 + 1e-3).to(cuda)
        z = torch.randint(-10, 10, (n,), generator=g).float().to(cuda)
        ws = w.to(torch.int32).sum(0).float()
        b = torch.randn(n, generator=g).to(cuda)
        args = (x, xs, w, d, z, ws, torch.tensor(0.02, device=cuda),
                torch.tensor(-3.0, device=cuda), b)
        copies = I8.KMAJOR_COPIES["int8_matmul_pre"]
        got = I8.int8_matmul_pre(*args, out_dtype=od, w_t=I8.kmajor(w))
        assert I8.KMAJOR_COPIES["int8_matmul_pre"] == copies
        ref = I8.int8_matmul_pre_plain(*args, out_dtype=od)
    torch.cuda.synchronize()
    assert got.dtype == ref.dtype and torch.equal(got, ref)


@pytest.mark.parametrize("m,k,n", [(256, 8640, 960), (4, 768, 960),
                                   (1024, 5184, 576), (256, 960, 960)])
def test_cuda_int8_gemm_split_k_reruns_bit_identical(cuda, m, k, n):
    """Shapes whose plan splits K: two calls agree bit for bit (the
    partials are int32, added in split order)."""
    from tfmq_dm_tpu_torch.ops import int8_kernels as I8
    assert I8.gemm_plan(m, n, k)[3] > 1
    g = torch.Generator().manual_seed(k)
    x, w = _codes(g, (m, k), cuda), _codes(g, (k, n), cuda)
    xs = x.to(torch.int32).sum(-1, keepdim=True).float()
    ones = torch.ones(n, device=cuda)
    args = (x, xs, w, ones, ones, ones, torch.tensor(0.5, device=cuda),
            torch.tensor(1.0, device=cuda))
    a = I8.int8_matmul_pre(*args, out_dtype=torch.bfloat16)
    b = I8.int8_matmul_pre(*args, out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.parametrize("sym", [False, True])
def test_cuda_int8_deployed_weights_take_kmajor_copy(cuda, sym):
    """``int_ops.int8_linear`` and ``int8_conv2d`` on a deployed IntWeight
    read its K-major copy (no copy made per call) and stay bit-equal to
    the plain versions."""
    from tfmq_dm_tpu_torch.ops import int8_kernels as I8
    from tfmq_dm_tpu_torch.ops import int_ops
    from tfmq_dm_tpu_torch.quant.quantizer import QCfg
    g = torch.Generator().manual_seed(11 + sym)
    cfg = QCfg(bits=8, symmetric=sym, channel_wise=True)
    zx, dx = torch.tensor(-3.0, device=cuda), torch.tensor(0.02, device=cuda)
    for shape, xshape in (((576, 192), (1024, 576)),
                          ((3, 3, 192, 192), (2, 16, 16, 192))):
        n = shape[-1]
        w = (torch.randn(shape, generator=g) * 0.05).to(cuda)
        delta = (torch.rand(n, generator=g) * 1e-3 + 5e-4).to(cuda)
        zp = torch.zeros(n, device=cuda) if sym else \
            torch.randint(100, 156, (n,), generator=g).float().to(cuda)
        iw = int_ops.quantize_weight_int(w, delta, zp, cfg)
        x = _codes(g, xshape, cuda)
        copies = dict(I8.KMAJOR_COPIES)
        if len(shape) == 2:
            got = int_ops.int8_linear(x, zx, dx, iw, out_dtype=torch.bfloat16)
        else:
            got = int_ops.int8_conv2d(x, zx, dx, iw)
        assert I8.KMAJOR_COPIES == copies
        with _plain_int8():
            ref = int_ops.int8_linear(x, zx, dx, iw,
                                      out_dtype=torch.bfloat16) \
                if len(shape) == 2 else int_ops.int8_conv2d(x, zx, dx, iw)
        torch.cuda.synchronize()
        assert torch.equal(got, ref)


def _plain_int8():
    """The int8 wrappers routed to their plain versions (on the card)."""
    from tfmq_dm_tpu_torch.ops import int8_kernels as I8
    stack = contextlib.ExitStack()
    for name in ("int8_matmul_pre", "int8_conv_acc"):
        stack.enter_context(mock.patch.object(
            I8, name, getattr(I8, f"{name}_plain")))
    return stack


# ---------------------------------------------------------------------------
# int8_matmul_fused: bit-equal to its plain version and to
# int8_matmul_pre on quantize_act_int8's codes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,k,n", [(3, 100, 37), (1, 64, 128),
                                   (130, 1100, 70), (77, 1536, 960),
                                   (4096, 384, 3072)])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_cuda_int8_matmul_fused_matches_plain(cuda, m, k, n, x_dtype,
                                              out_dtype):
    from tfmq_dm_tpu_torch.ops import int8_kernels as I8
    from tfmq_dm_tpu_torch.ops import int_ops
    from tfmq_dm_tpu_torch.quant.quantizer import QCfg
    g = torch.Generator().manual_seed(m + k + n)
    x = (torch.randn(m, k, generator=g) * 1.5).to(x_dtype).to(cuda)
    w = _codes(g, (k, n), cuda)
    d = (torch.rand(n, generator=g) * 0.01 + 1e-3).to(cuda)
    z = torch.randint(-10, 10, (n,), generator=g).float().to(cuda)
    ws = w.to(torch.int32).sum(0).float()
    b = torch.randn(n, generator=g).to(cuda)
    dx, zx = torch.tensor(0.021, device=cuda), torch.tensor(-3.0, device=cuda)
    xq, zc = int_ops.quantize_act_int8(x, dx, zx + 128.0, QCfg(bits=8))
    xs = xq.to(torch.int32).sum(-1, keepdim=True).float()
    for bias in (b, None):
        args = (x, w, d, z, ws, dx, zx, bias)
        before = I8.LAUNCHES["int8_matmul_fused"]
        got = I8.int8_matmul_fused(*args, out_dtype=out_dtype)
        assert I8.LAUNCHES["int8_matmul_fused"] == before + 1
        ref = I8.int8_matmul_fused_plain(*args, out_dtype=out_dtype)
        pre = I8.int8_matmul_pre(xq, xs, w, d, z, ws, dx, zc, bias,
                                 out_dtype=out_dtype)
        torch.cuda.synchronize()
        assert got.dtype == out_dtype
        assert torch.equal(got, ref) and torch.equal(got, pre)


def _fused_routes(k):
    """The routes ``int8_matmul_fused`` can take at depth K: the 128- and
    64-row A panels where they fit beside the weight ring, and both
    streamed."""
    from tfmq_dm_tpu_torch.ops import int8_kernels as I8
    out = [("stream", 128, I8.FUSED_BN), ("stream", 64, I8.FUSED_BN)]
    for bm in (128, 64):
        if I8.fused_smem("panel", bm, k) <= I8.SMEM_PER_SM:
            out.append(("panel", bm, I8.FUSED_BN))
    return out


@pytest.mark.parametrize("m,k,n", [(4096, 384, 3072), (130, 1152, 70),
                                   (77, 1536, 960), (97, 2304, 300),
                                   (257, 3840, 200)])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_cuda_int8_matmul_fused_routes_match_plain(cuda, m, k, n, x_dtype,
                                                   out_dtype):
    """Every route of the fused GEMM (the plan forced, each with 1 and 3
    groups of N tiles), with the K-major copy given: bit-equal to its
    plain version and to ``quantize_act_int8`` + ``int8_matmul_pre``."""
    from tfmq_dm_tpu_torch.ops import int8_kernels as I8
    from tfmq_dm_tpu_torch.ops import int_ops
    from tfmq_dm_tpu_torch.quant.quantizer import QCfg
    g = torch.Generator().manual_seed(m + k + n)
    x = (torch.randn(m, k, generator=g) * 1.5).to(x_dtype).to(cuda)
    w = _codes(g, (k, n), cuda)
    d = (torch.rand(n, generator=g) * 0.01 + 1e-3).to(cuda)
    z = torch.randint(-10, 10, (n,), generator=g).float().to(cuda)
    ws = w.to(torch.int32).sum(0).float()
    b = torch.randn(n, generator=g).to(cuda)
    dx, zx = torch.tensor(0.021, device=cuda), torch.tensor(-3.0, device=cuda)
    xq, zc = int_ops.quantize_act_int8(x, dx, zx + 128.0, QCfg(bits=8))
    xs = xq.to(torch.int32).sum(-1, keepdim=True).float()
    w_t = I8.kmajor(w)
    args = (x, w, d, z, ws, dx, zx, b)
    ref = I8.int8_matmul_fused_plain(*args, out_dtype=out_dtype)
    pre = I8.int8_matmul_pre(xq, xs, w, d, z, ws, dx, zc, b,
                             out_dtype=out_dtype, w_t=w_t)
    torch.cuda.synchronize()
    assert torch.equal(ref, pre)
    for route, bm, bn in _fused_routes(k):
        for groups in (1, 3):
            plan = (route, bm, bn, groups)
            with mock.patch.object(I8, "fused_plan", lambda *a, **kw: plan):
                copies = I8.KMAJOR_COPIES["int8_matmul_fused"]
                got = I8.int8_matmul_fused(*args, out_dtype=out_dtype,
                                           w_t=w_t)
                assert I8.KMAJOR_COPIES["int8_matmul_fused"] == copies
            torch.cuda.synchronize()
            assert got.dtype == out_dtype
            assert torch.equal(got, ref), plan


# ---------------------------------------------------------------------------
# gn_swish_quant_int8: codes within one level of the plain version
# ---------------------------------------------------------------------------

GN_SHAPES = [
    (8, 64, 64, 320, 1e-5, torch.bfloat16),     # SD v1.4, micro_gn
    (4, 8, 8, 1920, 1e-5, torch.bfloat16),      # cin256's widest concat
    (8, 4, 4, 512, 1e-6, torch.float32),        # CIFAR-10
    (2, 33, 17, 96, 1e-5, torch.bfloat16),      # hw 561: not % 512
    (3, 5, 7, 64, 1e-6, torch.float32)]


def _gn_forced(shape):
    """The plans forced on ``shape``: for each route and cluster size the
    plan function can take, the first such plan of ``gn_plans`` (where
    one fits); "auto" is ``gn_plan``'s pick."""
    from tfmq_dm_tpu_torch.ops import gn_kernels as G
    b, h, w, c, _, dt = shape
    item = 2 if dt == torch.bfloat16 else 4
    plans = G.gn_plans(b, h * w, c, 32, item)
    out = ["auto"]
    for route, sizes in (("resident", G.CLUSTERS), ("stream", (1, 2, 4, 8))):
        for k in sizes:
            cands = [p for p in plans if p[0] == route and p[2] == k]
            if cands:
                out.append(cands[0])
    return out


def _gn_args(cuda, b, h, w, c, dtype, use_ss):
    from tfmq_dm_tpu_torch.quant.quantizer import QCfg
    g = torch.Generator().manual_seed(b * h * w + c)
    x = (torch.randn(b, h, w, c, generator=g) * 1.5 + 0.3).to(dtype).to(cuda)
    gamma = (1 + 0.1 * torch.randn(c, generator=g)).to(cuda)
    beta = (0.1 * torch.randn(c, generator=g)).to(cuda)
    ss = tuple((0.1 * torch.randn(b, c, generator=g)).to(cuda)
               for _ in range(2)) if use_ss else None
    return (x, gamma, beta, torch.tensor(0.02, device=cuda),
            torch.tensor(117.0, device=cuda), QCfg(bits=8)), ss


def _gn_one_level(got, ref, x):
    torch.cuda.synchronize()
    diff = (got.int() - ref.int()).abs()
    assert got.dtype == torch.int8 and got.shape == x.shape
    assert int(diff.max()) <= 1 and float((diff > 0).float().mean()) < 1e-4


@pytest.mark.parametrize("b,h,w,c,eps,dtype,plan", [
    (*shape, plan) for shape in GN_SHAPES for plan in _gn_forced(shape)])
@pytest.mark.parametrize("swish,use_ss", [(True, False), (True, True),
                                          (False, False), (False, True)])
def test_cuda_gn_swish_quant_int8_matches_plain(cuda, b, h, w, c, eps, dtype,
                                                plan, swish, use_ss):
    """Each route and cluster size (the plan forced; "auto": the plan's
    pick): one launch a call, codes within one level of the plain
    version's on under 1e-4 of them, zp_c equal."""
    from tfmq_dm_tpu_torch.ops import gn_kernels as G
    args, ss = _gn_args(cuda, b, h, w, c, dtype, use_ss)
    kw = dict(eps=eps, do_swish=swish, ss=ss)
    forced = contextlib.nullcontext() if plan == "auto" else \
        mock.patch.object(G, "gn_plan", lambda *a, **k: plan)
    with forced:
        before = G.LAUNCHES["gn_swish_quant_int8"]
        got, gz = G.gn_swish_quant_int8(*args, **kw)
        assert G.LAUNCHES["gn_swish_quant_int8"] == before + 1
    ref, rz = G.gn_swish_quant_int8_plain(*args, **kw)
    _gn_one_level(got, ref, args[0])
    assert float(gz) == float(rz) == 117.0 - 128


def test_cuda_gn_reciprocal_is_correctly_rounded(cuda):
    """The kernel's reciprocal of 1 + exp(-y) (rcp.approx and one Newton
    step, no slow-path branch) equals __frcp_rn and IEEE division on every
    float in [1, 2^126)."""
    from tfmq_dm_tpu_torch.ops import gn_kernels as G
    assert G.rcp_mismatches() == 0


def test_cuda_gn_cluster_slots_hold_the_plan(cuda):
    """The card runs at least as many clusters of each size at once as
    the plan counts a wave (``CLUSTER_SLOTS``), at the most shared memory
    a resident block of a check shape takes."""
    from tfmq_dm_tpu_torch.ops import gn_kernels as G
    for k in G.CLUSTERS:
        assert G.cluster_slots(k, 200000) >= G.CLUSTER_SLOTS[k], k


@pytest.mark.parametrize("route", ["resident", "stream"])
def test_cuda_gn_swish_quant_int8_reruns_bit_identical(cuda, route):
    """Two calls give bit-identical codes: every sum runs in a fixed
    order, with no atomics (SD's 8x64x64x320, SiLU and scale-shift)."""
    from tfmq_dm_tpu_torch.ops import gn_kernels as G
    args, ss = _gn_args(cuda, 8, 64, 64, 320, torch.bfloat16, True)
    plan = G.gn_plan(8, 4096, 320, 32, 2)
    if route == "stream":
        plan = next(p for p in G.gn_plans(8, 4096, 320, 32, 2)
                    if p[0] == "stream" and p[2] == 8)
    with mock.patch.object(G, "gn_plan", lambda *a, **k: plan):
        first = G.gn_swish_quant_int8(*args, ss=ss)[0]
        second = G.gn_swish_quant_int8(*args, ss=ss)[0]
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("b,h,w,c,groups,dtype", [
    (1, 384, 384, 320, 32, torch.bfloat16),    # SD's channels at 384x384
    (1, 256, 256, 256, 32, torch.float32),
    (2, 5, 7, 27, 3, torch.bfloat16)])         # 18-byte slice rows
def test_cuda_gn_swish_quant_int8_stream_route_matches_plain(cuda, b, h, w,
                                                             c, groups,
                                                             dtype):
    """Shapes no cluster's shared memory can hold a slice of take the
    stream route (its plan unforced): one launch a call, the one-level
    rule, two calls bit-identical."""
    from tfmq_dm_tpu_torch.ops import gn_kernels as G
    assert G.gn_plan(b, h * w, c, groups, 2 if dtype == torch.bfloat16
                     else 4)[0] == "stream"
    args, ss = _gn_args(cuda, b, h, w, c, dtype, True)
    kw = dict(groups=groups, ss=ss)
    before = G.LAUNCHES["gn_swish_quant_int8"]
    got, gz = G.gn_swish_quant_int8(*args, **kw)
    assert G.LAUNCHES["gn_swish_quant_int8"] == before + 1
    ref, rz = G.gn_swish_quant_int8_plain(*args, **kw)
    _gn_one_level(got, ref, args[0])
    assert float(gz) == float(rz)
    assert torch.equal(got, G.gn_swish_quant_int8(*args, **kw)[0])


def test_cuda_fused_wrappers_reject_bad_inputs(cuda):
    from tfmq_dm_tpu_torch.ops import gn_kernels as G
    from tfmq_dm_tpu_torch.ops import int8_kernels as I8
    from tfmq_dm_tpu_torch.quant.quantizer import QCfg
    w = torch.zeros(64, 32, dtype=torch.int8, device=cuda)
    v = torch.zeros(32, device=cuda)
    with pytest.raises(ValueError, match="x dtype"):
        I8.int8_matmul_fused(torch.zeros(4, 64, device=cuda).half(), w, v,
                             v, v, 0.1, 0.0)
    with pytest.raises(ValueError, match="w: expected"):
        I8.int8_matmul_fused(torch.zeros(4, 64, device=cuda), w[:32], v, v,
                             v, 0.1, 0.0)
    x = torch.zeros(1, 4, 4, 48, device=cuda)
    with pytest.raises(ValueError, match="48 channels in 32 groups"):
        G.gn_swish_quant_int8(x, torch.ones(48), torch.zeros(48), 0.1, 0.0,
                              QCfg(bits=8))


# ---------------------------------------------------------------------------
# weight-phase reconstruction on the card against the same call on the CPU
# ---------------------------------------------------------------------------

RECON_LOSS_REL, RECON_HARD_EQUAL = 1e-4, 0.999


def _tiny_ddim_params(g):
    from tfmq_dm_tpu_torch.models import ddim_unet as T
    params = {}
    for kind, name, shape in T.iter_layers(T.tiny_config()):
        if kind == "norm":
            params[name] = {"scale": 1 + 0.1 * torch.randn(shape, generator=g),
                            "bias": 0.1 * torch.randn(shape, generator=g)}
            continue
        bound = float(torch.tensor(shape[:-1]).prod()) ** -0.5
        params[name] = {
            "w": (torch.rand(shape, generator=g) * 2 - 1) * bound,
            "b": (torch.rand(shape[-1:], generator=g) * 2 - 1) * bound}
    return params


@pytest.mark.parametrize("name", ["down.1.block.0", "tib"])
def test_cuda_reconstruct_unit_matches_cpu(cuda, name):
    """``reconstruct_unit`` (40 iterations, a fixed minibatch sequence) on
    the card and on the CPU from the same cached I/O: the loss at every
    iteration within 1e-4 relative, the hardened alphas equal on >= 99.9%
    of elements, the same guard decision, every result on the card (TF32
    off: the f32 convolutions are true f32; no step falls back)."""
    from tfmq_dm_tpu_torch.models import ddim_unet as T
    from tfmq_dm_tpu_torch.models import ddim_units as TU
    from tfmq_dm_tpu_torch.quant import recon as R

    g = torch.Generator().manual_seed(0)
    params = _tiny_ddim_params(g)
    cali = (torch.randn((16, 16, 16, 3), generator=g),
            torch.randint(0, 100, (16,), generator=g, dtype=torch.int32))
    adapter = TU.build_adapter(T.tiny_config(), w_bits=4, a_bits=8)
    wstate = R.init_weight_qparams(adapter.policy, params, scaler="minmax")
    unit = adapter.unit_by_name(name)
    fp_out = None if name == "tib" else R.precapture_fp_outs(
        adapter, [name], params, cali, batch_size=8)[name]
    inputs, outputs = R.capture_unit_io(adapter, unit, params, cali, wstate,
                                        fp_out, batch_size=8)
    hp = R.ReconHP(iters=40, batch_size=8)
    idx = torch.stack([torch.randperm(16, generator=g)[:8]
                       for _ in range(hp.iters)])

    def on(dev, tree):
        if isinstance(tree, dict):
            return {k: on(dev, v) for k, v in tree.items()}
        if isinstance(tree, tuple):
            return tuple(on(dev, v) for v in tree)
        return tree.to(dev)

    runs = {}
    for dev in ("cpu", cuda):
        stats = {}
        w2, losses = R.reconstruct_unit(
            adapter, unit, on(dev, params), on(dev, wstate),
            on(dev, inputs), on(dev, outputs), hp, stats=stats,
            indices=lambda u, n, bs, it: idx)
        runs[str(dev)] = (w2, losses, stats[name])
    (wc, lc, sc), (wg, lg, sg) = runs["cpu"], runs[str(cuda)]
    assert lg.device.type == "cuda"
    assert torch.all((lg.cpu() - lc).abs() <= RECON_LOSS_REL * lc.abs())
    assert sg["kept"] == sc["kept"]
    eq = tot = 0
    for _, full in unit.layers:
        if "alpha" in wc.get(full, {}):
            assert wg[full]["alpha"].device.type == "cuda"
            a, b = wc[full]["alpha"] >= 0, wg[full]["alpha"].cpu() >= 0
            eq += int((a == b).sum())
            tot += a.numel()
    assert tot > 0 and eq / tot >= RECON_HARD_EQUAL
