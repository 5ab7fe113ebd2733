"""The port's flash-attention plain versions and the flash dispatch of
``qsm_attention`` against the JAX package on the same numpy inputs.

On the CPU the port's wrappers take their plain versions (the CUDA
kernels are held against those on the card, tests/test_torch_cuda_
kernels.py); the JAX side runs its Pallas kernels in interpret mode, as
tests/test_flash_attention.py does.

Tolerances. Without a softmax quantizer the two differ in f32 summation
order only: 2e-5 of the output's largest magnitude. With one, the JAX
tests' one-level rule (tests/test_flash_attention.py:71-79): the online
denominator of the Pallas kernel and the materialized one differ in the
last bits, so a quantized probability at a rounding boundary may flip by
one level: under 0.5% of outputs off by more than 1e-5, none by more than
6 levels. The 16-bit softmax route keeps the JAX test's own limit for it
(5e-3, tests/test_flash_attention.py:351-390), since a level there is
1/65535 and a one-level flip exceeds 1e-5.

Mode fqk (the bf16 fast deploy) returns bf16: the same one-level rule with
a softmax quantizer, and without one under 0.5% of outputs off, none by
more than one bf16 ulp at the output's largest magnitude (2^-7 of it);
measured bit-equal to JAX's interpreted kernel but for one bf16 ulp in
one output. The key-block tests (JAX ``block_k=128`` at Tk 256: two key
blocks, each rounded against its own running max and rebased) keep the
same rules.
"""

from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfmq_dm_tpu.ops import attention as j_attn
from tfmq_dm_tpu.ops.flash_attention import flash_attention as j_flash
from tfmq_dm_tpu.quant.context import QuantCtx as JCtx
from tfmq_dm_tpu.quant.policy import LayerPolicy as JLP
from tfmq_dm_tpu.quant.policy import QuantPolicy as JPol
from tfmq_dm_tpu.quant.quantizer import QCfg as JQCfg
from tfmq_dm_tpu_torch.ops import attention as t_attn
from tfmq_dm_tpu_torch.ops import flash_attention as TF
from tfmq_dm_tpu_torch.quant.context import QuantCtx as TCtx
from tfmq_dm_tpu_torch.quant.policy import LayerPolicy as TLP
from tfmq_dm_tpu_torch.quant.policy import QuantPolicy as TPol
from tfmq_dm_tpu_torch.quant.quantizer import QCfg as TQCfg

REL_TOL = 2e-5
GRIDS = ((0.031, 130.0), (0.029, 120.0), (0.033, 125.0))


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _assert_close(got, ref):
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, rtol=0, atol=REL_TOL * scale)


def _assert_one_level(got, ref, level):
    d = np.abs(got - ref)
    assert np.mean(d > 1e-5) < 0.005, f"{np.mean(d > 1e-5):.4%} mismatch"
    assert d.max() <= 6.0 * level, d.max()


def _assert_bf16_close(got, ref, level=None):
    """bf16 outputs: the one-level rule with a softmax quantizer, else
    under 0.5% of outputs off and none by more than 2^-7 of the largest."""
    d = np.abs(got - ref)
    assert np.mean(d > 1e-5) < 0.005, f"{np.mean(d > 1e-5):.4%} mismatch"
    scale = float(np.abs(ref).max())
    assert d.max() <= max(2.0 ** -7 * scale,
                          0.0 if level is None else 6.0 * level), d.max()


def _both(fn_kwargs_j, fn_kwargs_t, q, k, v, sm):
    j = np.asarray(j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           sm_scale=sm, interpret=True, **fn_kwargs_j))
    t = TF.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), sm_scale=sm,
                           **fn_kwargs_t).numpy()
    return j, t


SHAPES = [(256, 256, 2, 40), (130, 130, 2, 40), (130, 77, 1, 384)]
# and the other head-dim templates of the tensor-core fp and int8 kernels
# (d 64, 80, 160), at a ragged Tk
WIDE_SHAPES = SHAPES + [(130, 77, 1, 64), (100, 77, 1, 80),
                        (64, 77, 1, 160)]


@pytest.mark.parametrize("tq,tk,h,d", WIDE_SHAPES)
def test_flash_fp_plain_matches_jax(tq, tk, h, d):
    rng = np.random.default_rng(tq + d)
    q, k, v = _rand(rng, 2, h, tq, d), _rand(rng, 2, h, tk, d), \
        _rand(rng, 2, h, tk, d)
    j, t = _both({}, {}, q, k, v, d ** -0.5)
    _assert_close(t, j)


@pytest.mark.parametrize("tq,tk,h,d", SHAPES)
@pytest.mark.parametrize("dz,zp_zero", [((1 / 255.0, 0.0), True),
                                        ((0.004, 3.0), False)])
def test_flash_pquant_plain_matches_jax(tq, tk, h, d, dz, zp_zero):
    rng = np.random.default_rng(tq + d + 1)
    q, k, v = _rand(rng, 1, h, tq, d), _rand(rng, 1, h, tk, d), \
        _rand(rng, 1, h, tk, d)
    pj = tuple(jnp.float32(a) for a in dz)
    pt = tuple(torch.tensor(a, dtype=torch.float32) for a in dz)
    j, t = _both(dict(p_quant=pj, qrange=(0, 255), p_always_zero=zp_zero),
                 dict(p_quant=pt, qrange=(0, 255), p_always_zero=zp_zero),
                 q, k, v, d ** -0.5)
    _assert_one_level(t, j, dz[0])


@pytest.mark.parametrize("tq,tk,h,d", WIDE_SHAPES)
@pytest.mark.parametrize("pw", [None, (1 / 255.0, 0.0), (0.004, 3.0)])
def test_flash_int8_plain_matches_jax(tq, tk, h, d, pw):
    rng = np.random.default_rng(tq + d + 2)
    q, k, v = _rand(rng, 1, h, tq, d), _rand(rng, 1, h, tk, d), \
        _rand(rng, 1, h, tk, d)
    kw = dict(qrange=None if pw is None else (0, 255))
    j, t = _both(
        dict(kw, qkv_quant=tuple(tuple(jnp.float32(a) for a in g)
                                 for g in GRIDS),
             p_quant=None if pw is None else
             tuple(jnp.float32(a) for a in pw)),
        dict(kw, qkv_quant=tuple(tuple(torch.tensor(a) for a in g)
                                 for g in GRIDS),
             p_quant=None if pw is None else
             tuple(torch.tensor(a) for a in pw)),
        q, k, v, d ** -0.5)
    if pw is None:
        _assert_close(t, j)
    else:
        _assert_one_level(t, j, pw[0])


# a v grid with a fractional zero point: (v' - zv') is no integer, so the
# int8 kernel's P @ V without a softmax quantizer splits it for TF32
FRAC_GRIDS = GRIDS[:2] + ((0.033, 125.37),)


def _int8_jax(q, k, v, grids, sm):
    return np.asarray(j_flash(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), sm_scale=sm,
        interpret=True, qkv_quant=tuple(tuple(jnp.float32(a) for a in g)
                                        for g in grids)))


@pytest.mark.parametrize("d", [40, 384])
def test_flash_int8_plain_fractional_zv_matches_jax(d):
    """No softmax quantizer, v zero point 125.37: the plain version (p f32
    against dv (v' - zv')) against JAX's interpreted ``_int8_kernel``."""
    rng = np.random.default_rng(d + 9)
    q, k, v = (_rand(rng, 1, 2, t, d) for t in (130, 77, 77))
    j = _int8_jax(q, k, v, FRAC_GRIDS, d ** -0.5)
    t = TF.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        sm_scale=d ** -0.5,
        qkv_quant=tuple(tuple(torch.tensor(a) for a in g)
                        for g in FRAC_GRIDS)).numpy()
    _assert_close(t, j)


@pytest.mark.parametrize("grids", [GRIDS, FRAC_GRIDS])
@pytest.mark.parametrize("d", [40, 160])
def test_int8_tf32_pv_route_matches_jax(grids, d):
    """The int8 kernel's P @ V without a softmax quantizer, in PyTorch ops:
    p = exp(s - m) split hi + lo (``tf32_split``) against (v' - zv'), an
    exact integer for an integer zv (two products) or split hi + lo too
    (three: hi.hi + hi.lo + lo.hi), products exact in float64, dv and 1/l
    applied per output. Within REL_TOL of JAX's interpreted kernel, which
    rounds dv (v' - zv') per element."""
    rng = np.random.default_rng(d + 10)
    q, k, v = (_rand(rng, 1, 2, t, d) for t in (130, 77, 77))
    j = _int8_jax(q, k, v, grids, d ** -0.5)
    qkv = tuple(tuple(torch.tensor(a) for a in g) for g in grids)
    flat = [torch.from_numpy(x).reshape(2, -1, d) for x in (q, k, v)]
    q8, k8, v8, qsum, ksum, _ = TF.int8_operands(*flat, qkv,
                                                 ((0, 255),) * 3)
    sc = torch.tensor([a for g in grids for a in g] + [1.0, 0.0])
    s = TF._int8_scores(q8, k8, qsum, ksum, sc, d ** -0.5)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    ph, pl = TF.tf32_split(p)
    vz = v8.float() - (sc[5] - 128.0)
    if float(sc[5]) == round(float(sc[5])):
        assert torch.equal(TF.tf32_split(vz)[0], vz)   # exact in TF32
        acc = ph.double() @ vz.double() + pl.double() @ vz.double()
    else:
        vh, vl = TF.tf32_split(vz)
        acc = ph.double() @ vh.double() + (ph.double() @ vl.double()
                                           + pl.double() @ vh.double())
    out = (sc[4] * acc.float()) / p.sum(dim=-1, keepdim=True)
    _assert_close(out.reshape(1, 2, 130, d).numpy(), j)


@pytest.mark.parametrize("tk,d,dp,tkp", [(77, 40, 64, 128),
                                         (1000, 64, 64, 1024),
                                         (130, 80, 96, 192),
                                         (4096, 160, 160, 4096),
                                         (1024, 384, 384, 1024)])
def test_int8_vt_plain_transposes_jax_codes(tk, d, dp, tkp):
    """The int8 kernel's pre-pass layout (``int8_scratch``,
    ``int8_vt_plain``): JAX's v codes (``_quant_i8``) transposed to
    (B*H, DP, Tkp), DP the head dim padded to the kernel's template
    width, Tkp the keys rounded up to 64, zero in the padding."""
    from tfmq_dm_tpu.ops.flash_attention import _quant_i8
    rng = np.random.default_rng(tk + d)
    v = _rand(rng, 2, tk, d) * 3
    j8 = np.array(_quant_i8(jnp.asarray(v), jnp.float32(0.033),
                            jnp.float32(125.0), 0.0, 255.0))
    got_dp, got_tkp, vt = TF.int8_scratch(2, tk, d, torch.device("cpu"))
    assert (got_dp, got_tkp) == (dp, tkp)
    assert vt.shape == (2, dp, tkp) and vt.dtype == torch.int8
    vt = TF.int8_vt_plain(torch.from_numpy(j8)).numpy()
    assert vt.shape == (2, dp, tkp)
    np.testing.assert_array_equal(vt[:, :d, :tk], j8.transpose(0, 2, 1))
    assert not vt[:, d:].any() and not vt[:, :, tk:].any()


def test_int8_operands_match_jax_quantizer():
    """The codes and row sums the int8 kernel reads are the JAX ones."""
    from tfmq_dm_tpu.ops.flash_attention import _quant_i8
    rng = np.random.default_rng(5)
    x = _rand(rng, 2, 100, 40) * 3
    got = TF.quant_i8(torch.from_numpy(x), torch.tensor(0.031),
                      torch.tensor(130.0), (0, 255)).numpy()
    ref = np.asarray(_quant_i8(jnp.asarray(x), jnp.float32(0.031),
                               jnp.float32(130.0), 0.0, 255.0))
    np.testing.assert_array_equal(got, ref)


# ---------------------------------------------------------------------------
# qsm_attention with flash forced on both sides
# ---------------------------------------------------------------------------

@pytest.fixture
def flash_on():
    j_attn.set_flash("on")
    t_attn.set_flash("on")
    try:
        yield
    finally:
        j_attn.set_flash("auto")
        t_attn.set_flash("auto")


def _ctxs(softmax_bits):
    """A JAX and a port QuantCtx over four act sites q/k/v/w with the same
    per-tensor grids; the w grid has ``softmax_bits`` bits."""
    a, w = dict(bits=8), dict(bits=softmax_bits, always_zero=True)
    dw = 1.0 / (2 ** softmax_bits - 1)
    states = {"q": GRIDS[0], "k": GRIDS[1], "v": GRIDS[2], "w": (dw, 0.0)}
    out = []
    for QC, LP, Pol, Ctx, cast in (
            (JQCfg, JLP, JPol, JCtx, jnp.float32),
            (TQCfg, TLP, TPol, TCtx,
             lambda x: torch.tensor(x, dtype=torch.float32))):
        pol = Pol({s: LP(w_cfg=None, a_cfg=QC(**(w if s == "w" else a)),
                         wq=False, aq=True) for s in states}, order=[])
        ast = {s: {"delta": cast(d), "zp": cast(z)}
               for s, (d, z) in states.items()}
        out.append(Ctx(pol, astate=ast, use_aq=True, flash=True))
    return out


@pytest.mark.parametrize("with_ctx,softmax_bits", [(False, 8), (True, 8),
                                                   (True, 16)])
def test_qsm_attention_flash_dispatch_matches_jax(flash_on, with_ctx,
                                                  softmax_bits):
    """FP (qctx None: mode fp), scalar 8-bit grids (mode int8 with the
    softmax quantizer) and a 16-bit softmax grid (q/k/v fake-quantized
    elementwise, then mode pquant)."""
    rng = np.random.default_rng(softmax_bits + with_ctx)
    q, k, v = (_rand(rng, 2, 130, 2, 40) for _ in range(3))
    sites = {"q": "q", "k": "k", "v": "v", "w": "w"}
    jctx, tctx = _ctxs(softmax_bits) if with_ctx else (None, None)
    j = np.asarray(j_attn.qsm_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 40 ** -0.5, jctx,
        sites))
    before = dict(TF.LAUNCHES)
    t = t_attn.qsm_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), 40 ** -0.5, tctx,
                             sites).numpy()
    assert TF.LAUNCHES == before      # CPU tensors: plain versions
    if not with_ctx:
        _assert_close(t, j)
    elif softmax_bits == 8:
        _assert_one_level(t, j, 1 / 255.0)
    else:
        np.testing.assert_allclose(t, j, atol=5e-3, rtol=5e-3)


def test_flash_auto_stays_materialized_on_cpu():
    """"auto" takes flash only for CUDA tensors with Tk >= MIN_FLASH_KV."""
    assert t_attn.MIN_FLASH_KV == j_attn.MIN_FLASH_KV == 1024
    cpu = torch.device("cpu")
    assert not t_attn._flash_ok(None, 4096, cpu)
    assert t_attn._flash_ok(None, 4096, torch.device("cuda"))
    assert not t_attn._flash_ok(None, 256, torch.device("cuda"))
    tctx = _ctxs(8)[1]
    tctx.act_mode = "init"
    assert not t_attn._flash_ok(tctx, 4096, torch.device("cuda"))


# ---------------------------------------------------------------------------
# mode fqk and the key blocks of the softmax quantizer
# ---------------------------------------------------------------------------

def _bf16(rng, *shape):
    """bf16 values in both frameworks' bf16 types."""
    x = jnp.asarray(_rand(rng, *shape)).astype(jnp.bfloat16)
    return x, torch.from_numpy(np.array(x.astype(jnp.float32))).to(
        torch.bfloat16)


FQK_CASES = [  # (tq, tk, h, d, block_k, JAX block_q)
    (256, 256, 2, 40, 128, None),     # two key blocks
    (300, 300, 1, 48, 128, 128),      # three q-blocks (JAX scratch reuse)
    (130, 77, 1, 64, None, None),     # ragged, Tk != Tq
    (130, 77, 2, 40, 2048, None),     # one key block past a ragged Tk
    (64, 300, 1, 384, 128, None)]     # cin256's head dim, ragged key block
P_MODES = [(None, False, False), ((1 / 255.0, 0.0), True, False),
           ((0.004, 3.0), False, False), ((1 / 255.0, 0.0), True, True),
           ((0.004, 3.0), False, True)]


@pytest.mark.parametrize("tq,tk,h,d,block_k,block_q", FQK_CASES)
@pytest.mark.parametrize("pw,zp_zero,int8_pv", P_MODES)
def test_flash_fqk_plain_matches_jax(tq, tk, h, d, block_k, block_q, pw,
                                     zp_zero, int8_pv):
    """Mode fqk against JAX's ``flash_attention(..., int8_matmul=False,
    interpret=True)`` in bf16: without and with the softmax quantizer
    (always-zero and not), and ``int8_pv`` against ``int8_pv=True``."""
    rng = np.random.default_rng(tq + tk + d)
    (jq, tq_), (jk, tk_), (jv, tv_) = (_bf16(rng, 1, h, t, d)
                                       for t in (tq, tk, tk))
    common = dict(sm_scale=d ** -0.5, int8_matmul=False, block_k=block_k,
                  p_always_zero=zp_zero, int8_pv=int8_pv)
    j = jnp.asarray(j_flash(
        jq, jk, jv, interpret=True, block_q=block_q,
        qkv_quant=tuple(tuple(jnp.float32(a) for a in g) for g in GRIDS),
        p_quant=None if pw is None else tuple(jnp.float32(a) for a in pw),
        **common).astype(jnp.float32))
    t = TF.flash_attention(
        tq_, tk_, tv_,
        qkv_quant=tuple(tuple(torch.tensor(a) for a in g) for g in GRIDS),
        p_quant=None if pw is None else tuple(torch.tensor(a) for a in pw),
        **common)
    assert t.dtype == torch.bfloat16
    _assert_bf16_close(t.float().numpy(), np.asarray(j),
                       None if pw is None else pw[0])


@pytest.mark.parametrize("mode", ["pquant", "int8"])
@pytest.mark.parametrize("pw", [(1 / 255.0, 0.0), (0.004, 3.0)])
def test_flash_key_blocks_match_jax(mode, pw):
    """Tk 256 at ``block_k=128``: the softmax quantizer's levels of each
    key block against that block's running max, rebased (Pallas
    flash_attention.py:134-163 and :330-368), in modes pquant and int8."""
    rng = np.random.default_rng(17)
    q, k, v = (_rand(rng, 1, 2, 256, 40) for _ in range(3))
    kw = dict(qrange=(0, 255), block_k=128, p_always_zero=pw[1] == 0.0)
    jkw, tkw = dict(kw), dict(kw)
    jkw["p_quant"] = tuple(jnp.float32(a) for a in pw)
    tkw["p_quant"] = tuple(torch.tensor(a) for a in pw)
    if mode == "int8":
        jkw["qkv_quant"] = tuple(tuple(jnp.float32(a) for a in g)
                                 for g in GRIDS)
        tkw["qkv_quant"] = tuple(tuple(torch.tensor(a) for a in g)
                                 for g in GRIDS)
    j, t = _both(jkw, tkw, q, k, v, 40 ** -0.5)
    _assert_one_level(t, j, pw[0])


def _fast_ctxs(softmax_bits=8):
    """Deployed JAX and port contexts with bf16 carriers (the fast
    deploy) over act sites q/k/v/w."""
    out = []
    for ctx, cast, dt in zip(_ctxs(softmax_bits),
                             (jnp.float32, lambda x: x),
                             (jnp.bfloat16, torch.bfloat16)):
        ctx.deploy = {}
        ctx.act_out_dtype = dt
        out.append(ctx)
    return out


def test_fast_deploy_dispatch_takes_fqk(flash_on):
    """qsm_attention in the fast deploy with flash on: mode fqk on both
    sides (attention.py:198-227), bf16 out."""
    rng = np.random.default_rng(3)
    (jq, tq_), (jk, tk_), (jv, tv_) = (_bf16(rng, 1, 140, 2, 40)
                                       for _ in range(3))
    jctx, tctx = _fast_ctxs()
    sites = {"q": "q", "k": "k", "v": "v", "w": "w"}
    j = np.asarray(j_attn.qsm_attention(jq, jk, jv, 40 ** -0.5, jctx,
                                        sites).astype(jnp.float32))
    with mock.patch.object(TF, "flash_fqk_plain",
                           wraps=TF.flash_fqk_plain) as fqk:
        t = t_attn.qsm_attention(tq_, tk_, tv_, 40 ** -0.5, tctx, sites)
    assert fqk.call_count == 1 and t.dtype == torch.bfloat16
    _assert_bf16_close(t.float().numpy(), j, 1 / 255.0)


def test_fast_deploy_skips_int8_materialized():
    """Below the flash gate the fast deploy takes the fake-quant
    materialized path with bf16 operands, the exact deploy
    ``_int8_materialized`` (tests/test_flash_attention.py:206)."""
    rng = np.random.default_rng(4)
    (jq, tq_), (jk, tk_), (jv, tv_) = (_bf16(rng, 2, 64, 1, 32)
                                       for _ in range(3))
    sites = {"q": "q", "k": "k", "v": "v", "w": "w"}
    jctx, tctx = _fast_ctxs()
    j = np.asarray(j_attn.qsm_attention(jq, jk, jv, 32 ** -0.5, jctx,
                                        sites).astype(jnp.float32))
    with mock.patch.object(t_attn, "_int8_materialized",
                           wraps=t_attn._int8_materialized) as spy:
        fast = t_attn.qsm_attention(tq_, tk_, tv_, 32 ** -0.5, tctx, sites)
        assert spy.call_count == 0 and fast.dtype == torch.bfloat16
        exact_ctx = _ctxs(8)[1]
        exact_ctx.deploy = {}
        t_attn.qsm_attention(tq_.float(), tk_.float(), tv_.float(),
                             32 ** -0.5, exact_ctx, sites)
        assert spy.call_count == 1
    _assert_bf16_close(fast.float().numpy(), j, 1 / 255.0)


def test_flash_off_under_capture_tape():
    """JAX's flash gate also requires no capture tape
    (tfmq_dm_tpu/ops/attention.py:78)."""
    tctx = _ctxs(8)[1]
    assert t_attn._flash_ok(tctx, 4096, torch.device("cuda"))
    tctx.capture = frozenset({"*"})
    assert not t_attn._flash_ok(tctx, 4096, torch.device("cuda"))


# ---------------------------------------------------------------------------
# the fqk pre-pass: k/v fake-quantized once per head
# ---------------------------------------------------------------------------

PREPASS_RANGES = ((0, 255), (0, 255), (0, 255))


def _fqk_sc(pw=(1 / 255.0, 0.0)):
    return torch.tensor([a for g in GRIDS for a in g] + list(pw),
                        dtype=torch.float32)


@pytest.mark.parametrize("tk,d", [(77, 40), (1000, 384)])
@pytest.mark.parametrize("ranges", [PREPASS_RANGES,
                                    ((0, 255), (10, 240), (3, 200))])
def test_fqk_prepass_plain_matches_jax(tk, d, ranges):
    """``fqk_prepass_plain`` bit for bit against JAX's ``_fq`` and
    ``_quant_i8`` (flash_attention.py:64-76) at a ragged Tk: bf16 K and V,
    and the centered v codes transposed with their column sums over the
    real keys."""
    from tfmq_dm_tpu.ops.flash_attention import _fq, _quant_i8
    rng = np.random.default_rng(tk + d)
    (jk, tk_), (jv, tv_) = (_bf16(rng, 2, tk, d) for _ in range(2))
    (dk, zk), (dv, zv) = GRIDS[1], GRIDS[2]
    sc = _fqk_sc()
    kf, vf = TF.fqk_prepass_plain(tk_, tv_, sc, ranges)
    assert kf.dtype == vf.dtype == torch.bfloat16

    def f32(x):
        return np.asarray(x.astype(jnp.float32))

    j_kf = _fq(jk, jnp.float32(dk), jnp.float32(zk), *ranges[1],
               jnp.bfloat16)
    j_vf = _fq(jv, jnp.float32(dv), jnp.float32(zv), *ranges[2],
               jnp.bfloat16)
    np.testing.assert_array_equal(kf.float().numpy(), f32(j_kf))
    np.testing.assert_array_equal(vf.float().numpy(), f32(j_vf))
    kf8, vt, vsum = TF.fqk_prepass_plain(tk_, tv_, sc, ranges, True)
    assert torch.equal(kf8, kf)
    j8 = np.asarray(_quant_i8(jv, jnp.float32(dv), jnp.float32(zv),
                              *ranges[2]))
    assert vt.shape == (2, d, tk) and vt.dtype == torch.int8
    np.testing.assert_array_equal(vt.numpy(), j8.transpose(0, 2, 1))
    assert vsum.dtype == torch.int32
    np.testing.assert_array_equal(vsum.numpy(),
                                  j8.astype(np.int32).sum(axis=1))


@pytest.mark.parametrize("tk,d,int8_pv,dp,tkp", [
    (1000, 40, False, 48, 1024), (4096, 384, True, 384, 4096),
    (77, 64, True, 80, 128), (130, 160, False, 160, 192)])
def test_fqk_scratch_pads_keys_and_head_dim(tk, d, int8_pv, dp, tkp):
    """The pre-pass scratch: head dim padded to the kernel's template
    width, keys to a multiple of 64; int8_pv's codes transposed, with one
    column-sum row per 64 keys."""
    got_dp, got_tkp, (kf, vf, vt, vpart) = TF.fqk_scratch(
        3, tk, d, int8_pv, torch.device("cpu"))
    assert (got_dp, got_tkp) == (dp, tkp)
    assert kf.shape == (3, tkp, dp) and kf.dtype == torch.bfloat16
    if int8_pv:
        assert vf is None and vt.shape == (3, dp, tkp)
        assert vpart.shape == (3, tkp // 64, dp)
        assert vpart.dtype == torch.int32
    else:
        assert vt is None and vpart is None and vf.shape == kf.shape


# ---------------------------------------------------------------------------
# the pquant kernel's TF32 splits, emulated in PyTorch ops
# ---------------------------------------------------------------------------

def _low13(t):
    return int((t.view(torch.int32) & 0x1FFF).abs().max())


@pytest.mark.parametrize("spread", [0.0, 6.0])
def test_tf32_split_reconstructs_f32_operands(spread):
    """x = hi + lo to 2^-23 of |x| (what the kernel's S = hi.hi + hi.lo +
    lo.hi rests on), both parts TF32 values (13 low bits zero), over a
    narrow and a wide exponent range."""
    rng = np.random.default_rng(int(spread))
    x = torch.from_numpy((rng.standard_normal(200000) * np.exp(
        rng.standard_normal(200000) * spread)).astype(np.float32))
    hi, lo = TF.tf32_split(x)
    assert _low13(hi) == 0 and _low13(lo) == 0
    r = (x.double() - hi.double() - lo.double()).abs()
    assert bool((r <= 2.0 ** -23 * x.double().abs()).all())


def test_tf32_split_levels_exact():
    """Every level of the 16-bit softmax grid, signed as (p_q - zp) with a
    non-zero zp, is hi + lo exactly with both parts TF32 values; levels of
    the 8-bit grid need no lo part."""
    levels = torch.arange(-65535 - 255, 65536 + 255).float()
    hi, lo = TF.tf32_split(levels)
    assert torch.equal(hi + lo, levels)
    assert _low13(hi) == 0 and _low13(lo) == 0
    hi8, lo8 = TF.tf32_split(torch.arange(-2048, 2049).float())
    assert torch.equal(hi8, torch.arange(-2048, 2049).float())
    assert not bool(lo8.any())


@pytest.mark.parametrize("d", [40, 384])
def test_3xtf32_scores_match_jax(d):
    """S from the split operands, hi.hi + (hi.lo + lo.hi) with exact
    products, against JAX's f32 q k^T on the same inputs: within 2^-20 of
    sum |q||k| (the kernel's own error is at most 3 2^-23 of it; JAX's f32
    sum adds its rounding)."""
    rng = np.random.default_rng(d)
    q = rng.standard_normal((64, d)).astype(np.float32)
    k = rng.standard_normal((96, d)).astype(np.float32)
    (qh, ql), (kh, kl) = (TF.tf32_split(torch.from_numpy(a))
                          for a in (q, k))
    qh, ql, kh, kl = (t.double() for t in (qh, ql, kh, kl))
    s3 = (qh @ kh.T + (qh @ kl.T + ql @ kh.T)).numpy()
    j = np.asarray(jnp.asarray(q) @ jnp.asarray(k).T, np.float64)
    bound = np.abs(q).astype(np.float64) @ np.abs(k).T.astype(np.float64)
    assert np.all(np.abs(s3 - j) <= 2.0 ** -20 * bound)
