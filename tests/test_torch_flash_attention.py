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
"""

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


def _both(fn_kwargs_j, fn_kwargs_t, q, k, v, sm):
    j = np.asarray(j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           sm_scale=sm, interpret=True, **fn_kwargs_j))
    t = TF.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), sm_scale=sm,
                           **fn_kwargs_t).numpy()
    return j, t


SHAPES = [(256, 256, 2, 40), (130, 130, 2, 40), (130, 77, 1, 384)]


@pytest.mark.parametrize("tq,tk,h,d", SHAPES)
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


@pytest.mark.parametrize("tq,tk,h,d", SHAPES)
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
