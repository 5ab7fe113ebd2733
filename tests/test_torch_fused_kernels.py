"""The port's last two kernel modules against the JAX package on the CPU,
on inputs made from a numpy seed, and the checkpoint loader's fault with
Lightning checkpoints.

- ``int8_matmul_fused`` (plain version) against JAX's ``int8_matmul_fused``
  with Pallas in interpret mode, at tests/test_pallas_kernels.py's shapes:
  bit-equal. Both shapes take one K block (the Pallas kernel adds each K
  block's int32 product into an f32 scratch, exact only below 2^24). XLA
  on the CPU contracts the interpreted epilogue's ``(dx dw) corr + b``
  into a fused multiply-add; the port rounds the product and the sum one
  by one, as ``int8_matmul_pre`` does and as the kernel is written, so
  the JAX reference is compiled with XLA's fusion pass off (each op
  rounds as written). Then the plain version against
  ``int8_matmul_pre_plain`` on ``quantize_act_int8``'s codes at K > 1024:
  bit-equal (the fused GEMM is a drop-in for that pair).
- ``gn_swish_quant_int8`` (plain version) against JAX's with
  ``interpret=True`` at the four cases of tests/test_pallas_kernels.py
  and at cin256's widest GroupNorm: codes at most one level apart on
  under 1e-4 of them (the JAX test's rule), ``zp_c`` equal. Measured: one
  level on 1 of 655360 codes (1.5e-6) at (2, 32, 32, 320) and on 2 of
  245760 (8.1e-6) at (2, 8, 8, 1920), none elsewhere; the column sums run
  in another order.
- The micro_gn twin's ``main`` on the CPU at a small shape.
- A Lightning-style checkpoint that pickles a ``callbacks`` entry and
  ``hyper_parameters`` of classes outside PyTorch (a dict subclass holding
  a numpy array): the JAX loader and the port's give the same weights (the
  port refused such a file before).
"""

import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from tfmq_dm_tpu.configs import tasks as jtasks
from tfmq_dm_tpu.models import ldm_unet as JL
from tfmq_dm_tpu.models import vae as JV
from tfmq_dm_tpu.ops import pallas_kernels as pk
from tfmq_dm_tpu.pipelines import loading as jload
from tfmq_dm_tpu.quant.quantizer import QCfg as JQCfg
from tfmq_dm_tpu.utils.torch_convert import export_state_dict as j_export
from tfmq_dm_tpu_torch.configs import tasks as ttasks
from tfmq_dm_tpu_torch.ops import gn_kernels as G
from tfmq_dm_tpu_torch.ops import int8_kernels as I8
from tfmq_dm_tpu_torch.ops import int_ops as ti
from tfmq_dm_tpu_torch.pipelines import loading as tload
from tfmq_dm_tpu_torch.quant.quantizer import QCfg as TQCfg
from tfmq_dm_tpu_torch.scripts import micro_gn

from test_torch_ldm_modules import random_params

T_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
J_DTYPES = {"f32": jnp.float32, "bf16": jnp.bfloat16}


def _gemm_inputs(rng, m, k, n):
    """x ~ N(0, 1) with its minmax 8-bit grid (dx, centered zp), centered
    int8 weight codes with per-channel scales, zero points, sums, bias."""
    x = rng.standard_normal((m, k)).astype(np.float32)
    dx = np.float32((x.max() - x.min()) / 255)
    zx = np.float32(np.round(-x.min() / dx) - 128)
    w = rng.integers(-128, 128, (k, n)).astype(np.int8)
    d = (rng.random(n) * 0.01 + 1e-3).astype(np.float32)
    z = rng.integers(-10, 10, n).astype(np.float32)
    ws = w.astype(np.int32).sum(0).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    return x, dx, zx, w, d, z, ws, b


# (m, k, n, Pallas blocks): tests/test_pallas_kernels.py:38-61
@pytest.mark.parametrize("m,k,n,blocks", [
    (64, 128, 256, {}), (33, 128, 128, dict(block_m=32, block_n=128))])
@pytest.mark.parametrize("x_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("bias", [True, False])
def test_int8_matmul_fused_plain_matches_pallas(m, k, n, blocks, x_dtype,
                                                bias):
    x, dx, zx, w, d, z, ws, b = _gemm_inputs(
        np.random.default_rng(m + n), m, k, n)
    jb = jnp.asarray(b) if bias else None
    tb = torch.from_numpy(b) if bias else None
    for od in ("f32", "bf16"):
        def ref_fn(xx, od=od):
            return pk.int8_matmul_fused(
                xx, jnp.asarray(w), jnp.asarray(d), jnp.asarray(z),
                jnp.asarray(ws), dx, zx, jb, out_dtype=J_DTYPES[od],
                **blocks)

        jx = jnp.asarray(x).astype(J_DTYPES[x_dtype])
        with mock.patch.object(pl, "pallas_call",
                               functools.partial(pl.pallas_call,
                                                 interpret=True)):
            ref = jax.jit(ref_fn).lower(jx).compile(
                {"xla_disable_hlo_passes": "fusion"})(jx)
        got = I8.int8_matmul_fused(
            torch.from_numpy(x).to(T_DTYPES[x_dtype]), torch.from_numpy(w),
            torch.from_numpy(d), torch.from_numpy(z), torch.from_numpy(ws),
            dx, zx, tb, out_dtype=T_DTYPES[od])
        assert got.dtype == T_DTYPES[od]
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(ref.astype(jnp.float32)))


@pytest.mark.parametrize("x_dtype", ["f32", "bf16"])
def test_int8_matmul_fused_plain_is_quantize_then_pre(x_dtype):
    """At K 1536 (past the f32-exact depth of 1024 for code products)."""
    m, k, n = 37, 1536, 96
    x, dx, zx, w, d, z, ws, b = _gemm_inputs(np.random.default_rng(7), m, k,
                                             n)
    tx = torch.from_numpy(x).to(T_DTYPES[x_dtype])
    tw, td, tz, tws, tb = map(torch.from_numpy, (w, d, z, ws, b))
    xq, zc = ti.quantize_act_int8(tx, torch.tensor(dx),
                                  torch.tensor(zx + 128), TQCfg(bits=8))
    xs = xq.to(torch.int32).sum(-1, keepdim=True).float()
    for od in (torch.float32, torch.bfloat16):
        for bias in (tb, None):
            got = I8.int8_matmul_fused(tx, tw, td, tz, tws, dx, zx, bias,
                                       out_dtype=od)
            ref = I8.int8_matmul_pre(xq, xs, tw, td, tz, tws, dx, zc, bias,
                                     out_dtype=od)
            assert torch.equal(got, ref)


# tests/test_pallas_kernels.py:118-122, then cin256's widest skip
# concatenation (960 + 960 channels at 8x8) with its scale-shift pair
@pytest.mark.parametrize("b,h,w,c,eps,swish,use_ss", [
    (2, 8, 8, 64, 1e-5, True, False), (2, 8, 8, 64, 1e-5, True, True),
    (2, 32, 32, 320, 1e-5, True, False), (3, 4, 4, 320, 1e-6, False, False),
    (2, 8, 8, 1920, 1e-5, True, True)])
def test_gn_swish_quant_int8_plain_matches_pallas(b, h, w, c, eps, swish,
                                                  use_ss):
    rng = np.random.default_rng(b * h * w + c)
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    gamma = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(c)).astype(np.float32)
    ss = tuple((0.1 * rng.standard_normal((b, c))).astype(np.float32)
               for _ in range(2)) if use_ss else None
    ref_q, ref_zc = pk.gn_swish_quant_int8(
        jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta),
        jnp.float32(0.02), jnp.float32(117.0),
        JQCfg(bits=8, symmetric=False), groups=32, eps=eps, do_swish=swish,
        ss=None if ss is None else tuple(map(jnp.asarray, ss)),
        interpret=True)
    got_q, got_zc = G.gn_swish_quant_int8(
        torch.from_numpy(x), torch.from_numpy(gamma), torch.from_numpy(beta),
        0.02, 117.0, TQCfg(bits=8), groups=32, eps=eps, do_swish=swish,
        ss=None if ss is None else tuple(map(torch.from_numpy, ss)))
    assert got_q.dtype == torch.int8 and got_q.shape == x.shape
    diff = np.abs(got_q.numpy().astype(np.int32)
                  - np.asarray(ref_q).astype(np.int32))
    assert diff.max() <= 1
    assert (diff > 0).mean() < 1e-4
    assert float(got_zc) == float(ref_zc)


def test_micro_gn_twin_runs_on_cpu(capsys):
    assert micro_gn.main(["--device", "cpu", "--shape", "2,8,8,64"]) == 0
    out = capsys.readouterr().out
    assert "(2, 8, 8, 64): unfused" in out and "cpu wall" in out


class ModelCheckpoint:
    """A callback as Lightning pickles it into a checkpoint."""

    def __init__(self):
        self.monitor, self.best_model_score = "val/loss", 0.25


class AttributeDict(dict):
    """Lightning's container of hyper-parameters (a dict subclass)."""


def test_lightning_checkpoint_loads_as_in_jax(tmp_path):
    """A checkpoint whose ``callbacks`` and ``hyper_parameters`` hold
    objects of classes outside PyTorch loads in JAX
    (``weights_only=False``); the port must load the same weights."""
    jtask, ttask = jtasks.get_task("tiny_cin"), ttasks.get_task("tiny_cin")
    rng = np.random.default_rng(0)
    up = random_params(JL.iter_layers(jtask.unet), rng)
    vp = random_params(JV.iter_layers(jtask.vae, encoder=False), rng)
    sd = {f"model.diffusion_model.{k}": torch.from_numpy(np.array(v))
          for k, v in j_export(up, JL.iter_layers(jtask.unet)).items()}
    sd.update({f"first_stage_model.{k}": torch.from_numpy(np.array(v))
               for k, v in j_export(
                   vp, JV.iter_layers(jtask.vae, encoder=False)).items()})
    sd["cond_stage_model.embedding.weight"] = torch.from_numpy(
        rng.standard_normal((11, 16)).astype(np.float32))
    ckpt = str(tmp_path / "lightning.ckpt")
    torch.save({"epoch": 3, "global_step": 1200, "state_dict": sd,
                "callbacks": {"ModelCheckpoint{'monitor': 'val/loss'}":
                              ModelCheckpoint()},
                "hyper_parameters": AttributeDict(
                    base_lr=1e-4, monitor="val/loss",
                    scale_mean=np.arange(3, dtype=np.float32))},
               ckpt)
    with pytest.raises(Exception):
        torch.load(ckpt, map_location="cpu", weights_only=True)

    jp, jv, jc = jload.load_ldm_checkpoint(ckpt, jtask)
    tp, tv, tc = tload.load_ldm_checkpoint(ckpt, ttask, device="cpu")
    for j, t in ((jp, tp), (jv, tv), (jc, tc)):
        flat_j = {k: v for k, v in jax.tree_util.tree_flatten_with_path(
            j)[0]}
        flat_t = {k: v for k, v in jax.tree_util.tree_flatten_with_path(
            t)[0]}
        assert flat_t.keys() <= flat_j.keys() and flat_t
        for k, v in flat_t.items():
            np.testing.assert_array_equal(v.numpy(), np.asarray(flat_j[k]))
