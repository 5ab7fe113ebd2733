"""Modules of the PyTorch port (tfmq_dm_tpu_torch) against their JAX
counterparts on the same numpy inputs: quantizer arithmetic (bit-equal),
FSC state packing, the FP UNet at the tiny config and at full CIFAR-10
width from the trained checkpoint, the sampling CLI on the CPU, and the
rule that the port imports no JAX.

FP forwards differ only in f32 summation order: 1e-5 of the output's
largest magnitude.

The JAX mse scaler runs its 80-candidate search in ``lax.fori_loop``,
which XLA compiles; on the CPU, XLA then computes ``(max*s - min*s) / 15``
as ``fma(max, s, -(min*s)) * f32(1/15)``, one ulp away from the IEEE
operations the source states (and the port performs). The quantizer
tests therefore run that loop op by op (a Python loop over the same body),
so that the comparison is with JAX's expressions as written.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfmq_dm_tpu.models import ddim_unet as J
from tfmq_dm_tpu.pipelines.training import load_params as j_load_params
from tfmq_dm_tpu.quant import fsc as jfsc
from tfmq_dm_tpu.quant import quantizer as jq
from tfmq_dm_tpu_torch import cli
from tfmq_dm_tpu_torch.convert import load_params, params_from_numpy
from tfmq_dm_tpu_torch.models import ddim_unet as T
from tfmq_dm_tpu_torch.models import ddim_units as TU
from tfmq_dm_tpu_torch.quant import fsc as tfsc
from tfmq_dm_tpu_torch.quant import quantizer as tq
from tfmq_dm_tpu_torch.quant.calibrate import cali_model
from tfmq_dm_tpu_torch.samplers.ddim import harvest_trajectory

REPO = Path(__file__).resolve().parent.parent
CKPT = REPO / "runs" / "cifar10_ddpm.npz"
FP_RTOL = 1e-5


def _assert_fp_close(got, ref):
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, rtol=0, atol=FP_RTOL * scale)


# ---------------------------------------------------------------------------
# quantizer: bit-equal
# ---------------------------------------------------------------------------

W4 = dict(bits=4, channel_wise=True)
A8 = dict(bits=8)
SM8 = dict(bits=8, always_zero=True)
W4S = dict(bits=4, channel_wise=True, symmetric=True)


@pytest.fixture
def op_by_op_fori_loop(monkeypatch):
    def fori_loop(lo, hi, body, init):
        carry = init
        for i in range(lo, hi):
            carry = body(jnp.int32(i), carry)
        return carry
    monkeypatch.setattr(jax.lax, "fori_loop", fori_loop)


def _data(shape, seed, relu=False):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return np.abs(x) if relu else x


@pytest.mark.parametrize("cfg,scaler,shape,relu", [
    (W4, "minmax", (3, 3, 16, 24), False),
    (W4, "mse", (3, 3, 16, 24), False),
    (W4S, "minmax", (32, 40), False),
    (A8, "minmax", (2, 8, 8, 16), False),
    (A8, "mse", (2, 8, 8, 16), False),
    (SM8, "minmax", (2, 64, 64), True),
], ids=["w4-minmax", "w4-mse", "w4sym-minmax", "a8-minmax", "a8-mse",
        "softmax-minmax"])
def test_init_qparams_and_fake_quant_bit_equal(op_by_op_fori_loop, cfg,
                                               scaler, shape, relu):
    x = _data(shape, seed=len(shape) + shape[-1], relu=relu)
    jd, jz = jq.init_qparams(jnp.asarray(x), jq.QCfg(**cfg), scaler=scaler)
    td, tz = tq.init_qparams(torch.from_numpy(x), tq.QCfg(**cfg),
                             scaler=scaler)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))
    jfq = jq.fake_quant(jnp.asarray(x), jq.broadcast_channel(jd, shape),
                        jq.broadcast_channel(jz, shape), jq.QCfg(**cfg))
    tfq = tq.fake_quant(torch.from_numpy(x),
                        tq.broadcast_channel(td, shape),
                        tq.broadcast_channel(tz, shape), tq.QCfg(**cfg))
    np.testing.assert_array_equal(tfq.numpy(), np.asarray(jfq))
    jint = jq.quant_int(jnp.asarray(x), jq.broadcast_channel(jd, shape),
                        jq.broadcast_channel(jz, shape), jq.QCfg(**cfg),
                        dtype=jnp.int32)
    tint = tq.quant_int(torch.from_numpy(x), tq.broadcast_channel(td, shape),
                        tq.broadcast_channel(tz, shape), tq.QCfg(**cfg),
                        dtype=torch.int32)
    np.testing.assert_array_equal(tint.numpy(), np.asarray(jint))


def test_qparams_from_range_bit_equal():
    lo = np.array([-1.7, 0.3, -0.01], np.float32)
    hi = np.array([2.9, 1.1, -0.002], np.float32)
    for cfg in (A8, SM8, dict(bits=8, symmetric=True)):
        jd, jz = jq.qparams_from_range(jnp.asarray(lo), jnp.asarray(hi),
                                       jq.QCfg(**cfg))
        td, tz = tq.qparams_from_range(torch.from_numpy(lo),
                                       torch.from_numpy(hi), tq.QCfg(**cfg))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))


# ---------------------------------------------------------------------------
# FSC state: slice and pack
# ---------------------------------------------------------------------------

def test_fsc_pack_and_slice_match_jax():
    rng = np.random.default_rng(3)
    groups = 5
    state = {f"site{i}": {"delta": rng.random(groups).astype(np.float32),
                          "zp": rng.integers(0, 255, groups).astype(
                              np.float32)} for i in range(4)}
    state["w"] = {"delta": rng.random((groups, 6)).astype(np.float32),
                  "zp": rng.integers(0, 15, (groups, 6)).astype(np.float32)}
    jstate = jax.tree.map(jnp.asarray, state)
    tstate = {s: {k: torch.from_numpy(v) for k, v in st.items()}
              for s, st in state.items()}
    flat, spec = tfsc.pack_fsc(tstate)
    assert flat.shape == (groups, 4 * 2 + 12)
    jflat, jspec = jfsc.pack_fsc(jstate)
    for g in range(groups):
        sl = tfsc.slice_fsc(tstate, g)
        un = tfsc.unpack_fsc(flat[g], spec)
        jsl = jfsc.unpack_fsc(jflat[g], jspec)
        for s in state:
            for k in ("delta", "zp"):
                np.testing.assert_array_equal(un[s][k].numpy(),
                                              sl[s][k].numpy())
                np.testing.assert_array_equal(un[s][k].numpy(),
                                              np.asarray(jsl[s][k]))


# ---------------------------------------------------------------------------
# FP UNet
# ---------------------------------------------------------------------------

def test_unet_fp_tiny_matches_jax():
    cfg = J.tiny_config()
    rng = np.random.default_rng(0)
    np_params = {}
    for kind, name, shape in J.iter_layers(cfg):
        if kind == "norm":
            np_params[name] = {"scale": 1 + 0.1 * rng.standard_normal(shape),
                               "bias": 0.1 * rng.standard_normal(shape)}
        else:
            bound = 1.0 / np.sqrt(np.prod(shape[:-1]))
            np_params[name] = {"w": rng.uniform(-bound, bound, shape),
                               "b": rng.uniform(-bound, bound, shape[-1:])}
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), np_params)
    tparams = params_from_numpy(np_params, "cpu")
    x = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    t = np.array([5, 700], np.int32)
    ref = np.asarray(jax.jit(lambda p, a, b: J.apply(p, cfg, a, b))(
        params, jnp.asarray(x), jnp.asarray(t)))
    got = T.apply(tparams, T.tiny_config(), torch.from_numpy(x),
                  torch.from_numpy(t)).numpy()
    _assert_fp_close(got, ref)


def test_unet_fp_cifar10_checkpoint_matches_jax():
    """Full published width (ch 128, ch_mult 1,2,2,2, attention at 16x16),
    the trained in-repo weights through each package's loader."""
    jparams, jmeta = j_load_params(str(CKPT))
    tparams, tmeta = load_params(str(CKPT), device="cpu")
    assert tmeta == jmeta and set(tparams) == set(jparams)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    t = np.array([10, 900], np.int32)
    cfg = J.cifar10_config()
    ref = np.asarray(jax.jit(lambda p, a, b: J.apply(p, cfg, a, b))(
        jparams, jnp.asarray(x), jnp.asarray(t)))
    got = T.apply(tparams, T.cifar10_config(), torch.from_numpy(x),
                  torch.from_numpy(t)).numpy()
    _assert_fp_close(got, ref)


def test_wide_weight_grid_deploys_fake_quantized_weights():
    """Weight grids wider than 8 bits cannot be stored as int8 codes: the
    deployment carries the fake-quantized weights (FPWeight), so the
    deployed forward is the simulation's, up to the deployed attention's
    integer algebra (f32 rounding only)."""
    from tfmq_dm_tpu_torch.ops.int_ops import FPWeight
    from tfmq_dm_tpu_torch.quant.context import QuantCtx
    from tfmq_dm_tpu_torch.quant.deploy import (deploy_weights,
                                                make_deployed_model_fn)
    from tfmq_dm_tpu_torch.quant.fsc import fsc_calibrate
    from tfmq_dm_tpu_torch.quant.recon import init_weight_qparams
    cfg = T.tiny_config()
    g = torch.Generator().manual_seed(0)
    params = {}
    for kind, name, shape in T.iter_layers(cfg):
        if kind == "norm":
            params[name] = {"scale": torch.ones(shape),
                            "bias": torch.zeros(shape)}
        else:
            params[name] = {"w": torch.randn(shape, generator=g) * 0.1,
                            "b": torch.randn(shape[-1:], generator=g) * 0.1}
    adapter = TU.build_adapter(cfg, w_bits=16, a_bits=8)
    wstate = init_weight_qparams(adapter.policy, params, scaler="minmax")
    x = torch.randn(2, 16, 16, 3, generator=g)
    t = torch.tensor([3, 60], dtype=torch.int32)
    astate = fsc_calibrate(adapter, params, wstate, (x[None], t[None]), g,
                           running_stat=False, init_samples=2,
                           act_scaler="minmax")
    deployed = deploy_weights(adapter.policy, params, wstate)
    assert {type(v) for v in deployed.values()} == {FPWeight}
    got = make_deployed_model_fn(adapter, params, deployed, astate,
                                 use_aq=True)(x, t, 0)
    ctx = QuantCtx(adapter.policy, wstate=wstate,
                   astate=tfsc.slice_fsc(astate, 0), use_wq=True,
                   use_aq=True)
    ref = T.apply(params, cfg, x, t, ctx)
    _assert_fp_close(got.numpy(), ref.numpy())


# ---------------------------------------------------------------------------
# the sampling CLI, on the CPU (the card runs it in chip_smoke.py)
# ---------------------------------------------------------------------------

def test_cli_int4_serving_on_cpu(tmp_path):
    """Calibrate at full width on 2 steps x 2 samples, then sample through
    ``cli.main`` with the packed-int4 deployment: finite images in [0, 1]
    that stay near the FP model's from the same noise."""
    steps = 2
    cfg = T.cifar10_config()
    params, _ = load_params(str(CKPT), device="cpu")
    adapter = TU.build_adapter(cfg, w_bits=4, a_bits=8)
    betas, seq = cli.cifar10_schedule(steps)
    x_T = torch.randn((2, 32, 32, 3), generator=torch.Generator()
                      .manual_seed(0))
    xs, ts = harvest_trajectory(lambda x, t, s: T.apply(params, cfg, x, t),
                                betas, seq, x_T)
    art = str(tmp_path / "cali.npz")
    cali_model(adapter, params, None, (xs, ts), hp=None, use_aq=True,
               running_stat=False,
               generator=torch.Generator().manual_seed(1),
               path=art, w_scaler="minmax", act_scaler="minmax",
               meta={"wq": 4, "aq": 8,
                     "cali_t": [float(v) for v in seq[::-1]]})
    common = ["--task", "cifar10", "--timesteps", str(steps), "-n", "2",
              "--batch", "2", "--device", "cpu", "--seed", "7"]
    assert cli.main(common + ["--out", str(tmp_path / "q"), "--ptq",
                              "--cali_ckpt", art, "--use_aq",
                              "--int-kernels", "--int4-serving"]) == 0
    assert cli.main(common + ["--out", str(tmp_path / "fp")]) == 0
    assert cli.main(common + ["--out", str(tmp_path / "sim"), "--ptq",
                              "--cali_ckpt", art, "--use_aq"]) == 0
    q = np.load(tmp_path / "q" / "samples.npy")
    fp = np.load(tmp_path / "fp" / "samples.npy")
    sim = np.load(tmp_path / "sim" / "samples.npy")
    # the deployed model is the fake-quant simulation up to the bf16
    # rounding of the int4 path's operands
    # (measured: 0.15 of the distance to FP)
    assert np.abs(q - sim).mean() < np.abs(q - fp).mean() / 3
    assert q.shape == fp.shape == (2, 32, 32, 3)
    assert np.all(np.isfinite(q)) and q.min() >= 0 and q.max() <= 1
    # w4a8 after 2 steps: close to FP, not equal to it
    assert 0 < np.abs(q - fp).mean() < 0.05


# ---------------------------------------------------------------------------
# the port imports no JAX
# ---------------------------------------------------------------------------

def test_port_imports_without_jax():
    mods = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in (REPO / "tfmq_dm_tpu_torch").rglob("*.py")
        if p.name != "__init__.py") + ["chip_smoke"]
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['tfmq_dm_tpu'] = None\n"
            "import importlib, json\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'tfmq_dm_tpu') and sys.modules[m]]\n"
            "print(json.dumps(bad))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []
    assert "tfmq_dm_tpu_torch.cli" in mods
