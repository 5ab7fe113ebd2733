"""The port's FSC running-stat pass against the JAX package on the CPU.

Both sides get the same calibration data, weight grids, init subsets
and EMA permutations (JAX's own draws, fsc.py:77-84, replayed and passed
in as the index source).

- On a chain of two activation sites around an elementwise op, the two
  sites see the same inputs on both sides. Every delta of every group is
  within 2 ulp and every zero point equal: XLA compiles the EMA update
  ``m * x_min + (1 - m) * min(x)`` into a fused multiply-add and the
  grid's ``/ 255`` into a reciprocal product, each up to 1 ulp from
  rounding every operation, as PyTorch does (and the reference's
  quant_layer.py:229-244); measured 1 ulp.
- Through the tiny UNet, the two frameworks' f32 convolutions differ by
  ulps; a value on an 8-bit rounding boundary then takes the other code,
  and GroupNorm and later layers spread the step. Measured over the two
  data seeds: delta within 2.4% relative at every (site, group), the
  median 7e-4 and 1.4e-3, zero points within one code (at 14-18% of the
  pairs). Limits: 10% (the ddim slice's FSC limit), median 5e-3, one
  code.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfmq_dm_tpu.models import ddim_unet as J
from tfmq_dm_tpu.models import ddim_units as JU
from tfmq_dm_tpu.quant.adapter import ModelAdapter as JAdapter
from tfmq_dm_tpu.quant.fsc import fsc_calibrate as j_fsc
from tfmq_dm_tpu.quant.policy import LayerInfo as JInfo
from tfmq_dm_tpu.quant.policy import build_policy as j_policy
from tfmq_dm_tpu.quant.recon import init_weight_qparams as j_iwq
from tfmq_dm_tpu_torch.convert import params_from_numpy
from tfmq_dm_tpu_torch.models import ddim_unet as T
from tfmq_dm_tpu_torch.models import ddim_units as TU
from tfmq_dm_tpu_torch.quant.adapter import ModelAdapter as TAdapter
from tfmq_dm_tpu_torch.quant.fsc import fsc_calibrate as t_fsc
from tfmq_dm_tpu_torch.quant.policy import LayerInfo as TInfo
from tfmq_dm_tpu_torch.quant.policy import build_policy as t_policy
from test_torch_ddim_slice import random_params
from test_torch_recon import ulps

FSC_DELTA_REL, FSC_DELTA_MEDIAN_REL, FSC_ZP_CODES = 0.1, 5e-3, 1.0


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Long loops of small CPU ops run on one intra-op thread: the test
    workers share the CPU, and idle threads spinning at every op's
    barrier cost more than the threads gain."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_fsc_indices(key, groups, n, init_samples):
    """JAX's per-group draws (fsc.py:77-84): the init subset and the EMA
    permutation."""
    out = []
    for _ in range(groups):
        key, k1, k2 = jax.random.split(key, 3)
        out.append((
            torch.tensor(np.asarray(jax.random.choice(
                k1, n, (min(init_samples, n),), replace=False))),
            torch.tensor(np.asarray(jax.random.permutation(k2, n)))))
    return lambda g, n_: out[g]


def _chain_adapters():
    """Two 8-bit act sites around an elementwise op, in both packages."""
    infos = [("a", "act"), ("b", "act")]
    jpol = j_policy([JInfo(name=n, kind=k) for n, k in infos])
    tpol = t_policy([TInfo(name=n, kind=k) for n, k in infos])

    def jfwd(params, ctx, x, t):
        return ctx.qact("b", jnp.maximum(ctx.qact("a", x), 0.0) * 3.0)

    def tfwd(params, ctx, x, t):
        return ctx.qact("b", torch.clamp(ctx.qact("a", x), min=0.0) * 3.0)

    return (JAdapter(policy=jpol, units=[], forward=jfwd, unit_fwd=None,
                     extract_uparams=None),
            TAdapter(policy=tpol, forward=tfwd))


def test_fsc_running_stat_bit_equal_on_an_elementwise_chain():
    ja, ta = _chain_adapters()
    rng = np.random.default_rng(0)
    g, n = 3, 40
    x = (rng.standard_normal((g, n, 5, 7)) *
         rng.uniform(0.5, 2.0, (g, 1, 1, 1))).astype(np.float32)
    t = np.zeros((g, n), np.int32)
    key = jax.random.PRNGKey(11)
    jast = j_fsc(ja, {}, {}, (jnp.asarray(x), jnp.asarray(t)), key,
                 running_stat=True, init_samples=8, batch_size=8,
                 act_scaler="minmax")
    tast = t_fsc(ta, {}, {}, (torch.from_numpy(x), torch.from_numpy(t)),
                 running_stat=True, init_samples=8, batch_size=8,
                 act_scaler="minmax",
                 indices=jax_fsc_indices(key, g, n, 8))
    assert sorted(tast) == sorted(jast) == ["a", "b"]
    for site in jast:
        np.testing.assert_array_equal(tast[site]["zp"].numpy(),
                                      np.asarray(jast[site]["zp"]))
        assert ulps(tast[site]["delta"].numpy(),
                    jast[site]["delta"]) <= 2, site
    # five EMA batches moved the grids away from the init pass's
    init = t_fsc(ta, {}, {}, (torch.from_numpy(x), torch.from_numpy(t)),
                 running_stat=False, init_samples=8, act_scaler="minmax",
                 indices=jax_fsc_indices(key, g, n, 8))
    assert not torch.equal(init["b"]["delta"], tast["b"]["delta"])


@pytest.fixture(scope="module")
def unet_adapters():
    """One adapter a package for both seeds: JAX keys its compiled FSC
    passes on the adapter's identity."""
    return (JU.build_adapter(J.tiny_config(), w_bits=4, a_bits=8),
            TU.build_adapter(T.tiny_config(), w_bits=4, a_bits=8))


@pytest.mark.parametrize("seed", [0, 1])
def test_fsc_running_stat_matches_jax_on_tiny_unet(unet_adapters, seed):
    """``fsc_calibrate(running_stat=True)`` (JAX's defaults: the mse init
    scaler, batches of 8 here) over 3 groups of 16 samples, w4a8."""
    cfg = J.tiny_config()
    rng = np.random.default_rng(seed)
    np_p = random_params(cfg, rng)
    jp = jax.tree.map(jnp.asarray, np_p)
    g, n = 3, 16
    x = rng.standard_normal((g, n, 16, 16, 3)).astype(np.float32)
    t = np.repeat(np.array([90, 50, 10], np.int32)[:, None], n, 1)
    ja, ta = unet_adapters
    jw = j_iwq(ja.policy, jp, scaler="minmax")
    tw = {k: {f: torch.tensor(np.asarray(v)) for f, v in st.items()}
          for k, st in jw.items()}
    key = jax.random.PRNGKey(3)
    jast = j_fsc(ja, jp, jw, (jnp.asarray(x), jnp.asarray(t)), key,
                 init_samples=8, batch_size=8)
    tast = t_fsc(ta, params_from_numpy(np_p, "cpu"), tw,
                 (torch.from_numpy(x), torch.from_numpy(t)), init_samples=8,
                 batch_size=8, indices=jax_fsc_indices(key, g, n, 8))
    assert sorted(tast) == sorted(jast)
    rel, zp = [], []
    for site in jast:
        jd = np.asarray(jast[site]["delta"])
        td = tast[site]["delta"].numpy()
        assert td.shape == jd.shape == (g,)
        rel.append(np.abs(td - jd) / jd)
        zp.append(np.abs(tast[site]["zp"].numpy()
                         - np.asarray(jast[site]["zp"])))
    rel, zp = np.concatenate(rel), np.concatenate(zp)
    assert rel.max() <= FSC_DELTA_REL
    assert np.median(rel) <= FSC_DELTA_MEDIAN_REL
    assert zp.max() <= FSC_ZP_CODES
