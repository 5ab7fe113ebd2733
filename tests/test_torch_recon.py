"""The port's weight-phase reconstruction (AdaRound, the Adam loop, unit
I/O capture, the unit forwards, the do-no-harm guard, per-unit resume)
against the JAX package on the CPU, at the tiny DDIM config (16 calibration
samples, minibatches of 8, 32 iterations a unit).

Both sides start from the same numpy parameters, inputs and weight grids;
the port draws its minibatches from JAX's own key splits
(recon.py:383, :663, :1010), replayed here and passed in as the index
source.

Tolerances, each measured on this data and set a few times above:

- AdaRound's functions: 1 ulp in float32, except where the sigmoid enters:
  XLA's logistic on the CPU and ``torch.sigmoid`` differ by up to 2 ulp
  (measured on 2e5 random values), so ``soft_targets`` and the soft
  fake-quant are held to 2 ulp. Sums (the regularizer, the losses) are
  taken in another order: 1e-6 relative.
  The soft gradient on elements that sit on a clip bound, where
  ``jnp.clip`` passes half the gradient, is JAX's within 1e-5 relative
  (``torch.clamp``'s would be twice it); everywhere within 1e-6 of the
  largest gradient (the sigmoid's derivative differs by ulps).
- The Adam step against ``optax.adam``: 1 ulp (XLA's and PyTorch's float32
  power differ for a few counts in the bias correction).
- Captured unit I/O and unit forwards: 1e-5 of the largest magnitude (f32
  convolutions summed in another order; measured 1.5e-6); through the
  float16 FP-output cache: that, plus one float16 step.
- Reconstruction: loss traces within 1e-4 relative (measured 1.5e-5),
  hardened alphas equal on >= 99.9% of elements (measured 100%), guard
  decisions identical.

``reconstruct`` over every unit, per-unit resume and the CLI are in
test_torch_cali_cli.py, the FSC running-stat pass in test_torch_fsc_ema.py
(files of their own, so that their JAX compilations run on other test
workers).
"""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from tfmq_dm_tpu.models import ddim_unet as J
from tfmq_dm_tpu.models import ddim_units as JU
from tfmq_dm_tpu.quant import adaround as JA
from tfmq_dm_tpu.quant import quantizer as JQ
from tfmq_dm_tpu.quant import recon as JR
from tfmq_dm_tpu_torch.convert import params_from_numpy
from tfmq_dm_tpu_torch.models import ddim_unet as T
from tfmq_dm_tpu_torch.models import ddim_units as TU
from tfmq_dm_tpu_torch.quant import adaround as TA
from tfmq_dm_tpu_torch.quant import quantizer as TQ
from tfmq_dm_tpu_torch.quant import recon as TR
from tfmq_dm_tpu_torch.quant.context import QuantCtx as TCtx
from test_torch_ddim_slice import random_params

CFG = J.tiny_config()
N = 16
HP = dict(iters=32, batch_size=8)
IO_REL = 1e-5
LOSS_REL = 1e-4
HARD_EQUAL = 0.999


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Long loops of small CPU ops run on one intra-op thread: the test
    workers share the CPU, and idle threads spinning at every op's
    barrier cost more than the threads gain."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ord(a):
    """float32 -> integers in the order of the floats (ulp distance)."""
    i = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    return np.where(i < 0, -(i & 0x7FFFFFFF), i)


def ulps(a, b) -> int:
    return int(np.abs(_ord(a) - _ord(b)).max())


def close(got, ref, rel=IO_REL):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    scale = max(float(np.abs(ref).max()), 1e-12)
    assert got.shape == ref.shape
    assert float(np.abs(got - ref).max()) <= rel * scale


def leaves(tree):
    return list(tree) if isinstance(tree, tuple) else [tree]


def to_torch(tree):
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(to_torch(v) for v in tree)
    return torch.from_numpy(np.array(tree))


def jax_indices(key, n, bs, iters):
    """JAX's minibatch rows of ``reconstruct_unit(key)``: one split for
    the segment (recon.py:663), then one per iteration (recon.py:383)."""
    _, k = jax.random.split(key)
    rows = []
    for _ in range(iters):
        k, k1 = jax.random.split(k)
        rows.append(np.asarray(jax.random.permutation(k1, n))[:bs])
    return torch.from_numpy(np.stack(rows)).long()


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    np_p = random_params(CFG, rng)
    jp = jax.tree.map(jnp.asarray, np_p)
    tp = params_from_numpy(np_p, "cpu")
    x = rng.standard_normal((N, 16, 16, 3)).astype(np.float32)
    t = rng.integers(0, 100, N).astype(np.int32)
    ja = JU.build_adapter(CFG, w_bits=4, a_bits=8)
    ta = TU.build_adapter(T.tiny_config(), w_bits=4, a_bits=8)
    jw = JR.init_weight_qparams(ja.policy, jp, scaler="minmax")
    return dict(np_p=np_p, jp=jp, tp=tp, x=x, t=t, ja=ja, ta=ta, jw=jw,
                tw=to_torch(jw), jcali=(jnp.asarray(x), jnp.asarray(t)),
                tcali=(torch.from_numpy(x), torch.from_numpy(t)))


# ---------------------------------------------------------------------------
# AdaRound, the losses and Adam
# ---------------------------------------------------------------------------

def _weight_case(sym: bool):
    rng = np.random.default_rng(1)
    w = (0.1 * rng.standard_normal((3, 3, 8, 16))).astype(np.float32)
    d = (np.abs(w).reshape(-1, 16).max(0) / 7.5).astype(np.float32)
    zp = np.zeros(16, np.float32) if sym else \
        np.round(rng.uniform(0, 15, 16)).astype(np.float32)
    alpha = (3 * rng.standard_normal(w.shape)).astype(np.float32)
    return w, d, zp, alpha


# alphas where both frameworks' h(alpha) is exactly 0 or exactly 1 before
# its clip: the gradient passes half there (jnp.clip's tie)
H0_ALPHA, H1_ALPHA = np.float32(-2.3978953), np.float32(2.3978944)


def _on_bounds(w, d, zp, alpha, sym):
    """Put alphas on h's clip bounds, and at some of them also the sum
    floor(w/d) + h + zp on the grid's top (second clip's tie)."""
    pb = 7 if sym else 15
    alpha = alpha.copy()
    w = w.copy()
    flat_a, flat_w = alpha.reshape(-1, 16), w.reshape(-1, 16)
    flat_a[0:4] = H0_ALPHA
    flat_a[4:8] = H1_ALPHA
    flat_w[6:8] = (pb - 1 - zp + 0.5) * d   # floor(w/d) + zp = pb - 1
    return w, alpha


@pytest.mark.parametrize("fn", ["init_alpha", "soft_targets",
                                "round_regularizer", "linear_temp_decay",
                                "lp_loss", "lp_loss_all",
                                "ema_range_update"])
def test_adaround_and_losses_match_jax(fn):
    w, d, zp, alpha = _weight_case(False)
    if fn == "init_alpha":
        ref = JA.init_alpha(jnp.asarray(w), jnp.asarray(d))
        got = TA.init_alpha(torch.from_numpy(w), torch.from_numpy(d))
        assert ulps(got.numpy(), ref) <= 1
    elif fn == "soft_targets":
        w, alpha = _on_bounds(w, d, zp, alpha, False)
        ref = np.asarray(JA.soft_targets(jnp.asarray(alpha)))
        got = TA.soft_targets(torch.from_numpy(alpha)).numpy()
        assert ulps(got, ref) <= 2
        assert np.sum(ref == 0.0) > 0 and np.sum(ref == 1.0) > 0
    elif fn == "round_regularizer":
        for b in (20.0, 7.3, 2.0):
            ref = JA.round_regularizer(jnp.asarray(alpha), jnp.float32(b))
            got = TA.round_regularizer(torch.from_numpy(alpha),
                                       torch.tensor(b))
            assert abs(float(got) - float(ref)) <= 1e-6 * abs(float(ref))
    elif fn == "linear_temp_decay":
        for t_max, warm in ((40, 0.2), (5000, 0.2), (37, 0.3)):
            t = np.arange(1, t_max + 1, dtype=np.float32)
            ref = JA.linear_temp_decay(jnp.asarray(t), t_max, warm)
            got = TA.linear_temp_decay(torch.from_numpy(t), t_max, warm)
            assert ulps(got.numpy(), ref) <= 1, t_max
    elif fn in ("lp_loss", "lp_loss_all"):
        rng = np.random.default_rng(2)
        a, b = (rng.standard_normal((2, 4, 4, 8)).astype(np.float32)
                for _ in range(2))
        ref = getattr(JQ, fn)(jnp.asarray(a), jnp.asarray(b), p=2.0)
        got = getattr(TQ, fn)(torch.from_numpy(a), torch.from_numpy(b),
                              p=2.0)
        assert abs(float(got) - float(ref)) <= 1e-6 * abs(float(ref))
    else:
        rng = np.random.default_rng(3)
        x = rng.standard_normal(64).astype(np.float32)
        lo, hi = np.float32(-0.7), np.float32(1.3)
        ref = JQ.ema_range_update(jnp.asarray(x), jnp.asarray(lo),
                                  jnp.asarray(hi), 0.95)
        got = TQ.ema_range_update(torch.from_numpy(x), torch.tensor(lo),
                                  torch.tensor(hi), 0.95)
        for g, r in zip(got, ref):
            assert ulps(g.numpy(), r) == 0


@pytest.mark.parametrize("soft", [True, False])
@pytest.mark.parametrize("sym", [False, True])
def test_adaround_fq_matches_jax(soft, sym):
    w, d, zp, alpha = _weight_case(sym)
    w, alpha = _on_bounds(w, d, zp, alpha, sym)
    cfg_j = JQ.QCfg(bits=4, symmetric=sym, channel_wise=True)
    cfg_t = TQ.QCfg(bits=4, symmetric=sym, channel_wise=True)
    ref = JA.adaround_fq(jnp.asarray(w), jnp.asarray(d), jnp.asarray(zp),
                         jnp.asarray(alpha), cfg_j, soft)
    got = TA.adaround_fq(torch.from_numpy(w), torch.from_numpy(d),
                         torch.from_numpy(zp), torch.from_numpy(alpha),
                         cfg_t, soft)
    assert ulps(got.numpy(), ref) <= (2 if soft else 0)


@pytest.mark.parametrize("sym", [False, True])
def test_adaround_soft_grad_matches_jax(sym):
    """d adaround_fq(soft) / d alpha, with elements exactly on both clips'
    bounds: there JAX passes half the gradient (twice halved where both
    clips tie), and so must the port."""
    w, d, zp, alpha = _weight_case(sym)
    w, alpha = _on_bounds(w, d, zp, alpha, sym)
    g = np.random.default_rng(4).standard_normal(w.shape).astype(np.float32)
    cfg_j = JQ.QCfg(bits=4, symmetric=sym, channel_wise=True)
    cfg_t = TQ.QCfg(bits=4, symmetric=sym, channel_wise=True)
    ref = np.asarray(jax.grad(lambda a: jnp.sum(JA.adaround_fq(
        jnp.asarray(w), jnp.asarray(d), jnp.asarray(zp), a, cfg_j, True)
        * g))(jnp.asarray(alpha)))
    a = torch.from_numpy(alpha).requires_grad_()
    (TA.adaround_fq(torch.from_numpy(w), torch.from_numpy(d),
                    torch.from_numpy(zp), a, cfg_t, True)
     * torch.from_numpy(g)).sum().backward()
    got = a.grad.numpy()
    # on the bounds the halving must match (torch.clamp would pass twice
    # JAX's gradient there); the sigmoid's derivative differs by ulps
    bound = (alpha == H0_ALPHA) | (alpha == H1_ALPHA)
    assert np.any(ref[bound] != 0)
    np.testing.assert_allclose(got[bound], ref[bound], rtol=1e-5, atol=0)
    close(got, ref, rel=1e-6)


def test_adam_matches_optax():
    """20 steps of the port's Adam against optax.adam(1e-3) on the same
    gradients: parameters within 1 ulp at every step."""
    rng = np.random.default_rng(5)
    p0 = {"a": rng.standard_normal((4, 8)).astype(np.float32),
          "b": rng.standard_normal(16).astype(np.float32)}
    opt = optax.adam(1e-3)
    jp = jax.tree.map(jnp.asarray, p0)
    jst = opt.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    mu = {k: torch.zeros_like(v) for k, v in tp.items()}
    nu = {k: torch.zeros_like(v) for k, v in tp.items()}
    c1 = TR.adam_corrections(0.9, 1, 20, "cpu")
    c2 = TR.adam_corrections(0.999, 1, 20, "cpu")
    for step in range(20):
        g = {k: (rng.standard_normal(v.shape) * 10 ** rng.uniform(-4, 1))
             .astype(np.float32) for k, v in p0.items()}
        upd, jst = opt.update(jax.tree.map(jnp.asarray, g), jst)
        jp = optax.apply_updates(jp, upd)
        tp, mu, nu = TR.adam_update(
            tp, {k: torch.from_numpy(v) for k, v in g.items()}, mu, nu,
            1e-3, (c1[step], c2[step]))
        for k in p0:
            assert ulps(tp[k].numpy(), jp[k]) <= 1, (step, k)


# ---------------------------------------------------------------------------
# capture and unit forwards
# ---------------------------------------------------------------------------

UNITS = ["down.1.block.0", "down.1.attn.0", "up.1.upsample.conv", "tib"]


@pytest.mark.parametrize("name,batch", [
    (name, batch) for name in UNITS for batch in (8, 5)
    if not (batch == 5 and name == "tib")])   # the TIB: no capture batches
def test_capture_unit_io_matches_jax(setup, name, batch):
    """asym capture (inputs under the 4-bit quantized prefix, FP outputs
    through the shared float16 FP-output cache), the port's capture in
    batches of 8 and of 5 (the last one short), JAX's in batches of 8;
    the TIB's inputs are the timesteps, its outputs its FP forward."""
    s = setup
    ju, tu = s["ja"].unit_by_name(name), s["ta"].unit_by_name(name)
    cache = name != "tib"
    jfp = tfp = None
    if cache:
        jfp = JR.precapture_fp_outs(s["ja"], [name], s["jp"], s["jcali"],
                                    batch_size=8)[name]
        tfp = TR.precapture_fp_outs(s["ta"], [name], s["tp"], s["tcali"],
                                    batch_size=batch)[name]
    jin, jout = JR.capture_unit_io(s["ja"], ju, s["jp"], s["jcali"],
                                   s["jw"], asym=True, batch_size=8,
                                   fp_out=jfp)
    tin, tout = TR.capture_unit_io(s["ta"], tu, s["tp"], s["tcali"],
                                   s["tw"], tfp, batch_size=batch)
    for g, r in zip(leaves(tin), leaves(jin)):
        close(g.numpy(), r)
    for g, r in zip(leaves(tout), leaves(jout)):
        if cache:
            assert g.dtype == torch.float16 and np.asarray(r).dtype == \
                np.float16
            g, r = g.float().numpy(), np.asarray(r, np.float32)
            # the f32 outputs' own difference, then at most one float16
            # step apart
            step = np.maximum(np.abs(g), np.abs(r)) * 2.0 ** -10 + \
                IO_REL * float(np.abs(r).max())
            bad = np.abs(g - r) > step
            assert not bad.any(), (g[bad][:5], r[bad][:5])
        else:
            close(g.numpy(), r)


@pytest.mark.parametrize("name", UNITS)
def test_unit_fwd_matches_model_and_jax(setup, name):
    """The unit forward on the FP model's tapped input gives the model's
    tapped output (FP), and the soft-rounding forward of the unit with
    alphas equals JAX's on the same inputs."""
    s = setup
    tu = s["ta"].unit_by_name(name)
    up = TU.extract_uparams(s["tp"], tu)
    fp_rc = tuple(r.__class__(role=r.role)
                  for r in s["ta"].role_cfgs(tu, frozenset()))
    if name == "tib":
        inp = (s["tcali"][1],)
        ref = T.tib_forward(s["tp"], T.tiny_config(), inp[0])
    else:
        ctx = TCtx(s["ta"].policy, capture=frozenset({name}))
        T.apply(s["tp"], T.tiny_config(), *s["tcali"], ctx)
        inp, ref = ctx.tape[f"{name}::in"], ctx.tape[f"{name}::out"]
    got = TU.unit_fwd(tu.kind, fp_rc, tu.extra, up, {}, {}, inp, False,
                      False)
    for g, r in zip(leaves(got), leaves(ref)):
        close(g.numpy(), r.numpy())

    train = s["ta"].default_train_roles(tu)
    rng = np.random.default_rng(6)
    ws = {}
    for role, full in tu.layers:
        if full in s["jw"]:
            ws[role] = dict(s["jw"][full])
            if role in train:
                ws[role]["alpha"] = rng.standard_normal(
                    s["np_p"][full]["w"].shape).astype(np.float32)
    ju = s["ja"].unit_by_name(name)
    jref = JU.unit_fwd(ju.kind, s["ja"].role_cfgs(ju, train), ju.extra,
                       s["ja"].extract_uparams(s["jp"], ju),
                       jax.tree.map(jnp.asarray, ws), {},
                       jax.tree.map(lambda a: jnp.asarray(a.numpy()), inp),
                       True, False)
    tgot = TU.unit_fwd(tu.kind, s["ta"].role_cfgs(tu, train), tu.extra, up,
                       to_torch(ws), {}, inp, True, False)
    for g, r in zip(leaves(tgot), leaves(jref)):
        close(g.numpy(), r)


def test_taps_leave_the_forward_unchanged(setup):
    s = setup
    ref = T.apply(s["tp"], T.tiny_config(), *s["tcali"])
    ctx = TCtx(s["ta"].policy, capture=frozenset({"*"}))
    got = T.apply(s["tp"], T.tiny_config(), *s["tcali"], ctx)
    assert torch.equal(got, ref)
    names = {u.name for u in s["ta"].units if u.kind != "tib"} - \
        {"conv_in", "conv_out"}
    assert {k.rsplit("::", 1)[0] for k in ctx.tape} == names


# ---------------------------------------------------------------------------
# reconstruction
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def unit_io(setup):
    """JAX's cached I/O of the units the single-unit tests reconstruct;
    both sides reconstruct from these same arrays."""
    s = setup
    out = {}
    for name in ("down.1.block.0", "tib"):
        u = s["ja"].unit_by_name(name)
        fp = None if name == "tib" else JR.precapture_fp_outs(
            s["ja"], [name], s["jp"], s["jcali"], batch_size=8)[name]
        out[name] = JR.capture_unit_io(s["ja"], u, s["jp"], s["jcali"],
                                       s["jw"], asym=True, batch_size=8,
                                       fp_out=fp)
    return out


def _hard_equal_share(jw, tw, names):
    eq = tot = 0
    for full in names:
        if "alpha" in jw.get(full, {}):
            a = np.asarray(jw[full]["alpha"]) >= 0
            b = tw[full]["alpha"].numpy() >= 0
            eq += int((a == b).sum())
            tot += a.size
    assert tot > 0
    return eq / tot


@pytest.mark.parametrize("lr", [1e-3, 25.0])
@pytest.mark.parametrize("name", ["down.1.block.0", "tib"])
def test_reconstruct_unit_matches_jax(setup, unit_io, name, lr):
    """One unit, 32 iterations on JAX's minibatches: the loss at every
    iteration, the hardened alphas and the guard's decision. lr 25
    wrecks the alphas (tests/test_recon_guard.py), so the guard must
    revert to nearest rounding on both sides."""
    s = setup
    ju, tu = s["ja"].unit_by_name(name), s["ta"].unit_by_name(name)
    jin, jout = unit_io[name]
    key = jax.random.PRNGKey(5)
    jst, tst = {}, {}
    jw2, jl = JR.reconstruct_unit(s["ja"], ju, s["jp"], s["jw"], jin, jout,
                                  JR.ReconHP(lr_alpha=lr, **HP), key,
                                  stats=jst)
    tw2, tl = TR.reconstruct_unit(
        s["ta"], tu, s["tp"], s["tw"], to_torch(jin), to_torch(jout),
        TR.ReconHP(lr_alpha=lr, **HP), stats=tst,
        indices=lambda u, n, bs, it: jax_indices(key, n, bs, it))
    assert jst[name]["kept"] == tst[name]["kept"] == \
        ("trained" if lr < 1 else "nearest")
    for k in ("hard_nearest", "hard_trained"):
        assert abs(tst[name][k] - jst[name][k]) <= LOSS_REL * jst[name][k]
    names = [full for _, full in tu.layers]
    assert _hard_equal_share(jw2, tw2, names) >= HARD_EQUAL
    if lr < 1:
        jl, tl = np.asarray(jl), tl.numpy()
        assert tl.shape == jl.shape == (HP["iters"],)
        assert np.all(np.abs(tl - jl) <= LOSS_REL * np.abs(jl))
        assert tl[-1] < tl[0]


def test_loss_floor_skips_the_unit_as_in_jax(setup, unit_io):
    s = setup
    name = "down.1.block.0"
    jin, jout = unit_io[name]
    jst, tst = {}, {}
    jw2, jl = JR.reconstruct_unit(
        s["ja"], s["ja"].unit_by_name(name), s["jp"], s["jw"], jin, jout,
        JR.ReconHP(loss_floor=1e3, **HP), jax.random.PRNGKey(0), stats=jst)
    tw2, tl = TR.reconstruct_unit(
        s["ta"], s["ta"].unit_by_name(name), s["tp"], s["tw"],
        to_torch(jin), to_torch(jout), TR.ReconHP(loss_floor=1e3, **HP),
        stats=tst)
    assert jl is None and tl is None
    assert tst[name]["kept"] == jst[name]["kept"] == "nearest"
    assert tst[name]["skipped"] and jst[name]["skipped"]
    assert tw2 is s["tw"]
