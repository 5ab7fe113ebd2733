"""The rest of the port's reconstruction against the JAX package on the CPU:
the straight-through ``fake_quant`` and its gradients, the KL and
histogram range scalers, the symmetric and act-quantized unit capture, the
Fisher gradients (``QuantCtx.override``) and losses, the act phase with its
guard, and mid-unit resume (the port against an uninterrupted run of
itself, through ``reconstruct`` and ``cli.main --resume_dir``).

The ddim tests run ``ddim_unet.tiny_config()`` at w8a8 (JAX's
tests/test_calibration.py setup) on 16 rows made with numpy from a seed;
the LDM act phase runs a transformer unit of tiny_cin's UNet
(``tiny_sd_config(context_dim=16)``). JAX runs one unit per feature, and
its cached I/O of ``mid.block_1`` is captured once for the module. The
port draws its minibatches from JAX's own key splits, passed in as the
index source.

Tolerances, each measured on this data and set a few times above:

- ``fake_quant``'s gradients: with respect to x, 1 ulp (both scale by
  delta * (1 / delta)); with respect to delta, 1e-5 relative (a sum over
  every element, in another order). The elements on a clamp bound get half
  the gradient on both sides.
- The scalers: bit-equal (the same float64 numpy, then minmax in float32).
- Captures: 1e-5 of the largest magnitude (test_torch_recon.py's IO_REL;
  f32 convolutions summed in another order). Under an act-quantized
  prefix an activation one ulp apart on the two sides now and then
  crosses a rounding boundary of its 8-bit grid, and the flipped code
  spreads downstream: the limits of test_torch_ddim_slice.py for values
  downstream of activation quantizers, ``AQ_MAX_REL`` of the largest
  magnitude and ``AQ_MEAN_REL`` of the mean (measured 4.4e-3 and 7.4e-4).
- Fisher gradients: 2e-3 of the largest magnitude. The gradient is
  softmax(quantized) - softmax(FP) carried back through the model, a
  difference of nearly equal f32 values (measured 3.8e-4). |g| + 1 within
  2 ulp.
- The weight phase with a Fisher loss, on synthetic Fisher weights far
  from 1: loss traces within LOSS_REL relative, hardened alphas equal on
  >= 99.9% of elements, guard decisions identical (test_torch_recon.py's
  limits).
- The act phase is held in two halves. The gradient of the first
  iteration's loss with respect to each delta, on the same deltas and
  rows, within ``ACT_GRAD_REL`` of JAX's plus ``ACT_GRAD_FLOOR`` of the
  unit's largest: an activation one ulp apart on the two sides crosses a
  rounding boundary of its 8-bit grid now and then (GroupNorm and the
  convolutions sum in another order), and the flipped code moves a
  delta's gradient (measured 1.9e-3 relative; 1e-6 of the largest at a
  site whose gradient is nearly 0 and changes sign).
  Then the port's trajectory against optax's ``adam`` with
  ``cosine_decay_schedule``, fed the port's own gradients step by step:
  within ``ADAM_ULPS`` at every step, and the first step is delta0 -
  lr_delta * sign(g0). The first loss within LOSS_REL, the later ones
  within ``ACT_LOSS_REL`` (measured 5.5e-3: the two runs' deltas part
  after a flip), zero points equal, guard decisions identical.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tfmq_dm_tpu.models import ddim_unet as J
from tfmq_dm_tpu.models import ddim_units as JU
from tfmq_dm_tpu.models import ldm_unet as JL
from tfmq_dm_tpu.models import ldm_units as JLU
from tfmq_dm_tpu.pipelines.training import save_params
from tfmq_dm_tpu.quant import quantizer as JQ
from tfmq_dm_tpu.quant import recon as JR
from tfmq_dm_tpu_torch import cli
from tfmq_dm_tpu_torch.convert import params_from_numpy
from tfmq_dm_tpu_torch.models import ddim_unet as T
from tfmq_dm_tpu_torch.models import ddim_units as TU
from tfmq_dm_tpu_torch.models import ldm_unet as TL
from tfmq_dm_tpu_torch.models import ldm_units as TLU
from tfmq_dm_tpu_torch.quant import quantizer as TQ
from tfmq_dm_tpu_torch.quant import recon as TR
from tfmq_dm_tpu_torch.quant.artifact import load_artifact
from tfmq_dm_tpu_torch.quant.context import QuantCtx as TCtx
from test_torch_ddim_slice import random_params
from test_torch_ldm_modules import random_params as ldm_random_params
from test_torch_recon import close, leaves, to_torch, ulps

CFG = J.tiny_config()
N = 16
IO_REL = 1e-5
GRAD_REL = 2e-3
LOSS_REL = 1e-4
AQ_MAX_REL, AQ_MEAN_REL = 1.5e-2, 1e-2
ACT_LOSS_REL = 1e-2
ACT_GRAD_REL, ACT_GRAD_FLOOR = 1e-2, 1e-5
ADAM_ULPS = 4
ACT_MOVE_SHARE = 1.0
HARD_EQUAL = 0.999
UNIT = "mid.block_1"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Long loops of small CPU ops run on one intra-op thread (as in
    test_torch_recon.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def key_rows(key, split_first: bool):
    """JAX's minibatch rows from ``key``: per iteration one split and a
    permutation (recon.py:383, :777), after one split for the segment in
    the weight phase (recon.py:663)."""
    def fn(unit, n, bs, iters):
        k = jax.random.split(key)[1] if split_first else key
        rows = []
        for _ in range(iters):
            k, k1 = jax.random.split(k)
            rows.append(np.asarray(jax.random.permutation(k1, n))[:bs])
        return torch.from_numpy(np.stack(rows)).long()
    return fn


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def s():
    rng = np.random.default_rng(0)
    np_p = random_params(CFG, rng)
    jp = jax.tree.map(jnp.asarray, np_p)
    x = rng.standard_normal((N, 16, 16, 3)).astype(np.float32)
    t = rng.integers(0, 100, N).astype(np.int32)
    ja = JU.build_adapter(CFG, w_bits=8, a_bits=8)
    ta = TU.build_adapter(T.tiny_config(), w_bits=8, a_bits=8)
    jw = JR.init_weight_qparams(ja.policy, jp, scaler="minmax")
    jcali = (jnp.asarray(x), jnp.asarray(t))
    tp = params_from_numpy(np_p, "cpu")
    tcali = (torch.from_numpy(x), torch.from_numpy(t))
    jas = act_init(ta, tp, to_torch(jw), tcali)
    return dict(np_p=np_p, jp=jp, tp=tp, ja=ja, ta=ta, jw=jw,
                tw=to_torch(jw), jcali=jcali, tcali=tcali, jas=jas,
                tas=to_torch(jas))


def act_init(ta, tp, tw, tcali):
    """The act state (numpy) of the lazy init forward on 8 rows
    (tests/test_calibration.py::test_act_phase_reconstruction), minmax:
    the port's, handed to both sides."""
    ctx = TCtx(ta.policy, wstate=tw, use_wq=True, use_aq=True,
               act_mode="init", act_scaler="minmax")
    with torch.no_grad():
        ta.forward(tp, ctx, *(a[:8] for a in tcali))
    return {k: {f: v.numpy() for f, v in st.items()}
            for k, st in ctx.out_astate.items()}


# ---------------------------------------------------------------------------
# the quantizer
# ---------------------------------------------------------------------------

def test_ste_round_passes_the_gradient_straight():
    x = np.array([1.3, -0.7, 2.5, -2.5, 0.49], np.float32)
    ref = np.asarray(jax.grad(lambda v: jnp.sum(JQ.ste_round(v) ** 2))(
        jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    (TQ.ste_round(xt) ** 2).sum().backward()
    assert ulps(xt.grad.numpy(), ref) == 0
    assert torch.equal(TQ.ste_round(torch.from_numpy(x)),
                       torch.round(torch.from_numpy(x)))


@pytest.mark.parametrize("cfg", [dict(bits=8), dict(bits=4, symmetric=True),
                                 dict(bits=8, always_zero=True)],
                         ids=["a8", "w4sym", "softmax8"])
def test_fake_quant_gradients_match_jax(cfg):
    """d fake_quant / d x and d / d delta against jax.grad, with a quarter
    of the elements past the grid's ends and some exactly on its bounds:
    there the clip passes half the gradient."""
    rng = np.random.default_rng(1)
    x = (2.0 * rng.standard_normal(512)).astype(np.float32)
    if cfg.get("always_zero"):
        x = np.abs(x)
    delta = np.float32(0.02 if cfg["bits"] == 8 else 0.3)
    zp = np.float32(0.0 if cfg.get("symmetric") or cfg.get("always_zero")
                    else 100.0)
    jcfg, tcfg = JQ.QCfg(**cfg), TQ.QCfg(**cfg)
    nb, pb = jcfg.qrange
    x[:8] = ((pb - zp) * delta, (nb - zp) * delta) * 4   # on the bounds
    g = rng.standard_normal(512).astype(np.float32)

    def jloss(v, d):
        return jnp.sum(JQ.fake_quant(v, d, jnp.float32(zp), jcfg) * g)
    jgx, jgd = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x),
                                               jnp.asarray(delta))
    xt = torch.from_numpy(x).requires_grad_()
    dt = torch.tensor(delta).requires_grad_()
    out = TQ.fake_quant(xt, dt, torch.tensor(zp), tcfg)
    (out * torch.from_numpy(g)).sum().backward()
    ref = TQ.fake_quant(torch.from_numpy(x), torch.tensor(delta),
                        torch.tensor(zp), tcfg)
    assert torch.equal(out.detach(), ref)   # the same values as no-grad
    jgx = np.asarray(jgx)
    assert ulps(xt.grad.numpy(), jgx) <= 1
    code = np.round(x * (np.float32(1) / delta)) + zp
    on_bound = (code == nb) | (code == pb)
    inside = (code > nb) & (code < pb)
    assert on_bound[:8].all() and (~inside).sum() > 8
    np.testing.assert_allclose(jgx[on_bound], 0.5 * g[on_bound], rtol=1e-6)
    assert abs(float(dt.grad) - float(jgd)) <= 1e-5 * abs(float(jgd))


@pytest.mark.parametrize("scaler", ["kl", "hist"])
@pytest.mark.parametrize("data", ["normal", "relu3", "constant"])
def test_host_scalers_bit_equal_jax(scaler, data):
    """The KL and histogram clips (float64 numpy), then minmax, bit for bit
    at 8 and 4 bits, per tensor and per channel (init_qparams)."""
    rng = np.random.default_rng(2)
    x = {"normal": rng.standard_normal((64, 32)),
         "relu3": np.abs(rng.standard_normal((64, 32))) ** 3,
         "constant": np.full((64, 32), 0.7)}[data].astype(np.float32)
    for cfg in (dict(bits=8), dict(bits=4, symmetric=True),
                dict(bits=4, channel_wise=True)):
        jd, jz = JQ.init_qparams(jnp.asarray(x), JQ.QCfg(**cfg),
                                 scaler=scaler)
        td, tz = TQ.init_qparams(torch.from_numpy(x), TQ.QCfg(**cfg),
                                 scaler=scaler)
        assert td.shape == np.shape(jd)
        assert np.asarray(jd).tobytes() == td.numpy().tobytes(), cfg
        assert np.asarray(jz).tobytes() == tz.numpy().tobytes(), cfg


@pytest.mark.parametrize("scaler", ["kl", "hist"])
def test_fsc_init_pass_takes_the_host_scalers(s, scaler):
    """The FSC init pass (``act_mode="init"``) reaches the KL and
    histogram scalers through ``SCALERS`` (fsc.py:34): every site's grid
    is ``init_qparams`` of the activation it saw, bit for bit, and the
    scalers are JAX's bit for bit (above). JAX's jitted init pass cannot
    call its host numpy scalers."""
    seen = {}

    class Seen(TCtx):
        def qact(self, name, x):
            seen[name] = x.clone()
            return super().qact(name, x)

    ctx = Seen(s["ta"].policy, wstate=s["tw"], use_wq=True, use_aq=True,
               act_mode="init", act_scaler=scaler)
    with torch.no_grad():
        s["ta"].forward(s["tp"], ctx, *(a[:4] for a in s["tcali"]))
    assert ctx.out_astate and set(ctx.out_astate) <= set(seen)
    for site, st in ctx.out_astate.items():
        d, z = TQ.init_qparams(seen[site], s["ta"].policy.get(site).a_cfg,
                               scaler=scaler)
        assert torch.equal(st["delta"], d) and torch.equal(st["zp"], z)


# ---------------------------------------------------------------------------
# capture, the Fisher gradients and losses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["symmetric", "use_aq"])
def test_capture_unit_io_matches_jax(s, unit_io, mode):
    """``asym=False``: inputs and outputs of the FP forward; ``use_aq``:
    inputs under the prefix quantized with the act state."""
    kw = dict(asym=False) if mode == "symmetric" else \
        dict(asym=True, use_aq=True)
    jin, jout = unit_io["aq"] if mode == "use_aq" else JR.capture_unit_io(
        s["ja"], s["ja"].unit_by_name(UNIT), s["jp"], s["jcali"], s["jw"],
        batch_size=8, **kw)
    tin, tout = TR.capture_unit_io(
        s["ta"], s["ta"].unit_by_name(UNIT), s["tp"], s["tcali"], s["tw"],
        s["tas"] if mode == "use_aq" else None, batch_size=8, **kw)
    for g, r in zip(leaves(tin), leaves(jin)):
        g, r = g.numpy(), np.asarray(r)
        if mode == "symmetric":
            close(g, r)
        else:   # downstream of act quantizers: flipped codes
            assert np.abs(g - r).max() <= AQ_MAX_REL * np.abs(r).max()
            assert np.abs(g - r).mean() <= AQ_MEAN_REL * np.abs(r).mean()
    close(tout.numpy(), jout)
    if mode == "symmetric":   # the FP input is the FP model's own
        ctx = TCtx(s["ta"].policy, capture=frozenset({UNIT}))
        T.apply(s["tp"], T.tiny_config(), *s["tcali"], ctx)
        for g, r in zip(leaves(tin), leaves(ctx.tape[f"{UNIT}::in"])):
            assert torch.equal(g, r)


@pytest.fixture(scope="module")
def unit_io(s):
    """JAX's cached I/O of the unit (capture batches of 8), numpy, shared
    by the capture, Fisher and act tests: "w" with the weights quantized,
    "aq" under the act state too."""
    ju = s["ja"].unit_by_name(UNIT)
    return dict(
        w=np_tree(JR.capture_unit_io(s["ja"], ju, s["jp"], s["jcali"],
                                     s["jw"], batch_size=8)),
        aq=np_tree(JR.capture_unit_io(s["ja"], ju, s["jp"], s["jcali"],
                                      s["jw"], s["jas"], asym=True,
                                      use_aq=True, batch_size=8)))


def test_capture_unit_grads_matches_jax(s):
    """|d KL / d unit output| + 1 through the override pass: the shape of
    the unit's output over every row, >= 1 and within 2 ulp of JAX's; the
    gradient itself (|g| is below 2e-4 here, so + 1 keeps only its top
    bits) of one batch within GRAD_REL of JAX's."""
    fisher = np.asarray(JR.capture_unit_grads(
        s["ja"], s["ja"].unit_by_name(UNIT), s["jp"], s["jcali"], s["jw"],
        batch_size=8))
    unit = s["ta"].unit_by_name(UNIT)
    got = TR.capture_unit_grads(s["ta"], unit, s["tp"], s["tcali"],
                                s["tw"], batch_size=8)
    assert got.shape == fisher.shape and got.shape[0] == N
    assert float(got.min()) >= 1.0
    assert ulps(got.numpy(), fisher) <= 2
    sub = TR.wstate_upto(s["ta"], unit, s["tw"])
    ref = JR._grad_batch(s["ja"], UNIT, False, s["jp"],
                         {k: s["jw"][k] for k in sub}, {},
                         tuple(a[:8] for a in s["jcali"]))
    g = TR._grad_batch(s["ta"], UNIT, False, s["tp"], sub, {},
                       tuple(a[:8] for a in s["tcali"]))
    close(g.numpy(), np.asarray(ref), rel=GRAD_REL)


def test_override_replaces_the_unit_output_and_runs_on(s):
    """An "out" override feeds the rest of the forward, also under a tape
    with stop_when_taped: the unit's own output reproduces the forward
    bit for bit, zeros change it. (JAX's override, through the Fisher
    gradients, is held above.)"""
    def fwd(ctx=None):
        return T.apply(s["tp"], T.tiny_config(), *s["tcali"], ctx)

    ref = fwd()
    ctx = TCtx(s["ta"].policy, capture=frozenset({UNIT}))
    fwd(ctx)
    own = ctx.tape[f"{UNIT}::out"]
    assert torch.equal(fwd(TCtx(s["ta"].policy, override={UNIT: own})), ref)
    zero = torch.zeros_like(own)
    octx = TCtx(s["ta"].policy, override={UNIT: zero},
                capture=frozenset({UNIT}), stop_when_taped=True)
    got = fwd(octx)
    assert torch.equal(octx.tape[f"{UNIT}::out"], zero)
    assert got.shape == ref.shape and not torch.equal(got, ref)


@pytest.mark.parametrize("rloss", ["fisher_diag", "fisher_full"])
def test_fisher_losses_match_jax(rloss):
    rng = np.random.default_rng(3)
    a, b = (rng.standard_normal((4, 4, 4, 8)).astype(np.float32)
            for _ in range(2))
    g = (np.abs(rng.standard_normal((4, 4, 4, 8))) + 1).astype(np.float32)
    ref = JR._rec_loss(jnp.asarray(a), jnp.asarray(b), 2.0, rloss,
                       jnp.asarray(g))
    got = TR._rec_loss(torch.from_numpy(a), torch.from_numpy(b), 2.0, rloss,
                       torch.from_numpy(g))
    assert abs(float(got) - float(ref)) <= 1e-6 * abs(float(ref))


# ---------------------------------------------------------------------------
# reconstruction: Fisher weight phase, act phase
# ---------------------------------------------------------------------------

def _hard_share(jw, tw, names):
    eq = tot = 0
    for full in names:
        if "alpha" in jw.get(full, {}):
            a = np.asarray(jw[full]["alpha"]) >= 0
            eq += int((a == (tw[full]["alpha"].numpy() >= 0)).sum())
            tot += a.size
    assert tot > 0
    return eq / tot


def chained_rows(key):
    """JAX's rows of ``reconstruct_unit`` without a partial path: each
    call (the whole schedule, or one chunk of a host cache, in order)
    splits the key once (recon.py:663), then once per iteration."""
    state = {"key": key}

    def fn(unit, n, bs, iters):
        state["key"], k = jax.random.split(state["key"])
        return key_rows(k, False)(unit, n, bs, iters)
    return fn


@pytest.mark.parametrize("cache", ["device", "host"])
@pytest.mark.parametrize("rloss", ["fisher_diag", "fisher_full"])
def test_reconstruct_unit_fisher_matches_jax(s, unit_io, monkeypatch,
                                             rloss, cache):
    """The weight phase with a Fisher loss on JAX's minibatches, both
    sides given the same Fisher weights |N(0, 1)| * 3 + 1 (the model's
    own are all about 1, so a weight gathered with the wrong row would not
    show): the loss at every iteration, the hardened alphas and the guard.
    "host" hands both a host cache (numpy), which runs the chunked
    schedule, chunks of one minibatch, each with its rows' weights."""
    ju, tu = s["ja"].unit_by_name(UNIT), s["ta"].unit_by_name(UNIT)
    jin, jout = unit_io["w"]
    fg = (np.abs(np.random.default_rng(9).standard_normal(jout.shape)) * 3
          + 1).astype(np.float32)
    if cache == "host":
        for m in (JR, TR):
            monkeypatch.setattr(m, "_HOST_CHUNK_BYTES", 1)
        jargs = targs = (jin, jout, fg)
    else:
        jargs = jax.tree.map(jnp.asarray, (jin, jout, fg))
        targs = to_torch((jin, jout, fg))
    key = jax.random.PRNGKey(11)
    kw = dict(iters=16, batch_size=8, rloss=rloss)
    jst, tst = {}, {}
    jw2, jl = JR.reconstruct_unit(s["ja"], ju, s["jp"], s["jw"], *jargs[:2],
                                  JR.ReconHP(**kw), key, fgrads=jargs[2],
                                  stats=jst)
    tw2, tl = TR.reconstruct_unit(
        s["ta"], tu, s["tp"], s["tw"], *targs[:2], TR.ReconHP(**kw), None,
        targs[2], stats=tst, indices=chained_rows(key))
    assert tst[UNIT]["kept"] == jst[UNIT]["kept"]
    for k in ("hard_nearest", "hard_trained"):
        assert abs(tst[UNIT][k] - jst[UNIT][k]) <= LOSS_REL * jst[UNIT][k]
    jl, tl = np.asarray(jl), tl.numpy()
    assert np.all(np.isfinite(tl)) and tl.shape == jl.shape == (16,)
    assert np.all(np.abs(tl - jl) <= LOSS_REL * np.abs(jl))
    assert _hard_share(jw2, tw2, [f for _, f in tu.layers]) >= HARD_EQUAL


def record_adam(monkeypatch):
    """Every call of the port's ``adam_update``: (the parameters it was
    given, their gradients, the parameters it returned)."""
    trace = []
    orig = TR.adam_update

    def rec(params, grads, *a, **k):
        out = orig(params, grads, *a, **k)
        trace.append(tuple({r: v.detach().clone() for r, v in d.items()}
                           for d in (params, grads, out[0])))
        return out

    monkeypatch.setattr(TR, "adam_update", rec)
    return trace


def _act_sites(adapter, unit, astate):
    """{role: site} of the unit's activation quantizers in ``astate``."""
    return {role: full for role, full in
            tuple(unit.layers) + tuple(unit.act_sites)
            if (pol := adapter.policy.get(full)) is not None and pol.aq
            and full in astate}


def _jax_act_grad(ja, ju, jp, jw, jas, jin, jout, hp, rows):
    """jax.grad of JAX's act-phase loss (recon.py:763-767) with respect to
    the unit's deltas, at the calibrated deltas, on the rows ``rows``."""
    sites = _act_sites(ja, ju, jas)
    d0 = {r: jnp.asarray(jas[f]["delta"]) for r, f in sites.items()}
    zps = {r: jnp.asarray(jas[f]["zp"]) for r, f in sites.items()}
    role_cfgs = ja.role_cfgs(ju, frozenset())
    uparams = ja.extract_uparams(jp, ju)
    wroles = {r: jw[f] for r, f in ju.layers if f in jw}
    binp, bout = (JR._f32(jax.tree.map(lambda x: jnp.asarray(x[rows]), t))
                  for t in (jin, jout))

    def loss(d):
        ast = {r: {"delta": d[r], "zp": zps[r]} for r in d}
        pred = ja.unit_fwd(ju.kind, role_cfgs, ju.extra, uparams, wroles,
                           ast, binp, False, True)
        return JR._rec_loss(pred, bout, hp.p, hp.rloss, None)
    return np_tree(jax.jit(jax.grad(loss))(d0))


def _act_case(monkeypatch, ja, ta, jp, tp, jw, tw, jas, jcali, tcali, name,
              hp, key, jio=None):
    """JAX's and the port's reconstruct_unit_act on JAX's cached I/O and
    minibatch rows; the port's Adam steps recorded."""
    ju, tu = ja.unit_by_name(name), ta.unit_by_name(name)
    jin, jout = jio or np_tree(JR.capture_unit_io(
        ja, ju, jp, jcali, jw, jas, asym=True, use_aq=True, batch_size=8))
    jas2, jl = JR.reconstruct_unit_act(
        ja, ju, jp, jw, jas, *jax.tree.map(jnp.asarray, (jin, jout)),
        JR.ReconHP(**hp), key)
    rows = key_rows(key, False)
    n = leaves(jin)[0].shape[0]
    jg0 = _jax_act_grad(ja, ju, jp, jw, jas, jin, jout, JR.ReconHP(**hp),
                        rows(name, n, min(hp["batch_size"], n), 1)[0].numpy())
    tst = {}
    trace = record_adam(monkeypatch)
    tas2, tl = TR.reconstruct_unit_act(
        ta, tu, tp, tw, to_torch(jas), to_torch(jin), to_torch(jout),
        TR.ReconHP(**hp), stats=tst, indices=rows)
    return dict(jas2=jas2, jl=jl, tas2=tas2, tl=tl, rec=tst[name],
                trace=trace, jg0=jg0, sites=_act_sites(ta, tu, tas2))


def _lr_budget(hp) -> float:
    """The sum of the act phase's learning rates: about the most Adam can
    move a delta in the run."""
    c = np.arange(hp["iters"])
    lr = hp.get("lr_delta", 4e-5)
    return float(np.sum(lr * 0.5 * (1 + np.cos(np.pi * c / hp["iters"]))))


def _check_act(jas, r, hp):
    jl, tl = np.asarray(r["jl"]), r["tl"].numpy()
    assert tl.shape == jl.shape == (hp["iters"],)
    # the first iteration runs on the same deltas
    assert abs(tl[0] - jl[0]) <= LOSS_REL * jl[0]
    assert np.all(np.abs(tl - jl) <= ACT_LOSS_REL * np.abs(jl))
    # the gradient: the first step's against jax.grad on the same rows
    trace, jg0 = r["trace"], r["jg0"]
    assert len(trace) == hp["iters"]
    p0, g0, first = trace[0]
    assert set(g0) == set(jg0) == set(r["sites"])
    top = max(float(np.abs(v).max()) for v in jg0.values())
    assert top > 0
    for role in g0:
        g, ref = g0[role].numpy(), np.asarray(jg0[role])
        assert np.all(np.abs(g - ref) <= ACT_GRAD_REL * np.abs(ref)
                      + ACT_GRAD_FLOOR * top), role
    # the optimizer: optax's adam on its cosine schedule, fed the port's
    # gradients; every step starts where the last ended
    lr = hp.get("lr_delta", 4e-5)
    opt = optax.adam(optax.cosine_decay_schedule(lr, hp["iters"]))
    d = {role: jnp.asarray(v.numpy()) for role, v in p0.items()}
    ost = opt.init(d)
    for c, (p, g, new) in enumerate(trace):
        if c:
            assert all(torch.equal(p[k], trace[c - 1][2][k]) for k in p)
        u, ost = opt.update({k: jnp.asarray(v.numpy())
                             for k, v in g.items()}, ost)
        d = optax.apply_updates(d, u)
        for k in new:
            assert ulps(new[k].numpy(), np.asarray(d[k])) <= ADAM_ULPS, \
                (c, k)
    # Adam's first step is the learning rate against the gradient's sign
    # (g / (|g| + eps) in full: eps / |g| short of it)
    for k in first:
        g = g0[k].numpy().astype(np.float64)
        with np.errstate(divide="ignore"):
            tol = lr * (1e-3 + 1e-8 / np.abs(g))
        assert np.all(np.abs(first[k].numpy() - (p0[k].numpy()
                                                 - lr * np.sign(g)))
                      <= tol), k
    # the guard: JAX's decision; the deltas kept are the last step's
    jkept = any(not np.array_equal(np.asarray(r["jas2"][k]["delta"]),
                                   np.asarray(jas[k]["delta"])) for k in jas)
    assert r["rec"]["kept"] == ("trained" if jkept else "calibrated")
    tas2 = r["tas2"]
    assert set(tas2) == set(r["jas2"])
    for site in r["jas2"]:
        assert np.array_equal(tas2[site]["zp"].numpy(),
                              np.asarray(r["jas2"][site]["zp"]))
    for role, site in r["sites"].items():
        assert torch.equal(tas2[site]["delta"],
                           (trace[-1][2] if jkept else p0)[role])


def test_reconstruct_unit_act_matches_jax_ddim(s, unit_io, monkeypatch):
    """One ddim res unit, 24 iterations: the losses, the first gradient,
    the Adam trajectory, the zero points and the guard's decision."""
    hp = dict(iters=24, batch_size=8)
    r = _act_case(monkeypatch, s["ja"], s["ta"], s["jp"], s["tp"], s["jw"],
                  s["tw"], s["jas"], s["jcali"], s["tcali"], UNIT, hp,
                  jax.random.PRNGKey(5), unit_io["aq"])
    _check_act(s["jas"], r, hp)
    assert r["rec"]["kept"] == "trained"


@pytest.fixture(scope="module")
def cin():
    """tiny_cin's UNet (spatial transformers, class context) with the
    attention act sites, w4a8, 12 rows."""
    jc = JL.tiny_sd_config(context_dim=16)
    tc = TL.tiny_sd_config(context_dim=16)
    rng = np.random.default_rng(6)
    np_p = ldm_random_params(JL.iter_layers(jc), rng)
    jp = jax.tree.map(jnp.asarray, np_p)
    n = 12
    data = [rng.standard_normal((n, 8, 8, 3)).astype(np.float32),
            rng.integers(0, 100, n).astype(np.int32),
            rng.standard_normal((n, 1, 16)).astype(np.float32)]
    ja = JLU.build_adapter(jc, w_bits=4, a_bits=8, use_aq=True)
    ta = TLU.build_adapter(tc, w_bits=4, a_bits=8, use_aq=True)
    jw = JR.init_weight_qparams(ja.policy, jp, scaler="minmax")
    tp = params_from_numpy(np_p, "cpu")
    tcali = tuple(torch.from_numpy(a) for a in data)
    return dict(ja=ja, ta=ta, jp=jp, tp=tp, jw=jw, tw=to_torch(jw),
                jas=act_init(ta, tp, to_torch(jw), tcali),
                jcali=tuple(jnp.asarray(a) for a in data), tcali=tcali)


def test_reconstruct_unit_act_matches_jax_tiny_cin(cin, monkeypatch):
    """A tiny_cin transformer unit (self- and cross-attention act sites)."""
    name = next(u.name for u in cin["ta"].units if u.kind == "btb")
    hp = dict(iters=16, batch_size=4)
    # both sides train on the port's capture (captures are held against
    # JAX's above and in test_torch_ldm_recon.py)
    io = TR.capture_unit_io(cin["ta"], cin["ta"].unit_by_name(name),
                            cin["tp"], cin["tcali"], cin["tw"],
                            to_torch(cin["jas"]), asym=True, use_aq=True,
                            batch_size=8)
    r = _act_case(monkeypatch, cin["ja"], cin["ta"], cin["jp"], cin["tp"],
                  cin["jw"], cin["tw"], cin["jas"], cin["jcali"],
                  cin["tcali"], name, hp, jax.random.PRNGKey(7),
                  jax.tree.map(lambda t: t.numpy(), io))
    _check_act(cin["jas"], r, hp)


def test_act_guard_reverts_on_regression(s):
    """A sabotaged act-phase lr leaves the calibrated deltas intact
    (tests/test_recon_guard.py::test_act_guard_reverts_on_regression)."""
    unit = s["ta"].unit_by_name(UNIT)
    inputs, outputs = TR.capture_unit_io(
        s["ta"], unit, s["tp"], s["tcali"], s["tw"], s["tas"], asym=True,
        use_aq=True)
    stats = {}
    new, losses = TR.reconstruct_unit_act(
        s["ta"], unit, s["tp"], s["tw"], s["tas"], inputs, outputs,
        TR.ReconHP(iters=20, batch_size=8, lr_delta=50.0),
        torch.Generator().manual_seed(5), stats=stats)
    assert stats[UNIT]["kept"] == "calibrated"
    assert stats[UNIT]["loss_after"] >= stats[UNIT]["loss_before"]
    assert np.all(np.isfinite(losses.numpy()))
    for site, st in new.items():
        assert torch.equal(st["delta"], s["tas"][site]["delta"])


def test_reconstruct_act_matches_jax(s):
    """The act phase over the TIB and a unit (the shared FP-output cache,
    the unit's inputs under the TIB's trained deltas, a key a unit): every
    site present, zero points and each unit's guard decision as JAX's,
    the deltas within the sum of the learning rates of JAX's (the unit
    tests above hold the gradient and the optimizer tightly). JAX's own
    test of ``reconstruct_act`` (tests/test_calibration.py:305) runs every
    unit."""
    names = ("tib", UNIT)
    ja = dataclasses.replace(s["ja"], units=tuple(
        s["ja"].unit_by_name(n) for n in names))
    ta = dataclasses.replace(s["ta"], units=tuple(
        s["ta"].unit_by_name(n) for n in names))
    # the unit test's hp: JAX compiles the unit's act loop once
    hp = dict(iters=24, batch_size=8)
    key = jax.random.PRNGKey(6)
    ref = JR.reconstruct_act(ja, s["jp"], s["jcali"], s["jw"], s["jas"],
                             JR.ReconHP(**hp), key, capture_batch_size=8)
    keys, k = [], key
    for _ in names:   # one split a unit (recon.py:905)
        k, ku = jax.random.split(k)
        keys.append(ku)
    keys = iter(keys)
    stats = {}
    got = TR.reconstruct_act(ta, s["tp"], s["tcali"], s["tw"], s["tas"],
                             TR.ReconHP(**hp), capture_batch_size=8,
                             indices=lambda u, n, bs, it: key_rows(
                                 next(keys), False)(u, n, bs, it),
                             stats=stats)
    assert set(got) == set(s["tas"]) == set(ref)
    assert set(stats) == set(names)
    for name in names:
        sites = _act_sites(ta, ta.unit_by_name(name), s["tas"]).values()
        jkept = any(float(ref[f]["delta"]) != float(s["jas"][f]["delta"])
                    for f in sites)
        assert stats[name]["kept"] == ("trained" if jkept else
                                       "calibrated"), name
    for site in ref:
        assert np.array_equal(got[site]["zp"].numpy(),
                              np.asarray(ref[site]["zp"]))
        jd, td = float(ref[site]["delta"]), float(got[site]["delta"])
        assert abs(td - jd) <= ACT_MOVE_SHARE * _lr_budget(hp), site


# ---------------------------------------------------------------------------
# mid-unit resume: the port against itself
# ---------------------------------------------------------------------------

def _alphas(w):
    return {k: v["alpha"].numpy() for k, v in w.items() if "alpha" in v}


@pytest.mark.parametrize("cache,rloss", [("device", "mse"),
                                         ("host", "fisher_diag")])
def test_midunit_crash_resume(s, tmp_path, monkeypatch, cache, rloss):
    """Segments of 4 iterations, a crash after the 5th partial save (the
    second segment of the second unit), a re-run: the alphas and records
    bit-equal to an uninterrupted run and to a run without resume_dir, no
    .partial file left. "host" caches every unit but the TIB on the host
    (the chunked schedule: 4 chunks of 4 rows, 3 iterations each, the
    segments cut at the chunks' ends) and weights the loss with the
    Fisher weights that ``reconstruct`` captures (the TIB keeps the Lp
    loss)."""
    names = ("tib", "down.0.block.0", UNIT, "mid.attn_1")
    ta = dataclasses.replace(s["ta"], units=tuple(
        s["ta"].unit_by_name(n) for n in names))
    monkeypatch.setattr(TR, "RESUME_SEG_ITERS", 4)
    if cache == "host":
        monkeypatch.setattr(TR, "HOST_OFFLOAD_BYTES", 1)
        monkeypatch.setattr(TR, "_HOST_CHUNK_BYTES", 1)
    hp = TR.ReconHP(iters=12, batch_size=4, rloss=rloss)

    def run(d=None, stats=None):
        return TR.reconstruct(ta, s["tp"], s["tcali"], dict(s["tw"]), hp,
                              torch.Generator().manual_seed(33),
                              capture_batch_size=8, resume_dir=d,
                              stats=stats)

    st_plain, st_ok, st_res = {}, {}, {}
    w_plain = run(stats=st_plain)
    w_ok = run(str(tmp_path / "ok"), st_ok)
    saves = {"n": 0}
    orig = TR._save_partial

    def bomb(*a, **k):
        orig(*a, **k)
        saves["n"] += 1
        if saves["n"] == 5:
            raise RuntimeError("simulated crash")

    monkeypatch.setattr(TR, "_save_partial", bomb)
    crashy = tmp_path / "crashy"
    with pytest.raises(RuntimeError, match="simulated"):
        run(str(crashy))
    monkeypatch.setattr(TR, "_save_partial", orig)
    partial = [f for f in os.listdir(crashy) if f.endswith(".partial")]
    assert partial == ["down.0.block.0.npz.partial"]
    # inside the unit: device 8 (two segments of 4), host 6 (chunks of 3)
    assert int(np.load(crashy / partial[0])["__it0"]) == \
        (8 if cache == "device" else 6)
    w_res = run(str(crashy), st_res)
    assert not any(f.endswith(".partial") for f in os.listdir(crashy))
    a_plain, a_ok, a_res = (_alphas(w) for w in (w_plain, w_ok, w_res))
    assert set(a_plain) == set(a_ok) == set(a_res) and a_plain
    for k in a_plain:
        assert np.array_equal(a_ok[k], a_plain[k]), k
        assert np.array_equal(a_res[k], a_plain[k]), k
    assert st_plain == st_ok == st_res


def test_cli_cali_resumes_mid_unit(tmp_path, monkeypatch):
    """``cli.main --ptq --cali --resume_dir`` at tiny_ddim (weights only),
    crashed inside a unit and run again: the artifact equals an
    uninterrupted run's."""
    rng = np.random.default_rng(8)
    np_p = random_params(CFG, rng)
    ckpt = tmp_path / "tiny.npz"
    save_params(str(ckpt), np_p)
    monkeypatch.setattr(TR, "RESUME_SEG_ITERS", 3)
    # weights only: resume is the reconstruction's (FSC runs after it)
    args = ["--task", "tiny_ddim", "--ckpt", str(ckpt), "--ptq", "--cali",
            "--cali_iters", "6", "--cali_n", "4", "--timesteps", "2",
            "--device", "cpu", "--seed", "3"]
    assert cli.main(args + ["--cali_save_path", str(tmp_path / "ok.npz"),
                            "--resume_dir", str(tmp_path / "ok")]) == 0
    saves = {"n": 0}
    orig = TR._save_partial

    def bomb(*a, **k):
        orig(*a, **k)
        saves["n"] += 1
        if saves["n"] == 7:
            raise RuntimeError("simulated crash")

    monkeypatch.setattr(TR, "_save_partial", bomb)
    res_args = args + ["--cali_save_path", str(tmp_path / "res.npz"),
                       "--resume_dir", str(tmp_path / "res")]
    with pytest.raises(RuntimeError, match="simulated"):
        cli.main(res_args)
    monkeypatch.setattr(TR, "_save_partial", orig)
    assert any(f.endswith(".partial") for f in os.listdir(tmp_path / "res"))
    assert cli.main(res_args) == 0
    w1, a1, m1 = load_artifact(str(tmp_path / "ok.npz"), device="cpu")
    w2, a2, m2 = load_artifact(str(tmp_path / "res.npz"), device="cpu")
    assert a1 is None and a2 is None
    # the residency record describes the run: the re-run's shared cache
    # holds only the units it had left
    r1, r2 = m1["recon"].pop("residency"), m2["recon"].pop("residency")
    assert r1["fp_out_cache"] == r2["fp_out_cache"] == "shared"
    assert m1 == m2
    assert set(w1) == set(w2)
    assert sum("alpha" in st for st in w1.values()) > 0
    for k in w1:
        for f in w1[k]:
            assert torch.equal(w1[k][f], w2[k][f]), (k, f)
