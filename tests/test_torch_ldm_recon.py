"""The port's LDM reconstruction units (``models/ldm_units.py``), the LDM
UNet's capture taps and ``tib_forward``, and the reconstruction engine's
residency rules (the shared FP-output cache or a fused capture per unit,
the host cache with its chunked schedule) against the JAX package on the
CPU, at ``tiny_ldm_config`` (AttentionBlocks) and ``tiny_sd_config``
(SpatialTransformers with a cross-attention context).

Both sides start from the same numpy parameters, inputs and weight grids
(w4a8 with the attention act sites, minmax weight grids, 12 calibration
rows); the port draws its minibatches from JAX's own key splits
(recon.py:383, :663), replayed here and passed in as the index source.
The residency thresholds are set small on both sides, so that the
per-unit fused capture, the host cache and the chunked schedule run at
this size.

Tolerances (test_torch_recon.py's, where PR 13's measurements are):
captured I/O and unit forwards within 1e-5 of the largest magnitude (f32
convolutions and matrix products summed in another order); float16
caches within one float16 step more. Reconstruction: loss traces within
LOSS_REL relative, hardened alphas 100% equal, guard decisions identical.
"""

import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfmq_dm_tpu.models import ldm_unet as JL
from tfmq_dm_tpu.models import ldm_units as JLU
from tfmq_dm_tpu.quant import recon as JR
from tfmq_dm_tpu_torch.convert import params_from_numpy
from tfmq_dm_tpu_torch.models import ldm_unet as TL
from tfmq_dm_tpu_torch.models import ldm_units as TLU
from tfmq_dm_tpu_torch.quant import recon as TR
from tfmq_dm_tpu_torch.quant.context import QuantCtx as TCtx
from test_torch_ldm_modules import random_params
from test_torch_recon import close, leaves, to_torch

FAMILIES = {"ldm": "tiny_ldm_config", "sd": "tiny_sd_config"}
N, CTX_LEN, CAPTURE = 12, 5, 8
HP = dict(iters=24, batch_size=4)
LOSS_REL = 1.5e-5
# ``reconstruct`` over several units: each side captures its own I/O, so
# a float16 host cache can hold a value one float16 step apart (a capture
# summed in another order, on a rounding boundary); measured 3.7e-5 on
# the host-cached unit, 2.3e-6 on the device; test_torch_cali_cli.py's
# limit for its runs over every unit
FULL_RUN_LOSS_REL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Long loops of small CPU ops run on one intra-op thread: the test
    workers share the CPU, and idle threads spinning at every op's
    barrier cost more than the threads gain."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_rows(key):
    """JAX's minibatch rows of ``reconstruct_unit(key)``: one key split
    for each segment of the schedule (the whole schedule, or a chunk of a
    host cache, recon.py:663), then one per iteration (recon.py:383)."""
    state = [key]

    def fn(unit, n, bs, iters):
        state[0], k = jax.random.split(state[0])
        rows = []
        for _ in range(iters):
            k, k1 = jax.random.split(k)
            rows.append(np.asarray(jax.random.permutation(k1, n))[:bs])
        return torch.from_numpy(np.stack(rows)).long()
    return fn


def host_close(got, ref):
    """Two float16 host caches: the f32 values' own difference, then at
    most one float16 step apart."""
    assert isinstance(got, np.ndarray) and got.dtype == np.float16
    assert isinstance(ref, np.ndarray) and ref.dtype == np.float16
    g, r = got.astype(np.float32), ref.astype(np.float32)
    step = np.maximum(np.abs(g), np.abs(r)) * 2.0 ** -10 + \
        1e-5 * float(np.abs(r).max())
    assert not (np.abs(g - r) > step).any()


def cache_close(got, ref):
    for g, r in zip(leaves(got), leaves(ref)):
        if isinstance(r, np.ndarray) and r.dtype == np.float16:
            host_close(g, r)
        elif np.asarray(r).dtype == np.float16:
            assert g.dtype == torch.float16
            host_close(g.numpy(), np.asarray(r))
        else:
            close(g.numpy(), np.asarray(r))


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def fam(request):
    name = FAMILIES[request.param]
    jc, tc = getattr(JL, name)(), getattr(TL, name)()
    rng = np.random.default_rng(3 if request.param == "ldm" else 4)
    np_p = random_params(JL.iter_layers(jc), rng)
    jp = jax.tree.map(jnp.asarray, np_p)
    x = rng.standard_normal((N, jc.image_size, jc.image_size,
                             jc.in_channels)).astype(np.float32)
    t = rng.integers(0, 100, N).astype(np.int32)
    data = [x, t]
    if jc.context_dim:
        data.append(rng.standard_normal((N, CTX_LEN, jc.context_dim))
                    .astype(np.float32))
    ja = JLU.build_adapter(jc, w_bits=4, a_bits=8, use_aq=True)
    ta = TLU.build_adapter(tc, w_bits=4, a_bits=8, use_aq=True)
    jw = JR.init_weight_qparams(ja.policy, jp, scaler="minmax")
    return dict(family=request.param, jc=jc, tc=tc, np_p=np_p, jp=jp,
                tp=params_from_numpy(np_p, "cpu"), ja=ja, ta=ta, jw=jw,
                tw=to_torch(jw), jcali=tuple(jnp.asarray(a) for a in data),
                tcali=tuple(torch.from_numpy(a) for a in data))


def pick(fam, kind: str):
    """The first unit of ``kind`` that trains (for res_ldm: one with a
    skip connection; for layer: a 3x3 conv at tiny_ldm, the 1x1 proj_in
    at tiny_sd)."""
    ta = fam["ta"]
    for u in ta.units:
        if u.kind != kind or not ta.default_train_roles(u):
            continue
        if kind == "res_ldm" and \
                f"{u.name}.skip_connection" not in fam["np_p"]:
            continue
        if kind == "layer":
            k = fam["np_p"][u.layers[0][1]]["w"].shape[0]
            if k != (3 if fam["family"] == "ldm" else 1):
                continue
        return u.name
    raise LookupError(kind)


KINDS = {"ldm": ("res_ldm", "attn_ldm", "layer", "tib_ldm"),
         "sd": ("res_ldm", "btb", "layer", "tib_ldm")}
# the unit kinds by place: "attn" is attn_ldm at tiny_ldm, btb at tiny_sd
PLACES = ("res", "attn", "layer", "tib")


def kind_at(fam, place: str) -> str:
    return KINDS[fam["family"]][PLACES.index(place)]


# ---------------------------------------------------------------------------
# units, taps, the TIB
# ---------------------------------------------------------------------------

def test_units_match_jax(fam):
    """Order, names, kinds, layers, act sites, extra and the trained
    roles of every unit."""
    def spec(adapter):
        return [(u.name, u.kind, u.layers, u.act_sites, u.extra, u.recon,
                 sorted(adapter.default_train_roles(u)))
                for u in adapter.units]
    assert spec(fam["ta"]) == spec(fam["ja"])
    kinds = {u.kind for u in fam["ta"].units}
    assert kinds == set(KINDS[fam["family"]])
    assert fam["ta"].units[0].kind == "tib_ldm"


def test_taps_leave_apply_unchanged(fam):
    """A tape over every unit leaves the FP and the weight-quantized
    forwards bit-identical, and tapes each unit but the TIB; the FP
    forward is JAX's within 1e-5."""
    tp, tc, ta = fam["tp"], fam["tc"], fam["ta"]
    x, t, *c = fam["tcali"]
    c = c[0] if c else None
    ref = TL.apply(tp, tc, x, t, context=c)
    ctx = TCtx(ta.policy, capture=frozenset({"*"}))
    assert torch.equal(TL.apply(tp, tc, x, t, context=c, qctx=ctx), ref)
    assert {k.rsplit("::", 1)[0] for k in ctx.tape} == \
        {u.name for u in ta.units if u.kind != "tib_ldm"}
    q = [TL.apply(tp, tc, x, t, context=c, qctx=TCtx(
        ta.policy, wstate=fam["tw"], use_wq=True, capture=cap))
        for cap in (None, frozenset({"*"}))]
    assert torch.equal(q[0], q[1]) and not torch.equal(q[0], ref)
    jref = JL.apply(fam["jp"], fam["jc"], *fam["jcali"][:2],
                    context=None if c is None else fam["jcali"][2])
    close(ref.numpy(), jref)


def test_tib_forward_matches_jax(fam):
    """``tib_forward`` (FP and weight-quantized) against JAX's, and the
    TIB unit's FP forward on the timesteps against the model's."""
    tp, tc, ta = fam["tp"], fam["tc"], fam["ta"]
    t = fam["tcali"][1]
    got = TL.tib_forward(tp, tc, t)
    for g, r in zip(got, JL.tib_forward(fam["jp"], fam["jc"],
                                        fam["jcali"][1])):
        close(g.numpy(), r)
    from tfmq_dm_tpu.quant.context import QuantCtx as JCtx
    qg = TL.tib_forward(tp, tc, t, qctx=TCtx(ta.policy, wstate=fam["tw"],
                                             use_wq=True))
    qr = JL.tib_forward(fam["jp"], fam["jc"], fam["jcali"][1],
                        qctx=JCtx(fam["ja"].policy, wstate=fam["jw"],
                                  use_wq=True))
    assert len(qg) == len(qr) == fam["ta"].units[0].extra[1]
    for g, r in zip(qg, qr):
        close(g.numpy(), r)
    tib = ta.units[0]
    fp_rc = tuple(r.__class__(role=r.role)
                  for r in ta.role_cfgs(tib, frozenset()))
    out = TLU.unit_fwd(tib.kind, fp_rc, tib.extra,
                       TLU.extract_uparams(tp, tib), {}, {}, (t,), False,
                       False)
    for g, r in zip(out, got):
        close(g.numpy(), r.numpy())


@pytest.mark.parametrize("place", PLACES)
def test_unit_fwd_matches_model_and_jax(fam, place):
    """The unit forward on the FP model's tapped input gives the model's
    tapped output, and the soft-rounding forward with random alphas
    equals JAX's on the same inputs, within 1e-5 of the largest
    magnitude."""
    kind = kind_at(fam, place)
    ta, tp = fam["ta"], fam["tp"]
    tu = ta.unit_by_name(pick(fam, kind))
    up = TLU.extract_uparams(tp, tu)
    fp_rc = tuple(r.__class__(role=r.role)
                  for r in ta.role_cfgs(tu, frozenset()))
    x, t, *c = fam["tcali"]
    if kind == "tib_ldm":
        inp = (t,)
        ref = TL.tib_forward(tp, fam["tc"], t)
    else:
        ctx = TCtx(ta.policy, capture=frozenset({tu.name}))
        TL.apply(tp, fam["tc"], x, t, context=c[0] if c else None,
                 qctx=ctx)
        inp, ref = ctx.tape[f"{tu.name}::in"], ctx.tape[f"{tu.name}::out"]
    got = TLU.unit_fwd(tu.kind, fp_rc, tu.extra, up, {}, {}, inp, False,
                       False)
    for g, r in zip(leaves(got), leaves(ref)):
        close(g.numpy(), r.numpy())

    train = ta.default_train_roles(tu)
    rng = np.random.default_rng(6)
    ws = {}
    for role, full in tu.layers:
        if full in fam["jw"]:
            ws[role] = dict(fam["jw"][full])
            if role in train:
                ws[role]["alpha"] = rng.standard_normal(
                    fam["np_p"][full]["w"].shape).astype(np.float32)
    ja = fam["ja"]
    ju = ja.unit_by_name(tu.name)
    jref = JLU.unit_fwd(ju.kind, ja.role_cfgs(ju, train), ju.extra,
                        JLU.extract_uparams(fam["jc"])(fam["jp"], ju),
                        jax.tree.map(jnp.asarray, ws), {},
                        tuple(jnp.asarray(a.numpy()) for a in inp), True,
                        False)
    tgot = TLU.unit_fwd(tu.kind, ta.role_cfgs(tu, train), tu.extra, up,
                        to_torch(ws), {}, inp, True, False)
    for g, r in zip(leaves(tgot), leaves(jref)):
        close(g.numpy(), r)


# ---------------------------------------------------------------------------
# capture and residency
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["shared", "fused", "host"])
def test_capture_unit_io_matches_jax(fam, mode):
    """A unit's cached I/O three ways, as JAX's ``capture_unit_io``
    (recon.py:213-245): through the shared float16 FP-output cache, with
    the fused per-unit capture (float32 on the device), and to the host
    (float16 numpy; the fused capture), of the attention or transformer
    block (a res block's, through the shared cache and to the host, feeds
    the reconstruction tests)."""
    ja, ta = fam["ja"], fam["ta"]
    for name in [pick(fam, kind_at(fam, "attn"))]:
        jfp = tfp = None
        if mode == "shared":
            jfp = JR.precapture_fp_outs(ja, [name], fam["jp"],
                                        fam["jcali"], batch_size=CAPTURE)
            jfp = jfp[name]
            tfp = TR.precapture_fp_outs(ta, [name], fam["tp"],
                                        fam["tcali"],
                                        batch_size=CAPTURE)[name]
        host = mode == "host"
        jin, jout = JR.capture_unit_io(
            ja, ja.unit_by_name(name), fam["jp"], fam["jcali"], fam["jw"],
            asym=True, batch_size=CAPTURE, fp_out=jfp, to_host=host)
        tin, tout = TR.capture_unit_io(
            ta, ta.unit_by_name(name), fam["tp"], fam["tcali"], fam["tw"],
            batch_size=CAPTURE, to_host=host, fp_out=tfp)
        cache_close(tin, jin)
        cache_close(tout, jout)
        if host:
            assert all(isinstance(a, np.ndarray)
                       for a in leaves(tin) + leaves(tout))


@pytest.fixture(scope="module")
def unit_io(fam):
    """JAX's cached I/O of the units that reconstruct_unit runs, on the
    device (shared FP cache), and the res block's also on the host; the
    port's host cache of the same block beside it."""
    ja = fam["ja"]
    out = {}
    for kind in KINDS[fam["family"]]:
        name = pick(fam, kind)
        u = ja.unit_by_name(name)
        fp = None if kind == "tib_ldm" else JR.precapture_fp_outs(
            ja, [name], fam["jp"], fam["jcali"], batch_size=CAPTURE)[name]
        out[kind] = JR.capture_unit_io(ja, u, fam["jp"], fam["jcali"],
                                       fam["jw"], asym=True,
                                       batch_size=CAPTURE, fp_out=fp)
        if kind == "res_ldm":
            out[kind, "host"] = JR.capture_unit_io(
                ja, u, fam["jp"], fam["jcali"], fam["jw"], asym=True,
                batch_size=CAPTURE, fp_out=fp, to_host=True)
    return out


def _same_result(fam, name, jst, tst, jw2, tw2, jl, tl,
                 iters=HP["iters"]):
    assert tst[name]["kept"] == jst[name]["kept"]
    for k in ("hard_nearest", "hard_trained"):
        assert abs(tst[name][k] - jst[name][k]) <= LOSS_REL * jst[name][k]
    eq = tot = 0
    for _, full in fam["ta"].unit_by_name(name).layers:
        if "alpha" in jw2.get(full, {}):
            a = np.asarray(jw2[full]["alpha"]) >= 0
            b = tw2[full]["alpha"].numpy() >= 0
            eq += int((a == b).sum())
            tot += a.size
    assert tot > 0 and eq == tot
    jl, tl = np.asarray(jl), tl.numpy()
    assert tl.shape == jl.shape == (iters,)
    assert np.all(np.abs(tl - jl) <= LOSS_REL * np.abs(jl))


@pytest.mark.parametrize("place", PLACES)
def test_reconstruct_unit_matches_jax(fam, unit_io, place):
    """One unit of every kind, 24 iterations on JAX's minibatches over
    the device cache: the loss at every iteration, the hardened alphas
    and the guard's decision."""
    kind = kind_at(fam, place)
    name = pick(fam, kind)
    jin, jout = unit_io[kind]
    key = jax.random.PRNGKey(5)
    jst, tst = {}, {}
    jw2, jl = JR.reconstruct_unit(fam["ja"], fam["ja"].unit_by_name(name),
                                  fam["jp"], fam["jw"], jin, jout,
                                  JR.ReconHP(**HP), key, stats=jst)
    tw2, tl = TR.reconstruct_unit(
        fam["ta"], fam["ta"].unit_by_name(name), fam["tp"], fam["tw"],
        to_torch(jin), to_torch(jout), TR.ReconHP(**HP), stats=tst,
        indices=jax_rows(key))
    _same_result(fam, name, jst, tst, jw2, tw2, jl, tl)


def small_thresholds(monkeypatch, row_bytes: int, *, fp_out_budget=None,
                     offload=None):
    """Both packages' residency thresholds, set for this size: host
    chunks of 5 rows of ``row_bytes`` (three chunks of 12 rows, the last
    wrapping to the front), the guard's host evaluation at a stride of 4
    rows, and optionally the FP-output budget and the offload bound."""
    for mod, budget in ((JR, "FP_OUT_HOST_BUDGET"), (TR, "FP_OUT_BUDGET")):
        monkeypatch.setattr(mod, "_HOST_CHUNK_BYTES", 5 * row_bytes)
        monkeypatch.setattr(mod, "HARD_EVAL_MAX_BYTES", 4 * row_bytes)
        monkeypatch.setattr(mod, "HARD_EVAL_MIN_ROWS", 4)
        if fp_out_budget is not None:
            monkeypatch.setattr(mod, budget, fp_out_budget)
        if offload is not None:
            monkeypatch.setattr(mod, "HOST_OFFLOAD_BYTES", offload)


def test_reconstruct_unit_host_cache_matches_jax(fam, unit_io, monkeypatch):
    """A host-cached res block (float16 numpy, JAX's host capture) runs
    JAX's chunked schedule: three chunks of a fixed permutation, the last
    wrapping to the front, 26 iterations split 8 + 8 + 10 (the remainder
    on the last chunk), Adam carried across the chunks, the guard over a
    stride of the host cache."""
    kind, iters = "res_ldm", 26
    name = pick(fam, kind)
    jin, jout = unit_io[kind, "host"]
    small_thresholds(monkeypatch, JR._bytes_per_row(jin, jout))
    hp = dict(HP, iters=iters)
    key = jax.random.PRNGKey(9)
    jst, tst = {}, {}
    jw2, jl = JR.reconstruct_unit(fam["ja"], fam["ja"].unit_by_name(name),
                                  fam["jp"], fam["jw"], jin, jout,
                                  JR.ReconHP(**hp), key, stats=jst)
    calls = []
    rows = jax_rows(key)

    def indices(u, n, bs, it):
        calls.append((n, it))
        return rows(u, n, bs, it)
    tw2, tl = TR.reconstruct_unit(
        fam["ta"], fam["ta"].unit_by_name(name), fam["tp"], fam["tw"],
        jin, jout, TR.ReconHP(**hp), stats=tst, indices=indices)
    assert calls == [(5, 8), (5, 8), (5, iters - 16)]
    _same_result(fam, name, jst, tst, jw2, tw2, jl, tl, iters)


def test_reconstruct_residency_matches_jax(fam, monkeypatch, caplog):
    """``reconstruct`` over the model's first seven units (the TIB, the
    input conv, which trains nothing, and five blocks and layers) with the
    FP-output budget at zero (every unit captures its own FP outputs,
    fused) and the offload bound between the units' cache sizes, so that
    some units go to the host and run the chunked schedule: the same
    residency decisions and log lines as JAX's, every guard decision
    identical, loss traces within FULL_RUN_LOSS_REL, hardened alphas
    equal."""
    ja = dataclasses.replace(fam["ja"], units=list(fam["ja"].units[:7]))
    ta = dataclasses.replace(fam["ta"], units=fam["ta"].units[:7])
    names = frozenset(u.name for u in ta.units if u.kind != "tib_ldm")
    ptape = TR._capture_many(ta, names, frozenset({"in", "out"}),
                             fam["tp"], tuple(a[:1] for a in fam["tcali"]))
    sizes = sorted(TR._bytes_per_row(ptape[f"{u}::in"], ptape[f"{u}::out"])
                   * N for u in names)
    small_thresholds(monkeypatch, sizes[0] // N // 2, fp_out_budget=0,
                     offload=sizes[len(sizes) // 2])
    key = jax.random.PRNGKey(7)
    keys, k = {}, key
    for u in ja.units:
        if u.recon and ja.default_train_roles(u):
            k, keys[u.name] = jax.random.split(k)
    rows = {u: jax_rows(kk) for u, kk in keys.items()}
    hp = dict(HP, iters=12)
    jst, tst, jl, tl, res = {}, {}, {}, {}, {}
    with caplog.at_level(logging.INFO, logger=JR.logger.name):
        jw2 = JR.reconstruct(ja, fam["jp"], fam["jcali"], dict(fam["jw"]),
                             JR.ReconHP(**hp, asym=True), key,
                             capture_batch_size=CAPTURE, stats=jst,
                             log=lambda u, l: jl.__setitem__(u, l))
    jhost = sorted(r.getMessage().split(":")[0].removeprefix("recon ")
                   for r in caplog.records
                   if "host offload, chunked schedule" in r.getMessage())
    assert any("exceeds budget" in r.getMessage() for r in caplog.records)
    tw2 = TR.reconstruct(ta, fam["tp"], fam["tcali"], dict(fam["tw"]),
                         TR.ReconHP(**hp), capture_batch_size=CAPTURE,
                         stats=tst, log=lambda u, l: tl.__setitem__(u, l),
                         indices=lambda u, n, bs, it: rows[u](u, n, bs, it),
                         residency=res)
    assert res["fp_out_cache"] == "fused"
    assert sorted(res["host"]) == jhost and 0 < len(jhost) < len(keys) - 1
    assert set(tst) == set(jst) == set(keys) and len(keys) == 6
    rel = {}
    for u in keys:
        assert tst[u]["kept"] == jst[u]["kept"], u
        j, t = np.asarray(jl[u]), tl[u].numpy()
        assert t.shape == j.shape == (hp["iters"],)
        rel[u] = float(np.max(np.abs(t - j) / np.abs(j)))
    assert max(rel.values()) <= FULL_RUN_LOSS_REL, rel
    for full, st in jw2.items():
        if "alpha" in st:
            assert np.array_equal(np.asarray(st["alpha"]) >= 0,
                                  tw2[full]["alpha"].numpy() >= 0), full
