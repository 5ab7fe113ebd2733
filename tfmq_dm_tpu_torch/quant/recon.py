"""Reconstruction engine, weight phase (port of
``tfmq_dm_tpu/quant/recon.py``): TIAR block, layer and TIB reconstruction
with AdaRound, unit by unit in module order.

- Unit I/O capture runs the full model with a ``QuantCtx`` tape and stops
  the forward once the tape holds what was asked for (the reference's
  StopForwardException, data_utill.py:76-169). The capture is always
  asymmetric, the JAX package's default: the inputs come from the
  quantized-prefix forward, the outputs from the FP one
  (data_utill.py:146-157).
- Residency, JAX's rules with the port's budgets (``FP_OUT_BUDGET``,
  ``HOST_OFFLOAD_BYTES``, ``_HOST_CHUNK_BYTES``): a one-sample FP probe
  sizes every pending unit's I/O; the FP outputs of every unit are
  captured in one pass and kept on the device in float16 when they fit
  their budget, else each unit captures its FP outputs and its inputs in
  one fused pass of its own; a unit whose cached I/O exceeds the device
  budget is cached in host memory in float16 (numpy) and its Adam
  schedule runs in chunks of the cache uploaded in turn
  (recon.py:612-700).
- The Adam loop over the AdaRound alphas: minibatch -> soft forward ->
  Lp reconstruction loss + the temperature-decayed rounding regularizer
  gated by warmup (reconstruction_util.py:13-173) -> Adam, with autograd;
  one iteration captured as a CUDA graph and replayed on the card (one
  graph per chunk of a host cache), run eagerly on the CPU. The Adam step
  is optax's ``adam`` written out (``adam_update``), not
  ``torch.optim.Adam``, whose order of rounding differs.
- A do-no-harm guard keeps the trained alphas only when their
  hard-rounding loss over the cached I/O beats nearest rounding; the
  reverted state is nearest rounding expressed as alphas.
- ``reconstruct`` writes per-unit checkpoints (the alphas and the unit's
  record) into ``resume_dir`` and skips the units found there on a
  re-run.

Minibatch indices come from a ``torch.Generator`` (one seed per unit,
drawn in unit order), or from an ``indices`` callable ``(unit_name, n,
bs, iters) -> LongTensor (iters, bs)``, called once per unit, or once per
chunk (in order) for a host-cached unit. Not ported yet: the act phase,
Fisher losses and mid-unit resume.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import math
import os
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from .adapter import ModelAdapter, UnitSpec
from .adaround import init_alpha, linear_temp_decay, round_regularizer
from .context import CaptureDone, QuantCtx
from .quantizer import init_qparams, lp_loss

logger = logging.getLogger(__name__)

# (unit_name, n, bs, iters) -> LongTensor (iters, bs) of minibatch rows
IndexSource = Callable[[str, int, int, int], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class ReconHP:
    """Weight-phase reconstruction hyperparameters (defaults: the entry
    scripts', ddim/runners/diffusion.py:296-304)."""

    iters: int = 20000
    batch_size: int = 32
    w: float = 0.01
    b_start: float = 20.0
    b_end: float = 2.0
    warmup: float = 0.2
    lr_alpha: float = 1e-3   # torch.optim.Adam default (reconstruction.py:41)
    p: float = 2.0
    # skip a unit's Adam loop when its nearest-rounding hard loss is
    # already at or below this floor (0: never)
    loss_floor: float = 0.0


@torch.no_grad()
def init_weight_qparams(policy, params, scaler: str = "mse") -> Dict:
    """Per-channel (delta, zp) for every wq-enabled layer, from the weight
    tensor itself (the reference's dummy init forward,
    calibration.py:87-92)."""
    wstate = {}
    for name in policy.weight_layers():
        pol = policy.get(name)
        if not pol.wq:
            continue
        delta, zp = init_qparams(params[name]["w"], pol.w_cfg, scaler=scaler)
        wstate[name] = {"delta": delta, "zp": zp}
    return wstate


# ---------------------------------------------------------------------------
# trees of tensors (a unit's I/O is a tensor or a tuple of tensors; a
# host cache holds numpy arrays)
# ---------------------------------------------------------------------------

def _tmap(fn, tree):
    if isinstance(tree, tuple):
        return tuple(None if x is None else fn(x) for x in tree)
    return fn(tree)


def _leaves(tree):
    xs = list(tree) if isinstance(tree, tuple) else [tree]
    return [x for x in xs if x is not None]


def _tcat(trees):
    lead = _leaves(trees[0])[0]
    cat = np.concatenate if isinstance(lead, np.ndarray) else torch.cat
    if isinstance(trees[0], tuple):
        return tuple(None if xs[0] is None else cat(xs)
                     for xs in zip(*trees))
    return cat(trees)


def _f32(tree):
    return _tmap(lambda x: x.float() if x.is_floating_point() else x, tree)


def _f16(tree):
    return _tmap(lambda x: x.half() if x.dtype == torch.float32 else x,
                 tree)


def _host16(tree):
    """To host memory in float16, as numpy (the JAX package's host
    caches)."""
    return _tmap(lambda x: x.cpu().numpy(), _f16(tree))


def _on_host(tree) -> bool:
    return isinstance(_leaves(tree)[0], np.ndarray)


def _to(tree, dev):
    """A host cache's (numpy) slice onto ``dev``; tensors pass as they
    are."""
    return _tmap(lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                 if isinstance(x, np.ndarray) else x, tree)


def _bytes_per_row(inputs, outputs) -> int:
    return sum(math.prod(x.shape[1:]) * x.itemsize
               for x in _leaves(inputs) + _leaves(outputs))


# ---------------------------------------------------------------------------
# I/O capture and residency
# ---------------------------------------------------------------------------

# Residency budgets, sized for an 80 GB H100 (79.1 GiB to PyTorch). The
# JAX package's (recon.py:153-155, 487-495: 48 GiB of host FP outputs,
# 3 GiB of device cache a unit, 2 GiB chunks) were sized for a 16 GiB TPU
# with its caches on the host. Besides these caches the card holds the
# model (cin256: 400.9 M parameters, 1.6 GB in f32), the trained layers'
# alphas (as much again at most), a capture forward's live activations
# (cin256 at 64 rows a capture batch: under 10 GB, a 64 x 4 MB score
# matrix at 1024 tokens included) and the Adam step's working set (under
# 2 GB at 32 rows a minibatch). The shared float16 FP-output cache (24
# GiB) plus one unit's cache on the card (16 GiB, or a host chunk of 8)
# plus those (15 GiB) come to 55 GiB, which leaves a quarter of the card
# to the harvest's samples and the allocator.
FP_OUT_BUDGET = 24 << 30
HOST_OFFLOAD_BYTES = 16 << 30
_HOST_CHUNK_BYTES = 8 << 30
# the guard's evaluations over a host cache take an even stride of rows,
# the same for both (recon.py:109-117), uploading at most this many bytes
# and never fewer than 512 rows
HARD_EVAL_MAX_BYTES = 4 << 30
HARD_EVAL_MIN_ROWS = 512


def _tape(adapter: ModelAdapter, params, ctx: QuantCtx, batch) -> dict:
    try:
        adapter.forward(params, ctx, *batch)
    except CaptureDone:
        pass
    return ctx.tape


@torch.no_grad()
def _capture_many(adapter: ModelAdapter, names: frozenset, tags: frozenset,
                  params, batch) -> dict:
    """One FP forward taping ``tags`` of every unit in ``names``, stopped
    once they are on the tape (recon.py:121-137)."""
    ctx = QuantCtx(adapter.policy, capture=names, capture_tags=tags,
                   stop_when_taped=True)
    return _tape(adapter, params, ctx, batch)


@torch.no_grad()
def _capture_in_batch(adapter: ModelAdapter, unit_name: str, params,
                      wstate, batch):
    """The unit's input under the weight-quantized prefix (hard-rounded
    weights; the weight phase quantizes no activation), the forward
    stopped there."""
    ctx = QuantCtx(adapter.policy, wstate=wstate, use_wq=True,
                   capture=frozenset({unit_name}),
                   capture_tags=frozenset({"in"}), stop_when_taped=True)
    return _tape(adapter, params, ctx, batch)[f"{unit_name}::in"]


@torch.no_grad()
def _capture_batch(adapter: ModelAdapter, unit_name: str, params, wstate,
                   batch):
    """The fused capture of one unit (recon.py:86-100): (its input under
    the weight-quantized prefix, its FP output), in float32."""
    out = _capture_many(adapter, frozenset({unit_name}),
                        frozenset({"out"}), params,
                        batch)[f"{unit_name}::out"]
    return _capture_in_batch(adapter, unit_name, params, wstate,
                             batch), out


@torch.no_grad()
def precapture_fp_outs(adapter: ModelAdapter, unit_names, params,
                       cali_data, *, batch_size: int = 128) -> dict:
    """One FP pass over the calibration set caching every listed unit's
    output, in float16 on the device: ``{unit: tensor}``. FP outputs do
    not depend on the quantized prefix, so one pass serves all units
    (recon.py:158-179)."""
    names = frozenset(unit_names)
    if not names:
        return {}
    n = cali_data[0].shape[0]
    parts: Dict[str, list] = {}
    for i in range(0, n, batch_size):
        tape = _capture_many(adapter, names, frozenset({"out"}), params,
                             tuple(x[i:i + batch_size] for x in cali_data))
        for k, v in tape.items():
            parts.setdefault(k, []).append(_f16(v))
    return {k.removesuffix("::out"): _tcat(v) for k, v in parts.items()}


@torch.no_grad()
def capture_unit_io(adapter: ModelAdapter, unit: UnitSpec, params,
                    cali_data: Tuple[torch.Tensor, ...], wstate,
                    fp_out=None, *, batch_size: int = 128,
                    to_host: bool = False):
    """Cache (inputs, outputs) of one unit over the calibration set
    (save_inout, data_utill.py:13-51): inputs from the weight-quantized
    prefix's forward; outputs ``fp_out``, this unit's FP outputs from
    ``precapture_fp_outs``, or, without it, captured with the inputs in
    one fused pass (float32). ``to_host``: the cache goes to host memory
    as float16 numpy arrays (calibration.py:62-67). The TIB's inputs are
    the timesteps and its outputs its own FP forward
    (reconstruction.py:287); it takes no ``fp_out``."""
    if unit.kind.startswith("tib"):
        uparams = adapter.extract_uparams(params, unit)
        fp_rc = tuple(dataclasses.replace(r, w_cfg=None, aq=False)
                      for r in adapter.role_cfgs(unit, frozenset()))
        inputs = (cali_data[1],)
        outputs = adapter.unit_fwd(unit.kind, fp_rc, unit.extra, uparams,
                                   {}, {}, inputs, False, False)
        return inputs, outputs
    keep = _host16 if to_host else (lambda tree: tree)
    n = cali_data[0].shape[0]
    batches = [tuple(x[i:i + batch_size] for x in cali_data)
               for i in range(0, n, batch_size)]
    if fp_out is not None:
        ins = [keep(_capture_in_batch(adapter, unit.name, params, wstate,
                                      b)) for b in batches]
        return _tcat(ins), keep(fp_out)
    ins, outs = [], []
    for b in batches:
        inp, out = _capture_batch(adapter, unit.name, params, wstate, b)
        ins.append(keep(inp))
        outs.append(keep(out))
    return _tcat(ins), _tcat(outs)


# ---------------------------------------------------------------------------
# Adam (optax.adam's update, written out)
# ---------------------------------------------------------------------------

def adam_corrections(b: float, first: int, n: int, device) -> torch.Tensor:
    """1 - b ** count for counts first .. first + n - 1, as optax computes
    them (a float32 power), on ``device`` in one copy."""
    counts = torch.arange(first, first + n, dtype=torch.float32)
    return (1 - torch.pow(torch.tensor(b, dtype=torch.float32),
                          counts)).to(device)


@torch.no_grad()
def adam_update(params: Dict[str, torch.Tensor],
                grads: Dict[str, torch.Tensor], mu: Dict[str, torch.Tensor],
                nu: Dict[str, torch.Tensor], lr: float, corrections,
                b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                eps_root: float = 0.0):
    """One step of ``optax.adam(lr)`` (scale_by_adam, then scale by -lr,
    then apply_updates), in optax's order of operations:
    mu = (1-b1) g + b1 mu; nu = (1-b2) g^2 + b2 nu; mu_hat = mu / (1 -
    b1^count), nu_hat likewise; u = mu_hat / (sqrt(nu_hat + eps_root) +
    eps); p = p + (-lr) u. ``corrections``: this step's (1 - b1^count,
    1 - b2^count) as 0-dim tensors on the parameters' device
    (``adam_corrections``): the division is by a tensor, since the card
    divides by a host scalar as a product with its reciprocal.
    Returns (params, mu, nu)."""
    c1, c2 = corrections
    new_p, new_mu, new_nu = {}, {}, {}
    for k in params:
        g = grads[k]
        new_mu[k] = (1 - b1) * g + b1 * mu[k]
        new_nu[k] = (1 - b2) * (g * g) + b2 * nu[k]
        u = (new_mu[k] / c1) / (torch.sqrt(new_nu[k] / c2 + eps_root) + eps)
        new_p[k] = params[k] + (-lr) * u
    return new_p, new_mu, new_nu


# ---------------------------------------------------------------------------
# the weight-phase loop
# ---------------------------------------------------------------------------

def _merge_alpha(wstate_roles, alphas):
    merged = dict(wstate_roles)
    for role, a in alphas.items():
        merged[role] = dict(merged[role])
        merged[role]["alpha"] = a
    return merged


def _rec_loss(pred, tgt, p: float):
    """LossFunc's reconstruction term (reconstruction_util.py:51-61): Lp
    summed over channels, summed over the output tuple's leaves."""
    loss = None
    for a, b in zip(_leaves(pred), _leaves(tgt)):
        term = lp_loss(a, b, p=p)
        loss = term if loss is None else loss + term
    return loss


# on the card the loop replays one iteration captured as a CUDA graph
# (eager PyTorch spends about 9 ms an iteration on the host); this many
# eager iterations first, on a side stream, on a copy of the state
GRAPH_WARMUP = 2


def _recon_run(unit_fwd, kind: str, role_cfgs: tuple, extra: tuple,
               hp: ReconHP, uparams, wstate_fixed, alphas, inputs, outputs,
               idx: torch.Tensor, moments=None, iter0: int = 0):
    """The weight-phase optimization of one unit over the minibatch rows
    ``idx`` (iters, bs): {minibatch -> soft forward -> loss -> Adam}
    (reconstruction.py:63-78, 182-198, 290-303). ``moments`` (Adam's mu
    and nu) and ``iter0`` continue a schedule (a host cache's chunks): the
    iterations are iter0 + 1 .. iter0 + iters of ``hp.iters``, Adam
    starting from ``moments`` (zero when None). Returns (alphas, moments,
    per-iteration reconstruction losses).

    One iteration is one ``step()`` that reads everything that changes
    between iterations from device tensors through a device counter: the
    minibatch rows, the temperature, the warmup gate of the regularizer
    (JAX's ``where(count < loss_start, 0, w * reg)`` as a factor 0 or 1)
    and Adam's bias corrections, and updates the alphas and Adam's
    moments in place. So on the card the iteration is captured once as a
    CUDA graph and replayed; on the CPU it runs eagerly."""
    keys = sorted(alphas)
    n_iters = idx.shape[0]
    dev = idx.device
    f32 = torch.float32
    counts = torch.arange(iter0 + 1, iter0 + n_iters + 1, dtype=f32)
    temps = linear_temp_decay(counts, hp.iters, hp.warmup, hp.b_start,
                              hp.b_end).to(dev)
    gates = (counts >= float(np.float32(hp.warmup * hp.iters))).to(
        f32).to(dev)
    bc1 = adam_corrections(0.9, iter0 + 1, n_iters, dev)
    bc2 = adam_corrections(0.999, iter0 + 1, n_iters, dev)
    a_buf = {k: alphas[k].detach().clone() for k in keys}
    if moments is None:
        mu = {k: torch.zeros_like(a_buf[k]) for k in keys}
        nu = {k: torch.zeros_like(a_buf[k]) for k in keys}
    else:
        mu, nu = ({k: m[k].clone() for k in keys} for m in moments)
    i_buf = torch.zeros(1, dtype=torch.long, device=dev)
    losses = torch.zeros(n_iters, dtype=f32, device=dev)

    def at(t):
        return t.index_select(0, i_buf)

    def step():
        rows = at(idx).view(-1)
        b, gate = at(temps).view(()), at(gates).view(())
        binp = _f32(_tmap(lambda x: x.index_select(0, rows), inputs))
        bout = _f32(_tmap(lambda x: x.index_select(0, rows), outputs))
        a = {k: a_buf[k].detach().requires_grad_(True) for k in keys}
        with torch.enable_grad():
            pred = unit_fwd(kind, role_cfgs, extra, uparams,
                            _merge_alpha(wstate_fixed, a), {}, binp, True,
                            False)
            rec = _rec_loss(pred, bout, hp.p)
            reg = None
            for k in keys:
                r = round_regularizer(a[k], b)
                reg = r if reg is None else reg + r
            loss = rec + gate * (hp.w * reg)
            grads = torch.autograd.grad(loss, [a[k] for k in keys])
        new, new_mu, new_nu = adam_update(
            {k: a[k].detach() for k in keys}, dict(zip(keys, grads)), mu,
            nu, hp.lr_alpha, (at(bc1).view(()), at(bc2).view(())))
        with torch.no_grad():
            for k in keys:
                a_buf[k].copy_(new[k])
                mu[k].copy_(new_mu[k])
                nu[k].copy_(new_nu[k])
            losses.index_copy_(0, i_buf, rec.detach().reshape(1))
            i_buf.add_(1)

    if dev.type == "cuda" and n_iters > GRAPH_WARMUP:
        saved = [t.clone() for t in (*a_buf.values(), *mu.values(),
                                     *nu.values())]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(GRAPH_WARMUP):
                step()
        torch.cuda.current_stream().wait_stream(side)
        with torch.no_grad():
            for t, v in zip((*a_buf.values(), *mu.values(), *nu.values()),
                            saved):
                t.copy_(v)
            i_buf.zero_()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            step()
        for _ in range(n_iters):
            graph.replay()
        del graph
    else:
        for _ in range(n_iters):
            step()
    return a_buf, (mu, nu), (losses if n_iters else None)


@torch.no_grad()
def _hard_loss_batch(unit_fwd, kind, role_cfgs, extra, hp: ReconHP, uparams,
                     wstate_roles, binp, bout):
    """Hard-rounding (inference-mode) reconstruction loss of one batch of
    the cached I/O: the loss the deployed model realizes."""
    pred = unit_fwd(kind, role_cfgs, extra, uparams, wstate_roles, {},
                    _f32(binp), False, False)
    return _rec_loss(pred, _f32(bout), hp.p)


def _hard_eval(unit_fwd, kind, role_cfgs, extra, hp: ReconHP, uparams,
               wstate_roles, inputs, outputs, dev,
               batch: int = 256) -> float:
    """Mean hard-rounding loss over the cached I/O, in batches on
    ``dev``. A host cache is subsampled at an even stride to
    ``HARD_EVAL_MAX_BYTES`` of upload (the calibration rows are
    timestep-major, so a prefix would favour early timesteps)."""
    n = _leaves(inputs)[0].shape[0]
    if _on_host(inputs):
        max_rows = max(HARD_EVAL_MIN_ROWS,
                       HARD_EVAL_MAX_BYTES
                       // max(1, _bytes_per_row(inputs, outputs)))
        if n > max_rows:
            idx = np.linspace(0, n - 1, max_rows).astype(np.int64)
            inputs = _tmap(lambda x: x[idx], inputs)
            outputs = _tmap(lambda x: x[idx], outputs)
            n = max_rows
    tot, cnt = 0.0, 0
    for i in range(0, n, batch):
        binp = _to(_tmap(lambda x: x[i:i + batch], inputs), dev)
        bout = _to(_tmap(lambda x: x[i:i + batch], outputs), dev)
        loss = _hard_loss_batch(unit_fwd, kind, role_cfgs, extra, hp,
                                uparams, wstate_roles, binp, bout)
        b = _leaves(binp)[0].shape[0]
        tot += float(loss) * b
        cnt += b
    return tot / max(cnt, 1)


def _prep_unit_states(adapter: ModelAdapter, unit: UnitSpec, params,
                      wstate):
    """Split one unit's wstate into (role_cfgs, uparams, fixed role
    states, trainable alphas); alphas start from the weight's fractional
    part on first touch (uaq2adar, calibration.py:19-42)."""
    train_roles = adapter.default_train_roles(unit)
    if not train_roles:
        return None
    role_cfgs = adapter.role_cfgs(unit, train_roles)
    uparams = adapter.extract_uparams(params, unit)
    wstate_roles, alphas = {}, {}
    for role, full in unit.layers:
        st = wstate.get(full)
        if st is None:
            continue
        wstate_roles[role] = st
        if role in train_roles:
            alphas[role] = st.get("alpha")
            if alphas[role] is None:
                alphas[role] = init_alpha(params[full]["w"], st["delta"])
    fixed = {r: {k: v for k, v in st.items()
                 if not (r in alphas and k == "alpha")}
             for r, st in wstate_roles.items()}
    return role_cfgs, uparams, fixed, alphas


def draw_indices(generator: torch.Generator, n: int, bs: int, iters: int
                 ) -> torch.Tensor:
    """(iters, bs) minibatch rows: the first ``bs`` of a fresh permutation
    of ``n`` at every iteration, as recon.py:383 draws them."""
    if iters == 0:
        return torch.zeros((0, bs), dtype=torch.long)
    return torch.stack([torch.randperm(n, generator=generator)[:bs]
                        for _ in range(iters)])


def reconstruct_unit(adapter: ModelAdapter, unit: UnitSpec, params,
                     wstate, inputs, outputs, hp: ReconHP,
                     generator: Optional[torch.Generator] = None, *,
                     indices: Optional[IndexSource] = None,
                     stats: Optional[dict] = None):
    """Weight-phase reconstruction of one unit; returns (wstate with the
    unit's alphas written back under their full layer names, per-iteration
    losses or None).

    A host cache (numpy, from ``capture_unit_io(..., to_host=True)``)
    runs the chunked schedule, one chunk on the device at a time.

    Do-no-harm guard (recon.py:601-609): the hard-rounding loss over the
    cached I/O is evaluated for nearest rounding and for the trained
    alphas, and the better one is kept. ``hp.loss_floor`` > 0 skips the
    Adam loop when nearest rounding is already at or below the floor.
    ``stats``: collects {unit: {"hard_nearest", "hard_trained", "kept",
    "loss_first", "loss_last"}} (the last two: the reconstruction loss at
    the first and the last iteration). Minibatch rows come from
    ``indices`` when given, else from ``generator`` (a CPU generator; seed
    0 when None)."""
    prep = _prep_unit_states(adapter, unit, params, wstate)
    if prep is None:
        return wstate, None
    role_cfgs, uparams, fixed, alphas = prep

    # nearest rounding as fresh init_alpha alphas: exactly the state a
    # revert stores
    base_alphas = {role: init_alpha(params[full]["w"],
                                    wstate[full]["delta"])
                   for role, full in unit.layers if role in alphas}
    dev = params[unit.layers[0][1]]["w"].device
    hard_nearest = _hard_eval(adapter.unit_fwd, unit.kind, role_cfgs,
                              unit.extra, hp, uparams,
                              _merge_alpha(fixed, base_alphas), inputs,
                              outputs, dev)
    if hp.loss_floor > 0.0 and hard_nearest <= hp.loss_floor:
        logger.info("recon %s: nearest-rounding loss %.6f already below "
                    "floor %g, skipping optimization", unit.name,
                    hard_nearest, hp.loss_floor)
        if stats is not None:
            stats[unit.name] = {"hard_nearest": hard_nearest,
                                "kept": "nearest", "skipped": True}
        return wstate, None

    gen = generator if generator is not None \
        else torch.Generator().manual_seed(0)

    def rows(m: int, iters: int) -> torch.Tensor:
        bs = max(1, min(hp.batch_size, m))
        idx = indices(unit.name, m, bs, iters) if indices is not None \
            else draw_indices(gen, m, bs, iters)
        return idx.to(dev, torch.long)

    def run(cin, cout, idx, moments=None, iter0=0):
        return _recon_run(adapter.unit_fwd, unit.kind, role_cfgs,
                          unit.extra, hp, uparams, fixed, alphas, cin, cout,
                          idx, moments, iter0)

    n = _leaves(inputs)[0].shape[0]
    if _on_host(inputs):
        # the chunked schedule (recon.py:672-700): equal chunks of a fixed
        # permutation, the last wrapping to the front; the iterations split
        # evenly, the remainder on the last chunk; Adam carried across
        chunk_n = max(hp.batch_size,
                      min(n, _HOST_CHUNK_BYTES
                          // max(1, _bytes_per_row(inputs, outputs))))
        chunk_n = min(chunk_n, max(1, n))
        n_chunks = -(-n // chunk_n)
        iters_per = [hp.iters // n_chunks] * n_chunks
        iters_per[-1] += hp.iters - sum(iters_per)
        perm = np.random.RandomState(0).permutation(n)
        moments, it0, parts = None, 0, []
        for c, n_it in enumerate(iters_per):
            if n_it == 0:
                continue
            sel = perm[(c * chunk_n + np.arange(chunk_n)) % n]
            alphas, moments, ls = run(
                _to(_tmap(lambda x: x[sel], inputs), dev),
                _to(_tmap(lambda x: x[sel], outputs), dev),
                rows(chunk_n, n_it), moments, it0)
            it0 += n_it
            parts.append(ls)
        losses = torch.cat(parts) if parts else None
    else:
        alphas, _, losses = run(inputs, outputs, rows(n, hp.iters))

    hard_trained = _hard_eval(adapter.unit_fwd, unit.kind, role_cfgs,
                              unit.extra, hp, uparams,
                              _merge_alpha(fixed, alphas), inputs, outputs,
                              dev)
    keep_trained = hard_trained < hard_nearest
    logger.info("recon %s guard: hard loss nearest %.6f vs trained %.6f "
                "-> keep %s", unit.name, hard_nearest, hard_trained,
                "trained" if keep_trained else "nearest")
    if stats is not None:
        stats[unit.name] = {"hard_nearest": hard_nearest,
                            "hard_trained": hard_trained,
                            "kept": "trained" if keep_trained
                            else "nearest"}
        if losses is not None:
            stats[unit.name].update(loss_first=float(losses[0]),
                                    loss_last=float(losses[-1]))
    if not keep_trained:
        alphas = base_alphas
    new_wstate = dict(wstate)
    for role, full in unit.layers:
        if role in alphas:
            new_wstate[full] = dict(new_wstate[full])
            new_wstate[full]["alpha"] = alphas[role]
    return new_wstate, losses


def _unit_seed(generator: torch.Generator) -> int:
    return int(torch.randint(0, 2 ** 62, (1,), generator=generator))


def reconstruct(adapter: ModelAdapter, params, cali_data, wstate,
                hp: ReconHP, generator: Optional[torch.Generator] = None,
                *, capture_batch_size: int = 128, log=None,
                resume_dir: Optional[str] = None,
                stats: Optional[dict] = None,
                indices: Optional[IndexSource] = None,
                residency: Optional[dict] = None):
    """Unit-by-unit reconstruction in module order (recon_model DFS,
    calibration.py:56-84). Each unit's inputs are captured under the
    current (partly reconstructed, hard-rounded) prefix, so order
    matters, as in the reference.

    ``generator`` gives every reconstructed unit its own seed, drawn in
    unit order (a resumed unit draws its seed too, so the stream stays
    aligned). ``resume_dir``: each finished unit's alphas and its
    ``stats`` record are saved there (``<unit>.npz``), and a re-run loads
    them and skips the unit. ``log(unit_name, losses or None)`` is called
    after each reconstructed unit, and with None for a resumed one.
    ``residency`` collects the residency decisions: "fp_out_cache"
    ("shared" or "fused"), "fp_out_gib" (the shared cache's size, float16)
    and "host" (the units cached in host memory)."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    if resume_dir:
        os.makedirs(resume_dir, exist_ok=True)

    def _unit_path(name):
        return os.path.join(resume_dir, name.replace("/", "_") + ".npz")

    def _resumable(unit):
        return bool(resume_dir) and os.path.exists(_unit_path(unit.name))

    # one 1-sample FP probe sizes every pending unit's I/O
    pending = [u for u in adapter.units
               if u.recon and adapter.default_train_roles(u)
               and not u.kind.startswith("tib") and not _resumable(u)]
    n_samples = cali_data[0].shape[0]
    row_bytes, out_bytes = {}, {}
    if pending:
        ptape = _capture_many(adapter, frozenset(u.name for u in pending),
                              frozenset({"in", "out"}), params,
                              tuple(x[:1] for x in cali_data))
        for u in pending:
            p_in, p_out = ptape[f"{u.name}::in"], ptape[f"{u.name}::out"]
            row_bytes[u.name] = _bytes_per_row(p_in, p_out)
            out_bytes[u.name] = _bytes_per_row((), p_out)
        del ptape

    # the shared FP-output cache, when it fits its budget: one pass serves
    # every unit's targets (they do not depend on the quantized prefix)
    fp_outs = {}
    if pending:
        total = sum(out_bytes.values()) * n_samples // 2   # float16
        shared = total <= FP_OUT_BUDGET
        if residency is not None:
            residency.update(fp_out_cache="shared" if shared else "fused",
                             fp_out_gib=total / (1 << 30), host=[])
        if shared:
            logger.info("recon: precapturing FP outputs of %d units in "
                        "one pass (~%.1f GiB on %s, f16)", len(pending),
                        total / (1 << 30), cali_data[0].device)
            fp_outs = precapture_fp_outs(
                adapter, [u.name for u in pending], params, cali_data,
                batch_size=capture_batch_size)
        else:
            logger.info("recon: FP-output cache ~%.1f GiB exceeds budget"
                        " -- per-unit fused capture", total / (1 << 30))

    dev = cali_data[0].device
    for unit in adapter.units:
        if not unit.recon or not adapter.default_train_roles(unit):
            continue
        unit_gen = torch.Generator().manual_seed(_unit_seed(generator))
        if _resumable(unit):
            with np.load(_unit_path(unit.name)) as data:
                for role, full in unit.layers:
                    akey = f"{full}::alpha"
                    if akey in data.files:
                        wstate[full] = dict(wstate[full])
                        wstate[full]["alpha"] = torch.from_numpy(
                            data[akey]).to(dev)
                if stats is not None:
                    stats[unit.name] = json.loads(str(data["__stats__"]))
            if log is not None:
                log(unit.name, None)
            continue
        to_host = False
        if not unit.kind.startswith("tib"):
            est = row_bytes[unit.name] * n_samples
            to_host = est > HOST_OFFLOAD_BYTES
            if to_host:
                logger.info("recon %s: cached I/O ~%.1f GiB -> host "
                            "offload, chunked schedule", unit.name,
                            est / (1 << 30))
                if residency is not None:
                    residency["host"].append(unit.name)
        inputs, outputs = capture_unit_io(
            adapter, unit, params, cali_data, wstate,
            fp_outs.pop(unit.name, None), batch_size=capture_batch_size,
            to_host=to_host)
        record = {}
        wstate, losses = reconstruct_unit(adapter, unit, params, wstate,
                                          inputs, outputs, hp, unit_gen,
                                          indices=indices, stats=record)
        del inputs, outputs
        if stats is not None:
            stats.update(record)
        if resume_dir:
            tmp = _unit_path(unit.name) + ".tmp.npz"
            np.savez(tmp, __stats__=np.array(json.dumps(record[unit.name])),
                     **{f"{full}::alpha":
                        wstate[full]["alpha"].detach().cpu().numpy()
                        for _, full in unit.layers
                        if "alpha" in wstate.get(full, {})})
            os.replace(tmp, _unit_path(unit.name))
        if log is not None and losses is not None:
            log(unit.name, losses)
    return wstate
