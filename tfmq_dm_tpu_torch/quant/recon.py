"""Reconstruction engine (port of ``tfmq_dm_tpu/quant/recon.py``): TIAR
block, layer and TIB reconstruction with AdaRound (the weight phase),
unit by unit in module order, and the act phase that re-trains the
activation deltas.

- Unit I/O capture runs the full model with a ``QuantCtx`` tape and stops
  the forward once the tape holds what was asked for (the reference's
  StopForwardException, data_utill.py:76-169). With ``asym`` (the
  default) the inputs come from the quantized-prefix forward (with the
  activation state when ``use_aq``), the outputs from the FP one
  (data_utill.py:146-157); without it both come from the FP forward.
- Residency, JAX's rules with the port's budgets (``FP_OUT_BUDGET``,
  ``HOST_OFFLOAD_BYTES``, ``_HOST_CHUNK_BYTES``): a one-sample FP probe
  sizes every pending unit's I/O; the FP outputs of every unit are
  captured in one pass and kept on the device in float16 when they fit
  their budget, else each unit captures its FP outputs and its inputs in
  one fused pass of its own; a unit whose cached I/O exceeds the device
  budget is cached in host memory in float16 (numpy) and its Adam
  schedule runs in chunks of the cache uploaded in turn
  (recon.py:612-700).
- The weight phase's Adam loop over the AdaRound alphas: minibatch ->
  soft forward -> reconstruction loss (Lp, or the Fisher-weighted
  ``fisher_diag`` / ``fisher_full`` with the cached |grad| + 1 of
  ``capture_unit_grads``) + the temperature-decayed rounding regularizer
  gated by warmup (reconstruction_util.py:13-173) -> Adam, with autograd;
  one iteration captured as a CUDA graph and replayed on the card (one
  graph per chunk of a host cache, and per segment), run eagerly on the
  CPU. The Adam step is optax's ``adam`` written out (``adam_update``),
  not ``torch.optim.Adam``, whose order of rounding differs.
- The act phase (``reconstruct_act``, ``reconstruct_unit_act``): Adam on
  each unit's activation deltas with a cosine-decayed learning rate, the
  reconstruction loss only, weights in hard rounding
  (reconstruction.py:43-48); one CUDA graph a unit on the card.
- A do-no-harm guard in both phases keeps the trained state only when its
  hard-rounding loss over the cached I/O beats the state it started from
  (nearest rounding expressed as alphas; the calibrated deltas).
- ``reconstruct`` writes per-unit checkpoints (the alphas and the unit's
  record) into ``resume_dir`` and skips the units found there on a
  re-run; inside a unit it runs the schedule in segments of
  ``RESUME_SEG_ITERS`` iterations and saves the partial state (alphas,
  Adam's moments, the next iteration, the losses so far) after each, so
  a re-run resumes mid-unit.

Minibatch indices come from a ``torch.Generator`` (one seed per unit,
drawn in unit order), or from an ``indices`` callable ``(unit_name, n,
bs, iters) -> LongTensor (iters, bs)``, called once per unit, or once per
chunk (in order) for a host-cached unit. All of a unit's rows are drawn
before its first iteration, so a resumed unit draws the same rows again
and starts at the saved iteration: the result does not depend on
``RESUME_SEG_ITERS`` or on whether ``resume_dir`` is set. The JAX package
splits its key at every segment (recon.py:660-665), so there the rows
depend on both.
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
    """Reconstruction hyperparameters (defaults: the entry scripts',
    ddim/runners/diffusion.py:296-304)."""

    iters: int = 20000
    batch_size: int = 32
    w: float = 0.01
    b_start: float = 20.0
    b_end: float = 2.0
    warmup: float = 0.2
    lr_alpha: float = 1e-3   # torch.optim.Adam default (reconstruction.py:41)
    lr_delta: float = 4e-5   # the act phase (reconstruction.py:45)
    p: float = 2.0
    asym: bool = True
    use_aq: bool = False
    rloss: str = "mse"       # mse | fisher_diag | fisher_full
    # (the RLOSS enum, reconstruction_util.py:10)
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
def _capture_in_batch(adapter: ModelAdapter, unit_name: str, use_aq: bool,
                      params, wstate, astate, batch):
    """The unit's input under the quantized prefix (hard-rounded weights;
    the activations quantized with ``astate`` when ``use_aq``), the
    forward stopped there."""
    ctx = QuantCtx(adapter.policy, wstate=wstate, astate=astate,
                   use_wq=True, use_aq=use_aq,
                   capture=frozenset({unit_name}),
                   capture_tags=frozenset({"in"}), stop_when_taped=True)
    return _tape(adapter, params, ctx, batch)[f"{unit_name}::in"]


@torch.no_grad()
def _capture_batch(adapter: ModelAdapter, unit_name: str, asym: bool,
                   use_aq: bool, params, wstate, astate, batch):
    """The fused capture of one unit (recon.py:86-100): (its input, its FP
    output), in float32; the input under the quantized prefix when
    ``asym``, else the FP forward's."""
    tape = _capture_many(adapter, frozenset({unit_name}),
                         frozenset({"out"} if asym else {"in", "out"}),
                         params, batch)
    inp = _capture_in_batch(adapter, unit_name, use_aq, params, wstate,
                            astate, batch) if asym \
        else tape[f"{unit_name}::in"]
    return inp, tape[f"{unit_name}::out"]


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
                    astate=None, *, asym: bool = True, use_aq: bool = False,
                    batch_size: int = 128, to_host: bool = False,
                    fp_out=None):
    """Cache (inputs, outputs) of one unit over the calibration set
    (save_inout, data_utill.py:13-51): inputs from the quantized prefix's
    forward when ``asym`` (activations quantized with ``astate`` when
    ``use_aq``), else from the FP forward; outputs from the FP forward:
    ``fp_out``, this unit's FP outputs from ``precapture_fp_outs``, or,
    without it (or without ``asym``), captured with the inputs in one
    fused pass (float32). ``to_host``: the cache goes to host memory as
    float16 numpy arrays (calibration.py:62-67). The TIB's inputs are the
    timesteps and its outputs its own FP forward (reconstruction.py:287);
    it takes no ``fp_out``."""
    if unit.kind.startswith("tib"):
        uparams = adapter.extract_uparams(params, unit)
        fp_rc = tuple(dataclasses.replace(r, w_cfg=None, aq=False)
                      for r in adapter.role_cfgs(unit, frozenset()))
        inputs = (cali_data[1],)
        outputs = adapter.unit_fwd(unit.kind, fp_rc, unit.extra, uparams,
                                   {}, {}, inputs, False, False)
        return inputs, outputs
    astate = astate or {}
    keep = _host16 if to_host else (lambda tree: tree)
    n = cali_data[0].shape[0]
    batches = [tuple(x[i:i + batch_size] for x in cali_data)
               for i in range(0, n, batch_size)]
    if fp_out is not None and asym:
        ins = [keep(_capture_in_batch(adapter, unit.name, use_aq, params,
                                      wstate, astate, b)) for b in batches]
        return _tcat(ins), keep(fp_out)
    ins, outs = [], []
    for b in batches:
        inp, out = _capture_batch(adapter, unit.name, asym, use_aq, params,
                                  wstate, astate, b)
        ins.append(keep(inp))
        outs.append(keep(out))
    return _tcat(ins), _tcat(outs)


def _grad_batch(adapter: ModelAdapter, unit_name: str, use_aq: bool,
                params, wstate_sub, astate, batch) -> torch.Tensor:
    """d KL(softmax(fp) || softmax(quant)) / d unit output, the softmax
    over the last axis, with the model quantized up to and including the
    unit (``wstate_sub``) and FP after it (GetLayerGrad,
    data_utill.py:191-256). The unit's output is taken from a capture
    pass and substituted through ``QuantCtx.override``, where the
    reference hooks the backward."""
    with torch.no_grad():
        cap = QuantCtx(adapter.policy, wstate=wstate_sub, astate=astate,
                       use_wq=True, use_aq=use_aq,
                       capture=frozenset({unit_name}),
                       capture_tags=frozenset({"out"}),
                       stop_when_taped=True)
        u_out = _tape(adapter, params, cap, batch)[f"{unit_name}::out"]
        out_fp = adapter.forward(params, None, *batch)
        p_fp = torch.softmax(out_fp, dim=-1)
        log_pfp = torch.log_softmax(out_fp, dim=-1)
    u_out = u_out.detach().requires_grad_(True)
    with torch.enable_grad():
        ctx = QuantCtx(adapter.policy, wstate=wstate_sub, astate=astate,
                       use_wq=True, use_aq=use_aq,
                       override={unit_name: u_out})
        out_q = adapter.forward(params, ctx, *batch)
        # F.kl_div(log_q, p_fp, reduction="batchmean")
        kl = torch.sum(p_fp * (log_pfp - torch.log_softmax(out_q, dim=-1))
                       ) / out_q.shape[0]
        (g,) = torch.autograd.grad(kl, [u_out])
    return g


def wstate_upto(adapter: ModelAdapter, unit: UnitSpec, wstate) -> dict:
    """The weight state of the units up to and including ``unit``: the
    model quantized to there and FP after it."""
    upto = set()
    for u in adapter.units:
        upto.update(full for _, full in u.layers)
        if u.name == unit.name:
            break
    return {k: v for k, v in wstate.items() if k in upto}


def capture_unit_grads(adapter: ModelAdapter, unit: UnitSpec, params,
                       cali_data: Tuple[torch.Tensor, ...], wstate,
                       astate=None, *, use_aq: bool = False,
                       batch_size: int = 32) -> torch.Tensor:
    """save_grad (data_utill.py:54-74): |d KL / d unit output| + 1 over
    the calibration set, the weights of the Fisher reconstruction losses;
    one full forward and backward a batch."""
    wstate_sub = wstate_upto(adapter, unit, wstate)
    astate = astate or {}
    n = cali_data[0].shape[0]
    gs = [_grad_batch(adapter, unit.name, use_aq, params, wstate_sub,
                      astate, tuple(x[i:i + batch_size] for x in cali_data))
          for i in range(0, n, batch_size)]
    return torch.abs(torch.cat(gs)) + 1.0


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
                nu: Dict[str, torch.Tensor], lr, corrections,
                b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                eps_root: float = 0.0):
    """One step of ``optax.adam(lr)`` (scale_by_adam, then scale by -lr,
    then apply_updates), in optax's order of operations:
    mu = (1-b1) g + b1 mu; nu = (1-b2) g^2 + b2 nu; mu_hat = mu / (1 -
    b1^count), nu_hat likewise; u = mu_hat / (sqrt(nu_hat + eps_root) +
    eps); p = p + (-lr) u. ``lr``: a float, or a 0-dim tensor (a
    schedule's value). ``corrections``: this step's (1 - b1^count,
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


def _rec_loss(pred, tgt, p: float, rloss: str = "mse", grads=None):
    """LossFunc's reconstruction term (reconstruction_util.py:51-61): Lp
    summed over channels, summed over the output tuple's leaves; or, with
    the cached |grad| + 1 ``grads``, FISHER_DIAG (the squared error
    weighted by grads^2, summed over channels) or FISHER_FULL (the
    weighted error times its sum over every non-batch axis, / 100)."""
    if rloss == "fisher_diag":
        return torch.mean(torch.sum((pred - tgt) ** 2 * grads ** 2, dim=-1))
    if rloss == "fisher_full":
        a = torch.abs(pred - tgt)
        g = torch.abs(grads)
        bd = torch.sum(a * g, dim=tuple(range(1, a.ndim)), keepdim=True)
        return torch.mean(bd * a * g) / 100.0
    loss = None
    for a, b in zip(_leaves(pred), _leaves(tgt)):
        term = lp_loss(a, b, p=p)
        loss = term if loss is None else loss + term
    return loss


# on the card the loops replay one iteration captured as a CUDA graph
# (eager PyTorch spends about 9 ms an iteration on the host); this many
# eager iterations first, on a side stream, on a copy of the state
GRAPH_WARMUP = 2


def _replay(step, state, i_buf: torch.Tensor, n_iters: int) -> None:
    """Run ``step()`` ``n_iters`` times. ``step`` reads what changes
    between iterations through the device counter ``i_buf`` and updates
    the tensors of ``state`` in place. On the card: GRAPH_WARMUP eager
    iterations on a side stream, ``state`` and the counter put back, then
    one iteration captured as a CUDA graph and replayed; on the CPU:
    eagerly."""
    if i_buf.device.type == "cuda" and n_iters > GRAPH_WARMUP:
        saved = [t.clone() for t in state]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(GRAPH_WARMUP):
                step()
        torch.cuda.current_stream().wait_stream(side)
        with torch.no_grad():
            for t, v in zip(state, saved):
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


def _recon_run(unit_fwd, kind: str, role_cfgs: tuple, extra: tuple,
               hp: ReconHP, uparams, wstate_fixed, alphas, inputs, outputs,
               idx: torch.Tensor, fgrads=None, moments=None, iter0: int = 0):
    """The weight-phase optimization of one unit over the minibatch rows
    ``idx`` (iters, bs): {minibatch -> soft forward -> loss -> Adam}
    (reconstruction.py:63-78, 182-198, 290-303). ``fgrads``: the cached
    Fisher weights when ``hp.rloss`` is not mse, gathered with the
    minibatch. ``moments`` (Adam's mu and nu) and ``iter0`` continue a
    schedule (a segment, a host cache's chunk): the iterations are iter0
    + 1 .. iter0 + iters of ``hp.iters``, Adam starting from ``moments``
    (zero when None). Returns (alphas, moments, per-iteration
    reconstruction losses).

    One iteration is one ``step()`` that reads everything that changes
    between iterations from device tensors through a device counter: the
    minibatch rows, the temperature, the warmup gate of the regularizer
    (JAX's ``where(count < loss_start, 0, w * reg)`` as a factor 0 or 1)
    and Adam's bias corrections, and updates the alphas and Adam's
    moments in place (``_replay``). The per-iteration values are sliced
    from those of the whole schedule, so a segment computes each
    iteration as one run does."""
    keys = sorted(alphas)
    n_iters = idx.shape[0]
    dev = idx.device
    f32 = torch.float32
    total = max(hp.iters, iter0 + n_iters)
    counts = torch.arange(1, total + 1, dtype=f32)
    sl = slice(iter0, iter0 + n_iters)
    temps = linear_temp_decay(counts, hp.iters, hp.warmup, hp.b_start,
                              hp.b_end)[sl].to(dev)
    gates = (counts >= float(np.float32(hp.warmup * hp.iters))).to(
        f32)[sl].to(dev)
    bc1 = adam_corrections(0.9, 1, total, dev)[sl]
    bc2 = adam_corrections(0.999, 1, total, dev)[sl]
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
        bg = None if fgrads is None else fgrads.index_select(0, rows)
        a = {k: a_buf[k].detach().requires_grad_(True) for k in keys}
        with torch.enable_grad():
            pred = unit_fwd(kind, role_cfgs, extra, uparams,
                            _merge_alpha(wstate_fixed, a), {}, binp, True,
                            hp.use_aq)
            rec = _rec_loss(pred, bout, hp.p, hp.rloss, bg)
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

    _replay(step, (*a_buf.values(), *mu.values(), *nu.values()), i_buf,
            n_iters)
    return a_buf, (mu, nu), (losses if n_iters else None)


@torch.no_grad()
def _hard_loss_batch(unit_fwd, kind, role_cfgs, extra, hp: ReconHP,
                     use_aq: bool, uparams, wstate_roles, ast, binp, bout,
                     bg=None):
    """Hard-rounding (inference-mode) reconstruction loss of one batch of
    the cached I/O: the loss the deployed model realizes."""
    pred = unit_fwd(kind, role_cfgs, extra, uparams, wstate_roles, ast,
                    _f32(binp), False, use_aq)
    return _rec_loss(pred, _f32(bout), hp.p, hp.rloss, bg)


def _hard_eval(unit_fwd, kind, role_cfgs, extra, hp: ReconHP, uparams,
               wstate_roles, inputs, outputs, dev, fgrads=None, ast=None,
               use_aq: Optional[bool] = None, batch: int = 256) -> float:
    """Mean hard-rounding loss over the cached I/O, in batches on
    ``dev``, with the activation state ``ast`` (``use_aq`` defaults to
    ``hp.use_aq``). A host cache is subsampled at an even stride to
    ``HARD_EVAL_MAX_BYTES`` of upload (the calibration rows are
    timestep-major, so a prefix would favour early timesteps)."""
    if use_aq is None:
        use_aq = hp.use_aq
    n = _leaves(inputs)[0].shape[0]
    if _on_host(inputs):
        max_rows = max(HARD_EVAL_MIN_ROWS,
                       HARD_EVAL_MAX_BYTES
                       // max(1, _bytes_per_row(inputs, outputs)))
        if n > max_rows:
            idx = np.linspace(0, n - 1, max_rows).astype(np.int64)
            inputs = _tmap(lambda x: x[idx], inputs)
            outputs = _tmap(lambda x: x[idx], outputs)
            if fgrads is not None:
                fgrads = fgrads[idx]
            n = max_rows
    tot, cnt = 0.0, 0
    for i in range(0, n, batch):
        binp = _to(_tmap(lambda x: x[i:i + batch], inputs), dev)
        bout = _to(_tmap(lambda x: x[i:i + batch], outputs), dev)
        bg = None if fgrads is None else _to(fgrads[i:i + batch], dev)
        loss = _hard_loss_batch(unit_fwd, kind, role_cfgs, extra, hp,
                                use_aq, uparams, wstate_roles, ast or {},
                                binp, bout, bg)
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


def _index_source(unit: UnitSpec, hp: ReconHP, dev,
                  generator: Optional[torch.Generator],
                  indices: Optional[IndexSource]):
    """rows(m, iters) -> (iters, bs) minibatch rows on ``dev`` over m
    cached rows: from ``indices`` when given, else from ``generator`` (a
    CPU generator; seed 0 when None)."""
    gen = generator if generator is not None \
        else torch.Generator().manual_seed(0)

    def rows(m: int, iters: int) -> torch.Tensor:
        bs = max(1, min(hp.batch_size, m))
        idx = indices(unit.name, m, bs, iters) if indices is not None \
            else draw_indices(gen, m, bs, iters)
        return idx.to(dev, torch.long)
    return rows


# A checkpointed unit (``partial_path``) runs its schedule in segments of
# at most this many iterations and saves its partial state after each, so
# that a crash resumes inside the unit; a unit's Adam loop at the tasks'
# 20000 iterations takes 40-94 s on an H100.
RESUME_SEG_ITERS = 2500


def _save_partial(path: str, alphas, moments, it0: int,
                  losses: torch.Tensor) -> None:
    """Atomically persist a mid-unit state: the alphas, Adam's mu and nu,
    the next iteration ``it0`` and the reconstruction losses so far."""
    mu, nu = moments
    arrays = {"__it0": np.int64(it0), "__losses": losses.cpu().numpy()}
    for name, tree in (("alpha", alphas), ("mu", mu), ("nu", nu)):
        for role, v in tree.items():
            arrays[f"{name}::{role}"] = v.detach().cpu().numpy()
    tmp = path + ".tmp.npz"   # np.savez appends .npz to other names
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def _load_partial(path: str, dev):
    """(alphas, (mu, nu), it0, losses) saved by ``_save_partial``, on
    ``dev``."""
    with np.load(path) as data:
        trees = {"alpha": {}, "mu": {}, "nu": {}}
        for key in data.files:
            name, _, role = key.partition("::")
            if name in trees:
                trees[name][role] = torch.from_numpy(data[key]).to(dev)
        return (trees["alpha"], (trees["mu"], trees["nu"]),
                int(data["__it0"]),
                torch.from_numpy(data["__losses"]).to(dev))


def reconstruct_unit(adapter: ModelAdapter, unit: UnitSpec, params,
                     wstate, inputs, outputs, hp: ReconHP,
                     generator: Optional[torch.Generator] = None,
                     fgrads=None, *, partial_path: Optional[str] = None,
                     indices: Optional[IndexSource] = None,
                     stats: Optional[dict] = None):
    """Weight-phase reconstruction of one unit; returns (wstate with the
    unit's alphas written back under their full layer names, per-iteration
    losses or None). ``fgrads``: the unit's cached Fisher weights
    (``capture_unit_grads``) when ``hp.rloss`` is not mse, on the device
    or, with a host cache, in host memory.

    A host cache (numpy, from ``capture_unit_io(..., to_host=True)``)
    runs the chunked schedule, one chunk on the device at a time.

    ``partial_path``: the schedule runs in segments of at most
    ``RESUME_SEG_ITERS`` iterations, the partial state saved there after
    each; when the file exists the unit resumes from it. The minibatch
    rows of the whole schedule are drawn first either way, so a resumed
    unit ends where an uninterrupted one does.

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
                              outputs, dev, fgrads)
    if hp.loss_floor > 0.0 and hard_nearest <= hp.loss_floor:
        logger.info("recon %s: nearest-rounding loss %.6f already below "
                    "floor %g, skipping optimization", unit.name,
                    hard_nearest, hp.loss_floor)
        if stats is not None:
            stats[unit.name] = {"hard_nearest": hard_nearest,
                                "kept": "nearest", "skipped": True}
        return wstate, None

    rows = _index_source(unit, hp, dev, generator, indices)
    moments, it0, parts = None, 0, []
    if partial_path is not None and os.path.exists(partial_path):
        alphas, moments, it0, done = _load_partial(partial_path, dev)
        parts.append(done)
        logger.info("recon %s: resuming mid-unit at iteration %d/%d",
                    unit.name, it0, hp.iters)

    def advance(cin, cout, cg, idx, c0: int, c_end: int) -> None:
        """Run iterations it0 .. c_end - 1 (the rows ``idx`` start at
        iteration c0), in segments when checkpointing."""
        nonlocal alphas, moments, it0
        while it0 < c_end:
            seg = c_end - it0 if partial_path is None \
                else min(RESUME_SEG_ITERS, c_end - it0)
            alphas, moments, ls = _recon_run(
                adapter.unit_fwd, unit.kind, role_cfgs, unit.extra, hp,
                uparams, fixed, alphas, cin, cout,
                idx[it0 - c0:it0 - c0 + seg], cg, moments, it0)
            it0 += seg
            parts.append(ls)
            if partial_path is not None:
                _save_partial(partial_path, alphas, moments, it0,
                              torch.cat(parts))

    n = _leaves(inputs)[0].shape[0]
    if _on_host(inputs):
        # the chunked schedule (recon.py:672-700): equal chunks of a fixed
        # permutation, the last wrapping to the front; the iterations split
        # evenly, the remainder on the last chunk; Adam carried across.
        # Every chunk draws its rows, one finished before a crash too
        chunk_n = max(hp.batch_size,
                      min(n, _HOST_CHUNK_BYTES
                          // max(1, _bytes_per_row(inputs, outputs))))
        chunk_n = min(chunk_n, max(1, n))
        n_chunks = -(-n // chunk_n)
        iters_per = [hp.iters // n_chunks] * n_chunks
        iters_per[-1] += hp.iters - sum(iters_per)
        perm = np.random.RandomState(0).permutation(n)
        c0 = 0
        for c, n_it in enumerate(iters_per):
            if n_it == 0:
                continue
            idx = rows(chunk_n, n_it)
            if it0 < c0 + n_it:
                sel = perm[(c * chunk_n + np.arange(chunk_n)) % n]
                advance(_to(_tmap(lambda x: x[sel], inputs), dev),
                        _to(_tmap(lambda x: x[sel], outputs), dev),
                        None if fgrads is None else _to(fgrads[sel], dev),
                        idx, c0, c0 + n_it)
            c0 += n_it
    else:
        advance(inputs, outputs, fgrads, rows(n, hp.iters), 0, hp.iters)
    losses = torch.cat(parts) if parts else None

    hard_trained = _hard_eval(adapter.unit_fwd, unit.kind, role_cfgs,
                              unit.extra, hp, uparams,
                              _merge_alpha(fixed, alphas), inputs, outputs,
                              dev, fgrads)
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


def _probe(adapter: ModelAdapter, names, params, cali_data,
           tags: frozenset) -> dict:
    """One 1-sample FP forward taping ``tags`` of every unit in ``names``:
    the I/O shapes that size the caches."""
    return _capture_many(adapter, frozenset(names), tags, params,
                         tuple(x[:1] for x in cali_data))


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
    matters, as in the reference. With ``hp.rloss`` other than mse every
    unit but the TIB also captures its Fisher weights
    (``capture_unit_grads``).

    ``generator`` gives every reconstructed unit its own seed, drawn in
    unit order (a resumed unit draws its seed too, so the stream stays
    aligned). ``resume_dir``: each finished unit's alphas and its
    ``stats`` record are saved there (``<unit>.npz``), and a re-run loads
    them and skips the unit; a unit in progress saves its partial state
    (``<unit>.npz.partial``) every ``RESUME_SEG_ITERS`` iterations, and a
    re-run resumes from it; the partial file goes once the unit's file is
    written. ``log(unit_name, losses or None)`` is called after each
    reconstructed unit, and with None for a resumed one. ``residency``
    collects the residency decisions: "fp_out_cache" ("shared" or
    "fused"), "fp_out_gib" (the shared cache's size, float16) and "host"
    (the units cached in host memory)."""
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
        ptape = _probe(adapter, [u.name for u in pending], params,
                       cali_data, frozenset({"in", "out"}))
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
        shared = hp.asym and total <= FP_OUT_BUDGET
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
                        " or the capture is symmetric -- per-unit fused "
                        "capture", total / (1 << 30))

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
            adapter, unit, params, cali_data, wstate, asym=hp.asym,
            use_aq=hp.use_aq, batch_size=capture_batch_size,
            to_host=to_host, fp_out=fp_outs.pop(unit.name, None))
        fgrads = None
        if hp.rloss != "mse" and not unit.kind.startswith("tib"):
            fgrads = capture_unit_grads(adapter, unit, params, cali_data,
                                        wstate, use_aq=hp.use_aq,
                                        batch_size=capture_batch_size)
            if to_host:
                fgrads = fgrads.cpu().numpy()
        partial = _unit_path(unit.name) + ".partial" if resume_dir \
            else None
        record = {}
        # the TIB's output is a tuple of projections with no Fisher
        # weights: it keeps the Lp loss (JAX's _rec_loss fails on it)
        uhp = hp if fgrads is not None else dataclasses.replace(
            hp, rloss="mse")
        wstate, losses = reconstruct_unit(adapter, unit, params, wstate,
                                          inputs, outputs, uhp, unit_gen,
                                          fgrads, partial_path=partial,
                                          indices=indices, stats=record)
        del inputs, outputs, fgrads
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
            if os.path.exists(partial):
                os.remove(partial)
        if log is not None and losses is not None:
            log(unit.name, losses)
    return wstate


# ---------------------------------------------------------------------------
# the act phase (reconstruction.py:43-48)
# ---------------------------------------------------------------------------

def _act_run(unit_fwd, kind: str, role_cfgs: tuple, extra: tuple,
             hp: ReconHP, uparams, wstate_roles, zps, deltas, inputs,
             outputs, idx: torch.Tensor):
    """The act-phase optimization of one unit over the minibatch rows
    ``idx`` (iters, bs): Adam on the activation deltas with
    ``optax.cosine_decay_schedule(hp.lr_delta, hp.iters)`` (update c,
    from 0, at lr_delta 1/2 (1 + cos(pi c / iters)); the reference's
    CosineAnnealingLR, T_max iters, eta_min 0), the reconstruction loss
    only (round loss NONE), the weights in hard rounding
    (reconstruction.py:43-48). Written out as ``adam_update``, one
    ``step()`` reading the rows, the learning rate and the bias
    corrections through a device counter (``_replay``: one CUDA graph on
    the card). Returns (deltas, per-iteration losses)."""
    keys = sorted(deltas)
    n_iters = idx.shape[0]
    dev = idx.device
    f32 = torch.float32
    count = torch.clamp(torch.arange(n_iters, dtype=f32),
                        max=float(hp.iters))
    lrs = (hp.lr_delta * (0.5 * (1 + torch.cos(math.pi * count
                                               / float(hp.iters))))).to(dev)
    bc1 = adam_corrections(0.9, 1, n_iters, dev)
    bc2 = adam_corrections(0.999, 1, n_iters, dev)
    d_buf = {k: deltas[k].detach().clone() for k in keys}
    mu = {k: torch.zeros_like(d_buf[k]) for k in keys}
    nu = {k: torch.zeros_like(d_buf[k]) for k in keys}
    i_buf = torch.zeros(1, dtype=torch.long, device=dev)
    losses = torch.zeros(n_iters, dtype=f32, device=dev)

    def at(t):
        return t.index_select(0, i_buf)

    def step():
        rows = at(idx).view(-1)
        binp = _f32(_tmap(lambda x: x.index_select(0, rows), inputs))
        bout = _f32(_tmap(lambda x: x.index_select(0, rows), outputs))
        d = {k: d_buf[k].detach().requires_grad_(True) for k in keys}
        with torch.enable_grad():
            ast = {k: {"delta": d[k], "zp": zps[k]} for k in keys}
            pred = unit_fwd(kind, role_cfgs, extra, uparams, wstate_roles,
                            ast, binp, False, True)
            rec = _rec_loss(pred, bout, hp.p, hp.rloss)
            grads = torch.autograd.grad(rec, [d[k] for k in keys])
        new, new_mu, new_nu = adam_update(
            {k: d[k].detach() for k in keys}, dict(zip(keys, grads)), mu,
            nu, at(lrs).view(()), (at(bc1).view(()), at(bc2).view(())))
        with torch.no_grad():
            for k in keys:
                d_buf[k].copy_(new[k])
                mu[k].copy_(new_mu[k])
                nu[k].copy_(new_nu[k])
            losses.index_copy_(0, i_buf, rec.detach().reshape(1))
            i_buf.add_(1)

    _replay(step, (*d_buf.values(), *mu.values(), *nu.values()), i_buf,
            n_iters)
    return d_buf, (losses if n_iters else None)


def reconstruct_unit_act(adapter: ModelAdapter, unit: UnitSpec, params,
                         wstate, astate, inputs, outputs, hp: ReconHP,
                         generator: Optional[torch.Generator] = None, *,
                         indices: Optional[IndexSource] = None,
                         stats: Optional[dict] = None):
    """Act-phase reconstruction of one unit: returns (astate with the
    unit's activation deltas re-trained against the cached FP outputs,
    per-iteration losses or None). ``inputs`` must have been captured with
    ``use_aq=True``. The zero points stay as they are.

    Do-no-harm guard: the trained deltas are kept only if their
    hard-rounding loss over the cached I/O is below the calibrated
    deltas' (the reference keeps them unconditionally,
    reconstruction.py:43-48). ``stats`` collects {unit: {"loss_before",
    "loss_after", "kept"}}, "kept" "trained" or "calibrated". Minibatch
    rows as in ``reconstruct_unit``."""
    role_cfgs = adapter.role_cfgs(unit, frozenset())
    uparams = adapter.extract_uparams(params, unit)
    wstate_roles = {role: wstate[full] for role, full in unit.layers
                    if full in wstate}
    deltas, zps, full_of = {}, {}, {}
    for role, full in tuple(unit.layers) + tuple(unit.act_sites):
        pol = adapter.policy.get(full)
        st = astate.get(full)
        if pol is None or not pol.aq or st is None:
            continue
        deltas[role] = st["delta"]
        zps[role] = st["zp"]
        full_of[role] = full
    if not deltas:
        return astate, None
    dev = next(iter(deltas.values())).device

    def hard(d):
        return _hard_eval(adapter.unit_fwd, unit.kind, role_cfgs,
                          unit.extra, hp, uparams, wstate_roles, inputs,
                          outputs, dev,
                          ast={r: {"delta": d[r], "zp": zps[r]} for r in d},
                          use_aq=True)

    loss_before = hard(deltas)
    rows = _index_source(unit, hp, dev, generator, indices)
    trained, losses = _act_run(
        adapter.unit_fwd, unit.kind, role_cfgs, unit.extra, hp, uparams,
        wstate_roles, zps, deltas, inputs, outputs,
        rows(_leaves(inputs)[0].shape[0], hp.iters))
    loss_after = hard(trained)
    kept = loss_after < loss_before
    if not kept:
        logger.info("act recon %s guard: %.6f -> %.6f, keeping the "
                    "calibrated deltas", unit.name, loss_before, loss_after)
    if stats is not None:
        stats[unit.name] = {"loss_before": loss_before,
                            "loss_after": loss_after,
                            "kept": "trained" if kept else "calibrated"}
    new_astate = dict(astate)
    for role, d in (trained if kept else deltas).items():
        full = full_of[role]
        new_astate[full] = dict(new_astate[full])
        new_astate[full]["delta"] = d
    return new_astate, losses


def reconstruct_act(adapter: ModelAdapter, params, cali_data, wstate,
                    astate, hp: ReconHP,
                    generator: Optional[torch.Generator] = None, *,
                    capture_batch_size: int = 128, log=None,
                    indices: Optional[IndexSource] = None,
                    stats: Optional[dict] = None):
    """Act-phase reconstruction over every unit with an activation site
    in ``astate``, in module order (the reference's ``use_aq=True``
    second pass of recon_model). ``astate`` is a flat ``{site: {delta,
    zp}}`` dict (e.g. one FSC group's slice, ``fsc.slice_fsc``); returns
    it with the deltas re-trained. Each unit's inputs are captured under
    the prefix quantized with the deltas trained so far. The FP outputs
    come from one shared pass when ``hp.asym`` and they fit
    ``FP_OUT_BUDGET`` (the TIB takes its own, as in the weight phase).
    ``generator`` gives each unit its seed, drawn in unit order;
    ``log(unit_name, losses)``; ``stats`` as ``reconstruct_unit_act``'s."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)

    def _has_act(unit):
        return any(
            (pol := adapter.policy.get(full)) is not None and pol.aq
            and full in astate
            for _, full in tuple(unit.layers) + tuple(unit.act_sites))

    units = [u for u in adapter.units
             if u.recon and adapter.default_train_roles(u) and _has_act(u)]
    cached = [u.name for u in units if not u.kind.startswith("tib")]
    fp_outs = {}
    if hp.asym and cached:
        ptape = _probe(adapter, cached, params, cali_data,
                       frozenset({"out"}))
        total = sum(_bytes_per_row((), v) for v in ptape.values()) \
            * cali_data[0].shape[0] // 2   # float16
        del ptape
        if total <= FP_OUT_BUDGET:
            fp_outs = precapture_fp_outs(adapter, cached, params, cali_data,
                                         batch_size=capture_batch_size)
    for unit in units:
        inputs, outputs = capture_unit_io(
            adapter, unit, params, cali_data, wstate, astate,
            asym=hp.asym, use_aq=True, batch_size=capture_batch_size,
            fp_out=fp_outs.pop(unit.name, None))
        unit_gen = torch.Generator().manual_seed(_unit_seed(generator))
        astate, losses = reconstruct_unit_act(
            adapter, unit, params, wstate, astate, inputs, outputs, hp,
            unit_gen, indices=indices, stats=stats)
        del inputs, outputs
        if log is not None and losses is not None:
            log(unit.name, losses)
    return astate
