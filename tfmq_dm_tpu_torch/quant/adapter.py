"""Model adapter: what the calibration, reconstruction and deployment code
needs to know of a model (port of ``tfmq_dm_tpu/quant/adapter.py``).

- ``units``: the ordered reconstruction units (the TIB first, then blocks
  and standalone layers in module order; calibration.py:56-84);
- ``unit_fwd``: one function per unit *kind* over role-keyed params and
  state, so that one code path serves all units of a kind;
- ``forward``: the full-model forward threading a QuantCtx (capture
  passes, FSC passes and inference).

An adapter without units (the LDM family's, until its reconstruction
slice) serves the FSC init pass, deployment and sampling only.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

from .policy import QuantPolicy
from .quantizer import QCfg


@dataclasses.dataclass(frozen=True)
class RoleCfg:
    """Static per-role quantization config inside a unit forward."""

    role: str
    w_cfg: Optional[QCfg] = None   # None: the weight stays FP
    a_cfg: Optional[QCfg] = None
    aq: bool = False               # input act-quant enabled for this role
    train: bool = False            # the alpha trains in this unit's recon


@dataclasses.dataclass(frozen=True)
class UnitSpec:
    """One reconstruction unit. ``layers`` maps role -> full layer name
    for weight layers; ``act_sites`` maps role -> full site name for
    standalone act sites; ``extra`` carries kind-specific data (the TIB's
    channel count and projection count)."""

    name: str
    kind: str
    layers: Tuple[Tuple[str, str], ...]
    act_sites: Tuple[Tuple[str, str], ...] = ()
    recon: bool = True
    extra: tuple = ()


@dataclasses.dataclass(eq=False)
class ModelAdapter:
    policy: QuantPolicy
    # forward(params, ctx, *cali_batch) -> model output (ctx may be None)
    forward: Callable
    units: Sequence[UnitSpec] = ()
    # unit_fwd(kind, role_cfgs, extra, uparams, wstate, astate, inputs,
    #          soft_on, use_aq) -> output tensor or tuple
    unit_fwd: Optional[Callable] = None
    # extract_uparams(params, unit) -> role-keyed param dict
    extract_uparams: Optional[Callable] = None

    def unit_by_name(self, name: str) -> UnitSpec:
        for u in self.units:
            if u.name == name:
                return u
        raise KeyError(name)

    def role_cfgs(self, unit: UnitSpec,
                  train_roles: frozenset) -> Tuple[RoleCfg, ...]:
        """The per-role config tuple of a unit, from the policy (bits and
        flags) and the set of roles that train."""
        out = []
        for role, full in unit.layers:
            pol = self.policy.get(full)
            if pol is None:
                out.append(RoleCfg(role=role))
                continue
            out.append(RoleCfg(role=role,
                               w_cfg=pol.w_cfg if pol.wq else None,
                               a_cfg=pol.a_cfg, aq=pol.aq,
                               train=role in train_roles))
        for role, full in unit.act_sites:
            pol = self.policy.get(full)
            out.append(RoleCfg(role=role,
                               a_cfg=None if pol is None else pol.a_cfg,
                               aq=bool(pol and pol.aq)))
        return tuple(out)

    def default_train_roles(self, unit: UnitSpec) -> frozenset:
        """Roles whose AdaRound alpha trains in this unit's recon:
        recon-enabled weight layers that are not quant_emb (temb_proj is
        reconstructed by the TIB, reconstruction.py:110-112,138), except
        inside the TIB itself (reconstruction.py:246-258)."""
        roles = []
        for role, full in unit.layers:
            pol = self.policy.get(full)
            if pol is None or not pol.wq or not pol.recon:
                continue
            if unit.kind != "tib" and pol.quant_emb:
                continue
            roles.append(role)
        return frozenset(roles)
