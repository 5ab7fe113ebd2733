"""Reference-format torch state dicts <-> the port's parameter dicts (the
port's copy of ``tfmq_dm_tpu/utils/torch_convert.py``).

Pure relabel and transpose: parameter names are the torch ``state_dict``
module paths, and only the layout changes:

- linear  : torch (out, in)       -> ours (in, out)
- conv1d  : torch (out, in, 1)    -> ours (in, out)
- conv2d  : torch (O, I, kh, kw)  -> ours (kh, kw, I, O)
- norms   : weight/bias           -> scale/bias
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _tensor(x, device) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.asarray(x))
    return x.detach().to(device=device, dtype=torch.float32)


def convert_state_dict(torch_sd: Mapping[str, object], layer_iter,
                       device="cpu") -> Dict[str, dict]:
    """Our flat param dict from a torch state_dict. ``layer_iter`` yields
    (kind, name, shape) like ``models.ldm_unet.iter_layers``."""
    params: Dict[str, dict] = {}
    for kind, name, _ in layer_iter:
        if kind in ("norm", "lnorm"):
            params[name] = {
                "scale": _tensor(torch_sd[f"{name}.weight"], device),
                "bias": _tensor(torch_sd[f"{name}.bias"], device)}
            continue
        if kind == "embed":
            params[name] = {"w": _tensor(torch_sd[f"{name}.weight"],
                                         device)}
            continue
        w = _tensor(torch_sd[f"{name}.weight"], device)
        if kind == "conv1d":
            w = w[:, :, 0].T
        elif kind.startswith("linear"):
            w = w.T
        else:
            w = w.permute(2, 3, 1, 0)
        entry = {"w": w.contiguous()}
        bkey = f"{name}.bias"
        if bkey in torch_sd:
            entry["b"] = _tensor(torch_sd[bkey], device)
        params[name] = entry
    return params


def export_state_dict(params: Dict[str, dict],
                      layer_iter) -> Dict[str, torch.Tensor]:
    """Exact inverse of ``convert_state_dict``: CPU tensors in the torch
    layout, keyed by state_dict name."""
    out: Dict[str, torch.Tensor] = {}
    for kind, name, _ in layer_iter:
        p = {k: v.detach().cpu() for k, v in params[name].items()}
        if kind in ("norm", "lnorm"):
            out[f"{name}.weight"] = p["scale"]
            out[f"{name}.bias"] = p["bias"]
            continue
        if kind == "embed":
            out[f"{name}.weight"] = p["w"]
            continue
        w = p["w"]
        if kind == "conv1d":
            w = w.T[:, :, None]
        elif kind.startswith("linear"):
            w = w.T
        else:
            w = w.permute(3, 2, 0, 1)
        out[f"{name}.weight"] = w.contiguous()
        if "b" in p:
            out[f"{name}.bias"] = p["b"]
    return out
