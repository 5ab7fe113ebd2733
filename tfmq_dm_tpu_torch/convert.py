"""Parameters of the JAX package -> the port.

The port keeps the JAX package's layouts (HWIO conv weights, (in, out)
linear weights, NHWC activations) at its public functions, so conversion
is a change of array type only: the one place where a layout change would
go is here. ``load_params`` reads the trainer's checkpoint format
(``p::<layer>::<field>`` + ``__meta__``, pipelines/training.py:220-233),
e.g. ``runs/cifar10_ddpm.npz``.
"""

from __future__ import annotations

import json
from typing import Dict, Tuple

import numpy as np
import torch


def params_from_numpy(np_params: Dict, device="cuda") -> Dict:
    """{layer: {field: np.ndarray}} (the JAX parameter dict as numpy) ->
    {layer: {field: float32 torch.Tensor on ``device``}}."""
    out: Dict = {}
    for layer, fields in np_params.items():
        out[layer] = {k: torch.from_numpy(np.array(v, np.float32)).to(
            device) for k, v in fields.items()}
    return out


def load_params(path: str, device="cuda") -> Tuple[Dict, dict]:
    """Read a ``p::<layer>::<field>`` npz -> (params, meta)."""
    with np.load(path if path.endswith(".npz") else path + ".npz") as data:
        meta = json.loads(bytes(data["__meta__"]).decode("utf-8"))
        np_params: Dict = {}
        for key in data.files:
            if key == "__meta__":
                continue
            _, layer, field = key.split("::")
            if not field:
                raise ValueError(f"{key}: expected <layer>::<field> keys")
            np_params.setdefault(layer, {})[field] = data[key]
    return params_from_numpy(np_params, device), meta
