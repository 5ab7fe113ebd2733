"""Calibration artifact (port of ``tfmq_dm_tpu/quant/artifact.py``): the
same flat-key npz, so an artifact written by either package drives the
other.

  w::<layer>::delta|zp|alpha      weight quantizer state
  fsc::<site>::delta|zp           per-timestep-group act state, (G, ...)
  __meta__                        JSON: version, bits, model config, notes
"""

from __future__ import annotations

import json
from typing import Dict, Optional, Tuple

import numpy as np
import torch

FORMAT_VERSION = 1


def save_artifact(path: str, wstate: Dict, astate: Optional[Dict] = None,
                  meta: Optional[dict] = None) -> None:
    arrays = {}
    for layer, st in wstate.items():
        for k, v in st.items():
            if v is not None:
                arrays[f"w::{layer}::{k}"] = v.detach().cpu().numpy()
    if astate:
        for site, st in astate.items():
            for k, v in st.items():
                arrays[f"fsc::{site}::{k}"] = v.detach().cpu().numpy()
    m = dict(meta or {})
    m["format_version"] = FORMAT_VERSION
    arrays["__meta__"] = np.frombuffer(
        json.dumps(m).encode("utf-8"), dtype=np.uint8)
    np.savez(path, **arrays)


def load_artifact(path: str, device="cuda"
                  ) -> Tuple[Dict, Optional[Dict], dict]:
    """-> (wstate, astate or None, meta), tensors on ``device``."""
    with np.load(path if path.endswith(".npz") else path + ".npz") as data:
        meta = json.loads(bytes(data["__meta__"]).decode("utf-8"))
        wstate: Dict = {}
        astate: Dict = {}
        for key in data.files:
            if key == "__meta__":
                continue
            kind, name, field = key.split("::")
            tgt = wstate if kind == "w" else astate
            tgt.setdefault(name, {})[field] = \
                torch.from_numpy(data[key]).to(device)
    return wstate, (astate or None), meta
