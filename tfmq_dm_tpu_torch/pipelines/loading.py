"""Checkpoint loading (port of ``tfmq_dm_tpu/pipelines/loading.py``):

- the LDM family: a PyTorch-Lightning ``.ckpt`` ``{'state_dict': ...}``
  with the submodule prefixes ``model.diffusion_model.`` /
  ``first_stage_model.`` / ``cond_stage_model.`` (the last absent for the
  unconditional tasks), and LitEma weights under ``model_ema.*`` with the
  dots stripped from their names (ldm/modules/ema.py);
- the ddim family: the reference's DDIM ``ckpt.pth``, a bare state dict
  or the trainer's ``[state, optimizer, epoch, step, ema]`` list, with
  DataParallel's ``module.`` prefixes (ddim/runners/diffusion.py:205-243).

The repo's own ``p::`` npz loader stays in ``convert.py``.

A Lightning checkpoint pickles more than tensors: ``callbacks`` (the
CompVis SD v1.x files carry a ``ModelCheckpoint``), ``hyper_parameters``
and loop state, as objects of Lightning's classes. ``torch.load`` with
``weights_only=True`` refuses such a file, and ``weights_only=False``, as
the JAX package loads it, needs Lightning installed to rebuild those
objects. ``load_checkpoint`` takes a third way: it unpickles PyTorch's own
globals (tensors, storages, dtypes) and ``OrderedDict`` as they are and
puts an inert stand-in in place of every other global, so the tensors of
any such file load, with or without Lightning, and nothing outside
PyTorch is imported or called."""

from __future__ import annotations

import logging
import pickle
from typing import Dict, Optional

import torch

from ..configs.tasks import TaskConfig, text_encoder
from ..models import ddim_unet, ldm_unet, vae as vae_mod
from ..utils.torch_convert import convert_state_dict

logger = logging.getLogger(__name__)


class _Skipped(dict):
    """Stand-in for a global outside PyTorch: takes any constructor
    arguments and any pickled state (a numpy array's is a tuple); a dict,
    so that it also takes the items of a pickled dict subclass
    (Lightning's ``AttributeDict``)."""

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        pass


class _TensorsOnly:
    """A ``pickle_module`` for ``torch.load`` (see the module docstring)."""

    load = pickle.load

    class Unpickler(pickle.Unpickler):
        def find_class(self, module, name):
            if module == "torch" or module.startswith("torch.") or \
                    (module == "collections" and name == "OrderedDict"):
                return super().find_class(module, name)
            return _Skipped


def load_checkpoint(path: str) -> Dict:
    """The checkpoint's pickled object with its tensors on the CPU and
    every non-PyTorch object replaced by an inert stand-in."""
    return torch.load(path, map_location="cpu", weights_only=False,
                      pickle_module=_TensorsOnly)


def _strip_prefix(sd: Dict, prefix: str) -> Dict:
    return {k[len(prefix):]: v for k, v in sd.items()
            if k.startswith(prefix)}


def _apply_ema(unet_sd: Dict, full_sd: Dict) -> Dict:
    """Swap in LitEma weights: ema names are the param names with dots
    removed, under 'model_ema.' (loading.py:38-53)."""
    ema = _strip_prefix(full_sd, "model_ema.")
    if not ema:
        return unet_sd
    out = dict(unet_sd)
    n = 0
    for k in unet_sd:
        ek = ("diffusion_model." + k).replace(".", "")
        if ek in ema:
            out[k] = ema[ek]
            n += 1
    logger.info("EMA swap: %d/%d tensors", n, len(unet_sd))
    return out


def _strip_module(sd: Dict) -> Dict:
    return {k.removeprefix("module."): v for k, v in sd.items()}


def load_ddim_checkpoint(path: str, cfg: ddim_unet.DDIMUNetConfig,
                         use_ema: bool = True, device="cuda") -> Dict:
    """The reference's DDIM checkpoint -> the port's parameters on
    ``device``: a bare state dict (the pretrained-DDPM files), or the
    trainer's ``[state, optimizer, epoch, step, ema]`` list, whose EMAHelper
    shadow weights replace the raw ones when ``use_ema``
    (loading.py:55-78, ddim/models/ema.py)."""
    states = load_checkpoint(path)
    ema = None
    if isinstance(states, (list, tuple)):
        sd = states[0]
        if use_ema and len(states) >= 2 and \
                isinstance(states[-1], dict) and any(
                    hasattr(v, "shape") for v in states[-1].values()):
            ema = states[-1]
    else:
        sd = states.get("state_dict", states)
    sd = _strip_module(sd)
    if ema:
        ema = _strip_module(ema)
        n = sum(1 for k in sd if k in ema)
        sd = {k: ema.get(k, v) for k, v in sd.items()}
        logger.info("EMA swap: %d/%d tensors", n, len(sd))
    return convert_state_dict(sd, ddim_unet.iter_layers(cfg), device)


def load_ldm_checkpoint(path: str, task: TaskConfig,
                        use_ema: Optional[bool] = None, device="cuda"):
    """-> (unet_params, vae_params, cond_params or None), tensors on
    ``device``. The first stage's decoder side only (the port decodes).
    ``cond_params``: the class embedding table ``{"embedding": tensor}``
    of a class-conditional task, or the text tower's parameters
    (``cond_stage_model.transformer.*``: BERT's x-transformers names where
    the task has a BERT encoder, else CLIP's HF names; loading.py:97-111)
    of a text-conditioned one; None for an unconditional task and when
    the checkpoint has neither."""
    full = load_checkpoint(path)
    sd = full.get("state_dict", full)
    unet_sd = _strip_prefix(sd, "model.diffusion_model.")
    if task.use_ema if use_ema is None else use_ema:
        unet_sd = _apply_ema(unet_sd, sd)
    unet_params = convert_state_dict(
        unet_sd, ldm_unet.iter_layers(task.unet), device)
    vae_params = convert_state_dict(
        _strip_prefix(sd, "first_stage_model."),
        vae_mod.iter_layers(task.vae), device)
    cond_params = None
    if task.cond == "class":
        w = sd.get("cond_stage_model.embedding.weight")
        if w is not None:
            cond_params = {"embedding": w.detach().to(device,
                                                      torch.float32)}
    elif task.cond == "text":
        cond_sd = _strip_prefix(sd, "cond_stage_model.transformer.")
        if cond_sd:
            enc, ecfg = text_encoder(task)
            cond_params = convert_state_dict(
                cond_sd, enc.iter_layers(ecfg), device)
    return unet_params, vae_params, cond_params
