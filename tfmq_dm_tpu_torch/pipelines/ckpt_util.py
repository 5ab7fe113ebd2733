"""Pretrained-DDPM checkpoint names, resolved to a file in the local cache
with an md5 check (port of ``tfmq_dm_tpu/pipelines/ckpt_util.py``; the
reference's ddim/functions/ckpt_util.py:5-72).

The registry holds the names, cache paths and md5 digests the reference
publishes. The port never downloads: a missing file, or one that fails its
md5, raises and says where to put it (the URL it came from included).
"""

from __future__ import annotations

import hashlib
import os

URLS = {
    "cifar10": "https://heibox.uni-heidelberg.de/f/869980b53bf5416c8a28/?dl=1",
    "ema_cifar10": "https://heibox.uni-heidelberg.de/f/2e4f01e2d9ee49bab1d5/?dl=1",
    "lsun_bedroom": "https://heibox.uni-heidelberg.de/f/f179d4f21ebc4d43bbfe/?dl=1",
    "ema_lsun_bedroom": "https://heibox.uni-heidelberg.de/f/b95206528f384185889b/?dl=1",
    "lsun_cat": "https://heibox.uni-heidelberg.de/f/fac870bd988348eab88e/?dl=1",
    "ema_lsun_cat": "https://heibox.uni-heidelberg.de/f/0701aac3aa69457bbe34/?dl=1",
    "lsun_church": "https://heibox.uni-heidelberg.de/f/2711a6f712e34b06b9d8/?dl=1",
    "ema_lsun_church": "https://heibox.uni-heidelberg.de/f/44ccb50ef3c6436db52e/?dl=1",
}

CACHE_PATHS = {
    "cifar10": "diffusion_cifar10_model/model-790000.ckpt",
    "ema_cifar10": "ema_diffusion_cifar10_model/model-790000.ckpt",
    "lsun_bedroom": "diffusion_lsun_bedroom_model/model-2388000.ckpt",
    "ema_lsun_bedroom":
        "ema_diffusion_lsun_bedroom_model/model-2388000.ckpt",
    "lsun_cat": "diffusion_lsun_cat_model/model-1761000.ckpt",
    "ema_lsun_cat": "ema_diffusion_lsun_cat_model/model-1761000.ckpt",
    "lsun_church": "diffusion_lsun_church_model/model-4432000.ckpt",
    "ema_lsun_church":
        "ema_diffusion_lsun_church_model/model-4432000.ckpt",
}

MD5S = {
    "cifar10": "82ed3067fd1002f5cf4c339fb80c4669",
    "ema_cifar10": "1fa350b952534ae442b1d5235cce5cd3",
    "lsun_bedroom": "f70280ac0e08b8e696f42cb8e948ff1c",
    "ema_lsun_bedroom": "1921fa46b66a3665e450e42f36c2720f",
    "lsun_cat": "bbee0e7c3d7abfb6e2539eaf2fb9987b",
    "ema_lsun_cat": "646f23f4821f2459b8bafc57fd824558",
    "lsun_church": "eb619b8a5ab95ef80f94ce8a5488dae3",
    "ema_lsun_church": "fdc68a23938c2397caba4a260bc2445f",
}


def canonical_name(name: str) -> str:
    """The registry's name for ``name``: the reference's
    ``*church_outdoor`` aliases map to ``*church`` (ckpt_util.py:59-60)."""
    return name.replace("church_outdoor", "church")


def md5_of(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.md5()
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                break
            h.update(block)
    return h.hexdigest()


def get_ckpt_path(name: str) -> str:
    """The cached file of a named pretrained checkpoint, under
    ``$XDG_CACHE_HOME`` (or ``~/.cache``), then
    ``diffusion_models_converted``, its md5 verified. Raises KeyError
    for an unknown name and FileNotFoundError for a file that is missing
    or fails its md5."""
    name = canonical_name(name)
    if name not in URLS:
        raise KeyError(
            f"unknown checkpoint '{name}'; known: {sorted(URLS)}")
    path = os.path.join(
        os.environ.get("XDG_CACHE_HOME", os.path.expanduser("~/.cache")),
        "diffusion_models_converted", CACHE_PATHS[name])
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"checkpoint '{name}' not found at {path}: place the file "
            f"there (source: {URLS[name]}); this package never downloads")
    if md5_of(path) != MD5S[name]:
        raise FileNotFoundError(
            f"checkpoint '{name}' at {path} fails its md5 (expected "
            f"{MD5S[name]}): replace the file (source: {URLS[name]})")
    return path
