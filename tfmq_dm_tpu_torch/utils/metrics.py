"""Fidelity metrics between a quantized model and its FP counterpart (the
port's copy of ``psnr`` and ``sqnr_db`` in ``tfmq_dm_tpu/utils/
metrics.py``), in float64 over numpy arrays."""

from __future__ import annotations

import numpy as np


def psnr(a: np.ndarray, b: np.ndarray, data_range: float = 1.0) -> float:
    mse = float(np.mean((np.asarray(a, np.float64)
                         - np.asarray(b, np.float64)) ** 2))
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(data_range ** 2 / mse)


def sqnr_db(fp: np.ndarray, quant: np.ndarray) -> float:
    """Signal-to-quantization-noise ratio in dB."""
    fp = np.asarray(fp, np.float64)
    err = fp - np.asarray(quant, np.float64)
    return 10.0 * np.log10(np.sum(fp ** 2) / max(np.sum(err ** 2), 1e-20))
