"""Timing of calls on an NVIDIA card: device time from a CUDA graph
replayed between CUDA events, and wall time per eager call."""

from __future__ import annotations

import time

import torch


def wall_ms(fn, iters: int = 20) -> float:
    """Wall time per eager call, back to back: host work (argument checks,
    allocation, launch) included."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def device_ms(fn, iters: int = 20) -> float:
    """Device time per call: ``iters`` calls captured in one CUDA graph,
    replayed and timed with CUDA events, so no host work is counted.
    ``fn`` must not copy from the host (pass its scalars as tensors on the
    card)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):       # warm-up off the capture
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (3 * iters)
    del graph
    return ms
