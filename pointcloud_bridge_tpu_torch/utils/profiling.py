"""Profiling and timing (counterpart of pointcloud_bridge_tpu/utils/
profiling.py:25-99).

- :func:`span`: a wall-clock context manager (train_MulSca_PN2.py:225-270).
- :func:`trace`: ``torch.profiler`` over the host and the card, written as a
  trace that TensorBoard's profiler plugin (or chrome://tracing) reads.
- :func:`device_time`: the device time a call, from ``iters`` calls captured
  in one CUDA graph and replayed between two CUDA events, so that no host
  launch cost or host round trip is in it. (The JAX package chains the calls
  in one ``fori_loop`` to get past its relay's round trip; that timing is
  not ported.) On the CPU, the host clock over ``iters`` calls.
- :func:`points_per_second`: the eva_model throughput metric.
- :func:`live_memory`: the caching allocator's byte counters of each card.
"""

from __future__ import annotations

import contextlib
import statistics
import time
from typing import Callable, Dict, Optional

import torch


@contextlib.contextmanager
def span(name: str, sink: Optional[Dict[str, float]] = None):
    """Seconds spent in the block, added to ``sink[name]``, or printed."""
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    if sink is not None:
        sink[name] = sink.get(name, 0.0) + dt
    else:
        print(f"[span] {name}: {dt*1e3:.2f} ms")


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` over the block (the host's and, where there is
    one, the card's activity), its trace written into ``log_dir`` when the
    block ends; yields the profiler, whose ``key_averages()`` hold the
    sums by op."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir),
    ) as prof:
        yield prof


def _device_of(args) -> torch.device:
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    return torch.device("cpu")


def device_time(fn: Callable, *args, iters: int = 10, reps: int = 5) -> float:
    """Median seconds a call of ``fn(*args)``.

    On a CUDA device (that of the first tensor among ``args``): one call to
    warm up on a side stream, then ``iters`` calls captured in one CUDA
    graph, the graph replayed ``reps`` times, each replay between two CUDA
    events; the median of each replay's time over ``iters``. ``fn`` must be
    capturable (no host synchronisation, no copy from the host), and a
    capture that fails raises. On the CPU: ``time.perf_counter`` around
    ``iters`` calls after one to warm up, the median over ``reps``."""
    if iters < 1 or reps < 1:
        raise ValueError(f"iters {iters} and reps {reps} must be positive")
    dev = _device_of(args)
    if dev.type != "cuda":
        fn(*args)
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            for _ in range(iters):
                fn(*args)
            times.append((time.perf_counter() - t0) / iters)
        return statistics.median(times)
    with torch.cuda.device(dev):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn(*args)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(iters):
                fn(*args)
        graph.replay()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3 / iters)
        return statistics.median(times)


def points_per_second(fn: Callable, xyz, *rest, iters: int = 10) -> float:
    """B * N points of xyz [B, N, ...] over :func:`device_time`."""
    dt = device_time(fn, xyz, *rest, iters=iters)
    b, n = xyz.shape[:2]
    return b * n / dt


def live_memory() -> Dict[str, Dict[str, float]]:
    """Per card, the caching allocator's byte counters
    (``torch.cuda.memory_stats``) in MiB; empty without a card."""
    if not torch.cuda.is_available():
        return {}
    return {f"cuda:{i}": {k: v / 2**20 for k, v in torch.cuda.memory_stats(i).items()
                          if "bytes" in k}
            for i in range(torch.cuda.device_count())}
