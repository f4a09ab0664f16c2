"""Profiling: device synchronisation, wall timing and torch.profiler traces.

PyTorch returns from a CUDA call before the card has finished it, so a host
clock measures the card's work only after ``device_sync``.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path

import torch


def _first_tensor(x):
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        for v in x:
            t = _first_tensor(v)
            if t is not None:
                return t
    return None


def device_sync(x=None) -> None:
    """Wait until the card has finished all queued work: a
    ``torch.cuda.synchronize`` of the device of ``x``'s first tensor (or of
    the current device when ``x`` holds none on a card); nothing on the CPU,
    where every op has returned complete."""
    t = _first_tensor(x)
    if t is not None:
        if t.device.type == "cuda":
            torch.cuda.synchronize(t.device)
    elif torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def timed(fn, *args, warmup: int = 1, reps: int = 3, **kw):
    """Run fn reps times after ``warmup`` runs; returns (best wall seconds,
    last result), each run ended by ``device_sync`` of its result."""
    out = None
    for _ in range(warmup):
        out = fn(*args, **kw)
        device_sync(out)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        device_sync(out)
        best = min(best, time.perf_counter() - t0)
    return best, out


@contextlib.contextmanager
def trace(logdir: str | Path, name: str = "trace"):
    """torch.profiler over the block (CPU activity, and CUDA activity where
    a card is present); writes ``<logdir>/<name>.json``, a Chrome trace
    (chrome://tracing or Perfetto), and yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    logdir = Path(logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
        device_sync()
    prof.export_chrome_trace(str(logdir / f"{name}.json"))
