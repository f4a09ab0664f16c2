"""Per-kernel attribution: marginal timing and a roofline row per kernel.

``time_chained`` is the marginal estimator: it times a chain of n and of 2n
applications of ``fn``, each taking the previous one's carry, and divides
the difference by n. On a card each chain is captured once as a CUDA graph
and replayed, timed with CUDA events; the difference cancels what every
replay pays once, the graph's launch and the first kernel's ramp on an idle
card, and what is left is the steady cost of one application on a busy
stream, ``fn``'s own ``dep`` op included. On the CPU the chains run eagerly
(the plain versions; a CPU time is no device number).

``kernel_report`` turns seconds and bytes into one row against the card's
spec-sheet peaks (``utils.roofline.CHIP_SPECS``).
"""

from __future__ import annotations

import itertools
import math
import time
from typing import Any, Callable

import torch

from tpu_kquant_torch.utils.roofline import DEFAULT_CHIP, chip_specs

L2_BYTES = 50e6  # H100's L2 cache


def dep(carry: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The next carry: ``carry`` plus 1e-30 times y's first element, in
    carry's dtype (one elementwise launch); makes each application wait
    for the previous one's output without changing the carry's values."""
    return torch.add(carry, y.reshape(-1)[0], alpha=1e-30)


def rotation(w0: Any, make: Callable[[], Any], one_bytes: int,
             l2_bytes: float = L2_BYTES) -> list:
    """w0 and enough copies from ``make()`` that together they exceed the
    L2 cache twice (at most 64), so a chain that cycles through them reads
    its operands from device memory, as a model's layer loop does."""
    n = min(64, max(1, math.ceil(2 * l2_bytes / max(1, one_bytes))))
    return [w0] + [make() for _ in range(n - 1)]


def cycle(items: list) -> Callable[[], Any]:
    """A function that returns the items in turn, forever."""
    it = itertools.cycle(items)
    return lambda: next(it)


def _run_chain(call, x, n: int):
    for _ in range(n):
        x = call(x)
    return x


def time_chained(fn: Callable, x0: torch.Tensor, n_iter: int, reps: int = 3,
                 aux: Any = ()) -> float:
    """Marginal seconds per application of ``fn`` (module docstring).

    fn is called as fn(x) when aux is the empty tuple, else as fn(x, aux);
    it returns the next carry (``dep`` folds an output in)."""
    return chain_times(fn, x0, n_iter, reps, aux)[0]


def chain_times(fn: Callable, x0: torch.Tensor, n_iter: int, reps: int = 3,
                aux: Any = ()) -> tuple[float, float]:
    """(``time_chained``'s marginal seconds, seconds per application of the
    n_iter chain as one graph replay; eager on the CPU), each the best of
    ``reps``. The second is what one replay of a short graph pays, its
    launch and the first kernel's ramp spread over n_iter."""
    no_aux = isinstance(aux, tuple) and not aux
    call = (lambda x: fn(x)) if no_aux else (lambda x: fn(x, aux))
    if x0.device.type != "cuda":
        _run_chain(call, x0, 1)
        t1s, t2s = [], []
        for _ in range(reps):
            for n, ts in ((n_iter, t1s), (2 * n_iter, t2s)):
                t0 = time.perf_counter()
                _run_chain(call, x0, n)
                ts.append(time.perf_counter() - t0)
        return max(min(t2s) - min(t1s), 1e-12) / n_iter, min(t1s) / n_iter

    x_in = x0.clone()
    cur = torch.cuda.current_stream(x0.device)
    side = torch.cuda.Stream(x0.device)
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        _run_chain(call, x_in, 2)  # builds and loads the kernels outside the capture
    cur.wait_stream(side)
    graphs = []
    for n in (n_iter, 2 * n_iter):
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            out = _run_chain(call, x_in, n)
        graphs.append((g, out))
    for g, _ in graphs:
        g.replay()
    torch.cuda.synchronize(x0.device)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    t1s, t2s = [], []
    for _ in range(reps):
        ev[0].record()
        graphs[0][0].replay()
        ev[1].record()
        graphs[1][0].replay()
        ev[2].record()
        ev[2].synchronize()
        t1s.append(ev[0].elapsed_time(ev[1]) * 1e-3)
        t2s.append(ev[1].elapsed_time(ev[2]) * 1e-3)
    del graphs
    return max(min(t2s) - min(t1s), 1e-12) / n_iter, min(t1s) / n_iter


def chain_length_for(nbytes: int, target_s: float = 0.03, chip: str = DEFAULT_CHIP) -> int:
    """Chain length whose marginal difference is about ``target_s`` of
    kernel time at the memory roofline, within [32, 2048]."""
    gbs = chip_specs(chip)[0]
    t_ideal = nbytes / (gbs * 1e9)
    return int(min(2048, max(32, target_s / max(t_ideal, 1e-12))))


def kernel_report(name: str, seconds: float, nbytes: int, flops: float = 0.0,
                  chip: str = DEFAULT_CHIP, log: Callable[..., Any] | None = None) -> dict:
    """One attribution row: achieved GB/s and the fractions of the chip's
    memory and bf16 tensor-core peaks (``mxu_frac``, the reference's key)."""
    gbs_peak, tflops = chip_specs(chip)
    gbs = nbytes / seconds / 1e9
    frac = gbs / gbs_peak
    mxu = flops / seconds / 1e12 / tflops if flops else 0.0
    if log is not None:
        log(f"{name:40s} {seconds * 1e6:9.2f} us  {nbytes / 1e6:8.2f} MB  "
            f"{gbs:8.1f} GB/s  {frac * 100:5.1f}% HBM  {mxu * 100:5.1f}% MXU")
    return {"kernel": name, "us": seconds * 1e6, "mb": nbytes / 1e6, "gbs": gbs,
            "hbm_frac": frac, "mxu_frac": mxu}
