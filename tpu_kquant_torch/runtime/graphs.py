"""One step captured as a CUDA graph and replayed: the port's counterpart of
the reference's one-dispatch loops (``tpu_kquant/runtime/engine.py``
``_decode_loop`` / ``_decode_loop_sampled``, ``tpu_kquant/serving/
scheduler.py`` ``_tick_fn`` / ``_tick_n_fn``), which runtime.engine's decode
loops and serving.scheduler's tick and chunk run on the card.

A ``StepGraph`` holds one step: a function over tensors whose addresses do
not change from one call to the next (the static inputs it reads, the cache
and state it writes in place, the static outputs it writes). Its first run
on a CUDA device runs the step once eagerly on a side stream (the warm run:
the kernel libraries load, cuBLAS makes its handles, and nothing made once
and kept is first made inside a capture), then captures it into a CUDA
graph without running it; every later run replays the graph, one launch
from the host for the whole step. Both the warm run and the capture run
under ``torch.cuda.set_sync_debug_mode("error")``: a step that reads the
device on the host raises. On the CPU each run calls the step
itself: the replay's plain version. A capture that fails raises; nothing
falls back to the eager step.

Launch accounting: the kernel wrappers count their calls
(``ops._build.LaunchCounter``). A capture calls them without launching, so
the capture's counts are taken back and kept as the graph's deltas, and each
replay adds them: the counts mean launches, as without graphs. ``STATS``
counts captures and replays (in all, by the step's sequence number, and the
launches the replays added) and keeps each capture's wall ms and the bytes
of its private memory pool.

A graph bakes in the addresses of what it touches and the path the forward
took, so its owner keys it (``GraphCache``) on the batch, the cache's
tensors (``tensor_key``), the sampler configuration and ``switches()``: the
value of every switch the forward reads at call time and the attention
budget. A ``GraphCache`` holds a few graphs (each a private pool of device
memory), drops the least recently used past ``maxsize``, and drops a graph
as soon as one of the tensors it was keyed on is gone.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import os
import time
import weakref
from collections import OrderedDict
from typing import Any, Callable

import torch

from tpu_kquant_torch.ops import _build, attention

# the switches the forward reads from the environment at call time
# (models/llama.py, the gates of ops/{attn_in,ffn,attn_out,layer,rot,kv_append}.py,
# and ops/dequant.py's int8 folds and the TPU's choice of manual variants)
SWITCHES = ("TKQ_DEFER_APPEND", "TKQ_FUSE_LAYER", "TKQ_FUSE_ATTN", "TKQ_FUSE_OPROJ",
            "TKQ_FUSE_FFN", "TKQ_FUSE_ATTN_OUT", "TKQ_ROTATE_LAYER", "TKQ_KV_APPEND_PALLAS",
            "TKQ_INT8_FOLDS", "TKQ_Q4_MXU_MINS", "TKQ_GROUP_SCALE", "TKQ_MANUAL_ATTN_IN",
            "TKQ_MANUAL_OPROJ")


def switches() -> tuple:
    """The forward's dispatch settings as they stand: every switch it reads
    at call time, and ops.attention.ATTN_PLAIN_MAX_MB (read from the
    environment at import, then changed by assignment: tests and the smoke
    lower it)."""
    return tuple(os.environ.get(k) for k in SWITCHES) + (attention.ATTN_PLAIN_MAX_MB,)


def cache_tensors(cache) -> list[torch.Tensor]:
    """Every tensor of a cache (KVCache, ISWACache, RecurrentCache): the
    dataclass's tensor fields, and those of its dataclass fields."""
    out = []
    for f in dataclasses.fields(cache):
        v = getattr(cache, f.name)
        if torch.is_tensor(v):
            out.append(v)
        elif dataclasses.is_dataclass(v):
            out += cache_tensors(v)
    return out


def tensor_key(tensors) -> tuple:
    """What a graph bakes in of each tensor: address, shape, strides, dtype."""
    return tuple((t.data_ptr(), tuple(t.shape), t.stride(), t.dtype) for t in tensors)


@dataclasses.dataclass
class GraphStats:
    captures: int = 0
    replays: int = 0
    by_step: dict = dataclasses.field(default_factory=dict)  # step seq -> replays
    replayed_launches: dict = dataclasses.field(default_factory=dict)  # kernel -> launches
    capture_ms: list = dataclasses.field(default_factory=list)
    pool_bytes: list = dataclasses.field(default_factory=list)


STATS = GraphStats()
_SEQ = itertools.count()
_capturing: int | None = None


def capturing() -> int | None:
    """The sequence number of the step being captured now, else None."""
    return _capturing


class StepGraph:
    """One step, captured on its first CUDA run and replayed after (module
    docstring). ``seq`` numbers it in ``STATS.by_step``."""

    def __init__(self, device: torch.device | str):
        self.device = torch.device(device)
        self.seq = next(_SEQ)
        self.graph: torch.cuda.CUDAGraph | None = None
        self.outputs: Any = None
        self.deltas: dict[str, int] = {}
        self.capture_ms = 0.0
        self.pool_bytes = 0

    def run(self, step: Callable, *args):
        """Run the step once: ``step(*args)`` on the CPU; on CUDA the warm
        run and the capture the first time, a replay after. The caller
        passes the same tensors every time (its key). Returns the step's
        outputs: after a replay the graph's own output tensors, which the
        next replay overwrites."""
        if self.device.type != "cuda":
            return step(*args)
        if self.graph is None:
            return self._capture(step, args)
        self.graph.replay()
        _build.add_launches(self.deltas)
        STATS.replays += 1
        STATS.by_step[self.seq] = STATS.by_step.get(self.seq, 0) + 1
        for k, d in self.deltas.items():
            STATS.replayed_launches[k] = STATS.replayed_launches.get(k, 0) + d
        return self.outputs

    def _capture(self, step: Callable, args: tuple):
        global _capturing
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side), _no_host_sync():
            out = step(*args)  # the warm run: this run's step
        cur.wait_stream(side)
        for t in _tensors(out):  # made on the side stream, read on this one
            t.record_stream(cur)
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        before = _build.launch_counts()
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        _capturing = self.seq
        try:
            with torch.cuda.device(self.device), torch.cuda.graph(graph), _no_host_sync():
                captured = step(*args)
        finally:
            _capturing = None
            self.deltas = _build.take_back(before)
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        self.graph, self.outputs = graph, captured
        STATS.captures += 1
        STATS.capture_ms.append(self.capture_ms)
        STATS.pool_bytes.append(self.pool_bytes)
        return out


@contextlib.contextmanager
def _no_host_sync():
    """torch.cuda.set_sync_debug_mode("error") for the step's warm run and
    its capture: a step that reads a device value on the host (.item(),
    .cpu(), nonzero, ...) raises there, not at some later replay."""
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(mode)


def _tensors(out) -> list[torch.Tensor]:
    if torch.is_tensor(out):
        return [out]
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _tensors(o)]
    return []


class GraphCache:
    """A few captured steps by key (module docstring): the least recently
    used goes past ``maxsize``, and a step keyed on tensors goes when one of
    them does."""

    def __init__(self, maxsize: int = 4):
        self.maxsize = maxsize
        self._items: OrderedDict = OrderedDict()  # key -> (value, finalizers)

    def __len__(self) -> int:
        return len(self._items)

    def get(self, key, make: Callable, tensors=()):
        """The value under ``key``, made by ``make()`` (and tied to the life
        of ``tensors``) if there is none."""
        hit = self._items.get(key)
        if hit is not None:
            self._items.move_to_end(key)
            return hit[0]
        value = make()
        ref = weakref.ref(self)
        self._items[key] = (value, [weakref.finalize(t, GraphCache._drop, ref, key)
                                    for t in tensors])
        while len(self._items) > self.maxsize:
            self._pop(next(iter(self._items)))
        return value

    def _pop(self, key) -> None:
        _value, finalizers = self._items.pop(key)
        for f in finalizers:
            f.detach()

    @staticmethod
    def _drop(ref, key) -> None:
        self = ref()
        if self is not None and key in self._items:
            self._pop(key)
