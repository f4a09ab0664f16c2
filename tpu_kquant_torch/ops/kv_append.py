"""One decode step's K/V rows into a layer of the bf16 KV cache, one launch.

Kernel: ``csrc/kv_append.cu`` (replaces ``tpu_kquant/ops/pallas_kv_append.py:
kv_append_pallas``). ``runtime.kv_cache.KVCache.append`` dispatches to it as
the reference does (``tpu_kquant/runtime/kv_cache.py:88-97``): with
``TKQ_KV_APPEND_PALLAS=1`` (default off, as in the reference), a bf16 cache,
one token per row (T = 1), B <= 32 and S % 16 == 0. The reference's gate
also requires a TPU backend; here a CUDA tensor takes the kernel and a CPU
tensor the plain version. The deferred append (``append_all``) never comes
here, as in the reference.

``kv_append_plain`` is the same write in plain PyTorch: two indexed writes.
"""

from __future__ import annotations

import ctypes
import os

import torch

from tpu_kquant_torch.ops import _build

counter = _build.LaunchCounter("kv_append")

_WIN = 16  # the reference's aligned slot window (pallas_kv_append.py:_WIN)
_P = ctypes.c_void_p
_L = ctypes.c_int64
_I = ctypes.c_int
#            k   v   scb sch kn  snb snh vn  svnb svnh start spos B   Hkv S   D   stream
_ARGTYPES = [_P, _P, _L, _L, _P, _L, _L, _P, _L, _L, _P, _L, _I, _I, _I, _I, _P]


def kv_append_supported(quantized: bool, T: int, B: int, S: int) -> bool:
    """The reference's shape gate (pallas_kv_append.py:kv_append_enabled,
    less its switch and backend test): a bf16 cache, T = 1, B <= 32 and
    S % 16 == 0."""
    return not quantized and T == 1 and B <= 32 and S % _WIN == 0


def kv_append_enabled(quantized: bool, T: int, B: int, S: int) -> bool:
    """The dispatch gate of KVCache.append: TKQ_KV_APPEND_PALLAS=1 (read at
    call time, default off) and kv_append_supported."""
    return (os.environ.get("TKQ_KV_APPEND_PALLAS", "0") == "1"
            and kv_append_supported(quantized, T, B, S))


def kv_append_plain(k_cache: torch.Tensor, v_cache: torch.Tensor, k_new: torch.Tensor,
                    v_new: torch.Tensor, layer_idx: int, start: torch.Tensor) -> None:
    """k_cache / v_cache [L, B, Hkv, S, D]; k_new / v_new [B, 1, Hkv, D];
    start [B]: writes row b into slot start[b] of layer ``layer_idx``, in
    place."""
    b = torch.arange(k_new.shape[0], device=start.device)
    start = start.long()
    k_cache[layer_idx, b, :, start] = k_new[:, 0].to(k_cache.dtype)
    v_cache[layer_idx, b, :, start] = v_new[:, 0].to(v_cache.dtype)


def kv_append(k_cache: torch.Tensor, v_cache: torch.Tensor, k_new: torch.Tensor,
              v_new: torch.Tensor, layer_idx: int, start: torch.Tensor) -> None:
    """kv_append_plain's write (in place). CPU tensors run the plain version;
    CUDA tensors launch the kernel or raise. ``start`` stays on the device:
    the host never reads it."""
    if k_cache.device.type == "cpu":
        counter.plain_calls += 1
        kv_append_plain(k_cache, v_cache, k_new, v_new, layer_idx, start)
        return
    L, B, Hkv, S, D = k_cache.shape
    req = _build.require
    req(k_cache.device.type == "cuda", f"kv_append: unsupported device {k_cache.device}")
    req(all(t.device == k_cache.device for t in (v_cache, k_new, v_new, start)),
        "kv_append: inputs on several devices")
    req(kv_append_supported(False, k_new.shape[1], B, S), "kv_append: unsupported shape")
    req(k_cache.dtype == v_cache.dtype == k_new.dtype == v_new.dtype == torch.bfloat16,
        "kv_append: the cache and the new rows must be bf16")
    req(v_cache.shape == k_cache.shape and k_new.shape == v_new.shape == (B, 1, Hkv, D),
        "kv_append: shapes")
    req(start.shape == (B,), "kv_append: start must be [B]")
    kc, vc = k_cache[layer_idx], v_cache[layer_idx]
    req(all(t.stride(3) == 1 and t.stride(2) == D for t in (kc, vc)),
        "kv_append: cache rows must be dense [.., S, D]")
    req(kc.stride()[:2] == vc.stride()[:2], "kv_append: k and v caches of different strides")
    req(k_new.stride(3) == 1 and v_new.stride(3) == 1, "kv_append: new rows must be dense along D")
    start = start.long()
    P = _build.ptr
    lib = _build.load("kv_append", "tkq_kv_append", _ARGTYPES)
    rc = lib.tkq_kv_append(P(kc), P(vc), kc.stride(0), kc.stride(1), P(k_new), k_new.stride(0),
                           k_new.stride(2), P(v_new), v_new.stride(0), v_new.stride(2), P(start),
                           start.stride(0), B, Hkv, S, D, _build.stream_ptr(k_cache.device))
    _build.check(lib, rc, "kv_append")
    counter.launches += 1
