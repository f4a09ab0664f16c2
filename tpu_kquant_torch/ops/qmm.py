"""qmm: y = x @ dequant(W)^T over packed q4 / q6w weights, with bf16 scale
pairs (q4-sm, q6w-sp: ``scale_dtype='bf16'``) or f32 scales (q4 ``scales`` +
``mins``, q6w ``scales``: ``scale_dtype='f32'``).

Kernel: ``csrc/qmm.cu`` (replaces ``tpu_kquant/ops/pallas_qmm.py:qmm_pallas``).
Rows <= 32 take its split-K GEMV (memory bound: every packed byte read
once); more rows take its tiled bf16 WMMA kernel (compute bound at prefill).
N must be a multiple of 4 (a MoE router has N = n_experts).

``qmm_plain`` is the same function in plain PyTorch: dequantize, then one
matmul in f32. Its compute dtype follows the activations, like the
reference's XLA path: bf16 activations meet bf16-rounded weights, f32
activations f32 weights. The kernel instead rounds f32 activations (qwen2's
prefill past the bias add) and the weights to bf16, as the reference's
kernel does for its MXU (``pallas_qmm.py:_qmm_kernel``). The plain version
does not follow it there, because it is the CPU path the tests hold against
the reference's XLA engine; the two differ by one bf16 rounding of each
factor (about 2^-8 of a term, summed with random signs), well inside the
2e-2 of max|ref| that the kernel is held to. ``qmm`` runs the plain version
only for CPU tensors; for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from tpu_kquant_torch.ops import _build
from tpu_kquant_torch.quant.codecs import dequant_kmajor
from tpu_kquant_torch.quant.qtensor import QTensor

counter = _build.LaunchCounter("qmm")

# (kind, the array that tells the layout) -> csrc/common.cuh's kind code
KIND_CODE = {("q4", "sm"): 0, ("q6w", "sp"): 1, ("q4", "mins"): 2, ("q6w", "scales"): 3}
GEMV_MAX_ROWS = 32
_TARGET_BLOCKS = 264  # two blocks per SM on a 132-SM H100
_SMEM_CAP = 200 * 1024
_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_I, _P, _I, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _P]


def qmm_plain(x: torch.Tensor, qt: QTensor, out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Plain version: dequantize W^T [K, N], multiply in f32."""
    out_dtype = out_dtype or x.dtype
    cdt = torch.float32 if x.dtype == torch.float32 else torch.bfloat16
    w = dequant_kmajor(qt, dtype=cdt).float()
    return (x.to(cdt).float() @ w).to(out_dtype)


def kernel_kind(qt: QTensor) -> int | None:
    """The kernel's kind code for ``qt``, or None if it reads another layout."""
    if qt.layout != "kmajor" or qt.fold != 1 or len(qt.shape) != 2:
        return None
    for (kind, scl), code in KIND_CODE.items():
        if qt.kind == kind and scl in qt.arrays:
            return code
    return None


def pick_rt(rows: int) -> int:
    """Rows per GEMV block (csrc/common.cuh pick_rt)."""
    return 1 if rows <= 1 else 2 if rows <= 2 else 4 if rows <= 4 else 8


def gemv_split(kind: int, N: int, K: int, rows: int,
               chunk_floats: int | None = None) -> tuple[int, int]:
    """(chunks per split, splits) of a GEMV's K range: enough blocks to cover
    the card, at least 8 chunks (one per warp) per split, and the block's
    shared memory (8 warps x 128 reduce floats, plus ``chunk_floats`` staged
    per chunk and row: by default qmm's activations, 64 floats for q4 and
    32 for q6w) within the cap."""
    q4 = kind in (0, 2)
    n_chunks = (K // 2 if q4 else K) // 32
    rt = pick_rt(rows)
    blocks = -(-N // 128) * -(-rows // rt)
    splits = max(1, min(-(-_TARGET_BLOCKS // blocks), n_chunks // 8))
    cps = -(-n_chunks // splits)
    span = chunk_floats or (2 if q4 else 1) * 32
    while cps > 1 and 4 * rt * (cps * span + 8 * 128) > _SMEM_CAP:
        splits += 1
        cps = -(-n_chunks // splits)
    return cps, -(-n_chunks // cps)


def qmm(x: torch.Tensor, qt: QTensor, out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """y[..., N] = x[..., K] @ W^T for a kmajor weight W (N, K)."""
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        counter.plain_calls += 1
        return qmm_plain(x, qt, out_dtype)
    kind = kernel_kind(qt)
    if kind is None:
        raise NotImplementedError(
            f"the qmm kernel reads kmajor q4 and q6w weights (bf16 pairs or f32 scales), not "
            f"{qt.kind} {qt.layout} with {sorted(qt.arrays)}")
    N, K = qt.shape
    q4 = kind in (0, 2)
    req = _build.require
    req(x.device.type == "cuda", f"qmm: unsupported device {x.device}")
    req(x.shape[-1] == K, f"qmm: x has {x.shape[-1]} features, W has K={K}")
    req(x.dtype in (torch.bfloat16, torch.float32), f"qmm: x dtype {x.dtype}")
    req(out_dtype in (torch.bfloat16, torch.float32), f"qmm: out dtype {out_dtype}")
    req(K % (64 if q4 else 32) == 0 and N % 4 == 0, f"qmm: shape (N={N}, K={K})")
    qs = qt.arrays["qs"]
    scl = qt.arrays[("sm", "sp", "scales", "scales")[kind]]
    side = [scl] + ([qt.arrays["mins"]] if kind == 2 else [])
    req(qs.dtype == (torch.uint8 if q4 else torch.int8)
        and all(a.dtype == torch.float32 for a in side), "qmm: packed array dtypes")
    groups = K // 16 if kind == 3 else K // 32
    req(qs.shape == ((K // 2 if q4 else K), N) and all(a.shape == (groups, N) for a in side),
        "qmm: packed array shapes")
    req(all(a.device == x.device and a.is_contiguous() for a in [qs] + side),
        "qmm: packed arrays must be contiguous on x's device")
    lead = x.shape[:-1]
    x2d = x.reshape(-1, K).contiguous()
    R = x2d.shape[0]
    out = torch.empty((R, N), dtype=out_dtype, device=x.device)
    if R == 0:
        return out.reshape(*lead, N)
    cps, splits = gemv_split(kind, N, K, R) if R <= GEMV_MAX_ROWS else (0, 1)
    ws = torch.empty(splits * R * N if splits > 1 else 0, dtype=torch.float32, device=x.device)
    lib = _build.load("qmm", "tkq_qmm", _ARGTYPES)
    P = _build.ptr
    mins = P(side[1]) if kind == 2 else None
    rc = lib.tkq_qmm(kind, P(x2d), int(x2d.dtype == torch.float32), P(qs), P(scl), mins,
                     P(out), int(out_dtype == torch.float32), P(ws), R, N, K, cps, splits,
                     _build.stream_ptr(x.device))
    _build.check(lib, rc, "qmm")
    counter.launches += 1
    return out.reshape(*lead, N)
