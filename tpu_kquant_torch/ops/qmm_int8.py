"""qmm_int8: y = x @ dequant(W)^T through Q8 activations, for a q4 weight
with f32 scales and mins (``scale_dtype='f32'``).

Kernel: ``csrc/qmm_int8.cu`` (replaces ``tpu_kquant/ops/pallas_qmm_int8.py:
qmm_int8``), decode rows only (R <= 32), kind q4. It quantizes the
activations per 32-group (ops.act_quant), sums each group's products with
the 4-bit codes as exact int32, rescales them by xs * s and subtracts the
min term gsums @ mins in the same pass.

``qmm_int8_plain`` is the same function in plain PyTorch: the group sums in
f32 (exact: |z| <= 32 * 127 * 15 < 2^24), then the f32 rescale. The kmajor
q6 layout (``qs`` + ``qh``) that the reference kernel also takes never
reaches this port's int8 path (the loader widens Q6_K to q6w), so the
plain version reads it and the kernel raises for it.
"""

from __future__ import annotations

import ctypes

import torch

from tpu_kquant_torch.ops import _build
from tpu_kquant_torch.ops.act_quant import quantize_activations
from tpu_kquant_torch.ops.qmm import gemv_split
from tpu_kquant_torch.quant.codecs import _unpack_codes_kmajor
from tpu_kquant_torch.quant.qtensor import QTensor
from tpu_kquant_torch.quant.repack import GROUP_SIZE

counter = _build.LaunchCounter("qmm_int8")

MAX_ROWS = 32
# shared-memory floats the kernel stages per chunk and row (csrc/qmm_int8.cu
# int8_smem_floats): xs and gsums of both folds (4), and 2 x 32 xq bytes (16)
CHUNK_FLOATS = 20
_P = ctypes.c_void_p
_I = ctypes.c_int
_QUANT_ARGTYPES = [_P, _I, _P, _P, _P, _I, _I, _P]
_ARGTYPES = [_P, _P, _P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _P]


def qmm_int8_plain(x: torch.Tensor, qt: QTensor, out_dtype: torch.dtype | None = None
                   ) -> torch.Tensor:
    """Plain version for kmajor q4 / q6 weights with f32 ``scales``/``mins``."""
    out_dtype = out_dtype or x.dtype
    g = GROUP_SIZE[qt.kind]
    K = x.shape[-1]
    N = int(qt.shape[0])
    xq, xs, gsums = quantize_activations(x.reshape(-1, K), g)  # [R, K], [R, G]
    R, G = xq.shape[0], K // g
    codes = _unpack_codes_kmajor(qt.arrays, qt.kind).float().reshape(G, g, N)
    z = torch.bmm(xq.float().reshape(R, G, g).transpose(0, 1), codes)  # [G, R, N]
    y = (z * (xs.T[:, :, None] * qt.arrays["scales"].float()[:, None, :])).sum(0)
    if "mins" in qt.arrays:
        y = y - gsums @ qt.arrays["mins"].float()
    return y.reshape(*x.shape[:-1], N).to(out_dtype)


def qmm_int8(x: torch.Tensor, qt: QTensor, out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """y[..., N] = x[..., K] @ W^T for a kmajor q4 weight W (N, K) with f32
    scales and mins, x of at most 32 rows."""
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        counter.plain_calls += 1
        return qmm_int8_plain(x, qt, out_dtype)
    if qt.kind != "q4" or qt.layout != "kmajor" or "mins" not in qt.arrays:
        raise NotImplementedError(
            f"the qmm_int8 kernel reads kmajor q4 weights with f32 scales and mins, not "
            f"{qt.kind} {qt.layout} with {sorted(qt.arrays)} (the q6 qs + qh layout is not "
            f"ported)")
    N, K = (int(d) for d in qt.shape)
    req = _build.require
    req(x.device.type == "cuda", f"qmm_int8: unsupported device {x.device}")
    req(x.shape[-1] == K, f"qmm_int8: x has {x.shape[-1]} features, W has K={K}")
    req(x.dtype in (torch.bfloat16, torch.float32), f"qmm_int8: x dtype {x.dtype}")
    req(out_dtype in (torch.bfloat16, torch.float32), f"qmm_int8: out dtype {out_dtype}")
    req(K % 64 == 0 and N % 4 == 0, f"qmm_int8: shape (N={N}, K={K})")
    qs, sc, mn = qt.arrays["qs"], qt.arrays["scales"], qt.arrays["mins"]
    req(qs.dtype == torch.uint8 and sc.dtype == mn.dtype == torch.float32,
        "qmm_int8: packed array dtypes")
    req(qs.shape == (K // 2, N) and sc.shape == mn.shape == (K // 32, N),
        "qmm_int8: packed array shapes")
    req(all(a.device == x.device and a.is_contiguous() for a in (qs, sc, mn)),
        "qmm_int8: weights must be contiguous on x's device")
    lead = x.shape[:-1]
    x2d = x.reshape(-1, K).contiguous()
    R = x2d.shape[0]
    req(R <= MAX_ROWS, f"qmm_int8: {R} rows (decode rows only, at most {MAX_ROWS})")
    out = torch.empty((R, N), dtype=out_dtype, device=x.device)
    if R == 0:
        return out.reshape(*lead, N)
    xq, xs, gsums = quantize_q8(x2d)
    cps, splits = gemv_split(0, N, K, R, CHUNK_FLOATS)
    ws = torch.empty(splits * R * N if splits > 1 else 0, dtype=torch.float32, device=x.device)
    lib = _build.load("qmm_int8", "tkq_qmm_int8", _ARGTYPES)
    P = _build.ptr
    rc = lib.tkq_qmm_int8(P(xq), P(xs), P(gsums), P(qs), P(sc), P(mn), P(out),
                          int(out_dtype == torch.float32), P(ws), R, N, K, cps, splits,
                          _build.stream_ptr(x.device))
    _build.check(lib, rc, "qmm_int8")
    counter.launches += 1
    return out.reshape(*lead, N)


def quantize_q8(x2d: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's first launch on a contiguous CUDA x [R, K] (bf16 or f32):
    (xq int8 [R, K], scales f32 [R, K/32], gsums f32 [R, K/32]), as
    ``quantize_activations`` computes them."""
    R, K = x2d.shape
    _build.require(x2d.device.type == "cuda" and x2d.is_contiguous() and K % 32 == 0
                   and x2d.dtype in (torch.bfloat16, torch.float32),
                   "quantize_q8: a contiguous bf16 or f32 CUDA tensor with K % 32 == 0")
    xq = torch.empty((R, K), dtype=torch.int8, device=x2d.device)
    xs = torch.empty((R, K // 32), dtype=torch.float32, device=x2d.device)
    gsums = torch.empty_like(xs)
    lib = _build.load("qmm_int8", "tkq_quantize_q8", _QUANT_ARGTYPES)
    P = _build.ptr
    rc = lib.tkq_quantize_q8(P(x2d), int(x2d.dtype == torch.float32), P(xq), P(xs), P(gsums),
                             R, K, _build.stream_ptr(x2d.device))
    _build.check(lib, rc, "qmm_int8 (quantize)")
    return xq, xs, gsums
