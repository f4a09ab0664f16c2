"""qmm_int8: y = x @ dequant(W)^T through Q8 activations, for a q4 weight or
an unwidened q6 weight (``widen_q6=False``), each with f32 scales and mins
(``scale_dtype='f32'``).

Kernel: ``csrc/qmm_int8.cu`` (replaces ``tpu_kquant/ops/pallas_qmm_int8.py:
qmm_int8``), decode rows only (R <= 32), kinds q4 and q6, as the
reference's. It quantizes the activations per weight group (32 for q4, 16
for q6; ops.act_quant), sums each group's products with the codes (4-bit,
or 6-bit from ``qs`` + ``qh``, 0..63) as exact int32 on int8 tensor cores,
rescales them by xs * s and subtracts the min term gsums @ mins in the same
pass (q6's -32 offset is in its mins). Its K split is
``ops.qmm.gemv_plan(..., int8=True)``, free of the row count like the
GEMV's, so a row's result does not depend on the batch.

``qmm_int8_plain`` is the same function in plain PyTorch: the group sums in
f32 (exact: |z| <= 32 * 127 * 15 and 16 * 127 * 63 < 2^24), then the f32
rescale.
"""

from __future__ import annotations

import ctypes

import torch

from tpu_kquant_torch.ops import _build
from tpu_kquant_torch.ops.act_quant import quantize_activations
from tpu_kquant_torch.ops.qmm import KIND_CODE, gemv_plan, kernel_kind, packed_arrays
from tpu_kquant_torch.quant.codecs import _unpack_codes_kmajor
from tpu_kquant_torch.quant.qtensor import QTensor
from tpu_kquant_torch.quant.repack import GROUP_SIZE

counter = _build.LaunchCounter("qmm_int8")

MAX_ROWS = 32
_P = ctypes.c_void_p
_I = ctypes.c_int
_QUANT_ARGTYPES = [_P, _I, _P, _P, _P, _I, _I, _I, _P]
#           kind xq  xs  gsums qs qh  scl mins out out_f32 ws R   N   K   cps splits stream
_ARGTYPES = [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _P]


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
    """y[..., N] = x[..., K] @ W^T for a kmajor q4 or q6 weight W (N, K) with
    f32 scales and mins, x of at most 32 rows."""
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        counter.plain_calls += 1
        return qmm_int8_plain(x, qt, out_dtype)
    code = kernel_kind(qt)
    if code not in (KIND_CODE[("q4", "f32")], KIND_CODE[("q6", "f32")]):
        raise NotImplementedError(
            f"the qmm_int8 kernel reads kmajor q4 and q6 weights with f32 scales and mins, not "
            f"{qt.kind} {qt.layout} with {sorted(qt.arrays)}")
    req = _build.require
    req(x.device.type == "cuda", f"qmm_int8: unsupported device {x.device}")
    _, (qs, qh, sc, mn) = packed_arrays(qt, "qmm_int8")
    N, K = (int(d) for d in qt.shape)
    req(x.shape[-1] == K, f"qmm_int8: x has {x.shape[-1]} features, W has K={K}")
    req(x.dtype in (torch.bfloat16, torch.float32), f"qmm_int8: x dtype {x.dtype}")
    req(out_dtype in (torch.bfloat16, torch.float32), f"qmm_int8: out dtype {out_dtype}")
    req(qs.device == x.device, "qmm_int8: weights must be on x's device")
    lead = x.shape[:-1]
    x2d = x.reshape(-1, K).contiguous()
    R = x2d.shape[0]
    req(R <= MAX_ROWS, f"qmm_int8: {R} rows (decode rows only, at most {MAX_ROWS})")
    out = torch.empty((R, N), dtype=out_dtype, device=x.device)
    if R == 0:
        return out.reshape(*lead, N)
    xq, xs, gsums = quantize_q8(x2d, GROUP_SIZE[qt.kind])
    cps, splits = gemv_plan(code, N, K, int8=True)
    ws = torch.empty(splits * R * N if splits > 1 else 0, dtype=torch.float32, device=x.device)
    lib = _build.load("qmm_int8", "tkq_qmm_int8", _ARGTYPES)
    P = _build.ptr
    rc = lib.tkq_qmm_int8(code, P(xq), P(xs), P(gsums), P(qs), None if qh is None else P(qh),
                          P(sc), P(mn), P(out), int(out_dtype == torch.float32), P(ws), R, N, K,
                          cps, splits, _build.stream_ptr(x.device))
    _build.check(lib, rc, "qmm_int8")
    counter.launches += 1
    return out.reshape(*lead, N)


def quantize_q8(x2d: torch.Tensor, group: int = 32
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's first launch on a contiguous CUDA x [R, K] (bf16 or f32):
    (xq int8 [R, K], scales f32 [R, K/group], gsums f32 [R, K/group]), as
    ``quantize_activations(x2d, group)`` computes them (group 32 or 16)."""
    R, K = x2d.shape
    _build.require(x2d.device.type == "cuda" and x2d.is_contiguous() and K % 32 == 0
                   and x2d.dtype in (torch.bfloat16, torch.float32) and group in (16, 32),
                   "quantize_q8: a contiguous bf16 or f32 CUDA tensor with K % 32 == 0, "
                   "group 16 or 32")
    xq = torch.empty((R, K), dtype=torch.int8, device=x2d.device)
    xs = torch.empty((R, K // group), dtype=torch.float32, device=x2d.device)
    gsums = torch.empty_like(xs)
    lib = _build.load("qmm_int8", "tkq_quantize_q8", _QUANT_ARGTYPES)
    P = _build.ptr
    rc = lib.tkq_quantize_q8(P(x2d), int(x2d.dtype == torch.float32), P(xq), P(xs), P(gsums),
                             R, K, group, _build.stream_ptr(x2d.device))
    _build.check(lib, rc, "qmm_int8 (quantize)")
    return xq, xs, gsums
