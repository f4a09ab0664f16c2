"""Float -> GGML block bytes on the card: Q4_K, Q6_K and Q8_0.

Kernels: ``csrc/quantize.cu`` (``tkq_quantize_q4k``, ``_q6k``, ``_q80``).
They replace no TPU kernel: they are the port's counterpart of the
reference's native quantizers (``csrc/tkq.cpp:364``, ``:419``, ``:477``,
reached through ``tpu_kquant/quant/native.py:quantize_native``), and give
the bytes of its NumPy quantizers (``quant/numpy_codecs.py``: ``_q_q4_k``,
``_q_q6_k``, ``_q_q8_0``) bit for bit.

``quantize_q4k_plain``, ``quantize_q6k_plain`` and ``quantize_q80_plain``
are the same functions in plain PyTorch: f32 elementwise, f64 sums written
out in NumPy's pairwise order (``_psum``), every division between two
tensors (PyTorch's CUDA division by a Python scalar multiplies by the
reciprocal). They run on either device and give the same bytes. The
wrappers run them on CPU tensors and launch the kernels on CUDA tensors, or
raise.
"""

from __future__ import annotations

import ctypes

import torch

from tpu_kquant_torch.gguf.constants import GGMLType
from tpu_kquant_torch.ops import _build

counters = {
    GGMLType.Q4_K: _build.LaunchCounter("quantize_q4k"),
    GGMLType.Q6_K: _build.LaunchCounter("quantize_q6k"),
    GGMLType.Q8_0: _build.LaunchCounter("quantize_q80"),
}
# (elements a block, bytes a block, C entry point)
_BLOCK = {GGMLType.Q4_K: (256, 144, "tkq_quantize_q4k"),
          GGMLType.Q6_K: (256, 210, "tkq_quantize_q6k"),
          GGMLType.Q8_0: (32, 34, "tkq_quantize_q80")}
_P = ctypes.c_void_p
_ARGTYPES = [_P, _P, ctypes.c_int64, _P]  # x, out, blocks, stream

# Operations an element, counted from csrc/quantize.cu (a multiply, add,
# compare, conversion or rounding each one; a sum one add an element):
# (f64, f32). Q4_K: 22 candidate fits of 13 f64 (conversion, wl, wl*l,
# wl*xd, ts*l, +tm, -xd, square, *wd, four sums' adds) and 4 f32 (scale,
# round, clamp twice), plus the weights, the first fit and the codes. Q6_K:
# 19 candidates of 6 f64 (conversion, two products, wl*l, two sums' adds)
# and 4 f32, plus w, w*x, the argmax and the codes. Q8_0: abs, max, divide,
# round, clamp twice.
OPS_PER_ELEMENT = {GGMLType.Q4_K: (22 * 13 + 6, 22 * 4 + 12),
                   GGMLType.Q6_K: (19 * 6 + 2, 19 * 4 + 6),
                   GGMLType.Q8_0: (0, 6)}


def work(t: GGMLType, n: int) -> tuple[int, int, int]:
    """(bytes, f64 operations, f32 operations) of quantizing ``n`` values
    to ``t``: each input read once, each output byte written once."""
    bs, nbytes, _ = _BLOCK[GGMLType(t)]
    f64, f32 = OPS_PER_ELEMENT[GGMLType(t)]
    return 4 * n + n // bs * nbytes, f64 * n, f32 * n


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _div(a, b):
    """a / b as IEEE division of two tensors (either may be a number)."""
    ref = b if torch.is_tensor(b) else a
    if not torch.is_tensor(a):
        a = torch.full_like(ref, a)
    if not torch.is_tensor(b):
        b = torch.full_like(ref, b)
    return a / b


def _psum(v: torch.Tensor) -> torch.Tensor:
    """Row sums of v [G, n] (n = 16 or 32) in NumPy's pairwise order, plus
    0.0 (NumPy's reduction adds the sum to an initial 0.0)."""
    r = v[:, 0:8]
    for i in range(8, v.shape[1], 8):
        r = r + v[:, i:i + 8]
    s = ((r[:, 0] + r[:, 1]) + (r[:, 2] + r[:, 3])) + ((r[:, 4] + r[:, 5]) + (r[:, 6] + r[:, 7]))
    return torch.zeros_like(s) + s


def _f16_round(v: torch.Tensor) -> torch.Tensor:
    """f64 -> f32 -> f16 -> f32, two roundings as NumPy's."""
    return v.to(torch.float32).to(torch.float16).to(torch.float32)


def _f16_bytes(v: torch.Tensor) -> torch.Tensor:
    """f32 [nb] -> little-endian fp16 bytes [nb, 2]."""
    return v.to(torch.float16).contiguous().view(torch.uint8).reshape(-1, 2)


def _qkx2_q4k(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """numpy_codecs._make_qkx2_quants(x, 15, av_x + |x|, -1.0, 0.1, 20,
    False) over groups x [G, 32] f32: (scale, the_min), both [G] f64."""
    xd = x.double()
    av_x = torch.sqrt(_div(_psum(xd * xd), 32.0)).float()
    wd = (av_x[:, None] + x.abs()).double()
    sum_w = _psum(wd)
    sum_x = _psum(wd * xd)
    xmin = x.amin(1)
    mn = torch.where(xmin < 0, xmin, torch.zeros_like(xmin))
    mx = x.amax(1)
    degen = mx == mn
    span = torch.where(degen, torch.ones_like(mx), mx - mn)
    xm = x - mn[:, None]
    isc0 = _div(15.0, span)
    scale = _div(1.0, isc0).double()
    minv = mn.double()
    lv = (isc0[:, None] * xm).round().clamp(0, 15).double()
    diff = scale[:, None] * lv + minv[:, None] - xd
    best_mad = _psum(wd * (diff * diff))
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    for step in range(21):
        num = (f32(-1.0) + f32(0.1) * f32(float(step)) + f32(15.0)).to(x.device)
        isc = _div(num.expand_as(span), span)
        lv = (isc[:, None] * xm).round().clamp(0, 15).double()
        wl = wd * lv
        sum_l = _psum(wl)
        sum_l2 = _psum(wl * lv)
        sum_xl = _psum(wl * xd)
        D = sum_w * sum_l2 - sum_l * sum_l
        ok = D > 0
        Ds = torch.where(ok, D, torch.ones_like(D))
        ts = _div(sum_w * sum_xl - sum_x * sum_l, Ds)
        tm = _div(sum_l2 * sum_x - sum_l * sum_xl, Ds)
        pos = tm > 0
        ts = torch.where(pos, _div(sum_xl, torch.where(sum_l2 > 0, sum_l2,
                                                       torch.ones_like(sum_l2))), ts)
        tm = torch.where(pos, torch.zeros_like(tm), tm)
        diff = ts[:, None] * lv + tm[:, None] - xd
        mad = _psum(wd * (diff * diff))
        upd = ok & (mad < best_mad)
        scale = torch.where(upd, ts, scale)
        minv = torch.where(upd, tm, minv)
        best_mad = torch.where(upd, mad, best_mad)
    scale = torch.where(degen, torch.zeros_like(scale), scale)
    minv = torch.where(degen, mn.double(), minv)
    return scale, -minv


def quantize_q4k_plain(x: torch.Tensor) -> torch.Tensor:
    """f32 values (n % 256 == 0) -> Q4_K bytes [n / 256 * 144] (uint8), on
    x's device: numpy_codecs._q_q4_k's arithmetic."""
    xg = x.reshape(-1, 8, 32).float()
    nb = xg.shape[0]
    scales, mins = _qkx2_q4k(xg.reshape(-1, 32))
    scales, mins = scales.reshape(nb, 8), mins.reshape(nb, 8)
    zero = torch.zeros(nb, dtype=torch.float64, device=x.device)
    max_scale = scales.amax(1)
    max_scale = torch.where(max_scale > 0, max_scale, zero)
    max_min = mins.amax(1)
    max_min = torch.where(max_min > 0, max_min, zero)
    one = torch.ones_like(zero)
    inv_scale = torch.where(max_scale > 0, _div(63.0, torch.where(max_scale > 0, max_scale, one)),
                            zero)
    inv_min = torch.where(max_min > 0, _div(63.0, torch.where(max_min > 0, max_min, one)), zero)
    sc = (inv_scale[:, None] * scales).round().clamp(0, 63).to(torch.uint8)
    m = (inv_min[:, None] * mins).round().clamp(0, 63).to(torch.uint8)
    d = _f16_round(_div(max_scale, 63.0))
    dmin = _f16_round(_div(max_min, 63.0))
    se = d[:, None] * sc.float()
    me = dmin[:, None] * m.float()
    pos = se > 0
    q = torch.where(pos[:, :, None],
                    _div(xg + me[:, :, None], torch.where(pos, se, torch.ones_like(se))[:, :, None])
                    .round().clamp(0, 15), torch.zeros_like(xg)).to(torch.uint8)
    q = q.reshape(nb, 4, 2, 32)
    out = torch.empty(nb, 144, dtype=torch.uint8, device=x.device)
    out[:, 0:2] = _f16_bytes(d)
    out[:, 2:4] = _f16_bytes(dmin)
    out[:, 4:8] = (sc[:, :4] & 63) | ((sc[:, 4:] >> 4) << 6)
    out[:, 8:12] = (m[:, :4] & 63) | ((m[:, 4:] >> 4) << 6)
    out[:, 12:16] = (sc[:, 4:] & 0xF) | ((m[:, 4:] & 0xF) << 4)
    out[:, 16:144] = (q[:, :, 0, :] | (q[:, :, 1, :] << 4)).reshape(nb, 128)
    return out.reshape(-1)


def _qx_q6k(x: torch.Tensor) -> torch.Tensor:
    """numpy_codecs._make_qx_quants(x, 32) over groups x [G, 16] f32: the
    signed scale [G] f64."""
    xd = x.double()
    w = xd * xd
    wx = w * xd
    idx = x.abs().argmax(1)
    maxv = x.gather(1, idx[:, None])[:, 0]
    dead = maxv.abs() < 1e-15
    safe = torch.where(dead, torch.ones_like(maxv), maxv)

    def cand(step: int):
        num = -(torch.tensor(32.0, dtype=torch.float32)
                + torch.tensor(0.1, dtype=torch.float32) * torch.tensor(float(step)))
        isc = _div(num.to(x.device).expand_as(safe), safe)
        lv = (isc[:, None] * x).round().clamp(-32, 31).double()
        return _psum(wx * lv), _psum((w * lv) * lv)

    sumlx, suml2 = cand(0)
    one, zero = torch.ones_like(suml2), torch.zeros_like(suml2)
    scale = torch.where(suml2 > 0, _div(sumlx, torch.where(suml2 > 0, suml2, one)), zero)
    best = scale * sumlx
    for step in (*range(-9, 0), *range(1, 10)):
        slx, sl2 = cand(step)
        better = (sl2 > 0) & (slx * slx > best * sl2)
        scale = torch.where(better, _div(slx, torch.where(sl2 > 0, sl2, one)), scale)
        best = torch.where(better, scale * slx, best)
    return torch.where(dead, zero, scale)


def quantize_q6k_plain(x: torch.Tensor) -> torch.Tensor:
    """f32 values (n % 256 == 0) -> Q6_K bytes [n / 256 * 210] (uint8), on
    x's device: numpy_codecs._q_q6_k's arithmetic."""
    xg = x.reshape(-1, 16, 16).float()
    nb = xg.shape[0]
    scales = _qx_q6k(xg.reshape(-1, 16)).reshape(nb, 16)
    max_scale = scales.gather(1, scales.abs().argmax(1)[:, None])[:, 0]
    dead = max_scale.abs() < 1e-15
    iscale = _div(-128.0, torch.where(dead, torch.ones_like(max_scale), max_scale))
    d = _f16_round(_div(1.0, iscale))
    d = torch.where(dead, torch.zeros_like(d), d)
    sc = (iscale[:, None] * scales).round().clamp(max=127).clamp(-128, 127).to(torch.int8)
    sc = torch.where(dead[:, None], torch.zeros_like(sc), sc)
    eff = d[:, None] * sc.float()
    nz = eff != 0
    q = torch.where(nz[:, :, None],
                    _div(xg, torch.where(nz, eff, torch.ones_like(eff))[:, :, None])
                    .round().clamp(-32, 31), torch.zeros_like(xg))
    q = (q.reshape(nb, 256).to(torch.int16) + 32).to(torch.uint8)
    q = torch.where(dead[:, None], torch.zeros_like(q), q)  # dead block: all-zero bytes
    out = torch.empty(nb, 210, dtype=torch.uint8, device=x.device)
    for n in range(2):  # csrc/tkq.cpp's packing, half n
        y = q[:, 128 * n:128 * n + 128]
        a, b, c, e = y[:, 0:32], y[:, 32:64], y[:, 64:96], y[:, 96:128]
        out[:, 64 * n:64 * n + 32] = (a & 0xF) | ((c & 0xF) << 4)
        out[:, 64 * n + 32:64 * n + 64] = (b & 0xF) | ((e & 0xF) << 4)
        out[:, 128 + 32 * n:160 + 32 * n] = ((a >> 4) | ((b >> 4) << 2) | ((c >> 4) << 4)
                                             | ((e >> 4) << 6))
    out[:, 192:208] = sc.view(torch.uint8)
    out[:, 208:210] = _f16_bytes(d)
    return out.reshape(-1)


def quantize_q80_plain(x: torch.Tensor) -> torch.Tensor:
    """f32 values (n % 32 == 0) -> Q8_0 bytes [n / 32 * 34] (uint8), on x's
    device: numpy_codecs._q_q8_0's arithmetic (round half to even)."""
    xb = x.reshape(-1, 32).float()
    d = _div(xb.abs().amax(1), 127.0)
    nz = d != 0
    q = torch.where(nz[:, None], _div(xb, torch.where(nz, d, torch.ones_like(d))[:, None])
                    .round().clamp(-127, 127), torch.zeros_like(xb)).to(torch.int8)
    return torch.cat([_f16_bytes(d), q.view(torch.uint8)], 1).reshape(-1)


PLAIN = {GGMLType.Q4_K: quantize_q4k_plain, GGMLType.Q6_K: quantize_q6k_plain,
         GGMLType.Q8_0: quantize_q80_plain}


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _quantize(t: GGMLType, x: torch.Tensor) -> torch.Tensor:
    bs, nbytes, fn = _BLOCK[t]
    what = f"quantize {t.name}"
    n = x.numel()
    _build.require(n % bs == 0, f"{what}: {n} values are not a multiple of {bs}")
    if x.device.type == "cpu":
        counters[t].plain_calls += 1
        return PLAIN[t](x)
    _build.require(x.device.type == "cuda", f"{what}: unsupported device {x.device}")
    _build.require(x.dtype == torch.float32, f"{what}: values must be f32")
    _build.require(x.is_contiguous(), f"{what}: values must be contiguous")
    out = torch.empty(n // bs * nbytes, dtype=torch.uint8, device=x.device)
    lib = _build.load("quantize", fn, _ARGTYPES)
    rc = getattr(lib, fn)(_build.ptr(x), _build.ptr(out), n // bs, _build.stream_ptr(x.device))
    _build.check(lib, rc, what)
    counters[t].launches += 1
    return out


def quantize_q4k(x: torch.Tensor) -> torch.Tensor:
    """f32 values (n % 256 == 0) -> Q4_K bytes [n / 256 * 144] on x's device."""
    return _quantize(GGMLType.Q4_K, x)


def quantize_q6k(x: torch.Tensor) -> torch.Tensor:
    """f32 values (n % 256 == 0) -> Q6_K bytes [n / 256 * 210] on x's device."""
    return _quantize(GGMLType.Q6_K, x)


def quantize_q80(x: torch.Tensor) -> torch.Tensor:
    """f32 values (n % 32 == 0) -> Q8_0 bytes [n / 32 * 34] on x's device."""
    return _quantize(GGMLType.Q8_0, x)


QUANTIZERS = {GGMLType.Q4_K: quantize_q4k, GGMLType.Q6_K: quantize_q6k,
              GGMLType.Q8_0: quantize_q80}
