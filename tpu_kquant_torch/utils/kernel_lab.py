"""The qmm kernel lab: a mutation ladder and tile sweeps of the quantized
GEMV, to attribute its time to the stages of its pipeline.

Counterpart of ``tpu_kquant/utils/kernel_lab.py``. One parametric kernel
family (``csrc/kernel_lab.cu``) computes y[R, N] from x [R, K] and a packed
kmajor weight W (N, K) in one of the ladder's modes; each mode adds one
stage of the production GEMV's pipeline:

  dma      every packed byte loaded and summed as signed int8 (``__dp4a``
           with ones): the weight stream alone
  extract  + the codes taken out of their bytes (q4: the nibble folds)
  convert  + codes to float, multiplied with x (no scales): x @ codes
  bf16c    + the scale (and min) chain in bf16: w = bf16(bf16(q s) - m)
  full     + the f32 scale chain, w rounded to bf16 before the product:
           w = bf16(q s - m); x @ w
  gdot     the production GEMV's form: per group s (x_g . q_g) - m sum(x_g)

Differencing adjacent rungs attributes time to each stage; sweeping the
tiles and the two geometries attributes the rest to the blocking:

- ``geometry="k"`` (#15): blocks over (128-column tile, chunk of ``tk``
  packed rows of each fold), f32 partials per chunk and a fixed-order
  reduce launch: the split-K shape of the production GEMV
  (``csrc/common.cuh``).
- ``geometry="n"`` (#14): a block per ``tn``-column tile walks the whole K,
  its accumulators in registers.
- ``lab_qmm_manual`` (#16, q4 only): the k geometry's blocks, each walking
  its chunk through a two-slot ``cp.async`` ring in shared memory (stage
  i + 1 requested before stage i is computed), then the f32 "combo" chain
  w = q s; x @ w - (x @ G) @ m.

Kinds: q4 with bf16 (scale, min) pairs (``s_fmt="sm"``) or f32 scales and
mins (``"f32"``); the flat int8 kinds q6w and q8 with bf16 scale pairs
(``"sp"``) or f32 scales (``"f32"``). Flat kinds are walked as two halves
of K, as the reference's k geometry does. Every output is f32.

Two faults of the reference's lab are not carried over (ROADMAP Queue 3):
its manual kernel reads one x chunk for every chunk and the low fold's
scale rows for both folds, and its f32-scale q4 rungs drop the mins. The
port's rungs compute x @ W as stated above, and so stream every byte that
``lab_bytes`` counts.

``lab_qmm_plain`` / ``lab_qmm_manual_plain`` are the same functions in
plain torch, one shot per mode. ``lab_qmm`` and ``lab_qmm_manual`` run them
only for CPU tensors; on a card they launch the kernel or raise.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from tpu_kquant_torch.ops import _build
from tpu_kquant_torch.ops.lab_dequant import (
    group_scale_dot,
    group_scale_mulsub,
    q4_codes_word,
    sp_scales,
)
from tpu_kquant_torch.quant.codecs import unpack_scale_pairs
from tpu_kquant_torch.quant.qtensor import QTensor
from tpu_kquant_torch.quant.repack import GROUP_SIZE

MODES = ("dma", "extract", "convert", "bf16c", "full", "gdot")
SCALED = ("bf16c", "full", "gdot")  # the rungs that read the scale planes
# scale layouts: csrc/kernel_lab.cu's FMT_*
FMT_SM, FMT_Q4F, FMT_SP, FMT_F32 = 0, 1, 2, 3

counter_n = _build.LaunchCounter("lab_qmm_n")
counter_k = _build.LaunchCounter("lab_qmm_k")
counter_manual = _build.LaunchCounter("lab_qmm_manual")

_P = ctypes.c_void_p
_I = ctypes.c_int
#              mode geom q4  fmt g   x   qs  scl mins out ws  R   N   K   tile stream
_LAB_ARGTYPES = [_I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]
#                 dma fmt x   qs  scl mins out ws  R   N   K   tk2 stream
_MANUAL_ARGTYPES = [_I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]


def _layout(qt: QTensor, s_fmt: str, what: str):
    """(fmt code, group rows, qs, scales array, mins or None) of a weight the
    lab reads; raises ValueError for any other kind, layout or shape."""
    req = _build.require
    if qt.layout != "kmajor" or qt.fold != 1 or len(qt.shape) != 2:
        raise ValueError(f"{what}: needs a kmajor (N, K) weight, got {qt.kind} {qt.layout}")
    a = qt.arrays
    N, K = (int(d) for d in qt.shape)
    if qt.kind == "q4" and s_fmt == "sm" and "sm" in a:
        fmt, scl, mins = FMT_SM, a["sm"], None
    elif qt.kind == "q4" and s_fmt == "f32" and "scales" in a and "mins" in a:
        fmt, scl, mins = FMT_Q4F, a["scales"], a["mins"]
    elif qt.kind in ("q6w", "q8") and s_fmt == "sp" and "sp" in a:
        fmt, scl, mins = FMT_SP, a["sp"], None
    elif qt.kind in ("q6w", "q8") and s_fmt == "f32" and "scales" in a:
        fmt, scl, mins = FMT_F32, a["scales"], None
    else:
        raise ValueError(f"{what}: the lab reads q4 with 'sm' or 'f32' scales and q6w / q8 "
                         f"with 'sp' or 'f32', not {qt.kind} with {s_fmt!r} "
                         f"(arrays {sorted(a)})")
    g = GROUP_SIZE[qt.kind]
    req(K % 64 == 0 and N % 4 == 0, f"{what}: shape (N={N}, K={K}) needs K % 64 == 0, N % 4 == 0")
    qs = a["qs"]
    req(qs.dtype == (torch.uint8 if qt.kind == "q4" else torch.int8)
        and tuple(qs.shape) == ((K // 2 if qt.kind == "q4" else K), N), f"{what}: codes")
    rows = K // g // (2 if fmt == FMT_SP else 1)
    req(all(t.dtype == torch.float32 and tuple(t.shape) == (rows, N)
            for t in (scl, mins) if t is not None), f"{what}: scale arrays")
    return fmt, g, qs, scl, mins


def _codes(qt: QTensor) -> torch.Tensor:
    """Integer codes [K, N] (q4: fold 0 rows, then fold 1 rows)."""
    qs = qt.arrays["qs"]
    if qt.kind == "q4":
        return torch.cat([q4_codes_word(qs, False), q4_codes_word(qs, True)], dim=0)
    return qs


def _scales(fmt: int, scl: torch.Tensor, mins):
    """Per-group f32 (scales, mins or None), group rows along axis 0."""
    if fmt == FMT_SM:
        return unpack_scale_pairs(scl)
    if fmt == FMT_SP:
        return sp_scales(scl), None
    return scl.float(), (mins.float() if mins is not None else None)


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16)


def _byte_sums(qt: QTensor, R: int) -> torch.Tensor:
    """The dma rung: every packed byte as signed int8, summed per column."""
    qs = qt.arrays["qs"].contiguous().view(torch.int8)
    return qs.to(torch.int64).sum(0).float().expand(R, -1).contiguous()


def _check_mode(mode: str, what: str) -> None:
    if mode not in MODES:
        raise ValueError(f"{what}: mode {mode!r} is not one of {MODES}")


def rung_weight(qt: QTensor, mode: str, s_fmt: str) -> torch.Tensor:
    """The weight [K, N] f32 that the rung ``mode`` multiplies x with:
    ``convert`` the codes, ``bf16c`` / ``full`` w after their scale chains
    (every value a bf16)."""
    if mode not in ("convert", "bf16c", "full"):
        raise ValueError(f"rung_weight: mode {mode!r} is not convert, bf16c or full")
    fmt, g, _, scl, mins = _layout(qt, s_fmt, "rung_weight")
    q = _codes(qt).float()
    if mode == "convert":
        return q
    s, m = _scales(fmt, scl, mins)
    if mode == "full" or fmt == FMT_SP:  # bf16c on pairs: the f32 product, rounded
        return _bf16(group_scale_mulsub(q, s, m, g)).float()
    # bf16c: the product (and the min's subtraction) rounded to bf16
    K, N = q.shape
    w = _bf16(q).reshape(K // g, g, N) * _bf16(s)[:, None, :]
    if m is not None:
        w = w - _bf16(m)[:, None, :]
    return w.reshape(K, N).float()


def lab_qmm_plain(x: torch.Tensor, xi8: torch.Tensor, qt: QTensor, mode: str,
                  s_fmt: str) -> torch.Tensor:
    """The rung ``mode`` of y = x @ W in plain torch (module docstring); the
    same function for either geometry and every tile. [R, N] f32."""
    _check_mode(mode, "lab_qmm_plain")
    fmt, g, _, scl, mins = _layout(qt, s_fmt, "lab_qmm_plain")
    R = x.shape[0]
    if mode == "dma":
        return _byte_sums(qt, R)
    if mode == "extract":
        return _codes(qt).to(torch.int64).sum(0).float().expand(R, -1).contiguous()
    if mode == "gdot":
        return group_scale_dot(x.float(), _codes(qt), *_scales(fmt, scl, mins), g)
    return x.float() @ rung_weight(qt, mode, s_fmt)


def lab_qmm_manual_plain(x: torch.Tensor, qt: QTensor, mode: str, s_fmt: str) -> torch.Tensor:
    """``lab_qmm_manual``'s function in plain torch: ``dma`` sums the bytes;
    every other mode is the f32 combo chain x @ (q s) - (x @ G) @ m."""
    _check_mode(mode, "lab_qmm_manual_plain")
    if qt.kind != "q4":
        raise ValueError(f"lab_qmm_manual_plain: q4 only, not {qt.kind}")
    fmt, g, _, scl, mins = _layout(qt, s_fmt, "lab_qmm_manual_plain")
    if mode == "dma":
        return _byte_sums(qt, x.shape[0])
    s, m = _scales(fmt, scl, mins)
    xf = x.float()
    y = xf @ group_scale_mulsub(_codes(qt).float(), s, None, g)
    if m is not None:
        y = y - xf.reshape(x.shape[0], -1, g).sum(-1) @ m
    return y


def k_chunk(K: int, tk: int) -> int:
    """Packed rows of each fold per K chunk: tk halved until it divides K/2
    (the reference's rule)."""
    if tk <= 0:
        raise ValueError(f"tk must be positive, got {tk}")
    t = tk
    while (K // 2) % t:
        t //= 2
    return t


def n_tile(N: int, tn: int) -> int:
    """Columns per block of the n geometry: tn halved until it divides N."""
    if tn <= 0:
        raise ValueError(f"tn must be positive, got {tn}")
    t = tn
    while N % t:
        t //= 2
    return t


def _inputs(x: torch.Tensor, qt: QTensor, what: str):
    req = _build.require
    N, K = (int(d) for d in qt.shape)
    req(x.device.type == "cuda", f"{what}: unsupported device {x.device}")
    req(x.dtype == torch.bfloat16 and x.dim() == 2 and x.shape[1] == K and x.is_contiguous(),
        f"{what}: x must be contiguous bf16 [R, {K}], got {x.dtype} {tuple(x.shape)}")
    req(all(t.device == x.device and t.is_contiguous() for t in qt.arrays.values()),
        f"{what}: packed arrays must be contiguous on x's device")
    return N, K


def lab_qmm(x: torch.Tensor, xi8: torch.Tensor, qt: QTensor, mode: str, s_fmt: str, tk: int,
            geometry: str = "k", tn: int = 256) -> torch.Tensor:
    """One rung of the ladder (kernels #14 / #15): y [R, N] f32.

    x [R, K] bf16; xi8 [R, >= 1] int8 is the reference's operand of ones
    for the dma and extract rungs (the port's rungs multiply by ones, so
    only its rows and dtype are checked); ``tk`` packed rows per K chunk
    (geometry "k", ``k_chunk``), ``tn`` columns per block (geometry "n",
    ``n_tile``: a multiple of 128 up to 1024)."""
    _check_mode(mode, "lab_qmm")
    if geometry not in ("k", "n"):
        raise ValueError(f"lab_qmm: geometry {geometry!r} is not 'k' or 'n'")
    counter = counter_k if geometry == "k" else counter_n
    if x.device.type == "cpu":
        counter.plain_calls += 1
        return lab_qmm_plain(x, xi8, qt, mode, s_fmt)
    req = _build.require
    fmt, g, qs, scl, mins = _layout(qt, s_fmt, "lab_qmm")
    N, K = _inputs(x, qt, "lab_qmm")
    R = x.shape[0]
    req(xi8.dtype == torch.int8 and xi8.dim() == 2 and xi8.shape[0] == R
        and xi8.device == x.device, "lab_qmm: xi8 must be int8 [R, *] on x's device")
    if geometry == "k":
        tile = k_chunk(K, tk)
        req(tile % 32 == 0, f"lab_qmm: K chunk {tile} (tk {tk}, K {K}) is not a multiple of 32")
        splits = (K // 2) // tile
    else:
        tile = n_tile(N, tn)
        req(tile % 128 == 0 and tile <= 1024,
            f"lab_qmm: column tile {tile} (tn {tn}, N {N}) is not a multiple of 128 up to 1024")
        splits = 1
    out = torch.empty((R, N), dtype=torch.float32, device=x.device)
    ws = torch.empty(splits * R * N if splits > 1 else 0, dtype=torch.float32, device=x.device)
    lib = _build.load("kernel_lab", "tkq_lab_qmm", _LAB_ARGTYPES)
    P = _build.ptr
    rc = lib.tkq_lab_qmm(MODES.index(mode), int(geometry == "n"), int(qt.kind == "q4"), fmt, g,
                         P(x), P(qs), P(scl), None if mins is None else P(mins), P(out), P(ws),
                         R, N, K, tile, _build.stream_ptr(x.device))
    _build.check(lib, rc, "lab_qmm")
    counter.launches += 1
    return out


def lab_qmm_manual(x: torch.Tensor, qt: QTensor, mode: str, s_fmt: str, tk: int) -> torch.Tensor:
    """Kernel #16: the k geometry's blocks with a two-slot ``cp.async`` ring
    (module docstring); q4 with 'sm' or 'f32' scales, N % 128 == 0. ``dma``
    sums the bytes; any other mode runs the f32 combo chain."""
    _check_mode(mode, "lab_qmm_manual")
    if qt.kind != "q4":
        raise ValueError(f"lab_qmm_manual: q4 only, not {qt.kind}")
    if x.device.type == "cpu":
        counter_manual.plain_calls += 1
        return lab_qmm_manual_plain(x, qt, mode, s_fmt)
    req = _build.require
    fmt, _, qs, scl, mins = _layout(qt, s_fmt, "lab_qmm_manual")
    N, K = _inputs(x, qt, "lab_qmm_manual")
    req(N % 128 == 0, f"lab_qmm_manual: N = {N} is not a multiple of 128")
    R = x.shape[0]
    tile = k_chunk(K, tk)
    req(tile % 32 == 0 and (tile <= 256 or tile % 256 == 0),
        f"lab_qmm_manual: K chunk {tile} (tk {tk}) is not a multiple of 32 up to 256, or of "
        f"256 (the ring's stage)")
    splits = (K // 2) // tile
    out = torch.empty((R, N), dtype=torch.float32, device=x.device)
    ws = torch.empty(splits * R * N if splits > 1 else 0, dtype=torch.float32, device=x.device)
    lib = _build.load("kernel_lab", "tkq_lab_qmm_manual", _MANUAL_ARGTYPES)
    P = _build.ptr
    rc = lib.tkq_lab_qmm_manual(int(mode == "dma"), fmt, P(x), P(qs), P(scl),
                                None if mins is None else P(mins), P(out), P(ws), R, N, K, tile,
                                _build.stream_ptr(x.device))
    _build.check(lib, rc, "lab_qmm_manual")
    counter_manual.launches += 1
    return out


def lab_bytes(qt: QTensor, mode: str) -> int:
    """Bytes the rung streams: the codes, plus every scale array for the
    scaled rungs (bf16c, full, gdot; the manual kernel's non-dma modes)."""
    keep = qt.arrays if mode in SCALED else {"qs": qt.arrays["qs"]}
    return sum(int(np.prod(v.shape)) * v.element_size() for v in keep.values())


def run_ladder(qt: QTensor, s_fmt: str, R: int = 1, tks=(256, 512, 1024), tns=(256, 512),
               modes=MODES, log=print, reps: int = 3, manual: bool = True,
               target_s: float = 0.03) -> list[dict]:
    """Time every rung at every tile of both geometries on one packed weight
    (on the device its arrays live on), and with ``manual`` the manual
    kernel's dma and full rungs at every tk on a q4 weight. Each time is
    ``time_chained``'s marginal estimate over copies of the weight that
    together exceed the L2 cache twice. Returns attribution rows
    (``kernel_report``'s keys plus kind, N, K, geometry, tile, mode, s_fmt)."""
    from tpu_kquant_torch.utils.attribution import (
        chain_length_for,
        cycle,
        dep,
        kernel_report,
        rotation,
        time_chained,
    )

    N, K = int(qt.shape[0]), int(qt.shape[1])
    dev = qt.arrays["qs"].device
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((R, K)).astype(np.float32)).to(dev).to(torch.bfloat16)
    xi8 = torch.ones((R, K), dtype=torch.int8, device=dev)
    copies = [qt] if dev.type == "cpu" else rotation(qt, qt.clone, qt.n_bytes)
    runs = [(geometry, tsz, mode) for geometry, sizes in (("k", tks), ("n", tns))
            for tsz in sizes for mode in modes]
    if manual and qt.kind == "q4":
        runs += [("manual", tsz, mode) for tsz in tks for mode in ("dma", "full") if mode in modes]
    rows = []
    for geometry, tsz, mode in runs:
        nb = lab_bytes(qt, mode)
        nxt = cycle(copies)
        if geometry == "manual":
            def fn(xc, mode=mode, tsz=tsz, nxt=nxt):
                return dep(xc, lab_qmm_manual(xc, nxt(), mode, s_fmt, tsz))
        else:
            def fn(xc, mode=mode, tsz=tsz, geometry=geometry, nxt=nxt):
                return dep(xc, lab_qmm(xc, xi8, nxt(), mode, s_fmt, tsz, geometry=geometry,
                                       tn=tsz))
        t = time_chained(fn, x, chain_length_for(nb, target_s), reps=reps)
        r = kernel_report(f"{qt.kind}-{s_fmt} [{N},{K}] {geometry} t={tsz} {mode}", t, nb,
                          log=log)
        r.update(kind=qt.kind, N=N, K=K, geometry=geometry, tile=tsz, mode=mode, s_fmt=s_fmt)
        rows.append(r)
    return rows
