"""Per-kernel attribution at model shapes: each kernel of the decode and
prefill paths timed alone on synthetic packed weights (TinyLlama-1.1B and
Llama-3-8B Q4_K_M inventories), reported as achieved GB/s and tensor-core
fraction against the card's peaks (``utils.roofline``).

Counterpart of the root ``tools_kernel_bench.py``. Weights are random codes
drawn directly in the packed layouts; ``mk_q4`` / ``mk_q6w`` draw the same
bytes as the reference's from the same ``numpy`` generator state. Times are
``utils.attribution.time_chained``'s marginal estimates (CUDA-graph chains
on the card), over copies of the weights that together exceed the L2 cache
twice.

  python -m tpu_kquant_torch.tools.kernel_bench --model 8b --phase decode
  python -m tpu_kquant_torch.tools.kernel_bench --model tiny --phase prefill --rows 512
  python -m tpu_kquant_torch.tools.kernel_bench --model toy --device cpu --iters 2

Without a card it raises unless ``--device cpu`` is given; CPU runs time
the plain versions, which is no device measurement.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

from tpu_kquant_torch.quant.qtensor import QTensor
from tpu_kquant_torch.quant.repack import pack_scale_kpairs, pack_scale_pairs
from tpu_kquant_torch.utils.attribution import (
    chain_length_for,
    cycle,
    dep,
    kernel_report,
    rotation,
    time_chained,
)
from tpu_kquant_torch.utils.roofline import chip_specs


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def mk_q4(N: int, K: int, rng, sm: bool = True, device=None) -> QTensor:
    """A q4 kmajor weight (N, K) of random codes: bf16 (scale, min) pairs
    ``sm`` or f32 ``scales`` + ``mins``; numpy arrays unless ``device``."""
    qs = rng.integers(0, 256, (K // 2, N), dtype=np.uint8)
    if sm:
        s = (rng.random((K // 32, N), dtype=np.float32) * 0.01).astype(np.float32)
        m = (rng.random((K // 32, N), dtype=np.float32) * 0.01).astype(np.float32)
        qt = pack_scale_pairs(QTensor("q4", "kmajor", (N, K), {"qs": qs, "scales": s, "mins": m}))
    else:
        qt = QTensor("q4", "kmajor", (N, K), {
            "qs": qs,
            "scales": rng.random((K // 32, N), dtype=np.float32) * 0.01,
            "mins": rng.random((K // 32, N), dtype=np.float32) * 0.01})
    return qt if device is None else qt.to(device)


def mk_q6w(N: int, K: int, rng, sp: bool = True, device=None) -> QTensor:
    """A q6w kmajor weight (N, K): bf16 scale pairs ``sp`` (the loader's
    bf16 layout) or f32 ``scales``; numpy arrays unless ``device``."""
    qs = rng.integers(-32, 32, (K, N)).astype(np.int8)
    scales = (rng.random((K // 16, N), dtype=np.float32) * 0.01).astype(np.float32)
    qt = QTensor("q6w", "kmajor", (N, K), {"qs": qs, "scales": scales})
    if sp:
        qt = pack_scale_kpairs(qt)
    return qt if device is None else qt.to(device)


def qt_bytes(qt: QTensor) -> int:
    return qt.n_bytes


MODELS = {
    # dim, n_heads, n_kv, head_dim, ffn, vocab, n_layers
    "tiny": dict(D=2048, H=32, Hkv=4, hd=64, F=5632, V=32000, L=22),
    "8b": dict(D=4096, H=32, Hkv=8, hd=128, F=14336, V=128256, L=32),
    # not a model: narrow shapes for CPU runs of the tools (the plain versions)
    "toy": dict(D=256, H=4, Hkv=2, hd=64, F=512, V=1024, L=2),
}


def rotated(*ws: QTensor):
    """A function returning the weights, or on a card copies of them in turn
    (enough to exceed the L2 cache twice)."""
    dev = ws[0].arrays["qs"].device
    if dev.type == "cpu":
        return lambda: ws
    nb = sum(w.n_bytes for w in ws)
    return cycle(rotation(ws, lambda: tuple(w.clone() for w in ws), nb))


def report_line(name: str, t: float, nbytes: int, flops: float = 0.0) -> dict:
    return kernel_report(name, t, nbytes, flops, log=log)


def bench_decode(model: str, R: int, n_iter: int, results: list, only: str = "",
                 device: str = "cuda"):
    """Each decode-path kernel at R rows: attn_in (wqk + wv), oproj_ffn,
    ffn, the lm-head qmm, and flash decode at S = 704 and 4096. n_iter > 0
    fixes the chain length (else ``chain_length_for``)."""
    from tpu_kquant_torch.ops.attn_in import fused_attn_in
    from tpu_kquant_torch.ops.decode_attention import attention_decode_flash
    from tpu_kquant_torch.ops.ffn import fused_ffn, fused_oproj_ffn
    from tpu_kquant_torch.ops.qmm import qmm

    def sel(name: str) -> bool:
        return (not only) or (only in name)

    def n_for(nb: int) -> int:
        return n_iter if n_iter > 0 else chain_length_for(nb)

    m = MODELS[model]
    D, H, Hkv, hd, F, V = m["D"], m["H"], m["Hkv"], m["hd"], m["F"], m["V"]
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((R, D)).astype(np.float32)).to(device)
    x = x.to(torch.bfloat16)
    log(f"--- decode kernels, {model} shapes, R={R}, device {device} ---")
    wqk = mk_q4((H + Hkv) * hd, D, rng, device=device)
    wv = mk_q6w(Hkv * hd, D, rng, device=device)
    wo = mk_q4(D, H * hd, rng, device=device)
    gu = mk_q4(2 * F, D, rng, device=device)
    dn = mk_q6w(D, F, rng, device=device)
    head = mk_q6w(V, D, rng, device=device)
    norm_w = torch.ones(D, dtype=torch.float32, device=device)
    cos = torch.ones(R, hd // 2, dtype=torch.float32, device=device)
    sin = torch.zeros(R, hd // 2, dtype=torch.float32, device=device)

    if sel("attn_in"):
        nxt = rotated(wqk, wv)

        def attn_in_fn(xc):
            a, b = nxt()
            qk, v = fused_attn_in(xc, norm_w, 1e-5, a, b, cos, sin, hd)
            return dep(dep(xc, qk), v)

        nb = qt_bytes(wqk) + qt_bytes(wv)
        t = time_chained(attn_in_fn, x, n_for(nb))
        results.append(report_line("attn_in (norm+qkv+rope)", t, nb,
                                   2.0 * R * D * (H + 2 * Hkv) * hd))

    attn = torch.from_numpy(rng.standard_normal((R, H * hd)).astype(np.float32)).to(device)
    attn = attn.to(torch.bfloat16)
    if sel("oproj"):
        nxt = rotated(wo, gu, dn)

        def oproj_ffn_fn(xc):
            a, b, c = nxt()
            return fused_oproj_ffn(xc, attn, a, norm_w, 1e-5, b, c)

        nb = qt_bytes(wo) + qt_bytes(gu) + qt_bytes(dn)
        t = time_chained(oproj_ffn_fn, x, n_for(nb))
        results.append(report_line("oproj+ffn megakernel", t, nb, 2.0 * R * D * (H * hd + 3 * F)))

    if sel("ffn megakernel") or only == "ffn":
        nxt = rotated(gu, dn)

        def ffn_fn(xc):
            b, c = nxt()
            return fused_ffn(xc, norm_w, 1e-5, b, c)

        nb = qt_bytes(gu) + qt_bytes(dn)
        t = time_chained(ffn_fn, x, n_for(nb))
        results.append(report_line("ffn megakernel", t, nb, 2.0 * R * D * 3 * F))

    if sel("head"):
        nxt = rotated(head)

        def head_fn(xc):
            return dep(xc, qmm(xc, nxt()[0], torch.float32))

        nb = qt_bytes(head)
        t = time_chained(head_fn, x, n_for(nb))
        results.append(report_line("lm head qmm", t, nb, 2.0 * R * D * V))

    for S in ((704, 4096) if sel("attn S=") else ()):
        B = R

        def bf(*shape):
            return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
                device).to(torch.bfloat16)

        k_cache, v_cache, q0 = bf(B, Hkv, S, hd), bf(B, Hkv, S, hd), bf(B, 1, H, hd)
        pos = torch.full((B, 1), S - 2, dtype=torch.int32, device=device)

        def attn_fn(xc):
            q = q0 + xc[:, None, None, :hd]
            return dep(xc, attention_decode_flash(q, k_cache, v_cache, pos))

        nb = 2 * B * Hkv * S * hd * 2
        t = time_chained(attn_fn, x, n_for(nb))
        results.append(report_line(f"flash decode attn S={S}", t, nb))


def bench_prefill(model: str, rows: int, n_iter: int, results: list, tb: int = 256,
                  tn: int = 0, device: str = "cuda"):
    """The q4 gate/up qmm at R = rows (the tiled kernel past 32 rows) against
    dequantize + torch.matmul and against ``qmatmul(impl="int8")`` (whose
    gate sends bf16 pairs and rows past 32 to qmm, as the reference's does).
    tb / tn are the reference's TPU tile flags: the port's tile is fixed
    (128 x 128), so they are only recorded."""
    from tpu_kquant_torch.ops.qmatmul import qmatmul
    from tpu_kquant_torch.ops.qmm import qmm
    from tpu_kquant_torch.quant.codecs import dequant_kmajor

    m = MODELS[model]
    D, F = m["D"], m["F"]
    rng = np.random.default_rng(0)
    R = rows
    x = torch.from_numpy(rng.standard_normal((R, D)).astype(np.float32)).to(device)
    x = x.to(torch.bfloat16)
    log(f"--- prefill qmm, {model} shapes, R={R}, device {device} ---")
    gu = mk_q4(2 * F, D, rng, device=device)
    nxt = rotated(gu)
    gbs, tflops = chip_specs()
    fl = 2.0 * R * D * 2 * F
    if n_iter <= 0:
        n_iter = int(min(512, max(16, 0.05 / (fl / (tflops * 1e12)
                                             + qt_bytes(gu) / (gbs * 1e9)))))

    def fn(xc):
        return dep(xc, qmm(xc, nxt()[0], torch.bfloat16))

    t = time_chained(fn, x, n_iter)
    r = report_line(f"qmm q4 gateup R={R}", t, qt_bytes(gu), fl)
    r["note"] = f"tb={tb} tn={tn} (TPU tile flags; not read by the port)"
    results.append(r)

    wd = [dequant_kmajor(w[0], dtype=torch.bfloat16).contiguous()
          for w in ([(gu,)] if x.device.type == "cpu" else [nxt() for _ in range(2)])]
    nw = cycle(wd)

    def fn_dq(xc):
        return dep(xc, xc @ nw())

    t = time_chained(fn_dq, x, n_iter)
    results.append(report_line(f"dequantized bf16 torch.matmul R={R}", t, qt_bytes(gu), fl))

    def fn_i8(xc):
        return dep(xc, qmatmul(xc[:, None, :], nxt()[0], "int8", out_dtype=torch.bfloat16))

    t = time_chained(fn_i8, x, n_iter)
    results.append(report_line(f"qmatmul impl=int8 R={R}", t, qt_bytes(gu), fl))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="8b", choices=list(MODELS))
    ap.add_argument("--phase", default="decode", choices=["decode", "prefill"])
    ap.add_argument("--rows", type=int, default=1)
    ap.add_argument("--iters", type=int, default=0, help="chain length (0: auto)")
    ap.add_argument("--tb", type=int, default=256)
    ap.add_argument("--tn", type=int, default=0)
    ap.add_argument("--only", default="", help="substring filter on kernel names")
    ap.add_argument("--json-out", default="")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("kernel_bench: no CUDA card; pass --device cpu to run the plain "
                           "versions on the CPU")
    dev = torch.device("cuda", 0) if args.device == "cuda" else torch.device("cpu")
    dev_name = torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu"
    log(f"device: {dev_name}")
    results: list = []
    if args.phase == "decode":
        bench_decode(args.model, args.rows, args.iters, results, only=args.only, device=dev)
    else:
        bench_prefill(args.model, args.rows, args.iters, results, tb=args.tb, tn=args.tn,
                      device=dev)
    for r in results:
        r["device"] = dev_name
    if args.json_out:
        Path(args.json_out).write_text(json.dumps(results, indent=1))
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
