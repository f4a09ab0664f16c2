"""Measure the flash decode kernel (csrc/decode_attn.cu, #7) and the few-row
attention of #10 / #11 on the card beyond chip_smoke.py's phase 3, each
number beside the card's name and power limit:

    python3 -m tpu_kquant_torch.tools.decode_sweep --out FILE.json [--ablate] [--crossover]
        [--fused]

--ablate     decode_attn.cu built with TKQ_FD_ABLATE (1: no mma, 2: no ring:
             each tile loaded and waited for before it is computed, 3: the
             loads alone) beside the full kernel at every DECODE_CASES case
             of chip_smoke.py: where a case's time goes between the loads,
             their overlap with the math, and the tensor-core math.
--fused      the few-row attention of attn_out (#10) and layer (#11)
             (csrc/decode_attn.cuh:fused_attn_kernel, through
             tkq_fused_attn) at FUSED_CASES, full and built with
             TKQ_FD_ABLATE 1 (no mma) or 3 (loads only) or TKQ_FA_ABLATE=1
             (no cluster: a plain launch, each split's state left unread by
             the others; wrong results, for timing).
--crossover  ops/attention.py's plain branch (the budget raised) beside the
             kernel at decode (T = 1) at TinyLlama's heads, B = 1, 16 and 64,
             S = 704 and 2048, bf16 KV, positions at the cache's end: the
             data for ATTN_PLAIN_MAX_MB at decode.

Inputs and timing are chip_smoke.py's (check_decode_attn's cache views,
graph_ms over 20 launches). Variant libraries are built with ops/_build.py's
flags under .cache/decode_variants. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import subprocess
from pathlib import Path

TREE = Path(__file__).resolve().parents[2]
VARIANTS = TREE / ".cache" / "decode_variants"
ABLATIONS = {"full": 0, "no mma": 1, "no ring": 2, "loads only": 3}
FUSED_ABLATIONS = {"full": [], "no mma": ["-DTKQ_FD_ABLATE=1"],
                   "loads only": ["-DTKQ_FD_ABLATE=3"], "no cluster": ["-DTKQ_FA_ABLATE=1"]}
# the few-row attention at chip_smoke.py's attn_out and layer shapes
# (TinyLlama's heads): (label, B, S, positions, int8 KV, the current token)
FUSED_CASES = (
    ("attn_out B=1 pos 700 bf16", 1, 704, (700,), False, False),
    ("attn_out B=1 pos 40 bf16", 1, 704, (40,), False, False),
    ("attn_out B=16 pos 700 int8", 16, 704, (700,) * 16, True, False),
    ("layer B=1 pos 700", 1, 704, (700,), False, True),
    ("layer B=1 pos 0", 1, 704, (0,), False, True),
    ("layer B=4 positions 64, 1000, 1500, 2047", 4, 2048, (64, 1000, 1500, 2047), False, True),
)


def _smoke():
    spec = importlib.util.spec_from_file_location("decode_sweep_smoke", TREE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build_variants(defines: dict[str, list[str]]) -> dict[str, ctypes.CDLL]:
    """csrc/decode_attn.cu built once per entry (name -> extra nvcc flags),
    all in parallel, each loaded with its entry point declared."""
    from tpu_kquant_torch.ops import _build
    from tpu_kquant_torch.ops.decode_attention import _ARGTYPES, _FUSED_ARGTYPES

    VARIANTS.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, flags in defines.items():
        out = VARIANTS / f"decode_attn-{name.replace(' ', '_')}.so"
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, *flags, "-o", str(out),
               str(_build.CSRC / "decode_attn.cu")]
        procs[name] = (out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"FAIL: nvcc decode_attn.cu {defines[name]}:\n{log}")
        lib = ctypes.CDLL(str(out))
        lib.tkq_decode_attn.argtypes = _ARGTYPES
        lib.tkq_decode_attn.restype = ctypes.c_int
        lib.tkq_fused_attn.argtypes = _FUSED_ARGTYPES
        lib.tkq_fused_attn.restype = ctypes.c_int
        lib.tkq_error_string.argtypes = [ctypes.c_int]
        lib.tkq_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def call(lib, q, k, v, qp, scales):
    """One launch of a variant library, with the wrapper's arguments
    (ops/decode_attention.py:attention_decode_flash, bf16 q)."""
    import torch

    from tpu_kquant_torch.ops import _build
    from tpu_kquant_torch.ops.decode_attention import decode_plan

    B, _, H, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    qb = q[:, 0]
    out = torch.empty_like(q)
    tps, splits = decode_plan(S, D, scales is not None)
    part = torch.empty(B * H * splits * (D + 2) if splits > 1 else 1, dtype=torch.float32,
                       device=q.device)
    items = torch.empty(B * splits + 2, dtype=torch.int32, device=q.device)
    P = _build.ptr
    sc = ([a for t in scales for a in (P(t), t.stride(0), t.stride(1))] if scales
          else [None, 0, 0] * 2)
    qp32 = qp[:, 0].to(torch.int32).contiguous()
    rc = lib.tkq_decode_attn(int(scales is not None), D, P(qb), qb.stride(0), P(k), k.stride(0),
                             k.stride(1), P(v), v.stride(0), v.stride(1), *sc, P(qp32), P(out), 0,
                             B, H, Hkv, S, float(D) ** -0.5, tps, splits, P(part), P(items),
                             _build.stream_ptr(q.device))
    _build.check(lib, rc, "decode_attn variant")
    return out


def call_fused(lib, q, k, v, qp, scales, cur):
    """One launch of a variant library's few-row attention, with the
    arguments of ops/decode_attention.py:fused_attention."""
    import torch

    from tpu_kquant_torch.ops import _build
    from tpu_kquant_torch.ops.decode_attention import fused_attn_plan

    B, H, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    out = torch.empty((B, H * D), dtype=torch.bfloat16, device=q.device)
    tps, splits = fused_attn_plan(S)
    P = _build.ptr
    sc = ([a for t in scales for a in (P(t), t.stride(0), t.stride(1))] if scales
          else [None, 0, 0] * 2)
    c = [P(cur[0]), cur[0].stride(0), P(cur[1]), cur[1].stride(0)] if cur else [None, 0, None, 0]
    rc = lib.tkq_fused_attn(int(scales is not None), D, P(q), q.stride(0), P(k), k.stride(0),
                            k.stride(1), P(v), v.stride(0), v.stride(1), *sc, P(qp), *c, P(out),
                            B, H, Hkv, S, float(D) ** -0.5, tps, splits,
                            _build.stream_ptr(q.device))
    _build.check(lib, rc, "fused_attn variant")
    return out


def fused(smoke, dev, libs) -> list:
    """Every FUSED_CASES case in every variant library (graph ms), and the
    full build's error against the plain version per (row, head)."""
    import torch

    from tpu_kquant_torch.ops.decode_attention import attend_with_current, decode_attention_plain

    H, Hkv, D = smoke.TINY_HEADS
    out = []
    for label, B, S, positions, int8, self_ in FUSED_CASES:
        g = torch.Generator(device=dev).manual_seed(B + S)
        q = torch.randn(B, H, D, device=dev, generator=g).to(torch.bfloat16)
        if int8:
            k, v = (torch.randint(-127, 128, (B, Hkv, S, D), device=dev, generator=g,
                                  dtype=torch.int8) for _ in range(2))
            scales = tuple(torch.rand(B, Hkv, S, device=dev, generator=g) * 0.02 + 0.001
                           for _ in range(2))
        else:
            k, v = (torch.randn(B, Hkv, S, D, device=dev, generator=g).to(torch.bfloat16)
                    for _ in range(2))
            scales = None
        cur = tuple(torch.randn(B, Hkv, D, device=dev, generator=g).to(torch.bfloat16)
                    for _ in range(2)) if self_ else None
        qp = torch.tensor(positions, device=dev)
        got = call_fused(libs["full"], q, k, v, qp, scales, cur)
        torch.cuda.synchronize()
        pos = qp[:, None]
        ref = attend_with_current(q, k, v, pos, *cur) if self_ else \
            decode_attention_plain(q[:, None], k, v, pos, scales)
        row = {"case": label,
               "rel_err": smoke.row_rel_err(got.reshape(B, H, D), ref.reshape(B, H, D))}
        for name, lib in libs.items():
            row[name] = smoke.graph_ms(lambda i: call_fused(lib, q, k, v, qp, scales, cur), 32)
        print(f"  fused {label:44s} " + "  ".join(f"{n} {row[n] * 1e3:7.2f} us" for n in libs)
              + f"  rel err {row['rel_err']:.2e}", flush=True)
        out.append(row)
    return out


def _inputs(smoke, case, dev, seed=1):
    """check_decode_attn's inputs for one DECODE_CASES entry."""
    import torch

    label, B, S, (H, Hkv, D), (lo, hi), int8 = case
    g = torch.Generator(device=dev).manual_seed(seed)
    qk = torch.randn(B, 1, (H + Hkv) * D, device=dev, generator=g).to(torch.bfloat16)
    q = qk[..., : H * D].reshape(B, 1, H, D)
    shape = (2, B, Hkv, S, D)
    if int8:
        kc, vc = (torch.randint(-127, 128, shape, device=dev, generator=g, dtype=torch.int8)
                  for _ in range(2))
        ksc, vsc = (torch.rand(shape[:-1], device=dev, generator=g) * 0.02 + 0.001
                    for _ in range(2))
        scales = (ksc[1], vsc[1])
    else:
        kc, vc = (torch.randn(shape, device=dev, generator=g).to(torch.bfloat16)
                  for _ in range(2))
        scales = None
    qp = torch.randint(lo, hi, (B, 1), device=dev, generator=g)
    return q, kc[1], vc[1], qp, scales


def ablate(smoke, dev, libs) -> list:
    import torch

    from tpu_kquant_torch.ops.decode_attention import decode_attention_plain

    out = []
    for case in smoke.DECODE_CASES:
        q, k, v, qp, scales = _inputs(smoke, case, dev)
        row = {"case": case[0]}
        full = call(libs["full"], q, k, v, qp, scales)
        torch.cuda.synchronize()
        row["rel_err"] = smoke.row_rel_err(full, decode_attention_plain(q, k, v, qp, scales))
        for name, lib in libs.items():
            row[name] = smoke.graph_ms(lambda i: call(lib, q, k, v, qp, scales), 20)
        print(f"  ablate {case[0]:56s} " + "  ".join(f"{n} {row[n] * 1e3:8.2f} us"
                                                    for n in libs) +
              f"  rel err {row['rel_err']:.2e}", flush=True)
        out.append(row)
        del q, k, v, scales
        torch.cuda.empty_cache()
    return out


def crossover(smoke, dev) -> list:
    import torch

    from tpu_kquant_torch.ops import attention as att
    from tpu_kquant_torch.ops.decode_attention import attention_decode_flash

    H, Hkv, D = smoke.TINY_HEADS
    out = []
    for S in (704, 2048):
        for B in (1, 16, 64):
            case = (f"B={B} S={S}", B, S, (H, Hkv, D), (S - 1, S), False)
            q, k, v, qp, _ = _inputs(smoke, case, dev)
            budget = att.ATTN_PLAIN_MAX_MB
            att.ATTN_PLAIN_MAX_MB = 1e9  # the plain branch at any size
            try:
                plain = smoke.graph_ms(lambda i: att.attention_decode(q, k, v, qp), 20)
            finally:
                att.ATTN_PLAIN_MAX_MB = budget
            flash = smoke.graph_ms(lambda i: attention_decode_flash(q, k, v, qp), 20)
            row = {"case": case[0], "B": B, "S": S, "logits_mb": att.logits_mb(B, 1, H, S),
                   "plain_ms": plain, "flash_ms": flash}
            print(f"  crossover {case[0]:14s} logits {row['logits_mb']:.2f} MB: plain "
                  f"{plain:.4f} ms, flash {flash:.4f} ms", flush=True)
            out.append(row)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--ablate", action="store_true")
    ap.add_argument("--crossover", action="store_true")
    ap.add_argument("--fused", action="store_true")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("decode_sweep needs a CUDA card")
    smoke = _smoke()
    dev = torch.device("cuda", 0)
    res = {"gpu": smoke.gpu_line()}
    print(f"== decode_sweep [{res['gpu']}]", flush=True)
    if args.ablate:
        libs = build_variants({n: [f"-DTKQ_FD_ABLATE={v}"] for n, v in ABLATIONS.items()})
        res["ablate"] = ablate(smoke, dev, libs)
    if args.fused:
        res["fused"] = fused(smoke, dev, build_variants(FUSED_ABLATIONS))
    if args.crossover:
        res["crossover"] = crossover(smoke, dev)
    res["gpu_after"] = smoke.gpu_line()
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(res, indent=1))
    print(f"== decode_sweep done [{res['gpu_after']}]", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
