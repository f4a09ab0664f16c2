"""Measure the decode GEMV (csrc/gemv.cuh: qmm at R <= 32) on the card beyond
chip_smoke.py's phase 3, each number beside the card's name and power
limit:

    python3 -m tpu_kquant_torch.tools.gemv_sweep --out FILE.json [--ablate] [--plan]

--ablate  qmm.cu built with TKQ_GV_ABLATE (1: no mma, 2: no per-group
          scale and min, 3: the code and scale loads alone) beside the full
          kernel: where a case's time goes between the loads, the code
          conversion and the mma, and the f32 group epilogue.
--plan    the split plan (ops/qmm.py:gemv_plan) against every other split
          count that fits, at R = 1 and 32: whether its cost model picks
          the fastest split.
--gate-up the gate/up phase of the fused FFN kernels (ops/ffn.py:gate_up,
          csrc/gate_up.cuh) at its plan (ops/ffn.py:gate_up_plan) against
          every other split count that fits, at R = 1 and 8, at
          TinyLlama's w_gateup [11264, 2048] (q4-sm, q8-sp), Qwen2.5-1.5B's
          [17920, 1536] and Qwen2.5-7B's [37888, 3584] (q4-sm).
--attn-in attn_in (csrc/attn_in.cuh) at its plan (ops/attn_in.py:
          attn_in_plan) against every other split count a cluster takes
          (attn_in.cu built with TKQ_AI_SPLITS = 1, 2, 4, 8), and the
          ablation builds (full / no mma / no scales / loads only, then no
          cluster / no chunk loop / the launch alone, at the plan's split),
          at TinyLlama's Q4_K_M and Q8_0 slots, Qwen2.5-1.5B's
          (biases, head_dim 128) and Mixtral-8x7B's (f32 scales, bf16 pairs),
          at R = 1 and 16.

Cases: Mixtral-8x7B's expert gate/up [14336, 4096] q4-sm and down [4096,
14336] q6w-sp, TinyLlama's lm head [32000, 2048] q6w-sp and q8-sp (Q8_0),
its down [2048, 5632] q6w-sp and wqk [2304, 2048] q4-sm, at R = 1, 16 and
32 (--ablate: the first four). Timing is
chip_smoke.py's (graph_ms over weight copies that exceed L2 twice). Variant
libraries are built with ops/_build.py's flags under .cache/gemv_variants.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import subprocess
from pathlib import Path

TREE = Path(__file__).resolve().parents[2]
VARIANTS = TREE / ".cache" / "gemv_variants"
ABLATIONS = {"full": 0, "no mma": 1, "no scales": 2, "loads only": 3}
SMEM_LIMIT = 227 * 1024  # dynamic shared memory a block may take on the H100
# attn_in's timing builds (csrc/attn_in.cuh TKQ_AI_ABLATE): its cluster, its
# chunk loop, everything but the launch taken out
AI_ABLATIONS = {"no cluster": 1, "no loop": 2, "launch only": 3}
# (label, kind as chip_smoke._rand_weights names it, N, K)
SHAPES = (("mixtral gate/up q4-sm", "q4", 14336, 4096),
          ("mixtral down q6w-sp", "q6w", 4096, 14336),
          ("lm head q6w-sp", "q6w", 32000, 2048),
          ("lm head q8-sp", "q8", 32000, 2048),
          ("tinyllama down q6w-sp", "q6w", 2048, 5632),
          ("tinyllama wqk q4-sm", "q4", 2304, 2048))
ROWS = (1, 16, 32)


def _smoke():
    spec = importlib.util.spec_from_file_location("gemv_sweep_smoke", TREE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build_variants(defines: dict[str, list[str]], source: str = "qmm", fn: str = "tkq_qmm",
                   argtypes: list | None = None) -> dict[str, ctypes.CDLL]:
    """csrc/<source>.cu built once per entry (name -> extra nvcc flags), all
    in parallel, each loaded with its entry point `fn` declared (qmm's by
    default)."""
    from tpu_kquant_torch.ops import _build
    from tpu_kquant_torch.ops.qmm import _ARGTYPES

    VARIANTS.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, flags in defines.items():
        out = VARIANTS / f"{source}-{name.replace(' ', '_')}.so"
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, *flags, "-o", str(out),
               str(_build.CSRC / f"{source}.cu")]
        procs[name] = (out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"FAIL: nvcc {source}.cu {defines[name]}:\n{log}")
        lib = ctypes.CDLL(str(out))
        getattr(lib, fn).argtypes = argtypes or _ARGTYPES
        getattr(lib, fn).restype = ctypes.c_int
        lib.tkq_error_string.argtypes = [ctypes.c_int]
        lib.tkq_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def gemv(lib, x, qt, out_dtype, plan=None):
    """qmm's GEMV launch (ops/qmm.py:qmm at R <= 32) through `lib`, with the
    (chunks per split, splits) `plan` in place of gemv_plan's."""
    import torch

    from tpu_kquant_torch.ops import _build
    from tpu_kquant_torch.ops.qmm import gemv_plan, packed_arrays

    code, (qs, qh, scl, mins) = packed_arrays(qt, "gemv_sweep")
    N, K = qt.shape
    R = x.shape[0]
    cps, splits = plan or gemv_plan(code, N, K)
    out = torch.empty((R, N), dtype=out_dtype, device=x.device)
    ws = torch.empty(splits * R * N if splits > 1 else 0, dtype=torch.float32, device=x.device)
    P = _build.ptr
    opt = lambda t: None if t is None else P(t)  # noqa: E731
    rc = lib.tkq_qmm(code, P(x), 0, P(qs), opt(qh), P(scl), opt(mins), P(out),
                     int(out_dtype == torch.float32), P(ws), R, N, K, cps, splits, 0,
                     _build.stream_ptr(x.device))
    _build.check(lib, rc, "gemv_sweep")
    return out


def _weights(smoke, rng, kind, N, K, dev):
    w0 = smoke._rand_weights(rng, kind, N, K, dev)
    return smoke._rotation(w0, lambda: smoke._rand_weights(rng, kind, N, K, dev), w0.n_bytes)


def ablate(smoke, dev, libs) -> list:
    import numpy as np
    import torch

    out = []
    rng = np.random.default_rng(0)
    for label, kind, N, K in SHAPES[:4]:
        ws = _weights(smoke, rng, kind, N, K, dev)
        for R in ROWS:
            x = (torch.randn(R, K, device=dev)).to(torch.bfloat16)
            row = {"case": f"{label} R={R}"}
            for name, lib in libs.items():
                row[f"{name} ms"] = smoke.graph_ms(
                    lambda i, lib=lib: gemv(lib, x, ws[i % len(ws)], torch.bfloat16), 40)
            print(f"  ablate {row['case']:32s} " + ", ".join(
                f"{k} {v:.4f}" for k, v in row.items() if k != "case"), flush=True)
            out.append(row)
        del ws
    return out


def plan_sweep(smoke, dev) -> list:
    import numpy as np
    import torch

    from tpu_kquant_torch.ops import _build
    from tpu_kquant_torch.ops.qmm import (GEMV_MAX_ROWS, KIND_CODE, SEGMENTS, _ARGTYPES,
                                          _SMEM_CAP, gemv_plan, gemv_smem_bytes)

    lib = _build.load("qmm", "tkq_qmm", _ARGTYPES)
    out = []
    rng = np.random.default_rng(1)
    for label, kind, N, K in SHAPES:
        code = KIND_CODE[(kind, "sm" if kind == "q4" else "sp")]
        n_chunks = K // (32 * SEGMENTS[kind])
        plans = sorted({(-(-n_chunks // s), -(-n_chunks // -(-n_chunks // s)))
                        for s in range(1, n_chunks + 1)}, key=lambda p: p[1])
        plans = [p for p in plans if (p[1] == 1 or p[0] >= 2)
                 and gemv_smem_bytes(code, p[0], GEMV_MAX_ROWS) <= _SMEM_CAP][:16]
        ws = _weights(smoke, rng, kind, N, K, dev)
        for R in (1, 32):
            x = torch.randn(R, K, device=dev).to(torch.bfloat16)
            times = {p: smoke.graph_ms(
                lambda i, p=p: gemv(lib, x, ws[i % len(ws)], torch.bfloat16, p), 20)
                for p in plans}
            best = min(times, key=times.get)
            chosen = gemv_plan(code, N, K)
            row = {"case": f"{label} R={R}", "plan": chosen, "plan_ms": times[chosen],
                   "best": best, "best_ms": times[best],
                   "times": {f"{c}x{s}": t for (c, s), t in times.items()}}
            print(f"  plan {row['case']:32s} gemv_plan {chosen} {times[chosen]:.4f} ms, fastest "
                  f"{best} {times[best]:.4f} ms", flush=True)
            out.append(row)
        del ws
    return out


GATE_UP_SHAPES = (("tinyllama gate/up q4-sm", "q4", 5632, 2048),
                  ("tinyllama gate/up q8-sp", "q8", 5632, 2048),
                  ("qwen2.5-1.5b gate/up q4-sm", "q4", 8960, 1536),
                  ("qwen2.5-7b gate/up q4-sm", "q4", 18944, 3584))


def gate_up_sweep(smoke, dev) -> list:
    import numpy as np
    import torch

    from tpu_kquant_torch.ops import ffn
    from tpu_kquant_torch.ops.qmm import (GEMV_MAX_ROWS, KIND_CODE, SEGMENTS, _SMEM_CAP,
                                          gemv_smem_bytes)

    out = []
    rng = np.random.default_rng(2)
    plan = ffn.gate_up_plan
    for label, kind, F, dim in GATE_UP_SHAPES:
        code = KIND_CODE[(kind, "sm" if kind == "q4" else "sp")]
        n_chunks = dim // (32 * SEGMENTS[kind])
        plans = sorted({(-(-n_chunks // s), -(-n_chunks // -(-n_chunks // s)))
                        for s in range(1, n_chunks + 1)}, key=lambda p: p[1])
        plans = [p for p in plans if (p[1] == 1 or p[0] >= 2)
                 and gemv_smem_bytes(code, p[0], GEMV_MAX_ROWS, halves=2) <= _SMEM_CAP][:16]
        ws = _weights(smoke, rng, kind, 2 * F, dim, dev)
        nw = torch.rand(dim, device=dev) + 0.5
        for R in (1, 8):
            x = (torch.randn(R, dim, device=dev) * 0.5).to(torch.bfloat16)
            times = {}
            try:
                for p in plans:
                    ffn.gate_up_plan = lambda code, F, dim, p=p: p
                    times[p] = smoke.graph_ms(lambda i: ffn.gate_up(x, nw, 1e-5, ws[i % len(ws)]),
                                              20)
            finally:
                ffn.gate_up_plan = plan
            best = min(times, key=times.get)
            chosen = plan(code, F, dim)
            row = {"case": f"{label} R={R}", "plan": chosen, "plan_ms": times.get(chosen),
                   "best": best, "best_ms": times[best],
                   "times": {f"{c}x{s}": t for (c, s), t in times.items()}}
            print(f"  gate/up {row['case']:34s} gate_up_plan {chosen} "
                  f"{times.get(chosen, float('nan')):.4f} ms, fastest {best} {times[best]:.4f} ms; "
                  + " ".join(f"{s}:{t * 1e3:.1f}" for (c, s), t in times.items()), flush=True)
            out.append(row)
        del ws
    return out


# (label, qk kind, v kind as chip_smoke._rand_weights names them, D, heads,
# KV heads, head_dim, biases)
ATTN_IN_SHAPES = (("tinyllama q4-sm + q6w-sp", "q4", "q6w", 2048, 32, 4, 64, False),
                  ("tinyllama q8_0 q8-sp + q8-sp", "q8", "q8", 2048, 32, 4, 64, False),
                  ("qwen2.5-1.5b + biases, hd 128", "q4", "q6w", 1536, 12, 2, 128, True),
                  ("mixtral q4-f32 + q6w-f32", "q4f", "q6wf", 4096, 32, 8, 128, False),
                  ("mixtral q4-sm + q6w-sp", "q4", "q6w", 4096, 32, 8, 128, False))


def attn_in_sweep(smoke, dev) -> list:
    """Each case at every split count and ablation build, through the
    wrapper with its library swapped for the variant's."""
    import numpy as np
    import torch

    from tpu_kquant_torch.ops import attn_in as ai
    from tpu_kquant_torch.ops.qmm import SEGMENTS, gemv_smem_bytes, kernel_kind

    splits = {f"splits {s}": [f"-DTKQ_AI_SPLITS={s}"] for s in (1, 2, 4, 8)}
    abl = {name: [f"-DTKQ_GV_ABLATE={v}"] for name, v in ABLATIONS.items() if v}
    abl.update({name: [f"-DTKQ_AI_ABLATE={v}"] for name, v in AI_ABLATIONS.items()})
    libs = build_variants({**splits, **abl}, "attn_in", "tkq_attn_in", ai._ARGTYPES)
    real_load = ai._build.load
    out = []
    rng = np.random.default_rng(3)
    for label, kq, kv, D, H, Hkv, hd, biased in ATTN_IN_SHAPES:
        mk = lambda: (smoke._rand_weights(rng, kq, (H + Hkv) * hd, D, dev),  # noqa: E731
                      smoke._rand_weights(rng, kv, Hkv * hd, D, dev))
        w0 = mk()
        ws = smoke._rotation(w0, mk, sum(w.n_bytes for w in w0))
        plan = ai.attn_in_plan(kernel_kind(w0[0]), kernel_kind(w0[1]), w0[0].shape[0],
                               w0[1].shape[0], D)
        nw = torch.rand(D, device=dev) + 0.5
        bias = (torch.randn(w0[0].shape[0], device=dev), torch.randn(w0[1].shape[0], device=dev)) \
            if biased else None
        for R in (1, 16):
            x = (torch.randn(R, D, device=dev) * 0.5).to(torch.bfloat16)
            cos, sin = torch.rand(R, hd // 2, device=dev), torch.rand(R, hd // 2, device=dev)
            run = lambda i: ai.fused_attn_in(x, nw, 1e-5, *ws[i % len(ws)], cos, sin,  # noqa: E731
                                             hd, bias)
            row = {"case": f"{label} R={R}", "plan": plan, "full ms": smoke.graph_ms(run, 40)}
            for name, lib in libs.items():  # every split divides these shapes' chunks
                if name.startswith("splits"):
                    sp, nch = int(name.split()[1]), [D // (32 * SEGMENTS[w.kind]) for w in w0]
                    if any(c % sp or c // sp < ai.ATTN_IN_WK or gemv_smem_bytes(
                            kernel_kind(w), c // sp, R, halves=2) > SMEM_LIMIT
                           for c, w in zip(nch, w0)):
                        row[f"{name} ms"] = None  # a split the kernel does not take here
                        continue
                ai._build.load = lambda *a, lib=lib: lib
                try:
                    row[f"{name} ms"] = smoke.graph_ms(run, 40)
                finally:
                    ai._build.load = real_load
            print(f"  attn_in {row['case']:36s} plan {plan}: " + ", ".join(
                f"{k} {v:.4f}" for k, v in row.items() if k.endswith("ms") and v is not None),
                flush=True)
            out.append(row)
        del ws
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True, help="JSON file the results go to")
    for flag in ("ablate", "plan", "gate-up", "attn-in"):
        ap.add_argument(f"--{flag}", action="store_true")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("gemv_sweep needs a CUDA card")
    smoke = _smoke()
    dev = torch.device("cuda", 0)
    res = {"gpu": smoke.gpu_line()}
    print(f"== gemv_sweep [{res['gpu']}]", flush=True)
    if args.ablate:
        libs = build_variants({name: [f"-DTKQ_GV_ABLATE={v}"] for name, v in ABLATIONS.items()})
        res["ablate"] = ablate(smoke, dev, libs)
    if args.plan:
        res["plan"] = plan_sweep(smoke, dev)
    if args.gate_up:
        res["gate_up"] = gate_up_sweep(smoke, dev)
    if args.attn_in:
        res["attn_in"] = attn_in_sweep(smoke, dev)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(res, indent=1))
    print(f"== gemv_sweep done [{smoke.gpu_line()}]", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
