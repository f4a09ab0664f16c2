"""Measure the flash prefill kernel (csrc/prefill.cu, #8) on the card beyond
chip_smoke.py's phase 3, each number beside the card's name and power
limit:

    python3 -m tpu_kquant_torch.tools.prefill_sweep --out FILE.json \\
        [--check] [--rows] [--ablate] [--crossover]

--check      build csrc/prefill.cu with the mbarrier watchdog
             (hopper.cuh: a deadlocked pipeline traps instead of hanging)
             and hold it to attention_prefill_plain at every phase-3 case
             and every row grouping; the first run of a new kernel.
--rows       the row-grouping sweep behind ops/prefill.py:heads_per_group:
             CUDA-graph ms per call of every divisor hw of the GQA group at
             phase 3's cases.
--ablate     variants built with TKQ_PF_ABLATE (1: no softmax, 2: no P V,
             3: loads and barriers only, 4: the other tile order: a tile's
             softmax overlapped with the previous tile's P V where the
             kernel runs them in turn, and the reverse) beside the full
             kernel at phase 3's T = S = 2048 cases.
--crossover  ops/attention.py's plain branch (the budget raised) beside the
             kernel at TinyLlama's pp512 layer (T 512, S 704) and bucket 1024
             (T = S = 1024), the data for ATTN_PLAIN_MAX_MB.

Inputs and timing are chip_smoke.py's (check_prefill's cache views, graph_ms
over 20 launches). Variant libraries are built with ops/_build.py's flags
under .cache/prefill_variants. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import subprocess
from pathlib import Path

TREE = Path(__file__).resolve().parents[2]
VARIANTS = TREE / ".cache" / "prefill_variants"
ABLATIONS = {"full": 0, "no softmax": 1, "no P V": 2, "loads only": 3, "other order": 4}


def _smoke():
    spec = importlib.util.spec_from_file_location("prefill_sweep_smoke", TREE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build_variants(defines: dict[str, list[str]]) -> dict[str, ctypes.CDLL]:
    """csrc/prefill.cu built once per entry (name -> extra nvcc flags), all
    in parallel, each loaded with its entry point declared."""
    from tpu_kquant_torch.ops import _build
    from tpu_kquant_torch.ops.prefill import _ARGTYPES

    VARIANTS.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, flags in defines.items():
        out = VARIANTS / f"prefill-{name.replace(' ', '_')}.so"
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, *flags, "-o", str(out),
               str(_build.CSRC / "prefill.cu")]
        procs[name] = (out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"FAIL: nvcc prefill.cu {defines[name]}:\n{log}")
        lib = ctypes.CDLL(str(out))
        lib.tkq_prefill.argtypes = _ARGTYPES
        lib.tkq_prefill.restype = ctypes.c_int
        lib.tkq_error_string.argtypes = [ctypes.c_int]
        lib.tkq_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def case_inputs(smoke, case, dev, seed: int = 0):
    """One chip_smoke.PREFILL_CASES case's inputs as check_prefill makes
    them: K/V strided views of a 2-layer cache with 64 spare slots."""
    import torch

    label, B, T, S, starts, int8, window, (H, Hkv, D), q_dtype = case
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, T, H, D, device=dev, generator=g).to(getattr(torch, q_dtype))
    shape = (2, B, Hkv, S + 64, D)
    if int8:
        kc, vc = (torch.randint(-127, 128, shape, device=dev, generator=g, dtype=torch.int8)
                  for _ in range(2))
        ksc, vsc = (torch.rand(shape[:-1], device=dev, generator=g) * 0.02 + 0.001
                    for _ in range(2))
        scales = (ksc[1, :, :, :S], vsc[1, :, :, :S])
    else:
        kc, vc = (torch.randn(shape, device=dev, generator=g).to(torch.bfloat16)
                  for _ in range(2))
        scales = None
    return q, kc[1, :, :, :S], vc[1, :, :, :S], torch.tensor(starts, device=dev), scales, window


def _divisors(G: int) -> list[int]:
    return [d for d in range(1, min(G, 64) + 1) if G % d == 0]


def check(smoke, dev, lib) -> list:
    import torch

    from tpu_kquant_torch.ops.prefill import _launch, attention_prefill_plain

    rows = []
    for case in smoke.PREFILL_CASES:
        q, k, v, qs, sc, window = case_inputs(smoke, case, dev)
        ref = attention_prefill_plain(q, k, v, qs, sc, sliding_window=window)
        qb = q.to(torch.bfloat16)
        for hw in _divisors(q.shape[2] // k.shape[1]):
            got = _launch(qb, k, v, qs, sc, q.shape[-1] ** -0.5, window, lib=lib, hw=hw)
            torch.cuda.synchronize()
            err = smoke.row_rel_err(got, ref)
            rows.append({"case": case[0], "hw": hw, "rel_err": err})
            print(f"  check {case[0]:70s} hw {hw:2d}: row rel err {err:.2e}", flush=True)
            if not err < smoke.TOL:
                raise SystemExit(f"FAIL: prefill at {case[0]}, hw {hw}: {err}")
        del ref
        torch.cuda.empty_cache()
    return rows


def rows_sweep(smoke, dev) -> list:
    import torch

    from tpu_kquant_torch.ops.prefill import _launch, heads_per_group

    out = []
    for case in smoke.PREFILL_CASES:
        q, k, v, qs, sc, window = case_inputs(smoke, case, dev)
        qb, G = q.to(torch.bfloat16), q.shape[2] // k.shape[1]
        row = {"case": case[0], "default_hw": heads_per_group(G)}
        for hw in _divisors(G):
            row[f"hw{hw}_ms"] = smoke.graph_ms(
                lambda i, hw=hw: _launch(qb, k, v, qs, sc, q.shape[-1] ** -0.5, window, hw=hw), 20)
        print(f"  rows {case[0]:70s} " + " ".join(
            f"{key} {val:.4f}" for key, val in row.items() if key.endswith("_ms")), flush=True)
        out.append(row)
    return out


def ablate(smoke, dev, libs) -> list:
    import torch

    from tpu_kquant_torch.ops.prefill import _launch

    out = []
    for case in smoke.PREFILL_CASES:
        if case[2] != 2048 or case[3] != 2048:
            continue
        q, k, v, qs, sc, window = case_inputs(smoke, case, dev)
        qb = q.to(torch.bfloat16)
        row = {"case": case[0]}
        for name, lib in libs.items():
            row[f"{name} ms"] = smoke.graph_ms(
                lambda i, lib=lib: _launch(qb, k, v, qs, sc, q.shape[-1] ** -0.5, window,
                                           lib=lib), 20)
        print(f"  ablate {case[0]:50s} " + ", ".join(
            f"{key} {val:.4f}" for key, val in row.items() if key != "case"), flush=True)
        out.append(row)
    return out


def crossover(smoke, dev) -> list:
    import torch

    from tpu_kquant_torch.ops import attention as att
    from tpu_kquant_torch.ops.prefill import attention_prefill

    out = []
    for label, T, S in (("TinyLlama pp512 layer", 512, 704), ("TinyLlama bucket 1024", 1024, 1024),
                        ("TinyLlama bucket 2048", 2048, 2048)):
        case = (label, 1, T, S, [0], False, 0, smoke.TINY_HEADS, "bfloat16")
        q, k, v, qs, sc, _ = case_inputs(smoke, case, dev)
        pos = torch.arange(T, device=dev)[None]
        budget = att.ATTN_PLAIN_MAX_MB
        att.ATTN_PLAIN_MAX_MB = 1e9  # the plain branch at any size
        try:
            plain = smoke.graph_ms(lambda i: att.attention_decode(q, k, v, pos), 5)
        finally:
            att.ATTN_PLAIN_MAX_MB = budget
        flash = smoke.graph_ms(lambda i: attention_prefill(q, k, v, qs), 20)
        row = {"case": label, "T": T, "S": S, "logits_mb": att.logits_mb(1, T, 32, S),
               "plain_ms": plain, "flash_ms": flash}
        print(f"  crossover {label:24s} logits {row['logits_mb']:.1f} MB: plain {plain:.4f} ms, "
              f"flash {flash:.4f} ms", flush=True)
        out.append(row)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True, help="JSON file the results go to")
    for flag in ("check", "rows", "ablate", "crossover"):
        ap.add_argument(f"--{flag}", action="store_true")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("prefill_sweep needs a CUDA card")
    smoke = _smoke()
    dev = torch.device("cuda", 0)
    res = {"gpu": smoke.gpu_line()}
    print(f"== prefill_sweep [{res['gpu']}]", flush=True)
    if args.check:
        lib = build_variants({"watchdog": ["-DTKQ_MBAR_WATCHDOG"]})["watchdog"]
        res["check"] = check(smoke, dev, lib)
    if args.rows:
        res["rows"] = rows_sweep(smoke, dev)
    if args.ablate:
        libs = build_variants({name: [f"-DTKQ_PF_ABLATE={v}"] for name, v in ABLATIONS.items()})
        res["ablate"] = ablate(smoke, dev, libs)
    if args.crossover:
        res["crossover"] = crossover(smoke, dev)
    res["gpu_after"] = smoke.gpu_line()
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(res, indent=1))
    print(f"== prefill_sweep done [{res['gpu_after']}]", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
