"""Time qmm's tile path and the rates it moves, for the package of a given
checkout, so that two checkouts (a parent commit unpacked beside this one)
can be compared in one run on one card:

    python3 tpu_kquant_torch/tools/tile_ab.py --root DIR --tag NAME --out FILE.json

``--root`` names the checkout whose ``tpu_kquant_torch`` is imported and
timed (its kernels built under DIR/.cache); the cases and the timing code
come from this checkout's ``chip_smoke.py``, so both sides run the same
shapes. Measured, each on the card with its name and power limit:
- qmm's tile (R > 32) at every weight shape of chip_smoke.py's TILE_CASES
  at R = 64 (a lone 64-token prompt), 512 (pp512), 1024 (the 16 x 64 burst
  and the 1024-slot tick) and 2048 (pp2048) (CUDA-graph ms per call over
  copies of the weight that exceed L2 twice, as phase 3 times them), each
  with its plan (block height, K splits) and its error against qmm_plain;
  ``--tile-nosplit`` times the candidate tile plan of one split at every R
  (the timed package's tile_plan patched to it) under its own tag;
- TinyLlama-1.1B (Q4_K_M fixture, seed 0, full depth): pp512 and pp2048
  (medians of 3 after a warm run), and the 1024-slot serving tick (1024
  requests of tools_serve_bench.py's mix admitted as one burst on 1024
  slots of 2048, bf16 KV: ms per tick after the first);
- Mixtral-8x7B at chip_smoke.MIXTRAL_DEPTH layers: pp512 (bf16 pairs,
  impl "auto");
- the flash prefill kernel (#8) at every phase-3 case (chip_smoke.py's
  check_prefill: CUDA-graph and eager ms, its plain version, SDPA, the
  bound, the error per row), the 1024-request burst among them; the
  burst's wall time end to end is the tick section's burst + first tick;
- the decode GEMV (csrc/gemv.cuh): every qmm case of phase 3 with R <= 32
  (chip_smoke.py's check_qmm: graph and eager ms, plain, torch.matmul on
  the dequantized weight, the bound, the error), qmm_int8's cases
  (check_qmm_int8) and the fused kernels whose o_proj / down steps it runs
  (check_fused_ffn: attn_in, oproj_ffn, ffn; check_fused_decode: kv_append,
  attn_out, layer, rot), the gate/up phase alone (ops/ffn.py:gate_up,
  where the timed package has it) beside oproj_ffn and ffn, and the
  attention phase of attn_out and layer alone (ops/decode_attention.py:
  fused_attention, where the timed package has it);
- flash decode (#7) at every DECODE_CASES case of phase 3 (chip_smoke.py's
  check_decode_attn: graph and eager ms, plain, SDPA, the bound, the error
  per row).
The sections are qmm, prefill, tiny, tick, mixtral, gemv, int8, fused and
decode; ``--skip`` leaves some out. ``--profile DIR`` also runs
chip_smoke.py's profile_steps on TinyLlama-1.1B (one pp512 prefill and 8
decode steps under torch.profiler at 704 slots: busy shares logged, kernel
tables into DIR/profile_*_TAG.txt).
So one call can time a parent's checkout and this one in turns (parent,
change, change, parent):

    mkdir -p .cache/parent && git archive HEAD | tar -x -C .cache/parent
    for side in .cache/parent . . .cache/parent; do
        python3 tpu_kquant_torch/tools/tile_ab.py --root $side --tag $side ...
    done
Fixtures are chip_smoke.py's (seed 0, Q4_K_M), written once under
``--fixtures`` (default: where chip_smoke.py writes them) and shared by
both sides. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

TREE = Path(__file__).resolve().parents[2]


def _smoke():
    spec = importlib.util.spec_from_file_location("tile_ab_smoke", TREE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _fixture(cfg0, path: Path, dev):
    import os

    import torch

    from tpu_kquant_torch.models.fixtures import write_fixture_gguf
    from tpu_kquant_torch.runtime.loader import load_model

    if not path.exists():
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        write_fixture_gguf(tmp, cfg0, seed=0, recipe="q4_k_m")
        os.replace(tmp, path)
    cfg, params, _ = load_model(str(path), device=dev)
    torch.cuda.synchronize()
    return cfg, params


def _prefill_ms(eng, prompt) -> list:
    import torch

    eng.prefill([prompt], eng.new_cache(1))  # warm
    out = []
    for _ in range(3):
        cache = eng.new_cache(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, _, _ = eng.prefill([prompt], cache)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
        if not torch.isfinite(logits).all():
            raise SystemExit("FAIL: prefill logits are not finite")
    return out


TILE_ROWS = (64, 512, 1024, 2048)


def qmm_cases(smoke, dev) -> list:
    import numpy as np
    import torch

    from tpu_kquant_torch.models.fixtures import random_packed
    from tpu_kquant_torch.ops import qmm as qmm_mod
    from tpu_kquant_torch.ops.qmm import KIND_CODE, qmm, qmm_plain

    rng = np.random.default_rng(0)
    out = []
    shapes = {}
    for label, kind, N, K, R, xdt, odt in smoke.TILE_CASES:
        shapes.setdefault((kind, N, K, xdt, odt), label.rsplit(" R=", 1)[0])
    for (kind, N, K, xdt, odt), label in shapes.items():
        xdt = torch.float32 if xdt == "f32" else torch.bfloat16
        odt = torch.float32 if odt == "f32" else torch.bfloat16
        base, f32 = (kind[:-1], True) if kind.endswith("f") else (kind, False)
        code = KIND_CODE[(base, "f32" if f32 else "sp" if base in ("q6w", "q8") else "sm")]

        def make():
            return random_packed(rng, base, N, K, f32=f32).to(dev)

        w0 = make()
        n = min(32, max(1, math.ceil(2 * smoke.L2_BYTES / w0.n_bytes)))
        ws = [w0] + [make() for _ in range(n - 1)]
        for R in TILE_ROWS:
            x = torch.randn(R, K, device=dev).to(xdt)
            got = qmm(x, w0, odt)
            ref = qmm_plain(x, w0, odt)
            rel = ((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item()
            ms = smoke.graph_ms(lambda i: qmm(x, ws[i % len(ws)], odt), 40)
            bm, _, splits, _ = qmm_mod.tile_plan(R, N, K, code)
            case = f"{label} R={R}"
            out.append({"case": case, "R": R, "ms": ms, "rel_err": rel, "bm": bm,
                        "splits": splits})
            print(f"  qmm {case:52s} {ms * 1e3:9.2f} us  (bm {bm}, {splits} split"
                  f"{'s' if splits > 1 else ''})  rel err {rel:.2e}", flush=True)
        del ws
    return out


def _one_split(qmm_mod):
    """Patch the timed package's tile_plan to the candidate of one split at
    every R (the block height as its own plan picks it)."""
    plan = qmm_mod.tile_plan

    def one_split(R, N, K, code):
        bm, bn, _, _ = plan(R, N, K, code)
        return bm, bn, 1, -(-K // qmm_mod.TILE_BK)

    qmm_mod.tile_plan = one_split


def _report(name: str, cases: list) -> list:
    """Print phase-3 case dicts (ms per call, the yardsticks, the error) and
    return them."""
    for c in cases:
        lib = c["library_ms"] if c["library_ms"] is not None else c.get("matmul_ms")
        bad = "" if c["rel_err"] <= c.get("tol", 2e-2) else "  FAIL: beyond its tolerance"
        print(f"  {name} {c['case']:60s} {c['ms'] * 1e3:9.2f} us  (eager "
              f"{c['eager_ms'] * 1e3:8.2f})  library {lib * 1e3:8.2f} us  bound "
              f"{c['bound_ms'] * 1e3:7.2f} us  rel err {c['rel_err']:.2e}{bad}", flush=True)
    return cases


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True, help="checkout whose tpu_kquant_torch is timed")
    ap.add_argument("--tag", required=True)
    ap.add_argument("--out", required=True, help="JSON file the results go to")
    ap.add_argument("--fixtures", default=str(TREE / ".cache" / "tkq_torch_fixture_vocab"))
    ap.add_argument("--skip", default="",
                    help="comma list of: qmm, prefill, tiny, tick, mixtral, gemv, int8, fused, "
                         "decode")
    ap.add_argument("--profile", type=Path, metavar="DIR",
                    help="also profile TinyLlama's pp512 prefill and 8 decode steps")
    ap.add_argument("--tile-nosplit", action="store_true",
                    help="time the tile plan of one split at every R (a candidate plan)")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import numpy as np
    import torch

    import tpu_kquant_torch
    from tpu_kquant_torch.models.fixtures import mixtral_8x7b_config, tinyllama_1b_config
    from tpu_kquant_torch.ops import _build
    from tpu_kquant_torch.runtime.engine import InferenceEngine
    from tpu_kquant_torch.serving import ContinuousBatcher

    if not torch.cuda.is_available():
        raise SystemExit("tile_ab needs a CUDA card")
    smoke = _smoke()
    dev = torch.device("cuda", 0)
    skip = set(filter(None, args.skip.split(",")))
    res = {"tag": args.tag, "package": str(Path(tpu_kquant_torch.__file__).parent),
           "gpu": smoke.gpu_line()}
    print(f"== tile_ab {args.tag}: {res['package']} [{res['gpu']}]", flush=True)
    t0 = time.perf_counter()
    res["build_s"] = _build.build_all()
    print(f"  build {res['build_s']:.1f} s", flush=True)
    fx = Path(args.fixtures)
    if args.tile_nosplit:
        from tpu_kquant_torch.ops import qmm as qmm_mod

        _one_split(qmm_mod)
        res["tile_plan"] = "one split"
    if "decode" not in skip:
        res["decode"] = _report("decode", smoke.check_decode_attn(dev))
    if "qmm" not in skip:
        res["qmm"] = qmm_cases(smoke, dev)
    if "gemv" not in skip:
        cases = [c for c in smoke.qmm_cases() if c[4] <= 32]
        res["gemv"] = _report("gemv", smoke.check_qmm(dev, np.random.default_rng(0), cases))
    if "int8" not in skip:
        res["qmm_int8"] = _report("qmm_int8", smoke.check_qmm_int8(dev, np.random.default_rng(0)))
    if "fused" not in skip:
        rng = np.random.default_rng(0)
        fused = smoke.check_fused_ffn(dev, rng)
        fused.update(smoke.check_fused_decode(dev, rng))
        res["fused"] = {k: _report(k, v) for k, v in fused.items()}
    if "prefill" not in skip:
        res["prefill"] = smoke.check_prefill(dev)
        for c in res["prefill"]:
            print(f"  prefill {c['case']:70s} {c['ms'] * 1e3:9.2f} us  SDPA "
                  f"{c['library_ms'] * 1e3:9.2f} us  row rel err {c['rel_err']:.2e}", flush=True)
    if not {"tiny", "tick"} <= skip or args.profile:
        cfg, params = _fixture(tinyllama_1b_config(), fx / "tinyllama-1.1b-q4_k_m-seed0.gguf",
                               dev)
        if args.profile:
            eng = InferenceEngine(cfg, params, max_batch=1, max_seq=704, device=dev)
            tag = "".join(c if c.isalnum() else "_" for c in args.tag)
            smoke.profile_steps(eng, cfg, dev, args.profile, tag=f"_{tag}")
            del eng
        rng = np.random.default_rng(2)
        if "tiny" not in skip:
            for n, max_seq in ((512, 704), (2048, 2240)):
                eng = InferenceEngine(cfg, params, max_batch=1, max_seq=max_seq, device=dev)
                ms = _prefill_ms(eng, rng.integers(10, cfg.vocab_size, n).tolist())
                res[f"pp{n}_ms_all"] = ms
                res[f"pp{n}_tok_s"] = n / (sorted(ms)[1] / 1e3)
                print(f"  pp{n}: {res[f'pp{n}_tok_s']:.1f} tok/s (runs {ms} ms)", flush=True)
                del eng
        if "tick" not in skip:
            rng = np.random.default_rng(8)
            reqs = [smoke.serve_request(i, cfg, rng, greedy=i % 16 < 3) for i in range(1024)]
            eng = InferenceEngine(cfg, params, max_batch=1024, max_seq=2048, device=dev)
            cb = ContinuousBatcher(eng)
            for r in reqs:
                cb.submit(r)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            cb.step()  # the burst and the first tick
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            cb.run()
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            ticks = cb.stats["steps"]
            res["tick_ms"] = (t3 - t2) / (ticks - 1) * 1e3
            res["burst_and_first_tick_s"] = t2 - t1
            res["serve_tok_s"] = cb.stats["tokens_out"] / (t3 - t1)
            print(f"  1024 slots: {ticks} ticks, {res['tick_ms']:.2f} ms/tick after the "
                  f"first; burst + first tick {t2 - t1:.3f} s; {res['serve_tok_s']:.1f} tok/s",
                  flush=True)
            del eng, cb
        del params
        torch.cuda.empty_cache()
    if "mixtral" not in skip:
        cfg0 = dataclasses.replace(mixtral_8x7b_config(), n_layers=smoke.MIXTRAL_DEPTH)
        cfg, params = _fixture(cfg0, fx / f"mixtral-8x7b-{smoke.MIXTRAL_DEPTH}l-q4_k_m-seed0.gguf",
                               dev)
        eng = InferenceEngine(cfg, params, max_batch=1, max_seq=704, device=dev)
        ms = _prefill_ms(eng, np.random.default_rng(2).integers(10, cfg.vocab_size, 512).tolist())
        res["mixtral_pp512_ms_all"] = ms
        res["mixtral_pp512_tok_s"] = 512 / (sorted(ms)[1] / 1e3)
        print(f"  mixtral pp512: {res['mixtral_pp512_tok_s']:.1f} tok/s (runs {ms} ms)",
              flush=True)
        del eng, params
    res["seconds"] = time.perf_counter() - t0
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(res, indent=1))
    print(f"== tile_ab {args.tag} done in {res['seconds']:.1f} s [{smoke.gpu_line()}]", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
