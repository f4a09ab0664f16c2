"""llama-bench's counterpart: pp / tg tests and a mean ± σ markdown table,
the port of ``tpu_kquant.tools.bench_cli``:

| model | size | params | backend | test | t/s |

The backend column names the card (torch.cuda.get_device_name()), or "cpu"
under ``--device cpu``, whose numbers time PyTorch's CPU kernels and are
no device measurement. Each timed part ends by reading a value back and
``torch.cuda.synchronize()``. Every rep clears one cache (zeroes it, as
llama-bench clears its KV cache), so on the card the decode loop's captured
step (runtime.graphs) is captured in the warm-up rep and replayed in the
timed ones.

Usage:
  python -m tpu_kquant_torch.tools.bench_cli -m M.gguf -p 512 -n 128 -r 2 [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import statistics
import time

import numpy as np
import torch


def _sync(x: torch.Tensor) -> float:
    v = float(x.float().sum())
    if x.is_cuda:
        torch.cuda.synchronize()
    return v


def run_bench(model_path: str, pp: int, tg: int, batch: int, reps: int, impl: str,
              scale_dtype: str = "bf16", device: str = "cuda"):
    """Returns (cfg, size MiB, parameter count, pp t/s per rep, tg t/s per
    rep); rep 0 is a warm-up and is not kept."""
    from tpu_kquant_torch.runtime.engine import InferenceEngine
    from tpu_kquant_torch.runtime.graphs import cache_tensors
    from tpu_kquant_torch.runtime.loader import load_model

    cfg, params, reader = load_model(model_path, scale_dtype=scale_dtype, device=device)
    n_params = sum(int(np.prod(ti.shape)) for ti in reader.tensors.values())
    size_mib = os.path.getsize(model_path) / (1 << 20)
    eng = InferenceEngine(cfg, params, max_batch=batch,
                          max_seq=min(cfg.max_seq_len, pp + tg + 64), impl=impl, device=device)
    rng = np.random.default_rng(0)
    pps, tgs = [], []
    cache = eng.new_cache(batch)
    for rep in range(reps + 1):  # rep 0: warm-up
        prompt = rng.integers(10, cfg.vocab_size, pp).tolist()
        rows = [prompt] * batch
        for t in cache_tensors(cache):
            t.zero_()
        _sync(cache.ssm[0, 0, 0] if cfg.is_recurrent else cache.k[0, 0, 0, 0])
        t0 = time.time()
        logits, cache, lens = eng.prefill(rows, cache)
        _sync(logits)
        pp_tps = pp * batch / (time.time() - t0)
        tok = torch.argmax(logits, dim=-1)
        t0 = time.time()
        toks, cache = eng.decode_greedy(tok, eng._tensor(lens), cache, tg)
        _sync(toks)
        tg_tps = tg * batch / (time.time() - t0)
        if rep > 0:
            pps.append(pp_tps)
            tgs.append(tg_tps)
    return cfg, size_mib, n_params, pps, tgs


def fmt_row(name, size_mib, n_params, backend, test, vals):
    mean = statistics.mean(vals)
    sd = statistics.stdev(vals) if len(vals) > 1 else 0.0
    return (f"| {name} | {size_mib:.2f} MiB | {n_params/1e9:.2f} B | {backend} "
            f"| {test} | {mean:.2f} ± {sd:.2f} |")


def main(argv=None) -> list[str]:
    ap = argparse.ArgumentParser(description="tpu-kquant bench (llama-bench format)")
    ap.add_argument("--model", "-m", required=True)
    ap.add_argument("-p", "--pp", type=int, default=512)
    ap.add_argument("-n", "--tg", type=int, default=128)
    ap.add_argument("-b", "--batch", type=int, default=1)
    ap.add_argument("-r", "--reps", type=int, default=3)
    ap.add_argument("--impl", default="auto")
    ap.add_argument("--scale-dtype", default="bf16", choices=["bf16", "f32", "f16"])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    from tpu_kquant_torch.runtime.loader import resolve_device

    dev = resolve_device(args.device)
    backend = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    cfg, size_mib, n_params, pps, tgs = run_bench(
        args.model, args.pp, args.tg, args.batch, args.reps, args.impl, args.scale_dtype,
        args.device)
    name = f"{cfg.arch} {n_params/1e9:.1f}B Q4_K_M"
    lines = ["| model | size | params | backend | test | t/s |",
             "| ----- | ---: | -----: | ------- | ---- | --: |",
             fmt_row(name, size_mib, n_params, backend, f"pp{args.pp}", pps),
             fmt_row(name, size_mib, n_params, backend, f"tg{args.tg}", tgs)]
    print("\n".join(lines))
    return lines


if __name__ == "__main__":
    main()
