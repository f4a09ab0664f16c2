"""Prefill-attention lab CLI: variants A, B and G of causal GQA prefill
attention (``tpu_kquant_torch/utils/prefill_lab.py``, kernels #17-#19) at
their sweep points, beside the flash prefill kernel #8 and SDPA, one JSON
row per (shape, variant, tq, ts) on stdout, the log on stderr.

Counterpart of the root ``tools_prefill_lab.py`` (variant ``prod``: the
production kernel; the port's #8 has one 64 x 64 tiling, so it is timed at
that tiling alone, where the reference swept its TPU tiles),
``tools_prefill_lab2.py`` (``a``, ``b``) and ``tools_prefill_lab3.py`` (``g``).

  python -m tpu_kquant_torch.tools.prefill_lab --shape tiny-pp512 --variant all
  python -m tpu_kquant_torch.tools.prefill_lab --shape qwen-pp512 --variant b --json-out lab.json
  python -m tpu_kquant_torch.tools.prefill_lab --shape toy --device cpu --iters 2

Without a card it raises unless ``--device cpu`` is given (the plain
versions; no device measurement).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

from tpu_kquant_torch.utils.prefill_lab import SHAPES, lab_inputs, run_sweep

VARIANTS = ("prod", "a", "b", "g")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variant", default="all", choices=[*VARIANTS, "all"])
    ap.add_argument("--shape", default="tiny-pp512", help="|".join(SHAPES) + " (comma-separable)")
    ap.add_argument("--iters", type=int, default=32, help="time_chained's chain length")
    ap.add_argument("--json-out", default="")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("prefill_lab: no CUDA card; pass --device cpu to run the plain "
                           "versions on the CPU")
    dev = torch.device("cuda", 0) if args.device == "cuda" else torch.device("cpu")
    dev_name = torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu"
    log(f"device: {dev_name}")
    variants = VARIANTS if args.variant == "all" else (args.variant,)
    rows = []
    for shape in args.shape.split(","):
        cfg = SHAPES[shape]
        log(f"=== {shape}: {cfg} ===")
        if "prod" in variants:
            log("prod is the flash prefill kernel (#8) at its one 64 x 64 tiling")
        q, k, v, qs = lab_inputs(cfg, dev)
        rs = run_sweep(q, k, v, qs, variants=variants, n_iter=args.iters, log=log)
        for r in rs:
            r["shape"] = shape
            r["device"] = dev_name
        rows += rs
    if args.json_out:
        Path(args.json_out).write_text(json.dumps(rows, indent=1))
    for r in rows:
        print(json.dumps(r))
    return rows


if __name__ == "__main__":
    main()
