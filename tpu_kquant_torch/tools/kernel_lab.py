"""Kernel-lab CLI: the qmm mutation ladder and tile sweeps
(``tpu_kquant_torch/utils/kernel_lab.py``) at model shapes, one JSON row per
(tensor, geometry, tile, rung) on stdout, the log on stderr.

Counterpart of the root ``tools_kernel_lab.py``, with ``--device`` and
``--manual`` (the manual ring kernel's dma and full rungs on q4 tensors).

  python -m tpu_kquant_torch.tools.kernel_lab --model tiny --tensor wqk --manual
  python -m tpu_kquant_torch.tools.kernel_lab --model tiny --tensor all --json-out lab.json
  python -m tpu_kquant_torch.tools.kernel_lab --model toy --device cpu --tks 64 --tns 128

Without a card it raises unless ``--device cpu`` is given (the plain
versions; no device measurement).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

from tpu_kquant_torch.tools.kernel_bench import MODELS, mk_q4, mk_q6w
from tpu_kquant_torch.utils.kernel_lab import MODES, run_ladder


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def tensors_for(model: str, rng, device=None) -> dict:
    """The lab's zoo at a model's shapes: {name: (QTensor, scale format)},
    drawn in the reference's order from ``rng``."""
    m = MODELS[model]
    D, H, Hkv, hd, F, V = m["D"], m["H"], m["Hkv"], m["hd"], m["F"], m["V"]
    return {
        "wqk": (mk_q4((H + Hkv) * hd, D, rng, device=device), "sm"),
        "wv": (mk_q6w(Hkv * hd, D, rng, device=device), "sp"),
        "wo": (mk_q4(D, H * hd, rng, device=device), "sm"),
        "gu": (mk_q4(2 * F, D, rng, device=device), "sm"),
        "dn": (mk_q6w(D, F, rng, device=device), "sp"),
        "head": (mk_q6w(V, D, rng, device=device), "sp"),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="tiny", choices=list(MODELS))
    ap.add_argument("--tensor", default="wqk", help="wqk|wv|wo|gu|dn|head|all (comma-separable)")
    ap.add_argument("--rows", type=int, default=1)
    ap.add_argument("--modes", default=",".join(MODES))
    ap.add_argument("--tks", default="256,512,1024")
    ap.add_argument("--tns", default="256,512")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--target-s", type=float, default=0.03,
                    help="kernel seconds per chain at the memory roofline (chain length)")
    ap.add_argument("--manual", action="store_true",
                    help="also the manual ring kernel (dma, full) on the q4 tensors")
    ap.add_argument("--json-out", default="")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("kernel_lab: no CUDA card; pass --device cpu to run the plain "
                           "versions on the CPU")
    dev = torch.device("cuda", 0) if args.device == "cuda" else torch.device("cpu")
    dev_name = torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu"
    log(f"device: {dev_name}")
    zoo = tensors_for(args.model, np.random.default_rng(0), device=dev)
    names = list(zoo) if args.tensor == "all" else args.tensor.split(",")
    rows = []
    for name in names:
        qt, s_fmt = zoo[name]
        log(f"=== {args.model} {name}: {qt.kind} {qt.shape} ({s_fmt}) ===")
        rs = run_ladder(qt, s_fmt, R=args.rows,
                        tks=tuple(int(t) for t in args.tks.split(",")),
                        tns=tuple(int(t) for t in args.tns.split(",")),
                        modes=tuple(args.modes.split(",")), log=log, reps=args.reps,
                        manual=args.manual, target_s=args.target_s)
        for r in rs:
            r["tensor"] = name
            r["model"] = args.model
            r["device"] = dev_name
        rows += rs
    if args.json_out:
        Path(args.json_out).write_text(json.dumps(rows, indent=1))
    print(json.dumps(rows))
    return rows


if __name__ == "__main__":
    main()
