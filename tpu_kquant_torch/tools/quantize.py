"""GGUF requantization, the port of ``tpu_kquant.tools.quantize`` (the
llama-quantize equivalent): reads any GGUF, re-encodes each tensor by a
recipe, writes a new GGUF. Norm vectors stay F32; Q4_K_M is llama.cpp's mix
(attn_v, ffn_down and output in Q6_K). On the card (the default) Q4_K, Q6_K
and Q8_0 are encoded by ``ops/quantize.py``'s kernels, the other types by
the NumPy code; the bytes are the same either way.

  python -m tpu_kquant_torch.tools.quantize --in f16.gguf --out q4.gguf --type q4_k_m [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from tpu_kquant_torch.gguf import GGMLType, GGUFReader, GGUFWriter
from tpu_kquant_torch.gguf.constants import block_size
from tpu_kquant_torch.quant import numpy_codecs
from tpu_kquant_torch.quant.repack import dequantize

RECIPES = {
    "q4_k_m": None,  # mixed; see target_type
    "q4_k_s": None,
    "q8_0": GGMLType.Q8_0,
    "q6_k": GGMLType.Q6_K,
    "q5_k_m": None,
    "q3_k_m": None,  # mixed: Q3_K base, Q4_K / Q5_K bumps (llama.cpp-style)
    "q2_k": None,  # mixed: Q2_K base, Q4_K attn_v (llama.cpp's Q2_K)
    "f16": GGMLType.F16,
    "bf16": GGMLType.BF16,
}


def target_type(name: str, shape, recipe: str) -> GGMLType:
    """The type of tensor ``name`` under ``recipe`` (the reference's
    ``_target_type``). The substring ``"output.weight"`` also matches
    ``attn_output.weight``, as in the reference."""
    if name.endswith("_norm.weight") or len(shape) == 1:
        return GGMLType.F32
    uniform = RECIPES.get(recipe)
    if uniform is not None:
        t = uniform
    elif recipe == "q2_k":
        t = GGMLType.Q2_K
        if "attn_v" in name:
            t = GGMLType.Q4_K
        elif "output.weight" in name:
            t = GGMLType.Q6_K
    elif recipe == "q3_k_m":
        t = GGMLType.Q3_K
        if any(s in name for s in ("attn_v", "ffn_down", "attn_output")):
            t = GGMLType.Q4_K
        elif "output.weight" in name:
            t = GGMLType.Q5_K
    else:
        t = GGMLType.Q5_K if recipe == "q5_k_m" else GGMLType.Q4_K
        if recipe.endswith("_m") and any(
                s in name for s in ("attn_v", "ffn_down", "output.weight")):
            t = GGMLType.Q6_K
    if shape[-1] % block_size(t) != 0:  # block-size feasibility fallbacks
        return GGMLType.Q8_0 if shape[-1] % 32 == 0 else GGMLType.F16
    return t


def _encoder(reader: GGUFReader, name: str, target: GGMLType, dev: torch.device,
             seconds: dict):
    """The zero-argument callable that makes tensor ``name``'s new bytes
    when the writer asks for them, adding its host dequantize, copy and
    quantize time to ``seconds`` (synchronised on the card)."""
    ti = reader.tensors[name]

    def encode() -> np.ndarray:
        t0 = time.perf_counter()
        f32 = dequantize(reader.tensor_bytes(name), ti.ggml_type, ti.shape)
        seconds["dequantize"] += time.perf_counter() - t0
        return numpy_codecs.quantize(f32, target, dev, seconds)

    return encode


def requantize(in_path: str, out_path: str, recipe: str = "q4_k_m", verbose: bool = True,
               device: str = "cuda") -> dict:
    """Requantize ``in_path`` into ``out_path`` under ``recipe``. Returns
    tensors, bytes_in, bytes_out (as the reference's), ``types`` (the
    output's type of each tensor) and ``seconds``: the wall time and its
    parts (host dequantize, copies to and from the card, the card's
    quantize, host quantize, and the rest: reading, writing)."""
    from tpu_kquant_torch.runtime.loader import resolve_device

    dev = resolve_device(device)
    t_start = time.perf_counter()
    seconds = dict.fromkeys(("dequantize", "copies", "quantize_card", "quantize_host"), 0.0)
    r = GGUFReader(in_path)
    w = GGUFWriter(out_path)
    for k, v in r.metadata.items():
        if k == "general.file_type":
            continue
        w.add(k, v)
    stats = {"tensors": 0, "bytes_in": 0, "bytes_out": 0, "types": {}}
    for name, ti in r.tensors.items():
        target = target_type(name, ti.shape, recipe)
        if target == ti.ggml_type:
            w.add_tensor(name, ti.shape, target, lambda n=name: r.tensor_bytes(n))
        else:
            w.add_tensor(name, ti.shape, target, _encoder(r, name, target, dev, seconds))
        stats["tensors"] += 1
        stats["bytes_in"] += ti.n_bytes
        stats["bytes_out"] += w.n_bytes(name)
        stats["types"][name] = target
        if verbose:
            print(f"  {name}: {ti.ggml_type.name} -> {target.name} "
                  f"({w.n_bytes(name) / 1e6:.1f} MB)", file=sys.stderr)
    w.write()
    r.close()
    seconds["total"] = time.perf_counter() - t_start
    seconds["rest"] = seconds["total"] - sum(
        seconds[k] for k in ("dequantize", "copies", "quantize_card", "quantize_host"))
    stats["seconds"] = seconds
    return stats


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="requantize a GGUF model")
    ap.add_argument("--in", dest="inp", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--type", default="q4_k_m", choices=sorted(RECIPES))
    ap.add_argument("-q", "--quiet", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    s = requantize(args.inp, args.out, args.type, verbose=not args.quiet, device=args.device)
    print(f"{s['tensors']} tensors: {s['bytes_in'] / 1e6:.1f} MB -> "
          f"{s['bytes_out'] / 1e6:.1f} MB ({args.type}) in {s['seconds']['total']:.2f} s")
    return s


if __name__ == "__main__":
    main()
