"""Find, on the card, which step makes a row computed among others differ
from the same row computed alone (greedy serving's streams against their
solo runs, chip_smoke.py phase 6), each result beside the card's name and
power limit:

    python3 -m tpu_kquant_torch.tools.batch_invariance --out FILE.json

Each check compares row 0 of a batch of 16 with row 0 computed alone, bit
for bit (torch.equal), and reports the largest difference:
- ops at TinyLlama-1.1B's widths: ops/norms.py:rms_norm over [16, 2048];
  ops/attention.py's plain branch at a decode step over 128 slots (with
  the deferred append's current token, as the forward calls it) and at a
  64-token prefill; qmm's tile at a burst of 16 x 64 rows against 64 (the
  tile plan depends on the row count); qmm's GEMV at 16 rows (a control:
  its plan does not);
- the engine on TinyLlama-1.1B (chip_smoke.py's seed-0 Q4_K_M fixture, 2
  layers): one decode step of 16 rows whose cache row 0 equals a solo
  cache, the logits of row 0; a 16-prompt burst prefill (the batcher's
  admission path) against prompt 0 alone, the last logits and the layers'
  cache rows.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
from pathlib import Path

TREE = Path(__file__).resolve().parents[2]
B = 16


def _smoke():
    spec = importlib.util.spec_from_file_location("batch_inv_smoke", TREE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cmp(label, got, alone) -> dict:
    """Row-0 results of the batch against alone: equal bits, max |diff|."""
    import torch

    got, alone = got.float(), alone.float()
    row = {"check": label, "equal": bool(torch.equal(got, alone)),
           "max_abs_diff": float((got - alone).abs().max()),
           "max_abs": float(alone.abs().max())}
    print(f"  {label:64s} {'equal' if row['equal'] else 'DIFFERS'}  max|diff| "
          f"{row['max_abs_diff']:.3e} of max|ref| {row['max_abs']:.3e}", flush=True)
    return row


def op_checks(smoke, dev) -> list:
    import numpy as np
    import torch

    from tpu_kquant_torch.ops.attention import attention_decode
    from tpu_kquant_torch.ops.norms import rms_norm
    from tpu_kquant_torch.ops.qmm import qmm

    g = torch.Generator(device=dev).manual_seed(0)
    rnd = lambda *s: torch.randn(*s, device=dev, generator=g)  # noqa: E731
    out = []
    x = (rnd(B, 2048) * 2).to(torch.bfloat16)
    w = rnd(2048).abs() + 0.5
    out.append(_cmp("rms_norm [16, 2048] bf16", rms_norm(x, w)[:1], rms_norm(x[:1], w)))
    H, Hkv, D, S = 32, 4, 64, 128
    k, v = (rnd(B, Hkv, S, D).to(torch.bfloat16) for _ in range(2))
    q = rnd(B, 1, H, D).to(torch.bfloat16)
    pos = torch.full((B, 1), 70, device=dev)
    cur = tuple(rnd(B, 1, Hkv, D).to(torch.bfloat16) for _ in range(2))
    out.append(_cmp("plain attention, decode step, 128 slots (deferred append)",
                    attention_decode(q, k, v, pos, kv_cur=cur)[:1],
                    attention_decode(q[:1], k[:1], v[:1], pos[:1],
                                     kv_cur=tuple(c[:1] for c in cur))))
    out.append(_cmp("plain attention, decode step, 128 slots",
                    attention_decode(q, k, v, pos)[:1],
                    attention_decode(q[:1], k[:1], v[:1], pos[:1])))
    T = 64
    qp = rnd(B, T, H, D).to(torch.bfloat16)
    kp, vp = (rnd(B, Hkv, T, D).to(torch.bfloat16) for _ in range(2))
    ppos = torch.arange(T, device=dev)[None].expand(B, T)
    out.append(_cmp("plain attention, 64-token prefill",
                    attention_decode(qp, kp, vp, ppos)[:1],
                    attention_decode(qp[:1], kp[:1], vp[:1], ppos[:1])))
    rng = np.random.default_rng(0)
    for label, kind, N, K in (("wqk q4-sm", "q4", 2304, 2048), ("down q6w-sp", "q6w", 2048, 5632)):
        wt = smoke._rand_weights(rng, kind, N, K, dev)
        xb = rnd(B * T, K).to(torch.bfloat16)
        out.append(_cmp(f"qmm tile, {label}: rows 0-63 of a 16 x 64 burst vs 64",
                        qmm(xb, wt)[:T], qmm(xb[:T], wt)))
        out.append(_cmp(f"qmm GEMV, {label}: row 0 of 16 vs alone (control)",
                        qmm(xb[:B], wt)[:1], qmm(xb[:1], wt)))
    return out


def engine_checks(smoke, dev) -> list:
    import numpy as np
    import torch

    from tpu_kquant_torch.models.fixtures import tinyllama_1b_config
    from tpu_kquant_torch.runtime.engine import InferenceEngine
    from tpu_kquant_torch.runtime.kv_cache import set_batch_row, slice_batch_row

    cfg, params, _ = smoke.load_fixture(tinyllama_1b_config(), "tinyllama-1.1b-q4_k_m-seed0.gguf",
                                        dev)
    cfg = dataclasses.replace(cfg, n_layers=2)
    params = {**params, "layers": params["layers"][:2]}
    rng = np.random.default_rng(7)
    prompts = [rng.integers(10, cfg.vocab_size, int(n)).tolist() for n in rng.integers(32, 64, B)]
    out = []
    many = InferenceEngine(cfg, params, max_batch=B, max_seq=128, device=dev)
    one = InferenceEngine(cfg, params, max_batch=1, max_seq=128, device=dev)
    # a burst prefill (the batcher's admission: one [16, T] forward with the
    # pad mask) against prompt 0 alone
    T = 64
    toks = np.zeros((B, T), np.int64)
    for j, p in enumerate(prompts):
        toks[j, : len(p)] = p
    positions = np.broadcast_to(np.arange(T), (B, T))
    lens = np.array([len(p) for p in prompts])
    valid = torch.from_numpy(positions < lens[:, None]).to(dev)
    logits, burst = many._step_valid(many._tensor(toks), many._tensor(positions),
                                     many.new_cache(B, max_seq=T), valid)
    alone_logits, alone = one._step_valid(one._tensor(toks[:1]), one._tensor(positions[:1]),
                                          one.new_cache(1, max_seq=T), valid[:1])
    n0 = int(lens[0])
    out.append(_cmp("engine: burst prefill of 16 prompts, prompt 0's last logits",
                    logits[0, n0 - 1], alone_logits[0, n0 - 1]))
    for layer in range(cfg.n_layers):
        out.append(_cmp(f"engine: burst prefill, layer {layer}'s K rows of prompt 0",
                        burst.k[layer, :1, :, :n0], alone.k[layer, :, :, :n0]))
    # one decode step of 16 rows, row 0's cache equal to the solo cache
    cache = many.new_cache(B)
    cache.k[:, :, :, :T] = burst.k
    cache.v[:, :, :, :T] = burst.v
    solo = one.new_cache(1)
    set_batch_row(solo, slice_batch_row(cache, 0), 0)
    tok = torch.tensor([p[-1] for p in prompts], device=dev)
    pos = torch.tensor(lens, device=dev)
    l16, _ = many.decode_step(tok, pos, cache)
    l1, _ = one.decode_step(tok[:1], pos[:1], solo)
    out.append(_cmp("engine: decode step of 16 rows, row 0's logits", l16[:1], l1))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True, help="JSON file the results go to")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("batch_invariance needs a CUDA card")
    smoke = _smoke()
    dev = torch.device("cuda", 0)
    res = {"gpu": smoke.gpu_line()}
    print(f"== batch_invariance [{res['gpu']}]", flush=True)
    with torch.no_grad():
        res["ops"] = op_checks(smoke, dev)
        res["engine"] = engine_checks(smoke, dev)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(res, indent=1))
    print(f"== batch_invariance done [{smoke.gpu_line()}]", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
