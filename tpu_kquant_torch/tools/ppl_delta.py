"""Quantization quality across the recipe ladder, the port of
``tpu_kquant.tools.ppl_delta``: perplexity delta, mean token KL(p_f16 ||
p_q) over every teacher-forced position, and top-1 agreement with the
high-precision model, for each recipe in one run, so that the expected
ordering (q2 > q3 > q4 > q5 > q6 > q8 damage) is measured, not assumed.

Each recipe is requantized with ``tools/quantize.py:requantize`` (on the
card's kernels by default) and its windows run through
``tools/perplexity.py:window_logprobs``; on the card a window of more than
32 tokens runs every projection on qmm's tile.

  python -m tpu_kquant_torch.tools.ppl_delta --model f16.gguf --text wiki.txt \\
      --types q2_k,q3_k_m,q4_k_m,q5_k_m,q6_k,q8_0 --ctx 256 [--device cpu] [--json-out F]
"""

from __future__ import annotations

import argparse
import json
import tempfile
from pathlib import Path

import numpy as np


class _LPStore:
    """Per-window teacher-forced log-probs, f16 on a disk-backed memmap (in
    the temporary directory), so the ladder's base run streams to disk once
    and every quantized run reads it back window by window."""

    def __init__(self, nw: int, ctx: int, vocab: int):
        f = tempfile.NamedTemporaryFile(suffix=".lp.f16", delete=False)
        self._path = f.name
        f.close()
        self._mm = np.memmap(self._path, np.float16, "w+", shape=(nw, ctx, vocab))
        self._ts: list[int] = []

    def append(self, lp: np.ndarray) -> None:
        w, t = len(self._ts), lp.shape[0]
        self._mm[w, :t] = lp.astype(np.float16)
        self._ts.append(t)

    def get(self, w: int) -> np.ndarray:
        blp = np.asarray(self._mm[w, : self._ts[w]], np.float32)
        # f16 rounding denormalizes the stored distribution slightly (KL
        # against it could go ~1e-5 negative); renormalize on read
        m = blp.max(-1, keepdims=True)
        blp -= m + np.log(np.exp(blp - m).sum(-1, keepdims=True))
        return blp

    def close(self) -> None:
        del self._mm
        Path(self._path).unlink(missing_ok=True)


def window_metrics(model_path: str, ids, ctx: int, max_windows, impl: str,
                   base_lp: _LPStore | None = None, device: str = "cuda"):
    """Teacher-forced windows of ctx + 1 tokens (each position scored).
    Returns (ppl, mean_kl, top1_agreement, logprob_store). With ``base_lp``
    (the high-precision run's windows) KL and top-1 are taken against it and
    the store returned is None."""
    from tpu_kquant_torch.runtime.engine import InferenceEngine
    from tpu_kquant_torch.runtime.loader import load_model
    from tpu_kquant_torch.tools.perplexity import window_logprobs

    cfg, params, reader = load_model(model_path, device=device)
    eng = InferenceEngine(cfg, params, max_batch=1, max_seq=ctx, impl=impl, device=device)
    nw = max((len(ids) - 1) // ctx, 1)
    if max_windows:
        nw = min(nw, max_windows)
    nll, cnt, kl_sum, agree = 0.0, 0, 0.0, 0
    lps = _LPStore(nw, ctx, cfg.vocab_size) if base_lp is None else None
    for w in range(nw):
        seg = list(ids[w * ctx: w * ctx + ctx + 1])
        if len(seg) < 2:
            break
        T = len(seg) - 1
        lp = window_logprobs(eng, seg[:-1]).cpu().numpy()
        tgt = np.asarray(seg[1:])
        nll += float(-lp[np.arange(T), tgt].sum())
        cnt += T
        if base_lp is not None:
            blp = base_lp.get(w)
            kl_sum += float((np.exp(blp) * (blp - lp)).sum(-1).sum())
            agree += int((blp.argmax(-1) == lp.argmax(-1)).sum())
        else:
            lps.append(lp)
    reader.close()
    ppl = float(np.exp(nll / max(cnt, 1)))
    if base_lp is not None:
        return ppl, kl_sum / max(cnt, 1), agree / max(cnt, 1), None
    return ppl, 0.0, 1.0, lps


def main(argv=None):
    ap = argparse.ArgumentParser(description="ppl/KL/top-1 delta across quantizations")
    ap.add_argument("--model", required=True, help="high-precision GGUF (f16/f32)")
    ap.add_argument("--text", required=True)
    ap.add_argument("--type", default=None, help="single recipe (legacy mode)")
    ap.add_argument("--types", default=None, help="comma list for the ladder table")
    ap.add_argument("--ctx", type=int, default=512)
    ap.add_argument("--max-windows", type=int, default=None)
    ap.add_argument("--impl", default="auto")
    ap.add_argument("--json-out", default="")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    from tpu_kquant_torch.gguf import GGUFReader
    from tpu_kquant_torch.tokenizer import from_gguf_metadata
    from tpu_kquant_torch.tools.quantize import requantize

    with GGUFReader(args.model) as r:
        tok = from_gguf_metadata(r.metadata)
    with open(args.text, encoding="utf-8") as f:
        ids = tok.encode(f.read(), add_bos=True)
    types = args.types.split(",") if args.types else [args.type or "q4_k_m"]

    base_ppl, _, _, base_lp = window_metrics(args.model, ids, args.ctx, args.max_windows,
                                             args.impl, device=args.device)
    print(f"base ppl   : {base_ppl:.4f}")
    rows = []
    for t in types:
        with tempfile.TemporaryDirectory() as td:
            qpath = str(Path(td) / "q.gguf")
            requantize(args.model, qpath, t, verbose=False, device=args.device)
            q_ppl, kl, top1, _ = window_metrics(qpath, ids, args.ctx, args.max_windows,
                                                args.impl, base_lp=base_lp, device=args.device)
        print(f"{t:10s}: ppl {q_ppl:.4f}  dppl {q_ppl - base_ppl:+.4f}  "
              f"KL {kl:.5f}  top1 {top1 * 100:.2f}%")
        rows.append({"type": t, "ppl": round(q_ppl, 4), "dppl": round(q_ppl - base_ppl, 4),
                     "kl": round(kl, 6), "top1": round(top1, 4)})
    base_lp.close()
    if args.json_out:
        Path(args.json_out).write_text(json.dumps(
            {"base_ppl": round(base_ppl, 4), "rows": rows}, indent=1))
    if len(rows) == 1:
        return rows[0]["dppl"]
    return rows


if __name__ == "__main__":
    main()
