"""Perplexity over sliding windows (wikitext-2 style): the port of
``tpu_kquant.tools.perplexity``. Each window is one engine.step over a fresh
cache.

Usage:
  python -m tpu_kquant_torch.tools.perplexity --model M.gguf --text f.txt --ctx 512 [--device cpu]
"""

from __future__ import annotations

import math
from typing import Iterable

import torch


@torch.no_grad()
def window_logprobs(engine, tokens: list[int]) -> torch.Tensor:
    """f32 log-probabilities [T, vocab] of the token after each of the
    window's T tokens: one engine.step over a fresh cache."""
    cache = engine.new_cache(1)
    T = len(tokens)
    toks = torch.tensor([tokens], dtype=torch.long)
    logits, _ = engine.step(toks, torch.arange(T)[None, :], cache)
    return torch.log_softmax(logits[0].float(), dim=-1)


def nll_of_window(engine, tokens: list[int]) -> tuple[float, int]:
    """Summed negative log-likelihood of tokens[1:] given their prefixes,
    and their count."""
    T = len(tokens)
    logp = window_logprobs(engine, tokens)[: T - 1]
    tgt = torch.tensor(tokens[1:], dtype=torch.long, device=logp.device)
    nll = -logp.gather(1, tgt[:, None]).sum()
    return float(nll), T - 1


def perplexity(engine, token_stream: Iterable[int], ctx: int = 512, stride: int | None = None,
               max_windows: int | None = None) -> dict:
    """Sliding-window perplexity over a token stream: non-overlapping
    ctx-sized windows by default (llama.cpp's perplexity tool), every
    position after a window's first scored."""
    toks = list(token_stream)
    stride = stride or ctx
    total_nll, total_cnt, n_win = 0.0, 0, 0
    for start in range(0, max(1, len(toks) - 1), stride):
        window = toks[start : start + ctx]
        if len(window) < 2:
            break
        nll, cnt = nll_of_window(engine, window)
        total_nll += nll
        total_cnt += cnt
        n_win += 1
        if max_windows and n_win >= max_windows:
            break
    ppl = math.exp(total_nll / max(1, total_cnt))
    return {"ppl": ppl, "nll_per_token": total_nll / max(1, total_cnt),
            "tokens": total_cnt, "windows": n_win}


def main(argv=None) -> dict:
    import argparse

    ap = argparse.ArgumentParser(description="perplexity over a text file")
    ap.add_argument("--model", required=True)
    ap.add_argument("--text", required=True, help="path to raw text file")
    ap.add_argument("--ctx", type=int, default=512)
    ap.add_argument("--max-windows", type=int, default=None)
    ap.add_argument("--impl", default="auto")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    from tpu_kquant_torch.runtime.engine import InferenceEngine
    from tpu_kquant_torch.runtime.loader import load_model
    from tpu_kquant_torch.tokenizer import from_gguf_metadata

    cfg, params, reader = load_model(args.model, device=args.device)
    tok = from_gguf_metadata(reader.metadata)
    with open(args.text, encoding="utf-8") as f:
        ids = tok.encode(f.read(), add_bos=True)
    eng = InferenceEngine(cfg, params, max_batch=1, max_seq=args.ctx, impl=args.impl,
                          device=args.device)
    res = perplexity(eng, ids, ctx=args.ctx, max_windows=args.max_windows)
    print(f"ppl = {res['ppl']:.4f} over {res['tokens']} tokens ({res['windows']} windows)")
    return res


if __name__ == "__main__":
    main()
