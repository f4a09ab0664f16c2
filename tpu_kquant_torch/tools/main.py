"""Generate CLI, the user's entry point (llama-cli's counterpart): the port
of ``tpu_kquant.tools.main``, with its flags and stderr lines, plus
``--device`` (default cuda; without a card it raises unless ``--device
cpu`` is given).

Usage:
  python -m tpu_kquant_torch.tools.main -m m.gguf -p "..." -n 64 [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
import time

from tpu_kquant_torch.ops.qmatmul import IMPLS


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="tpu-kquant text generation")
    ap.add_argument("--model", "-m", required=True)
    ap.add_argument("--prompt", "-p", default="Hello")
    ap.add_argument("-n", "--n-tokens", type=int, default=64)
    ap.add_argument("--temp", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=40)
    ap.add_argument("--top-p", type=float, default=0.95)
    ap.add_argument("--min-p", type=float, default=0.0)
    ap.add_argument("--repeat-penalty", type=float, default=1.0)
    ap.add_argument("--presence-penalty", type=float, default=0.0)
    ap.add_argument("--frequency-penalty", type=float, default=0.0)
    ap.add_argument("--repeat-last-n", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--impl", default="auto", choices=list(IMPLS))
    ap.add_argument("--kv-int8", action="store_true", help="INT8 KV cache")
    ap.add_argument("--kv-layout", default="unified", choices=["unified", "iswa"],
                    help="iswa: ring-buffer KV for sliding-window layers (llama.cpp "
                         "unified_iswa equivalent; needs a sliding-window arch)")
    ap.add_argument("--max-seq", type=int, default=None)
    ap.add_argument("--scale-dtype", default="bf16", choices=["bf16", "f32", "f16"],
                    help="per-group scale layout (f16 is not ported: the loader raises)")
    ap.add_argument("--ctx-shift", action="store_true",
                    help="keep generating past the KV capacity by context shift "
                         "(llama.cpp main's behavior when the context fills)")
    ap.add_argument("--keep", type=int, default=0,
                    help="tokens at the start of the prompt pinned across context "
                         "shifts (llama.cpp --keep)")
    ap.add_argument("--draft", default=None, metavar="GGUF",
                    help="draft model for greedy speculative decoding (llama.cpp "
                         "tools/speculative; the output is plain greedy's)")
    ap.add_argument("--n-draft", type=int, default=6,
                    help="draft tokens proposed per verify step")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap.parse_args(argv)


def run(argv=None) -> dict:
    """The CLI's work: prints what main prints and returns {'ids': the new
    token ids, 'text', 'seconds': generation wall time, 'stats': the
    speculative stats or None}."""
    args = parse_args(argv)

    from tpu_kquant_torch.runtime.engine import InferenceEngine
    from tpu_kquant_torch.runtime.loader import load_model
    from tpu_kquant_torch.tokenizer import from_gguf_metadata

    t0 = time.time()
    cfg, params, reader = load_model(args.model, scale_dtype=args.scale_dtype,
                                     device=args.device)
    tok = from_gguf_metadata(reader.metadata)
    print(f"[load {time.time()-t0:.1f}s] {cfg.arch} L={cfg.n_layers} dim={cfg.dim} "
          f"vocab={cfg.vocab_size}", file=sys.stderr)

    ids = tok.encode(args.prompt, add_bos=True)
    max_seq = args.max_seq or min(cfg.max_seq_len, len(ids) + args.n_tokens + 16)
    eng = InferenceEngine(cfg, params, max_batch=1, max_seq=max_seq,
                          kv_quantized=args.kv_int8, impl=args.impl,
                          kv_layout=args.kv_layout, device=args.device)
    stats = None
    t0 = time.time()
    if args.draft is not None:
        from tpu_kquant_torch.runtime.speculative import generate_speculative

        dcfg, dparams, _ = load_model(args.draft, scale_dtype=args.scale_dtype,
                                      device=args.device)
        deng = InferenceEngine(dcfg, dparams, max_batch=1, max_seq=max_seq,
                               kv_quantized=args.kv_int8, impl=args.impl, device=args.device)
        outs, stats = generate_speculative(eng, deng, [ids], max_new_tokens=args.n_tokens,
                                           n_draft=args.n_draft,
                                           eos_id=getattr(tok, "eos_id", None))
        out = outs[0]
        acc = stats["accepted"] / max(1, stats["drafted"])
        print(f"[speculative: {stats['rounds']} rounds, {acc:.0%} draft acceptance]",
              file=sys.stderr)
    else:
        out = eng.generate(
            [ids], max_new_tokens=args.n_tokens, temperature=args.temp,
            top_k=args.top_k, top_p=args.top_p,
            eos_id=getattr(tok, "eos_id", None), seed=args.seed,
            context_shift=args.ctx_shift, n_keep=args.keep,
            min_p=args.min_p, repeat_penalty=args.repeat_penalty,
            presence_penalty=args.presence_penalty,
            frequency_penalty=args.frequency_penalty,
            penalty_last_n=args.repeat_last_n,
        )[0]
    dt = time.time() - t0
    text = tok.decode(out)
    print(text)
    print(f"[{len(out)} tokens in {dt:.2f}s = {len(out)/dt:.1f} tok/s]", file=sys.stderr)
    return {"ids": out, "text": text, "seconds": dt, "stats": stats}


def main(argv=None) -> str:
    return run(argv)["text"]


if __name__ == "__main__":
    main()
