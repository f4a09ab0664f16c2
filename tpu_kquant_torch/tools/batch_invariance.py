"""Find, on the card, which step makes a row computed among others differ
from the same row computed alone (greedy serving's streams against their
solo runs, chip_smoke.py phase 6), each result beside the card's name and
power limit:

    python3 -m tpu_kquant_torch.tools.batch_invariance --out FILE.json

Each check compares row 0 of a batch of 16 with row 0 computed alone, bit
for bit (torch.equal), and reports the largest difference:
- ops at TinyLlama-1.1B's widths: ops/norms.py:rms_norm over [16, 2048]
  and over a burst's [16, 64, 2048] against [1, 64, 2048];
  ops/attention.py's plain branch at a decode step over 128 slots (with
  the deferred append's current token, as the forward calls it) and at a
  64-token prefill; qmm's tile at a burst of 16 x 64 rows against 64 (its
  K split does not depend on the row count); qmm's GEMV at 16 rows; the
  flash decode kernel (#7) at 16 rows of 2048 slots (its split plan does
  not depend on B either);
- the engine on TinyLlama-1.1B (chip_smoke.py's seed-0 Q4_K_M fixture, 2
  layers): one decode step of 16 rows whose cache row 0 equals a solo
  cache, the logits of row 0; a 16-prompt burst prefill (the batcher's
  admission path) against prompt 0 alone, the last logits and the layers'
  cache rows; and that burst prefill traced op by op (models/llama.py's
  rms_norm, qmatmul, apply_rope, swiglu and ops/attention.py's
  attention_decode, each call's output recorded): every call whose row-0
  output (prompt 0's tokens) differs from the solo run's, in order, so the
  first names the op that makes the streams differ;
- with --serving, chip_smoke.py's phase-6 run (TinyLlama-1.1B at full
  depth, 16 slots of 128, its 64 requests, 12 greedy): for every greedy
  request, the first step at which the logits it sampled from in the batch
  (the batcher's tick_logits row) differ from the solo run's (its prompt
  and the batch's own tokens through a batch-1 engine: prefill, then
  decode steps), and whether that step's logits came from the admission's
  prefill or from a decode tick; then the run again up to the earliest
  such tick, that tick traced op by op (the ops above and models/llama.py's
  fused_attn_in, fused_oproj_ffn and fused_ffn) against the solo decode
  step that should equal it: every op whose output for the request's row
  differs, in order; and for every layer's attention at that tick, the
  row's cache slots below its position (K and V), its query and current
  token, then the plain branch's f32 logits, probabilities and p v product
  for the row in the 16-row call against the 1-row call, both as PyTorch's
  einsums take them and as ops/attention.py:attention_plain takes them on
  the card (fixed-shape bmm calls).
The op checks also hold the plain branch's f32 parts of row 0 of 16 to
the row alone, for the einsums and for attention_plain's card form.
Folded cases (``fold_checks``; chip_smoke.py phase 3 runs them, fatal):
the int8 folds of attn_in (#3, Llama-3-8B's wqk / wv), oproj_ffn (#5,
TinyLlama's layout and a q4 wo) and ffn (#6), each row quantized alone, so
row 0 of 16 equals the row alone bit for bit.
Verify windows (speculative decoding; fatal, the tool exits 1 where one
differs): on the same 2-layer cut, each row t of a window of T = 5 tokens
(engine.step) at positions p..p + 4, at B = 1 and at B = 2 rows of other
lengths, against the decode step at position p + t on a cache that the
same prefill and the decode steps before it filled (``window_checks``;
chip_smoke.py phase 14 runs it at full depth).
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


def _einsum_parts(q, k, v, pos, kv_scales=None, kv_cur=None) -> dict:
    """The f32 logits, probabilities and p v product of ops/attention.py's
    plain branch as it stood before attention_plain (three torch.einsum
    calls, whatever device)."""
    import torch

    B, T, H, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    qf = q.float().reshape(B, T, Hkv, H // Hkv, D)
    logits = torch.einsum("bthgd,bhsd->bthgs", qf, k.float()) * D ** -0.5
    if kv_scales is not None:
        logits = logits * kv_scales[0].float()[:, None, :, None, :]
    kv_pos = torch.arange(S, device=q.device)
    at_cur = None
    if kv_cur is not None:
        l_cur = torch.einsum("bthgd,bthd->bthg", qf,
                             kv_cur[0].float().reshape(B, T, Hkv, D)) * D ** -0.5
        at_cur = (kv_pos[None, None, :] == pos[:, :, None])[:, :, None, None, :]
        logits = torch.where(at_cur, l_cur[..., None], logits)
    mask = kv_pos[None, None, :] <= pos[:, :, None]
    logits = logits.masked_fill(~mask[:, :, None, None, :], float("-inf"))
    p = torch.softmax(logits, dim=-1)
    pp = p if at_cur is None else torch.where(at_cur, 0.0, p)
    if kv_scales is not None:
        pp = pp * kv_scales[1].float()[:, None, :, None, :]
    return {"logits": logits, "p": p, "pv": torch.einsum("bthgs,bhsd->bthgd", pp, v.float())}


def _parts(form, *args) -> dict | None:
    """f32 parts of the plain branch: form "einsum" (the einsums above) or
    "fixed" (attention_plain's card form; None where the tree has none)."""
    from tpu_kquant_torch.ops import attention

    if form == "einsum":
        return _einsum_parts(*args)
    if not hasattr(attention, "attention_plain"):
        return None
    parts: dict = {}
    attention.attention_plain(*args, fixed=True, parts=parts)
    return parts


def _cmp_parts(label, form, batch_args, solo_args, b=0) -> list:
    """Row b of the batch call's f32 parts against row 0 of the solo call's."""
    import torch

    got, alone = _parts(form, *batch_args), _parts(form, *solo_args)
    if got is None:
        return []
    rows = []
    for key in ("logits", "p", "pv"):
        g, a = got[key][b:b + 1], alone[key]
        fin = a.isfinite()
        row = {"check": f"{label}, f32 {key} ({form})", "equal": bool(torch.equal(g, a)),
               "max_abs_diff": float((g[fin] - a[fin]).abs().max()) if fin.any() else 0.0,
               "max_abs": float(a[fin].abs().max()) if fin.any() else 0.0}
        print(f"  {row['check']:72s} {'equal' if row['equal'] else 'DIFFERS'}  max|diff| "
              f"{row['max_abs_diff']:.3e} of max|ref| {row['max_abs']:.3e}", flush=True)
        rows.append(row)
    return rows


def op_checks(smoke, dev) -> list:
    import numpy as np
    import torch

    from tpu_kquant_torch.ops.attention import attention_decode
    from tpu_kquant_torch.ops.decode_attention import attention_decode_flash
    from tpu_kquant_torch.ops.norms import rms_norm
    from tpu_kquant_torch.ops.qmm import qmm

    g = torch.Generator(device=dev).manual_seed(0)
    rnd = lambda *s: torch.randn(*s, device=dev, generator=g)  # noqa: E731
    out = []
    x = (rnd(B, 2048) * 2).to(torch.bfloat16)
    w = rnd(2048).abs() + 0.5
    out.append(_cmp("rms_norm [16, 2048] bf16", rms_norm(x, w)[:1], rms_norm(x[:1], w)))
    xb = (rnd(B, 64, 2048) * 2).to(torch.bfloat16)
    out.append(_cmp("rms_norm [16, 64, 2048] bf16: prompt 0 of a burst vs alone",
                    rms_norm(xb, w)[:1], rms_norm(xb[:1], w)))
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
    ki, vi = (torch.randint(-127, 128, (B, Hkv, S, D), device=dev, generator=g,
                            dtype=torch.int8) for _ in range(2))
    sc = tuple(torch.rand(B, Hkv, S, device=dev, generator=g) * 0.02 + 0.001 for _ in range(2))
    for form in ("einsum", "fixed"):
        for kv, kk, vv, scl in (("bf16", k, v, None), ("int8", ki, vi, sc)):
            for c in (cur, None):
                one = lambda t: None if t is None else tuple(x[:1] for x in t)  # noqa: E731
                out += _cmp_parts(f"plain attention parts, {kv} KV, 128 slots"
                                  f"{' (deferred append)' if c else ''}", form,
                                  (q, kk, vv, pos, scl, c),
                                  (q[:1], kk[:1], vv[:1], pos[:1], one(scl), one(c)))
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
        out.append(_cmp(f"qmm GEMV, {label}: row 0 of 16 vs alone",
                        qmm(xb[:B], wt)[:1], qmm(xb[:1], wt)))
    S = 2048
    k, v = (rnd(B, Hkv, S, D).to(torch.bfloat16) for _ in range(2))
    pos = torch.full((B, 1), 1500, device=dev)
    out.append(_cmp("flash decode (#7), 2048 slots: row 0 of 16 vs alone",
                    attention_decode_flash(q, k, v, pos)[:1],
                    attention_decode_flash(q[:1], k[:1], v[:1], pos[:1])))
    return out


def fold_checks(smoke, dev) -> list:
    """chip_smoke.py's check_fold_invariance (the int8 folds under
    TKQ_INT8_FOLDS=1 with the manual variants off), each case reported as
    row 0 of 16 against the row alone."""
    import numpy as np

    out = []

    def row0(label, fn, *xs):
        tup = lambda y: y if isinstance(y, tuple) else (y,)  # noqa: E731
        got, alone = tup(fn(*(x[:B] for x in xs))), tup(fn(*(x[:1] for x in xs)))
        for i, (g, a) in enumerate(zip(got, alone)):
            part = f", output {i}" if len(got) > 1 else ""
            out.append(_cmp(f"{label}{part}: row 0 of 16 vs alone", g[:1], a))

    smoke.check_fold_invariance(dev, np.random.default_rng(1), row0)
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
    # the burst prefill op by op: the calls whose row 0 differs
    traces = [_trace(lambda: eng._step_valid(eng._tensor(toks[:b]), eng._tensor(positions[:b]),
                                             eng.new_cache(b, max_seq=T), valid[:b]))
              for eng, b in ((many, B), (one, 1))]
    for i, ((name, got), (_, alone)) in enumerate(zip(*traces)):
        row = _cmp(f"engine: burst prefill op {i} ({name}), prompt 0's tokens",
                   got[:1, :n0], alone[:, :n0])
        if not row["equal"]:
            out.append(row)
    out.append({"check": "engine: burst prefill ops traced", "equal": True,
                "ops": [name for name, _ in traces[0]]})
    # verify windows (fatal in main): B = 1, then two rows of other lengths
    two = InferenceEngine(cfg, params, max_batch=2, max_seq=128, device=dev)
    out += [dict(r, window=True) for r in window_checks(one, prompts[:1])]
    out += [dict(r, window=True) for r in window_checks(two, prompts[1:3])]
    return out


def window_checks(eng, prompts: list[list[int]], T: int = 5, seed: int = 0) -> list:
    """Row t of a verify window of T tokens after ``prompts`` (engine.step at
    positions len + t) against the decode step at that position (both on
    caches the same prefill filled; the decode steps write theirs one by
    one), the logits of every row of the batch, bit for bit."""
    import numpy as np
    import torch

    B = len(prompts)
    window = np.random.default_rng(seed).integers(10, eng.cfg.vocab_size, (B, T))
    c_win, c_dec = eng.new_cache(B), eng.new_cache(B)
    _, c_win, lens = eng.prefill(prompts, c_win)
    _, c_dec, _ = eng.prefill(prompts, c_dec)
    wl, _ = eng.step(window, lens[:, None] + np.arange(T)[None, :], c_win)
    out = []
    for t in range(T):
        dl, c_dec = eng.decode_step(eng._tensor(window[:, t]), eng._tensor(lens + t), c_dec)
        out.append(_cmp(f"window of {T} at B = {B}: row {t} against the decode step",
                        wl[:, t], dl))
    return out


def _trace(run, fused: bool = False, args: dict | None = None) -> list:
    """(name, output) of every rms_norm, qmatmul, apply_rope and swiglu call
    of models/llama.py and every attention_decode call while run() runs;
    fused: also its fused_attn_in, fused_oproj_ffn and fused_ffn calls (a
    tuple output kept as a tuple); args: filled with each attention_decode
    call's arguments (cloned), keyed by its index in the list."""
    from tpu_kquant_torch.models import llama
    from tpu_kquant_torch.ops import attention

    rec = []
    names = [(llama, "rms_norm"), (llama, "qmatmul"), (llama, "apply_rope"), (llama, "swiglu"),
             (attention, "attention_decode")]
    if fused:
        names += [(llama, "fused_attn_in"), (llama, "fused_oproj_ffn"), (llama, "fused_ffn")]
    saved = [(mod, name, getattr(mod, name)) for mod, name in names]

    def clone(t):
        if isinstance(t, tuple):
            return tuple(clone(x) for x in t)
        return t.detach().clone() if hasattr(t, "detach") else t

    def wrap(fn, name):
        def f(*a, **kw):
            if args is not None and name == "attention_decode":
                args[len(rec)] = clone(tuple(a) + tuple(kw.get(n) for n in ("kv_cur",)))
            y = fn(*a, **kw)
            rec.append((name, tuple(t.detach().clone() for t in y) if isinstance(y, tuple)
                        else y.detach().clone()))
            return y
        return f

    for mod, name, fn in saved:
        setattr(mod, name, wrap(fn, name))
    try:
        run()
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    return rec


def serving_checks(smoke, dev) -> list:
    import numpy as np
    import torch

    from tpu_kquant_torch.models.fixtures import tinyllama_1b_config
    from tpu_kquant_torch.runtime.engine import InferenceEngine
    from tpu_kquant_torch.serving import ContinuousBatcher

    cfg, params, _ = smoke.load_fixture(tinyllama_1b_config(), "tinyllama-1.1b-q4_k_m-seed0.gguf",
                                        dev)
    greedy = {i for i in range(64) if i % 16 < 3}
    solo_eng = InferenceEngine(cfg, params, max_batch=1, max_seq=128, device=dev)
    eos = {}

    def requests():
        rng = np.random.default_rng(7)  # chip_smoke.py serving()'s requests
        reqs = [smoke.serve_request(i, cfg, rng, greedy=i in greedy) for i in range(64)]
        for j, i in enumerate(sorted(greedy)[:4]):
            if i not in eos:
                eos[i] = solo_eng.generate(
                    [reqs[i].prompt], max_new_tokens=smoke.SERVE_NEW, top_k=40, top_p=0.95,
                    repeat_penalty=1.1, penalty_last_n=64)[0][8 + 4 * j]
            reqs[i].eos_id = eos[i]
        return reqs

    batch_args: dict = {}
    solo_args: dict = {}

    def serve(reqs, trace_at=None):
        """Run the 16 slots; record each greedy request's (logits row, from
        prefill, tick, slot) per step; trace tick trace_at's ops."""
        eng = InferenceEngine(cfg, params, max_batch=16, max_seq=128, device=dev)
        cb = ContinuousBatcher(eng)
        seen: dict = {i: [] for i in greedy}
        real_tick, n, traced = cb._tick, [0], []

        def tick(sampling):
            rows = [(b, s.req.rid) for b, s in enumerate(cb.slots)
                    if s is not None and s.req is not None and s.req.rid in greedy]
            fresh = cb.state.fresh.clone()
            if n[0] == trace_at:
                box = []
                traced.extend(_trace(lambda: box.append(real_tick(sampling)), fused=True,
                                     args=batch_args))
                tok = box[0]
            else:
                tok = real_tick(sampling)
            for b, rid in rows:
                seen[rid].append((cb.tick_logits[b].clone(), bool(fresh[b]), n[0], b))
            n[0] += 1
            return tok

        cb._tick = tick
        for r in reqs:
            cb.submit(r)
        cb.run()
        return seen, traced

    reqs = requests()
    seen, _ = serve(reqs)
    out, earliest = [], None
    for i in sorted(greedy):
        r = reqs[i]
        logits, cache, lens = solo_eng.prefill([r.prompt], solo_eng.new_cache(1))
        pos, first = int(lens[0]), None
        for d, (row, fresh, tick_no, b) in enumerate(seen[i][:len(r.output)]):
            if d:
                logits, cache = solo_eng.decode_step(
                    torch.tensor([r.output[d - 1]], device=dev), torch.tensor([pos], device=dev),
                    cache)
                pos += 1
            if not torch.equal(row, logits[0].float()):
                first = {"step": d, "from_prefill": fresh, "tick": tick_no, "slot": b,
                         "max_abs_diff": float((row - logits[0].float()).abs().max())}
                if not fresh and (earliest is None or tick_no < earliest[0]):
                    earliest = (tick_no, i, d, b)
                break
        res = {"check": f"serving: request {i}'s logits against its solo run",
               "equal": first is None, "first_difference": first, "steps": len(r.output)}
        print(f"  serving: request {i:2d}: " + ("logits equal at every step" if first is None
              else f"logits first differ at step {first['step']} "
                   f"({'prefill' if first['from_prefill'] else 'decode tick'}), max|diff| "
                   f"{first['max_abs_diff']:.3e}"), flush=True)
        out.append(res)
    if earliest is None:
        return out
    # the earliest differing decode tick again, op by op, against the solo
    # decode step of the same request at the same step
    tick_no, i, d, b = earliest
    _, batch_ops = serve(requests(), trace_at=tick_no)
    r = reqs[i]
    logits, cache, lens = solo_eng.prefill([r.prompt], solo_eng.new_cache(1))
    pos = int(lens[0])
    for t in r.output[:d - 1]:
        logits, cache = solo_eng.decode_step(torch.tensor([t], device=dev),
                                             torch.tensor([pos], device=dev), cache)
        pos += 1
    solo_ops = _trace(lambda: solo_eng.decode_step(
        torch.tensor([r.output[d - 1]], device=dev), torch.tensor([pos], device=dev), cache),
        fused=True, args=solo_args)
    for j, ((name, got), (_, alone)) in enumerate(zip(batch_ops, solo_ops)):
        pairs = list(zip(got, alone)) if isinstance(got, tuple) else [(got, alone)]
        for k, (g, a) in enumerate(pairs):
            row = _cmp(f"serving: tick {tick_no} op {j} ({name}{f'[{k}]' if k else ''}), "
                       f"request {i}'s row", g[b:b + 1], a)
            if not row["equal"]:
                out.append(row)
    out.append({"check": f"serving: tick {tick_no} ops traced", "equal": True,
                "ops": [name for name, _ in batch_ops]})
    # each layer's attention at that tick: the row's inputs, then the plain
    # branch's f32 parts for the row among 16 and alone
    for layer, j in enumerate(sorted(batch_args)):
        ba, sa = batch_args[j], solo_args.get(j)
        if sa is None:
            continue
        q, k, v, qpos, scl, cur = (*ba[:4], ba[4] if len(ba) > 5 else None, ba[-1])
        sq, sk, sv, spos, sscl, scur = (*sa[:4], sa[4] if len(sa) > 5 else None, sa[-1])
        p = int(qpos[b, 0])
        label = f"serving: tick {tick_no} layer {layer}"
        for name, g, a in (("K slots below the position", k[b:b + 1, :, :p], sk[:, :, :p]),
                           ("V slots below the position", v[b:b + 1, :, :p], sv[:, :, :p]),
                           ("query", q[b:b + 1], sq),
                           *((("current k", cur[0][b:b + 1], scur[0]),
                              ("current v", cur[1][b:b + 1], scur[1])) if cur else ())):
            out.append(_cmp(f"{label}: {name}, request {i}'s row", g, a))
        for form in ("einsum", "fixed"):
            out += _cmp_parts(f"{label} plain attention", form, (q, k, v, qpos, scl, cur),
                              (sq, sk, sv, spos, sscl, scur), b)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True, help="JSON file the results go to")
    ap.add_argument("--serving", action="store_true", help="also trace phase 6's serving run")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("batch_invariance needs a CUDA card")
    smoke = _smoke()
    dev = torch.device("cuda", 0)
    res = {"gpu": smoke.gpu_line()}
    print(f"== batch_invariance [{res['gpu']}]", flush=True)
    with torch.no_grad():
        res["ops"] = op_checks(smoke, dev) + fold_checks(smoke, dev)
        res["engine"] = engine_checks(smoke, dev)
        if args.serving:
            res["serving"] = serving_checks(smoke, dev)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(res, indent=1))
    print(f"== batch_invariance done [{smoke.gpu_line()}]", flush=True)
    bad = [r["check"] for r in res["engine"] if r.get("window") and not r["equal"]]
    if bad:
        print(f"FAIL: verify-window rows differ from their decode steps: {bad}", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
