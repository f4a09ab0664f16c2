"""Speculative decoding: the port of ``tpu_kquant.runtime.speculative``. A
draft proposes n_draft tokens and the target verifies them in one forward
of n_draft + 1 rows (engine.step), as llama.cpp's tools/speculative does.

Greedy verification: a draft token is accepted while it equals the target's
own argmax, and the first mismatch is replaced by the target's argmax, so
the output is plain greedy decoding of the target whatever the draft. On
the card it is so bit for bit on a bf16 cache within the attention's
logits budget: each row of a verify window computes what the decode step
at its position computes (models.llama: window_rows). On an int8 cache a
decode step attends its current token unquantized and a window row its
int8 copy, in both packages, so a stream may differ from plain greedy
there.

Rejected positions leave stale K/V in both caches, which is safe: the next
round's feed starts at the first unverified position and writes every
rejected slot before any query attends it. A draft model runs n_draft
decode steps a round, as the reference's, so its cache never holds the
last draft token's K/V: after a round that accepted every draft, the
draft attends that stale slot. Only the draft's proposals can change by
it, never the output.

A recurrent model (mamba) is refused as target and as draft: its state
cannot take back a rejected draft, which the verify forward has already
folded in. The reference runs it all the same, and its stream then parts
from plain greedy (tests/test_torch_mamba.py pins both).
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_kquant_torch.ops.sampling import greedy
from tpu_kquant_torch.runtime.engine import InferenceEngine


def _refuse_recurrent(*engines: InferenceEngine | None) -> None:
    if any(e is not None and e.cfg.is_recurrent for e in engines):
        raise NotImplementedError("speculative decoding of a recurrent (mamba) model: its "
                                  "state cannot drop a rejected draft")


def generate_speculative(
    target: InferenceEngine,
    draft: InferenceEngine,
    prompts: list[list[int]],
    max_new_tokens: int = 32,
    n_draft: int = 6,
    eos_id: int | None = None,
) -> tuple[list[list[int]], dict]:
    """Greedy speculative generation, stepped by the host. Returns (tokens
    per row, stats): {'rounds', 'drafted', 'accepted'}; accepted / drafted
    is the draft's acceptance rate."""
    _refuse_recurrent(target, draft)
    B = len(prompts)
    t_cache = target.new_cache(B)
    d_cache = draft.new_cache(B)
    t_logits, t_cache, lens = target.prefill(prompts, t_cache)
    _, d_cache, _ = draft.prefill(prompts, d_cache)

    # the first token comes from the target's prefill logits (greedy)
    cur = greedy(t_logits).long()  # [B]
    pos = target._tensor(lens)  # position of `cur` per row
    span = torch.arange(n_draft + 1, device=target.device)

    out: list[list[int]] = [[int(c)] for c in cur.tolist()]
    done = np.zeros(B, bool)
    if eos_id is not None:
        done |= cur.cpu().numpy() == eos_id
    stats = {"rounds": 0, "drafted": 0, "accepted": 0}

    cap = min(target.max_seq, draft.max_seq)
    while (not done.all() and min(len(o) for o in out) < max_new_tokens
           and int(pos.max()) + n_draft + 1 < cap):
        stats["rounds"] += 1
        # 1) the draft proposes n_draft greedy tokens from (cur, pos)
        d_toks, d_cache = draft.decode_greedy(cur, pos, d_cache, n_draft)
        # 2) the target verifies [cur, d_1..d_n] in one forward; row i
        #    predicts the token at pos + 1 + i
        feed = torch.cat([cur[:, None], d_toks], dim=1)  # [B, n + 1]
        v_logits, t_cache = target.step(feed, pos[:, None] + span, t_cache)
        t_pred = torch.argmax(v_logits, dim=-1).cpu().numpy()  # [B, n + 1]
        d_np = d_toks.cpu().numpy()

        # 3) each row's longest accepted prefix and the target's next token
        accepted = np.zeros(B, np.int64)
        next_tok = np.zeros(B, np.int64)
        for b in range(B):
            k = 0
            while k < n_draft and t_pred[b, k] == d_np[b, k]:
                k += 1
            accepted[b] = k
            next_tok[b] = t_pred[b, k]
            if not done[b]:
                for tok in [int(x) for x in d_np[b, :k]] + [int(t_pred[b, k])]:
                    out[b].append(tok)
                    if eos_id is not None and tok == eos_id:
                        done[b] = True
                        break
        stats["drafted"] += int(n_draft * B)
        stats["accepted"] += int(accepted.sum())

        # 4) the next round decodes from the target's token; rows advance by
        #    different amounts
        pos = pos + torch.from_numpy(accepted + 1).to(pos.device)
        cur = torch.from_numpy(next_tok).to(pos.device)

    return [o[:max_new_tokens] for o in out], stats


class DeviceSpeculator:
    """Speculative decoding whose rounds stay on the device: the draft (a
    draft engine's decode steps, or a prompt-lookup n-gram match over each
    row's history as tensor ops), the verify window, the accepted prefix (a
    cumprod of matches) and the history (written at masked indices) are all
    device work, and the host reads one flag a round, the loop's exit test.
    The reference runs the whole loop as one lax.while_loop; here the
    host's one small read a round keeps a round free of other host reads,
    so a round can later be captured in a CUDA graph.

    draft=None is prompt lookup (llama.cpp's tools/lookup): the draft after
    position p is the continuation of the latest earlier occurrence of the
    row's last ``ngram`` tokens in its own history (prompt and output), or
    the current token n_draft times where there is none. Either draft
    source gives plain greedy output.

    accept_all=True skips the comparison: every round emits n_draft + 1
    tokens for one verify, the ceiling of this machinery; the output is
    then the draft's, so it is a timing harness only.
    """

    def __init__(self, target: InferenceEngine, draft: InferenceEngine | None,
                 n_draft: int = 6, ngram: int = 3, accept_all: bool = False):
        _refuse_recurrent(target, draft)
        self.target = target
        self.draft = draft
        self.n_draft = n_draft
        self.ngram = ngram
        self.accept_all = accept_all

    def _draft_lookup(self, hist: torch.Tensor, cur: torch.Tensor,
                      pos: torch.Tensor) -> torch.Tensor:
        """hist [B, C] (the first C columns of the history), cur, pos [B] ->
        the n-gram drafts [B, n]."""
        C, g, n = self.target.max_seq, self.ngram, self.n_draft
        B = hist.shape[0]
        dev = hist.device
        idx = torch.arange(C - g + 1, device=dev)
        ok = torch.ones(B, C - g + 1, dtype=torch.bool, device=dev)
        for j in range(g):
            at = pos - g + 1 + j
            at = torch.where(at < 0, at + C, at).clamp(0, C - 1)  # JAX's negative index
            ok &= hist[:, j:j + C - g + 1] == hist.gather(1, at[:, None])
        # the candidate gram must END strictly before the current one
        ok &= (idx + g - 1)[None, :] < pos[:, None]
        i = torch.where(ok, idx[None, :], -1).amax(dim=1)
        start = torch.clamp(i + g, 0, C - n)
        cont = hist.gather(1, start[:, None] + torch.arange(n, device=dev)[None, :])
        return torch.where((i >= 0)[:, None], cont, cur[:, None].expand(B, n))

    @torch.no_grad()
    def generate(self, prompts: list[list[int]], max_new_tokens: int = 32,
                 eos_id: int | None = None) -> tuple[list[list[int]], dict]:
        """Greedy speculative generation. Returns (tokens per row, stats)."""
        tgt, drf, n = self.target, self.draft, self.n_draft
        B, C, dev = len(prompts), tgt.max_seq, tgt.device
        t_cache = tgt.new_cache(B)
        t_logits, t_cache, lens = tgt.prefill(prompts, t_cache)
        d_cache = None
        if drf is not None:
            d_cache = drf.new_cache(B)
            _, d_cache, _ = drf.prefill(prompts, d_cache)
        cur = greedy(t_logits).long()
        # the history, with n + 1 columns past C that take the writes the
        # reference drops (mode="drop"), so every write is one scatter
        hist_np = np.zeros((B, C + n + 1), np.int64)
        for b, p in enumerate(prompts):
            hist_np[b, :len(p)] = p
        hist = torch.from_numpy(hist_np).to(dev)
        lens_d = tgt._tensor(lens)
        rows = torch.arange(B, device=dev)
        hist[rows, lens_d] = cur
        pos = lens_d.clone()
        span = torch.arange(n + 1, device=dev)[None, :]
        rounds = torch.zeros((), dtype=torch.long, device=dev)
        acc = torch.zeros(B, dtype=torch.long, device=dev)

        def more() -> bool:  # the loop's exit test: the one read a round
            emitted = pos - lens_d + 1
            return bool(((emitted.min() < max_new_tokens) & (pos.max() + n + 1 < C)).item())

        while more():
            if drf is not None:
                d_toks, d_cache = drf.decode_greedy(cur, pos, d_cache, n)
            else:
                d_toks = self._draft_lookup(hist[:, :C], cur, pos)
            feed = torch.cat([cur[:, None], d_toks], dim=1)
            t_logits, t_cache = tgt.step(feed, pos[:, None] + span, t_cache)
            t_pred = torch.argmax(t_logits, dim=-1)
            if self.accept_all:
                k = torch.full((B,), n, dtype=torch.long, device=dev)
            else:
                match = (t_pred[:, :n] == d_toks).long()
                k = torch.cumprod(match, dim=1).sum(dim=1)
            nxt = t_pred.gather(1, k[:, None])[:, 0]
            emit = torch.where(span < k[:, None], torch.nn.functional.pad(d_toks, (0, 1)), 0)
            emit = emit + torch.where(span == k[:, None], nxt[:, None], 0)
            cols = pos[:, None] + 1 + span
            cols = torch.where((span <= k[:, None]) & (cols < C), cols, C + span)
            hist.scatter_(1, cols, emit)
            cur, pos = nxt, pos + k + 1
            rounds += 1
            acc += k
        hist_np, pos_np = hist.cpu().numpy(), pos.cpu().numpy()
        out = []
        for b in range(B):
            row = [int(t) for t in hist_np[b, lens[b]:min(lens[b] + max_new_tokens,
                                                           pos_np[b] + 1)]]
            if eos_id is not None and eos_id in row:
                row = row[:row.index(eos_id) + 1]
            out.append(row)
        stats = {"rounds": int(rounds), "drafted": int(rounds) * n * B,
                 "accepted": int(acc.sum())}
        return out, stats
