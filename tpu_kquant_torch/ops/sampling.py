"""Token samplers: the port of ``tpu_kquant.ops.sampling`` (greedy,
temperature, min-p, top-k, top-p, and llama.cpp's repeat / presence /
frequency penalties over a sliding window of recent tokens).

The chain keeps the reference's order, temperature -> min_p -> top_k ->
top_p -> categorical, and its top-p rule: the sorted probabilities'
cumulative sums below ``top_p`` are counted, and the logit at that count is
the cutoff (ties with it survive).

Randomness is explicit and batched. ``jax.random.categorical(key, l)`` is
``argmax(l + gumbel(key))``; here a row's Gumbel noise comes from a
counter-based hash of (seed, step, token id), drawn for the whole [B, V]
batch in one vectorised pass on the logits' device. A row's ``key`` is the
pair (seed, step) in an int64 ``keys`` [B, 2] tensor: the serving batcher
gives each request its own seed and counts its sampled tokens as the step,
so a request's draws do not depend on its slot or on the other requests
(the reference gets the same property from ``fold_in(base_key, step)``).
The port does not reproduce JAX's threefry bits: every sampling function
takes ``noise`` [B, V] f32 to use in place of its own draw, which is how the
tests feed JAX's Gumbel noise to both packages.

Penalty state is (counts [B, V] i32, window [B, W] i32, widx [B] i32,
nfill [B] i32), as in the reference. The updates write it in
place (the port's tensors are mutable; the reference returns new arrays)
and return it. Division by temperature and by the repeat penalty is by a
tensor on the logits' device, never by a Python scalar: PyTorch's CUDA
division by a host scalar multiplies by its reciprocal, which is not IEEE
division.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    """Sampler settings of one generation (the reference's SamplerConfig:
    llama.cpp's sampler-chain parameters)."""

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    min_p: float = 0.0
    repeat_penalty: float = 1.0
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    penalty_last_n: int = 64

    @property
    def uses_penalties(self) -> bool:
        return (self.repeat_penalty != 1.0 or self.presence_penalty != 0.0
                or self.frequency_penalty != 0.0) and self.penalty_last_n != 0

    @property
    def is_greedy(self) -> bool:
        return self.temperature <= 0.0


# -- noise ---------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _mix(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash with full avalanche (Wellons' lowbias32
    constants, both below 2^31, so a product of a 32-bit value never
    leaves int64's range). x holds uint32 values in an int64 tensor."""
    x = x ^ (x >> 16)
    x = (x * 0x21F0AAAD) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x735A2D97) & _M32
    return x ^ (x >> 15)


def row_keys(seeds, steps) -> torch.Tensor:
    """keys [B, 2] int64 from per-row seeds and steps (tensors or lists)."""
    seeds = torch.as_tensor(seeds, dtype=torch.int64)
    steps = torch.as_tensor(steps, dtype=torch.int64, device=seeds.device)
    return torch.stack(torch.broadcast_tensors(seeds, steps), dim=-1)


def uniform(keys: torch.Tensor, V: int) -> torch.Tensor:
    """[B, V] f32 uniform in (0, 1), a function of (seed, step, token id)
    only: 24 hashed bits per value, offset by half a step, so 0 and 1 are
    never drawn."""
    seed, step = keys[:, 0], keys[:, 1]
    k = _mix(seed & _M32)
    k = _mix(k ^ ((seed >> 32) & _M32))
    k = _mix(k ^ (step & _M32))
    tid = _mix(torch.arange(V, dtype=torch.int64, device=keys.device) + 0x5BD1E995)
    h = _mix(_mix(k[:, None] ^ tid[None, :]))
    return ((h >> 8).to(torch.float32) + 0.5) * (2.0 ** -24)


def gumbel(keys: torch.Tensor, V: int) -> torch.Tensor:
    """[B, V] f32 standard Gumbel noise, -log(-log(u))."""
    return -torch.log(-torch.log(uniform(keys, V)))


def _categorical(l: torch.Tensor, keys: torch.Tensor | None,
                 noise: torch.Tensor | None) -> torch.Tensor:
    if noise is None:
        if keys is None:
            raise ValueError("sampling needs keys [B, 2] (seed, step) or noise [B, V]")
        noise = gumbel(keys.to(l.device), l.shape[-1])
    return torch.argmax(noise.to(l.device) + l, dim=-1).to(torch.int32)


# -- penalties -----------------------------------------------------------------


def init_penalty_state(prompts: list[list[int]], vocab_size: int, last_n: int,
                       device: str | torch.device = "cpu"):
    """Penalty state from the prompts' tails: counts [B, V] over each row's
    last ``last_n`` tokens, the window ring [B, last_n] itself, the ring's
    write index [B] and fill count [B]."""
    B = len(prompts)
    counts = np.zeros((B, vocab_size), np.int32)
    window = np.zeros((B, last_n), np.int32)
    widx = np.zeros(B, np.int32)
    nfill = np.zeros(B, np.int32)
    for b, p in enumerate(prompts):
        tail = p[-last_n:]
        np.add.at(counts[b], np.asarray(tail, np.int64), 1)
        window[b, : len(tail)] = tail
        widx[b] = len(tail) % last_n
        nfill[b] = len(tail)
    return tuple(torch.from_numpy(a).to(device) for a in (counts, window, widx, nfill))


def update_penalty_state(state, tok: torch.Tensor):
    """Admit sampled tokens [B] into the window: when it is full the
    overwritten slot's token leaves the counts, then the new token is
    counted and recorded. In place; returns the state."""
    widx = state[2]
    return update_penalty_state_rows(state, tok, torch.full_like(widx, state[1].shape[1]))


def update_penalty_state_rows(state, tok: torch.Tensor, last_n: torch.Tensor):
    """update_penalty_state with a window length per row (serving: each
    request has its own penalty_last_n; 0 disables, and that row's counts
    never change). In place; returns the state."""
    counts, window, widx, nfill = state
    rows = torch.arange(tok.shape[0], device=tok.device)
    tok = tok.long()
    ln = torch.clamp(last_n, min=1).to(widx.dtype)
    on = (last_n > 0).to(counts.dtype)
    w = widx.long()
    old = window[rows, w].long()
    evict = (nfill >= ln).to(counts.dtype) * on
    counts.index_put_((rows, old), -evict, accumulate=True)
    counts.index_put_((rows, tok), on, accumulate=True)
    window[rows, w] = torch.where(on > 0, tok, old).to(window.dtype)
    widx.copy_((widx + 1) % ln)
    nfill.copy_(torch.minimum(nfill + on, ln))
    return state


def apply_penalties(logits: torch.Tensor, token_counts: torch.Tensor,
                    repeat_penalty: float = 1.0, presence_penalty: float = 0.0,
                    frequency_penalty: float = 0.0) -> torch.Tensor:
    """llama.cpp's penalties sampler: a seen token's logit is divided by the
    repeat penalty when positive and multiplied by it otherwise, then the
    presence penalty and the count-proportional frequency penalty are
    subtracted (apply_penalties_rows with one value for every row)."""
    B = logits.shape[0]
    return apply_penalties_rows(logits, token_counts, *(
        torch.full((B,), v, dtype=logits.dtype, device=logits.device)
        for v in (repeat_penalty, presence_penalty, frequency_penalty)))


def apply_penalties_rows(logits: torch.Tensor, token_counts: torch.Tensor,
                         repeat_penalty: torch.Tensor, presence_penalty: torch.Tensor,
                         frequency_penalty: torch.Tensor) -> torch.Tensor:
    """apply_penalties with per-row values [B] (rp = 1, pp = fp = 0 rows are
    exact no-ops, so a mixed batch needs no mask)."""
    seen = token_counts > 0
    rp = repeat_penalty[:, None]
    logits = torch.where(seen, torch.where(logits > 0, logits / rp, logits * rp), logits)
    logits = logits - presence_penalty[:, None] * seen.to(logits.dtype)
    return logits - frequency_penalty[:, None] * token_counts.to(logits.dtype)


# -- the chain -----------------------------------------------------------------


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """logits [B, V] -> token ids [B] (int32)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def sample(logits: torch.Tensor, keys: torch.Tensor | None, temperature: float = 1.0,
           top_k: int = 0, top_p: float = 1.0, min_p: float = 0.0,
           noise: torch.Tensor | None = None) -> torch.Tensor:
    """Temperature -> min_p -> top_k -> top_p -> categorical over logits
    [B, V] f32, one setting for every row (sample_rows). Returns [B] int32."""
    if temperature <= 0.0:
        return greedy(logits)
    B, dev = logits.shape[0], logits.device
    f = lambda v: torch.full((B,), v, dtype=torch.float32, device=dev)  # noqa: E731
    return sample_rows(logits, keys, f(temperature),
                       torch.full((B,), top_k, dtype=torch.int64, device=dev), f(top_p),
                       f(min_p), noise)


def sample_rows(logits: torch.Tensor, keys: torch.Tensor | None, temperature: torch.Tensor,
                top_k: torch.Tensor, top_p: torch.Tensor, min_p: torch.Tensor,
                noise: torch.Tensor | None = None) -> torch.Tensor:
    """The chain with per-row settings [B] (temperature <= 0: that row's
    greedy argmax; top_k 0, top_p 1 and min_p 0 are off) and per-row keys:
    one batched pass over a mixed serving batch. Returns [B] int32."""
    V = logits.shape[-1]
    greedy_tok = greedy(logits)
    l = logits / torch.clamp(temperature, min=1e-6)[:, None]
    cutoff = l.amax(dim=-1, keepdim=True) + torch.log(torch.clamp(min_p, min=1e-38))[:, None]
    l = torch.where((min_p[:, None] > 0.0) & (l < cutoff), float("-inf"), l)
    desc = torch.sort(l, dim=-1, descending=True).values
    kth = torch.gather(desc, -1, torch.clamp(top_k.long()[:, None] - 1, 0, V - 1))
    l = torch.where((top_k[:, None] > 0) & (l < kth), float("-inf"), l)
    # top_p: the logit at which the sorted probabilities' running sum
    # reaches top_p (the reference's count of cum < top_p)
    desc = torch.sort(l, dim=-1, descending=True).values
    cum = torch.cumsum(torch.softmax(desc, dim=-1), dim=-1)
    idx = torch.sum(cum < top_p[:, None], dim=-1, keepdim=True).clamp(max=V - 1)
    l = torch.where((top_p[:, None] < 1.0) & (l < torch.gather(desc, -1, idx)), float("-inf"), l)
    return torch.where(temperature <= 0.0, greedy_tok, _categorical(l, keys, noise))


def sample_step(logits: torch.Tensor, keys: torch.Tensor | None, sc: SamplerConfig,
                penalty_state=None, noise: torch.Tensor | None = None):
    """One step of the whole chain under one SamplerConfig. Returns
    (tokens [B] int32, keys with every step advanced by one, the penalty
    state updated in place)."""
    logits = logits.float()
    if sc.uses_penalties:
        logits = apply_penalties(logits, penalty_state[0], sc.repeat_penalty,
                                 sc.presence_penalty, sc.frequency_penalty)
    if sc.is_greedy:
        tok = greedy(logits)
    else:
        tok = sample(logits, keys, sc.temperature, sc.top_k, sc.top_p, sc.min_p, noise)
    if sc.uses_penalties:
        penalty_state = update_penalty_state(penalty_state, tok)
    if keys is not None:
        keys = keys.clone()
        keys[:, 1] += 1
    return tok, keys, penalty_state
