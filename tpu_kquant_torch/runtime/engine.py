"""Inference engine around the llama forward: the port of
``tpu_kquant.runtime.engine.InferenceEngine`` (greedy and sampled
generation, and the slot prefill that serving builds on) on a bf16 or int8
(``kv_quantized``) KV cache.

prefill(tokens [B, T]): bucketed T, right-padded. Padded slots write stale
K/V beyond a row's length, which is safe because a later decode step
always overwrites slot p before any query can attend it (mask j <= q_pos).
Only here (and in the slot prefill and the serving burst, whose positions
are arange(T) too) may attention be bounded to the first T slots
(kv_attend_len): every query position is below T.
decode_step(tokens [B]): one token per row; never bounds attention.
step(tokens [B, T], positions [B, T]): the reference's general ``_step``,
for T > 1 windows at any positions (speculative verification, perplexity);
never bounds attention either. Within the GEMV's rows on a bf16 cache, row
t of a window equals the decode step at its position bit for bit
(models.llama: window_rows).
prefill_slot(tokens, cache, slot): one request into batch row ``slot``,
through a forward over a view of that row, so nothing is copied and the
other rows stay as they are.
decode_greedy / decode_sampled: n decode steps, the sampler chain after
each, on the device with no host read until the caller reads. On a CUDA
device each step is a replay of one captured step (runtime.graphs: the
reference's one-dispatch ``_decode_loop`` / ``_decode_loop_sampled``): the
step reads its token and position from static buffers, writes its token
into column ``col`` of a [B, LOOP_WIDTH] buffer and feeds the next step
from its own outputs, so the host issues one graph launch a step. The graph
is keyed on the batch, the cache's tensors, the sampler configuration and
the forward's switches (``_loop``); a new cache costs one capture, whose
warm run is the loop's first step. On the CPU, or with ``plain=True``, the
loop is the plain Python loop of decode steps; ``plain=False`` on the CPU
runs the captured step's body eagerly. Sampled generation runs
ops.sampling's chain after each step; row i of a batch draws from the
stream of seed + i (the serving batcher's per-request seeds use the same
streams). ``impl`` is the
reference's (engine.py:52): "auto", or "int8" for the Q8-activation path of
ops.qmatmul on weights loaded with ``scale_dtype="f32"``.
Context shift (``shift_context``; ``generate(context_shift=True)``, a
host-stepped loop as in the reference) slides the cache IN PLACE
(runtime.kv_cache.shift_cache). Sessions (``save_session`` /
``load_session``) use the reference's npz format, so a file from either
package loads in the other.
kv_layout "iswa" (the reference's; llama.cpp's llama_kv_cache_unified_iswa)
needs a sliding-window arch: its window layers keep a ring of window +
``iswa_chunk`` slots (rounded up to 16, at most max_seq;
runtime.kv_cache.ISWACache) in place of max_seq, and a prompt prefills in
chunks of the largest bucket within ring - window tokens (``_prefill_iswa``),
so every query finds its whole window in the ring and no pad wraps onto a
live slot. Slot prefill (serving), context shift and sessions stay on the
unified layout, as in the reference.
A recurrent config (mamba: ``cfg.is_recurrent``) runs models.mamba's
forward on a ``RecurrentCache`` (the unified layout, a bf16 forward, f32
state; the constructor refuses iSWA and int8 KV, as the reference's does,
and the port has no stacked-layer forward). Its prefill masks the right
pads (``_step_valid``), since a recurrent update is forever where a pad KV
slot is overwritten later; the slot prefill zeroes the reused row first;
``decode_step(valid=)`` leaves the rows marked False as they were (serving's
fresh and idle rows); sessions hold the ``conv`` / ``ssm`` state
(``recurrent`` = 1, the reference's keys); context shift raises.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from tpu_kquant_torch.models.config import ModelConfig
from tpu_kquant_torch.models.llama import llama_forward
from tpu_kquant_torch.models.mamba import RecurrentCache, mamba_forward
from tpu_kquant_torch.ops.qmatmul import IMPLS
from tpu_kquant_torch.ops.sampling import (
    SamplerConfig,
    greedy,
    init_penalty_state,
    row_keys,
    sample_step,
)
from tpu_kquant_torch.runtime.graphs import (
    GraphCache,
    StepGraph,
    cache_tensors,
    switches,
    tensor_key,
)
from tpu_kquant_torch.runtime.kv_cache import ISWACache, KVCache, shift_cache, slice_batch_row
from tpu_kquant_torch.runtime.loader import resolve_device

PREFILL_BUCKETS = (16, 32, 64, 128, 256, 512, 1024, 2048)
LOOP_WIDTH = 256  # columns of a decode loop's token buffer; longer loops go in turns


def _bucket(n: int) -> int:
    for b in PREFILL_BUCKETS:
        if n <= b:
            return b
    return -(-n // 2048) * 2048


def _param_device(params: dict[str, Any]) -> torch.device:
    return next(iter(params["tok_embd"].arrays.values())).device


@dataclasses.dataclass
class _Loop:
    """A decode loop's static tensors and its captured step (module
    docstring): the step's token and position [B], the token buffer's next
    column [1] and the buffer [B, LOOP_WIDTH] (i64), the sampler's keys [B,
    2] and penalty state (sampled loops)."""

    tok: torch.Tensor
    pos: torch.Tensor
    col: torch.Tensor
    out: torch.Tensor
    keys: torch.Tensor | None
    pstate: tuple | None
    graph: StepGraph


class InferenceEngine:
    def __init__(
        self,
        cfg: ModelConfig,
        params: dict[str, Any],
        max_batch: int = 1,
        max_seq: int | None = None,
        kv_quantized: bool = False,
        kv_layout: str = "unified",
        device: str | torch.device = "cuda",
        impl: str = "auto",
        iswa_chunk: int = 512,
    ):
        """params must already live on ``device`` (load_model(device=...)).
        kv_quantized: int8 KV cache with per-token scales. impl: "auto" or
        "int8" (module docstring). kv_layout: "unified" or "iswa" (a
        sliding-window arch only); iswa_chunk: the prefill chunk its rings
        make room for."""
        if kv_layout not in ("unified", "iswa"):
            raise ValueError(f"kv_layout must be 'unified' or 'iswa', got {kv_layout!r}")
        if kv_layout == "iswa" and cfg.sliding_window <= 0:
            raise ValueError("kv_layout='iswa' needs a sliding-window arch")
        if cfg.is_recurrent and (kv_layout != "unified" or kv_quantized):
            raise ValueError("recurrent archs use the default unified layout and fp state")
        if impl not in IMPLS:
            raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
        self.impl = impl
        self.kv_layout = kv_layout
        self.iswa_chunk = iswa_chunk
        self.device = resolve_device(device)
        pdev = _param_device(params)
        if pdev.type != self.device.type:
            raise ValueError(f"params are on {pdev}, the engine runs on {self.device}")
        self.cfg = cfg
        self.params = params
        self.max_batch = max_batch
        self.max_seq = max_seq or cfg.max_seq_len
        self.kv_quantized = kv_quantized
        self._graphs = GraphCache()
        self.last_logits: torch.Tensor | None = None  # [B, V]: the last loop's last step

    def new_cache(self, batch: int | None = None,
                  max_seq: int | None = None) -> KVCache | ISWACache | RecurrentCache:
        """A zeroed cache of ``batch`` rows (max_batch) and ``max_seq`` slots
        (the engine's; serving's burst asks for a prefill bucket's T); on
        the iSWA layout the window layers' rings hold ``ring`` slots; a
        recurrent model's state has no slots."""
        cfg, batch, max_seq = self.cfg, batch or self.max_batch, max_seq or self.max_seq
        if cfg.is_recurrent:
            return RecurrentCache.create(cfg.n_layers, batch, cfg.ssm_d_conv, cfg.ssm_d_inner,
                                         cfg.ssm_d_state, device=self.device)
        if self.kv_layout == "iswa":
            # window + a prefill chunk, as llama.cpp's n_swa + n_ubatch
            ring = min(max_seq, -(-(cfg.sliding_window + self.iswa_chunk) // 16) * 16)
            return ISWACache.create([cfg.layer_window(i) for i in range(cfg.n_layers)], batch,
                                    max_seq, ring, cfg.n_kv_heads, cfg.head_dim,
                                    device=self.device, quantized=self.kv_quantized)
        return KVCache.create(cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim,
                              device=self.device, quantized=self.kv_quantized)

    def _tensor(self, a) -> torch.Tensor:
        return torch.tensor(np.array(a), dtype=torch.long, device=self.device)

    def _long(self, a) -> torch.Tensor:
        """A tensor, array or list as int64 on the engine's device."""
        return a.long().to(self.device) if torch.is_tensor(a) else self._tensor(a)

    def _forward(self, tokens: torch.Tensor, positions: torch.Tensor, cache, **kw):
        """The model's forward (mamba's for a recurrent config, else the
        llama family's), looked up at call time, under the engine's impl."""
        fwd = mamba_forward if self.cfg.is_recurrent else llama_forward
        return fwd(self.params, self.cfg, tokens, positions, cache, impl=self.impl, **kw)

    # -- steps -----------------------------------------------------------------
    @torch.no_grad()
    def prefill(self, token_rows: list[list[int]], cache: KVCache):
        """Right-padded bucketed prefill. Returns (last_logits [B, V] f32,
        cache, lengths [B] numpy)."""
        B = len(token_rows)
        lens = np.array([len(t) for t in token_rows], np.int64)
        if int(lens.max()) > self.max_seq:
            raise ValueError(f"prompt length {int(lens.max())} exceeds max_seq {self.max_seq}")
        if self.kv_layout == "iswa":
            return self._prefill_iswa(token_rows, cache, lens)
        T = min(_bucket(int(lens.max())), self.max_seq)
        toks = np.zeros((B, T), np.int64)
        for i, row in enumerate(token_rows):
            toks[i, : len(row)] = row
        positions = np.broadcast_to(np.arange(T), (B, T))
        if self.cfg.is_recurrent:  # a pad step must not move the state
            valid = torch.from_numpy(positions < lens[:, None]).to(self.device)
            logits, cache = self._step_valid(self._tensor(toks), self._tensor(positions), cache,
                                             valid)
        else:
            kw = {"kv_attend_len": T} if T > 1 else {}
            logits, cache = self._forward(self._tensor(toks), self._tensor(positions), cache,
                                          **kw)
        last = logits[torch.arange(B, device=self.device), self._tensor(lens - 1)]
        return last, cache, lens

    def _prefill_iswa(self, token_rows: list[list[int]], cache: ISWACache, lens: np.ndarray):
        """The iSWA layout's prefill, in chunks of C tokens, C the largest
        bucket <= ring - window: a chunk's queries find their whole window
        in the ring, and its pad tokens (kv_valid) leave it as it is. Each
        chunk takes logits only at each row's last prompt token (its
        ``logits_rows``; rows that end elsewhere are dropped), the
        reference's last logits without its [B, T, vocab] of the rest. A
        chunk ends at max_seq, as the unified prefill's bucket does (the
        reference's last bucket may pass it, and a full layer's write then
        lands clamped onto earlier slots). Returns (last_logits [B, V] f32,
        cache, lengths)."""
        B, W = len(token_rows), self.cfg.sliding_window
        if cache.ring - W < PREFILL_BUCKETS[0]:
            raise ValueError(f"iswa ring {cache.ring} too small for window {W}")
        C = max(b for b in PREFILL_BUCKETS if b <= cache.ring - W)
        maxlen = int(lens.max())
        last = torch.zeros((B, self.cfg.vocab_size), dtype=torch.float32, device=self.device)
        for c0 in range(0, maxlen, C):
            T = min(_bucket(min(C, maxlen - c0)), C, self.max_seq - c0)
            toks = np.zeros((B, T), np.int64)
            for i, row in enumerate(token_rows):
                seg = row[c0:c0 + T]
                toks[i, : len(seg)] = seg
            positions = np.broadcast_to(c0 + np.arange(T), (B, T))
            valid = torch.from_numpy(positions < lens[:, None]).to(self.device)
            end = np.clip(lens - 1 - c0, 0, T - 1)
            logits, cache = self._step_valid(self._tensor(toks), self._tensor(positions), cache,
                                             valid, logits_rows=self._tensor(end))
            here = torch.from_numpy((lens - 1 >= c0) & (lens - 1 < c0 + T)).to(self.device)
            last = torch.where(here[:, None], logits[:, 0], last)
        return last, cache, lens

    @torch.no_grad()
    def _step_valid(self, tokens: torch.Tensor, positions: torch.Tensor, cache,
                    kv_valid: torch.Tensor, logits_rows: torch.Tensor | None = None):
        """Forward over [B, T] tokens with the pad mask ``kv_valid`` [B, T]:
        serving's admission burst (positions arange(T) per row: attention
        reads only the first T slots) and the iSWA prefill's chunks (any
        positions; logits at ``logits_rows`` only). Returns (logits [B, T or
        1, V] f32, cache)."""
        T = tokens.shape[1]
        kw = {"kv_attend_len": T} if self.kv_layout == "unified" and T > 1 else {}
        return self._forward(tokens, positions, cache, kv_valid=kv_valid,
                             logits_rows=logits_rows, **kw)

    @torch.no_grad()
    def _prefill_slot(self, tokens: torch.Tensor, positions: torch.Tensor, cache: KVCache,
                      slot: int, kv_valid: torch.Tensor):
        """Prefill one sequence [1, T] (positions arange(T)) into batch row
        ``slot``: the forward runs over a view of the row, so its appends
        land in ``cache`` and no other row is touched. Attention reads only
        the first T slots. A recurrent row is zeroed first: it still holds
        the previous request's final state, and the forward starts from the
        row it is given. Unified layout only (prefill_slot). Returns
        (logits [T, V] f32, cache)."""
        T = tokens.shape[1]
        kw = {"kv_attend_len": T} if self.kv_layout == "unified" and T > 1 else {}
        row = cache.row(slot).zero_() if self.cfg.is_recurrent else slice_batch_row(cache, slot)
        logits, _ = self._forward(tokens, positions, row, kv_valid=kv_valid, **kw)
        return logits[0], cache

    def prefill_slot(self, tokens: list[int], cache: KVCache, slot: int):
        """Prefill one request into batch row ``slot``. Returns (last_logits
        [V] f32, cache)."""
        if self.kv_layout != "unified":
            raise NotImplementedError("slot prefill requires the unified KV layout")
        if len(tokens) > self.max_seq:
            raise ValueError(f"prompt length {len(tokens)} exceeds max_seq {self.max_seq}")
        T = min(_bucket(len(tokens)), self.max_seq)
        toks = np.zeros((1, T), np.int64)
        toks[0, : len(tokens)] = tokens
        positions = np.arange(T)[None, :]
        valid = torch.from_numpy(positions < len(tokens)).to(self.device)
        logits, cache = self._prefill_slot(self._tensor(toks), self._tensor(positions), cache,
                                           slot, valid)
        return logits[len(tokens) - 1], cache

    @torch.no_grad()
    def step(self, tokens, positions, cache: KVCache, last_only: bool = False):
        """tokens [B, T], positions [B, T] (tensors or arrays; contiguous per
        row, anywhere in the sequence) -> (logits [B, T or 1, V] f32, cache).
        The reference's ``_step``: attention is never bounded (no
        kv_attend_len), since the queries may sit mid-sequence."""
        return self._forward(self._long(tokens), self._long(positions), cache,
                             logits_last_only=last_only)

    @torch.no_grad()
    def decode_step(self, tokens: torch.Tensor, positions: torch.Tensor, cache: KVCache,
                    valid: torch.Tensor | None = None):
        """tokens [B], positions [B] -> (logits [B, V] f32, cache). ``valid``
        [B] bool, recurrent models only: the rows marked False keep their
        state as it was (serving's fresh and idle rows; their logits are not
        used)."""
        kw = {} if valid is None else {"kv_valid": valid[:, None]}
        logits, cache = self._forward(tokens.long()[:, None], positions.long()[:, None], cache,
                                      logits_last_only=True, **kw)
        return logits[:, 0, :], cache

    def _plain(self, plain: bool | None) -> bool:
        return self.device.type != "cuda" if plain is None else plain

    @torch.no_grad()
    def decode_greedy(self, first_tok: torch.Tensor, start_pos: torch.Tensor,
                      cache: KVCache, n_steps: int, plain: bool | None = None):
        """[B] first tokens at positions start_pos -> ([B, n_steps] greedy
        tokens that follow, cache). Stays on the device: the host reads
        nothing until the caller does. A CUDA device replays the captured
        step (module docstring); the CPU, or ``plain=True``, runs the plain
        loop."""
        if self._plain(plain) or n_steps == 0:
            tok, pos = first_tok.long(), start_pos.long()
            out = []
            for _ in range(n_steps):
                logits, cache = self.decode_step(tok, pos, cache)
                tok = greedy(logits).long()
                pos = pos + 1
                out.append(tok)
                self.last_logits = logits
            if not out:
                return torch.empty((first_tok.shape[0], 0), dtype=torch.long,
                                   device=self.device), cache
            return torch.stack(out, dim=1), cache
        loop = self._loop(cache, first_tok.shape[0])
        return self._run_loop(loop, cache, first_tok, start_pos, n_steps, None), cache

    @torch.no_grad()
    def decode_sampled(self, first_tok: torch.Tensor, start_pos: torch.Tensor, cache: KVCache,
                       n_steps: int, sc: SamplerConfig, keys: torch.Tensor, penalty_state=None,
                       plain: bool | None = None):
        """decode_greedy with the whole sampler chain after every step:
        ([B, n_steps] tokens, cache, keys, penalty state (updated in place)).
        Stays on the device."""
        if self._plain(plain) or n_steps == 0:
            tok, pos = first_tok.long(), start_pos.long()
            out = []
            for _ in range(n_steps):
                logits, cache = self.decode_step(tok, pos, cache)
                tok, keys, penalty_state = sample_step(logits, keys, sc, penalty_state)
                tok = tok.long()
                pos = pos + 1
                out.append(tok)
                self.last_logits = logits
            if not out:
                return (torch.empty((first_tok.shape[0], 0), dtype=torch.long,
                                    device=self.device), cache, keys, penalty_state)
            return torch.stack(out, dim=1), cache, keys, penalty_state
        loop = self._loop(cache, first_tok.shape[0], sc, keys, penalty_state)
        if keys is not None:
            loop.keys.copy_(keys)
        for mine, theirs in zip(loop.pstate or (), penalty_state or ()):
            mine.copy_(theirs)
        toks = self._run_loop(loop, cache, first_tok, start_pos, n_steps, sc)
        for mine, theirs in zip(loop.pstate or (), penalty_state or ()):
            theirs.copy_(mine)
        return toks, cache, None if keys is None else loop.keys.clone(), penalty_state

    def _loop(self, cache, B: int, sc: SamplerConfig | None = None, keys=None,
              pstate=None) -> _Loop:
        """The captured decode step of B rows on this cache (module
        docstring), made on first use; ``sc`` None: greedy."""
        tensors = cache_tensors(cache)
        key = (B, sc, keys is None, tuple(tuple(t.shape) for t in pstate or ()), switches(),
               type(cache).__name__, tensor_key(tensors))

        def make() -> _Loop:
            z = lambda *s: torch.zeros(s, dtype=torch.long, device=self.device)  # noqa: E731
            return _Loop(z(B), z(B), z(1), z(B, LOOP_WIDTH),
                         None if sc is None or keys is None else z(B, 2),
                         None if pstate is None else tuple(torch.empty_like(t) for t in pstate),
                         StepGraph(self.device))

        return self._graphs.get(key, make, tensors)

    def _loop_step(self, loop: _Loop, cache, sc: SamplerConfig | None):
        """The captured step: one decode step of loop.tok at loop.pos, the
        sampler, the token into loop.out's column loop.col, then the next
        step's token and position. Returns (logits,)."""
        logits, _ = self.decode_step(loop.tok, loop.pos, cache)
        if sc is None:
            tok = greedy(logits).long()
        else:
            tok, keys, _ = sample_step(logits, loop.keys, sc, loop.pstate)
            tok = tok.long()
            if keys is not None:
                loop.keys.copy_(keys)
        loop.out.index_copy_(1, loop.col, tok[:, None])
        loop.tok.copy_(tok)
        loop.pos.add_(1)
        loop.col.add_(1)
        return (logits,)

    def _run_loop(self, loop: _Loop, cache, first_tok, start_pos, n_steps: int,
                  sc: SamplerConfig | None) -> torch.Tensor:
        """n_steps runs of the loop's step from (first_tok, start_pos), in
        turns of LOOP_WIDTH columns. Returns the [B, n_steps] tokens."""
        loop.tok.copy_(first_tok)
        loop.pos.copy_(start_pos)
        parts = []
        for s0 in range(0, n_steps, LOOP_WIDTH):
            k = min(LOOP_WIDTH, n_steps - s0)
            loop.col.zero_()
            for _ in range(k):
                (self.last_logits,) = loop.graph.run(self._loop_step, loop, cache, sc)
            parts.append(loop.out[:, :k].clone())
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)

    def shift_context(self, cache: KVCache, positions, n_keep: int, n_discard: int):
        """Discard positions [n_keep, n_keep + n_discard) from every row and
        slide the tail down, K re-rotated (in place: shift_cache). Returns
        (cache, new positions [B] on the device). Every row must hold at
        least n_keep + n_discard live entries, or it would lose tokens it
        still attends to."""
        if self.kv_layout != "unified" or self.cfg.is_recurrent:
            raise NotImplementedError("context shift requires the unified KV layout")
        positions = self._long(positions)
        low = int(positions.min())
        if low < n_keep + n_discard:
            raise ValueError(f"shift of {n_discard} after keep={n_keep} would drop live "
                             f"entries of a row at position {low}")
        cache = shift_cache(cache, int(n_keep), int(n_discard), self.cfg.rope)
        return cache, positions - n_discard

    # -- session persistence ---------------------------------------------------
    def save_session(self, path: str, cache: KVCache, lengths) -> None:
        """Write a KV cache and its rows' lengths in the reference's npz
        format (resume generation without a new prefill): bf16 stored as its
        uint16 bits, ``kv_dtype`` the dtype's name as bytes, int8 caches with
        ``k_scale`` / ``v_scale``. A recurrent state is its f32 ``conv`` and
        ``ssm`` arrays and ``recurrent`` = 1."""
        if self.kv_layout != "unified":
            raise NotImplementedError("sessions require the unified KV layout")
        if self.cfg.is_recurrent:
            np.savez(path, lengths=np.asarray(lengths, np.int32),
                     conv=cache.conv.detach().cpu().numpy(),
                     ssm=cache.ssm.detach().cpu().numpy(), recurrent=np.int32(1))
            return

        def enc(t: torch.Tensor) -> np.ndarray:
            t = t.detach().cpu()
            if t.dtype == torch.bfloat16:
                return t.view(torch.int16).numpy().view(np.uint16)
            return t.numpy()

        name = "int8" if cache.quantized else "bfloat16"
        arrs = {"lengths": np.asarray(lengths, np.int32), "k": enc(cache.k), "v": enc(cache.v),
                "kv_dtype": np.frombuffer(name.encode(), np.uint8)}
        if cache.quantized:
            arrs["k_scale"] = enc(cache.k_scale)
            arrs["v_scale"] = enc(cache.v_scale)
        np.savez(path, **arrs)

    def load_session(self, path: str) -> tuple[KVCache | RecurrentCache, np.ndarray]:
        """Read a session written by either package. Returns (cache on the
        engine's device, lengths [B] numpy)."""
        with np.load(path) as z:
            if "recurrent" in z:
                state = [torch.from_numpy(np.array(z[k], np.float32)).to(self.device)
                         for k in ("conv", "ssm")]
                return RecurrentCache(*state), np.array(z["lengths"])
            name = bytes(z["kv_dtype"]).decode()

            def dec(a: np.ndarray) -> torch.Tensor:
                if name == "bfloat16":  # uint16 bits
                    return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(self.device)
                return torch.from_numpy(a).to(self.device)

            scales = [dec(z[k]) if k in z else None for k in ("k_scale", "v_scale")]
            return KVCache(dec(z["k"]), dec(z["v"]), *scales), np.array(z["lengths"])

    # -- generation ------------------------------------------------------------
    def generate(self, prompts: list[list[int]], max_new_tokens: int = 32,
                 temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
                 eos_id: int | None = None, seed: int = 0, context_shift: bool = False,
                 n_keep: int = 0, min_p: float = 0.0, repeat_penalty: float = 1.0,
                 presence_penalty: float = 0.0, frequency_penalty: float = 0.0,
                 penalty_last_n: int = 64) -> list[list[int]]:
        """Greedy or sampled generation (the reference's options); returns the
        new ids per row (cut after eos_id). Row i draws from the stream of
        seed + i. Penalties follow llama.cpp's over the last penalty_last_n
        context tokens. Generation stops at the KV capacity, unless
        ``context_shift``: then, when the cache is full, half of the
        (max_seq - n_keep) positions after the first n_keep are discarded
        and generation goes on (llama.cpp main's --keep), in a loop that
        the host steps, as the reference's."""
        sc = SamplerConfig(temperature=temperature, top_k=top_k, top_p=top_p, min_p=min_p,
                           repeat_penalty=repeat_penalty, presence_penalty=presence_penalty,
                           frequency_penalty=frequency_penalty, penalty_last_n=penalty_last_n)
        B = len(prompts)
        cache = self.new_cache(B)
        logits, cache, lens = self.prefill(prompts, cache)
        if context_shift:
            return self._generate_shifting(logits, cache, lens, prompts, max_new_tokens, sc,
                                           eos_id, seed, n_keep)
        max_new_tokens = min(max_new_tokens, self.max_seq - int(lens.max()))
        if max_new_tokens <= 0:
            return [[] for _ in range(B)]
        if sc.is_greedy and not sc.uses_penalties:
            first = greedy(logits).long()
            rest, cache = self.decode_greedy(first, self._tensor(lens), cache,
                                             max_new_tokens - 1)
        else:
            keys = row_keys(torch.arange(B) + seed, 0).to(self.device)
            pstate = (init_penalty_state(prompts, self.cfg.vocab_size, penalty_last_n,
                                         self.device) if sc.uses_penalties else None)
            first, keys, pstate = sample_step(logits, keys, sc, pstate)
            first = first.long()
            rest, cache, keys, pstate = self.decode_sampled(first, self._tensor(lens), cache,
                                                            max_new_tokens - 1, sc, keys, pstate)
        toks = torch.cat([first[:, None], rest], dim=1).cpu().numpy()
        out = []
        for i in range(B):
            row = [int(t) for t in toks[i]]
            if eos_id is not None and eos_id in row:
                row = row[: row.index(eos_id) + 1]
            out.append(row)
        return out

    def _generate_shifting(self, logits, cache, lens, prompts, max_new_tokens: int,
                           sc: SamplerConfig, eos_id, seed: int, n_keep: int):
        """generate's context-shift loop: one decode step and one sampler
        step at a time, shifting the cache whenever a row reaches max_seq.
        Each step draws as decode_sampled's does, so without a shift the
        tokens are generate's own."""
        B = len(prompts)
        plain = sc.is_greedy and not sc.uses_penalties
        keys = None if plain else row_keys(torch.arange(B) + seed, 0).to(self.device)
        pstate = (init_penalty_state(prompts, self.cfg.vocab_size, sc.penalty_last_n,
                                     self.device) if sc.uses_penalties else None)
        positions = self._tensor(lens)
        out: list[list[int]] = [[] for _ in range(B)]
        done = np.zeros(B, bool)
        tok = None
        for i in range(max_new_tokens):
            if i > 0:
                if int(positions.max()) >= self.max_seq:
                    n_discard = max(1, (self.max_seq - n_keep) // 2)
                    cache, positions = self.shift_context(cache, positions, n_keep, n_discard)
                logits, cache = self.decode_step(tok, positions, cache)
                positions = positions + 1
            if plain:
                tok = greedy(logits).long()
            else:
                tok, keys, pstate = sample_step(logits, keys, sc, pstate)
                tok = tok.long()
            for b, t in enumerate(tok.tolist()):
                if not done[b]:
                    out[b].append(int(t))
                    done[b] = eos_id is not None and t == eos_id
            if done.all():
                break
        return out
