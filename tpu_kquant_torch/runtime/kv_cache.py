"""KV cache, heads-major [L, B, Hkv, S, D], bf16 or int8 with per-token
scales: the port of ``tpu_kquant.runtime.kv_cache.KVCache``, its batch-row
helpers ``slice_batch_row`` / ``set_batch_row``, the context shift
``shift_cache`` and the iSWA layout ``ISWACache`` (full-attention layers
keep every slot, sliding-window layers a ring).

int8 mode stores each (token, kv head) row as int8 codes with one f32 scale,
amax / 127, chosen at append time (``_quant_i8``); attention folds the K
scales into the logits and the V scales into the probabilities.

Unlike the reference's immutable arrays, the port writes appends IN PLACE
into the cache tensors; ``append`` and ``append_all`` return the same
object so call sites read like the reference's. The writes index by the
position tensor on the device, so an append never waits for the host.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_kquant_torch.ops.kv_append import kv_append, kv_append_enabled


def _quant_i8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """int8 KV quantization over the last axis: amax / 127 f32 scales (a
    zero scale divides by 1), codes rounded half to even. 127 is a full
    tensor, as in ops.act_quant: CUDA's division by a Python scalar
    multiplies by its reciprocal."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = amax / torch.full_like(amax, 127.0)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    return torch.round(xf / safe[..., None]).to(torch.int8), scale


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor  # [L, B, Hkv, S, D] bf16, or int8 when quantized
    v: torch.Tensor
    k_scale: torch.Tensor | None = None  # [L, B, Hkv, S] f32 (int8 mode only)
    v_scale: torch.Tensor | None = None

    @staticmethod
    def create(n_layers: int, batch: int, max_seq: int, n_kv_heads: int, head_dim: int,
               device: str | torch.device = "cuda", quantized: bool = False) -> "KVCache":
        shape = (n_layers, batch, n_kv_heads, max_seq, head_dim)
        if quantized:
            return KVCache(torch.zeros(shape, dtype=torch.int8, device=device),
                           torch.zeros(shape, dtype=torch.int8, device=device),
                           torch.zeros(shape[:-1], dtype=torch.float32, device=device),
                           torch.zeros(shape[:-1], dtype=torch.float32, device=device))
        return KVCache(torch.zeros(shape, dtype=torch.bfloat16, device=device),
                       torch.zeros(shape, dtype=torch.bfloat16, device=device))

    @staticmethod
    def from_numpy(k: np.ndarray, v: np.ndarray, k_scale: np.ndarray | None = None,
                   v_scale: np.ndarray | None = None,
                   device: str | torch.device = "cuda") -> "KVCache":
        """A cache holding the same bytes as the given arrays (e.g. a JAX
        ``KVCache``'s fields): int8 codes with f32 scales, or bf16 rows
        (any float array is rounded to bf16)."""
        def t(a, dtype):
            return None if a is None else torch.from_numpy(np.array(a, dtype)).to(device)

        if k_scale is not None:
            return KVCache(t(k, np.int8), t(v, np.int8), t(k_scale, np.float32),
                           t(v_scale, np.float32))
        return KVCache(t(k, np.float32).to(torch.bfloat16), t(v, np.float32).to(torch.bfloat16))

    @property
    def quantized(self) -> bool:
        return self.k.dtype == torch.int8

    @property
    def max_seq(self) -> int:
        return self.k.shape[3]

    def append(self, layer_idx: int, k_new: torch.Tensor, v_new: torch.Tensor,
               positions: torch.Tensor) -> "KVCache":
        """Write layer ``layer_idx``'s new rows: k_new/v_new [B, T, Hkv, D]
        go to slots ``positions`` [B, T]. In place; returns self. A decode
        step's rows on a bf16 cache go through the kv_append kernel where its
        gate passes (ops.kv_append: TKQ_KV_APPEND_PALLAS=1, T = 1, B <= 32,
        S % 16), as the reference dispatches them."""
        B, T = k_new.shape[0], k_new.shape[1]
        if kv_append_enabled(self.quantized, T, B, self.max_seq):
            kv_append(self.k, self.v, k_new, v_new, layer_idx, positions[:, 0])
            return self
        b = torch.arange(B, device=positions.device)[:, None]
        if self.quantized:
            kq, ks = _quant_i8(k_new)
            vq, vs = _quant_i8(v_new)
            self.k_scale[layer_idx, b, :, positions] = ks
            self.v_scale[layer_idx, b, :, positions] = vs
            k_new, v_new = kq, vq
        self.k[layer_idx, b, :, positions] = k_new.to(self.k.dtype)
        self.v[layer_idx, b, :, positions] = v_new.to(self.v.dtype)
        return self

    def append_all(self, k_new: torch.Tensor, v_new: torch.Tensor,
                   positions: torch.Tensor) -> "KVCache":
        """Every layer's new rows at once: k_new/v_new [L, B, T, Hkv, D]
        (the deferred-append decode step). In place; returns self."""
        b = torch.arange(k_new.shape[1], device=positions.device)[:, None]
        # advanced indices (b, positions) split by a slice index [B, T, L, ...]
        if self.quantized:
            kq, ks = _quant_i8(k_new)  # [L, B, T, Hkv, D] / [L, B, T, Hkv]
            vq, vs = _quant_i8(v_new)
            self.k_scale[:, b, :, positions] = ks.permute(1, 2, 0, 3)
            self.v_scale[:, b, :, positions] = vs.permute(1, 2, 0, 3)
            k_new, v_new = kq, vq
        self.k[:, b, :, positions] = k_new.permute(1, 2, 0, 3, 4).to(self.k.dtype)
        self.v[:, b, :, positions] = v_new.permute(1, 2, 0, 3, 4).to(self.v.dtype)
        return self

    def layer_view(self, layer_idx: int):
        """(k [B, Hkv, S, D], v, scales) for attention: scales is
        (k_scale, v_scale) [B, Hkv, S] each in int8 mode, else None."""
        if self.quantized:
            return (self.k[layer_idx], self.v[layer_idx],
                    (self.k_scale[layer_idx], self.v_scale[layer_idx]))
        return self.k[layer_idx], self.v[layer_idx], None


@dataclasses.dataclass
class ISWACache:
    """The iSWA layout (the reference's ISWACache; llama.cpp's
    llama_kv_cache_unified_iswa): two stacked caches, the full-attention
    layers' of max_seq slots and the sliding-window layers' RING of ``ring``
    slots (position p in slot p % ring), so a window layer's KV memory is
    bounded by its window, not by the context. ``layer_map`` gives each
    model layer's (kind, index): ("full", i) or ("swa", i). Written in
    place, as KVCache."""

    full: KVCache | None  # [L_full, B, Hkv, max_seq, D]
    swa: KVCache | None  # [L_swa, B, Hkv, ring, D]
    layer_map: tuple
    ring: int

    @staticmethod
    def create(windows: list[int], batch: int, max_seq: int, ring: int, n_kv_heads: int,
               head_dim: int, device: str | torch.device = "cuda",
               quantized: bool = False) -> "ISWACache":
        """windows: each layer's sliding window (0: full attention)."""
        lmap = []
        for w in windows:
            kind = "swa" if w > 0 else "full"
            lmap.append((kind, sum(k == kind for k, _ in lmap)))

        def mk(kind: str, slots: int) -> KVCache | None:
            n = sum(k == kind for k, _ in lmap)
            return KVCache.create(n, batch, slots, n_kv_heads, head_dim, device,
                                  quantized) if n else None

        return ISWACache(mk("full", max_seq), mk("swa", ring), tuple(lmap), ring)

    @property
    def quantized(self) -> bool:
        return (self.full or self.swa).quantized

    @property
    def max_seq(self) -> int:
        return (self.full or self.swa).max_seq

    def append(self, layer_idx: int, k_new: torch.Tensor, v_new: torch.Tensor,
               positions: torch.Tensor, valid: torch.Tensor | None = None) -> "ISWACache":
        """Write layer ``layer_idx``'s rows k_new / v_new [B, T, Hkv, D] at
        ``positions`` [B, T]: a full layer's at the positions, a ring
        layer's at positions % ring. A decode step (T = 1) writes through
        KVCache.append; a prefill chunk (it may wrap the ring) scatters each
        row's tokens and, where ``valid`` [B, T] is given, leaves the slots
        of its pad tokens as they are: a pad's slot may hold that row's live
        history, unlike on the unified layout. In place; returns self."""
        kind, li = self.layer_map[layer_idx]
        if kind == "full":
            self.full.append(li, k_new, v_new, positions)
            return self
        slots = torch.remainder(positions, self.ring)
        if k_new.shape[1] == 1:
            self.swa.append(li, k_new, v_new, slots)
            return self
        c = self.swa
        b = torch.arange(k_new.shape[0], device=slots.device)[:, None]

        def scat(full: torch.Tensor, val: torch.Tensor) -> None:
            # the advanced indices (b, slots), split by the head axis, lead:
            # the gathered / written shape is [B, T, Hkv(, D)]
            val = val.to(full.dtype)
            if valid is not None:
                keep = valid.reshape(valid.shape + (1,) * (val.dim() - 2))
                val = torch.where(keep, val, full[li, b, :, slots])
            full[li, b, :, slots] = val

        if c.quantized:
            kq, ks = _quant_i8(k_new)
            vq, vs = _quant_i8(v_new)
            for full, val in ((c.k, kq), (c.v, vq), (c.k_scale, ks), (c.v_scale, vs)):
                scat(full, val)
        else:
            scat(c.k, k_new)
            scat(c.v, v_new)
        return self

    def layer_view(self, layer_idx: int):
        kind, li = self.layer_map[layer_idx]
        return (self.full if kind == "full" else self.swa).layer_view(li)

    def is_ring(self, layer_idx: int) -> bool:
        return self.layer_map[layer_idx][0] == "swa"


def shift_cache(cache: KVCache, n_keep: int, n_discard: int, rope) -> KVCache:
    """Context shift: drop positions [n_keep, n_keep + n_discard) and slide
    the tail down, re-rotating the moved K rows by -n_discard positions (the
    reference's shift_cache; llama.cpp's seq_rm + seq_add K-shift). Slot j >=
    n_keep takes slot min(j + n_discard, S - 1). ``rope`` is the rope the
    forward applied to K: the loader's cfg.rope, NEOX pairing after its q/k
    permutation. bf16 K is rotated in f32 and rounded; int8 K is
    dequantized, rotated and requantized with fresh per-(token, head) scales
    (_quant_i8); V only moves.

    IN PLACE, unlike the reference (JAX donates the cache): each layer's
    moved rows are gathered into a new tensor first, then written back, so
    no read sees a row this shift has already written. Returns cache."""
    from tpu_kquant_torch.ops.rope import apply_rope, rope_delta_cos_sin

    S = cache.max_seq
    if n_keep >= S:
        return cache
    dev = cache.k.device
    src = torch.clamp(torch.arange(n_keep, S, device=dev) + n_discard, max=S - 1)
    cos, sin = rope_delta_cos_sin(-n_discard, rope, dev)
    for layer in range(cache.k.shape[0]):
        k = cache.k[layer].index_select(2, src)  # [B, Hkv, S - n_keep, D]
        v = cache.v[layer].index_select(2, src)
        if cache.quantized:
            ks = cache.k_scale[layer].index_select(2, src)
            vs = cache.v_scale[layer].index_select(2, src)
            k, ks = _quant_i8(apply_rope(k.float() * ks[..., None], cos, sin, rope.mode))
            cache.k_scale[layer, :, :, n_keep:] = ks
            cache.v_scale[layer, :, :, n_keep:] = vs
        else:
            k = apply_rope(k, cos, sin, rope.mode)
        cache.k[layer, :, :, n_keep:] = k
        cache.v[layer, :, :, n_keep:] = v
    return cache


def slice_batch_row(cache: KVCache, slot: int) -> KVCache:
    """Batch row ``slot`` as a [L, 1, ...] cache that is a VIEW of ``cache``:
    a forward over it writes the row in place (serving's slot prefill)."""
    def row(t):
        return None if t is None else t.narrow(1, slot, 1)

    return KVCache(row(cache.k), row(cache.v), row(cache.k_scale), row(cache.v_scale))


def set_batch_row(cache: KVCache, row: KVCache, slot: int) -> KVCache:
    """Copy a [L, 1, ...] row cache into batch row ``slot`` in place (a row
    that is already that view of ``cache`` is left as it is). Returns
    cache."""
    for dst, src in ((cache.k, row.k), (cache.v, row.v), (cache.k_scale, row.k_scale),
                     (cache.v_scale, row.v_scale)):
        if dst is None:
            continue
        d = dst.narrow(1, slot, 1)
        if d.data_ptr() != src.data_ptr():
            d.copy_(src)
    return cache


def set_batch_rows(cache: KVCache, src: KVCache, slots: torch.Tensor) -> KVCache:
    """Copy every row of a burst cache ``src`` [L, k, Hkv, T, ...], T <=
    S, into the first T slots of batch rows ``slots`` [k] of ``cache``: one
    indexed write per tensor, in place. Slots past T keep what they held;
    they lie past each row's position, so attention masks them until a
    decode step overwrites them. Returns cache."""
    T = src.k.shape[3]
    for dst, s in ((cache.k, src.k), (cache.v, src.v), (cache.k_scale, src.k_scale),
                   (cache.v_scale, src.v_scale)):
        if dst is not None:
            dst[:, slots, :, :T] = s
    return cache
