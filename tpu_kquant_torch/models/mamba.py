"""Mamba (S6 selective state space): the recurrent family, the port of
``tpu_kquant.models.mamba``.

llama.cpp serves its ``mamba`` architecture from the recurrent memory
backend (SURVEY.md §2.1): a layer's "cache" is not a KV ring but a fixed
state per sequence, the depthwise conv's last d_conv - 1 inputs and the SSM
state [d_inner, d_state], so context costs no memory at decode.

Tensor names follow llama.cpp's GGUF export (``blk.N.ssm_{in,conv1d,x,dt,a,
d,out}``, runtime.loader._load_mamba); the widths come from the
``mamba.ssm.*`` metadata.

A layer over T steps (``mamba_layer_scan``) runs the function the
reference computes:
- the time-independent matmuls (ssm_in, ssm_x, ssm_dt, ssm_out) once over
  all B * T rows, each through ops.qmatmul (the qmm kernel on the card: the
  GEMV at <= 32 rows, the wgmma tile above);
- the depthwise causal conv over the carried inputs and this call's, and
  ``dA = exp(dt A)``, ``dBx = dt x B`` in f32 for every step at once;
- a loop over t of one fused multiply-add, ``state = state dA_t + dBx_t``,
  each step's state kept, then ``y = sum_s state C`` for those steps at once.
  dA, dBx and the kept states are [B, steps, d_inner, d_state] f32, so the
  steps go in chunks of at most SCAN_CHUNK_ELEMS elements each (a 16-row
  burst of 2048 tokens at Mamba-2.8B's widths would hold 10.7 GB per such
  tensor whole); each step's values do not depend on the chunking.
  A pad step (``valid`` False: right-padded prefill, a serving row that
  must not move) takes dA = 1 and dBx = 0, which leaves its state as it
  was, bit for bit;
- the new conv state: the last d_conv - 1 VALID inputs of each row.
Both small reductions (the conv over d_conv, y over d_state) are a
broadcast multiply and a sum over that fixed axis, never an einsum or a
bmm, so a row's bits do not depend on the other rows of the call (cuBLAS
picks a batched product's algorithm from the batch).

The forward updates the cache IN PLACE (``RecurrentCache``), as the port's
KV caches are: a forward over a view of one batch row (``row``) writes that
row.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from tpu_kquant_torch.models.config import ModelConfig
from tpu_kquant_torch.ops.norms import rms_norm
from tpu_kquant_torch.ops.qmatmul import IMPLS, qmatmul
from tpu_kquant_torch.quant.codecs import dequant_rows


# the most elements of one [B, steps, d_inner, d_state] f32 tensor of the
# scan (dA, dBx, the kept states): 256 MB
SCAN_CHUNK_ELEMS = 1 << 26


@dataclasses.dataclass
class RecurrentCache:
    """The recurrent state of every layer and row (llama.cpp's recurrent
    memory): ``conv`` [L, B, d_conv - 1, d_inner], the depthwise conv's last
    inputs, and ``ssm`` [L, B, d_inner, d_state], the SSM state; both f32."""

    conv: torch.Tensor
    ssm: torch.Tensor

    @staticmethod
    def create(n_layers: int, batch: int, d_conv: int, d_inner: int, d_state: int,
               device: str | torch.device = "cpu",
               dtype: torch.dtype = torch.float32) -> "RecurrentCache":
        return RecurrentCache(
            conv=torch.zeros((n_layers, batch, d_conv - 1, d_inner), dtype=dtype, device=device),
            ssm=torch.zeros((n_layers, batch, d_inner, d_state), dtype=dtype, device=device))

    @property
    def quantized(self) -> bool:  # the engine's interface, as KVCache's
        return False

    def row(self, slot: int) -> "RecurrentCache":
        """Batch row ``slot`` as a [L, 1, ...] cache that is a VIEW of this
        one: a forward over it writes the row in place."""
        return RecurrentCache(self.conv.narrow(1, slot, 1), self.ssm.narrow(1, slot, 1))

    def zero_(self) -> "RecurrentCache":
        self.conv.zero_()
        self.ssm.zero_()
        return self

    def set_rows(self, src: "RecurrentCache", slots: torch.Tensor) -> None:
        """Copy every row of ``src`` [L, k, ...] into batch rows ``slots``
        [k] (one indexed write per state tensor)."""
        self.conv[:, slots] = src.conv
        self.ssm[:, slots] = src.ssm


def mamba_layer_scan(layer: dict[str, Any], cfg: ModelConfig, x: torch.Tensor,
                     conv_state: torch.Tensor, ssm_state: torch.Tensor,
                     valid: torch.Tensor | None, impl: str = "auto"):
    """One mamba block over T steps: x [B, T, D] the residual stream (bf16),
    conv_state [B, d_conv - 1, d_inner], ssm_state [B, d_inner, d_state],
    valid [B, T] bool (None: every step). Returns (y [B, T, D] in x's dtype,
    the new conv state, the new SSM state), both f32."""
    B, T, _ = x.shape
    di, ds, dc, dtr = cfg.ssm_d_inner, cfg.ssm_d_state, cfg.ssm_d_conv, cfg.ssm_dt_rank

    h = rms_norm(x, layer["attn_norm"].arrays["w"], cfg.norm_eps)
    xz = qmatmul(h, layer["ssm_in"], impl)  # [B, T, 2 di]
    xin = xz[..., :di].float()
    z = xz[..., di:].float()

    # depthwise causal conv: the window is the carried inputs and this call's
    # T; output t reads window[t : t + dc] (unfold: [B, T, di, dc])
    win = torch.cat([conv_state.float(), xin], dim=1)  # [B, dc - 1 + T, di]
    xc = (win.unfold(1, dc, 1) * layer["conv_w"]).sum(-1) + layer["conv_b"]
    xc = F.silu(xc)

    # the SSM's data-dependent parameters (time-independent, all rows at once)
    xdb = qmatmul(xc.to(torch.bfloat16), layer["ssm_x"], impl).float()
    Bm = xdb[..., dtr:dtr + ds]  # [B, T, ds]
    Cm = xdb[..., dtr + ds:]
    dt = qmatmul(xdb[..., :dtr].to(torch.bfloat16), layer["ssm_dt"], impl).float()
    dt = F.softplus(dt + layer["dt_b"])  # [B, T, di]
    A = -torch.exp(layer["A_log"].float())  # [di, ds]
    dtx = dt * xc
    one = torch.ones((), dtype=torch.float32, device=x.device)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    y = torch.empty_like(xc)  # sum_s state C, step by step
    state = ssm_state.float()
    chunk = max(1, min(T, SCAN_CHUNK_ELEMS // (B * di * ds)))
    for t0 in range(0, T, chunk):
        t1 = min(T, t0 + chunk)
        dA = torch.exp(dt[:, t0:t1, :, None] * A)  # [B, t1 - t0, di, ds]
        dBx = dtx[:, t0:t1, :, None] * Bm[:, t0:t1, None, :]
        if valid is not None:  # a pad step: state * 1 + 0, its state as it was
            v = valid[:, t0:t1, None, None]
            dA = torch.where(v, dA, one)
            dBx = torch.where(v, dBx, zero)
        states = torch.empty_like(dA)  # each step's state
        for t in range(t1 - t0):
            state = torch.addcmul(dBx[:, t], state, dA[:, t], out=states[:, t])
        y[:, t0:t1] = (states * Cm[:, t0:t1, None, :]).sum(-1)
        del dA, dBx, states
    y = (y + layer["Dd"] * xc) * F.silu(z)  # [B, T, di]
    out = qmatmul(y.to(torch.bfloat16), layer["ssm_out"], impl)

    # the conv state: the last dc - 1 VALID inputs of each row (right pads
    # trail, so each row's window ends at its own length)
    if valid is None:
        conv_new = win[:, T:]
    else:
        n_valid = valid.long().sum(1)  # [B]
        idx = n_valid[:, None] + torch.arange(dc - 1, device=x.device)[None, :]
        conv_new = torch.gather(win, 1, idx[:, :, None].expand(B, dc - 1, di))
    return out.to(x.dtype), conv_new, state


def mamba_forward(params: dict[str, Any], cfg: ModelConfig, tokens: torch.Tensor,
                  positions: torch.Tensor, cache: RecurrentCache,
                  logits_last_only: bool = False, impl: str = "auto",
                  kv_valid: torch.Tensor | None = None,
                  logits_rows: torch.Tensor | None = None,
                  kv_attend_len: int | None = None) -> tuple[torch.Tensor, RecurrentCache]:
    """tokens [B, T] -> (logits [B, T or 1, vocab] f32, cache). The state IS
    the position: ``positions`` and ``kv_attend_len`` are taken for the
    llama forward's signature and unused. ``kv_valid`` [B, T] masks pad
    steps (module docstring); ``logits_last_only`` takes each row's last
    valid step (the last step without a mask), ``logits_rows`` [B] the given
    step of each row. The cache is updated in place."""
    del positions, kv_attend_len
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    B = tokens.shape[0]
    x = dequant_rows(params["tok_embd"], tokens, dtype=torch.bfloat16)
    for i, layer in enumerate(params["layers"]):
        y, conv_new, ssm_new = mamba_layer_scan(layer, cfg, x, cache.conv[i], cache.ssm[i],
                                                kv_valid, impl)
        x = x + y
        cache.conv[i].copy_(conv_new)
        cache.ssm[i].copy_(ssm_new)
    x = rms_norm(x, params["output_norm"].arrays["w"], cfg.norm_eps)
    if logits_rows is None and logits_last_only:
        logits_rows = (torch.full((B,), x.shape[1] - 1, device=x.device) if kv_valid is None
                       else kv_valid.long().sum(1) - 1)
    if logits_rows is not None:
        x = x[torch.arange(B, device=x.device), logits_rows][:, None]
    logits = qmatmul(x, params["output"], impl, out_dtype=torch.float32)
    return logits, cache
