"""The attention phase of attn_out (#10) and layer (#11) in the port, on the CPU.

Both kernels run one few-row attention kernel (``csrc/decode_attn.cuh:
fused_attn_kernel``): #7's tensor-core core, a split over S from
``ops/decode_attention.py:fused_attn_plan`` (S alone), the splits of a (KV
head, row) one thread-block cluster that combines them in rank order and,
for #11, folds the current token in after them. The card alone runs it;
here:
- the plan: it covers every cache tile exactly once, in at most 8 splits (a
  portable cluster), and takes no batch size;
- the kernel's blocking in plain PyTorch (``decode_attention_split_plain``:
  each (split, 16-slot lane) block's max, sum and accumulator, the lanes
  then the splits rescaled to their common max in order, the current token
  folded in last) against the one-pass plain versions the wrappers' checks
  use (``decode_attention_plain``, ``attend_with_current``), at several
  plans and ragged positions, position 0 and S % 64 != 0 with the current
  token, and int8 scales. With p kept f32 the blocked form agrees with a
  one-pass softmax within 1e-5 of each (row, head)'s max|ref| (the order of
  f32 sums); with p rounded to bf16, as the kernel rounds it against each
  block's own max, it agrees with the one-pass plain versions within the
  bound of that rounding, 3 * 2^-9 of the (row, KV head)'s max|v|;
- the phase's entry point ``fused_attention`` (plain on the CPU, counted)
  against the JAX package's flash decode kernel in interpret mode on the
  same inputs: the cache-only phase directly, the current-token phase on
  the cache with the current token appended.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_kquant.ops.pallas_attention import attention_decode_pallas
from tpu_kquant_torch.ops import _build
from tpu_kquant_torch.ops import decode_attention as t_decode
from tpu_kquant_torch.ops.decode_attention import (
    FUSED_MAX_SPLITS,
    TILE,
    attend_with_current,
    decode_attention_plain,
    decode_attention_split_plain,
    fused_attention,
    fused_attn_plan,
)

torch.set_num_threads(1)


@pytest.mark.parametrize("S", [1, 63, 64, 65, 96, 128, 512, 704, 2048, 2240, 4096, 32768])
def test_fused_attn_plan_covers_every_tile_once(S):
    tps, splits = fused_attn_plan(S)
    n_tiles = -(-S // TILE)
    assert 1 <= splits <= FUSED_MAX_SPLITS and tps >= 1
    covered = [t for z in range(splits) for t in range(z * tps, min((z + 1) * tps, n_tiles))]
    assert covered == list(range(n_tiles))
    assert (splits - 1) * tps < n_tiles  # no split past the last tile
    # as few tiles a split as FUSED_MAX_SPLITS allows
    assert tps == 1 or -(-n_tiles // (tps - 1)) > FUSED_MAX_SPLITS


def test_fused_attn_plan_takes_no_batch_size():
    assert list(inspect.signature(fused_attn_plan).parameters) == ["S"]
    assert fused_attn_plan(704) == (2, 6) and fused_attn_plan(2048) == (4, 8)


def _inputs(B, S, H, Hkv, D, int8, seed):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(B, H, D, generator=g).to(torch.bfloat16)
    if int8:
        k, v = (torch.randint(-127, 128, (B, Hkv, S, D), generator=g, dtype=torch.int8)
                for _ in range(2))
        scales = tuple(torch.rand(B, Hkv, S, generator=g) * 0.02 + 0.001 for _ in range(2))
    else:
        k, v = (torch.randn(B, Hkv, S, D, generator=g).to(torch.bfloat16) for _ in range(2))
        scales = None
    cur = tuple(torch.randn(B, Hkv, D, generator=g).to(torch.bfloat16) for _ in range(2))
    return q, k, v, scales, cur


def _one_pass_f32(q, k, v, pos, scales, cur):
    """The softmax over the live slots (and the current token) in one pass,
    p kept f32."""
    B, H, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    qg = q.float().reshape(B, Hkv, H // Hkv, D)
    s = torch.einsum("bhgd,bhsd->bhgs", qg, k.float()) * D ** -0.5
    vsc = torch.ones(B, Hkv, S)
    if scales is not None:
        s, vsc = s * scales[0][:, :, None], scales[1]
    lim = pos.long() + (0 if cur is not None else 1)
    live = (torch.arange(S)[None, :] < lim)[:, None, None, :]
    s = torch.where(live, s, -1e30)
    vs = v.float() * vsc[..., None]
    if cur is not None:
        s = torch.cat([s, torch.einsum("bhgd,bhd->bhg", qg, cur[0].float())[..., None]
                       * D ** -0.5], -1)
        vs = torch.cat([vs, cur[1].float()[:, :, None]], 2)
    p = torch.softmax(s, -1)
    return torch.einsum("bhgs,bhsd->bhgd", p, vs).reshape(B, H, D)


def _row_rel(got, ref):
    """Max over (row, head) of |got - ref| / max|ref| of that (row, head)."""
    return ((got.float() - ref.float()).abs().amax(-1) / ref.float().abs().amax(-1)).max().item()


# (B, S, H, Hkv, D, positions, int8 KV, with the current token, tiles a split)
SPLIT_CASES = {
    "attn_out 704 plan": (4, 704, 32, 4, 64, [1, 255, 256, 703], False, False, None),
    "attn_out int8 plan": (3, 704, 32, 4, 64, [0, 64, 700], True, False, None),
    "attn_out one split": (2, 256, 8, 2, 64, [5, 255], False, False, 4),
    "attn_out 2048 tps 3": (2, 2048, 8, 2, 128, [1000, 2047], False, False, 3),
    "layer 704 plan": (4, 704, 32, 4, 64, [0, 1, 255, 700], False, True, None),
    "layer 2048 plan": (4, 2048, 32, 4, 64, [64, 1000, 1500, 2047], False, True, None),
    "layer S 96": (4, 96, 16, 4, 64, [0, 1, 64, 95], False, True, None),
    "layer S 100 tps 1": (3, 100, 12, 2, 128, [0, 63, 99], False, True, 1),
    "layer hd 128 GQA 16": (2, 320, 32, 2, 128, [0, 319], False, True, 2),
}


@pytest.mark.parametrize("round_p", [False, True], ids=["p_f32", "p_bf16"])
@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_split_plain_matches_one_pass(case, round_p):
    B, S, H, Hkv, D, positions, int8, self_, tps = SPLIT_CASES[case]
    q, k, v, scales, cur = _inputs(B, S, H, Hkv, D, int8, seed=S + B)
    cur = cur if self_ else None
    pos = torch.tensor(positions)[:, None]
    tps = fused_attn_plan(S)[0] if tps is None else tps
    got = decode_attention_split_plain(q[:, None].float(), k, v, pos, scales, tps=tps,
                                       kv_cur=cur, round_p=round_p).reshape(B, H, D)
    if not round_p:
        assert _row_rel(got, _one_pass_f32(q, k, v, pos, scales, cur)) <= 1e-5
        return
    # p rounded to bf16 (relative error <= 2^-9) against each block's max on
    # one side and the row's on the other moves an output by <= 2^-9 max|v|
    # each (v times its scale, the current token's included), and
    # attend_with_current's bf16 output by another 2^-9 of it
    if self_:
        ref = attend_with_current(q, k, v, pos, *cur)
    else:
        ref = decode_attention_plain(q[:, None].float(), k, v, pos, scales)
    vs = v.float() * (scales[1][..., None] if int8 else 1.0)
    if self_:
        vs = torch.cat([vs, cur[1].float()[:, :, None]], 2)
    vmax = vs.abs().amax((2, 3)).repeat_interleave(H // Hkv, 1)  # [B, H]
    err = (got - ref.float().reshape(B, H, D)).abs().amax(-1) / vmax
    assert err.max().item() <= 3 * 2.0 ** -9


def test_split_plain_attends_the_current_token_alone_at_position_zero():
    """Position 0 with the current token: every split is dead (weight 0)
    and the output is the current token's v, whatever the cache holds."""
    q, k, v, _, cur = _inputs(2, 704, 32, 4, 64, False, seed=3)
    got = decode_attention_split_plain(q[:, None].float(), k * 1e3, v * 1e3,
                                       torch.zeros(2, 1, dtype=torch.long), kv_cur=cur,
                                       tps=fused_attn_plan(704)[0])
    want = cur[1].float().repeat_interleave(8, dim=1)
    assert torch.equal(got.reshape(2, 32, 64), want)


def test_split_plain_ignores_dead_slots_and_the_pad_past_s():
    """Slots at or past the position (with the current token) and the
    zeros past S in the last tile change nothing."""
    q, k, v, _, cur = _inputs(2, 100, 16, 4, 64, False, seed=4)
    pos = torch.tensor([[37], [99]])
    ref = decode_attention_split_plain(q[:, None].float(), k, v, pos, kv_cur=cur, tps=1)
    k2, v2 = k.clone(), v.clone()
    k2[0, :, 37:] = 3e4
    v2[0, :, 37:] = -3e4
    k2[1, :, 99] = 1e4
    got = decode_attention_split_plain(q[:, None].float(), k2, v2, pos, kv_cur=cur, tps=1)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("self_", [False, True], ids=["attn_out", "layer"])
def test_fused_attention_runs_plain_on_cpu_and_counts_it(self_):
    q, k, v, _, cur = _inputs(2, 128, 8, 2, 64, False, seed=5)
    pos = torch.tensor([[0], [100]])
    c = _build.COUNTERS["fused_attn"]
    assert c is t_decode.fused_counter
    before = (c.plain_calls, c.launches)
    got = fused_attention(q, k, v, pos, kv_cur=cur if self_ else None)
    assert (c.plain_calls, c.launches) == (before[0] + 1, before[1])
    assert got.shape == (2, 8 * 64) and got.dtype == torch.bfloat16
    want = attend_with_current(q, k, v, pos, *cur) if self_ else \
        decode_attention_plain(q[:, None], k, v, pos).reshape(2, -1)
    assert torch.equal(got, want)


# (B, S, H, Hkv, D, positions, int8 KV, the Pallas tile)
JAX_CASES = {
    "tinyllama ragged": (4, 704, 32, 4, 64, [0, 255, 256, 700], False, 64),
    "int8": (2, 256, 8, 2, 64, [60, 255], True, 64),
    "head_dim 128, GQA 6": (2, 512, 12, 2, 128, [37, 450], False, 128),
}


def _jax(q, k, v, pos, scales, ts):
    jq = jnp.asarray(q.float().numpy(), jnp.bfloat16)[:, None]
    if scales is None:
        jk, jv = (jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (k, v))
        js = None
    else:
        jk, jv = jnp.asarray(k.numpy()), jnp.asarray(v.numpy())
        js = tuple(jnp.asarray(t.numpy()) for t in scales)
    out = attention_decode_pallas(jq, jk, jv, jnp.asarray(pos.numpy().astype(np.int32)), js,
                                  ts=ts, interpret=True)
    return torch.from_numpy(np.asarray(out, np.float32)).reshape(q.shape)


@pytest.mark.parametrize("case", sorted(JAX_CASES))
def test_fused_attention_matches_pallas_decode(case):
    """The cache-only phase (#10's) is the JAX flash decode's function."""
    B, S, H, Hkv, D, positions, int8, ts = JAX_CASES[case]
    q, k, v, scales, _ = _inputs(B, S, H, Hkv, D, int8, seed=B + S)
    pos = torch.tensor(positions)[:, None]
    got = fused_attention(q, k, v, pos, scales).reshape(B, H, D)
    assert _row_rel(got, _jax(q, k, v, pos, scales, ts)) < (3e-2 if int8 else 2e-2)


@pytest.mark.parametrize("case", ["tinyllama ragged", "head_dim 128, GQA 6"])
def test_fused_attention_with_current_matches_pallas_decode_after_append(case):
    """The current-token phase (#11's) is the JAX flash decode's function on
    the cache with the current token appended at the position (the two
    round that token's p differently: f32 here, bf16 there)."""
    B, S, H, Hkv, D, positions, _, ts = JAX_CASES[case]
    q, k, v, _, cur = _inputs(B, S, H, Hkv, D, False, seed=B + S + 1)
    pos = torch.tensor(positions)[:, None]
    got = fused_attention(q, k, v, pos, kv_cur=cur).reshape(B, H, D)
    k2, v2 = k.clone(), v.clone()
    rows = torch.arange(B)
    k2[rows, :, pos[:, 0]] = cur[0]
    v2[rows, :, pos[:, 0]] = cur[1]
    assert _row_rel(got, _jax(q, k2, v2, pos, None, ts)) < 2e-2
