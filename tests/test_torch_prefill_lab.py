"""The port's prefill-attention lab (``tpu_kquant_torch/utils/prefill_lab.py``
and ``tools/prefill_lab.py``) against the reference's lab scripts.

On the CPU ``call_a`` / ``call_b`` / ``call_g`` run their plain versions;
these tests hold them to the reference's ``call_a`` / ``call_b`` (from
``tools_prefill_lab2.py``) and ``call_g`` (``tools_prefill_lab3.py``), run
as Pallas kernels in TPU interpret mode on the same bf16 inputs. The
reference's calls are ``jax.jit``ed, so each is traced inside the interpret
context. Tolerance: 1e-2 of each output row's own max|ref| (causal
attention's output shrinks along the prompt); one bf16 rounding of the
output is up to 3.9e-3 of it. The CUDA kernels are held to these plain
versions on a card (tests/test_torch_cuda.py, chip_smoke.py).

The reference's lab has two faults the port does not copy; the tests pin
them: its B reads past S where its last tile is ragged and live (NaN rows in
interpret mode), and every variant leaves the rows past T // tq * tq
unwritten. The reference scripts set JAX's compilation cache to
``.cache/jax_cc`` on import.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

import chip_smoke
import tools_prefill_lab2 as ref2
import tools_prefill_lab3 as ref3
from tpu_kquant_torch.ops.prefill import attention_prefill_plain
from tpu_kquant_torch.tools import prefill_lab as t_cli
from tpu_kquant_torch.utils import prefill_lab as lab
from tpu_kquant_torch.utils.attribution import chain_times

torch.set_num_threads(1)

TOL = 1e-2
# (H, Hkv, D, T, S) of the two head layouts: TinyLlama-like G 4 of 64 and
# Qwen-like G 6 of 128
HEADS = {"h8": (8, 2, 64, 256, 320), "h6": (6, 1, 128, 128, 192)}
REF = {"a": ref2.call_a, "b": ref2.call_b, "g": ref3.call_g}
# (variant, heads, q_start, tq, ts): B only where its last tile is whole or
# dead (its fault 1 is pinned below); G also on a ragged, live last tile
CASES = [
    ("a", "h8", 0, 128, None), ("a", "h8", 64, 64, None),
    ("a", "h6", 0, 128, None), ("a", "h6", 64, 32, None),
    ("b", "h8", 0, 128, 64), ("b", "h8", 64, 64, 160),
    ("b", "h6", 0, 128, 96), ("b", "h6", 64, 64, 64),
    ("g", "h8", 0, 256, 64), ("g", "h8", 64, 128, 128),
    ("g", "h6", 0, 128, 192), ("g", "h6", 64, 64, 128),
]


def _inputs(H, Hkv, D, T, S, q_start, B=1, seed=0):
    """bf16 q [B, Hkv, G, T, D], k, v [B, Hkv, S, D] and q_start [B] as
    torch tensors (the reference gets the same values)."""
    rng = np.random.default_rng(seed)

    def draw(*dims):
        return torch.from_numpy(rng.standard_normal(dims).astype(np.float32)).to(torch.bfloat16)

    return (draw(B, Hkv, H // Hkv, T, D), draw(B, Hkv, S, D), draw(B, Hkv, S, D),
            torch.full((B,), q_start, dtype=torch.int32))


def _ref(variant, q, k, v, q_start, scale, tq, ts=None):
    """The reference's kernel in interpret mode, as f32 numpy."""
    args = [jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (q, k, v)]
    kw = {"scale": scale, "tq": tq} | ({} if ts is None else {"ts": ts})
    with pltpu.force_tpu_interpret_mode():
        out = REF[variant](*args, jnp.asarray(q_start.numpy()), **kw)
        return np.asarray(out, np.float32)


def _row_rel(got, ref) -> float:
    d = np.abs(got - ref).max(-1)
    return float((d / np.maximum(np.abs(ref).max(-1), 1e-30)).max())


def _extra(ts):
    return () if ts is None else (ts,)


@pytest.mark.parametrize("variant,heads,q_start,tq,ts", CASES)
def test_plain_matches_reference(variant, heads, q_start, tq, ts):
    H, Hkv, D, T, S = HEADS[heads]
    q, k, v, qs = _inputs(H, Hkv, D, T, S, q_start)
    scale = D ** -0.5
    ref = _ref(variant, q, k, v, qs, scale, tq, ts)
    assert np.isfinite(ref).all()
    call, plain = lab.CALLS[variant]
    got = plain(q, k, v, qs, scale, tq, *_extra(ts))
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert _row_rel(got.float().numpy(), ref) < TOL
    assert torch.equal(call(q, k, v, qs, scale, tq, *_extra(ts)), got)


def test_reference_b_reads_past_s_and_the_port_does_not():
    """Fault 1, at the reference lab's own sweep point (T 512, S 704, tq 128,
    ts 384): tile 1 holds slots 384-767, of which 704-767 do not exist; the
    reference's rows 384-511 of every head come out NaN in interpret mode.
    The port's B is finite there, equals its plain version, agrees with the
    reference on the rows before 384, and with the one-shot A on every row."""
    q, k, v, qs = _inputs(8, 2, 64, 512, 704, 0, seed=3)
    ref = _ref("b", q, k, v, qs, 0.125, 128, 384)
    bad = ~np.isfinite(ref).all(-1)  # [B, Hkv, G, T]
    assert bad[..., 384:].all() and not bad[..., :384].any()
    got = lab.call_b(q, k, v, qs, 0.125, 128, 384)
    assert torch.isfinite(got).all()
    assert torch.equal(got, lab.call_b_plain(q, k, v, qs, 0.125, 128, 384))
    g = got.float().numpy()
    assert _row_rel(g[..., :384, :], ref[..., :384, :]) < TOL
    assert _row_rel(g, lab.call_a_plain(q, k, v, qs, 0.125, 128).float().numpy()) < TOL


def test_reference_leaves_rows_past_tq_unwritten():
    """Fault 2: with T 128 and tq 96 the reference's grid has T // 96 = 1
    query block, so rows 96-127 are never written (NaN in interpret mode);
    the rows it writes agree with the port."""
    q, k, v, qs = _inputs(8, 2, 64, 128, 128, 0, seed=4)
    ref = _ref("a", q, k, v, qs, 0.125, 96)
    assert np.isnan(ref[..., 96:, :]).all() and np.isfinite(ref[..., :96, :]).all()
    got = lab.call_a(q, k, v, qs, 0.125, 32).float().numpy()
    assert _row_rel(got[..., :96, :], ref[..., :96, :]) < TOL


@pytest.mark.parametrize("variant", ["a", "b", "g"])
@pytest.mark.parametrize("tq", [96, 0])
def test_wrappers_refuse_a_tq_that_does_not_divide_t(variant, tq):
    q, k, v, qs = _inputs(8, 2, 64, 128, 128, 0)
    call, plain = lab.CALLS[variant]
    for fn in (call, plain):
        with pytest.raises(ValueError, match="tq"):
            fn(q, k, v, qs, 0.125, tq, *_extra(None if variant == "a" else 64))


@pytest.mark.parametrize("variant", ["a", "b", "g"])
def test_wrappers_run_plain_on_the_cpu_and_refuse_other_devices(variant):
    q, k, v, qs = _inputs(8, 2, 64, 128, 192, 64)
    call, plain = lab.CALLS[variant]
    counter = {"a": lab.counter_a, "b": lab.counter_b, "g": lab.counter_g}[variant]
    extra = _extra(None if variant == "a" else 128)
    calls, launches = counter.plain_calls, counter.launches
    assert torch.equal(call(q, k, v, qs, 0.125, 64, *extra), plain(q, k, v, qs, 0.125, 64, *extra))
    assert (counter.plain_calls, counter.launches) == (calls + 1, launches)
    meta = [t.to("meta") for t in (q, k, v, qs)]
    with pytest.raises(ValueError, match="unsupported device"):
        call(*meta, 0.125, 64, *extra)
    assert counter.launches == launches


@pytest.mark.parametrize("what", ["k", "v", "q_start"])
def test_wrappers_refuse_shapes_that_disagree_with_q(what):
    q, k, v, qs = _inputs(8, 2, 64, 128, 192, 0)
    bad = {"k": k[:, :, :, :32], "v": v[:, :1], "q_start": qs[:0]}[what]
    args = [bad if n == what else t for n, t in (("q", q), ("k", k), ("v", v), ("q_start", qs))]
    for variant, extra in (("a", ()), ("b", (64,)), ("g", (64,))):
        with pytest.raises(ValueError):
            lab.CALLS[variant][0](*args, 0.125, 64, *extra)


@pytest.mark.parametrize("heads", sorted(HEADS))
def test_variants_compute_the_flash_prefill_function(heads):
    """A, B (several ts) and G, ungrouped, against #8's plain version on the
    scripts' [B, T, H, D] layout: the same attention, apart from where P is
    rounded to bf16 and (B) the running max it is taken against."""
    H, Hkv, D, T, S = HEADS[heads]
    q, k, v, qs = _inputs(H, Hkv, D, T, S, 64, B=2, seed=7)
    qs[1] = 0
    q4 = lab.ungroup_heads(q)
    assert torch.equal(lab.group_heads(q4, Hkv), q)
    ref = attention_prefill_plain(q4, k, v, qs).float().numpy()
    outs = [lab.call_a(q, k, v, qs, D ** -0.5, 64), lab.call_g(q, k, v, qs, D ** -0.5, 64, 128)]
    outs += [lab.call_b(q, k, v, qs, D ** -0.5, 64, ts) for ts in (64, 128, 1000)]
    for o in outs:
        assert _row_rel(lab.ungroup_heads(o).float().numpy(), ref) < TOL


def test_group_heads_is_the_scripts_transpose():
    x = np.random.default_rng(1).standard_normal((2, 16, 12, 8)).astype(np.float32)
    g = lab.group_heads(torch.from_numpy(x), 3)
    want = x.reshape(2, 16, 3, 4, 8).transpose(0, 2, 3, 1, 4)  # tools_prefill_lab2.main
    assert g.is_contiguous() and np.array_equal(g.numpy(), want)
    back = lab.ungroup_heads(g).numpy()
    assert np.array_equal(back, want.transpose(0, 3, 1, 2, 4).reshape(2, 16, 12, 8))


@pytest.mark.parametrize("shape", sorted(lab.SHAPES))
def test_lab_work_counts_what_prefill_work_counts(shape):
    c = lab.SHAPES[shape]
    got = lab.lab_work(c["B"], c["T"], c["S"], c["H"], c["Hkv"], c["D"], c["q_start"])
    want = chip_smoke.prefill_work(c["B"], c["T"], c["S"], c["H"], c["Hkv"], c["D"],
                                   c["q_start"], 0, 2 * c["D"])
    assert got == want
    if shape == "tiny-pp512":  # 4.72 MB and 1.08 GFLOP of causal pairs
        assert got == (4718592.0, 4.0 * (512 * 513 // 2) * 32 * 64)


@pytest.mark.parametrize("q_start", [0, 64])
def test_sdpa_yardstick_computes_the_same_attention(q_start):
    """SDPA's top-left causal mask (kv <= t) at q_start 0, the explicit
    positions otherwise: the same function as the plain one-shot."""
    q, k, v, qs = _inputs(8, 2, 64, 128, 192, q_start, seed=9)
    q4 = lab.ungroup_heads(q).float()
    got = lab.sdpa_call(k.float(), v.float(), [q_start], 128, 0.125)(q4)
    ref = lab.ungroup_heads(lab.call_a_plain(q, k, v, qs, 0.125, 128)).float()
    assert _row_rel(got.numpy(), ref.numpy()) < TOL


def test_cli_runs_the_sweep_on_the_cpu(capsys):
    rows = t_cli.main(["--shape", "toy", "--device", "cpu", "--iters", "1"])
    n = 1 + sum(len(p) for p in lab.SWEEPS.values())
    assert len(rows) == n
    assert [r["variant"] for r in rows] == ["prod"] + [v for v in "abg"
                                                      for _ in lab.SWEEPS[v]]
    for r in rows:
        assert r["shape"] == "toy" and r["device"] == "cpu" and r["rel_err"] == 0.0
        assert {"us", "graph_us", "bound_us", "bound_by", "sdpa_us", "dep_us", "tq", "ts"} <= set(r)
    assert len(capsys.readouterr().out.strip().splitlines()) == n


def test_cli_without_a_card_needs_device_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        t_cli.main(["--shape", "toy"])


def test_chain_times_gives_the_marginal_and_the_chain_time():
    x = torch.zeros(4)
    marg, chain = chain_times(lambda c: c + 1, x, 2, reps=1)
    assert marg > 0 and chain > 0
