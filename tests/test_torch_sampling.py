"""The port's sampler chain (tpu_kquant_torch.ops.sampling) against the JAX
package's, on the CPU.

Both packages get the same logits, counts and rings (numpy, from a seed).
The penalties and the penalty-state updates must be equal bit for bit. The
samplers must pick the same tokens when both are fed JAX's own Gumbel
noise (the port takes it through ``noise``; the test first checks that JAX's
categorical is argmax(logits + gumbel) in the installed version). The
port's own noise is checked for uniformity and for depending only on each
row's (seed, step).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_kquant.ops import sampling as J
from tpu_kquant_torch.ops import sampling as T

B, V = 6, 300
RNG = np.random.default_rng(21)


def _logits(ties: bool = False, seed: int = 0) -> np.ndarray:
    x = np.random.default_rng(seed).standard_normal((B, V)).astype(np.float32) * 3
    if ties:  # a coarse grid: many equal logits, equal maxima included
        x = np.round(x).astype(np.float32)
        x[:, 7] = x[:, 3] = x.max(axis=1)
    return x


def _counts(seed: int = 1) -> np.ndarray:
    r = np.random.default_rng(seed)
    c = r.integers(0, 4, (B, V)).astype(np.int32)
    c[r.random((B, V)) < 0.7] = 0
    return c


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _bits_equal(got: torch.Tensor, want) -> bool:
    w = np.asarray(want)
    return got.numpy().tobytes() == w.tobytes() and got.numpy().dtype == w.dtype


def test_jax_categorical_is_argmax_of_gumbel():
    """The identity the shared-noise tests rest on, for the installed JAX:
    one key over a [B, V] batch, and one key per row as sample_rows draws."""
    l = jnp.asarray(_logits())
    key = jax.random.PRNGKey(3)
    assert np.array_equal(np.asarray(jax.random.categorical(key, l, axis=-1)),
                          np.asarray(jnp.argmax(l + jax.random.gumbel(key, l.shape), -1)))
    keys = jax.random.split(key, B)
    rows = jax.vmap(lambda k, lg: jax.random.categorical(k, lg, axis=-1))(keys, l)
    noise = jax.vmap(lambda k: jax.random.gumbel(k, (V,)))(keys)
    assert np.array_equal(np.asarray(rows), np.asarray(jnp.argmax(l + noise, -1)))


@pytest.mark.parametrize("rp,pp,fp", [(1.3, 0.0, 0.0), (1.0, 0.4, 0.0), (1.0, 0.0, 0.25),
                                      (1.1, 0.5, 0.2), (1.0, 0.0, 0.0)])
def test_apply_penalties_bit_equal(rp, pp, fp):
    x, c = _logits(), _counts()
    want = J.apply_penalties(jnp.asarray(x), jnp.asarray(c), rp, pp, fp)
    got = T.apply_penalties(_t(x), _t(c), rp, pp, fp)
    assert _bits_equal(got, want)


def test_apply_penalties_rows_bit_equal():
    x, c = _logits(), _counts()
    rp = np.array([1.0, 1.1, 1.3, 1.0, 2.0, 0.9], np.float32)
    pp = np.array([0.0, 0.5, 0.0, 0.2, 0.0, 1.0], np.float32)
    fp = np.array([0.0, 0.1, 0.0, 0.0, 0.3, 0.05], np.float32)
    want = J.apply_penalties_rows(*(jnp.asarray(a) for a in (x, c, rp, pp, fp)))
    got = T.apply_penalties_rows(*(_t(a) for a in (x, c, rp, pp, fp)))
    assert _bits_equal(got, want)


def _prompts(r):
    return [r.integers(0, V, int(n)).tolist() for n in r.integers(1, 40, B)]


@pytest.mark.parametrize("last_n", [8, 64])
def test_update_penalty_state_equal(last_n):
    """Counts, ring, write index and fill over 40 steps: rows start below,
    at and past a full window, so eviction starts at different steps."""
    r = np.random.default_rng(last_n)
    prompts = _prompts(r)
    js = J.init_penalty_state(prompts, V, last_n)
    ts = T.init_penalty_state(prompts, V, last_n)
    for a, b in zip(ts, js):
        assert _bits_equal(a, b)
    for _ in range(40):
        tok = r.integers(0, V, B).astype(np.int32)
        js = J.update_penalty_state(js, jnp.asarray(tok))
        ts = T.update_penalty_state(ts, _t(tok))
        for a, b in zip(ts, js):
            assert _bits_equal(a, b)


def test_update_penalty_state_rows_equal():
    """Per-row window lengths, 0 (off) included, in a ring of 16 with
    evictions, over 40 steps."""
    r = np.random.default_rng(5)
    W = 16
    last_n = np.array([0, 3, 16, 8, 0, 1], np.int32)
    counts = np.zeros((B, V), np.int32)
    window = np.zeros((B, W), np.int32)
    widx, nfill = np.zeros(B, np.int32), np.zeros(B, np.int32)
    for b, p in enumerate(_prompts(r)):
        if last_n[b] == 0:
            continue
        tail = p[-last_n[b]:]
        np.add.at(counts[b], tail, 1)
        window[b, :len(tail)] = tail
        widx[b], nfill[b] = len(tail) % last_n[b], len(tail)
    js = tuple(jnp.asarray(a) for a in (counts, window, widx, nfill))
    ts = tuple(_t(a) for a in (counts, window, widx, nfill))
    for _ in range(40):
        tok = r.integers(0, V, B).astype(np.int32)
        js = J.update_penalty_state_rows(js, jnp.asarray(tok), jnp.asarray(last_n))
        ts = T.update_penalty_state_rows(ts, _t(tok), _t(last_n))
        for a, b in zip(ts, js):
            assert _bits_equal(a, b)
    assert (ts[0][last_n == 0] == 0).all()


SAMPLE_CASES = {
    "temperature": dict(temperature=0.7),
    "min_p": dict(temperature=1.0, min_p=0.05),
    "top_k": dict(temperature=0.9, top_k=20),
    "top_p": dict(temperature=1.1, top_p=0.8),
    "combined": dict(temperature=0.8, top_k=40, top_p=0.95, min_p=0.02),
    "greedy": dict(temperature=0.0, top_k=5),
}


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("case", sorted(SAMPLE_CASES))
def test_sample_equal_with_jax_noise(case, ties):
    kw = SAMPLE_CASES[case]
    for seed in range(4):
        x = _logits(ties, seed)
        key = jax.random.PRNGKey(seed)
        want = J.sample(jnp.asarray(x), key, **kw)
        noise = np.asarray(jax.random.gumbel(key, x.shape))
        got = T.sample(_t(x), None, noise=_t(noise), **kw)
        assert np.array_equal(got.numpy(), np.asarray(want)), (case, ties, seed)


@pytest.mark.parametrize("ties", [False, True])
def test_sample_rows_equal_with_jax_noise(ties):
    """A mixed batch: greedy rows (temperature 0 and below), min_p, top_k,
    top_p alone and combined."""
    temp = np.array([0.0, 0.7, 1.0, 0.9, 1.2, -1.0], np.float32)
    top_k = np.array([0, 0, 0, 20, 40, 3], np.int32)
    top_p = np.array([1.0, 1.0, 0.8, 1.0, 0.95, 0.5], np.float32)
    min_p = np.array([0.0, 0.05, 0.0, 0.0, 0.02, 0.0], np.float32)
    for seed in range(4):
        x = _logits(ties, seed)
        keys = jax.random.split(jax.random.PRNGKey(100 + seed), B)
        want = J.sample_rows(*(jnp.asarray(a) for a in (x,)), keys,
                             *(jnp.asarray(a) for a in (temp, top_k, top_p, min_p)))
        noise = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (V,)))(keys))
        got = T.sample_rows(_t(x), None, *(_t(a) for a in (temp, top_k, top_p, min_p)),
                            noise=_t(noise))
        assert np.array_equal(got.numpy(), np.asarray(want)), (ties, seed)
        assert np.array_equal(got.numpy()[temp <= 0], np.argmax(x, -1)[temp <= 0])


@pytest.mark.parametrize("sc", [
    J.SamplerConfig(temperature=0.8, top_k=40, top_p=0.95, repeat_penalty=1.1,
                    penalty_last_n=16),
    J.SamplerConfig(temperature=0.0, repeat_penalty=1.5, presence_penalty=0.3,
                    frequency_penalty=0.2, penalty_last_n=8),
    J.SamplerConfig(temperature=1.0, min_p=0.05),
], ids=["sampled+penalties", "greedy+penalties", "sampled"])
def test_sample_step_equal_with_jax_noise(sc):
    """Ten chained steps: tokens and penalty state equal; the port's keys
    advance their step by one per call."""
    tsc = T.SamplerConfig(**vars(sc))
    r = np.random.default_rng(9)
    prompts = _prompts(r)
    js = J.init_penalty_state(prompts, V, sc.penalty_last_n) if sc.uses_penalties else None
    ts = T.init_penalty_state(prompts, V, sc.penalty_last_n) if tsc.uses_penalties else None
    key = jax.random.PRNGKey(7)
    tkeys = T.row_keys([5] * B, 0)
    for step in range(10):
        x = _logits(False, step)
        _, sub = jax.random.split(key)
        noise = _t(np.asarray(jax.random.gumbel(sub, x.shape)))
        jt, key, js = J.sample_step(jnp.asarray(x), key, sc, js)
        tt, tkeys, ts = T.sample_step(_t(x), tkeys, tsc, ts, noise=noise)
        assert np.array_equal(tt.numpy(), np.asarray(jt)), step
        if ts is not None:
            for a, b in zip(ts, js):
                assert _bits_equal(a, b)
    assert tkeys[:, 1].tolist() == [10] * B


def test_noise_is_uniform():
    """1e5 draws of the port's uniform noise in 64 bins: chi-square under
    a bound that a uniform source exceeds with probability about 1e-6
    (63 degrees of freedom: mean 63, sd 11.2)."""
    keys = T.row_keys(torch.arange(100) * 7919 + 3, torch.arange(100) % 7)
    u = T.uniform(keys, 1000).reshape(-1)
    assert u.numel() == 100_000 and 0 < u.min() and u.max() < 1
    hist = torch.histc(u, bins=64, min=0.0, max=1.0)
    chi2 = (((hist - 1e5 / 64) ** 2) / (1e5 / 64)).sum().item()
    assert chi2 < 130, chi2
    g = T.gumbel(keys, 1000)
    assert abs(g.mean().item() - 0.5772) < 0.01  # Euler-Mascheroni


def test_noise_depends_only_on_seed_and_step():
    """A request's draws are the same in any slot of any batch; other seeds
    or steps draw other noise."""
    seeds = torch.tensor([11, 2 ** 40 + 5, 7, 123456789])
    steps = torch.tensor([0, 3, 9, 1])
    base = T.gumbel(T.row_keys(seeds, steps), V)
    perm = torch.tensor([2, 0, 3, 1])
    moved = T.gumbel(T.row_keys(seeds[perm], steps[perm]), V)
    assert torch.equal(moved, base[perm])
    alone = T.gumbel(T.row_keys(seeds[1:2], steps[1:2]), V)
    assert torch.equal(alone[0], base[1])
    crowd = T.gumbel(T.row_keys(torch.cat([seeds, seeds + 1]), torch.cat([steps, steps])), V)
    assert torch.equal(crowd[:4], base)
    assert not torch.equal(crowd[4:], base)
    assert not torch.equal(T.gumbel(T.row_keys(seeds, steps + 1), V), base)


def test_sampling_follows_the_distribution():
    """Drawing with the port's noise reproduces softmax(logits): 20000 draws
    over 8 categories, chi-square under the 1e-6 bound for 7 degrees of
    freedom (about 40)."""
    l = torch.tensor([[0.0, 1.0, -1.0, 2.0, 0.5, -3.0, 1.5, 0.2]])
    keys = T.row_keys(torch.full((20000,), 17), torch.arange(20000))
    tok = T.sample(l.expand(20000, -1).contiguous(), keys, temperature=1.0)
    hist = torch.bincount(tok.long(), minlength=8).double()
    p = torch.softmax(l[0].double(), -1)
    chi2 = (((hist - 20000 * p) ** 2) / (20000 * p)).sum().item()
    assert chi2 < 40, chi2
