"""The slice as a whole on the CPU: a tiny llama requantized by the JAX
package's quantize tool to every recipe, loaded by both packages and run
end to end.

The JAX writer makes the model at f32 (2 layers, dim 1024, 16 + 4 heads of
64, ffn 512, vocab 512: the narrowest width at which attn_in, oproj_ffn and
ffn all pass their gates), ``tpu_kquant.tools.quantize.requantize`` turns it
into each recipe's GGUF, and both loaders read that file. The JAX engine runs
impl="xla" (impl="int8" for the f32-scale int8 case, whose qmm_int8 runs in
interpret mode); the port runs its plain versions under the reference's
dispatch. Held: loader bytes, prefill logits within 5e-2 of max|ref| (the
tolerance of tests/test_torch_model.py: bf16 rounding points differ between
the fused plain versions and XLA), the same argmax, 8 greedy tokens equal,
and the port's plain calls per decode step as the recipe table gives them.
"""

import numpy as np
import pytest
import torch

from tpu_kquant.models.fixtures import tiny_config, write_fixture_gguf
from tpu_kquant.runtime import InferenceEngine as JEngine
from tpu_kquant.runtime import load_model as jload
from tpu_kquant.tools.quantize import requantize
from tpu_kquant_torch.ops import _build
from tpu_kquant_torch.runtime.engine import InferenceEngine
from tpu_kquant_torch.runtime.loader import load_model

torch.set_num_threads(1)

CFG = dict(n_layers=2, dim=1024, n_heads=16, n_kv_heads=4, ffn_dim=512, vocab_size=512,
           max_seq_len=128)
TOKENS = [3, 100, 7, 256, 42, 9, 300, 5]
# case -> (recipe, load options, impl, a decode step's plain calls per layer,
# the lm head's counter): the recipe table at this width (every weight K is
# 1024 or 512, so the fused gates and the int8 gate decide as at TinyLlama)
CASES = {
    "q8_0": ("q8_0", {}, "auto", {"attn_in": 1, "oproj_ffn": 1}, "qmm"),
    "q6_k": ("q6_k", {}, "auto", {"attn_in": 1, "oproj_ffn": 1}, "qmm"),
    "q5_k_m": ("q5_k_m", {}, "auto", {"qmm": 5}, "qmm"),
    "q4_k_s": ("q4_k_s", {}, "auto", {"attn_in": 1, "qmm": 3}, "qmm"),
    "q3_k_m": ("q3_k_m", {}, "auto", {"qmm": 5}, "qmm"),
    "q2_k": ("q2_k", {}, "auto", {"qmm": 5}, "qmm"),
    "q4_k_m-q6-bf16": ("q4_k_m", {"widen_q6": False}, "auto", {"qmm": 5}, "qmm"),
    "q4_k_m-q6-f32-int8": ("q4_k_m", {"widen_q6": False, "scale_dtype": "f32"}, "int8",
                           {"qmm_int8": 5}, "qmm_int8"),
}
COUNTED = ("attn_in", "oproj_ffn", "ffn", "qmm", "qmm_int8")


@pytest.fixture(scope="module")
def f32_gguf(tmp_path_factory):
    path = tmp_path_factory.mktemp("f32") / "f32.gguf"
    return write_fixture_gguf(path, tiny_config(**CFG), seed=3, quant="f32", scale=0.05)


@pytest.fixture(scope="module")
def engines(f32_gguf, tmp_path_factory):
    """case -> (JAX engine, port engine, JAX params, port params), built on
    first use."""
    made = {}

    def get(case):
        if case not in made:
            recipe, load_kw, impl, _, _ = CASES[case]
            path = str(tmp_path_factory.mktemp(case) / f"{recipe}.gguf")
            requantize(f32_gguf, path, recipe, verbose=False)
            sd = load_kw.get("scale_dtype", "bf16")
            widen = load_kw.get("widen_q6", True)
            jc, jp, _ = jload(path, scale_dtype=sd, widen_q6=widen)
            tc, tp, _ = load_model(path, scale_dtype=sd, device="cpu", widen_q6=widen)
            made[case] = (JEngine(jc, jp, max_batch=1, max_seq=64,
                                  impl="int8" if impl == "int8" else "xla"),
                          InferenceEngine(tc, tp, max_batch=1, max_seq=64, device="cpu",
                                          impl=impl), jp, tp)
        return made[case]

    return get


def _plain_calls():
    return {k: c.plain_calls for k, c in _build.COUNTERS.items()}


def _same_bytes(ref, got, path=""):
    if isinstance(ref, dict):
        assert set(ref) == set(got), path
        for k in ref:
            _same_bytes(ref[k], got[k], f"{path}/{k}")
    elif isinstance(ref, list):
        for i, (a, b) in enumerate(zip(ref, got, strict=True)):
            _same_bytes(a, b, f"{path}[{i}]")
    else:
        assert (ref.kind, ref.layout, tuple(ref.shape)) == (got.kind, got.layout,
                                                            tuple(got.shape)), path
        assert set(ref.arrays) == set(got.arrays), path
        for k in ref.arrays:
            assert np.asarray(ref.arrays[k]).tobytes() == got.arrays[k].numpy().tobytes(), (
                path, k)


@pytest.mark.parametrize("case", sorted(CASES))
def test_recipe_loads_the_reference_bytes(engines, case):
    *_, jp, tp = engines(case)
    _same_bytes(jp, tp)


@pytest.mark.parametrize("case", sorted(CASES))
def test_recipe_prefill_logits_and_greedy_tokens_match_jax(engines, case):
    je, te, _, _ = engines(case)
    lj, _, _ = je.prefill([TOKENS], je.new_cache(1))
    lt, _, _ = te.prefill([TOKENS], te.new_cache(1))
    want, got = np.asarray(lj[0], np.float32), lt[0].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-2 * np.abs(want).max())
    assert np.argmax(got) == np.argmax(want)
    assert te.generate([TOKENS[:3]], max_new_tokens=8) == \
        je.generate([TOKENS[:3]], max_new_tokens=8)


@pytest.mark.parametrize("case", sorted(CASES))
def test_recipe_dispatch_follows_the_recipe_table(engines, case):
    """One decode step's plain calls per kernel: per_layer x 2 layers, and
    the lm head; the 8-token prefill (16 rows) dispatches the same way."""
    _, te, _, _ = engines(case)
    _, _, _, per_layer, head = CASES[case]
    want = {k: 2 * per_layer.get(k, 0) + (k == head) for k in COUNTED}
    before = _plain_calls()
    logits, cache, lens = te.prefill([TOKENS], te.new_cache(1))
    mid = _plain_calls()
    te.decode_step(torch.argmax(logits, -1), torch.tensor(lens), cache)
    after = _plain_calls()
    assert {k: mid[k] - before[k] for k in COUNTED} == want
    assert {k: after[k] - mid[k] for k in COUNTED} == want
