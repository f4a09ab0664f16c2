"""The reference's default-on switches in the port, on the CPU.

The reference turns its fused decode kernels off when TKQ_FUSE_ATTN
(attn_in), TKQ_FUSE_OPROJ (oproj_ffn) or TKQ_FUSE_FFN (ffn) is set to
anything but "1", reading each at call time, and sizes its attention budget
from TKQ_ATTN_XLA_MAX_MB (alias TKQ_PREFILL_XLA_MAX_MB) once at import.
These tests hold the port's gates to the reference's over a grid of switch
values, impls and row counts (the reference's gates also require a TPU
backend, patched here); run the tiny fixture's forward under each switch
setting, counting its plain calls and holding its logits to the JAX engine
(whose TPU-only gates keep it unfused: the same function); and import both
attention modules in a subprocess under each budget variable.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_kquant.ops import pallas_attn_in as j_attn_in
from tpu_kquant.ops import pallas_ffn as j_ffn
from tpu_kquant.quant.qtensor import QTensor as JQTensor
from tpu_kquant.runtime import InferenceEngine as JEngine
from tpu_kquant.runtime import load_model as jload
from tpu_kquant_torch.models.fixtures import tiny_config, write_fixture_gguf
from tpu_kquant_torch.ops import _build
from tpu_kquant_torch.ops import attn_in as t_attn_in
from tpu_kquant_torch.ops import ffn as t_ffn
from tpu_kquant_torch.quant.qtensor import QTensor
from tpu_kquant_torch.runtime.engine import InferenceEngine
from tpu_kquant_torch.runtime.loader import load_model

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
DEFAULT_ON = ("TKQ_FUSE_ATTN", "TKQ_FUSE_OPROJ", "TKQ_FUSE_FFN")
OPT_IN = ("TKQ_KV_APPEND_PALLAS", "TKQ_FUSE_ATTN_OUT", "TKQ_DEFER_APPEND", "TKQ_FUSE_LAYER",
          "TKQ_ROTATE_LAYER")
VALUES = (None, "0", "1", "true")  # None: unset


@pytest.fixture(autouse=True)
def _no_switches(monkeypatch):
    """Every test starts with the reference's defaults (switches unset)."""
    for k in DEFAULT_ON + OPT_IN:
        monkeypatch.delenv(k, raising=False)


@pytest.fixture
def tpu_backend(monkeypatch):
    """The reference's *_enabled gates also require a TPU backend."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")


_SIDES = {("q4", "sm"): ("sm",), ("q4", "f32"): ("scales", "mins"), ("q6w", "sp"): ("sp",),
          ("q6w", "f32"): ("scales",), ("q8", "sp"): ("sp",)}
_ONE = np.zeros(1, np.float32)


def _dummy(kind, side, shape):
    """The two packages' kmajor QTensors of a kind and shape; the gates read
    nothing but these, so the arrays are placeholders."""
    keys = ("qs",) + _SIDES[(kind, side)]
    return (JQTensor(kind, "kmajor", tuple(shape), {k: _ONE for k in keys}),
            QTensor(kind, "kmajor", tuple(shape), {k: _ONE for k in keys}))


# (D, attention width, F) at which every *_supported passes at decode rows:
# the path fixture's 512 / 1024 / 512 and TinyLlama's 2048 / 2048 / 5632
GATE_SHAPES = ((512, 1024, 512), (2048, 2048, 5632))


@pytest.mark.parametrize("value", VALUES, ids=lambda v: f"value={v}")
@pytest.mark.parametrize("impl", ["auto", "int8", "xla"])
def test_default_on_gates_read_the_switches_as_the_reference(monkeypatch, tpu_backend, impl,
                                                            value):
    """Each switch alone at `value`, the others unset: the port's three gates
    equal the reference's at decode (1, 16) and prefill (33, 512) rows, on
    bf16 pairs and on f32 scales."""
    n = 0
    for switch in DEFAULT_ON:
        for k in DEFAULT_ON:
            monkeypatch.delenv(k, raising=False)
        if value is not None:
            monkeypatch.setenv(switch, value)
        for D, A, F in GATE_SHAPES:
            for sides in (("sm", "sp"), ("f32", "f32")):
                (jqk, tqk), (jv, tv), (jwo, two), (jgu, tgu), (jdn, tdn) = (
                    _dummy(k, s, shp) for k, s, shp in (
                        ("q4", sides[0], (A + A // 4, D)), ("q6w", sides[1], (A // 4, D)),
                        ("q6w", sides[1], (D, A)), ("q4", sides[0], (2 * F, D)),
                        ("q6w", sides[1], (D, F))))
                for rows in (1, 16, 33, 512):
                    got = (t_attn_in.attn_in_enabled(tqk, tv, rows, D, 64, None, impl),
                           t_ffn.oproj_ffn_enabled(impl, two, tgu, tdn, rows),
                           t_ffn.ffn_enabled(impl, tgu, tdn, rows))
                    want = (j_attn_in.attn_in_enabled(impl, [jqk, jv], rows, D),
                            j_ffn.oproj_ffn_enabled(impl, jwo, jgu, jdn, rows),
                            j_ffn.fused_ffn_enabled(impl, jgu, jdn, rows))
                    assert got == want, (switch, value, impl, D, sides, rows)
                    n += sum(got)
    # one switch off leaves the other two on; impl "xla" (the reference's,
    # not the port's) turns all three off
    assert (n > 0) == (impl != "xla"), n


# ---------------------------------------------------------------------------
# the forward under each switch setting
# ---------------------------------------------------------------------------

# 2 layers at dim 512, 16 / 4 heads of 64 (attention width 1024), ffn 512:
# attn_in, oproj_ffn and ffn all pass their shape gates at decode rows
PATH_CFG = dict(n_layers=2, dim=512, n_heads=16, n_kv_heads=4, ffn_dim=512, vocab_size=512,
                max_seq_len=128)
PROMPT = [3, 100, 7, 256, 42, 9, 300, 5]
MAX_SEQ = 64

# (switches, a decode step's plain calls); "true" is not "1": off
SETTINGS = {
    "unset": ({}, {"attn_in": 2, "oproj_ffn": 2, "qmm": 1}),
    "attn 1": ({"TKQ_FUSE_ATTN": "1"}, {"attn_in": 2, "oproj_ffn": 2, "qmm": 1}),
    "attn 0": ({"TKQ_FUSE_ATTN": "0"}, {"oproj_ffn": 2, "qmm": 5}),
    "oproj 0": ({"TKQ_FUSE_OPROJ": "0"}, {"attn_in": 2, "ffn": 2, "qmm": 3}),
    "oproj true": ({"TKQ_FUSE_OPROJ": "true"}, {"attn_in": 2, "ffn": 2, "qmm": 3}),
    "ffn 0": ({"TKQ_FUSE_FFN": "0"}, {"attn_in": 2, "oproj_ffn": 2, "qmm": 1}),
    "oproj 0 + ffn 0": ({"TKQ_FUSE_OPROJ": "0", "TKQ_FUSE_FFN": "0"}, {"attn_in": 2, "qmm": 7}),
    "all 0": ({k: "0" for k in DEFAULT_ON}, {"qmm": 11}),
    "attn 0 + rotate": ({"TKQ_FUSE_ATTN": "0", "TKQ_ROTATE_LAYER": "1"},
                        {"rot": 1, "oproj_ffn": 1, "qmm": 3}),
}


def _plain_calls() -> dict:
    return {k: c.plain_calls for k, c in _build.COUNTERS.items()}


def _delta(before: dict) -> dict:
    after = _plain_calls()
    return {k: after[k] - before.get(k, 0) for k in after if after[k] != before.get(k, 0)}


@pytest.fixture(scope="module")
def path_model(tmp_path_factory):
    path = tmp_path_factory.mktemp("switches") / "switches.gguf"
    cfg = tiny_config(**PATH_CFG)  # head_dim dim / n_heads = 32: widen it to 64
    cfg = dataclasses.replace(cfg, head_dim=64,
                              rope=dataclasses.replace(cfg.rope, head_dim=64, n_rot=64))
    write_fixture_gguf(path, cfg, seed=5, recipe="q4_k_m")
    jc, jp, _ = jload(str(path))
    tc, tp, _ = load_model(str(path), device="cpu")
    je = JEngine(jc, jp, max_batch=1, max_seq=MAX_SEQ, impl="xla")
    lj, jcache, lens = je.prefill([PROMPT], je.new_cache(1))
    dj, _ = je.decode_step(jnp.argmax(lj, -1), jnp.asarray(lens, jnp.int32), jcache)
    return dict(cfg=tc, params=tp, prefill=np.asarray(lj[0], np.float32),
                decode=np.asarray(dj[0], np.float32))


@pytest.mark.parametrize("name", sorted(SETTINGS))
def test_forward_dispatch_follows_the_switches(path_model, monkeypatch, name):
    """A decode step under each setting launches what the gates say (and
    what chip_smoke.expected_launches predicts from them), and its logits,
    and the prefill's, stay the JAX engine's."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    env, step = SETTINGS[name]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    cfg, params = path_model["cfg"], path_model["params"]
    te = InferenceEngine(cfg, params, max_batch=1, max_seq=MAX_SEQ, device="cpu")
    lt, cache, lens = te.prefill([PROMPT], te.new_cache(1))
    before = _plain_calls()
    dt, _ = te.decode_step(torch.argmax(lt, -1), torch.tensor(lens), cache)
    assert _delta(before) == step
    want = chip_smoke.expected_launches(cfg, params, 1, seq=MAX_SEQ)
    assert {k: v for k, v in want.items() if v} == step
    for got, ref in ((lt[0], path_model["prefill"]), (dt[0], path_model["decode"])):
        np.testing.assert_allclose(got.numpy(), ref, rtol=0.05, atol=0.05 * np.abs(ref).max())


# ---------------------------------------------------------------------------
# the attention budget, read at import
# ---------------------------------------------------------------------------

_BUDGET = """
import json
from tpu_kquant.ops import attention as j
from tpu_kquant_torch.ops import attention as t
print(json.dumps([j._ATTN_XLA_MAX_MB, t.ATTN_PLAIN_MAX_MB]))
"""


@pytest.mark.parametrize("env,want", [
    ({}, 192.0),
    ({"TKQ_ATTN_XLA_MAX_MB": "77.5"}, 77.5),
    ({"TKQ_PREFILL_XLA_MAX_MB": "33"}, 33.0),
    ({"TKQ_ATTN_XLA_MAX_MB": "12", "TKQ_PREFILL_XLA_MAX_MB": "900"}, 12.0),
], ids=["unset", "canonical", "alias", "both"])
def test_attention_budget_follows_the_reference_variables(env, want):
    """Both modules imported afresh in a subprocess under the variables:
    ATTN_PLAIN_MAX_MB equals the reference's _ATTN_XLA_MAX_MB."""
    base = {k: v for k, v in os.environ.items()
            if k not in ("TKQ_ATTN_XLA_MAX_MB", "TKQ_PREFILL_XLA_MAX_MB")}
    r = subprocess.run([sys.executable, "-c", _BUDGET], env={**base, "JAX_PLATFORMS": "cpu", **env},
                       cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    ref, got = json.loads(r.stdout.strip().splitlines()[-1])
    assert ref == got == want
