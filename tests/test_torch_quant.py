"""The port's host layers against the JAX package: GGUF I/O, repack, bf16
pair packing, torch dequant, config and loader (byte for byte), and the
rule that the port imports nothing of JAX."""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from tpu_kquant.gguf import GGMLType
from tpu_kquant.models.config import ModelConfig as JModelConfig
from tpu_kquant.models.fixtures import tiny_config, write_fixture_gguf
from tpu_kquant.quant import quantize
from tpu_kquant.quant import jnp_codecs
from tpu_kquant.quant import repack as jrepack
from tpu_kquant.quant.qtensor import QTensor as JQTensor
from tpu_kquant.runtime.loader import load_model as jload
from tpu_kquant_torch.gguf import GGUFReader
from tpu_kquant_torch.models import fixtures as tfix
from tpu_kquant_torch.models.config import ModelConfig
from tpu_kquant_torch.quant import codecs, repack
from tpu_kquant_torch.quant.qtensor import QTensor
from tpu_kquant_torch.runtime.loader import load_model, params_from_numpy

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]
FIXTURES = {
    # test_model_parity's tiny model (dim 64: Q8_0 + Q6_K)
    "tiny": (dict(n_layers=2, dim=64, n_heads=4, n_kv_heads=2, ffn_dim=160,
                  vocab_size=512, max_seq_len=128), 7, 0.08),
    # smallest width through the fused gates (Q4_K + Q6_K)
    "w1024": (dict(n_layers=2, dim=1024, n_heads=16, n_kv_heads=4, ffn_dim=1024,
                   vocab_size=512, max_seq_len=128), 3, 0.05),
}


@pytest.fixture(scope="module")
def gguf_paths(tmp_path_factory):
    out = {}
    for name, (kw, seed, scale) in FIXTURES.items():
        path = tmp_path_factory.mktemp(name) / f"{name}.gguf"
        write_fixture_gguf(path, tiny_config(**kw), seed=seed, quant="q4_k_m", scale=scale)
        out[name] = str(path)
    return out


def _assert_same_params(ref, got, path=""):
    """ref: JAX params (arrays of any kind); got: the port's (torch)."""
    if isinstance(ref, dict):
        assert set(ref) == set(got), path
        for k in ref:
            _assert_same_params(ref[k], got[k], f"{path}/{k}")
        return
    if isinstance(ref, list):
        assert len(ref) == len(got), path
        for i, (a, b) in enumerate(zip(ref, got)):
            _assert_same_params(a, b, f"{path}[{i}]")
        return
    assert (ref.kind, ref.layout, tuple(ref.shape)) == (got.kind, got.layout, tuple(got.shape)), path
    assert set(ref.arrays) == set(got.arrays), path
    for k in ref.arrays:
        a = np.asarray(ref.arrays[k])
        b = got.arrays[k].cpu().numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, (path, k, a.dtype, b.dtype)
        assert a.tobytes() == b.tobytes(), (path, k)


@pytest.mark.parametrize("name", sorted(FIXTURES))
@pytest.mark.parametrize("scale_dtype", ["bf16", "f32"])
def test_loader_bytes_match_reference(gguf_paths, name, scale_dtype):
    _, pj, _ = jload(gguf_paths[name], scale_dtype=scale_dtype)
    _, pt, _ = load_model(gguf_paths[name], scale_dtype=scale_dtype, device="cpu")
    _assert_same_params(pj, pt)


@pytest.mark.parametrize("scale_dtype", ["bf16", "f32"])
def test_params_from_numpy_matches_loader(gguf_paths, scale_dtype):
    _, pj, _ = jload(gguf_paths["w1024"], scale_dtype=scale_dtype)

    def export(v):  # the JAX package's params as numpy (dict form)
        if isinstance(v, dict):
            return {k: export(x) for k, x in v.items()}
        if isinstance(v, list):
            return [export(x) for x in v]
        return {"kind": v.kind, "layout": v.layout, "shape": v.shape,
                "arrays": {k: np.asarray(a) for k, a in v.arrays.items()}}

    got = params_from_numpy(export(pj), "cpu")
    _assert_same_params(pj, got)
    _, pt, _ = load_model(gguf_paths["w1024"], scale_dtype=scale_dtype, device="cpu")
    _assert_same_params(pj, pt)


def test_config_from_gguf_matches_reference(gguf_paths):
    r = GGUFReader(gguf_paths["w1024"])
    got = dataclasses.asdict(ModelConfig.from_gguf(r.metadata))
    want = dataclasses.asdict(JModelConfig.from_gguf(r.metadata))
    want.pop("moe_impl")
    assert got == want


def _bf16_bits_ref(a):
    return a.astype(ml_dtypes.bfloat16).view(np.uint16)


def test_bf16_rounding_matches_ml_dtypes():
    rng = np.random.default_rng(0)
    x = rng.standard_normal(4096).astype(np.float32) * 10.0 ** rng.integers(-8, 8, 4096)
    # exact ties round to even: low 16 bits 0x8000 on odd and even bf16 patterns
    ties = (np.arange(64, dtype=np.uint32) << 16 | 0x8000) + 0x3F800000
    x = np.concatenate([x, ties.view(np.float32), np.float32([0.0, -0.0, 1e-40])])
    got = repack._bf16_bits(x).astype(np.uint16)
    np.testing.assert_array_equal(got, _bf16_bits_ref(x))


def _jq(qt):
    return JQTensor(qt.kind, qt.layout, qt.shape, {k: np.asarray(v) for k, v in qt.arrays.items()})


def _tq(qt):
    return QTensor(qt.kind, qt.layout, tuple(qt.shape), {k: np.asarray(v) for k, v in qt.arrays.items()})


CASES = [(GGMLType.Q4_K, 256, 512), (GGMLType.Q6_K, 128, 512), (GGMLType.Q8_0, 64, 96)]


@pytest.mark.parametrize("qtype,N,K", CASES)
@pytest.mark.parametrize("layout", ["kmajor", "rowmajor"])
def test_repack_matches_reference(qtype, N, K, layout):
    rng = np.random.default_rng(int(qtype) + N)
    raw = quantize(rng.standard_normal((N, K)).astype(np.float32) * 0.1, qtype)
    want = jrepack.repack(raw, qtype, (N, K), layout=layout)
    got = repack.repack(raw, qtype, (N, K), layout=layout)
    assert (got.kind, got.layout, got.shape) == (want.kind, want.layout, want.shape)
    assert set(got.arrays) == set(want.arrays)
    for k in want.arrays:
        np.testing.assert_array_equal(np.asarray(got.arrays[k]), np.asarray(want.arrays[k]))
    if layout == "kmajor":
        wq, gq = jrepack.widen_q6(want), repack.widen_q6(_tq(got))
        for k in wq.arrays:
            np.testing.assert_array_equal(np.asarray(gq.arrays[k]), np.asarray(wq.arrays[k]))
        for pack in ("pack_scale_pairs", "pack_scale_kpairs"):
            a, b = getattr(jrepack, pack)(_jq(wq)), getattr(repack, pack)(gq)
            assert set(a.arrays) == set(b.arrays)
            for k in a.arrays:
                assert np.asarray(a.arrays[k]).tobytes() == np.asarray(b.arrays[k]).tobytes()


def test_dequantize_floats_match_reference():
    from tpu_kquant.quant import dequantize as jdequantize

    rng = np.random.default_rng(5)
    x = rng.standard_normal((8, 256)).astype(np.float32)
    for t in (GGMLType.F32, GGMLType.F16, GGMLType.BF16, GGMLType.Q4_K, GGMLType.Q8_0):
        raw = quantize(x, t)
        np.testing.assert_allclose(repack.dequantize(raw, t, x.shape),
                                   jdequantize(raw, t, x.shape), rtol=1e-6, atol=1e-7)


def _kmajor_cases():
    rng = np.random.default_rng(11)
    out = {}
    for name, qtype, N, K, sd in (("q4-sm", GGMLType.Q4_K, 96, 512, "bf16"),
                                  ("q4-f32", GGMLType.Q4_K, 96, 512, "f32"),
                                  ("q6w-sp", GGMLType.Q6_K, 64, 512, "bf16"),
                                  ("q8-sp", GGMLType.Q8_0, 64, 128, "bf16")):
        raw = quantize(rng.standard_normal((N, K)).astype(np.float32) * 0.1, qtype)
        qt = jrepack.widen_q6(jrepack.repack(raw, qtype, (N, K)))
        if sd == "bf16":
            qt = jrepack.pack_scale_kpairs(jrepack.pack_scale_pairs(_jq(qt)))
        out[name] = qt
    return out


@pytest.mark.parametrize("case", ["q4-sm", "q4-f32", "q6w-sp", "q8-sp"])
def test_dequant_kmajor_matches_jnp(case):
    qt = _kmajor_cases()[case]
    want = np.asarray(jnp_codecs.dequant_kmajor(
        JQTensor(qt.kind, qt.layout, qt.shape, {k: jnp.asarray(v) for k, v in qt.arrays.items()})))
    got = codecs.dequant_kmajor(_tq(qt).to("cpu")).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("scale_dtype", ["bf16", "f32"])
def test_dequant_rows_matches_jnp(gguf_paths, scale_dtype):
    _, pj, _ = jload(gguf_paths["w1024"], scale_dtype=scale_dtype)
    _, pt, _ = load_model(gguf_paths["w1024"], scale_dtype=scale_dtype, device="cpu")
    rows = np.array([[3, 100, 7], [511, 0, 42]])
    want = np.asarray(jnp_codecs.dequant_rows(pj["tok_embd"], jnp.asarray(rows)))
    got = codecs.dequant_rows(pt["tok_embd"], torch.from_numpy(rows)).numpy()
    np.testing.assert_array_equal(got, want)


def test_port_fixture_is_valid_gguf(tmp_path):
    """The port's writer draws K-quant blocks directly: both packages read
    the file, load identical bytes, and the weights are centred with the
    requested spread."""
    from tpu_kquant.gguf import GGUFReader as JReader

    cfg = tfix.tiny_config(n_layers=1, dim=512, n_heads=8, n_kv_heads=2, ffn_dim=768,
                           vocab_size=256)
    path = tfix.write_fixture_gguf(tmp_path / "port.gguf", cfg, seed=4)
    jr, tr = JReader(path), GGUFReader(path)
    # the vocab's scores and token types are arrays: compared key by key
    assert jr.metadata.keys() == tr.metadata.keys() and all(
        np.array_equal(jr.metadata[k], tr.metadata[k]) for k in jr.metadata)
    assert {k: (v.shape, v.ggml_type) for k, v in jr.tensors.items()} == \
        {k: (v.shape, v.ggml_type) for k, v in tr.tensors.items()}
    assert tr.tensors["blk.0.attn_q.weight"].ggml_type == GGMLType.Q4_K
    assert tr.tensors["blk.0.ffn_down.weight"].ggml_type == GGMLType.Q6_K
    for name in ("blk.0.attn_q.weight", "blk.0.ffn_down.weight", "output.weight"):
        w = jr.tensor_float(name)
        assert abs(float(w.mean())) < 0.005 and 0.04 < float(w.std()) < 0.06, name
        np.testing.assert_array_equal(tr.tensor_float(name), w)
    _, pj, _ = jload(path, scale_dtype="bf16")
    _, pt, _ = load_model(path, scale_dtype="bf16", device="cpu")
    _assert_same_params(pj, pt)


def test_load_model_defaults_to_cuda(gguf_paths):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        load_model(gguf_paths["tiny"])


def test_port_imports_nothing_of_jax():
    """No module of the port (nor chip_smoke.py) imports jax or tpu_kquant,
    and importing the whole port leaves both out of sys.modules."""
    files = sorted((REPO / "tpu_kquant_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    for f in files:
        for line in f.read_text().splitlines():
            s = line.strip()
            if s.startswith(("import ", "from ")):
                mod = s.split()[1]
                assert mod.split(".")[0] not in ("jax", "jaxlib", "tpu_kquant", "ml_dtypes"), (f, s)
    code = ("import sys, pkgutil, importlib, tpu_kquant_torch\n"
            "for m in pkgutil.walk_packages(tpu_kquant_torch.__path__, 'tpu_kquant_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "import chip_smoke\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'tpu_kquant')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)
