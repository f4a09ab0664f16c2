"""The port's HF -> GGUF converter against the reference's, on the CPU.

Locally built checkpoints (nothing is downloaded): a ``LlamaForCausalLM``
at dim 256 (so Q4_K and Q6_K apply under q4_k_m) and
tests/test_mamba.py's ``MambaForCausalLM``. ``tools/convert_hf.py:convert``
must write the reference converter's file byte for byte, at f16 and q4_k_m,
from safetensors and from ``.bin`` shards, with a BPE and a Unigram
tokenizer.json (the reference runs with its native library off, so both
quantize with their NumPy code). The port's own safetensors reader must
give what the ``safetensors`` package gives, F32 and BF16. The converted
llama's logits in the port (CPU) must follow transformers' (correlation >
0.995 and the same argmax, as tests/test_convert_hf.py holds the reference).
"""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import tpu_kquant.quant.native as j_native
from tpu_kquant.tools import convert_hf as j_convert
from tpu_kquant_torch.runtime.engine import InferenceEngine
from tpu_kquant_torch.runtime.loader import load_model
from tpu_kquant_torch.tokenizer.bpe import PRE_PATTERNS
from tpu_kquant_torch.tools import convert_hf as t_convert

transformers = pytest.importorskip("transformers")
torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def no_native(monkeypatch):
    monkeypatch.setattr(j_native, "get_lib", lambda: None)


def _bpe_tokenizer() -> dict:
    vocab = {c: i for i, c in enumerate(["<s>", "</s>", "a", "b", "ab", "Ġ", "Ġa"])}
    return {"model": {"type": "BPE", "vocab": vocab, "merges": ["a b", ["Ġ", "a"]]},
            "added_tokens": [{"id": 0, "content": "<s>", "special": True},
                             {"id": 7, "content": "<extra>", "special": True}],
            "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
                {"type": "Split", "pattern": {"Regex": PRE_PATTERNS["llama3"]}}]}}


def _unigram_tokenizer() -> dict:
    pieces = [["<unk>", 0.0], ["<0x41>", 0.0], ["▁a", -1.5], ["b", -2.25]]
    return {"model": {"type": "Unigram", "vocab": pieces},
            "added_tokens": [{"id": 0, "content": "<unk>", "special": True}]}


@pytest.fixture(scope="module")
def llama_dirs(tmp_path_factory):
    """The llama checkpoint as safetensors and as a .bin shard, and its model."""
    from transformers import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                      num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                      max_position_embeddings=256, rms_norm_eps=1e-5, rope_theta=10000.0,
                      tie_word_embeddings=False, bos_token_id=0, eos_token_id=1)
    torch.manual_seed(0)
    model = LlamaForCausalLM(cfg).eval()
    root = tmp_path_factory.mktemp("hf")
    st, binf = root / "llama-st", root / "llama-bin"
    model.save_pretrained(str(st), safe_serialization=True)
    model.save_pretrained(str(binf), safe_serialization=False)
    return st, binf, model


@pytest.fixture(scope="module")
def mamba_dir(tmp_path_factory):
    from transformers import MambaConfig, MambaForCausalLM

    torch.manual_seed(0)
    cfg = MambaConfig(vocab_size=512, hidden_size=64, state_size=16, num_hidden_layers=2,
                      conv_kernel=4, expand=2, time_step_rank=4, use_conv_bias=True,
                      use_bias=False, tie_word_embeddings=False)
    d = tmp_path_factory.mktemp("hf") / "mamba"
    MambaForCausalLM(cfg).eval().save_pretrained(str(d), safe_serialization=True)
    return d


def _same_file(hf_dir, tmp_path, recipe: str) -> Path:
    ref, got = tmp_path / "ref.gguf", tmp_path / "port.gguf"
    j_convert.convert(str(hf_dir), str(ref), recipe=recipe, verbose=False)
    t_convert.convert(str(hf_dir), str(got), recipe=recipe, verbose=False, device="cpu")
    assert got.read_bytes() == ref.read_bytes()
    return got


@pytest.mark.parametrize("recipe", ["f16", "q4_k_m"])
@pytest.mark.parametrize("shards", ["safetensors", "bin"])
def test_convert_llama_equals_reference(llama_dirs, tmp_path, no_native, recipe, shards):
    st, binf, _ = llama_dirs
    _same_file(st if shards == "safetensors" else binf, tmp_path, recipe)


@pytest.mark.parametrize("tok", ["bpe", "unigram"])
def test_convert_exports_the_tokenizer_as_reference(llama_dirs, tmp_path, no_native, tok):
    d = tmp_path / "with-tok"
    shutil.copytree(llama_dirs[0], d)
    (d / "tokenizer.json").write_text(json.dumps(_bpe_tokenizer() if tok == "bpe"
                                                 else _unigram_tokenizer()))
    from tpu_kquant_torch.gguf import GGUFReader

    with GGUFReader(_same_file(d, tmp_path, "f16")) as r:
        assert r.metadata["tokenizer.ggml.model"] == ("gpt2" if tok == "bpe" else "llama")
        if tok == "bpe":
            assert r.metadata["tokenizer.ggml.pre"] == "llama3"
            assert r.metadata["tokenizer.ggml.tokens"][7] == "<extra>"


@pytest.mark.parametrize("recipe", ["f16", "q4_k_m"])
def test_convert_mamba_equals_reference(mamba_dir, tmp_path, no_native, recipe):
    _same_file(mamba_dir, tmp_path, recipe)


def test_converted_llama_follows_transformers(llama_dirs, tmp_path):
    st, _, model = llama_dirs
    out = str(tmp_path / "c.gguf")
    t_convert.main(["--hf", str(st), "--out", out, "--type", "f16", "--device", "cpu"])
    cfg, params, _ = load_model(out, device="cpu")
    tokens = [3, 100, 7, 256, 42, 9]
    with torch.no_grad():
        want = model(torch.tensor([tokens])).logits[0, -1].double().numpy()
    eng = InferenceEngine(cfg, params, max_batch=1, max_seq=64, device="cpu")
    logits, _, _ = eng.prefill([tokens], eng.new_cache(1))
    got = logits[0].double().numpy()
    assert np.corrcoef(got, want)[0, 1] > 0.995
    assert np.argmax(got) == np.argmax(want)


def test_convert_needs_a_card_unless_cpu(llama_dirs, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        t_convert.convert(str(llama_dirs[0]), str(tmp_path / "x.gguf"), verbose=False)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_safetensors_reader_equals_safetensors(llama_dirs, tmp_path, dtype):
    safetensors = pytest.importorskip("safetensors")
    from safetensors.torch import save_file

    _, _, model = llama_dirs
    sd = {k: v.to(getattr(torch, dtype)).contiguous() for k, v in model.state_dict().items()}
    path = tmp_path / "m.safetensors"
    save_file(sd, str(path), metadata={"format": "pt"})
    got = t_convert.read_safetensors(path)
    with safetensors.safe_open(str(path), framework="pt") as f:
        keys = list(f.keys())
        assert sorted(got) == sorted(keys)
        for k in keys:
            want = f.get_tensor(k).float().numpy()
            assert got[k].dtype == np.float32 and got[k].shape == want.shape
            np.testing.assert_array_equal(got[k], want, err_msg=k)


def test_port_imports_no_checkpoint_package():
    """No module of the port imports safetensors or transformers (the card's
    machine has neither), and importing every module leaves both out."""
    for f in sorted((REPO / "tpu_kquant_torch").rglob("*.py")):
        for line in f.read_text().splitlines():
            s = line.strip()
            if s.startswith(("import ", "from ")):
                assert s.split()[1].split(".")[0] not in ("safetensors", "transformers"), (f, s)
    code = ("import sys, pkgutil, importlib, tpu_kquant_torch\n"
            "for m in pkgutil.walk_packages(tpu_kquant_torch.__path__, 'tpu_kquant_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('safetensors', 'transformers')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)
