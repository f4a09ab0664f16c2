"""The port's tokenizers (tpu_kquant_torch.tokenizer) against the JAX
package's on the CPU: SPM and byte-level BPE vocabularies trained in the test
with the `tokenizers` library (as tests/test_tokenizer_parity.py trains
them) and the fixture vocab both writers put into a GGUF. Encode and decode
must give the same ids and text exactly, with the `regex` module and with
it hidden: the card's machine has none, so the port's pre-tokenizer runs its
hand-written splitter (bpe.split_exact) there.
"""

import json
import random

import numpy as np
import pytest

tokenizers = pytest.importorskip("tokenizers")
regex = pytest.importorskip("regex")

from tokenizers import Tokenizer, models, pre_tokenizers, trainers  # noqa: E402

from tpu_kquant.gguf.reader import GGUFReader as JReader  # noqa: E402
from tpu_kquant.models.fixtures import tiny_config as j_tiny_config  # noqa: E402
from tpu_kquant.models.fixtures import write_fixture_gguf as j_write_fixture  # noqa: E402
from tpu_kquant.tokenizer import bpe as j_bpe  # noqa: E402
from tpu_kquant.tokenizer import from_gguf_metadata as j_from_md  # noqa: E402
from tpu_kquant.tokenizer.spm import SPMTokenizer as JSPM  # noqa: E402
from tpu_kquant_torch.gguf import GGUFReader  # noqa: E402
from tpu_kquant_torch.models.fixtures import tiny_config, write_fixture_gguf  # noqa: E402
from tpu_kquant_torch.tokenizer import bpe as t_bpe  # noqa: E402
from tpu_kquant_torch.tokenizer import from_gguf_metadata  # noqa: E402
from tpu_kquant_torch.tokenizer.spm import SPM_SPACE, SPMTokenizer  # noqa: E402

TRAIN_CORPUS = [
    "The quick brown fox jumps over the lazy dog.",
    "Pack my box with five dozen liquor jugs!",
    "In 2024, 15% of 378 engineers shipped 1234567 lines of code.",
    "def tokenize(text: str) -> list[int]:\n    return ids",
    "  leading spaces   and\ttabs\nand\r\nnewlines everywhere  ",
    "don't can't won't I'll you're we've they'd it's I'm",
    "naïve café résumé Zürich Москва 東京 مرحبا שלום",
    "!!!??? ... --- ###$$$ @@@ ((()))[[]]{{}}",
    "CamelCase snake_case kebab-case SCREAMING_CASE x86_64",
    "http://example.com/path?query=1&other=2#fragment",
]
# byte fallback (characters the vocabularies never saw), non-ASCII text,
# runs of whitespace, contractions in any case, and specials' spellings
CORPUS = TRAIN_CORPUS + [
    "Hello, world!", "don't DON'T Don'T ſ's", "  double  spaces  ",
    "tabs\tand\nnewlines\r\nmixed \n\n  \n", "12345678901234", "a1b2c3 42x 100,000.99",
    "émigré's naïveté — “smart quotes” …", "日本語のテキスト and English mixed 混合",
    "x('s)('t)('re) its' 'd", "trailing space ", " leading space", "", "\n", "    ",
    "🤖 emoji 🚀 test 🇺🇸", "a　b c d", "word​word", "\x1c\x1f\x85 \x0b",
    "<s> </s> <unk> <0x41>", "Ⅻ ² ٣ ½ numbers", "the hello world the a",
]


def _vocab_of(tok):
    blob = json.loads(tok.to_str())
    vocab, merges = blob["model"]["vocab"], blob["model"]["merges"]
    tokens = [None] * len(vocab)
    for piece, i in vocab.items():
        tokens[i] = piece
    return vocab, tokens, [m if isinstance(m, str) else f"{m[0]} {m[1]}" for m in merges]


@pytest.fixture(scope="module")
def bpe_vocab():
    """A byte-level BPE trained on TRAIN_CORPUS with the llama-3 Split."""
    tok = Tokenizer(models.BPE())
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(tokenizers.Regex(j_bpe.PRE_PATTERNS["llama3"]), behavior="isolated"),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False),
    ])
    trainer = trainers.BpeTrainer(vocab_size=400, special_tokens=["<s>", "</s>"],
                                  show_progress=False,
                                  initial_alphabet=pre_tokenizers.ByteLevel.alphabet())
    tok.train_from_iterator(TRAIN_CORPUS, trainer)
    _, tokens, merges = _vocab_of(tok)
    return tokens, merges


@pytest.fixture(scope="module")
def spm_vocab():
    """A Metaspace BPE with byte fallback; SPM scores = -merge rank."""
    tok = Tokenizer(models.BPE(byte_fallback=True))
    tok.pre_tokenizer = pre_tokenizers.Metaspace(replacement=SPM_SPACE, prepend_scheme="never",
                                                 split=True)
    byte_tokens = [f"<0x{b:02X}>" for b in range(256)]
    trainer = trainers.BpeTrainer(vocab_size=500, show_progress=False,
                                  special_tokens=["<unk>", "<s>", "</s>"] + byte_tokens,
                                  initial_alphabet=[SPM_SPACE], limit_alphabet=1000)
    tok.train_from_iterator([t.replace(" ", SPM_SPACE) for t in TRAIN_CORPUS], trainer)
    vocab, tokens, merges = _vocab_of(tok)
    rank_of = {m.replace(" ", "", 1): r for r, m in enumerate(merges)}
    scores = [-float(rank_of[t]) if t in rank_of else -1e9 for t in tokens]
    ttypes = [1] * len(tokens)
    for b in range(256):
        ttypes[vocab[f"<0x{b:02X}>"]] = 6
    for s in ("<unk>", "<s>", "</s>"):
        ttypes[vocab[s]] = 3
    return tokens, scores, ttypes, vocab


@pytest.fixture
def no_regex(monkeypatch):
    """Hide the regex module from the port's BPE, as on the card's machine."""
    monkeypatch.setattr(t_bpe, "_regex", None)
    monkeypatch.setattr(t_bpe, "_PRE_COMPILED", {})


@pytest.mark.parametrize("hidden", [False, True], ids=["regex", "no-regex"])
@pytest.mark.parametrize("pre", ["llama3", "gpt2", "qwen2"])
def test_bpe_matches_jax(bpe_vocab, pre, hidden, monkeypatch):
    if hidden:
        monkeypatch.setattr(t_bpe, "_regex", None)
        monkeypatch.setattr(t_bpe, "_PRE_COMPILED", {})
    tokens, merges = bpe_vocab
    ours = t_bpe.BPETokenizer(tokens, merges, 0, 1, {0, 1}, pre=pre)
    ref = j_bpe.BPETokenizer(tokens, merges, 0, 1, {0, 1}, pre=pre)
    for text in CORPUS:
        ids = ours.encode(text)
        assert ids == ref.encode(text), text
        assert ours.decode(ids) == ref.decode(ids) == text


@pytest.mark.parametrize("pre", ["llama3", "gpt2", "qwen2", "llama-bpe", "qwen2.5", "other"])
def test_split_exact_matches_regex(pre):
    """The hand-written splitter gives findall's splits: on the corpus and
    on random strings over an alphabet of the cases each pattern decides
    (classes, contractions in any case, every kind of whitespace)."""
    name = j_bpe.PRE_ALIASES.get(pre, pre)
    pat = regex.compile(j_bpe.PRE_PATTERNS.get(name, j_bpe.PRE_PATTERNS["llama3"]))
    alpha = list("aZé1²Ⅻ٣'sStTrRvVmMlLdDſ\t\n\r\x0b\x0c\x1c\x85\xa0　​.,!?(-_🤖日 ")
    alpha += ["'s", "'LL", " '", "\r\n", " \n", "  "]
    rng = random.Random(5)
    texts = CORPUS + ["".join(rng.choice(alpha) for _ in range(rng.randint(1, 12)))
                      for _ in range(3000)]
    for text in texts:
        assert t_bpe.split_exact(text, pre) == pat.findall(text), repr(text)


def test_pretokenize_without_regex_equals_with(no_regex):
    for pre in ("llama3", "gpt2", "qwen2"):
        for text in CORPUS:
            assert t_bpe.pretokenize(text, pre) == j_bpe.pretokenize(text, pre), (pre, text)


@pytest.mark.parametrize("prefix", [False, True])
def test_spm_matches_jax(spm_vocab, prefix):
    tokens, scores, ttypes, vocab = spm_vocab
    ids_of = (vocab["<s>"], vocab["</s>"], vocab["<unk>"])
    ours = SPMTokenizer(tokens, scores, ttypes, *ids_of, add_space_prefix=prefix)
    ref = JSPM(tokens, scores, ttypes, *ids_of, add_space_prefix=prefix)
    for text in CORPUS:
        ids = ours.encode(text, add_eos=True)
        assert ids == ref.encode(text, add_eos=True), text
        assert ours.decode(ids) == ref.decode(ids)


def test_fixture_vocab_matches_jax_writer(tmp_path):
    """The port's fixture writer puts the reference's minimal SPM vocab into
    the file key for key, and both packages' tokenizers read it alike."""
    kw = dict(n_layers=1, dim=64, n_heads=4, n_kv_heads=2, ffn_dim=128, vocab_size=512)
    t_path = write_fixture_gguf(tmp_path / "t.gguf", tiny_config(**kw), seed=1)
    j_path = j_write_fixture(tmp_path / "j.gguf", j_tiny_config(**kw), seed=1)
    t_md, j_md = GGUFReader(t_path).metadata, JReader(j_path).metadata
    keys = sorted(k for k in j_md if k.startswith("tokenizer."))
    assert keys == sorted(k for k in t_md if k.startswith("tokenizer."))
    assert len(keys) == 6
    for k in keys:
        np.testing.assert_array_equal(np.asarray(t_md[k]), np.asarray(j_md[k]), err_msg=k)
    ours, ref = from_gguf_metadata(t_md), j_from_md(j_md)
    for text in CORPUS:
        ids = ours.encode(text)
        assert ids == ref.encode(text), text
        assert ours.decode(ids) == ref.decode(ids)
    # the vocab draws nothing from the seed: the weights are the same bytes
    no_vocab = GGUFReader(write_fixture_gguf(tmp_path / "n.gguf", tiny_config(**kw), seed=1,
                                             with_tokenizer=False))
    r = GGUFReader(t_path)
    assert not any(k.startswith("tokenizer.") for k in no_vocab.metadata)
    for name in r.tensors:
        assert np.array_equal(r.tensor_bytes(name), no_vocab.tensor_bytes(name)), name
