"""Byte-level BPE tokenizer (gpt2-style; llama-3 / qwen2 GGUF vocabs): the
port of ``tpu_kquant.tokenizer.bpe``.

Rank-ordered pair merging over the GGUF-embedded ``tokenizer.ggml.merges``
list, with the gpt2 byte<->unicode mapping so every byte sequence tokenizes.
Pre-tokenization follows the per-family splitter regex (selected by the
GGUF ``tokenizer.ggml.pre`` key, as llama.cpp's LLAMA_VOCAB_PRE_TYPE
dispatch does), through the ``regex`` module where it is installed. Without
it, ``split_exact`` runs each pattern as hand-written code that gives the
same splits: each pattern is a list of alternatives that ``findall`` tries
in order at each position, and every backtracking choice they allow is
decided by looking at most one character ahead.
"""

from __future__ import annotations

import unicodedata

try:
    import regex as _regex
except ImportError:  # pragma: no cover
    _regex = None

# the canonical pre-tokenizer patterns (llama.cpp llama-vocab.cpp /
# the models' tokenizer.json "Split" pre-tokenizers)
PRE_PATTERNS: dict[str, str] = {
    "llama3": (
        r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}"
        r"| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+"
    ),
    "gpt2": (
        r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+"
        r"|\s+(?!\S)|\s+"
    ),
    "qwen2": (
        r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}"
        r"| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+"
    ),
}
PRE_ALIASES = {"llama-bpe": "llama3", "llama-v3": "llama3", "default": "llama3",
               "gpt-2": "gpt2", "qwen2.5": "qwen2"}
_PRE_COMPILED: dict[str, "object"] = {}


def _compiled(pre: str):
    pat = _PRE_COMPILED.get(pre)
    if pat is None and _regex is not None:
        pat = _regex.compile(PRE_PATTERNS[pre])
        _PRE_COMPILED[pre] = pat
    return pat


def bytes_to_unicode() -> dict[int, str]:
    """gpt2's reversible byte -> printable-unicode mapping."""
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(0xA1, 0xAD)) + list(range(0xAE, 0x100))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


_B2U = bytes_to_unicode()
_U2B = {v: k for k, v in _B2U.items()}

# \s of the regex module on str patterns: the Unicode White_Space property
# (not str.isspace, which also takes U+001C..U+001F)
_WHITE_SPACE = frozenset(
    [chr(c) for c in (*range(0x09, 0x0E), 0x20, 0x85, 0xA0, 0x1680, *range(0x2000, 0x200B),
                      0x2028, 0x2029, 0x202F, 0x205F, 0x3000)])
_CONTRACTIONS = ("s", "t", "re", "ve", "m", "ll", "d")


def _letter(c: str) -> bool:  # \p{L}
    return unicodedata.category(c)[0] == "L"


def _number(c: str) -> bool:  # \p{N}
    return unicodedata.category(c)[0] == "N"


def _other(c: str) -> bool:  # [^\s\p{L}\p{N}]
    return c not in _WHITE_SPACE and not _letter(c) and not _number(c)


def _same_letter(c: str, x: str, fold: bool) -> bool:
    """c matches the pattern letter x (lower case); under (?i) by the simple
    case folding the regex module applies (U+017F long s folds to s)."""
    return c == x or fold and (c.lower() == x or c.upper() == x.upper())


def _contraction(text: str, i: int, fold: bool) -> int:
    """End of '(s|t|re|ve|m|ll|d) at i, tried in the pattern's order, or -1."""
    if text[i] != "'":
        return -1
    for suf in _CONTRACTIONS:
        j = i + 1 + len(suf)
        if j <= len(text) and all(_same_letter(text[i + 1 + k], x, fold)
                                  for k, x in enumerate(suf)):
            return j
    return -1


def _run(text: str, i: int, pred, limit: int | None = None) -> int:
    """End of the run of characters from i that satisfy pred (at most limit)."""
    j, n = i, len(text)
    while j < n and pred(text[j]) and (limit is None or j - i < limit):
        j += 1
    return j


def _match_at(text: str, i: int, pre: str) -> int:
    """End of findall's match at i under family ``pre``'s pattern."""
    n, c = len(text), text[i]
    nxt = text[i + 1] if i + 1 < n else ""
    llama = pre != "gpt2"  # llama3 and qwen2 share all but the number rule
    j = _contraction(text, i, fold=llama)
    if j >= 0:
        return j
    if llama:
        # [^\r\n\p{L}\p{N}]?\p{L}+
        if _letter(c):
            return _run(text, i, _letter)
        if c not in "\r\n" and not _number(c) and nxt and _letter(nxt):
            return _run(text, i + 1, _letter)
        # \p{N}{1,3} / \p{N}
        if _number(c):
            return _run(text, i, _number, 3 if pre == "llama3" else 1)
        # ' ?[^\s\p{L}\p{N}]+[\r\n]*'
        start = i + 1 if c == " " and nxt and _other(nxt) else i
        if _other(text[start]):
            j = _run(text, start, _other)
            return _run(text, j, lambda ch: ch in "\r\n")
        # \s*[\r\n]+: the whitespace run up to its last line break
        end = _run(text, i, lambda ch: ch in _WHITE_SPACE)
        last = max((k for k in range(i, end) if text[k] in "\r\n"), default=-1)
        if last >= 0:
            return last + 1
    else:
        # ' ?\p{L}+', ' ?\p{N}+', ' ?[^\s\p{L}\p{N}]+'
        start = i + 1 if c == " " and nxt else i
        for pred in (_letter, _number, _other):
            for s in dict.fromkeys((start, i)):
                if pred(text[s]):
                    return _run(text, s, pred)
    # \s+(?!\S), then \s+
    end = _run(text, i, lambda ch: ch in _WHITE_SPACE)
    if end == n or end - i == 1:
        return end
    return end - 1


def split_exact(text: str, pre: str = "llama3") -> list[str]:
    """``PRE_PATTERNS[pre]``'s ``findall`` over text, without the regex
    module."""
    pre = PRE_ALIASES.get(pre, pre)
    if pre not in PRE_PATTERNS:
        pre = "llama3"
    out, i = [], 0
    while i < len(text):
        j = _match_at(text, i, pre)
        out.append(text[i:j])
        i = j
    return out


def pretokenize(text: str, pre: str = "llama3") -> list[str]:
    """Split ``text`` with the pre-tokenizer regex of family ``pre`` (llama3
    / gpt2 / qwen2; unknown names take llama3): the regex module where it is
    installed, else ``split_exact``, which gives the same splits."""
    pre = PRE_ALIASES.get(pre, pre)
    if pre not in PRE_PATTERNS:
        pre = "llama3"
    pat = _compiled(pre)
    if pat is not None:
        return pat.findall(text)
    return split_exact(text, pre)


class BPETokenizer:
    def __init__(
        self,
        tokens: list[str],
        merges: list[str],
        bos_id: int | None = None,
        eos_id: int | None = None,
        special_ids: set[int] | None = None,
        pre: str = "llama3",
    ):
        self.pre = pre
        self.tokens = tokens
        self.piece_to_id = {t: i for i, t in enumerate(tokens)}
        self.ranks: dict[tuple[str, str], int] = {}
        for r, m in enumerate(merges):
            a, _, b = m.partition(" ")
            self.ranks[(a, b)] = r
        self.bos_id, self.eos_id = bos_id, eos_id
        self.special_ids = special_ids or set()

    @property
    def vocab_size(self) -> int:
        return len(self.tokens)

    def _bpe(self, word: str) -> list[str]:
        parts = list(word)
        while len(parts) > 1:
            best, best_rank = None, None
            for i in range(len(parts) - 1):
                r = self.ranks.get((parts[i], parts[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best, best_rank = i, r
            if best is None:
                break
            parts[best : best + 2] = [parts[best] + parts[best + 1]]
        return parts

    def encode(self, text: str, add_bos: bool = True, add_eos: bool = False) -> list[int]:
        ids: list[int] = [self.bos_id] if (add_bos and self.bos_id is not None) else []
        for chunk in pretokenize(text, self.pre):
            mapped = "".join(_B2U[b] for b in chunk.encode("utf-8"))
            for piece in self._bpe(mapped):
                tid = self.piece_to_id.get(piece)
                if tid is None:
                    for ch in piece:  # per-char fallback
                        t2 = self.piece_to_id.get(ch)
                        if t2 is not None:
                            ids.append(t2)
                else:
                    ids.append(tid)
        if add_eos and self.eos_id is not None:
            ids.append(self.eos_id)
        return ids

    def decode(self, ids: list[int]) -> str:
        buf = bytearray()
        for tid in ids:
            if tid in self.special_ids:
                continue
            for ch in self.tokens[tid]:
                b = _U2B.get(ch)
                if b is not None:
                    buf.append(b)
                else:
                    buf.extend(ch.encode("utf-8"))
        return buf.decode("utf-8", errors="replace")
