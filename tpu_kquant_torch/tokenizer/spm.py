"""SentencePiece-style greedy-merge tokenizer (llama/TinyLlama vocab): the
port of ``tpu_kquant.tokenizer.spm``, pure Python. Algorithm:
score-ranked bigram merging over the GGUF-embedded vocab (tokens + scores),
with byte fallback <0xXX> for out-of-vocab pieces — the standard SPM BPE
decomposition used by llama-family models.
"""

from __future__ import annotations

import heapq

SPM_SPACE = "▁"  # ▁


class SPMTokenizer:
    def __init__(
        self,
        tokens: list[str],
        scores: list[float],
        token_types: list[int],
        bos_id: int = 1,
        eos_id: int = 2,
        unk_id: int = 0,
        add_space_prefix: bool = True,
    ):
        self.tokens = tokens
        self.scores = scores
        self.token_types = token_types
        self.bos_id, self.eos_id, self.unk_id = bos_id, eos_id, unk_id
        self.add_space_prefix = add_space_prefix
        self.piece_to_id = {t: i for i, t in enumerate(tokens)}
        self.byte_ids = {}
        for b in range(256):
            tid = self.piece_to_id.get(f"<0x{b:02X}>")
            if tid is not None:
                self.byte_ids[b] = tid

    @property
    def vocab_size(self) -> int:
        return len(self.tokens)

    # -- encode ----------------------------------------------------------------
    def _merge(self, text: str) -> list[str]:
        """Greedy highest-score bigram merging (SPM resegmentation)."""
        symbols = list(text)
        if not symbols:
            return []
        # doubly linked list over symbol indices
        prev = list(range(-1, len(symbols) - 1))
        nxt = list(range(1, len(symbols) + 1))
        alive = [True] * len(symbols)
        heap: list[tuple[float, int, int, str]] = []

        def try_add(li: int, ri: int):
            if li < 0 or ri >= len(symbols):
                return
            piece = symbols[li] + symbols[ri]
            tid = self.piece_to_id.get(piece)
            if tid is not None:
                heapq.heappush(heap, (-self.scores[tid], li, ri, piece))

        for i in range(len(symbols) - 1):
            try_add(i, i + 1)

        while heap:
            _, li, ri, piece = heapq.heappop(heap)
            if not (alive[li] and alive[ri]):
                continue
            if symbols[li] + symbols[ri] != piece:
                continue  # stale entry
            symbols[li] = piece
            alive[ri] = False
            nxt[li] = nxt[ri]
            if nxt[ri] < len(symbols):
                prev[nxt[ri]] = li
            try_add(prev[li], li)
            if nxt[li] < len(symbols):
                try_add(li, nxt[li])

        out = []
        i = 0
        while i < len(symbols):
            if alive[i]:
                out.append(symbols[i])
            i += 1
        return out

    def encode(self, text: str, add_bos: bool = True, add_eos: bool = False) -> list[int]:
        if self.add_space_prefix and text and not text.startswith(" "):
            text = " " + text
        text = text.replace(" ", SPM_SPACE)
        ids: list[int] = [self.bos_id] if add_bos else []
        for piece in self._merge(text):
            tid = self.piece_to_id.get(piece)
            if tid is not None:
                ids.append(tid)
            else:  # byte fallback
                for b in piece.encode("utf-8"):
                    ids.append(self.byte_ids.get(b, self.unk_id))
        if add_eos:
            ids.append(self.eos_id)
        return ids

    # -- decode ----------------------------------------------------------------
    def id_to_piece(self, tid: int) -> str:
        return self.tokens[tid]

    def decode(self, ids: list[int]) -> str:
        buf = bytearray()
        for tid in ids:
            t = self.tokens[tid]
            ttype = self.token_types[tid] if tid < len(self.token_types) else 1
            if ttype == 6 and t.startswith("<0x") and t.endswith(">"):  # BYTE
                buf.append(int(t[3:-1], 16))
            elif ttype in (2, 3, 4):  # UNK / CONTROL / USER_DEFINED-ish
                continue
            else:
                buf.extend(t.replace(SPM_SPACE, " ").encode("utf-8"))
        text = buf.decode("utf-8", errors="replace")
        return text[1:] if text.startswith(" ") and self.add_space_prefix else text
