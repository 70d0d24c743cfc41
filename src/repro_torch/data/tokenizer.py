"""Byte-level tokenizer with reserved control/label tokens.

No external vocab files are available offline; a byte tokenizer is exact,
reversible, and sufficient for the substrate (the semantic-operator layer
only needs token ids + designated single-token labels for predicate /
comparison prompting, mirroring the paper's True/False log-prob proxies).
"""
from __future__ import annotations

import numpy as np

PAD = 256
BOS = 257
EOS = 258
TRUE = 259   # single-token "True" label (predicate prompts)
FALSE = 260  # single-token "False" label
OPT_A = 261  # pairwise-comparison labels (sem_topk)
OPT_B = 262
SEP = 263

VOCAB_SIZE = 384  # 256 bytes + specials, padded up for alignment

SPECIAL_TEXT = {
    "<pad>": PAD, "<bos>": BOS, "<eos>": EOS,
    "<true>": TRUE, "<false>": FALSE, "<A>": OPT_A, "<B>": OPT_B, "<sep>": SEP,
}
_ID_TO_SPECIAL = {v: k for k, v in SPECIAL_TEXT.items()}


class ByteTokenizer:
    vocab_size = VOCAB_SIZE
    pad_id, bos_id, eos_id = PAD, BOS, EOS
    true_id, false_id, a_id, b_id, sep_id = TRUE, FALSE, OPT_A, OPT_B, SEP

    def encode(self, text: str, *, bos: bool = True, eos: bool = False) -> list[int]:
        ids = list(text.encode("utf-8"))
        if bos:
            ids = [BOS] + ids
        if eos:
            ids = ids + [EOS]
        return ids

    def decode(self, ids) -> str:
        out: list[str] = []
        buf: list[int] = []
        for t in np.asarray(ids).tolist():
            if t < 256:
                buf.append(t)
            else:
                if buf:
                    out.append(bytes(buf).decode("utf-8", errors="replace"))
                    buf = []
                if t in _ID_TO_SPECIAL and t not in (BOS, PAD):
                    out.append(_ID_TO_SPECIAL[t])
        if buf:
            out.append(bytes(buf).decode("utf-8", errors="replace"))
        return "".join(out)

    def pad_batch(self, seqs: list[list[int]], length: int | None = None) -> np.ndarray:
        length = length or max(len(s) for s in seqs)
        out = np.full((len(seqs), length), PAD, np.int32)
        for i, s in enumerate(seqs):
            out[i, : min(len(s), length)] = s[:length]
        return out


TOKENIZER = ByteTokenizer()
