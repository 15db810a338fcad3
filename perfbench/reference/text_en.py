"""English text to phoneme ids for the sentences of the benchmark's word
list: each word's IPA (g2p_en.tsv, frozen from the text front end, whose
sentence output is the words' IPA joined by spaces and a full stop at the
end), the published 401-symbol table (symbols.json), and a blank id 0
between and around the symbols."""

from __future__ import annotations

import json
import os

_DIR = os.path.dirname(os.path.abspath(__file__))


def _tables():
    with open(os.path.join(_DIR, "g2p_en.tsv"), encoding="utf-8") as f:
        g2p = dict(line.rstrip("\n").split("\t", 1) for line in f if line.strip())
    with open(os.path.join(_DIR, "symbols.json"), encoding="utf-8") as f:
        ids = {s: i for i, s in enumerate(json.load(f))}
    return g2p, ids


_G2P, _IDS = _tables()


def sentence_ids(sentence: str) -> list:
    """'Word word word.' -> interspersed phoneme ids."""
    words = sentence.rstrip(".").lower().split(" ")
    ipa = " ".join(_G2P[w] for w in words) + "."
    seq = [_IDS[c] for c in ipa if c in _IDS]
    out = [0] * (2 * len(seq) + 1)
    out[1::2] = seq
    return out
