"""Pinyin engine: phrase/char lookup + TONE3 conversion.

Replaces pypinyin's `lazy_pinyin(word, Style.TONE3, neutral_tone_with_five=
True)` as used by the reference (text/mandarin.py:157): phrase-level lookup
from the vendored CC-CEDICT/genshin data, falling back to a per-character
majority-vote dictionary derived from the same data. Non-Chinese characters
pass through unchanged (pypinyin behavior).
"""

from __future__ import annotations

import functools
import os
import unicodedata
from typing import Dict, List

_DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")

# combining tone marks (after NFD) -> tone number
_TONE_MARKS = {
    "̄": "1",  # macron
    "́": "2",  # acute
    "̌": "3",  # caron
    "̀": "4",  # grave
}


def diacritic_to_tone3(syllable: str) -> str:
    """'xié' -> 'xie2', 'lǜ' -> 'lv4', 'ma' -> 'ma5' (neutral tone = 5).

    'ü' maps to 'v' per the CNM3 syllable convention (text/cnm3/ds_CNM3.txt
    keys use lv/nv)."""
    decomposed = unicodedata.normalize("NFD", syllable)
    tone = ""
    out = []
    for ch in decomposed:
        if ch in _TONE_MARKS:
            tone = _TONE_MARKS[ch]
        elif ch == "̈":  # diaeresis: ü -> v
            if out and out[-1] == "u":
                out[-1] = "v"
            elif out and out[-1] == "U":
                out[-1] = "V"
        elif unicodedata.combining(ch):
            continue
        else:
            out.append(ch)
    base = "".join(out)
    if not base.isalpha():
        return syllable
    return base + (tone or "5")


def _load_tsv(path: str) -> Dict[str, str]:
    out = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            key, value = line.split("\t", 1)
            out[key] = value
    return out


@functools.lru_cache(maxsize=1)
def phrase_dict() -> Dict[str, List[str]]:
    raw = _load_tsv(os.path.join(_DATA_DIR, "pinyin_phrases.tsv"))
    return {k: v.split(" ") for k, v in raw.items()}


@functools.lru_cache(maxsize=1)
def char_dict() -> Dict[str, str]:
    return _load_tsv(os.path.join(_DATA_DIR, "pinyin_chars.tsv"))


def lazy_pinyin_tone3(word: str) -> List[str]:
    """Word -> TONE3 syllables. Whole-word phrase lookup first, then
    longest-match segments, then per-char; unknown chars pass through."""
    phrases = phrase_dict()
    chars = char_dict()
    if word in phrases:
        return list(phrases[word])
    out: List[str] = []
    i = 0
    n = len(word)
    while i < n:
        matched = False
        # longest phrase match within the word (up to 8 chars)
        for j in range(min(n, i + 8), i + 1, -1):
            seg = word[i:j]
            if seg in phrases:
                out.extend(phrases[seg])
                i = j
                matched = True
                break
        if matched:
            continue
        ch = word[i]
        # measure-word 只 after a numeral is zhi1 (一只/两只/几只), the one
        # bound reading jieba's numeral+classifier tokens leave per-char
        if ch == "只" and i > 0 and word[i - 1] in "一二三四五六七八九十百千几两每":
            out.append("zhi1")
        else:
            out.append(chars.get(ch, ch))
        i += 1
    return out
