"""Chinese g2p: text -> CNM3 tone-numbered phones
(reference: text/mandarin.py:150-173).

Pipeline: punctuation/symbol normalization -> arabic->chinese numbers ->
jieba segmentation -> pinyin (TONE3) via the vendored phrase/char dicts ->
CNM3 phone expansion with tone suffixes.
"""

from __future__ import annotations

import functools
import os
import re
from typing import Dict, List

from stabletts_torch.text.numbers_zh import an2cn
from stabletts_torch.text.pinyin import lazy_pinyin_tone3

# punctuation / symbol normalization table (reference: text/mandarin.py:12-105)
PUNC_MAP: Dict[str, str] = {
    "：": ",", "；": ",", "，": ",", "。": ".", "！": "!", "？": "?", "\n": ".",
    "·": ",", "、": ",", "$": ".", "“": "'", "”": "'", '"': "'", "‘": "'",
    "’": "'", "（": "'", "）": "'", "(": "'", ")": "'", "《": "'", "》": "'",
    "【": "'", "】": "'", "[": "'", "]": "'", "—": "-", "～": "~", "「": "'",
    "」": "'", "『": "'", "』": "'",
    # GPT-SoVITS-style symbol-to-chinese readings
    "/": "每", "①": "一", "②": "二", "③": "三", "④": "四", "⑤": "五",
    "⑥": "六", "⑦": "七", "⑧": "八", "⑨": "九", "⑩": "十",
    "α": "阿尔法", "β": "贝塔", "γ": "伽玛", "Γ": "伽玛", "δ": "德尔塔",
    "Δ": "德尔塔", "ε": "艾普西龙", "ζ": "捷塔", "η": "依塔", "θ": "西塔",
    "Θ": "西塔", "ι": "艾欧塔", "κ": "喀帕", "λ": "拉姆达", "Λ": "拉姆达",
    "μ": "缪", "ν": "拗", "ξ": "克西", "Ξ": "克西", "ο": "欧米克伦",
    "π": "派", "Π": "派", "ρ": "肉", "ς": "西格玛", "σ": "西格玛",
    "Σ": "西格玛", "τ": "套", "υ": "宇普西龙", "φ": "服艾", "Φ": "服艾",
    "χ": "器", "ψ": "普赛", "Ψ": "普赛", "ω": "欧米伽", "Ω": "欧米伽",
    "+": "加", "-": "减", "×": "乘", "÷": "除", "=": "等",
    "嗯": "恩", "呣": "母",
}
PUNC_TABLE = str.maketrans(PUNC_MAP)

NUMBER_PATTERN = re.compile(r"\d+(?:\.?\d+)?")
_FILTER_PATTERN = re.compile(r"[#&@“”^_|\\]")


_PERCENT_PATTERN = re.compile(r"(\d+(?:\.\d+)?)\s*%")


def normalize_number(text: str) -> str:
    # N% -> 百分之N first: '%' is not a symbol and would otherwise leak
    # through the CNM3 stream as a dead token
    text = _PERCENT_PATTERN.sub(lambda m: "百分之" + an2cn(m.group(1)), text)
    return NUMBER_PATTERN.sub(lambda m: an2cn(m.group()), text)


@functools.lru_cache(maxsize=1)
def cnm3_dict() -> Dict[str, List[str]]:
    """pinyin syllable -> CNM3 phones (vendored ds_CNM3 table)."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "cnm3.tsv")
    out = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            syllable, phones = line.split("\t", 1)
            out[syllable] = phones.split()
    return out


def chinese_to_cnm3(text: str) -> List[str]:
    """(reference: text/mandarin.py:150-173). Unknown alphabetic tokens are
    dropped; punctuation passes through as individual symbols."""
    import jieba

    text = text.translate(PUNC_TABLE)
    text = normalize_number(text)
    text = _FILTER_PATTERN.sub("", text)

    pinyin_dict = cnm3_dict()
    phones: List[str] = []
    for word in jieba.lcut(text, cut_all=False):
        for pinyin in lazy_pinyin_tone3(word):
            if pinyin and pinyin[-1].isdigit():
                tone = pinyin[-1]
                syllable = pinyin[:-1]
                phone = pinyin_dict.get(syllable)
                if phone is None:
                    continue
                phones.extend(ph + tone for ph in phone)
            elif pinyin and pinyin[-1].isalpha():
                pass  # untranscribed alphabetic token: dropped
            else:
                phones.extend(pinyin)
    return phones
