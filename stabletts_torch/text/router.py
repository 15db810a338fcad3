"""Automatic language routing for mixed-language text.

The reference ships a `cjke_cleaners4` auto-router that is dead code and
buggy (concatenates a list onto a str, text/cleaners.py:30-58); this is a
working equivalent: the text is split into language spans (Chinese han /
Japanese kana / everything-latin) and each span is dispatched to its g2p,
with punctuation attached to the preceding span.
"""

from __future__ import annotations

import re
from typing import List

_HAN = r"一-鿿㐀-䶿"
_KANA = r"ぁ-ヿ"
_SPAN = re.compile(
    rf"(?P<ja>[{_KANA}]+[{_HAN}{_KANA}]*)|(?P<zh>[{_HAN}]+)|(?P<en>[A-Za-z][A-Za-z' ]*)"
)
# sentence-context classification: a han-only run inside a sentence that
# carries kana is Japanese (今日の会議 must not read 今日 as jin1 ri4) —
# kanji-only spans are only Chinese when their whole sentence is kana-free
_SENT_SPLIT = re.compile(r"(?<=[。．.!?！?\n])")
_KANA_RE = re.compile(rf"[{_KANA}]")


def detect_language(text: str) -> str:
    """Dominant language of a string: 'chinese' | 'japanese' | 'english'."""
    counts = {"zh": 0, "ja": 0, "en": 0}
    for m in _SPAN.finditer(text):
        counts[m.lastgroup] += len(m.group())
    if counts["ja"]:
        return "japanese"
    if counts["zh"] >= counts["en"]:
        return "chinese" if counts["zh"] else "english"
    return "english"


def auto_g2p(text: str) -> List[str]:
    """Mixed text -> phone list, routing each span to its language g2p.

    Spans containing kana are treated as Japanese (kanji inside them still
    needs kana-ization); pure-han spans go to the Chinese g2p; latin spans to
    English. Punctuation between spans passes through the following span's
    cleaner (or as raw symbols).
    """
    from stabletts_torch.text.english import english_to_ipa2
    from stabletts_torch.text.japanese import japanese_to_ipa2
    from stabletts_torch.text.mandarin import chinese_to_cnm3

    g2p = {
        "zh": chinese_to_cnm3,
        "ja": japanese_to_ipa2,
        "en": english_to_ipa2,
    }
    matches = list(_SPAN.finditer(text))

    def route_gap(gap: str, prev_lang, next_lang):
        if not gap.strip():
            return
        # digits belong to the surrounding language — a '5' inside an English
        # sentence must be verbalized in English, not read as Mandarin 'wu3';
        # next to kana it goes through the Japanese number verbalizer.
        if re.search(r"[0-9]", gap):
            lang = prev_lang or next_lang or "en"
            phones.extend(g2p[lang](gap))
        else:
            # bare punctuation: chinese normalization handles both CJK and
            # ascii punctuation tables
            phones.extend(chinese_to_cnm3(gap))

    # sentence boundaries for the kana-context rule
    sent_has_kana = []
    edge = 0
    for sent in _SENT_SPLIT.split(text):
        sent_has_kana.append((edge, edge + len(sent), bool(_KANA_RE.search(sent))))
        edge += len(sent)

    def span_lang(m) -> str:
        lang = m.lastgroup
        if lang == "zh":
            for lo, hi, has_kana in sent_has_kana:
                if lo <= m.start() < hi:
                    return "ja" if has_kana else "zh"
        return lang

    phones: List[str] = []
    langs = [span_lang(m) for m in matches]
    # Coalesce adjacent same-language spans into ONE g2p call: the span
    # regex cuts 新しい into 新|しい and 会議は into 会議|は, and a split
    # call loses the okurigana/particle context (は must read わ). A
    # digits-only gap between two Japanese spans is glued in as well so
    # 1,500円 reaches the Japanese number verbalizer whole.
    digit_glue = re.compile(r"^[0-9][0-9.,:%/+\-〜~]*$")
    groups: List[List[object]] = []  # [lang, start, end]
    for i, m in enumerate(matches):
        if groups:
            plang, pstart, pend = groups[-1]
            gap = text[pend : m.start()]
            if plang == langs[i] and (
                not gap or (langs[i] == "ja" and digit_glue.match(gap))
            ):
                groups[-1][2] = m.end()
                continue
        groups.append([langs[i], m.start(), m.end()])
    pos = 0
    for i, (lang, start, end) in enumerate(groups):
        prev_lang = groups[i - 1][0] if i else None
        route_gap(text[pos:start], prev_lang, lang)
        phones.extend(g2p[lang](text[start:end]))
        pos = end
    route_gap(text[pos:], groups[-1][0] if groups else None, None)
    return phones
