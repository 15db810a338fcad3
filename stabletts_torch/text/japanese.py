"""Japanese g2p: text (kanji + kana) -> IPA2 character list
(reference: text/japanese.py).

The reference delegates to pyopenjtalk (native Open JTalk + its UniDic-style
morphological/accent dictionary), unavailable in this image. This module
reproduces the same *output conventions* with a self-contained pipeline:

  1. segmentation: greedy longest-match over a vendored word dictionary
     (text/data/ja_words.tsv: surface -> kana reading -> Tokyo accent type),
     single-kanji fallback readings (text/data/ja_kanji.tsv), kana passthrough
  2. accent phrases: particles/auxiliaries attach to the preceding content
     word; each phrase carries its head word's accent nucleus position
  3. mora conversion: kana -> Open-JTalk romaji moras (digraph = 1 mora,
     っ = Q via 'cl', ん = N, ー = vowel length)
  4. high-vowel devoicing: i/u in a voiceless-onset mora followed by a
     voiceless onset (or phrase-final su/shi after voiceless) -> I/U,
     matching Open JTalk's devoiced-vowel labels; the accent nucleus resists
  5. pitch-accent arrows exactly as the reference derives them from the
     fullcontext labels (japanese.py:95-112): within a phrase of accent type
     k, '↓' after mora k, elif '↑' after mora 1; ' ' between phrases
  6. the reference's sokuon/hatsuon rewrites and romaji->IPA2 substitutions

Unknown kanji (not in either table) are skipped with a warning — with the
vendored tables this is the rare tail, not the common case.
"""

from __future__ import annotations

import os
import re
import warnings
from typing import Dict, List, Optional, Tuple

# kana -> Open-JTalk-style romaji, one entry per mora
_KANA_MAP = {
    # basic hiragana
    "あ": "a", "い": "i", "う": "u", "え": "e", "お": "o",
    "か": "ka", "き": "ki", "く": "ku", "け": "ke", "こ": "ko",
    "さ": "sa", "し": "shi", "す": "su", "せ": "se", "そ": "so",
    "た": "ta", "ち": "chi", "つ": "tsu", "て": "te", "と": "to",
    "な": "na", "に": "ni", "ぬ": "nu", "ね": "ne", "の": "no",
    "は": "ha", "ひ": "hi", "ふ": "fu", "へ": "he", "ほ": "ho",
    "ま": "ma", "み": "mi", "む": "mu", "め": "me", "も": "mo",
    "や": "ya", "ゆ": "yu", "よ": "yo",
    "ら": "ra", "り": "ri", "る": "ru", "れ": "re", "ろ": "ro",
    "わ": "wa", "ゐ": "i", "ゑ": "e", "を": "o", "ん": "N",
    "が": "ga", "ぎ": "gi", "ぐ": "gu", "げ": "ge", "ご": "go",
    "ざ": "za", "じ": "ji", "ず": "zu", "ぜ": "ze", "ぞ": "zo",
    "だ": "da", "ぢ": "ji", "づ": "zu", "で": "de", "ど": "do",
    "ば": "ba", "び": "bi", "ぶ": "bu", "べ": "be", "ぼ": "bo",
    "ぱ": "pa", "ぴ": "pi", "ぷ": "pu", "ぺ": "pe", "ぽ": "po",
    "ゔ": "vu",
    # digraphs (one mora each)
    "きゃ": "kya", "きゅ": "kyu", "きょ": "kyo",
    "しゃ": "sha", "しゅ": "shu", "しょ": "sho",
    "ちゃ": "cha", "ちゅ": "chu", "ちょ": "cho",
    "にゃ": "nya", "にゅ": "nyu", "にょ": "nyo",
    "ひゃ": "hya", "ひゅ": "hyu", "ひょ": "hyo",
    "みゃ": "mya", "みゅ": "myu", "みょ": "myo",
    "りゃ": "rya", "りゅ": "ryu", "りょ": "ryo",
    "ぎゃ": "gya", "ぎゅ": "gyu", "ぎょ": "gyo",
    "じゃ": "ja", "じゅ": "ju", "じょ": "jo",
    "ぢゃ": "ja", "ぢゅ": "ju", "ぢょ": "jo",
    "びゃ": "bya", "びゅ": "byu", "びょ": "byo",
    "ぴゃ": "pya", "ぴゅ": "pyu", "ぴょ": "pyo",
    "ふぁ": "fa", "ふぃ": "fi", "ふぇ": "fe", "ふぉ": "fo",
    "うぃ": "wi", "うぇ": "we", "うぉ": "wo",
    "てぃ": "ti", "でぃ": "di", "とぅ": "tu", "どぅ": "du",
    "しぇ": "she", "ちぇ": "che", "じぇ": "je",
    "ゔぁ": "va", "ゔぃ": "vi", "ゔぇ": "ve", "ゔぉ": "vo", "ゔゅ": "vyu",
    "つぁ": "tsa", "つぃ": "tsi", "つぇ": "tse", "つぉ": "tso",
    "いぇ": "ye", "きぇ": "kye", "にぇ": "nye", "ひぇ": "hye",
    # small vowels standalone
    "ぁ": "a", "ぃ": "i", "ぅ": "u", "ぇ": "e", "ぉ": "o",
}
_SOKUON = "っ"
_CHOUON = "ー"

_KATA_START, _KATA_END = 0x30A1, 0x30F6

_japanese_marks = re.compile(
    r"[^A-Za-z\d々぀-ヿ一-鿿１-９Ａ-Ｚａ-ｚｦ-ﾝ]"
)

_symbols_to_japanese = [(re.compile("％"), "パーセント"), (re.compile("%"), "パーセント")]

_romaji_to_ipa2 = [
    (re.compile(p), r)
    for p, r in [
        ("u", "ɯ"), ("ʧ", "tʃ"), ("j", "dʑ"), ("y", "j"), ("ni", "n^i"),
        ("nj", "n^"), ("hi", "çi"), ("hj", "ç"), ("f", "ɸ"), ("I", "i*"),
        ("U", "ɯ*"), ("r", "ɾ"),
    ]
]

_real_sokuon = [
    (re.compile(p), r)
    for p, r in [
        (r"Q([↑↓]*[kg])", r"k#\1"), (r"Q([↑↓]*[tdjʧ])", r"t#\1"),
        (r"Q([↑↓]*[sʃ])", r"s\1"), (r"Q([↑↓]*[pb])", r"p#\1"),
    ]
]

_real_hatsuon = [
    (re.compile(p), r)
    for p, r in [
        (r"N([↑↓]*[pbm])", r"m\1"), (r"N([↑↓]*[ʧʥj])", r"n^\1"),
        (r"N([↑↓]*[tdn])", r"n\1"), (r"N([↑↓]*[kg])", r"ŋ\1"),
    ]
]

# particles / auxiliaries that attach to the preceding accent phrase.
# longest-first so った/ます match before た/ま. Readings: は->wa, へ->e.
_PARTICLES = [
    "でしょう", "ですか", "ました", "ません", "ながら", "けれど", "について",
    "によって", "という", "ていた", "ている", "でした", "たちは", "たちが",
    "です", "ます", "から", "まで", "より", "ほど", "だけ", "など", "くらい",
    "ぐらい", "ばかり", "しか", "でも", "とも", "とは", "には", "へは", "では",
    "もう", "こそ", "さえ", "って", "た", "て", "と", "な", "に", "ね", "の",
    "は", "へ", "も", "や", "よ", "を", "が", "で", "か", "ぞ", "ぜ", "わ",
    "さ", "し",
]
_PARTICLE_READING = {"は": "わ", "へ": "え"}
# polite-auxiliary nucleus position relative to the stem's last mora
# (1 = the aux's first mora): ま↓す, ま↓した, ませ↓ん, ましょ↓う, でしょ↓う
_AUX_ACCENT = {"ます": 1, "ました": 1, "ません": 2, "でしょう": 2}

_DATA_DIR = os.path.join(os.path.dirname(__file__), "data")
_word_dict: Optional[Dict[str, Tuple[str, int]]] = None
# kanji -> (isolated_reading, on_variants, initial_on).
#   on_variants: the on readings usable inside multi-kanji Sino compounds,
#     pipe-separated in the table, first = default (used compound-finally
#     and wherever no more specific rule applies); falls back to the
#     isolated reading when the table has no third column (on == kun, or
#     the kanji is kun-only even in compounds: 畑, 峠, 箱 ...).
#   initial_on: optional 4th column — the variant used when the kanji is
#     NOT in effectively-final position (力学 りき vs 能力 りょく). The
#     reference gets every context-dependent reading whole from Open
#     JTalk's morphological dictionary (reference text/japanese.py:84);
#     here default/initial variants + the pair-binding table below cover
#     the じ/ち, りき/りょく, にん/じん, こう/ぎょう-class splits.
_kanji_dict: Optional[Dict[str, Tuple[str, List[str], Optional[str]]]] = None
# (left_kanji, right_kanji) at an element boundary -> (left_reading,
# right_reading) lexicalized overrides; "" = leave that side alone.
_binding_dict: Optional[Dict[Tuple[str, str], Tuple[str, str]]] = None
_max_word_len = 1


def _load_dicts() -> Tuple[
    Dict[str, Tuple[str, int]], Dict[str, Tuple[str, List[str], Optional[str]]]
]:
    global _word_dict, _kanji_dict, _max_word_len
    if _word_dict is None:
        words: Dict[str, Tuple[str, int]] = {}
        path = os.path.join(_DATA_DIR, "ja_words.tsv")
        if os.path.exists(path):
            with open(path, encoding="utf-8") as f:
                for line in f:
                    parts = line.rstrip("\n").split("\t")
                    if len(parts) >= 2 and parts[0]:
                        accent = int(parts[2]) if len(parts) > 2 and parts[2] else 0
                        words.setdefault(parts[0], (parts[1], accent))
        kanji: Dict[str, Tuple[str, List[str], Optional[str]]] = {}
        path = os.path.join(_DATA_DIR, "ja_kanji.tsv")
        if os.path.exists(path):
            with open(path, encoding="utf-8") as f:
                for line in f:
                    parts = line.rstrip("\n").split("\t")
                    if len(parts) >= 2 and parts[0]:
                        iso = parts[1]
                        ons = (
                            parts[2].split("|")
                            if len(parts) > 2 and parts[2]
                            else [iso]
                        )
                        initial = (
                            parts[3] if len(parts) > 3 and parts[3] else None
                        )
                        kanji.setdefault(parts[0], (iso, ons, initial))
        _word_dict = words
        _kanji_dict = kanji
        _max_word_len = max((len(w) for w in words), default=1)
    return _word_dict, _kanji_dict


_stem_dict: Optional[Dict[str, Tuple[str, str]]] = None


def _load_stems() -> Dict[str, Tuple[str, str]]:
    """kanji -> (okurigana stem, allowed first kana), consulted ONLY when
    hiragana directly follows an isolated kanji AND that kana is in the
    allowed set: 会う must read あう through the fallback while 会を keeps
    the isolated reading かい (を after a kanji is a particle, never
    okurigana). Derived from ja_words conjugation rows (round-5 audit)."""
    global _stem_dict
    if _stem_dict is None:
        stems: Dict[str, Tuple[str, str]] = {}
        path = os.path.join(_DATA_DIR, "ja_stems.tsv")
        if os.path.exists(path):
            with open(path, encoding="utf-8") as f:
                for line in f:
                    if line.startswith("#"):
                        continue
                    parts = line.rstrip("\n").split("\t")
                    if len(parts) >= 3 and parts[0]:
                        stems.setdefault(parts[0], (parts[1], parts[2]))
        _stem_dict = stems
    return _stem_dict


def _load_bindings() -> Dict[Tuple[str, str], Tuple[str, str]]:
    global _binding_dict
    if _binding_dict is None:
        bindings: Dict[Tuple[str, str], Tuple[str, str]] = {}
        path = os.path.join(_DATA_DIR, "ja_bindings.tsv")
        if os.path.exists(path):
            with open(path, encoding="utf-8") as f:
                for line in f:
                    parts = line.rstrip("\n").split("\t")
                    if len(parts) >= 3 and len(parts[0]) == 2:
                        bindings.setdefault(
                            (parts[0][0], parts[0][1]), (parts[1], parts[2])
                        )
        _binding_dict = bindings
    return _binding_dict


def _kata_to_hira(text: str) -> str:
    return "".join(
        chr(ord(c) - 0x60) if _KATA_START <= ord(c) <= _KATA_END else c for c in text
    )


def _is_kanji(ch: str) -> bool:
    return 0x4E00 <= ord(ch) <= 0x9FFF or ch == "々"


# honorific suffixes keep their address reading after a name, never the
# on-compound reading (田中様 = さま, not よう)
_HONORIFIC_SUFFIX = {"様": "さま", "殿": "どの"}


# continuative (i-row) kana -> dictionary-form (u-row) kana of the same
# consonant, for okurigana-echo trimming
_IROW_TO_UROW = {"い": "う", "き": "く", "ぎ": "ぐ", "し": "す", "ち": "つ",
                 "に": "ぬ", "ひ": "ふ", "び": "ぶ", "み": "む", "り": "る"}


def _trim_okurigana(kun: str, following: str) -> str:
    """Kun readings are stored in their noun/continuative spelling (担 ->
    にない for 担い手); when the surface supplies its own okurigana (担う)
    the echoed tail must come off or it doubles (にな_いう_). Strip the
    longest kun suffix the upcoming kana re-spell, allowing the final
    continuative i-row kana to stand for its u-row dictionary form:
    にない+う -> にな+う, ふくらみ+らむ -> ふく+らむ, おとずれ+れる ->
    おとず+れる, まつり+り -> まつ+り, あかり+るい -> あか+るい."""
    for L in range(min(len(kun) - 1, len(following)), 0, -1):
        tail, head = kun[-L:], following[:L]
        ok = True
        for k, (a, b) in enumerate(zip(tail, head)):
            if a == b:
                continue
            if k == L - 1 and _IROW_TO_UROW.get(a) == b:
                continue
            ok = False
            break
        if ok:
            return kun[:-L]
    # godan past/te gemination and nasalization: the continuative final
    # i-row kana drops before っ/ん (買い+った -> 買った, 読み+んだ ->
    # 読んだ, 庇い+った -> 庇った)
    if (len(kun) >= 2 and kun[-1] in _IROW_TO_UROW
            and following[:1] in ("っ", "ん")):
        return kun[:-1]
    return kun


def _is_kana(ch: str) -> bool:
    o = ord(ch)
    return 0x3041 <= o <= 0x309F or 0x30A1 <= o <= 0x30FF or ch == _CHOUON


def kana_to_moras(kana: str) -> List[str]:
    """Kana string -> list of Open-JTalk romaji moras ('cl' for っ, 'N' for ん,
    long vowels repeat the previous vowel as their own mora)."""
    text = _kata_to_hira(kana)
    moras: List[str] = []
    i = 0
    while i < len(text):
        two = text[i : i + 2]
        ch = text[i]
        if two in _KANA_MAP:
            moras.append(_KANA_MAP[two])
            i += 2
            continue
        if ch == _SOKUON:
            moras.append("cl")
        elif ch == _CHOUON:
            prev = moras[-1] if moras else ""
            if prev and prev[-1] in "aiueo":
                moras.append(prev[-1])
        elif ch in _KANA_MAP:
            moras.append(_KANA_MAP[ch])
        i += 1
    return moras


# --- segmentation into accent phrases --------------------------------------

_VOICELESS_ONSETS = ("k", "s", "t", "p", "h", "f", "ch", "sh", "ts",
                     "ky", "hy", "py", "sha", "shu", "sho", "cha", "chu", "cho")

# --- Sino-compound sandhi (kana level) --------------------------------------
_K_ROW = set("かきくけこ")
_S_ROW = set("さしすせそ")
_T_ROW = set("たちつてと")
_H2P = {"は": "ぱ", "ひ": "ぴ", "ふ": "ぷ", "へ": "ぺ", "ほ": "ぽ"}


def _join_on_readings(
    readings: List[str], surfaces: Optional[List[str]] = None
) -> List[str]:
    """Join per-element kana readings of a Sino compound applying the regular
    sandhi rules (the reference gets these readings whole from Open JTalk's
    dictionary, reference text/japanese.py:84):

    - sokuon gemination: element-final つ/ち before k/s/t/h -> っ
      (いち+ぱん patterns: 出発 しゅつ+はつ -> しゅっぱつ, 一致 いっち),
      element-final く/き before k -> っ (学校 がく+こう -> がっこう)
    - h-row onset hardens to p after っ and ん (発表 はっぴょう,
      心配 しんぱい, 文法 ぶんぽう)

    Lexical rendaku (敗北 はいぼく, 研究所 けんきゅうじょ) is out of scope
    here — such words belong in ja_words.tsv.

    Sandhi applies only between single-kanji elements: a multi-kanji word
    followed by a suffix keeps its boundary (出発 + 点 -> しゅっぱつてん,
    not しゅっぱってん), while 欠 + 点 -> けってん still geminates.
    `surfaces` carries each element's surface form for that check.
    """
    out: List[str] = []
    for idx, r in enumerate(readings):
        left_single = surfaces is None or (idx > 0 and len(surfaces[idx - 1]) == 1)
        if out and r and left_single:
            prev = out[-1]
            first = r[0]
            # a single-mora reading never geminates — っ would swallow the
            # whole element (危機 きき must stay kiki, not Qki)
            if len(prev) < 2:
                out.append(r)
                continue
            if prev and prev[-1] in "つち" and (
                first in _K_ROW or first in _S_ROW or first in _T_ROW
                or first in _H2P
            ):
                out[-1] = prev[:-1] + "っ"
                if first in _H2P:
                    r = _H2P[first] + r[1:]
            elif prev and prev[-1] in "くき" and first in _K_ROW:
                out[-1] = prev[:-1] + "っ"
            elif prev and prev[-1] == "ん" and first in _H2P:
                r = _H2P[first] + r[1:]
        out.append(r)
    return out


# noun-forming suffix kanji that attach AFTER a complete compound: for
# on-variant selection they are transparent — the kanji before them keeps
# its effectively-final reading (能力者 のうりょくしゃ stays りょく, not
# the compound-initial りき of 力学)
_TRANSPARENT_SUFFIX = {
    "者", "的", "化", "性", "費", "論", "界", "感", "権", "制", "式",
    "型", "級", "層", "側", "団", "場", "家", "別", "用", "上", "戦",
}


def _select_on_variants(
    surfaces: List[str],
    readings: List[str],
    kanji_tbl: Dict[str, Tuple[str, List[str], Optional[str]]],
) -> List[str]:
    """Pick each single-kanji element's on reading in compound context.

    Priority: (1) pair bindings — lexicalized readings keyed on the two
    kanji at an element boundary (自治 じ+ち, 人間 にん+げん, 行政
    ぎょう+せい); (2) positional preference — the table's 4th-column
    variant when the kanji is not effectively final (力学 りき); (3) the
    default (first) on variant. Multi-kanji word elements keep their
    dictionary readings. The reference resolves all of this through Open
    JTalk's morphological dictionary (reference text/japanese.py:84).
    """
    n = len(surfaces)

    def effectively_final(i: int) -> bool:
        return all(
            len(surfaces[j]) == 1 and surfaces[j] in _TRANSPARENT_SUFFIX
            for j in range(i + 1, n)
        )

    out: List[str] = []
    for i, s in enumerate(surfaces):
        if len(s) == 1 and s in kanji_tbl:
            _, ons, initial = kanji_tbl[s]
            if initial and not effectively_final(i):
                out.append(initial)
            else:
                out.append(ons[0])
        else:
            out.append(readings[i])
    bindings = _load_bindings()
    for i in range(n - 1):
        key = (surfaces[i][-1], surfaces[i + 1][0])
        hit = bindings.get(key)
        if hit:
            left, right = hit
            if left and len(surfaces[i]) == 1:
                out[i] = left
            if right and len(surfaces[i + 1]) == 1:
                out[i + 1] = right
    return out


# suffix kanji that pull the accent nucleus onto the last mora of the stem
# (競争力 きょうそう↓りょく, 研究者 けんきゅう↓しゃ)
_PREACCENT_SUFFIX = {"力", "者"}
# 2-mora suffixes that still take the nucleus on their own first mora
# (言語学 げんご↓がく)
_SELFACCENT_SUFFIX = {"学"}


def _compound_accent(elem_moras: List[int], last_surface: str) -> int:
    """Accent type for a multi-element compound noun (the standard compound
    rule): nucleus on the first mora of the final element when it is 3+
    moras, flat (type 0) for 1-2-mora finals, with two exception lists —
    pre-accenting suffixes (力, 者: nucleus on the stem's last mora) and
    self-accenting 2-mora suffixes (学)."""
    if len(elem_moras) < 2:
        return 0
    total = sum(elem_moras)
    final = elem_moras[-1]
    last_ch = last_surface[-1] if last_surface else ""
    if last_ch in _PREACCENT_SUFFIX:
        return total - final
    if final >= 3 or last_ch in _SELFACCENT_SUFFIX:
        return total - final + 1
    return 0


def _onset_voiceless(mora: str) -> bool:
    return mora[0] in "kstphf" or mora.startswith(("ch", "sh", "ts"))


def _devoice(moras: List[str], accent: int) -> List[str]:
    """Open JTalk's devoiced high vowels: i/u in a voiceless-onset mora become
    I/U when the next onset is voiceless too, or phrase-finally in su/shi
    after a preceding mora (です/ます pattern). The accent-nucleus mora keeps
    its voicing."""
    out = list(moras)
    n = len(out)
    for j, m in enumerate(out):
        if not m or m[-1] not in "iu" or not _onset_voiceless(m):
            continue
        if j + 1 == accent:  # 1-based nucleus position
            continue
        if j + 1 < n and _onset_voiceless(out[j + 1]):
            out[j] = m[:-1] + m[-1].upper()
        elif j + 1 == n and j > 0 and m in ("su", "shi"):
            out[j] = m[:-1] + m[-1].upper()
    return out


def _segment(sentence: str) -> List[Tuple[List[str], int]]:
    """Japanese span -> accent phrases [(moras, accent_type)].

    Greedy longest-match over the word dictionary; particles attach to the
    preceding phrase; unmatched kana become their own phrase (accent 0).

    Kanji not covered by the word dictionary are resolved by the per-kanji
    fallback table with on/kun selection: a maximal run of consecutive
    kanji (plus any all-kanji dictionary words it abuts) is read as ONE
    Sino compound — per-kanji *compound* (on) readings, regular sokuon /
    h->p sandhi (_join_on_readings), one accent phrase with the compound
    accent rule (_compound_accent). An isolated single kanji keeps its
    isolated (kun) reading. A single unmatched kanji directly after an
    all-kanji word attaches to it as a suffix (研究 + 所). The reference
    gets all of this from Open JTalk's morphological dictionary
    (reference text/japanese.py:84)."""
    words, kanji = _load_dicts()
    phrases: List[Tuple[List[str], int]] = []
    skipped: List[str] = []
    i = 0
    n = len(sentence)
    current: List[str] = []  # moras of the phrase being built
    current_accent = 0
    has_head = False  # current phrase has a content word
    # (surface, kana_reading) elements while the phrase is still a pure
    # Sino-compound chain and can take suffix kanji; None otherwise
    comp_elems: Optional[List[Tuple[str, str]]] = None

    def flush():
        nonlocal current, current_accent, has_head, comp_elems
        if current:
            phrases.append((current, current_accent))
        current, current_accent, has_head = [], 0, False
        comp_elems = None

    def match_word(pos: int, allow_kana: bool) -> Optional[str]:
        """Longest dictionary word at pos. Kana-only words match only at a
        phrase start (allow_kana): with no morphology there is no evidence
        for a word boundary inside a running kana span, and greedy matches
        there split morphemes (がっこう must not break at こう)."""
        for l in range(min(_max_word_len, n - pos), 0, -1):
            cand = sentence[pos : pos + l]
            if cand in words and (allow_kana or any(_is_kanji(c) for c in cand)):
                return cand
        return None

    def set_compound(elements: List[Tuple[str, str]]):
        """Install a Sino-compound phrase from (surface, reading) elements.
        Single-kanji elements are re-read with their *compound* (on) reading
        — a stem that entered as an isolated word (体 -> からだ) must flip
        to its on reading once a compound forms (体力 -> たいりょく) — with
        variant selection (bindings + position) via _select_on_variants."""
        nonlocal current, current_accent, has_head, comp_elems
        surfaces = [s for s, _ in elements]
        selected = _select_on_variants(surfaces, [r for _, r in elements], kanji)
        elements = list(zip(surfaces, selected))
        readings = _join_on_readings(selected, surfaces)
        per_elem = [kana_to_moras(r) for r in readings]
        current = [m for ms in per_elem for m in ms]
        current_accent = _compound_accent(
            [len(ms) for ms in per_elem], elements[-1][0]
        )
        has_head = True
        comp_elems = elements

    while i < n:
        # particle attachment: after a content word or an ongoing kana run
        if has_head or current:
            matched_particle = None
            for p in _PARTICLES:
                if sentence.startswith(p, i):
                    # not a particle if a (kanji-bearing) word starts here
                    longest_word = match_word(i, allow_kana=False)
                    if longest_word is None or len(longest_word) <= len(p):
                        matched_particle = p
                    break
            if matched_particle:
                reading = "".join(
                    _PARTICLE_READING.get(c, c) for c in matched_particle
                )
                # polite auxiliaries carry their own nucleus regardless of
                # the stem's accent (きま↓した, ませ↓ん, でしょ↓う —
                # Open JTalk derives this from the aux's accent entry);
                # only fires when the conjugated form was not already a
                # dictionary row with its accent baked in
                if matched_particle in _AUX_ACCENT and current:
                    current_accent = len(current) + _AUX_ACCENT[matched_particle]
                current.extend(kana_to_moras(reading))
                comp_elems = None
                i += len(matched_particle)
                continue
        # longest dictionary word — but a single-kanji word does not win
        # when a Sino compound is forming around it (an active all-kanji
        # stem before it, or more kanji after it): 体力 must not split as
        # からだ+りょく, 研究|所 must not read 所 as ところ.
        # Kana-only words normally match only at a phrase start, but a
        # FRESH katakana run mid-phrase is strong word-boundary evidence
        # (a loanword after a particle: コンビニで|アイスクリーム) — let it
        # match so the loanword keeps its dictionary accent.
        kat_start = (0x30A1 <= ord(sentence[i]) <= 0x30FF) and (
            i == 0 or not (0x30A1 <= ord(sentence[i - 1]) <= 0x30FF)
        )
        matched = match_word(i, allow_kana=(not current) or kat_start)
        if matched and len(matched) == 1 and _is_kanji(matched):
            if (comp_elems and current) or (
                i + 1 < n and _is_kanji(sentence[i + 1])
            ):
                matched = None
        if matched:
            flush()
            reading, accent = words[matched]
            current = kana_to_moras(reading)
            current_accent = accent
            has_head = True
            if all(_is_kanji(c) for c in matched):
                comp_elems = [(matched, reading)]
            i += len(matched)
            continue
        ch = sentence[i]
        if _is_kana(ch):
            # raw kana: continue the current phrase (verb endings, okurigana)
            comp_elems = None
            if ch == _CHOUON or _kata_to_hira(ch) == _CHOUON:
                # long-vowel mark needs the previous mora's vowel
                prev = current[-1] if current else ""
                if prev and prev[-1] in "aiueo":
                    current.append(prev[-1])
                i += 1
                continue
            two = _kata_to_hira(sentence[i : i + 2])
            if two in _KANA_MAP:
                current.extend(kana_to_moras(two))
                i += 2
            else:
                current.extend(kana_to_moras(ch))
                i += 1
            continue
        if _is_kanji(ch):
            # collect the maximal compound chain: unmatched kanji plus any
            # all-kanji dictionary words directly abutting them
            items: List[Tuple[str, str, str]] = []  # (surface, iso, comp)
            j = i
            while j < n and _is_kanji(sentence[j]):
                w = match_word(j, allow_kana=False)
                if w is not None and len(w) >= 2:
                    if all(_is_kanji(c) for c in w):
                        wr = words[w][0]
                        items.append((w, wr, wr))
                        j += len(w)
                        continue
                    break  # mixed kanji+kana word: main loop handles it
                cj = sentence[j]
                rd = kanji.get(cj)
                if rd is None and cj in words:
                    # single-kanji word absent from the kanji table
                    wr = words[cj][0]
                    rd = (wr, [wr], None)
                if rd is None and cj == "々" and j > i:
                    prev_surf = items[-1][0][-1] if items else ""
                    rd = kanji.get(prev_surf)
                if rd is None and cj == "々" and j == i and i > 0:
                    rd = kanji.get(sentence[i - 1])
                if rd is None:
                    skipped.append(cj)
                else:
                    items.append((cj, rd[0], rd[1][0]))
                j += 1
                # a consumed word ends the chain only if what follows is
                # not kanji — the loop condition handles that
            if not items:
                i = j if j > i else i + 1
                continue
            if (len(items) == 1 and comp_elems and current
                    and items[0][0] in _HONORIFIC_SUFFIX):
                # honorific after a name: 田中様 = たなかさま, never the
                # on-compound reading よう; keeps the name's accent phrase
                current.extend(kana_to_moras(_HONORIFIC_SUFFIX[items[0][0]]))
                comp_elems = None
                i = j
                continue
            if len(items) == 1 and comp_elems and current:
                # suffix kanji/word after an all-kanji word: 研究 + 所
                set_compound(comp_elems + [(items[0][0], items[0][2])])
            elif len(items) == 1:
                # isolated kanji: isolated (kun) reading, own phrase;
                # trim the okurigana echo against the upcoming kana run
                flush()
                reading = items[0][1]
                k = j
                while k < n and k - j < 4 and 0x3041 <= ord(sentence[k]) <= 0x309F:
                    k += 1
                if k > j:
                    base = reading
                    stem = _load_stems().get(items[0][0])
                    if stem is not None and sentence[j] in stem[1]:
                        base = stem[0]
                    reading = _trim_okurigana(base, sentence[j:k])
                current = kana_to_moras(reading)
                current_accent = 0
                has_head = True
                comp_elems = [(items[0][0], items[0][1])]
            else:
                # multi-element Sino compound: compound (on) readings
                elements = [(s, c) for s, _, c in items]
                if comp_elems and current:
                    elements = comp_elems + elements
                else:
                    flush()
                set_compound(elements)
            i = j
            continue
        i += 1  # ascii/digits inside a span: handled upstream, skip here
    flush()
    if skipped:
        warnings.warn(
            f"unknown kanji skipped (not in vendored tables): {''.join(skipped)}",
            stacklevel=3,
        )
    return phrases


def _assemble_with_accent(phrases: List[Tuple[List[str], int]]) -> str:
    """Moras + accent types -> romaji string with the reference's arrows
    (reference japanese.py:95-112: '↓' after the nucleus mora, elif '↑'
    after mora 1, ' ' between accent phrases)."""
    parts: List[str] = []
    for moras, accent in phrases:
        if not moras:
            continue
        moras = _devoice(moras, accent)
        s = ""
        n = len(moras)
        for j, m in enumerate(moras, start=1):
            s += m
            if j < n:
                if j == accent:
                    s += "↓"
                elif j == 1:
                    s += "↑"
        parts.append(s)
    return " ".join(parts)


def kana_to_romaji(text: str) -> str:
    """Kana span -> Open-JTalk-style romaji with ʧ/ʃ/Q substitutions applied
    (no accent arrows — the flat-assembly helper kept for compatibility)."""
    romaji = "".join(kana_to_moras(text))
    return romaji.replace("ch", "ʧ").replace("sh", "ʃ").replace("cl", "Q")


def symbols_to_japanese(text: str) -> str:
    for regex, replacement in _symbols_to_japanese:
        text = re.sub(regex, replacement, text)
    return text


def japanese_to_romaji_with_accent(text: str) -> str:
    """Text (kanji + kana) -> romaji with pitch-accent arrows
    (reference: text/japanese.py:74-112)."""
    from stabletts_torch.text.english import asciify
    from stabletts_torch.text.numbers_ja import verbalize_numbers

    text = verbalize_numbers(text)  # 2024年 -> にせんにじゅうよねん
    text = symbols_to_japanese(text)
    sentences = re.split(_japanese_marks, text)
    marks = re.findall(_japanese_marks, text)
    out = ""
    for i, sentence in enumerate(sentences):
        if sentence:
            assembled = _assemble_with_accent(_segment(sentence))
            if assembled:
                if out:
                    out += " "
                out += assembled.replace("ch", "ʧ").replace("sh", "ʃ").replace("cl", "Q")
        if i < len(marks):
            out += asciify(marks[i]).replace(" ", "")
    return out


def get_real_sokuon(text: str) -> str:
    for regex, replacement in _real_sokuon:
        text = re.sub(regex, replacement, text)
    return text


def get_real_hatsuon(text: str) -> str:
    for regex, replacement in _real_hatsuon:
        text = re.sub(regex, replacement, text)
    return text


def japanese_to_ipa2(text: str) -> List[str]:
    """(reference: text/japanese.py:138-144)."""
    text = japanese_to_romaji_with_accent(text).replace("...", "…")
    text = get_real_sokuon(text)
    text = get_real_hatsuon(text)
    for regex, replacement in _romaji_to_ipa2:
        text = re.sub(regex, replacement, text)
    return list(text)
