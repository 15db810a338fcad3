"""Japanese number verbalization: arabic numerals (+ counters) -> kana.

The reference inherits digit reading from Open JTalk's text-normalization
frontend (reference: text/japanese.py:74-112 via pyopenjtalk); this module
reproduces the same behavior rule-based: positional readings with the
standard euphonic changes (300 さんびゃく, 600 ろっぴゃく, 8000 はっせん),
counter-specific sound changes (1分 いっぷん, 3本 さんぼん, 10匹 じゅっぴき),
and the irregular native-number series for dates (1日 ついたち, 20日 はつか),
people (1人 ひとり), the つ counter (3つ みっつ), and 20歳 はたち.
"""

from __future__ import annotations

import re

_DIGITS = ["", "いち", "に", "さん", "よん", "ご", "ろく", "なな", "はち", "きゅう"]

# (multiplier reading, per-digit overrides)
_TENS = ("じゅう", {})
_HUNDREDS = ("ひゃく", {3: "さんびゃく", 6: "ろっぴゃく", 8: "はっぴゃく"})
_THOUSANDS = ("せん", {3: "さんぜん", 8: "はっせん"})
_MYRIADS = ["", "まん", "おく", "ちょう", "けい"]


def _under_10000(n: int, sen_needs_ichi: bool = False) -> str:
    """1..9999 -> kana. sen_needs_ichi: 1000 reads いっせん (true inside
    higher myriad groups: 1000万 = いっせんまん) vs bare せん."""
    out = []
    th, rem = divmod(n, 1000)
    if th:
        if th == 1:
            out.append("いっせん" if sen_needs_ichi else "せん")
        else:
            out.append(_THOUSANDS[1].get(th, _DIGITS[th] + _THOUSANDS[0]))
    h, rem = divmod(rem, 100)
    if h:
        out.append(_HUNDREDS[1].get(h, (_DIGITS[h] if h > 1 else "") + _HUNDREDS[0]))
    t, ones = divmod(rem, 10)
    if t:
        out.append((_DIGITS[t] if t > 1 else "") + _TENS[0])
    if ones:
        out.append(_DIGITS[ones])
    return "".join(out)


def number_to_kana(n) -> str:
    """Integer (int or digit string, commas allowed) -> kana reading."""
    s = str(n).replace(",", "")
    neg = s.startswith("-")
    if neg:
        s = s[1:]
    s = s.lstrip("0") or "0"
    if s == "0":
        return "マイナスゼロ" if neg else "ゼロ"
    val = int(s)
    groups = []
    idx = 0
    while val > 0 and idx < len(_MYRIADS):
        val, g = divmod(val, 10000)
        if g:
            groups.append(_under_10000(g, sen_needs_ichi=idx > 0) + _MYRIADS[idx])
        idx += 1
    out = "".join(reversed(groups))
    return ("マイナス" if neg else "") + out


# --- counters ---------------------------------------------------------------
# counter kana + sound-change table: {final-step value: full reading of the
# (final digit + counter) unit}. The prefix (tens/hundreds/...) keeps its
# normal reading; the table applies to the LAST digit (and 10 when the
# number ends in exactly 10: 10分 じゅっぷん but 13分 じゅうさんぷん).

_COUNTERS = {
    "年": {"base": "ねん", 4: "よねん"},
    "時": {"base": "じ", 4: "よじ", 7: "しちじ", 9: "くじ"},
    "分": {"base": "ふん", 1: "いっぷん", 3: "さんぷん", 4: "よんぷん",
           6: "ろっぷん", 8: "はっぷん", 10: "じゅっぷん"},
    "秒": {"base": "びょう"},
    "円": {"base": "えん", 4: "よえん"},
    "人": {"base": "にん", 1: "ひとり", 2: "ふたり", 4: "よにん"},
    "個": {"base": "こ", 1: "いっこ", 6: "ろっこ", 8: "はっこ", 10: "じゅっこ"},
    "本": {"base": "ほん", 1: "いっぽん", 3: "さんぼん", 6: "ろっぽん",
           8: "はっぽん", 10: "じゅっぽん"},
    "匹": {"base": "ひき", 1: "いっぴき", 3: "さんびき", 6: "ろっぴき",
           8: "はっぴき", 10: "じゅっぴき"},
    "杯": {"base": "はい", 1: "いっぱい", 3: "さんばい", 6: "ろっぱい",
           8: "はっぱい", 10: "じゅっぱい"},
    "歳": {"base": "さい", 1: "いっさい", 8: "はっさい", 10: "じゅっさい"},
    "才": {"base": "さい", 1: "いっさい", 8: "はっさい", 10: "じゅっさい"},
    "回": {"base": "かい", 1: "いっかい", 6: "ろっかい", 8: "はっかい",
           10: "じゅっかい"},
    "階": {"base": "かい", 1: "いっかい", 3: "さんがい", 6: "ろっかい",
           8: "はっかい", 10: "じゅっかい"},
    "冊": {"base": "さつ", 1: "いっさつ", 8: "はっさつ", 10: "じゅっさつ"},
    "枚": {"base": "まい"},
    "台": {"base": "だい"},
    "度": {"base": "ど"},
    "番": {"base": "ばん"},
    "号": {"base": "ごう"},
    "名": {"base": "めい"},
    "件": {"base": "けん", 1: "いっけん", 6: "ろっけん", 8: "はっけん",
           10: "じゅっけん"},
    "軒": {"base": "けん", 1: "いっけん", 3: "さんげん", 6: "ろっけん",
           8: "はっけん", 10: "じゅっけん"},
    "頭": {"base": "とう", 1: "いっとう", 8: "はっとう", 10: "じゅっとう"},
    "羽": {"base": "わ", 3: "さんば", 6: "ろっぱ", 10: "じゅっぱ"},
    "歩": {"base": "ほ", 1: "いっぽ", 3: "さんぽ", 6: "ろっぽ", 8: "はっぽ",
           10: "じゅっぽ"},
    "泊": {"base": "はく", 1: "いっぱく", 3: "さんぱく", 6: "ろっぱく",
           8: "はっぱく", 10: "じゅっぱく"},
    "倍": {"base": "ばい"},
    "割": {"base": "わり"},
    "畳": {"base": "じょう", 1: "いちじょう", 8: "はちじょう", 10: "じゅうじょう"},
    "票": {"base": "ひょう", 1: "いっぴょう", 3: "さんびょう",
           6: "ろっぴょう", 8: "はっぴょう", 10: "じゅっぴょう"},
    "点": {"base": "てん", 1: "いってん", 8: "はってん", 10: "じゅってん"},
    # multi-char duration counters (matched by alternation, not char class)
    "時間": {"base": "じかん", 4: "よじかん", 9: "くじかん"},
    "週間": {"base": "しゅうかん", 1: "いっしゅうかん", 8: "はっしゅうかん",
             10: "じゅっしゅうかん"},
    "年間": {"base": "ねんかん", 4: "よねんかん"},
    "か月": {"base": "かげつ", 1: "いっかげつ", 6: "ろっかげつ",
             10: "じゅっかげつ"},
    "ヶ月": {"base": "かげつ", 1: "いっかげつ", 6: "ろっかげつ",
             10: "じゅっかげつ"},
    "カ月": {"base": "かげつ", 1: "いっかげつ", 6: "ろっかげつ",
             10: "じゅっかげつ"},
    "か所": {"base": "かしょ", 1: "いっかしょ", 6: "ろっかしょ",
             8: "はっかしょ", 10: "じゅっかしょ"},
    "ヶ所": {"base": "かしょ", 1: "いっかしょ", 6: "ろっかしょ",
             8: "はっかしょ", 10: "じゅっかしょ"},
    "箇所": {"base": "かしょ", 1: "いっかしょ", 6: "ろっかしょ",
             8: "はっかしょ", 10: "じゅっかしょ"},
}

_MONTH = {1: "いちがつ", 2: "にがつ", 3: "さんがつ", 4: "しがつ", 5: "ごがつ",
          6: "ろくがつ", 7: "しちがつ", 8: "はちがつ", 9: "くがつ",
          10: "じゅうがつ", 11: "じゅういちがつ", 12: "じゅうにがつ"}

_DAY = {1: "ついたち", 2: "ふつか", 3: "みっか", 4: "よっか", 5: "いつか",
        6: "むいか", 7: "なのか", 8: "ようか", 9: "ここのか", 10: "とおか",
        14: "じゅうよっか", 20: "はつか", 24: "にじゅうよっか"}

_TSU = {1: "ひとつ", 2: "ふたつ", 3: "みっつ", 4: "よっつ", 5: "いつつ",
        6: "むっつ", 7: "ななつ", 8: "やっつ", 9: "ここのつ", 10: "とお"}


def _with_counter(num_str: str, counter: str) -> str:
    n = int(num_str.replace(",", "") or "0")
    if counter == "月" and 1 <= n <= 12:
        return _MONTH[n]
    if counter == "日":
        if n in _DAY:
            return _DAY[n]
        return number_to_kana(n) + "にち"
    if counter == "つ" and 1 <= n <= 10:
        return _TSU[n]
    if counter == "日間":  # native day readings + かん: 3日間 みっかかん,
        # but 1日間 いちにちかん (ついたち is the date, not the duration)
        if n == 1:
            return "いちにちかん"
        return _with_counter(num_str, "日") + "かん"
    if counter == "歳" and n == 20:
        return "はたち"
    table = _COUNTERS.get(counter)
    if table is None:
        return number_to_kana(n) + counter  # unknown counter: leave kanji
    base = table["base"]
    if n in table:  # whole-number special (1分 いっぷん, 1人 ひとり, ...)
        return table[n]
    # euphony applies to the final spoken unit: numbers ending in a bare
    # じゅう (10, 20, ..., x10 but not x00) use the 10-entry
    # (20分 = に + じゅっぷん); otherwise the final digit's entry
    # (21分 = にじゅう + いっぷん)
    if n % 10 == 0 and n % 100 != 0 and 10 in table:
        # strip the final じゅう and attach the euphonic 10-form:
        # 30分 さん+じゅっぷん, 110分 ひゃく+じゅっぷん. Every such
        # reading currently ends じゅう; fall through to the generic
        # path if a future number_to_kana form does not (no bare assert
        # in the synthesis path — it would vanish under python -O).
        head = number_to_kana(n)
        if head.endswith("じゅう"):
            return head[: -len("じゅう")] + table[10]
    last = n % 10
    if last and last in table and (counter, last) not in _SUPPLETIVE:
        return number_to_kana(n - last) + table[last]
    return number_to_kana(n) + base


_FULLWIDTH = str.maketrans("０１２３４５６７８９．，", "0123456789.,")

_NUM_COUNTER_RE = re.compile(
    r"(\d[\d,]*)(?:(\.\d+))?([万億兆]?)"
    r"(時間|週間|年間|[かヶカ]月|[かヶ]所|箇所|日間|"
    r"[年月日時分秒円人個本匹杯歳才回階冊枚台度番号名件軒頭羽歩泊倍点割票畳つ]?)"
)

_MAGNITUDE = {"万": 10000, "億": 10 ** 8, "兆": 10 ** 12}

# whole-word suppletive counter forms that never combine with a higher
# decade: 1人 ひとり / 2人 ふたり, but 31人 さんじゅういちにん (NOT
# さんじゅうひとり). Euphonic variants (4人 よにん, 9時 くじ) still do.
_SUPPLETIVE = {("人", 1), ("人", 2)}


_HIRA_TO_KATA = {i: i + 0x60 for i in range(0x3041, 0x3097)}


def _katakana(s: str) -> str:
    """Readings are emitted in KATAKANA so the segmenter's particle
    attachment cannot reinterpret a は inside a number reading as the
    topic particle わ (はちがつ would otherwise become わちがつ)."""
    return s.translate(_HIRA_TO_KATA)


# kanji numerals followed by a counter read as numbers (朝八時 -> 朝8時 ->
# あさはちじ; 百年前 -> 100年前 -> ひゃくねんまえ). Converting BEFORE
# segmentation also breaks the kanji run, so the surrounding kanji keep
# their native readings instead of being swept into a Sino compound.
_KANJI_DIGITS = {"〇": 0, "一": 1, "二": 2, "三": 3, "四": 4,
                 "五": 5, "六": 6, "七": 7, "八": 8, "九": 9}
_KANJI_UNITS = {"十": 10, "百": 100, "千": 1000}
_KANJI_NUM_RE = re.compile(
    r"([〇一二三四五六七八九十百千]+[万億兆]?)"
    r"(?=[年月日時分秒円人個本匹杯歳才回階冊枚台度番号名件軒頭羽歩泊倍点割票畳つ週かヶカ箇])"
)
# lexicalized readings that are NOT digit+counter (十分 じゅうぶん "enough",
# 一日 いちにち "one day/all day" — the counter table would read ついたち)
_KANJI_NUM_EXCEPTIONS = {"十分", "一日"}


def _parse_kanji_numeral(s: str) -> int:
    total, section, current = 0, 0, 0
    for ch in s:
        if ch in _KANJI_DIGITS:
            current = current * 10 + _KANJI_DIGITS[ch]
        elif ch in _KANJI_UNITS:
            section += (current or 1) * _KANJI_UNITS[ch]
            current = 0
        else:  # 万/億/兆
            total += (section + current or 1) * _MAGNITUDE[ch]
            section = current = 0
    return total + section + current


_PROTECTED_CACHE = None


def _protected_words():
    """ja_words entries (len >= 3) containing a kanji numeral — idioms like
    十人十色 / 百発百中 whose numerals are lexical, not counts; the word
    dictionary must see them intact."""
    global _PROTECTED_CACHE
    if _PROTECTED_CACHE is None:
        from stabletts_torch.text.japanese import _load_dicts

        digits = set("〇一二三四五六七八九十百千万億兆")
        words, _ = _load_dicts()
        _PROTECTED_CACHE = sorted(
            w for w in words if len(w) >= 3 and any(c in digits for c in w)
        )
    return _PROTECTED_CACHE


def _kanji_numerals_to_arabic(text: str) -> str:
    def repl(m: re.Match) -> str:
        end = m.end()
        span = text[m.start():end + 1]
        if span in _KANJI_NUM_EXCEPTIONS:
            # ...except in a date context: 〜月一日 is the first of the
            # month (ついたち via the _DAY table), not いちにち
            if not (span == "一日" and m.start() > 0
                    and text[m.start() - 1] == "月"):
                return m.group(0)
        # containment requires start k in [end-len(w), m.start()]; test
        # those positions directly (str.find's first hit in the window can
        # miss a later containing occurrence when the word repeats nearby)
        for w in _protected_words():
            for k in range(max(0, end - len(w)), m.start() + 1):
                if text.startswith(w, k):
                    return m.group(0)
        return str(_parse_kanji_numeral(m.group(1)))

    return _KANJI_NUM_RE.sub(repl, text)


def verbalize_numbers(text: str) -> str:
    """Replace arabic-numeral (+ optional 万/億/兆 magnitude + counter)
    spans in Japanese text with their KATAKANA readings. Full-width digits
    are normalized first; kanji numerals followed by a counter are
    converted to arabic so the same counter reader (and its sound
    changes) applies."""
    text = text.translate(_FULLWIDTH)
    # currency sigils become trailing counter words ($19.99 -> 19.99ドル)
    # so the number reader handles them like any other counter
    for sigil, unit in (("$", "ドル"), ("€", "ユーロ"), ("£", "ポンド"),
                        ("¥", "円"), ("￥", "円")):
        text = re.sub(re.escape(sigil) + r"([0-9][0-9.,]*)",
                      r"\1" + unit, text)
    text = _kanji_numerals_to_arabic(text)

    def repl(m: re.Match) -> str:
        num, frac, mag, counter = m.groups()
        if mag and not frac:
            num = str(int(num.replace(",", "")) * _MAGNITUDE[mag])
        elif mag and frac:
            # 1.5万 -> いちてんごまん (read the magnitude as a word)
            head = number_to_kana(num)
            tail = "".join(_DIGITS[int(d)] if d != "0" else "ゼロ" for d in frac[1:])
            mag_kana = {"万": "まん", "億": "おく", "兆": "ちょう"}[mag]
            return _katakana(head + "てん" + tail + mag_kana + _counter_reading(counter))
        if frac:
            # decimal: 3.5 -> さんてんご (digit-by-digit after the point);
            # any counter keeps its plain reading (3.5秒 さんてんごびょう)
            head = number_to_kana(num)
            tail = "".join(_DIGITS[int(d)] if d != "0" else "ゼロ" for d in frac[1:])
            return _katakana(head + "てん" + tail + _counter_reading(counter))
        if counter:
            return _katakana(_with_counter(num, counter))
        return _katakana(number_to_kana(num))

    return _NUM_COUNTER_RE.sub(repl, text)


def _counter_reading(counter: str) -> str:
    if not counter:
        return ""
    if counter in _COUNTERS:
        return _COUNTERS[counter]["base"]
    return {"月": "がつ", "日": "にち", "つ": "つ"}.get(counter, counter)
