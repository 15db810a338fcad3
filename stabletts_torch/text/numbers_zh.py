"""Arabic-numeral -> Chinese-numeral conversion ("low" mode), equivalent in
behavior to the reference's vendored cn2an.an2cn (text/cn2an/an2cn.py) for
the inputs the TTS pipeline produces (\\d+(\\.?\\d+)? matches)."""

from __future__ import annotations

_DIGITS = "零一二三四五六七八九"
_UNITS = ["", "十", "百", "千", "万", "十", "百", "千", "亿", "十", "百", "千", "万", "十", "百", "千"]


def _integer_to_cn(integer: str) -> str:
    integer = str(int(integer))  # strip leading zeros: 007 -> 7
    n = len(integer)
    if n > len(_UNITS):
        # beyond the unit table (>16 digits — ID-number territory, not a
        # quantity): read digit-by-digit instead of crashing mid-synthesis
        return "".join(_DIGITS[int(d)] for d in integer)
    out = ""
    for i, d in enumerate(integer):
        v = int(d)
        pos = n - i - 1
        if v:
            out += _DIGITS[v] + _UNITS[pos]
        else:
            # section markers (万/亿 positions) always emitted for zeros
            if pos % 4 == 0:
                out += _DIGITS[v] + _UNITS[pos]
            if i > 0 and (not out or out[-1] != "零"):
                out += _DIGITS[v]
    out = (
        out.replace("零零", "零").replace("零万", "万").replace("零亿", "亿").replace("亿万", "亿").strip("零")
    )
    if out[:2] == "一十":
        out = out[1:]
    return out or "零"


def _decimal_to_cn(decimal: str) -> str:
    if not decimal:
        return ""
    decimal = decimal[:16]
    return "点" + "".join(_DIGITS[int(d)] for d in decimal)


_CN_DIGIT = {c: i for i, c in enumerate(_DIGITS)}
_CN_DIGIT.update({"两": 2, "壹": 1, "贰": 2, "叁": 3, "肆": 4, "伍": 5, "陆": 6, "柒": 7, "捌": 8, "玖": 9})
_CN_UNIT = {"十": 10, "拾": 10, "百": 100, "佰": 100, "千": 1000, "仟": 1000}
_CN_SECTION = {"万": 10 ** 4, "亿": 10 ** 8}


def cn2an_number(text: str) -> float | int:
    """Chinese numeral -> arabic ('一百二十三' -> 123, '三点一四' -> 3.14).

    Reverse direction of `an2cn`; the reference vendors the cn2an package's
    converter for this (text/cn2an/cn2an.py) though the TTS pipeline itself
    only uses an2cn.
    """
    text = str(text).strip()
    sign = 1
    if text.startswith("负"):
        sign = -1
        text = text[1:]
    if "点" in text:
        int_part, dec_part = text.split("点", 1)
        dec = 0.0
        for i, ch in enumerate(dec_part):
            if ch not in _CN_DIGIT:
                raise ValueError(f"bad decimal digit {ch!r}")
            dec += _CN_DIGIT[ch] / (10 ** (i + 1))
        return sign * (_cn_int(int_part) + dec)
    return sign * _cn_int(text)


def _cn_int(text: str) -> int:
    if not text:
        return 0
    total = 0
    section = 0  # value accumulated below the current 万/亿 marker
    current = 0
    for ch in text:
        if ch in _CN_DIGIT:
            current = _CN_DIGIT[ch]
        elif ch in _CN_UNIT:
            unit = _CN_UNIT[ch]
            section += (current or 1) * unit  # 十 alone = 10
            current = 0
        elif ch in _CN_SECTION:
            mult = _CN_SECTION[ch]
            total = (total + section + current) * mult
            section = 0
            current = 0
        else:
            raise ValueError(f"bad chinese numeral char {ch!r}")
    return total + section + current


def an2cn(text: str) -> str:
    """'123' -> '一百二十三', '3.14' -> '三点一四', '-7' -> '负七'."""
    text = str(text)
    if not text:
        raise ValueError("empty number")
    sign = ""
    if text[0] == "-":
        sign = "负"
        text = text[1:]
    parts = text.split(".")
    if len(parts) == 1:
        return sign + _integer_to_cn(parts[0])
    if len(parts) == 2:
        return sign + _integer_to_cn(parts[0]) + _decimal_to_cn(parts[1])
    raise ValueError(f"bad number format: {text}")
