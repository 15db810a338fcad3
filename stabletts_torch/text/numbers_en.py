"""English number normalization (reference: text/english.py:88-153), with a
built-in number_to_words replacing the unavailable `inflect` package."""

from __future__ import annotations

import re

_ONES = [
    "zero", "one", "two", "three", "four", "five", "six", "seven", "eight",
    "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
    "sixteen", "seventeen", "eighteen", "nineteen",
]
_TENS = [
    "", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
    "eighty", "ninety",
]
_SCALES = [
    (10 ** 18, "quintillion"), (10 ** 15, "quadrillion"),
    (10 ** 12, "trillion"), (10 ** 9, "billion"), (10 ** 6, "million"), (10 ** 3, "thousand"),
]

_ORDINAL_IRREGULAR = {
    "one": "first", "two": "second", "three": "third", "five": "fifth",
    "eight": "eighth", "nine": "ninth", "twelve": "twelfth",
}


def _under_100(n: int) -> str:
    if n < 20:
        return _ONES[n]
    tens, ones = divmod(n, 10)
    return _TENS[tens] + ("-" + _ONES[ones] if ones else "")


def _under_1000(n: int) -> str:
    hundreds, rest = divmod(n, 100)
    parts = []
    if hundreds:
        parts.append(_ONES[hundreds] + " hundred")
    if rest:
        parts.append(_under_100(rest))
    return " ".join(parts)


def number_to_words(n: int, zero: str = "zero", group: int = 0) -> str:
    """Inflect-equivalent for the subset the cleaners use: andword='' always;
    group=2 reads digit pairs ('1999' -> 'nineteen, ninety-nine')."""
    if group == 2:
        s = str(n)
        if len(s) % 2:
            s = "0" + s
        pairs = [s[i : i + 2] for i in range(0, len(s), 2)]
        words = []
        for p in pairs:
            v = int(p)
            if v == 0:
                words.append(zero + " " + zero if zero == "oh" else zero)
            elif p[0] == "0":
                words.append(zero + " " + _ONES[v])
            else:
                words.append(_under_100(v))
        return ", ".join(words)
    if n == 0:
        return zero
    parts = []
    for scale_value, scale_name in _SCALES:
        if n >= scale_value:
            count, n = divmod(n, scale_value)
            # recurse: the top-scale count can itself exceed 999 (e.g. a 22+
            # digit number); _under_1000 alone would IndexError past 2e15-style
            # inputs with counts >= 2000
            parts.append(
                (number_to_words(count) if count >= 1000 else _under_1000(count))
                + " " + scale_name
            )
    if n:
        parts.append(_under_1000(n))
    return ", ".join(parts)


def ordinal_to_words(match_text: str) -> str:
    """'21st' -> 'twenty-first' (inflect.number_to_words on ordinal strings)."""
    n = int(re.sub(r"(st|nd|rd|th)$", "", match_text))
    words = number_to_words(n)
    # convert the last word to ordinal form
    head, sep, last = words.rpartition(" ")
    if "-" in last:
        first_part, _, ones = last.rpartition("-")
        last = first_part + "-" + _ordinalize(ones)
    else:
        last = _ordinalize(last)
    return head + sep + last


def _ordinalize(word: str) -> str:
    if word in _ORDINAL_IRREGULAR:
        return _ORDINAL_IRREGULAR[word]
    if word.endswith("y"):
        return word[:-1] + "ieth"
    return word + "th"


_comma_number_re = re.compile(r"([0-9][0-9\,]+[0-9])")
_decimal_number_re = re.compile(r"([0-9]+\.[0-9]+)")
_pounds_re = re.compile(r"£([0-9\,]*[0-9]+)")
_dollars_re = re.compile(r"\$([0-9\.\,]*[0-9]+)")
_ordinal_re = re.compile(r"[0-9]+(st|nd|rd|th)")
_number_re = re.compile(r"[0-9]+")


def _expand_dollars(m: re.Match) -> str:
    match = m.group(1)
    parts = match.split(".")
    if len(parts) > 2:
        return match + " dollars"
    dollars = int(parts[0]) if parts[0] else 0
    cents = int(parts[1]) if len(parts) > 1 and parts[1] else 0
    if dollars and cents:
        dollar_unit = "dollar" if dollars == 1 else "dollars"
        cent_unit = "cent" if cents == 1 else "cents"
        return f"{dollars} {dollar_unit}, {cents} {cent_unit}"
    if dollars:
        return f"{dollars} {'dollar' if dollars == 1 else 'dollars'}"
    if cents:
        return f"{cents} {'cent' if cents == 1 else 'cents'}"
    return "zero dollars"


def _expand_number(m: re.Match) -> str:
    num = int(m.group(0))
    if 1000 < num < 3000:
        if num == 2000:
            return "two thousand"
        if 2000 < num < 2010:
            return "two thousand " + number_to_words(num % 100)
        if num % 100 == 0:
            return number_to_words(num // 100) + " hundred"
        return number_to_words(num, zero="oh", group=2).replace(", ", " ")
    return number_to_words(num)


# measurement abbreviations after a number read as unit words (the
# reference leaves them to be starred/dropped as OOV: 'kg' would reach the
# model as dead letters). Case-sensitive on purpose: MB != mb context.
_UNITS = {
    "kg": ("kilogram", "kilograms"), "km": ("kilometer", "kilometers"),
    "cm": ("centimeter", "centimeters"), "mm": ("millimeter", "millimeters"),
    "ml": ("milliliter", "milliliters"), "mg": ("milligram", "milligrams"),
    "ms": ("millisecond", "milliseconds"), "ft": ("foot", "feet"),
    "lb": ("pound", "pounds"), "lbs": ("pounds", "pounds"),
    "oz": ("ounce", "ounces"), "mph": ("miles per hour", "miles per hour"),
    "fps": ("frames per second", "frames per second"),
    "kph": ("kilometers per hour", "kilometers per hour"),
    "Hz": ("hertz", "hertz"), "kHz": ("kilohertz", "kilohertz"),
    "MHz": ("megahertz", "megahertz"), "GHz": ("gigahertz", "gigahertz"),
    "KB": ("kilobyte", "kilobytes"), "kB": ("kilobyte", "kilobytes"),
    "MB": ("megabyte", "megabytes"), "GB": ("gigabyte", "gigabytes"),
    "TB": ("terabyte", "terabytes"), "kW": ("kilowatt", "kilowatts"),
    "MW": ("megawatt", "megawatts"),
    "K": ("thousand", "thousand"), "M": ("million", "million"),
    "B": ("billion", "billion"),
}
_units_re = re.compile(
    r"([0-9][0-9.,]*)[  ]*("
    + "|".join(sorted(_UNITS, key=len, reverse=True))
    + r")(?![A-Za-z0-9])"
)


def _expand_units(m: re.Match) -> str:
    num, unit = m.groups()
    sing, plur = _UNITS[unit]
    return num + " " + (sing if num.rstrip(".,") == "1" else plur)


def expand_units(text: str) -> str:
    """Case-sensitive unit expansion. Must run BEFORE the cleaner lowercases
    (english_to_ipa), or MB/GHz/K arrive as unrecognizable 'mb'/'ghz'/'k';
    the lowercase-stable units (kg, ml, ft, ...) are also caught again
    inside normalize_numbers for direct callers."""
    return re.sub(_units_re, _expand_units, text)


_minus_re = re.compile(r"(^|[\s(\[])[-−](?=[0-9])")
_percent_re = re.compile(r"([0-9])\s*%")
_hash_number_re = re.compile(r"#\s*([0-9])")
# ':' guards: a candidate preceded or followed by ':' is part of an
# H:MM:SS form and must be handled whole by _hms_re, never as two
# overlapping H:MM matches that leak a dead ':' token
_time_re = re.compile(r"\b(?<![:\d])([01]?[0-9]|2[0-3]):([0-5][0-9])\b(?!:)")
_hms_re = re.compile(
    r"\b(?<![:\d])([01]?[0-9]|2[0-3]):([0-5][0-9]):([0-5][0-9])\b(?!:)"
)


def _two_digit(g: str) -> str:
    if g[0] == "0":
        return f"oh {g[1]}"
    return g


def _expand_time(m: re.Match) -> str:
    h, mm = m.group(1), m.group(2)
    if mm == "00":
        return f"{h} o'clock"
    return f"{h} {_two_digit(mm)}"


def _expand_hms(m: re.Match) -> str:
    h, mm, ss = m.groups()
    parts = [h, "zero" if mm == "00" else _two_digit(mm)]
    if ss != "00":
        parts.append("and " + (ss if ss[0] != "0" else ss[1]) + " seconds")
    return " ".join(parts)


def normalize_numbers(text: str) -> str:
    """(reference: text/english.py:146-153). % and #N are verbalized here
    even though the reference drops them at sequence time — '% ' and '#'
    are not in the symbol table, so leaving them would silently lose
    'percent' / 'number' from the audio."""
    # currency amounts keep their comma-stripped numeric path
    text = re.sub(r"([$£][0-9]{1,3}(?:,[0-9]{3})+)",
                  lambda m: m.group(1).replace(",", ""), text)
    text = re.sub(_pounds_re, r"\1 pounds", text)
    text = re.sub(_dollars_re, _expand_dollars, text)
    text = re.sub(_units_re, _expand_units, text)
    # a comma-GROUPED number is never a year: read it as a plain cardinal
    # instead of letting _expand_number's 1000..3000 pair-reading fire
    # ('1,540 km' must not read 'fifteen forty'); plain '1540' keeps the
    # reference's year-style reading
    text = re.sub(r"\b[0-9]{1,3}(?:,[0-9]{3})+\b",
                  lambda m: number_to_words(int(m.group(0).replace(",", ""))),
                  text)
    # odd comma groupings just lose their commas (reference behavior)
    text = re.sub(_comma_number_re, lambda m: m.group(1).replace(",", ""), text)
    text = re.sub(_minus_re, r"\1minus ", text)
    text = re.sub(_percent_re, r"\1 percent", text)
    text = re.sub(_hash_number_re, r"number \1", text)
    text = re.sub(_hms_re, _expand_hms, text)
    text = re.sub(_time_re, _expand_time, text)
    for _ in range(3):  # versions chain decimals: 2.0.1 -> two point zero point one
        new = re.sub(_decimal_number_re,
                     lambda m: m.group(1).replace(".", " point "), text)
        if new == text:
            break
        text = new
    text = re.sub(_ordinal_re, lambda m: ordinal_to_words(m.group(0)), text)
    text = re.sub(_number_re, _expand_number, text)
    return text
