"""Phoneme symbol table — 401 symbols, IDs must match the reference exactly
for checkpoint compatibility (reference: text/symbols.py:54-79).

Layout: [pad] + 8 punctuation + 60 IPA chars + 330 CNM3 tone-numbered phones
(66 bases x tones 1-5) + ['<sil>', '<asp>'].
"""

PAD = "_"
PUNCTUATION = ",.!?-~…'"
IPA_LETTERS = "NQabdefghijklmnopstuvwxyzɑæʃʑçɯɪɔɛɹðəɫɥɸʊɾʒθβŋɦ⁼ʰ`^#*=ˈˌ→↓↑ "

# CNM3 phone bases in reference order; each expands to 5 tone-suffixed symbols.
_CNM3_BASES = [
    "y", "n", "p", "x", "k", "l", "q", "w", "E", "b", "c", "z", "e", "f", "s",
    "j", "o", "i", "d", "m", "t", "h", "g", "v", "r", "a", "u",
    "I0", "i0", "uo", "o0", "U0", "v0", "er", "A0", "ai", "e0", "sh", "an",
    "ou", "ch", "a0", "N0", "ao", "ve", "ir", "ng", "ua", "zh", "O0", "ie",
    "E0", "ia", "iE0", "ang", "ng0", "io0", "iA0", "uA0", "ong", "oo0", "uE0",
    "vE0", "ue0", "ua0", "iO0",
]
CNM3_LETTERS = [f"{base}{tone}" for base in _CNM3_BASES for tone in range(1, 6)]
ADDITIONAL = ["<sil>", "<asp>"]

symbols = [PAD] + list(PUNCTUATION) + list(IPA_LETTERS) + CNM3_LETTERS + ADDITIONAL

SPACE_ID = symbols.index(" ")

_symbol_to_id = {s: i for i, s in enumerate(symbols)}
_id_to_symbol = {i: s for i, s in enumerate(symbols)}
