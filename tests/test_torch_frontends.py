"""The port's Chinese, Japanese and mixed-language frontends against the JAX
package's: the same phoneme ids, exactly, on the sentences of the JAX
package's frontend tests and on seeded random strings; the same language
detection; and chip_smoke.py's pinned Chinese ids equal to both."""

import warnings

import numpy as np
import pytest

from stabletts_torch.text import cleaned_text_to_sequence, intersperse
from stabletts_torch.text.japanese import japanese_to_ipa2
from stabletts_torch.text.mandarin import chinese_to_cnm3
from stabletts_torch.text.router import auto_g2p, detect_language
from test_japanese_sentences import SENTENCES as JA_SENTENCE_PAIRS
from test_preprocess_mixed import MIXED_CORPUS

# tests/test_text_frontend.py and tests/test_completeness.py:73-97, by the g2p they run through
ZH = ["你好，世界！", "我有3个苹果", "我有三个苹果", "25%的学生", "银行", "行走", "行长", "长江", "重庆", "重要",
      "重新", "音乐", "快乐", "大家都好", "我还没吃饭", "他曾说过", "别把钱藏起来", "天气更热了", "我将出发",
      "你只需要休息", "先切菜", "首都的都市", "归还", "西藏", "一只猫", "两只鸟", "你好世界", "你好。",
      "编号2557685903089544876号", "", "中国", "天"]
JA = [s for s, _ in JA_SENTENCE_PAIRS] + ["こんにちは！", "がっこう", "さんぽ", "コーヒー", "コンピュータ",
                                          "番号2557685903089544876です", "私は猫が好きです。", "第１２３回のテスト。"]
AUTO = MIXED_CORPUS + ["hello world", "你好世界", "こんにちは", "你好 world", "I have 5 apples", "Hello.",
                       "今日の会議はZoomで行います。", "你好。こんにちは。", "I bought a 新しい smartphone.",
                       "会議はat 3pm.", "価格は1,500円(税込)です。", "この商品は$19.99で販売中です。",
                       "He paid 50 dollars."]


def _jax_g2p(lang):
    from stabletts_tpu.text.japanese import japanese_to_ipa2 as ja
    from stabletts_tpu.text.mandarin import chinese_to_cnm3 as zh
    from stabletts_tpu.text.router import auto_g2p as auto

    return {"chinese": zh, "japanese": ja, "auto": auto}[lang]


OURS = {"chinese": chinese_to_cnm3, "japanese": japanese_to_ipa2, "auto": auto_g2p}


def _ids(g2p, text, seq, inter):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        phones = g2p(text)
    return phones, inter(seq(phones), 0)


def _assert_same(lang, text):
    from stabletts_tpu.text import cleaned_text_to_sequence as jseq
    from stabletts_tpu.text import intersperse as jinter

    phones, ids = _ids(OURS[lang], text, cleaned_text_to_sequence, intersperse)
    jphones, jids = _ids(_jax_g2p(lang), text, jseq, jinter)
    assert phones == jphones and ids == jids, text


@pytest.mark.parametrize("lang,text", [("chinese", t) for t in ZH] + [("japanese", t) for t in JA]
                         + [("auto", t) for t in AUTO])
def test_phoneme_ids_match_jax(lang, text):
    _assert_same(lang, text)


def _random_text(rng, alphabet, n=40):
    return "".join(chr(c) for c in rng.choice(alphabet, size=rng.integers(1, n)))


# tests/test_frontend_fuzz.py's pools: ascii, CJK, kana, CJK punctuation, emoji
FUZZ_POOL = np.concatenate([np.arange(0x20, 0x7F), np.arange(0x4E00, 0x4E80), np.arange(0x3041, 0x3097),
                            np.arange(0x30A1, 0x30F7), np.asarray([0x3002, 0xFF01, 0xFF1F, 0x2026, 0x201C, 0x201D]),
                            np.arange(0x1F600, 0x1F610)])


@pytest.mark.parametrize("lang", ["chinese", "japanese", "auto"])
def test_phoneme_ids_match_jax_on_random_strings(lang):
    rng = np.random.default_rng({"chinese": 0, "japanese": 1, "auto": 2}[lang])
    for _ in range(40):
        _assert_same(lang, _random_text(rng, FUZZ_POOL))


def test_detect_language_matches_jax():
    from stabletts_tpu.text.router import detect_language as jdetect

    rng = np.random.default_rng(3)
    texts = ZH + JA + AUTO + [_random_text(rng, FUZZ_POOL) for _ in range(40)]
    assert [detect_language(t) for t in texts] == [jdetect(t) for t in texts]
    assert {detect_language(t) for t in ("hello world", "你好世界", "こんにちは")} == {"english", "chinese", "japanese"}


def test_number_readings_match_jax():
    from stabletts_tpu.text.numbers_ja import verbalize_numbers as jverb
    from stabletts_tpu.text.numbers_zh import an2cn as jan2cn

    from stabletts_torch.text.numbers_ja import verbalize_numbers
    from stabletts_torch.text.numbers_zh import an2cn

    for c in ["0", "7", "10", "15", "101", "1010", "10086", "654321", "100000000", "3.14", "0.5", "007",
              "12345678901234567"]:
        assert an2cn(c) == jan2cn(c)
    for t in ["1,500円", "3本", "8時", "2024年1月5日", "100人", "第１２３回", "１０％"]:
        assert verbalize_numbers(t) == jverb(t)


def test_chip_smoke_pinned_chinese_ids():
    """chip_smoke.py's Chinese request starts from ZH_IDS (the machine with
    the card has no jieba): both packages' frontends give those ids."""
    import chip_smoke
    from stabletts_tpu.text import cleaned_text_to_sequence as jseq

    assert cleaned_text_to_sequence(chinese_to_cnm3(chip_smoke.ZH_SENTENCE)) == chip_smoke.ZH_IDS
    assert jseq(_jax_g2p("chinese")(chip_smoke.ZH_SENTENCE)) == chip_smoke.ZH_IDS
    # the ids' symbols give the ids back, as the pinned g2p of chip_smoke.py hands them to the API
    from stabletts_torch.text import symbols

    assert cleaned_text_to_sequence([symbols[i] for i in chip_smoke.ZH_IDS]) == chip_smoke.ZH_IDS


def test_chip_smoke_sentences_need_no_jieba(monkeypatch):
    """The Japanese and mixed requests of chip_smoke.py run without jieba."""
    import sys

    import chip_smoke

    monkeypatch.setitem(sys.modules, "jieba", None)
    assert detect_language(chip_smoke.JA_SENTENCE) == detect_language(chip_smoke.AUTO_SENTENCE) == "japanese"
    assert japanese_to_ipa2(chip_smoke.JA_SENTENCE) and auto_g2p(chip_smoke.AUTO_SENTENCE)
    with pytest.raises(ImportError):
        chinese_to_cnm3(chip_smoke.ZH_SENTENCE)
