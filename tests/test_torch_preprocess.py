"""The port's preprocessing (stabletts_torch/data/preprocess.py) and dataset
recipes (stabletts_torch/data/recipes.py) against the JAX package's.

  * `preprocess` over a seeded corpus of WAVs at 44.1 and 22.05 kHz in
    English, Chinese and mixed ("auto") text, in batches that pad to one
    shape: the same JSONL records apart from the mel directory, the same mel
    file names, mels within 2e-4, and the same per-file g2p tolerance;
  * every recipe but `genshin` (it needs openpyxl, which is not installed
    here) on small fake dataset trees: the same lines, and for
    `vctk_parquet` the same extracted files.

Both packages load audio through their native loaders (built from the same
C++), as tests/test_torch_native_audio.py holds them."""

import json
import os

import numpy as np
import pandas as pd
import pytest
from scipy.io import wavfile

from stabletts_torch.data import preprocess as port_pre
from stabletts_torch.data import recipes as port_recipes
from stabletts_tpu.data import preprocess as jax_pre
from stabletts_tpu.data import recipes as jax_recipes
from torch_port_utils import TOL, private_jax_native_lib

CORPORA = {
    "english": ["The quick brown fox jumps over the lazy dog.", "Hello world, this is a test of 42 words."],
    "chinese": ["今天天气很好，我们一起去公园散步吧。", "你好，世界。"],
    "auto": ["Hello 世界, this is mixed text.", "今日はいい天気ですね。"],
}


@pytest.fixture(scope="module", autouse=True)
def private_jax_lib(tmp_path_factory):
    yield from private_jax_native_lib(tmp_path_factory)


def _corpus(root, texts, seed=0) -> str:
    """WAVs (alternately 44.1 and 22.05 kHz, 0.5-1.2 s) and their filelist."""
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    filelist = os.path.join(root, "input.txt")
    with open(filelist, "w", encoding="utf-8") as f:
        for i, text in enumerate(texts):
            sr = (44100, 22050)[i % 2]
            n = int(sr * rng.uniform(0.5, 1.2))
            tt = np.arange(n) / sr
            wav = 0.3 * np.sin(2 * np.pi * rng.uniform(90, 300) * tt) + 0.05 * rng.standard_normal(n)
            path = os.path.join(root, f"utt_{i}.wav")
            wavfile.write(path, sr, (np.clip(wav, -1, 1) * 32767).astype(np.int16))
            f.write(f"{path}|{text}\n")
    return filelist


def _run(pkg, filelist, out, language, batch_size, **kw):
    cfg = pkg.DataConfig(input_filelist_path=filelist, output_filelist_path=os.path.join(out, "fl.jsonl"),
                         mel_output_dir=os.path.join(out, "mels"), language=language, batch_size=batch_size)
    n = pkg.preprocess(cfg, **kw)
    with open(cfg.output_filelist_path, encoding="utf-8") as f:
        records = [json.loads(line) for line in f]
    return n, records, sorted(os.listdir(cfg.mel_output_dir))


def _compare(tmp_path, filelist, language, batch_size):
    jn, jrec, jfiles = _run(jax_pre, filelist, str(tmp_path / "jax"), language, batch_size)
    pn, prec, pfiles = _run(port_pre, filelist, str(tmp_path / "port"), language, batch_size, device="cpu")
    assert pn == jn and pfiles == jfiles and len(prec) == len(jrec)
    for p, j in zip(prec, jrec):
        assert os.path.dirname(p["mel_path"]) == str(tmp_path / "port" / "mels")
        assert {**p, "mel_path": os.path.basename(p["mel_path"])} == {**j, "mel_path": os.path.basename(j["mel_path"])}
    for name in jfiles:
        want, got = np.load(str(tmp_path / "jax" / "mels" / name)), np.load(str(tmp_path / "port" / "mels" / name))
        assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_allclose(got, want, **TOL)
    return prec


@pytest.mark.parametrize("language", list(CORPORA))
def test_preprocess_matches_jax(tmp_path, language):
    texts = CORPORA[language] * 3  # 6 WAVs, 3 at each rate
    filelist = _corpus(str(tmp_path / "corpus"), texts)
    records = _compare(tmp_path, filelist, language, batch_size=4)  # a batch of 4 and one of 2
    assert len(records) == 6 and all(r["phone"] and r["mel_length"] > 0 for r in records)


def test_preprocess_g2p_tolerance_matches_jax(tmp_path, monkeypatch):
    """An utterance whose g2p raises is left out, its mel written and then
    overwritten by the next one's, in both packages."""
    for pkg in (jax_pre, port_pre):
        real = pkg.get_g2p

        def failing(language, real=real):
            g2p = real(language)
            return lambda text: (_ for _ in ()).throw(ValueError("no")) if "fox" in text else g2p(text)

        monkeypatch.setattr(pkg, "get_g2p", failing)
    texts = ["Hello there.", "The fox runs.", "A third line.", "The fox again.", "Last one."]
    filelist = _corpus(str(tmp_path / "corpus"), texts)
    records = _compare(tmp_path, filelist, "english", batch_size=2)
    assert [r["text"] for r in records] == ["Hello there.", "A third line.", "Last one."]


def test_get_g2p_matches_jax():
    for language, texts in CORPORA.items():
        for text in texts:
            assert port_pre.get_g2p(language)(text) == jax_pre.get_g2p(language)(text)
    assert port_pre.get_g2p("japanese")("私は猫が好きです。") == jax_pre.get_g2p("japanese")("私は猫が好きです。")
    for pkg in (port_pre, jax_pre):
        with pytest.raises(ValueError, match="unsupported language"):
            pkg.get_g2p("klingon")
    assert port_pre.DataConfig() == port_pre.DataConfig(**vars(jax_pre.DataConfig()))


def _wav(path, seconds=0.1, sr=16000):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    wavfile.write(path, sr, np.zeros(int(seconds * sr), np.int16))


def _tree_libritts(root):
    for spk, chap, utt, text in [("19", "198", "19_198_000000_000000", "Hello, world."),
                                 ("19", "227", "19_227_000001_000000", "A second one."),
                                 ("26", "495", "26_495_000004_000000", "No transcript.")]:
        base = os.path.join(root, spk, chap, utt)
        _wav(base + ".wav")
        if text != "No transcript.":
            with open(base + ".normalized.txt", "w", encoding="utf-8") as f:
                f.write(f"  {text}\n")
    return (root,)


def _tree_aishell3(root):
    for name in ("SSB00050001.wav", "SSB00050002.wav"):
        _wav(os.path.join(root, name[:7], name))
    txt = os.path.join(root, "content.txt")
    with open(txt, "w", encoding="utf-8") as f:
        f.write("SSB00050001.wav 广 guang3 州 zhou1 女 nv3 大 da4 学 xue2 生 sheng1 iPhone15 发 fa1\n")
        f.write("SSB00050002.wav 我 wo3 们 men5\n")
        f.write("SSB00050003.wav 缺 que1 失 shi1\n")  # no audio file
        f.write("broken\n")
    return root, txt


def _tree_bznsyp(root):
    for name in ("000001", "000002"):
        _wav(os.path.join(root, f"{name}.wav"))
    txt = os.path.join(root, "000001-010000.txt")
    with open(txt, "w", encoding="utf-8") as f:
        f.write("000001\t卡尔普#2陪外孙#1玩滑梯#4。\n\tka2 er2 pu3 pei2 wai4 sun1 wan2 hua2 ti1\n")
        f.write("000002\t假语村言#2别再#1拥抱我#4。\n\tjia2 yu3 cun1 yan2 bie2 zai4 yong1 bao4 wo3\n")
        f.write("000003\t没有音频#4。\n")
    return root, txt


def _tree_hifi_tts(root):
    _wav(os.path.join(root, "audio", "92", "a.flac"))
    _wav(os.path.join(root, "audio", "92", "b.flac"))
    with open(os.path.join(root, "92_manifest_clean_train.json"), "w", encoding="utf-8") as f:
        f.write(json.dumps({"audio_filepath": "audio/92/a.flac", "text_normalized": "First line."}) + "\n")
        f.write("not json\n")
        f.write(json.dumps({"audio_filepath": "audio/92/b.flac", "text_normalized": "Second line."}) + "\n")
        f.write(json.dumps({"audio_filepath": "audio/92/missing.flac", "text_normalized": "Gone."}) + "\n")
    return (root,)


TREES = {"libritts": _tree_libritts, "aishell3": _tree_aishell3, "bznsyp": _tree_bznsyp, "hifi_tts": _tree_hifi_tts}


@pytest.mark.parametrize("recipe", list(TREES))
def test_recipe_matches_jax(tmp_path, recipe):
    args = TREES[recipe](str(tmp_path / "data"))
    want = jax_recipes.RECIPES[recipe](*args, output=str(tmp_path / "jax" / "list.txt"))
    got = port_recipes.RECIPES[recipe](*args, output=str(tmp_path / "port" / "list.txt"))
    assert got == want and len(got) >= 2
    with open(tmp_path / "jax" / "list.txt", encoding="utf-8") as a, open(tmp_path / "port" / "list.txt",
                                                                          encoding="utf-8") as b:
        assert a.read() == b.read()


def test_vctk_parquet_recipe_matches_jax(tmp_path):
    def wav_bytes(sr, seed):
        import io

        buf = io.BytesIO()
        wavfile.write(buf, sr, (np.random.default_rng(seed).standard_normal(800) * 3000).astype(np.int16))
        return buf.getvalue()

    rows = [{"audio": {"bytes": wav_bytes(16000, 0), "path": "p225/p225_001.wav"}, "text": "Please call Stella."},
            {"audio": {"bytes": b"fLaC not decodable", "path": "p225/p225_002.flac"}, "text": "Skipped."},
            {"audio": {"bytes": wav_bytes(22050, 1), "path": "p226/p226_001.wav"}, "text": "Ask her to bring."}]
    os.makedirs(tmp_path / "data" / "shards")
    pd.DataFrame(rows).to_parquet(tmp_path / "data" / "shards" / "train-0.parquet")
    outs = {}
    for name, mod in (("jax", jax_recipes), ("port", port_recipes)):
        lines = mod.vctk_parquet(str(tmp_path / "data"), str(tmp_path / name / "wavs"), str(tmp_path / name / "l.txt"))
        outs[name] = [line.replace(str(tmp_path / name), "<out>") for line in lines]
        assert sorted(os.listdir(tmp_path / name / "wavs")) == ["p225_001.wav", "p226_001.wav"]
    assert outs["port"] == outs["jax"] and len(outs["port"]) == 2
    for f in ("p225_001.wav", "p226_001.wav"):
        assert (tmp_path / "port" / "wavs" / f).read_bytes() == (tmp_path / "jax" / "wavs" / f).read_bytes()
    assert set(port_recipes.RECIPES) == set(jax_recipes.RECIPES)
