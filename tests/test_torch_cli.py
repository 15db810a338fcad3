"""The port's CLI (stabletts_torch/cli.py) and `api.get_vocoder` against the
JAX package's (stabletts_tpu/cli.py, stabletts_tpu/api.py:65-84) on the CPU.

  * every subcommand the port has parses the same flags to the same values
    (the port adds `--device`), and the `train` and `train-vocos` configs
    built from one argv are equal field by field (the trainers are
    monkeypatched in both packages to capture them);
  * `preprocess` and `preprocess-vocos` write the same files;
  * `get_vocoder` gives JAX's waveform within 2e-4 for both vocoders from one
    `.pt` written through `state_dict_from_jax_*`;
  * `train --epochs 1` and then `synth` from the checkpoint it wrote, on
    `--device cpu`.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

import stabletts_torch.train.train_tts as port_train_tts
import stabletts_torch.train.train_vocos as port_train_vocos
import stabletts_tpu.train.train_tts as jax_train_tts
import stabletts_tpu.train.train_vocos as jax_train_vocos
from stabletts_torch import cli as port_cli
from stabletts_torch.api import StableTTSAPI, get_vocoder
from stabletts_tpu import api as jax_api
from stabletts_tpu import cli as jax_cli
from torch_port_utils import TOL, private_jax_native_lib, randomise_tree

torch.set_num_threads(2)

TEXTS = ["Hello world, this is a test.", "The quick brown fox jumps.", "Good morning to you all.",
         "We love speech synthesis."]
# argv of each subcommand: the defaults, then every flag set
ARGVS = {
    "preprocess": [["--input", "in.txt"],
                   ["--input", "in.txt", "--output", "o.json", "--mel-dir", "m", "--language", "japanese"]],
    "train": [[], ["--dataset", "d.json", "--batch-size", "4", "--epochs", "3", "--save-path", "s", "--lr", "2e-4",
                   "--compute-dtype", "bfloat16", "--remat"]],
    "train-vocos": [[], ["--dataset", "wavs", "--batch-size", "2", "--epochs", "5", "--save-path", "v"]],
    "preprocess-vocos": [["--input", "wavs"], ["--input", "wavs", "--output", "l.txt"]],
    "synth": [["--text", "hi", "--ref", "r.wav"],
              ["--text", "hi", "--ref", "r.wav", "--language", "chinese", "--tts-ckpt", "c.pt", "--vocoder-ckpt", "v.pt",
               "--vocoder", "ffgan", "--steps", "4", "--temperature", "0.7", "--length-scale", "1.2", "--solver", "rk4",
               "--cfg", "1.5", "--out", "x.wav"]],
}
COMPUTES = {"preprocess", "train", "train-vocos", "synth"}  # the subcommands that take --device


@pytest.fixture(scope="module", autouse=True)
def private_jax_lib(tmp_path_factory):
    yield from private_jax_native_lib(tmp_path_factory)


def _namespace(cli, monkeypatch, argv) -> dict:
    """The parsed arguments of argv, with the subcommand's function replaced."""
    seen = {}
    for name in dir(cli):
        if name.startswith("cmd_"):
            monkeypatch.setattr(cli, name, lambda args: seen.update(vars(args)))
    cli.main(argv)
    seen.pop("fn")
    return seen


@pytest.mark.parametrize("case", [(cmd, i) for cmd in ARGVS for i in range(2)], ids=lambda c: f"{c[0]}-{c[1]}")
def test_flags_and_defaults_match_jax(monkeypatch, case):
    cmd, i = case
    argv = [cmd, *ARGVS[cmd][i]]
    want = _namespace(jax_cli, monkeypatch, argv)
    got = _namespace(port_cli, monkeypatch, argv)
    assert got.pop("device", "absent") == (None if cmd in COMPUTES else "absent")
    assert got == want
    got = _namespace(port_cli, monkeypatch, [*argv, "--device", "cpu"] if cmd in COMPUTES else argv)
    assert got.get("device", "cpu") == "cpu"


@pytest.mark.parametrize("argv", [["preprocess", "--input", "x", "--language", "auto"],
                                  ["synth", "--text", "a", "--ref", "b", "--vocoder", "hifigan"],
                                  ["train", "--compute-dtype", "float16"], ["convert", "--input", "a", "--output", "b"]])
def test_choices_refused_as_in_jax_and_no_orbax_subcommands(monkeypatch, argv):
    """The same `choices`; `convert` and `export` (orbax <-> .pt) exist only in JAX."""
    if argv[0] != "convert":
        with pytest.raises(SystemExit):
            _namespace(jax_cli, monkeypatch, argv)
    with pytest.raises(SystemExit):
        _namespace(port_cli, monkeypatch, argv)


def _captured_configs(monkeypatch, argv) -> dict:
    """{package: (args, kwargs)} the trainer of argv's subcommand was called with."""
    calls = {}
    for pkg, mod, fn in (("jax", jax_train_tts, "train"), ("port", port_train_tts, "train"),
                         ("jax", jax_train_vocos, "train_vocos"), ("port", port_train_vocos, "train_vocos")):
        monkeypatch.setattr(mod, fn, lambda *a, pkg=pkg, **k: calls.__setitem__(pkg, (a, k)))
    jax_cli.main(argv)
    port_cli.main([*argv, "--device", "cpu"])
    return calls


@pytest.mark.parametrize("i", [0, 1])
def test_train_configs_match_jax(monkeypatch, i):
    calls = _captured_configs(monkeypatch, ["train", *ARGVS["train"][i]])
    (jcfg, jmodel), jkw = calls["jax"]
    (pcfg, pmodel), pkw = calls["port"]
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(pmodel) == dataclasses.asdict(jmodel) and pmodel.remat == (i == 1)
    assert set(jkw) == {"log_fn"} and pkw.keys() == {"log_fn", "device"} and pkw["device"] == "cpu"


@pytest.mark.parametrize("i", [0, 1])
def test_train_vocos_configs_match_jax(monkeypatch, i):
    calls = _captured_configs(monkeypatch, ["train-vocos", *ARGVS["train-vocos"][i]])
    (jcfg,), jkw = calls["jax"]
    (pcfg,), pkw = calls["port"]
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(jcfg)
    assert pkw.pop("device") == "cpu" and pkw.keys() == jkw.keys() == {"num_epochs", "log_fn"}
    assert pkw["num_epochs"] == jkw["num_epochs"] == (5 if i else None)


def _corpus(root) -> str:
    rng = np.random.default_rng(0)
    os.makedirs(os.path.join(root, "wavs"), exist_ok=True)
    filelist = os.path.join(root, "input.txt")
    with open(filelist, "w", encoding="utf-8") as f:
        for i, text in enumerate(TEXTS):
            sr = (44100, 22050)[i % 2]
            n = int(sr * rng.uniform(0.8, 1.2))
            wav = 0.3 * np.sin(2 * np.pi * rng.uniform(100, 300) * np.arange(n) / sr) + 0.02 * rng.standard_normal(n)
            path = os.path.join(root, "wavs", f"u{i}.wav")
            wavfile.write(path, sr, (np.clip(wav, -1, 1) * 32767).astype(np.int16))
            f.write(f"{path}|{text}\n")
    return filelist


def test_preprocess_subcommands_write_what_jax_writes(tmp_path, capsys):
    filelist = _corpus(str(tmp_path))
    for pkg, cli, extra in (("jax", jax_cli, []), ("port", port_cli, ["--device", "cpu"])):
        out = tmp_path / pkg
        cli.main(["preprocess", "--input", filelist, "--output", str(out / "fl.json"), "--mel-dir", str(out / "mels"),
                  "--language", "english", *extra])
        cli.main(["preprocess-vocos", "--input", str(tmp_path / "wavs"), "--output", str(out / "vocos.txt")])
    printed = capsys.readouterr().out.splitlines()
    assert printed[2:] == [line.replace(str(tmp_path / "jax"), str(tmp_path / "port")) for line in printed[:2]]
    assert (tmp_path / "port" / "vocos.txt").read_text() == (tmp_path / "jax" / "vocos.txt").read_text()
    assert len((tmp_path / "port" / "vocos.txt").read_text().splitlines()) == len(TEXTS)
    records = {}
    for pkg in ("jax", "port"):
        with open(tmp_path / pkg / "fl.json", encoding="utf-8") as f:
            records[pkg] = [json.loads(line) for line in f]
    assert len(records["port"]) == len(TEXTS)
    for p, j in zip(records["port"], records["jax"]):
        assert p["mel_path"] == j["mel_path"].replace(str(tmp_path / "jax"), str(tmp_path / "port"))
        assert {**p, "mel_path": None} == {**j, "mel_path": None}
        np.testing.assert_allclose(np.load(p["mel_path"]), np.load(j["mel_path"]), **TOL)


def _jax_vocoder_pt(name, path) -> None:
    """A randomised JAX vocoder at the default config, written as a reference
    .pt through the port's `state_dict_from_jax_*`."""
    from stabletts_torch.utils.convert import state_dict_from_jax_ffgan, state_dict_from_jax_vocos
    from stabletts_tpu.config import MelConfig, VocosConfig
    from stabletts_tpu.models.ffgan import FireflyGANBase
    from stabletts_tpu.models.vocos import Vocos

    model = Vocos(VocosConfig(), MelConfig()) if name == "vocos" else FireflyGANBase()
    params = randomise_tree(model.init(jax.random.PRNGKey(3), jnp.zeros((1, 8, 128)))["params"], seed=11)
    sd = state_dict_from_jax_vocos(params, 8) if name == "vocos" else state_dict_from_jax_ffgan(params)
    torch.save(sd, path)


@pytest.mark.parametrize("name", ["vocos", "ffgan"])
def test_get_vocoder_matches_jax(tmp_path, name):
    path = str(tmp_path / f"{name}.pt")
    _jax_vocoder_pt(name, path)
    jmodel, jvars = jax_api.get_vocoder(path, name)
    ours = get_vocoder(path, name, device="cpu")
    assert type(ours).__name__ == type(jmodel).__name__ and not ours.training
    mel = np.random.default_rng(4).standard_normal((1, 12, 128)).astype(np.float32)
    want = np.asarray(jmodel.apply(jvars, jnp.asarray(mel)))
    with torch.no_grad():
        got = ours(torch.from_numpy(mel)).numpy()
    assert got.shape == want.shape == (1, 12 * 512) and np.abs(want).max() > 1e-3
    assert float(np.abs(got - want).max() / np.abs(want).max()) <= 2e-4
    for get in (jax_api.get_vocoder, lambda p, m: get_vocoder(p, m, device="cpu")):
        with pytest.raises(NotImplementedError, match="hifigan"):
            get(path, "hifigan")


def test_train_then_synth_on_cpu(tmp_path, capsys):
    filelist = _corpus(str(tmp_path))
    fl, ckpt = str(tmp_path / "fl.json"), str(tmp_path / "ckpt")
    port_cli.main(["preprocess", "--input", filelist, "--output", fl, "--mel-dir", str(tmp_path / "mels"),
                   "--language", "english", "--device", "cpu"])
    port_cli.main(["train", "--dataset", fl, "--epochs", "1", "--batch-size", "2", "--save-path", ckpt,
                   "--device", "cpu"])
    assert sorted(os.listdir(ckpt)) == ["checkpoint_0.pt", "optimizer_0.pt"]
    logged = [json.loads(line) for line in capsys.readouterr().out.splitlines() if line.startswith("{")]
    assert logged and logged[0]["step"] == 0 and all(np.isfinite(v) for v in logged[0].values())
    out = str(tmp_path / "out.wav")
    argv = ["synth", "--text", "Hello there.", "--ref", str(tmp_path / "wavs" / "u0.wav"), "--tts-ckpt",
            os.path.join(ckpt, "checkpoint_0.pt"), "--steps", "2", "--out", out, "--device", "cpu"]
    port_cli.main(argv)
    assert "wrote" in capsys.readouterr().out
    sr, wav = wavfile.read(out)
    # the API from the same checkpoint gives the same length (seeded noise, random Vocos without a vocoder path)
    api = StableTTSAPI(os.path.join(ckpt, "checkpoint_0.pt"), None, "vocos", device="cpu")
    want, mel = api.inference("Hello there.", str(tmp_path / "wavs" / "u0.wav"), "english", step=2)
    assert sr == 44100 and wav.dtype == np.int16 and wav.shape == (want.shape[1],) == (mel.shape[2] * 512,)
    assert np.isfinite(want).all() and np.array_equal(wav, (np.clip(want[0], -1, 1) * 32767).astype(np.int16))
