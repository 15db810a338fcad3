"""The benchmark's FireflyGAN cell (`serve_ffgan_batch_bf16`, entry
perfbench/entries/synthesise_ffgan.py) found and run by its files alone on
the CPU: the acoustic model at the harness's tiny widths, FireflyGAN at its
published widths over a mel cap of 24 frames. Its `correct` holds a sound
run, and fails an altered waveform and the fp8 control; the traced run
reads the program's vocoder padding share; and a program whose FireflyGAN
takes no `lengths` fails at construction, before any set-up."""

import json
import os
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "perfbench", "tests"))

import pb_helpers  # noqa: E402
from perfbench.lib import core  # noqa: E402

CELL = "serve_ffgan_batch_bf16"
CONFIG = "stabletts-v1.1-ffgan44k-serve"
TINY_TRAFFIC = {"batch": 3, "pool_batches": 2, "text_ids": {"median": 5, "sigma": 0.4, "min": 3, "max": 9},
                "ref_frames": 40}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """pb_helpers.tiny_copy with this cell's traffic cut down, the published
    FireflyGAN section back in its configuration and a cap of 24 frames."""
    root = pb_helpers.tiny_copy(tmp_path_factory.mktemp("ffgan_cell"), {CELL: TINY_TRAFFIC})
    path = os.path.join(root, "perfbench", "configs", f"{CONFIG}.json")
    cfg = json.load(open(path))
    cfg["vocoder"] = core.load_json(os.path.join(REPO, "perfbench", "configs", f"{CONFIG}.json"))["vocoder"]
    cfg["max_mel_len"] = 24
    json.dump(cfg, open(path, "w"))
    return root


def _run(root, trace=False, seed=2700000017, after_check=None):
    run = core.load_module(os.path.join(root, "perfbench", "run.py"), "pb_run_ffgan")
    return run.run(core.Cell(CELL, root), seed, 0.3, trace, "cpu", after_check=after_check)


def test_cell_runs_by_its_files_alone(root):
    res = _run(root)
    assert res["correct"], res["checks"]
    assert set(res["checks"]) == {"duration_gap", "mel_rel_err", "wave_rel_err"}
    assert res["metrics"]["serve_audio_s_per_s"]["value"] > 0 and "setup_s" in res["metrics"]
    work = {}
    res = _run(root, trace=True, seed=2 ** 33 + 5, after_check=lambda driver: work.update(driver.work()))
    got = {k: v["value"] for k, v in res["metrics"].items()}
    assert res["correct"] and 0.0 <= got["vocoder_padding_share.serve"] < 100.0 and got["mfu.serve"] > 0.0
    # the vocoder runs every item at the cap: its padding is the harness's own count's
    want = 100.0 * (1.0 - work["valid_frames"] / work["estimator_frames"])
    assert got["vocoder_padding_share.serve"] == pytest.approx(want, abs=1e-9)


def test_altered_wave_is_not_correct(root, monkeypatch):
    from stabletts_torch.models.ffgan import FireflyGANBase

    orig = FireflyGANBase.forward
    monkeypatch.setattr(FireflyGANBase, "forward", lambda self, mel, lengths=None: orig(self, mel, lengths) * 1.2)
    res = _run(root)
    assert not res["correct"] and res["checks"]["wave_rel_err"]["value"] > res["checks"]["wave_rel_err"]["limit"]


def test_fp8_control_is_not_correct(root):
    from perfbench.reference.stabletts_ref import Precision

    readings = {}

    def read(driver):
        driver.produce_control(Precision("fp8"))
        readings.update(driver.check())

    assert _run(root, after_check=read)["correct"]
    limits = core.Cell(CELL, root).workload["limits"]
    assert readings["wave_rel_err"] > limits["wave_rel_err"], (readings, limits)


def test_a_program_without_lengths_fails_at_construction(root, monkeypatch):
    from stabletts_torch.models.ffgan import FireflyGANBase

    monkeypatch.setattr(FireflyGANBase, "forward", lambda self, mel: mel)
    cell = core.Cell(CELL, root)
    with pytest.raises(RuntimeError, match="lengths"):
        cell.entry_module().Driver(cell, 1, "cpu", cell.traffic_module())
