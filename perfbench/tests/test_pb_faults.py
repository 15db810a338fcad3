"""A run with the timed path broken underneath comes out not correct: the
harness's look for a chip is skipped (device "cpu", tiny sizes) and the rest
of a run is driven as it is on the card. The faults a serving cell can have
are an answer altered where it is produced: the waveform (in the vocoder),
the mel (in the sampler) and a duration (in the duration path). And the
control, the reference one precision down in the program's place, fails too.
"""

import os

import pytest

import pb_helpers
from perfbench.lib import core

faults = core.load_module(os.path.join(core.PKG_DIR, "tools", "faults.py"), "pb_faults")

CELLS = ["serve_batch_bf16", "serve_request_f32", "serve_api_batch_f32"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return pb_helpers.tiny_copy(tmp_path_factory.mktemp("faults"), pb_helpers.TINY_TRAFFIC)


def _run(root, cell, seed=17, after_check=None):
    run = core.load_module(os.path.join(root, "perfbench", "run.py"), "pb_run_faults")
    return run.run(core.Cell(cell, root), seed, 0.5, False, "cpu", after_check=after_check)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(root, cell):
    assert _run(root, cell)["correct"]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", sorted(faults.SERVING))
def test_altered_answer_is_not_correct(root, cell, fault, monkeypatch):
    faults.SERVING[fault](monkeypatch.setattr)
    res = _run(root, cell)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell,control", [("serve_batch_bf16", "fp8"), ("serve_request_f32", "tf32"),
                                          ("serve_api_batch_f32", "tf32")])
def test_control_is_not_correct(root, cell, control):
    """The control at a size the CPU holds: on the CPU TF32 does not exist,
    so the float32 cells' control here is bfloat16 operands (one step further
    down); on the card it is TF32 (perfbench/tools/control.py)."""
    from perfbench.reference.stabletts_ref import Precision

    readings = {}

    def read(driver):
        driver.produce_control(Precision("fp8" if control == "fp8" else "bf16"))
        readings.update(driver.check())

    res = _run(root, cell, after_check=read)
    limits = core.Cell(cell, root).workload["limits"]
    assert any(readings[k] > v for k, v in limits.items()), (readings, limits)
    assert res["correct"]


def test_sound_training_run_is_correct(root):
    assert _run(root, "train_f32_b32")["correct"]


@pytest.mark.parametrize("fault", sorted(faults.TRAINING))
def test_training_fault_is_not_correct(root, fault, monkeypatch):
    faults.TRAINING[fault](monkeypatch.setattr)
    res = _run(root, "train_f32_b32")
    assert not res["correct"], res["checks"]


def test_training_control_is_not_correct(root):
    """The float32 training cell's control at a CPU size: bfloat16 operands
    (TF32 exists on the card only)."""
    from perfbench.reference.stabletts_ref import Precision

    readings = {}

    def read(driver):
        driver.produce_control(Precision("bf16"))
        readings.update(driver.check())

    _run(root, "train_f32_b32", after_check=read)
    limits = core.Cell("train_f32_b32", root).workload["limits"]
    assert any(readings[k] > v for k, v in limits.items()), (readings, limits)
