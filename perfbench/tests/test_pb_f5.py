"""The F5-TTS cell (`serve_f5_batch_bf16`): found and run by its files alone on
the CPU at a tiny size, its traffic (the same pool every seed, one item of
each length part in every batch), its counts against a hand count, and its
`correct` against altered answers and against the fp8 control."""

import json
import os

import numpy as np
import pytest

import pb_helpers
from perfbench.counts import f5tts as counts
from perfbench.lib import core
from perfbench.traffic import prompt_batches

CELL = "serve_f5_batch_bf16"
TINY_F5 = {"dim": 128, "depth": 2, "heads": 2, "text_dim": 64, "text_num_embeds": 40, "conv_layers": 1, "n_mels": 20,
           "nfe_step": 3}
TINY_TRAFFIC = {"batch": 3, "pool_batches": 2, "prompt_s": {"median": 0.3, "sigma": 0.4, "min": 0.2, "max": 0.5},
                "gen_s": {"median": 0.4, "sigma": 0.5, "min": 0.2, "max": 0.7}, "max_total_s": 1.0}
SEEDS = [0, 7, 2 ** 31 + 11, 2 ** 33 + 5]
faults = core.load_module(os.path.join(core.PKG_DIR, "tools", "faults.py"), "pb_f5_faults")


def tiny_f5_copy(tmp_path) -> str:
    """pb_helpers.tiny_copy with the F5-TTS configuration and cell cut to CPU size too."""
    root = pb_helpers.tiny_copy(tmp_path, {**pb_helpers.TINY_TRAFFIC, CELL: TINY_TRAFFIC})
    path = os.path.join(root, "perfbench", "configs", "f5tts-v1-base-vocos24k-serve.json")
    cfg = json.load(open(path))
    cfg.update(TINY_F5)
    json.dump(cfg, open(path, "w"))
    return root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_f5_copy(tmp_path_factory.mktemp("f5"))


def _run(root, trace=False, seed=17, after_check=None):
    run = core.load_module(os.path.join(root, "perfbench", "run.py"), "pb_run_f5")
    return run.run(core.Cell(CELL, root), seed, 0.5, trace, "cpu", after_check=after_check)


def test_cell_runs_by_its_files_alone(root):
    """Untraced: correct, the generated audio a second; traced: the program's
    padding share as the harness's own count of the batches, and the mfu."""
    res = _run(root)
    assert res["correct"] and res["metrics"]["serve_audio_s_per_s"]["value"] > 0 and "setup_s" in res["metrics"]
    assert set(res["checks"]) == {"mel_rel_err", "wave_rel_err"}
    res = _run(root, trace=True)
    got = {k: v["value"] for k, v in res["metrics"].items()}
    assert got["estimator_padding_share.f5_serve"] >= 0.0 and got["mfu.f5_serve"] > 0.0


def test_sound_run_is_correct_on_another_seed(root):
    assert _run(root, seed=2 ** 33 + 5)["correct"]


@pytest.mark.parametrize("fault", ["wave", "mel"])
def test_altered_answer_is_not_correct(root, fault, monkeypatch):
    faults.SERVING[fault](monkeypatch.setattr)
    res = _run(root)
    assert not res["correct"], res["checks"]


def test_fp8_control_is_not_correct(root):
    from perfbench.reference.f5tts_ref import Precision

    readings = {}

    def read(driver):
        driver.produce_control(Precision("fp8"))
        readings.update(driver.check())

    res = _run(root, after_check=read)
    limits = core.Cell(CELL, root).workload["limits"]
    assert any(readings[k] > v for k, v in limits.items()), (readings, limits)
    assert res["correct"]


def _params():
    return core.load_json(f"{core.PKG_DIR}/workloads/{CELL}.json")["traffic"]


@pytest.mark.parametrize("seed", SEEDS)
def test_pool_is_the_same_every_seed_in_the_seed_order(seed):
    p = _params()
    a, b = prompt_batches.generate(p, seed, 2545, 93.75), prompt_batches.generate(p, seed, 2545, 93.75)
    assert all(np.array_equal(x["ids"], y["ids"]) for x, y in zip(a, b))
    key = lambda bs: sorted((x["pool_index"], tuple(x["totals"]), tuple(x["ref_frames"]), tuple(x["x_lengths"]),
                            tuple(x["x_ref_lengths"])) for x in bs)
    assert key(a) == key(prompt_batches.generate(p, 0, 2545, 93.75))


def test_each_batch_holds_one_item_of_each_part():
    p = _params()
    batches = prompt_batches.generate(p, 3, 2545, 93.75)
    assert len(batches) == p["pool_batches"] and all(len(x["totals"]) == p["batch"] for x in batches)
    totals = np.sort(np.concatenate([x["totals"] for x in batches]))
    bounds = [totals[k * p["pool_batches"]] for k in range(p["batch"])] + [totals[-1] + 1]
    for x in batches:
        parts = sorted(int(np.searchsorted(bounds, t, side="right")) - 1 for t in x["totals"])
        assert parts == list(range(p["batch"]))
    fps = 24000 / 256
    refs = np.concatenate([x["ref_frames"] for x in batches])
    assert refs.min() >= int(3.0 * fps) and refs.max() <= int(12.0 * fps)
    assert totals.max() <= int(22.0 * fps) + 8  # the rule's rounding of the bytes
    orders = [[x["pool_index"] for x in prompt_batches.generate(p, s, 2545, 93.75)] for s in SEEDS[:2]]
    assert orders[0] != orders[1]


CFG = {"dim": 128, "ff_mult": 2, "text_dim": 64, "conv_layers": 1, "n_mels": 20, "conv_pos_groups": 16,
       "conv_pos_kernel": 31, "freq_embed_dim": 256, "depth": 2}


def test_block_hand_count():
    L, C, F = 50, 128, 256
    qkv, out = 2 * L * C * 3 * C, 2 * L * C * C
    scores, pv = 2 * L * L * C, 2 * L * L * C
    ffn = 2 * L * C * F + 2 * L * F * C
    adaln = 2 * C * 6 * C
    flops, nbytes = counts.block_call(CFG, [L], "bfloat16")
    assert flops == qkv + out + scores + pv + ffn + adaln
    assert nbytes == 2 * (4 * C * C + 2 * C * F + 6 * C * C) + 2 * (2 * L * C) + 2 * 6 * C
    assert counts.block_call(CFG, [50, 20], "float32")[0] == sum(counts.block_call(CFG, [n], "float32")[0]
                                                                   for n in (50, 20))


def test_synthesis_hand_count():
    L, C, M, Td, steps = 30, 128, 20, 64, 4
    text = L * (2 * 7 * Td + 2 * Td * 2 * Td * 2)
    inemb = L * (2 * (2 * M + Td) * C + 2 * 2 * C * (C // 16) * 31)
    outl = 2 * 256 * C + 2 * C * C + 2 * C * 2 * C + L * 2 * C * M
    est = inemb + 2 * counts.block_call(CFG, [L], "float32")[0] + outl
    assert counts.synthesis_flops(CFG, [L], steps, True) == pytest.approx(2 * text + steps * 2 * est)
    assert counts.synthesis_flops(CFG, [L], steps, False) == pytest.approx(2 * text + steps * est)
