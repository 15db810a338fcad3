"""The port's serving bench (stabletts_torch/tools/bench.py) and its kernel
gate (stabletts_torch/tools/selftest.py) on the CPU: one JSON line in the
JAX package's bench.py schema, no silent move to the CPU, and a gate that
fails when a kernel's output is off."""

import ast
import json
import os

import pytest
import torch

from stabletts_torch.ops import convnext_cuda, dit_block_cuda, istft_cuda
from stabletts_torch.ops.bars import BARS
from stabletts_torch.tools import bench, selftest

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the fields the port's bench adds to bench.py's `detail`, and to its cfg3 record
ADDED_DETAIL = {"build_s", "card", "launches"}


def _bench_py_keys() -> dict:
    """Keys of the dict literals bench.py prints: `result` (with `detail`),
    `cfg3` and `b1` (each set into `detail` under its own name)."""
    with open(os.path.join(REPO, "bench.py"), encoding="utf-8") as f:
        tree = ast.parse(f.read())
    dicts = {node.targets[0].id: node.value for node in ast.walk(tree)
             if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
             and isinstance(node.targets[0], ast.Name)}
    result = dicts["result"]
    detail = next(v for k, v in zip(result.keys, result.values) if k.value == "detail")
    keys = lambda d: {k.value for k in d.keys}
    return {"top": keys(result), "detail": keys(detail) | {"cfg3", "b1"}, "cfg3": keys(dicts["cfg3"]),
            "b1": keys(dicts["b1"])}


def test_bench_prints_bench_py_schema_on_cpu(capsys):
    result = bench.main(["--device", "cpu", "--batch", "2", "--frames", "32", "--steps", "2", "--iters", "1"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == result
    want = _bench_py_keys()
    d = result["detail"]
    assert set(result) == want["top"] and set(d) == want["detail"] | ADDED_DETAIL
    assert set(d["cfg3"]) == want["cfg3"] | {"launches"} and set(d["b1"]) == want["b1"]
    assert result["metric"] == "audio_seconds_per_s_per_chip_10steps" and result["value"] > 0
    assert d["kernel_selftest"] == "skipped" and d["platform"] == "cpu" and d["card"] is None
    assert (d["batch"], d["mel_frames"], d["ode_steps"], d["cfg"], d["dtype"]) == (2, 32, 2, 1.0, "bfloat16")
    # CFG 3 at half the batch: the headline's estimator batch; the CPU path launches no kernel
    assert d["cfg3"]["batch"] == 1 and d["b1"]["cfg"] == 3.0
    assert d["launches"] == d["cfg3"]["launches"] == {"dit_block": 0, "convnext": 0, "istft": 0}


def test_bench_defaults_are_bench_py_defaults():
    args = bench.parse_args([])
    assert (args.batch, args.frames, args.steps, args.cfg, args.iters, args.dtype) == (192, 1000, 10, 1.0, 5,
                                                                                        "bfloat16")
    assert args.device is None and not (args.skip_selftest or args.skip_cfg3 or args.skip_b1) and args.profile is None


def test_bench_does_not_fall_back_to_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal without a GPU")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench.main(["--batch", "1", "--frames", "16", "--steps", "1", "--iters", "1"])


def test_selftest_rows_on_cpu():
    """On the CPU every wrapper takes its plain version: each check passes at
    its bar from ops/bars.py, in f32 and bf16."""
    rows = selftest.run("cpu")
    assert [(r["kernel"], r["dtype"]) for r in rows] == [
        (k, dt) for dt in ("float32", "bfloat16") for k in ("dit_block", "convnext", "istft", "istft")]
    assert [r.get("lengths") for r in rows[:4]] == [None, None, False, True]
    for r in rows:
        assert r["ok"] and r["rel_err"] == 0.0
        assert r["bar"] == BARS[r["kernel"]][torch.float32 if r["dtype"] == "float32" else torch.bfloat16]


@pytest.mark.parametrize("module,name,kernel", [(dit_block_cuda, "dit_block", "dit_block"),
                                                (convnext_cuda, "convnext_block", "convnext"),
                                                (istft_cuda, "istft_head", "istft")])
def test_selftest_fails_on_a_perturbed_kernel(monkeypatch, capsys, module, name, kernel):
    """A wrapper whose output is 10% off (over every bar) fails the gate, and
    only its own checks."""
    real = getattr(module, name)

    def perturbed(*a, **k):
        return real(*a, **k) * 1.1

    perturbed.launches = 0  # on the card the wrapper counts its launch on the module's attribute
    monkeypatch.setattr(module, name, perturbed)
    with pytest.raises(SystemExit) as e:
        selftest.main(["--device", "cpu"])
    assert e.value.code == 1
    out = capsys.readouterr().out
    assert "SELFTEST FAILED" in out and "SELFTEST OK" not in out
    failed = {json.loads(line)["kernel"] for line in out.splitlines() if line.startswith("{")
              and not json.loads(line)["ok"]}
    assert failed == {kernel}


def test_bench_profile_needs_the_card(tmp_path):
    with pytest.raises(SystemExit, match="--profile"):
        bench.main(["--device", "cpu", "--batch", "1", "--frames", "16", "--steps", "1", "--iters", "1",
                    "--profile", str(tmp_path)])
    assert not any(tmp_path.iterdir())
