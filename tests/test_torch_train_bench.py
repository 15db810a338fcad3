"""The port's training benches (stabletts_torch/tools/train_bench.py and
vocos_bench.py) and `ModelConfig.remat` on the CPU.

  * remat, port against port: with dropout on (the trainer's generator
    seeded), two steps with `remat=True` give the loss, every gradient and
    every parameter of two steps without it bit for bit, and leave the
    generator where it stands without remat (the recompute must draw the
    forward's dropout again, from a copy of the generator). The JAX package
    holds its remat to no-remat in tests/test_train.py, and the port's
    no-remat step is held to JAX's in tests/test_torch_train.py.
  * the benches print the JAX package's JSON line (tools/train_bench.py,
    tools/vocos_bench.py: the keys read from their source), take its flags
    and defaults (`--device` for `--platform`), and refuse to run without a
    card unless asked for the CPU.
"""

import ast
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from stabletts_torch.config import MelConfig, ModelConfig, TrainConfig
from stabletts_torch.models import build_stabletts
from stabletts_torch.nn.blocks import DiTConVBlock
from stabletts_torch.train.scheduler import make_scheduler
from stabletts_torch.train.train_tts import make_optimizer, train_step
from stabletts_torch.tools import train_bench, vocos_bench

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ModelConfig(hidden_channels=32, filter_channels=64, n_heads=2, n_enc_layers=1, n_dec_layers=2,
                   p_dropout=0.1, gin_channels=32)
TINY_MEL = MelConfig(n_mels=16)


def _batch():
    rng = np.random.default_rng(0)
    b, tx, ty, tz = 3, 10, 30, 8
    return (torch.from_numpy(rng.integers(1, 50, (b, tx)).astype(np.int32)), torch.tensor([10, 7, 9]),
            torch.from_numpy(rng.standard_normal((b, ty, 16)).astype(np.float32)), torch.tensor([30, 22, 27]),
            torch.from_numpy(rng.standard_normal((b, tz, 16)).astype(np.float32)), torch.tensor([8, 8, 6]))


def _two_steps(remat: bool, compute_dtype):
    """Two training steps from seeded weights and a seeded generator:
    (metrics of each step, gradients, parameters, generator state, block
    forward calls)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = build_stabletts(dataclasses.replace(TINY, remat=remat), TINY_MEL, device="cpu")
    model.train()
    calls = []
    for m in model.modules():
        if isinstance(m, DiTConVBlock):
            m.register_forward_pre_hook(lambda *_: calls.append(1))
    opt = make_optimizer(model, TrainConfig())
    sched = make_scheduler(opt, 1e-3, 1, 10)
    gen = torch.Generator().manual_seed(5)
    metrics = [train_step(model, opt, sched, _batch(), gen, compute_dtype) for _ in range(2)]
    grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    params = {k: p.detach().clone() for k, p in model.named_parameters()}
    return metrics, grads, params, gen.get_state(), len(calls)


@pytest.mark.parametrize("compute_dtype", [None, torch.bfloat16], ids=["float32", "bfloat16"])
def test_remat_equals_no_remat_bit_for_bit_with_dropout(compute_dtype):
    plain, remat = _two_steps(False, compute_dtype), _two_steps(True, compute_dtype)
    for step in range(2):
        for k in plain[0][step]:
            assert torch.equal(plain[0][step][k], remat[0][step][k]), (step, k)
    for i, what in ((1, "gradient"), (2, "parameter")):
        assert plain[i].keys() == remat[i].keys()
        bad = [k for k in plain[i] if not torch.equal(plain[i][k], remat[i][k])]
        assert not bad, f"{what}s differ: {bad}"
    assert torch.equal(plain[3], remat[3]), "the generator stands elsewhere after remat's steps"
    # the 2 estimator blocks run again in each backward; the encoder's block does not
    enc, dec = TINY.n_enc_layers, TINY.n_dec_layers
    assert plain[4] == 2 * (enc + dec) and remat[4] == 2 * (enc + 2 * dec)


def test_remat_leaves_the_state_dict_and_inference_alone():
    models = []
    for remat in (False, True):
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            models.append(build_stabletts(dataclasses.replace(TINY, remat=remat), TINY_MEL, device="cpu"))
    sds = [m.state_dict() for m in models]
    assert list(sds[0]) == list(sds[1]) and all(torch.equal(sds[0][k], sds[1][k]) for k in sds[0])
    rng = np.random.default_rng(1)
    args = (torch.from_numpy(rng.uniform(size=2).astype(np.float32)),
            torch.from_numpy(rng.standard_normal((2, 20, 16)).astype(np.float32)), torch.ones(2, 20),
            torch.from_numpy(rng.standard_normal((2, 20, 16)).astype(np.float32)),
            torch.from_numpy(rng.standard_normal((2, 32)).astype(np.float32)))
    outs = [m.decoder(*args) for m in models]  # eval mode: no checkpoint
    assert torch.equal(outs[0], outs[1])


def _jax_tool(name: str) -> ast.Module:
    with open(os.path.join(REPO, "tools", name), encoding="utf-8") as f:
        return ast.parse(f.read())


def _jax_json_keys(name: str) -> tuple:
    """(top-level keys, detail keys) of the metric line the JAX tool prints."""
    for node in ast.walk(_jax_tool(name)):
        if isinstance(node, ast.Dict) and any(isinstance(k, ast.Constant) and k.value == "metric" for k in node.keys):
            detail = next(v for k, v in zip(node.keys, node.values) if k.value == "detail")
            return {k.value for k in node.keys}, {k.value for k in detail.keys}
    raise AssertionError(f"no metric line in tools/{name}")


def _jax_defaults(name: str) -> dict:
    """{dest: default} of the JAX tool's argparse flags."""
    out = {}
    for node in ast.walk(_jax_tool(name)):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "add_argument":
            flag = node.args[0].value.lstrip("-").replace("-", "_")
            kw = {k.arg: k.value for k in node.keywords}
            out[flag] = False if "action" in kw else (kw["default"].value if "default" in kw else None)
    return out


def _check_line(capsys, result, name, metric):
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line) == result
    top, detail = _jax_json_keys(name)
    assert set(result) == top and detail <= set(result["detail"])
    assert result["metric"] == metric and result["value"] > 0 and result["detail"]["platform"] == "cpu"
    assert result["detail"]["card"] is None and result["detail"]["peak_memory_gb"] is None


@pytest.mark.parametrize("extra", [[], ["--remat"], ["--from-disk"]], ids=["default", "remat", "from_disk"])
def test_train_bench_prints_jax_schema_on_cpu(capsys, extra):
    result = train_bench.main(["--device", "cpu", "--batch", "2", "--mel-frames", "64", "--text-len", "32",
                               "--iters", "1", *extra])
    _check_line(capsys, result, "train_bench.py", "tts_train_audio_s_per_s_per_chip")
    d = result["detail"]
    assert (d["batch"], d["ty"], d["tx"], d["dtype"], d["remat"]) == (2, 64, 32, "float32", "--remat" in extra)
    assert np.isfinite([d["first_loss"], d["loss"], d["ms_per_step"], d["mas_ms"]]).all()
    # the CPU path launches no kernel
    assert d["launches_per_step"] == {k: 0 for k in train_bench.KERNELS}
    if "--from-disk" in extra:
        fd = d["from_disk"]
        assert fd["steps"] == 4 and fd["loader_workers"] == 4 and fd["prefetch_depth"] == 8
        assert fd["sync_ms_per_step"] > 0 and fd["prefetch_ms_per_step"] > 0
    else:
        assert d["from_disk"] is None


def test_vocos_bench_prints_jax_schema_on_cpu(capsys):
    result = vocos_bench.main(["--device", "cpu", "--batch", "1", "--iters", "1"])
    _check_line(capsys, result, "vocos_bench.py", "vocos_gan_train_audio_s_per_s_per_chip")
    d = result["detail"]
    assert (d["batch"], d["segment"], d["dtype"]) == (1, 20480, "float32") and np.isfinite(d["gen_loss_total"])


@pytest.mark.parametrize("module,name", [(train_bench, "train_bench.py"), (vocos_bench, "vocos_bench.py")])
def test_bench_flags_and_defaults_are_jax(module, name):
    ours = vars(module.parse_args([]))
    theirs = _jax_defaults(name)
    assert theirs.pop("platform") is None and ours.pop("device") is None
    assert ours == theirs
    assert vocos_bench.TRAIN_VOCOS == dataclasses.replace(vocos_bench.TRAIN_VOCOS, dim=768, intermediate_dim=2048,
                                                          num_layers=12)


@pytest.mark.parametrize("main,argv", [
    (train_bench.main, ["--batch", "1", "--mel-frames", "16", "--text-len", "8", "--iters", "1"]),
    (vocos_bench.main, ["--batch", "1", "--iters", "1"])], ids=["train_bench", "vocos_bench"])
def test_benches_do_not_fall_back_to_the_cpu(main, argv, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal without a GPU")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(argv)
    with pytest.raises(SystemExit, match="--profile"):
        main(["--device", "cpu", *argv, "--profile", str(tmp_path)])
    assert not any(tmp_path.iterdir())
