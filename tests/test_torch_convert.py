"""Guards of the PyTorch port (stabletts_torch):

* its weight converters equal the JAX package's flax_to_torch_* key for key
  and bit for bit, at the flagship and at a small config, and the result
  loads strictly into the port's models;
* no file of the port, nor chip_smoke.py, imports jax/flax/optax/orbax or
  stabletts_tpu;
* every module of the port imports on the CPU without nvcc or triton;
* its config copies keep the JAX package's defaults.
"""

import ast
import dataclasses
import importlib
import os
import pkgutil

import jax
import numpy as np
import pytest
import torch

import stabletts_torch
from stabletts_torch.config import MelConfig, ModelConfig, VocosConfig
from torch_port_utils import MEL_CFG, MODEL_CFG, VOCOS_CFG, jax_configs

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "flax", "optax", "orbax", "stabletts_tpu")


def _random_tree(abstract, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), abstract)


def _stabletts_tree(model_cfg, mel_cfg):
    from stabletts_tpu.models import build_stabletts, init_stabletts_params

    jm, jmel, _ = jax_configs(model_cfg, mel_cfg)
    model = build_stabletts(jm, jmel)
    abstract = jax.eval_shape(lambda: init_stabletts_params(model, jax.random.PRNGKey(0)))
    return _random_tree(abstract["params"], 0)


def _vocos_tree(vocos_cfg, mel_cfg):
    import jax.numpy as jnp

    from stabletts_tpu.models.vocos import Vocos

    _, jmel, jvoc = jax_configs(mel_cfg=mel_cfg, vocos_cfg=vocos_cfg)
    model = Vocos(jvoc, jmel)
    abstract = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, mel_cfg.n_mels))))
    return _random_tree(abstract["params"], 1)


def _assert_same(ours, theirs):
    assert list(ours) == list(theirs)
    for k in theirs:
        mine = ours[k].numpy()
        assert mine.dtype == theirs[k].dtype and mine.shape == theirs[k].shape, k
        assert np.array_equal(mine, theirs[k]), k


@pytest.mark.parametrize("size", ["flagship", "small"])
def test_stabletts_state_dict_matches_jax_converter(size):
    from stabletts_torch.models import build_stabletts
    from stabletts_torch.utils.convert import state_dict_from_jax_stabletts
    from stabletts_tpu.utils.convert import flax_to_torch_stabletts

    model_cfg, mel_cfg = (ModelConfig(), MelConfig()) if size == "flagship" else (MODEL_CFG, MEL_CFG)
    params = _stabletts_tree(model_cfg, mel_cfg)
    layers = (model_cfg.n_enc_layers, model_cfg.n_dec_layers)
    ours = state_dict_from_jax_stabletts(params, *layers)
    _assert_same(ours, flax_to_torch_stabletts(params, *layers))

    model = build_stabletts(model_cfg, mel_cfg, device="cpu")
    model.load_state_dict(ours)  # strict: names and shapes line up
    assert torch.equal(model.decoder.estimator.blocks[1].block.mlp.conv_1.weight,
                       ours["decoder.estimator.blocks.1.block.mlp.conv_1.weight"])


@pytest.mark.parametrize("size", ["flagship", "small"])
def test_vocos_state_dict_matches_jax_converter(size):
    from stabletts_torch.models.vocos import Vocos
    from stabletts_torch.utils.convert import state_dict_from_jax_vocos
    from stabletts_tpu.utils.convert import flax_to_torch_vocos

    vocos_cfg, mel_cfg = (VocosConfig(), MelConfig()) if size == "flagship" else (VOCOS_CFG, MEL_CFG)
    params = _vocos_tree(vocos_cfg, mel_cfg)
    ours = state_dict_from_jax_vocos(params, vocos_cfg.num_layers)
    _assert_same(ours, flax_to_torch_vocos(params, vocos_cfg.num_layers))
    model = Vocos(vocos_cfg, mel_cfg, device="cpu")
    model.load_state_dict(ours)
    assert model.backbone.convnext[0].dwconv.weight.shape == (vocos_cfg.dim, 1, 7)


def test_load_torch_state_dict_drops_recomputed_buffers(tmp_path):
    from stabletts_torch.utils.convert import load_torch_state_dict

    sd = {"a.weight": torch.ones(2, 3), "head.istft.window": torch.ones(4),
          "encoder.encoder.0.attn.query_rotary_pe.cos_cached": torch.ones(2)}
    torch.save({"state_dict": sd}, tmp_path / "m.pt")
    loaded = load_torch_state_dict(str(tmp_path / "m.pt"))
    assert list(loaded) == ["a.weight"] and loaded["a.weight"].dtype == torch.float32


def _port_files():
    root = os.path.join(REPO, "stabletts_torch")
    files = [os.path.join(REPO, "chip_smoke.py")]
    for dirpath, _, names in os.walk(root):
        files += [os.path.join(dirpath, f) for f in names if f.endswith(".py")]
    return sorted(files)


def test_port_imports_nothing_of_jax():
    offenders = []
    for path in _port_files():
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                names = [node.module]
            offenders += [f"{os.path.relpath(path, REPO)}: {m}" for m in names
                          if m.split(".")[0] in FORBIDDEN]
    assert not offenders, offenders
    assert len(_port_files()) > 20
    # the training slices' files, and the frontends, decoders and bench of the serving slice, are among those searched
    searched = {os.path.relpath(p, REPO) for p in _port_files()}
    assert {"chip_smoke.py", "stabletts_torch/ops/attention_train_cuda.py", "stabletts_torch/ops/prenet_train_cuda.py",
            "stabletts_torch/ops/mpd_cuda.py", "stabletts_torch/models/discriminators.py",
            "stabletts_torch/models/gan_losses.py", "stabletts_torch/train/train_vocos.py",
            "stabletts_torch/data/vocos_dataset.py", "stabletts_torch/utils/audio_io.py",
            "stabletts_torch/tools/ab_dit_attention_train.py", "stabletts_torch/text/numbers_zh.py",
            "stabletts_torch/text/pinyin.py", "stabletts_torch/text/mandarin.py", "stabletts_torch/text/numbers_ja.py",
            "stabletts_torch/text/japanese.py", "stabletts_torch/text/router.py", "stabletts_torch/utils/flac_py.py",
            "stabletts_torch/utils/codecs.py", "stabletts_torch/ops/bars.py", "stabletts_torch/tools/bench.py",
            "stabletts_torch/tools/selftest.py"} <= searched


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(stabletts_torch.__path__, "stabletts_torch."))


@pytest.mark.parametrize("module", _port_modules())
def test_port_module_imports_on_cpu(module):
    mod = importlib.import_module(module)
    assert mod.__name__ == module


def test_importing_builds_no_kernel():
    from stabletts_torch.ops import _build
    from stabletts_torch.ops.convnext_cuda import convnext_block
    from stabletts_torch.ops.dit_block_cuda import dit_block
    from stabletts_torch.ops.dit_attention_train_cuda import dit_attention_train_bwd, dit_attention_train_fwd
    from stabletts_torch.ops.ffn_train_cuda import ffn_train_bwd, ffn_train_fwd
    from stabletts_torch.ops.istft_cuda import istft_head
    from stabletts_torch.ops.mas_cuda import mas
    from stabletts_torch.ops.attention_train_cuda import attention_train_bwd, attention_train_fwd
    from stabletts_torch.ops.mpd_cuda import mpd_stack
    from stabletts_torch.ops.prenet_train_cuda import prenet_train_bwd, prenet_train_fwd

    # importing builds nothing; the CPU path never touches the kernels
    assert not _build._libs
    for fn in (dit_block, convnext_block, istft_head, dit_attention_train_fwd, dit_attention_train_bwd,
               ffn_train_fwd, ffn_train_bwd, mas, attention_train_fwd, attention_train_bwd, prenet_train_fwd,
               prenet_train_bwd, mpd_stack):
        assert isinstance(fn.launches, int)


@pytest.mark.parametrize("name", ["MelConfig", "ModelConfig", "TrainConfig", "VocosConfig", "VocosTrainConfig"])
def test_config_defaults_match_jax(name):
    from stabletts_tpu import config as jc

    ours = dataclasses.asdict(getattr(stabletts_torch.config, name)())
    theirs = dataclasses.asdict(getattr(jc, name)())
    assert {k: theirs[k] for k in ours} == ours
    assert set(theirs) - set(ours) <= {"remat"}
