"""Shared setup of the stabletts_torch parity tests: small configurations and
JAX parameter trees (seeded, adaLN randomised) carried into the port.

adaLN-Zero makes every DiT block the identity at init, so the modulation is
randomised (x0.1) as tests/test_parity_stabletts.py does, and the CFG
embeddings are made nonzero so the unconditional branch is exercised."""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import torch

from stabletts_torch.config import MelConfig, ModelConfig, VocosConfig
from stabletts_torch.models.ffgan import FireflyGANBase

# 2 heads of 64 (the flagship's head width), F=128, 1 encoder / 2 decoder layers
MODEL_CFG = ModelConfig(hidden_channels=128, filter_channels=128, n_heads=2, n_enc_layers=1, n_dec_layers=2)
MEL_CFG = MelConfig(n_fft=256, win_length=256, hop_length=64, n_mels=32)
VOCOS_CFG = VocosConfig(input_channels=32, dim=64, intermediate_dim=128, num_layers=2)
TOL = dict(rtol=2e-4, atol=2e-4)  # fp32 module bar (tests/test_parity_stabletts.py:27)


def jax_configs(model_cfg=MODEL_CFG, mel_cfg=MEL_CFG, vocos_cfg=VOCOS_CFG):
    from stabletts_tpu import config as jc

    return (jc.ModelConfig(**dataclasses.asdict(model_cfg)), jc.MelConfig(**dataclasses.asdict(mel_cfg)),
            jc.VocosConfig(**dataclasses.asdict(vocos_cfg)))


def randomise_tree(params, seed: int = 7):
    """numpy copy of a flax param tree with adaLN (x0.1), the CFG embeddings
    (x0.5) and every bias (x0.05) drawn from a numpy seed."""
    rng = np.random.default_rng(seed)

    def visit(path, leaf):
        keys = [getattr(p, "key", str(p)) for p in path]
        leaf = np.asarray(leaf, dtype=np.float32)
        if any("adaLN_modulation" in k for k in keys):
            return (rng.standard_normal(leaf.shape) * 0.1).astype(np.float32)
        if keys[-1] in ("fake_speaker", "fake_content"):
            return (rng.standard_normal(leaf.shape) * 0.5).astype(np.float32)
        if keys[-1] == "bias":
            return (rng.standard_normal(leaf.shape) * 0.05).astype(np.float32)
        return leaf

    return jax.tree_util.tree_map_with_path(visit, params)


def jax_stabletts(model_cfg=MODEL_CFG, mel_cfg=MEL_CFG, seed: int = 0):
    """(JAX StableTTS module, numpy params) with randomised adaLN."""
    from stabletts_tpu.models import build_stabletts, init_stabletts_params

    jm, jmel, _ = jax_configs(model_cfg, mel_cfg)
    model = build_stabletts(jm, jmel)
    params = init_stabletts_params(model, jax.random.PRNGKey(seed))["params"]
    return model, randomise_tree(params, seed + 7)


def port_stabletts(params, model_cfg=MODEL_CFG, mel_cfg=MEL_CFG):
    from stabletts_torch.models import build_stabletts
    from stabletts_torch.utils.convert import state_dict_from_jax_stabletts

    model = build_stabletts(model_cfg, mel_cfg, device="cpu")
    sd = state_dict_from_jax_stabletts(params, model_cfg.n_enc_layers, model_cfg.n_dec_layers)
    model.load_state_dict(sd)
    return model


def jax_vocos(vocos_cfg=VOCOS_CFG, mel_cfg=MEL_CFG, seed: int = 1):
    import jax.numpy as jnp

    from stabletts_tpu.models.vocos import Vocos

    _, jmel, jvoc = jax_configs(mel_cfg=mel_cfg, vocos_cfg=vocos_cfg)
    model = Vocos(jvoc, jmel)
    params = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8, mel_cfg.n_mels)))["params"]
    return model, randomise_tree(params, seed + 7)


def port_vocos(params, vocos_cfg=VOCOS_CFG, mel_cfg=MEL_CFG):
    from stabletts_torch.models.vocos import Vocos
    from stabletts_torch.utils.convert import state_dict_from_jax_vocos

    model = Vocos(vocos_cfg, mel_cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax_vocos(params, vocos_cfg.num_layers))
    return model


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def n(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def ffgan_reference_state_dict(seed=0):
    """A FireflyGAN generator state dict as the reference serialises it: the
    port's parameter names, with every conv of the head weight-normed (half
    as weight_g / weight_v, half as parametrizations.weight.original0/1) and
    a BatchNorm-style counter that loaders drop."""
    rng = np.random.default_rng(seed)
    model = FireflyGANBase(device="cpu")
    sd = {}
    for i, (key, value) in enumerate(model.state_dict().items()):
        shape = tuple(value.shape)
        fan = max(1, int(np.prod(shape[1:])))
        if key.endswith("gamma"):
            arr = rng.uniform(0.05, 0.2, shape)
        elif len(shape) == 1 and key.endswith(".weight"):  # a LayerNorm scale
            arr = 1.0 + 0.1 * rng.standard_normal(shape)
        elif len(shape) == 1:
            arr = 0.05 * rng.standard_normal(shape)
        else:
            arr = rng.standard_normal(shape) / np.sqrt(fan)
        arr = arr.astype(np.float32)
        if key.startswith("head.") and key.endswith(".weight"):
            prefix = key[: -len(".weight")]
            g = np.sqrt((arr ** 2).sum(axis=tuple(range(1, arr.ndim)), keepdims=True)) * rng.uniform(0.5, 1.5)
            v = arr * rng.uniform(0.3, 3.0)
            names = (".weight_g", ".weight_v") if (i // 2) % 2 else (".parametrizations.weight.original0",
                                                             ".parametrizations.weight.original1")
            sd[prefix + names[0]], sd[prefix + names[1]] = g.astype(np.float32), v.astype(np.float32)
        else:
            sd[key] = arr
    sd["backbone.num_batches_tracked"] = np.asarray(3, np.int64)
    return sd


def private_jax_native_lib(tmp_path_factory):
    """Points the JAX package's native loader at a private library path, so
    both packages take their native loaders (scipy's fallback resampler
    differs by ~4e-2; see tests/test_torch_native_audio.py). Use as a
    module-scoped fixture body (a generator); the attributes are restored."""
    import pytest

    import stabletts_tpu.native as jax_native

    path = str(tmp_path_factory.mktemp("jax_native") / "libstabletts_native.so")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "_LIB_PATH", path)
        mp.setattr(jax_native, "_lib", None)
        mp.setattr(jax_native, "_build_failed", False)
        yield path
