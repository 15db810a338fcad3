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
