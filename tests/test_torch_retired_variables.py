"""The port's model layer reads no kernel-selection variable. The JAX package
picks among its kernels by nine environment variables; the port's
`DiTConVBlock` (eval and train), the estimator (train) and the Vocos head
(train) each take one path, chosen by mode, device and kernel size.

Two checks. No file of `stabletts_torch` names any of the nine, so none can
be read (one case each). And the five that picked another path for a CPU
tensor when the port still read them (the whole-block kernel off, the fused
halves off, the training attention core, the training FFN and the training
prenet), set to such a value, leave every module's outputs and gradients
bit for bit as they are with the variable unset. The other four picked
another path only for a CUDA tensor or together with another variable, so
on the CPU they change nothing whether read or not: the first check alone
holds them."""

import copy
import pathlib

import numpy as np
import pytest
import torch

import stabletts_torch
from stabletts_torch.config import MelConfig, VocosConfig
from stabletts_torch.models.estimator import Decoder
from stabletts_torch.models.vocos import Vocos
from stabletts_torch.nn import blocks as tb

torch.set_num_threads(2)

# each variable and a value that picked another path
RETIRED = {"STABLETTS_DIT_BLOCK": "0", "STABLETTS_DIT_FUSED": "0", "STABLETTS_FFN_IMPL": "xla",
           "STABLETTS_ATTN_IMPL": "xla", "STABLETTS_ATTN_LAYOUT": "tminor", "STABLETTS_ATTN_TRAIN": "xla",
           "STABLETTS_FFN_TRAIN": "xla", "STABLETTS_PRENET_TRAIN": "fused", "STABLETTS_ISTFT_IMPL": "fused"}
CPU_PATH = ("STABLETTS_DIT_BLOCK", "STABLETTS_DIT_FUSED", "STABLETTS_ATTN_TRAIN", "STABLETTS_FFN_TRAIN",
            "STABLETTS_PRENET_TRAIN")


@pytest.mark.parametrize("name", list(RETIRED))
def test_no_module_names_a_retired_variable(name):
    root = pathlib.Path(stabletts_torch.__file__).parent
    naming = [str(p.relative_to(root)) for p in sorted(root.rglob("*"))
              if p.is_file() and p.suffix in (".py", ".cu", ".cuh", ".h", ".cpp") and name in p.read_text()]
    assert naming == []


def _train(module, *args, **kwargs):
    """The train-mode output and the gradients of a fixed cotangent."""
    module.train().zero_grad()
    out = module(*args, **kwargs)
    (out * torch.linspace(-1.0, 1.0, out.shape[-1])).sum().backward()
    return [out.detach()] + [p.grad.clone() for p in module.parameters() if p.grad is not None]


def _outputs() -> list:
    """Every module's results on fixed weights, inputs and dropout draws."""
    rng = np.random.default_rng(3)
    g = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    mask = (torch.arange(40)[None, :] < torch.tensor([40, 27])[:, None]).float()
    x, cond = g(2, 40, 128) * mask[..., None], g(2, 64)
    torch.manual_seed(0)
    block = tb.DiTConVBlock(128, 96, 2, 3, 64, p_dropout=0.1)
    torch.nn.init.normal_(block.adaLN_modulation[2].weight, std=0.1)
    block5 = tb.DiTConVBlock(128, 96, 2, 5, 64, p_dropout=0.1)
    torch.nn.init.normal_(block5.adaLN_modulation[2].weight, std=0.1)
    out = []
    with torch.no_grad():
        for blk in (block, block5):
            out.append(blk.eval()(x, cond, mask))
        out.append(copy.deepcopy(block).to(torch.bfloat16)(x.bfloat16(), cond.bfloat16(), mask))
    for blk in (block, block5):
        out += _train(blk, x, cond, mask, torch.Generator().manual_seed(5))
    decoder = Decoder(16, 16, 128, 16, 96, n_layers=2, n_heads=2, gin_channels=64, p_dropout=0.1)
    out += _train(decoder, torch.tensor([0.3, 0.8]), g(2, 40, 16), mask, g(2, 40, 16), cond,
                  gen=torch.Generator().manual_seed(7))
    vocos = Vocos(VocosConfig(input_channels=20, dim=32, intermediate_dim=64, num_layers=2),
                  MelConfig(n_fft=256, win_length=256, hop_length=64, n_mels=20), device="cpu")
    out += _train(vocos, g(2, 24, 20))
    return out


@pytest.fixture(scope="module")
def unset():
    with pytest.MonkeyPatch.context() as mp:
        for name in RETIRED:
            mp.delenv(name, raising=False)
        return _outputs()


@pytest.mark.parametrize("name", CPU_PATH)
def test_retired_variable_changes_nothing(unset, monkeypatch, name):
    for other in RETIRED:
        monkeypatch.delenv(other, raising=False)
    monkeypatch.setenv(name, RETIRED[name])
    got = _outputs()
    assert len(got) == len(unset) and all(torch.equal(a, b) for a, b in zip(got, unset))
