"""FireflyGAN's lengths mode (stabletts_torch/models/ffgan.py) on the CPU at
the published widths and a few frames: the port against the benchmark's
plain reference (perfbench/reference/ffgan_ref.py) on the serving cell's
seeded random weights; a batched item with `lengths` against the item
vocoded alone, and zeros past it; `StableTTSAPI.batch_inference` with
FireflyGAN giving each item as its mel vocoded alone; and the benchmark's
operation count (perfbench/counts/ffgan.py) against the module's own.

Bars: float32 on the CPU, where the port's channels-last convs and the
reference's sum in other orders, and a batch and a lone item may take other
conv algorithms: both differences measured about 5e-7, so 1e-5 is 20 times
that and far below what a frame of a neighbour or of noise leaking into an
item gives (of the order of the waveform itself)."""

import json
import os
import sys

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from stabletts_torch.api import StableTTSAPI
from stabletts_torch.config import MelConfig
from stabletts_torch.models.ffgan import FFGAN_CONFIG, FireflyGANBase
from torch_port_utils import MODEL_CFG

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from perfbench.counts import ffgan as ffgan_counts  # noqa: E402
from perfbench.lib import core  # noqa: E402
from perfbench.lib.weights import make_weights  # noqa: E402
from perfbench.reference import ffgan_ref as FR  # noqa: E402
from perfbench.reference import judge  # noqa: E402

torch.set_num_threads(2)
CFG = core.load_json(os.path.join(REPO, "perfbench", "configs", "stabletts-v1.1-ffgan44k-serve.json"))
V = CFG["vocoder"]
entry = core.load_module(os.path.join(REPO, "perfbench", "entries", "synthesise_ffgan.py"), "pb_entry_ffgan_test")
BAR = 1e-5


def _rel_max(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.fixture(scope="module")
def weights():
    """The serving cell's vocoder weights (the shared rule and the upsamplers' gain) for one seed."""
    cfg = {"vocoder": V, "weights": {"velocity_gain": 1.0, "ups_gain": CFG["weights"]["ups_gain"]}}
    w = make_weights(FR.parameter_shapes(V), cfg, 2700000003, "cpu")
    entry.scale_upsamplers(w, cfg, prefix="")
    return w


@pytest.fixture(scope="module")
def vocoder(weights):
    model = FireflyGANBase(device="cpu")
    model.load_state_dict(weights, strict=True)
    return model.eval()


def _mel(seed, b, t):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(b, t, 128, generator=gen)


def test_config_section_is_the_port_s():
    """The configuration's `vocoder` widths are FFGAN_CONFIG's, and the
    reference names every parameter of the port with its shape."""
    assert V["backbone"] == json.loads(json.dumps(FFGAN_CONFIG["backbone"]))
    assert V["head"] == json.loads(json.dumps(FFGAN_CONFIG["head"]))
    sd = FireflyGANBase(device="cpu").state_dict()
    shapes = FR.parameter_shapes(V)
    assert list(shapes) == list(sd) and all(tuple(sd[k].shape) == s for k, s in shapes.items())


@pytest.mark.parametrize("frames", [5, 11, 17])
def test_port_matches_the_plain_reference(weights, vocoder, frames):
    mel = _mel(frames, 1, frames)
    want = FR.vocode(weights, mel[0], V)
    got = vocoder(mel)[0]
    assert got.shape == want.shape == (frames * 512,)
    assert judge.rel_err(got, want) <= BAR
    # the waveform of the cell's weights: neither vanishing nor held in tanh's saturation
    assert 0.02 < float(want.pow(2).mean().sqrt()) < 0.5 and float((want.abs() > 0.99).float().mean()) < 0.01


@pytest.mark.parametrize("lengths", [(17, 1, 9), (5, 17, 17), (12, 3, 17)])
def test_batched_item_equals_the_item_alone(vocoder, lengths):
    """Frames past each item's length hold noise: the item's waveform is its
    trimmed mel's, and zero past lengths[i] x 512 samples."""
    mel = _mel(sum(lengths), len(lengths), max(lengths))
    got = vocoder(mel, torch.tensor(lengths))
    assert got.shape == (len(lengths), max(lengths) * 512)
    for i, n in enumerate(lengths):
        alone = vocoder(mel[i:i + 1, :n])[0]
        assert _rel_max(got[i, :n * 512], alone) <= BAR, i
        assert torch.equal(got[i, n * 512:], torch.zeros_like(got[i, n * 512:])), i


def test_lengths_none_is_every_frame(vocoder):
    """Without lengths every frame is vocoded: the bits of lengths = T."""
    mel = _mel(1, 2, 9)
    np.testing.assert_array_equal(vocoder(mel).numpy(), vocoder(mel, torch.tensor([9, 9])).numpy())


def test_batch_inference_gives_each_item_as_its_mel_alone(weights, tmp_path):
    """StableTTSAPI with FireflyGAN: each waveform `batch_inference` returns is
    its item's mel vocoded alone (the batch's mel padded with noise past each
    item, at a cap of 64 frames that no item reaches)."""
    path = str(tmp_path / "ffgan.pt")
    torch.save(weights, path)
    api = StableTTSAPI(vocoder_model_path=path, vocoder_name="ffgan", model_config=MODEL_CFG,
                       mel_config=MelConfig(), max_mel_len=64, device="cpu")
    seen = []
    hook = api.vocoder_model.register_forward_hook(lambda _m, args, _out: seen.append(args[0].clone()))
    items = [("Hi.", "english"), ("Good day.", "english"), ("Yes.", "english")]
    wavs = api.batch_inference(items, (0.1 * np.random.default_rng(1).standard_normal(22050)).astype(np.float32),
                               step=2, cfg=2.0)
    hook.remove()
    (mel,) = seen
    assert mel.shape[1] == 64 and len(wavs) == 3
    lengths = [len(w) // 512 for w in wavs]
    assert all(len(w) % 512 == 0 for w in wavs) and max(lengths) < 64 and len(set(lengths)) > 1
    for i, n in enumerate(lengths):
        alone = api.vocoder_model(mel[i:i + 1, :n])[0].numpy()
        assert float(np.abs(wavs[i] - alone).max() / np.abs(alone).max()) <= BAR, i


def test_counts_are_the_module_s_own():
    """0.693 GFLOP a mel frame (38.7M in the backbone, 654.5M in the head),
    against torch's count of the module's convs and linears over 4 frames."""
    assert ffgan_counts.backbone_flops_per_frame(V) == 38_719_488
    assert ffgan_counts.head_flops_per_frame(V) == 654_524_416
    assert ffgan_counts.flops_per_frame(V) == 693_243_904
    counter = FlopCounterMode(display=False)
    with counter:
        FireflyGANBase(device="cpu")(torch.zeros(1, 4, 128))
    assert counter.get_total_flops() == 4 * 693_243_904
    flops, nbytes = ffgan_counts.vocoder_call(V, [3, 5], "bfloat16")
    params = sum(p.numel() for p in FireflyGANBase(device="cpu").parameters())
    assert flops == 8 * 693_243_904 and nbytes == 2 * params + 2 * 8 * (128 + 512)
