"""The port's CUDA kernels against their plain versions on a GPU, at small
shapes (flagship widths, short T, odd T). Marked `cuda`: they need a CUDA
device and nvcc, and skip elsewhere. Run on a GPU machine with

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest

(--noconftest: tests/conftest.py configures JAX, which such a machine may lack.)
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

BF16 = torch.bfloat16


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rand(rng, dev, dtype, *shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(dev, dtype)


def _rel(got, ref):
    return ((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


@pytest.mark.parametrize("dtype,bar", [(torch.float32, 5e-3), (BF16, 2e-2)])
@pytest.mark.parametrize("t_len", [64, 77])
def test_dit_block_kernel(dev, dtype, bar, t_len):
    from stabletts_torch.ops.dit_block_cuda import DiTWeights, dit_block, dit_block_plain

    rng = np.random.default_rng(0)
    b, c, f, heads = 2, 256, 1024, 4
    w = DiTWeights(*(_rand(rng, dev, dtype, *s, scale=0.05) for s in
                     [(c, 3 * c), (3 * c,), (c, c), (c,), (3, c, f), (f,), (3, f, c), (c,)]))
    mask = (torch.arange(t_len, device=dev)[None, :] < torch.tensor([[t_len], [t_len - 9]], device=dev)).float()
    x = _rand(rng, dev, dtype, b, t_len, c) * mask[..., None].to(dtype)
    mods = _rand(rng, dev, dtype, b, 6, c, scale=0.1)
    before = dit_block.launches
    got = dit_block(x, mods, mask, w, heads)
    assert dit_block.launches == before + 1
    assert _rel(got, dit_block_plain(x, mods, mask, w, heads)) <= bar


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("t_len", [32, 45])
def test_convnext_kernel(dev, dtype, t_len):
    from stabletts_torch.ops.convnext_cuda import ConvNeXtWeights, convnext_block, convnext_block_plain

    rng = np.random.default_rng(1)
    c, f = 512, 1536
    w = ConvNeXtWeights(*(_rand(rng, dev, dtype, *s, scale=0.05) for s in
                          [(7, c), (c,), (c,), (c,), (c, f), (f,), (f, c), (c,), (c,)]))
    x = _rand(rng, dev, dtype, 2, t_len, c)
    assert _rel(convnext_block(x, w), convnext_block_plain(x, w)) <= 2e-2


@pytest.mark.parametrize("dtype,bar", [(torch.float32, 1e-4), (BF16, 1e-3)])
@pytest.mark.parametrize("lengths", [None, [13, 6]])
def test_istft_kernel(dev, dtype, bar, lengths):
    from stabletts_torch.ops.istft_cuda import istft_head

    rng = np.random.default_rng(2)
    re, im = (_rand(rng, dev, torch.float32, 2, 13, 1025) for _ in range(2))
    md = None if dtype == torch.float32 else dtype
    lens = None if lengths is None else torch.tensor(lengths)
    got = istft_head(re, im, 2048, 512, md, None if lens is None else lens.to(dev))
    ref = istft_head(re.cpu(), im.cpu(), 2048, 512, md, lens)
    assert _rel(got.cpu(), ref) <= bar
