"""The port's plain MAS (stabletts_torch/ops/mas.py) against the JAX
package's three: the numpy oracle, the lax.scan DP and the Pallas kernel
under the TPU interpreter, exactly (bar 0), on ragged and degenerate lengths
(t_x = 1, t_y = t_x, the lengths of tools/tpu_selftest.py:227-237). The
port's verbatim numpy oracle is held against the original too."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stabletts_torch.ops.mas import maximum_path, maximum_path_numpy
from stabletts_torch.ops.mas_cuda import mas
from stabletts_tpu.ops import mas as jmas
from stabletts_tpu.ops.mas_pallas import maximum_path_pallas


def _case(b, ty, tx, seed, t_ys=None, t_xs=None):
    rng = np.random.default_rng(seed)
    if t_ys is None:
        t_ys = rng.integers(max(tx, 2), ty + 1, size=b)
        t_xs = np.minimum(rng.integers(2, tx + 1, size=b), t_ys)
    t_ys, t_xs = np.asarray(t_ys, np.int32), np.asarray(t_xs, np.int32)
    neg = rng.standard_normal((b, ty, tx)).astype(np.float32)
    mask = ((np.arange(ty)[None, :] < t_ys[:, None])[:, :, None]
            & (np.arange(tx)[None, :] < t_xs[:, None])[:, None, :]).astype(np.float32)
    return neg, mask, t_ys, t_xs


CASES = {
    "ragged": dict(b=6, ty=50, tx=20, seed=0),
    "degenerate": dict(b=5, ty=40, tx=20, seed=3, t_ys=[40, 20, 33, 1, 40], t_xs=[1, 20, 7, 1, 20]),
    "selftest_lengths": dict(b=8, ty=300, tx=120, seed=6, t_ys=[300, 250, 123, 77, 300, 12, 299, 150],
                             t_xs=[120, 100, 120, 50, 1, 12, 64, 120]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_mas_equals_jax_oracle_and_scan(name):
    neg, mask, t_ys, t_xs = _case(**CASES[name])
    got = maximum_path(torch.from_numpy(neg), torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(got.astype(np.int32), jmas.maximum_path_numpy(neg, t_ys, t_xs))
    np.testing.assert_array_equal(got, np.asarray(jmas.maximum_path(jnp.asarray(neg), jnp.asarray(mask))))
    np.testing.assert_array_equal(maximum_path_numpy(neg, t_ys, t_xs), jmas.maximum_path_numpy(neg, t_ys, t_xs))


# The shapes at which the card checks each form of the CUDA kernel against this
# plain version (chip_smoke.py, tests/test_torch_cuda.py::test_mas_kernel_forms):
# four chain warps with the decision bits in shared memory and in the
# workspace (Ty * Tx / 8 past the shared budget), five warps of 32 cells a lane
# (Tx > 4096), and one warp with 4-byte copies (Tx % 4 != 0); each with
# degenerate lengths beside ragged ones (t_x = 1, t_y = t_x, t_x > t_y, bands
# and backtraces that cross from one chain warp's cells into another's).
KERNEL_FORM_CASES = {
    "warps_shared": dict(b=4, ty=1000, tx=1024, seed=11, t_ys=[1000, 1000, 950, 300], t_xs=[1024, 900, 1, 1000]),
    "warps_workspace": dict(b=2, ty=2000, tx=1024, seed=12, t_ys=[2000, 2000], t_xs=[1024, 1]),
    "wide_workspace": dict(b=2, ty=300, tx=5000, seed=13, t_ys=[300, 300], t_xs=[4200, 290]),
    "unaligned_tx": dict(b=4, ty=301, tx=77, seed=14, t_ys=[301, 250, 77, 30], t_xs=[77, 61, 77, 50]),
}


@pytest.mark.parametrize("name", sorted(KERNEL_FORM_CASES))
def test_plain_mas_equals_jax_oracle_at_kernel_form_shapes(name):
    neg, mask, t_ys, t_xs = _case(**KERNEL_FORM_CASES[name])
    got = maximum_path(torch.from_numpy(neg), torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(got.astype(np.int32), jmas.maximum_path_numpy(neg, t_ys, t_xs))


@pytest.mark.parametrize("name", ["ragged", "degenerate"])
def test_plain_mas_equals_pallas_interpreted(name):
    neg, mask, _, _ = _case(**CASES[name])
    want = np.asarray(maximum_path_pallas(jnp.asarray(neg), jnp.asarray(mask), interpret=True))
    np.testing.assert_array_equal(maximum_path(torch.from_numpy(neg), torch.from_numpy(mask)).numpy(), want)


def test_mas_dispatch_takes_plain_path_on_cpu():
    neg, mask, t_ys, t_xs = _case(**CASES["ragged"])
    before = mas.launches
    got = mas(torch.from_numpy(neg).requires_grad_(), torch.from_numpy(mask))
    assert mas.launches == before and not got.requires_grad
    np.testing.assert_array_equal(got.numpy().astype(np.int32), maximum_path_numpy(neg, t_ys, t_xs))


def test_mas_path_is_monotonic_and_covers_every_frame():
    neg, mask, t_ys, t_xs = _case(**CASES["ragged"])
    path = maximum_path(torch.from_numpy(neg), torch.from_numpy(mask)).numpy()
    for i in range(len(t_ys)):
        p = path[i, :t_ys[i], :t_xs[i]]
        assert (p.sum(axis=1) == 1).all() and path[i].sum() == t_ys[i]
        idx = p.argmax(axis=1)
        assert idx[0] == 0 and idx[-1] == t_xs[i] - 1 and (np.diff(idx) >= 0).all() and (np.diff(idx) <= 1).all()
