"""The port's attention microbenchmark variants
(stabletts_torch/ops/attention_variants_cuda.py and its tools) against the
JAX package on the CPU: the Pallas kernels of ops/attention_pallas_v2.py and
ops/attention_pallas.py run with interpret=True, those of tools/attn_exp*.py
(loaded by path) under force_tpu_interpret_mode. Same numpy inputs into both,
flagship head width (H=4, D=64). Bars: f32 rtol = atol = 2e-4; bf16 2e-2 of
the largest value; only valid query rows are compared, padded rows must be
finite."""

import contextlib
import importlib.util
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from stabletts_torch.ops import attention_packed_cuda as ap
from stabletts_torch.ops import attention_variants_cuda as av
from stabletts_tpu.nn.blocks import _rope_neg_half_matrix, _rope_packed_cache
from stabletts_tpu.ops.attention_pallas import fused_attention_packed_rope
from stabletts_tpu.ops.attention_pallas_v2 import fused_attention_packed as fused_attention_packed_v2
from torch_port_utils import TOL

torch.set_num_threads(2)

H = 4
_TOOLS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools")
_DT = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
_NEG = -0.7 * float(np.finfo(np.float32).max)


def _tool(name):
    spec = importlib.util.spec_from_file_location(f"_jax_{name}", os.path.join(_TOOLS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def tools():
    return {name: _tool(name) for name in ("attn_exp", "attn_exp2", "attn_exp3", "attn_exp4", "attn_exp5")}


def _inputs(b, t_len, seed, lengths=None):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, t_len, H * 64)).astype(np.float32) for _ in range(3))
    mask = None
    if lengths is not None:
        mask = (np.arange(t_len)[None, :] < np.asarray(lengths)[:, None]).astype(np.float32)
    return q, k, v, mask


def _t(a, dtype):
    return None if a is None else torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _j(a, dtype):
    return None if a is None else jnp.asarray(a, dtype)


def _close(got, want, dtype, mask=None):
    got, want = got.float().numpy(), np.asarray(want.astype(jnp.float32))
    assert np.isfinite(got).all()
    if mask is not None:
        rows = np.asarray(mask) > 0
        got, want = got[rows], want[rows]
    if dtype == "bf16":
        assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()
    else:
        np.testing.assert_allclose(got, want, **TOL)


CASES = [(2, 97, [97, 50]), (2, 200, None), (2, 200, [200, 131])]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("b,t_len,lengths", CASES)
def test_attention_packed_v2_matches_pallas_interpret(b, t_len, lengths, dtype):
    jd, td = _DT[dtype]
    q, k, v, mask = _inputs(b, t_len, 0, lengths)
    want = fused_attention_packed_v2(_j(q, jd), _j(k, jd), _j(v, jd), _j(mask, jnp.float32), n_heads=H,
                                     interpret=True)
    got = av.attention_packed_v2(_t(q, td), _t(k, td), _t(v, td), _t(mask, torch.float32), n_heads=H)
    _close(got, want, dtype, mask)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("rotary_dim", [32, 16])
@pytest.mark.parametrize("b,t_len,lengths", CASES)
def test_attention_packed_rope_matches_pallas_interpret(b, t_len, lengths, rotary_dim, dtype):
    jd, td = _DT[dtype]
    q, k, v, mask = _inputs(b, t_len, 1, lengths)
    want = fused_attention_packed_rope(_j(q, jd), _j(k, jd), _j(v, jd), _j(mask, jnp.float32), n_heads=H,
                                       rotary_dim=rotary_dim, interpret=True)
    got = av.attention_packed_rope(_t(q, td), _t(k, td), _t(v, td), _t(mask, torch.float32), n_heads=H,
                                   rotary_dim=rotary_dim)
    _close(got, want, dtype, mask)


@pytest.mark.parametrize("t_len,rotary_dim", [(97, 32), (200, 16), (1000, 32), (1024, 64)])
def test_rope_tables_match_jax(t_len, rotary_dim):
    """bf16 tables equal the JAX package's to the last bit; f32 tables within
    one ulp (XLA's f32 cos/sin and the port's f64-then-rounded ones differ
    in the last bit for a few entries)."""
    for jd, td in _DT.values():
        jc, js = _rope_packed_cache(t_len, H, 64, rotary_dim, jd)
        tc, ts = av.rope_packed_tables(t_len, H, 64, rotary_dim, td)
        for got, want in ((tc, jc), (ts, js)):
            got, want = got.float().numpy(), np.asarray(want.astype(jnp.float32))
            if td == torch.bfloat16:
                np.testing.assert_array_equal(got, want)
            else:
                assert np.abs(got - want).max() <= np.spacing(np.float32(1.0))


@pytest.mark.parametrize("lengths", [None, [97, 40]])
def test_rope_plain_is_rope_then_v2(lengths):
    """The JAX docstring's claim (ops/attention_pallas.py:192-193): in f32
    the fused RoPE kernel equals RoPE followed by packed attention (here the
    v2 function, whose q is pre-scaled in its dtype as #7's is)."""
    q, k, v, mask = _inputs(2, 97, 2, lengths)
    q, k, v, mask = (_t(a, torch.float32) for a in (q, k, v, mask))
    cos, sin = av.rope_packed_tables(97, H, 64, 32)
    rope = lambda x: av.apply_rope_packed(x, cos, sin, H, 32)
    want = av.attention_packed_v2_plain(rope(q), rope(k), v, mask, n_heads=H)
    got = av.attention_packed_rope_plain(q, k, v, mask, n_heads=H)
    assert (got - want).abs().max().item() <= 1e-6


def _jax_rotation(q, k, rotary_dim, jd):
    """#7's rotation as the JAX package computes it: q pre-scaled in its
    dtype (ops/attention_pallas.py:200), then x*cos + (x @ P)*sin in the
    dtype with the tables and signed permutation the kernel is given
    (:165-168, :208-209), one operation at a time. Returns q_r, k_r and the
    (cos, sin) tables."""
    t = q.shape[1]
    cos, sin = _rope_packed_cache(t, H, 64, rotary_dim, jd)
    perm = _rope_neg_half_matrix(H, 64, rotary_dim).astype(jd)
    rotate = lambda x: x * cos + jnp.dot(x, perm, preferred_element_type=jnp.float32).astype(jd) * sin
    qs = (jnp.asarray(q, jd).astype(jnp.float32) * (math.log2(math.e) / math.sqrt(64))).astype(jd)
    return rotate(qs), rotate(jnp.asarray(k, jd)), (cos, sin)


def _np(a):
    return np.array(jnp.asarray(a).astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("t_len", [97, 128])
@pytest.mark.parametrize("rotary_dim", [16, 32, 64])
def test_rope_rotation_plain_is_the_pallas_rotation(t_len, rotary_dim, dtype):
    """The port's plain rotation (the rotation kernel's plain version) gives
    the JAX package's in-kernel rotation of #7 bit for bit, on the same
    tables: the rounding order (q pre-scaled, x*cos, (x @ P)*sin, their sum,
    each in the dtype) and the signed permutation are the same."""
    jd, td = _DT[dtype]
    q, k, _, _ = _inputs(2, t_len, 21)
    want_q, want_k, (cos, sin) = _jax_rotation(q, k, rotary_dim, jd)
    tables = tuple(torch.from_numpy(_np(a)).to(td) for a in (cos, sin))
    got_q, got_k = av.rope_rotate_packed_plain(_t(q, td), _t(k, td), H, rotary_dim, tables=tables)
    np.testing.assert_array_equal(got_q.float().numpy(), _np(want_q))
    np.testing.assert_array_equal(got_k.float().numpy(), _np(want_k))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("lengths", [None, [97, 40]])
def test_rope_plain_is_v2_core_over_the_pallas_rotation(lengths, dtype):
    """`attention_packed_rope_plain` is the v2 core on the JAX package's
    rotated q and k, on every row (padded query rows too): bit for bit in
    bf16, whose tables equal the JAX package's; in f32 within 1e-6, since a
    few f32 table entries differ from XLA's by one ulp
    (test_rope_tables_match_jax)."""
    jd, td = _DT[dtype]
    q, k, v, mask = _inputs(2, 97, 22, lengths)
    qr, kr, _ = _jax_rotation(q, k, 32, jd)
    mask_t = _t(mask, torch.float32)
    want = av._v2_core(torch.from_numpy(_np(qr)).to(td), torch.from_numpy(_np(kr)).to(td), _t(v, td), mask_t, H)
    got = av.attention_packed_rope_plain(_t(q, td), _t(k, td), _t(v, td), mask_t, n_heads=H, rotary_dim=32)
    if dtype == "bf16":
        assert torch.equal(got, want)
    else:
        assert (got - want).abs().max().item() <= 1e-6 * want.abs().max().item()


@contextlib.contextmanager
def _interpret():
    with pltpu.force_tpu_interpret_mode():
        yield


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("t_len", [97, 200])
def test_head_pair_matches_attn_exp(tools, t_len, dtype):
    jd, td = _DT[dtype]
    q, k, v, _ = _inputs(2, t_len, 3)
    with _interpret():
        want = tools["attn_exp"].run_pair(_j(q, jd), _j(k, jd), _j(v, jd))
    _close(av.attention_head_pair(_t(q, td), _t(k, td), _t(v, td), n_heads=H), want, dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("which", ["matmul", "nomax", "nomax_bf16", "bf16"])
@pytest.mark.parametrize("t_len", [97, 200])
def test_decompose_matches_attn_exp2(tools, t_len, which, dtype):
    jd, td = _DT[dtype]
    q, k, v, _ = _inputs(2, t_len, 4)
    with _interpret():
        want = tools["attn_exp2"].run(_j(q, jd), _j(k, jd), _j(v, jd), which=which)
    _close(av.attention_decompose(_t(q, td), _t(k, td), _t(v, td), which=which, n_heads=H), want, dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_nomax_bodies_are_the_same_math_in_jax(tools, dtype):
    """attn_exp2's `nomax` and `nomax_bf16` bodies give the same bits, so the
    port runs both through one kernel mode."""
    jd, _ = _DT[dtype]
    q, k, v, _ = _inputs(2, 97, 5)
    with _interpret():
        a = tools["attn_exp2"].run(_j(q, jd), _j(k, jd), _j(v, jd), which="nomax")
        b = tools["attn_exp2"].run(_j(q, jd), _j(k, jd), _j(v, jd), which="nomax_bf16")
    np.testing.assert_array_equal(np.asarray(a.astype(jnp.float32)), np.asarray(b.astype(jnp.float32)))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("t_len,lengths", [(97, [97, 50]), (200, None)])
def test_flash_chunks_matches_attn_exp3(tools, t_len, lengths, dtype):
    jd, td = _DT[dtype]
    q, k, v, mask = _inputs(2, t_len, 6, lengths)
    with _interpret():
        want = tools["attn_exp3"].run_flash(_j(q, jd), _j(k, jd), _j(v, jd), _j(mask, jnp.float32))
    got = av.attention_flash_chunks(_t(q, td), _t(k, td), _t(v, td), _t(mask, torch.float32), n_heads=H)
    _close(got, want, dtype, mask)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("t_len", [97, 200])
def test_k_transposed_matches_attn_exp4(tools, t_len, dtype):
    jd, td = _DT[dtype]
    q, k, v, _ = _inputs(2, t_len, 7)
    kt = np.ascontiguousarray(k.transpose(0, 2, 1))
    with _interpret():
        want = tools["attn_exp4"].run_kt(_j(q, jd), _j(kt, jd), _j(v, jd))
    _close(av.attention_packed_kt(_t(q, td), _t(kt, td), _t(v, td), n_heads=H), want, dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("t_len,lengths", [(97, [97, 50]), (200, [131, 200])])
def test_batch_pair_matches_attn_exp5(tools, t_len, lengths, dtype):
    jd, td = _DT[dtype]
    q, k, v, mask = _inputs(2, t_len, 8, lengths)
    kbias = np.where(mask > 0, 0.0, _NEG).astype(np.float32)[:, None, :]
    with _interpret():
        want = tools["attn_exp5"].run_bpair(_j(q, jd), _j(k, jd), _j(v, jd), _j(kbias, jnp.float32))
    got = av.attention_batch_pair(_t(q, td), _t(k, td), _t(v, td), _t(kbias, torch.float32), n_heads=H)
    _close(got, want, dtype, mask)


def test_attn_tools_run_on_the_cpu():
    """The port's attention tools end to end on device="cpu" at (2, 97):
    every function runs through its plain version, every row is finite and
    within its bar of attention_packed (the matmul-only mode has no such
    bar), nothing is timed and no kernel is launched."""
    from stabletts_torch.tools import attn_bench, attn_exp

    names = list(attn_bench.VARIANTS)
    rows = attn_bench.main("cpu", 2, 97, names, iters=1)
    rows += attn_exp.main("cpu", 2, 97, iters=1)
    variant_rows = [r for r in rows if "rel_err" in r]
    assert len(variant_rows) == 1 + len(names) + 7
    for row in variant_rows:
        assert row["finite"] and row["ms"] is None and row["launches"] == {}
        assert row["rel_err"] is None if row["variant"] == "matmul" else row["rel_err"] <= row["bar"]
    assert [r["experiment"] for r in rows if "experiment" in r] == [
        "head_pair", "decompose", "decompose", "decompose", "flash_chunks", "k_transposed", "batch_pair"]


def test_variants_take_what_their_kernels_take():
    q = torch.zeros(2, 8, 256)
    with pytest.raises(ValueError, match="cpu or cuda"):
        av.attention_packed_v2(q.to("meta"), q.to("meta"), q.to("meta"))
    with pytest.raises(ValueError, match="which must be"):
        av.attention_decompose(q, q, q, which="softmax")
    with pytest.raises(ValueError, match="rotary_dim"):
        av.attention_packed_rope(q, q, q, rotary_dim=15)
    with pytest.raises(ValueError, match="rotary_dim"):
        av.rope_rotate_packed(q, q, rotary_dim=66)
    with pytest.raises(ValueError, match="kbias takes only"):
        av.attention_batch_pair(q, q, q, torch.full((2, 1, 8), -1.0))
    with pytest.raises(ValueError, match=r"\[B, 1, T\]"):
        av.attention_batch_pair(q, q, q, torch.zeros(2, 8))
    x = torch.from_numpy(np.random.default_rng(9).standard_normal((2, 8, 256)).astype(np.float32))
    assert torch.equal(av.attention_decompose(x, x, x, "nomax_bf16"), av.attention_decompose(x, x, x, "nomax"))
