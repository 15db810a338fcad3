"""Plain PyTorch reference of a StableTTS training step (KdaiP/StableTTS
train.py:39-96, models/model.py:114-178): the training forward with its
dropouts, monotonic alignment search, the duration, diffusion and prior
losses, autograd's backward and torch's AdamW under the cosine-warmup rate,
and the bucketed batches it trains on, re-derived from the raw files.

Dropout draws follow the trainer's generator in the published order of the
forward: the CFG mask, t and the noise; the style encoder's five dropouts;
then for each DiT block one 64-bit key for the attention weights and one for
the FFN activations, whose keep masks are Philox4x32-10 of each element's
coordinates (the counter layout the trainer's kernels use, written down
here again); the duration predictor's two dropouts in between. An element is
kept where its 32-bit word is >= rate * 2**32, and kept values are scaled by
1 / (1 - rate).
"""

from __future__ import annotations

import bisect
import json
import math
import os

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference import stabletts_ref as R

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF


# ---------------------------------------------------------------- Philox keep masks

def _mulhilo(a, m: int):
    a_lo, a_hi = a & 0xFFFF, a >> 16
    m_lo, m_hi = m & 0xFFFF, m >> 16
    ll, lh, hl, hh = a_lo * m_lo, a_lo * m_hi, a_hi * m_lo, a_hi * m_hi
    mid = (ll >> 16) + (lh & 0xFFFF) + (hl & 0xFFFF)
    return hh + (lh >> 16) + (hl >> 16) + (mid >> 16), ((mid & 0xFFFF) << 16) | (ll & 0xFFFF)


def philox4x32(c0, c1, c2, c3, key) -> torch.Tensor:
    k0, k1 = int(key[0]), int(key[1])
    c0, c1, c2, c3 = torch.broadcast_tensors(c0, c1, c2, c3)
    for _ in range(10):
        hi0, lo0 = _mulhilo(c0, _M0)
        hi1, lo1 = _mulhilo(c2, _M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _W0) & _MASK32, (k1 + _W1) & _MASK32
    return torch.stack([c0, c1, c2, c3], dim=-1)


def _keep(words, n: int, rate: float) -> torch.Tensor:
    thresh = min(int(rate * float(2 ** 32)), 2 ** 32 - 1)
    return (words.flatten(-2)[..., :n] >= thresh).float() / (1.0 - rate)


def attention_keep(key, b: int, h: int, t: int, rate: float) -> torch.Tensor:
    """[B, H, Tq, Tk]: counter (k // 4, q, b * H + h, 0), word k % 4."""
    ar = lambda n: torch.arange(n, device=key.device, dtype=torch.int64)
    c2 = (ar(b)[:, None] * h + ar(h)[None, :])[:, :, None, None]
    words = philox4x32(ar((t + 3) // 4)[None, None, None, :], ar(t)[None, None, :, None], c2,
                       torch.zeros((), device=key.device, dtype=torch.int64), key.tolist())
    return _keep(words, t, rate)


def ffn_keep(key, b: int, t: int, f: int, rate: float) -> torch.Tensor:
    """[B, T, F]: counter (f // 4, t, b, 1), word f % 4."""
    ar = lambda n: torch.arange(n, device=key.device, dtype=torch.int64)
    words = philox4x32(ar((f + 3) // 4)[None, None, :], ar(t)[None, :, None], ar(b)[:, None, None],
                       torch.ones((), device=key.device, dtype=torch.int64), key.tolist())
    return _keep(words, f, rate)


class Draws:
    """The trainer's generator, drawn from in the forward's order."""

    def __init__(self, gen: torch.Generator, device):
        self.gen, self.device = gen, device

    def rand(self, shape, dtype=None):
        return torch.rand(shape, generator=self.gen, device=self.device, dtype=dtype)

    def randn(self, shape, dtype=None):
        return torch.randn(shape, generator=self.gen, device=self.device, dtype=dtype)

    def key(self):
        return torch.randint(0, 2 ** 32, (2,), generator=self.gen, device=self.device, dtype=torch.int64)

    def dropout(self, x, p: float):
        return x * (self.rand(x.shape) >= p).to(x.dtype) / (1.0 - p)


# ---------------------------------------------------------------- the training forward

def dit_block_train(P, pre, x, c, mask, n_heads, rate, draws: Draws, p=R.F32):
    b, t, ch = x.shape
    m = mask[..., None]
    x = x * m
    mods = R.linear(F.silu(c), P[pre + "adaLN_modulation.2.weight"], P[pre + "adaLN_modulation.2.bias"], p)
    shift_a, scale_a, gate_a, shift_f, scale_f, gate_f = mods.view(b, 6, 1, ch).unbind(1)
    key_a = draws.key()
    h = F.layer_norm(x, (ch,), eps=1e-5) * (1 + scale_a) + shift_a
    proj = lambda z, name: R.conv_same(z, P[pre + f"attn.{name}.weight"], P[pre + f"attn.{name}.bias"], p)
    heads = lambda z: z.reshape(b, t, n_heads, ch // n_heads)
    q, k, v = R.rope(heads(proj(h, "conv_q"))), R.rope(heads(proj(h, "conv_k"))), heads(proj(h, "conv_v"))
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(ch // n_heads)
    logits = logits.masked_fill(mask[:, None, None, :] <= 0, float("-inf"))
    probs = torch.softmax(logits, dim=-1) * attention_keep(key_a, b, n_heads, t, rate)
    att = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, t, ch)
    x = x + gate_a * proj(att, "conv_o") * m
    key_f = draws.key()
    h = (F.layer_norm(x, (ch,), eps=1e-5) * (1 + scale_f) + shift_f) * m
    h = F.silu(R.conv_same(h, P[pre + "mlp.conv_1.weight"], P[pre + "mlp.conv_1.bias"], p))
    h = h * ffn_keep(key_f, b, t, h.shape[-1], rate) * m
    h = R.conv_same(h, P[pre + "mlp.conv_2.weight"], P[pre + "mlp.conv_2.bias"], p) * m
    return x + gate_f * h


def style_encoder_train(P, z, z_mask, p_drop, draws: Draws, p=R.F32):
    pre = "ref_encoder."
    mish = lambda v: v * torch.tanh(F.softplus(v))
    x = draws.dropout(mish(R.linear(z, P[pre + "spectral.0.weight"], P[pre + "spectral.0.bias"], p)), p_drop)
    x = draws.dropout(mish(R.linear(x, P[pre + "spectral.3.weight"], P[pre + "spectral.3.bias"], p)), p_drop)
    for i in range(2):
        h = R.conv_same(x, P[pre + f"temporal.{i}.conv1.weight"], P[pre + f"temporal.{i}.conv1.bias"], p)
        a, g = h.chunk(2, dim=-1)
        x = x + draws.dropout(a * torch.sigmoid(g), p_drop)
    b, t, c = x.shape
    qkv = R.linear(x, P[pre + "slf_attn.in_proj_weight"], P[pre + "slf_attn.in_proj_bias"], p)
    q, k, v = (u.reshape(b, t, 2, c // 2) for u in qkv.chunk(3, dim=-1))
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(c // 2)
    logits = logits.masked_fill(z_mask[:, None, None, :] <= 0, -torch.finfo(logits.dtype).max)
    probs = draws.dropout(torch.softmax(logits, dim=-1), p_drop)
    x = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, t, c)
    x = R.linear(x, P[pre + "slf_attn.out_proj.weight"], P[pre + "slf_attn.out_proj.bias"], p)
    x = R.linear(x, P[pre + "fc.weight"], P[pre + "fc.bias"], p)
    m = z_mask[..., None]
    return (x * m).sum(dim=1) / m.sum(dim=1)


def maximum_path(neg_cent: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Monotonic alignment search over [B, Ty, Tx] (the published numba
    kernel's semantics: its band, its tie-breaking, cells outside the band
    keeping their raw value, and the row read at y = 0 wrapping to the last
    row): a loop over mel rows, vectorised over the batch and the text."""
    neg = neg_cent.float()
    b, t_y, t_x = neg.shape
    dev = neg.device
    ys, xs_len = mask[:, :, 0].sum(1).long(), mask[:, 0, :].sum(1).long()
    xs = torch.arange(t_x, device=dev)
    batch = torch.arange(b, device=dev)
    prev = torch.zeros(b, t_x, device=dev)
    rows = []
    for y in range(t_y):
        v_cur = torch.where(xs[None, :] == y, torch.full_like(prev, -1e9), prev)
        edge = torch.full((b, 1), 0.0 if y == 0 else -1e9, device=dev)
        v_prev = torch.cat([edge, prev[:, :-1]], dim=1)
        lo = (xs_len + y - ys).clamp(min=0)[:, None]
        hi = xs_len.clamp(max=y + 1)[:, None]
        band = (xs[None, :] >= lo) & (xs[None, :] < hi)
        prev = torch.where(band, neg[:, y] + torch.maximum(v_prev, v_cur), neg[:, y])
        rows.append(prev)
    value = torch.stack(rows, dim=1)
    path = torch.zeros(b, t_y, t_x, device=dev)
    index = xs_len - 1
    for y in range(t_y - 1, -1, -1):
        active = (y < ys) & (index >= 0)
        path[batch[active], y, index[active]] = 1.0
        prev_row = value[:, (y - 1) % t_y]
        idx = index.clamp(min=0)
        move = (index != 0) & ((index == y) | (prev_row[batch, idx] < prev_row[batch, (idx - 1).clamp(min=0)])) & active
        index = index - move.long()
    return path


def losses(P, batch, cfg: dict, draws: Draws, p=R.F32):
    """(dur, diff, prior) of one training batch (x, x_lengths, y, y_lengths, z, z_lengths);
    `p` rounds the products' operands and results (the control)."""
    x, x_len, y, y_len, z, z_len = batch
    b = y.shape[0]
    y_mask, z_mask = R.seq_mask(y_len, y.shape[1]), R.seq_mask(z_len, z.shape[1])
    cfg_mask = (draws.rand((b, 1)) > cfg["cfg_dropout"]).float()
    t_rand = draws.rand((b,))
    noise = draws.randn(y.shape)
    c = style_encoder_train(P, z, z_mask, 0.25, draws, p)
    c = c * cfg_mask + (1 - cfg_mask) * P["fake_speaker"]
    H, n_heads, rate = cfg["hidden_channels"], cfg["n_heads"], cfg["p_dropout"]
    h = P["encoder.emb.weight"][x] * math.sqrt(H)
    x_mask = R.seq_mask(x_len, x.shape[1])
    for i in range(cfg["n_enc_layers"]):
        h = dit_block_train(P, f"encoder.encoder.{i}.", h, c, x_mask, n_heads, rate, draws, p)
    mu_x = R.conv_same(h, P["encoder.proj.weight"], P["encoder.proj.bias"], p) * x_mask[..., None]

    m = x_mask[..., None]
    hd = h.detach() + R.conv_same(c.detach()[:, None, :], P["dp.cond.weight"], P["dp.cond.bias"], p)
    for i in (1, 2):
        hd = torch.relu(R.conv_same(hd * m, P[f"dp.conv{i}.weight"], P[f"dp.conv{i}.bias"], p))
        hd = draws.dropout(F.layer_norm(hd, (hd.shape[-1],), P[f"dp.norm{i}.weight"], P[f"dp.norm{i}.bias"], eps=1e-5),
                           0.5)
    logw = R.conv_same(hd * m, P["dp.proj.weight"], P["dp.proj.bias"], p) * m

    n_mels = y.shape[-1]
    with torch.no_grad():
        neg_cent = (-0.5 * math.log(2 * math.pi) * n_mels - 0.5 * (y ** 2).sum(-1, keepdim=True)
                    + torch.matmul(y, mu_x.transpose(1, 2)) - 0.5 * (mu_x ** 2).sum(-1)[:, None, :])
        attn = maximum_path(neg_cent, y_mask[:, :, None] * x_mask[:, None, :])
    logw_ = torch.log(1e-8 + attn.sum(dim=1))[..., None] * m
    dur = ((logw - logw_) ** 2).sum() / x_len.sum()

    mu_y = torch.matmul(attn, mu_x)
    c3 = cfg_mask[..., None]
    mu_y = mu_y * c3 + (1 - c3) * P["fake_content"][:, :, 0][:, None, :]
    t = 1 - torch.cos(t_rand * 0.5 * math.pi)
    t3 = t[:, None, None]
    sigma_min = 1e-4
    yt = (1 - (1 - sigma_min) * t3) * noise + t3 * y
    u = y - (1 - sigma_min) * noise
    pred = estimator_train(P, t, yt, y_mask, mu_y, c, cfg, draws, p)
    diff = ((pred - u) ** 2).sum() / (y_mask.sum() * n_mels)
    prior = (0.5 * ((y - torch.matmul(attn, mu_x)) ** 2 + math.log(2 * math.pi)) * y_mask[..., None]).sum()
    prior = prior / (y_mask.sum() * n_mels)
    return dur, diff, prior


def estimator_train(P, t, x, mask, mu, c, cfg, draws: Draws, p=R.F32):
    pre = "decoder.estimator."
    te = R.timestep_embedding(t, cfg["hidden_channels"])
    te = R.linear(te, P[pre + "time_mlp.layer.0.weight"], P[pre + "time_mlp.layer.0.bias"], p)
    te = R.linear(F.silu(te), P[pre + "time_mlp.layer.2.weight"], P[pre + "time_mlp.layer.2.bias"], p)
    h = R.conv_same(torch.cat([x, R.prenet(P, mu, p)], dim=-1), P[pre + "in_proj.weight"],
                    P[pre + "in_proj.bias"], p)
    m = mask[..., None]
    n = cfg["n_dec_layers"]
    skips = []
    for i in range(n):
        if i < n // 2:
            skips.append(h)
        else:
            j = i - n // 2
            h = R.conv_same(torch.cat([h, skips.pop()], dim=-1), P[pre + f"lsc_layers.{j}.weight"],
                            P[pre + f"lsc_layers.{j}.bias"], p)
        bp = pre + f"blocks.{i}."
        film = R.linear(te, P[bp + "time_fusion.film.weight"][..., 0], P[bp + "time_fusion.film.bias"], p)
        gamma, beta = film[:, None, :].chunk(2, dim=-1)
        h = (gamma * h + beta) * m
        h = dit_block_train(P, bp + "block.", h, c, mask, cfg["n_heads"], cfg["p_dropout"], draws, p)
    return R.conv_same(h * m, P[pre + "final_proj.weight"], P[pre + "final_proj.bias"], p) * m


def lr_factor(step: int, warmup: int, total: int) -> float:
    """Linear warm-up from 0, then cosine decay to 0 (transformers' schedule)."""
    if step < warmup:
        return step / max(warmup, 1)
    progress = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
    return max(0.0, 0.5 * (1.0 + math.cos(math.pi * progress)))


# ---------------------------------------------------------------- the batches

def bucket_batches(lengths, batch_size: int, boundaries, epoch: int) -> list:
    """[(pad length, item indices)] of one epoch: buckets by mel length
    (boundaries[k] < length <= boundaries[k + 1]), each padded to a multiple
    of the batch by repeating its order, shuffled by the epoch's numpy seed."""
    bounds = list(boundaries)
    buckets = [[] for _ in range(len(bounds) - 1)]
    for idx, n in enumerate(lengths):
        i = bisect.bisect_left(bounds, n)
        if 0 < i < len(bounds):
            buckets[i - 1].append(idx)
    for i in range(len(buckets) - 1, -1, -1):
        if not buckets[i]:
            buckets.pop(i)
            bounds.pop(i + 1)
    g = np.random.default_rng(epoch)
    orders = [g.permutation(len(b)).tolist() for b in buckets]
    batches = []
    for i, bucket in enumerate(buckets):
        ids = orders[i]
        rem = (batch_size - len(bucket) % batch_size) % batch_size
        ids = ids + ids * (rem // len(bucket)) + ids[: rem % len(bucket)]
        for j in range(len(ids) // batch_size):
            batches.append((bounds[i + 1], [bucket[k] for k in ids[j * batch_size:(j + 1) * batch_size]]))
    order = g.permutation(len(batches))
    return [batches[k] for k in order]


def make_batch(records: list, indices, pad_mel: int, pad_text: int, n_mels: int, seed_prefix, symbols: dict):
    """The padded batch of `indices` from the raw files: mels, interspersed
    ids, and a reference slice of T/12 .. T/3 frames per item from
    default_rng(SeedSequence([*seed_prefix, index]))."""
    b = len(indices)
    z_len = -(-max(pad_mel // 3, 12) // 64) * 64
    x = np.zeros((b, pad_text), np.int64)
    xl = np.zeros(b, np.int64)
    y = np.zeros((b, pad_mel, n_mels), np.float32)
    yl = np.zeros(b, np.int64)
    z = np.zeros((b, z_len, n_mels), np.float32)
    zl = np.zeros(b, np.int64)
    for i, idx in enumerate(indices):
        rec = records[idx]
        mel = np.load(rec["mel_path"]).astype(np.float32)
        seq = [symbols[s] for s in rec["phone"] if s in symbols]
        ids = [0] * (2 * len(seq) + 1)
        ids[1::2] = seq
        tm, tt = min(mel.shape[0], pad_mel), min(len(ids), pad_text)
        y[i, :tm], yl[i] = mel[:tm], tm
        x[i, :tt], xl[i] = ids[:tt], tt
        rng = np.random.default_rng(np.random.SeedSequence([*seed_prefix, int(idx)]))
        sl = mel[:tm]
        if tm >= 12:
            seg = int(rng.integers(tm // 12, tm // 3 + 1))
            start = int(rng.integers(0, tm - seg + 1))
            sl = sl[start:start + seg]
        n = min(sl.shape[0], z_len)
        z[i, :n], zl[i] = sl[:n], n
    return x, xl, y, yl, z, zl


def symbols() -> list:
    """The published 401-symbol table."""
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "symbols.json"), encoding="utf-8") as f:
        return json.load(f)


def read_filelist(path: str) -> list:
    with open(path, encoding="utf-8") as f:
        return [json.loads(line) for line in f if line.strip()]
