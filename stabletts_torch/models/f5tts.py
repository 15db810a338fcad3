"""F5-TTS v1 Base: a DiT flow-matching TTS model that fills in the speech after
a prompt (reference: SWivid/F5-TTS src/f5_tts/model/cfm.py, backbones/dit.py,
modules.py, configs/F5TTS_v1_Base.yaml and infer/utils_infer.py).

The estimator runs on [noisy mel, prompt mel (zero past the prompt), text
embedding] over the prompt and the speech together: an input embedding
(Linear, then two grouped k=31 convs with Mish added back), 22 adaLN-Zero
DiT blocks with RoPE on every feature of each head and a GELU-tanh FFN, a
final adaLN and a projection to the mels. The text is characters embedded
at 512 (id + 1, 0 the filler), with absolute sinusoids and 4 ConvNeXt-V2
blocks (GRN), computed once a `prepare` for both CFG branches. Sampling:
the total frames from the prompt's frames and the text's bytes (the
byte-ratio rule), 32 Euler steps on the sway-sampled grid, CFG as
v + s (v - v_null) over one packed pass of 2B rows, the null branch without
prompt and text; the generated frames alone are returned.

Parameter names follow the published module tree
(`transformer.transformer_blocks.N.attn.to_q.weight`, ...), so a published
checkpoint's EMA weights, with their `ema_model.` prefix taken off, load by
`load_state_dict`. The blocks run through `ops.dit_block_cuda.dit_block`,
StableTTS's block kernel on the GPU (its plain version on the CPU), with q
and k's columns permuted once per head so that the interleaved rotary pairs
of x-transformers become the block's concatenated halves (`rope_permutation`).
The text blocks, the grouped convs and the small linears are library calls.

Departures from the published batch computation, each so that a batched
item equals the same item run alone (F5-TTS's own batch of one): padded
keys are masked in attention (v1 Base sets attn_mask_enabled false, which
lets padding keys into a padded batch); the grouped convs are masked
between the two convs as well as around them; the text blocks' GRN takes
its L2 norm over the item's own frames. Inference only.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from stabletts_torch.config import F5Config
from stabletts_torch.nn.blocks import sinusoidal_pos_emb
from stabletts_torch.ops.dit_block_cuda import DiTWeights, dit_block, packed_weights
from stabletts_torch.utils.device import resolve_device
from stabletts_torch.utils.metrics import count, span

TEXT_MAX_POS = 4096  # modules.py TextEmbedding.precompute_max_pos


def rope_permutation(heads: int, dim_head: int) -> torch.Tensor:
    """Column order [C] that puts each head's interleaved rotary pairs
    (2i, 2i + 1) at (i, i + D/2): x-transformers' rotation of the pairs is
    then the half-split rotation of the permuted columns, and q . k is
    unchanged because q and k are permuted alike."""
    head = torch.cat([torch.arange(0, dim_head, 2), torch.arange(1, dim_head, 2)])
    return torch.cat([h * dim_head + head for h in range(heads)])


def text_pos_table(dim: int, end: int = TEXT_MAX_POS) -> torch.Tensor:
    """modules.py precompute_freqs_cis: [end, dim], cos then sin of t * theta_i."""
    freqs = 1.0 / (10000.0 ** (torch.arange(0, dim, 2)[: dim // 2].float() / dim))
    ang = torch.outer(torch.arange(end), freqs).float()
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)


def sway_grid(n_steps: int, coef: float, device) -> torch.Tensor:
    """cfm.py's time grid: linspace(0, 1, n + 1) moved by
    coef * (cos(pi t / 2) - 1 + t), in f32."""
    t = torch.linspace(0.0, 1.0, n_steps + 1, dtype=torch.float32, device=device)
    return t + coef * (torch.cos(torch.pi / 2 * t) - 1 + t)


def total_frames(ref_frames: int, ref_bytes: int, gen_bytes: int, text_len: int, speed: float = 1.0,
                 max_duration: int = 4096) -> int:
    """The byte-ratio rule of infer/utils_infer.py, then cfm.py's floor (the
    text or the prompt plus one frame) and cap."""
    duration = ref_frames + int(ref_frames / ref_bytes * gen_bytes / speed)
    return min(max(max(text_len, ref_frames) + 1, duration), max_duration)


class GRN(nn.Module):
    """Global response normalisation over time (ConvNeXt-V2)."""

    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.zeros(1, 1, dim))
        self.beta = nn.Parameter(torch.zeros(1, 1, dim))

    def forward(self, x, frames=None):
        """x [B, T, C]; frames [B, T, 1] (1 on the item's own frames) or None."""
        gx = torch.norm(x if frames is None else x * frames, p=2, dim=1, keepdim=True)
        nx = gx / (gx.mean(dim=-1, keepdim=True) + 1e-6)
        return self.gamma * (x * nx) + self.beta + x


class ConvNeXtV2Block(nn.Module):
    def __init__(self, dim: int, intermediate_dim: int):
        super().__init__()
        self.dwconv = nn.Conv1d(dim, dim, 7, padding=3, groups=dim)
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.pwconv1 = nn.Linear(dim, intermediate_dim)
        self.grn = GRN(intermediate_dim)
        self.pwconv2 = nn.Linear(intermediate_dim, dim)

    def forward(self, x, frames=None):
        h = self.norm(self.dwconv(x.transpose(1, 2)).transpose(1, 2))
        return x + self.pwconv2(self.grn(F.gelu(self.pwconv1(h)), frames))


class TextEmbedding(nn.Module):
    def __init__(self, text_num_embeds: int, text_dim: int, conv_layers: int):
        super().__init__()
        self.text_embed = nn.Embedding(text_num_embeds + 1, text_dim)  # 0 is the filler
        self.register_buffer("freqs_cis", text_pos_table(text_dim), persistent=False)
        self.text_blocks = nn.ModuleList(ConvNeXtV2Block(text_dim, 2 * text_dim) for _ in range(conv_layers))

    def forward(self, ids1, frames, drop_text: bool = False):
        """ids1 [B, T] (id + 1 on the text, 0 past it) over the mel's T frames;
        frames [B, T, 1] the item's own frames -> [B, T, text_dim], zero past
        the text. drop_text: the null branch (every id the filler)."""
        keep = (ids1 != 0)[..., None]
        h = self.text_embed(torch.zeros_like(ids1) if drop_text else ids1)
        pos = torch.arange(ids1.shape[1], device=ids1.device).clamp(max=TEXT_MAX_POS - 1)
        h = (h + self.freqs_cis[pos].to(h.dtype)) * keep
        for block in self.text_blocks:
            h = block(h, frames) * keep
        return h


class ConvPositionEmbedding(nn.Module):
    def __init__(self, dim: int, kernel_size: int, groups: int):
        super().__init__()
        self.conv1d = nn.Sequential(
            nn.Conv1d(dim, dim, kernel_size, groups=groups, padding=kernel_size // 2), nn.Mish(),
            nn.Conv1d(dim, dim, kernel_size, groups=groups, padding=kernel_size // 2), nn.Mish(),
        )

    def forward(self, x, m):
        """x [B, T, C]; m [B, T, 1] the frame mask, applied before, between and after the convs."""
        c0, a0, c2, a2 = self.conv1d
        h = a0(c0((x * m).transpose(1, 2))).transpose(1, 2) * m
        return a2(c2(h.transpose(1, 2))).transpose(1, 2) * m


class InputEmbedding(nn.Module):
    def __init__(self, mel_dim: int, text_dim: int, out_dim: int, kernel_size: int, groups: int):
        super().__init__()
        self.proj = nn.Linear(2 * mel_dim + text_dim, out_dim)
        self.conv_pos_embed = ConvPositionEmbedding(out_dim, kernel_size, groups)

    def forward(self, x, cond, text, m):
        h = self.proj(torch.cat([x, cond, text], dim=-1))
        return self.conv_pos_embed(h, m) + h


class TimestepEmbedding(nn.Module):
    """Sinusoids of 1000 t (freq_embed_dim of them), then Linear-SiLU-Linear."""

    def __init__(self, dim: int, freq_embed_dim: int):
        super().__init__()
        self.freq_embed_dim = freq_embed_dim
        self.time_mlp = nn.Sequential(nn.Linear(freq_embed_dim, dim), nn.SiLU(), nn.Linear(dim, dim))

    def forward(self, t):
        return self.time_mlp(sinusoidal_pos_emb(t, self.freq_embed_dim, scale=1000.0))


class RotaryEmbedding(nn.Module):
    """x-transformers' RotaryEmbedding: its `inv_freq` is a buffer of the
    published state dict. The block computes its tables itself
    (`ops.dit_block_cuda.rope_tables` at the head's whole width: the same
    frequencies)."""

    def __init__(self, dim_head: int):
        super().__init__()
        self.register_buffer("inv_freq", 1.0 / (10000.0 ** (torch.arange(0, dim_head, 2).float() / dim_head)))


class AdaLayerNorm(nn.Module):
    def __init__(self, dim: int, n: int):
        super().__init__()
        self.linear = nn.Linear(dim, n * dim)


class Attention(nn.Module):
    def __init__(self, dim: int, inner_dim: int):
        super().__init__()
        self.to_q = nn.Linear(dim, inner_dim)
        self.to_k = nn.Linear(dim, inner_dim)
        self.to_v = nn.Linear(dim, inner_dim)
        self.to_out = nn.ModuleList([nn.Linear(inner_dim, dim), nn.Dropout(0.0)])


class FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int):
        super().__init__()
        inner = dim * mult
        self.ff = nn.Sequential(nn.Sequential(nn.Linear(dim, inner), nn.GELU(approximate="tanh")), nn.Dropout(0.0),
                                nn.Linear(inner, dim))


class DiTBlock(nn.Module):
    """adaLN-Zero block: attention with RoPE on each whole head, then the
    GELU-tanh FFN, LayerNorms without affine at eps 1e-6. One `dit_block`
    call on the kernel-layout weights."""

    def __init__(self, dim: int, heads: int, dim_head: int, ff_mult: int):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        self.attn_norm = AdaLayerNorm(dim, 6)
        self.attn = Attention(dim, heads * dim_head)
        self.ff = FeedForward(dim, ff_mult)
        self._packed = None

    def kernel_weights(self) -> DiTWeights:
        """Kernel-layout copies, q and k's columns in `rope_permutation`'s
        order (see `packed_weights`)."""
        a, lin1, lin2 = self.attn, self.ff.ff[0][0], self.ff.ff[2]

        def pack():
            perm = rope_permutation(self.heads, self.dim_head).to(a.to_q.weight.device)
            return (torch.cat([a.to_q.weight[perm].t(), a.to_k.weight[perm].t(), a.to_v.weight.t()], dim=1),
                    torch.cat([a.to_q.bias[perm], a.to_k.bias[perm], a.to_v.bias]), a.to_out[0].weight.t(),
                    a.to_out[0].bias, lin1.weight.t()[None], lin1.bias, lin2.weight.t()[None], lin2.bias)

        return packed_weights(self, (a.to_q, a.to_k, a.to_v, a.to_out[0], lin1, lin2), pack)

    def forward(self, x, t, mask):
        """x [B, T, C] (zero on padded rows, which the block keeps so); t [B, C]
        the time embedding; mask [B, T]."""
        b, _, c = x.shape
        mods = self.attn_norm.linear(F.silu(t)).view(b, 6, c)
        return dit_block(x.contiguous(), mods.contiguous(), mask, self.kernel_weights(), self.heads, 1e-6,
                         self.dim_head, "gelu_tanh")


class AdaLayerNormFinal(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.linear = nn.Linear(dim, 2 * dim)

    def forward(self, x, t):
        scale, shift = self.linear(F.silu(t)).chunk(2, dim=-1)
        return F.layer_norm(x, (x.shape[-1],), eps=1e-6) * (1 + scale)[:, None, :] + shift[:, None, :]


class DiT(nn.Module):
    def __init__(self, cfg: F5Config):
        super().__init__()
        self.time_embed = TimestepEmbedding(cfg.dim, cfg.freq_embed_dim)
        self.text_embed = TextEmbedding(cfg.text_num_embeds, cfg.text_dim, cfg.conv_layers)
        self.input_embed = InputEmbedding(cfg.mel_dim, cfg.text_dim, cfg.dim, cfg.conv_pos_kernel,
                                          cfg.conv_pos_groups)
        self.rotary_embed = RotaryEmbedding(cfg.dim_head)
        self.transformer_blocks = nn.ModuleList(DiTBlock(cfg.dim, cfg.heads, cfg.dim_head, cfg.ff_mult)
                                                for _ in range(cfg.depth))
        self.norm_out = AdaLayerNormFinal(cfg.dim)
        self.proj_out = nn.Linear(cfg.dim, cfg.mel_dim)

    def forward(self, h, t, mask):
        """The blocks and the output layer on the input embedding h [R, T, C]."""
        te = self.time_embed(t)
        for block in self.transformer_blocks:
            h = block(h, te, mask)
        return self.proj_out(self.norm_out(h, te))


class F5TTS(nn.Module):
    """cfm.py's CFM around the DiT, for the port's sampler
    (`models/sampler.py`: `prepare` calls `prepare_synthesis`, `sample` calls
    `flow_condition`, `flow_rows`, `time_grid`, `flow_velocity`
    and `flow_output`)."""

    def __init__(self, cfg: F5Config | None = None, device=None):
        super().__init__()
        self.cfg = cfg or F5Config()
        self.transformer = DiT(self.cfg)
        self.to(resolve_device(device))
        self.eval()

    def prepare_synthesis(self, x, x_lengths, y_ref, max_mel_len: int, length_scale: float = 1.0, y_ref_mask=None,
                          clip_len=None, x_ref_lengths=None) -> dict:
        """Text ids x [B, Tx] (the prompt's text then the text to speak, the
        first x_lengths of each row), prompt mels y_ref [B, Tref, n_mels] with
        their frames marked by y_ref_mask (all of Tref where None), and
        x_ref_lengths [B] the ids of the prompt's text (its bytes: the rule
        counts UTF-8 bytes, one id each for the characters it is given) ->
        the flow's conditioning over T = the longest total. Each total is
        `total_frames` at speed 1 / length_scale, capped at clip_len
        (default the configuration's max_duration); max_mel_len is unused.
        Reads the lengths on the host: T sets the shapes."""
        if x_ref_lengths is None:
            raise ValueError("F5TTS.prepare_synthesis needs x_ref_lengths, the ids of the prompt's text")
        b, dev = x.shape[0], x.device
        ref = (y_ref_mask > 0).sum(1) if y_ref_mask is not None else torch.full((b,), y_ref.shape[1], device=dev)
        cap = clip_len or self.cfg.max_duration
        refs, xls, rbs = (v.tolist() for v in torch.stack([ref.long(), x_lengths.long(), x_ref_lengths.long()]).cpu())
        raw = [total_frames(r, rb, xl - rb, xl, 1.0 / length_scale, 1 << 62) for r, xl, rb in zip(refs, xls, rbs)]
        totals = [min(n, cap) for n in raw]
        t_len = max(totals)
        pos = torch.arange(t_len, device=dev)
        y_lengths = torch.tensor(totals, dtype=torch.int32, device=dev)
        frames = (pos[None, :] < y_lengths[:, None])
        dtype = self.transformer.proj_out.weight.dtype
        cond = F.pad(y_ref.to(dtype), (0, 0, 0, max(0, t_len - y_ref.shape[1])))[:, :t_len]
        cond = cond * (pos[None, :] < ref[:, None])[..., None].to(dtype)
        xs = x[:, :t_len]
        ids1 = torch.where(torch.arange(xs.shape[1], device=dev)[None, :] < x_lengths[:, None], xs + 1, 0)
        ids1 = F.pad(ids1, (0, t_len - ids1.shape[1]))
        fm = frames[..., None].to(dtype)
        with span("f5.text_embed"):
            te = self.transformer.text_embed
            text = torch.cat([te(ids1, fm), te(ids1, fm, drop_text=True)], dim=0)
        gen = [n - r for n, r in zip(totals, refs)]
        return {"y_lengths": y_lengths, "y_clamped": torch.tensor([n > cap for n in raw], device=dev),
                "y_mask": frames.to(dtype), "ref_lengths": ref.long(), "cond": cond, "text": text,
                "gen_lengths": torch.tensor(gen, dtype=torch.int32, device=dev), "gen_max": max(gen)}

    def flow_condition(self, prep: dict, cfg: float) -> dict:
        """What every step of one ODE pass shares: the packed rows' prompt
        mels (zero in the null branch), text embeddings and masks. CFG is on
        where cfg_strength >= 1e-5, as in cfm.py."""
        count("f5.prompt_frames", prep["ref_lengths"])
        cond, mask, text = prep["cond"], prep["y_mask"], prep["text"]
        b = cond.shape[0]
        if cfg >= 1e-5:
            cond, mask = torch.cat([cond, torch.zeros_like(cond)]), torch.cat([mask, mask])
        else:
            text = text[:b]
        return {"cond": cond, "text": text, "mask": mask, "m": mask[..., None], "cfg_on": cfg >= 1e-5}

    frame_quantum = 1  # the frames run at each batch's longest total, to the frame

    def flow_rows(self, cond: dict, rows, frames: int) -> dict:
        """`flow_condition`'s output for the items `rows` (an index tensor)
        over their first `frames` frames: rows r and B + r of the packed
        CFG branches."""
        branches = 2 if cond["cfg_on"] else 1
        b = cond["mask"].shape[0] // branches
        packed = torch.cat([rows + i * b for i in range(branches)])
        return {**{k: cond[k][packed, :frames] for k in ("cond", "text", "mask", "m")}, "cfg_on": cond["cfg_on"]}

    def time_grid(self, n_steps: int, device) -> torch.Tensor:
        return sway_grid(n_steps, self.cfg.sway_sampling_coef, device)

    def flow_velocity(self, cond: dict, t, xt, cfg: float):
        """v + cfg (v - v_null) from one pass over the packed [2B] rows (v alone without CFG)."""
        x = torch.cat([xt, xt]) if cond["cfg_on"] else xt
        with span("f5.input_embed"):
            h = self.transformer.input_embed(x, cond["cond"], cond["text"], cond["m"]) * cond["m"]
        out = self.transformer(h, t.expand(x.shape[0]).to(xt.dtype), cond["mask"])
        if not cond["cfg_on"]:
            return out
        v, v_null = out.chunk(2)
        return v + (v - v_null) * cfg

    def flow_output(self, prep: dict, mel) -> dict:
        """The generated frames of each item, from its prompt's end:
        decoder_outputs [B, longest generation, n_mels] (float32, zero past
        y_lengths), y_lengths the generated frames, total_lengths and
        ref_lengths the prompt's and the whole sequence's."""
        ref, gen = prep["ref_lengths"], prep["gen_lengths"]
        j = torch.arange(prep["gen_max"], device=mel.device)
        idx = (ref[:, None] + j[None, :]).clamp(max=mel.shape[1] - 1)
        out = mel.gather(1, idx[..., None].expand(-1, -1, mel.shape[-1]))
        valid = (j[None, :] < gen[:, None])
        return {"decoder_outputs": (out * valid[..., None].to(out.dtype)).float(), "y_lengths": gen,
                "y_clamped": prep["y_clamped"], "total_lengths": prep["y_lengths"], "ref_lengths": ref,
                "y_mask": valid.float()}
