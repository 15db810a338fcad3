"""Weights across packages: JAX param trees -> the port's state dicts, and
reference `.pt` files -> state dicts.

The port's modules use the reference StableTTS / Vocos torch state-dict names
and layouts, so both routes end in `model.load_state_dict`. The JAX trees are
nested dicts of numpy arrays (flax layouts):

  flax dense kernel [in, out]    -> torch Linear [out, in] / Conv1d k=1 [out, in, 1]
  flax conv kernel [k, in, out]  -> torch Conv1d [out, in, k]
  flax LayerNorm scale/bias      -> weight/bias
  q/k/v dense kernels            -> packed MHA in_proj_weight [3C, C]
  transposed-conv kernel [k, in, out] -> torch ConvTranspose1d [in, out, k]

The GAN discriminators keep weight norm apart, as the reference does: flax
`WeightNorm_*/<conv>/kernel/scale` -> `<conv>.parametrizations.weight.original0`
(g, [out, 1, 1, 1]) and the conv's kernel [kh, kw, in, out] ->
`.original1` (v, [out, in, kh, kw]); `jax_params_from_discriminator` is the
inverse.

FireflyGAN checkpoints store weight-normed convs as (weight_g, weight_v) or as
parametrizations.weight.original0/1; `load_ffgan_state_dict` folds them into
plain weights, which is what the port's `FireflyGANBase` holds.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

# buffers the reference modules register but recompute (rotary caches, the
# ISTFT window) and BatchNorm counters: not parameters of the port
_BUFFER_MARKERS = ("rotary", "num_batches", "window")


def _t_linear(out: Dict[str, np.ndarray], prefix: str, d: dict):
    """flax dense {kernel [in,out], bias?} -> torch Linear weight [out,in]."""
    out[f"{prefix}.weight"] = np.ascontiguousarray(d["kernel"].T)
    if "bias" in d:
        out[f"{prefix}.bias"] = d["bias"]


def _t_conv1x1(out: Dict[str, np.ndarray], prefix: str, d: dict):
    """flax dense -> torch Conv1d k=1 weight [out,in,1]."""
    out[f"{prefix}.weight"] = np.ascontiguousarray(d["kernel"].T)[..., None]
    if "bias" in d:
        out[f"{prefix}.bias"] = d["bias"]


def _t_conv(out: Dict[str, np.ndarray], prefix: str, d: dict):
    """flax conv {kernel [k,in,out]} -> torch Conv1d weight [out,in,k]."""
    out[f"{prefix}.weight"] = np.ascontiguousarray(np.transpose(d["kernel"], (2, 1, 0)))
    if "bias" in d:
        out[f"{prefix}.bias"] = d["bias"]


def _t_ln(out: Dict[str, np.ndarray], prefix: str, d: dict):
    out[f"{prefix}.weight"] = d["scale"]
    out[f"{prefix}.bias"] = d["bias"]


def _export_dit_block(out: Dict[str, np.ndarray], p: str, blk: dict):
    for name in ("conv_q", "conv_k", "conv_v", "conv_o"):
        _t_conv1x1(out, f"{p}.attn.{name}", blk["attn"][name])
    _t_conv(out, f"{p}.mlp.conv_1", blk["mlp"]["conv_1"])
    _t_conv(out, f"{p}.mlp.conv_2", blk["mlp"]["conv_2"])
    if "adaLN_proj" in blk:
        _t_linear(out, f"{p}.adaLN_modulation.0", blk["adaLN_proj"])
    _t_linear(out, f"{p}.adaLN_modulation.2", blk["adaLN_modulation"])


def _export_mel_style_encoder(out: Dict[str, np.ndarray], p: str, enc: dict):
    _t_linear(out, f"{p}.spectral.0", enc["spectral_0"])
    _t_linear(out, f"{p}.spectral.3", enc["spectral_3"])
    _t_conv(out, f"{p}.temporal.0.conv1", enc["temporal_0"]["conv1"])
    _t_conv(out, f"{p}.temporal.1.conv1", enc["temporal_1"]["conv1"])
    attn = enc["slf_attn"]
    out[f"{p}.slf_attn.in_proj_weight"] = np.ascontiguousarray(
        np.concatenate([attn["q_proj"]["kernel"].T, attn["k_proj"]["kernel"].T,
                        attn["v_proj"]["kernel"].T], axis=0)
    )
    out[f"{p}.slf_attn.in_proj_bias"] = np.concatenate(
        [attn["q_proj"]["bias"], attn["k_proj"]["bias"], attn["v_proj"]["bias"]]
    )
    _t_linear(out, f"{p}.slf_attn.out_proj", attn["out_proj"])
    _t_linear(out, f"{p}.fc", enc["fc"])


def state_dict_from_jax_stabletts(params: dict, n_enc_layers=3, n_dec_layers=6) -> Dict[str, torch.Tensor]:
    """JAX StableTTS params (the `params` collection) -> the port's
    `StableTTS` state dict (float32 CPU tensors)."""
    out: Dict[str, np.ndarray] = {}
    out["fake_speaker"] = np.asarray(params["fake_speaker"])
    out["fake_content"] = np.asarray(params["fake_content"])[..., None]  # [1,C] -> [1,C,1]

    enc = params["encoder"]
    out["encoder.emb.weight"] = np.asarray(enc["emb"]["embedding"])
    _t_conv1x1(out, "encoder.proj", enc["proj"])
    for i in range(n_enc_layers):
        _export_dit_block(out, f"encoder.encoder.{i}", enc[f"encoder_{i}"])

    _export_mel_style_encoder(out, "ref_encoder", params["ref_encoder"])

    dp = params["dp"]
    _t_conv1x1(out, "dp.cond", dp["cond"])
    _t_conv(out, "dp.conv1", dp["conv1"])
    _t_ln(out, "dp.norm1", dp["norm1"])
    _t_conv(out, "dp.conv2", dp["conv2"])
    _t_ln(out, "dp.norm2", dp["norm2"])
    _t_conv1x1(out, "dp.proj", dp["proj"])

    est = params["decoder"]["estimator"]
    _t_linear(out, "decoder.estimator.time_mlp.layer.0", est["time_mlp"]["layer_0"])
    _t_linear(out, "decoder.estimator.time_mlp.layer.2", est["time_mlp"]["layer_2"])
    for j in (0, 2, 4):
        _t_conv(out, f"decoder.estimator.cond_proj.{j}", est[f"cond_proj_{j}"])
    _t_conv1x1(out, "decoder.estimator.in_proj", est["in_proj"])
    _t_conv1x1(out, "decoder.estimator.final_proj", est["final_proj"])
    for i in range(n_dec_layers):
        blk = est[f"blocks_{i}"]
        _t_conv1x1(out, f"decoder.estimator.blocks.{i}.time_fusion.film",
                   blk["time_fusion"]["film"])
        _export_dit_block(out, f"decoder.estimator.blocks.{i}.block", blk["block"])
    for j in range(n_dec_layers // 2):
        _t_conv(out, f"decoder.estimator.lsc_layers.{j}", est[f"lsc_{j}"])
    return _tensors(out)


def state_dict_from_jax_vocos(params: dict, num_layers=8) -> Dict[str, torch.Tensor]:
    """JAX Vocos params -> the port's `Vocos` state dict (float32 CPU tensors)."""
    out: Dict[str, np.ndarray] = {}
    bb = params["backbone"]
    _t_conv(out, "backbone.embed", bb["embed"])
    _t_ln(out, "backbone.norm", bb["norm"])
    _t_ln(out, "backbone.final_layer_norm", bb["final_layer_norm"])
    for i in range(num_layers):
        blk = bb[f"convnext_{i}"]
        p = f"backbone.convnext.{i}"
        _t_conv(out, f"{p}.dwconv", blk["dwconv"])
        _t_ln(out, f"{p}.norm", blk["norm"])
        _t_linear(out, f"{p}.pwconv1", blk["pwconv1"])
        _t_linear(out, f"{p}.pwconv2", blk["pwconv2"])
        out[f"{p}.gamma"] = np.asarray(blk["gamma"])
    _t_linear(out, "head.out", params["head"]["out"])
    return _tensors(out)


_FFGAN_DEPTHS = (3, 3, 9, 3)


def state_dict_from_jax_ffgan(params: dict) -> Dict[str, torch.Tensor]:
    """JAX FireflyGANBase params -> the port's `FireflyGANBase` state dict
    (float32 CPU tensors; reference names, weight norm folded)."""
    out: Dict[str, np.ndarray] = {}
    bb = params["backbone"]
    _t_conv(out, "backbone.downsample_layers.0.0", bb["stem_conv"])
    _t_ln(out, "backbone.downsample_layers.0.1", bb["stem_norm"])
    _t_ln(out, "backbone.norm", bb["norm"])
    for i in range(1, len(_FFGAN_DEPTHS)):
        _t_ln(out, f"backbone.downsample_layers.{i}.0", bb[f"mid_norm_{i}"])
        _t_conv1x1(out, f"backbone.downsample_layers.{i}.1", bb[f"mid_conv_{i}"])
    for i, depth in enumerate(_FFGAN_DEPTHS):
        for j in range(depth):
            blk, p = bb[f"stages_{i}_{j}"], f"backbone.stages.{i}.{j}"
            _t_conv(out, f"{p}.dwconv", blk["dwconv"])
            _t_ln(out, f"{p}.norm", blk["norm"])
            _t_linear(out, f"{p}.pwconv1", blk["pwconv1"])
            _t_linear(out, f"{p}.pwconv2", blk["pwconv2"])
            out[f"{p}.gamma"] = np.asarray(blk["gamma"])
    head = params["head"]
    _t_conv(out, "head.conv_pre", head["conv_pre"])
    _t_conv(out, "head.conv_post", head["conv_post"])
    for i in range(5):
        # [k, C_in, C_out] -> ConvTranspose1d [C_in, C_out, k]
        out[f"head.ups.{i}.weight"] = np.ascontiguousarray(np.transpose(head[f"ups_{i}_kernel"], (1, 2, 0)))
        out[f"head.ups.{i}.bias"] = head[f"ups_{i}_bias"]
        for j in range(3):
            blk = head[f"resblocks_{i}"][f"blocks_{j}"]
            for name in ("convs1", "convs2"):
                for m in range(3):
                    _t_conv(out, f"head.resblocks.{i}.blocks.{j}.{name}.{m}",
                            {"kernel": blk[f"{name}_{m}_kernel"], "bias": blk[f"{name}_{m}_bias"]})
    return _tensors(out)


def _conv_names(name: str) -> str:
    """flax conv name -> the port's module path: convs_3 -> convs.3,
    band_convs_2_4 -> band_convs.2.4, conv_post -> conv_post."""
    if name == "conv_post":
        return name
    head, *idx = name.rsplit("_", 2 if name.startswith("band_convs") else 1)
    return ".".join([head, *idx])


def _export_discriminator(out: Dict[str, np.ndarray], prefix: str, d: dict) -> None:
    """One flax DiscriminatorP / DiscriminatorR (built with weight norm)."""
    scales = {}
    for key, entry in d.items():
        if key.startswith("WeightNorm_"):
            for path, scale in entry.items():
                conv_name, _, _ = path.rsplit("/", 2)
                scales[conv_name] = np.asarray(scale)
    for name, conv in d.items():
        if name.startswith("WeightNorm_"):
            continue
        p = f"{prefix}{_conv_names(name)}"
        out[f"{p}.bias"] = np.asarray(conv["bias"])
        out[f"{p}.parametrizations.weight.original0"] = scales[name].reshape(-1, 1, 1, 1)
        out[f"{p}.parametrizations.weight.original1"] = np.ascontiguousarray(
            np.transpose(np.asarray(conv["kernel"]), (3, 2, 0, 1)))


def _state_dict_from_jax_discriminators(params: dict) -> Dict[str, torch.Tensor]:
    out: Dict[str, np.ndarray] = {}
    for key, d in params.items():
        _export_discriminator(out, f"discriminators.{key.rsplit('_', 1)[1]}.", d)
    return _tensors(out)


def state_dict_from_jax_mpd(params: dict) -> Dict[str, torch.Tensor]:
    """JAX MultiPeriodDiscriminator params -> the port's state dict (the
    reference Vocos names; g and v kept apart)."""
    return _state_dict_from_jax_discriminators(params)


def state_dict_from_jax_mrd(params: dict) -> Dict[str, torch.Tensor]:
    """JAX MultiResolutionDiscriminator params -> the port's state dict."""
    return _state_dict_from_jax_discriminators(params)


def jax_params_from_discriminator(state_dict: dict) -> dict:
    """The inverse of `state_dict_from_jax_mpd` / `_mrd`: the port's MPD or
    MRD state dict -> the flax param tree (numpy), with the WeightNorm_i
    entries numbered in the modules' conv order."""
    tree: dict = {}
    order: dict = {}
    for key, value in state_dict.items():
        parts = key.split(".")
        disc = f"discriminators_{parts[1]}"
        if parts[2] == "conv_post":
            conv, rest = "conv_post", parts[3:]
        elif parts[2] == "convs":
            conv, rest = f"convs_{parts[3]}", parts[4:]
        else:
            conv, rest = f"band_convs_{parts[3]}_{parts[4]}", parts[5:]
        value = np.asarray(value)
        node = tree.setdefault(disc, {})
        order.setdefault(disc, [])
        if conv not in order[disc]:
            order[disc].append(conv)
        if rest == ["bias"]:
            node.setdefault(conv, {})["bias"] = value
        elif rest[-1] == "original1":
            node.setdefault(conv, {})["kernel"] = np.ascontiguousarray(np.transpose(value, (2, 3, 1, 0)))
        else:
            node.setdefault("_scales", {})[conv] = value.reshape(-1)
    for disc, node in tree.items():
        scales = node.pop("_scales")
        convs = sorted((c for c in order[disc] if c != "conv_post"),
                       key=lambda c: tuple(int(i) for i in c.split("_")[-2:] if i.isdigit())) + ["conv_post"]
        for i, conv in enumerate(convs):
            node[f"WeightNorm_{i}"] = {f"{conv}/kernel/scale": scales[conv]}
    return tree


def load_discriminator_state_dict(state_dict: dict) -> Dict[str, torch.Tensor]:
    """A reference MPD / MRD state dict -> the port's: weight norm stored the
    old way (`weight_g`, `weight_v`) is renamed to
    `parametrizations.weight.original0/1`; nothing is folded."""
    rename = {".weight_g": ".parametrizations.weight.original0", ".weight_v": ".parametrizations.weight.original1"}
    out: Dict[str, torch.Tensor] = {}
    for key, value in state_dict.items():
        for old, new in rename.items():
            if key.endswith(old):
                key = key[: -len(old)] + new
        out[key] = torch.as_tensor(np.asarray(value) if not isinstance(value, torch.Tensor) else value).float()
    return out


def fold_weight_norm(g: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """w = g * v / ||v||, the norm over every dim but 0 (torch weight_norm's
    default dim=0)."""
    norm = v.float().square().sum(dim=tuple(range(1, v.ndim)), keepdim=True).sqrt()
    return (g.float() * v.float() / norm).float()


def load_ffgan_state_dict(state_dict: dict) -> Dict[str, torch.Tensor]:
    """A FireflyGAN generator state dict in the reference format -> the port's
    `FireflyGANBase` state dict: every weight-normed conv, stored as
    (`weight_g`, `weight_v`) or as `parametrizations.weight.original0/1`, is
    folded into a plain `weight`; BatchNorm counters are dropped."""
    pairs = ((".weight_g", ".weight_v"), (".parametrizations.weight.original0", ".parametrizations.weight.original1"))
    sd = {k: torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v) for k, v in state_dict.items()}
    out: Dict[str, torch.Tensor] = {}
    for key, value in sd.items():
        if "num_batches" in key:
            continue
        for g_suffix, v_suffix in pairs:
            if key.endswith(g_suffix):
                prefix = key[: -len(g_suffix)]
                out[f"{prefix}.weight"] = fold_weight_norm(value, sd[prefix + v_suffix])
                break
            if key.endswith(v_suffix):
                break
        else:
            out[key] = value.float()
    return out


def _tensors(state_dict: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, dtype=np.float32, copy=True)) for k, v in state_dict.items()}


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """Reference `.pt` checkpoint -> float32 CPU state dict, unwrapping the
    common {'state_dict': ...} container and dropping recomputed buffers."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return {
        k: v.float() for k, v in sd.items()
        if not any(marker in k for marker in _BUFFER_MARKERS)
    }
