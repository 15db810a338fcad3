"""Epoch-granular checkpoints in the reference's format and with its resume
semantics (reference: utils/load.py:7-43, train.py:91-93).

Each save writes `checkpoint_{epoch}.pt` (the model's state dict, with the
reference StableTTS names, so `StableTTSAPI(tts_model_path=...)` loads it)
and `optimizer_{epoch}.pt` (the optimizer's state dict). On resume the
newest epoch present with both is loaded and training starts at epoch + 1;
a model-only checkpoint is a pretrained init and training starts at epoch 0.
Vocos GAN training saves five parts per epoch under the reference's names
(`generator_`, `mpd_`, `mrd_`, `optimizerg_`, `optimizerd_{epoch}.pt`) and
resumes at the newest epoch that has all five.
"""

from __future__ import annotations

import os
import re

import torch

_CKPT_RE = re.compile(r"^checkpoint_(\d+)\.pt$")
_OPT_RE = re.compile(r"^optimizer_(\d+)\.pt$")


def _epochs(path: str, regex) -> set:
    if not os.path.isdir(path):
        return set()
    return {int(m.group(1)) for m in map(regex.match, os.listdir(path)) if m}


def save_checkpoint(ckpt_dir: str, epoch: int, model: torch.nn.Module, optimizer: torch.optim.Optimizer) -> None:
    os.makedirs(ckpt_dir, exist_ok=True)
    torch.save(model.state_dict(), os.path.join(ckpt_dir, f"checkpoint_{epoch}.pt"))
    torch.save(optimizer.state_dict(), os.path.join(ckpt_dir, f"optimizer_{epoch}.pt"))


def continue_training(ckpt_dir: str, model: torch.nn.Module, optimizer: torch.optim.Optimizer) -> int:
    """Load the newest resumable state into model and optimizer (in place)
    and return the epoch to start at."""
    model_epochs = _epochs(ckpt_dir, _CKPT_RE)
    common = model_epochs & _epochs(ckpt_dir, _OPT_RE)
    dev = next(model.parameters()).device
    load = lambda name: torch.load(os.path.join(ckpt_dir, name), map_location=dev, weights_only=True)
    if common:
        e = max(common)
        model.load_state_dict(load(f"checkpoint_{e}.pt"))
        optimizer.load_state_dict(load(f"optimizer_{e}.pt"))
        return e + 1
    if model_epochs:
        model.load_state_dict(load(f"checkpoint_{max(model_epochs)}.pt"))
    return 0


def optimizer_steps(optimizer: torch.optim.Optimizer) -> int:
    """Updates the optimizer has applied (its per-parameter step count, the
    counterpart of optax's schedule count); 0 for a fresh optimizer."""
    for state in optimizer.state.values():
        if "step" in state:
            return int(state["step"])
    return 0


_VOCOS_PARTS = ("generator", "mpd", "mrd", "optimizerd", "optimizerg")


def save_checkpoint_named(ckpt_dir: str, epoch: int, parts: dict) -> None:
    """Save named state dicts as `{name}_{epoch}.pt` (the Vocos protocol,
    reference vocoders/vocos/train.py:150-155)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    for name, state_dict in parts.items():
        torch.save(state_dict, os.path.join(ckpt_dir, f"{name}_{epoch}.pt"))


def continue_training_vocos(ckpt_dir: str, parts: dict) -> int:
    """Vocos resume semantics (reference: vocoders/vocos/utils/load.py:7-53).
    `parts` maps the five names (generator, mpd, mrd, optimizerd, optimizerg)
    to the modules and optimizers to load into, in place. The newest epoch
    that has all five files is restored and training starts at epoch + 1; a
    generator alone is a pretrained start at epoch 0. Returns the epoch to
    start at."""
    per_part = {p: _epochs(ckpt_dir, re.compile(rf"^{p}_(\d+)\.pt$")) for p in _VOCOS_PARTS}
    dev = next(parts["generator"].parameters()).device
    load = lambda name, e: torch.load(os.path.join(ckpt_dir, f"{name}_{e}.pt"), map_location=dev, weights_only=True)
    common = set.intersection(*per_part.values())
    if common:
        e = max(common)
        for name in _VOCOS_PARTS:
            parts[name].load_state_dict(load(name, e))
        return e + 1
    if per_part["generator"]:
        parts["generator"].load_state_dict(load("generator", max(per_part["generator"])))
    return 0
