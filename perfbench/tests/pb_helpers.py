"""Shared by the benchmark's CPU tests: a copy of the benchmark in a
temporary directory with the cells cut to a size the CPU runs in seconds."""

from __future__ import annotations

import json
import os
import shutil
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

TINY_MODEL = {"hidden_channels": 64, "filter_channels": 128, "n_heads": 2, "n_enc_layers": 1, "n_dec_layers": 2,
              "gin_channels": 64, "n_timesteps": 2, "max_mel_len": 256,
              "vocoder": {"name": "vocos", "dim": 32, "intermediate_dim": 64, "num_layers": 2}}


def tiny_copy(tmp_path, traffic: dict = None) -> str:
    """A checkout-like root holding BENCHMARK.json and perfbench/, every
    configuration at TINY_MODEL's widths and every workload's traffic updated
    with `traffic[cell]`; returns the root."""
    root = str(tmp_path / "root")
    shutil.copytree(os.path.join(REPO, "perfbench"), os.path.join(root, "perfbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    for name in os.listdir(os.path.join(root, "perfbench", "configs")):
        path = os.path.join(root, "perfbench", "configs", name)
        cfg = json.load(open(path))
        cfg.update(TINY_MODEL)
        if "batch_size" in cfg:
            cfg.update(TINY_TRAIN)
        json.dump(cfg, open(path, "w"))
    for cell, upd in (traffic or {}).items():
        path = os.path.join(root, "perfbench", "workloads", f"{cell}.json")
        wl = json.load(open(path))
        wl["traffic"].update(upd)
        json.dump(wl, open(path, "w"))
    return root


TINY_TRAFFIC = {
    "serve_batch_bf16": {"batch": 3, "pool_batches": 2, "text_ids": {"median": 21, "sigma": 0.5, "min": 9, "max": 41},
                         "ref_frames": 40},
}
TINY_TRAFFIC["serve_request_f32"] = {"pool": 6, "words": {"median": 4, "sigma": 0.75, "min": 2, "max": 9},
                                     "clips": {"n": 2, "min_s": 0.5, "max_s": 1.0}}
TINY_TRAFFIC["serve_api_batch_f32"] = {"batch": 2, "pool": 4, "words": {"median": 4, "sigma": 0.75, "min": 2, "max": 6},
                                       "clips": {"n": 1, "min_s": 0.5, "max_s": 1.0}}
TINY_TRAFFIC["train_f32_b32"] = {"n": 24, "seconds": {"median": 1.0, "sigma": 0.3, "min": 0.6, "max": 1.6}}
TINY_TRAIN = {"batch_size": 4, "bucket_boundaries": [32, 80, 120, 160], "max_text_len": 48, "loader_workers": 2,
              "prefetch_depth": 2}
