"""Batch job through `stabletts_torch.models.sampler.synthesise` and
`FireflyGANBase.forward(mel, lengths)`: the `synthesise_vocos` entry's closed
loop (the next batch enqueued while the last one's waveforms copy back to
pinned memory, at most two in flight) and its acoustic path, with
FireflyGAN, the API's default vocoder, in Vocos's place on the whole mel at
the cap.

The window's metric is the audio returned, each item's own frames x 512 /
44100, over the window's wall time. The sampled rows' waveforms are judged
against the plain reference `reference/ffgan_ref.py` on the program's own
mel, each item trimmed to its length and vocoded alone.

A program whose `FireflyGANBase.forward` takes no `lengths` cannot serve a
batch of ragged items exactly, and `Driver` raises at construction.
"""

from __future__ import annotations

import inspect
import math
import os
import time

import numpy as np
import torch

from perfbench.counts import ffgan as ffgan_counts
from perfbench.counts import stabletts as counts
from perfbench.lib import core, program
from perfbench.lib.weights import calibrate_durations, make_weights, split
from perfbench.reference import ffgan_ref as FR
from perfbench.reference import stabletts_ref as R

base = core.load_module(os.path.join(core.PKG_DIR, "entries", "synthesise_vocos.py"), "perfbench_entry_ffgan_base")
DTYPES = base.DTYPES


def acoustic_config(cfg: dict) -> dict:
    """The configuration with a Vocos-shaped stand-in for `vocoder`, for the
    helpers that read the acoustic model's widths beside a Vocos's
    (`stabletts_ref.parameter_shapes`, `program.configs`); nothing of the
    stand-in is built or drawn."""
    return {**cfg, "vocoder": {"dim": 1, "intermediate_dim": 1, "num_layers": 1}}


def parameter_shapes(cfg: dict) -> dict:
    """The acoustic model's published names and shapes, then FireflyGAN's under `vocoder.`."""
    shapes = {k: s for k, s in R.parameter_shapes(acoustic_config(cfg), cfg["n_vocab"]).items()
              if not k.startswith("vocoder.")}
    shapes.update(FR.parameter_shapes(cfg["vocoder"], "vocoder."))
    return shapes


def scale_upsamplers(weights: dict, cfg: dict, prefix: str = "vocoder.") -> None:
    """Redraws, in place, each transposed conv of the rule's draw at
    `ups_gain` / sqrt(C_in k / u), the fan-in of its outputs (the rule reads
    C_out k): without it the waveform is the last conv's bias through tanh."""
    for i, u in enumerate(cfg["vocoder"]["head"]["upsample_rates"]):
        ups = weights[f"{prefix}head.ups.{i}.weight"]
        c_in, c_out, k = ups.shape
        ups.mul_(cfg["weights"]["ups_gain"] * math.sqrt(c_out * k) / math.sqrt(c_in * k / u))


def weights_for(cfg: dict, seed: int, device) -> dict:
    """`lib/weights.py`'s rule over `parameter_shapes`, the upsamplers'
    gain and the duration calibration."""
    w = make_weights(parameter_shapes(cfg), cfg, seed, device)
    scale_upsamplers(w, cfg)
    calibrate_durations(w, cfg, seed, device)
    return w


def build(cfg: dict, tts_sd: dict, voc_sd: dict, device, dtype=None) -> tuple:
    """(acoustic model, FireflyGAN) on `device` in eval mode holding the
    given weights, cast once to `dtype` where given."""
    from stabletts_torch.models import build_stabletts
    from stabletts_torch.models.ffgan import FireflyGANBase
    from stabletts_torch.models.sampler import cast_model

    model_cfg, mel_cfg, _ = program.configs(acoustic_config(cfg))
    model = build_stabletts(model_cfg, mel_cfg, n_vocab=cfg["n_vocab"], device=device)
    model.load_state_dict(tts_sd, strict=True)
    vocoder = FireflyGANBase(device=device)
    vocoder.load_state_dict(voc_sd, strict=True)
    model, vocoder = model.eval(), vocoder.eval()
    if dtype is not None:
        model, vocoder = cast_model(model, dtype), cast_model(vocoder, dtype)
    return model, vocoder


class Driver(base.Driver):
    def __init__(self, cell, seed: int, device, traffic):
        from stabletts_torch.models.ffgan import FireflyGANBase

        if "lengths" not in inspect.signature(FireflyGANBase.forward).parameters:
            raise RuntimeError("FireflyGANBase.forward takes no `lengths`: this program cannot vocode a batch "
                               "of ragged items as each item alone")
        super().__init__(cell, seed, device, traffic)

    # ------------------------------------------------------------ set-up
    def setup(self) -> dict:
        cfg, dev = self.cfg, self.device
        build_s = program.build_kernels(dev)
        dt = DTYPES[self.dtype]
        self.weights = {k: v.to(dt) for k, v in weights_for(cfg, self.seed, dev).items()}
        tts, voc = split(self.weights)
        self.model, self.vocoder = build(cfg, tts, voc, dev, None if dt == torch.float32 else dt)

        params = self.wl["traffic"]
        gen = torch.Generator(device=dev).manual_seed(self.seed + 2)
        rng = np.random.default_rng([self.seed, 2])
        self.pool = []
        for item in self.traffic_mod.generate(params, self.seed, cfg["n_vocab"]):
            b = item["ids"].shape[0]
            self.pool.append({
                "ids": torch.from_numpy(item["ids"]).to(dev),
                "x_lengths": torch.from_numpy(item["x_lengths"]).to(dev),
                "x_host": item["x_lengths"],
                "ids_host": item["ids"],
                "noise": torch.randn(b, self.cap, cfg["n_mels"], generator=gen, device=dev),
                "y_ref": torch.randn(b, params["ref_frames"], cfg["n_mels"], generator=gen, device=dev) * 2.0 - 5.0,
                "rows": sorted({int(rng.integers(b)), int(np.argmax(item["x_lengths"]))}),
            })
        b = self.pool[0]["ids"].shape[0]
        pin = dev.type == "cuda"
        self.host = [(torch.empty(b, self.cap * cfg["hop_length"], dtype=dt, pin_memory=pin),
                      torch.empty(b, dtype=torch.int32, pin_memory=pin)) for _ in range(2)]
        self.reset()
        t0 = time.time()
        for i in range(len(self.pool)):  # every shape the window will run
            self._launch(i, i % 2)
            if len(self.pending) == 2:
                self._complete_one()
        self._drain()
        self.reset()
        return {"build_s": build_s, "warm_s": time.time() - t0}

    # ------------------------------------------------------------ the window
    def _pipeline(self, item):
        from stabletts_torch.models.sampler import synthesise

        cfg = self.cfg
        out = synthesise(self.model, item["ids"], item["x_lengths"], item["noise"], item["y_ref"],
                         n_timesteps=cfg["n_timesteps"], temperature=cfg["temperature"],
                         length_scale=cfg["length_scale"], solver=cfg["solver"], cfg=cfg["cfg"],
                         max_mel_len=self.cap, compute_dtype=None if self.dtype == "float32" else DTYPES[self.dtype],
                         device=self.device)
        mel = out["decoder_outputs"].to(DTYPES[self.dtype])
        return out, mel, self.vocoder(mel, out["y_lengths"])

    # ------------------------------------------------------------ readings
    def work(self) -> dict:
        """The window's work at valid lengths, for the per-layer readers."""
        cfg, dt, v = self.cfg, self.dtype, self.cfg["vocoder"]
        ref = self.wl["traffic"]["ref_frames"]
        steps, cfg_on = cfg["n_timesteps"], cfg["cfg"] != 1.0
        flops = dit_s = voc_s = 0.0
        frames = padded = 0
        for i, y in self.done:
            x = self.pool[i]["x_host"]
            flops += counts.synthesis_flops(cfg, x, y, [ref] * len(x), steps, cfg_on)
            flops += ffgan_counts.vocoder_call(v, y, dt)[0]
            dit_s += counts.dit_blocks_least_s(cfg, x, y, steps, cfg_on, dt)
            voc_s += ffgan_counts.vocoder_least_s(v, y, dt)
            frames += int(y.sum())
            padded += len(y) * self.cap
        return {"flops": flops, "dtype": dt, "least_s": {"dit_blocks": dit_s, "ffgan": voc_s},
                "valid_frames": frames, "estimator_frames": padded, "units": len(self.done)}

    def module_roots(self) -> dict:
        return {"acoustic": self.model, "vocoder": self.vocoder}

    def release(self):
        """Frees the program's state; keeps the weights and the samples."""
        del self.model, self.vocoder, self.host
        for item in self.pool:
            del item["ids"], item["x_lengths"]
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------ correctness
    def _vocode(self, mel, precision=R.F32):
        """The reference vocoder on one trimmed mel as the program's vocoder receives it."""
        return FR.vocode(self._ref_weights()[1], mel.to(DTYPES[self.dtype]).float(), self.cfg["vocoder"], precision)
