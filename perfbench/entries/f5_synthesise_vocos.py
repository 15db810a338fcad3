"""Batch job of voice-cloned generations: F5-TTS v1 Base through
`stabletts_torch.models.sampler.synthesise` (prepare, then sample), then
`Vocos.forward(mel, lengths)` at 24 kHz. Closed loop: the next batch is
enqueued while the last one's waveforms copy back to pinned memory, at most
two in flight.

The window's metric is the generated audio alone: each item's generated
frames x hop / sample rate, over the window's wall time (never the prompt or
the padding). Per pool batch, the outputs of the sampled rows (one drawn
from the seed, and the batch's longest) of its last run in the window are
kept for the reference, which runs each of them alone (F5-TTS's batch of
one) on the program's noise and prompt.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from perfbench.counts import f5tts as counts
from perfbench.lib import program, weights as wrule
from perfbench.reference import f5tts_ref as R
from perfbench.reference import judge

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def make_weights(cfg: dict, seed: int, device) -> dict:
    """`perfbench/lib/weights.py`'s rule over the published names (one
    uniform draw from the seed, scale 1 / sqrt(fan_in), norms 1 +- 0.1, the
    adaLN modulation not zero), then the configuration's `velocity_gain` on
    `proj_out` and `time_cutoff` on the time MLP's sinusoids (as the rule
    does for StableTTS's estimator), and the rotary buffer."""
    w = wrule.make_weights(R.parameter_shapes(cfg), {"weights": {"velocity_gain": 1.0}, "vocoder": cfg["vocoder"]},
                           seed, device)
    gain = cfg["weights"]["velocity_gain"]
    w["transformer.proj_out.weight"].mul_(gain)
    w["transformer.proj_out.bias"].mul_(gain)
    tw = w["transformer.time_embed.time_mlp.0.weight"]
    half = tw.shape[1] // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=device) * -(math.log(10000.0) / (half - 1)))
    g = torch.exp(-1000.0 * freqs / cfg["weights"]["time_cutoff"])
    tw.mul_(torch.cat([g, g])[None, :])
    w.update(R.buffers(cfg, device))
    return w


def f5_config(cfg: dict):
    from stabletts_torch.config import F5Config

    return F5Config(dim=cfg["dim"], depth=cfg["depth"], heads=cfg["heads"], dim_head=cfg["dim_head"],
                    ff_mult=cfg["ff_mult"], text_dim=cfg["text_dim"], text_num_embeds=cfg["text_num_embeds"],
                    conv_layers=cfg["conv_layers"], mel_dim=cfg["n_mels"], freq_embed_dim=cfg["freq_embed_dim"],
                    conv_pos_kernel=cfg["conv_pos_kernel"], conv_pos_groups=cfg["conv_pos_groups"],
                    sway_sampling_coef=cfg["sway_sampling_coef"], max_duration=cfg["max_duration"])


def build(cfg: dict, tts_sd: dict, voc_sd: dict, device, dtype=None) -> tuple:
    """(F5TTS, Vocos at 24 kHz) on `device` in eval mode holding the given
    weights, cast once to `dtype` where given."""
    from stabletts_torch.config import MelConfig, VocosConfig
    from stabletts_torch.models.f5tts import F5TTS
    from stabletts_torch.models.sampler import cast_model
    from stabletts_torch.models.vocos import Vocos

    model = F5TTS(f5_config(cfg), device=device)
    model.load_state_dict(tts_sd, strict=True)
    v = cfg["vocoder"]
    mel = MelConfig(sample_rate=cfg["sample_rate"], n_fft=cfg["n_fft"], win_length=cfg["win_length"],
                    hop_length=cfg["hop_length"], n_mels=cfg["n_mels"], mel_scale=cfg["mel_scale"])
    vocos = Vocos(VocosConfig(input_channels=cfg["n_mels"], dim=v["dim"], intermediate_dim=v["intermediate_dim"],
                              num_layers=v["num_layers"]), mel, device=device)
    vocos.load_state_dict(voc_sd, strict=True)
    if dtype is not None:
        model, vocos = cast_model(model, dtype), cast_model(vocos, dtype)
    return model.eval(), vocos.eval()


class Driver:
    def __init__(self, cell, seed: int, device, traffic):
        from stabletts_torch.models import f5tts  # noqa: F401  (a program without F5-TTS stops here)

        self.cfg, self.wl, self.seed, self.device = cell.config, cell.workload, seed, torch.device(device)
        self.traffic_mod = traffic
        self.dtype = self.wl["dtype"]
        self.hop = self.cfg["hop_length"]
        self.fps = self.cfg["sample_rate"] / self.hop
        self.trace_modules = self.cfg["trace_modules"]

    # ------------------------------------------------------------ set-up
    def setup(self) -> dict:
        cfg, dev = self.cfg, self.device
        build_s = program.build_kernels(dev)
        dt = DTYPES[self.dtype]
        self.weights = {k: v.to(dt) for k, v in make_weights(cfg, self.seed, dev).items()}
        tts, voc = wrule.split(self.weights)
        self.model, self.vocos = build(cfg, tts, voc, dev, None if dt == torch.float32 else dt)

        gen = torch.Generator(device=dev).manual_seed(self.seed + 2)
        rng = np.random.default_rng([self.seed, 2])
        self.pool = []
        for item in self.traffic_mod.generate(self.wl["traffic"], self.seed, cfg["text_num_embeds"], self.fps):
            b = len(item["x_lengths"])
            refs = item["ref_frames"]
            frames = torch.arange(int(refs.max()), device=dev)
            ref_mask = (frames[None, :] < torch.from_numpy(refs).to(dev)[:, None]).float()
            self.pool.append({
                "ids": torch.from_numpy(item["ids"]).to(dev),
                "x_lengths": torch.from_numpy(item["x_lengths"]).to(dev),
                "x_ref_lengths": torch.from_numpy(item["x_ref_lengths"]).to(dev),
                "host": item,
                "y_ref": (torch.randn(b, len(frames), cfg["n_mels"], generator=gen, device=dev) * 2.0 - 5.0)
                * ref_mask[..., None],
                "y_ref_mask": ref_mask,
                "noise": torch.randn(b, int(item["totals"].max()), cfg["n_mels"], generator=gen, device=dev),
                "rows": sorted({int(rng.integers(b)), int(np.argmax(item["totals"]))}),
            })
        b = len(self.pool[0]["host"]["x_lengths"])
        longest = max(int((p["host"]["totals"] - p["host"]["ref_frames"]).max()) for p in self.pool)
        pin = dev.type == "cuda"
        self.host = [(torch.empty(b * longest * self.hop, dtype=dt, pin_memory=pin),
                      torch.empty(b, dtype=torch.int32, pin_memory=pin)) for _ in range(2)]
        self.reset()
        t0 = time.time()
        for i in range(len(self.pool)):  # every shape the window will run: one step of each pool batch
            self._launch(i, i % 2, n_timesteps=1)
            if len(self.pending) == 2:
                self._complete_one()
        self._drain()
        self.reset()
        return {"build_s": build_s, "warm_s": time.time() - t0}

    def reset(self):
        self.pending, self.done, self.samples, self.next = [], [], {}, 0

    # ------------------------------------------------------------ the window
    def _pipeline(self, item, n_timesteps: int):
        from stabletts_torch.models.sampler import synthesise

        cfg = self.cfg
        out = synthesise(self.model, item["ids"], item["x_lengths"], item["noise"], item["y_ref"],
                         n_timesteps=n_timesteps, length_scale=1.0 / cfg["speed"], solver=cfg["solver"],
                         cfg=cfg["cfg_strength"], max_mel_len=cfg["max_duration"],
                         compute_dtype=None if self.dtype == "float32" else DTYPES[self.dtype],
                         y_ref_mask=item["y_ref_mask"], device=self.device, x_ref_lengths=item["x_ref_lengths"])
        mel = out["decoder_outputs"].to(DTYPES[self.dtype])
        return out, mel, self.vocos(mel, out["y_lengths"])

    def _launch(self, i: int, slot: int, n_timesteps: int | None = None):
        item = self.pool[i]
        out, mel, wav = self._pipeline(item, n_timesteps or self.cfg["nfe_step"])
        wav_h, len_h = self.host[slot]
        wav_h[:wav.numel()].view(wav.shape).copy_(wav, non_blocking=True)
        len_h.copy_(out["y_lengths"], non_blocking=True)
        rows = item["rows"]
        sample = {"rows": rows, "mel": out["decoder_outputs"][rows].clone(), "wav": wav[rows].clone()}
        ev = torch.cuda.Event() if self.device.type == "cuda" else None
        if ev is not None:
            ev.record()
        self.pending.append((i, slot, ev, sample))

    def _complete_one(self):
        i, slot, ev, sample = self.pending.pop(0)
        if ev is not None:
            ev.synchronize()
        y = self.host[slot][1].numpy().astype(np.int64).copy()
        sample["y_lengths"] = y[sample["rows"]]
        self.samples[i] = sample
        self.done.append((i, y))

    def _drain(self):
        while self.pending:
            self._complete_one()

    def step(self):
        slot = self.next % 2
        if len(self.pending) == 2:
            self._complete_one()
        self._launch(self.next % len(self.pool), slot)
        self.next += 1

    def finish(self):
        self._drain()

    # ------------------------------------------------------------ readings
    def end_to_end(self, window_s: float) -> dict:
        frames = sum(int(y.sum()) for _, y in self.done)
        return {"serve_audio_s_per_s": frames * self.hop / self.cfg["sample_rate"] / window_s}

    def attempted(self) -> tuple:
        """(items attempted, items failed): every item of a batch that ran."""
        return sum(len(y) for _, y in self.done), 0

    def work(self) -> dict:
        """The window's work at valid frames, for the per-layer readers."""
        cfg, dt = self.cfg, self.dtype
        steps, cfg_on = cfg["nfe_step"], cfg["cfg_strength"] >= 1e-5
        flops = blocks_s = 0.0
        frames = padded = 0
        for i, y in self.done:
            totals = self.pool[i]["host"]["totals"]
            flops += counts.synthesis_flops(cfg, totals, steps, cfg_on) + counts.vocoder_call(cfg, y, dt)[0]
            blocks_s += counts.blocks_least_s(cfg, totals, steps, cfg_on, dt)
            frames += int(totals.sum())
            padded += len(totals) * int(totals.max())
        return {"flops": flops, "dtype": dt, "least_s": {"f5_blocks": blocks_s}, "valid_frames": frames,
                "estimator_frames": padded, "units": len(self.done)}

    def module_roots(self) -> dict:
        return {"acoustic": self.model, "vocoder": self.vocos}

    def release(self):
        """Frees the program's state; keeps the weights and the samples."""
        del self.model, self.vocos, self.host
        for item in self.pool:
            del item["ids"], item["x_lengths"], item["x_ref_lengths"]
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------ correctness
    def _ref_weights(self):
        if not hasattr(self, "_P"):
            tts, voc = wrule.split(self.weights)
            self._P = {k: v.float() for k, v in tts.items()}
            self._V = {k: v.float() for k, v in voc.items()}
        return self._P, self._V

    def _reference(self, item, r: int, precision=R.F32):
        """The reference's generated mel of row r alone: its prompt, text and
        noise as the program received them, its total from the rule."""
        h = item["host"]
        n, ref, rb = int(h["x_lengths"][r]), int(h["ref_frames"][r]), int(h["x_ref_lengths"][r])
        ids = torch.from_numpy(h["ids"][r:r + 1, :n]).to(self.device)
        total = R.total_frames(ref, rb, n - rb, self.cfg["speed"])
        out, dur = R.sample(self._ref_weights()[0], item["y_ref"][r:r + 1, :ref].float(), ids,
                            torch.tensor([total], device=self.device), item["noise"][r:r + 1].float(), self.cfg,
                            precision)
        return out[0, ref:int(dur[0])]

    def _vocode(self, mel, precision=R.F32):
        """The reference vocoder on a mel as the program's vocoder receives it."""
        cfg = self.cfg
        return R.vocos(self._ref_weights()[1], mel.to(DTYPES[self.dtype]).float(), cfg["n_fft"], cfg["hop_length"],
                       cfg["vocoder"]["num_layers"], precision)

    def produce_control(self, precision) -> None:
        """Replaces the kept samples by the reference's own outputs computed in
        `precision` on the same inputs: the control of the comparison."""
        with torch.no_grad():
            for i, s in self.samples.items():
                for k, r in enumerate(s["rows"]):
                    mel = self._reference(self.pool[i], r, precision)
                    wav = self._vocode(mel, precision)
                    for key, val in (("mel", mel), ("wav", wav)):
                        s[key][k].zero_()
                        s[key][k, :val.shape[0]] = val.to(s[key].dtype)
                    s["y_lengths"][k] = mel.shape[0]

    def check(self) -> dict:
        """The worst reading of each number over the kept samples, each
        against the float32 reference (reference/judge.py's relative error;
        inf where the program's generated frames are not the rule's)."""
        worst = {"mel_rel_err": 0.0, "wave_rel_err": 0.0}
        with torch.no_grad():
            for i, s in sorted(self.samples.items()):
                for k, r in enumerate(s["rows"]):
                    y = int(s["y_lengths"][k])
                    readings = {"mel_rel_err": judge.rel_err(s["mel"][k, :y], self._reference(self.pool[i], r)),
                                "wave_rel_err": judge.rel_err(s["wav"][k, :y * self.hop],
                                                              self._vocode(s["mel"][k, :y]))}
                    for name, v in readings.items():
                        if v > worst[name]:
                            worst[name] = v
                            worst[name.replace("_rel_err", "_worst_at")] = {"batch": i, "row": r, "frames": y}
        return worst
