"""Batch job through `stabletts_torch.models.sampler.synthesise` and
`Vocos.forward(mel, lengths)`: closed loop, the next batch enqueued while
the last one's waveforms copy back to the host, at most two in flight.

The window's metric is the audio returned, each item's own frames x hop /
sample rate, over the window's wall time. Per pool batch, the outputs of
the sampled rows (one drawn from the seed, and the batch's longest text) of
its last run in the window are kept for the reference.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from perfbench.counts import stabletts as counts
from perfbench.lib import program
from perfbench.lib.weights import calibrate_durations, make_weights, split
from perfbench.reference import judge
from perfbench.reference import stabletts_ref as R

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class Driver:
    def __init__(self, cell, seed: int, device, traffic):
        self.cfg, self.wl, self.seed, self.device = cell.config, cell.workload, seed, torch.device(device)
        self.traffic_mod = traffic
        self.dtype = self.wl["dtype"]
        self.cap = self.cfg["max_mel_len"]
        self.trace_modules = self.cfg["trace_modules"]

    # ------------------------------------------------------------ set-up
    def setup(self) -> dict:
        cfg, dev = self.cfg, self.device
        build_s = program.build_kernels(dev)
        dt = DTYPES[self.dtype]
        weights = make_weights(R.parameter_shapes(cfg, cfg["n_vocab"]), cfg, self.seed, dev)
        calibrate_durations(weights, cfg, self.seed, dev)
        self.weights = {k: v.to(dt) for k, v in weights.items()}
        del weights
        tts, voc = split(self.weights)
        self.model, self.vocos = program.build(cfg, tts, voc, dev, None if dt == torch.float32 else dt)

        params = self.wl["traffic"]
        gen = torch.Generator(device=dev).manual_seed(self.seed + 2)
        rng = np.random.default_rng([self.seed, 2])
        self.pool = []
        for item in self.traffic_mod.generate(params, self.seed, cfg["n_vocab"]):
            b = item["ids"].shape[0]
            rows = sorted({int(rng.integers(b)), int(np.argmax(item["x_lengths"]))})
            self.pool.append({
                "ids": torch.from_numpy(item["ids"]).to(dev),
                "x_lengths": torch.from_numpy(item["x_lengths"]).to(dev),
                "x_host": item["x_lengths"],
                "ids_host": item["ids"],
                "noise": torch.randn(b, self.cap, cfg["n_mels"], generator=gen, device=dev),
                "y_ref": torch.randn(b, params["ref_frames"], cfg["n_mels"], generator=gen, device=dev) * 2.0 - 5.0,
                "rows": rows,
            })
        b = self.pool[0]["ids"].shape[0]
        wav_len = self.cap * cfg["hop_length"]
        pin = dev.type == "cuda"
        self.host = [(torch.empty(b, wav_len, dtype=dt, pin_memory=pin), torch.empty(b, dtype=torch.int32, pin_memory=pin))
                     for _ in range(2)]
        self.reset()
        t0 = time.time()
        for i in range(len(self.pool)):  # every shape the window will run
            self._launch(i, i % 2)
            if len(self.pending) == 2:
                self._complete_one()
        self._drain()
        self.reset()
        return {"build_s": build_s, "warm_s": time.time() - t0}

    def reset(self):
        self.pending, self.done, self.samples, self.next = [], [], {}, 0

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
        return out, mel, self.vocos(mel, out["y_lengths"])

    def _launch(self, i: int, slot: int):
        item = self.pool[i]
        out, mel, wav = self._pipeline(item)
        wav_h, len_h = self.host[slot]
        wav_h.copy_(wav, non_blocking=True)
        len_h.copy_(out["y_lengths"], non_blocking=True)
        rows = item["rows"]
        sample = {"rows": rows, "mel": out["decoder_outputs"][rows].clone(), "frames": out["attn"][rows].sum(-1),
                  "wav": wav[rows].clone()}
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
        audio_s = frames * self.cfg["hop_length"] / self.cfg["sample_rate"]
        return {"serve_audio_s_per_s": audio_s / window_s}

    def attempted(self) -> tuple:
        """(items attempted, items failed): every item of a batch that ran."""
        return sum(len(y) for _, y in self.done), 0

    def work(self) -> dict:
        """The window's work at valid lengths, for the per-layer readers."""
        cfg, dt = self.cfg, self.dtype
        ref = self.wl["traffic"]["ref_frames"]
        steps, cfg_on = cfg["n_timesteps"], cfg["cfg"] != 1.0
        flops = dit_s = voc_s = 0.0
        frames = padded = 0
        for i, y in self.done:
            x = self.pool[i]["x_host"]
            flops += counts.synthesis_flops(cfg, x, y, [ref] * len(x), steps, cfg_on)
            flops += counts.vocoder_call(cfg, y, dt)[0]
            dit_s += counts.dit_blocks_least_s(cfg, x, y, steps, cfg_on, dt)
            voc_s += counts.vocoder_least_s(cfg, y, dt)
            frames += int(y.sum())
            padded += len(y) * self.cap
        return {"flops": flops, "dtype": dt, "least_s": {"dit_blocks": dit_s, "vocoder": voc_s},
                "valid_frames": frames, "estimator_frames": padded, "units": len(self.done)}

    def module_roots(self) -> dict:
        return {"acoustic": self.model, "vocoder": self.vocos}

    def release(self):
        """Frees the program's state; keeps the weights and the samples."""
        del self.model, self.vocos, self.host
        for item in self.pool:
            del item["ids"], item["x_lengths"]
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------ correctness
    def _ref_weights(self):
        if not hasattr(self, "_P"):
            tts, voc = split(self.weights)
            self._P = {k: v.float() for k, v in tts.items()}
            self._V = {k: v.float() for k, v in voc.items()}
        return self._P, self._V

    def _encode(self, item, r: int, precision=R.F32):
        n = int(item["x_host"][r])
        ids = torch.from_numpy(item["ids_host"][r:r + 1, :n]).to(self.device)
        return R.encode(self._ref_weights()[0], ids, torch.tensor([n], device=self.device),
                        item["y_ref"][r:r + 1].float(), None, self.cfg, precision)

    def _decode(self, item, r: int, c, mu_x, frames, precision=R.F32):
        cfg = self.cfg
        mel, y = R.decode(self._ref_weights()[0], c, mu_x, frames, item["noise"][r:r + 1].float(), self.cap,
                          cfg["n_timesteps"], cfg["cfg"], cfg, precision, cfg["temperature"])
        return mel[0, :int(y[0])]

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
                item = self.pool[i]
                for k, r in enumerate(s["rows"]):
                    c, mu_x, _, w = self._encode(item, r, precision)
                    frames = R.frames_from_w(w, self.cfg["length_scale"])
                    mel = self._decode(item, r, c, mu_x, frames, precision)
                    wav = self._vocode(mel, precision)
                    n, y = frames.shape[1], mel.shape[0]
                    for key, val in (("frames", frames[0]), ("mel", mel), ("wav", wav)):
                        s[key][k].zero_()
                        s[key][k, :val.shape[0]] = val.to(s[key].dtype)
                    s["y_lengths"][k] = y

    def check(self) -> dict:
        """The worst reading of each number over the kept samples, each
        against the float32 reference (see reference/judge.py)."""
        cfg = self.cfg
        worst = {"duration_gap": 0.0, "mel_rel_err": 0.0, "wave_rel_err": 0.0}
        with torch.no_grad():
            for i, s in sorted(self.samples.items()):
                item = self.pool[i]
                for k, r in enumerate(s["rows"]):
                    c, mu_x, _, w = self._encode(item, r)
                    frames = s["frames"][k, :w.shape[1]].float()
                    y = int(s["y_lengths"][k])
                    mel_r = self._decode(item, r, c, mu_x, frames[None])
                    readings = {
                        "duration_gap": judge.duration_gap(w[0], frames, cfg["length_scale"], self.cap),
                        "mel_rel_err": judge.rel_err(s["mel"][k, :y], mel_r),
                        "wave_rel_err": judge.rel_err(s["wav"][k, :y * cfg["hop_length"]],
                                                      self._vocode(s["mel"][k, :y])),
                    }
                    if readings["duration_gap"] > worst["duration_gap"]:
                        worst["duration_gap_at"] = {"batch": i, "row": r, "ids": int(item["x_host"][r]), "frames": y}
                    for name, v in readings.items():
                        worst[name] = max(worst[name], v)
        return worst
