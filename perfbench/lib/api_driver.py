"""What the two `StableTTSAPI` entries share: the API built with the seeded
weights, the sentence pool and the reference clips, the regrow records of
the API's logger, and the reference's reading of a served item from its
text, clip, noise seed and mel cap.

An API item's durations are not returned, only its length, so the
reference takes the frames nearest its own that give the program's length
(`judge.explain_length`): the same frames where the totals agree, else one
phoneme's ceiling moved, and the gap that move needs.
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from perfbench.counts import stabletts as counts
from perfbench.lib import program
from perfbench.lib.weights import calibrate_durations, make_weights, split
from perfbench.reference import judge, text_en
from perfbench.reference import stabletts_ref as R

API_LOGGER = "stabletts_torch.api"


class RegrowCounter(logging.Handler):
    """Counts the API logger's 'regrowing' records."""

    def __init__(self):
        super().__init__(logging.WARNING)
        self.count = 0

    def emit(self, record):
        if "regrowing" in record.getMessage():
            self.count += 1


def cap_for(y: int, base: int) -> int:
    """The mel cap the API ends at for a total of y frames: base doubled
    while y exceeds it, up to 8192."""
    cap = base
    while y > cap and cap < 8192:
        cap *= 2
    return cap


class ApiDriver:
    """Base of the API entries: `setup` builds the API and the traffic; the
    subclass runs the window and keeps each sampled call in `samples` as
    {"idx": the call's sentence indices, "clip": its voice, "seed": its noise
    seed, "y": every item's frames, "rows": the rows kept, "wav": their
    waveforms, "mel": their mels or None}."""

    def __init__(self, cell, seed: int, device, traffic):
        self.cfg, self.wl, self.seed, self.device = cell.config, cell.workload, seed, torch.device(device)
        self.traffic_mod = traffic
        self.trace_modules = self.cfg["trace_modules"]
        self.base_cap = self.cfg["max_mel_len"]

    def setup(self) -> dict:
        from stabletts_torch.api import StableTTSAPI

        cfg, dev = self.cfg, self.device
        build_s = program.build_kernels(dev)
        params = self.wl["traffic"]
        self.sentences = self.traffic_mod.sentences(params, self.seed)
        self.clips = self.traffic_mod.clips(params, self.seed, cfg["sample_rate"])
        self.weights = make_weights(R.parameter_shapes(cfg, cfg["n_vocab"]), cfg, self.seed, dev)
        ref_mel = R.log_mel(torch.from_numpy(self.clips[0]).to(dev), cfg["sample_rate"], cfg["n_fft"],
                            cfg["hop_length"], cfg["n_mels"])
        calibrate_durations(self.weights, cfg, self.seed, dev, [text_en.sentence_ids(s) for s in sorted(self.sentences)],
                            ref_mel)
        tts, voc = split(self.weights)
        model_cfg, mel_cfg, vocos_cfg = program.configs(cfg)
        self.api = StableTTSAPI(None, None, vocoder_name=cfg["vocoder"]["name"], model_config=model_cfg,
                                mel_config=mel_cfg, vocos_config=vocos_cfg, max_mel_len=self.base_cap, device=dev)
        self.api.tts_model.load_state_dict(tts, strict=True)
        self.api.vocoder_model.load_state_dict(voc, strict=True)
        self.ids_len = [len(text_en.sentence_ids(s)) for s in self.sentences]
        self.regrow = RegrowCounter()
        logging.getLogger(API_LOGGER).addHandler(self.regrow)
        self.rng = np.random.default_rng([self.seed, 3])
        t0 = time.time()
        self.warmup()
        return {"build_s": build_s, "warm_s": time.time() - t0}

    def call_kwargs(self) -> dict:
        cfg = self.cfg
        return dict(step=cfg["n_timesteps"], temperature=cfg["temperature"], length_scale=cfg["length_scale"],
                    solver=cfg["solver"], cfg=cfg["cfg"])

    def module_roots(self) -> dict:
        return {"acoustic": self.api.tts_model, "vocoder": self.api.vocoder_model}

    def release(self):
        logging.getLogger(API_LOGGER).removeHandler(self.regrow)
        del self.api
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def work_of(self, batches) -> dict:
        """Per-layer counts of batches [(sentence indices, clip index, y lengths, cap)]."""
        cfg, dt = self.cfg, "float32"
        steps, cfg_on = cfg["n_timesteps"], cfg["cfg"] != 1.0
        hop = cfg["hop_length"]
        flops = dit_s = voc_s = 0.0
        frames = padded = 0
        for idx, clip, ys, cap in batches:
            x = [self.ids_len[i] for i in idx]
            ref = -(-len(self.clips[clip]) // hop)
            flops += counts.synthesis_flops(cfg, x, ys, [ref] * len(x), steps, cfg_on)
            flops += counts.vocoder_call(cfg, ys, dt)[0]
            dit_s += counts.dit_blocks_least_s(cfg, x, ys, steps, cfg_on, dt)
            voc_s += counts.vocoder_least_s(cfg, ys, dt)
            frames += int(sum(ys))
            padded += len(ys) * cap
        return {"flops": flops, "dtype": dt, "least_s": {"dit_blocks": dit_s, "vocoder": voc_s},
                "valid_frames": frames, "estimator_frames": padded}

    # ------------------------------------------------------------ correctness
    def _ref_weights(self):
        if not hasattr(self, "_P"):
            tts, voc = split(self.weights)
            self._P = {k: v.float() for k, v in tts.items()}
            self._V = {k: v.float() for k, v in voc.items()}
        return self._P, self._V

    def reference_batch(self, texts, clip: int, seed: int, rows, precision=R.F32, y_prog=None):
        """Reference outputs for `rows` of one API call over `texts` with the
        shared clip and noise seed: [(gap, mel [y, n_mels])]. With the
        program's lengths `y_prog` (every item's), the cap is the one they led
        the API to and each row takes the frames that explain its length;
        without, the reference takes its own frames and cap (the control)."""
        cfg, dev = self.cfg, self.device
        P, _ = self._ref_weights()
        ls = cfg["length_scale"]
        ref_mel = R.log_mel(torch.from_numpy(self.clips[clip]).to(dev), cfg["sample_rate"], cfg["n_fft"],
                            cfg["hop_length"], cfg["n_mels"])[None]
        enc = []
        for text in texts:
            ids = torch.tensor([text_en.sentence_ids(text)], device=dev)
            c, mu_x, _, w = R.encode(P, ids, torch.tensor([ids.shape[1]], device=dev), ref_mel, None, cfg, precision)
            enc.append((c, mu_x, w[0]))
        if y_prog is None:
            totals = [float(R.frames_from_w(w, ls).sum()) for _, _, w in enc]
        else:
            totals = [int(y) for y in y_prog]
        cap = cap_for(int(max(totals)), self.base_cap)
        gen = torch.Generator().manual_seed(seed)
        noise = torch.randn((len(texts), cap, cfg["n_mels"]), generator=gen).to(dev)
        out = []
        for r in rows:
            c, mu_x, w = enc[r]
            if y_prog is None:
                frames, gap = R.frames_from_w(w, ls), 0.0
            else:
                frames, gap = judge.explain_length(w, ls, int(y_prog[r]), cap)
            mel, y = R.decode(P, c, mu_x, frames[None].float(), noise[r:r + 1], cap, cfg["n_timesteps"], cfg["cfg"],
                              cfg, precision, cfg["temperature"])
            out.append((gap, mel[0, :int(y[0])]))
        return out

    def vocode(self, mel, precision=R.F32):
        cfg = self.cfg
        return R.vocos(self._ref_weights()[1], mel.float(), cfg["n_fft"], cfg["hop_length"],
                       cfg["vocoder"]["num_layers"], precision)

    def produce_control(self, precision) -> None:
        """Replaces each kept sample's outputs by the reference's own in
        `precision` on the same inputs."""
        with torch.no_grad():
            for s in self.samples.values():
                texts = [self.sentences[i] for i in s["idx"]]
                ys = list(s["y"])
                for k, (_, mel) in enumerate(self.reference_batch(texts, s["clip"], s["seed"], s["rows"], precision)):
                    s["wav"][k] = self.vocode(mel, precision).cpu().numpy()
                    if s.get("mel") is not None:
                        s["mel"][k] = mel.cpu().numpy()
                    ys[s["rows"][k]] = mel.shape[0]
                s["y"] = ys

    def check(self) -> dict:
        hop = self.cfg["hop_length"]
        worst = {"duration_gap": 0.0, "mel_rel_err": 0.0, "wave_rel_err": 0.0}
        with torch.no_grad():
            for s in self.samples.values():
                texts = [self.sentences[i] for i in s["idx"]]
                refs = self.reference_batch(texts, s["clip"], s["seed"], s["rows"], y_prog=s["y"])
                for k, (gap, mel_r) in enumerate(refs):
                    wav_p = torch.from_numpy(s["wav"][k]).to(self.device)
                    worst["duration_gap"] = max(worst["duration_gap"], gap)
                    if s.get("mel") is not None:
                        mel_p = torch.from_numpy(s["mel"][k]).to(self.device)
                        worst["mel_rel_err"] = max(worst["mel_rel_err"], judge.rel_err(mel_p, mel_r))
                        wav_r = self.vocode(mel_p)
                    else:
                        wav_r = self.vocode(mel_r)
                    if wav_p.shape[0] != mel_r.shape[0] * hop:
                        worst["wave_rel_err"] = float("inf")
                        continue
                    worst["wave_rel_err"] = max(worst["wave_rel_err"], judge.rel_err(wav_p, wav_r))
        return worst
