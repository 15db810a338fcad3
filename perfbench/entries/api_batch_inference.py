"""API batches through `StableTTSAPI.batch_inference`: closed loop, batches
of the pool's sentences in the seeded order sharing one reference clip,
batch k of the window passing `seed=k`. The audio returned is each item's
trimmed waveform."""

from __future__ import annotations

import numpy as np

from perfbench.lib.api_driver import ApiDriver, cap_for


class Driver(ApiDriver):
    def warmup(self):
        b = self.wl["traffic"]["batch"]
        n = len(self.sentences) // b
        self.batches = [list(range(k * b, (k + 1) * b)) for k in range(n)]
        self.keep_rows = [sorted({int(self.rng.integers(b)), int(np.argmax([self.ids_len[i] for i in idx]))})
                          for idx in self.batches]
        for k in range(n):  # every shape the window runs
            self._call(k, 0)
        self.done, self.samples, self.n = [], {}, 0

    def _call(self, k: int, seed: int):
        items = [(self.sentences[i], "english") for i in self.batches[k]]
        return self.api.batch_inference(items, self.clips[0], seed=seed, **self.call_kwargs())

    def step(self):
        k = self.n % len(self.batches)
        wavs = self._call(k, self.n)
        hop = self.cfg["hop_length"]
        y = [len(w) // hop for w in wavs]
        self.done.append((k, y))
        rows = self.keep_rows[k]
        self.samples[k] = {"idx": self.batches[k], "clip": 0, "seed": self.n, "rows": rows, "y": y,
                           "wav": [wavs[r] for r in rows], "mel": None}
        self.n += 1

    def finish(self):
        pass

    def end_to_end(self, window_s: float) -> dict:
        frames = sum(sum(y) for _, y in self.done)
        return {"serve_audio_s_per_s": frames * self.cfg["hop_length"] / self.cfg["sample_rate"] / window_s}

    def attempted(self) -> tuple:
        return sum(len(y) for _, y in self.done), 0

    def work(self) -> dict:
        w = self.work_of([(self.batches[k], 0, y, cap_for(max(y), self.base_cap)) for k, y in self.done])
        w["units"] = len(self.done)
        return w
