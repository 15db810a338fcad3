"""Interactive requests through `StableTTSAPI.inference`, served one at a
time as the web UI's lock serialises them. The requests arrive open loop,
one every 1 / `rate_per_s` seconds from the window's start, and each waits
for the one before it; a request's latency is the host clock from when it
was due to its return (the numpy waveform), so it counts the wait. Request i
of the window passes `seed=i`; its sentence and reference clip come from the
pool in the seeded order."""

from __future__ import annotations

import time

import numpy as np

from perfbench.lib.api_driver import ApiDriver, cap_for
from perfbench.lib.core import percentile


class Driver(ApiDriver):
    def warmup(self):
        """One request per clip, and the longest sentence (the doubled cap)."""
        n_clips = len(self.clips)
        self.clip_of = self.rng.integers(0, n_clips, size=len(self.sentences))
        keep = self.rng.choice(len(self.sentences), size=min(self.wl["sample"], len(self.sentences)), replace=False)
        self.keep = set(int(i) for i in keep) | {int(np.argmax(self.ids_len))}
        for c in range(n_clips):
            self._request(c % len(self.sentences), c, 0)
        self._request(int(np.argmax(self.ids_len)), 0, 0)
        self.lat, self.done, self.samples, self.n = [], [], {}, 0

    def _request(self, i: int, clip: int, seed: int, due=None):
        """(seconds from `due`, or from the call where none, waveform, mel, regrown)."""
        r0 = self.regrow.count
        t0 = time.perf_counter() if due is None else due
        wav, mel = self.api.inference(self.sentences[i], self.clips[clip], "english", seed=seed,
                                      **self.call_kwargs())
        return time.perf_counter() - t0, wav, mel, self.regrow.count > r0

    def begin(self, seconds: float):
        """The window starts now and lasts `seconds`: requests due in it are served."""
        self.t_start = time.perf_counter()
        self.t_end = self.t_start + seconds
        self.waits = []

    def step(self):
        i = self.n % len(self.sentences)
        clip = int(self.clip_of[i])
        due = self.t_start + self.n / self.wl["traffic"]["rate_per_s"]
        if due >= self.t_end:  # the window's last arrival has been served
            time.sleep(max(0.0, self.t_end - time.perf_counter()))
            return
        time.sleep(max(0.0, due - time.perf_counter()))
        self.waits.append(time.perf_counter() - due)
        dt, wav, mel, regrown = self._request(i, clip, self.n, due)
        y = mel.shape[2]
        self.lat.append(dt)
        self.done.append((i, clip, y, regrown))
        if i in self.keep:
            self.samples[i] = {"idx": [i], "clip": clip, "seed": self.n, "rows": [0], "y": [y],
                               "wav": [wav[0]], "mel": [np.ascontiguousarray(mel[0].T)]}
        self.n += 1

    def finish(self):
        """Serves the requests that came due in the window and wait still."""
        while self.t_start + self.n / self.wl["traffic"]["rate_per_s"] < self.t_end:
            self.step()

    def end_to_end(self, window_s: float) -> dict:
        ms = [t * 1e3 for t in self.lat]
        return {"request_ms_p50": percentile(ms, 50), "request_ms_p90": percentile(ms, 90)}

    def attempted(self) -> tuple:
        return len(self.done), 0

    def work(self) -> dict:
        w = self.work_of([([i], clip, [y], cap_for(y, self.base_cap)) for i, clip, y, _ in self.done])
        w.update(units=len(self.done), regrown=sum(1 for d in self.done if d[3]), waits_s=list(self.waits))
        return w

    def window_info(self) -> dict:
        """How late the server took up requests (the queue's wait, ms), and
        the mean latency of the window's last quarter of requests over its
        first quarter's: a backlog that grows through the run reads well
        over 1."""
        q = max(1, len(self.lat) // 4)
        return {"wait_ms_p50": percentile(self.waits, 50) * 1e3, "wait_ms_p95": percentile(self.waits, 95) * 1e3,
                "wait_ms_max": max(self.waits) * 1e3, "requests_per_s": len(self.lat) / (self.t_end - self.t_start),
                "backlog_growth": float(np.mean(self.lat[-q:]) / np.mean(self.lat[:q]))}
