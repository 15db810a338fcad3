"""TTS training through `stabletts_torch.train.train_tts.train_step`, fed by
the port's data layer (`StableDataset`, `DistributedBucketSampler`,
`collate`, `prefetch`, pinned copies to the card) as `train()` feeds it,
over a corpus that set-up writes from the seed under TMPDIR.

Set-up builds the model, AdamW and the schedule once and drives that same
object through its first steps: the first three are the ones the reference
follows (their losses, the first gradient as AdamW's state holds it after
one update, and the parameters' change after three), the rest of the first
epoch warms every bucket's shape. The window goes on from there. The
window's metric is the unpadded audio of every batch stepped over its wall
time.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time

import numpy as np
import torch

from perfbench.counts import stabletts as counts
from perfbench.lib import program
from perfbench.lib.weights import make_weights, split
from perfbench.reference import stabletts_ref as R
from perfbench.reference import train_ref as T

CHECK_STEPS = 3


def leaf_gap(prog: dict, ref: dict, names) -> float:
    """Worst leaf's |prog - ref| / max(ref, the median leaf's ref), over norms."""
    med = float(np.median([ref[n] for n in names]))
    return max(abs(prog[n] - ref[n]) / max(ref[n], med) for n in names)


class Driver:
    def __init__(self, cell, seed: int, device, traffic):
        self.cell, self.cfg, self.wl, self.seed = cell, cell.config, cell.workload, seed
        self.device = torch.device(device)
        self.traffic_mod = traffic
        self.trace_modules = self.cfg["trace_modules"]

    # ------------------------------------------------------------ set-up
    def setup(self) -> dict:
        from stabletts_torch.config import TrainConfig
        from stabletts_torch.data.dataset import StableDataset
        from stabletts_torch.data.sampler import DistributedBucketSampler
        from stabletts_torch.models import build_stabletts
        from stabletts_torch.parallel import mesh as mesh_lib
        from stabletts_torch.train.scheduler import make_scheduler
        from stabletts_torch.train.train_tts import make_optimizer

        cfg, dev = self.cfg, self.device
        build_s = program.build_kernels(dev)
        weights, _ = split(make_weights(R.parameter_shapes(cfg, cfg["n_vocab"]), cfg, self.seed, dev))
        self.weights = weights
        t0 = time.time()
        self.data_dir = os.path.join(tempfile.gettempdir(), "perfbench_corpus", self.cell.name)
        shutil.rmtree(self.data_dir, ignore_errors=True)
        self.filelist = self.traffic_mod.write(self.wl["traffic"], self.seed, cfg, self.data_dir)
        corpus_s = time.time() - t0
        self.train_cfg = TrainConfig(train_dataset_path=self.filelist, batch_size=cfg["batch_size"],
                                     learning_rate=cfg["learning_rate"], warmup_steps=cfg["warmup_steps"],
                                     seed=self.seed, bucket_boundaries=tuple(cfg["bucket_boundaries"]),
                                     max_text_len=cfg["max_text_len"], compute_dtype=cfg["compute_dtype"],
                                     loader_workers=cfg["loader_workers"], prefetch_depth=cfg["prefetch_depth"],
                                     num_epochs=cfg["num_epochs"])
        model_cfg, mel_cfg, _ = program.configs(cfg)
        self.model = build_stabletts(model_cfg, mel_cfg, n_vocab=cfg["n_vocab"], device=dev)
        self.model.load_state_dict(weights, strict=True)
        self.model.train()
        self.dataset = StableDataset(self.filelist)
        self.sampler = DistributedBucketSampler(self.dataset.lengths, cfg["batch_size"], list(cfg["bucket_boundaries"]))
        self.optimizer = make_optimizer(self.model, self.train_cfg)
        self.total_steps = cfg["num_epochs"] * len(self.sampler)
        self.scheduler = make_scheduler(self.optimizer, cfg["learning_rate"], cfg["warmup_steps"], self.total_steps)
        self.mesh = mesh_lib.make_mesh(dev)
        self.gen = torch.Generator(device=dev)
        self.step_idx = 0
        self.feed = self._feed()

        self.reset()
        t0 = time.time()
        beta1 = self.optimizer.param_groups[0]["betas"][0]
        self.prog = {"loss": [], "grad": {}, "update": {}}
        for k in range(CHECK_STEPS):
            out = self._step()
            self.prog["loss"].append(float(out["loss"]))
            if k == 0:  # AdamW's first moment after one update is (1 - beta1) x the gradient it got
                moments = {n: self.optimizer.state.get(p, {}).get("exp_avg") for n, p in self.model.named_parameters()}
                self.prog["grad"] = {n: 0.0 if m is None else float(m.norm()) / (1.0 - beta1) for n, m in moments.items()}
        self.prog["update"] = {n: float((p.detach() - weights[n]).norm()) for n, p in self.model.named_parameters()}
        first_steps_s = time.time() - t0
        for _ in range(len(self.sampler) - CHECK_STEPS):  # the rest of the first epoch: every bucket's shape
            self._step()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        self.reset()
        return {"build_s": build_s, "corpus_s": corpus_s, "first_steps_s": first_steps_s,
                "warm_steps_s": time.time() - t0 - first_steps_s, "steps_per_epoch": len(self.sampler)}

    def reset(self):
        self.stepped, self.wait_s = [], 0.0

    def _feed(self):
        """(host y lengths, pad length, device batch) in train()'s order, epoch after epoch."""
        from stabletts_torch.data.dataset import collate
        from stabletts_torch.data.prefetch import prefetch

        cfg, tc = self.cfg, self.train_cfg
        epoch = 0
        while True:
            self.sampler.set_epoch(epoch)

            def make(work, epoch=epoch):
                _, (bucket, indices) = work
                pad = self.sampler.bucket_mel_len(bucket)
                batch = collate(self.dataset, indices, pad, tc.max_text_len, cfg["n_mels"], (tc.seed, epoch))
                host = batch.as_tuple()
                dev = tuple(self._to_device(a) for a in host)
                return host[3].copy(), host[1].copy(), pad, dev

            yield from prefetch(enumerate(self.sampler), make, n_workers=tc.loader_workers, depth=tc.prefetch_depth)
            epoch += 1

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(a)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _step(self) -> dict:
        from stabletts_torch.parallel import mesh as mesh_lib
        from stabletts_torch.train.train_tts import train_step

        t0 = time.perf_counter()
        y_len, x_len, pad, batch = next(self.feed)
        self.wait_s += time.perf_counter() - t0
        # the step's random streams depend on (seed, step) only, as in train()
        self.gen.manual_seed((self.seed + 1) * 2 ** 32 + self.step_idx)
        rows = mesh_lib.window(self.gen, mesh_lib.shard_batch(self.mesh, batch[0].shape[0]))
        out = train_step(self.model, self.optimizer, self.scheduler, batch, rows, None, self.mesh)
        self.stepped.append((y_len, x_len, pad))
        self.step_idx += 1
        return out

    # ------------------------------------------------------------ the window
    def step(self):
        self._step()

    def finish(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def end_to_end(self, window_s: float) -> dict:
        frames = sum(int(y.sum()) for y, _, _ in self.stepped)
        return {"train_audio_s_per_s": frames * self.cfg["hop_length"] / self.cfg["sample_rate"] / window_s}

    def attempted(self) -> tuple:
        return sum(len(y) for y, _, _ in self.stepped), 0

    def work(self) -> dict:
        cfg = self.cfg
        flops = 0.0
        frames = padded = 0
        for y, x, pad in self.stepped:
            z = [max(n // 3, 12) for n in y]  # the reference slice is T/12 .. T/3 frames: its largest
            flops += 3.0 * counts.synthesis_flops(cfg, x, y, z, 1, False)
            frames += int(y.sum())
            padded += len(y) * pad
        return {"flops": flops, "dtype": "float32", "valid_frames": frames, "estimator_frames": padded,
                "units": len(self.stepped), "wait_s": self.wait_s}

    def module_roots(self) -> dict:
        return {"acoustic": self.model}

    def release(self):
        self.feed.close()
        del self.model, self.optimizer, self.scheduler, self.feed
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------ correctness
    def reference(self, precision=R.F32) -> dict:
        """The reference's three steps from the same weights and files."""
        cfg, dev = self.cfg, self.device
        P = {n: w.detach().clone().requires_grad_(True) for n, w in self.weights.items()}
        opt = torch.optim.AdamW(list(P.values()), lr=cfg["learning_rate"], betas=tuple(cfg["betas"]), eps=cfg["eps"],
                                weight_decay=cfg["weight_decay"])
        records = T.read_filelist(self.filelist)
        symbols = {s: i for i, s in enumerate(T.symbols())}
        batches = T.bucket_batches([r["mel_length"] for r in records], cfg["batch_size"], cfg["bucket_boundaries"], 0)
        ref = {"loss": [], "grad": {}, "update": {}}
        for k in range(CHECK_STEPS):
            pad, idx = batches[k]
            host = T.make_batch(records, idx, pad, cfg["max_text_len"], cfg["n_mels"], (self.seed, 0), symbols)
            batch = tuple(torch.from_numpy(a).to(dev) for a in host)
            gen = torch.Generator(device=dev).manual_seed((self.seed + 1) * 2 ** 32 + k)
            opt.zero_grad(set_to_none=True)
            dur, diff, prior = T.losses(P, batch, cfg, T.Draws(gen, dev), precision)
            loss = dur + diff + prior
            loss.backward()
            for p in P.values():
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            ref["loss"].append(float(loss.detach()))
            if k == 0:
                ref["grad"] = {n: float(p.grad.norm()) for n, p in P.items()}
            for g in opt.param_groups:
                g["lr"] = cfg["learning_rate"] * T.lr_factor(k, cfg["warmup_steps"], self.total_steps)
            opt.step()
        ref["update"] = {n: float((p.detach() - self.weights[n]).norm()) for n, p in P.items()}
        return ref

    def produce_control(self, precision=R.F32) -> None:
        """The reference's own readings in `precision` in place of the
        program's (the float32 configuration's control on the card is this
        under TF32)."""
        self.prog = self.reference(precision)

    def check(self) -> dict:
        ref = self.reference()
        med = float(np.median(list(ref["grad"].values())))
        moved = [n for n in ref["grad"] if ref["grad"][n] >= 1e-3 * med]
        return {
            "loss_rel_err": max(abs(p - r) / abs(r) for p, r in zip(self.prog["loss"], ref["loss"])),
            "grad_norm_gap": leaf_gap(self.prog["grad"], ref["grad"], list(ref["grad"])),
            "update_norm_gap": leaf_gap(self.prog["update"], ref["update"], moved),
            "leaves_left_out": len(ref["grad"]) - len(moved),
        }
