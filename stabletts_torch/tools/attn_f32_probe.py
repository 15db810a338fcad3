"""Which query tile the f32 serving attention core should take, on one GPU.

    python -m stabletts_torch.tools.attn_f32_probe [--calls 20]

Builds `csrc/attention_packed.cu` twice, from a copy of the sources as they
are ("as_built": `ATF_BQ` in csrc/attention.cuh, 64 query rows a CTA, 4
queries x 8 keys a thread) and with `ATF_BQ` 128 ("bq_128": 8 x 8). Each
build runs packed attention in both layouts, f32, at a request's 2B = 2,
T = 1024 with every key valid and with the request's mask (313 valid frames
an item), and at the bench batch's 2B = 16, T = 1024 with every key valid
and with a ragged mask, two rounds in opposite orders.
A case's time is the kernel's device ms a call from torch.profiler over
`--calls` calls (a request's core runs shorter than the host takes to issue
a call). Every build is checked against the plain version on the valid
rows. It prints one JSON line per build and case, then the card line.
Nothing of the port calls it.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess

import numpy as np
import torch

TILE = "constexpr int ATF_BQ = 64;"
CASES = [(2, 1024, "none"), (2, 1024, "request"), (16, 1024, "none"), (16, 1024, "ragged")]


def _build_variants(_build) -> dict:
    src = open(os.path.join(_build.CSRC_DIR, "attention.cuh")).read()
    if src.count(TILE) != 1:
        raise RuntimeError("attn_f32_probe: the query tile is not found once in attention.cuh; update the probe")
    variants = {"as_built": src, "bq_128": src.replace(TILE, "constexpr int ATF_BQ = 128;")}
    procs = {}
    for name, text in variants.items():
        d = os.path.join(_build.BUILD_DIR, "attn_probe", name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(_build.CSRC_DIR, d)
        with open(os.path.join(d, "attention.cuh"), "w") as f:
            f.write(text)
        lib = os.path.join(d, "libattention_packed.so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", d, "-o", lib, os.path.join(d, "attention_packed.cu")]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the {name} build:\n{out}")
        libs[name] = ctypes.CDLL(lib)
    return libs


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--calls", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("attn_f32_probe measures the kernel on a GPU; none is present")
    from stabletts_torch.ops import _build
    from stabletts_torch.ops import attention_packed_cuda as ap_
    from stabletts_torch.tools.device_time import device_ms

    _build.build_all()
    libs = _build_variants(_build)
    dev = torch.device("cuda")
    inputs = {}
    for b, t, kind in CASES:
        rng = np.random.default_rng(0)
        q, k, v = (torch.from_numpy(rng.standard_normal((b, t, 256)).astype(np.float32)).to(dev) for _ in range(3))
        lengths = {"none": [t] * b, "request": [313] * b, "ragged": [t - (i * 37) % (t // 2) for i in range(b)]}[kind]
        mask = (torch.arange(t, device=dev)[None, :] < torch.tensor(lengths, device=dev)[:, None]).float()
        inputs[(b, t, kind)] = (q, k, v, None if kind == "none" else mask, mask > 0)
    rows = {}
    for order in (list(libs), list(reversed(libs))):
        for name in order:
            _build._libs["attention_packed"] = libs[name]
            for (b, t, kind), (q, k, v, mask, valid) in inputs.items():
                for tminor in (False, True):
                    args_ = [a.transpose(1, 2).contiguous() for a in (q, k, v)] if tminor else [q, k, v]
                    fn = ap_.attention_packed_t if tminor else ap_.attention_packed
                    plain = ap_.attention_packed_t_plain if tminor else ap_.attention_packed_plain
                    row = rows.setdefault((name, b, t, kind, tminor), {
                        "build": name, "layout": "tminor" if tminor else "tc", "B": b, "T": t, "mask": kind,
                        "device_ms": []})
                    by = device_ms(lambda: fn(*args_, mask, n_heads=4), args.calls)[1]
                    row["device_ms"].append(sum(ms for kernel, ms in by.items() if "attention_kernel" in kernel))
                    if "rel_err" not in row:
                        got, want = fn(*args_, mask, n_heads=4), plain(*args_, mask, n_heads=4)
                        if tminor:
                            got, want = got.transpose(1, 2), want.transpose(1, 2)
                        got, want = got[valid], want[valid]
                        row["rel_err"] = ((got - want).abs().max() / want.abs().max()).item()
    for row in rows.values():
        print(json.dumps(row), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=False).stdout.strip()
    print(smi or torch.cuda.get_device_name(0))


if __name__ == "__main__":
    main()
