"""Time the Vocos ISTFT head (csrc/istft.cu, #3) of the tree in the current
directory, for comparing two commits on one GPU, one after the other:

    cd <parent checkout> && python <this file> parent
    cd <changed checkout> && python <this file> change     (then change, parent)

Each run builds that tree's kernels and runs, on inputs made here from a seed
(so that every tree runs the same cases with the same code):

  * `istft_head(re, im, n_fft=2048, hop=512, ...)`, the entry both trees
    have, at `bench.py`'s batch (192, 1000) and (8, 1000) in bf16, a
    request's (1, 313) and (1, 1000) in f32, (1, 1024) in f32 with lengths
    [313] (the API's fixed-shape mode) and (8, 1000) in f32 with ragged
    lengths: per case the CUDA-event median ms of three runs ("ms"), the
    plain version's ("plain_ms", `istft_same_real` on the card), the device
    ms of one call from torch.profiler ("device_ms", every kernel the call
    launches, and "by_kernel"), the rel err against the plain version and a
    short hash of the output ("sha"; equal hashes = equal bits);
  * the whole head from its Dense output at the bench batch and at (8, 1000)
    in bf16 and at (1, 313) in f32 ("head ..."): the tree's eval path, which
    is `istft_head_from_logits` where the tree has it and otherwise the
    chain the parent's `ISTFTHead` ran (exp, clamp, cos, sin in f32, then
    `istft_head`), against that chain on the card;
  * where the tree has them, the f32 product at each CTA tile ("tile 64",
    "tile 128" device ms), and, as a yardstick that is not the same function,
    one `torch.matmul` of the frames product alone (spec [B*T, 2050] @ W
    [2050, 2048], the same FLOPs, no overlap-add) at the bf16 cases.

It prints one JSON line with the card's name and power limit.
"""

import hashlib
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import torch

N_FFT, HOP = 2048, 512
# (B, T, dtype, lengths or None)
CASES = [(192, 1000, torch.bfloat16, None), (8, 1000, torch.bfloat16, None), (1, 313, torch.float32, None),
         (1, 1000, torch.float32, None), (1, 1024, torch.float32, [313]),
         (8, 1000, torch.float32, [1000 - (i * 53) % 500 for i in range(8)])]
HEAD_CASES = [(192, 1000, torch.bfloat16), (8, 1000, torch.bfloat16), (1, 313, torch.float32)]


def _device_time():
    """tools/device_time.py, loaded from beside this file (the tree under test may lack it)."""
    spec = importlib.util.spec_from_file_location("device_time", os.path.join(os.path.dirname(__file__),
                                                                              "device_time.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.device_ms


def _sha(x: torch.Tensor) -> str:
    return hashlib.sha256(x.float().cpu().numpy().tobytes()).hexdigest()[:16]


def _spectrum(rng, b, t, dev):
    nf = N_FFT // 2 + 1
    mag = np.exp(np.clip(rng.standard_normal((b, t, nf)), None, np.log(100.0)))
    phase = rng.uniform(-np.pi, np.pi, (b, t, nf))
    return (torch.from_numpy((mag * np.cos(phase)).astype(np.float32)).to(dev),
            torch.from_numpy((mag * np.sin(phase)).astype(np.float32)).to(dev))


def _chain(x):
    """The parent's eval head after its Dense (models/vocos.py), in f32."""
    mag, p = x.float().chunk(2, dim=-1)
    mag = torch.clamp(torch.exp(mag), max=1e2)
    return mag * torch.cos(p), mag * torch.sin(p)


def main() -> None:
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from stabletts_torch.ops import istft_cuda
    from stabletts_torch.ops.istft import idft_matrix_windowed, istft_same_real

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    device_ms = _device_time()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=False).stdout.strip()
    out = {"tree": sys.argv[1] if len(sys.argv) > 1 else os.getcwd(), "card": smi}
    for b, t, dtype, lengths in CASES:
        rng = np.random.default_rng(1234)
        re, im = _spectrum(rng, b, t, dev)
        md = None if dtype == torch.float32 else dtype
        lens = None if lengths is None else torch.tensor(lengths, device=dev)
        fm = None if lens is None else (torch.arange(t, device=dev)[None, :] < lens[:, None]).float()
        run = lambda: istft_cuda.istft_head(re, im, N_FFT, HOP, md, lens)
        plain = lambda: istft_same_real(re, im, N_FFT, HOP, N_FFT, md, fm)
        got = run()
        total, by = device_ms(run)
        row = {"ms": [cs.time_ms(run) for _ in range(3)], "plain_ms": cs.time_ms(plain, iters=3), "device_ms": total,
               "by_kernel": by, "rel_err": cs.rel_err(got, plain())[0], "sha": _sha(got)}
        if md is None and hasattr(istft_cuda, "istft_product"):
            a = istft_cuda.istft_spectrum(re, N_FFT, md, lens, im=im)
            for tile in (64, 128):
                fn = lambda: istft_cuda.istft_product(a, b, t, N_FFT, HOP, lens, tile=tile)
                row[f"tile {tile}"] = {"device_ms": device_ms(fn)[0], "rel_err": cs.rel_err(fn(), plain())[0]}
        if md is not None:
            spec = torch.cat([re, im], -1).reshape(b * t, -1).to(dtype)
            w = idft_matrix_windowed(N_FFT, N_FFT, dev, dtype)
            row["frames_matmul_device_ms_not_the_same_function"] = device_ms(lambda: torch.matmul(spec, w))[0]
            del spec
        out[f"istft {b}x{t} {cs.DT_NAME[dtype]}{'' if lengths is None else ' lengths'}"] = row
        del re, im, got
        torch.cuda.empty_cache()
    for b, t, dtype in HEAD_CASES:
        rng = np.random.default_rng(99)
        nf = N_FFT // 2 + 1
        logits = np.concatenate([rng.standard_normal((b, t, nf)) * 2.0, rng.standard_normal((b, t, nf)) * 6.0], -1)
        x = torch.from_numpy(logits.astype(np.float32)).to(dev, dtype)
        md = None if dtype == torch.float32 else dtype
        if hasattr(istft_cuda, "istft_head_from_logits"):
            run = lambda: istft_cuda.istft_head_from_logits(x, N_FFT, HOP, md)
        else:
            run = lambda: istft_cuda.istft_head(*_chain(x), N_FFT, HOP, md)
        plain = lambda: istft_same_real(*_chain(x), N_FFT, HOP, N_FFT, md)
        got = run()
        total, by = device_ms(run)
        out[f"head {b}x{t} {cs.DT_NAME[dtype]}"] = {
            "ms": [cs.time_ms(run) for _ in range(3)], "device_ms": total, "by_kernel": by,
            "rel_err": cs.rel_err(got, plain())[0], "sha": _sha(got)}
        del x, got
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
