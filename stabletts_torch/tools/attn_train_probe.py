"""Device ms of each kernel of the training attention core (csrc/attention_train.cuh) on the GPU: packed
attention with dropout (`attention_train_fwd` and `attention_train_bwd`) on seeded inputs, ten forward and
backward calls under torch.profiler, averaged per call. One JSON line per case:

    python -m stabletts_torch.tools.attn_train_probe                 # f32, (32, 1000) and (32, 512), dropout 0.1 and 0
    python -m stabletts_torch.tools.attn_train_probe --dtype bfloat16 --b 32 --t 1000
"""

import argparse
import json

import numpy as np
import torch


def probe(b: int, t: int, dtype, rate: float, calls: int = 10) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from stabletts_torch.ops import attention_train_cuda as A
    from stabletts_torch.ops import philox

    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    q, k, v, cot = (torch.from_numpy(rng.standard_normal((b, t, 256)).astype(np.float32)).to(dev, dtype)
                    for _ in range(4))
    lengths = torch.tensor([t - (i * 37) % max(1, t // 2) for i in range(b)], device=dev)
    mask = (torch.arange(t, device=dev)[None, :] < lengths[:, None]).float()
    seed = philox.draw_seed(torch.Generator(device=dev).manual_seed(3), dev)

    def step():
        o, lse, o_lo = A.attention_train_fwd(q, k, v, mask, 4, rate, seed)
        A.attention_train_bwd(q, k, v, mask, 4, rate, seed, o, lse, cot, o_lo)

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            step()
        torch.cuda.synchronize()
    kernels = {e.key.split("(")[0]: e.self_device_time_total / e.count / 1e3 for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0}
    return {"B": b, "T": t, "dtype": str(dtype).removeprefix("torch."), "dropout": rate,
            "device_ms_per_call": kernels, "card": torch.cuda.get_device_name(0)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"))
    ap.add_argument("--b", type=int, nargs="*", default=[32, 32])
    ap.add_argument("--t", type=int, nargs="*", default=[1000, 512])
    ap.add_argument("--rate", type=float, nargs="*", default=[0.1, 0.0])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("attn_train_probe: needs a CUDA device")
    for b, t in zip(args.b, args.t):
        for rate in args.rate:
            print(json.dumps(probe(b, t, getattr(torch, args.dtype), rate)), flush=True)


if __name__ == "__main__":
    main()
