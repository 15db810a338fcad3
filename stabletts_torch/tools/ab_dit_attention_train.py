"""Time the training attention kernels (csrc/attention_train.cuh's core,
through the DiT attention half and through packed attention with dropout) of
the tree in the current directory, for comparing two commits on one GPU, one
after the other:

    cd <parent checkout> && python <this file> parent --outputs DIR
    cd <changed checkout> && python <this file> change --outputs DIR     (then change, parent)

Each run builds that tree's kernels and runs, three times each on the same
seeded inputs and the same Philox key, `chip_smoke.check_train` for
`dit_attention_train` and `chip_smoke.check_attention_train` for
`attention_train` at the decoder's shape in the trainer (B=32, T=1000), f32
and bf16, dropout 0.1 and 0, and at the encoder's (32, 512) in f32. It prints
one JSON line: for the forward and the backward kernel the median ms of each
run, the rel err against the plain version and SDPA's ms where the case has
it; and per case ("... bits") a short hash of each output of one forward and
one backward launch on fixed inputs ("sha": equal hashes mean equal bits).
With --outputs, the first run labelled "parent" saves its f32 outputs there,
and every later run reports each f32 output's rel err against them
("rel_err_vs_parent"; 0 in the second parent run: the same bits).
"""

import argparse
import hashlib
import json
import os
import sys

import numpy as np
import torch


def _hash(t: torch.Tensor) -> str:
    return hashlib.sha1(t.detach().float().contiguous().cpu().numpy().tobytes()).hexdigest()[:12]  # bf16 -> f32 is exact


def _outputs(cs, kind: str, b: int, t: int, dtype, rate: float, dev) -> dict:
    """Every output of one forward and one backward launch of `kind` on inputs
    made from a numpy seed and a fixed Philox key."""
    from stabletts_torch.ops import philox

    seed = philox.draw_seed(torch.Generator(device=dev).manual_seed(b + t), dev)
    heads, c = 4, 256
    if kind == "attention_train":
        from stabletts_torch.ops import attention_train_cuda as A

        rng = np.random.default_rng(b * 131 + t)
        q, k, v, cot = (torch.from_numpy(rng.standard_normal((b, t, c)).astype(np.float32)).to(dev, dtype)
                        for _ in range(4))
        mask = cs._ragged_mask(b, t, dev)
        o, lse, o_lo = A.attention_train_fwd(q, k, v, mask, heads, rate, seed)
        dq, dk, dv = A.attention_train_bwd(q, k, v, mask, heads, rate, seed, o, lse, cot, o_lo)
        return {"o": o, "lse": lse, "dq": dq, "dk": dk, "dv": dv}
    from stabletts_torch.ops import dit_attention_train_cuda as A

    x, mod, mask, ws, cot = cs._train_inputs(kind, b, t, dtype, dev)
    wqkv, bqkv = torch.cat(ws[0:6:2], dim=1).contiguous(), torch.cat(ws[1:6:2]).contiguous()
    out, att, lse, att_lo = A.dit_attention_train_fwd(x, mod, mask, wqkv, bqkv, ws[6], ws[7], heads, rate, seed)
    grads = A.dit_attention_train_bwd(x, mod, mask, wqkv, bqkv, ws[6], ws[7], heads, rate, seed, att, lse, cot,
                                      att_lo=att_lo)
    return {"out": out, "att": att, "lse": lse,
            **dict(zip(["dx", "dmod", "dwqkv", "dbqkv", "dwo", "dbo"], grads))}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("tree", nargs="?", default=os.getcwd())
    ap.add_argument("--outputs", default=None, help="directory for the parent's f32 outputs")
    args = ap.parse_args()
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    out = {"tree": args.tree}
    f32, bf = torch.float32, torch.bfloat16
    cases = [(32, 1000, dtype, rate) for dtype in (f32, bf) for rate in (0.1, 0.0)]
    cases += [(32, 512, f32, rate) for rate in (0.1, 0.0)]
    for kind in ("dit_attention_train", "attention_train"):
        for b, t, dtype, rate in cases:
            if kind == "attention_train":
                runs = [cs.check_attention_train(b, t, dtype, rate, dev) for _ in range(3)]
            else:
                runs = [cs.check_train(kind, b, t, dtype, rate, dev) for _ in range(3)]
            label = f"{b}x{t} {cs.DT_NAME[dtype]} dropout {rate}"
            for half in range(2):
                rows = [r[half] for r in runs]
                out[f"{rows[0]['kernel']} {label}"] = {
                    "ms": [r["ms"] for r in rows], "rel_err": rows[0]["rel_err"],
                    "worst_output": rows[0]["worst_output"], "library_ms": rows[0]["library_ms"]}
            del runs
            outs = _outputs(cs, kind, b, t, dtype, rate, dev)
            bits = {name: {"sha": _hash(o)} for name, o in outs.items()}
            if args.outputs and dtype == f32:
                path = os.path.join(args.outputs, f"{kind} {label}.pt".replace(" ", "_"))
                if os.path.exists(path):
                    ref = torch.load(path)
                    for name, o in outs.items():
                        bits[name]["rel_err_vs_parent"] = cs.rel_err(o, ref[name].to(dev))[0]
                elif args.tree == "parent":
                    os.makedirs(args.outputs, exist_ok=True)
                    torch.save({n: o.cpu() for n, o in outs.items()}, path)
            out[f"{kind} {label} bits"] = bits
            del outs
            torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
