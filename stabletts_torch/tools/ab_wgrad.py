"""Time the kernels built on common.cuh's weight-gradient GEMM and column
sums, of the tree in the current directory, for comparing two commits on one
GPU, one after the other:

    cd <parent checkout> && python <this file> parent
    cd <changed checkout> && python <this file> change     (then change, parent)

Each run builds that tree's kernels and runs, three times each on the same
seeded inputs, that tree's `chip_smoke` checks of the backward kernels whose
weight gradients and bias sums these are: #11 and #12 (`check_train`, (32,
1000), dropout 0.1) and #13 (`check_prenet_train`, (32, 1000)), bf16 and f32;
and, where the tree has them, `check_wgrad` at the training step's four
products and `check_colsum` at its three shapes. It prints one JSON line: per
case the median ms of each run, the rel err against the plain version (the
worst gradient's for a backward) and the library call's ms where the case
has one, and per backward a short hash of each output of one launch on fixed
inputs (and of its forward's output, "out"), so that equal hashes in two
trees mean equal bits, beside that output's rel err against autograd through
the plain version on the same inputs.
"""

import hashlib
import json
import os
import sys

import numpy as np
import torch


def _hash(t: torch.Tensor) -> str:
    return hashlib.sha1(t.detach().float().contiguous().cpu().numpy().tobytes()).hexdigest()[:12]  # bf16 -> f32 is exact


def _backward_bits(kind: str, dtype, dev, rel_err) -> dict:
    """Each output of one backward launch at (32, 1000), dropout 0.1, as a
    hash and its rel err against autograd through the plain version, and the
    same for the output of one forward launch ("out"); the inputs come from a
    numpy seed, the dropout key from a fixed generator."""
    from stabletts_torch.ops import philox

    b, t, c, f, heads = 32, 1000, 256, 1024, 4
    rng = np.random.default_rng(77)
    g = lambda *s, scale=1.0: torch.from_numpy((rng.standard_normal(s) * scale).astype(np.float32)).to(dev, dtype)
    seed = philox.draw_seed(torch.Generator(device=dev).manual_seed(5), dev)
    lengths = torch.tensor([t - (i * 37) % (t // 2) for i in range(b)], device=dev)
    mask = (torch.arange(t, device=dev)[None, :] < lengths[:, None]).float()
    x, mod = g(b, t, c) * mask[..., None].to(dtype), g(b, 3, c, scale=0.3)
    if kind == "ffn_train":
        from stabletts_torch.ops import ffn_train_cuda as F

        ws = [g(3, c, f, scale=(3 * c) ** -0.5), g(f, scale=0.05), g(3, f, c, scale=(3 * f) ** -0.5), g(c, scale=0.05)]
        cot = g(b, t, c)
        fwd = F.ffn_train_fwd(x, mod, mask, *ws, 0.1, seed)
        outs = F.ffn_train_bwd(x, mod, mask, *ws, 0.1, seed, cot)
        names = ["dx", "dmod", "dw1", "db1", "dw2", "db2"]
        leaves = [a.detach().clone().requires_grad_() for a in (x, mod, *ws)]
        fwd_plain = F.ffn_train_plain(leaves[0], leaves[1], mask, *leaves[2:], 0.1, seed)
        plain = torch.autograd.grad(fwd_plain, leaves, cot)
    elif kind == "dit_attention_train":
        from stabletts_torch.ops import dit_attention_train_cuda as A

        wqkv, bqkv, wo, bo = g(c, 3 * c, scale=c ** -0.5), g(3 * c, scale=0.05), g(c, c, scale=c ** -0.5), g(c, scale=0.05)
        cot = g(b, t, c)
        fwd, att, lse, att_lo = A.dit_attention_train_fwd(x, mod, mask, wqkv, bqkv, wo, bo, heads, 0.1, seed)
        outs = A.dit_attention_train_bwd(x, mod, mask, wqkv, bqkv, wo, bo, heads, 0.1, seed, att, lse, cot,
                                         att_lo=att_lo)
        names = ["dx", "dmod", "dwqkv", "dbqkv", "dwo", "dbo"]
        split = [wqkv[:, :c], bqkv[:c], wqkv[:, c:2 * c], bqkv[c:2 * c], wqkv[:, 2 * c:], bqkv[2 * c:], wo, bo]
        leaves = [a.detach().clone().requires_grad_() for a in (x, mod, *split)]
        fwd_plain = A.dit_attention_train_plain(leaves[0], leaves[1], mask, *leaves[2:], heads, 0.1, seed)
        gp = torch.autograd.grad(fwd_plain, leaves, cot)
        plain = [gp[0], gp[1], torch.cat(gp[2:8:2], dim=1), torch.cat(gp[3:8:2]), gp[8], gp[9]]
    else:
        from stabletts_torch.ops import prenet_train_cuda as P

        cin = 128
        ws = [g(3, cin, f, scale=(3 * cin) ** -0.5), g(f, scale=0.05), g(3, f, f, scale=(3 * f) ** -0.5),
              g(f, scale=0.05), g(3, f, c, scale=(3 * f) ** -0.5), g(c, scale=0.05)]
        mu, cot = g(b, t, cin), g(b, t, c)
        fwd = P.prenet_train_fwd(mu, *ws)
        outs = P.prenet_train_bwd(mu, *ws, cot)
        names = ["dmu", "dwa", "dba", "dwb", "dbb", "dwc", "dbc"]
        leaves = [a.detach().clone().requires_grad_() for a in (mu, *ws)]
        fwd_plain = P.prenet_train_plain(*leaves)
        plain = torch.autograd.grad(fwd_plain, leaves, cot)
    return {name: {"sha": _hash(o), "rel_err": rel_err(o, r)[0]}
            for name, o, r in zip(["out", *names], [fwd, *outs], [fwd_plain, *plain])}


def main() -> None:
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    bf, f32 = torch.bfloat16, torch.float32
    out = {"tree": sys.argv[1] if len(sys.argv) > 1 else os.getcwd()}
    rng = lambda: np.random.default_rng(1234)
    cases = []
    for dtype in (bf, f32):
        name = cs.DT_NAME[dtype]
        for kind in ("dit_attention_train", "ffn_train"):
            cases.append((f"{kind} 32x1000 {name} dropout 0.1",
                          lambda kind=kind, dtype=dtype: cs.check_train(kind, 32, 1000, dtype, 0.1, dev)))
        cases.append((f"prenet_train 32x1000 {name}", lambda dtype=dtype: cs.check_prenet_train(32, 1000, dtype, dev)))
        if hasattr(cs, "check_wgrad"):
            cases += [(f"wgrad {p} 32x1000 {name}", lambda p=p, dtype=dtype: [cs.check_wgrad(rng(), 32, 1000, dtype,
                                                                                              dev, p)])
                      for p in cs.WGRAD_SHAPES]
            cases += [(f"colsum {groups}x{32000 // groups}x{n} {name}",
                       lambda n=n, groups=groups, dtype=dtype: [cs.check_colsum(rng(), 32, 1000, dtype, dev, n,
                                                                                groups)])
                      for n, groups in ((256, 1), (1024, 1), (256, 32))]
    for label, run in cases:
        runs = [run() for _ in range(3)]
        for i, row in enumerate(runs[0]):
            key = label if len(runs[0]) == 1 else f"{label} {row['kernel'].rsplit('_', 1)[1]}"
            out[key] = {"ms": [r[i]["ms"] for r in runs], "rel_err": row["rel_err"],
                        "ok": all(r[i]["ok"] for r in runs)}
            if "library_ms" in row and row["library_ms"] is not None:
                out[key]["library_ms"] = row["library_ms"]
        torch.cuda.empty_cache()
    for dtype in (bf, f32):
        for kind in ("dit_attention_train", "ffn_train", "prenet_train"):
            out[f"{kind}_bwd bits {cs.DT_NAME[dtype]}"] = _backward_bits(kind, dtype, dev, cs.rel_err)
            torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
