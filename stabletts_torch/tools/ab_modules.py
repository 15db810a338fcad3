"""Hash the model modules' outputs and training gradients in the tree of the
current directory, to compare two commits on one GPU (run from each checkout,
parent, change, change, parent: `python <this file> <tree name>`).

StableTTS's DiTConVBlock at 3 and 5 taps (eval f32 and bf16, train f32 with
dropout), F5-TTS's DiTBlock (eval f32 and bf16), the estimator's Decoder and
Vocos (train f32), and `ops.attention.masked_attention`. A hash is the first 16
hex digits of the sha256 of the values as f32 (equal hashes, equal bits). Each
case runs twice, under cuDNN's deterministic algorithms; `repeatable` names the
cases whose two runs gave equal bits. Prints one JSON line, with the launches
of each kernel that ran and the card."""

import copy
import hashlib
import importlib
import json
import os
import pkgutil
import sys

import numpy as np
import torch


def main() -> None:
    sys.path.insert(0, os.getcwd())
    from stabletts_torch.config import MelConfig, VocosConfig
    from stabletts_torch.models.estimator import Decoder
    from stabletts_torch.models.f5tts import DiTBlock
    from stabletts_torch.models.vocos import Vocos
    from stabletts_torch.nn import blocks as tb
    from stabletts_torch import ops
    from stabletts_torch.ops import attention as tattn

    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    # every kernel wrapper of the ops package, by its launch counter
    wrappers = (vars(importlib.import_module(f"stabletts_torch.ops.{m.name}")).values()
                for m in pkgutil.iter_modules(ops.__path__) if m.name.endswith("_cuda"))
    kernels = {fn.__name__: fn for fns in wrappers for fn in fns if isinstance(getattr(fn, "launches", None), int)}
    before = {k: fn.launches for k, fn in kernels.items()}
    rng = np.random.default_rng(0)
    g = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dev)
    lengths = torch.tensor([1024, 700, 313, 1000] * 4, device=dev)
    mask = (torch.arange(1024, device=dev)[None, :] < lengths[:, None]).float()
    x, cond = g(16, 1024, 256) * mask[..., None], g(16, 256)

    def train(module, *args, gen_seed=None, **kw):
        module.train().zero_grad()
        if gen_seed is not None:
            kw["gen"] = torch.Generator(device=dev).manual_seed(gen_seed)
        o = module(*args, **kw)
        (o * torch.linspace(-1, 1, o.shape[-1], device=dev)).sum().backward()
        return [o] + [p.grad for p in module.parameters() if p.grad is not None]

    cases = {}
    for ks in (3, 5):
        torch.manual_seed(ks)
        blk = tb.DiTConVBlock(256, 1024, 4, ks, 256, p_dropout=0.1).to(dev)
        torch.nn.init.normal_(blk.adaLN_modulation[2].weight, std=0.05)
        b16 = copy.deepcopy(blk).to(torch.bfloat16).eval()
        cases[f"stts_k{ks}_eval_f32"] = lambda blk=blk: [blk.eval()(x, cond, mask)]
        cases[f"stts_k{ks}_eval_bf16"] = lambda b16=b16: [b16(x.bfloat16(), cond.bfloat16(), mask)]
        cases[f"stts_k{ks}_train_f32"] = lambda blk=blk: train(blk, x, cond, mask, gen_seed=3)
    torch.manual_seed(1)
    f5 = DiTBlock(1024, 16, 64, 2).to(dev).eval()
    f5_16 = copy.deepcopy(f5).to(torch.bfloat16)
    mf = (torch.arange(700, device=dev)[None, :] < torch.tensor([700, 650, 400, 123], device=dev)[:, None]).float()
    xf, tf = g(4, 700, 1024) * mf[..., None], g(4, 1024)
    cases["f5_eval_f32"] = lambda: [f5(xf, tf, mf)]
    cases["f5_eval_bf16"] = lambda: [f5_16(xf.bfloat16(), tf.bfloat16(), mf)]
    torch.manual_seed(2)
    dec = Decoder(128, 128, 256, 128, 1024, n_layers=6, n_heads=4, gin_channels=256, p_dropout=0.1).to(dev)
    t_dec, x_dec, mu_dec = torch.rand(16, device=dev), g(16, 1024, 128), g(16, 1024, 128)
    cases["decoder_train_f32"] = lambda: train(dec, t_dec, x_dec, mask, mu_dec, cond, gen_seed=4)
    torch.manual_seed(3)
    voc = Vocos(VocosConfig(), MelConfig(), device=dev)
    mel = g(4, 64, 128)
    cases["vocos_train_f32"] = lambda: train(voc, mel)
    q, k, v = g(2, 1000, 4, 64), g(2, 1000, 4, 64), g(2, 1000, 4, 64)
    am = (torch.arange(1000, device=dev)[None, :] < torch.tensor([1000, 417], device=dev)[:, None]).float()
    cases["masked_attention"] = lambda: [tattn.masked_attention(q, k, v, mask=am) * am[:, :, None, None]]

    h = lambda ts: hashlib.sha256(b"".join(t.detach().float().cpu().numpy().tobytes() for t in ts)).hexdigest()[:16]
    out, repeatable = {"tree": sys.argv[1] if len(sys.argv) > 1 else "tree"}, []
    for name, fn in cases.items():
        grad = torch.enable_grad() if name.endswith("_train_f32") else torch.no_grad()
        with grad:
            first, second = h(fn()), h(fn())
        out[name] = first
        if first == second:
            repeatable.append(name)
    out["repeatable"] = repeatable
    out["launches"] = {k: fn.launches - before[k] for k, fn in sorted(kernels.items()) if fn.launches > before[k]}
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader 2>/dev/null").read().strip()
    out["card"] = smi or "cpu"
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
