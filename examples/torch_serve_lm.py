"""Batched serving on the card with prefill + a decode loop (KV/state
caches).

The PyTorch/CUDA port's counterpart of ``examples/serve_lm.py``: both a
full-attention arch (ring-buffer KV cache) and sub-quadratic ones
(recurrentgemma: RG-LRU state + local window; mamba2: SSM state), the
cache regimes behind the decode_32k / long_500k dry-run shapes, and MoE
decode.  Smoke configs, random weights from a seed, the same prompts
from the same numpy draws.

  python examples/torch_serve_lm.py              (the card)
  python examples/torch_serve_lm.py --device cpu
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import configs as CFG  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.solver import resolve_device  # noqa: E402

ARCHS = ("qwen3-8b",             # full attention, ring KV cache
         "recurrentgemma-2b",    # RG-LRU state + 2048-window local attn
         "mamba2-130m",          # pure SSM state
         "moonshot-v1-16b-a3b")  # MoE decode


def demo(arch: str, device, batch: int = 4, prompt: int = 64,
         gen: int = 48):
    cfg = CFG.get_smoke_config(arch)
    params = M.init_params(cfg, torch.Generator(device=device).manual_seed(0))
    eng = ServeEngine(cfg, params, max_len=prompt + gen, temperature=0.8)
    rng = np.random.default_rng(0)
    b = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (batch, prompt))).to(
        device=device, dtype=torch.int32)}
    if cfg.num_prefix_embeds:
        b["embeds"] = torch.from_numpy(rng.standard_normal(
            (batch, cfg.num_prefix_embeds, cfg.d_model))).to(
            device=device, dtype=getattr(torch, cfg.dtype))
    t0 = time.perf_counter()
    toks, _ = eng.generate(
        b, steps=gen, generator=torch.Generator(device=device).manual_seed(7))
    toks = toks.cpu()  # the one read back
    dt = time.perf_counter() - t0
    kinds = ",".join(sorted(set(cfg.block_pattern)))
    print(f"[serve] {arch:22s} mixers=({kinds}) batch={batch} "
          f"prompt={prompt} gen={gen}: {batch * gen / dt:7.1f} tok/s "
          f"(incl. first-call setup)")
    return toks


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default: the card)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=64)
    ap.add_argument("--gen", type=int, default=48)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    out = {}
    for arch in ARCHS:
        toks = demo(arch, device, args.batch, args.prompt, args.gen)
        vocab = CFG.get_smoke_config(arch).vocab_size
        out[arch] = {"shape": tuple(toks.shape),
                     "in_vocab": bool(((toks >= 0) & (toks < vocab)).all())}
    return out


if __name__ == "__main__":
    main()
