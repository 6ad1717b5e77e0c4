"""Serving launcher.

Port of ``repro/launch/serve.py`` with ``--device`` (default ``cuda``,
the current card; raises without one): ``--smoke`` swaps in the reduced
config, which runs on the CPU.

  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch recurrentgemma-2b --smoke --batch 4 --prompt-len 64 --gen 32 \
      --device cpu
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs as CFG
from repro_torch.models import model as M
from repro_torch.serve.engine import ServeEngine
from repro_torch.solver import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-sized)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default: the card)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = (CFG.get_smoke_config(args.arch) if args.smoke
           else CFG.get_config(args.arch))
    params = M.init_params(
        cfg, torch.Generator(device=device).manual_seed(args.seed))
    eng = ServeEngine(cfg, params, max_len=args.prompt_len + args.gen,
                      temperature=args.temperature)
    rng = np.random.default_rng(args.seed)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len))).to(
        device=device, dtype=torch.int32)}
    if cfg.num_prefix_embeds:
        batch["embeds"] = torch.from_numpy(rng.standard_normal(
            (args.batch, cfg.num_prefix_embeds, cfg.d_model))).to(
            device=device, dtype=getattr(torch, cfg.dtype))
    gen = torch.Generator(device=device).manual_seed(args.seed)
    t0 = time.perf_counter()
    toks, _ = eng.generate(batch, steps=args.gen, generator=gen)
    toks = toks.cpu()  # the one read back
    dt = time.perf_counter() - t0
    print(f"[serve] generated {tuple(toks.shape)} in {dt:.2f}s "
          f"({args.batch * args.gen / dt:.1f} tok/s)")
    print(toks[:, :16].numpy())
    return toks


if __name__ == "__main__":
    main()
