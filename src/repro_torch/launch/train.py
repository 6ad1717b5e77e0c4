"""Training launcher.

Port of ``repro/launch/train.py`` with ``--device`` (default ``cuda``,
the current card; raises without one): ``--smoke`` swaps in the reduced
config, which runs on the CPU.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-8b \
      --smoke --steps 20 --batch 4 --seq 64 --ckpt-dir /tmp/ckpt \
      --device cpu
"""

from __future__ import annotations

import argparse

import torch

from repro_torch import configs as CFG
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.optim.muon import MuonConfig
from repro_torch.solver import resolve_device
from repro_torch.train.loop import TrainLoop
from repro_torch.train.step import make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=0.02)
    ap.add_argument("--method", default="zolo",
                    choices=["zolo", "qdwh", "ns5"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default: the card)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = (CFG.get_smoke_config(args.arch) if args.smoke
           else CFG.get_config(args.arch))
    muon = MuonConfig(lr=args.lr, method=args.method)
    init_fn, step_fn = make_train_step(cfg, muon, total_steps=args.steps)

    data = SyntheticLM(cfg.vocab_size, args.seq, args.batch,
                       num_prefix_embeds=cfg.num_prefix_embeds,
                       d_model=cfg.d_model, dtype=cfg.dtype, seed=args.seed,
                       device=str(device))
    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    loop = TrainLoop(step_fn, data, ckpt=ckpt, ckpt_every=args.ckpt_every,
                     log_path=args.log,
                     tokens_per_step=args.batch * args.seq)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    state = loop.resume_or_init(init_fn, gen)
    state = loop.run(state, args.steps)
    print(f"[train] finished at step {int(state.step)}")
    return state


if __name__ == "__main__":
    main()
