"""End-to-end training on the card: LM + ZoloMuon (the paper's PD
inside every step, on the hand-written kernels), with checkpoint/restart
and metrics.

The PyTorch/CUDA port's counterpart of ``examples/train_lm.py``.
Default: a ~15M-param mamba2-family model for 200 steps (CPU-sized).
``--arch``/``--steps``/``--full`` scale it up; rerun on the same
``--ckpt-dir`` with more ``--steps`` to resume from its last checkpoint.

  python examples/torch_train_lm.py                         (the card)
  python examples/torch_train_lm.py --arch qwen3-8b --steps 50
  python examples/torch_train_lm.py --device cpu --steps 20
"""

import argparse
import dataclasses
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))

import torch  # noqa: E402

from repro_torch import configs as CFG  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.optim.muon import MuonConfig  # noqa: E402
from repro_torch.solver import resolve_device  # noqa: E402
from repro_torch.train.loop import TrainLoop  # noqa: E402
from repro_torch.train.step import make_train_step  # noqa: E402


def cpu_sized_config(arch: str):
    """~15M params: big enough to exercise every code path, small enough
    for a few hundred CPU steps."""
    cfg = CFG.get_config(arch)
    return dataclasses.replace(
        cfg, num_layers=max(len(cfg.block_pattern) * 2,
                            4 - (4 % len(cfg.block_pattern))),
        d_model=256,
        num_heads=4 if cfg.num_heads else 0,
        num_kv_heads=min(cfg.num_kv_heads, 4) if cfg.num_kv_heads else 0,
        head_dim=64 if cfg.num_heads else 0,
        d_ff=min(cfg.d_ff, 1024) if cfg.d_ff else 0,
        rnn_width=256 if cfg.rnn_width else 0,
        vocab_size=min(cfg.vocab_size, 8192),
        num_experts=min(cfg.num_experts, 8) if cfg.num_experts else 0,
        moe_top_k=min(cfg.moe_top_k, 2) if cfg.moe_top_k else 0,
        window=min(cfg.window, 256) if cfg.window else None,
        num_prefix_embeds=min(cfg.num_prefix_embeds, 16),
        dtype="float32",
    ).validate()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="mamba2-130m")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--method", default="zolo",
                    choices=["zolo", "qdwh", "ns5"])
    ap.add_argument("--full", action="store_true",
                    help="use the full assigned config (not CPU-sized)")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = CFG.get_config(args.arch) if args.full \
        else cpu_sized_config(args.arch)
    init_fn, step_fn = make_train_step(
        cfg, MuonConfig(lr=0.02, method=args.method),
        total_steps=args.steps)
    data = SyntheticLM(cfg.vocab_size, args.seq, args.batch,
                       num_prefix_embeds=cfg.num_prefix_embeds,
                       d_model=cfg.d_model, dtype=cfg.dtype,
                       device=str(device))
    ckpt = CheckpointManager(args.ckpt_dir, keep_k=2)
    loop = TrainLoop(step_fn, data, ckpt=ckpt, ckpt_every=50, log_every=10,
                     tokens_per_step=args.batch * args.seq)
    state = loop.resume_or_init(
        init_fn, torch.Generator(device=device).manual_seed(0))
    start = int(state.step)
    n_params = M.param_count(state.params)
    print(f"[train_lm] arch={cfg.name} params={n_params:,} "
          f"optimizer=ZoloMuon({args.method}) device={device}")
    state = loop.run(state, args.steps)
    print(f"[train_lm] done at step {int(state.step)}; "
          f"checkpoints in {args.ckpt_dir}")
    return {"arch": cfg.name, "params": n_params, "start_step": start,
            "step": int(state.step), "latest_ckpt": ckpt.latest_step()}


if __name__ == "__main__":
    main()
