#!/usr/bin/env python3
"""The control's readings, from which (with the program's own) the
limits of ``correct`` are set: the reference put in the program's place,
computed in the precision below the configuration's (the exact answer
rounded to TF32, for a configuration in float32 with TF32 off), judged
as a run judges the program.

    python3 bench/control.py --workload <cell> --seeds <n> [<n> ...]

For each seed it builds the cell's inputs as a run with that seed does
and prints one JSON line of the cell's numbers.  The benchmark's own
runs never run this.  It needs a card, as the benchmark does, unless
``--device cpu`` is given with ``--small``, which shrinks the cell to
the sizes of the CPU tests.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

BENCH = pathlib.Path(__file__).resolve().parent
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from harness import manifest as _manifest  # noqa: E402

SMALL_MATRIX = {"n": 192}
SMALL_TOPK = {"k": 16}


def cell_files(cell_name: str, small: bool):
    """(cell, config, traffic) of a cell, shrunk to the CPU tests' sizes when
    ``small``."""
    manifest = _manifest.load_manifest()
    cell = _manifest.by_name(manifest["workloads"], cell_name, "workload")
    config = _manifest.load_json("configs", cell["config"])
    traffic = _manifest.load_json("traffic", cell["traffic"])
    if small:
        config["matrix"].update(SMALL_MATRIX)
        if traffic["request"] == "topk":
            traffic.update(SMALL_TOPK)
    return cell, config, traffic


def readings(cell_name: str, seed: int, device, small: bool = False) -> dict:
    """The control's numbers over the ring of a run with ``seed``: the
    worst over the members, as a run reports the worst over its
    answers."""
    import torch

    from harness.traffic import ring_scale

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell, config, traffic = cell_files(cell_name, small)
    ref = _manifest.load_module("reference", cell["config"])
    mat = config["matrix"]
    n, kappa = int(mat["n"]), float(mat["kappa"])
    topk = traffic["request"] == "topk"
    k = int(traffic["k"]) if topk else 0
    numbers = ref.topk_numbers if topk else ref.dense_numbers
    device = torch.device(device)
    worst = {}
    for j in range(int(traffic["ring"])):
        js = _manifest.sub_seed(seed, f"ring/{j}")
        member = ref.synthesize(n, kappa, js, ring_scale(j), device=device,
                                k=k)
        ans = ref.control_answer(n, kappa, js, ring_scale(j),
                                 k=k or None, device=device)
        for name, v in numbers(*member[:4 if topk else 2], *ans).items():
            worst[name] = max(worst.get(name, 0.0), v)
        del member, ans
    return {"control": worst}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda:0")
    p.add_argument("--small", action="store_true")
    args = p.parse_args(argv)
    for seed in args.seeds:
        rec = readings(args.workload, seed, args.device, args.small)
        print(json.dumps({"workload": args.workload, "seed": seed, **rec}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
