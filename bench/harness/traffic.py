"""The one traffic generator: it reads a mix's parameters (a data file
under ``bench/traffic/``) and a run's ``--seed``, and yields the inputs.

Every seed gets the same set of sizes and the same amount of work; the
seed changes the draws and their order only.
"""

from __future__ import annotations

import itertools
import random

from harness.manifest import sub_seed


def ring_order(seed: int, ring: int):
    """Endless ring indices: each pass over the ring is a permutation of
    ``range(ring)`` drawn from the seed, so every member is used equally
    often whatever the seed."""
    for cycle in itertools.count():
        order = list(range(ring))
        random.Random(sub_seed(seed, f"order/{cycle}")).shuffle(order)
        yield from order


def ring_scale(j: int) -> float:
    """Member ``j``'s scale, 2**j: exact in floating point, so every
    member is the same work, and each member has its own spectrum, which
    catches an answer given to the wrong request."""
    return float(2 ** j)


def row_signs(torch, seed: int, n: int, device):
    """Endless float32 vectors of n signs (+1 or -1), drawn on ``device``
    from one generator seeded from the run's seed.  A request flips the
    rows of its ring member to the next vector, D A in place of A: exact
    in floating point, the same work and the same singular values, with
    U turned into D U.  So no two requests send the same matrix, and an
    answer kept from an earlier request is wrong for the next."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "signs"))
    while True:
        bits = torch.randint(0, 2, (n,), generator=gen, device=device,
                             dtype=torch.int32)
        yield (2 * bits - 1).to(torch.float32)
