"""Batched LM serving engine: prefill + the decode loop.

Port of ``repro/serve/engine.py``.  ``decode_step`` (one token for the
whole batch against the KV/state caches) is the unit; the engine adds
greedy / temperature sampling and multi-token generation.  The
reference's ``lax.scan`` over the compiled step is a Python loop here:
every token stays on the device, nothing is read back inside the loop,
and the caller reads the (b, steps) tokens once at the end.  The engine
owns the caches its prefill makes, and each step writes its ring slot
and states into them in place (as XLA updates the scan's carry), so a
step copies no cache.

Temperature sampling is the Gumbel-max form of
``jax.random.categorical`` drawn from an explicit ``torch.Generator``:
it is reproducible from that generator, but cannot match JAX's PRNG draw
for draw.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Optional

import torch

from repro_torch.models import model as M

F32 = torch.float32


def make_prefill_fn(cfg, max_len: int):
    def prefill_fn(params, batch):
        return M.prefill(params, batch, cfg, max_len)

    return prefill_fn


def make_decode_fn(cfg):
    def decode_fn(params, tokens, caches):
        return M.decode_step(params, tokens, caches, cfg)

    return decode_fn


def sample(logits, generator: Optional[torch.Generator] = None,
           temperature: float = 0.0, vocab_size: int = 0):
    """Next tokens (b,) int32 from logits (b, vocab_padded): argmax at
    temperature 0 (the first maximum, as ``jnp.argmax``), else a draw
    from softmax(logits / temperature) by Gumbel-max on ``generator``.
    The padded vocab tail (ids >= vocab_size) is never sampled."""
    if vocab_size:
        neg = torch.full_like(logits[..., vocab_size:], -1e30)
        logits = torch.cat([logits[..., :vocab_size], neg], dim=-1)
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    u = torch.rand(logits.shape, generator=generator, dtype=F32,
                   device=logits.device)
    gumbel = -torch.log(-torch.log(torch.clamp(
        u, min=torch.finfo(F32).tiny)))
    return torch.argmax(logits.to(F32) / temperature + gumbel,
                        dim=-1).to(torch.int32)


@dataclasses.dataclass
class ServeEngine:
    cfg: Any
    params: Any
    max_len: int
    temperature: float = 0.0

    def __post_init__(self):
        self._prefill = make_prefill_fn(self.cfg, self.max_len)
        # the engine owns its caches: each step writes into them
        self._decode = functools.partial(M.decode_step_, cfg=self.cfg)

    def generate(self, batch, steps: int,
                 generator: Optional[torch.Generator] = None):
        """batch: {"tokens": (b, s) [, "embeds": ...]} -> ((b, steps)
        int32 tokens, caches), both on the params' device.  Temperature
        sampling draws from ``generator`` (seed 0 on that device when
        None)."""
        if generator is None and self.temperature > 0.0:
            generator = torch.Generator(
                device=batch["tokens"].device).manual_seed(0)
        logits, caches = self._prefill(self.params, batch)
        tokens = sample(logits, generator, self.temperature,
                        self.cfg.vocab_size)[:, None]
        out = [tokens]
        for _ in range(steps - 1):
            logits, caches = self._decode(self.params, tokens, caches)
            tokens = sample(logits, generator, self.temperature,
                            self.cfg.vocab_size)[:, None]
            out.append(tokens)
        return torch.cat(out, dim=1), caches
