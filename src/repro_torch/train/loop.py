"""Fault-tolerant training loop.

Port of ``repro/train/loop.py``, run eagerly:

* checkpoint/restart — resume from the newest complete checkpoint; saves
  every ``ckpt_every`` steps (async) and at the end or on SIGTERM/SIGINT
  (preemption).
* deterministic data — batch(step) is pure, so a restart needs no data
  state (see :mod:`repro_torch.data.pipeline`).
* metrics — a JSONL log with loss / grad norm / throughput.  The metrics
  are device scalars, read to the host only on a logged step.
"""

from __future__ import annotations

import dataclasses
import json
import signal
import time
from typing import Any, Callable, Optional

from repro_torch.checkpoint.manager import CheckpointManager


@dataclasses.dataclass
class TrainLoop:
    train_step: Callable
    data: Any  # has .batch_at(step)
    ckpt: Optional[CheckpointManager] = None
    ckpt_every: int = 100
    log_every: int = 10
    log_path: Optional[str] = None
    tokens_per_step: int = 0

    def __post_init__(self):
        self._stop = False

    def _install_signals(self):
        def handler(signum, frame):
            self._stop = True

        for sig in (signal.SIGINT, signal.SIGTERM):
            try:
                signal.signal(sig, handler)
            except ValueError:  # non-main thread
                pass

    def run(self, state, num_steps: int):
        """Run up to ``num_steps`` total steps (resuming from state.step)."""
        self._install_signals()
        start = int(state.step)
        log_f = open(self.log_path, "a") if self.log_path else None
        try:
            t_last = time.perf_counter()
            for step in range(start, num_steps):
                if self._stop:
                    break
                batch = self.data.batch_at(step)
                state, metrics = self.train_step(state, batch)
                if (step + 1) % self.log_every == 0 or step + 1 == num_steps:
                    metrics = {k: float(v) for k, v in metrics.items()}
                    now = time.perf_counter()
                    dt = (now - t_last) / self.log_every
                    t_last = now
                    rec = {"step": step + 1, "sec_per_step": round(dt, 4),
                           **{k: round(v, 6) for k, v in metrics.items()}}
                    if self.tokens_per_step:
                        rec["tokens_per_sec"] = round(
                            self.tokens_per_step / max(dt, 1e-9), 1)
                    if log_f:
                        log_f.write(json.dumps(rec) + "\n")
                        log_f.flush()
                    else:
                        print(rec, flush=True)
                if self.ckpt and (step + 1) % self.ckpt_every == 0:
                    self.ckpt.save(step + 1, state)
            if self.ckpt:
                self.ckpt.save(int(state.step), state, block=True)
                self.ckpt.wait()
        finally:
            if log_f:
                log_f.close()
        return state

    def resume_or_init(self, init_fn, gen):
        """Restore the latest checkpoint if present, else init fresh from
        the ``torch.Generator`` ``gen``."""
        state = init_fn(gen)
        if self.ckpt and self.ckpt.latest_step() is not None:
            state, step = self.ckpt.restore(state)
            print(f"[loop] resumed from step {step}", flush=True)
        return state
