"""Continuous micro-batching scheduler for the SVD service.

A copy of ``repro/serve/scheduler.py`` (it imports neither JAX nor
torch).  One FIFO queue per bucket key;
:meth:`MicroBatchScheduler.ready` drains queues into dispatchable
batches.  "Continuous" in the LM-serving sense:
slots are refilled *between* dispatches — a batch takes up to
``batch_size`` requests off its queue, the executable runs, and the next
dispatch at that bucket picks up whatever arrived in the meantime.
Nothing waits for a "full epoch" of traffic.

Dispatch policy (anti-starvation by construction):

* A bucket whose queue holds >= ``batch_size`` requests is always
  ready — full batches never wait.
* A partial batch becomes ready once its *head* request has aged past
  ``max_wait``: a rare shape cannot be starved by a hot one, because
  its age — not its queue length — forces the flush.  Empty slots are
  padded by the caller (they keep the compiled batch shape fixed, which
  is what makes the zero-retrace contract hold).
* Ready buckets drain oldest-head-first, so ordering between buckets
  follows arrival order, and requests within one bucket resolve in
  submission order (FIFO pops).

The scheduler is deliberately free of any array library: it moves
opaque items between queues, so its policy is unit-testable with plain
objects and a fake clock.
"""

from __future__ import annotations

import collections
import time
from typing import Any, Dict, Hashable, List, Tuple


class MicroBatchScheduler:
    """Per-bucket FIFO queues drained into fixed-size micro-batches.

    ``batch_size`` is the slot count of every dispatched batch;
    ``max_wait`` (seconds) is the head-of-line age that forces a
    partial dispatch; ``clock`` is injectable for tests (defaults to
    ``time.monotonic``).  :meth:`set_max_wait` overrides the age per
    bucket key — a latency-sensitive lane (small interactive solves)
    can flush early while bulk lanes keep batching for occupancy; keys
    without an override keep the global default, so behavior is
    unchanged unless a caller opts a bucket in.
    """

    def __init__(self, batch_size: int, max_wait: float = 0.005,
                 clock=time.monotonic):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        if max_wait < 0:
            raise ValueError(f"max_wait must be >= 0, got {max_wait}")
        self.batch_size = int(batch_size)
        self.max_wait = float(max_wait)
        self._max_wait_by_key: Dict[Hashable, float] = {}
        self._clock = clock
        self._queues: Dict[Hashable, collections.deque] = {}

    def set_max_wait(self, key: Hashable, max_wait: float) -> None:
        """Override the partial-dispatch age for one bucket key
        (idempotent; ``None`` restores the global default)."""
        if max_wait is None:
            self._max_wait_by_key.pop(key, None)
            return
        if max_wait < 0:
            raise ValueError(f"max_wait must be >= 0, got {max_wait}")
        self._max_wait_by_key[key] = float(max_wait)

    def max_wait_for(self, key: Hashable) -> float:
        """The effective partial-dispatch age of a bucket key."""
        return self._max_wait_by_key.get(key, self.max_wait)

    def enqueue(self, key: Hashable, item: Any, now: float = None) -> None:
        now = self._clock() if now is None else now
        self._queues.setdefault(key, collections.deque()).append((now, item))

    def pending(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def drop(self, predicate) -> List[Any]:
        """Remove and return every queued item with ``predicate(item)``
        true, preserving FIFO order among the survivors.  The service's
        deadline reaper: expired requests leave the queue *before* they
        can occupy batch slots, and the caller fails their futures with
        a typed error."""
        dropped: List[Any] = []
        for key, q in self._queues.items():
            kept = collections.deque()
            for entry in q:
                if predicate(entry[1]):
                    dropped.append(entry[1])
                else:
                    kept.append(entry)
            self._queues[key] = kept
        return dropped

    def pending_by_key(self) -> Dict[Hashable, int]:
        return {k: len(q) for k, q in self._queues.items() if q}

    def ready(self, now: float = None,
              force: bool = False) -> List[Tuple[Hashable, List[Any]]]:
        """Drain every dispatchable batch: (key, items) pairs, oldest
        head request first.

        Full batches are always taken; partial batches only when the
        head has waited past ``max_wait`` (or ``force=True`` — the
        flush/shutdown path).  A queue longer than one batch yields
        multiple batches in one call, so a burst drains at full slot
        occupancy instead of one batch per poll.
        """
        now = self._clock() if now is None else now
        # queue-creation order breaks timestamp ties: keys need not be
        # orderable (BucketKey and retry-lane keys share one scheduler)
        heads = sorted((q[0][0], i, k) for i, (k, q)
                       in enumerate(self._queues.items()) if q)
        out: List[Tuple[Hashable, List[Any]]] = []
        for t_head, _, key in heads:
            q = self._queues[key]
            while len(q) >= self.batch_size:
                out.append((key, [q.popleft()[1]
                                  for _ in range(self.batch_size)]))
            if q and (force or now - q[0][0] >= self.max_wait_for(key)):
                out.append((key, [q.popleft()[1] for _ in range(len(q))]))
        return out
