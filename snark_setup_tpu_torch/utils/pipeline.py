"""Bounded dispatch pipelines: the device work of a batch is queued, and its
host half (a check that reads device flags, a pairing, byte packing) runs
later, once later batches' device work is queued behind it.

One `Pipeline` holds the pending host halves ("finishes") of one loop, first
in, first out. `push(finish)` queues one, then runs the oldest until at most
`depth - 1` are pending; leaving the `with` block runs the rest. If an
exception leaves the block, the pending finishes are dropped, not run: a
failed verification writes nothing more. These are the reference's `flush`
/ `vflush` loops (snark_setup_tpu/phase1/protocol.py: computation at depth
4, verification at depth 3, aggregate_verification at `limit=2`;
phase2/chunked.py: _mul_query at `limit=3`), so a check of batch i raises
where the reference raises it: after the reads of the batches pushed
behind it.

`recording()` collects what each pipeline closed inside it did (its name,
depth, pushes, the most finishes pending at once and the host seconds spent
in finishes), for `chip_smoke.py` and the tests.
"""

from __future__ import annotations

import collections
import contextlib
import time

_recorders: list[list] = []


class Pipeline:
    def __init__(self, depth: int, name: str = ""):
        if depth < 1:
            raise ValueError("a pipeline holds at least one batch")
        self.depth, self.name = depth, name
        self._pending: collections.deque = collections.deque()
        self.pushes = 0
        self.high_water = 0
        self.finish_seconds = 0.0

    def __enter__(self) -> "Pipeline":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.flush()
        else:
            self._pending.clear()
        for runs in _recorders:
            runs.append(self.stats(completed=exc_type is None))

    def push(self, finish) -> None:
        """Queue `finish` (no arguments), then run the oldest finishes until
        at most depth - 1 are pending."""
        self._pending.append(finish)
        self.pushes += 1
        self.high_water = max(self.high_water, len(self._pending))
        self.flush(self.depth - 1)

    def flush(self, limit: int = 0) -> None:
        """Run the oldest pending finishes until at most `limit` are left."""
        while len(self._pending) > limit:
            finish = self._pending.popleft()
            t0 = time.perf_counter()
            try:
                finish()
            finally:
                self.finish_seconds += time.perf_counter() - t0

    def stats(self, completed: bool = True) -> dict:
        return {"name": self.name, "depth": self.depth, "pushes": self.pushes,
                "high_water": self.high_water, "finish_seconds": self.finish_seconds,
                "completed": completed}


@contextlib.contextmanager
def recording():
    """Yield a list that receives `Pipeline.stats()` of every pipeline
    closed inside the block, in the order they close."""
    runs: list = []
    _recorders.append(runs)
    try:
        yield runs
    finally:
        _recorders.remove(runs)
