"""Fault tolerance: restart supervision and straggler detection
(counterpart of ``repro/checkpoint/fault_tolerance.py``, same semantics).

- `RestartableLoop` checkpoints every `ckpt_every` steps and, on any
  exception (a lost device shows as a RuntimeError), restores from the
  newest *verified* checkpoint and replays the data pipeline to the
  restored step (the pipeline is deterministic-by-step, see
  repro_torch/data); a newer verified checkpoint than the start step is
  resumed from; after `max_restarts` the exception propagates.  Unlike
  the reference, a restart waits for an async save in flight before it
  looks for the newest checkpoint, so that the save is not missed.
- `StragglerMonitor` tracks per-step wall times; steps slower than
  `threshold` x the running median are recorded as events.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable, Optional

from repro_torch.checkpoint.checkpoint import CheckpointManager

log = logging.getLogger("repro_torch.ft")


@dataclasses.dataclass
class StragglerMonitor:
    threshold: float = 2.0
    window: int = 32

    def __post_init__(self):
        self.times: list[float] = []
        self.events: list[dict] = []

    def record(self, step: int, dt: float) -> bool:
        """Returns True if this step was a straggler."""
        self.times.append(dt)
        self.times = self.times[-self.window:]
        med = sorted(self.times)[len(self.times) // 2]
        if len(self.times) >= 8 and dt > self.threshold * med:
            self.events.append({"step": step, "dt": dt, "median": med})
            log.warning("straggler: step %d took %.3fs (median %.3fs)",
                        step, dt, med)
            return True
        return False


@dataclasses.dataclass
class RestartableLoop:
    """Supervised training loop with checkpoint/restart semantics."""

    ckpt: CheckpointManager
    ckpt_every: int = 100
    max_restarts: int = 10

    def run(self, state: Any, step_fn: Callable[[Any, int], Any],
            n_steps: int, *, start_step: int = 0,
            on_restore: Optional[Callable[[Any, int], Any]] = None):
        """state -> step_fn(state, step) -> state, for n_steps.

        On failure: restore latest verified checkpoint and continue.
        Returns (state, diagnostics)."""
        monitor = StragglerMonitor()
        restarts = 0
        step = start_step
        latest = self.ckpt.latest_step()
        if latest is not None and latest > step:
            state = self.ckpt.restore(latest, state)
            step = latest
            log.info("resumed from checkpoint step %d", step)
        while step < n_steps:
            try:
                t0 = time.perf_counter()
                state = step_fn(state, step)
                monitor.record(step, time.perf_counter() - t0)
                step += 1
                if step % self.ckpt_every == 0:
                    self.ckpt.save(step, state)
            except KeyboardInterrupt:
                raise
            except Exception as e:  # device loss / preemption / NaN guard
                restarts += 1
                log.error("step %d failed (%s); restart %d/%d", step, e,
                          restarts, self.max_restarts)
                if restarts > self.max_restarts:
                    raise
                # wait for a save in flight first (the reference looks for
                # the newest step before it waits, and can miss that save)
                self.ckpt.wait()
                latest = self.ckpt.latest_step()
                if latest is None:
                    raise
                state = self.ckpt.restore(latest, state)
                step = latest
                if on_restore is not None:
                    state = on_restore(state, step)
        self.ckpt.wait()
        return state, {"restarts": restarts,
                       "straggler_events": monitor.events}
