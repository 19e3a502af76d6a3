"""Fault tolerance: supervised step loop, heartbeats, straggler mitigation
(port of ``repro.distributed.fault_tolerance``, the same code over the
port's checkpointer).

PC isolates crashes by running user code in a *worker backend* process that
the front-end re-forks on failure (paper §2). Our analogue at pod scale:

* :class:`Supervisor` — wraps the training loop; on a step failure it
  restores the last atomic checkpoint and replays (the re-fork), with a
  bounded restart budget and deterministic data-cursor recovery.
* :class:`HeartbeatMonitor` — per-worker step timestamps; a worker slower
  than ``straggler_factor`` x the median (or silent past ``timeout``) is
  flagged, and its data shard is re-assigned to the fastest worker (work
  stealing over the page-sharded loader).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.checkpoint import Checkpointer

__all__ = ["Supervisor", "SupervisorReport", "HeartbeatMonitor",
           "StragglerPlan"]


@dataclasses.dataclass
class SupervisorReport:
    steps_run: int = 0
    restarts: int = 0
    restored_from: List[int] = dataclasses.field(default_factory=list)


class Supervisor:
    """Runs ``state = step_fn(state, step)`` for `total_steps`, saving every
    `save_every` steps; any exception triggers restore-from-checkpoint and
    continue (the worker re-fork).

    Over a mesh (``specs`` and ``mesh``, every rank running its own
    supervisor in step) the saves write whole leaves and the restores take
    the rank's slices (``Checkpointer.save`` / ``restore``), so a job
    restarted on another mesh resumes from the same files; a failure must
    reach every rank at the same step (one rank alone would leave the
    others waiting in a collective). Async saves are single-process only:
    a mesh save gathers on every rank."""

    def __init__(self, checkpointer: Checkpointer, save_every: int = 10,
                 max_restarts: int = 5, async_save: bool = False,
                 specs: Any = None, mesh=None):
        if async_save and mesh is not None:
            raise ValueError("an async save over a mesh: its gathers run "
                             "on every rank in step, save synchronously")
        self.ckpt = checkpointer
        self.save_every = save_every
        self.max_restarts = max_restarts
        self.async_save = async_save
        self.placement = {"specs": specs, "mesh": mesh}

    def run(self, state: Any, step_fn: Callable[[Any, int], Any],
            total_steps: int,
            extra_fn: Optional[Callable[[], Dict]] = None,
            restore_extra: Optional[Callable[[Dict], None]] = None
            ) -> Tuple[Any, SupervisorReport]:
        rep = SupervisorReport()
        start = 0
        latest = self.ckpt.latest_step()
        if latest is not None:  # resuming an interrupted job
            state, extra = self.ckpt.restore(state, **self.placement)
            if restore_extra:
                restore_extra(extra)
            start = latest
            rep.restored_from.append(latest)
        step = start
        while step < total_steps:
            try:
                state = step_fn(state, step)
                step += 1
                rep.steps_run += 1
                if step % self.save_every == 0 or step == total_steps:
                    extra = {"step": step, **(extra_fn() if extra_fn else {})}
                    if self.async_save:
                        self.ckpt.save_async(step, state, extra)
                    else:
                        self.ckpt.save(step, state, extra, **self.placement)
            except Exception:
                rep.restarts += 1
                if rep.restarts > self.max_restarts:
                    raise
                self.ckpt.wait()
                latest = self.ckpt.latest_step()
                if latest is None:
                    raise
                state, extra = self.ckpt.restore(state, **self.placement)
                if restore_extra:
                    restore_extra(extra)
                step = latest
                rep.restored_from.append(latest)
        self.ckpt.wait()
        return state, rep


@dataclasses.dataclass
class StragglerPlan:
    stragglers: List[int]
    reassign: Dict[int, int]  # straggler worker -> takeover worker


class HeartbeatMonitor:
    def __init__(self, n_workers: int, straggler_factor: float = 2.0,
                 timeout_s: float = 60.0):
        self.n = n_workers
        self.factor = straggler_factor
        self.timeout = timeout_s
        self.last_beat: Dict[int, float] = {}
        self.durations: Dict[int, List[float]] = {i: [] for i in range(n_workers)}

    def beat(self, worker: int, step_duration: float,
             now: Optional[float] = None) -> None:
        self.last_beat[worker] = now if now is not None else time.time()
        self.durations[worker].append(step_duration)

    def median_duration(self) -> float:
        all_d = sorted(d for ds in self.durations.values() for d in ds[-5:])
        return all_d[len(all_d) // 2] if all_d else 0.0

    def check(self, now: Optional[float] = None) -> StragglerPlan:
        now = now if now is not None else time.time()
        med = self.median_duration()
        stragglers, healthy = [], []
        for w in range(self.n):
            silent = now - self.last_beat.get(w, now) > self.timeout
            recent = self.durations[w][-3:]
            slow = (med > 0 and recent
                    and sum(recent) / len(recent) > self.factor * med)
            (stragglers if (silent or slow) else healthy).append(w)
        healthy.sort(key=lambda w: (sum(self.durations[w][-3:])
                                    / max(1, len(self.durations[w][-3:]))))
        reassign = {}
        for i, s in enumerate(stragglers):
            if healthy:
                reassign[s] = healthy[i % len(healthy)]
        return StragglerPlan(stragglers, reassign)
