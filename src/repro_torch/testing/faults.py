"""Deterministic fault injection for the serving stack.

The port of :mod:`repro.testing.faults` (numpy and torch's exception
classes only). A fault trace is a pure function of its seed:
:func:`fault_schedule` draws a list of :class:`FaultEvent` s (which
scheduler step they hit and what kind of fault they are) from a seeded
generator, the same events as the reference for the same arguments, and
:class:`FaultInjector` replays it through the scheduler's ``fault_hook``
— ``before_step`` raises the dispatch-layer faults, ``after_step``
applies the state-layer ones (NaN poison, clock skew). Two injectors
built from the same schedule drive identical fault sequences, so a chaos
run replays to an identical scheduler event log
(``tests/test_torch_faults.py``).

Fault kinds:

  * ``dispatch`` — an opaque runtime error from a kernel launch (the
    shape of the ``RuntimeError`` a failed CUDA launch raises).
  * ``oom`` — a device out-of-memory failure: :class:`InjectedOOM`
    subclasses ``torch.OutOfMemoryError``, so a handler written for
    torch's OOM catches it, and its message holds "out of memory", the
    text the scheduler's classifier keys on (production code never
    imports this module).
  * ``transfer`` — a host-transfer failure *after* the pass moved its
    round counter, mimicking a partially-applied step; recovery MUST
    restore from the checkpoint rather than trust in-memory state.
  * ``shard`` — a shard/device dropout. After its retries a sharded
    pass takes the single-device rung (``force_unsharded``), an
    unsharded one the host-loop rung.
  * ``nan`` — poisons one slot's fold state (a NaN mean in the slot's
    host views, which the next device-loop step uploads), exercising the
    NaN sentinel and quarantine path.
  * ``skew`` — returns a positive clock skew in seconds from
    ``after_step`` (only meaningful under ``SimClock``, where the
    scheduler logs and applies it deterministically).

The injector counts scheduler *step attempts* (every ``before_step``
call), so a retry of step k is attempt k+1 — a fault schedule can hit
the retry itself, driving the ladder."""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

__all__ = ["InjectedFault", "InjectedDispatchError", "InjectedOOM",
           "InjectedTransferError", "InjectedShardDropout",
           "FaultEvent", "fault_schedule", "FaultInjector", "KINDS",
           "DeviceOOMHook"]


class InjectedFault(RuntimeError):
    """Base class of all injected faults (a RuntimeError, like a failed
    CUDA launch, so the scheduler's production handler catches them
    without knowing they are injected)."""


class InjectedDispatchError(InjectedFault):
    """Opaque kernel-launch failure."""


class InjectedOOM(InjectedFault, torch.OutOfMemoryError):
    """Simulated device OOM: a ``torch.OutOfMemoryError`` whose message
    holds "out of memory"."""

    def __init__(self, detail: str = ""):
        super().__init__(
            f"CUDA out of memory (injected) {detail}")


class InjectedTransferError(InjectedFault):
    """Host-transfer failure after a partially-applied step."""

    def __init__(self, detail: str = ""):
        super().__init__(f"injected device-to-host transfer failure "
                         f"{detail}")


class InjectedShardDropout(InjectedFault):
    """A shard / device dropped out mid-pass."""

    def __init__(self, detail: str = ""):
        super().__init__(f"injected shard dropout: device unavailable "
                         f"{detail}")


class FaultEvent(NamedTuple):
    """One scheduled fault: fires at scheduler step-attempt ``step``
    (0-based, counted across ALL passes), with ``kind`` in
    :data:`KINDS` and a uniform ``arg`` in [0, 1) the fault uses for its
    internal choice (which slot to poison, how much skew)."""

    step: int
    kind: str
    arg: float


KINDS = ("dispatch", "oom", "transfer", "shard", "nan", "skew")


def fault_schedule(seed: int, n_steps: int, rate: float = 0.05,
                   kinds: Sequence[str] = KINDS) -> List[FaultEvent]:
    """Draw a deterministic fault trace: each step attempt in
    ``[0, n_steps)`` independently faults with probability ``rate``,
    the kind uniform over ``kinds``. Pure function of its arguments."""
    rng = np.random.default_rng(seed)
    out: List[FaultEvent] = []
    for step in range(n_steps):
        if rng.random() < rate:
            kind = kinds[int(rng.integers(len(kinds)))]
            out.append(FaultEvent(step, kind, float(rng.random())))
    return out


class FaultInjector:
    """Replay a fault schedule through the scheduler's ``fault_hook``.

    Stateless apart from the step counter and the ``fired`` record, so
    building a second injector from the same schedule replays the exact
    same fault sequence."""

    def __init__(self, schedule: Sequence[FaultEvent]):
        self.by_step = {}
        for ev in schedule:
            self.by_step.setdefault(ev.step, []).append(ev)
        self.step = 0          # next attempt index (0-based)
        self._attempt = -1     # attempt currently executing
        self.fired: List[FaultEvent] = []

    def _take(self, kinds: Sequence[str]) -> Optional[FaultEvent]:
        for ev in self.by_step.get(self._attempt, ()):
            if ev.kind in kinds and ev not in self.fired:
                self.fired.append(ev)
                return ev
        return None

    # -- scheduler hook protocol ----------------------------------------------

    def before_step(self, sched, pas, t: float) -> None:
        """Raise this attempt's dispatch-layer fault, if any. Counts
        the attempt (retries are new attempts)."""
        self._attempt = self.step
        self.step += 1
        ev = self._take(("dispatch", "oom", "transfer", "shard"))
        if ev is None:
            return
        if ev.kind == "oom":
            raise InjectedOOM(f"at step {ev.step}")
        if ev.kind == "transfer":
            # mimic a partially-applied step: the pass already moved its
            # round counter when the transfer failed, so a recovery that
            # trusts in-memory state instead of the checkpoint would
            # silently skip a round
            pas.rounds += 1
            raise InjectedTransferError(f"at step {ev.step}")
        if ev.kind == "shard":
            raise InjectedShardDropout(f"at step {ev.step}")
        raise InjectedDispatchError(
            f"injected dispatch failure at step {ev.step}")

    def after_step(self, sched, pas, t: float) -> Optional[float]:
        """Apply this attempt's state-layer fault: NaN-poison one slot's
        fold state (its host views, which the device pass loop's next
        step uploads), or return a clock skew in seconds."""
        ev = self._take(("nan", "skew"))
        if ev is None:
            return None
        if ev.kind == "nan":
            if not pas.slots:
                return None
            slot = pas.slots[int(ev.arg * 1000) % len(pas.slots)]
            mean = np.array(slot.views.state.mean, dtype=np.float64)
            mean[0] = np.nan
            slot.views.state = slot.views.state._replace(mean=mean)
            return None
        return 0.05 * ev.arg   # skew: up to 50ms forward


class DeviceOOMHook:
    """A fault hook that provokes a real ``torch.OutOfMemoryError`` (not
    :class:`InjectedOOM`): on the listed step attempts, ``before_step``
    asks the card for twice the memory it holds. Attempts are counted
    as :class:`FaultInjector` counts them. Card only: on the CPU such an
    allocation could succeed lazily, so the constructor refuses it."""

    def __init__(self, attempts: Sequence[int], device="cuda"):
        self.device = torch.device(device)
        if self.device.type != "cuda":
            raise ValueError(f"DeviceOOMHook needs a CUDA device, got "
                             f"{self.device}")
        self.attempts = frozenset(int(a) for a in attempts)
        self.step = 0
        self.fired: List[int] = []

    def before_step(self, sched, pas, t: float) -> None:
        attempt, self.step = self.step, self.step + 1
        if attempt in self.attempts:
            self.fired.append(attempt)
            total = torch.cuda.get_device_properties(self.device).total_memory
            torch.empty(2 * total, dtype=torch.uint8, device=self.device)

    def after_step(self, sched, pas, t: float) -> Optional[float]:
        return None
