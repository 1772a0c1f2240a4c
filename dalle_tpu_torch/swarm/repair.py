"""Round repair: a convicted round is also a corrected round
(counterpart of ``dalle_tpu/swarm/repair.py``; the port's averaged
gradients may also be tensors on the card, which are patched there:
only the correction window is touched, never the whole gradient).

The audit alone ends at DETECTION: the aggregation audit
(swarm/audit.py) replays a challenged part owner's signed transcript
and convicts it when the served bytes cannot be explained — but the
wrong part has already landed in every member's averaged gradients,
and (once the optimizer step fires) in their parameters. This module
closes the loop with the BTARD-style pairing of detection and
CORRECTION (Gorbunov et al. arXiv 2106.11257): the replay that
convicted the owner has, as a byproduct, recomputed the HONEST part
bytes bit-exactly from the transcript's sender-signed inputs, so the
correction

    correction = honest_part - served_part

is known the moment the conviction is. Each member that gathered the
wrong part repairs itself locally — no extra wire round, no
coordination: the replay is deterministic, so every honest member
derives the identical correction.

Two landing sites, one drain point:

- **Pre-step** (the conviction beat the optimizer apply): the averaged
  flat vector still holds the served bytes, so the repair ASSIGNS the
  honest bytes over them — bit-identical to an honest round, pinned by
  the soak's repair oracle. The assign is used whenever the target
  window still bit-equals the retained served bytes, which also makes
  the repair idempotent (re-assigning honest bytes over honest bytes
  is a no-op).
- **Post-step** (the LAMB step already fired — the common case for the
  asynchronous AuditWorker): the correction is ADDED into the next
  gradient vector the optimizer applies, i.e. it rides one (or more)
  steps late through the same update rule, exactly like an
  error-feedback residual. The compensation bound is one optimizer
  step of staleness: the correction passes through the preconditioner
  of a later step instead of the poisoned one. For a linear
  accumulator (the soak's state += averaged) the two sites are
  equivalent up to f32 reassociation; for LAMB the bound is documented
  in CHAOS.md ("Round repair").

Repair is strictly LOCAL and strictly bounded: only convictions whose
replay *succeeded* (the transcript is internally consistent — the
``replayed-bytes-mismatch`` verdict, the ``wrong_gather_part`` attack
shape) yield an honest reconstruction; a transcript that is itself the
lie proves the owner dishonest without revealing what the honest part
was, so those convictions stay detection-only (the round degrades
exactly as without repair). Repair OFF (``CollabConfig.repair_convicted``
False, or no plane wired) leaves every byte identical to the
unrepaired protocol — the plane is pull-only and nothing consults it.

The retention that makes late repair possible — the per-round
:class:`~dalle_tpu_torch.swarm.audit.RoundAudit` objects queued at the
AuditWorker, each holding the signed frames and gathered bytes of its
audited parts — is bounded by BYTES as well as round count
(``CollabConfig.audit_ring_bytes``): flagship-size parts under a slow
audit evict oldest-first with a counted eviction instead of
ballooning host RAM.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

logger = logging.getLogger(__name__)

#: queued-correction bound: repair is a narrow corrective channel, not
#: a buffer plane — a backlog this deep means the auditor is convicting
#: faster than the trainer steps, and the oldest corrections are the
#: stalest (least valuable) ones
MAX_ACTIONS = 64


@dataclasses.dataclass
class RepairAction:
    """One part's correction, derived from one conviction.

    ``served`` is the wrong part as this member gathered (and applied)
    it; ``honest`` is the audit replay's bit-exact reconstruction from
    the owner's signed transcript. ``lo`` is the part's offset in the
    round's FLAT gradient layout (model-global coordinates — the
    flatten order is fixed by the leaf list, so the offset stays valid
    across rounds whatever the roster does to part boundaries)."""

    prefix: str
    epoch: int
    part: int
    owner: str
    lo: int
    served: np.ndarray
    honest: np.ndarray

    @property
    def hi(self) -> int:
        return self.lo + int(self.honest.size)

    def nbytes(self) -> int:
        return int(self.served.nbytes + self.honest.nbytes)


def _flat(a):
    """A flat view of one leaf (numpy array or tensor) that writes
    through to it."""
    if isinstance(a, torch.Tensor):
        if not a.is_contiguous():
            raise ValueError("repair needs contiguous tensors")
        return a.view(-1)
    return a.reshape(-1)


def _flat_windows(arrays: Sequence, lo: int, hi: int
                  ) -> List[Tuple[int, object, int, int]]:
    """(array index, flat view, start, stop) per leaf overlapping the
    flat window [lo, hi) — the inverse of ``flatten_tensors``'s
    layout."""
    out = []
    off = 0
    for i, a in enumerate(arrays):
        n = int(np.prod(tuple(a.shape))) if len(a.shape) else 1
        alo, ahi = off, off + n
        s, e = max(lo, alo), min(hi, ahi)
        if s < e:
            out.append((i, _flat(a), s - alo, e - alo))
        off = ahi
    return out


def _window_equals(view, s: int, e: int, want: np.ndarray) -> bool:
    """Whether ``view[s:e]`` holds exactly the bytes of ``want``."""
    if isinstance(view, torch.Tensor):
        got = view[s:e]
        return torch.equal(got.view(torch.int32), torch.from_numpy(
            want).to(got.device).view(torch.int32))
    return view[s:e].tobytes() == want.tobytes()


def _patch(view, s: int, e: int, honest: np.ndarray,
           served: np.ndarray, exact: bool) -> None:
    """Assign ``honest`` over ``view[s:e]`` (exact) or add ``honest -
    served`` to it; on a tensor both run on its device, in f32, with
    the same two roundings as numpy's."""
    if isinstance(view, torch.Tensor):
        h = torch.from_numpy(honest).to(view.device)
        if exact:
            view[s:e] = h
        else:
            view[s:e] += h - torch.from_numpy(served).to(view.device)
    elif exact:
        view[s:e] = honest
    else:
        view[s:e] += honest - served


def apply_flat_correction(arrays: Sequence,
                          action: RepairAction) -> Optional[bool]:
    """Patch ``arrays`` (per-leaf, in the flatten order) in place with
    one correction. Three-way result: True — the repair was EXACT (the
    window still bit-equals the served bytes, so the honest bytes are
    assigned over them, bit-identical to an honest round); False — the
    correction ``honest - served`` was ADDED (the bounded-staleness
    compensation: the window holds some later vector); None — the
    correction was DROPPED untouched (structurally alien target), so
    callers must not count it as a repair.

    Leaves are float32 numpy arrays (writable) or contiguous float32
    tensors; a tensor's window is compared and patched on its own
    device, and only the window's bytes move there.
    """
    windows = _flat_windows(arrays, action.lo, action.hi)
    covered = sum(e - s for _i, _v, s, e in windows)
    if covered != action.honest.size:
        # a structurally alien target (model changed size mid-flight):
        # never guess — dropping the correction degrades to detection
        logger.warning(
            "repair: correction window [%d, %d) does not fit the "
            "target layout (%d of %d elements) — dropped",
            action.lo, action.hi, covered, action.honest.size)
        return None
    exact = True
    off = 0
    for _i, view, s, e in windows:
        n = e - s
        if not _window_equals(view, s, e, action.served[off:off + n]):
            exact = False
            break
        off += n
    off = 0
    for _i, view, s, e in windows:
        n = e - s
        _patch(view, s, e, action.honest[off:off + n],
               action.served[off:off + n], exact)
        off += n
    return exact


class RepairPlane:
    """Thread-safe hand-off of corrections from the auditor to the
    training thread.

    The AuditWorker (or the soak's synchronous audit) ``submit()``s
    actions as convictions land; the optimizer ``drain()``s them at its
    next application site and patches the averaged vector before the
    consuming step. ``accept_prefix`` scopes the plane to the round
    families it repairs — a single prefix, a tuple of prefixes, or
    None for everything. The auxiliary phases are repairable
    too: a ``replayed-bytes-mismatch`` conviction in a PowerSGD factor
    round queues its ``honest - served`` correction for the factor
    buffers, and one in state averaging for the averaged-state
    application — the same pre-step-exact / bounded-staleness split as
    gradient repair, landed at the phase's own drain site via the
    ``prefix=`` scoping on :meth:`apply`/:meth:`drain`/:meth:`pending`
    (phase corrections never cross-apply to another phase's buffers).
    With aux repair off, factor/state convictions stay detection +
    proof.
    """

    def __init__(self, accept_prefix=None,
                 max_actions: int = MAX_ACTIONS):
        if isinstance(accept_prefix, (list, tuple, set, frozenset)):
            accept_prefix = tuple(sorted(accept_prefix))
        self.accept_prefix = accept_prefix
        self.max_actions = max_actions
        self._lock = threading.Lock()
        self._actions: List[RepairAction] = []
        # observability counters (surfaced in the optimizer round
        # report and the swarm metrics snapshot)
        self.submitted = 0
        self.skipped_prefix = 0
        self.dropped_overflow = 0
        self.applied = 0
        self.applied_exact = 0
        self.applied_stale = 0
        self.dropped_alien = 0

    def accepts(self, prefix: str) -> bool:
        """Whether this plane takes corrections for ``prefix`` (the
        audit's submit gate keys on this)."""
        if self.accept_prefix is None:
            return True
        if isinstance(self.accept_prefix, tuple):
            return prefix in self.accept_prefix
        return prefix == self.accept_prefix

    def submit(self, action: RepairAction) -> bool:
        if not self.accepts(action.prefix):
            with self._lock:
                self.skipped_prefix += 1
            return False
        with self._lock:
            if len(self._actions) >= self.max_actions:
                dropped = self._actions.pop(0)
                self.dropped_overflow += 1
                logger.warning(
                    "repair plane backlogged: dropping epoch %d part %d "
                    "correction (oldest-first)", dropped.epoch,
                    dropped.part)
            self._actions.append(action)
            self.submitted += 1
        logger.warning(
            "repair: correction queued for part %d (epoch %d, owner "
            "%s, %d elements)", action.part, action.epoch,
            action.owner[:16], action.honest.size)
        return True

    def pending(self, prefix: Optional[str] = None) -> int:
        with self._lock:
            if prefix is None:
                return len(self._actions)
            return sum(1 for a in self._actions if a.prefix == prefix)

    def drain(self, prefix: Optional[str] = None) -> List[RepairAction]:
        """Take queued corrections. ``prefix`` scopes the drain to one
        round family (the multi-phase plane: the gradient drain
        must not swallow a factor-round correction destined for the
        factor buffers, and vice versa); None drains everything."""
        with self._lock:
            if prefix is None:
                out, self._actions = self._actions, []
                return out
            out = [a for a in self._actions if a.prefix == prefix]
            self._actions = [a for a in self._actions
                             if a.prefix != prefix]
            return out

    def apply(self, arrays: Sequence,
              prefix: Optional[str] = None) -> int:
        """Drain (scoped by ``prefix``) and apply every queued
        correction onto ``arrays``; returns the number that actually
        LANDED. Counts exact (pre-step assign) vs stale (post-step
        compensation) landings; a correction dropped for an alien
        target layout is counted separately and never inflates
        ``applied`` (the repair oracles key on it)."""
        actions = self.drain(prefix)
        n = 0
        for a in actions:
            exact = apply_flat_correction(arrays, a)
            with self._lock:
                if exact is None:
                    self.dropped_alien += 1
                    continue
                self.applied += 1
                if exact:
                    self.applied_exact += 1
                else:
                    self.applied_stale += 1
            n += 1
            logger.warning(
                "repair: applied part %d correction from epoch %d "
                "(%s)", a.part, a.epoch,
                "exact pre-step assign" if exact
                else "stale compensation")
        return n

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return {
                "submitted": self.submitted,
                "pending": len(self._actions),
                "applied": self.applied,
                "applied_exact": self.applied_exact,
                "applied_stale": self.applied_stale,
                "dropped_alien": self.dropped_alien,
                "dropped_overflow": self.dropped_overflow,
                "skipped_prefix": self.skipped_prefix,
            }
