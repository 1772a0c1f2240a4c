"""The collaborative optimizer: swarm-synchronous training facade
(counterpart of ``dalle_tpu/swarm/optimizer.py``).

Capability parity with ``hivemind.Optimizer`` as configured by the
reference (task.py:122-135): peers accumulate gradients locally until the
swarm collectively reaches ``target_batch_size``; then they form a group
(matchmaking), average gradients with a compressed butterfly all-reduce,
and every peer applies an identical optimizer update — so the swarm
behaves like one giant synchronous data-parallel trainer with elastic
membership. Surfaces: ``.step()``, ``.local_epoch``, ``.tracker``,
``.load_state_from_peers()``, ``on_after_global_step`` /
``on_load_state_from_peers`` callbacks, ``finalize()``,
``drop_pending_round()`` and ``robustness_snapshot()``.

The trust plane runs at the JAX package's defaults: verified aggregation
(``swarm/audit.py``: each round's challenged owners post signed
transcripts, and an ``AuditWorker`` replays the parts this peer gathered),
round repair (``swarm/repair.py``: a conviction's correction lands in the
next applied gradients, or the factor/state buffers of its own phase),
proof-carrying strike receipts judged by a ``ProofVerifier`` and the
evidence-by-reference plane. ``grad_compression="power_sgd"`` runs the
rank-r factor rounds of ``swarm/powersgd.py`` (P, then Q and the raw
tail, each on half the round budget, fp16 on the wire, audited and
repaired under ``{run}_grads_p`` / ``_q``).

The port's seams:

- Gradients arrive as a dict of f32 tensors keyed by the port's parameter
  names (``training/steps.grad_step``) and are accumulated on their device
  (``acc + g * batch_size``). They cross the wire in the JAX package's leaf
  order (:func:`~dalle_tpu_torch.params.jax_leaf_names`), and state
  crosses it in the order of :func:`~dalle_tpu_torch.params
  .jax_state_leaves`, so a torch peer and a JAX peer average the same
  coordinates. Under ``wire_codec_backend="device"`` the round hands
  device tensors to the codec (``swarm/device_codec.py``: the divide, the
  flatten and the ``wire_quantize_u8``/``u4`` kernels run on the GPU).
- The apply (``apply_step``) and the accumulator update tensors in place,
  where JAX returns new arrays. So every reader on another thread takes a
  copy under :attr:`state_lock`, which the training thread holds while it
  changes the state: the state server's snapshot clones the state on the
  device and pulls the clone to the host after the lock is released; an
  overlapped round is handed the accumulator, and the training thread
  starts a new one rather than writing it. All device work of the peer's
  threads runs on the device's default stream, so a clone is ordered after
  the apply it follows and before the next one.

With an ``authorizer`` (``swarm/auth.py``), every matchmaking round
(gradients, PowerSGD factors, state) announces this peer's access token
and admits only peers whose token the experiment authority signed for
their identity. A fault-injection DHT (``swarm/chaos.py``) hears each
epoch advance (``ChaosDHT.note_epoch``: its crash-at-epoch). Multi-process
peers are refused by
:class:`~dalle_tpu_torch.parallel.multihost.SliceRole`, so every peer is
one process and repair always runs.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from dalle_tpu_torch.config import CollabConfig
from dalle_tpu_torch.params import (jax_leaf_names, load_state_leaves,
                                    state_leaf_tensors)
from dalle_tpu_torch.swarm import compression
from dalle_tpu_torch.swarm.allreduce import run_allreduce
from dalle_tpu_torch.swarm.dht import DHT
from dalle_tpu_torch.swarm.matchmaking import make_group
from dalle_tpu_torch.swarm.progress import ProgressTracker
from dalle_tpu_torch.swarm.state_transfer import (StateServer,
                                                  load_state_from_peers)

logger = logging.getLogger(__name__)

_CODECS = {"none": compression.NONE, "float16": compression.FLOAT16,
           "uniform8bit": compression.UNIFORM8BIT, "size_adaptive": None}

Grads = Dict[str, torch.Tensor]


class _PendingRound:
    """An overlapped swarm round in flight on a background thread.

    Holds the gradient accumulator handed off at launch (``leaves``, device
    tensors in the wire order that the training thread no longer writes)
    and receives the wire outcome (``result`` = averaged host arrays, or
    None for an ALONE epoch whose device grads flow straight to the
    apply). The worker thread only touches the wire and its copies; all
    train-state mutation happens at reconcile time on the training thread.
    """

    def __init__(self, epoch: int, leaves: List[torch.Tensor],
                 weight: float, weight_int: int):
        self.epoch = epoch
        self.leaves = leaves
        self.weight = weight
        self.weight_int = weight_int          # frozen progress report value
        self.result: Optional[List[np.ndarray]] = None
        self.report: Optional[dict] = None      # run_allreduce's report
        self.error: Optional[BaseException] = None
        self.group_size = 1
        self.timings: dict = {}
        self.overlapped_steps = 0             # grad steps run during round
        self.hidden_s = 0.0                   # round wall hidden from chip
        self.done = threading.Event()
        self.thread: Optional[threading.Thread] = None
        # hop-granular progress (pipeline_hops): run_allreduce's progress
        # hook bumps these from codec/drain threads while the training
        # thread polls hop_progress() between grad steps
        self._hop_lock = threading.Lock()
        self.hops = {"scatter": 0, "reduce": 0, "gather": 0}

    def note_hop(self, leg: str, part: int) -> None:
        """run_allreduce ``progress`` sink (thread-safe)."""
        with self._hop_lock:
            if leg in self.hops:
                self.hops[leg] += 1

    def hop_progress(self) -> dict:
        with self._hop_lock:
            return dict(self.hops)


class CollaborativeOptimizer:
    """Owns the train state and drives swarm-synchronous updates.

    Args:
      dht: this peer's swarm node.
      cfg: swarm-wide semantics (target batch, timeouts, compression).
      state: the initial ``training.steps.TrainState`` (model + optimizer
        state + step), on the device the peer trains on.
      apply_step: ``(state, grads) -> state``, one optimizer update with a
        dict of averaged f32 gradients (``training.steps.apply_step`` with
        the optimizer bound).
      client_mode: outbound-only peer — contributes gradients but owns no
        all-reduce part (reference arguments.py:89-92).
      serve_state: run a StateServer thread so joiners can bootstrap from
        this peer (reference callback.py:41 semantics).
    """

    def __init__(self, dht: Optional[DHT], cfg: CollabConfig, state: Any,
                 apply_step: Callable[[Any, Grads], Any],
                 client_mode: bool = False,
                 serve_state: bool = True,
                 matchmaking_min_group: int = 2,
                 authorizer=None,
                 role=None):
        from dalle_tpu_torch.parallel.multihost import SliceRole
        self.role = role or SliceRole()
        if dht is None:
            raise ValueError("a trainer peer needs a DHT")
        self.dht = dht
        self.cfg = cfg
        self.state = state
        self.apply_step = apply_step
        self.client_mode = client_mode
        self.matchmaking_min_group = matchmaking_min_group
        # Optional access-token authorizer (swarm/auth.py): gates group
        # membership the way the reference's HF authorizer gates the swarm
        # (huggingface_auth.py:46-193, wired at task.py:95-99).
        self.authorizer = authorizer
        # held by the training thread while it changes the state, and by
        # readers on other threads while they take their device copy
        self.state_lock = threading.RLock()
        self._names = jax_leaf_names(state.model.cfg)
        self._device = next(state.model.parameters()).device
        # flight recorder (obs/trace.py): round spans under the protocol
        # round id {run_id}:grads:{epoch}; None records nothing
        self.tracer = None
        if cfg.trace_file:
            from dalle_tpu_torch.obs.trace import Tracer
            self.tracer = Tracer(peer=dht.peer_id[:12],
                                 sink_path=cfg.trace_file,
                                 ring_bytes=cfg.trace_ring_kb * 1024)
        self.local_epoch = 0
        self.local_samples = 0
        # Peer-health ledger (swarm/health.py): allreduce bans feed
        # strikes; matchmaking and progress aggregation down-rank repeat
        # offenders until the strikes decay. Content screening and the
        # frame-weight clamp ride every allreduce call; the gossip worker
        # publishes/folds signed strike receipts until shutdown().
        from dalle_tpu_torch.swarm.health import (PeerHealthLedger,
                                                  StrikeGossip)
        self.ledger = PeerHealthLedger()
        self.tracker = ProgressTracker(
            dht, cfg.run_id, cfg.target_batch_size,
            client_mode=client_mode, ledger=self.ledger,
            max_epoch_lead=cfg.progress_max_epoch_lead)
        if cfg.screen_gradients:
            from dalle_tpu_torch.swarm.screening import (GradientScreen,
                                                         ScreenPolicy)
            self._screen = GradientScreen(ScreenPolicy(
                min_senders=cfg.screen_min_senders,
                max_drop_frac=cfg.screen_max_drop_frac,
                norm_tolerance=cfg.screen_norm_tolerance,
                cosine_floor=cfg.screen_cosine_floor,
                abs_norm_ceiling=cfg.screen_abs_norm_ceiling))
        else:
            self._screen = None
        mpw = cfg.max_peer_weight
        if mpw is None:
            mpw = float(cfg.target_batch_size)
        self._max_peer_weight = mpw if mpw > 0 else None
        # The round config below is set before the first worker thread
        # of this peer starts. Wire-codec execution backend
        # (swarm/device_codec.py): "device" quantizes on the GPU and keeps
        # gradients there until the codec consumes them; the wire bytes
        # are identical either way.
        from dalle_tpu_torch.swarm.device_codec import resolve_backend
        self._codec_backend = resolve_backend(cfg.wire_codec_backend)
        self._device_grad_handoff = (
            self._codec_backend == compression.DEVICE_BACKEND)
        self._powersgd = None
        if cfg.grad_compression == "power_sgd":
            # rank-r factor exchange; the factors ride the wire as fp16
            from dalle_tpu_torch.swarm.powersgd import PowerSGDCompressor
            self._powersgd = PowerSGDCompressor(
                cfg.powersgd_rank,
                host_orthogonalize=cfg.powersgd_host_orthogonalize,
                keep_factors_on_device=self._device_grad_handoff,
                device=self._device)
            self._grad_codec = compression.FLOAT16
        else:
            self._grad_codec = _CODECS[cfg.grad_compression]
        self._state_codec = _CODECS[cfg.state_compression]
        # In-collective quantization: wire_bits_reduce/_gather pin the
        # butterfly legs' codecs for the run (receivers reject codec
        # flapping); ef_residuals arms both error-feedback legs. Grad
        # rounds only: state averaging keeps its own codec.
        wb_r, wb_g = cfg.wire_bits_reduce, cfg.wire_bits_gather
        reduce_codec = compression.codec_for_bits(wb_r)
        gather_codec = compression.codec_for_bits(wb_g)
        if (wb_r is not None or wb_g is not None or cfg.ef_residuals) \
                and self._powersgd is not None:
            raise ValueError(
                "wire_bits_*/ef_residuals pin the uniform wire codec; "
                "power_sgd exchanges low-rank factors — choose one "
                "compression family")
        if cfg.ef_residuals and (wb_r is None or wb_g is None):
            raise ValueError(
                "ef_residuals carries quantization error between rounds, "
                "which is only meaningful against a STABLE codec: pin "
                "both wire_bits_reduce and wire_bits_gather (8 or 4)")
        if reduce_codec is not None:
            self._grad_codec = reduce_codec
        self._gather_codec = gather_codec
        self._pin_codec = wb_r is not None or wb_g is not None
        # Per-part pipelined butterfly: moves wall-clock only, the bytes
        # are those of the sequential protocol. Grad rounds only.
        self._pipeline_hops = bool(cfg.pipeline_hops)
        self._pipeline_depth = int(cfg.pipeline_depth)
        if cfg.ef_residuals:
            from dalle_tpu_torch.swarm.error_feedback import ErrorFeedback
            self._ef_scatter = ErrorFeedback()
            self._ef_gather = ErrorFeedback()
        else:
            self._ef_scatter = None
            self._ef_gather = None
        self._gossip = None
        if cfg.gossip_strikes:
            self._gossip = StrikeGossip(dht, self.ledger, cfg.run_id,
                                        period=cfg.strike_gossip_period)
            self._gossip.start()
        # Verified aggregation: the worker drains completed rounds'
        # RoundAudit retention off the training thread (fetch, replay,
        # bit-compare, strike); its ring is byte-bounded. Repair queues a
        # conviction's honest - served correction for the phase it
        # belongs to. shutdown() stops the worker before the DHT goes.
        # audit plane wiring: created here before the round worker
        # exists; shutdown() clears them only AFTER auditor.stop()
        # joins (the dht ordering contract) — the in-between reads
        # from the worker see either None or a live worker
        # graftlint: handoff=init-then-joined-teardown
        self._auditor = None
        # graftlint: handoff=init-then-joined-teardown
        self._audit_policy = None
        self._repair = None
        self._evidence = None
        if cfg.audit_gather:
            from dalle_tpu_torch.swarm.audit import (AuditPolicy, AuditWorker,
                                                     EvidencePlane)
            self._audit_policy = AuditPolicy(frac=cfg.audit_frac,
                                             ttl=cfg.audit_ttl)
            if cfg.repair_convicted:
                from dalle_tpu_torch.swarm.repair import RepairPlane
                prefixes = [f"{cfg.run_id}_grads"]
                if cfg.repair_aux_phases:
                    # factor and state corrections drain at their own
                    # phase's application site, never into gradients
                    prefixes += [f"{cfg.run_id}_grads_p",
                                 f"{cfg.run_id}_grads_q",
                                 f"{cfg.run_id}_state"]
                self._repair = RepairPlane(accept_prefix=tuple(prefixes))
            if cfg.proof_by_reference and self._gossip is not None:
                # evidence past PROOF_MAX_BYTES rides the receipt as a
                # digest and mailbox reference: this plane serves ours
                # and fetches theirs (budgeted, hash-checked)
                self._evidence = EvidencePlane(
                    dht, cfg.run_id, max_bytes=cfg.proof_fetch_max_bytes,
                    budget_s=cfg.proof_fetch_budget_s,
                    retries=cfg.proof_fetch_retries, tracer=self.tracer)
                self._gossip.evidence_store = self._evidence
            self._auditor = AuditWorker(
                dht, self.ledger, repair=self._repair,
                max_bytes=cfg.audit_ring_bytes,
                # with the by-reference plane, evidence has no inline cap
                evidence_limit=0 if self._evidence is not None else None)
            self._auditor.start()
        self.on_after_global_step: List[Callable[[], None]] = []
        self.on_load_state_from_peers: List[Callable[[], None]] = []
        # Proof-carrying receipts: a gossiped owner-audit-fail receipt
        # with evidence is replayed under THIS peer's round config
        # (codec, pin, screen, clamp); a verified proof convicts alone,
        # an unverifiable one is dropped without ledger effect.
        if self._gossip is not None and self._audit_policy is not None:
            from dalle_tpu_torch.swarm.allreduce import CHUNK_ELEMS
            from dalle_tpu_torch.swarm.audit import ProofVerifier
            self._gossip.verifier = ProofVerifier(
                cfg.run_id, frac=self._audit_policy.frac,
                chunk_elems=CHUNK_ELEMS, codec=self._grad_codec,
                adaptive_threshold=cfg.size_adaptive_threshold,
                screen=self._screen,
                max_peer_weight=self._max_peer_weight,
                gather_codec=self._gather_codec,
                pinned=self._grad_codec if self._pin_codec else None,
                phase_overrides={
                    # the aux phases run their own codec config
                    "powersgd": {"gather_codec": None, "pinned": None},
                    "state": {"codec": self._state_codec,
                              "gather_codec": None, "pinned": None},
                },
                fetcher=self._evidence)
        self._grad_acc: Optional[Grads] = None
        self._pending: Optional[_PendingRound] = None
        self._next_resync = 0.0
        self.last_timings: dict = {}
        # the last applied round's run_allreduce report (None for an
        # ALONE epoch): per-phase walls, per-hop rows with wire bytes
        self.last_wire_report: Optional[dict] = None
        self._apply_timings: dict = {}
        self._server: Optional[StateServer] = None
        if serve_state and not client_mode:
            self._server = StateServer(
                dht, cfg.run_id, self._state_snapshot,
                codec=self._state_codec,
                adaptive_threshold=cfg.size_adaptive_threshold,
                epoch_fn=lambda: self.local_epoch,
                stream_timeout=cfg.averaging_timeout,
                tracer=self.tracer).start()
        self.tracker.report_local_progress(0, 0, force=True)

    # -- state (de)construction -----------------------------------------

    def _state_snapshot(self):
        """StateServer provider (runs on a server thread): ``(epoch,
        arrays)``, the state leaves in the JAX order, copied on the device
        under the state lock (never a half-applied state) and pulled to
        the host after it is released."""
        with self.state_lock:
            leaves = state_leaf_tensors(self.state.model,
                                        self.state.opt_state)
            epoch, copies = self.local_epoch, [t.clone() for t in leaves]
        return epoch, [_host(t) for t in copies]

    def _replace_state_leaves(self, arrays) -> None:
        with self.state_lock:
            self.state.opt_state = load_state_leaves(
                self.state.model, self.state.opt_state, arrays)

    # -- the hot path ----------------------------------------------------

    _CONTINUE, _GLOBAL_STEP, _RESYNC = 0, 1, 2

    def _accumulate(self, grads: Grads, scale: float) -> None:
        if self._grad_acc is None:
            self._grad_acc = {n: torch.zeros_like(g, dtype=torch.float32)
                              for n, g in grads.items()}
        s = float(scale)
        for n, g in grads.items():
            # a multiply, then an add: two roundings, as the JAX tree-add
            self._grad_acc[n].add_(g.to(torch.float32) * s)

    def step(self, grads: Grads, batch_size: int) -> bool:
        """Record one local accumulation step; run a global step when the
        swarm is ready. Returns True iff a global step (the optimizer
        apply) happened during this call.

        With ``cfg.delay_optimizer_step`` (the reference's default,
        task.py:129-131) the swarm round — matchmaking + all-reduce — runs
        on a background thread while step() keeps accumulating gradients
        for the NEXT epoch into a fresh buffer. The epoch counter and the
        tracker's published progress stay frozen at the launch values
        until the round's result is applied (reconciled) at a later
        step() boundary, so to every other peer the DHT looks identical to
        a synchronous round in progress. Samples accumulated during the
        round were computed against the pre-apply params and count toward
        the next epoch: the one-step staleness delay_optimizer_step trades
        for a device that never waits on the wire.
        """
        did_global = False
        if self._pending is not None and self._pending.done.is_set():
            self._finish_pending()
            did_global = True

        if self.tracer is not None and self._pending is not None:
            t_acc = time.monotonic()
            self._accumulate(grads, batch_size)
            _sync(self._device)
            self.tracer.add(
                "swarm", "accumulate",
                self._round_trace(self._pending.epoch), t_acc,
                time.monotonic() - t_acc, samples=int(batch_size))
        else:
            self._accumulate(grads, batch_size)
        self.local_samples += int(batch_size)
        if self._pending is not None:
            # round in flight: report the FROZEN pre-round progress (pure
            # liveness); decisions wait for the reconcile
            self._pending.overlapped_steps += 1
            self.tracker.report_local_progress(
                self.local_epoch, self._pending.weight_int)
            return did_global
        # after a reconcile the tracker just force-published the epoch
        # reset (samples=0): an unforced report here would be throttled
        # and this call's ready check would miss
        self.tracker.report_local_progress(
            self.local_epoch, self.local_samples, force=did_global)

        decision = self._CONTINUE
        min_epoch = 0
        progress = self.tracker.global_progress()
        if progress.epoch > self.local_epoch:
            # keep accumulating between throttled attempts
            if time.monotonic() >= self._next_resync:
                decision = self._RESYNC
                min_epoch = progress.epoch
                self._next_resync = time.monotonic() + 1.0
        elif progress.ready_to_update:
            decision = self._GLOBAL_STEP

        if decision == self._RESYNC:
            logger.info("behind the swarm (local %d < global %d): "
                        "resyncing", self.local_epoch, min_epoch)
            self.load_state_from_peers(min_epoch=min_epoch)
            return did_global
        if decision == self._GLOBAL_STEP:
            if self.cfg.delay_optimizer_step:
                self._launch_round()
                return did_global  # the apply lands at a later reconcile
            self._run_global_step()
            return True
        return did_global

    # -- overlapped rounds (delay_optimizer_step) -------------------------

    def _new_round_audit(self, epoch: int, phase_suffix: str = "grads"):
        """A fresh per-round audit container, or None when auditing is
        off. ``phase_suffix`` names the averaging phase: the gradient
        rounds ("grads"), the PowerSGD factor rounds ("grads_p" /
        "grads_q") and state averaging ("state"); the last three are
        audited only with ``cfg.audit_aux_phases``."""
        if self._auditor is None:
            return None
        if phase_suffix != "grads" and not self.cfg.audit_aux_phases:
            return None
        from dalle_tpu_torch.swarm.audit import RoundAudit
        return RoundAudit(f"{self.cfg.run_id}_{phase_suffix}", epoch,
                          self._audit_policy)

    def _submit_audit(self, ra) -> None:
        if ra is not None and self._auditor is not None:
            self._auditor.submit(ra)

    def _repaired(self, arrays, prefix: str):
        """Round repair at a phase's application site: ``arrays`` with the
        corrections queued for ``prefix`` applied, or ``arrays`` itself
        when none are. A correction whose round is this application's
        still finds the served bytes and is assigned exactly; one that
        missed its round is added as a bounded-staleness compensation.
        Host arrays are patched in a copy; tensors in place on their
        device, in the correction's window only."""
        if (arrays is None or self._repair is None
                or not self._repair.accepts(prefix)
                or not self._repair.pending(prefix)):
            return arrays
        arrays = [_writable(a) for a in arrays]
        self._repair.apply(arrays, prefix=prefix)
        return arrays

    def _round_trace(self, epoch: int) -> str:
        """The PROTOCOL round id (shared by every member of the round)."""
        return f"{self.cfg.run_id}:grads:{epoch}"

    def _trace_allreduce(self, trace: str, t_start: float, t_end: float,
                         rep: Optional[dict], group_size: int) -> None:
        """A completed exchange's measured walls as spans: the allreduce
        envelope plus the wire report's per-protocol-phase walls."""
        tr = self.tracer
        if tr is None:
            return
        attrs = {"group": group_size}
        if rep is not None and "complete" in rep:
            attrs["complete"] = bool(rep["complete"])
        tr.add("swarm", "allreduce", trace, t_start, t_end - t_start,
               **attrs)
        t = t_start
        for name, dur in ((rep or {}).get("phases") or {}).items():
            if not isinstance(dur, (int, float)):
                continue
            phase = "ar_" + (name[:-2] if name.endswith("_s") else name)
            tr.add("swarm", phase, trace, t, dur)
            t += dur

    def _wire_leaves(self, acc: Grads) -> List[torch.Tensor]:
        return [acc[n] for n in self._names]

    def _launch_round(self) -> None:
        """Hand the gradient accumulator to a background wire thread and
        start a fresh buffer; the epoch advances when the round's result
        is applied (``_finish_pending``)."""
        pending = _PendingRound(
            epoch=self.local_epoch,
            leaves=self._wire_leaves(self._grad_acc),
            weight=float(max(self.local_samples, 1)),
            weight_int=self.local_samples)
        self._grad_acc = None
        self.local_samples = 0
        pending.thread = threading.Thread(
            target=self._round_worker, args=(pending,),
            name="swarm-round", daemon=True)
        self._pending = pending
        pending.thread.start()

    def _exchange(self, epoch: int, leaves: List[torch.Tensor],
                  weight: float, group, budget: float,
                  progress=None):
        """``(averaged, pull_s, report)``: the averaged gradients of one
        round (host arrays, wire order), the seconds spent handing the
        gradients to the codec, and the wire report (per-phase walls and
        per-hop rows with their bytes)."""
        if self._powersgd is not None:
            return self._exchange_powersgd(epoch, leaves, weight, group,
                                           budget)
        t_pull = time.monotonic()
        if self._device_grad_handoff:
            # device tensors to the codec: the divide, flatten and
            # quantize all run on the GPU; the round's one bulk host copy
            # lands in allreduce's flatten phase
            grads_local = [g / weight for g in leaves]
        else:
            grads_local = [_host(g) / weight for g in leaves]
        pull_s = time.monotonic() - t_pull
        rep = {}
        ra = self._new_round_audit(epoch)
        t_ar = time.monotonic()
        averaged = run_allreduce(
            self.dht, group, f"{self.cfg.run_id}_grads", epoch,
            grads_local, weight=weight, allreduce_timeout=budget,
            codec=self._grad_codec,
            adaptive_threshold=self.cfg.size_adaptive_threshold,
            codec_backend=self._codec_backend, ledger=self.ledger,
            screen=self._screen, max_peer_weight=self._max_peer_weight,
            audit=ra, gather_codec=self._gather_codec,
            ef_scatter=self._ef_scatter, ef_gather=self._ef_gather,
            pin_codec=self._pin_codec, report=rep,
            pipeline_hops=self._pipeline_hops,
            pipeline_depth=self._pipeline_depth, tracer=self.tracer,
            trace=self._round_trace(epoch), progress=progress)
        self._submit_audit(ra)
        self._trace_allreduce(self._round_trace(epoch), t_ar,
                              time.monotonic(), rep, group.size)
        return averaged, pull_s, rep

    def _exchange_powersgd(self, epoch: int, leaves: List[torch.Tensor],
                           weight: float, group, budget: float):
        """The PowerSGD round: the factor rounds of
        :func:`~dalle_tpu_torch.swarm.powersgd.average_with_powersgd` on
        the accumulated device gradients. The report holds each factor
        round's wire report under ``"p"`` and ``"q"``."""
        from dalle_tpu_torch.swarm.powersgd import average_with_powersgd
        rep = {}
        t_ar = time.monotonic()
        averaged = average_with_powersgd(
            self._powersgd, [g / weight for g in leaves],
            self._powersgd_reduce_fn(group, weight, budget, epoch, rep),
            epoch=epoch)
        self._trace_allreduce(self._round_trace(epoch), t_ar,
                              time.monotonic(), None, group.size)
        return averaged, 0.0, rep

    def _powersgd_reduce_fn(self, group, weight: float, budget: float,
                            epoch: int, reports: dict):
        """Reduce callback for the PowerSGD factor rounds: P, then Q and
        the raw tail, each with half the round budget. An incomplete round
        raises :class:`~dalle_tpu_torch.swarm.powersgd.IncompleteRound`
        (the epoch falls back to local gradients). Each round is audited
        under its phase prefix, and a queued correction for that prefix
        lands in the averaged factors before they are used."""
        from dalle_tpu_torch.swarm.powersgd import IncompleteRound

        def reduce_fn(tensors, phase):
            prefix = f"{self.cfg.run_id}_grads_{phase}"
            rep: dict = {}
            ra = self._new_round_audit(epoch, f"grads_{phase}")
            out = run_allreduce(
                self.dht, group, prefix, epoch, tensors, weight=weight,
                allreduce_timeout=budget / 2, codec=self._grad_codec,
                adaptive_threshold=self.cfg.size_adaptive_threshold,
                report=rep, codec_backend=self._codec_backend,
                ledger=self.ledger, screen=self._screen,
                max_peer_weight=self._max_peer_weight, audit=ra)
            self._submit_audit(ra)
            reports[phase] = rep
            if not rep.get("complete", False):
                raise IncompleteRound(phase)
            return self._repaired(out, prefix)

        return reduce_fn

    def _round_worker(self, pending: _PendingRound) -> None:
        """Wire half of an overlapped round: matchmaking + all-reduce.
        Touches the DHT and the handed-off gradients only — never
        ``self.state`` (the training thread owns it)."""
        t0 = time.monotonic()
        try:
            group = make_group(
                self.dht, f"{self.cfg.run_id}_grads", pending.epoch,
                weight=pending.weight,
                matchmaking_time=self.cfg.matchmaking_time,
                min_group_size=self.matchmaking_min_group,
                client_mode=self.client_mode, authorizer=self.authorizer,
                encrypt=self.cfg.encrypt_data_plane, ledger=self.ledger)
            t_match = time.monotonic()
            pending.timings["matchmaking_s"] = round(t_match - t0, 4)
            if self.tracer is not None:
                self.tracer.add(
                    "swarm", "matchmaking", self._round_trace(
                        pending.epoch), t0, t_match - t0,
                    group=group.size if group is not None else 1)
            if group is not None and group.size > 1:
                budget = min(self.cfg.allreduce_timeout,
                             max(1.0, self.cfg.averaging_timeout
                                 - (t_match - t0)))
                pending.result, pull_s, pending.report = self._exchange(
                    pending.epoch, pending.leaves, pending.weight, group,
                    budget, progress=pending.note_hop)
                pending.timings["grad_pull_s"] = round(pull_s, 4)
                pending.timings["allreduce_s"] = round(
                    time.monotonic() - t_match, 4)
            if group is not None:
                pending.group_size = group.size
        # the error crosses threads on the round object and
        # _finish_pending logs it on the training thread, where the
        # apply-local-grads fallback runs
        # graftlint: disable=silent-except
        except BaseException as e:  # noqa: BLE001 - reported at reconcile
            pending.error = e
        finally:
            pending.hidden_s = time.monotonic() - t0
            pending.done.set()

    def _finish_pending(self, block: bool = False,
                        discard: bool = False) -> None:
        """Reconcile an overlapped round on the training thread: apply its
        averaged gradients (or, for an ALONE / failed round, the handed-off
        device gradients — the synchronous path's exact fallback) and
        advance the epoch. ``block`` waits for the wire thread;
        ``discard`` drops the round instead of applying."""
        pending = self._pending
        if pending is None:
            return
        if not pending.done.is_set() and not block:
            return
        pending.thread.join()
        self._pending = None
        if discard:
            return
        self.last_wire_report = pending.report
        if pending.error is not None:
            logger.warning(
                "overlapped round for epoch %d failed (%r): applying "
                "local gradients", pending.epoch, pending.error)
        averaged = pending.result
        if averaged is None:
            # ALONE epoch (or wire failure): the accumulated grads never
            # left the device
            averaged = [g / pending.weight for g in pending.leaves]
        self._apply_averaged(averaged, preserve_accumulator=True)
        pending.timings.setdefault("grad_pull_s", 0.0)
        pending.timings.setdefault("allreduce_s", 0.0)
        self.last_timings = {
            **pending.timings, **self._apply_timings,
            "group_size": pending.group_size,
            "overlapped_steps": pending.overlapped_steps,
            "hidden_s": round(pending.hidden_s, 4),
            "round_hops": pending.hop_progress(),
            "robust": self.robustness_snapshot(),
        }
        logger.info(
            "overlapped global step -> epoch %d (group=%d, %d grad steps "
            "ran during the %.2fs round, %s)", self.local_epoch,
            pending.group_size, pending.overlapped_steps, pending.hidden_s,
            self.last_timings)

    def round_progress(self) -> Optional[dict]:
        """Hop-granular progress of the in-flight overlapped round
        ({"scatter", "reduce", "gather"} part counts, the epoch and the
        grad steps overlapped so far), or None when no round is
        pending."""
        p = self._pending
        if p is None:
            return None
        prog = p.hop_progress()
        prog["epoch"] = p.epoch
        prog["overlapped_steps"] = p.overlapped_steps
        return prog

    def finalize(self) -> bool:
        """Block until an in-flight overlapped round (if any) is applied.
        Returns True iff a round was applied."""
        if self._pending is None:
            return False
        self._finish_pending(block=True)
        return True

    def drop_pending_round(self) -> None:
        """Abandon the current trajectory's swarm work WITHOUT applying
        it (the rollback paths' hook): discard an in-flight overlapped
        round AND the live gradient accumulator, both computed against
        pre-rollback params."""
        self._finish_pending(block=True, discard=True)
        self._grad_acc = None
        self.local_samples = 0

    def _run_global_step(self) -> None:
        t0 = time.monotonic()
        leaves = self._wire_leaves(self._grad_acc)
        weight = float(max(self.local_samples, 1))
        group = make_group(
            self.dht, f"{self.cfg.run_id}_grads", self.local_epoch,
            weight=weight, matchmaking_time=self.cfg.matchmaking_time,
            min_group_size=self.matchmaking_min_group,
            client_mode=self.client_mode, authorizer=self.authorizer,
            encrypt=self.cfg.encrypt_data_plane, ledger=self.ledger)
        t_match = time.monotonic()
        if self.tracer is not None:
            self.tracer.add(
                "swarm", "matchmaking", self._round_trace(
                    self.local_epoch), t0, t_match - t0,
                group=group.size if group is not None else 1)
        pull_s = 0.0
        if group is not None and group.size > 1:
            budget = min(self.cfg.allreduce_timeout,
                         max(1.0, self.cfg.averaging_timeout
                             - (time.monotonic() - t0)))
            averaged, pull_s, self.last_wire_report = self._exchange(
                self.local_epoch, leaves, weight, group, budget)
        else:
            # alone this epoch: the grads never leave the device
            averaged = [g / weight for g in leaves]
        t_reduce = time.monotonic()
        self._apply_averaged(averaged)
        self.last_timings = {
            "grad_pull_s": round(pull_s, 4),
            "matchmaking_s": round(t_match - t0, 4),
            "allreduce_s": round(t_reduce - t_match - pull_s, 4),
            "group_size": group.size if group is not None else 1,
            **self._apply_timings,
            "robust": self.robustness_snapshot(),
        }
        logger.info("global step -> epoch %d (%.2fs, group=%s, %s)",
                    self.local_epoch, time.monotonic() - t0,
                    group.size if group else 1, self.last_timings)

    def _note_epoch_advanced(self) -> None:
        """Every epoch advance drives the health ledger's strike decay and
        the fault injector's crash-at-epoch (``ChaosDHT.note_epoch``; a
        plain DHT has no such attribute)."""
        self.ledger.advance_epoch(self.local_epoch)
        note = getattr(self.dht, "note_epoch", None)
        if note is not None:
            note(self.local_epoch)

    def _apply_averaged(self, averaged,
                        preserve_accumulator: bool = False) -> None:
        """The post-exchange half of a global step: apply the averaged
        gradients (host arrays or device tensors, wire order), advance the
        epoch, and run the periodic state averaging. Fills
        ``self._apply_timings``. ``preserve_accumulator`` (overlapped
        rounds): the live accumulator holds the NEXT epoch's gradients
        collected during the round and survives the reconcile."""
        t0 = time.monotonic()
        averaged = self._repaired(averaged, f"{self.cfg.run_id}_grads")
        grads = {n: _to_device(a, self._device)
                 for n, a in zip(self._names, averaged)}
        with self.state_lock:
            self.state = self.apply_step(self.state, grads)
        _sync(self._device)
        t_applied = time.monotonic()

        epoch0 = self.local_epoch
        self.local_epoch += 1
        if not preserve_accumulator:
            self.local_samples = 0
            self._grad_acc = None
        self.tracker.reset_epoch(self.local_epoch)
        self._note_epoch_advanced()

        if (self.cfg.average_state_every > 0
                and self.local_epoch % self.cfg.average_state_every == 0):
            self._average_state()
        self._apply_timings = {
            "apply_s": round(t_applied - t0, 4),
            "state_avg_s": round(time.monotonic() - t_applied, 4),
        }
        if self.tracer is not None:
            trace = self._round_trace(epoch0)
            self.tracer.add("swarm", "apply", trace, t0,
                            self._apply_timings["apply_s"])
            if self._apply_timings["state_avg_s"] > 0:
                self.tracer.add("swarm", "state_avg", trace, t_applied,
                                self._apply_timings["state_avg_s"])
            self.tracer.maybe_flush()

        for cb in self.on_after_global_step:
            cb()

    def robustness_snapshot(self) -> dict:
        """The robustness counters of the JAX package's optimizer, with
        its keys: audit volume and verdicts, repairs applied (exact vs
        stale), repair-ring evictions, proof-receipt traffic and the
        error-feedback residuals lost to failed rounds."""
        out = {
            "parts_audited": 0, "audit_fail": 0, "audit_omit": 0,
            "audit_unserved": 0, "ring_evictions": 0,
            "repairs_applied": 0, "repairs_exact": 0,
            "repairs_pending": 0,
            "proofs_published": 0, "proofs_convicted": 0,
            "proofs_rejected": 0, "proofs_by_reference": 0,
            "proof_fetch_attempted": 0, "proof_fetch_ok": 0,
            "proof_fetch_failed": 0, "proof_fetch_timeouts": 0,
            "proof_fetch_failover": 0, "proof_fetch_bytes": 0,
            "ef_lost_rounds": 0,
        }
        if self._auditor is not None:
            ac = self._auditor.counters()
            out["parts_audited"] = ac["audited"]
            out["audit_fail"] = ac["failures"]
            out["audit_omit"] = ac["omissions"]
            out["audit_unserved"] = ac["unserved"]
            out["ring_evictions"] = ac["ring_evictions"]
        if self._repair is not None:
            snap = self._repair.snapshot()
            out["repairs_applied"] = snap["applied"]
            out["repairs_exact"] = snap["applied_exact"]
            out["repairs_pending"] = snap["pending"]
        if self._gossip is not None:
            out["proofs_published"] = self._gossip.proofs_published
            out["proofs_convicted"] = self._gossip.proofs_convicted
            out["proofs_rejected"] = self._gossip.proofs_rejected
            out["proofs_by_reference"] = self._gossip.proofs_by_reference
        if self._evidence is not None:
            for k, v in self._evidence.counters().items():
                out[f"proof_fetch_{k}"] = v
        for ef in (self._ef_scatter, self._ef_gather):
            if ef is not None:
                out["ef_lost_rounds"] += ef.lost_rounds
        return out

    # -- drift control / recovery ----------------------------------------

    def _average_state(self) -> None:
        """Butterfly-average the float content of the state (params + opt
        statistics), in the JAX package's leaf order.

        Block-quantized moments are dequantized before averaging and
        requantized after (averaging their absmax scales against another
        peer's codes would corrupt the moments precisely in the divergent-
        peer situation state averaging exists for). The step count stays
        local (identical updates keep it synchronized)."""
        from dalle_tpu_torch.ops.quant import (Quantized,
                                               dequantize_blockwise,
                                               quantize_blockwise)
        group = make_group(
            self.dht, f"{self.cfg.run_id}_state", self.local_epoch,
            weight=1.0, matchmaking_time=self.cfg.matchmaking_time,
            min_group_size=self.matchmaking_min_group,
            client_mode=self.client_mode, authorizer=self.authorizer,
            encrypt=self.cfg.encrypt_data_plane)
        if group is None or group.size <= 1:
            return
        model, opt_state = self.state.model, self.state.opt_state
        params = dict(model.named_parameters())
        # (kind, name) of each float leaf, the JAX order with a quantized
        # moment as ONE leaf (its dequantized values)
        slots = [("param", n) for n in self._names]
        for moment in ("mu", "nu"):
            slots += [(moment, n) for n in self._names]

        def value(slot):
            kind, name = slot
            if kind == "param":
                return params[name].detach()
            m = getattr(opt_state, kind)[name]
            return dequantize_blockwise(m) if isinstance(m, Quantized) else m

        with self.state_lock:
            floats = [_host(value(s).to(torch.float32)) for s in slots]
        ra = self._new_round_audit(self.local_epoch, "state")
        averaged = run_allreduce(
            self.dht, group, f"{self.cfg.run_id}_state",
            self.local_epoch, floats, weight=1.0,
            allreduce_timeout=self.cfg.allreduce_timeout,
            codec=self._state_codec,
            adaptive_threshold=self.cfg.size_adaptive_threshold,
            codec_backend=self._codec_backend, ledger=self.ledger,
            screen=self._screen, max_peer_weight=self._max_peer_weight,
            audit=ra)
        self._submit_audit(ra)
        if averaged is None:
            return
        # a convicted state round's correction lands in the averaged
        # floats before they are adopted
        averaged = self._repaired(averaged, f"{self.cfg.run_id}_state")
        with self.state_lock, torch.no_grad():
            mu, nu = dict(opt_state.mu), dict(opt_state.nu)
            for (kind, name), avg in zip(slots, averaged):
                if kind == "param":
                    p = params[name]
                    p.copy_(_to_device(avg, p.device).reshape(p.shape)
                            .to(p.dtype))
                    continue
                tree = mu if kind == "mu" else nu
                old = tree[name]
                if isinstance(old, Quantized):
                    x = _to_device(avg, old.codes.device).reshape(old.shape)
                    tree[name] = quantize_blockwise(
                        x, block_size=old.codes.shape[1], signed=old.signed)
                else:
                    tree[name] = _to_device(avg, old.device).reshape(
                        old.shape).to(old.dtype)
            self.state.opt_state = type(opt_state)(opt_state.count, mu, nu)

    def load_state_from_peers(self, min_epoch: int = 0,
                              timeout: Optional[float] = None) -> bool:
        """Bootstrap params+opt state from the freshest live peer
        (reference callback.py:41, run_aux_peer.py:48)."""
        # an in-flight overlapped round averages gradients for state this
        # download is about to replace: drain and discard it first
        self._finish_pending(block=True, discard=True)
        result = load_state_from_peers(
            self.dht, self.cfg.run_id, min_epoch=min_epoch,
            timeout=timeout or self.cfg.averaging_timeout,
            tracer=self.tracer)
        if result is None:
            logger.warning("load_state_from_peers: nobody answered")
            return False
        epoch, arrays = result
        # accept only state that moves us forward (except at epoch 0, where
        # a fresh joiner synchronizes its random init with the swarm)
        if epoch < self.local_epoch or (
                epoch == self.local_epoch and self.local_epoch > 0):
            logger.warning("ignoring stale peer state (epoch %d <= local "
                           "%d)", epoch, self.local_epoch)
            return False
        try:
            self._replace_state_leaves(arrays)
        except (ValueError, RuntimeError):  # structurally alien state
            logger.warning("peer state does not match local structure",
                           exc_info=True)
            return False
        self.local_epoch = max(epoch, self.local_epoch)
        self.local_samples = 0
        self._grad_acc = None
        self.tracker.reset_epoch(self.local_epoch)
        self._note_epoch_advanced()
        for cb in self.on_load_state_from_peers:
            cb()
        return True

    def shutdown(self) -> None:
        self._finish_pending(block=True, discard=True)
        if self._server is not None:
            self._server.stop()
            self._server = None
        if self._gossip is not None:
            # signal AND bounded-join BEFORE the caller tears the DHT
            # down: an in-flight publish/fold on a destroyed native node
            # is a use-after-free
            self._gossip.stop()
            self._gossip = None
        if self._evidence is not None:
            # after the gossip worker (it publishes through this plane),
            # before the DHT dies
            self._evidence.stop()
            self._evidence = None
        if self._auditor is not None:
            # an in-flight transcript fetch needs a live node
            self._auditor.stop()
            self._auditor = None
        if self.tracer is not None:
            self.tracer.flush()

    def __enter__(self) -> "CollaborativeOptimizer":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()


def _host(t) -> np.ndarray:
    """A host copy of a tensor (or an array), through a pinned buffer for
    a GPU tensor."""
    if isinstance(t, torch.Tensor):
        from dalle_tpu_torch.swarm.device_codec import to_host
        return to_host(t)
    return np.array(t, copy=True)


def _writable(a):
    """An averaged leaf the repair plane may patch in place: a tensor as
    an f32 contiguous tensor on its device (no host pull), a host array
    as a fresh f32 copy."""
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).contiguous()
    return np.array(a, np.float32, copy=True)


def _to_device(a, device: torch.device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
