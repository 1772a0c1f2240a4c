"""Byzantine gradient screening: drop valid-but-wrong contributions.

The trust model below this layer stops at transport integrity: signed
frames and strict parsing (allreduce._parse) catch malformed or forged
traffic, but a peer that signs *correct-looking wrong* data — a
sign-flipped gradient, a scaled one, deterministic garbage re-signed
under its real identity — passes every check and lands in the average
with full force. This module is the content-level defense, shaped after
BTARD-style Byzantine-tolerant collaborative training (Gorbunov et al.,
arXiv 2106.11257) and the CenteredClip family of robust aggregators
(Karimireddy et al., arXiv 2012.10333), adapted to one hard local
constraint: the swarm's convergence oracle (CHAOS.md) is *bit-exact*,
so the screen must decide DROP or KEEP per sender and never reweight,
clip, or blend — a surviving round is then bit-identical to an
honest-only round over the survivors, and the exactness oracle still applies.

Where it runs: at ``allreduce.apply_reduce`` time each part owner
already holds every sender's decoded segment of its part — the one
place in the protocol with a cross-sender view of the same coordinates.
The screen there computes, per sender,

- the segment L2 **norm**, compared against the *median* sender norm
  (a scaled or garbage gradient shows up as a norm ratio; the median is
  itself robust to a minority of liars), and
- the **cosine agreement** with the leave-one-out weighted mean of the
  other senders (a sign-flipped gradient agrees with nobody; honest
  non-IID peers are noisy but not anti-correlated).

Drops are greedy and ITERATIVE: the single worst offender is removed
and the statistics recomputed, because one loud attacker (a 100x-scaled
segment) drags the leave-one-out mean toward itself and masks a quiet
one (the classic masking attack on one-shot outlier tests).

Guard rails, in order of precedence:

- **non-finite is always dropped** — NaN/Inf poisons the accumulator
  regardless of roster size, so this check ignores ``min_senders`` and
  does not count against the drop budget;
- **small swarms are never screened** (``min_senders``, default 4
  weighted contributors including self): with 2-3 senders the
  leave-one-out "consensus" is one or two peers' word against another's
  — the same unattributability rule the timeout-strike path follows.
  NOTE the allreduce integration distinguishes a small ROSTER (screen
  off, pre-screening semantics byte-for-byte) from a screenable roster
  whose DELIVERIES fell below the quorum — the latter withholds the
  part entirely (see ``run_allreduce``);
- **bounded drops** (``max_drop_frac``, default just under half): the
  screen can never evict a majority, so a coordinated minority cannot
  use it to take over the round;
- **calibrated tolerances** (``norm_tolerance``, ``cosine_floor``):
  honest non-IID volunteers differ in norm by small factors and are
  weakly correlated, never strongly anti-correlated — the defaults sit
  far outside that envelope and are pinned by a false-positive test
  (tests/test_screening.py).

Screening verdicts are ATTRIBUTABLE: the frame signature already proved
the sender produced these exact bytes, so a drop feeds the health
ledger (``health.PeerHealthLedger``) as a ``screen-outlier`` strike and
may be gossiped as a signed receipt (health.StrikeGossip) — unlike
timeout bans, which stay local because silence is never provable.
"""

from __future__ import annotations

import dataclasses
import logging
import math
from typing import Dict, List, Tuple

import numpy as np

logger = logging.getLogger(__name__)

#: strike reason fed to the health ledger for screened senders
SCREEN_REASON = "screen-outlier"


#: lane width of the fixed-order summation: n/4096 sequential
#: vectorized adds, then one exact fsum over 4096 lane partials
_SUM_LANES = 4096


def _fixed_order_sum(x: np.ndarray) -> float:
    """Build-independent f64 sum with an explicitly-spelled-out order.

    The screen's verdicts are a DETERMINISM surface: the audit replay
    (swarm/audit.py) recomputes them on arbitrary hosts and convicts
    owners on a mismatch. numpy/BLAS reductions (np.sum, linalg.norm,
    ``@``) sum in a SIMD-width/build-dependent order, so a mixed-build
    fleet could split honest verdicts on ulp-boundary inputs (the
    CHAOS.md "Known gaps" entry this function closes). Here the order
    is fixed BY THE CODE, never by the backend: the (zero-padded)
    input is viewed as rows of ``_SUM_LANES`` and rows are accumulated
    one by one — pure elementwise f64 vector adds, which have no
    intra-op reduction to reorder — then the 4096 lane partials are
    combined with ``math.fsum``, which is exactly rounded and hence
    order-free. Cost: one vectorized pass over the data plus an fsum
    over 4096 scalars — near np.sum speed, not the per-element-Python
    fsum this replaced (seconds per flagship-scale sender).
    """
    x = np.ascontiguousarray(x, np.float64).reshape(-1)
    n = x.size
    if n == 0:
        return 0.0
    pad = (-n) % _SUM_LANES
    if pad:
        x = np.concatenate([x, np.zeros(pad, np.float64)])
    rows = x.reshape(-1, _SUM_LANES)
    acc = rows[0].copy()
    for i in range(1, rows.shape[0]):
        acc += rows[i]          # explicit order: ascending row index
    return math.fsum(acc.tolist())


def _fsum_sq(seg: np.ndarray) -> float:
    """Fixed-order sum of squares — see :func:`_fixed_order_sum`."""
    return _fixed_order_sum(np.square(np.asarray(seg, np.float64)))


def _fsum_dot(a: np.ndarray, b: np.ndarray) -> float:
    """Fixed-order f64 dot product — see :func:`_fixed_order_sum`."""
    return _fixed_order_sum(np.asarray(a, np.float64)
                            * np.asarray(b, np.float64))


def _fsum_norm(seg: np.ndarray) -> float:
    return math.sqrt(_fsum_sq(seg))


@dataclasses.dataclass(frozen=True)
class ScreenPolicy:
    """Tunable envelope of the screen (CollabConfig.screen_* knobs).

    ``min_senders`` counts weighted contributors INCLUDING this part
    owner's own contribution. ``max_drop_frac`` bounds outlier drops
    (non-finite drops are exempt — see module docstring). The
    tolerance defaults are deliberately loose: the screen exists to
    catch sign flips, order-of-magnitude scalings and garbage, not to
    police honest statistical heterogeneity.
    """

    min_senders: int = 4
    #: strictly below one half by default: the screen must never be
    #: able to evict a majority of the round
    max_drop_frac: float = 0.49
    #: drop when ||v_i|| > norm_tolerance * median(||v||)
    norm_tolerance: float = 8.0
    #: drop when cos(v_i, leave-one-out mean) < cosine_floor; honest
    #: non-IID gradients are noisy (cos near 0 is normal) but never
    #: strongly anti-correlated — -0.5 is far outside the honest
    #: envelope while a sign flip sits at exactly -1
    cosine_floor: float = -0.5
    #: ABSOLUTE per-sender L2 norm ceiling, active at ANY sender count
    #: (unlike the relative checks above it needs no leave-one-out
    #: consensus) — it narrows the <4-sender gap where LOO screening
    #: must skip. 0 disables. Below ``min_senders`` the drop carries
    #: NO strike (2-peer unattributability: with two peers either
    #: could be the liar about what "too big" means — the clamp is the
    #: defense, the strike needs a quorum). Deployments size it well
    #: above the honest gradient envelope (e.g. 10-100x the expected
    #: accumulated-gradient norm); there is deliberately no finite
    #: default — an absolute bound is model- and scale-specific.
    abs_norm_ceiling: float = 0.0

    def __post_init__(self):
        if self.min_senders < 3:
            # with 2 senders the leave-one-out mean IS the other peer:
            # screening would let either evict the other (veto) — the
            # 2-peer unattributability rule from the timeout path
            raise ValueError(
                f"min_senders must be >= 3, got {self.min_senders}")
        if not 0.0 < self.max_drop_frac < 1.0:
            raise ValueError(
                f"max_drop_frac must be in (0, 1), got {self.max_drop_frac}")
        if self.norm_tolerance <= 1.0:
            raise ValueError(
                f"norm_tolerance must be > 1, got {self.norm_tolerance}")
        if not -1.0 <= self.cosine_floor <= 1.0:
            raise ValueError(
                f"cosine_floor must be in [-1, 1], got {self.cosine_floor}")
        if self.abs_norm_ceiling < 0:
            raise ValueError(
                f"abs_norm_ceiling must be >= 0 (0 disables), "
                f"got {self.abs_norm_ceiling}")


@dataclasses.dataclass
class ScreenVerdict:
    """What the screen decided for one part's contributions.

    ``dropped`` maps sender key -> human-readable reason string
    ("nonfinite", "norm-ratio 101.2", "cosine -1.00"). ``skipped`` is
    True when the roster was below ``min_senders`` and only the
    non-finite check ran. ``stats`` carries the per-sender
    (norm_ratio, cosine) pairs measured on the FINAL survivor set —
    observability for the soak reports and tests.
    """

    dropped: Dict[int, str] = dataclasses.field(default_factory=dict)
    skipped: bool = False
    stats: Dict[int, Tuple[float, float]] = dataclasses.field(
        default_factory=dict)
    #: drops that must NOT feed the ledger: absolute-ceiling drops
    #: made below the ``min_senders`` quorum (drop the data, withhold
    #: the strike — the small-swarm unattributability rule)
    dropped_unstruck: Dict[int, str] = dataclasses.field(
        default_factory=dict)


class GradientScreen:
    """Stateless drop/keep screen over one part's sender segments.

    ``screen()`` takes ``{sender_key: (weight, segment)}`` — every
    fully-delivered weighted contribution for one part, the owner's own
    included — and returns a :class:`ScreenVerdict`. Pure function of
    its inputs (deterministic, no RNG), so every honest part owner
    holding the same segments reaches the same verdict.
    """

    def __init__(self, policy: ScreenPolicy = ScreenPolicy()):
        self.policy = policy

    # -- internals ---------------------------------------------------------

    @staticmethod
    def _finite(seg: np.ndarray) -> bool:
        return bool(np.isfinite(seg).all())

    @staticmethod
    def _abs_norm(seg: np.ndarray) -> float:
        """Fixed-order (fsum) f64 L2 norm — the determinism surface
        the audit replay recomputes bit-equal on ANY host build."""
        return _fsum_norm(seg)

    def over_ceiling(self, seg: np.ndarray) -> bool:
        """Whether a segment violates the absolute-norm ceiling; the
        streaming (below-quorum) allreduce path calls this per
        completed sender, and the audit replay re-applies the same
        predicate. False whenever the ceiling is disabled."""
        c = self.policy.abs_norm_ceiling
        return c > 0 and self._abs_norm(seg) > c

    @staticmethod
    def _measure(contribs: Dict[int, Tuple[float, np.ndarray]],
                 keys: List[int]) -> Dict[int, Tuple[float, float]]:
        """(norm_ratio, cosine vs leave-one-out mean) per sender over
        the given survivor set. The reductions (norms, dots) are
        exactly-rounded fixed-order fsum — the verdict must not depend
        on f32 OR f64 summation order (mixed numpy builds must never
        split audit verdicts) — while the segments themselves are
        untouched (the caller's accumulation stays the bit-exact f32
        path). The leave-one-out mean is built from elementwise f64
        ops only, which are order-free by construction."""
        norms = {k: _fsum_norm(contribs[k][1]) for k in keys}
        med = float(np.median([norms[k] for k in keys]))
        total = np.zeros(contribs[keys[0]][1].size, np.float64)
        total_w = 0.0
        for k in keys:
            w, seg = contribs[k]
            total += seg.astype(np.float64) * w
            total_w += w
        out: Dict[int, Tuple[float, float]] = {}
        for k in keys:
            w, seg = contribs[k]
            ratio = norms[k] / med if med > 0.0 else (
                np.inf if norms[k] > 0.0 else 1.0)
            rest_w = total_w - w
            if rest_w <= 0.0:
                out[k] = (ratio, 1.0)  # nobody to disagree with
                continue
            loo = (total - seg.astype(np.float64) * w) / rest_w
            denom = norms[k] * _fsum_norm(loo)
            cos = (_fsum_dot(seg, loo) / denom
                   if denom > 0.0 else 1.0)  # a zero vector harms nobody
            out[k] = (ratio, cos)
        return out

    # -- the screen --------------------------------------------------------

    def screen(self, contribs: Dict[int, Tuple[float, np.ndarray]]
               ) -> ScreenVerdict:
        verdict = ScreenVerdict()
        pol = self.policy
        survivors = []
        for k in sorted(contribs):
            w, seg = contribs[k]
            if not np.isfinite(w):
                # a NaN/Inf WEIGHT poisons total_w and the accumulator
                # exactly like NaN data — and `w <= 0` is False for
                # NaN, so it must be rejected before the sign check
                verdict.dropped[k] = "nonfinite"
                continue
            if w <= 0:
                continue  # weight-0 senders never reach the accumulator
            if not self._finite(seg):
                verdict.dropped[k] = "nonfinite"
            else:
                survivors.append(k)
        # the absolute ceiling runs at ANY sender count (it needs no
        # leave-one-out consensus); whether the drop STRIKES depends
        # on the quorum below
        over: Dict[int, str] = {}
        if pol.abs_norm_ceiling > 0:
            for k in list(survivors):
                nrm = self._abs_norm(contribs[k][1])
                if nrm > pol.abs_norm_ceiling:
                    over[k] = f"abs-norm {nrm:.4g}"
                    survivors.remove(k)
        if (len(survivors) + len(verdict.dropped)
                + len(over)) < pol.min_senders:
            # small swarm: outlier screening is one peer's word against
            # another's — only the unambiguous non-finite check applies,
            # and ceiling drops are made WITHOUT a strike
            verdict.skipped = True
            verdict.dropped_unstruck.update(over)
            return verdict
        verdict.dropped.update(over)
        # the drop budget covers OUTLIER drops; the minimum survivor
        # count keeps a majority alive by construction
        budget = int(pol.max_drop_frac * len(survivors))
        while budget > 0 and len(survivors) >= 2:
            stats = self._measure(contribs, survivors)
            flagged = [
                k for k in survivors
                if stats[k][0] > pol.norm_tolerance
                or stats[k][1] < pol.cosine_floor]
            if not flagged:
                break
            # worst single offender first, then re-measure: a loud
            # outlier drags the leave-one-out mean and masks quiet ones.
            # Rank norm violations above cosine violations (they distort
            # the mean the most), break ties deterministically by key.
            def badness(k):
                ratio, cos = stats[k]
                return (ratio > pol.norm_tolerance, ratio, -cos, -k)
            worst = max(flagged, key=badness)
            ratio, cos = stats[worst]
            verdict.dropped[worst] = (
                f"norm-ratio {ratio:.4g}" if ratio > pol.norm_tolerance
                else f"cosine {cos:.2f}")
            survivors.remove(worst)
            budget -= 1
        verdict.stats = self._measure(contribs, survivors) \
            if len(survivors) >= 2 else {}
        return verdict
