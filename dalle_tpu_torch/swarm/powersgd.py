"""PowerSGD gradient compression for swarm averaging (counterpart of
``dalle_tpu/swarm/powersgd.py``), its device math on torch.

Low-rank gradient compression (Vogels et al., NeurIPS 2019) as an alternate
``grad_compression`` mode. Per 2D-reshapable gradient M (m x n), rank r:

1. error feedback: ``M += e`` (the residual from last round);
2. ``P = M @ Q`` with the epoch-seeded projection Q (n x r);
3. **average P across the group** (the butterfly all-reduce);
4. orthogonalize the averaged P (modified Gram-Schmidt) — every peer runs
   the same deterministic step on the same averaged bytes, so all peers
   hold the identical orthonormal basis;
5. ``Q = M^T @ P_orth`` and **average Q across the group**;
6. reconstruct ``G = P_orth @ Q^T``; store ``e = M - G`` locally.

**Where the work happens.** The O(m*n*r) products — the P and Q
projections, the reconstruction and the error-feedback update — run as
torch ops on the compressor's device, in f32 (TF32 stays off, as the
package sets it), and the error-feedback and M caches are tensors there.
The JAX package runs the same products as jitted XLA ops outside any
Pallas kernel. Only the rank-r factors cross to the host for the wire,
unless ``keep_factors_on_device`` hands them to the device wire codec.

Gram-Schmidt runs on the HOST by default (``host_orthogonalize=True``):
:func:`orthogonalize` is the JAX package's numpy loop, so a JAX peer and
a torch peer derive bit-identical bases from the same averaged-P bytes.
Q is seeded from ``(seed, tensor index, epoch)`` with numpy's
``RandomState``, so both frameworks' peers project with the same Q.

Across frameworks the averaged factor bytes and ``P_orth`` are identical;
the reconstruction ``P_orth @ Q_avg^T`` and ``e = M - G`` are each
framework's own matmul and differ in the last bits (the JAX package
accepts the same across XLA backends). Two port peers end bitwise equal.

An incomplete factor round (a member died mid-exchange) raises
:class:`IncompleteRound`; the caller then keeps its exact local gradients
for the epoch. Tensors too small to win from rank-r factorization travel
uncompressed in the Q round.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

#: tensors compress only if rank-r factors are at most this fraction of
#: the raw payload (hivemind's min_compression_rate idea)
MIN_COMPRESSION_RATIO = 0.5


class IncompleteRound(Exception):
    """A factor all-reduce did not receive every expected chunk: this
    peer's averaged bytes may differ from other survivors', so the caller
    must not reconstruct from them (mismatched orthogonal bases corrupt
    the gradients on every peer)."""


@dataclasses.dataclass
class _TensorPlan:
    index: int                   # position in the gradient leaf list
    shape: Tuple[int, ...]       # original shape
    m: int                       # rows after 2D reshape
    n: int                       # cols after 2D reshape


def _as_matrix(shape: Sequence[int]) -> Tuple[int, int]:
    """Collapse a >=2D shape to (leading, trailing) — first axis vs rest,
    the standard PowerSGD matricization."""
    m = int(shape[0])
    n = 1
    for s in shape[1:]:
        n *= int(s)
    return m, n


#: a column whose post-projection residual is below this fraction of its
#: original norm is (numerically) linearly dependent on the earlier basis:
#: it is ZEROED, not normalized (normalizing cancellation noise would make
#: P_orth non-orthogonal); error feedback recovers the residual.
MGS_RELATIVE_TOL = 1e-4


def orthogonalize(p: np.ndarray, rel_tol: float = MGS_RELATIVE_TOL
                  ) -> np.ndarray:
    """Host-side modified Gram-Schmidt: plain IEEE f32 loop order, the
    JAX package's function verbatim, bit-identical across x86 peers for
    identical input bytes. Numerically dependent columns come back zero."""
    p = np.array(p, np.float32, copy=True)
    for i in range(p.shape[1]):
        col = p[:, i]
        orig = float(np.linalg.norm(col))
        for j in range(i):
            col -= (col @ p[:, j]) * p[:, j]
        norm = float(np.linalg.norm(col))
        if norm > rel_tol * orig:
            p[:, i] = col / norm
        else:
            p[:, i] = 0.0
    return p


def orthogonalize_device(p: torch.Tensor,
                         rel_tol: float = MGS_RELATIVE_TOL
                         ) -> torch.Tensor:
    """Device MGS over the (few) rank columns, with the same
    dependent-column zeroing as :func:`orthogonalize`."""
    cols: List[torch.Tensor] = []
    for i in range(p.shape[1]):
        c = p[:, i]
        orig = torch.linalg.vector_norm(c)
        for q in cols:
            c = c - torch.dot(c, q) * q
        norm = torch.linalg.vector_norm(c)
        keep = norm > rel_tol * orig
        safe = torch.where(keep, norm, torch.ones_like(norm))
        cols.append(torch.where(keep, c / safe, torch.zeros_like(c)))
    return torch.stack(cols, dim=1)


def _tensor(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def _host(t: torch.Tensor) -> np.ndarray:
    from dalle_tpu_torch.swarm.device_codec import to_host
    return to_host(t)


class PowerSGDCompressor:
    """Per-peer PowerSGD state: error feedback and the in-flight M caches,
    tensors on ``device``. Qs are epoch-seeded, never warm-started (a
    joiner derives the veterans' Q without communication), so there is no
    cross-epoch basis state.

    One instance per CollaborativeOptimizer; its lifetime spans epochs so
    error feedback accumulates.
    """

    def __init__(self, rank: int = 4, seed: int = 0,
                 min_ratio: float = MIN_COMPRESSION_RATIO,
                 host_orthogonalize: bool = True,
                 keep_factors_on_device: bool = False,
                 device: Optional[torch.device] = None):
        self.rank = rank
        self.seed = seed
        self.min_ratio = min_ratio
        self.host_orthogonalize = host_orthogonalize
        # hand the P/Q factors (and the raw tail) to the wire as tensors
        # on the device: the device wire codec consumes them there
        self.keep_factors_on_device = keep_factors_on_device
        self.device = torch.device(device if device is not None else "cpu")
        self._errors: Dict[int, torch.Tensor] = {}
        self._mat_cache: Dict[int, torch.Tensor] = {}
        self._p_orth: Dict[int, torch.Tensor] = {}

    # -- planning ---------------------------------------------------------

    def plan(self, leaves: Sequence[Any]) -> List[_TensorPlan]:
        plans = []
        for i, leaf in enumerate(leaves):
            if len(leaf.shape) < 2:
                continue
            m, n = _as_matrix(leaf.shape)
            if min(m, n) < self.rank:
                continue  # factorization cannot even express the tensor
            if self.rank * (m + n) > self.min_ratio * m * n:
                continue
            plans.append(_TensorPlan(i, tuple(leaf.shape), m, n))
        return plans

    def _q_for(self, plan: _TensorPlan, epoch: int) -> np.ndarray:
        # seeded by (seed, tensor index, epoch) ONLY — every peer,
        # including one that just joined, derives the identical Q
        rng = np.random.RandomState(
            (self.seed * 1_000_003 + plan.index * 7919 + epoch)
            % (2 ** 31 - 1))
        return orthogonalize(
            rng.randn(plan.n, self.rank).astype(np.float32))

    def _factors_out(self, ts: List[torch.Tensor]) -> List[Any]:
        if self.keep_factors_on_device:
            return list(ts)  # the device wire codec consumes them as-is
        return [_host(t) for t in ts]

    # -- the two communication phases ------------------------------------

    def phase1_ps(self, leaves: Sequence[Any],
                  plans: List[_TensorPlan],
                  epoch: int = 0) -> List[Any]:
        """Error-compensated P factors to be averaged across the group,
        ``(M + e) @ Q`` on the device."""
        ps = []
        with torch.no_grad():
            for p in plans:
                mat = _tensor(leaves[p.index], self.device).reshape(p.m, p.n)
                e = self._errors.get(p.index)
                if e is None or tuple(e.shape) != (p.m, p.n):
                    e = 0.0  # adds like JAX's zeros: -0.0 becomes +0.0
                me = mat.to(torch.float32) + e
                q = torch.from_numpy(self._q_for(p, epoch)).to(self.device)
                self._mat_cache[p.index] = me
                ps.append(me @ q)
        return self._factors_out(ps)

    def phase2_qs(self, plans: List[_TensorPlan],
                  averaged_ps: List[Any]) -> List[Any]:
        """Orthogonalize averaged Ps, compute the Q factors to average,
        ``(M + e)^T @ P_orth`` on the device."""
        self._p_orth = {}
        qs = []
        with torch.no_grad():
            for p, pa in zip(plans, averaged_ps):
                if self.host_orthogonalize:
                    host = (_host(pa) if isinstance(pa, torch.Tensor)
                            else np.asarray(pa, np.float32))
                    po = torch.from_numpy(orthogonalize(
                        host.reshape(p.m, self.rank))).to(self.device)
                else:
                    po = orthogonalize_device(_tensor(pa, self.device)
                                              .to(torch.float32)
                                              .reshape(p.m, self.rank))
                self._p_orth[p.index] = po
                qs.append(self._mat_cache[p.index].T @ po)
        return self._factors_out(qs)

    def reconstruct(self, leaves: List[Any],
                    plans: List[_TensorPlan],
                    averaged_qs: List[Any]) -> List[Any]:
        """Replace planned leaves with the rank-r group average (tensors
        on the device) and update the error feedback there."""
        out = list(leaves)
        with torch.no_grad():
            for p, qa in zip(plans, averaged_qs):
                me = self._mat_cache.pop(p.index)
                q_avg = _tensor(qa, self.device).to(torch.float32).reshape(
                    p.n, self.rank)
                approx = self._p_orth[p.index] @ q_avg.T
                self._errors[p.index] = me - approx
                out[p.index] = approx.reshape(p.shape)
        self._p_orth = {}
        return out

    def abandon_round(self) -> None:
        """Discard this round's in-flight state after an incomplete factor
        exchange: the caller keeps its local gradients, so error feedback
        for the round is not recorded and cached matrices are dropped."""
        self._mat_cache.clear()
        self._p_orth = {}


def _local_f32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return np.array(x, np.float32)


def average_with_powersgd(
        compressor: PowerSGDCompressor,
        leaves: Sequence[Any],
        reduce_fn,
        epoch: int = 0,
) -> List[Any]:
    """Run the full PowerSGD exchange.

    ``leaves`` may be tensors (the trainer's accumulated grads — no host
    pull happens for the planned ones) or numpy arrays.
    ``reduce_fn(tensors, phase)`` performs the group averaging for one
    phase ("p" or "q"): the butterfly all-reduce with the phase folded
    into the round prefix, or a plain mean in tests. It may raise
    :class:`IncompleteRound`; the caller then keeps its exact local
    gradients for the epoch.

    The result: the rank-r approximate mean for planned matrices (tensors
    on the compressor's device), the exact mean for everything else (the
    arrays the wire produced).
    """
    leaves = list(leaves)
    plans = compressor.plan(leaves)
    planned = {p.index for p in plans}

    try:
        ps = compressor.phase1_ps(leaves, plans, epoch)
        averaged_ps = reduce_fn(ps, "p") if ps else []
        qs = compressor.phase2_qs(plans, averaged_ps)
        unplanned = [leaves[i] for i in range(len(leaves))
                     if i not in planned]
        if compressor.keep_factors_on_device:
            # the raw tail rides the wire from wherever it lives
            raw = unplanned
        else:
            raw = [_host(a.to(torch.float32)) if isinstance(a, torch.Tensor)
                   else np.asarray(a).astype(np.float32, copy=False)
                   for a in unplanned]
        averaged_tail = reduce_fn(qs + raw, "q") if (qs or raw) else []
    except IncompleteRound:
        compressor.abandon_round()
        return [_local_f32(x) for x in leaves]
    averaged_qs = averaged_tail[:len(qs)]
    averaged_raw = averaged_tail[len(qs):]

    out = compressor.reconstruct(leaves, plans, averaged_qs)
    it = iter(averaged_raw)
    for i in range(len(out)):
        if i not in planned:
            out[i] = np.asarray(next(it)).reshape(tuple(leaves[i].shape))
    return out
