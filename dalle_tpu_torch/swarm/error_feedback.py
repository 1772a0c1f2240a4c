"""Error-feedback residuals for the quantized butterfly all-reduce
(counterpart of ``dalle_tpu/swarm/error_feedback.py``).

Every quantizer keeps the error it just made and adds it back before it
quantizes the next round, so the quantization noise telescopes instead of
accumulating (EF-SGD, Karimireddy et al. 2019). Two legs:

- **Scatter leg (sender side), on the device.** One residual the size of the
  flat gradient. ``compensate(flat)`` returns ``flat + residual`` before the
  per-part wire encode; ``store(comp, decoded_segs)`` keeps ``comp -
  cat(decoded_segs)``, the segments being what each part's owner decoded
  (:meth:`device_codec.EncodedPart.decoded_dev`; the peer's own part is
  applied raw, so it is its own segment). For tensors both steps work in
  place, as the JAX package donates its buffers: ``compensate`` adds
  ``flat`` into the residual's buffer and returns it, ``store`` subtracts
  into ``comp`` and keeps it as the next residual, so the caller must not
  read ``comp`` after ``store``. Host numpy arrays take the same math.
- **Gather leg (owner side), on the host.** ``compensate_slice`` /
  ``store_slice`` carry the owner's residual for the part it re-quantizes
  for the broadcast; the residual persists at the full vector's size,
  since part boundaries move with the roster.

A round that fails between compensate and store loses its scatter residual
(restart from zero, safe but lossy) or may re-carry a gather slice; both
are counted in ``lost_rounds`` and logged.
"""

from __future__ import annotations

import logging
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

logger = logging.getLogger(__name__)

Array = Union[np.ndarray, torch.Tensor]


class ErrorFeedback:
    """The persistent quantization-error residual of one all-reduce leg.
    It starts at zero and starts again at zero when the vector's size
    changes."""

    def __init__(self) -> None:
        self._resid: Optional[Array] = None
        self._in_flight = False
        self.rounds = 0        # stores completed
        self.lost_rounds = 0   # residuals consumed and never stored

    # -- scatter leg (whole vector, device-capable) --------------------

    def compensate(self, flat: Array) -> Array:
        """``flat + residual``; for a tensor, computed in the residual's
        buffer, which the caller then owns."""
        if self._in_flight:
            self.lost_rounds += 1
            logger.warning(
                "error-feedback residual lost: the previous round "
                "consumed it and never stored (failed round?); restarting "
                "from zero (%d lost so far)", self.lost_rounds)
        n = int(flat.shape[0])
        resid = self._resid
        if resid is None or int(resid.shape[0]) != n:
            resid = np.zeros(n, np.float32)
        self._resid = None     # consumed
        self._in_flight = True
        if isinstance(flat, torch.Tensor):
            resid = torch.as_tensor(resid, dtype=torch.float32,
                                    device=flat.device)
            return resid.add_(flat)
        if isinstance(resid, torch.Tensor):
            resid = resid.detach().cpu().numpy()
        return flat + resid

    def store(self, comp: Array, decoded_segs: Sequence[Array]) -> None:
        """``residual = comp - cat(decoded_segs)``, the error the wire just
        made; the segments cover the vector in part order. A tensor ``comp``
        becomes the residual (the caller must not read it again)."""
        if isinstance(comp, torch.Tensor):
            self._resid = comp.sub_(torch.cat(list(decoded_segs)))
        else:
            decoded = np.concatenate([np.asarray(s, np.float32)
                                      for s in decoded_segs])
            self._resid = comp - decoded
        self._in_flight = False
        self.rounds += 1

    # -- gather leg (owned slice of a persistent full vector) ----------

    def compensate_slice(self, part: np.ndarray, lo: int, hi: int,
                         total: int) -> np.ndarray:
        """``part + residual[lo:hi]`` on the host; the slices this peer
        does not own this round keep their pending error."""
        if self._in_flight:
            self.lost_rounds += 1
            logger.warning(
                "gather error-feedback residual re-carried without a store "
                "(failed round?); receivers of the dead round may see up to "
                "one extra quantization step (%d such rounds so far)",
                self.lost_rounds)
        if self._resid is None or int(self._resid.shape[0]) != total:
            self._resid = np.zeros(total, np.float32)
        self._in_flight = True
        return part + self._resid[lo:hi]

    def store_slice(self, comp_part: np.ndarray, decoded: np.ndarray,
                    lo: int, hi: int, total: int) -> None:
        if self._resid is None or int(self._resid.shape[0]) != total:
            self._resid = np.zeros(total, np.float32)
        self._resid[lo:hi] = comp_part - decoded
        self._in_flight = False
        self.rounds += 1

    def residual_host(self) -> Optional[np.ndarray]:
        """A host copy of the residual (None before any round)."""
        if self._resid is None:
            return None
        if isinstance(self._resid, torch.Tensor):
            return self._resid.detach().cpu().numpy()
        return np.asarray(self._resid, np.float32)


def make_pair() -> List[ErrorFeedback]:
    """(scatter, gather): the two legs one peer carries."""
    return [ErrorFeedback(), ErrorFeedback()]
