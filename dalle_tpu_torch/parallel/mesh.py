"""The peer's device mesh, sized (counterpart of the size resolution of
``dalle_tpu/parallel/mesh.py``'s ``make_mesh``).

The JAX package lays a peer's devices out on a ``(dp, fsdp, tp, sp)``
mesh. The port drives one device a process, and its processes form the
peer (``parallel/multihost.py``), so the mesh's devices are the peer's
processes and ``dp`` is the only axis that may exceed 1: each process
trains on its rows of the batch. ``dp=-1`` absorbs the processes the
other axes leave, and a layout that does not cover them raises the JAX
package's ``ValueError``. ``fsdp``, ``tp`` and ``sp`` above 1 shard
parameters or sequences across devices, which waits for the multi-GPU
slice: this is the one place that refuses them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

from dalle_tpu_torch.parallel.multihost import process_count

AXES = ("dp", "fsdp", "tp", "sp")


@dataclass(frozen=True)
class Mesh:
    """The resolved axis sizes."""

    dp: int
    fsdp: int = 1
    tp: int = 1
    sp: int = 1

    @property
    def shape(self) -> Dict[str, int]:
        return {axis: getattr(self, axis) for axis in AXES}


def make_mesh(dp: int = -1, fsdp: int = 1, tp: int = 1, sp: int = 1,
              n_devices: Optional[int] = None) -> Mesh:
    """The ``(dp, fsdp, tp, sp)`` sizes over ``n_devices`` devices (default:
    the peer's processes, one device each)."""
    if fsdp != 1 or tp != 1 or sp != 1:
        raise NotImplementedError(
            f"mesh fsdp={fsdp} tp={tp} sp={sp}: the port shards nothing "
            "yet; it trains on one GPU a process, data-parallel over the "
            "processes (dp). Sharded axes wait for the multi-GPU slice "
            "(ROADMAP Queue 1 item 7)")
    n = process_count() if n_devices is None else n_devices
    rest = fsdp * tp * sp
    if dp == -1:
        if n % rest:
            raise ValueError(
                f"{n} devices not divisible by fsdp*tp*sp={rest}")
        dp = n // rest
    if dp * rest != n:
        raise ValueError(
            f"mesh {dp}x{fsdp}x{tp}x{sp} != device count {n} (one GPU a "
            "process: the devices are the peer's processes)")
    return Mesh(dp, fsdp, tp, sp)
