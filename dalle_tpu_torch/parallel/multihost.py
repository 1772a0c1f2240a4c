"""The process roles of a trainer peer (counterpart of
``dalle_tpu/parallel/multihost.py``).

In the JAX package a multi-host slice presents as one swarm peer: process
0 speaks the swarm protocol and broadcasts its decisions and the averaged
gradients to the other processes. The port runs one process per peer for
now: that process is the coordinator, and more than one process (a
``torch.distributed`` group of size > 1) raises until the multi-GPU slice
ports the broadcasts.
"""

from __future__ import annotations


def process_count() -> int:
    """The processes of this peer: 1, or the size of an initialised
    ``torch.distributed`` group (which :class:`SliceRole` refuses)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


class SliceRole:
    """This process's role: the coordinator of a one-process peer, which
    speaks the swarm protocol (``swarm_enabled``)."""

    def __init__(self) -> None:
        self.n_processes = process_count()
        if self.n_processes != 1:
            raise NotImplementedError(
                "multi-process peers are not ported yet (ROADMAP: the "
                "multi-GPU slice); run one process per peer")
        self.coordinator = True

    @property
    def swarm_enabled(self) -> bool:
        return self.coordinator

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (f"SliceRole(processes={self.n_processes}, "
                f"coordinator={self.coordinator})")
