"""Multi-process trainer peers as one swarm peer (counterpart of
``dalle_tpu/parallel/multihost.py``).

In the JAX package a multi-host slice presents as one swarm peer: process
0, the coordinator, opens the DHT, tracks swarm progress, matchmakes and
runs the butterfly all-reduce; the followers run the same grad step and
learn the coordinator's decisions and the averaged gradients through
host-level broadcasts, so every process applies the identical update and
the parameters stay bit-identical across the slice.

The port does the same over a ``torch.distributed`` group that the caller
has initialised before it builds the ``TrainingTask`` (the JAX CLI never
calls ``jax.distributed.initialize`` either): rank 0 is the coordinator.
The group's backend is ``gloo``, on every machine: the broadcasts carry
host arrays, as the JAX package's ``multihost_utils`` does, and the
processes of a slice may share one GPU. A group of any other backend is
refused (``NCCL`` waits for a machine with more than one card). Each
process drives one device. On a data-parallel slice (``dp``,
``parallel/mesh.py``) each trains on its rows of the slice's batch, and
:func:`mean_over_processes` makes each grad step's gradients their mean
over the processes, which is what the JAX grad step over the global mesh
gives. On a sharded mesh (``fsdp``, ``tp``, ``sp``) each process holds its
shards (``parallel/sharding.py``) and :func:`host_global` gathers them.

Single-process runs (no group, or a group of one) take none of these
paths: every helper is a passthrough. The broadcasts count their bytes
and seconds in ``collectives.TRAFFIC`` (kind ``"broadcast"``).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

BACKEND = "gloo"

#: kind -> [calls, bytes this rank sent, seconds] of the peer's host
#: collectives since :func:`reset_traffic` (``collectives.TRAFFIC``)
TRAFFIC: Dict[str, List[float]] = {}


#: the same by the mesh axis whose line carried the collective (the
#: groups ``parallel/mesh.py`` names, :func:`name_group`; the peer's
#: broadcasts over all its processes are not in it)
AXIS_TRAFFIC: Dict[str, List[float]] = {}
_AXES: Dict[int, str] = {}


def reset_traffic() -> None:
    TRAFFIC.clear()
    AXIS_TRAFFIC.clear()


def name_group(group, axis: str) -> None:
    """Count the collectives over ``group`` under ``axis`` in
    :data:`AXIS_TRAFFIC`."""
    _AXES[id(group)] = axis


def count(kind: str, host: torch.Tensor, t0: float, group=None) -> None:
    """One collective's call, the bytes of ``host`` and the seconds since
    ``t0`` in :data:`TRAFFIC` (and, over a named ``group``, in
    :data:`AXIS_TRAFFIC`)."""
    seconds = time.perf_counter() - t0
    rows = [TRAFFIC.setdefault(kind, [0, 0, 0.0])]
    if id(group) in _AXES:
        rows.append(AXIS_TRAFFIC.setdefault(_AXES[id(group)], [0, 0, 0.0]))
    for row in rows:
        row[0] += 1
        row[1] += host.numel() * host.element_size()
        row[2] += seconds


def _dist():
    import torch.distributed as dist
    return dist


def process_count() -> int:
    """The processes of this peer: the size of the initialised
    ``torch.distributed`` group, else 1."""
    dist = _dist()
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def process_index() -> int:
    """This process's rank in the group (0 without one)."""
    return _dist().get_rank() if process_count() > 1 else 0


def check_backend() -> None:
    """Raise unless the group of a multi-process peer is ``gloo``."""
    if process_count() > 1:
        backend = _dist().get_backend()
        if backend != BACKEND:
            raise NotImplementedError(
                f"multi-process peers run over a {BACKEND!r} group; "
                f"backend {backend!r} waits for a machine with more than "
                "one card")


def is_coordinator() -> bool:
    """True on the process that speaks the swarm protocol for this
    peer."""
    return process_index() == 0


def broadcast_decision(value: int) -> int:
    """Broadcast a small integer decision from the coordinator to every
    process (followers pass any value; the coordinator's wins). A
    passthrough for one process."""
    if process_count() == 1:
        return int(value)
    t0 = time.perf_counter()
    t = torch.tensor([int(value)], dtype=torch.int64)
    _dist().broadcast(t, src=0)
    count("broadcast", t, t0)
    return int(t[0])


def all_processes(flag: bool) -> bool:
    """Whether ``flag`` holds on every process of the peer (a collective
    every process calls). A passthrough for one process."""
    if process_count() == 1:
        return bool(flag)
    t = torch.tensor([1 if flag else 0], dtype=torch.int64)
    _dist().all_reduce(t, op=_dist().ReduceOp.MIN)
    return bool(t[0])


def broadcast_arrays(arrays: Optional[Sequence[np.ndarray]],
                     like: Sequence[np.ndarray]) -> List[np.ndarray]:
    """Broadcast a list of host arrays from the coordinator, dtypes kept.

    Followers pass ``arrays=None`` and supply ``like`` (the same shapes
    and dtypes) as the template. The arrays cross as one byte buffer. A
    passthrough for one process (returns ``arrays``, or ``like`` without
    them)."""
    if process_count() == 1:
        return list(arrays if arrays is not None else like)
    t0 = time.perf_counter()
    src = [np.ascontiguousarray(a) for a in
           (arrays if arrays is not None else like)]
    sizes = [a.nbytes for a in src]
    if arrays is not None:
        buf = torch.from_numpy(np.concatenate(
            [a.reshape(-1).view(np.uint8) for a in src]
            or [np.zeros(0, np.uint8)]))
    else:
        buf = torch.empty(sum(sizes), dtype=torch.uint8)
    _dist().broadcast(buf, src=0)
    count("broadcast", buf, t0)
    raw = buf.numpy()
    out, offset = [], 0
    for a, size in zip(src, sizes):
        out.append(raw[offset:offset + size].view(a.dtype)
                   .reshape(a.shape).copy())
        offset += size
    return out


def mean_over_processes(tensors: Sequence[torch.Tensor]
                        ) -> List[torch.Tensor]:
    """Each tensor's mean over the peer's processes, in f32 on its device:
    one ``gloo`` all-reduce (a sum, then the division by the process
    count) of their flat concatenation through host memory, so every
    process ends with the same bits. A passthrough for one process."""
    n = process_count()
    if n == 1:
        return list(tensors)
    device = tensors[0].device
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    host = torch.empty(flat.shape, dtype=torch.float32,
                       pin_memory=device.type == "cuda")
    host.copy_(flat)
    del flat
    _dist().all_reduce(host)
    host.div_(n)
    flat = host.to(device)
    out, offset = [], 0
    for t in tensors:
        out.append(flat[offset:offset + t.numel()].view(t.shape))
        offset += t.numel()
    return out


def host_global(leaves: Sequence[torch.Tensor], specs=None,
                mesh=None) -> List[np.ndarray]:
    """Host numpy copies of each leaf's global value: a local copy, or on
    a sharded ``mesh`` (``specs``: each leaf's spec,
    ``parallel/sharding.py``) the leaf gathered whole over the mesh, a
    collective that every process of the peer calls in the same order."""
    from dalle_tpu_torch.swarm.device_codec import to_host
    if mesh is None or not mesh.sharded:
        return [to_host(t) for t in leaves]
    from dalle_tpu_torch.parallel.sharding import unshard_tensor
    return [to_host(unshard_tensor(t, spec, mesh))
            for t, spec in zip(leaves, specs)]


def sync() -> None:
    """Barrier across the peer's processes (around checkpoint writes). A
    no-op for one process."""
    if process_count() > 1:
        _dist().barrier()


class SliceRole:
    """This process's role in its peer, resolved once: the coordinator
    (rank 0) speaks the swarm protocol (``swarm_enabled``); the followers
    learn its decisions through the broadcasts above."""

    def __init__(self) -> None:
        check_backend()
        self.n_processes = process_count()
        self.coordinator = is_coordinator()

    @property
    def swarm_enabled(self) -> bool:
        return self.coordinator

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (f"SliceRole(processes={self.n_processes}, "
                f"coordinator={self.coordinator})")
