"""The peer's device mesh (counterpart of ``dalle_tpu/parallel/mesh.py``).

The JAX package lays a peer's devices out on a ``(dp, fsdp, tp, sp)``
mesh: ``dp`` (data), ``fsdp`` (data and parameter sharding), ``tp``
(tensor) and ``sp`` (sequence). The port drives one device a process, and
its processes form the peer (``parallel/multihost.py``), so the mesh's
devices are the peer's processes: rank ``r`` sits at
``np.arange(n).reshape(dp, fsdp, tp, sp)``'s coordinates of ``r``, as a JAX
device sits in its mesh's device array. ``dp=-1`` absorbs the processes
the other axes leave, and a layout that does not cover them raises the JAX
package's ``ValueError``.

A sharded mesh (``fsdp``, ``tp`` or ``sp`` above 1) builds one ``gloo``
sub-group a line of each axis, and one a line of the batch axes ``(dp,
fsdp)``; every process creates every group, in the same order
(``torch.distributed.new_group`` asks that of all of them). A mesh of one
process, or a data-parallel mesh (only ``dp`` above 1, which the
gradient mean over the processes serves,
``multihost.mean_over_processes``), builds no group.

:func:`batch_sharding` and :func:`replicated` are the counterparts of the
JAX package's shardings of the same names: they give a process its rows of
a batch (those of its ``(dp, fsdp)`` coordinate, the same for every
``tp``/``sp`` rank), or everything.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from dalle_tpu_torch.parallel.multihost import (check_backend, name_group,
                                                process_count, process_index)

AXES = ("dp", "fsdp", "tp", "sp")
# the batch is sharded over every data-like axis
BATCH_AXES = ("dp", "fsdp")


@dataclass(frozen=True)
class Mesh:
    """The resolved axis sizes, this process's rank, and (on a sharded
    mesh of several processes) its sub-groups: ``groups[axis]`` for each
    axis in :data:`AXES` and ``"batch"``, None where the line has one
    rank."""

    dp: int
    fsdp: int = 1
    tp: int = 1
    sp: int = 1
    rank: int = 0
    groups: Optional[Dict[str, object]] = field(default=None, compare=False,
                                                repr=False)

    @property
    def shape(self) -> Dict[str, int]:
        return {axis: getattr(self, axis) for axis in AXES}

    @property
    def size(self) -> int:
        return self.dp * self.fsdp * self.tp * self.sp

    @property
    def sharded(self) -> bool:
        """Whether parameters or sequences are split across processes."""
        return self.fsdp * self.tp * self.sp > 1

    def coords(self, rank: Optional[int] = None) -> Dict[str, int]:
        """The axis indices of ``rank`` (default: this process)."""
        idx = np.unravel_index(self.rank if rank is None else rank,
                               (self.dp, self.fsdp, self.tp, self.sp))
        return dict(zip(AXES, (int(i) for i in idx)))

    def index(self, axis: str) -> int:
        """This process's index along ``axis`` (or ``"batch"``)."""
        c = self.coords()
        if axis == "batch":
            return c["dp"] * self.fsdp + c["fsdp"]
        return c[axis]

    def axis_size(self, axis: str) -> int:
        return self.dp * self.fsdp if axis == "batch" else \
            self.shape[axis]

    def group(self, axis: str):
        """The sub-group of this process's line along ``axis`` (or
        ``"batch"``); None where that line is this process alone."""
        if self.axis_size(axis) == 1:
            return None
        if not self.groups:
            raise RuntimeError(
                f"mesh {self.dp}x{self.fsdp}x{self.tp}x{self.sp} has no "
                "process groups: build it with make_mesh() in every "
                "process of an initialised gloo group")
        return self.groups[axis]


def _line_ranks(shape: Tuple[int, ...], axes: Sequence[int]
                ) -> list:
    """The rank lists of every line of ``np.arange(n).reshape(shape)``
    along ``axes`` (the other axes fixed), in a fixed order."""
    ids = np.arange(int(np.prod(shape))).reshape(shape)
    keep = [a for a in range(len(shape)) if a not in axes]
    moved = np.transpose(ids, keep + list(axes))
    lines = moved.reshape(-1, int(np.prod([shape[a] for a in axes])))
    return [[int(r) for r in line] for line in lines]


def _build_groups(sizes: Tuple[int, int, int, int]) -> Dict[str, object]:
    import torch.distributed as dist
    me = process_index()
    groups: Dict[str, object] = {}
    for name, axes in (("dp", (0,)), ("fsdp", (1,)), ("tp", (2,)),
                       ("sp", (3,)), ("batch", (0, 1))):
        if int(np.prod([sizes[a] for a in axes])) == 1:
            continue
        for ranks in _line_ranks(sizes, axes):
            group = dist.new_group(ranks, backend="gloo")
            if me in ranks:
                groups[name] = group
                name_group(group, name)
    return groups


def make_mesh(dp: int = -1, fsdp: int = 1, tp: int = 1, sp: int = 1,
              n_devices: Optional[int] = None) -> Mesh:
    """The ``(dp, fsdp, tp, sp)`` mesh over ``n_devices`` devices (default:
    the peer's processes, one device each, with their sub-groups when the
    mesh is sharded). ``n_devices`` given: the layout alone (no groups,
    rank 0), as the sharding rules need it."""
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
    if n_devices is not None or n == 1 or rest == 1:
        return Mesh(dp, fsdp, tp, sp)
    check_backend()
    return Mesh(dp, fsdp, tp, sp, rank=process_index(),
                groups=_build_groups((dp, fsdp, tp, sp)))


def batch_sharding(mesh: Mesh, batch: Dict[str, torch.Tensor],
                   accum_steps: int = 1) -> Dict[str, torch.Tensor]:
    """This process's rows of a global batch: of each of the
    ``accum_steps`` micro-batches, the rows of its ``(dp, fsdp)`` index
    (``P(("dp", "fsdp"))``); every ``tp``/``sp`` rank of that index gets
    the same rows."""
    n, i = mesh.axis_size("batch"), mesh.index("batch")
    if n == 1:
        return dict(batch)
    rows = next(iter(batch.values())).shape[0]
    if rows % (n * accum_steps):
        raise ValueError(f"batch {rows} not divisible by dp*fsdp={n} "
                         f"x {accum_steps} micro-batches")
    micro, per = rows // accum_steps, rows // accum_steps // n
    idx = torch.cat([torch.arange(a * micro + i * per,
                                  a * micro + (i + 1) * per)
                     for a in range(accum_steps)])
    return {k: v[idx.to(v.device)] for k, v in batch.items()}


def replicated(mesh: Mesh, value):
    """``value`` whole on every process (``P()``)."""
    del mesh
    return value
