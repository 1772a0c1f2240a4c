"""Parameter partitioning rules (counterpart of
``dalle_tpu/parallel/sharding.py``).

Megatron-style tensor parallelism for the block matmuls, FSDP sharding of
the remaining large tensors, replication for small ones. Rules are matched
on the parameter's flax path (``params.flax_path``: the port keeps flax's
names and its (in, out) kernel layout, so the JAX rules apply unchanged),
most specific first; the first rule whose pattern is a substring of the
path wins. A spec is a tuple with one mesh axis name, or None, a
dimension (the JAX ``PartitionSpec``'s entries).

Where JAX places a leaf on the mesh, the port keeps this process's shard
of it: :func:`param_shardings` says which (the spec of each leaf, an axis
dropped where it does not divide the dimension, as JAX's does),
:func:`shard_tensor` cuts a whole leaf to the process's shard and
:func:`unshard_tensor` gathers it back, and :func:`shard_train_state`
replaces each process's leaves by its shards. The model computes on the
shards (``models/transformer.py``, ``models/dalle.py``), the optimizer
updates them (``optim/lamb.py``), and checkpoints and the swarm see whole
leaves (``training/checkpoint.py``, ``parallel/multihost.host_global``).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from dalle_tpu_torch.ops.quant import Quantized
from dalle_tpu_torch.parallel.collectives import chunk_of, gather_whole
from dalle_tpu_torch.parallel.mesh import Mesh

Spec = Tuple[Optional[str], ...]

# (path-substring, spec); first match wins. Kernel layouts:
#   q/k/v: (dim, dim)         -> columns (heads) split over tp, rows fsdp
#   out:  (dim, dim)          -> rows (heads) split over tp, cols fsdp
#   wi/gate: (dim, inner)     -> columns over tp
#   wo:   (inner, dim)        -> rows over tp
#   token_emb: (vocab, dim)   -> vocab over tp (tied head contracts over dim)
PARAM_RULES: Tuple[Tuple[str, Spec], ...] = (
    ("attn/q/kernel", ("fsdp", "tp")),
    ("attn/k/kernel", ("fsdp", "tp")),
    ("attn/v/kernel", ("fsdp", "tp")),
    ("attn/out/kernel", ("tp", "fsdp")),
    ("ff/wi/kernel", ("fsdp", "tp")),
    ("ff/gate/kernel", ("fsdp", "tp")),
    ("ff/wo/kernel", ("tp", "fsdp")),
    ("token_emb", ("tp", None)),
    ("text_pos_emb", (None, None)),
    ("img_row_emb", (None, None)),
    ("img_col_emb", (None, None)),
    ("lm_head/kernel", ("fsdp", "tp")),
)


def spec_for_path(path: str) -> Spec:
    for pattern, spec in PARAM_RULES:
        if pattern in path:
            return spec
    return ()  # norms, biases, scalars: replicated


def leaf_spec(path: str, shape: Sequence[int]) -> Spec:
    """The spec of a leaf at flax ``path`` with ``shape``: the rule's,
    shifted right by one for a stacked ``dense_scan`` leaf (one extra
    leading axis of repetitions, unsharded), entries past the leaf's rank
    set to None."""
    spec = spec_for_path(path)
    ndim = len(shape)
    if spec and ndim == len(spec) + 1:
        spec = (None,) + spec
    return tuple(ax if i < ndim else None for i, ax in enumerate(spec))


def _flax_paths(model: nn.Module) -> Dict[str, str]:
    from dalle_tpu_torch.params import flax_path
    return {name: "/".join(("params",) + flax_path(name, model.cfg))
            for name, _ in model.named_parameters()}


def param_specs(model: nn.Module) -> Dict[str, Spec]:
    """The spec of every parameter of ``model`` (a port ``DALLE`` whose
    parameters are whole), keyed by the port's names."""
    paths = _flax_paths(model)
    return {name: leaf_spec(paths[name], p.shape)
            for name, p in model.named_parameters()}


def fit_spec(mesh: Mesh, shape: Sequence[int], spec: Spec) -> Spec:
    """``spec`` with every axis that does not divide its dimension dropped
    (XLA requires even sharding); the other axes stay."""
    out = []
    for i, ax in enumerate(spec):
        size = mesh.shape[ax] if isinstance(ax, str) else 1
        out.append(ax if ax is not None and i < len(shape)
                   and shape[i] % size == 0 else None)
    return tuple(out)


def param_shardings(mesh: Mesh, model: nn.Module) -> Dict[str, Spec]:
    """What each process holds of each parameter: its spec on ``mesh``
    (:func:`fit_spec` of :func:`param_specs`); ``model`` whole."""
    return {name: fit_spec(mesh, model.get_parameter(name).shape, spec)
            for name, spec in param_specs(model).items()}


def moment_spec(mesh: Mesh, moment, spec: Spec):
    """A moment's spec: a dense moment's is its parameter's; a quantized
    one's codes and absmax shard their block axis over ``fsdp`` when it
    divides, else replicate (a ``Quantized`` of specs)."""
    if isinstance(moment, Quantized):
        # the whole moment's block count (``moment`` may be a shard)
        n_blocks = -(-moment.size // moment.codes.shape[1])
        blocks = (("fsdp",) if mesh.fsdp > 1
                  and n_blocks % mesh.fsdp == 0 else ())
        return Quantized(codes=blocks, absmax=blocks, shape=moment.shape,
                         signed=moment.signed)
    return spec


def opt_state_shardings(mesh: Mesh, opt_state, model: nn.Module,
                        pspecs: Optional[Dict[str, Spec]] = None):
    """Specs for the optimizer state, in its structure: the step count
    replicated; each moment per :func:`moment_spec` (dense moments follow
    their parameter; quantized codes and absmax are sharded over ``fsdp``
    on their block axis). Replicating the moments, the largest tensors of
    training, on every process would defeat FSDP."""
    pspecs = pspecs or param_shardings(mesh, model)
    return type(opt_state)(
        (), {n: moment_spec(mesh, m, pspecs[n])
             for n, m in opt_state.mu.items()},
        {n: moment_spec(mesh, m, pspecs[n])
         for n, m in opt_state.nu.items()})


def shard_tensor(t: torch.Tensor, spec: Spec, mesh: Mesh) -> torch.Tensor:
    """This process's shard of the whole leaf ``t`` under ``spec``
    (contiguous; ``t`` itself when nothing is sharded)."""
    for dim, ax in enumerate(spec):
        if ax is not None and mesh.shape[ax] > 1:
            t = chunk_of(t, dim, mesh.shape[ax], mesh.index(ax))
    return t


def unshard_tensor(t: torch.Tensor, spec: Spec, mesh: Mesh) -> torch.Tensor:
    """The whole leaf from each process's shard ``t`` (a collective over
    the leaf's axes: every process of those lines calls it)."""
    return gather_whole(t, [(dim, mesh.group(ax)) for dim, ax in
                            enumerate(spec) if ax is not None])


def whole_shape(shape: Sequence[int], spec: Spec, mesh: Mesh
                ) -> Tuple[int, ...]:
    """The whole leaf's shape from a shard's ``shape`` under ``spec``."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(int(s) * (mesh.shape[a] if a else 1)
                 for s, a in zip(shape, spec))


def shard_moment(m, spec, mesh: Mesh):
    if isinstance(m, Quantized):
        return Quantized(shard_tensor(m.codes, spec.codes, mesh),
                         shard_tensor(m.absmax, spec.absmax, mesh),
                         m.shape, m.signed)
    return shard_tensor(m, spec, mesh)


def unshard_moment(m, spec, mesh: Mesh):
    if isinstance(m, Quantized):
        return Quantized(unshard_tensor(m.codes, spec.codes, mesh),
                         unshard_tensor(m.absmax, spec.absmax, mesh),
                         m.shape, m.signed)
    return unshard_tensor(m, spec, mesh)


@torch.no_grad()
def shard_train_state(mesh: Mesh, state):
    """Place a TrainState on the mesh: each process keeps its shard of
    every parameter (per :data:`PARAM_RULES`) and of every moment
    (quantized codes and absmax over ``fsdp``), in place; the step count
    stays. The model must have been built with this mesh
    (``DALLE(cfg, mesh=mesh)``), whose forward computes on the shards.
    The single placement of the dry run, the chip smoke and the
    trainer."""
    model = state.model
    if not mesh.sharded:
        return state
    if getattr(model, "mesh", None) != mesh:
        raise ValueError("shard_train_state: the model was built for "
                         f"{getattr(model, 'mesh', None)}, not {mesh}")
    if model.sharded:
        raise ValueError("shard_train_state: the state is sharded already")
    pspecs = model.shard_specs
    mspecs = opt_state_shardings(mesh, state.opt_state, model, pspecs)
    for name, p in model.named_parameters():
        p.data = shard_tensor(p.data, pspecs[name], mesh)
    opt = state.opt_state
    state.opt_state = type(opt)(
        opt.count,
        {n: shard_moment(m, mspecs.mu[n], mesh) for n, m in opt.mu.items()},
        {n: shard_moment(m, mspecs.nu[n], mesh) for n, m in opt.nu.items()})
    model.mark_sharded()
    return state


def state_leaf_specs(model: nn.Module, opt_state) -> list:
    """The spec of each leaf of ``(model, opt_state)`` in
    ``params.jax_state_leaves`` order (the count replicated), for
    ``multihost.host_global``."""
    from dalle_tpu_torch.params import jax_state_leaves
    mesh, specs = model.mesh, model.shard_specs
    out = []
    for leaf in jax_state_leaves(model.cfg, opt_state):
        if leaf[0] == "param":
            out.append(specs[leaf[1]])
        elif leaf[0] == "count":
            out.append(())
        else:
            m = getattr(opt_state, leaf[0])[leaf[1]]
            spec = moment_spec(mesh, m, specs[leaf[1]])
            out.append(spec if leaf[2] == "dense" else getattr(spec, leaf[2]))
    return out
