"""On-disk checkpointing, backups, NaN rollback, and resume (counterpart of
``dalle_tpu/training/checkpoint.py``).

Capability parity with the reference's recovery stack
(``callback.py:33-127`` of learning-at-home/dalle):

- periodic local checkpoint of model + optimizer state + local epoch
  (``state.zip`` backups every ``backup_every_steps``,
  ``callback.py:102-113``);
- a finite-params sweep every step with automatic restore from the latest
  backup on NaN/Inf (``callback.py:95-100,50-54``);
- resume-from-latest on start (``run_trainer.py:55-56``, ``task.py:88-93``).

**The file format is the JAX trainer's**, so the port resumes from
checkpoints that ``dalle_tpu.training.checkpoint.CheckpointManager``
wrote, and writes files of the same layout: a MessagePack header
``{"epoch": N}``, then flax's MessagePack state dict of the train state,
``{"step", "params": {"params": <flax tree>}, "opt_state": {"count",
"mu", "nu"}}``, whose arrays are extension type 1 (``[shape, dtype name,
C-order bytes]``; arrays above 1 GiB split into flax's chunked form on
read). A quantized moment is ``{"codes", "absmax"}``; its shape is the
parameter's and its codebook is signed for ``mu``, unsigned for ``nu``.
Parameters come into the port's modules through
:func:`~dalle_tpu_torch.params.params_from_jax` and moments through
:func:`~dalle_tpu_torch.params.opt_state_from_jax`. ``bfloat16`` arrays
are read as their uint16 bits viewed as ``torch.bfloat16``: numpy is
never asked for a bfloat16 dtype.

The port's train state is updated in place by the apply, so an async
save first takes a device-side copy of every tensor (on the training
thread, ordered after the apply that produced it); the writer thread
serializes the copy.

A sharded model (``parallel/sharding.py``) is saved as whole leaves in the
same format: :func:`state_to_state_dict` gathers every leaf over the mesh
(a collective: every process of the peer calls it, and the caller writes
the file from one), and :func:`load_state_dict_into` gives each process
its shards of the whole leaves it reads.
"""

from __future__ import annotations

import logging
import os
import re
import tempfile
import threading
import time
from types import SimpleNamespace
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from dalle_tpu_torch.params import (flax_path, opt_state_from_jax,
                                    params_from_jax, placed_like)
from dalle_tpu_torch.utils import msgpack

logger = logging.getLogger(__name__)

_CKPT_RE = re.compile(r"^ckpt_(\d+)\.msgpack$")

#: flax's MessagePack extension codes
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3

_DTYPES = {
    "float32": torch.float32, "float64": torch.float64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int8": torch.int8, "int16": torch.int16, "int32": torch.int32,
    "int64": torch.int64, "uint8": torch.uint8, "bool": torch.bool,
}
_NAMES = {v: k for k, v in _DTYPES.items()}


def params_are_finite(model: torch.nn.Module) -> bool:
    """All-finite sweep over the floating parameters (reference
    ``callback.py:95-100``): one reduction on the device, one host read."""
    oks = [torch.isfinite(p).all() for p in model.parameters()
           if p.is_floating_point()]
    return bool(torch.stack(oks).all().item()) if oks else True


# -- the array codec (flax's extension type 1) ----------------------------

def _tensor_bytes(t: torch.Tensor) -> bytes:
    t = t.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().tobytes()


def _pack_tensor(t: torch.Tensor) -> msgpack.ExtType:
    if t.dtype not in _NAMES:
        raise TypeError(f"cannot serialize a {t.dtype} tensor")
    payload = msgpack.packb([list(t.shape), _NAMES[t.dtype],
                             _tensor_bytes(t)])
    return msgpack.ExtType(_EXT_NDARRAY, payload)


def _unpack_tensor(code: int, data: bytes):
    if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
        return msgpack.ExtType(code, data)
    shape, name, buf = msgpack.unpackb(data)
    if isinstance(name, bytes):
        name = name.decode()
    if name not in _DTYPES:
        raise ValueError(f"unsupported array dtype {name!r}")
    dtype = _DTYPES[name]
    raw = torch.int16 if dtype == torch.bfloat16 else dtype
    if len(buf) == 0:
        t = torch.empty(0, dtype=raw)
    else:
        t = torch.frombuffer(bytearray(buf), dtype=raw)
    t = t.reshape([int(d) for d in shape])
    return t.view(torch.bfloat16) if dtype == torch.bfloat16 else t


def _unchunk(tree):
    """flax's chunked form of an array above 1 GiB, back to one tensor."""
    if isinstance(tree, dict):
        if "__msgpack_chunked_array__" in tree:
            shape = [int(tree["shape"][str(i)])
                     for i in range(len(tree["shape"]))]
            chunks = [tree["chunks"][str(i)]
                      for i in range(len(tree["chunks"]))]
            return torch.cat([c.reshape(-1) for c in chunks]).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def _sorted_tree(tree):
    """Map keys sorted at every level (flax serializes a tree-mapped copy,
    whose keys are sorted)."""
    if isinstance(tree, dict):
        return {k: _sorted_tree(tree[k]) for k in sorted(tree)}
    return tree


def pack_state_dict(state_dict: Dict) -> bytes:
    """flax's ``msgpack_serialize`` bytes of a state dict with tensor
    leaves."""
    return msgpack.packb(_sorted_tree(state_dict), default=_pack_tensor)


def serialize_state_dict(state_dict: Dict, epoch: int) -> bytes:
    """The checkpoint file's bytes: the epoch header, then the state dict
    (tensor leaves as flax arrays)."""
    return msgpack.packb({"epoch": int(epoch)}) + pack_state_dict(state_dict)


def _read_header(path: str) -> Optional[int]:
    try:
        with open(path, "rb") as f:
            return int(msgpack.Unpacker(f).unpack()["epoch"])
    # header PEEK over every restore candidate: None just excludes the
    # file; the restore of the winning candidate logs its own failure
    # graftlint: disable=silent-except
    except Exception:  # noqa: BLE001 - corrupt/missing file
        return None


def read_checkpoint(path: str) -> Tuple[int, Dict]:
    """``(epoch, state_dict)`` of a checkpoint file, tensors on the CPU."""
    with open(path, "rb") as f:
        blob = f.read()
    unpacker = msgpack.Unpacker()
    unpacker.feed(blob[:4096])          # the header only
    epoch = int(unpacker.unpack()["epoch"])
    body = memoryview(blob)[unpacker.tell():]
    state_dict = msgpack.unpackb(body, ext_hook=_unpack_tensor)
    return epoch, _unchunk(state_dict)


# -- train state <-> state dict --------------------------------------------

def _nest(flat: Dict[Tuple[str, ...], Any]) -> Dict:
    out: Dict = {}
    for path, leaf in flat.items():
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return out


def _whole(model, opt):
    """The whole parameters and moments of a sharded model's state
    (gathered over its mesh), or its own tensors."""
    params = {n: p.detach() for n, p in model.named_parameters()}
    mesh = getattr(model, "mesh", None)
    if mesh is None:
        return params, opt.mu, opt.nu
    from dalle_tpu_torch.parallel.sharding import (moment_spec,
                                                   unshard_moment,
                                                   unshard_tensor)
    specs = model.shard_specs

    def moments(tree):
        return {n: unshard_moment(m, moment_spec(mesh, m, specs[n]), mesh)
                for n, m in tree.items()}

    return ({n: unshard_tensor(p, specs[n], mesh) for n, p in params.items()},
            moments(opt.mu), moments(opt.nu))


def _moment_tree(moments: Dict, cfg) -> Dict:
    flat = {}
    for name, m in moments.items():
        path = ("params",) + flax_path(name, cfg)
        flat[path] = ({"codes": m.codes, "absmax": m.absmax}
                      if hasattr(m, "codes") else m)
    return _nest(flat)


def state_to_state_dict(state) -> Dict:
    """The flax state dict of a ``training.steps.TrainState`` (live tensor
    leaves)."""
    model, opt = state.model, state.opt_state
    cfg = model.cfg
    whole, mu, nu = _whole(model, opt)
    params = _nest({("params",) + flax_path(n, cfg): p
                    for n, p in whole.items()})
    return {
        "step": torch.tensor(int(state.step), dtype=torch.int32),
        "params": params,
        "opt_state": {
            "count": torch.tensor(int(opt.count), dtype=torch.int32),
            "mu": _moment_tree(mu, cfg),
            "nu": _moment_tree(nu, cfg),
        },
    }


def _quantized_leaves(tree: Dict, params: Dict, signed: bool) -> Dict:
    """A moment tree with each ``{"codes", "absmax"}`` node turned into a
    record carrying the parameter's shape and the codebook's sign (what
    ``opt_state_from_jax`` reads)."""
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict) and set(val) == {"codes", "absmax"}:
            out[key] = SimpleNamespace(codes=val["codes"],
                                       absmax=val["absmax"],
                                       shape=tuple(params[key].shape),
                                       signed=signed)
        elif isinstance(val, dict):
            out[key] = _quantized_leaves(val, params[key], signed)
        else:
            out[key] = val
    return out


@torch.no_grad()
def load_state_dict_into(state, state_dict: Dict, params_only: bool = False):
    """Adopt a checkpoint's state dict into ``state`` (a TrainState): the
    parameters are copied into its model in place (each cast to its
    parameter's dtype and device); unless ``params_only``, the optimizer
    state is replaced and the step set. Everything is converted and
    checked before anything is written, so a mismatched file leaves
    ``state`` as it was. Returns ``state``."""
    model = state.model
    cfg = model.cfg
    loaded = params_from_jax(state_dict["params"], cfg)
    new_opt = None
    if not params_only:
        opt_sd = state_dict["opt_state"]
        root = state_dict["params"]["params"]
        jax_like = SimpleNamespace(
            count=opt_sd["count"],
            mu=_quantized_leaves(opt_sd["mu"], {"params": root}, True),
            nu=_quantized_leaves(opt_sd["nu"], {"params": root}, False))
        port = _shards(model, opt_state_from_jax(jax_like, cfg))
        new_opt = _moments_like(port, state.opt_state)
    src = dict(loaded.named_parameters())
    mesh = getattr(model, "mesh", None)
    for name, p in model.named_parameters():
        whole = src[name]
        if mesh is not None:
            from dalle_tpu_torch.parallel.sharding import shard_tensor
            whole = shard_tensor(whole, model.shard_specs[name], mesh)
        p.copy_(whole.to(device=p.device, dtype=p.dtype))
    if new_opt is not None:
        state.opt_state = new_opt
        state.step = int(np.asarray(state_dict["step"]))
    return state


def _shards(model, opt):
    """A loaded (whole) optimizer state cut to this process's shards when
    ``model`` is sharded."""
    mesh = getattr(model, "mesh", None)
    if mesh is None:
        return opt
    from dalle_tpu_torch.parallel.sharding import moment_spec, shard_moment
    specs = model.shard_specs

    def cut(tree):
        return {n: shard_moment(m, moment_spec(mesh, m, specs[n]), mesh)
                for n, m in tree.items()}

    return type(opt)(opt.count, cut(opt.mu), cut(opt.nu))


def _moments_like(src, like):
    """The loaded optimizer state in the type of ``like`` (the live state),
    each tensor placed as the live one (its device; pinned host memory for
    an offloaded state, ``params.placed_like``); raises when a moment's
    kind (quantized or dense) differs from the live optimizer's."""
    from dalle_tpu_torch.ops.quant import Quantized

    def move(m, ref):
        if isinstance(ref, Quantized) != isinstance(m, Quantized):
            raise ValueError("checkpoint moments do not match the "
                             "optimizer (state_bits / min_8bit_size)")
        if isinstance(m, Quantized):
            return Quantized(placed_like(m.codes, ref.codes),
                             placed_like(m.absmax, ref.absmax), m.shape,
                             m.signed)
        return placed_like(m, ref)

    mu = {n: move(src.mu[n], like.mu[n]) for n in like.mu}
    nu = {n: move(src.nu[n], like.nu[n]) for n in like.nu}
    return type(like)(int(src.count), mu, nu)


def _snapshot(state) -> Dict:
    """A device-side copy of the state dict: the async writer's
    in-place-update-proof snapshot."""
    def clone(tree):
        if isinstance(tree, dict):
            return {k: clone(v) for k, v in tree.items()}
        return tree.clone()
    return clone(state_to_state_dict(state))


def _write_atomic(path: str, blob: bytes) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(blob)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


class _AsyncWriter:
    """One background thread serializing and writing checkpoints off the
    step path (the JAX package's writer, unchanged in behaviour).

    At most one write per kind ('ckpt'/'backup') is queued behind the one
    in flight; a newer request of the same kind replaces the queued one
    (latest-wins — intermediate backups are droppable by design). A
    NUMBERED checkpoint is different: ``save()`` returned its path, so
    ``submit`` first waits (bounded, ``SUPERSEDE_FLUSH_S``) for a queued
    ckpt to drain to the worker rather than dropping it. Write errors are
    logged and surfaced via ``last_error``; training never dies on a
    checkpoint.
    """

    SUPERSEDE_FLUSH_S = 300.0

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        # FIFO of (kind, fn, label): submission order IS epoch order
        self._queued: list = []
        self._in_flight = 0
        self._stop = False
        self.last_error: Optional[BaseException] = None
        self._thread = threading.Thread(
            target=self._run, name="ckpt-writer", daemon=True)
        self._thread.start()

    def submit(self, kind: str, fn, label: str) -> None:
        with self._lock:
            if kind == "ckpt" and any(k == kind
                                      for k, _f, _l in self._queued):
                deadline = time.monotonic() + self.SUPERSEDE_FLUSH_S
                while any(k == kind for k, _f, _l in self._queued):
                    left = deadline - time.monotonic()
                    if left <= 0:
                        break
                    self._work.wait(left)
            for i, (k, _f, lbl) in enumerate(self._queued):
                if k == kind:
                    log = (logger.warning if kind == "ckpt"
                           else logger.info)
                    log("checkpoint writer busy: superseding queued "
                        "%s with %s (the superseded file will never "
                        "be written)", lbl, label)
                    del self._queued[i]
                    break
            self._queued.append((kind, fn, label))
            self._work.notify()

    def flush(self, timeout: Optional[float] = None) -> None:
        """Block until every queued/in-flight write has landed."""
        deadline = (time.monotonic() + timeout) if timeout is not None \
            else None
        with self._lock:
            while self._queued or self._in_flight:
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise TimeoutError("checkpoint flush timed out")
                self._work.wait(remaining)

    def close(self, flush_timeout: Optional[float] = 300.0) -> None:
        """Drain and stop the writer; a wedged filesystem is abandoned
        after ``flush_timeout`` with a warning."""
        drained = True
        try:
            self.flush(timeout=flush_timeout)
        except TimeoutError:
            drained = False
            with self._lock:
                abandoned = ([lbl for _k, _f, lbl in self._queued]
                             + ([f"{self._in_flight} in flight"]
                                if self._in_flight else []))
                self._queued.clear()
            logger.warning(
                "checkpoint writer did not drain within %.0fs; shutting "
                "down without it (abandoned: %s)", flush_timeout,
                ", ".join(abandoned) or "none")
        with self._lock:
            self._stop = True
            self._work.notify()
        self._thread.join(timeout=10 if drained else 0.5)

    def _run(self) -> None:
        while True:
            with self._lock:
                while not self._queued and not self._stop:
                    self._work.wait()
                if self._stop and not self._queued:
                    return
                _kind, fn, label = self._queued.pop(0)
                self._in_flight += 1
            try:
                fn()
            except BaseException as e:  # noqa: BLE001 - logged, not fatal
                self.last_error = e
                logger.warning("async checkpoint write failed (%s)",
                               label, exc_info=True)
            finally:
                with self._lock:
                    self._in_flight -= 1
                    self._work.notify_all()


class CheckpointManager:
    """Numbered checkpoints + a rolling backup in one directory.

    ``async_writes`` (default) moves serialization + disk IO to a
    background thread: ``save``/``save_backup`` return after taking a
    device copy of the state, and every restore path flushes pending
    writes first so recovery always sees the freshest state.
    """

    def __init__(self, directory: str, keep: int = 3,
                 async_writes: bool = True, write: bool = True):
        self.directory = directory
        self.keep = max(1, keep)  # 0 would disable pruning entirely
        # a follower of a sharded peer reads the directory, and takes part
        # in each save's gather (state_to_state_dict) without writing
        self.write = write
        self._writer = _AsyncWriter() if async_writes and write else None
        os.makedirs(directory, exist_ok=True)

    # -- paths ------------------------------------------------------------

    def _ckpt_path(self, epoch: int) -> str:
        return os.path.join(self.directory, f"ckpt_{epoch:08d}.msgpack")

    @property
    def backup_path(self) -> str:
        return os.path.join(self.directory, "backup.msgpack")

    def checkpoints(self) -> List[Tuple[int, str]]:
        out = []
        for name in os.listdir(self.directory):
            m = _CKPT_RE.match(name)
            if m:
                out.append((int(m.group(1)),
                            os.path.join(self.directory, name)))
        return sorted(out)

    # -- save -------------------------------------------------------------

    def _state_dict(self, state) -> Dict:
        # async: a device copy now, so the apply that follows cannot
        # change what the writer serializes
        return (_snapshot(state) if self._writer is not None
                else state_to_state_dict(state))

    def save(self, state, epoch: int, backup: bool = False) -> str:
        """Numbered checkpoint; ``backup=True`` also refreshes the rolling
        backup from the same serialized bytes. Async by default: returns
        the DESTINATION path, the bytes land later (:meth:`flush`)."""
        path = self._ckpt_path(epoch)
        sd = self._state_dict(state)
        if not self.write:
            return path

        def write() -> None:
            blob = serialize_state_dict(sd, epoch)
            _write_atomic(path, blob)
            if backup:
                _write_atomic(self.backup_path, blob)
            logger.info("checkpoint saved: %s", path)
            for _old_epoch, old_path in self.checkpoints()[: -self.keep]:
                os.unlink(old_path)

        if self._writer is not None:
            self._writer.submit("ckpt", write, f"ckpt_{epoch}")
        else:
            write()
        return path

    def save_backup(self, state, epoch: int) -> str:
        """The reference's ``state.zip`` rolling backup
        (``callback.py:102-113``). Async by default, like :meth:`save`."""
        sd = self._state_dict(state)
        if not self.write:
            return self.backup_path

        def write() -> None:
            _write_atomic(self.backup_path, serialize_state_dict(sd, epoch))
            logger.info("backup saved: %s (epoch %d)",
                        self.backup_path, epoch)

        if self._writer is not None:
            self._writer.submit("backup", write, f"backup@{epoch}")
        else:
            write()
        return self.backup_path

    def flush(self) -> None:
        """Wait for queued async writes to land (no-op when sync)."""
        if self._writer is not None:
            self._writer.flush()

    def close(self, flush_timeout: Optional[float] = 300.0) -> None:
        if self._writer is not None:
            self._writer.close(flush_timeout=flush_timeout)

    @property
    def last_write_error(self) -> Optional[BaseException]:
        return self._writer.last_error if self._writer is not None else None

    # -- restore ----------------------------------------------------------

    def _restore_file(self, path: str, template,
                      params_only: bool = False
                      ) -> Optional[Tuple[Any, int]]:
        try:
            epoch, state_dict = read_checkpoint(path)
            return load_state_dict_into(template, state_dict,
                                        params_only=params_only), epoch
        except Exception:  # noqa: BLE001 - corrupt/partial/mismatched file
            logger.warning("failed to restore %s", path, exc_info=True)
            return None

    def _candidates(self) -> List[Tuple[int, str]]:
        """(epoch, path) for every readable candidate, freshest first,
        using the peekable header (no full deserialization)."""
        out = [(e, p) for e, p in self.checkpoints()]
        backup_epoch = _read_header(self.backup_path) \
            if os.path.exists(self.backup_path) else None
        if backup_epoch is not None:
            out.append((backup_epoch, self.backup_path))
        return sorted(out, reverse=True)

    def restore_latest(self, template) -> Optional[Tuple[Any, int]]:
        """Freshest of numbered checkpoints and the backup, loaded into
        ``template`` (a TrainState), or None."""
        self.flush()  # recovery must see writes still in the async queue
        for _epoch, path in self._candidates():
            result = self._restore_file(path, template)
            if result is not None:
                return result
        return None

    def restore_backup(self, template) -> Optional[Tuple[Any, int]]:
        self.flush()  # the freshest (pre-corruption) backup may be queued
        if not os.path.exists(self.backup_path):
            return None
        return self._restore_file(self.backup_path, template)

    def restore_params_latest(self, model: torch.nn.Module
                              ) -> Optional[Tuple[torch.nn.Module, int]]:
        """Load only the parameters of the freshest candidate (numbered or
        backup) into ``model``: inference needs no optimizer state, and
        this reads checkpoints whatever optimizer flags trained them.
        ``(model, epoch)``, or None."""
        self.flush()
        holder = SimpleNamespace(model=model)
        for _epoch, path in self._candidates():
            result = self._restore_file(path, holder, params_only=True)
            if result is not None:
                return model, result[1]
        return None
