"""Transformer stack with the weight-sharing schedule (counterpart of
``dalle_tpu/models/transformer.py``).

Parameters are named as in the flax tree (``attn/q/kernel``,
``ff/wi/bias``, ``attn_norm/scale`` ...) and kept in flax's (in, out)
kernel layout, so ``params.py`` maps one tree onto the other by name and the
GEGLU kernel takes ``Wi`` as (d, K) as the TPU kernel does. Blocks that
share an id are one module; the depth is a Python loop over
``cfg.layer_schedule()`` (no scan).

A dense model that the JAX package stacks (``cfg.dense_scan_reps() > 0``,
its ``dense_scan`` layout) holds one module a position of the attention-type
group, ``block_{u}`` for ``u`` in ``range(len(attn_types))``, each of whose
parameters has a leading axis of ``reps``: body layer ``i`` reads slice ``i
// group`` of ``block_{i % group}``. Each forward unbinds every stacked
parameter once (:meth:`Transformer.layers`), so autograd gives the stacked
gradient in one ``stack`` and every slice is contiguous. The slices go to
per-layer views that hold no parameters of their own: :func:`bound` puts
them in a view only while a part of it runs, and a rematerialised view's
checkpoint keeps them for its replay, so no slice (nor the cast copy it
views) outlives the step's autograd graph. Where the body is not a
multiple of the group (the flagship's 63 = 15 x 4 + 3), the last repetition
has slices that no layer reads: the JAX scan applies them and discards the
result, the port never applies them, and in both their gradient is zero.

Remat, as the JAX package configures it (``cfg.remat``, the highest
``remat_skip_blocks`` body block ids left plain, ``w_conv`` always
rematerialised), applies only while autograd records: under ``no_grad`` or
``inference_mode`` every block runs exactly as the plain forward. A
rematerialised block is ``torch.utils.checkpoint`` (non-reentrant):

- ``remat_policy=None`` (blanket remat): the whole block is one
  checkpoint, so only its input is kept and backward replays it, the
  attention forward kernels included.
- ``remat_policy="save_attn"``: the JAX policy saves the rotated q/k/v
  and the attention kernels' out/lse. Here the block is two checkpoints,
  the part before the attention Functions (norm, projections, rotary ->
  q, k, v) and the part after them (output projection, residual, norm,
  FF), with the Functions between them, outside both: their saved
  tensors (q, k, v, prefix, out, lse) are the residuals, so the attention
  forward kernels never run again in backward. The replay of the first
  part recomputes the q/k/v projections, which JAX does not (it needs
  only the norm's output for their weight gradients).
- ``remat_policy="save_ctx"``: the JAX policy saves only the attention
  kernels' out/lse, so backward replays the norm, the projections and
  rotary but never the attention. Here the block is two checkpoints: the
  first over the part before the attention and the attention Functions
  together, the second the part after them, as under ``save_attn``. Each
  block call makes a fresh pair of
  :class:`~dalle_tpu_torch.ops.attention.SavedContext` holders (text and
  image call) that the first checkpoint's closure keeps: the forward
  launches the attention kernels and keeps their out and lse there, and
  the replay in backward recomputes q/k/v and takes out and lse from the
  holders instead of launching again. So the block keeps its input, the
  attention outputs (the second checkpoint's inputs) and the lse, not
  q/k/v; the attention forward kernels launch once a layer and
  micro-batch; and the gradients are those of ``save_attn``, whose replay
  recomputes the same q/k/v.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from dalle_tpu_torch.config import (ATTN_AXIAL_COL, ATTN_AXIAL_ROW, SP_NONE,
                                    ModelConfig)
from dalle_tpu_torch.models.attention import (apply_rotary, join_halves,
                                              rotary_cos_sin,
                                              zoo_attention_halves)
from dalle_tpu_torch.ops import LAUNCHES
from dalle_tpu_torch.ops.attention import SavedContext
from dalle_tpu_torch.ops.geglu import GEGLUFn
from dalle_tpu_torch.ops.layer_norm import LayerNormFn
from dalle_tpu_torch.parallel import collectives

LN_EPS = 1e-6


def torch_dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


class Dense(nn.Module):
    """flax ``nn.Dense`` parameters: ``kernel`` (in, out), optional
    ``bias`` (out,). Applied in the computation dtype, as flax casts
    both operands to ``dtype``."""

    def __init__(self, in_features: int, out_features: int, bias: bool,
                 param_dtype: torch.dtype, stack: Tuple[int, ...] = ()):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(
            *stack, in_features, out_features, dtype=param_dtype))
        self.bias = (nn.Parameter(torch.zeros(*stack, out_features,
                                              dtype=param_dtype))
                     if bias else None)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        y = x.to(dtype) @ self.kernel.to(dtype)
        if self.bias is not None:
            y = y + self.bias.to(dtype)
        return y


class LayerNorm(nn.Module):
    """The block norm: ``{scale, bias}`` (d,) in param dtype.

    ``fused`` (``cfg.ln_fusion``) is the JAX package's ``FusedLayerNorm``:
    the LayerNorm kernel, ``(x - mean) * rstd * scale + bias``. Otherwise
    flax's ``nn.LayerNorm``: ``(x - mean) * (rstd * scale) + bias``. Both
    take f32 statistics with the fast variance."""

    def __init__(self, dim: int, fused: bool, param_dtype: torch.dtype,
                 stack: Tuple[int, ...] = ()):
        super().__init__()
        self.fused = fused
        self.scale = nn.Parameter(torch.ones(*stack, dim, dtype=param_dtype))
        self.bias = nn.Parameter(torch.zeros(*stack, dim, dtype=param_dtype))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        shape = x.shape
        if self.fused:
            y = LayerNormFn.apply(x.reshape(-1, shape[-1]), self.scale,
                                  self.bias, LN_EPS)
            return y.reshape(shape).to(dtype)
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        msq = (xf * xf).mean(dim=-1, keepdim=True)
        rstd = torch.rsqrt(torch.clamp(msq - mean * mean, min=0.0) + LN_EPS)
        y = (xf - mean) * (rstd * self.scale.float()) + self.bias.float()
        return y.to(dtype)


class ZooAttention(nn.Module):
    """Bias-free q/k/v projections, rotary, zoo attention, biased out:
    three steps, which :class:`TransformerBlock` chains (and checkpoints
    apart under ``save_attn`` and ``save_ctx``)."""

    def __init__(self, cfg: ModelConfig, attn_type: str,
                 stack: Tuple[int, ...] = (), mesh=None):
        super().__init__()
        self.cfg, self.attn_type, self.mesh = cfg, attn_type, mesh
        pd = torch_dtype(cfg.param_dtype)
        self.q = Dense(cfg.dim, cfg.dim, False, pd, stack)
        self.k = Dense(cfg.dim, cfg.dim, False, pd, stack)
        self.v = Dense(cfg.dim, cfg.dim, False, pd, stack)
        self.out = Dense(cfg.dim, cfg.dim, True, pd, stack)

    def tp(self):
        """The ``tp`` group that splits q/k/v's columns and out's rows, as
        their specs say (None: they are whole on every rank and the layer
        runs replicated over ``tp``)."""
        return tp_group(self.mesh, spec_of(self.q))

    def heads_split(self) -> bool:
        """Whether ``tp`` splits whole heads: False where it splits the
        columns but not the heads (XL's 28 heads at ``tp=8``), and each
        rank then gathers q/k/v and attends on every head."""
        return self.cfg.heads % self.mesh.tp == 0

    def qkv(self, x: torch.Tensor, rot):
        """The rotated (B, T, H, d) q, k and v of the normed input; over
        ``tp``, this rank's heads, or every head where ``tp`` does not
        split them (the projected columns gathered, the gather's backward
        this rank's columns of the gradient: every rank computes the same
        attention)."""
        cfg = self.cfg
        cd = torch_dtype(cfg.dtype)
        b, t, _ = x.shape
        group = self.tp()
        x = column_input(x, group)
        q, k, v = (proj(x, cd) for proj in (self.q, self.k, self.v))
        if group is not None and not self.heads_split():
            q, k, v = collectives.all_gather(
                torch.stack((q, k, v)), -1, group, grad="split").unbind(0)
        q, k, v = (y.reshape(b, t, -1, cfg.head_dim) for y in (q, k, v))
        if rot is not None:
            cos, sin = rot
            q, k = apply_rotary(q, cos, sin), apply_rotary(k, cos, sin)
        return q, k, v

    def attend(self, q, k, v, saved=None):
        """The attention kernels' (text, image) outputs, (B, H, t, d), or
        where the token axis is split over ``sp`` (:func:`token_shards`)
        the one sequence-parallel output (B, t, H, d) in a tuple;
        ``saved``: the calls' ``save_ctx`` holders."""
        cfg, mesh = self.cfg, self.mesh
        if seq_group(mesh, cfg) is not None:
            from dalle_tpu_torch.parallel.sequence import sp_zoo_attention
            return (sp_zoo_attention(
                q, k, v, mesh=mesh, mode=cfg.sequence_parallel,
                attn_type=self.attn_type, text_len=cfg.text_seq_len,
                grid=cfg.image_grid, conv_kernel=cfg.conv_kernel,
                saved=saved),)
        return zoo_attention_halves(
            q, k, v, attn_type=self.attn_type, text_len=cfg.text_seq_len,
            grid=cfg.image_grid, conv_kernel=cfg.conv_kernel, saved=saved)

    def project(self, *outs) -> torch.Tensor:
        """The output projection of the joined halves (or of the one
        sequence-parallel output), (B, T, dim)."""
        out = join_halves(*outs) if len(outs) == 2 else outs[0]
        b, t = out.shape[:2]
        cd = torch_dtype(self.cfg.dtype)
        out = out.reshape(b, t, -1)
        group = self.tp()
        if group is None:
            return self.out(out, cd)
        if not self.heads_split():
            # every head on every rank: this rank's columns of the context
            # (the backward gathers each rank's part of the gradient)
            out = collectives.split(out, -1, group)
        return row_output(out.to(cd) @ self.out.kernel.to(cd),
                          self.out.bias, group)


class GEGLUFeedForward(nn.Module):
    """GEGLU MLP with biased ``wi``/``gate``/``wo``. ``fuse`` routes it
    through the fused GEGLU kernel (``cfg.fuse_ff``); otherwise the
    unfused ``h * gelu(gate)`` in the computation dtype, as the JAX
    package computes it on the blocks it does not fuse."""

    def __init__(self, cfg: ModelConfig, fuse: bool,
                 stack: Tuple[int, ...] = (), mesh=None):
        super().__init__()
        self.cfg, self.fuse, self.mesh = cfg, fuse, mesh
        pd = torch_dtype(cfg.param_dtype)
        inner = cfg.ff_mult * cfg.dim
        self.wi = Dense(cfg.dim, inner, True, pd, stack)
        self.gate = Dense(cfg.dim, inner, True, pd, stack)
        self.wo = Dense(inner, cfg.dim, True, pd, stack)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = torch_dtype(self.cfg.dtype)
        group = tp_group(self.mesh, spec_of(self.wi))
        if group is not None:
            return self._forward_tp(x, cd, group)
        if self.fuse:
            b, t, d = x.shape
            out = GEGLUFn.apply(x.reshape(b * t, d).to(cd),
                                *(p.to(cd) for p in (
                                    self.wi.kernel, self.gate.kernel,
                                    self.wo.kernel, self.wi.bias,
                                    self.gate.bias, self.wo.bias)))
            return out.reshape(b, t, self.cfg.dim)
        h = self.wi(x, cd)
        gate = self.gate(x, cd)
        return self.wo(h * F.gelu(gate, approximate="tanh"), cd)

    def _forward_tp(self, x: torch.Tensor, cd: torch.dtype, group
                    ) -> torch.Tensor:
        """Column-parallel ``wi``/``gate`` on the local ``K/tp`` columns
        (biases sliced to them), row-parallel ``wo``: the fused kernel
        (or the unfused product) gives this rank's partial output without
        ``bo``, which :func:`row_output` adds after the sum over ``tp``.
        Where ``tp`` does not divide ``K`` the FF is whole on every rank
        and :meth:`forward` runs it as one process does."""
        x = column_input(x, group)
        bi, bg = (collectives.split(b, -1, group).to(cd)
                  for b in (self.wi.bias, self.gate.bias))
        wi, wg, wo = (p.kernel.to(cd) for p in (self.wi, self.gate, self.wo))
        if self.fuse:
            b, t, d = x.shape
            part = GEGLUFn.apply(x.reshape(b * t, d).to(cd), wi, wg, wo, bi,
                                 bg, torch.zeros_like(self.wo.bias, dtype=cd))
            part = part.reshape(b, t, -1)
        else:
            xc = x.to(cd)
            h = xc @ wi + bi
            part = (h * F.gelu(xc @ wg + bg, approximate="tanh")) @ wo
        return row_output(part, self.wo.bias, group)


def spec_of(module: nn.Module, leaf: str = "kernel") -> Tuple:
    """The spec of ``module``'s parameter ``leaf`` on the mesh, as
    :meth:`Transformer.set_specs` recorded it (``()``: whole)."""
    return getattr(module, "_specs", {}).get(leaf, ())


def tp_group(mesh, spec: Tuple):
    """The tensor-parallel group that splits a leaf of spec ``spec``
    (None: no tensor parallelism, or ``param_shardings`` keeps the leaf
    whole on every rank, as JAX's does where ``tp`` does not divide it;
    the layer that owns it then runs replicated over ``tp``)."""
    if mesh is None or mesh.tp == 1 or "tp" not in spec:
        return None
    return mesh.group("tp")


def token_shards(mesh, cfg: ModelConfig) -> int:
    """How many ways the token axis is split: ``sp`` under ring or
    Ulysses; 1 without a mesh or with ``sequence_parallel="none"``, where
    every ``sp`` rank runs whole sequences on the rows its batch index
    holds (a replica axis, as in JAX, whose model then has no mesh and
    whose shardings name no ``sp``). The one place that decides it."""
    if mesh is None or cfg.sequence_parallel == SP_NONE:
        return 1
    return mesh.sp


def seq_group(mesh, cfg: ModelConfig):
    """The group the token axis is split over (None: whole sequences)."""
    return mesh.group("sp") if token_shards(mesh, cfg) > 1 else None


def column_input(x: torch.Tensor, group) -> torch.Tensor:
    """The input of a column-parallel product over the ``tp`` group
    ``group``: ``x``, whose gradient is summed over ``tp`` (each rank's
    product sees its columns only); ``x`` itself for None."""
    return x if group is None else collectives.reduce_grad(x, group)


def row_output(part: torch.Tensor, bias: torch.Tensor, group
               ) -> torch.Tensor:
    """A row-parallel product's output: this rank's partial product summed
    over the ``tp`` group in f32, plus the replicated ``bias``, rounded
    once to the partial's dtype."""
    total = collectives.all_reduce(part.float(), group)
    return (total + bias.float()).to(part.dtype)


class TransformerBlock(nn.Module):
    """Pre-norm attention + GEGLU FF with residuals. ``remat``: checkpoint
    the block (by ``cfg.remat_policy``) while autograd records. ``stack``:
    the leading axes of every parameter (``(reps,)`` for a stacked
    ``dense_scan`` block, which only holds the parameters: its layers
    apply them, :meth:`Transformer.layers`)."""

    def __init__(self, cfg: ModelConfig, attn_type: str, fuse_ff: bool,
                 remat: bool = False, stack: Tuple[int, ...] = (),
                 mesh=None):
        super().__init__()
        self.cfg, self.remat, self.mesh = cfg, remat, mesh
        pd = torch_dtype(cfg.param_dtype)
        self.attn_norm = LayerNorm(cfg.dim, cfg.ln_fusion, pd, stack)
        self.attn = ZooAttention(cfg, attn_type, stack, mesh)
        self.ff_norm = LayerNorm(cfg.dim, cfg.ln_fusion, pd, stack)
        self.ff = GEGLUFeedForward(cfg, fuse_ff, stack, mesh)

    def _pre(self, x, rot):
        return self.attn.qkv(self.attn_norm(x, torch_dtype(self.cfg.dtype)),
                             rot)

    def _post(self, x, *outs):
        x = x + self.attn.project(*outs)
        return x + self.ff(self.ff_norm(x, torch_dtype(self.cfg.dtype)))

    def _pre_attend(self, x, rot, saved):
        return self.attn.attend(*self._pre(x, rot), saved=saved)

    def _block(self, x, rot):
        return self._post(x, *self.attn.attend(*self._pre(x, rot)))

    def forward(self, x: torch.Tensor, rot, params=None) -> torch.Tensor:
        """``params``: a stacked layer view's slices (:meth:`Transformer.
        layers`), bound while each part runs; a checkpoint holds them in
        its closure for the replay."""
        def run(fn, *args):
            with bound(params), gathered(self):
                return fn(*args)

        if not (self.remat and torch.is_grad_enabled()):
            return run(self._block, x, rot)
        with replay_whole(self.mesh):
            return self._remat(run, x, rot)

    def _remat(self, run, x, rot):
        policy = self.cfg.remat_policy
        if policy is None:
            return checkpoint(run, self._block, x, rot, use_reentrant=False)
        if policy == "save_attn":
            q, k, v = checkpoint(run, self._pre, x, rot, use_reentrant=False)
            halves = self.attn.attend(q, k, v)
        else:                                   # "save_ctx"
            saved = (SavedContext(), SavedContext())
            halves = checkpoint(run, self._pre_attend, x, rot, saved,
                                use_reentrant=False)
        return checkpoint(run, self._post, x, *halves, use_reentrant=False)


Slices = List[Tuple[nn.Module, str, torch.Tensor]]


@contextlib.contextmanager
def bound(params: Optional[Slices]):
    """Within the block, each ``(module, name, tensor)`` of ``params`` is
    that module's parameter ``name``; after it, None again."""
    params = params or ()
    for module, name, tensor in params:
        module._parameters[name] = tensor
    try:
        yield
    finally:
        for module, name, _ in params:
            module._parameters[name] = None


@contextlib.contextmanager
def gathered(block: nn.Module):
    """Within the block, each fsdp-sharded kernel of ``block`` (the
    modules' ``_specs``, set by ``models.dalle.DALLE`` on a mesh with
    ``fsdp > 1``) is its all-gather over ``fsdp``, whose backward
    reduce-scatters the gradient; after it, the shard again."""
    mesh = getattr(block, "mesh", None)
    if mesh is None or mesh.fsdp == 1:
        yield
        return
    group = mesh.group("fsdp")
    swapped = []
    for module in block.modules():
        for leaf, spec in getattr(module, "_specs", {}).items():
            if "fsdp" not in spec:
                continue
            shard = module._parameters[leaf]
            swapped.append((module, leaf, shard))
            module._parameters[leaf] = collectives.all_gather(
                shard, spec.index("fsdp"), group)
    try:
        yield
    finally:
        for module, leaf, shard in swapped:
            module._parameters[leaf] = shard


def replay_whole(mesh):
    """On a sharded mesh, checkpoints made within replay their whole
    function (no early stop), so every rank replays the same
    collectives."""
    if mesh is None or not mesh.sharded:
        return contextlib.nullcontext()
    from torch.utils.checkpoint import set_checkpoint_early_stop
    return set_checkpoint_early_stop(False)


def block_name(uid: int) -> str:
    return "block_wconv" if uid == -1 else f"block_{uid}"


class Transformer(nn.Module):
    """The depth-``cfg.depth`` stack: one module per unique block id (or per
    group position of the stacked ``dense_scan`` layout), applied in
    ``cfg.layer_schedule()`` order, then the final norm."""

    def __init__(self, cfg: ModelConfig, mesh=None):
        super().__init__()
        self.cfg, self.mesh = cfg, mesh
        plain = set(cfg.plain_block_ids())
        reps = cfg.dense_scan_reps()
        group = len(cfg.attn_types)
        self.blocks = nn.ModuleDict()
        for uid, attn_type in cfg.layer_schedule():
            stacked = reps > 0 and uid != -1
            name = block_name(uid % group if stacked else uid)
            if name not in self.blocks:
                self.blocks[name] = TransformerBlock(
                    cfg, attn_type, cfg.fuse_ff(uid in plain),
                    remat=cfg.remat and uid not in plain,
                    stack=(reps,) if stacked else (), mesh=mesh)
        self.final_norm = LayerNorm(cfg.dim, cfg.ln_fusion,
                                    torch_dtype(cfg.param_dtype))
        # the stacked layout's layers: modules without storage of their
        # own (built on the meta device, never registered, so they are
        # neither parameters nor moved by ``to``), whose parameters are
        # None but while :func:`bound` puts a repetition's slices in;
        # _slots lists (group position, block module, parameter name, the
        # layers' modules)
        self._views, self._slots = [], []
        for u in range(group if reps else 0):
            block = self.blocks[block_name(u)]
            with torch.device("meta"):
                views = [TransformerBlock(cfg, cfg.attn_types[u],
                                          block.ff.fuse, block.remat,
                                          mesh=mesh)
                         for _ in range(reps)]
            self._views.append(views)
            for mod_name, mod in block.named_modules():
                for leaf in mod._parameters:
                    subs = [v.get_submodule(mod_name) for v in views]
                    for sub in subs:
                        sub._parameters[leaf] = None
                    self._slots.append((u, mod, leaf, subs))

    def rotary(self, device, start: int = 0, length: Optional[int] = None
               ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        """cos/sin of positions ``[start, start + length)`` (default: the
        whole sequence)."""
        if not self.cfg.rotary:
            return None
        if length is None:
            length = self.cfg.total_seq_len - start
        return rotary_cos_sin(torch.arange(start, start + length,
                                           device=device), self.cfg.head_dim)

    def layers(self) -> List[Tuple[nn.Module, Optional[Slices]]]:
        """``(module, params)`` for each ``cfg.layer_schedule()`` position:
        params None for a block with parameters of its own. In the stacked
        layout the module is a storage-free view and params its
        repetition's slices of every stacked parameter as it is now (a
        cast copy under ``cast_parameters`` included), which the module
        binds (:func:`bound`) while it runs. Call it once per forward."""
        slices = [[[] for _ in views] for views in self._views]
        for u, block_param, leaf, subs in self._slots:
            parts = block_param._parameters[leaf].unbind(0)
            for rep, (sub, part) in enumerate(zip(subs, parts)):
                slices[u][rep].append((sub, leaf, part))
        group = len(self.cfg.attn_types)
        out = []
        for uid, _ in self.cfg.layer_schedule():
            if self._views and uid != -1:
                rep, u = divmod(uid, group)
                out.append((self._views[u][rep], slices[u][rep]))
            else:
                out.append((self.blocks[block_name(uid)], None))
        return out

    def set_specs(self, specs: Dict[str, Tuple]) -> None:
        """Record, on each module of the blocks (and the stacked layout's
        views, without the repetitions' axis), the spec of each of its
        leaves: the one record of how a layer's leaves are split, which
        the fsdp gathers (:func:`gathered`) and the ``tp`` layers
        (:func:`tp_group`) read; ``specs``: each parameter's spec, by its
        name under this module."""
        for name, spec in specs.items():
            owner, leaf = name.rsplit(".", 1)
            module = self.get_submodule(owner)
            module.__dict__.setdefault("_specs", {})[leaf] = tuple(spec)
        for _, block_param, leaf, subs in self._slots:
            spec = spec_of(block_param, leaf)
            for sub in subs:
                sub.__dict__.setdefault("_specs", {})[leaf] = spec[1:]

    def forward(self, x: torch.Tensor, start: int = 0) -> torch.Tensor:
        """``x``: (B, t, dim) at positions ``[start, start + t)``."""
        rot = self.rotary(x.device, start, x.shape[1])
        for layer, params in self.layers():
            x = layer(x, rot, params)
        return self.final_norm(x, torch_dtype(self.cfg.dtype))


def wrapper_calls(cfg: ModelConfig, training: bool) -> Dict[str, int]:
    """The kernel wrappers' calls (the keys of ``ops.LAUNCHES``) in one
    forward of a (B, T) batch, from the schedule and the remat set; with
    ``training``, also those of its backward: one backward call per forward
    call, and the forward calls a rematerialised block runs again (under
    ``save_attn`` and ``save_ctx`` all but the attention's; under blanket
    remat all). The
    wrappers the model never calls (the backward ones without
    ``training``, the quantizers) count 0."""
    plain = set(cfg.plain_block_ids())
    calls = {"layer_norm": 0, "line_attention": 0, "window_attention": 0,
             "geglu_ff": 0}

    def block(uid: int, attn_type: str, n: int, attention: bool = True):
        calls["layer_norm"] += 2 * n if cfg.ln_fusion else 0
        if attention:
            calls["line_attention"] += n
            axial = attn_type in (ATTN_AXIAL_ROW, ATTN_AXIAL_COL)
            calls["line_attention" if axial else "window_attention"] += n
        calls["geglu_ff"] += n if cfg.fuse_ff(uid in plain) else 0

    sched = cfg.layer_schedule()
    for uid, attn_type in sched:
        block(uid, attn_type, 1)
    calls["layer_norm"] += 1 if cfg.ln_fusion else 0      # final norm
    out = dict(calls)
    if training:
        out.update({f"{k}_bwd": v for k, v in calls.items()})
        for uid, attn_type in sched:
            if cfg.remat and uid not in plain:
                block(uid, attn_type, 1,
                      attention=cfg.remat_policy is None)
        out.update(calls)
    return dict.fromkeys(LAUNCHES, 0) | out
