"""The DALL-E text-to-image model in PyTorch (counterpart of
``dalle_tpu/models/dalle.py``).

Sequence layout, kept from the JAX model: it scores the unshifted sequence
``S = [text || image + vocab_text]``; position ``p`` receives the previous
token's embedding (BOS, id ``vocab_total``, at p=0) and predicts ``S_p``.
One tied table over ``vocab_total + 1`` rows rounded up to a multiple of
128; text positions may only predict text ids and image positions only image
ids (segment masking with -1e9).

The tied head's loss streams over vocabulary chunks of ``cfg.head_chunk``
rows where a segment is wider (:class:`ChunkedNLL`, JAX's
``_segment_nll``): the same values without the (B, T, V) logits, each
chunk recomputed in backward. ``head_chunk=0``, the untied head and
``return_logits`` take the whole vocabulary in one pass, as in JAX.

``DALLE(cfg, mesh=...)`` on a sharded mesh (``parallel/mesh.py``, ``fsdp``,
``tp`` or ``sp`` above 1) computes on this process's shards once
``parallel/sharding.shard_train_state`` has cut them (:meth:`DALLE.
mark_sharded`), on every mesh the JAX package runs:

- its rows of the batch (those of its ``(dp, fsdp)`` index);
- under ring or Ulysses, its token slice (positions ``[i*T/sp,
  (i+1)*T/sp)``, which ranks of one batch index share); with
  ``sequence_parallel="none"`` every ``sp`` rank runs whole sequences, a
  replica axis (``transformer.token_shards``, the one decision);
- its rows of the tied table where ``tp`` divides them (``token_emb``
  ``P("tp", None)``): the embedding looks up the ids in its rows and sums
  over ``tp``, the head gives this rank's vocabulary slice of the logits,
  and the loss takes a vocab-parallel logsumexp and target gather
  (:class:`VocabParallelNLL`, or :class:`ChunkedNLL` over the slice);
  where ``tp`` does not divide them the table is whole on every rank
  (``param_shardings`` drops the axis, as JAX's does) and the embedding
  and head run as on one process;
- the blocks' ``tp`` shards where ``tp`` divides their leaves, whole
  leaves otherwise (``models/transformer.py``).

An untied head's ``lm_head/kernel`` (dim, vocab_total) is ``P("fsdp",
"tp")``: it is gathered over ``fsdp`` as the blocks' kernels are, and each
``tp`` rank computes its columns of the vocabulary (no BOS row, no
padding); where ``tp`` does not divide ``vocab_total`` every rank computes
the whole vocabulary, as JAX's replicated leaf does. The returned loss is
this rank's part of the global loss (its tokens' sums over the global
denominators), so the gradients summed over the batch axes (and the token
shards) are the global mesh's (``training/steps.reduce_gradients``);
``aux`` holds the global values. ``return_logits`` gives this process's
rows of the batch with the whole token axis and the whole vocabulary,
summed into place over ``tp`` and the token shards with the identity as
backward (each rank keeps its own tokens' and columns' part of the
gradient).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from dalle_tpu_torch.config import ModelConfig
from dalle_tpu_torch.models.transformer import (Dense, Transformer,
                                                column_input, seq_group,
                                                token_shards, tp_group,
                                                torch_dtype)
from dalle_tpu_torch.parallel import collectives

NEG_INF = -1e9


def _head_logits(h: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``h @ table^T`` in f32 from operands in h's dtype (exact products,
    f32 accumulation: ``preferred_element_type=float32``)."""
    return h.float() @ table.to(h.dtype).float().t()


def _dense_logits(h: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """The untied head, ``h @ kernel`` in h's dtype (flax ``nn.Dense``
    with ``dtype``), then f32."""
    return (h @ kernel.to(h.dtype)).float()


def _nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, targets[..., None].long())[..., 0]


class _HeadPart:
    """This rank's part of the output head on a mesh: the logits of the
    vocabulary columns ``[c0, c0 + width)`` (``group``: the ``tp`` group
    the vocabulary is split over, None when every rank holds it whole)."""

    def __init__(self, weight, tied: bool, c0: int, width: int, group):
        self.weight, self.tied = weight, tied
        self.c0, self.width, self.group = c0, width, group

    def logits(self, h: torch.Tensor, a: int, b: int) -> torch.Tensor:
        """Logits of the vocabulary ids ``[a, b)`` (inside this part)."""
        lo, hi = a - self.c0, b - self.c0
        if self.tied:
            return _head_logits(h, self.weight[lo:hi])
        return _dense_logits(h, self.weight[:, lo:hi])


def _segment_nll(h: torch.Tensor, table: torch.Tensor,
                 targets: torch.Tensor, head_chunk: int = 0
                 ) -> torch.Tensor:
    """Per-token NLL of ``targets`` under the tied-head logits over one
    segment's vocabulary slice, (B, T): in one pass, or, with
    ``head_chunk > 0`` and a segment wider than it, streamed over chunks
    of ``head_chunk`` rows (:class:`ChunkedNLL`; JAX's ``_segment_nll``)."""
    if head_chunk <= 0 or table.shape[0] <= head_chunk:
        return _nll(_head_logits(h, table), targets)
    return ChunkedNLL.apply(h, table, targets, 0, head_chunk, None)


class ChunkedNLL(torch.autograd.Function):
    """Per-token NLL of ``targets`` (ids into the segment) under the
    tied-head logits ``h @ table^T`` of a vocabulary slice ``table`` (the
    segment's ids ``offset`` onward), streamed over chunks of ``chunk``
    rows: the target's logit from its gathered row, and the logsumexp as
    a running max and sum of exponentials, chunk by chunk, so no (B, T,
    V) tensor is kept. The last chunk is as narrow as the rows left (JAX
    pads it and masks the padding out). Over the ``tp`` group ``group``
    each rank streams its slice, and the ranks' maxima, sums and target
    logits combine once. Backward rebuilds each chunk's logits and takes
    softmax minus one-hot, chunk by chunk; the gradients round where the
    one-pass head's do (f32 products from operands in ``h``'s dtype, the
    sums in f32, each gradient cast once)."""

    @staticmethod
    def forward(ctx, h, table, targets, offset, chunk, group):
        hf = h.float()
        v = table.shape[0]
        m = hf.new_full(h.shape[:-1], float("-inf"))
        total = hf.new_zeros(h.shape[:-1])
        for a in range(0, v, chunk):
            s = hf @ table[a:a + chunk].to(h.dtype).float().t()
            top = torch.maximum(m, s.amax(dim=-1))
            total = total * torch.exp(m - top) + torch.exp(
                s - top[..., None]).sum(dim=-1)
            m = top
        local = targets.long() - offset
        inside = (local >= 0) & (local < v)
        target = torch.zeros_like(m)
        if v:
            rows = table[local.clamp(0, v - 1)].to(h.dtype).float()
            target = torch.where(inside, (hf * rows).sum(dim=-1), target)
        if group is not None:
            top = collectives.max_over(m, group)
            total = collectives.sum_over(total * torch.exp(m - top),
                                         [group])
            m = top
            target = collectives.sum_over(target, [group])
        lse = m + torch.log(total)
        ctx.chunk = chunk
        ctx.save_for_backward(h, table, local, lse)
        return lse - target

    @staticmethod
    def backward(ctx, g):
        h, table, local, lse = ctx.saved_tensors
        hf = h.float()
        rows = hf.reshape(-1, hf.shape[-1])
        dh = torch.zeros_like(hf)
        dtable = torch.zeros(table.shape, dtype=torch.float32,
                             device=table.device)
        for a in range(0, table.shape[0], ctx.chunk):
            w = table[a:a + ctx.chunk].to(h.dtype).float()
            ids = torch.arange(a, a + w.shape[0], device=w.device)
            p = torch.exp(hf @ w.t() - lse[..., None])
            p = (p - (local[..., None] == ids).to(p.dtype)) * g[..., None]
            dh += p @ w
            dtable[a:a + w.shape[0]] = p.reshape(-1, w.shape[0]).t() @ rows
        return (dh.to(h.dtype), dtable.to(h.dtype).to(table.dtype), None,
                None, None, None)


class VocabParallelNLL(torch.autograd.Function):
    """Per-token NLL from this rank's vocabulary slice of the logits,
    (B, t, V/tp) f32, over the ``tp`` group: the max and the sum of
    exponentials over the whole vocabulary, and the target's logit from
    the rank that holds it; ``targets`` are ids into the segment,
    ``offset`` the first segment id of this slice. Backward: softmax minus
    one-hot on the slice."""

    @staticmethod
    def forward(ctx, logits, targets, offset, group):
        width = logits.shape[-1]
        if width:
            local_max = logits.amax(dim=-1)
        else:
            local_max = logits.new_full(logits.shape[:-1], float("-inf"))
        m = collectives.max_over(local_max, group)
        e = torch.exp(logits - m[..., None])
        total = collectives.sum_over(e.sum(dim=-1), [group])
        local = targets.long() - offset
        inside = (local >= 0) & (local < width)
        idx = local.clamp(0, max(width - 1, 0))[..., None]
        picked = (logits.gather(-1, idx)[..., 0] if width
                  else torch.zeros_like(m))
        target = collectives.sum_over(
            torch.where(inside, picked, torch.zeros_like(picked)), [group])
        ctx.save_for_backward(e, total, idx, inside)
        return torch.log(total) + m - target

    @staticmethod
    def backward(ctx, g):
        e, total, idx, inside = ctx.saved_tensors
        grad = e / total[..., None]
        if grad.shape[-1]:
            grad = grad.scatter_add(
                -1, idx, -inside.to(grad.dtype)[..., None])
        return grad * g[..., None], None, None, None


class DALLE(nn.Module):
    def __init__(self, cfg: ModelConfig, mesh=None):
        super().__init__()
        cfg.validate()
        self.cfg = cfg
        self.mesh = mesh if mesh is not None and mesh.sharded else None
        self.sharded = False
        pd = torch_dtype(cfg.param_dtype)
        rows = -(-(cfg.vocab_total + 1) // 128) * 128
        self.token_emb = nn.Parameter(torch.zeros(rows, cfg.dim, dtype=pd))
        self.text_pos_emb = nn.Parameter(
            torch.zeros(cfg.text_seq_len, cfg.dim, dtype=pd))
        self.img_row_emb = nn.Parameter(
            torch.zeros(cfg.image_grid, cfg.dim, dtype=pd))
        self.img_col_emb = nn.Parameter(
            torch.zeros(cfg.image_grid, cfg.dim, dtype=pd))
        self.transformer = Transformer(cfg, self.mesh)
        self.lm_head = (None if cfg.tied_embeddings else
                        Dense(cfg.dim, cfg.vocab_total, False, pd))
        if self.mesh is not None:
            self._place_on_mesh()

    def _place_on_mesh(self) -> None:
        """Raise what JAX's sequence-parallel attention raises where the
        token axis is split (the sequence over ``sp``, or ``2*sp`` for the
        ring; the heads over ``tp``; Ulysses' heads per ``tp`` rank over
        ``sp``), and record each leaf's spec: the one record of which
        leaves ``fsdp`` and ``tp`` split, which the blocks' gathers and
        ``tp`` layers, the embedding and the head read."""
        from dalle_tpu_torch.parallel.sequence import check_sp
        from dalle_tpu_torch.parallel.sharding import param_shardings
        cfg, mesh = self.cfg, self.mesh
        if token_shards(mesh, cfg) > 1:
            for attn_type in sorted({a for _, a in cfg.layer_schedule()}):
                check_sp(mesh, cfg.sequence_parallel, attn_type,
                         mesh.dp * mesh.fsdp, cfg.total_seq_len, cfg.heads)
        self.shard_specs = specs = param_shardings(mesh, self)
        self.whole_shapes = {n: tuple(p.shape)
                             for n, p in self.named_parameters()}
        self.transformer.set_specs(
            {n[len("transformer."):]: s for n, s in specs.items()
             if n.startswith("transformer.")})

    def mark_sharded(self) -> None:
        """Called by ``shard_train_state`` once the parameters are this
        process's shards."""
        self.sharded = True

    @property
    def bos_id(self) -> int:
        return self.cfg.vocab_total

    def positional(self) -> torch.Tensor:
        """(T, dim) learned positions: text, then image row + column."""
        cfg = self.cfg
        img = (self.img_row_emb[:, None, :]
               + self.img_col_emb[None, :, :]).reshape(cfg.image_seq_len,
                                                       cfg.dim)
        return torch.cat([self.text_pos_emb, img], dim=0)

    def backbone(self, input_ids: torch.Tensor) -> torch.Tensor:
        x = self.token_emb[input_ids.long()] + self.positional()[None]
        return self.transformer(x.to(torch_dtype(self.cfg.dtype)))

    def logits_from_hidden(self, h: torch.Tensor) -> torch.Tensor:
        """Full-vocabulary logits in f32 with segment masking."""
        cfg = self.cfg
        if cfg.tied_embeddings:
            logits = _head_logits(h, self.token_emb[:cfg.vocab_total])
        else:
            logits = self.lm_head(h, h.dtype).float()
        t = h.shape[1]
        is_text_pos = (torch.arange(t, device=h.device)
                       < cfg.text_seq_len)[None, :, None]
        is_text_vocab = (torch.arange(cfg.vocab_total, device=h.device)
                         < cfg.vocab_text)[None, None, :]
        valid = is_text_pos == is_text_vocab
        return torch.where(valid, logits, NEG_INF)

    def forward(self, text_tokens: torch.Tensor, image_tokens: torch.Tensor,
                loss_mask: Optional[torch.Tensor] = None,
                return_logits: bool = False):
        """Weighted next-token cross-entropy ``(loss, aux)``, plus the
        logits with ``return_logits``. text_tokens (B, text_seq_len),
        image_tokens (B, image_seq_len) integer ids; loss_mask an optional
        (B, T) multiplier. On a sharded mesh: this process's rows, and the
        loss is its part of the global loss (module docstring)."""
        if self.mesh is not None:
            return self._mesh_forward(text_tokens, image_tokens, loss_mask,
                                      return_logits)
        cfg = self.cfg
        labels = torch.cat([text_tokens, image_tokens + cfg.vocab_text], 1)
        bos = torch.full((labels.shape[0], 1), self.bos_id,
                         dtype=labels.dtype, device=labels.device)
        h = self.backbone(torch.cat([bos, labels[:, :-1]], dim=1))

        if return_logits or not cfg.tied_embeddings:
            logits = self.logits_from_hidden(h)
            logp = torch.log_softmax(logits, dim=-1)
            nll = -logp.gather(-1, labels[..., None].long())[..., 0]
            nll_text = nll[:, :cfg.text_seq_len]
            nll_img = nll[:, cfg.text_seq_len:]
        else:
            table = self.token_emb
            nll_text = _segment_nll(h[:, :cfg.text_seq_len],
                                    table[:cfg.vocab_text], text_tokens,
                                    cfg.head_chunk)
            nll_img = _segment_nll(h[:, cfg.text_seq_len:],
                                   table[cfg.vocab_text:cfg.vocab_total],
                                   image_tokens, cfg.head_chunk)

        if loss_mask is not None:
            mask_text = loss_mask[:, :cfg.text_seq_len]
            mask_img = loss_mask[:, cfg.text_seq_len:]
            nll_text = nll_text * mask_text
            nll_img = nll_img * mask_img
            denom_text = torch.clamp(mask_text.sum(), min=1.0)
            denom_img = torch.clamp(mask_img.sum(), min=1.0)
        else:
            denom_text = nll_text.shape[0] * cfg.text_seq_len
            denom_img = nll_img.shape[0] * cfg.image_seq_len
        loss_text = nll_text.sum() / denom_text
        loss_img = nll_img.sum() / denom_img
        w = cfg.loss_img_weight
        loss = (loss_text + w * loss_img) / (1.0 + w)
        aux = {"loss": loss, "loss_text": loss_text, "loss_img": loss_img}
        if return_logits:
            return loss, aux, logits
        return loss, aux


    def _tp_of(self, name: str):
        """The ``tp`` group that splits parameter ``name`` (None: it is
        whole on every rank)."""
        return tp_group(self.mesh, self.shard_specs[name])

    def _embed(self, ids: torch.Tensor) -> torch.Tensor:
        """The token embedding; over ``tp`` each rank looks up the ids in
        its rows of the table and the lookups are summed."""
        group = self._tp_of("token_emb")
        table = self.token_emb
        if group is None:
            return table[ids.long()]
        rows = table.shape[0]
        local = ids.long() - self.mesh.index("tp") * rows
        inside = (local >= 0) & (local < rows)
        x = table[local.clamp(0, rows - 1)] * inside[..., None].to(
            table.dtype)
        return collectives.all_reduce(x, group)

    def _head_part(self) -> _HeadPart:
        """This rank's head: the tied table's rows over ``tp``, or the
        untied kernel gathered over ``fsdp`` (its backward reduce-scatters
        the gradient) with its columns over ``tp``."""
        mesh = self.mesh
        if self.cfg.tied_embeddings:
            group = self._tp_of("token_emb")
            rows = self.token_emb.shape[0]
            c0 = mesh.index("tp") * rows if group is not None else 0
            return _HeadPart(self.token_emb, True, c0, rows, group)
        spec = self.shard_specs["lm_head.kernel"]
        kernel = self.lm_head.kernel
        if "fsdp" in spec and mesh.fsdp > 1:
            kernel = collectives.all_gather(kernel, spec.index("fsdp"),
                                            mesh.group("fsdp"))
        group = self._tp_of("lm_head.kernel")
        cols = kernel.shape[1]
        c0 = mesh.index("tp") * cols if group is not None else 0
        return _HeadPart(kernel, False, c0, cols, group)

    def _segment_sums(self, h, head: _HeadPart, lo: int, hi: int, targets,
                      mask):
        """The (B, t) NLL of ``targets`` (ids into the vocabulary segment
        ``[lo, hi)``) under the head, masked by ``mask``; over ``tp`` from
        this rank's columns of the segment; the tied head's streamed over
        ``head_chunk`` rows where the segment is wider."""
        chunk = self.cfg.head_chunk
        c0, c1 = head.c0, head.c0 + head.width
        a, b = max(lo, c0), max(min(hi, c1), max(lo, c0))
        if head.tied and 0 < chunk < hi - lo:
            nll = ChunkedNLL.apply(h, head.weight[a - c0:b - c0], targets,
                                   a - lo, chunk, head.group)
        elif head.group is None:
            nll = _nll(head.logits(h, lo, hi), targets)
        else:
            nll = VocabParallelNLL.apply(head.logits(h, a, b), targets,
                                         a - lo, head.group)
        return nll * mask if mask is not None else nll

    def _mesh_logits(self, h, head: _HeadPart, t0: int) -> torch.Tensor:
        """This process's rows of the logits, (B, T, vocab_total) f32 with
        segment masking: its columns and tokens summed into place over
        ``tp`` and the token shards (the identity as backward)."""
        cfg = self.cfg
        v, tl = cfg.vocab_total, h.shape[1]
        a, e = min(head.c0, v), min(head.c0 + head.width, v)
        logits = head.logits(h, a, e)
        if head.group is not None:
            logits = collectives.all_reduce(
                nn.functional.pad(logits, (a, v - e)), head.group)
        pos = torch.arange(t0, t0 + tl, device=h.device)
        valid = ((pos < cfg.text_seq_len)[None, :, None]
                 == (torch.arange(v, device=h.device)
                     < cfg.vocab_text)[None, None, :])
        logits = torch.where(valid, logits, NEG_INF)
        group = seq_group(self.mesh, cfg)
        if group is not None:
            logits = collectives.all_reduce(
                nn.functional.pad(
                    logits, (0, 0, t0, cfg.total_seq_len - t0 - tl)), group)
        return logits

    def _mesh_forward(self, text_tokens, image_tokens, loss_mask,
                      return_logits=False):
        if not self.sharded:
            raise RuntimeError("the model was built for a sharded mesh: "
                               "call parallel.sharding.shard_train_state")
        cfg, mesh = self.cfg, self.mesh
        labels = torch.cat([text_tokens, image_tokens + cfg.vocab_text], 1)
        bos = torch.full((labels.shape[0], 1), self.bos_id,
                         dtype=labels.dtype, device=labels.device)
        inputs = torch.cat([bos, labels[:, :-1]], dim=1)
        shards = token_shards(mesh, cfg)
        tl = cfg.total_seq_len // shards
        t0 = mesh.index("sp") * tl if shards > 1 else 0
        inputs, labels = inputs[:, t0:t0 + tl], labels[:, t0:t0 + tl]
        mask = None if loss_mask is None else loss_mask[:, t0:t0 + tl]
        x = self._embed(inputs) + self.positional()[t0:t0 + tl][None]
        h = self.transformer(x.to(torch_dtype(cfg.dtype)), t0)
        head = self._head_part()
        h = column_input(h, head.group)

        n_text = min(max(cfg.text_seq_len - t0, 0), tl)
        axes = [mesh.group("batch"), seq_group(mesh, cfg)]
        parts = []
        for lo, hi, sl, offset in ((0, cfg.vocab_text, slice(0, n_text), 0),
                                   (cfg.vocab_text, cfg.vocab_total,
                                    slice(n_text, tl), cfg.vocab_text)):
            m = None if mask is None else mask[:, sl]
            if sl.stop > sl.start:
                nll_sum = self._segment_sums(h[:, sl], head, lo, hi,
                                             labels[:, sl] - offset,
                                             m).sum()
            else:
                nll_sum = h.new_zeros((), dtype=torch.float32)
            if m is None:
                seg_len = (cfg.text_seq_len if offset == 0
                           else cfg.image_seq_len)
                denom = float(labels.shape[0] * mesh.axis_size("batch")
                              * seg_len)
            else:
                denom = torch.clamp(collectives.sum_over(
                    m.sum().float(), axes), min=1.0)
            parts.append(nll_sum / denom)
        w = cfg.loss_img_weight
        loss = (parts[0] + w * parts[1]) / (1.0 + w)
        total = collectives.sum_over(
            torch.stack([loss, parts[0], parts[1]]).detach(), axes)
        aux = {"loss": total[0], "loss_text": total[1],
               "loss_img": total[2]}
        if return_logits:
            return loss, aux, self._mesh_logits(h, head, t0)
        return loss, aux


@torch.no_grad()
def init_params(cfg: ModelConfig, generator: torch.Generator,
                mesh=None) -> DALLE:
    """A DALLE (built for ``mesh``, whole until ``shard_train_state``) on
    the generator's device with random weights drawn from ``generator``,
    the same on every process: embeddings N(0, 0.02),
    dense kernels lecun-normal (truncated normal, std 1/sqrt(fan_in), each
    slice of a stacked kernel with its own draws),
    biases zero, LayerNorm scale 1 and bias 0 -- the flax initialisers."""
    model = DALLE(cfg, mesh=mesh).to(generator.device)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if name in ("token_emb", "text_pos_emb", "img_row_emb",
                    "img_col_emb"):
            p.copy_(torch.randn(p.shape, generator=generator,
                                device=generator.device) * 0.02)
        elif leaf == "kernel":
            # flax lecun_normal: truncated normal on [-2, 2] rescaled to
            # unit variance (the 0.8796 factor), times 1/sqrt(fan_in)
            w = torch.empty(p.shape, device=generator.device)
            nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0,
                                  generator=generator)
            p.copy_(w / 0.87962566103423978 / math.sqrt(p.shape[-2]))
    return model
