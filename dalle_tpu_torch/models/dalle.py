"""The DALL-E text-to-image model in PyTorch (counterpart of
``dalle_tpu/models/dalle.py``).

Sequence layout, kept from the JAX model: it scores the unshifted sequence
``S = [text || image + vocab_text]``; position ``p`` receives the previous
token's embedding (BOS, id ``vocab_total``, at p=0) and predicts ``S_p``.
One tied table over ``vocab_total + 1`` rows rounded up to a multiple of
128; text positions may only predict text ids and image positions only image
ids (segment masking with -1e9).

``DALLE(cfg, mesh=...)`` on a sharded mesh (``parallel/mesh.py``, ``fsdp``,
``tp`` or ``sp`` above 1) computes on this process's shards once
``parallel/sharding.shard_train_state`` has cut them (:meth:`DALLE.
mark_sharded`): its rows of the batch, its token slice (``sp``: positions
``[i*T/sp, (i+1)*T/sp)``, which ranks of one batch index share), and its
rows of the tied table, ``token_emb`` being vocab-sharded over ``tp``
(``P("tp", None)``): the embedding looks up the ids in its rows and sums
over ``tp``, the head gives this rank's vocabulary slice of the logits,
and the loss takes a vocab-parallel logsumexp and target gather
(:class:`VocabParallelNLL`). Its returned loss is this rank's part of the
global loss (its tokens' sums over the global denominators), so the
gradients summed over the batch and sequence axes are the global mesh's
(``training/steps.reduce_gradients``); ``aux`` holds the global values.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from dalle_tpu_torch.config import SP_NONE, ModelConfig
from dalle_tpu_torch.models.transformer import (Dense, Transformer,
                                                column_input, tp_group,
                                                torch_dtype)
from dalle_tpu_torch.parallel import collectives

NEG_INF = -1e9


def _head_logits(h: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``h @ table^T`` in f32 from operands in h's dtype (exact products,
    f32 accumulation: ``preferred_element_type=float32``)."""
    return h.float() @ table.to(h.dtype).float().t()


def _segment_nll(h: torch.Tensor, table: torch.Tensor,
                 targets: torch.Tensor) -> torch.Tensor:
    """Per-token NLL of ``targets`` under the tied-head logits over one
    segment's vocabulary slice, (B, T). The JAX head's vocabulary chunking
    (``head_chunk``) bounds its training memory and gives the same values,
    so the port takes the logsumexp in one pass."""
    logp = torch.log_softmax(_head_logits(h, table), dim=-1)
    return -logp.gather(-1, targets[..., None].long())[..., 0]


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
        """Check that the mesh can run this model, and record each block
        kernel's fsdp dimension for the blocks' gathers."""
        from dalle_tpu_torch.parallel.sharding import (param_shardings,
                                                       param_specs)
        cfg, mesh = self.cfg, self.mesh
        if mesh.sp > 1 and cfg.sequence_parallel == SP_NONE:
            raise ValueError(
                f"mesh sp={mesh.sp} needs sequence_parallel 'ring' or "
                "'ulysses': the port shards the token axis over sp")
        if cfg.total_seq_len % mesh.sp:
            raise ValueError(f"sequence {cfg.total_seq_len} not divisible "
                             f"by sp={mesh.sp}")
        if cfg.heads % mesh.tp:
            raise ValueError(f"heads {cfg.heads} not divisible by "
                             f"tp={mesh.tp}")
        if not cfg.tied_embeddings:
            raise NotImplementedError(
                "a sharded mesh needs the tied head (the vocab-sharded "
                "token_emb)")
        rules, specs = param_specs(self), param_shardings(mesh, self)
        for name, spec in specs.items():
            if "tp" in rules[name] and "tp" not in spec:
                raise ValueError(
                    f"{name} {tuple(self.get_parameter(name).shape)} does "
                    f"not split over tp={mesh.tp}")
        self.shard_specs = specs
        self.whole_shapes = {n: tuple(p.shape)
                             for n, p in self.named_parameters()}
        self.transformer.set_fsdp_dims(
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
            if return_logits:
                raise NotImplementedError(
                    "return_logits on a sharded mesh: the logits are "
                    "vocab- and token-sharded")
            return self._mesh_forward(text_tokens, image_tokens, loss_mask)
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
                                    table[:cfg.vocab_text], text_tokens)
            nll_img = _segment_nll(h[:, cfg.text_seq_len:],
                                   table[cfg.vocab_text:cfg.vocab_total],
                                   image_tokens)

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


    def _embed(self, ids: torch.Tensor) -> torch.Tensor:
        """The token embedding; over ``tp`` each rank looks up the ids in
        its rows of the table and the lookups are summed."""
        group = tp_group(self.mesh)
        table = self.token_emb
        if group is None:
            return table[ids.long()]
        rows = table.shape[0]
        local = ids.long() - self.mesh.index("tp") * rows
        inside = (local >= 0) & (local < rows)
        x = table[local.clamp(0, rows - 1)] * inside[..., None].to(
            table.dtype)
        return collectives.all_reduce(x, group)

    def _segment_sums(self, h, lo: int, hi: int, targets, mask):
        """The (B, t) NLL of ``targets`` (ids into the vocabulary segment
        ``[lo, hi)``) under the tied head, masked by ``mask``; over ``tp``
        from this rank's rows of the segment."""
        group = tp_group(self.mesh)
        table = self.token_emb
        if group is None:
            nll = _segment_nll(h, table[lo:hi], targets)
        else:
            rows = table.shape[0]
            r0 = self.mesh.index("tp") * rows
            a, b = max(lo, r0), max(min(hi, r0 + rows), max(lo, r0))
            logits = _head_logits(h, table[a - r0:b - r0])
            nll = VocabParallelNLL.apply(logits, targets, a - lo, group)
        return nll * mask if mask is not None else nll

    def _mesh_forward(self, text_tokens, image_tokens, loss_mask):
        if not self.sharded:
            raise RuntimeError("the model was built for a sharded mesh: "
                               "call parallel.sharding.shard_train_state")
        cfg, mesh = self.cfg, self.mesh
        labels = torch.cat([text_tokens, image_tokens + cfg.vocab_text], 1)
        bos = torch.full((labels.shape[0], 1), self.bos_id,
                         dtype=labels.dtype, device=labels.device)
        inputs = torch.cat([bos, labels[:, :-1]], dim=1)
        tl = cfg.total_seq_len // mesh.sp
        t0 = mesh.index("sp") * tl
        inputs, labels = inputs[:, t0:t0 + tl], labels[:, t0:t0 + tl]
        mask = None if loss_mask is None else loss_mask[:, t0:t0 + tl]
        x = self._embed(inputs) + self.positional()[t0:t0 + tl][None]
        h = self.transformer(x.to(torch_dtype(cfg.dtype)), t0)
        h = column_input(h, self.mesh)

        n_text = min(max(cfg.text_seq_len - t0, 0), tl)
        axes = [mesh.group("batch"), mesh.group("sp")]
        parts = []
        for lo, hi, sl, offset in ((0, cfg.vocab_text, slice(0, n_text), 0),
                                   (cfg.vocab_text, cfg.vocab_total,
                                    slice(n_text, tl), cfg.vocab_text)):
            m = None if mask is None else mask[:, sl]
            if sl.stop > sl.start:
                nll_sum = self._segment_sums(h[:, sl], lo, hi,
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
