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
(:class:`VocabParallelNLL`). An untied head's ``lm_head/kernel`` (dim,
vocab_total) is ``P("fsdp", "tp")``: it is gathered over ``fsdp`` as the
blocks' kernels are, and each ``tp`` rank computes its columns of the
vocabulary (no BOS row, no padding); where ``tp`` does not divide
``vocab_total`` the axis is dropped (``param_shardings``) and every rank
computes the whole vocabulary, as JAX's replicated leaf does. Its returned
loss is this rank's part of the global loss (its tokens' sums over the
global denominators), so the gradients summed over the batch and sequence
axes are the global mesh's (``training/steps.reduce_gradients``); ``aux``
holds the global values. ``return_logits`` gives this process's rows of
the batch with the whole token axis and the whole vocabulary, summed
into place over ``tp`` and ``sp`` with the identity as backward (each
rank keeps its own tokens' and columns' part of the gradient).
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
                 targets: torch.Tensor) -> torch.Tensor:
    """Per-token NLL of ``targets`` under the tied-head logits over one
    segment's vocabulary slice, (B, T). The JAX head's vocabulary chunking
    (``head_chunk``) bounds its training memory and gives the same values,
    so the port takes the logsumexp in one pass."""
    return _nll(_head_logits(h, table), targets)


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
        rules, specs = param_specs(self), param_shardings(mesh, self)
        for name, spec in specs.items():
            # an untied head that tp does not divide computes the whole
            # vocabulary on every rank (JAX replicates the leaf)
            if ("tp" in rules[name] and "tp" not in spec
                    and name != "lm_head.kernel"):
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

    def _head_part(self) -> _HeadPart:
        """This rank's head: the tied table's rows over ``tp``, or the
        untied kernel gathered over ``fsdp`` (its backward reduce-scatters
        the gradient) with its columns over ``tp``."""
        mesh = self.mesh
        if self.cfg.tied_embeddings:
            group = tp_group(mesh)
            rows = self.token_emb.shape[0]
            c0 = mesh.index("tp") * rows if group is not None else 0
            return _HeadPart(self.token_emb, True, c0, rows, group)
        spec = self.shard_specs["lm_head.kernel"]
        kernel = self.lm_head.kernel
        if "fsdp" in spec and mesh.fsdp > 1:
            kernel = collectives.all_gather(kernel, spec.index("fsdp"),
                                            mesh.group("fsdp"))
        group = tp_group(mesh) if "tp" in spec else None
        cols = kernel.shape[1]
        c0 = mesh.index("tp") * cols if group is not None else 0
        return _HeadPart(kernel, False, c0, cols, group)

    def _segment_sums(self, h, head: _HeadPart, lo: int, hi: int, targets,
                      mask):
        """The (B, t) NLL of ``targets`` (ids into the vocabulary segment
        ``[lo, hi)``) under the head, masked by ``mask``; over ``tp`` from
        this rank's columns of the segment."""
        if head.group is None:
            nll = _nll(head.logits(h, lo, hi), targets)
        else:
            c0, c1 = head.c0, head.c0 + head.width
            a, b = max(lo, c0), max(min(hi, c1), max(lo, c0))
            nll = VocabParallelNLL.apply(head.logits(h, a, b), targets,
                                         a - lo, head.group)
        return nll * mask if mask is not None else nll

    def _mesh_logits(self, h, head: _HeadPart, t0: int) -> torch.Tensor:
        """This process's rows of the logits, (B, T, vocab_total) f32 with
        segment masking: its columns and tokens summed into place over
        ``tp`` and ``sp`` (the identity as backward)."""
        cfg, mesh = self.cfg, self.mesh
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
        if mesh.sp > 1:
            logits = collectives.all_reduce(
                nn.functional.pad(
                    logits, (0, 0, t0, cfg.total_seq_len - t0 - tl)),
                mesh.group("sp"))
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
        tl = cfg.total_seq_len // mesh.sp
        t0 = mesh.index("sp") * tl
        inputs, labels = inputs[:, t0:t0 + tl], labels[:, t0:t0 + tl]
        mask = None if loss_mask is None else loss_mask[:, t0:t0 + tl]
        x = self._embed(inputs) + self.positional()[t0:t0 + tl][None]
        h = self.transformer(x.to(torch_dtype(cfg.dtype)), t0)
        head = self._head_part()
        if head.group is not None:
            h = column_input(h, self.mesh)

        n_text = min(max(cfg.text_seq_len - t0, 0), tl)
        axes = [mesh.group("batch"), mesh.group("sp")]
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
