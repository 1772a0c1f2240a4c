"""The DALL-E text-to-image model in PyTorch (counterpart of
``dalle_tpu/models/dalle.py``).

Sequence layout, kept from the JAX model: it scores the unshifted sequence
``S = [text || image + vocab_text]``; position ``p`` receives the previous
token's embedding (BOS, id ``vocab_total``, at p=0) and predicts ``S_p``.
One tied table over ``vocab_total + 1`` rows rounded up to a multiple of
128; text positions may only predict text ids and image positions only image
ids (segment masking with -1e9).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from dalle_tpu_torch.config import ModelConfig
from dalle_tpu_torch.models.transformer import (Dense, Transformer,
                                                torch_dtype)

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


class DALLE(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        cfg.validate()
        self.cfg = cfg
        pd = torch_dtype(cfg.param_dtype)
        rows = -(-(cfg.vocab_total + 1) // 128) * 128
        self.token_emb = nn.Parameter(torch.zeros(rows, cfg.dim, dtype=pd))
        self.text_pos_emb = nn.Parameter(
            torch.zeros(cfg.text_seq_len, cfg.dim, dtype=pd))
        self.img_row_emb = nn.Parameter(
            torch.zeros(cfg.image_grid, cfg.dim, dtype=pd))
        self.img_col_emb = nn.Parameter(
            torch.zeros(cfg.image_grid, cfg.dim, dtype=pd))
        self.transformer = Transformer(cfg)
        self.lm_head = (None if cfg.tied_embeddings else
                        Dense(cfg.dim, cfg.vocab_total, False, pd))

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
        (B, T) multiplier."""
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


@torch.no_grad()
def init_params(cfg: ModelConfig, generator: torch.Generator) -> DALLE:
    """A DALLE on the generator's device with random weights drawn from
    ``generator``: embeddings N(0, 0.02),
    dense kernels lecun-normal (truncated normal, std 1/sqrt(fan_in)),
    biases zero, LayerNorm scale 1 and bias 0 -- the flax initialisers."""
    model = DALLE(cfg).to(generator.device)
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
            p.copy_(w / 0.87962566103423978 / math.sqrt(p.shape[0]))
    return model
