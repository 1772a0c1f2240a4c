"""KV-cached autoregressive image generation (counterpart of
``dalle_tpu/models/decode.py``, the lockstep path: every batch row at one
scalar position).

The incremental math mirrors the blocks of ``transformer.py`` on one
position (LayerNorm -> q/k/v -> rotary -> masked single-query attention
against the cache -> out -> GEGLU FF) and reads the same parameters. As in
the JAX decode it runs no kernel: the LayerNorm here is the two-pass
variance of ``decode._ln`` and the FF is the unfused ``h * gelu(gate)``.

The cache holds one k/v pair per layer application (weight sharing shares
parameters, not activations), ``(n_layers, B, T, H*d)``, and is updated in
place. Attention reads the cache up to the current position: the positions
past it are masked in the JAX decode, so the result is the same.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch
import torch.nn.functional as F

from dalle_tpu_torch.models.attention import (NEG_INF, apply_rotary,
                                              dense_attention,
                                              rotary_cos_sin,
                                              zoo_attention_mask)
from dalle_tpu_torch.models.dalle import DALLE
from dalle_tpu_torch.models.transformer import block_name, torch_dtype

LN_EPS = 1e-6


class SamplingConfig(NamedTuple):
    temperature: float = 1.0
    top_k: int = 0          # 0 = disabled
    top_p: float = 1.0      # 1.0 = disabled


def init_cache(cfg, batch: int, device, dtype=None) -> Dict[str, torch.Tensor]:
    """Zeroed (n_layers, B, T, H*d) k and v caches."""
    dtype = dtype or torch_dtype(cfg.dtype)
    shape = (len(cfg.layer_schedule()), batch, cfg.total_seq_len, cfg.dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _ln(x, norm, dtype):
    """``decode._ln``: f32 statistics with the two-pass variance."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + LN_EPS)
    return (y * norm.scale.float() + norm.bias.float()).to(dtype)


def decode_tables(cfg, device) -> Dict:
    """What every position reads: the (T, T) mask of each attention type
    and the rotary cos/sin table (T, d), on ``device``. A caller looping
    over positions builds them once."""
    masks = {t: torch.from_numpy(zoo_attention_mask(
        t, cfg.text_seq_len, cfg.image_grid, cfg.conv_kernel)).to(device)
        for t in {a for _, a in cfg.layer_schedule()}}
    cos, sin = rotary_cos_sin(torch.arange(cfg.total_seq_len, device=device),
                              cfg.head_dim)
    return {"masks": masks, "cos": cos, "sin": sin}


def _apply_block(x, blk, attn_type, li, cache, pos, rot, mask_row, cfg,
                 dtype):
    b = x.shape[0]
    h = _ln(x, blk.attn_norm, dtype)
    a = blk.attn
    q, k, v = ((h @ p.kernel.to(dtype)).reshape(b, cfg.heads, cfg.head_dim)
               for p in (a.q, a.k, a.v))
    if rot is not None:
        cos, sin = rot
        q, k = apply_rotary(q, cos, sin), apply_rotary(k, cos, sin)
    cache["k"][li, :, pos] = k.reshape(b, cfg.dim)
    cache["v"][li, :, pos] = v.reshape(b, cfg.dim)
    vis = pos + 1
    k_view, v_view = (cache[n][li, :, :vis].reshape(
        b, vis, cfg.heads, cfg.head_dim).to(dtype) for n in ("k", "v"))
    ctx = dense_attention(q[:, None], k_view, v_view, mask_row[:vis])
    x = x + (ctx.reshape(b, cfg.dim) @ a.out.kernel.to(dtype)
             + a.out.bias.to(dtype))
    h = _ln(x, blk.ff_norm, dtype)
    ff = blk.ff
    hh = h @ ff.wi.kernel.to(dtype) + ff.wi.bias.to(dtype)
    gate = h @ ff.gate.kernel.to(dtype) + ff.gate.bias.to(dtype)
    return x + ((hh * F.gelu(gate, approximate="tanh"))
                @ ff.wo.kernel.to(dtype) + ff.wo.bias.to(dtype))


@torch.no_grad()
def decode_step(model: DALLE, cache: Dict[str, torch.Tensor],
                input_ids: torch.Tensor, pos: int, tables=None):
    """One cached step at the scalar position ``pos``: input_ids (B,)
    combined-vocabulary ids (BOS included). Returns the segment-masked f32
    logits over the full combined vocabulary, (B, vocab_total), and the
    cache (updated in place). ``tables``: :func:`decode_tables`."""
    cfg = model.cfg
    dtype = torch_dtype(cfg.dtype)
    device = model.token_emb.device
    tables = tables if tables is not None else decode_tables(cfg, device)
    if pos < cfg.text_seq_len:
        pos_emb = model.text_pos_emb[pos]
    else:
        r, c = divmod(pos - cfg.text_seq_len, cfg.image_grid)
        pos_emb = model.img_row_emb[r] + model.img_col_emb[c]
    x = (model.token_emb[input_ids.long()] + pos_emb).to(dtype)
    rot = None
    if cfg.rotary:
        rot = (tables["cos"][pos][None, None], tables["sin"][pos][None, None])
    blocks = model.transformer.blocks
    for li, (uid, attn_type) in enumerate(cfg.layer_schedule()):
        x = _apply_block(x, blocks[block_name(uid)], attn_type, li, cache,
                         pos, rot, tables["masks"][attn_type][pos], cfg,
                         dtype)
    x = _ln(x, model.transformer.final_norm, dtype)
    if cfg.tied_embeddings:
        logits = x.float() @ model.token_emb[:cfg.vocab_total].to(
            dtype).float().t()
    else:
        logits = (x @ model.lm_head.kernel.to(dtype)).float()
    vocab_is_text = torch.arange(cfg.vocab_total, device=device) \
        < cfg.vocab_text
    valid = vocab_is_text if pos < cfg.text_seq_len else ~vocab_is_text
    logits = torch.where(valid[None], logits, NEG_INF)
    return logits, cache


def sample_logits(logits: torch.Tensor, cfg: SamplingConfig,
                  generator: torch.Generator) -> torch.Tensor:
    """Temperature / top-k / top-p sampling, (B, V) -> (B,) int64, with
    the JAX package's thresholds (``decode.sample_logits``, static knobs).
    ``temperature == 0`` is greedy argmax. The draw is Gumbel-max, as
    ``jax.random.categorical`` is, with noise from ``generator``."""
    if cfg.temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits / cfg.temperature
    if cfg.top_k and cfg.top_k > 0:
        kth = torch.sort(logits, dim=-1).values[:, -cfg.top_k][:, None]
        logits = torch.where(logits < kth,
                             NEG_INF,
                             logits)
    if cfg.top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep = cum - probs < cfg.top_p
        threshold = torch.where(keep, sorted_logits,
                                float("inf")).amin(-1)
        logits = torch.where(logits < threshold[:, None],
                             NEG_INF,
                             logits)
    u = torch.rand(logits.shape, generator=generator,
                   device=generator.device).to(logits.device)
    u = u.clamp(min=torch.finfo(u.dtype).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


@torch.no_grad()
def generate_images(model: DALLE, text_tokens: torch.Tensor,
                    generator: torch.Generator,
                    sampling: SamplingConfig = SamplingConfig()
                    ) -> torch.Tensor:
    """Sample (B, image_seq_len) VQGAN codes for the captions (B,
    text_seq_len): the text is teacher-forced, image positions sample from
    the segment-masked logits."""
    cfg = model.cfg
    device = model.token_emb.device
    b = text_tokens.shape[0]
    cache = init_cache(cfg, b, device)
    tables = decode_tables(cfg, device)
    cur = torch.full((b,), cfg.vocab_total, dtype=torch.long, device=device)
    codes = []
    for pos in range(cfg.total_seq_len):
        logits, cache = decode_step(model, cache, cur, pos, tables)
        # position pos emits S_pos, the input at pos + 1: the caption
        # while pos is a text position, the sampled code after
        if pos < cfg.text_seq_len:
            cur = text_tokens[:, pos].long()
        else:
            cur = sample_logits(logits, sampling, generator)
            codes.append(cur)
    return torch.stack(codes, dim=1) - cfg.vocab_text
