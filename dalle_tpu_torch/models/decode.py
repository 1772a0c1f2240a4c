"""KV-cached autoregressive image generation (counterpart of
``dalle_tpu/models/decode.py``).

The incremental math mirrors the blocks of ``transformer.py`` on one
position (LayerNorm -> q/k/v -> rotary -> masked single-query attention
against the cache -> out -> GEGLU FF) and reads the same parameters (a
stacked ``dense_scan`` model's layer its repetition's slice, as JAX
``decode.layer_params`` does). As in
the JAX decode it runs no kernel: the LayerNorm here is the two-pass
variance of ``decode._ln`` and the FF is the unfused ``h * gelu(gate)``.

The cache holds one k/v pair per layer application (weight sharing shares
parameters, not activations), ``(n_layers, B, T, H*d)``, and is updated in
place.

:func:`decode_step` takes a scalar position (every batch row at one
position, the lockstep path) or a (B,) position tensor (each row at its
own position: the serving engine's per-slot decode, which runs without a
host sync and so can be captured in a CUDA graph). ``visible`` bounds the
attention's cache read to ``[0, visible)``; without it the scalar path
reads up to the position and the vector path the whole cache.

Sampling draws Gumbel noise that is a counter-based function of (request
seed, position, vocabulary index) (:func:`gumbel_noise`), so a request's
codes depend neither on its batch row nor on the other rows, and no
generator state has to be carried from one position to the next.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import torch
import torch.nn.functional as F

from dalle_tpu_torch.models.attention import (NEG_INF, apply_rotary,
                                              dense_attention,
                                              rotary_cos_sin,
                                              zoo_attention_mask)
from dalle_tpu_torch.models.dalle import DALLE
from dalle_tpu_torch.models.transformer import bound, torch_dtype

LN_EPS = 1e-6


class SamplingConfig(NamedTuple):
    """Python scalars, or (B,) tensors: one setting a row (the serving
    engine's per-slot knobs)."""

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


def bucket_bounds(total: int, n_buckets: int) -> List[int]:
    """Prefix-bucket upper bounds over ``total`` positions (clamped to
    [1, total] buckets). One definition for the lockstep
    ``generate_images`` and the serving engine's per-chunk visible choice:
    the two must truncate identically to give the same codes."""
    n = max(1, min(int(n_buckets), total))
    return [round(total * (i + 1) / n) for i in range(n)]


def resolve_buckets(buckets: Optional[int], batch: int) -> int:
    """The adaptive prefix-bucket count (``buckets=None``): the JAX
    package's choice, 4 buckets for batches up to 8, else 2."""
    if buckets is None:
        return 4 if batch <= 8 else 2
    return buckets


def _apply_block(x, blk, li, cache, pos, vis, rot, mask_rows, cfg, dtype):
    """One cached block application, (B, dim) -> (B, dim). ``pos`` is an
    int (every row writes its k/v at one position) or a (B,) tensor (row
    i writes at ``pos[i]``); ``mask_rows`` is (vis,) or (B, vis)."""
    b = x.shape[0]
    h = _ln(x, blk.attn_norm, dtype)
    a = blk.attn
    q, k, v = ((h @ p.kernel.to(dtype)).reshape(b, cfg.heads, cfg.head_dim)
               for p in (a.q, a.k, a.v))
    if rot is not None:
        cos, sin = rot
        q, k = apply_rotary(q, cos, sin), apply_rotary(k, cos, sin)
    if isinstance(pos, int):
        cache["k"][li, :, pos] = k.reshape(b, cfg.dim)
        cache["v"][li, :, pos] = v.reshape(b, cfg.dim)
        mask = mask_rows
    else:
        rows = torch.arange(b, device=x.device)
        cache["k"][li, rows, pos] = k.reshape(b, cfg.dim)
        cache["v"][li, rows, pos] = v.reshape(b, cfg.dim)
        mask = mask_rows[:, None, None, :]
    k_view, v_view = (cache[n][li, :, :vis].reshape(
        b, vis, cfg.heads, cfg.head_dim).to(dtype) for n in ("k", "v"))
    ctx = dense_attention(q[:, None], k_view, v_view, mask)
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
                input_ids: torch.Tensor, pos, tables=None,
                visible: Optional[int] = None):
    """One cached step. input_ids (B,) combined-vocabulary ids (BOS
    included) at ``pos``: an int (the whole batch at one position) or a
    (B,) integer tensor (row i at ``pos[i]``; nothing here reads a tensor
    value on the host). Returns the segment-masked f32 logits over the
    full combined vocabulary, (B, vocab_total), and the cache (updated in
    place). ``tables``: :func:`decode_tables`. ``visible`` (a static
    int, greater than every position): read the cache rows
    ``[0, visible)``; None reads up to ``pos`` (int) or all of it
    (tensor)."""
    cfg = model.cfg
    dtype = torch_dtype(cfg.dtype)
    device = model.token_emb.device
    tables = tables if tables is not None else decode_tables(cfg, device)
    scalar = isinstance(pos, int)
    if scalar:
        vis = pos + 1 if visible is None else visible
        if pos < cfg.text_seq_len:
            pos_emb = model.text_pos_emb[pos]
        else:
            r, c = divmod(pos - cfg.text_seq_len, cfg.image_grid)
            pos_emb = model.img_row_emb[r] + model.img_col_emb[c]
    else:
        vis = cfg.total_seq_len if visible is None else visible
        pos_emb = model.positional()[pos]
    x = (model.token_emb[input_ids.long()] + pos_emb).to(dtype)
    rot = None
    if cfg.rotary:
        cos, sin = tables["cos"][pos], tables["sin"][pos]
        rot = ((cos[None, None], sin[None, None]) if scalar
               else (cos[:, None], sin[:, None]))
    layers = model.transformer.layers()
    for li, (_, attn_type) in enumerate(cfg.layer_schedule()):
        blk, params = layers[li]
        with bound(params):
            x = _apply_block(x, blk, li, cache, pos, vis, rot,
                             tables["masks"][attn_type][pos][..., :vis],
                             cfg, dtype)
    x = _ln(x, model.transformer.final_norm, dtype)
    if cfg.tied_embeddings:
        logits = x.float() @ model.token_emb[:cfg.vocab_total].to(
            dtype).float().t()
    else:
        logits = (x @ model.lm_head.kernel.to(dtype)).float()
    vocab_is_text = torch.arange(cfg.vocab_total, device=device) \
        < cfg.vocab_text
    if scalar:
        valid = (vocab_is_text if pos < cfg.text_seq_len
                 else ~vocab_is_text)[None]
    else:
        valid = vocab_is_text[None] == (pos < cfg.text_seq_len)[:, None]
    logits = torch.where(valid, logits, NEG_INF)
    return logits, cache


_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for x in [0, 2**32) held in int64, without an
    intermediate past 2**48 (no signed overflow)."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer finaliser (xor-shift-multiply), on int64 tensors
    holding values in [0, 2**32): the same bits on any device."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """32-bit hashes (int64 in [0, 2**32)) -> f32 uniforms on the grid
    ``(i + 1/2) / 2**23``: strictly inside (0, 1), since 2**23 - 1/2 is
    exact in f32 (a 24-bit grid would round its top value to 1.0, whose
    Gumbel noise is +inf)."""
    return ((bits >> 9).float() + 0.5) * 2.0 ** -23


def gumbel_noise(seeds: torch.Tensor, pos, vocab: int) -> torch.Tensor:
    """(B, vocab) f32 Gumbel noise, a function of (seed, position,
    vocabulary index) alone: ``seeds`` (B,) int64, ``pos`` an int or a
    (B,) tensor. The counter hash runs in int64 tensor ops, so the CPU and
    the card draw the same uniform bits (:func:`uniform_from_bits`); the
    logs may round differently there."""
    seeds = seeds.long()
    pos = torch.as_tensor(pos, device=seeds.device).long().expand_as(seeds)
    row = _mix32((seeds >> 32) & _M32 ^ 0x9E3779B9)
    row = _mix32(row ^ (seeds & _M32))
    row = _mix32(row ^ _mix32((pos & _M32) ^ 0x85EBCA6B))
    col = _mix32(torch.arange(vocab, device=seeds.device) ^ 0xC2B2AE35)
    bits = _mix32(_mix32(row[:, None] ^ col[None]) ^ row[:, None])
    return -torch.log(-torch.log(uniform_from_bits(bits)))


def _per_row(value, batch: int, dtype, device) -> torch.Tensor:
    return torch.as_tensor(value, dtype=dtype, device=device).expand(batch)


def sample_logits(logits: torch.Tensor, sampling: SamplingConfig,
                  noise: torch.Tensor) -> torch.Tensor:
    """Temperature / top-k / top-p sampling, (B, V) -> (B,) int64, the
    counterpart of ``decode._sample_logits_traced``: every stage runs and
    is switched per row by ``where`` on its knob (scalar knobs apply to
    every row), with the JAX package's thresholds. ``temperature == 0``
    is greedy argmax (a safe divisor keeps the unused branch finite);
    top-k keeps the values not below the k-th largest (``sort`` then the
    element at ``V - clamp(k, 1, V)``, ``k <= 0`` keeps all); top-p keeps
    the smallest sorted prefix with mass ``>= p``. The draw is Gumbel-max,
    as ``jax.random.categorical`` is, on ``noise`` (:func:`gumbel_noise`).
    Nothing here reads a tensor value on the host."""
    b, v = logits.shape
    dev = logits.device
    temp = _per_row(sampling.temperature, b, logits.dtype, dev)
    top_k = _per_row(sampling.top_k, b, torch.long, dev)
    top_p = _per_row(sampling.top_p, b, logits.dtype, dev)
    greedy = torch.argmax(logits, dim=-1)
    is_greedy = temp == 0.0
    x = logits / torch.where(is_greedy, torch.ones_like(temp), temp)[:, None]
    k_eff = torch.clamp(top_k, 1, v)
    kth = torch.sort(x, dim=-1).values.gather(1, (v - k_eff)[:, None])
    x = torch.where((top_k > 0)[:, None] & (x < kth), NEG_INF, x)
    sorted_x = torch.sort(x, dim=-1, descending=True).values
    probs = torch.softmax(sorted_x, dim=-1)
    keep = torch.cumsum(probs, dim=-1) - probs < top_p[:, None]
    threshold = torch.where(keep, sorted_x, float("inf")).amin(-1)
    x = torch.where((top_p < 1.0)[:, None] & (x < threshold[:, None]),
                    NEG_INF, x)
    sampled = torch.argmax(x + noise, dim=-1)
    return torch.where(is_greedy, greedy, sampled)


@torch.no_grad()
def generate_images(model: DALLE, text_tokens: torch.Tensor, seeds,
                    sampling: SamplingConfig = SamplingConfig(),
                    buckets: Optional[int] = None) -> torch.Tensor:
    """Sample (B, image_seq_len) VQGAN codes for the captions (B,
    text_seq_len), row i with the noise of ``seeds[i]``: the text is
    teacher-forced, image positions sample from the segment-masked logits.
    Positions in the prefix bucket ``[lo, hi)`` read the cache rows
    ``[0, hi)`` (:func:`bucket_bounds`, ``buckets=None``:
    :func:`resolve_buckets`), as the serving engine does."""
    cfg = model.cfg
    device = model.token_emb.device
    b = text_tokens.shape[0]
    seeds = torch.as_tensor(seeds, dtype=torch.long).to(device)
    cache = init_cache(cfg, b, device)
    tables = decode_tables(cfg, device)
    cur = torch.full((b,), cfg.vocab_total, dtype=torch.long, device=device)
    codes = []
    lo = 0
    for hi in bucket_bounds(cfg.total_seq_len, resolve_buckets(buckets, b)):
        for pos in range(lo, hi):
            logits, cache = decode_step(model, cache, cur, pos, tables,
                                        visible=hi)
            # position pos emits S_pos, the input at pos + 1: the caption
            # while pos is a text position, the sampled code after
            if pos < cfg.text_seq_len:
                cur = text_tokens[:, pos].long()
            else:
                cur = sample_logits(logits, sampling, gumbel_noise(
                    seeds, pos, cfg.vocab_total))
                codes.append(cur)
        lo = max(lo, hi)
    return torch.stack(codes, dim=1) - cfg.vocab_text
