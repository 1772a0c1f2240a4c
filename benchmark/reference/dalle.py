"""The plain reference of the DALL-E model, in PyTorch alone: weights made
from a seed, the forward pass, the training loss and its gradients, and
the logits of a served sequence.

It imports nothing of the program and reads only a configuration file's
``model`` sizes (``benchmark/configs``). The parameters are a dict keyed
by the names the port gives its parameters (``param_specs``), so the
harness can hand one set of weights to both sides and compare them leaf
by leaf.

The model (learning-at-home/dalle ``task.py``, as the JAX package lays it
out): the sequence ``[BOS, text, image + vocab_text]`` shifted by one; the
token embedding plus learned positions (text, image row + column); each
layer a pre-norm block: LayerNorm, bias-free q/k/v projections, rotary
embedding on q and k, softmax attention under the layer's mask (text
causal; image tokens see all the text and, by layer type, every earlier
image token, their row or column up to themselves, or the raster-causal
``conv_kernel`` window), a biased output projection, then LayerNorm and
a GEGLU feed-forward ``wo((x wi + bi) * gelu_tanh(x wg + bg)) + bo``;
a final LayerNorm; the tied head over each segment's vocabulary (text
positions score text ids, image positions image ids); the loss
``(text NLL + w * image NLL) / (1 + w)`` with masked means.

Everything runs in float32 with TF32 off. ``prec="fp8"`` is the
control, the precision below the configuration's bfloat16 activations:
both operands of every matrix product, and the gradient in backward,
rounded to float8 e4m3 (one scale a tensor), and the residual stream
held in float8 between layers, as the program holds it in bfloat16.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

LN_EPS = 1e-6
NEG_INF = -1e9
FP8_MAX = 448.0
EMB_STD = 0.02

Params = Dict[str, torch.Tensor]


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ---------------------------------------------------------------------------
# parameters and weights
# ---------------------------------------------------------------------------

def schedule(m: Dict) -> List[Tuple[int, str]]:
    body = m["depth"] - (1 if m["final_conv_block"] else 0)
    cycle = m["shared_block_cycle"] or body
    out = [(i % cycle, m["attn_types"][(i % cycle) % len(m["attn_types"])])
           for i in range(body)]
    if m["final_conv_block"]:
        out.append((-1, "conv_like"))
    return out


def block_prefix(uid: int) -> str:
    name = "block_wconv" if uid == -1 else f"block_{uid}"
    return f"transformer.blocks.{name}."


def table_rows(m: Dict) -> int:
    """The tied table: every id plus BOS, rounded up to 128 rows."""
    total = m["vocab_text"] + m["vocab_image"] + 1
    return -(-total // 128) * 128


def param_specs(m: Dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """``(name, shape, kind)`` of every parameter; kind ``emb`` (normal,
    std 0.02), ``kernel`` (normal over sqrt(fan_in)), ``zeros`` or
    ``ones``."""
    d, k = m["dim"], m["ff_mult"] * m["dim"]
    specs = [("token_emb", (table_rows(m), d), "emb"),
             ("text_pos_emb", (m["text_seq_len"], d), "emb"),
             ("img_row_emb", (m["image_grid"], d), "emb"),
             ("img_col_emb", (m["image_grid"], d), "emb")]
    seen = []
    for uid, _ in schedule(m):
        if uid in seen:
            continue
        seen.append(uid)
        p = block_prefix(uid)
        specs += [(p + "attn_norm.scale", (d,), "ones"),
                  (p + "attn_norm.bias", (d,), "zeros"),
                  (p + "attn.q.kernel", (d, d), "kernel"),
                  (p + "attn.k.kernel", (d, d), "kernel"),
                  (p + "attn.v.kernel", (d, d), "kernel"),
                  (p + "attn.out.kernel", (d, d), "kernel"),
                  (p + "attn.out.bias", (d,), "zeros"),
                  (p + "ff_norm.scale", (d,), "ones"),
                  (p + "ff_norm.bias", (d,), "zeros"),
                  (p + "ff.wi.kernel", (d, k), "kernel"),
                  (p + "ff.wi.bias", (k,), "zeros"),
                  (p + "ff.gate.kernel", (d, k), "kernel"),
                  (p + "ff.gate.bias", (k,), "zeros"),
                  (p + "ff.wo.kernel", (k, d), "kernel"),
                  (p + "ff.wo.bias", (d,), "zeros")]
    specs += [("transformer.final_norm.scale", (d,), "ones"),
              ("transformer.final_norm.bias", (d,), "zeros")]
    return specs


def make_weights(m: Dict, seed: int, device, dtype=torch.float32) -> Params:
    """The weights of ``seed``: one normal draw on ``device`` for every
    embedding and kernel element, cut into leaves and scaled; biases 0,
    norm scales 1. The same seed gives the same weights."""
    specs = param_specs(m)
    drawn = sum(int(np.prod(s)) for _, s, kind in specs
                if kind in ("emb", "kernel"))
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(drawn, generator=gen, device=device,
                       dtype=torch.float32)
    out, at = {}, 0
    for name, shape, kind in specs:
        if kind == "zeros":
            out[name] = torch.zeros(shape, device=device, dtype=dtype)
        elif kind == "ones":
            out[name] = torch.ones(shape, device=device, dtype=dtype)
        else:
            n = int(np.prod(shape))
            scale = EMB_STD if kind == "emb" else shape[-2] ** -0.5
            out[name] = (flat[at:at + n].view(shape) * scale).to(dtype)
            at += n
    return out


# ---------------------------------------------------------------------------
# the forward pass
# ---------------------------------------------------------------------------

def _fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one scale a tensor."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class _Fp8Matmul(torch.autograd.Function):
    """``a @ b`` with both operands rounded to float8, and in backward
    the incoming gradient too, before each product."""

    @staticmethod
    def forward(ctx, a, b):
        a8, b8 = _fp8(a), _fp8(b)
        ctx.save_for_backward(a8, b8)
        return a8 @ b8

    @staticmethod
    def backward(ctx, g):
        a8, b8 = ctx.saved_tensors
        g8 = _fp8(g)
        da = g8 @ b8.transpose(-1, -2)
        db = a8.transpose(-1, -2) @ g8
        return (da.sum_to_size(a8.shape), db.sum_to_size(b8.shape))


class _Fp8Round(torch.autograd.Function):
    """An activation held in float8, as the program holds its activations
    in bfloat16: rounded on the way forward, its gradient on the way
    back."""

    @staticmethod
    def forward(ctx, x):
        return _fp8(x)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g)


def matmul(a: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    if prec == "fp8":
        return _Fp8Matmul.apply(a, b)
    return a @ b


def held(x: torch.Tensor, prec: str) -> torch.Tensor:
    """``x`` in the activation precision: itself in float32, rounded to
    float8 in the control."""
    return _Fp8Round.apply(x) if prec == "fp8" else x


@lru_cache(maxsize=16)
def _mask_np(attn_type: str, text_len: int, grid: int,
             conv_kernel: int) -> np.ndarray:
    n = grid * grid
    total = text_len + n
    idx = np.arange(total)
    mask = np.zeros((total, total), dtype=bool)
    mask[:text_len, :text_len] = idx[None, :text_len] <= idx[:text_len, None]
    mask[text_len:, :text_len] = True
    q = np.arange(n)
    qr, qc = q // grid, q % grid
    causal = q[None, :] <= q[:, None]
    if attn_type == "full":
        img = causal
    elif attn_type == "axial_row":
        img = (qr[None, :] == qr[:, None]) & causal
    elif attn_type == "axial_col":
        img = (qc[None, :] == qc[:, None]) & causal
    elif attn_type == "conv_like":
        hw = conv_kernel // 2
        img = ((np.abs(qr[None, :] - qr[:, None]) <= hw)
               & (np.abs(qc[None, :] - qc[:, None]) <= hw) & causal)
    else:
        raise ValueError(f"unknown attention type {attn_type!r}")
    mask[text_len:, text_len:] = img
    return mask


_MASKS: Dict[Tuple, torch.Tensor] = {}


def attention_mask(m: Dict, attn_type: str, device) -> torch.Tensor:
    key = (attn_type, m["text_seq_len"], m["image_grid"], m["conv_kernel"],
           str(device))
    if key not in _MASKS:
        _MASKS[key] = torch.from_numpy(_mask_np(*key[:4])).to(device)
    return _MASKS[key]


def rotary(t: int, head_dim: int, device) -> Tuple[torch.Tensor, ...]:
    half = head_dim // 2
    freqs = 1.0 / (10000.0 ** (torch.arange(half, dtype=torch.float64,
                                            device=device) / half))
    ang = torch.arange(t, dtype=torch.float64, device=device)[:, None] * freqs
    ang = torch.cat([ang, ang], dim=-1)
    return ang.cos().float(), ang.sin().float()


def _rotate(x, cos, sin):
    half = x.shape[-1] // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos[:, None, :] + rot * sin[:, None, :]


def _layer_norm(x, p: Params, name: str):
    return F.layer_norm(x, x.shape[-1:], p[name + ".scale"],
                        p[name + ".bias"], LN_EPS)


def _block(x, p: Params, pre: str, mask, rot, m: Dict, prec: str):
    b, t, d = x.shape
    h, hd = m["heads"], m["head_dim"]
    y = _layer_norm(x, p, pre + "attn_norm")
    q, k, v = (matmul(y, p[pre + f"attn.{n}.kernel"], prec).view(b, t, h, hd)
               for n in ("q", "k", "v"))
    if rot is not None:
        q, k = _rotate(q, *rot), _rotate(k, *rot)
    q, k, v = (z.transpose(1, 2) for z in (q, k, v))
    scores = matmul(q, k.transpose(-1, -2), prec) * hd ** -0.5
    probs = torch.softmax(scores.masked_fill(~mask, NEG_INF), dim=-1)
    ctx = matmul(probs, v, prec).transpose(1, 2).reshape(b, t, d)
    x = x + matmul(ctx, p[pre + "attn.out.kernel"], prec) \
        + p[pre + "attn.out.bias"]
    y = _layer_norm(x, p, pre + "ff_norm")
    hid = matmul(y, p[pre + "ff.wi.kernel"], prec) + p[pre + "ff.wi.bias"]
    gate = matmul(y, p[pre + "ff.gate.kernel"], prec) + p[pre + "ff.gate.bias"]
    out = matmul(hid * F.gelu(gate, approximate="tanh"),
                 p[pre + "ff.wo.kernel"], prec)
    return x + out + p[pre + "ff.wo.bias"]


def hidden(p: Params, m: Dict, inputs: torch.Tensor, prec: str = "f32",
           remat: bool = False) -> torch.Tensor:
    """The final-normed hidden states (B, T, dim) of ``inputs`` (B, T)."""
    t_len, grid, dim = m["text_seq_len"], m["image_grid"], m["dim"]
    pos = torch.cat([p["text_pos_emb"],
                     (p["img_row_emb"][:, None] + p["img_col_emb"][None])
                     .reshape(grid * grid, dim)])
    x = held(p["token_emb"][inputs] + pos[None], prec)
    rot = rotary(inputs.shape[1], m["head_dim"], x.device) \
        if m["rotary"] else None
    for uid, attn_type in schedule(m):
        args = (p, block_prefix(uid), attention_mask(m, attn_type, x.device),
                rot, m, prec)
        if remat:
            x = checkpoint(_block, x, *args, use_reentrant=False)
        else:
            x = _block(x, *args)
        x = held(x, prec)
    return held(_layer_norm(x, p, "transformer.final_norm"), prec)


def inputs_of(m: Dict, text: torch.Tensor, image: torch.Tensor):
    """``(inputs, labels)``: labels ``[text, image + vocab_text]`` and the
    inputs, BOS (id vocab_text + vocab_image) then the labels shifted."""
    labels = torch.cat([text.long(), image.long() + m["vocab_text"]], 1)
    bos = torch.full_like(labels[:, :1], m["vocab_text"] + m["vocab_image"])
    return torch.cat([bos, labels[:, :-1]], 1), labels


def _segment_nll(h, table, targets, prec):
    logits = matmul(h, table.t(), prec)
    return torch.logsumexp(logits, -1) - logits.gather(
        -1, targets[..., None])[..., 0]


def nll_sums(p: Params, m: Dict, text, image, mask=None, prec="f32",
             remat: bool = False):
    """``(sum of masked text NLL, sum of image NLL)`` over the rows."""
    inputs, _ = inputs_of(m, text, image)
    h = hidden(p, m, inputs, prec, remat)
    t, vt = m["text_seq_len"], m["vocab_text"]
    vocab = vt + m["vocab_image"]
    table = p["token_emb"]
    nt = _segment_nll(h[:, :t], table[:vt], text.long(), prec)
    ni = _segment_nll(h[:, t:], table[vt:vocab], image.long(), prec)
    if mask is not None:
        nt, ni = nt * mask[:, :t], ni * mask[:, t:]
    return nt.sum(), ni.sum()


def loss_and_grads(p: Params, m: Dict, batch: Dict[str, torch.Tensor],
                   accum: int, rows: int, prec: str = "f32"
                   ) -> Tuple[float, Dict[str, torch.Tensor]]:
    """The mean loss over ``accum`` micro-batches and the mean of their
    gradients (f32), each micro-batch's loss taken with its own masked
    denominators, computed ``rows`` samples at a time with every layer
    rematerialised so that it fits beside a cell."""
    n = batch["text"].shape[0]
    mb = n // accum
    leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
    grads = {k: torch.zeros_like(v) for k, v in p.items()}
    w = m["loss_img_weight"]
    t = m["text_seq_len"]
    loss = 0.0
    for i in range(accum):
        sl = slice(i * mb, (i + 1) * mb)
        text, image = batch["text"][sl], batch["image"][sl]
        mask = batch.get("mask")
        mask = None if mask is None else mask[sl].float()
        if mask is None:
            dt, di = float(mb * t), float(mb * image.shape[1])
        else:
            dt = max(float(mask[:, :t].sum()), 1.0)
            di = max(float(mask[:, t:].sum()), 1.0)
        for a in range(0, mb, rows):
            r = slice(a, min(a + rows, mb))
            st, si = nll_sums(leaves, m, text[r], image[r],
                              None if mask is None else mask[r], prec,
                              remat=True)
            part = (st / dt + w * si / di) / (1.0 + w)
            g = torch.autograd.grad(part, list(leaves.values()),
                                    allow_unused=True)
            for (k, _), gi in zip(leaves.items(), g):
                if gi is not None:
                    grads[k] += gi
            loss += float(part.detach())
    for g in grads.values():
        g /= accum
    return loss / accum, grads


@torch.no_grad()
def image_logits(p: Params, m: Dict, text: torch.Tensor,
                 codes: torch.Tensor, prec: str = "f32") -> torch.Tensor:
    """The image-segment logits (n_codes, vocab_image) of one served
    sequence: the caption ``text`` (text_seq_len,) and the codes
    (image_seq_len,) that were served; row j scores code j given
    everything before it."""
    inputs, _ = inputs_of(m, text[None], codes[None])
    h = hidden(p, m, inputs, prec)[0, m["text_seq_len"]:]
    vt = m["vocab_text"]
    return matmul(h, p["token_emb"][vt:vt + m["vocab_image"]].t(), prec)
