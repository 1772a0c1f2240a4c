"""The yardstick's arithmetic: the chip's peaks, the least time of a piece
of work, the classes of device kernels, and the operations and bytes that
the cells' shapes need.

The peaks, :func:`bound`, ``KERNEL_CLASSES`` and ``CUBLAS_MARKS`` are a
frozen copy of those in ``chip_smoke.py``; everything else counts work
from a configuration file's ``model`` sizes (``benchmark/configs``), never
from the program, so the base of every share stays put while the program
changes.

Counts follow the model's definition, not any kernel's: a matmul of an
(m, k) by a (k, n) operand is ``2 m k n`` operations; attention does
``4 * heads * head_dim`` operations per (query, key) pair that a layer's
mask allows in its forward pass and twice that in its backward pass; no
recomputation is counted.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict, List, Tuple

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM
BF16_FLOP_PER_S = 989e12       # dense bf16 tensor cores
F32_FLOP_PER_S = 67e12         # f32 outside the tensor cores
TF32_FLOP_PER_S = 495e12       # dense TF32 tensor cores


def bound(nbytes: float, flops: float, peak: float = BF16_FLOP_PER_S):
    """``(ms, what)``: the least time of moving ``nbytes`` and doing
    ``flops`` on the card, and which of the two sets it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


KERNEL_CLASSES = (
    ("_generic", "generic attention and GEGLU instances"),
    ("attn_fwd_kernel", "attention kernel, forward"),
    ("attn_bwd_", "attention kernels, backward (dq pass, dk/dv pass, "
                  "prefix dk/dv pass)"),
    ("geglu_bwd_kernel", "GEGLU backward kernel"),
    ("geglu_fwd_kernel", "GEGLU forward kernels"),
    ("ln_bwd_", "LayerNorm backward kernels (row pass, partial sum)"),
    ("_ln_fwd", "LayerNorm forward kernel"),
)
CUBLAS_MARKS = ("nvjet", "xmma", "gemm", "cutlass")
ELEMENTWISE = "PyTorch elementwise, copies, reductions"


def kernel_class(key: str) -> str:
    for mark, cls in KERNEL_CLASSES:
        if mark in key:
            return cls
    if any(m in key for m in CUBLAS_MARKS):
        return "cuBLAS GEMMs"
    return ELEMENTWISE


# ---------------------------------------------------------------------------
# the model's shapes (a configuration file's "model" dict)
# ---------------------------------------------------------------------------

def schedule(m: Dict) -> List[Tuple[int, str]]:
    """``(block id, attention type)`` of every layer: the body cycles
    ``shared_block_cycle`` blocks (every layer its own block at 0) over
    ``attn_types``; a final ``conv_like`` block (id -1) closes the stack
    where ``final_conv_block`` is set."""
    body = m["depth"] - (1 if m["final_conv_block"] else 0)
    cycle = m["shared_block_cycle"] or body
    out = []
    for i in range(body):
        uid = i % cycle
        out.append((uid, m["attn_types"][uid % len(m["attn_types"])]))
    if m["final_conv_block"]:
        out.append((-1, "conv_like"))
    return out


def inner(m: Dict) -> int:
    return m["ff_mult"] * m["dim"]


def layer_matmul_params(m: Dict) -> int:
    """Weights one layer application multiplies: q, k, v, out and the
    GEGLU's wi, gate and wo."""
    d = m["dim"]
    return 4 * d * d + 3 * d * inner(m)


def matmul_params(m: Dict) -> int:
    """Weights multiplied in one pass over all layers (a shared block
    counts once for each layer it serves)."""
    return m["depth"] * layer_matmul_params(m)


@lru_cache(maxsize=32)
def image_pairs(attn_type: str, grid: int, conv_kernel: int) -> int:
    """(query, key) pairs among image tokens that one head of a layer of
    ``attn_type`` allows (the text prefix not included)."""
    n = grid * grid
    if attn_type == "full":
        return n * (n + 1) // 2
    if attn_type in ("axial_row", "axial_col"):
        return grid * grid * (grid + 1) // 2
    if attn_type == "conv_like":
        hw = conv_kernel // 2
        q = np.arange(n)
        qr, qc = q // grid, q % grid
        total = 0
        for dr in range(-hw, 1):
            for dc in range(-hw, hw + 1):
                if dr == 0 and dc > 0:
                    continue
                kr, kc = qr + dr, qc + dc
                total += int(((kr >= 0) & (kc >= 0) & (kc < grid)).sum())
        return total
    raise ValueError(f"unknown attention type {attn_type!r}")


def text_pairs(m: Dict) -> int:
    t = m["text_seq_len"]
    return t * (t + 1) // 2


def layer_pairs(m: Dict, attn_type: str) -> int:
    """All (query, key) pairs one head of a layer allows: text causal,
    every image token over the whole text, and the image pairs."""
    n = m["image_grid"] ** 2
    return (text_pairs(m) + n * m["text_seq_len"]
            + image_pairs(attn_type, m["image_grid"], m["conv_kernel"]))


def tokens(m: Dict) -> int:
    return m["text_seq_len"] + m["image_grid"] ** 2


def head_flops_forward(m: Dict) -> int:
    """The tied head of one sample: text positions over the text
    vocabulary, image positions over the image vocabulary."""
    return 2 * m["dim"] * (m["text_seq_len"] * m["vocab_text"]
                           + m["image_grid"] ** 2 * m["vocab_image"])


def attention_flops_forward(m: Dict) -> int:
    """Attention operations of one sample's forward pass over all layers."""
    hd = m["heads"] * m["head_dim"]
    return sum(4 * hd * layer_pairs(m, t) for _, t in schedule(m))


def train_flops_per_image(m: Dict) -> int:
    """Operations one image costs a training step, forward and backward
    (3x the forward), without recomputation."""
    return (6 * matmul_params(m) * tokens(m)
            + 3 * attention_flops_forward(m) + 3 * head_flops_forward(m))


def attention_calls(m: Dict, attn_type: str):
    """The calls one layer makes, as ``(queries, prefix keys, pairs)``
    per head: the text call (causal, no prefix) and the image call (over
    the text prefix and the image keys its mask allows)."""
    t, n = m["text_seq_len"], m["image_grid"] ** 2
    return ((t, 0, text_pairs(m)),
            (n, t, n * t + image_pairs(attn_type, m["image_grid"],
                                       m["conv_kernel"])))


def attention_step_least_ms(m: Dict, samples: int, act_bytes: int = 2
                            ) -> float:
    """Least time (ms) of the attention work of ``samples`` samples'
    forward and backward passes: each call's operations at the bf16 peak
    or its bytes at the HBM rate, whichever is larger, summed. Forward
    reads q, k, v (and the prefix's k, v) and writes out and an f32
    logsumexp; backward reads q, k, v, out, the output's gradient, the
    logsumexp (and the prefix) and writes dq, dk, dv (and the prefix's)."""
    h, d = m["heads"], m["head_dim"]
    total = 0.0
    for _, attn_type in schedule(m):
        for q, p, pairs in attention_calls(m, attn_type):
            rows = samples * h
            tok = rows * q * d * act_bytes
            pre = rows * p * d * act_bytes
            lse = rows * q * 4
            fwd_bytes = 3 * tok + 2 * pre + tok + lse
            bwd_bytes = 5 * tok + 2 * pre + lse + 3 * tok + 2 * pre
            ops = 4 * d * pairs * rows
            total += bound(fwd_bytes, ops)[0] + bound(bwd_bytes, 2 * ops)[0]
    return total


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

@lru_cache(maxsize=32)
def _allowed_keys_mean(attn_type: str, text_len: int, grid: int,
                       conv_kernel: int) -> float:
    """Keys a query's mask allows, averaged over the positions
    ``0 .. T-1`` that a request decodes."""
    n = grid * grid
    total = text_pairs({"text_seq_len": text_len})
    total += n * text_len + image_pairs(attn_type, grid, conv_kernel)
    return total / (text_len + n)


def decode_step_work(m: Dict, live_slots: float, weight_bytes: int = 2,
                     cache_bytes: int = 2) -> Tuple[float, float]:
    """``(bytes, operations)`` of one decode position of ``live_slots``
    requests: the weights of every layer application read once (a shared
    block once for each layer it serves) and the tied head's table; each
    live slot's keys and values that its mask allows at its position,
    read once (averaged over the positions a request walks through), and
    its new key and value written; the matmuls and attention of each
    live slot."""
    d, v = m["dim"], m["vocab_text"] + m["vocab_image"]
    params = matmul_params(m) + v * d
    nbytes = params * weight_bytes
    ops = 2.0 * params * live_slots
    for _, attn_type in schedule(m):
        keys = _allowed_keys_mean(attn_type, m["text_seq_len"],
                                  m["image_grid"], m["conv_kernel"])
        nbytes += live_slots * (2 * keys + 2) * d * cache_bytes
        ops += live_slots * 4 * d * keys
    return nbytes, ops


def decode_step_least_s(m: Dict, live_slots: float) -> float:
    nbytes, ops = decode_step_work(m, live_slots)
    return bound(nbytes, ops)[0] / 1e3
