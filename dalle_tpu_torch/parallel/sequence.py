"""Sequence/context parallelism over the mesh's ``sp`` axis (counterpart of
``dalle_tpu/parallel/sequence.py``).

Under ``sequence_parallel`` "ring" or "ulysses" the token axis shards over
the ``sp`` ranks (with "none" they are replicas that run whole sequences,
``models.transformer.token_shards``): each holds one contiguous slice of
every sequence (``models/dalle.py`` cuts it), and attention, the
one layer that mixes tokens, runs as one of two programs whose collectives
are ``parallel/collectives.py``'s:

- **Ring attention** (:func:`ring_attention`) for ``full`` (plain-causal)
  layers: k/v blocks rotate around the ring while a flash-style online
  softmax accumulates each query block's attention over every key block,
  in the zigzag layout that balances the causal work. The per-step update
  is plain torch (``einsum``, ``exp``), as JAX's is plain ``jnp``: the
  JAX package runs no Pallas kernel here either.
- **Ulysses all-to-all** (:func:`ulysses_attention`) for the whole zoo: one
  all-to-all trades the sequence sharding of the stacked q/k/v for head
  sharding, the zoo's kernels (``models/attention.zoo_attention_halves``:
  the hand-written line and window kernels) run on the full sequence for
  ``H/(tp*sp)`` heads, and a second all-to-all restores the sequence
  sharding.

:func:`sp_zoo_attention` dispatches: ring for ``full`` layers when
``mode="ring"``, Ulysses otherwise, with every ``ValueError`` the JAX
function raises (:func:`check_sp`). Where JAX's takes global arrays and
maps the body over the mesh, the port's takes this rank's shards, (B/(dp *
fsdp), T/sp, H/tp, d), and returns this rank's shard of the output.
"""

from __future__ import annotations

from typing import Tuple

import torch

from dalle_tpu_torch.config import ATTN_FULL, SP_RING, SP_ULYSSES
from dalle_tpu_torch.parallel.collectives import all_to_all, ppermute

BATCH_AXES: Tuple[str, ...] = ("dp", "fsdp")


def _update(stats, qc, kc, vc, scale, mask=None):
    """One flash-accumulation step of q-chunk against k/v-chunk: scores
    and the P.V product in f32 from the operands (``preferred_element_type
    =float32``), the probabilities cast to v's dtype first."""
    m, l, acc = stats
    s = torch.einsum("bqhd,bkhd->bhqk", qc.float(), kc.float()) * scale
    if mask is not None:
        s = s.masked_fill(~mask, float("-inf"))
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    alpha = torch.exp(m - m_new)
    l_new = l * alpha + p.sum(dim=-1)
    acc_new = acc * alpha[..., None] + torch.einsum(
        "bhqk,bkhd->bhqd", p.to(vc.dtype).float(), vc.float())
    return m_new, l_new, acc_new


def zigzag_perms(n: int):
    """The entry re-deal's two permutations: chunk ``C_j`` (of ``2n``) lives
    on rank ``j // 2`` (its low half iff ``j`` even) and is owned in the
    zigzag layout by rank ``min(j, 2n-1-j)``."""
    low = [(i, 2 * i if 2 * i < n else 2 * n - 1 - 2 * i) for i in range(n)]
    high = [(i, 2 * i + 1 if 2 * i + 1 < n else 2 * n - 2 - 2 * i)
            for i in range(n)]
    return low, high


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   group, n_shards: int, index: int) -> torch.Tensor:
    """Zigzag ring attention on this rank's shard (``ring_attention`` of the
    JAX package, one rank of the ``shard_map``).

    q/k/v: (B, T/sp, H, d) local sequence shards, contiguous in and out
    (shard ``i`` holds global positions ``[i*T/sp, (i+1)*T/sp)``); global
    semantics: plain causal attention over the full sequence, the zoo's
    ``full`` type. ``index`` is this rank's position on the ring.

    The sequence splits into ``2*sp`` chunks and rank ``i`` works on chunks
    ``(i, 2*sp-1-i)`` (A early, B late). The peeled local step runs A x A
    (diagonal mask), B x A and B x B (diagonal); ring step ``r`` holds the
    k/v pair of shard ``s = (i - r) mod sp`` and runs B x A_s (always
    allowed) and one of A x A_s (``r <= i``) / B x B_s. Each exchange is one
    collective (the re-deal's two permutations together, the ring's four
    rotating tensors together), so every rank's backward runs the same
    collectives in the same order whichever chunks its own control flow
    used.
    """
    b, tl, h, d = q.shape
    n, idx = n_shards, index
    scale = d ** -0.5
    if tl % 2:
        raise ValueError(f"zigzag ring needs an even local shard, got {tl}")
    half = tl // 2
    low_perm, high_perm = zigzag_perms(n)
    inv_low = [(dst, src) for (src, dst) in low_perm]
    inv_high = [(dst, src) for (src, dst) in high_perm]
    even = idx % 2 == 0     # rank i's A-chunk C_i is a low half iff i even

    # -- entry re-deal: contiguous (C_{2i} || C_{2i+1}) -> (A, B) ---------
    qkv = torch.stack((q, k, v))                    # (3, B, Tl, H, d)
    lo, hi = ppermute(torch.stack((qkv[:, :, :half], qkv[:, :, half:])),
                      (low_perm, high_perm), group).unbind(0)
    a, bch = (lo, hi) if even else (hi, lo)
    qa, ka, va = a.unbind(0)
    qb, kb, vb = bch.unbind(0)

    def fresh():
        return (q.new_full((b, h, half), float("-inf"), dtype=torch.float32),
                q.new_zeros((b, h, half), dtype=torch.float32),
                q.new_zeros((b, h, half, d), dtype=torch.float32))

    # -- peeled local step (the only masked products: the two diagonals) --
    diag = torch.ones((half, half), dtype=torch.bool,
                      device=q.device).tril()
    stats_a = _update(fresh(), qa, ka, va, scale, mask=diag)
    stats_b = _update(_update(fresh(), qb, ka, va, scale), qb, kb, vb,
                      scale, mask=diag)

    # -- ring: rotate the zigzag k/v pair; two unmasked products a step ---
    ring = [(j, (j + 1) % n) for j in range(n)]
    kv = torch.stack((ka, kb, va, vb))
    for r in range(1, n):
        kv = ppermute(kv[None], (ring,), group)[0]
        ka_n, kb_n, va_n, vb_n = kv.unbind(0)
        # after r rotations this rank holds shard s = (i - r) mod n's pair
        stats_b = _update(stats_b, qb, ka_n, va_n, scale)  # B x A_s
        if r <= idx:                                       # s < i
            stats_a = _update(stats_a, qa, ka_n, va_n, scale)
        else:
            stats_b = _update(stats_b, qb, kb_n, vb_n, scale)

    def finish(stats):
        m, l, acc = stats
        return (acc / l[..., None]).transpose(1, 2)       # (B, half, H, d)

    out_a, out_b = finish(stats_a), finish(stats_b)

    # -- exit re-deal: (A, B) -> contiguous local halves ------------------
    pair = (out_a, out_b) if even else (out_b, out_a)
    lo, hi = ppermute(torch.stack(pair), (inv_low, inv_high),
                      group).unbind(0)
    return torch.cat([lo, hi], dim=1).to(q.dtype)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      group, attn_type: str, text_len: int, grid: int,
                      conv_kernel: int, saved=None) -> torch.Tensor:
    """Ulysses on this rank's shard. q/k/v: (B, T/sp, Hl, d). One stacked
    all-to-all for q/k/v trades the sequence sharding for head sharding,
    the zoo's kernels run on the full sequence with ``Hl/sp`` heads, and
    the output is traded back: (B, T/sp, Hl, d). ``saved``: the kernel
    calls' ``save_ctx`` holders."""
    from dalle_tpu_torch.models.attention import (join_halves,
                                                  zoo_attention_halves)
    qkv = all_to_all(torch.stack((q, k, v)), 3, 2, group)
    out = join_halves(*zoo_attention_halves(
        qkv[0], qkv[1], qkv[2], attn_type=attn_type, text_len=text_len,
        grid=grid, conv_kernel=conv_kernel, saved=saved))
    return all_to_all(out, 1, 2, group)


def check_sp(mesh, mode: str, attn_type: str, b: int, t: int, h: int,
             sp_axis: str = "sp", tp_axis: str = "tp") -> None:
    """The checks of JAX's ``sp_zoo_attention`` on the global (B, T, H)
    sizes, each its ``ValueError``."""
    sp, tp = mesh.shape[sp_axis], mesh.shape[tp_axis]
    dbatch = 1
    for ax in BATCH_AXES:
        dbatch *= mesh.shape[ax]
    if b % dbatch:
        raise ValueError(f"batch {b} not divisible by dp*fsdp={dbatch}")
    if t % sp:
        raise ValueError(f"sequence {t} not divisible by sp={sp}")
    if mode == SP_RING and t % (2 * sp):
        raise ValueError(
            f"zigzag ring needs the sequence ({t}) divisible by 2*sp="
            f"{2 * sp} (each shard splits into an early and a late chunk)")
    if h % tp:
        raise ValueError(f"heads {h} not divisible by tp={tp}")
    if mode == SP_RING:
        if attn_type != ATTN_FULL:
            raise ValueError(
                f"ring sequence parallelism requires 'full' attention "
                f"layers, got {attn_type!r} (use mode='ulysses')")
    elif mode == SP_ULYSSES:
        if (h // tp) % sp:
            raise ValueError(
                f"ulysses needs heads/tp ({h}/{tp}={h // tp}) divisible "
                f"by sp={sp}")
    else:
        raise ValueError(f"unknown sequence-parallel mode {mode!r}")


def sp_zoo_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     mesh, mode: str, attn_type: str, text_len: int,
                     grid: int, conv_kernel: int = 11, saved=None,
                     sp_axis: str = "sp", tp_axis: str = "tp"
                     ) -> torch.Tensor:
    """Sequence-parallel zoo attention on this rank's (B_l, T/sp, H/tp, d)
    shards of q/k/v; returns its shard of the output, (B_l, T/sp, H/tp,
    d).

    ``mode="ring"`` uses ring attention for ``full`` layers (and requires
    every layer be ``full``, enforced by ``ModelConfig.validate``);
    ``mode="ulysses"`` handles every zoo type. ``sp == 1`` is refused here:
    the model then runs the zoo's kernels on its whole sequence."""
    sp = mesh.shape[sp_axis]
    if sp == 1:
        raise ValueError("sp_zoo_attention needs sp > 1; with sp == 1 the "
                         "model runs zoo_attention_halves")
    b, tl, hl, _ = q.shape
    check_sp(mesh, mode, attn_type,
             b * mesh.shape["dp"] * mesh.shape["fsdp"], tl * sp,
             hl * mesh.shape[tp_axis], sp_axis, tp_axis)
    group = mesh.group(sp_axis)
    if mode == SP_RING:
        return ring_attention(q, k, v, group=group, n_shards=sp,
                              index=mesh.index(sp_axis))
    return ulysses_attention(q, k, v, group=group, attn_type=attn_type,
                             text_len=text_len, grid=grid,
                             conv_kernel=conv_kernel, saved=saved)
