"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version. A wrapper given CPU tensors runs the plain version; given CUDA
tensors it launches its kernel or raises.

``LAUNCHES`` counts, per wrapper, the calls that launched its kernel(s): a
wrapper adds one where it launches and nowhere else, so a run can show
which kernels its path went through. It counts calls, not CUDA launches:
one ``geglu_ff`` call launches two kernels (the gate GEMM and the output
GEMM) and adds one; so do the backward wrappers (the LayerNorm backward's
row pass and partial sum; the attention backward's dq pass, dk/dv pass
and, with a prefix, the prefix's dk/dv pass). A forward kernel run again by
a rematerialised block in backward counts again.

The attention and GEGLU wrappers have two routes on the card, picked from
the operands' dtype and shape before any launch (``attention_route``,
``geglu_route``): the fast kernels, or the generic instances
(``csrc/attention_generic.cu``, ``csrc/geglu_generic.cu``) for what the
fast ones do not take. A call on either route adds one to ``LAUNCHES``
under the wrapper's name; a call on the generic route also adds one to
``GENERIC_LAUNCHES``, so a run can show which route its path took.

Each forward/backward pair is also a ``torch.autograd.Function``
(``LayerNormFn``, ``GEGLUFn``, ``LineAttention``, ``WindowAttention``)
whose backward calls the backward wrapper, as the JAX package wraps each
Pallas pair in a ``jax.custom_vjp``.
"""

from __future__ import annotations

from typing import Dict

LAUNCHES: Dict[str, int] = {
    "layer_norm": 0, "line_attention": 0, "window_attention": 0,
    "geglu_ff": 0, "layer_norm_bwd": 0, "line_attention_bwd": 0,
    "window_attention_bwd": 0, "geglu_ff_bwd": 0, "quantize_blockwise": 0,
    "wire_quantize_u8": 0, "wire_quantize_u4": 0}

GENERIC_LAUNCHES: Dict[str, int] = {
    "line_attention": 0, "window_attention": 0, "geglu_ff": 0,
    "line_attention_bwd": 0, "window_attention_bwd": 0, "geglu_ff_bwd": 0}


def reset_launches() -> None:
    for counts in (LAUNCHES, GENERIC_LAUNCHES):
        for name in counts:
            counts[name] = 0
