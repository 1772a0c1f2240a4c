"""PyTorch/CUDA port of ``dalle_tpu`` for one NVIDIA H100.

``dalle_tpu`` (JAX on a TPU) is the reference and stays unchanged; this
package mirrors its layout (``config.py``, ``models/``, ``ops/``, ``optim/``,
``training/``, ``data/``) and imports nothing of it. Hand-written Hopper
kernels live under ``csrc/`` (CUDA C++) and ``ops/`` (Triton), each beside
its plain PyTorch version.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. ``"cuda"`` (the default) raises
    when no GPU is present: the CPU is used only when the caller asks.

    On the GPU, TF32 is switched off for matmuls and cuDNN, so that float32
    products stay float32 as the JAX reference computes them
    (``preferred_element_type=float32`` on bf16 operands is reproduced by
    upcasting the operands, which is exact only without TF32), and cuBLAS
    may not reduce bf16 products in reduced precision, so a bf16 GEMM sums
    in f32 and rounds once as XLA's does."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the plain "
                "PyTorch versions on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
    return device
