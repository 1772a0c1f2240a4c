"""Gated ``torch.load`` for the VQGAN and CLIP checkpoint readers
(counterpart of ``dalle_tpu/utils/torch_io.py``).

The safe, tensor-only loader runs first. A file it rejects needs the full
unpickler, which executes code from the file; that runs only when the
caller opts in (``allow_unsafe``, the CLIs' ``--allow-unsafe-pickle``) or
``DALLE_TPU_ALLOW_UNSAFE_PICKLE=1`` is set. The variable has the JAX
package's name, so one setting serves both packages.
"""

from __future__ import annotations

import os
import pickle
from typing import Any

import torch

#: the opt-in for callers without a CLI flag (tests, notebooks)
_UNSAFE_ENV = "DALLE_TPU_ALLOW_UNSAFE_PICKLE"


class UnsafeCheckpointError(RuntimeError):
    """The archive needs the permissive pickle loader, which executes
    arbitrary code from the file, and the caller did not opt in."""


def torch_load_trusted(path: str, allow_unsafe: bool = False) -> Any:
    """``torch.load(path)`` on the CPU through the weights-only loader.
    Only that loader's rejection (``pickle.UnpicklingError``) falls back to
    the permissive one, and only with ``allow_unsafe`` or the environment
    opt-in; otherwise it raises :class:`UnsafeCheckpointError`. Missing or
    truncated files raise as ``torch.load`` raises."""
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as safe_err:
        if not (allow_unsafe or os.environ.get(_UNSAFE_ENV) == "1"):
            raise UnsafeCheckpointError(
                f"{path} is rejected by torch's safe (weights_only) "
                f"loader ({safe_err!r}); loading it requires executing "
                f"pickled code from the file. Re-run with "
                f"--allow-unsafe-pickle (or {_UNSAFE_ENV}=1) ONLY if you "
                f"trust this checkpoint's origin.") from safe_err
        return torch.load(path, map_location="cpu", weights_only=False)
