"""Command-line entry points of the port (``python -m
dalle_tpu_torch.cli.<name>``)."""

import logging

from dalle_tpu_torch.config import (flagship_model_config, tiny_model_config,
                                    xl_model_config)

#: base model shapes that field flags override (the JAX CLIs' presets)
MODEL_PRESETS = {
    "flagship": flagship_model_config,
    "tiny": tiny_model_config,
    "xl": xl_model_config,
}


def restore_weights(model, checkpoint_dir: str,
                    log: logging.Logger) -> bool:
    """Load the parameters of the freshest checkpoint under
    ``checkpoint_dir`` (the port's or the JAX trainer's) into ``model``;
    False, with an error logged, when none loads."""
    from dalle_tpu_torch.training.checkpoint import CheckpointManager
    restored = CheckpointManager(
        checkpoint_dir, async_writes=False).restore_params_latest(model)
    if restored is None:
        log.error("no loadable checkpoint under %s", checkpoint_dir)
        return False
    log.info("loaded checkpoint at epoch %d", restored[1])
    return True
