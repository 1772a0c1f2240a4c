"""Command-line entry points of the port (``python -m
dalle_tpu_torch.cli.<name>``)."""

from dalle_tpu_torch.config import flagship_model_config, tiny_model_config

#: base model shapes that field flags override (the JAX CLIs' presets
#: the port has configs for)
MODEL_PRESETS = {
    "flagship": flagship_model_config,
    "tiny": tiny_model_config,
}

CHECKPOINT_UNPORTED = (
    "--checkpoint-dir: the port cannot read training checkpoints yet "
    "(training/checkpoint.py is ported with the swarm trainer slice); "
    "weights come from --seed")
TOKENIZER_UNPORTED = (
    "--tokenizer-path: the port has no caption tokenizer yet "
    "(data/tokenizer.py needs the `tokenizers` package); send "
    "pre-tokenized ids instead")
