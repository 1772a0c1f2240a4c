"""Training of the port (counterpart of ``dalle_tpu/training``)."""
