"""Data sources of the port (counterpart of ``dalle_tpu/data``)."""
