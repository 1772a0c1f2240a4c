"""Process roles of a peer (counterpart of ``dalle_tpu/parallel``)."""
