"""Process roles of a peer and its device mesh (counterpart of
``dalle_tpu/parallel``)."""
