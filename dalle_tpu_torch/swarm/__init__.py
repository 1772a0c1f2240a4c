"""The swarm's device-side half for a trainer peer (counterpart of the
parts of ``dalle_tpu/swarm`` that run where the gradients live):

- ``compression.py``: the wire codecs' bytes, a numpy copy of the JAX
  package's module (held byte-identical by ``tests/test_torch_codec.py``);
- ``device_codec.py``: the u8/u4 wire encode on the GPU (the
  ``wire_quantize_u8``/``wire_quantize_u4`` kernels), per-chunk framing,
  decode and the owner's fused accumulate;
- ``error_feedback.py``: the quantization-error residuals of the
  ``wire_bits=4`` rounds.

The network half (DHT, matchmaking, the butterfly all-reduce, audit) is
not ported yet.
"""
