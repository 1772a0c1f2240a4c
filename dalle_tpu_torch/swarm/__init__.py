"""The swarm of a trainer peer (counterpart of ``dalle_tpu/swarm``).

- the device half: ``compression.py`` (the wire codecs' bytes, a numpy
  copy of the JAX package's module), ``device_codec.py`` (the u8/u4 wire
  encode on the GPU, the ``wire_quantize_u8``/``wire_quantize_u4``
  kernels, per-chunk framing, decode and the owner's fused accumulate) and
  ``error_feedback.py`` (the quantization-error residuals);
- the network half, copies of the JAX package's modules on the port's
  MessagePack (``utils/msgpack.py``): identity and crypto, the DHT over
  the repository's C++ daemon (``_native.py`` builds it into
  ``build/dalle_tpu_torch/``), metrics records, rendezvous, the health
  ledger and strike gossip, gradient screening, progress tracking,
  matchmaking, the butterfly all-reduce, state transfer and the
  collaborative optimizer;
- the trust plane and PowerSGD: ``audit.py`` (verified aggregation:
  challenges, signed transcripts, replay, proofs), ``repair.py`` (the
  corrections a conviction queues) and ``powersgd.py`` (rank-r factor
  rounds, their products on torch).

A torch peer and a JAX peer in one run speak the same protocol and average
the same coordinates (``params.jax_leaf_names``).
"""

from dalle_tpu_torch.swarm.dht import (DHT, RecordValidatorBase,
                                       SchemaValidator, SignatureValidator,
                                       ValueWithExpiration, get_dht_time,
                                       key_hash, owner_public_key,
                                       strip_owner)
from dalle_tpu_torch.swarm.identity import Identity


def __getattr__(name):
    # the optimizer and the averaging protocol load on first use
    if name == "CollaborativeOptimizer":
        from dalle_tpu_torch.swarm.optimizer import CollaborativeOptimizer
        return CollaborativeOptimizer
    if name == "ProgressTracker":
        from dalle_tpu_torch.swarm.progress import ProgressTracker
        return ProgressTracker
    if name == "GradientScreen":
        from dalle_tpu_torch.swarm.screening import GradientScreen
        return GradientScreen
    if name == "ScreenPolicy":
        from dalle_tpu_torch.swarm.screening import ScreenPolicy
        return ScreenPolicy
    if name == "StrikeGossip":
        from dalle_tpu_torch.swarm.health import StrikeGossip
        return StrikeGossip
    if name == "ErrorFeedback":
        from dalle_tpu_torch.swarm.error_feedback import ErrorFeedback
        return ErrorFeedback
    raise AttributeError(name)


__all__ = [
    "DHT", "Identity", "RecordValidatorBase", "SchemaValidator",
    "SignatureValidator", "ValueWithExpiration", "get_dht_time", "key_hash",
    "owner_public_key", "strip_owner", "CollaborativeOptimizer",
    "ProgressTracker", "GradientScreen", "ScreenPolicy", "StrikeGossip",
    "ErrorFeedback",
]
