"""Task assembly: lazily wire model, data, DHT and swarm optimizer
(counterpart of ``dalle_tpu/task.py``).

Capability parity with the reference's ``TrainingTask`` (``task.py:25-181``):
one container that every entry point shares, building each subsystem on
first access, so a trainer never opens a DHT it was not asked to join.
The port's differences: the model is a PyTorch module on ``device`` (the
GPU unless the caller asks for the CPU), one GPU per peer (no mesh), and
the optimizer step runs on that device.

Settings whose modules are not ported yet raise ``NotImplementedError``
when the task is built: ``chaos_plan``, optimizer offload, a
``dense_scan`` model whose blocks the JAX package stacks, and meshes other
than one device (each names its ROADMAP item).
"""

from __future__ import annotations

import functools
import logging
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from dalle_tpu_torch import resolve_device
from dalle_tpu_torch.config import (SP_NONE, CollabConfig, ModelConfig,
                                    OptimizerConfig, PeerConfig,
                                    TrainerConfig)
from dalle_tpu_torch.swarm.metrics import make_validators, peer_data_seed

logger = logging.getLogger(__name__)


class TrainingTask:
    """Lazy container: each property builds its subsystem on first use."""

    def __init__(self,
                 model: ModelConfig,
                 optimizer: OptimizerConfig,
                 trainer: TrainerConfig,
                 collab: CollabConfig,
                 peer: PeerConfig,
                 data_path: Optional[str] = None,
                 tokenizer_path: Optional[str] = None,
                 device="cuda"):
        model.validate()
        if model.dense_scan_reps() > 0:
            # the JAX package stacks such a model's blocks into
            # per-repetition leaves; the port's leaf order is unrolled, so
            # a mixed swarm would average vectors in different orders
            raise NotImplementedError(
                "dense_scan with stacked blocks (dense_scan_reps() > 0): the "
                "port's parameter, moment and checkpoint layout is unrolled "
                "where the JAX package stacks it (ROADMAP Queue 1, the "
                "stacked dense_scan layout)")
        if model.sequence_parallel != SP_NONE:
            raise NotImplementedError(
                "sequence_parallel: ring/ulysses attention needs a mesh; "
                "meshes wait for the multi-GPU slice (ROADMAP)")
        optimizer.check_ported()
        trainer.check_ported()
        collab.check_ported()
        peer.check_ported()
        self.model_cfg = model
        self.opt_cfg = optimizer
        self.trainer_cfg = trainer
        self.collab_cfg = collab
        self.peer_cfg = peer
        self.data_path = data_path
        self.tokenizer_path = tokenizer_path
        self.device = resolve_device(device)

    # -- identity / swarm -------------------------------------------------

    @functools.cached_property
    def identity(self):
        from dalle_tpu_torch.swarm.identity import Identity
        return Identity.load_or_create(self.peer_cfg.identity_path)

    @functools.cached_property
    def dht(self):
        """This peer's swarm node (reference ``task.py:101-119``)."""
        from dalle_tpu_torch.swarm.dht import DHT
        initial_peers = list(self.peer_cfg.initial_peers)
        rdv = None
        if self.peer_cfg.rendezvous_path:
            # an empty --initial-peers list falls back to the shared
            # rendezvous file's fresh advertisements
            from dalle_tpu_torch.swarm.rendezvous import RendezvousFile
            rdv = RendezvousFile(self.peer_cfg.rendezvous_path)
            if not initial_peers:
                # exclude our own (possibly stale, pre-restart)
                # advertisement
                initial_peers = rdv.fresh_peers(
                    exclude_peer_id=self.identity.node_id.hex())
                if initial_peers:
                    logger.info("rendezvous bootstrap: %d peer(s) from %s",
                                len(initial_peers),
                                self.peer_cfg.rendezvous_path)
        dht = DHT(host=self.peer_cfg.host,
                  port=self.peer_cfg.port,
                  initial_peers=initial_peers,
                  client_mode=self.peer_cfg.client_mode,
                  identity=self.identity,
                  record_validators=make_validators(
                      self.identity, self.peer_cfg.experiment_prefix))
        # advertise now and RE-advertise on a background cadence:
        # rendezvous records expire, so a one-shot publish would strand
        # joiners arriving later than the TTL
        from dalle_tpu_torch.swarm.rendezvous import (RendezvousAdvertiser,
                                                      discover)
        self._rdv_advertiser = RendezvousAdvertiser(
            dht, self.peer_cfg.experiment_prefix, rdv_file=rdv)
        self._rdv_advertiser.publish_once()
        self._rdv_advertiser.start()
        # list REPAIR through the DHT rendezvous key: any one live contact
        # reveals the rest of the advertised swarm
        known = set(initial_peers)
        for addr in discover(dht, self.peer_cfg.experiment_prefix):
            if addr not in known:
                dht.bootstrap(addr)
        logger.info("swarm node up: peer_id=%s addr=%s",
                    dht.peer_id[:16], dht.visible_address)
        return dht

    @functools.cached_property
    def authorizer(self):
        """Optional experiment authorizer (reference ``task.py:95-99``:
        built only when auth is configured)."""
        from dalle_tpu_torch.swarm.auth import make_authorizer
        return make_authorizer(self.peer_cfg.auth_authority,
                               self.peer_cfg.auth_token_path)

    @functools.cached_property
    def slice_role(self):
        from dalle_tpu_torch.parallel.multihost import SliceRole
        return SliceRole()

    @functools.cached_property
    def collab_optimizer(self):
        """Swarm-synchronous optimizer owning the train state (reference
        ``task.py:121-135``)."""
        from dalle_tpu_torch.swarm.optimizer import CollaborativeOptimizer
        return CollaborativeOptimizer(
            self.dht, self.collab_cfg, self.train_state, self.apply_step,
            client_mode=self.peer_cfg.client_mode,
            authorizer=self.authorizer, role=self.slice_role)

    # -- compute ----------------------------------------------------------

    @functools.cached_property
    def model(self):
        """The DALLE, its parameters drawn from ``trainer.seed`` on
        :attr:`device` (``models.dalle.init_params``), in training mode."""
        from dalle_tpu_torch.models.dalle import init_params
        gen = torch.Generator(device=self.device).manual_seed(
            self.trainer_cfg.seed)
        model = init_params(self.model_cfg, gen)
        model.train()
        return model

    @functools.cached_property
    def tx(self):
        from dalle_tpu_torch.optim import make_optimizer
        return make_optimizer(self.opt_cfg)

    @functools.cached_property
    def train_state(self):
        """The initial TrainState (fresh params; checkpoint restore is the
        trainer loop's job, reference ``task.py:88-93``)."""
        from dalle_tpu_torch.training.steps import TrainState
        return TrainState.create(self.model, self.tx)

    @functools.cached_property
    def grad_step(self):
        """``(model, batch) -> (grads, metrics)``: forward and backward
        over ``grad_accum_steps`` micro-batches of the delivered batch
        (reference ``lib/training/tpu.py:119-126``); ``metrics`` holds
        ``loss``, ``loss_text`` and ``loss_img``."""
        from dalle_tpu_torch.training.steps import grad_step
        accum = self.trainer_cfg.grad_accum_steps

        def step(model, batch):
            loss, aux, grads = grad_step(model, batch, accum)
            return grads, aux
        return step

    @functools.cached_property
    def apply_step(self):
        """``(state, averaged_grads) -> state``; the once-per-epoch
        optimizer update (reference ``run_trainer_tpu.py:85-88`` seam)."""
        from dalle_tpu_torch.training.steps import apply_step
        tx = self.tx
        return lambda state, grads: apply_step(state, grads, tx)

    # -- data -------------------------------------------------------------

    @property
    def data_shards(self) -> int:
        return 1

    @property
    def local_batch_size(self) -> int:
        """Samples contributed per grad_step call on this peer (reference
        ``arguments.py:39-56``: device batch x accum x device count)."""
        t = self.trainer_cfg
        return t.per_device_batch * t.grad_accum_steps * self.data_shards

    @functools.cached_property
    def data_seed(self) -> int:
        """Per-peer shuffle seed so peers see different data (reference
        ``run_trainer.py:46``, ``hf_trainer.py:30-33``)."""
        return peer_data_seed(self.identity, self.trainer_cfg.seed)

    @functools.cached_property
    def dataset(self):
        """The shards under ``data_path`` read with the caption tokenizer
        at ``tokenizer_path`` (``data.dataset.CodesDataset``), or else
        ``SyntheticCodes``."""
        if self.data_path is not None:
            from dalle_tpu_torch.data.dataset import CodesDataset
            dataset = CodesDataset(self.data_path, self.model_cfg,
                                   tokenizer_path=self.tokenizer_path)
            if dataset.tokenizer.vocab_size > self.model_cfg.vocab_text:
                raise ValueError(
                    f"tokenizer vocab {dataset.tokenizer.vocab_size} "
                    f"exceeds model vocab_text {self.model_cfg.vocab_text}")
            return dataset
        from dalle_tpu_torch.data.synthetic import SyntheticCodes
        return SyntheticCodes(
            self.model_cfg,
            num_samples=max(64, 2 * self.local_batch_size),
            seed=self.trainer_cfg.seed)

    def batches(self) -> Iterator[Dict[str, torch.Tensor]]:
        """Batches on :attr:`device`: ids as int64, the loss mask (real
        data) as float32."""
        for batch in self.dataset.batches(self.local_batch_size,
                                          seed=self.data_seed):
            yield {k: (torch.from_numpy(v) if v.dtype == np.float32
                       else torch.from_numpy(v).long()).to(self.device)
                   for k, v in batch.items()}

    # -- lifecycle --------------------------------------------------------

    def shutdown(self) -> None:
        if "collab_optimizer" in self.__dict__:
            self.collab_optimizer.shutdown()
        if getattr(self, "_rdv_advertiser", None) is not None:
            # stop() both signals and joins (bounded): an in-flight
            # publish_once() touching a destroyed native node is a
            # use-after-free
            self._rdv_advertiser.stop(join_timeout=10)
        if "dht" in self.__dict__:
            self.dht.shutdown()

    def __enter__(self) -> "TrainingTask":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()
