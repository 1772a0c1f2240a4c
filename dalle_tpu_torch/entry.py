"""Entry points of the port: the flagship forward loss (counterpart of
``__graft_entry__.entry``), one flagship training step (the regime of
``bench.py``: micro-batches accumulated, then one LAMB update), and the
sharded dry run (counterpart of ``__graft_entry__.dryrun_multichip``)."""

from __future__ import annotations

import torch

from dalle_tpu_torch import resolve_device
from dalle_tpu_torch.config import OptimizerConfig, flagship_model_config
from dalle_tpu_torch.data.synthetic import SyntheticCodes
from dalle_tpu_torch.models.dalle import init_params
from dalle_tpu_torch.optim import make_optimizer
from dalle_tpu_torch.training.steps import TrainState, train_step


def entry(device="cuda", batch: int = 1, seed: int = 0):
    """``(fn, args)``: ``fn(*args)`` is the flagship model's forward loss
    on ``batch`` all-zero captions and code grids, with bf16 parameters
    drawn from ``seed``. Runs on the GPU unless ``device="cpu"`` is asked
    for; raises when the GPU is asked for and absent."""
    dev = resolve_device(device)
    cfg = flagship_model_config(param_dtype="bfloat16")
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(seed))
    model.eval()
    text = torch.zeros((batch, cfg.text_seq_len), dtype=torch.long,
                       device=dev)
    image = torch.zeros((batch, cfg.image_seq_len), dtype=torch.long,
                        device=dev)

    def forward(model, text, image):
        with torch.inference_mode():
            loss, _ = model(text, image)
        return loss

    return forward, (model, text, image)


def train_entry(device="cuda", micro: int = 4, accum: int = 2,
                seed: int = 0, state_bits: int = 8, **model_overrides):
    """``(fn, args)``: ``fn(*args)`` is one flagship training step, ``(state,
    metrics)``, over ``accum`` micro-batches of ``micro`` samples followed
    by one LAMB update. The model: the flagship with
    ``FLAGSHIP_TUNED`` (fused LayerNorm, ``save_attn`` remat of all blocks
    but ``block_3``, hoisted bf16 parameter casts), f32 parameters drawn
    from ``seed``, bf16 activations; ``model_overrides`` change it (for
    example a smaller ``depth``, or ``dtype="float32"``). The batch: the
    first of ``SyntheticCodes(cfg, micro * accum, seed)``. The optimizer:
    ``OptimizerConfig(state_bits=state_bits, warmup_steps=2,
    total_steps=100)``, the 8-bit LAMB by default (the JAX package's and
    ``bench.py``'s), the fp32 LAMB with ``state_bits=32``; the learning rate
    leaves 0 at the second step. Runs on the GPU unless ``device="cpu"`` is
    asked for."""
    dev = resolve_device(device)
    cfg = flagship_model_config(**{"param_dtype": "float32",
                                   "dtype": "bfloat16", **model_overrides})
    tx = make_optimizer(OptimizerConfig(state_bits=state_bits,
                                        warmup_steps=2, total_steps=100))
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(seed))
    model.train()
    state = TrainState.create(model, tx)
    n = micro * accum
    data = next(SyntheticCodes(cfg, num_samples=n, seed=seed).batches(n))
    batch = {k: torch.from_numpy(v).long().to(dev) for k, v in data.items()}

    def step(state, batch):
        return train_step(state, batch, tx, accum_steps=accum)

    return step, (state, batch)


def _factor_mesh(n: int):
    """Split n devices over (dp, fsdp, tp): tp=2 when even, fsdp=2 when
    divisible by 4, rest data-parallel (``__graft_entry__._factor_mesh``)."""
    tp = 2 if n % 2 == 0 else 1
    fsdp = 2 if n % 4 == 0 else 1
    dp = n // (tp * fsdp)
    return dp, fsdp, tp


def dryrun_multichip(n_devices: int, device="cuda",
                     timeout: float = 600.0) -> None:
    """One full sharded train step (model forward/backward + 8-bit LAMB
    update) on tiny shapes over an ``n_devices`` mesh with real dp/fsdp/tp
    shardings, then (when ``n_devices`` divides by 4) ring and Ulysses
    steps at tp=2 sp=2: the cases of ``__graft_entry__.dryrun_multichip``,
    each printing ``dryrun_multichip ok: <label> loss=<loss>``.

    The mesh's devices are ``n_devices`` processes of one ``gloo`` group
    (``parallel/launch.py``), all on the visible GPU, or on the CPU when
    ``device="cpu"`` is asked for; it raises when the GPU is asked for and
    absent, or when any process fails."""
    resolve_device(device)
    from dalle_tpu_torch.parallel.launch import spawn
    results = spawn("dalle_tpu_torch.entry:_dryrun_rank", n_devices,
                    {"device": str(device)}, timeout=timeout)
    for line in results[0]["stdout"].splitlines():
        if line.startswith("dryrun_multichip ok:"):
            print(line)


def _dryrun_rank(rank: int, n_devices: int, args) -> dict:
    """One process of :func:`dryrun_multichip`."""
    import numpy as np

    from dalle_tpu_torch.config import tiny_model_config
    from dalle_tpu_torch.parallel.mesh import batch_sharding, make_mesh
    from dalle_tpu_torch.parallel.sharding import shard_train_state

    dev = resolve_device(args["device"])
    dp, fsdp, tp = _factor_mesh(n_devices)
    mesh = make_mesh(dp=dp, fsdp=fsdp, tp=tp, sp=1)
    tx = make_optimizer(OptimizerConfig(warmup_steps=2, total_steps=10))
    data_shards = dp * fsdp
    batch_size = data_shards * max(1, 8 // data_shards)
    losses = {}

    def smoke_step(cfg, run_mesh, label):
        """One sharded train step (init -> shard -> step) asserting a
        finite loss: the protocol of every case."""
        model = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            mesh=run_mesh)
        model.train()
        state = shard_train_state(run_mesh, TrainState.create(model, tx))
        data = SyntheticCodes(cfg, num_samples=batch_size, seed=0)
        whole = {k: torch.from_numpy(v).long().to(dev) for k, v in
                 next(data.batches(batch_size, seed=0)).items()}
        state, metrics = train_step(state, batch_sharding(run_mesh, whole),
                                    tx)
        loss = float(metrics["loss"])
        assert np.isfinite(loss), f"non-finite {label} loss {loss}"
        losses[label] = loss
        if rank == 0:
            print(f"dryrun_multichip ok: {label} loss={loss:.4f}",
                  flush=True)

    # tiny shapes, but the full layer zoo: weight-shared axial blocks plus
    # the final conv_like block, rotary, remat
    zoo = dict(dim=64, heads=4, head_dim=16, conv_kernel=3, remat=True,
               attn_types=("axial_row", "axial_col", "axial_row",
                           "axial_row"), final_conv_block=True)
    smoke_step(tiny_model_config(depth=5, shared_block_cycle=4, **zoo),
               mesh, f"mesh dp={dp} fsdp={fsdp} tp={tp}")
    # dense (no weight sharing) via dense_scan: stacked per-iteration
    # parameters under fsdp
    if fsdp > 1:
        smoke_step(
            tiny_model_config(depth=9, shared_block_cycle=0,
                              dense_scan=True, **zoo),
            mesh, f"mesh dp={dp} fsdp={fsdp} tp={tp} dense_scan")
    # sequence parallelism: ring over a full-causal stack, Ulysses over
    # the mixed zoo, each a full sharded train step
    if n_devices % 4 == 0:
        sp_mesh = make_mesh(dp=n_devices // 4, fsdp=1, tp=2, sp=2)
        for mode, attn_types, final_conv in (
                ("ring", ("full",), False),
                ("ulysses", ("axial_row", "axial_col"), True)):
            cfg_sp = tiny_model_config(
                dim=64, heads=4, head_dim=16, depth=4, shared_block_cycle=2,
                attn_types=attn_types, final_conv_block=final_conv,
                conv_kernel=3, remat=True, sequence_parallel=mode)
            smoke_step(cfg_sp, sp_mesh,
                       f"mesh dp={n_devices // 4} tp=2 sp=2 mode={mode}")
    return {"losses": np.array(list(losses.values()))}
