"""A mesh with ``sp > 1`` and ``sequence_parallel="none"`` on the port
against the JAX package.

JAX builds such a model without a mesh (``dalle_tpu/task.py``), shards
its parameters by ``param_shardings`` and the batch by ``BATCH_SPEC``,
neither of which names ``sp``: every ``sp`` device holds the rows of its
batch index and runs whole sequences. The port's ``sp`` ranks do the same
(``models.transformer.token_shards``). The zoo with its final
``conv_like`` block at ``dp=1 fsdp=2 tp=1 sp=2``, two micro-batches and a
loss mask whose rows keep different counts: the loss, every gradient and
``return_logits`` against the JAX package on one device and on its mesh
of four CPU devices, at JAX's tolerances (loss 1e-5; gradients rtol 5e-4,
atol 5e-5; f32, ``tests/test_torch_mesh_model.check_case``). The ``sp``
ranks' gradients are bitwise equal (the same kernels on the same bytes),
and no collective of the grad step runs over ``sp``
(``collectives.AXIS_TRAFFIC``): a sum over ``sp`` would count the loss
and the gradients twice. Then a ``TrainingTask`` whose ``TrainerConfig``
lays its four processes out as ``fsdp=2 sp=2`` (what ``run_trainer --fsdp
2 --sp 2`` builds) reads the rows of its batch index and ends two fp32
steps as one process does (tests/test_torch_mesh_train.py's tolerances).
"""

import numpy as np

from dalle_tpu_torch import config as tconfig
from dalle_tpu_torch.parallel.launch import spawn
from tests.test_torch_mesh_model import CHILDREN, check_case
from tests.test_torch_mesh_train import ELEM_RTOL, TOL, _opt

ZOO = dict(attn_types=("axial_row", "axial_col", "axial_row", "axial_row"),
           depth=5, shared_block_cycle=4, final_conv_block=True,
           conv_kernel=3, remat=True)


def test_sp_replica_mesh_matches_jax_and_sums_nothing_over_sp(tmp_path):
    results = check_case(tmp_path, "sp_none", ZOO,
                         dict(dp=1, fsdp=2, tp=1, sp=2), 2, masked=True)
    grads = [{k: v for k, v in r.items() if k.startswith("g:")}
             for r in results]
    for rank, g in enumerate(grads[1:], 1):
        bad = [k for k in g if not np.array_equal(g[k], grads[0][k])]
        assert not bad, (rank, bad)
    for rank, r in enumerate(results):
        axes = [str(a) for a in r["axes"]]
        assert "sp" not in axes and "fsdp" in axes, (rank, axes)


def test_a_task_with_sp_replicas_trains_as_one_process(tmp_path):
    from tests.torch_mesh_children import run_task
    args = dict(cfg={k: list(v) if isinstance(v, tuple) else v
                     for k, v in ZOO.items()},
                opt=_opt(32), steps=2, identity=str(tmp_path / "id.pem"),
                trainer=dict(per_device_batch=2, dp=-1, fsdp=2, sp=2))
    got = spawn(f"{CHILDREN}:task_steps", 4, args, timeout=150)
    assert all(bool(r["sharded"]) and list(r["rows"]) == [2, 2]
               for r in got)
    one, losses, rows = run_task(
        tconfig.tiny_model_config(**ZOO),
        dict(args, trainer=dict(per_device_batch=4)))
    assert rows == [4, 4] and not one.sharded
    for r in got:
        np.testing.assert_allclose(r["losses"], losses, rtol=TOL)
    for name, p in one.train_state.model.named_parameters():
        want = p.detach().numpy()
        np.testing.assert_allclose(
            got[0]["p:" + name], want, rtol=ELEM_RTOL,
            atol=TOL * max(float(np.abs(want).max()), 1.0), err_msg=name)
        assert np.array_equal(got[1]["p:" + name], got[0]["p:" + name])
