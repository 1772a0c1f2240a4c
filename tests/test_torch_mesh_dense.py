"""8-bit and fp32 LAMB steps of a ``dense_scan`` model (stacked leaves,
per-slice trust ratios) sharded over fsdp=4 in the port against the JAX
package's ``make_train_step`` on ``shard_train_state``: the helpers and
tolerances of tests/test_torch_mesh_train.py (split out so the two files'
JAX compiles run in parallel).
"""

import pytest

from tests.test_torch_mesh_train import check_lamb_steps


@pytest.mark.parametrize("bits", [32, 8])
def test_sharded_dense_scan_lamb_steps_match_jax(tmp_path, bits):
    check_lamb_steps(tmp_path, "dense_scan_fsdp4", bits)
