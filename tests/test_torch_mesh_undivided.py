"""The meshes whose ``tp`` leaves JAX's ``param_shardings`` keeps whole,
on the port's mesh of processes against the JAX package.

JAX drops ``tp`` from any leaf dimension it does not divide and runs the
program on the layout that results; the port runs each such layer
replicated over ``tp`` (``models/transformer.py``):

- ``tp_heads_undivided``, XL's shape in small (XL has 28 heads at
  ``tp=8``): 6 heads of 16 at ``tp=4``, so that each rank's q/k/v columns
  hold 1.5 heads. The projections stay column- and row-parallel, every
  rank attends on all six heads, and the FF stays split.
- ``tp_blocks_whole``, the flagship's shape in small (dim 1024 and inner
  4096 at ``tp=3``): dim 64 at ``tp=3``, so that every block leaf is whole
  while ``token_emb``'s 384 rows are vocabulary-sharded.
- ``tp_table_whole``: dim 96 with 3 heads at ``tp=3``, whose blocks split
  by whole heads while the table's 256 rows are whole on every rank.

Each case's loss, every gradient and ``return_logits`` are held to the
JAX package's single-device values at JAX's tolerances (loss 1e-5;
gradients rtol 5e-4, atol 5e-5; f32), through
``tests/test_torch_mesh_model.check_case``.
"""

import pytest

from tests.test_torch_mesh_model import check_case

CASES = {
    "tp_heads_undivided": (dict(dim=96, heads=6, head_dim=16,
                                attn_types=("axial_row", "axial_col"),
                                depth=3, shared_block_cycle=2, remat=True),
                           dict(dp=1, fsdp=1, tp=4, sp=1)),
    "tp_blocks_whole": (dict(vocab_text=256, attn_types=("axial_row",
                                                         "axial_col"),
                             depth=3),
                        dict(dp=1, fsdp=1, tp=3, sp=1)),
    "tp_table_whole": (dict(dim=96, heads=3, head_dim=32, vocab_text=130,
                            depth=2),
                       dict(dp=1, fsdp=1, tp=3, sp=1)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_undivided_tp_mesh_matches_jax(tmp_path, case):
    kw, mesh = CASES[case]
    check_case(tmp_path, case, kw, mesh, 1)
