"""The yardstick's counts against counts made by hand."""

import json

import pytest

from benchmark import work
from benchmark.reference import dalle as ref
from benchmark.tests import tiny

FLAGSHIP = json.loads((tiny.REPO / "benchmark/configs/flagship.json")
                      .read_text())["model"]
LONG = json.loads((tiny.REPO / "benchmark/configs/long_context.json")
                  .read_text())["model"]


@pytest.mark.parametrize("attn_type, pairs", [
    ("full", 16 * 17 // 2), ("axial_row", 4 * 10), ("axial_col", 4 * 10),
    # rows above: 2 + 3 + 3 + 2 keys in each of 3 rows; own row 1 + 2 + 2 + 2
    ("conv_like", 3 * 10 + 4 * 7)])
def test_image_pairs_by_hand_and_by_mask(attn_type, pairs):
    assert work.image_pairs(attn_type, 4, 3) == pairs
    mask = ref._mask_np(attn_type, 8, 4, 3)
    assert int(mask[8:, 8:].sum()) == pairs
    m = dict(tiny.SIZES, attn_types=[attn_type], final_conv_block=False)
    assert work.layer_pairs(m, attn_type) == int(mask.sum())


def test_tiny_training_flops_by_hand():
    m = tiny.ZOO
    d, k, t = 32, 128, 8 + 16
    per_layer = 4 * d * d + 3 * d * k
    assert work.matmul_params(m) == 5 * per_layer
    pairs = {"axial_row": 36 + 16 * 8 + 40, "axial_col": 36 + 16 * 8 + 40,
             "conv_like": 36 + 16 * 8 + 58}
    attn = sum(4 * 32 * pairs[a] for a in
               ("axial_row", "axial_col", "axial_row", "axial_row",
                "conv_like"))
    head = 2 * d * (8 * 64 + 16 * 32)
    assert work.train_flops_per_image(m) == \
        6 * 5 * per_layer * t + 3 * attn + 3 * head


def test_flagship_and_long_context_totals():
    assert work.matmul_params(FLAGSHIP) == 1_073_741_824
    assert work.train_flops_per_image(FLAGSHIP) == pytest.approx(8.60e12,
                                                                 rel=0.01)
    assert work.train_flops_per_image(LONG) == pytest.approx(35.75e12,
                                                             rel=0.01)
    nbytes, _ = work.decode_step_work(FLAGSHIP, 8)
    assert nbytes == pytest.approx(2.76e9, rel=0.05)


def test_attention_least_time_by_hand():
    m = dict(tiny.SIZES, depth=1, shared_block_cycle=0, attn_types=["full"],
             final_conv_block=False)
    rows, d = 3 * 2, 16
    total = 0.0
    for q, p, pairs in ((8, 0, 36), (16, 8, 16 * 8 + 136)):
        tok, pre, lse = rows * q * d * 2, rows * p * d * 2, rows * q * 4
        total += max((4 * tok + 2 * pre + lse) / work.HBM_BYTES_PER_S,
                     4 * d * pairs * rows / work.BF16_FLOP_PER_S)
        total += max((8 * tok + 4 * pre + lse) / work.HBM_BYTES_PER_S,
                     8 * d * pairs * rows / work.BF16_FLOP_PER_S)
    assert work.attention_step_least_ms(m, 3) == pytest.approx(total * 1e3)


def test_kernel_classes():
    assert work.kernel_class("void attn_fwd_kernel<0>(...)") == \
        "attention kernel, forward"
    assert work.kernel_class("nvjet_tst_128x256") == "cuBLAS GEMMs"
    assert work.kernel_class("elementwise_kernel") == work.ELEMENTWISE
