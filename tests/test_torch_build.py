"""The kernel build cache of ``dalle_tpu_torch/ops/_build.py``: a library's
name is a hash of its source and of every ``csrc/*.cuh`` header, so an
edited header rebuilds the sources that may include it. No ``nvcc`` needed:
only the names are computed, on copies of ``csrc`` under ``tmp_path``."""

import shutil

from dalle_tpu_torch.ops import _build


def _copy(tmp_path):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    return csrc


def _names(csrc):
    return {n: _build._target(n, csrc).name for n in _build.sources()}


def test_target_is_the_checkout_name_for_the_same_files(tmp_path):
    csrc = _copy(tmp_path)
    assert _names(csrc) == {n: _build._target(n).name
                            for n in _build.sources()}
    assert {p.name for p in csrc.glob("*.cuh")} >= {"attention_common.cuh",
                                                    "gemm_sm90.cuh"}


def test_editing_a_header_changes_every_target(tmp_path):
    csrc = _copy(tmp_path)
    before = _names(csrc)
    header = csrc / "attention_common.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = _names(csrc)
    assert all(after[n] != before[n] for n in before)
    assert all(after[n].startswith(f"{n}-") for n in after)


def test_editing_a_source_changes_its_target_only(tmp_path):
    csrc = _copy(tmp_path)
    before = _names(csrc)
    src = csrc / "attention_fwd.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    after = _names(csrc)
    assert {n for n in before if after[n] != before[n]} == {"attention_fwd"}


def test_editing_the_gemm_header_rebuilds_both_geglu_sources(tmp_path):
    csrc = _copy(tmp_path)
    before = _names(csrc)
    header = csrc / "gemm_sm90.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = _names(csrc)
    assert after["geglu_fwd"] != before["geglu_fwd"]
    assert after["geglu_bwd"] != before["geglu_bwd"]
