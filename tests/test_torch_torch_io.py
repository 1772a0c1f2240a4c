"""The port's gated ``torch.load`` (``dalle_tpu_torch/utils/torch_io.py``)
against the JAX package's (``dalle_tpu/utils/torch_io.py``), the cases of
``tests/test_security.py::TestUnsafePickleGate``, and through the port's
VQGAN and CLIP checkpoint loaders: a lightning-style pickle that the
weights-only loader rejects raises ``UnsafeCheckpointError`` unless the
caller opts in (``allow_unsafe`` or ``DALLE_TPU_ALLOW_UNSAFE_PICKLE=1``).
"""

import argparse

import pytest
import torch

from dalle_tpu.utils import torch_io as jtio
from dalle_tpu_torch.models import clip as tclip
from dalle_tpu_torch.models import vqgan as tvqgan
from dalle_tpu_torch.utils import torch_io as tio

torch.set_num_threads(2)
ENV = "DALLE_TPU_ALLOW_UNSAFE_PICKLE"


@pytest.fixture(autouse=True)
def _no_env_optin(monkeypatch):
    monkeypatch.delenv(ENV, raising=False)


def _wrapped(tmp_path, state_dict, name="wrapped.ckpt"):
    """A lightning-style checkpoint: the weights beside a non-tensor
    object, which the weights-only loader rejects."""
    path = str(tmp_path / name)
    torch.save({"state_dict": state_dict,
                "hparams": argparse.Namespace(x=1)}, path)
    return path


def test_one_environment_variable_serves_both_packages():
    assert tio._UNSAFE_ENV == jtio._UNSAFE_ENV == ENV


@pytest.mark.parametrize("package", [tio, jtio], ids=["port", "jax"])
def test_rejected_without_optin(tmp_path, package):
    with pytest.raises(package.UnsafeCheckpointError, match=ENV):
        package.torch_load_trusted(_wrapped(tmp_path, {}))


def test_flag_and_env_optins_load(tmp_path, monkeypatch):
    path = _wrapped(tmp_path, {})
    assert tio.torch_load_trusted(path, allow_unsafe=True)["hparams"].x == 1
    monkeypatch.setenv(ENV, "1")
    assert tio.torch_load_trusted(path)["hparams"].x == 1
    assert jtio.torch_load_trusted(path)["hparams"].x == 1


def test_safe_checkpoints_and_missing_files_are_unaffected(tmp_path):
    path = str(tmp_path / "plain.pt")
    torch.save({"w": torch.zeros(2)}, path)
    assert tio.torch_load_trusted(path)["w"].shape == (2,)
    with pytest.raises(FileNotFoundError):
        tio.torch_load_trusted(str(tmp_path / "absent.pt"))


def _vqgan_state():
    torch.manual_seed(0)
    return tvqgan.VQGANDecoder(tvqgan.tiny_vqgan_config()).state_dict()


def _clip_state():
    torch.manual_seed(0)
    return tclip.CLIPModel(tclip.tiny_clip_config()).state_dict()


@pytest.mark.parametrize("which", ["vqgan", "clip"])
def test_the_loaders_gate_a_wrapped_pickle(tmp_path, monkeypatch, which):
    """The loaders refuse the wrapped file without an opt-in, and with
    ``allow_unsafe`` or the environment variable load its weights."""
    state, load, cfg = {
        "vqgan": (_vqgan_state(), tvqgan.load_taming_checkpoint,
                  tvqgan.tiny_vqgan_config()),
        "clip": (_clip_state(), tclip.load_openai_checkpoint,
                 tclip.tiny_clip_config()),
    }[which]
    path = _wrapped(tmp_path, state)
    with pytest.raises(tio.UnsafeCheckpointError):
        load(path, cfg)
    for model in (load(path, cfg, allow_unsafe=True),
                  (monkeypatch.setenv(ENV, "1"), load(path, cfg))[1]):
        got = model.state_dict()
        for name, want in state.items():
            if name in got:
                assert torch.equal(got[name], want), name
