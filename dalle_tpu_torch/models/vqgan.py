"""VQGAN f8 decoder: image codes -> pixels (counterpart of
``dalle_tpu/models/vqgan.py``).

The decoder half of taming-transformers' f8 VQGAN (8192-entry codebook,
32x32 codes -> 256x256 RGB): codebook lookup -> post_quant_conv 1x1 ->
conv_in 3x3 -> mid (ResnetBlock, AttnBlock, ResnetBlock) -> per-level
[ResnetBlock x (n+1), optional AttnBlock, nearest-2x upsample + conv] ->
GroupNorm -> swish -> conv_out 3x3. The modules carry taming's names
(``quantize.embedding``, ``post_quant_conv``, ``decoder.up.{i}.block.{j}``
...), so a released checkpoint is ``torch.load`` plus ``load_state_dict``
(:func:`load_taming_checkpoint`). Convolutions run NCHW as plain PyTorch
ops, as the JAX package computes them outside any Pallas kernel;
:func:`decode_codes` returns NHWC uint8, as the JAX one does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn


@dataclass(frozen=True)
class VQGANConfig:
    """f8 Gumbel-VQGAN shape (the reference's ``VQGanParams(image_size=256,
    num_layers=3)``: 3 upsamplings = f8)."""

    n_embed: int = 8192          # codebook entries (vocab_image)
    embed_dim: int = 256         # codebook vector dim
    z_channels: int = 256
    ch: int = 128                # base channel count
    ch_mult: Tuple[int, ...] = (1, 1, 2, 4)   # len-1 = num upsamplings (f8)
    num_res_blocks: int = 2
    attn_resolutions: Tuple[int, ...] = (32,)
    resolution: int = 256        # output image size
    dropout: float = 0.0

    @property
    def code_grid(self) -> int:
        return self.resolution // (2 ** (len(self.ch_mult) - 1))


def tiny_vqgan_config(**overrides: Any) -> VQGANConfig:
    """CPU-test shape: 4x4 codes -> 16x16 pixels."""
    base = dict(n_embed=64, embed_dim=16, z_channels=16, ch=16,
                ch_mult=(1, 2, 4), num_res_blocks=1, attn_resolutions=(4,),
                resolution=16)
    base.update(overrides)
    return VQGANConfig(**base)


def group_norm(channels: int) -> nn.GroupNorm:
    """flax ``nn.GroupNorm`` as the JAX decoder builds it: 32 groups when
    they divide the channels, else one; eps 1e-6."""
    return nn.GroupNorm(32 if channels % 32 == 0 else 1, channels, eps=1e-6)


def _swish(x):
    return x * torch.sigmoid(x)


class ResnetBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.norm1 = group_norm(in_ch)
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, padding=1)
        self.norm2 = group_norm(out_ch)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1)
        self.nin_shortcut = (nn.Conv2d(in_ch, out_ch, 1)
                             if in_ch != out_ch else None)

    def forward(self, x):
        h = self.conv1(_swish(self.norm1(x)))
        h = self.conv2(_swish(self.norm2(h)))
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head spatial self-attention over the (H*W) grid."""

    def __init__(self, ch: int):
        super().__init__()
        self.norm = group_norm(ch)
        self.q, self.k, self.v, self.proj_out = (nn.Conv2d(ch, ch, 1)
                                                 for _ in range(4))

    def forward(self, x):
        b, c, h, w = x.shape
        y = self.norm(x)
        q, k, v = (m(y).reshape(b, c, h * w) for m in (self.q, self.k,
                                                       self.v))
        probs = torch.softmax(torch.einsum("bcq,bck->bqk", q, k)
                              * c ** -0.5, dim=-1)
        out = torch.einsum("bqk,bck->bcq", probs, v).reshape(b, c, h, w)
        return x + self.proj_out(out)


class _Mid(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.block_1 = ResnetBlock(ch, ch)
        self.attn_1 = AttnBlock(ch)
        self.block_2 = ResnetBlock(ch, ch)


class _Upsample(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class _Level(nn.Module):
    def __init__(self):
        super().__init__()
        self.block = nn.ModuleList()
        self.attn = nn.ModuleList()
        self.upsample = None


class Decoder(nn.Module):
    def __init__(self, cfg: VQGANConfig):
        super().__init__()
        block_in = cfg.ch * cfg.ch_mult[-1]
        self.conv_in = nn.Conv2d(cfg.z_channels, block_in, 3, padding=1)
        self.mid = _Mid(block_in)
        n_levels = len(cfg.ch_mult)
        levels = [None] * n_levels
        curr_res = cfg.code_grid
        for i_level in reversed(range(n_levels)):
            level = _Level()
            block_out = cfg.ch * cfg.ch_mult[i_level]
            for _ in range(cfg.num_res_blocks + 1):
                level.block.append(ResnetBlock(block_in, block_out))
                block_in = block_out
                if curr_res in cfg.attn_resolutions:
                    level.attn.append(AttnBlock(block_in))
            if i_level != 0:
                level.upsample = _Upsample(block_in)
                curr_res *= 2
            levels[i_level] = level
        self.up = nn.ModuleList(levels)
        self.norm_out = group_norm(block_in)
        self.conv_out = nn.Conv2d(block_in, 3, 3, padding=1)

    def forward(self, z):
        h = self.conv_in(z)
        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(h)))
        for level in reversed(self.up):
            for i, blk in enumerate(level.block):
                h = blk(h)
                if len(level.attn):
                    h = level.attn[i](h)
            if level.upsample is not None:
                h = level.upsample(h)
        return self.conv_out(_swish(self.norm_out(h)))


class _Quantize(nn.Module):
    def __init__(self, cfg: VQGANConfig):
        super().__init__()
        self.embedding = nn.Embedding(cfg.n_embed, cfg.embed_dim)


class VQGANDecoder(nn.Module):
    """Codes (B, grid*grid) int -> images (B, 3, res, res) in about
    [-1, 1]. Parameters named as taming's ``VQModel`` decoder half."""

    def __init__(self, cfg: VQGANConfig):
        super().__init__()
        self.cfg = cfg
        self.quantize = _Quantize(cfg)
        self.post_quant_conv = nn.Conv2d(cfg.embed_dim, cfg.z_channels, 1)
        self.decoder = Decoder(cfg)

    def forward(self, codes: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        grid = cfg.code_grid
        z = self.quantize.embedding.weight[codes.long()].reshape(
            codes.shape[0], grid, grid, cfg.embed_dim).permute(0, 3, 1, 2)
        return self.decoder(self.post_quant_conv(z))


@torch.no_grad()
def decode_codes(model: VQGANDecoder, codes: torch.Tensor) -> torch.Tensor:
    """Codes -> uint8 RGB images (B, res, res, 3), as
    ``dalle_tpu.models.vqgan.decode_codes``."""
    imgs = model(codes).permute(0, 2, 3, 1)
    return ((torch.clamp(imgs, -1.0, 1.0) + 1.0) * 127.5).to(torch.uint8)


@torch.no_grad()
def init_params(cfg: VQGANConfig, generator: torch.Generator) -> VQGANDecoder:
    """A :class:`VQGANDecoder` on the generator's device with random
    weights drawn from ``generator`` (no released weights are used): the
    codebook N(0, 0.02) as the JAX decoder's, conv kernels
    N(0, 1/fan_in), biases 0, norms 1 and 0."""
    model = VQGANDecoder(cfg).to(generator.device)
    for name, p in model.named_parameters():
        if name == "quantize.embedding.weight":
            p.copy_(torch.randn(p.shape, generator=generator,
                                device=p.device) * 0.02)
        elif p.dim() == 4:
            p.copy_(torch.randn(p.shape, generator=generator,
                                device=p.device) / p[0].numel() ** 0.5)
        elif "norm" not in name:
            p.zero_()
    return model.eval()


def taming_decoder_state(sd: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The decoder half of a taming-transformers ``VQModel``/``GumbelVQ``
    state dict, under :class:`VQGANDecoder`'s names: the codebook is
    ``quantize.embedding.weight`` (VQ) or ``quantize.embed.weight``
    (Gumbel, the reference's f8-8192 model)."""
    out = {k: v for k, v in sd.items()
           if k.startswith(("post_quant_conv.", "decoder."))}
    out["quantize.embedding.weight"] = sd.get(
        "quantize.embedding.weight", sd.get("quantize.embed.weight"))
    return out


def load_taming_checkpoint(path: str, cfg: VQGANConfig,
                           allow_unsafe: bool = False) -> VQGANDecoder:
    """A :class:`VQGANDecoder` from a taming-transformers ``.ckpt``: the
    gated load of :func:`~dalle_tpu_torch.utils.torch_io.torch_load_trusted`
    (``allow_unsafe``: the full unpickler, which executes code from the
    file, for trusted files only), then ``load_state_dict`` of the decoder
    half."""
    from dalle_tpu_torch.utils.torch_io import torch_load_trusted
    ckpt = torch_load_trusted(path, allow_unsafe=allow_unsafe)
    model = VQGANDecoder(cfg)
    model.load_state_dict(taming_decoder_state(ckpt.get("state_dict", ckpt)))
    return model.eval()
