"""CLIP (ViT-B/32-shaped) text/image scorer for generation reranking
(counterpart of ``dalle_tpu/models/clip.py``).

The reference reranks its generated images per query with OpenAI CLIP
ViT-B/32 (cosine scores between the text query and each decoded image).
The modules here carry openai/CLIP's names (``visual.conv1``,
``visual.transformer.resblocks.{i}.attn.in_proj_weight``,
``token_embedding`` ...), so a released checkpoint is ``torch.load``
(or ``torch.jit.load``) plus ``load_state_dict``
(:func:`load_openai_checkpoint`). Attention is plain PyTorch ops, as the
JAX package computes it outside any Pallas kernel. The byte-level BPE
tokenizer reads the public ``bpe_simple_vocab_16e6.txt.gz`` merges file
from disk.

- image: 32x32-patch conv embed -> [CLS] + learned positions -> pre-LN
  ViT (QuickGELU MLP) -> post-LN on CLS -> linear projection.
- text: token + position embeddings -> causal transformer -> LN -> take
  the EOT position (the largest id) -> linear projection.
- score: cosine similarity of L2-normalised embeddings.
"""

from __future__ import annotations

import gzip
import html
from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclass(frozen=True)
class CLIPConfig:
    """ViT-B/32 shapes (openai/CLIP released model)."""

    image_size: int = 224
    patch_size: int = 32
    vision_width: int = 768
    vision_layers: int = 12
    vision_heads: int = 12
    text_width: int = 512
    text_layers: int = 12
    text_heads: int = 8
    context_length: int = 77
    vocab_size: int = 49408
    embed_dim: int = 512         # joint embedding dim


def tiny_clip_config(**overrides: Any) -> CLIPConfig:
    base = dict(image_size=16, patch_size=8, vision_width=32,
                vision_layers=2, vision_heads=2, text_width=32,
                text_layers=2, text_heads=2, context_length=12,
                vocab_size=64, embed_dim=16)
    base.update(overrides)
    return CLIPConfig(**base)


class MultiheadAttention(nn.Module):
    """``nn.MultiheadAttention``'s parameters (packed ``in_proj_weight``
    (3W, W), ``in_proj_bias``, ``out_proj``), computed with plain ops:
    f32 scores, softmax, probabilities times values."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.zeros(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = nn.Linear(width, width)

    def forward(self, x, mask=None):
        b, t, w = x.shape
        hd = w // self.heads
        q, k, v = (y.reshape(b, t, self.heads, hd).transpose(1, 2)
                   for y in F.linear(x, self.in_proj_weight,
                                     self.in_proj_bias).chunk(3, dim=-1))
        scores = (q * hd ** -0.5) @ k.transpose(-1, -2)
        if mask is not None:
            scores = scores.masked_fill(~mask, torch.finfo(x.dtype).min)
        out = torch.softmax(scores, dim=-1) @ v
        return self.out_proj(out.transpose(1, 2).reshape(b, t, w))


class _MLP(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.c_fc = nn.Linear(width, 4 * width)
        self.c_proj = nn.Linear(4 * width, width)

    def forward(self, x):
        h = self.c_fc(x)
        return self.c_proj(h * torch.sigmoid(1.702 * h))   # QuickGELU


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int, causal: bool = False):
        super().__init__()
        self.causal = causal
        self.ln_1 = nn.LayerNorm(width, eps=1e-5)
        self.attn = MultiheadAttention(width, heads)
        self.ln_2 = nn.LayerNorm(width, eps=1e-5)
        self.mlp = _MLP(width)

    def forward(self, x):
        mask = None
        if self.causal:
            t = x.shape[1]
            mask = torch.ones(t, t, dtype=torch.bool,
                              device=x.device).tril()
        x = x + self.attn(self.ln_1(x), mask)
        return x + self.mlp(self.ln_2(x))


class Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int,
                 causal: bool = False):
        super().__init__()
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(width, heads, causal)
            for _ in range(layers))

    def forward(self, x):
        for blk in self.resblocks:
            x = blk(x)
        return x


class VisionTransformer(nn.Module):
    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        w = cfg.vision_width
        n_patches = (cfg.image_size // cfg.patch_size) ** 2
        self.conv1 = nn.Conv2d(3, w, cfg.patch_size, stride=cfg.patch_size,
                               bias=False)
        self.class_embedding = nn.Parameter(torch.zeros(w))
        self.positional_embedding = nn.Parameter(torch.zeros(n_patches + 1,
                                                             w))
        self.ln_pre = nn.LayerNorm(w, eps=1e-5)
        self.transformer = Transformer(w, cfg.vision_layers,
                                       cfg.vision_heads)
        self.ln_post = nn.LayerNorm(w, eps=1e-5)
        self.proj = nn.Parameter(torch.zeros(w, cfg.embed_dim))

    def forward(self, x):
        x = self.conv1(x)                             # (B, W, h, w)
        x = x.flatten(2).transpose(1, 2)              # (B, h*w, W)
        cls = self.class_embedding.expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding
        x = self.transformer(self.ln_pre(x))
        return self.ln_post(x[:, 0]) @ self.proj


class CLIPModel(nn.Module):
    """openai/CLIP's ``CLIP`` module layout (ViT image tower)."""

    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        self.cfg = cfg
        self.visual = VisionTransformer(cfg)
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.text_width)
        self.positional_embedding = nn.Parameter(
            torch.zeros(cfg.context_length, cfg.text_width))
        self.transformer = Transformer(cfg.text_width, cfg.text_layers,
                                       cfg.text_heads, causal=True)
        self.ln_final = nn.LayerNorm(cfg.text_width, eps=1e-5)
        self.text_projection = nn.Parameter(
            torch.zeros(cfg.text_width, cfg.embed_dim))
        self.logit_scale = nn.Parameter(torch.tensor(float(np.log(1 / 0.07))))

    def encode_image(self, images: torch.Tensor) -> torch.Tensor:
        """images: (B, H, W, 3) float in [0, 1] -> (B, embed_dim)."""
        mean = torch.tensor(CLIP_MEAN, device=images.device)
        std = torch.tensor(CLIP_STD, device=images.device)
        return self.visual(((images - mean) / std).permute(0, 3, 1, 2))

    def encode_text(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens: (B, context_length) int -> (B, embed_dim), read at each
        sequence's highest token id (CLIP's EOT is the largest id)."""
        x = self.token_embedding(tokens.long()) + self.positional_embedding
        x = self.ln_final(self.transformer(x))
        x = x[torch.arange(x.shape[0], device=x.device), tokens.argmax(-1)]
        return x @ self.text_projection

    def forward(self, images: torch.Tensor,
                tokens: torch.Tensor) -> torch.Tensor:
        """Cosine-similarity score matrix (B_images, B_texts)."""
        ie = self.encode_image(images)
        te = self.encode_text(tokens)
        ie = ie / torch.linalg.norm(ie, dim=-1, keepdim=True)
        te = te / torch.linalg.norm(te, dim=-1, keepdim=True)
        return ie @ te.t()


@torch.no_grad()
def clip_scores(model: CLIPModel, images: torch.Tensor,
                tokens: torch.Tensor) -> torch.Tensor:
    """(B_images, B_texts) cosine scores, the reranking signal."""
    return model(images, tokens)


@torch.no_grad()
def init_params(cfg: CLIPConfig, generator: torch.Generator) -> CLIPModel:
    """A :class:`CLIPModel` on the generator's device with random weights
    drawn from ``generator`` (no released weights are used), with the JAX
    module's scales: token embeddings N(0, 0.02), text positions
    N(0, 0.01), the class and vision positions and the projections
    N(0, width^-1/2), weight matrices N(0, 1/fan_in), biases 0, norms 1
    and 0, ``logit_scale`` log(1/0.07)."""
    model = CLIPModel(cfg).to(generator.device)

    def normal(p, std):
        p.copy_(torch.randn(p.shape, generator=generator,
                            device=p.device) * std)

    for name, p in model.named_parameters():
        if name == "token_embedding.weight":
            normal(p, 0.02)
        elif name == "positional_embedding":
            normal(p, 0.01)
        elif name in ("visual.class_embedding",
                      "visual.positional_embedding", "visual.proj"):
            normal(p, cfg.vision_width ** -0.5)
        elif name == "text_projection":
            normal(p, cfg.text_width ** -0.5)
        elif p.dim() >= 2:
            normal(p, p[0].numel() ** -0.5)
        elif name.endswith("bias"):
            p.zero_()
    return model.eval()


def _resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) f32 weights of ``jax.image.resize(method="bilinear")``
    along one axis: the triangle kernel, widened by the scale when
    downsampling (antialias), each column normalised."""
    f32 = np.float32
    inv_scale = f32(1.0 / (n_out / n_in))
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) \
        / kernel_scale
    w = np.maximum(f32(0), f32(1) - np.abs(x))
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(f32).eps),
                 w / np.where(total != 0, total, f32(1)), f32(0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, f32(0)).astype(f32)


def resize_for_clip(images: torch.Tensor, cfg: CLIPConfig) -> torch.Tensor:
    """uint8 (B, H, W, 3) -> float (B, image_size, image_size, 3) in
    [0, 1], resized as ``jax.image.resize(..., "bilinear")`` resizes."""
    x = images.float() / 255.0
    h, w = x.shape[1:3]
    s = cfg.image_size
    if (h, w) == (s, s):
        return x
    wh, ww = (torch.from_numpy(_resize_weights(n, s)).to(x.device)
              for n in (h, w))
    return torch.einsum("bhwc,hy,wx->byxc", x, wh, ww)


def load_openai_checkpoint(path: str, cfg: CLIPConfig,
                           allow_unsafe: bool = False) -> CLIPModel:
    """A :class:`CLIPModel` from an openai/CLIP checkpoint (a TorchScript
    archive, or a pickled model or state dict through the gated load of
    :func:`~dalle_tpu_torch.utils.torch_io.torch_load_trusted`:
    ``allow_unsafe`` for trusted files only). Extra entries of the
    released state dict (``input_resolution``, ``context_length``,
    ``vocab_size``) are dropped."""
    from dalle_tpu_torch.utils.torch_io import torch_load_trusted
    try:
        sd = torch.jit.load(path, map_location="cpu").state_dict()
    except RuntimeError:
        ckpt = torch_load_trusted(path, allow_unsafe=allow_unsafe)
        sd = (ckpt.get("state_dict", ckpt) if isinstance(ckpt, dict)
              else ckpt.state_dict())
    model = CLIPModel(cfg)
    own = model.state_dict()
    model.load_state_dict({k: v for k, v in sd.items() if k in own})
    return model.eval()


# ---------------------------------------------------------------------------
# CLIP byte-level BPE tokenizer (pure Python, offline)
# ---------------------------------------------------------------------------

def _bytes_to_unicode() -> Dict[int, str]:
    bs = (list(range(ord("!"), ord("~") + 1)) +
          list(range(ord("\xa1"), ord("\xac") + 1)) +
          list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


class CLIPTokenizer:
    """The byte-level BPE CLIP text encoders expect, reading the public
    ``bpe_simple_vocab_16e6.txt.gz`` merges file from disk (the file the
    reference's ``clip.tokenize`` uses internally)."""

    def __init__(self, bpe_path: str, context_length: int = 77):
        import re
        self._re = re
        self.context_length = context_length
        self.byte_encoder = _bytes_to_unicode()
        with gzip.open(bpe_path, "rt", encoding="utf-8") as f:
            merges = f.read().split("\n")
        merges = [tuple(m.split()) for m in merges[1:48894 + 1] if m]
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        vocab.extend("".join(m) for m in merges)
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        # CLIP's original pattern uses \p{L}/\p{N} (regex module); stdlib
        # `re` has no Unicode property classes, so letters are [^\W\d_]+
        # and the punctuation run [^\s\p{L}\p{N}]+ becomes (?:[^\s\w]|_)+
        # (underscore is \w in Python but punctuation to CLIP) — identical
        # on ASCII captions, which is what the LAION-en captions here are.
        self.pat = re.compile(
            r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"
            r"[^\W\d_]+|[0-9]|(?:[^\s\w]|_)+", re.IGNORECASE | re.UNICODE)
        self.cache: Dict[str, str] = {}

    def _bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word: Tuple[str, ...] = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = set(zip(word[:-1], word[1:]))
            bigram = min(pairs,
                         key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            out: List[str] = []
            i = 0
            while i < len(word):
                if (i < len(word) - 1 and word[i] == first
                        and word[i + 1] == second):
                    out.append(first + second)
                    i += 2
                else:
                    out.append(word[i])
                    i += 1
            word = tuple(out)
        result = " ".join(word)
        self.cache[token] = result
        return result

    def encode(self, text: str) -> np.ndarray:
        text = html.unescape(html.unescape(text)).strip().lower()
        text = self._re.sub(r"\s+", " ", text)
        ids: List[int] = [self.encoder["<|startoftext|>"]]
        for token in self._re.findall(self.pat, text):
            token = "".join(self.byte_encoder[b]
                            for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(token).split(" "))
        ids.append(self.encoder["<|endoftext|>"])
        if len(ids) > self.context_length:
            # keep EOT at the end: encode_text locates the sequence
            # embedding via argmax over ids, which must find EOT
            ids = ids[: self.context_length]
            ids[-1] = self.encoder["<|endoftext|>"]
        out = np.zeros(self.context_length, np.int32)
        out[: len(ids)] = ids
        return out
