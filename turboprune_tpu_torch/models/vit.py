"""Vision Transformer / DeiT in torch.nn (port of
``turboprune_tpu/models/vit.py``).

Module names follow the flax param paths (``patch_embed``, ``cls_token``,
``pos_embed``, ``block{i}.norm1``, ``block{i}.attn.{query,key,value,out}``,
``block{i}.norm2``, ``block{i}.mlp.fc1/fc2``, ``norm``, ``head``,
``head_dist``), so ``bridge.py`` maps checkpoints mechanically and mask keys
are the flax path names.

The dtype flow mirrors flax op by op. Params stay fp32; each conv/dense
casts its input and weights to the compute dtype. LayerNorm computes in
fp32 and returns fp32 (flax promotes with its fp32 params), which the next
dense casts back down. The residual stream stays in the compute dtype. The
head runs in fp32. GELU is exact.

Images come in NHWC ``[n, H, W, C]`` as in the JAX package; the patch
embedding permutes to NCHW inside the model, and its output is flattened
row-major over (H', W') as flax's reshape of the NHWC conv output is.
"""

from __future__ import annotations

import math
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.flash import flash_attention
from ..parallel.ring import ring_attention
from .dropout import dropout, forward_noise

ATTENTION_IMPLS = ("dense", "ring", "flash")

class Dense(nn.Linear):
    """``nn.Dense``/``DenseGeneral`` with flax's dtype handling: fp32
    params, input and weights cast to ``dtype`` for the product."""

    def __init__(self, in_features: int, out_features: int, dtype=torch.float32):
        super().__init__(in_features, out_features)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(
            x.to(self.dtype), self.weight.to(self.dtype), self.bias.to(self.dtype)
        )


class LayerNorm(nn.LayerNorm):
    """flax ``nn.LayerNorm(epsilon=1e-6)``: statistics and output in fp32."""

    def __init__(self, dim: int):
        super().__init__(dim, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(
            x.float(), self.normalized_shape, self.weight, self.bias, self.eps
        )


class PatchEmbed(nn.Conv2d):
    """Non-overlapping patch conv on NHWC input; returns [n, H'W', E]."""

    def __init__(self, in_chans: int, embed_dim: int, patch: int, dtype):
        super().__init__(in_chans, embed_dim, patch, stride=patch)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        y = F.conv2d(
            x, self.weight.to(self.dtype), self.bias.to(self.dtype),
            stride=self.stride,
        )
        return y.flatten(2).transpose(1, 2)


class SelfAttention(nn.Module):
    """Multi-head self-attention with flax MHA's param names
    (query/key/value/out). ``impl="dense"`` mirrors
    ``nn.MultiHeadDotProductAttention`` (materialised scores, softmax in the
    compute dtype); ``impl="flash"`` mirrors ``FlashSelfAttention``: tokens
    padded to a multiple of ``block``, ``[B*H, S, hd]`` into
    ``ops.flash.flash_attention`` with the validity row of the true length,
    padded query rows sliced away; ``impl="ring"`` mirrors
    ``RingSelfAttention``: tokens padded to a multiple of the ring's size
    (``mesh.model_size``), ``parallel.ring.ring_attention`` over the
    mesh's model axis, padded query rows sliced away."""

    def __init__(self, dim: int, num_heads: int, dtype, impl: str, block: int = 128,
                 mesh: Optional[Any] = None):
        super().__init__()
        if impl not in ATTENTION_IMPLS:
            raise ValueError(f"unknown attention impl {impl!r}")
        if impl == "ring" and mesh is None:
            raise ValueError(
                "attention_impl='ring' needs a mesh (create_model(..., "
                "mesh=...) — the harness passes its own)"
            )
        self.num_heads = num_heads
        self.impl = impl
        self.block = block
        self.mesh = mesh
        self.query = Dense(dim, dim, dtype)
        self.key = Dense(dim, dim, dtype)
        self.value = Dense(dim, dim, dtype)
        self.out = Dense(dim, dim, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, s, d = x.shape
        h = self.num_heads
        hd = d // h
        q, k, v = (
            proj(x).view(n, s, h, hd) for proj in (self.query, self.key, self.value)
        )
        if self.impl == "dense":
            q = q / math.sqrt(hd)
            w = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k), dim=-1)
            out = torch.einsum("bhqk,bkhd->bqhd", w, v)
        elif self.impl == "ring":
            pad = (-s) % self.mesh.model_size
            if pad:
                q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
            valid = torch.arange(s + pad, device=x.device) < s
            out = ring_attention(q, k, v, valid, self.mesh)[:, :s]
        else:
            pad = (-s) % self.block
            if pad:
                q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
            s_pad = s + pad
            q, k, v = (
                t.transpose(1, 2).reshape(n * h, s_pad, hd) for t in (q, k, v)
            )
            valid = (torch.arange(s_pad, device=x.device) < s)[None, :]
            out = flash_attention(
                q, k, v, valid, 1.0 / math.sqrt(hd), self.block, self.block
            )
            out = out.reshape(n, h, s_pad, hd).transpose(1, 2)[:, :s]
        return self.out(out.reshape(n, s, d))


def _dense(in_features: int, out_features: int, dtype, nm: Optional[tuple]) -> nn.Linear:
    """``Dense``, or with an N:M hook (kept_in, kept_out) the gathered
    ``sparse.nm_execute.NMDense`` under the same name."""
    if nm is None:
        return Dense(in_features, out_features, dtype)
    from ..sparse.nm_execute import NMDense

    return NMDense(in_features, out_features, *nm, dtype=dtype)


class MlpBlock(nn.Module):
    def __init__(self, dim: int, hidden: int, dropout_rate: float, dtype,
                 nm_fc1: Optional[tuple] = None, nm_fc2: Optional[tuple] = None):
        super().__init__()
        self.fc1 = _dense(dim, hidden, dtype, nm_fc1)
        self.fc2 = _dense(hidden, dim, dtype, nm_fc2)
        self.dropout_rate = dropout_rate

    def forward(self, x: torch.Tensor, noise: Optional[list] = None) -> torch.Tensor:
        hidden_noise, out_noise = noise if noise else (None, None)
        x = dropout(F.gelu(self.fc1(x), approximate="none"), self.dropout_rate, hidden_noise)
        return dropout(self.fc2(x), self.dropout_rate, out_noise)


class EncoderBlock(nn.Module):
    def __init__(
        self,
        dim: int,
        num_heads: int,
        mlp_ratio: float = 4.0,
        dropout_rate: float = 0.0,
        dtype=torch.float32,
        attention_impl: str = "dense",
        mlp_hidden: Optional[int] = None,
        nm: Optional[dict] = None,
        mesh: Optional[Any] = None,
    ):
        # No attention dropout: the JAX model never sets it (the
        # reference's DeiT configs use attn_drop=0). ``mlp_hidden``: a
        # compacted MLP width; ``nm``: the block's N:M hooks keyed
        # "attn/query" ... "mlp/fc2" (projection hooks under dense
        # attention only); ``mesh``: ring attention's (parallel.Mesh).
        super().__init__()
        nm = nm or {}
        attn_nm = {k.split("/")[1]: v for k, v in nm.items() if k.startswith("attn/")}
        self.norm1 = LayerNorm(dim)
        if attn_nm:
            if attention_impl != "dense":
                raise ValueError("N:M attention projections need attention_impl='dense'")
            from ..sparse.nm_execute import NMSelfAttention

            self.attn = NMSelfAttention(dim, num_heads, dtype, attn_nm)
        else:
            self.attn = SelfAttention(dim, num_heads, dtype, attention_impl, mesh=mesh)
        self.norm2 = LayerNorm(dim)
        self.mlp = MlpBlock(dim, mlp_hidden or int(dim * mlp_ratio), dropout_rate, dtype,
                            nm.get("mlp/fc1"), nm.get("mlp/fc2"))

    def forward(self, x: torch.Tensor, noise: Optional[list] = None) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x), noise)


class VisionTransformer(nn.Module):
    """DeiT. ``image_size`` fixes the patch count (flax infers it at init);
    ``attention_impl="ring"`` shards the tokens over ``mesh``'s model axis
    (``parallel/ring.py``) with the params of the dense attention, and
    needs the mesh (the harness passes its own).
    ``width_overrides`` ("block{i}/mlp/fc1" -> kept hidden width) and
    ``nm_overrides`` ("block{i}/mlp/fc1" | "block{i}/mlp/fc2" | "head" |
    "head_dist", and "block{i}/attn/{query,key,value,out}" under dense
    attention -> (kept_in, kept_out)) are the sparse execution's
    (sparse/); module names stay the same."""

    def __init__(
        self,
        num_classes: int,
        patch_size: int = 16,
        embed_dim: int = 384,
        depth: int = 12,
        num_heads: int = 6,
        mlp_ratio: float = 4.0,
        dropout_rate: float = 0.0,
        distilled: bool = False,
        dtype: Any = torch.float32,
        attention_impl: str = "dense",
        image_size: int = 224,
        in_chans: int = 3,
        width_overrides: Optional[Any] = None,
        nm_overrides: Optional[Any] = None,
        mesh: Optional[Any] = None,
    ):
        super().__init__()
        ov = dict(width_overrides or {})
        nv = dict(nm_overrides or {})
        if attention_impl not in ATTENTION_IMPLS:
            raise ValueError(f"attention_impl={attention_impl!r} not in {ATTENTION_IMPLS}")
        if image_size % patch_size:
            raise ValueError(f"image_size {image_size} % patch_size {patch_size} != 0")
        self.num_classes = num_classes
        self.embed_dim = embed_dim
        self.dropout_rate = dropout_rate
        self.distilled = distilled
        self.dtype = dtype
        self.attention_impl = attention_impl
        num_patches = (image_size // patch_size) ** 2
        extra = 2 if distilled else 1
        self.patch_embed = PatchEmbed(in_chans, embed_dim, patch_size, dtype)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        if distilled:
            self.dist_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, num_patches + extra, embed_dim))
        self.depth = depth
        for i in range(depth):
            self.add_module(
                f"block{i}",
                EncoderBlock(
                    embed_dim,
                    num_heads,
                    mlp_ratio,
                    dropout_rate,
                    dtype=dtype,
                    attention_impl=attention_impl,
                    mlp_hidden=ov.get(f"block{i}/mlp/fc1"),
                    nm={k[len(f"block{i}/"):]: v for k, v in nv.items()
                        if k.startswith(f"block{i}/")},
                    mesh=mesh,
                ),
            )
        self.norm = LayerNorm(embed_dim)
        self.head = _dense(embed_dim, num_classes, torch.float32, nv.get("head"))
        if distilled:
            self.head_dist = _dense(embed_dim, num_classes, torch.float32, nv.get("head_dist"))

    def blocks(self) -> list[EncoderBlock]:
        return [getattr(self, f"block{i}") for i in range(self.depth)]

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "VisionTransformer":
        """flax's initializers from an explicit generator: truncated normal
        (0.02) for the tokens and position embedding, lecun_normal for conv
        and dense kernels, zero biases, LayerNorm ones/zeros."""
        for p in (self.cls_token, self.pos_embed, getattr(self, "dist_token", None)):
            if p is not None:
                _trunc_normal(p, 0.02, generator)
        for module in self.modules():
            if isinstance(module, (nn.Linear, nn.Conv2d)):
                fan_in = module.weight[0].numel()
                # lecun_normal: truncated normal whose std after the +-2
                # sigma cut is sqrt(1/fan_in).
                _trunc_normal(module.weight, math.sqrt(1.0 / fan_in) / 0.87962566103423978, generator)
                module.bias.zero_()
            elif isinstance(module, nn.LayerNorm):
                module.weight.fill_(1.0)
                module.bias.zero_()
        return self

    def dropout_shapes(self, n: int) -> list[tuple[int, ...]]:
        """Shapes of the uniforms a train forward of ``n`` images takes, in
        the order it uses them (after the position embedding, then each
        block's MLP hidden and output); empty when the rate is 0."""
        if self.dropout_rate == 0.0:
            return []
        s, d = self.pos_embed.shape[1], self.embed_dim
        shapes = [(n, s, d)]
        for block in self.blocks():
            shapes += [(n, s, block.mlp.fc1.out_features), (n, s, d)]
        return shapes

    def forward(self, x: torch.Tensor, noise: Optional[list] = None) -> torch.Tensor:
        noise = forward_noise(self, noise)
        n = x.shape[0]
        x = self.patch_embed(x)
        tokens = [self.cls_token.to(self.dtype).expand(n, -1, -1)]
        if self.distilled:
            tokens.append(self.dist_token.to(self.dtype).expand(n, -1, -1))
        x = torch.cat(tokens + [x], dim=1)
        x = dropout(x + self.pos_embed.to(self.dtype), self.dropout_rate,
                    noise[0] if noise else None)
        for i, block in enumerate(self.blocks()):
            x = block(x, noise[1 + 2 * i:3 + 2 * i] if noise else None)
        x = self.norm(x).float()
        if not self.distilled:
            return self.head(x[:, 0])
        # Mean of both heads, as in the JAX model (no teacher at inference).
        return (self.head(x[:, 0]) + self.head_dist(x[:, 1])) / 2.0


def _trunc_normal(t: torch.Tensor, std: float, generator: torch.Generator) -> None:
    nn.init.trunc_normal_(t, std=std, a=-2.0 * std, b=2.0 * std, generator=generator)


def _deit(embed_dim, depth, num_heads, distilled=False):
    def ctor(num_classes: int, cifar_stem: bool = False, **kw) -> VisionTransformer:
        del cifar_stem  # ViTs have no CIFAR stem surgery in the reference
        return VisionTransformer(
            num_classes=num_classes,
            embed_dim=embed_dim,
            depth=depth,
            num_heads=num_heads,
            distilled=distilled,
            **kw,
        )

    return ctor


deit_tiny_patch16_224 = _deit(192, 12, 3)
deit_small_patch16_224 = _deit(384, 12, 6)
deit_base_patch16_224 = _deit(768, 12, 12)
deit_base_patch16_384 = _deit(768, 12, 12)
deit_tiny_distilled_patch16_224 = _deit(192, 12, 3, distilled=True)
deit_small_distilled_patch16_224 = _deit(384, 12, 6, distilled=True)
deit_base_distilled_patch16_224 = _deit(768, 12, 12, distilled=True)
deit_base_distilled_patch16_384 = _deit(768, 12, 12, distilled=True)
