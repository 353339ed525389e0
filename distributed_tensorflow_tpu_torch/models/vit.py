"""Vision Transformer (ViT) image classification, in PyTorch.

Counterpart of ``distributed_tensorflow_tpu/models/vit.py``: ``ViTConfig``,
``vit_base``, ``vit_tiny`` and ``ViT`` (``init``, ``apply``, ``loss_fn``).
The patch embedding is one strided convolution (stride = patch, VALID),
through the layer library's NHWC convolution (cuDNN on the card, as the
JAX package leaves it to XLA), then a zero-initialised CLS token, learned
positions over ``1 + n_patches`` tokens, pre-LN encoder layers, a final
LayerNorm and a linear head on the CLS token.

Functional like ``models/bert.py``, whose helpers it shares: ``init``
returns a flat dict of f32 leaf tensors under the JAX tree's paths, the
encoder unstacked (``encoder.<i>.<path>``).  Every LayerNorm goes through
the LayerNorm kernel and every attention through the flash kernel,
non-causal and unmasked; 197 tokens at 224/16 is three 64-row tiles and
a ragged one.  ``ViTConfig.use_flash`` is the JAX package's gate and has
no effect.

``partition_rules(fsdp=)`` is the JAX table over the port's names.  With
``fsdp=True`` it gives ZeRO its blocks (``train.shard_train_state`` on
an ``fsdp`` axis; the model itself stays whole).  Tensor parallelism
(``ViT(config, mesh=...)`` with a ``tensor`` axis of T > 1 ranks,
beside ``data``): ``init`` draws the whole model and returns this rank's
blocks, and the model computes on them as ``Bert`` does: the patch
convolution column-parallel (this rank's output channels, with its
slice of the replicated bias, gathered whole over the line before the
CLS token and the positions), Megatron attention and FFN
(``ops.attention.attention_core(mesh=)``, ``models.bert.ffn``), and the
head cut over the classes (its replicated bias sliced the same way):
``loss_fn`` takes ``tensor_parallel.vocab_parallel_cross_entropy`` and
``vocab_parallel_argmax`` of the cut logits, ``apply`` gathers them
whole.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, Optional

import torch

from ..ops import initializers as init_lib
from ..ops import losses as loss_lib
from ..ops.attention import attention_core, dropout, resolve_activation
from ..ops.kernels import flash_attention as flash_lib
from ..ops.layers import _nhwc_conv
from ..parallel import sharding as sharding_lib
from ..parallel import tensor_parallel as tp_lib
from .bert import (attention_params, ffn, init_attention, init_ffn,
                   init_ln, layer_norm, stacked_decay_mask, trainable)
from .gpt import _checkpointed

__all__ = ["ViTConfig", "ViT", "vit_base", "vit_tiny"]


@dataclasses.dataclass
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    channels: int = 3
    num_classes: int = 1000
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    dropout_rate: float = 0.0
    layer_norm_eps: float = 1e-6
    dtype: torch.dtype = torch.float32
    # FFN activation (ops.attention.resolve_activation)
    hidden_act: str = "gelu_approx"
    remat: bool = False
    # the JAX package's kernel gate; no effect here
    use_flash: Any = "auto"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def act_fn(self) -> Callable:
        return resolve_activation(self.hidden_act)

    @property
    def n_patches(self) -> int:
        side = self.image_size // self.patch_size
        return side * side


def vit_base(**kw) -> "ViT":
    """ViT-B/16 at 224: d 768, 12 layers of 12 heads, FFN 3072."""
    return ViT(ViTConfig(**kw))


def vit_tiny(**kw) -> "ViT":
    """The JAX package's ``vit_tiny``: 32x32 images in 8x8 patches, d 64,
    2 layers of 2 heads, 10 classes."""
    for k, v in dict(image_size=32, patch_size=8, num_classes=10,
                     hidden_size=64, num_layers=2, num_heads=2,
                     intermediate_size=128).items():
        kw.setdefault(k, v)
    return ViT(ViTConfig(**kw))


class ViT:
    """Functional ViT: ``init(generator) -> params``, ``apply(params,
    images)``, ``loss_fn``.  ``mesh``: a ``parallel.Mesh`` with a
    ``tensor`` axis for tensor parallelism (module docstring)."""

    def __init__(self, config: ViTConfig, mesh=None):
        self.config = config
        self.mesh = mesh
        # the tensor line, None at T = 1
        self.line = tp_lib.active(mesh)
        if self.line is not None:
            sharding_lib.check_mesh(mesh)
        self.stacks = {"encoder": config.num_layers}

    def decay_mask(self, params: Mapping[str, torch.Tensor]
                   ) -> Dict[str, bool]:
        """``adamw``'s mask for these parameters, the JAX default (as
        ``Bert.decay_mask``)."""
        return stacked_decay_mask(params, self.stacks)

    def init(self, generator: Optional[torch.Generator] = None
             ) -> Dict[str, torch.Tensor]:
        """Patch kernel lecun-normal, positions and encoder kernels
        truncated normal (std 0.02), CLS token, biases and head zero,
        norms identity; drawn from ``generator`` on its device.  Under
        tensor parallelism the whole model is drawn and this rank's
        blocks returned."""
        c = self.config
        if c.image_size % c.patch_size:
            raise ValueError(f"image_size {c.image_size} not divisible by "
                             f"patch_size {c.patch_size}")
        dev = init_lib._device(generator)
        trunc = init_lib.truncated_normal(0.02)

        def draw(shape):
            return trunc(generator, shape)

        def zeros(shape):
            return torch.zeros(shape, device=dev)
        d, h, hd, i = c.hidden_size, c.num_heads, c.head_dim, \
            c.intermediate_size
        params = {
            "patch_embed.kernel": init_lib.lecun_normal()(
                generator, (c.patch_size, c.patch_size, c.channels, d)),
            "patch_embed.bias": zeros((d,)),
            "cls_token": zeros((1, 1, d)),
            "pos_embed": draw((1, 1 + c.n_patches, d))}
        for layer in range(c.num_layers):
            pre = f"encoder.{layer}"
            params.update(init_attention(draw, d, h, hd, pre + ".attention",
                                         zeros))
            params.update(init_ln(d, pre + ".attention.ln", dev))
            params.update(init_ffn(draw, d, i, pre + ".ffn", zeros))
            params.update(init_ln(d, pre + ".ffn.ln", dev))
        params.update(init_ln(d, "final_ln", dev))
        params.update({"head.kernel": zeros((d, c.num_classes)),
                       "head.bias": zeros((c.num_classes,))})
        params = trainable(params)
        if self.line is None:
            return params
        return sharding_lib.cut_blocks(params, self.partition_rules(),
                                       self.line)

    def _encoder_layer(self, p: Mapping[str, torch.Tensor], x, generator,
                       train):
        """Pre-LN: x + attn(LN(x)); x + ffn(LN(x))."""
        c = self.config
        y = layer_norm(p, "attention.ln", x, c.layer_norm_eps)
        y = attention_core(
            attention_params(p, "attention"), y,
            dropout_rate=c.dropout_rate, generator=generator, train=train,
            attention_fn=flash_lib.make_flash_attention_fn(causal=False),
            mesh=self.line)
        x = x + dropout(y, c.dropout_rate, generator, train)
        y = ffn(p, "ffn", layer_norm(p, "ffn.ln", x, c.layer_norm_eps),
                c.act_fn, self.line)
        return x + dropout(y, c.dropout_rate, generator, train)

    def _column(self, params: Mapping[str, torch.Tensor], prefix: str,
                x: torch.Tensor, linear: Callable) -> torch.Tensor:
        """``linear(x, kernel) + bias`` of ``<prefix>.kernel`` /
        ``.bias``; under tensor parallelism this rank's output columns
        (the kernel's last dim is its block) with its slice of the
        replicated bias, whose gradient the line sums with x's."""
        kernel = params[prefix + ".kernel"]
        bias = params[prefix + ".bias"]
        if self.line is None:
            return linear(x, kernel) + bias.to(x.dtype)
        n = kernel.shape[-1]
        x, bias = tp_lib.copy_to_line(x, self.line, bias)
        at = tp_lib.index(self.line) * n
        return linear(x, kernel) + bias[at:at + n].to(x.dtype)

    def _features(self, params, images, train, rng):
        """The final-LN token sequence [batch, 1 + n_patches, hidden]."""
        c = self.config
        if train and c.dropout_rate > 0.0 and rng is None:
            raise ValueError("ViT.apply(train=True) requires a generator "
                             "(rng) for dropout")
        dev = params["pos_embed"].device
        p = c.patch_size
        x = self._column(
            params, "patch_embed",
            torch.as_tensor(images, device=dev).to(c.dtype),
            lambda x, k: _nhwc_conv(x, k.to(c.dtype), (p, p), "VALID"))
        x = tp_lib.gather_from_line(x, self.line)
        b = x.shape[0]
        x = x.reshape(b, -1, c.hidden_size)
        cls = params["cls_token"].to(c.dtype).expand(b, 1, c.hidden_size)
        x = torch.cat([cls, x], dim=1) + params["pos_embed"].to(c.dtype)
        x = dropout(x, c.dropout_rate, rng, train)
        for i in range(c.num_layers):
            pre = f"encoder.{i}."
            names = [n for n in params if n.startswith(pre)]

            def layer(x, *tensors, rel=[n[len(pre):] for n in names]):
                return self._encoder_layer(dict(zip(rel, tensors)), x, rng,
                                           train)
            tensors = [params[n] for n in names]
            if c.remat:
                x = _checkpointed(layer, rng, None, x, *tensors)
            else:
                x = layer(x, *tensors)
        return layer_norm(params, "final_ln", x, c.layer_norm_eps)

    def _local_logits(self, features, params) -> torch.Tensor:
        """The head's f32 logits of this rank's classes (all of them at
        T = 1) from the CLS token."""
        cls_out = features[:, 0]
        return self._column(params, "head", cls_out,
                            lambda x, k: x @ k.to(x.dtype)).float()

    def apply(self, params: Mapping[str, torch.Tensor], images, *,
              train: bool = False, rng: Optional[torch.Generator] = None,
              return_features: bool = False) -> torch.Tensor:
        """NHWC images -> [batch, num_classes] f32 logits (gathered whole
        over a tensor line); with ``return_features`` the final-LN token
        sequence [batch, 1 + n_patches, hidden] instead."""
        x = self._features(params, images, train, rng)
        if return_features:
            return x
        return tp_lib.gather_from_line(self._local_logits(x, params),
                                       self.line)

    def loss_fn(self) -> Callable:
        """``train.make_custom_train_step``'s contract; ``batch`` is
        ``(images, integer labels)``; metric ``accuracy``.  Under tensor
        parallelism the logits stay cut over the classes, into the
        vocabulary-parallel cross entropy and argmax."""
        def loss_fn(params, model_state, batch, generator, train):
            images, labels = batch
            labels = labels.to(params["pos_embed"].device).long()
            logits = self._local_logits(
                self._features(params, images, train, generator), params)
            if self.line is None:
                loss = loss_lib.softmax_cross_entropy_with_integer_labels(
                    logits, labels)
            else:
                loss = tp_lib.vocab_parallel_cross_entropy(
                    logits, labels, self.line).mean()
            with torch.no_grad():
                accuracy = (tp_lib.vocab_parallel_argmax(logits, self.line)
                            == labels).float().mean()
            return loss, ({"accuracy": accuracy}, model_state)
        return loss_fn

    def partition_rules(self, fsdp: bool = False
                        ) -> sharding_lib.PartitionRules:
        """The JAX package's table (``ViT.partition_rules``) over the
        port's per-layer names: the BERT layout (heads and the FFN's
        hidden dim over ``tensor``), the patch kernel's output channels
        and the head's classes over ``tensor``; ``fsdp=True`` cuts the
        other large dim of each matrix over ``fsdp``."""
        f = "fsdp" if fsdp else None
        enc = r"^encoder\.\d+\."
        return sharding_lib.PartitionRules([
            (r"^patch_embed\.kernel$", (None, None, None, "tensor")),
            (enc + r"attention\.(query|key|value)\.kernel$",
             (f, "tensor", None)),
            (enc + r"attention\.(query|key|value)\.bias$",
             ("tensor", None)),
            (enc + r"attention\.out\.kernel$", ("tensor", None, f)),
            (enc + r"ffn\.w_in\.kernel$", (f, "tensor")),
            (enc + r"ffn\.w_in\.bias$", ("tensor",)),
            (enc + r"ffn\.w_out\.kernel$", ("tensor", f)),
            (r"^head\.kernel$", (f, "tensor")),
        ])
