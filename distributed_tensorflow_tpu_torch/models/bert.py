"""BERT encoder (MLM pre-training and classifier fine-tuning), in PyTorch.

Counterpart of ``distributed_tensorflow_tpu/models/bert.py``: ``BertConfig``,
``bert_base``, ``bert_tiny``, ``mlm_gather_flops_correction`` and ``Bert``
(``init``, ``apply``, ``mlm_logits``, ``pooled``, ``mlm_loss_fn``), with the
post-LN encoder layer, the tied MLM head and its gathered variant
(``mlm_predictions_per_seq``).

Functional, as in the JAX package: ``Bert.init(generator)`` returns the
parameters, a flat dict of f32 leaf tensors that require gradients (on the
generator's device), and every other method reads them from the dict it
is given, so the train step's casts and gradients land on them and an
entry point may add leaves of its own (``examples/finetune_bert.py``'s
classifier).  The names are the JAX tree's paths with the encoder
unstacked: ``encoder.<i>.<path>`` is layer i of the JAX leaf
``encoder.<path>`` (the JAX package stacks the layers on a leading
``[L]`` axis for its scan; here each layer keeps its own tensors, so a
layer's backward writes only its own gradients).  ``models/convert.py``
carries the tree both ways.

Kernels: every LayerNorm (the embeddings', two a layer and the MLM
head's) goes through ``ops.kernels.fused.fused_layernorm`` and every
attention through ``ops.kernels.flash_attention``, non-causal, the
``attention_mask`` turned into the kernel's ``kv_valid`` plane by
``make_flash_attention_fn``.  On a CPU tensor those wrappers run their
plain versions; on a CUDA tensor they launch the kernels.  The JAX
package's gates (``use_flash="auto"``, ``fused_layernorm``) are not
ported: ``BertConfig`` keeps both fields, which have no effect.  One
consequence: a row whose keys are all padding attends to nothing and
gives zeros, as the JAX flash kernel does (``use_flash=True``), where the
JAX package's dense path gives the mean of V.

Dropout draws from the step's ``torch.Generator`` (embeddings, the
attention context, both residual branches), so its bits differ from
``jax.random``'s.  ``remat`` runs each layer under the GPT's
``_checkpointed`` (selective for the "dots" policies, the generator's
state replayed).

Tensor parallelism (``Bert(config, mesh=...)`` with a ``tensor`` axis of
T > 1 ranks; ``partition_rules`` is the JAX package's table):
``init`` draws the whole model, as at T = 1, and returns this rank's
blocks (marked, ``parallel.sharding.mark_block``).  The word embedding is
looked up vocabulary-parallel; every layer is Megatron's (a rank's
heads, the row-parallel attention output, the column-parallel ``w_in``
into the row-parallel ``w_out``: ``ops/attention.py``); the MLM
transform and the pooler are column-parallel (``[d, d/T]`` kernels, this
rank's slice of the replicated bias), gathered whole over the line
before the transform's LayerNorm and the classifier; the MLM logits stay
cut over the vocabulary (with ``mlm.output_bias``'s block) into the
vocabulary-parallel cross entropy and argmax.  ``mlm_logits`` gathers
them whole.

Sequence parallelism (``seq_axis`` with ``Bert(config, mesh=...)``):
every rank of the axis passes the global batch and computes its shard
of the sequence through every layer, attention as bidirectional
ring-flash (``parallel/ring_flash.py``) with the key-padding plane
rotating with K/V; ``apply`` gathers the global output, so the pooler's
``[CLS]`` is the global position 0.  ``mlm_loss_fn`` never gathers: its
sums (nll, hits) are summed over the axis and divided by the global mask
weight, so the loss equals the dense one on every rank of the axis.

Both at once (``seq_axis`` on a mesh with a ``tensor`` axis of T > 1,
``{"seq": S, "tensor": T}`` or with ``data``: the JAX package's
multi-chip mesh): a rank runs its Megatron blocks on its sequence shard,
the ring-flash ring of its seq line carrying its ``h/T`` heads and the
key plane; ``apply`` gathers over ``seq`` (the pooler reads the global
``[CLS]``) and the column-parallel heads over ``tensor``;
``mlm_loss_fn`` scores the shard's masked positions with the
vocabulary-parallel cross entropy and sums over ``seq``, as each alone.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, Optional

import torch
import torch.nn.functional as F

from ..ops import initializers as init_lib
from ..ops.attention import (attention_core, dropout, ffn_core,
                             padding_mask, resolve_activation)
from ..ops.kernels import flash_attention as flash_lib
from ..ops.kernels import fused as fused_lib
from ..parallel import ring as ring_lib
from ..parallel import ring_flash as ring_flash_lib
from ..parallel import sharding as sharding_lib
from ..parallel import tensor_parallel as tp_lib
from .gpt import _REMAT_SAVES, _checkpointed

__all__ = ["BertConfig", "Bert", "bert_base", "bert_tiny",
           "mlm_gather_flops_correction"]

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position: int = 512
    type_vocab_size: int = 2
    dropout_rate: float = 0.1
    layer_norm_eps: float = 1e-12
    dtype: torch.dtype = torch.float32     # activation/compute dtype
    # checkpoint each encoder layer; "full" saves nothing, "dots" every
    # matrix product's output, "dots_no_batch" the weight products
    remat: bool = False
    remat_policy: str = "full"
    # sequence parallelism: ring-flash attention over this mesh axis
    # (Bert(config, mesh=...)); None: off
    seq_axis: Optional[str] = None
    # the JAX package's kernel gates; no effect here: on the card the
    # flash and LayerNorm kernels are always the path
    use_flash: Any = "auto"
    fused_layernorm: Any = False
    # > 0: gather at most N masked positions a sequence before the MLM
    # head (the lower position first among the masked), so the head runs
    # on those rows only; 0 projects every position
    mlm_predictions_per_seq: int = 0
    # FFN / MLM-transform activation (ops.attention.resolve_activation)
    hidden_act: str = "gelu_approx"

    def __post_init__(self):
        if self.remat_policy not in _REMAT_SAVES:
            raise ValueError(f"remat_policy must be 'full', 'dots', or "
                             f"'dots_no_batch'; got {self.remat_policy!r}")
        if self.hidden_size % self.num_heads:
            raise ValueError(f"hidden_size {self.hidden_size} not divisible "
                             f"by num_heads {self.num_heads}")

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def act_fn(self) -> Callable:
        return resolve_activation(self.hidden_act)


def bert_base(**kw) -> "Bert":
    """BERT-base: vocab 30522, d 768, 12 layers of 12 heads, FFN 3072."""
    return Bert(BertConfig(**kw))


def bert_tiny(**kw) -> "Bert":
    """The JAX package's ``bert_tiny`` sizes: 2 layers, d 128, 2 heads."""
    for k, v in dict(hidden_size=128, num_layers=2, num_heads=2,
                     intermediate_size=512, vocab_size=1000,
                     max_position=128).items():
        kw.setdefault(k, v)
    return Bert(BertConfig(**kw))


def layer_norm(params: Mapping[str, torch.Tensor], prefix: str,
               x: torch.Tensor, eps: float) -> torch.Tensor:
    """The LayerNorm kernel (its plain version on a CPU tensor) with the
    f32 ``<prefix>.gamma`` / ``<prefix>.beta`` of ``params``; output in
    x's type.  Shared by ViT and seq2seq, as the JAX ``_layer_norm``."""
    return fused_lib.fused_layernorm(x.contiguous(),
                                     params[prefix + ".gamma"].float(),
                                     params[prefix + ".beta"].float(), eps)


def mlm_gather_flops_correction(config: BertConfig, seq: int) -> float:
    """Training flops a token the gathered MLM head skips against
    projecting every position: the transform d^2 and the vocab projection
    d V, 6x each (forward 2x, backward 4x), on the non-gathered share; 0
    when gathering is off."""
    n = config.mlm_predictions_per_seq
    if not n:
        return 0.0
    d, v = config.hidden_size, config.vocab_size
    return (1.0 - n / seq) * 6.0 * (d * d + d * v)


def gather_masked(mask: torch.Tensor, n: int):
    """(weights [b, n], positions [b, n]) of the first ``n`` masked
    positions of each row, as ``lax.top_k`` of the 0/1 mask picks them: a
    stable descending sort keeps the lower position first among equal
    values (``torch.topk`` promises no order for ties).  A row with fewer
    masked positions pads with weight-0 positions; one with more drops
    the rest."""
    w, idx = torch.sort(mask.float(), dim=1, descending=True, stable=True)
    return w[:, :n], idx[:, :n]


def _dense(params, prefix, x):
    """``x @ kernel + bias`` of ``<prefix>.kernel`` / ``.bias`` in x's
    type."""
    return (x @ params[prefix + ".kernel"].to(x.dtype)
            + params[prefix + ".bias"].to(x.dtype))


def attention_params(params: Mapping[str, torch.Tensor], prefix: str):
    """The nested {query, key, value, out: {kernel, bias}} that
    ``attention_core`` takes, from the flat names under ``prefix``."""
    return {n: {"kernel": params[f"{prefix}.{n}.kernel"],
                "bias": params[f"{prefix}.{n}.bias"]}
            for n in ("query", "key", "value", "out")}


def ffn(params: Mapping[str, torch.Tensor], prefix: str, x: torch.Tensor,
        activation: Callable, mesh=None) -> torch.Tensor:
    """``ffn_core`` over ``<prefix>.w_in`` / ``<prefix>.w_out``."""
    return ffn_core(params[prefix + ".w_in.kernel"],
                    params[prefix + ".w_in.bias"],
                    params[prefix + ".w_out.kernel"],
                    params[prefix + ".w_out.bias"], x, activation, mesh)


def init_attention(draw, d: int, h: int, hd: int, prefix: str,
                   zeros) -> Params:
    """Truncated-normal projection kernels and zero biases of one
    attention under ``prefix`` (BERT, ViT and seq2seq alike)."""
    p = {}
    for n in ("query", "key", "value"):
        p[f"{prefix}.{n}.kernel"] = draw((d, h, hd))
        p[f"{prefix}.{n}.bias"] = zeros((h, hd))
    p[f"{prefix}.out.kernel"] = draw((h, hd, d))
    p[f"{prefix}.out.bias"] = zeros((d,))
    return p


def init_ffn(draw, d: int, i: int, prefix: str, zeros) -> Params:
    return {f"{prefix}.w_in.kernel": draw((d, i)),
            f"{prefix}.w_in.bias": zeros((i,)),
            f"{prefix}.w_out.kernel": draw((i, d)),
            f"{prefix}.w_out.bias": zeros((d,))}


def init_ln(d: int, prefix: str, device) -> Params:
    return {prefix + ".gamma": torch.ones(d, device=device),
            prefix + ".beta": torch.zeros(d, device=device)}


def trainable(params: Params) -> Params:
    """The floating leaves made leaf tensors that require gradients."""
    for p in params.values():
        if p.is_floating_point():
            p.requires_grad_(True)
    return params


def stacked_decay_mask(params: Mapping[str, torch.Tensor],
                       stacks: Mapping[str, int]) -> Dict[str, bool]:
    """The JAX ``adamw`` default mask, ``ndim > 1`` on the JAX tree, of a
    functional model's parameters: ``<stack>.<i>.<path>`` for a name in
    ``stacks`` is layer i's slice of a JAX leaf with a leading layer
    axis, so it has one axis more there."""
    return {name: p.dim() + (name.partition(".")[0] in stacks) > 1
            for name, p in params.items()}


class Bert:
    """Functional BERT: ``init(generator) -> params``, ``apply(params,
    input_ids, ...)``, the heads and the MLM loss.  ``mesh``: a
    ``parallel.Mesh`` naming ``config.seq_axis``, or with a ``tensor``
    axis for tensor parallelism (module docstring)."""

    def __init__(self, config: BertConfig, mesh=None):
        if config.seq_axis is not None and (
                mesh is None or config.seq_axis not in mesh.shape):
            raise ValueError(f"seq_axis={config.seq_axis!r} needs "
                             f"Bert(config, mesh=...) with that axis; got "
                             f"{mesh}")
        self.config = config
        self.mesh = mesh
        # the tensor line, None at T = 1
        self.line = tp_lib.active(mesh)
        if self.line is not None:
            sharding_lib.check_mesh(mesh)
        # the layer lists kept unstacked, with their lengths
        self.stacks = {"encoder": config.num_layers}

    def decay_mask(self, params: Mapping[str, torch.Tensor]
                   ) -> Dict[str, bool]:
        """``adamw``'s mask for these parameters (``adamw(lr,
        mask=model.decay_mask)``): the JAX default, so a layer's biases
        and norm scales decay, the embeddings' norm does not."""
        return stacked_decay_mask(params, self.stacks)

    # -- init -------------------------------------------------------------
    def init(self, generator: Optional[torch.Generator] = None) -> Params:
        """Truncated normal (std 0.02, cut at 2 std) embeddings, kernels
        and head, drawn from ``generator`` on its device (the CPU when
        None); zero biases, identity norms.  Under tensor parallelism the
        whole model is drawn and this rank's blocks returned."""
        c = self.config
        dev = init_lib._device(generator)
        trunc = init_lib.truncated_normal(0.02)

        def draw(shape):
            return trunc(generator, shape)

        def zeros(shape):
            return torch.zeros(shape, device=dev)
        d, h, hd, i = c.hidden_size, c.num_heads, c.head_dim, \
            c.intermediate_size
        params = {"embeddings.word": draw((c.vocab_size, d)),
                  "embeddings.position": draw((c.max_position, d)),
                  "embeddings.type": draw((c.type_vocab_size, d)),
                  **init_ln(d, "embeddings.ln", dev)}
        for layer in range(c.num_layers):
            pre = f"encoder.{layer}"
            params.update(init_attention(draw, d, h, hd, pre + ".attention",
                                         zeros))
            params.update(init_ln(d, pre + ".attention.ln", dev))
            params.update(init_ffn(draw, d, i, pre + ".ffn", zeros))
            params.update(init_ln(d, pre + ".ffn.ln", dev))
        params.update({"mlm.transform.kernel": draw((d, d)),
                       "mlm.transform.bias": zeros((d,)),
                       **init_ln(d, "mlm.ln", dev),
                       "mlm.output_bias": zeros((c.vocab_size,)),
                       "pooler.kernel": draw((d, d)),
                       "pooler.bias": zeros((d,))})
        params = trainable(params)
        if self.line is None:
            return params
        return sharding_lib.cut_blocks(params, self.partition_rules(),
                                       self.line)

    # -- encoder ----------------------------------------------------------
    def _encoder_layer(self, p: Mapping[str, torch.Tensor], x, mask,
                       generator, train, attention_fn):
        """One post-LN layer over its tensors ``p`` (names relative to
        ``encoder.<i>.``)."""
        c = self.config
        attn = attention_core(
            attention_params(p, "attention"), x, mask=mask,
            dropout_rate=c.dropout_rate, generator=generator, train=train,
            attention_fn=attention_fn, mesh=self.line)
        x = layer_norm(p, "attention.ln",
                       x + dropout(attn, c.dropout_rate, generator, train),
                       c.layer_norm_eps)
        y = ffn(p, "ffn", x, c.act_fn, self.line)
        return layer_norm(p, "ffn.ln",
                          x + dropout(y, c.dropout_rate, generator, train),
                          c.layer_norm_eps)

    def apply(self, params: Mapping[str, torch.Tensor],
              input_ids: torch.Tensor, *,
              token_type_ids: Optional[torch.Tensor] = None,
              attention_mask: Optional[torch.Tensor] = None,
              train: bool = False,
              rng: Optional[torch.Generator] = None) -> torch.Tensor:
        """input_ids [b, s] -> sequence output [b, s, hidden] in the
        config's dtype.  ``attention_mask`` [b, s] (1 = real token) masks
        the keys; ``rng``, a ``torch.Generator`` on the parameters'
        device, is required with ``train``.  Under ``seq_axis`` each rank
        of the axis computes its shard and the global output is gathered
        (``s`` must divide by the axis size)."""
        out, _ = self._encode(params, input_ids, token_type_ids,
                              attention_mask, train, rng)
        if self.config.seq_axis is not None:
            out = ring_lib.gather_seq(out, self.mesh, self.config.seq_axis)
        return out

    def _encode(self, params, input_ids, token_type_ids, attention_mask,
                train, rng):
        """(this rank's sequence output, its slice of the positions): the
        whole sequence without ``seq_axis``."""
        c = self.config
        if train and rng is None:
            raise ValueError("Bert.apply(train=True) requires a generator "
                             "(rng) for dropout; make_custom_train_step "
                             "passes one")
        dev = params["embeddings.word"].device
        ids = input_ids.to(dev).long()
        part = ring_lib.seq_part(ids.shape[1], self.mesh, c.seq_axis)
        ids = ids[:, part]
        x = tp_lib.vocab_parallel_embed(ids, params["embeddings.word"],
                                        self.line)
        x = x + params["embeddings.position"][part][None]
        if token_type_ids is not None:
            x = x + F.embedding(token_type_ids.to(dev).long()[:, part],
                                params["embeddings.type"])
        else:
            x = x + params["embeddings.type"][0][None, None]
        x = layer_norm(params, "embeddings.ln", x, c.layer_norm_eps)
        x = dropout(x, c.dropout_rate, rng, train).to(c.dtype)
        valid = (None if attention_mask is None
                 else attention_mask.to(dev)[:, part])
        mask = None if valid is None else padding_mask(valid)
        if c.seq_axis is None:
            attention_fn = flash_lib.make_flash_attention_fn(causal=False)
        else:
            group = self.mesh.axis_group(c.seq_axis)

            def attention_fn(q, k, v, mask=None):
                return ring_flash_lib.ring_flash_attention(
                    q, k, v, group, kv_valid=valid)
        for i in range(c.num_layers):
            pre = f"encoder.{i}."
            names = [n for n in params if n.startswith(pre)]

            def layer(x, *tensors, rel=[n[len(pre):] for n in names]):
                return self._encoder_layer(dict(zip(rel, tensors)), x, mask,
                                           rng, train, attention_fn)
            tensors = [params[n] for n in names]
            if c.remat:
                x = _checkpointed(layer, rng, _REMAT_SAVES[c.remat_policy],
                                  x, *tensors)
            else:
                x = layer(x, *tensors)
        return x, part

    # -- heads ------------------------------------------------------------
    def _column(self, params: Mapping[str, torch.Tensor], prefix: str,
                x: torch.Tensor, activation: Callable) -> torch.Tensor:
        """``activation(x @ kernel + bias)``; under tensor parallelism
        column-parallel: this rank's ``[d, d/T]`` kernel with its slice of
        the replicated bias (whose gradient the line sums with x's), the
        outputs gathered whole over the line."""
        if self.line is None:
            return activation(_dense(params, prefix, x))
        kernel = params[prefix + ".kernel"]
        n = kernel.shape[1]
        x, bias = tp_lib.copy_to_line(x, self.line, params[prefix + ".bias"])
        at = tp_lib.index(self.line) * n
        y = activation(x @ kernel.to(x.dtype)
                       + bias[at:at + n].to(x.dtype))
        return tp_lib.gather_from_line(y, self.line)

    def _mlm_local_logits(self, params: Mapping[str, torch.Tensor],
                          sequence_output: torch.Tensor) -> torch.Tensor:
        """The MLM head's f32 logits of this rank's vocabulary rows (all
        of them at T = 1)."""
        c = self.config
        h = self._column(params, "mlm.transform", sequence_output, c.act_fn)
        h = layer_norm(params, "mlm.ln", h, c.layer_norm_eps)
        h = tp_lib.copy_to_line(h, self.line)
        logits = h @ params["embeddings.word"].T.to(h.dtype)
        return logits.float() + params["mlm.output_bias"]

    def mlm_logits(self, params: Mapping[str, torch.Tensor],
                   sequence_output: torch.Tensor) -> torch.Tensor:
        """Tied-embedding MLM head -> [..., vocab] f32 logits (gathered
        whole over a tensor line)."""
        return tp_lib.gather_from_line(
            self._mlm_local_logits(params, sequence_output), self.line)

    def pooled(self, params: Mapping[str, torch.Tensor],
               sequence_output: torch.Tensor) -> torch.Tensor:
        """[CLS] pooler -> [batch, hidden] (the classifier's input)."""
        return self._column(params, "pooler", sequence_output[:, 0],
                            torch.tanh)

    # -- losses -----------------------------------------------------------
    def mlm_loss_fn(self) -> Callable:
        """``loss_fn(params, model_state, batch, generator, train)``, the
        contract of ``train.make_custom_train_step``.  ``batch``:
        ``input_ids``, ``labels``, ``mlm_mask`` (1 at the positions the
        loss reads) and optional ``attention_mask`` / ``token_type_ids``,
        all [b, s].  Metrics: ``mlm_accuracy``, ``loss_weight`` (the
        masked mean's weight, for gradient accumulation) and, when
        gathering, ``mlm_overflow`` (masked positions the gather
        dropped).  Under ``seq_axis`` each rank scores the masked
        positions of its shard (the gather picks the global first ``n``
        and each rank keeps those in its shard), the sums are summed
        over the axis (module docstring), and ``loss_weight`` is this
        rank's share of the weight (``parallel.ring.weight_share``)."""
        def loss_fn(params, model_state, batch, generator, train):
            dev = params["embeddings.word"].device
            seq, part = self._encode(params, batch["input_ids"],
                                     batch.get("token_type_ids"),
                                     batch.get("attention_mask"), train,
                                     generator)
            mask = batch["mlm_mask"].to(dev).float()
            labels = batch["labels"].to(dev).long()
            n_pred = self.config.mlm_predictions_per_seq
            extra = {}
            if n_pred:
                w, idx = gather_masked(mask, n_pred)
                extra["mlm_overflow"] = mask.sum() - w.sum()
                labels = torch.gather(labels, 1, idx)
                mask = w
                # the gathered positions this rank holds (all of them
                # without seq_axis) weigh in, the others are 0
                mine = (idx >= part.start) & (idx < part.stop)
                idx = torch.clamp(idx - part.start, 0, seq.shape[1] - 1)
                seq = torch.gather(seq, 1, idx[..., None].expand(
                    -1, -1, seq.shape[-1]))
                w = w * mine
            else:
                labels, w = labels[:, part], mask[:, part]
            # the masked mean's sums over this rank's positions, summed
            # over seq_axis, over the global weight; the logits stay cut
            # over a tensor line
            logits = self._mlm_local_logits(params, seq)
            nll = tp_lib.vocab_parallel_cross_entropy(
                logits.reshape(-1, logits.shape[-1]), labels.reshape(-1),
                self.line).reshape(labels.shape)
            hits = (tp_lib.vocab_parallel_argmax(logits.detach(), self.line)
                    == labels).float()
            sums = torch.stack([(nll * w).sum(), (hits * w).sum()])
            if self.config.seq_axis is not None:
                sums = ring_lib.sum_seq(sums, self.mesh,
                                        self.config.seq_axis)
            weight = mask.sum()
            return sums[0] / torch.clamp(weight, min=1e-9), (
                {"mlm_accuracy": sums[1].detach() / torch.clamp(weight,
                                                                min=1.0),
                 "loss_weight": ring_lib.weight_share(
                     weight, self.mesh, self.config.seq_axis),
                 **extra}, model_state)
        return loss_fn

    # -- sharding ---------------------------------------------------------
    def partition_rules(self, fsdp: bool = False
                        ) -> sharding_lib.PartitionRules:
        """The JAX package's Megatron table (``Bert.partition_rules``)
        over the port's per-layer names (a layer leaf's spec without the
        JAX tree's leading layer dim): heads and the FFN's hidden dim on
        ``tensor``, the word embedding's vocabulary too; the MLM
        transform and the pooler column-parallel, ``mlm.output_bias``
        with the vocabulary; ``fsdp=True`` cuts each matrix's other large
        dim over ``fsdp``.  No match replicates."""
        f = "fsdp" if fsdp else None
        layer = r"^encoder\.\d+\."
        return sharding_lib.PartitionRules([
            (r"^embeddings\.word$", ("tensor", f)),
            (r"^embeddings\.(position|type)$", (None, None)),
            (layer + r"attention\.(query|key|value)\.kernel$",
             (f, "tensor", None)),
            (layer + r"attention\.(query|key|value)\.bias$",
             ("tensor", None)),
            (layer + r"attention\.out\.kernel$", ("tensor", None, f)),
            (layer + r"ffn\.w_in\.kernel$", (f, "tensor")),
            (layer + r"ffn\.w_in\.bias$", ("tensor",)),
            (layer + r"ffn\.w_out\.kernel$", ("tensor", f)),
            (r"^mlm\.transform\.kernel$", (f, "tensor")),
            (r"^pooler\.kernel$", (f, "tensor")),
            (r"^mlm\.output_bias$", ("tensor",)),
        ])
