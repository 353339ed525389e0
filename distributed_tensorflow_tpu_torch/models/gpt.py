"""GPT decoder for serving, decoding and causal-LM training, in PyTorch.

Counterpart of ``distributed_tensorflow_tpu/models/gpt.py``, the subset
the port's paths run: pre-LN decoder blocks in two recipes, chosen by
the config as in the JAX package.  GPT-2: learned positions, LayerNorm,
the tanh-gelu FFN, biases and a head tied to the word embedding.  Llama
(``models/llama.py``): RoPE, RMSNorm, the SwiGLU FFN, no biases, a
separate ``lm_head`` and grouped-query attention.  With ``moe_experts``
every block's FFN is a top-k mixture of experts (``ops/moe.py``), shared
by the training and KV-cache paths; its router losses join the training
loss.  Either recipe may keep its
KV cache in int8 (``kv_cache_dtype="int8"``): each written key and value
vector is quantized with its own f32 scale (``ops/quant.py``) into the
cache's ``k_scale``/``v_scale`` planes.

Three ways to hold the KV cache, all under ``torch.no_grad()``:

* the page pool (``serve/pages.py``): ``decode_window_paged`` (chunked
  prefill) and ``decode_step_slots_paged`` (one token per slot), read
  through the paged-attention kernel, which dequantizes at the operand;
* the contiguous cache of one decode stream (``init_cache``: ``[L, b,
  max_len, kv_heads, head_dim]`` leaves and a host-int ``pos``):
  ``decode_block`` (the prompt prefill), ``decode_window``,
  ``decode_step``, ``prefill_cache``, and on top of them ``generate``
  and ``beam_search`` (``models/speculative.py`` drives two of them);
* the contiguous slot cache (``serve/slots.py``): ``decode_step_slots``,
  one token per slot at per-row columns.

Training drives ``apply`` (the full-sequence forward, causal flash
attention) through ``lm_loss_fn`` (next-token cross-entropy).  Both read
every parameter from the dict the step passes (the model's own tensors,
or casts of them under a precision policy), so the gradients land on
whatever that dict holds.  ``GPTConfig.remat`` runs each block under
``torch.utils.checkpoint`` (``_checkpointed``: selective for the "dots"
policies, with the dropout generator's state replayed for the
recomputation), and ``loss_seq_chunk`` computes the loss a chunk of
tokens at a time (``_lm_stats``), each chunk recomputed in the backward.

Parameters keep the JAX package's layouts (projection kernels ``[d, h,
hd]`` and ``[h, hd, d]``) and stay float32; each product casts them to
the compute dtype, as the JAX code's ``.astype(dtype)`` does.
``models/convert.py`` loads a JAX parameter tree.

Kernels: every block norm and ``ln_f`` go through
``ops.kernels.fused.fused_layernorm`` or ``fused_rmsnorm``, every paged
read through ``ops.kernels.paged_attention``, and the training forward's
attention and the unpadded prompt prefill (``decode_block`` without
``kv_valid``) through ``ops.kernels.flash_attention``.  Those wrappers
launch the CUDA kernel for CUDA tensors and run their plain version only
for CPU tensors: the tensor's device decides, there is no knob.  The JAX
package's gates (``use_flash="auto"``, ``fused_layernorm=False``) are not
ported: on the card the kernels are always the path.  The contiguous
cache's reads (``decode_step``, ``decode_window``, the ragged
``decode_block``, ``decode_step_slots``) are dense attention in plain
torch (``ops/attention.py``), as the JAX package computes them outside
any Pallas kernel; they read only the cache's first ``pos + s`` columns,
which the JAX package masks instead.

Tensor parallelism (``GPT(config, mesh=...)`` with a ``tensor`` axis of
T > 1 ranks): the constructor draws the whole model from the generator,
as at T = 1, then keeps this rank's blocks under ``partition_rules``
(marked, ``parallel.sharding.mark_block``), so the model is the same one
at every T and no rank holds a whole cut leaf.  ``apply``,
``lm_loss_fn`` and the contiguous cache's paths compute on the blocks
with the collectives of ``parallel/tensor_parallel.py``: the vocabulary-
parallel embedding, Megatron's attention (a rank's query heads, its kv
heads, the row-parallel output) and FFN (``ops/attention.py``), and a
head whose logits stay cut over the vocabulary into the vocabulary-
parallel cross entropy and argmax; ``logits()`` gathers them whole.
Keys and values shard with the queries under plain MHA or ``shard_kv``;
otherwise they replicate and each rank's query heads read their group's
kv heads (``tensor_parallel.kv_heads``).  The cache holds the rank's kv
heads.  The paged paths, LoRA adapters and the int8 cache raise under
T > 1 (ROADMAP Queue 1 item 7.2b; the paged engine takes no mesh in the
JAX package either).

Tensor beside sequence parallelism (``seq_axis`` on a mesh with a
``tensor`` axis too, ``{"seq": S, "tensor": T}`` or with ``data``): a
rank computes its blocks on its shard of the sequence.  The embedding is
vocabulary-parallel on the shard's ids, RoPE (or the learned positions)
at the shard's global offset; a block's attention is ring-flash over the
rank's seq line on its ``h/T`` query heads and the kv heads they read;
``lm_loss_fn`` takes the vocabulary-parallel cross entropy of the
shard's tokens, sums it over the seq line and reports its share of the
weight; ``apply`` gathers the hidden over the seq line and ``logits()``
over the tensor line, as the JAX package's partial-manual ring leaves
its heads to the partitioner.

Expert parallelism (a MoE config, ``GPT(config, mesh=...)`` with an
``expert`` axis of X > 1 ranks, beside ``data`` or ``tensor``): the
constructor keeps this rank's ``E/X`` experts of every block's bank
(and, on a tensor line, their hidden dim's block) under
``partition_rules``, whose MoE rows are ``ops.moe.moe_partition_rules``;
every FFN passes the mesh to ``apply_moe``, which routes whole on every
rank and sums the ranks' experts over the line (``ops/moe.py``), so
``moe_aux``, ``moe_dropped`` and the loss come out equal on every rank
of the line.  In a train step over a mesh with a batch line of more than
one rank, the training forward reads that line once as it starts
(``parallel.data_parallel.batch_group``) and passes it to every MoE
layer, whose ``aux_loss`` then takes the global batch's router
statistics, in a block that ``remat`` recomputes in the backward too.

Pipeline parallelism (``pipeline_stages`` S > 1, ``GPT(config, mesh=)``
with a ``pipe`` axis of S ranks): the constructor draws the whole model,
as at S = 1, then keeps this rank's stage, layers ``[s L/S, (s+1) L/S)``
under their global names ``blocks.<i>`` (each marked with its
``parallel.sharding.Stage``), beside the replicated embeddings, ``ln_f``
and head.  ``apply`` and ``lm_loss_fn`` send the decoder through
``parallel.pipeline.pipeline_apply`` (GPipe over
``pipeline_microbatches`` microbatches, S when 0), so every rank of the
line holds the hidden states and the loss; ``lm_1f1b_value_and_grad``
is the hand-scheduled 1F1B pass.  Dropout in the stages draws from a
generator derived from the step's after the embedding's draws and the
stage index, so the embedding's masks are the same on every rank of
the line and GPipe and 1F1B draw the same masks.  The KV-cache paths
raise on a stage model: decode on a whole model built from
``train.gather_params`` (the JAX package decodes from its global
arrays).  MoE and ``seq_axis`` raise beside a pipeline, as in the JAX
package.

Numerics: TF32 stays off.  This module never sets
``torch.backends.cuda.matmul.allow_tf32`` or
``torch.backends.cudnn.allow_tf32``, so a float32 model computes in full
float32 on the card.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import warnings
from typing import Any, Callable, Dict, Mapping, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import decoding as dec
from ..ops import quant
from ..ops.moe import apply_moe, init_moe, moe_partition_rules
from ..ops.attention import (NEG_INF, _row_parallel, apply_rope,
                             attention_core, causal_mask,
                             dot_product_attention, dropout, ffn_core,
                             ffn_swiglu_core, padding_mask, project,
                             rope_tables)
from ..ops.kernels import flash_attention as flash_lib
from ..ops.kernels import fused as fused_lib
from ..ops.kernels import paged_attention as paged_lib
from ..parallel import data_parallel as dp_lib
from ..parallel import pipeline as pipeline_lib
from ..parallel import ring as ring_lib
from ..parallel import sharding as sharding_lib
from ..parallel import ring_flash as ring_flash_lib
from ..parallel import tensor_parallel as tp_lib

__all__ = ["GPT", "GPTConfig", "gpt_partition_rules", "gpt_small",
           "gpt_tiny", "resolve_device"]


def _row_write(layer: torch.Tensor, cols: torch.Tensor,
               val: torch.Tensor) -> None:
    """``layer[r, cols[r]] = val[r, 0]`` in place for every row r (``val``
    holds one column), dropping a column past ``layer.shape[1]``: it is
    aimed at the row's last column and writes back the value already
    there, so no index leaves the layer (``index_put_`` would raise on
    the CPU and assert on the card) and no live entry changes.  One
    gather and one scatter, no host sync."""
    b, max_len = layer.shape[:2]
    rows = torch.arange(b, device=layer.device)
    at = torch.clamp(cols.long(), max=max_len - 1)
    keep = (cols < max_len).view((b,) + (1,) * (val.dim() - 2))
    layer.index_put_((rows, at), torch.where(keep, val[:, 0],
                                             layer[rows, at]))


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """``device`` as a ``torch.device``; raises for a CUDA device when
    there is no card (the port never falls back to the CPU by itself)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card unless the caller "
            "passes device='cpu'")
    return device


# what each remat policy saves (the aten products whose outputs the
# recomputation reads back instead of recomputing; None: nothing)
_REMAT_SAVES = {
    "full": None,
    "dots": ("mm", "addmm", "bmm"),
    "dots_no_batch": ("mm", "addmm"),
}


def _checkpointed(fn: Callable, generator: Optional[torch.Generator],
                  saves, *args):
    """``fn(*args)`` under ``torch.utils.checkpoint`` (non-reentrant):
    its activations are dropped after the forward and recomputed in the
    backward, except the outputs of the aten products named in ``saves``
    (selective checkpointing).

    The recomputation must draw the dropout masks the forward drew, and
    ``torch.utils.checkpoint`` replays only the global RNG, never an
    explicit generator's: so the generator's state is taken before the
    forward and set again for the recomputation (and put back after it).
    The port's kernels launch through ctypes, unseen by the dispatcher,
    so every policy runs them again, as ``dots_saveable`` recomputes a
    ``pallas_call`` in the JAX package."""
    from torch.utils import checkpoint as ckpt
    state = None if generator is None else generator.get_state()
    calls = [0]

    def run(*a):
        calls[0] += 1
        if state is None or calls[0] == 1:
            return fn(*a)
        now = generator.get_state()
        generator.set_state(state)
        try:
            return fn(*a)
        finally:
            generator.set_state(now)

    kw = {}
    if saves:
        ops = tuple(getattr(torch.ops.aten, name).default for name in saves)

        def policy_fn(ctx, op, *args, **kwargs):
            return (ckpt.CheckpointPolicy.MUST_SAVE if op in ops
                    else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)
        kw["context_fn"] = lambda: ckpt.create_selective_checkpoint_contexts(
            policy_fn)
    return ckpt.checkpoint(run, *args, use_reentrant=False,
                           preserve_rng_state=False, **kw)


def _chunk_stats(hidden: torch.Tensor, head: torch.Tensor,
                 targets: torch.Tensor, mask: Optional[torch.Tensor],
                 mesh=None):
    """(nll sum, hit sum) of one chunk of tokens: ``hidden`` [t, d]
    against the head [vocab, d], f32 logits and log-softmax; hits (argmax
    equal to the target) outside autograd; both weighted by ``mask``.
    ``mesh`` with a ``tensor`` axis: ``head`` is this rank's rows of the
    vocabulary and the logits stay cut (the vocabulary-parallel cross
    entropy and argmax)."""
    hidden = tp_lib.copy_to_line(hidden, tp_lib.active(mesh))
    logits = (hidden @ head.T.to(hidden.dtype)).float()
    nll = tp_lib.vocab_parallel_cross_entropy(logits, targets, mesh)
    hits = (tp_lib.vocab_parallel_argmax(logits.detach(), mesh)
            == targets).float()
    if mask is not None:
        nll, hits = nll * mask, hits * mask
    return nll.sum(), hits.sum()


@dataclasses.dataclass
class GPTConfig:
    vocab_size: int = 50257
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position: int = 1024
    # training only (serving never drops); masks come from the step's
    # torch.Generator, so their bits differ from the JAX package's
    dropout_rate: float = 0.1
    layer_norm_eps: float = 1e-5
    dtype: torch.dtype = torch.float32
    # grouped-query attention: kv heads (None = num_heads, plain MHA)
    num_kv_heads: Optional[int] = None
    # the Llama switches (models/llama.py sets them together):
    # "learned" absolute positions or "rope" rotary embeddings
    position_embedding: str = "learned"
    rope_base: float = 10000.0
    # "layernorm" (GPT-2) or "rmsnorm" (gamma only, no centering)
    norm: str = "layernorm"
    # "gelu" (w_in -> gelu -> w_out) or "swiglu" (w_out(silu(w_gate(x))
    # * w_in(x)))
    ffn_activation: str = "gelu"
    # False: no bias parameters in the attention and FFN projections
    use_bias: bool = True
    # False: a separate lm_head [vocab, d] instead of the word embedding
    tied_head: bool = True
    # KV-cache storage: None = the compute dtype; "int8" = int8 values
    # with one f32 scale per (token, kv head)
    kv_cache_dtype: Optional[str] = None
    # training: recompute each decoder block in the backward
    # (torch.utils.checkpoint); ``remat_policy`` says what the block SAVES:
    # "full" (nothing), "dots" (every matrix product's output: aten mm,
    # addmm and bmm), "dots_no_batch" (the weight products: mm and addmm)
    remat: bool = False
    remat_policy: str = "full"
    # training: > 0 computes the LM loss this many tokens at a time, each
    # chunk's head projection and log-softmax recomputed in the backward,
    # so the [tokens, vocab] f32 logits never exist whole; 0 = off
    loss_seq_chunk: int = 0
    # sparse (MoE) FFN: 0 = dense.  With experts > 0 every block's FFN is
    # a grouped top-k MoE bank (ops/moe.py); the router aux losses, so
    # weighted, are added to the loss by lm_loss_fn
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 1e-2
    moe_z_weight: float = 1e-3
    # training: the mesh axis of sequence (context) parallelism; apply and
    # lm_loss_fn run this rank's shard of the sequence through ring-flash
    # attention over that axis (GPT(config, mesh=...)).  None: off
    seq_axis: Optional[str] = None
    # pipeline parallelism (parallel/pipeline.py): the L decoder blocks as
    # ``pipeline_stages`` same-shape stages of L/S blocks over the
    # ``pipe_axis`` mesh axis (GPT(config, mesh=...)); the embeddings and
    # the head run on every rank of the line.  0 or 1 is off
    pipeline_stages: int = 0
    pipe_axis: str = "pipe"
    # microbatches a step; 0 -> pipeline_stages
    pipeline_microbatches: int = 0

    def __post_init__(self):
        if self.pipeline_stages > 1:
            if self.num_layers % self.pipeline_stages:
                raise ValueError(
                    f"num_layers {self.num_layers} not divisible by "
                    f"pipeline_stages {self.pipeline_stages}")
            if self.moe_experts > 0:
                raise ValueError(
                    "pipeline_stages with MoE is unsupported: the router "
                    "aux-loss scalar cannot cross the same-shape pipeline "
                    "stage contract (parallel/pipeline.py)")
            if self.seq_axis is not None:
                raise ValueError(
                    "pipeline_stages with seq_axis (ring attention) is "
                    "unsupported: the JAX package's ring cannot nest inside "
                    "its pipe-manual region (ROADMAP Queue 1 item 7.3c)")
        if self.remat_policy not in _REMAT_SAVES:
            raise ValueError(f"remat_policy must be 'full', 'dots', or "
                             f"'dots_no_batch'; got {self.remat_policy!r}")
        if self.loss_seq_chunk < 0:
            raise ValueError(f"loss_seq_chunk must be >= 0; "
                             f"got {self.loss_seq_chunk}")
        if self.kv_cache_dtype not in (None, "int8"):
            raise ValueError(f"kv_cache_dtype must be None or 'int8'; "
                             f"got {self.kv_cache_dtype!r}")
        if self.norm not in ("layernorm", "rmsnorm"):
            raise ValueError(f"norm must be 'layernorm' or 'rmsnorm'; "
                             f"got {self.norm!r}")
        if self.ffn_activation not in ("gelu", "swiglu"):
            raise ValueError(f"ffn_activation must be 'gelu' or 'swiglu'; "
                             f"got {self.ffn_activation!r}")
        if self.ffn_activation == "swiglu" and self.moe_experts > 0:
            raise ValueError("moe_experts with ffn_activation='swiglu' is "
                             "unsupported: ops.moe's expert bank is the "
                             "two-matrix gelu FFN")
        if self.position_embedding not in ("learned", "rope"):
            raise ValueError("position_embedding must be 'learned' or "
                             f"'rope'; got {self.position_embedding!r}")
        if self.hidden_size % self.num_heads:
            raise ValueError(f"hidden_size {self.hidden_size} not divisible "
                             f"by num_heads {self.num_heads}")
        if self.kv_heads < 1 or self.num_heads % self.kv_heads:
            raise ValueError(f"num_kv_heads must be a positive divisor of "
                             f"num_heads {self.num_heads}; got "
                             f"{self.num_kv_heads}")
        if self.seq_axis is not None and self.moe_experts > 0:
            # a MoE group is a whole row (ops/moe.py): routing a shard
            # alone would change which tokens overflow the capacity
            raise NotImplementedError(
                "moe_experts with seq_axis is not ported (ROADMAP Queue 1 "
                "item 7.4): the MoE routes each sequence as one group, and "
                "a sequence shard alone would drop other tokens")

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def kv_heads(self) -> int:
        return (self.num_heads if self.num_kv_heads is None
                else self.num_kv_heads)


def gpt_small(**kw) -> GPTConfig:
    """GPT-2 small: vocab 50257, d 768, 12 layers, 12 heads, FFN 3072."""
    return GPTConfig(**kw)


def gpt_tiny(**kw) -> GPTConfig:
    """The JAX package's ``gpt_tiny`` sizes: 2 layers, d 128, 2 heads."""
    for k, v in dict(hidden_size=128, num_layers=2, num_heads=2,
                     intermediate_size=512, vocab_size=512,
                     max_position=128).items():
        kw.setdefault(k, v)
    return GPTConfig(**kw)


class _Norm(nn.Module):
    """gamma, and beta under LayerNorm (RMSNorm has none)."""

    def __init__(self, c: GPTConfig, device):
        super().__init__()
        d = c.hidden_size
        self.gamma = nn.Parameter(torch.ones(d, device=device))
        if c.norm == "layernorm":
            self.beta = nn.Parameter(torch.zeros(d, device=device))
        else:
            self.register_parameter("beta", None)


class _Dense(nn.Module):
    """kernel, and a zero-initialised bias unless ``use_bias=False``."""

    def __init__(self, kernel_shape, bias_shape, c: GPTConfig, device):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(kernel_shape, device=device))
        if c.use_bias:
            self.bias = nn.Parameter(torch.zeros(bias_shape, device=device))
        else:
            self.register_parameter("bias", None)


class _Attention(nn.Module):
    def __init__(self, c: GPTConfig, device):
        super().__init__()
        d, h, kvh, hd = c.hidden_size, c.num_heads, c.kv_heads, c.head_dim
        self.query = _Dense((d, h, hd), (h, hd), c, device)
        self.key = _Dense((d, kvh, hd), (kvh, hd), c, device)
        self.value = _Dense((d, kvh, hd), (kvh, hd), c, device)
        self.out = _Dense((h, hd, d), (d,), c, device)


class _FFN(nn.Module):
    def __init__(self, c: GPTConfig, device):
        super().__init__()
        d, i = c.hidden_size, c.intermediate_size
        self.w_in = _Dense((d, i), (i,), c, device)
        self.w_out = _Dense((i, d), (d,), c, device)
        if c.ffn_activation == "swiglu":
            self.w_gate = _Dense((d, i), (i,), c, device)


class _Leaves(nn.Module):
    """Parameters under the names of a dict of tensors."""

    def __init__(self, leaves: Mapping[str, torch.Tensor]):
        super().__init__()
        for name, t in leaves.items():
            setattr(self, name, nn.Parameter(t))


class _MoE(nn.Module):
    """``router.kernel`` [D, E] and ``experts.w_in`` [E, D, F], ``b_in``
    [E, F], ``w_out`` [E, F, D], ``b_out`` [E, D] (``ops.moe.init_moe``,
    glorot-uniform kernels from ``generator``)."""

    def __init__(self, c: GPTConfig, device, generator):
        super().__init__()
        tree = init_moe(generator, c.hidden_size, c.intermediate_size,
                        c.moe_experts)
        self.router = _Leaves({k: v.to(device)
                               for k, v in tree["router"].items()})
        self.experts = _Leaves({k: v.to(device)
                                for k, v in tree["experts"].items()})


def _moe_tree(get: Callable) -> Dict[str, Dict[str, torch.Tensor]]:
    """The nested dict ``ops.moe.apply_moe`` reads, from ``get(name)`` of
    each tensor's name under a block's ``moe.``."""
    return {"router": {"kernel": get("router.kernel")},
            "experts": {n: get(f"experts.{n}")
                        for n in ("w_in", "b_in", "w_out", "b_out")}}


class _Block(nn.Module):
    def __init__(self, c: GPTConfig, device):
        super().__init__()
        self.ln_1 = _Norm(c, device)
        self.attention = _Attention(c, device)
        self.ln_2 = _Norm(c, device)
        if not c.moe_experts:
            self.ffn = _FFN(c, device)


class GPT(nn.Module):
    """Decoder stack for paged serving and causal-LM training.

    ``GPT(config, device="cuda", generator=None, mesh=None)``: weights
    are random,
    truncated normal (std 0.02, cut at 2 std) from ``generator`` (seed 0
    when None), biases zero, norms identity, all float32 and trainable.
    The Llama recipe has no ``position``, ``beta`` or ``bias`` parameters,
    a ``w_gate`` in every FFN and, untied, a top-level ``lm_head``.  A
    MoE block holds ``moe.router.kernel`` and ``moe.experts.w_in``,
    ``b_in``, ``w_out``, ``b_out`` (glorot-uniform kernels, as
    ``ops.moe.init_moe``) in place of ``ffn``.
    Raises for ``cuda`` when there is no card; tests pass
    ``device="cpu"``.  Parameter names (``named_parameters``) are the JAX
    tree's paths with the decoder unstacked: ``blocks.<i>.<path>`` is
    layer i of the JAX leaf ``decoder.<path>`` (``models/convert.py``).
    ``mesh`` (a ``parallel.Mesh``): naming ``config.seq_axis``, every
    rank of the axis builds the same weights and ``apply`` /
    ``lm_loss_fn`` compute its shard of the sequence; with a ``tensor``
    axis of more than one rank (beside ``seq_axis`` or not), the model
    keeps this rank's blocks and computes tensor-parallel, and a MoE
    config with an ``expert`` axis of more than one rank keeps this
    rank's experts (module docstring).
    ``shard_kv``: the kv
    projections shard over ``tensor`` (True) or replicate (False); None
    shards them under plain MHA only, as ``partition_rules``.
    """

    def __init__(self, config: GPTConfig, *,
                 device: Union[str, torch.device] = "cuda",
                 generator: Optional[torch.Generator] = None, mesh=None,
                 shard_kv: Optional[bool] = None):
        super().__init__()
        device = resolve_device(device)
        c = self.config = config
        if c.seq_axis is not None and (mesh is None
                                       or c.seq_axis not in mesh.shape):
            raise ValueError(f"seq_axis={c.seq_axis!r} needs GPT(config, "
                             f"mesh=...) with that axis; got {mesh}")
        if c.pipeline_stages > 1:
            if mesh is None or mesh.axis_size(c.pipe_axis) \
                    != c.pipeline_stages:
                raise ValueError(
                    f"pipeline_stages={c.pipeline_stages} requires GPT("
                    f"config, mesh=...) with a {c.pipe_axis!r} axis of that "
                    f"many ranks; got {mesh}")
            sharding_lib.check_mesh(mesh)
        self.mesh = mesh
        self.shard_kv = shard_kv
        # the tensor line (None at T = 1) and, with replicated kv
        # projections, the kv heads this rank's queries read
        self._line = tp_lib.active(mesh)
        # the expert line (None at X = 1): the MoE banks' experts cut
        self._experts = tp_lib.active(mesh, "expert")
        self._kv_heads = None
        if self._experts is not None:
            sharding_lib.check_mesh(mesh)
        if self._line is not None:
            sharding_lib.check_mesh(mesh)
            if c.kv_cache_dtype == "int8":
                raise NotImplementedError(
                    f"kv_cache_dtype='int8' under a tensor axis of "
                    f"{tp_lib.size(mesh)}: not ported (ROADMAP Queue 1 "
                    f"item 7.2b)")
        self.word = nn.Parameter(torch.empty(c.vocab_size, c.hidden_size,
                                             device=device))
        if c.position_embedding == "learned":
            self.position = nn.Parameter(torch.empty(
                c.max_position, c.hidden_size, device=device))
        else:
            self.register_parameter("position", None)
        self.blocks = nn.ModuleList(_Block(c, device)
                                    for _ in range(c.num_layers))
        self.ln_f = _Norm(c, device)
        if c.tied_head:
            self.register_parameter("lm_head", None)
        else:
            self.lm_head = nn.Parameter(torch.empty(
                c.vocab_size, c.hidden_size, device=device))
        if generator is None:
            generator = torch.Generator(device).manual_seed(0)
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name in ("word", "position", "lm_head") \
                        or name.endswith(".kernel"):
                    nn.init.trunc_normal_(p, std=0.02, a=-0.04, b=0.04,
                                          generator=generator)
        # a MoE bank is glorot-uniform, as ops.moe.init_moe draws it
        if c.moe_experts:
            for blk in self.blocks:
                blk.moe = _MoE(c, device, generator)
        if self._line is not None or self._experts is not None:
            self._keep_blocks()
        # the global indices of the layers this rank holds
        self._layers = range(c.num_layers)
        if c.pipeline_stages > 1:
            self._keep_stage()

    def _keep_stage(self) -> None:
        """Keep this rank's stage of layers under their global names
        (``blocks`` becomes a ``ModuleDict`` keyed by layer index), each
        parameter marked with its ``Stage``."""
        c = self.config
        per = c.num_layers // c.pipeline_stages
        lo = self.mesh.axis_index(c.pipe_axis) * per
        self._layers = range(lo, lo + per)
        self.blocks = nn.ModuleDict({str(i): self.blocks[i]
                                     for i in self._layers})
        rules = self.partition_rules()
        for name, p in self.named_parameters():
            stage = rules.stage_for(name)
            if stage is not None:
                sharding_lib.mark_block(p, stage)

    def _refuse_stage(self, what: str) -> None:
        if self.config.pipeline_stages > 1:
            raise ValueError(
                f"{what} on a pipeline stage's model (it holds layers "
                f"{self._layers.start}..{self._layers.stop - 1} of "
                f"{self.config.num_layers}): decode on a GPT built without "
                f"pipeline_stages from train.gather_params(state)")

    def _keep_blocks(self) -> None:
        """Replace every parameter the rules cut over ``tensor`` or
        ``expert`` by this rank's block of it (a new parameter, marked
        with its ``Shard`` or ``Blocks``)."""
        blocks = sharding_lib.cut_blocks(dict(self.named_parameters()),
                                         self.partition_rules(), self.mesh)
        for name, t in blocks.items():
            shard = sharding_lib.marked_shard(t)
            if shard is None:
                continue
            owner, _, leaf = name.rpartition(".")
            module = self.get_submodule(owner) if owner else self
            setattr(module, leaf, sharding_lib.mark_block(
                nn.Parameter(t.detach()), shard))
        c = self.config
        if self._line is not None and not self._kv_on_tensor():
            self._kv_heads = tp_lib.kv_heads(c.num_heads, c.kv_heads,
                                             self._line)

    def _kv_on_tensor(self, shard_kv: Optional[bool] = None) -> bool:
        """Whether the kv projections shard over ``tensor``: ``shard_kv``,
        else the constructor's, else plain MHA."""
        c = self.config
        for choice in (shard_kv, self.shard_kv):
            if choice is not None:
                return bool(choice)
        return c.kv_heads == c.num_heads

    @property
    def device(self) -> torch.device:
        return self.word.device

    # -- blocks -----------------------------------------------------------
    def _norm(self, p: _Norm, x: torch.Tensor) -> torch.Tensor:
        return self._norm_of(p.gamma, p.beta, x)

    def _ffn(self, blk: _Block, x: torch.Tensor):
        """The pre-LN FFN of the KV-cache paths: (out, aux), as
        ``_ffn_of``, with the MoE at ``train=False``."""
        if self.config.moe_experts:
            return self._ffn_of(None, _moe_tree(blk.moe.get_parameter),
                                self._norm(blk.ln_2, x))
        f = blk.ffn
        return self._ffn_of(lambda n: (getattr(f, n).kernel,
                                       getattr(f, n).bias), None,
                            self._norm(blk.ln_2, x))

    def _ffn_of(self, dense: Optional[Callable], moe, h: torch.Tensor,
                train: bool = False,
                generator: Optional[torch.Generator] = None,
                batch_group=None):
        """The FFN on normed ``h``, dense or MoE, shared by the training
        and KV-cache paths so their arithmetic cannot differ.  Dense:
        ``dense(name) -> (kernel, bias)`` of ``w_in``, ``w_out`` (and
        ``w_gate``); MoE: ``moe`` the ``ops.moe`` tree, routed with ``h``'s
        leading dim as the group (one row a group: a decode token is
        never dropped, and a window routes its own tokens only; over the
        model's expert and tensor lines, as ``apply_moe(mesh=)``
        computes it; the router statistics over ``batch_group``).
        Returns (out, aux): aux the weighted router loss
        ``moe_aux_weight * aux_loss + moe_z_weight * router_z_loss``
        (f32), 0.0 when dense."""
        c = self.config
        if moe is not None:
            y, m = apply_moe(moe, h, k=c.moe_top_k,
                             capacity_factor=c.moe_capacity_factor,
                             train=train, generator=generator,
                             mesh=self.mesh, batch_group=batch_group)
            return y, (c.moe_aux_weight * m["aux_loss"]
                       + c.moe_z_weight * m["router_z_loss"])
        if c.ffn_activation == "swiglu":
            return ffn_swiglu_core(*dense("w_gate"), *dense("w_in"),
                                   *dense("w_out"), h, mesh=self._line), 0.0
        return ffn_core(*dense("w_in"), *dense("w_out"), h,
                        mesh=self._line), 0.0

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """LM head (the word embedding, or ``lm_head`` when untied) ->
        [..., vocab] f32 logits; under tensor parallelism each rank's
        vocabulary rows, gathered whole over the line."""
        head = self.word if self.lm_head is None else self.lm_head
        if self._line is None:
            return (hidden @ head.T.to(hidden.dtype)).float()
        hidden = tp_lib.copy_to_line(hidden, self._line)
        return tp_lib.gather_from_line(
            (hidden @ head.T.to(hidden.dtype)).float(), self._line)

    def _embed(self, token_ids: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
        if self._line is None:
            x = self.word[token_ids.long()]
        else:
            x = tp_lib.vocab_parallel_embed(token_ids.long(), self.word,
                                            self._line)
        if self.position is not None:
            x = x + self.position[positions.long()]
        return x.to(self.config.dtype)

    def _rope(self, positions: torch.Tensor):
        """(cos, sin) for ``positions`` under RoPE, else None; built once
        per call and shared by every layer."""
        c = self.config
        if c.position_embedding != "rope":
            return None
        return rope_tables(positions, c.head_dim, base=c.rope_base)

    def _cache_layer(self, blk: _Block, x: torch.Tensor,
                     kv: Dict[str, torch.Tensor], i: int,
                     attention: Callable, rope_cs, *,
                     write_pos: Union[int, torch.Tensor, None] = None,
                     paged=None, lora=None) -> torch.Tensor:
        """One decoder layer of every KV-cache path.  In order: RoPE on q
        and k (when ``rope_cs``), the K/V write into layer ``i`` of ``kv``
        (int8 caches: quantized per token and kv head, values and scales
        written together), then ``attention(q, k, v, kv, i)``, so a read
        through the cache sees each token's own column.

        Where the window's [b, s] tokens are written, in place:
        ``paged`` (page ids [N], offsets [N], N = b*s): the pool cells of
        the flattened window (the page pool); else ``write_pos`` an int:
        columns ``write_pos..write_pos+s-1`` of every row (the generate
        and beam path); else a [b] tensor: row r's columns from
        ``write_pos[r]`` on (the slot path), where a column past
        ``max_len`` is dropped, never clamped onto a live entry.  (The
        JAX package donates the cache buffer instead.)

        ``lora``: (adapter table, rows [b]) adds each row's adapter
        deltas (``_lora_deltas``) to the q/k/v projections, before RoPE,
        and to the out projection; None does no adapter work."""
        h = self._norm(blk.ln_1, x)
        a = blk.attention
        deltas = (None if lora is None
                  else self._lora_deltas(lora[0], lora[1], i, h.dtype))
        q = project(a.query.kernel, a.query.bias, h)
        k, v = (project(*self._kv_weights(p.kernel, p.bias), h)
                for p in (a.key, a.value))
        if deltas is not None:
            q, k, v = (y + deltas[name](h) for name, y
                       in (("query", q), ("key", k), ("value", v)))
        if rope_cs is not None:
            q, k = apply_rope(q, *rope_cs), apply_rope(k, *rope_cs)

        def write(name, val):
            buf = kv[name]
            val = val.to(buf.dtype)
            if paged is not None:
                buf[i].index_put_(paged, val.reshape(-1, *val.shape[2:]))
            elif isinstance(write_pos, int):
                buf[i, :, write_pos:write_pos + val.shape[1]] = val
            else:
                _row_write(buf[i], write_pos, val)
        for name, val in (("k", k), ("v", v)):
            if "k_scale" in kv:
                qt = quant.quantize_tensor(val, reduce_axes=(-1,))
                write(name, qt.q)
                write(name + "_scale", qt.scale)
            else:
                write(name, val)
        attn = attention(q, k, v, kv, i)
        nh, hd, d = a.out.kernel.shape
        attn_out = _row_parallel(a.out.kernel.reshape(nh * hd, d),
                                 a.out.bias,
                                 attn.reshape(*attn.shape[:2], nh * hd),
                                 self._line)
        if deltas is not None:
            attn_out = attn_out + deltas["out"](attn)
        x = x + attn_out
        ffn_out, _ = self._ffn(blk, x)         # aux unused at decode
        return x + ffn_out

    def _kv_weights(self, kernel: torch.Tensor,
                    bias: Optional[torch.Tensor]):
        """(kernel, bias) of a key or value projection as this rank
        computes it: its block, or the replicated projection's kv heads
        that this rank's queries read."""
        if self._kv_heads is None:
            return kernel, bias
        return (kernel[:, self._kv_heads],
                None if bias is None else bias[self._kv_heads])

    # -- LoRA adapters ----------------------------------------------------
    # Per-request low-rank adapters for the serving engine: many fine-
    # tuned variants served off one set of base weights.  An adapter adds
    # rank-r deltas to the four attention projections: q/k/v get
    # ``x @ a @ b`` added to the projection before RoPE (both linear, so
    # this equals projecting with the merged kernel ``W + a @ b``,
    # ``merge_lora``), the out projection ``attn @ a @ b``.  Adapters live
    # in a stacked table (``[T, L, ...]`` leaves) indexed by a per-row
    # table-row tensor, so loading and swapping adapters is a row copy.
    # Row 0 is the all-zero adapter: an ``adapter_id=None`` request's
    # delta is an exact zero, so its tokens equal an adapter-free
    # engine's (``serve/adapters.py`` manages the table).

    _LORA_TARGETS = ("query", "key", "value", "out")

    def lora_shapes(self, rank: int) -> Dict[str, Any]:
        """{target: (a_shape, b_shape)} for ONE layer of a rank-``rank``
        adapter (an adapter's leaves prepend [num_layers], the table's
        [capacity, num_layers]); k and v use the kv heads."""
        c = self.config
        h, kv, hd, d = c.num_heads, c.kv_heads, c.head_dim, c.hidden_size
        return {"query": ((d, rank), (rank, h, hd)),
                "key": ((d, rank), (rank, kv, hd)),
                "value": ((d, rank), (rank, kv, hd)),
                "out": ((h, hd, rank), (rank, d))}

    def init_lora(self, generator: Optional[torch.Generator] = None,
                  rank: int = 8, scale: float = 1.0):
        """One adapter on the model's device: {target: {a, b}} with
        ``[L, ...]`` f32 leaves.  Standard LoRA init: ``a`` truncated
        normal (std 0.02, cut at 2 std) from ``generator`` times
        ``scale``, ``b`` zeros, so a fresh adapter changes nothing until
        its ``b`` is trained or loaded."""
        if rank < 1:
            raise ValueError(f"rank must be >= 1; got {rank}")
        L = self.config.num_layers
        adapter = {}
        for name, (a_shape, b_shape) in self.lora_shapes(rank).items():
            a = torch.empty((L,) + a_shape, device=self.device)
            nn.init.trunc_normal_(a, std=0.02, a=-0.04, b=0.04,
                                  generator=generator)
            adapter[name] = {"a": a * scale,
                             "b": torch.zeros((L,) + b_shape,
                                              device=self.device)}
        return adapter

    def init_lora_table(self, capacity: int, rank: int):
        """An all-zero stacked adapter table on the model's device:
        {target: {a, b}} with ``[capacity, L, ...]`` f32 leaves.  Row 0 is
        the reserved zero adapter: never write it."""
        if capacity < 2:
            raise ValueError(f"capacity must be >= 2 (row 0 is the "
                             f"reserved zero adapter); got {capacity}")
        L = self.config.num_layers
        return {name: {"a": torch.zeros((capacity, L) + a_shape,
                                        device=self.device),
                       "b": torch.zeros((capacity, L) + b_shape,
                                        device=self.device)}
                for name, (a_shape, b_shape)
                in self.lora_shapes(rank).items()}

    @staticmethod
    def lora_insert_row(table, row: int, adapter):
        """Copy ``adapter`` into row ``row`` of ``table`` in place;
        returns ``table``."""
        for name, leaves in table.items():
            for ab, buf in leaves.items():
                buf[row].copy_(adapter[name][ab])
        return table

    @torch.no_grad()
    def merge_lora(self, adapter) -> Dict[str, torch.Tensor]:
        """This model's state dict (copies) with ``adapter``'s deltas
        merged into the four attention projection kernels: the model that
        state dict loads into, run adapter-free, is what per-request
        adapter decoding must match."""
        merged = {k: v.detach().clone() for k, v in self.state_dict().items()}
        for name in self._LORA_TARGETS:
            a = adapter[name]["a"].to(self.device, torch.float32)
            b = adapter[name]["b"].to(self.device, torch.float32)
            delta = (torch.einsum("lhkr,lrd->lhkd", a, b) if name == "out"
                     else torch.einsum("ldr,lrhk->ldhk", a, b))
            for i in range(self.config.num_layers):
                merged[f"blocks.{i}.attention.{name}.kernel"] += delta[i]
        return merged

    def _lora_arg(self, adapters, adapter_rows):
        """``_cache_layer``'s ``lora`` argument of a serving entry: the
        table and the rows as int64 indices on the model's device."""
        if adapters is None:
            return None
        self._refuse_tp("LoRA adapters")
        if adapter_rows is None:
            raise ValueError("adapters need adapter_rows")
        return adapters, adapter_rows.to(self.device, torch.long)

    def _lora_deltas(self, adapters, rows: torch.Tensor, i: int,
                     dtype: torch.dtype) -> Dict[str, Callable]:
        """Per-row rank-r deltas of layer ``i``: {target: fn(x) -> delta}.
        ``adapters``: a stacked table; ``rows`` [b] int64: each batch row's
        table row.  The products are batched over rows on ``[b, d, r]``/
        ``[b, r, h * hd]`` gathers of a small table."""
        def gathered(name):
            return (adapters[name]["a"][rows, i].to(dtype),
                    adapters[name]["b"][rows, i].to(dtype))

        def qkv_delta(name):
            a, b = gathered(name)              # [b, d, r], [b, r, h, hd]

            def fn(x):                         # x [b, s, d]
                y = torch.bmm(torch.bmm(x, a), b.flatten(2))
                return y.view(*x.shape[:2], *b.shape[2:])
            return fn

        def out_delta():
            a, b = gathered("out")             # [b, h, hd, r], [b, r, d]

            def fn(attn):                      # attn [b, s, h, hd]
                return torch.bmm(torch.bmm(attn.flatten(2),
                                           a.flatten(1, 2)), b)
            return fn

        return {"query": qkv_delta("query"), "key": qkv_delta("key"),
                "value": qkv_delta("value"), "out": out_delta()}

    # -- full-sequence forward and the LM loss -----------------------------
    def apply(self, input_ids: torch.Tensor, train: bool = False,
              generator: Optional[torch.Generator] = None,
              params: Optional[Mapping[str, torch.Tensor]] = None,
              return_aux: bool = False):
        """input_ids [b, s] -> hidden [b, s, d] in the compute dtype (after
        ``ln_f``); with ``return_aux`` also the router aux loss summed
        over the layers (an f32 scalar, zero for a dense FFN).  Causal
        attention through the flash kernel, RoPE on q and k before it
        under ``position_embedding="rope"``.  With ``train`` and a nonzero
        ``dropout_rate``, dropout (embedding, attention context, both
        residual branches) draws from ``generator``, as does a MoE's
        router jitter under ``train``.  ``params``: the tensors to read
        under the parameters' names (``named_parameters``), for example
        casts of them to a compute dtype; None reads the model's own.
        Under ``remat`` each block runs through ``_checkpointed``, with
        its tensors passed in.  (This replaces ``nn.Module.apply(fn)``,
        which the port never uses, with the JAX package's name.)

        Under ``seq_axis`` every rank of the axis passes the global ids;
        each computes its shard of ``s / R`` tokens through every block
        (positions from its offset, ring-flash attention over the axis)
        and the global hidden is gathered at the end, as the JAX
        package's partial-manual ring returns it.  ``s`` must divide by
        the axis size."""
        ids = input_ids.to(self.device).long()
        off, n = self._seq_shard(ids.shape[1])
        hidden, aux = self._hidden(ids[:, off:off + n], off, train,
                                   generator, params)
        if self.config.seq_axis is not None:
            hidden = ring_lib.gather_seq(hidden, self.mesh,
                                         self.config.seq_axis)
        return (hidden, aux) if return_aux else hidden

    def _seq_shard(self, s: int):
        """(offset, length) of this rank's shard of ``s`` positions: the
        whole sequence without ``seq_axis``."""
        part = ring_lib.seq_part(s, self.mesh, self.config.seq_axis)
        return part.start, part.stop - part.start

    def _attention_fn(self) -> Callable:
        """Causal attention over the block's q, k, v: the flash kernel, or
        under ``seq_axis`` ring-flash over the axis' ring (GQA native in
        both)."""
        c = self.config
        if c.seq_axis is None:
            return flash_lib.make_flash_attention_fn(causal=True)
        group = self.mesh.axis_group(c.seq_axis)

        def fn(q, k, v, mask=None):
            return ring_flash_lib.ring_flash_attention(q, k, v, group,
                                                       causal=True)
        fn.supports_gqa = True
        return fn

    def _hidden(self, ids: torch.Tensor, offset: int, train: bool,
                generator: Optional[torch.Generator],
                params: Optional[Mapping[str, torch.Tensor]]):
        """(hidden [b, n, d] after ``ln_f``, aux) of the ids at positions
        ``offset .. offset + n`` (the rank's shard under ``seq_axis``, else
        the whole sequence); aux a zero f32 scalar for a dense FFN."""
        c = self.config
        P = dict(self.named_parameters()) if params is None else params
        length = ids.shape[1]
        x = tp_lib.vocab_parallel_embed(ids, P["word"], self._line)
        if self.position is not None:
            x = x + P["position"][offset:offset + length][None]
        x = dropout(x, c.dropout_rate, generator, train).to(c.dtype)
        attention_fn = self._attention_fn()
        rope_cs = self._rope(torch.arange(offset, offset + length,
                                          device=self.device))
        qk_transform = None if rope_cs is None else (
            lambda q, k: (apply_rope(q, *rope_cs), apply_rope(k, *rope_cs)))
        if c.pipeline_stages > 1:
            stage_params, stage_fn, gen = self._stage_bits(
                P, attention_fn, qk_transform, generator, train)
            x = pipeline_lib.pipeline_apply(
                stage_fn, stage_params, x, self.mesh, self._microbatches(),
                axis=c.pipe_axis, generator=gen)
            aux_total = None
        else:
            # the train step's batch line, read here and passed down: a
            # block recomputed in the backward (remat) runs outside the
            # step's cross_rank_moments
            x, aux_total = self._run_blocks(
                P, x, [f"blocks.{i}." for i in range(c.num_layers)],
                attention_fn, qk_transform, generator, train,
                dp_lib.batch_group())
        hidden = self._norm_of(P["ln_f.gamma"], P.get("ln_f.beta"), x)
        if aux_total is None:
            aux_total = torch.zeros((), device=self.device)
        return hidden, aux_total

    def _run_blocks(self, P: Mapping[str, torch.Tensor], x: torch.Tensor,
                    prefixes, attention_fn, qk_transform, generator, train,
                    batch_group=None):
        """(x, the MoE aux summed, None for a dense FFN) after the blocks
        whose tensors are ``P``'s entries under each of ``prefixes``, in
        order; each through ``_checkpointed`` under ``remat``.
        ``batch_group``: the batch line the MoE's router statistics sum
        over (``ops.moe.apply_moe``)."""
        c = self.config
        aux_total = None
        for pre in prefixes:
            names = [n for n in P if n.startswith(pre)]

            def block(x, *tensors, rel=[n[len(pre):] for n in names]):
                return self._train_block(dict(zip(rel, tensors)), x,
                                         attention_fn, qk_transform,
                                         generator, train, batch_group)
            tensors = [P[n] for n in names]
            if c.remat:
                x, aux = _checkpointed(block, generator,
                                       _REMAT_SAVES[c.remat_policy], x,
                                       *tensors)
            else:
                x, aux = block(x, *tensors)
            if c.moe_experts:
                aux_total = aux if aux_total is None else aux_total + aux
        return x, aux_total

    def _microbatches(self) -> int:
        c = self.config
        return c.pipeline_microbatches or c.pipeline_stages

    def _stage_bits(self, P: Mapping[str, torch.Tensor], attention_fn,
                    qk_transform, generator, train):
        """(stage params, stage_fn, stage generator) of this rank's stage:
        the params ``{"<j>.<path>": [1, ...]}`` (layer j of the stage, a
        block of the pipeline's stacked params), ``stage_fn(params,
        acts)`` running the stage's blocks, and the generator the stage's
        dropout draws from: seeded from the step generator's state (after
        the embedding's draws, so every call draws anew) and the stage
        index, None without a generator."""
        stage_params = {}
        for j, i in enumerate(self._layers):
            pre = f"blocks.{i}."
            for n in P:
                if n.startswith(pre):
                    stage_params[f"{j}.{n[len(pre):]}"] = P[n][None]
        gen = None
        if generator is not None:
            digest = hashlib.blake2b(
                generator.get_state().numpy().tobytes()
                + self._layers.start.to_bytes(8, "little"),
                digest_size=8).digest()
            gen = torch.Generator(generator.device).manual_seed(
                int.from_bytes(digest, "little") % (2 ** 63))
        prefixes = [f"{j}." for j in range(len(self._layers))]

        def stage_fn(sp, acts):
            return self._run_blocks(sp, acts, prefixes, attention_fn,
                                    qk_transform, gen, train)[0]
        return stage_params, stage_fn, gen

    def _norm_of(self, gamma: torch.Tensor, beta: Optional[torch.Tensor],
                 x: torch.Tensor) -> torch.Tensor:
        """The block norm with these scale and shift tensors, passed to
        the kernel in f32 (under a precision policy they arrive cast)."""
        if self.config.norm == "rmsnorm":
            return fused_lib.fused_rmsnorm(x.contiguous(), gamma.float(),
                                           self.config.layer_norm_eps)
        return fused_lib.fused_layernorm(x.contiguous(), gamma.float(),
                                         beta.float(),
                                         self.config.layer_norm_eps)

    def _train_block(self, bp: Mapping[str, torch.Tensor], x: torch.Tensor,
                     attention_fn: Callable, qk_transform, generator, train,
                     batch_group=None):
        """One decoder block of the training forward over its tensors
        ``bp`` (names relative to ``blocks.<i>.``): (x, the FFN's aux)."""
        c = self.config

        def norm(name, x):
            return self._norm_of(bp[f"{name}.gamma"], bp.get(f"{name}.beta"),
                                 x)
        attn = attention_core(
            {n: {"kernel": bp[f"attention.{n}.kernel"],
                 "bias": bp.get(f"attention.{n}.bias")}
             for n in ("query", "key", "value", "out")},
            norm("ln_1", x), dropout_rate=c.dropout_rate,
            generator=generator, train=train, attention_fn=attention_fn,
            qk_transform=qk_transform, mesh=self._line,
            kv_heads=self._kv_heads)
        x = x + dropout(attn, c.dropout_rate, generator, train)
        moe = None if not c.moe_experts else _moe_tree(
            lambda n: bp["moe." + n])
        y, aux = self._ffn_of(lambda n: (bp[f"ffn.{n}.kernel"],
                                         bp.get(f"ffn.{n}.bias")),
                              moe, norm("ln_2", x), train, generator,
                              batch_group)
        return x + dropout(y, c.dropout_rate, generator, train), aux

    def _lm_stats(self, head: torch.Tensor, hidden: torch.Tensor,
                  targets: torch.Tensor, mask: Optional[torch.Tensor]):
        """(nll sum, hit sum) over every token, ``loss_seq_chunk`` tokens
        at a time: each chunk's projection against the head and its
        log-softmax run under ``_checkpointed``, so only one chunk's
        ``[chunk, vocab]`` f32 logits live at a time, in the forward and
        again in the backward; the head's gradient adds up over the
        chunks.  A chunk above the token count is clamped to it; the last
        chunk may be short (the JAX package pads it: the sums agree to
        f32 round-off)."""
        d = hidden.shape[-1]
        h2, y2 = hidden.reshape(-1, d), targets.reshape(-1)
        m2 = None if mask is None else mask.reshape(-1)
        t = h2.shape[0]
        chunk = min(self.config.loss_seq_chunk, t)
        nll_sum = hit_sum = None
        stats = functools.partial(_chunk_stats, mesh=self._line)
        for lo in range(0, t, chunk):
            part = slice(lo, lo + chunk)
            nll, hits = _checkpointed(
                stats, None, None, h2[part], head, y2[part],
                None if m2 is None else m2[part])
            nll_sum = nll if nll_sum is None else nll_sum + nll
            hit_sum = hits if hit_sum is None else hit_sum + hits
        return nll_sum, hit_sum

    def lm_loss_fn(self) -> Callable:
        """``loss_fn(params, model_state, batch, generator, train) ->
        (loss, (metrics, model_state))``, the contract of
        ``train.make_custom_train_step``.  ``params``: a dict under the
        model's parameter names holding the model's own tensors
        (``dict(model.named_parameters())``) or differentiable casts of
        them to a compute dtype, which the step's precision policy
        passes; anything else (a clone, a rebound tensor) is refused, so
        the gradients land on the parameters that generation and the
        engines read.  ``batch``:
        ``input_ids`` [b, s] and optional ``loss_mask`` [b, s - 1]; the
        targets are the inputs shifted by one.  Metrics:
        ``token_accuracy``, under a mask ``loss_weight`` (its sum), and
        with experts ``moe_aux``: the layers' weighted router losses,
        which the returned loss includes.  One path of sums serves every
        config: the nll and hit sums of the tokens (through ``_lm_stats``,
        a chunk of logits at a time, with ``loss_seq_chunk``) over the
        token count or the mask's sum.

        Under ``seq_axis`` each rank takes the global batch, slices the
        inputs ``ids[:, :-1]``, the targets ``ids[:, 1:]`` and the mask at
        its shard's offset, and never gathers the hidden: its sums are
        summed over the axis (``parallel.ring.sum_seq``), so the loss and
        metrics equal the dense ones on every rank of the axis;
        ``loss_weight`` is this rank's share of the mask's sum
        (``parallel.ring.weight_share``), so the step's all-reduce sums
        the global weight.  ``s - 1`` must divide by the axis size."""
        own = dict(self.named_parameters())

        def is_own(t: torch.Tensor, p: torch.Tensor) -> bool:
            fn = t.grad_fn
            return t is p or (
                type(fn).__name__.startswith("ToCopyBackward")
                and getattr(fn.next_functions[0][0], "variable", None) is p)

        def loss_fn(params: Mapping[str, torch.Tensor], model_state: Any,
                    batch: Mapping[str, torch.Tensor],
                    generator: Optional[torch.Generator], train: bool):
            if params.keys() != own.keys() or not all(
                    is_own(params[k], p) for k, p in own.items()):
                raise ValueError("lm_loss_fn takes the model's own "
                                 "parameters (dict(model.named_parameters()"
                                 ")) or casts of them")
            c = self.config
            ids = batch["input_ids"].to(self.device).long()
            off, n = self._seq_shard(ids.shape[1] - 1)
            hidden, aux = self._hidden(ids[:, off:off + n], off, train,
                                       generator, params)
            head = params["word"] if c.tied_head else params["lm_head"]
            targets = ids[:, 1:]
            mask = batch.get("loss_mask")
            if mask is not None:
                mask = mask.to(self.device).float()
            # sums over this rank's tokens (all of them without
            # seq_axis), summed over the axis, over the global count
            local_t = targets[:, off:off + n]
            local_m = None if mask is None else mask[:, off:off + n]
            if c.loss_seq_chunk:
                nll, hits = self._lm_stats(head, hidden, local_t, local_m)
            else:
                nll, hits = _chunk_stats(
                    hidden.reshape(-1, hidden.shape[-1]), head,
                    local_t.reshape(-1),
                    None if local_m is None else local_m.reshape(-1),
                    self._line)
            if c.seq_axis is not None:
                nll, hits = ring_lib.sum_seq(torch.stack([nll, hits]),
                                             self.mesh, c.seq_axis)
            hits = hits.detach()
            if mask is None:
                loss = nll / targets.numel()
                metrics = {"token_accuracy": hits / targets.numel()}
            else:
                loss = nll / torch.clamp(mask.sum(), min=1e-9)
                metrics = {"token_accuracy": hits / torch.clamp(
                    mask.sum(), min=1.0),
                    "loss_weight": ring_lib.weight_share(
                        mask.sum(), self.mesh, c.seq_axis)}
            if c.moe_experts:
                metrics["moe_aux"] = aux
                loss = loss + aux
            return loss, (metrics, model_state)

        return loss_fn

    def lm_1f1b_value_and_grad(self, params: Mapping[str, torch.Tensor],
                               batch: Mapping[str, torch.Tensor],
                               generator: Optional[torch.Generator] = None,
                               train: bool = True):
        """The causal-LM training pass under the hand-scheduled 1F1B
        pipeline -> ``(loss, grads)``: ``grads`` {name: gradient} of every
        parameter in ``params`` (this rank's, the ``lm_loss_fn`` names),
        what autograd through ``lm_loss_fn`` gives on the GPipe path, with
        at most ``min(M, 2S - 1)`` stashed stage inputs a rank.

        Composition, as the JAX package's: the embedding runs on every
        rank under autograd and takes the pipeline's ``dx`` as its
        cotangent; the stages run ``parallel.pipeline.
        pipeline_value_and_grad``; ``ln_f``, the head and the cross
        entropy are its loss with ``aux_params`` (their gradients come
        back on every rank).  A tied word embedding adds both paths' grads.
        Under a ``loss_mask`` each microbatch's masked mean weighs in by
        its share of the mask's sum, so the loss is the batch's masked
        mean.  ``loss_seq_chunk`` is not applied here (a warning says
        so)."""
        c = self.config
        if c.pipeline_stages <= 1:
            raise ValueError("lm_1f1b_value_and_grad requires "
                             "pipeline_stages > 1")
        if c.loss_seq_chunk:
            warnings.warn(
                "loss_seq_chunk is not applied on the 1F1B path: head_loss "
                "builds full-width logits per microbatch (already 1/N of "
                "the batch).  Use the GPipe path (the normal train step) "
                "for chunked-loss memory savings.", stacklevel=2)
        P = params
        ids = batch["input_ids"].to(self.device).long()
        inputs, targets = ids[:, :-1], ids[:, 1:]
        length = inputs.shape[1]
        mask = batch.get("loss_mask")
        emb_names = ["word"] + (["position"] if self.position is not None
                                else [])
        with torch.enable_grad():
            x = P["word"][inputs]
            if self.position is not None:
                x = x + P["position"][:length][None]
            x = dropout(x, c.dropout_rate, generator, train).to(c.dtype)
        attention_fn = self._attention_fn()
        rope_cs = self._rope(torch.arange(length, device=self.device))
        qk_transform = None if rope_cs is None else (
            lambda q, k: (apply_rope(q, *rope_cs), apply_rope(k, *rope_cs)))
        stage_params, stage_fn, gen = self._stage_bits(
            P, attention_fn, qk_transform, generator, train)
        head_name = "word" if c.tied_head else "lm_head"
        aux = {"gamma": P["ln_f.gamma"], "head": P[head_name]}
        if "ln_f.beta" in P:
            aux["beta"] = P["ln_f.beta"]

        def head_loss(a, out, y_mb):
            h = self._norm_of(a["gamma"], a.get("beta"), out)
            m = y_mb.get("m")
            nll, _ = _chunk_stats(h.reshape(-1, h.shape[-1]), a["head"],
                                  y_mb["t"].reshape(-1),
                                  None if m is None else m.reshape(-1))
            if m is None:
                return nll / y_mb["t"].numel()
            return nll / torch.clamp(m.sum(), min=1e-9)

        n_micro = self._microbatches()
        y = {"t": targets}
        weights = None
        if mask is not None:
            mask = mask.to(self.device).float()
            y["m"] = mask
            per_mb = mask.reshape(n_micro, -1).sum(dim=1)
            weights = per_mb / torch.clamp(per_mb.sum(), min=1e-9)
        loss, stage_grads, aux_grads, dx = \
            pipeline_lib.pipeline_value_and_grad(
                stage_fn, head_loss, stage_params, x.detach(), y, self.mesh,
                n_micro, axis=c.pipe_axis, aux_params=aux, with_dx=True,
                microbatch_weights=weights, generator=gen)
        emb = dict(zip(emb_names, torch.autograd.grad(
            x, [P[n] for n in emb_names], dx)))
        grads = {"ln_f.gamma": aux_grads["gamma"]}
        if "beta" in aux_grads:
            grads["ln_f.beta"] = aux_grads["beta"]
        grads.update(emb)
        if c.tied_head:
            grads["word"] = emb["word"] + aux_grads["head"].to(
                emb["word"].dtype)
        else:
            grads["lm_head"] = aux_grads["head"]
        for j, i in enumerate(self._layers):
            pre = f"{j}."
            for n, g in stage_grads.items():
                if n.startswith(pre):
                    grads[f"blocks.{i}.{n[len(pre):]}"] = g[0]
        return loss, {n: grads[n] for n in P}

    # -- paged decode -----------------------------------------------------
    @torch.no_grad()
    def decode_step_slots_paged(self, kv: Dict[str, torch.Tensor],
                                token_ids: torch.Tensor,
                                page_tab: torch.Tensor,
                                write_col: torch.Tensor,
                                kv_valid: torch.Tensor,
                                positions: torch.Tensor, adapters=None,
                                adapter_rows: Optional[torch.Tensor] = None):
        """One token per slot row against the page pool.

        token_ids/write_col/positions [b] int32; page_tab [b, P] int32;
        kv_valid [b, P * page_size] bool; ``kv`` the pool leaves
        (``serve/pages.py``, int8 scale planes included).  Row r writes its
        token's K/V at
        logical column ``write_col[r]`` (pool cell ``(page_tab[r, col //
        pg], col % pg)``, the page index clamped so a full slot's frozen
        write head cannot run off its table row), attends ``kv_valid[r]``
        OR its own column, and embeds at ``positions[r]``.  Rows whose
        table maps the trash page 0 are retired: their writes land where
        no validity mask looks.  ``adapters``/``adapter_rows`` [b]: row r
        decodes under table row ``adapter_rows[r]``'s LoRA adapter (row 0
        the zero adapter; None: no adapter work).  Returns (logits [b,
        vocab] f32, kv); the pool is updated in place."""
        self._refuse_stage("decode_step_slots_paged")
        self._refuse_tp("the paged KV cache")
        x = self._embed(token_ids, positions)[:, None, :]
        page_size = kv["k"].shape[2]
        P = page_tab.shape[1]
        cols = torch.arange(P * page_size, device=x.device, dtype=torch.int32)
        valid = (kv_valid | (cols[None, :] == write_col[:, None])).contiguous()
        page_idx = torch.clamp(write_col // page_size, max=P - 1)
        w_pages = page_tab.gather(1, page_idx[:, None].long())[:, 0]
        paged = (w_pages.long(), (write_col % page_size).long())
        page_tab = page_tab.to(torch.int32).contiguous()
        rope_cs = self._rope(positions[:, None])

        def attention(q, k, v, kv, i):
            return paged_lib.paged_decode_attention(q.contiguous(), kv, i,
                                                    page_tab, valid)

        lora = self._lora_arg(adapters, adapter_rows)
        for i, blk in enumerate(self.blocks):
            x = self._cache_layer(blk, x, kv, i, attention, rope_cs,
                                  paged=paged, lora=lora)
        return self._head(x), kv

    @torch.no_grad()
    def decode_window_paged(self, kv: Dict[str, torch.Tensor],
                            token_ids: torch.Tensor, page_row: torch.Tensor,
                            pos: int, head: Union[str, int] = "all",
                            adapters=None,
                            adapter_rows: Optional[torch.Tensor] = None):
        """A batch-1 window of ``s`` tokens at positions ``pos..pos+s-1``
        through one request's ``page_row`` [P] int32: K/V are written to
        their pool cells, then row j attends every column ``<= pos + j``
        (shared prefix pages included) through the window kernel.

        ``head``: ``"all"`` -> [1, s, vocab] f32 logits, ``"none"`` ->
        None (intermediate prefill windows only feed the pool), or an int
        j -> [1, vocab] for window row j only (the scheduler's first-token
        shape; the JAX package computes all rows and picks one).  Pad
        columns past the row's view write to the trash page 0.
        ``adapters``/``adapter_rows`` [1]: the request's LoRA adapter, as
        in ``decode_step_slots_paged``.  Returns (logits, kv); the pool
        is updated in place."""
        self._refuse_stage("decode_window_paged")
        self._refuse_tp("the paged KV cache")
        b, s = token_ids.shape
        if b != 1:
            raise ValueError(f"decode_window_paged is batch-1 (one page "
                             f"row = one request); got batch {b}")
        page_size = kv["k"].shape[2]
        P = page_row.shape[0]
        cols = pos + torch.arange(s, device=self.device)
        # pad rows past max_position embed at the last position; they are
        # never valid and their outputs are never read
        x = self._embed(token_ids[0],
                        torch.clamp(cols, max=self.config.max_position - 1))
        x = x[None]
        rope_cs = self._rope(cols)            # unclamped, as in the JAX code
        page_row = page_row.to(torch.int32).contiguous()
        pids = page_row[torch.clamp(cols // page_size, max=P - 1)].long()
        pids = torch.where(cols < P * page_size, pids, 0)
        paged = (pids, cols % page_size)

        def attention(q, k, v, kv, i):
            return paged_lib.paged_window_attention(q.contiguous(), kv, i,
                                                    page_row, pos)

        lora = self._lora_arg(adapters, adapter_rows)
        for i, blk in enumerate(self.blocks):
            x = self._cache_layer(blk, x, kv, i, attention, rope_cs,
                                  paged=paged, lora=lora)
        if head == "none":
            return None, kv
        if head == "all":
            return self.logits(self._norm(self.ln_f, x)), kv
        return self._head(x[:, head:head + 1, :]), kv

    # -- the contiguous KV cache -------------------------------------------
    def init_cache(self, batch_size: int, max_len: Optional[int] = None
                   ) -> Dict[str, Any]:
        """An empty contiguous cache on the model's device: ``k``/``v``
        ``[L, b, max_len, kv_heads, head_dim]`` in the compute dtype, or
        int8 beside f32 ``k_scale``/``v_scale`` ``[..., kv_heads, 1]``
        planes under ``kv_cache_dtype="int8"`` (zero: an unwritten entry
        dequantizes to 0), and ``pos``, the next column to write.  ``pos``
        is a host int (the JAX package keeps a device scalar), so every
        slice and mask of the decode path is built without a sync."""
        self._refuse_stage("init_cache")
        c = self.config
        max_len = max_len or c.max_position
        dev = self.device
        # the kv heads this rank computes (all of them at T = 1)
        kvh = (self.blocks[0].attention.key.kernel.shape[1]
               if self._kv_heads is None
               else self._kv_heads.stop - self._kv_heads.start)
        shape = (c.num_layers, batch_size, max_len, kvh, c.head_dim)
        if c.kv_cache_dtype == "int8":
            sshape = shape[:-1] + (1,)
            return {"k": torch.zeros(shape, dtype=torch.int8, device=dev),
                    "v": torch.zeros(shape, dtype=torch.int8, device=dev),
                    "k_scale": torch.zeros(sshape, device=dev),
                    "v_scale": torch.zeros(sshape, device=dev),
                    "pos": 0}
        return {"k": torch.zeros(shape, dtype=c.dtype, device=dev),
                "v": torch.zeros(shape, dtype=c.dtype, device=dev),
                "pos": 0}

    @staticmethod
    def _cache_kv(cache: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
        """The K/V leaves of a cache dict (everything but ``pos``)."""
        return {k: v for k, v in cache.items() if k != "pos"}

    def _dequant_layer_kv(self, kv: Mapping[str, torch.Tensor], i: int,
                          n: Optional[int] = None):
        """Layer ``i``'s (k, v) ``[b, n, kv_heads, head_dim]`` in the
        compute dtype (the first ``n`` columns, all when None); int8
        entries are dequantized here, at the operand."""
        cols = slice(None) if n is None else slice(0, n)
        k, v = kv["k"][i, :, cols], kv["v"][i, :, cols]
        if "k_scale" not in kv:
            return k, v
        dtype = self.config.dtype
        return (quant.dequantize_tensor(
                    quant.QTensor(k, kv["k_scale"][i, :, cols]), dtype),
                quant.dequantize_tensor(
                    quant.QTensor(v, kv["v_scale"][i, :, cols]), dtype))

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        """ln_f and the LM head of the window's last position: [b, vocab]."""
        return self.logits(self._norm(self.ln_f, x[:, -1:, :]))[:, 0, :]

    @torch.no_grad()
    def decode_step(self, cache: Mapping[str, Any], token_ids: torch.Tensor,
                    kv_valid: Optional[torch.Tensor] = None,
                    positions: Optional[torch.Tensor] = None):
        """One token per row against the contiguous cache.

        ``token_ids`` [b]: the tokens at column ``cache["pos"]``.  Ragged
        rows (``generate(prompt_valid=...)``): ``kv_valid`` [b, max_len]
        also masks cache columns (left pads), and ``positions`` [b] gives
        each row's position index (column minus its pad count) for the
        learned table and RoPE.  Returns (logits [b, vocab] f32, the cache
        with ``pos`` advanced by 1; its tensors are written in place)."""
        pos = int(cache["pos"])
        ids = token_ids.to(self.device)
        at = (torch.full_like(ids, pos) if positions is None
              else positions.to(self.device))
        x = self._embed(ids, at)[:, None, :]
        n = pos + 1
        # columns past pos are not read at all (the JAX package masks them)
        mask = None if kv_valid is None else padding_mask(kv_valid[:, :n])
        rope_cs = self._rope(at[:, None])

        def attention(q, k, v, kv, i):
            k_cache, v_cache = self._dequant_layer_kv(kv, i, n)
            return dot_product_attention(q, k_cache, v_cache, mask=mask)

        kv = self._cache_kv(cache)
        for i, blk in enumerate(self.blocks):
            x = self._cache_layer(blk, x, kv, i, attention, rope_cs,
                                  write_pos=pos)
        return self._head(x), dict(cache, pos=n)

    @torch.no_grad()
    def decode_block(self, cache: Mapping[str, Any], token_ids: torch.Tensor,
                     kv_valid: Optional[torch.Tensor] = None,
                     positions: Optional[torch.Tensor] = None):
        """The prompt prefill: a whole [b, s] block into an EMPTY cache
        (``pos == 0``) in one forward.

        Attention reads the block's own K and V (s x s), never the cache:
        without ``kv_valid`` through the causal flash forward
        (``ops.kernels.flash_attention``, one launch a layer on the
        card); with ``kv_valid`` [b, s] (left-padded ragged rows) through
        the dense path with causal and padding masks, ``positions`` [b, s]
        the rows' position indices.  Under an int8 cache the block attends
        its unquantized K and V, as the JAX package's does; the cache
        holds the quantized ones.  Returns (logits [b, vocab] f32 at the
        last position, the cache with ``pos`` = s)."""
        if int(cache["pos"]) != 0:
            raise ValueError(f"decode_block needs an empty cache (pos == 0);"
                             f" got pos={int(cache['pos'])}")
        ids = token_ids.to(self.device)
        s = ids.shape[1]
        at = (torch.arange(s, device=self.device) if positions is None
              else positions.to(self.device))
        x = self._embed(ids, at)
        if kv_valid is None:
            flash = flash_lib.make_flash_attention_fn(causal=True)

            def block_attn(q, k, v, kv, i):
                return flash(q.contiguous(), k.contiguous(), v.contiguous())
        else:
            mask = (causal_mask(s, device=self.device)
                    + padding_mask(kv_valid.to(self.device)))

            def block_attn(q, k, v, kv, i):
                return dot_product_attention(q, k, v, mask=mask)

        rope_cs = self._rope(at)
        kv = self._cache_kv(cache)
        for i, blk in enumerate(self.blocks):
            x = self._cache_layer(blk, x, kv, i, block_attn, rope_cs,
                                  write_pos=0)
        return self._head(x), dict(cache, pos=s)

    @torch.no_grad()
    def decode_window(self, cache: Mapping[str, Any], token_ids: torch.Tensor,
                      head: Union[str, int] = "all", adapters=None,
                      adapter_rows: Optional[torch.Tensor] = None):
        """``s`` tokens per row against a cache holding ``pos`` columns:
        K/V written at columns ``pos..pos+s-1``, window row j attends
        every column ``<= pos + j``, read back through the cache (int8
        dequantized).  The speculative verifier and the chunked prefill.
        Rolling back is the caller's: moving ``pos`` back hides the later
        columns until they are overwritten.

        ``head``: ``"all"`` -> [b, s, vocab] f32, ``"last"`` -> [b, vocab],
        ``"none"`` -> None (a mid-prefill window only feeds the cache), or
        an int j -> [b, vocab] for window row j only (the contiguous
        engine's first token; the JAX package computes all rows and picks
        one).  ``adapters``/``adapter_rows`` [b]: per-row LoRA adapters,
        as in ``decode_step_slots_paged``.  Returns (logits, the cache
        with ``pos`` advanced by s)."""
        if head not in ("all", "last", "none") and not isinstance(head, int):
            raise ValueError(f"head must be all|last|none or a row index; "
                             f"got {head!r}")
        lora = self._lora_arg(adapters, adapter_rows)
        pos = int(cache["pos"])
        ids = token_ids.to(self.device)
        s = ids.shape[1]
        n = pos + s
        win_pos = pos + torch.arange(s, device=self.device)
        x = self._embed(ids, win_pos)
        cols = torch.arange(n, device=self.device)
        mask = torch.where(cols[None, :] <= win_pos[:, None], 0.0,
                           NEG_INF)[None, None]
        rope_cs = self._rope(win_pos)

        def window_attn(q, k, v, kv, i):
            k_cache, v_cache = self._dequant_layer_kv(kv, i, n)
            return dot_product_attention(q, k_cache, v_cache, mask=mask)

        kv = self._cache_kv(cache)
        for i, blk in enumerate(self.blocks):
            x = self._cache_layer(blk, x, kv, i, window_attn, rope_cs,
                                  write_pos=pos, lora=lora)
        new_cache = dict(cache, pos=n)
        if head == "none":
            return None, new_cache
        if head == "last":
            return self._head(x), new_cache
        if head == "all":
            return self.logits(self._norm(self.ln_f, x)), new_cache
        return self._head(x[:, head:head + 1, :]), new_cache

    @torch.no_grad()
    def prefill_cache(self, cache: Mapping[str, Any], token_ids: torch.Tensor,
                      chunk: Optional[int] = None):
        """The prompt into an EMPTY cache: one ``decode_block`` (``chunk``
        None or >= s), else ``decode_window`` ``chunk`` tokens at a time,
        each window attending the cached prefix and itself.  The two agree
        to round-off, except under an int8 cache: a window reads its own
        K/V back quantized, the block attends them unquantized, so they
        agree to quantization tolerance.  Returns (last-position logits
        [b, vocab] f32, the advanced cache)."""
        s = token_ids.shape[1]
        if s == 0:
            raise ValueError("prefill_cache needs a non-empty prompt")
        if chunk is not None and chunk < 1:
            raise ValueError(f"chunk must be >= 1; got {chunk}")
        if int(cache["pos"]) != 0:
            raise ValueError(
                f"prefill_cache needs an empty cache (pos == 0); got pos="
                f"{int(cache['pos'])}: append to a live cache with "
                "decode_window instead")
        if chunk is None or chunk >= s:
            return self.decode_block(cache, token_ids)
        logits = None
        for lo in range(0, s, chunk):
            logits, cache = self.decode_window(
                cache, token_ids[:, lo:lo + chunk],
                head="last" if lo + chunk >= s else "none")
        return logits, cache

    def _check_gen_lengths(self, plen: int, max_new_tokens: int,
                           max_len: int) -> None:
        """The length rules ``generate`` and ``beam_search`` share."""
        c = self.config
        if max_len > c.max_position and c.position_embedding == "learned":
            # only the learned table runs out of rows; RoPE extrapolates
            raise ValueError(f"generation length {max_len} exceeds "
                             f"max_position {c.max_position}")
        if plen + max_new_tokens > max_len:
            raise ValueError(f"prompt ({plen}) + max_new_tokens "
                             f"({max_new_tokens}) = {plen + max_new_tokens} "
                             f"exceeds max_len {max_len}")

    def _prompt(self, prompt_ids, prompt_valid, max_len: int):
        """(ids [b, plen] int32 on the device, pad_len [b] or None,
        kv_valid [b, max_len] or None) for ``generate``/``beam_search``."""
        ids = torch.as_tensor(prompt_ids).to(self.device, torch.int32)
        if prompt_valid is None:
            return ids, None, None
        pad_len, kv_valid = dec.ragged_prompt_masks(
            torch.as_tensor(prompt_valid).to(self.device), tuple(ids.shape),
            max_len)
        return ids, pad_len, kv_valid

    def _ragged_prefill(self, cache, ids, pad_len, kv_valid):
        """``decode_block`` over left-padded rows, each at its own
        positions ``max(j - pad_len, 0)``."""
        s = ids.shape[1]
        positions = torch.clamp(torch.arange(s, device=self.device)[None, :]
                                - pad_len[:, None], min=0)
        return self.decode_block(cache, ids, kv_valid=kv_valid[:, :s],
                                 positions=positions)

    @torch.no_grad()
    def generate(self, prompt_ids, max_new_tokens: int,
                 temperature: float = 0.0,
                 generator: Optional[torch.Generator] = None,
                 max_len: Optional[int] = None, top_k: Optional[int] = None,
                 top_p: Optional[float] = None,
                 eos_id: Optional[int] = None, pad_id: Optional[int] = None,
                 prompt_valid=None,
                 prefill_chunk: Optional[int] = None) -> torch.Tensor:
        """Autoregressive decoding with the contiguous KV cache.

        ``prompt_ids`` [b, p] -> [b, p + max_new_tokens] int32 on the
        model's device.  ``temperature`` 0 is greedy; above 0 tokens are
        drawn from ``generator`` (on the model's device) after the
        ``top_k``/``top_p`` filters (``ops.decoding``).  A prompt of more
        than one token prefills in one ``decode_block`` (the flash
        forward on the card), or ``prefill_chunk`` tokens at a time
        through ``decode_window``; then one ``decode_step`` a token.

        ``eos_id``: a row that emits EOS after its prompt is finished and
        emits ``pad_id`` (default ``eos_id``) from then on; the loop stops
        once every row has finished (one host read of the finished mask a
        step).  ``prompt_valid`` [b, p]: LEFT-padded ragged prompts (1 =
        real token): pads are masked from attention and each row's
        positions shift by its pad count; it does not compose with
        ``prefill_chunk``."""
        self._refuse_stage("generate")
        if prefill_chunk is not None and prompt_valid is not None:
            raise ValueError("prefill_chunk does not compose with "
                             "prompt_valid (ragged prompts prefill as "
                             "one block)")
        pad = dec.resolve_pad(eos_id, pad_id)
        b, plen = torch.as_tensor(prompt_ids).shape
        total = plen + max_new_tokens
        max_len = max_len or max(total, 1)
        self._check_gen_lengths(plen, max_new_tokens, max_len)
        ids, pad_len, kv_valid = self._prompt(prompt_ids, prompt_valid,
                                              max_len)
        cache = self.init_cache(b, max_len)
        tokens = torch.full((b, total), 0 if eos_id is None else pad,
                            dtype=torch.int32, device=self.device)
        tokens[:, :plen] = ids

        def sample(logits):
            return dec.sample_logits(logits, temperature, top_k, top_p,
                                     generator=generator)

        def advance(carry, i):
            tokens, cache, finished = carry
            if kv_valid is None:
                logits, cache = self.decode_step(cache, tokens[:, i])
            else:
                logits, cache = self.decode_step(
                    cache, tokens[:, i], kv_valid=kv_valid,
                    positions=torch.clamp(i - pad_len, min=0))
            # inside the prompt the next token is the prompt's own
            if i + 1 >= plen:
                nxt = sample(logits)
                if eos_id is not None:
                    nxt, finished = dec.finish_step(nxt, finished, eos_id,
                                                    pad)
                tokens[:, i + 1] = nxt
            return tokens, cache, finished

        finished = torch.zeros((b,), dtype=torch.bool, device=self.device)
        start = 0
        if plen > 1 and max_new_tokens > 0:
            if kv_valid is None:
                logits, cache = self.prefill_cache(cache, ids,
                                                   chunk=prefill_chunk)
            else:
                logits, cache = self._ragged_prefill(cache, ids, pad_len,
                                                     kv_valid)
            nxt = sample(logits)
            if eos_id is not None:
                nxt, finished = dec.finish_step(nxt, finished, eos_id, pad)
            tokens[:, plen] = nxt
            start = plen
        carry = (tokens, cache, finished)
        if eos_id is None:
            for i in range(start, total - 1):
                carry = advance(carry, i)
        else:
            carry, _ = dec.decode_loop(advance, carry, total - 1,
                                       start=start)
        return carry[0]

    @torch.no_grad()
    def beam_search(self, prompt_ids, max_new_tokens: int,
                    beam_size: int = 4, eos_id: Optional[int] = None,
                    length_penalty: float = 0.6,
                    max_len: Optional[int] = None, prompt_valid=None,
                    prefill_chunk: Optional[int] = None) -> torch.Tensor:
        """Beam search over the contiguous KV cache; returns the best beam
        of each row, [b, p + max_new_tokens] int32.

        The prompt but its last token prefills at batch b (one
        ``decode_block``, or ``prefill_chunk`` windows), the cache rows
        are repeated ``beam_size``-fold, and every expansion reorders them
        by gather.  Ranking: ``ops.decoding`` (``expand_beams`` keeps the
        lower index first among tied scores; finished beams extend only
        with EOS at no cost; GNMT length penalty).  With ``eos_id`` the
        loop stops once every beam has finished and the rest reads EOS.
        ``prompt_valid``: LEFT-padded ragged prompts, as ``generate``."""
        self._refuse_stage("beam_search")
        if prefill_chunk is not None and prompt_valid is not None:
            raise ValueError("prefill_chunk does not compose with "
                             "prompt_valid (ragged prompts prefill as "
                             "one block)")
        b, plen = torch.as_tensor(prompt_ids).shape
        k = beam_size
        total = plen + max_new_tokens
        max_len = max_len or max(total, 1)
        self._check_gen_lengths(plen, max_new_tokens, max_len)
        ids, pad_len, kv_valid = self._prompt(prompt_ids, prompt_valid,
                                              max_len)
        dev = self.device
        if kv_valid is not None:
            kv_valid_folded = kv_valid.repeat_interleave(k, dim=0)
            pad_len_folded = pad_len.repeat_interleave(k, dim=0)

        cache = self.init_cache(b, max_len)
        if plen > 1:
            if kv_valid is None:
                _, cache = self.prefill_cache(cache, ids[:, :-1],
                                              chunk=prefill_chunk)
            else:
                _, cache = self._ragged_prefill(cache, ids[:, :-1], pad_len,
                                                kv_valid)
        # beams fold into the batch: row r of batch i -> i*k + r
        cache = dict({n: t.repeat_interleave(k, dim=1)
                      for n, t in self._cache_kv(cache).items()},
                     pos=cache["pos"])
        tokens = torch.zeros((b, k, total), dtype=torch.int32, device=dev)
        tokens[:, :, :plen] = ids[:, None, :]
        scores = dec.init_beam_scores(b, k, device=dev)
        finished = torch.zeros((b, k), dtype=torch.bool, device=dev)
        batch_base = torch.arange(b, device=dev)[:, None] * k

        def advance(carry, i):
            tokens, cache, scores, finished = carry
            tok = tokens.reshape(b * k, total)[:, i]
            if kv_valid is None:
                logits, cache = self.decode_step(cache, tok)
            else:
                logits, cache = self.decode_step(
                    cache, tok, kv_valid=kv_valid_folded,
                    positions=torch.clamp(i - pad_len_folded, min=0))
            logp = torch.log_softmax(logits, dim=-1).reshape(b, k, -1)
            logp = dec.freeze_finished(logp, finished, eos_id)
            scores, beam, nxt = dec.expand_beams(scores, logp)
            tokens = torch.gather(tokens, 1,
                                  beam[:, :, None].expand(b, k, total))
            tokens[:, :, i + 1] = nxt
            finished = torch.gather(finished, 1, beam)
            if eos_id is not None:
                finished = finished | (nxt == eos_id)
            flat = (batch_base + beam).reshape(-1)
            cache = dict({n: t.index_select(1, flat)
                          for n, t in self._cache_kv(cache).items()},
                         pos=cache["pos"])
            return tokens, cache, scores, finished

        carry = (tokens, cache, scores, finished)
        if eos_id is None:
            for i in range(plen - 1, total - 1):
                carry = advance(carry, i)
            tokens, _, scores, _ = carry
        else:
            # unwritten tail columns read EOS: what a full run writes, as
            # frozen beams only ever extend with EOS
            carry, steps = dec.decode_loop(
                lambda c_, j: advance(c_, plen - 1 + j), carry,
                max_new_tokens)
            tokens, _, scores, _ = carry
            col = torch.arange(total, device=dev)[None, None, :]
            tokens = torch.where(col > plen - 1 + steps,
                                 torch.full_like(tokens, eos_id), tokens)
        best = dec.rank_beams(scores, tokens[:, :, plen:], eos_id,
                              max_new_tokens, length_penalty)
        return tokens[torch.arange(b, device=dev), best]

    @torch.no_grad()
    def decode_step_slots(self, kv: Dict[str, torch.Tensor],
                          token_ids: torch.Tensor, write_col: torch.Tensor,
                          kv_valid: torch.Tensor, positions: torch.Tensor,
                          adapters=None,
                          adapter_rows: Optional[torch.Tensor] = None):
        """One token per slot row against a contiguous SLOT cache.

        ``kv``: the cache leaves without ``pos`` (``serve/slots.py``),
        whose batch rows are slots.  Row r writes its token at column
        ``write_col[r]`` (a column past max_len, a dead row's, is
        dropped), attends ``kv_valid[r]`` [max_len] OR its own column,
        and embeds at ``positions[r]`` (the learned table's index clamped
        to its last row: a dead row's output is never read).  Per row
        this is ``decode_step`` at ``pos = write_col[r]``, and every
        operation is row-independent.  ``adapters``/``adapter_rows`` [b]:
        per-slot LoRA adapters, as in ``decode_step_slots_paged``.
        Returns (logits [b, vocab] f32, kv); the cache is written in
        place."""
        self._refuse_stage("decode_step_slots")
        c = self.config
        max_len = kv["k"].shape[2]
        x = self._embed(token_ids, torch.clamp(
            positions, max=c.max_position - 1))[:, None, :]
        cols = torch.arange(max_len, device=self.device)
        mask = padding_mask(kv_valid | (cols[None, :] == write_col[:, None]))
        rope_cs = self._rope(positions[:, None])

        def attention(q, k, v, kv, i):
            k_cache, v_cache = self._dequant_layer_kv(kv, i)
            return dot_product_attention(q, k_cache, v_cache, mask=mask)

        lora = self._lora_arg(adapters, adapter_rows)
        for i, blk in enumerate(self.blocks):
            x = self._cache_layer(blk, x, kv, i, attention, rope_cs,
                                  write_pos=write_col, lora=lora)
        return self._head(x), kv

    def _refuse_tp(self, what: str) -> None:
        if self._line is not None:
            raise NotImplementedError(
                f"{what} under a tensor axis of {tp_lib.size(self._line)}: "
                f"not ported (ROADMAP Queue 1 item 7.2b)")

    # -- sharding ---------------------------------------------------------
    def partition_rules(self, fsdp: bool = False,
                        shard_kv: Optional[bool] = None
                        ) -> sharding_lib.PartitionRules:
        """``gpt_partition_rules`` of this model's config; ``shard_kv``
        defaults to the constructor's."""
        return gpt_partition_rules(self.config, fsdp,
                                   self._kv_on_tensor(shard_kv))


def gpt_partition_rules(config: GPTConfig, fsdp: bool = False,
                        shard_kv: Optional[bool] = None
                        ) -> sharding_lib.PartitionRules:
    """The JAX package's Megatron table (``GPT.partition_rules``) over the
    port's per-layer names: a decoder leaf's spec loses the JAX tree's
    leading layer dim (``decoder/attention/query/kernel`` ``P(None, f,
    "tensor", None)`` is ``(f, "tensor", None)`` on
    ``blocks.<i>.attention.query.kernel`` [d, h, hd]).  ``fsdp=True`` cuts
    the remaining large dim of each matrix over ``fsdp`` (the word
    embedding's dim 1, the attention output's last, ``w_out``'s dim 1);
    keys and values shard over ``tensor`` only under plain MHA unless
    ``shard_kv`` says otherwise.  With ``pipeline_stages`` S > 1 the
    table gives layer ``i``'s leaves to stage ``i // (L / S)`` of
    ``pipe_axis`` (``PartitionRules.stage_for``), where the JAX package
    puts the axis on the stacked leaves' leading layer dim.  A MoE config's
    banks take ``ops.moe.moe_partition_rules``'s rows per layer
    (``blocks.<i>.moe.experts.w_in`` ``("expert", None, "tensor")``, the
    router replicated), where the JAX package prepends the stacked layer
    dim to each."""
    c = config
    f = "fsdp" if fsdp else None
    kv_on_tensor = (shard_kv if shard_kv is not None
                    else c.kv_heads == c.num_heads)
    kv_spec = (f, "tensor", None) if kv_on_tensor else (f, None, None)
    kv_bias = ("tensor", None) if kv_on_tensor else (None, None)
    blk = r"^blocks\.\d+\."
    return sharding_lib.PartitionRules([
        (r"^word$", ("tensor", f)),
        (r"^lm_head$", ("tensor", f)),      # untied head: same split
        (r"^position$", (None, None)),
        (blk + r"attention\.query\.kernel$", (f, "tensor", None)),
        (blk + r"attention\.query\.bias$", ("tensor", None)),
        (blk + r"attention\.(key|value)\.kernel$", kv_spec),
        (blk + r"attention\.(key|value)\.bias$", kv_bias),
        (blk + r"attention\.out\.kernel$", ("tensor", None, f)),
        (blk + r"ffn\.w_(in|gate)\.kernel$", (f, "tensor")),
        (blk + r"ffn\.w_(in|gate)\.bias$", ("tensor",)),
        (blk + r"ffn\.w_out\.kernel$", ("tensor", f)),
        (blk + r"ffn\.w_out\.bias$", (None,)),
        (blk + r"attention\.out\.bias$", (None,)),
        (blk + r"ln_[12]\.(gamma|beta)$", (None,)),
    ] + [(blk + r"moe\." + pat, spec)
         for pat, spec in moe_partition_rules()], stages=((r"^blocks\.(\d+)\.", c.num_layers, c.pipeline_stages,
                c.pipe_axis) if c.pipeline_stages > 1 else None))
