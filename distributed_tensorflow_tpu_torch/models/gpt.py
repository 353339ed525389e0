"""GPT decoder for paged serving and causal-LM training, in PyTorch.

Counterpart of ``distributed_tensorflow_tpu/models/gpt.py``, the subset
the port's paths run: pre-LN decoder blocks in two recipes, chosen by
the config as in the JAX package.  GPT-2: learned positions, LayerNorm,
the tanh-gelu FFN, biases and a head tied to the word embedding.  Llama
(``models/llama.py``): RoPE, RMSNorm, the SwiGLU FFN, no biases, a
separate ``lm_head`` and grouped-query attention.  Either may keep its
KV cache in int8 (``kv_cache_dtype="int8"``): each written key and value
vector is quantized with its own f32 scale (``ops/quant.py``) into the
pool's ``k_scale``/``v_scale`` planes, and the paged-attention kernel
dequantizes at the operand.  Serving drives ``decode_window_paged``
(chunked prefill) and ``decode_step_slots_paged`` (one token per slot)
against a shared KV page pool (``serve/pages.py``), under
``torch.no_grad()``.  Training drives
``apply`` (the full-sequence forward, causal flash attention) through
``lm_loss_fn`` (next-token cross-entropy).

Parameters keep the JAX package's layouts (projection kernels ``[d, h,
hd]`` and ``[h, hd, d]``) and stay float32; each product casts them to
the compute dtype, as the JAX code's ``.astype(dtype)`` does.
``models/convert.py`` loads a JAX parameter tree.

Kernels: every block norm and ``ln_f`` go through
``ops.kernels.fused.fused_layernorm`` or ``fused_rmsnorm``, every paged
read through ``ops.kernels.paged_attention`` and the training forward's
attention through ``ops.kernels.flash_attention`` (forward, dK/dV and
dQ).  Those wrappers launch the CUDA kernel for CUDA tensors and run
their plain version only for CPU tensors: the tensor's device decides,
there is no knob.  The JAX package's gates (``use_flash="auto"``,
``fused_layernorm=False``) are not ported: on the card the kernels are
always the path.

Numerics: TF32 stays off.  This module never sets
``torch.backends.cuda.matmul.allow_tf32`` or
``torch.backends.cudnn.allow_tf32``, so a float32 model computes in full
float32 on the card.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import losses as loss_lib
from ..ops import quant
from ..ops.attention import (affine, apply_rope, attention_core, dropout,
                             ffn_core, ffn_swiglu_core, project, rope_tables)
from ..ops.kernels import flash_attention as flash_lib
from ..ops.kernels import fused as fused_lib
from ..ops.kernels import paged_attention as paged_lib

__all__ = ["GPT", "GPTConfig", "gpt_small", "gpt_tiny", "resolve_device"]


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """``device`` as a ``torch.device``; raises for a CUDA device when
    there is no card (the port never falls back to the CPU by itself)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card unless the caller "
            "passes device='cpu'")
    return device


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

    def __post_init__(self):
        if self.kv_cache_dtype not in (None, "int8"):
            raise ValueError(f"kv_cache_dtype must be None or 'int8'; "
                             f"got {self.kv_cache_dtype!r}")
        if self.norm not in ("layernorm", "rmsnorm"):
            raise ValueError(f"norm must be 'layernorm' or 'rmsnorm'; "
                             f"got {self.norm!r}")
        if self.ffn_activation not in ("gelu", "swiglu"):
            raise ValueError(f"ffn_activation must be 'gelu' or 'swiglu'; "
                             f"got {self.ffn_activation!r}")
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


class _Block(nn.Module):
    def __init__(self, c: GPTConfig, device):
        super().__init__()
        self.ln_1 = _Norm(c, device)
        self.attention = _Attention(c, device)
        self.ln_2 = _Norm(c, device)
        self.ffn = _FFN(c, device)


class GPT(nn.Module):
    """Decoder stack for paged serving and causal-LM training.

    ``GPT(config, device="cuda", generator=None)``: weights are random,
    truncated normal (std 0.02, cut at 2 std) from ``generator`` (seed 0
    when None), biases zero, norms identity, all float32 and trainable.
    The Llama recipe has no ``position``, ``beta`` or ``bias`` parameters,
    a ``w_gate`` in every FFN and, untied, a top-level ``lm_head``.
    Raises for ``cuda`` when there is no card; tests pass
    ``device="cpu"``.  Parameter names (``named_parameters``) are the JAX
    tree's paths with the decoder unstacked: ``blocks.<i>.<path>`` is
    layer i of the JAX leaf ``decoder.<path>`` (``models/convert.py``).
    """

    def __init__(self, config: GPTConfig, *,
                 device: Union[str, torch.device] = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        c = self.config = config
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

    @property
    def device(self) -> torch.device:
        return self.word.device

    # -- blocks -----------------------------------------------------------
    def _norm(self, p: _Norm, x: torch.Tensor) -> torch.Tensor:
        c = self.config
        if c.norm == "rmsnorm":
            return fused_lib.fused_rmsnorm(x.contiguous(), p.gamma,
                                           c.layer_norm_eps)
        return fused_lib.fused_layernorm(x.contiguous(), p.gamma, p.beta,
                                         c.layer_norm_eps)

    def _ffn(self, blk: _Block, x: torch.Tensor) -> torch.Tensor:
        f = blk.ffn
        h = self._norm(blk.ln_2, x)
        if self.config.ffn_activation == "swiglu":
            return ffn_swiglu_core(f.w_gate.kernel, f.w_gate.bias,
                                   f.w_in.kernel, f.w_in.bias,
                                   f.w_out.kernel, f.w_out.bias, h)
        return ffn_core(f.w_in.kernel, f.w_in.bias, f.w_out.kernel,
                        f.w_out.bias, h)

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """LM head (the word embedding, or ``lm_head`` when untied) ->
        [..., vocab] f32 logits."""
        head = self.word if self.lm_head is None else self.lm_head
        return (hidden @ head.T.to(hidden.dtype)).float()

    def _embed(self, token_ids: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
        x = self.word[token_ids.long()]
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
                     paged, attention: Callable, rope_cs) -> torch.Tensor:
        """One decoder layer against the page pool.  ``paged``: (page ids
        [N], offsets [N]) with N = b*s, the pool cell token t of the
        flattened window writes to.  In order: RoPE on q and k (when
        ``rope_cs``), the K/V write (int8 pools: quantized per token and
        kv head, values and scales written together), then attention, so
        the read sees each token's own column.  The write is an in-place
        ``index_put_`` on layer ``i`` of the pool (the JAX package donates
        the pool buffer instead)."""
        h = self._norm(blk.ln_1, x)
        a = blk.attention
        q, k, v = (project(p.kernel, p.bias, h)
                   for p in (a.query, a.key, a.value))
        if rope_cs is not None:
            q, k = apply_rope(q, *rope_cs), apply_rope(k, *rope_cs)

        def write(name, val):
            kv[name][i].index_put_(
                paged, val.reshape(-1, *val.shape[2:]).to(kv[name].dtype))
        for name, val in (("k", k), ("v", v)):
            if "k_scale" in kv:
                qt = quant.quantize_tensor(val, reduce_axes=(-1,))
                write(name, qt.q)
                write(name + "_scale", qt.scale)
            else:
                write(name, val)
        attn = attention(q, kv, i)
        nh, hd, d = a.out.kernel.shape
        attn_out = affine(a.out.kernel.reshape(nh * hd, d), a.out.bias,
                          attn.reshape(*attn.shape[:2], nh * hd))
        x = x + attn_out
        return x + self._ffn(blk, x)

    # -- full-sequence forward and the LM loss -----------------------------
    def apply(self, input_ids: torch.Tensor, train: bool = False,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """input_ids [b, s] -> hidden [b, s, d] in the compute dtype (after
        ``ln_f``).  Causal attention through the flash kernel, RoPE on q
        and k before it under ``position_embedding="rope"``.  With
        ``train`` and a nonzero ``dropout_rate``, dropout (embedding,
        attention context, both residual branches) draws from
        ``generator``.  (This replaces ``nn.Module.apply(fn)``, which the
        port never uses, with the JAX package's name.)"""
        c = self.config
        ids = input_ids.to(self.device).long()
        s = ids.shape[1]
        x = F.embedding(ids, self.word)
        if self.position is not None:
            x = x + self.position[:s][None]
        x = dropout(x, c.dropout_rate, generator, train).to(c.dtype)
        attention_fn = flash_lib.make_flash_attention_fn(causal=True)
        rope_cs = self._rope(torch.arange(s, device=self.device))
        qk_transform = None if rope_cs is None else (
            lambda q, k: (apply_rope(q, *rope_cs), apply_rope(k, *rope_cs)))
        for blk in self.blocks:
            a = blk.attention
            params = {name: {"kernel": p.kernel, "bias": p.bias} for name, p
                      in (("query", a.query), ("key", a.key),
                          ("value", a.value), ("out", a.out))}
            attn = attention_core(params, self._norm(blk.ln_1, x),
                                  dropout_rate=c.dropout_rate,
                                  generator=generator, train=train,
                                  attention_fn=attention_fn,
                                  qk_transform=qk_transform)
            x = x + dropout(attn, c.dropout_rate, generator, train)
            x = x + dropout(self._ffn(blk, x), c.dropout_rate, generator,
                            train)
        return self._norm(self.ln_f, x)

    def lm_loss_fn(self) -> Callable:
        """``loss_fn(params, model_state, batch, generator, train) ->
        (loss, (metrics, model_state))``, the contract of
        ``train.make_custom_train_step``.  ``params`` are this model's own
        parameters by name (``dict(model.named_parameters())``): the loss
        reads them through the model, and the step's gradients and updates
        are taken on those tensors.  ``batch``: ``input_ids`` [b, s] and
        optional ``loss_mask`` [b, s - 1]; the targets are the inputs
        shifted by one.  Metrics: ``token_accuracy`` and, under a mask,
        ``loss_weight`` (its sum)."""
        own = dict(self.named_parameters())

        def loss_fn(params: Mapping[str, torch.Tensor], model_state: Any,
                    batch: Mapping[str, torch.Tensor],
                    generator: Optional[torch.Generator], train: bool):
            if params.keys() != own.keys() or any(
                    params[k] is not p for k, p in own.items()):
                raise ValueError("lm_loss_fn takes the model's own "
                                 "parameters, dict(model.named_parameters())")
            ids = batch["input_ids"].to(self.device).long()
            hidden = self.apply(ids[:, :-1], train=train, generator=generator)
            targets = ids[:, 1:]
            mask = batch.get("loss_mask")
            if mask is not None:
                mask = mask.to(self.device).float()
            logits = self.logits(hidden)
            loss = loss_lib.softmax_cross_entropy_with_integer_labels(
                logits, targets, where=mask)
            hits = (logits.argmax(-1) == targets).float()
            metrics = {}
            if mask is None:
                metrics["token_accuracy"] = hits.mean()
            else:
                metrics["token_accuracy"] = ((hits * mask).sum()
                                             / torch.clamp(mask.sum(), min=1.0))
                metrics["loss_weight"] = mask.sum()
            return loss, (metrics, model_state)

        return loss_fn

    # -- paged decode -----------------------------------------------------
    @torch.no_grad()
    def decode_step_slots_paged(self, kv: Dict[str, torch.Tensor],
                                token_ids: torch.Tensor,
                                page_tab: torch.Tensor,
                                write_col: torch.Tensor,
                                kv_valid: torch.Tensor,
                                positions: torch.Tensor):
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
        no validity mask looks.  Returns (logits [b, vocab] f32, kv); the
        pool is updated in place."""
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

        def attention(q, kv, i):
            return paged_lib.paged_decode_attention(q.contiguous(), kv, i,
                                                    page_tab, valid)

        for i, blk in enumerate(self.blocks):
            x = self._cache_layer(blk, x, kv, i, paged, attention, rope_cs)
        x = self._norm(self.ln_f, x)
        return self.logits(x)[:, 0, :], kv

    @torch.no_grad()
    def decode_window_paged(self, kv: Dict[str, torch.Tensor],
                            token_ids: torch.Tensor, page_row: torch.Tensor,
                            pos: int, head: Union[str, int] = "all"):
        """A batch-1 window of ``s`` tokens at positions ``pos..pos+s-1``
        through one request's ``page_row`` [P] int32: K/V are written to
        their pool cells, then row j attends every column ``<= pos + j``
        (shared prefix pages included) through the window kernel.

        ``head``: ``"all"`` -> [1, s, vocab] f32 logits, ``"none"`` ->
        None (intermediate prefill windows only feed the pool), or an int
        j -> [1, vocab] for window row j only (the scheduler's first-token
        shape; the JAX package computes all rows and picks one).  Pad columns past the row's
        view write to the trash page 0.  Returns (logits, kv); the pool
        is updated in place."""
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

        def attention(q, kv, i):
            return paged_lib.paged_window_attention(q.contiguous(), kv, i,
                                                    page_row, pos)

        for i, blk in enumerate(self.blocks):
            x = self._cache_layer(blk, x, kv, i, paged, attention, rope_cs)
        if head == "none":
            return None, kv
        if head == "all":
            return self.logits(self._norm(self.ln_f, x)), kv
        x = x[:, head:head + 1, :]
        return self.logits(self._norm(self.ln_f, x))[:, 0, :], kv
