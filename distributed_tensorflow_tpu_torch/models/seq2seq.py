"""Encoder-decoder transformer (seq2seq), in PyTorch.

Counterpart of ``distributed_tensorflow_tpu/models/seq2seq.py``:
``Seq2SeqConfig``, ``seq2seq_tiny`` and ``Seq2Seq`` (``init``, ``encode``,
``decode``, ``logits``, ``seq2seq_loss_fn``, ``generate``).  Pre-LN
blocks, learned absolute positions (one table for each side), a head
tied to the word embedding; a bidirectional encoder over the source and
a causal decoder with cross-attention into the encoder's memory.

Functional like ``models/bert.py``: ``init`` returns a flat dict of f32
leaf tensors under the JAX tree's paths with both stacks unstacked
(``encoder.<i>.<path>``, ``decoder.<i>.<path>``).  Attention is the dense
``dot_product_attention`` with additive masks (causal, source padding),
as the JAX package computes it outside any Pallas kernel; every
LayerNorm goes through the LayerNorm kernel (BERT's ``layer_norm``).

``generate`` (greedy, or sampled from a ``torch.Generator``) encodes once
and then runs the whole decoder again at each target position over the
BOS-filled target, as the JAX package's cache-free scan does, and
projects only the row it extends.  With ``eos_id`` the loop stops once
every row has finished (``ops.decoding.decode_loop``: one host read a
step) and the rest is padded.  ``beam_search`` flattens the beams into
the batch for the decoder and ranks them as the JAX package does
(``ops.decoding``'s stable beam helpers).

Tensor parallelism (``Seq2Seq(config, mesh=...)`` with a ``tensor`` axis
of T > 1 ranks; ``partition_rules`` is the JAX package's table): ``init``
draws the whole model, as at T = 1, and returns this rank's blocks
(marked, ``parallel.sharding.mark_block``), as ``models/bert.py`` does.
The word embedding is looked up vocabulary-parallel on both sides; the
encoder's self-attention, the decoder's self- and cross-attention and
every FFN are Megatron's (``ops/attention.py``).  The encoder's memory
comes onto the tensor line once a ``decode`` call (one ``copy_to_line``,
whose backward is one all-reduce of the memory's gradient for every
layer together), and each layer's cross-attention projects its heads'
keys and values from it.  The tied head's logits stay cut over the
vocabulary into the vocabulary-parallel cross entropy and argmax of
``seq2seq_loss_fn``; ``logits`` gathers them whole, so ``generate`` and
``beam_search`` run on every rank of the line and give the plain
model's tokens.  A mesh with ``fsdp`` beside ``tensor`` trains under
``train.shard_train_state`` with ``partition_rules(fsdp=True)``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional

import torch

from ..ops import decoding as dec
from ..ops import initializers as init_lib
from ..ops.attention import (attention_core, causal_mask, dropout,
                             padding_mask, resolve_activation)
from ..parallel import sharding as sharding_lib
from ..parallel import tensor_parallel as tp_lib
from .bert import (attention_params, ffn, init_attention, init_ffn, init_ln,
                   layer_norm, stacked_decay_mask, trainable)
from .gpt import _checkpointed

__all__ = ["Seq2SeqConfig", "Seq2Seq", "seq2seq_tiny"]


@dataclasses.dataclass
class Seq2SeqConfig:
    vocab_size: int = 32128
    hidden_size: int = 512
    num_encoder_layers: int = 6
    num_decoder_layers: int = 6
    num_heads: int = 8
    intermediate_size: int = 2048
    max_position: int = 512
    dropout_rate: float = 0.1
    layer_norm_eps: float = 1e-6
    dtype: torch.dtype = torch.float32
    remat: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


def seq2seq_tiny(**kw) -> "Seq2Seq":
    """The JAX package's ``seq2seq_tiny``: vocab 128, d 64, 2 + 2 layers
    of 2 heads."""
    for k, v in dict(vocab_size=128, hidden_size=64, num_encoder_layers=2,
                     num_decoder_layers=2, num_heads=2,
                     intermediate_size=128, max_position=64).items():
        kw.setdefault(k, v)
    return Seq2Seq(Seq2SeqConfig(**kw))


_gelu = resolve_activation("gelu_approx")


class Seq2Seq:
    """Functional encoder-decoder: ``init(generator) -> params``;
    ``encode`` / ``decode`` / ``logits`` / ``seq2seq_loss_fn`` /
    ``generate``.  ``mesh``: a ``parallel.Mesh``, with a ``tensor`` axis
    for tensor parallelism (module docstring)."""

    def __init__(self, config: Seq2SeqConfig, mesh=None):
        self.config = config
        self.mesh = mesh
        if mesh is not None:
            sharding_lib.check_mesh(mesh)
        # the tensor line, None at T = 1
        self.line = tp_lib.active(mesh)
        self.stacks = {"encoder": config.num_encoder_layers,
                       "decoder": config.num_decoder_layers}

    def decay_mask(self, params: Mapping[str, torch.Tensor]
                   ) -> Dict[str, bool]:
        """``adamw``'s mask for these parameters, the JAX default (as
        ``Bert.decay_mask``)."""
        return stacked_decay_mask(params, self.stacks)

    def init(self, generator: Optional[torch.Generator] = None
             ) -> Dict[str, torch.Tensor]:
        """Truncated normal (std 0.02) embeddings and kernels, zero biases,
        identity norms; drawn from ``generator`` on its device.  Under
        tensor parallelism the whole model is drawn and this rank's
        blocks returned."""
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
                  "embeddings.enc_position": draw((c.max_position, d)),
                  "embeddings.dec_position": draw((c.max_position, d))}
        for layer in range(c.num_encoder_layers):
            pre = f"encoder.{layer}"
            params.update(init_ln(d, pre + ".ln_1", dev))
            params.update(init_attention(draw, d, h, hd, pre + ".attention",
                                         zeros))
            params.update(init_ln(d, pre + ".ln_2", dev))
            params.update(init_ffn(draw, d, i, pre + ".ffn", zeros))
        for layer in range(c.num_decoder_layers):
            pre = f"decoder.{layer}"
            params.update(init_ln(d, pre + ".ln_1", dev))
            params.update(init_attention(draw, d, h, hd,
                                         pre + ".self_attention", zeros))
            params.update(init_ln(d, pre + ".ln_x", dev))
            params.update(init_attention(draw, d, h, hd,
                                         pre + ".cross_attention", zeros))
            params.update(init_ln(d, pre + ".ln_2", dev))
            params.update(init_ffn(draw, d, i, pre + ".ffn", zeros))
        params.update(init_ln(d, "ln_enc_f", dev))
        params.update(init_ln(d, "ln_dec_f", dev))
        params = trainable(params)
        if self.line is None:
            return params
        return sharding_lib.cut_blocks(params, self.partition_rules(),
                                       self.line)

    # -- blocks -----------------------------------------------------------
    def _ln(self, p, name, x):
        return layer_norm(p, name, x, self.config.layer_norm_eps)

    def _enc_block(self, p, x, src_mask, generator, train):
        c = self.config
        a = attention_core(attention_params(p, "attention"),
                           self._ln(p, "ln_1", x), mask=src_mask,
                           dropout_rate=c.dropout_rate, generator=generator,
                           train=train, mesh=self.line)
        x = x + dropout(a, c.dropout_rate, generator, train)
        f = ffn(p, "ffn", self._ln(p, "ln_2", x), _gelu, self.line)
        return x + dropout(f, c.dropout_rate, generator, train)

    def _dec_block(self, p, x, memory, self_mask, cross_mask, generator,
                   train):
        """One decoder layer; ``memory`` is on the tensor line already
        (``decode``)."""
        c = self.config
        a = attention_core(attention_params(p, "self_attention"),
                           self._ln(p, "ln_1", x), mask=self_mask,
                           dropout_rate=c.dropout_rate, generator=generator,
                           train=train, mesh=self.line)
        x = x + dropout(a, c.dropout_rate, generator, train)
        ca = attention_core(attention_params(p, "cross_attention"),
                            self._ln(p, "ln_x", x), kv=memory,
                            mask=cross_mask, dropout_rate=c.dropout_rate,
                            generator=generator, train=train,
                            mesh=self.line)
        x = x + dropout(ca, c.dropout_rate, generator, train)
        f = ffn(p, "ffn", self._ln(p, "ln_2", x), _gelu, self.line)
        return x + dropout(f, c.dropout_rate, generator, train)

    def _stack(self, params, side: str, n: int, block: Callable, x,
               generator):
        """``x`` through the ``n`` layers of ``side``, each under
        ``_checkpointed`` with ``remat``; ``block(p, x)``."""
        for i in range(n):
            pre = f"{side}.{i}."
            names = [k for k in params if k.startswith(pre)]

            def layer(x, *tensors, rel=[k[len(pre):] for k in names]):
                return block(dict(zip(rel, tensors)), x)
            tensors = [params[k] for k in names]
            if self.config.remat:
                x = _checkpointed(layer, generator, None, x, *tensors)
            else:
                x = layer(x, *tensors)
        return x

    @staticmethod
    def _check_rng(train, rng, what):
        if train and rng is None:
            raise ValueError(f"{what}(train=True) requires a generator "
                             "(rng)")

    # -- forward ----------------------------------------------------------
    def encode(self, params: Mapping[str, torch.Tensor], src_ids,
               src_valid=None, *, train: bool = False,
               rng: Optional[torch.Generator] = None) -> torch.Tensor:
        """-> memory [b, s, d]; ``src_valid`` [b, s] 1/0 masks the
        source's padding."""
        c = self.config
        self._check_rng(train, rng, "encode")
        dev = params["embeddings.word"].device
        ids = torch.as_tensor(src_ids, device=dev).long()
        x = tp_lib.vocab_parallel_embed(ids, params["embeddings.word"],
                                        self.line)
        x = x + params["embeddings.enc_position"][:ids.shape[1]][None]
        x = dropout(x, c.dropout_rate, rng, train).to(c.dtype)
        mask = (None if src_valid is None
                else padding_mask(torch.as_tensor(src_valid, device=dev)))
        x = self._stack(params, "encoder", c.num_encoder_layers,
                        lambda p, x: self._enc_block(p, x, mask, rng, train),
                        x, rng)
        return self._ln(params, "ln_enc_f", x)

    def decode(self, params: Mapping[str, torch.Tensor], memory, tgt_ids,
               src_valid=None, *, train: bool = False,
               rng: Optional[torch.Generator] = None) -> torch.Tensor:
        """-> hidden [b, t, d]: causal self-attention, then
        cross-attention into ``memory`` (brought onto a tensor line once
        here, for every layer)."""
        c = self.config
        self._check_rng(train, rng, "decode")
        dev = params["embeddings.word"].device
        ids = torch.as_tensor(tgt_ids, device=dev).long()
        t = ids.shape[1]
        memory = tp_lib.copy_to_line(memory, self.line)
        x = tp_lib.vocab_parallel_embed(ids, params["embeddings.word"],
                                        self.line)
        x = x + params["embeddings.dec_position"][:t][None]
        x = dropout(x, c.dropout_rate, rng, train).to(c.dtype)
        self_mask = causal_mask(t, device=dev)
        cross_mask = (None if src_valid is None
                      else padding_mask(torch.as_tensor(src_valid,
                                                        device=dev)))
        x = self._stack(params, "decoder", c.num_decoder_layers,
                        lambda p, x: self._dec_block(
                            p, x, memory, self_mask, cross_mask, rng, train),
                        x, rng)
        return self._ln(params, "ln_dec_f", x)

    def _local_logits(self, params: Mapping[str, torch.Tensor],
                      hidden: torch.Tensor) -> torch.Tensor:
        """The tied head's f32 logits of this rank's vocabulary rows (all
        of them at T = 1)."""
        hidden = tp_lib.copy_to_line(hidden, self.line)
        return (hidden @ params["embeddings.word"].T.to(hidden.dtype)
                ).float()

    def logits(self, params: Mapping[str, torch.Tensor],
               hidden: torch.Tensor) -> torch.Tensor:
        """Tied head -> [..., vocab] f32 (gathered whole over a tensor
        line)."""
        return tp_lib.gather_from_line(self._local_logits(params, hidden),
                                       self.line)

    # -- training ---------------------------------------------------------
    def seq2seq_loss_fn(self) -> Callable:
        """``make_custom_train_step``'s contract.  ``batch``: ``src_ids``
        [b, s], ``tgt_ids`` [b, t] (BOS first; the targets are the ids
        shifted by one), optional ``src_valid`` [b, s] and ``loss_mask``
        [b, t - 1].  Metrics: ``token_accuracy``, and under a mask
        ``loss_weight``.  The encoder and the decoder draw their dropout
        from the one generator, in that order.  Under tensor parallelism
        the logits stay cut over the vocabulary (the vocabulary-parallel
        cross entropy and argmax), and every rank of the line holds the
        whole loss."""
        def loss_fn(params, model_state, batch, generator, train):
            dev = params["embeddings.word"].device
            src_valid = batch.get("src_valid")
            memory = self.encode(params, batch["src_ids"], src_valid,
                                 train=train, rng=generator)
            tgt = torch.as_tensor(batch["tgt_ids"], device=dev).long()
            hidden = self.decode(params, memory, tgt[:, :-1], src_valid,
                                 train=train, rng=generator)
            logits = self._local_logits(params, hidden)
            targets = tgt[:, 1:]
            mask = batch.get("loss_mask")
            nll = tp_lib.vocab_parallel_cross_entropy(
                logits.reshape(-1, logits.shape[-1]), targets.reshape(-1),
                self.line).reshape(targets.shape)
            if mask is None:
                loss = nll.mean()
            else:
                mask = torch.as_tensor(mask, device=dev).float()
                loss = (nll * mask).sum() / torch.clamp(mask.sum(), min=1e-9)
            with torch.no_grad():
                hits = (tp_lib.vocab_parallel_argmax(logits, self.line)
                        == targets).float()
                if mask is None:
                    metrics = {"token_accuracy": hits.mean()}
                else:
                    metrics = {"token_accuracy": (hits * mask).sum()
                               / torch.clamp(mask.sum(), min=1.0),
                               "loss_weight": mask.sum()}
            return loss, (metrics, model_state)
        return loss_fn

    # -- generation -------------------------------------------------------
    @torch.no_grad()
    def generate(self, params: Mapping[str, torch.Tensor], src_ids,
                 max_new_tokens: int, bos_id: int = 0,
                 temperature: float = 0.0,
                 generator: Optional[torch.Generator] = None,
                 src_valid=None, top_k: Optional[int] = None,
                 top_p: Optional[float] = None,
                 eos_id: Optional[int] = None,
                 pad_id: Optional[int] = None) -> torch.Tensor:
        """[b, max_new_tokens] int32 (BOS not included): greedy at
        ``temperature <= 0``, else drawn from ``generator``; rows that
        emit ``eos_id`` pad with ``pad_id`` (default ``eos_id``)."""
        c = self.config
        if max_new_tokens > c.max_position:
            raise ValueError(f"max_new_tokens {max_new_tokens} exceeds "
                             f"max_position {c.max_position}")
        pad = dec.resolve_pad(eos_id, pad_id)
        dev = params["embeddings.word"].device
        src = torch.as_tensor(src_ids, device=dev)
        b = src.shape[0]
        memory = self.encode(params, src, src_valid)
        tgt = torch.full((b, max_new_tokens + 1), bos_id, dtype=torch.int32,
                         device=dev)

        def advance(carry, i):
            tgt, finished = carry
            hidden = self.decode(params, memory, tgt[:, :-1], src_valid)
            logits = self.logits(params, hidden[:, i])
            nxt = dec.sample_logits(logits, temperature, top_k, top_p,
                                    generator)
            if eos_id is not None:
                nxt, finished = dec.finish_step(nxt, finished, eos_id, pad)
            tgt = tgt.clone()
            tgt[:, i + 1] = nxt
            return tgt, finished

        finished = torch.zeros(b, dtype=torch.bool, device=dev)
        if eos_id is None:
            for i in range(max_new_tokens):
                tgt, finished = advance((tgt, finished), i)
            return tgt[:, 1:]
        (tgt, finished), stop = dec.decode_loop(advance, (tgt, finished),
                                                max_new_tokens)
        tgt[:, stop + 1:] = pad
        return tgt[:, 1:]

    @torch.no_grad()
    def beam_search(self, params: Mapping[str, torch.Tensor], src_ids,
                    max_new_tokens: int, beam_size: int = 4,
                    bos_id: int = 0, eos_id: Optional[int] = None,
                    length_penalty: float = 0.6,
                    src_valid=None) -> torch.Tensor:
        """The best beam of each row, [b, max_new_tokens] int32: scores are
        sums of log-probabilities, a finished beam (it emitted
        ``eos_id``) keeps its score and extends with EOS only, and the
        final ranking divides by ``length ** length_penalty``.  With
        ``eos_id`` the loop stops once every beam has finished and the
        unwritten tail is EOS."""
        c = self.config
        if max_new_tokens > c.max_position:
            raise ValueError(f"max_new_tokens {max_new_tokens} exceeds "
                             f"max_position {c.max_position}")
        dev = params["embeddings.word"].device
        src = torch.as_tensor(src_ids, device=dev)
        b, k, T = src.shape[0], beam_size, max_new_tokens
        memory = self.encode(params, src, src_valid)
        mem_k = memory.repeat_interleave(k, dim=0)
        valid_k = (None if src_valid is None else torch.as_tensor(
            src_valid, device=dev).repeat_interleave(k, dim=0))
        seqs = torch.full((b, k, T + 1), bos_id, dtype=torch.int32,
                          device=dev)
        scores = dec.init_beam_scores(b, k, device=dev)
        finished = torch.zeros((b, k), dtype=torch.bool, device=dev)

        def advance(carry, i):
            seqs, scores, finished = carry
            hidden = self.decode(params, mem_k,
                                 seqs.reshape(b * k, T + 1)[:, :-1], valid_k)
            logp = torch.log_softmax(self.logits(params, hidden[:, i]),
                                     dim=-1).reshape(b, k, -1)
            logp = dec.freeze_finished(logp, finished, eos_id)
            scores, beam, tok = dec.expand_beams(scores, logp)
            seqs = torch.gather(seqs, 1, beam[:, :, None].expand(-1, -1,
                                                                 T + 1))
            seqs[:, :, i + 1] = tok
            finished = torch.gather(finished, 1, beam)
            if eos_id is not None:
                finished = finished | (tok == eos_id)
            return seqs, scores, finished

        carry = (seqs, scores, finished)
        if eos_id is None:
            for i in range(T):
                carry = advance(carry, i)
        else:
            carry, steps = dec.decode_loop(advance, carry, T)
            carry[0][:, :, steps + 1:] = eos_id
        seqs, scores, _ = carry
        best = dec.rank_beams(scores, seqs[:, :, 1:], eos_id, T,
                              length_penalty)
        return seqs[torch.arange(b, device=dev), best, 1:]

    # -- sharding ---------------------------------------------------------
    def partition_rules(self, fsdp: bool = False
                        ) -> sharding_lib.PartitionRules:
        """The JAX package's Megatron table (``Seq2Seq.partition_rules``)
        over the port's per-layer names (a layer leaf's spec without the
        JAX tree's leading layer dim): the heads of every attention (the
        encoder's, the decoder's self- and cross-attention) and the FFN's
        hidden dim on ``tensor``, the word embedding's vocabulary too;
        ``fsdp=True`` cuts each matrix's other large dim over ``fsdp``.
        No match replicates (positions, norms, the output biases)."""
        f = "fsdp" if fsdp else None
        att = r"^(encoder|decoder)\.\d+\.(self_|cross_)?attention\."
        ffn_ = r"^(encoder|decoder)\.\d+\.ffn\."
        return sharding_lib.PartitionRules([
            (r"^embeddings\.word$", ("tensor", f)),
            (r"^embeddings\.(enc|dec)_position$", (None, None)),
            (att + r"(query|key|value)\.kernel$", (f, "tensor", None)),
            (att + r"(query|key|value)\.bias$", ("tensor", None)),
            (att + r"out\.kernel$", ("tensor", None, f)),
            (ffn_ + r"w_in\.kernel$", (f, "tensor")),
            (ffn_ + r"w_in\.bias$", ("tensor",)),
            (ffn_ + r"w_out\.kernel$", ("tensor", f)),
        ])
