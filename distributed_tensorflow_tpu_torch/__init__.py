"""PyTorch/CUDA port of distributed_tensorflow_tpu for NVIDIA Hopper.

The JAX package beside it is the reference; this package imports none of
it, nor JAX.  Slice 1 is the paged serving path: ``GPT`` (GPT-2 family)
driven by ``Engine`` over a KV page pool, with hand-written CUDA kernels
for paged attention and LayerNorm.  Slice 2 is causal-LM training:
``GPT.lm_loss_fn``, ``adamw`` and ``make_custom_train_step``, with
hand-written CUDA kernels for flash attention (forward, dK/dV, dQ) and
the Adam step.  Slice 3 serves the Llama family (``llama3_8b``) with an
int8 KV cache, with a hand-written RMSNorm kernel and the int8 branch of
the paged-attention kernel.  Slice 7 decodes single streams on the
contiguous KV cache: ``GPT.generate``, ``GPT.beam_search``,
``GPT.prefill_cache`` and ``generate_speculative``, whose prompt prefill
runs the flash forward kernel, and ``Engine(paged=False)``.  Slice 9 is
the engine's request surface: per-request LoRA adapters
(``Engine.load_adapter``), admission with a queue bound, deadlines and
tenant quotas (``fleet.TenantPolicy``), and live migration
(``export_request``/``import_request``, with KV pages shipped between
engines through ``fleet.pagewire``); it adds no kernel.  Slice 10 is
the rest of GPT training: ``TrainSession`` with hooks, checkpoints in the
JAX package's format and TensorBoard event files, accumulation, the
precision policy and loss scaling, per-block remat and the chunked LM
loss (``GPTConfig.remat``, ``loss_seq_chunk``), ``with_ema`` and the
learning-rate schedules, and the synthetic LM ``Dataset``; it adds no
kernel either.  Slice 11 is the source system's own path, ``example.py``
(``python -m distributed_tensorflow_tpu_torch.example``): the XOR MLP of
``ops.serial``/``Dense``/``Dropout`` with its activations,
initializers, losses and metrics, ``data.xor_data`` and
``prefetch_to_device``, ``make_train_step``/``make_eval_step``, the flags,
the cluster bootstrap over ``torch.distributed`` and the data-parallel
mesh with its gradient all-reduce; Adam runs its kernel on every leaf.
Slice 12 is the high-level tier (``models.Sequential``).  Slice 13 is the
sight and the survival of both paths: ``obs`` (the metrics registry and
its ``/metrics`` endpoint, host traces, ``Telemetry``, goodput, request
traces and critical paths) and ``resilience`` (fault plans and the
auto-resume ``Supervisor``), wired into ``TrainSession``, the prefetch,
checkpoints and the serving engine; it adds no kernel.  Slice 14 is the
serving fleet: N engines behind ``fleet.Router`` (placement, retry, live
migration over ``fleet.PageWire``, rolling operations), ``fleet.Watchdog``
over the pump heartbeat, ``fleet.Autoscaler``, ``fleet.synthesize``
traces and ``obs.FederatedMetrics``; it adds no kernel.  Slice 15 is
the encoder zoo: ``models.Bert`` (MLM, the gathered head, the pooler),
``models.ViT``, ``models.ResNet`` and ``models.Seq2Seq``, with
``ops.MultiHeadAttention`` and the entry points ``examples.finetune_bert``
and ``examples.train_vit``; BERT and ViT run the flash kernel
bidirectional with key padding, and at head dims 16 and 32 padded to 64
in its wrapper.  Slice 17 is text and Hugging Face interop: the
tokenizers (``data.ByteTokenizer``, ``BPETokenizer`` with its host C++
encoder, ``GPT2BPETokenizer`` without ``regex``), the native batch
loader behind ``data.Dataset(backend="native")``, ``tfrecord_batches``,
the HF converters for GPT-2, BERT, ViT and Llama with ``load_hf_dir``
(no ``transformers``), and ``examples.finetune_gpt2_hf``; it adds no
kernel.  Kernels live
in ``ops/kernels``, their sources in ``csrc/``.  Entry points run on the
card unless given ``device="cpu"``.
"""
from . import (data, fleet, models, obs, ops, optim, parallel, resilience,
               serve, summary, train, utils)
from .fleet import QuotaExceededError, TenantPolicy, TenantQuota
from .models.convert import (bert_from_hf, bert_params_from_jax,
                             bert_params_to_jax, gpt2_from_hf,
                             gpt_params_from_jax, gpt_params_to_jax,
                             llama_from_hf, load_hf_dir, load_jax_params,
                             lora_from_jax, lora_to_jax,
                             seq2seq_params_from_jax, seq2seq_params_to_jax,
                             stack_params_from_jax, stack_params_to_jax,
                             train_state_from_jax, train_state_to_jax,
                             vit_from_hf, vit_params_from_jax,
                             vit_params_to_jax)
from .models.gpt import GPT, GPTConfig, gpt_small, gpt_tiny
from .models.llama import (llama, llama2_7b, llama3_8b, llama_config,
                           llama_tiny)
from .models.speculative import generate_speculative, speculative_accept
from .ops.quant import QTensor, dequantize_tensor, quantize_tensor
from .optim import adam, adamw, ema_params, with_ema
from .serve.engine import (DrainResult, Engine, EngineStats, QueueFullError,
                           RequestHandle, RequestSnapshot)
from .summary import SummaryWriter
from .train import (TrainSession, TrainState, init_train_state,
                    make_custom_train_step, make_eval_step, make_train_step)

__all__ = ["DrainResult", "Engine", "EngineStats", "GPT", "GPTConfig",
           "QTensor", "QueueFullError", "QuotaExceededError",
           "RequestHandle", "RequestSnapshot", "SummaryWriter",
           "TenantPolicy", "TenantQuota", "TrainSession", "TrainState",
           "adam", "adamw", "bert_from_hf", "bert_params_from_jax",
           "bert_params_to_jax",
           "data", "dequantize_tensor", "ema_params",
           "fleet", "models", "obs", "resilience", "serve",
           "generate_speculative", "gpt2_from_hf", "gpt_params_from_jax",
           "gpt_params_to_jax", "gpt_small", "gpt_tiny", "init_train_state",
           "llama", "llama2_7b", "llama3_8b", "llama_config",
           "llama_from_hf", "llama_tiny", "load_hf_dir", "load_jax_params", "lora_from_jax", "lora_to_jax",
           "make_custom_train_step", "make_eval_step", "make_train_step",
           "ops", "optim", "parallel", "quantize_tensor",
           "seq2seq_params_from_jax", "seq2seq_params_to_jax",
           "speculative_accept", "stack_params_from_jax",
           "stack_params_to_jax", "summary", "train",
           "train_state_from_jax", "train_state_to_jax", "utils",
           "vit_from_hf", "vit_params_from_jax", "vit_params_to_jax",
           "with_ema"]
