"""End-to-end distributed GPT training, in PyTorch: the port of
``examples/train_gpt.py``, the whole training stack in one script.

    python -m distributed_tensorflow_tpu_torch.examples.train_gpt
        [--device=cuda] [--steps=200] [--batch_size=32] [--seq_len=64]
        [--log_dir=/tmp/dttpu_gpt] [--seed=0] [--num_layers=2]
        [--family=gpt2|llama] [--remat] [--remat_policy=full]
        [--loss_seq_chunk=0] [--pipeline_stages=0] [--pp_schedule=gpipe]

Causal-LM training on the order-1 synthetic corpus (``--seed``), with

  * a ``data`` x ``fsdp`` mesh over the process group (``fsdp`` 2 on an
    even rank count above 1, as the JAX script picks it) and ZeRO
    placement (``GPT.partition_rules(fsdp=True)`` through
    ``train.shard_train_state``: the parameters' master blocks, Adam's
    moments and the EMA shadow cut over ``fsdp``);
  * bf16 compute over the f32 master weights (``mixed_bfloat16``);
  * ``with_ema(adamw(3e-3), 0.99)`` with a global-norm clip of 1.0;
  * a ``TrainSession`` with stop, logging, NaN and (on the chief)
    summary hooks, writing sharded per-process checkpoints to
    ``--log_dir`` and resuming from them;
  * eval of the live and the EMA weights against the uniform loss, and
    a greedy ``generate`` from the trained weights at the end.

It exits 1 with a warning when the live eval loss does not beat the
uniform baseline.  Every attention runs the flash kernel, every norm the
LayerNorm (``gpt2``) or RMSNorm (``llama``) kernel and Adam its kernel on
every block.

``--pipeline_stages`` P above 1 takes the JAX script's pipeline path: a
``{"pipe": P, "data": n / P}`` mesh (no ``fsdp``; P must divide the
rank count and ``--num_layers``), ``GPTConfig(pipeline_stages=P)`` built
on it (each rank holds its stage's layers, placed by
``shard_train_state``), ``--pp_schedule`` ``gpipe`` (the normal step
through the pipelined ``lm_loss_fn``) or ``1f1b``
(``train.make_1f1b_train_step``), no precision policy (the config's
bf16 is the compute dtype, as the JAX script sets it), and the global
batch rounded up to a multiple of the data shards times the
microbatches (each data rank's batch splits into P microbatches).  Eval
and ``generate`` run on a whole model loaded from the gathered stages
(``train.gather_params``, ``optim.ema_params``).

``--device`` is ``cuda`` by default and raises
without a card; ``--device=cpu`` runs on the CPU.  Several processes
form a group from ``COORDINATOR_ADDRESS``, ``NUM_PROCESSES`` and
``PROCESS_ID`` (``parallel.cluster_from_env``).
"""
import math
import sys

from distributed_tensorflow_tpu_torch.utils import flags as flags_lib
from distributed_tensorflow_tpu_torch.utils.flags import FLAGS

VOCAB = 256


def _define_flags() -> None:
    flags_lib.DEFINE_string(
        "device", "cuda",
        "'cuda' (the default; raises without a card) or 'cpu'")
    flags_lib.DEFINE_integer("steps", 200, "training steps")
    flags_lib.DEFINE_integer("batch_size", 32, "global batch size")
    flags_lib.DEFINE_integer("seq_len", 64, "sequence length")
    flags_lib.DEFINE_string("log_dir", "/tmp/dttpu_gpt",
                            "checkpoints + events")
    flags_lib.DEFINE_integer("seed", 0, "data/init seed")
    flags_lib.DEFINE_integer("num_layers", 2, "decoder blocks")
    flags_lib.DEFINE_integer("pipeline_stages", 0,
                             "split the decoder over a 'pipe' mesh axis "
                             "(0 = off; must divide --num_layers AND the "
                             "rank count; replaces the fsdp axis)")
    flags_lib.DEFINE_string("pp_schedule", "gpipe",
                            "pipeline schedule: gpipe (the step's "
                            "backward through the pipeline) | 1f1b "
                            "(hand-scheduled, O(stages) stashed inputs)")
    flags_lib.DEFINE_string("family", "gpt2",
                            "decoder recipe: gpt2 (layernorm/gelu/learned "
                            "positions) | llama (rmsnorm/swiglu/rope/GQA)")
    flags_lib.DEFINE_integer("loss_seq_chunk", 0,
                             "chunked LM loss: N tokens at a time (0 = off)")
    flags_lib.DEFINE_string("remat_policy", "full",
                            "with remat: full | dots | dots_no_batch")
    flags_lib.DEFINE_bool("remat", False, "recompute each decoder layer in "
                          "the backward")


def corpus_rows(seq_len: int, seed: int):
    """The script's rows of ``seq_len + 1`` tokens: the order-1 (bigram)
    synthetic corpus of 200,000 tokens, strongly learnable, so short runs
    show a real drop below the uniform loss."""
    from distributed_tensorflow_tpu_torch.data import (lm_sequences,
                                                       synthetic_lm_corpus)
    return lm_sequences(synthetic_lm_corpus(VOCAB, 200_000, seed=seed,
                                            order=1), seq_len)


def config_of(family: str, **dims):
    """The script's model config for ``--family``."""
    from distributed_tensorflow_tpu_torch.models.gpt import GPTConfig
    from distributed_tensorflow_tpu_torch.models.llama import llama_config
    if family == "llama":
        return llama_config(num_kv_heads=2, **dims)
    if family == "gpt2":
        return GPTConfig(**dims)
    raise SystemExit(f"--family={family!r}: gpt2|llama")


def main(argv=None) -> int:
    _define_flags()
    FLAGS.reset()
    FLAGS.parse(argv)

    import numpy as np
    import torch

    from distributed_tensorflow_tpu_torch import (data, optim, parallel,
                                                  summary, train)
    from distributed_tensorflow_tpu_torch._launch import start
    from distributed_tensorflow_tpu_torch.models.gpt import GPT
    from distributed_tensorflow_tpu_torch.parallel import cluster

    device = start(FLAGS.device, cluster.cluster_from_env())
    n = parallel.data_parallel_mesh().size
    pp = FLAGS.pipeline_stages
    if pp > 1:
        if n % pp:
            raise SystemExit(f"--pipeline_stages={pp} does not divide the "
                             f"device count {n}")
        if FLAGS.num_layers % pp:
            raise SystemExit(f"--pipeline_stages={pp} does not divide "
                             f"--num_layers={FLAGS.num_layers}")
        if FLAGS.pp_schedule not in ("gpipe", "1f1b"):
            raise SystemExit(f"--pp_schedule={FLAGS.pp_schedule!r}: "
                             f"gpipe|1f1b")
        fsdp = 1
        mesh = parallel.make_mesh({"pipe": pp, "data": n // pp})
    else:
        fsdp = 2 if n % 2 == 0 and n > 1 else 1
        mesh = parallel.make_mesh({"data": n // fsdp, "fsdp": fsdp})
    print(f"devices: {n} ({device.type}), mesh={mesh.shape}",
          file=sys.stderr)

    dims = dict(vocab_size=VOCAB, num_layers=FLAGS.num_layers, num_heads=4,
                hidden_size=128, max_position=FLAGS.seq_len,
                dtype=torch.bfloat16, remat=FLAGS.remat,
                remat_policy=FLAGS.remat_policy,
                loss_seq_chunk=FLAGS.loss_seq_chunk)
    config = config_of(FLAGS.family, **dims)
    model = GPT(config_of(FLAGS.family, pipeline_stages=pp if pp > 1
                          else 0, **dims),
                device=device, mesh=mesh if pp > 1 else None,
                generator=torch.Generator(device).manual_seed(FLAGS.seed))
    optimizer = optim.with_ema(optim.adamw(3e-3), decay=0.99)
    params = dict(model.named_parameters())
    state = train.TrainState.create(params, optimizer.init(params))
    state = train.shard_train_state(state, mesh,
                                    model.partition_rules(fsdp=fsdp > 1))
    if pp > 1 and FLAGS.pp_schedule == "1f1b":
        step = train.make_1f1b_train_step(model, optimizer, seed=FLAGS.seed,
                                          grad_clip_norm=1.0)
    else:
        # under pp no policy: the config's bf16 already casts the compute
        step = train.make_custom_train_step(
            model.lm_loss_fn(), optimizer, seed=FLAGS.seed, mesh=mesh,
            grad_clip_norm=1.0,
            policy=None if pp > 1 else "mixed_bfloat16")

    rows = corpus_rows(FLAGS.seq_len, FLAGS.seed)
    batch = parallel.round_batch_to_mesh(FLAGS.batch_size, mesh)
    shards = parallel.data_shards(mesh)
    if pp > 1 and batch % (shards * pp):
        # each data rank's rows split into pp microbatches
        quantum = shards * pp
        batch = -(-FLAGS.batch_size // quantum) * quantum
        print(f"batch_size -> {batch} (divisible by {quantum}: data shards"
              f" x pipeline microbatches)", file=sys.stderr)
    local = parallel.local_batch_size(batch, mesh)
    part = slice(mesh.data_index * local, (mesh.data_index + 1) * local)
    ds = data.Dataset([rows], batch, seed=FLAGS.seed)

    chief = parallel.is_chief()
    writer = summary.SummaryWriter(FLAGS.log_dir) if chief else None
    hooks = [train.StopAtStepHook(FLAGS.steps),
             train.LoggingHook(every_steps=20),
             train.NaNHook(every_steps=20)]
    if writer is not None:
        hooks.append(train.SummaryHook(writer, every_steps=10))

    with train.TrainSession(state, step, checkpoint_dir=FLAGS.log_dir,
                            hooks=hooks, sharded_checkpoint=True) as sess:
        while not sess.should_stop():
            for (b,) in ds:
                if sess.should_stop():
                    break
                sess.run_step({"input_ids": torch.from_numpy(
                    np.ascontiguousarray(b[part])).to(device)})
        final = sess.state
    if writer is not None:
        writer.close()

    # eval the live and the EMA weights on held-out rows; generate.  Under
    # pp both run on whole models built from the gathered stages.
    eval_rows = torch.from_numpy(rows[-64:]).to(device)
    live_params = train.gather_params(final)
    ema_params = optim.ema_params(final.opt_state)
    if pp > 1:
        model = GPT(config, device=device)
        model.load_state_dict(live_params)
        live_params = dict(model.named_parameters())
    ema_model = GPT(config, device=device)
    ema_model.load_state_dict(ema_params)

    @torch.no_grad()
    def eval_loss(m, params):
        loss, (metrics, _) = m.lm_loss_fn()(
            params, (), {"input_ids": eval_rows}, None, False)
        return float(loss), float(metrics["token_accuracy"])
    live = eval_loss(model, live_params)
    ema = eval_loss(ema_model, dict(ema_model.named_parameters()))
    uniform = math.log(config.vocab_size)
    print(f"eval loss: live={live[0]:.3f} ema={ema[0]:.3f} "
          f"(uniform={uniform:.3f}); token acc live={live[1]:.3f}",
          flush=True)

    out = model.generate(eval_rows[:2, :8], max_new_tokens=16)
    print(f"generated: {out[0].tolist()}", flush=True)
    if live[0] >= uniform:
        print("WARNING: did not beat the uniform baseline", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
