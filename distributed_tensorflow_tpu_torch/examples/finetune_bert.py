"""BERT classification fine-tune, in PyTorch: the port of
``examples/finetune_bert.py``.

    python -m distributed_tensorflow_tpu_torch.examples.finetune_bert
        [--device=cuda] [--steps=150] [--batch_size=32] [--seq_len=32]
        [--seed=0] [--mlm_steps=0] [--mlm_predictions_per_seq=0]
        [--remat] [--remat_policy=full]

A small BERT (vocab 64, d 128, 2 layers of 4 heads of 32, FFN 256, bf16
compute over f32 weights, dropout 0.1) with the [CLS] pooler and a fresh
two-class head, trained with ``adamw(5e-4)`` and a global-norm clip of
1.0 on a synthetic task (does the sequence hold the trigger token 7?),
then evaluated on 256 held-out sequences.  ``--mlm_steps`` first trains
the encoder with the MLM head on BERT's corruption (80% [MASK], 10% a
random token, 10% kept, applied on the host), where
``--mlm_predictions_per_seq`` gathers the masked positions before the
head.  The data come from numpy's generator seeded with ``--seed``, as in
the JAX script, so both draw the same batches.

Every attention runs the flash kernel at head dim 32 (zero-padded to 64
in its wrapper) and every LayerNorm the LayerNorm kernel; Adam runs its
kernel on every leaf.  ``--fused_layernorm`` is the JAX script's kernel
gate and has no effect.  The mesh is the JAX script's: ``{"data": n //
tp, "tensor": tp}`` over the process group's n ranks, with ``tp = 2`` on
an even n above 1, where the model is tensor-parallel (each rank of a
``tensor`` line holds its blocks, placed by ``train.shard_train_state``
as the JAX script places its state) and the step averages over the
``data`` line.  Ranks that share one card run over gloo
(``DTTPU_DIST_BACKEND=gloo``; NCCL refuses them).

``--device`` is ``cuda`` by default and raises when there is no card;
``--device=cpu`` runs on the CPU.
"""
import sys

from distributed_tensorflow_tpu_torch.utils import flags as flags_lib
from distributed_tensorflow_tpu_torch.utils.flags import FLAGS

TRIGGER = 7          # class 1 iff this token id appears in the sequence
NUM_CLASSES = 2
MASK_ID = 1          # reserved: data tokens are drawn from [8, vocab)


def _define_flags() -> None:
    flags_lib.DEFINE_string(
        "device", "cuda",
        "'cuda' (the default; raises without a card) or 'cpu'")
    flags_lib.DEFINE_integer("steps", 150, "training steps")
    flags_lib.DEFINE_integer("batch_size", 32, "global batch size")
    flags_lib.DEFINE_integer("seq_len", 32, "sequence length")
    flags_lib.DEFINE_integer("seed", 0, "data/init seed")
    flags_lib.DEFINE_integer("mlm_steps", 0,
                             "MLM pretrain steps before the classifier "
                             "fine-tune (the standard BERT recipe order)")
    flags_lib.DEFINE_integer("mlm_predictions_per_seq", 0,
                             "gather at most N masked positions before the "
                             "MLM head (0 = project every position)")
    flags_lib.DEFINE_bool("fused_layernorm", False,
                          "the JAX script's kernel gate; no effect (the "
                          "LayerNorm kernel is always the path)")
    flags_lib.DEFINE_bool("remat", False, "checkpoint each encoder layer")
    flags_lib.DEFINE_string("remat_policy", "full",
                            "remat policy: full | dots | dots_no_batch")


def make_batch(rng, vocab, batch, seq):
    ids = rng.integers(8, vocab, (batch, seq)).astype("int32")
    labels = rng.integers(0, NUM_CLASSES, batch).astype("int32")
    pos = rng.integers(0, seq, batch)
    rows = labels == 1
    ids[rows, pos[rows]] = TRIGGER
    return ids, labels


def mlm_batch(rng, vocab, batch, seq):
    """One MLM batch with BERT's corruption at the masked positions."""
    import numpy as np
    ids = rng.integers(8, vocab, (batch, seq)).astype(np.int32)
    mask = (rng.random((batch, seq)) < 0.15).astype(np.float32)
    inp = ids.copy()
    r = rng.random((batch, seq))
    m = mask == 1.0
    inp[m & (r < 0.8)] = MASK_ID
    rand_rows = m & (r >= 0.8) & (r < 0.9)
    inp[rand_rows] = rng.integers(8, vocab,
                                  int(rand_rows.sum())).astype(np.int32)
    return {"input_ids": inp, "labels": ids, "mlm_mask": mask,
            "attention_mask": np.ones_like(ids)}


def main(argv=None) -> int:
    _define_flags()
    FLAGS.reset()
    FLAGS.parse(argv)

    import numpy as np
    import torch

    from distributed_tensorflow_tpu_torch import optim, parallel, train
    from distributed_tensorflow_tpu_torch._launch import start
    from distributed_tensorflow_tpu_torch.examples import local_rows
    from distributed_tensorflow_tpu_torch.models.bert import Bert, BertConfig
    from distributed_tensorflow_tpu_torch.ops import losses
    from distributed_tensorflow_tpu_torch.parallel import cluster

    device = start(FLAGS.device, cluster.cluster_from_env())
    n = cluster.process_count()
    tp = 2 if n % 2 == 0 and n > 1 else 1
    mesh = parallel.make_mesh({"data": n // tp, "tensor": tp})
    print(f"devices: {n} ({device.type}), mesh={dict(mesh.shape)}",
          file=sys.stderr)

    config = BertConfig(vocab_size=64, hidden_size=128, num_layers=2,
                        num_heads=4, intermediate_size=256,
                        max_position=FLAGS.seq_len, dropout_rate=0.1,
                        dtype=torch.bfloat16,
                        mlm_predictions_per_seq=FLAGS.mlm_predictions_per_seq,
                        fused_layernorm=FLAGS.fused_layernorm,
                        remat=FLAGS.remat, remat_policy=FLAGS.remat_policy)
    model = Bert(config, mesh=mesh)
    params = model.init(torch.Generator(device).manual_seed(FLAGS.seed))
    # fine-tune head: fresh [hidden, classes] on top of the pooler
    params["classifier.kernel"] = torch.zeros(
        config.hidden_size, NUM_CLASSES, device=device, requires_grad=True)
    params["classifier.bias"] = torch.zeros(NUM_CLASSES, device=device,
                                            requires_grad=True)

    def loss_fn(p, model_state, batch, generator, train_flag):
        seq_out = model.apply(p, batch["input_ids"], train=train_flag,
                              rng=generator)
        pooled = model.pooled(p, seq_out)
        logits = (pooled @ p["classifier.kernel"].to(pooled.dtype)
                  + p["classifier.bias"].to(pooled.dtype)).float()
        labels = batch["labels"].to(logits.device).long()
        loss = losses.softmax_cross_entropy_with_integer_labels(logits,
                                                                labels)
        with torch.no_grad():
            acc = (logits.argmax(-1) == labels).float().mean()
        return loss, ({"accuracy": acc}, model_state)

    optimizer = optim.adamw(5e-4, mask=model.decay_mask)
    state = train.TrainState.create(params, optimizer.init(params))
    if tp > 1:
        state = train.shard_train_state(state, mesh, model.partition_rules())
    step = train.make_custom_train_step(loss_fn, optimizer, seed=FLAGS.seed,
                                        mesh=mesh, grad_clip_norm=1.0)

    def put(tree):
        return {k: torch.from_numpy(v).to(device)
                for k, v in local_rows(tree, mesh).items()}

    rng = np.random.default_rng(FLAGS.seed)
    batch = parallel.round_batch_to_mesh(FLAGS.batch_size, mesh)

    # Optional MLM warm-up (the BERT recipe's order: pretrain the encoder
    # with the MLM head, then fine-tune the classifier); the phase where
    # mlm_predictions_per_seq gathers before the vocab projection.
    if FLAGS.mlm_steps:
        mlm_step = train.make_custom_train_step(
            model.mlm_loss_fn(), optimizer, seed=FLAGS.seed, mesh=mesh,
            grad_clip_norm=1.0)
        for i in range(FLAGS.mlm_steps):
            mb = put(mlm_batch(rng, config.vocab_size, batch, FLAGS.seq_len))
            state, mlm_m = mlm_step(state, mb)
            if (i + 1) % 25 == 0 or i + 1 == FLAGS.mlm_steps:
                print(f"mlm step {i + 1}: "
                      f"loss={float(mlm_m['loss']):.4f} "
                      f"acc={float(mlm_m['mlm_accuracy']):.3f}",
                      flush=True)

    for i in range(FLAGS.steps):
        ids, labels = make_batch(rng, config.vocab_size, batch,
                                 FLAGS.seq_len)
        state, metrics = step(state, put({"input_ids": ids,
                                          "labels": labels}))
        if (i + 1) % 25 == 0:
            print(f"step {i + 1}: loss={float(metrics['loss']):.4f} "
                  f"acc={float(metrics['accuracy']):.3f}", flush=True)

    # held-out eval
    ids, labels = make_batch(np.random.default_rng(FLAGS.seed + 1),
                             config.vocab_size, 256, FLAGS.seq_len)
    with torch.no_grad():
        _, (m, _) = loss_fn(state.params, {},
                            {"input_ids": torch.from_numpy(ids).to(device),
                             "labels": torch.from_numpy(labels).to(device)},
                            None, False)
    print(f"eval accuracy: {float(m['accuracy']):.3f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
