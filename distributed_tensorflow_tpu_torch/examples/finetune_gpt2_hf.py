"""Fine-tune a Hugging Face GPT-2 checkpoint, in PyTorch: the port of
``examples/finetune_gpt2_hf.py``.

    python -m distributed_tensorflow_tpu_torch.examples.finetune_gpt2_hf
        [--device=cuda] [--hf_dir=DIR] [--steps=50] [--batch_size=16]
        [--seq_len=32] [--dtype=float32]

``--hf_dir`` is a local checkpoint directory: ``config.json``, the
weights as ``model.safetensors`` or ``pytorch_model.bin``, and the
tokenizer's ``vocab.json`` and ``merges.txt``.  It is read by
``models.convert.load_hf_dir`` and ``data.GPT2BPETokenizer.load``,
neither of which needs ``transformers``.  Without ``--hf_dir`` the JAX
script's no-download demo runs: a random tiny ``transformers``
GPT2LMHeadModel (vocab 256, d 64, 2 layers of 2 heads, dropout 0, torch
seed 0; ``transformers`` is imported for it alone) with the byte-level
``ByteTokenizer``.

The weights convert through ``models.convert.gpt2_from_hf``; then, as in
the JAX script, rows of ``seq_len + 1`` ids of "the quick brown fox
jumps over the lazy dog. " x 64, ``adamw(3e-4)`` with a global-norm clip
of 1.0 on a batch of ``round_batch_to_mesh(batch_size)`` rows picked by
``np.random.default_rng(0)`` each step, a loss line every 10 steps and
at the last (stderr), and a greedy ``generate`` of 12 tokens from "the
quick brown" (stdout).  ``--dtype`` is the compute dtype over the f32
weights (the JAX script computes in f32, the default).

On the card every attention runs the flash kernel (causal; forward,
dK/dV and dQ; the demo's head dim 32 padded to 64), every norm the
LayerNorm kernel, Adam its kernel on every leaf, and ``generate``'s
prompt prefill the flash forward.  ``--device`` is ``cuda`` by default
and raises when there is no card; ``--device=cpu`` runs the kernels'
plain versions.  ``run(argv)`` is ``main``'s body; it returns the
losses, the generated ids and text, and host-clock marks of the loop.
"""
import os
import sys
import time
from typing import Any, Dict, Optional

from distributed_tensorflow_tpu_torch.utils import flags as flags_lib
from distributed_tensorflow_tpu_torch.utils.flags import FLAGS

CORPUS = "the quick brown fox jumps over the lazy dog. " * 64
PROMPT = "the quick brown"
NEW_TOKENS = 12
LR = 3e-4


def _define_flags() -> None:
    flags_lib.DEFINE_string(
        "device", "cuda",
        "'cuda' (the default; raises without a card) or 'cpu'")
    flags_lib.DEFINE_string("hf_dir", "", "local HF checkpoint dir (config "
                            "+ weights + vocab.json/merges.txt); empty = "
                            "random-init tiny demo model")
    flags_lib.DEFINE_integer("steps", 50, "fine-tune steps")
    flags_lib.DEFINE_integer("batch_size", 16, "global batch size")
    flags_lib.DEFINE_integer("seq_len", 32, "training sequence length")
    flags_lib.DEFINE_string("dtype", "float32",
                            "compute dtype: float32 or bfloat16")


def demo_model():
    """The JAX script's demo: a random tiny ``transformers``
    GPT2LMHeadModel (torch seed 0)."""
    import torch
    import transformers
    torch.manual_seed(0)
    return transformers.GPT2LMHeadModel(transformers.GPT2Config(
        vocab_size=256, n_positions=64, n_embd=64, n_layer=2, n_head=2,
        resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0)).eval()


def rows_of(ids, seq: int):
    """The training rows: consecutive windows of ``seq + 1`` ids."""
    import numpy as np
    n = (len(ids) - 1) // seq
    if n == 0:
        raise SystemExit(
            f"--seq_len={seq} exceeds the tokenized corpus "
            f"({len(ids)} ids) — no training rows")
    return np.stack([ids[i * seq:i * seq + seq + 1] for i in range(n)])


def run(argv: Optional[list] = None) -> Dict[str, Any]:
    _define_flags()
    FLAGS.reset()
    FLAGS.parse(argv)

    import numpy as np
    import torch

    from distributed_tensorflow_tpu_torch import optim, parallel, train
    from distributed_tensorflow_tpu_torch._launch import start
    from distributed_tensorflow_tpu_torch.examples import local_rows
    from distributed_tensorflow_tpu_torch.models import convert
    from distributed_tensorflow_tpu_torch.parallel import cluster

    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    if FLAGS.dtype not in dtypes:
        raise ValueError(f"--dtype={FLAGS.dtype!r}: one of {sorted(dtypes)}")
    device = start(FLAGS.device, cluster.cluster_from_env())
    if FLAGS.hf_dir:
        hf = convert.load_hf_dir(FLAGS.hf_dir)
        from distributed_tensorflow_tpu_torch.data import GPT2BPETokenizer
        tok = GPT2BPETokenizer.load(
            os.path.join(FLAGS.hf_dir, "vocab.json"),
            os.path.join(FLAGS.hf_dir, "merges.txt"))
    else:
        hf = demo_model()
        # the byte-level base: ids < 256 land inside the tiny vocab
        from distributed_tensorflow_tpu_torch.data import ByteTokenizer
        tok = ByteTokenizer()
    encode, decode = tok.encode, tok.decode

    mesh = parallel.data_parallel_mesh()
    model, params = convert.gpt2_from_hf(hf, device=device,
                                         dtype=dtypes[FLAGS.dtype])
    del hf
    print(f"converted GPT-2: {model.config.num_layers} layers, "
          f"hidden {model.config.hidden_size}, "
          f"vocab {model.config.vocab_size}", file=sys.stderr)

    rows = rows_of(np.asarray(encode(CORPUS)), FLAGS.seq_len)
    optimizer = optim.adamw(LR)
    step = train.make_custom_train_step(model.lm_loss_fn(), optimizer,
                                        mesh=mesh, grad_clip_norm=1.0)
    state = train.TrainState.create(params, optimizer.init(params))
    batch = parallel.round_batch_to_mesh(FLAGS.batch_size, mesh)
    rng = np.random.default_rng(0)
    losses, marks = [], [(-1, time.perf_counter())]
    for it in range(FLAGS.steps):
        pick = rng.integers(0, len(rows), batch)
        ids = local_rows({"input_ids": rows[pick].astype(np.int32)}, mesh)
        state, m = step(state, {"input_ids": torch.from_numpy(
            ids["input_ids"]).to(device)})
        losses.append(m["loss"].detach())
        if it % 10 == 0 or it == FLAGS.steps - 1:
            print(f"step {it}: loss={float(m['loss']):.4f}",
                  file=sys.stderr)
            marks.append((it, time.perf_counter()))

    prompt = torch.from_numpy(encode(PROMPT)[None].astype(np.int32))
    out = model.generate(prompt.to(device), max_new_tokens=NEW_TOKENS,
                         temperature=0.0)
    ids = out[0].cpu().tolist()
    text = decode(ids)
    print("generated:", repr(text))
    return {"losses": [float(x) for x in losses], "ids": ids, "text": text,
            "marks": marks, "batch": batch, "seq_len": FLAGS.seq_len}


def main(argv: Optional[list] = None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
