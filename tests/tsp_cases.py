"""The cases and the JAX side of the port's tests of ``tensor`` beside
``seq`` (``tests/test_torch_tp_sp.py``, ``tests/test_torch_tp_sp_graft.py``):
the models' weights (drawn by the port's ``init``: the JAX package draws
op by op, slowly, on the CPU) and batches, the JAX package's step on
``shard_pytree(params, jmesh, rules)`` over an XLA CPU mesh, and its
one-device forward."""
import concurrent.futures
import dataclasses

import numpy as np
import torch

import jax
import jax.numpy as jnp

from distributed_tensorflow_tpu import optim as joptim
from distributed_tensorflow_tpu.models import bert as jbert
from distributed_tensorflow_tpu.models import gpt as jgpt
from distributed_tensorflow_tpu.parallel import mesh as jmesh
from distributed_tensorflow_tpu_torch import GPT, gpt_tiny
from distributed_tensorflow_tpu_torch.models import bert as tbert
from distributed_tensorflow_tpu_torch.models import convert
from distributed_tensorflow_tpu_torch.models.llama import llama_tiny

import tpf_cases

AXES = {"seq": 2, "tensor": 2}
GRAFT_AXES = {"data": 2, "seq": 2, "tensor": 2}
LR = 1e-3
_GPT_FIELDS = ("vocab_size", "hidden_size", "num_layers", "num_heads",
               "intermediate_size", "max_position", "layer_norm_eps",
               "num_kv_heads", "position_embedding", "rope_base", "norm",
               "ffn_activation", "use_bias", "tied_head")
_BERT_FIELDS = ("vocab_size", "hidden_size", "num_layers", "num_heads",
                "intermediate_size", "max_position", "type_vocab_size",
                "layer_norm_eps", "mlm_predictions_per_seq")


def _gpt_batches(vocab, masked):
    """Two batches of 8 rows of 17 tokens (16 positions, 8 a seq rank);
    ``masked``: a ``loss_mask`` whose counts differ between the shards."""
    rng = np.random.default_rng(3)
    out = []
    for _ in range(2):
        b = {"input_ids": rng.integers(0, vocab, (8, 17)).astype(np.int64)}
        if masked:
            keep = rng.random((8, 16)) < np.linspace(0.9, 0.3, 16)
            b["loss_mask"] = keep.astype(np.float32)
        out.append(b)
    return out


def _bert_batches(vocab, seq=16, rows=8, lengths=(16, 9, 5, 12, 8, 3, 16,
                                                  11), seed=3):
    """Two MLM batches with key padding: rows of ``lengths`` real tokens,
    so at 16 positions over 2 seq ranks the rows of 8 or fewer have no
    real key on rank 1's block."""
    rng = np.random.default_rng(seed)
    valid = (np.arange(seq)[None, :]
             < np.array(lengths)[:rows, None]).astype(np.int64)
    return [{"input_ids": rng.integers(0, vocab, (rows, seq)),
             "labels": rng.integers(0, vocab, (rows, seq)),
             "mlm_mask": ((rng.random((rows, seq)) < 0.3) * valid).astype(
                 np.float32),
             "attention_mask": valid} for _ in range(2)]


def gpt_case(config, shard_kv, masked=False, remat_policy=None):
    """A worker case of a GPT config with ``seq_axis="seq"``: weights
    drawn from seed 0."""
    model = GPT(dataclasses.replace(config, seq_axis=None), device="cpu",
                generator=torch.Generator().manual_seed(0))
    return {"kind": "gpt", "config": dataclasses.asdict(config),
            "shard_kv": shard_kv, "remat_policy": remat_policy,
            "state": {k: v.detach().numpy().copy()
                      for k, v in model.state_dict().items()},
            "batches": _gpt_batches(config.vocab_size, masked)}


def bert_case(config, batches, remat_policy=None):
    """A worker case of a BERT config with ``seq_axis="seq"``: weights
    drawn from seed 0."""
    params = tbert.Bert(dataclasses.replace(config, seq_axis=None)).init(
        torch.Generator().manual_seed(0))
    return {"kind": "bert", "config": dataclasses.asdict(config),
            "remat_policy": remat_policy,
            "state": {k: v.detach().numpy().copy()
                      for k, v in params.items()},
            "batches": batches}


def cases():
    """{name: worker case} of ``tests/test_torch_tp_sp.py``: GPT-2 tiny
    (2 heads: one a rank; a loss mask), the Llama recipe tiny (4 q / 2 kv
    heads) with its kv heads cut (``shard_kv``) and replicated, and with
    1 kv head replicated (fewer kv heads than tensor ranks), and BERT
    tiny (MLM, the gathered head, key padding); dropout off."""
    bert = tbert.BertConfig(hidden_size=128, num_layers=2, num_heads=2,
                            intermediate_size=512, vocab_size=1000,
                            max_position=16, dropout_rate=0.0,
                            mlm_predictions_per_seq=3, seq_axis="seq")
    return {
        "gpt2": gpt_case(gpt_tiny(dropout_rate=0.0, seq_axis="seq"), None,
                         masked=True, remat_policy="full"),
        "llama_skv": gpt_case(llama_tiny(seq_axis="seq"), True,
                              remat_policy="dots"),
        "llama": gpt_case(llama_tiny(seq_axis="seq"), None),
        "llama_kv1": gpt_case(llama_tiny(seq_axis="seq", num_kv_heads=1),
                              None, remat_policy="dots"),
        "bert": bert_case(bert, _bert_batches(bert.vocab_size),
                          remat_policy="full"),
    }


def graft_case():
    """The JAX package's multi-chip check (``__graft_entry__.py``
    ``dryrun_multichip(8)``): BERT with vocab 512, d 64, 2 layers of 2
    heads, FFN 128, 32 positions, an MLM batch of 2 rows a data rank with
    a 15% mask, on ``{"data": 2, "seq": 2, "tensor": 2}``; dropout off
    (its bits are the generators', not ``jax.random``'s) and two
    steps."""
    config = tbert.BertConfig(vocab_size=512, hidden_size=64, num_layers=2,
                              num_heads=2, intermediate_size=128,
                              max_position=32, dropout_rate=0.0,
                              seq_axis="seq")
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(2):
        batches.append({
            "input_ids": rng.integers(0, 512, (4, 32)),
            "labels": rng.integers(0, 512, (4, 32)),
            "mlm_mask": (rng.random((4, 32)) < 0.15).astype(np.float32),
            "attention_mask": np.ones((4, 32), np.int64)})
    return bert_case(config, batches)


def _jax_gpt(case, mesh):
    c = case["config"]
    return jgpt.GPT(jgpt.GPTConfig(
        dropout_rate=0.0, seq_axis=None if mesh is None else "seq",
        **{f: c[f] for f in _GPT_FIELDS}), mesh=mesh)


def _jax_bert(case, mesh):
    c = case["config"]
    return jbert.Bert(jbert.BertConfig(
        dropout_rate=0.0, seq_axis=None if mesh is None else "seq",
        **{f: c[f] for f in _BERT_FIELDS}), mesh=mesh)


def _port_config(case):
    from distributed_tensorflow_tpu_torch import GPTConfig
    cls = GPTConfig if case["kind"] == "gpt" else tbert.BertConfig
    return cls(**dict(case["config"], seq_axis=None))


def to_jax(case):
    """The JAX tree (numpy leaves) of a case's whole weights."""
    state = {k: torch.from_numpy(v) for k, v in case["state"].items()}
    if case["kind"] == "gpt":
        return convert.gpt_params_to_jax(state, _port_config(case))
    return convert.bert_params_to_jax(state, _port_config(case))


def to_port(case):
    """``tree -> the port's whole parameters (numpy)`` of a case."""
    config = _port_config(case)
    fn = (convert.gpt_params_from_jax if case["kind"] == "gpt"
          else convert.bert_params_from_jax)

    def convert_tree(tree):
        return {k: v.detach().numpy() for k, v in fn(tree, config).items()}
    return convert_tree


def jax_steps(case, axes):
    """The JAX step (adamw 1e-3, clip 1.0) over ``axes`` on the case's
    weights, the model built with ``seq_axis`` on that mesh: (each step's
    metrics, the port's whole parameters after the steps)."""
    n = int(np.prod(list(axes.values())))
    jm = jmesh.make_mesh(axes, jax.devices()[:n])
    if case["kind"] == "gpt":
        jmodel = _jax_gpt(case, jm)
        rules = jmodel.partition_rules(shard_kv=case["shard_kv"])
        loss_fn = jmodel.lm_loss_fn()
    else:
        jmodel = _jax_bert(case, jm)
        rules = jmodel.partition_rules()
        loss_fn = jmodel.mlm_loss_fn()
    return tpf_cases.jax_steps(axes, jmodel, to_jax(case), rules, loss_fn,
                               joptim.adamw(LR), case["batches"],
                               to_port(case))


def jax_forward(case):
    """The JAX package's one-device forward of the case's first batch:
    {"hidden": apply's output (a GPT's of ``input_ids[:, :-1]``),
    "pooled" (BERT)}."""
    params = jax.tree.map(jnp.asarray, to_jax(case))
    batch = case["batches"][0]
    ids = jnp.asarray(batch["input_ids"].astype(np.int32))
    if case["kind"] == "gpt":
        jmodel = _jax_gpt(case, None)
        return {"hidden": np.asarray(jax.jit(jmodel.apply)(params,
                                                           ids[:, :-1]))}
    jmodel = _jax_bert(case, None)

    @jax.jit
    def fwd(params, ids, valid):
        seq = jmodel.apply(params, ids, attention_mask=valid)
        return seq, jmodel.pooled(params, seq)
    seq, pooled = fwd(params, ids,
                      jnp.asarray(batch["attention_mask"].astype(np.int32)))
    return {"hidden": np.asarray(seq), "pooled": np.asarray(pooled)}


# -- the checks of the ranks' runs ---------------------------------------

LOSS_RTOL, PARAM_ATOL, FWD_ATOL = 1e-5, 5e-5, 1e-5


def start(tmp_path_factory, spec, axes=AXES):
    """The gloo run of ``torch_tsp_worker.run_tsp_rank`` on ``axes``,
    started now (before the JAX package's side is computed): its join
    function."""
    import torch_ep_worker
    import torch_sp_worker
    import torch_tsp_worker
    tmp = tmp_path_factory.mktemp("tsp")
    return torch_sp_worker.start_ranks(
        tmp_path_factory.mktemp("tsp_run"), torch_tsp_worker.run_tsp_rank,
        (torch_ep_worker.park(tmp / "spec.pkl", dict(spec, axes=axes)),),
        world=int(np.prod(list(axes.values()))))


def jax_side(cases, names):
    """{name: ((the JAX step's metrics, whole parameters), the JAX
    forward)} of the cases ``names``, on AXES: each traced and compiled
    on a thread of its own (XLA compiles outside the GIL, so the
    compiles overlap)."""
    with concurrent.futures.ThreadPoolExecutor(2 * len(names)) as pool:
        steps = {n: pool.submit(jax_steps, cases[n], AXES) for n in names}
        fwds = {n: pool.submit(jax_forward, cases[n]) for n in names}
        return {n: (steps[n].result(), fwds[n].result()) for n in names}


def check_forward(run, side, name):
    """Every rank's forward against the JAX package's: ``apply``'s output
    of its data rank's rows within FWD_ATOL; without a data line (every
    rank holds the whole batch) the loss within LOSS_RTOL of the JAX
    step's first."""
    (jmetrics, _), fwd = side
    whole = all(int(out["coords"][0]) == 0 for out in run)
    for out in run:
        d = int(out["coords"][0])
        for part, want in fwd.items():
            got = out[f"fwd/{name}/{part}"]
            n = got.shape[0]
            np.testing.assert_allclose(got, want[d * n:(d + 1) * n], rtol=0,
                                       atol=FWD_ATOL, err_msg=part)
        if whole:
            np.testing.assert_allclose(out[f"fwd/{name}/loss"],
                                       jmetrics[0]["loss"], rtol=LOSS_RTOL)


def check_jax_steps(run, side, name, arm):
    """Every rank's two steps of ``<arm>/<name>`` against the JAX step:
    the loss and the norm within LOSS_RTOL, the blocks within
    PARAM_ATOL."""
    import expert_cases
    jmetrics, jwhole = side[0]
    for r, out in enumerate(run):
        for i, jm in enumerate(jmetrics):
            for k in ("loss", "grad_norm"):
                np.testing.assert_allclose(
                    float(out[f"{arm}/{name}/step{i}/{k}"]), jm[k],
                    rtol=LOSS_RTOL, err_msg=(k, i, r))
        expert_cases.blocks_close(out, f"{arm}/{name}", jwhole, PARAM_ATOL)


def check_plain_steps(run, name):
    """Every rank's two steps against rank 0's plain step on the whole
    batch: every metric within LOSS_RTOL, the blocks within PARAM_ATOL;
    every rank reports the same loss."""
    import expert_cases
    plain = run[0]
    pre = f"plain/{name}"
    keys = [k.rsplit("/", 1)[1] for k in plain
            if k.startswith(f"{pre}/step0/") and "/launches/" not in k]
    assert "loss" in keys and "grad_norm" in keys
    whole = {k[len(pre) + 3:]: v for k, v in plain.items()
             if k.startswith(pre + "/p/")}
    for out in run:
        for i in range(2):
            for k in keys:
                np.testing.assert_allclose(
                    out[f"tsp/{name}/step{i}/{k}"], plain[f"{pre}/step{i}/{k}"],
                    rtol=LOSS_RTOL, atol=1e-7, err_msg=f"step {i} {k}")
        expert_cases.blocks_close(out, f"tsp/{name}", whole, PARAM_ATOL)
    for i in range(2):
        assert len({float(o[f"tsp/{name}/step{i}/loss"]) for o in run}) == 1


def collectives(kind, layers, remat, data=1):
    """The collectives of one training step over ``layers`` layers on a
    seq line of 2 beside a tensor line (and a data line of ``data``).
    The tensor line's (a GPT's embedding sum, 2 row-parallel sums a layer
    and the cross entropy's 2 forward, 2 column-parallel gradient sums a
    layer and the head's backward; BERT adds the MLM transform's gradient
    sum and its gather); the ring's rotations (one a layer forward, two
    backward: the blocks' one and the accumulators' way home); the seq
    line's loss sum; the norm's sum over the tensor line and the gradient
    mean over the seq line and then the data line.  Remat recomputes a
    layer's forward as far as its backward needs: the rotation and the
    attention output's sum, and BERT's FFN sum, which a LayerNorm reads
    (a GPT block's last sum feeds only the residual add, and the
    recomputation stops before it)."""
    bert = kind == "bert"
    return {"tp_all_reduce": (4 * layers + (5 if bert else 4)
                              + (2 if bert else 1) * layers * remat),
            "tp_all_gather": 2 if bert else 1,
            "ring_p2p": 3 * layers + layers * remat, "ring_all_reduce": 1,
            "stats_all_reduce": 1, "all_reduce": 1 + (data > 1)}


def lines_agree(run, prefix):
    """The blocks under ``prefix`` agree on every rank of a tensor index
    (the replicas: the ranks of its seq and data lines), and a leaf the
    tensor line does not cut on every rank."""
    by_t = {}
    for out in run:
        by_t.setdefault(int(out["coords"][2]), out)
    for out in run:
        ref = by_t[int(out["coords"][2])]
        for k in ref:
            if k.startswith(prefix + "/p/"):
                np.testing.assert_array_equal(out[k], ref[k], err_msg=k)
    for k in by_t[0]:
        box = k.replace("/p/", "/box/")
        if k.startswith(prefix + "/p/") and np.array_equal(by_t[0][box],
                                                           by_t[1][box]):
            np.testing.assert_array_equal(by_t[0][k], by_t[1][k], err_msg=k)


def check_collectives(run, name, case, data=1):
    """Each step's collectives exact, without and with remat (when the
    case runs it), and the replicas' parameters in agreement."""
    layers = case["config"]["num_layers"]
    arms = ("tsp", "remat") if case.get("remat_policy") else ("tsp",)
    for out in run:
        for arm in arms:
            for i in range(2):
                assert tpf_cases.launches(out, f"{arm}/{name}", i) == \
                    collectives(case["kind"], layers, arm == "remat",
                                data), (arm, i)
    lines_agree(run, f"tsp/{name}")
