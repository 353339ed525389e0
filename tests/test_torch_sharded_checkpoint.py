"""The port's sharded checkpoints (``train/sharded_checkpoint.py``) and
``TrainSession(sharded_checkpoint=True)``, held against the JAX package.

- **Both ways, onto other layouts, bit-equal.** A checkpoint the port
  writes from 2 gloo ranks (``fsdp`` 2, a ZeRO state of GPT tiny under
  ``with_ema(adamw)`` after one step) restores in the JAX package's
  ``restore_sharded`` onto ``shard_train_state``'s placement on a
  ``{"data": 4, "fsdp": 2}`` mesh of 8 devices; the JAX package's
  ``save_sharded`` of such a state (after one JAX step) restores into the
  port's 2 ranks; the port's 2-rank checkpoint restores on 4 ranks
  (``fsdp`` 4), whose checkpoint restores into one process's plain state.
  Every leaf is compared whole, to the bit.
- **The JAX package's cases** (``tests/test_sharded_checkpoint.py``),
  with the processes of a save played by virtual ranks of one process:
  round trip and reshard, a replicated leaf written once, an incomplete
  checkpoint not listed, a missing chunk detected, structural
  completeness, a clear error on an incomplete restore, pruning of old
  torn saves, the older embedded chunk index, structure and shape
  mismatches, bf16 through its bits, and a corrupt chunk caught by its
  CRC and quarantined by the verified walk.
- **The session** saves and resumes at the saved step, sync and async;
  a corrupt newest checkpoint is quarantined and the one before it
  restored.
"""
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_tensorflow_tpu import optim as joptim
from distributed_tensorflow_tpu import train as jtrain
from distributed_tensorflow_tpu.models.gpt import gpt_tiny as jgpt_tiny
from distributed_tensorflow_tpu.parallel import mesh as jmesh
from distributed_tensorflow_tpu.train import sharded_checkpoint as jsc
from distributed_tensorflow_tpu_torch import (TrainState, gpt_params_from_jax,
                                              gpt_tiny, optim, parallel,
                                              train)
from distributed_tensorflow_tpu_torch.parallel import sharding
from distributed_tensorflow_tpu_torch.train import sharded_checkpoint as sc

import torch_sp_worker
import torch_zero_worker

torch.set_num_threads(1)


def _spec():
    jmodel = jgpt_tiny(dropout_rate=0.0)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    state = {k: v.numpy() for k, v in gpt_params_from_jax(
        jax.tree.map(np.asarray, jparams), gpt_tiny(dropout_rate=0.0)
    ).items()}
    rng = np.random.default_rng(4)
    return jmodel, jparams, state, [rng.integers(0, 512, (8, 17)).astype(
        np.int64)]


def _jax_state(jmodel, jparams):
    jm = jmesh.make_mesh({"data": 4, "fsdp": 2})
    opt = joptim.with_ema(joptim.adamw(1e-3), 0.99)
    return jtrain.shard_train_state(
        jtrain.TrainState.create(jparams, opt.init(jparams)), jm,
        jmodel.partition_rules(fsdp=True)), opt


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(jax.device_get(tree))[0]}


def _leaves(out, prefix):
    return {k[len(prefix) + 1:]: v for k, v in out.items()
            if k.startswith(prefix + "/")}


def _equal(got, want):
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        np.testing.assert_array_equal(got[path], w, err_msg=path)


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    """The JAX package's checkpoint of its state after one step, and 2
    port ranks that train one step and save, then restore the JAX
    checkpoint: (dirs, JAX leaves, rank results)."""
    base = tmp_path_factory.mktemp("xckpt")
    dirs = {k: str(base / k) for k in ("jax", "port2", "port4")}
    jmodel, jparams, state, batches = _spec()
    jstate, opt = _jax_state(jmodel, jparams)
    step = jtrain.make_custom_train_step(jmodel.lm_loss_fn(), opt,
                                         grad_clip_norm=1.0)
    jstate, _ = step(jstate, {"input_ids": jnp.asarray(batches[0])})
    jsc.save_sharded(dirs["jax"], 1, jstate)
    outs = torch_sp_worker.spawn_ranks(
        base, torch_zero_worker.run_ckpt_rank,
        ({"axes": {"fsdp": 2}, "state": state, "batches": batches,
          "jobs": [("train", dirs["port2"]),
                   ("restore", dirs["jax"], "fromjax", None)]},),
        world=2)
    return dirs, _flat(jstate), outs


@pytest.fixture(scope="module")
def four(two, tmp_path_factory):
    """4 port ranks (``fsdp`` 4) restore the 2-rank checkpoint and save
    it again."""
    dirs = two[0]
    _, _, state, batches = _spec()
    return torch_sp_worker.spawn_ranks(
        tmp_path_factory.mktemp("four"), torch_zero_worker.run_ckpt_rank,
        ({"axes": {"fsdp": 4}, "state": state, "batches": batches,
          "jobs": [("restore", dirs["port2"], "from2", dirs["port4"])]},),
        world=4)


def test_port_checkpoint_restores_in_jax(two):
    dirs, _, outs = two
    jmodel, jparams, _, _ = _spec()
    target, _ = _jax_state(jmodel, jparams)
    path = jsc.all_sharded_checkpoints(dirs["port2"])[-1]
    assert jsc.verify_sharded(path) == (True, "")
    restored = jsc.restore_sharded(target, path)
    assert int(restored.step) == 1
    # the JAX target keeps its data 4 x fsdp 2 placement
    w_in = restored.params["decoder"]["ffn"]["w_in"]["kernel"]
    assert "fsdp" in str(w_in.sharding.spec)
    _equal(_flat(restored), _leaves(outs[0], "train"))


def test_jax_checkpoint_restores_in_the_port(two):
    _, jflat, outs = two
    for out in outs:
        _equal(_leaves(out, "fromjax"), jflat)


def test_reshard_two_to_four_to_one(two, four):
    dirs, _, outs = two
    want = _leaves(outs[0], "train")
    for out in four:
        _equal(_leaves(out, "from2"), want)
    _, _, state, _ = _spec()
    model = torch_zero_worker._model(state)
    params = dict(model.named_parameters())
    opt = torch_zero_worker._optimizer()
    plain = TrainState.create(params, opt.init(params))
    path = sc.all_sharded_checkpoints(dirs["port4"])[-1]
    with open(os.path.join(path, "manifest.json")) as f:
        assert json.load(f)["process_count"] == 4
    restored = sc.restore_sharded(plain, path)
    assert restored.step == 1
    assert all(restored.params[k] is p for k, p in params.items())
    got = {}
    torch_zero_worker.dump_state(got, "one", restored)
    _equal(_leaves(got, "one"), want)


# -- the JAX package's cases, on virtual ranks ----------------------------

def _virtual(n, r):
    return parallel.Mesh(n, r, None, axes={"fsdp": n}, lines={})


def _tree(n, r, kernel=None, bias=None, step=7, spec=("fsdp", None),
          dtype=torch.float32):
    """Rank r of n's part of ``{"params": {"kernel" [64, 16] cut by
    ``spec``, "bias" [16] whole}, "step"}`` (the JAX test's state)."""
    if kernel is None:
        kernel = torch.arange(64 * 16, dtype=torch.float32).reshape(64, 16)
    if bias is None:
        bias = torch.arange(16, dtype=torch.float32)
    mesh = _virtual(n, r)
    leaves = {"kernel": kernel.to(dtype), "bias": bias.to(dtype)}
    layout = {"kernel": sharding.zero_shard((64, 16), spec, mesh),
              "bias": None}
    return {"params": sharding.ShardedDict(
        {k: v if layout[k] is None else layout[k].take(v)
         for k, v in leaves.items()},
        layout, mesh), "step": np.int64(step)}


def _zeros(n, r, **kw):
    return _tree(n, r, torch.zeros(64, 16), torch.zeros(16), step=0, **kw)


def _save_all(d, at, n, **kw):
    """Every virtual rank of n saves its part at step ``at``."""
    path = None
    for r in range(n):
        path = sc.save_sharded(str(d), at, _tree(n, r, **kw),
                               process_index=r, process_count=n)
    return path


def _joined(n, parts):
    return torch.cat([p["params"]["kernel"] for p in parts], 0)


@pytest.mark.parametrize("n_save,n_load", [(2, 2), (2, 4), (4, 1)])
def test_roundtrip_and_reshard(tmp_path, n_save, n_load):
    path = _save_all(tmp_path, 7, n_save)
    assert sc.is_sharded_checkpoint(path)
    assert sc.verify_sharded(path) == (True, "")
    parts = [sc.restore_sharded(_zeros(n_load, r), path)
             for r in range(n_load)]
    want = torch.arange(64 * 16, dtype=torch.float32).reshape(64, 16)
    assert torch.equal(_joined(n_load, parts), want)
    for p in parts:
        assert torch.equal(p["params"]["bias"], torch.arange(16.0))
        assert int(p["step"]) == 7
        assert isinstance(p["params"], sharding.ShardedDict)


def test_replicated_leaves_written_once(tmp_path):
    path = _save_all(tmp_path, 3, 2)
    with open(os.path.join(path, "manifest.json")) as f:
        paths = [m["path"] for m in json.load(f)["leaves"]]
    rows = []
    for p in range(2):
        with open(os.path.join(path, f"chunks-{p:05d}.json")) as f:
            rows += json.load(f)
    bias = paths.index("['params']['bias']")
    kernel = paths.index("['params']['kernel']")
    assert [c["pid"] for c in rows if c["leaf"] == bias] == [0]
    assert sorted(c["pid"] for c in rows if c["leaf"] == kernel) == [0, 1]


def test_incomplete_checkpoint_not_listed(tmp_path):
    path = _save_all(tmp_path, 5, 2)
    os.unlink(os.path.join(path, "manifest.json"))     # the chief crashed
    assert sc.all_sharded_checkpoints(str(tmp_path)) == []
    assert not sc.is_sharded_checkpoint(path)


def test_missing_chunk_detected(tmp_path):
    path = _save_all(tmp_path, 4, 2)
    with open(os.path.join(path, "manifest.json")) as f:
        bias = [m["path"] for m in json.load(f)["leaves"]].index(
            "['params']['bias']")
    cpath = os.path.join(path, "chunks-00000.json")
    with open(cpath) as f:
        rows = json.load(f)
    with open(cpath, "w") as f:
        json.dump([c for c in rows if c["leaf"] != bias], f)
    with pytest.raises(ValueError, match="cover"):
        sc.restore_sharded(_zeros(2, 0), path)
    ok, reason = sc.verify_sharded(path)
    assert not ok and "cover" in reason


def test_structural_completeness_gates_listing(tmp_path):
    path = sc.save_sharded(str(tmp_path), 9, _tree(2, 0), process_index=0,
                           process_count=2)
    assert sc.is_sharded_checkpoint(path)
    assert not sc.is_complete_sharded_checkpoint(path)
    assert sc.all_sharded_checkpoints(str(tmp_path)) == []
    sc.save_sharded(str(tmp_path), 9, _tree(2, 1), process_index=1,
                    process_count=2)
    assert sc.is_complete_sharded_checkpoint(path)
    assert sc.all_sharded_checkpoints(str(tmp_path)) == [path]


def test_restore_incomplete_raises_clearly(tmp_path):
    path = sc.save_sharded(str(tmp_path), 13, _tree(2, 0), process_index=0,
                           process_count=2)
    with pytest.raises(ValueError, match="INCOMPLETE"):
        sc.restore_sharded(_zeros(2, 0), path)


def test_prune_removes_old_incomplete_dirs(tmp_path):
    torn_old = sc.save_sharded(str(tmp_path), 1, _tree(2, 0),
                               process_index=0, process_count=2,
                               max_to_keep=2)
    for s in (2, 3, 4):
        sc.save_sharded(str(tmp_path), s, _tree(1, 0), max_to_keep=2)
    torn_new = sc.save_sharded(str(tmp_path), 5, _tree(2, 0),
                               process_index=0, process_count=2,
                               max_to_keep=2)
    kept = sc.all_sharded_checkpoints(str(tmp_path))
    assert [os.path.basename(p) for p in kept] == ["ckpt-0000000003",
                                                   "ckpt-0000000004"]
    assert not os.path.exists(torn_old)
    assert os.path.exists(torn_new)


def test_legacy_embedded_chunk_manifest_restores(tmp_path):
    path = _save_all(tmp_path, 11, 1)
    mpath = os.path.join(path, "manifest.json")
    with open(mpath) as f:
        manifest = json.load(f)
    with open(os.path.join(path, "chunks-00000.json")) as f:
        manifest["chunks"] = json.load(f)
    with open(mpath, "w") as f:
        json.dump(manifest, f)
    os.unlink(os.path.join(path, "chunks-00000.json"))
    assert sc.is_complete_sharded_checkpoint(path)
    out = sc.restore_sharded(_zeros(1, 0), path)
    assert torch.equal(out["params"]["kernel"],
                       torch.arange(64 * 16.0).reshape(64, 16))


def test_structure_and_shape_mismatch(tmp_path):
    path = _save_all(tmp_path, 6, 1)
    bad = {"params": {"kernel": torch.zeros(32, 16),
                      "bias": torch.zeros(16)}, "step": np.int64(0)}
    with pytest.raises(ValueError, match="shape"):
        sc.restore_sharded(bad, path)
    with pytest.raises(ValueError, match="leaves"):
        sc.restore_sharded({"params": {"kernel": torch.zeros(64, 16)}},
                           path)


def test_bfloat16_roundtrip_and_reshard(tmp_path):
    path = _save_all(tmp_path, 0, 2, dtype=torch.bfloat16)
    with open(os.path.join(path, "manifest.json")) as f:
        assert {m["dtype"] for m in json.load(f)["leaves"]} >= {"bfloat16"}
    parts = [sc.restore_sharded(_zeros(4, r, dtype=torch.bfloat16), path)
             for r in range(4)]
    got = _joined(4, parts)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, torch.arange(64 * 16.0).reshape(64, 16).to(
        torch.bfloat16))


def test_corrupt_chunk_is_quarantined(tmp_path):
    _save_all(tmp_path, 1, 2)
    bad = _save_all(tmp_path, 2, 2, step=8)
    shard = os.path.join(bad, "shards-00001.npz")
    z = dict(np.load(shard))
    key = next(iter(z))
    z[key] = z[key] + 1
    np.savez(shard, **z)
    ok, reason = sc.verify_sharded(bad)
    assert not ok and "CRC" in reason
    out, path = sc.restore_latest_good_sharded(_zeros(2, 0), str(tmp_path))
    assert os.path.basename(path) == "ckpt-0000000001"
    assert int(out["step"]) == 7
    assert os.path.exists(os.path.join(str(tmp_path),
                                       "corrupt-ckpt-0000000002"))


# -- the session ----------------------------------------------------------

def _session_setup():
    _, _, state, batches = _spec()
    model = torch_zero_worker._model(state)
    mesh = parallel.make_mesh({"data": 1, "fsdp": 1})
    zstate = torch_zero_worker._zero_state(model, mesh)
    step = train.make_custom_train_step(
        model.lm_loss_fn(), torch_zero_worker._optimizer(), mesh=mesh,
        grad_clip_norm=1.0)
    return model, zstate, step, {"input_ids": torch.from_numpy(batches[0])}


@pytest.mark.parametrize("async_checkpoint", [False, True])
def test_session_saves_and_resumes(tmp_path, async_checkpoint):
    d = str(tmp_path)
    model, state, step, batch = _session_setup()
    with train.TrainSession(state, step, checkpoint_dir=d,
                            sharded_checkpoint=True,
                            async_checkpoint=async_checkpoint,
                            hooks=[train.CheckpointHook(every_steps=2)]
                            ) as sess:
        for _ in range(3):
            sess.run_step(batch)
        final = {k: p.detach().clone() for k, p in model.named_parameters()}
        shadow = optim.ema_params(sess.state.opt_state)
    assert [os.path.basename(p) for p in sc.all_sharded_checkpoints(d)] \
        == ["ckpt-0000000002", "ckpt-0000000003"]
    model2, state2, step2, _ = _session_setup()
    with train.TrainSession(state2, step2, checkpoint_dir=d,
                            sharded_checkpoint=True) as s2:
        assert s2.step == 3
        for k, p in model2.named_parameters():
            assert torch.equal(p.detach(), final[k]), k
        again = optim.ema_params(s2.state.opt_state)
        for k in shadow:
            assert torch.equal(again[k], shadow[k]), k
        assert isinstance(s2.state.params, sharding.ShardedDict)
        s2.run_step(batch)
        assert s2.step == 4


def test_session_quarantines_a_corrupt_newest(tmp_path):
    d = str(tmp_path)
    model, state, step, batch = _session_setup()
    with train.TrainSession(state, step, checkpoint_dir=d,
                            sharded_checkpoint=True,
                            hooks=[train.CheckpointHook(every_steps=1)]
                            ) as sess:
        sess.run_step(batch)
        at_one = {k: p.detach().clone() for k, p in model.named_parameters()}
        sess.run_step(batch)
    newest = sc.all_sharded_checkpoints(d)[-1]
    with open(os.path.join(newest, "chunks-00000.json")) as f:
        rows = json.load(f)
    rows[0]["crc32c"] ^= 1
    with open(os.path.join(newest, "chunks-00000.json"), "w") as f:
        json.dump(rows, f)
    model2, state2, step2, _ = _session_setup()
    with train.TrainSession(state2, step2, checkpoint_dir=d,
                            sharded_checkpoint=True) as s2:
        assert s2.step == 1
        for k, p in model2.named_parameters():
            assert torch.equal(p.detach(), at_one[k]), k
    assert os.path.exists(os.path.join(d, "corrupt-ckpt-0000000002"))
