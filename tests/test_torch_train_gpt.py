"""The port's ``examples/train_gpt.py`` entry point on the CPU.

- One process (in-process, ``--device=cpu --steps=8 --batch_size=16``)
  and two gloo ranks (subprocesses forming a group from
  ``COORDINATOR_ADDRESS``/``NUM_PROCESSES``/``PROCESS_ID``: a ``data`` 1
  x ``fsdp`` 2 mesh, ZeRO blocks on each rank), with the JAX test's rule
  for the exit code (``tests/test_example_gpt.py``: 0, or 1 with the
  "did not beat the uniform baseline" warning); the eval and
  ``generated:`` lines print and a complete sharded checkpoint of every
  process is on disk.  The two ranks resume from it at step 8 when run
  again to step 10, and print the same lines.
- ``--family=llama`` runs; ``--pipeline_stages=2`` in one process exits
  naming the device count it does not divide, as the JAX script does.
- ``--pipeline_stages=2`` on two gloo ranks (``{"pipe": 2, "data": 1}``)
  under ``--pp_schedule=gpipe`` and ``=1f1b`` at once, then the GPipe
  run again to step 10, restored from its checkpoint at step 8: the
  exit-code rule, the mesh, eval and ``generated:`` lines equal on both
  ranks, and a complete sharded checkpoint.
- The first batch equals the JAX script's (the same corpus and
  ``Dataset`` from ``--seed``).
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from distributed_tensorflow_tpu import data as jdata
from distributed_tensorflow_tpu.data.datasets import (lm_sequences,
                                                      synthetic_lm_corpus)
from distributed_tensorflow_tpu_torch import data as tdata
from distributed_tensorflow_tpu_torch.examples import train_gpt
from distributed_tensorflow_tpu_torch.train import sharded_checkpoint

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["--device=cpu", "--steps=8", "--batch_size=16"]
WARNING = "did not beat the uniform baseline"


def _ok(rc, err):
    return rc == 0 or (rc == 1 and WARNING in err)


@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_one_process(tmp_path, capsys, family):
    rc = train_gpt.main(ARGS + [f"--log_dir={tmp_path}",
                                f"--family={family}"])
    out, err = capsys.readouterr()
    assert _ok(rc, err), err[-2000:]
    assert "eval loss:" in out and "generated:" in out
    path, = sharded_checkpoint.all_sharded_checkpoints(str(tmp_path))
    assert os.path.basename(path) == "ckpt-0000000008"
    assert sharded_checkpoint.verify_sharded(path) == (True, "")


def test_pipeline_stages_raise(tmp_path):
    with pytest.raises(SystemExit, match="does not divide the device "
                                         "count 1"):
        train_gpt.main(ARGS + ["--pipeline_stages=2",
                               f"--log_dir={tmp_path}"])


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _two_ranks(args, timeout=240):
    """(rc, stdout, stderr) of each of 2 ranks of the entry point."""
    return _wait(_start_two(args), timeout)


def _start_two(args):
    """Two ranks of the entry point, started."""
    port = _free_port()
    procs = []
    for r in range(2):
        env = dict(os.environ, COORDINATOR_ADDRESS=f"localhost:{port}",
                   NUM_PROCESSES="2", PROCESS_ID=str(r), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-m",
             "distributed_tensorflow_tpu_torch.examples.train_gpt"] + args,
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    return procs


def _wait(procs, timeout=240):
    """(rc, stdout, stderr) of each process; a hang kills them."""
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
        return [(p.returncode, out, err)
                for p, (out, err) in zip(procs, outs)]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(5)


def test_two_ranks_train_save_and_resume(tmp_path):
    log_dir = f"--log_dir={tmp_path}"
    for steps, resumed in ((8, None), (10, 8)):
        runs = _two_ranks(["--device=cpu", f"--steps={steps}",
                           "--batch_size=16", log_dir])
        for rc, out, err in runs:
            assert _ok(rc, err), err[-2000:]
            assert "mesh={'data': 1, 'fsdp': 2}" in err
            assert "eval loss:" in out and "generated:" in out
            if resumed is not None:
                assert (f"Restored checkpoint ckpt-{resumed:010d} at step "
                        f"{resumed}") in out
        path = sharded_checkpoint.all_sharded_checkpoints(str(tmp_path))[-1]
        assert os.path.basename(path) == f"ckpt-{steps:010d}"
        with open(os.path.join(path, "manifest.json")) as f:
            assert json.load(f)["process_count"] == 2
        assert sharded_checkpoint.verify_sharded(path) == (True, "")


def test_two_ranks_pipeline_stages(tmp_path):
    base = ["--device=cpu", "--batch_size=16", "--pipeline_stages=2"]
    started = {s: _start_two(base + [f"--log_dir={tmp_path / s}",
                                     "--steps=8", f"--pp_schedule={s}"])
               for s in ("gpipe", "1f1b")}
    done = {s: _wait(p) for s, p in started.items()}
    done["resume"] = _two_ranks(base + [f"--log_dir={tmp_path / 'gpipe'}",
                                        "--steps=10"])
    for name, runs in done.items():
        for rc, out, err in runs:
            assert _ok(rc, err), err[-2000:]
            assert "mesh={'pipe': 2, 'data': 1}" in err
            assert "eval loss:" in out and "generated:" in out
            if name == "resume":
                assert "Restored checkpoint ckpt-0000000008 at step 8" in out
        assert runs[0][1] == runs[1][1]
    for name, steps in (("gpipe", 10), ("1f1b", 8)):
        path = sharded_checkpoint.all_sharded_checkpoints(
            str(tmp_path / name))[-1]
        assert os.path.basename(path) == f"ckpt-{steps:010d}"
        with open(os.path.join(path, "manifest.json")) as f:
            assert json.load(f)["process_count"] == 2
        assert sharded_checkpoint.verify_sharded(path) == (True, "")


def test_first_batch_equals_the_jax_script():
    rows = train_gpt.corpus_rows(64, 0)
    want = lm_sequences(synthetic_lm_corpus(256, 200_000, seed=0, order=1),
                        64)
    np.testing.assert_array_equal(rows, want)
    got, = next(iter(tdata.Dataset([rows], 16, seed=0)))
    jgot, = next(iter(jdata.Dataset([want], 16, seed=0)))
    np.testing.assert_array_equal(got, np.asarray(jgot))
