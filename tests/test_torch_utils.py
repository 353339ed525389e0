"""The port's copies of the JAX package's host utilities, held against it:
``utils.flags`` (the same values from the same definitions, argv and
environment, and the same errors) and ``utils.paths`` (the same paths
with and without the managed roots)."""
import os

import pytest
import torch

from distributed_tensorflow_tpu.utils import flags as jflags
from distributed_tensorflow_tpu.utils import paths as jpaths
from distributed_tensorflow_tpu_torch.utils import flags as tflags
from distributed_tensorflow_tpu_torch.utils import paths as tpaths

torch.set_num_threads(1)

ARGVS = [
    [],
    ["--epochs=7", "--log_dir", "/tmp/x", "--nofast", "extra", "--seed=-2"],
    ["--fast", "--rate=0.25", "--name=a=b", "--unknown=1"],
    ["--fast=false", "--epochs", "3"],
]


def _define(lib):
    fv = lib.FlagValues()
    fv.define("epochs", 50, "", int)
    fv.define("seed", 0, "", int)
    fv.define("log_dir", None, "", str)
    fv.define("name", "x", "", str)
    fv.define("rate", 0.5, "", float)
    fv.define("fast", True, "", lib._parse_bool)
    return fv


@pytest.mark.parametrize("argv", ARGVS, ids=str)
def test_flags_parse_as_jax(argv):
    t, j = _define(tflags), _define(jflags)
    assert t.parse(list(argv)) == j.parse(list(argv))
    for name in ("epochs", "seed", "log_dir", "name", "rate", "fast"):
        assert getattr(t, name) == getattr(j, name)
    t.reset()
    assert t.epochs == 50


def test_flag_errors_and_env_defaults_as_jax(monkeypatch):
    for lib in (tflags, jflags):
        with pytest.raises(ValueError, match="requires a value"):
            _define(lib).parse(["--epochs", "--fast"])
        with pytest.raises(ValueError, match="cannot parse boolean"):
            _define(lib).parse(["--fast=maybe"])
    monkeypatch.setenv("TASK_INDEX", "3")
    monkeypatch.setenv("BAD_INT", "three")
    for var, default, cast in (("TASK_INDEX", 0, int), ("BAD_INT", 5, int),
                               ("MISSING_VAR", "d", str)):
        assert tflags.env_default(var, default, cast) == \
            jflags.env_default(var, default, cast)
    assert tflags.env_default("TASK_INDEX", 0, int) == 3


@pytest.mark.parametrize("roots", [{}, {"DTTPU_DATA_ROOT": "gs://b/data",
                                        "DTTPU_LOGS_ROOT": "gs://b/logs",
                                        "USER": "u", "DTTPU_JOB_NAME": "j"},
                                   {"DTTPU_DATA_ROOT": "/mnt/data",
                                    "DTTPU_LOGS_ROOT": "/mnt/logs",
                                    "USER": "u"}], ids=["local", "url", "dir"])
def test_paths_equal_jax(monkeypatch, roots):
    for var in ("DTTPU_DATA_ROOT", "DTTPU_LOGS_ROOT", "DTTPU_JOB_NAME"):
        monkeypatch.delenv(var, raising=False)
    for var, val in roots.items():
        monkeypatch.setenv(var, val)
    for args in (("xor",), ("xor", os.path.join("logs", "data"), "xor"),
                 ("user/ds", "/r", "repo", "sub/")):
        assert tpaths.get_data_path(*args) == jpaths.get_data_path(*args)
    for root in (None, os.path.join("logs", "xor")):
        assert tpaths.get_logs_path(root) == jpaths.get_logs_path(root)
