"""The port imports neither JAX nor the JAX package, and runs on the card
unless told otherwise.

Grep cannot prove the first: the port's own name begins with the JAX
package's.  So every port module is imported in a fresh interpreter whose
meta-path finder refuses the top-level names ``jax`` and
``distributed_tensorflow_tpu``, and also ``transformers``, ``regex`` and
``safetensors``, which the card's machine may lack: the tokenizers and
the HF converters need none of them (``examples.finetune_gpt2_hf``
imports ``transformers`` inside ``main``, for its demo model only).
"""
import os
import pkgutil
import subprocess
import sys
import textwrap

import pytest
import torch

import distributed_tensorflow_tpu_torch as port

torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REFUSED = ("jax", "distributed_tensorflow_tpu", "transformers", "regex",
            "safetensors")


def _port_modules():
    names = [port.__name__]
    for info in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
        names.append(info.name)
    return names


def test_every_port_module_imports_without_jax():
    modules = _port_modules()
    assert len(modules) >= 90
    assert {f"{port.__name__}.{m}" for m in (
        "ops.quant", "models.llama", "ops.kernels.fused", "serve.adapters",
        "fleet.tenancy", "fleet.pagewire", "summary.crc32c",
        "optim.schedules", "optim.ema", "train.precision", "obs.device",
        "train.step", "models.convert", "data.datasets", "data.pipeline",
        "data.tfrecord", "summary.event_writer", "train.checkpoint",
        "train.hooks", "train.session", "ops.layers", "ops.activations",
        "ops.initializers", "ops.losses", "ops.metrics", "data.xor",
        "parallel", "parallel.cluster", "parallel.mesh",
        "parallel.data_parallel", "utils", "utils.flags", "utils.paths",
        "example", "example2", "outline_keras", "outline_tensorflow",
        "_launch", "models.sequential", "models.callbacks",
        "models.saving", "models.zoo", "optim.adafactor",
        "data.augment", "obs", "obs.metrics", "obs.trace", "obs.http",
        "obs.goodput", "obs.reqtrace", "obs.critpath", "resilience",
        "resilience.faults", "resilience.supervisor", "fleet.router",
        "fleet.watchdog", "fleet.workload", "fleet.autoscaler",
        "obs.federate", "ops.attention", "models.bert", "models.vit",
        "models.resnet", "models.seq2seq", "examples",
        "examples.finetune_bert", "examples.train_vit", "ops.moe",
        "examples.serve_gpt", "data.text", "utils.native",
        "examples.finetune_gpt2_hf", "parallel.ring",
        "parallel.ring_flash", "parallel.sharding",
        "train.sharded_checkpoint", "examples.train_gpt",
        "parallel.tensor_parallel", "parallel.pipeline", "fleet.sim",
        "fleet.launcher", "examples.launch_multihost_smoke")} <= set(modules)
    code = textwrap.dedent(f"""
        import importlib, sys
        REFUSED = {_REFUSED!r}
        class Refuse:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in REFUSED:
                    raise ImportError("refused: " + name)
                return None
        sys.meta_path.insert(0, Refuse())
        for name in {modules!r}:
            importlib.import_module(name)
        bad = sorted(m for m in sys.modules if m.split(".")[0] in REFUSED)
        assert not bad, bad
        print("ok", len({modules!r}))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=_REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_entry_points_default_to_the_card():
    """On a host without a card, the defaults raise instead of quietly
    running on the CPU; ``device="cpu"`` is the explicit opt-in."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the defaults would run on it")
    config = port.gpt_tiny()
    with pytest.raises(RuntimeError, match="CUDA"):
        port.GPT(config)
    with pytest.raises(RuntimeError, match="CUDA"):
        port.llama(vocab_size=64)
    model = port.GPT(config, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        port.Engine(model, num_slots=1, max_len=32)
    eng = port.Engine(model, device="cpu", num_slots=1, max_len=32)
    assert eng.device.type == "cpu"


def test_chip_smoke_imports_neither_jax_nor_the_jax_package():
    """Every import statement of ``chip_smoke.py``, at top level or
    inside a phase, names neither JAX nor the JAX package; on a host
    without a card the script fails before it prints a result."""
    import ast
    path = os.path.join(_REPO, "chip_smoke.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    assert "distributed_tensorflow_tpu_torch.obs" in names
    bad = [n for n in names
           if n.split(".")[0] in ("jax", "distributed_tensorflow_tpu")]
    assert not bad, bad
    if torch.cuda.is_available():
        return
    out = subprocess.run([sys.executable, path], cwd=_REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and '"ok"' not in out.stdout
