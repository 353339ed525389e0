"""Full-model persistence for the Sequential tier, in PyTorch.

Counterpart of ``distributed_tensorflow_tpu/models/saving.py``: the same
files, so a directory written by either package loads in the other.
``model.save`` / ``load_model`` / ``model.to_json`` (architecture +
weights + training config in one artifact).  Layout (a directory; the
weights are a checkpoint of the port's ``train/checkpoint.py``, in the
JAX package's format):

    <dir>/model.json     architecture + compile config + input shape
    <dir>/ckpt-*/        {params, model_state} weights checkpoint

Only registry-name configs serialize (a callable activation/initializer
can't round-trip JSON); ``Layer.get_config`` raises a descriptive error
otherwise.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

from ..ops import layers as layer_lib

__all__ = ["model_to_config", "model_from_config", "save_model",
           "load_model", "build_layer", "LAYER_CLASSES"]

# Every serializable layer class, keyed by class name (the Keras
# ``class_name`` convention).
LAYER_CLASSES = {
    cls.__name__: cls
    for cls in (layer_lib.Dense, layer_lib.Dropout, layer_lib.Flatten,
                layer_lib.Activation, layer_lib.Conv2D, layer_lib.MaxPool2D,
                layer_lib.AvgPool2D, layer_lib.GlobalAvgPool,
                layer_lib.BatchNorm, layer_lib.LayerNorm,
                layer_lib.Embedding, layer_lib.LSTM, layer_lib.GRU,
                layer_lib.Conv1D, layer_lib.DepthwiseConv2D,
                layer_lib.SeparableConv2D)
}


def _check_spec(spec: Dict[str, Any]) -> None:
    name = spec["class_name"]
    if name == "Stack":
        for sub in spec["config"]["layers"]:
            _check_spec(sub)
        return
    if name not in LAYER_CLASSES:
        raise ValueError(
            f"{name} is not a registered serializable layer "
            f"(known: {sorted(LAYER_CLASSES)} + Stack)")


def build_layer(spec: Dict[str, Any]):
    """One layer from its {class_name, config} spec; Stack recurses (zoo
    models are Stacks, so they serialize through Sequential too)."""
    name, cfg = spec["class_name"], spec["config"]
    if name == "Stack":
        return layer_lib.Stack([build_layer(s) for s in cfg["layers"]],
                               name=cfg.get("name"))
    return LAYER_CLASSES[name](**cfg)


def model_to_config(model) -> Dict[str, Any]:
    """Sequential -> JSON-able dict (architecture + compile + input shape)."""
    layers = [layer_lib.layer_spec(l) for l in model._layers]
    for spec in layers:
        _check_spec(spec)
    cfg: Dict[str, Any] = {"format": "dttpu-sequential-v1",
                           "name": model.name, "layers": layers}
    if model._compile_config is not None:
        cfg["compile"] = model._compile_config
    if model._in_shape is not None:
        cfg["in_shape"] = list(model._in_shape)
    return cfg


def model_from_config(cfg: Dict[str, Any], device="cuda"):
    """Rebuild a Sequential on ``device`` (uncompiled unless the config
    carries a string-based compile section)."""
    from .sequential import Sequential
    if cfg.get("format") != "dttpu-sequential-v1":
        raise ValueError(f"not a saved Sequential config: "
                         f"format={cfg.get('format')!r}")
    layers = [build_layer(spec) for spec in cfg["layers"]]
    model = Sequential(layers, name=cfg.get("name", "sequential"),
                       device=device)
    compile_cfg = cfg.get("compile")
    if compile_cfg is not None:
        model.compile(**compile_cfg)
    return model


def save_model(model, path: str) -> str:
    """Write architecture + weights under ``path`` (a directory)."""
    if model.state is None:
        raise RuntimeError("model has no state; call fit or build before "
                           "save_model")
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "model.json"), "w") as f:
        json.dump(model_to_config(model), f, indent=1)
    model.save_weights(path)
    return path


def load_model(path: str, compile: bool = True, device="cuda"):
    """Rebuild the model saved at ``path`` on ``device``: architecture
    from model.json, weights from the latest checkpoint under it.

    The saved weights load on EVERY path that recorded an ``in_shape``:
    when the saved compile config is absent (it wasn't JSON-able — mesh or
    callables) or ``compile=False``, a throwaway compile/build initializes
    the param structure, the checkpoint restores into it, and the model is
    handed back uncompiled — the user's own ``compile()`` then keeps the
    weights and re-creates the optimizer state (Keras recompile
    semantics)."""
    with open(os.path.join(path, "model.json")) as f:
        cfg = json.load(f)
    if not compile:
        cfg = dict(cfg)
        cfg.pop("compile", None)
    model = model_from_config(cfg, device=device)
    in_shape: Optional[list] = cfg.get("in_shape")
    if in_shape is None:
        return model
    compiled = model._compiled is not None
    if not compiled:
        model.compile(loss="mse", optimizer="sgd")   # throwaway, see above
    model.build(tuple(in_shape))
    model.load_weights(path)
    if not compiled:
        model._compiled = None
        model._compile_config = None
    return model
