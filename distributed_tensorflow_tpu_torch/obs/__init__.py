"""Observability of the port: device-health reductions (``obs/device.py``)."""
from .device import GRAD_NORM_KEY, NONFINITE_KEY, grad_health, tree_bytes

__all__ = ["GRAD_NORM_KEY", "NONFINITE_KEY", "grad_health", "tree_bytes"]
