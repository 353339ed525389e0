"""Local-vs-cloud path portability, the ``clusterone`` helper analogue.

A copy of ``distributed_tensorflow_tpu/utils/paths.py`` (pure host code):
``DTTPU_DATA_ROOT`` and ``DTTPU_LOGS_ROOT`` switch data and log paths to
managed roots (URL-style roots such as ``gs://bucket/x`` keep their
form); otherwise the caller's local fallbacks apply.
"""
from __future__ import annotations

import getpass
import os
from typing import Optional

__all__ = ["get_data_path", "get_logs_path"]


def _join(root: str, *parts: str) -> str:
    """os.path.join that preserves URL-style roots (gs://...)."""
    parts = tuple(p.strip("/") for p in parts if p)
    if "://" in root:
        return "/".join((root.rstrip("/"),) + parts)
    return os.path.join(root, *parts)


def get_data_path(dataset_name: str = "",
                  local_root: Optional[str] = None,
                  local_repo: str = "", path: str = "") -> str:
    """Dataset directory: ``$DTTPU_DATA_ROOT/<dataset>/<path>`` on the
    managed platform, else ``<local_root>/<local_repo>/<path>``.

    Signature parity with ``clusterone.get_data_path`` (reference
    example.py:85-89): ``dataset_name`` is the ``user/dataset`` identifier
    used in cloud mode, ``local_root``/``local_repo`` the local fallback.
    """
    root = os.environ.get("DTTPU_DATA_ROOT")
    if root:
        return _join(root, dataset_name, path)
    local_root = local_root or os.path.join(
        os.path.expanduser("~"), "Documents", "data")
    return os.path.join(local_root, local_repo, path).rstrip(os.sep)


def get_logs_path(root: Optional[str] = None) -> str:
    """Log/checkpoint directory: ``$DTTPU_LOGS_ROOT/<user>/<job>`` on the
    managed platform, else the caller's ``root`` (parity with
    ``clusterone.get_logs_path``, reference example.py:96-99)."""
    env_root = os.environ.get("DTTPU_LOGS_ROOT")
    if env_root:
        user = os.environ.get("USER") or getpass.getuser()
        job = os.environ.get("DTTPU_JOB_NAME", "default")
        return _join(env_root, user, job)
    return root or os.path.join(os.path.expanduser("~"), "Documents",
                                "tpu_logs")
