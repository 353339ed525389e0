"""Host utilities of the port: flags (``utils/flags.py``) and local-vs-cloud
paths (``utils/paths.py``)."""
from . import flags, paths
from .paths import get_data_path, get_logs_path

__all__ = ["flags", "paths", "get_data_path", "get_logs_path"]
