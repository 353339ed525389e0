"""Host utilities of the port: flags (``utils/flags.py``), local-vs-cloud
paths (``utils/paths.py``) and the host C++ routines of the data path
(``utils/native.py``)."""
from . import flags, native, paths
from .paths import get_data_path, get_logs_path

__all__ = ["flags", "native", "paths", "get_data_path", "get_logs_path"]
