"""Checksums (``summary/crc32c.py``) and TensorBoard event files
(``summary/event_writer.py``) of the port.  The module ``crc32c`` keeps
its name here (its function of that name is ``crc32c.crc32c``)."""
from . import crc32c
from .crc32c import masked_crc32c
from .event_writer import EventFileWriter, SummaryWriter, model_graph_nodes

__all__ = ["crc32c", "masked_crc32c", "EventFileWriter", "SummaryWriter",
           "model_graph_nodes"]
