"""Input data of the port: the XOR task (``data/xor.py``, exported as
``xor_data``), synthetic LM corpora (``data/datasets.py``), the shuffled
``Dataset`` and ``prefetch_to_device`` (``data/pipeline.py``) and record
framing (``data/tfrecord.py``)."""
from . import xor
from .datasets import lm_sequences, synthetic_lm_corpus
from .pipeline import Dataset, prefetch_to_device
from .tfrecord import RecordWriter, read_tfrecord, write_framed, \
    write_tfrecord
from .xor import get_data as xor_data

__all__ = ["Dataset", "RecordWriter", "lm_sequences", "prefetch_to_device",
           "read_tfrecord", "synthetic_lm_corpus", "write_framed",
           "write_tfrecord", "xor", "xor_data"]
