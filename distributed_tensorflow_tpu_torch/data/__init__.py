"""Input data of the port: synthetic LM corpora (``data/datasets.py``), the
shuffled ``Dataset`` (``data/pipeline.py``) and record framing
(``data/tfrecord.py``)."""
from .datasets import lm_sequences, synthetic_lm_corpus
from .pipeline import Dataset
from .tfrecord import RecordWriter, read_tfrecord, write_framed, \
    write_tfrecord

__all__ = ["Dataset", "RecordWriter", "lm_sequences", "read_tfrecord",
           "synthetic_lm_corpus", "write_framed", "write_tfrecord"]
