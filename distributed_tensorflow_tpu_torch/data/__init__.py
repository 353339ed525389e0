"""Input data of the port: the XOR task (``data/xor.py``, exported as
``xor_data``), the MNIST / CIFAR-10 loaders with their synthetic
stand-ins and synthetic LM corpora (``data/datasets.py``), image
augmentation (``data/augment.py``), the shuffled ``Dataset`` and
``prefetch_to_device`` (``data/pipeline.py``), record framing and
``tfrecord_batches`` (``data/tfrecord.py``), and the tokenizers
(``data/text.py``)."""
from . import augment, xor
from .datasets import (cifar10, lm_sequences, mnist, provenance,
                       synthetic_image_classes, synthetic_lm_corpus)
from .pipeline import Dataset, prefetch_to_device
from .text import BPETokenizer, ByteTokenizer, GPT2BPETokenizer
from .tfrecord import (RecordWriter, read_tfrecord, tfrecord_batches,
                       write_framed, write_tfrecord)
from .xor import get_data as xor_data

__all__ = ["BPETokenizer", "ByteTokenizer", "Dataset", "GPT2BPETokenizer",
           "RecordWriter", "augment", "cifar10", "lm_sequences", "mnist",
           "prefetch_to_device", "provenance", "read_tfrecord",
           "synthetic_image_classes", "synthetic_lm_corpus",
           "tfrecord_batches", "write_framed", "write_tfrecord", "xor",
           "xor_data"]
