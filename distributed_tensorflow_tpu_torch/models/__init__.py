"""Models of the port: GPT and Llama (``gpt.py``, ``llama.py``),
speculative decoding, the encoder zoo (BERT, ViT, ResNet, seq2seq),
weight conversion (``convert.py``: the JAX package's trees and Hugging
Face checkpoints), and the high-level tier:
``Sequential`` with its callbacks and saving, and the zoo (``xor_mlp``,
``mnist_mlp``, ``cifar_cnn``)."""
from . import bert, callbacks, resnet, saving, seq2seq, vit, zoo
from .bert import Bert, BertConfig, bert_base, bert_tiny
from .convert import (bert_config_from_hf, bert_from_hf,
                      bert_params_from_hf, gpt2_config_from_hf, gpt2_from_hf,
                      gpt2_params_from_hf, llama_config_from_hf,
                      llama_from_hf, llama_params_from_hf, load_hf_dir,
                      vit_config_from_hf, vit_from_hf, vit_params_from_hf)
from .callbacks import (Callback, CSVLogger, EarlyStopping, History,
                        LambdaCallback, LearningRateScheduler,
                        ModelCheckpoint, ReduceLROnPlateau, TensorBoard,
                        TerminateOnNaN)
from .resnet import ResNet, resnet18, resnet50, resnet_cifar
from .saving import load_model, save_model
from .seq2seq import Seq2Seq, Seq2SeqConfig, seq2seq_tiny
from .sequential import Sequential
from .vit import ViT, ViTConfig, vit_base, vit_tiny
from .zoo import cifar_cnn, mnist_mlp, xor_mlp

__all__ = ["bert", "callbacks", "resnet", "saving", "seq2seq", "vit", "zoo",
           "load_model", "save_model",
           "Bert", "BertConfig", "bert_base", "bert_tiny",
           "ViT", "ViTConfig", "vit_base", "vit_tiny",
           "ResNet", "resnet18", "resnet50", "resnet_cifar",
           "Seq2Seq", "Seq2SeqConfig", "seq2seq_tiny",
           "Callback", "CSVLogger", "EarlyStopping", "History",
           "LambdaCallback", "LearningRateScheduler", "ModelCheckpoint",
           "ReduceLROnPlateau", "TerminateOnNaN", "TensorBoard",
           "Sequential", "cifar_cnn", "mnist_mlp", "xor_mlp",
           "bert_config_from_hf", "bert_from_hf", "bert_params_from_hf",
           "gpt2_config_from_hf", "gpt2_from_hf", "gpt2_params_from_hf",
           "llama_config_from_hf", "llama_from_hf", "llama_params_from_hf",
           "load_hf_dir", "vit_config_from_hf", "vit_from_hf",
           "vit_params_from_hf"]
