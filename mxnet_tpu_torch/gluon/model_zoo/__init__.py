"""Model zoo: the BERT encoder family, the Transformer NMT and the ResNet
v1 family."""
from . import transformer, vision
from .transformer import bert_base, bert_small, transformer_nmt_base

__all__ = ["bert_base", "bert_small", "transformer", "transformer_nmt_base",
           "vision"]
