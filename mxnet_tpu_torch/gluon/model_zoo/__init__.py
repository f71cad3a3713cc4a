"""Model zoo: the BERT encoder family and the ResNet v1 family."""
from . import transformer, vision
from .transformer import bert_base, bert_small

__all__ = ["bert_base", "bert_small", "transformer", "vision"]
