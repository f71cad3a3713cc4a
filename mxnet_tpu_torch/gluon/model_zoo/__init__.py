"""Model zoo: the BERT encoder family, the Transformer NMT, the causal LM
of generation serving, the vision models (``vision``, with
``get_model``) and the detectors of config #5 (SSD, Faster-/Mask-RCNN)."""
from . import rcnn, ssd, transformer, vision
from .rcnn import (FasterRCNN, MaskRCNN, RCNNLoss, faster_rcnn_resnet18_v1,
                   faster_rcnn_toy, mask_rcnn_resnet18_v1, mask_rcnn_toy)
from .ssd import SSD, SSDMultiBoxLoss, ssd_512_resnet50_v1, ssd_toy
from .transformer import (CausalLM, bert_base, bert_small, causal_lm_small,
                          transformer_nmt_base)
from .vision import get_model

__all__ = ["CausalLM", "FasterRCNN", "MaskRCNN", "RCNNLoss", "SSD", "SSDMultiBoxLoss",
           "bert_base", "bert_small", "causal_lm_small",
           "faster_rcnn_resnet18_v1",
           "faster_rcnn_toy", "get_model", "mask_rcnn_resnet18_v1",
           "mask_rcnn_toy",
           "rcnn", "ssd", "ssd_512_resnet50_v1", "ssd_toy", "transformer",
           "transformer_nmt_base", "vision"]
