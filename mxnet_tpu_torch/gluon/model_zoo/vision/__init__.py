"""Vision models: the ResNet v1 family."""
from .resnet import (BasicBlockV1, BottleneckV1, ResNetV1, get_resnet,
                     resnet18_v1, resnet50_v1)

__all__ = ["BasicBlockV1", "BottleneckV1", "ResNetV1", "get_resnet",
           "resnet18_v1", "resnet50_v1"]
