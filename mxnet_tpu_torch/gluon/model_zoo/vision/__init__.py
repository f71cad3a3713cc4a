"""The vision model zoo with the reference's ``get_model`` registry:
ResNet v1/v2, AlexNet, VGG, MobileNet v1/v2, DenseNet, SqueezeNet and
Inception v3 (the JAX package's 34 constructors)."""
from ....base import MXNetError
from . import (alexnet as _alexnet, densenet as _densenet,
               inception as _inception, mobilenet as _mobilenet,
               resnet as _resnet, squeezenet as _squeezenet, vgg as _vgg)
from .alexnet import *     # noqa: F401,F403
from .densenet import *    # noqa: F401,F403
from .inception import *   # noqa: F401,F403
from .mobilenet import *   # noqa: F401,F403
from .resnet import *      # noqa: F401,F403
from .squeezenet import *  # noqa: F401,F403
from .vgg import *         # noqa: F401,F403

_models = {}
for _mod in (_resnet, _alexnet, _vgg, _mobilenet, _densenet, _squeezenet,
             _inception):
    for _name in _mod.__all__:
        if _name[0].islower() and not _name.startswith("get_"):
            _models[_name] = getattr(_mod, _name)


def get_model(name, **kwargs):
    """The model ``name`` (``"resnet50_v2"``, ``"vgg16_bn"``, ...) built
    with ``kwargs`` (``classes``, ``ctx``; ``pretrained=True`` raises)."""
    name = name.lower()
    if name not in _models:
        raise MXNetError(f"unknown model {name!r}; available: "
                         f"{sorted(_models)}")
    return _models[name](**kwargs)


__all__ = sorted(["get_model", *_models])
