"""Whole-net forwards of the vision zoo's AlexNet, VGG (with BatchNorm),
MobileNet and SqueezeNet families against the JAX package's, in predict
mode at the smallest input each takes (``whole_net_forward`` of
``tests/test_torch_vision_zoo.py``; tolerance 1e-4 there)."""
import pytest

from tests.test_torch_vision_zoo import whole_net_forward

NETS = [("alexnet", 64), ("vgg11_bn", 32), ("mobilenet0_25", 32),
        ("squeezenet1_1", 32)]


@pytest.mark.parametrize("name,size", NETS, ids=[n for n, _ in NETS])
def test_whole_net_forward_matches_jax(name, size):
    whole_net_forward(name, size)
