"""DenseNet-121's whole forward against the JAX package's, in predict mode
at 32 x 32 (``whole_net_forward`` of ``tests/test_torch_vision_zoo.py``;
tolerance 1e-4 there).  A file of its own: the JAX side takes ~40 s."""
from tests.test_torch_vision_zoo import whole_net_forward


def test_densenet121_forward_matches_jax():
    whole_net_forward("densenet121", 32)
