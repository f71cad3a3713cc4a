"""Inception v3's whole forward against the JAX package's, in predict mode
at 299 x 299, the smallest input it takes (its last pool is 8 x 8;
``whole_net_forward`` of ``tests/test_torch_vision_zoo.py``; tolerance
1e-4 there).  A file of its own: the JAX side takes ~45 s."""
from tests.test_torch_vision_zoo import whole_net_forward


def test_inception_v3_forward_matches_jax():
    whole_net_forward("inception_v3", 299)
