"""Inception v3's A-E blocks against the JAX package's, forward and input
gradient in training mode (``block_case`` of
``tests/test_torch_vision_zoo.py``; tolerance 1e-4 there).  A file of its
own: their fixed widths (64-448 channels) cost the JAX side ~55 s."""
import pytest

from tests.test_torch_vision_zoo import INCEPTION_BLOCKS, block_case


@pytest.mark.parametrize("name,make,channels,size", INCEPTION_BLOCKS,
                         ids=[b[0] for b in INCEPTION_BLOCKS])
def test_inception_block_matches_jax(name, make, channels, size):
    block_case(make, channels, size)
