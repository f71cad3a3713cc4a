"""Command-line tools: ``im2rec`` (``python -m
mxnet_tpu_torch.tools.im2rec``)."""
