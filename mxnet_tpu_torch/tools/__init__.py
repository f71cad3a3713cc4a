"""Command-line tools: ``im2rec`` (``python -m
mxnet_tpu_torch.tools.im2rec``) and ``launch`` (``python -m
mxnet_tpu_torch.tools.launch -n N command...``)."""
