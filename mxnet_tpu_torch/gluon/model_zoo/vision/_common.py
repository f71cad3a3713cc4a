"""What every constructor of the vision zoo shares."""
from __future__ import annotations

from ....base import MXNetError


def check_layout(layout) -> None:
    if layout != "NCHW":
        raise MXNetError(f"layout {layout!r}: the port's vision models "
                         f"take NCHW only")


def finish(net, pretrained=False, ctx=None):
    """A constructor's last step: ``pretrained`` raises (no weights are
    downloaded; ``load_parameters`` reads a local file), ``ctx``
    initializes the net there."""
    if pretrained:
        raise MXNetError("no pretrained weights available offline; "
                         "load_parameters() from a local file instead")
    if ctx is not None:
        net.initialize(ctx=ctx)
    return net
