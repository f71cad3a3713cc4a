"""``python -m mxnet_tpu_torch.kvstore_server``: MXNet's server-process
entry point (``python/mxnet/kvstore_server.py``), kept so that cluster
scripts written for the parameter-server launcher run unchanged.

Counterpart of ``mxnet_tpu/kvstore_server.py``.  There are no parameter
servers: gradients are summed by synchronous collectives over
``torch.distributed`` (``parallel/dist.py``).  A process launched with
``DMLC_ROLE=server`` or ``=scheduler`` has nothing to serve; it logs that
and exits 0, so that a job tracker sees a clean end.  ``worker`` exits 0
too (the training script joins the group itself); no role exits 1.
"""
from __future__ import annotations

import logging
import os
import sys


def _main() -> int:
    role = os.environ.get("DMLC_ROLE", "")
    logging.basicConfig(level=logging.INFO)
    log = logging.getLogger("kvstore_server")
    if role in ("server", "scheduler"):
        log.info(
            "DMLC_ROLE=%s: this build has no parameter servers — gradient "
            "exchange is synchronous collective allreduce (kvstore "
            "dist_sync over torch.distributed). Exiting cleanly; only "
            "worker processes participate.", role)
        return 0
    if role == "worker":
        log.info("DMLC_ROLE=worker: nothing to do in kvstore_server; "
                 "run your training script directly (it joins the "
                 "process group via mxnet_tpu_torch.parallel.dist).")
        return 0
    log.error("kvstore_server: DMLC_ROLE is not set")
    return 1


if __name__ == "__main__":
    sys.exit(_main())
