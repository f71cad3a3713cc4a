"""launch: run N distributed worker processes on this machine.

Counterpart of ``mxnet_tpu/tools/launch.py`` (MXNet's ``tools/launch.py``
with the dmlc local tracker): forks the training command once per worker
with the ``DMLC_*`` environment that ``parallel.dist`` reads, polls every
worker, and propagates the first failure (the other workers are killed,
so a rank that died while its peers wait in a collective ends the job).
There are no parameter servers (synchronous data parallelism), so ``-s``
is accepted and ignored with a note.

Usage:
    python -m mxnet_tpu_torch.tools.launch -n 2 python train.py --args...
"""
from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import time


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(n_workers: int, cmd, env_extra=None) -> int:
    """Run ``cmd`` as ``n_workers`` ranks; the first non-zero exit code
    (0 when every worker succeeded)."""
    port = _free_port()
    procs = []
    for rank in range(n_workers):
        env = dict(os.environ,
                   DMLC_ROLE="worker",
                   DMLC_PS_ROOT_URI="127.0.0.1",
                   DMLC_PS_ROOT_PORT=str(port),
                   DMLC_NUM_WORKER=str(n_workers),
                   DMLC_WORKER_ID=str(rank),
                   **(env_extra or {}))
        procs.append(subprocess.Popen(cmd, env=env))
    # poll every worker: one crashing while its peers block in a
    # collective must end the group, not hang the launcher
    rc = 0
    live = list(procs)
    while live:
        for p in list(live):
            r = p.poll()
            if r is not None:
                live.remove(p)
                rc = rc or r
        if rc:
            for p in live:
                p.kill()
            for p in live:
                p.wait()
            break
        time.sleep(0.1)
    return rc


def main(argv=None):
    ap = argparse.ArgumentParser(prog="launch")
    ap.add_argument("-n", "--num-workers", type=int, required=True)
    ap.add_argument("-s", "--num-servers", type=int, default=0,
                    help="accepted for MXNet's command line; ignored "
                    "(no parameter servers in synchronous data "
                    "parallelism)")
    ap.add_argument("command", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    if args.num_servers:
        print("note: -s ignored — dist_sync is synchronous data "
              "parallelism, no server processes", file=sys.stderr)
    if not args.command:
        ap.error("no command given")
    return launch(args.num_workers, args.command)


if __name__ == "__main__":
    sys.exit(main())
