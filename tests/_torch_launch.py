"""Helper of the port's multi-process tests: run a worker script as N
ranks through ``mxnet_tpu_torch.tools.launch`` on the CPU (gloo), each
launch bounded by its own timeout after which every rank is killed."""
import os
import pickle
import signal
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the prologue of every worker: the repo on the path, one intra-op
#: thread (the ranks share the tier-1 run's cores), the rank's id and
#: the shared directory
PROLOGUE = """
import os, pickle, sys
sys.path.insert(0, os.environ["MXNET_TEST_ROOT"])
import numpy as np
import torch
torch.set_num_threads(1)
WORK = os.environ["MXNET_TEST_WORKDIR"]
RANK = int(os.environ["DMLC_WORKER_ID"])
with open(os.path.join(WORK, "inputs.pkl"), "rb") as f:
    INPUTS = pickle.load(f)


def save(result):
    with open(os.path.join(WORK, f"rank{RANK}.pkl"), "wb") as f:
        pickle.dump(result, f)
"""


def run_ranks(n: int, body: str, workdir, inputs=None, timeout: float = 100):
    """Run ``PROLOGUE + body`` as ``n`` ranks; returns each rank's
    ``save``d result, in rank order.  Fails with the ranks' output when
    the launch fails or outlives ``timeout`` seconds (every rank is then
    killed with its process group)."""
    workdir = str(workdir)
    with open(os.path.join(workdir, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs or {}, f)
    script = os.path.join(workdir, "worker.py")
    with open(script, "w") as f:
        f.write(PROLOGUE + body)
    env = dict(os.environ, MXNET_TEST_ROOT=ROOT, MXNET_TEST_WORKDIR=workdir,
               OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    # the launcher's file imports only the standard library: run it as a
    # script, so the launch does not pay for importing the package
    launcher = os.path.join(ROOT, "mxnet_tpu_torch", "tools", "launch.py")
    proc = subprocess.Popen(
        [sys.executable, launcher, "-n", str(n), sys.executable, script],
        cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        raise AssertionError(f"{n} ranks outlived {timeout} s:\n"
                             f"{out[-6000:]}")
    assert proc.returncode == 0, f"launch exited {proc.returncode}:\n" \
        f"{out[-6000:]}"
    results = []
    for r in range(n):
        with open(os.path.join(workdir, f"rank{r}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results
