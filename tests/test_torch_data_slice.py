"""The data pipeline as a whole, against the JAX package on the CPU.

- Config #1's MLP (784-128-64-10) trained 5 steps through
  ``gluon.Trainer("sgd", momentum=0.9)``, fed by
  ``DataLoader(vision.MNIST(root).transform_first(ToTensor()),
  shuffle=True, num_workers=2)`` over idx-ubyte files made from a seed,
  in both packages from the same weights (``load_reference_params``) with
  numpy's stream seeded alike: the same batches exactly, losses and
  weights within 1e-5.
- A 2-conv net at 32x32 fed by ``ImageRecordIter`` (the native core,
  random crop and mirror) from a seeded ``.rec``, 2 steps: the same
  batches bit for bit, losses and weights within 1e-5.
- The new modules and ``python -m mxnet_tpu_torch.tools.im2rec`` run
  with ``jax`` and the JAX package unimportable.
"""
import gzip
import os
import struct
import subprocess
import sys

import numpy as np

import mxnet_tpu as mx
import mxnet_tpu_torch as pmx
from mxnet_tpu_torch import autograd, cpu, gluon, load_reference_params
from mxnet_tpu_torch import recordio as prec

TOL = 1e-5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _arrays(net):
    return {k: p.data().asnumpy() for k, p in net.collect_params().items()}


def _np(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else x.detach().numpy()


def _check_params(ref, port):
    for p, q in zip(ref.collect_params().values(),
                    port.collect_params().values()):
        np.testing.assert_allclose(_np(q._tensor()), p.data().asnumpy(),
                                   atol=TOL, rtol=TOL, err_msg=p.name)


def _mnist_files(root, n=64, seed=0):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, n).astype(np.uint8)
    # a class-dependent blob plus noise, so that the steps learn
    yy, xx = np.mgrid[:28, :28]
    imgs = np.stack([np.clip(
        200 * np.exp(-((yy - 4 - 2 * c) ** 2 + (xx - 14) ** 2) / 30.0)
        + rng.normal(0, 20, (28, 28)), 0, 255) for c in labels])
    os.makedirs(root)
    with gzip.open(os.path.join(root, "train-images-idx3-ubyte.gz"),
                   "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, 28, 28) +
                imgs.astype(np.uint8).tobytes())
    with open(os.path.join(root, "train-labels-idx1-ubyte"), "wb") as f:
        f.write(struct.pack(">II", 2049, n) + labels.tobytes())


def _mlp(lib):
    net = lib.gluon.nn.HybridSequential()
    with net.name_scope():
        net.add(lib.gluon.nn.Dense(128, activation="relu", in_units=784),
                lib.gluon.nn.Dense(64, activation="relu", in_units=128),
                lib.gluon.nn.Dense(10, in_units=64))
    return net


def _step(ag, net, trainer, lossfn, x, y):
    """One Trainer step; ``ag`` is the package's autograd module."""
    with ag.record():
        loss = lossfn(net(x), y)
    if ag is autograd:
        ag.backward(loss)
    else:
        loss.backward()
    trainer.step(x.shape[0])
    return _np(loss)


def test_mlp_trains_from_the_mnist_loader_like_jax(tmp_path):
    root = str(tmp_path / "mnist")
    _mnist_files(root)
    ref = _mlp(mx)
    ref.initialize(mx.init.Xavier())
    port = _mlp(pmx)
    load_reference_params(port, _arrays(ref), ctx=cpu())
    opt = {"learning_rate": 0.1, "momentum": 0.9}
    runs = []
    for lib, tlib, net in ((mx, mx.autograd, ref), (pmx, autograd, port)):
        data = lib.gluon.data
        loader = data.DataLoader(
            data.vision.MNIST(root=root).transform_first(
                data.vision.transforms.ToTensor()),
            batch_size=8, shuffle=True, num_workers=2)
        trainer = lib.gluon.Trainer(net.collect_params(), "sgd", opt)
        lossfn = lib.gluon.loss.SoftmaxCrossEntropyLoss()
        np.random.seed(4)
        out = []
        for k, (x, y) in enumerate(loader):
            if k == 5:
                break
            y = y.astype("float32")
            out.append((_np(x), _np(y),
                        _step(tlib, net, trainer, lossfn, x, y)))
        runs.append(out)
    assert len(runs[1]) == 5
    for (rx, ry, rl), (px, py, pl) in zip(*runs):
        np.testing.assert_array_equal(px, rx)
        np.testing.assert_array_equal(py, ry)
        np.testing.assert_allclose(pl, rl, atol=TOL, rtol=TOL)
    assert runs[1][-1][2].mean() < runs[1][0][2].mean()
    _check_params(ref, port)


def _conv_net(lib):
    nn = lib.gluon.nn
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Conv2D(8, 3, padding=1, in_channels=3, activation="relu"),
                nn.MaxPool2D(2),
                nn.Conv2D(16, 3, padding=1, in_channels=8,
                          activation="relu"),
                nn.GlobalAvgPool2D(),
                nn.Dense(10, in_units=16))
    return net


def test_conv_net_trains_from_the_record_iter_like_jax(tmp_path):
    rng = np.random.default_rng(1)
    prefix = str(tmp_path / "r")
    w = prec.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    for i in range(12):
        img = rng.integers(0, 255, (36 + i % 4, 40, 3), dtype=np.uint8)
        w.write_idx(i, prec.pack_img(prec.IRHeader(0, float(i % 10), i, 0),
                                     img, quality=90))
    w.close()
    ref = _conv_net(mx)
    ref.initialize(mx.init.Xavier())
    port = _conv_net(pmx)
    load_reference_params(port, _arrays(ref), ctx=cpu())
    runs = []
    for lib, tlib, net in ((mx, mx.autograd, ref), (pmx, autograd, port)):
        it = lib.io.ImageRecordIter(
            prefix + ".rec", (3, 32, 32), 4, path_imgidx=prefix + ".idx",
            shuffle=True, rand_crop=True, rand_mirror=True, mean_r=120.0,
            mean_g=115.0, mean_b=100.0, std_r=60.0, std_g=60.0, std_b=60.0,
            seed=5, use_native=True)
        trainer = lib.gluon.Trainer(net.collect_params(), "sgd",
                                    {"learning_rate": 0.05})
        lossfn = lib.gluon.loss.SoftmaxCrossEntropyLoss()
        out = []
        for k, b in enumerate(it):
            if k == 2:
                break
            x, y = b.data[0], b.label[0]
            out.append((_np(x), _step(tlib, net, trainer, lossfn, x, y)))
        runs.append(out)
    for (rx, rl), (px, pl) in zip(*runs):
        np.testing.assert_array_equal(px.view(np.uint32), rx.view(np.uint32))
        np.testing.assert_allclose(pl, rl, atol=TOL, rtol=TOL)
    _check_params(ref, port)


def test_pipeline_imports_and_im2rec_runs_without_jax(tmp_path):
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'mxnet_tpu'):\n"
            "    sys.modules[m] = None\n"
            "import mxnet_tpu_torch as mx\n"
            "import mxnet_tpu_torch.recordio, mxnet_tpu_torch.image\n"
            "import mxnet_tpu_torch.io, mxnet_tpu_torch.native\n"
            "import mxnet_tpu_torch.faults, mxnet_tpu_torch.tools.im2rec\n"
            "import mxnet_tpu_torch.ndarray.ops_image\n"
            "import mxnet_tpu_torch.gluon.data.vision.transforms\n"
            "import chip_smoke\n"
            "assert mx.nd.image.to_tensor and mx.gluon.data.DataLoader\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT,
                   env=env, timeout=300)
    root = tmp_path / "imgs"
    from PIL import Image
    for cls in ("a", "b"):
        os.makedirs(root / cls)
        Image.fromarray(np.full((8, 8, 3), 7, np.uint8)).save(
            root / cls / "0.png")
    prefix = str(tmp_path / "out")
    subprocess.run([sys.executable, "-c",
                    "import sys, runpy\n"
                    "for m in ('jax', 'jaxlib', 'mxnet_tpu'):\n"
                    "    sys.modules[m] = None\n"
                    "sys.argv = ['im2rec', sys.argv[1], sys.argv[2]]\n"
                    "runpy.run_module('mxnet_tpu_torch.tools.im2rec',\n"
                    "                 run_name='__main__')\n",
                    prefix, str(root)], check=True, cwd=ROOT, env=env,
                   timeout=300)
    rd = prec.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "r")
    labels = sorted(float(prec.unpack(rd.read_idx(k))[0].label)
                    for k in rd.keys)
    assert labels == [0.0, 1.0]
