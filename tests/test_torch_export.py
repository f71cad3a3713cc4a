"""MXNet's export seam in the port, held against the JAX package on the
CPU: a ``HybridBlock`` called on a ``Symbol`` (every layer with a symbolic
body, and the graph of each of the 34 vision constructors),
``HybridBlock.export``, ``SymbolBlock.imports``,
``ModelServer.from_exported`` and ``model.load_checkpoint`` + ``Module``
over exported files (``mxnet_tpu/gluon/block.py:324-329``, :666-681,
:749-782; ``mxnet_tpu/serving/server.py:222-231``).

A seeded net (config #1's MLP, a two-convolution CNN with BatchNorm, and
``resnet18_v1`` and ``mobilenet_v2_0_25`` at 32 x 32 with 10 classes; a
DenseNet layer and an Inception E block for the other bodies) is exported
by each package and imported by the other: the same arguments, outputs
and parameter keys (less the instance prefix, which comes from each
package's name counters), and outputs within 1e-5 of the exporting
package's own Gluon forward (fp32, predict mode).  The JAX side of each
net is built once per module.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu.gluon.model_zoo import vision as jax_vision
from mxnet_tpu_torch import autograd, cpu, load_reference_params, nd
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import SymbolBlock
from mxnet_tpu_torch.gluon.model_zoo import vision
from mxnet_tpu_torch.gluon.model_zoo.vision import densenet, inception
from mxnet_tpu_torch.serving import ModelServer

TOL = dict(rtol=1e-5, atol=1e-5)
NETS = ["mlp", "cnn", "resnet18_v1", "mobilenet_v2_0_25", "dense_layer",
        "inception_e"]
SHAPES = {"mlp": (4, 784), "cnn": (2, 3, 12, 12), "dense_layer": (2, 8, 6, 6),
          "inception_e": (2, 16, 4, 4)}


def _make(lib, name):
    """``name`` in ``lib`` (``mx`` or ``mt``), with no widths given."""
    nn = lib.gluon.nn
    if name == "mlp":
        net = nn.HybridSequential()
        with net.name_scope():
            net.add(nn.Dense(128, activation="relu"),
                    nn.Dense(64, activation="relu"), nn.Dense(10))
        return net
    if name == "cnn":
        net = nn.HybridSequential()
        with net.name_scope():
            net.add(nn.Conv2D(8, 3, padding=1), nn.BatchNorm(),
                    nn.Activation("relu"), nn.Conv2D(16, 3, strides=2),
                    nn.MaxPool2D(2), nn.Flatten(), nn.Dense(10))
        return net
    if name == "dense_layer":
        mod = jax_vision.densenet if lib is mx else densenet
        return mod._DenseLayer(8, 2, 0.0)
    if name == "inception_e":
        mod = jax_vision.inception if lib is mx else inception
        return mod._InceptionE()
    return (jax_vision if lib is mx else vision).get_model(name, classes=10)


def _strip(names, prefix):
    return [n[len(prefix):] if n.startswith(prefix) else n for n in names]


class _Pair:
    """One net in both packages (the port's with the JAX weights), its
    forwards, and each package's export of it."""

    def __init__(self, name, tmp):
        shape = SHAPES.get(name, (2, 3, 32, 32))
        self.x = np.random.default_rng(5).standard_normal(shape) \
            .astype(np.float32)
        self.ref = _make(mx, name)
        self.ref.initialize(mx.init.Xavier())
        self.jax_out = self.ref(mx.nd.array(self.x.copy())).asnumpy()
        self.port = _make(mt, name)
        load_reference_params(self.port, {
            k: p.data().asnumpy()
            for k, p in self.ref.collect_params().items()}, ctx=cpu())
        with torch.no_grad(), autograd.predict_mode():
            self.port_out = self.port(torch.from_numpy(self.x)).numpy()
        self.jax_files = self.ref.export(str(tmp / f"jax_{name}"))
        self.port_files = self.port.export(str(tmp / f"port_{name}"))


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    made = {}

    def get(name):
        if name not in made:
            made[name] = _Pair(name, tmp_path_factory.mktemp(name))
        return made[name]
    return get


@pytest.mark.parametrize("name", NETS)
def test_exported_files_agree_across_packages(pair, name):
    """Either package's file loads in the other with the same arguments
    and outputs; both packages export the same arguments, in the same
    order, and the same parameter keys."""
    p = pair(name)
    np.testing.assert_allclose(p.port_out, p.jax_out, **TOL)
    for sym_file, _ in (p.jax_files, p.port_files):
        ours, theirs = mt.sym.load(sym_file), mx.sym.load(sym_file)
        assert ours.list_arguments() == theirs.list_arguments()
        assert ours.list_outputs() == theirs.list_outputs()
    jax_sym, port_sym = (mt.sym.load(f) for f, _ in (p.jax_files,
                                                     p.port_files))
    assert _strip(port_sym.list_arguments(), p.port.prefix) == \
        _strip(jax_sym.list_arguments(), p.ref.prefix)
    assert len(port_sym.list_outputs()) == len(jax_sym.list_outputs()) == 1
    port_keys = sorted(mt.nd.load(p.port_files[1], ctx=cpu()))
    jax_keys = sorted(mx.nd.load(p.jax_files[1]))
    assert all(k.startswith("arg:") for k in port_keys + jax_keys)
    assert _strip([k[4:] for k in port_keys], p.port.prefix) == \
        _strip([k[4:] for k in jax_keys], p.ref.prefix)
    assert len(port_keys) == len(p.port.collect_params())


@pytest.mark.parametrize("name", NETS)
def test_port_imports_the_jax_export(pair, name):
    p = pair(name)
    with mt.cpu():
        net = SymbolBlock.imports(*p.jax_files[:1], "data", p.jax_files[1])
        out = net(nd.array(p.x)).asnumpy()
    np.testing.assert_allclose(out, p.jax_out, **TOL)


@pytest.mark.parametrize("name", NETS)
def test_jax_imports_the_port_export(pair, name):
    p = pair(name)
    net = mx.gluon.SymbolBlock.imports(p.port_files[0], "data",
                                       p.port_files[1])
    out = net(mx.nd.array(p.x.copy())).asnumpy()
    np.testing.assert_allclose(out, p.port_out, **TOL)


@pytest.mark.parametrize("name", ["cnn", "resnet18_v1"])
def test_checkpoint_module_runs_the_export(pair, name):
    """``load_checkpoint`` + ``Module`` bound for inference on the files of
    either package, as the JAX package runs it (``set_params(...,
    allow_extra=True)``, ``forward(is_train=False)``)."""
    p = pair(name)
    for prefix, want in ((p.jax_files[0], p.jax_out),
                         (p.port_files[0], p.port_out)):
        prefix = prefix[:-len("-symbol.json")]
        sym, arg, aux = mt.model.load_checkpoint(prefix, 0, ctx=cpu())
        assert not aux and len(arg) == len(p.port.collect_params())
        mod = mt.mod.Module(sym, data_names=["data"], label_names=None,
                            context=cpu())
        mod.bind(data_shapes=[("data", p.x.shape)], for_training=False)
        mod.set_params(arg, aux, allow_extra=True)
        mod.forward(mt.io.DataBatch([nd.array(p.x, ctx=cpu())]),
                    is_train=False)
        np.testing.assert_allclose(mod.get_outputs()[0].asnumpy(), want,
                                   **TOL)


def test_model_server_serves_exported_files(pair, tmp_path):
    """(test_serving.py:424-440) ``ModelServer.from_exported`` on the port's
    export of a small MLP, and on the JAX package's export of config #1's
    MLP, answers as the exporting package's forward."""
    net = mt.gluon.nn.HybridSequential()
    with net.name_scope():
        net.add(mt.gluon.nn.Dense(16, activation="relu", in_units=6),
                mt.gluon.nn.Dense(3, in_units=16))
    net.initialize(ctx=cpu(), seed=0)
    sym_f, par_f = net.export(str(tmp_path / "m"))
    rng = np.random.default_rng(6)
    xs = [rng.standard_normal((6,)).astype(np.float32) for _ in range(5)]
    p = pair("mlp")
    for files, samples, refs in (
            ((sym_f, par_f), xs,
             [net(nd.array(x[None], ctx=cpu())).asnumpy()[0] for x in xs]),
            (p.jax_files, list(p.x), list(p.jax_out))):
        srv = ModelServer.from_exported(files[0], "data", files[1],
                                        ctx=cpu(), max_batch=4,
                                        deadline_ms=0)
        assert isinstance(srv._block, SymbolBlock)
        try:
            srv.start()
            outs = [srv.infer(x, timeout=60) for x in samples]
        finally:
            srv.stop()
        for o, r in zip(outs, refs):
            np.testing.assert_allclose(o, r, **TOL)


def test_server_takes_any_block_as_the_jax_server_does():
    """A ``Block`` that is not hybrid is served as the JAX server serves
    it (there through ``_freeze_generic``); what is not a Block is
    refused."""
    net = mt.gluon.nn.Sequential()
    net.add(mt.gluon.nn.Dense(3, in_units=4))
    net.initialize(ctx=cpu(), seed=1)
    x = np.ones(4, np.float32)
    srv = ModelServer(net, max_batch=2, deadline_ms=0)
    try:
        srv.start()
        out = srv.infer(x, timeout=60)
    finally:
        srv.stop()
    np.testing.assert_allclose(
        out, net(nd.array(x[None], ctx=cpu())).asnumpy()[0], **TOL)
    with pytest.raises(MXNetError, match="gluon Block"):
        ModelServer(lambda v: v)


def test_symbol_block_holds_parameters_without_gradients(tmp_path):
    net = mt.gluon.nn.Dense(3, in_units=4)
    net.initialize(ctx=cpu(), seed=2)
    files = net.export(str(tmp_path / "d"), epoch=7)
    assert files[1].endswith("-0007.params")
    with mt.cpu():
        sb = SymbolBlock.imports(files[0], ["data"], files[1])
    assert sorted(sb.collect_params()) == sorted(net.collect_params())
    assert all(p.grad_req == "null" for p in sb.collect_params().values())
    x = np.arange(8, dtype=np.float32).reshape(2, 4)
    with mt.cpu():
        want = net(nd.array(x)).asnumpy()
        sb.hybridize()
        np.testing.assert_array_equal(sb(nd.array(x)).asnumpy(), want)
    with pytest.raises(MXNetError, match="no symbolic body"):
        sb(mt.sym.var("data"))
    bare = SymbolBlock(mt.sym.load(files[0]), mt.sym.var("data"))
    with pytest.raises(MXNetError, match="missing from feed"):
        bare(torch.from_numpy(x))


def test_block_without_symbolic_body_names_itself():
    class OnlyForward(mt.gluon.HybridBlock):
        def forward(self, x):
            return x * 2

    with pytest.raises(MXNetError, match="OnlyForward has no symbolic"):
        OnlyForward()(mt.sym.var("data"))
    seq = mt.gluon.nn.HybridSequential()
    seq.add(mt.gluon.nn.Dense(2, in_units=3), OnlyForward())
    with pytest.raises(MXNetError, match="OnlyForward"):
        seq(mt.sym.var("data"))


def _layer(lib, kind):
    nn = lib.gluon.nn
    return {
        "dense_flat": lambda: nn.Dense(5, activation="tanh"),
        "dense_noflat_nobias": lambda: nn.Dense(5, use_bias=False,
                                                flatten=False),
        "activation": lambda: nn.Activation("softrelu"),
        "leaky": lambda: nn.LeakyReLU(0.1),
        "prelu": lambda: nn.PReLU(),
        "elu": lambda: nn.ELU(0.7),
        "selu": lambda: nn.SELU(),
        "gelu": lambda: nn.GELU(),
        "swish": lambda: nn.Swish(1.5),
        "flatten": lambda: nn.Flatten(),
        "dropout": lambda: nn.Dropout(0.3),
        "batchnorm": lambda: nn.BatchNorm(momentum=0.8, epsilon=1e-3),
        "batchnorm_noscale": lambda: nn.BatchNorm(scale=False),
        "instancenorm": lambda: nn.InstanceNorm(),
        "layernorm": lambda: nn.LayerNorm(axis=1),
        "groupnorm": lambda: nn.GroupNorm(2),
        "reflectionpad": lambda: nn.ReflectionPad2D((1, 2, 0, 1)),
        "identity": lambda: nn.Identity(),
        "conv2d": lambda: nn.Conv2D(3, (3, 2), strides=(2, 1),
                                    padding=(1, 0), dilation=(1, 2),
                                    activation="relu"),
        "conv2d_groups": lambda: nn.Conv2D(4, 1, groups=2, use_bias=False),
        "conv2d_transpose": lambda: nn.Conv2DTranspose(3, 3, strides=2,
                                                       padding=1,
                                                       output_padding=1),
        "maxpool": lambda: nn.MaxPool2D(3, 2, 1),
        "maxpool_ceil": lambda: nn.MaxPool2D(3, 2, ceil_mode=True),
        "avgpool": lambda: nn.AvgPool2D(3, 1, 1, count_include_pad=False),
        "global_avg": lambda: nn.GlobalAvgPool2D(),
        "global_max": lambda: nn.GlobalMaxPool2D(),
    }[kind]()


LAYERS = ["dense_flat", "dense_noflat_nobias", "activation", "leaky", "prelu",
          "elu", "selu", "gelu", "swish", "flatten", "dropout", "batchnorm",
          "batchnorm_noscale", "instancenorm", "layernorm", "groupnorm",
          "reflectionpad", "identity", "conv2d", "conv2d_groups",
          "conv2d_transpose", "maxpool", "maxpool_ceil", "avgpool",
          "global_avg", "global_max"]


@pytest.mark.parametrize("kind", LAYERS)
def test_layer_symbolic_body_is_the_jax_one(kind, tmp_path):
    """Each layer's graph on ``data`` (4, 4, 6, 6) has the JAX layer's
    arguments and op attributes: the port's export runs in the JAX
    package as the port's eager forward, and its graph in the port."""
    x = np.random.default_rng(7).standard_normal((4, 4, 6, 6)) \
        .astype(np.float32)
    ref = _layer(mx, kind)
    ref.initialize(mx.init.Xavier())
    ref(mx.nd.array(x.copy()))
    port = _layer(mt, kind)
    load_reference_params(port, {k: p.data().asnumpy() + 0.25 for k, p in
                                 ref.collect_params().items()}, ctx=cpu())
    with torch.no_grad(), autograd.predict_mode():
        want = port(torch.from_numpy(x)).numpy()
    files = port.export(str(tmp_path / kind))
    theirs = mx.gluon.SymbolBlock.imports(files[0], "data", files[1])
    np.testing.assert_allclose(theirs(mx.nd.array(x.copy())).asnumpy(), want,
                               **TOL)
    with mt.cpu():
        ours = SymbolBlock.imports(files[0], "data", files[1])
        np.testing.assert_allclose(ours(nd.array(x)).asnumpy(), want, **TOL)
    jax_args = _strip(ref(mx.sym.var("data")).list_arguments(), ref.prefix)
    assert _strip(mt.sym.load(files[0]).list_arguments(), port.prefix) == \
        jax_args


@pytest.mark.parametrize("name", sorted(jax_vision._models))
def test_every_vision_constructor_builds_the_jax_graph(name):
    """``get_model(name)`` on ``mx.sym.var("data")``: the JAX package's
    arguments in its order, and the graph's shapes at the model's input
    size (a deferred width, 0 in a variable's shape, left to the layer
    rules)."""
    ref = jax_vision.get_model(name, classes=10)
    port = vision.get_model(name, classes=10)
    theirs = ref(mx.sym.var("data"))
    ours = port(mt.sym.var("data"))
    assert isinstance(ours, mt.sym.Symbol) and len(ours.list_outputs()) == 1
    assert _strip(ours.list_arguments(), port.prefix) == \
        _strip(theirs.list_arguments(), ref.prefix)
    size = 299 if name.startswith("inception") else 224
    args, outs, aux = ours.infer_shape(data=(1, 3, size, size))
    assert outs == [(1, 10)] and not aux
    named = dict(zip(ours.list_arguments(), args))
    for k, p in port.collect_params().items():
        assert all(a in (0, b) for a, b in zip(p.shape, named[k])), k
