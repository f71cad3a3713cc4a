"""mxnet_tpu_torch: the PyTorch/CUDA port of ``mxnet_tpu``.

Mirrors the JAX package's layout and names.  It serves BERT-base through
``serving.ModelServer``, with attention in a hand-written Hopper
flash-attention kernel (``kernels/csrc/flash_attention.cu``), and trains
through ``autograd.record`` -> ``autograd.backward`` ->
``gluon.Trainer.step`` (ResNet-50 v1, the MNIST MLP), with the
multi-tensor SGD update in hand-written kernels
(``kernels/csrc/multi_sgd.cu``) and Adam in plain torch.  Users add
operators of their own: ``operator.CustomOp``/``CustomOpProp`` run
through ``mx.nd.Custom`` inside autograd, ``autograd.Function`` is a
differentiable function, and ``rtc.CudaModule`` compiles CUDA source
strings at run time with NVRTC (the counterpart of the JAX package's
Pallas ``rtc``).  ``metric.Accuracy`` scores the training.  BERT-base
pretrains through ``gluon.Trainer("adam")`` with the flash kernel's
forward and a chunked torch backward, in fp32 or under
``contrib.amp.init("bfloat16")``, whose casts each listed op makes
itself.  The imperative surface is MXNet's: ``nd.NDArray`` over a
``torch.Tensor``, the ``mx.nd.<op>`` frontends of the op registry (on
``NDArray``s or tensors), autograd on arrays (``attach_grad``,
``backward``), ``mx.random`` and the engine's waits (``mx.engine``,
``nd.waitall``); Gluon blocks, losses and metrics take ``NDArray``s.  It
imports ``torch`` and never ``jax`` or ``mxnet_tpu``.  Config #4 runs
both ways: the Transformer NMT trains through ``gluon.Trainer`` and
``translate``s with the flash kernel in its encoder and cross-attention,
and the Symbol API (``mx.sym``, ``Executor``) drives ``mx.mod.Module`` /
``BucketingModule.fit`` over ``mx.rnn`` cells and ``BucketSentenceIter``
with the metrics, callbacks, checkpoints and the one-process kvstore.
The training surface around ``gluon.Trainer`` is MXNet's: every optimizer
of the JAX package with its update ops, ``mx.lr_scheduler``,
``Block.save_parameters``/``load_parameters`` and
``Trainer.save_states``/``load_states`` in files either package loads,
the metrics, initializers and ``gluon.utils``.
The data pipeline is MXNet's: ``mx.recordio`` and ``tools.im2rec``,
``mx.io.ImageRecordIter`` over the native io core (``native/io_core.cc``,
host C++), ``mx.image`` and ``mx.nd.image``, the CSV/LibSVM/MNIST
iterators, and ``gluon.data`` with its datasets, samplers, vision
transforms and a ``DataLoader`` whose device stage copies pinned batches
on a side CUDA stream.
Observability and tuning are the JAX package's: the metrics registry with
Prometheus and JSONL export, causal tracing with W3C ``traceparent``,
the flight recorder, the stack sampler, the progress watchdog,
``mx.profiler`` (op events, spans and ``torch.profiler``'s device trace
on one timeline) and the ``tuning`` controllers.
Data-parallel training across processes is the JAX package's:
``python -m mxnet_tpu_torch.tools.launch -n N python train.py`` starts the
ranks, the ``dist_*`` kvstores (with 2-bit compression) carry
``gluon.Trainer``'s gradients over ``torch.distributed``, and
``parallel.ShardedTrainer`` runs ZeRO, accumulation, communication
buckets and BatchNorm over the global batch.
Entry points run on ``gpu(0)`` unless the caller passes ``ctx=cpu()`` or
opens a ``with mx.cpu():`` scope.
"""
from . import attribute, autograd, base, callback, context, contrib, \
    engine, faults, gluon, image, initializer, io, kernels, kvstore, \
    lr_scheduler, metric, model, module, monitor, name, ndarray, \
    observability, operator, optimizer, parallel, profiler, random, \
    recordio, rnn, rtc, runtime, serving, symbol, test_utils, tuning, \
    visualization
from .attribute import AttrScope
from .base import MXNetError, get_env, list_env, register_env
from .context import Context, cpu, cpu_pinned, current_context, gpu, \
    num_gpus
from .convert import load_reference_params
from .monitor import Monitor

nd = ndarray
init = initializer
sym = symbol
mod = module
kv = kvstore
viz = visualization


def waitall() -> None:
    """Block until every op queued on every device has run
    (``mx.nd.waitall``)."""
    engine.wait_all()


__all__ = ["AttrScope", "Context", "MXNetError", "Monitor", "attribute",
           "autograd", "base", "callback",
           "context", "contrib", "cpu", "cpu_pinned", "current_context",
           "engine", "faults", "get_env", "gpu", "gluon", "image", "init",
           "initializer", "io", "kernels", "kv", "kvstore", "list_env",
           "load_reference_params", "lr_scheduler",
           "metric", "mod", "model", "module", "monitor", "name", "nd",
           "ndarray", "num_gpus",
           "observability", "operator", "optimizer", "parallel", "profiler",
           "random",
           "recordio", "register_env", "rnn", "rtc", "runtime", "serving",
           "sym", "symbol", "test_utils", "tuning", "visualization", "viz",
           "waitall"]

# opt-in exporters and sampler, as the JAX package starts them at import:
# a Prometheus /metrics endpoint when MXTPU_METRICS_PORT is set, a JSONL
# snapshot writer when MXTPU_METRICS_JSONL is set, the stack sampler when
# MXTPU_PROF_SAMPLE_HZ > 0 (the servers' constructors probe it again)
if base.get_env("MXTPU_METRICS_PORT") or \
        base.get_env("MXTPU_METRICS_JSONL"):
    observability.export.maybe_start_from_env()
if base.get_env("MXTPU_PROF_SAMPLE_HZ"):
    observability.sampler.maybe_start_from_env()
