"""AMP op cast lists: a copy of the JAX package's ``contrib/amp/lists.py``
(reference: python/mxnet/contrib/amp/lists/symbol_fp16.py).

Three classes, same policy as the reference:
- LP16: compute-bound ops that are safe and fast in low precision — the
  matmul/conv families, which the card's tensor cores run in bf16.  The
  low-precision dtype is bfloat16 by default (fp16 accepted for parity).
- FP32: numerically-sensitive ops forced to fp32 (reductions through exp/
  log, norms, losses).
- WIDEST: multi-input elementwise ops run in the widest input dtype.
Everything else runs in whatever dtype its inputs already have.
"""

LP16_OPS = [
    "FullyConnected", "Convolution", "Deconvolution", "RNN",
    "dot", "batch_dot", "linalg_gemm2",
]

# BatchNorm is deliberately NOT in FP32_OPS: the op computes batch
# statistics in fp32 internally (ops_nn.py batchnorm) while keeping its
# input/output in the activation dtype — casting its INPUT to fp32 (as the
# fp16-era reference list does) forces every conv→BN edge in a ResNet to
# materialize fp32 activations, doubling HBM traffic on the elementwise
# chain.  bf16 activations + fp32 stats is the policy.
FP32_OPS = [
    "LayerNorm", "InstanceNorm", "L2Normalization",
    "softmax", "log_softmax", "softmin", "SoftmaxOutput",
    "exp", "expm1", "log", "log1p", "log2", "log10",
    "sum", "nansum", "prod", "nanprod", "mean", "norm",
    "gamma", "gammaln", "erf", "erfinv",
    "square", "sqrt", "rsqrt", "cbrt", "rcbrt", "reciprocal",
    "smooth_l1", "make_loss", "power", "broadcast_power",
    # round-5 tail: ops whose math runs through exp/log ladders where
    # bf16's 8-bit mantissa visibly degrades (same rationale as softmax)
    "logsumexp", "masked_log_softmax", "masked_softmax",
    "erfc", "erfcinv", "gammainc", "gammaincc", "zeta", "polygamma",
    "bessel_i0", "bessel_i1", "bessel_i0e", "bessel_i1e",
]

# note: LP16 takes precedence over WIDEST in both the hook and
# convert_symbol, so LP16 ops must not be repeated here
WIDEST_TYPE_CASTS = [
    "broadcast_add", "broadcast_sub", "broadcast_mul", "broadcast_div",
    "broadcast_mod", "broadcast_hypot", "broadcast_maximum",
    "broadcast_minimum", "concat", "stack", "where",
]
