"""``mx.sym.<op>``: Symbol frontends made from the op registry.

Counterpart of ``mxnet_tpu/symbol/register.py`` (:96-157): one frontend
for every op of the ``nd`` registry, with the same positional-parameter
convention (``split_positional_params``), so ``mx.sym.X`` and ``mx.nd.X``
stay in lockstep.  The tensor inputs an op declares and the caller leaves
out become variables named ``{node name}_{input}``
(``mx.sym.FullyConnected(data=d, num_hidden=8, name="fc")`` grows
``fc_weight`` and ``fc_bias``; ``RNN`` its ``parameters`` and states,
``LeakyReLU(act_type="prelu")`` its ``gamma``); the moving statistics
of ``BatchNorm`` and ``BatchNorm_v1`` become auxiliary states.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

from ..base import MXNetError
from .symbol import Symbol, _Node

__all__ = ["apply_op", "num_outputs"]

# tensor inputs of the ops whose missing inputs become variables
_OP_INPUTS: Dict[str, List[str]] = {
    "FullyConnected": ["data", "weight", "bias"],
    "Convolution": ["data", "weight", "bias"],
    "Deconvolution": ["data", "weight", "bias"],
    "BatchNorm": ["data", "gamma", "beta", "moving_mean", "moving_var"],
    "BatchNorm_v1": ["data", "gamma", "beta", "moving_mean",
                     "moving_var"],
    "LayerNorm": ["data", "gamma", "beta"],
    "InstanceNorm": ["data", "gamma", "beta"],
    "Embedding": ["data", "weight"],
    "LeakyReLU": ["data", "gamma"],
    "RNN": ["data", "parameters", "state", "state_cell"],
    "SoftmaxOutput": ["data", "label"],
}
_OP_AUX = {"BatchNorm": ("moving_mean", "moving_var"),
           "BatchNorm_v1": ("moving_mean", "moving_var")}


def _needed_inputs(opname: str, kwargs: Dict[str, Any]) -> List[str]:
    """The declared inputs a node of ``opname`` takes: no bias with
    ``no_bias``, a LeakyReLU's ``gamma`` only for ``prelu``, an RNN's
    ``state_cell`` only for an LSTM (the JAX package's rules)."""
    names = _OP_INPUTS[opname]
    if opname in ("FullyConnected", "Convolution", "Deconvolution") and \
            kwargs.get("no_bias"):
        names = names[:2]
    if opname == "LeakyReLU" and kwargs.get("act_type", "leaky") != "prelu":
        names = names[:1]
    if opname == "RNN" and kwargs.get("mode") != "lstm":
        names = names[:3]
    return names


def num_outputs(opname: str, kwargs: Dict[str, Any], n_inputs: int = 1
                ) -> int:
    """Outputs of one node of ``opname`` with attributes ``kwargs`` (the
    JAX package's rules, ``mxnet_tpu/symbol/register.py:49-90``).
    BatchNorm has one (the port's op updates its moving statistics in
    place; the JAX package's returns them as two more outputs)."""
    if opname in ("split", "SliceChannel"):
        return int(kwargs.get("num_outputs", 1))
    if opname == "split_v2":
        if kwargs.get("sections"):
            return int(kwargs["sections"])
        from ..ndarray.ops_misc import normalize_split_indices
        return len(normalize_split_indices(kwargs.get("indices", ()))) + 1
    if opname == "meshgrid":
        return n_inputs
    if opname in ("_contrib_hawkesll", "linalg_gelqf", "linalg_slogdet",
                  "linalg_syevd"):
        return 2
    if opname == "_sample_multinomial" and kwargs.get("get_prob"):
        return 2
    if opname in ("BatchNorm", "LayerNorm", "GroupNorm") and \
            kwargs.get("output_mean_var"):
        return 3
    if opname == "moments":
        return 2
    if opname == "topk" and kwargs.get("ret_typ") == "both":
        return 2
    if opname == "amp_multicast":
        return int(kwargs.get("num_outputs", n_inputs))
    if opname == "RNN" and kwargs.get("state_outputs"):
        return 3 if kwargs.get("mode", "lstm") == "lstm" else 2
    if opname in ("_foreach", "_while_loop"):
        from ..ndarray.ops_control_flow import names_of
        states = "state_names" if opname == "_foreach" else "loop_names"
        return int(kwargs.get("n_outs", 1)) + len(names_of(kwargs.get(
            states, ())))
    if opname == "_cond":
        return int(kwargs.get("n_outs", 1))
    if opname == "Custom":
        from ..ndarray.ops_custom import _registry as props
        prop = props.get(kwargs.get("op_type"))
        if prop is None:
            return 1
        user = {k: v for k, v in kwargs.items()
                if k not in ("op_type", "_training")
                and not (k.startswith("__") and k.endswith("__"))}
        return len(prop(**user).list_outputs())
    stride = _MULTI_STRIDE.get(opname)
    if stride:
        return (n_inputs - 2) // stride
    return 1


# the multi-tensor updates: inputs a weight (then the rates); their
# registry form returns the new weights
_MULTI_STRIDE = {"multi_sgd_update": 2, "multi_sgd_mom_update": 3,
                 "multi_mp_sgd_mom_update": 4}


def apply_op(opname: str, args: List[Symbol], kwargs: Dict[str, Any],
             name: Optional[str] = None) -> Symbol:
    """One node of ``opname`` over the Symbols ``args`` (and those among
    ``kwargs``), named ``name`` or by the current ``mx.name`` manager
    (``{op}{counter}`` by default), with the current ``mx.AttrScope``'s
    attributes."""
    from .. import attribute, name as _name
    from ..ndarray.register import get_op
    canonical = get_op(opname).name
    tensor_kwargs = {k: v for k, v in kwargs.items()
                     if isinstance(v, Symbol)}
    attrs = attribute.current().get(
        {k: v for k, v in kwargs.items()
         if not isinstance(v, Symbol) and k != "name"})
    node_name = _name.current().get(name or kwargs.get("name"),
                                    canonical.lower().lstrip("_"))
    if canonical in _OP_INPUTS:
        inputs = []
        pos = list(args)
        for in_name in _needed_inputs(canonical, attrs):
            if pos:
                sym = pos.pop(0)
            elif in_name in tensor_kwargs:
                sym = tensor_kwargs.pop(in_name)
            else:
                aux = in_name in _OP_AUX.get(canonical, ())
                sym = Symbol.var(f"{node_name}_{in_name}",
                                 **({"__aux__": True} if aux else {}))
            inputs.append(sym)
    else:
        inputs = list(args) + list(tensor_kwargs.values())
    refs = []
    for s in inputs:
        if not isinstance(s, Symbol):
            raise MXNetError(f"symbol op {opname} got non-symbol input "
                             f"{type(s)}")
        if len(s._heads) != 1:
            raise MXNetError("cannot feed a grouped symbol as one input")
        refs.append(s._heads[0])
    node = _Node(canonical, node_name, attrs, refs,
                 num_outputs(canonical, attrs, len(refs)))
    return Symbol([(node, i) for i in range(node.num_outputs)])


def _make_frontend(opname: str):
    def frontend(*args, **kwargs):
        from ..ndarray.register import get_op, split_positional_params
        name = kwargs.pop("name", None)
        inputs, kwargs = split_positional_params(get_op(opname), args,
                                                 kwargs)
        return apply_op(opname, list(inputs), kwargs, name=name)
    frontend.__name__ = opname
    frontend.__qualname__ = opname
    return frontend


def _attach_frontends(module) -> None:
    from ..ndarray.register import _registry
    for name in list(_registry):
        if not hasattr(module, name):
            setattr(module, name, _make_frontend(name))
