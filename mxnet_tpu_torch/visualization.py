"""Network visualization: ``mx.viz.print_summary`` and
``mx.viz.plot_network``.

Counterpart of ``mxnet_tpu/visualization.py``: ``print_summary`` walks a
``Symbol``'s graph with its inferred shapes and prints MXNet's layer
table (name, output shape, parameters, previous layers);
``plot_network`` returns the graph's Graphviz dot source (rendering it
needs the graphviz binary, which the JAX package does not call either).
"""
from __future__ import annotations

from typing import Dict, Optional

from .base import MXNetError

__all__ = ["print_summary", "plot_network"]


def _node_shapes(sym, shape: Optional[Dict] = None):
    """ONE inference pass over a Symbol whose heads are every op node:
    returns ({name -> output shape}, {arg/aux name -> shape})."""
    if not shape:
        return {}, {}
    from .symbol.symbol import Symbol
    heads, names = [], []
    for node in sym._topo():
        if not node.is_var:
            heads.append((node, 0))
            names.append(node.name)
    big = Symbol(heads) if heads else sym
    try:
        arg_shapes, out_shapes, aux_shapes = big.infer_shape(**shape)
    except MXNetError:
        return {}, {}
    arg_map = dict(zip(big.list_arguments(),
                       (tuple(s) for s in arg_shapes)))
    arg_map.update(zip(big.list_auxiliary_states(),
                       (tuple(s) for s in aux_shapes)))
    shapes = dict(zip(names, (tuple(s) for s in out_shapes)))
    shapes.update(arg_map)
    return shapes, arg_map


def print_summary(symbol, shape: Optional[Dict] = None,
                  line_length: int = 98, positions=(0.44, 0.64, 0.74, 1.0)):
    """Print a Keras-style layer table (reference: mx.viz.print_summary).
    ``shape``: dict of input name -> shape enabling output-shape and
    param counting."""
    shapes, arg_shapes = _node_shapes(symbol, shape)
    positions = [int(line_length * p) for p in positions]
    fields = ["Layer (type)", "Output Shape", "Param #",
              "Previous Layer"]

    def print_row(vals):
        line = ""
        for v, pos in zip(vals, positions):
            line = (line + str(v))[:pos - 1].ljust(pos)
        print(line)

    print("_" * line_length)
    print_row(fields)
    print("=" * line_length)
    total = 0
    import numpy as _np
    data_names = {n for n in symbol.list_inputs()
                  if shape and n in shape}
    for node in symbol._topo():
        if node.is_var:
            if node.name in data_names:
                print_row([f"{node.name} (null)",
                           shapes.get(node.name, ""), 0, ""])
            continue
        n_params = 0
        prevs = []
        for p, _i in node.inputs:
            if p.is_var and p.name not in data_names:
                s = arg_shapes.get(p.name)
                if s:
                    n_params += int(_np.prod(s))
            else:
                prevs.append(p.name)
        total += n_params
        print_row([f"{node.name} ({node.op})",
                   shapes.get(node.name, ""), n_params,
                   ", ".join(prevs[:2])])
    print("=" * line_length)
    print(f"Total params: {total}")
    print("_" * line_length)
    return total


def plot_network(symbol, title: str = "plot", shape: Optional[Dict] = None,
                 node_attrs: Optional[Dict] = None, save_format="dot"):
    """Return Graphviz dot source for the Symbol graph (reference:
    mx.viz.plot_network returns a graphviz.Digraph; no graphviz binary
    in this image, so the dot text itself is the artifact)."""
    shapes, _ = _node_shapes(symbol, shape)
    lines = [f'digraph "{title}" {{',
             "  node [shape=box, style=filled, fillcolor=lightblue];"]
    for node in symbol._topo():
        nid = f"n{id(node)}"
        label = node.name if node.is_var else f"{node.name}\\n{node.op}"
        if node.name in shapes:
            label += f"\\n{shapes[node.name]}"
        color = "lightgray" if node.is_var else "lightblue"
        lines.append(f'  {nid} [label="{label}", fillcolor={color}];')
        for p, _i in node.inputs:
            lines.append(f"  n{id(p)} -> {nid};")
    lines.append("}")
    return "\n".join(lines)
