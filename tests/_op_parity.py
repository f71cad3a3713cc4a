"""Helpers of the registry parity tests: one op through both packages'
``nd`` frontends on the same numpy inputs, and the comparison."""
import numpy as np


def to_numpy(x):
    a = x.asnumpy()
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def run(pkg, name, inputs, kwargs, grad):
    """The outputs of ``pkg.nd.<name>`` (numpy inputs as arrays, any other
    input passed as it is) as numpy arrays and, with
    ``grad``, the gradient of the sum of its outputs (as float32) with
    respect to the first input (``grad`` an int: the input of that
    position; a callable: of what it returns on the outputs)."""
    arrays = [pkg.nd.array(a.copy(), dtype=a.dtype)
              if isinstance(a, np.ndarray) else a for a in inputs]
    if not grad:
        out = getattr(pkg.nd, name)(*arrays, **kwargs)
        outs = out if isinstance(out, (list, tuple)) else [out]
        return [to_numpy(o) for o in outs], None
    wrt = grad if isinstance(grad, int) and not isinstance(grad, bool) \
        else 0
    arrays[wrt].attach_grad()
    with pkg.autograd.record():
        out = getattr(pkg.nd, name)(*arrays, **kwargs)
        outs = out if isinstance(out, (list, tuple)) else [out]
        if callable(grad):
            total = grad(pkg, outs)
        else:
            total = pkg.nd.sum(pkg.nd.cast(outs[0], dtype="float32"))
            for o in outs[1:]:
                total = total + pkg.nd.sum(pkg.nd.cast(o, dtype="float32"))
    total.backward()
    return [to_numpy(o) for o in outs], to_numpy(arrays[wrt].grad)


def assert_match(got, want, tol, exact):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, \
            (g.shape, w.shape, g.dtype, w.dtype)
        if exact:
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, **tol)


def case_ids(cases):
    seen, out = {}, []
    for name, *_ in cases:
        seen[name] = seen.get(name, 0) + 1
        out.append(f"{name}-{seen[name]}")
    return out
