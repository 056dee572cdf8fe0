"""Nested dicts of tensors: the port's params, state, gradient and
updater-state trees (the JAX package's pytrees).

A quantized weight (``ops.quantize.QuantizedTensor``, duck-typed by its
``__quantized_tensor__`` marker) is one leaf pair, as in the JAX package's
pytree: :func:`leaves` yields its ``q`` and ``scale``, the flat view walks
the two in that order, and :func:`tmap` hands it to ``fn`` whole (its
``to(device)`` moves both)."""

from __future__ import annotations


def _quantized(node) -> bool:
    return getattr(node, "__quantized_tensor__", False)


def tmap(fn, *trees):
    """``fn`` over the leaves of nested dicts of one structure (the first
    tree's keys), in the first tree's key order."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tmap(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def leaves(tree):
    """The leaves of a nested dict, in key order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    elif _quantized(tree):
        yield tree.q
        yield tree.scale
    else:
        yield tree


# DL4J's parameter-name order inside a layer, for the flat view (the JAX
# ``nn/model.py`` ``_PARAM_ORDER``: LSTMParamInitializer's W, RW, b; PW the
# peephole tensor; fw/bw a Bidirectional's sub-trees)
_PARAM_ORDER = {"W": 0, "RW": 1, "PW": 2, "b": 3, "gamma": 4, "beta": 5,
                "fw": 6, "bw": 7}


def param_paths(node, prefix=()):
    """Depth-first paths to the leaves of one layer's or vertex's
    parameter dict, in DL4J's name order at each level (a quantized
    weight: its ``q``, then its ``scale``)."""
    if _quantized(node):
        return [prefix + ("q",), prefix + ("scale",)]
    if not isinstance(node, dict):
        return [prefix]
    out = []
    for k in sorted(node, key=lambda n: (_PARAM_ORDER.get(n, 99), n)):
        out.extend(param_paths(node[k], prefix + (k,)))
    return out


def get_path(tree, path):
    for p in path:
        tree = getattr(tree, p) if _quantized(tree) else tree[p]
    return tree


def set_path(tree, path, value):
    """``tree`` with the leaf at ``path`` replaced, the dicts along the
    path copied."""
    if _quantized(tree):
        parts = {"q": tree.q, "scale": tree.scale}
        parts[path[0]] = value
        return type(tree)(parts["q"], parts["scale"], tree.axis)
    new = dict(tree)
    new[path[0]] = value if len(path) == 1 else \
        set_path(tree[path[0]], path[1:], value)
    return new


def ravel(params, keys):
    """``(vector, unravel)``: the parameters of ``keys`` as one tensor on
    their device, in :func:`flatten_params`' order (the vector
    ``params_flat`` gives, without leaving the device), and the function
    that makes a ``vector`` of that layout back into ``params``' trees
    (each leaf a copy; keys absent from ``keys`` kept as they are)."""
    import torch
    paths = [(k, path) for k in keys if k in params
             for path in param_paths(params[k])]
    like = [get_path(params[k], path) for k, path in paths]
    vec = torch.cat([t.reshape(-1) for t in like]) if like else \
        torch.zeros(0)

    def unravel(v):
        new, off = dict(params), 0
        for (k, path), t in zip(paths, like):
            n = t.numel()
            new[k] = set_path(new[k], path,
                              v[off:off + n].reshape(t.shape).clone())
            off += n
        return new
    return vec, unravel


def flatten_params(params, keys):
    """The parameters of ``keys`` (in that order; absent keys skipped) as
    one numpy vector, each tree in ``param_paths`` order: DL4J's flat
    parameter view, the JAX package's ``params_flat``."""
    import numpy as np
    parts = [get_path(params[k], path).detach().cpu().numpy().ravel()
             for k in keys if k in params
             for path in param_paths(params[k])]
    return np.concatenate(parts) if parts else np.zeros((0,), np.float32)


def unflatten_params(params, keys, vec):
    """``params`` with every leaf taken from ``vec`` in
    :func:`flatten_params`' order, each in its leaf's dtype and device."""
    import numpy as np
    import torch
    vec = np.asarray(vec.detach().cpu() if torch.is_tensor(vec) else vec)
    total = sum(int(t.numel()) for t in leaves(params))
    if vec.size != total:
        raise ValueError(f"param vector length {vec.size} != model {total}")
    new, off = dict(params), 0
    for k in keys:
        if k not in params:
            continue
        for path in param_paths(params[k]):
            a = get_path(params[k], path)
            n = int(a.numel())
            new[k] = set_path(new[k], path, torch.as_tensor(
                vec[off:off + n].reshape(tuple(a.shape))).to(
                    device=a.device, dtype=a.dtype))
            off += n
    return new
