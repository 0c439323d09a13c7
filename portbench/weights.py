"""Seeded weights, made on the device in a few large calls.

``draw(leaf_shapes, seed, device, dtype)`` fills one buffer of the served
dtype with every leaf of the model, in the port's parameter layout (paths
such as ``blocks/slot0/mixer/wq`` with the layers stacked in front), and
returns ``{path: view}``.  The program gets the views in its parameter
tree; the reference draws them again from the same seed once the program
is gone, so it takes nothing that the program held.  Leaves are drawn by
their name:

* products: normal with standard deviation ``1/sqrt(fan_in)`` (``fan_in``
  the leaf's second-to-last dim), one ``normal_`` call over all of them;
* the embedding table: normal, standard deviation 1;
* norm weights and Mamba's skip ``d_skip``: ones; the conv bias: zeros;
* Mamba's ``a_log``: ``log(1..N)`` on every channel (Mamba's own init);
* Mamba's ``dt_b``: the inverse softplus of a step size drawn
  log-uniformly in ``[1e-3, 1e-1]`` (Mamba's own init).
"""

from __future__ import annotations

import math

import torch

__all__ = ["draw", "leaf_shapes", "unflatten_tree"]


def leaf_shapes(meta_tree) -> dict:
    """``{path: shape}`` of a tree of objects with a ``shape`` (sorted keys,
    '/'-joined paths)."""
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], f"{path}/{k}" if path else k)
        else:
            out[path] = tuple(t.shape)

    walk(meta_tree, "")
    return out


def _kind(path: str) -> str:
    name = path.rsplit("/", 1)[-1]
    if name == "embedding":
        return "embed"
    if "norm" in name or name == "d_skip":
        return "ones"
    if name == "conv_b":
        return "zeros"
    if name in ("a_log", "dt_b"):
        return name
    return "normal"


def draw(shapes: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """``{path: tensor}`` views of one buffer, drawn from ``seed``."""
    device = torch.device(device)
    paths = sorted(shapes, key=lambda p: (_kind(p) not in ("normal", "embed"), p))
    sizes = {p: math.prod(shapes[p]) for p in paths}
    total = sum(sizes.values())
    buf = torch.empty(total, dtype=dtype, device=device)
    g = torch.Generator(device=device).manual_seed(int(seed) % (2**63))
    out, off = {}, 0
    for p in paths:
        out[p] = buf[off:off + sizes[p]].view(shapes[p])
        off += sizes[p]
    n_random = sum(sizes[p] for p in paths if _kind(p) in ("normal", "embed"))
    buf[:n_random].normal_(generator=g)
    for p in paths:
        t, kind = out[p], _kind(p)
        if kind == "normal":
            t.mul_(1.0 / math.sqrt(shapes[p][-2] if len(shapes[p]) > 1 else 1))
        elif kind == "ones":
            t.fill_(1.0)
        elif kind == "zeros":
            t.zero_()
        elif kind == "a_log":
            n = shapes[p][-1]
            t.copy_(torch.log(torch.arange(1, n + 1, dtype=torch.float32, device=device))
                    .expand(shapes[p]))
        elif kind == "dt_b":
            u = torch.rand(shapes[p], generator=g, device=device, dtype=torch.float32)
            dt = torch.exp(u * (math.log(1e-1) - math.log(1e-3)) + math.log(1e-3))
            t.copy_(dt + torch.log(-torch.expm1(-dt)))  # softplus^-1(dt)
    return out


def unflatten_tree(flat: dict) -> dict:
    """``{"a/b/c": t}`` -> ``{"a": {"b": {"c": t}}}``."""
    tree: dict = {}
    for path, t in flat.items():
        node = tree
        parts = path.split("/")
        for k in parts[:-1]:
            node = node.setdefault(k, {})
        node[parts[-1]] = t
    return tree
