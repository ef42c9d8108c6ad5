"""Weights made from the seed, on the device, in the program's tree
layout as the configuration's family states it (:func:`layout`).

Every leaf is a view of one of two flat buffers (the model's dtype, and
float32 for the routers), each filled by one ``normal_`` call on the
device's generator and then scaled leaf by leaf: projections and tables
Normal(0, 1/fan_in), norm weights 0.1·Normal(0, 1) (the program
multiplies by 1 + w).  The same seed gives the same bits on the same
kind of device, so the reference can make the weights again."""
from __future__ import annotations

import math

import torch

from .data import stream_seed

#: the step index of the weights' generator stream (batches use 0, 1, ...)
WEIGHT_STREAM = 1 << 40


def layout(m: dict) -> list:
    """(path, shape, fan_in or None for a norm, float32?) of every leaf,
    in the order of the flat buffers: the family's own
    (:func:`reference.family`)."""
    from reference import family
    return family(m).layout(m)


def put(tree: dict, path: tuple, value) -> None:
    node = tree
    for key, nxt in zip(path[:-1], path[1:]):
        if isinstance(node, list):
            while len(node) <= key:
                node.append({})
            node = node[key]
            continue
        if key not in node:
            node[key] = [] if isinstance(nxt, int) else {}
        node = node[key]
    node[path[-1]] = value


def get(tree, path: tuple):
    for key in path:
        tree = tree[key]
    return tree


def make_params(m: dict, seed: int, device, dtype=None) -> dict:
    """The weight tree of configuration ``m`` for ``seed`` on
    ``device``, in ``dtype`` (default the configuration's)."""
    device = torch.device(device)
    dt = dtype or getattr(torch, m.get("dtype", "bfloat16"))
    lay = layout(m)
    sizes = [math.prod(shape) for _, shape, _, _ in lay]
    n_model = sum(n for n, (_, _, _, f32) in zip(sizes, lay) if not f32)
    n_f32 = sum(n for n, (_, _, _, f32) in zip(sizes, lay) if f32)
    gen = torch.Generator(device=device).manual_seed(
        stream_seed(seed, WEIGHT_STREAM))
    flat = torch.empty(n_model, dtype=dt, device=device).normal_(
        generator=gen)
    flat32 = torch.empty(n_f32, dtype=torch.float32, device=device)
    if n_f32:
        flat32.normal_(generator=gen)
    tree: dict = {}
    at = {False: 0, True: 0}
    with torch.no_grad():
        for (path, shape, fan_in, f32), n in zip(lay, sizes):
            buf = flat32 if f32 else flat
            leaf = buf[at[f32]:at[f32] + n].view(shape)
            at[f32] += n
            leaf.mul_(0.1 if fan_in is None else 1.0 / math.sqrt(fan_in))
            put(tree, path, leaf)
    return tree


def leaf_paths(m: dict) -> list:
    return [path for path, _, _, _ in layout(m)]
