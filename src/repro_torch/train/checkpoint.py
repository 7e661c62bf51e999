"""Flat-npz checkpoints with the reference's keys and layout (mirrors
``repro.train.checkpoint``): ``embed/embedding``, ``body/p0/attn/w_q``
(stacked over layers), ... in one ``.npz``, and an optional
``.meta.json`` beside it.  A checkpoint either framework saves loads in
the other: the port saves ``bridge.to_jax_tree(model)`` and rebuilds a
model from ``load`` with ``bridge.from_jax``."""
from __future__ import annotations

import json
import os

import numpy as np


def _flatten(tree):
    flat = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}/{k}" if prefix else str(k), v)
        else:
            flat[prefix] = np.asarray(node)
    walk("", tree)
    return flat


def save(path: str, tree, meta: dict | None = None):
    """``tree``: a nested dict of numpy arrays (``bridge.to_jax_tree``)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **_flatten(tree))
    if meta is not None:
        with open(path + ".meta.json", "w") as f:
            json.dump(meta, f, indent=2)


def load(path: str):
    """The nested dict of numpy arrays rebuilt from the flat keys."""
    nested = {}
    with np.load(path if path.endswith(".npz") else path + ".npz") as data:
        for key in data.files:
            parts = key.split("/")
            node = nested
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = data[key]
    return nested


def load_meta(path: str):
    with open(path + ".meta.json") as f:
        return json.load(f)
