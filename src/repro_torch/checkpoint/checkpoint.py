"""Tree checkpoints: npz payload + json manifest, counterpart of
``repro.checkpoint.checkpoint`` with the same files and keys.

Layout: ``<dir>/step_<n>/arrays.npz`` (arrays ``a0, a1, …`` in leaf
order) + ``manifest.json`` (``step``, ``keys`` as ``jax.tree_util.keystr``
writes them, numpy ``dtypes`` and ``shapes``, user ``metadata``).  bf16
leaves are stored as their ``uint16`` bits under the dtype name
``bfloat16``, as the reference stores them, so a checkpoint of a state
written by either package restores into the other's state bitwise where
the two lay the state out alike (every family but the cnn's convolution
weights, which the port keeps OIHW: ``params.py``).  Restoring needs a
template tree of the same structure, and checks keys and shapes.
"""
from __future__ import annotations

import json
import os
import re
from typing import Any

import numpy as np
import torch

from repro_torch.tree import tree_leaves, tree_paths, tree_unflatten


def _to_numpy(t) -> tuple[np.ndarray, str]:
    """A leaf as the array ``np.savez`` stores and its dtype's name."""
    t = torch.as_tensor(t).detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    a = t.numpy()
    return a, a.dtype.name


def save(directory: str, step: int, tree: Any, metadata: dict | None = None) -> str:
    path = os.path.join(directory, f"step_{step:08d}")
    os.makedirs(path, exist_ok=True)
    pairs = [_to_numpy(l) for l in tree_leaves(tree)]
    arrays = [a for a, _ in pairs]
    np.savez(os.path.join(path, "arrays.npz"), **{f"a{i}": a for i, a in enumerate(arrays)})
    manifest = {"step": step, "keys": tree_paths(tree), "dtypes": [d for _, d in pairs],
                "shapes": [list(a.shape) for a in arrays], "metadata": metadata or {}}
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    return path


def load_metadata(directory: str, step: int) -> dict:
    """The user metadata ``save`` stored with this step (the loop counters
    ``coda.fit`` resumes from)."""
    with open(os.path.join(directory, f"step_{step:08d}", "manifest.json")) as f:
        return json.load(f)["metadata"]


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for d in os.listdir(directory)
             if (m := re.match(r"step_(\d+)$", d))]
    return max(steps) if steps else None


def restore(directory: str, step: int, template: Any, *, device=None) -> Any:
    """``template``'s structure filled with the checkpoint's arrays, each
    as a tensor of the template leaf's dtype on its device (or on
    ``device``: a template of ``meta`` tensors gives only shapes and
    dtypes)."""
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    keys, leaves = tree_paths(template), tree_leaves(template)
    if keys != manifest["keys"]:
        raise ValueError(
            f"checkpoint structure mismatch: {set(keys) ^ set(manifest['keys'])}")
    out = []
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for i, (tmpl, shape) in enumerate(zip(leaves, manifest["shapes"])):
            tmpl = torch.as_tensor(tmpl)
            if list(tmpl.shape) != shape:
                raise ValueError(f"shape mismatch at {keys[i]}: {list(tmpl.shape)} vs "
                                 f"checkpointed {shape}")
            arr = data[f"a{i}"]
            if manifest["dtypes"][i] == "bfloat16" and arr.dtype == np.uint16:
                t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(arr)
            out.append(t.to(device=device or tmpl.device, dtype=tmpl.dtype))
    return tree_unflatten(template, out)
