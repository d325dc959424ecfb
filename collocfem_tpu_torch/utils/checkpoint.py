"""Checkpoint and resume of solver state.

Counterpart of ``collocfem_tpu/utils/checkpoint.py``: a pytree of tensors
(``Decision``, ``BatchDecision``, ``Multipliers``, ``SolveStats``, ...) is
saved as a flat ``.npz`` archive, one ``leaf_i`` array per leaf in
flattening order (a NamedTuple's field order) and its structure as a JSON
string under ``__treedef__``, the JAX package's layout.  A solution can
warm-start a refined mesh through :func:`warm_start_on_mesh`.
"""

from __future__ import annotations

import json

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from collocfem_tpu_torch.ops.mesh import interpolate_trajectory

_STRUCTURE = "__treedef__"


def save_pytree(path: str, tree) -> None:
    """Save a pytree of tensors as an .npz with a structure key."""
    leaves, spec = tree_flatten(tree)
    arrays = {f"leaf_{i}": leaf.detach().cpu().numpy()
              for i, leaf in enumerate(leaves)}
    arrays[_STRUCTURE] = np.frombuffer(json.dumps(str(spec)).encode(),
                                       dtype=np.uint8)
    np.savez(path, **arrays)


def load_pytree(path: str, like):
    """Load an .npz checkpoint into the structure of pytree ``like``.

    Raises ``ValueError`` unless the stored structure, leaf count and leaf
    shapes are ``like``'s.  Each leaf comes back on ``like``'s leaf's device,
    in its dtype.
    """
    with np.load(path) as data:
        n = sum(1 for k in data.files if k.startswith("leaf_"))
        leaves = [data[f"leaf_{i}"] for i in range(n)]
        stored = json.loads(bytes(data[_STRUCTURE]).decode())
    like_leaves, spec = tree_flatten(like)
    if stored != str(spec):
        raise ValueError(f"checkpoint structure mismatch:\n  stored: "
                         f"{stored}\n  expected: {spec}")
    if len(leaves) != len(like_leaves):
        raise ValueError("checkpoint leaf count mismatch")
    for i, (leaf, ref) in enumerate(zip(leaves, like_leaves)):
        if tuple(leaf.shape) != tuple(ref.shape):
            raise ValueError(f"checkpoint leaf {i} has shape {leaf.shape}, "
                             f"expected {tuple(ref.shape)}")
    return tree_unflatten([torch.as_tensor(leaf, dtype=ref.dtype,
                                           device=ref.device)
                           for leaf, ref in zip(leaves, like_leaves)], spec)


def warm_start_on_mesh(old_mesh, new_mesh, V_old):
    """Node values of ``new_mesh`` from ``V_old`` on ``old_mesh``: the old
    collocation polynomial evaluated at the new mesh's node times (mesh
    refinement)."""
    return interpolate_trajectory(old_mesh, V_old, new_mesh.node_times)
