"""Elastic scaling: resume training state on a DIFFERENT mesh.

The port of the JAX package's ``repro/runtime/elastic.py``.  Checkpoints
hold logical (unsharded) tensors and every rank's piece follows from
the spec trees and the *current* mesh, so elastic rescale is: gather
the logical state under the old env, re-cut it under the new one.  It
works for growing or shrinking the data axis (node loss, capacity
changes); the model axis can change too where the weights' dims divide
the new TP size.

``shrink_mesh`` simulates node failure: a mesh with fewer data rows
over the surviving ranks.
"""
from __future__ import annotations

from .meshenv import MeshEnv, make_env, shard_tree, unshard_tree


def shrink_mesh(mesh, *, drop_data_rows: int = 1):
    """A mesh with ``drop_data_rows`` fewer rows on the data axis, the
    surviving prefix of its rows: the mesh after a (simulated) node
    failure.  Every rank of the world calls it (``DeviceMesh`` builds
    its groups collectively); a dropped rank gets no coordinate."""
    from torch.distributed.device_mesh import DeviceMesh
    names = tuple(mesh.mesh_dim_names)
    if "data" not in names:
        raise ValueError(f"mesh axes {names} have no 'data' axis")
    idx = names.index("data")
    layout = mesh.mesh
    new_rows = layout.shape[idx] - drop_data_rows
    if new_rows < 1:
        raise ValueError("cannot drop all data rows")
    return DeviceMesh(mesh.device_type, layout.narrow(idx, 0, new_rows),
                      mesh_dim_names=names)


def remesh_state(state_tree, spec_fn, old_env: MeshEnv, new_mesh):
    """Re-cut a live state tree for a new mesh.

    ``spec_fn(env)`` returns the spec tree of ``state_tree`` under an env
    (specs can differ between meshes: k/v-head sharding follows the TP
    size, ZeRO-1 the DP size).  Every rank of the old mesh gathers the
    logical tensors; each rank of the new mesh keeps its piece.  Returns
    (new state, new env); the state is None on a rank the new mesh
    dropped."""
    new_env = make_env(new_mesh)
    logical = unshard_tree(state_tree, spec_fn(old_env), old_env)
    if not new_env.member:
        return None, new_env
    return shard_tree(logical, spec_fn(new_env), new_env), new_env


__all__ = ["remesh_state", "shrink_mesh"]
