"""Fault-tolerant checkpointing: atomic, restart-safe, retention-managed.

The port of the JAX package's ``repro/runtime/checkpoint.py``, with its
guarantees:

* layout ``<dir>/step_<N>/{manifest.json, arrays.npz}``, written in a
  staging dir ``step_<N>.tmp`` and committed with an atomic
  ``os.replace``: a checkpoint is visible iff complete;
* ``restore`` picks the newest complete step; a corrupt or partial
  newest falls back to the one before;
* ``retain`` newest checkpoints are kept, older ones removed.

The leaves (parameters, then the optimizer state) are flattened in the
order of :func:`repro_torch._tree.leaves`; a bfloat16 leaf, which numpy
cannot hold, is stored as its ``uint16`` view with ``bfloat16`` in the
manifest's dtype list.  ``TrainState.rng`` is the state of a
``torch.Generator`` (``get_state()``, a uint8 tensor), the counterpart
of the reference's PRNG key.  ``restore`` puts each leaf on the device
and in the dtype of the example state's leaf.

On a mesh (``env`` and ``specs``, the spec tree of ``{"params",
"opt_state"}``), the leaves are logical: ``save`` gathers each leaf's
pieces (every rank of the mesh calls it), the mesh's first rank writes,
and every rank waits for the commit; ``restore`` reads the logical
leaves and cuts each rank's piece for the *current* env.  So a
checkpoint from data 2 x model 2 resumes on data 1 x model 2, or on one
process (``runtime/elastic.py``).
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Any, Optional

import numpy as np
import torch

from repro_torch._tree import leaves, unflatten
from .meshenv import CPU_ENV, MeshEnv, unshard_tree


@dataclasses.dataclass
class TrainState:
    step: int
    params: Any
    opt_state: Any
    data_cursor: int
    rng: torch.Tensor           # torch.Generator state (uint8)


def _to_numpy(t: torch.Tensor) -> tuple:
    """(array, dtype name) of a leaf; bfloat16 as its uint16 view."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    return t.numpy(), str(t.dtype).replace("torch.", "")


def _from_numpy(a: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:010d}")


def save(ckpt_dir: str, state: TrainState, *, retain: int = 3,
         env: MeshEnv = CPU_ENV, specs=None) -> str:
    """Commit ``state`` as step ``state.step``; on a mesh, its logical
    leaves under ``specs`` (module docstring)."""
    final = _step_dir(ckpt_dir, state.step)
    tree = {"params": state.params, "opt_state": state.opt_state}
    if env.is_spmd:
        tree = unshard_tree(tree, specs, env)
        if not env.is_first:
            env.barrier()                       # the first rank commits
            return final
    _write(ckpt_dir, final, state, leaves(tree), retain)
    env.barrier()
    return final


def _write(ckpt_dir: str, final: str, state: TrainState, flat: list,
           retain: int) -> None:
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    arrays, dtypes = {}, []
    for i, x in enumerate(flat):
        a, dt = _to_numpy(torch.as_tensor(x))
        arrays[f"leaf_{i}"] = a
        dtypes.append(dt)
    arrays["rng"] = state.rng.cpu().numpy()
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    manifest = {
        "step": state.step,
        "data_cursor": state.data_cursor,
        "num_leaves": len(flat),
        "dtypes": dtypes,
        "format": 1,
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    os.replace(tmp, final)                      # atomic commit

    for old in list_steps(ckpt_dir)[:-retain]:
        shutil.rmtree(_step_dir(ckpt_dir, old), ignore_errors=True)


def list_steps(ckpt_dir: str) -> list:
    """The complete steps in ``ckpt_dir`` (those with a manifest),
    ascending."""
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(ckpt_dir, name, "manifest.json")):
                out.append(int(name.split("_")[1]))
    return sorted(out)


def _try_load(path: str, example: TrainState, env: MeshEnv = CPU_ENV,
              specs=None) -> Optional[TrainState]:
    """The checkpoint at ``path`` on ``example``'s devices and dtypes
    (each logical leaf cut to this rank's piece on a mesh), or None if
    it is unreadable or does not fit ``example``."""
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        data = np.load(os.path.join(path, "arrays.npz"))
        tree = {"params": example.params, "opt_state": example.opt_state}
        refs = leaves(tree)
        if manifest["num_leaves"] != len(refs):
            return None
        cuts = leaves(specs) if env.is_spmd else [None] * len(refs)
        out = []
        for i, ref in enumerate(refs):
            t = _from_numpy(data[f"leaf_{i}"], manifest["dtypes"][i])
            if cuts[i] is not None:
                t = env.shard(t, cuts[i]).contiguous()
            ref = torch.as_tensor(ref)
            if tuple(t.shape) != tuple(ref.shape):
                return None
            out.append(t.to(device=ref.device, dtype=ref.dtype))
        restored = unflatten(tree, out)
        return TrainState(step=manifest["step"],
                          params=restored["params"],
                          opt_state=restored["opt_state"],
                          data_cursor=manifest["data_cursor"],
                          rng=torch.from_numpy(np.array(data["rng"])))
    except Exception:
        return None


def restore(ckpt_dir: str, example: TrainState, *, env: MeshEnv = CPU_ENV,
            specs=None) -> Optional[TrainState]:
    """Restore the newest COMPLETE checkpoint, skipping corrupt ones;
    None when there is none.  On a mesh, each logical leaf is cut for
    ``env`` under ``specs`` (the spec tree of ``{"params",
    "opt_state"}``) and must then fit ``example``'s local leaf."""
    for step in reversed(list_steps(ckpt_dir)):
        state = _try_load(_step_dir(ckpt_dir, step), example, env, specs)
        if state is not None:
            return state
    return None
