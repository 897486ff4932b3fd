"""Checkpoint save/restore as one ``.npz`` per step.

The reference has NO checkpointing (SURVEY.md §5: training is
epochs-then-eval in one job); this is basic hygiene for a production
framework: params + optimizer state + step. Each leaf of the
``{"params", "opt_state"}`` pytree is stored under its key path
(``jax.tree_util.keystr``), next to a ``step`` entry; restore rebuilds the
tree from a template with the same structure.
"""

from __future__ import annotations

import os
from typing import Any, Optional, Tuple

import jax
import numpy as np

_STEP_KEY = "step"


def _file(path: str, step: int) -> str:
    return os.path.join(os.path.abspath(path), f"step_{step}.npz")


def save(path: str, params: Any, opt_state: Any, step: int) -> None:
    os.makedirs(path, exist_ok=True)
    leaves = jax.tree_util.tree_flatten_with_path(
        {"params": params, "opt_state": opt_state})[0]
    arrays = {jax.tree_util.keystr(k): np.asarray(v) for k, v in leaves}
    arrays[_STEP_KEY] = np.asarray(step, np.int64)
    final = _file(path, step)
    tmp = final + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, final)   # a crash mid-write never leaves a torn step


def latest_step(path: str) -> Optional[int]:
    if not os.path.isdir(path):
        return None
    steps = [int(d[5:-4]) for d in os.listdir(path)
             if d.startswith("step_") and d.endswith(".npz")
             and d[5:-4].isdigit()]
    return max(steps) if steps else None


def restore(path: str, like: Any, step: Optional[int] = None
            ) -> Optional[Tuple[Any, Any, int]]:
    """Restore (params, opt_state, step); ``like`` is a matching pytree
    template {"params":..., "opt_state":..., "step": 0}. Returns None if no
    checkpoint exists."""
    step = step if step is not None else latest_step(path)
    if step is None:
        return None
    template = {"params": like["params"], "opt_state": like["opt_state"]}
    leaves, treedef = jax.tree_util.tree_flatten_with_path(template)
    with np.load(_file(path, step), allow_pickle=False) as data:
        out = []
        for k, ref in leaves:
            a = data[jax.tree_util.keystr(k)]
            want = np.asarray(ref).dtype
            if a.dtype != want:   # bfloat16 round-trips as raw 2-byte void
                a = a.view(want)
            out.append(a)
        saved_step = int(data[_STEP_KEY])
    tree = jax.tree_util.tree_unflatten(treedef, out)
    return tree["params"], tree["opt_state"], saved_step
