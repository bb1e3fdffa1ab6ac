"""State checkpoint/resume.

Port of ``tpunav/runtime/checkpoint.py``. The reference has NO state
persistence (SURVEY.md §5 — its closest mechanism is the runtime set_pose
reset). For benchmark reproducibility and long-running SLAM sessions, a
state (``EKFState``, ``PFState``, a course state, a sim state) round-trips
through one ``.npz`` of ``leaf_i`` arrays, as in ``tpunav``; its structure
is rebuilt from a matching template on load.

Leaves are taken depth first through NamedTuples, tuples, lists and dicts
(dict keys sorted, ``None`` holding no leaf), the order ``jax.tree`` uses,
so a ``tpunav`` checkpoint of a state with the same fields loads into the
port's template. A tensor is saved as its values; a ``torch.Generator`` as
its ``get_state()`` bytes, restored into a new generator on the template's
generator's device; a Python number as a 0-d array.
"""

from __future__ import annotations

import numpy as np
import torch


def _leaves(tree, out):
    if tree is None:
        return out
    if isinstance(tree, (tuple, list)):
        for sub in tree:
            _leaves(sub, out)
    elif isinstance(tree, dict):
        for key in sorted(tree):
            _leaves(tree[key], out)
    else:
        out.append(tree)
    return out


def _rebuild(template, leaves):
    if template is None:
        return None
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(_rebuild(sub, leaves) for sub in template))
    if isinstance(template, (tuple, list)):
        return type(template)(_rebuild(sub, leaves) for sub in template)
    if isinstance(template, dict):
        rebuilt = {key: _rebuild(template[key], leaves)
                   for key in sorted(template)}
        return {key: rebuilt[key] for key in template}
    return next(leaves)


def _to_array(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Generator):
        return leaf.get_state().numpy()
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _like(arr: np.ndarray, leaf):
    """``arr`` as the template's ``leaf`` is: its type, dtype and device."""
    if isinstance(leaf, torch.Generator):
        gen = torch.Generator(device=leaf.device)
        gen.set_state(torch.from_numpy(np.ascontiguousarray(arr, np.uint8)))
        return gen
    if isinstance(leaf, torch.Tensor):
        return torch.from_numpy(np.array(arr)).to(device=leaf.device,
                                                  dtype=leaf.dtype)
    if isinstance(leaf, (bool, int, float)):
        return type(leaf)(arr.item())
    return np.asarray(arr, dtype=getattr(leaf, "dtype", arr.dtype))


def save_pytree(path: str, tree) -> None:
    arrays = {f"leaf_{i}": _to_array(leaf)
              for i, leaf in enumerate(_leaves(tree, []))}
    np.savez(path, **arrays)


def load_pytree(path: str, template):
    """Load into the structure of ``template`` (same leaf count; each
    leaf's type, dtype and device follow the template's leaf)."""
    with np.load(path) as data:
        leaves = _leaves(template, [])
        if len(leaves) != len(data.files):
            raise ValueError(
                f"checkpoint has {len(data.files)} leaves, template has "
                f"{len(leaves)}")
        new = [_like(data[f"leaf_{i}"], leaf) for i, leaf in enumerate(leaves)]
    return _rebuild(template, iter(new))
