"""Carries configuration and course state across from ``tpunav``, as numpy.

No counterpart in ``tpunav``. The MPPI path has no weights: its
parameters are the configurations (``MPPIConfig``, ``CartParams``,
``MotorParams``, ``CourseConfig``) and its state is ``CourseState``. Nothing
here imports jax: the caller hands over plain dicts and numpy arrays.
"""

from __future__ import annotations

import dataclasses
import typing
from typing import Any, Dict

import numpy as np
import torch

from .control.waypoint_loop import CourseState

_STATE_DTYPES = {"pose": torch.float32, "u": torch.float32,
                 "wpt_idx": torch.int32, "visits": torch.int32,
                 "ticks": torch.int32, "done": torch.bool,
                 "wheel_vel": torch.float32}


def config_from_fields(cls, fields: Dict[str, Any]):
    """Build one of the port's configurations from the fields of its
    ``tpunav`` twin: ``dataclasses.asdict(cfg)`` for a dataclass, or
    ``params._asdict()`` for a NamedTuple. Nested dataclass fields given
    as dicts (``CourseConfig.motor``) are built recursively."""
    if not dataclasses.is_dataclass(cls):
        return cls(**fields)
    hints = typing.get_type_hints(cls)
    kwargs = {}
    for name, val in fields.items():
        sub = hints.get(name)
        if isinstance(val, dict) and dataclasses.is_dataclass(sub):
            val = config_from_fields(sub, val)
        elif isinstance(val, list):
            val = tuple(val)
        kwargs[name] = val
    return cls(**kwargs)


def course_state_from_numpy(d: Dict[str, Any], device=None,
                            seed: int = 0) -> CourseState:
    """A ``CourseState`` from numpy arrays {pose, u, wpt_idx, visits, ticks,
    done, wheel_vel}. The jax PRNG key has no counterpart: the port's state
    gets a fresh ``torch.Generator`` seeded with ``seed``."""
    t = {name: torch.as_tensor(np.array(d[name]), device=device).to(dtype)
         for name, dtype in _STATE_DTYPES.items()}
    gen = torch.Generator(device=t["pose"].device)
    gen.manual_seed(seed)
    return CourseState(seed=seed, generator=gen, **t)


def course_state_to_numpy(st: CourseState) -> Dict[str, np.ndarray]:
    """The tensors of a ``CourseState`` as numpy arrays (the generator and
    its seed stay behind)."""
    return {name: getattr(st, name).detach().cpu().numpy()
            for name in _STATE_DTYPES}
