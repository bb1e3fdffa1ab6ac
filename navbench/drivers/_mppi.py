"""What the MPPI drivers share: the configuration file read into the
program's objects and into the reference's plain dict."""

from __future__ import annotations


def plain(cfg: dict) -> dict:
    """The configuration as the reference reads it."""
    horizon, dt = cfg["horizon"], cfg["time_step"]
    return {"lambda": cfg["lambda"], "ul_var": cfg["ul_var"],
            "ur_var": cfg["ur_var"], "dt": dt,
            "steps": int(horizon / dt), "Q": cfg["Q"], "R": cfg["R"],
            "P1": cfg["P1"], "u_init": (cfg["ul_init"], cfg["ur_init"]),
            "wheel_radius": cfg["wheel_radius"],
            "wheel_base": cfg["wheel_base"],
            "max_wheel_vel": cfg["max_rot_motor"],
            "goal_thresh": cfg.get("goal_thresh"),
            "cycles": cfg.get("cycles"),
            "tick_dt": 1.0 / cfg["tick_hz"] if "tick_hz" in cfg else None,
            "waypoints": cfg.get("waypoints")}


def program(cfg: dict, rollouts: int):
    """(MPPIConfig, CartParams) of the program."""
    from tpunav_torch.control.mppi import MPPIConfig
    from tpunav_torch.models.cart import CartParams

    mcfg = MPPIConfig(
        lambda_=cfg["lambda"], max_wheel_vel=cfg["max_rot_motor"],
        ul_var=cfg["ul_var"], ur_var=cfg["ur_var"], horizon=cfg["horizon"],
        dt=cfg["time_step"], rollouts=rollouts, q_diag=tuple(cfg["Q"]),
        r_diag=tuple(cfg["R"]), p1_diag=tuple(cfg["P1"]),
        u_init=(cfg["ul_init"], cfg["ur_init"]))
    return mcfg, CartParams(cfg["wheel_radius"], cfg["wheel_base"])


def sample_steps(gen, lo: int, hi: int, count: int):
    """``count`` distinct step indices in [lo, hi), drawn from ``gen``."""
    import torch

    perm = torch.randperm(hi - lo, generator=gen, device=gen.device)
    return sorted(int(i) + lo for i in perm[:count].tolist())
