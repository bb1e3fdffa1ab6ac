"""Write the RBPF course's scans as ``tpunav`` draws them, for
``tools/rbpf_course_spread.py``.

    python3 tools/tpunav_course_scans.py

Runs ``tpunav`` (JAX) on the CPU: the course of examples/rbpf_slam_demo.py
and bench.py (an arc at u = (0.03 rad, 0.02 m) per update inside walls at
±1.8 m, 120 updates, 360-beam scans with 2 mm range noise), with the scan
noise keyed as the demo keys it (fold_in(PRNGKey(99), i)) and as the bench
keys it (fold_in(PRNGKey(7), i)). Saves scans (2, 120, 360) and odometry
(120, 3), float32, to tools/out/tpunav_course_scans.npz.
"""

import os

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from tpunav.sim.lidar import box_segments, scan_segments  # noqa: E402

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "out")
KEYS = {"tpunav_demo_key99": 99, "tpunav_bench_key7": 7}


def main():
    segs = box_segments(-1.8, -1.8, 1.8, 1.8, jnp.float32)
    u = jnp.array([0.03, 0.02], jnp.float32)
    pose = jnp.zeros(3, jnp.float32)
    odoms = []
    for _ in range(120):
        th = pose[0] + u[0]
        pose = jnp.stack([th, pose[1] + u[1] * jnp.cos(th),
                          pose[2] + u[1] * jnp.sin(th)])
        odoms.append(pose)
    scans = [[np.asarray(scan_segments(
        pose, segs, num_beams=360, max_range=3.5,
        key=jax.random.fold_in(jax.random.PRNGKey(key), i), noise_std=0.002))
        for i, pose in enumerate(odoms)] for key in KEYS.values()]
    os.makedirs(OUT, exist_ok=True)
    path = os.path.join(OUT, "tpunav_course_scans.npz")
    np.savez(path, names=np.array(list(KEYS)),
             scans=np.asarray(scans, np.float32),
             odoms=np.asarray(odoms, np.float32))
    print(path)


if __name__ == "__main__":
    main()
