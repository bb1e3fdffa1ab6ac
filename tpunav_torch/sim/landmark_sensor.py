"""Simulated landmark sensor: ground-truth cylinders → robot-frame
measurements with visibility gating and optional Gaussian noise.

Port of ``tpunav/sim/landmark_sensor.py`` (the reference's fake-sensor
``analysis`` node, nuslam/src/nuslam/analysis_node.cpp:56-182): world
landmarks transformed into the robot frame (:106-137), NaN rows beyond the
visibility radius (:140-166), optional Gaussian noise (:142-151). Noise is
drawn from a ``torch.Generator`` or injected as standard normals, so a
test can hand both packages the same draw.
"""

from __future__ import annotations

from typing import Optional

import torch


def landmark_measurements(landmarks_world, pose, visibility_radius,
                          generator: Optional[torch.Generator] = None,
                          noise_std: float = 0.0,
                          pose_noise_std: float = 0.0,
                          noise: Optional[torch.Tensor] = None,
                          pose_noise: Optional[torch.Tensor] = None):
    """(M, 2) robot-frame landmark positions; NaN rows lie outside the
    visibility radius.

    landmarks_world: (M, 2) world coordinates (configs/
    block_world_landmarks.yaml). pose: (3,) [theta, x, y] ground truth.
    ``pose_noise_std``: Gaussian noise added to the pose before the
    world→robot transform, like the reference's fake sensor corrupting the
    gazebo pose (ref: analysis_node.cpp:169-178). The draws come from
    ``generator`` (pose first, as ``tpunav`` splits its key), or from the
    injected standard normals ``pose_noise`` (3,) and ``noise`` (M, 2);
    either is scaled by its std, and none is drawn where its std is 0."""
    if pose_noise_std > 0.0 and (generator is not None or
                                 pose_noise is not None):
        if pose_noise is None:
            pose_noise = torch.randn(pose.shape, generator=generator,
                                     dtype=pose.dtype, device=pose.device)
        pose = pose + pose_noise_std * pose_noise
    theta, x, y = pose[0], pose[1], pose[2]
    d = landmarks_world - torch.stack([x, y])
    c, s = torch.cos(theta), torch.sin(theta)
    # World → robot frame: R(-theta) @ d.
    local = torch.stack([c * d[..., 0] + s * d[..., 1],
                         -s * d[..., 0] + c * d[..., 1]], dim=-1)
    if noise_std > 0.0 and (generator is not None or noise is not None):
        if noise is None:
            noise = torch.randn(local.shape, generator=generator,
                                dtype=local.dtype, device=local.device)
        local = local + noise_std * noise
    dist = torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])
    visible = dist <= visibility_radius
    return torch.where(visible[..., None], local, float("nan"))


def associate_known(detections, landmarks_world, true_pose,
                    max_dist: float = 0.2):
    """Known-correspondence oracle: robot-frame detections → an (M, 2)
    measurement tensor indexed by ground-truth landmark id.

    The reference's known-DA path works because its fake sensor publishes
    landmarks in ground-truth order (ref: nuslam/src/analysis_node.cpp:
    106-137), so measurement row i IS landmark id i (ref:
    ekf_filter.cpp:327-345). When the measurements come from the lidar
    circle detector, rows are in cluster order: this sim-side oracle
    matches each ground-truth landmark to its nearest detection (in the
    world frame, through the TRUE pose) within ``max_dist``; unmatched ids
    become NaN rows.

    detections: (C, 2) robot-frame circle centers, NaN rows empty.
    landmarks_world: (M, 2); true_pose: (3,) [theta, x, y].
    """
    theta, x, y = true_pose[0], true_pose[1], true_pose[2]
    c, s = torch.cos(theta), torch.sin(theta)
    ok = torch.isfinite(detections).all(dim=-1)
    det = torch.nan_to_num(detections)
    # Robot → world frame: R(theta) @ p + t.
    world = torch.stack([c * det[:, 0] - s * det[:, 1] + x,
                         s * det[:, 0] + c * det[:, 1] + y], dim=-1)
    d2 = torch.sum((landmarks_world[:, None, :] - world[None, :, :]) ** 2,
                   dim=-1)
    d2 = torch.where(ok[None, :], d2, float("inf"))           # (M, C)
    best_d2, best = torch.min(d2, dim=-1)
    matched = best_d2 <= max_dist * max_dist
    return torch.where(matched[:, None],
                       detections.index_select(0, best), float("nan"))
