"""Camera matrices: view from the player transform, gluPerspective-style
projection. Port of `tpu_doom/render/camera.py` over an env batch."""

from __future__ import annotations

import math

import numpy as np
import torch

from .._numerics import cos_sin, f32


def tan_f32(x: float) -> float:
    """f32 tangent of an f32 argument, rounded once from float64."""
    return f32(math.tan(f32(x)))


def perspective(fovy_rad, aspect, near, far, device) -> torch.Tensor:
    """gluPerspective matrix (4, 4) f32 (row-major, z in [-1, 1])."""
    f = float(np.float32(1.0) / np.float32(tan_f32(fovy_rad / 2.0)))
    m = torch.zeros((4, 4), dtype=torch.float32, device=device)
    # fill_ takes the scalar as a kernel argument; `m[i, j] = x` would
    # copy it from the host, which a captured tick cannot do.
    m[0, 0].fill_(float(np.float32(f) / np.float32(aspect)))
    m[1, 1].fill_(f)
    m[2, 2].fill_((far + near) / (near - far))
    m[2, 3].fill_(2.0 * far * near / (near - far))
    m[3, 2].fill_(-1.0)
    return m


def rotation_yaw_pitch(yaw, pitch):
    """R = R_y(yaw) @ R_x(pitch) as (B, 3, 3). Every entry is one product
    (the other terms of the 3x3 product are exact zeros). The trig is
    rounded once from float64 (`_numerics.cos_sin`)."""
    cy, sy = cos_sin(yaw)
    cx, sx = cos_sin(pitch)
    z = torch.zeros_like(cy)
    return torch.stack([
        torch.stack([cy, sy * sx, sy * cx], dim=-1),
        torch.stack([z, cx, -sx], dim=-1),
        torch.stack([-sy, cy * sx, cy * cx], dim=-1),
    ], dim=-2)


def camera_matrices(pos, yaw, pitch, *, camera_height, fovy_rad, aspect,
                    near, far):
    """(modelview (B, 4, 4), projection (4, 4)). The camera sits at
    pos + R @ (0, camera_height, 0); view = inverse transform."""
    r = rotation_yaw_pitch(yaw, pitch)
    cam_pos = pos + r[:, :, 1] * f32(camera_height)
    rt = r.transpose(1, 2)
    t = -(rt[:, :, 0] * cam_pos[:, None, 0] + rt[:, :, 1] * cam_pos[:, None, 1]
          + rt[:, :, 2] * cam_pos[:, None, 2])
    B = pos.shape[0]
    mv = torch.zeros((B, 4, 4), dtype=torch.float32, device=pos.device)
    mv[:, :3, :3] = rt
    mv[:, :3, 3] = t
    mv[:, 3, 3].fill_(1.0)
    return mv, perspective(fovy_rad, aspect, near, far, pos.device)
