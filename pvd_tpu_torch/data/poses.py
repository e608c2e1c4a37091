"""Camera poses (port of pvd_tpu/data/poses.py:24-51).

Host-side numpy: `pose_spherical` gives the blender-style orbit c2w that
the synthetic scene and the test orbit use.  The random distillation pose
samplers are not ported yet (ROADMAP A15).
"""

from __future__ import annotations

import numpy as np


def pose_spherical(theta_deg: float, phi_deg: float,
                   radius: float) -> np.ndarray:
    """Blender-style spherical c2w [4, 4] float32
    (distill_mutual/utils.py:67-98 in the reference)."""
    c2w = np.eye(4, dtype=np.float32)
    c2w[2, 3] = radius
    phi = phi_deg / 180.0 * np.pi
    rot_phi = np.array([[1, 0, 0, 0], [0, np.cos(phi), -np.sin(phi), 0],
                        [0, np.sin(phi), np.cos(phi), 0], [0, 0, 0, 1]],
                       np.float32)
    th = theta_deg / 180.0 * np.pi
    rot_theta = np.array([[np.cos(th), 0, -np.sin(th), 0], [0, 1, 0, 0],
                          [np.sin(th), 0, np.cos(th), 0], [0, 0, 0, 1]],
                         np.float32)
    flip = np.array([[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0],
                     [0, 0, 0, 1]], np.float32)
    return flip @ rot_theta @ rot_phi @ c2w
