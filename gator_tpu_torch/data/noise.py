"""Detector-error statistics for Human3.6M inputs (counterpart of
gator_tpu/data/noise.py:50 `h36m_error_stats`; data: AbsPoseLifter error
statistics, as bundled in the reference's data/Human36M/noise_stats.py).
The detector-noise simulators that draw from them are not ported yet (the
data-pipeline slice)."""
from __future__ import annotations

import numpy as np

# (mean_x, mean_y, std_x, std_y, weight) keyed by h36m joint name
H36M_ERROR_STATS = {
    "Pelvis":     (-0.06, -2.37, 1.33, 2.13, 1.00),
    "R_Hip":      (-0.83, -2.07, 3.41, 2.69, 1.00),
    "R_Knee":     (-0.04, -1.01, 1.74, 2.20, 0.95),
    "R_Ankle":    (0.52, -3.40, 1.39, 2.14, 0.93),
    "L_Hip":      (0.78, -2.79, 3.26, 2.28, 1.00),
    "L_Knee":     (0.42, -0.15, 1.53, 1.99, 0.94),
    "L_Ankle":    (-0.15, -3.78, 1.39, 2.39, 0.93),
    "Torso":      (-0.05, 0.10, 1.36, 1.74, 0.99),
    "Neck":       (0.14, -2.56, 1.18, 1.15, 0.99),
    "Head":       (0.09, 0.49, 1.35, 0.87, 0.99),
    "Nose":       (0.13, -0.26, 0.78, 0.59, 0.98),
    "L_Shoulder": (-0.19, 0.31, 2.51, 1.48, 0.99),
    "L_Elbow":    (0.11, -0.60, 1.79, 1.76, 0.95),
    "L_Wrist":    (-0.02, 0.88, 2.02, 2.10, 0.91),
    "R_Shoulder": (0.52, -0.12, 2.23, 1.73, 0.99),
    "R_Elbow":    (0.06, -0.44, 1.93, 1.63, 0.95),
    "R_Wrist":    (0.05, 0.16, 2.02, 2.24, 0.90),
}


def h36m_error_stats(joints_name) -> np.ndarray:
    """[J, 5] (mean_x, mean_y, std_x, std_y, weight) ordered by joint name
    (reference: Human36M/dataset.py:135-141)."""
    return np.array([H36M_ERROR_STATS[n] for n in joints_name],
                    dtype=np.float32)
