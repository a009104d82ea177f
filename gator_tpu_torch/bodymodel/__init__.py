from .rotations import (axis_angle_to_rotmat, quat_to_rotmat,
                        rotmat_flat_minus_id, rotmat_to_axis_angle,
                        rotmat_to_quat)
from .smpl import SmplParams, smpl_forward, substitute_mean_betas

__all__ = ["SmplParams", "axis_angle_to_rotmat", "quat_to_rotmat",
           "rotmat_flat_minus_id", "rotmat_to_axis_angle", "rotmat_to_quat",
           "smpl_forward", "substitute_mean_betas"]
