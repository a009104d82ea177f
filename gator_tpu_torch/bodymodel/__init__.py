from .mano import (ManoModel, ManoParams, load_mano_pkl, mano_forward,
                   synthetic_mano)
from .rotations import (axis_angle_to_rotmat, quat_to_rotmat,
                        rotmat_flat_minus_id, rotmat_to_axis_angle,
                        rotmat_to_quat)
from .rotations6d import (project_to_rotation, rot6d_to_rotmat,
                          rot6d_to_rotmat_spin, rotmat_to_rot6d)
from .smpl import (SmplParams, smpl_forward, smpl_forward_rotmat,
                   substitute_mean_betas)

__all__ = ["ManoModel", "ManoParams", "SmplParams", "axis_angle_to_rotmat",
           "load_mano_pkl", "mano_forward", "project_to_rotation",
           "quat_to_rotmat", "rot6d_to_rotmat", "rot6d_to_rotmat_spin",
           "rotmat_flat_minus_id", "rotmat_to_axis_angle", "rotmat_to_quat",
           "rotmat_to_rot6d", "smpl_forward", "smpl_forward_rotmat",
           "substitute_mean_betas", "synthetic_mano"]
