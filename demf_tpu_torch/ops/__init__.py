"""Geometric ops of the port.  FPS, ball query and MSDA (forward and
backward) each have a CUDA kernel (``csrc/``) beside a plain PyTorch
version; a CPU tensor takes the plain version and a CUDA tensor the
kernel.  So do the row gather, the slot fold and the M-form sampler of
the quad-plane MSDA route (``msda_quad.py``), which the probes of
``demf_tpu_torch.tools`` drive and the model does not call."""
from .gather_rows import GATHER_ROWS_KERNEL
from .grouping import (BALL_QUERY_KERNEL, ball_query, gather_points,
                       gather_points_last, group_points, group_points_last,
                       query_and_group)
from .interpolate import three_nn_interpolate
from .mform import MFORM_KERNEL
from .msda import (MSDA_BACKWARD_KERNEL, MSDA_KERNEL,
                   multi_scale_deformable_attention)
from .msda_fold import MSDA_FOLD_KERNEL
from .nms import aligned_3d_nms
from .sampling import FPS_KERNEL, furthest_point_sample

__all__ = [
    'aligned_3d_nms', 'ball_query', 'furthest_point_sample', 'gather_points',
    'gather_points_last', 'group_points', 'group_points_last',
    'multi_scale_deformable_attention', 'query_and_group',
    'three_nn_interpolate', 'kernels',
]


def kernels():
    """name -> CudaKernel for every kernel of the port: the serving and
    training paths' (FPS to MSDA backward) and the probes'."""
    return {'fps': FPS_KERNEL, 'ball_query': BALL_QUERY_KERNEL,
            'msda': MSDA_KERNEL, 'msda_backward': MSDA_BACKWARD_KERNEL,
            'gather_rows': GATHER_ROWS_KERNEL, 'msda_fold': MSDA_FOLD_KERNEL,
            'mform_sample': MFORM_KERNEL}
