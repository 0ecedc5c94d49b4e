"""Geometric ops of the port.  FPS, ball query, MSDA (forward and
backward), the aligned 3D NMS, the count of points in rotated boxes, the
batched 2D NMS and the pyramid RoIAlign each have a CUDA kernel
(``csrc/``) beside a plain PyTorch version; a CPU tensor takes the plain
version and a CUDA tensor the kernel.  So do the
row gather, the slot fold and the M-form sampler of the quad-plane MSDA
route (``msda_quad.py``), which the probes of ``demf_tpu_torch.tools``
drive and the model does not call."""
from .box_count import BOX_COUNT_KERNEL, box_point_count
from .gather_rows import GATHER_ROWS_KERNEL
from .grouping import (BALL_QUERY_KERNEL, ball_query, gather_points,
                       gather_points_last, group_points, group_points_last,
                       query_and_group)
from .interpolate import three_nn_interpolate
from .mform import MFORM_KERNEL
from .msda import (MSDA_BACKWARD_BF16_KERNEL, MSDA_BACKWARD_KERNEL,
                   MSDA_BF16_KERNEL, MSDA_KERNEL,
                   multi_scale_deformable_attention)
from .msda_fold import MSDA_FOLD_KERNEL
from .nms import NMS3D_KERNEL, aligned_3d_nms
from .nms2d import NMS2D_KERNEL, batched_nms_2d, nms_2d
from .roi_align import ROI_ALIGN_KERNEL, pyramid_roi_align
from .sampling import FPS_KERNEL, furthest_point_sample

__all__ = [
    'aligned_3d_nms', 'ball_query', 'batched_nms_2d', 'box_point_count',
    'furthest_point_sample', 'gather_points', 'gather_points_last',
    'group_points', 'group_points_last',
    'multi_scale_deformable_attention', 'nms_2d', 'pyramid_roi_align',
    'query_and_group', 'three_nn_interpolate', 'kernels',
]


def kernels():
    """name -> CudaKernel for every kernel of the port: the serving and
    training paths' (FPS to MSDA backward, the 3D NMS and the box count,
    the 2D NMS and the RoIAlign of ImVoteNet's image branch; MSDA
    forward and backward on a float32 and on a bfloat16 value, each with
    its own count) and the probes'."""
    return {'fps': FPS_KERNEL, 'ball_query': BALL_QUERY_KERNEL,
            'msda': MSDA_KERNEL, 'msda_backward': MSDA_BACKWARD_KERNEL,
            'msda_bf16': MSDA_BF16_KERNEL,
            'msda_backward_bf16': MSDA_BACKWARD_BF16_KERNEL,
            'gather_rows': GATHER_ROWS_KERNEL, 'msda_fold': MSDA_FOLD_KERNEL,
            'mform_sample': MFORM_KERNEL, 'nms3d': NMS3D_KERNEL,
            'box_count': BOX_COUNT_KERNEL, 'nms2d': NMS2D_KERNEL,
            'roi_align': ROI_ALIGN_KERNEL}
