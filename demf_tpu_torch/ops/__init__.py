"""Geometric ops of the port.  FPS, ball query, MSDA (forward and
backward), the aligned 3D NMS, the count of points in rotated boxes, the
batched 2D NMS, the pyramid RoIAlign (forward and backward), and the
FCAF3D family's sparse-convolution kernel map and gather-GEMM and its
class-wise rotated 3D NMS each have a CUDA kernel
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
from .nms_rotated import NMS3D_ROTATED_KERNEL, rotated_nms_classwise
from .roi_align import (ROI_ALIGN_BACKWARD_BF16_KERNEL,
                        ROI_ALIGN_BACKWARD_KERNEL, ROI_ALIGN_BF16_KERNEL,
                        ROI_ALIGN_KERNEL, pyramid_roi_align)
from .sampling import FPS_KERNEL, furthest_point_sample
from .sparse import (KERNEL_MAP_KERNEL, SPARSE_CONV_BF16_KERNEL,
                     SPARSE_CONV_KERNEL)

__all__ = [
    'aligned_3d_nms', 'ball_query', 'batched_nms_2d', 'box_point_count',
    'furthest_point_sample', 'gather_points', 'gather_points_last',
    'group_points', 'group_points_last',
    'multi_scale_deformable_attention', 'nms_2d', 'pyramid_roi_align',
    'query_and_group', 'rotated_nms_classwise', 'three_nn_interpolate',
    'kernels',
]


def kernels():
    """name -> CudaKernel for every kernel of the port: the serving and
    training paths' (FPS to MSDA backward, the 3D NMS and the box count,
    the 2D NMS and the RoIAlign (forward and backward) of ImVoteNet's
    image branch; the kernel map, the sparse convolution (float32 and
    bfloat16 rows, each with its own count) and the class-wise rotated NMS
    of the FCAF3D family; MSDA forward and backward on a float32 and on a
    bfloat16 value, and the RoIAlign on float32 and on bfloat16 levels,
    each with its own count) and the probes'."""
    return {'fps': FPS_KERNEL, 'ball_query': BALL_QUERY_KERNEL,
            'msda': MSDA_KERNEL, 'msda_backward': MSDA_BACKWARD_KERNEL,
            'msda_bf16': MSDA_BF16_KERNEL,
            'msda_backward_bf16': MSDA_BACKWARD_BF16_KERNEL,
            'gather_rows': GATHER_ROWS_KERNEL, 'msda_fold': MSDA_FOLD_KERNEL,
            'mform_sample': MFORM_KERNEL, 'nms3d': NMS3D_KERNEL,
            'box_count': BOX_COUNT_KERNEL, 'nms2d': NMS2D_KERNEL,
            'roi_align': ROI_ALIGN_KERNEL,
            'roi_align_backward': ROI_ALIGN_BACKWARD_KERNEL,
            'roi_align_bf16': ROI_ALIGN_BF16_KERNEL,
            'roi_align_backward_bf16': ROI_ALIGN_BACKWARD_BF16_KERNEL,
            'kernel_map': KERNEL_MAP_KERNEL,
            'sparse_conv': SPARSE_CONV_KERNEL,
            'sparse_conv_bf16': SPARSE_CONV_BF16_KERNEL,
            'nms3d_rotated': NMS3D_ROTATED_KERNEL}
