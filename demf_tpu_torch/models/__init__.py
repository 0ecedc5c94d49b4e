"""Models of the port.  Importing this package registers the detector and
its parts in ``demf_tpu_torch.registry``."""
from . import (conv_bbox_head, demf_fcaf3d, demf_head, demfnet, detr_head,
               fcaf3d, image_neck, imvotenet, losses, mink_resnet, pointnet2,
               resnet, rpn_roi, target_assign, transformer, vote_fusion,
               vote_head, vote_module, votenet)
from .demf_fcaf3d import DeMFFcaf3D
from .demfnet import DeMFVoteNet
from .fcaf3d import FCAF3D
from .imvotenet import ImVoteNet, ImVoteNet_Deformdetr
from .votenet import VoteNet
from .weight_init import init_weights

__all__ = ['DeMFFcaf3D', 'DeMFVoteNet', 'FCAF3D', 'ImVoteNet',
           'ImVoteNet_Deformdetr', 'VoteNet', 'conv_bbox_head', 'demf_fcaf3d',
           'demf_head', 'demfnet', 'detr_head', 'fcaf3d', 'image_neck',
           'imvotenet', 'init_weights', 'losses', 'mink_resnet', 'pointnet2',
           'resnet', 'rpn_roi', 'target_assign', 'transformer',
           'vote_fusion', 'vote_head', 'vote_module', 'votenet']
