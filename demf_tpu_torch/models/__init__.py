"""Models of the port.  Importing this package registers the detector and
its parts in ``demf_tpu_torch.registry``."""
from . import (conv_bbox_head, demf_head, demfnet, detr_head, image_neck,
               imvotenet, losses, pointnet2, resnet, rpn_roi, target_assign,
               transformer, vote_fusion, vote_head, vote_module, votenet)
from .demfnet import DeMFVoteNet
from .imvotenet import ImVoteNet, ImVoteNet_Deformdetr
from .votenet import VoteNet
from .weight_init import init_weights

__all__ = ['DeMFVoteNet', 'ImVoteNet', 'ImVoteNet_Deformdetr', 'VoteNet',
           'conv_bbox_head', 'demf_head', 'demfnet', 'detr_head',
           'image_neck', 'imvotenet', 'init_weights', 'losses', 'pointnet2',
           'resnet', 'rpn_roi', 'target_assign', 'transformer',
           'vote_fusion', 'vote_head', 'vote_module', 'votenet']
