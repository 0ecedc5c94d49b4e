"""Models of the port.  Importing this package registers the detector and
its parts in ``demf_tpu_torch.registry``."""
from . import (conv_bbox_head, demf_head, demfnet, image_neck, losses,
               pointnet2, resnet, target_assign, transformer, vote_head,
               vote_module)
from .demfnet import DeMFVoteNet
from .weight_init import init_weights

__all__ = ['DeMFVoteNet', 'conv_bbox_head', 'demf_head', 'demfnet',
           'image_neck', 'init_weights', 'losses', 'pointnet2', 'resnet',
           'target_assign', 'transformer', 'vote_head', 'vote_module']
