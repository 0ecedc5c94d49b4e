# Tiny ImVoteNet_Deformdetr in its fusion mode on synthetic RGB-D scenes,
# for the port's entry points on the CPU: the frozen Deformable-DETR image
# branch of detr_pretrain_tiny.py (zoo.tiny_detr_model_cfg) with the point
# branch, VoteFusion and towers of imvotenet_tiny.py, on that config's
# pipelines, scenes and schedule.  At random weights the DETR scores its
# queries near 0.01, under the fusion's 0.09, so the seeds take no image
# vote: the entries run that case.
import copy
import os

from demf_tpu_torch.utils.config import Config
from demf_tpu_torch.zoo import tiny_detr_model_cfg, tiny_imvotenet_model_cfg

_stage2 = Config.fromfile(os.path.join(os.path.dirname(__file__),
                                       'imvotenet_tiny.py'))
_points = tiny_imvotenet_model_cfg()
_detr = tiny_detr_model_cfg()
model = dict(
    {k: copy.deepcopy(v) for k, v in _points.items() if k not in (
        'type', 'img_backbone', 'img_neck', 'img_rpn_head', 'img_roi_head',
        'train_cfg', 'test_cfg')},
    type='ImVoteNet_Deformdetr', img_backbone=_detr['img_backbone'],
    img_neck=_detr['img_neck'], img_bbox_head=_detr['img_bbox_head'],
    train_cfg=dict(_detr['train_cfg'], pts=_points['train_cfg']['pts']),
    test_cfg=dict(_detr['test_cfg'], pts=_points['test_cfg']['pts']))
class_names = _stage2.class_names
train_pipeline = _stage2.train_pipeline
test_pipeline = _stage2.test_pipeline
data = _stage2.data
max_gt = _stage2.max_gt
optimizer = _stage2.optimizer
optimizer_config = _stage2.optimizer_config
lr_config = _stage2.lr_config
runner = _stage2.runner
checkpoint_config = _stage2.checkpoint_config
log_config = _stage2.log_config
evaluation = _stage2.evaluation
del _stage2, _points, _detr
