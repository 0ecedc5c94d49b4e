"""ImVoteNet detectors (port of ``demf_tpu/models/imvotenet.py``).

``ImVoteNet_Deformdetr`` has two modes, as in the JAX package.  A batch
without ``points`` runs the stage-1 2D pretrain: ResNet-50 ->
ChannelMapper -> ``DeformableDETRHead``, trained end to end (but for the
backbone's ``frozen_stages``); its checkpoint is what stage 2 warm-starts
its image branch from (``engine.checkpoint.load_weights``).  A batch with
``points`` runs the fusion: the 2D branch in eval mode without a graph ->
the 2D boxes over a score of 0.09 -> in training a random half of them
dropped -> ``VoteFusion``'s 18-dim image votes -> ``sample_valid_seeds`` ->
``ImgMLP`` -> three vote towers (``CAVoteHead``: joint on the point and
image features, pts, img) with the loss weighted [0.4, 0.3, 0.3] and the
detections of the joint tower.

``ImVoteNet`` (the published baseline, ``configs/baseline/imvotenet.py``)
shares the fusion and takes its 2D boxes from a Faster R-CNN branch:
caffe ResNet-50 -> FPN -> ``RPNHead`` proposals -> ``StandardRoIHead``
detections over ``test_cfg.img_rcnn.score_thr``; the 2D NMS and the
RoIAlign run as kernels K10 and K11 on the card.  Without ``points`` it is
the image-only Faster R-CNN, the first stage of the published workflow:
in training the RPN's loss over every anchor, proposals without a graph,
512 RoIs an image sampled from them and the GT boxes, and the R-CNN's loss
on those (the RoIAlign's backward is K12); in inference the R-CNN's
detections on the proposals.  Its checkpoint warm-starts the stage-2 model
(``load_from``).  Every mode runs under the bf16 policy as in the JAX
package: the FPN levels are bf16, K11 reads them in bf16 and pools in
float32 (so the R-CNN computes in float32 from there), K12 writes their
bf16 gradient, and the RPN's bf16 scores meet K10 widened exactly.

Random draws: the half-drop and the seed sampling take their uniforms
from the caller's ``torch.Generator`` in training, in that order; in eval
(no generator) from a ``torch.Generator`` seeded 0 on the model's device,
where the JAX package draws from ``jax.random.PRNGKey(0)``: the same
distribution, other numbers.  ``forward(..., draws=dict(bboxes_2d=u,
seeds=u))`` takes the uniforms instead (the tests pass the JAX draws).
The image-only training draws, in this order, ``FRCNN_DRAWS``: the RPN
sampler's positive and negative keys (B, anchors), then the R-CNN
sampler's and its order keys (B, proposals + GT slots); ``draws`` takes
any of them by name.
Like the JAX package, a module builds only what its modes run: without
``pts_backbone`` no point branch, towers or fusion.
"""
from __future__ import annotations

import contextlib

import torch
from torch import nn

from ..ops.grouping import gather_points_last
from ..registry import BACKBONES, DETECTORS, HEADS, NECKS, build_from_cfg
from .pointnet2 import SharedMLP
from .rpn_roi import rcnn_loss, rpn_loss, sample_rcnn_rois
from .vote_fusion import VoteFusion, sample_valid_seeds

TOWERS = ('joint', 'pts', 'img')
# the image-only Faster R-CNN's uniform draws, in the order a generator
# makes them
FRCNN_DRAWS = ('rpn_pos', 'rpn_neg', 'rcnn_pos', 'rcnn_neg', 'rcnn_order')


class ImgMLP(nn.Module):
    """mmdet3d ``MLP``: 1x1 Conv1d + BN + ReLU layers from the 18-dim image
    votes (``mlp.layer{i}``)."""

    def __init__(self, in_channel=18, conv_channels=(256, 256),
                 conv_cfg=None, norm_cfg=None, act_cfg=None):
        super().__init__()
        self.mlp = SharedMLP(in_channel, list(conv_channels), dims=1)

    def forward(self, x):
        return self.mlp(x)


@contextlib.contextmanager
def _eval_mode(modules):
    """The modules in eval mode inside the block, as they were after it."""
    modes = [(m, m.training) for m in modules]
    for m, _ in modes:
        m.eval()
    try:
        yield
    finally:
        for m, mode in modes:
            m.train(mode)


def half_drop(valid, generator=None, u=None):
    """Keep a random half (``ceil(count / 2)``) of each image's valid boxes:
    the valid boxes ranked by a uniform draw (``u`` (B, K), the caller's,
    or from ``generator``), the lower ranks kept."""
    if u is None:
        u = torch.rand(valid.shape, generator=generator, device=valid.device)
    key = torch.where(valid, u, torch.full_like(u, float('inf')))
    rank = (key[..., None, :] < key[..., :, None]).sum(-1)
    count = valid.sum(-1, keepdim=True)
    return valid & (rank < (count + 1) // 2)


@DETECTORS.register_module()
class ImVoteNet_Deformdetr(nn.Module):
    # what the step-time measurements train it on (``zoo.synth_batch_for``):
    # batch maker, images, GT slots
    synth_batch = ('detr2d', 4, 20)
    # the frozen 2D branch, and the score over which its boxes are kept
    img_branch = ('img_backbone', 'img_neck', 'img_bbox_head')
    box_score_thr = 0.09

    def __init__(self, pts_backbone=None, pts_bbox_heads=None, pts_neck=None,
                 img_backbone=None, img_neck=None, img_bbox_head=None,
                 img_mlp=None, freeze_img_branch=False, fusion_layer=None,
                 num_sampled_seed=None, train_cfg=None, test_cfg=None,
                 pretrained=None, init_cfg=None, **heads_2d):
        super().__init__()
        self.train_cfg = train_cfg
        self.test_cfg = test_cfg
        self.freeze_img_branch = freeze_img_branch
        self.num_sampled_seed = num_sampled_seed
        self.img_backbone = build_from_cfg(img_backbone, BACKBONES)
        self.img_neck = build_from_cfg(img_neck, NECKS)
        self._build_2d_heads(img_bbox_head=img_bbox_head, **heads_2d)
        if pts_backbone is not None:
            self.pts_backbone = build_from_cfg(pts_backbone, BACKBONES)
            towers, self.loss_weights = self._tower_cfgs(pts_bbox_heads)
            for tower in TOWERS:
                setattr(self, f'pts_bbox_head_{tower}',
                        build_from_cfg(towers[tower], HEADS))
            self.img_mlp = ImgMLP(**dict(img_mlp or {}))
            fusion = dict(fusion_layer or {})
            fusion.pop('type', None)
            self.fusion = VoteFusion(**fusion)
        else:
            self.pts_backbone = None
        if freeze_img_branch:
            for module in self._img_modules():
                module.requires_grad_(False)

    def _build_2d_heads(self, img_bbox_head=None):
        head = dict(img_bbox_head)
        head['train_cfg'] = self.train_cfg
        head['test_cfg'] = self.test_cfg
        self.img_bbox_head = build_from_cfg(head, HEADS)

    def _tower_cfgs(self, heads):
        """The three towers' head configs (the common part, the pts
        train / test cfg, each tower's vote module and aggregation) and the
        loss weights."""
        heads = dict(heads)
        common = dict(heads['common'])
        common['train_cfg'] = (self.train_cfg or {}).get('pts')
        common['test_cfg'] = (self.test_cfg or {}).get('pts')
        towers = {t: dict(common, **dict(heads[t])) for t in TOWERS}
        return towers, list(heads['loss_weights'])

    def _img_modules(self):
        return [m for m in (getattr(self, n) for n in self.img_branch)
                if m is not None]

    def train(self, mode=True):
        """Train mode everywhere but a frozen image branch."""
        super().train(mode)
        if self.freeze_img_branch:
            for module in self._img_modules():
                module.eval()
        return self

    def frozen_param_patterns(self):
        return list(self.img_branch) if self.freeze_img_branch else []

    def extract_img_feat(self, img):
        """img (B, H, W, 3) -> tuple of NHWC maps from the neck."""
        with torch.set_grad_enabled(torch.is_grad_enabled() and
                                    not self.freeze_img_branch):
            x = self.img_backbone(img)
            if self.img_neck is not None:
                x = self.img_neck(x)
        return x

    def detect_2d(self, img, meta):
        """The 2D branch's detections: dict(bboxes (B, K, 5), labels (B, K)
        and, where the head gives one, valid (B, K))."""
        feats = self.extract_img_feat(img)
        head = self.img_bbox_head
        return head.get_bboxes(head(feats, meta['img_shape']),
                               meta['img_shape'])

    def extract_bboxes_2d(self, img, meta, generator=None, u=None):
        """The frozen 2D inference -> (B, K, 6) score-sorted boxes [xyxy,
        score, class] and their mask: over the score threshold, and in
        training a random half of them (``half_drop``)."""
        with torch.no_grad(), _eval_mode(self._img_modules()):
            det = self.detect_2d(img, meta)
        boxes = torch.cat([det['bboxes'],
                           det['labels'][..., None].to(det['bboxes'].dtype)],
                          -1)
        valid = det['bboxes'][..., 4] > self.box_score_thr
        if 'valid' in det:
            valid = valid & det['valid']
        if self.training:
            valid = half_drop(valid, generator, u)
        return boxes, valid

    def forward(self, batch, sample_mod=None, generator=None, draws=None):
        """batch: ``img`` (B, H, W, 3) and ``img_meta`` (``img_shape`` and,
        with points, the calibration and augmentation); with ``points``
        (B, N, C) the fusion mode.  ``sample_mod`` overrides the config's
        proposal sampling; ``generator`` (a ``torch.Generator`` on the
        model's device) draws the dropout masks, the half-drop and the seed
        sampling in training; ``draws`` gives the last two's uniforms
        instead (``bboxes_2d`` (B, K), ``seeds`` (B, N * slots); without
        points, the image-only mode's draws by name)."""
        if 'points' not in batch:
            return self.forward_img_only(batch, generator, draws)
        if self.pts_backbone is None:
            raise ValueError('fusion mode: the model was built without a '
                             'pts_backbone')
        draws = draws or {}
        if self.training and generator is None and len(draws) < 2:
            raise ValueError('the fusion mode trains on a torch.Generator '
                             '(or the draws)')
        meta = batch['img_meta']
        if not self.training:
            generator = torch.Generator(batch['points'].device).manual_seed(0)
        boxes_2d, box_valid = self.extract_bboxes_2d(
            batch['img'], meta, generator, draws.get('bboxes_2d'))

        x = self.pts_backbone(batch['points'])
        seeds_3d = x['fp_xyz'][-1]
        seed_feats = x['fp_features'][-1]
        seed_indices = x['fp_indices'][-1]
        n = seeds_3d.shape[1]
        img_votes, vote_mask = self.fusion(batch['img'], boxes_2d, box_valid,
                                           seeds_3d, meta)
        inds = sample_valid_seeds(vote_mask, self.num_sampled_seed,
                                  generator, draws.get('seeds'))
        img_votes = gather_points_last(img_votes, inds)
        seed_inds = inds % n
        seeds_3d = gather_points_last(seeds_3d, seed_inds)
        seed_feats = gather_points_last(seed_feats, seed_inds)
        seed_indices = torch.gather(seed_indices, 1, seed_inds)
        img_feats = self.img_mlp(img_votes)
        fused = torch.cat([seed_feats, img_feats], -1)
        features = dict(joint=fused, pts=seed_feats, img=img_feats)

        if sample_mod is None:
            cfg = self.train_cfg if self.training else self.test_cfg
            sample_mod = cfg['pts']['sample_mod']
        results = {
            tower: getattr(self, f'pts_bbox_head_{tower}')(
                dict(seed_points=seeds_3d, seed_features=features[tower],
                     seed_indices=seed_indices), sample_mod, generator)
            for tower in TOWERS}
        results['bboxes_2d'] = boxes_2d
        results['bboxes_2d_valid'] = box_valid
        return results

    def forward_img_only(self, batch, generator=None, draws=None):
        """The stage-1 2D pretrain: -> dict(img_preds=the head's output);
        ``generator`` draws the dropout masks in train mode."""
        feats = self.extract_img_feat(batch['img'])
        return dict(img_preds=self.img_bbox_head(
            feats, batch['img_meta']['img_shape'], generator))

    def loss(self, results, batch):
        if 'img_preds' in results:
            return self.img_bbox_head.loss(
                results['img_preds'], batch['gt_bboxes'], batch['gt_labels'],
                batch['gt_bboxes_valid'], batch['img_meta']['img_shape'])
        combined = {}
        for weight, tower in zip(self.loss_weights, TOWERS):
            losses = getattr(self, f'pts_bbox_head_{tower}').loss(
                results[tower], batch['points'], batch['gt_bboxes_3d'],
                batch['gt_labels_3d'], batch['gt_valid'])
            for key, value in losses.items():
                combined[key] = combined.get(key, 0.) + value * weight
        return combined

    def get_bboxes(self, results, batch):
        if 'img_preds' in results:
            return self.img_bbox_head.get_bboxes(
                results['img_preds'], batch['img_meta']['img_shape'])
        return self.pts_bbox_head_joint.get_bboxes(batch['points'],
                                                   results['joint'])


@DETECTORS.register_module()
class ImVoteNet(ImVoteNet_Deformdetr):
    """The ImVoteNet baseline: the Faster R-CNN 2D branch (frozen, in eval
    mode) and the fusion of ``ImVoteNet_Deformdetr``; without points the
    Faster R-CNN alone, trained and served."""

    img_branch = ('img_backbone', 'img_neck', 'img_rpn_head', 'img_roi_head')

    @property
    def synth_batch(self):
        """A scene at the size Resize (1333, 600) + Pad 32 gives a 530x730
        SUN RGB-D frame; without a point branch its image and 2D boxes."""
        if self.pts_backbone is None:
            return ('detr2d', 16, 64, dict(hw=(608, 832)))
        return ('demf', 16, 64, dict(hw=(608, 832), valid_hw=(600, 826)))

    def _build_2d_heads(self, img_bbox_head=None, img_rpn_head=None,
                        img_roi_head=None):
        train_cfg, test_cfg = self.train_cfg or {}, self.test_cfg or {}
        self.img_rpn_head = build_from_cfg(dict(
            img_rpn_head, train_cfg=train_cfg.get('img_rpn'),
            test_cfg=test_cfg.get('img_rpn')), HEADS)
        self.img_roi_head = build_from_cfg(dict(
            img_roi_head, train_cfg=train_cfg.get('img_rcnn'),
            test_cfg=test_cfg.get('img_rcnn')), HEADS)
        self.box_score_thr = dict(test_cfg.get('img_rcnn') or {}).get(
            'score_thr', 0.05)

    def _cfg(self, train, key):
        return dict(((self.train_cfg if train else self.test_cfg) or {}).get(
            key) or {})

    def detect_2d(self, img, meta):
        """RPN proposals -> RoI head -> its per-class detections."""
        feats = self.extract_img_feat(img)
        img_shape = meta['img_shape']
        proposals, _, p_valid = self.img_rpn_head.get_proposals(
            self.img_rpn_head(feats), img_shape, self._cfg(False, 'img_rpn'))
        cls_logits, bbox_deltas = self.img_roi_head(feats, proposals)
        return self.img_roi_head.get_bboxes(cls_logits, bbox_deltas,
                                            proposals, p_valid, img_shape)

    def forward_img_only(self, batch, generator=None, draws=None):
        """The Faster R-CNN alone.  Training (with ``gt_bboxes``): the RPN
        on every level, proposals of ``train_cfg.img_rpn_proposal`` without
        a graph, ``sample_rcnn_rois`` and the RoI head on the sampled RoIs
        -> dict(rpn_outs, rpn_draws, rcnn_sampled, rcnn_cls, rcnn_deltas).
        Otherwise the proposals (of ``test_cfg.img_rpn`` in eval mode) and
        the RoI head on all of them -> dict(rpn_outs, proposals,
        proposal_valid, rcnn_cls, rcnn_deltas).  The samplers' uniforms:
        ``draws`` by the names of ``FRCNN_DRAWS``, the rest from
        ``generator`` in that order."""
        feats = self.extract_img_feat(batch['img'])
        outs = self.img_rpn_head(feats)
        results = dict(rpn_outs=outs)
        train = self.training and 'gt_bboxes' in batch
        with torch.no_grad():
            proposals, _, p_valid = self.img_rpn_head.get_proposals(
                outs, batch['img_meta']['img_shape'], self._cfg(
                    self.training, 'img_rpn_proposal' if self.training
                    else 'img_rpn'))
        if not train:
            cls_logits, bbox_deltas = self.img_roi_head(feats, proposals)
            return dict(results, proposals=proposals,
                        proposal_valid=p_valid, rcnn_cls=cls_logits,
                        rcnn_deltas=bbox_deltas)
        b = proposals.shape[0]
        sizes = dict.fromkeys(FRCNN_DRAWS[:2], (b, sum(
            c.shape[1] * c.shape[2] * c.shape[3] for c, _ in outs)))
        sizes.update(dict.fromkeys(FRCNN_DRAWS[2:], (
            b, proposals.shape[1] + batch['gt_bboxes'].shape[1])))
        draws = dict(draws or {})
        if generator is None and set(draws) != set(FRCNN_DRAWS):
            raise ValueError('the image-only training samples on a '
                             'torch.Generator (or the draws)')
        for name in FRCNN_DRAWS:
            if name not in draws:
                draws[name] = torch.rand(sizes[name], generator=generator,
                                         device=proposals.device)
        sampled = sample_rcnn_rois(
            proposals, p_valid, batch['gt_bboxes'], batch['gt_labels'],
            batch['gt_bboxes_valid'], self._cfg(True, 'img_rcnn'),
            self.img_roi_head.num_classes, u_pos=draws['rcnn_pos'],
            u_neg=draws['rcnn_neg'], u_order=draws['rcnn_order'])
        cls_logits, bbox_deltas = self.img_roi_head(feats, sampled['rois'])
        return dict(results, rpn_draws=(draws['rpn_pos'], draws['rpn_neg']),
                    rcnn_sampled=sampled, rcnn_cls=cls_logits,
                    rcnn_deltas=bbox_deltas)

    def loss(self, results, batch):
        """The image-only training's RPN and R-CNN losses
        (``loss_rpn_cls``, ``loss_rpn_bbox``, ``loss_cls``, ``loss_bbox``),
        else the fusion's."""
        if 'rpn_outs' not in results:
            return ImVoteNet_Deformdetr.loss(self, results, batch)
        rpn = self.img_rpn_head
        losses = rpn_loss(
            results['rpn_outs'], rpn.anchor_generator, rpn.bbox_coder,
            batch['gt_bboxes'], batch['gt_bboxes_valid'],
            self._cfg(True, 'img_rpn'), rpn.loss_cls_cfg, rpn.loss_bbox_cfg,
            *results['rpn_draws'])
        head = self.img_roi_head.head_cfg
        losses.update(rcnn_loss(
            results['rcnn_cls'], results['rcnn_deltas'],
            results['rcnn_sampled'], dict(head['bbox_coder']),
            self.img_roi_head.num_classes, dict(head['loss_cls']),
            dict(head['loss_bbox'])))
        return losses

    def get_bboxes(self, results, batch):
        """The image-only inference's R-CNN detections (dict(bboxes (B, K,
        5), labels, valid)), else the joint tower's."""
        if 'proposals' in results:
            return self.img_roi_head.get_bboxes(
                results['rcnn_cls'], results['rcnn_deltas'],
                results['proposals'], results['proposal_valid'],
                batch['img_meta']['img_shape'])
        return ImVoteNet_Deformdetr.get_bboxes(self, results, batch)
