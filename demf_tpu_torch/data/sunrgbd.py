"""SUN RGB-D dataset + synthetic stand-in (the port's copy of
``demf_tpu/data/sunrgbd.py``, numpy only).

mmdet3d's ``SUNRGBDDataset`` as configured at
configs/_base_/datasets/sunrgbd-3d-10class.py: pkl info files + per-scene
point ``.bin`` + jpg, declarative pipeline, ``RepeatDataset``, and
``evaluate()`` -> indoor mAP.  ``SyntheticSUNRGBD`` makes the same scenes
as the original from the same seed.
"""
from __future__ import annotations

import os
import pickle
from typing import Any, Dict, List

import numpy as np

from ..core.eval3d import indoor_eval
from ..registry import DATASETS, build_from_cfg
from .pipeline import Compose

SUNRGBD_CLASSES = ('bed', 'table', 'sofa', 'chair', 'toilet', 'desk',
                   'dresser', 'night_stand', 'bookshelf', 'bathtub')

# depth -> camera axis permutation used by the SUN RGB-D calib convention
# (x right, y down, z forward from x right, y forward, z up)
_DEPTH2CAM = np.array([[1, 0, 0], [0, 0, -1], [0, 1, 0]], np.float32)


# corner offsets in units of the box size, in the order of
# ``core.boxes.box_corners`` (mmdet3d 0.18), about the bottom center
_CORNERS_NORM = (np.stack(np.unravel_index(np.arange(8), [2] * 3), axis=1)[
    [0, 1, 3, 2, 4, 5, 7, 6]] - np.array([0.5, 0.5, 0.0])).astype(np.float32)


def _box_corners(boxes):
    """(G, 7) float32 boxes -> (G, 8, 3) corners, as
    ``core.boxes.box_corners`` (x' = x cos + y sin, y' = -x sin + y cos),
    in float32 numpy."""
    boxes = np.asarray(boxes, np.float32)
    local = boxes[:, None, 3:6] * _CORNERS_NORM
    c = np.cos(boxes[:, 6])[:, None]
    s = np.sin(boxes[:, 6])[:, None]
    x, y = local[..., 0], local[..., 1]
    rotated = np.stack([x * c + y * s, -x * s + y * c, local[..., 2]], -1)
    return rotated + boxes[:, None, :3]


@DATASETS.register_module()
class SUNRGBDDataset:
    """Reads mmdet3d-format sunrgbd_infos_{train,val}.pkl."""

    def __init__(self, data_root, ann_file, pipeline=None, classes=None,
                 test_mode=False, box_type_3d='Depth', filter_empty_gt=True,
                 modality=None, **kwargs):
        self.data_root = data_root
        self.CLASSES = tuple(classes) if classes else SUNRGBD_CLASSES
        self.test_mode = test_mode
        self.filter_empty_gt = filter_empty_gt
        with open(ann_file, 'rb') as f:
            self.infos = pickle.load(f)
        if filter_empty_gt and not test_mode:
            # mmdet3d Custom3DDataset drops annotation-less scenes during
            # training (reference configs/_base_/datasets/
            # sunrgbd-3d-10class.py:62 filter_empty_gt default True)
            self.infos = [info for info in self.infos
                          if self._num_valid_gt(info) > 0]
        self.pipeline = Compose(pipeline) if pipeline else None

    def _num_valid_gt(self, info):
        annos = info.get('annos', {})
        n = int(annos.get('gt_num', len(annos.get('name', []))))
        if n == 0:
            return 0
        if 'class' in annos:
            return n
        return sum(1 for nm in annos['name'] if nm in self.CLASSES)

    def __len__(self):
        return len(self.infos)

    def get_data_info(self, index) -> Dict[str, Any]:
        info = self.infos[index]
        pts_path = info['pts_path'] if 'pts_path' in info else \
            info['point_cloud']['lidar_idx']
        sample = dict(
            pts_filename=os.path.join(self.data_root, pts_path),
            sample_idx=index,
            transformation_3d_flow=[],
        )
        if 'image' in info:
            sample['img_filename'] = os.path.join(
                self.data_root, info['image']['image_path'])
        if 'calib' in info:
            k = np.asarray(info['calib']['K'], np.float32).reshape(3, 3)
            rt = np.asarray(info['calib']['Rt'], np.float32).reshape(3, 3)
            depth2img = k @ (_DEPTH2CAM @ rt.T)
            mat = np.eye(4, dtype=np.float32)
            mat[:3, :3] = depth2img
            sample['depth2img'] = mat
        annos = info.get('annos', {})
        n = int(annos.get('gt_num', len(annos.get('name', []))))
        if n > 0:
            boxes = np.asarray(annos['gt_boxes_upright_depth'],
                               np.float32).reshape(-1, 7)
            if 'class' in annos:
                labels = np.asarray(annos['class'], np.int64)
            else:
                labels = np.asarray(
                    [self.CLASSES.index(nm) for nm in annos['name']],
                    np.int64)
            bboxes_2d = np.asarray(
                annos.get('bbox', np.zeros((n, 4))), np.float32)
        else:
            boxes = np.zeros((0, 7), np.float32)
            labels = np.zeros((0,), np.int64)
            bboxes_2d = np.zeros((0, 4), np.float32)
        sample['ann_info'] = dict(gt_bboxes_3d=boxes, gt_labels_3d=labels,
                                  bboxes=bboxes_2d, labels=labels)
        return sample

    def __getitem__(self, index):
        sample = self.get_data_info(index)
        if self.pipeline:
            sample = self.pipeline(sample)
        return sample

    def get_gt_annos(self) -> List[Dict[str, np.ndarray]]:
        out = []
        for info in self.infos:
            annos = info.get('annos', {})
            n = int(annos.get('gt_num', len(annos.get('name', []))))
            if n > 0:
                boxes = np.asarray(annos['gt_boxes_upright_depth'],
                                   np.float32).reshape(-1, 7)
                if 'class' in annos:
                    labels = np.asarray(annos['class'], np.int64)
                else:
                    labels = np.asarray(
                        [self.CLASSES.index(nm) for nm in annos['name']],
                        np.int64)
            else:
                boxes = np.zeros((0, 7), np.float32)
                labels = np.zeros((0,), np.int64)
            out.append(dict(gt_boxes=boxes, gt_labels=labels))
        return out

    def evaluate(self, results, metric='mAP', iou_thr=(0.25, 0.5),
                 logger=None, **kwargs):
        """results: list per scene of dict(boxes_3d, scores_3d, labels_3d)
        (numpy, already validity-filtered)."""
        return indoor_eval(self.get_gt_annos(), results,
                           iou_thresholds=tuple(iou_thr),
                           class_names=self.CLASSES, logger=logger)

    def format_results(self, results, pklfile_prefix=None, **kwargs):
        """Write results to ``<prefix>.pkl`` (mmdet3d
        ``Custom3DDataset.format_results``): one record per scene
        with boxes/scores/labels plus sample_idx and class names, so
        downstream tooling can consume them without the dataset object.

        Returns ``(results, out_file)``.
        """
        import tempfile
        if pklfile_prefix is None:
            pklfile_prefix = os.path.join(tempfile.mkdtemp(), 'results')
        d = os.path.dirname(os.path.abspath(str(pklfile_prefix)))
        os.makedirs(d, exist_ok=True)
        out = []
        for i, r in enumerate(results):
            rec = {k: np.asarray(v) for k, v in r.items()}
            rec['sample_idx'] = (self.infos[i]['image']['image_idx']
                                 if i < len(self.infos) and
                                 'image' in self.infos[i] else i)
            out.append(rec)
        out_file = str(pklfile_prefix) + '.pkl'
        with open(out_file, 'wb') as f:
            pickle.dump(dict(results=out, classes=list(self.CLASSES)), f)
        return results, out_file


@DATASETS.register_module()
class RepeatDataset:
    def __init__(self, dataset, times=1, **kwargs):
        if isinstance(dataset, dict):
            dataset = build_from_cfg(dataset, DATASETS)
        self.dataset = dataset
        self.times = times
        self.CLASSES = getattr(dataset, 'CLASSES', None)

    def __len__(self):
        return len(self.dataset) * self.times

    def __getitem__(self, index):
        return self.dataset[index % len(self.dataset)]

    def evaluate(self, *args, **kwargs):
        return self.dataset.evaluate(*args, **kwargs)

    def format_results(self, *args, **kwargs):
        return self.dataset.format_results(*args, **kwargs)


@DATASETS.register_module()
class SyntheticSUNRGBD:
    """Deterministic synthetic scenes in SUN RGB-D format.

    Used for end-to-end tests and throughput benchmarks (no dataset download
    in this environment).  Scenes contain a floor plane plus points sampled
    on a few labeled boxes, so a detector can actually (over)fit.
    """

    # class-colored rendering palette (render_boxes=True)
    PALETTE = np.array(
        [[230, 30, 30], [30, 230, 30], [30, 30, 230], [230, 230, 30],
         [230, 30, 230], [30, 230, 230], [230, 140, 30], [140, 30, 230],
         [30, 140, 140], [140, 140, 30]], np.uint8)

    def __init__(self, num_scenes=64, num_raw_points=24000, max_boxes=8,
                 image_hw=(480, 640), pipeline=None, classes=None, seed=0,
                 test_mode=False, render_boxes=False, **kwargs):
        self.num_scenes = num_scenes
        self.num_raw_points = num_raw_points
        self.max_boxes = max_boxes
        self.image_hw = image_hw
        self.seed = seed
        self.CLASSES = tuple(classes) if classes else SUNRGBD_CLASSES
        self.pipeline = Compose(pipeline) if pipeline else None
        self.test_mode = test_mode
        # render_boxes: draw each gt box's projected 2D rectangle filled
        # with a class-specific color, so the image actually carries
        # class+location evidence at the fusion head's reference points
        # (used by the DeMF / ImVoteNet learning proofs,
        # tools/overfit_check.py; mirrors tools/overfit_2d.py's scenes)
        self.render_boxes = render_boxes

    def __len__(self):
        return self.num_scenes

    def _gen_scene(self, index):
        rng = np.random.RandomState(self.seed * 100003 + index)
        ng = rng.randint(1, self.max_boxes + 1)
        boxes = np.zeros((ng, 7), np.float32)
        boxes[:, 0] = rng.uniform(-3, 3, ng)
        boxes[:, 1] = rng.uniform(1, 6, ng)
        boxes[:, 2] = rng.uniform(-1.2, 0.2, ng)
        boxes[:, 3:6] = rng.uniform(0.4, 1.8, (ng, 3))
        boxes[:, 6] = rng.uniform(-np.pi, np.pi, ng)
        labels = rng.randint(0, len(self.CLASSES), ng).astype(np.int64)

        n_obj = self.num_raw_points // 2
        per = n_obj // ng
        pts = []
        for i in range(ng):
            local = (rng.rand(per, 3) - 0.5) * boxes[i, 3:6]
            c, s = np.cos(boxes[i, 6]), np.sin(boxes[i, 6])
            world = np.stack([
                local[:, 0] * c + local[:, 1] * s,
                -local[:, 0] * s + local[:, 1] * c,
                local[:, 2] + boxes[i, 5] / 2], 1)
            pts.append(world + boxes[i, :3] * np.array([1, 1, 1]))
        n_bg = self.num_raw_points - per * ng
        bg = np.stack([rng.uniform(-4, 4, n_bg), rng.uniform(0, 7, n_bg),
                       np.full(n_bg, -1.3)], 1)
        points = np.concatenate(pts + [bg], 0).astype(np.float32)
        # mimic the raw 6-dim bin layout (xyz + rgb)
        raw = np.concatenate(
            [points, rng.rand(len(points), 3).astype(np.float32)], 1)

        h, w = self.image_hw
        img = (rng.rand(h, w, 3) * 255).astype(np.uint8)
        k = np.array([[520., 0, w / 2], [0, 520., h / 2], [0, 0, 1]],
                     np.float32)
        rt = np.eye(3, dtype=np.float32)
        depth2img = k @ (_DEPTH2CAM @ rt.T)
        mat = np.eye(4, dtype=np.float32)
        mat[:3, :3] = depth2img
        if self.render_boxes:
            img = (rng.rand(h, w, 3) * 40 + 108).astype(np.uint8)  # gray bg
            boxes2d, keep = self._project_boxes_2d(boxes, mat, (h, w))
            for i in np.argsort(-boxes[:, 1]):      # far-to-near overdraw
                if not keep[i]:
                    continue
                x1, y1, x2, y2 = boxes2d[i].astype(np.int32)
                img[y1:y2 + 1, x1:x2 + 1] = self.PALETTE[labels[i] % 10]
        return raw, img, mat, boxes, labels

    @staticmethod
    def _project_boxes_2d(boxes, depth2img, hw):
        """3D box corners -> clipped 2D xyxy boxes (for the 2D branches)."""
        corners = _box_corners(boxes)  # (G, 8, 3)
        hom = np.concatenate([corners, np.ones_like(corners[..., :1])], -1)
        p2d = hom @ depth2img.T
        z = np.clip(p2d[..., 2], 1e-3, None)
        uv = p2d[..., :2] / z[..., None]
        h, w = hw
        x1 = uv[..., 0].min(-1).clip(0, w - 1)
        y1 = uv[..., 1].min(-1).clip(0, h - 1)
        x2 = uv[..., 0].max(-1).clip(0, w - 1)
        y2 = uv[..., 1].max(-1).clip(0, h - 1)
        boxes2d = np.stack([x1, y1, x2, y2], -1).astype(np.float32)
        keep = (x2 - x1 > 2) & (y2 - y1 > 2)
        return boxes2d, keep

    def __getitem__(self, index):
        raw, img, depth2img, boxes, labels = self._gen_scene(index)
        boxes2d, keep2d = self._project_boxes_2d(boxes, depth2img,
                                                 self.image_hw)
        sample = dict(
            raw_points=raw, raw_img=img, depth2img=depth2img,
            sample_idx=index, transformation_3d_flow=[],
            ann_info=dict(gt_bboxes_3d=boxes, gt_labels_3d=labels,
                          bboxes=boxes2d[keep2d],
                          labels=labels[keep2d]))
        if self.pipeline:
            sample = self.pipeline(sample)
        return sample

    def get_gt_annos(self):
        out = []
        for i in range(self.num_scenes):
            _, _, _, boxes, labels = self._gen_scene(i)
            out.append(dict(gt_boxes=boxes, gt_labels=labels))
        return out

    def evaluate(self, results, metric='mAP', iou_thr=(0.25, 0.5),
                 logger=None, **kwargs):
        return indoor_eval(self.get_gt_annos(), results,
                           iou_thresholds=tuple(iou_thr),
                           class_names=self.CLASSES, logger=logger)
