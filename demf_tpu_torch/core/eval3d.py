"""Indoor 3D detection mAP evaluation (SUN RGB-D protocol), host numpy.

The port's copy of ``demf_tpu/core/eval3d.py`` (numpy only on both sides;
``tests/test_torch_eval3d.py`` holds the two equal): the metric that
``dataset.evaluate(metric='mAP')`` reports, as mmdet3d's ``indoor_eval``:
per-class AP at IoU 0.25/0.5 with rotated-box 3D IoU, VOC 'area' AP
interpolation, and greedy per-scene matching of score-sorted detections.

3D IoU follows mmdet3d-0.18: BEV intersection of yaw-rotated rectangles
(exact convex-polygon clipping here instead of the CUDA ``box_iou_rotated``
reconstruction) times the z-extent overlap, over the volume union.
"""
from __future__ import annotations

import numpy as np


def _bev_corners(boxes):
    """(N, 7) -> (N, 4, 2) BEV polygon corners, consistent with
    ``core.boxes.box_corners``' rotation convention."""
    x, y = boxes[:, 0], boxes[:, 1]
    dx, dy = boxes[:, 3], boxes[:, 4]
    yaw = boxes[:, 6]
    # local corners
    lx = np.stack([-dx / 2, dx / 2, dx / 2, -dx / 2], -1)
    ly = np.stack([-dy / 2, -dy / 2, dy / 2, dy / 2], -1)
    c, s = np.cos(yaw)[:, None], np.sin(yaw)[:, None]
    # rotation_3d_in_axis convention: x' = x c + y s; y' = -x s + y c
    wx = lx * c + ly * s + x[:, None]
    wy = -lx * s + ly * c + y[:, None]
    return np.stack([wx, wy], -1)


def _polygon_clip(subject, clip):
    """Sutherland–Hodgman clipping of polygon ``subject`` by convex ``clip``.

    Both (K, 2) arrays in CCW or CW consistent order.  Returns list of pts.
    """
    def inside(p, a, b):
        return (b[0] - a[0]) * (p[1] - a[1]) - (b[1] - a[1]) * (p[0] - a[0]) >= 0

    def intersect(p1, p2, a, b):
        dxc = p1[0] - p2[0]
        dyc = p1[1] - p2[1]
        dxp = a[0] - b[0]
        dyp = a[1] - b[1]
        n1 = p1[0] * p2[1] - p1[1] * p2[0]
        n2 = a[0] * b[1] - a[1] * b[0]
        denom = dxc * dyp - dyc * dxp
        if abs(denom) < 1e-12:
            return p2
        return ((n1 * dxp - dxc * n2) / denom, (n1 * dyp - dyc * n2) / denom)

    output = [tuple(p) for p in subject]
    k = len(clip)
    for i in range(k):
        a, b = tuple(clip[i]), tuple(clip[(i + 1) % k])
        input_list = output
        output = []
        if not input_list:
            break
        prev = input_list[-1]
        for cur in input_list:
            if inside(cur, a, b):
                if not inside(prev, a, b):
                    output.append(intersect(prev, cur, a, b))
                output.append(cur)
            elif inside(prev, a, b):
                output.append(intersect(prev, cur, a, b))
            prev = cur
    return output


def _poly_area(pts):
    if len(pts) < 3:
        return 0.0
    arr = np.asarray(pts)
    x, y = arr[:, 0], arr[:, 1]
    return 0.5 * abs(np.dot(x, np.roll(y, 1)) - np.dot(y, np.roll(x, 1)))


def _ccw(poly):
    """Ensure counter-clockwise orientation for the clipper."""
    arr = np.asarray(poly)
    x, y = arr[:, 0], arr[:, 1]
    signed = 0.5 * (np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))
    return arr if signed > 0 else arr[::-1]


def rotated_iou_3d(boxes1, boxes2):
    """Exact 3D IoU of yaw-rotated depth boxes. (N, 7) x (M, 7) -> (N, M)."""
    n, m = len(boxes1), len(boxes2)
    if n == 0 or m == 0:
        return np.zeros((n, m))
    b1 = _bev_corners(boxes1)
    b2 = _bev_corners(boxes2)
    vol1 = boxes1[:, 3:6].prod(-1)
    vol2 = boxes2[:, 3:6].prod(-1)
    zmin1, zmax1 = boxes1[:, 2], boxes1[:, 2] + boxes1[:, 5]
    zmin2, zmax2 = boxes2[:, 2], boxes2[:, 2] + boxes2[:, 5]
    iou = np.zeros((n, m))
    for i in range(n):
        p1 = _ccw(b1[i])
        for j in range(m):
            hz = min(zmax1[i], zmax2[j]) - max(zmin1[i], zmin2[j])
            if hz <= 0:
                continue
            inter2d = _poly_area(_polygon_clip(_ccw(b2[j]), p1))
            inter = inter2d * hz
            union = vol1[i] + vol2[j] - inter
            if union > 1e-8:
                iou[i, j] = inter / union
    return iou


def average_precision(recalls, precisions, mode='area'):
    """VOC AP (mmdet3d 'area' mode)."""
    recalls = np.asarray(recalls)
    precisions = np.asarray(precisions)
    if mode == 'area':
        mrec = np.concatenate([[0.], recalls, [1.]])
        mpre = np.concatenate([[0.], precisions, [0.]])
        for i in range(len(mpre) - 2, -1, -1):
            mpre[i] = max(mpre[i], mpre[i + 1])
        idx = np.where(mrec[1:] != mrec[:-1])[0]
        return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))
    if mode == '11points':
        ap = 0.
        for t in np.arange(0, 1.01, 0.1):
            prec = precisions[recalls >= t]
            ap += (prec.max() if prec.size else 0.) / 11.
        return float(ap)
    raise ValueError(mode)


def eval_det_cls(pred_by_scene, gt_by_scene, iou_thresholds):
    """Per-class evaluation.

    Args:
        pred_by_scene: {scene_id: (boxes (K,7), scores (K,))}.
        gt_by_scene: {scene_id: boxes (G, 7)}.
        iou_thresholds: list of IoU thresholds.
    Returns:
        {thr: (recall, precision, ap)}.
    """
    total_gt = sum(len(g) for g in gt_by_scene.values())
    records = []  # (score, scene_id, det_index)
    iou_cache = {}
    for sid, (boxes, scores) in pred_by_scene.items():
        gts = gt_by_scene.get(sid, np.zeros((0, 7)))
        iou_cache[sid] = rotated_iou_3d(np.asarray(boxes), np.asarray(gts))
        for k, s in enumerate(scores):
            records.append((float(s), sid, k))
    records.sort(key=lambda r: -r[0])

    out = {}
    for thr in iou_thresholds:
        matched = {sid: np.zeros(len(g), bool) for sid, g in
                   gt_by_scene.items()}
        tp = np.zeros(len(records))
        fp = np.zeros(len(records))
        for r, (score, sid, k) in enumerate(records):
            ious = iou_cache[sid]
            if ious.shape[1] == 0:
                fp[r] = 1
                continue
            j = int(np.argmax(ious[k]))
            # mmdet3d indoor_eval uses a STRICT > threshold test
            if ious[k, j] > thr and not matched[sid][j]:
                matched[sid][j] = True
                tp[r] = 1
            else:
                fp[r] = 1
        tp_cum = np.cumsum(tp)
        fp_cum = np.cumsum(fp)
        recall = tp_cum / max(total_gt, 1)
        precision = tp_cum / np.maximum(tp_cum + fp_cum, np.finfo(float).eps)
        ap = average_precision(recall, precision)
        out[thr] = (recall[-1] if len(recall) else 0., precision, ap)
    return out


def indoor_eval(gt_annos, det_results, iou_thresholds=(0.25, 0.5),
                class_names=None, logger=None):
    """Dataset-level indoor mAP.

    Args:
        gt_annos: list per scene of dict(gt_boxes (G, 7), gt_labels (G,)).
        det_results: list per scene of dict(boxes_3d (K, 7), scores_3d (K,),
            labels_3d (K,)) — already validity-filtered, numpy.
        class_names: tuple of class names.
    Returns:
        flat dict of per-class AP + mAP per threshold (mmdet3d key style).
    """
    num_classes = len(class_names)
    results = {}
    aps = {thr: [] for thr in iou_thresholds}
    for cls in range(num_classes):
        pred_by_scene = {}
        gt_by_scene = {}
        for sid, (gt, det) in enumerate(zip(gt_annos, det_results)):
            gmask = np.asarray(gt['gt_labels']) == cls
            gt_by_scene[sid] = np.asarray(gt['gt_boxes'])[gmask]
            dmask = np.asarray(det['labels_3d']) == cls
            pred_by_scene[sid] = (np.asarray(det['boxes_3d'])[dmask],
                                  np.asarray(det['scores_3d'])[dmask])
        has_gt = any(len(g) for g in gt_by_scene.values())
        if not has_gt:
            continue
        cls_res = eval_det_cls(pred_by_scene, gt_by_scene, iou_thresholds)
        name = class_names[cls]
        for thr in iou_thresholds:
            _, _, ap = cls_res[thr]
            results[f'{name}_AP_{thr:.2f}'] = ap
            aps[thr].append(ap)
    for thr in iou_thresholds:
        results[f'mAP_{thr:.2f}'] = float(np.mean(aps[thr])) if aps[thr] else 0.
    if logger:
        logger(str(results))
    return results
