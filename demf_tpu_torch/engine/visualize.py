"""Detection visualization: Wavefront .obj dumps per scene (port of
``demf_tpu/engine/visualize.py``, byte for byte the same files).

The ``--show / --show-dir`` eval surface (mmdet3d
``Base3DDetector.show_results``) writes ``{name}_points.obj`` /
``{name}_gt.obj`` / ``{name}_pred.obj`` per scene for any mesh viewer; no
window is opened (headless hosts), and ``--show`` without ``--show-dir``
saves to ``./show_results``.  Host numpy after inference; the box corners
come from ``core/boxes.py::box_corners`` on the CPU in float32.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..core.boxes import box_corners

# box_corners layout: 12 edges of a 7-dof upright box's corner set
_EDGES = ((0, 1), (1, 2), (2, 3), (3, 0), (4, 5), (5, 6), (6, 7), (7, 4),
          (0, 4), (1, 5), (2, 6), (3, 7))


def write_obj_points(path, points):
    """points: (N, 3[+3]) xyz or xyzrgb."""
    points = np.asarray(points)
    with open(path, 'w') as f:
        for p in points:
            if p.shape[0] >= 6:
                f.write(f'v {p[0]:.4f} {p[1]:.4f} {p[2]:.4f} '
                        f'{p[3]:.3f} {p[4]:.3f} {p[5]:.3f}\n')
            else:
                f.write(f'v {p[0]:.4f} {p[1]:.4f} {p[2]:.4f}\n')


def write_obj_boxes(path, boxes):
    """boxes: (G, 7) depth boxes -> wireframe obj (8 verts + 12 lines each)."""
    boxes = np.asarray(boxes, np.float32).reshape(-1, 7)
    with open(path, 'w') as f:
        if len(boxes) == 0:
            return
        corners = box_corners(torch.from_numpy(boxes)).numpy()  # (G, 8, 3)
        for c8 in corners:
            for v in c8:
                f.write(f'v {v[0]:.4f} {v[1]:.4f} {v[2]:.4f}\n')
        for g in range(len(boxes)):
            base = 1 + 8 * g
            for a, b in _EDGES:
                f.write(f'l {base + a} {base + b}\n')


def show_result(points, gt_boxes, pred_boxes, out_dir, name):
    """One scene -> {name}_points.obj / _gt.obj / _pred.obj in out_dir."""
    os.makedirs(out_dir, exist_ok=True)
    if points is not None:
        write_obj_points(os.path.join(out_dir, f'{name}_points.obj'),
                         points)
    if gt_boxes is not None:
        write_obj_boxes(os.path.join(out_dir, f'{name}_gt.obj'), gt_boxes)
    if pred_boxes is not None:
        write_obj_boxes(os.path.join(out_dir, f'{name}_pred.obj'),
                        pred_boxes)


def show_dataset_results(dataset, results, out_dir, score_thr=0.1):
    """Dump per-scene visualizations for an eval run.

    results: list per scene of dict(boxes_3d, scores_3d, labels_3d)
    (the ``run_dataset_inference`` output contract).
    """
    gts = dataset.get_gt_annos()
    for i, (res, gt) in enumerate(zip(results, gts)):
        scores = np.asarray(res.get('scores_3d', []))
        boxes = np.asarray(res.get('boxes_3d', np.zeros((0, 7))))
        keep = scores >= score_thr if len(scores) else \
            np.zeros((0,), bool)
        sample = dataset[i]
        pts = sample.get('points') if isinstance(sample, dict) else None
        show_result(pts, gt.get('gt_boxes'), boxes[keep], out_dir,
                    f'{i:06d}')
    return out_dir
