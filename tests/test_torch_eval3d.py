"""The port's ``core/eval3d.py`` (numpy) against the JAX package's: the
golden cases of ``tests/test_eval3d.py`` and ``tests/test_eval3d_golden.py``
value for value, and seeded random detections, equal to 1e-6 (both sides
are float64 numpy: they come out equal to the last bit)."""
import numpy as np
import pytest
from test_eval3d_golden import (_grid_iou_3d, _mm_eval_det_cls,
                                _random_scene)

from demf_tpu.core import eval3d as jeval
from demf_tpu_torch.core import eval3d as peval

TOL = 1e-6


def random_boxes(rng, n):
    return np.concatenate([rng.uniform(-2, 2, (n, 3)),
                           rng.uniform(0.4, 1.5, (n, 3)),
                           rng.uniform(-np.pi, np.pi, (n, 1))], 1)


def random_dataset(seed, n_scenes=5, n_classes=3, empty_scene=True):
    """gt_annos and det_results as ``indoor_eval`` takes them, with
    detections near the GT boxes and elsewhere, and one scene without GT."""
    rng = np.random.RandomState(seed)
    gt_annos, det_results = [], []
    for sid in range(n_scenes):
        gts, dets = _random_scene(
            rng, 0 if (empty_scene and sid == 1) else rng.randint(1, 6),
            rng.randint(0, 12))
        gt_annos.append(dict(
            gt_boxes=np.stack(gts) if gts else np.zeros((0, 7)),
            gt_labels=rng.randint(0, n_classes, len(gts))))
        det_results.append(dict(
            boxes_3d=(np.stack([b for b, _ in dets]) if dets
                      else np.zeros((0, 7))),
            scores_3d=np.array([s for _, s in dets]),
            labels_3d=rng.randint(0, n_classes, len(dets))))
    return gt_annos, det_results


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_rotated_iou_equals_original(seed):
    rng = np.random.RandomState(seed)
    a, b = random_boxes(rng, 7), random_boxes(rng, 5)
    b[0] = a[0]                                   # an identical pair
    b[1, :3] += 50                                # a disjoint one
    got, want = peval.rotated_iou_3d(a, b), jeval.rotated_iou_3d(a, b)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    assert abs(got[0, 0] - 1) < 1e-6 and (got[:, 1] == 0).all()
    assert peval.rotated_iou_3d(a[:0], b).shape == (0, 5)


def test_rotated_iou_golden_values():
    """The cases of tests/test_eval3d.py, and the rasterized oracle of
    tests/test_eval3d_golden.py on yaw-rotated boxes."""
    iou = peval.rotated_iou_3d
    b = np.array([[0, 0, 0, 2, 1, 1, 0.3]])
    np.testing.assert_allclose(iou(b, b), [[1.0]], atol=1e-6)
    np.testing.assert_allclose(
        iou(b, np.array([[10, 10, 10, 2, 1, 1, 0.0]])), [[0.0]])
    a = np.array([[0, 0, 0, 2, 2, 2, 0.0]])
    np.testing.assert_allclose(iou(a, a + [1, 0, 0, 0, 0, 0, 0]), [[4 / 12]],
                               atol=1e-6)
    c = np.array([[0, 0, 0, 4, 2, 1, 0.0]])
    np.testing.assert_allclose(iou(c, c + [0, 0, 0, 0, 0, 0, np.pi / 2]),
                               [[4 / 12]], atol=1e-5)
    rng = np.random.RandomState(11)
    for _ in range(4):
        p = random_boxes(rng, 1)
        q = p + np.concatenate([rng.uniform(-0.4, 0.4, 3), np.zeros(3),
                                rng.uniform(-0.6, 0.6, 1)])
        assert abs(iou(p, q)[0, 0] - _grid_iou_3d(p, q)[0, 0]) < 0.02


@pytest.mark.parametrize('mode', ['area', '11points'])
def test_average_precision_equals_original(mode):
    rng = np.random.RandomState(5)
    rec = np.sort(rng.rand(20))
    prec = rng.rand(20)
    assert abs(peval.average_precision(rec, prec, mode) -
               jeval.average_precision(rec, prec, mode)) <= TOL
    assert abs(peval.average_precision(np.array([0.5, 1.0]),
                                       np.array([1.0, 1.0])) - 1.0) < 1e-6
    with pytest.raises(ValueError):
        peval.average_precision(rec, prec, 'other')


@pytest.mark.parametrize('seed', [7, 8])
def test_eval_det_cls_equals_original_and_mmdet3d_transcription(seed):
    rng = np.random.RandomState(seed)
    thresholds = [0.25, 0.5]
    pred_mm, gt_mm, pred, gt = {}, {}, {}, {}
    for sid in range(6):
        gts, dets = _random_scene(rng, rng.randint(0, 4), rng.randint(0, 7))
        gt_mm[sid], pred_mm[sid] = gts, dets
        gt[sid] = np.stack(gts) if gts else np.zeros((0, 7))
        pred[sid] = (np.stack([b for b, _ in dets]) if dets
                     else np.zeros((0, 7)), np.array([s for _, s in dets]))
    got = peval.eval_det_cls(pred, gt, thresholds)
    want = jeval.eval_det_cls(pred, gt, thresholds)
    ref = _mm_eval_det_cls(pred_mm, gt_mm, thresholds, peval.rotated_iou_3d)
    for thr in thresholds:
        assert abs(got[thr][0] - want[thr][0]) <= TOL
        np.testing.assert_allclose(got[thr][1], want[thr][1], rtol=0,
                                   atol=TOL)
        assert abs(got[thr][2] - want[thr][2]) <= TOL
        np.testing.assert_allclose(got[thr][2], ref[thr][2], atol=1e-9)


@pytest.mark.parametrize('seed', [3, 4, 5])
def test_indoor_eval_equals_original(seed):
    gt_annos, det_results = random_dataset(seed)
    names = ('a', 'b', 'c')
    lines = []
    got = peval.indoor_eval(gt_annos, det_results, (0.25, 0.5), names,
                            logger=lines.append)
    want = jeval.indoor_eval(gt_annos, det_results, (0.25, 0.5), names)
    assert list(got) == list(want)
    for k in want:
        assert abs(got[k] - want[k]) <= TOL, k
    assert 0 < got['mAP_0.25'] < 1 and got['mAP_0.50'] <= got['mAP_0.25']
    assert lines == [str(got)]


def test_indoor_eval_golden_values():
    """Perfect detections score 1, a false positive ranked first hurts, a
    class without GT has no key (tests/test_eval3d.py)."""
    gt = [dict(gt_boxes=np.array([[0, 0, 0, 1, 1, 1, 0.]]),
               gt_labels=np.array([0])),
          dict(gt_boxes=np.array([[2, 2, 2, 1, 1, 1, 0.3],
                                  [5, 5, 5, 1, 1, 1, 0.]]),
               gt_labels=np.array([1, 0]))]
    det = [dict(boxes_3d=g['gt_boxes'], scores_3d=np.array([0.9, 0.8][:n]),
                labels_3d=g['gt_labels'])
           for g, n in zip(gt, (1, 2))]
    res = peval.indoor_eval(gt, det, (0.25, 0.5), ('a', 'b', 'c'))
    assert abs(res['mAP_0.25'] - 1.0) < 1e-6
    assert abs(res['mAP_0.50'] - 1.0) < 1e-6
    assert 'c_AP_0.25' not in res
    det[0] = dict(boxes_3d=np.array([[0, 0, 0, 1, 1, 1, 0.],
                                     [9, 9, 9, 1, 1, 1, 0.]]),
                  scores_3d=np.array([0.5, 0.95]), labels_3d=np.array([0, 0]))
    assert peval.indoor_eval(gt, det, (0.25,), ('a', 'b'))['mAP_0.25'] < 1.0
