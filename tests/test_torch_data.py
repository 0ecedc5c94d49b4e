"""The port's data layer (numpy) against the JAX package's on the same
inputs and the same ``np.random.seed``: every registered transform alone,
the DeMF train and test pipelines composed (on the SUN RGB-D fixture, its
GT-less scene too, and on ``SyntheticSUNRGBD``), ``collate_fixed``, the
loader's batches and order, and the dataset classes.

Arrays must be equal, images too: the port's numpy ``Resize`` repeats
OpenCV's fixed-point bilinear arithmetic on uint8 bit for bit, and its
``Normalize`` the float32 subtract and multiply.  The one tolerance is the
float32 resize (0.02 of a grey level, 0.00035 after ``Normalize``), which no
config uses.  The 2D boxes of ``SyntheticSUNRGBD`` come from corners
computed in numpy here and in ``jax.numpy`` there: equal to 1e-3 px.
"""
import copy
import os
import pickle

import cv2
import numpy as np
import pytest

from demf_tpu import data as jdata
from demf_tpu.utils import registry as jregistry
from demf_tpu_torch import data as pdata
from demf_tpu_torch import registry as pregistry
from demf_tpu_torch.data import pipeline as ppipeline
from demf_tpu_torch.utils.config import Config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, 'tests', 'fixtures', 'sunrgbd_mini')
ANN = os.path.join(FIXTURE, 'sunrgbd_infos_mini.pkl')
FULL = Config.fromfile(os.path.join(ROOT, 'configs', 'demf',
                                    'demf_votenet.py'))
NORM = dict(mean=[123.675, 116.28, 103.53], std=[58.395, 57.12, 57.375],
            to_rgb=True)


def assert_same(got, want, path='sample', atol=0.0):
    """Recursive equality of two samples / batches: same keys, same types
    of leaves, arrays equal in dtype, shape and value."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            assert_same(got[k], want[k], f'{path}[{k!r}]', atol)
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), path
        assert got.dtype == want.dtype and got.shape == want.shape, path
        if atol:
            np.testing.assert_allclose(got, want, rtol=0, atol=atol,
                                       err_msg=path)
        else:
            np.testing.assert_array_equal(got, want, err_msg=path)
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f'{path}[{i}]', atol)
    else:
        assert type(got) is type(want) and got == want, path


def scaled(pipeline, img_scale=(400, 240), points=2048):
    """A config's pipeline with a smaller resize and point budget."""
    out = copy.deepcopy(pipeline)
    for t in out:
        if t['type'] in ('Resize', 'MultiScaleFlipAug3D') and \
                t.get('img_scale'):
            t['img_scale'] = img_scale
        if t['type'] == 'PointSample':
            t['num_points'] = points
        for inner in t.get('transforms', []):
            if inner['type'] == 'PointSample':
                inner['num_points'] = points
    return out


def both(cfg):
    """The dataset ``cfg`` names, built by the JAX package and the port."""
    return (jdata.build_dataset(copy.deepcopy(cfg)),
            pdata.build_dataset(copy.deepcopy(cfg)))


def fixture_cfg(pipeline, test_mode=False, **kwargs):
    return dict(type='SUNRGBDDataset', data_root=FIXTURE, ann_file=ANN,
                pipeline=pipeline, test_mode=test_mode, **kwargs)


def synthetic_cfg(pipeline, **kwargs):
    return dict(dict(type='SyntheticSUNRGBD', num_scenes=5,
                     num_raw_points=3000, image_hw=(120, 160),
                     pipeline=pipeline, seed=4), **kwargs)


def raw_samples():
    """One sample before any transform from each dataset kind: files to
    read (the fixture) and arrays carried along (synthetic)."""
    real = pdata.SUNRGBDDataset(FIXTURE, ANN).get_data_info(0)
    synth = pdata.SyntheticSUNRGBD(num_scenes=2, num_raw_points=3000,
                                   image_hw=(120, 160), seed=9)[1]
    return dict(fixture=real, synthetic=synth)


LOADS = [dict(type='LoadPointsFromFile', shift_height=True, load_dim=6,
              use_dim=[0, 1, 2]),
         dict(type='LoadImageFromFile'), dict(type='LoadAnnotations3D'),
         dict(type='LoadAnnotations', with_bbox=True)]
INNER = [dict(type='Resize', keep_ratio=True),
         dict(type='RandomFlip', flip_ratio=0.0),
         dict(type='Normalize', **NORM), dict(type='Pad', size_divisor=32),
         dict(type='PointSample', num_points=512),
         dict(type='Collect3D', keys=['img', 'points'])]
# every registered transform, each after the loads it needs
TRANSFORMS = [
    ([], LOADS[0]),
    ([], dict(type='LoadPointsFromFile', shift_height=False, load_dim=6,
              use_dim=[0, 1, 2, 3, 4, 5])),
    ([], LOADS[1]),
    ([], dict(type='LoadImageFromFile', to_float32=True)),
    ([], LOADS[2]),
    ([], LOADS[3]),
    (LOADS, dict(type='Resize', img_scale=(333, 200), keep_ratio=True)),
    (LOADS, dict(type='Resize', img_scale=(96, 64), keep_ratio=False)),
    (LOADS, dict(type='Resize', img_scale=[(333, 200), (260, 200)],
                 multiscale_mode='value', keep_ratio=True)),
    (LOADS, dict(type='RandomFlip', flip_ratio=0.0)),
    (LOADS, dict(type='RandomFlip', flip_ratio=1.0)),
    (LOADS, dict(type='Normalize', **NORM)),
    (LOADS, dict(type='Normalize', mean=[1, 2, 3], std=[4, 5, 6],
                 to_rgb=False)),
    (LOADS, dict(type='Pad', size_divisor=32)),
    (LOADS, dict(type='Pad', size=(256, 256), pad_val=7)),
    (LOADS, dict(type='RandomFlip3D', flip_ratio_bev_horizontal=0.5)),
    (LOADS, dict(type='RandomFlip3D', flip_ratio_bev_horizontal=1.0)),
    (LOADS, dict(type='GlobalRotScaleTrans', shift_height=True)),
    (LOADS, dict(type='GlobalRotScaleTrans', rot_range=[0, 0],
                 scale_ratio_range=[1., 1.],
                 translation_std=[0.1, 0.2, 0.3])),
    (LOADS, dict(type='PointSample', num_points=1000)),
    (LOADS, dict(type='PointSample', num_points=9000)),
    (LOADS, dict(type='DefaultFormatBundle3D', class_names=('a',))),
    (LOADS, dict(type='DefaultFormatBundle')),
    (LOADS, dict(type='ImageToTensor', keys=['img'])),
    (LOADS, dict(type='Collect3D', keys=['img', 'points', 'gt_bboxes_3d'])),
    (LOADS, dict(type='Collect', keys=['img', 'gt_bboxes', 'gt_labels'],
                 meta_keys=('img_shape', 'ori_shape'))),
    (LOADS, dict(type='MultiScaleFlipAug3D', img_scale=(333, 200),
                 flip=False, transforms=INNER)),
    (LOADS, dict(type='MultiScaleFlipAug', img_scale=(333, 200), flip=False,
                 transforms=INNER[:4])),
    (LOADS, dict(type='RandomCrop', crop_size=(60, 100))),
    (LOADS, dict(type='AutoAugment', policies=[
        [dict(type='Resize', img_scale=(333, 200), keep_ratio=True)],
        [dict(type='RandomCrop', crop_size=(60, 100)),
         dict(type='Resize', img_scale=(260, 200), keep_ratio=True)]])),
]


def test_the_same_transforms_are_registered_and_every_one_is_tested():
    names = set(pregistry.PIPELINES._module_dict)
    assert names == set(jregistry.PIPELINES._module_dict)
    assert len(names) == 20
    assert {t['type'] for _, t in TRANSFORMS} == names
    assert set(pregistry.DATASETS._module_dict) >= {
        'SUNRGBDDataset', 'RepeatDataset', 'SyntheticSUNRGBD'}


@pytest.mark.parametrize('source', ['fixture', 'synthetic'])
@pytest.mark.parametrize('before,transform', TRANSFORMS,
                         ids=[f'{i}-{t["type"]}'
                              for i, (_, t) in enumerate(TRANSFORMS)])
def test_transform_equals_original(before, transform, source):
    raw = raw_samples()[source]
    results = []
    for compose in (jdata.pipeline.Compose, ppipeline.Compose):
        sample = compose(copy.deepcopy(before))(copy.deepcopy(raw))
        np.random.seed(17)
        results.append(compose([copy.deepcopy(transform)])(sample))
    assert_same(results[1], results[0])


@pytest.mark.parametrize('which', ['train_pipeline', 'test_pipeline',
                                   'eval_pipeline'])
@pytest.mark.parametrize('index', [0, 1, 2])
def test_demf_pipelines_on_the_fixture_equal_original(which, index):
    """All 3 scenes (scene 2 has no GT) at a smaller resize."""
    jds, pds = both(fixture_cfg(scaled(FULL[which]), test_mode=True))
    np.random.seed(index)
    want = jds[index]
    np.random.seed(index)
    got = pds[index]
    assert_same(got, want)
    assert got['img'].dtype == (np.uint8 if which == 'eval_pipeline'
                                else np.float32)


def test_demf_train_pipeline_at_full_size_equals_original():
    """The config's own (1333, 800) resize and 20,000 points."""
    jds, pds = both(fixture_cfg(FULL.train_pipeline))
    np.random.seed(3)
    want = jds[1]
    np.random.seed(3)
    got = pds[1]
    assert_same(got, want)
    assert got['img'].shape == (800, 1056, 3)
    assert got['points'].shape == (20000, 4)


@pytest.mark.parametrize('which', ['train_pipeline', 'test_pipeline'])
def test_demf_pipelines_on_synthetic_scenes_equal_original(which):
    jds, pds = both(synthetic_cfg(scaled(FULL[which]), render_boxes=True))
    for index in (0, 3):
        np.random.seed(index)
        want = jds[index]
        np.random.seed(index)
        got = pds[index]
        boxes2d = (got.pop('gt_bboxes', None), want.pop('gt_bboxes', None))
        assert_same(got, want)
        if which == 'train_pipeline':
            assert_same(boxes2d[0], boxes2d[1], 'gt_bboxes', atol=1e-3)
    assert_same(pds.get_gt_annos(), jds.get_gt_annos())


@pytest.mark.parametrize('shape,size', [
    ((480, 640), (1067, 800)), ((160, 208), (1040, 800)),
    ((64, 96), (96, 64)), ((100, 37), (20, 250)), ((33, 47), (47, 33)),
    ((5, 7), (70, 50)), ((120, 160), (160, 120))])
def test_resize_equals_cv2(shape, size):
    rng = np.random.RandomState(shape[0])
    img = (rng.rand(*shape, 3) * 255).astype(np.uint8)
    got = ppipeline.resize_bilinear(img, size)
    want = cv2.resize(img, size, interpolation=cv2.INTER_LINEAR)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    as_float = img.astype(np.float32)
    got = ppipeline.resize_bilinear(as_float, size)
    want = cv2.resize(as_float, size, interpolation=cv2.INTER_LINEAR)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=0.02)
    with pytest.raises(TypeError):
        ppipeline.resize_bilinear(img.astype(np.float64), size)


@pytest.mark.parametrize('to_rgb', [True, False])
def test_normalize_equals_cv2(to_rgb):
    """mmcv's ``imnormalize_`` with OpenCV, on uint8 and float32 input and
    on a flipped view."""
    rng = np.random.RandomState(0)
    img = (rng.rand(50, 70, 3) * 255).astype(np.uint8)
    for sample in (img, img.astype(np.float32), img[:, ::-1]):
        want = np.array(sample, dtype=np.float32, order='C')
        if to_rgb:
            cv2.cvtColor(want, cv2.COLOR_BGR2RGB, want)
        mean = np.asarray(NORM['mean'], np.float64).reshape(1, -1)
        std = np.asarray(NORM['std'], np.float32)
        cv2.subtract(want, mean, want)
        cv2.multiply(want, (1.0 / std).reshape(1, -1).astype(np.float64),
                     want)
        got = ppipeline.Normalize(NORM['mean'], NORM['std'], to_rgb)(
            dict(img=sample))
        np.testing.assert_array_equal(got['img'], want)
        assert got['img'].flags['C_CONTIGUOUS']
        assert got['img_norm_cfg']['to_rgb'] is to_rgb


def test_load_image_names_the_missing_decoder(monkeypatch):
    """Without OpenCV a jpg cannot be read, and the error says so; a sample
    that carries ``raw_img`` needs none."""
    import builtins
    real_import = builtins.__import__

    def no_cv2(name, *args, **kwargs):
        if name == 'cv2':
            raise ImportError('No module named cv2')
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, '__import__', no_cv2)
    load = ppipeline.LoadImageFromFile()
    with pytest.raises(ImportError, match='needs OpenCV'):
        load(dict(img_filename=os.path.join(FIXTURE, 'image', '000000.jpg')))
    raw = np.zeros((4, 6, 3), np.uint8)
    assert load(dict(raw_img=raw))['img_shape'] == (4, 6, 3)


@pytest.mark.parametrize('source', ['fixture', 'synthetic'])
def test_collate_fixed_equals_original(source):
    pipe = scaled(FULL.train_pipeline)
    cfg = (fixture_cfg(pipe, filter_empty_gt=False) if source == 'fixture'
           else synthetic_cfg(pipe))
    _, pds = both(cfg)
    np.random.seed(0)
    samples = [pds[i] for i in range(3)]
    for max_gt in (64, 2):
        got = pdata.collate_fixed(samples, max_gt=max_gt)
        want = jdata.collate_fixed(samples, max_gt=max_gt)
        assert_same(got, want, 'batch')
        assert got['gt_bboxes_3d'].shape == (3, max_gt, 7)
    _, pds = both(fixture_cfg(scaled(FULL.test_pipeline), test_mode=True))
    samples = [pds[i] for i in range(3)]
    assert_same(pdata.collate_fixed(samples), jdata.collate_fixed(samples),
                'batch')


@pytest.mark.parametrize('shuffle', [True, False])
def test_dataloader_yields_the_originals_batches_in_order(shuffle):
    """One worker, so the global draws come in one order: two epochs (the
    shuffle changes with the epoch), the last partial batch dropped."""
    jds, pds = both(synthetic_cfg(scaled(FULL.train_pipeline), num_scenes=7))
    kwargs = dict(samples_per_gpu=3, workers_per_gpu=1, shuffle=shuffle,
                  seed=5, max_gt=8)
    jloader = jdata.build_dataloader(jds, **kwargs)
    ploader = pdata.build_dataloader(pds, **kwargs)
    assert len(ploader) == len(jloader) == 2
    for epoch in range(2):
        np.random.seed(epoch)
        want = list(jloader)
        np.random.seed(epoch)
        got = list(ploader)
        assert len(got) == 2
        for g, w in zip(got, want):
            boxes2d = (g.pop('gt_bboxes'), w.pop('gt_bboxes'))
            assert_same(g, w, 'batch')
            assert_same(boxes2d[0], boxes2d[1], 'gt_bboxes', atol=1e-3)
    if shuffle:
        assert sorted(np.concatenate([b['sample_idx'] for b in got])) != \
            list(np.concatenate([b['sample_idx'] for b in got]))


@pytest.mark.parametrize('workers,prefetch', [(1, 2), (4, 2), (4, 0)])
def test_dataloader_threads_and_errors(workers, prefetch):
    """With a thread pool the batches hold the same scenes in the same
    order; a transform's exception comes out in the consumer."""
    pds = pdata.build_dataset(synthetic_cfg(
        scaled(FULL.test_pipeline), num_scenes=6, test_mode=True))
    loader = pdata.DataLoader(pds, batch_size=2, shuffle=False,
                              num_threads=workers, prefetch=prefetch)
    got = list(loader)
    assert [list(b['sample_idx']) for b in got] == [[0, 1], [2, 3], [4, 5]]
    assert got[0]['img'].shape == (2, 256, 320, 3)

    class Broken:
        def __len__(self):
            return 4

        def __getitem__(self, index):
            if index == 3:
                raise RuntimeError('scene 3 is broken')
            return pds[index]

    loader = pdata.DataLoader(Broken(), batch_size=2, shuffle=False,
                              num_threads=workers, prefetch=prefetch)
    with pytest.raises(RuntimeError, match='scene 3 is broken'):
        list(loader)


def test_sunrgbd_dataset_reads_filters_and_formats_like_the_original(
        tmp_path):
    for kwargs in (dict(test_mode=False), dict(test_mode=True),
                   dict(test_mode=False, filter_empty_gt=False),
                   dict(test_mode=True, classes=('bed', 'chair', 'desk'))):
        jds, pds = both(fixture_cfg(None, **kwargs))
        assert len(pds) == len(jds) and pds.CLASSES == jds.CLASSES
        for i in range(len(jds)):
            assert_same(pds.get_data_info(i), jds.get_data_info(i))
        assert_same(pds.get_gt_annos(), jds.get_gt_annos())
    jds, pds = both(fixture_cfg(None, test_mode=True))
    assert len(pds) == 3 and len(pds.get_gt_annos()[2]['gt_boxes']) == 0
    rng = np.random.RandomState(0)
    results = [dict(boxes_3d=rng.rand(k, 7).astype(np.float32),
                    scores_3d=rng.rand(k).astype(np.float32),
                    labels_3d=rng.randint(0, 10, k)) for k in (4, 0, 2)]
    _, jfile = jds.format_results(results, str(tmp_path / 'jax' / 'res'))
    _, pfile = pds.format_results(results, str(tmp_path / 'port' / 'res'))
    with open(jfile, 'rb') as f, open(pfile, 'rb') as g:
        assert_same(pickle.load(g), pickle.load(f), 'records')
    assert pds.format_results(results)[1].endswith('results.pkl')
    gts = pds.get_gt_annos()
    perfect = [dict(boxes_3d=g['gt_boxes'], scores_3d=np.ones(len(
        g['gt_boxes'])), labels_3d=g['gt_labels']) for g in gts]
    assert pds.evaluate(perfect) == jds.evaluate(perfect)
    assert abs(pds.evaluate(perfect)['mAP_0.25'] - 1) < 1e-6


def test_repeat_dataset_and_the_full_configs_data_section():
    """``data.train`` of configs/demf/demf_votenet.py (a RepeatDataset
    around SUNRGBDDataset) builds once it points at the fixture."""
    cfg = copy.deepcopy(FULL.data['train'])
    cfg['dataset'].update(data_root=FIXTURE, ann_file=ANN,
                          pipeline=scaled(FULL.train_pipeline))
    jds, pds = both(cfg)
    assert len(pds) == len(jds) == 15 and pds.times == 5
    assert pds.CLASSES == jds.CLASSES
    np.random.seed(1)
    want = jds[7]
    np.random.seed(1)
    assert_same(pds[7], want)
    assert pds.evaluate is not None and pds.format_results is not None
