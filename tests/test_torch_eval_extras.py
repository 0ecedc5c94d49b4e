"""The eval entry's extras and the optimizers of the port against the JAX
package's, on the CPU:

* ``engine/fuse_bn.py``: the same pairs folded as the JAX package's
  ``fuse_conv_bn`` on the same random weights with spread statistics
  (shapes by ``jax.eval_shape``, carried by ``state_dict_from_jax``; no
  compile), the folded state within 1e-6 of JAX's folded state carried
  across, and the fused model's detections equal to the unfused one's at
  tiny DeMF and tiny FCAF3D;
* ``engine/visualize.py``: the ``.obj`` files byte for byte the JAX
  package's, for random boxes and for ``show_dataset_results`` on
  ``tests/fixtures/sunrgbd_mini``;
* ``engine/aug_test.py``: ``aug_test_3d`` against JAX's on the tiny
  VoteNet with shared weights (batch 2, as ``tests/test_aug_test.py``),
  and the merge cut by class equal to the merge in one piece;
* Adam and SGD (``engine/optim.py``) against the JAX package's
  ``build_optimizer`` chain for 3 steps on the same arrays, within 1e-6,
  with and without decay, clip and lr_mult, and a frozen parameter.
"""
import copy
import filecmp
import os

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp

import demf_tpu.models  # noqa: F401  (registers the JAX detectors)
from demf_tpu import data as jdata
from demf_tpu import zoo as jzoo
from demf_tpu.engine import aug_test as jaug
from demf_tpu.engine import fuse_bn as jfuse
from demf_tpu.engine import optim as joptim
from demf_tpu.engine import visualize as jvis
from demf_tpu.engine.torch_port import flatten_params, unflatten_params
from demf_tpu.utils.registry import DETECTORS as JAX_DETECTORS
from demf_tpu.utils.registry import build_from_cfg
from demf_tpu_torch import data as pdata
from demf_tpu_torch import zoo
from demf_tpu_torch.engine import aug_test as paug
from demf_tpu_torch.engine import batch_to_device, make_eval_step
from demf_tpu_torch.engine import visualize as pvis
from demf_tpu_torch.engine.fuse_bn import conv_bn_pairs, fuse_conv_bn
from demf_tpu_torch.engine.optim import (build_optimizer,
                                         clip_grad_global_norm, set_lr)
from demf_tpu_torch.engine.weights import state_dict_from_jax
from demf_tpu_torch.models.mink_resnet import MaskedBatchNorm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def one_thread():
    """Each test on one intra-op thread: the tiny models' many small ops
    under the other workers' threads slow by hundreds of times with
    torch's default pool (a tiny FCAF3D's two steps took 434 s in a loaded
    run, 1.3 s alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
FIXTURE = os.path.join(ROOT, 'tests', 'fixtures', 'sunrgbd_mini')


def votenet_cfg():
    """The tiny VoteNet with exact ball query (the port's rule)."""
    cfg = copy.deepcopy(dict(zoo.load_model_cfg('synthetic/votenet_tiny.py')
                             .model))
    cfg['backbone']['sa_cfg']['ball_query_exact'] = True
    cfg['bbox_head']['vote_aggregation_cfg']['ball_query_exact'] = True
    return cfg


def demf_cfg():
    cfg = jzoo.tiny_demf_model_cfg()
    cfg['pts_backbone']['sa_cfg']['ball_query_exact'] = True
    cfg['pts_bbox_head']['vote_aggregation_cfg']['ball_query_exact'] = True
    return cfg


MODELS = {
    'votenet': (votenet_cfg,
                lambda: zoo.synth_points_batch(2, 256, g=4, seed=1)),
    'demf': (demf_cfg,
             lambda: zoo.synth_demf_batch(2, p=256, g=4, hw=(64, 96),
                                          seed=1)),
    'fcaf3d': (lambda: copy.deepcopy(dict(zoo.load_model_cfg(
        'synthetic/fcaf3d_tiny.py').model)),
               lambda: zoo.synth_fcaf3d_batch(2, p=1024, g=4, seed=1)),
}


def jax_variables(jmodel, batch, seed=0):
    """Flat params and statistics at ``init``'s shapes (by
    ``jax.eval_shape``, no compile): fan-in kernels, small biases,
    BatchNorm scales spread around 1 and statistics spread."""
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    shapes = jax.eval_shape(lambda r, b: jmodel.init(r, b, train=False),
                            {'params': jax.random.PRNGKey(0),
                             'sample': jax.random.PRNGKey(0)}, jbatch)
    rng = np.random.RandomState(seed)
    params = {}
    for k, s in flatten_params(shapes['params']).items():
        if k.endswith('scale'):
            v = 1.0 + rng.randn(*s.shape) * 0.2
        elif k.endswith('bias') or k.endswith('level_embeds'):
            v = rng.randn(*s.shape) * 0.02
        else:
            v = rng.randn(*s.shape) * np.sqrt(2.0 / np.prod(s.shape[:-1]))
        params[k] = v.astype(np.float32)
    stats = {k: (rng.randn(*s.shape) * 0.1 if k.endswith('mean') else
                 rng.uniform(0.5, 2.0, s.shape)).astype(np.float32)
             for k, s in flatten_params(shapes['batch_stats']).items()}
    return params, stats


@pytest.fixture(scope='module', params=sorted(MODELS))
def shared(request):
    """(name, model cfg, numpy batch, flat params, flat statistics)."""
    make_cfg, make_batch = MODELS[request.param]
    cfg, batch = make_cfg(), make_batch()
    jmodel = build_from_cfg(copy.deepcopy(cfg), JAX_DETECTORS)
    params, stats = jax_variables(jmodel, batch)
    return request.param, cfg, batch, params, stats


def port_model(cfg, params, stats):
    model = zoo.build_detector(copy.deepcopy(cfg), 'cpu')
    model.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    return model


def test_fuse_conv_bn_folds_the_jax_pairs(shared):
    name, cfg, _, params, stats = shared
    fused, n_jax = jfuse.fuse_conv_bn({'params': unflatten_params(params),
                                       'batch_stats':
                                           unflatten_params(stats)})
    model = port_model(cfg, params, stats)
    masked = {id(m.bn) for m in model.modules()
              if isinstance(m, MaskedBatchNorm)}
    pairs = conv_bn_pairs(model)
    # the sparse convolutions' BatchNorms stay, as in the JAX package
    assert not masked & {id(bn) for _, bn in pairs}
    assert fuse_conv_bn(model) == n_jax == len(pairs)
    assert (n_jax > 0) == (name != 'fcaf3d')
    want = state_dict_from_jax(flatten_params(fused['params']),
                               flatten_params(fused['batch_stats']))
    got = model.state_dict()
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=k)


def test_fused_eval_detects_as_unfused(shared):
    name, cfg, batch, params, stats = shared
    params = dict(params)
    for key in [k for k in params if k.endswith('conv_reg/bias')]:
        # box sizes around 1.5 m, so boxes hold points and NMS has work
        params[key] = params[key].copy()
        params[key][3:6] += 1.5
    batch = batch_to_device(batch, 'cpu')
    model = port_model(cfg, params, stats)
    want = make_eval_step(model)(batch)
    # FCAF3D folds nothing: its BatchNorms follow sparse convolutions
    assert (fuse_conv_bn(model) > 0) == (name != 'fcaf3d')
    got = make_eval_step(model)(batch)
    assert torch.equal(got['valid'], want['valid'])
    assert int(want['valid'].sum()) > 0
    v = want['valid']
    top = want['boxes_3d'][v].abs().max()
    assert (got['boxes_3d'][v] - want['boxes_3d'][v]).abs().max() <= \
        1e-4 * top
    assert (got['scores_3d'][v] - want['scores_3d'][v]).abs().max() <= 1e-5
    assert torch.equal(got['labels_3d'][v], want['labels_3d'][v])


def test_obj_files_are_the_jax_packages_bytes(tmp_path):
    rng = np.random.RandomState(0)
    boxes = np.concatenate([rng.rand(6, 3) * 4 - 2, rng.rand(6, 3) + 0.2,
                            rng.uniform(-np.pi, np.pi, (6, 1))], 1)
    points = rng.rand(50, 6) * 3
    for side, vis in (('jax', jvis), ('port', pvis)):
        vis.show_result(points, boxes, boxes[:0], str(tmp_path / side), 's')
        vis.show_result(points[:, :3], None, boxes[2:], str(tmp_path / side),
                        't')
    names = sorted(os.listdir(tmp_path / 'jax'))
    assert names == sorted(os.listdir(tmp_path / 'port')) and len(names) == 5
    _, mismatch, errors = filecmp.cmpfiles(tmp_path / 'jax',
                                           tmp_path / 'port', names,
                                           shallow=False)
    assert not mismatch and not errors


def test_show_dataset_results_on_the_fixture(tmp_path):
    pipeline = [
        dict(type='LoadPointsFromFile', coord_type='DEPTH',
             shift_height=True, load_dim=6, use_dim=[0, 1, 2]),
        dict(type='DefaultFormatBundle3D', class_names=('bed',)),
        dict(type='Collect3D', keys=['points'])]
    cfg = dict(type='SUNRGBDDataset', data_root=FIXTURE,
               ann_file=os.path.join(FIXTURE, 'sunrgbd_infos_mini.pkl'),
               pipeline=pipeline, test_mode=True)
    jds = jdata.build_dataset(copy.deepcopy(cfg))
    pds = pdata.build_dataset(copy.deepcopy(cfg))
    rng = np.random.RandomState(1)
    results = [dict(boxes_3d=g['gt_boxes'] + rng.rand(*g['gt_boxes'].shape)
                    * 0.1, scores_3d=rng.rand(len(g['gt_boxes'])),
                    labels_3d=g['gt_labels']) for g in pds.get_gt_annos()]
    jvis.show_dataset_results(jds, results, str(tmp_path / 'jax'))
    pvis.show_dataset_results(pds, results, str(tmp_path / 'port'))
    names = sorted(os.listdir(tmp_path / 'jax'))
    assert names == sorted(os.listdir(tmp_path / 'port'))
    assert len(names) == 3 * len(pds)
    _, mismatch, errors = filecmp.cmpfiles(tmp_path / 'jax',
                                           tmp_path / 'port', names,
                                           shallow=False)
    assert not mismatch and not errors


def test_aug_test_matches_jax_on_tiny_votenet():
    cfg = votenet_cfg()
    batch = zoo.synth_points_batch(2, 256, g=4, seed=1)
    jmodel = build_from_cfg(copy.deepcopy(cfg), JAX_DETECTORS)
    params, stats = jax_variables(jmodel, batch, seed=5)
    # box sizes around 1.5 m, so the merge's NMS has overlaps to sweep
    params['bbox_head/conv_pred/conv_reg/bias'][:6] += 0.75
    want = jax.device_get(jaug.aug_test_3d(
        jmodel, {'params': unflatten_params(params),
                 'batch_stats': unflatten_params(stats)},
        jax.tree_util.tree_map(jnp.asarray, batch), nms_thr=0.25))
    model = port_model(cfg, params, stats)
    got = paug.aug_test_3d(model, batch_to_device(batch, 'cpu'),
                           nms_thr=0.25)
    got = {k: v.numpy() for k, v in got.items()}
    assert got['boxes_3d'].shape == want['boxes_3d'].shape
    np.testing.assert_array_equal(got['valid'], want['valid'])
    v = want['valid']
    # the merge keeps fewer than it was given, from both augmentations
    half = v.shape[1] // 2
    assert 0 < v.sum() and v[:, :half].any() and v[:, half:].any()
    np.testing.assert_array_equal(got['labels_3d'][v], want['labels_3d'][v])
    top = np.abs(want['boxes_3d'][v]).max()
    assert np.abs(got['boxes_3d'][v] - want['boxes_3d'][v]).max() <= \
        1e-4 * top
    np.testing.assert_allclose(got['scores_3d'][v], want['scores_3d'][v],
                               atol=1e-5)


def test_aug_flip_toggles_the_meta_and_unflips_the_boxes():
    batch = batch_to_device(zoo.synth_demf_batch(2, p=16, g=2, hw=(32, 64)),
                            'cpu')
    batch['img_meta']['pcd_horizontal_flip'][1] = True
    out = paug.flip_batch(batch)
    assert torch.equal(out['points'][..., 0], -batch['points'][..., 0])
    assert torch.equal(out['points'][..., 1:], batch['points'][..., 1:])
    assert out['img_meta']['pcd_horizontal_flip'].tolist() == [True, False]
    assert batch['img_meta']['pcd_horizontal_flip'].tolist() == [False, True]
    boxes = torch.rand(2, 5, 7)
    jboxes = np.asarray(jaug._unflip_boxes(jnp.asarray(boxes.numpy())))
    np.testing.assert_array_equal(paug.unflip_boxes(boxes).numpy(), jboxes)


@pytest.mark.parametrize('per_class', [8, 40])
def test_merge_cut_by_class_equals_the_merge_in_one_piece(per_class):
    """A scene of more boxes than K8 sweeps is merged by (scene, class)
    rows: the same keep mask as one sweep over the scene."""
    rng = np.random.RandomState(per_class)
    b, m = 2, 5 * per_class
    boxes = torch.from_numpy(np.concatenate(
        [rng.rand(b, m, 3) * 2, rng.rand(b, m, 3) * 0.8 + 0.3,
         rng.uniform(-np.pi, np.pi, (b, m, 1))], -1).astype(np.float32))
    scores = torch.from_numpy(rng.rand(b, m).astype(np.float32))
    scores[0, :4] = 0.5                               # ties keep index order
    labels = torch.from_numpy(rng.randint(0, 5, (b, m)))
    valid = torch.from_numpy(rng.rand(b, m) < 0.8)
    whole = paug.merge_nms(boxes, scores, labels, valid, 0.25)
    cut = paug.merge_nms(boxes, scores, labels, valid, 0.25,
                         rows=per_class - 1)
    assert torch.equal(whole, cut)
    assert 0 < int(whole.sum()) < int(valid.sum())


class _Net(nn.Module):
    """Parameters named as the flax tree below, with '.' for '/'."""

    def __init__(self, arrays):
        super().__init__()
        self.decoder = nn.ParameterDict(
            {k: nn.Parameter(torch.tensor(v)) for k, v in
             arrays['decoder'].items()})
        self.head = nn.ParameterDict(
            {k: nn.Parameter(torch.tensor(v)) for k, v in
             arrays['head'].items()})
        self.img_backbone = nn.ParameterDict(
            {k: nn.Parameter(torch.tensor(v), requires_grad=False)
             for k, v in arrays['img_backbone'].items()})


OPT_CASES = {
    'adam': dict(type='Adam', lr=0.01),
    'adam_decay_mult': dict(type='Adam', lr=0.01, weight_decay=0.05,
                            paramwise_cfg=dict(custom_keys={
                                'decoder': dict(lr_mult=0.1)})),
    'sgd': dict(type='SGD', lr=0.05, momentum=0.9),
    'sgd_decay_mult': dict(type='SGD', lr=0.05, momentum=0.8,
                           weight_decay=0.01, paramwise_cfg=dict(
                               custom_keys={'decoder': dict(lr_mult=0.1)})),
}


@pytest.mark.parametrize('clip', [None, 0.5])
@pytest.mark.parametrize('case', sorted(OPT_CASES))
def test_optimizer_matches_the_jax_chain(case, clip):
    """3 steps from the same arrays and gradients; the frozen pattern
    (``img_backbone``: no gradient here, a zero one in the JAX package)
    joins the custom keys at lr_mult 0 as both entry points do."""
    rng = np.random.RandomState(0)
    arrays = {'decoder': {'w': rng.randn(4, 3).astype(np.float32)},
              'head': {'w': rng.randn(3).astype(np.float32),
                       'b': rng.randn(2, 2).astype(np.float32)},
              'img_backbone': {'w': rng.randn(5).astype(np.float32)}}
    cfg = OPT_CASES[case]
    frozen = ['img_backbone']
    jcfg = copy.deepcopy(cfg)
    keys = dict((jcfg.get('paramwise_cfg') or {}).get('custom_keys') or {})
    keys.update({p: dict(lr_mult=0.0, decay_mult=0.0) for p in frozen})
    jcfg['paramwise_cfg'] = dict(custom_keys=keys)
    params = jax.tree_util.tree_map(jnp.asarray, arrays)
    tx = joptim.build_optimizer(jcfg, params, grad_clip=None if clip is None
                                else dict(max_norm=clip))
    state = tx.init(params)
    net = _Net(arrays)
    opt = build_optimizer(net, cfg, frozen)
    trained = [p for p in net.parameters() if p.requires_grad]
    for _ in range(3):
        grads = jax.tree_util.tree_map(
            lambda a: rng.randn(*a.shape).astype(np.float32), arrays)
        grads['img_backbone'] = jax.tree_util.tree_map(np.zeros_like,
                                                       grads['img_backbone'])
        updates, state = tx.update(jax.tree_util.tree_map(jnp.asarray,
                                                          grads),
                                   state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
        opt.zero_grad(set_to_none=True)
        for scope in ('decoder', 'head'):
            for k, g in grads[scope].items():
                getattr(net, scope)[k].grad = torch.tensor(g)
        if clip is not None:
            clip_grad_global_norm(trained, clip)
        set_lr(opt, cfg['lr'])
        opt.step()
    for scope, leaves in jax.device_get(params).items():
        for k, want in leaves.items():
            got = getattr(net, scope)[k].detach().numpy()
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6,
                                       err_msg=f'{scope}/{k}')
    moved = not np.array_equal(net.img_backbone['w'].detach().numpy(),
                               arrays['img_backbone']['w'])
    # SGD's chain has no lr_mult: its decay moves the frozen parameter
    assert moved == (cfg['type'] == 'SGD' and bool(cfg.get('weight_decay')))
