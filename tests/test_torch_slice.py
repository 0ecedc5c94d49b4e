"""The port's serving slice against the JAX package: a tiny DeMF-VoteNet
(``demf_tpu.zoo.tiny_demf_model_cfg`` with exact ball query) runs
``apply(train=False)`` + ``get_bboxes`` on the JAX side and forward +
``get_bboxes`` in the port, from the same weights and the same batch.

Also: the weight map is the exact inverse of ``port_demf_checkpoint``, and
a full-config mmdet3d-named state_dict loads strictly into the port.
"""
import numpy as np
import pytest
import torch

import jax

import demf_tpu.models  # noqa: F401  (registers the JAX detector)
from demf_tpu.engine.torch_port import (flatten_params,
                                        port_demf_checkpoint,
                                        unflatten_params)
from demf_tpu.utils.registry import DETECTORS as JAX_DETECTORS
from demf_tpu.utils.registry import build_from_cfg
from demf_tpu.zoo import load_model_cfg
from demf_tpu.zoo import synth_demf_batch as jax_synth_batch
from demf_tpu.zoo import tiny_demf_model_cfg
from demf_tpu_torch import zoo
from demf_tpu_torch.engine import (batch_to_device, make_eval_step,
                                   run_batches_inference,
                                   state_dict_from_jax)
from test_demf_port import DeMFVoteNetMimic

BATCH = dict(b=2, p=1024, g=4, hw=(64, 96), valid_hw=(60, 88), seed=0)
STAGE_KEYS = ('center', 'size', 'dir_class', 'dir_res_norm', 'obj_scores',
              'sem_scores')


def _tiny_cfg():
    cfg = tiny_demf_model_cfg()
    cfg['pts_backbone']['sa_cfg']['ball_query_exact'] = True
    cfg['pts_bbox_head']['vote_aggregation_cfg']['ball_query_exact'] = True
    return cfg


def _scaled_diff(got, want):
    """max |got - want| / max(max |want|, 1e-3), the parity test's bound."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-3)


@pytest.fixture(scope='module')
def slice_pair():
    """(JAX results by sample_mod, JAX detections (seed), port model, port
    batch)."""
    cfg = _tiny_cfg()
    jmodel = build_from_cfg(cfg, JAX_DETECTORS)
    jbatch = jax_synth_batch(**BATCH)
    variables = jax.jit(lambda r, b: jmodel.init(r, b, train=False))(
        jax.random.PRNGKey(0), jbatch)
    rng = np.random.RandomState(0)
    params = {k: np.asarray(v) + rng.randn(*v.shape).astype(np.float32) *
              0.02 for k, v in flatten_params(variables['params']).items()}
    # box sizes around 1.5 m, so boxes hold points and NMS has work to do
    for i in range(2):
        params[f'pts_bbox_head/conv_pred{i}/conv_reg/bias'][3:6] += 1.5
    stats = {k: (rng.randn(*v.shape) * 0.1 if k.endswith('mean') else
                 rng.uniform(0.5, 2.0, v.shape)).astype(np.float32)
             for k, v in flatten_params(variables['batch_stats']).items()}
    jvars = {'params': unflatten_params(params),
             'batch_stats': unflatten_params(stats)}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('DEMF_TPU_MSDA_F32', '1')

        @jax.jit
        def serve(v, b):
            results = jmodel.apply(v, b, train=False)
            vote = jmodel.apply(v, b, train=False, sample_mod='vote')
            return (dict(seed=results, vote=vote),
                    jmodel.get_bboxes(results, b))

        jres, jdet = jax.device_get(serve(jvars, jbatch))
    port = zoo.build_detector(cfg, 'cpu')
    port.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    batch = zoo.synth_demf_batch(**BATCH)
    return jres, jdet, port, batch


def test_synth_batch_matches_jax_zoo():
    want = jax_synth_batch(**BATCH)
    got = zoo.synth_demf_batch(**BATCH)
    assert set(got) == set(want)
    for key in ('points', 'gt_bboxes_3d', 'gt_labels_3d', 'gt_valid', 'img'):
        np.testing.assert_array_equal(got[key], np.asarray(want[key]))
    assert set(got['img_meta']) == set(want['img_meta'])
    for key, v in got['img_meta'].items():
        np.testing.assert_array_equal(v, np.asarray(want['img_meta'][key]))


@pytest.mark.parametrize('sample_mod,stage', [('seed', 0), ('seed', 1),
                                              ('vote', 0), ('vote', 1)])
def test_stage_predictions_match_jax(slice_pair, sample_mod, stage):
    jres, _, port, batch = slice_pair
    want = jres[sample_mod]
    with torch.no_grad():
        res = port(batch_to_device(batch, 'cpu'), sample_mod=sample_mod)
    assert _scaled_diff(res['aggregated_points'],
                        want['aggregated_points']) < 1e-4
    got, want = res['decode_res_all'][stage], want['decode_res_all'][stage]
    for key in STAGE_KEYS:
        assert _scaled_diff(got[key], want[key]) < 2e-3, (stage, key)


def test_img_features_path_equals_img_path(slice_pair):
    """A batch that carries the frozen image branch's output runs the same
    head as one that carries the image."""
    _, _, port, batch = slice_pair
    tb = batch_to_device(batch, 'cpu')
    with torch.no_grad():
        feats = port.extract_img_feat(tb['img'], tb['img_meta']['img_shape'])
        want = port(tb)['decode_res_all']
        cached = {k: v for k, v in tb.items() if k != 'img'}
        got = port(dict(cached, img_features=feats))['decode_res_all']
    for g, w in zip(got, want):
        for key in STAGE_KEYS:
            assert torch.equal(g[key], w[key]), key


def test_detections_match_jax(slice_pair):
    _, jdet, port, batch = slice_pair
    det = make_eval_step(port)(batch_to_device(batch, 'cpu'))
    assert tuple(det['boxes_3d'].shape) == jdet['boxes_3d'].shape
    valid = det['valid'].numpy()
    np.testing.assert_array_equal(valid, jdet['valid'])
    assert 0 < valid.sum() < valid.size       # NMS kept some, dropped some
    np.testing.assert_array_equal(det['labels_3d'].numpy(),
                                  jdet['labels_3d'])
    for key in ('boxes_3d', 'scores_3d'):
        np.testing.assert_allclose(det[key].numpy()[valid],
                                   jdet[key][valid], rtol=1e-4, atol=1e-4)


def test_run_batches_inference_filters_valid(slice_pair):
    _, jdet, port, batch = slice_pair
    results = run_batches_inference(port, [batch, batch])
    assert len(results) == 4
    for i, r in enumerate(results):
        v = jdet['valid'][i % 2]
        assert r['boxes_3d'].shape == (v.sum(), 7)
        np.testing.assert_array_equal(r['labels_3d'],
                                      jdet['labels_3d'][i % 2][v])


def test_weights_invert_port_demf_checkpoint():
    """mmdet3d state_dict -> port_demf_checkpoint -> state_dict_from_jax
    gives the state_dict back exactly, and it loads strictly into the
    full-width port."""
    cfg = load_model_cfg('demf/demf_votenet.py')
    jmodel = build_from_cfg(cfg.model, JAX_DETECTORS)
    jbatch = jax_synth_batch(b=1, p=2048, hw=(128, 160), valid_hw=(120, 156))
    shapes = jax.eval_shape(
        lambda b: jmodel.init(jax.random.PRNGKey(0), b, train=False), jbatch)
    template = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                      shapes)
    torch.manual_seed(0)
    mimic = DeMFVoteNetMimic(flatten_params(template['params']))
    for m in mimic.modules():
        if isinstance(m, (torch.nn.BatchNorm1d, torch.nn.BatchNorm2d)):
            m.running_mean.normal_()
            m.running_var.uniform_(0.5, 2.0)
    sd = {k: v.detach().numpy() for k, v in mimic.state_dict().items()}
    new_vars, _ = port_demf_checkpoint(sd, dict(template), strict=True)
    back = state_dict_from_jax(flatten_params(new_vars['params']),
                               flatten_params(new_vars['batch_stats']))
    assert set(back) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)
    port = zoo.build_detector(cfg.model, 'cpu')
    port.load_state_dict(mimic.state_dict(), strict=True)
