"""The port's DeMF-FCAF3D (``demf_tpu_torch/models/demf_fcaf3d.py``)
against the JAX package's, on the CPU: the model of
``configs/synthetic/demf_fcaf3d_tiny.py`` (MinkResNet18 at stem 16, the
ResNet-50 image branch with a 32-wide neck and encoder, 16 queries, one
decoder layer) on the same weights (made with numpy at the shapes of
``jax.eval_shape``, moved by ``state_dict_from_jax``) and the same scenes
and 64x96 images.  MSDA runs in float32 on the JAX side
(``DEMF_TPU_MSDA_F32=1``).

* the image branch's encoded levels within 1e-4 of their largest;
* every level's centerness, bbox_pred and cls_scores and the fused stage's
  within 1e-4 of each tensor's largest, the selected voxels equal; on the
  uncached path (``img``) and on the cached one (``img_features``, the
  branch's output carried by the batch);
* ``get_bboxes``' kept boxes within 1e-4 in all three
  ``fusion_ensemble`` modes.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import demf_tpu.models  # noqa: F401  (registers the JAX detectors)
from demf_tpu.engine.torch_port import unflatten_params
from demf_tpu.utils.registry import DETECTORS as JAX_DETECTORS
from demf_tpu.utils.registry import build_from_cfg
from demf_tpu_torch import zoo
from demf_tpu_torch.engine import batch_to_device
from demf_tpu_torch.engine.weights import state_dict_from_jax
from test_torch_fcaf3d import (LEVEL_KEYS, detections_agree, jax_variables,
                               level_errors)

MODES = ('selected_base+fusion', 'fusion_only', 'all')


def with_mode(cfg, mode):
    return dict(cfg, test_cfg=dict(cfg['test_cfg'], fusion_ensemble=mode))


@pytest.fixture(scope='module')
def demf():
    """(JAX image levels, JAX results, JAX detections by mode, the port's
    model, the torch batch)."""
    cfg = dict(zoo.load_model_cfg('synthetic/demf_fcaf3d_tiny.py').model)
    jmodel = build_from_cfg(cfg, JAX_DETECTORS)
    batch = zoo.synth_demf_fcaf3d_batch(2, p=2048, g=4, hw=(64, 96),
                                        valid_hw=(60, 90), seed=0)
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    params, stats = jax_variables(jmodel, jbatch)
    variables = {'params': unflatten_params(params),
                 'batch_stats': unflatten_params(stats)}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('DEMF_TPU_MSDA_F32', '1')
        levels = jax.device_get(jax.jit(lambda v, b: jmodel.apply(
            v, b, train=False, img_feat_only=True))(variables, jbatch))
        cached = dict(jbatch, img_features=tuple(map(jnp.asarray, levels)))
        del cached['img']
        want = jax.device_get(jax.jit(lambda v, b: jmodel.apply(
            v, b, train=False))(variables, cached))
        dets = {}
        for mode in MODES:
            jm = build_from_cfg(with_mode(cfg, mode), JAX_DETECTORS)
            dets[mode] = jax.device_get(jax.jit(jm.get_bboxes)(want))
    model = zoo.build_detector(cfg, 'cpu')
    model.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    return levels, want, dets, model, batch_to_device(batch, 'cpu')


@pytest.fixture(scope='module')
def port_runs(demf):
    """The port's results on the uncached and on the cached path."""
    _, _, _, model, tbatch = demf
    with torch.inference_mode():
        levels = model.extract_img_feat(tbatch['img'],
                                        tbatch['img_meta']['img_shape'])
        cached = dict(tbatch, img_features=levels)
        del cached['img']
        return levels, {'img': model(tbatch), 'img_features': model(cached)}


def test_image_levels_equal_jax(demf, port_runs):
    for got, want in zip(port_runs[0], demf[0]):
        assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()


@pytest.mark.parametrize('path', ['img', 'img_features'])
def test_levels_and_fused_stage_equal_jax(demf, port_runs, path):
    want = demf[1]
    got = port_runs[1][path]
    errs = level_errors(got['head_outs'], want['head_outs'])
    errs.update({('fused', k): e for (_, k), e in level_errors(
        got['fusion_stages'], want['fusion_stages']).items()})
    assert len(errs) == 5 * len(LEVEL_KEYS)
    assert max(errs.values()) <= 1e-4, errs
    assert np.array_equal(got['sel_idx'].numpy(), want['sel_idx'])


@pytest.mark.parametrize('path', ['img', 'img_features'])
@pytest.mark.parametrize('mode', MODES)
def test_get_bboxes_equals_jax(demf, port_runs, mode, path):
    model = demf[3]
    model.head.test_cfg = dict(model.head.test_cfg, fusion_ensemble=mode)
    det = model.get_bboxes(port_runs[1][path])
    assert detections_agree(det, demf[2][mode]) > 0


def test_unknown_ensemble_mode_is_refused(demf, port_runs):
    model = demf[3]
    model.head.test_cfg = dict(model.head.test_cfg,
                               fusion_ensemble='base_only')
    with pytest.raises(ValueError, match='fusion_ensemble'):
        model.get_bboxes(port_runs[1]['img'])
