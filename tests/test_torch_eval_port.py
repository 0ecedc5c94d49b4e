"""Dataset -> inference -> mAP in both packages, and the port's two entry
points end to end on the CPU.

The tiny DeMF-VoteNet with the JAX model's weights carried across
(``engine.weights.state_dict_from_jax``) reads the 4 val scenes of the
port's tiny config (``demf_tpu_torch/configs/demf_tiny.py``) through
``run_dataset_inference`` at batch size 3, so the last batch is filled and
the fill dropped: per scene the detections' count and labels are equal and
boxes and scores agree to 1e-5, and ``dataset.evaluate`` gives the same mAP
dict.  Then ``python -m demf_tpu_torch.train`` and ``python -m
demf_tpu_torch.eval`` run through ``main(argv)``.
"""
import os
import pickle

import numpy as np
import pytest
import torch

import jax

import demf_tpu.models  # noqa: F401  (registers the JAX detector)
from demf_tpu import data as jdata
from demf_tpu.engine import evaluation as jevaluation
from demf_tpu.engine.torch_port import flatten_params, unflatten_params
from demf_tpu.utils.registry import DETECTORS as JAX_DETECTORS
from demf_tpu.utils.registry import build_from_cfg
from demf_tpu.zoo import tiny_demf_model_cfg as jax_tiny_cfg
from demf_tpu_torch import data as pdata
from demf_tpu_torch import eval as eval_entry
from demf_tpu_torch import train, zoo
from demf_tpu_torch.engine import (latest_checkpoint, load_meta,
                                   make_dataset_eval_fn,
                                   run_dataset_inference,
                                   state_dict_from_jax)
from demf_tpu_torch.utils.config import Config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, 'demf_tpu_torch', 'configs', 'demf_tiny.py')
FIXTURE = os.path.join(ROOT, 'tests', 'fixtures', 'sunrgbd_mini')


def test_tiny_model_cfg_equals_the_jax_zoos():
    assert zoo.tiny_demf_model_cfg() == jax_tiny_cfg()
    assert dict(Config.fromfile(TINY).model) == jax_tiny_cfg()


@pytest.fixture(scope='module')
def inference_pair():
    """(JAX results, port results, JAX dataset, port dataset, port model):
    the val scenes of the tiny config through both packages' dataset
    inference, same weights, same draws of the point sampling."""
    cfg = Config.fromfile(TINY)
    jds = jdata.build_dataset(cfg.data['val'])
    pds = pdata.build_dataset(cfg.data['val'])
    model_cfg = jax_tiny_cfg()
    model_cfg['pts_backbone']['sa_cfg']['ball_query_exact'] = True
    model_cfg['pts_bbox_head']['vote_aggregation_cfg'][
        'ball_query_exact'] = True
    jmodel = build_from_cfg(model_cfg, JAX_DETECTORS)
    np.random.seed(0)
    batch0 = jdata.collate_fixed([jds[0]], max_gt=cfg.max_gt)
    variables = jax.jit(lambda r, b: jmodel.init(r, b, train=False))(
        jax.random.PRNGKey(0), batch0)
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
        np.random.seed(1)
        jprogress = []
        jres = jevaluation.run_dataset_inference(
            jmodel, jvars, jds, batch_size=3, max_gt=cfg.max_gt,
            progress_cb=lambda d, n: jprogress.append((d, n)))
    port = zoo.build_detector(model_cfg, 'cpu')
    port.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    np.random.seed(1)
    progress = []
    pres = run_dataset_inference(
        port, pds, batch_size=3, max_gt=cfg.max_gt,
        progress_cb=lambda d, n: progress.append((d, n)))
    assert progress == jprogress == [(3, 4), (4, 4)]
    return jres, pres, jds, pds, port


@pytest.mark.parametrize('scene', [0, 1, 2, 3])
def test_dataset_inference_detections_equal_jax(inference_pair, scene):
    """Scene 3 comes from the filled batch (scenes 3, 3, 3)."""
    jres, pres, _, _, _ = inference_pair
    assert len(pres) == len(jres) == 4
    got, want = pres[scene], jres[scene]
    assert list(got) == ['boxes_3d', 'scores_3d', 'labels_3d']
    assert len(got['scores_3d']) == len(want['scores_3d']) > 0
    np.testing.assert_array_equal(got['labels_3d'], want['labels_3d'])
    np.testing.assert_allclose(got['boxes_3d'], want['boxes_3d'], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(got['scores_3d'], want['scores_3d'], rtol=0,
                               atol=1e-5)


def test_dataset_evaluate_gives_the_same_map_dict(inference_pair):
    jres, pres, jds, pds, _ = inference_pair
    got, want = pds.evaluate(pres), jds.evaluate(jres)
    assert list(got) == list(want) and 'mAP_0.25' in got
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-6, k
    # detections placed on the GT score 1 through the same path
    gts = pds.get_gt_annos()
    perfect = [dict(boxes_3d=g['gt_boxes'], labels_3d=g['gt_labels'],
                    scores_3d=np.ones(len(g['gt_boxes']))) for g in gts]
    assert abs(pds.evaluate(perfect)['mAP_0.50'] - 1) < 1e-6


def test_eval_hook_logs_the_map_and_restores_the_mode(inference_pair):
    _, pres, _, pds, port = inference_pair
    lines = []
    eval_fn = make_dataset_eval_fn(pds, 3, lines.append)
    port.train()
    np.random.seed(1)
    metrics = eval_fn(port, 4)
    assert port.training
    port.eval()
    assert metrics == pds.evaluate(pres)
    assert len(lines) == 1 and lines[0].startswith('[eval @ epoch 5] ')
    assert f"mAP_0.25: {metrics['mAP_0.25']:.4f}" in lines[0]


@pytest.fixture(scope='module')
def trained(tmp_path_factory):
    """The train entry point on the tiny config: 2 epochs on the CPU with
    the eval hook at every epoch.  -> (work dir, its stdout)."""
    wd = tmp_path_factory.mktemp('train') / 'wd'
    with pytest.MonkeyPatch.context() as mp:
        lines = []
        mp.setattr('builtins.print', lambda *a, **k: lines.append(
            ' '.join(str(x) for x in a)))
        train.main([TINY, '--device', 'cpu', '--work-dir', str(wd),
                    '--seed', '3', '--cfg-options', 'evaluation.interval=1',
                    'runner.max_epochs=2'])
    return wd, '\n'.join(lines)


def test_train_entry_point_runs_the_tiny_config(trained):
    wd, out = trained
    assert 'filling frozen image-feature cache' in out
    assert sorted(os.listdir(wd / 'img_feat_cache')) == \
        [f'{i}.npz' for i in range(8)]
    assert out.count('Epoch [1/2]') == 2 and out.count('Epoch [2/2]') == 2
    assert out.count('[eval @ epoch') == 2 and 'mAP_0.25: ' in out
    assert 'waiting for the loader' in out and 'training finished' in out
    # max_keep_ckpts=1: the first epoch's checkpoint is gone
    assert os.listdir(wd / 'checkpoints') == ['epoch_2.pth']
    meta = load_meta(latest_checkpoint(str(wd)))
    assert meta['CLASSES'][0] == 'bed' and len(meta['CLASSES']) == 10
    assert meta['config_file'] == 'demf_tiny.py' and meta['epoch'] == 1
    assert meta['seed'] == 3 and 'SyntheticSUNRGBD' in meta['config']
    assert meta['torch_version'] == str(torch.__version__)
    assert (wd / 'demf_tiny.py').exists()
    logs = [f for f in os.listdir(wd) if f.endswith('.log')]
    assert len(logs) == 1
    with open(wd / logs[0]) as f:
        assert 'training finished' in f.read()


def test_train_entry_point_resumes(trained, tmp_path, capsys):
    """From the checkpoint of epoch 2 to epoch 3: one more epoch, at the
    rate after the milestone (``lr_config.step=[2]``)."""
    wd, _ = trained
    ckpt = latest_checkpoint(str(wd))
    rates = []
    build = zoo.build_trainer

    def recording_build(*args, **kwargs):
        model, optimizer, step = build(*args, **kwargs)
        rates.append(step)
        return model, optimizer, step

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(zoo, 'build_trainer', recording_build)
        train.main([TINY, '--device', 'cpu', '--work-dir', str(tmp_path),
                    '--resume-from', ckpt, '--no-validate', '--cfg-options',
                    'runner.max_epochs=3'])
    out = capsys.readouterr().out
    assert f'resumed from {ckpt}' in out
    assert out.count('Epoch [3/3]') == 2 and 'Epoch [1/3]' not in out
    assert '[eval @' not in out
    assert rates[0].count == 6 and rates[0].lr == pytest.approx(0.0004)
    assert os.listdir(tmp_path / 'checkpoints') == ['epoch_3.pth']


def test_eval_entry_point_prints_the_map_and_writes_results(trained,
                                                            tmp_path, capsys):
    wd, _ = trained
    ckpt = latest_checkpoint(str(wd))
    out_file = str(tmp_path / 'results.pkl')
    metrics = eval_entry.main([TINY, ckpt, '--eval', 'mAP', '--device',
                               'cpu', '--out', out_file])
    out = capsys.readouterr().out
    assert "checkpoint meta: {'config_file': 'demf_tiny.py'" in out
    assert f"mAP_0.25: {metrics['mAP_0.25']:.4f}" in out
    assert f"mAP_0.50: {metrics['mAP_0.50']:.4f}" in out
    assert all(np.isfinite(v) for v in metrics.values())
    with open(out_file, 'rb') as f:
        results = pickle.load(f)
    assert len(results) == 4
    assert all(r['boxes_3d'].shape[1] == 7 for r in results)


def test_eval_entry_point_formats_only_and_takes_classes_from_meta(
        trained, tmp_path, capsys):
    """``data.test`` pointed at the SUN RGB-D fixture (3 scenes at batch 4:
    one filled batch; jpgs decoded) with other class names in the config
    than the checkpoint's: ``--format-only`` writes the records under the
    checkpoint's names and prints no mAP."""
    wd, _ = trained
    pipeline = Config.fromfile(TINY).data['test']['pipeline']
    cfg_file = tmp_path / 'fixture.py'
    cfg_file.write_text(
        f'_base_ = [{TINY!r}]\n'
        f"data = dict(test=dict(_delete_=True, type='SUNRGBDDataset', "
        f'data_root={FIXTURE!r}, '
        f"ann_file={os.path.join(FIXTURE, 'sunrgbd_infos_mini.pkl')!r}, "
        f"test_mode=True, classes=('a', 'b'), pipeline={pipeline!r}))\n")
    prefix = str(tmp_path / 'formatted' / 'res')
    assert eval_entry.main([
        str(cfg_file), latest_checkpoint(str(wd)), '--format-only',
        '--device', 'cpu', '--eval-options',
        f'pklfile_prefix={prefix}']) is None
    out = capsys.readouterr().out
    assert 'using CLASSES from checkpoint meta' in out and 'mAP' not in out
    assert f'formatted results written to {prefix}.pkl' in out
    with open(prefix + '.pkl', 'rb') as f:
        written = pickle.load(f)
    assert written['classes'][:2] == ['bed', 'table']
    assert [r['sample_idx'] for r in written['results']] == [0, 1, 2]
