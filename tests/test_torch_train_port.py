"""The port's training path on its own, on the CPU at a tiny size: dropout
and random proposal sampling repeat from an explicit ``torch.Generator``,
the spec sampling runs, the optax clip rule, the frozen-feature cache is
shared with the JAX package in both directions, checkpoints save and
resume, the warm-start key remap, the runner and the training entry point.
"""
import copy
import os

import numpy as np
import pytest
import torch

from demf_tpu.engine import feature_cache as jfeature_cache
from demf_tpu.zoo import load_model_cfg, tiny_demf_model_cfg
from demf_tpu_torch import train, zoo
from demf_tpu_torch.engine import (FeatureCache, Runner,
                                   attach_cached_features, batch_to_device,
                                   clip_grad_global_norm,
                                   compute_image_features, load_checkpoint,
                                   remap_img_branch_keys, save_checkpoint)

FULL = load_model_cfg('demf/demf_votenet.py')
BATCH = dict(b=2, p=1024, g=8, hw=(64, 96), valid_hw=(60, 88), seed=0)


def tiny_trainer_cfg():
    cfg = tiny_demf_model_cfg()
    cfg['pts_backbone']['sa_cfg']['ball_query_exact'] = True
    return dict(model=cfg, optimizer=FULL.optimizer,
                optimizer_config=FULL.optimizer_config,
                lr_config=FULL.lr_config)


@pytest.fixture(scope='module')
def tiny():
    """(model, optimizer, train step, cached batch); the tiny config keeps
    its decoder dropout (0.4 / 0.4 / 0.1)."""
    model, optimizer, step = zoo.build_trainer(tiny_trainer_cfg(), 'cpu')
    batch = batch_to_device(zoo.synth_demf_batch(**BATCH), 'cpu')
    batch['img_features'] = compute_image_features(model, batch)
    del batch['img']
    return model, optimizer, step, batch


def _loss(model, batch, seed, sample_mod=None):
    model.train()
    g = torch.Generator().manual_seed(seed)
    results = model(batch, sample_mod=sample_mod, generator=g)
    return float(sum(model.loss(results, batch).values()).detach()), results


def test_dropout_repeats_from_its_generator(tiny):
    model, _, _, batch = tiny
    model = copy.deepcopy(model)
    assert model.pts_bbox_head.decoder[0].layer.ffns[0].ffn_drop == 0.1
    a, _ = _loss(model, batch, 0)
    b, _ = _loss(model, batch, 0)
    c, _ = _loss(model, batch, 1)
    assert a == b
    assert a != c
    model.eval()
    with torch.no_grad():
        x = model(batch)['decode_res_all'][1]['center']
        y = model(batch)['decode_res_all'][1]['center']
    assert torch.equal(x, y)           # eval mode draws nothing


def test_train_mode_without_generator_raises(tiny):
    model, _, _, batch = tiny
    model = copy.deepcopy(model).train()
    with pytest.raises(ValueError, match='Generator'):
        model(batch)


def test_sample_mod_random_repeats_and_spec_runs(tiny):
    model, _, _, batch = tiny
    model = copy.deepcopy(model)
    _, r0 = _loss(model, batch, 3, 'random')
    _, r1 = _loss(model, batch, 3, 'random')
    _, r2 = _loss(model, batch, 4, 'random')
    assert torch.equal(r0['aggregated_points'], r1['aggregated_points'])
    assert not torch.equal(r0['aggregated_points'], r2['aggregated_points'])
    assert r0['aggregated_points'].shape == (2, 16, 3)
    loss, rs = _loss(model, batch, 3, 'spec')
    assert np.isfinite(loss)
    assert torch.equal(rs['aggregated_points'], rs['vote_points'])


def test_clip_follows_optax_rule():
    """Untouched below max_norm; scaled to exactly max_norm at or above
    (torch.nn.utils.clip_grad_norm_ would scale by max / (norm + 1e-6))."""
    p = torch.nn.Parameter(torch.zeros(2))
    p.grad = torch.tensor([3.0, 4.0])
    assert float(clip_grad_global_norm([p], 5.0)) == 5.0
    assert torch.equal(p.grad, torch.tensor([3.0, 4.0]))
    assert float(clip_grad_global_norm([p], 5.0 - 1e-6)) == 5.0
    assert torch.allclose(p.grad.norm(), torch.tensor(5.0 - 1e-6),
                          rtol=0, atol=1e-6)


def test_train_step_keeps_frozen_branch_bit_for_bit(tiny):
    _, _, _, batch = tiny
    model, _, step = zoo.build_trainer(tiny_trainer_cfg(), 'cpu')
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    metrics = step(batch, torch.Generator().manual_seed(0))
    assert all(torch.isfinite(v) for v in metrics.values())
    for name, p in model.named_parameters():
        if name.startswith(('img_backbone', 'img_neck', 'img_encoder')):
            assert torch.equal(p, before[name]), name
        elif name.endswith('sampling_offsets.weight'):
            assert not torch.equal(p, before[name]), name


@pytest.mark.parametrize('writer', ['jax', 'port'])
def test_feature_cache_is_shared_with_jax(tmp_path, writer):
    rng = np.random.RandomState(0)
    feats = [rng.randn(6, 8, 4).astype(np.float32),
             rng.randn(3, 4, 4).astype(np.float32)]
    jcache = jfeature_cache.FeatureCache(str(tmp_path))
    pcache = FeatureCache(str(tmp_path))
    (jcache if writer == 'jax' else pcache).save(7, feats)
    reader = pcache if writer == 'jax' else jcache
    got = reader.load(7)
    for g, f in zip(got, feats):
        np.testing.assert_array_equal(np.asarray(g),
                                      f.astype(np.float16).astype(np.float32))
    pcache.save(8, [torch.from_numpy(f) for f in feats])
    batch = attach_cached_features(dict(img=0, points=1), pcache, [7, 8])
    assert 'img' not in batch and batch['points'] == 1
    assert [f.shape for f in batch['img_features']] == [(2, 6, 8, 4),
                                                        (2, 3, 4, 4)]


def test_checkpoint_saves_and_resumes(tiny, tmp_path):
    _, _, _, batch = tiny
    model, optimizer, step = zoo.build_trainer(tiny_trainer_cfg(), 'cpu')
    step(batch, torch.Generator().manual_seed(0))
    path = save_checkpoint(str(tmp_path), model, optimizer, 4)
    assert path.endswith(os.path.join('checkpoints', 'epoch_5.pth'))
    fresh, fresh_opt, _ = zoo.build_trainer(tiny_trainer_cfg(), 'cpu', seed=1)
    assert load_checkpoint(path, fresh, fresh_opt) == 4
    for (k, v), w in zip(model.state_dict().items(),
                         fresh.state_dict().values()):
        assert torch.equal(v, w), k
    assert fresh_opt.state_dict()['state'].keys() == \
        optimizer.state_dict()['state'].keys()


def test_remap_img_branch_keys():
    sd = {'img_bbox_head.transformer.encoder.layers.0.norms.0.weight': 1,
          'img_bbox_head.transformer.level_embeds': 2,
          'img_bbox_head.transformer.decoder.layers.0.norms.0.weight': 3,
          'img_bbox_head.cls_branches.0.weight': 4,
          'img_backbone.conv1.weight': 5}
    assert remap_img_branch_keys(sd) == {
        'img_encoder.encoder.layers.0.norms.0.weight': 1,
        'img_encoder.level_embeds': 2,
        'img_backbone.conv1.weight': 5}


def test_runner_trains_checkpoints_and_resumes(tiny, tmp_path):
    _, _, _, batch = tiny
    model, optimizer, step = zoo.build_trainer(tiny_trainer_cfg(), 'cpu')
    lines = []
    runner = Runner(model, optimizer, step, [batch, batch], max_epochs=2,
                    log_interval=2, work_dir=str(tmp_path),
                    logger=lines.append)
    last = runner.run()
    assert len(lines) == 2 and lines[-1].startswith('Epoch [2/2][2]')
    assert np.isfinite(last['loss']) and 'grad_norm' in last
    ckpt = os.path.join(str(tmp_path), 'checkpoints', 'epoch_2.pth')
    assert os.path.exists(ckpt)
    again = Runner(model, optimizer, step, [batch], max_epochs=2)
    again.resume(ckpt)
    assert again.start_epoch == 2 and again.run() == {}


def test_train_entry_point_runs_tiny_config(tmp_path, capsys):
    cfg_file = tmp_path / 'tiny.py'
    cfg = tiny_trainer_cfg()
    cfg_file.write_text('\n'.join(f'{k} = {dict(v)!r}'
                                  for k, v in cfg.items()))
    train.main([str(cfg_file), '--steps', '2', '--batch', '2', '--points',
                '1024', '--hw', '64', '96', '--gt', '8', '--device', 'cpu',
                '--work-dir', str(tmp_path / 'wd'), '--profile'])
    out = capsys.readouterr().out
    assert 'image features of 2 scenes cached' in out
    assert out.count('Epoch [1/1]') == 2
    assert 'profiled step' in out
    assert 'phases: forward' in out and ', optimizer ' in out
    assert os.path.exists(tmp_path / 'wd' / 'checkpoints' / 'epoch_1.pth')
