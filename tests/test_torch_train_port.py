"""The port's training path on its own, on the CPU at a tiny size: dropout
and random proposal sampling repeat from an explicit ``torch.Generator``,
the spec sampling runs, the optax clip rule, the frozen-feature cache is
shared with the JAX package in both directions, checkpoints save and
resume (with the update count, so the LR schedule goes on), carry meta and
are pruned, the warm-start key remap, the runner with its eval hook, the training
entry point's synthetic mode and its schedule, a resumed run's shuffles,
and the stage-1 pretrain through the entry with its hand-over to stage 2.
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
                                   compute_image_features, latest_checkpoint,
                                   load_checkpoint, load_meta, load_weights,
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
    train.main([str(cfg_file), '--synthetic', '--steps', '2', '--batch', '2',
                '--points', '1024', '--hw', '64', '96', '--gt', '8',
                '--device', 'cpu', '--work-dir', str(tmp_path / 'wd'),
                '--profile'])
    out = capsys.readouterr().out
    assert 'image features of 2 scenes cached' in out
    assert out.count('Epoch [1/1]') == 2
    assert 'profiled step' in out
    assert 'phases: forward' in out and ', optimizer ' in out
    assert os.path.exists(tmp_path / 'wd' / 'checkpoints' / 'epoch_1.pth')


def _record_rates(optimizer):
    """Every base learning rate ``optimizer.step`` is called with."""
    rates, step = [], optimizer.step

    def recording_step(*args, **kwargs):
        rates.append(optimizer.param_groups[0]['lr'] /
                     optimizer.param_groups[0]['lr_mult'])
        return step(*args, **kwargs)

    optimizer.step = recording_step
    return rates


def _scheduled_trainer(batches):
    """The tiny model without dropout (so that a run repeats exactly), a
    schedule whose warmup (2 steps) and milestone (epoch 1) fall inside
    two epochs of three steps, and three cached batches."""
    cfg = tiny_trainer_cfg()
    tl = cfg['model']['pts_bbox_head']['decoder']['transformerlayers']
    tl['ffn_dropout'] = 0.0
    tl['attn_cfgs'] = [dict(c, dropout=0.0) for c in tl['attn_cfgs']]
    cfg['lr_config'] = dict(policy='step', warmup='linear', warmup_iters=2,
                            warmup_ratio=0.25, step=[1])
    model, optimizer, step = zoo.build_trainer(cfg, 'cpu', steps_per_epoch=3)
    if not batches:
        for seed in range(3):
            b = batch_to_device(zoo.synth_demf_batch(**dict(BATCH, seed=seed)),
                                'cpu')
            b['img_features'] = compute_image_features(model, b)
            del b['img']
            batches.append(b)
    return model, optimizer, step, _record_rates(optimizer)


def test_resume_continues_the_lr_schedule_and_the_weights(tmp_path):
    """Two epochs unbroken against one epoch, a resume in a fresh trainer,
    and one more: the rate of every step and the final weights are equal
    (the update count travels in the checkpoint)."""
    batches = []
    model, optimizer, step, rates = _scheduled_trainer(batches)
    Runner(model, optimizer, step, batches, max_epochs=2,
           logger=lambda m: None).run()
    base = FULL.optimizer['lr']
    assert rates[:3] == pytest.approx([base * 0.25, base * 0.625, base])
    assert rates[3:] == pytest.approx([base * 0.1] * 3)

    first, first_opt, first_step, first_rates = _scheduled_trainer(batches)
    Runner(first, first_opt, first_step, batches, max_epochs=1,
           work_dir=str(tmp_path), logger=lambda m: None).run()
    ckpt = latest_checkpoint(str(tmp_path))
    again, again_opt, again_step, again_rates = _scheduled_trainer(batches)
    runner = Runner(again, again_opt, again_step, batches, max_epochs=2,
                    logger=lambda m: None)
    runner.resume(ckpt)
    assert runner.start_epoch == 1 and again_step.count == 3
    runner.run()
    assert first_rates + again_rates == rates
    assert again_step.count == step.count == 6
    for (k, v), w in zip(model.state_dict().items(),
                         again.state_dict().values()):
        assert torch.equal(v, w), k


def test_checkpoints_carry_meta_and_are_pruned(tiny, tmp_path):
    model, optimizer, step, batch = tiny
    wd = str(tmp_path)
    assert latest_checkpoint(wd) is None
    meta = dict(config='model = {}', CLASSES=['bed', 'chair'], seed=3,
                versions=dict(torch='2'))
    for epoch in range(4):
        save_checkpoint(wd, model, optimizer, epoch, count=10 * epoch,
                        keep=2, meta=meta)
    assert sorted(os.listdir(os.path.join(wd, 'checkpoints'))) == \
        ['epoch_3.pth', 'epoch_4.pth']
    latest = latest_checkpoint(wd)
    assert latest.endswith('epoch_4.pth')
    assert load_meta(latest) == dict(meta, epoch=3)
    save_checkpoint(wd, model, optimizer, 9, meta=meta)       # keeps all
    assert latest_checkpoint(wd).endswith('epoch_10.pth')
    assert len(os.listdir(os.path.join(wd, 'checkpoints'))) == 3
    bare = save_checkpoint(str(tmp_path / 'bare'), model, optimizer, 0)
    assert load_meta(bare) is None
    fresh_step = zoo.build_trainer(tiny_trainer_cfg(), 'cpu')[2]
    assert load_checkpoint(latest, model, optimizer, fresh_step) == 3
    assert fresh_step.count == 30
    with pytest.raises(TypeError, match='plain types'):
        save_checkpoint(wd, model, optimizer, 0,
                        meta=dict(torch_version=torch.__version__))


def test_runner_prunes_writes_meta_and_fires_the_eval_hook(tiny, tmp_path):
    _, _, _, batch = tiny
    model, optimizer, step = zoo.build_trainer(tiny_trainer_cfg(), 'cpu')
    seen = []

    def eval_fn(m, epoch):
        seen.append((epoch, m is model, m.training))

    runner = Runner(model, optimizer, step, [batch], max_epochs=4,
                    work_dir=str(tmp_path), logger=lambda m: None,
                    eval_fn=eval_fn, eval_interval=2, max_keep_ckpts=1,
                    meta=dict(CLASSES=['bed']))
    runner.run()
    assert seen == [(1, True, True), (3, True, True)]
    assert os.listdir(tmp_path / 'checkpoints') == ['epoch_4.pth']
    assert load_meta(latest_checkpoint(str(tmp_path))) == \
        dict(CLASSES=['bed'], epoch=3)
    assert runner.epoch_s > 0 and 0 <= runner.loader_wait_s < runner.epoch_s


def test_load_weights_warm_starts_through_the_remap(tiny, tmp_path):
    """A stage-1 file (encoder under ``img_bbox_head.transformer``, a
    decoder that DeMF drops) and a checkpoint of the port both load."""
    model = tiny[0]
    fresh = zoo.build_detector(tiny_trainer_cfg()['model'], 'cpu', seed=5)
    stage1 = {}
    for k, v in model.state_dict().items():
        if k.startswith('img_encoder.'):
            k = k.replace('img_encoder.', 'img_bbox_head.transformer.', 1)
        stage1[k] = v
    stage1['img_bbox_head.transformer.decoder.layers.0.w'] = torch.zeros(1)
    path = str(tmp_path / 'stage1.pth')
    torch.save(stage1, path)
    assert load_weights(path, fresh) == ([], [])
    for (k, v), w in zip(model.state_dict().items(),
                         fresh.state_dict().values()):
        assert torch.equal(v, w), k
    ckpt = save_checkpoint(str(tmp_path), model, tiny[1], 0)
    assert load_weights(ckpt, fresh) == ([], [])


def test_train_entry_point_takes_the_epochs_length_for_its_schedule(
        tmp_path, monkeypatch):
    """A step schedule (milestones at epochs 4 and 5, as ``schedule_3x``
    has them at 24 and 32) over an epoch of 6 steps: step 4, where a
    schedule that took the milestones for step counts would decay, still
    runs at the base rate, in the dataset mode (the loader's length) and in
    the synthetic mode (``--steps``)."""
    rates = []
    build = zoo.build_trainer

    def recording_build(*args, **kwargs):
        model, optimizer, step = build(*args, **kwargs)
        rates.append(_record_rates(optimizer))
        return model, optimizer, step

    monkeypatch.setattr(zoo, 'build_trainer', recording_build)
    cfg = os.path.join(os.path.dirname(zoo.__file__), 'configs',
                       'demf_tiny.py')
    train.main([cfg, '--device', 'cpu', '--work-dir', str(tmp_path / 'wd'),
                '--no-validate', '--cfg-options', 'data.samples_per_gpu=1',
                'data.train.num_scenes=6', 'lr_config.step=[4,5]',
                'cached_img_features=False'])
    train.main([cfg, '--synthetic', '--steps', '6', '--batch', '1',
                '--points', '256', '--hw', '64', '96', '--gt', '4',
                '--device', 'cpu', '--cfg-options', 'lr_config.step=[4,5]'])
    assert len(rates[0]) == 6 and len(rates[1]) == 6
    for run in rates:
        assert run[4] == pytest.approx(0.004) and set(run) == {run[4]}


def test_entry_points_stop_without_a_card_and_refuse_what_is_not_ported(
        tmp_path, capsys):
    from demf_tpu_torch import eval as eval_entry
    cfg = os.path.join(os.path.dirname(zoo.__file__), 'configs',
                       'demf_tiny.py')
    if not torch.cuda.is_available():
        for main, argv in ((train.main, [cfg]),
                           (eval_entry.main, [cfg, 'none.pth'])):
            with pytest.raises(SystemExit, match='no CUDA device'):
                main(argv)
    # nothing is refused as not ported any more: a launcher without its
    # env raises, naming it; --gpus above 1 without one is refused
    for main, argv, launcher in (
            (train.main, [cfg], 'pytorch'),
            (eval_entry.main, [cfg, 'c.pth'], 'slurm')):
        with pytest.raises(RuntimeError, match=f'--launcher {launcher}'):
            with pytest.MonkeyPatch.context() as mp:
                for name in ('RANK', 'WORLD_SIZE', 'MASTER_ADDR',
                             'MASTER_PORT', 'SLURM_PROCID', 'SLURM_NTASKS'):
                    mp.delenv(name, raising=False)
                main(argv + ['--device', 'cpu', '--launcher', launcher])
    with pytest.raises(SystemExit):
        train.main([cfg, '--device', 'cpu', '--gpus', '2'])
    assert '--launcher pytorch' in capsys.readouterr().err
    # a config's bf16 / fp16 is no longer refused: both entries take the
    # bf16 policy and run on the CPU
    wd = tmp_path / 'bf16'
    for key in ('bf16=True', 'fp16.loss_scale=512.0'):
        train.main([cfg, '--device', 'cpu', '--work-dir', str(wd),
                    '--no-validate', '--cfg-options', key])
        assert 'compute dtype: bfloat16' in capsys.readouterr().out
        metrics = eval_entry.main([cfg, str(wd / 'checkpoints' /
                                             'epoch_1.pth'), '--device',
                                   'cpu', '--cfg-options', key])
        assert set(metrics) >= {'mAP_0.25', 'mAP_0.50'}
        assert all(np.isfinite(v) for v in metrics.values())


# -- a resumed run shuffles as the unbroken run does ------------------------

class _Numbers:
    """A dataset of 12 numbered samples."""

    def __len__(self):
        return 12

    def __getitem__(self, i):
        return int(i)


class _Recorder:
    """A train step that only records the batches it is given."""

    def __init__(self):
        self.count = 0
        self.seen = []

    def __call__(self, batch, generator):
        self.seen.append(batch.tolist())
        self.count += 1
        return {}


def _shuffling_runner(work_dir=None, max_epochs=4, cached=False):
    from demf_tpu_torch.data import DataLoader
    from demf_tpu_torch.engine import CachedFeatureLoader
    loader = DataLoader(_Numbers(), batch_size=4, shuffle=True, seed=3,
                        num_threads=1, prefetch=0, collate_fn=np.asarray)
    if cached:     # the wrapper of the stage-2 step passes the epoch on

        class Passing(CachedFeatureLoader):
            def __iter__(self):
                return iter(self.loader)

        loader = Passing(loader, cache=None)
    model = torch.nn.Linear(1, 1)
    step = _Recorder()
    runner = Runner(model, torch.optim.AdamW(model.parameters()), step,
                    loader, max_epochs=max_epochs, work_dir=work_dir,
                    logger=lambda m: None)
    return runner, step


@pytest.mark.parametrize('cached', [False, True])
@pytest.mark.parametrize('stop_at', [1, 2, 3])
def test_resumed_run_shuffles_as_the_unbroken_run(tmp_path, stop_at, cached):
    """Epoch k draws its order from ``seed + k``: after a resume at epoch k
    the loader goes on with epoch k's order, not with epoch 0's."""
    runner, unbroken = _shuffling_runner(cached=cached)
    runner.run()
    assert len(unbroken.seen) == 4 * 3
    epochs = [unbroken.seen[3 * e:3 * e + 3] for e in range(4)]
    assert len({str(e) for e in epochs}) == 4        # every epoch its own
    for epoch in epochs:
        assert sorted(sum(epoch, [])) == list(range(12))

    first, _ = _shuffling_runner(str(tmp_path), max_epochs=stop_at,
                                 cached=cached)
    first.run()
    again, resumed = _shuffling_runner(cached=cached)
    again.resume(latest_checkpoint(str(tmp_path)))
    assert again.start_epoch == stop_at
    again.run()
    assert resumed.seen == unbroken.seen[3 * stop_at:]


def test_loader_set_epoch_names_the_shuffle():
    from demf_tpu_torch.data import DataLoader
    kw = dict(batch_size=4, shuffle=True, seed=1, num_threads=1, prefetch=0,
              collate_fn=list)
    a, b = DataLoader(_Numbers(), **kw), DataLoader(_Numbers(), **kw)
    orders = [list(a) for _ in range(3)]
    b.set_epoch(2)
    assert list(b) == orders[2] and list(b) == list(a)   # both at epoch 3
    b.set_epoch(0)
    assert list(b) == orders[0]


# -- the stage-1 pretrain through the entry, and its hand-over to stage 2 --

PRETRAIN_CFG = os.path.join(os.path.dirname(zoo.__file__), 'configs',
                            'detr_pretrain_tiny.py')


@pytest.fixture(scope='module')
def pretrain_run(tmp_path_factory):
    """``train.main`` on the tiny pretrain config: one epoch of 2 steps and
    a checkpoint; then a resumed run to 2 epochs in the same work dir."""
    wd = str(tmp_path_factory.mktemp('pretrain'))
    train.main([PRETRAIN_CFG, '--device', 'cpu', '--work-dir', wd])
    first = latest_checkpoint(wd)
    train.main([PRETRAIN_CFG, '--device', 'cpu', '--work-dir', wd,
                '--resume-from', first, '--cfg-options',
                'runner.max_epochs=2'])
    return wd, first, latest_checkpoint(wd)


def test_pretrain_entry_trains_checkpoints_and_resumes(pretrain_run):
    wd, first, second = pretrain_run
    assert first.endswith('epoch_1.pth') and second.endswith('epoch_2.pth')
    a = torch.load(first, weights_only=True)
    b = torch.load(second, weights_only=True)
    assert (a['epoch'], a['count'], b['epoch'], b['count']) == (0, 2, 1, 4)
    assert a['meta']['config_file'] == 'detr_pretrain_tiny.py'
    assert 'ImVoteNet_Deformdetr' in a['meta']['config']
    logs = [f for f in os.listdir(wd) if f.endswith('.log')]
    text = ''.join(open(os.path.join(wd, f)).read() for f in logs)
    assert text.count('Epoch [1/1]') == 2 and text.count('Epoch [2/2]') == 2
    assert 'loss_cls.d0' in text and 'loss_iou' in text
    assert 'resumed from' in text
    moved = frozen = 0
    for key, v in a['state_dict'].items():
        if not v.is_floating_point() or 'running_' in key:
            continue
        if key.startswith(('img_backbone.conv1', 'img_backbone.bn1',
                           'img_backbone.layer1.')):
            assert torch.equal(v, b['state_dict'][key]), key
            frozen += 1
        else:
            moved += not torch.equal(v, b['state_dict'][key])
    assert frozen == 33 and moved > 200


def test_pretrain_entry_synthetic_mode(capsys):
    train.main([PRETRAIN_CFG, '--synthetic', '--steps', '2', '--batch', '2',
                '--hw', '64', '96', '--gt', '5', '--device', 'cpu',
                '--profile'])
    out = capsys.readouterr().out
    assert 'image features' not in out        # nothing to cache: it trains
    assert out.count('Epoch [1/1]') == 2 and 'loss_bbox.d0' in out
    assert 'profiled step' in out and 'phases: forward' in out


def test_pretrain_checkpoint_warm_starts_stage_two(pretrain_run):
    """The hand-over: a checkpoint that the port's own pretrain wrote loads
    into a DeMF model through ``load_from``: backbone and neck as they are,
    the head's encoder and level embeds as ``img_encoder``, its decoder and
    branches dropped; nothing else is unused and only the point branch and
    the fusion head are missing.  Then a serving forward runs."""
    _, _, ckpt = pretrain_run
    cfg = tiny_demf_model_cfg()
    cfg['pts_backbone']['sa_cfg']['ball_query_exact'] = True
    cfg['img_encoder']['encoder']['num_layers'] = 1      # as the pretrain's
    model = zoo.build_detector(cfg, 'cpu', seed=9)
    missing, unexpected = load_weights(ckpt, model)
    assert unexpected == []
    assert missing and all(k.startswith(('pts_backbone.', 'pts_bbox_head.'))
                           for k in missing)
    stage1 = torch.load(ckpt, weights_only=True)['state_dict']
    got = model.state_dict()
    carried = 0
    for key, v in stage1.items():
        if key.startswith(('img_backbone.', 'img_neck.')):
            target = key
        elif key.startswith(('img_bbox_head.transformer.encoder.',
                             'img_bbox_head.transformer.level_embeds')):
            target = key.replace('img_bbox_head.transformer', 'img_encoder')
        else:
            assert key.startswith('img_bbox_head.'), key
            continue
        assert torch.equal(got[target], v), key
        carried += 1
    assert carried == sum(k.startswith(('img_backbone.', 'img_neck.',
                                        'img_encoder.')) for k in got)
    batch = batch_to_device(zoo.synth_demf_batch(**BATCH), 'cpu')
    with torch.no_grad():
        det = model.get_bboxes(model(batch), batch)
    assert torch.isfinite(det['boxes_3d']).all()
