"""Card tests of the entry surface of the port's launchers, fused eval
and flip aug-test: the pieces of ``chip_smoke.py``'s launcher, two-rank,
fused-eval and aug-test phases in small.  This file imports no JAX, so it
runs on a GPU machine without it:

    python -m pytest tests/test_torch_launch_card.py -m cuda --noconftest -q

On a machine without a card every test here skips.
"""
import os
import socket

import numpy as np
import pytest
import torch

from demf_tpu_torch import train, zoo
from demf_tpu_torch.engine import batch_to_device, make_eval_step
from demf_tpu_torch.engine.aug_test import merge_nms
from demf_tpu_torch.engine.fuse_bn import fuse_conv_bn
from demf_tpu_torch.tools import dp_equivalence as dpe

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOTENET = os.path.join(ROOT, 'configs', 'synthetic', 'votenet_tiny.py')
CASE = dict(config=VOTENET, batch=4, points=512)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU (the kernels build with nvcc for '
                    'sm_90a)')
    return torch.device('cuda', 0)


def _free_port():
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


@pytest.mark.cuda
def test_two_gloo_ranks_on_one_card_train_as_one_process(dev):
    """Both ranks on cuda:0 over gloo, the tiny VoteNet: the ranks the same
    bits after 2 steps, the first step's loss that of one process on the
    card within 1e-5 (the kernels take float32 only: the float64 check of
    the semantics runs on the CPU, tests/test_torch_launch.py)."""
    ranks = dpe.run_ranks([CASE], world=2, device='cuda', backend='gloo')
    one = dpe.run_case(CASE, 'cuda')
    result = dpe.compare(one, [r[0]['float32'] for r in ranks])
    assert result['same_bits'] == [] and result['loss'] <= 1e-5


@pytest.mark.cuda
def test_launcher_step_on_one_nccl_rank_launches_as_without(dev):
    """One NCCL rank through the train entry launches, step for step, what
    the entry launches without a launcher."""
    from demf_tpu_torch import ops
    kernels = ops.kernels()
    counts = []
    for extra, env in (([], {}), (['--launcher', 'pytorch'], dict(
            RANK='0', WORLD_SIZE='1', LOCAL_RANK='0', MASTER_ADDR='127.0.0.1',
            MASTER_PORT=str(_free_port())))):
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            for k in kernels.values():
                k.launches = 0
            train.main([VOTENET, '--synthetic', '--steps', '2', '--batch',
                        '4', '--points', '2048'] + extra)
            counts.append({n: k.launches for n, k in kernels.items()})
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
    assert counts[0] == counts[1] and counts[0]['fps'] > 0


@pytest.mark.cuda
def test_fused_model_detects_as_unfused_on_the_card(dev):
    model = zoo.build_detector(zoo.tiny_demf_model_cfg(), dev, seed=0)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith('conv_reg.bias'):
                p[3:6] += 1.5
    batch = batch_to_device(zoo.synth_demf_batch(2, p=2048, hw=(64, 96)),
                            dev)
    want = make_eval_step(model)(batch)
    assert fuse_conv_bn(model) > 0
    got = make_eval_step(model)(batch)
    v = want['valid']
    assert torch.equal(got['valid'], v) and int(v.sum()) > 0
    top = want['boxes_3d'][v].abs().max()
    assert (got['boxes_3d'][v] - want['boxes_3d'][v]).abs().max() <= \
        1e-4 * top


@pytest.mark.cuda
@pytest.mark.parametrize('per_class', [512, 1024])
def test_merge_cut_by_class_on_the_card_equals_plain(dev, per_class):
    """K8 over (scene, class) rows at the aug-test's width (2 x 5,120
    detections a request, 1,024 a class after the merge) against the plain
    version on the CPU."""
    rng = np.random.RandomState(per_class)
    b, m = 2, 10 * per_class
    boxes = torch.from_numpy(np.concatenate(
        [rng.rand(b, m, 3) * 4, rng.rand(b, m, 3) * 0.8 + 0.3,
         rng.uniform(-np.pi, np.pi, (b, m, 1))], -1).astype(np.float32))
    scores = torch.from_numpy(rng.rand(b, m).astype(np.float32))
    labels = torch.from_numpy(np.repeat(np.arange(10), per_class)[None]
                              .repeat(b, 0))
    valid = torch.from_numpy(rng.rand(b, m) < 0.5)
    want = merge_nms(boxes, scores, labels, valid, 0.25)
    got = merge_nms(boxes.to(dev), scores.to(dev), labels.to(dev),
                    valid.to(dev), 0.25)
    assert torch.equal(got.cpu(), want)
