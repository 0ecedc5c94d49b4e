"""The port's standard ``VoteHead`` and ``PartialBinBasedBBoxCoder``
against the JAX package's, on the CPU.

The coder: encode, ``split_pred`` and decode on the same inputs equal to
the JAX coder's within 1e-6 (integer fields equal), and the roundtrip of
``tests/test_vote_head_standard.py``.  The model: the tiny standard
VoteNet of that test file (``VoteHead``, per-class mean sizes, proposals
aggregated around the votes in training), held with the checks and
bounds of ``tests/test_torch_votenet.py``: the train forward, every loss
term, the empty-GT sample, one train step and ``get_bboxes`` (on 8,192
points a scene, so that boxes of the mean sizes hold points).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from demf_tpu.core.coders import PartialBinBasedBBoxCoder as JaxCoder
from demf_tpu_torch.core.coders import PartialBinBasedBBoxCoder
from test_torch_votenet import (RESULT_KEYS, TINY, check_detections,
                                check_losses, check_results, check_step,
                                exact_cfg, run_pair)
from test_vote_head_standard import MEAN_SIZES, tiny_std_votenet_cfg

MEANS = np.random.RandomState(7).uniform(0.3, 2.0, (10, 3)).astype(
    np.float32)


def _coders():
    return (PartialBinBasedBBoxCoder(12, 10, MEANS),
            JaxCoder(num_dir_bins=12, num_sizes=10, mean_sizes=MEANS))


def _close(got, want, tol=1e-6):
    got = got.detach().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want)
    if np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_partial_bin_encode_matches_jax():
    coder, jcoder = _coders()
    rng = np.random.RandomState(1)
    boxes = np.concatenate([rng.randn(3, 9, 3), rng.rand(3, 9, 3) + 0.2,
                            rng.uniform(-7, 7, (3, 9, 1))],
                           -1).astype(np.float32)
    labels = rng.randint(0, 10, (3, 9))
    got = coder.encode(torch.from_numpy(boxes), torch.from_numpy(labels))
    want = jcoder.encode(jnp.asarray(boxes), jnp.asarray(labels))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        _close(g, w)


def test_partial_bin_split_and_decode_match_jax():
    coder, jcoder = _coders()
    rng = np.random.RandomState(2)
    cls = rng.randn(2, 12, 16).astype(np.float32)
    reg = rng.randn(2, 3 + 12 * 2 + 10 * 4, 16).astype(np.float32)
    xyz = rng.randn(2, 16, 3).astype(np.float32)
    got = coder.split_pred(torch.from_numpy(cls), torch.from_numpy(reg),
                           torch.from_numpy(xyz))
    want = jcoder.split_pred(jnp.asarray(cls), jnp.asarray(reg),
                             jnp.asarray(xyz))
    assert set(got) == set(want)
    for key in want:
        _close(got[key], want[key])
    _close(coder.decode(got), jcoder.decode(want), 1e-5)


def test_partial_bin_roundtrip():
    """As ``tests/test_vote_head_standard.py``: a prediction built from the
    targets decodes back to the GT boxes (gravity centers)."""
    coder = PartialBinBasedBBoxCoder(12, 10, MEAN_SIZES)
    rng = np.random.RandomState(0)
    n = 6
    gt = np.concatenate([rng.randn(n, 3), rng.rand(n, 3) + 0.5,
                         rng.uniform(-np.pi, np.pi, (n, 1))],
                        -1).astype(np.float32)
    labels = torch.from_numpy(rng.randint(0, 10, n))
    center, scls, sres, dcls, dres = coder.encode(torch.from_numpy(gt),
                                                  labels)
    out = dict(center=center[None],
               dir_class=torch.nn.functional.one_hot(dcls, 12)[None] * 10.,
               dir_res=dres[:, None].repeat(1, 12)[None],
               size_class=torch.nn.functional.one_hot(scls, 10)[None] * 10.,
               size_res=sres[:, None, :].repeat(1, 10, 1)[None])
    dec = coder.decode(out)[0].numpy()
    np.testing.assert_allclose(dec[:, :3], center.numpy(), atol=1e-5)
    np.testing.assert_allclose(dec[:, 3:6], gt[:, 3:6], atol=1e-4)
    yaw = np.arctan2(np.sin(gt[:, 6]), np.cos(gt[:, 6]))
    np.testing.assert_allclose(np.cos(dec[:, 6] - yaw), 1.0, atol=1e-5)


@pytest.fixture(scope='module')
def pair():
    # the mean sizes of 0.8-1 m hold more than 5 points (the non-empty
    # test before the NMS) only in a denser cloud
    return run_pair(exact_cfg(tiny_std_votenet_cfg()), TINY, points=8192)


STD_KEYS = RESULT_KEYS + ('center', 'size_class', 'size_res_norm',
                          'size_res')


def test_train_forward_matches_jax(pair):
    jax_out, port = pair
    assert port['results']['size_res_norm'].shape == (2, 16, 10, 3)
    check_results(port['results'], jax_out['results'], STD_KEYS, 1e-3)


def test_each_loss_term_matches_jax(pair):
    jax_out, port = pair
    assert set(jax_out['losses']) == {
        'vote_loss', 'objectness_loss', 'center_loss', 'dir_class_loss',
        'dir_res_loss', 'size_class_loss', 'size_res_loss', 'semantic_loss'}
    for key, w in jax_out['losses'].items():
        assert float(w) > 0, key
    check_losses(port['losses'], jax_out['losses'])


def test_empty_gt_losses_match_jax(pair):
    jax_out, port = pair
    for v in port['empty_losses'].values():
        assert torch.isfinite(v)
    check_losses(port['empty_losses'], jax_out['empty_losses'])


def test_train_step_matches_jax(pair):
    jax_out, port = pair
    check_step(jax_out, port,
               TINY.optimizer_config['grad_clip']['max_norm'])


def test_eval_forward_and_get_bboxes_match_jax(pair):
    jax_out, port = pair
    check_results(port['eval_results'], jax_out['eval_results'], STD_KEYS,
                  1e-4)
    check_detections(port['det'], jax_out['det'])
    assert port['det']['boxes_3d'].shape == (2, 160, 7)
