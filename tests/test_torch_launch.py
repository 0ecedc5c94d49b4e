"""Data parallelism over ranks and the launchers of the port's entry
points, on the CPU (gloo).

* ``parallel.resolve_launcher_env`` equals the JAX package's function on
  the env dicts of ``tests/test_multihost.py``, errors included; the JAX
  package's auto-detection (``{}``) is refused at the init.
* Two gloo processes against one process (``tools/dp_equivalence.py``) on
  the tiny VoteNet, DeMF (every dropout 0) and FCAF3D, 2 steps each on
  their rows of the same synthetic global batch: the ranks' parameters
  the same bits, in float32 and in float64, and the float64 ones equal to
  the one-process run's within the JAX package's own tolerance (rtol
  2e-5, atol 2e-6, ``tests/test_multihost.py``).  In float32 two float
  schedules already part further than that: the gradient of a bias just
  before a train-mode BatchNorm is rounding noise, which AdamW's first
  steps turn into moves of the learning rate's size (one process on 1
  and on 2 threads parts by 1.5 of such a tensor's largest).  In float64
  that noise stays far under Adam's eps, so what is left is the
  semantics: global statistics, normalizers and gradient.
* The entry points under ``--launcher pytorch`` on two ranks: training,
  then the eval entry gathering by a collective (``--gpu-collect``) and
  through pickles (``--tmpdir``), each result list equal to one rank's.
* The CLI's new flags and its refusals.
"""
import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from demf_tpu.parallel import mesh as jmesh
from demf_tpu_torch import eval as eval_entry
from demf_tpu_torch import train
from demf_tpu_torch.engine import cli
from demf_tpu_torch.parallel import (global_sum, init_distributed,
                                     mean_share, resolve_launcher_env,
                                     rows_of_rank, shard_batch)
from demf_tpu_torch.tools import dp_equivalence as dpe

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
VOTENET = os.path.join(ROOT, 'configs', 'synthetic', 'votenet_tiny.py')

ENVS = [
    ('pytorch', {'RANK': '3', 'WORLD_SIZE': '8', 'MASTER_ADDR': '10.0.0.1',
                 'MASTER_PORT': '29400'}),
    ('slurm', {'SLURM_PROCID': '2', 'SLURM_NTASKS': '4',
               'SLURM_STEP_NODELIST': 'tpu-node[003-006],tpu-node009'}),
    ('slurm', {'SLURM_PROCID': '0', 'SLURM_NTASKS': '2',
               'SLURM_JOB_NODELIST': 'hostA,hostB', 'MASTER_PORT': '12345'}),
    ('mpi', {'OMPI_COMM_WORLD_RANK': '1', 'OMPI_COMM_WORLD_SIZE': '2',
             'MASTER_ADDR': 'head', 'MASTER_PORT': '29500'}),
    ('jax', {'JAX_COORDINATOR_ADDRESS': 'c:1', 'JAX_NUM_PROCESSES': '2',
             'JAX_PROCESS_ID': '1'}),
    ('jax', {}),
    ('pytorch', {}),
    ('mpi', {'MASTER_ADDR': 'h'}),
    ('slurm', {'SLURM_PROCID': '0', 'SLURM_NTASKS': '1'}),
]


@pytest.mark.parametrize('launcher,env', ENVS)
def test_resolve_launcher_env_equals_jax(launcher, env):
    try:
        want = jmesh.resolve_launcher_env(launcher, dict(env))
    except RuntimeError as e:
        assert launcher in str(e)
        with pytest.raises(RuntimeError, match=launcher):
            resolve_launcher_env(launcher, dict(env))
        return
    assert resolve_launcher_env(launcher, dict(env)) == want


@pytest.mark.parametrize('env', [{}, {'JAX_COORDINATOR_ADDRESS': 'c:1'}])
def test_init_refuses_what_it_cannot_resolve(env):
    """The JAX package's auto-detection has no counterpart: refused by
    name, as is a missing env (no quiet single-process run)."""
    with pytest.raises(RuntimeError, match='--launcher jax'):
        init_distributed('jax', 'cpu', environ=env)
    with pytest.raises(RuntimeError, match='--launcher pytorch'):
        init_distributed('pytorch', 'cpu', environ={'RANK': '0'})


def test_rows_and_shares_without_a_group():
    assert rows_of_rank(16, 1, 2) == slice(8, 16)
    with pytest.raises(ValueError, match='do not divide the global batch'):
        rows_of_rank(6, 0, 4)
    batch = {'points': np.zeros((4, 3)), 'img_meta': {'x': np.ones(4)},
             'img_features': (torch.zeros(4, 2),)}
    assert shard_batch(batch) is batch
    half = shard_batch(batch, 1, 2)
    assert half['points'].shape == (2, 3) and \
        half['img_meta']['x'].shape == (2,) and \
        tuple(half['img_features'][0].shape) == (2, 2)
    x = torch.arange(6.0, requires_grad=True)
    assert global_sum(x) is x
    assert torch.equal(mean_share(x), x.mean())


DP_CASES = {
    'votenet': dict(config=VOTENET, batch=4, points=512),
    'demf': dict(config=os.path.join(ROOT, 'demf_tpu_torch', 'configs',
                                     'demf_tiny.py'),
                 batch=4, points=256, hw=(64, 96), gt=4),
    'fcaf3d': dict(config=os.path.join(ROOT, 'configs', 'synthetic',
                                       'fcaf3d_tiny.py'),
                   batch=4, points=1024),
}


@pytest.fixture(scope='module')
def two_ranks():
    """Every case of ``DP_CASES`` on two gloo ranks, in float32 and float64
    (one pair of processes for all): {case: [rank 0's, rank 1's]}."""
    names = sorted(DP_CASES)
    ranks = dpe.run_ranks([DP_CASES[n] for n in names], world=2,
                          device='cpu', backend='gloo', steps=2, threads=1,
                          dtypes=('float32', 'float64'))
    return {n: [r[i] for r in ranks] for i, n in enumerate(names)}


@pytest.mark.parametrize('case', sorted(DP_CASES))
def test_two_gloo_ranks_train_as_one_process(two_ranks, case):
    for name, dtype in (('float32', torch.float32),
                        ('float64', torch.float64)):
        one = dpe.run_case(DP_CASES[case], 'cpu', dtype=dtype)
        mine = [r[name] for r in two_ranks[case]]
        result = dpe.compare(one, mine)
        assert result['same_bits'] == [], (name, result['same_bits'])
        # the first step's loss is the global batch's on both sides
        assert result['loss'] <= (1e-5 if name == 'float32' else 1e-12)
        assert mine[0]['all_reduce_s'] and len(mine[0]['losses']) == 2
        if name == 'float64':
            assert result['allclose'] == [], result['allclose'][:5]
            assert result['stats'][1] <= 1e-10, result['stats']


def _free_port():
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


# a test pipeline without random draws, so the ranks' eval can be held to
# one rank's scene by scene; 2 scenes a batch (1 a rank in training)
_DETERMINISTIC = '''
_base_ = [{base!r}]
data = dict(samples_per_gpu=2, test=dict(pipeline=[
    dict(type='LoadPointsFromFile', coord_type='DEPTH', shift_height=True,
         load_dim=6, use_dim=[0, 1, 2]),
    dict(type='DefaultFormatBundle3D', class_names=('bed', 'table')),
    dict(type='Collect3D', keys=['points'])]))
runner = dict(max_epochs=1)
'''

_RANK = '''
import os, sys
from demf_tpu_torch import eval as ev, train
cfg, wd, ports = sys.argv[1], sys.argv[2], sys.argv[3:]
os.environ['MASTER_PORT'] = ports[0]
train.main([cfg, '--device', 'cpu', '--launcher', 'pytorch', '--work-dir',
            wd, '--no-validate'])
ckpt = os.path.join(wd, 'checkpoints', 'epoch_1.pth')
os.environ['MASTER_PORT'] = ports[1]
ev.main([cfg, ckpt, '--device', 'cpu', '--launcher', 'pytorch',
         '--gpu-collect', '--out', os.path.join(wd, 'collective.pkl')])
os.environ['MASTER_PORT'] = ports[2]
ev.main([cfg, ckpt, '--device', 'cpu', '--launcher', 'pytorch', '--tmpdir',
         os.path.join(wd, 'parts'), '--out', os.path.join(wd, 'pickles.pkl')])
'''


def test_entry_points_under_a_launcher_on_two_ranks(tmp_path, capsys):
    cfg = tmp_path / 'votenet_tiny_dp.py'
    cfg.write_text(_DETERMINISTIC.format(base=VOTENET))
    wd = tmp_path / 'wd'
    ports = [str(_free_port()) for _ in range(3)]
    env = dict(os.environ, WORLD_SIZE='2', MASTER_ADDR='127.0.0.1',
               OMP_NUM_THREADS='1',
               PYTHONPATH=ROOT + os.pathsep + os.environ.get('PYTHONPATH',
                                                              ''))
    procs = [subprocess.Popen(
        [sys.executable, '-c', _RANK, str(cfg), str(wd)] + ports,
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), cwd=str(tmp_path),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    logs = [p.communicate(timeout=300)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    # rank 0 alone logs, dumps the config and writes the checkpoint
    assert 'rank 0 of 2' in logs[0] and 'Epoch [1/1]' in logs[0]
    assert 'Epoch' not in logs[1] and 'mAP' not in logs[1]
    assert sorted(os.listdir(wd / 'checkpoints')) == ['epoch_1.pth']
    assert len([f for f in os.listdir(wd) if f.endswith('.log')]) == 1
    assert not os.listdir(wd / 'parts')          # the pickles are removed
    one = tmp_path / 'one.pkl'
    eval_entry.main([str(cfg), str(wd / 'checkpoints' / 'epoch_1.pth'),
                     '--device', 'cpu', '--out', str(one)])
    with open(one, 'rb') as f:
        want = pickle.load(f)
    assert len(want) == 8
    for name in ('collective.pkl', 'pickles.pkl'):
        with open(wd / name, 'rb') as f:
            got = pickle.load(f)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert list(g) == list(w)
            for k in w:
                np.testing.assert_array_equal(g[k], w[k])


def test_cli_takes_every_flag_and_refuses_by_name(tmp_path, capsys,
                                                  monkeypatch):
    for name in ('MASTER_ADDR', 'MASTER_PORT', 'RANK', 'WORLD_SIZE'):
        monkeypatch.delenv(name, raising=False)
    args = cli.parse_args([VOTENET, '--deterministic', '--local_rank', '3',
                           '--launcher', 'slurm'])
    assert (args.deterministic, args.local_rank) == (True, 3)
    assert cli.parse_args([VOTENET, '--gpus', '1']).gpus == 1
    assert cli.parse_args([VOTENET, '--gpu-ids', '2']).gpu_ids == [2]
    args = cli.parse_args_test([VOTENET, 'c.pth', '--gpu-collect',
                                '--tmpdir', 'd', '--fuse-conv-bn', '--show',
                                '--show-dir', 'x', '--launcher', 'mpi',
                                '--local_rank', '1'])
    assert (args.gpu_collect, args.tmpdir, args.fuse_conv_bn, args.show,
            args.show_dir, args.launcher) == (True, 'd', True, True, 'x',
                                              'mpi')
    assert not hasattr(cli, 'NOT_PORTED')
    for argv, message in (
            (['--gpus', '2'], 'torchrun --nproc_per_node 2'),
            (['--gpu-ids', '0', '1'], 'one process drives one card'),
            (['--gpus', '1', '--launcher', 'pytorch'], 'LOCAL_RANK')):
        with pytest.raises(SystemExit):
            train.main([VOTENET, '--device', 'cpu'] + argv)
        assert message in capsys.readouterr().err
    with pytest.raises(SystemExit, match='names a card'):
        train.main([VOTENET, '--device', 'cpu', '--gpu-ids', '0'])
    for main, argv in ((train.main, [VOTENET]),
                       (eval_entry.main, [VOTENET, 'c.pth'])):
        with pytest.raises(RuntimeError, match='--launcher pytorch: missing'):
            main(argv + ['--device', 'cpu', '--launcher', 'pytorch'])
    # --deterministic and --autoscale-lr on one process: lr x 1 card / 8
    try:
        train.main([VOTENET, '--device', 'cpu', '--deterministic',
                    '--autoscale-lr', '--gpus', '1', '--work-dir',
                    str(tmp_path / 'wd'), '--no-validate', '--cfg-options',
                    'runner.max_epochs=1'])
        assert torch.are_deterministic_algorithms_enabled()
    finally:
        torch.use_deterministic_algorithms(False)
    assert 'autoscaled lr to 0.0005' in capsys.readouterr().out
