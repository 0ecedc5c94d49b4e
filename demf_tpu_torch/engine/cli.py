"""Argument parsers of the port's two entry points (port of
``demf_tpu/engine/cli.py``): every flag of the repository's ``train.py`` and
``eval.py``, plus ``--device``.  A config's ``bf16`` / ``fp16`` selects the
bf16 policy (``utils/precision.py``).

A launcher (``--launcher pytorch|slurm|mpi|jax``) runs one process a card:
``parallel.dist.init_distributed`` reads the launcher's env and joins the
process group (NCCL on the card, gloo with ``--device cpu``); the global
batch (``samples_per_gpu``) is split over the ranks.  Without a launcher
one process drives one card: ``--gpu-ids N`` picks ``cuda:N``, and
``--gpus`` above 1 is refused with the launch command that runs that many.
"""
from __future__ import annotations

import argparse
import os

from ..parallel import LAUNCHERS
from ..utils.config import DictAction

DETERMINISTIC_HELP = (
    'torch.use_deterministic_algorithms(True) and cudnn benchmark off '
    '(cuBLAS gets CUBLAS_WORKSPACE_CONFIG=:4096:8). It does not reach the '
    "port's own CUDA kernels: those whose output is the same bits every "
    'call stay so, and K4 (MSDA backward) on a float32 value at the '
    "encoder's shapes keeps its float atomics, whose sum order varies; a "
    'PyTorch op with no deterministic form raises')


def _add_common(parser):
    parser.add_argument('--seed', type=int, default=0, help='random seed')
    parser.add_argument('--cfg-options', nargs='+', action=DictAction,
                        help='override config entries: key.path=value')
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (the default; the entry points stop "
                             "without a card) or 'cpu' for a small run")
    parser.add_argument('--launcher', choices=('none',) + LAUNCHERS,
                        default='none',
                        help='job launcher: one process a card, the global '
                             'batch split over the ranks')
    parser.add_argument('--local_rank', '--local-rank', type=int,
                        default=None,
                        help="this process's card on its node, as "
                             'torch.distributed.launch passes it (the '
                             "launcher's LOCAL_RANK env var wins)")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description='Train a 3D detector (PyTorch + CUDA)')
    parser.add_argument('config', help='train config file path')
    parser.add_argument('--work-dir', help='dir to save logs and ckpts')
    parser.add_argument('--resume-from', help='checkpoint to resume from')
    parser.add_argument('--no-validate', action='store_true',
                        help='skip validation during training')
    group = parser.add_mutually_exclusive_group()
    group.add_argument('--gpus', type=int,
                       help='cards to use without a launcher: 1 (above 1 '
                            'is refused: launch one process a card)')
    group.add_argument('--gpu-ids', type=int, nargs='+',
                       help='the card to use without a launcher (one id)')
    parser.add_argument('--deterministic', action='store_true',
                        help=DETERMINISTIC_HELP)
    parser.add_argument('--autoscale-lr', action='store_true',
                        help='linear LR scaling by the cards of all ranks '
                             '/ 8')
    _add_common(parser)
    group = parser.add_argument_group(
        'synthetic mode', 'train on one synthetic batch instead of the '
        "config's dataset (what the step-time measurements use)")
    group.add_argument('--synthetic', action='store_true')
    group.add_argument('--steps', type=int, default=3)
    group.add_argument('--batch', type=int, default=None,
                       help="the global batch (default: the model's, "
                            'zoo.synth_batch_for)')
    group.add_argument('--points', type=int, default=20000)
    group.add_argument('--hw', type=int, nargs=2, default=None,
                       help="image size (default: the model's)")
    group.add_argument('--gt', type=int, default=None,
                       help="GT box slots (default: the model's)")
    group.add_argument('--profile', action='store_true',
                       help='trace one more step and print where it spends')
    args = parser.parse_args(argv)
    if args.launcher != 'none' and (args.gpus or args.gpu_ids):
        parser.error('--gpus / --gpu-ids pick cards without a launcher; '
                     "under --launcher each rank takes its launcher's "
                     'LOCAL_RANK')
    if args.gpus is not None and args.gpus > 1:
        parser.error(
            f'--gpus {args.gpus}: one process drives one card; launch one '
            f'process a card, e.g. torchrun --nproc_per_node {args.gpus} '
            f'-m demf_tpu_torch.train <config> --launcher pytorch')
    if args.gpu_ids is not None and len(args.gpu_ids) > 1:
        parser.error(
            f'--gpu-ids {args.gpu_ids}: one process drives one card; '
            f'launch one process a card (torchrun --nproc_per_node '
            f'{len(args.gpu_ids)} ... --launcher pytorch, with '
            f'CUDA_VISIBLE_DEVICES naming the cards)')
    return args


def parse_args_test(argv=None):
    parser = argparse.ArgumentParser(
        description='Evaluate a 3D detector (PyTorch + CUDA)')
    parser.add_argument('config', help='test config file path')
    parser.add_argument('checkpoint', help='checkpoint file')
    parser.add_argument('--out', help='output result file (pickle)')
    parser.add_argument('--fuse-conv-bn', action='store_true',
                        help='fold each BatchNorm into the conv or linear '
                             'before it (engine/fuse_bn.py)')
    parser.add_argument('--format-only', action='store_true')
    parser.add_argument('--eval', type=str, nargs='+', default=['mAP'],
                        help='evaluation metrics')
    parser.add_argument('--show', action='store_true',
                        help='write .obj dumps of each scene to '
                             'show_results (no window: headless hosts)')
    parser.add_argument('--show-dir', help='dir to save the .obj dumps')
    parser.add_argument('--gpu-collect', action='store_true',
                        help="gather the ranks' results by a collective")
    parser.add_argument('--tmpdir',
                        help="gather the ranks' results through pickles in "
                             'this dir (default: a fresh dir under '
                             '.dist_test)')
    parser.add_argument('--eval-options', nargs='+', action=DictAction)
    _add_common(parser)
    return parser.parse_args(argv)


def require_device(name, gpu_ids=None):
    """``--device`` as a ``torch.device`` (``--gpu-ids N`` picks
    ``cuda:N``); stops when it names the card and there is none."""
    import torch
    device = torch.device(name)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise SystemExit('no CUDA device: this entry point runs on the GPU '
                         '(pass --device cpu for a small run on the CPU)')
    if gpu_ids:
        if device.type != 'cuda':
            raise SystemExit(f'--gpu-ids {gpu_ids} names a card, but '
                             f'--device is {name}')
        device = torch.device('cuda', gpu_ids[0])
    return device


def setup_device(args):
    """The entry's device: under a launcher, join its process group
    (``parallel.init_distributed``) and take this rank's card; else
    ``require_device``.  Returns (device, whether a group was joined)."""
    if args.launcher == 'none':
        return require_device(args.device, getattr(args, 'gpu_ids', None)), \
            False
    from ..parallel import init_distributed
    return init_distributed(args.launcher, args.device,
                            local_rank=args.local_rank), True


def set_deterministic():
    """``--deterministic``: see ``DETERMINISTIC_HELP``."""
    import torch
    os.environ.setdefault('CUBLAS_WORKSPACE_CONFIG', ':4096:8')
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
