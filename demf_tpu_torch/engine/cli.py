"""Argument parsers of the port's two entry points (port of
``demf_tpu/engine/cli.py``): the flags of the repository's ``train.py`` and
``eval.py``, plus ``--device``.  Options whose code is not ported yet are
refused by name; none is accepted and ignored.  A config's ``bf16`` /
``fp16`` selects the bf16 policy (``utils/precision.py``).
"""
from __future__ import annotations

import argparse

from ..utils.config import DictAction

NOT_PORTED = 'not ported yet (ROADMAP M4)'


def _parse(parser, argv, refused=()):
    """Parse, then stop at the first option whose code is not ported."""
    args = parser.parse_args(argv)
    for name in refused:
        if getattr(args, name):
            parser.error(f'--{name.replace("_", "-")} is {NOT_PORTED}')
    if args.launcher != 'none':
        parser.error(f'--launcher {args.launcher} is {NOT_PORTED}')
    return args


def _add_common(parser):
    parser.add_argument('--seed', type=int, default=0, help='random seed')
    parser.add_argument('--cfg-options', nargs='+', action=DictAction,
                        help='override config entries: key.path=value')
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (the default; the entry points stop "
                             "without a card) or 'cpu' for a small run")
    parser.add_argument('--launcher', default='none',
                        help=f"only 'none': launchers are {NOT_PORTED}")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description='Train a 3D detector (PyTorch + CUDA)')
    parser.add_argument('config', help='train config file path')
    parser.add_argument('--work-dir', help='dir to save logs and ckpts')
    parser.add_argument('--resume-from', help='checkpoint to resume from')
    parser.add_argument('--no-validate', action='store_true',
                        help='skip validation during training')
    parser.add_argument('--autoscale-lr', action='store_true',
                        help='linear LR scaling by device count / 8')
    _add_common(parser)
    group = parser.add_argument_group(
        'synthetic mode', 'train on one synthetic batch instead of the '
        "config's dataset (what the step-time measurements use)")
    group.add_argument('--synthetic', action='store_true')
    group.add_argument('--steps', type=int, default=3)
    group.add_argument('--batch', type=int, default=None,
                       help="default: the model's (zoo.synth_batch_for)")
    group.add_argument('--points', type=int, default=20000)
    group.add_argument('--hw', type=int, nargs=2, default=(800, 1344))
    group.add_argument('--gt', type=int, default=None,
                       help="GT box slots (default: the model's)")
    group.add_argument('--profile', action='store_true',
                       help='trace one more step and print where it spends')
    return _parse(parser, argv)


def parse_args_test(argv=None):
    parser = argparse.ArgumentParser(
        description='Evaluate a 3D detector (PyTorch + CUDA)')
    parser.add_argument('config', help='test config file path')
    parser.add_argument('checkpoint', help='checkpoint file')
    parser.add_argument('--out', help='output result file (pickle)')
    parser.add_argument('--format-only', action='store_true')
    parser.add_argument('--eval', type=str, nargs='+', default=['mAP'],
                        help='evaluation metrics')
    parser.add_argument('--eval-options', nargs='+', action=DictAction)
    parser.add_argument('--fuse-conv-bn', action='store_true',
                        help=NOT_PORTED)
    parser.add_argument('--show', action='store_true', help=NOT_PORTED)
    parser.add_argument('--show-dir', help=NOT_PORTED)
    _add_common(parser)
    return _parse(parser, argv, ('fuse_conv_bn', 'show', 'show_dir'))


def require_device(name):
    """``--device`` as a ``torch.device``; stops when it names the card and
    there is none."""
    import torch
    device = torch.device(name)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise SystemExit('no CUDA device: this entry point runs on the GPU '
                         '(pass --device cpu for a small run on the CPU)')
    return device
