"""Evaluate a checkpoint with the port (the repository's ``eval.py`` on
PyTorch + CUDA).

    python -m demf_tpu_torch.eval <config> <checkpoint> [--eval mAP]
        [--out results.pkl] [--format-only] [--eval-options k=v ...]

builds ``data.test`` of the config and the detector, loads the checkpoint
(strict; ``CLASSES`` come from its meta when it has one), runs batched
inference over the dataset (``engine.run_dataset_inference``: the last
batch filled and the fill dropped) and prints the indoor mAP of
``dataset.evaluate``.  A config's ``bf16`` / ``fp16`` runs the forward
under the bf16 policy (``utils/precision.py``).  It runs on the GPU by
default and stops when there is none; ``--device cpu`` is for small
configs.

``--fuse-conv-bn`` folds each BatchNorm into the conv or linear before it
(``engine/fuse_bn.py``, the pairs the JAX package folds) after the load;
``--show`` / ``--show-dir DIR`` write each scene's points, GT and
predicted boxes as ``.obj`` files (``engine/visualize.py``; ``--show``
alone into ``show_results``).  With a launcher (``torchrun
--nproc_per_node N -m demf_tpu_torch.eval ... --launcher pytorch``) the
batches are split over the ranks and rank 0 gathers the results in dataset
order (``--gpu-collect``: by a collective; else pickles in ``--tmpdir``)
and writes, shows and evaluates them.
"""
from __future__ import annotations

import pickle

import torch

from . import zoo
from .data import build_dataset
from .engine import load_checkpoint, load_meta, run_dataset_inference
from .engine.cli import parse_args_test, setup_device
from .engine.fuse_bn import fuse_conv_bn
from .engine.visualize import show_dataset_results
from .parallel import rank_and_world
from .utils.config import Config
from .utils.precision import resolve_compute_dtype

META_SHOWN = ('config_file', 'demf_tpu_torch_version', 'torch_version',
              'seed', 'time', 'epoch')


def main(argv=None):
    args = parse_args_test(argv)
    device, grouped = setup_device(args)
    try:
        return _main(args, device)
    finally:
        if grouped:
            torch.distributed.destroy_process_group()


def _main(args, device):
    rank = rank_and_world()[0]
    say = print if rank == 0 else (lambda *a, **k: None)
    cfg = Config.fromfile(args.config)
    if args.cfg_options:
        cfg.merge_from_dict(args.cfg_options)

    dataset = build_dataset(cfg.data['test'])
    # self-describing checkpoints: recover CLASSES recorded at train time
    meta = load_meta(args.checkpoint)
    if meta:
        shown = {k: meta[k] for k in META_SHOWN if k in meta}
        say(f'checkpoint meta: {shown}')
        classes = meta.get('CLASSES')
        if classes and tuple(classes) != tuple(
                getattr(dataset, 'CLASSES', ()) or ()):
            say(f'using CLASSES from checkpoint meta: {classes}')
            inner = getattr(dataset, 'dataset', dataset)
            inner.CLASSES = dataset.CLASSES = tuple(classes)

    model = zoo.build_detector(cfg.model, device, args.seed)
    load_checkpoint(args.checkpoint, model)
    if args.fuse_conv_bn:
        say(f'fused {fuse_conv_bn(model)} conv+BN pairs')
    batch_size = cfg.data['samples_per_gpu']

    def progress(done, total):
        if done % (10 * batch_size) < batch_size:
            print(f'[{done}/{total}]', flush=True)

    results = run_dataset_inference(
        model, dataset, batch_size=batch_size, max_gt=cfg.get('max_gt', 64),
        progress_cb=progress, compute_dtype=resolve_compute_dtype(cfg),
        gpu_collect=args.gpu_collect, tmpdir=args.tmpdir)
    if results is None:        # a rank other than 0: rank 0 goes on
        return None

    if args.out:
        with open(args.out, 'wb') as f:
            pickle.dump(results, f)
        print(f'results written to {args.out}')
    if args.show or args.show_dir:
        out_dir = args.show_dir or 'show_results'
        show_dataset_results(dataset, results, out_dir)
        print(f'visualizations written to {out_dir}')
    if args.format_only:
        prefix = (args.eval_options or {}).get('pklfile_prefix')
        _, out_file = dataset.format_results(results, pklfile_prefix=prefix)
        print(f'formatted results written to {out_file}')
        return None
    metrics = None
    if args.eval:
        metrics = dataset.evaluate(results, metric=args.eval,
                                   **(args.eval_options or {}))
        for k, v in metrics.items():
            print(f'{k}: {v:.4f}')
    return metrics


if __name__ == '__main__':
    main()
