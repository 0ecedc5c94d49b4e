"""Convert a JAX package checkpoint into one the PyTorch port loads.

    python convert_jax_checkpoint.py <config> <orbax ckpt dir> <out.pth>

reads the parameters and BatchNorm statistics of an orbax checkpoint that
``demf_tpu`` wrote (``epoch_<n>`` under a work dir's ``checkpoints/``,
with its ``.meta.json`` beside it when there is one), renames them to the
port's mmdet3d keys (``demf_tpu.engine.torch_port.flatten_params``, then
``demf_tpu_torch.engine.weights.state_dict_from_jax``) and writes a
``.pth`` of ``state_dict``, ``epoch`` and ``meta`` (``CLASSES``, the
config's text, ``converted_from``) in plain types, which
``python -m demf_tpu_torch.eval <config> <out.pth>`` loads strictly and a
config's ``load_from`` warm-starts from.  It covers the detectors
``state_dict_from_jax`` covers: DeMF-VoteNet, the stage-1 DETR, VoteNet,
ImVoteNet (its fusion and its image-only Faster R-CNN), FCAF3D and
DeMF-FCAF3D (their sparse kernels in MinkowskiEngine's tap order, as
mmdet3d stores them).  The optimizer state (optax's) is not AdamW's, so
the file resumes no training.

It imports both packages, so it lives outside ``demf_tpu_torch`` and runs
where JAX and orbax are installed.
"""
from __future__ import annotations

import argparse
import os

def convert(config, ckpt_dir, out):
    """Write ``out`` from the orbax checkpoint ``ckpt_dir`` of a model of
    ``config``; returns the payload written."""
    import torch

    from demf_tpu.engine.checkpoint import load_meta, load_params
    from demf_tpu.engine.torch_port import flatten_params
    from demf_tpu_torch.engine.checkpoint import check_plain
    from demf_tpu_torch.engine.weights import state_dict_from_jax
    from demf_tpu_torch.utils.config import Config

    cfg = Config.fromfile(config)
    params, stats = load_params(ckpt_dir, with_batch_stats=True)
    state_dict = state_dict_from_jax(flatten_params(params),
                                     flatten_params(stats or {}))
    jax_meta = load_meta(ckpt_dir) or {}
    epoch = int(jax_meta.get('epoch', 0))
    classes = jax_meta.get('CLASSES') or cfg.get('class_names') or []
    meta = dict(CLASSES=[str(c) for c in classes], config=cfg.dump(),
                config_file=os.path.basename(config),
                converted_from=os.path.abspath(ckpt_dir), epoch=epoch)
    check_plain(meta)
    payload = dict(state_dict=state_dict, epoch=epoch, meta=meta)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    torch.save(payload, out)
    return payload


def main(argv=None):
    parser = argparse.ArgumentParser(
        description='Convert a demf_tpu (JAX) checkpoint to the PyTorch '
                    'port\'s .pth')
    parser.add_argument('config', help='the model\'s config file')
    parser.add_argument('checkpoint', help='orbax checkpoint directory')
    parser.add_argument('out', help='the .pth to write')
    args = parser.parse_args(argv)
    payload = convert(args.config, args.checkpoint, args.out)
    print(f'{args.out}: {len(payload["state_dict"])} tensors, epoch '
          f'{payload["epoch"]}, {len(payload["meta"]["CLASSES"])} classes')


if __name__ == '__main__':
    main()
