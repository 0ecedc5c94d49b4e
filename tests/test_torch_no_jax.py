"""The port runs where there is no JAX: importing ``demf_tpu_torch``, every
submodule (the data layer, the mAP and the two entry points among them)
and ``chip_smoke`` must not touch jax, flax, optax, orbax or the JAX package
``demf_tpu`` (not even its framework-free modules: the port keeps its own
copies), and must not build the CUDA kernels (they are built at first
launch, so no nvcc is needed to import)."""
import glob
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r'''
import importlib, pkgutil, sys
sys.modules['jax'] = None          # any "import jax" now raises ImportError
sys.modules['flax'] = None
sys.modules['optax'] = None
sys.modules['orbax'] = None
sys.modules['demf_tpu'] = None     # the JAX package, whatever the module
import demf_tpu_torch
names = [m.name for m in pkgutil.walk_packages(demf_tpu_torch.__path__,
                                               'demf_tpu_torch.')]
for name in names:
    importlib.import_module(name)
import chip_smoke  # noqa: F401
from demf_tpu_torch.ops import _cuda
assert _cuda._lib is None, 'the kernel library was loaded at import'
loaded = sorted(m for m in sys.modules
                if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax',
                                       'orbax', 'demf_tpu')
                and sys.modules[m] is not None)
assert not loaded, loaded
print(' '.join(names))
'''

DATASET_PATH_MODULES = ('data', 'data.pipeline', 'data.sunrgbd',
                        'data.loader', 'core.eval3d', 'engine.cli', 'train',
                        'eval', 'tools.nms_cases')
PRETRAIN_PATH_MODULES = ('ops.assignment', 'models.detr_head',
                         'models.imvotenet', 'tools.k4_phases',
                         'tools.compare_kernels')
IMVOTENET_PATH_MODULES = ('ops.nms2d', 'ops.roi_align', 'models.rpn_roi',
                          'models.vote_fusion', 'models.image_neck')


def test_port_imports_without_jax_or_nvcc():
    env = dict(os.environ, CUDA_HOME=os.path.join(ROOT, 'no-such-cuda'),
               PATH=os.path.dirname(sys.executable), PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, '-c', _PROBE], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    names = proc.stdout.strip().splitlines()[-1].split()
    assert len(names) >= 50
    for name in (DATASET_PATH_MODULES + PRETRAIN_PATH_MODULES +
                 IMVOTENET_PATH_MODULES):
        assert f'demf_tpu_torch.{name}' in names


def test_port_sources_name_no_import_of_the_jax_package():
    """No ``import demf_tpu`` / ``from demf_tpu[.x] import``, and no import
    of jax, flax, optax or orbax, in the port's sources, its configs or
    ``chip_smoke.py`` (a lazy import inside a function would get past the
    probe above)."""
    pattern = re.compile(
        r'^\s*(from|import)\s+(demf_tpu|jax|flax|optax|orbax)($|[.\s])', re.M)
    files = glob.glob(os.path.join(ROOT, 'demf_tpu_torch', '**', '*.py'),
                      recursive=True) + [os.path.join(ROOT, 'chip_smoke.py')]
    assert len(files) >= 55
    hits = []
    for path in files:
        with open(path) as f:
            if pattern.search(f.read()):
                hits.append(os.path.relpath(path, ROOT))
    assert not hits, hits


_CONFIG_PROBE = r'''
import glob, sys
for name in ('jax', 'flax', 'optax', 'orbax', 'demf_tpu'):
    sys.modules[name] = None
from demf_tpu_torch.utils.config import Config
from demf_tpu_torch.registry import DETECTORS, build_from_cfg
import demf_tpu_torch.models
files = sorted(glob.glob('demf_tpu_torch/configs/*.py'))
for path in files:
    cfg = Config.fromfile(path)
    assert cfg.model['type'] in DETECTORS, path
print(' '.join(files))
'''


def test_port_configs_load_without_jax():
    """Every config of the port (the pretrain ones among them) reads, with
    its ``_base_`` files under ``configs/``, where there is no JAX."""
    env = dict(os.environ, PATH=os.path.dirname(sys.executable),
               PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, '-c', _CONFIG_PROBE], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    names = proc.stdout.strip().splitlines()[-1].split()
    for name in ('detr_pretrain_tiny', 'detr_pretrain_synthetic',
                 'demf_tiny', 'demf_votenet_synthetic', 'imvotenet_tiny',
                 'imvotenet_synthetic'):
        assert f'demf_tpu_torch/configs/{name}.py' in names
