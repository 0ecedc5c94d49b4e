"""The port runs where there is no JAX: importing ``demf_tpu_torch``, every
submodule and ``chip_smoke`` must not touch jax or flax, and must not build
the CUDA kernels (they are built at first launch, so no nvcc is needed to
import)."""
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r'''
import importlib, pkgutil, sys
sys.modules['jax'] = None          # any "import jax" now raises ImportError
sys.modules['flax'] = None
import demf_tpu_torch
names = [m.name for m in pkgutil.walk_packages(demf_tpu_torch.__path__,
                                               'demf_tpu_torch.')]
for name in names:
    importlib.import_module(name)
import chip_smoke  # noqa: F401
from demf_tpu_torch.ops import _cuda
assert _cuda._lib is None, 'the kernel library was loaded at import'
loaded = sorted(m for m in sys.modules
                if m.split('.')[0] in ('jax', 'jaxlib', 'flax')
                and sys.modules[m] is not None)
assert not loaded, loaded
print(len(names))
'''


def test_port_imports_without_jax_or_nvcc():
    env = dict(os.environ, CUDA_HOME=os.path.join(ROOT, 'no-such-cuda'),
               PATH=os.path.dirname(sys.executable), PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, '-c', _PROBE], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert int(proc.stdout.strip().splitlines()[-1]) >= 20
