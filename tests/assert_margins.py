"""How close each comparison of some test files comes to its bound.

    JAX_PLATFORMS=cpu python tests/assert_margins.py tests/test_torch_votenet.py [...] [-- pytest args]

Runs pytest on the named files with this module as a plugin: it imports
them with every ``assert a < b`` and ``assert a <= b`` rewritten to record
``a / b`` before it asserts (pytest's own assertion rewriting off), and
then prints, for each file, its asserts by line with the largest ratio
seen: 1.0 is the bound, 0.5 half of it.  Not a test: pytest collects only
``test_*.py``.
"""
import ast
import importlib.abc
import importlib.machinery
import importlib.util
import json
import os
import subprocess
import sys
from collections import defaultdict

HERE = os.path.dirname(os.path.abspath(__file__))


def _margin(a, b, where):
    try:
        ratio = float(a) / float(b)
    except (TypeError, ValueError, ZeroDivisionError):
        return
    with open(os.environ['ASSERT_MARGINS_LOG'], 'a') as f:
        f.write(json.dumps([where, ratio]) + '\n')


class _Record(ast.NodeTransformer):
    """``assert a < b, msg`` -> ``__ma = a; __mb = b; __margin__(__ma,
    __mb, 'file:line'); assert __ma < __mb, msg`` (each side evaluated
    once)."""

    def __init__(self, name):
        self.name = name

    def visit_Assert(self, node):
        test = node.test
        if not (isinstance(test, ast.Compare) and len(test.ops) == 1 and
                isinstance(test.ops[0], (ast.Lt, ast.LtE))):
            return node
        store = [ast.Name('__ma', ast.Store()), ast.Name('__mb', ast.Store())]
        load = [ast.Name('__ma', ast.Load()), ast.Name('__mb', ast.Load())]
        node.test = ast.Compare(load[0], test.ops, [load[1]])
        return [ast.Assign([store[0]], test.left),
                ast.Assign([store[1]], test.comparators[0]),
                ast.Expr(ast.Call(ast.Name('__margin__', ast.Load()), load + [
                    ast.Constant(f'{self.name}:{node.lineno}')], [])),
                node]


class _Loader(importlib.abc.SourceLoader):
    def __init__(self, path):
        self.path = path

    def get_filename(self, name):
        return self.path

    def get_data(self, path):
        with open(path, 'rb') as f:
            return f.read()

    def source_to_code(self, data, path, *, _optimize=-1):
        tree = _Record(os.path.basename(path)).visit(ast.parse(data))
        return compile(ast.fix_missing_locations(tree), path, 'exec')

    def exec_module(self, module):
        module.__margin__ = _margin
        super().exec_module(module)


class _Finder(importlib.abc.MetaPathFinder):
    """Imports the files of ``ASSERT_MARGINS_FILES`` through ``_Loader``."""

    def __init__(self, paths):
        self.paths = paths

    def find_spec(self, name, path=None, target=None):
        spec = importlib.machinery.PathFinder.find_spec(name, path)
        if spec is None or spec.origin is None or \
                os.path.abspath(spec.origin) not in self.paths:
            return None
        return importlib.util.spec_from_file_location(
            name, spec.origin, loader=_Loader(spec.origin))


def pytest_configure(config):
    paths = {os.path.abspath(p) for p in
             os.environ['ASSERT_MARGINS_FILES'].split(os.pathsep)}
    sys.meta_path.insert(0, _Finder(paths))


def main(argv):
    split = argv.index('--') if '--' in argv else len(argv)
    files, extra = argv[:split], argv[split + 1:]
    log = os.path.abspath(os.path.join(
        os.path.dirname(HERE), 'build', 'assert_margins.jsonl'))
    os.makedirs(os.path.dirname(log), exist_ok=True)
    if os.path.exists(log):
        os.remove(log)
    env = dict(os.environ, ASSERT_MARGINS_LOG=log,
               ASSERT_MARGINS_FILES=os.pathsep.join(
                   os.path.abspath(f) for f in files),
               PYTHONPATH=os.pathsep.join(
                   [HERE, os.path.dirname(HERE),
                    os.environ.get('PYTHONPATH', '')]))
    rc = subprocess.call([sys.executable, '-m', 'pytest', '-q',
                          '-p', 'no:cacheprovider', '-p', 'assert_margins',
                          '--assert=plain', *extra, *files], env=env)
    worst = defaultdict(float)
    if os.path.exists(log):
        with open(log) as f:
            for line in f:
                where, ratio = json.loads(line)
                if ratio == ratio:               # NaN: nothing to report
                    worst[where] = max(worst[where], ratio)
    by_file = defaultdict(list)
    for where, ratio in worst.items():
        name, line = where.rsplit(':', 1)
        by_file[name].append((int(line), ratio))
    for name in sorted(by_file):
        print(name)
        for line, ratio in sorted(by_file[name]):
            print(f'  :{line} {ratio:.3g}')
    return rc


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
