"""Python-file config system with ``_base_`` inheritance.

The port's own copy of ``demf_tpu/utils/config.py`` (standard library
only), so that the port imports nothing of the JAX package.  It gives the
declarative surface of mmcv's ``Config``: configs are plain python
files defining module-level variables, may inherit from a list of ``_base_``
files (recursive dict merge, later keys win), support ``_delete_=True`` to
replace instead of merge, dot-path CLI overrides, and reproducible dumps.
"""
from __future__ import annotations

import copy
import os
import types


class ConfigDict(dict):
    """dict with attribute access, recursively applied."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name, value):
        self[name] = value

    def __delattr__(self, name):
        try:
            del self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __deepcopy__(self, memo):
        out = ConfigDict()
        memo[id(self)] = out
        for k, v in self.items():
            out[copy.deepcopy(k, memo)] = copy.deepcopy(v, memo)
        return out


def _to_configdict(obj):
    if isinstance(obj, dict):
        return ConfigDict({k: _to_configdict(v) for k, v in obj.items()})
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_configdict(v) for v in obj)
    return obj


DELETE_KEY = '_delete_'
BASE_KEY = '_base_'
RESERVED_KEYS = ('filename', 'text')


def _merge_a_into_b(a, b):
    """Recursively merge dict ``a`` into dict ``b`` (a wins)."""
    b = copy.deepcopy(b)
    for k, v in a.items():
        if isinstance(v, dict) and k in b and not v.pop(DELETE_KEY, False):
            if not isinstance(b[k], dict):
                raise TypeError(
                    f'Cannot merge dict into non-dict for key `{k}`: '
                    f'{type(b[k])}. Add `_delete_: True` to override.')
            b[k] = _merge_a_into_b(v, b[k])
        else:
            if isinstance(v, dict):
                v = {kk: vv for kk, vv in v.items() if kk != DELETE_KEY}
            b[k] = copy.deepcopy(v)
    return b


def _exec_pyfile(filename):
    filename = os.path.abspath(os.path.expanduser(filename))
    with open(filename) as f:
        code = f.read()
    mod = types.ModuleType('_cfg_')
    mod.__file__ = filename
    exec(compile(code, filename, 'exec'), mod.__dict__)
    cfg = {
        k: v for k, v in mod.__dict__.items()
        if not k.startswith('__') and not isinstance(v, types.ModuleType)
        and not isinstance(v, (type, types.FunctionType))
    }
    return cfg


def _load_cfg_dict(filename):
    cfg = _exec_pyfile(filename)
    base = cfg.pop(BASE_KEY, None)
    if base is None:
        return cfg
    if isinstance(base, str):
        base = [base]
    merged = {}
    cfg_dir = os.path.dirname(os.path.abspath(os.path.expanduser(filename)))
    for b in base:
        bcfg = _load_cfg_dict(os.path.join(cfg_dir, b))
        dup = set(merged) & set(bcfg)
        merged = _merge_a_into_b(bcfg, merged) if dup else {**merged, **bcfg}
    return _merge_a_into_b(cfg, merged)


def _format_value(v, indent=0):
    pad = ' ' * indent
    if isinstance(v, dict):
        items = ',\n'.join(
            f"{pad}    {k!r}: {_format_value(val, indent + 4).lstrip()}"
            for k, val in v.items())
        return f'{pad}dict(**{{\n{items}}})' if False else \
            f"{pad}{{\n{items}\n{pad}}}"
    if isinstance(v, (list, tuple)):
        inner = ', '.join(_format_value(x, 0) for x in v)
        return f'{pad}[{inner}]' if isinstance(v, list) else f'{pad}({inner}{"," if len(v) == 1 else ""})'
    return f'{pad}{v!r}'


class Config:
    """A facade over a nested ConfigDict, mmcv-compatible surface."""

    def __init__(self, cfg_dict=None, filename=None, text=''):
        object.__setattr__(self, '_cfg_dict', _to_configdict(cfg_dict or {}))
        object.__setattr__(self, '_filename', filename)
        object.__setattr__(self, '_text', text)

    @staticmethod
    def fromfile(filename):
        cfg_dict = _load_cfg_dict(filename)
        with open(filename) as f:
            text = f.read()
        return Config(cfg_dict, filename=filename, text=text)

    @property
    def filename(self):
        return self._filename

    @property
    def text(self):
        return self._text

    @property
    def pretty_text(self):
        lines = []
        for k, v in self._cfg_dict.items():
            lines.append(f'{k} = {_format_value(v)}')
        return '\n'.join(lines)

    def merge_from_dict(self, options):
        """Merge dot-path keyed options, e.g. {'model.backbone.depth': 50}."""
        option_cfg = {}
        for full_key, v in options.items():
            d = option_cfg
            keys = full_key.split('.')
            for sub in keys[:-1]:
                d = d.setdefault(sub, {})
            d[keys[-1]] = v
        merged = _merge_a_into_b(option_cfg, dict(self._cfg_dict))
        object.__setattr__(self, '_cfg_dict', _to_configdict(merged))

    def dump(self, file=None):
        s = self.pretty_text
        if file is None:
            return s
        with open(file, 'w') as f:
            f.write(s)

    def copy(self):
        return Config(copy.deepcopy(dict(self._cfg_dict)),
                      filename=self._filename, text=self._text)

    # -- mapping / attribute protocol --------------------------------------
    def __getattr__(self, name):
        return getattr(self._cfg_dict, name)

    def __setattr__(self, name, value):
        self._cfg_dict[name] = _to_configdict(value)

    def __getitem__(self, name):
        return self._cfg_dict[name]

    def __setitem__(self, name, value):
        self._cfg_dict[name] = _to_configdict(value)

    def __contains__(self, name):
        return name in self._cfg_dict

    def __iter__(self):
        return iter(self._cfg_dict)

    def get(self, name, default=None):
        return self._cfg_dict.get(name, default)

    def keys(self):
        return self._cfg_dict.keys()

    def items(self):
        return self._cfg_dict.items()

    def __repr__(self):
        return f'Config (path: {self._filename})\n{self.pretty_text}'


class DictAction:
    """argparse action-compatible parser for KEY=VALUE dot-path overrides."""

    @staticmethod
    def parse_value(val):
        import ast
        try:
            return ast.literal_eval(val)
        except (ValueError, SyntaxError):
            pass
        lowered = val.lower()
        if lowered in ('true', 'false'):
            return lowered == 'true'
        if lowered in ('none', 'null'):
            return None
        if ',' in val:
            return [DictAction.parse_value(v) for v in val.split(',')]
        return val

    def __init__(self, option_strings, dest, nargs=None, **kwargs):
        self.option_strings = option_strings
        self.dest = dest
        self.nargs = '+'
        self.const = None
        self.default = kwargs.get('default')
        self.type = None
        self.choices = None
        self.required = kwargs.get('required', False)
        self.help = kwargs.get('help')
        self.metavar = kwargs.get('metavar')

    def __call__(self, parser, namespace, values, option_string=None):
        options = getattr(namespace, self.dest, None) or {}
        for kv in values:
            key, val = kv.split('=', maxsplit=1)
            options[key] = self.parse_value(val)
        setattr(namespace, self.dest, options)

    def format_usage(self):
        return self.option_strings[0]
