"""Factory-config system: port of ``tssep_tpu/config/configurable.py``.

Nested ``{'factory': 'dotted.path', **kwargs}`` configurations, with the JAX
package's semantics:

- ``get_config(factory, updates)`` produces the complete configuration of a
  class by layering (1) the caller's values (highest priority, never
  overwritten), (2) values written by the class's
  ``finalize_dogmatic_config`` (first write wins), (3) the signature's
  defaults, then recursing into nested factory configurations;
- ``from_config(config, **options)`` instantiates recursively;
- YAML load and dump, factories written as dotted import paths.

Factories resolve in the port. A path under ``tssep_tpu.`` (a
``config.yaml`` dumped by the JAX CLI) is read as the same path under
``tssep_tpu_torch.``: the string is rewritten, the JAX package is never
imported. The reference's ``tssep.train.*`` paths resolve through
``compat/aliases.py``; a bare class name resolves among the port's modules
that hold factories. A class object resolves to itself.

Port-only arguments (``PORT_ONLY``: the device, the storage and head types
and the kernel switches) are keyword-only in the port's constructors.
``get_config`` never writes them, so they never reach a ``config.yaml``;
``from_config(config, **options)`` passes each option to every factory
whose signature takes it.
"""

from __future__ import annotations

import dataclasses
import importlib
import inspect
from pathlib import Path

import yaml

__all__ = [
    'Configurable',
    'PORT_ONLY',
    'import_class',
    'class_to_str',
    'get_config',
    'from_config',
    'load_yaml',
    'dump_yaml',
    'dumps_yaml',
    'NestedView',
    'DogmaticView',
    'nested_merge',
    'nested_get',
    'nested_set',
    'register_alias',
]

#: Keyword-only arguments of the port's constructors that choose where and
#: how a model runs; never part of a configuration.
PORT_ONLY = frozenset({'device', 'storage_dtype', 'head_dtype', 'cond_fuse',
                       'fullfuse', 'spill', 'bidi'})

_JAX_PACKAGE = 'tssep_tpu.'
_PORT_PACKAGE = 'tssep_tpu_torch.'

#: Modules of the JAX package the port has not ported yet, and where they
#: stand in ROADMAP.md (none: tensor parallelism, item 4b, is an option of
#: ``dist.mesh`` and raises there).
NOT_PORTED: dict[str, str] = {}

#: The port's modules that hold factories, searched for a bare class name.
_FACTORY_MODULES = (
    'tssep_tpu_torch.features.extractor', 'tssep_tpu_torch.features.kaldi',
    'tssep_tpu_torch.nn.estimator',
    'tssep_tpu_torch.nn.norm', 'tssep_tpu_torch.tasks.enhancer',
    'tssep_tpu_torch.tasks.losses', 'tssep_tpu_torch.tasks.model',
    'tssep_tpu_torch.data.dummy', 'tssep_tpu_torch.train.optimizer',
    'tssep_tpu_torch.train.trainer', 'tssep_tpu_torch.train.experiment',
    'tssep_tpu_torch.train.init_ckpt', 'tssep_tpu_torch.eval.classic_bf',
    'tssep_tpu_torch.eval.wpe')


# ---------------------------------------------------------------------------
# Import helpers
# ---------------------------------------------------------------------------

#: Alias table so configs written for other frameworks (the torch
#: reference's ``tssep.train.*`` paths) resolve to the port's classes;
#: filled by ``compat/aliases.py``.
FACTORY_ALIASES: dict[str, str] = {}


def register_alias(alias: str, target: str):
    FACTORY_ALIASES[alias] = target


def port_path(path: str) -> str:
    """``path`` with a leading ``tssep_tpu.`` read as ``tssep_tpu_torch.``."""
    if path.startswith(_JAX_PACKAGE):
        return _PORT_PACKAGE + path[len(_JAX_PACKAGE):]
    return path


def import_class(path):
    """The class or function a factory names: a class object itself, a
    dotted path (``tssep_tpu.`` read as ``tssep_tpu_torch.``), a registered
    alias or a bare class name of the port. A path into a module that is
    not ported yet raises ``NotImplementedError`` naming its queue item."""
    if not isinstance(path, str):
        return path
    if path not in FACTORY_ALIASES and path.startswith(('tssep.',
                                                        'padertorch.')):
        importlib.import_module('tssep_tpu_torch.compat.aliases')
    path = port_path(FACTORY_ALIASES.get(path, path))
    module_name, _, cls_name = path.rpartition('.')
    if not module_name:
        for name in _FACTORY_MODULES:
            found = getattr(importlib.import_module(name), cls_name, None)
            if inspect.isclass(found):
                return found
        raise ImportError(f'Cannot import {path!r}: no module part and no '
                          f'factory of that name in the port')
    for prefix, where in NOT_PORTED.items():
        if path.startswith(prefix):
            raise NotImplementedError(f'{path} is not ported yet ({where})')
    module = importlib.import_module(module_name)
    try:
        return getattr(module, cls_name)
    except AttributeError:
        raise ImportError(
            f'Module {module_name!r} has no attribute {cls_name!r}') from None


def class_to_str(cls):
    if isinstance(cls, str):
        return cls
    return f'{cls.__module__}.{cls.__qualname__}'


def same_factory(a, b) -> bool:
    """Whether two factories name the same class: compared as resolved
    classes where both import, else as paths (``tssep_tpu.`` read as
    ``tssep_tpu_torch.``)."""
    try:
        return import_class(a) is import_class(b)
    except (ImportError, NotImplementedError):
        return (port_path(class_to_str(a))
                == port_path(class_to_str(b)))


def is_factory_config(obj):
    return isinstance(obj, dict) and 'factory' in obj


# ---------------------------------------------------------------------------
# Nested dict helpers
# ---------------------------------------------------------------------------

def nested_merge(base: dict, update: dict) -> dict:
    """Return a new dict: ``update`` layered over ``base`` (update wins).

    If both provide a dict for a key, merge recursively, unless the update
    changes the factory: then the update's sub-dict replaces the base's
    entirely (kwargs of a different factory don't mix).
    """
    out = dict(base)
    for k, v in update.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            if ('factory' in v and 'factory' in out[k]
                    and not same_factory(v['factory'], out[k]['factory'])):
                out[k] = _copy_nested(v)
            else:
                out[k] = nested_merge(out[k], v)
        else:
            out[k] = _copy_nested(v)
    return out


def _copy_nested(v):
    if isinstance(v, dict):
        return {k: _copy_nested(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_copy_nested(x) for x in v]
    return v


def nested_get(d, dotted_key, default=KeyError):
    keys = dotted_key.split('.') if isinstance(dotted_key, str) else dotted_key
    for k in keys:
        try:
            d = d[k]
        except (KeyError, TypeError):
            if default is KeyError:
                raise KeyError(dotted_key) from None
            return default
    return d


def nested_set(d, dotted_key, value):
    keys = dotted_key.split('.') if isinstance(dotted_key, str) else dotted_key
    for k in keys[:-1]:
        d = d.setdefault(k, {})
    d[keys[-1]] = value


class NestedView:
    """Flat dotted-key view over a nested dict (read/write)."""

    def __init__(self, data):
        self.data = data

    def __getitem__(self, key):
        return nested_get(self.data, key)

    def __setitem__(self, key, value):
        nested_set(self.data, key, value)

    def __contains__(self, key):
        try:
            nested_get(self.data, key)
            return True
        except KeyError:
            return False


# ---------------------------------------------------------------------------
# Dogmatic layered dict
# ---------------------------------------------------------------------------

class DogmaticView:
    """Layered mapping view used inside ``finalize_dogmatic_config``.

    Priorities (read): user > finalize-writes > signature fallback.
    Writes go to the finalize layer; a key already visible (user layer or an
    earlier finalize write) is NOT overwritten, except dict-valued writes,
    which merge recursively (filling only missing sub-keys).
    """

    def __init__(self, user: dict, defaults: dict, fallback: dict):
        self._user = user          # immutable (from the caller's perspective)
        self._defaults = defaults  # finalize-written defaults
        self._fallback = fallback  # signature defaults

    # -- reads ------------------------------------------------------------
    def _layers(self):
        return (self._user, self._defaults, self._fallback)

    def __contains__(self, key):
        return any(key in layer for layer in self._layers())

    def keys(self):
        seen = {}
        for layer in self._layers():
            for k in layer:
                seen.setdefault(k, None)
        return list(seen)

    def __iter__(self):
        return iter(self.keys())

    def get(self, key, default=None):
        return self[key] if key in self else default

    def __getitem__(self, key):
        for layer in self._layers():
            if key in layer:
                first = layer[key]
                break
        else:
            raise KeyError(key)
        if not isinstance(first, dict):
            return first
        # a dict value: a sub-view whose writes land in our defaults layer
        user = self._user.get(key)
        user = user if isinstance(user, dict) else {}
        dsub = self._defaults.get(key)
        if not isinstance(dsub, dict):
            dsub = {}
            self._defaults[key] = dsub
        fsub = self._fallback.get(key)
        fsub = fsub if isinstance(fsub, dict) else {}
        return DogmaticView(user, dsub, fsub)

    # -- writes -----------------------------------------------------------
    def __setitem__(self, key, value):
        if isinstance(value, DogmaticView):
            value = value.to_dict()
        # Only user values and earlier finalize writes are dogmatic; the
        # signature-fallback layer never blocks a write.
        existing = None
        found = False
        for layer in (self._user, self._defaults):
            if key in layer:
                existing = layer[key]
                found = True
                break
        if not found:
            self._defaults[key] = _copy_nested(value)
            return
        if isinstance(existing, dict) and isinstance(value, dict):
            # merge: fill only missing sub-keys (respecting all layers)
            sub = self[key]
            if ('factory' in value and 'factory' in sub
                    and not same_factory(value['factory'], sub['factory'])):
                return    # factory mismatch: the existing factory wins
            for k, v in value.items():
                sub[k] = v
        # else: a scalar already set is dogmatic; the write is ignored

    def setdefault(self, key, value):
        self[key] = value
        return self[key]

    def update(self, other):
        for k, v in dict(other).items():
            self[k] = v

    # -- materialize ------------------------------------------------------
    def to_dict(self):
        out = {}
        for k in self.keys():
            v = self[k]
            if isinstance(v, DogmaticView):
                v = v.to_dict()
            out[k] = _copy_nested(v)
        return out

    def __repr__(self):
        return f'DogmaticView({self.to_dict()!r})'


# ---------------------------------------------------------------------------
# get_config / from_config
# ---------------------------------------------------------------------------

def _signature_defaults(factory):
    """Defaults of ``factory``'s signature (or dataclass fields), without
    the port-only arguments, and its required arguments."""
    out = {}
    required = []
    try:
        sig = inspect.signature(factory)
    except (TypeError, ValueError):
        return out, required
    for name, p in sig.parameters.items():
        if p.kind in (p.VAR_POSITIONAL, p.VAR_KEYWORD) or name in PORT_ONLY:
            continue
        if p.default is inspect.Parameter.empty:
            required.append(name)
        elif type(p.default).__name__ == '_HAS_DEFAULT_FACTORY_CLASS':
            required.append(name)    # dataclass default_factory, see below
        else:
            out[name] = p.default
    return out, required


def get_config(factory, updates=None) -> dict:
    """The complete config for ``factory`` with ``updates`` layered on top."""
    factory_cls = import_class(factory)
    user = _copy_nested(updates) if updates else {}
    user.pop('factory', None)

    fallback, required = _signature_defaults(factory_cls)
    if dataclasses.is_dataclass(factory_cls):
        for f in dataclasses.fields(factory_cls):
            if f.default_factory is not dataclasses.MISSING:
                d = f.default_factory()
                if isinstance(d, Configurable):
                    fallback[f.name] = {'factory': class_to_str(type(d))}
                elif isinstance(d, (dict, list, str, int, float, bool, tuple,
                                    type(None))):
                    fallback[f.name] = d
                if f.name in required:
                    required.remove(f.name)

    defaults: dict = {}
    view = DogmaticView(user, defaults, fallback)
    finalize = getattr(factory_cls, 'finalize_dogmatic_config', None)
    if finalize is not None:
        finalize(view)

    config = view.to_dict()

    # the remaining signature defaults, then the required arguments
    for k, v in fallback.items():
        if k not in config:
            config[k] = v
        elif isinstance(config[k], dict) and isinstance(v, dict):
            config[k] = nested_merge(v, config[k])
    missing = [r for r in required if r not in config]
    if missing:
        raise ValueError(f'Missing required config keys for '
                         f'{class_to_str(factory_cls)}: {missing}')

    for k, v in list(config.items()):
        if is_factory_config(v):
            sub = get_config(v['factory'], {kk: vv for kk, vv in v.items()
                                            if kk != 'factory'})
            config[k] = {'factory': class_to_str(import_class(v['factory'])),
                         **sub}

    return {'factory': class_to_str(factory_cls),
            **{k: v for k, v in config.items() if k != 'factory'}}


def _port_options(factory, options):
    """The subset of ``options`` that ``factory``'s signature takes."""
    if not options:
        return {}
    try:
        params = inspect.signature(factory).parameters
    except (TypeError, ValueError):
        return {}
    return {k: v for k, v in options.items() if k in params}


def from_config(config, **options):
    """Recursively instantiate a factory config; ``options`` (port-only
    arguments such as ``device``) go to every factory that takes them."""
    unknown = set(options) - PORT_ONLY
    if unknown:
        raise TypeError(f'not port-only options: {sorted(unknown)}')
    if is_factory_config(config):
        factory = import_class(config['factory'])
        kwargs = {k: from_config(v, **options)
                  for k, v in config.items() if k != 'factory'}
        return factory(**kwargs, **_port_options(factory, options))
    if isinstance(config, dict):
        return {k: from_config(v, **options) for k, v in config.items()}
    if isinstance(config, list):
        return [from_config(v, **options) for v in config]
    return config


class Configurable:
    """Mixin giving classes the factory-config API."""

    @classmethod
    def get_config(cls, updates=None):
        return get_config(cls, updates)

    @classmethod
    def from_config(cls, config, **options):
        if is_factory_config(config):
            return from_config(config, **options)
        return from_config({'factory': class_to_str(cls), **(config or {})},
                           **options)

    @classmethod
    def new(cls, updates=None, **options):
        """Build the config with ``updates`` and instantiate it."""
        return from_config(cls.get_config(updates), **options)


# ---------------------------------------------------------------------------
# YAML round-trip
# ---------------------------------------------------------------------------

class _ConfigDumper(yaml.SafeDumper):
    pass


def _represent_tuple(dumper, data):
    return dumper.represent_list(list(data))


def _represent_path(dumper, data):
    return dumper.represent_str(str(data))


_ConfigDumper.add_representer(tuple, _represent_tuple)
_ConfigDumper.add_multi_representer(Path, _represent_path)


def _stringify_factories(obj):
    if isinstance(obj, dict):
        return {k: (class_to_str(v) if k == 'factory'
                    else _stringify_factories(v)) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_stringify_factories(v) for v in obj]
    if isinstance(obj, Path):
        return str(obj)
    return obj


def dumps_yaml(config) -> str:
    return yaml.dump(_stringify_factories(config), Dumper=_ConfigDumper,
                     default_flow_style=False, sort_keys=False)


def dump_yaml(config, path):
    path = Path(path)
    tmp = path.with_suffix(path.suffix + '.tmp')
    tmp.write_text(dumps_yaml(config))
    tmp.replace(path)  # atomic on POSIX


def load_yaml(path):
    with open(path) as f:
        return yaml.safe_load(f)
