"""Plugin loader: config-named implementations resolve at runtime.

Port of ``pinot_tpu/spi/plugin.py``. The built-in short names are the
two stream consumers of the port (``inmemory``, ``filelog``); the
reference's ``localfs`` names ``spi/filesystem``, which comes with the
cluster plane.

Reference parity: pinot-spi/.../spi/plugin/PluginManager.java —
`createInstance(className)` is the substitution point that makes every
SPI pluggable (stream consumers, filesystems, metrics backends, query
executors are all chosen by config key, e.g. `queryExecutor.class`).
Python's import system replaces the isolated classloaders: a plugin is
any importable class; short names register in-process so built-ins and
tests don't need dotted paths.
"""
from __future__ import annotations

import importlib
import threading
from typing import Any, Dict, Type

_REGISTRY: Dict[str, Any] = {}
_LOCK = threading.Lock()


def register_plugin(name: str, cls: Any) -> None:
    """Register a short name -> class (the bundled-plugin manifest
    analog). Re-registering the same name with a different class raises —
    silent replacement hides deployment mistakes."""
    with _LOCK:
        cur = _REGISTRY.get(name)
        if cur is not None and cur is not cls:
            raise ValueError(f"plugin name {name!r} already registered "
                             f"to {cur!r}")
        _REGISTRY[name] = cls


def resolve_class(name: str) -> Type:
    """Short registered name, or a dotted 'pkg.module.Class' path."""
    with _LOCK:
        if name in _REGISTRY:
            return _REGISTRY[name]
    if "." not in name:
        raise KeyError(f"unknown plugin {name!r}; registered: "
                       f"{sorted(_REGISTRY)}")
    module_name, _, cls_name = name.rpartition(".")
    module = importlib.import_module(module_name)
    try:
        return getattr(module, cls_name)
    except AttributeError:
        raise KeyError(f"module {module_name!r} has no class "
                       f"{cls_name!r}") from None


def create_instance(name: str, *args: Any, **kwargs: Any) -> Any:
    """PluginManager.createInstance analog."""
    return resolve_class(name)(*args, **kwargs)


def _register_builtins() -> None:
    """Built-in plugins under their config short names (the reference
    ships these as bundled plugin modules)."""
    from ..realtime.filestream import FileLogStream
    from ..realtime.stream import InMemoryStream

    register_plugin("inmemory", InMemoryStream)
    register_plugin("filelog", FileLogStream)


_register_builtins()
