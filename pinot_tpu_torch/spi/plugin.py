"""Plugin loader: config-named implementations resolve at runtime.

Port of ``pinot_tpu/spi/plugin.py``. The built-in short names are the
two stream consumers of the port (``inmemory``, ``filelog``); the
reference's ``localfs`` names ``spi/filesystem``, which comes with the
cluster plane.

A dotted name under the JAX package (``pinot_tpu.``) resolves to the
port's module of the same path under ``pinot_tpu_torch.``, so table
configs written for the reference (``consumer_factory_class=
"pinot_tpu.realtime.kafka.KafkaStream"``) run unchanged and the port
never imports the JAX package; a path the port lacks raises
``KeyError`` naming the port's path.

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
    port_name = port_module_name(module_name)
    if port_name != module_name:
        try:
            module = importlib.import_module(port_name)
        except ModuleNotFoundError as e:
            if e.name is None or not (port_name + ".").startswith(
                    e.name + "."):
                raise          # the module exists; an import inside failed
            raise KeyError(f"the port has no module {port_name!r} (for "
                           f"{name!r})") from None
        module_name = port_name
    else:
        module = importlib.import_module(module_name)
    try:
        return getattr(module, cls_name)
    except AttributeError:
        raise KeyError(f"module {module_name!r} has no class "
                       f"{cls_name!r}") from None


_REFERENCE = "pinot_tpu"
_PORT = __name__.split(".")[0]


def port_module_name(module_name: str) -> str:
    """The port's module for a module path under the JAX package (same
    path under ``pinot_tpu_torch``); any other path unchanged."""
    head, dot, rest = module_name.partition(".")
    if head == _REFERENCE:
        return _PORT + dot + rest
    return module_name


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
