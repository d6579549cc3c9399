"""ConfigDef — typed, documented, validated configuration keys.

Parity: the reference's config system (SURVEY.md C35) is built on Kafka's
``ConfigDef``: every key is declared with a type, default, validator,
importance and doc string; ``config/KafkaCruiseControlConfig.java`` merges
per-subsystem defs (``MonitorConfig``, ``AnalyzerConfig``, ``ExecutorConfig``,
``AnomalyDetectorConfig``, ``WebServerConfig``, ``UserTaskManagerConfig``)
and class-valued keys instantiate SPI plugins reflectively. This module is
the same contract in Python: a declarative key table, coercing parser, and
reflective plugin instantiation via dotted paths.
"""

from __future__ import annotations

import dataclasses
import enum
import importlib
from typing import Any, Callable, Iterable


class ConfigException(Exception):
    """Parity: org.apache.kafka.common.config.ConfigException."""


class Type(enum.Enum):
    STRING = "string"
    INT = "int"
    LONG = "long"
    DOUBLE = "double"
    BOOLEAN = "boolean"
    LIST = "list"        # comma-separated -> tuple[str, ...]
    CLASS = "class"      # dotted path -> resolved object (class or callable)
    PASSWORD = "password"


class Importance(enum.Enum):
    HIGH = "high"
    MEDIUM = "medium"
    LOW = "low"


#: sentinel for keys with no default (required keys raise if absent)
NO_DEFAULT = object()


def _coerce(name: str, typ: Type, value: Any) -> Any:
    try:
        if typ is Type.STRING or typ is Type.PASSWORD:
            return str(value)
        if typ in (Type.INT, Type.LONG):
            if isinstance(value, bool):
                raise ValueError(value)
            return int(value)
        if typ is Type.DOUBLE:
            return float(value)
        if typ is Type.BOOLEAN:
            if isinstance(value, bool):
                return value
            s = str(value).strip().lower()
            if s in ("true", "1", "yes"):
                return True
            if s in ("false", "0", "no"):
                return False
            raise ValueError(value)
        if typ is Type.LIST:
            if isinstance(value, (list, tuple)):
                return tuple(str(v) for v in value)
            return tuple(s.strip() for s in str(value).split(",") if s.strip())
        if typ is Type.CLASS:
            # Kept as the dotted string (or the object itself); resolution is
            # lazy — CruiseControlConfig.configured_instance resolves at
            # plugin-construction time so config parsing never imports SPIs.
            return value
    except (TypeError, ValueError) as e:
        raise ConfigException(
            f"Invalid value {value!r} for configuration {name}: expected {typ.value}"
        ) from e
    raise ConfigException(f"Unknown config type {typ} for {name}")


def resolve_class(path: str) -> Any:
    """Resolve ``pkg.mod.Class`` (reflective SPI loading, ref C35).

    A path under the JAX package's root ``ccx`` resolves to its counterpart
    under ``ccx_torch``, so properties files and recipes written for the JAX
    package load the port's classes and never the JAX package; a path with
    no counterpart raises ``ConfigException`` like any unknown class."""
    module_name, _, attr = path.rpartition(".")
    if not module_name:
        raise ConfigException(f"Not a dotted class path: {path!r}")
    root, dot, rest = module_name.partition(".")
    if root == "ccx":
        module_name = "ccx_torch" + dot + rest
    try:
        module = importlib.import_module(module_name)
        return getattr(module, attr)
    except (ImportError, AttributeError) as e:
        raise ConfigException(f"Cannot resolve class {path!r}: {e}") from e


# ----- validators (parity: ConfigDef.Range / ValidString / NonEmptyList) ----

def at_least(lo: float) -> Callable[[str, Any], None]:
    def check(name: str, v: Any) -> None:
        if v < lo:
            raise ConfigException(f"{name} must be >= {lo}, got {v}")
    return check


def between(lo: float, hi: float) -> Callable[[str, Any], None]:
    def check(name: str, v: Any) -> None:
        if not (lo <= v <= hi):
            raise ConfigException(f"{name} must be in [{lo}, {hi}], got {v}")
    return check


def one_of(*allowed: str) -> Callable[[str, Any], None]:
    def check(name: str, v: Any) -> None:
        if v not in allowed:
            raise ConfigException(f"{name} must be one of {allowed}, got {v!r}")
    return check


def non_empty(name: str, v: Any) -> None:
    if v is None or (hasattr(v, "__len__") and len(v) == 0):
        raise ConfigException(f"{name} must be non-empty")


@dataclasses.dataclass(frozen=True)
class ConfigKey:
    name: str
    type: Type
    default: Any
    importance: Importance
    doc: str
    validator: Callable[[str, Any], None] | None = None


class ConfigDef:
    """A declarative table of config keys with a coercing parser."""

    def __init__(self) -> None:
        self._keys: dict[str, ConfigKey] = {}

    def define(
        self,
        name: str,
        typ: Type,
        default: Any,
        importance: Importance,
        doc: str,
        validator: Callable[[str, Any], None] | None = None,
    ) -> "ConfigDef":
        if name in self._keys:
            raise ConfigException(f"Configuration {name} defined twice")
        self._keys[name] = ConfigKey(name, typ, default, importance, doc, validator)
        return self

    def merge(self, other: "ConfigDef") -> "ConfigDef":
        for k in other._keys.values():
            if k.name not in self._keys:
                self._keys[k.name] = k
        return self

    @property
    def keys(self) -> dict[str, ConfigKey]:
        return dict(self._keys)

    def parse(self, props: dict[str, Any]) -> dict[str, Any]:
        parsed: dict[str, Any] = {}
        for name, key in self._keys.items():
            if name in props:
                value = _coerce(name, key.type, props[name])
            elif key.default is NO_DEFAULT:
                raise ConfigException(
                    f"Missing required configuration {name} which has no default"
                )
            else:
                value = key.default
            if key.validator is not None and value is not None:
                key.validator(name, value)
            parsed[name] = value
        return parsed

    def unknown_keys(self, props: Iterable[str]) -> list[str]:
        return sorted(set(props) - set(self._keys))

    def doc_table(self) -> list[dict[str, Any]]:
        """Config reference rows (used by docs generation, ref M7 wiki)."""
        return [
            {
                "name": k.name,
                "type": k.type.value,
                "default": None if k.default is NO_DEFAULT else k.default,
                "importance": k.importance.value,
                "doc": k.doc,
            }
            for k in sorted(self._keys.values(), key=lambda k: k.name)
        ]


def load_properties(path: str) -> dict[str, str]:
    """Parse a java-style ``.properties`` file (ref M6
    ``config/cruisecontrol.properties``): ``key=value`` lines, ``#``/``!``
    comments, trailing-backslash continuations."""
    props: dict[str, str] = {}
    pending = ""
    with open(path, encoding="utf-8") as f:
        for raw in f:
            line = pending + raw.strip()
            pending = ""
            if not line or line.startswith(("#", "!")):
                continue
            if line.endswith("\\"):
                pending = line[:-1]
                continue
            for sep in ("=", ":"):
                if sep in line:
                    k, _, v = line.partition(sep)
                    props[k.strip()] = v.strip()
                    break
            else:
                props[line] = ""
    return props
