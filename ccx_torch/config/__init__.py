"""Typed config system (ref C35: Kafka ConfigDef-style keys + SPI loading)."""

from ccx_torch.config.configs import (
    DEFAULT_GOALS,
    DEFAULT_HARD_GOALS,
    CruiseControlConfig,
    cruise_control_config_def,
)
from ccx_torch.config.definition import (
    NO_DEFAULT,
    ConfigDef,
    ConfigException,
    Importance,
    Type,
    load_properties,
    resolve_class,
)

__all__ = [
    "DEFAULT_GOALS",
    "DEFAULT_HARD_GOALS",
    "CruiseControlConfig",
    "cruise_control_config_def",
    "NO_DEFAULT",
    "ConfigDef",
    "ConfigException",
    "Importance",
    "Type",
    "load_properties",
    "resolve_class",
]
