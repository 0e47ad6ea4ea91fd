"""Typed ini config system with CLI override grammar (a copy of
piccolo_tpu/config.py: the port reads the same files the same way).

Behavioural re-implementation of the reference's config surface
(``parse_utils.py:6-85``, ``main.py:24-59``): ini sections are flattened
into one namespace, values are type-inferred (int/float/bool/None/lists),
the result is an immutable namedtuple, and the effective config is
re-serialized to ``<log>/config.ini``.  The three shipped reference configs
parse unmodified.

``cfg_get(cfg, key, default)`` mirrors the reference's point-of-use defaults
(``getattr(cfg, key, default)`` everywhere).
"""

from __future__ import annotations

import configparser
import os
from ast import literal_eval
from collections import namedtuple
from typing import Any, Dict, Optional

__all__ = ["parse_ini", "parse_value", "apply_overrides", "save_config", "cfg_get", "make_config"]


def _is_number(value: str) -> bool:
    # Accept decimal / exponential / signed forms, mirroring the reference's
    # replace-and-isdigit probe (parse_utils.py:14).
    return (
        value.replace(".", "", 1)
        .replace("+", "", 1)
        .replace("-", "", 1)
        .replace("e", "", 1)
        .isdigit()
    )


def parse_value(value: str) -> Any:
    """Type-infer one config value string."""
    value = value.strip()
    if _is_number(value):
        return literal_eval(value)
    if value in ("True", "true"):
        return True
    if value in ("False", "false"):
        return False
    if value == "None":
        return None
    if "," in value:
        items = [v.strip() for v in value.split(",")]
        items = [v for v in items if v != ""]
        if items and any(ch.isdigit() for ch in items[0]):
            return [literal_eval(v) for v in items]
        return items
    return value


def parse_ini(config_path: str):
    """ini file -> immutable namedtuple config (sections flattened)."""
    reader = configparser.ConfigParser()
    if not reader.read(config_path):
        raise FileNotFoundError(f"config file not found: {config_path}")
    data: Dict[str, Any] = {}
    for section in reader.sections():
        for key, value in reader.items(section):
            data[key] = parse_value(value)
    Config = namedtuple("Config", tuple(data.keys()))
    return Config(**data)


def make_config(**kwargs):
    """Build a config namedtuple directly (programmatic use / tests)."""
    Config = namedtuple("Config", tuple(kwargs.keys()))
    return Config(**kwargs)


def apply_overrides(cfg, override: Optional[str]):
    """Apply the ``--override "k1=v1,k2=v2,..."`` grammar.

    Same chained-assignment grammar as the reference (main.py:24-45): the
    string is split on '='; middle segments carry "value,nextkey"; list
    values may themselves contain commas and optional [brackets].
    """
    if not override:
        return cfg
    parts = override.split("=")
    assert len(parts) > 0
    if len(parts) == 2:
        od = {parts[0]: parse_value(parts[1])}
    else:
        keys = [parts[0]]
        keys += [seg.split(",")[-1] for seg in parts[1:-1]]
        values = [
            seg[: -(len(key) + 1)] if seg.endswith("," + key) else seg
            for seg, key in zip(parts[1:-1], keys[1:])
        ]
        values.append(parts[-1])
        values = [v.replace("[", "").replace("]", "") for v in values]
        od = {k: parse_value(v) for k, v in zip(keys, values)}

    base = cfg._asdict()
    base.update(od)
    Config = namedtuple("Config", tuple(base.keys()))
    return Config(**base)


def save_config(cfg, log_dir: str, filename: str = "config.ini") -> str:
    """Persist the effective config (reference main.py:47-59)."""
    writer = configparser.ConfigParser()
    writer.add_section("Default")
    for key, value in cfg._asdict().items():
        if key != "name":
            writer["Default"][key] = str(value).replace("[", "").replace("]", "")
        else:
            writer["Default"][key] = str(value)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, filename)
    with open(path, "w") as f:
        writer.write(f)
    return path


def cfg_get(cfg, key: str, default: Any = None) -> Any:
    """Point-of-use default lookup (getattr with fallback)."""
    return getattr(cfg, key, default)
