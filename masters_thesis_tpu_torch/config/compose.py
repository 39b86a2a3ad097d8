"""Config composition: groups + defaults list + interpolation + overrides.

A copy of ``masters_thesis_tpu/config/compose.py`` (the port imports
nothing of the JAX package), with the same semantics, on the port's own
YAML reader (``yaml_subset``) instead of PyYAML:

- ``defaults`` list in the primary config selects one YAML per config group
  (``- model: small`` loads ``<config_dir>/model/small.yaml`` under the
  ``model`` key); ``_self_`` positions the primary config's own keys in the
  merge order.
- CLI overrides: ``group=option`` re-selects a group, ``a.b=value`` sets a
  leaf (YAML-typed), ``+a.b=value`` adds a new key, ``~a.b`` deletes one.
- Interpolations: ``${a.b}`` references another config node;
  ``${resolver:arg1,arg2}`` calls a registered resolver; interpolations
  nest (``${f:${a.b}}``, as in configs/model/small.yaml).
- Multirun: comma-separated values in overrides expand to the cartesian
  product of single-run override lists.
"""

from __future__ import annotations

import copy
import itertools
from pathlib import Path
from typing import Any, Callable

from masters_thesis_tpu_torch.config import yaml_subset


class Config(dict):
    """Nested dict with attribute access (``cfg.model.hidden_size``)."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    @staticmethod
    def wrap(obj: Any) -> Any:
        """Recursively convert plain dicts to Config."""
        if isinstance(obj, dict):
            return Config({k: Config.wrap(v) for k, v in obj.items()})
        if isinstance(obj, list):
            return [Config.wrap(v) for v in obj]
        return obj


_RESOLVERS: dict[str, Callable[..., Any]] = {}


def register_resolver(name: str, fn: Callable[..., Any]) -> None:
    """Register a ``${name:args}`` resolver."""
    _RESOLVERS[name] = fn


# --------------------------------------------------------------- primitives


def _parse_value(text: str) -> Any:
    """YAML-typed parse of an override value ('1e-4' -> float, 'true' -> bool).

    YAML 1.1 only floats exponent literals with a dot ('1.0e-4'), but CLI
    sweeps write '1e-4' (sweeps/example.sh), so numbers are tried first. A
    value outside the YAML subset (a date, a flow mapping, a comment, ...)
    raises: PyYAML would read it as something the port does not guess at.
    """
    try:
        return int(text)
    except ValueError:
        pass
    try:
        return float(text)
    except ValueError:
        pass
    try:
        return yaml_subset.parse_value(text)
    except yaml_subset.YamlSubsetError as exc:
        raise ValueError(f"value {text!r} is outside the YAML subset the "
                         f"port reads ({exc})") from None


def _get_path(cfg: dict, path: str) -> Any:
    node: Any = cfg
    for part in path.split("."):
        if not isinstance(node, dict) or part not in node:
            raise KeyError(f"config path not found: {path!r} (missing {part!r})")
        node = node[part]
    return node


def _set_path(cfg: dict, path: str, value: Any, *, allow_new: bool) -> None:
    parts = path.split(".")
    node: Any = cfg
    for part in parts[:-1]:
        if part not in node:
            if not allow_new:
                raise KeyError(
                    f"override path not found: {path!r} (missing {part!r}); "
                    f"use +{path} to add new keys"
                )
            node[part] = Config()
        node = node[part]
    if parts[-1] not in node and not allow_new:
        raise KeyError(
            f"override path not found: {path!r}; use +{path} to add new keys"
        )
    node[parts[-1]] = value


def _del_path(cfg: dict, path: str) -> None:
    parts = path.split(".")
    node = _get_path(cfg, ".".join(parts[:-1])) if len(parts) > 1 else cfg
    node.pop(parts[-1], None)


# ------------------------------------------------------------ interpolation


def _find_interpolation(text: str) -> tuple[int, int] | None:
    """Locate the first ``${...}`` span, honouring nested braces."""
    start = text.find("${")
    if start < 0:
        return None
    depth = 0
    i = start
    while i < len(text):
        if text.startswith("${", i):
            depth += 1
            i += 2
            continue
        if text[i] == "}":
            depth -= 1
            if depth == 0:
                return start, i + 1
        i += 1
    raise ValueError(f"unterminated interpolation in {text!r}")


def _resolve_expr(expr: str, root: dict, stack: tuple[str, ...]) -> Any:
    """Resolve the inside of one ``${...}``: resolver call or config path."""
    expr = _resolve_str(expr, root, stack)
    if isinstance(expr, str) and ":" in expr:
        name, _, argstr = expr.partition(":")
        if name in _RESOLVERS:
            args = [_parse_value(a) for a in argstr.split(",")] if argstr else []
            return _RESOLVERS[name](*args)
    if expr in stack:
        raise ValueError(f"interpolation cycle: {' -> '.join(stack + (expr,))}")
    value = _get_path(root, expr)
    return _resolve_node(value, root, stack + (expr,))


def _resolve_str(value: str, root: dict, stack: tuple[str, ...]) -> Any:
    span = _find_interpolation(value) if isinstance(value, str) else None
    if span is None:
        return value
    start, end = span
    inner = _resolve_expr(value[start + 2 : end - 1], root, stack)
    if start == 0 and end == len(value):
        return inner  # whole-string interpolation keeps the value's type
    rest = _resolve_str(value[end:], root, stack)
    return f"{value[:start]}{inner}{rest}"


def _resolve_node(node: Any, root: dict, stack: tuple[str, ...] = ()) -> Any:
    if isinstance(node, str):
        return _resolve_str(node, root, stack)
    if isinstance(node, dict):
        return Config({k: _resolve_node(v, root, stack) for k, v in node.items()})
    if isinstance(node, list):
        return [_resolve_node(v, root, stack) for v in node]
    return node


# ---------------------------------------------------------------- composing


def _deep_merge(base: dict, extra: dict) -> dict:
    for key, value in extra.items():
        if isinstance(value, dict) and isinstance(base.get(key), dict):
            _deep_merge(base[key], value)
        else:
            base[key] = copy.deepcopy(value)
    return base


def _load_yaml(path: Path) -> Config:
    if not path.exists():
        raise FileNotFoundError(f"config file not found: {path}")
    return Config.wrap(yaml_subset.load(path) or {})


def parse_overrides(
    overrides: list[str],
) -> tuple[dict[str, str], list[tuple[str, str, Any]]]:
    """Split CLI overrides into (group selections, value edits).

    Group selections are ``name=option`` where ``name`` has no dot and no
    ``+``/``~`` prefix; whether a name actually is a group is decided by the
    caller against the config tree.
    """
    groups: dict[str, str] = {}
    edits: list[tuple[str, str, Any]] = []
    for ov in overrides:
        if ov.startswith("~"):
            edits.append(("del", ov[1:], None))
            continue
        if "=" not in ov:
            raise ValueError(f"malformed override (expected key=value): {ov!r}")
        key, _, raw = ov.partition("=")
        if key.startswith("+"):
            edits.append(("add", key[1:], _parse_value(raw)))
        elif "." not in key:
            groups[key] = raw
        else:
            edits.append(("set", key, _parse_value(raw)))
    return groups, edits


def compose(
    config_dir: str | Path,
    config_name: str = "config",
    overrides: list[str] | None = None,
    resolve: bool = True,
) -> Config:
    """Compose the run config as Hydra would (see module docstring)."""
    config_dir = Path(config_dir)
    overrides = list(overrides or [])
    groups, edits = parse_overrides(overrides)

    primary = _load_yaml(config_dir / f"{config_name}.yaml")
    defaults = primary.pop("defaults", [{"_self_": None}])

    cfg = Config()
    self_merged = False
    for entry in defaults:
        if entry == "_self_":
            _deep_merge(cfg, primary)
            self_merged = True
            continue
        if not isinstance(entry, dict) or len(entry) != 1:
            raise ValueError(f"malformed defaults entry: {entry!r}")
        (group, option), = entry.items()
        option = groups.pop(group, option)
        if option in (None, "null"):
            continue
        cfg[group] = _load_yaml(config_dir / group / f"{option}.yaml")
    if not self_merged:
        _deep_merge(cfg, primary)

    # Group-style overrides for groups not in the defaults list: treat a
    # bare name as a group if <config_dir>/<name>/ exists, else as a
    # top-level value edit (e.g. `checkpoint=path`).
    for name, raw in groups.items():
        if (config_dir / name).is_dir():
            cfg[name] = _load_yaml(config_dir / name / f"{raw}.yaml")
        else:
            edits.append(("set", name, _parse_value(raw)))

    for action, path, value in edits:
        if action == "del":
            _del_path(cfg, path)
        else:
            _set_path(cfg, path, value, allow_new=(action == "add"))

    return _resolve_node(cfg, cfg) if resolve else cfg


def expand_multirun(overrides: list[str]) -> list[list[str]]:
    """Expand comma-separated override values into the cartesian sweep.

    ``["lr=1e-3,1e-4", "model=large"]`` -> two single-run override lists.
    Commas inside brackets are value syntax (``dims=[16,32]``), not sweep
    separators.
    """
    choice_lists: list[list[str]] = []
    for ov in overrides:
        key, eq, raw = ov.partition("=")
        choices = _split_top_level(raw) if eq else [raw]
        if len(choices) > 1:
            choice_lists.append([f"{key}={v}" for v in choices])
        else:
            choice_lists.append([ov])
    return [list(combo) for combo in itertools.product(*choice_lists)]


def _split_top_level(raw: str) -> list[str]:
    """Split on commas not nested inside []/{}."""
    parts, depth, start = [], 0, 0
    for i, ch in enumerate(raw):
        if ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
        elif ch == "," and depth == 0:
            parts.append(raw[start:i])
            start = i + 1
    parts.append(raw[start:])
    return parts


def to_flat_dict(cfg: dict, prefix: str = "") -> dict[str, Any]:
    """Flatten to ``{'model.hidden_size': 64, ...}`` — for hparam logging."""
    flat: dict[str, Any] = {}
    for key, value in cfg.items():
        path = f"{prefix}{key}"
        if isinstance(value, dict):
            flat.update(to_flat_dict(value, f"{path}."))
        else:
            flat[path] = value
    return flat

