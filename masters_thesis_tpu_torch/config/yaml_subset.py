"""The YAML subset that ``configs/`` is written in: a reader and an emitter.

PyYAML is not a dependency of the port, so it reads and writes its config
files itself. The reader takes exactly what the files under ``configs/``
use, and gives what ``yaml.safe_load`` gives for them:

- block mappings whose keys are plain words;
- block lists of scalars or of one-key mappings (the defaults list), at the
  key's indent or deeper;
- flow lists of scalars (``buckets: [1, 2, 4, 8]``), and ``[]``, ``{}``;
- scalars with YAML 1.1's resolution: decimal ints, floats with a dot
  (``0.0001``; ``1e-4`` is a string in YAML 1.1, as PyYAML reads it),
  ``.inf``/``.nan``, the bools (``true``, ``yes``, ``on``, ...), null (``~``,
  ``null``, nothing), plain strings (``${a.b}`` included), and quoted
  strings without escapes beyond JSON's;
- comments and blank lines.

Anything else (anchors, tags, multi-line scalars, flow mappings with
content, octal, hex or sexagesimal numbers, dates, tabs, several documents)
raises :class:`YamlSubsetError` naming the file and line: the reader does
not guess what PyYAML would make of it.

:func:`dump` writes a config tree in block style that ``yaml.safe_load``
(and :func:`loads`) read back to an equal tree: the port's
``.hydra/config.yaml`` and ``overrides.yaml``.
"""

from __future__ import annotations

import json
import math
import re
from pathlib import Path
from typing import Any


class YamlSubsetError(ValueError):
    """Input outside the subset, with the file and line it was found at."""


_NULL = {"", "~", "null", "Null", "NULL"}
_TRUE = {"true", "True", "TRUE", "yes", "Yes", "YES", "on", "On", "ON"}
_FALSE = {"false", "False", "FALSE", "no", "No", "NO", "off", "Off", "OFF"}
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9]*)")
# YAML 1.1's float, without '_' separators and sexagesimal forms (refused).
_FLOAT = re.compile(r"[-+]?(?:[0-9]+\.[0-9]*|\.[0-9]+)(?:[eE][-+][0-9]+)?")
_INF = re.compile(r"[-+]?\.(?:inf|Inf|INF)")
_NAN = re.compile(r"\.(?:nan|NaN|NAN)")
# Plain scalars YAML 1.1 reads as something this subset does not produce:
# other int and float spellings (octal, hex, binary, '_' separators,
# sexagesimal) and dates.
_OTHER_NUMBER = re.compile(
    r"[-+]?(?:0[0-7_]+|0x[0-9a-fA-F_]+|0b[01_]+|[0-9][0-9_]*(?::[0-5]?[0-9])+"
    r"(?:\.[0-9_]*)?|[0-9][0-9_]*(?:\.[0-9_]*)?(?:[eE][-+][0-9]+)?)"
)
_DATE = re.compile(r"[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}(?:[Tt ].*)?")
_KEY = re.compile(r"[A-Za-z_][A-Za-z0-9_-]*")
# First characters that make a plain scalar something else in YAML.
_INDICATORS = set("[]{},#&*!|>'\"%@`?:-")


class _Source:
    """Where the text came from, for the error messages."""

    def __init__(self, name: str):
        self.name = name

    def fail(self, lineno: int, msg: str) -> YamlSubsetError:
        return YamlSubsetError(f"{self.name}:{lineno}: {msg}")


def _strip_comment(text: str) -> str:
    """``text`` without a trailing comment: a ``#`` at its start or after a
    blank, outside quotes."""
    quote = None
    for i, ch in enumerate(text):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"" and (i == 0 or text[i - 1] in " [,"):
            quote = ch
        elif ch == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i].rstrip()
    return text.rstrip()


def _scalar(text: str, src: _Source, lineno: int) -> Any:
    """One scalar, resolved as YAML 1.1 (PyYAML) resolves it."""
    text = text.strip()
    if text[:1] == '"':
        if not text.endswith('"') or len(text) < 2:
            raise src.fail(lineno, f"unterminated double-quoted scalar {text!r}")
        try:
            value = json.loads(text)
        except ValueError:
            raise src.fail(lineno, f"double-quoted scalar outside the subset: "
                                   f"{text!r}") from None
        if not isinstance(value, str):
            raise src.fail(lineno, f"not one double-quoted scalar: {text!r}")
        return value
    if text[:1] == "'":
        inner = text[1:-1]
        if (len(text) < 2 or not text.endswith("'")
                or "'" in inner.replace("''", "")):
            raise src.fail(lineno, f"malformed single-quoted scalar {text!r}")
        return inner.replace("''", "'")
    if text in _NULL:
        return None
    if text in _TRUE:
        return True
    if text in _FALSE:
        return False
    if _INT.fullmatch(text):
        return int(text)
    if _FLOAT.fullmatch(text):
        return float(text)
    if _INF.fullmatch(text):
        return -math.inf if text[0] == "-" else math.inf
    if _NAN.fullmatch(text):
        return math.nan
    if _OTHER_NUMBER.fullmatch(text) or _DATE.fullmatch(text):
        raise src.fail(lineno, f"scalar {text!r} is a number or date form "
                               "outside the subset")
    if (text[0] in _INDICATORS and not (text[0] == "-" and text[1:2] not in ("", " "))
            or ": " in text or text.endswith(":") or " #" in text
            or text in ("=", "<<")):
        raise src.fail(lineno, f"plain scalar {text!r} is outside the subset")
    return text


def _value(text: str, src: _Source, lineno: int) -> Any:
    """A mapping value or list item on one line: a flow list, ``{}`` or a
    scalar."""
    text = text.strip()
    if text == "{}":
        return {}
    if text.startswith("{"):
        raise src.fail(lineno, "flow mappings are outside the subset")
    if text.startswith("["):
        if not text.endswith("]"):
            raise src.fail(lineno, f"unterminated flow list {text!r}")
        inner = text[1:-1].strip()
        if not inner:
            return []
        items = [item.strip() for item in inner.split(",")]
        if any(not item or item[0] in "[{" for item in items):
            raise src.fail(lineno, f"flow list {text!r}: only non-empty "
                                   "scalars are in the subset")
        return [_scalar(item, src, lineno) for item in items]
    return _scalar(text, src, lineno)


def _lines(text: str, src: _Source) -> list[tuple[int, int, str]]:
    """``(lineno, indent, content)`` of every line that holds more than a
    comment."""
    out = []
    for lineno, raw in enumerate(text.splitlines(), start=1):
        body = _strip_comment(raw)
        if not body.strip():
            continue
        stripped = body.lstrip(" ")
        if "\t" in body:
            raise src.fail(lineno, "tabs are outside the subset")
        if stripped.startswith(("---", "...", "%")):
            raise src.fail(lineno, "document markers and directives are "
                                   "outside the subset")
        if stripped[0] in "&*!|>":
            raise src.fail(lineno, "anchors, aliases, tags and block scalars "
                                   "are outside the subset")
        out.append((lineno, len(body) - len(stripped), stripped))
    return out


def _split_key(content: str, src: _Source, lineno: int) -> tuple[str, str]:
    key, sep, rest = content.partition(":")
    if not sep or (rest and rest[0] != " "):
        raise src.fail(lineno, f"expected 'key: value', got {content!r}")
    if not _KEY.fullmatch(key):
        raise src.fail(lineno, f"key {key!r} is outside the subset (plain "
                               "words only)")
    return key, rest.strip()


def _is_item(content: str) -> bool:
    return content == "-" or content.startswith("- ")


class _Parser:
    def __init__(self, lines: list[tuple[int, int, str]], src: _Source):
        self.lines = lines
        self.src = src
        self.pos = 0

    def peek(self):
        return self.lines[self.pos] if self.pos < len(self.lines) else None

    def block(self, indent: int) -> Any:
        """The node whose lines start at ``indent``."""
        if _is_item(self.lines[self.pos][2]):
            return self.sequence(indent)
        return self.mapping(indent)

    def mapping(self, indent: int) -> dict:
        out: dict = {}
        while (line := self.peek()) is not None and line[1] == indent:
            lineno, _, content = line
            if _is_item(content):
                raise self.src.fail(lineno, "list item inside a mapping")
            key, rest = _split_key(content, self.src, lineno)
            if key in out:
                raise self.src.fail(lineno, f"duplicate key {key!r}")
            self.pos += 1
            nxt = self.peek()
            if rest:
                out[key] = _value(rest, self.src, lineno)
                if nxt is not None and nxt[1] > indent:
                    raise self.src.fail(nxt[0], "multi-line scalars are "
                                                "outside the subset")
            elif nxt is not None and nxt[1] > indent:
                out[key] = self.block(nxt[1])
            elif nxt is not None and nxt[1] == indent and _is_item(nxt[2]):
                out[key] = self.sequence(indent)
            else:
                out[key] = None
        line = self.peek()
        if line is not None and line[1] > indent:
            raise self.src.fail(line[0], "unexpected indentation")
        return out

    def sequence(self, indent: int) -> list:
        out: list = []
        while ((line := self.peek()) is not None and line[1] == indent
               and _is_item(line[2])):
            lineno, _, content = line
            item = content[1:].strip()
            self.pos += 1
            nxt = self.peek()
            if not item:
                raise self.src.fail(lineno, "empty and nested list items are "
                                            "outside the subset")
            if nxt is not None and nxt[1] > indent:
                raise self.src.fail(nxt[0], "list items of more than one line "
                                            "are outside the subset")
            key, sep, _ = item.partition(":")
            if sep and _KEY.fullmatch(key) and item[len(key) + 1:][:1] in ("", " "):
                key, rest = _split_key(item, self.src, lineno)
                out.append({key: _value(rest, self.src, lineno) if rest else None})
            else:
                out.append(_value(item, self.src, lineno))
        return out


def loads(text: str, name: str = "<string>") -> Any:
    """Parse ``text`` (a whole document); ``None`` when it holds nothing,
    as ``yaml.safe_load``."""
    src = _Source(name)
    lines = _lines(text, src)
    if not lines:
        return None
    if lines[0][1] != 0:
        raise src.fail(lines[0][0], "the document must start at column 0")
    lineno, _, content = lines[0]
    if (len(lines) == 1 and not _is_item(content)
            and not re.match(r"[A-Za-z_][A-Za-z0-9_-]*:( |$)", content)):
        return _value(content, src, lineno)  # a document of one value
    parser = _Parser(lines, src)
    node = parser.block(0)
    if parser.peek() is not None:
        raise src.fail(parser.peek()[0], "unexpected content after the "
                                         "document's top-level node")
    return node


def load(path: str | Path) -> Any:
    """Parse the file at ``path``."""
    path = Path(path)
    return loads(path.read_text(), str(path))


def parse_value(text: str) -> Any:
    """One value as it stands on a line (a scalar or a flow list); raises
    :class:`YamlSubsetError` outside the subset."""
    return _value(text, _Source("<value>"), 1) if text.strip() else None


# -------------------------------------------------------------------- emitter


def _emit_scalar(value: Any) -> str:
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        if math.isnan(value):
            return ".nan"
        if math.isinf(value):
            return ".inf" if value > 0 else "-.inf"
        text = repr(value)
        # YAML 1.1 floats need a dot: 1e-05 -> 1.0e-05 (PyYAML's rule).
        if "." not in text and "e" in text:
            text = text.replace("e", ".0e", 1)
        return text
    if isinstance(value, str):
        try:
            plain = (value == value.strip() and bool(value)
                     and re.fullmatch(r"[A-Za-z0-9_$/.][A-Za-z0-9_$/.{}=:,+~-]*",
                                      value) is not None
                     and _scalar(value, _Source("<emit>"), 1) == value)
        except YamlSubsetError:
            plain = False
        return value if plain else json.dumps(value)
    raise TypeError(f"cannot emit {type(value).__name__} {value!r}")


def _emit(node: Any, indent: int, out: list[str]) -> None:
    pad = " " * indent
    if isinstance(node, dict):
        for key, value in node.items():
            if not isinstance(key, str) or not _KEY.fullmatch(key):
                raise TypeError(f"cannot emit key {key!r}")
            if isinstance(value, dict) and value:
                out.append(f"{pad}{key}:")
                _emit(value, indent + 2, out)
            elif isinstance(value, list) and value:
                out.append(f"{pad}{key}:")
                _emit(value, indent, out)
            else:
                out.append(f"{pad}{key}: {_emit_inline(value)}")
    elif isinstance(node, list):
        for item in node:
            if isinstance(item, dict) and len(item) == 1 and not isinstance(
                    next(iter(item.values())), (dict, list)):
                (key, value), = item.items()
                _emit({key: value}, 0, lines := [])
                out.append(f"{pad}- {lines[0]}")
            elif isinstance(item, (dict, list)) and item:
                out.append(f"{pad}-")
                _emit(item, indent + 2, out)
            else:
                out.append(f"{pad}- {_emit_inline(item)}")
    else:
        out.append(pad + _emit_inline(node))


def _emit_inline(value: Any) -> str:
    if isinstance(value, dict):
        return "{}"
    if isinstance(value, list):
        return "[]"
    return _emit_scalar(value)


def dump(node: Any) -> str:
    """``node`` (dicts with word keys, lists, scalars) as block-style YAML."""
    if isinstance(node, (dict, list)) and not node:
        return _emit_inline(node) + "\n"
    out: list[str] = []
    _emit(node, 0, out)
    return "\n".join(out) + "\n"
