"""Minimal yacs-style config tree, with its own reader for the YAML subset
the repository's configs use.

The port keeps its own copy of the JAX package's ``config/node.py`` so it
imports nothing of that package. PyYAML is not a dependency of the port:
``load_yaml`` reads block mappings nested by indentation, ``key: value``
scalars, flow lists ``[a, b]`` and ``#`` comments, which is all
``configs/pap/*.yaml`` holds; ``ConfigNode.dump`` writes a tree in that
subset (the train CLI's ``config.yaml``).
"""

from __future__ import annotations

import ast
from typing import Any


class ConfigNode(dict):
    """Nested dict with attribute access and yacs-style merging."""

    __slots__ = ()

    def __init__(self, init: dict | None = None):
        super().__init__()
        for k, v in (init or {}).items():
            self[k] = ConfigNode(v) if isinstance(v, dict) else v

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def merge_from_dict(self, other: dict) -> None:
        for k, v in other.items():
            if isinstance(v, dict) and isinstance(self.get(k), ConfigNode):
                self[k].merge_from_dict(v)
            else:
                self[k] = _coerce(v, self.get(k, None))

    def merge_from_file(self, path: str) -> None:
        with open(path) as f:
            data = load_yaml(f.read())
        self.merge_from_dict(data)

    def merge_from_list(self, opts: list) -> None:
        """yacs-style flat [KEY, VALUE, KEY, VALUE, ...] override list."""
        if len(opts) % 2:
            raise ValueError(f"override list must pair KEY VALUE: {opts}")
        for key, value in zip(opts[0::2], opts[1::2]):
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                node = node[p]
            node[parts[-1]] = _coerce(value, node.get(parts[-1], None))

    def dump(self) -> str:
        """The tree as YAML, keys sorted as the JAX package's ``yaml.safe_dump``
        sorts them, strings quoted and sequences as flow lists: what
        ``load_yaml`` (and PyYAML) read back."""
        return "".join(_dump_lines(self, 0))


def _dump_lines(node: dict, indent: int):
    for k in sorted(node):
        v = node[k]
        if isinstance(v, dict):
            yield f"{' ' * indent}{k}:\n"
            yield from _dump_lines(v, indent + 2)
        else:
            yield f"{' ' * indent}{k}: {_dump_value(v)}\n"


def _dump_value(v: Any) -> str:
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_dump_value(x) for x in v) + "]"
    if isinstance(v, str):
        if "'" in v or "," in v:
            raise ValueError(f"cannot write {v!r} in the YAML subset")
        return f"'{v}'"
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    return repr(v)


def _coerce(value: Any, current: Any) -> Any:
    """Parse string CLI/YAML values into python types, yacs-style."""
    if isinstance(value, str):
        try:
            value = ast.literal_eval(value)
        except (ValueError, SyntaxError):
            pass
    if isinstance(current, tuple) and isinstance(value, list):
        value = tuple(value)
    if isinstance(current, list) and isinstance(value, tuple):
        value = list(value)
    if isinstance(current, float) and isinstance(value, int) and not isinstance(value, bool):
        value = float(value)
    return value


# ------------------------------------------------------------- YAML subset
def _scalar(text: str) -> Any:
    low = text.lower()
    if low in ("true", "yes", "on"):
        return True
    if low in ("false", "no", "off"):
        return False
    if low in ("null", "~", ""):
        return None
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "'\"":
        return text[1:-1]
    for cast in (int, float):
        try:
            return cast(text)
        except ValueError:
            pass
    return text


def _value(text: str) -> Any:
    if text.startswith("["):
        if not text.endswith("]"):
            raise ValueError(f"unsupported YAML flow value {text!r}")
        inner = text[1:-1].strip()
        return [_scalar(t.strip()) for t in inner.split(",")] if inner else []
    return _scalar(text)


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            quote = None if ch == quote else quote
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1].isspace()):
            return line[:i]
    return line


def load_yaml(text: str) -> dict:
    """Parse the block-mapping YAML subset described in the module doc."""
    root: dict = {}
    stack = [(-1, root)]  # (indent, mapping)
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = _strip_comment(raw).rstrip()
        if not line.strip():
            continue
        indent = len(line) - len(line.lstrip(" "))
        key, sep, rest = line.strip().partition(":")
        if not sep or not key:
            raise ValueError(f"line {lineno}: expected 'key: value', got {raw!r}")
        while indent <= stack[-1][0]:
            stack.pop()
        parent = stack[-1][1]
        rest = rest.strip()
        if rest:
            parent[key] = _value(rest)
        else:
            parent[key] = {}
            stack.append((indent, parent[key]))
    return root
