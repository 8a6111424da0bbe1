"""HOCON-compatible configuration system (the port's own copy of
avatarclip_tpu/config.py; tests/test_torch_config.py holds the two parsers
equal on every conf under ``confs/``).

The reference drives every stage with pyhocon ``.conf`` files (reference:
AvatarGen/AppearanceGen/main.py:38-42, AvatarAnimate/main.py:16-19). This module
implements a self-contained parser for the HOCON subset those configs use, so the
example confs, the ablation ladders and the animate confs parse unchanged with
no third-party dependency.

Supported syntax:
  - ``section { ... }`` nesting (also ``section = { ... }``)
  - ``key = value`` / ``key : value`` with dotted keys (``a.b.c = 1``)
  - scalars: int, float (incl. ``5e-4``), bool (``true/True/false/False``),
    bare or quoted strings (bare strings may contain ``{...}`` placeholders such
    as the ``{TOREPLACE}`` prompt templates in confs/examples_small/example.conf)
  - lists ``[a, b, c]`` including multiline lists of bare strings
  - comments ``#`` and ``//``; trailing commas

Access mirrors the pyhocon API used by the reference Runner: ``conf['a.b']``,
``get_string/get_int/get_float/get_bool/get_list`` with optional defaults, and
``as_dict()`` for splatting into constructors (builder.py:21 pattern).
"""

from __future__ import annotations

import re
from typing import Any


class ConfigMissingError(KeyError):
    pass


_NUM_INT = re.compile(r"^[+-]?\d+$")
_NUM_FLOAT = re.compile(r"^[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?$")


def _coerce(token: str) -> Any:
    """Parse a raw value token into int/float/bool if it looks like one."""
    t = token.strip()
    if _NUM_INT.match(t):
        return int(t)
    if _NUM_FLOAT.match(t):
        return float(t)
    low = t.lower()
    if low == "true":
        return True
    if low == "false":
        return False
    if low in ("null", "none"):
        return None
    if len(t) >= 2 and t[0] == t[-1] and t[0] in "\"'":
        return t[1:-1]
    return t


def _strip_comment(line: str) -> str:
    """Remove # / // comments (not inside quotes)."""
    out = []
    in_q: str | None = None
    i = 0
    while i < len(line):
        c = line[i]
        if in_q:
            if c == in_q:
                in_q = None
            out.append(c)
        else:
            if c in "\"'":
                in_q = c
                out.append(c)
            elif c == "#":
                break
            elif c == "/" and i + 1 < len(line) and line[i + 1] == "/":
                break
            else:
                out.append(c)
        i += 1
    return "".join(out)


def _parse_list(text: str) -> list:
    """Parse the inside of a [...] list literal."""
    items: list[Any] = []
    depth = 0
    cur = ""
    for c in text:
        if c == "[":
            depth += 1
            cur += c
        elif c == "]":
            depth -= 1
            cur += c
        elif c in ",\n" and depth == 0:
            if cur.strip():
                items.append(_parse_value(cur.strip()))
            cur = ""
        else:
            cur += c
    if cur.strip():
        items.append(_parse_value(cur.strip()))
    return items


def _parse_value(raw: str) -> Any:
    raw = raw.strip()
    if raw.endswith(","):
        raw = raw[:-1].rstrip()
    if raw.startswith("[") and raw.endswith("]"):
        return _parse_list(raw[1:-1])
    return _coerce(raw)


class Conf:
    """A (possibly nested) configuration tree with pyhocon-style accessors."""

    def __init__(self, data: dict | None = None):
        self._data: dict[str, Any] = data if data is not None else {}

    # -- raw access ---------------------------------------------------------
    def _resolve(self, key: str) -> Any:
        node: Any = self._data
        for part in key.split("."):
            if isinstance(node, Conf):
                node = node._data
            if not isinstance(node, dict) or part not in node:
                raise ConfigMissingError(key)
            node = node[part]
        return node

    def __getitem__(self, key: str) -> Any:
        v = self._resolve(key)
        if isinstance(v, dict):
            return Conf(v)
        return v

    def __contains__(self, key: str) -> bool:
        try:
            self._resolve(key)
            return True
        except ConfigMissingError:
            return False

    def put(self, key: str, value: Any) -> None:
        node = self._data
        parts = key.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value

    # -- typed getters (pyhocon API used by the reference Runner) -----------
    _MISSING = object()

    def _get(self, key: str, default: Any) -> Any:
        try:
            return self._resolve(key)
        except ConfigMissingError:
            if default is Conf._MISSING:
                raise
            return default

    def get_string(self, key: str, default: Any = _MISSING) -> str:
        v = self._get(key, default)
        return v if v is None else str(v)

    def get_int(self, key: str, default: Any = _MISSING) -> int:
        v = self._get(key, default)
        return v if v is None else int(v)

    def get_float(self, key: str, default: Any = _MISSING) -> float:
        v = self._get(key, default)
        return v if v is None else float(v)

    def as_dict(self) -> dict:
        """Deep-copy to plain python dict (for ``**conf`` constructor splats)."""

        def conv(v: Any) -> Any:
            if isinstance(v, dict):
                return {k: conv(x) for k, x in v.items()}
            if isinstance(v, list):
                return [conv(x) for x in v]
            return v

        return conv(self._data)


def parse_string(text: str) -> Conf:
    """Parse a HOCON document into a :class:`Conf`."""
    root: dict[str, Any] = {}
    stack: list[dict[str, Any]] = [root]

    lines = text.split("\n")
    i = 0
    n = len(lines)
    while i < n:
        line = _strip_comment(lines[i]).strip()
        i += 1
        if not line:
            continue

        # closing brace(s)
        while line.startswith("}"):
            if len(stack) > 1:
                stack.pop()
            line = line[1:].strip()
        if not line:
            continue

        # section open: "name {" or "name = {"
        m = re.match(r"^([\w.\-]+)\s*[=:]?\s*\{\s*$", line)
        if m:
            node = stack[-1]
            for part in m.group(1).split("."):
                node = node.setdefault(part, {})
            stack.append(node)
            continue

        # single-line section: "name { k = v, k2 = v2 }" — expand and recurse
        m = re.match(r"^([\w.\-]+)\s*[=:]?\s*\{(.*)\}\s*$", line)
        if m and "=" in m.group(2):
            node = stack[-1]
            for part in m.group(1).split("."):
                node = node.setdefault(part, {})
            inner = parse_string(
                "\n".join(p.strip() for p in m.group(2).split(",") if p.strip())
            )
            node.update(inner._data)
            continue

        # key = value
        m = re.match(r"^([\w.\-]+)\s*[=:]\s*(.*)$", line)
        if m:
            key, raw = m.group(1), m.group(2).strip()
            # multiline list: read until brackets balance
            if raw.startswith("[") and raw.count("[") > raw.count("]"):
                buf = [raw]
                depth = raw.count("[") - raw.count("]")
                while i < n and depth > 0:
                    nxt = _strip_comment(lines[i])
                    i += 1
                    depth += nxt.count("[") - nxt.count("]")
                    buf.append(nxt)
                raw = "\n".join(buf)
            # inline nested object: "key = { a = 1, b = 2 }"
            if raw.startswith("{") and raw.endswith("}"):
                inner = parse_string(
                    "\n".join(p.strip() for p in raw[1:-1].split(","))
                )
                value: Any = inner._data
            else:
                value = _parse_value(raw)
            node = stack[-1]
            parts = key.split(".")
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = value
            continue

        # lone closing brace already handled; ignore stray tokens
        if line == "{":
            continue
        raise ValueError(f"Cannot parse config line: {lines[i - 1]!r}")

    return Conf(root)


def parse_file(path: str, case: str | None = None) -> Conf:
    """Parse a HOCON file; ``case`` substitutes the reference's prompt
    templating tokens before parsing: ``{TOREPLACE}`` (the Colab workflow,
    reference: AvatarGen/AppearanceGen/confs/examples_small/example.conf:47-49)
    and ``CASE_NAME`` (the --case CLI flag, reference: main.py:31,959)."""
    with open(path, "r") as f:
        text = f.read()
    return parse_string(substitute_case(text, case))


def substitute_case(text: str, case: str | None) -> str:
    if case and case not in ("smpl", "CASE_NAME"):  # reference CLI defaults
        text = text.replace("{TOREPLACE}", case).replace("CASE_NAME", case)
    return text
