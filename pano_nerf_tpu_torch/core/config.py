"""Flat dot-key YAML config system, without PyYAML.

Counterpart of pano_nerf_tpu/core/config.py: nested YAML flattens into one
dict keyed by the dotted nesting path (`nerf.mlp.net_width`); string leaves
go through `ast.literal_eval` when they parse; lists become tuples; a
top-level `_base_: other.yaml` loads that file first and overlays this one.

The machines the port runs on need not have PyYAML, so this module parses
the subset of YAML the repository's configs use: block mappings by
indentation, plain and quoted scalars, flow lists of scalars and `#`
comments. Plain scalars resolve as YAML 1.1 (PyYAML's `safe_load`) does:
null, booleans (true/yes/on ...), decimal integers and floats with a dot;
everything else stays a string for `literal_eval` to try.
"""

from __future__ import annotations

import argparse
import os
import re
from ast import literal_eval
from typing import Dict, Iterator, List, Optional, Tuple

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_CONFIG_FILE = os.path.join(_REPO_ROOT, "configs", "default.yaml")

_BOOLS = {v: True for v in ("yes", "Yes", "YES", "true", "True", "TRUE",
                            "on", "On", "ON")}
_BOOLS.update({v: False for v in ("no", "No", "NO", "false", "False",
                                  "FALSE", "off", "Off", "OFF")})
_NULLS = ("~", "null", "Null", "NULL", "")
_INT = re.compile(r"[-+]?(0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"[-+]?([0-9][0-9_]*)?\.[0-9_]*([eE][-+][0-9]+)?$")
_SPECIAL_FLOATS = {".inf": float("inf"), ".Inf": float("inf"),
                   ".INF": float("inf"), "-.inf": float("-inf"),
                   "-.Inf": float("-inf"), "-.INF": float("-inf"),
                   ".nan": float("nan"), ".NaN": float("nan"),
                   ".NAN": float("nan")}


def _strip_comment(line: str) -> str:
    """Drop a `#` comment that starts the line or follows whitespace,
    outside quotes."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _split_flow(body: str) -> List[str]:
    items, depth, quote, start = [], 0, None, 0
    for i, ch in enumerate(body):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "[":
            depth += 1
        elif ch == "]":
            depth -= 1
        elif ch == "," and depth == 0:
            items.append(body[start:i])
            start = i + 1
    items.append(body[start:])
    return [s.strip() for s in items]


def _scalar(text: str):
    """Resolve one YAML scalar the way PyYAML's safe_load does."""
    text = text.strip()
    if len(text) >= 2 and text[0] == text[-1] == "'":
        return text[1:-1].replace("''", "'")
    if len(text) >= 2 and text[0] == text[-1] == '"':
        return bytes(text[1:-1], "utf-8").decode("unicode_escape")
    if text.startswith("[") and text.endswith("]"):
        body = text[1:-1].strip()
        return [_scalar(s) for s in _split_flow(body)] if body else []
    if text in _NULLS:
        return None
    if text in _BOOLS:
        return _BOOLS[text]
    if _INT.match(text):
        return int(text.replace("_", ""))
    if text in _SPECIAL_FLOATS:
        return _SPECIAL_FLOATS[text]
    if _FLOAT.match(text) and any(c.isdigit() for c in text):
        return float(text.replace("_", ""))
    return text


def parse_yaml(source: str) -> Optional[dict]:
    """Parse the block-mapping YAML subset; None for an empty document."""
    lines: List[Tuple[int, str, int]] = []
    for lineno, raw in enumerate(source.splitlines(), 1):
        body = _strip_comment(raw).rstrip()
        if body.strip():
            if "\t" in raw[:len(raw) - len(raw.lstrip())]:
                raise ValueError(f"line {lineno}: tab indentation")
            lines.append((len(body) - len(body.lstrip(" ")), body.strip(),
                          lineno))
    if not lines:
        return None

    def block(i: int, indent: int) -> Tuple[dict, int]:
        out: dict = {}
        while i < len(lines):
            ind, text, lineno = lines[i]
            if ind < indent:
                break
            if ind > indent:
                raise ValueError(f"line {lineno}: unexpected indentation")
            key, sep, rest = text.partition(":")
            if not sep or (rest and not rest.startswith(" ")):
                raise ValueError(f"line {lineno}: expected 'key: value'")
            key = _scalar(key)
            i += 1
            if rest.strip():
                out[key] = _scalar(rest)
            elif i < len(lines) and lines[i][0] > indent:
                out[key], i = block(i, lines[i][0])
            else:
                out[key] = None
        return out, i

    tree, end = block(0, lines[0][0])
    if end != len(lines):
        raise ValueError(f"line {lines[end][2]}: unexpected dedent")
    return tree


def _coerce(value):
    """Literal coercion of a leaf; lists are frozen to tuples."""
    if isinstance(value, str):
        try:
            value = literal_eval(value)
        except (ValueError, SyntaxError):
            return value
    if isinstance(value, list):
        value = tuple(value)
    return value


def _walk_leaves(nested: dict, path: str = "") -> Iterator[Tuple[str, object]]:
    for key, value in nested.items():
        dotted = f"{path}{key}"
        if isinstance(value, dict):
            yield from _walk_leaves(value, f"{dotted}.")
        else:
            yield dotted, _coerce(value)


def flatten(nested: Optional[dict]) -> dict:
    return dict(_walk_leaves(nested)) if nested else {}


def load(fname: str, _depth: int = 0) -> dict:
    """Load and flatten one YAML file, resolving `_base_` inheritance."""
    if _depth > 8:
        raise ValueError(f"config _base_ chain too deep at {fname!r}")
    with open(fname, "r") as fp:
        flat = flatten(parse_yaml(fp.read()))
    base = flat.pop("_base_", None)
    if base is None:
        return flat
    if not isinstance(base, str):
        raise ValueError(f"_base_ in {fname!r} must be a file name")
    config = load(os.path.join(os.path.dirname(os.path.abspath(fname)), base),
                  _depth + 1)
    config.update(flat)
    return config


def merge_from_list(config: Dict, pairs) -> None:
    """Overlay alternating [key, value, key, value, ...] CLI overrides."""
    pairs = list(pairs)
    if len(pairs) % 2:
        raise ValueError("config overrides must come as key value pairs")
    updates = {k: _coerce(v) for k, v in zip(pairs[0::2], pairs[1::2])}
    for key in updates.keys() - config.keys():
        print(f"[Error] unknown config key {key!r} introduced by merge")
    config.update(updates)


def load_config(config_path: Optional[str] = None, opts=None) -> dict:
    """Default config, then a named config file, then CLI pairs."""
    config = load(DEFAULT_CONFIG_FILE) if os.path.exists(
        DEFAULT_CONFIG_FILE) else {}
    if config_path is not None:
        config.update(load(config_path))
    if opts:
        merge_from_list(config, opts)
    return config


def parse_args(parser: argparse.ArgumentParser, argv=None) -> dict:
    """argparse + YAML merge; argparse values fill keys the YAML lacks."""
    args = parser.parse_args(argv)
    config = load_config(getattr(args, "config", None),
                         getattr(args, "opts", None))
    for key, value in vars(args).items():
        config.setdefault(key, value)
    return config
