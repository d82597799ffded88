"""The small YAML subset the port reads and writes, without PyYAML.

The v5 model files, the hyperparameter files (``--hyp``, evolve's
``gen{g}-hyp.yaml`` and ``hyp_evolved.yaml``), autoanchor's
``model-autoanchor.yaml`` and v5 data yamls are mappings of top-level
``key: value`` lines, where a value is a scalar, a flow list (``[..]``,
nested, possibly over several lines) or a block list of ``- `` items.
``loads`` reads that subset as ``yaml.safe_load`` reads it; ``dumps``
writes a mapping of scalars and (nested) lists in flow style, which both
read back to the same values (``tests/test_torch_autoanchor_evolve.py``
holds them against PyYAML).
"""

from __future__ import annotations

import math
import re
from typing import Any, Dict, Mapping

_TOKEN = re.compile(r"\s*(\[|\]|,|'(?:[^']|'')*'|\"[^\"]*\"|[^\[\],]+)")


def _scalar(tok: str):
    tok = tok.strip()
    if tok[:1] == "'":
        return tok[1:-1].replace("''", "'")
    if tok[:1] == '"':
        return tok[1:-1]
    if tok in ("true", "True", "TRUE"):
        return True
    if tok in ("false", "False", "FALSE"):
        return False
    if tok in ("null", "Null", "NULL", "~", ""):
        return None
    if tok in (".inf", ".Inf", ".INF", "+.inf"):
        return math.inf
    if tok in ("-.inf", "-.Inf", "-.INF"):
        return -math.inf
    if tok in (".nan", ".NaN", ".NAN"):
        return math.nan
    for cast in (int, float):
        try:
            return cast(tok)
        except ValueError:
            pass
    return tok


def _flow(text: str):
    """A YAML flow value: nested [..] lists of scalars (trailing commas
    allowed)."""
    tokens = [t.strip() for t in _TOKEN.findall(text) if t.strip()]
    pos = 0

    def value():
        nonlocal pos
        tok = tokens[pos]
        pos += 1
        if tok != "[":
            return _scalar(tok)
        items = []
        while tokens[pos] != "]":
            items.append(value())
            if tokens[pos] == ",":
                pos += 1
        pos += 1
        return items

    if not tokens:
        return None
    out = value()
    if pos != len(tokens):
        raise ValueError(f"unparsed yaml value: {text!r}")
    return out


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            quote = None if ch == quote else quote
        elif ch in ("'", '"'):
            quote = ch
        elif ch == "#":
            return line[:i]
    return line


def loads(text: str) -> Dict[str, Any]:
    """The mapping ``text`` holds (see the module docstring)."""
    out: Dict[str, Any] = {}
    key, body = None, []

    def close():
        if key is None:
            return
        items = [ln.strip() for ln in body if ln.strip()]
        if items and items[0].startswith("- "):
            out[key] = [_flow(it[2:]) for it in items]
        else:
            out[key] = _flow(" ".join(items)) if items else None

    for raw in text.splitlines():
        line = _strip_comment(raw).rstrip()
        if not line.strip():
            continue
        if not line[0].isspace() and ":" in line and not line.startswith("-"):
            close()
            key, rest = line.split(":", 1)
            key, body = key.strip(), [rest]
        else:
            body.append(line)
    close()
    return out


def load(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return loads(f.read())


def _format(value) -> str:
    if isinstance(value, (list, tuple)):
        return "[" + ", ".join(_format(v) for v in value) + "]"
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
        # YAML 1.1 (PyYAML) reads an exponent as a float only with a dot
        mant, _, exp = text.partition("e")
        if exp and "." not in mant:
            text = f"{mant}.0e{exp}"
        return text
    if hasattr(value, "item"):                  # numpy scalars
        return _format(value.item())
    return "'" + str(value).replace("'", "''") + "'"


def dumps(mapping: Mapping[str, Any], sort_keys: bool = True) -> str:
    """``mapping`` as ``key: value`` lines, lists in flow style."""
    keys = sorted(mapping) if sort_keys else list(mapping)
    return "".join(f"{k}: {_format(mapping[k])}\n" for k in keys)


def dump(mapping: Mapping[str, Any], path: str,
         sort_keys: bool = True) -> None:
    with open(path, "w") as f:
        f.write(dumps(mapping, sort_keys))
