"""Config system: YAML + CLI-dotlist merged attribute-dicts (port of
nr3d_lib_tpu/config.py).

  * ``ConfigDict`` — a dict with attribute access, wrapped recursively.
  * ``load_config(path)`` — YAML load, with ``_base_`` includes.
  * ``merge_dotlist(cfg, ["a.b.c=1", ...])`` — CLI overrides.
  * ``BaseConfig.parse()`` — CLI dotlist > argparse > ``--config`` yaml >
    base yaml, and ``--resume_dir`` to reload a persisted config.
  * ``${eval:...}`` and ``${import:...}`` string resolvers.
  * ``instantiate(cfg)`` — build ``cfg.target(**cfg.param)``; a target in
    the JAX package (``nr3d_lib_tpu.``) names the class at the same path
    in this package.

YAML is read and written by this module's own reader and writer, which
cover the YAML the repository's configs use: comments, block maps and
lists, flow maps and lists (also across lines), plain, single- and
double-quoted and null scalars. Plain scalars resolve by YAML 1.1's
rules, as PyYAML's ``safe_load`` resolves them: ``5.0e-3`` is a float
but ``1e-3`` (no dot) a string, ``yes``/``no``/``on``/``off`` are bools,
``~`` is null, ``0x1F`` and ``017`` are ints. What the reader does not
cover (anchors, tags, block scalars, multi-line plain scalars,
timestamps, merge keys) raises ``ValueError``.
"""

from __future__ import annotations

import argparse
import copy
import math
import os
import re
from numbers import Number
from typing import Any, List, Optional, Sequence, Tuple, Union

import numpy as np

from nr3d_lib_tpu_torch.utils import import_str

__all__ = ["ConfigDict", "load_config", "save_config", "merge_dicts",
           "merge_dotlist", "parse_value", "resolve", "instantiate",
           "BaseConfig", "parse_device_ids", "yaml_load", "yaml_dump"]


# ========================================================== the YAML reader
_BOOL_RE = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False"
                      r"|FALSE|on|On|ON|off|Off|OFF)$")
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FLOAT_RE = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                       r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                       r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*"
                       r"|[-+]?\.(?:inf|Inf|INF)"
                       r"|\.(?:nan|NaN|NAN))$")
_INT_RE = re.compile(r"^(?:[-+]?0b[0-1_]+"
                     r"|[-+]?0[0-7_]+"
                     r"|[-+]?(?:0|[1-9][0-9_]*)"
                     r"|[-+]?0x[0-9a-fA-F_]+"
                     r"|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$")
_NULL_RE = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP_RE = re.compile(r"^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]"
                           r"|[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?"
                           r"(?:[Tt]|[ \t]+)[0-9][0-9]?:[0-9][0-9]:[0-9][0-9]"
                           r"(?:\.[0-9]*)?(?:[ \t]*(?:Z|[-+][0-9][0-9]?"
                           r"(?::[0-9][0-9])?))?)$")
_ESCAPES = {"0": "\0", "a": "\x07", "b": "\x08", "t": "\t", "\t": "\t",
            "n": "\n", "v": "\x0b", "f": "\x0c", "r": "\r", "e": "\x1b",
            " ": " ", '"': '"', "\\": "\\", "/": "/", "N": "\x85",
            "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_ESCAPE_CODES = {"x": 2, "u": 4, "U": 8}


def _sexagesimal(text: str, conv) -> Any:
    value = 0
    for part in text.split(":"):
        value = value * 60 + conv(part)
    return value


def _resolve_plain(text: str) -> Any:
    """A plain scalar → the value PyYAML's SafeLoader gives it."""
    if _NULL_RE.match(text):
        return None
    if _BOOL_RE.match(text):
        return text in _TRUE
    if _FLOAT_RE.match(text):
        v = text.replace("_", "").lower()
        sign = -1.0 if v[0] == "-" else 1.0
        if v[0] in "+-":
            v = v[1:]
        if v == ".inf":
            return sign * math.inf
        if v == ".nan":
            return math.nan
        if ":" in v:
            return sign * _sexagesimal(v, float)
        return sign * float(v)
    if _INT_RE.match(text):
        v = text.replace("_", "")
        sign = -1 if v[0] == "-" else 1
        if v[0] in "+-":
            v = v[1:]
        if v == "0":
            return 0
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if v[0] == "0":
            return sign * int(v, 8)
        if ":" in v:
            return sign * _sexagesimal(v, int)
        return sign * int(v)
    if _TIMESTAMP_RE.match(text):
        raise ValueError(f"YAML timestamps are not read: {text!r}")
    if text in ("<<", "="):
        raise ValueError(f"YAML merge and value keys are not read: {text!r}")
    return text


class _Line:
    __slots__ = ("indent", "text", "no")

    def __init__(self, indent: int, text: str, no: int):
        self.indent, self.text, self.no = indent, text, no


def _strip_comment(line: str) -> str:
    """The line without its comment: a `#` at the start or after
    whitespace, outside quotes (a quote opens only where a scalar starts)."""
    quote, prev = None, " "
    i = 0
    while i < len(line):
        ch = line[i]
        if quote == "'":
            if ch == "'":
                if i + 1 < len(line) and line[i + 1] == "'":
                    i += 1
                else:
                    quote = None
        elif quote == '"':
            if ch == "\\":
                i += 1
            elif ch == '"':
                quote = None
        elif ch == "#" and prev in " \t":
            return line[:i]
        elif ch in "'\"" and prev in " \t:-[{,":
            quote = ch
        prev = ch
        i += 1
    return line


def _quoted(s: str, pos: int) -> Tuple[str, int]:
    """The quoted scalar starting at s[pos] → (value, position after)."""
    q, i, out = s[pos], pos + 1, []
    while i < len(s):
        ch = s[i]
        if q == "'":
            if ch == "'":
                if i + 1 < len(s) and s[i + 1] == "'":
                    out.append("'")
                    i += 2
                    continue
                return "".join(out), i + 1
            out.append(ch)
        else:
            if ch == '"':
                return "".join(out), i + 1
            if ch == "\\":
                i += 1
                e = s[i] if i < len(s) else ""
                if e in _ESCAPES:
                    out.append(_ESCAPES[e])
                elif e in _ESCAPE_CODES:
                    n = _ESCAPE_CODES[e]
                    out.append(chr(int(s[i + 1:i + 1 + n], 16)))
                    i += n
                else:
                    raise ValueError(f"YAML: unknown escape \\{e}")
            else:
                out.append(ch)
        i += 1
    raise ValueError("YAML: a quoted scalar is not closed on its line")


def _skip_ws(s: str, pos: int) -> int:
    while pos < len(s) and s[pos] in " \t":
        pos += 1
    return pos


def _flow_node(s: str, pos: int) -> Tuple[Any, int]:
    """A node in flow context at s[pos] → (value, position after)."""
    pos = _skip_ws(s, pos)
    if pos >= len(s):
        raise ValueError("YAML: a flow collection ends early")
    ch = s[pos]
    if ch == "[":
        out, pos = [], pos + 1
        while True:
            pos = _skip_ws(s, pos)
            if pos < len(s) and s[pos] == "]":
                return out, pos + 1
            value, pos = _flow_node(s, pos)
            pos = _skip_ws(s, pos)
            if pos < len(s) and s[pos] == ":":
                raise ValueError("YAML: pairs inside a flow list are not read")
            out.append(value)
            if pos < len(s) and s[pos] == ",":
                pos += 1
            elif pos >= len(s) or s[pos] != "]":
                raise ValueError("YAML: expected ',' or ']' in a flow list")
    if ch == "{":
        out, pos = {}, pos + 1
        while True:
            pos = _skip_ws(s, pos)
            if pos < len(s) and s[pos] == "}":
                return out, pos + 1
            key, pos = _flow_node(s, pos)
            pos = _skip_ws(s, pos)
            value = None
            if pos < len(s) and s[pos] == ":":
                pos = _skip_ws(s, pos + 1)
                if pos < len(s) and s[pos] not in ",}":
                    value, pos = _flow_node(s, pos)
                    pos = _skip_ws(s, pos)
            out[_hashable(key)] = value
            if pos < len(s) and s[pos] == ",":
                pos += 1
            elif pos >= len(s) or s[pos] != "}":
                raise ValueError("YAML: expected ',' or '}' in a flow map")
    if ch in "'\"":
        return _quoted(s, pos)
    if ch in "&*!|>%@`":
        raise ValueError(f"YAML: {ch!r} (anchors, tags, block scalars) is "
                         "not read")
    end = pos
    while end < len(s):
        c = s[end]
        if c in ",[]{}":
            break
        if c == ":" and (end + 1 == len(s) or s[end + 1] in " \t,[]{}"):
            break
        end += 1
    return _resolve_plain(s[pos:end].strip()), end


def _hashable(key):
    if isinstance(key, (list, dict)):
        raise ValueError("YAML: a collection as a map key is not read")
    return key


def _split_key(text: str) -> Optional[Tuple[Any, str]]:
    """A block map entry `key: rest` → (key, rest), or None if the text is
    no map entry."""
    if text[0] in "'\"":
        key, pos = _quoted(text, 0)
        pos = _skip_ws(text, pos)
        if pos < len(text) and text[pos] == ":" and \
                (pos + 1 == len(text) or text[pos + 1] in " \t"):
            return key, text[pos + 1:].strip()
        return None
    if text[0] in "[{":
        return None
    m = re.search(r":(?:[ \t]|$)", text)
    if m is None:
        return None
    return _hashable(_resolve_plain(text[:m.start()].strip())), \
        text[m.end():].strip()


def _is_seq_item(text: str) -> bool:
    return text == "-" or text.startswith(("- ", "-\t"))


class _BlockParser:
    def __init__(self, text: str):
        self.lines: List[_Line] = []
        for no, raw in enumerate(text.splitlines(), 1):
            body = _strip_comment(raw).rstrip()
            stripped = body.lstrip(" ")
            if not stripped:
                continue
            if stripped[0] == "\t":
                raise ValueError(f"YAML line {no}: a tab in the indentation")
            if body in ("---", "...") or body.startswith(("--- ", "%")):
                if self.lines:
                    raise ValueError(f"YAML line {no}: one document only")
                continue
            self.lines.append(_Line(len(body) - len(stripped), stripped, no))

    def parse(self) -> Any:
        if not self.lines:
            return None
        value, i = self.node(0, self.lines[0].indent)
        if i != len(self.lines):
            raise ValueError(f"YAML line {self.lines[i].no}: unexpected "
                             "indentation")
        return value

    def node(self, i: int, indent: int) -> Tuple[Any, int]:
        text = self.lines[i].text
        if _is_seq_item(text):
            return self.seq(i, indent)
        if _split_key(text) is not None:
            return self.map(i, indent)
        return self.inline(text, i)

    def child(self, i: int, indent: int, seq_ok: bool) -> Tuple[Any, int]:
        """The value of an entry whose text ends at line i - 1: a block
        node on the following, deeper lines (or a sequence at the same
        indentation, after a map key), else null."""
        if i < len(self.lines):
            nxt = self.lines[i]
            if nxt.indent > indent or (seq_ok and nxt.indent == indent
                                       and _is_seq_item(nxt.text)):
                return self.node(i, nxt.indent)
        return None, i

    def map(self, i: int, indent: int) -> Tuple[dict, int]:
        out = {}
        while i < len(self.lines) and self.lines[i].indent == indent:
            line = self.lines[i]
            if _is_seq_item(line.text):
                break
            kv = _split_key(line.text)
            if kv is None:
                raise ValueError(f"YAML line {line.no}: expected 'key: "
                                 f"value', got {line.text!r}")
            key, rest = kv
            if rest:
                value, i = self.inline(rest, i)
            else:
                value, i = self.child(i + 1, indent, seq_ok=True)
            out[key] = value
        return out, i

    def seq(self, i: int, indent: int) -> Tuple[list, int]:
        out = []
        while i < len(self.lines) and self.lines[i].indent == indent and \
                _is_seq_item(self.lines[i].text):
            line = self.lines[i]
            rest = line.text[1:].lstrip(" \t")
            if not rest:
                value, i = self.child(i + 1, indent, seq_ok=False)
            elif _is_seq_item(rest) or _split_key(rest) is not None:
                # a nested node opens on the item's own line
                self.lines[i] = _Line(indent + len(line.text) - len(rest),
                                      rest, line.no)
                value, i = self.node(i, self.lines[i].indent)
            else:
                value, i = self.inline(rest, i)
            out.append(value)
        return out, i

    def inline(self, text: str, i: int) -> Tuple[Any, int]:
        """A scalar or flow collection that starts on line i (a flow
        collection may go on over the following lines)."""
        no, indent = self.lines[i].no, self.lines[i].indent
        if text[0] in "[{":
            parts, depth = [text], _depth(text)
            while depth > 0:
                i += 1
                if i >= len(self.lines):
                    raise ValueError(f"YAML line {no}: a flow collection is "
                                     "not closed")
                parts.append(self.lines[i].text)
                depth += _depth(self.lines[i].text)
            s = " ".join(parts)
            value, pos = _flow_node(s, 0)
        elif text[0] in "'\"":
            value, pos = _quoted(text, 0)
            s = text
        elif text[0] in "&*!|>%@`":
            raise ValueError(f"YAML line {no}: {text[0]!r} (anchors, tags, "
                             "block scalars) is not read")
        elif _is_seq_item(text) or re.search(r":(?:[ \t]|$)", text):
            raise ValueError(f"YAML line {no}: a sequence entry or a map "
                             f"entry is not allowed here: {text!r}")
        else:
            value, s, pos = _resolve_plain(text), text, len(text)
        if s[pos:].strip():
            raise ValueError(f"YAML line {no}: unexpected text {s[pos:]!r}")
        i += 1
        if i < len(self.lines) and self.lines[i].indent > indent:
            raise ValueError(f"YAML line {self.lines[i].no}: multi-line "
                             "plain scalars are not read")
        return value, i


def _depth(text: str) -> int:
    """Brackets opened minus closed on a line, outside quotes."""
    depth, i, quote = 0, 0, None
    while i < len(text):
        ch = text[i]
        if quote:
            if ch == "\\" and quote == '"':
                i += 1
            elif ch == quote:
                quote = None
        elif ch in "'\"" and (i == 0 or text[i - 1] in " \t[{,:"):
            quote = ch
        elif ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
        i += 1
    return depth


def yaml_load(text: str) -> Any:
    """YAML text → Python values, as PyYAML's ``safe_load`` reads the
    subset this module covers (see the module's docstring)."""
    return _BlockParser(text).parse()


# ========================================================== the YAML writer
_PLAIN_SAFE = re.compile(r"^[A-Za-z_./$][A-Za-z0-9_./$+-]*$")
_PRINTABLE = re.compile("[\x20-\x7e\xa0-\ud7ff\ue000-\ufffd"
                        "\U00010000-\U0010ffff]")


def _dq(s: str) -> str:
    out = []
    for ch in s:
        if ch in '"\\':
            out.append("\\" + ch)
        elif _PRINTABLE.match(ch):
            out.append(ch)
        elif ord(ch) < 0x10000:
            out.append(f"\\u{ord(ch):04x}")
        else:
            out.append(f"\\U{ord(ch):08x}")
    return '"' + "".join(out) + '"'


def _scalar(v) -> str:
    if isinstance(v, np.generic):
        v = v.item()
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if v != v:
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        r = repr(v)
        if "e" in r:
            mant, exp = r.split("e")
            r = (mant if "." in mant else mant + ".0") + "e" + exp
        return r
    if isinstance(v, str):
        if _PLAIN_SAFE.match(v) and _resolve_plain(v) == v:
            return v
        return _dq(v)
    raise TypeError(f"YAML: cannot write a {type(v).__name__}")


def _emit(v, indent: int) -> List[str]:
    pad = " " * indent
    lines = []
    if isinstance(v, dict):
        for k, x in v.items():
            key = _scalar(k)
            if isinstance(x, (dict, list, tuple)) and len(x):
                lines.append(f"{pad}{key}:")
                lines += _emit(x, indent + 2)
            else:
                lines.append(f"{pad}{key}: {_inline(x)}")
    else:
        for x in v:
            if isinstance(x, (dict, list, tuple)) and len(x):
                sub = _emit(x, indent + 2)
                lines.append(f"{pad}- {sub[0][indent + 2:]}")
                lines += sub[1:]
            else:
                lines.append(f"{pad}- {_inline(x)}")
    return lines


def _inline(v) -> str:
    if isinstance(v, dict):
        return "{}"
    if isinstance(v, (list, tuple)):
        return "[]"
    return _scalar(v)


def yaml_dump(value) -> str:
    """Block-style YAML for dicts, lists and scalars that this module's
    reader and PyYAML's ``safe_load`` both read back to `value`."""
    if isinstance(value, (dict, list, tuple)) and len(value):
        return "\n".join(_emit(value, 0)) + "\n"
    return _inline(value) + "\n"


# ============================================================== the configs
class ConfigDict(dict):
    """A dict with attribute access; nested dicts are wrapped recursively."""

    def __init__(self, *args, **kwargs):
        super().__init__()
        for arg in args:
            if arg is None:
                continue
            if isinstance(arg, dict):
                for k, v in arg.items():
                    self[k] = v
            else:
                for k, v in arg:
                    self[k] = v
        for k, v in kwargs.items():
            self[k] = v

    @staticmethod
    def _wrap(value):
        if isinstance(value, ConfigDict):
            return value
        if isinstance(value, dict):
            return ConfigDict(value)
        if isinstance(value, (list, tuple)):
            return type(value)(ConfigDict._wrap(v) for v in value)
        return value

    def __setitem__(self, key, value):
        super().__setitem__(key, ConfigDict._wrap(value))

    def __setattr__(self, name, value):
        self[name] = value

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __delattr__(self, name):
        try:
            del self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __deepcopy__(self, memo):
        out = ConfigDict()
        memo[id(self)] = out
        for k, v in self.items():
            dict.__setitem__(out, copy.deepcopy(k, memo),
                             copy.deepcopy(v, memo))
        return out

    def copy(self) -> "ConfigDict":
        return copy.deepcopy(self)

    def deepcopy(self) -> "ConfigDict":
        return copy.deepcopy(self)

    def to_dict(self) -> dict:
        def un(v):
            if isinstance(v, dict):
                return {k: un(x) for k, x in v.items()}
            if isinstance(v, (list, tuple)):
                return [un(x) for x in v]
            return v

        return un(self)

    def setdefault(self, key, default=None):
        if key not in self:
            self[key] = default
        return self[key]


def merge_dicts(base: dict, override: dict,
                allow_new: bool = True) -> ConfigDict:
    """Recursively merge ``override`` into a deep copy of ``base``."""
    out = ConfigDict(copy.deepcopy(dict(base)))
    for k, v in override.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = merge_dicts(out[k], v, allow_new=allow_new)
        else:
            if not allow_new and k not in out:
                raise KeyError(f"Unknown config key: {k}")
            out[k] = copy.deepcopy(v)
    return out


def parse_value(text: str) -> Any:
    """A CLI value string with YAML's meaning ('1' → int, 'true' → bool);
    text that is no YAML stays text."""
    try:
        return yaml_load(text)
    except ValueError:
        return text


def merge_dotlist(cfg: dict, dotlist: Sequence[str]) -> ConfigDict:
    """Apply ``a.b.c=value`` overrides (creates intermediate dicts)."""
    out = ConfigDict(copy.deepcopy(dict(cfg)))
    for item in dotlist:
        if "=" not in item:
            raise ValueError(f"Dotlist item must look like key=value, got: "
                             f"{item!r}")
        key, value = item.split("=", 1)
        node = out
        parts = key.split(".")
        for p in parts[:-1]:
            if p not in node or not isinstance(node[p], dict):
                node[p] = ConfigDict()
            node = node[p]
        node[parts[-1]] = parse_value(value)
    return out


_RESOLVER_RE = re.compile(r"^\$\{(eval|import):(.*)\}$", re.DOTALL)
_JAX_PACKAGE = "nr3d_lib_tpu."


def _port_path(path: str) -> str:
    """A dotted path into the JAX package → the same path in the port."""
    if path.startswith(_JAX_PACKAGE):
        return "nr3d_lib_tpu_torch." + path[len(_JAX_PACKAGE):]
    return path


def resolve(cfg: Any) -> Any:
    """Resolve ``${eval:...}`` / ``${import:...}`` strings recursively."""
    if isinstance(cfg, dict):
        return ConfigDict({k: resolve(v) for k, v in cfg.items()})
    if isinstance(cfg, (list, tuple)):
        return type(cfg)(resolve(v) for v in cfg)
    if isinstance(cfg, str):
        m = _RESOLVER_RE.match(cfg.strip())
        if m is not None:
            kind, expr = m.group(1), m.group(2)
            if kind == "eval":
                return eval(expr, {"math": math, "np": np})
            return import_str(_port_path(expr.strip()))
    return cfg


def load_config(path: Union[str, os.PathLike],
                resolve_exprs: bool = True) -> ConfigDict:
    """Load a YAML config; a top-level ``_base_`` key includes parent
    yaml(s), relative to the file."""
    with open(path, "r") as f:
        raw = yaml_load(f.read()) or {}
    base_paths = raw.pop("_base_", None)
    cfg = ConfigDict(raw)
    if base_paths is not None:
        if isinstance(base_paths, str):
            base_paths = [base_paths]
        merged = ConfigDict()
        for bp in base_paths:
            bp_abs = bp if os.path.isabs(bp) else \
                os.path.join(os.path.dirname(str(path)), bp)
            merged = merge_dicts(merged, load_config(bp_abs,
                                                     resolve_exprs=False))
        cfg = merge_dicts(merged, cfg)
    if resolve_exprs:
        cfg = resolve(cfg)
    return cfg


def instantiate(cfg: dict, **overrides):
    """Build an object from ``{"target": "pkg.mod.Class", "param": {...}}``;
    ``overrides`` (a seed, ``device``) are merged over ``param``. A target
    in the JAX package is built from this package's class at the same
    path."""
    cfg = ConfigDict(cfg)
    target = import_str(_port_path(cfg["target"]))
    param = ConfigDict(cfg.get("param", {})).to_dict()
    param.update(overrides)
    return target(**param)


def save_config(cfg: dict, path: Union[str, os.PathLike]):
    with open(path, "w") as f:
        f.write(yaml_dump(ConfigDict(cfg).to_dict()))


def parse_device_ids(value: Union[str, int, Sequence[int], None]
                     ) -> List[int]:
    """'0', '0,1,2', [0,1] → a list of device ordinals."""
    if value is None:
        return [0]
    if isinstance(value, Number):
        return [int(value)]
    if isinstance(value, str):
        return [int(v) for v in value.replace(" ", "").split(",") if v != ""]
    return [int(v) for v in value]


class BaseConfig:
    """CLI + YAML config parser.

    Priority (highest first): CLI dotlist > argparse flags > ``--config``
    yaml. ``--resume_dir`` re-reads the persisted ``config.yaml`` of an
    earlier run.
    """

    def __init__(self, parser: Optional[argparse.ArgumentParser] = None):
        self.parser = parser or argparse.ArgumentParser(add_help=True)
        self.parser.add_argument("--config", type=str, default=None,
                                 help="Path to YAML config.")
        self.parser.add_argument(
            "--resume_dir", type=str, default=None,
            help="Experiment dir to resume; reloads its config.yaml.")
        self.parser.add_argument("--device_ids", type=str, default="0")

    def parse(self, argv: Optional[Sequence[str]] = None,
              print_config: bool = False) -> ConfigDict:
        args, unknown = self.parser.parse_known_args(argv)
        dotlist = [u for u in unknown if "=" in u and not u.startswith("--")]

        cfg = ConfigDict()
        if args.resume_dir is not None:
            persisted = os.path.join(args.resume_dir, "config.yaml")
            if os.path.exists(persisted):
                cfg = load_config(persisted)
            cfg.training = cfg.get("training", ConfigDict())
            cfg.exp_dir = args.resume_dir
        elif args.config is not None:
            cfg = load_config(args.config)

        for k, v in vars(args).items():
            if k in ("config", "resume_dir") or v is None:
                continue
            if k == "device_ids":
                cfg[k] = parse_device_ids(v)
            else:
                cfg.setdefault(k, v)

        cfg = merge_dotlist(cfg, dotlist)
        cfg = resolve(cfg)
        if print_config:
            print(yaml_dump(cfg.to_dict()))
        return cfg
