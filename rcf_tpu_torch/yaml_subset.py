"""The subset of YAML that the recipes use: a reader and a block writer.

The machine with the card has no ``yaml`` package, so the port reads its
configs here. The subset is what ``configs/**/*.yaml`` and ``--opts``
values use:

* block mappings, nested by indentation (spaces), ``# comments``;
* flow sequences and mappings on one line: ``[96, 96]``, ``{}``,
  ``{a: 1, b: [1, 2]}``;
* plain, single-quoted and double-quoted scalars.

Plain scalars resolve as PyYAML's ``SafeLoader`` (YAML 1.1) resolves them:
``null``/``~``/empty to None; ``true``/``yes``/``on`` (and their false
forms, in three cases) to bools; decimal, ``0x``, ``0b``, leading-zero
octal and sexagesimal integers; floats only with a dot (``1.0e-4`` is a
float, ``1e-4`` a string), ``.inf``, ``.nan``. A duplicate key in a
mapping raises. Anything outside the subset (block sequences, block
scalars, anchors, aliases, tags, documents, multi-line flow collections,
timestamps) raises ``YamlError`` naming the file and the line.

``dump(tree)`` writes block YAML that ``load`` reads back to the same tree
(and so does PyYAML): mappings as blocks, lists as flow sequences, strings
double-quoted.
"""

from __future__ import annotations

import json
import math
import re


class YamlError(ValueError):
    pass


_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9_]+(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_TIMESTAMP = re.compile(r"^[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}")
_TRUE = {"yes", "true", "on"}


def _sexagesimal(text: str, conv) -> float | int:
    sign = -1 if text.startswith("-") else 1
    value, base = 0, 1
    for part in reversed(text.lstrip("+-").split(":")):
        value += conv(part) * base
        base *= 60
    return sign * value


def resolve_plain(text: str):
    """A plain scalar's value under YAML 1.1's implicit resolvers (PyYAML's)."""
    if _NULL.match(text):
        return None
    if _BOOL.match(text):
        return text.lower() in _TRUE
    if _INT.match(text):
        t = text.replace("_", "")
        sign = -1 if t.startswith("-") else 1
        body = t.lstrip("+-")
        if ":" in body:
            return _sexagesimal(t, int)
        if body == "0":
            return 0
        if body.startswith("0b"):
            return sign * int(body[2:], 2)
        if body.startswith("0x"):
            return sign * int(body[2:], 16)
        if body.startswith("0"):
            return sign * int(body, 8)
        return sign * int(body)
    if _FLOAT.match(text):
        t = text.replace("_", "").lower()
        if t.lstrip("+-") == ".inf":
            return -math.inf if t.startswith("-") else math.inf
        if t == ".nan":
            return math.nan
        if ":" in t:
            return float(_sexagesimal(t, float))
        return float(t)
    if _TIMESTAMP.match(text):
        raise ValueError(f"timestamp {text!r} is outside the supported subset")
    return text


class _Reader:
    def __init__(self, text: str, name: str):
        self.name = name
        self.lines = []  # (line number, indent, content without comment)
        for no, raw in enumerate(text.splitlines(), 1):
            body = self._strip_comment(raw, no).rstrip()
            if not body.strip():
                continue
            stripped = body.lstrip(" ")
            if stripped.startswith("\t") or "\t" in body[: len(body) - len(stripped)]:
                self.fail(no, "tab in indentation")
            self.lines.append((no, len(body) - len(stripped), stripped))

    def fail(self, line: int, msg: str):
        raise YamlError(f"{self.name}, line {line}: {msg}")

    def _strip_comment(self, raw: str, no: int) -> str:
        quote = None
        for i, ch in enumerate(raw):
            if quote:
                if ch == quote:
                    quote = None
            elif ch in "'\"" and (i == 0 or raw[i - 1] in " \t[{,:"):
                quote = ch
            elif ch == "#" and (i == 0 or raw[i - 1] in " \t"):
                return raw[:i]
        return raw

    # -- block structure ---------------------------------------------------
    def document(self):
        if not self.lines:
            return None
        no, indent, content = self.lines[0]
        if content.startswith(("---", "...", "%")):
            self.fail(no, "documents and directives are outside the supported subset")
        if self._split_key(content, no) is None:
            if len(self.lines) > 1:
                self.fail(self.lines[1][0], "more than one node at the top level")
            return self.inline(content, no)
        tree, i = self.mapping(0, indent)
        if i != len(self.lines):
            self.fail(self.lines[i][0], "bad indentation")
        return tree

    def mapping(self, i: int, indent: int):
        out: dict = {}
        while i < len(self.lines):
            no, ind, content = self.lines[i]
            if ind < indent:
                break
            if ind > indent:
                self.fail(no, "bad indentation")
            split = self._split_key(content, no)
            if split is None:
                self.fail(no, "expected 'key: value'")
            key_text, value_text = split
            key = self.inline(key_text, no, key=True)
            if key in out:
                raise YamlError(f"{self.name}, line {no}: duplicate key {key!r} in YAML mapping")
            i += 1
            if value_text:
                out[key] = self.inline(value_text, no)
            elif i < len(self.lines) and self.lines[i][1] > indent:
                out[key], i = self.mapping(i, self.lines[i][1])
            else:
                out[key] = None
        return out, i

    def _split_key(self, content: str, no: int):
        if content == "-" or content.startswith("- "):
            self.fail(no, "block sequences are outside the supported subset (use [a, b])")
        if content.startswith(("? ", "&", "*", "!", "|", ">")):
            self.fail(no, f"{content[0]!r} is outside the supported subset")
        quote, depth = None, 0
        for i, ch in enumerate(content):
            if quote:
                if ch == quote:
                    quote = None
                continue
            if ch in "'\"" and i == 0:
                quote = ch
            elif ch in "[{":
                depth += 1
            elif ch in "]}":
                depth -= 1
            elif ch == ":" and depth == 0 and (i + 1 == len(content) or content[i + 1] == " "):
                return content[:i].rstrip(), content[i + 1:].strip()
        return None

    # -- inline nodes --------------------------------------------------------
    def inline(self, text: str, no: int, key: bool = False):
        text = text.strip()
        if text[:1] in ("&", "*", "!", "|", ">", "%", "@", "`"):
            self.fail(no, f"{text[0]!r} is outside the supported subset")
        if text.startswith(("[", "{")):
            if key:
                self.fail(no, "collection keys are outside the supported subset")
            value, pos = self.flow(text, 0, no)
            if text[pos:].strip():
                self.fail(no, f"unexpected text after a flow collection: {text[pos:]!r}")
            return value
        if text.startswith(("'", '"')):
            value, pos = self.quoted(text, 0, no)
            if text[pos:].strip():
                self.fail(no, f"unexpected text after a quoted scalar: {text[pos:]!r}")
            return value
        if ": " in text or text.endswith(":"):
            self.fail(no, "mapping values are not allowed here")
        try:
            return resolve_plain(text)
        except ValueError as exc:
            self.fail(no, str(exc))

    def quoted(self, text: str, pos: int, no: int):
        q = text[pos]
        out, i = [], pos + 1
        while i < len(text):
            ch = text[i]
            if q == "'" and ch == "'":
                if text[i + 1:i + 2] == "'":
                    out.append("'")
                    i += 2
                    continue
                return "".join(out), i + 1
            if q == '"' and ch == "\\":
                esc = text[i + 1:i + 2]
                table = {"\\": "\\", '"': '"', "/": "/", "n": "\n", "t": "\t", "r": "\r",
                         "0": "\0", "b": "\b", "f": "\f"}
                if esc in table:
                    out.append(table[esc])
                    i += 2
                    continue
                if esc in ("x", "u", "U"):
                    n = {"x": 2, "u": 4, "U": 8}[esc]
                    out.append(chr(int(text[i + 2:i + 2 + n], 16)))
                    i += 2 + n
                    continue
                self.fail(no, f"unsupported escape \\{esc}")
            if q == '"' and ch == '"':
                return "".join(out), i + 1
            out.append(ch)
            i += 1
        self.fail(no, "unterminated quoted scalar (multi-line scalars are outside the subset)")

    def flow(self, text: str, pos: int, no: int):
        """A flow node at ``pos`` -> (value, position after it)."""
        while pos < len(text) and text[pos] == " ":
            pos += 1
        if pos >= len(text):
            self.fail(no, "unterminated flow collection (multi-line flow is outside the subset)")
        ch = text[pos]
        if ch in "'\"":
            return self.quoted(text, pos, no)
        if ch == "[":
            items, pos = [], pos + 1
            while True:
                pos = self._skip(text, pos, no)
                if text[pos] == "]":
                    return items, pos + 1
                value, pos = self.flow(text, pos, no)
                items.append(value)
                pos = self._skip(text, pos, no)
                if text[pos] == ",":
                    pos += 1
                elif text[pos] != "]":
                    self.fail(no, f"expected ',' or ']' in a flow sequence at {text[pos:]!r}")
        if ch == "{":
            out, pos = {}, pos + 1
            while True:
                pos = self._skip(text, pos, no)
                if text[pos] == "}":
                    return out, pos + 1
                if text[pos] in "'\"":
                    key, pos = self.quoted(text, pos, no)
                else:
                    m = re.match(r"[^:,{}\[\]]+", text[pos:])
                    if not m:
                        self.fail(no, f"bad flow mapping key at {text[pos:]!r}")
                    key = self.inline(m.group(0), no, key=True)
                    pos += m.end()
                pos = self._skip(text, pos, no)
                if text[pos] != ":":
                    self.fail(no, "expected ':' in a flow mapping")
                value, pos = self.flow(text, pos + 1, no)
                if key in out:
                    raise YamlError(f"{self.name}, line {no}: duplicate key {key!r} in YAML mapping")
                out[key] = value
                pos = self._skip(text, pos, no)
                if text[pos] == ",":
                    pos += 1
                elif text[pos] != "}":
                    self.fail(no, f"expected ',' or '}}' in a flow mapping at {text[pos:]!r}")
        m = re.match(r"[^,{}\[\]]*", text[pos:])
        plain = m.group(0).rstrip()
        if ": " in plain:
            self.fail(no, "mapping values are not allowed here")
        return self.inline(plain, no) if plain else None, pos + m.end()

    def _skip(self, text: str, pos: int, no: int) -> int:
        while pos < len(text) and text[pos] == " ":
            pos += 1
        if pos >= len(text):
            self.fail(no, "unterminated flow collection (multi-line flow is outside the subset)")
        return pos


def load(text: str, name: str = "<string>"):
    """The tree of one YAML document in the supported subset."""
    return _Reader(text, name).document()


def load_file(path: str):
    with open(path, "r") as f:
        return load(f.read(), path)


def _scalar(value) -> str:
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
        if "e" in text:  # YAML 1.1 floats need a dot and a signed exponent
            mant, exp = text.split("e")
            if "." not in mant:
                mant += ".0"
            if exp[0] not in "+-":
                exp = "+" + exp
            text = f"{mant}e{exp}"
        return text
    if isinstance(value, str):
        return json.dumps(value)
    if isinstance(value, (list, tuple)):
        return "[" + ", ".join(_scalar(v) for v in value) + "]"
    if isinstance(value, dict):
        return "{" + ", ".join(f"{_scalar(str(k)) if isinstance(k, str) else _scalar(k)}: "
                               f"{_scalar(v)}" for k, v in value.items()) + "}"
    raise TypeError(f"cannot write {type(value).__name__} as YAML")


def _plain_key(key) -> bool:
    if not (isinstance(key, str) and re.fullmatch(r"[A-Za-z_][A-Za-z0-9_.\-]*", key)):
        return False
    try:
        return resolve_plain(key) == key
    except ValueError:
        return False


def dump(tree: dict, indent: int = 0) -> str:
    """Block YAML of a config tree; ``load(dump(t)) == t``."""
    lines = []
    for key, value in tree.items():
        k = key if _plain_key(key) else _scalar(key)
        if isinstance(value, dict) and value:
            lines.append(" " * indent + f"{k}:")
            lines.append(dump(value, indent + 2).rstrip("\n"))
        else:
            lines.append(" " * indent + f"{k}: {_scalar(value)}")
    return "\n".join(lines) + "\n"
