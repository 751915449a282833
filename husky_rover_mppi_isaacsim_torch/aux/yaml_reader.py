"""A reader of the YAML subset the configuration tree under ``cfg/`` uses,
with the values ``yaml.safe_load`` gives for it. The card's machine has no
PyYAML, so the port reads its configuration with this one code path
everywhere.

The subset: block mappings and block sequences by indentation (a sequence
may sit at its key's indentation, an item may open a mapping: ``- k: v``),
flow mappings and flow sequences (nested, and spanning lines while a bracket
is open), plain, single- and double-quoted scalars, ``#`` comments, and the
YAML 1.1 scalars PyYAML resolves: null (``~``, ``null``, empty), booleans
(``true``/``false``, ``yes``/``no``, ``on``/``off``), integers (decimal,
``0b``, ``0x``, leading-zero octal, ``_`` separators), floats (a dot is
needed, as in PyYAML: ``1e-3`` stays a string; ``.inf``, ``.nan``) and
dates (``2024-05-01``). Anything else (anchors, tags, block scalars,
timestamps with a time, several documents) raises
:class:`YamlSubsetError` rather than being read wrongly.
"""

from __future__ import annotations

import datetime
import re
from pathlib import Path

_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_INT = re.compile(r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
                  r"|[-+]?0x[0-9a-fA-F_]+|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9_]+(?:[eE][-+][0-9]+)?"
                    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
_DATE = re.compile(r"^[0-9]{4}-[0-9]{2}-[0-9]{2}$")
_TIMESTAMP = re.compile(r"^[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}")
_TRUE = ("yes", "true", "on")


class YamlSubsetError(ValueError):
    """The text uses YAML outside the subset this reader knows."""


def _sexagesimal(digits: str, sign: int, cast):
    value, base = 0, 1
    for part in reversed(digits.split(":")):
        value += cast(part) * base
        base *= 60
    return sign * value


def scalar(text: str):
    """A plain scalar as PyYAML's implicit resolvers read it."""
    if _NULL.match(text):
        return None
    if _BOOL.match(text):
        return text.lower() in _TRUE
    if _INT.match(text):
        s = text.replace("_", "")
        sign = -1 if s[0] == "-" else 1
        s = s.lstrip("+-")
        if s.startswith("0b"):
            return sign * int(s[2:], 2)
        if s.startswith("0x"):
            return sign * int(s[2:], 16)
        if ":" in s:
            return _sexagesimal(s, sign, int)
        if s != "0" and s.startswith("0"):
            return sign * int(s, 8)
        return sign * int(s)
    if _FLOAT.match(text):
        s = text.replace("_", "").lower()
        sign = -1.0 if s[0] == "-" else 1.0
        s = s.lstrip("+-")
        if s == ".inf":
            return sign * float("inf")
        if s == ".nan":
            return float("nan")
        if ":" in s:
            return _sexagesimal(s, sign, float)
        return sign * float(s)
    if _DATE.match(text):
        return datetime.date(*(int(v) for v in text.split("-")))
    if _TIMESTAMP.match(text) or text[0] in "&*!|>%@`":
        raise YamlSubsetError(f"unsupported YAML construct: {text!r}")
    return text


def _strip_comment(line: str) -> str:
    """``line`` without a ``#`` comment (one at the start or after a space,
    outside quotes)."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"" and (i == 0 or line[i - 1] in " \t[{,:-"):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


class _Flow:
    """Recursive descent over one flow node (``[...]``, ``{...}``, a quoted
    or plain scalar)."""

    def __init__(self, text: str):
        self.s, self.i = text, 0

    def _ws(self):
        while self.i < len(self.s) and self.s[self.i] in " \t":
            self.i += 1

    def node(self, stops: str):
        self._ws()
        if self.i >= len(self.s):
            return None
        ch = self.s[self.i]
        if ch == "[":
            return self._seq()
        if ch == "{":
            return self._map()
        if ch in "'\"":
            return self._quoted()
        start = self.i
        while self.i < len(self.s):
            c = self.s[self.i]
            if c in stops and (c != ":" or self.i + 1 >= len(self.s)
                               or self.s[self.i + 1] in " \t,]}"):
                break
            self.i += 1
        return scalar(self.s[start:self.i].strip())

    def _quoted(self):
        q, self.i = self.s[self.i], self.i + 1
        out = []
        while True:
            if self.i >= len(self.s):
                raise YamlSubsetError(f"unterminated quote in {self.s!r}")
            c = self.s[self.i]
            if q == "'" and c == "'" and self.s[self.i + 1:self.i + 2] == "'":
                out.append("'")
                self.i += 2
            elif c == q:
                self.i += 1
                return "".join(out)
            elif q == '"' and c == "\\":
                esc = self.s[self.i + 1:self.i + 2]
                out.append({"n": "\n", "t": "\t", '"': '"', "\\": "\\", "/": "/"}.get(esc))
                if out[-1] is None:
                    raise YamlSubsetError(f"unsupported escape \\{esc} in {self.s!r}")
                self.i += 2
            else:
                out.append(c)
                self.i += 1

    def _expect(self, chars: str) -> str:
        self._ws()
        if self.i >= len(self.s) or self.s[self.i] not in chars:
            raise YamlSubsetError(f"expected one of {chars!r} at {self.i} in {self.s!r}")
        self.i += 1
        return self.s[self.i - 1]

    def _seq(self):
        self.i += 1
        out = []
        self._ws()
        if self.s[self.i:self.i + 1] == "]":
            self.i += 1
            return out
        while True:
            out.append(self.node(",]"))
            if self._expect(",]") == "]":
                return out
            self._ws()
            if self.s[self.i:self.i + 1] == "]":  # a trailing comma
                self.i += 1
                return out

    def _map(self):
        self.i += 1
        out = {}
        self._ws()
        if self.s[self.i:self.i + 1] == "}":
            self.i += 1
            return out
        while True:
            key = self.node(":,}")
            self._ws()
            value = None
            if self.s[self.i:self.i + 1] == ":":
                self.i += 1
                value = self.node(",}")
            out[key] = value
            if self._expect(",}") == "}":
                return out
            self._ws()
            if self.s[self.i:self.i + 1] == "}":
                self.i += 1
                return out

    def whole(self):
        value = self.node("")
        self._ws()
        if self.i != len(self.s):
            raise YamlSubsetError(f"text after the node in {self.s!r}")
        return value


def _flow(text: str):
    return _Flow(text).whole()


def _depth(text: str) -> int:
    """Open flow brackets at the end of ``text`` (outside quotes)."""
    depth, quote = 0, None
    for ch in text:
        if quote:
            quote = None if ch == quote else quote
        elif ch in "'\"":
            quote = ch
        elif ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
    return depth


def _lines(text: str) -> list[tuple[int, str]]:
    """``(indent, content)`` of each line that holds content, comments
    removed, a flow collection that spans lines joined into one."""
    out: list[tuple[int, str]] = []
    pending = None
    for raw in text.splitlines():
        if raw.strip() in ("---", "...") and pending is None:
            if out:
                raise YamlSubsetError("several documents in one text")
            continue
        if "\t" in raw[:len(raw) - len(raw.lstrip())]:
            raise YamlSubsetError("tab in indentation")
        line = _strip_comment(raw).rstrip()
        if not line.strip():
            continue
        if pending is not None:
            pending = (pending[0], pending[1] + " " + line.strip())
        else:
            pending = (len(line) - len(line.lstrip(" ")), line.strip())
        if _depth(pending[1]) <= 0:
            out.append(pending)
            pending = None
    if pending is not None:
        raise YamlSubsetError(f"unclosed flow collection: {pending[1]!r}")
    return out


def _split_key(content: str):
    """``(key, rest)`` of a ``key: rest`` line, or ``None``."""
    quote = None
    depth = 0
    for i, ch in enumerate(content):
        if quote:
            quote = None if ch == quote else quote
        elif ch in "'\"" and i == 0:
            quote = ch
        elif ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
        elif ch == ":" and depth == 0 and (i + 1 == len(content) or content[i + 1] in " \t"):
            key = content[:i].strip()
            return (_flow(key) if key[:1] in "'\"" else scalar(key)), content[i + 1:].strip()
    return None


class _Block:
    def __init__(self, lines):
        self.lines = lines
        self.i = 0

    def node(self, indent: int):
        """The block node whose lines start at the current line, at
        ``indent``."""
        ind, content = self.lines[self.i]
        if content == "-" or content.startswith("- "):
            return self._seq(ind)
        if _split_key(content) is not None:
            return self._map(ind)
        self.i += 1
        return _flow(content)

    def _value(self, indent: int, rest: str, seq_at_indent: bool):
        """The value after ``key:`` or ``-``: inline, or the block below."""
        if rest:
            return _flow(rest)
        if self.i < len(self.lines):
            ind, content = self.lines[self.i]
            is_item = content == "-" or content.startswith("- ")
            if ind > indent or (seq_at_indent and ind == indent and is_item):
                return self.node(ind)
        return None

    def _map(self, indent: int) -> dict:
        out = {}
        while self.i < len(self.lines):
            ind, content = self.lines[self.i]
            if ind < indent:
                break
            if ind > indent:
                raise YamlSubsetError(f"bad indentation at {content!r}")
            kv = _split_key(content)
            if kv is None:
                if content == "-" or content.startswith("- "):
                    break
                raise YamlSubsetError(f"expected 'key: value', got {content!r}")
            self.i += 1
            out[kv[0]] = self._value(indent, kv[1], True)
        return out

    def _seq(self, indent: int) -> list:
        out = []
        while self.i < len(self.lines):
            ind, content = self.lines[self.i]
            if ind != indent or not (content == "-" or content.startswith("- ")):
                if ind > indent:
                    raise YamlSubsetError(f"bad indentation at {content!r}")
                break
            rest = content[1:].strip()
            item_indent = ind + len(content) - len(rest) if rest else ind + 2
            if rest and (rest.startswith("- ") or rest == "-" or _split_key(rest) is not None):
                # the item opens a block on its own line: read it at its column
                self.lines[self.i] = (item_indent, rest)
                out.append(self.node(item_indent))
            else:
                self.i += 1
                out.append(self._value(indent, rest, False))
        return out


def loads(text: str):
    """The value of one YAML document in the subset (``None`` when empty)."""
    lines = _lines(text)
    if not lines:
        return None
    block = _Block(lines)
    value = block.node(lines[0][0])
    if block.i != len(lines):
        raise YamlSubsetError(f"unexpected line {lines[block.i][1]!r}")
    return value


def load(path) -> object:
    """:func:`loads` of a file."""
    return loads(Path(path).read_text())
