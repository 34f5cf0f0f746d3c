"""The artifact store's sidecar logs: the subset of YAML they use.

A log is a YAML stream of block mappings: md5 -> a mapping of the
artifact's attributes, whose values are scalars (str, int, float, bool,
None; timestamps are strings) or lists of scalars.  :func:`dump` writes
one entry as text that PyYAML's ``safe_load`` reads back as the same
dict (every string and key double-quoted, so none resolves to another
type); :func:`load_all` reads that subset as PyYAML's
``safe_dump(..., sort_keys=False)`` writes it, as the JAX package's logs
hold it: several top-level keys in one document, ``---`` between
documents, block mappings and block lists, plain, single- and
double-quoted scalars, long strings folded over lines, ``[]`` and ``{}``.
Scalars resolve as PyYAML's ``SafeLoader`` resolves them (YAML 1.1:
``yes``/``off`` are bools, ``0o``-less octal, ``1_000``, ``.inf``).
Anything else (anchors, aliases, tags, block scalars, flow collections
with items, a plain timestamp, ``<<``) raises :class:`StoreLogError`
with its name.
"""

from __future__ import annotations

import math
import re

__all__ = ["StoreLogError", "dump", "load_all"]


class StoreLogError(ValueError):
    """Text outside the YAML subset of the store's logs."""


# ------------------------------------------------------------------ writing


def _quote(text: str) -> str:
    out = ['"']
    for ch in text:
        code = ord(ch)
        if ch in '"\\':
            out.append("\\" + ch)
        elif 0x20 <= code <= 0x7E or (0xA0 <= code <= 0xD7FF and code not in (0x2028, 0x2029)) \
                or 0xE000 <= code <= 0xFFFD and code != 0xFEFF or 0x10000 <= code <= 0x10FFFF:
            out.append(ch)
        elif code <= 0xFF:
            out.append(f"\\x{code:02X}")
        elif code <= 0xFFFF:
            out.append(f"\\u{code:04X}")
        else:
            out.append(f"\\U{code:08X}")
    out.append('"')
    return "".join(out)


def _scalar_text(value) -> str:
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
        text = repr(value).lower()
        return text.replace("e", ".0e", 1) if "." not in text and "e" in text else text
    if isinstance(value, str):
        return _quote(value)
    raise StoreLogError(f"a store log holds no value of type {type(value).__name__}")


def _dump_mapping(mapping: dict, indent: int, out: list[str]) -> None:
    pad = " " * indent
    for key, value in mapping.items():
        head = f"{pad}{_scalar_text(key)}:"
        if isinstance(value, dict):
            if value:
                out.append(head)
                _dump_mapping(value, indent + 2, out)
            else:
                out.append(head + " {}")
        elif isinstance(value, (list, tuple)):
            if value:
                out.append(head)
                for item in value:
                    if isinstance(item, (dict, list, tuple)):
                        raise StoreLogError("a store log's lists hold scalars only")
                    out.append(f"{pad}- {_scalar_text(item)}")
            else:
                out.append(head + " []")
        else:
            out.append(f"{head} {_scalar_text(value)}")


def dump(mapping: dict) -> str:
    """``mapping`` as block YAML text (a log entry: md5 -> attributes)."""
    out: list[str] = []
    _dump_mapping(mapping, 0, out)
    return "".join(line + "\n" for line in out)


# ------------------------------------------------------------------ reading

_BOOL = {"yes": True, "true": True, "on": True, "no": False, "false": False, "off": False}
_BOOL_RE = re.compile(r"yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE|on|On|ON|off|Off|OFF")
_FLOAT_RE = re.compile(r"""[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
    |[-+]?\.(?:inf|Inf|INF)
    |\.(?:nan|NaN|NAN)""", re.X)
_INT_RE = re.compile(r"""[-+]?0b[0-1_]+
    |[-+]?0[0-7_]+
    |[-+]?(?:0|[1-9][0-9_]*)
    |[-+]?0x[0-9a-fA-F_]+
    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+""", re.X)
_NULL_RE = re.compile(r"~|null|Null|NULL|")
_TIMESTAMP_RE = re.compile(r"""[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
    |[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?
     (?:[Tt]|[ \t]+)[0-9][0-9]?
     :[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?
     (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?""", re.X)
_ESCAPES = {"0": "\0", "a": "\x07", "b": "\x08", "t": "\t", "\t": "\t", "n": "\n", "v": "\x0b",
            "f": "\x0c", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\",
            "N": "\x85", "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


def _sexagesimal(text: str) -> float:
    total = 0.0
    for part in text.split(":"):
        total = total * 60 + float(part)
    return total


def _resolve(text: str):
    """A plain scalar's value, as PyYAML's SafeLoader resolves it."""
    if _NULL_RE.fullmatch(text):
        return None
    if _BOOL_RE.fullmatch(text):
        return _BOOL[text.lower()]
    if _INT_RE.fullmatch(text):
        value, sign = text.replace("_", ""), 1
        if value[0] in "+-":
            sign, value = (-1 if value[0] == "-" else 1), value[1:]
        if value == "0":
            return 0
        if value.startswith("0b"):
            return sign * int(value[2:], 2)
        if value.startswith("0x"):
            return sign * int(value[2:], 16)
        if value[0] == "0":
            return sign * int(value, 8)
        if ":" in value:
            return sign * int(_sexagesimal(value))
        return sign * int(value)
    if _FLOAT_RE.fullmatch(text):
        value, sign = text.replace("_", "").lower(), 1.0
        if value[0] in "+-":
            sign, value = (-1.0 if value[0] == "-" else 1.0), value[1:]
        if value == ".inf":
            return sign * math.inf
        if value == ".nan":
            return math.nan
        return sign * (_sexagesimal(value) if ":" in value else float(value))
    if _TIMESTAMP_RE.fullmatch(text):
        raise StoreLogError(f"plain timestamp scalar {text!r} (a store log quotes its times)")
    if text in ("<<", "="):
        raise StoreLogError(f"merge or value key {text!r}")
    return text


class _Parser:
    """Recursive descent over the text: block mappings, block lists of
    scalars, and scalars."""

    def __init__(self, text: str):
        self.s = text.replace("\r\n", "\n")
        self.i = 0

    def fail(self, what: str):
        line = self.s.count("\n", 0, self.i) + 1
        raise StoreLogError(f"{what} (line {line})")

    # ---- lines

    def eof(self) -> bool:
        return self.i >= len(self.s)

    def column(self) -> int:
        return self.i - (self.s.rfind("\n", 0, self.i) + 1)

    def skip_space(self) -> None:
        while self.i < len(self.s) and self.s[self.i] == " ":
            self.i += 1

    def next_line(self) -> None:
        """Move to the first column of the next line holding content
        (blank and comment lines skipped), or to the end."""
        while True:
            end = self.s.find("\n", self.i)
            self.i = len(self.s) if end < 0 else end + 1
            if self.eof() or not self._blank_here():
                return

    def _blank_here(self) -> bool:
        j = self.i
        while j < len(self.s) and self.s[j] in " \t":
            j += 1
        return j >= len(self.s) or self.s[j] in "\n#"

    def at_line_content(self) -> None:
        """At the start of a line: skip blank lines and the indent."""
        if not self.eof() and self._blank_here():
            self.next_line()
        self.skip_space()
        if not self.eof() and self.s[self.i] == "\t":
            self.fail("a tab in indentation")

    def marker(self) -> str | None:
        if self.column() == 0 and self.s.startswith(("---", "..."), self.i):
            j = self.i + 3
            if j >= len(self.s) or self.s[j] in " \n":
                return self.s[self.i:j]
        return None

    # ---- documents

    def documents(self) -> list:
        docs = []
        while True:
            self.at_line_content()
            if self.eof():
                return docs
            mark = self.marker()
            if mark:
                self.i += 3
                self.skip_space()
                if not self.eof() and self.s[self.i] not in "\n#":
                    self.fail("content on a document marker line")
                self.next_line()
                if mark == "---":
                    self.at_line_content()
                    if self.eof() or self.marker():
                        docs.append(None)
                continue
            if self.column() != 0:
                self.fail("a document that does not start at column 0")
            docs.append(self.block_node(-1))

    # ---- nodes

    def block_node(self, parent: int, in_mapping: bool = False):
        """The node whose first line is the current one (content at the
        current column, > parent, or == parent for a list in a mapping)."""
        col = self.column()
        ch = self.s[self.i]
        if ch == "-" and self.s[self.i + 1:self.i + 2] in (" ", "\n", ""):
            if col < parent or col == parent and not in_mapping:
                self.fail("a list item out of its indentation")
            return self.block_list(col)
        if col <= parent:
            self.fail("a node indented no deeper than its parent")
        self.check_node_start()
        start = self.i
        key = self.scalar(col - 1, key=True)
        if self.s.startswith(":", self.i) and self.s[self.i + 1:self.i + 2] in (" ", "\n", ""):
            self.i = start
            return self.block_mapping(col)
        self.i = start
        value = self.scalar(parent, key=False)
        self.end_of_line()
        return value

    def check_node_start(self) -> None:
        ch = self.s[self.i]
        names = {"&": "anchor", "*": "alias", "!": "tag", "|": "literal block scalar",
                 ">": "folded block scalar", "?": "complex mapping key", "%": "directive",
                 "@": "reserved indicator", "`": "reserved indicator"}
        if ch in names:
            self.fail(f"{names[ch]} ({ch!r})")
        if ch in "[{":
            close = "]" if ch == "[" else "}"
            j = self.i + 1
            while j < len(self.s) and self.s[j] == " ":
                j += 1
            if not self.s.startswith(close, j):
                self.fail("a flow collection with items")

    def end_of_line(self) -> None:
        self.skip_space()
        if not self.eof() and self.s[self.i] not in "\n#":
            self.fail(f"unexpected {self.s[self.i]!r} after a value")
        self.next_line()

    def block_mapping(self, col: int) -> dict:
        out: dict = {}
        while True:
            self.check_node_start()
            key = self.scalar(col - 1, key=True)
            if not (self.s.startswith(":", self.i) and self.s[self.i + 1:self.i + 2] in (" ", "\n", "")):
                self.fail("a mapping key without ': '")
            self.i += 1
            self.skip_space()
            if self.eof() or self.s[self.i] in "\n#":
                self.next_line()
                self.at_line_content()
                if self.eof() or self.marker() or self.column() < col or (
                        self.column() == col and not self.s.startswith(("- ", "-\n"), self.i)):
                    value = None
                else:
                    value = self.block_node(col, in_mapping=True)
            else:
                self.check_node_start()
                if self.s[self.i] == "-" and self.s[self.i + 1:self.i + 2] in (" ", "\n", ""):
                    self.fail("a list item on its key's line")
                value = self.scalar(col, key=False)
                self.end_of_line()
            if isinstance(key, (list, dict)):
                self.fail("a collection as a mapping key")
            out[key] = value
            self.at_line_content()
            if self.eof() or self.marker() or self.column() < col:
                return out
            if self.column() > col:
                self.fail("a mapping entry indented deeper than its mapping")

    def block_list(self, col: int) -> list:
        out = []
        while True:
            self.i += 1
            self.skip_space()
            if self.eof() or self.s[self.i] in "\n#":
                self.fail("a list item that is not a scalar on its line")
            if self.s[self.i] == "-" and self.s[self.i + 1:self.i + 2] in (" ", "\n", ""):
                self.fail("a nested list (a store log's lists hold scalars)")
            self.check_node_start()
            start = self.i
            self.scalar(col, key=True)
            if self.s.startswith(":", self.i) and self.s[self.i + 1:self.i + 2] in (" ", "\n", ""):
                self.fail("a mapping in a list (a store log's lists hold scalars)")
            self.i = start
            out.append(self.scalar(col, key=False))
            self.end_of_line()
            self.at_line_content()
            if self.eof() or self.marker() or self.column() < col or not (
                    self.s.startswith("-", self.i)
                    and self.s[self.i + 1:self.i + 2] in (" ", "\n", "")):
                if not self.eof() and not self.marker() and self.column() > col:
                    self.fail("a line indented into a list")
                return out

    # ---- scalars

    def scalar(self, parent: int, key: bool):
        """A scalar at the current position: quoted, ``[]``/``{}``, or
        plain (over several lines, indented deeper than ``parent``)."""
        ch = self.s[self.i]
        if ch == '"':
            return self.double_quoted()
        if ch == "'":
            return self.single_quoted()
        if ch in "[{":
            self.check_node_start()
            self.i = self.s.index("]" if ch == "[" else "}", self.i) + 1
            return [] if ch == "[" else {}
        return _resolve(self.plain(parent, key))

    def plain(self, parent: int, key: bool) -> str:
        s, parts = self.s, []
        while True:
            j = self.i
            while j < len(s) and s[j] != "\n":
                if s[j] == ":" and (j + 1 >= len(s) or s[j + 1] in " \n"):
                    break
                if s[j] == "#" and j > self.i and s[j - 1] in " \t":
                    break
                j += 1
            parts.append(s[self.i:j].rstrip(" \t"))
            self.i = j
            if key or j >= len(s) or s[j] != "\n":
                break
            # a continuation line: deeper than the parent, not a marker
            k, breaks = j, 0
            while k < len(s) and s[k] == "\n":
                breaks += 1
                k += 1
                while k < len(s) and s[k] in " \t":
                    k += 1
            line_start = s.rfind("\n", 0, k) + 1
            indent = len(s[line_start:k]) - len(s[line_start:k].lstrip(" "))
            if k >= len(s) or indent <= parent or s[k] == "#" or (
                    indent == 0 and s.startswith(("---", "..."), k)):
                break
            parts.append("\n" * (breaks - 1) if breaks > 1 else " ")
            self.i = k
        text = "".join(parts)
        if ": " in text:
            self.fail("a mapping value inside a plain scalar")
        return text

    def _fold(self, quote: str) -> str:
        """At a line break inside a quoted scalar: the text it folds to."""
        s, breaks = self.s, 0
        while self.i < len(s) and s[self.i] in " \t\n":
            if s[self.i] == "\n":
                breaks += 1
            self.i += 1
        if self.i >= len(s):
            self.fail(f"an unterminated {quote} scalar")
        if self.column() == 0 and s.startswith(("---", "..."), self.i):
            self.fail(f"a document marker inside a {quote} scalar")
        return "\n" * (breaks - 1) if breaks > 1 else " "

    def single_quoted(self) -> str:
        s, out = self.s, []
        self.i += 1
        while True:
            if self.i >= len(s):
                self.fail("an unterminated single-quoted scalar")
            ch = s[self.i]
            if ch == "'":
                if s[self.i + 1:self.i + 2] == "'":
                    out.append("'")
                    self.i += 2
                    continue
                self.i += 1
                return "".join(out)
            if ch in " \t" or ch == "\n":
                j = self.i
                while j < len(s) and s[j] in " \t":
                    j += 1
                if j < len(s) and s[j] == "\n":
                    self.i = j
                    out.append(self._fold("single-quoted"))
                else:
                    out.append(s[self.i:j])
                    self.i = j
                continue
            out.append(ch)
            self.i += 1

    def double_quoted(self) -> str:
        s, out = self.s, []
        self.i += 1
        while True:
            if self.i >= len(s):
                self.fail("an unterminated double-quoted scalar")
            ch = s[self.i]
            if ch == '"':
                self.i += 1
                return "".join(out)
            if ch == "\\":
                nxt = s[self.i + 1:self.i + 2]
                if nxt in _ESCAPES:
                    out.append(_ESCAPES[nxt])
                    self.i += 2
                elif nxt in _HEX_ESCAPES:
                    width = _HEX_ESCAPES[nxt]
                    digits = s[self.i + 2:self.i + 2 + width]
                    if len(digits) != width or not all(c in "0123456789abcdefABCDEF" for c in digits):
                        self.fail(f"a bad \\{nxt} escape")
                    out.append(chr(int(digits, 16)))
                    self.i += 2 + width
                elif nxt == "\n":  # an escaped line break: the lines join
                    self.i += 2
                    while self.i < len(s) and s[self.i] in " \t\n":
                        if s[self.i] == "\n":
                            out.append("\n")
                        self.i += 1
                else:
                    self.fail(f"an unknown escape \\{nxt}")
                continue
            if ch in " \t" or ch == "\n":
                j = self.i
                while j < len(s) and s[j] in " \t":
                    j += 1
                if j < len(s) and s[j] == "\n":
                    self.i = j
                    out.append(self._fold("double-quoted"))
                else:
                    out.append(s[self.i:j])
                    self.i = j
                continue
            out.append(ch)
            self.i += 1


def load_all(text: str) -> list:
    """The documents of a log's text (as PyYAML's ``safe_load_all``)."""
    if text.startswith("\ufeff"):
        text = text[1:]
    return _Parser(text).documents()
