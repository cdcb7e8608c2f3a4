"""A reader for the YAML subset of the recipe files, without PyYAML.

The card's machine has no PyYAML, so the port reads its configs with this
module alone. It returns what ``yaml.safe_load`` (YAML 1.1) returns on the
subset below, the resolver's quirks included (a plain ``1e-3`` has no dot
and is a string; ``1.0e5`` has no exponent sign and is a string too;
``yes``/``on`` are booleans; ``010`` is octal), and raises ``YAMLSubsetError``
on anything outside it rather than read it otherwise:

* block mappings by indentation (spaces only), their values on the same
  line or as a nested block, and block sequences of ``- item`` entries
  (also at the key's own indentation);
* flow sequences ``[...]`` and flow mappings ``{...}``, nested, on one line
  or over several (the JSON that ``Config.dump`` writes);
* plain, single-quoted and double-quoted scalars on one line; plain ints,
  floats, booleans and nulls resolved as PyYAML's resolver does;
* comments (``#`` at the start of a line or after whitespace).

``safe_load`` returns the document; ``config.py`` reads every recipe
through it.

Outside it (raises): anchors, aliases, tags, block scalars (``|``, ``>``),
documents and directives (``---``, ``...``, ``%``), complex keys (``?``),
compact mappings in sequence entries (``- a: 1``), multi-line plain or
quoted scalars, timestamps, merge keys, tabs in indentation, and a ``:``
inside a plain scalar of a flow collection.
"""

from __future__ import annotations

import re
from typing import Any, List, Tuple


class YAMLSubsetError(ValueError):
    """Input outside the subset (or not YAML)."""


# PyYAML's implicit resolvers (yaml/resolver.py), tried in this order
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False"
                   r"|FALSE|on|On|ON|off|Off|OFF)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9_]+(?:[eE][-+][0-9]+)?"
                    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*"
                    r"|[-+]?\.(?:inf|Inf|INF)"
                    r"|\.(?:nan|NaN|NAN))$")
_INT = re.compile(r"^(?:[-+]?0b[0-1_]+"
                  r"|[-+]?0[0-7_]+"
                  r"|[-+]?(?:0|[1-9][0-9_]*)"
                  r"|[-+]?0x[0-9a-fA-F_]+"
                  r"|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$")
_MERGE = re.compile(r"^(?:<<)$")
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP = re.compile(r"^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]"
                        r"|[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?"
                        r"(?:[Tt]|[ \t]+)[0-9][0-9]?"
                        r":[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?"
                        r"(?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$")
_VALUE = re.compile(r"^(?:=)$")

_BOOL_VALUES = {"yes": True, "no": False, "true": True, "false": False,
                "on": True, "off": False}
# characters that may not start a plain scalar here
_BAD_START = set("&*!|>%@`?")
_ESCAPES = {"0": "\0", "a": "\x07", "b": "\x08", "t": "\t", "\t": "\t",
            "n": "\n", "v": "\x0b", "f": "\x0c", "r": "\r", "e": "\x1b",
            " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
            "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


def _sexagesimal(text: str, conv) -> Any:
    sign = 1
    if text[0] in "+-":
        sign = -1 if text[0] == "-" else 1
        text = text[1:]
    value, base = 0, 1
    for part in reversed(text.split(":")):
        value += conv(part) * base
        base *= 60
    return sign * value


def _int(text: str) -> int:
    v = text.replace("_", "")
    sign = 1
    if v[0] in "+-":
        sign = -1 if v[0] == "-" else 1
        v = v[1:]
    if v == "0":
        return 0
    if v.startswith("0b"):
        return sign * int(v[2:], 2)
    if v.startswith("0x"):
        return sign * int(v[2:], 16)
    if ":" in v:
        return sign * _sexagesimal(v, int)
    if v[0] == "0":
        return sign * int(v, 8)
    return sign * int(v)


def _float(text: str) -> float:
    v = text.replace("_", "").lower()
    sign = 1.0
    if v[0] in "+-":
        sign = -1.0 if v[0] == "-" else 1.0
        v = v[1:]
    if v == ".inf":
        return sign * float("inf")
    if v == ".nan":
        return float("nan")
    if ":" in v:
        return sign * _sexagesimal(v, float)
    return sign * float(v)


def resolve_plain(text: str) -> Any:
    """A plain scalar's value, as PyYAML's SafeLoader resolves it."""
    if _BOOL.match(text):
        return _BOOL_VALUES[text.lower()]
    if _FLOAT.match(text):
        return _float(text)
    if _INT.match(text):
        return _int(text)
    if _MERGE.match(text) or _VALUE.match(text):
        raise YAMLSubsetError(f"the plain scalar {text!r} (a merge key or "
                              "a value key) is outside the subset")
    if _NULL.match(text):
        return None
    if _TIMESTAMP.match(text):
        raise YAMLSubsetError(f"the timestamp {text!r} is outside the "
                              "subset")
    return text


class _Source:
    """The text, its lines and a position in it."""

    def __init__(self, text: str):
        if text.startswith("\ufeff"):
            text = text[1:]
        self.lines = text.split("\n")

    def where(self, row: int) -> str:
        return f"line {row + 1}"


def _quoted(line: str, col: int, row: int, src: _Source) -> Tuple[str, int]:
    """The quoted scalar starting at line[col]; returns (value, index after
    its closing quote). One line only."""
    quote = line[col]
    out: List[str] = []
    i = col + 1
    while True:
        if i >= len(line):
            raise YAMLSubsetError(
                f"{src.where(row)}: a quoted scalar over several lines is "
                "outside the subset")
        ch = line[i]
        if quote == "'":
            if ch == "'":
                if i + 1 < len(line) and line[i + 1] == "'":
                    out.append("'")
                    i += 2
                    continue
                return "".join(out), i + 1
            out.append(ch)
            i += 1
            continue
        if ch == '"':
            return "".join(out), i + 1
        if ch == "\\":
            if i + 1 >= len(line):
                raise YAMLSubsetError(
                    f"{src.where(row)}: an escaped line break is outside "
                    "the subset")
            esc = line[i + 1]
            if esc in _ESCAPES:
                out.append(_ESCAPES[esc])
                i += 2
                continue
            if esc in _HEX_ESCAPES:
                n = _HEX_ESCAPES[esc]
                digits = line[i + 2:i + 2 + n]
                if len(digits) != n or not all(
                        c in "0123456789abcdefABCDEF" for c in digits):
                    raise YAMLSubsetError(
                        f"{src.where(row)}: a bad \\{esc} escape")
                out.append(chr(int(digits, 16)))
                i += 2 + n
                continue
            raise YAMLSubsetError(f"{src.where(row)}: unknown escape "
                                  f"\\{esc}")
        out.append(ch)
        i += 1


def _is_comment_start(line: str, i: int) -> bool:
    return line[i] == "#" and (i == 0 or line[i - 1] in " \t")


def _rest_is_blank(line: str, i: int) -> bool:
    """Only whitespace and perhaps a comment from line[i] on."""
    while i < len(line):
        if _is_comment_start(line, i):
            return True
        if line[i] not in " \t":
            return False
        i += 1
    return True


class _Flow:
    """A flow collection over one or more lines, from (row, col)."""

    def __init__(self, src: _Source, row: int, col: int):
        self.src, self.row, self.col = src, row, col

    @property
    def line(self) -> str:
        return self.src.lines[self.row]

    def error(self, msg: str):
        raise YAMLSubsetError(f"{self.src.where(self.row)}: {msg}")

    def skip(self) -> None:
        """Skip whitespace, line breaks and comments."""
        while True:
            if self.row >= len(self.src.lines):
                self.error("an unclosed flow collection")
            line = self.line
            while self.col < len(line) and line[self.col] in " \t":
                self.col += 1
            if self.col < len(line) and not _is_comment_start(line,
                                                               self.col):
                return
            self.row += 1
            self.col = 0

    def peek(self) -> str:
        self.skip()
        return self.line[self.col]

    def node(self):
        ch = self.peek()
        if ch == "[":
            return self.sequence()
        if ch == "{":
            return self.mapping()
        if ch in "'\"":
            value, self.col = _quoted(self.line, self.col, self.row,
                                      self.src)
            return value
        return self.plain()

    def plain(self):
        line, start = self.line, self.col
        ch = line[start]
        if ch in _BAD_START or ch in ",]}:" or (
                ch == "-" and (start + 1 >= len(line)
                               or line[start + 1] in " \t,[]{}")):
            self.error(f"a plain scalar starting with {ch!r} is outside "
                       "the subset")
        i = start
        while i < len(line) and line[i] not in ",[]{}":
            if line[i] == ":":
                if i + 1 == len(line) or line[i + 1] in " \t,[]{}":
                    break  # the value indicator after a key
                self.error("a ':' inside a plain scalar of a flow "
                           "collection is outside the subset")
            if _is_comment_start(line, i):
                break
            i += 1
        text = line[start:i].rstrip(" \t")
        self.col = start + len(text)
        if _rest_is_blank(line, self.col) and self.row + 1 < len(
                self.src.lines):
            # the next token must not continue the scalar on the next line
            save = (self.row, self.col)
            self.row, self.col = self.row + 1, 0
            nxt = self.peek()
            self.row, self.col = save
            if nxt not in ",]}:":
                self.error("a plain scalar over several lines is outside "
                           "the subset")
        return resolve_plain(text)

    def sequence(self) -> list:
        self.col += 1  # "["
        out = []
        while True:
            if self.peek() == "]":
                self.col += 1
                return out
            out.append(self.node())
            ch = self.peek()
            if ch == ",":
                self.col += 1
            elif ch != "]":
                self.error(f"expected ',' or ']' in a flow sequence, got "
                           f"{ch!r}")

    def mapping(self) -> dict:
        self.col += 1  # "{"
        out = {}
        while True:
            if self.peek() == "}":
                self.col += 1
                return out
            ch = self.peek()
            if ch in "[{":
                self.error("a flow collection as a key is outside the "
                           "subset")
            key = self.node()
            if self.peek() != ":":
                self.error("a flow mapping entry without ':' is outside "
                           "the subset")
            self.col += 1
            ch = self.peek()
            if ch in ",}":
                value = None
            else:
                value = self.node()
            out[key] = value
            ch = self.peek()
            if ch == ",":
                self.col += 1
            elif ch != "}":
                self.error(f"expected ',' or '}}' in a flow mapping, got "
                           f"{ch!r}")


class _Block:
    """The block structure: lines by indentation."""

    def __init__(self, text: str):
        self.src = _Source(text)
        self.row = 0

    def error(self, msg: str, row=None):
        raise YAMLSubsetError(
            f"{self.src.where(self.row if row is None else row)}: {msg}")

    def next_content(self):
        """(row, indent) of the next line with content from self.row on,
        or None; rejects tabs in indentation and document markers."""
        while self.row < len(self.src.lines):
            line = self.src.lines[self.row]
            stripped = line.lstrip(" ")
            indent = len(line) - len(stripped)
            if stripped.startswith("\t") and stripped.strip(" \t"):
                self.error("a tab in the indentation is outside the subset")
            body = stripped.rstrip(" \t\r")
            if body and not body.startswith("#"):
                if indent == 0 and (body.startswith(("---", "..."))
                                    or body.startswith("%")):
                    self.error("documents and directives (---, ..., %) are "
                               "outside the subset")
                if line.endswith("\r"):
                    self.src.lines[self.row] = line.rstrip("\r")
                return self.row, indent
            self.row += 1
        return None

    def document(self):
        nxt = self.next_content()
        if nxt is None:
            return None
        value = self.node(nxt[1])
        if self.next_content() is not None:
            self.error("content after the document's top node")
        return value

    def _entry_key(self, line: str, col: int):
        """(key, index after ': ') where line[col:] is a block mapping
        entry, else None."""
        ch = line[col]
        if ch in "'\"":
            key, i = _quoted(line, col, self.row, self.src)
            while i < len(line) and line[i] in " \t":
                i += 1
            if i < len(line) and line[i] == ":" and (
                    i + 1 == len(line) or line[i + 1] in " \t"):
                return key, i + 1
            return None
        if ch in "[{":
            return None
        i = col
        while i < len(line):
            if _is_comment_start(line, i):
                return None
            if line[i] == ":" and (i + 1 == len(line)
                                   or line[i + 1] in " \t"):
                text = line[col:i].rstrip(" \t")
                if text[:1] in _BAD_START or text.startswith("- "):
                    self.error(f"the key {text!r} is outside the subset")
                return resolve_plain(text), i + 1
            i += 1
        return None

    @staticmethod
    def _is_seq_entry(line: str, col: int) -> bool:
        return line[col] == "-" and (col + 1 == len(line)
                                     or line[col + 1] in " \t")

    def node(self, indent: int):
        row, _ = self.next_content()
        line = self.src.lines[row]
        if self._is_seq_entry(line, indent):
            return self.sequence(indent)
        if self._entry_key(line, indent) is not None:
            return self.mapping(indent)
        value, self.row = self.inline(row, indent)
        return value

    def child(self, indent: int, allow_sequence: bool):
        """The value of an entry whose text ended at its line: a nested
        block (deeper than ``indent``, or a sequence at ``indent`` where
        ``allow_sequence``), else null."""
        nxt = self.next_content()
        if nxt is None:
            return None
        row, ind = nxt
        if ind > indent:
            return self.node(ind)
        if (ind == indent and allow_sequence
                and self._is_seq_entry(self.src.lines[row], ind)):
            return self.sequence(ind)
        return None

    def mapping(self, indent: int) -> dict:
        out = {}
        while True:
            nxt = self.next_content()
            if nxt is None or nxt[1] < indent:
                return out
            row, ind = nxt
            line = self.src.lines[row]
            if ind > indent:
                self.error("unexpected indentation")
            entry = self._entry_key(line, indent)
            if entry is None:
                self.error("expected a 'key: value' entry")
            key, col = entry
            if _rest_is_blank(line, col):
                self.row = row + 1
                value = self.child(indent, allow_sequence=True)
            else:
                value, self.row = self.inline(row, col)
            try:
                out[key] = value
            except TypeError:
                self.error(f"the key {key!r} is outside the subset")

    def sequence(self, indent: int) -> list:
        out = []
        while True:
            nxt = self.next_content()
            if nxt is None or nxt[1] < indent:
                return out
            row, ind = nxt
            line = self.src.lines[row]
            if ind > indent:
                self.error("unexpected indentation")
            if not self._is_seq_entry(line, indent):
                return out if out else self.error("expected '- '")
            col = indent + 1
            if _rest_is_blank(line, col):
                self.row = row + 1
                out.append(self.child(indent, allow_sequence=False))
                continue
            while line[col] in " \t":
                col += 1
            if self._is_seq_entry(line, col) or self._entry_key(
                    line, col) is not None:
                self.error("a compact collection in a sequence entry "
                           "('- a: 1', '- - a') is outside the subset")
            value, self.row = self.inline(row, col)
            out.append(value)

    def inline(self, row: int, col: int):
        """The value that starts at (row, col) after its key or '- ':
        (value, the row after it). A flow collection may run over several
        lines; anything else ends on its line."""
        line = self.src.lines[row]
        while line[col] in " \t":
            col += 1
        ch = line[col]
        if ch in "[{":
            flow = _Flow(self.src, row, col)
            value = flow.node()
            if not _rest_is_blank(flow.line, flow.col):
                self.error("content after a flow collection", flow.row)
            return value, flow.row + 1
        if ch in "'\"":
            value, end = _quoted(line, col, row, self.src)
            if not _rest_is_blank(line, end):
                self.error("content after a quoted scalar", row)
            self._no_continuation(row)
            return value, row + 1
        if ch in _BAD_START or (ch == "-" and (col + 1 == len(line)
                                               or line[col + 1] in " \t")):
            self.error(f"a value starting with {ch!r} is outside the "
                       "subset", row)
        end = col
        while end < len(line) and not _is_comment_start(line, end):
            if line[end] == ":" and (end + 1 == len(line)
                                     or line[end + 1] in " \t"):
                self.error("a ': ' inside a plain scalar", row)
            end += 1
        text = line[col:end].rstrip(" \t")
        self._no_continuation(row)
        return resolve_plain(text), row + 1

    def _no_continuation(self, row: int) -> None:
        """A scalar ends on its line: the next line with content may not
        be indented under it as its continuation."""
        save = self.row
        self.row = row + 1
        nxt = self.next_content()
        self.row = save
        if nxt is None:
            return
        line = self.src.lines[row]
        own = len(line) - len(line.lstrip(" "))
        nrow, ind = nxt
        if ind > own and not (
                self._is_seq_entry(self.src.lines[nrow], ind)
                or self._entry_key(self.src.lines[nrow], ind) is not None):
            self.error("a scalar over several lines is outside the subset",
                       nrow)


def safe_load(text: str) -> Any:
    """The document in ``text``, as ``yaml.safe_load`` reads it; raises
    ``YAMLSubsetError`` outside the subset."""
    return _Block(text).document()
