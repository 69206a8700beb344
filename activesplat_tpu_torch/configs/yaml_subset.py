"""A reader for the subset of YAML that the Habitat env configs use, in plain
Python (the machine with the card has no PyYAML).

The subset:
  * block mappings, comments and blank lines;
  * block sequences, indented under their key or not (as `yaml.safe_dump`
    writes them); an item is a scalar or a one-pair mapping written on the
    item's line (`- /habitat: habitat_config_base`);
  * flow sequences of scalars (`[0, 1.25, 0]`);
  * scalars: decimal ints, decimal floats with a point, `true`/`false` in
    YAML's three spellings, single- and double-quoted strings without
    escapes, and plain strings.

Each scalar resolves as `yaml.safe_load` resolves it (so `"v1"` and `v1`
are strings, `0.065` a float, `90` an int). Anything else raises
`YamlSubsetError` with its line: anchors, aliases, tags, block and
multi-line scalars, flow mappings, tabs, document markers, nulls, duplicate
keys, YAML 1.1's other booleans (yes/no/on/off) and number-like plain
scalars that are not decimal (`1e5`, `0x1f`, `1_000`, dates, `.inf`),
rather than guess what a fuller reader would make of them.
"""

from __future__ import annotations

import re
from typing import Any, List, Tuple

_INT = re.compile(r"[-+]?(0|[1-9][0-9]*)")
_FLOAT = re.compile(r"[-+]?([0-9]+\.[0-9]*|\.[0-9]+)([eE][-+][0-9]+)?")
_BOOLS = {"true": True, "True": True, "TRUE": True,
          "false": False, "False": False, "FALSE": False}
# what YAML 1.1 would read as a null or a boolean other than true/false
_REFUSED_WORDS = {"~", "null", "Null", "NULL", "yes", "Yes", "YES", "no", "No", "NO",
                  "on", "On", "ON", "off", "Off", "OFF", "=", "<<"}
_REFUSED_STARTS = "&*!|>%@`{]},?"


class YamlSubsetError(ValueError):
    pass


def _fail(lineno: int, why: str):
    raise YamlSubsetError(f"line {lineno}: {why} (outside the YAML subset this reader takes)")


def _quoted(text: str, lineno: int) -> Tuple[str, str]:
    """(the string, the text after its closing quote) of a quoted scalar."""
    quote = text[0]
    i, out = 1, []
    while True:
        j = text.find(quote, i)
        if j < 0:
            _fail(lineno, "an unterminated or multi-line quoted scalar")
        out.append(text[i:j])
        if quote == "'" and text[j + 1:j + 2] == "'":  # '' is one quote
            out.append("'")
            i = j + 2
            continue
        body = "".join(out)
        if quote == '"' and "\\" in body:
            _fail(lineno, "an escape in a double-quoted scalar")
        return body, text[j + 1:]


def _after_value(rest: str, lineno: int) -> None:
    rest = rest.strip()
    if rest and not rest.startswith("#"):
        _fail(lineno, f"text {rest!r} after a value")


def _strip_comment(text: str) -> str:
    """A plain scalar's text up to a comment (` #`)."""
    cut = text.find(" #")
    return (text if cut < 0 else text[:cut]).rstrip()


def _plain(text: str, lineno: int) -> Any:
    if text in _BOOLS:
        return _BOOLS[text]
    if _INT.fullmatch(text):
        return int(text)
    if _FLOAT.fullmatch(text):
        return float(text)
    if text in _REFUSED_WORDS:
        _fail(lineno, f"the scalar {text!r}")
    if text[0] in _REFUSED_STARTS or text[0] in "-:" and text[1:2] in ("", " "):
        _fail(lineno, f"the scalar {text!r}")
    if (text[0].isdigit() or (text[0] in "+-." and text[1:2].isdigit())
            or re.fullmatch(r"[-+]?\.(inf|Inf|INF|nan|NaN|NAN)", text)):
        _fail(lineno, f"the number-like scalar {text!r}")
    if ": " in text or text.endswith(":"):
        _fail(lineno, f"a mapping inside the scalar {text!r}")
    return text


def _scalar(text: str, lineno: int) -> Any:
    """One scalar with nothing after it (inside a flow sequence)."""
    if not text:
        _fail(lineno, "an empty item in a flow sequence")
    if text[0] in "'\"":
        value, rest = _quoted(text, lineno)
        if rest.strip():
            _fail(lineno, f"text {rest!r} after a quoted scalar")
        return value
    if text[0] in "[#":
        _fail(lineno, f"the item {text!r} in a flow sequence")
    return _plain(text, lineno)


def _value(text: str, lineno: int) -> Any:
    """An inline value, with a comment after it or not."""
    if text[0] in "'\"":
        value, rest = _quoted(text, lineno)
        _after_value(rest, lineno)
        return value
    if text[0] == "[":
        end = text.find("]")
        if end < 0:
            _fail(lineno, "a flow sequence that ends on a later line")
        body = text[1:end]
        if "[" in body or "{" in body:
            _fail(lineno, "a nested flow collection")
        _after_value(text[end + 1:], lineno)
        if not body.strip():
            return []
        return [_scalar(item.strip(), lineno) for item in body.split(",")]
    return _plain(_strip_comment(text), lineno)


def _split_key(content: str, lineno: int):
    """(key, the text after `key:`) of a mapping entry, or None where the
    line holds no `key:`."""
    if content[0] in "'\"":
        key, rest = _quoted(content, lineno)
        if not rest.startswith(":") or rest[1:2] not in ("", " "):
            return None
        return key, rest[1:].strip()
    for m in re.finditer(r":( |$)", content):
        key = content[:m.start()]
        if " #" in key:
            return None
        if not key or key[0] in _REFUSED_STARTS + "[#":
            _fail(lineno, f"the key {key!r}")
        if key in _BOOLS or key in _REFUSED_WORDS or _INT.fullmatch(key) or _FLOAT.fullmatch(key):
            _fail(lineno, f"the non-string key {key!r}")
        return key, content[m.end():].strip()
    return None


def _is_item(content: str) -> bool:
    return content == "-" or content.startswith("- ")


class _Reader:
    def __init__(self, text: str) -> None:
        self.lines: List[Tuple[int, int, str]] = []  # (line number, indent, content)
        for lineno, raw in enumerate(text.splitlines(), 1):
            if "\t" in raw:
                _fail(lineno, "a tab")
            content = raw.strip()
            if not content or content.startswith("#"):
                continue
            if content.startswith(("---", "...", "%")):
                _fail(lineno, "a document marker or directive")
            self.lines.append((lineno, len(raw) - len(raw.lstrip(" ")), content))

    def deeper(self, idx: int, indent: int) -> bool:
        return idx < len(self.lines) and self.lines[idx][1] > indent

    def node(self, idx: int, indent: int):
        if _is_item(self.lines[idx][2]):
            return self.seq(idx, indent)
        return self.mapping(idx, indent)

    def mapping(self, idx: int, indent: int):
        out = {}
        while idx < len(self.lines) and self.lines[idx][1] == indent:
            lineno, _, content = self.lines[idx]
            if _is_item(content):
                _fail(lineno, "a sequence item among mapping keys")
            split = _split_key(content, lineno)
            if split is None:
                _fail(lineno, f"{content!r} is not a `key: value` line")
            key, rest = split
            if key in out:
                _fail(lineno, f"the duplicate key {key!r}")
            idx += 1
            if rest and not rest.startswith("#"):
                out[key] = _value(rest, lineno)
            elif self.deeper(idx, indent):
                out[key], idx = self.node(idx, self.lines[idx][1])
            elif idx < len(self.lines) and self.lines[idx][1] == indent and _is_item(
                    self.lines[idx][2]):
                out[key], idx = self.seq(idx, indent)  # an indentless sequence
            else:
                _fail(lineno, f"the key {key!r} with no value (a null)")
        if self.deeper(idx, indent):
            _fail(self.lines[idx][0], "a line indented deeper than its block (a multi-line "
                                      "scalar or a stray indent)")
        return out, idx

    def seq(self, idx: int, indent: int):
        out = []
        while (idx < len(self.lines) and self.lines[idx][1] == indent
               and _is_item(self.lines[idx][2])):
            lineno, _, content = self.lines[idx]
            rest = content[1:].strip()
            idx += 1
            if not rest or rest.startswith("#"):
                if not self.deeper(idx, indent):
                    _fail(lineno, "an empty sequence item (a null)")
                item, idx = self.node(idx, self.lines[idx][1])
                out.append(item)
                continue
            if _is_item(rest):
                _fail(lineno, "a sequence nested on an item's line")
            split = None if rest[0] in "'\"[" else _split_key(rest, lineno)
            if split is None:
                out.append(_value(rest, lineno))
            else:
                key, value = split
                if not value or value.startswith("#"):
                    _fail(lineno, "a block nested in a sequence item's mapping")
                out.append({key: _value(value, lineno)})
            if self.deeper(idx, indent):
                _fail(self.lines[idx][0], "a sequence item continued on a later line")
        return out, idx


def loads(text: str) -> Any:
    """The document in `text`, as `yaml.safe_load` reads it where it lies in
    the subset; raises YamlSubsetError otherwise."""
    reader = _Reader(text)
    if not reader.lines:
        _fail(1, "an empty document (a null)")
    if reader.lines[0][1] != 0:
        _fail(reader.lines[0][0], "an indented first line")
    doc, idx = reader.node(0, 0)
    if idx != len(reader.lines):
        _fail(reader.lines[idx][0], "a line outside the document's top-level block")
    return doc


def load(path: str) -> Any:
    with open(path) as fh:
        return loads(fh.read())
