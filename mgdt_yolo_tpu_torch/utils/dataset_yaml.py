"""A reader for dataset YAML files, without PyYAML (the card's host has
none): the counterpart of the JAX package's `utils.yaml_load` for the
subset that YOLO dataset files use.

Taken, as `yaml.safe_load` reads them:

* `#` comments, blank lines, and the characters outside YAML's printable
  set removed first, as the JAX `yaml_load` removes them;
* a top-level block mapping of `key: value` lines;
* scalars by YAML 1.1's resolver, as PyYAML's: null (`null`, `~`, empty),
  bool (`true`, `false`, `yes`, `no`, `on`, `off` in their three cases),
  int (decimal, `0x` hex, `0b` binary, `0`-led octal, `_` separators),
  float (a dot required, `.inf`, `.nan`), single- and double-quoted
  strings (the common escapes), and plain strings;
* a value given as an indented block mapping (`names:` then `  0: pig`),
  an indented block list (`- pig`), an inline list (`[pig, sow]`) of
  scalars, or a literal block (`|`, as download scripts are written).

Anything else (anchors, tags, nested collections, folded blocks, flow
mappings, sexagesimal numbers, duplicate keys) raises `ValueError` naming
the line.
"""
from __future__ import annotations

import re
from typing import Any, Dict, List, Tuple

_NON_PRINTABLE = re.compile(
    "[^\x09\x0A\x0D\x20-\x7E\x85\xA0-\uD7FF\uE000-\uFFFD\U00010000-\U0010ffff]+")
_BOOL = {**dict.fromkeys(("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"), True),
         **dict.fromkeys(("no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"),
                         False)}
_NULL = ("", "~", "null", "Null", "NULL")
_INT = re.compile(r"[-+]?(?:0b[0-1_]+|0[0-7_]+|(?:0|[1-9][0-9_]*)|0x[0-9a-fA-F_]+)$")
_SEXAGESIMAL = re.compile(r"[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?$")
_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?$"
                    r"|\.[0-9_]+(?:[eE][-+][0-9]+)?$|[-+]?\.(?:inf|Inf|INF)$|\.(?:nan|NaN|NAN)$")
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v",
            "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\",
            "N": "\x85", "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_HEX = {"x": 2, "u": 4, "U": 8}


class _Error(ValueError):
    pass


def _fail(n: int, line: str, why: str):
    raise _Error(f"line {n + 1}: {why}: {line.strip()!r} (the dataset YAML reader takes "
                 "the subset dataset files use; see utils/dataset_yaml.py)")


def _strip_comment(text: str) -> str:
    """`text` without a `#` comment (one at the start or after a blank,
    outside quotes)."""
    quote = None
    for i, ch in enumerate(text):
        if quote:
            if ch == quote:
                quote = None
            continue
        if ch in "'\"" and (i == 0 or text[i - 1] in " \t[,"):
            quote = ch
        elif ch == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i]
    return text


def _double_quoted(body: str, n: int, line: str) -> str:
    out, i = [], 0
    while i < len(body):
        ch = body[i]
        if ch == "\\":
            if i + 1 >= len(body):
                _fail(n, line, "a dangling escape")
            e = body[i + 1]
            if e in _ESCAPES:
                out.append(_ESCAPES[e])
                i += 2
            elif e in _HEX:
                k = _HEX[e]
                digits = body[i + 2:i + 2 + k]
                if len(digits) != k or not re.fullmatch(r"[0-9a-fA-F]+", digits):
                    _fail(n, line, "a bad escape")
                out.append(chr(int(digits, 16)))
                i += 2 + k
            else:
                _fail(n, line, f"the escape \\{e}")
        elif ch == '"':
            _fail(n, line, "an unescaped quote")
        else:
            out.append(ch)
            i += 1
    return "".join(out)


def _scalar(text: str, n: int, line: str) -> Any:
    """One scalar, resolved as PyYAML's safe loader resolves it."""
    s = text.strip()
    if s[:1] in ("'", '"'):
        q = s[0]
        if len(s) < 2 or s[-1] != q:
            _fail(n, line, "an unterminated or multi-line quoted string")
        body = s[1:-1]
        if q == "'":
            if re.search(r"(?<!')'(?!')", body.replace("''", "")):
                _fail(n, line, "an unescaped quote")
            return body.replace("''", "'")
        return _double_quoted(body, n, line)
    if s[:1] in ("&", "*", "!", "{", "[", "|", ">", "@", "`", "%") or s.startswith(("- ", "? ")):
        _fail(n, line, "a YAML feature outside the subset")
    if ": " in s or s.endswith(":") or " #" in s:
        _fail(n, line, "a nested mapping or an ambiguous plain scalar")
    if s in _NULL:
        return None
    if s in _BOOL:
        return _BOOL[s]
    if _SEXAGESIMAL.match(s):
        _fail(n, line, "a sexagesimal number")
    if _INT.match(s):
        v = s.replace("_", "")
        sign = -1 if v[0] == "-" else 1
        v = v.lstrip("+-")
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if v != "0" and v.startswith("0"):
            return sign * int(v, 8)
        return sign * int(v)
    if _FLOAT.match(s):
        v = s.replace("_", "").lower()
        if v.endswith(".inf"):
            return float("-inf") if v[0] == "-" else float("inf")
        if v.endswith(".nan"):
            return float("nan")
        return float(v)
    return s


def _flow_list(text: str, n: int, line: str) -> List[Any]:
    """`[a, 'b', 3]`: a flow sequence of scalars."""
    body = text.strip()[1:-1]
    items, cur, quote = [], [], None
    for ch in body:
        if quote:
            cur.append(ch)
            if ch == quote:
                quote = None
        elif ch in "'\"" and not "".join(cur).strip():
            quote = ch
            cur.append(ch)
        elif ch == ",":
            items.append("".join(cur))
            cur = []
        elif ch in "[]{}":
            _fail(n, line, "a nested flow collection")
        else:
            cur.append(ch)
    if quote:
        _fail(n, line, "an unterminated quoted string")
    last = "".join(cur)
    if last.strip() or items:
        items.append(last)
    if items and not items[-1].strip():
        items.pop()  # a trailing comma
    if any(not it.strip() for it in items):
        _fail(n, line, "an empty entry")
    return [_scalar(it, n, line) for it in items]


def _split_key(text: str, n: int, line: str) -> Tuple[Any, str]:
    """`key: value` -> (key, value text); the key a plain or quoted scalar."""
    s = text.strip()
    if s[:1] in ("'", '"'):
        end = s.find(s[0], 1)
        while s[0] == "'" and end != -1 and s[end + 1:end + 2] == "'":
            end = s.find("'", end + 2)
        if end == -1 or s[end + 1:end + 2] != ":":
            _fail(n, line, "a quoted key without a colon")
        return _scalar(s[:end + 1], n, line), s[end + 2:]
    m = re.match(r"(.*?):(?:\s|$)(.*)$", s)
    if not m or not m.group(1).strip():
        _fail(n, line, "not a `key: value` line")
    return _scalar(m.group(1), n, line), m.group(2)


def loads(text: str) -> Dict[Any, Any]:
    """The mapping a dataset YAML's text holds ({} for an empty file)."""
    raw = text.splitlines()
    lines = []   # (line number, indent, content without comment)
    for n, line in enumerate(raw):
        if "\t" in line[:len(line) - len(line.lstrip())]:
            _fail(n, line, "a tab in the indentation")
        if line.strip() in ("---", "...") and not line[:1].isspace():
            _fail(n, line, "a document marker")
        lines.append((n, len(line) - len(line.lstrip(" ")), line))
    out: Dict[Any, Any] = {}
    i = 0
    while i < len(lines):
        n, ind, line = lines[i]
        content = _strip_comment(line).rstrip()
        if not content.strip():
            i += 1
            continue
        if ind:
            _fail(n, line, "an indented line outside a block")
        key, value = _split_key(content, n, line)
        if key in out:
            _fail(n, line, f"a duplicate key {key!r}")
        value = value.strip()
        i += 1
        if value.startswith(("|", ">")):
            if value not in ("|",):
                _fail(n, line, "a block scalar other than `|`")
            block, j = [], i
            while j < len(lines) and (not lines[j][2].strip() or lines[j][1] > 0):
                block.append(lines[j])
                j += 1
            while block and not block[-1][2].strip():
                block.pop()
            if not block:
                out[key] = ""
                i = j
                continue
            indent = block[0][1]
            if any(b[2].strip() and b[1] < indent for b in block):
                _fail(block[0][0], block[0][2], "a literal block with a shrinking indent")
            out[key] = "\n".join(b[2][indent:] for b in block) + "\n"
            i = j
            continue
        if value.startswith("["):
            if not value.endswith("]"):
                _fail(n, line, "a flow list over several lines")
            out[key] = _flow_list(value, n, line)
            continue
        if value:
            out[key] = _scalar(value, n, line)
            continue
        # an empty value: null, or the indented block under it
        block = []
        while i < len(lines):
            bn, bind, bline = lines[i]
            bcontent = _strip_comment(bline).rstrip()
            if not bcontent.strip():
                i += 1
                continue
            if bind == 0 and not bcontent.lstrip().startswith("- "):
                break
            if bind == 0 and bcontent.startswith("- ") and block and block[0][1] > 0:
                break
            block.append((bn, bind, bline, bcontent))
            i += 1
        if not block:
            out[key] = None
            continue
        indent = block[0][1]
        if block[0][3].lstrip().startswith("-") and block[0][3].strip() in ("-",) or \
                block[0][3].lstrip().startswith("- "):
            items = []
            for bn, bind, bline, bcontent in block:
                item = bcontent.strip()
                if bind != indent or not (item == "-" or item.startswith("- ")):
                    _fail(bn, bline, "a block list item out of line")
                rest = item[1:].strip()
                if rest.startswith("[") or rest.startswith("- "):
                    _fail(bn, bline, "a nested collection")
                items.append(_scalar(rest, bn, bline))
            out[key] = items
        else:
            sub: Dict[Any, Any] = {}
            for bn, bind, bline, bcontent in block:
                if bind != indent:
                    _fail(bn, bline, "a nested block")
                k, v = _split_key(bcontent, bn, bline)
                if k in sub:
                    _fail(bn, bline, f"a duplicate key {k!r}")
                if not v.strip() or v.strip().startswith(("[", "|", ">")):
                    _fail(bn, bline, "a nested collection")
                sub[k] = _scalar(v, bn, bline)
            out[key] = sub
    return out


def yaml_load(file) -> Dict[Any, Any]:
    """The mapping of the dataset YAML at `file`, its non-printable
    characters removed first, as the JAX `yaml_load` reads it."""
    with open(file, errors="ignore", encoding="utf-8") as f:
        s = f.read()
    if not s.isprintable():
        s = _NON_PRINTABLE.sub("", s)
    return loads(s)

