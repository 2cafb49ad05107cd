"""The C interface of the port's CUDA library, read from the sources.

``ops/build.py::SIGNATURES`` gives ctypes the argument types of every C
entry; a count that differs from the definition in ``csrc/`` passes the
arguments shifted and shows only as a fault on the card. These tests read
the source text alone (no compiler), so they run on the CPU: every entry of
the table is an ``extern "C"`` function of ``csrc/`` with as many
parameters, and every ``int nx_*`` function defined there has an entry.
"""

import re

import pytest

from nextgen_uia_tpu_torch.ops import build

_DEF = re.compile(r"\bint\s+(nx_\w+)\s*\(")


def _strip_comments(text):
    """The source with comments blanked out, string literals kept."""
    out, i, n = [], 0, len(text)
    while i < n:
        if text.startswith("//", i):
            j = text.find("\n", i)
            i = n if j < 0 else j
        elif text.startswith("/*", i):
            j = text.find("*/", i + 2)
            i = n if j < 0 else j + 2
        elif text[i] in "\"'":
            j = _literal_end(text, i)
            out.append(text[i:j])
            i = j
        else:
            out.append(text[i])
            i += 1
    return "".join(out)


def _literal_end(text, i):
    """Index just past the string or character literal opening at i."""
    quote, j = text[i], i + 1
    while j < len(text) and text[j] != quote:
        j += 2 if text[j] == "\\" else 1
    return j + 1


def _close(text, i, open_, close):
    """Index of the bracket closing the one at i, literals skipped."""
    depth, j = 0, i
    while j < len(text):
        c = text[j]
        if c in "\"'":
            j = _literal_end(text, j)
            continue
        depth += (c == open_) - (c == close)
        if depth == 0:
            return j
        j += 1
    raise ValueError(f"unbalanced {open_!r} at {i}")


def _parameter_count(params):
    params = params.strip()
    if not params or params == "void":
        return 0
    depth, count = 0, 1
    for c in params:
        depth += (c in "(<[") - (c in ")>]")
        count += c == "," and depth == 0
    return count


def _c_entries():
    """{name: (parameter count, inside an extern "C" block)} for every
    ``int nx_*`` function defined (not only declared) under csrc/."""
    found = {}
    for path in sorted(build.CSRC.glob("*.cu*")):
        text = _strip_comments(path.read_text())
        blocks = [(m.end() - 1, _close(text, m.end() - 1, "{", "}"))
                  for m in re.finditer(r'extern\s+"C"\s*\{', text)]
        for m in _DEF.finditer(text):
            open_paren = m.end() - 1
            close_paren = _close(text, open_paren, "(", ")")
            if not text[close_paren + 1:].lstrip().startswith("{"):
                continue  # a declaration
            name = m.group(1)
            assert name not in found, f"{name} is defined twice under csrc/"
            found[name] = (_parameter_count(text[open_paren + 1:close_paren]),
                           any(a < m.start() < b for a, b in blocks))
    return found


ENTRIES = _c_entries()


@pytest.mark.parametrize("name", sorted(build.SIGNATURES))
def test_signature_matches_its_c_definition(name):
    assert name in ENTRIES, f"{name} is in build.SIGNATURES but csrc/ defines no int {name}(...)"
    count, extern_c = ENTRIES[name]
    assert extern_c, f"{name} is not inside an extern \"C\" block"
    assert count == len(build.SIGNATURES[name]), (
        f"{name}: csrc/ takes {count} parameters, build.SIGNATURES lists "
        f"{len(build.SIGNATURES[name])}")


def test_every_c_entry_has_a_signature():
    assert ENTRIES, "found no int nx_* definitions under csrc/"
    missing = sorted(set(ENTRIES) - set(build.SIGNATURES))
    assert not missing, f"C entries with no ctypes signature in build.SIGNATURES: {missing}"


def test_parser_counts_parameters_and_skips_literals():
    text = _strip_comments('extern "C" {\n// int nx_gone(int a);\nint nx_one(const void* p, '
                           'int n, /* , */ float s) { asm("{"); return 0; }\n'
                           'int nx_decl(int a);\n}\n')
    assert "nx_gone" not in text
    start = text.index("{")
    assert text[_close(text, start, "{", "}"):].startswith("}\n")
    m = _DEF.search(text)
    params = text[m.end():_close(text, m.end() - 1, "(", ")")]
    assert m.group(1) == "nx_one" and _parameter_count(params) == 3
    assert _parameter_count(" void ") == 0
