#!/usr/bin/env python
"""Generate unicode_tables.h for the native WordPiece encoder.

The C++ encoder must classify codepoints and normalize text EXACTLY like the
Python spec in data/tokenization.py, which consults Python's `unicodedata`.
Rather than reimplementing Unicode in C++, this script dumps the four
classification range tables (whitespace Zs, control C*, punctuation P* +
BERT's ASCII ranges, combining-mark Mn), the full lowercase mapping (str
.lower(), including one-to-many expansions), and fully-recursive canonical
NFD decompositions — all straight out of the running Python's Unicode
database, guaranteeing byte-identical behavior between the two paths.

Run: python -m bert_pytorch_tpu_torch.native.gen_unicode_tables [PATH]
(regenerates bert_pytorch_tpu_torch/native/unicode_tables.h, or writes
PATH; commit the result)
"""

from __future__ import annotations

import os
import sys
import unicodedata

MAX_CP = 0x110000


def ranges_of(pred):
    out = []
    start = None
    for cp in range(MAX_CP):
        ok = pred(cp)
        if ok and start is None:
            start = cp
        elif not ok and start is not None:
            out.append((start, cp - 1))
            start = None
    if start is not None:
        out.append((start, MAX_CP - 1))
    return out


def is_whitespace(cp):
    ch = chr(cp)
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def is_control(cp):
    ch = chr(cp)
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def is_punct(cp):
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) \
            or (123 <= cp <= 126):
        return True
    return unicodedata.category(chr(cp)).startswith("P")


def is_mn(cp):
    return unicodedata.category(chr(cp)) == "Mn"


# BPE pretokenizer classes — defined by delegating to the str methods the
# Python scanner (data/tokenization.py ByteLevelBPETokenizer._pretokenize)
# itself calls, so the two paths agree by construction.
def is_alpha(cp):
    return chr(cp).isalpha()


def is_numeric(cp):
    return chr(cp).isnumeric()


def is_pyspace(cp):
    return chr(cp).isspace()


# Cased / Case_Ignorable (DerivedCoreProperties) — needed for str.lower()'s
# one context-sensitive rule, Greek Final_Sigma (CPython handle_capital_sigma:
# U+03A3 lowers to U+03C2 iff preceded by a cased codepoint, skipping
# case-ignorables, and not followed by one). unicodedata does not expose
# these properties, so they are PROBED out of str.lower() itself: a cp is
# Cased iff (cp + 'Σ').lower() produces final sigma; a non-cased cp is
# Case_Ignorable iff it is transparent between a cased letter and 'Σ'.
# Derivation-by-probe keeps the C++ scanner equal to the running CPython by
# construction, same as every other table here.
def is_cased(cp):
    if cp in (0xD800,):  # avoid building lone-surrogate probe strings
        return False
    try:
        return (chr(cp) + "Σ").lower()[-1] == "ς"
    except (ValueError, UnicodeError):
        return False


def is_case_ignorable(cp):
    if 0xD800 <= cp <= 0xDFFF:
        return False
    if is_cased(cp):
        return False
    try:
        return ("A" + chr(cp) + "Σ").lower()[-1] == "ς"
    except (ValueError, UnicodeError):
        return False


def lowercase_map():
    """cp -> lowered codepoint sequence, only where it differs."""
    out = {}
    for cp in range(MAX_CP):
        low = chr(cp).lower()
        if low != chr(cp):
            out[cp] = [ord(c) for c in low]
    return out


def nfd_map():
    """cp -> full canonical decomposition (NFD), only where it differs."""
    out = {}
    for cp in range(MAX_CP):
        dec = unicodedata.normalize("NFD", chr(cp))
        if dec != chr(cp):
            out[cp] = [ord(c) for c in dec]
    return out


def emit_ranges(name, ranges, f):
    f.write(f"static const CpRange {name}[] = {{\n")
    for a, b in ranges:
        f.write(f"  {{0x{a:x}, 0x{b:x}}},\n")
    f.write("};\n")
    f.write(f"static const size_t {name}_len = "
            f"sizeof({name}) / sizeof(CpRange);\n\n")


def emit_map(name, mapping, f):
    """Flat (cp, len, offset) index + a shared expansion pool."""
    pool = []
    f.write(f"static const CpMapEntry {name}[] = {{\n")
    for cp in sorted(mapping):
        seq = mapping[cp]
        f.write(f"  {{0x{cp:x}, {len(seq)}, {len(pool)}}},\n")
        pool.extend(seq)
    f.write("};\n")
    f.write(f"static const size_t {name}_len = "
            f"sizeof({name}) / sizeof(CpMapEntry);\n")
    f.write(f"static const uint32_t {name}_pool[] = {{\n  ")
    f.write(", ".join(f"0x{c:x}" for c in pool) or "0")
    f.write("\n};\n\n")


def main(path=None):
    here = os.path.dirname(os.path.abspath(__file__))
    path = path or os.path.join(here, "unicode_tables.h")
    with open(path, "w", encoding="utf-8") as f:
        f.write("// GENERATED by gen_unicode_tables.py from Python "
                f"unicodedata {unicodedata.unidata_version} "
                f"(CPython {sys.version.split()[0]}). DO NOT EDIT.\n")
        f.write("#pragma once\n#include <cstdint>\n#include <cstddef>\n\n")
        f.write("struct CpRange { uint32_t lo, hi; };\n")
        f.write("struct CpMapEntry { uint32_t cp; uint16_t len; "
                "uint32_t offset; };\n\n")
        emit_ranges("kWhitespace", ranges_of(is_whitespace), f)
        emit_ranges("kControl", ranges_of(is_control), f)
        emit_ranges("kPunct", ranges_of(is_punct), f)
        emit_ranges("kMn", ranges_of(is_mn), f)
        emit_ranges("kAlpha", ranges_of(is_alpha), f)
        emit_ranges("kNumeric", ranges_of(is_numeric), f)
        emit_ranges("kPySpace", ranges_of(is_pyspace), f)
        emit_ranges("kCased", ranges_of(is_cased), f)
        emit_ranges("kCaseIgnorable", ranges_of(is_case_ignorable), f)
        emit_map("kLower", lowercase_map(), f)
        emit_map("kNFD", nfd_map(), f)
    size = os.path.getsize(path)
    print(f"wrote {path} ({size / 1024:.0f} KiB)")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else None)
