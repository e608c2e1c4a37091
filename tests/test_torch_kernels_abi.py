"""The ctypes bindings of pvd_tpu_torch's CUDA kernels against their C
sources (CPU; no nvcc, no GPU).

`kernels.py` loads `csrc/*.cu` as one shared library with a plain C
interface and declares every entry point's argument types by hand.  A
wrong entry there does not fail loudly on the card: ctypes passes a
pointer declared `c_int` as 32 bits and cuts it, and a struct whose fields
drift from the C layout hands the kernel shifted constants.  These tests
parse each `extern "C" int pvd_*(...)` and each by-value struct in the
sources and hold `kernels._SIGNATURES` and the ctypes structs to them.
"""

import ctypes
import re

import pytest

from pvd_tpu_torch import kernels

SOURCES = {name: (kernels.CSRC / name).read_text()
           for name in kernels.SOURCES}
STRUCTS = {"HashLevels": kernels.HashLevels,
           "MarchParams": kernels.MarchParams,
           "VMTables": kernels.VMTables}
SCALARS = {"int": ctypes.c_int, "long long": ctypes.c_longlong,
           "float": ctypes.c_float, "uint32_t": ctypes.c_uint32}


def _strip_comments(text: str) -> str:
    return re.sub(r"//[^\n]*|/\*.*?\*/", "", text, flags=re.S)


def _entry_points() -> dict:
    """{name: [C type of each argument]} of every extern "C" entry."""
    found = {}
    for text in SOURCES.values():
        for name, args in re.findall(r'extern\s+"C"\s+int\s+(pvd_\w+)\s*'
                                     r'\(([^)]*)\)', _strip_comments(text)):
            args = " ".join(args.split())
            found[name] = [] if args in ("", "void") else [
                re.sub(r"\s*\w+$", "", a.strip()) if "*" not in a
                else a.strip()[:a.strip().rindex("*") + 1]
                for a in args.split(",")]
    return found


def _ctype(c_type: str):
    """The ctypes type that passes the C argument type `c_type`."""
    if "*" in c_type:
        return ctypes.c_void_p
    c_type = c_type.replace("const ", "").strip()
    return STRUCTS.get(c_type) or SCALARS[c_type]


def _defines() -> dict:
    out = {}
    for text in SOURCES.values():
        for name, value in re.findall(r"#define\s+(\w+)\s+(\d+)\b", text):
            out[name] = int(value)
    return out


def _struct_fields(name: str) -> list:
    """[(field, ctypes type)] of `struct name { ... };` in the sources."""
    for text in SOURCES.values():
        m = re.search(r"struct\s+" + name + r"\s*\{(.*?)\};",
                      _strip_comments(text), flags=re.S)
        if m:
            break
    else:
        raise AssertionError(f"struct {name} not found in csrc")
    defines, fields = _defines(), []
    for decl in filter(None, (d.strip() for d in m.group(1).split(";"))):
        fm = re.fullmatch(r"(.+?)\s*(\*?)\s*(\w+)\s*(?:\[(\w+)\])?", decl)
        c_type, ptr, field, count = fm.groups()
        t = ctypes.c_void_p if ptr else SCALARS[c_type.strip()]
        if count:
            t = t * (int(count) if count.isdigit() else defines[count])
        fields.append((field, t))
    return fields


def test_every_entry_point_is_bound():
    """The same entry points in the sources and in `_SIGNATURES`."""
    assert set(_entry_points()) == set(kernels._SIGNATURES)
    # the entry points this parser must see: all kernels' and the probe
    assert len(_entry_points()) == 17


@pytest.mark.parametrize("name", sorted(kernels._SIGNATURES))
def test_signature_matches_source(name):
    """Same argument count; pointers (and the stream) c_void_p, long long
    c_longlong, int c_int, structs by value as their ctypes class."""
    c_args = _entry_points()[name]
    bound = kernels._SIGNATURES[name]
    assert len(bound) == len(c_args), (name, c_args, bound)
    for i, (c_type, t) in enumerate(zip(c_args, bound)):
        assert t is _ctype(c_type), (name, i, c_type, t)
        if "*" in c_type:
            assert t is ctypes.c_void_p
        elif "long long" in c_type:
            assert t is ctypes.c_longlong


@pytest.mark.parametrize("name", sorted(STRUCTS))
def test_struct_layout_matches_source(name):
    """Field names, order, types and array lengths of each struct passed
    by value, so ctypes lays it out as nvcc does."""
    want = _struct_fields(name)
    got = STRUCTS[name]._fields_
    assert [f for f, _ in got] == [f for f, _ in want]
    for (field, t_got), (_, t_want) in zip(got, want):
        if issubclass(t_want, ctypes.Array):
            assert issubclass(t_got, ctypes.Array), field
            assert t_got._length_ == t_want._length_, field
            assert t_got._type_ is t_want._type_, field
        else:
            assert t_got is t_want, field


def test_limits_match_source():
    """The wrappers' level limits are the sources' array sizes."""
    d = _defines()
    assert kernels.MAX_LEVELS == d["PVD_MAX_LEVELS"]
    assert kernels.MAX_BAKED_LEVELS == d["PVD_MAX_BAKED"]


def test_parser_reads_pointer_and_scalar_arguments():
    """The parser itself: pvd_vm_sample_fwd's eight arguments."""
    assert _entry_points()["pvd_vm_sample_fwd"] == [
        "VMTables", "const float*", "float*", "long long", "int", "int",
        "int", "void*"]
    assert _entry_points()["pvd_hash_cell_vector_atomics"] == []


def test_k6_and_k11_entries():
    """K6's entry takes the stream's ray ids and valid flags (it writes
    the zeros of the slots no ray owns) and its lanes per ray; K11's takes
    no layout switch."""
    assert _entry_points()["pvd_composite_compact_bwd"] == [
        "const float*", "const float*", "const float*", "const float*",
        "const float*", "const int*", "const long long*", "const uint8_t*",
        "int", "int", "int", "const float*", "const float*", "const float*",
        "const float*", "float*", "float*", "void*"]
    assert _entry_points()["pvd_hash_cell_bwd"] == [
        "const float*", "const float*", "float*", "long long", "HashLevels",
        "void*"]
