"""The C ABI of the port's CUDA kernels, checked on the CPU.

``native.SIGNATURES`` declares every ``extern "C"`` entry point of
``csrc/`` once, and ``native.library`` applies it when it loads a
library.  A declaration that drifts from its C source passes wrong
arguments without an error, so each one is held here to the
declaration parsed from ``csrc/<name>.cu``: the parameter count and each
parameter's kind (pointer, int, u32, float).  The wrappers in
``kernels/*/ops.py`` reach the entry points only through
``native.entry`` and never assign ``argtypes`` or ``restype``
themselves.
"""

import ast
import ctypes
import inspect
import re
from pathlib import Path

import pytest

from repro_torch.kernels import native
from repro_torch.kernels.cascade import ops as cascade_ops

KERNELS_DIR = Path(native.__file__).resolve().parent
OPS = sorted(KERNELS_DIR.glob("*/ops.py"))
DECLARED = sorted((lib, fn) for lib, fns in native.SIGNATURES.items()
                  for fn in fns)
KIND = {ctypes.c_void_p: "ptr", ctypes.c_int: "int",
        ctypes.c_uint32: "u32", ctypes.c_float: "float"}
EXTERN = re.compile(r'extern "C" (\w+) (\w+)\(([^)]*)\)')


def c_param_kind(param: str) -> str:
    param = " ".join(param.split())
    if "*" in param:
        return "ptr"
    ctype = param.rsplit(" ", 1)[0].replace("const ", "")
    return {"int": "int", "uint32_t": "u32", "float": "float"}[ctype]


def c_entries(lib: str) -> dict:
    """{entry: (return type, [(kind, name)])} of ``csrc/<lib>.cu``."""
    src = (native.CSRC / f"{lib}.cu").read_text()
    out = {}
    for ret, name, params in EXTERN.findall(src):
        parts = [p.strip() for p in params.split(",") if p.strip()]
        out[name] = (ret, [(c_param_kind(p), p.split()[-1].lstrip("*"))
                           for p in parts])
    return out


def ops_tree(path: Path) -> ast.Module:
    return ast.parse(path.read_text(), filename=str(path))


def test_the_table_covers_every_library():
    assert set(native.SIGNATURES) == set(native.KERNELS)
    assert len(native.KERNELS) == 9
    assert set(native.LAUNCHES) == set(native.KERNELS)


@pytest.mark.parametrize("lib", native.KERNELS)
def test_every_c_entry_point_is_declared(lib):
    assert set(c_entries(lib)) == set(native.SIGNATURES[lib])


@pytest.mark.parametrize("lib,fn", DECLARED,
                         ids=[f"{lib}.{fn}" for lib, fn in DECLARED])
def test_each_declaration_matches_its_c_source(lib, fn):
    ret, params = c_entries(lib)[fn]
    assert ret == "int"
    declared = [KIND[t] for t in native.SIGNATURES[lib][fn]]
    assert declared == [kind for kind, _ in params], params
    assert params[-1] == ("ptr", "stream")


@pytest.mark.parametrize("path", OPS, ids=[p.parent.name for p in OPS])
def test_no_wrapper_declares_a_signature(path):
    for node in ast.walk(ops_tree(path)):
        targets = getattr(node, "targets", None) or \
            [getattr(node, "target", None)]
        for t in targets:
            assert not (isinstance(t, ast.Attribute)
                        and t.attr in ("argtypes", "restype")), \
                f"{path.parent.name}: assigns {t.attr} at line {t.lineno}"


@pytest.mark.parametrize("path", OPS, ids=[p.parent.name for p in OPS])
def test_wrappers_call_only_declared_entries(path):
    calls = []
    for node in ast.walk(ops_tree(path)):
        if isinstance(node, ast.Call) and isinstance(node.func,
                                                     ast.Attribute):
            owner = node.func.value
            if isinstance(owner, ast.Name) and owner.id == "native":
                assert node.func.attr != "library", \
                    f"{path.parent.name}: reaches a library, not an entry"
                if node.func.attr == "entry":
                    calls.append(tuple(a.value for a in node.args))
    assert calls, f"{path.parent.name} launches nothing"
    for lib, fn in calls:
        assert fn in native.SIGNATURES[lib], (lib, fn)


def test_cascade_takes_no_lanes():
    entries = c_entries("cascade_sm90")
    for fn in ("cascade_sm90_launch", "cascade_sm90_floor_launch"):
        assert "lanes" not in [name for _, name in entries[fn][1]], fn
    for launch in (cascade_ops._launch_sm90, cascade_ops._launch_floor):
        assert "lanes" not in inspect.signature(launch).parameters
    assert not hasattr(cascade_ops, "LANES")
    for name in ("cascade", "bloom", "interval"):
        assert not (native.CSRC / f"{name}.cu").exists()
        assert name not in native.KERNELS


class _FakeLib:
    """A loaded library's stand-in: any entry point, declared or not."""

    def __getattr__(self, name):
        fn = type("Fn", (), {})()
        setattr(self, name, fn)
        return fn


def test_loading_a_library_declares_its_entries_once(monkeypatch):
    monkeypatch.setattr(native, "_libs", {})
    monkeypatch.setattr(native.ctypes, "CDLL", lambda path: _FakeLib())
    native._load("cascade_sm90", Path("unused.so"))
    fn = native.entry("cascade_sm90", "cascade_sm90_launch")
    assert fn.argtypes == native.SIGNATURES["cascade_sm90"][
        "cascade_sm90_launch"]
    assert fn.restype is ctypes.c_int
    assert len(fn.argtypes) == 28
    # The same declared function on every call, never declared again.
    assert native.entry("cascade_sm90", "cascade_sm90_launch") is fn
    with pytest.raises(KeyError, match="no declared entry point"):
        native.entry("cascade_sm90", "cascade_launch")
