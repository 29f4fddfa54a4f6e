"""The kernel library's bindings (`magi_tpu_torch/ops/_lib.py`) against the
CUDA sources, read as text, so it runs without `nvcc` or a card: the
sources built are the `.cu` files of `csrc/`, and each ctypes signature
names a C entry defined once with as many parameters as it has argument
types, each of the type it declares (pointer, long long, int, float).  A
list that does not match its entry cuts a pointer or shifts every
argument after it on the card."""

import os
import re

import pytest

from magi_tpu_torch.ops import _lib


def _source_text():
    texts = {}
    for name in _lib.SOURCES:
        with open(os.path.join(_lib.CSRC_DIR, name)) as f:
            texts[name] = f.read()
    return texts


def test_sources_are_the_cu_files_of_csrc():
    on_disk = sorted(f for f in os.listdir(_lib.CSRC_DIR) if f.endswith(".cu"))
    assert sorted(_lib.SOURCES) == on_disk
    assert len(set(_lib.SOURCES)) == len(_lib.SOURCES)
    for header in _lib.HEADERS:
        assert os.path.exists(os.path.join(_lib.CSRC_DIR, header))


@pytest.mark.parametrize("name", sorted(_lib._SIGNATURES))
def test_signature_matches_its_c_entry(name):
    pattern = re.compile(r"\bint\s+" + re.escape(name) + r"\s*\(([^)]*)\)\s*\{")
    found = [(src, m) for src, text in _source_text().items() for m in pattern.finditer(text)]
    assert len(found) == 1, f"{name} is defined {len(found)} times in {_lib.SOURCES}"
    src, m = found[0]
    params = [p.strip() for p in m.group(1).split(",") if p.strip()]
    assert len(params) == len(_lib._SIGNATURES[name]), (
        f"{name} in {src} takes {len(params)} parameters; _SIGNATURES lists {len(_lib._SIGNATURES[name])}")
    assert [_ctype(p) for p in params] == _lib._SIGNATURES[name], f"{name}: argument types differ from {src}"


def _ctype(param: str):
    """The ctypes type a C parameter declaration is bound with."""
    if "*" in param:
        return _lib._P
    for prefix, t in (("long long", _lib._LL), ("int", _lib._I), ("float", _lib._F)):
        if param.startswith(prefix):
            return t
    raise AssertionError(f"no ctypes type for the parameter {param!r}")
