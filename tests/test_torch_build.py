"""The PyTorch port's kernel build cache (``kernels/_build.py``).

Each CUDA source builds into a library whose file name carries a hash of
what it was built from, so an edit rebuilds instead of loading a stale
library from ``build/``.  Computing the name needs no ``nvcc``.
"""
import shutil

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402


def test_library_path_follows_every_header(tmp_path, monkeypatch):
    """An edit to a shared header, or a new one, changes the library path
    of every source: any of them may include it."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = {name: _build.library_path(name) for name in _build.SOURCES}
    assert before == {name: _build.library_path(name)
                      for name in _build.SOURCES}
    header = csrc / "scatter.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    edited = {name: _build.library_path(name) for name in _build.SOURCES}
    assert all(edited[name] != before[name] for name in _build.SOURCES)
    (csrc / "extra.cuh").write_text("// a new header\n")
    assert all(_build.library_path(name) != edited[name]
               for name in _build.SOURCES)
