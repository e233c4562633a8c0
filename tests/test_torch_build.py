"""The kernel library's rebuild rule, on CPU (no nvcc needed): the
library is stale when it is missing or older than any CUDA source or any
shared header those sources include. Imports no JAX."""
import os
import shutil
import time

import pytest

from tpu_hpc_torch.kernels import _build


@pytest.fixture
def built_copy(tmp_path, monkeypatch):
    """A copy of csrc/ and a library file newer than every file in it,
    with _build pointed at both."""
    src = tmp_path / "csrc"
    shutil.copytree(_build.SOURCE_DIR, src)
    lib = tmp_path / "build" / _build.LIBRARY.name
    lib.parent.mkdir()
    lib.write_bytes(b"")
    old = time.time() - 100
    for f in src.iterdir():
        os.utime(f, (old, old))
    monkeypatch.setattr(_build, "SOURCE_DIR", src)
    monkeypatch.setattr(_build, "LIBRARY", lib)
    return src, lib


def test_sources_are_the_cu_files_only(built_copy):
    src, _ = built_copy
    assert any(src.glob("*.cuh")), "the sources share a header"
    assert [p.suffix for p in _build.sources()] == [".cu"] * len(
        _build.sources())


@pytest.mark.parametrize("name", ["hopper.cuh", "flash_attention.cu",
                                  "paged_attention.cu"])
def test_touching_a_source_or_header_makes_the_library_stale(built_copy,
                                                              name):
    src, _ = built_copy
    assert not _build._stale()
    os.utime(src / name, None)  # now: newer than the library
    assert _build._stale()


def test_a_missing_library_is_stale(built_copy):
    _, lib = built_copy
    lib.unlink()
    assert _build._stale()
