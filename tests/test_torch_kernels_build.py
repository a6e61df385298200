"""The kernels' build digest, on the CPU (no nvcc needed to compute it).

A library's file name carries a digest of its source, of every header in
``csrc/`` and of the compiler flags, so that editing any of them rebuilds
the library rather than loading a stale one.
"""

import fnmatch
import os
import re
import tomllib

import pytest

from flexflow_tpu_torch import kernels

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _csrc(tmp_path, source, header):
    (tmp_path / "k.cu").write_text(source)
    (tmp_path / "common.cuh").write_text(header)
    return str(tmp_path)


def test_editing_only_a_header_changes_the_library_path(tmp_path,
                                                        monkeypatch):
    monkeypatch.setattr(kernels, "CSRC",
                        _csrc(tmp_path, '#include "common.cuh"\n',
                              "// v1\n"))
    first = kernels.library_path("k")
    assert kernels.library_path("k") == first          # stable
    (tmp_path / "common.cuh").write_text("// v2\n")
    second = kernels.library_path("k")
    assert second != first
    (tmp_path / "k.cu").write_text('#include "common.cuh"\n// edited\n')
    assert kernels.library_path("k") not in (first, second)
    # a new header counts too
    (tmp_path / "more.cuh").write_text("// new\n")
    assert kernels.library_path("k") != second
    assert os.path.basename(first).startswith("libk-")


def test_flags_enter_the_digest_and_link_no_libcuda(tmp_path, monkeypatch):
    monkeypatch.setattr(kernels, "CSRC", _csrc(tmp_path, "// k\n", "// h\n"))
    before = kernels.library_path("k")
    monkeypatch.setattr(kernels, "NVCC_FLAGS", kernels.NVCC_FLAGS + ("-G",))
    assert kernels.library_path("k") != before
    assert not any(f.startswith("-lcuda") for f in kernels.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in kernels.NVCC_FLAGS


def test_package_data_ships_every_source_and_local_header():
    """An installed package builds its kernels from the files it ships:
    every ``csrc`` source and every header one of them includes by a
    quoted name must match a package-data glob."""
    with open(os.path.join(ROOT, "pyproject.toml"), "rb") as f:
        globs = tomllib.load(f)["tool"]["setuptools"]["package-data"][
            "flexflow_tpu_torch"]
    sources = sorted(f for f in os.listdir(kernels.CSRC)
                     if f.endswith((".cu", ".cuh")))
    included = set()
    for fname in sources:
        with open(os.path.join(kernels.CSRC, fname)) as f:
            included.update(re.findall(r'^\s*#include\s+"([^"]+)"',
                                       f.read(), re.M))
    assert "hopper.cuh" in included
    for fname in sorted(included) + sources:
        assert os.path.exists(os.path.join(kernels.CSRC, fname)), fname
        assert any(fnmatch.fnmatch(f"csrc/{fname}", g) for g in globs), (
            fname, globs)


def test_a_cached_library_returns_the_log_of_its_build(tmp_path,
                                                       monkeypatch):
    """The smoke's spill check reads the ptxas output: a library built
    before returns the output stored beside it, without nvcc."""
    monkeypatch.setattr(kernels, "CSRC", _csrc(tmp_path, "// k\n", "// h\n"))
    monkeypatch.setattr(kernels, "BUILD_DIR", str(tmp_path / "build"))
    path = kernels.library_path("k")
    os.makedirs(os.path.dirname(path))
    open(path, "wb").close()
    with open(f"{path}.log", "w") as f:
        f.write("ptxas info    : Used 40 registers, 0 bytes spill stores")

    def no_nvcc():
        raise AssertionError("nvcc called for a cached library")

    monkeypatch.setattr(kernels, "_nvcc", no_nvcc)
    assert kernels.build("k") == (
        path, 0.0, "ptxas info    : Used 40 registers, 0 bytes spill stores")


def test_a_library_without_its_log_is_built_again(tmp_path, monkeypatch):
    monkeypatch.setattr(kernels, "CSRC", _csrc(tmp_path, "// k\n", "// h\n"))
    monkeypatch.setattr(kernels, "BUILD_DIR", str(tmp_path / "build"))
    path = kernels.library_path("k")
    os.makedirs(os.path.dirname(path))
    open(path, "wb").close()
    calls = []

    def no_nvcc():
        calls.append(1)
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(kernels, "_nvcc", no_nvcc)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.build("k")
    assert calls == [1]
