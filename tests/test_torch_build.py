"""``mxnet_tpu_torch.ops._build``: the cache key of a kernel library.

A library is built once into ``_build/<key>/<name>.so`` and reused
while the key is unchanged.  The key must cover everything nvcc reads:
the source, every shared header under ``csrc/`` and the flags, or an
edited header would load a stale library.  No nvcc is needed here: the
tests only compute target paths, in a temporary ``csrc``.
"""
import os

import pytest

from mxnet_tpu_torch.ops import _build


@pytest.fixture()
def csrc(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "a.cu").write_bytes(b'#include "shared.cuh"\nint a;\n')
    (src / "b.cu").write_bytes(b"int b;\n")
    (src / "shared.cuh").write_bytes(b"#pragma once\n")
    monkeypatch.setattr(_build, "CSRC", str(src))
    monkeypatch.setattr(_build, "BUILD", str(tmp_path / "_build"))
    return src


def test_target_lies_under_build_and_names_the_source(csrc):
    out = _build._target("a")
    assert os.path.dirname(os.path.dirname(out)) == _build.BUILD
    assert os.path.basename(out) == "a.so"
    assert _build._target("a") == out        # deterministic


@pytest.mark.parametrize("edit", ["header bytes", "new header", "source",
                                  "flags"])
def test_target_changes_with_everything_nvcc_reads(csrc, monkeypatch, edit):
    before = _build._target("a")
    if edit == "header bytes":
        (csrc / "shared.cuh").write_bytes(b"#pragma once\n// edited\n")
    elif edit == "new header":
        (csrc / "other.cuh").write_bytes(b"#pragma once\n")
    elif edit == "source":
        (csrc / "a.cu").write_bytes(b'#include "shared.cuh"\nint a2;\n')
    else:
        monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    assert _build._target("a") != before


def test_sources_with_the_same_bytes_share_no_target(csrc):
    """Two sources get their own library names even where keys match."""
    (csrc / "c.cu").write_bytes((csrc / "b.cu").read_bytes())
    assert _build._target("b") != _build._target("c")


def test_repository_kernels_include_their_shared_header():
    """The CUDA sources that use the Hopper helpers include the header the
    key covers (a header outside ``csrc/*.cuh`` would not be hashed)."""
    for name in ("flash_fwd", "flash_bwd"):
        with open(os.path.join(_build.CSRC, name + ".cu")) as f:
            assert '#include "hopper.cuh"' in f.read()
    assert os.path.exists(os.path.join(_build.CSRC, "hopper.cuh"))
