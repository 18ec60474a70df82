"""The port's CUDA build cache (``ops/_build.py``): a library is named by a
hash of its source, every ``csrc`` header that the source includes
(directly or through another header) and the nvcc flags, so that an edit of
a shared header rebuilds every library that includes it. No ``nvcc`` is
needed: only the hash is computed."""

import pytest

from general_medical_image_segmentation_cnn_framework_tpu_torch.ops import _build


@pytest.fixture
def csrc(tmp_path):
    (tmp_path / "kernel.cu").write_text('#include <cuda_runtime.h>\n#include "ring.cuh"\nint k;\n')
    (tmp_path / "ring.cuh").write_text('#pragma once\n#include "tiles.cuh"\nint r;\n')
    (tmp_path / "tiles.cuh").write_text("#pragma once\nint t;\n")
    (tmp_path / "unrelated.cuh").write_text("int u;\n")
    (tmp_path / "other.cu").write_text("int o;\n")
    return tmp_path


def test_digest_covers_the_source_and_its_headers(csrc):
    src = csrc / "kernel.cu"
    assert [p.name for p in _build._sources(src)] == ["kernel.cu", "ring.cuh", "tiles.cuh"]
    before = _build.digest(src)
    assert _build.digest(src) == before  # the same tree gives the same library
    for name in ("kernel.cu", "ring.cuh", "tiles.cuh"):  # the source, a header, a header's header
        path = csrc / name
        text = path.read_text()
        path.write_text(text + "// edited\n")
        assert _build.digest(src) != before, name
        path.write_text(text)
        assert _build.digest(src) == before


def test_digest_ignores_files_the_source_does_not_include(csrc):
    src = csrc / "kernel.cu"
    before = _build.digest(src)
    for name in ("unrelated.cuh", "other.cu"):
        (csrc / name).write_text("int changed;\n")
    (csrc / "new.cuh").write_text("int n;\n")
    assert _build.digest(src) == before


def test_digest_covers_the_flags(csrc, monkeypatch):
    before = _build.digest(csrc / "kernel.cu")
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-lineinfo",))
    assert _build.digest(csrc / "kernel.cu") != before


def test_the_conv_sources_include_the_shared_header():
    for name in ("conv3d_bn_relu", "conv3d_wgrad"):
        assert "hopper_gemm.cuh" in [p.name for p in _build._sources(_build.CSRC / f"{name}.cu")]
