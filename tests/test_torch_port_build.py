"""The build key of the port's CUDA libraries (`ops/_build.py`): the
library's name hashes the flags, the sources and every header they include
with `#include "..."`, so an edited header builds anew and nothing else
does. Runs on copies in a temporary directory; needs no nvcc."""

import os
import shutil

from ddp_classification_pytorch_tpu_torch.ops import _build
from ddp_classification_pytorch_tpu_torch.ops import flash_attention as fa


def _write(path, text):
    with open(path, "w") as f:
        f.write(text)


def _copy_flash_sources(tmp_path):
    """The flash library's sources and headers, copied as they are."""
    for name in os.listdir(_build.CSRC):
        if name.startswith("flash_"):
            shutil.copy(os.path.join(_build.CSRC, name), tmp_path / name)
    return [str(tmp_path / os.path.basename(s)) for s in fa.SOURCES]


def test_flash_sources_name_their_shared_header():
    headers = _build.local_headers(fa.SOURCES)
    assert [os.path.basename(h) for h in headers] == ["flash_sm90.cuh"]


def test_key_changes_when_an_included_header_changes(tmp_path):
    sources = _copy_flash_sources(tmp_path)
    before = _build.library_path("flash_attention", sources)
    assert _build.library_path("flash_attention", sources) == before
    header = tmp_path / "flash_sm90.cuh"
    _write(header, header.read_text() + "\n// an edit\n")
    after = _build.library_path("flash_attention", sources)
    assert after != before
    assert os.path.dirname(after) == _build.BUILD_DIR


def test_key_ignores_files_no_source_includes(tmp_path):
    sources = _copy_flash_sources(tmp_path)
    before = _build.library_path("flash_attention", sources)
    _write(tmp_path / "unrelated.cuh", "// not included by anything\n")
    _write(tmp_path / "fused_abn.cu", "// another library's source\n")
    assert _build.library_path("flash_attention", sources) == before


def test_key_follows_nested_includes_and_skips_system_headers(tmp_path):
    _write(tmp_path / "k.cu", '#include <cuda.h>\n#include "a.cuh"\n__global__ void k() {}\n')
    _write(tmp_path / "a.cuh", '#pragma once\n  #  include "sub/b.cuh"\n')
    os.mkdir(tmp_path / "sub")
    _write(tmp_path / "sub" / "b.cuh", '#pragma once\n#include "../a.cuh"\nint b;\n')
    src = [str(tmp_path / "k.cu")]
    assert _build.local_headers(src) == [str(tmp_path / "a.cuh"),
                                         str(tmp_path / "sub" / "b.cuh")]
    before = _build.library_path("k", src)
    _write(tmp_path / "sub" / "b.cuh", '#pragma once\n#include "../a.cuh"\nint c;\n')
    assert _build.library_path("k", src) != before


def test_key_changes_with_a_source_but_not_with_a_missing_include(tmp_path):
    _write(tmp_path / "k.cu", '#include "generated.cuh"\nint x;\n')
    src = [str(tmp_path / "k.cu")]
    assert _build.local_headers(src) == []  # not beside the source: nvcc's problem
    before = _build.library_path("k", src)
    _write(tmp_path / "k.cu", '#include "generated.cuh"\nint y;\n')
    assert _build.library_path("k", src) != before
