"""The port's native build names each library after its source, the local
headers the source includes and the compiler command, so an edited header
never loads a stale library.  Runs on the CPU: it hashes files, it compiles
nothing."""

from s2v_torch.utils import native_build


def _write(path, text):
    path.write_text(text)
    return path


def test_library_path_follows_included_headers(tmp_path):
    src = _write(tmp_path / "kern.cu", '#include <stdint.h>\n#include "common.cuh"\nint f() { return 1; }\n')
    header = _write(tmp_path / "common.cuh", '#pragma once\n#include "inner.cuh"\nconstexpr int kA = 1;\n')
    inner = _write(tmp_path / "inner.cuh", "constexpr int kB = 2;\n")
    assert native_build.local_includes(src) == [header, inner]

    first = native_build.library_path(src)
    assert native_build.library_path(src) == first  # stable while nothing changes
    _write(header, '#pragma once\n#include "inner.cuh"\nconstexpr int kA = 3;\n')
    second = native_build.library_path(src)
    assert second != first and second.name.startswith("libkern-")
    _write(inner, "constexpr int kB = 4;\n")  # a header of the header
    assert native_build.library_path(src) not in (first, second)


def test_library_path_ignores_system_headers_and_missing_files(tmp_path):
    src = _write(tmp_path / "plain.cu", '#include <cuda.h>\n#include "absent.cuh"\nint g() { return 0; }\n')
    assert native_build.local_includes(src) == []
    before = native_build.library_path(src)
    _write(src, '#include <cuda.h>\n#include "absent.cuh"\nint g() { return 1; }\n')
    assert native_build.library_path(src) != before  # the source itself still counts


def test_the_attention_kernels_include_the_hopper_layer():
    for name in ("flash_attention.cu", "flash_attention_bwd.cu"):
        includes = native_build.local_includes(native_build.CSRC_DIR / name)
        assert [p.name for p in includes] == ["hopper.cuh"]
