"""vietasr_tpu_torch._build on the CPU: which sources a kernel library's name
depends on (nothing is compiled here)."""

from vietasr_tpu_torch import _build


def _lib_name(monkeypatch, csrc):
    monkeypatch.setattr(_build, "CSRC_DIR", str(csrc))
    return _build.lib_path("k")


def test_lib_path_follows_the_source_and_every_header(tmp_path,
                                                      monkeypatch):
    """The library's name changes when the .cu changes, when a csrc/*.cuh
    header beside it changes, appears or goes, and not when another
    kernel's source changes: a stale library is never loaded."""
    (tmp_path / "k.cu").write_text('#include "sm90.cuh"\n')
    (tmp_path / "other.cu").write_text("int x;\n")
    (tmp_path / "sm90.cuh").write_text("// helpers\n")
    names = [_lib_name(monkeypatch, tmp_path)]
    (tmp_path / "sm90.cuh").write_text("// helpers, edited\n")
    names.append(_lib_name(monkeypatch, tmp_path))
    (tmp_path / "extra.cuh").write_text("// another header\n")
    names.append(_lib_name(monkeypatch, tmp_path))
    (tmp_path / "extra.cuh").unlink()
    names.append(_lib_name(monkeypatch, tmp_path))
    (tmp_path / "k.cu").write_text('#include "sm90.cuh"\nint y;\n')
    names.append(_lib_name(monkeypatch, tmp_path))
    assert names[3] == names[1]                   # the headers as before
    del names[3]
    assert len(set(names)) == len(names), names
    (tmp_path / "other.cu").write_text("int z;\n")
    assert _lib_name(monkeypatch, tmp_path) == names[-1]
    assert all(n.startswith(_build.BUILD_DIR) and n.endswith(".so")
               and "/k-" in n for n in names)


def test_every_kernel_source_is_built():
    """Every csrc/*.cu is one of SOURCES, so a build of SOURCES builds
    them all; the shipped headers are hashed into each library's name."""
    import os

    sources = {f[:-3] for f in os.listdir(_build.CSRC_DIR)
               if f.endswith(".cu")}
    assert sources == set(_build.SOURCES)
