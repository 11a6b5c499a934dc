"""ops/_build.py on the CPU: the library's file name follows every source
it is built from.  Needs no nvcc."""

from horovod_tpu_torch.ops import _build


def _csrc(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "kern.cu").write_text('#include "shared.cuh"\n')
    (csrc / "shared.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    return csrc


def test_library_path_changes_with_a_shared_header(tmp_path, monkeypatch):
    csrc = _csrc(tmp_path, monkeypatch)
    before = _build._library_path("kern", "nvcc")
    assert _build._library_path("kern", "nvcc") == before  # deterministic
    (csrc / "shared.cuh").write_text("// v2\n")
    assert _build._library_path("kern", "nvcc") != before
    (csrc / "other.cuh").write_text("// a new header\n")
    assert len({before, _build._library_path("kern", "nvcc")}) == 2


def test_library_path_follows_source_flags_and_compiler(tmp_path, monkeypatch):
    csrc = _csrc(tmp_path, monkeypatch)
    base = _build._library_path("kern", "nvcc")
    assert base.parent == _build.BUILD_DIR and base.name.startswith("libkern-")
    assert _build._library_path("kern", "/other/nvcc") != base
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ["-Iinclude"])
    assert _build._library_path("kern", "nvcc") != base
    monkeypatch.undo()
    monkeypatch.setattr(_build, "CSRC", csrc)
    (csrc / "notes.txt").write_text("not a source\n")
    assert _build._library_path("kern", "nvcc") == base
    (csrc / "kern.cu").write_text('#include "shared.cuh"\n// edited\n')
    assert _build._library_path("kern", "nvcc") != base
