"""ops/_build.py on the CPU: the library's file name follows every source
it is built from, the ``-Xptxas -v`` report is parsed and survives a
cached build.  Needs no nvcc."""

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


# -Xptxas -v lines as nvcc prints them for two kernels, one spilling
_PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115flash_dq_kernelILi128EEEv14CUtensorMap_st' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_115flash_dq_kernelILi128EEEv14CUtensorMap_st
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 384 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_114xent_dw_kernelILi2048EEEv14CUtensorMap_st' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_114xent_dw_kernelILi2048EEEv14CUtensorMap_st
    48 bytes stack frame, 44 bytes spill stores, 52 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 392 bytes cmem[0]
"""


def test_spill_bytes_parses_each_function():
    spills = _build.spill_bytes(_PTXAS_LOG.splitlines())
    assert spills == {
        "_ZN12_GLOBAL__N_115flash_dq_kernelILi128EEEv14CUtensorMap_st": (0, 0),
        "_ZN12_GLOBAL__N_114xent_dw_kernelILi2048EEEv14CUtensorMap_st": (44, 52),
    }
    assert _build.spill_bytes([]) == {}


class _FakeNvcc:
    """Stands in for the nvcc process: writes the library it is asked for
    and prints the canned ptxas log."""

    calls = []

    def __init__(self, cmd, **kwargs):
        _FakeNvcc.calls.append(cmd)
        out = cmd[cmd.index("-o") + 1]
        with open(out, "w") as f:
            f.write("not a real library\n")
        self.returncode = 0

    def communicate(self):
        return "nvcc noise\n" + _PTXAS_LOG, None


def test_a_cached_build_reads_its_ptxas_report(tmp_path, monkeypatch):
    _csrc(tmp_path, monkeypatch)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "Popen", _FakeNvcc)
    monkeypatch.setattr(_build, "PTXAS_REPORT", {})
    _FakeNvcc.calls = []

    path, job, lock = _build._start("kern")  # built here
    assert job is not None
    _build._finish("kern", path, job, lock)
    kept = [ln for ln in _PTXAS_LOG.splitlines() if ln]
    assert path.exists() and _build.PTXAS_REPORT["kern"] == kept
    sidecar = path.with_suffix(".ptxas.txt")
    assert sidecar.name == path.name[:-3] + ".ptxas.txt"

    _build.PTXAS_REPORT.clear()  # another process: the library is cached
    path2, job, lock = _build._start("kern")
    assert path2 == path and job is None
    _build._finish("kern", path, job, lock)
    assert _build.PTXAS_REPORT["kern"] == kept
    assert len(_FakeNvcc.calls) == 1

    sidecar.unlink()  # a library without its report is built again
    path3, job, lock = _build._start("kern")
    assert job is not None
    _build._finish("kern", path3, job, lock)
    assert sidecar.exists() and len(_FakeNvcc.calls) == 2
