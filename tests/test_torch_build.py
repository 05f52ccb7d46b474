"""The kernel build of the port (ops/_build.py) and the wrappers' refusals,
on the CPU: a failed build or launch raises, nothing falls back."""

import pytest

torch = pytest.importorskip("torch")

from gvcnn_tf_tpu_torch.ops import _build  # noqa: E402
from gvcnn_tf_tpu_torch.ops.grouping_kernel import group_and_fuse  # noqa: E402
from gvcnn_tf_tpu_torch.ops.stem_kernel import stem_conv  # noqa: E402


@pytest.fixture
def sources(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text("// a kernel\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    return csrc


def test_library_path_follows_the_sources(sources):
    first = _build.library_path()
    assert first.parent.parent == _build.BUILD_ROOT
    (sources / "k.cu").write_text("// another kernel\n")
    assert _build.library_path() != first


def test_build_without_nvcc_raises(sources, monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


def test_failed_compile_raises_with_its_output(sources, monkeypatch):
    monkeypatch.setattr(_build, "_nvcc", lambda: "false")  # exits 1
    with pytest.raises(RuntimeError, match="nvcc failed with code 1"):
        _build.build()
    assert not _build.library_path().exists()
    assert list(_build.library_path().parent.iterdir()) == []  # no .so left


def test_nonzero_launch_code_raises():
    _build.check(0, "k")
    with pytest.raises(RuntimeError, match="CUDA launch failed with error 9"):
        _build.check(9, "k")


def test_wrappers_refuse_other_devices():
    x = torch.zeros((1, 16, 16, 3), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        stem_conv(x, torch.zeros((64, 3, 7, 7), device="meta"))
    s = torch.zeros((1, 4), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        group_and_fuse(s, torch.zeros((1, 4, 8), device="meta"), 8)
