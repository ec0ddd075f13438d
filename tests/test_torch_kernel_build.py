"""``kernel_build`` on the CPU, with the C compiler standing in for nvcc: the
libraries build together, keyed by their sources' hash, and a failed
build breaks only its own library."""

import shutil

import pytest

from hallthrusterpem_tpu_torch import kernel_build

GOOD = "int answer(void) { return 42; }\n"
BAD = "int answer(void) { return 42 }\n"


@pytest.fixture
def registry(tmp_path, monkeypatch):
    cc = shutil.which("gcc") or shutil.which("cc")
    if cc is None:
        pytest.skip("a C compiler is needed to stand in for nvcc")
    monkeypatch.setattr(kernel_build, "_libs", {})
    monkeypatch.setattr(kernel_build, "build_info", {})
    monkeypatch.setattr(kernel_build, "NVCC_FLAGS", ["-x", "c", "-shared", "-fPIC"])
    monkeypatch.setattr(kernel_build, "_nvcc", lambda: cc)
    monkeypatch.setattr(kernel_build, "build_dir", lambda: tmp_path / "build")
    sources = {}
    for name, text in (("good", GOOD), ("other", GOOD.replace("42", "7")), ("bad", BAD)):
        (tmp_path / f"{name}.c").write_text(text)
        sources[name] = (tmp_path / f"{name}.c", ())
    monkeypatch.setattr(kernel_build, "SOURCES", sources)
    return tmp_path


def test_a_failed_build_breaks_only_its_own_library(registry):
    lib = kernel_build.library("good")
    assert lib.answer() == 42
    # the first call built every library together
    assert set(kernel_build.build_info) == {"good", "other"}
    assert kernel_build.library("other").answer() == 7
    with pytest.raises(RuntimeError, match="nvcc failed to build bad.c"):
        kernel_build.library("bad")
    assert kernel_build.library("good") is lib
    with pytest.raises(RuntimeError, match="bad.c"):
        kernel_build.build_all()


def test_a_built_library_is_reused_until_its_source_changes(registry):
    first = kernel_build._build(["good"])["good"]
    assert not kernel_build.build_info["good"]["cached"]
    assert kernel_build._build(["good"])["good"] == first and kernel_build.build_info["good"]["cached"]
    (registry / "good.c").write_text(GOOD.replace("42", "43"))
    second = kernel_build._build(["good"])["good"]
    assert second != first and not kernel_build.build_info["good"]["cached"]
