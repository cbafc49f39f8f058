"""PyTorch port: ``ops/_build.library_path``, on the CPU (no ``nvcc``).

A kernel's library is named by a hash of its source, of every header
``csrc/*.cuh`` and of the compiler flags, so that an edited source or
header never loads a library built from the old one.  The tests point the
module's ``CSRC`` at a copy of ``csrc`` in a temporary directory; the
repository's sources stay as they are.
"""

import shutil

import pytest

from analytics_zoo_tpu_torch.ops import _build

KERNELS = ("flash_attention", "flash_attention_bwd", "fused_bn",
           "paged_attention", "quant_matmul", "quant_conv")


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    dst = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, dst)
    monkeypatch.setattr(_build, "CSRC", dst)
    return dst


def test_the_shared_header_ships_and_its_users_include_it():
    assert (_build.CSRC / "mma_tf32.cuh").exists()
    for name in ("flash_attention", "flash_attention_bwd", "fused_bn",
                 "quant_matmul", "quant_conv"):
        src = (_build.CSRC / f"{name}.cu").read_text()
        assert '#include "mma_tf32.cuh"' in src, name


@pytest.mark.parametrize("name", KERNELS)
def test_library_path_is_stable_and_follows_the_package_copy(
        tmp_path, monkeypatch, name):
    packaged = _build.library_path(name)
    dst = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, dst)
    monkeypatch.setattr(_build, "CSRC", dst)
    assert _build.library_path(name) == packaged
    assert _build.library_path(name) == _build.library_path(name)
    assert packaged.parent == _build.BUILD_DIR


@pytest.mark.parametrize("name", KERNELS)
def test_an_edited_header_changes_the_library_path(csrc, name):
    before = _build.library_path(name)
    header = csrc / "mma_tf32.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = _build.library_path(name)
    assert after != before
    assert after.name.startswith(f"lib{name}-")


def test_a_new_header_and_an_edited_source_change_the_path(csrc):
    before = _build.library_path("fused_bn")
    (csrc / "extra.cuh").write_text("#pragma once\n")
    added = _build.library_path("fused_bn")
    assert added != before
    src = csrc / "fused_bn.cu"
    src.write_text(src.read_text() + "\n")
    assert _build.library_path("fused_bn") not in (before, added)


def test_defined_macros_name_a_library_of_their_own(csrc, monkeypatch):
    """A build with ``-D`` macros (a variant of the source, such as the
    conv kernel's planted merge fault) gets a library of its own, stable
    for the same macros; the plain build's path does not change; a
    build job may name its macros."""
    plain = _build.library_path("quant_conv")
    skip = _build.library_path("quant_conv", ("-DCV_MERGE_SKIP=1",))
    assert skip != plain and skip.name.startswith("libquant_conv-")
    assert _build.library_path("quant_conv", ("-DCV_MERGE_SKIP=1",)) == skip
    assert _build.library_path("quant_conv", ()) == plain
    jobs = []
    monkeypatch.setattr(_build, "build",
                        lambda name, defines=(): jobs.append((name, defines)))
    _build.build_all(["fused_bn", ("quant_conv", ("-DCV_MERGE_SKIP=1",))])
    assert sorted(jobs) == [("fused_bn", ()),
                            ("quant_conv", ("-DCV_MERGE_SKIP=1",))]


def test_a_cached_library_keeps_its_compiler_report(csrc, tmp_path,
                                                    monkeypatch):
    """The compiler's report is kept beside the library: a second build
    finds both, runs no compiler and reads the report back, so a second
    run of the chip smoke in one checkout still sees the register and
    spill lines.  A library without its report is built again."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build, "BUILD_LOG", {})
    monkeypatch.setattr(_build, "BUILD_SECONDS", {})
    runs = []

    class Done:
        returncode = 0
        stderr = "ptxas info    : Used 80 registers\n" \
                 "    0 bytes spill stores, 0 bytes spill loads\n"

    def fake_run(cmd, **kw):
        runs.append(cmd)
        out = cmd[cmd.index("-o") + 1]
        with open(out, "wb") as f:
            f.write(b"\x7fELF")
        return Done()

    monkeypatch.setattr(_build.subprocess, "run", fake_run)
    lib = _build.build("fused_bn")
    assert len(runs) == 1 and lib.exists()
    assert _build.report_path(lib).read_text() == Done.stderr
    _build.BUILD_LOG.clear()
    _build.BUILD_SECONDS.clear()
    assert _build.build("fused_bn") == lib and len(runs) == 1
    assert _build.BUILD_LOG["fused_bn"] == Done.stderr
    assert "fused_bn" not in _build.BUILD_SECONDS
    _build.report_path(lib).unlink()
    assert _build.build("fused_bn") == lib and len(runs) == 2
    assert sorted(p.name for p in lib.parent.iterdir()) == sorted(
        [lib.name, _build.report_path(lib).name])
