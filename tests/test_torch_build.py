"""The port's kernel build cache (``repro_torch.kernels.build``) on the CPU.

nvcc exists only on the machine with the card, so a stand-in compiler (a
small script that writes the output file and prints ptxas-style lines)
takes its place: a library built once is reused with its ptxas log, and a
library whose log is missing is built again.
"""
import sys
import textwrap

import pytest

from repro_torch.kernels import build

FAKE_NVCC = textwrap.dedent("""\
    #!{python}
    import os, sys
    args = sys.argv[1:]
    out = args[args.index("-o") + 1]
    with open(out, "w") as f:
        f.write("lib")
    with open(os.path.join(os.path.dirname(__file__), "calls"), "a") as f:
        f.write("1")
    print("ptxas info    : Used 40 registers", file=sys.stderr)
    print("    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads", file=sys.stderr)
""")


@pytest.fixture
def fake_build(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text("// a kernel\n")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(0o755)
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(build, "PTXAS_LOG", {})
    monkeypatch.setattr(build, "BUILD_SECONDS", {})
    return lambda: len((tmp_path / "calls").read_text())   # nvcc runs so far


def test_a_reused_library_brings_back_its_ptxas_log(fake_build):
    builds = fake_build
    lib = build.build_library("k")
    assert lib.exists() and "spill" in build.PTXAS_LOG["k"]
    assert lib.with_suffix(".log").read_text() == build.PTXAS_LOG["k"]
    build.PTXAS_LOG.clear()
    assert build.build_library("k") == lib              # reused, not rebuilt
    assert builds() == 1
    assert "0 bytes spill stores" in build.PTXAS_LOG["k"]


def test_a_library_without_its_log_is_built_again(fake_build):
    builds = fake_build
    lib = build.build_library("k")
    lib.with_suffix(".log").unlink()
    build.build_library("k")
    assert builds() == 2
    assert "registers" in build.PTXAS_LOG["k"]
