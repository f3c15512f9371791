"""The port's kernel builder on the CPU (no nvcc needed).

A library that is already built is not rebuilt, and ``build_all`` still
returns its compiler log (ptxas registers and shared memory), read from
the ``.log`` saved beside it, so ``chip_smoke.py``'s build phase reports
them on a cached build too.
"""
import subprocess

import pytest

from pinot_tpu_torch.ops import cuda_build


@pytest.fixture()
def build_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path))

    def no_nvcc(*args, **kwargs):
        raise AssertionError("nvcc started for a library already built")

    monkeypatch.setattr(subprocess, "Popen", no_nvcc)
    monkeypatch.setattr(cuda_build, "nvcc_path", no_nvcc)
    return tmp_path


def _plant(name: str, log: str) -> str:
    so = cuda_build._target(name)
    with open(so, "wb") as fh:
        fh.write(b"\x7fELF")
    with open(so + ".log", "w") as fh:
        fh.write(log)
    return so


def test_build_all_returns_saved_log_of_cached_build(build_dir):
    logs = {}
    for name in cuda_build.SOURCES:
        logs[name] = (f"ptxas info    : Used 40 registers, 32848 bytes smem "
                      f"({name})\n")
        so = _plant(name, logs[name])
        assert so.startswith(str(build_dir))
    assert cuda_build.build_all() == logs


def test_target_names_source_and_flags(build_dir, monkeypatch):
    so = cuda_build._target("compact")
    assert so.startswith(str(build_dir)) and so.endswith(".so")
    monkeypatch.setattr(cuda_build, "NVCC_FLAGS",
                        cuda_build.NVCC_FLAGS + ["-DNDEBUG"])
    assert cuda_build._target("compact") != so
