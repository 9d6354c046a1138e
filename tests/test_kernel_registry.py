"""The hand-kernel registry (graph/kernels.find_kernel): every kept
entry is found on every backend, including the CPU these tests run on;
the entries removed with the accelerator-specific kernels are gone; and
``RCTPU_KERNELS=off`` disables the library."""

import pytest

from retrocapture_tpu.graph import kernels as K

KEPT = ["xbr-lv2.glsl", "ntsc-pass1-composite-2phase.glsl",
        "ntsc-pass1-svideo-2phase.glsl"] + [
    f"nnedi3-nns{n}-win8x4-{p}-{k}.glsl"
    for n in (16, 32, 64) for p in ("pass1", "pass2") for k in ("luma", "rgb")
]
REMOVED = ["crt-mattias.glsl", "ntsc-pass2-2phase.glsl",
           "ntsc-pass2-2phase-gamma.glsl", "ntsc-pass2-2phase-linear.glsl"]


@pytest.mark.parametrize("name", KEPT)
def test_kept_kernel_found(name, monkeypatch):
    monkeypatch.delenv("RCTPU_KERNELS", raising=False)
    fn = K.find_kernel(f"/some/tree/shaders/{name}")
    assert fn is K._REGISTRY[name] and callable(fn)


@pytest.mark.parametrize("name", REMOVED)
def test_removed_kernel_absent(name, monkeypatch):
    monkeypatch.delenv("RCTPU_KERNELS", raising=False)
    assert K.find_kernel(f"/some/tree/shaders/{name}") is None


def test_kernels_off_disables_library(monkeypatch):
    monkeypatch.setenv("RCTPU_KERNELS", "off")
    assert all(K.find_kernel(n) is None for n in KEPT)
