"""The CUDA sources of the port rehearsed on the host with g++
(tests/rehearse_cuda.py): the quad ladder's verdicts against the RFC 8032
oracle, and both SHA-256 digest bodies against hashlib, with every
shuffle, warp reduction and mbarrier of the card's code modelled by host
threads.  The card itself runs them in tests/test_torch_chip.py."""

import shutil

import pytest

import rehearse_cuda


@pytest.fixture
def gxx():
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the CUDA sources as host C++")


@pytest.mark.parametrize("rows", [1, 6])
def test_quad_ladder_verdicts_equal_the_oracle_on_the_host(gxx, tmp_path, rows):
    assert rehearse_cuda.rehearse_ladder(rows, tmp_path) == 0


def test_both_digest_bodies_equal_hashlib_on_the_host(gxx, tmp_path):
    assert rehearse_cuda.rehearse_sha256(tmp_path) == 0


@pytest.mark.parametrize("name", ["ed25519", "sha256"])
def test_host_source_cuts_the_launchers_and_the_ptx(name):
    text = rehearse_cuda.host_source(name)
    assert 'extern "C"' not in text and "<<<" not in text
    assert "asm volatile" not in text
    # Each helper the source calls is defined once, by the stub.
    for helper in ("cp_async16", "mbar_wait", "mbar_arrive"):
        assert text.count(f"inline void {helper}(") == 1


def test_kernel_sources_have_one_code_path():
    """No host branch inside a kernel source: the rehearsal's versions of
    the PTX helpers live in its stub."""
    for source in rehearse_cuda.CSRC.glob("*.cu"):
        assert "#ifdef" not in source.read_text()
        assert "#ifndef" not in source.read_text()
