"""The CUDA sources of the port rehearsed on the host with g++
(tests/rehearse_cuda.py): both quad ladders' verdicts against the RFC 8032
oracle (the extended one's against its plain version too), decompression's points against the oracle and its plain version,
both SHA-256 digest bodies against hashlib, the ack plane's step and
sweep against their plain versions (the step on a mesh's client blocks
too), the BLS G1 aggregation against its plain version and the host
fold, and the sharded plane's column sums and shard sum against theirs,
with every shuffle, warp reduction,
atomic and mbarrier of the card's code modelled by host threads.  The card
itself runs them in tests/test_torch_chip.py."""

import shutil

import pytest

import rehearse_cuda
from ed25519_corpus import decompression_corpus


@pytest.fixture
def gxx():
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the CUDA sources as host C++")


@pytest.mark.parametrize("rows", [1, 6])
def test_quad_ladder_verdicts_equal_the_oracle_on_the_host(gxx, tmp_path, rows):
    assert rehearse_cuda.rehearse_ladder(rows, tmp_path) == 0


@pytest.mark.parametrize("rows", [1, 6])
def test_extended_ladder_verdicts_equal_the_oracle_on_the_host(gxx, tmp_path,
                                                              rows):
    """Host-decompressed rows (valid, corrupted, the identity and an
    order-8 key), every other -A at Z != 1: the oracle's verdicts and the
    plain version's, bit for bit, and nothing past the rows."""
    assert rehearse_cuda.rehearse_ladder_extended(rows, tmp_path) == 0


@pytest.mark.parametrize(
    "rows", [None, *rehearse_cuda.DEC_RAGGED_ROWS],
    ids=lambda rows: "corpus" if rows is None else f"rows{rows}",
)
def test_decompress_equals_the_oracle_on_the_host(gxx, tmp_path, rows):
    """The decompression corpus (each branch of RFC 8032 5.1.3), and ragged
    launches: 1 and 3 rows (groups of the warp left empty), one past a
    block and one past two."""
    encodings = (decompression_corpus() if rows is None
                 else rehearse_cuda.decompress_rows(rows, rows))
    assert rehearse_cuda.rehearse_decompress(encodings, tmp_path) == 0


def test_both_digest_bodies_equal_hashlib_on_the_host(gxx, tmp_path):
    assert rehearse_cuda.rehearse_sha256(tmp_path) == 0


@pytest.mark.parametrize(
    "rows,limbs", rehearse_cuda.ACK_CASES,
    ids=[f"rows{r}-limbs{l}" for r, l in rehearse_cuda.ACK_CASES],
)
def test_ack_plane_equals_its_plain_version_on_the_host(gxx, tmp_path, rows,
                                                        limbs):
    """The step's one cooperative grid (host threads meeting at the grid
    barrier, a few rows a thread) and the sweep, on a seeded case holding
    every row class: state, row outputs, sweep tick and totals bit for bit
    against the plain versions, and the adoption scratch empty again after
    the step."""
    assert rehearse_cuda.rehearse_ack(rows, limbs, tmp_path) == 0


@pytest.mark.parametrize("rows", rehearse_cuda.ACK_CROSSING_ROWS)
def test_ack_step_adoption_across_a_threads_rows_on_the_host(gxx, tmp_path,
                                                            rows):
    """The crossing case (tests/ack_plane_cases.py) on the rehearsal's grid
    of 8 blocks of 64 threads: at 4096 rows 8 a thread, all in registers;
    at 8192 rows 16 a thread, the last 8 carrying their class through the
    output.  The virgin slot's first row (a thread's first) adopts, the
    middle one falls back and the last (a thread's eighth, then its
    sixteenth) applies, state and row outputs bit for bit against the
    plain version."""
    assert rehearse_cuda.rehearse_ack(rows, 1, tmp_path, crossing=True) == 0


@pytest.mark.parametrize(
    "rows,limbs,shards", rehearse_cuda.ACK_SHARD_CASES,
    ids=[f"rows{r}-limbs{l}-shards{k}"
         for r, l, k in rehearse_cuda.ACK_SHARD_CASES],
)
def test_ack_step_on_a_meshs_client_blocks_on_the_host(gxx, tmp_path, rows,
                                                      limbs, shards):
    """A shard's view of the step: a seeded case split over client blocks,
    each block stepped from its first client row, then a block no row
    names.  Each block's state, row outputs and sweep bit for bit against
    the plain version; the foreign block's row outputs all exactly 0; the
    blocks' outputs summed equal to the one-block step's, row for row (the
    mesh's psum)."""
    assert rehearse_cuda.rehearse_ack_shards(rows, limbs, shards,
                                             tmp_path) == 0


@pytest.mark.parametrize(
    "case", rehearse_cuda.TALLY_CASES,
    ids=[f"tally{r}x{c}-sum{k}x{n}" + (f"-off{o}" if o else "")
         for r, c, k, n, o in rehearse_cuda.TALLY_CASES],
)
def test_tally_and_shard_sum_equal_their_plain_versions_on_the_host(
        gxx, tmp_path, case):
    """csrc/parallel.cu: the column sums of a ragged int8 vote block (word
    loads, and byte loads where the columns or the base do not fall on 4
    bytes) and the sum of ragged int32 partials, with and without a
    threshold, bit for bit against the plain versions (sign extension and
    int32 wrap-around included); nothing written past the outputs."""
    assert rehearse_cuda.rehearse_parallel(*case, tmp_path) == 0


@pytest.mark.parametrize(
    "slots,limbs,certified,misalign", rehearse_cuda.SWEEP_REHEARSALS,
    ids=[f"slots{s}-limbs{l}" + ("-certified" if c else "")
         + ["", "-bytes-off", "-masks-off"][m]
         for s, l, c, m in rehearse_cuda.SWEEP_REHEARSALS],
)
def test_ack_sweep_equals_its_plain_version_twice_on_the_host(
        gxx, tmp_path, slots, limbs, certified, misalign):
    """The sweep kernel alone, a thread a group of 8 slots (vector loads
    where the arrays are aligned, slot by slot in a plane's last
    part-group and where the byte arrays are not, scalar limbs at 3 limbs
    and where the masks are not), grid-stride past the rehearsal's 8
    blocks, each block's partials summed by the block that draws the last
    ticket: two sweeps in a row on one counter, ticks and totals bit for
    bit against the plain version each time, the counter back at 0.  The
    certified plane gives every block 4096 slots, all weak and strong:
    past the 10-bit fields of the first port's packed counts."""
    assert rehearse_cuda.rehearse_sweep(slots, limbs, tmp_path, certified,
                                        misalign) == 0


@pytest.mark.parametrize("index", range(4),
                         ids=["edges-4x4", "edges-4x8", "random-4x4",
                              "rung4-4x128"])
def test_bls_aggregate_equals_its_plain_version_on_the_host(gxx, tmp_path,
                                                           index):
    """tests/bls_cases.py's small cases, a group of host threads a
    certificate: the output bit for bit equal to the plain version's, the
    affine points to the host fold (``rehearse_cuda.py bls`` adds (64,
    128) and (4, 256))."""
    from bls_cases import cases

    assert rehearse_cuda.rehearse_bls([cases(full=False)[index]],
                                      tmp_path) == 0


@pytest.mark.parametrize("index", range(3), ids=["width1", "width85",
                                                  "width200"])
def test_bls_aggregate_at_widths_no_lane_split_divides_on_the_host(
        gxx, tmp_path, index):
    """tests/bls_cases.py's width cases (1, 85 and 200 slots, unpadded),
    a group of host threads a certificate: bit for bit equal to the plain
    version, the affine points to the host fold."""
    from bls_cases import width_cases

    assert rehearse_cuda.rehearse_bls([width_cases()[index]], tmp_path,
                                      exact=True) == 0


@pytest.mark.parametrize("name", ["ed25519", "sha256", "ack_plane", "bls_g1",
                                  "parallel"])
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
