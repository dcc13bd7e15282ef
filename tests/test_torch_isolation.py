"""The port stands alone: mirbft_tpu_torch imports neither jax nor the JAX
package, its entry points refuse to run on a card that is not there, and
the device ack plane and the BLS aggregation raise instead of falling back
to the host.  The live service (signed ingress, the app layer, state
transfer, the load generator and the chaos campaign) is held to the same
rules: no jax, no JAX package, no host route unless named.  So is the
multi-process cluster, a spawned worker process's own imports included,
and the sharded plane: ``make_mesh``, its three sharded functions and the
entry points of ``entry.py``."""

import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from mirbft_tpu_torch import bench as port_bench
from mirbft_tpu_torch import entry as port_entry
from mirbft_tpu_torch.chaos import (
    live_smoke_matrix,
    run_live_scenario,
    run_scenario,
    smoke_matrix,
)
from mirbft_tpu_torch.chaos.__main__ import main as chaos_main
from mirbft_tpu_torch.core import device_tracker
from mirbft_tpu_torch.core.state_machine import StateMachine
from mirbft_tpu_torch.crypto import ed25519_host
from mirbft_tpu_torch.crypto import qc as port_qc
from mirbft_tpu_torch.obsv.__main__ import main as obsv_main
from mirbft_tpu_torch.ops import bls_g1 as port_bls_g1
from mirbft_tpu_torch.ops import ed25519 as port_ed25519
from mirbft_tpu_torch.ops import sha256 as port_sha256
from mirbft_tpu_torch.ops.batching import pack_preimages, to_tensors
from mirbft_tpu_torch.parallel import sharding
from mirbft_tpu_torch.runtime import Config as RuntimeConfig
from mirbft_tpu_torch.runtime import processor as runtime_processor
from mirbft_tpu_torch.testengine import BasicRecorder
from mirbft_tpu_torch.testengine import signing
from mirbft_tpu_torch.testengine.crypto_plane import AsyncKernelHashPlane

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "mirbft_tpu_torch"


def forbidden(module: str) -> bool:
    """jax, or the JAX package itself (mirbft_tpu_torch shares its
    prefix, so compare the name exactly or with its dot)."""
    return any(
        module == name or module.startswith(name + ".")
        for name in ("jax", "mirbft_tpu")
    )


def test_forbidden_names():
    assert forbidden("jax") and forbidden("jax.numpy")
    assert forbidden("mirbft_tpu") and forbidden("mirbft_tpu.ops.sha256")
    assert not forbidden("mirbft_tpu_torch")
    assert not forbidden("mirbft_tpu_torch.ops")
    assert not forbidden("jaxlib_other")


def _imports(path: Path) -> list:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names.extend(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return names


def test_no_module_imports_jax_or_the_jax_package():
    sources = sorted(PORT.rglob("*.py"))
    assert len(sources) >= 30
    bad = [
        f"{path.relative_to(REPO)}: {name}"
        for path in sources
        for name in _imports(path)
        if forbidden(name)
    ]
    assert not bad, bad


BLOCKED_RUN = textwrap.dedent(
    """
    import importlib, pkgutil, sys

    class Block:
        def find_spec(self, name, path=None, target=None):
            if any(name == b or name.startswith(b + ".")
                   for b in ("jax", "mirbft_tpu")):
                raise ImportError(f"blocked: {name}")
            return None

    sys.meta_path.insert(0, Block())
    import mirbft_tpu_torch
    for info in pkgutil.walk_packages(
        mirbft_tpu_torch.__path__, "mirbft_tpu_torch."
    ):
        importlib.import_module(info.name)
    from mirbft_tpu_torch.testengine import BasicRecorder
    from mirbft_tpu_torch.testengine.crypto_plane import AsyncKernelHashPlane
    r = BasicRecorder(node_count=1, client_count=1, reqs_per_client=3,
                      hash_plane=AsyncKernelHashPlane(device="cpu"))
    print("events", r.drain_clients(max_steps=20000))
    loaded = [m for m in sys.modules
              if m == "jax" or m.startswith("jax.")
              or m == "mirbft_tpu" or m.startswith("mirbft_tpu.")]
    print("loaded", loaded)
    """
)


def test_port_runs_with_jax_and_the_jax_package_blocked():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", BLOCKED_RUN],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert "events 19" in proc.stdout
    assert "loaded []" in proc.stdout


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _packed():
    return pack_preimages([b"abc"], batch_floor=1)


SEED = b"\x03" * 32
SIGNED = (
    [ed25519_host.public_key(SEED)], [b"m"], [ed25519_host.sign(SEED, b"m")]
)


def _rows():
    return [port_ed25519.marshal_light(*t) for t in zip(*SIGNED)]


def _host_rows():
    """``SIGNED`` decompressed on the host (``marshal_signature``)."""
    return [port_ed25519.marshal_signature(*t) for t in zip(*SIGNED)]


class _StubNode:
    """Enough of a Node for build_processor: its config."""

    def __init__(self, **config):
        self.config = RuntimeConfig(id=0, **config)


class _NullStore:
    def uncommitted(self, for_each):
        pass


def _processor(kind=None, **kwargs):
    return runtime_processor.build_processor(
        _StubNode(), None, None, None, _NullStore(), kind=kind, **kwargs
    )


#: The live rung at a size the CPU runs in seconds.
TINY_LIVE = port_bench.LiveSettings(
    clients=2, reqs_per_client=10, target_commits=20, batch_size=1,
    tick_s=0.05, fsync_floor_s=0.0, deadline_s=60.0, checkpoint_interval=20,
    suspect_ticks=100,
)


def _chain_block():
    return torch.zeros((4, 16), dtype=torch.int32)


def _cluster(**kw):
    from mirbft_tpu_torch.loadgen import InProcessCluster

    return InProcessCluster(node_count=1, client_ids=[1], **kw)


def _sharded(name, device="cuda"):
    """One of ``parallel.sharding``'s sharded functions on a mesh of two
    ``device``s (one for Ed25519: a single signature row), on a tiny
    input."""
    if name == "ed25519":
        mesh = sharding.Mesh([device])
        return sharding.sharded_ed25519_verify(mesh)(
            *port_ed25519.pack_signature_rows(_host_rows()))
    mesh = sharding.Mesh([device] * 2)
    if name == "sha256":
        packed = pack_preimages([b"abc", b"de"], batch_floor=2)
        return sharding.sharded_sha256(mesh)(packed.blocks, packed.n_blocks)
    return sharding.sharded_quorum_tally(mesh)(np.ones((2, 3), np.int8), 2)


@pytest.mark.parametrize(
    "entry",
    [
        AsyncKernelHashPlane,
        lambda: port_sha256.sha256_many([b"abc"]),
        lambda: port_sha256.sha256_chunked([[b"a", b"bc"]]),
        lambda: to_tensors(_packed()),
        lambda: BasicRecorder(node_count=1, client_count=1, reqs_per_client=3),
        signing.AsyncSignaturePlane,
        signing.SpeculativeSignaturePlane,
        lambda: port_ed25519.verify_batch(*SIGNED),
        lambda: port_ed25519.verify_batch_pallas(*SIGNED),
        lambda: port_ed25519.verify_batch([], [], []),
        lambda: port_ed25519.launch_rows(_rows()),
        lambda: port_ed25519.launch_signature_rows(_host_rows()),
        lambda: signing.kernel_verifier([(7, 0, b"x" * 100)]),
        port_bench.kernel_microbench,
        port_bench.sha256_microbench_warmup,
        lambda: port_bench.live_cluster_rate("cuda"),
        lambda: _processor("cuda"),
        lambda: _processor("cuda-pool"),
        lambda: _processor("cuda-pipelined"),
        lambda: _processor(),
        signing.batch_verifier,
        signing.kernel_authority,
        _cluster,
        lambda: _cluster(app="kv"),
        port_bench.ingress_run,
        port_bench.app_run,
        port_bench.rung5_run,
        lambda: obsv_main(["--nodes", "1", "--clients", "1", "--reqs", "1"]),
        lambda: port_bench.soak_run(0.5),
        lambda: chaos_main(["--smoke"]),
        lambda: chaos_main(["--live", "--smoke"]),
        lambda: run_scenario(smoke_matrix()[0]),
        lambda: run_live_scenario(live_smoke_matrix()[0]),
        port_bench.live_attack_run,
        port_bench.live_mp_run,
        port_bench.reconfig_run,
        port_bench.knee_run,
        lambda: chaos_main(["--live", "--cluster", "mp", "--smoke",
                            "--only", "retry"]),
        sharding.make_mesh,
        lambda: sharding.make_mesh(2),
        lambda: _sharded("sha256"),
        lambda: _sharded("tally"),
        lambda: _sharded("ed25519"),
        port_entry.entry,
        lambda: port_entry.dryrun_multichip(1),
        port_bench.ladder_run,
        port_bench.rung3_run,
        port_bench.ed25519_microbench_warmup,
        lambda: port_bench.ed25519_microbench(8),
    ],
    ids=[
        "kernel_plane", "sha256_many", "sha256_chunked", "to_tensors",
        "recorder", "async_signature_plane", "speculative_signature_plane",
        "verify_batch", "verify_batch_pallas", "verify_batch_empty",
        "launch_rows", "launch_signature_rows", "kernel_verifier",
        "kernel_microbench", "microbench_warmup", "live_cluster_rate",
        "cuda_processor", "cuda_pool_processor", "cuda_pipelined_processor",
        "default_config_processor", "batch_verifier", "kernel_authority",
        "inprocess_cluster", "inprocess_kv_cluster", "ingress_run",
        "app_run", "rung5_run", "obsv_cli_run", "soak_run", "chaos_cli_run",
        "chaos_cli_live_run", "run_scenario", "run_live_scenario",
        "live_attack_run", "live_mp_run", "reconfig_run", "knee_run",
        "chaos_cli_mp_run", "make_mesh", "make_mesh_2", "sharded_sha256",
        "sharded_quorum_tally", "sharded_ed25519_verify", "entry",
        "dryrun_multichip", "ladder_run", "rung3_run",
        "ed25519_microbench_warmup", "ed25519_microbench",
    ],
)
def test_entry_points_raise_without_a_card(no_card, entry):
    with pytest.raises(RuntimeError, match="no CUDA card"):
        entry()


@pytest.mark.parametrize(
    "entry",
    [
        lambda: AsyncKernelHashPlane(device="cpu"),
        lambda: port_sha256.sha256_many([b"abc"], device="cpu"),
        lambda: to_tensors(_packed(), "cpu"),
        lambda: BasicRecorder(
            node_count=1, client_count=1, reqs_per_client=3,
            hash_plane=AsyncKernelHashPlane(device="cpu"),
        ).drain_clients(max_steps=20000),
        lambda: signing.AsyncSignaturePlane(device="cpu"),
        lambda: signing.SpeculativeSignaturePlane(device="cpu"),
        lambda: port_ed25519.verify_batch(*SIGNED, device="cpu"),
        lambda: port_ed25519.verify_batch_pallas(*SIGNED, device="cpu"),
        lambda: port_ed25519.launch_rows(_rows(), device="cpu"),
        lambda: port_ed25519.launch_signature_rows(_host_rows(),
                                                   device="cpu"),
        lambda: port_sha256.sha256_chain_checksum(_chain_block(), iters=1),
        lambda: port_bench.kernel_microbench(
            "cpu", batch=8, iters=1, reps=1, host_messages=8
        ),
        lambda: port_bench.sha256_microbench_warmup("cpu"),
        lambda: _processor("cuda", device="cpu"),
        lambda: _processor("cuda-pool", device="cpu"),
        lambda: _processor("cuda-pipelined", device="cpu"),
        lambda: _processor(device="cpu"),
        lambda: signing.batch_verifier("cpu"),
        lambda: _cluster(device="cpu"),
        lambda: obsv_main(["--nodes", "1", "--clients", "1", "--reqs", "1",
                           "--device", "cpu"]),
        lambda: port_bench.soak_run(0.5, 0.1, device="cpu"),
        lambda: chaos_main(["--smoke", "--device", "cpu", "--only",
                            "partition"]),
        lambda: run_scenario(smoke_matrix()[0], device="cpu"),
        lambda: run_live_scenario(live_smoke_matrix()[1], budget_s=60.0,
                                  device="cpu"),
        lambda: port_bench.live_attack_run(
            "cuda", device="cpu", settings=TINY_LIVE),
        lambda: chaos_main(["--live", "--cluster", "mp", "--smoke",
                            "--device", "cpu", "--only", "retry"]),
        lambda: sharding.make_mesh(2, devices=["cpu"] * 2),
        lambda: _sharded("sha256", "cpu"),
        lambda: _sharded("tally", "cpu"),
        lambda: _sharded("ed25519", "cpu"),
        lambda: port_entry.entry("cpu"),
        lambda: port_entry.dryrun_multichip(2, devices=["cpu"] * 2),
        lambda: port_bench.ladder_run(device="cpu", reqs_per_client=1),
        lambda: port_bench.rung3_run(device="cpu", nodes=4, clients=2,
                                     reqs=1),
        lambda: port_bench.ed25519_microbench(2, device="cpu"),
    ],
    ids=[
        "kernel_plane", "sha256_many", "to_tensors", "recorder",
        "async_signature_plane", "speculative_signature_plane",
        "verify_batch", "verify_batch_pallas", "launch_rows",
        "launch_signature_rows", "sha256_chain_checksum", "kernel_microbench", "microbench_warmup",
        "cuda_processor", "cuda_pool_processor", "cuda_pipelined_processor",
        "default_config_processor", "batch_verifier", "inprocess_cluster",
        "obsv_cli_run", "soak_run", "chaos_cli_run", "run_scenario",
        "run_live_scenario", "live_attack_run", "chaos_cli_mp_run",
        "make_mesh", "sharded_sha256", "sharded_quorum_tally",
        "sharded_ed25519_verify", "entry", "dryrun_multichip",
        "ladder_run", "rung3_run", "ed25519_microbench",
    ],
)
def test_entry_points_run_on_the_cpu_when_asked(no_card, entry):
    result = entry()
    assert result is not None
    close = getattr(result, "close", None)
    if close is not None:
        close()


def _class_source_names(cls) -> set:
    import inspect

    tree = ast.parse(textwrap.dedent(inspect.getsource(cls)))
    return {
        node.id if isinstance(node, ast.Name) else node.attr
        for node in ast.walk(tree)
        if isinstance(node, (ast.Name, ast.Attribute))
    }


@pytest.mark.parametrize(
    "cls",
    [
        runtime_processor._CudaHashMixin,
        runtime_processor.CudaProcessor,
        runtime_processor.CudaPoolProcessor,
        runtime_processor.CudaPipelinedProcessor,
    ],
    ids=lambda cls: cls.__name__,
)
def test_cuda_processors_have_no_host_route(cls):
    """No batch-size threshold and no hashlib call in the Cuda* classes;
    their inherited inline hash phase is the mixin's, which launches."""
    names = _class_source_names(cls)
    assert "min_batch_for_device" not in names
    assert "host_digest" not in names
    assert "hashlib" not in names
    assert cls._hash is runtime_processor._CudaHashMixin._hash
    assert cls.host_digests == 0


def test_processor_module_has_no_try_around_a_launch():
    """A launch that fails raises: the mixin holds no try statement."""
    import inspect

    tree = ast.parse(textwrap.dedent(
        inspect.getsource(runtime_processor._CudaHashMixin)
    ))
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)]


NEW_MODULES = [
    "bench.py", "resilience.py", "status.py", "crypto/mac.py",
    "obsv/bqueue.py", "runtime/__init__.py", "runtime/config.py",
    "runtime/log.py", "runtime/msgfilter.py", "runtime/node.py",
    "runtime/processor.py", "runtime/reconfig.py", "runtime/storage.py",
    "runtime/transport.py",
]


#: The device ack plane and its oracle.
ACK_PLANE_MODULES = [
    "ops/ack_plane.py", "core/device_tracker.py", "core/client_tracker.py",
    "obsv/device.py", "obsv/recorder.py", "obsv/shadow.py",
]


@pytest.mark.parametrize("name", ACK_PLANE_MODULES)
def test_ack_plane_modules_import_neither_jax_nor_the_jax_package(name):
    """Checked by the source's import statements, including the imports
    inside functions (the JAX package's plane imported jax lazily)."""
    path = PORT / name
    assert path.exists(), name
    bad = [m for m in _imports(path) if m and forbidden(m)]
    assert not bad, f"{name}: {bad}"
    assert "jax" not in path.read_text().replace("JAX", "").split(), name


def test_ack_plane_has_no_host_fallback():
    """The tracker's plane build and the wrapper's launch hold no try
    statement: a failure raises out of them."""
    import inspect

    from mirbft_tpu_torch.core.client_tracker import ClientTracker
    from mirbft_tpu_torch.ops import ack_plane

    for fn in (ClientTracker._build_device, ClientTracker.reinitialize,
               ack_plane.ack_step, ack_plane.quorum_sweep):
        tree = ast.parse(textwrap.dedent(inspect.getsource(fn)))
        assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)], fn
    assert not hasattr(device_tracker, "device_plane_available")


#: The live node as a replicated service: signed ingress, the app layer,
#: state transfer, the load generator, and the chaos campaign with the
#: circuit breaker.
SERVICE_MODULES = [
    "crypto/ed25519_batch.py", "runtime/ingress.py", "runtime/transfer.py",
    "runtime/storage.py", "app/__init__.py", "app/kvstore.py",
    "app/stream.py", "app/journal.py", "app/service.py",
    "loadgen/__init__.py", "loadgen/arrivals.py", "loadgen/clients.py",
    "loadgen/generator.py", "loadgen/inproc.py", "loadgen/kv.py",
    "loadgen/slo.py", "chaos/__init__.py", "chaos/invariants.py",
    "chaos/faults.py", "chaos/scenarios.py", "chaos/runner.py",
    "chaos/live.py", "chaos/__main__.py", "resilience.py",
    "cluster/__init__.py", "cluster/__main__.py", "cluster/profiles.py",
    "cluster/worker.py", "cluster/supervisor.py", "cluster/chaos_mp.py",
]


@pytest.mark.parametrize("name", SERVICE_MODULES)
def test_service_modules_import_neither_jax_nor_the_jax_package(name):
    """Checked by every import statement of the source, those inside
    functions too (generator.py signs through a lazy import)."""
    path = PORT / name
    assert path.exists(), name
    bad = [m for m in _imports(path) if m and forbidden(m)]
    assert not bad, f"{name}: {bad}"
    relative = [
        node.module for node in ast.walk(ast.parse(path.read_text()))
        if isinstance(node, ast.ImportFrom) and node.level
        and node.module and forbidden(node.module)
    ]
    assert not relative, f"{name}: {relative}"


def test_no_host_route_is_picked_unless_named():
    """The verifier live embedders inject is the kernels', the in-process
    cluster's default processor hashes on the kernel, and no code in the
    port's service modules or bench.py calls the host batch verifier or
    passes a hashlib processor kind."""
    import inspect

    from mirbft_tpu_torch.loadgen import inproc

    cpu = signing.batch_verifier("cpu")
    assert cpu is not signing.rlc_verifier
    names = _class_source_names(signing.batch_verifier)
    assert "kernel_verifier" in names and "rlc_verifier" not in names
    default = inspect.signature(inproc.InProcessCluster).parameters
    assert default["processor"].default == "cuda-pipelined"
    assert default["device"].default == "cuda"
    for name in SERVICE_MODULES + ["bench.py"]:
        tree = ast.parse((PORT / name).read_text())
        used = {
            node.id if isinstance(node, ast.Name) else node.attr
            for node in ast.walk(tree)
            if isinstance(node, (ast.Name, ast.Attribute))
        }
        assert "rlc_verifier" not in used, name
        kinds = {
            kw.value.value for node in ast.walk(tree)
            if isinstance(node, ast.Call) for kw in node.keywords
            if kw.arg == "processor" and isinstance(kw.value, ast.Constant)
        }
        assert not kinds & {"serial", "pool", "pipelined"}, (name, kinds)


@pytest.mark.parametrize("name", NEW_MODULES)
def test_live_node_modules_import_neither_jax_nor_the_jax_package(name):
    path = PORT / name
    assert path.exists(), name
    bad = [m for m in _imports(path) if m and forbidden(m)]
    assert not bad, f"{name}: {bad}"


def test_signing_has_no_except_around_a_verify():
    """No verdict on the signed path may come from a handler: signing.py
    and ops/ed25519.py hold no try statement at all."""
    for name in ("testengine/signing.py", "ops/ed25519.py"):
        tree = ast.parse((PORT / name).read_text())
        tries = [n for n in ast.walk(tree) if isinstance(n, ast.Try)]
        assert not tries, f"{name}: try at line {tries[0].lineno}"


def test_signing_has_no_host_authority_switch(no_card):
    """The JAX package's kernel_authority()/batch_verifier() picked a host
    route when no device was attached.  The port's raise there instead;
    rlc_verifier exists as a route a caller names, and batch_verifier
    never returns it."""
    with pytest.raises(RuntimeError, match="no CUDA card"):
        signing.kernel_authority()
    with pytest.raises(RuntimeError, match="no CUDA card"):
        signing.batch_verifier()
    assert signing.kernel_authority("cpu") is False
    assert signing.batch_verifier("cpu") is not signing.rlc_verifier
    assert "rlc_verifier" not in _class_source_names(signing.kernel_authority)


def test_recorder_has_no_hash_executor_route():
    """Digests reach the engine through a hash plane only."""
    with pytest.raises(ValueError, match="hash_executor"):
        BasicRecorder(
            node_count=1, client_count=1, reqs_per_client=3,
            hash_executor=port_sha256.sha256_chunked,
            hash_plane=AsyncKernelHashPlane(device="cpu"),
        )


def test_device_ack_plane_raises(monkeypatch):
    """"device" resolves; on its default card, "cuda", with no card the
    plane's build raises; "gpu" is no plane at all."""
    assert device_tracker.resolve_ack_plane("device") == "device"
    assert device_tracker.resolve_ack_plane("host") == "host"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        device_tracker.require_device("cuda")
    assert device_tracker.require_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        device_tracker.resolve_ack_plane("gpu")


def test_device_ack_plane_raises_through_the_state_machine(monkeypatch):
    """A state machine on the device plane, on its default card, raises
    when it initialises without a card: it does not run the host plane."""
    from mirbft_tpu_torch import pb

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    machine = StateMachine(ack_plane="device")
    assert machine.ack_device == "cuda"
    init = pb.StateEvent(
        type=pb.EventInitialize(
            initial_parms=pb.InitialParameters(
                id=0, batch_size=1, heartbeat_ticks=2, suspect_ticks=4,
                new_epoch_timeout_ticks=8, buffer_size=1 << 20,
            )
        )
    )
    with pytest.raises(RuntimeError, match="no CUDA card"):
        machine.apply_event(init)


def test_device_ack_plane_env_knob_raises_in_the_engine(monkeypatch):
    """The MIRBFT_ACK_PLANE knob selects the device plane in the engine as
    in the JAX package; on the default card and with no card, the run
    raises instead of running on the host plane."""
    monkeypatch.setenv("MIRBFT_ACK_PLANE", "device")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        recorder = BasicRecorder(
            node_count=1, client_count=1, reqs_per_client=3,
            hash_plane=AsyncKernelHashPlane(device="cpu"),
        )
        recorder.drain_clients(max_steps=20000)


#: Ladder rung 4's modules: the manglers, the event log and its CLI, and
#: the BLS certificate plane down to its kernel.
RUNG4_MODULES = [
    "testengine/manglers.py", "eventlog.py", "cat.py", "crypto/bls_host.py",
    "crypto/qc.py", "testengine/certs.py", "ops/bls_g1.py",
]


@pytest.mark.parametrize("name", RUNG4_MODULES)
def test_rung4_modules_import_neither_jax_nor_the_jax_package(name):
    path = PORT / name
    assert path.exists(), name
    bad = [m for m in _imports(path) if m and forbidden(m)]
    assert not bad, f"{name}: {bad}"


def _bls_votes():
    from mirbft_tpu_torch.crypto import bls_host

    return [(bls_host.G1_X, bls_host.G1_Y)] * 3


def _pending_plane(**kwargs):
    from mirbft_tpu_torch.testengine.certs import CheckpointCertPlane

    plane = CheckpointCertPlane(quorum=3, **kwargs)
    plane._votes[(20, b"v")] = dict(enumerate(_bls_votes()))
    plane._pending.append((20, b"v"))
    return plane


@pytest.mark.parametrize(
    "entry",
    [
        lambda: port_qc.aggregate(_bls_votes()),
        lambda: port_bls_g1.aggregate_signatures([_bls_votes()]),
        lambda: _pending_plane().certificates(),
        port_bench.rung4_run,
    ],
    ids=["qc_aggregate", "aggregate_signatures", "cert_plane", "rung4_run"],
)
def test_bls_entry_points_raise_without_a_card(no_card, entry):
    with pytest.raises(RuntimeError, match="no CUDA card"):
        entry()


def test_bls_entry_points_run_on_the_cpu_when_asked(no_card):
    from mirbft_tpu_torch.crypto import bls_host

    want = bls_host.aggregate_g1(_bls_votes())
    assert port_qc.aggregate(_bls_votes(), device="cpu") == want
    assert port_bls_g1.aggregate_signatures([_bls_votes()],
                                            device="cpu") == [want]
    plane = _pending_plane(device="cpu")
    assert plane.certificates() == {(20, b"v"): ([0, 1, 2], want)}
    assert plane.host_folds == 0


def test_bls_route_has_no_host_fallback():
    """Neither the wrapper's launch, nor the entry point, nor the seam, nor
    the plane's aggregation holds a try statement: a failure raises out
    of them instead of folding on the host."""
    import inspect

    from mirbft_tpu_torch.testengine.certs import CheckpointCertPlane

    for fn in (port_bls_g1.aggregate_points, port_bls_g1.aggregate_signatures,
               port_qc.aggregate, CheckpointCertPlane._aggregate_pending):
        fn = inspect.unwrap(fn)
        tree = ast.parse(textwrap.dedent(inspect.getsource(fn)))
        assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)], fn


WORKER_BLOCKED = textwrap.dedent(
    """
    import runpy, sys

    class Block:
        def find_spec(self, name, path=None, target=None):
            if any(name == b or name.startswith(b + ".")
                   for b in ("jax", "mirbft_tpu")):
                raise ImportError(f"blocked: {name}")
            return None

    sys.meta_path.insert(0, Block())
    sys.argv = ["mirbft_tpu_torch.cluster", "--spec", sys.argv[1]]
    code = 0
    try:
        runpy.run_module("mirbft_tpu_torch.cluster", run_name="__main__",
                         alter_sys=True)
    except SystemExit as exc:
        code = exc.code
    loaded = [m for m in sys.modules
              if m == "jax" or m.startswith("jax.")
              or m == "mirbft_tpu" or m.startswith("mirbft_tpu.")]
    print("loaded", loaded, flush=True)
    sys.exit(code)
    """
)


def test_a_spawned_worker_imports_neither_jax_nor_the_jax_package(tmp_path):
    """``python -m mirbft_tpu_torch.cluster`` as the supervisor spawns it,
    with jax and the JAX package blocked: a 1-node worker on ``cpu`` with
    signed ingress and link MACs (the worker's lazy imports) boots, goes
    ready, and stops on SIGTERM with exit 0, having loaded neither."""
    import json
    import signal
    import time
    import urllib.request

    node_dir = tmp_path / "node0"
    node_dir.mkdir()
    spec = {"node_id": 0, "node_count": 1, "client_ids": [1],
            "dir": str(node_dir), "root": str(tmp_path), "device": "cpu",
            "processor": "cuda-pipelined", "signed_ingress": True,
            "link_auth": True, "auth_secret": "s"}
    (node_dir / "spec.json").write_text(json.dumps(spec))
    (node_dir / "peers.json").write_text(json.dumps({"peers": {}}))
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.Popen(
        [sys.executable, "-c", WORKER_BLOCKED, str(node_dir / "spec.json")],
        cwd=tmp_path, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True,
    )
    try:
        deadline = time.monotonic() + 60
        ready = False
        while time.monotonic() < deadline and not ready:
            assert proc.poll() is None, proc.communicate()
            address = node_dir / "address.json"
            if address.exists():
                port = json.loads(address.read_text())["metrics_port"]
                try:
                    with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/healthz", timeout=1.0
                    ) as resp:
                        ready = json.loads(resp.read()).get("ready", False)
                except OSError:
                    pass
            time.sleep(0.05)
        assert ready
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err
    assert "loaded []" in out, (out, err)
    assert "blocked" not in err


BENCH_RECOVER_BLOCKED = textwrap.dedent(
    """
    import os, runpy, sys

    class Block:
        def find_spec(self, name, path=None, target=None):
            if any(name == b or name.startswith(b + ".")
                   for b in ("jax", "mirbft_tpu")):
                raise ImportError(f"blocked: {name}")
            return None

    sys.meta_path.insert(0, Block())
    exit_now = os._exit

    def reporting_exit(code):
        loaded = [m for m in sys.modules
                  if m == "jax" or m.startswith("jax.")
                  or m == "mirbft_tpu" or m.startswith("mirbft_tpu.")]
        print("loaded", loaded, flush=True)
        exit_now(code)

    os._exit = reporting_exit
    sys.argv = ["mirbft_tpu_torch.bench", "--recover", sys.argv[1]]
    runpy.run_module("mirbft_tpu_torch.bench", run_name="__main__",
                     alter_sys=True)
    """
)


def test_bench_recover_imports_neither_jax_nor_the_jax_package(tmp_path):
    """``python -m mirbft_tpu_torch.bench --recover <journal>`` with jax and
    the JAX package blocked: it prints the journal's payload, exits 0, and
    loaded neither (its ``os._exit`` reports the modules first)."""
    import json

    payload = {"metric": "committed_reqs_per_sec_per_chip", "value": 1.5}
    journal = tmp_path / "BENCH_stream.jsonl"
    journal.write_text(
        json.dumps({"schema": "mirbft-bench-stream/1", "kind": "header"})
        + "\n" + json.dumps({"kind": "final", "payload": payload}) + "\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", BENCH_RECOVER_BLOCKED, str(journal)],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert json.loads(lines[0]) == payload
    assert lines[1] == "loaded []"
    assert "blocked" not in proc.stderr
