"""The port stands alone: mirbft_tpu_torch imports neither jax nor the JAX
package, its entry points refuse to run on a card that is not there, and
the unported device ack plane raises instead of falling back."""

import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from mirbft_tpu_torch import bench as port_bench
from mirbft_tpu_torch.core import device_tracker
from mirbft_tpu_torch.core.state_machine import StateMachine
from mirbft_tpu_torch.crypto import ed25519_host
from mirbft_tpu_torch.ops import ed25519 as port_ed25519
from mirbft_tpu_torch.ops import sha256 as port_sha256
from mirbft_tpu_torch.ops.batching import pack_preimages, to_tensors
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


def _chain_block():
    return torch.zeros((4, 16), dtype=torch.int32)


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
        lambda: signing.kernel_verifier([(7, 0, b"x" * 100)]),
        port_bench.kernel_microbench,
        port_bench.sha256_microbench_warmup,
        lambda: port_bench.live_cluster_rate("cuda"),
        lambda: _processor("cuda"),
        lambda: _processor("cuda-pool"),
        lambda: _processor("cuda-pipelined"),
        lambda: _processor(),
    ],
    ids=[
        "kernel_plane", "sha256_many", "sha256_chunked", "to_tensors",
        "recorder", "async_signature_plane", "speculative_signature_plane",
        "verify_batch", "verify_batch_pallas", "verify_batch_empty",
        "launch_rows", "kernel_verifier", "kernel_microbench", "microbench_warmup", "live_cluster_rate",
        "cuda_processor", "cuda_pool_processor", "cuda_pipelined_processor",
        "default_config_processor",
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
        lambda: port_sha256.sha256_chain_checksum(_chain_block(), iters=1),
        lambda: port_bench.kernel_microbench(
            "cpu", batch=8, iters=1, reps=1, host_messages=8
        ),
        lambda: port_bench.sha256_microbench_warmup("cpu"),
        lambda: _processor("cuda", device="cpu"),
        lambda: _processor("cuda-pool", device="cpu"),
        lambda: _processor("cuda-pipelined", device="cpu"),
        lambda: _processor(device="cpu"),
    ],
    ids=[
        "kernel_plane", "sha256_many", "to_tensors", "recorder",
        "async_signature_plane", "speculative_signature_plane",
        "verify_batch", "verify_batch_pallas", "launch_rows",
        "sha256_chain_checksum", "kernel_microbench", "microbench_warmup",
        "cuda_processor", "cuda_pool_processor", "cuda_pipelined_processor",
        "default_config_processor",
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


def test_signing_has_no_host_authority_switch():
    """The JAX package's kernel_authority()/batch_verifier() picked a host
    route when no device was attached; the port has neither."""
    assert not hasattr(signing, "kernel_authority")
    assert not hasattr(signing, "batch_verifier")
    assert not hasattr(signing, "rlc_verifier")


def test_recorder_has_no_hash_executor_route():
    """Digests reach the engine through a hash plane only."""
    with pytest.raises(ValueError, match="hash_executor"):
        BasicRecorder(
            node_count=1, client_count=1, reqs_per_client=3,
            hash_executor=port_sha256.sha256_chunked,
            hash_plane=AsyncKernelHashPlane(device="cpu"),
        )


def test_device_ack_plane_raises():
    with pytest.raises(NotImplementedError, match="not ported yet"):
        device_tracker.resolve_ack_plane("device")
    assert device_tracker.resolve_ack_plane("host") == "host"
    with pytest.raises(ValueError):
        device_tracker.resolve_ack_plane("gpu")


def test_device_ack_plane_raises_through_the_state_machine():
    from mirbft_tpu_torch import pb

    machine = StateMachine(ack_plane="device")
    init = pb.StateEvent(
        type=pb.EventInitialize(
            initial_parms=pb.InitialParameters(
                id=0, batch_size=1, heartbeat_ticks=2, suspect_ticks=4,
                new_epoch_timeout_ticks=8, buffer_size=1 << 20,
            )
        )
    )
    with pytest.raises(NotImplementedError):
        machine.apply_event(init)


def test_device_ack_plane_env_knob_raises_in_the_engine(monkeypatch):
    monkeypatch.setenv("MIRBFT_ACK_PLANE", "device")
    recorder = BasicRecorder(
        node_count=1, client_count=1, reqs_per_client=3,
        hash_plane=AsyncKernelHashPlane(device="cpu"),
    )
    with pytest.raises(NotImplementedError):
        recorder.drain_clients(max_steps=20000)
