"""The runtime around the deterministic core: threads, IO, the CUDA executor.

This is the rebuild of the reference's L2-L4 (Node facade + serializer
goroutine + processors, reference: mirbft.go, serializer.go, processor.go)
and L3 storage (simplewal/, reqstore/).  The protocol core stays
single-threaded behind the serializer; executors carry out Actions under
the safety contract (requests + WAL durable before sends; hashing
order-free; commits independent), with the ``Cuda*`` processors sending
all hash work of an Actions batch to one launch of the SHA-256 kernel.

Start a node on the card:

    node = Node.start_new(Config(id=0), state)      # processor="cuda"
    processor = build_processor(node, link, app_log, wal, store)

``build_processor(..., device="cpu")`` runs the ``cuda*`` kinds on the
kernel's plain version; ``kind="serial"`` (or ``pool``, ``pipelined``)
asks for hashlib.
"""

from .config import Config  # noqa: F401
from .log import ConsoleLogger, LogLevel  # noqa: F401
from .node import ClientProposer, Node  # noqa: F401
from .processor import (  # noqa: F401
    PROCESSOR_KINDS,
    CudaPipelinedProcessor,
    CudaPoolProcessor,
    CudaProcessor,
    PipelinedProcessor,
    PoolProcessor,
    ProcessorClosed,
    SerialProcessor,
    build_processor,
)
from .storage import FileRequestStore, FileWal  # noqa: F401
from .transport import TcpTransport  # noqa: F401
