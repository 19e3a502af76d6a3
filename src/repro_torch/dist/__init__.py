"""The distributed worker runtime (paper §5's staged distributed plans,
made real): a driver plus N workers, each owning its own
:class:`~repro_torch.objectmodel.store.PagedStore` shard and executing pipeline
stages locally, connected by an exchange layer implementing the three
communication patterns the executor assumes — hash-partition shuffle
(JOIN / AGG), broadcast (small-side joins), and gather-merge (TOPK,
``collect()``).

Transfers are page-granular: the wire format *is* the page byte format
(:meth:`~repro_torch.objectmodel.store.PagedSet.to_payloads` /
:meth:`~repro_torch.objectmodel.store.PagedSet.from_payloads`), so neither end
parses anything. Workers run as threads, forked processes, or framed-TCP
socket peers (``worker_kind="socket"`` — true multi-host: launch workers
anywhere with ``python -m repro_torch.dist.worker --connect host:port``) behind
a common transport interface.

Front door: ``Session(backend="workers", num_workers=N)``, or
:class:`~repro_torch.dist.driver.DistributedExecutor` directly.
"""
from repro_torch.dist.driver import DistributedExecutor
from repro_torch.dist.exchange import (SocketTransport, all_gather,
                                 exchange_partitions, gather_to)
from repro_torch.dist.placement import build_shard_store, place_scans
from repro_torch.dist.protocol import (DRIVER, PageBlock, PickleBlock,
                                 ProtocolError, decode_batch, decode_frame,
                                 encode_batch, frame_buffers, read_frame,
                                 write_frame)
from repro_torch.dist.worker import WorkerRuntime, connect_worker, run_remote_worker

__all__ = [
    "DistributedExecutor", "WorkerRuntime", "DRIVER", "PageBlock",
    "PickleBlock", "ProtocolError", "encode_batch", "decode_batch",
    "frame_buffers", "write_frame", "read_frame", "decode_frame",
    "all_gather", "exchange_partitions", "gather_to", "place_scans",
    "build_shard_store", "SocketTransport", "connect_worker",
    "run_remote_worker",
]
