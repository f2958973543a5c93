"""Cluster bring-up and the driver's backend.

Reference analog: ``python/ray/_private/node.py`` + ``services.py`` — the
process-tree orchestration behind ``ray.init()``. Redesign: the GCS and
raylets are asyncio components, so a "node" is a component on an event loop
rather than a forced OS process; the default ``init()`` hosts the GCS + head
raylet on the driver's background io thread and spawns real worker
subprocesses. ``cluster_utils.Cluster`` adds more (fake-resource) raylets on
the same loop for multi-node tests — the reference's trick of real control
planes with fake resource counts (SURVEY.md §4), with identical RPC paths to
a true multi-host deployment.
"""

from __future__ import annotations

import os
import time
import uuid
from typing import Dict, List, Optional

from ray_tpu_torch._private import accelerator
from ray_tpu_torch._private.config import get_config
from ray_tpu_torch._private.ids import JobID
from ray_tpu_torch.cluster.gcs import GcsServer
from ray_tpu_torch.cluster.object_store import SESSION_PREFIX
from ray_tpu_torch.cluster.raylet import Raylet
from ray_tpu_torch.cluster.rpc import EventLoopThread, RpcServer
from ray_tpu_torch.core import resources as res


class ClusterHandle:
    """Owns the in-process control-plane components (GCS + raylets)."""

    def __init__(self, session_name: Optional[str] = None):
        self.session_name = session_name or f"{SESSION_PREFIX}{uuid.uuid4().hex[:12]}"
        self.io = EventLoopThread(name="rt-cluster-io")
        self.gcs: Optional[GcsServer] = None
        self.gcs_address: Optional[str] = None
        self.raylets: List[Raylet] = []
        self._gcs_persist_path: Optional[str] = None

    def start_gcs(self, persist_path: Optional[str] = None) -> str:
        self._gcs_persist_path = persist_path

        async def _go():
            self.gcs = GcsServer(persist_path=persist_path)
            server = RpcServer(self.io.loop)
            server.register_object(self.gcs)
            await server.start()
            self.gcs.start_monitor()
            self._gcs_rpc_server = server
            return server.address

        self.gcs_address = self.io.run(_go())
        return self.gcs_address

    def kill_gcs(self) -> None:
        """Chaos helper: take the head down (RPC server closed, component
        stopped). Clients see ConnectionLost; WAL-backed state survives."""
        async def _go():
            await self._gcs_rpc_server.stop()
            await self.gcs.stop()

        self.io.run(_go())
        self.gcs = None

    def restart_gcs(self) -> str:
        """Bring the head back ON THE SAME ADDRESS with the persisted
        state; live raylets reconnect (RpcClient auto_reconnect) and
        re-register via the heartbeat 'unknown' path."""
        port = int(self.gcs_address.rsplit(":", 1)[1])

        async def _go():
            self.gcs = GcsServer(persist_path=self._gcs_persist_path)
            server = RpcServer(self.io.loop)
            server.register_object(self.gcs)
            await server.start(port=port)
            self.gcs.start_monitor()
            self._gcs_rpc_server = server
            return server.address

        self.gcs_address = self.io.run(_go())
        return self.gcs_address

    def add_node(self, num_cpus: Optional[float] = None,
                 num_gpus: Optional[float] = None,
                 resources: Optional[Dict[str, float]] = None,
                 labels: Optional[Dict[str, str]] = None) -> Raylet:
        total = {
            res.CPU: num_cpus if num_cpus is not None else (os.cpu_count() or 1),
            res.GPU: num_gpus if num_gpus is not None
            else accelerator.autodetect_num_gpus(),
            res.MEMORY: float(os.sysconf("SC_PAGE_SIZE")
                              * os.sysconf("SC_PHYS_PAGES")),
        }
        total.update(resources or {})
        total = {k: v for k, v in total.items() if v}
        node_labels = dict(labels or {})
        node_id = uuid.uuid4().hex

        async def _go():
            raylet = Raylet(node_id, self.session_name, self.gcs_address,
                            total, node_labels, self.io.loop)
            await raylet.start()
            return raylet

        raylet = self.io.run(_go())
        self.raylets.append(raylet)
        return raylet

    def remove_node(self, raylet: Raylet) -> None:
        async def _go():
            await self.gcs._mark_node_dead(
                self.gcs.nodes[raylet.node_id], "removed")
            await raylet.stop()

        self.io.run(_go())
        self.raylets.remove(raylet)

    def shutdown(self) -> None:
        async def _go():
            for raylet in self.raylets:
                try:
                    await raylet.stop()
                except Exception:
                    pass
            try:
                if self.gcs is not None:
                    await self.gcs.stop()
                await self._gcs_rpc_server.stop()
            except Exception:
                pass

        try:
            self.io.run(_go(), timeout=get_config().graceful_shutdown_timeout_s)
        except Exception:
            pass
        # Session owner: remove the shared shm dir once, after all nodes stop.
        if self.raylets:
            try:
                self.raylets[0].store.destroy()
            except Exception:
                pass
        self.raylets.clear()
        self.io.stop()


def start_or_connect(address: Optional[str], job_id: JobID, *,
                     num_cpus: Optional[float] = None,
                     num_gpus: Optional[float] = None,
                     resources: Optional[Dict[str, float]] = None,
                     namespace: Optional[str] = None):
    from ray_tpu_torch.cluster.worker_core import ClusterBackend

    if address == "auto":
        from ray_tpu_torch.cluster import node_main

        latest = node_main.read_session_latest()
        if latest is None:
            raise ConnectionError(
                "init(address='auto'): no running cluster found "
                "(start one with `rt start --head`)")
        address = latest["gcs_address"]
    if address and address.startswith("rt://"):
        # Ray-Client analog: rt://<gcs-host:port> — attach WITHOUT shared shm
        return connect_existing(address[len("rt://"):], job_id,
                                namespace=namespace, client_mode=True)
    if address is None:
        cluster = ClusterHandle()
        cluster.start_gcs()
        raylet = cluster.add_node(num_cpus=num_cpus, num_gpus=num_gpus,
                                  resources=resources)
        backend = ClusterBackend(
            gcs_address=cluster.gcs_address,
            raylet_address=raylet.server.address,
            node_id=raylet.node_id,
            session_name=cluster.session_name,
            job_id=job_id, role="driver", namespace=namespace)
        backend.connect()
        backend._cluster_shutdown_hook = cluster.shutdown
        backend._cluster = cluster
        return backend
    return connect_existing(address, job_id, namespace=namespace)


def connect_existing(gcs_address: str, job_id: JobID, *,
                     namespace: Optional[str] = None,
                     client_mode: bool = False):
    """Attach a driver to a running cluster: pick a raylet from the node
    table (head node preferred) and join its session. ``client_mode``
    (the reference's Ray Client): this process shares NO /dev/shm with the
    cluster — large objects travel via the raylet's chunked put/get RPCs,
    so a laptop can drive a remote GPU cluster over plain TCP."""
    import asyncio

    from ray_tpu_torch.cluster.rpc import RpcClient
    from ray_tpu_torch.cluster.worker_core import ClusterBackend

    io = EventLoopThread(name="rt-driver-io")

    async def _discover():
        client = RpcClient(gcs_address, peer_id="driver-discover")
        await client.connect()
        deadline = time.monotonic() + get_config().gcs_rpc_timeout_s
        while time.monotonic() < deadline:
            nodes = await client.call("list_nodes", {})
            alive = [n for n in nodes if n["alive"]]
            if alive:
                await client.close()
                return alive[0]
            await asyncio.sleep(0.2)
        raise TimeoutError(f"no alive nodes at GCS {gcs_address}")

    node = io.run(_discover())
    # Session name comes through the raylet's node entry labels if remote;
    # same-host drivers read it from the env set by `rt start` (not ported yet, R5).
    session_name = os.environ.get("RT_SESSION_NAME",
                                  node.get("labels", {}).get("session", ""))
    backend = ClusterBackend(
        gcs_address=gcs_address,
        raylet_address=node["address"],
        node_id=node["node_id"],
        session_name=session_name or f"{SESSION_PREFIX}shared",
        job_id=job_id, role="client" if client_mode else "driver",
        namespace=namespace, loop_thread=io,
        shared_store=not client_mode)
    backend.connect()
    return backend
