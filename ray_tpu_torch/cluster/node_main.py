"""Standalone node daemon: the process behind ``rt start``.

Reference analog: ``python/ray/_private/node.py`` (``start_head_processes
:1395``, ``start_ray_processes :1424``) — except the reference spawns
gcs_server/raylet as separate OS processes; here one daemon process hosts the
GCS (head only) and the raylet on a single asyncio loop. A worker-host daemon
(``--address``) joins an existing GCS over TCP, learning the session name
from the GCS KV — the path a second host takes to join the cluster.

State files land in ``<session_dir_root>/nodes/<node_id>.json`` (plus
``session_latest.json`` for the head) so ``rt status`` / ``rt stop`` /
``init(address="auto")`` can find the cluster without arguments.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import signal
import sys
import uuid
from typing import Dict, Optional

from ray_tpu_torch._private import accelerator
from ray_tpu_torch._private.config import get_config
from ray_tpu_torch.cluster.object_store import SESSION_PREFIX
from ray_tpu_torch.core import resources as res


def state_dir() -> str:
    return os.path.join(get_config().session_dir_root, "nodes")


def session_latest_path() -> str:
    return os.path.join(get_config().session_dir_root, "session_latest.json")


def read_session_latest() -> Optional[Dict]:
    """The head's state file, when it names a session of this runtime: a
    state file of JAX's runtime (a session root shared through
    ``RT_SESSION_DIR_ROOT``) is never attached to."""
    try:
        with open(session_latest_path()) as f:
            latest = json.load(f)
    except (FileNotFoundError, ValueError):
        return None
    if not str(latest.get("session_name", "")).startswith(SESSION_PREFIX):
        return None
    return latest


def node_resources(num_cpus: Optional[float], num_gpus: Optional[float],
                   extra: Optional[Dict[str, float]]) -> Dict[str, float]:
    total = {
        res.CPU: num_cpus if num_cpus is not None else (os.cpu_count() or 1),
        res.GPU: num_gpus if num_gpus is not None
        else accelerator.autodetect_num_gpus(),
        res.MEMORY: float(os.sysconf("SC_PAGE_SIZE")
                          * os.sysconf("SC_PHYS_PAGES")),
    }
    total.update(extra or {})
    return {k: v for k, v in total.items() if v}


async def _amain(args: argparse.Namespace) -> None:
    from ray_tpu_torch.cluster.gcs import GcsServer
    from ray_tpu_torch.cluster.raylet import Raylet
    from ray_tpu_torch.cluster.rpc import RpcClient, RpcServer

    # Marks this process as a standalone node daemon: destructive chaos
    # sites (gcs.kill) are only allowed to os._exit here, never inside a
    # driver-hosted in-process control plane (util/chaos.py).
    os.environ["RT_NODE_DAEMON"] = "1"

    loop = asyncio.get_running_loop()
    stop_ev = asyncio.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        loop.add_signal_handler(sig, stop_ev.set)

    # Bind interface for EVERY server this node tree runs (GCS, raylet,
    # workers via RT_CONFIG_JSON): rt start --host 0.0.0.0 makes them all
    # reachable cross-host, advertising the outbound IP.
    if args.host and args.host != "127.0.0.1":
        get_config().bind_host = args.host

    gcs = gcs_server = None
    session_name = args.session_name
    gcs_address = args.address
    if args.head:
        session_name = session_name or f"{SESSION_PREFIX}{uuid.uuid4().hex[:12]}"
        # Same --session-name across head restarts => same snapshot file:
        # actors/PGs/KV survive the restart (GCS fault tolerance).
        persist = os.path.join(get_config().session_dir_root, session_name,
                               "gcs_snapshot.pkl")
        gcs = GcsServer(persist_path=persist)
        gcs_server = RpcServer(loop)
        gcs_server.register_object(gcs)
        await gcs_server.start(args.port)
        gcs.start_monitor()
        gcs_address = gcs_server.address
        gcs.kv["@session/name"] = session_name.encode()
    else:
        client = RpcClient(gcs_address, peer_id="node-join")
        await client.connect()
        reply = await client.call("kv_get", {"key": "@session/name"})
        val = reply.get("value")
        session_name = session_name or (
            val.decode() if isinstance(val, bytes) else val) or f"{SESSION_PREFIX}shared"
        await client.close()

    node_id = uuid.uuid4().hex
    labels = {}
    if args.labels:
        labels.update(json.loads(args.labels))
    labels["session"] = session_name
    if args.head:
        labels["node_role"] = "head"
    resources = node_resources(args.num_cpus, args.num_gpus,
                               json.loads(args.resources)
                               if args.resources else None)
    raylet = Raylet(node_id, session_name, gcs_address, resources, labels,
                    loop)
    await raylet.start()

    state = {
        "pid": os.getpid(), "node_id": node_id, "head": bool(args.head),
        "gcs_address": gcs_address,
        "raylet_address": raylet.server.address,
        "session_name": session_name,
        "resources": resources,
    }
    os.makedirs(state_dir(), exist_ok=True)
    state_path = os.path.join(state_dir(), f"{node_id}.json")
    # rt: lint-allow(event-loop-blocking) one-shot boot bookkeeping: two
    # tiny local writes before the daemon starts serving anything
    with open(state_path, "w") as f:
        json.dump(state, f)
    if args.head:
        # rt: lint-allow(event-loop-blocking) same boot-time write
        with open(session_latest_path(), "w") as f:
            json.dump(state, f)
    # The launching `rt start` blocks on this line.
    print("RT_NODE_READY " + json.dumps(state), flush=True)

    await stop_ev.wait()
    try:
        await raylet.stop()
        if gcs is not None:
            await gcs.stop()
            await gcs_server.stop()
    finally:
        try:
            os.unlink(state_path)
        except FileNotFoundError:
            pass
        if args.head:
            try:
                os.unlink(session_latest_path())
            except FileNotFoundError:
                pass


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="rt-node")
    p.add_argument("--head", action="store_true")
    p.add_argument("--address", default=None,
                   help="GCS address of an existing head to join")
    p.add_argument("--host", default="127.0.0.1",
                   help="bind host for the head GCS (0.0.0.0 for multi-host)")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--num-cpus", type=float, default=None)
    p.add_argument("--num-gpus", type=float, default=None)
    p.add_argument("--resources", default=None, help="JSON dict of extras")
    p.add_argument("--labels", default=None,
                   help="JSON dict of node labels (e.g. tpu-slice-name from "
                        "a pod-slice provider) merged over autodetected ones")
    p.add_argument("--session-name", default=None)
    args = p.parse_args(argv)
    if not args.head and not args.address:
        p.error("pass --head or --address=<gcs>")
    asyncio.run(_amain(args))


if __name__ == "__main__":
    main()
