"""Multiprocess cluster runtime.

The process tree mirrors the reference's (SURVEY.md §3.1): a head with the
GCS (cluster control plane) and a raylet (node control plane) per node;
worker processes leased from the raylet execute tasks and host actors; a
shared-memory object store per node gives zero-copy reads; owners serve
small objects from an in-process memory store. Transport is asyncio TCP with
pickled frames (the gRPC role); the data plane between collocated processes
is /dev/shm.
"""
