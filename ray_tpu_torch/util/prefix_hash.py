"""Chunk-aligned prompt-prefix digests: the shared vocabulary of the
KV-reuse plane (the port's own copy of ``ray_tpu/util/prefix_hash.py``).

Three layers must agree on what "the same prefix" means for cache keys to
line up end to end:

  - the engine's :class:`~ray_tpu_torch.models.serving.PrefixKVCache` keys
    its retained KV pages by chunk-aligned token prefixes,
  - the replica reports its resident prefixes as short digests,
  - the serve router hashes an incoming request's prompt the same way
    and biases power-of-two routing toward replicas already holding the
    longest matching prefix.

The router hashes prompts with the JAX package's module, so every key and
digest here is byte-identical to it (``tests/test_torch_prefix_cache.py``
holds that): pure python, one digest function, one chunk-size knob
(``RT_KV_CHUNK``, tokens per chunk; the engine and the router both read
it so the two sides cannot drift).
"""

from __future__ import annotations

import hashlib
import os
import struct
from typing import Any, Dict, List, Optional, Sequence, Tuple

_DEFAULT_CHUNK = 16
#: residency reports and request-side probes are bounded to this many
#: chunk digests — a router decision needs the longest few matches, not
#: the whole prompt
MAX_PROBE_CHUNKS = 32
#: bytes per token in a packed key (int32 little-endian) — key prefixes
#: slice at TOKEN_WIDTH * n_tokens
TOKEN_WIDTH = 4


def chunk_size() -> int:
    """Tokens per prefix chunk (``RT_KV_CHUNK``): prefixes are cached and
    matched at multiples of this."""
    try:
        return max(1, int(os.environ.get("RT_KV_CHUNK", _DEFAULT_CHUNK)))
    except ValueError:
        return _DEFAULT_CHUNK


def aligned_len(n: int, chunk: Optional[int] = None) -> int:
    """Largest chunk multiple <= n."""
    c = chunk or chunk_size()
    return (n // c) * c


def token_key(tokens: Sequence[int], n: int) -> bytes:
    """Exact byte key of ``tokens[:n]`` (int32 little-endian) — collision-
    free equality, used as the engine cache's index key."""
    return struct.pack(f"<{n}i", *[int(t) for t in tokens[:n]])


def prefix_digest(tokens: Sequence[int], n: int) -> str:
    """Short stable digest of ``tokens[:n]`` for residency reports (16
    hex chars of sha1 — a report row, not a security boundary)."""
    return hashlib.sha1(token_key(tokens, n)).hexdigest()[:16]


def chunked_digests(key: bytes, chunk: int) -> List[str]:
    """Digests of every chunk-aligned prefix of an already-packed token
    key, SHORTEST first — ONE incremental sha1 pass over the buffer
    instead of re-hashing each prefix from scratch (O(n) not O(n^2))."""
    w = TOKEN_WIDTH * chunk
    h = hashlib.sha1()
    out: List[str] = []
    for off in range(0, len(key) - len(key) % w, w):
        h.update(key[off:off + w])
        out.append(h.copy().hexdigest()[:16])
    return out


def prompt_digests(tokens: Sequence[int],
                   chunk: Optional[int] = None,
                   max_chunks: int = MAX_PROBE_CHUNKS) -> List[str]:
    """Digests of chunk-aligned prefixes of ``tokens``, LONGEST FIRST
    (the router scores a replica by the first — longest — digest it
    holds). At most ``max_chunks`` entries; when the prompt has more
    aligned prefixes than that, the probe keeps BOTH ends — the longest
    (session-replay residency) and the shortest (a short shared system
    prompt under a long unique tail; truncating longest-only would
    silently zero affinity for exactly that trace). One packed buffer,
    one incremental sha1 pass."""
    c = chunk or chunk_size()
    n = aligned_len(len(tokens), c)
    nchunks = n // c
    if nchunks <= 0:
        return []
    keep = None
    if nchunks > max_chunks:
        head = max_chunks // 2
        keep = set(range(1, head + 1)) | set(
            range(nchunks - (max_chunks - head) + 1, nchunks + 1))
    buf = token_key(tokens, n)
    w = TOKEN_WIDTH * c
    h = hashlib.sha1()
    out: List[str] = []
    for i in range(1, nchunks + 1):
        h.update(buf[(i - 1) * w:i * w])
        if keep is None or i in keep:
            out.append(h.copy().hexdigest()[:16])
    return out[::-1]


def request_prefix_digests(args: Tuple, kwargs: Dict[str, Any]
                           ) -> Optional[List[str]]:
    """Best-effort prefix probe for a handle call: when the request body
    follows the LLM protocol (a dict with a ``tokens`` list, as
    ``serve/llm.py``'s ``_parse_request`` takes), return its prompt's
    chunk digests longest-first; None for any other call shape (the
    router then routes load-only).

    Deliberately shallow: one isinstance walk over the top-level args, no
    JSON parsing — this runs on the routing hot path for EVERY handle
    call, LLM or not."""
    for v in list(args) + list(kwargs.values()):
        if isinstance(v, dict):
            toks = v.get("tokens")
        else:
            toks = getattr(v, "_rt_prefix_tokens", None)
        if (isinstance(toks, (list, tuple)) and toks
                and all(isinstance(t, int) for t in toks[:4])):
            try:
                digests = prompt_digests(toks)
            except Exception:  # noqa: BLE001 — non-conforming payload
                # (mixed types past the probe, ints outside int32): this
                # is a ROUTING probe — never fail the request, route
                # load-only instead
                return None
            return digests or None
    return None
