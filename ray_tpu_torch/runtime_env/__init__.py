"""Per-task/actor/job runtime environments.

Reference analog: ``python/ray/_private/runtime_env/`` (architecture in its
``ARCHITECTURE.md``): ``working_dir.py`` + ``packaging.py`` (zip the project
dir into the GCS KV under a content-addressed ``gcs://`` URI, refcounted
node-local cache), ``pip.py`` (per-env python deps), worker-pool reuse keyed
by the env hash. Redesign: no separate per-node agent process — the worker
materializes its own env at startup (the raylet already spawns one worker
process per distinct env hash, so setup cost is paid once per (node, env)).
"""

from ray_tpu_torch.runtime_env.runtime_env import (  # noqa: F401
    RuntimeEnv,
    env_hash,
    materialize,
    package_working_dir,
    prepare_runtime_env,
)
