"""External-env policy serving: train on envs that live OUTSIDE the
process (simulators, games, real systems) and connect over HTTP (the
port's ``ray_tpu/rl/policy_server.py``).

Reference analog: ``rllib/env/policy_server_input.py`` +
``policy_client.py``. External simulators drive episodes with
``start_episode`` / ``get_action`` / ``log_returns`` / ``end_episode``,
and the experiences feed training.

:class:`ExternalEnvRunner` has the sampling surface of
:class:`ray_tpu_torch.rl.env_runner.EnvRunner` (``sample(params)``
returns a columnar batch with GAE), so on-policy algorithms swap it in by
setting ``config.env = "external://<port>"``. JAX's runner is an actor
serving aiohttp; the port's is an actor too where its runtime is
initialized (the algorithm reads ``server_ports`` from ``ready.remote()``;
killing the actor closes the server), else a plain object in the
algorithm's process. It serves JAX's four routes, JSON bodies and status
codes from a ``http.server.ThreadingHTTPServer`` on 127.0.0.1 in a daemon
thread. The handler threads and ``sample`` share the episode state under
one lock. Inference runs the port's ``rl/models.py`` policy on the
runner's device, its draws from the runner's ``torch.Generator``
(``models.gumbel`` for categorical actions, ``models.normal`` for
Gaussian ones). :class:`PolicyClient` is the simulator's side, on
``urllib.request``.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.rl import models
from ray_tpu_torch.rl.env import EnvSpec
from ray_tpu_torch.rl.env_runner import compute_gae

ROUTES = ("start", "action", "rewards", "end")


class ExternalEnvRunner:
    """Serves get_action over HTTP; buffers the resulting transitions.

    ``sample(params)`` installs fresh policy params, then blocks until
    ``rollout_len * num_slots`` external steps accumulate and returns the
    standard columnar batch (advantages computed per completed episode
    segment). It waits as long as that takes, as JAX does; ``shutdown``
    ends the wait with a ``RuntimeError``."""

    def __init__(self, port: int, spec: Dict[str, Any], rollout_len: int,
                 num_slots: int = 1, gamma: float = 0.99,
                 lam: float = 0.95, seed: int = 0,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.spec = EnvSpec(**spec)
        self._target_steps = rollout_len * num_slots
        self._gamma, self._lam = gamma, lam
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._lock = threading.Lock()
        self._params = None  # rt: guarded-by(_lock)
        self._episodes: Dict[str, Dict[str, Any]] = {}  # rt: guarded-by(_lock)
        self._done_rows: List[Dict[str, np.ndarray]] = []  # rt: guarded-by(_lock)
        self._steps_buffered = 0  # rt: guarded-by(_lock)
        self._completed_returns: List[float] = []  # rt: guarded-by(_lock)
        self._port = port
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._stopped = threading.Event()

    @torch.no_grad()
    def _act(self, params, obs: np.ndarray
             ) -> Tuple[np.ndarray, float, float]:
        """One action for ``obs`` [obs_dims]: (action, its log-prob, the
        state's value). Called under ``_lock``: the generator's draws are
        serialized."""
        x = torch.as_tensor(obs[None], device=self.device)
        logits = models.policy_logits(params, x)
        vals = models.value(params, x)
        if self.spec.discrete:
            actions = models.categorical_sample(self._gen, logits)
            logp = models.categorical_logp(logits, actions)
        else:
            std = torch.exp(params["log_std"])
            actions = logits + std * models.normal(self._gen, logits.shape)
            logp = models.gaussian_logp(logits, params["log_std"], actions)
        return (actions[0].cpu().numpy(), float(logp[0]), float(vals[0]))

    def ready(self) -> int:
        """Bind the server (once) and return its port."""
        if self._server is not None:
            return self._server.server_address[1]
        runner = self

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):
                parts = self.path.strip("/").split("/")
                if len(parts) != 3 or parts[0] != "episodes" \
                        or parts[2] not in ROUTES:
                    self._reply(404, {"error": "not found"})
                    return
                n = int(self.headers.get("Content-Length") or 0)
                raw = self.rfile.read(n) if n else b""
                try:
                    status, payload = runner.handle(parts[2], parts[1], raw)
                except (ValueError, KeyError, TypeError) as e:
                    # a malformed body from the simulator
                    status, payload = 400, {"error": repr(e)}
                self._reply(status, payload)

            def _reply(self, status: int, payload: Dict) -> None:
                data = json.dumps(payload).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def log_message(self, *args) -> None:  # no access log
                pass

        server = ThreadingHTTPServer(("127.0.0.1", self._port), Handler)
        server.daemon_threads = True
        self._server = server
        self._thread = threading.Thread(target=server.serve_forever,
                                        name="rtt-policy-server",
                                        daemon=True)
        self._thread.start()
        return server.server_address[1]

    def shutdown(self) -> None:
        """Stop serving and close the socket; a waiting ``sample`` raises."""
        self._stopped.set()
        server, self._server = self._server, None
        if server is not None:
            server.shutdown()
            server.server_close()
            self._thread.join(timeout=10)

    # ---- HTTP routes ------------------------------------------------------
    def handle(self, route: str, eid: str, raw: bytes
               ) -> Tuple[int, Dict[str, Any]]:
        """One request: (status, JSON reply) of JAX's handlers."""
        with self._lock:
            if route == "start":
                self._episodes[eid] = {"obs": [], "actions": [], "logp": [],
                                       "values": [], "rewards": [],
                                       "return": 0.0}
                return 200, {"ok": True}
            if route == "end":
                ep = self._episodes.pop(eid, None)
                if ep is None:
                    return 404, {"error": "unknown episode"}
                self._finish_episode_locked(ep, terminal=True)
                return 200, {"ok": True}
            ep = self._episodes.get(eid)
            if ep is None:
                return 404, {"error": "unknown episode"}
            body = json.loads(raw or b"{}")
            if route == "rewards":
                r = float(body["reward"])
                ep["rewards"].append(r)
                ep["return"] += r
                return 200, {"ok": True}
            obs = np.asarray(body["obs"], dtype=np.float32)
            if self._params is None:
                return 503, {"error": "no policy yet"}
            a, logp, val = self._act(self._params, obs)
            ep["obs"].append(obs)
            ep["actions"].append(a)
            ep["logp"].append(logp)
            ep["values"].append(val)
            action = a.tolist() if not self.spec.discrete else int(a)
            return 200, {"action": action}

    def _finish_episode_locked(self, ep: Dict, terminal: bool) -> int:
        """Consume the first T complete (action, reward) steps into a
        training segment; returns T so a mid-episode cut can leave the
        incomplete tail (an action whose reward hasn't arrived) in place
        — discarding it would misalign every later reward by one step.
        JAX's ``_finish_episode``; called under ``_lock``."""
        T = min(len(ep["rewards"]), len(ep["actions"]))
        if T == 0:
            return 0
        rewards = np.asarray(ep["rewards"][:T], np.float32).reshape(T, 1)
        values = np.asarray(ep["values"][:T], np.float32).reshape(T, 1)
        dones = np.zeros((T, 1), dtype=bool)
        if terminal:
            dones[-1] = True
        # bootstrap a mid-episode cut from the NEXT state's value when the
        # pending tail holds one, else from the last consumed state
        if terminal:
            last_v = np.zeros(1, np.float32)
        elif len(ep["values"]) > T:
            last_v = np.asarray([ep["values"][T]], np.float32)
        else:
            last_v = values[-1]
        gae = compute_gae(rewards, values, dones, last_v,
                          self._gamma, self._lam)
        obs = np.asarray(ep["obs"][:T], np.float32)
        acts = np.asarray(ep["actions"][:T])
        next_obs = np.concatenate([obs[1:], obs[-1:]], axis=0)
        self._done_rows.append({
            "obs": obs, "actions": acts,
            "actions_executed": acts,
            "logp": np.asarray(ep["logp"][:T], np.float32),
            "values": values[:, 0], "rewards": rewards[:, 0],
            "dones": dones[:, 0], "next_obs": next_obs,
            "advantages": gae["advantages"][:, 0],
            "value_targets": gae["value_targets"][:, 0],
        })
        self._steps_buffered += T
        if terminal:
            self._completed_returns.append(ep["return"])
        return T

    # ---- EnvRunner protocol ----------------------------------------------
    def get_spec(self):
        return self.spec

    def _total_steps_locked(self) -> int:
        """Buffered steps plus the complete steps of OPEN episodes: an
        episode longer than the target (a trained CartPole balancing
        forever, any continuing task) must still cut, like the
        reference's rollout_fragment_length cut mid-episode. Called under
        ``_lock``."""
        open_steps = sum(min(len(ep["rewards"]), len(ep["actions"]))
                         for ep in self._episodes.values())
        return self._steps_buffered + open_steps

    def sample(self, params) -> Dict[str, np.ndarray]:
        with self._lock:
            self._params = params
        while True:
            with self._lock:
                if self._total_steps_locked() >= self._target_steps:
                    # cut still-open episodes at their last COMPLETE step;
                    # the incomplete tail (action awaiting its reward)
                    # stays in place
                    for ep in list(self._episodes.values()):
                        t = self._finish_episode_locked(ep, terminal=False)
                        if t:
                            for k in ("obs", "actions", "logp", "values",
                                      "rewards"):
                                ep[k] = ep[k][t:]
                    rows, self._done_rows = self._done_rows, []
                    self._steps_buffered = 0
                    break
            if self._stopped.wait(0.02):
                raise RuntimeError(
                    f"external env: shut down with fewer than "
                    f"{self._target_steps} steps")
        return {k: np.concatenate([r[k] for r in rows]) for k in rows[0]}

    def pop_connector_deltas(self):
        return None

    def set_connector_globals(self, states) -> None:
        pass

    def episode_stats(self) -> Dict[str, float]:
        with self._lock:
            completed, self._completed_returns = self._completed_returns, []
        if not completed:
            return {"episodes": 0, "mean_return": float("nan")}
        return {"episodes": len(completed),
                "mean_return": float(np.mean(completed))}


class PolicyClient:
    """The external simulator's side (reference: ``policy_client.py``),
    on ``urllib.request``: a 503 (no policy installed yet) is retried
    every 0.2 s, up to ``retries`` times; any other error status raises
    ``urllib.error.HTTPError``."""

    def __init__(self, address: str):
        self._base = address.rstrip("/")
        self._n = 0

    def _post(self, path: str, payload: Optional[Dict] = None,
              retries: int = 50) -> Dict:
        data = json.dumps(payload or {}).encode()
        for _ in range(retries):
            req = urllib.request.Request(
                f"{self._base}{path}", data=data, method="POST",
                headers={"Content-Type": "application/json"})
            try:
                with urllib.request.urlopen(req, timeout=30) as r:
                    return json.loads(r.read())
            except urllib.error.HTTPError as e:
                if e.code != 503:   # 503: policy not installed yet
                    raise
                e.close()
                time.sleep(0.2)
        raise TimeoutError(f"policy server never became ready: {path}")

    def start_episode(self, episode_id: Optional[str] = None) -> str:
        eid = episode_id or f"ep{self._n}"
        self._n += 1
        self._post(f"/episodes/{eid}/start")
        return eid

    def get_action(self, episode_id: str, obs) -> Any:
        reply = self._post(f"/episodes/{episode_id}/action",
                           {"obs": np.asarray(obs).tolist()})
        return reply["action"]

    def log_returns(self, episode_id: str, reward: float) -> None:
        self._post(f"/episodes/{episode_id}/rewards",
                   {"reward": float(reward)})

    def end_episode(self, episode_id: str, obs=None) -> None:
        self._post(f"/episodes/{episode_id}/end")
