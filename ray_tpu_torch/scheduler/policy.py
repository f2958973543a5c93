"""Node-selection policies.

Reference analog: ``src/ray/raylet/scheduling/policy/`` — the hybrid policy's
rationale (``hybrid_scheduling_policy.h:29-48``) is kept: prefer nodes that
can run the task NOW over merely-feasible ones; rank by critical-resource
utilization truncated below a spread threshold (so lightly-loaded nodes tie
and small tasks pack rather than fragment); break ties randomly among the
top candidates with the local/preferred node winning outright ties.
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional, Tuple

from ray_tpu_torch._private.config import get_config
from ray_tpu_torch.core.resources import NodeResources, ResourceSet


class HybridPolicy:
    def pick(self, nodes: Dict[str, NodeResources], req: ResourceSet,
             preferred: Optional[str] = None,
             rng: Optional[random.Random] = None) -> Optional[str]:
        cfg = get_config()
        rng = rng or random
        available: List[Tuple[float, str]] = []
        feasible: List[str] = []
        for node_id, nr in nodes.items():
            if not nr.is_feasible(req):
                continue
            feasible.append(node_id)
            if nr.can_fit(req):
                util = nr.utilization(req)
                if util < cfg.scheduler_spread_threshold:
                    util = 0.0  # truncate: lightly-loaded nodes tie
                available.append((util, node_id))
        if available:
            # Rank by critical-resource utilization and pick randomly among
            # the TOP-K (reference hybrid_scheduling_policy.h:29-48): pure
            # best-node packing funnels every scheduler's next task at the
            # same node (noisy neighbor, worker-pool cold-start pileup);
            # pure random fragments. The preferred/local node wins outright
            # ties at the best score.
            available.sort()
            best = available[0][0]
            if any(n == preferred and u == best for u, n in available):
                return preferred
            n_tied = sum(1 for u, _ in available if u == best)
            k = max(1, n_tied,
                    int(cfg.scheduler_top_k_fraction * len(available) + .999))
            return rng.choice([n for _, n in available[:k]])
        if feasible:
            # Nothing can run it now; queue at a feasible node (prefer local).
            if preferred in feasible:
                return preferred
            return rng.choice(feasible)
        return None


class SpreadPolicy:
    """Round-robin across nodes that can fit (reference:
    ``spread_scheduling_policy.h:27``)."""

    def __init__(self):
        self._rr = 0

    def pick(self, nodes, req, preferred=None, rng=None):
        fitting = sorted(n for n, nr in nodes.items() if nr.can_fit(req))
        if not fitting:
            fitting = sorted(n for n, nr in nodes.items() if nr.is_feasible(req))
        if not fitting:
            return None
        self._rr += 1
        return fitting[self._rr % len(fitting)]


class NodeAffinityPolicy:
    def __init__(self, node_id: str, soft: bool):
        self.node_id = node_id
        self.soft = soft

    def pick(self, nodes, req, preferred=None, rng=None):
        nr = nodes.get(self.node_id)
        if nr is not None and nr.is_feasible(req):
            return self.node_id
        if self.soft:
            return HybridPolicy().pick(nodes, req, preferred, rng)
        return None


def _label_matches(expr, value: Optional[str]) -> bool:
    """One label match expression against a node's label value (None =
    absent). See ``NodeLabelStrategy`` for the expression forms."""
    if isinstance(expr, (list, tuple, set)):
        return value is not None and value in expr
    if expr == "*":
        return value is not None
    if expr == "!*":
        return value is None
    if isinstance(expr, str) and expr.startswith("!"):
        return value != expr[1:]
    return value == expr


class NodeLabelPolicy:
    """Hard label constraints filter; soft constraints prefer (reference:
    ``NodeLabelSchedulingPolicy`` — hard eliminates, soft splits the
    survivors into preferred/fallback tiers). Within a tier, the hybrid
    ranking applies."""

    def __init__(self, hard: Dict, soft: Dict):
        self.hard = hard or {}
        self.soft = soft or {}

    def _matches(self, nr, constraints: Dict) -> bool:
        return all(_label_matches(expr, nr.labels.get(key))
                   for key, expr in constraints.items())

    def pick(self, nodes, req, preferred=None, rng=None):
        hard_ok = {nid: nr for nid, nr in nodes.items()
                   if self._matches(nr, self.hard)}
        if not hard_ok:
            return None  # infeasible until a matching node joins
        if self.soft:
            soft_ok = {nid: nr for nid, nr in hard_ok.items()
                       if self._matches(nr, self.soft)}
            picked = HybridPolicy().pick(soft_ok, req, preferred, rng) \
                if soft_ok else None
            # a soft preference only holds if its node can run the task
            # NOW — a full soft-matching node must not shadow an idle
            # hard-tier node (HybridPolicy returns queue targets too)
            if picked is not None and soft_ok[picked].can_fit(req):
                return picked
        return HybridPolicy().pick(hard_ok, req, preferred, rng)


def strategy_allows_local(strategy, node_id: str,
                          labels: Dict[str, str]) -> bool:
    """May a raylet dispatch this task on ITS OWN node, or must it route?

    Hard NODE_AFFINITY to another node and unsatisfied hard NODE_LABEL
    constraints forbid local execution (reference: these policies filter
    the candidate set BEFORE dispatch; here raylet-push means the local
    queue sees every task first and must decline ineligible ones)."""
    kind = getattr(strategy, "kind", "DEFAULT")
    if kind == "NODE_AFFINITY" and not strategy.soft:
        return strategy.node_id_hex == node_id
    if kind == "NODE_LABEL":
        return all(_label_matches(expr, labels.get(key))
                   for key, expr in (strategy.hard or {}).items())
    return True


# Module-level instance so the round-robin counter persists across calls.
_SPREAD = SpreadPolicy()


def pick_node(strategy, nodes: Dict[str, NodeResources], req: ResourceSet,
              preferred: Optional[str] = None) -> Optional[str]:
    """Dispatch on a TaskSpec SchedulingStrategy."""
    kind = getattr(strategy, "kind", "DEFAULT")
    if kind == "SPREAD":
        return _SPREAD.pick(nodes, req, preferred)
    if kind == "NODE_AFFINITY":
        return NodeAffinityPolicy(strategy.node_id_hex, strategy.soft).pick(
            nodes, req, preferred)
    if kind == "NODE_LABEL":
        return NodeLabelPolicy(strategy.hard, strategy.soft).pick(
            nodes, req, preferred)
    return HybridPolicy().pick(nodes, req, preferred)
