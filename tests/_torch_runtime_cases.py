"""Programs the runtime parity tests feed to both runtimes, ``ray_tpu``
and ``ray_tpu_torch``, in turn.

This module imports neither package (nor jax): each program takes the
runtime's package name and imports it by name, so a worker of the port's
cluster that runs one of these functions never imports jax or
``ray_tpu``. The tests register the module with cloudpickle by value,
because worker processes cannot import it by name.

Every program returns plain data (lists, numbers, strings, numpy arrays)
for the test to compare across the two runtimes.
"""

from __future__ import annotations

import importlib
import os
import sys
import time


def _rt(pkg):
    return importlib.import_module(pkg)


def _exc(e):
    """An exception as (type name, first line of its message)."""
    return type(e).__name__, str(e).splitlines()[0] if str(e) else ""


# ---- remote functions and classes -----------------------------------------

def square(x):
    return x * x


def squares_stream(n):
    for i in range(n):
        yield i * i


def divmod_pair(a, b):
    return divmod(a, b)


def nested_sum(pkg, n):
    rt = _rt(pkg)
    return sum(rt.get([rt.remote(square).remote(i) for i in range(n)]))


def nested_twice(pkg, n):
    rt = _rt(pkg)
    return rt.get(rt.remote(nested_sum).remote(pkg, n)) + 1


def sleeper(s, tag):
    time.sleep(s)
    return tag


def array_stats(a):
    return float(a.sum()), a.dtype.str, a.shape


def tensor_double(t):
    return t * 2, str(t.dtype), tuple(t.shape)


def fail(msg):
    raise ValueError(msg)


def fail_downstream(x):
    return x + 1


def worker_modules():
    """The worker's view of itself: what it imported and its pid."""
    roots = sorted({m.split(".")[0] for m in sys.modules})
    return {"roots": [r for r in roots if r in ("jax", "jaxlib", "ray_tpu",
                                                 "ray_tpu_torch", "torch")],
            "pid": os.getpid()}


def accelerator_ids(pkg):
    """The accelerator indices this worker holds, as its runtime pins them:
    JAX's TPU chips, the port's GPUs."""
    ctx = _rt(pkg).get_runtime_context()
    ids = ctx.get_tpu_ids() if pkg == "ray_tpu" else ctx.get_gpu_ids()
    return [int(i) for i in ids]


class Counter:
    def __init__(self, start=0):
        self.n = start

    def inc(self, by=1):
        self.n += by
        return self.n

    def value(self):
        return self.n

    def pid(self):
        return os.getpid()

    def crash(self):
        os._exit(1)

    def fail(self, msg):
        raise KeyError(msg)


class Holder:
    """An actor that holds accelerators and reports which."""

    def __init__(self, pkg):
        self.pkg = pkg

    def ids(self):
        return accelerator_ids(self.pkg)


# ---- programs ---------------------------------------------------------------

def tasks(pkg):
    rt = _rt(pkg)
    f = rt.remote(square)
    out = {"map": rt.get([f.remote(i) for i in range(8)])}
    out["chained"] = rt.get(f.remote(f.remote(3)))
    q, r = rt.remote(num_returns=2)(divmod_pair).remote(17, 5)
    out["two_returns"] = [rt.get(q), rt.get(r)]
    out["options"] = rt.get(f.options(num_cpus=2).remote(7))
    return out


def nested(pkg):
    rt = _rt(pkg)
    return {"one_level": rt.get(rt.remote(nested_sum).remote(pkg, 6)),
            "two_levels": rt.get(rt.remote(nested_twice).remote(pkg, 4))}


def wait(pkg):
    rt = _rt(pkg)
    s = rt.remote(sleeper)
    # two warm workers first: a cold start must not decide which is first
    rt.get([s.remote(0.5, "warm"), s.remote(0.5, "warm")])
    slow, fast = s.remote(3.0, "slow"), s.remote(0.0, "fast")
    ready, rest = rt.wait([slow, fast], num_returns=1, timeout=30)
    first = [rt.get(r) for r in ready]
    none_ready, _ = rt.wait([slow], num_returns=1, timeout=0.05)
    both, left = rt.wait([slow, fast], num_returns=2, timeout=30)
    return {"first": first, "rest": len(rest),
            "timed_out_ready": len(none_ready),
            "both": sorted(rt.get(both)), "left": len(left)}


def put_get_numpy(pkg):
    import numpy as np

    rt = _rt(pkg)
    small = np.arange(12, dtype=np.int32).reshape(3, 4)
    big = np.linspace(0.0, 1.0, 300_000)   # 2.4 MB: the shared store
    refs = [rt.put(small), rt.put(big)]
    got = rt.get(refs)
    stats = rt.get([rt.remote(array_stats).remote(r) for r in refs])
    return {"small": got[0], "big_equal": bool(np.array_equal(got[1], big)),
            "stats": [list(s) for s in stats],
            "nested": rt.get(rt.put({"a": [small, {"b": 1}]}))["a"][1]}


def put_get_tensor(pkg):
    import numpy as np
    import torch

    rt = _rt(pkg)
    g = torch.Generator().manual_seed(0)
    tensors = [torch.randn(3, 5, generator=g),
               torch.arange(40_000, dtype=torch.int64),   # 320 kB
               torch.ones(2, 3, dtype=torch.float64),
               torch.randn(4, 300, generator=g).to(torch.bfloat16)]
    out = {}
    for i, t in enumerate(tensors):
        back = rt.get(rt.put(t))
        doubled, dtype, shape = rt.get(rt.remote(tensor_double).remote(t))
        # numpy has no bfloat16: compare it widened, exactly
        out[i] = {"back": back.double().numpy(),
                  "doubled": doubled.double().numpy(),
                  "dtype": dtype, "back_dtype": str(back.dtype),
                  "shape": shape, "type": type(back).__name__}
    return out


def _aliased_tensors(n):
    """A tensor beside a view of it, itself again, its transpose, one
    parameter twice and a sparse tensor, in one value."""
    import torch

    a = torch.arange(n * 4, dtype=torch.float32).reshape(n, 4)
    p = torch.nn.Parameter(torch.ones(3))
    return {"a": a, "view": a[1:], "again": a, "t": a.t(), "p": p, "p2": p,
            "sparse": torch.sparse_coo_tensor([[0, 2]], [1.0, 2.0], (4,))}


def alias_facts(v):
    """What a value of :func:`_aliased_tensors` came back as: its values,
    which objects are one object, and whether writing through the tensor
    shows through its view."""
    facts = {"values": {k: v[k].detach().to_dense().tolist() for k in v},
             "types": {k: type(v[k]).__name__ for k in v},
             "layouts": {k: str(v[k].layout) for k in v},
             "again_is_a": v["again"] is v["a"], "p2_is_p": v["p2"] is v["p"],
             "requires_grad": v["p"].requires_grad}
    v["a"][1, 0] = -1.0
    facts["view_shares"] = v["view"][0, 0].item() == -1.0
    facts["t_shares"] = v["t"][0, 1].item() == -1.0
    return facts


def tensor_aliasing(pkg):
    rt = _rt(pkg)
    out = {}
    # 12 floats travel in the call; 80,000 (320 kB) through the shared store
    for n in (3, 20_000):
        out[n] = {"get": alias_facts(rt.get(rt.put(_aliased_tensors(n)))),
                  "task": rt.get(rt.remote(alias_facts).remote(
                      _aliased_tensors(n)))}
    return out


def named_actor(pkg):
    rt = _rt(pkg)
    c = rt.remote(Counter).options(name="parity_counter").remote(10)
    seq = rt.get([c.inc.remote() for _ in range(5)])
    again = rt.get_actor("parity_counter")
    seq.append(rt.get(again.inc.remote(5)))
    try:
        rt.get_actor("no_such_actor")
        missing = None
    except ValueError as e:
        missing = _exc(e)
    rt.kill(c)
    return {"seq": seq, "missing": missing}


def restarting_actor(pkg):
    rt = _rt(pkg)
    c = rt.remote(Counter).options(max_restarts=1).remote()
    before = rt.get([c.inc.remote(), c.inc.remote()])
    pid = rt.get(c.pid.remote())
    crash = c.crash.remote()
    try:
        rt.get(crash, timeout=60)
        crashed = None
    except Exception as e:  # noqa: BLE001 — the type is the result
        crashed = type(e).__name__
    after, deadline = None, time.monotonic() + 60
    while after is None and time.monotonic() < deadline:
        try:
            after = rt.get(c.inc.remote(), timeout=60)
        except Exception:  # noqa: BLE001 — still restarting
            time.sleep(0.2)
    new_pid = rt.get(c.pid.remote())
    rt.kill(c)
    return {"before": before, "crashed": crashed, "after": after,
            "new_process": new_pid != pid}


def kill_and_cancel(pkg):
    rt = _rt(pkg)
    c = rt.remote(Counter).remote()
    rt.get(c.inc.remote())
    rt.kill(c)
    try:
        rt.get(c.inc.remote(), timeout=60)
        killed = None
    except Exception as e:  # noqa: BLE001
        killed = type(e).__name__
    f = rt.remote(square)
    done = f.remote(4)
    rt.get(done)
    rt.cancel(done)                      # a finished task keeps its value
    running = rt.remote(sleeper).remote(0.5, "ran")
    time.sleep(0.2)
    rt.cancel(running)                   # a started one runs to its end
    try:
        rt.kill("not an actor")
        bad_kill = None
    except TypeError as e:
        bad_kill = _exc(e)
    return {"killed": killed, "done": rt.get(done),
            "running": rt.get(running, timeout=60), "bad_kill": bad_kill}


def errors(pkg):
    rt = _rt(pkg)
    exc = _rt(pkg + ".exceptions")
    out = {}
    ref = rt.remote(fail).remote("boom")
    try:
        rt.get(ref)
    except exc.TaskError as e:
        out["task"] = (_exc(e), e.function_name, type(e.cause).__name__,
                       "ValueError: boom" in e.remote_traceback)
    try:
        rt.get(rt.remote(fail_downstream).remote(ref))
    except exc.TaskError as e:
        out["propagated"] = _exc(e)
    c = rt.remote(Counter).remote()
    try:
        rt.get(c.fail.remote("k"))
    except exc.TaskError as e:
        out["actor_method"] = (_exc(e), e.function_name)
    out["actor_alive"] = rt.get(c.inc.remote())
    rt.kill(c)
    try:
        rt.get(rt.remote(sleeper).remote(5.0, "late"), timeout=0.1)
    except exc.GetTimeoutError as e:
        out["timeout"] = type(e).__name__
    try:
        rt.remote(square).options(num_returns=1, no_such_option=1)
    except Exception as e:  # noqa: BLE001
        # the message goes on to list the valid options, which differ:
        # the port's have no num_tpus
        kind, msg = _exc(e)
        out["bad_option"] = (kind, msg.split("[")[0])
    return out


def dag(pkg):
    """``.bind`` graphs: functions over an input, and an actor's methods."""
    rt = _rt(pkg)
    dagmod = _rt(pkg + ".dag")
    f = rt.remote(square)
    with dagmod.InputNode() as inp:
        graph = f.bind(f.bind(inp))
    out = {"functions": [rt.get(graph.execute(x)) for x in (2, 3)]}
    counter = rt.remote(Counter).bind(5)
    out["actor"] = rt.get(counter.inc.bind(counter.inc.bind(1)).execute())
    return out


PROGRAMS = ("tasks", "nested", "wait", "put_get_numpy", "put_get_tensor",
            "tensor_aliasing", "named_actor", "kill_and_cancel", "errors", "dag")
# a crashed actor process restarts only on the cluster: in local mode an
# actor is a thread of the driver's process
CLUSTER_PROGRAMS = ("restarting_actor",)


# ---- placement on a two-node cluster ----------------------------------------

def _accel(pkg):
    """The accelerator resource of ``pkg``: JAX's TPU, the port's GPU."""
    return "TPU" if pkg == "ray_tpu" else "GPU"


def _accel_opt(pkg, n):
    return {"num_tpus" if pkg == "ray_tpu" else "num_gpus": n}


def where_am_i(pkg):
    ctx = _rt(pkg).get_runtime_context()
    return ctx.get_node_id(), accelerator_ids(pkg)


def placement(pkg, target_node_id):
    """Placement groups and bundle indices on a cluster whose second node
    (``target_node_id``) alone has accelerators."""
    rt = _rt(pkg)
    pgmod = _rt(pkg + ".util.placement_group")
    acc = _accel(pkg)
    out = {}
    pg = pgmod.placement_group([{"CPU": 1, acc: 2}, {"CPU": 1}],
                               strategy="PACK")
    out["ready"] = pg.wait(timeout=60)
    entry = next(e for e in pgmod.placement_group_table()
                 if e["pg_id"] == pg.id.hex())
    out["bundles"] = entry["bundles"]
    out["strategy"] = entry["strategy"]
    out["bundle0_on_target"] = entry["bundle_nodes"][0] == target_node_id
    f = rt.remote(where_am_i).options(
        num_cpus=1, **_accel_opt(pkg, 2),
        scheduling_strategy=pgmod.PlacementGroupSchedulingStrategy(pg, 0))
    node, ids = rt.get(f.remote(pkg), timeout=120)
    out["task_on_target"] = node == target_node_id
    out["task_ids"] = ids
    actor = rt.remote(Holder).options(
        num_cpus=1, **_accel_opt(pkg, 0),
        scheduling_strategy=pgmod.PlacementGroupSchedulingStrategy(pg, 1))
    h = actor.remote(pkg)
    out["actor_ids"] = rt.get(h.ids.remote(), timeout=120)
    rt.kill(h)
    try:
        pgmod.PlacementGroupSchedulingStrategy(pg, 2)
        out["bad_index"] = None
    except ValueError as e:
        out["bad_index"] = _exc(e)
    pgmod.remove_placement_group(pg)
    spread = pgmod.placement_group([{"CPU": 1}, {"CPU": 1}],
                                   strategy="STRICT_SPREAD")
    out["spread_ready"] = spread.wait(timeout=60)
    entry = next(e for e in pgmod.placement_group_table()
                 if e["pg_id"] == spread.id.hex())
    out["spread_nodes"] = len(set(entry["bundle_nodes"]))
    pgmod.remove_placement_group(spread)
    too_big = pgmod.placement_group([{"CPU": 1, acc: 8}], strategy="PACK")
    out["too_big_ready"] = too_big.wait(timeout=1.0)
    pgmod.remove_placement_group(too_big)
    return out


def accelerator_sequence(pkg):
    """Actors holding 1, 2 and 1 accelerators at once, then one of 2
    after the first two are gone: each one's indices."""
    rt = _rt(pkg)
    held, out = {}, {}
    for name, n in (("a", 1), ("b", 2), ("c", 1)):
        held[name] = rt.remote(Holder).options(
            num_cpus=0, **_accel_opt(pkg, n)).remote(pkg)
        out[name] = rt.get(held[name].ids.remote(), timeout=120)
    for name in ("a", "b"):
        rt.kill(held.pop(name))
    deadline = time.monotonic() + 60
    acc = _accel(pkg)
    while (rt.available_resources().get(acc, 0) < 3
           and time.monotonic() < deadline):
        time.sleep(0.1)
    d = rt.remote(Holder).options(num_cpus=0,
                                  **_accel_opt(pkg, 2)).remote(pkg)
    out["d"] = rt.get(d.ids.remote(), timeout=120)
    rt.kill(d)
    rt.kill(held.pop("c"))
    return out


# ---- train loops -------------------------------------------------------------

def loop_report(config):
    train = _rt(config["pkg"] + ".train")
    ctx = train.get_context()
    for step in range(3):
        train.report({"step": step, "rank": ctx.get_world_rank(),
                      "lr": config["lr"]})


def loop_ranks(config):
    train = _rt(config["pkg"] + ".train")
    ctx = train.get_context()
    train.report({"rank": ctx.get_world_rank(),
                  "world": ctx.get_world_size()})


def loop_checkpoint(config):
    train = _rt(config["pkg"] + ".train")
    start = 0
    ckpt = train.get_checkpoint()
    if ckpt is not None:
        start = ckpt.to_dict()["step"] + 1
    for step in range(start, start + 2):
        train.report({"step": step},
                     checkpoint=train.Checkpoint.from_dict({"step": step}))


def loop_fail_once(config):
    train = _rt(config["pkg"] + ".train")
    ckpt = train.get_checkpoint()
    start = ckpt.to_dict()["step"] + 1 if ckpt else 0
    for step in range(start, 4):
        if step == 2 and ckpt is None:
            raise RuntimeError("injected failure at step 2")
        train.report({"step": step},
                     checkpoint=train.Checkpoint.from_dict({"step": step}))


def loop_always_fails(config):
    raise ValueError("always fails")


def loop_shard(config):
    train = _rt(config["pkg"] + ".train")
    train.report({"shard": list(train.get_dataset_shard("train"))})


def loop_mlp(config):
    """JAX's data-parallel MLP (tests/test_train.py): two ranks, the
    gradient all-reduced each step; JAX's through its collective group,
    the port's through the gang's gloo process group."""
    import numpy as np

    pkg = config["pkg"]
    train = _rt(pkg + ".train")
    ctx = train.get_context()
    rank, world = ctx.get_world_rank(), ctx.get_world_size()
    if pkg == "ray_tpu":
        col = _rt("ray_tpu.collective")
        col.init_collective_group(world, rank, "mlp")

        def allreduce(g):
            return col.allreduce(g, "mlp")
    else:
        import torch
        import torch.distributed as dist

        def allreduce(g):
            t = torch.from_numpy(np.ascontiguousarray(g))
            dist.all_reduce(t)
            return t.numpy()

    rng = np.random.RandomState(0)
    w = rng.randn(4, 1) * 0.1          # same init on all ranks
    data_rng = np.random.RandomState(rank)
    losses = []
    for step in range(8):
        x = data_rng.randn(16, 4)
        y = x @ np.array([[1.0], [-2.0], [0.5], [3.0]])
        pred = x @ w
        grad = 2 * x.T @ (pred - y) / len(x)
        grad = allreduce(grad) / world
        w -= 0.05 * grad
        losses.append(float(((pred - y) ** 2).mean()))
    train.report({"first_loss": losses[0], "last_loss": losses[-1],
                  "w_checksum": float(np.sum(w)), "losses": losses})


def loop_llama(config):
    """The ``debug`` Llama in fp32 from the weights in ``config`` (a numpy
    tree of JAX's), ``config["batches"]`` through the package's
    ``StepDriver``, whose K is the session's; the per-step losses."""
    import dataclasses

    import numpy as np

    pkg = config["pkg"]
    train = _rt(pkg + ".train")
    opt_kw = config["opt"]
    if pkg == "ray_tpu":
        jax = _rt("jax")
        jnp = _rt("jax.numpy")
        llama = _rt("ray_tpu.models.llama")
        ts = _rt("ray_tpu.parallel.train_step")
        cfg = dataclasses.replace(llama.PRESETS["debug"],
                                  compute_dtype=jnp.float32)
        params = jax.tree_util.tree_map(jnp.asarray, config["params"])
        opt = ts.default_optimizer(**opt_kw)
        state = jax.jit(opt.init)(params)
        drv = train.StepDriver(cfg, opt)
    else:
        import torch

        from ray_tpu_torch.models import llama
        from ray_tpu_torch.models.convert import params_from_jax
        from ray_tpu_torch.parallel import train_step as ts

        torch.set_num_threads(1)
        cfg = dataclasses.replace(llama.PRESETS["debug"],
                                  compute_dtype=torch.float32)
        params = params_from_jax(config["params"], cfg, device="cpu",
                                 dtype=torch.float32)
        opt = ts.default_optimizer(**opt_kw)
        state = opt.init(params)
        drv = train.StepDriver(cfg, opt, device="cpu")
    losses = []
    drv.run(params, state, iter(config["batches"]),
            on_launch=lambda m: losses.extend(
                np.asarray(m["loss"], np.float64).reshape(-1).tolist()))
    train.report({"losses": losses, "steps": drv.steps,
                  "launches": drv.launches,
                  "steps_per_launch": drv.steps_per_launch})


def fit(pkg, loop, *, storage, name, num_workers=1, config=None,
        datasets=None, max_failures=0, resume=None, steps_per_launch=1):
    """``loop`` through the package's trainer: JAX's ``JaxTrainer``, the
    port's ``TorchTrainer`` with CPU workers (a gloo gang)."""
    train = _rt(pkg + ".train")
    if pkg == "ray_tpu":
        trainer_cls = train.JaxTrainer
        scaling = train.ScalingConfig(num_workers=num_workers)
    else:
        trainer_cls = train.TorchTrainer
        scaling = train.ScalingConfig(num_workers=num_workers,
                                      gpus_per_worker=0)
    run = train.RunConfig(
        name=name, storage_path=storage,
        failure_config=train.FailureConfig(max_failures=max_failures),
        fast_path=train.FastPathConfig(steps_per_launch=steps_per_launch))
    return trainer_cls(loop, train_loop_config=dict(config or {}, pkg=pkg),
                       scaling_config=scaling, run_config=run,
                       datasets=datasets,
                       resume_from_checkpoint=resume).fit()


def slice_groups(pkg, target_node_id):
    """``slice_group``: one bundle a host holding its accelerators (JAX's
    chips, the port's GPUs), all or nothing."""
    pgmod = _rt(pkg + ".util.placement_group")
    per_host = {("chips_per_host" if pkg == "ray_tpu"
                 else "gpus_per_host"): 2}
    out = {}
    pg = pgmod.slice_group(num_hosts=1, cpus_per_host=1, strategy="PACK",
                           name="slice", **per_host)
    out["ready"] = pg.wait(timeout=60)
    entry = next(e for e in pgmod.placement_group_table()
                 if e["pg_id"] == pg.id.hex())
    out["bundles"] = entry["bundles"]
    out["on_target"] = entry["bundle_nodes"] == [target_node_id]
    pgmod.remove_placement_group(pg)
    two = pgmod.slice_group(num_hosts=2, cpus_per_host=1, **per_host)
    out["two_hosts_ready"] = two.wait(timeout=1.0)   # one node has them
    pgmod.remove_placement_group(two)
    return out
