"""Rank body of the port's multi-rank tests on the CPU (gloo). Imports
torch and ``tpu_rl_torch`` only, never jax: the test process computes
``tpu_rl``'s side and hands each rank its jobs in a file.

Run as: ``python -m tests.torch_rank_child <jobs.pt> <rank> <world>
<rendezvous file> <out.pt>``. Every rank runs every job in order (each job
is a collective program) and writes its results to ``<out.pt>.<rank>``.

Jobs (dicts, ``kind`` first):

- ``dp``: ``raw`` (Config dict), ``state`` (a port train state), ``batches``
  (K global batches as numpy dicts), ``kw`` (one dict of step arguments per
  update; ``noise`` global, sliced here by rank). The DP step
  (``make_parallel_train_step``, ``chain=K`` when K > 1) on this rank's rows.
- ``attn``: ``impl`` (ring/ulysses), ``mesh`` (n_data, n_seq), global
  ``q, k, v, pos, seg`` and a cotangent ``w``: this rank's block of the
  output and of the grads of ``sum(o * w)``, and the bytes the attention
  saved for its backward.
- ``sp_step``: a transformer step under ``make_sp_mesh(*mesh)``.
- ``replicate_check``: ranks other than 0 perturb ``state``; ``replicate``
  must raise on every rank (its message is the result).
- ``colocated``: ``ColocatedLoop`` on ``raw`` for ``updates`` updates: its
  flat params, episode count and mesh.
- ``learner``: a multihost ``LearnerService`` on ``raw`` for ``updates``
  updates, its store fed seeded random windows by a thread, its watchdog
  made to trip at check ``trip_at`` (world rank 0's; None: never); its flat
  params, updates run, rollbacks and run epoch. With ``record``: every
  host's windows carry the host's index in ``obs[..., 0]``, and each rank
  returns the raw batches it assembled from its store (a host's rank 0
  only) and the host tags of the rows it trained on.

- ``sebulba``: a ``SebulbaLoop`` on ``raw`` over the test seam's
  ``devices``, whose learner group is the ranks: rank 0 runs both lanes
  for ``updates`` updates and returns the batches its learner lane
  consumed, every other rank follows; each rank's flat params.

A rendezvous of the form ``tcp://host:port`` joins through
``init_multihost`` (one process per host) instead of a ``file://`` store;
a ``dp`` job with ``host_local`` then feeds each rank its host's rows
through ``host_local_batch_to_global``. With ``pod://host:port`` the jobs
join themselves, through the ``multihost`` of their config (its
``process_id`` set to this rank's host), each host holding
``LOCAL_WORLD_SIZE`` ranks.

Not collected by pytest (no ``test_`` prefix).
"""

from __future__ import annotations

import os
import sys
import time

import torch


def _dp(job, world):
    from tpu_rl_torch.algos.registry import get_algo
    from tpu_rl_torch.config import Config
    from tpu_rl_torch.parallel import make_mesh, make_parallel_train_step, replicate, shard_batch
    from tpu_rl_torch.types import Batch

    cfg = Config.from_dict(job["raw"])
    mesh = make_mesh(world)
    _f, _s, step = get_algo(cfg.algo).build(
        cfg, torch.Generator().manual_seed(0), device="cpu", mesh=mesh)
    state = replicate(job["state"], mesh)
    chain = len(job["batches"])
    pstep = make_parallel_train_step(step, mesh, cfg, chain=chain)
    if job.get("host_local"):
        from tpu_rl_torch.parallel.mesh import batch_sharding
        from tpu_rl_torch.parallel.multihost import host_local_batch_to_global

        shard = batch_sharding(mesh)
        host = [{k: v[shard.of(v.shape[0])] for k, v in b.items()} for b in job["batches"]]
        local = [Batch.from_mapping(host_local_batch_to_global(b, shard), device="cpu")
                 for b in host]
    else:
        local = [shard_batch(Batch.from_mapping(b, device="cpu"), mesh) for b in job["batches"]]
    kws = []
    for kw in job["kw"]:
        kw = dict(kw)
        if "noise" in kw:
            rows = mesh.rows(local[0].obs.shape[0])
            kw["noise"] = [tuple(n[rows] for n in pair) for pair in kw["noise"]]
        kws.append(kw)
    if chain == 1:
        state, metrics = pstep(state, local[0], None, **kws[0])
    else:
        assert all(not kw for kw in kws), "the chained jobs draw nothing"
        state, metrics = pstep(state, local, None)
    return {"state": state, "metrics": metrics}


def _attn(job):
    from tpu_rl_torch.parallel.sequence import ATTENTION_IMPLS, make_sp_mesh

    nd, ns = job["mesh"]
    mesh = make_sp_mesh(nd, ns)
    B, T = job["q"].shape[:2]
    rows = slice(mesh.data_index * (B // nd), (mesh.data_index + 1) * (B // nd))
    cols = slice(mesh.seq_index * (T // ns), (mesh.seq_index + 1) * (T // ns))
    q, k, v = (torch.tensor(job[n][rows, cols]).requires_grad_() for n in ("q", "k", "v"))
    pos, seg = (torch.tensor(job[n][rows, cols]) for n in ("pos", "seg"))
    saved = []

    def pack(t):
        saved.append(t.numel() * t.element_size())
        return t

    # what the attention keeps for its backward (the loss's own saves aside)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        o = ATTENTION_IMPLS[job["impl"]](q, k, v, pos, seg, causal=True, mesh=mesh)
    (o * torch.tensor(job["w"][rows, cols])).sum().backward()
    return {"o": o.detach(), "dq": q.grad, "dk": k.grad, "dv": v.grad,
            "rows": rows, "cols": cols, "saved_bytes": sum(saved)}


def _sp_step(job):
    from tpu_rl_torch.algos.registry import get_algo
    from tpu_rl_torch.config import Config
    from tpu_rl_torch.parallel import make_sp_mesh, make_sp_train_step, replicate, shard_batch
    from tpu_rl_torch.types import Batch

    cfg = Config.from_dict(job["raw"])
    mesh = make_sp_mesh(*job["mesh"])
    _f, _s, step = get_algo(cfg.algo).build(
        cfg, torch.Generator().manual_seed(0), device="cpu", mesh=mesh)
    state = replicate(job["state"], mesh)
    pstep = make_sp_train_step(step, mesh, cfg)
    batch = shard_batch(Batch.from_mapping(job["batch"], device="cpu"), mesh)
    state, metrics = pstep(state, batch, None, **job.get("kw", {}))
    return {"state": state, "metrics": metrics}


def _replicate_check(job, world):
    from tpu_rl_torch.parallel import make_mesh, replicate
    from tpu_rl_torch.utils.tree import tree_leaves

    state = job["state"]
    if torch.distributed.get_rank() > 0:
        leaf = tree_leaves(state.params)[0]
        leaf.add_(1.0)
    try:
        replicate(state, make_mesh(world))
    except ValueError as e:
        return {"error": str(e)}
    return {"error": ""}


def _colocated(job):
    import torch.distributed as dist

    from tpu_rl_torch.config import Config
    from tpu_rl_torch.runtime.colocated import ColocatedLoop

    raw = _pod_raw(job["raw"]) if "RANK" in os.environ else job["raw"]
    loop = ColocatedLoop(Config.from_dict(raw), seed=0, max_updates=job["updates"],
                         device="cpu")
    out = loop.run(log=False)
    leaves = [t.reshape(-1) for t in loop.state.params["actor"].values()]
    return {"params": torch.cat(leaves), "episodes": out["episodes"],
            "world": loop.mesh.world, "backend": dist.get_backend()}


def _pod_raw(raw: dict) -> dict:
    """``raw`` with its multihost ``process_id`` set to this rank's host
    (``pod://`` runs; the rank is ``RANK`` in the environment)."""
    from tpu_rl_torch.parallel.multihost import host_rank

    pid = int(os.environ["RANK"]) // host_rank()[1]
    return dict(raw, multihost=dict(raw["multihost"], process_id=pid))


def _learner(job):
    import threading

    import numpy as np

    from tpu_rl_torch.config import Config
    from tpu_rl_torch.data.layout import BatchLayout
    from tpu_rl_torch.data.shm_ring import alloc_handles, make_store
    from tpu_rl_torch.heal import watchdog as W
    from tpu_rl_torch.runtime.learner_service import LearnerService
    from tpu_rl_torch.runtime.mailbox import STAT_SLOTS
    from tpu_rl_torch.types import BATCH_FIELDS
    from tpu_rl_torch.utils.tree import tree_leaves

    checks = [0]
    observe = W.DivergenceWatchdog.observe

    def tripping(self, signals):
        observe(self, signals)
        checks[0] += 1
        return checks[0] == job["trip_at"]

    W.DivergenceWatchdog.observe = tripping
    cfg = Config.from_dict(_pod_raw(job["raw"]))
    rank = int(os.environ["RANK"])
    from tpu_rl_torch.parallel.multihost import host_rank
    from tpu_rl_torch.runtime.learner_service import RankChannel

    host = rank // host_rank()[1]
    record = job.get("record", False)
    assembled, tags = [], set()
    if record:
        assemble, unpack = LearnerService._assemble_device, RankChannel._unpack

        def assembling(self, raws, dev, stager):
            assembled.extend({k: np.array(v) for k, v in r.items()} for r in raws)
            return assemble(self, raws, dev, stager)

        def unpacking(self, flat):
            b = unpack(self, flat)
            tags.update(b.obs[..., 0].unique().tolist())
            return b

        LearnerService._assemble_device = assembling
        RankChannel._unpack = unpacking
    layout = BatchLayout.from_config(cfg)
    handles = alloc_handles(layout, cfg.batch_size)
    store = make_store(cfg, layout, handles=handles)
    rng = np.random.default_rng(rank)
    stop = threading.Event()

    def feed():
        while not stop.is_set():
            w = {f: rng.standard_normal((layout.seq_len, layout.width(f))).astype(np.float32)
                 * 0.1 for f in BATCH_FIELDS}
            w["act"] = rng.integers(0, 2, w["act"].shape).astype(np.float32)
            w["is_fir"][:] = 0.0
            w["is_fir"][0] = 1.0
            w["log_prob"][:] = -0.7
            if record:
                w["obs"][:, 0] = float(host)
            while not stop.is_set() and not store.put(w):
                time.sleep(0.001)

    last = {}
    publish = LearnerService._publish

    def recording(self, pub, state, ver=-1):
        last.update(ver=ver, params=torch.cat([t.reshape(-1) for t in
                                               tree_leaves(state.params)]).clone())
        return publish(self, pub, state, ver)

    LearnerService._publish = recording
    feeder = threading.Thread(target=feed, daemon=True)
    feeder.start()
    svc = LearnerService(cfg, handles, model_port=job["model_ports"][rank],
                         stat_array=[0.0] * STAT_SLOTS, max_updates=job["updates"],
                         stop_event=threading.Event())
    try:
        svc.run()
    finally:
        stop.set()
        feeder.join(10)
    out = {"updates": svc.n_updates, "rollbacks": svc.n_rollbacks, "epoch": svc.run_epoch,
           "world": svc.mesh.world, **last}
    if getattr(svc, "state", None) is not None:  # a follower rank's final state
        out["params"] = torch.cat([t.reshape(-1) for t in tree_leaves(svc.state.params)])
    if record:
        out.update(assembled=assembled, tags=sorted(tags))
    return out


def _sebulba(job):
    from tpu_rl_torch.config import Config
    from tpu_rl_torch.runtime.sebulba import SebulbaLoop

    loop = SebulbaLoop(Config.from_dict(job["raw"]), seed=0, max_updates=job["updates"],
                       device="cpu", devices=job["devices"], record_batches=True)
    out = {"world": loop.mesh.world}
    if loop.mesh.rank == 0:
        out.update(run=loop.run(log=False), consumed=loop.consumed)
    else:
        out["updates"] = loop.follow()
    out["params"] = torch.cat([t.reshape(-1) for t in loop.state.params["actor"].values()])
    return out


def main(argv: list[str]) -> None:
    jobs_path, rank, world, rdv, out = argv[0], int(argv[1]), int(argv[2]), argv[3], argv[4]
    torch.set_num_threads(1)
    from tpu_rl_torch.parallel.mesh import init_process_group

    if rdv.startswith("pod://"):
        os.environ["RANK"] = str(rank)  # the jobs join through their config
    elif rdv.startswith("tcp://"):
        from tpu_rl_torch.parallel.multihost import init_multihost, is_multihost

        init_multihost(rdv[len("tcp://"):], world, rank, device="cpu")
        # idempotent within a process
        assert init_multihost(rdv[len("tcp://"):], world, rank, device="cpu") == "gloo"
        assert is_multihost()
    else:
        init_process_group(f"file://{rdv}", world, rank, torch.device("cpu"), False)
    jobs = torch.load(jobs_path, weights_only=False)
    results = []
    for job in jobs:
        kind = job["kind"]
        if kind == "dp":
            results.append(_dp(job, world))
        elif kind == "attn":
            results.append(_attn(job))
        elif kind == "sp_step":
            results.append(_sp_step(job))
        elif kind == "replicate_check":
            results.append(_replicate_check(job, world))
        elif kind == "colocated":
            results.append(_colocated(job))
        elif kind == "learner":
            results.append(_learner(job))
        elif kind == "sebulba":
            results.append(_sebulba(job))
        else:
            raise ValueError(kind)
    torch.save(results, f"{out}.{rank}")
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()


def run_ranks(jobs: list, world: int, workdir: str, timeout: float = 240.0,
              coordinator: str | None = None, pod: bool = False,
              local_ranks: int = 1) -> list[list]:
    """Run ``jobs`` on ``world`` gloo ranks (subprocesses of this
    interpreter), joined through a ``file://`` store in ``workdir`` or, with
    ``coordinator`` ("host:port"), through ``init_multihost``: here, or with
    ``pod`` by the jobs' own configs, on hosts of ``local_ranks`` ranks
    each (``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``). Returns each rank's
    results."""
    import subprocess

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    jobs_path = os.path.join(workdir, f"jobs{world}.pt")
    out = os.path.join(workdir, f"out{world}.pt")
    rdv = (f"{'pod' if pod else 'tcp'}://{coordinator}" if coordinator
           else os.path.join(workdir, f"rdv{world}"))
    torch.save(jobs, jobs_path)
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "PYTHONSTARTUP")}
    env["PYTHONPATH"] = repo
    env["OMP_NUM_THREADS"] = "1"
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "tests.torch_rank_child", jobs_path, str(r), str(world), rdv, out],
            cwd=repo, env=dict(env, LOCAL_RANK=str(r % local_ranks),
                               LOCAL_WORLD_SIZE=str(local_ranks)),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for r in range(world)
    ]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} rc={p.returncode}\n{logs[r][-4000:]}"
    return [torch.load(f"{out}.{r}", weights_only=False) for r in range(world)]


if __name__ == "__main__":
    main(sys.argv[1:])
