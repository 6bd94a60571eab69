"""Runs a case of the port's multi-device layer on N gloo ranks, each a
spawned process, for tests/test_torch_collectives.py and
tests/test_torch_sharded.py.

    results = run(2, "schur", problems=[...])    # one value per rank

A spawned rank re-imports this module to find its target, so it imports
only torch, numpy and the port, never jax (tests/test_torch_isolation.py
holds that).  Each rank joins a gloo group through a file store in a
fresh directory (no port to collide with another test worker's), with a
timeout on every collective, runs the case with device="cpu" and one
thread, and pickles its result (or its traceback) there.  `run` fails
fast: the first rank that fails, or the deadline, kills every rank and
raises, so no test waits on a rank stuck in a collective.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import pickle
import socket
import sys
import tempfile
import time
import traceback

import numpy as np

COLLECTIVE_TIMEOUT_S = 60


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run(world: int, case: str, timeout: float = 150.0, env: dict | None = None,
        **kwargs) -> list:
    """Run CASES[case](**kwargs) on `world` gloo ranks and return each
    rank's result in rank order.  `env`: torchrun's variables to set in
    every rank (RANK and LOCAL_RANK are added), which then joins the
    group from them alone."""
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as d:
        procs = [ctx.Process(target=_rank, args=(r, world, d, case, kwargs, env),
                             daemon=True) for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while any(p.exitcode is None for p in procs):
                if any(p.exitcode not in (None, 0) for p in procs):
                    break                      # one failed: stop the rest
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"case {case!r} on {world} ranks still running after "
                        f"{timeout} s; every rank killed")
                time.sleep(0.02)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join(10)
        results, errors = [], []
        for r, p in enumerate(procs):
            path = os.path.join(d, f"rank{r}.pkl")
            if not os.path.exists(path):
                errors.append(f"rank {r}: exit code {p.exitcode}, no result")
                continue
            with open(path, "rb") as f:      # written by the rank below
                ok, value = pickle.load(f)
            (results if ok else errors).append(value if ok else
                                               f"rank {r}:\n{value}")
        if errors:
            raise RuntimeError(f"case {case!r} on {world} ranks failed:\n"
                               + "\n".join(errors))
        return results


def _rank(rank, world, d, case, kwargs, env):
    import torch
    import torch.distributed as dist

    from socp_tpu_torch.parallel.runtime import init_distributed

    torch.set_num_threads(1)
    timeout = datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S)
    if env is not None:
        os.environ.update({k: str(v) for k, v in env.items()},
                          RANK=str(rank), LOCAL_RANK=str(rank),
                          WORLD_SIZE=str(world))
        init_distributed(device="cpu", timeout=timeout)
    else:
        init_distributed(rank, world, f"file://{d}/store", device="cpu",
                         timeout=timeout)
    try:
        out = (True, CASES[case](**kwargs))
    except Exception:
        out = (False, traceback.format_exc())
    tmp = os.path.join(d, f"rank{rank}.tmp")
    with open(tmp, "wb") as f:
        pickle.dump(out, f)
    os.replace(tmp, os.path.join(d, f"rank{rank}.pkl"))
    if out[0]:
        dist.destroy_process_group()
    sys.exit(0 if out[0] else 1)


# ---- the cases: each runs on every rank and returns plain data ----------

def case_collectives(x: np.ndarray, p_chunks: tuple[int, ...]) -> dict:
    """Each collective on this rank's slice x[rank] (and on its first p
    columns for the chunked rings), with the counts of the calls."""
    import torch
    import torch.distributed as dist

    from socp_tpu_torch.parallel import collectives as coll
    from socp_tpu_torch.parallel.mesh import batch_mesh, mesh_group

    group = mesh_group(batch_mesh())
    r = dist.get_rank()
    t = torch.as_tensor(x[r])
    coll.reset_counts()
    out = {"psum": coll.psum(t, group), "pmin": coll.pmin(t, group),
           "allsum": coll.allsum(t, group),
           "gather": coll.all_gather(t, group),
           "scalar_psum": coll.psum(t[0, 0], group),
           "any_one": coll.pany(torch.tensor(r == 0), group),
           "any_none": coll.pany(torch.tensor(False), group)}
    for p, chunks in p_chunks:
        out[f"ring_{p}_{chunks}"] = coll.ring_allreduce(t[:, :p], group,
                                                        n_chunks=chunks)
    counts = coll.counts()
    same = coll.psum(t, None) is t and coll.allsum(t, None) is t
    return {**{k: v.numpy() for k, v in out.items()}, "counts": counts,
            "identity_without_group": same and coll.counts() == counts}


def case_meshes(local_world_size: int) -> dict:
    """The meshes of a world of 4: their dims, groups and shards."""
    import torch
    import torch.distributed as dist

    from socp_tpu_torch.parallel import collectives as coll
    from socp_tpu_torch.parallel.mesh import (batch_mesh, block_mesh,
                                              mesh_group, shard_leading)
    from socp_tpu_torch.parallel.runtime import pod_mesh

    out = {"rank": dist.get_rank(), "world": dist.get_world_size(),
           "backend": dist.get_backend()}
    bm, km = batch_mesh(4), block_mesh()
    out["batch"] = (bm.mesh_dim_names, tuple(bm.mesh.shape))
    out["blocks"] = (km.mesh_dim_names, tuple(km.mesh.shape))
    for bad in (3, 8):
        try:
            batch_mesh(bad)
            out[f"batch_mesh({bad})"] = "no error"
        except ValueError as e:
            out[f"batch_mesh({bad})"] = str(e)
    default = pod_mesh()
    os.environ["LOCAL_WORLD_SIZE"] = str(local_world_size)
    by_node = pod_mesh()
    pod = pod_mesh(scenario_size=2)
    out["pod_default"] = (default.mesh_dim_names, tuple(default.mesh.shape))
    out["pod_by_node"] = tuple(by_node.mesh.shape)
    out["pod"] = (pod.mesh_dim_names, pod.mesh.tolist())
    row = coll.psum(torch.tensor(float(dist.get_rank())),
                    mesh_group(pod, "blocks"))
    col = coll.psum(torch.tensor(float(dist.get_rank())),
                    mesh_group(pod, "scenario"))
    out["row_sum"], out["col_sum"] = float(row), float(col)
    out["shard_all_axes"] = shard_leading(pod, ("scenario", "blocks"),
                                          np.arange(8))[0].tolist()
    out["shard_batch"] = shard_leading(bm, "batch", np.arange(12))[0].tolist()
    try:
        shard_leading(bm, "batch", np.arange(6))
        out["shard_indivisible"] = "no error"
    except ValueError as e:
        out["shard_indivisible"] = str(e)
    return out


def case_env_init() -> dict:
    """What init_distributed made of torchrun's variables alone."""
    import torch.distributed as dist

    from socp_tpu_torch.parallel.runtime import init_distributed

    before = dist.get_rank()
    init_distributed(device="cpu")           # a second call changes nothing
    return {"rank": before, "world": dist.get_world_size(),
            "backend": dist.get_backend(), "same_after": dist.get_rank() == before}


def case_stuck() -> None:
    """Rank 1 waits in an all-reduce that rank 0 does not join before the
    collective timeout: only the caller's deadline ends the run."""
    import torch
    import torch.distributed as dist

    if dist.get_rank() == 0:
        time.sleep(COLLECTIVE_TIMEOUT_S)
    else:
        dist.all_reduce(torch.zeros(()))


def case_batch(c, G, h, dims, configs: list, B_bad: int) -> dict:
    """solve_batch_sharded over every rank for each config's fields, with
    its collectives counted (the loop condition's `pany`, one a check);
    an indivisible batch."""
    from socp_tpu_torch import SolverConfig
    from socp_tpu_torch.parallel import collectives as coll
    from socp_tpu_torch.parallel.batch import solve_batch_sharded
    from socp_tpu_torch.parallel.mesh import batch_mesh

    mesh = batch_mesh()
    outs, counts = [], []
    for cfg in configs:
        coll.reset_counts()
        outs.append(solve_batch_sharded(c, G, h, dims, mesh=mesh,
                                        config=SolverConfig(**cfg),
                                        device="cpu"))
        counts.append(coll.counts())
    try:
        solve_batch_sharded(c[:B_bad], G[:B_bad], h[:B_bad], dims, mesh=mesh,
                            device="cpu")
        msg = "no error"
    except ValueError as e:
        msg = str(e)
    return {"outs": outs, "counts": counts, "indivisible": msg}


def case_schur(problems: list, configs: list, K_bad: int) -> dict:
    """solve_block over every rank, for each (the port's BlockSocpProblem,
    config fields); an indivisible block count."""
    import dataclasses

    from socp_tpu_torch import SolverConfig
    from socp_tpu_torch.parallel import collectives as coll
    from socp_tpu_torch.parallel.mesh import block_mesh
    from socp_tpu_torch.parallel.schur import solve_block

    mesh = block_mesh()
    outs, counts = [], []
    for prob, cfg in zip(problems, configs):
        coll.reset_counts()
        outs.append(solve_block(prob, config=SolverConfig(**cfg), device="cpu",
                                mesh=mesh))
        counts.append(coll.counts())
    prob = problems[0]
    bad = dataclasses.replace(prob, c=prob.c[:K_bad], G=prob.G[:K_bad],
                              h=prob.h[:K_bad], A=prob.A[:K_bad])
    try:
        solve_block(bad, device="cpu", mesh=mesh)
        msg = "no error"
    except ValueError as e:
        msg = str(e)
    return {"outs": outs, "counts": counts, "indivisible": msg}


def case_admm(data: tuple, kw: dict, pod: bool = False) -> dict:
    """admm_consensus over every rank (the 2-D pod mesh with two scenario
    rows where `pod`), with its device reads and collectives counted."""
    from socp_tpu_torch import SolverConfig
    from socp_tpu_torch.parallel import admm
    from socp_tpu_torch.parallel import collectives as coll
    from socp_tpu_torch.parallel.mesh import batch_mesh
    from socp_tpu_torch.parallel.runtime import pod_mesh

    kw = dict(kw)
    if "config" in kw:
        kw["config"] = SolverConfig(**kw["config"])
    mesh = pod_mesh(scenario_size=2) if pod else batch_mesh()
    fetch, reads = admm._fetch, []

    def counted(*args):
        reads.append(1)
        return fetch(*args)

    coll.reset_counts()
    admm._fetch = counted
    try:
        res = admm.admm_consensus(*data, **kw, mesh=mesh, device="cpu")
    finally:
        admm._fetch = fetch
    return {"res": res, "reads": len(reads), "counts": coll.counts()}


def case_hugecone(problems: list) -> dict:
    """solve_huge over the rows split on every rank, for each (args,
    kwargs), with the loop's device reads counted."""
    from socp_tpu_torch import SolverConfig
    from socp_tpu_torch.parallel import hugecone
    from socp_tpu_torch.parallel.mesh import block_mesh

    mesh = block_mesh()
    fetch, reads = hugecone._fetch, []

    def counted(flags):
        reads.append(1)
        return fetch(flags)

    outs, n_reads = [], []
    hugecone._fetch = counted
    try:
        for args, kw in problems:
            kw = dict(kw)
            kw["config"] = SolverConfig(**kw.get("config", {}))
            reads.clear()
            outs.append(hugecone.solve_huge(*args, **kw, mesh=mesh,
                                            device="cpu"))
            n_reads.append(len(reads))
    finally:
        hugecone._fetch = fetch
    return {"outs": outs, "reads": n_reads}


def case_dryrun() -> dict:
    import torch.distributed as dist

    from socp_tpu_torch.parallel import collectives as coll
    from socp_tpu_torch.parallel.dryrun import dryrun_multichip

    coll.reset_counts()
    dryrun_multichip(dist.get_world_size(), device="cpu")
    return coll.counts()


CASES = {name[len("case_"):]: f for name, f in list(globals().items())
         if name.startswith("case_")}
