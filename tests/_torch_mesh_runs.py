"""The port's engine mesh over gloo on the CPU, for `tests/test_torch_distributed.py`
and `tests/test_torch_halo.py`: `run_gloo(job, tmp_path)` spawns one process
a rank (WORLD of them, `torch.multiprocessing`, start method "spawn"), joins
them into a gloo group from a `file://` store under `tmp_path`, runs `job` on
a "process_group" mesh whose engines sit on the ranks in PERMUTATION's order
(not the identity), destroys the group, and returns what each rank saved.
The same job runs in the test process on a "stacked" mesh, so the two
backends are held against each other on the same inputs.  This module and
the ranks import torch and the port only; the test process never
initialises a group and sets no environment variable.
"""
import pathlib
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.core.partition import partition_by_name
from repro_torch.graph import algorithms as alg
from repro_torch.graph.distributed import DistributedEngine, make_engines_mesh
from repro_torch.graph.generators import rmat

WORLD = 4
PERMUTATION = np.array([2, 0, 3, 1])  # engine p runs on rank PERMUTATION[p]
GLOO_TIMEOUT_S = 240


def engine_runs(mesh) -> dict:
    """BFS, SSSP and PageRank on a powerlaw and a random partition, and
    PageRank with the bf16 exchange: props and iteration counts."""
    g0 = rmat(200, 1600, seed=5)
    out = {}
    for pn in ("powerlaw", "random"):
        for name in ("bfs", "sssp", "pagerank"):
            g = alg.prepare_graph(name, g0)
            part = partition_by_name(pn, g.src, g.dst, g.num_nodes, mesh.num_engines)
            props, it = DistributedEngine(alg.ALGORITHMS[name](), mesh).run(g, part, source=3)
            out[f"{pn}/{name}"], out[f"{pn}/{name}/iterations"] = props, np.asarray(it)
    g = alg.prepare_graph("pagerank", g0)
    part = partition_by_name("powerlaw", g.src, g.dst, g.num_nodes, mesh.num_engines)
    props, it = DistributedEngine(alg.pagerank_program(), mesh, comm_dtype=torch.bfloat16).run(g, part)
    out["powerlaw/pagerank_bf16"], out["powerlaw/pagerank_bf16/iterations"] = props, np.asarray(it)
    return out


def halo_runs(mesh) -> dict:
    """gin (3 × 16, d_in 8, 5 classes, weights from the port's seeded
    generator) by halo exchange on rmat(120, 900, seed=4): the local
    engines' logits, in engine order, and the loss."""
    from repro_torch.graph.halo import build_halo_plan
    from repro_torch.models import gnn
    from repro_torch.models.gnn_dist import gin_forward_halo, gin_halo_loss_fn, pack_batch, shard_batch

    g = rmat(120, 900, seed=4)
    cfg = gnn.GnnConfig("gin", "gin", n_layers=3, d_hidden=16, d_in=8, d_out=5)
    params = gnn.init_params(cfg, 0, device="cpu")
    rng = np.random.default_rng(1)
    x = rng.standard_normal((120, 8)).astype(np.float32)
    labels = rng.integers(0, 5, 120)
    plan = build_halo_plan(g.src, g.dst, 120, mesh.num_engines)
    batch = shard_batch(pack_batch(plan, x, labels, rng.random(120) < 0.5), mesh)
    with torch.no_grad():
        logits = gin_forward_halo(params, batch, cfg, mesh)
        loss = gin_halo_loss_fn(params, batch, cfg, mesh)
    return {"engines": mesh.local_engines, "logits": logits.numpy(), "loss": loss.numpy()}


JOBS = {"engine": engine_runs, "halo": halo_runs}


def _rank(rank: int, store: str, out_dir: str, job: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=WORLD, rank=rank)
    try:
        mesh = make_engines_mesh(PERMUTATION, backend="process_group", device="cpu")
        np.savez(pathlib.Path(out_dir) / f"rank{rank}.npz", **JOBS[job](mesh))
    finally:
        dist.destroy_process_group()


def run_gloo(job: str, tmp_path: pathlib.Path) -> list[dict]:
    """Each rank's saved arrays, in rank order; raises a child's exception,
    and fails after GLOO_TIMEOUT_S with every child killed."""
    ctx = mp.start_processes(_rank, args=(str(tmp_path / "store"), str(tmp_path), job), nprocs=WORLD,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + GLOO_TIMEOUT_S
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"the gloo run of {job!r} took over {GLOO_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(WORLD)]
