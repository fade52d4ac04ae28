"""The port's engine mesh over gloo on the CPU, for `tests/test_torch_distributed.py`,
`tests/test_torch_halo.py`, `tests/test_torch_mesh2d.py`, `tests/test_torch_moe_ep.py`
and `tests/test_torch_recsys_psum.py`: `run_gloo(job, tmp_path)` spawns one
process a rank (WORLD of them, `torch.multiprocessing`, start method "spawn"),
joins them into a gloo group from a `file://` store under `tmp_path`, runs
`job` on a "process_group" mesh whose engines sit on the ranks in
PERMUTATION's order (not the identity) — the 1-D `("engines",)` mesh, or
MESH_2D over ("data", "model") for the model jobs, its axes' subgroups made
by every rank — destroys the group, and returns what each rank saved.
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
from repro_torch.graph.distributed import DistributedEngine, make_engines_mesh, make_mesh
from repro_torch.graph.generators import rmat

WORLD = 4
PERMUTATION = np.array([2, 0, 3, 1])  # engine p runs on rank PERMUTATION[p]
MESH_2D = ((2, 2), ("data", "model"))  # engine p = (p // 2, p % 2), row-major
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


def mesh2d_runs(mesh) -> dict:
    """The collectives along each axis of the 2-D mesh, on the local block of
    x (2, 2, 2, 3) (x[g, j] engine (g, j)'s), and a table laid out by
    `shard_tensor` and put back whole by `unshard_tensor`."""
    from repro_torch.models.sharding import P, shard_tensor, unshard_tensor

    x = torch.arange(2 * 2 * 2 * 3, dtype=torch.float32).view(2, 2, 2, 3) * 1.5 - 7.0
    local = x[mesh.local_slices()]
    out = {}
    for axis in mesh.axis_names:
        (other,) = (a for a in mesh.axis_names if a != axis)
        out[f"all_to_all/{axis}"] = mesh.all_gather(mesh.all_to_all(local, axis)).numpy()
        out[f"psum/{axis}"] = mesh.all_gather(mesh.psum(local, axis), other).numpy()
        out[f"all_gather/{axis}"] = mesh.all_gather(mesh.all_gather(local, axis), other).numpy()
    out["psum/all"] = mesh.psum(local).numpy()
    table = torch.arange(4 * 8 * 2, dtype=torch.float32).view(4, 8, 2)
    for name, spec, used in (("rows", P(None, "model", None), ("model",)),
                             ("both", P(None, ("data", "model"), None), mesh.axis_names),
                             ("two_dims", P("data", "model", None), mesh.axis_names)):
        slab = shard_tensor(table, spec, mesh)
        out[f"unshard/{name}"] = unshard_tensor(slab, spec, mesh).numpy()
        for axis in used:
            slab = mesh.all_gather(slab, axis)
        out[f"shard/{name}"] = slab.numpy()
    return out


def moe_ep_runs(mesh) -> dict:
    """`moe_block` with impl="ep_shardmap": 6 experts (padded to 8) top-2
    with a shared expert at capacity_factor 1.25 (slots drop) on 2 × 24
    tokens and a 3-token decode, and the smoke olmoe-1b-7b forward with EP."""
    import dataclasses

    from repro_torch.configs.registry import get_arch
    from repro_torch.models import moe
    from repro_torch.models import transformer as tfm

    rng = np.random.default_rng(7)
    m = moe.MoEConfig(6, 2, 24, d_ff_shared=40, capacity_factor=1.25, impl="ep_shardmap")
    lp = {n: torch.from_numpy((rng.standard_normal(sh) / np.sqrt(sh[-2])).astype(np.float32))
          for n, sh in moe.layer_shapes(m, 32).items()}
    x = torch.from_numpy(rng.standard_normal((2, 24, 32)).astype(np.float32))
    out = {"block": moe.moe_block(m, lp, x, mesh=mesh).numpy(),
           "decode": moe.moe_block(m, lp, x.reshape(-1, 32)[:3].reshape(3, 1, 32), mesh=mesh).numpy()}
    cfg = get_arch("olmoe-1b-7b").smoke_config()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, impl="ep_shardmap"))
    params = tfm.init_params(cfg, 0, device="cpu")
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 12)))
    with torch.no_grad():
        out["olmoe_forward"] = tfm.forward(params, toks, cfg, mesh=mesh).numpy()
    return out


def recsys_psum_runs(mesh) -> dict:
    """dcn-v2's smoke model with lookup_impl="psum_model": logits and loss
    of a single-hot batch of 8 and of a weighted multi-hot (L = 3) batch of
    6 (not a multiple of the data axis: the whole batch on every row)."""
    import dataclasses

    from repro_torch.configs.registry import get_arch
    from repro_torch.models import recsys as rec
    from repro_torch.models.sharding import shard_tensor

    cfg = dataclasses.replace(get_arch("dcn-v2").smoke_config(), lookup_impl="psum_model")
    params = rec.init_params(cfg, 0, device="cpu")
    params["tables"] = shard_tensor(params["tables"], rec.param_specs(cfg, mesh)["tables"], mesh)
    rng = np.random.default_rng(3)
    out = {}
    for name, b, shape in (("single", 8, ()), ("multi", 6, (3,))):
        ids = rng.integers(-1, cfg.rows_per_table + 1, (b, cfg.n_sparse, *shape)).astype(np.int32)
        batch = {"dense": rng.standard_normal((b, cfg.n_dense)).astype(np.float32), "sparse_ids": ids,
                 "labels": rng.integers(0, 2, b).astype(np.float32)}
        if shape:
            batch["sparse_weights"] = rng.random(ids.shape).astype(np.float32)
        with torch.no_grad():
            out[f"{name}/logits"] = rec.forward(params, batch, cfg, mesh=mesh).numpy()
            out[f"{name}/loss"] = rec.loss_fn(params, batch, cfg, mesh=mesh).numpy()
    return out


JOBS = {"engine": engine_runs, "halo": halo_runs, "mesh2d": mesh2d_runs, "moe_ep": moe_ep_runs,
        "recsys_psum": recsys_psum_runs}
JOBS_2D = ("mesh2d", "moe_ep", "recsys_psum")


def make_job_mesh(job: str, backend: str = "process_group"):
    """The mesh a job runs on: the 1-D mesh, or MESH_2D; on "stacked" the
    same shape on the CPU in engine order."""
    perm = PERMUTATION if backend == "process_group" else None
    if job in JOBS_2D:
        return make_mesh(*MESH_2D, site_permutation=perm, backend=backend, device="cpu")
    return make_engines_mesh(perm, num_engines=WORLD, backend=backend, device="cpu")


def _rank(rank: int, store: str, out_dir: str, job: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=WORLD, rank=rank)
    try:
        mesh = make_job_mesh(job)
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
