"""The port's engine mesh over gloo on the CPU, for `tests/test_torch_distributed.py`,
`tests/test_torch_halo.py`, `tests/test_torch_mesh2d.py`, `tests/test_torch_moe_ep.py`,
`tests/test_torch_recsys_psum.py`, `tests/test_torch_transformer_tp_serve.py`,
`tests/test_torch_moe_tp_serve.py` and `tests/test_torch_moe_fsdp.py` (the
`dense_tp_serve`, `moe_tp_serve` and `moe_fsdp` jobs: logits, and each
rank's KV cache block; `moe_fsdp` also one training step),
`tests/test_torch_dryrun.py` (the `counted` job: the collectives a
`obs.cost.CostCounter` counts) and their
training counterparts (`tests/test_torch_{halo,moe_ep,recsys_psum}_train.py`
and `tests/test_torch_transformer_tp.py`, the `*_train` jobs:
every gradient and the params after one AdamW step, by leaf path; a rank
holds the whole of a replicated leaf and its own block of a laid-out one,
`engine_block`): `run_gloo(job, tmp_path)` spawns one
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
TRAIN_LR = 1e-3  # the reference launcher's lr and clip, a constant schedule so the first step moves


def _path(path: tuple) -> str:
    return "/".join(str(p) for p in path)


def train_step_runs(loss_fn, params, mesh, sharded: dict) -> dict:
    """`loss_fn(params)`'s gradients, then one `make_train_step` AdamW step
    (lr TRAIN_LR, clip 1.0, the global norm over `sharded` on `mesh`) on a
    copy of `params`: {"grad/<path>", "param/<path>" (updated), "loss"}."""
    from repro_torch.train.loop import make_train_step
    from repro_torch.train.optim import adamw
    from repro_torch.train.pytree import tree_leaves_with_path, tree_map

    leaves = tree_leaves_with_path(params)
    for _, t in leaves:
        t.requires_grad_(True)
    grads = torch.autograd.grad(loss_fn(params), [t for _, t in leaves])
    out = {f"grad/{_path(path)}": g.numpy() for (path, _), g in zip(leaves, grads)}
    init, step = make_train_step(lambda p, _: loss_fn(p), adamw(TRAIN_LR, mesh=mesh, sharded=sharded))
    state, metrics = step(init(tree_map(lambda t: t.detach().clone(), params)), None)
    out.update({f"param/{_path(path)}": t.detach().numpy() for path, t in tree_leaves_with_path(state.params)})
    out["loss"] = metrics["loss"].numpy()
    return out


def engine_block(x: np.ndarray, engine: int, shape: tuple) -> np.ndarray:
    """Engine `engine`'s block of a tensor laid out over the stacked mesh of
    `shape` (an axis of size 1 is replicated: every engine's)."""
    coords = np.unravel_index(engine, shape)
    return x[tuple(slice(c, c + 1) if n > 1 else slice(0, 1) for c, n in zip(coords, x.shape))]


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


def _halo_case(mesh, *, transpose: bool = False):
    """gin (3 × 16, d_in 8, 5 classes, weights from the port's seeded
    generator) and its batch on rmat(120, 900, seed=4), sharded on `mesh`."""
    from repro_torch.graph.halo import build_halo_plan
    from repro_torch.models import gnn
    from repro_torch.models.gnn_dist import pack_batch, shard_batch

    g = rmat(120, 900, seed=4)
    cfg = gnn.GnnConfig("gin", "gin", n_layers=3, d_hidden=16, d_in=8, d_out=5)
    params = gnn.init_params(cfg, 0, device="cpu")
    rng = np.random.default_rng(1)
    x = rng.standard_normal((120, 8)).astype(np.float32)
    labels = rng.integers(0, 5, 120)
    plan = build_halo_plan(g.src, g.dst, 120, mesh.num_engines)
    return cfg, params, shard_batch(pack_batch(plan, x, labels, rng.random(120) < 0.5), mesh, transpose=transpose)


def halo_runs(mesh) -> dict:
    """The halo GIN of `_halo_case`: the local engines' logits, in engine
    order, and the loss."""
    from repro_torch.models.gnn_dist import gin_forward_halo, gin_halo_loss_fn

    cfg, params, batch = _halo_case(mesh)
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
    lp = moe.shard_experts(m, lp, mesh)
    out = {"block": moe.moe_block(m, lp, x, mesh=mesh).numpy(),
           "decode": moe.moe_block(m, lp, x.reshape(-1, 32)[:3].reshape(3, 1, 32), mesh=mesh).numpy()}
    cfg = get_arch("olmoe-1b-7b").smoke_config()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, impl="ep_shardmap"))
    params = tfm.shard_params(tfm.init_params(cfg, 0, device="cpu"), cfg, mesh)
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


def halo_train_runs(mesh) -> dict:
    """One training step of `_halo_case`'s GIN: every weight is whole on
    every engine."""
    from repro_torch.models.gnn_dist import gin_halo_loss_fn

    cfg, params, batch = _halo_case(mesh, transpose=True)
    out = train_step_runs(lambda p: gin_halo_loss_fn(p, batch, cfg, mesh), params, mesh, {})
    return out | {"engines": mesh.local_engines}


def moe_ep_train_runs(mesh) -> dict:
    """One training step of the smoke olmoe-1b-7b with EP (every leaf laid
    out by `shard_params`: TP attention, EP experts; the recompute on), and
    the gradients of one
    EP block of 5 experts (padded to 6) top-2 with a shared expert at
    capacity_factor 1.25 (slots drop) with respect to its weights and its
    tokens."""
    import dataclasses

    from repro_torch.configs.registry import get_arch
    from repro_torch.models import moe
    from repro_torch.models import transformer as tfm
    from repro_torch.train.pytree import tree_leaves_with_path

    rng = np.random.default_rng(11)
    cfg = get_arch("olmoe-1b-7b").smoke_config()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, impl="ep_shardmap"))
    params = tfm.shard_params(tfm.init_params(cfg, 0, device="cpu"), cfg, mesh)
    toks = rng.integers(0, cfg.vocab, (4, 13))
    batch = {"tokens": torch.from_numpy(toks[:, :-1]), "labels": torch.from_numpy(toks[:, 1:])}
    sharded = tfm.sharded_specs(cfg, mesh)
    out = train_step_runs(lambda p: tfm.loss_fn(p, batch, cfg, mesh=mesh), params, mesh, sharded)

    m = moe.MoEConfig(5, 2, 24, d_ff_shared=40, capacity_factor=1.25, impl="ep_shardmap")
    lp = {n: torch.from_numpy((rng.standard_normal(sh) / np.sqrt(sh[-2])).astype(np.float32))
          for n, sh in moe.layer_shapes(m, 32).items()}
    lp = moe.shard_experts(m, lp, mesh)
    x = torch.from_numpy(rng.standard_normal((2, 24, 32)).astype(np.float32)).requires_grad_(True)
    dy = torch.from_numpy(rng.standard_normal((2, 24, 32)).astype(np.float32))
    leaves = tree_leaves_with_path(lp)
    for _, t in leaves:
        t.requires_grad_(True)
    grads = torch.autograd.grad((moe.moe_block(m, lp, x, mesh=mesh) * dy).sum(), [x] + [t for _, t in leaves])
    out["block/grad/x"] = grads[0].numpy()
    out.update({f"block/grad/{_path(path)}": g.numpy() for (path, _), g in zip(leaves, grads[1:])})
    return out | {"engines": mesh.local_engines}


def recsys_psum_train_runs(mesh) -> dict:
    """One training step of dcn-v2's smoke model with lookup_impl="psum_model"
    (its tables laid out over "model") on a batch of 8, split over the data
    axis, and the gradients of the loss of a batch of 5, which is not: every
    data row then looks the whole batch up."""
    import dataclasses

    from repro_torch.configs.registry import get_arch
    from repro_torch.models import recsys as rec
    from repro_torch.models.sharding import shard_tensor

    cfg = dataclasses.replace(get_arch("dcn-v2").smoke_config(), lookup_impl="psum_model")
    spec = rec.param_specs(cfg, mesh)["tables"]
    params = rec.init_params(cfg, 0, device="cpu")
    params["tables"] = shard_tensor(params["tables"], spec, mesh)
    rng = np.random.default_rng(13)

    def batch(b):
        return {"dense": rng.standard_normal((b, cfg.n_dense)).astype(np.float32),
                "sparse_ids": rng.integers(0, cfg.rows_per_table, (b, cfg.n_sparse)).astype(np.int32),
                "labels": rng.integers(0, 2, b).astype(np.float32)}

    split, whole = batch(8), batch(5)
    out = train_step_runs(lambda p: rec.loss_fn(p, split, cfg, mesh=mesh), params, mesh, {("tables",): spec})
    unsplit = train_step_runs(lambda p: rec.loss_fn(p, whole, cfg, mesh=mesh), params, mesh, {("tables",): spec})
    out.update({f"unsplit/{k}": v for k, v in unsplit.items() if not k.startswith("param/")})
    return out | {"engines": mesh.local_engines}


def dense_tp_config(strategy: str, **kw):
    """The reference's 2 × 2 training test's transformer (2 layers, d 64, 4
    heads, 2 KV heads, d_ff 128, vocab 128, float32, the recompute on) under
    `strategy`."""
    from repro_torch.models import transformer as tfm
    from repro_torch.models.sharding import MeshRules

    shape = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=128) | kw
    return tfm.TransformerConfig("tp", **shape, dtype=torch.float32, rules=MeshRules(strategy=strategy))


def dense_tp_train_runs(mesh) -> dict:
    """One training step of `dense_tp_config` with every leaf laid out by
    `shard_params`: Megatron TP ("tp_sp": heads on their engines; with one
    KV head, the head-gather path) and FSDP ("fsdp", a `valid` mask), a batch
    of 8 × 16 split over the rules' batch axes."""
    from repro_torch.models import transformer as tfm

    rng = np.random.default_rng(17)
    out = {}
    for name, strategy, kw in (("tp_sp", "tp_sp", {}), ("tp_sp_gather", "tp_sp", {"n_kv_heads": 1}),
                               ("fsdp", "fsdp", {})):
        cfg = dense_tp_config(strategy, **kw)
        params = tfm.shard_params(tfm.init_params(cfg, 1, device="cpu"), cfg, mesh)
        toks = rng.integers(0, cfg.vocab, (8, 17))
        batch = {"tokens": torch.from_numpy(toks[:, :-1]), "labels": torch.from_numpy(toks[:, 1:])}
        if strategy == "fsdp":
            batch["valid"] = torch.from_numpy(rng.random((8, 16)) < 0.8)
        run = train_step_runs(lambda p: tfm.loss_fn(p, batch, cfg, mesh=mesh), params, mesh,
                              tfm.sharded_specs(cfg, mesh))
        out.update({f"{name}/{k}": v for k, v in run.items()})
    return out | {"engines": mesh.local_engines}


def dense_tp_serve_runs(mesh) -> dict:
    """Serving `dense_tp_config` with its params and KV cache laid out
    (tp_sp, tp_sp with one KV head: the head-gather path and a cache whole
    along "model", fsdp): a prefill of 8 rows, a `decode_step`, two
    `decode_step_batched_pos` steps with the rows at their own positions,
    and a one-slot prefill into slot 5 of a fresh cache (one data row's
    engines hold it): the logits, whole, and the local cache blocks.  Every
    rank's products take two rows or more where stacked takes more (fsdp:
    2 of 8 a rank): a CPU product of one row takes BLAS's matrix-vector
    path, which rounds otherwise than the same row in a product of
    several."""
    from repro_torch.models import transformer as tfm

    rng = np.random.default_rng(19)
    out = {}
    for name, strategy, kw in (("tp_sp", "tp_sp", {}), ("tp_sp_gather", "tp_sp", {"n_kv_heads": 1}),
                               ("fsdp", "fsdp", {})):
        cfg = dense_tp_config(strategy, **kw)
        params = tfm.shard_params(tfm.init_params(cfg, 2, device="cpu"), cfg, mesh)
        cache = tfm.init_kv_cache(cfg, 8, 16, torch.float32, device="cpu", mesh=mesh)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (8, 9)))
        offs = torch.from_numpy(rng.integers(0, 3, 8))
        steps = [torch.from_numpy(rng.integers(0, cfg.vocab, (8, 1))) for _ in range(3)]
        with torch.no_grad():
            run = {"prefill": tfm.prefill(params, toks, cache, cfg, mesh=mesh)[0],
                   "decode": tfm.decode_step(params, cache, 9, steps[0], cfg, mesh=mesh)[0]}
            for i in range(2):
                run[f"batched{i}"] = tfm.decode_step_batched_pos(params, cache, 10 + offs + i, steps[i + 1], cfg,
                                                                 mesh=mesh)[0]
            run["cache_k"], run["cache_v"] = cache["k"], cache["v"]
            slot = tfm.init_kv_cache(cfg, 8, 16, torch.float32, device="cpu", mesh=mesh)
            run["slot_logits"] = tfm.prefill(params, toks[1:2, :7], slot, cfg, mesh=mesh, slot=5)[0]
            run["slot_cache_k"] = slot["k"]
        out.update({f"{name}/{k}": v.numpy() for k, v in run.items()})
    return out | {"engines": mesh.local_engines}


def moe_tp_serve_runs(mesh) -> dict:
    """Serving the smoke olmoe-1b-7b and qwen2-moe-a2.7b with EP under tp_sp
    (every leaf and the KV cache laid out: Megatron TP attention, EP experts)
    at capacity_factor 1.25: a prefill of 8 rows (each engine routing block i
    of its data row's own tokens), a `decode_step`, two
    `decode_step_batched_pos` steps (8 tokens on 4 engines: gathered over
    "data", routed as the reference lays them) and a one-slot prefill of 7
    tokens into slot 5 of a fresh cache (held once along "data"): the logits,
    whole, and the local cache blocks."""
    import dataclasses

    from repro_torch.configs.registry import get_arch
    from repro_torch.models import transformer as tfm

    rng = np.random.default_rng(23)
    out = {}
    for name in ("olmoe-1b-7b", "qwen2-moe-a2.7b"):
        cfg = get_arch(name).smoke_config()
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, impl="ep_shardmap"))
        params = tfm.shard_params(tfm.init_params(cfg, 3, device="cpu"), cfg, mesh)
        cache = tfm.init_kv_cache(cfg, 8, 16, torch.float32, device="cpu", mesh=mesh)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (8, 9)))
        offs = torch.from_numpy(rng.integers(0, 3, 8))
        steps = [torch.from_numpy(rng.integers(0, cfg.vocab, (8, 1))) for _ in range(3)]
        with torch.no_grad():
            run = {"prefill": tfm.prefill(params, toks, cache, cfg, mesh=mesh)[0],
                   "decode": tfm.decode_step(params, cache, 9, steps[0], cfg, mesh=mesh)[0]}
            for i in range(2):
                run[f"batched{i}"] = tfm.decode_step_batched_pos(params, cache, 10 + offs + i, steps[i + 1], cfg,
                                                                 mesh=mesh)[0]
            run["cache_k"], run["cache_v"] = cache["k"], cache["v"]
            slot = tfm.init_kv_cache(cfg, 8, 16, torch.float32, device="cpu", mesh=mesh)
            run["slot_logits"] = tfm.prefill(params, toks[1:2, :7], slot, cfg, mesh=mesh, slot=5)[0]
            run["slot_cache_k"] = slot["k"]
        out.update({f"{name}/{k}": v.numpy() for k, v in run.items()})
    return out | {"engines": mesh.local_engines}


def moe_fsdp_runs(mesh) -> dict:
    """The smoke olmoe-1b-7b and qwen2-moe-a2.7b with EP under "fsdp" (every
    leaf, the ZeRO-3 expert stacks and the KV cache laid out) at
    capacity_factor 1.25: serving as `moe_tp_serve_runs` serves (a prefill
    and decode steps of 8 rows, 2 an engine: each engine routes its own
    rows; a one-slot prefill, routed over the reference's padded flat
    layout) — the logits, whole, and the local cache blocks — and one
    training step of each on a batch of 8 rows split over both axes:
    "<arch>/grad/<path>", "<arch>/param/<path>" (a rank's own block of every
    laid-out leaf) and "<arch>/loss"."""
    import dataclasses

    from repro_torch.configs.registry import get_arch
    from repro_torch.models import transformer as tfm
    from repro_torch.models.sharding import MeshRules

    rng = np.random.default_rng(29)
    out = {}
    for name in ("olmoe-1b-7b", "qwen2-moe-a2.7b"):
        cfg = get_arch(name).smoke_config()
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, impl="ep_shardmap"),
                                  rules=MeshRules(strategy="fsdp"))
        params = tfm.shard_params(tfm.init_params(cfg, 5, device="cpu"), cfg, mesh)
        cache = tfm.init_kv_cache(cfg, 8, 16, torch.float32, device="cpu", mesh=mesh)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (8, 9)))
        offs = torch.from_numpy(rng.integers(0, 3, 8))
        steps = [torch.from_numpy(rng.integers(0, cfg.vocab, (8, 1))) for _ in range(3)]
        with torch.no_grad():
            run = {"prefill": tfm.prefill(params, toks, cache, cfg, mesh=mesh)[0],
                   "decode": tfm.decode_step(params, cache, 9, steps[0], cfg, mesh=mesh)[0]}
            for i in range(2):
                run[f"batched{i}"] = tfm.decode_step_batched_pos(params, cache, 10 + offs + i, steps[i + 1], cfg,
                                                                 mesh=mesh)[0]
            run["cache_k"], run["cache_v"] = cache["k"], cache["v"]
            slot = tfm.init_kv_cache(cfg, 8, 16, torch.float32, device="cpu", mesh=mesh)
            run["slot_logits"] = tfm.prefill(params, toks[1:2, :7], slot, cfg, mesh=mesh, slot=5)[0]
            run["slot_cache_k"] = slot["k"]
        out.update({f"{name}/{k}": v.numpy() for k, v in run.items()})
        train = dataclasses.replace(cfg, dtype=torch.float32)
        seq = rng.integers(0, cfg.vocab, (8, 13))
        batch = {"tokens": torch.from_numpy(seq[:, :-1]), "labels": torch.from_numpy(seq[:, 1:])}
        step = train_step_runs(lambda p: tfm.loss_fn(p, batch, train, mesh=mesh), params, mesh,
                               tfm.sharded_specs(train, mesh))
        out.update({f"{name}/{k}": v for k, v in step.items()})
    out.update(_whole_stacks_ffn(mesh, rng))
    return out | {"engines": mesh.local_engines}


def _whole_stacks_ffn(mesh, rng) -> dict:
    """`dense_mesh._moe_ffn` under "fsdp" where d_model (30) does not divide
    over the engines, so the expert stacks stay whole: 5 experts (padded to
    6) top-2 with a shared expert at capacity_factor 1.25 on 8 × 5 rows split
    over both axes, its output and the gradients of a seeded cotangent with
    respect to the block's laid-out leaves ("ffn_whole/...").  The FFN
    widths are multiples of 16: a CPU elementwise op vectorizes a
    contiguous tensor by its whole count and computes a short tail apart,
    so SiLU rounds an engine's last entries otherwise where a row's width
    leaves its block off the vector grid."""
    from repro_torch.models import dense_mesh, moe
    from repro_torch.models import transformer as tfm
    from repro_torch.models.sharding import P, MeshRules, shard_tensor

    m = moe.MoEConfig(5, 2, 32, d_ff_shared=32, capacity_factor=1.25, impl="ep_shardmap")
    cfg = tfm.TransformerConfig("ffn", n_layers=1, d_model=30, n_heads=2, n_kv_heads=1, d_ff=8, vocab=8, moe=m,
                                dtype=torch.float32, rules=MeshRules(strategy="fsdp"))
    laid = tfm.shard_params(tfm.init_params(cfg, 6, device="cpu"), cfg, mesh)
    layer = {k: v.requires_grad_(True) for k, v in laid["layers"].items()}
    plan = dense_mesh._plan(cfg, mesh, tfm._layout_specs(cfg, mesh), 8)
    spec = P(plan.batch, None, None)
    x = shard_tensor(torch.from_numpy(rng.standard_normal((8, 5, 30)).astype(np.float32)), spec, mesh)
    dy = shard_tensor(torch.from_numpy(rng.standard_normal((8, 5, 30)).astype(np.float32)), spec, mesh)
    out = dense_mesh._moe_ffn(m, plan, x, frozenset(plan.batch), tfm._layers({"layers": layer}, 1)[0])
    keys = ["mlp_norm", *moe.layer_shapes(m, cfg.d_model)]
    grads = torch.autograd.grad((out * dy).sum(), [layer[k] for k in keys])
    return {"ffn_whole/out": out.detach().numpy(), **{f"ffn_whole/grad/{k}": g.numpy() for k, g in zip(keys, grads)}}


def counted_runs(mesh) -> dict:
    """The collectives `obs.cost.CostCounter` counts on this process
    (one engine's link bytes by op kind, and every call's (kind, group,
    per-engine output bytes)) in a training step's loss and gradients of
    `dense_tp_config` under tp_sp and fsdp and of the smoke olmoe-1b-7b with
    EP (its all-to-alls and their transposes), and in a prefill of 8 rows
    under tp_sp: a gloo rank counts what the stacked mesh counts."""
    import dataclasses

    from repro_torch.configs.registry import get_arch
    from repro_torch.obs.cost import _COLLECTIVES, CostCounter
    from repro_torch.models import transformer as tfm
    from repro_torch.train.pytree import tree_leaves

    rng = np.random.default_rng(23)
    toks = torch.from_numpy(rng.integers(0, 128, (8, 16)))
    olmoe = get_arch("olmoe-1b-7b").smoke_config()
    olmoe = dataclasses.replace(olmoe, vocab=128, moe=dataclasses.replace(olmoe.moe, impl="ep_shardmap"))
    out = {}
    for strategy in ("tp_sp", "fsdp", "olmoe_ep"):
        cfg = olmoe if strategy == "olmoe_ep" else dense_tp_config(strategy)
        params = tfm.shard_params(tfm.init_params(cfg, 1, device="cpu"), cfg, mesh)
        leaves = [t.requires_grad_(True) for t in tree_leaves(params)]
        with CostCounter() as c:
            torch.autograd.grad(tfm.loss_fn(params, {"tokens": toks, "labels": toks}, cfg, mesh=mesh), leaves)
        if strategy == "tp_sp":
            cache = tfm.init_kv_cache(cfg, 8, 32, dtype=torch.float32, device="cpu", mesh=mesh)
            with torch.no_grad(), c:
                tfm.prefill(params, toks, cache, cfg, mesh=mesh)
        out[f"{strategy}/coll"] = np.array([c.coll[k] for k in _COLLECTIVES])
        out[f"{strategy}/calls"] = np.array([(_COLLECTIVES.index(k), g, b) for k, g, b in c.coll_calls])
    return out


JOBS = {"engine": engine_runs, "halo": halo_runs, "mesh2d": mesh2d_runs, "moe_ep": moe_ep_runs,
        "recsys_psum": recsys_psum_runs, "halo_train": halo_train_runs, "moe_ep_train": moe_ep_train_runs,
        "recsys_psum_train": recsys_psum_train_runs, "dense_tp_train": dense_tp_train_runs,
        "dense_tp_serve": dense_tp_serve_runs, "moe_tp_serve": moe_tp_serve_runs, "moe_fsdp": moe_fsdp_runs,
        "counted": counted_runs}
JOBS_2D = ("mesh2d", "moe_ep", "recsys_psum", "moe_ep_train", "recsys_psum_train", "dense_tp_train",
           "dense_tp_serve", "moe_tp_serve", "moe_fsdp", "counted")


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
