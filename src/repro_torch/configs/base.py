"""Architecture configurations the port can run, and their dry-run cases:
the port of `repro.configs.base`.

An `LmArch`, `GnnArch` or `RecsysArch` knows its published configuration
(`model_config()`, a GNN's for one `GNN_SHAPES` cell), a reduced
`smoke_config()` the CPU tests run, `model_flops(cell)`, the useful-FLOPs
yardstick (6·N·D train / 2·N·D forward; MoE counts active params only), its
shape cells (`shape_cells`, `skipped_cells`) and a `DryrunCase` a cell
(`dryrun_case`), which `launch.dryrun` counts.

A case is the cell's step as a callable plus its arguments, built at the
cell's shapes on `device="meta"` (no memory, no kernel): the leaves made with
`torch.empty(..., device="meta")` from the model's shapes, then laid out on
the engine mesh by `sharding.shard_tensor` under the specs the port already
has (`transformer.param_specs`/`kv_cache_specs` through `shard_params` and
`init_kv_cache(mesh=)`, `moe.layer_specs`, `recsys.param_specs`).  The LM
steps run on the stacked production mesh (`launch.mesh`), every engine's
work on the one meta device.  The port loops over layers in Python, so a
counted step counts every layer: there is no counterpart of the
reference's scan correction (`launch.dryrun._scan_corrected_costs`).  A GNN
or dcn-v2 ("gather" lookup) step is one program over the whole batch, as the
port runs it; the batch specs (`GnnArch.batch_specs`: shapes, dtypes and
the reference's PartitionSpecs) say what one engine would hold.  A GNN cell
counts GIN with `reduce_impl="scatter"`: the ELL is built on the host from
real edges, which a dry run does not have.

The configs keep MoE's `impl="local"`, dcn-v2's `lookup_impl="gather"` and
the transformer's default `rules` ("tp_sp"); the dry run's LM configs take
EP (`impl="ep_shardmap"`) as the reference's do, and the sharded lookup and
the "fsdp" strategy are switched on by `launch.perf`'s variants.
"""
from __future__ import annotations

import contextlib
import dataclasses
import typing

import numpy as np
import torch

from repro_torch.models import gnn as gnn_lib
from repro_torch.models import recsys as rec_lib
from repro_torch.models import transformer as tfm
from repro_torch.models.gnn import GnnConfig
from repro_torch.models.moe import MoEConfig
from repro_torch.models.recsys import DcnConfig
from repro_torch.models.sharding import P, MeshRules
from repro_torch.models.transformer import TransformerConfig
from repro_torch.train import optim as optim_lib
from repro_torch.train.loop import make_train_step
from repro_torch.train.pytree import tree_leaves

__all__ = ["LM_SHAPES", "GNN_SHAPES", "RECSYS_SHAPES", "N_CLASSES_DEFAULT", "DryrunCase", "Arch", "LmArch",
           "GnnArch", "RecsysArch", "train_case", "meta_lm_params", "meta_dcn_params", "meta_tree"]

LM_SHAPES: dict[str, tuple[str, int, int]] = {
    # name: (step kind, seq_len, global_batch)
    "train_4k": ("train", 4_096, 256),
    "prefill_32k": ("prefill", 32_768, 32),
    "decode_32k": ("decode", 32_768, 128),
    "long_500k": ("long_decode", 524_288, 1),
}

GNN_SHAPES: dict[str, dict] = {
    "full_graph_sm": dict(n_nodes=2_708, n_edges=10_556, d_feat=1_433),
    "minibatch_lg": dict(
        n_nodes=232_965, n_edges=114_615_892, batch_nodes=1_024, fanout=(15, 10), d_feat=602
    ),
    "ogb_products": dict(n_nodes=2_449_029, n_edges=61_859_140, d_feat=100),
    "molecule": dict(n_nodes=30, n_edges=64, batch=128, d_feat=32),
}

RECSYS_SHAPES: dict[str, dict] = {
    "train_batch": dict(batch=65_536, kind="train"),
    "serve_p99": dict(batch=512, kind="serve"),
    "serve_bulk": dict(batch=262_144, kind="serve"),
    "retrieval_cand": dict(batch=1, n_candidates=1_000_000, kind="retrieval"),
}

N_CLASSES_DEFAULT = 16  # synthetic label space for GNN cells


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


META = torch.device("meta")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def _axes(entry) -> tuple[str, ...]:
    return () if entry is None else ((entry,) if isinstance(entry, str) else tuple(entry))


def _split_bytes(t: torch.Tensor, spec, mesh) -> float:
    """One engine's bytes of a whole tensor laid out by `spec` on `mesh`:
    its size over the engines its dims are split over (axes the mesh lacks
    count as whole)."""
    split = int(np.prod([mesh.shape[a] for e in tuple(spec) for a in _axes(e) if a in mesh.shape]))
    return t.numel() * t.element_size() / split


def _block_bytes(tree, mesh) -> float:
    """One engine's bytes of the leaves of `tree`, each laid out on `mesh`
    (local engines…, block…): its block."""
    n = len(mesh.axis_names)
    return float(sum(t.numel() * t.element_size() / int(np.prod(t.shape[:n])) for t in tree_leaves(tree)))


@dataclasses.dataclass
class DryrunCase:
    """Everything `launch.dryrun` needs to count one (arch × shape × mesh):
    `fn(*args)` is the cell's step on `device="meta"`, on `mesh` (None: one
    program over the whole batch); `chips` the production mesh's engines;
    `bytes_per_device` the resident bytes one engine holds (params,
    optimizer state, cache and batch, each leaf's size over its spec's
    split); `grad`: whether the step differentiates (serving steps run
    under `torch.no_grad`)."""

    arch: str
    cell: str
    fn: typing.Callable
    args: tuple
    mesh: object
    chips: int
    bytes_per_device: float
    model_flops: float = 0.0
    note: str = ""
    grad: bool = True

    def run(self):
        with contextlib.nullcontext() if self.grad else torch.no_grad():
            return self.fn(*self.args)


class Arch:
    """Interface every architecture implements."""

    name: str
    family: str

    def shape_cells(self) -> list[str]:
        raise NotImplementedError

    def skipped_cells(self) -> dict[str, str]:
        return {}

    def dryrun_case(self, cell: str, mesh, *, multi_pod: bool, cfg_transform=None) -> DryrunCase:
        raise NotImplementedError

    def smoke_config(self):
        raise NotImplementedError


def train_case(arch: str, cell: str, loss, params, batch: dict, *, mesh, chips: int, state_bytes, batch_bytes: float,
                model_flops: float, note: str, lr: float, opt_mesh=None, sharded=None) -> DryrunCase:
    """A training step (loss, grads, AdamW) over `params` as the port trains
    (`train.loop.make_train_step`), the optimizer state made on the params'
    device; resident: `state_bytes` of the params and of the optimizer
    state (a tree → one engine's bytes), and the batch's."""
    opt = optim_lib.adamw(optim_lib.cosine_schedule(lr, 100, 10_000), mesh=opt_mesh, sharded=sharded)
    init_state, step = make_train_step(loss, opt)
    state = init_state(params)
    resident = state_bytes(state.params) + state_bytes(state.opt_state) + batch_bytes
    return DryrunCase(arch, cell, step, (state, batch), mesh, chips, resident, model_flops, note)


@dataclasses.dataclass
class LmArch(Arch):
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int | None = None
    moe: MoEConfig | None = None
    source: str = ""
    family: str = "lm"

    def model_config(self, *, multi_pod: bool = False, dryrun: bool = False) -> TransformerConfig:
        """The published width and depth; activations bf16, params float32;
        MoE layers `impl="local"`, or with `dryrun` `impl="ep_shardmap"` (EP
        over "model", as the reference's dry run takes them); `multi_pod`
        adds "pod" to the rules' batch axes."""
        return TransformerConfig(
            self.name,
            n_layers=self.n_layers,
            d_model=self.d_model,
            n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads,
            d_ff=self.d_ff,
            vocab=self.vocab,
            d_head=self.d_head,
            moe=None if self.moe is None else dataclasses.replace(
                self.moe, impl="ep_shardmap" if dryrun else "local"),
            rules=MeshRules(multi_pod=multi_pod),
        )

    def smoke_config(self) -> TransformerConfig:
        moe = self.moe
        if moe is not None:
            moe = dataclasses.replace(
                moe, num_experts=min(8, moe.num_experts), d_ff_expert=64,
                d_ff_shared=64 if moe.d_ff_shared else 0, impl="local",
            )
        return TransformerConfig(
            self.name + "-smoke",
            n_layers=2,
            d_model=64,
            n_heads=4,
            n_kv_heads=max(1, min(4, self.n_kv_heads)),
            d_ff=128,
            vocab=512,
            moe=moe,
            dtype=torch.float32,
        )

    def shape_cells(self) -> list[str]:
        return [c for c in LM_SHAPES if c not in self.skipped_cells()]

    def skipped_cells(self) -> dict[str, str]:
        return {
            "long_500k": "pure full-attention arch — long_500k skipped per "
            "assignment rule (DESIGN.md §long_500k)"
        }

    def model_flops(self, cell: str) -> float:
        kind, seq, batch = LM_SHAPES[cell]
        n = self.model_config().num_active_params
        if kind == "train":
            return 6.0 * n * seq * batch
        if kind == "prefill":
            return 2.0 * n * seq * batch
        return 2.0 * n * batch  # decode: one token per sequence

    def dryrun_case(self, cell: str, mesh, *, multi_pod: bool, n_layers: int | None = None,
                    cfg_transform: typing.Callable | None = None) -> DryrunCase:
        """The cell's step on `mesh` (the stacked production mesh on "meta"):
        a training step, a prefill of the whole batch or one decode step at
        the last position of a full cache, every leaf laid out as
        `transformer.shard_params` and `init_kv_cache(mesh=)` lay it.
        `n_layers` cuts the depth; `cfg_transform` is `launch.perf`'s
        variant hook."""
        kind, seq, batch = LM_SHAPES[cell]
        cfg = self.model_config(multi_pod=multi_pod, dryrun=True)
        if n_layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=n_layers)
        if cfg_transform is not None:
            cfg = cfg_transform(cfg)
        params = tfm.shard_params(meta_lm_params(cfg), cfg, mesh)
        chips, tok_spec = mesh.num_engines, P(cfg.rules.batch, None)
        note = (f"counted on the stacked {'x'.join(map(str, mesh.axis_sizes))} engine mesh on 'meta' "
                f"({cfg.rules.strategy}); per device = the run's totals over {chips} engines (work held once "
                "along an axis counts once); bytes_per_device: params, optimizer state, cache and batch, "
                "temporaries not counted")
        if kind == "train":
            b = {"tokens": _meta((batch, seq), torch.int32), "labels": _meta((batch, seq), torch.int32)}
            return train_case(
                self.name, cell, lambda p, bb: tfm.loss_fn(p, bb, cfg, mesh=mesh), params, b, mesh=mesh,
                chips=chips, state_bytes=lambda t: _block_bytes(t, mesh),
                batch_bytes=sum(_split_bytes(b[k], tok_spec, mesh) for k in sorted(b)),
                model_flops=self.model_flops(cell), note=note, lr=3e-4, opt_mesh=mesh,
                sharded=tfm.sharded_specs(cfg, mesh))
        cache = tfm.init_kv_cache(cfg, batch, seq, device=META, mesh=mesh)
        if kind == "prefill":
            toks = _meta((batch, seq), torch.int32)
            fn = lambda p, t, c: tfm.prefill(p, t, c, cfg, mesh=mesh)[0]  # noqa: E731
            args = (params, toks, cache)
        else:  # decode: one new token against a full cache of `seq`
            toks = _meta((batch, 1), torch.int32)
            fn = lambda p, c, t: tfm.decode_step(p, c, seq - 1, t, cfg, mesh=mesh)[0]  # noqa: E731
            args = (params, cache, toks)
        resident = _block_bytes(params, mesh) + _block_bytes(cache, mesh) + _split_bytes(toks, tok_spec, mesh)
        return DryrunCase(self.name, cell, fn, args, mesh, chips, resident, self.model_flops(cell), note, grad=False)


def meta_lm_params(cfg: TransformerConfig) -> dict:
    """`transformer.init_params`' tree on "meta" (no values)."""
    n, d = cfg.n_layers, cfg.d_model
    params = {
        "embed": _meta((cfg.vocab, d), cfg.param_dtype),
        "layers": {k: _meta((n, *shape), cfg.param_dtype) for k, shape in tfm.layer_shapes(cfg).items()},
        "final_norm": _meta((d,), cfg.param_dtype),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = _meta((d, cfg.vocab), cfg.param_dtype)
    return params


def meta_tree(shapes, dtype):
    """A shape tree (dicts, lists, tuples of ints) as "meta" tensors."""
    if isinstance(shapes, dict):
        return {k: meta_tree(v, dtype) for k, v in shapes.items()}
    if isinstance(shapes, list):
        return [meta_tree(v, dtype) for v in shapes]
    return _meta(shapes, dtype)


@dataclasses.dataclass
class GnnArch(Arch):
    name: str
    kind: str  # gin | gat | pna | graphcast
    n_layers: int
    d_hidden: int
    n_heads: int = 1
    aggregators: tuple[str, ...] = ("sum",)
    scalers: tuple[str, ...] = ("identity",)
    mesh_refinement: int = 6
    n_vars: int = 227
    source: str = ""
    family: str = "gnn"

    def model_config(self, cell: str, *, multi_pod: bool = False) -> GnnConfig:
        """The published width and depth at one `GNN_SHAPES` cell (its feature
        width; graph classification on `molecule`, regression for graphcast);
        float32 params and activations."""
        sh = GNN_SHAPES[cell]
        task = "graph_class" if cell == "molecule" else "node_class"
        d_out = N_CLASSES_DEFAULT
        if self.kind == "graphcast":
            task, d_out = "regression", self.n_vars
        return GnnConfig(
            self.name,
            self.kind,
            n_layers=self.n_layers,
            d_hidden=self.d_hidden,
            d_in=sh["d_feat"],
            d_out=d_out,
            task=task,
            n_heads=self.n_heads,
            aggregators=self.aggregators,
            scalers=self.scalers,
            mesh_refinement=self.mesh_refinement,
            n_vars=self.n_vars,
        )

    def smoke_config(self) -> GnnConfig:
        return GnnConfig(
            self.name + "-smoke", self.kind, n_layers=2, d_hidden=16, d_in=8,
            d_out=4, task="regression" if self.kind == "graphcast" else "node_class",
            n_heads=min(2, self.n_heads), aggregators=self.aggregators,
            scalers=self.scalers, n_vars=4,
        )

    def shape_cells(self) -> list[str]:
        return list(GNN_SHAPES)

    def model_flops(self, cell: str) -> float:
        sh = GNN_SHAPES[cell]
        cfg = self.model_config(cell)
        n_nodes = sh["n_nodes"] * sh.get("batch", 1)
        n_edges = sh["n_edges"] * sh.get("batch", 1)
        # 6 × (dense param-FLOPs on nodes + message FLOPs on edges)
        return 6.0 * (cfg.num_params * 1.0 * n_nodes / max(cfg.d_in, 1) + n_edges * self.d_hidden)

    def _node_edge_counts(self, cell: str, n_devices: int) -> tuple[int, int]:
        """(nodes, edges) of one batch of the cell, each rounded up to a
        multiple of `n_devices`."""
        sh = GNN_SHAPES[cell]
        if cell == "molecule":
            n = sh["n_nodes"] * sh["batch"]
            e = sh["n_edges"] * sh["batch"]
        elif cell == "minibatch_lg":
            seeds, (f1, f2) = sh["batch_nodes"], sh["fanout"]
            n = seeds * (1 + f1 + f1 * f2)
            e = seeds * (f1 + f1 * f2)
        else:
            n, e = sh["n_nodes"], sh["n_edges"]
        return _round_up(n, n_devices), _round_up(e, n_devices)

    def batch_specs(self, cell: str, n_devices: int) -> tuple[dict, dict]:
        """The reference's batch of one cell: ({name: a "meta" tensor of its
        shape and dtype}, {name: its PartitionSpec}), node and edge counts
        rounded up to a multiple of `n_devices`."""
        sh = GNN_SHAPES[cell]
        n, e = self._node_edge_counts(cell, n_devices)
        d_feat = sh["d_feat"]
        flat = P(("pod", "data", "model"))  # axes a mesh lacks count as whole
        f32, i32, b_ = torch.float32, torch.int32, torch.bool
        if self.kind == "graphcast":
            plan = gnn_lib.graphcast_mesh_plan(n, self.mesh_refinement)
            m = _round_up(plan["n_mesh"], n_devices)
            specs = {
                "x": _meta((n, d_feat), f32),
                "mesh_x": _meta((m, 3), f32),
                "labels": _meta((n, self.n_vars), f32),
                "node_mask": _meta((n,), b_),
            }
            for pre, ecount in (("g2m", plan["e_g2m"]), ("m2m", plan["e_m2m"]), ("m2g", plan["e_m2g"])):
                ecount = _round_up(ecount, n_devices)
                specs[f"{pre}_src"] = _meta((ecount,), i32)
                specs[f"{pre}_dst"] = _meta((ecount,), i32)
                specs[f"{pre}_feat"] = _meta((ecount, 4), f32)
                specs[f"{pre}_mask"] = _meta((ecount,), b_)
            return specs, {k: flat for k in specs}
        specs = {
            "x": _meta((n, d_feat), f32),
            "src": _meta((e,), i32),
            "dst": _meta((e,), i32),
            "edge_mask": _meta((e,), b_),
            "node_mask": _meta((n,), b_),
        }
        parts = {k: flat for k in specs}
        if cell == "molecule":
            specs["graph_ids"] = _meta((n,), i32)
            specs["labels"] = _meta((sh["batch"],), i32)
            # graph-level labels: 128 graphs can't split 256 ways — DP axes only
            parts["graph_ids"], parts["labels"] = flat, P(("pod", "data"))
        else:
            specs["labels"] = _meta((n,), i32)
            specs["train_mask"] = _meta((n,), b_)
            parts["labels"], parts["train_mask"] = flat, flat
        return specs, parts

    def dryrun_case(self, cell: str, mesh, *, multi_pod: bool,
                    cfg_transform: typing.Callable | None = None) -> DryrunCase:
        """A training step over the cell's whole batch, one program (the port
        has no sharded GNN step but the halo GIN, `launch.perf`'s "halo"),
        GIN by `reduce_impl="scatter"`; per device = its totals over the
        mesh's engines, resident bytes = the replicated params and optimizer
        state and the batch over its specs' split."""
        cfg = dataclasses.replace(self.model_config(cell, multi_pod=multi_pod), reduce_impl="scatter")
        if cfg_transform is not None:
            cfg = cfg_transform(cfg)
        chips = mesh.num_engines
        batch, parts = self.batch_specs(cell, chips)
        params = meta_tree(gnn_lib.param_shapes(cfg), cfg.param_dtype)
        note = (f"one program over the whole batch on 'meta'; per device = its totals over {chips} engines; GIN "
                "counts reduce_impl='scatter' (the ELL is built on the host from real edges); bytes_per_device: "
                "params and optimizer state replicated, the batch split, temporaries not counted")
        return train_case(
            self.name, cell, lambda p, b: gnn_lib.loss_fn(p, b, cfg), params, batch, mesh=None, chips=chips,
            state_bytes=lambda t: float(sum(x.numel() * x.element_size() for x in tree_leaves(t))),
            batch_bytes=sum(_split_bytes(v, parts[k], mesh) for k, v in batch.items()),
            model_flops=self.model_flops(cell), note=note, lr=1e-3)


@dataclasses.dataclass
class RecsysArch(Arch):
    name: str
    n_dense: int = 13
    n_sparse: int = 26
    embed_dim: int = 16
    rows_per_table: int = 1_000_000
    n_cross_layers: int = 3
    mlp_dims: tuple[int, ...] = (1024, 1024, 512)
    source: str = ""
    family: str = "recsys"

    def model_config(self, *, multi_pod: bool = False) -> DcnConfig:
        """The published configuration; params and activations float32."""
        return DcnConfig(
            self.name,
            n_dense=self.n_dense,
            n_sparse=self.n_sparse,
            embed_dim=self.embed_dim,
            rows_per_table=self.rows_per_table,
            n_cross_layers=self.n_cross_layers,
            mlp_dims=self.mlp_dims,
            rules=MeshRules(multi_pod=multi_pod),
        )

    def smoke_config(self) -> DcnConfig:
        return DcnConfig(
            self.name + "-smoke", n_dense=4, n_sparse=6, embed_dim=8,
            rows_per_table=128, n_cross_layers=2, mlp_dims=(32, 16),
        )

    def model_flops(self, cell: str) -> float:
        """The reference's yardstick: 2·(dense params + looked-up features)
        a row, ×6 to train and ×2 forward, plus the retrieval's scores.  It
        takes each weight's multiply-add as two FLOPs and then doubles it
        again, so a count of the products the step runs (`launch.dryrun`)
        stands at about half of it: dcn-v2's useful/HLO is about 2."""
        sh = RECSYS_SHAPES[cell]
        cfg = self.model_config()
        dense_params = cfg.num_params - cfg.n_sparse * cfg.rows_per_table * cfg.embed_dim
        per_ex = 2.0 * dense_params + 2.0 * cfg.n_sparse * cfg.embed_dim
        mult = 6.0 if sh.get("kind") == "train" else 2.0
        flops = mult * per_ex * sh["batch"]
        if sh.get("kind") == "retrieval":
            flops += 2.0 * sh["n_candidates"] * cfg.mlp_dims[-1] * sh["batch"]
        return flops

    def shape_cells(self) -> list[str]:
        return list(RECSYS_SHAPES)

    def dryrun_case(self, cell: str, mesh, *, multi_pod: bool,
                    cfg_transform: typing.Callable | None = None) -> DryrunCase:
        """The cell's step: a training step, a forward (serve) or the
        retrieval scores against the candidates rounded up to a multiple of
        the engine count.  With lookup_impl="gather" one program over the
        whole batch; with "psum_model" (`launch.perf`'s "psum_embed") on
        `mesh`, the tables laid out as `recsys.param_specs` says."""
        sh = RECSYS_SHAPES[cell]
        cfg = self.model_config(multi_pod=multi_pod)
        if cfg_transform is not None:
            cfg = cfg_transform(cfg)
        r, chips = cfg.rules, mesh.num_engines
        specs = rec_lib.param_specs(cfg, mesh)
        params = meta_dcn_params(cfg)
        run_mesh = mesh if cfg.lookup_impl == "psum_model" else None
        if run_mesh is not None:
            from repro_torch.models.sharding import shard_tensor

            params["tables"] = shard_tensor(params["tables"], specs["tables"], mesh)
        b = sh["batch"]
        n_dev_dp = int(np.prod([mesh.shape[a] for a in mesh.axis_names if a != "model"]))
        bspec = P(r.batch) if b % n_dev_dp == 0 else P()  # retrieval: B=1 → replicate
        batch = {"dense": _meta((b, cfg.n_dense), torch.float32),
                 "sparse_ids": _meta((b, cfg.n_sparse), torch.int32),
                 "labels": _meta((b,), torch.float32)}
        batch_bytes = sum(_split_bytes(batch[k], bspec, mesh) for k in sorted(batch))

        def state_bytes(tree) -> float:
            if set(tree) == {"mu", "nu"}:
                return state_bytes(tree["mu"]) + state_bytes(tree["nu"])
            return float(sum(_block_bytes(t, mesh) if t.dim() > 3 else _split_bytes(t, spec, mesh)
                             for t, spec in _leaves_with_specs(tree, specs)))

        note = (("the lookup psum_model on the stacked engine mesh" if run_mesh is not None else
                 "one program over the whole batch") + f" on 'meta'; per device = its totals over {chips} engines; "
                "bytes_per_device: params and optimizer state over param_specs' split, the batch over the data "
                "axes, temporaries not counted")
        if sh["kind"] == "train":
            return train_case(
                self.name, cell, lambda p, bb: rec_lib.loss_fn(p, bb, cfg, mesh=run_mesh), params, batch,
                mesh=run_mesh, chips=chips, state_bytes=state_bytes, batch_bytes=batch_bytes,
                model_flops=self.model_flops(cell), note=note, lr=1e-3, opt_mesh=run_mesh,
                sharded={("tables",): specs["tables"]} if run_mesh is not None else None)
        if sh["kind"] == "retrieval":
            cand = _meta((_round_up(sh["n_candidates"], chips), cfg.mlp_dims[-1]), torch.float32)
            fn = lambda p, bb, c: rec_lib.retrieval_scores(p, bb, c, cfg, mesh=run_mesh)  # noqa: E731
            args = (params, batch, cand)
            batch_bytes += _split_bytes(cand, P(("pod", "data", "model"), None), mesh)
        else:
            fn = lambda p, bb: rec_lib.forward(p, bb, cfg, mesh=run_mesh)  # noqa: E731
            args = (params, batch)
        return DryrunCase(self.name, cell, fn, args, run_mesh, chips, state_bytes(params) + batch_bytes,
                          self.model_flops(cell), note, grad=False)


def meta_dcn_params(cfg: DcnConfig) -> dict:
    """`recsys.init_params`' tree on "meta" (no values)."""
    d0, f32 = cfg.d_input, cfg.param_dtype
    cross = []
    for _ in range(cfg.n_cross_layers):
        if cfg.cross_rank == 0:
            cross.append({"w": _meta((d0, d0), f32), "b": _meta((d0,), torch.float32)})
        else:
            cross.append({"u": _meta((d0, cfg.cross_rank), f32), "v": _meta((cfg.cross_rank, d0), f32),
                          "b": _meta((d0,), torch.float32)})
    dims = [d0, *cfg.mlp_dims]
    return {
        "tables": _meta((cfg.n_sparse, cfg.rows_per_table, cfg.embed_dim), f32),
        "cross": cross,
        "mlp": [{"w": _meta((a, b), f32), "b": _meta((b,), torch.float32)} for a, b in zip(dims[:-1], dims[1:])],
        "out": {"w": _meta((cfg.mlp_dims[-1], 1), f32), "b": _meta((1,), torch.float32)},
    }


def _leaves_with_specs(tree, specs) -> list:
    """[(leaf, its spec)] of a params tree and its parallel spec tree (dicts
    and lists; a spec `P` is a leaf)."""
    if isinstance(tree, dict):
        return [pair for k in tree for pair in _leaves_with_specs(tree[k], specs[k])]
    if isinstance(tree, list):
        return [pair for t, sp in zip(tree, specs) for pair in _leaves_with_specs(t, sp)]
    return [(tree, specs)]
