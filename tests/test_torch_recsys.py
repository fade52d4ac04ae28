"""`repro_torch.models.recsys` against `repro.models.recsys` on the same
weights and batches: dcn-v2 at `smoke_config()`, the multi-hot config of
`tests/test_models.py` (`multi_hot=4`, weighted bags too) and a low-rank
cross (`cross_rank=4`), the JAX params carried over by
`repro_torch.interop.recsys_params`.  Forward, loss and every gradient leaf
within rtol/atol 2e-3, as `tests/test_models.py` holds its models."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import RECSYS_SHAPES as JAX_RECSYS_SHAPES
from repro.configs.registry import get_arch as jax_get_arch
from repro.models import recsys as jrec
from repro_torch import interop
from repro_torch.configs.base import RECSYS_SHAPES
from repro_torch.configs.registry import get_arch
from repro_torch.kernels.embedding_bag.ops import embedding_bag
from repro_torch.models import recsys as rec
from repro_torch.models.recsys import DcnConfig

TOL = dict(rtol=2e-3, atol=2e-3)
ARCH = "dcn-v2"

CONFIGS = {
    "smoke": lambda: (jax_get_arch(ARCH).smoke_config(), get_arch(ARCH).smoke_config()),
    "multi_hot4": lambda: (
        jrec.DcnConfig(rows_per_table=64, n_sparse=3, n_dense=2, mlp_dims=(16,), multi_hot=4),
        DcnConfig(rows_per_table=64, n_sparse=3, n_dense=2, mlp_dims=(16,), multi_hot=4),
    ),
    "cross_rank4": lambda: (
        jrec.DcnConfig(rows_per_table=96, n_sparse=4, n_dense=3, embed_dim=8, mlp_dims=(24, 8), cross_rank=4),
        DcnConfig(rows_per_table=96, n_sparse=4, n_dense=3, embed_dim=8, mlp_dims=(24, 8), cross_rank=4),
    ),
}


def _pair(which):
    jcfg, cfg = CONFIGS[which]()
    jp = jrec.init_params(jcfg, jax.random.key(0))
    return jcfg, jp, cfg, interop.recsys_params(jax.tree.map(np.asarray, jp), cfg, device="cpu")


def _batch(cfg, b, seed, *, weighted=False):
    rng = np.random.default_rng(seed)
    shape = (b, cfg.n_sparse) if cfg.multi_hot == 1 else (b, cfg.n_sparse, cfg.multi_hot)
    out = {
        "dense": rng.standard_normal((b, cfg.n_dense)).astype(np.float32),
        "sparse_ids": rng.integers(0, cfg.rows_per_table, shape).astype(np.int32),
        "labels": rng.integers(0, 2, b).astype(np.float32),
    }
    if weighted:
        out["sparse_weights"] = rng.random(shape).astype(np.float32)
    return out


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _grads_equal(jg, tg, path=""):
    if isinstance(jg, dict):
        assert set(jg) == set(tg), path
        for k in jg:
            _grads_equal(jg[k], tg[k], f"{path}/{k}")
    elif isinstance(jg, (list, tuple)):
        assert len(jg) == len(tg), path
        for i, (a, b) in enumerate(zip(jg, tg)):
            _grads_equal(a, b, f"{path}/{i}")
    else:
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), err_msg=path, **TOL)


@pytest.mark.parametrize("which,weighted", [("smoke", False), ("multi_hot4", False), ("multi_hot4", True),
                                             ("cross_rank4", False)])
def test_forward_loss_and_grads_match_jax(which, weighted):
    jcfg, jp, cfg, p = _pair(which)
    batch = _batch(cfg, 8, 1, weighted=weighted)
    before = embedding_bag.launches
    got = rec.forward(p, batch, cfg)
    assert embedding_bag.launches == before  # CPU: the plain version
    assert got.shape == (8,) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(jrec.forward(jp, _j(batch), jcfg)), **TOL)

    jl, jg = jax.value_and_grad(lambda q: jrec.loss_fn(q, _j(batch), jcfg))(jp)
    leaves = [p["tables"], *[t for lp in p["cross"] + p["mlp"] + [p["out"]] for t in lp.values()]]
    for t in leaves:
        t.requires_grad_(True)
    loss = rec.loss_fn(p, batch, cfg)
    np.testing.assert_allclose(float(loss.detach()), float(jl), **TOL)
    loss.backward()
    _grads_equal(jg, _torch_grads(p))
    assert float(p["tables"].grad.abs().sum()) > 0


def _torch_grads(p):
    if isinstance(p, dict):
        return {k: _torch_grads(v) for k, v in p.items()}
    if isinstance(p, list):
        return [_torch_grads(v) for v in p]
    return p.grad


def test_retrieval_top_k_matches_jax():
    jcfg, jp, cfg, p = _pair("smoke")
    batch = _batch(cfg, 2, 2)
    cands = np.random.default_rng(3).standard_normal((1000, cfg.mlp_dims[-1])).astype(np.float32)
    jv, ji = jrec.retrieval_scores(jp, _j(batch), jnp.asarray(cands), jcfg, top_k=50)
    v, i = rec.retrieval_scores(p, batch, torch.from_numpy(cands), cfg, top_k=50)
    assert v.shape == (2, 50) and v.dtype == torch.float32
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), **TOL)
    for row in range(2):
        assert set(i[row].tolist()) == set(np.asarray(ji)[row].tolist())
    # the values are the best scores of a full product, best first
    u = rec.user_tower(p, batch, cfg)
    np.testing.assert_allclose(u.numpy(), np.asarray(jrec.user_tower(jp, _j(batch), jcfg)), **TOL)
    full = (u @ torch.from_numpy(cands).T).sort(dim=-1, descending=True).values[:, :50]
    torch.testing.assert_close(v, full)


def test_cross_layer_identity_at_zero_weights():
    _, _, cfg, p = _pair("smoke")
    lp = {"w": torch.zeros_like(p["cross"][0]["w"]), "b": torch.zeros_like(p["cross"][0]["b"])}
    x0 = torch.randn((4, cfg.d_input), generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(rec._cross_layer(lp, x0, x0), x0)


@pytest.mark.parametrize("which", ["model_config", "smoke_config"])
def test_configs_and_param_counts_equal_jax(which):
    jcfg, cfg = getattr(jax_get_arch(ARCH), which)(), getattr(get_arch(ARCH), which)()
    for f in ("name", "n_dense", "n_sparse", "embed_dim", "rows_per_table", "multi_hot", "lookup_impl",
              "n_cross_layers", "mlp_dims", "cross_rank", "hot_rows_replicated"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert cfg.d_input == jcfg.d_input and cfg.num_params == jcfg.num_params
    assert str(cfg.dtype).split(".")[-1] == jnp.dtype(jcfg.dtype).name
    assert RECSYS_SHAPES == JAX_RECSYS_SHAPES
    for cell in RECSYS_SHAPES:
        assert get_arch(ARCH).model_flops(cell) == jax_get_arch(ARCH).model_flops(cell)


def test_dcn_v2_full_width_is_the_published_one():
    cfg = get_arch(ARCH).model_config()
    assert (cfg.n_dense, cfg.n_sparse, cfg.embed_dim, cfg.rows_per_table, cfg.n_cross_layers, cfg.mlp_dims) == (
        13, 26, 16, 1_000_000, 3, (1024, 1024, 512))
    assert cfg.num_params == 418_569_930 and cfg.d_input == 429
    assert get_arch(ARCH).family == "recsys" and get_arch(ARCH).source == "arXiv:2008.13535"


def test_init_params_has_the_jax_layout():
    jcfg, jp, cfg, _ = _pair("cross_rank4")
    p = rec.init_params(cfg, 0, device="cpu")
    assert jax.tree.map(lambda t: tuple(t.shape), p) == jax.tree.map(lambda a: tuple(a.shape), jp)
    assert rec.init_params(cfg, 0, device="cpu")["tables"].equal(p["tables"])  # seeded
    assert not rec.init_params(cfg, 1, device="cpu")["tables"].equal(p["tables"])
    assert abs(float(p["tables"].std()) - 0.01) < 1e-3


def test_interop_refuses_a_wrong_tree():
    jcfg, jp, cfg, _ = _pair("smoke")
    tree = jax.tree.map(np.asarray, jp)
    with pytest.raises(ValueError, match="tables"):
        interop.recsys_params(dict(tree, tables=tree["tables"][:, :-1]), cfg, device="cpu")
    with pytest.raises(ValueError):
        interop.recsys_params(dict(tree, mlp=tree["mlp"][:-1]), cfg, device="cpu")
    with pytest.raises(ValueError):
        interop.recsys_params({k: v for k, v in tree.items() if k != "out"}, cfg, device="cpu")
    low = dataclasses.replace(cfg, cross_rank=2)  # {u, v, b} expected, {w, b} given
    with pytest.raises(ValueError, match="cross"):
        interop.recsys_params(tree, low, device="cpu")


def test_sharded_lookup_raises_naming_its_roadmap_item():
    """psum_model runs over a mesh (tests/test_torch_recsys_psum.py); without
    one it raises, where the reference falls back to the gather."""
    _, _, cfg, p = _pair("smoke")
    with pytest.raises(ValueError, match="needs a mesh with the 'model' axis"):
        rec.forward(p, _batch(cfg, 2, 0), dataclasses.replace(cfg, lookup_impl="psum_model"))


def test_bag_routes_agree_inside_the_port():
    _, _, cfg, p = _pair("multi_hot4")
    batch = _batch(cfg, 6, 4, weighted=True)
    torch.testing.assert_close(rec.forward(p, batch, cfg),
                               rec.forward(p, batch, dataclasses.replace(cfg, bag_impl="ref")))
