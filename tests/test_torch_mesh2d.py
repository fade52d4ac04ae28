"""The port's named-axis engine mesh and sharding rules against numpy and the
JAX package.

`graph.distributed.make_mesh` over ("data", "model") and a 3-D mesh: each
collective along each axis against numpy, on the stacked backend and over
gloo (4 ranks spawned from `tests/_torch_mesh_runs.py`, engine p on rank
[2, 0, 3, 1][p], bit-equal to stacked); `launch/mesh.py`'s shapes, axes and
permutations; `models/sharding.py`'s `MeshRules`, `axis_if_divisible`,
`shard_tensor`/`unshard_tensor`, and `moe.layer_specs` and
`recsys.param_specs` equal to the reference's PartitionSpecs for both
strategies, with and without `multi_pod`, for olmoe-1b-7b, qwen2-moe-a2.7b
and dcn-v2 (the reference gets a stand-in mesh with only the `shape`
mapping it reads)."""
import types

import numpy as np
import pytest
import torch

from _torch_mesh_runs import JOBS, make_job_mesh, run_gloo
from repro.configs.registry import get_arch as jax_get_arch
from repro.models import moe as jmoe
from repro.models import recsys as jrec
from repro.models import sharding as jsh
from repro_torch.configs.registry import get_arch
from repro_torch.graph.distributed import make_engines_mesh, make_mesh
from repro_torch.launch.mesh import make_production_mesh, make_smoke_mesh, mesh_devices
from repro_torch.models import moe
from repro_torch.models import recsys as rec
from repro_torch.models import sharding as sh

MESHES = {"single": {"data": 16, "model": 16}, "multi": {"pod": 2, "data": 16, "model": 16},
          "odd": {"data": 3, "model": 5}}
STRATEGIES = [(False, "tp_sp"), (False, "fsdp"), (True, "tp_sp"), (True, "fsdp")]


def _x(shape):
    return torch.arange(int(np.prod(shape)), dtype=torch.float32).view(shape) * 0.5 - 3.0


@pytest.mark.parametrize("shape,axes", [((2, 4), ("data", "model")), ((4, 2), ("model", "data")),
                                        ((2, 3, 2), ("pod", "data", "model"))])
def test_stacked_collectives_along_each_axis_against_numpy(shape, axes):
    mesh = make_mesh(shape, axes, device="cpu")
    n = len(shape)
    assert mesh.shape == dict(zip(axes, shape)) and mesh.num_engines == int(np.prod(shape))
    assert mesh.local_shape == shape and mesh.local_engines.tolist() == list(range(mesh.num_engines))
    for a, name in enumerate(axes):
        s = shape[a]
        x = _x((*shape, s, 3))
        got = mesh.all_to_all(x, name).numpy()
        want = np.swapaxes(x.numpy(), a, n)  # engine i gets block i of every engine in its row
        assert np.array_equal(got, want)
        y = _x((*shape, 2, 3))
        want = y.numpy()[(slice(None),) * a + (0,)].copy()
        for i in range(1, s):
            want = want + y.numpy()[(slice(None),) * a + (i,)]  # in engine order, one add at a time
        assert np.array_equal(mesh.psum(y, name).numpy(), np.expand_dims(want, a))
        assert mesh.all_gather(y, name) is y
        assert mesh.local_coords(name).tolist() == list(range(s))
    total = _x((*shape, 2)).reshape(-1, 2).numpy()
    want = total[0].copy()
    for row in total[1:]:
        want = want + row
    assert np.array_equal(mesh.psum(_x((*shape, 2))).numpy(), want)


def test_the_one_axis_api_is_unchanged():
    mesh = make_engines_mesh([1, 2, 0], device="cpu")
    assert mesh.axis_names == ("engines",) and mesh.shape == {"engines": 3} and mesh.axis_sizes == (3,)
    x = _x((3, 3, 2))
    assert torch.equal(mesh.all_to_all(x), x.transpose(0, 1)) and mesh.all_gather(x) is x
    assert torch.equal(mesh.psum(x), (x[0] + x[1]) + x[2])
    with pytest.raises(ValueError, match="no axis 'pod'"):
        make_mesh((2, 2), ("data", "model"), device="cpu").psum(_x((2, 2, 1)), "pod")
    with pytest.raises(ValueError, match="needs the axis named"):
        make_mesh((2, 2), ("data", "model"), device="cpu").all_to_all(_x((2, 2, 2)))


def test_make_mesh_checks_its_arguments_and_defaults_to_the_card():
    with pytest.raises(ValueError, match="not a permutation"):
        make_mesh((2, 2), ("data", "model"), site_permutation=[0, 1, 1, 3], device="cpu")
    with pytest.raises(ValueError, match="a mesh of shape"):
        make_mesh((2, 2), ("data",), device="cpu")
    with pytest.raises(ValueError, match="a mesh of shape"):
        make_mesh((2, 2), ("data", "data"), device="cpu")
    with pytest.raises(ValueError, match="unknown mesh backend"):
        make_mesh((2, 2), ("data", "model"), backend="mpi", device="cpu")
    with pytest.raises(RuntimeError, match="initialised by the caller"):
        make_mesh((1, 1), ("data", "model"), backend="process_group", device="cpu")
    if not torch.cuda.is_available():
        for build in (lambda: make_mesh((2, 8), ("data", "model")), make_production_mesh, make_smoke_mesh):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                build()


def test_launch_mesh_shapes_axes_and_permutations():
    m = make_production_mesh(device="cpu")
    assert m.axis_names == ("data", "model") and m.shape == {"data": 16, "model": 16}
    assert mesh_devices(m) == m.num_engines == 256 and m.site_permutation is None
    mp = make_production_mesh(multi_pod=True, device="cpu")
    assert mp.axis_names == ("pod", "data", "model") and mp.axis_sizes == (2, 16, 16) and mesh_devices(mp) == 512
    perm = np.random.default_rng(0).permutation(256)
    assert np.array_equal(make_production_mesh(device_permutation=perm, device="cpu").site_permutation, perm)
    with pytest.raises(ValueError, match="not a permutation"):
        make_production_mesh(device_permutation=np.arange(255), device="cpu")
    s = make_smoke_mesh(device="cpu")
    assert s.shape == {"data": 1, "model": 1} and mesh_devices(s) == 1
    assert make_smoke_mesh((2, 4), device="cpu").shape == {"data": 2, "model": 4}


def test_gloo_2x2_collectives_and_layouts_are_bit_equal_to_stacked(tmp_path):
    ranks = run_gloo("mesh2d", tmp_path)
    want = JOBS["mesh2d"](make_job_mesh("mesh2d", "stacked"))
    for r, got in enumerate(ranks):
        assert set(got) == set(want)
        for k, v in want.items():
            assert got[k].shape == v.shape and np.array_equal(got[k], v), (r, k)
    assert not torch.distributed.is_initialized()


# ------------------------------ sharding rules ------------------------------


@pytest.mark.parametrize("multi_pod,strategy", STRATEGIES)
def test_mesh_rules_equal_the_reference(multi_pod, strategy):
    r, jr = sh.MeshRules(multi_pod, strategy), jsh.MeshRules(multi_pod, strategy)
    assert (r.batch, r.fsdp, r.model) == (jr.batch, jr.fsdp, jr.model)
    for name, shape in MESHES.items():
        jm, m = types.SimpleNamespace(shape=shape), types.SimpleNamespace(shape=shape)
        for args in [(2048, 1024), (60, 2048), (3072, 8192), (7, 12), (429, 1024)]:
            for f in ("col_parallel", "row_parallel"):
                for prefix in (0, 1):
                    got = getattr(r, f)(*args, prefix=prefix, mesh=m)
                    assert isinstance(got, sh.P)
                    assert tuple(got) == tuple(getattr(jr, f)(*args, prefix=prefix, mesh=jm)), (name, f, args)
            assert tuple(r.vocab_embed(*args, mesh=m)) == tuple(jr.vocab_embed(*args, mesh=jm))
            assert tuple(r.expert_weight(64, *args, prefix=1, mesh=m)) == tuple(
                jr.expert_weight(64, *args, prefix=1, mesh=jm))
        assert tuple(r.replicated(prefix=2)) == tuple(jr.replicated(prefix=2)) and tuple(r.replicated()) == ()


def test_axis_if_divisible_equals_the_reference():
    for shape in MESHES.values():
        jm, m = types.SimpleNamespace(shape=shape), types.SimpleNamespace(shape=shape)
        for dim in (1, 3, 5, 15, 16, 32, 60, 256, 512):
            for axis in (None, "data", "model", "pod", ("data", "model"), ("pod", "data"), ("pod", "data", "model")):
                assert sh.axis_if_divisible(dim, axis, m) == jsh.axis_if_divisible(dim, axis, jm), (shape, dim, axis)
    assert sh.axis_if_divisible(60, "model") == "model"  # no mesh: the axis as given (the reference, no mesh)
    mesh = make_mesh((3, 5), ("data", "model"), device="cpu")
    assert sh.axis_if_divisible(10, "model", mesh) == "model" and sh.axis_if_divisible(10, "data", mesh) is None


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "qwen2-moe-a2.7b"])
@pytest.mark.parametrize("multi_pod,strategy", STRATEGIES)
def test_moe_layer_specs_equal_the_reference(arch, multi_pod, strategy):
    cfg, jcfg = get_arch(arch).model_config(), jax_get_arch(arch).model_config(dryrun=False)
    r, jr = sh.MeshRules(multi_pod, strategy), jsh.MeshRules(multi_pod, strategy)
    for shape in MESHES.values():
        for prefix in (0, 1):
            got = moe.layer_specs(cfg.moe, cfg.d_model, r, prefix=prefix, mesh=types.SimpleNamespace(shape=shape))
            want = jmoe.layer_specs(jcfg.moe, jcfg.d_model, jr, prefix=prefix, mesh=types.SimpleNamespace(shape=shape))
            assert {k: tuple(v) for k, v in got.items()} == {k: tuple(v) for k, v in want.items()}
    if arch.startswith("qwen") and strategy == "tp_sp":  # 60 experts on 16: the FFN dim is sharded instead
        specs = moe.layer_specs(cfg.moe, cfg.d_model, r, mesh=make_production_mesh(device="cpu"))
        assert tuple(specs["we_gate"]) == (None, "data", "model") and tuple(specs["we_down"]) == (None, "model", "data")


@pytest.mark.parametrize("multi_pod,strategy", STRATEGIES)
def test_recsys_param_specs_equal_the_reference(multi_pod, strategy):
    import dataclasses

    cfg = dataclasses.replace(get_arch("dcn-v2").model_config(), rules=sh.MeshRules(multi_pod, strategy))
    jcfg = dataclasses.replace(jax_get_arch("dcn-v2").model_config(), rules=jsh.MeshRules(multi_pod, strategy))
    for shape in (*MESHES.values(), {"data": 2, "model": 8}):
        got = rec.param_specs(cfg, types.SimpleNamespace(shape=shape))
        want = jrec.param_specs(jcfg, types.SimpleNamespace(shape=shape))

        def flat(tree):
            if isinstance(tree, dict):
                return {k: flat(v) for k, v in tree.items()}
            if isinstance(tree, list):
                return [flat(v) for v in tree]
            return tuple(tree)

        assert flat(got) == flat(want)


@pytest.mark.parametrize("spec", [sh.P(None, "model", None), sh.P("data", None, "model"), sh.P(None, ("data", "model")),
                                  sh.P(None, ("model", "data"), None), sh.P(), sh.P("model")])
def test_shard_tensor_lays_out_blocks_and_unshard_tensor_inverts_it(spec):
    mesh = make_mesh((2, 4), ("data", "model"), device="cpu")
    x = _x((8, 16, 4))
    y = sh.shard_tensor(x, spec, mesh)
    used = {a for s in spec if s is not None for a in ((s,) if isinstance(s, str) else s)}
    assert y.shape[:2] == tuple(mesh.shape[a] if a in used else 1 for a in mesh.axis_names)
    assert y.is_contiguous() and y.untyped_storage().data_ptr() != x.untyped_storage().data_ptr()
    assert torch.equal(sh.unshard_tensor(y, spec, mesh), x)
    # engine (g, j)'s block is x's chunk at its coordinates, numpy-indexed
    xn = x.numpy()
    for g in range(y.shape[0]):
        for j in range(y.shape[1]):
            idx = []
            for i, s in enumerate(tuple(spec) + (None,) * (3 - len(spec))):
                axes = () if s is None else ((s,) if isinstance(s, str) else tuple(s))
                coord = {"data": g, "model": j}
                sizes = [mesh.shape[a] for a in axes]
                k = int(np.ravel_multi_index([coord[a] for a in axes], sizes)) if axes else 0
                c = x.shape[i] // int(np.prod(sizes))
                idx.append(slice(k * c, (k + 1) * c))
            assert np.array_equal(y[g, j].numpy(), xn[tuple(idx)]), (g, j)


def test_shard_tensor_refuses_what_does_not_divide():
    mesh = make_mesh((2, 4), ("data", "model"), device="cpu")
    with pytest.raises(ValueError, match="does not divide"):
        sh.shard_tensor(_x((3, 6)), sh.P(None, "model"), mesh)
    with pytest.raises(ValueError, match="names 'pod'"):
        sh.shard_tensor(_x((4, 4)), sh.P("pod"), mesh)
    with pytest.raises(ValueError, match="twice"):
        sh.shard_tensor(_x((4, 4)), sh.P("model", "model"), mesh)
