"""repro_torch.dist.sharding and repro_torch.launch.mesh against the
reference's logical-axis layer.

* the cases of ``tests/test_dist.py`` (hint identity, hint inside
  ``activation_hints``, the mesh requirement, rules resolution with
  dropped axes, ``tree_shardings`` structure) on ``DeviceMesh``es of the
  fake process group;
* ``arch_rules`` tables, and the spec of every leaf of ``params_axes``,
  ``caches_axes`` and ``state_axes_for_params``, equal to the
  reference's for all ten archs (full and smoke configs) on (1, 1),
  (2, 2), (16, 16) and (2, 16, 16) meshes: the reference's side on
  ``jax.sharding.AbstractMesh``, so no 512 devices are needed;
* the placements those specs give (tuple rules pod-major, size-1 axes
  replicated, a mesh axis named twice refused as JAX refuses it).
"""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import torch.distributed as dist  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402
from repro import configs as JC  # noqa: E402
from repro.dist import sharding as JS  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models.config import SHAPES as JSHAPES  # noqa: E402
from repro.train import step as JStep  # noqa: E402
from repro_torch import configs as C  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.dist import sharding as S  # noqa: E402
from repro_torch.launch import mesh as LM  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.config import SHAPES  # noqa: E402
from repro_torch.models.layers import MetaGenerator  # noqa: E402
from repro_torch.train import step as TS  # noqa: E402
from torch.distributed.tensor import (DTensor, Replicate,  # noqa: E402
                                      Shard)

FAKE_WORLD = 512
MESHES = {"1x1": ((1, 1), ("data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _fake_pg(world):
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", rank=0, world_size=world,
                            store=FakeStore())


def test_production_mesh_needs_enough_ranks():
    """The reference's ValueError, naming both numbers, when the default
    process group has fewer ranks than the mesh (and without one)."""
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="needs 256 devices; only 0"):
        LM.make_production_mesh(device_type="cpu")
    _fake_pg(16)
    try:
        with pytest.raises(ValueError, match="needs 512 devices; only 16"):
            LM.make_production_mesh(multi_pod=True, device_type="cpu")
        mesh = LM.make_debug_mesh(2, 4, device_type="cpu")
        assert mesh.mesh_dim_names == ("data", "model")
        assert tuple(mesh.shape) == (2, 4)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def meshes():
    """Every mesh of MESHES on one fake process group of 512 ranks (this
    process is rank 0), destroyed after the module."""
    _fake_pg(FAKE_WORLD)
    from torch.distributed.device_mesh import DeviceMesh

    out = {name: DeviceMesh("cpu", torch.arange(
        torch.Size(shape).numel()).reshape(shape), mesh_dim_names=axes)
        for name, (shape, axes) in MESHES.items()}
    out["production"] = LM.make_production_mesh(device_type="cpu")
    out["multi_pod"] = LM.make_production_mesh(multi_pod=True,
                                               device_type="cpu")
    yield out
    dist.destroy_process_group()


# --- the cases of tests/test_dist.py ----------------------------------------


def test_hint_is_identity_outside_mesh_context():
    assert S.current_rules() is None
    x = torch.ones((4, 8))
    assert S.hint(x, "batch", None) is x  # exact no-op, not a copy
    t = {"w": x, "b": torch.zeros((8,))}
    out = S.hint_tree(t, {"w": ("batch", None), "b": (None,)})
    assert out["w"] is x and out["b"] is t["b"]


def test_hint_places_inside_mesh_context(meshes):
    mesh = meshes["1x1"]
    rules = S.LogicalRules({"batch": "data", "feat": "model"}, mesh=mesh)
    x = torch.arange(32.0).reshape(4, 8)
    with S.activation_hints(rules):
        assert S.current_rules() is rules
        y = S.hint(x, "batch", "feat")
        t = S.hint_tree({"w": x}, {"w": ("batch", "feat")})
        # a DTensor already placed is returned as it is
        assert S.hint(y, "batch", "feat") is y
    assert S.current_rules() is None  # context restored
    assert isinstance(y, DTensor) and isinstance(t["w"], DTensor)
    assert y.device_mesh == mesh
    # values are untouched, only placement changes
    torch.testing.assert_close(y.full_tensor(), x, rtol=0, atol=0)
    torch.testing.assert_close(t["w"].full_tensor(), x, rtol=0, atol=0)

    rules22 = S.LogicalRules({"batch": "data", "feat": "model"},
                             mesh=meshes["2x2"])
    with S.activation_hints(rules22):
        z = S.hint(x, "batch", "feat")
        w = S.hint(z, None, "feat")  # redistributed, not re-distributed
    assert tuple(z.placements) == (Shard(0), Shard(1))
    assert tuple(w.placements) == (Replicate(), Shard(1))
    assert tuple(z.to_local().shape) == (2, 4)


def test_activation_hints_requires_mesh():
    with pytest.raises(ValueError, match="mesh"):
        with S.activation_hints(S.LogicalRules({"batch": "data"})):
            pass
    with pytest.raises(TypeError, match="mesh axis"):
        S.LogicalRules({"batch": 3})


def test_logical_rules_resolution(meshes):
    rules = S.LogicalRules({"batch": ("pod", "data"), "mlp": "model",
                            "seq": None})
    jrules = JS.LogicalRules({"batch": ("pod", "data"), "mlp": "model",
                              "seq": None})
    assert rules.spec(("batch", "seq", "mlp")) == \
        tuple(P(("pod", "data"), None, "model"))
    assert rules.spec("REPLICATED") == tuple(P()) == ()
    assert rules.spec(None) == ()
    # unknown logical names resolve to replicated, not an error
    assert rules.spec(("nonexistent",)) == tuple(P(None))
    # axes missing from the bound mesh are dropped at resolution time
    mesh = meshes["1x1"]  # ("data", "model") only — no "pod"
    jmesh = AbstractMesh((1, 1), ("data", "model"))
    assert rules.spec(("batch", "mlp"), mesh=mesh) == \
        tuple(jrules.spec(("batch", "mlp"), mesh=jmesh)) == ("data", "model")
    # no mesh bound: placements need one
    with pytest.raises(ValueError, match="no mesh bound"):
        rules.placements(("batch",))


def test_placements(meshes):
    """Per-mesh-dimension placements: a tuple rule pod-major, a size-1
    axis replicated, an axis named twice refused."""
    rules = S.LogicalRules({"batch": ("pod", "data"), "mlp": "model",
                            "embed": "data"})
    pods = meshes["2x16x16"]
    assert rules.placements(("batch", None, "mlp"), pods) == \
        [Shard(0), Shard(0), Shard(2)]
    assert rules.placements(("mlp", "batch"), meshes["2x2"]) == \
        [Shard(1), Shard(0)]
    # a one-rank axis shards nothing: the same layout, no collective
    assert rules.placements(("mlp", "batch"), meshes["1x1"]) == \
        [Replicate(), Replicate()]
    assert rules.placements("REPLICATED", pods) == [Replicate()] * 3
    with pytest.raises(ValueError, match="'data' on dimensions 0 and 1"):
        rules.placements(("batch", "embed"), meshes["16x16"])
    rev = S.LogicalRules({"batch": ("data", "pod")})
    with pytest.raises(ValueError, match="axis order"):
        rev.placements(("batch",), pods)


def test_tree_shardings_structure(meshes):
    mesh = meshes["1x1"]
    cfg = C.get_smoke_config("olmo-1b")
    rules = S.arch_rules(cfg, mesh, None)
    axes = {"w": ("embed", "vocab"), "scalars": "REPLICATED",
            "nested": {"b": ("batch", None)}, "skip": None}
    sh = S.tree_shardings(mesh, rules, axes)
    assert sh["skip"] is None
    assert isinstance(sh["w"], S.MeshSharding)
    assert sh["w"].mesh == mesh
    assert sh["scalars"].spec == tuple(P())
    assert set(sh) == set(axes)
    assert set(sh["nested"]) == {"b"}


# --- the rules and axes trees against the reference ------------------------


def _jax_mesh(name):
    shape, axes = MESHES[name]
    return AbstractMesh(shape, axes)


def _specs(rules, axes_tree, is_leaf, mesh):
    """[(path, spec tuple)] of every axes leaf (None leaves kept)."""
    names, leaves, _ = tree.flatten_with_names(axes_tree, is_leaf=is_leaf)
    return [(n, None if ax is None else tuple(rules.spec(ax, mesh)))
            for n, ax in zip(names, leaves)]


def _jspecs(rules, axes_tree, mesh):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        axes_tree, is_leaf=JS._is_axes_leaf)
    out = []
    for path, ax in flat:
        name = "/".join(str(getattr(k, "key", getattr(k, "idx",
                                                    getattr(k, "name", k))))
                        for k in path)
        out.append((name, None if ax is None
                    else tuple(rules.spec(ax, mesh))))
    return out


def _abstract_params(params):
    """The reference's abstract params from the port's meta ones (the
    labels read only ranks and shapes)."""
    return jax.tree.map(lambda t: jax.ShapeDtypeStruct(tuple(t.shape),
                                                      jax.numpy.float32),
                        params)


@pytest.mark.parametrize("arch", sorted(C.ARCHS))
def test_rules_and_axes_trees_match_the_reference(arch, meshes):
    """For the full and the smoke config, on every mesh and for two
    shapes: the rules table, and the spec of every leaf of params_axes,
    caches_axes and state_axes_for_params; every parameter leaf has
    placements."""
    for cfg, jcfg in ((C.get_config(arch), JC.get_config(arch)),
                      (C.get_smoke_config(arch), JC.get_smoke_config(arch))):
        params = M.init_params(cfg, MetaGenerator())
        jparams = _abstract_params(params)
        for mname in MESHES:
            mesh, jmesh = meshes[mname], _jax_mesh(mname)
            for sname in (None, "train_4k", "decode_32k"):
                shape = None if sname is None else SHAPES[sname]
                jshape = None if sname is None else JSHAPES[sname]
                rules = S.arch_rules(cfg, mesh, shape)
                jrules = JS.arch_rules(jcfg, jmesh, jshape)
                assert dict(rules.items()) == dict(jrules.items()), \
                    (arch, mname, sname)
                for port_axes, ref_axes in (
                        (M.params_axes(cfg), JM.params_axes(jcfg)),
                        (M.caches_axes(cfg), JM.caches_axes(jcfg))):
                    assert _specs(rules, port_axes, S._is_axes_leaf,
                                  mesh) == _jspecs(jrules, ref_axes, jmesh)
                st = TS.state_axes_for_params(cfg, params)
                jst = JStep.state_axes_for_params(jcfg, jparams)
                assert _specs(rules, st, S._is_axes_leaf, mesh) == \
                    _jspecs(jrules, jst, jmesh), (arch, mname, sname)
            sh = S.tree_shardings(mesh, S.arch_rules(cfg, mesh, None),
                                  M.params_axes(cfg))

            def check(p, s):
                assert len(s.placements) == mesh.ndim
                assert all(pl.dim < p.ndim for pl in s.placements
                           if pl.is_shard())

            tree.map(check, params, sh)


def test_a_doubly_named_axis_has_no_placements(meshes):
    """("batch", "embed") resolves to ('data', 'data') for qwen3-8b x
    train_4k on (16, 16): the spec equals the reference's, and placements
    refuse it as JAX refuses such a NamedSharding."""
    cfg, jcfg = C.get_config("qwen3-8b"), JC.get_config("qwen3-8b")
    rules = S.arch_rules(cfg, meshes["16x16"], SHAPES["train_4k"])
    jrules = JS.arch_rules(jcfg, _jax_mesh("16x16"), JSHAPES["train_4k"])
    assert rules.spec(("batch", "embed")) == \
        tuple(jrules.spec(("batch", "embed"))) == ("data", "data")
    with pytest.raises(ValueError, match="at most one dimension"):
        rules.placements(("batch", "embed"))
    # batch 256 over (pod, data) = 32 on the multi-pod mesh; a batch of 1
    # degrades to replicated
    pods = meshes["multi_pod"]
    assert S._batch_axes(pods, 256) == ("pod", "data")
    assert S._batch_axes(pods, 16) == "data"
    assert S._batch_axes(pods, 1) is None


def test_state_placement_on_the_meta_device(meshes):
    """A meta train state placed by the rules: every leaf a DTensor on the
    mesh with the rules' placements, Muon leaves' nu scalars replicated,
    and nothing allocated."""
    from repro_torch.optim.muon import MuonConfig

    mesh = meshes["2x2"]
    cfg = C.get_smoke_config("qwen3-8b")
    init_fn, _ = TS.make_train_step(cfg, MuonConfig())
    state = init_fn(MetaGenerator())
    axes = TS.state_axes_for_params(cfg, state.params)
    rules = S.arch_rules(cfg, mesh, SHAPES["train_4k"])
    placed = S.distribute_tree(state, S.tree_shardings(mesh, rules, axes),
                               src_data_rank=None)
    leaves = tree.leaves(placed)
    assert leaves and all(isinstance(x, DTensor) and x.is_meta
                          for x in leaves)
    wq = placed.params["stages"][0]["mixer"]["wq"]
    assert tuple(wq.placements) == (Shard(1), Shard(2))
    assert tuple(wq.to_local().shape) == (cfg.num_stages, 32, 32)
    nu = placed.opt["nu"]["stages"][0]["mixer"]["wq"]
    assert nu.ndim == 0 and tuple(nu.placements) == (Replicate(),) * 2
