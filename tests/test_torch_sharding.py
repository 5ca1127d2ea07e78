"""The port's sharding rules (``repro_torch.models.sharding``) and mesh
builders (``repro_torch.launch.mesh``) against the JAX package's.

The rules read only shapes and a mesh's axis sizes and names, so both
packages run them with no devices: JAX on ``jax.sharding.AbstractMesh``
over ``jax.eval_shape`` trees, the port on its ``AbstractMesh`` over
trees built on the ``meta`` device.  Every leaf's spec of the params
(train and serve), a batch, a cache and the train state equals the JAX
``NamedSharding.spec``, for all ten archs' full configs and smokes, on
the (2, 4), (16, 16) and (2, 16, 16) meshes.  (The rules on real ranks:
tests/test_torch_sharded.py.)"""
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh as JMesh

from repro import configs as jconfigs
from repro.launch import mesh as jmesh
from repro.models import init_params as jinit
from repro.models import serve as jserve
from repro.models import sharding as jsh
from repro.train import trainstep as jts
from repro_torch import configs
from repro_torch.launch import mesh
from repro_torch.models import init_params, serve
from repro_torch.models import sharding as sh
from repro_torch.train import trainstep as ts

MESHES = [((2, 4), ("data", "model")), ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
ARCHS = jconfigs.list_archs()


def _jax_specs(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {jsh._path_str(p): tuple(s.spec) for p, s in flat}


def _specs(tree):
    out = {}
    sh._map_with_path(lambda p, s: out.__setitem__(sh._path_str(p),
                                                   tuple(s)), tree)
    return out


def _batch(cfg, B, T):
    shapes = {"tokens": (B, T), "behavior_logp": (B, T),
              "advantages": (B, T), "mask": (B, T)}
    if cfg.family == "vlm":
        shapes["patch_embeds"] = (B, cfg.frontend_tokens, cfg.d_model)
    if cfg.family == "audio":
        shapes["frame_embeds"] = (B, cfg.frontend_tokens, cfg.d_model)
    return ({k: torch.empty(s, device="meta") for k, s in shapes.items()},
            {k: jax.ShapeDtypeStruct(s, jnp.float32)
             for k, s in shapes.items()})


@pytest.fixture(scope="module")
def trees():
    """(port tree on meta, JAX eval_shape tree) of each arch's params,
    train state and caches, for the full config and the smoke."""
    out = {}
    key = jax.random.PRNGKey(0)
    for arch in ARCHS:
        for which in ("get_config", "get_smoke"):
            cfg = getattr(configs, which)(arch)
            jcfg = getattr(jconfigs, which)(arch)
            state = ts.init_train_state(cfg, 0, torch.bfloat16,
                                        device="meta")
            jstate = jax.eval_shape(
                lambda: jts.init_train_state(jcfg, key, jnp.bfloat16))
            caches = []
            for B, L in ((128, 4096), (1, 4096), (3, 64)):
                caches.append((
                    serve.init_cache(cfg, B, L, torch.bfloat16,
                                     device="meta"),
                    jax.eval_shape(lambda: jserve.init_cache(
                        jcfg, B, L, jnp.bfloat16))))
            out[arch, which] = (cfg, state, jstate, caches)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_equal_jax_leaf_by_leaf(trees, arch):
    """Params in train and serve mode, the train state, three caches
    (B 128 over dp, B 1 with its sequence over data, B 3 unsharded) and
    batches of 256, 32, 3 and 1 rows: the same leaves, each with the
    reference's spec, on every mesh."""
    for which in ("get_config", "get_smoke"):
        cfg, state, jstate, caches = trees[arch, which]
        for shape, names in MESHES:
            m, jm = sh.AbstractMesh(shape, names), JMesh(shape, names)
            for mode in ("train", "serve"):
                got = _specs(sh.params_shardings(state.params, m, mode))
                want = _jax_specs(jsh.params_shardings(jstate.params, jm,
                                                       mode))
                assert got == want, (which, shape, mode)
            st = sh.state_shardings(state, m)
            jst = jsh.state_shardings(jstate, jm)
            for part in ("params", "m", "v"):
                tree = st.params if part == "params" else \
                    getattr(st.opt, part)
                jtree = jst.params if part == "params" else \
                    getattr(jst.opt, part)
                assert _specs(tree) == _jax_specs(jtree), (which, part)
            assert tuple(st.opt.step) == tuple(jst.opt.step.spec) == ()
            for cache, jcache in caches:
                assert _specs(sh.cache_shardings(cache, m)) == \
                    _jax_specs(jsh.cache_shardings(jcache, jm)), which
            for B in (256, 32, 3, 1):
                b, jb = _batch(cfg, B, 16)
                assert _specs(sh.batch_shardings(b, m)) == \
                    _jax_specs(jsh.batch_shardings(jb, jm)), B
    # the rules shard something real at the production size
    cfg, state, _, _ = trees[arch, "get_config"]
    prod = sh.AbstractMesh(*MESHES[2])
    specs = _specs(sh.params_shardings(state.params, prod, "train"))
    assert any(s != (None,) * len(s) for s in specs.values())


def test_fit_and_dp_axes_equal_jax():
    """``_fit`` keeps an axis only where it divides the dim (a tuple of
    one name is the name, as PartitionSpec keeps it), and the
    data-parallel axes follow the mesh's names."""
    for shape, names in MESHES:
        m, jm = sh.AbstractMesh(shape, names), JMesh(shape, names)
        assert sh.dp_axes(m) == jsh.dp_axes(jm)
        dp = sh.dp_axes(m)
        for dims in ((256, 4096), (3, 4096), (32, 6), (16, 1)):
            for spec in ((dp, "model"), ("model", "data"), (None, dp),
                         (("data",), None)):
                assert tuple(sh._fit(m, dims, spec)) == \
                    tuple(jsh._fit(jm, dims, spec)), (shape, dims, spec)


def test_to_placements():
    """Per mesh dim, ``Shard`` of the tensor dim that names it, in the
    spec's order, else ``Replicate``; out of the mesh's order raises."""
    from torch.distributed.tensor import Replicate, Shard
    m = sh.AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    assert sh.to_placements(m, sh.Spec(("pod", "data"), None)) == \
        [Shard(0), Shard(0), Replicate()]
    assert sh.to_placements(m, sh.Spec(None, "model", "data")) == \
        [Replicate(), Shard(2), Shard(1)]
    assert sh.to_placements(m, sh.Spec()) == [Replicate()] * 3
    with pytest.raises(ValueError, match="order"):
        sh.to_placements(m, sh.Spec(("data", "pod")))


def test_mesh_builders_equal_jax(monkeypatch):
    """The mesh builders' shapes and axis names, and the trainer /
    generator split of ``trainer_generator_submeshes``, equal the
    reference's: both packages' device lists and mesh constructors are
    stubbed, so no devices and no ranks are needed."""
    made = []
    monkeypatch.setattr(jax, "make_mesh",
                        lambda shape, axes: (tuple(shape), tuple(axes)))
    monkeypatch.setattr(jax.sharding, "Mesh",
                        lambda devs, axes: (devs.reshape(-1).tolist(),
                                            devs.shape, tuple(axes)))
    monkeypatch.setattr(mesh, "_mesh", lambda dt, ranks, shape, names: (
        list(ranks), tuple(shape), tuple(names)))
    for n in (1, 2, 3, 4, 8, 9, 256, 512):
        monkeypatch.setattr(jax, "devices", lambda n=n: list(range(n)))
        monkeypatch.setattr(mesh, "_world", lambda dt, n=n: n)
        assert mesh.make_dev_mesh(device_type="cpu")[1:] == \
            jmesh.make_dev_mesh()
        assert mesh.make_dev_mesh(1, device_type="cpu")[1:] == \
            jmesh.make_dev_mesh(1)
        for multi in (False, True):
            want = jmesh.make_production_mesh(multi_pod=multi)
            if n == (512 if multi else 256):
                assert mesh.make_production_mesh(
                    multi_pod=multi, device_type="cpu")[1:] == want
            else:
                with pytest.raises(ValueError, match="ranks"):
                    mesh.make_production_mesh(multi_pod=multi,
                                              device_type="cpu")
        for theta in (0.0, 0.1, 0.25, 0.5, 0.75, 0.9, 1.0):
            if n < 2:
                with pytest.raises(ValueError, match="2"):
                    mesh.trainer_generator_submeshes(theta,
                                                     device_type="cpu")
                continue
            t, g = mesh.trainer_generator_submeshes(theta, device_type="cpu")
            jt, jg = jmesh.trainer_generator_submeshes(theta)
            assert (t[0], t[1], t[2]) == (jt[0], jt[1], jt[2])
            assert (g[0], g[1], g[2]) == (jg[0], jg[1], jg[2])
            made.append((n, theta, len(t[0])))
    assert (4, 0.5, 2) in made and (9, 1.0, 8) in made and (2, 0.0, 1) in made


def test_mesh_on_cuda_without_cuda_raises():
    """A ``cuda`` mesh without CUDA raises, as ``device.resolve`` does;
    a mesh before ``join`` raises too."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh.make_dev_mesh()
    with pytest.raises(RuntimeError, match="join"):
        mesh.make_dev_mesh(device_type="cpu")


def test_meta_params_match_the_cpu_init():
    """``init_params`` on ``meta`` gives the CPU init's tree: the same
    leaves with the same shapes and dtypes."""
    cfg = configs.get_smoke("deepseek-v3-671b")
    meta = init_params(cfg, 0, torch.bfloat16, device="meta")
    cpu = init_params(cfg, 0, torch.bfloat16, device="cpu")
    got, want = {}, {}
    sh._map_with_path(lambda p, t: got.__setitem__(p, (t.shape, t.dtype)),
                      meta)
    sh._map_with_path(lambda p, t: want.__setitem__(p, (t.shape, t.dtype)),
                      cpu)
    assert got == want
