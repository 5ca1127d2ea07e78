"""The dry run on the ``meta`` device (``repro_torch.launch.dryrun``)
against the JAX package.

* ``argument_bytes`` a device, for every ``combos()`` pair on the pod1
  (16, 16) and pod2 (2, 16, 16) meshes, is the sum over leaves of the
  reference's ``NamedSharding.shard_shape`` bytes under its own rules,
  less its 0-d ``pos`` and Adam ``step`` (device scalars there, host ints
  in the port).
* For the ten smoke configs, every product a forward runs on ``meta`` is
  counted as 2 m n k FLOPs (2 b m n k batched), computed here from the
  operands' shapes, and every linear layer's weight is an operand of
  one.
* A one-layer smoke train step's FLOPs against the reference's
  ``jax.jit(step).lower(...).compile().cost_analysis()["flops"]`` on the
  CPU (one layer: XLA counts a scan's body once): ``FlopCounterMode``
  counts products only and XLA elementwise work too, 2.7% more here
  (measured ratio 0.9734), so the port's count lies within [0.95, 1.0]
  of XLA's.
* ``remat`` (the reference's ``remat_layers``) on the llama31 smoke's
  train step on a (data 2) mesh: autograd keeps the layers' inputs in
  place of what the layers save, so the saved bytes are what the
  forward saves outside the layers plus one boundary a layer, each
  measured from ``--no-remat`` records at 1 and 2 layers; the peak
  drops, the FLOPs grow by the recompute, and each stacked leaf is
  gathered twice (the recompute's gather) while its gradient is
  reduced once.
* ``llama31-8b`` lowers by name, as the launcher takes it; the CLI runs
  one full-size combo (starcoder2-3b, train_4k, a (1, 1) mesh) and
  writes its JSON record.

Only ``inputspecs``, ``models.sharding`` and the train step of the
reference are imported: ``repro.launch.dryrun`` sets ``XLA_FLAGS`` when
imported."""
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JMesh
from jax.sharding import NamedSharding
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro import configs as jconfigs
from repro.configs import llama_paper as jllama
from repro.configs.base import INPUT_SHAPES as JSHAPES
from repro.launch import inputspecs as jspecs
from repro.models import init_params as jinit
from repro.models import sharding as jsh
from repro.train import trainstep as jts
from repro_torch import configs
from repro_torch.configs.base import ShapeSpec
from repro_torch.configs.llama_paper import smoke as llama_smoke
from repro_torch.launch import dryrun
from repro_torch.models import forward_train, init_params

MESHES = {"pod1": ((16, 16), ("data", "model")),
          "pod2": ((2, 16, 16), ("pod", "data", "model"))}
KEY = jax.random.PRNGKey(0)


def _shard_bytes(tree, shardings) -> int:
    leaves = jax.tree.leaves(tree)
    shs = jax.tree.leaves(shardings,
                          is_leaf=lambda x: isinstance(x, NamedSharding))
    assert len(leaves) == len(shs)
    return sum(int(np.prod(s.shard_shape(x.shape))) * x.dtype.itemsize
               for x, s in zip(leaves, shs))


@pytest.fixture(scope="module")
def jax_trees():
    """Per arch, the reference's eval_shape params and train state."""
    out = {}

    def get(arch, which):
        if (arch, which) not in out:
            cfg = jconfigs.get_config(arch)
            out[arch, which] = jax.eval_shape(
                (lambda: jts.init_train_state(cfg, KEY, jnp.bfloat16))
                if which == "state" else
                (lambda: jinit(cfg, KEY, jnp.bfloat16)))
        return out[arch, which]
    return get


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_argument_bytes_match_the_references_shards(mesh_name, jax_trees):
    shape, axes = MESHES[mesh_name]
    jmesh = JMesh(shape, axes)
    mesh = dryrun.production_mesh(mesh_name)
    assert tuple(mesh.shape.values()) == shape
    for arch, sname in configs.combos():
        jcfg, spec = jconfigs.get_config(arch), JSHAPES[sname]
        inputs = jspecs.input_specs(jcfg, spec)
        if spec.kind == "train":
            state = jax_trees(arch, "state")
            want = _shard_bytes(state, jsh.state_shardings(state, jmesh)) \
                + _shard_bytes(inputs["batch"],
                               jsh.batch_shardings(inputs["batch"], jmesh))
            want -= 4                        # AdamState.step
        else:
            params = jax_trees(arch, "params")
            want = _shard_bytes(params, jsh.params_shardings(
                params, jmesh, mode="serve"))
            if spec.kind == "prefill":
                want += _shard_bytes(inputs["batch"], jsh.batch_shardings(
                    inputs["batch"], jmesh))
            else:
                want += _shard_bytes(inputs["cache"], jsh.cache_shardings(
                    inputs["cache"], jmesh)) - 4          # pos
                want += _shard_bytes(
                    inputs["tokens"],
                    jsh.batch_shardings({"t": inputs["tokens"]}, jmesh)["t"])
        _, _, lowered = dryrun.lower_combo(arch, sname, mesh)
        assert lowered.argument_bytes == want, (arch, sname)


class _Products(TorchDispatchMode):
    """Each product's operand shapes and the FLOPs ``FlopCounterMode``
    (the outer mode) counted for it."""

    OPS = {torch.ops.aten.mm, torch.ops.aten.addmm, torch.ops.aten.bmm,
           torch.ops.aten.baddbmm}

    def __init__(self, fc):
        super().__init__()
        self.fc, self.calls = fc, []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        before = self.fc.get_total_flops()
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket in self.OPS:
            a, b = [t for t in args if isinstance(t, torch.Tensor)][-2:]
            self.calls.append((tuple(a.shape), tuple(b.shape),
                               self.fc.get_total_flops() - before))
        return out


LINEAR = re.compile(r"(^|/)(wq|wk|wv|wo|w_gate|w_up|w_down|w_in|w_out|"
                    r"wq_a|wq_b|wkv_a|wk_b|wv_b|w_qkv|w_if|w_x|w_router|"
                    r"proj|lm_head)$")


def _linear_weights(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _linear_weights(v, prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _linear_weights(v, prefix + (str(i),))
    elif LINEAR.search("/".join(prefix)) and tree.dim() >= 2:
        yield "/".join(prefix), tuple(tree.shape[-2:])


@pytest.mark.parametrize("arch", configs.list_archs())
def test_every_linear_layer_counts_two_m_n_k(arch):
    cfg = configs.get_smoke(arch)
    params = init_params(cfg, 0, torch.float32, device="meta")
    B, S = 2, 16
    batch = {"tokens": torch.empty((B, S), dtype=torch.int32,
                                   device="meta")}
    front = {"vision": "patch_embeds", "audio": "frame_embeds"}
    if cfg.frontend in front:
        batch[front[cfg.frontend]] = torch.empty(
            (B, cfg.frontend_tokens, cfg.d_model), device="meta")
    with FlopCounterMode(display=False) as fc, _Products(fc) as rec:
        forward_train(params, cfg, batch)
    assert rec.calls
    for a, b, flops in rec.calls:
        if len(a) == 2:
            m, k = a
            n = b[1]
            want = 2 * m * k * n
        else:
            bt, m, k = a
            n = b[2]
            want = 2 * bt * m * k * n
        assert flops == want, (a, b, flops)
    seen = {b[-2:] for _, b, _ in rec.calls} | \
        {b[-2:][::-1] for _, b, _ in rec.calls}
    for path, kn in _linear_weights(params):
        assert kn in seen, (arch, path, kn)
    assert fc.get_total_flops() == sum(f for _, _, f in rec.calls)


def test_train_step_flops_against_xla():
    jcfg = jllama.smoke().replace(n_layers=1)
    B, T = 4, 32
    rng = np.random.default_rng(0)
    batch = {"tokens": jnp.asarray(rng.integers(0, jcfg.vocab, (B, T))
                                   .astype(np.int32)),
             "behavior_logp": jnp.zeros((B, T)),
             "advantages": jnp.ones((B, T)), "mask": jnp.ones((B, T))}
    state = jts.init_train_state(jcfg, KEY, jnp.float32)
    cost = jax.jit(jts.make_train_step(jcfg)).lower(
        state, batch).compile().cost_analysis()
    cost = cost[0] if isinstance(cost, list) else cost
    mesh = dryrun.production_mesh(mesh_shape=(1, 1))
    cfg, shape, lowered = dryrun.lower_combo(
        llama_smoke().replace(n_layers=1), ShapeSpec("t", T, B, "train"),
        mesh, dtype=torch.float32, remat=False)
    rec = dryrun.analyse(cfg, shape, lowered, mesh)
    ratio = rec["flops_per_device"] / cost["flops"]
    assert 0.95 <= ratio <= 1.0, ratio


def test_remat_keeps_the_layer_boundaries():
    mesh = dryrun.production_mesh(mesh_shape=(2, 1))
    B, T = 4, 32

    def record(n_layers, remat):
        cfg, shape, lowered = dryrun.lower_combo(
            llama_smoke().replace(n_layers=n_layers),
            ShapeSpec("t", T, B, "train"), mesh, dtype=torch.float32,
            remat=remat)
        return dryrun.analyse(cfg, shape, lowered, mesh)

    one, off, on = record(1, False), record(2, False), record(2, True)
    layer = off["saved_bytes"] - one["saved_bytes"]     # one layer's saves
    outside = one["saved_bytes"] - layer
    boundary = (B // 2) * T * llama_smoke().d_model * 4
    assert on["rows_per_device"] == B // 2 and boundary < layer
    assert on["saved_bytes"] == outside + 2 * boundary
    assert on["saved_bytes"] < off["saved_bytes"]
    assert on["peak_bytes_per_device"] < off["peak_bytes_per_device"]
    assert on["argument_bytes"] == off["argument_bytes"]
    assert on["flops_per_device"] > off["flops_per_device"]
    # on (2, 1) only the layers' FSDP leaves are sharded
    assert on["collectives"]["all-gather"] == \
        2 * off["collectives"]["all-gather"] > 0
    assert on["collectives"]["reduce-scatter"] == \
        off["collectives"]["reduce-scatter"] > 0


def test_llama31_8b_lowers_by_name():
    """``llama31-8b``, the paper's policy outside the registry, by name
    as the launcher takes it."""
    from repro_torch.configs.llama_paper import LLAMA31_8B
    cfg, _, lowered = dryrun.lower_combo("llama31-8b", "train_4k",
                                         dryrun.production_mesh("pod1"))
    assert cfg.name == LLAMA31_8B.name and lowered.rows == 16


def test_cli_writes_a_full_size_record(tmp_path, capsys):
    rec = dryrun.main(["--arch", "starcoder2-3b", "--shape", "train_4k",
                       "--mesh-shape", "1x1", "--out", str(tmp_path)])
    line = capsys.readouterr().out
    assert line.startswith("starcoder2-3b") and "C=" in line \
        and "peak=" in line and "count=" in line
    saved = json.loads(
        (tmp_path / "starcoder2-3b_train_4k_pod1.json").read_text())
    assert saved == json.loads(json.dumps(rec))
    cfg = configs.get_config("starcoder2-3b")
    assert saved["mesh"] == [1, 1] and saved["rows_per_device"] == 256
    # every weight and moment whole on one device: 12 bytes a param
    n = sum(t.numel() for t in jax.tree.leaves(
        init_params(cfg, 0, torch.bfloat16, device="meta")))
    assert saved["argument_bytes"] == n * (2 + 4 + 4) + 256 * 4096 * 16
    assert saved["flops_per_device"] >= 6 * n * 256 * 4096 * 0.9
    assert saved["peak_bytes_per_device"] > saved["hbm_bytes"]
    assert not saved["fits_hbm"] and saved["collectives"] == {}
    assert set(saved["roofline"]) == {"compute_s", "memory_s",
                                      "collective_s"}


def _serve_products(cfg, kind, mesh_shape):
    """One device's serving step of ``cfg`` on meta (``kind`` prefill of
    16 ids or decode over a cache of 32, 4 rows), run under
    ``FlopCounterMode``: (each product's shapes and FLOPs, the record's
    collectives)."""
    mesh = dryrun.production_mesh(mesh_shape=mesh_shape)
    S = 16 if kind == "prefill" else 32
    c, shape, lowered = dryrun.lower_combo(
        cfg, ShapeSpec("t", S, 4, kind), mesh, dtype=torch.float32)
    with FlopCounterMode(display=False) as fc, _Products(fc) as rec:
        got = lowered.run()
    return rec.calls, got["collectives"], lowered


@pytest.mark.parametrize("kv_heads", [2, 4])
@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_tp_serving_splits_every_sharded_product(kind, kv_heads):
    """On a (1, 4) mesh the dense serving step is the tensor-parallel one:
    every product whose weight the plan splits counts exactly a quarter
    of the (1, 1) step's FLOPs, every other product its whole count
    (the attention core where 4 does not divide the KV heads: a rank
    then computes its quarter of ``wq wk wv`` by columns and of ``wo`` by
    rows around it); two all-reduces of [rows, S, D] a layer and the
    embedding's one, and where the KV heads do not split one all-gather
    a layer of the ranks' q, k and v columns, [rows, S, (H + 2 K) hd]
    whole; ``argument_bytes`` stays the reference's shards while
    ``held_bytes`` is what the rank holds."""
    cfg = llama_smoke().replace(n_kv_heads=kv_heads)
    full, none, one = _serve_products(cfg, kind, (1, 1))
    part, colls, four = _serve_products(cfg, kind, (1, 4))
    assert none == {} and len(full) == len(part) > 0
    split = 0
    for (_, b, f), (_, b4, f4) in zip(full, part):
        if b4 == b:
            assert f4 == f, (b, f, f4)
        else:
            split += 1
            assert 4 * f4 == f, (b, b4, f, f4)
    # per layer: wq wk wv wo, the two attention products where the heads
    # split, w_gate w_up w_down; the head
    per_layer = 7 + (2 if kv_heads == 4 else 0)
    assert split == cfg.n_layers * per_layer + 1
    S = 16 if kind == "prefill" else 1
    act = 4 * S * cfg.d_model * 4
    want = {"all-reduce": (2 * cfg.n_layers + 1) * act}
    if kv_heads == 2:
        qkv = (cfg.n_heads + 2 * kv_heads) * cfg.hd
        want["all-gather"] = cfg.n_layers * 4 * S * qkv * 4
    assert colls == want, (colls, want)
    assert four.argument_bytes < one.argument_bytes
    if kv_heads == 4 and kind == "decode":
        # a cache of one KV head in place of the reference's four
        assert four.held_bytes < four.argument_bytes
    if kv_heads == 2 and kind == "decode":
        # the reference's shards and its whole cache, to the byte
        assert four.held_bytes == four.argument_bytes


@pytest.fixture(scope="module")
def xla_tp_decode_flops():
    """XLA's ``cost_analysis()`` FLOPs a device of the reference's
    ``lower_combo`` for llama31-smoke's decode and train step at one
    layer (XLA counts a scan's body once) on a (1, 4) mesh of four
    emulated CPU devices, with 2 and with 4 KV heads, and of deepseek-v3's
    smoke decode (a subprocess: the device count is fixed at JAX's first
    use).  Returns {kv heads: decode FLOPs, "train<kv heads>": train
    FLOPs, "dsv3": deepseek-v3's decode FLOPs}."""
    import os
    import subprocess
    import sys
    script = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
assert len(jax.devices()) == 4
from repro import configs
from repro.configs.base import INPUT_SHAPES, ShapeSpec
from repro.configs.llama_paper import smoke
import repro.launch.dryrun as d
INPUT_SHAPES["tp_decode"] = ShapeSpec("tp_decode", 32, 4, "decode")
INPUT_SHAPES["tp_train"] = ShapeSpec("tp_train", 32, 4, "train")
mesh = jax.sharding.Mesh(np.array(jax.devices()).reshape(1, 4),
                         ("data", "model"))
for k, kv, shape in ((2, 2, "tp_decode"), (4, 4, "tp_decode"),
                     ("train4", 4, "tp_train"), ("train2", 2, "tp_train")):
    configs.get_config = lambda a: smoke().replace(n_layers=1, n_kv_heads=kv)
    _, _, lowered = d.lower_combo("llama31-smoke", shape, mesh,
                                  dtype=jnp.float32)
    cost = lowered.compile().cost_analysis()
    cost = cost[0] if isinstance(cost, list) else cost
    print("FLOPS", k, cost["flops"])
dsv3 = configs.get_smoke("deepseek-v3-671b")
configs.get_config = lambda a: dsv3
_, _, lowered = d.lower_combo("deepseek-v3-671b", "tp_decode", mesh,
                              dtype=jnp.float32)
cost = lowered.compile().cost_analysis()
cost = cost[0] if isinstance(cost, list) else cost
print("FLOPS dsv3", cost["flops"])
"""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", script], env=env, cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return {(int(k) if k.isdigit() else k): float(f) for k, f in
            (line.split()[1:] for line in out.stdout.splitlines()
             if line.startswith("FLOPS"))}


@pytest.mark.parametrize("kv_heads", [4, 2])
def test_tp_decode_flops_against_xla(kv_heads, xla_tp_decode_flops):
    """The port's per-device FLOPs of the tensor-parallel decode against
    XLA's for the reference's partitioned decode on (1, 4).  With 4 KV
    heads both split the heads over ``model``; with the smoke's own 2 (2
    % 4 != 0) both compute a quarter of ``wq wk wv`` by columns and of
    ``wo`` by rows, as the reference's ``param_spec`` stores them, and
    the attention core whole, as its ``constrain_attn`` rule says:
    within [0.9, 1.1] either way."""
    mesh = dryrun.production_mesh(mesh_shape=(1, 4))
    cfg, shape, lowered = dryrun.lower_combo(
        llama_smoke().replace(n_layers=1, n_kv_heads=kv_heads),
        ShapeSpec("tp_decode", 32, 4, "decode"), mesh, dtype=torch.float32)
    rec = dryrun.analyse(cfg, shape, lowered, mesh)
    ratio = rec["flops_per_device"] / xla_tp_decode_flops[kv_heads]
    assert 0.9 <= ratio <= 1.1, (rec["flops_per_device"], ratio)


@pytest.mark.parametrize("kv_heads", [4, 2])
def test_tp_train_flops_against_xla(kv_heads, xla_tp_decode_flops):
    """The port's per-device FLOPs of the tensor-parallel train step
    (``models.tp.forward_train``, the vocabulary-parallel log-prob, under
    ``remat_layers`` as the reference's dry run trains) against XLA's for
    the reference's partitioned train step, llama31-smoke at one layer
    on (1, 4): both split the MLP and the vocabulary over ``model``, and
    the heads with 4 KV heads, ``wq wk wv`` by columns and ``wo`` by rows
    around a whole attention core with 2; within [0.9, 1.1] (XLA counts
    elementwise work too, ``FlopCounterMode`` products only)."""
    mesh = dryrun.production_mesh(mesh_shape=(1, 4))
    cfg, shape, lowered = dryrun.lower_combo(
        llama_smoke().replace(n_layers=1, n_kv_heads=kv_heads),
        ShapeSpec("tp_train", 32, 4, "train"), mesh, dtype=torch.float32)
    rec = dryrun.analyse(cfg, shape, lowered, mesh)
    ratio = rec["flops_per_device"] / xla_tp_decode_flops[f"train{kv_heads}"]
    assert 0.9 <= ratio <= 1.1, (rec["flops_per_device"], ratio)


def test_tp_moe_decode_flops_against_xla(xla_tp_decode_flops):
    """The port's per-device FLOPs of deepseek-v3's smoke decode on (1, 4),
    tensor-parallel (MLA on one of its 4 heads a rank over the whole
    latent, one of 4 experts and a quarter of the shared expert's and of
    the dense layer's columns, a quarter of the vocabulary), against
    XLA's for the reference's partitioned decode: within [0.9, 1.1].
    Every leaf splits as the reference's serve shards split it and the
    latent cache is whole in both, so the rank holds the reference's
    arguments to the byte."""
    mesh = dryrun.production_mesh(mesh_shape=(1, 4))
    cfg, shape, lowered = dryrun.lower_combo(
        configs.get_smoke("deepseek-v3-671b"),
        ShapeSpec("tp_decode", 32, 4, "decode"), mesh, dtype=torch.float32)
    rec = dryrun.analyse(cfg, shape, lowered, mesh)
    ratio = rec["flops_per_device"] / xla_tp_decode_flops["dsv3"]
    assert 0.9 <= ratio <= 1.1, (rec["flops_per_device"], ratio)
    assert rec["held_bytes"] == rec["argument_bytes"], rec
    assert set(rec["collectives"]) == {"all-reduce"}, rec


def test_tp_moe_collectives_counted():
    """The dry run counts a MoE rank's collectives at their seams on (1,
    4), deepseek-v3's smoke (a dense MLA layer, an MLA + MoE layer, the
    MTP head): decoding, one all-reduce of [rows, 1, D] for each layer's
    ``wo`` and one for its MLP or its experts and shared expert
    together, and the embedding's; training, the all-gathers of the
    log-prob's [rows, T - 1, 3] and the MTP loss's [rows, T - 2, 3]
    partials and of the MTP ``proj``'s [rows, T, D / 4] output."""
    cfg = configs.get_smoke("deepseek-v3-671b")
    mesh = dryrun.production_mesh(mesh_shape=(1, 4))
    B, T, D = 4, 32, cfg.d_model
    _, _, lowered = dryrun.lower_combo(
        cfg, ShapeSpec("d", T, B, "decode"), mesh, dtype=torch.float32)
    got = lowered.run()["collectives"]
    assert got == {"all-reduce": (2 * cfg.n_layers + 1) * B * D * 4}, got
    _, _, lowered = dryrun.lower_combo(
        cfg, ShapeSpec("t", T, B, "train"), mesh, dtype=torch.float32)
    got = lowered.run()["collectives"]
    want = 4 * 4 * (B * (T - 1) * 3 + B * (T - 2) * 3 + B * T * D // 4)
    assert got["all-gather"] == want, got
