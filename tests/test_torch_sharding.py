"""The port's partitioning rules (``dalle_tpu_torch/parallel/sharding.py``)
against the JAX package's (``dalle_tpu/parallel/sharding.py``).

For every leaf of the tiny, flagship, XL and ``dense_scan`` trees, and of
their 8-bit LAMB states, the port's ``param_specs``, ``param_shardings``
and ``opt_state_shardings`` equal the JAX package's specs on the same mesh
shapes (JAX's meshes over the 8 virtual CPU devices of tests/conftest.py).
Tolerance: exact. The JAX trees are shapes only (``jax.eval_shape``); the
port's models are built on the meta device. Then, in a ``gloo`` group of
four processes, ``shard_tensor``/``unshard_tensor`` and
``shard_train_state`` round-trip every leaf exactly, and each
differentiable collective of ``parallel/collectives.py`` equals its
definition forward and backward.
"""

from pathlib import Path

import jax
import pytest
import torch

from dalle_tpu import config as jconfig
from dalle_tpu.models.dalle import DALLE as JaxDALLE
from dalle_tpu.optim import make_optimizer as jax_make_optimizer
from dalle_tpu.ops.quant import Quantized as JaxQuantized
from dalle_tpu.parallel import mesh as jmesh
from dalle_tpu.parallel import sharding as jsharding
from dalle_tpu_torch import config as tconfig
from dalle_tpu_torch.models.dalle import DALLE
from dalle_tpu_torch.ops.quant import Quantized
from dalle_tpu_torch.parallel import mesh as tmesh
from dalle_tpu_torch.parallel import sharding as tsharding
from dalle_tpu_torch.parallel.launch import spawn
from dalle_tpu_torch.params import _port_name

torch.set_num_threads(2)
CHILDREN = str(Path(__file__).with_name("torch_mesh_children.py"))

ZOO = dict(attn_types=("axial_row", "axial_col", "full", "conv_like"),
           conv_kernel=3, final_conv_block=True)
TREES = {
    "tiny": ("tiny_model_config", dict()),
    "tiny_zoo": ("tiny_model_config", dict(depth=5, shared_block_cycle=4,
                                           **ZOO)),
    "dense_scan": ("tiny_model_config", dict(depth=9, shared_block_cycle=0,
                                             dense_scan=True, **ZOO)),
    "flagship": ("flagship_model_config", dict()),
    "xl": ("xl_model_config", dict()),
}
MESHES = [(1, 2, 2, 2), (2, 2, 2, 1), (1, 8, 1, 1), (1, 4, 2, 1),
          (2, 1, 4, 1), (1, 1, 8, 1)]
OPT = dict(min_8bit_size=1024, block_size=256)


def _configs(name):
    maker, kw = TREES[name]
    return getattr(jconfig, maker)(**kw), getattr(tconfig, maker)(**kw)


def _jax_shapes(jcfg):
    model = JaxDALLE(jcfg)
    t = jax.ShapeDtypeStruct((1, jcfg.text_seq_len), jax.numpy.int32)
    i = jax.ShapeDtypeStruct((1, jcfg.image_seq_len), jax.numpy.int32)
    params = jax.eval_shape(model.init, jax.random.PRNGKey(0), t, i)
    opt = jax.eval_shape(
        jax_make_optimizer(jconfig.OptimizerConfig(**OPT)).init, params)
    return params, opt


def _by_port_name(tree, is_leaf=None):
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]
    out = {}
    for path, leaf in flat:
        keys = tuple(str(p.key) for p in path)
        if keys[0] == "params":
            keys = keys[1:]
        out[_port_name(keys)] = leaf
    return out


def _spec(sharding):
    return tuple(sharding.spec)


def _port_state(model, opt_cfg):
    """The 8-bit state's moment layout (quantized where the leaf has
    ``min_8bit_size`` elements) as the port's ``Lamb8bit.init`` makes it,
    on the meta device."""
    from dalle_tpu_torch.optim.lamb8bit import Lamb8bitState
    moments = {}
    for name, p in model.named_parameters():
        if p.numel() >= opt_cfg.min_8bit_size:
            nb = -(-p.numel() // opt_cfg.block_size)
            moments[name] = Quantized(
                torch.empty((nb, opt_cfg.block_size), dtype=torch.uint8,
                            device="meta"),
                torch.empty((nb, 1), device="meta"), tuple(p.shape), True)
        else:
            moments[name] = torch.empty(p.shape, device="meta")
    return Lamb8bitState(0, moments, dict(moments))


@pytest.mark.parametrize("tree", list(TREES))
def test_specs_equal_jax_for_every_leaf(tree):
    jcfg, tcfg = _configs(tree)
    jparams, jopt = _jax_shapes(jcfg)
    with torch.device("meta"):
        model = DALLE(tcfg)
    jspecs = _by_port_name(jsharding.param_specs(jparams))
    tspecs = tsharding.param_specs(model)
    assert set(jspecs) == set(tspecs)
    for name in tspecs:
        assert tspecs[name] == tuple(jspecs[name]), name
    opt_cfg = tconfig.OptimizerConfig(**OPT)
    tstate = _port_state(model, opt_cfg)
    for shape in MESHES:
        jm = jmesh.make_mesh(*shape)
        tm = tmesh.make_mesh(*shape, n_devices=8)
        jsh = _by_port_name(jsharding.param_shardings(jm, jparams))
        tsh = tsharding.param_shardings(tm, model)
        for name in tsh:
            assert tsh[name] == _spec(jsh[name]), (shape, name)
        jost = jsharding.opt_state_shardings(jm, jopt, jparams)
        tost = tsharding.opt_state_shardings(tm, tstate, model)
        assert tost.count == _spec(jost.count)
        for moment in ("mu", "nu"):
            jm_tree = _by_port_name(getattr(jost, moment),
                                    is_leaf=lambda x: isinstance(
                                        x, JaxQuantized))
            for name, t_spec in getattr(tost, moment).items():
                j_spec = jm_tree[name]
                if isinstance(j_spec, JaxQuantized):
                    assert isinstance(t_spec, Quantized), (shape, name)
                    assert t_spec.codes == _spec(j_spec.codes)
                    assert t_spec.absmax == _spec(j_spec.absmax)
                else:
                    assert t_spec == _spec(j_spec), (shape, moment, name)


def test_spec_rules_equal_jax():
    """The rule table and the path lookup, pattern for pattern."""
    assert [(p, tuple(s)) for p, s in jsharding.PARAM_RULES] == \
        list(tsharding.PARAM_RULES)
    for path in ("params/transformer/cycle/block_0/attn/q/kernel",
                 "params/transformer/block_wconv/ff/wo/kernel",
                 "params/token_emb", "params/transformer/final_norm/scale",
                 "params/transformer/block_1/ff/wi/bias"):
        assert tsharding.spec_for_path(path) == \
            tuple(jsharding.spec_for_path(path))


def test_mesh_layout_equals_jax():
    """Rank r sits where device r sits in the JAX mesh's device array,
    and the sizes resolve (and fail) as JAX's do."""
    for shape in MESHES:
        jm = jmesh.make_mesh(*shape)
        tm = tmesh.make_mesh(*shape, n_devices=8)
        ids = [[d.id for d in row] for row in jm.devices.reshape(8, 1)]
        for rank in range(8):
            c = tm.coords(rank)
            assert jm.devices[c["dp"], c["fsdp"], c["tp"], c["sp"]].id == \
                ids[rank][0]
    assert tmesh.make_mesh(-1, 2, 2, 1, n_devices=8).dp == 2
    for bad in ((-1, 3, 1, 1), (3, 2, 1, 1)):
        with pytest.raises(ValueError):
            jmesh.make_mesh(*bad)
        with pytest.raises(ValueError):
            tmesh.make_mesh(*bad, n_devices=8)


def test_shard_unshard_round_trips_in_a_group():
    """Four processes (fsdp=2 tp=2, then tp=2 sp=2): every spec's shard
    and gather give back the whole leaf, and ``shard_train_state`` keeps
    exactly the shards of a tiny zoo model's parameters and 8-bit
    moments."""
    for mesh in (dict(dp=1, fsdp=2, tp=2, sp=1),
                 dict(dp=1, fsdp=1, tp=2, sp=2)):
        cfg = dict(TREES["tiny_zoo"][1])
        if mesh["sp"] > 1:
            cfg["sequence_parallel"] = "ulysses"
        results = spawn(f"{CHILDREN}:roundtrip", 4,
                        dict(mesh=mesh, cfg=cfg), timeout=120)
        for r in results:
            assert r["ok"].all(), (mesh, r["ok"])


def test_collectives_forward_and_backward_in_a_group():
    """Each differentiable collective of ``parallel/collectives.py`` over
    four processes, forward and backward, equals its definition exactly
    (small integers in f32; bf16 bits through a permutation)."""
    results = spawn(f"{CHILDREN}:collectives_check", 4, {}, timeout=120)
    for rank, r in enumerate(results):
        bad = [k for k, v in r.items() if k != "stdout" and not bool(v)]
        assert not bad, (rank, bad)


BUILDS = [
    # sp a replica axis: sequence_parallel "none" at sp=2
    ("tiny_model_config", dict(), (1, 2, 1, 2)),
    # heads tp does not divide (XL: 28 heads at tp=8, 3.5 a rank)
    ("xl_model_config", dict(), (1, 1, 8, 1)),
    # tp divides no block leaf (dim 1024, inner 4096) but token_emb's rows
    ("flagship_model_config", dict(), (1, 1, 3, 1)),
    # blocks split by whole heads, the tied table's 256 rows whole
    ("tiny_model_config", dict(dim=96, heads=3, head_dim=32,
                               vocab_text=130), (1, 1, 3, 1)),
    # untied heads: the vocabulary over tp, or whole where it does not
    # divide (vocab_total 193)
    ("tiny_model_config", dict(tied_embeddings=False), (1, 2, 1, 1)),
    ("tiny_model_config", dict(tied_embeddings=False), (1, 2, 2, 1)),
    ("tiny_model_config", dict(tied_embeddings=False, vocab_image=65),
     (1, 2, 2, 1)),
]


def test_meshes_jax_runs_build_with_its_specs_and_its_refusals_stay():
    """Every mesh the JAX package runs builds the port's model, with JAX's
    shard specs on that mesh: ``sp > 1`` with ``sequence_parallel="none"``
    (every ``sp`` rank a replica), heads that ``tp`` does not divide,
    blocks that ``tp`` leaves whole, a tied table whose rows ``tp`` does
    not divide, and untied heads (``P("fsdp", "tp")``, ``tp`` dropped where
    it does not divide the vocabulary). What JAX's sequence-parallel
    attention raises stays refused when the model is built: Ulysses with
    heads per ``tp`` rank that ``sp`` does not divide, and the ring with a
    sequence that ``2*sp`` does not divide."""
    for maker, kw, axes in BUILDS:
        jcfg = getattr(jconfig, maker)(**kw)
        tcfg = getattr(tconfig, maker)(**kw)
        n = axes[0] * axes[1] * axes[2] * axes[3]
        jm = jmesh.make_mesh(*axes, devices=jax.devices()[:n])
        with torch.device("meta"):
            model = DALLE(tcfg, mesh=tmesh.make_mesh(*axes, n_devices=n))
        jsh = _by_port_name(jsharding.param_shardings(
            jm, _jax_shapes(jcfg)[0]))
        assert set(model.shard_specs) == set(jsh), (maker, kw, axes)
        for name, spec in model.shard_specs.items():
            assert spec == _spec(jsh[name]), (maker, kw, axes, name)
    with pytest.raises(ValueError, match="ulysses needs heads/tp"):
        DALLE(tconfig.tiny_model_config(sequence_parallel="ulysses",
                                        attn_types=("axial_row",)),
              mesh=tmesh.make_mesh(1, 1, 2, 4, n_devices=8))
    with pytest.raises(ValueError, match="zigzag ring needs"):
        DALLE(tconfig.tiny_model_config(sequence_parallel="ring",
                                        text_seq_len=12),
              mesh=tmesh.make_mesh(1, 1, 1, 4, n_devices=4))
