"""The port's sharding rules against the JAX package's, spec for spec, with no devices.

For all 11 archs at full width, on the five meshes below, every parameter
leaf's spec from ``repro_torch.distributed.sharding.params_pspecs`` (shapes
from ``repro_torch.launch.shapes`` on the meta device) equals the JAX
``params_pspecs`` (shapes from ``repro.launch.shapes.params_specs``, the
rules run on a ``jax.sharding.AbstractMesh``); the same for
``batch_pspecs`` on each arch's train and prefill inputs and for
``cache_pspecs`` on its ``decode_32k`` cache.  Then the DTensor placements
the specs turn into, and two rules pinned by name: the stacked dense FFN
taking the MoE rule (its layer dim on ``model``), and the few-expert
branch (mixtral-8x22b's FFN width over ``("model", "data")``).
"""

from __future__ import annotations

import jax
import pytest
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as jax_config
from repro.distributed import sharding as jsh
from repro.launch import shapes as jshapes

from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.distributed import sharding as tsh
from repro_torch.launch import shapes as tshapes
from repro_torch.launch.mesh import LocalMesh

MESHES = {
    "data16_model16": {"data": 16, "model": 16},
    "pod2_data16_model16": {"pod": 2, "data": 16, "model": 16},
    "pod2_data2_model2": {"pod": 2, "data": 2, "model": 2},
    "data2_model2": {"data": 2, "model": 2},
    "pod4_data1_model1": {"pod": 4, "data": 1, "model": 1},
}


def _abstract(sizes):
    return AbstractMesh(tuple(sizes.values()), tuple(sizes))


def _jax_flat(specs):
    leaves, _ = jax.tree_util.tree_flatten_with_path(specs, is_leaf=lambda x: isinstance(x, P))
    return {jax.tree_util.keystr(path): tuple(spec) for path, spec in leaves}


def _port_flat(specs, prefix=""):
    """Spec trees: dicts and lists are nodes, spec tuples the leaves; keys as keystr writes them."""
    if isinstance(specs, dict):
        out = {}
        for k, v in specs.items():
            out.update(_port_flat(v, f"{prefix}[{k!r}]"))
        return out
    if isinstance(specs, list):
        out = {}
        for i, v in enumerate(specs):
            out.update(_port_flat(v, f"{prefix}[{i}]"))
        return out
    return {prefix: specs}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_params_pspecs_equal_jax(arch, mesh):
    sizes = MESHES[mesh]
    want = _jax_flat(jsh.params_pspecs(jshapes.params_specs(jax_config(arch)), _abstract(sizes)))
    got = _port_flat(tsh.params_pspecs(tshapes.params_specs(get_config(arch)), sizes))
    assert got == want


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_batch_and_cache_pspecs_equal_jax(arch, mesh):
    sizes = MESHES[mesh]
    amesh = _abstract(sizes)
    jcfg, cfg = jax_config(arch), get_config(arch)
    for shape in ("train_4k", "prefill_32k"):
        want = _jax_flat(jsh.batch_pspecs(jshapes.input_specs(jcfg, shape)["batch"], amesh))
        got = _port_flat(tsh.batch_pspecs(tshapes.input_specs(cfg, shape)["batch"], sizes))
        assert got == want, shape
    want = _jax_flat(jsh.cache_pspecs(jshapes.decode_cache_specs(jcfg, "decode_32k"), amesh))
    got = _port_flat(tsh.cache_pspecs(tshapes.decode_cache_specs(cfg, "decode_32k"), sizes))
    assert got == want


@pytest.mark.parametrize("strategy", ["hier", "hier_int8", "local_sgd"])
def test_state_pspecs_equal_jax(strategy):
    """The train state follows the parameters' specs, as the JAX
    ``state_pspecs`` gives them (its TrainState and AdamWState field by field)."""
    from repro.distributed.steps import state_pspecs as jax_state_pspecs

    from repro_torch.distributed import state_pspecs

    sizes = MESHES["pod2_data2_model2"]
    want = jax_state_pspecs(jshapes.params_specs(jax_config("distilgpt2-82m")), _abstract(sizes), strategy=strategy)
    got = state_pspecs(tshapes.params_specs(get_config("distilgpt2-82m")), sizes, strategy=strategy)
    assert tuple(want.adam.step) == got.adam.step == ()
    for field in ("m", "v"):
        assert _port_flat(getattr(got.adam, field)) == _jax_flat(getattr(want.adam, field))
    assert (got.ef == ()) == (want.ef == ())
    if got.ef != ():
        assert _port_flat(got.ef) == _jax_flat(want.ef)
    assert (got.diloco == ()) == (want.diloco == ())
    if got.diloco != ():
        assert _port_flat(got.diloco.anchor) == _jax_flat(want.diloco.anchor)
        assert _port_flat(got.diloco.momentum) == _jax_flat(want.diloco.momentum)


def test_rules_take_any_mesh_form():
    """A plain dict and a ``LocalMesh`` of the same sizes give one answer."""
    specs = tshapes.params_specs(get_config("distilgpt2-82m"))
    sizes = {"pod": 2, "data": 1, "model": 1}
    assert tsh.params_pspecs(specs, sizes) == tsh.params_pspecs(specs, LocalMesh(sizes))


def test_dense_ffn_takes_the_moe_rule():
    """``sharding.py:95`` keys the MoE branch on name and rank alone: a
    stacked dense FFN ``[L, D, F]`` puts its layer dim on ``model``."""
    sizes = {"data": 2, "model": 2}
    ffn = tsh.params_pspecs(tshapes.params_specs(get_config("distilgpt2-82m")), sizes)["groups"]["slot0"]["ffn"]
    assert ffn["w_up"] == ("model", None, "data")
    assert ffn["w_down"] == ("model", "data", None)
    assert ffn["b_up"] == (None, "model")


def test_few_expert_branch_and_its_strided_placement():
    """Mixtral's 8 experts on a 16-way model axis: the FFN width over
    ``("model", "data")``, model-major, which DTensor places as a strided
    shard on ``data`` and a shard on ``model``."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.placement_types import _StridedShard

    sizes = {"pod": 2, "data": 16, "model": 16}
    params = tshapes.params_specs(get_config("mixtral-8x22b"))
    specs = tsh.params_pspecs(params, sizes)
    moe = specs["groups"]["slot0"]["ffn"]
    assert moe["w_up"] == (None, None, None, ("model", "data"))
    assert moe["w_down"] == (None, None, ("model", "data"), None)
    pl = tsh.params_placements(params, sizes)["groups"]["slot0"]["ffn"]
    assert pl["w_up"] == (Replicate(), _StridedShard(3, split_factor=16), Shard(3))
    assert pl["w_down"] == (Replicate(), _StridedShard(2, split_factor=16), Shard(2))


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_placements_follow_the_specs(arch):
    """One placement per mesh axis: ``Shard(d)`` where dim d names the axis
    (a strided shard for the earlier mesh axis of a model-major pair),
    ``Replicate()`` where none does; parameters replicated over ``pod``,
    the batch sharded over it."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.placement_types import _StridedShard

    sizes = MESHES["pod2_data2_model2"]
    axes = tuple(sizes)
    params = tshapes.params_specs(get_config(arch))
    specs = _port_flat(tsh.params_pspecs(params, sizes))
    placements = _port_flat(tsh.params_placements(params, sizes))
    assert set(specs) == set(placements)
    for key, spec in specs.items():
        pl = placements[key]
        assert len(pl) == 3 and pl[0] == Replicate(), key
        for axis, p in zip(axes, pl):
            dims = [d for d, e in enumerate(spec) if e == axis or (isinstance(e, tuple) and axis in e)]
            want = Shard(dims[0]) if dims else Replicate()
            joint = spec[dims[0]] if dims else None
            if isinstance(joint, tuple) and joint[0] != axis and axes.index(axis) < axes.index(joint[0]):
                want = _StridedShard(dims[0], split_factor=sizes[joint[0]])  # model-major over data, model
            assert p == want, (key, axis)
    batch = tsh.batch_placements(tshapes.input_specs(get_config(arch), "train_4k")["batch"], sizes)
    for p in batch.values():
        assert p == (Shard(0), Shard(0), Replicate())
