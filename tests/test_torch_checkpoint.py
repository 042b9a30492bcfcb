"""The port's checkpoint store and tree keys against the JAX package's, on the CPU.

A checkpoint is a directory of ``.npy`` files and a manifest whose leaf keys
are ``jax.tree_util.keystr`` strings, so the two stores must agree on every
key, file and byte: each restores what the other wrote, exactly (no
tolerance: the values go through ``np.save`` and back unchanged).
"""

import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointStore as JaxStore
from repro.configs import get_smoke_config as jax_smoke
from repro.distributed.steps import init_train_state as jax_init_train_state
from repro.models import init_params as jax_init_params
from repro.optim.adamw import AdamWConfig as JaxAdamWConfig
from repro_torch.checkpoint import AsyncCheckpointer, CheckpointStore
from repro_torch.convert import params_from_numpy
from repro_torch.distributed import TrainState, init_pod_params, init_train_state
from repro_torch.optim import AdamWConfig
from repro_torch.tree import tree_items, tree_keystr_items, tree_leaves, tree_map, tree_unflatten

ARCH = "distilgpt2-82m"
STRATEGIES = ("allreduce", "ps", "hier", "hier_int8", "local_sgd")


def _jax_keys(tree):
    return [jax.tree_util.keystr(path) for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _random_like(tree, seed):
    """``tree`` with every leaf redrawn from a seed (ints for the step)."""
    rng = np.random.default_rng(seed)

    def draw(a):
        if jnp.issubdtype(a.dtype, jnp.integer):
            return jnp.asarray(rng.integers(1, 1000, a.shape).astype(a.dtype))
        return jnp.asarray(rng.standard_normal(a.shape).astype(a.dtype))

    return jax.tree.map(draw, tree)


def _pair(case, seed):
    """The same values as a JAX tree and as the port's tree.

    ``allreduce``: (params, TrainState) on one pod.  ``hier_int8``:
    (params, AdamWState) -- the port keeps the error feedback per pod
    ([npods, ...]), the JAX state one pod's view of it."""
    jparams = jax_init_params(jax.random.PRNGKey(seed), jax_smoke(ARCH))
    jstate = jax_init_train_state(jparams, JaxAdamWConfig(), strategy=case)
    jtree = _random_like((jparams, jstate) if case == "allreduce" else (jparams, jstate.adam), seed + 1)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    state = init_train_state(params, AdamWConfig(), strategy=case, npods=2)
    like = (params, state) if case == "allreduce" else (params, state.adam)
    port = tree_unflatten(like, [torch.from_numpy(np.array(a)) for a in jax.tree.leaves(jtree)])
    return jtree, port


def _assert_equal(port_tree, jax_tree):
    port = list(tree_keystr_items(port_tree))
    assert [k for k, _ in port] == _jax_keys(jax_tree)
    for (key, t), a in zip(port, jax.tree.leaves(jax_tree)):
        assert t.dtype == torch.from_numpy(np.array(a)).dtype, key
        np.testing.assert_array_equal(t.numpy(), np.asarray(a), err_msg=key)


# -- tree keys -------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["distilgpt2-82m", "recurrentgemma-9b"])
@pytest.mark.parametrize("strategy", ["allreduce", "hier_int8", "local_sgd"])
def test_keystrs_match_jax(arch, strategy):
    """Every leaf of (params, TrainState) gets the key the JAX store gives
    it.  recurrentgemma-9b's smoke config holds its remainder layers in a
    list (``[0]['remainder'][0]['ffn']['w_down']``)."""
    jparams = jax_init_params(jax.random.PRNGKey(0), jax_smoke(arch))
    jstate = jax_init_train_state(jparams, JaxAdamWConfig(), strategy=strategy)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    state = init_train_state(params, AdamWConfig(), strategy=strategy, npods=2)
    tree = (init_pod_params(params, strategy=strategy, npods=2), state)
    keys = [k for k, _ in tree_keystr_items(tree)]
    assert keys == _jax_keys((jparams, jstate))
    assert "[1].adam.step" in keys
    if strategy == "local_sgd":
        assert "[1].diloco.anchor['embed']" in keys and "[1].diloco.momentum['embed']" in keys
    if arch == "recurrentgemma-9b":
        assert any(k.startswith("[0]['remainder'][0]") for k in keys)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_tree_map_rebuilds_a_train_state(strategy):
    """tree_map and tree_unflatten rebuild NamedTuples field by field."""
    params = params_from_numpy(
        jax.tree.map(np.asarray, jax_init_params(jax.random.PRNGKey(1), jax_smoke(ARCH))), device="cpu")
    state = init_train_state(params, AdamWConfig(), strategy=strategy, npods=2)
    doubled = tree_map(lambda t: t * 2, state)
    assert type(doubled) is TrainState and type(doubled.adam) is type(state.adam)
    assert type(doubled.diloco) is type(state.diloco)
    back = tree_unflatten(state, tree_leaves(doubled))
    assert type(back) is TrainState
    for (path, a), (_, b) in zip(tree_items(back), tree_items(state)):
        assert torch.equal(a, b * 2), path
    # tree_items' slash paths are unchanged: tuple fields by index (adam.m is "0/1")
    assert "0/1/embed" in dict(tree_items(state))


# -- restore across the packages ---------------------------------------------------


@pytest.mark.parametrize("case", ["allreduce", "hier_int8"])
def test_jax_checkpoint_restores_into_the_port(tmp_path, case):
    jtree, port = _pair(case, seed=2)
    JaxStore(tmp_path).save(3, jtree, metadata={"data_step": 3})
    like = tree_map(torch.zeros_like, port)
    got, meta = CheckpointStore(tmp_path).restore(3, like)
    assert meta == {"data_step": 3}
    _assert_equal(got, jtree)


@pytest.mark.parametrize("case", ["allreduce", "hier_int8"])
def test_port_checkpoint_restores_into_jax(tmp_path, case):
    jtree, port = _pair(case, seed=3)
    CheckpointStore(tmp_path).save(5, port, metadata={"data_step": 5})
    got, meta = JaxStore(tmp_path).restore(5, jax.tree.map(jnp.zeros_like, jtree))
    assert meta == {"data_step": 5}
    _assert_equal(port, got)
    _assert_equal(port, jtree)


def test_pinned_clock_gives_the_jax_stores_bytes(tmp_path):
    """The same tree through both stores with the clock pinned: the same
    manifest, marker and array files, byte for byte."""
    jtree, port = _pair("allreduce", seed=4)
    JaxStore(tmp_path / "jax", clock=lambda: 1234.5).save(7, jtree, metadata={"data_step": 7})
    CheckpointStore(tmp_path / "port", clock=lambda: 1234.5).save(7, port, metadata={"data_step": 7})
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    files = sorted(p.relative_to(jdir) for p in jdir.rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(pdir) for p in pdir.rglob("*") if p.is_file())
    assert len(files) == len(jax.tree.leaves(jtree)) + 2
    for f in files:
        assert (jdir / f).read_bytes() == (pdir / f).read_bytes(), f
    manifest = json.loads((pdir / "step_00000007" / "manifest.json").read_text())
    assert manifest["written_at"] == 1234.5 and manifest["leaves"][0]["key"] == "[0]['embed']"


# -- the store's own behaviour (tests/test_runtime.py::TestCheckpoint, on the port) ------


def _small_tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn(4, 8, generator=g), "b": [torch.arange(5, dtype=torch.int32), torch.randn(3, generator=g)]}


def test_roundtrip_latest_and_gc(tmp_path):
    store = CheckpointStore(tmp_path, keep=2)
    for step in (1, 2, 3):
        store.save(step, _small_tree(step))
    assert store.steps() == [2, 3] and store.latest_step() == 3
    assert not (tmp_path / "step_00000001").exists()
    step, got, _ = store.restore_latest(_small_tree())
    assert step == 3
    for (k, a), (_, b) in zip(tree_keystr_items(got), tree_keystr_items(_small_tree(3))):
        assert torch.equal(a, b), k
    assert store.nbytes(3) > 4 * (32 + 5 + 3)


def test_corruption_raises_ioerror(tmp_path):
    store = CheckpointStore(tmp_path)
    store.save(1, _small_tree())
    f = tmp_path / "step_00000001" / "arr_00000.npy"
    raw = bytearray(f.read_bytes())
    raw[-1] ^= 0xFF
    f.write_bytes(bytes(raw))
    with pytest.raises(IOError, match="checksum"):
        store.restore(1, _small_tree())


def test_shape_mismatch_raises(tmp_path):
    store = CheckpointStore(tmp_path)
    store.save(1, _small_tree())
    like = _small_tree()
    like["a"] = torch.zeros(8, 4)
    with pytest.raises(ValueError, match="shape"):
        store.restore(1, like)


def test_uncommitted_step_is_invisible(tmp_path):
    store = CheckpointStore(tmp_path)
    store.save(1, _small_tree())
    shutil.copytree(tmp_path / "step_00000001", tmp_path / "step_00000002")  # no marker
    assert store.latest_step() == 1
    with pytest.raises(FileNotFoundError):
        store.restore(2, _small_tree())


def test_async_save_snapshots_before_the_tree_changes(tmp_path):
    ck = AsyncCheckpointer(CheckpointStore(tmp_path))
    tree = _small_tree(5)
    want = tree_map(torch.clone, tree)
    ck.save(4, tree, metadata={"data_step": 4})
    tree["a"].add_(100.0)  # the step after the save mutates nothing the snapshot holds
    ck.wait()
    assert ck.snapshot_s > 0 and ck.write_s > 0
    got, meta = CheckpointStore(tmp_path).restore(4, _small_tree())
    assert meta == {"data_step": 4} and torch.equal(got["a"], want["a"])


def test_async_error_is_raised_on_wait(tmp_path):
    root = tmp_path / "ck"
    ck = AsyncCheckpointer(CheckpointStore(root))
    shutil.rmtree(root)
    root.write_text("a file where the directory was")  # the worker's mkdir fails
    ck.save(1, _small_tree())
    with pytest.raises(OSError):
        ck.wait()
    ck.wait()  # raised once, then cleared
