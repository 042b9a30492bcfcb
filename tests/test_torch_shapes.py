"""The port's sizing hooks against the JAX package's, on the CPU.

``repro_torch.launch.shapes`` builds every spec on the ``meta`` device;
``repro.launch.shapes`` through ``jax.eval_shape``.  Leaf for leaf (by
``jax.tree_util.keystr`` path) the two must have the same shapes and
dtypes, for every arch, and the simulator's ``model_grad_bytes`` /
``model_kv_bytes`` must give the same bytes.  The MoE and RG-LRU
parameters match the JAX leaves in structure and convert bit-exact both
ways.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import ALL_ARCHS
from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke
from repro.launch import shapes as jax_shapes
from repro.models import init_decode_cache as jax_init_decode_cache
from repro.models import init_params as jax_init_params
from repro.scenario import model_grad_bytes as jax_grad_bytes
from repro.scenario import model_kv_bytes as jax_kv_bytes
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.launch import shapes
from repro_torch.models import forward, init_decode_cache, init_params, loss_fn, prefill
from repro_torch.scenario import model_grad_bytes, model_kv_bytes

ROOT = Path(__file__).resolve().parents[1]

# (fp32 gradient bytes, decode-cache bytes per token) as the JAX package
# gives them; several KV values end in +1 from the decode_32k cache's small
# leaves (the int32 slot positions, recurrent states) after the division
# by 128 x 32768 tokens
SIZES = {
    "distilgpt2-82m": (324_504_576, 18_432),
    "rwkv6-7b": (30_138_728_448, 1_040),
    "recurrentgemma-9b": (37_584_781_312, 800),
    "mixtral-8x22b": (562_520_285_184, 28_672),
    "arctic-480b": (1_907_401_101_312, 143_361),
    "yi-34b": (137_555_668_992, 245_761),
    "phi-3-vision-4.2b": (15_296_901_120, 393_217),
    "starcoder2-7b": (29_601_665_024, 65_537),
    "chatglm3-6b": (24_974_794_752, 28_672),
    "olmo-1b": (4_707_057_664, 131_072),
    "musicgen-large": (9_703_014_400, 393_217),
}
UNPORTED_PASSES = ("mixtral-8x22b", "arctic-480b", "recurrentgemma-9b")


def _dtype_name(dt) -> str:
    return str(dt).removeprefix("torch.")


def _layout(tree):
    """{keystr path: (shape, dtype name)} of a JAX or a port tree."""
    return {
        jax.tree_util.keystr(path): (tuple(leaf.shape), _dtype_name(leaf.dtype))
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]
    }


def test_size_table_covers_every_arch():
    assert set(SIZES) == set(ALL_ARCHS)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_model_sizes_equal_jax(arch):
    assert (model_grad_bytes(arch), model_kv_bytes(arch)) == SIZES[arch]
    assert (jax_grad_bytes(arch), jax_kv_bytes(arch)) == SIZES[arch]
    assert model_kv_bytes(arch, tokens=1024) == 1024 * SIZES[arch][1]


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_params_specs_match_eval_shape(arch):
    port = shapes.params_specs(get_config(arch))
    assert all(t.device.type == "meta" for t in jax.tree.leaves(port))
    assert _layout(port) == _layout(jax_shapes.params_specs(jax_config(arch)))


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_decode_cache_specs_match_eval_shape(arch):
    port = shapes.decode_cache_specs(get_config(arch), "decode_32k")
    assert all(t.device.type == "meta" for t in jax.tree.leaves(port))
    assert _layout(port) == _layout(jax_shapes.decode_cache_specs(jax_config(arch), "decode_32k"))


@pytest.mark.parametrize("shape", sorted(jax_shapes.SHAPES))
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_input_specs_match_jax(arch, shape):
    cfg, jcfg = get_config(arch), jax_config(arch)
    ok = jax_shapes.shape_supported(jcfg, shape)
    assert shapes.shape_supported(cfg, shape) == ok
    if not ok[0]:
        with pytest.raises(ValueError, match="unsupported"):
            shapes.input_specs(cfg, shape)
        return
    assert _layout(shapes.input_specs(cfg, shape)) == _layout(jax_shapes.input_specs(jcfg, shape))


def test_shape_table_equals_jax():
    assert {k: (s.name, s.seq_len, s.global_batch, s.kind) for k, s in shapes.SHAPES.items()} == {
        k: (s.name, s.seq_len, s.global_batch, s.kind) for k, s in jax_shapes.SHAPES.items()
    }


@pytest.mark.parametrize("arch", UNPORTED_PASSES)
def test_moe_and_rglru_init_match_jax_and_convert_bit_exact(arch):
    """The smoke config's parameters and decode cache: the JAX leaves'
    paths, shapes and dtypes; JAX values through the port and back, bit for
    bit; the port's own draws finite and of the JAX initialisers' spread."""
    cfg, jcfg = get_smoke_config(arch), jax_smoke(arch)
    port = init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    ref = jax.jit(lambda key: jax_init_params(key, jcfg))(jax.random.PRNGKey(0))
    assert _layout(port) == _layout(ref)
    assert _layout(init_decode_cache(cfg, 2, 16, device="cpu")) == _layout(
        jax.eval_shape(lambda: jax_init_decode_cache(jcfg, 2, 16))
    )
    ref_np = jax.tree.map(np.asarray, ref)
    back = params_to_numpy(params_from_numpy(ref_np, device="cpu"))
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(ref_np)[0], jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(b), a, err_msg=jax.tree_util.keystr(path))
    flat = {jax.tree_util.keystr(p): t for p, t in jax.tree_util.tree_flatten_with_path(port)[0]}
    for key, t in flat.items():
        assert torch.isfinite(t).all(), key
    if cfg.moe is not None:
        router = [t for k, t in flat.items() if k.endswith("['router']")]
        assert router and all(t.dtype == torch.float32 for t in router)
        w_up = next(t for k, t in flat.items() if k.endswith("['ffn']['w_up']"))
        # truncated normal at +-2 std: 0.8796 of 1/sqrt(d_model)
        assert abs(w_up.float().std().item() * np.sqrt(cfg.d_model) - 0.8796) < 0.05


def test_lru_lambda_matches_jax():
    """``lru_lambda`` is drawn from no RNG: the logit of
    linspace(0.9, 0.999)^(1/8) in float32, as the JAX package computes it.
    The two libraries' float32 ``linspace``/``log``/``exp`` round a few
    entries differently (at most ~5e-6 of the value): rtol 1e-5."""
    from repro.models.rglru import init_rglru_block as jax_rglru
    from repro_torch.models.rglru import init_rglru_block

    cfg, jcfg = get_smoke_config("recurrentgemma-9b"), jax_smoke("recurrentgemma-9b")
    port = init_rglru_block(cfg, generator=torch.Generator().manual_seed(0), device=torch.device("cpu"))
    ref = jax_rglru(jax.random.PRNGKey(0), jcfg)
    assert port["lru_lambda"].dtype == torch.float32
    np.testing.assert_allclose(port["lru_lambda"].numpy(), np.asarray(ref["lru_lambda"]), rtol=1e-5, atol=0)


@pytest.mark.parametrize("arch", UNPORTED_PASSES)
def test_passes_through_moe_and_rglru_raise_naming_their_item(arch):
    """The passes that once raised naming their item (MoE item 11, RG-LRU
    item 12) run: forward, loss (with the MoE router's aux loss above 0)
    and prefill give finite outputs of the expected shapes; each arch's
    parity with JAX is in ``test_torch_moe.py``, ``test_torch_rglru.py``,
    ``test_torch_serve.py`` and ``test_torch_train.py``."""
    cfg = get_smoke_config(arch)
    params = init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.zeros((1, 5), dtype=torch.long)
    logits, aux = forward(params, {"tokens": tokens}, cfg)
    loss, metrics = loss_fn(params, {"tokens": tokens, "labels": tokens}, cfg)
    last, _ = prefill(params, {"tokens": tokens}, cfg)
    outs = [logits, loss, last]
    assert [tuple(o.shape) for o in outs] == [(1, 5, cfg.vocab_size), (), (1, cfg.vocab_size)]
    assert all(torch.isfinite(o).all() for o in outs)
    assert aux.shape == () and torch.equal(aux, metrics["aux"])
    assert (aux.item() > 0) == (cfg.moe is not None)


def test_train_cli_takes_a_named_shape(monkeypatch, capsys):
    """``--shape`` sets the sequence length and global batch, as in the JAX
    CLI; a tiny shape stands in for train_4k on the CPU."""
    from repro_torch.launch import train

    monkeypatch.setitem(shapes.SHAPES, "tiny_train", shapes.ShapeSpec("tiny_train", 16, 2, "train"))
    train.main(["--shape", "tiny_train", "--device", "cpu", "--steps", "1"])
    assert "(1 pods, hier, 2 x 16)" in capsys.readouterr().out
    with pytest.raises(KeyError):
        train.main(["--shape", "no_such_shape", "--device", "cpu", "--steps", "1"])


def test_sizing_hooks_import_no_jax():
    code = (
        "import sys\n"
        "from repro_torch.scenario import model_grad_bytes, model_kv_bytes\n"
        "print(model_grad_bytes('mixtral-8x22b'), model_kv_bytes('recurrentgemma-9b'))\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')]\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == [str(SIZES["mixtral-8x22b"][0]), str(SIZES["recurrentgemma-9b"][1])]
