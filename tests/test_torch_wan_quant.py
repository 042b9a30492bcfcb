"""The port's WAN int8 quantiser against the JAX package's.

On the CPU the port's wrappers compute their plain versions.  They are held
against the JAX Pallas kernels in interpret mode (``repro.kernels.wan_quant``
through its ``ops`` wrappers, which pad to 256 lanes) and against the sync
path's ``int8_compress`` / ``int8_decompress``.  Tolerances: the int8 values
must equal ``int8_compress``'s exactly; against the Pallas kernel the JAX
suite's own bar holds (``tests/test_kernels.py::TestWanQuant``: |dq| <= 1 on
fewer than 1e-3 of lanes, scales at rtol 1e-6); dequantisation is one
float32 multiply on both sides, so it is exact.  ``tests/test_torch_cuda.py``
holds the CUDA kernels to the plain versions on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed.compression import int8_compress as jax_compress
from repro.distributed.compression import int8_decompress as jax_decompress
from repro.kernels.wan_quant import ops as jax_ops
from repro.kernels.wan_quant.kernel import wan_dequant as jax_wan_dequant
from repro_torch.distributed.compression import compressed_bytes, int8_compress, int8_decompress
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels.wan_quant import dequantize, quantize, wan_dequant, wan_quant


def _x(seed, shape, scale=5.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _as(a, dtype):
    """The same values for both frameworks: bf16 rounded once, by JAX."""
    j = jnp.asarray(a, getattr(jnp, dtype))
    t = torch.tensor(np.asarray(j.astype(jnp.float32))).to(getattr(torch, dtype))
    return j, t


def _suite_bar(q_port, q_jax):
    dq = np.abs(np.asarray(q_port, np.int32) - np.asarray(q_jax, np.int32))
    assert dq.max() <= 1
    assert (dq != 0).mean() < 1e-3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(8, 256), (13, 300), (64, 512), (5, 1000)], ids=str)
def test_quant_matches_jax_kernel_and_compress(dtype, shape):
    jx, tx = _as(_x(shape[0] * 7 + shape[1], shape), dtype)
    q, s = wan_quant(tx)
    lanes = -(-shape[1] // 256) * 256
    assert q.shape == (shape[0], lanes) and q.dtype == torch.int8
    assert s.shape == (shape[0], lanes // 256) and s.dtype == torch.float32
    qk, sk = jax_ops.quantize(jx, interpret=True)
    _suite_bar(q.numpy(), qk)
    np.testing.assert_allclose(s.numpy(), np.asarray(sk), rtol=1e-6)
    c = jax_compress(jx)
    np.testing.assert_array_equal(q.numpy(), np.asarray(c.values))
    np.testing.assert_array_equal(s.numpy(), np.asarray(c.scales))
    assert (q.numpy()[:, shape[1]:] == 0).all()  # the zero padding stays zero


@pytest.mark.parametrize("shape", [(8, 256), (13, 300), (64, 512)], ids=str)
def test_dequant_matches_jax_kernel(shape):
    jx, tx = _as(_x(shape[1], shape), "float32")
    qk, sk = jax_ops.quantize(jx, interpret=True)
    expected = np.asarray(jax_wan_dequant(qk, sk, row_tile=1, interpret=True))[:, : shape[1]]
    out = wan_dequant(torch.tensor(np.asarray(qk)), torch.tensor(np.asarray(sk)), shape[1])
    assert out.shape == shape and out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), expected)


@pytest.mark.parametrize("shape", [(), (7,), (300,), (3, 5, 300), (2, 6, 768)], ids=str)
def test_leaf_roundtrip_matches_jax_ops_and_compress(shape):
    jx, tx = _as(_x(len(shape) + 1, shape), "float32")
    q, s = quantize(tx)
    qk, sk = jax_ops.quantize(jx, interpret=True)
    _suite_bar(q.numpy(), qk)  # XLA's jit of the kernel may round absmax / 127 one ulp apart
    np.testing.assert_allclose(s.numpy(), np.asarray(sk), rtol=1e-6)
    back = dequantize(q, s, shape)
    assert back.shape == shape
    if shape:  # the JAX ops wrapper cannot reshape a 0-d leaf back; int8_decompress below can
        np.testing.assert_array_equal(
            back.numpy(), np.asarray(jax_ops.dequantize(q.numpy(), s.numpy(), orig_shape=shape, interpret=True))
        )
    c, jc = int8_compress(tx), jax_compress(jx)
    np.testing.assert_array_equal(c.values.numpy(), np.asarray(jc.values))
    np.testing.assert_array_equal(c.scales.numpy(), np.asarray(jc.scales))
    assert (c.orig_last, c.orig_shape) == (jc.orig_last, jc.orig_shape)
    np.testing.assert_array_equal(int8_decompress(c).numpy(), np.asarray(jax_decompress(jc)))
    assert compressed_bytes(c) == jc.values.size + jc.scales.size * 4


def test_all_zero_block_has_scale_one():
    x = np.zeros((3, 512), np.float32)
    x[1, 300] = 2.0  # only the second row's second block is non-zero
    q, s = wan_quant(torch.from_numpy(x))
    expected = np.ones((3, 2), np.float32)
    expected[1, 1] = 2.0 / 127.0
    np.testing.assert_array_equal(s.numpy(), expected)
    assert q.numpy()[1, 300] == 127 and np.count_nonzero(q.numpy()) == 1
    np.testing.assert_array_equal(s.numpy(), np.asarray(jax_compress(jnp.asarray(x)).scales))


def test_ties_round_half_to_even_and_clip():
    """absmax 127 gives scale 1 exactly, so x / scale lands on the .5 ties."""
    row = np.zeros(256, np.float32)
    row[:9] = [127.0, -127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5]
    q, s = wan_quant(torch.from_numpy(row[None]))
    assert s.item() == 1.0
    np.testing.assert_array_equal(q.numpy()[0, :9], [127, -127, 0, 2, 2, 0, -2, -2, 126])
    np.testing.assert_array_equal(q.numpy(), np.asarray(jax_compress(jnp.asarray(row[None])).values))
    qk, _ = jax_ops.quantize(jnp.asarray(row[None]), interpret=True)
    np.testing.assert_array_equal(q.numpy(), np.asarray(qk))


def test_cpu_wrappers_count_no_launch_and_reject_bad_input():
    before = (LAUNCHES["wan_quant"], LAUNCHES["wan_dequant"])
    q, s = wan_quant(torch.ones((2, 300)))
    wan_dequant(q, s, 300)
    assert (LAUNCHES["wan_quant"], LAUNCHES["wan_dequant"]) == before
    with pytest.raises(ValueError, match="rows, cols"):
        wan_quant(torch.ones(300))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        wan_quant(torch.ones((2, 4), dtype=torch.float16))
    with pytest.raises(ValueError, match="disagree"):
        wan_dequant(q, s, 600)
