"""The port's row gathers on the CPU against the JAX package.

The same numpy inputs (seeded) go to the port's ``ops.gather`` and
``ops.gather_bag`` (which take their plain PyTorch versions for CPU
tensors) and to the reference's Pallas kernels in interpret mode and its
pure-jnp oracles.  Gathers are held bit for bit.  The bag is held in
float32 at the reference's own tolerance (``rtol = atol = 1e-5``,
tests/test_kernels.py), against both JAX versions; in bfloat16 it is held
to the Pallas kernel only, which sums float32 products and casts the sum
once, as the port does: the two float32 sums differ only in the order of
their K terms, so the outputs may differ by one bfloat16 rounding of the
sum (``rtol = 2**-7``) plus that order's float32 error (``atol = 1e-5``).
The reference's oracle sums in bfloat16 and rounds at every term.  The
port's kernel-order plain version (``ref.gather_bag_ordered_ref``: rounded
float32 products added in k order, what the CUDA kernel computes bit for
bit) is held to the Pallas kernel and to ``ref.gather_bag_ref`` at the
same tolerances.
"""
import ctypes
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.gather_runahead import ops as jax_ops
from repro.kernels.gather_runahead import ref as jax_ref
from repro_torch.checkpoint.convert import to_tensor
from repro_torch.kernels import _build
from repro_torch.kernels.gather_runahead import gather_runahead as kernel
from repro_torch.kernels.gather_runahead import ops, ref


def _bits(a) -> np.ndarray:
    """The raw bits of a port tensor or a JAX array, as unsigned ints."""
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int16) if a.dtype == torch.bfloat16 else a
        a = a.numpy()
    a = np.asarray(a)
    return a.view(np.uint16 if a.dtype.itemsize == 2 else np.uint32)


def _port(*arrays):
    return [to_tensor(np.asarray(a)) for a in arrays]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["runahead", "pipelined", "reference"])
@pytest.mark.parametrize("n,v,d", [(32, 128, 128), (64, 1024, 256)])
def test_gather_matches_jax_bit_exactly(impl, dtype, n, v, d):
    rng = np.random.default_rng(0)
    table = jnp.asarray(rng.normal(size=(v, d)), dtype)
    idx = jnp.asarray(rng.integers(0, v, n), jnp.int32)
    out = ops.gather(*_port(table, idx), impl=impl)
    assert out.dtype == getattr(torch, dtype) and out.shape == (n, d)
    pallas = "runahead" if impl == "reference" else impl
    for want in (jax_ops.gather(table, idx, impl=pallas),
                 jax_ref.gather_ref(table, idx)):
        np.testing.assert_array_equal(_bits(out), _bits(want))


@pytest.mark.parametrize("depth", [1, 2, 4, 16])
def test_gather_runahead_depth_invariance(depth):
    """The runahead window depth (MSHR analogue) does not change results."""
    rng = np.random.default_rng(1)
    table = jnp.asarray(rng.normal(size=(256, 128)), jnp.float32)
    idx = jnp.asarray(rng.integers(0, 256, 64), jnp.int32)
    out = ops.gather(*_port(table, idx), impl="runahead", depth=depth)
    for want in (jax_ops.gather(table, idx, impl="runahead", depth=depth),
                 jax_ref.gather_ref(table, idx)):
        np.testing.assert_array_equal(_bits(out), _bits(want))


@pytest.mark.parametrize("depth", [9, 16])
def test_gather_runahead_at_the_allocators_depths(depth):
    """Depths past 8 that ``core.runahead.allocate`` plans (up to 16), with
    more index blocks than the depth so the reference does not clamp it;
    the card takes the same depths (tests/test_torch_cuda_kernels.py)."""
    rng = np.random.default_rng(depth)
    table = jnp.asarray(rng.normal(size=(512, 64)), jnp.bfloat16)
    idx = jnp.asarray(rng.integers(0, 512, 4 * 40), jnp.int32)
    out = ops.gather(*_port(table, idx), impl="runahead", block_rows=4,
                     depth=depth)
    want = jax_ops.gather(table, idx, impl="runahead", block_rows=4,
                          depth=depth)
    np.testing.assert_array_equal(_bits(out), _bits(want))


@pytest.mark.parametrize("depth", [0, 17])
def test_runahead_refuses_depths_the_kernel_does_not_take(depth):
    """On the CPU as on the card: depth in 1..16."""
    table, idx = torch.zeros(64, 16), torch.zeros(32, dtype=torch.int32)
    with pytest.raises(ValueError, match="depth"):
        ops.gather(table, idx, impl="runahead", depth=depth)


@pytest.mark.parametrize("block_rows", [8, 16])
def test_runahead_refuses_a_partial_block(block_rows):
    """The reference asserts n % block_rows == 0; the port raises."""
    table, idx = torch.zeros(64, 16), torch.zeros(30, dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of block_rows"):
        ops.gather(table, idx, impl="runahead", block_rows=block_rows)
    assert ops.gather(table, idx, impl="pipelined").shape == (30, 16)


@pytest.mark.parametrize("row_bytes,block_rows,depth,want", [
    (12_288, 1, 15, "bulk"),      # the allocator's plan at dbrx-132b's width
    (512, 8, 2, "bulk"),          # phase 7's stream at its default depth
    (512, 8, 8, "bulk"),          # six blocks an SM: 2,731 B an operation
    (512, 8, 15, "cp_async"),     # three blocks an SM: 1,365 B an operation
    (2_048, 8, 8, "bulk"),        # one block an SM: 1,820 B an operation
    (14_528, 1, 16, "cp_async"),  # a ring that fills shared memory exactly
    (14_512, 1, 16, "bulk"),      # 16 bytes a row less: room for barriers
])
def test_runahead_route_of_each_shape(row_bytes, block_rows, depth, want):
    """The route rule, by shape alone: the bulk route wherever its ring
    and one 8-byte barrier a stage fit a block's 232,448 bytes and its
    TMA operations move at least 1,536 bytes each over the blocks an SM
    holds (scripts/torch_gather_variants.py: on the card the cp_async
    route was the faster at 512-byte rows, 8 a tile, depths 15 and 16, and
    the slower at every other shape where both ran)."""
    assert kernel.route(row_bytes, block_rows, depth) == want


@pytest.mark.parametrize("name", sorted(kernel.ARGTYPES))
def test_ctypes_signature_matches_the_source(name):
    """The wrapper's argtypes follow each C entry point, parameter for
    parameter (ctypes would cut a pointer passed as an int, or shift every
    argument after a missing one)."""
    src = _build.SOURCES["gather_runahead"].read_text()
    params = re.search(rf"int {name}\((.*?)\)", src, re.S).group(1)
    want = [ctypes.c_void_p if "*" in p else ctypes.c_int
            for p in params.split(",")]
    assert kernel.ARGTYPES[name] == want


def test_runahead_refuses_an_unknown_route():
    table, idx = torch.zeros(64, 16), torch.zeros(32, dtype=torch.int32)
    with pytest.raises(ValueError, match="use"):
        kernel.runahead_gather(table, idx, use="tma")


def test_gather_refuses_an_unknown_impl():
    with pytest.raises(ValueError, match="impl"):
        ops.gather(torch.zeros(8, 4), torch.zeros(8, dtype=torch.int32),
                   impl="dma")


def _bag_inputs(seed, fanin, dtype):
    rng = np.random.default_rng(seed)
    s, v, d = 16, 128, 128
    table = jnp.asarray(rng.normal(size=(v, d)), dtype)
    idx = jnp.asarray(rng.integers(0, v, (s, fanin)), jnp.int32)
    w = jnp.asarray(rng.normal(size=(s, fanin)), jnp.float32)
    return table, idx, w


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("fanin", [2, 4, 8])
def test_gather_bag_matches_jax_f32(seed, fanin):
    table, idx, w = _bag_inputs(seed, fanin, jnp.float32)
    out = ops.gather_bag(*_port(table, idx, w))
    assert out.dtype == torch.float32 and out.shape == (16, 128)
    for want in (jax_ops.gather_bag(table, idx, w),
                 jax_ref.gather_bag_ref(table, idx, w)):
        np.testing.assert_allclose(out.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("fanin", [2, 4, 8])
def test_gather_bag_matches_the_pallas_kernel_bf16(seed, fanin):
    table, idx, w = _bag_inputs(seed, fanin, jnp.bfloat16)
    out = ops.gather_bag(*_port(table, idx, w))
    assert out.dtype == torch.bfloat16 and out.shape == (16, 128)
    want = jax_ops.gather_bag(table, idx, w)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=2**-7, atol=1e-5)


def test_gather_bag_ref_sums_in_f32():
    """The plain version takes rows and weights to float32 before the sum
    (bfloat16 table, bfloat16 weights), as the Pallas kernel does."""
    table = torch.tensor([[1.0], [2.0**-9]]).to(torch.bfloat16)
    idx = torch.tensor([[0, 1, 1, 1]], dtype=torch.int32)
    w = torch.ones(1, 4, dtype=torch.bfloat16)
    # summed in bfloat16, 1 + 2**-9 rounds back to 1 at every term; in
    # float32 the three small terms add to 1.5 * 2**-8, and the one final
    # rounding to bfloat16 gives 1 + 2**-7
    assert ref.gather_bag_ref(table, idx, w).item() == 1.0 + 2.0**-7


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("fanin", [2, 4, 8])
def test_gather_bag_ordered_ref_matches_the_pallas_kernel(seed, fanin, dtype):
    table, idx, w = _bag_inputs(seed, fanin, getattr(jnp, dtype))
    out = ref.gather_bag_ordered_ref(*_port(table, idx, w))
    assert out.dtype == getattr(torch, dtype) and out.shape == (16, 128)
    rtol = 1e-5 if dtype == "float32" else 2**-7
    for want in (np.asarray(jax_ops.gather_bag(table, idx, w), np.float32),
                 ref.gather_bag_ref(*_port(table, idx, w)).float().numpy()):
        np.testing.assert_allclose(out.float().numpy(), want, rtol=rtol,
                                   atol=1e-5)


def test_gather_bag_ordered_ref_keeps_zero_times_inf():
    """A pad row of inf under weight 0 gives NaN in every version: the
    kernel may fetch that row once per batch, but every entry multiplies."""
    rng = np.random.default_rng(4)
    table = np.asarray(rng.normal(size=(8, 128)), np.float32)
    table[0, :64] = np.inf
    idx = np.asarray(rng.integers(1, 8, (16, 6)), np.int32)
    idx[::2, 3:] = 0                                   # pads on even rows
    w = np.asarray(rng.normal(size=(16, 6)), np.float32)
    w[idx == 0] = 0.0
    out = ref.gather_bag_ordered_ref(*_port(table, idx, w)).numpy()
    for want in (jax_ops.gather_bag(jnp.asarray(table), jnp.asarray(idx),
                                    jnp.asarray(w)),
                 ref.gather_bag_ref(*_port(table, idx, w))):
        want = np.asarray(want)
        np.testing.assert_array_equal(np.isnan(out), np.isnan(want))
    assert np.isnan(out[::2, :64]).all() and not np.isnan(out[1::2]).any()
