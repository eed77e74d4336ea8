"""The schedule of the W4A8 kernel (ops/int4.py, csrc/w4a8.cu) on the CPU:
its plain twin (the int32 sums of each split of K, merged in split order,
then scaled) against the JAX Pallas kernel in interpret mode and the JAX
XLA path, exactly; the split ranges; the split rule at the 14B model's
shapes; the token tiling; and the GEMM-alone path's rows."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitdance_tpu.ops import int4 as ji4
from bitdance_tpu_torch.ops import int4 as ti4
from bitdance_tpu_torch.ops.int8 import quantize_rows

torch.set_num_threads(2)
# (M, N, K): N a multiple of 128 for the Pallas kernel (_pick_n_tile), N 64
# against the XLA path; K/2 % 128 == 64 (K 384) gives a half last stage
PALLAS_CASES = [(1, 128, 256), (5, 256, 384), (128, 1024, 1024), (132, 256, 2048),
                (300, 128, 512)]
XLA_CASES = [(1, 64, 256), (5, 64, 2048), (132, 64, 384), (300, 64, 1024)]
SPLITS = ["one", "two", "three", "max"]
_JAX: dict = {}


def _inputs(m, n, k, seed=0):
    """Packed weight bytes over the whole int8 range (nibbles -8..7), int8
    rows, positive scales."""
    rng = np.random.default_rng(seed + m + n + k)
    packed = rng.integers(-128, 128, (n, k // 2), dtype=np.int8)
    xq = rng.integers(-127, 128, (m, k), dtype=np.int8)
    sx = rng.uniform(1e-3, 2e-2, m).astype(np.float32)
    sw = rng.uniform(1e-3, 2e-2, n).astype(np.float32)
    x = rng.standard_normal((m, k)).astype(np.float32)
    return packed, xq, sx, sw, x


def _n_splits(name, k):
    stages = ti4.w4a8_stages(k)
    return {"one": 1, "two": min(2, stages), "three": min(3, stages), "max": stages}[name]


def _twin(xq, sx, packed, sw, n_splits):
    return ti4.w4a8_split_plain(torch.from_numpy(xq), torch.from_numpy(sx),
                                torch.from_numpy(packed), torch.from_numpy(sw),
                                n_splits).numpy()


def _pallas(case):
    key = ("pallas", case)
    if key not in _JAX:
        packed, xq, sx, sw, _ = _inputs(*case)
        _JAX[key] = np.asarray(ji4._w4a8_matmul_tpu(
            jnp.asarray(xq), jnp.asarray(sx)[:, None], jnp.asarray(packed.T.copy()),
            jnp.asarray(sw)[None, :], interpret=True))
    return _JAX[key]


def _xla(case):
    """JAX int4_matmul(force_xla=True) on x, and the port's quantized rows
    of the same x."""
    key = ("xla", case)
    if key not in _JAX:
        packed, _, _, sw, x = _inputs(*case)
        w = ji4.Q4Tensor(q=jnp.asarray(packed.T.copy()), s=jnp.asarray(sw)[None, :])
        _JAX[key] = np.asarray(ji4.int4_matmul(jnp.asarray(x), w, force_xla=True))
    return _JAX[key]


@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("case", PALLAS_CASES, ids=lambda c: "x".join(map(str, c)))
def test_split_twin_equals_pallas_kernel(case, splits):
    packed, xq, sx, sw, _ = _inputs(*case)
    got = _twin(xq, sx, packed, sw, _n_splits(splits, case[2]))
    np.testing.assert_array_equal(got, _pallas(case))


@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("case", XLA_CASES + PALLAS_CASES[2:3],
                         ids=lambda c: "x".join(map(str, c)))
def test_split_twin_equals_xla_path(case, splits):
    """The twin on the port's row quantization of x equals the JAX XLA path
    (its own row quantization of the same x) bit for bit."""
    packed, _, _, sw, x = _inputs(*case)
    xq, sx = quantize_rows(torch.from_numpy(x))
    got = _twin(xq.numpy(), sx.numpy(), packed, sw, _n_splits(splits, case[2]))
    np.testing.assert_array_equal(got, _xla(case))


@pytest.mark.parametrize("n_splits", [1, 2, 3, 5])
def test_split_partials_sum_to_the_whole_product(n_splits):
    """Each split's int32 sums are exact and together give the unsplit
    integer product (float64 reference, exact at this size)."""
    packed, xq, _, _, _ = _inputs(7, 64, 1280)
    parts = ti4.w4a8_split_partials(torch.from_numpy(xq), torch.from_numpy(packed), n_splits)
    assert parts.dtype == torch.int32 and parts.shape == (n_splits, 7, 64)
    lo, hi = ti4.unpack_int4(torch.from_numpy(packed))
    whole = (torch.from_numpy(xq[:, :640]).double() @ lo.double().t()
             + torch.from_numpy(xq[:, 640:]).double() @ hi.double().t())
    assert torch.equal(parts.long().sum(0), whole.long())


@pytest.mark.parametrize("k", [128, 256, 384, 5120, 17408])
def test_split_ranges_cover_k_once(k):
    stages = ti4.w4a8_stages(k)
    assert stages == -(-k // 256)
    for n in range(1, stages + 1):
        ranges = ti4.w4a8_split_ranges(k, n)
        assert len(ranges) == n and ranges[0][0] == 0 and ranges[-1][1] == k // 2
        for (a, b), (c, _) in zip(ranges, ranges[1:]):
            assert a < b == c                       # contiguous, each split non-empty
        assert all(a % 128 == 0 and b <= k // 2 for a, b in ranges)
        sizes = [-(-(b - a) // 128) for a, b in ranges]     # stages per split
        assert max(sizes) - min(sizes) <= 1
    for bad in (0, stages + 1):
        with pytest.raises(ValueError):
            ti4.w4a8_split_ranges(k, bad)


# the 14B model's projections at the AR step's 128 rows on 132 SMs:
# (N, K) -> (tail_from, n_splits)
SPLIT_RULE = {"q_proj / o_proj": ((5120, 5120), (0, 3)),
              "k_proj / v_proj": ((1024, 5120), (0, 10)),
              "gate_proj / up_proj": ((17408, 5120), (132, 10)),
              "down_proj": ((5120, 17408), (0, 3))}


@pytest.mark.parametrize("name", list(SPLIT_RULE))
def test_split_rule_at_the_14b_shapes(name):
    (n, k), want = SPLIT_RULE[name]
    assert ti4.w4a8_splits(128, n, k) == want
    assert ti4.w4a8_splits(132, n, k) == want


def test_split_rule_edges():
    # as many tiles as SMs: all whole; several token chunks: all whole
    assert ti4.w4a8_splits(128, 132 * 128, 5120) == (132, 1)
    assert ti4.w4a8_splits(300, 1024, 5120) == (8, 1)
    # a split walks at least MIN_SPLIT_STAGES stages; one stage: no split
    assert ti4.w4a8_splits(128, 64, 17408) == (0, 68 // ti4.MIN_SPLIT_STAGES)
    assert ti4.w4a8_splits(5, 64, 256) == (0, 1)
    # fewer SMs: the tail is what is left over a multiple of them
    assert ti4.w4a8_splits(128, 17408, 5120, sm_count=100) == (100, 2)


@pytest.mark.parametrize("m,want", [(1, (1, 1, 16)), (5, (1, 5, 16)), (128, (1, 128, 128)),
                                    (132, (1, 132, 144)), (145, (2, 73, 128)),
                                    (300, (3, 100, 128))])
def test_token_tiles(m, want):
    chunks, rows, nt = ti4.w4a8_token_tiles(m)
    assert (chunks, rows, nt) == want and chunks * rows >= m and nt in ti4.TOKEN_WIDTHS


def test_gemm_alone_rows_give_the_same_product():
    """int4_matmul on the rows of w4a8_quantize equals the call that
    quantizes itself (the CPU twin of the card's GEMM-alone launch)."""
    packed, _, _, sw, x = _inputs(6, 128, 512)
    w = ti4.Q4Tensor(q=torch.from_numpy(packed), s=torch.from_numpy(sw))
    xt = torch.from_numpy(x)
    rows = ti4.w4a8_quantize(xt)
    assert torch.equal(ti4.int4_matmul(xt, w, rows=rows), ti4.int4_matmul(xt, w))
