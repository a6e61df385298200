"""The port's max pool against the JAX package's.

The plain PyTorch version (``max_pool_nhwc_reference``, what the CUDA
kernel is held against on the card) must be bit-equal to the Pallas
kernel ``pallas_max_pool_nhwc`` run in interpret mode, and the port's
``Pool2D`` must match the JAX ``Pool2D`` forward.  The CUDA kernel
itself is held against the plain version in ``test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.op import OpContext as JaxOpContext
from flexflow_tpu.ops.conv import Pool2D as JaxPool2D
from flexflow_tpu.ops.pallas_pool import pallas_max_pool_nhwc
from flexflow_tpu.tensor import Tensor as JaxTensor
from flexflow_tpu_torch.op import OpContext
from flexflow_tpu_torch.ops import cuda_pool
from flexflow_tpu_torch.ops.conv import Pool2D
from flexflow_tpu_torch.tensor import Tensor
from tests.test_pallas_pool import CASES as PALLAS_CASES

ALEXNET = [((2, 56, 56, 64), (3, 3), (2, 2), (0, 0)),
           ((2, 27, 27, 192), (3, 3), (2, 2), (0, 0)),
           ((2, 13, 13, 256), (3, 3), (2, 2), (0, 0))]


def _nhwc_input(shape, seed, kind="normal"):
    rng = np.random.default_rng(seed)
    if kind == "ties":
        return rng.integers(-2, 3, shape).astype(np.float32)
    x = rng.standard_normal(shape).astype(np.float32)
    if kind == "nan":
        x[rng.random(shape) < 0.02] = np.nan
        x[rng.random(shape) < 0.02] = -np.inf
    return x


def _port_pool(x_nhwc, kernel, stride, padding, dtype=torch.float32):
    # NHWC memory under the logical NCHW shape: torch.channels_last
    xt = torch.from_numpy(x_nhwc).to(dtype).permute(0, 3, 1, 2)
    assert xt.is_contiguous(memory_format=torch.channels_last)
    y = cuda_pool.max_pool_nhwc(xt, kernel, stride, padding)
    return y.permute(0, 2, 3, 1).to(torch.float32).numpy()


@pytest.mark.parametrize(
    "shape,kernel,stride,padding,kind,dtype",
    [c + ("normal", "float32") for c in PALLAS_CASES]
    + [c + ("normal", "float32") for c in ALEXNET]
    + [ALEXNET[1] + ("normal", "bfloat16"),
       ((2, 13, 13, 8), (3, 3), (2, 2), (1, 1), "ties", "bfloat16"),
       ((2, 13, 13, 8), (3, 3), (2, 2), (1, 1), "nan", "float32"),
       ((1, 9, 9, 16), (2, 2), (2, 2), (0, 0), "nan", "bfloat16")])
def test_plain_version_bit_equal_to_pallas(shape, kernel, stride, padding,
                                          kind, dtype):
    x = _nhwc_input(shape, seed=sum(shape), kind=kind)
    y_jax = pallas_max_pool_nhwc(jnp.asarray(x, getattr(jnp, dtype)),
                                 kernel, stride, padding)
    y = _port_pool(x, kernel, stride, padding, getattr(torch, dtype))
    np.testing.assert_array_equal(y, np.asarray(y_jax, np.float32))


@pytest.mark.parametrize("pool_type", ["max", "avg"])
@pytest.mark.parametrize("layout", ["nchw", "nhwc"])
@pytest.mark.parametrize("geom", [(3, 3, 2, 2, 0, 0), (3, 3, 2, 2, 1, 1),
                                  (2, 3, 1, 2, 1, 0)])
def test_pool2d_matches_jax_op(pool_type, layout, geom):
    shape = (2, 6, 11, 12)
    x = np.random.default_rng(7).standard_normal(shape).astype(np.float32)
    jop = JaxPool2D("p", JaxTensor(shape, "float32", name="x"), *geom,
                    pool_type=pool_type)
    (want,) = jop.forward({}, [jnp.asarray(x)],
                          JaxOpContext(compute_dtype="float32"))
    op = Pool2D("p", Tensor(shape, "float32", name="x"), *geom,
                pool_type=pool_type)
    (got,) = op.forward({}, [torch.from_numpy(x)],
                        OpContext(compute_dtype="float32",
                                  conv_layout=layout))
    assert tuple(got.shape) == tuple(op.outputs[0].shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_integer_max_pool_takes_plain_version():
    """Non-float pools route to the plain version by dtype, before the
    kernel wrapper is reached (the kernel takes floats only)."""
    shape = (2, 3, 9, 9)
    x = np.random.default_rng(3).integers(-50, 50, shape).astype(np.int32)
    jop = JaxPool2D("p", JaxTensor(shape, "int32", name="x"), 3, 3, 2, 2,
                    1, 1)
    (want,) = jop.forward({}, [jnp.asarray(x)],
                          JaxOpContext(compute_dtype="float32"))
    op = Pool2D("p", Tensor(shape, "int32", name="x"), 3, 3, 2, 2, 1, 1)
    before = cuda_pool.max_pool_nhwc.launches
    (got,) = op.forward({}, [torch.from_numpy(x)],
                        OpContext(compute_dtype="float32"))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert cuda_pool.max_pool_nhwc.launches == before


def test_cpu_tensor_launches_nothing():
    x = torch.from_numpy(_nhwc_input((2, 9, 9, 8), 1)).permute(0, 3, 1, 2)
    before = cuda_pool.max_pool_nhwc.launches
    cuda_pool.max_pool_nhwc(x, (3, 3), (2, 2), (0, 0))
    assert cuda_pool.max_pool_nhwc.launches == before == 0


def test_non_cpu_tensor_never_takes_the_plain_version():
    """Only a CPU tensor may take the plain version: any other device
    launches the kernel or raises."""
    x = torch.empty((2, 8, 9, 9), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_pool.max_pool_nhwc(x, (3, 3), (2, 2), (0, 0))


def test_plain_version_accepts_padding_above_half_the_window():
    """JAX accepts padding > kernel/2 (F.max_pool2d does not): the
    padded positions hold finfo.min, so an all-padding window gives
    finfo.min, as the Pallas kernel pads."""
    x = torch.zeros((1, 1, 2, 2))
    y = cuda_pool.max_pool_nhwc_reference(x, (2, 2), (2, 2), (2, 2))
    assert tuple(y.shape) == (1, 1, 3, 3)
    assert float(y[0, 0, 0, 0]) == torch.finfo(torch.float32).min
    assert float(y[0, 0, 1, 1]) == 0.0


# the kernels' host-side choices: plain functions, testable without a card

@pytest.mark.parametrize("c,itemsize,ptrs,want", [
    (64, 2, (0, 4096), 8),      # AlexNet bf16: 16 bytes
    (64, 4, (0,), 4),           # f32: 16 bytes
    (36, 2, (0,), 4),           # C not a multiple of 8
    (130, 2, (0,), 2),
    (130, 4, (0,), 2),
    (4, 2, (0,), 4),
    (7, 2, (0,), 1),
    (64, 2, (2,), 1),           # storage offset 1 in bf16
    (64, 4, (4,), 1),           # storage offset 1 in f32
    (64, 2, (8,), 4),           # 8-byte aligned: 4 bf16
    (64, 2, (0, 4), 2),         # the least aligned pointer decides
])
def test_vector_width(c, itemsize, ptrs, want):
    assert cuda_pool.vector_width(c, itemsize, *ptrs) == want


def test_vector_width_of_a_view_at_storage_offset_one():
    n, c, h, w = 2, 64, 5, 5
    buf = torch.zeros(n * c * h * w + 1, dtype=torch.bfloat16)
    x = buf.as_strided((n, c, h, w), (h * w * c, 1, w * c, c), 1)
    assert x.is_contiguous(memory_format=torch.channels_last)
    assert cuda_pool.vector_width(c, x.element_size(), x.data_ptr()) == 1
    y = torch.zeros((n, c, h, w), dtype=torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    assert cuda_pool.vector_width(c, y.element_size(), y.data_ptr()) == 8


def _covering_windows(h0, h1, oh, kernel, stride, padding):
    """Window rows that cover input rows [h0, h1), by brute force."""
    (kh, _), (sh, _), (ph, _) = kernel, stride, padding
    return [o for o in range(oh)
            if any(o * sh - ph <= r < o * sh - ph + kh
                   for r in range(h0, h1))]


@pytest.mark.parametrize("h,kernel,stride,padding", [
    (56, (3, 3), (2, 2), (0, 0)), (27, (3, 3), (2, 2), (0, 0)),
    (13, (3, 3), (2, 2), (1, 1)), (9, (3, 3), (1, 1), (2, 2)),
    (10, (3, 3), (3, 3), (0, 0)), (10, (2, 2), (3, 3), (0, 0)),
    (30, (12, 12), (4, 4), (2, 2)), (7, (3, 2), (1, 2), (0, 1))])
@pytest.mark.parametrize("band", [1, 2, 3, 4, 8, 16])
def test_backward_tile_bounds_the_windows_of_every_band(h, kernel, stride,
                                                       padding, band):
    """The shared-memory carve-up assumes at most (band + kh - 2) // sh
    + 1 windows cover a band (of rows or of columns), and that the
    staged x positions are the windows' positions: check both against
    brute force, band by band."""
    (kh, _), (sh, _), (ph, _) = kernel, stride, padding
    oh, _ = cuda_pool.out_hw(h, h, kernel, stride, padding)
    most = cuda_pool._tile_windows(band, kh, sh, oh)
    assert most == min(oh, (band + kh - 2) // sh + 1)
    x_rows = g_rows = 0
    for h0 in range(0, h, band):
        wins = _covering_windows(h0, min(h0 + band, h), oh, kernel, stride,
                                 padding)
        assert len(wins) <= most
        assert wins == list(range(wins[0], wins[-1] + 1)) if wins else True
        x_rows += (len(wins) - 1) * sh + kh if wins else 0
        g_rows += len(wins)
    assert cuda_pool._staged(h, oh, band, kh, sh, ph) == (x_rows, g_rows)


@pytest.mark.parametrize("itemsize,vec", [(2, 8), (4, 4)])
@pytest.mark.parametrize("c,h", [(64, 56), (192, 27), (256, 13)])
def test_backward_plan_at_alexnet_pools(c, h, itemsize, vec):
    k, s, p = (3, 3), (2, 2), (0, 0)
    plan = cuda_pool.backward_plan(64, c, h, h, k, s, p, itemsize, vec)
    oh, ow = cuda_pool.out_hw(h, h, k, s, p)
    assert plan.vec == vec and plan.band_cols == h     # whole rows
    assert plan.smem_bytes <= cuda_pool.BWD_SMEM_BUDGET
    assert plan.smem_bytes == cuda_pool.backward_smem_bytes(
        plan.band_rows, plan.band_cols, plan.chan_vecs, vec, itemsize,
        (oh, ow), k, s)
    assert plan.band_rows % s[0] == 0
    assert plan.blocks >= cuda_pool.BWD_MIN_BLOCKS
    assert plan.chan_vecs <= cuda_pool.BWD_MAX_CHAN_VECS
    assert plan.chan_vecs * vec * itemsize >= cuda_pool.BWD_MIN_PIXEL_BYTES
    slices = -(-(c // vec) // plan.chan_vecs)
    assert plan.blocks == 64 * -(-h // plan.band_rows) * slices
    # no band of whole rows within the budget stages fewer rows
    x_rows, _ = cuda_pool._staged(h, oh, plan.band_rows, 3, 2, 0)
    for band in range(s[0], 17, s[0]):
        if cuda_pool.backward_smem_bytes(band, h, plan.chan_vecs, vec,
                                         itemsize, (oh, ow), k, s) <= \
                cuda_pool.BWD_SMEM_BUDGET:
            assert cuda_pool._staged(h, oh, band, 3, 2, 0)[0] >= \
                x_rows or 64 * -(-h // band) * slices < \
                cuda_pool.BWD_MIN_BLOCKS


@pytest.fixture
def smem_budget(monkeypatch):
    """Set BWD_SMEM_BUDGET for one test, with a fresh plan cache."""
    def set_budget(b):
        monkeypatch.setattr(cuda_pool, "BWD_SMEM_BUDGET", b)
        cuda_pool.backward_plan.cache_clear()
    yield set_budget
    cuda_pool.backward_plan.cache_clear()


def test_backward_plan_narrows_under_a_small_budget_and_raises_past_it(
        smem_budget):
    args = (64, 64, 56, 56, (3, 3), (2, 2), (0, 0), 2, 8)
    smem_budget(100 * 1024)
    wide = cuda_pool.backward_plan(*args)
    smem_budget(40_000)
    narrow = cuda_pool.backward_plan(*args)
    assert narrow.smem_bytes <= 40_000 < wide.smem_bytes
    assert narrow.band_rows * narrow.chan_vecs < (wide.band_rows
                                                  * wide.chan_vecs)
    # past the budget a large window takes what the card allows
    smem_budget(1_000)
    big = cuda_pool.backward_plan(1, 16, 30, 30, (12, 12), (4, 4), (2, 2),
                                  4, 4)
    assert 1_000 < big.smem_bytes <= cuda_pool.BWD_SMEM_MAX
    assert big.vec == 4
    # and a window no tile of the card can hold raises
    with pytest.raises(ValueError, match="no tile"):
        cuda_pool.backward_plan(1, 16, 400, 400, (181, 181), (1, 1), (0, 0),
                                4, 4)


@pytest.mark.parametrize("itemsize,vec", [(2, 8), (4, 4)])
def test_backward_plan_tiles_wide_rows_in_column_bands(itemsize, vec):
    """A 4096-wide row does not fit a tile: the plan splits it into
    bands of columns and keeps the full vector width."""
    w = 4096
    k, s, p = (3, 3), (2, 2), (0, 0)
    plan = cuda_pool.backward_plan(8, 64, 6, w, k, s, p, itemsize, vec)
    oh, ow = cuda_pool.out_hw(6, w, k, s, p)
    assert plan.vec == vec
    assert plan.band_cols < w and plan.band_cols % s[1] == 0
    assert plan.smem_bytes <= cuda_pool.BWD_SMEM_BUDGET
    assert plan.smem_bytes == cuda_pool.backward_smem_bytes(
        plan.band_rows, plan.band_cols, plan.chan_vecs, vec, itemsize,
        (oh, ow), k, s)
    assert plan.blocks == 8 * -(-6 // plan.band_rows) * -(
        -w // plan.band_cols) * -(-(64 // vec) // plan.chan_vecs)
    # the whole row at the narrowest slice would not fit
    assert cuda_pool.backward_smem_bytes(
        plan.band_rows, w, 1, vec, itemsize, (oh, ow), k, s) > \
        cuda_pool.BWD_SMEM_BUDGET


def test_backward_plan_narrows_the_vector_for_a_window_too_large():
    """A 100x100 window at stride 1 fits no tile of 16-byte pixels: the
    plan takes a narrower instance of the kernel."""
    plan = cuda_pool.backward_plan(1, 16, 300, 300, (100, 100), (1, 1),
                                   (0, 0), 4, 4)
    assert plan.vec < 4 and 4 % plan.vec == 0
    assert plan.smem_bytes <= cuda_pool.BWD_SMEM_MAX
    assert cuda_pool.backward_smem_bytes(1, 1, 1, 4, 4, (201, 201),
                                         (100, 100), (1, 1)) > \
        cuda_pool.BWD_SMEM_MAX


@pytest.mark.parametrize("parts", [1, 2, 3, 7])
def test_split_lengths_cover_the_axis_in_near_equal_bands(parts):
    lengths = cuda_pool._split_lengths(56, 2)
    assert lengths[0] == 56 and lengths[-1] == 2
    assert all(b % 2 == 0 for b in lengths)
    # a split into `parts` bands is among them
    assert min(56, -(-(-(-56 // parts)) // 2) * 2) in lengths


def test_backward_plan_small_tensors_prefer_more_blocks():
    """A small tensor cannot reach BWD_MIN_BLOCKS: the plan takes the
    tile that makes the most blocks."""
    plan = cuda_pool.backward_plan(1, 8, 14, 14, (12, 12), (2, 2), (1, 1),
                                   2, 8)
    assert plan.band_rows == plan.band_cols == 2 and plan.chan_vecs == 1
    assert plan.blocks == 49


def test_geometry_takes_images_past_32_bit_indexing():
    """The kernels index a row in 32 bits and rows in 64: an image of
    2^31 elements is taken."""
    x = torch.empty((1, 2 ** 11, 2 ** 10, 2 ** 10), dtype=torch.bfloat16,
                    device="meta").contiguous(
                        memory_format=torch.channels_last)
    assert cuda_pool._geometry("max_pool_nhwc", x, (3, 3), (2, 2),
                               (0, 0)) == (1, (511, 511))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("first", [0.0, -0.0])
def test_plain_forward_keeps_the_sign_of_the_first_zero(dtype, first):
    """A window whose max is a zero held with both signs takes the first
    zero's bits, as the kernel's strict walk does; a NaN still wins."""
    x = torch.tensor([[first, -first, -1.0, -first],
                      [-first, first, float("nan"), 0.0]],
                     dtype=dtype).reshape(1, 1, 2, 4)
    y = cuda_pool.max_pool_nhwc_reference(x, (2, 2), (2, 2), (0, 0))
    assert float(y[0, 0, 0, 0]) == 0.0
    assert torch.signbit(y[0, 0, 0, 0]) == (str(first) == "-0.0")
    assert torch.isnan(y[0, 0, 0, 1])


# (N, C, H, W), kernel, stride, padding, itemsize, vec, route: the
# pools of ResNet-50 and InceptionV3 at batch 64, and windows past what
# a tile holds (no tile of one pixel fits 227 KB of shared memory, or
# more than 32767 window positions for the tile's int16 offsets)
ROUTES = [
    ((64, 64, 112, 112), (3, 3), (2, 2), (1, 1), 2, 8, "tile"),
    ((64, 64, 147, 147), (3, 3), (2, 2), (0, 0), 2, 8, "tile"),
    ((64, 288, 36, 36), (3, 3), (2, 2), (0, 0), 4, 4, "tile"),
    ((1, 8, 160, 160), (128, 128), (1, 1), (0, 0), 4, 4, "tile"),
    ((1, 8, 256, 256), (128, 128), (1, 1), (0, 0), 4, 4, "window"),
    ((1, 8, 256, 256), (128, 128), (1, 1), (0, 0), 2, 8, "tile"),
    ((1, 8, 352, 352), (172, 172), (1, 1), (0, 0), 2, 8, "window"),
    ((1, 8, 192, 192), (184, 184), (1, 1), (0, 0), 2, 8, "window"),
    ((2, 8, 192, 192), (184, 184), (1, 1), (0, 0), 4, 4, "window"),
    ((1, 3, 300, 300), (200, 180), (1, 1), (0, 0), 4, 1, "window"),
]


@pytest.mark.parametrize("shape,kernel,stride,padding,itemsize,vec,route",
                         ROUTES)
def test_backward_route_picks_the_path_by_shape(shape, kernel, stride,
                                                padding, itemsize, vec,
                                                route):
    """The tiled kernel where a tile fits and the offsets fit int16,
    else the window path."""
    n, c, h, w = shape
    plan = cuda_pool.backward_route(n, c, h, w, kernel, stride, padding,
                                    itemsize, vec)
    if route == "tile":
        assert plan == cuda_pool.backward_plan(n, c, h, w, kernel, stride,
                                               padding, itemsize, vec)
        return
    assert plan == cuda_pool.WindowPlan(vec)
    if kernel[0] * kernel[1] <= cuda_pool.BWD_TILE_MAX_WINDOW:
        with pytest.raises(ValueError, match="no tile"):
            cuda_pool.backward_plan(n, c, h, w, kernel, stride, padding,
                                    itemsize, vec)
