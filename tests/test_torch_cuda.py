"""The port's CUDA kernels on the card, against their plain versions
(the max-pool forward and backward kernels and the autograd function
that pairs them, the flash-attention forward and backward kernels, and
the fused LayerNorm kernel); and the zoo's ops on the card against the
CPU: the Embedding's id rules, the sparse embedding update against the
dense one, and the LSTM; host-placed embedding tables, a host-placed
Linear and a bf16-pinned attention under a strategy; KV page migration
(one device-to-host copy an export) and the disaggregated pair's tokens
against the CPU's; the pipeline block's residual LayerNorms on the
kernel.  The bf16/f16 flash kernels load by TMA, so
the flash cases include head dims that are not a multiple of 8 and
unaligned storage, which the wrapper pads and copies.

Every test here needs a CUDA device: it carries the ``cuda`` marker and
skips elsewhere.  The file imports neither jax nor the JAX package, so
it runs on a machine that has only PyTorch and the CUDA toolkit:

    python -m pytest tests/test_torch_cuda.py -q --noconftest
"""

import pytest
import torch

from flexflow_tpu_torch.ops import cuda_attention, cuda_norm, cuda_pool

pytestmark = pytest.mark.cuda

# (N, C, H, W), kernel, stride, padding: AlexNet's pools and edge cases
# (C not a multiple of the 16-byte vector: 130, 4, 36; a 12x12 window,
# whose 144 positions need the backward's int16 argmax); ties of -0.0
# and +0.0 and 4096-wide rows have their own tests below
CASES = [
    ((4, 64, 56, 56), (3, 3), (2, 2), (0, 0)),
    ((4, 192, 27, 27), (3, 3), (2, 2), (0, 0)),
    ((4, 256, 13, 13), (3, 3), (2, 2), (0, 0)),
    ((2, 8, 13, 13), (3, 3), (2, 2), (1, 1)),
    ((1, 130, 9, 9), (3, 3), (1, 1), (1, 1)),
    ((1, 4, 7, 7), (3, 2), (1, 2), (0, 1)),
    ((1, 8, 10, 10), (3, 3), (3, 3), (0, 0)),
    ((2, 8, 9, 9), (3, 3), (1, 1), (2, 2)),
    ((2, 36, 11, 11), (3, 3), (2, 2), (1, 1)),
    ((2, 16, 30, 30), (12, 12), (4, 4), (2, 2)),
]


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


def _input(shape, dtype, gen, nan=False, unaligned=False):
    x = torch.randn(shape, generator=gen, device="cuda")
    if nan:
        x = x.masked_fill(torch.rand(shape, generator=gen, device="cuda")
                          < 0.02, float("nan"))
    x = x.to(dtype).contiguous(memory_format=torch.channels_last)
    if unaligned:
        # the same values in a channels-last view at storage offset 1,
        # which no vector wider than one element can load
        n, c, h, w = shape
        buf = torch.empty(x.numel() + 1, dtype=dtype, device="cuda")
        view = buf.as_strided(shape, (h * w * c, 1, w * c, c), 1)
        view.copy_(x)
        assert view.is_contiguous(memory_format=torch.channels_last)
        assert view.data_ptr() % 16 != 0
        x = view
    return x


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("shape,kernel,stride,padding", CASES)
def test_kernel_bit_equal_to_plain_version(gen, dtype, shape, kernel,
                                           stride, padding):
    for nan in (False, True):
        x = _input(shape, dtype, gen, nan)
        before = cuda_pool.max_pool_nhwc.launches
        y = cuda_pool.max_pool_nhwc(x, kernel, stride, padding)
        torch.cuda.synchronize()
        assert cuda_pool.max_pool_nhwc.launches == before + 1
        ref = cuda_pool.max_pool_nhwc_reference(x, kernel, stride, padding)
        assert y.is_contiguous(memory_format=torch.channels_last)
        assert torch.equal(torch.isnan(y), torch.isnan(ref))
        assert torch.equal(torch.nan_to_num(y), torch.nan_to_num(ref))


def test_kernel_refuses_what_it_does_not_take(gen):
    x = _input((2, 8, 9, 9), torch.float32, gen)
    with pytest.raises(ValueError, match="channels_last"):
        cuda_pool.max_pool_nhwc(x.contiguous(), (3, 3), (2, 2), (0, 0))
    with pytest.raises(TypeError, match="float32, bfloat16"):
        cuda_pool.max_pool_nhwc(x.double(), (3, 3), (2, 2), (0, 0))
    with pytest.raises(TypeError, match="float32, bfloat16"):
        cuda_pool.max_pool_nhwc(x.to(torch.int32), (3, 3), (2, 2), (0, 0))
    with pytest.raises(ValueError, match="does not fit"):
        cuda_pool.max_pool_nhwc(x, (11, 11), (1, 1), (0, 0))


def _gradient(shape, kernel, stride, padding, dtype, gen):
    n, c, h, w = shape
    oh, ow = cuda_pool.out_hw(h, w, kernel, stride, padding)
    return _input((n, c, oh, ow), dtype, gen)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("shape,kernel,stride,padding", CASES)
def test_backward_kernel_bit_equal_to_plain_version(gen, dtype, shape,
                                                    kernel, stride,
                                                    padding):
    for nan in (False, True):
        x = _input(shape, dtype, gen, nan)
        g = _gradient(shape, kernel, stride, padding, dtype, gen)
        before = cuda_pool.max_pool_nhwc_backward.launches
        dx = cuda_pool.max_pool_nhwc_backward(x, g, kernel, stride, padding)
        torch.cuda.synchronize()
        assert cuda_pool.max_pool_nhwc_backward.launches == before + 1
        ref = cuda_pool.max_pool_nhwc_backward_reference(x, g, kernel,
                                                         stride, padding)
        assert dx.dtype == x.dtype and dx.shape == x.shape
        assert dx.is_contiguous(memory_format=torch.channels_last)
        assert torch.equal(torch.isnan(dx), torch.isnan(ref))
        assert torch.equal(torch.nan_to_num(dx), torch.nan_to_num(ref))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("shape,kernel,stride,padding",
                         [((2, 64, 13, 13), (3, 3), (2, 2), (0, 0)),
                          ((2, 36, 11, 11), (3, 3), (2, 2), (1, 1))])
def test_kernels_on_unaligned_storage(gen, dtype, shape, kernel, stride,
                                      padding):
    """A view at storage offset 1 takes the one-element instance of both
    kernels: still bit-equal, still one launch each."""
    for nan in (False, True):
        x = _input(shape, dtype, gen, nan, unaligned=True)
        g = _gradient(shape, kernel, stride, padding, dtype, gen)
        before = (cuda_pool.max_pool_nhwc.launches,
                  cuda_pool.max_pool_nhwc_backward.launches)
        y = cuda_pool.max_pool_nhwc(x, kernel, stride, padding)
        dx = cuda_pool.max_pool_nhwc_backward(x, g, kernel, stride, padding)
        torch.cuda.synchronize()
        assert (cuda_pool.max_pool_nhwc.launches,
                cuda_pool.max_pool_nhwc_backward.launches) == (
                    before[0] + 1, before[1] + 1)
        for got, want in (
                (y, cuda_pool.max_pool_nhwc_reference(x, kernel, stride,
                                                      padding)),
                (dx, cuda_pool.max_pool_nhwc_backward_reference(
                    x, g, kernel, stride, padding))):
            assert torch.equal(torch.isnan(got), torch.isnan(want))
            assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))


def _bits(t):
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int16)


def _assert_bit_equal(got, want):
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    zero = torch.zeros_like(_bits(want))
    assert torch.equal(torch.where(nan, zero, _bits(got)),
                       torch.where(nan, zero, _bits(want)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_kernels_keep_the_bits_of_signed_zero_ties(gen, dtype):
    """Windows whose max is a zero held with both signs: the forward
    keeps the first zero's bits, as the plain version does, and the
    backward routes each window's gradient to its first zero."""
    shape, k, s, p = (4, 64, 27, 27), (3, 3), (2, 2), (1, 1)
    x = torch.randint(-2, 3, shape, generator=gen, device="cuda").float()
    half = torch.rand(shape, generator=gen, device="cuda") < 0.5
    x = torch.where((x == 0) & half, -0.0, x).to(dtype).contiguous(
        memory_format=torch.channels_last)
    assert ((x == 0) & torch.signbit(x)).any()
    y = cuda_pool.max_pool_nhwc(x, k, s, p)
    ref = cuda_pool.max_pool_nhwc_reference(x, k, s, p)
    assert ((ref == 0) & torch.signbit(ref)).any()
    _assert_bit_equal(y, ref)
    g = _gradient(shape, k, s, p, dtype, gen)
    _assert_bit_equal(cuda_pool.max_pool_nhwc_backward(x, g, k, s, p),
                      cuda_pool.max_pool_nhwc_backward_reference(x, g, k, s,
                                                                 p))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_on_4096_wide_rows(gen, dtype):
    """A 4096-wide row does not fit one backward tile: the backward runs
    in bands of columns, still one launch, bit-equal."""
    shape, k, s, p = (2, 64, 6, 4096), (3, 3), (2, 2), (0, 0)
    for nan in (False, True):
        x = _input(shape, dtype, gen, nan)
        g = _gradient(shape, k, s, p, dtype, gen)
        before = cuda_pool.max_pool_nhwc_backward.launches
        y = cuda_pool.max_pool_nhwc(x, k, s, p)
        dx = cuda_pool.max_pool_nhwc_backward(x, g, k, s, p)
        torch.cuda.synchronize()
        assert cuda_pool.max_pool_nhwc_backward.launches == before + 1
        assert cuda_pool.max_pool_nhwc_backward.last_plan.band_cols < 4096
        _assert_bit_equal(y, cuda_pool.max_pool_nhwc_reference(x, k, s, p))
        _assert_bit_equal(dx, cuda_pool.max_pool_nhwc_backward_reference(
            x, g, k, s, p))


def test_backward_kernel_refuses_a_tile_size_it_did_not_compute(gen):
    """The wrapper passes the tile's shared memory, computed by
    backward_smem_bytes; the launch holds it against the kernel's own
    formula and refuses another size."""
    shape, k, s, p = (2, 64, 13, 13), (3, 3), (2, 2), (0, 0)
    x = _input(shape, torch.bfloat16, gen)
    g = _gradient(shape, k, s, p, torch.bfloat16, gen)
    dx = cuda_pool.max_pool_nhwc_backward(x, g, k, s, p)
    plan = cuda_pool.max_pool_nhwc_backward.last_plan
    args = [x.data_ptr(), g.data_ptr(), dx.data_ptr(), 1, plan.vec,
            plan.band_rows, plan.band_cols, plan.chan_vecs, plan.smem_bytes,
            2, 13, 13, 64, 6, 6, 3, 3, 2, 2, 0, 0, 0,
            torch.cuda.current_stream().cuda_stream]
    lib = cuda_pool._library()
    assert lib.ff_max_pool_nhwc_bwd(*args) == 0
    args[8] += 16
    assert lib.ff_max_pool_nhwc_bwd(*args) != 0
    torch.cuda.synchronize()


def test_backward_kernel_takes_an_nchw_gradient(gen):
    """The gradient that flows back through Flat's reshape is
    NCHW-contiguous: the wrapper converts it and still launches."""
    shape, k, s, p = (2, 16, 13, 13), (3, 3), (2, 2), (0, 0)
    x = _input(shape, torch.bfloat16, gen)
    g = _gradient(shape, k, s, p, torch.bfloat16, gen)
    before = cuda_pool.max_pool_nhwc_backward.launches
    a = cuda_pool.max_pool_nhwc_backward(x, g.contiguous(), k, s, p)
    b = cuda_pool.max_pool_nhwc_backward(x, g, k, s, p)
    assert cuda_pool.max_pool_nhwc_backward.launches == before + 2
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="does not match"):
        cuda_pool.max_pool_nhwc_backward(x, g.float(), k, s, p)


def test_autograd_on_cuda_equals_the_cpu_plain_path(gen):
    shape, k, s, p = (2, 8, 11, 11), (3, 3), (2, 2), (1, 1)
    x = _input(shape, torch.float32, gen)
    g = _gradient(shape, k, s, p, torch.float32, gen)
    xs = {}
    for dev in ("cuda", "cpu"):
        xd = x.to(dev).detach().requires_grad_(True)
        y = cuda_pool.max_pool_nhwc_autograd(xd, k, s, p)
        (y * g.to(dev)).sum().backward()
        xs[dev] = (y.detach().cpu(), xd.grad.cpu())
    before = (cuda_pool.max_pool_nhwc.launches,
              cuda_pool.max_pool_nhwc_backward.launches)
    xd = x.detach().requires_grad_(True)
    cuda_pool.max_pool_nhwc_autograd(xd, k, s, p).sum().backward()
    assert (cuda_pool.max_pool_nhwc.launches,
            cuda_pool.max_pool_nhwc_backward.launches) == (before[0] + 1,
                                                           before[1] + 1)
    assert torch.equal(xs["cuda"][0], xs["cpu"][0])
    assert torch.equal(xs["cuda"][1], xs["cpu"][1])


# flash attention: f32 within 2e-5 (outputs) and 1e-4 (gradients) of the
# plain version with TF32 off, bf16/f16 within 2e-2 of the largest
# reference value; the kernel sums in another order, so it is not
# bit-equal
FLASH_CASES = [  # n, sq, sk, h, d
    (16, 512, 512, 12, 64),   # BERT-base at batch 16
    (2, 512, 512, 3, 64),
    (2, 200, 200, 3, 64),
    (1, 512, 512, 2, 128),
    (2, 77, 130, 2, 16),
    (1, 130, 77, 2, 100),
    (2, 130, 77, 2, 128),     # two swizzled 64-column halves, ragged
    (1, 96, 96, 2, 20),       # padded to 24 for TMA
]


def _flash_tol(dtype, ref, f32_tol):
    if dtype == torch.float32:
        return f32_tol
    return 2e-2 * float(ref.abs().max())


@pytest.fixture
def no_tf32():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.Generator(device="cuda").manual_seed(0)
    torch.backends.cuda.matmul.allow_tf32 = old


def _qkv(shape, dtype, gen):
    n, sq, sk, h, d = shape
    return tuple(torch.randn(dims, generator=gen, device="cuda").to(dtype)
                 for dims in ((n, sq, h, d), (n, sk, h, d), (n, sk, h, d)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", FLASH_CASES)
def test_flash_forward_matches_plain_version(no_tf32, shape, causal, dtype):
    q, k, v = _qkv(shape, dtype, no_tf32)
    scale = shape[-1] ** -0.5
    before = cuda_attention.flash_attention_forward.launches
    o, lse = cuda_attention.flash_attention_forward(q, k, v, causal, scale)
    torch.cuda.synchronize()
    assert cuda_attention.flash_attention_forward.launches == before + 1
    assert o.dtype == dtype and o.shape == q.shape
    ref = cuda_attention.flash_attention_reference(q, k, v, causal, scale)
    tol = _flash_tol(dtype, ref, 2e-5)
    assert float((o.float() - ref).abs().max()) <= tol
    ref_lse = cuda_attention.flash_attention_lse_reference(q, k, causal,
                                                           scale)
    assert float((lse - ref_lse).abs().max()) <= 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", FLASH_CASES)
def test_flash_backward_matches_plain_version(no_tf32, shape, causal,
                                              dtype):
    q, k, v = _qkv(shape, dtype, no_tf32)
    scale = shape[-1] ** -0.5
    o, lse = cuda_attention.flash_attention_forward(q, k, v, causal, scale)
    do = torch.randn(o.shape, generator=no_tf32, device="cuda").to(dtype)
    before = cuda_attention.flash_attention_backward.launches
    got = cuda_attention.flash_attention_backward(q, k, v, o, lse, do,
                                                  causal, scale)
    torch.cuda.synchronize()
    assert cuda_attention.flash_attention_backward.launches == before + 1
    want = cuda_attention.flash_attention_backward_reference(
        q, k, v, o, lse, do, causal, scale)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dtype and g.shape == w.shape, name
        err = float((g.float() - w.float()).abs().max())
        assert err <= _flash_tol(dtype, w.float(), 1e-4), (name, err)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_takes_unaligned_and_strided_storage(no_tf32, dtype):
    """Inputs that start 2 bytes into their storage are copied to aligned
    buffers for TMA; the results equal those of aligned copies."""
    n, s, h, d = 2, 96, 2, 64
    buf = torch.randn(3 * n * s * h * d + 1, generator=no_tf32,
                      device="cuda").to(dtype)
    q, k, v = (buf[1 + i * n * s * h * d:1 + (i + 1) * n * s * h * d]
               .view(n, s, h, d) for i in range(3))
    assert q.data_ptr() % 16 != 0
    o, lse = cuda_attention.flash_attention_forward(q, k, v, True, 0.125)
    o2, lse2 = cuda_attention.flash_attention_forward(
        q.clone(), k.clone(), v.clone(), True, 0.125)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    do = torch.randn(o.shape, generator=no_tf32, device="cuda").to(dtype)
    got = cuda_attention.flash_attention_backward(q, k, v, o, lse, do, True,
                                                  0.125)
    want = cuda_attention.flash_attention_backward(
        q.clone(), k.clone(), v.clone(), o, lse, do, True, 0.125)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_flash_backward_repeats_bit_equal(no_tf32, dtype, causal):
    """No atomics: two backward calls on the same inputs give the same
    bits (so do two forward calls)."""
    q, k, v = _qkv((4, 512, 512, 12, 64), dtype, no_tf32)
    o, lse = cuda_attention.flash_attention_forward(q, k, v, causal, 0.125)
    o2, lse2 = cuda_attention.flash_attention_forward(q, k, v, causal, 0.125)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    do = torch.randn(o.shape, generator=no_tf32, device="cuda").to(dtype)
    a = cuda_attention.flash_attention_backward(q, k, v, o, lse, do, causal,
                                                0.125)
    b = cuda_attention.flash_attention_backward(q, k, v, o, lse, do, causal,
                                                0.125)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("d", [100, 20])
def test_flash_pads_an_unaligned_odd_head_dim(no_tf32, d):
    """Unaligned storage and a head dim that TMA cannot stride: one
    launch per call, the results within tolerance of the plain version."""
    n, s, h = 2, 77, 3
    buf = torch.randn(3 * n * s * h * d + 1, generator=no_tf32,
                      device="cuda").to(torch.bfloat16)
    q, k, v = (buf[1 + i * n * s * h * d:1 + (i + 1) * n * s * h * d]
               .view(n, s, h, d) for i in range(3))
    before = (cuda_attention.flash_attention_forward.launches,
              cuda_attention.flash_attention_backward.launches)
    o, lse = cuda_attention.flash_attention_forward(q, k, v, True, 0.1)
    do = torch.randn(o.shape, generator=no_tf32, device="cuda").to(o.dtype)
    got = cuda_attention.flash_attention_backward(q, k, v, o, lse, do, True,
                                                  0.1)
    torch.cuda.synchronize()
    assert (cuda_attention.flash_attention_forward.launches,
            cuda_attention.flash_attention_backward.launches) == (
                before[0] + 1, before[1] + 1)
    assert o.shape == q.shape and o.is_contiguous()
    ref = cuda_attention.flash_attention_reference(q, k, v, True, 0.1)
    assert float((o.float() - ref).abs().max()) <= _flash_tol(
        torch.bfloat16, ref, 0)
    want = cuda_attention.flash_attention_backward_reference(
        q, k, v, o, lse, do, True, 0.1)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert float((g.float() - w.float()).abs().max()) <= _flash_tol(
            torch.bfloat16, w.float(), 0)


def test_flash_autograd_equals_autograd_of_the_dense_math(no_tf32):
    q, k, v = _qkv((2, 96, 96, 2, 32), torch.float32, no_tf32)
    g = torch.randn(q.shape, generator=no_tf32, device="cuda")
    grads = []
    for fn in (cuda_attention.flash_attention,
               cuda_attention.flash_attention_reference):
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        (fn(*leaves, True, 32 ** -0.5) * g).sum().backward()
        grads.append([t.grad for t in leaves])
    for a, b in zip(*grads):
        assert float((a - b).abs().max()) <= 1e-4


def test_flash_refuses_what_it_does_not_take(no_tf32):
    q, k, v = _qkv((1, 8, 8, 1, 160), torch.float32, no_tf32)
    with pytest.raises(TypeError, match="head dim"):
        cuda_attention.flash_attention_forward(q, k, v, False, 1.0)
    q, k, v = _qkv((1, 8, 8, 1, 16), torch.float32, no_tf32)
    with pytest.raises(TypeError, match="one dtype"):
        cuda_attention.flash_attention_forward(q, k.double(), v, False, 1.0)


# LayerNorm, in units in the last place of the output's largest value
# (at least 1; cuda_norm.ulp_distance): the kernel within 4 of the float64
# function and within 4 of the plain version, whose float32 statistics
# reduce in another order
LN_MAX_ULPS_EXACT = 4
LN_MAX_ULPS_PLAIN = 4


# the earlier shapes, then rows of 1 to 14336 at 1, 16 and 256 rows
LN_SHAPES = [(8192, 768), (3, 100, 77), (5, 1000)] + [
    (rows, d) for d in (1, 768, 1024, 4096, 14336) for rows in (1, 16, 256)]


def _layernorm_case(gen, shape, with_res, dtype, x=None):
    if x is None:
        x = (3 * torch.randn(shape, generator=gen, device="cuda")
             + 1).to(dtype)
    res = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
           if with_res else None)
    d = shape[-1]
    scale = torch.randn(d, generator=gen, device="cuda")
    bias = torch.randn(d, generator=gen, device="cuda")
    return x, res, scale, bias


def _check_layernorm(x, res, scale, bias, out_dtype):
    """One launch; the float32 output within the ulp limits of the plain
    version and of float64, and the narrow output equal to it cast."""
    before = cuda_norm.fused_layernorm.launches
    y = cuda_norm.fused_layernorm(x, res, scale, bias, 1e-5, out_dtype)
    torch.cuda.synchronize()
    assert cuda_norm.fused_layernorm.launches == before + 1
    assert y.dtype == out_dtype and y.shape == x.shape
    y32 = (y if out_dtype == torch.float32 else
           cuda_norm.fused_layernorm(x, res, scale, bias, 1e-5))
    if out_dtype != torch.float32:
        assert torch.equal(y.view(torch.int16),
                           y32.to(out_dtype).view(torch.int16))
    ref = cuda_norm.fused_layernorm_reference(x, res, scale, bias, 1e-5)
    exact = cuda_norm.layernorm_float64(x, res, scale, bias, 1e-5)
    assert cuda_norm.ulp_distance(y32, exact) <= LN_MAX_ULPS_EXACT
    assert cuda_norm.ulp_distance(y32, ref) <= LN_MAX_ULPS_PLAIN


@pytest.mark.parametrize("out", ["float32", "input"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("with_res", [False, True])
@pytest.mark.parametrize("shape", LN_SHAPES)
def test_layernorm_matches_plain_version(gen, shape, with_res, dtype, out):
    out_dtype = torch.float32 if out == "float32" else dtype
    _check_layernorm(*_layernorm_case(gen, shape, with_res, dtype),
                     out_dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_res", [False, True])
def test_layernorm_offset_view_takes_the_element_path(gen, with_res, dtype):
    # a contiguous view one element into its storage: no 16-byte vector
    # lines up, so the plan takes single elements
    rows, d = 16, 768
    buf = torch.randn(rows * d + 1, generator=gen, device="cuda").to(dtype)
    x = buf[1:].view(rows, d)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    assert cuda_norm.launch_plan(rows, d, x.element_size(), 4,
                                 False).vec == 1
    _check_layernorm(*_layernorm_case(gen, (rows, d), with_res, dtype, x),
                     dtype)


def test_layernorm_autograd_matches_plain_autograd(gen):
    x = torch.randn((4, 33, 64), generator=gen, device="cuda")
    scale = torch.randn(64, generator=gen, device="cuda")
    bias = torch.randn(64, generator=gen, device="cuda")
    g = torch.randn(x.shape, generator=gen, device="cuda")
    grads = []
    for fn in (cuda_norm.fused_layernorm_autograd,
               cuda_norm.fused_layernorm_reference):
        leaves = [t.detach().requires_grad_(True) for t in (x, scale, bias)]
        (fn(leaves[0], None, leaves[1], leaves[2], 1e-5) * g).sum().backward()
        grads.append([t.grad for t in leaves])
    for a, b in zip(*grads):
        assert torch.allclose(a, b, rtol=1e-5, atol=1e-5)


# The pools of ResNet-50 and InceptionV3 ((C, H, W), kernel, stride,
# padding; the card tests run them at batch 8, the smoke at 64):
# ResNet's padded stem pool and Inception's four stride-2 pools
MODEL_POOLS = [
    ((64, 112, 112), (3, 3), (2, 2), (1, 1)),
    ((64, 147, 147), (3, 3), (2, 2), (0, 0)),
    ((192, 73, 73), (3, 3), (2, 2), (0, 0)),
    ((288, 36, 36), (3, 3), (2, 2), (0, 0)),
    ((768, 17, 17), (3, 3), (2, 2), (0, 0)),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("chw,kernel,stride,padding", MODEL_POOLS)
def test_kernels_bit_equal_at_the_resnet_and_inception_pools(
        gen, dtype, chw, kernel, stride, padding):
    shape = (8,) + chw
    for nan in (False, True):
        x = _input(shape, dtype, gen, nan)
        g = _gradient(shape, kernel, stride, padding, dtype, gen)
        before = (cuda_pool.max_pool_nhwc.launches,
                  cuda_pool.max_pool_nhwc_backward.tile_launches)
        y = cuda_pool.max_pool_nhwc(x, kernel, stride, padding)
        dx = cuda_pool.max_pool_nhwc_backward(x, g, kernel, stride, padding)
        torch.cuda.synchronize()
        assert (cuda_pool.max_pool_nhwc.launches,
                cuda_pool.max_pool_nhwc_backward.tile_launches) == (
                    before[0] + 1, before[1] + 1)
        _assert_bit_equal(y, cuda_pool.max_pool_nhwc_reference(
            x, kernel, stride, padding))
        _assert_bit_equal(dx, cuda_pool.max_pool_nhwc_backward_reference(
            x, g, kernel, stride, padding))


# Windows the backward's tile cannot take, (N, C, H, W), kernel, stride,
# padding, dtypes: no tile of one pixel fits the card's shared memory
# (f32 past about 120 x 120, bf16/f16 past about 170 x 170 at stride 1;
# padded and strided), or more than 32767 window positions
LARGE_WINDOWS = [
    ((1, 8, 256, 256), (128, 128), (1, 1), (0, 0), [torch.float32]),
    ((1, 8, 352, 352), (172, 172), (1, 1), (0, 0),
     [torch.bfloat16, torch.float16]),
    ((2, 8, 200, 200), (130, 130), (2, 2), (40, 40), [torch.float32]),
    ((1, 8, 192, 192), (184, 184), (1, 1), (0, 0),
     [torch.float32, torch.bfloat16, torch.float16]),
]


@pytest.mark.parametrize("shape,kernel,stride,padding,dtype", [
    (s, k, st, p, dt) for s, k, st, p, dts in LARGE_WINDOWS for dt in dts])
def test_large_window_backward_takes_the_window_path(
        gen, monkeypatch, shape, kernel, stride, padding, dtype):
    """Bit-equal to the plain version, through the window path's two
    launches, with no call to the plain version on the card; the
    forward at the same window is bit-equal too."""
    x = _input(shape, dtype, gen, nan=True)
    g = _gradient(shape, kernel, stride, padding, dtype, gen)
    plain = cuda_pool.max_pool_nhwc_backward_reference

    def refuse(*args):
        raise AssertionError("the plain backward ran on the card")

    monkeypatch.setattr(cuda_pool, "max_pool_nhwc_backward_reference",
                        refuse)
    before = (cuda_pool.max_pool_nhwc_backward.launches,
              cuda_pool.max_pool_nhwc_backward.window_launches,
              cuda_pool.max_pool_nhwc_backward.tile_launches)
    dx = cuda_pool.max_pool_nhwc_backward(x, g, kernel, stride, padding)
    y = cuda_pool.max_pool_nhwc(x, kernel, stride, padding)
    torch.cuda.synchronize()
    monkeypatch.undo()
    assert (cuda_pool.max_pool_nhwc_backward.launches,
            cuda_pool.max_pool_nhwc_backward.window_launches,
            cuda_pool.max_pool_nhwc_backward.tile_launches) == (
                before[0] + 1, before[1] + 1, before[2])
    assert isinstance(cuda_pool.max_pool_nhwc_backward.last_plan,
                      cuda_pool.WindowPlan)
    assert dx.is_contiguous(memory_format=torch.channels_last)
    _assert_bit_equal(dx, plain(x, g, kernel, stride, padding))
    _assert_bit_equal(y, cuda_pool.max_pool_nhwc_reference(x, kernel, stride,
                                                           padding))


def test_concat_of_channels_last_branches_stays_channels_last(gen):
    """An Inception module's branches (a conv output and a max-pool
    output, both channels-last) concatenate on the channel axis into a
    channels-last tensor on the card."""
    from flexflow_tpu_torch.op import OpContext
    from flexflow_tpu_torch.ops.tensor_ops import Concat
    from flexflow_tpu_torch.tensor import Tensor

    a = _input((4, 96, 17, 17), torch.bfloat16, gen)
    b = cuda_pool.max_pool_nhwc(_input((4, 288, 35, 35), torch.bfloat16, gen),
                                (3, 3), (2, 2), (0, 0))
    op = Concat("concat", [Tensor(tuple(a.shape)), Tensor(tuple(b.shape))],
                1)
    (y,) = op.forward({}, [a, b], OpContext(device=torch.device("cuda"),
                                            conv_layout="nhwc"))
    assert y.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(y, torch.cat([a.contiguous(), b.contiguous()], 1))


def _bad_ids():
    # wrapped (-1, -rows), NaN rows (-rows-1, rows, rows+7) beside
    # in-range ids
    return torch.tensor([[0, -1, 3], [-7, 6, 2], [-8, 1, 1], [7, 4, 5],
                         [14, 0, -2]], dtype=torch.int32)


@pytest.mark.parametrize("aggr", ["none", "sum", "avg"])
def test_embedding_reads_ids_on_the_card_as_on_the_cpu(no_tf32, aggr):
    """Ids out of range raise no device-side assert: the card reads NaN
    rows where the CPU does (and JAX, tests/test_torch_zoo_ops.py), and
    the table's gradient matches."""
    from flexflow_tpu_torch.op import OpContext
    from flexflow_tpu_torch.ops.linear import Embedding
    from flexflow_tpu_torch.tensor import Tensor

    ids = _bad_ids()
    op = Embedding("emb", Tensor(tuple(ids.shape), "int32"), 7, 4, aggr)
    table = torch.randn(7, 4, generator=torch.Generator().manual_seed(0))
    cot = torch.randn(op.outputs[0].shape,
                      generator=torch.Generator().manual_seed(1))
    got = {}
    for dev in ("cuda", "cpu"):
        t = table.to(dev).requires_grad_(True)
        (y,) = op.forward({op.w_table.name: t}, [ids.to(dev)],
                          OpContext(device=torch.device(dev),
                                    compute_dtype="float32"))
        (dt,) = torch.autograd.grad(y, t, cot.to(dev))
        got[dev] = (y.detach().cpu(), dt.cpu())
    torch.cuda.synchronize()
    (y_c, dt_c), (y_h, dt_h) = got["cuda"], got["cpu"]
    assert torch.isnan(y_h).any()
    assert torch.equal(torch.isnan(y_c), torch.isnan(y_h))
    torch.testing.assert_close(y_c, y_h, rtol=0, atol=1e-6, equal_nan=True)
    torch.testing.assert_close(dt_c, dt_h, rtol=0, atol=1e-6)


def _sparse_model(device, sparse):
    import flexflow_tpu_torch as ft

    cfg = ft.FFConfig(batch_size=64, compute_dtype="float32", seed=0,
                      sparse_embedding_updates=sparse)
    m = ft.FFModel(cfg, device=device)
    ids0 = m.create_tensor((64, 3), dtype="int32", name="ids0")
    ids1 = m.create_tensor((64, 1), dtype="int32", name="ids1")
    t = m.concat([m.embedding(ids0, 5000, 16, name="emb0"),
                  m.embedding(ids1, 300, 16, name="emb1")], axis=1)
    t = m.dense(m.dense(t, 32, activation="relu"), 1)
    p = m.mse_loss(t)
    m.compile(ft.SGDOptimizer(lr=0.1), final_tensor=p)
    m.init_layers(seed=0)
    return m


def test_sparse_update_equals_dense_on_the_card(no_tf32):
    """Three plain-SGD steps on the sparse path against the dense path
    on the card, duplicate ids included: losses within 1e-6 relative,
    parameters within 1e-6 (index_add_ sums duplicates with atomics, in
    another order than the dense gradient), rows no id touched keep
    their bits."""
    g = torch.Generator().manual_seed(2)
    batches = [(torch.randint(0, 5000, (64, 3), generator=g,
                              dtype=torch.int32),
                torch.randint(0, 300, (64, 1), generator=g,
                              dtype=torch.int32),
                torch.rand(64, 1, generator=g)) for _ in range(3)]
    batches[0][0][:8] = 17                # duplicates in and across bags
    runs = {}
    for sparse in (None, False):
        m = _sparse_model("cuda", sparse)
        w0 = {k: v.clone() for k, v in m._params.items()}
        losses = [float(m.train_batch(*b)) for b in batches]
        runs[sparse] = (m, losses)
    (ms, ls), (md, ld) = runs[None], runs[False]
    assert len(ms._sparse_specs) == 2 and not md._sparse_specs
    torch.testing.assert_close(torch.tensor(ls), torch.tensor(ld),
                               rtol=1e-6, atol=0)
    for k in md._params:
        torch.testing.assert_close(ms._params[k], md._params[k], rtol=0,
                                   atol=1e-6, msg=k)
    touched = torch.unique(torch.cat([b[0].reshape(-1) for b in batches]))
    keep = torch.ones(5000, dtype=torch.bool)
    keep[touched.long()] = False
    assert torch.equal(_bits(ms._params["emb0/table"][keep.cuda()]),
                       _bits(w0["emb0/table"][keep.cuda()]))


@pytest.mark.parametrize("with_state", [False, True])
def test_lstm_on_the_card_equals_the_cpu(no_tf32, with_state):
    """A float32 LSTM forward and backward on the card against the CPU,
    within 1e-5: the cell is plain torch on both (no cuDNN RNN)."""
    from flexflow_tpu_torch.op import OpContext
    from flexflow_tpu_torch.ops.rnn import LSTM
    from flexflow_tpu_torch.tensor import Tensor

    n, s, d, h = 4, 9, 24, 32
    state = ((Tensor((n, h)), Tensor((n, h))) if with_state else None)
    op = LSTM("lstm", Tensor((n, s, d)), h, initial_state=state)
    g = torch.Generator().manual_seed(3)
    params = {w.name: 0.3 * torch.randn(w.shape, generator=g)
              for w in op.weights}
    xs = [torch.randn(n, s, d, generator=g)]
    if with_state:
        xs += [0.5 * torch.randn(n, h, generator=g) for _ in range(2)]
    cots = [torch.randn(t.shape, generator=g) for t in op.outputs]
    got = {}
    for dev in ("cuda", "cpu"):
        p = {k: v.to(dev).requires_grad_(True) for k, v in params.items()}
        x = [v.to(dev).requires_grad_(True) for v in xs]
        outs = op.forward(p, x, OpContext(device=torch.device(dev),
                                          compute_dtype="float32"))
        grads = torch.autograd.grad(outs, list(p.values()) + x,
                                    [c.to(dev) for c in cots])
        got[dev] = [t.detach().cpu() for t in list(outs) + list(grads)]
    for a, b in zip(got["cuda"], got["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def _remat_counts():
    return (cuda_attention.flash_attention_forward.launches,
            cuda_attention.flash_attention_backward.launches,
            cuda_norm.fused_layernorm.launches,
            cuda_pool.max_pool_nhwc.launches,
            cuda_pool.max_pool_nhwc_backward.launches)


def _reckon(model, op_type) -> int:
    """Forward launches of ``op_type``'s kernel in one remat step: two in
    a checkpointed segment (the forward, then the recomputation), one in
    the last segment."""
    segs = model.remat_segments()
    return sum((1 if i == len(segs) - 1 else 2)
               * sum(op.op_type == op_type for op in seg)
               for i, seg in enumerate(segs))


def _step_from(model, start, batch, remat):
    """One train_batch from the state ``start`` (params, optimizer
    state, step) with remat on or off; the launches and the result."""
    model._params, model._opt_state, model._step = (dict(start[0]),
                                                    start[1], start[2])
    model.config.remat = remat
    before = _remat_counts()
    loss = model.train_batch(*batch)
    torch.cuda.synchronize()
    launched = [a - b for a, b in zip(_remat_counts(), before)]
    return float(loss), dict(model._params), launched


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_runs_the_flash_and_layernorm_kernels(no_tf32, dtype):
    """A transformer step under remat recomputes the flash forward and
    the LayerNorm kernel inside torch.utils.checkpoint: bit-equal to the
    plain step (the kernels are deterministic; the flash backward has no
    atomics), with the launches the segments reckon."""
    import flexflow_tpu_torch as ft

    cfg = ft.FFConfig(batch_size=2, compute_dtype=dtype)
    m, _, logits = ft.build_transformer(
        cfg, num_layers=3, d_model=64, num_heads=2, d_ff=128, seq_len=64,
        vocab_size=100, num_classes=2, device="cuda")
    m.compile(ft.AdamOptimizer(alpha=1e-3), final_tensor=logits)
    m.init_layers(seed=0)
    g = torch.Generator().manual_seed(1)
    batch = (torch.randint(0, 100, (2, 64), generator=g, dtype=torch.int32),
             torch.randint(0, 2, (2, 1), generator=g, dtype=torch.int32))
    start = (dict(m._params), m._opt_state, m._step)
    l0, p0, n0 = _step_from(m, start, batch, False)
    l1, p1, n1 = _step_from(m, start, batch, True)
    assert l0 == l1
    for k in p0:
        assert torch.equal(p0[k], p1[k]), k
    assert n0[:3] == [3, 3, 6]
    assert n1[:3] == [_reckon(m, ft.OpType.ATTENTION), 3,
                      _reckon(m, ft.OpType.LAYERNORM)]
    assert n1[0] > 3 and n1[2] > 6


def test_remat_runs_the_max_pool_kernels(no_tf32):
    """A CNN step under remat recomputes the max-pool forward kernel in
    its checkpointed segment and runs the backward kernel once, bit-equal
    to the plain step (deterministic cuDNN)."""
    import flexflow_tpu_torch as ft

    cfg = ft.FFConfig(batch_size=4, compute_dtype="bfloat16")
    m = ft.FFModel(cfg, device="cuda")
    x = m.create_tensor((4, 3, 32, 32), name="x")
    t = m.conv2d(x, 16, 3, 3, 1, 1, 1, 1, activation="relu")
    t = m.pool2d(t, 3, 3, 2, 2, 1, 1)
    for _ in range(6):
        t = m.conv2d(t, 16, 3, 3, 1, 1, 1, 1, activation="relu")
    t = m.batch_norm(t)
    t = m.flat(t)
    t = m.dense(t, 10)
    m.compile(ft.SGDOptimizer(lr=0.01, momentum=0.9), final_tensor=t)
    m.init_layers(seed=0)
    g = torch.Generator().manual_seed(2)
    batch = (torch.randn(4, 3, 32, 32, generator=g),
             torch.randint(0, 10, (4, 1), generator=g, dtype=torch.int32))
    start = (dict(m._params), m._opt_state, m._step)
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        l0, p0, n0 = _step_from(m, start, batch, False)
        l1, p1, n1 = _step_from(m, start, batch, True)
    finally:
        torch.backends.cudnn.deterministic = old
    assert l0 == l1
    for k in p0:
        assert torch.equal(p0[k], p1[k]), k
    assert n0[3:] == [1, 1]
    assert n1[3:] == [_reckon(m, ft.OpType.POOL2D), 1] == [2, 1]


def test_checkpoint_round_trip_on_the_card(no_tf32, tmp_path):
    """Save on the card, train on, load and train the same steps again:
    parameters, running statistics and momentum bit-equal; the file
    verifies, and a flipped byte raises CorruptCheckpointError."""
    import flexflow_tpu_torch as ft
    from flexflow_tpu_torch.resilience import (CorruptCheckpointError,
                                               verify_checkpoint)

    cfg = ft.FFConfig(batch_size=4, compute_dtype="float32")
    m = ft.FFModel(cfg, device="cuda")
    x = m.create_tensor((4, 3, 16, 16), name="x")
    t = m.conv2d(x, 8, 3, 3, 1, 1, 1, 1)
    t = m.batch_norm(t)
    t = m.pool2d(t, 2, 2, 2, 2, 0, 0)
    t = m.flat(t)
    t = m.dense(t, 5)
    m.compile(ft.SGDOptimizer(lr=0.05, momentum=0.9), final_tensor=t)
    m.init_layers(seed=0)
    g = torch.Generator().manual_seed(4)
    batches = [(torch.randn(4, 3, 16, 16, generator=g),
                torch.randint(0, 5, (4, 1), generator=g, dtype=torch.int32))
               for _ in range(5)]
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for b in batches[:3]:
            m.train_batch(*b)
        path = str(tmp_path / "card.npz")
        for async_write in (False, True):
            m.save_checkpoint(path, async_write=async_write)
            step0 = m._step
            for b in batches[3:]:
                m.train_batch(*b)
            want = (dict(m._params), m._opt_state["v"])
            m.load_checkpoint(path)
            assert m._step == step0
            for b in batches[3:]:
                m.train_batch(*b)
            for k, v in want[0].items():
                assert torch.equal(m._params[k], v), k
            for k, v in want[1].items():
                assert torch.equal(m._opt_state["v"][k], v), k
            m.load_checkpoint(path)
    finally:
        torch.backends.cudnn.deterministic = old
    assert verify_checkpoint(path)
    raw = bytearray(open(path, "rb").read())
    raw[len(raw) // 2] ^= 0x10
    bad = str(tmp_path / "flipped.npz")
    with open(bad, "wb") as f:
        f.write(raw)
    with pytest.raises(CorruptCheckpointError, match="flipped.npz"):
        m.load_checkpoint(bad)


def _hetero_model(device, momentum):
    """The small zoo-shaped model with both tables host-placed (the
    hetero strategy's device type CPU and ZCM memory)."""
    import flexflow_tpu_torch as ft

    cfg = ft.FFConfig(batch_size=64, compute_dtype="float32", seed=0)
    cfg.strategies = {name: ft.ParallelConfig(
        device_type=ft.DeviceType.HOST, dims=(1, 1), device_ids=(0,),
        memory_types=(ft.MemoryType.ZCM,) * 3) for name in ("emb0", "emb1")}
    m = ft.FFModel(cfg, device=device)
    ids0 = m.create_tensor((64, 3), dtype="int32", name="ids0")
    ids1 = m.create_tensor((64, 1), dtype="int32", name="ids1")
    t = m.concat([m.embedding(ids0, 5000, 16, name="emb0"),
                  m.embedding(ids1, 300, 16, name="emb1")], axis=1)
    t = m.dense(m.dense(t, 32, activation="relu"), 1)
    p = m.mse_loss(t)
    m.compile(ft.SGDOptimizer(lr=0.1, momentum=momentum), final_tensor=p)
    m.init_layers(seed=0)
    return m


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_host_table_stays_pinned_across_train_batch(no_tf32, momentum):
    """Host-placed tables are pinned host tensors after init and after
    every train_batch (the row update on the host under plain SGD, the
    dense update, which the tables visit the card for, under momentum),
    in the same buffers; three steps on the card
    equal the CPU's within 1e-5."""
    g = torch.Generator().manual_seed(4)
    batches = [(torch.randint(0, 5000, (64, 3), generator=g,
                              dtype=torch.int32),
                torch.randint(0, 300, (64, 1), generator=g,
                              dtype=torch.int32),
                torch.rand(64, 1, generator=g)) for _ in range(3)]
    card = _hetero_model("cuda", momentum)
    cpu = _hetero_model("cpu", momentum)
    assert bool(card._host_rows) == (momentum == 0.0)
    tables = {n: card._params[n] for n in card._host_params}
    assert sorted(tables) == ["emb0/table", "emb1/table"]
    for b in batches:
        for n, t in tables.items():
            assert card._params[n] is t and t.is_pinned(), n
            assert t.device.type == "cpu"
        lc, lh = float(card.train_batch(*b)), float(cpu.train_batch(*b))
        assert abs(lc - lh) <= 1e-5 * max(1.0, abs(lh)), (lc, lh)
    for n, t in tables.items():
        assert card._params[n] is t and t.is_pinned(), n
    for k in cpu._params:
        torch.testing.assert_close(card._params[k].cpu(), cpu._params[k],
                                   rtol=1e-5, atol=1e-5, msg=k)


def test_pinned_bf16_attention_launches_the_bf16_flash_kernel(no_tf32):
    """A strategy pinning the attention ops to bf16 in a float32 session:
    every flash launch, forward and backward, is a bf16 launch, one per
    attention a forward and one more per attention a step's backward."""
    import flexflow_tpu_torch as ft

    cfg = ft.FFConfig(batch_size=2, compute_dtype="float32", seed=0)
    cfg.strategies = {f"attention_{i}": ft.ParallelConfig(
        dims=(1, 1, 1), device_ids=(0,), precision="bf16")
        for i in range(2)}
    m, _, logits = ft.build_transformer(
        cfg, num_layers=2, d_model=128, num_heads=2, d_ff=256, seq_len=128,
        vocab_size=1000, num_classes=2, device="cuda")
    m.compile(ft.SGDOptimizer(lr=0.01), final_tensor=logits)
    m.init_layers(seed=0)
    report = m.verify_report
    assert "FF141" in report.codes() and not report.errors, \
        report.render_text()
    fwd, bwd = (cuda_attention.flash_attention_forward,
                cuda_attention.flash_attention_backward)
    g = torch.Generator().manual_seed(5)
    x = torch.randint(0, 1000, (2, 128), generator=g, dtype=torch.int32)
    y = torch.randint(0, 2, (2, 1), generator=g, dtype=torch.int32)
    for f in (fwd, bwd):
        f.launches_by_dtype = {}
    out = m.predict(x.numpy())
    assert fwd.launches_by_dtype == {"torch.bfloat16": 2}
    assert out.dtype.name == "float32"
    for f in (fwd, bwd):
        f.launches_by_dtype = {}
    m.train_batch(x, y)
    assert fwd.launches_by_dtype == {"torch.bfloat16": 2}
    assert bwd.launches_by_dtype == {"torch.bfloat16": 2}


def _gen_lm(device):
    """A small float32 causal LM for the generation tests."""
    import flexflow_tpu_torch as ft

    cfg = ft.FFConfig(batch_size=4, compute_dtype="float32", seed=0)
    m, _, logits = ft.build_transformer_lm(
        cfg, num_layers=2, d_model=64, num_heads=4, d_ff=128, seq_len=64,
        vocab_size=97, device=device)
    m.compile(final_tensor=logits)
    m.init_layers(seed=0)
    return m


def test_decode_step_drops_sentinel_writes_on_the_card(no_tf32):
    """Inactive slots ride the no-page sentinel in the table and the
    write page: no device assert and no host sync, the two real writes
    land, and every other pool row keeps its bits."""
    import numpy as np

    from flexflow_tpu_torch.serving.generation import GraphDecoder

    m = _gen_lm("cuda")
    dec = GraphDecoder(m, 4, 64, page_size=16, num_pages=12)
    caches = dec.init_cache()
    for sub in caches.values():
        for t in sub.values():
            t.copy_(torch.randn(t.shape, generator=no_tf32, device="cuda"))
    before = {(n, leaf): t.clone() for n, sub in caches.items()
              for leaf, t in sub.items()}
    table = np.full((4, 4), 12, np.int32)
    table[0, :2] = (3, 7)
    table[2, 0] = 5
    # the step enqueues with no host sync (the caller's fetch is the one)
    torch.cuda.set_sync_debug_mode("error")
    try:
        nxt = dec.decode_fn()(m._params, caches, [5, 6, 7, 8],
                              [20, 0, 9, 0], table, [7, 12, 5, 12],
                              [4, 0, 9, 0])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert nxt.shape == (4,) and bool(((nxt >= 0) & (nxt < 97)).all())
    written = {(7, 4), (5, 9)}
    for (name, leaf), old in before.items():
        new = caches[name][leaf]
        for page in range(12):
            for row in range(16):
                same = torch.equal(new[page, row], old[page, row])
                assert same != ((page, row) in written), (name, page, row)


def test_forward_kv_runs_the_causal_flash_kernel(no_tf32):
    """``forward_kv`` on the card is one causal flash launch: its output
    is bit-equal to the op's forward, and its output, K and V match the
    CPU's dense path."""
    from flexflow_tpu_torch.op import OpContext
    from flexflow_tpu_torch.ops.attention import MultiHeadAttention

    m = _gen_lm("cuda")
    op = next(o for o in m.layers if isinstance(o, MultiHeadAttention))
    x = torch.randn((2, 64, 64), generator=no_tf32, device="cuda")
    got = {}
    for dev in ("cuda", "cpu"):
        params = {k: v.to(dev) for k, v in m._params.items()}
        ctx = OpContext(device=torch.device(dev), training=False,
                        compute_dtype="float32")
        fwd = cuda_attention.flash_attention_forward
        fwd.launches = 0
        with torch.inference_mode():
            (out,), k, v = op.forward_kv(params, [x.to(dev)], ctx)
            plain = op.forward(params, [x.to(dev)], ctx)[0]
        got[dev] = (out, k, v)
        if dev == "cuda":
            assert fwd.launches == 2        # forward_kv's, forward's
            assert torch.equal(out, plain)
    for a, b in zip(got["cuda"], got["cpu"]):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-5)


def test_prefill_chunk_past_the_position_table_runs(no_tf32):
    """A 64-token bucket at offset 48 of a 64-row position table: its
    pad rows reach position 111, which must clamp, not assert; the
    token and the written pages match the CPU."""
    import numpy as np

    from flexflow_tpu_torch.serving.generation import GraphDecoder

    got = {}
    for dev in ("cuda", "cpu"):
        m = _gen_lm(dev)
        dec = GraphDecoder(m, 2, 64, page_size=16, num_pages=8)
        caches = dec.init_cache()
        tokens = np.zeros((1, 64), np.int32)
        tokens[0, :16] = np.arange(1, 17)
        row = np.array([2, 4, 6, 1], np.int32)
        tok = dec.prefill_fn(64)(m._params, caches, tokens, row, 0, 48, 16)
        got[dev] = (int(tok.cpu()),
                    {n: {k: v.cpu() for k, v in sub.items()}
                     for n, sub in caches.items()})
    assert got["cuda"][0] == got["cpu"][0]
    for name, sub in got["cpu"][1].items():
        for leaf, want in sub.items():
            torch.testing.assert_close(got["cuda"][1][name][leaf], want,
                                       rtol=1e-5, atol=1e-5)


def test_generation_engine_on_the_card_equals_the_cpu(no_tf32):
    """A small float32 LM through GenerationEngine (chunked prefill,
    prefix cache on) gives the same greedy tokens, and the same sampled
    tokens for the same seeds, on the card as on the CPU."""
    import numpy as np

    import flexflow_tpu_torch as ft

    rng = np.random.default_rng(0)
    prefix = rng.integers(1, 97, 20)
    prompts = [np.concatenate([prefix, rng.integers(1, 97, n)])
               for n in (3, 9, 1)] + [rng.integers(1, 97, 7)]
    sp = ft.SamplingParams(temperature=0.8, top_k=20, top_p=0.9, seed=3)
    cuda_model = _gen_lm("cuda")
    got = {}
    for dev in ("cuda", "cpu"):
        m = cuda_model if dev == "cuda" else _gen_lm("cpu")
        if dev == "cpu":
            for p in cuda_model.parameters:
                m.set_weights(p.name, cuda_model.get_weights(p.name))
        with ft.GenerationEngine(m, slots=2, prefill_chunk=8) as eng:
            greedy = [eng.submit(p, max_new_tokens=12) for p in prompts]
            sampled = [eng.submit(p, max_new_tokens=12, sampling=sp)
                       for p in prompts]
            got[dev] = [s.result(timeout=300).tolist()
                        for s in greedy + sampled]
            assert eng.stats()["prefix_hit_tokens"] > 0
    assert got["cuda"] == got["cpu"]


def test_lstm_lm_generation_on_the_card_equals_the_cpu(no_tf32):
    """The LSTM LM's decode (``LSTM.forward_states`` and ``decode``)
    through GenerationEngine gives the same greedy tokens on the card as
    on the CPU, in float32."""
    import numpy as np

    import flexflow_tpu_torch as ft

    models = {}
    for dev in ("cuda", "cpu"):
        cfg = ft.FFConfig(batch_size=4, compute_dtype="float32", seed=0)
        m = ft.build_lstm_lm(cfg, vocab_size=97, embed_dim=32,
                             hidden_dim=48, num_layers=2, seq_len=48,
                             device=dev)[0]
        m.compile()
        m.init_layers(seed=0)
        models[dev] = m
    for p in models["cuda"].parameters:
        models["cpu"].set_weights(p.name, models["cuda"].get_weights(p.name))
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, 97, n) for n in (3, 11, 6, 17)]
    got = {}
    for dev, m in models.items():
        with ft.GenerationEngine(m, slots=2, max_new_tokens=12) as eng:
            got[dev] = [s.result(timeout=300).tolist()
                        for s in [eng.submit(p) for p in prompts]]
    assert got["cuda"] == got["cpu"]
    assert all(len(t) == 12 for t in got["cpu"])


def _quant_mlp(device):
    import flexflow_tpu_torch as ft

    cfg = ft.FFConfig(batch_size=8, compute_dtype="float32", seed=0)
    m = ft.FFModel(cfg, device=device)
    t = m.create_tensor((8, 256), name="x")
    t = m.dense(t, 1024, activation="relu", name="d1")
    t = m.dense(t, 512, activation="relu", name="d2")
    m.dense(t, 10, name="d3")
    m.compile()
    m.init_layers(seed=0)
    return m


def test_quantized_linear_on_the_card_equals_the_cpu(no_tf32):
    """An int8-quantized MLP: the same q and scales on the card as on the
    CPU, and the forward within 1e-5 of the CPU's (the float32 products'
    summation order differs)."""
    import numpy as np

    card, host = _quant_mlp("cuda"), _quant_mlp("cpu")
    for p in card.parameters:
        host.set_weights(p.name, card.get_weights(p.name))
    rep = {d: m.quantize_weights("int8") for d, m in
           (("cuda", card), ("cpu", host))}
    assert rep["cuda"] == rep["cpu"]
    for name in ("d1/kernel", "d2/kernel", "d3/kernel"):
        assert card._params[name].dtype == torch.int8
        assert card._params[name].device.type == "cuda"
        assert torch.equal(card._params[name].cpu(), host._params[name])
        assert torch.equal(card._params[name + "::scale"].cpu(),
                           host._params[name + "::scale"])
    x = np.random.default_rng(0).standard_normal((8, 256)).astype(
        np.float32)
    np.testing.assert_allclose(card.predict(x), host.predict(x),
                               rtol=1e-5, atol=1e-5)


def test_quantize_weights_frees_the_float32_kernels_on_the_card(no_tf32):
    """memory_allocated falls by the report's bytes_before - bytes_after
    (within 1%): no float32 kernel outlives quantize_weights."""
    import gc

    m = _quant_mlp("cuda")
    m.predict(torch.zeros((8, 256)).numpy())
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    rep = m.quantize_weights("int8")
    gc.collect()
    torch.cuda.synchronize()
    drop = before - torch.cuda.memory_allocated()
    want = rep["bytes_before"] - rep["bytes_after"]
    assert abs(drop - want) <= 0.01 * want, (drop, want)


def _spec_models(device):
    """A small float32 LM, a draft of other widths and weights, and
    prompts, for the speculative tests on ``device``."""
    import numpy as np

    import flexflow_tpu_torch as ft

    target = _gen_lm(device)
    cfg = ft.FFConfig(batch_size=4, compute_dtype="float32", seed=1)
    draft = ft.build_transformer_lm(
        cfg, num_layers=1, d_model=32, num_heads=2, d_ff=64, seq_len=64,
        vocab_size=97, device=device)[0]
    draft.compile()
    draft.init_layers(seed=1)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, 97, n) for n in (3, 11, 6, 17)]
    return target, draft, prompts


def test_speculative_round_makes_no_host_sync(no_tf32):
    """The draft's gamma steps and the verify walk enqueue with no host
    sync; the caller's one fetch brings the accept counts and tokens."""
    import numpy as np

    from flexflow_tpu_torch.serving import GraphDecoder

    target, draft, _ = _spec_models("cuda")
    dec = GraphDecoder(target, 4, 64, page_size=16, num_pages=12)
    ddec = GraphDecoder(draft, 4, 64, page_size=16, num_pages=12)
    caches, dcaches = dec.init_cache(), ddec.init_cache()
    table = np.full((4, 4), 12, np.int32)
    table[0, :2] = (3, 7)
    table[2, 0] = 5
    g = 4
    pos = np.array([20, 0, 9, 0], np.int32)
    vwp = np.full((4, g), 12, np.int32)
    vwr = np.zeros((4, g), np.int32)
    for i in (0, 2):
        for t in range(g):
            p = pos[i] + t
            vwp[i, t] = table[i, p // 16]
            vwr[i, t] = p % 16
    dwp, dwr = np.ascontiguousarray(vwp.T), np.ascontiguousarray(vwr.T)
    first = np.array([5, 6, 7, 8], np.int32)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        d = ddec.draft_fn(g)(draft._params, dcaches, first, pos, table,
                             dwp, dwr)
        n_acc, out = dec.verify_fn(g)(target._params, caches, first, d,
                                      pos, table, vwp, vwr)
        sp = ([0.8, 0.0, 0.8, 0.0], [0, 0, 5, 0], [0.9, 1, 1, 1],
              [1, 0, 2, 0])
        arrays = tuple(np.asarray(a) for a in sp)
        ds, q = ddec.draft_fn(g, sampled=True)(
            draft._params, dcaches, first, pos, table, dwp, dwr, *arrays)
        ns, outs = dec.verify_fn(g, sampled=True)(
            target._params, caches, first, ds, q, pos, table, vwp, vwr,
            *arrays)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    host = torch.cat([n_acc[:, None], out, ns[:, None], outs], 1).cpu()
    assert host.shape == (4, 2 + 2 * g)
    assert bool(((host[:, 0] >= 0) & (host[:, 0] <= g)).all())
    assert bool(((host[:, 1:1 + g] >= 0) & (host[:, 1:1 + g] < 97)).all())


def test_speculative_generation_on_the_card_equals_the_cpu(no_tf32):
    """Greedy speculative tokens in float32 are the same on the card as
    on the CPU, and equal plain greedy decode on the card."""
    import flexflow_tpu_torch as ft

    got = {}
    for dev in ("cuda", "cpu"):
        target, draft, prompts = _spec_models(dev)
        if dev == "cpu":
            src = got["cuda_models"]
            for a, b in ((target, src[0]), (draft, src[1])):
                for p in b.parameters:
                    a.set_weights(p.name, b.get_weights(p.name))
        with ft.GenerationEngine(target, slots=2, max_new_tokens=12,
                                 draft_model=draft, spec_gamma=3) as eng:
            got[dev] = [s.result(timeout=300).tolist()
                        for s in [eng.submit(p) for p in prompts]]
        snap = eng.stats()
        assert snap["draft_dispatches"] > 0
        if dev == "cuda":
            got["cuda_models"] = (target, draft)
            with ft.GenerationEngine(target, slots=2,
                                     max_new_tokens=12) as eng:
                got["plain"] = [s.result(timeout=300).tolist()
                                for s in [eng.submit(p) for p in prompts]]
    assert got["cuda"] == got["cpu"] == got["plain"]


def test_disaggregated_tokens_on_the_card_equal_the_cpu(no_tf32):
    """A small float32 LM through the port's ``build_disagg`` on the card:
    every stream migrates, the tokens equal a co-located engine's on the
    card and the disaggregated pair's on the CPU, and both pools drain."""
    import time

    import numpy as np

    from flexflow_tpu_torch.fflogger import silenced
    from flexflow_tpu_torch.serving.cluster import build_disagg

    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, 97, n) for n in (5, 20, 33, 9)]
    cuda_model = _gen_lm("cuda")
    got = {}
    for dev in ("cuda", "cpu"):
        m = cuda_model if dev == "cuda" else _gen_lm("cpu")
        if dev == "cpu":
            for p in cuda_model.parameters:
                m.set_weights(p.name, cuda_model.get_weights(p.name))
        with silenced("serve"):
            router, fleets, (pf, dc) = build_disagg(m, 2, 64, 8)
        try:
            with silenced("serve"):
                got[dev] = [router.submit("lm", p, max_new_tokens=12)
                            .result(timeout=300).tolist() for p in prompts]
            assert router.stats()["migrations"] == len(prompts)
            deadline = time.monotonic() + 30
            while pf._pool.pages_in_use or dc._pool.pages_in_use:
                assert time.monotonic() < deadline
                time.sleep(0.01)
        finally:
            with silenced("serve"):
                router.stop()
                for f in fleets:
                    f.stop()
    import flexflow_tpu_torch as ft
    with silenced("serve"), ft.GenerationEngine(
            cuda_model, slots=2, max_seq=64, prefill_chunk=8,
            prefix_cache="off") as eng:
        colo = [eng.submit(p, max_new_tokens=12).result(timeout=300)
                .tolist() for p in prompts]
    assert got["cuda"] == got["cpu"] == colo


def test_export_pages_makes_one_device_to_host_copy(gen):
    """``export_pages`` gathers every leaf into one packed buffer and
    copies it to the host once; ``pages_to_device`` then ``import_pages``
    write the rows back bit for bit, and a payload of another geometry
    leaves the destination pool untouched."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from flexflow_tpu_torch.serving.generation.pages import (
        export_pages, import_pages, pages_to_device)

    class DeviceToHost(TorchDispatchMode):
        """The bytes of each op that reads a card's tensor and returns a
        host one, seen at the dispatcher (the profiler's device copies
        came and went between runs of one process on an H100)."""
        def __init__(self):
            super().__init__()
            self.copies = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            ins = [t for t in args if isinstance(t, torch.Tensor)]
            if isinstance(out, torch.Tensor) and out.device.type == "cpu" \
                    and any(t.is_cuda for t in ins):
                self.copies.append(out.numel() * out.element_size())
            return out

    def pool():
        return {f"attn{i}": {
            leaf: torch.randn((12, 16, 4, 8), generator=gen,
                              device="cuda").to(torch.bfloat16)
            for leaf in ("k", "v")} for i in range(3)}

    src, dst = pool(), pool()
    torch.cuda.synchronize()
    with DeviceToHost() as mode:
        host = export_pages(src, [7, 2, 9], 12)
    # 3 pages x 6 leaves x 16 x 4 x 8 bf16
    assert mode.copies == [3 * 6 * 16 * 4 * 8 * 2]
    assert all(t.device.type == "cpu" for sub in host.values()
               for t in sub.values())
    dev = pages_to_device(host, "cuda")
    before = {n: {k: v.clone() for k, v in sub.items()}
              for n, sub in dst.items()}
    bad = dict(dev, attn0={"k": dev["attn0"]["k"][:, :8],
                           "v": dev["attn0"]["v"]})
    with pytest.raises(ValueError):
        import_pages(dst, bad, [0, 1, 4])
    assert all(torch.equal(dst[n][k], before[n][k])
               for n in dst for k in dst[n])
    import_pages(dst, dev, [0, 1, 4])
    for n in src:
        for k in src[n]:
            assert torch.equal(dst[n][k][[0, 1, 4]], src[n][k][[7, 2, 9]])


def _pipeline_model(device, stages=2):
    """A small pipeline block model in float32 (tokens, an embedding, the
    block, its first position, a dense head)."""
    import flexflow_tpu_torch as ft

    cfg = ft.FFConfig(batch_size=4, compute_dtype="float32", seed=0)
    m = ft.FFModel(cfg, device=device)
    tok = m.create_tensor((4, 64), dtype="int32", name="tokens")
    t = m.embedding(tok, 100, 128, aggr="none")
    t = m.pipeline_transformer_block(t, num_stages=stages, num_heads=4,
                                     d_ff=256, num_microbatches=2)
    t = m.reshape(m.split(t, [1, 63], axis=1)[0], (4, 128))
    m.compile(ft.SGDOptimizer(lr=0.05), "sparse_categorical_crossentropy",
              [], final_tensor=m.dense(t, 4))
    m.init_layers(seed=0)
    return m


def test_pipeline_block_residual_layernorms_launch_the_kernel(no_tf32):
    """On the card the block's two ln(x + attn) sites of every stage
    launch the fused LayerNorm kernel with its residual operand (2 a
    stage a forward; the backward recomputes the plain version), never
    the plain version; predict and a step equal the CPU's within 1e-4."""
    from unittest import mock

    card, cpu = _pipeline_model("cuda"), _pipeline_model("cpu")
    g = torch.Generator().manual_seed(5)
    x = torch.randint(0, 100, (4, 64), generator=g, dtype=torch.int32)
    y = torch.randint(0, 4, (4, 1), generator=g, dtype=torch.int32)
    plain = mock.patch.object(cuda_norm, "fused_layernorm_reference",
                              wraps=cuda_norm.fused_layernorm_reference)
    cuda_norm.fused_layernorm.launches = 0
    with plain as ref:
        out = card.predict(x.numpy())
        assert cuda_norm.fused_layernorm.launches == 2 * 2
        assert ref.call_count == 0
    torch.testing.assert_close(torch.from_numpy(out),
                               torch.from_numpy(cpu.predict(x.numpy())),
                               rtol=1e-4, atol=1e-4)
    cuda_norm.fused_layernorm.launches = 0
    lc, lh = float(card.train_batch(x, y)), float(cpu.train_batch(x, y))
    assert cuda_norm.fused_layernorm.launches == 2 * 2
    assert abs(lc - lh) <= 1e-4 * max(1.0, abs(lh)), (lc, lh)
    for k in cpu._params:
        torch.testing.assert_close(card._params[k].cpu(), cpu._params[k],
                                   rtol=1e-4, atol=1e-4, msg=k)


def test_pipeline_residual_layernorm_kernel_equals_the_plain_version(gen):
    """The block's call of the kernel, at a stage's rows: float32 x and
    residual, float32 out, within the 4 ulp the smoke's check allows."""
    x = torch.randn(4, 64, 128, generator=gen, device="cuda")
    res = torch.randn(4, 64, 128, generator=gen, device="cuda")
    scale = torch.rand(128, generator=gen, device="cuda") + 0.5
    bias = torch.randn(128, generator=gen, device="cuda")
    y = cuda_norm.fused_layernorm_autograd(x, res, scale, bias, 1e-5,
                                           torch.float32)
    ref = cuda_norm.fused_layernorm_reference(x, res, scale, bias, 1e-5)
    assert cuda_norm.ulp_distance(y, ref) <= 4


def test_host_placed_linear_stays_pinned_on_the_card(no_tf32):
    """A host-placed Linear's kernel and bias are pinned host tensors
    after init and after every step, in the same buffers; they visit
    the card for the forward and the update (the optimizer's state
    lives there); three steps equal the CPU's within 1e-5."""
    import flexflow_tpu_torch as ft

    def model(device):
        cfg = ft.FFConfig(batch_size=16, compute_dtype="float32", seed=0)
        cfg.strategies = {"dense": ft.ParallelConfig(
            device_type=ft.DeviceType.HOST, dims=(1, 1), device_ids=(0,),
            memory_types=(ft.MemoryType.ZCM,) * 3)}
        m = ft.FFModel(cfg, device=device)
        x = m.create_tensor((16, 32), name="x")
        t = m.dense(m.dense(x, 64, activation="relu"), 8)
        m.compile(ft.SGDOptimizer(lr=0.05, momentum=0.9),
                  "sparse_categorical_crossentropy", [], final_tensor=t)
        m.init_layers(seed=0)
        return m

    card, cpu = model("cuda"), model("cpu")
    bufs = {k: card._params[k] for k in card._host_stream}
    assert sorted(bufs) == ["dense/bias", "dense/kernel"]
    g = torch.Generator().manual_seed(6)
    for _ in range(3):
        x = torch.randn(16, 32, generator=g)
        y = torch.randint(0, 8, (16, 1), generator=g, dtype=torch.int32)
        lc, lh = float(card.train_batch(x, y)), float(cpu.train_batch(x, y))
        assert abs(lc - lh) <= 1e-5 * max(1.0, abs(lh)), (lc, lh)
        for k, t in bufs.items():
            assert card._params[k] is t and t.is_pinned(), k
    assert all(v.is_cuda for v in card._opt_state["v"].values())
    for k in cpu._params:
        torch.testing.assert_close(card._params[k].cpu(), cpu._params[k],
                                   rtol=1e-5, atol=1e-5, msg=k)
