"""The port's CUDA kernels on the card, against their plain versions
(the max-pool forward and backward kernels, and the autograd function
that pairs them).

Every test here needs a CUDA device: it carries the ``cuda`` marker and
skips elsewhere.  The file imports neither jax nor the JAX package, so
it runs on a machine that has only PyTorch and the CUDA toolkit:

    python -m pytest tests/test_torch_cuda.py -q --noconftest
"""

import pytest
import torch

from flexflow_tpu_torch.ops import cuda_pool

pytestmark = pytest.mark.cuda

# (N, C, H, W), kernel, stride, padding: AlexNet's pools and edge cases
CASES = [
    ((4, 64, 56, 56), (3, 3), (2, 2), (0, 0)),
    ((4, 192, 27, 27), (3, 3), (2, 2), (0, 0)),
    ((4, 256, 13, 13), (3, 3), (2, 2), (0, 0)),
    ((2, 8, 13, 13), (3, 3), (2, 2), (1, 1)),
    ((1, 130, 9, 9), (3, 3), (1, 1), (1, 1)),
    ((1, 4, 7, 7), (3, 2), (1, 2), (0, 1)),
    ((1, 8, 10, 10), (3, 3), (3, 3), (0, 0)),
    ((2, 8, 9, 9), (3, 3), (1, 1), (2, 2)),
]


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


def _input(shape, dtype, gen, nan=False):
    x = torch.randn(shape, generator=gen, device="cuda")
    if nan:
        x = x.masked_fill(torch.rand(shape, generator=gen, device="cuda")
                          < 0.02, float("nan"))
    return x.to(dtype).contiguous(memory_format=torch.channels_last)


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
