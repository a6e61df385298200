"""The flash-attention wrapper's operand preparation, on the CPU.

The bf16/f16 kernels load their tiles by TMA, which needs a head dim that
is a multiple of 8 and 16-byte aligned operands; ``kernel_operands``
copies operands that are not so, zero-padding the head dim
(``pad_head_dim``), and ``unpad`` slices the results back.  Here the plain
versions (which the wrapper runs for CPU tensors) take padded operands:
O, lse, dq, dk and dv must come out as from the unpadded ones.  They
agree within 1e-6 rather than bit for bit, because the CPU's matrix
products may block a longer reduction differently; the padded columns
themselves are exact zeros.
"""

import numpy as np
import pytest
import torch

from flexflow_tpu_torch.ops import cuda_attention as ca


def _operands(n, sq, sk, h, d, seed=0):
    rng = np.random.default_rng(seed)
    shapes = [(n, sq, h, d), (n, sk, h, d), (n, sk, h, d), (n, sq, h, d)]
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in shapes]


@pytest.mark.parametrize("sq,sk", [(77, 130), (130, 77)])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [16, 100, 64])
def test_padded_operands_give_the_unpadded_results(d, causal, sq, sk):
    q, k, v, do = _operands(2, sq, sk, 3, d)
    scale = d ** -0.5
    o, lse = ca.flash_attention_forward(q, k, v, causal, scale)
    grads = ca.flash_attention_backward(q, k, v, o, lse, do, causal, scale)

    # past the next multiple of 8, so that every case has zero columns
    padded = (d // 8 + 1) * 8
    qp, kp, vp, dop = (ca.pad_head_dim(t, padded) for t in (q, k, v, do))
    op, lsep = ca.flash_attention_forward(qp, kp, vp, causal, scale)
    assert torch.equal(op[..., d:], torch.zeros_like(op[..., d:]))
    # the backward takes O as the forward returned it, sliced back
    op_ = ca.pad_head_dim(ca.unpad(op, d), padded)
    gp = ca.flash_attention_backward(qp, kp, vp, op_, lsep, dop, causal,
                                     scale)
    np.testing.assert_allclose(ca.unpad(op, d).numpy(), o.numpy(),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(lsep.numpy(), lse.numpy(), atol=1e-6,
                               rtol=0)
    for name, g, w in zip(("dq", "dk", "dv"), gp, grads):
        assert torch.equal(g[..., d:], torch.zeros_like(g[..., d:])), name
        np.testing.assert_allclose(ca.unpad(g, d).numpy(), w.numpy(),
                                   atol=1e-6, rtol=0, err_msg=name)


def test_kernel_operands_copies_only_what_tma_cannot_take():
    base = torch.randn(4 * 8 * 2 * 64 + 1).to(torch.bfloat16)
    aligned = base[:4 * 8 * 2 * 64].view(4, 8, 2, 64)
    assert aligned.data_ptr() % 16 == 0
    # aligned bf16 with d % 8 == 0 (BERT-base's case): no copy
    (same,) = ca.kernel_operands(aligned)
    assert same.data_ptr() == aligned.data_ptr()
    # unaligned storage: a fresh aligned copy of the same values
    shifted = base[1:].view(4, 8, 2, 64)
    assert shifted.data_ptr() % 16 != 0
    a, b = ca.kernel_operands(aligned, shifted)
    assert b.data_ptr() % 16 == 0 and a.data_ptr() % 16 == 0
    assert torch.equal(b, shifted) and torch.equal(a, aligned)
    # a head dim TMA cannot stride: padded with zeros to a multiple of 8
    odd = torch.randn(2, 5, 3, 100).to(torch.float16)
    (p,) = ca.kernel_operands(odd)
    assert p.shape == (2, 5, 3, 104) and p.is_contiguous()
    assert torch.equal(p[..., :100], odd)
    assert torch.equal(p[..., 100:], torch.zeros_like(p[..., 100:]))
    assert torch.equal(ca.unpad(p, 100), odd)
    # non-contiguous: made contiguous
    (c,) = ca.kernel_operands(aligned.transpose(1, 2))
    assert c.is_contiguous() and torch.equal(c, aligned.transpose(1, 2))
    # float32 runs the scalar kernels: any head dim, only made contiguous
    f = torch.randn(2, 5, 3, 100)
    (g,) = ca.kernel_operands(f)
    assert g.data_ptr() == f.data_ptr()
