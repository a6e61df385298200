"""The ops' cost methods and the cost model's time half in the port
(``flexflow_tpu_torch/op.py``, ``ops/*``, ``search/cost_model.py``)
against the JAX package's, on the CPU.

For every op of the zoo's graphs (AlexNet, a small BERT, ResNet-50 with
BatchNorm, a trimmed InceptionV3, DLRM, CANDLE-Uno, NMT, the MoE slice
and a pipeline block and segment) under every degree tuple
``legal_configs`` gives it on any mesh of 4 or 8 devices: ``flops``,
``weight_bytes``, ``activation_bytes`` and ``sub_problem`` equal,
``mxu_efficiency``, ``backward_overhead`` and ``internal_io_bytes`` equal
with the JAX package's corrections passed in through the spec
(``_torch_search_cases.reference_spec``), and ``op_compute_time``
forward and backward within 1e-12 relative at 2 and 4 bytes and each
precision token.  Attention is compared with ``flash_attention`` False
in both packages (the dense path); the port's own flash rule is held
separately, as are the H100 spec's neutral corrections, its cited time
fields and ``transfer_time``/``allreduce_time``.
"""

import math

import pytest

import _torch_search_cases as cases
import flexflow_tpu_torch as ft
from flexflow_tpu.search import cost_model as jax_cost
from flexflow_tpu.search.mcmc import candidate_meshes, legal_configs
from flexflow_tpu_torch.ops.attention import MultiHeadAttention
from flexflow_tpu_torch.search import cost_model as port_cost
from flexflow_tpu_torch.tensor import Tensor

REL = 1e-12


def close(a, b):
    return a == b or math.isclose(a, b, rel_tol=REL, abs_tol=0.0)


def degree_tuples(op, ndev):
    """Every distinct degree tuple of ``op``'s legal configs over the
    candidate meshes of ``ndev`` devices, in first-seen order."""
    seen = {}
    for mesh in candidate_meshes(ndev):
        for pc in legal_configs(op, mesh):
            seen.setdefault(tuple(pc.dims), None)
    return list(seen)


def sub_problem(op, dims):
    try:
        ins, ws = op.sub_problem(dims)
    except (AssertionError, ValueError) as e:
        return type(e).__name__
    return [tuple(s) for s in ins], {k: tuple(v) for k, v in ws.items()}


@pytest.mark.parametrize("ndev", [4, 8])
@pytest.mark.parametrize("name", sorted(cases.ZOO))
def test_cost_methods_equal_the_jax_package(name, ndev):
    jm, pm = cases.pair(name)
    ref = cases.REF
    checked = 0
    for jop, pop in zip(jm.layers, pm.layers):
        where = f"{name}/{jop.name}"
        assert pop.flops() == jop.flops(), where
        assert pop.weight_bytes() == jop.weight_bytes(), where
        assert pop.activation_bytes() == jop.activation_bytes(), where
        assert pop.mxu_efficiency(ref) == jop.mxu_efficiency(), where
        assert (pop.internal_io_bytes(False, "cpu", "float32")
                == jop.internal_io_bytes(False)), where
        for dims in degree_tuples(jop, ndev):
            assert (pop.backward_overhead(dims, ref)
                    == jop.backward_overhead(dims)), (where, dims)
            assert sub_problem(pop, dims) == sub_problem(jop, dims), \
                (where, dims)
            for dtype_bytes in (2, 4):
                for precision in ("", "bf16", "f32"):
                    for backward in (False, True):
                        j = jax_cost.op_compute_time(
                            jop, dims, jax_cost.DEFAULT_SPEC, dtype_bytes,
                            backward, flash_attention=False,
                            precision=precision)
                        p = port_cost.op_compute_time(
                            pop, dims, ref, dtype_bytes, backward,
                            flash_attention=False, precision=precision,
                            device="cpu", compute_dtype="float32")
                        assert close(p, j), (where, dims, dtype_bytes,
                                             precision, backward, p, j)
            checked += 1
    assert checked >= len(jm.layers)


def _attention(n=2, s=16, d=64, heads=2, dropout=0.0):
    x = Tensor((n, s, d), "float32")
    return MultiHeadAttention("attention", x, x, x, d, heads,
                              dropout=dropout)


@pytest.mark.parametrize("case,kw,flash", [
    ("cuda, flash auto", dict(device="cuda"), True),
    ("cuda, flash on", dict(device="cuda", flash_attention=True), True),
    ("cpu", dict(device="cpu"), False),
    ("cpu, flash on", dict(device="cpu", flash_attention=True), False),
    ("cuda, flash off", dict(device="cuda", flash_attention=False), False),
    ("cuda, float16", dict(device="cuda", compute_dtype="float16"), True),
    ("cuda, float64", dict(device="cuda", compute_dtype="float64"), False),
])
def test_attention_follows_the_ports_flash_rule(case, kw, flash):
    """The dense path's 12 bytes an element of (n, heads, sq, sk) are
    charged exactly where ``ops.attention.use_flash`` takes the dense
    path: on the CPU, with flash off, or with a dtype the kernels do not
    take; never by a length threshold or an alignment rule (s 16 here)."""
    op = _attention()
    kw.setdefault("compute_dtype", "bfloat16")
    got = op.internal_io_bytes(kw.get("flash_attention"), kw["device"],
                               kw["compute_dtype"])
    assert got == (0 if flash else 12 * 2 * 2 * 16 * 16), case


def test_attention_dropout_and_wide_heads_take_the_dense_path():
    dense = 12 * 2 * 2 * 16 * 16
    assert _attention(dropout=0.1).internal_io_bytes(None, "cuda") == dense
    wide = _attention(d=2 * 256, heads=2)       # head dim 256 > 128
    assert wide.internal_io_bytes(None, "cuda") == dense
    assert _attention(d=2 * 128).internal_io_bytes(None, "cuda") == 0
    # the rule reaches op_compute_time through the simulator's device
    op = _attention()
    cuda = port_cost.op_compute_time(op, (1, 1, 1), device="cuda")
    cpu = port_cost.op_compute_time(op, (1, 1, 1), device="cpu")
    assert cpu > cuda


def test_h100_spec_is_neutral_and_cites_its_time_fields():
    spec = port_cost.H100_SXM_SPEC
    assert spec.conv_lane_fill == 0 and spec.strided_dgrad_law == 0.0
    assert spec.maxpool_bwd_factor == 1.0
    assert spec.temp_factor == port_cost.TEMP_FACTOR
    # NVIDIA's data sheets: one 400 Gb/s ConnectX-7 a GPU (DGX H100),
    # 67 of 989 TFLOP/s for float32 outside the tensor cores (H100 SXM)
    assert spec.dcn_bw == 50e9
    assert spec.f32_matmul_scale == 67e12 / 989e12
    # the launch floor measured on the card, and no TPU value anywhere
    assert spec.kernel_launch == port_cost.H100_KERNEL_LAUNCH == 1.87e-6
    jax_spec = jax_cost.DEFAULT_SPEC
    for f in ("dcn_bw", "ici_latency", "kernel_launch", "mxu_flops",
              "vpu_flops", "hbm_bw", "ici_bw", "hbm_capacity"):
        assert getattr(spec, f) != getattr(jax_spec, f), f
    # a stride-2 conv and a max pool cost their roofline on the H100
    m = cases.alexnet(ft)
    conv, pool = m.layers[0], m.layers[1]
    assert conv.backward_overhead((1, 1, 1, 1), spec) == 1.0
    assert conv.mxu_efficiency(spec) == 1.0
    assert pool.backward_overhead((1, 1, 1, 1), spec) == 1.0
    # AlexNet's stride-4 stem under the JAX package's law: 1 + 2.4*16/4
    assert conv.backward_overhead((1, 1, 1, 1), cases.REF) == 10.6


@pytest.mark.parametrize("nbytes", [0, 1, 4096, 3.5e6, 1e9])
def test_transfer_and_allreduce_equal_the_jax_package(nbytes):
    for intra in (True, False):
        assert port_cost.transfer_time(nbytes, intra, cases.REF) == \
            jax_cost.transfer_time(nbytes, intra, jax_cost.DEFAULT_SPEC)
    for k in (1, 2, 3, 4, 8, 16):
        for per in (0, 1, 2, 4, 8):
            assert port_cost.allreduce_time(nbytes, k, cases.REF, per) == \
                jax_cost.allreduce_time(nbytes, k, jax_cost.DEFAULT_SPEC,
                                        per)
