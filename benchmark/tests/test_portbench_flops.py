"""The benchmark's copy of the operation and byte arithmetic reproduces
the figures the port's kernel table was measured against (H100
roofline, bf16): flash attention at BERT-base's shape and the LayerNorm
kernel at 8192 rows of 768."""

from __future__ import annotations

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from portbench import flops, peaks  # noqa: E402


def test_flash_forward_at_bert_base_shape():
    f = flops.flash_forward(16, 512, 12, 64)
    assert f["flop"] / 1e9 == pytest.approx(12.88, abs=0.005)
    assert f["bytes"] / 1e6 == pytest.approx(50.72, abs=0.005)
    # bytes bound it: 0.0151 ms against the FLOP bound's 0.0130
    assert flops.least_seconds(f["flop"], f["bytes"]) * 1e3 == \
        pytest.approx(0.0151, abs=5e-5)


def test_flash_backward_at_bert_base_shape():
    b = flops.flash_backward(16, 512, 12, 64)
    assert b["flop"] / 1e9 == pytest.approx(32.21, abs=0.005)
    assert b["bytes"] / 1e6 == pytest.approx(101.06, abs=0.005)
    assert flops.least_seconds(b["flop"], b["bytes"]) * 1e3 == \
        pytest.approx(0.0326, abs=5e-5)


@pytest.mark.parametrize("out_bytes, mb", [(4, 37.75), (2, 25.17)])
def test_layernorm_bytes_at_8192_rows(out_bytes, mb):
    assert flops.layernorm_bytes(8192, 768, 2, out_bytes) / 1e6 == \
        pytest.approx(mb, abs=0.005)


def test_causal_pairs_count_the_lower_triangle():
    assert flops.attention_pairs(4, 4, True) == 10
    assert flops.attention_pairs(1, 7, True) == 7      # a decode step
    assert flops.attention_pairs(3, 5, False) == 15


def test_peaks_are_the_data_sheet_figures():
    assert peaks.BF16_FLOPS == 989e12
    assert peaks.HBM_BYTES == 3.35e12


def test_prefill_counts_each_token_at_its_context():
    geo = {"layers": 2, "d_model": 8, "heads": 2, "head_dim": 4,
           "d_ff": 32, "vocab": 11}
    by_token = sum(flops.lm_token_flop(geo, i + 1, False) for i in range(5))
    head = 2.0 * geo["d_model"] * geo["vocab"]
    assert flops.lm_prefill_flop(geo, 5) == pytest.approx(by_token + head)


def test_encoder_flop_is_three_forwards():
    geo = {"layers": 12, "d_model": 768, "heads": 12, "head_dim": 64,
           "d_ff": 3072, "classes": 2}
    f = flops.encoder_train_flop(geo, 512, 1)
    # about 290 GFLOP a sample at s 512: 6 x 85 M x 512 plus attention
    assert 280e9 < f["model"] < 300e9
    assert f["matmul"] < f["model"]
