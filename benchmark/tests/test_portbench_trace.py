"""The reduction of a traced window: device intervals merged, kernel time
clipped to the window, idle gaps named by the innermost host range open
when each began, and a trace whose kernel count differs from the
program's launch counter refused."""

from __future__ import annotations

import os
import sys
import types

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from portbench import readers  # noqa: E402
from portbench.trace import WINDOW, Trace, TracedSpan  # noqa: E402


def _trace():
    ops = [("void layernorm_kernel<bf16>", 1.0, 2.0),
           ("sm80_xmma_gemm_f32f32", 1.5, 3.0),    # overlaps the first
           ("flash_fwd_tc_kernel", 5.0, 6.0),
           ("flash_bwd_dq_tc_kernel", 9.5, 11.0)]  # runs past the window
    host = [("bench.train_batch", 0.0, 10.0), ("aten::mul", 3.5, 4.0),
            ("cudaStreamSynchronize", 6.5, 8.0)]
    return Trace(0.0, 10.0, ops, host)


def test_busy_time_merges_overlaps_and_clips_to_the_window():
    tr = _trace()
    assert tr.busy_intervals() == [(1.0, 3.0), (5.0, 6.0), (9.5, 10.0)]
    assert tr.busy_s == pytest.approx(3.5)
    assert tr.kernel_seconds(r"flash_bwd") == pytest.approx(0.5)
    assert tr.kernel_count(readers.GEMM_KERNELS) == 1
    assert tr.kernel_count(readers.LAYERNORM_KERNELS) == 1
    assert tr.kernel_count(readers.FLASH_KERNELS) == 2


def test_idle_gaps_are_named_by_the_innermost_open_range():
    gaps = dict(map(tuple, _trace().idle_gaps()))
    # 0-1 and 3-5 open under train_batch (3.5-4 is aten::mul, but the
    # gap began at 3.0); 6-9.5 began under train_batch too
    assert gaps == pytest.approx({"bench.train_batch": 1.0 + 2.0 + 3.5})


def test_layernorm_kernel_pattern_leaves_torch_layer_norm_out():
    tr = Trace(0.0, 1.0, [
        ("void at::native::vectorized_layer_norm_kernel<float>", 0.1, 0.2),
        ("void layernorm_kernel<__nv_bfloat16, 4>", 0.3, 0.4)])
    assert tr.kernel_count(readers.LAYERNORM_KERNELS) == 1


def test_a_trace_short_of_the_counter_is_refused(monkeypatch):
    counter = types.ModuleType("portbench_test_counter")
    counter.launches = 0
    monkeypatch.setitem(sys.modules, "portbench_test_counter", counter)
    span = TracedSpan({r"no_such_kernel":
                       ("portbench_test_counter:launches", 1)}, False)
    span.start()
    with torch.profiler.record_function(WINDOW):
        counter.launches += 1      # a launch the trace does not hold
    with pytest.raises(RuntimeError, match="incomplete trace"):
        span.stop()


def test_a_complete_trace_passes():
    span = TracedSpan({}, False)
    span.start()
    with torch.profiler.record_function(WINDOW):
        torch.ones(4).sum()
    tr = span.stop()
    assert tr.window_s > 0 and tr.ops == []
