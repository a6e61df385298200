"""Per-op profiling, the counterpart of the JAX package's
``profiling.py`` (the ``profiling`` flag; the reference's cudaEvent
timing inside every forward and backward task, conv_2d.cu:446-471).

Each op is timed alone on the device it is given, forward and forward
plus backward, as the reference's simulator times an op for measure mode
(``measure_compute_time``, simulator.cc:235-273).  On a CUDA device the
op's own path runs (the hand-written kernels where the op has one) and
CUDA events time it; on the CPU, which runs only when a caller names it,
the plain versions run and the host clock times them.  ``fit`` prints
:func:`profile_model`'s table once up front when ``config.profiling`` is
set, and the simulator's measure mode (``search/simulator.py``) times
each candidate partition through :func:`profile_op`.
"""

from __future__ import annotations

import time
from typing import Dict, List, Tuple

import torch

from .op import Op, OpContext, resolve_conv_layout
from .ops.common import torch_dtype


def _example_inputs(op: Op, shapes, device: torch.device, seed: int):
    """Random normal float inputs from a seeded generator (zeros could
    flatter ops whose time depends on the data); int inputs zeros, a
    valid index everywhere.  ``shapes`` overrides the declared shapes
    (measure mode's per-partition sub-shapes)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    outs = []
    for i, t in enumerate(op.inputs):
        shape = tuple(shapes[i]) if shapes is not None else t.shape
        dtype = torch_dtype(t.dtype)
        if not dtype.is_floating_point:
            outs.append(torch.zeros(shape, dtype=dtype, device=device))
        else:
            outs.append(torch.randn(shape, generator=gen, device=device,
                                    dtype=torch.float32).to(dtype))
    return outs


def _init_params(op: Op, shapes, device: torch.device,
                 seed: int) -> Dict[str, torch.Tensor]:
    """The op's weights from its initializers (GlorotUniform where it
    names none), drawn as ``FFModel.init_layers`` draws them, at the
    sizes ``shapes`` gives (a partition's)."""
    from .initializers import GlorotUniform
    gen = torch.Generator().manual_seed(seed)
    params = {}
    for p in op.weights:
        init = p.initializer or GlorotUniform()
        shape = tuple(shapes.get(p.name, p.shape)) if shapes else p.shape
        params[p.name] = init(gen, shape, torch_dtype(p.dtype)).to(device)
    return params


def profile_op(op: Op, compute_dtype: str = "bfloat16", warmup: int = 2,
               iters: int = 5, flash_attention=None, input_shapes=None,
               weight_shapes=None, conv_layout: str = "auto",
               device="cuda") -> Dict[str, float]:
    """``{"fwd_ms", "bwd_ms"}`` for one op timed alone on ``device``.
    The context mirrors the run's choices (compute dtype, flash flag,
    conv layout, a training step), so the numbers are those of what
    ``fit`` runs.  ``input_shapes``/``weight_shapes`` override the
    declared shapes: the simulator's measure mode times one PARTITION
    of the op this way (``Op.sub_problem``).

    The backward is forward and backward through autograd, with
    gradients to the weights and the float inputs (wgrad and dgrad, as
    the reference measures bwdFilter and bwdData), less the forward.
    An op with no float input and no weight gives NaN for both; an op
    whose output does not depend on one gives NaN for the backward.
    Anything else the op raises propagates (a kernel that fails to build
    or launch is an error, not a slow config)."""
    device = torch.device(device)
    seed = 0
    ctx = OpContext(device=device, seed=seed, training=True,
                    compute_dtype=compute_dtype,
                    conv_layout=resolve_conv_layout(conv_layout, device),
                    flash_attention=flash_attention)
    params = _init_params(op, weight_shapes, device, seed)
    inputs = _example_inputs(op, input_shapes, device, seed)
    float_in = [i for i, x in enumerate(inputs) if x.is_floating_point()]
    float_params = [k for k, v in params.items() if v.is_floating_point()]
    if not float_in and not float_params:
        # int-only view op: nothing on the float path to time
        return {"fwd_ms": float("nan"), "bwd_ms": float("nan")}

    def fwd():
        with torch.no_grad():
            out = op.forward(params, inputs, ctx)
        ctx.updates.clear()
        ctx.aux_losses.clear()
        return out

    leaves_p = {k: v.detach().requires_grad_(True)
                for k, v in params.items() if k in float_params}
    leaves_x = [inputs[i].detach().requires_grad_(True) for i in float_in]

    def loss():
        full = list(inputs)
        for i, v in zip(float_in, leaves_x):
            full[i] = v
        outs = op.forward({**params, **leaves_p}, full, ctx)
        ctx.updates.clear()
        ctx.aux_losses.clear()
        terms = [torch.sum(o.to(torch.float32) ** 2) for o in outs
                 if o.is_floating_point()]
        return sum(terms) if terms else None

    def fwd_bwd():
        total = loss()
        return torch.autograd.grad(total, [*leaves_p.values(), *leaves_x],
                                   allow_unused=True)

    fwd_ms = _time_loop(fwd, device, warmup, iters)
    probe = loss()
    differentiable = probe is not None and probe.requires_grad
    del probe
    tot_ms = (_time_loop(fwd_bwd, device, warmup, iters) if differentiable
              else float("nan"))
    # NaN survives: max(0.0, nan - fwd) would report a failed backward
    # as a free one
    bwd_ms = float("nan") if tot_ms != tot_ms else max(0.0, tot_ms - fwd_ms)
    return {"fwd_ms": fwd_ms, "bwd_ms": bwd_ms}


def quantiles(samples, qs=(0.5, 0.95, 0.99)) -> Dict[float, float]:
    """Nearest-rank quantiles of a sample sequence — the p50/p95/p99
    latency accounting shared by the serving metrics.  Nearest-rank
    (not interpolated): every reported value is a latency that actually
    happened.  Returns ``{q: value}``; empty input yields NaNs."""
    xs = sorted(samples)
    if not xs:
        return {q: float("nan") for q in qs}
    n = len(xs)
    return {q: float(xs[min(n - 1, _nearest_rank(q, n))]) for q in qs}


def _nearest_rank(q: float, n: int) -> int:
    """0-based nearest-rank index: ceil(q*n) - 1, computed in exact
    integer arithmetic for the common x.xx quantiles so float jitter
    (0.95*20 == 18.999...96) cannot shift the rank."""
    num = int(round(q * 10000))
    return max(0, -(-num * n // 10000) - 1)


def time_calls(fn, min_time_s: float = 0.3, max_calls: int = 1_000_000
               ) -> Tuple[float, int]:
    """(calls/sec, n_calls) of repeatedly invoking ``fn()`` until at
    least ``min_time_s`` of wall clock accumulates: host-side timing for
    host code (the search's proposals a second)."""
    n = 0
    t0 = time.perf_counter()
    while True:
        fn()
        n += 1
        dt = time.perf_counter() - t0
        if dt >= min_time_s or n >= max_calls:
            return n / dt, n


def _time_loop(fn, device: torch.device, warmup: int, iters: int) -> float:
    """Per-call ms of ``fn()``: after ``warmup`` calls (the first call
    of a kernel builds and loads it), ``n`` calls back to back between
    two CUDA events on a CUDA device (the median of three windows), or
    between two host-clock reads on the CPU.  ``n`` grows until a window
    covers 1 ms on the card (10 ms of host time), so launch jitter is
    small beside it."""
    for _ in range(max(1, warmup)):
        fn()
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)

    def window(n: int) -> float:
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n):
                fn()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / n
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t0) * 1e3 / n

    target_ms, repeats = (1.0, 3) if cuda else (10.0, 1)
    n = max(1, iters)
    est = window(n)
    if est * n < target_ms:
        n = int(min(1000, max(n, target_ms / max(est, 1e-4))))
        est = window(n)
    if repeats > 1:
        ts = sorted([est] + [window(n) for _ in range(repeats - 1)])
        est = ts[len(ts) // 2]
    return est


def profile_model(model, file=None) -> List[Dict[str, float]]:
    """Print the reference's per-op timing table for every layer, timed
    on the model's device."""
    rows = []
    cfg = model.config
    print(f"{'op':30s} {'type':14s} {'fwd(ms)':>9s} {'bwd(ms)':>9s}",
          file=file)
    for op in model.layers:
        r = profile_op(op, cfg.compute_dtype,
                       flash_attention=cfg.flash_attention,
                       conv_layout=cfg.conv_layout, device=model.device)
        rows.append({"name": op.name, **r})
        print(f"{op.name:30s} {op.op_type.value:14s} "
              f"{r['fwd_ms']:9.3f} {r['bwd_ms']:9.3f}", file=file)
    return rows
