"""The training driver: ``FFModel.train_batch`` back to back.

Set-up builds the one model, installs the seed's weights and drives it
through its first ``CHECKED_STEPS`` steps by the window's own call and
feed, on batches whose rows all differ; those steps warm every shape,
and what they produced is recorded for the check: each step's loss, the
first gradient as Adam got it (from its first moment) and each leaf's
change over the steps.  The window then runs steps until
``seconds`` have passed and ends on a device synchronize.  After the
window the program is freed and the plain reference follows the same
steps from the same weights and batches.
"""

from __future__ import annotations

import gc
import sys
import time
from typing import Dict, Optional

import torch

from . import check, flops, weights
from .cell import Cell, Run
from .trace import WINDOW, TracedSpan

CHECKED_STEPS = 3
# the host range around each train_batch call of the window
STEP = "bench.train_batch"


def program_steps(cell: Cell, seed: int, device):
    """Build the program, install the weights, run the checked steps.
    Returns (model, batches, record)."""
    fam, traffic = cell.family, cell.traffic
    model = fam.build(cell.config, traffic, device)
    spec = fam.weight_spec(cell.config, traffic["seq_len"])
    weights.install(model, weights.make(spec, seed, device))
    feed = fam.batches(cell.config, traffic, seed, device)
    if len(feed) <= CHECKED_STEPS:
        raise ValueError(f"a pool of {len(feed)} batches: the window needs "
                         f"more than the {CHECKED_STEPS} checked steps")
    losses, grads = [], {}
    for i in range(CHECKED_STEPS):
        losses.append(model.train_batch(*feed[i]))
        if i == 0:
            grads = fam.first_gradient_norms(model)
    w0 = weights.make(spec, seed, device)
    params = fam.parameters(model)
    change = {k: float((params[k].float() - w0[k]).norm()) for k in w0}
    del w0, params
    record = {"losses": [float(v) for v in losses], "grad_norms": grads,
              "change_norms": change}
    return model, feed, record


def reference_steps(cell: Cell, seed: int, device, prec: str = "float32",
                    rows: Optional[slice] = None) -> Dict:
    """The reference's checked steps from the seed's weights and
    batches (``rows`` of each batch only: the half-batch fault)."""
    fam = cell.family
    w0 = weights.make(fam.weight_spec(cell.config, cell.traffic["seq_len"]),
                      seed, device)
    feed = fam.batches(cell.config, cell.traffic, seed,
                       device)[:CHECKED_STEPS]
    if rows is not None:
        feed = [(t[rows], y[rows]) for t, y in feed]
    return cell.reference.train(w0, cell.geometry, cell.config["optimizer"],
                                feed, prec)


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float) -> Run:
    cuda = torch.device(device).type == "cuda"
    model, feed, record = program_steps(cell, seed, device)
    batch = cell.traffic["batch"]
    span = TracedSpan(cell.kernels(), cuda) if trace else None
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.monotonic() - t_start
    if span:
        span.start()
    host, losses = [], []
    with torch.profiler.record_function(WINDOW):
        t0 = time.monotonic()
        i = CHECKED_STEPS
        while True:
            ts = time.monotonic()
            with torch.profiler.record_function(STEP):
                losses.append(model.train_batch(*feed[i % len(feed)]))
            host.append(time.monotonic() - ts)
            i += 1
            if time.monotonic() - t0 >= seconds:
                break
        if cuda:
            torch.cuda.synchronize()
        window_s = time.monotonic() - t0
    tr = span.stop() if span else None
    if tr is not None:
        print(f"trace: {len(tr.ops)} device operations in the window, "
              f"reduced in {span.reduce_s:.3f} s", file=sys.stderr)
    steps = len(host)
    failed = int((~torch.isfinite(torch.stack(losses))).sum())
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    del model, feed, losses
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ref = reference_steps(cell, seed, device)
    plain = reference_steps(cell, seed, device, "bf16")
    numbers = check.train_numbers(record, ref, plain)
    seq = cell.traffic["seq_len"]
    geo = cell.geometry
    work = {"steps": steps, "samples": steps * batch, "seq_len": seq,
            "host_s": host, "record": record,
            "model_flop": flops.encoder_train_flop(
                geo, seq, steps * batch)["model"],
            # two LayerNorms a layer over every row of every step
            "layernorm_rows": 2 * geo["layers"] * steps * batch * seq}
    return Run(cell, seed, window_s, work,
               trace=tr, setup_s=setup_s, attempted=steps, failed=failed,
               end_to_end={"train_samples_per_s": steps * batch / window_s},
               checks=numbers, memory_peak_bytes=peak)
