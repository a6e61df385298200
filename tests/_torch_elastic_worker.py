"""One rank of an elastic run of the port, launched by
``flexflow_tpu_torch.parallel.elastic.run_elastic`` (the tests'
``tests/test_torch_elastic.py`` and ``chip_smoke.py``'s elastic phase
follow the same pattern):
``python _torch_elastic_worker.py <workdir> <device> <steps> <every>``.

The standard resume pattern: join the group from torchrun's variables
the supervisor exports (``initialize_distributed()``), stamp a
heartbeat a step (``resilience.Heartbeat``, which also registers the
rank for rank-scoped ``FF_FAULT`` specs), resume from the newest valid
checkpoint of ``<workdir>/ckpt`` (``resilience.elastic_resume``,
resharding on resume when the world changed), then train to ``<steps>``
on per-step batches, saving ``elastic_step<N>.npz`` every ``<every>``
steps.  Faults come from ``FF_FAULT`` alone: the hooks in
``train_batch`` and ``save_checkpoint`` fire them.

Writes ``<workdir>/resume_r<rank>_a<attempt>.txt`` (the checkpoint
resumed from, or "fresh") and, on rank 0 at the end,
``<workdir>/final.json`` (the losses and the last loss's repr).
"""

import json
import os
import sys

_TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [_TESTS, os.path.dirname(_TESTS)]

import _torch_a8b_cases as cases  # noqa: E402
import flexflow_tpu_torch as ft  # noqa: E402
from flexflow_tpu_torch.resilience import (Heartbeat,  # noqa: E402
                                           elastic_resume)


def main():
    workdir, device = sys.argv[1], sys.argv[2]
    steps, every = int(sys.argv[3]), int(sys.argv[4])
    import torch
    torch.set_num_threads(1)
    rank = int(os.environ["RANK"])
    attempt = int(os.environ.get("FF_ELASTIC_ATTEMPT", "0"))
    backend = "cpu:gloo,cuda:gloo" if device == "cuda" else "gloo"
    ft.initialize_distributed(backend=backend, device_type=device)
    hb = Heartbeat(rank=rank)
    ckpt = os.path.join(workdir, "ckpt")
    model = cases.mlp(ft, degrees={}, device=device)
    with ft.fflogger.capture_events("elastic") as events:
        resumed = elastic_resume(model, ckpt)
    with open(os.path.join(workdir, f"resume_r{rank}_a{attempt}.txt"),
              "w") as f:
        f.write(os.path.basename(resumed) if resumed else "fresh")
    hb.beat(model._step)
    losses = []
    while model._step < steps:
        losses.append(cases.train(model, 1)[0])
        hb.beat(model._step)
        if model._step % every == 0 and model._step < steps:
            model.save_checkpoint(
                os.path.join(ckpt, f"elastic_step{model._step}.npz"))
    if rank == 0:
        with open(os.path.join(workdir, "final.json"), "w") as f:
            json.dump({"loss": repr(losses[-1]) if losses else None,
                       "losses": losses,
                       "world": torch.distributed.get_world_size(),
                       "attempt": attempt,
                       "events": [e["event"] for e in events]}, f)
    ft.finalize_distributed()


if __name__ == "__main__":
    main()
