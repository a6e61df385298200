"""One rank of the port's strategy-search mesh tests:
``python _torch_search_worker.py <suite> <rank> <world> <workdir>``.

Started by ``_torch_mesh_cases.spawn`` (with ``script`` naming this
file), never by pytest.  The rank joins a gloo group through a
``file://`` rendezvous in ``workdir``, runs its suite on the CPU and
writes ``<suite>-rank<r>.npz`` and ``<suite>-rank<r>.json``.  The
device spec the search prices with (the JAX package's values) comes
from ``workdir/spec.json``, the initial parameters and the batch from
``workdir/init.npz``.
"""

import json
import os
import sys
import traceback

import numpy as np
import torch

_TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [_TESTS, os.path.dirname(_TESTS)]

import flexflow_tpu_torch as ft  # noqa: E402
from flexflow_tpu_torch.interop import params_from_jax_numpy  # noqa: E402
from flexflow_tpu_torch.search import cost_model  # noqa: E402
from flexflow_tpu_torch.strategy.proto import strategy_digest  # noqa: E402

ARRAYS: dict = {}
RECORD: dict = {}
ARCH = dict(num_layers=2, d_model=32, num_heads=2, d_ff=64, seq_len=16,
            vocab_size=128, num_classes=4)


def transformer(workdir: str, **cfg_kw):
    """The small BERT of ``_torch_search_cases.transformer``, compiled
    under the config's search (the process group's four devices)."""
    cfg = ft.FFConfig(batch_size=8, compute_dtype="float32",
                      flash_attention=False, **cfg_kw)
    m, _, logits = ft.build_transformer(cfg, **ARCH, device="cpu")
    m.compile(ft.AdamOptimizer(alpha=1e-3), final_tensor=logits)
    m.init_layers(seed=0)
    with np.load(os.path.join(workdir, "init.npz")) as z:
        params_from_jax_numpy(m, {k.split("|", 1)[1]: z[k]
                                  for k in z.files if k.startswith("p|")})
    return m


def batch(workdir: str):
    with np.load(os.path.join(workdir, "init.npz")) as z:
        return z["x"], z["y"]


def record(model) -> dict:
    return {"digest": strategy_digest({op.name: op.parallel_config
                                       for op in model.layers}),
            "mesh": {a: s for a, s in model.mesh.sizes.items() if s > 1},
            "dims": {op.name: list(op.parallel_config.dims)
                     for op in model.layers}}


def searched(workdir: str):
    """compile(search_budget) on four ranks (every rank searches the
    analytic objective), 2 steps, then a re-search pinned to {"n": 4}
    at a reshard and 1 step more; then the measured search in the same
    group."""
    rank = torch.distributed.get_rank()
    out = os.path.join(workdir, f"searched-rank{rank}.pb")
    m = transformer(workdir, search_budget=40, seed=3,
                    export_strategy_file=out)
    RECORD["compiled"] = record(m)
    x, y = batch(workdir)
    ARRAYS["loss"] = np.asarray([float(m.train_batch(x, y))
                                 for _ in range(2)])
    rep = m.reshard(new_mesh={"n": 4}, research=True)
    RECORD["reshard"] = {"researched": rep["researched"], **record(m)}
    ARRAYS["loss_after"] = np.asarray([float(m.train_batch(x, y))])
    for p in m.parameters:
        ARRAYS[f"param|{p.name}"] = np.asarray(m.get_weights(p.name),
                                               np.float32)
    measured(workdir)


def measured(workdir: str):
    """Measure mode on four ranks: rank 0 times the candidates on its
    CPU and broadcasts what it found; every rank compiles it."""
    m = transformer(workdir, search_budget=12, seed=1,
                    simulator_mode="measure")
    RECORD["measured"] = record(m)
    x, y = batch(workdir)
    ARRAYS["measured_loss"] = np.asarray([float(m.train_batch(x, y))])


SUITES = {"searched": searched}


def main():
    suite, rank, world, workdir = sys.argv[1:5]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    with open(os.path.join(workdir, "spec.json")) as f:
        cost_model.DEFAULT_SPEC = cost_model.DeviceSpec(**json.load(f))
    ft.initialize_distributed(
        init_method="file://" + os.path.join(workdir, f"store-{suite}"),
        world_size=world, rank=rank, device_type="cpu")
    try:
        with ft.fflogger.silenced("serve", "elastic"):
            SUITES[suite](workdir)
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        os._exit(1)
    np.savez(os.path.join(workdir, f"{suite}-rank{rank}.npz"), **ARRAYS)
    with open(os.path.join(workdir, f"{suite}-rank{rank}.json"), "w") as f:
        json.dump(RECORD, f)
    ft.finalize_distributed()


if __name__ == "__main__":
    main()
