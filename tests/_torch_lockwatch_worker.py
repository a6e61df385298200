"""The port's serving stack under ``FF_LOCKWATCH=1``, in a process of its
own (the module-level locks are made at import, when enablement is
sampled).  Run by ``tests/test_torch_concurrency.py``, never through
pytest (whose conftest imports jax):

    FF_LOCKWATCH=1 python tests/_torch_lockwatch_worker.py OUT.json

A dense model behind a ``ServingEngine``, a small causal LM behind a
``GenerationEngine``, a two-tenant ``FleetEngine`` round and one scrape
of the metrics server, all on the CPU; then the observed lock-order
edges and the static ones over the port's tree are written to OUT.json.
"""

import json
import os
import sys
import urllib.request

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import flexflow_tpu_torch as ft  # noqa: E402
from flexflow_tpu_torch.analysis import concurrency as cz  # noqa: E402
from flexflow_tpu_torch.fflogger import silenced  # noqa: E402
from flexflow_tpu_torch.obs import lockwatch  # noqa: E402
from flexflow_tpu_torch.obs.registry import (  # noqa: E402
    start_metrics_server, validate_prometheus_text)
from flexflow_tpu_torch.serving.fleet import (FleetEngine,  # noqa: E402
                                              ModelRegistry)

NFEAT = 12


def dense_builder(hidden, seed):
    def build(cfg, device):
        cfg.seed = seed
        m = ft.FFModel(cfg, device=device)
        x = m.create_tensor((cfg.batch_size, NFEAT), name="x")
        t = m.dense(x, hidden, activation="relu")
        m.dense(t, 6)
        return m
    return build


def lm_builder(cfg, device):
    return ft.build_transformer_lm(cfg, num_layers=1, d_model=32,
                                   num_heads=2, d_ff=64, seq_len=32,
                                   vocab_size=50, device=device)[0]


def main(out_path: str) -> int:
    assert lockwatch.enabled(), "run with FF_LOCKWATCH=1"
    rng = np.random.default_rng(0)
    cfg = ft.FFConfig(batch_size=8, compute_dtype="float32")
    dense = dense_builder(24, 1)(cfg, "cpu")
    dense.compile()
    dense.init_layers(seed=0)
    lm = lm_builder(ft.FFConfig(batch_size=2, compute_dtype="float32"),
                    "cpu")
    lm.compile()
    lm.init_layers(seed=0)
    with silenced("serve", "obs"):
        with ft.ServingEngine(dense, stats_every=4) as eng:
            futs = [eng.submit(rng.standard_normal(
                (int(n), NFEAT)).astype(np.float32))
                for n in rng.integers(1, 5, 24)]
            for f in futs:
                f.result(timeout=60)
        with ft.GenerationEngine(lm, slots=2, max_new_tokens=6) as gen:
            futs = [gen.submit([int(t) for t in rng.integers(1, 50, 5)])
                    for _ in range(4)]
            for f in futs:
                f.result(timeout=60)
        reg = ModelRegistry()
        reg.register("a", dense_builder(24, 1), batch_size=8,
                     serve={"max_wait_ms": 0.5, "stats_every": 0})
        reg.register("b", dense_builder(40, 2), batch_size=8,
                     serve={"max_wait_ms": 0.5, "stats_every": 0})
        server = start_metrics_server(0)
        try:
            with FleetEngine(reg, device="cpu") as fleet:
                xs = rng.standard_normal((4, NFEAT)).astype(np.float32)
                for f in [fleet.submit(n, xs) for n in ("a", "b") * 4]:
                    f.result(timeout=60)
                text = urllib.request.urlopen(
                    f"http://127.0.0.1:{server.server_port}/metrics",
                    timeout=30).read().decode()
        finally:
            server.shutdown()
            server.server_close()
    an = cz.build()
    runtime = sorted(lockwatch.edges())
    with open(out_path, "w") as f:
        json.dump({"runtime": runtime, "static": sorted(an.edges),
                   "locks": sorted(an.locks),
                   "cycle": lockwatch.report()["cycle"],
                   "scrape_problems": validate_prometheus_text(text),
                   "scrape_has_fleet": "ff_fleet_" in text}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
