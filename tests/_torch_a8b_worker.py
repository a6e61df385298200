"""One rank of the port's reshard and sharded-generation tests:
``python _torch_a8b_worker.py <suite> <rank> <world> <workdir>``.

Started by ``_torch_mesh_cases.spawn`` (with ``script`` naming this
file), never by pytest.  The rank joins a gloo group through a
``file://`` rendezvous in ``workdir``, runs its suite on the CPU and
writes ``<suite>-rank<r>.npz`` and ``<suite>-rank<r>.json``.  Initial
parameters come from ``workdir/init.npz`` (the JAX package's).
"""

import json
import os
import sys
import traceback

import numpy as np
import torch

_TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [_TESTS, os.path.dirname(_TESTS)]

import _torch_a8b_cases as cases  # noqa: E402
import flexflow_tpu_torch as ft  # noqa: E402
from flexflow_tpu_torch.fflogger import capture_events  # noqa: E402
from flexflow_tpu_torch.interop import params_from_jax_numpy  # noqa: E402

ARRAYS: dict = {}
RECORD: dict = {}


def init_params(workdir: str, prefix: str) -> dict:
    with np.load(os.path.join(workdir, "init.npz")) as z:
        return {k.split("|", 1)[1]: z[k] for k in z.files
                if k.startswith(prefix + "|")}


def mesh_mlp(workdir, shape):
    m = cases.mlp(ft, mesh=ft.MachineMesh(shape, device="cpu"),
                  device="cpu")
    params_from_jax_numpy(m, init_params(workdir, "mlp"))
    return m


def reshard(workdir: str):
    """Each target: 2 steps on the source mesh, the step-2 checkpoint,
    an in-process reshard, 3 steps; the fixed-mesh reference loads the
    checkpoint on the target and takes the same 3 steps.  Then the
    optimizer state across a reshard, the rollback and the refusals."""
    rank = torch.distributed.get_rank()
    for tag, target in cases.TARGETS.items():
        m = mesh_mlp(workdir, cases.SOURCE)
        ARRAYS[f"{tag}|pre"] = np.asarray(cases.train(m, cases.PRE))
        ckpt = os.path.join(workdir, f"{tag}_step{cases.PRE}.npz")
        m.save_checkpoint(ckpt)
        with capture_events("elastic") as ev:
            report = m.reshard(new_mesh=target)
        ARRAYS[f"{tag}|post"] = np.asarray(cases.train(m, cases.POST))
        after = os.path.join(workdir, f"{tag}_after.npz")
        RECORD[tag] = {"report": report,
                       "events": [e["event"] for e in ev],
                       "mesh": {a: s for a, s in m.mesh.sizes.items()
                                if s > 1},
                       "local": {p.name: list(
                           m._params[p.name].to_local().shape)
                           for p in m.parameters}}
        ref = mesh_mlp(workdir, target)
        ref.load_checkpoint(ckpt)
        ARRAYS[f"{tag}|ref"] = np.asarray(cases.train(ref, cases.POST))
        for k, v in cases.weights(m).items():
            ARRAYS[f"{tag}|param|{k}"] = v
    # the optimizer state moves value-lossless: a save right after a
    # reshard holds the arrays of a save right before it
    m = mesh_mlp(workdir, cases.SOURCE)
    cases.train(m, 2)
    m.save_checkpoint(os.path.join(workdir, "before.npz"))
    m.reshard(new_mesh={"n": 4})
    m.save_checkpoint(os.path.join(workdir, "after.npz"))
    # verify="error" rolls back: a degree of 3 fits no axis of the target
    bad = ft.ParallelConfig(dims=(3, 1), device_ids=(0, 1, 2))
    m.layers[0].parallel_config = bad
    out = {}
    try:
        m.reshard(new_mesh={"n": 2, "c": 2}, verify="error")
        out["verify"] = "no error"
    except Exception as e:  # noqa: BLE001 — recorded for the test
        out["verify"] = type(e).__name__
    out["kept_mesh"] = {a: s for a, s in m.mesh.sizes.items() if s > 1}
    out["kept_config"] = m.layers[0].parallel_config is bad
    m.layers[0].parallel_config = None
    out["loss_after_rollback"] = cases.train(m, 1)[0]
    for name, call in (
            ("count", lambda: m.reshard(num_devices=2)),
            ("mesh_count", lambda: m.reshard(new_mesh={"n": 8})),
            ("args", lambda: m.reshard())):
        try:
            call()
            out[name] = "no error"
        except Exception as e:  # noqa: BLE001
            out[name] = f"{type(e).__name__}: {e}"
    # the 4-rank checkpoint the 2-rank resume suite loads
    m.save_checkpoint(os.path.join(workdir, f"elastic_step{m._step}.npz"))
    # a re-search pinned to the explicit mesh: the searched strategies
    # are expressible on {"n": 4} and training goes on
    rep = m.reshard(new_mesh={"n": 4}, research=True)
    out["research"] = {"researched": rep["researched"],
                       "new_mesh": rep["new_mesh"],
                       "loss": cases.train(m, 1)[0]}
    RECORD["behaviour"] = out
    RECORD["rank"] = rank


def resume2(workdir: str):
    """A 4-rank checkpoint loads on 2 ranks: reshard_on_resume, then
    two steps."""
    from flexflow_tpu_torch.resilience import elastic_resume
    m = cases.mlp(ft, mesh=ft.MachineMesh({"n": 2}, device="cpu"),
                  device="cpu")
    with capture_events("elastic") as ev:
        path = elastic_resume(m, workdir)
    RECORD["path"] = os.path.basename(path)
    RECORD["events"] = [{k: v for k, v in e.items()
                         if k not in ("t", "t_ns")} for e in ev]
    RECORD["step"] = m._step
    ARRAYS["loss"] = np.asarray(cases.train(m, 2))


def _lm_on_mesh(workdir):
    lm = cases.build_lm(ft, device="cpu")
    lm.compile(mesh=ft.MachineMesh(cases.GEN_MESH, device="cpu"))
    lm.init_layers(seed=0)
    params_from_jax_numpy(lm, init_params(workdir, "lm"))
    return lm


def _serve(eng, prompts, max_new):
    rank = torch.distributed.get_rank()
    outs = []
    with eng:
        if rank == 0:
            streams = [eng.submit(p, max_new_tokens=max_new)
                       for p in prompts]
            outs = [[int(t) for t in s.result(timeout=300)]
                    for s in streams]
    return outs, eng.stats()


def gen(workdir: str):
    """Sharded generation at {"n": 2, "c": 2}: from_strategy on a
    compiled model (the JAX weights, re-placed), with a replicated draft,
    and on a fresh model; tokens on rank 0, dispatch counts everywhere."""
    rank = torch.distributed.get_rank()
    pb = os.path.join(workdir, "gen_tp.pb")
    prompts = cases.prompts()
    lm = cases.build_lm(ft, device="cpu")
    lm.compile()     # the default mesh: data parallel over the 4 ranks
    lm.init_layers(seed=0)
    params_from_jax_numpy(lm, init_params(workdir, "lm"))
    eng = ft.GenerationEngine.from_strategy(lm, pb, slots=cases.SLOTS,
                                            max_new_tokens=6)
    RECORD["mesh"] = {a: s for a, s in lm.mesh.sizes.items() if s > 1}
    RECORD["kv_cache_bytes"] = eng.kv_cache_bytes
    RECORD["pool_bytes"] = sum(
        int(t.numel() * t.element_size())
        for sub in eng._decoder.init_cache().values() for t in sub.values())
    RECORD["local_wq"] = list(eng._params["attention_0/wq"].shape)
    if rank != 0:
        try:
            eng.submit(prompts[0])
            RECORD["follower_submit"] = "no error"
        except Exception as e:  # noqa: BLE001
            RECORD["follower_submit"] = f"{type(e).__name__}: {e}"
    outs, snap = _serve(eng, prompts[:4], 6)
    RECORD["tp"] = {"outs": outs, "dispatches": snap["plan_dispatches"],
                    "plan_bytes": snap["plan_bytes"]}
    # speculation: the target sharded, the draft replicated (data
    # parallel over every rank, the same weights)
    draft = _lm_on_mesh(workdir)
    draft.reshard(new_mesh={"n": 4})
    lm2 = _lm_on_mesh(workdir)
    eng = ft.GenerationEngine.from_strategy(
        lm2, pb, slots=cases.SLOTS, draft_model=draft, spec_gamma=2)
    outs, snap = _serve(eng, prompts[:3], 6)
    RECORD["spec"] = {"outs": outs, "dispatches": snap["plan_dispatches"],
                      "draft_dispatches": snap.get("draft_dispatches"),
                      "spec_fallbacks": snap.get("spec_fallbacks")}
    # a fresh (uncompiled) model: compiled and initialised under the
    # strategy's mesh
    fresh = cases.build_lm(ft, device="cpu")
    eng = ft.GenerationEngine.from_strategy(fresh, pb, slots=cases.SLOTS,
                                            max_new_tokens=4)
    RECORD["fresh_mesh"] = {a: s for a, s in fresh.mesh.sizes.items()
                            if s > 1}
    outs, snap = _serve(eng, prompts[:1], 4)
    RECORD["fresh"] = {"outs": outs,
                       "dispatches": snap["plan_dispatches"]}
    RECORD["rank"] = rank


SUITES = {"reshard": reshard, "resume2": resume2, "gen": gen}


def main():
    suite, rank, world, workdir = sys.argv[1:5]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
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
