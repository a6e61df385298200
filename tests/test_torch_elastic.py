"""The port's elastic supervisor (``flexflow_tpu_torch/parallel/
elastic.py``) driving the port's own workers (``tests/_torch_elastic_worker.py``,
gloo CPU ranks that take torchrun's variables from the supervisor) under
``FF_FAULT``: a crash, a hang found by heartbeats, a corrupt newest
checkpoint and a spawn fault each recover, and every recovered final
loss is bit-equal to the uninterrupted run's; exhausted restarts and
fail-fast are reported; degrade-and-continue halves the world; and
``shrink_at_step`` goes through the supervisor: the four ranks save the
step's checkpoint and exit with ``RESIZE_EXIT_CODE``, two ranks resume
from it (reshard on resume), bit-equal to a fixed two-rank run resumed
from the same checkpoint.  The cases of ``tests/test_elastic.py`` and
``tests/test_faults.py`` (whose pins on the fire points themselves are
held against the JAX package in ``test_torch_faults_training.py``).
"""

import json
import os
import shutil
import sys

import pytest

from flexflow_tpu_torch.fflogger import capture_events
from flexflow_tpu_torch.parallel.elastic import (RESIZE_EXIT_CODE,
                                                 latest_checkpoint,
                                                 run_elastic)

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
WORKER = os.path.join(HERE, "_torch_elastic_worker.py")
STEPS, EVERY = 6, 2


def _run(workdir, nprocs, fault="", max_restarts=2, **kw):
    """One supervised run of the worker in ``workdir`` (its checkpoints
    in ``workdir/ckpt``): the report and rank 0's final record."""
    os.makedirs(os.path.join(workdir, "ckpt"), exist_ok=True)
    env = {"FF_FAULT": fault, "OMP_NUM_THREADS": "1", "PYTHONPATH": REPO}
    env.pop("XLA_FLAGS", None)

    def argv(attempt, port, rank):
        return [sys.executable, WORKER, str(workdir), "cpu", str(STEPS),
                str(EVERY)]

    kw.setdefault("attempt_timeout_s", 180)
    report = run_elastic(argv, nprocs, max_restarts=max_restarts,
                         poll_interval_s=0.1, env=env, backoff_base_s=0.01,
                         checkpoint_dir=os.path.join(workdir, "ckpt"), **kw)
    final = None
    path = os.path.join(workdir, "final.json")
    if os.path.exists(path):
        with open(path) as f:
            final = json.load(f)
    return report, final


def _resumed(workdir, rank, attempt):
    with open(os.path.join(workdir, f"resume_r{rank}_a{attempt}.txt")) as f:
        return f.read()


@pytest.fixture(scope="module")
def clean(tmp_path_factory):
    """The uninterrupted two-rank run every recovery is held to."""
    wd = str(tmp_path_factory.mktemp("clean"))
    report, final = _run(wd, 2)
    assert report.success and report.restarts == 0, report.attempts
    assert len(final["losses"]) == STEPS
    return final


def test_crash_restart_resume_bit_equal(tmp_path, clean):
    """kill_at_step:3 on rank 1: the attempt is a crash with the kill's
    exit code, the restart resumes from the step-2 checkpoint and ends
    on the uninterrupted run's loss, bit for bit."""
    report, final = _run(tmp_path, 2, "kill_at_step:3,rank=1")
    assert report.success and report.restarts == 1
    first = report.attempts[0]
    assert first.cause == "crash" and first.returncodes[1] == 17
    assert _resumed(tmp_path, 0, 1) == "elastic_step2.npz"
    assert final["loss"] == clean["loss"]
    assert final["losses"] == clean["losses"][2:]


def test_hang_detected_by_heartbeats(tmp_path, clean):
    """hang_at_step:3 on rank 0 stops its heartbeat: the monitor kills
    the attempt as hung long before the attempt timeout, and the
    restart finishes bit-equal."""
    report, final = _run(tmp_path, 2, "hang_at_step:3,rank=0",
                         hang_timeout_s=6.0, attempt_timeout_s=120)
    assert report.success
    assert report.attempts[0].cause == "hung"
    assert report.attempts[0].elapsed_s < 60
    assert report.attempts[0].rank_steps.get(1, 0) >= 2
    assert final["loss"] == clean["loss"]


def test_corrupt_newest_checkpoint_falls_back(tmp_path, clean):
    """corrupt_ckpt:4 then kill_at_step:5: the restart skips the
    truncated step-4 file (a checkpoint_skipped event on the worker),
    resumes from step 2 and finishes bit-equal."""
    report, final = _run(tmp_path, 2, "corrupt_ckpt:4;kill_at_step:5,rank=1")
    assert report.success and report.restarts == 1
    assert _resumed(tmp_path, 0, 1) == "elastic_step2.npz"
    assert "checkpoint_skipped" in final["events"]
    assert final["loss"] == clean["loss"]
    assert latest_checkpoint(os.path.join(tmp_path, "ckpt")).endswith(
        "elastic_step4.npz")


def test_spawn_fault_consumes_a_restart(tmp_path, clean):
    report, final = _run(tmp_path, 2, "spawn_fail_attempt:0")
    assert report.success and report.restarts == 1
    assert report.attempts[0].cause == "spawn"
    assert "spawn_fail_attempt" in report.attempts[0].spawn_error
    assert final["loss"] == clean["loss"]


def test_exhausted_restarts_are_reported():
    def argv(attempt, port, rank):
        return [sys.executable, "-c", "import sys; sys.exit(1)"]

    report = run_elastic(argv, num_processes=2, max_restarts=2,
                         attempt_timeout_s=30, poll_interval_s=0.05,
                         backoff_base_s=0.01, fail_fast_window_s=0.0)
    assert not report.success and not report.fail_fast
    assert [a.cause for a in report.attempts] == ["crash"] * 3
    assert report.restarts == 2
    assert [a.backoff_s > 0 for a in report.attempts] == [True, True, False]


def test_instant_all_rank_crash_fails_fast():
    def argv(attempt, port, rank):
        return [sys.executable, "-c", "import sys; sys.exit(2)"]

    report = run_elastic(argv, num_processes=2, max_restarts=3,
                         attempt_timeout_s=30, poll_interval_s=0.05,
                         backoff_base_s=0.01, fail_fast_window_s=10.0)
    assert report.fail_fast and len(report.attempts) == 1


def test_workers_get_torchrun_variables():
    """Each rank sees torchrun's variables and the supervisor's own."""
    code = ("import os, sys; e = os.environ; sys.exit(0 if ("
            "e['RANK'] == sys.argv[1] and e['WORLD_SIZE'] == '3' and "
            "e['MASTER_ADDR'] == '127.0.0.1' and e['MASTER_PORT'] == "
            "sys.argv[2] and e['FF_ELASTIC_NPROCS'] == '3' and "
            "e['FF_ELASTIC_ATTEMPT'] == '0' and os.path.isdir("
            "e['FF_HEARTBEAT_DIR'])) else 5)")

    def argv(attempt, port, rank):
        return [sys.executable, "-c", code, str(rank), str(port)]

    report = run_elastic(argv, num_processes=3, max_restarts=0,
                         attempt_timeout_s=30, poll_interval_s=0.05)
    assert report.success, report.attempts[0].returncodes


def test_degrade_halves_the_world():
    """After degrade_after topology-class failures the world halves
    (never below min_processes), each attempt records its size and each
    shrink is a degrade event."""
    def argv(attempt, port, rank, nprocs):
        return [sys.executable, "-c",
                "import sys; sys.exit(1 if int(sys.argv[1]) > 1 else 0)",
                str(nprocs)]

    with capture_events("elastic") as events:
        report = run_elastic(argv, num_processes=4, max_restarts=3,
                             attempt_timeout_s=30, poll_interval_s=0.05,
                             backoff_base_s=0.01, fail_fast_window_s=0.0,
                             min_processes=1, degrade_after=1)
    assert report.success
    assert [a.num_processes for a in report.attempts] == [4, 2, 1]
    assert [(e["from_processes"], e["to_processes"]) for e in events
            if e["event"] == "degrade"] == [(4, 2), (2, 1)]


def test_shrink_at_step_goes_through_the_supervisor(tmp_path):
    """shrink_at_step:4 on four ranks: a planned resize (every rank
    exits RESIZE_EXIT_CODE after the step-4 checkpoint) relaunches two
    ranks without consuming a restart; they reshard on resume and end
    bit-equal to a fixed two-rank run resumed from the same file."""
    with capture_events("elastic") as events:
        report, final = _run(tmp_path, 4, "shrink_at_step:4",
                             max_restarts=0)
    assert report.success and report.restarts == 0
    first = report.attempts[0]
    assert first.cause == "resize"
    assert first.returncodes == [RESIZE_EXIT_CODE] * 4
    assert first.resize == {"processes": 2, "step": 4}
    assert [a.num_processes for a in report.attempts] == [4, 2]
    assert [(e["old_devices"], e["new_devices"], e["step"])
            for e in events if e["event"] == "reshard"] == [(4, 2, 4)]
    assert final["world"] == 2 and "reshard_on_resume" in final["events"]
    assert _resumed(tmp_path, 0, 1) == "elastic_step4.npz"
    # the fixed two-rank reference from a copy of the same checkpoint
    ref = os.path.join(tmp_path, "ref")
    os.makedirs(os.path.join(ref, "ckpt"))
    shutil.copy(os.path.join(tmp_path, "ckpt", "elastic_step4.npz"),
                os.path.join(ref, "ckpt"))
    ref_report, ref_final = _run(ref, 2)
    assert ref_report.success
    assert final["losses"] == ref_final["losses"]
    assert final["loss"] == ref_final["loss"]
