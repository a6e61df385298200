"""Median wall of the engine's decode steps (one dispatch and one fetch
for every active slot) recorded in the window: the step records of
``GenerationMetrics``, which the engine reports as ``tpot_*``."""


def read(run):
    return run.work.get("decode_step_p50_ms")
