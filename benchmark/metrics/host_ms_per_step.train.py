"""Milliseconds of the benchmark's clock around each ``train_batch``
call of the window (the host's enqueue of a step), over the window's
steps."""


def read(run):
    host = run.work.get("host_s")
    if not host:
        return None
    return 1e3 * sum(host) / len(host)
