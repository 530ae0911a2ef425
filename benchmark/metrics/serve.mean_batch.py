"""Requests completed per device batch in the window (the engine's
``completed / batches``)."""


def read(run):
    return run.engine.get("mean_batch")
