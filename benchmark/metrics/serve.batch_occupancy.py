"""Share of the batches' slots that held a real request, not padding (%,
the engine's ``batch_occupancy``)."""


def read(run):
    occ = run.engine.get("occupancy")
    return None if occ is None else 100.0 * occ
