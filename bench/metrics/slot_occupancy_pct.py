"""slot_occupancy_pct: slot-steps of the window that served a request,
over all its slot-steps (server layer, BatchedServer)."""


def read(run):
    rec = run.rec
    if not rec.step_lengths:
        return None
    live = sum(len(x) for x in rec.step_lengths)
    return 100.0 * live / (rec.slots * len(rec.step_lengths))
