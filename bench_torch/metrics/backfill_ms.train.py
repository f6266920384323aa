"""backfill_ms.train: the host condition-number backfill of a training
run, ms (``TrainResult.cond_backfill_time``), the mean over the window's
runs; nothing where the runs compute none."""


def read(run):
    times = [u["cond_backfill_s"] for u in run.units if u.get("cond_backfill_s") is not None]
    return 1e3 * sum(times) / len(times) if times else None
