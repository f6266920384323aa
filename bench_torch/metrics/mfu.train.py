"""mfu.train: the whole iteration's share of the card's peaks, %: the
least time of an iteration's counted work (counts.train_iteration_least_s:
the features, the Grams' products, the float64 factorizations, solves and
contractions, the backfill's share) over iter_ms, the time an iteration
takes in the units after the traced one (the profiler slows the traced
unit). Nothing where the window ended in the traced unit."""


def read(run):
    if run.trace is None or not run.untraced_work:
        return None
    iter_s = run.untraced_s / run.untraced_work
    return 100.0 * run.counts.train_iteration_least_s(run.cfg) / iter_s
