"""mfu.posterior: the whole posterior's share of the card's FP32 peak, %:
the least time of its counted work (counts.posterior_least_s, from the
configuration's sizes) over the traced posterior's time. The work depends
on the CG's iterations: the alpha solve's as the program returns them, and
all matvecs as the Gram tiles in the trace count them (every matvec needs
each of the N^2 Gram entries once, a tile at a time, each tile one product
over the 3n features). Nothing where the trace holds no Gram tile."""


def read(run):
    if run.trace is None or not run.trace.kernels or run.traced_work != 1:
        return None
    c = run.counts
    rows, inner, width = c.gram_tile(run.cfg)
    tiles = run.trace.products(rows, inner, width)
    alpha = run.units[0]["cg_iterations"]
    matvecs, rest = divmod(tiles, rows // width)
    if rest or matvecs < alpha:
        return None
    return 100.0 * c.posterior_least_s(run.cfg, matvecs, alpha) / run.trace.window_s
