"""cg_iters.posterior: the alpha solve's CG iterations, as the program
returns them, the mean over the window's posteriors."""


def read(run):
    its = [u["cg_iterations"] for u in run.units]
    return sum(its) / len(its) if its else None
