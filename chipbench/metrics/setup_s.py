"""From the process's start to the first timed request: imports, the
card's start, the kernels built or loaded, the weights made on the card,
the cell's own shapes warmed, and the decode cell's sessions prefilled."""


def read(ctx):
    return ctx.setup_s
