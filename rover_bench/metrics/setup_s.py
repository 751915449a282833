"""Set-up: the process's start to the first moment of the window (imports,
the card's context, kernel builds or loads, the world, warm-up and graph
captures), on the host's clock."""


def read(run):
    return run.setup_s
