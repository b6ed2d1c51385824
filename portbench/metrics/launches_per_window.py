"""Window-kernel launches a window (the wrappers' `.launches`)."""


def read(run):
    w = run.window.windows
    return run.window.launches / w if w else None
