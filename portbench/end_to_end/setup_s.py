"""Process start to the window's start (host clock): imports, the graph
made on the card, the program's build of its structures, the kernels'
load (and build on a checkout's first run), one warm unit."""


def read(ctx):
    return ctx["setup_s"]
