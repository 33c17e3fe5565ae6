"""``setup_s`` (s): process start until the window opens: imports, the
kernels loaded from the program's build cache (built there by the first
run in a checkout), the cfg, the engine, and one warm-up run at the
cell's own shapes.  Host clock."""


def read(run):
    return run.setup_s
