"""setup.warm_s: seconds from the first import of the port to the end of
the first request (its libraries loaded, or built at a checkout's first
run, and first launched)."""


def read(ctx):
    return ctx.setup["warm_s"]
