"""solves_per_s: solves that reached the tolerance, over the window's
seconds on the host clock."""


def read(ctx):
    if ctx.driver.kind != "solve" or ctx.window.seconds <= 0:
        return None
    return ctx.window.completed(ok_only=True) / ctx.window.seconds
