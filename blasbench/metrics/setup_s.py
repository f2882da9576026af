"""setup_s: seconds from process start to the first timed request (import,
CUDA context, the libraries' load or first build, the inputs, warm-up)."""


def read(ctx):
    return ctx.setup["setup_s"]
