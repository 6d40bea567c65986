"""setup_s (s, host clock): from the process's start to the window's
opening: imports, weights drawn on the device, the AE bank trained, the
engines built, the kernels built or loaded, every decode graph captured
and the mix's warm-up served."""


def read(ctx):
    return ctx.setup_s
