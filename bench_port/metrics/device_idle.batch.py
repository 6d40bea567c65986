"""device_idle (%, device trace): the share of the traced stretch of the
window in which no kernel, copy or memset ran on the card."""
from bench_port.readers import device_idle_pct


def read(ctx):
    return device_idle_pct(ctx)
