"""mfu (%, host clock and counts): the useful model operations of every
request of the window's jobs (``counts.request_flops``: 2 x the active
parameters a real prompt token or decode step, plus attention over its
context), over the seconds ``gen_tok_s`` divides by, times the card's
bf16 peak (989 TFLOP/s, ``counts/peaks.json``)."""
from bench_port import counts
from bench_port.readers import span_s, useful_flops


def read(ctx):
    span = span_s(ctx)
    f = useful_flops(ctx) if span else 0.0
    if not f:
        return None
    return 100.0 * f / (span * counts.PEAKS["bf16_flops"])
