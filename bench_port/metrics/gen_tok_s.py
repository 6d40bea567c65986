"""gen_tok_s (tokens/s, host clock): the generated tokens of every request
of the jobs that went in during the window, over the seconds from the
window's open to the harvest of the last of them. Whole jobs: all the
work that went in and all the time it took, so a change of speed shows
whatever point of a job the close falls on."""
from bench_port.readers import served, span_s


def read(ctx):
    span = span_s(ctx)
    if not span:
        return None
    return sum(len(r.tokens) for r in served(ctx)) / span
