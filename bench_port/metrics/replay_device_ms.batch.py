"""replay_device_ms (ms, program spans): the mean device time of the
program's ``decode.replay`` ranges (CUDA events from a decode step's
first copy in to the clone of its tokens, the graph replay between)
that lie wholly in the window and off the stretch a traced run
profiles; a bucket's eager and capture steps (``eager``, ``captured``)
are left out (``program_spans``)."""
from bench_port.program_spans import window_records


def read(ctx):
    w = ctx.window
    ms = [r["dur"] / 1e3 for a, b, r in window_records(ctx, "decode.replay",
                                                       "device")
          if w.start <= a and b <= w.finish
          and not r["args"].get("eager") and not r["args"].get("captured")]
    return sum(ms) / len(ms) if ms else None
