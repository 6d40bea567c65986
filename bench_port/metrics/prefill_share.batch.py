"""prefill_share (%, program spans): the device time of the program's
``prefill.dispatch`` ranges (CUDA events around every eager prefill and
prefill chunk: the prompt processing) over the window's seconds, from
its open to the harvest of its last job, leaving out the stretch a
traced run profiles and every range that meets it
(``program_spans``)."""
from bench_port.program_spans import share_pct


def read(ctx):
    return share_pct(ctx, "prefill.dispatch", "device")
