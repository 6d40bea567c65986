"""attn_kernel_roofline (%, device trace and counts): the paged decode
attention kernel's share of its roofline over the traced stretch: the
least time its launches' operations and bytes (``counts.
paged_attention_call``: live K/V read once, q and o once) need on the
card, over the time the trace gives its launches. Each launch's shape
is rebuilt from the tracer's wave spans (``readers.wave_ticks``) and
the mean need a launch taken over the launches the trace holds; where
the rebuilt decode steps are not the ones the engines counted
(``readers.ticks_agree``), nothing is read."""
from bench_port import counts
from bench_port.readers import kernel_time, ticks_agree, wave_ticks


def read(ctx):
    ticks = wave_ticks(ctx)
    sec, n = kernel_time(ctx, "decode_attention_kernel", "PagedAddr")
    if not ticks_agree(ctx, ticks, n):
        return None
    page = int(ctx.cfg["fleet"]["page_size"])
    need = 0.0
    for bb, rows, live in ticks:
        f, b = counts.paged_attention_call(ctx.arch, rows, bb, live, page)
        need += counts.roofline_s(f, b, counts.PEAKS["bf16_flops"])
    return 100.0 * need * n / (len(ticks) * sec)
