"""wkv_kernel_roofline (%, device trace and counts): the ``wkv_step``
kernel's share of its roofline over the traced stretch: the least time
its launches' bytes and operations (``counts.wkv_call``: each real
row's f32 state read and written once, its r/k/v/logw read and o
written, u once; padding rows need nothing) need, over the time the
trace gives its launches (f32 peak for the operations). Each launch's
real rows are rebuilt from the tracer's wave spans and the mean need
a launch taken over the launches the trace holds; where the rebuilt
decode steps are not the ones the engines counted
(``readers.ticks_agree``), nothing is read."""
from bench_port import counts
from bench_port.readers import kernel_time, ticks_agree, wave_ticks


def read(ctx):
    ticks = wave_ticks(ctx)
    sec, n = kernel_time(ctx, "wkv_step_kernel")
    if not ticks_agree(ctx, ticks, n):
        return None
    need = 0.0
    for _bb, rows, _live in ticks:
        f, b = counts.wkv_call(ctx.arch, rows)
        need += counts.roofline_s(f, b, counts.PEAKS["f32_flops"])
    return 100.0 * need * n / (len(ticks) * sec)
