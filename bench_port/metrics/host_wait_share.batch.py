"""host_wait_share (%, program spans): the time the host waits on the
device, the program's ``engine.fetch`` spans (the harvest's wait for
its token planes), over the window's seconds from its open to the
harvest of its last job, leaving out the stretch a traced run profiles
and every span that meets it (``program_spans``). High: the card sets
the pace; low: the host's Python does."""
from bench_port.program_spans import share_pct


def read(ctx):
    return share_pct(ctx, "engine.fetch", "host")
