"""rows_per_replay (rows, program counters): over the window's jobs, the
decoded rows a decode-graph replay carries: the engines' (tokens_generated
- rows_served) / decode_steps, read at the open and once the last job
is harvested. Rows that finished early and ride along
in their wave do not count, nor the batch's padding rows."""
from bench_port.readers import rows_per_replay


def read(ctx):
    return rows_per_replay(ctx)
