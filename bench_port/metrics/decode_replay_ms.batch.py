"""decode_replay_ms (ms, device trace): device time a decode-graph replay
takes, over the traced stretch: the kernels whose CUPTI correlation is a
``cudaGraphLaunch``'s, summed, over the number of launches."""
from bench_port.readers import traced


def read(ctx):
    t = traced(ctx)
    if t is None or not t["graph_launches"] or not t["graph_kernels"]:
        return None
    return 1e3 * t["graph_kernel_s"] / t["graph_launches"]
