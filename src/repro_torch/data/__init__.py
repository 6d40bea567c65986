"""The paper's benchmark data, generated (the port's own numpy copy of
the reference's ``repro.data``): six synthetic dataset analogues at their
Table 1 counts, the 784-d preprocessing, the 50/25/25 server / client
splits, and the LM token stream of the training substrate."""
from .preprocess import adaptive_avg_pool_1d, resize_image, to_784
from .splits import load_benchmark, server_client_split, synthetic_token_stream
from .synthetic import SPECS, generate

__all__ = ["adaptive_avg_pool_1d", "resize_image", "to_784",
           "load_benchmark", "server_client_split", "synthetic_token_stream",
           "SPECS", "generate"]
