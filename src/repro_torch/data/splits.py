"""Paper's experimental protocol: 50/25/25% server / Client A / Client B
non-overlapping splits (Table 1), plus the LM-side token pipeline used by
the training substrate."""
from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np

from . import preprocess, synthetic


def server_client_split(x: np.ndarray, y: np.ndarray, seed: int = 0):
    """Returns dict(server=(x, y), client_a=..., client_b=...)."""
    n = len(x)
    perm = np.random.default_rng(seed).permutation(n)
    n_server = n // 2
    n_a = n // 4
    si = perm[:n_server]
    ai = perm[n_server:n_server + n_a]
    bi = perm[n_server + n_a:n_server + 2 * n_a]
    return {
        "server": (x[si], y[si]),
        "client_a": (x[ai], y[ai]),
        "client_b": (x[bi], y[bi]),
    }


def load_benchmark(names=None, n_per_dataset=None, seed: int = 0):
    """Generate + preprocess + split the full 6-dataset benchmark.

    Returns {name: {split: (x784, y)}} with x784 (N, 784) float32.
    ``n_per_dataset`` caps sample counts for fast tests.
    """
    names = names or list(synthetic.SPECS)
    out = {}
    for name in names:
        x, y = synthetic.generate(name, n_per_dataset, seed)
        x784 = preprocess.to_784(x)
        out[name] = server_client_split(x784, y, seed)
    return out


# ---------------------------------------------------------------------------
# LM token pipeline (training substrate)
# ---------------------------------------------------------------------------


def synthetic_token_stream(vocab_size: int, seq_len: int, batch: int,
                           seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Infinite stream of (tokens, labels) batches with Zipfian marginals
    and local n-gram structure (so losses actually decrease)."""
    rng = np.random.default_rng(seed)
    zipf = 1.0 / np.arange(1, vocab_size + 1) ** 1.05
    zipf = zipf / zipf.sum()
    trans_shift = rng.integers(1, vocab_size, size=64)
    while True:
        base = rng.choice(vocab_size, size=(batch, seq_len + 1), p=zipf)
        # inject deterministic bigram structure on half the positions
        mask = rng.random((batch, seq_len)) < 0.5
        nxt = (base[:, :-1] + trans_shift[base[:, :-1] % 64]) % vocab_size
        base[:, 1:][mask] = nxt[mask]
        yield {"tokens": base[:, :-1].astype(np.int32),
               "labels": base[:, 1:].astype(np.int32)}
