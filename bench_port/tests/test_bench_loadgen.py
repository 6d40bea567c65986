"""The traffic generator: deterministic from the seed, the same sizes for
every seed, lengths and experts as the mix states."""
import json

import numpy as np
import pytest

import tiny  # noqa: F401  (paths)
from bench_port import loadgen

NAMES = ["stl10", "har", "reuters", "nlos"]


def mix(name):
    return json.loads((tiny.ROOT / "bench_port" / "traffic" / f"{name}.json")
                      .read_text())


def key(specs):
    return sorted((len(s.prompt), s.max_new, s.expert) for s in specs)


def test_same_seed_same_requests_and_every_seed_the_same_sizes():
    m = mix("batch-job")
    a = loadgen.Traffic(m, NAMES, 50304, 2**31 + 5).job(1)
    b = loadgen.Traffic(m, NAMES, 50304, 2**31 + 5).job(1)
    c = loadgen.Traffic(m, NAMES, 50304, 7).job(1)
    assert len(a) == m["job_requests"]
    for x, y in zip(a, b):
        assert np.array_equal(x.prompt, y.prompt) and x.max_new == y.max_new
        assert np.array_equal(x.features, y.features) and x.expert == y.expert
    assert key(a) == key(c)
    assert [len(s.prompt) for s in a] != [len(s.prompt) for s in c]
    assert not np.array_equal(a[0].features, c[0].features)
    assert all((0 <= s.prompt).all() and (s.prompt < 50304).all() for s in a)


def test_lengths_follow_the_mix():
    m = mix("batch-job")
    t = loadgen.shapes(m, 2000, 4)
    p, n = t[:, 0], t[:, 1]
    assert p.min() == 16 and p.max() == 448 and abs(np.median(p) - 96) <= 1
    assert n.min() == 16 and n.max() == 64 and abs(np.median(n) - 32) <= 1
    # a lognormal's quartiles sit at median * exp(+-0.674 sigma)
    q1, q3 = np.percentile(p, [25, 75])
    assert abs(q1 - 96 * np.exp(-0.674 * 0.6)) <= 2
    assert abs(q3 - 96 * np.exp(0.674 * 0.6)) <= 2
    assert np.bincount(t[:, 2]).tolist() == [500] * 4


def test_expert_table_is_uniform():
    assert np.bincount(loadgen.expert_table(10, 4)).tolist() == [3, 3, 2, 2]
    assert np.bincount(loadgen.expert_table(128, 4)).tolist() == [32] * 4


def test_a_key_the_generator_does_not_read_is_refused():
    m = dict(mix("batch-job"))
    m["arrivals"] = {"process": "poisson", "rate_per_s": 5.0}
    with pytest.raises(ValueError, match="arrivals"):
        loadgen.Traffic(m, NAMES, 512, 1)
