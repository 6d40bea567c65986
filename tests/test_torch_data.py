"""The port's own copy of the data pipeline against ``repro.data``: each
generator, the 784-d preprocessing, the server / client splits and the
LM token stream give the same arrays, bit for bit, for the same seed (in
one process: both packages salt the generator's seed with ``hash(name)``
the same way)."""
import numpy as np
import pytest

from _torch_threads import one_intra_op_thread  # noqa: F401
from repro import data as jdata
from repro_torch import data as tdata


def _equal(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def test_specs_are_the_papers():
    assert list(tdata.SPECS) == list(jdata.SPECS)
    for name, spec in jdata.SPECS.items():
        assert tdata.SPECS[name].__dict__ == spec.__dict__


@pytest.mark.parametrize("name", list(jdata.SPECS))
def test_generator_and_to_784(name):
    for n, seed in ((300, 0), (257, 3)):
        x, y = tdata.generate(name, n, seed)
        xr, yr = jdata.generate(name, n, seed)
        _equal(x, xr)
        _equal(y, yr)
        _equal(tdata.to_784(x), jdata.to_784(xr))


def test_preprocess_branches():
    rng = np.random.default_rng(0)
    for x in (rng.random((5, 32, 32)), rng.random((5, 28, 28)),
              rng.random((5, 561)), rng.random((5, 2000)),
              rng.random((5, 784))):
        x = x.astype(np.float32)
        _equal(tdata.to_784(x), jdata.to_784(x))
    with pytest.raises(ValueError):
        tdata.to_784(np.zeros((2, 3, 4, 5), np.float32))


def test_splits_and_benchmark():
    names = ["mnist", "reuters", "db"]
    got = tdata.load_benchmark(names, n_per_dataset=401, seed=2)
    want = jdata.load_benchmark(names, n_per_dataset=401, seed=2)
    assert list(got) == names
    for name in names:
        assert list(got[name]) == ["server", "client_a", "client_b"]
        for split in got[name]:
            for a, b in zip(got[name][split], want[name][split]):
                _equal(a, b)
        # 50/25/25, non-overlapping
        assert [len(got[name][s][0]) for s in got[name]] == [200, 100, 100]


def test_token_stream():
    for vocab, seq, batch, seed in ((512, 16, 4, 0), (65536, 33, 3, 7)):
        a = tdata.synthetic_token_stream(vocab, seq, batch, seed)
        b = jdata.synthetic_token_stream(vocab, seq, batch, seed)
        for _ in range(3):
            ga, gb = next(a), next(b)
            assert list(ga) == ["tokens", "labels"]
            for k in ga:
                _equal(ga[k], gb[k])
            assert ga["tokens"].shape == (batch, seq)
