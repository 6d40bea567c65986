"""The readers of the program's own spans and device ranges
(``prefill_share.batch``, ``replay_device_ms.batch``,
``host_wait_share.batch``): records clipped to the window, every record
that meets the profiled stretch left out (and the stretch's seconds
with it), nothing read where the program recorded nothing; and a traced
tiny run of each kind reports all three."""
import pytest

import tiny  # noqa: F401
from bench_port import harness, readers
from test_bench_readers import window

SHARES = {"prefill_share.batch": ("prefill.dispatch", "device"),
          "host_wait_share.batch": ("engine.fetch", "host")}


def rec(name, a, b, cat="device", **args):
    """A tracer record from ``a`` to ``b`` seconds on the tracer's
    clock."""
    return {"name": name, "cat": cat, "ph": "X", "ts": a * 1e6,
            "dur": (b - a) * 1e6, "tid": "t", "id": 1, "parent": 0,
            "args": args}


def ctx(records, traced=None, offset=0.0):
    """The window of ``test_bench_readers``: open at 100 s, the last job
    harvested at 113 s; tracer records ``offset`` seconds behind the host
    clock."""
    w = window()
    w.traced = traced
    return readers.Context("c", {}, None, {}, 10.0, 1.0, w, records,
                           offset)


@pytest.mark.parametrize("metric", sorted(SHARES))
def test_share_is_clipped_to_the_window(metric):
    name, cat = SHARES[metric]
    recs = [rec(name, 99.5, 100.5, cat), rec(name, 105.0, 106.0, cat),
            rec(name, 112.5, 113.5, cat), rec(name, 90.0, 91.0, cat),
            rec("other", 101.0, 109.0, cat)]
    got = harness.reader(metric)(ctx(recs))
    assert got == pytest.approx(100.0 * 2.0 / 13.0)
    # the same records on a tracer clock 50 s behind the host's
    moved = [dict(r, ts=r["ts"] - 50e6) for r in recs]
    assert harness.reader(metric)(ctx(moved, offset=50.0)) == \
        pytest.approx(got)
    # a record of another category is not read
    other = "host" if cat == "device" else "device"
    assert harness.reader(metric)(ctx([rec(name, 105.0, 106.0, other)])) \
        is None


@pytest.mark.parametrize("metric", sorted(SHARES))
def test_share_leaves_out_the_profiled_stretch(metric):
    name, cat = SHARES[metric]
    recs = [rec(name, 101.0, 102.0, cat), rec(name, 102.5, 103.5, cat),
            rec(name, 104.0, 105.0, cat), rec(name, 106.0, 107.0, cat)]
    traced = {"window_s": 2.0, "host_t0": 103.0, "host_t1": 105.5}
    # two records meet the stretch; 2.5 of the 13 s are profiled
    assert harness.reader(metric)(ctx(recs, traced)) == \
        pytest.approx(100.0 * 2.0 / 10.5)


@pytest.mark.parametrize("metric", sorted(SHARES) + ["replay_device_ms.batch"])
def test_nothing_read_without_the_programs_records(metric):
    assert harness.reader(metric)(ctx(None)) is None
    assert harness.reader(metric)(ctx([])) is None
    assert harness.reader(metric)(ctx([rec("wave.prefill", 101, 102)])) \
        is None
    w = ctx([rec("decode.replay", 101.0, 101.01),
             rec("engine.fetch", 101.0, 102.0, "host"),
             rec("prefill.dispatch", 101.0, 102.0)])
    w.window.finish = None               # the last job never came back
    assert harness.reader(metric)(w) is None


def test_replay_mean_takes_steady_replays_inside_the_window():
    recs = [rec("decode.replay", 101.0, 101.008),
            rec("decode.replay", 102.0, 102.010),
            rec("decode.replay", 102.5, 102.600, eager=True),
            rec("decode.replay", 102.7, 102.900, captured=True),
            rec("decode.replay", 99.999, 100.007),       # meets the open
            rec("decode.replay", 104.0, 104.050),        # profiled
            rec("verify.replay", 106.0, 106.5),
            rec("decode.replay", 107.0, 107.012, cat="enqueue")]
    traced = {"window_s": 1.0, "host_t0": 103.9, "host_t1": 104.5}
    got = harness.reader("replay_device_ms.batch")(ctx(recs, traced))
    assert got == pytest.approx((8.0 + 10.0) / 2)


@pytest.mark.parametrize("kind", ["moe", "rwkv"])
def test_a_traced_tiny_run_reports_the_program_spans(kind):
    res = tiny.run(tiny.spec(kind), seconds=2.0, trace=True)
    assert res["correct"]
    m = res["metrics"]
    assert 0 < m["prefill_share.batch"]["value"] < 100
    assert m["replay_device_ms.batch"]["value"] > 0
    assert 0 < m["host_wait_share.batch"]["value"] < 100
    assert m["replay_device_ms.batch"]["unit"] == "ms"
