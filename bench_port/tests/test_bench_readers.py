"""The end-to-end arithmetic: a rate counts every request of the jobs
that went in during the window, over the seconds to the harvest of the
last of them, whatever point of a job the close falls on; the
roofline's counts follow a launch's real rows, and are read only where
the rebuilt decode steps are the ones the engines counted."""
import numpy as np

import tiny  # noqa: F401
from bench_port import counts, driver, harness, readers
from bench_port.loadgen import Spec


def window(finish=113.0):
    """Two jobs of five requests of 4 tokens, opened at 100 s, closed at
    110 s; the second job's last response at ``finish``."""
    recs = {}
    for i in range(10):
        r = driver.Record(Spec(i, 0, np.zeros(4, np.int32), 4,
                               np.zeros(784)))
        r.done = 100.0 + i if i < 9 else finish
        r.tokens = np.zeros(4, np.int32)
        recs[i] = r
    return driver.Window(100.0, 110.0, finish, recs, [], {}, {}, jobs=2)


def ctx(w):
    return readers.Context("c", {}, None, {}, 10.0, 1.0, w)


def test_rate_counts_whole_jobs_over_the_time_they_took():
    assert harness.reader("gen_tok_s")(ctx(window())) == 10 * 4 / 13.0
    # a slower last job reads slower, though the close falls mid-job
    assert harness.reader("gen_tok_s")(ctx(window(116.0))) == 10 * 4 / 16.0


def test_no_rate_where_a_job_never_finished():
    w = window()
    w.finish = None
    w.records[9].done = w.records[9].tokens = None
    assert harness.reader("gen_tok_s")(ctx(w)) is None
    assert harness.reader("mfu.batch")(ctx(w)) is None


def test_rows_per_replay():
    w = window()
    w.stats0 = {"a": {"decode_steps": 10, "tokens_generated": 50,
                      "rows_served": 10}}
    w.stats1 = {"a": {"decode_steps": 30, "tokens_generated": 150,
                      "rows_served": 20}}
    assert readers.rows_per_replay(ctx(w)) == (100 - 10) / 20


def test_wkv_roofline_counts_real_rows_not_the_bucket(monkeypatch):
    a = tiny.namespace(n_heads=2, dh=4, n_layers=3)
    ticks = [(16, 3, 0), (4, 4, 0)]
    monkeypatch.setattr(readers, "wave_ticks", lambda c: ticks)
    monkeypatch.setattr(readers, "kernel_time", lambda c, *n: (1e-3, 6))
    w = window()
    w.traced = {"window_s": 1.0, "decode_steps": 2}
    c = readers.Context("c", {}, a, {}, 10.0, 1.0, w)
    got = harness.reader("wkv_kernel_roofline.batch")(c)
    need = sum(counts.roofline_s(*counts.wkv_call(a, rows),
                                 counts.PEAKS["f32_flops"])
               for _, rows, _ in ticks)
    # six launches traced in 1 ms, each needing the mean of the two ticks
    assert got == 100.0 * need * 6 / (2 * 1e-3)
    bucket = sum(counts.roofline_s(*counts.wkv_call(a, bb),
                                   counts.PEAKS["f32_flops"])
                 for bb, _, _ in ticks)
    assert got < 100.0 * bucket * 6 / (2 * 1e-3)


def test_a_traced_tiny_run_reads_its_stretch():
    res = tiny.run(tiny.spec("moe"), seconds=2.0, trace=True)
    assert res["correct"]
    d = res["device"]
    assert 0 < d["window_s"] and 0 <= d["busy_s"] <= d["window_s"]
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    m = res["metrics"]
    assert m["rows_per_replay.batch"]["value"] > 0
    assert 0 < m["mfu.batch"]["value"] < 100


def test_no_roofline_where_the_rebuild_misses_a_counted_step(monkeypatch):
    a = tiny.namespace(n_heads=2, dh=4, n_layers=3)
    monkeypatch.setattr(readers, "wave_ticks", lambda c: [(16, 3, 0)])
    monkeypatch.setattr(readers, "kernel_time", lambda c, *n: (1e-3, 3))
    w = window()
    w.traced = {"window_s": 1.0, "decode_steps": 2}
    c = readers.Context("c", {}, a, {}, 10.0, 1.0, w)
    assert harness.reader("wkv_kernel_roofline.batch")(c) is None
