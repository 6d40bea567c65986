"""The port's deterministic schedule fuzzer (rules S001-S002, the
``Interleaver`` and its shims in ``repro_torch.analysis.sanitizer``)
over the port's ``ExpertHub``: the counterparts of
``tests/test_sanitizer.py``'s determinism, staging-failure and
thread-hygiene cases.

``fuzz_torch_hub`` runs the reference ``fuzz_hub``'s seeded workload
(acquire / pin / unpin / note_hit / want / service / check from the
managed main thread while the hub's staging worker interleaves, line by
line in ``serve/hub.py``), a drain, and the same conservation checks,
over a torch stub model whose hub builds in milliseconds.

Armed with a faulthandler hard timeout, as the reference suite is: a
real deadlock dumps every thread's stack instead of hanging the run.
"""
import faulthandler
import threading

import pytest

from _torch_threads import one_intra_op_thread  # noqa: F401
from repro_torch.analysis import sanitizer as S

SUITE_TIMEOUT = 240.0


@pytest.fixture(autouse=True, scope="module")
def hard_timeout():
    on_main = threading.current_thread() is threading.main_thread()
    if on_main:
        faulthandler.dump_traceback_later(SUITE_TIMEOUT, exit=True)
    yield
    if on_main:
        faulthandler.cancel_dump_traceback_later()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_replay_is_byte_deterministic(seed):
    r1 = S.fuzz_torch_hub(seed, device="cpu")
    r2 = S.fuzz_torch_hub(seed, device="cpu")
    assert r1.trace == r2.trace, S._diverge(r1.trace, r2.trace)
    assert r1.failures == [] and r2.failures == []
    assert r1.errors == [] and r2.errors == []
    # the workload really ran the lifecycle, worker lines included
    assert r1.stats["loads"] >= 1
    assert any(t.startswith("hub-stage|") for t in r1.trace)


def test_different_seeds_take_different_schedules():
    assert S.fuzz_torch_hub(0, device="cpu").trace != \
        S.fuzz_torch_hub(1, device="cpu").trace


def test_staging_failure_path_recovers():
    """The missing expert's load fails mid-fuzz: the worker's cold reset
    happens under the hub lock, the failure re-raises on the scheduler
    side, every conservation check still holds after, and the failure
    path replays deterministically."""
    r = S.fuzz_torch_hub(S.FAIL_SEED, fail_expert=True, device="cpu")
    assert r.stats["stage_failures"] >= 1, \
        "workload never wanted the broken expert: dead seed"
    assert r.failures == []
    assert r.errors and set(r.errors) == {"FileNotFoundError"}
    assert r.trace == S.fuzz_torch_hub(S.FAIL_SEED, fail_expert=True,
                                       device="cpu").trace


def test_fuzz_leaves_no_threads_behind():
    before = {t.ident for t in threading.enumerate()}
    S.fuzz_torch_hub(3, device="cpu")
    leftover = [t for t in threading.enumerate()
                if t.ident not in before and t.is_alive()]
    assert leftover == [], leftover
