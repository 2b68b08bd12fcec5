"""The port's copies of the sequential oracle (core/pymodel.py) and the
raceguard plugin (testing/raceguard.py) against the JAX package's.

The same seeded stream of token, leaky, RESET_REMAINING and Gregorian
checks under the same frozen clock gives equal answers and equal cached
items in both oracles; both lock-order detectors flag the same scripted
inversion with the same report; and the port's plugin, loaded with
`-p gubernator_tpu_torch.testing.raceguard` into a pytest run that does not
read tests/conftest.py, fails a test that inverts two asyncio locks."""
from __future__ import annotations

import asyncio
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from gubernator_tpu.core import clock as jclock
from gubernator_tpu.core import types as jtypes
from gubernator_tpu.core.pymodel import PyRateLimiter as JPyRateLimiter
from gubernator_tpu.testing import raceguard as jraceguard
from gubernator_tpu_torch.core import clock as tclock
from gubernator_tpu_torch.core import types as ttypes
from gubernator_tpu_torch.core.pymodel import PyRateLimiter
from gubernator_tpu_torch.testing import raceguard

REPO = Path(__file__).resolve().parents[1]
T0_NS = 1_700_000_000_000 * 1_000_000


def request_stream(seed: int, n: int):
    """Seeded request fields: 2:1 token:leaky over 12 keys, hits 0-5,
    limits 3-20, some bursts, ~10% RESET_REMAINING, ~10% Gregorian
    (durations 0-5, 5 being an invalid interval), and a clock step after
    each request."""
    rng = np.random.default_rng(seed)
    for _ in range(n):
        greg = rng.random() < 0.1
        behavior = 0
        if rng.random() < 0.1:
            behavior |= int(ttypes.Behavior.RESET_REMAINING)
        if greg:
            behavior |= int(ttypes.Behavior.DURATION_IS_GREGORIAN)
        yield dict(
            name="oracle", unique_key=f"k{rng.integers(12)}",
            hits=int(rng.integers(0, 6)), limit=int(rng.integers(3, 21)),
            duration=int(rng.integers(0, 6)) if greg
            else int(rng.choice([50, 1000, 60_000])),
            algorithm=int(rng.random() < 1 / 3),
            behavior=behavior,
            burst=int(rng.choice([0, 0, 25])),
        ), int(rng.choice([0, 1, 7, 40, 900]))


def answer(model, req):
    """The oracle's answer, or the error it raises (a Gregorian weeks
    duration is refused by raising, as the packer's validation does)."""
    try:
        return dataclasses.astuple(model.get_rate_limit(req))
    except Exception as e:  # noqa: BLE001 — compared across packages
        return ("raised", type(e).__name__, str(e))


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_oracle_answers_equal_the_jax_oracle(seed):
    jc, tc = jclock.Clock(), tclock.Clock()
    jc.freeze(T0_NS)
    tc.freeze(T0_NS)
    jm, tm = JPyRateLimiter(jc), PyRateLimiter(tc)
    kinds = set()
    for fields, step_ms in request_stream(seed, 600):
        jr = answer(jm, jtypes.RateLimitReq(**fields))
        tr = answer(tm, ttypes.RateLimitReq(**fields))
        assert tr == jr, fields
        kinds.add((fields["algorithm"], fields["behavior"], tr[0],
                   tr[0] == "raised" or bool(tr[4])))
        jc.advance(step_ms)
        tc.advance(step_ms)
    assert sorted(tm.cache) == sorted(jm.cache)
    for k in jm.cache:
        assert (dataclasses.astuple(tm.cache[k])
                == dataclasses.astuple(jm.cache[k])), k
    # The stream reached both algorithms, both flags, over-limit answers
    # and Gregorian refusals.
    assert {a for a, *_ in kinds} == {0, 1}
    assert any(b & 8 for _, b, *_ in kinds)
    assert any(s == ttypes.Status.OVER_LIMIT for _, _, s, _ in kinds)
    assert any(s == "raised" for _, _, s, _ in kinds)
    assert any(e for *_, e in kinds)


def scripted_inversion(module):
    """Arm a private guard of `module` (the session's guard disarmed around
    it) and run two tasks' worth of A->B then B->A nesting."""
    session = jraceguard.active_guard()
    if session is not None:
        session.disarm()
    g = module.RaceGuard(stall_ms=1e9)
    g.arm()
    try:
        async def scenario():
            a, b = asyncio.Lock(), asyncio.Lock()
            async with a:
                async with b:
                    pass
            async with b:
                async with a:  # the inversion
                    pass

        asyncio.run(scenario())
    finally:
        g.disarm()
        if session is not None:
            session.arm()
    return g


def test_raceguard_copy_flags_the_same_inversion_as_the_jax_one():
    jg = scripted_inversion(jraceguard)
    tg = scripted_inversion(raceguard)
    assert len(tg.graph.inversions) == len(jg.graph.inversions) == 1
    assert tg.graph.inversions == jg.graph.inversions
    assert "lock-order inversion" in tg.graph.inversions[0]
    # The pure graph agrees on a transitive cycle too.
    for mod in (jraceguard, raceguard):
        g = mod.LockOrderGraph()
        assert not g.record(1, 2) and not g.record(2, 3)
        assert g.record(3, 1) is True


def test_raceguard_plugin_fails_an_inverting_test_without_conftest(
        tmp_path):
    (tmp_path / "test_inv.py").write_text(
        "import asyncio\n"
        "def test_inverts():\n"
        "    async def go():\n"
        "        a, b = asyncio.Lock(), asyncio.Lock()\n"
        "        async with a:\n"
        "            async with b:\n"
        "                pass\n"
        "        async with b:\n"
        "            async with a:\n"
        "                pass\n"
        "    asyncio.run(go())\n"
        "def test_consistent():\n"
        "    async def go():\n"
        "        a, b = asyncio.Lock(), asyncio.Lock()\n"
        "        for _ in range(2):\n"
        "            async with a:\n"
        "                async with b:\n"
        "                    pass\n"
        "    asyncio.run(go())\n"
    )
    p = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "--noconftest",
         "-p", "no:cacheprovider", "-p", "no:xdist", "-p", "no:randomly",
         "-p", "gubernator_tpu_torch.testing.raceguard",
         str(tmp_path / "test_inv.py")],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    out = p.stdout + p.stderr
    assert p.returncode == 1, out
    assert "1 failed, 1 passed" in out, out
    assert "raceguard detected lock-order inversion" in out, out
    assert "1 inversion(s)" in out, out
