"""gubernator_tpu_torch stands alone: in a fresh interpreter where `jax` and
the JAX package cannot be imported, the port imports and answers a check()
on the CPU, and no module named jax, gubernator_tpu or gubernator_tpu.* is
ever loaded (gubernator_tpu_torch itself must pass the prefix test)."""
from __future__ import annotations

import os
import subprocess
import sys
import textwrap
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

SCRIPT = textwrap.dedent("""
    import importlib.abc
    import sys

    def blocked(name):
        top = name.split(".")[0]
        return top in ("jax", "jaxlib", "gubernator_tpu")

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if blocked(name):
                raise ImportError(f"blocked import of {name}")
            return None

    sys.meta_path.insert(0, Block())

    import gubernator_tpu_torch
    from gubernator_tpu_torch.core.config import DeviceConfig
    from gubernator_tpu_torch.core.types import RateLimitReq
    from gubernator_tpu_torch.runtime.backend import TorchBackend

    be = TorchBackend(DeviceConfig(num_slots=256, ways=8, batch_size=16,
                                   platform="cpu"))
    r = be.check([RateLimitReq(name="iso", unique_key="k", hits=1, limit=5,
                               duration=60_000)])[0]
    assert (r.error, r.remaining) == ("", 4), r
    bad = sorted(m for m in sys.modules if blocked(m))
    assert not bad, bad
    assert "gubernator_tpu_torch.runtime.backend" in sys.modules
    print("ISOLATED-OK")
""")


def test_port_imports_without_jax_or_the_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "ISOLATED-OK" in proc.stdout
