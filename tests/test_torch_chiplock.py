"""The port's chip lock (``quip_for_all_tpu_torch/utils/chiplock.py``), the
four cases of ``tests/test_chiplock.py``: two cooperating processes never
hold the lock together, a waiter times out, a holder that dies releases
it, and a CPU caller does not take it (the port tests the caller's device
where the JAX package tests ``JAX_PLATFORMS``). The holder loads the
module by its file, which imports only the standard library."""
import os
import subprocess
import sys
import time

import pytest

from quip_for_all_tpu_torch.utils.chiplock import ChipLockTimeout, chip_lock

pytestmark = pytest.mark.fast

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULE = os.path.join(ROOT, "quip_for_all_tpu_torch", "utils", "chiplock.py")

HOLDER = r"""
import importlib.util, time
spec = importlib.util.spec_from_file_location("chiplock", {module!r})
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
with mod.chip_lock(path={path!r}, device="cuda"):
    print("HELD", flush=True)
    time.sleep({hold})
"""


def _spawn(path, hold):
    p = subprocess.Popen(
        [sys.executable, "-c",
         HOLDER.format(module=MODULE, path=path, hold=hold)],
        stdout=subprocess.PIPE, text=True)
    assert p.stdout.readline().strip() == "HELD"
    return p


@pytest.fixture
def lockfile(tmp_path):
    return str(tmp_path / "chip.lock")


def test_mutual_exclusion_and_queueing(lockfile):
    p = _spawn(lockfile, hold=3.0)
    t0 = time.time()
    with chip_lock(timeout_s=30.0, poll_s=0.2, path=lockfile, device="cuda"):
        waited = time.time() - t0
    assert waited >= 1.0, "acquired while the holder was alive"
    p.wait(timeout=10)


def test_timeout_raises(lockfile):
    p = _spawn(lockfile, hold=8.0)
    with pytest.raises(ChipLockTimeout):
        with chip_lock(timeout_s=0.6, poll_s=0.2, path=lockfile,
                       device="cuda"):
            pass
    p.kill()
    p.wait(timeout=10)


def test_crashed_holder_releases(lockfile):
    p = _spawn(lockfile, hold=60.0)
    p.kill()
    p.wait(timeout=10)
    t0 = time.time()
    with chip_lock(timeout_s=10.0, poll_s=0.2, path=lockfile, device="cuda"):
        pass
    assert time.time() - t0 < 5.0, "the lock outlived its holder"


def test_cpu_device_bypasses(lockfile):
    p = _spawn(lockfile, hold=5.0)
    t0 = time.time()
    with chip_lock(timeout_s=30.0, path=lockfile, device="cpu") as fd:
        assert fd is None
    assert time.time() - t0 < 2.0
    p.kill()
    p.wait(timeout=10)
