"""One card, one claimant: an advisory lock that serializes the processes
of this repository on a card — counterpart of
``quip_for_all_tpu/utils/chiplock.py``.

``chip_lock()`` takes an exclusive ``flock`` on a well-known file. A
cooperating process queues behind the holder instead of sharing the card
with it (a measurement beside another job's kernels reads that job's time
too); a holder that dies releases the lock with its file descriptor, so
no stale lock file needs cleaning. The sanitize CLI
(``tools/sanitize.py``) and the quality matrix's subprocesses
(``tools/quality_matrix.py``) take it.

    with chip_lock(timeout_s=1800):
        ...  # work on the card

The lock is a no-op when the caller's device is the CPU (the JAX package
tests ``JAX_PLATFORMS`` instead), so CPU runs never queue behind a card
user. The path is an argument, by default under the temporary directory
(``/tmp`` unless ``TMPDIR`` says otherwise); the port reads no ``QFA_*``
variable, so there is no ``QFA_CHIP_LOCK`` override. Imports nothing
but the standard library.
"""
from __future__ import annotations

import contextlib
import errno
import fcntl
import os
import tempfile
import time


def default_lock_path() -> str:
    return os.path.join(tempfile.gettempdir(), "qfa_torch_chip.lock")


class ChipLockTimeout(TimeoutError):
    pass


def _is_cpu(device) -> bool:
    return str(device).split(":")[0] == "cpu"


@contextlib.contextmanager
def chip_lock(timeout_s: float = 1800.0, poll_s: float = 5.0,
              path: str | None = None, device="cuda"):
    """Advisory inter-process lock around work on the card.

    Waits up to ``timeout_s`` (polling every ``poll_s``) for the holder to
    finish, then yields holding the lock (its file descriptor). Raises
    ``ChipLockTimeout`` on expiry: the caller retries later, and never
    goes on unlocked. Yields None at once where ``device`` is the CPU."""
    if _is_cpu(device):
        yield None
        return
    p = path or default_lock_path()
    fd = os.open(p, os.O_CREAT | os.O_RDWR, 0o666)
    t0 = time.time()
    try:
        while True:
            try:
                fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
                break
            except OSError as e:
                if e.errno not in (errno.EAGAIN, errno.EACCES):
                    raise
                if time.time() - t0 > timeout_s:
                    raise ChipLockTimeout(
                        f"chip lock {p} held elsewhere for "
                        f"> {timeout_s:.0f}s") from None
                time.sleep(poll_s)
        try:
            os.ftruncate(fd, 0)
            os.write(fd, f"pid={os.getpid()} t={time.time():.0f}\n"
                     .encode())
        except OSError:
            pass
        yield fd
    finally:
        try:
            fcntl.flock(fd, fcntl.LOCK_UN)
        finally:
            os.close(fd)
