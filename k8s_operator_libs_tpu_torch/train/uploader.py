"""Checkpoint uploader: the drain-immune half of the drain-save protocol.

Port of the JAX package's ``train/uploader.py``. The training job saves
to node-local storage, so a drain save pays only the device-to-host fetch
and a local write before the job exits; a :class:`CheckpointUploader`,
deployed as a DaemonSet pod that shares the host path
(``docs/checkpoint-uploader.yaml``), mirrors each finished checkpoint to
durable storage in the background. A drain never evicts DaemonSet pods
(the reference operator's ``IgnoreAllDaemonSets``), so the mirror keeps
running while the job is torn down and rescheduled: the durable write
rides the unavailability window instead of preceding it. The durable
target must rename directories atomically (NFS, a persistent disk, local
disk; not gcsfuse, whose rename is a copy and a delete).

Correctness rests on two atomic renames:

- the trainer (:mod:`.harness`) writes a step into a ``.tmp-*``
  directory and publishes it with ``os.replace`` as the bare ``<step>``
  name, so every all-digit directory in the local root is a whole
  checkpoint: the uploader never sees half of one;
- the uploader copies into a ``<step>.uploading-*`` staging directory and
  renames it on completion, so a reader of the durable directory (the
  resumed job) never sees half a copy, and a crashed upload leaves only a
  staging directory that is never read and is swept once stale.

If the host dies before a mirror lands, the resumed job restores the
previous durable checkpoint: the uncoordinated baseline, never data
loss.
"""

from __future__ import annotations

import logging
import os
import shutil
import uuid
from typing import List, Optional

from ..utils import threads
from ..utils.clock import Clock, RealClock

logger = logging.getLogger(__name__)

_STAGING_SUFFIX = ".uploading"
_STALE_STAGING_SECONDS = 3600.0


def _finalized_steps(root: str) -> List[str]:
    try:
        names = os.listdir(root)
    except FileNotFoundError:
        return []
    return sorted((n for n in names if n.isdigit()), key=int)


def mirror_once(local_dir: str, durable_dir: str,
                clock: Optional[Clock] = None) -> int:
    """Copy every finished local step that ``durable_dir`` lacks, each
    through a staging directory and a rename; the number of steps
    mirrored. Runs alone (a cron-style job) or under
    :class:`CheckpointUploader`.

    Safe against a concurrent uploader: staging names are unique per
    attempt (pid and a random suffix), so two uploaders whose hosts both
    hold a step (a job drained on host A and rescheduled to host B) never
    write into one staging directory; the first rename wins and the other
    discards its own whole copy."""
    os.makedirs(durable_dir, exist_ok=True)
    _sweep_stale_staging(durable_dir, clock=clock)
    done = set(_finalized_steps(durable_dir))
    mirrored = 0
    for step in _finalized_steps(local_dir):
        if step in done:
            continue
        src = os.path.join(local_dir, step)
        staging = os.path.join(
            durable_dir,
            f"{step}{_STAGING_SUFFIX}-{os.getpid()}-{uuid.uuid4().hex[:8]}")
        dst = os.path.join(durable_dir, step)
        shutil.copytree(src, staging)
        try:
            os.rename(staging, dst)  # readers see whole steps only
        except OSError as exc:
            shutil.rmtree(staging, ignore_errors=True)
            if os.path.isdir(dst):
                # a concurrent uploader published it first: both copies
                # were whole, so dropping ours loses nothing
                logger.info("step %s already published by a concurrent "
                            "uploader; discarded our copy", step)
            else:
                # the step is not durable: say so and retry next pass
                logger.error("failed to publish checkpoint step %s -> %s: "
                             "%s (will retry)", step, dst, exc)
            continue
        mirrored += 1
        logger.info("mirrored checkpoint step %s -> %s", step, durable_dir)
    return mirrored


def _newest_mtime(root: str) -> float:
    """The newest mtime anywhere in the tree: the top directory's alone
    does not change while a copy writes into its subdirectories, and
    sweeping on it could delete a slow live copy."""
    newest = os.path.getmtime(root)
    for dirpath, dirnames, filenames in os.walk(root):
        for n in dirnames + filenames:
            try:
                newest = max(newest,
                             os.path.getmtime(os.path.join(dirpath, n)))
            except OSError:
                continue
    return newest


def _sweep_stale_staging(durable_dir: str,
                         clock: Optional[Clock] = None) -> None:
    """Remove crashed attempts' staging directories once nothing in them
    has been written for ``_STALE_STAGING_SECONDS`` (a live copy, however
    slow, keeps writing and is never swept), judged by the clock's wall
    time, which the on-disk mtimes are comparable with."""
    now = (clock or RealClock()).wall()
    try:
        names = os.listdir(durable_dir)
    except FileNotFoundError:
        return
    for n in names:
        if _STAGING_SUFFIX not in n:
            continue
        path = os.path.join(durable_dir, n)
        try:
            if now - _newest_mtime(path) > _STALE_STAGING_SECONDS:
                shutil.rmtree(path, ignore_errors=True)
        except OSError:
            continue


class CheckpointUploader:
    """A background mirror of ``local_dir`` into ``durable_dir``.

    Its lifetime is the host's, not the job's: start it before the job
    and leave it running across the job's restarts. :meth:`wait_idle`
    blocks until every step finished locally is durable (tests and a
    single-host run use it where a deployment relies on the DaemonSet
    outliving the drain)."""

    def __init__(self, local_dir: str, durable_dir: str,
                 poll_seconds: float = 1.0,
                 clock: Optional[Clock] = None):
        self.local_dir = local_dir
        self.durable_dir = durable_dir
        self.poll_seconds = poll_seconds
        self._clock = clock or RealClock()
        self._stop = threads.make_event("ckpt-uploader-stop")
        self._idle = threads.make_event("ckpt-uploader-idle")
        self._thread = None

    def start(self) -> "CheckpointUploader":
        self._thread = threads.spawn("ckpt-uploader", self._run)
        return self

    def _caught_up(self) -> bool:
        return set(_finalized_steps(self.local_dir)) <= set(
            _finalized_steps(self.durable_dir))

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                mirror_once(self.local_dir, self.durable_dir,
                            clock=self._clock)
                if self._caught_up():
                    self._idle.set()
                else:
                    self._idle.clear()
            except Exception:  # exc: allow — the mirror thread must survive any I/O failure and retry next poll
                logger.exception("checkpoint mirror pass failed; retrying")
                self._idle.clear()
            self._stop.wait(self.poll_seconds)

    def wait_idle(self, timeout: float = 60.0) -> bool:
        """Block until the mirror has caught up; False at ``timeout``."""
        deadline = self._clock.now() + timeout
        while self._clock.now() < deadline:
            if self._idle.is_set() and self._caught_up():
                return True
            self._clock.sleep(min(0.05, self.poll_seconds))
        return False

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)

    def __enter__(self) -> "CheckpointUploader":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
