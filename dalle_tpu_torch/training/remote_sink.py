"""Pluggable remote archival sink for the aux peer's state archive
(counterpart of ``dalle_tpu/training/remote_sink.py``).

The reference's aux peer uploads model+optimizer to the HF Hub on a
cadence (``run_aux_peer.py:59-76``, ``arguments.py:150-161`` of
learning-at-home/dalle) so the world can fetch the latest model without
joining the swarm. This sink is destination-agnostic: a
local/NFS directory (or ``file://`` URL), a ``gs://`` bucket path (via
gsutil), or an rsync target — selected by the destination string, no
cloud SDK baked in.

Uploads are best-effort: a failed upload logs and returns False; the
local archive (training/checkpoint.py) is the durable copy.
"""

from __future__ import annotations

import logging
import os
import shutil
import subprocess
from typing import Optional

logger = logging.getLogger(__name__)


class RemoteSink:
    """Base: ``upload(local_path)`` pushes one file to the destination."""

    def upload(self, local_path: str) -> bool:
        raise NotImplementedError

    @staticmethod
    def create(dest: Optional[str]) -> Optional["RemoteSink"]:
        """Sink for a destination string, or None for no destination.

        - ``gs://bucket/prefix``            -> gsutil cp
        - ``rsync://host/path`` / ``user@host:path`` -> rsync
        - ``file:///abs/dir`` or a plain path        -> filesystem copy
        """
        if not dest:
            return None
        if dest.startswith("file://"):  # before the rsync heuristic: a
            return _DirSink(dest[len("file://"):])  # path may contain '@'
        if dest.startswith("gs://"):
            return _CommandSink(["gsutil", "-q", "cp"], dest)
        if dest.startswith("rsync://") or (":" in dest.split("/", 1)[0]
                                           and "@" in dest):
            # rsync accepts rsync:// daemon URLs and user@host:path
            # specs natively — pass through verbatim
            return _CommandSink(["rsync", "-q"], dest)
        return _DirSink(dest)


class _DirSink(RemoteSink):
    """Copy into a (possibly network-mounted) directory."""

    def __init__(self, directory: str):
        self.directory = directory

    def upload(self, local_path: str) -> bool:
        try:
            os.makedirs(self.directory, exist_ok=True)
            tmp = os.path.join(self.directory,
                               "." + os.path.basename(local_path) + ".tmp")
            shutil.copyfile(local_path, tmp)
            os.replace(tmp, os.path.join(self.directory,
                                         os.path.basename(local_path)))
            return True
        except OSError as e:
            logger.warning("remote archive copy to %s failed: %s",
                           self.directory, e)
            return False


class UploadWorker:
    """One background uploader with a 1-slot latest-wins queue.

    The aux peer is the swarm's single monitoring writer: uploads must not
    block its loop, must not pile up threads when the destination hangs,
    and the FRESHEST checkpoint must still be drained at shutdown. A
    submit while a transfer is in flight simply replaces the pending slot
    (older checkpoints are superseded anyway).
    """

    def __init__(self, sink: RemoteSink, dest: str):
        import threading

        self.sink = sink
        self.dest = dest
        self._cv = threading.Condition()
        self._pending: Optional[str] = None
        self._closing = False
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def submit(self, path: str) -> None:
        with self._cv:
            self._pending = path
            self._cv.notify()

    def close(self, timeout: float = 660.0) -> None:
        with self._cv:
            self._closing = True
            self._cv.notify()
        self._thread.join(timeout)

    def _run(self) -> None:
        while True:
            with self._cv:
                while self._pending is None and not self._closing:
                    self._cv.wait()
                path, self._pending = self._pending, None
                if path is None and self._closing:
                    return
            if self.sink.upload(path):
                logger.info("uploaded %s to %s", path, self.dest)


class _CommandSink(RemoteSink):
    """Upload via an external transfer tool (gsutil / rsync)."""

    def __init__(self, argv_prefix, dest: str, timeout: float = 600.0):
        self.argv_prefix = list(argv_prefix)
        self.dest = dest
        self.timeout = timeout

    def upload(self, local_path: str) -> bool:
        argv = self.argv_prefix + [local_path, self.dest]
        try:
            res = subprocess.run(argv, capture_output=True, text=True,
                                 timeout=self.timeout)
        except (OSError, subprocess.TimeoutExpired) as e:
            logger.warning("remote archive upload failed (%s): %s",
                           argv[0], e)
            return False
        if res.returncode != 0:
            logger.warning("remote archive upload failed (%s): %s",
                           argv[0], res.stderr.strip()[-500:])
            return False
        return True
