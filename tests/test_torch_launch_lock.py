"""``parallel/launch.group_lock``: process groups started by different
processes of one machine run one after another.

Four processes each hold the lock for 0.3 s and report when they took and
left it (``time.monotonic``, one clock for the machine); no two of those
intervals may overlap. The children get a temporary directory of their
own, so the groups of other tests running beside this one do not wait on
them.
"""

import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
HOLDERS = 4
TIMEOUT_S = 60

_HOLDER = """
import time
from dalle_tpu_torch.parallel.launch import group_lock
with group_lock():
    start = time.monotonic()
    time.sleep(0.3)
    end = time.monotonic()
print(start, end)
"""


def test_group_lock_runs_groups_one_after_another(tmp_path):
    env = dict(os.environ, TMPDIR=str(tmp_path),
               PYTHONPATH=os.pathsep.join(
                   [str(REPO)] + [p for p in os.environ.get(
                       "PYTHONPATH", "").split(os.pathsep) if p]))
    procs = [subprocess.Popen([sys.executable, "-c", _HOLDER], env=env,
                              cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for _ in range(HOLDERS)]
    try:
        outs = [p.communicate(timeout=TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), outs
    spans = sorted(tuple(map(float, out.split()[-2:])) for out in outs)
    for (_, end), (start, _) in zip(spans, spans[1:]):
        assert start >= end, spans
    assert (tmp_path / "dalle_tpu_torch_process_groups.lock").exists()
