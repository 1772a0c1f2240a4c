"""The project's analyzer (``scripts/lint.py``, LINTS.md) over the port:
zero findings with no baseline entry. Where a copied module keeps the JAX
design, it keeps the JAX line's ``# graftlint:`` pragma; the modules the
port adds lint clean as they are."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_the_port_has_no_lint_findings():
    res = subprocess.run(
        [sys.executable, "scripts/lint.py", "dalle_tpu_torch", "--no-cache",
         "--format", "json"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert res.returncode == 0, res.stderr
    findings = json.loads(res.stdout)["findings"]
    assert findings == [], "\n".join(
        f"{f.get('path')}:{f.get('line')}: [{f.get('rule')}] "
        f"{f.get('message', '')[:120]}" for f in findings)


def test_no_baseline_entry_names_the_port():
    with open(os.path.join(ROOT, "lint_baseline.json")) as f:
        assert "dalle_tpu_torch" not in f.read()
