"""The port's fleet manager (``dalle_tpu_torch/cli/manage_fleet.py``),
held to the structure of the JAX package's (``TestFleetCLI`` in
tests/test_cli.py): a dry run prints one create a worker (Spot, the
worker's name, the initial peer and the port's ``run_trainer``), one
delete a worker and one list; the startup script inlines no secret and
names no JAX, and its trainer command parses with the port's CLI."""

import shlex
import subprocess
import sys
from pathlib import Path

import pytest

from dalle_tpu_torch.cli import manage_fleet

REPO = Path(__file__).resolve().parent.parent


def test_dry_run_prints_gcloud_commands(capsys):
    main = manage_fleet.main
    rc = main(["create", "--project", "p", "--zone", "z",
               "--swarm-size", "2", "--initial-peer", "10.0.0.2:31334",
               "--dry-run"])
    assert rc == 0
    out = capsys.readouterr().out
    assert out.count("gcloud compute instances create") == 2
    assert out.count("--provisioning-model=SPOT") == 2
    # an evicted worker is deleted, so create can make it again
    assert out.count("--instance-termination-action=DELETE") == 2
    assert out.count("--machine-type=a3-highgpu-1g") == 2
    assert "dalle-h100-worker-0" in out and "dalle-h100-worker-1" in out
    assert "--initial-peers 10.0.0.2:31334" in out
    assert out.count("python3 -m dalle_tpu_torch.cli.run_trainer") == 2
    assert "--device cuda" in out

    rc = main(["delete", "--project", "p", "--swarm-size", "2",
               "--dry-run"])
    assert rc == 0
    out = capsys.readouterr().out
    assert out.count("gcloud compute instances delete") == 2
    assert "dalle-h100-worker-1" in out

    rc = main(["list", "--project", "p", "--dry-run"])
    assert rc == 0
    out = capsys.readouterr().out
    assert out.count("gcloud compute instances list") == 1
    assert manage_fleet.FLEET_PREFIX in out


def test_the_module_runs_as_a_script():
    res = subprocess.run(
        [sys.executable, "-m", "dalle_tpu_torch.cli.manage_fleet", "create",
         "--project", "p", "--swarm-size", "3", "--machine-type",
         "a3-highgpu-2g", "--dry-run"], cwd=REPO, capture_output=True,
        text=True, timeout=60)
    assert res.returncode == 0, res.stderr
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("+ ")]
    assert len(lines) == 3
    assert all("--machine-type=a3-highgpu-2g" in ln for ln in lines)


def test_startup_script_has_no_secrets_and_no_jax():
    lowered = manage_fleet.STARTUP_SCRIPT.lower()
    for needle in ("ghp_", "api_key=", "token=", "password"):
        assert needle not in lowered
    assert "jax" not in lowered
    assert "pip install" not in lowered


@pytest.mark.parametrize("initial_peer", [None, "10.0.0.2:31334"])
def test_the_startup_script_launches_the_ports_trainer(initial_peer):
    """The script's trainer command line parses with the port's
    ``run_trainer`` parser, on the card, and gcloud's ``--metadata`` gets
    the script whole (gcloud splits that flag's value at commas)."""
    from dalle_tpu_torch.cli.run_trainer import build_parser
    args = manage_fleet.build_parser().parse_args(
        ["create", "--project", "p", "--preset", "xl",
         "--experiment-prefix", "exp"]
        + (["--initial-peer", initial_peer] if initial_peer else []))
    script = manage_fleet.startup_script(args)
    assert "," not in script
    create = manage_fleet.build_create_command(args, 0)
    meta = [c for c in create if c.startswith("--metadata=")]
    assert meta == ["--metadata=install-nvidia-driver=True,"
                    f"startup-script={script}"]
    body = script.split("exec ", 1)[1].split(">>", 1)[0]
    argv = shlex.split(body.replace("\\\n", " "))
    assert argv[:3] == ["python3", "-m", "dalle_tpu_torch.cli.run_trainer"]
    parsed = build_parser().parse_args(argv[3:])
    assert parsed.device == "cuda" and parsed.preset == "xl"
    assert parsed.experiment_prefix == "exp" and parsed.run_id == "exp"
    want = (initial_peer,) if initial_peer else ()
    assert tuple(getattr(parsed, "initial_peers", ()) or ()) == want
