"""The port's examples (examples/torch_*_example.py) on the CPU, each as a
user runs it, with --device cpu: exit code 0 and the original's accepted
line.  The four run at once (each about 4-10 s alone, mostly host curve
work), each with OMP_NUM_THREADS=1: one intra-op thread, as the other
test files set for themselves.  examples/torch_dist_plonk_example.py is not run here: its
single-device check alone, three plain MSMs of 256 points, takes over a
minute on the CPU; chip_smoke.py runs it on the card."""
import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
ACCEPTED = {
    "kzg": "KZG commit/open/verify: accepted",
    "plonk": "PLONK prove/verify: accepted",
    "fri": "Accepted!",
    "nova": "Nova 4-step IVC: accepted",
}


@pytest.fixture(scope="module")
def runs():
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = {name: subprocess.Popen([sys.executable, str(REPO / "examples" / f"torch_{name}_example.py"),
                                     "--device", "cpu"], cwd=REPO, env=env, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)
             for name in ACCEPTED}
    out = {}
    try:
        for name, p in procs.items():
            stdout, stderr = p.communicate(timeout=300)
            out[name] = (p.returncode, stdout, stderr)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


@pytest.mark.parametrize("name", list(ACCEPTED))
def test_example_runs_on_the_cpu(runs, name):
    rc, stdout, stderr = runs[name]
    assert rc == 0, stderr
    assert ACCEPTED[name] in stdout.splitlines()
