"""``kill-mid-trial-resume`` in both packages, on the CPU.

Each package runs its own scenario (the JAX package's through its CLI,
in a subprocess, while the port's runs here): its ProcessScheduler
worker SIGKILLs itself after epoch 1 of a 3-epoch trial, and the
respawned ``-r1`` worker adopts and resumes it from its checkpoint. Both
must pass every check, with the same check names in the same order
(trial ids aside), the runner's journal checks included.
"""

import json
import os
import subprocess
import sys

import torch

from rafiki_tpu_torch.chaos.runner import format_report, run_scenario

# See test_torch_train.py: two intra-op threads per xdist worker.
torch.set_num_threads(2)

JAX_TIMEOUT_S = 300


def run_in_both(name, monkeypatch):
    """The port's report and the JAX package's report dict of ``name``."""
    # The scenarios' workers and their serial references compute with the
    # same intra-op thread count as this process.
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    jax_proc = subprocess.Popen(
        [sys.executable, "-m", "rafiki_tpu.chaos", "run", name, "--json"],
        env=dict(os.environ, JAX_PLATFORMS="cpu"), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        got = run_scenario(name, device="cpu")
        out, err = jax_proc.communicate(timeout=JAX_TIMEOUT_S)
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
            jax_proc.wait()
    assert jax_proc.returncode == 0, (out[-2000:], err[-2000:])
    [want], _ = json.JSONDecoder().raw_decode(out[out.index("[\n"):])
    return got, want


def check_names(got, want):
    assert got.passed, format_report(got)
    assert want["passed"], want
    assert [c.name.split(":")[0] for c in got.checks] == \
        [c["name"].split(":")[0] for c in want["checks"]]


def test_kill_mid_trial_resume_in_both_packages(monkeypatch):
    got, want = run_in_both("kill-mid-trial-resume", monkeypatch)
    check_names(got, want)
    assert "journal_records_worker_death" in [c.name for c in got.checks]
