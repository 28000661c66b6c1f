"""``collective-kill-mid-step`` in both packages, on the CPU: a width-2
dp trial (in the port, two gloo ranks, one process each) SIGKILLed at
the ``collective.step`` site of its second epoch; the scheduler tears
the group down, respawns it, and every rank of the new group resumes
the orphan from its checkpoint and runs it to completion. The same check names as the JAX package's run of its own
scenario, all passing (``tests/test_torch_chaos_kill_trial.py`` runs
the pair).
"""

import torch

from tests.test_torch_chaos_kill_trial import check_names, run_in_both

# See test_torch_train.py: two intra-op threads per xdist worker.
torch.set_num_threads(2)


def test_collective_kill_mid_step_in_both_packages(monkeypatch):
    got, want = run_in_both("collective-kill-mid-step", monkeypatch)
    check_names(got, want)
