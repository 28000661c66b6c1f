"""``kill-mid-pack-resume`` in both packages, on the CPU: a k=4 pack
SIGKILLed after epoch 1 under the ProcessScheduler; all four members
resume serially from their slice checkpoints in the respawned worker,
and their params equal unfaulted serial runs bit for bit. The same
check names as the JAX package's run of its own scenario, all passing
(``tests/test_torch_chaos_kill_trial.py`` runs the pair).
"""

import torch

from tests.test_torch_chaos_kill_trial import check_names, run_in_both

# See test_torch_train.py: two intra-op threads per xdist worker.
torch.set_num_threads(2)


def test_kill_mid_pack_resume_in_both_packages(monkeypatch):
    got, want = run_in_both("kill-mid-pack-resume", monkeypatch)
    check_names(got, want)
    assert sum(c.name.startswith("params_match_serial:") for c in got.checks) == 4
