"""Ask/tell hyperparameter-optimisation engines.

Counterpart of ``rafiki_tpu/advisor``: ``BaseAdvisor`` is the in-proc
engine, ``AdvisorService`` shares it between workers. The GP engine is
the port's own Gaussian process in numpy and scipy (``gp.py``), with no
scikit-learn.
"""

from rafiki_tpu_torch.advisor.base import BaseAdvisor, make_advisor
from rafiki_tpu_torch.advisor.gp import GpAdvisor
from rafiki_tpu_torch.advisor.random_advisor import RandomAdvisor
from rafiki_tpu_torch.advisor.service import AdvisorService
from rafiki_tpu_torch.advisor.tpe import TpeAdvisor

__all__ = ["AdvisorService", "BaseAdvisor", "GpAdvisor", "RandomAdvisor",
           "TpeAdvisor", "make_advisor"]
