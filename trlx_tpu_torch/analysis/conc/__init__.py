"""graftcheck-conc: interprocedural concurrency analysis (rules CC001–CC005).

Built on the repo-wide call graph: discovers thread roots
(``threading.Thread(target=...)`` incl. bound methods and nested closures,
watchdog ``escalate`` callbacks), assigns every class method the set of
execution contexts it can run in, and propagates Eraser-style static locksets
through call edges. See :mod:`trlx_tpu_torch.analysis.conc.model` for the model and
its approximations, :mod:`trlx_tpu_torch.analysis.conc.rules_conc` for the rules,
and :mod:`trlx_tpu_torch.analysis.conc.seeds` for the CI must-fail seed
(``TRLX_CONC_SEED_REGRESSION=scheduler_race``).
"""

from trlx_tpu_torch.analysis.conc import rules_conc  # noqa: F401  (registers CC001-CC005)
from trlx_tpu_torch.analysis.conc.model import ConcReport, analyze  # noqa: F401
