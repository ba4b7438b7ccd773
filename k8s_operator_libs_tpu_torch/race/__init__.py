"""race: the deterministic concurrency sanitizer over the port's threaded
components (the twin of the JAX package's ``tools/race``).

- :mod:`.scheduler`: a cooperative scheduler installed as the
  ``utils/threads.py`` backend: one runnable thread at a time, a
  preemption point at every shim lock, event or clock operation, seeded
  choices, a replayable decision trace, virtual time, deadlock reports;
- :mod:`.explore`: seeded bounded exploration with greedy trace
  shrinking (``chaos/campaign.py``'s seed-replay discipline applied to
  interleavings);
- :mod:`.lockset`: an Eraser-style lockset checker (a module-scoped
  ``sys.settrace`` over the operator spine's files) that convicts shared
  attributes whose candidate lockset goes empty, even on schedules that
  happen not to corrupt anything;
- :mod:`.harnesses`: the seven real-component harnesses (drain workers,
  eviction workers, leader renew vs demote, informer vs readers,
  uploader mirror vs wait_idle, router ticker vs proxy, sharded
  reconcile);
- :mod:`.planted`: scratch components with deliberate bugs, the
  explorer's own regression oracles.

CLI::

    python -m k8s_operator_libs_tpu_torch.race              # full exploration
    python -m k8s_operator_libs_tpu_torch.race --smoke      # fixed seeds
    python -m k8s_operator_libs_tpu_torch.race --self-test  # planted bugs
    python -m k8s_operator_libs_tpu_torch.race --harness NAME --seeds N
    python -m k8s_operator_libs_tpu_torch.race --base-seed K  # seeds K..
"""

from .explore import (ExploreResult, ScheduleResult, explore, replay,  # noqa: F401
                      run_once, shrink)
from .harnesses import HARNESSES, LOCKSET_FILES  # noqa: F401
from .lockset import LocksetChecker, RaceFinding  # noqa: F401
from .scheduler import (BudgetExceeded, CoopScheduler, DeadlockError,  # noqa: F401
                        RunReport)
