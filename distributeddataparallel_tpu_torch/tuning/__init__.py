"""Attribution-driven autotuner: the port's counterpart of the reference's
``tuning`` package.

Turns the performance-attribution layer's numbers (cost model, memory
budget, MFU gauge) into decisions: enumerate a typed config space,
prune analytically, measure the top-K with short windows, and persist
the winner keyed by the toolchain, devices, mesh and model fingerprint —
so ``dpp --autotune apply`` reaches its first step on a previously-tuned
host with zero search.  ``space`` and ``store``'s record format are the
reference's; the divergences (no executable store, only running out of
memory is a trial's own failure, the port's own key) are stated in
``autotuner``, ``harness`` and ``store``.

Entry points: ``dpp --autotune`` and ``search_model`` for programmatic
use.
"""

from distributeddataparallel_tpu_torch.tuning.autotuner import (  # noqa: F401
    Autotuner,
    TrialRecord,
    TrialRefused,
)
from distributeddataparallel_tpu_torch.tuning.harness import (  # noqa: F401
    TUNE_MODELS,
    build_trial_case,
    canonical_model,
    default_space_for,
    default_tuned_key,
    measure_trial,
    model_config_for,
    model_statics,
    search_model,
    trial_key,
)
from distributeddataparallel_tpu_torch.tuning.space import (  # noqa: F401
    SearchSpace,
    TrialConfig,
)
from distributeddataparallel_tpu_torch.tuning.store import (  # noqa: F401
    TuningStore,
    tuned_key,
)
