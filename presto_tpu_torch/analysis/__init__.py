"""Engine-invariant static analysis of the port (the lint subsystem).

Counterpart of ``presto_tpu/analysis``, with its rule ids, suppression
comment and baseline format, pointed at ``presto_tpu_torch/`` and
``chip_smoke.py``. The engine's correctness rests on hand-enforced
invariants: every behavior-changing knob folded into the exec-cache
key, no host sync inside a cached step body or a kernel wrapper,
lock-guarded mutation of shared runtime state, restore discipline for
the process-global ``PRESTO_TPU_*`` env switches and registries. This
package machine-checks them: a pure-stdlib ``ast`` pass that imports
none of the analyzed code, failing on any unsuppressed finding.

Usage::

    python -m presto_tpu_torch.analysis [--format json|text] [--rule ID] \
        [paths...]

The README's port section lists the rules and the suppression policy.
"""

from presto_tpu_torch.analysis.engine import (  # noqa: F401
    RULES,
    AnalysisResult,
    analyze,
    load_baseline,
)
from presto_tpu_torch.analysis.findings import Finding  # noqa: F401
