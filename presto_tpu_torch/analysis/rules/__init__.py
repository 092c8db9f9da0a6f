"""Rule modules — importing this package populates ``engine.RULES``.

Rule-id namespace:

- ``PT0xx`` analyzer meta (engine.py emits these directly)
- ``PT1xx`` trace hygiene
- ``PT2xx`` cache-key completeness
- ``PT3xx`` lock discipline
- ``PT4xx`` global-state hygiene
"""

from presto_tpu_torch.analysis.rules import (  # noqa: F401
    cache_keys,
    global_state,
    lock_discipline,
    meta,
    trace_hygiene,
)
