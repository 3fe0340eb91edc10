"""Parameter-count breakdown of a parameter tree.

Counterpart of ``t5gemma_tts_tpu/utils/profiling.py::param_count_breakdown``
(the JAX module's meters and ``jax.profiler`` wrappers have no caller in
the training path; the card's timings come from ``torch.cuda`` events and
``torch.profiler`` in ``chip_smoke.py``).
"""

from __future__ import annotations

from typing import Dict

from .tree import leaves_with_path


def param_count_breakdown(params) -> Dict[str, int]:
    """Per-subtree parameter counts (the first key of each leaf's path) and
    their total."""
    counts: Dict[str, int] = {}
    total = 0
    for path, leaf in leaves_with_path(params):
        key = path[0] if path else "params"
        n = int(leaf.numel()) if hasattr(leaf, "numel") else 0
        counts[key] = counts.get(key, 0) + n
        total += n
    counts["total"] = total
    return counts
