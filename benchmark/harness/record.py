"""What a cell's driver hands back to the harness."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

from .trace import DeviceTrace


@dataclass
class RunRecord:
    attempted: int
    failed: int
    end_to_end: Dict[str, float]          # every end-to-end metric it took
    checks: Dict[str, float]              # the numbers held to the limits
    memory_peak_bytes: int
    facts: Dict[str, Any] = field(default_factory=dict)   # for the readers
    trace: Optional[DeviceTrace] = None
    notes: Dict[str, Any] = field(default_factory=dict)   # printed, not read
