"""What the program-span metrics read: the port's span totals
(``utils/profiling.totals()``, ``{name: (calls, host s, device s)}``) over
the traced solves.  The traced run records them by itself, since the
profiler is on, and its warm solves ran before the profiler started, so
the totals hold the traced solves alone.  A port without the recorder,
or a run without a card (no span has device time), gives nothing to
read: the metric is left out."""

from __future__ import annotations

from typing import Dict, Optional, Tuple


def totals(on_card: str) -> Optional[Dict[str, Tuple[int, float, float]]]:
    """The port's span totals, or None when it has no recorder or when
    span ``on_card`` took no device time."""
    from medane_tchakorom_ufc_thesis_repository_tpu_torch.utils import profiling

    read = getattr(profiling, "totals", None)
    if read is None:
        return None
    got = read()
    return got if device_s(got, on_card) > 0 else None


def host_s(got, name: str) -> float:
    return got.get(name, (0, 0.0, 0.0))[1]


def device_s(got, name: str) -> float:
    return got.get(name, (0, 0.0, 0.0))[2]
