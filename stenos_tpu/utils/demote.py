"""One-shot warnings for decisions the caller should see.

frame.compress_generic warns once when a time budget is below the
measured warm floor of its backend: the call still runs, but the budget
cannot be met, and saying so beats a silent overshoot.

Set STENOS_SILENT=1 to suppress.
"""

import os
import warnings

_seen: set = set()


class DemotionWarning(UserWarning):
    """A request the chosen path cannot honour (e.g. an unmeetable time
    budget)."""


def warn_once(key: str, msg: str) -> None:
    """Emit one DemotionWarning per (process, key)."""
    if key in _seen or os.environ.get("STENOS_SILENT"):
        return
    _seen.add(key)
    warnings.warn(f"stenos-tpu: {msg}", DemotionWarning,
                  stacklevel=3)
