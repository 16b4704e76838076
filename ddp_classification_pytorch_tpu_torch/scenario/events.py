"""Re-export of the port's event plane (`obs/events.py`): the vocabulary,
the env gating and the torn-line tolerance live there, where the trainer,
the server and the fleet emit through it; this module keeps the scenario
package's import path."""

from ..obs.events import (  # noqa: F401
    ENV_EVENTS,
    ENV_SOURCE,
    EventLog,
    emit,
    read_events,
    write_event,
)
