"""Structured JSON metrics — port of ``dmlp_tpu/utils/metrics_log.py``.

The reference's observability is two text channels: results on stdout,
one ``Time taken`` line on stderr. That contract stays untouched
(utils.timing); this logger adds an optional structured channel: one
JSON object per line, appendable to a file or any stream. Every record
carries a monotonic ``t_ms`` (milliseconds since the logger was created)
so interleaved emitters stay orderable without trusting wall-clock.
Richer run-level artifacts belong in dmlp_tpu_torch.obs.run.RunRecord;
this stays the line-per-event channel.
"""

from __future__ import annotations

import json
import sys
import time
from typing import IO, Optional


class MetricsLogger:
    """Writes one JSON line per record; values must be JSON-serializable.

    Usable as a context manager (closes an owned file on exit)::

        with MetricsLogger(path="metrics.jsonl") as log:
            log.log(step=1, loss=0.5)
    """

    def __init__(self, path: Optional[str] = None, stream: Optional[IO] = None):
        if path is not None:
            self._fh: IO = open(path, "a")
            self._owns = True
        else:
            self._fh = stream if stream is not None else sys.stderr
            self._owns = False
        self._t0 = time.monotonic()

    def log(self, **record) -> None:
        record.setdefault(
            "t_ms", round((time.monotonic() - self._t0) * 1e3, 3))
        try:
            line = json.dumps(record, sort_keys=True)
        except TypeError as e:
            # A raw TypeError mid-run names neither the record nor the
            # offending key; rebuild the message so the emitter is fixable
            # from the traceback alone.
            bad = [k for k, v in record.items() if not _serializable(v)]
            raise TypeError(
                f"MetricsLogger record has non-JSON-serializable "
                f"value(s) for key(s) {bad or sorted(record)}: {e}"
            ) from None
        self._fh.write(line + "\n")
        self._fh.flush()

    def close(self) -> None:
        if self._owns:
            self._fh.close()

    def __enter__(self) -> "MetricsLogger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _serializable(value) -> bool:
    try:
        json.dumps(value)
        return True
    except TypeError:
        return False
