"""Per-layer metric readers, one file per metric named by the metric
(``<name>.py``, dots included), loaded by path.  Each declares ``NAME``,
``UNIT``, ``LAYER`` and ``MOVES`` and defines ``read(record)``, which
returns the metric from a traced run's record (``trace.Recorder.record``)
or None where the run has nothing for it to read."""
