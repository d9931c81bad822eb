"""Fault tolerance: checkpoints, elastic resume and the step watchdog
(port of ``repro.ft``)."""
