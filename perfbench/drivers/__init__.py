"""Closed-loop drivers, one module per ``driver`` a traffic file names.
Each has ``setup(run)``, everything before the window, and
``request(run, index)``, one timed request returning a ``harness.Request``."""
