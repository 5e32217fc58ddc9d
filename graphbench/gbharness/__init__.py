"""The yardstick of ``graphbench``: input generation, the measured window
and its arithmetic, the device trace, the byte bounds and the plain
reference that decides ``correct``.  Only ``program.py`` touches the
system under test (``repro_torch``)."""
