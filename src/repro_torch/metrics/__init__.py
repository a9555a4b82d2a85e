"""Streaming + exact evaluation metrics behind one mergeable protocol
(counterpart of ``repro.metrics``): ``streaming`` holds the sketch and the
``Metric`` backends, ``report`` the launcher's flags and report lines."""
