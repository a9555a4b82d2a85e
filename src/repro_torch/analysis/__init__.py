"""The port's program audit (``audit.py``) and its analytic roofline terms
(``roofline.py``)."""
