"""Which workers' rows each rank holds (``sharding/rules.py``)."""
