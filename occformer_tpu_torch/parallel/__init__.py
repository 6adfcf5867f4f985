"""Data parallelism over processes (``distributed.py``)."""
