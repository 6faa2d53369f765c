"""Persistence: the co-execution run journal (``checkpoint.py``)."""
