"""Persistence: training checkpoints and the co-execution run journal
(``checkpoint.py``)."""
