"""The plain reference that decides ``correct`` (``viterbi.py``)."""
