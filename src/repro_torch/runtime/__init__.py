"""The fault-tolerant trainer (``trainer``)."""
