"""Distributed-training pieces of the port that one card runs: the int8
error-feedback gradient round trip (``compress``)."""
