"""Atomic, asynchronous checkpoints of the port's training state
(``checkpoint``)."""
