"""Training of the port: the step factories (``steps``) and the
fault-tolerant loop (``loop``)."""
