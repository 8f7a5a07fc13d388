"""Distributed-training pieces of the port: the int8 error-feedback
gradient round trip (``compress``) and the named-axis sharding rules
(``sharding``) the placement session traces a mesh with."""
